"""The full-bucket lm_head (``gather_last=False``): the builders run the
lm_head over every row, ``next_token`` is the argmax over [slots, T, V],
and the engine reads each admission's row at its prompt's last index and
row 0 of every decode step. Against the JAX package on the same seeded
weights: the graph and the engine token for token on GPT-2 and Llama
cache forms.

Small GPT-2 (2 layers, E 128, H 2, D 64, vocab 512, weights sharpened 10x)
and Llama (2 layers, E 256, 4 query heads over 2 KV heads, D 64, the
projections sharpened 2x), 3 slots, cap 64.
"""

import numpy as np
import pytest

from rten_tpu.dtypes import DataType as JDataType
from rten_tpu.model import Model as JModel
from rten_tpu.model import ModelOptions as JOptions
from rten_tpu.models import gpt2 as jgpt2
from rten_tpu.models import llama as jllama
from rten_tpu.quantize_pass import quantize_dynamic as jquantize
from rten_tpu.serving import ContinuousBatchingEngine as JEngine
from rten_tpu_torch.dtypes import DataType as TDataType
from rten_tpu_torch.model import Model as TModel
from rten_tpu_torch.models import gpt2 as tgpt2
from rten_tpu_torch.models import llama as tllama
from rten_tpu_torch.quantize_pass import quantize_dynamic as tquantize
from rten_tpu_torch.serving import ContinuousBatchingEngine as TEngine
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

GPT2 = dict(vocab_size=512, n_positions=128, n_embd=128, n_layer=2, n_head=2)
LLAMA = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128)
CAP = 64

# name: (family, builder options; "bf16" names the recent windows' dtype)
FORMS = {
    "gpt2_s8_cat": ("gpt2", dict(kv_quant=True, kernel_append=True)),
    "gpt2_int4_deferred": ("gpt2", dict(kv_quant=True, kv_bits=4, deferred_kv=True,
                                        recent_dtype="bf16")),
    "gpt2_s8_cat_paged": ("gpt2", dict(kv_quant=True, kernel_append=True, paged_blocks=8,
                                       block_size=16)),
    "llama_s8_head_major": ("llama", dict(kv_quant=True)),
    "llama_f32_cat": ("llama", dict(kernel_append=True)),
}


def _graphs(form):
    family, opts = FORMS[form]
    out = []
    for mod, quant, DT in ((tgpt2 if family == "gpt2" else tllama, tquantize, TDataType),
                           (jgpt2 if family == "gpt2" else jllama, jquantize, JDataType)):
        o = {k: DT.BFloat16 if v == "bf16" else v for k, v in opts.items()}
        if family == "gpt2":
            cfg = mod.GPT2Config(**GPT2)
            w = mod.random_weights(cfg, seed=0)
            w = {k: v * np.float32(10) if (".attn." in k or ".mlp." in k) else v
                 for k, v in w.items()}
        else:
            cfg = mod.LlamaConfig(**LLAMA)
            w = mod.random_weights(cfg, seed=0)
            w = {k: v * np.float32(2) if "_proj." in k else v for k, v in w.items()}
        g = mod.build_graph_static_cache(cfg, w, capacity=CAP, gather_last=False, **o)
        quant(g)
        out.append(g)
    return out


def _signature(g):
    return [(nid, g.node_name(nid), type(n).__name__, getattr(n, "op_type", None))
            for nid, n in sorted(g.nodes.items())]


@pytest.mark.parametrize("form", list(FORMS))
def test_graph_matches_jax(form):
    """No last_pos input and no gather: the same nodes as the JAX graph."""
    tg, jg = _graphs(form)
    assert _signature(tg) == _signature(jg)
    assert tg.find_node("last_pos") is None
    assert not any(op.op_type == "GatherND" for _, op in tg.operators())


def test_admission_forward_shapes():
    """The full-bucket forward: logits [slots, T, V] and next_token
    [slots, T], the argmax of each row's logits."""
    tg, _ = _graphs("gpt2_s8_cat")
    tm = TModel(tg, device="cpu")
    rng = np.random.default_rng(3)
    T = 8
    feed = {"input_ids": rng.integers(0, 512, (3, T)).astype(np.int32),
            "past_lens": np.zeros(3, np.int32),
            "position_ids": np.tile(np.arange(T, dtype=np.int32), (3, 1))}
    for name, dt, shape in tm.input_info():
        if name.startswith("past_key_values."):
            feed[name] = np.zeros((3,) + tuple(shape[1:]), dt.np_dtype)
    logits, tok = (t.numpy() for t in tm.run(feed, ["logits", "next_token"]))
    assert logits.shape == (3, T, 512) and tok.shape == (3, T)
    np.testing.assert_array_equal(tok, logits.argmax(-1))


def _serve(cls, model, k, n_head, seed=2):
    eng = cls(model, n_layer=2, n_head=n_head, head_dim=64, slots=3, capacity=CAP,
              prefill_bucket=8, greedy_on_device=True, steps_per_dispatch=k)
    rng = np.random.default_rng(seed)
    reqs = [eng.submit(rng.integers(0, 512, int(rng.integers(3, 12))).tolist(),
                       max_new_tokens=int(rng.integers(3, 14))) for _ in range(5)]
    eng.run()
    return eng, [r.generated for r in reqs]


@pytest.mark.parametrize("form,k", [("gpt2_s8_cat", 1), ("gpt2_s8_cat_paged", 4),
                                    ("llama_s8_head_major", 4)])
def test_engine_token_exact(form, k):
    """The engine on a full-bucket graph: the JAX engine's tokens (a paged
    engine ends with every block back in the pool)."""
    tg, jg = _graphs(form)
    n_head = 2 if FORMS[form][0] == "gpt2" else 4
    teng, got = _serve(TEngine, TModel(tg, device="cpu"), k, n_head)
    _, want = _serve(JEngine, JModel(jg, JOptions()), k, n_head)
    assert got == want
    assert teng.last_pos_id is None
    assert len({t for g in got for t in g}) > 5
    if teng.paged:
        assert sorted(teng._free_blocks) == list(range(1, teng.n_blocks))
