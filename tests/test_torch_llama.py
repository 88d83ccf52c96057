"""The port's Llama-family serving path against the JAX package's, at a
small config (2 layers, E 256, 4 query heads over 2 KV heads, D 64, vocab
512, slots 3, cap 64): the graph builder and pipeline, the model's
admission forward and decode steps, and the continuous-batching engine
token for token, for the three supported cache layouts.

Both packages build their graph from the same seeded weights. JAX runs on
the CPU (its kernels take their XLA fallbacks); the port runs on the CPU,
where each kernel wrapper runs its plain PyTorch version.

Activations are quantized per tensor (DynamicQuantizeLinear), and torch
and XLA sum in different orders, so an activation that lies within an ulp
of a u8 rounding boundary can take the neighbouring code on one side.
Through RMSNorm and SwiGLU such a flip moves the logits by up to a few
hundredths of their maximum (measured at the weights used here), and at a
near tie it changes the greedy token. The engine tests use weights and
prompts where both packages produce the same tokens; the forward test
states its tolerance.
"""

import numpy as np
import pytest
import torch

from rten_tpu.dtypes import DataType as JDataType
from rten_tpu.model import Model as JModel
from rten_tpu.model import ModelOptions as JOptions
from rten_tpu.models import llama as jllama
from rten_tpu.quantize_pass import quantize_dynamic as jquantize
from rten_tpu.serving import ContinuousBatchingEngine as JEngine
from rten_tpu_torch.ir.graph import Constant as TConstant
from rten_tpu_torch.kernels import flash_attention as tfa
from rten_tpu_torch.model import Model as TModel
from rten_tpu_torch.models import llama as tllama
from rten_tpu_torch.optimize import optimize_graph as toptimize
from rten_tpu_torch.quantize_pass import quantize_dynamic as tquantize
from rten_tpu_torch.serving import ContinuousBatchingEngine as TEngine
from rten_tpu_torch.weights import load_numpy_constants

SMALL = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128)
SLOTS, CAP, BUCKET = 3, 64, 8
# The supported cache layouts: name -> builder options.
LAYOUTS = {
    "s8_head_major": dict(kv_quant=True),
    "f32_head_major": dict(kv_quant=False),
    "s8_cat": dict(kv_quant=True, kernel_append=True),
}
# Model variants: name -> LlamaConfig overrides.
VARIANTS = {"llama": {}, "qwen2_bias": dict(attention_bias=True),
            "mistral_window": dict(sliding_window=8)}


def _cfg(variant="llama", **over):
    return {**SMALL, **VARIANTS[variant], **over}


def _weights(cfg, sharpen=1.0):
    """``random_weights(seed=0)`` with the projections scaled by
    ``sharpen``, so that greedy tokens depend on the context."""
    w = tllama.random_weights(tllama.LlamaConfig(**cfg), seed=0)
    for name in w:
        if "_proj." in name:
            w[name] = w[name] * np.float32(sharpen)
    return w


def _graphs(cfg, weights, layout, quantize=True):
    opts = dict(capacity=CAP, gather_last=True, **LAYOUTS[layout])
    tg = tllama.build_graph_static_cache(tllama.LlamaConfig(**cfg), weights, **opts)
    jg = jllama.build_graph_static_cache(jllama.LlamaConfig(**cfg), weights, **opts)
    if quantize:
        tquantize(tg)
        jquantize(jg)
    return tg, jg


def _models(cfg, weights, layout):
    tg, jg = _graphs(cfg, weights, layout)
    return TModel(tg, device="cpu"), JModel(jg, JOptions(optimize=True))


# --- the builder and the graph pipeline ---------------------------------------


def test_random_weights_and_rope_tables_match():
    for variant in VARIANTS:
        cfg = _cfg(variant)
        tw = tllama.random_weights(tllama.LlamaConfig(**cfg), seed=3)
        jw = jllama.random_weights(jllama.LlamaConfig(**cfg), seed=3)
        assert tw.keys() == jw.keys()
        for k in tw:
            assert tw[k].dtype == jw[k].dtype
            np.testing.assert_array_equal(tw[k], jw[k])
    for t, j in zip(tllama.rope_tables(tllama.LlamaConfig(**SMALL)),
                    jllama.rope_tables(jllama.LlamaConfig(**SMALL))):
        np.testing.assert_array_equal(t, j)
    # The defaults are TinyLlama-1.1B's shape in both packages.
    assert tllama.LlamaConfig() == tllama.LlamaConfig(**vars(jllama.LlamaConfig()))


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_weights_from_torch_matches_jax(qkv_bias):
    """The flat-named test model (tests/llama_like_model.py) renamed to HF
    ``LlamaForCausalLM`` names as the JAX package renames it; an HF-named
    state dict passes through unchanged."""
    from llama_like_model import LlamaLike

    torch.manual_seed(0)
    module = LlamaLike(vocab=64, E=32, Hq=4, Hkv=2, ffn=48, layers=2, qkv_bias=qkv_bias)
    tw, jw = tllama.weights_from_torch(module), jllama.weights_from_torch(module)
    assert tw.keys() == jw.keys()
    assert "model.layers.1.self_attn.k_proj.weight" in tw
    assert ("model.layers.0.self_attn.q_proj.bias" in tw) == qkv_bias
    for k in tw:
        np.testing.assert_array_equal(tw[k], jw[k])
    hf = torch.nn.Module()
    hf.model = torch.nn.Module()
    hf.model.embed_tokens = torch.nn.Embedding(3, 2)
    assert tllama.weights_from_torch(hf).keys() == {"model.embed_tokens.weight"}


def _constants(g):
    from rten_tpu.ir.graph import Constant as JConstant

    return {nid: (node.name, node.array) for nid, node in g.nodes.items()
            if isinstance(node, (TConstant, JConstant))}


def _plan_ops(g):
    return [g.nodes[n].op_type for n in g.plan(g.input_ids, g.output_ids)]


@pytest.mark.parametrize("stage", ["built", "quantized", "optimized"])
@pytest.mark.parametrize("layout,variant", [
    ("s8_head_major", "llama"), ("f32_head_major", "llama"), ("s8_cat", "llama"),
    ("s8_head_major", "qwen2_bias"), ("f32_head_major", "mistral_window"),
])
def test_pipeline_matches_jax(layout, variant, stage):
    """Same operators in plan order, same node ids, names, attributes,
    inputs and outputs, every constant equal by name, dtype and value."""
    cfg = _cfg(variant)
    tg, jg = _graphs(cfg, tllama.random_weights(tllama.LlamaConfig(**cfg), 0), layout,
                     quantize=stage != "built")
    if stage == "optimized":
        tg = toptimize(tg)
        jg = JModel(jg, JOptions(optimize=True)).graph
    assert _plan_ops(tg) == _plan_ops(jg)
    for attr in ("input_ids", "output_ids"):
        assert getattr(tg, attr) == getattr(jg, attr)
        assert ([tg.node_name(i) for i in getattr(tg, attr)]
                == [jg.node_name(i) for i in getattr(jg, attr)])
    for (tid, top), (jid, jop) in zip(tg.operators(), jg.operators()):
        assert (tid, top.op_type, top.attrs, top.inputs, top.outputs) == \
            (jid, jop.op_type, jop.attrs, jop.inputs, jop.outputs)
    for nid in tg.input_ids:
        t, j = tg.nodes[nid], jg.nodes[nid]
        assert (t.name, t.dtype.name, tuple(t.shape)) == (j.name, j.dtype.name, tuple(j.shape))
    tc, jc = _constants(tg), _constants(jg)
    assert tc.keys() == jc.keys()
    for nid in tc:
        (tn, ta), (jn, ja) = tc[nid], jc[nid]
        assert tn == jn
        assert ta.dtype == ja.dtype and ta.shape == ja.shape, tn
        np.testing.assert_array_equal(ta, ja, err_msg=str(tn))
    if stage == "optimized":
        attn = "GroupQueryAttention" if layout == "f32_head_major" else "QuantizedKVAttention"
        assert set(_plan_ops(tg)) == {
            "Add", "ArgMax", "DynamicQuantizeLinear", "Gather", "GatherND", attn,
            "MatMulIntegerToFloat", "Mul", "RMSNormalization", "Reshape", "Silu",
        }
        mm = [op for _, op in tg.operators() if op.op_type == "MatMulIntegerToFloat"]
        assert len(mm) == 7 * SMALL["num_hidden_layers"] + 1
        assert all(op.inputs[7] is not None for op in mm)  # colsums prepacked
        biased = [op for op in mm if op.inputs[6] is not None]
        assert len(biased) == (3 * SMALL["num_hidden_layers"] if variant == "qwen2_bias" else 0)


def test_weights_carried_by_name():
    """The JAX model's optimized constants (s8 weights, scales, colsums)
    carried into the port's Llama model by name: the same admission
    logits as the JAX model, and an equal next token, with the weights of
    the JAX side."""
    cfg = _cfg()
    tm, jm = _models(cfg, _weights(cfg, 3.0), "s8_head_major")
    arrays = {node.name: np.asarray(node.array) for node in jm.graph.nodes.values()
              if type(node).__name__ == "Constant" and node.name and node.array.size >= 16}
    assert any(k.endswith(".colsums") for k in arrays)
    assert any(k.endswith(".q8") for k in arrays)
    load_numpy_constants(tm, arrays)
    feed = _feed(tm, np.random.default_rng(0))
    got = [t.numpy() for t in tm.run(dict(feed), ["logits", "next_token"])]
    want = [np.asarray(a) for a in jm.run(dict(feed), ["logits", "next_token"])]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4 * np.abs(want[0]).max())


# --- the model: one admission forward, then three decode steps --------------


def _feed(model, rng, T=BUCKET):
    feed = {
        "input_ids": rng.integers(0, SMALL["vocab_size"], (SLOTS, T)).astype(np.int32),
        "past_lens": np.zeros(SLOTS, np.int32),
        "position_ids": np.tile(np.arange(T, dtype=np.int32), (SLOTS, 1)),
        "last_pos": np.array([T - 1, 3, 0], np.int32),
    }
    for name, dt, shape in model.input_info():
        if name.startswith("past_key_values."):
            feed[name] = np.zeros((SLOTS,) + tuple(shape[1:]), dt.np_dtype)
    return feed


@pytest.mark.parametrize("seed", [5, 6])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_model_forward_and_decode_match_jax(layout, seed):
    """An admission of 16 positions, then three decode steps, on weights
    sharpened 3x (the module docstring says why codes can flip): logits
    within 5e-2 of max|logit| (measured worst over these cases: a few
    1e-3), the same next token wherever JAX's top two logits are further
    apart than that, and s8 cache rows off by at most one code in at most
    1 % of entries (f32 caches: atol 1e-2)."""
    cfg = _cfg()
    tm, jm = _models(cfg, _weights(cfg, 3.0), layout)
    cache_names = [n for n, _, _ in tm.input_info() if n.startswith("past_key_values.")]
    present = ["present." + n[len("past_key_values."):] for n in cache_names]
    feed = _feed(tm, np.random.default_rng(seed), T=2 * BUCKET)
    tfeed, jfeed = dict(feed), dict(feed)
    lens = feed["last_pos"] + 1
    outs = ["logits", "next_token"] + present
    tol = 5e-2
    for step in range(4):
        got = [t.numpy() for t in tm.run(tfeed, outs)]
        want = [np.asarray(a) for a in jm.run(jfeed, outs)]
        scale = np.abs(want[0]).max()
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=tol * scale,
                                   err_msg=f"step {step}")
        for s in np.nonzero(got[1][:, 0] != want[1][:, 0])[0]:
            top2 = np.sort(want[0][s, 0])[-2:]
            assert top2[1] - top2[0] <= tol * scale, f"step {step} slot {s}"
        for name, g, w in zip(present, got[2:], want[2:]):
            if name.endswith("_scale"):
                np.testing.assert_allclose(g, w, rtol=2e-2, atol=0, err_msg=name)
            elif g.dtype == np.int8:
                diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
                assert diff.max() <= 1 or (diff > 0).mean() <= 1e-2, name
            else:
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-2, err_msg=name)
        tok = want[1][:, :1].astype(np.int32)
        step_feed = {"input_ids": tok, "past_lens": lens, "position_ids": lens[:, None],
                     "last_pos": np.zeros(SLOTS, np.int32)}
        tfeed = {**step_feed, **dict(zip(cache_names, got[2:]))}
        jfeed = {**step_feed, **dict(zip(cache_names, want[2:]))}
        lens = lens + 1


# --- the engine: token-exact against the JAX engine -------------------------


def _serve(cls, model, k, requests):
    eng = cls(model, n_layer=SMALL["num_hidden_layers"], n_head=SMALL["num_attention_heads"],
              head_dim=64, slots=SLOTS, capacity=CAP, prefill_bucket=BUCKET,
              greedy_on_device=True, steps_per_dispatch=k)
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in requests]
    finished = eng.run()
    return eng, reqs, finished


def _requests(seed=0, n=5):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, SMALL["vocab_size"], int(rng.integers(3, 12))).tolist(),
             int(rng.integers(3, 14))) for _ in range(n)]


def _check_token_exact(cfg, layout, k, requests, sharpen):
    tm, jm = _models(cfg, _weights(cfg, sharpen), layout)
    teng, treqs, tfin = _serve(TEngine, tm, k, requests)
    jeng, jreqs, jfin = _serve(JEngine, jm, k, requests)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert [r.request_id for r in tfin] == [r.request_id for r in jfin]
    assert all(r.done and len(r.generated) == r.max_new_tokens for r in treqs)
    assert teng.steps == jeng.steps
    assert teng.stats()["decode_tokens"] == jeng.stats()["decode_tokens"]
    # The tokens depend on the context: not one token repeated.
    assert len({t for r in treqs for t in r.generated}) > len(treqs)
    return teng


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("layout,variant", [
    ("s8_head_major", "llama"), ("f32_head_major", "llama"), ("s8_cat", "llama"),
    ("s8_head_major", "qwen2_bias"), ("s8_head_major", "mistral_window"),
    ("f32_head_major", "mistral_window"),
])
def test_engine_token_exact(layout, variant, k):
    """5 requests on 3 slots (two re-admissions, prompts of 3 to 11 tokens
    in buckets of 8 and 16), steps_per_dispatch k: every request's tokens
    equal the JAX engine's, in the same order of completion."""
    _check_token_exact(_cfg(variant), layout, k, _requests(), sharpen=2.0)


@pytest.mark.parametrize("layout", ["s8_head_major", "f32_head_major"])
def test_engine_rotary_clamp_past_max_positions(layout):
    """max_position_embeddings 32: the long request stays below it, while
    the idle slots of a fused dispatch keep advancing their lengths past
    it. Rotary reads the tables clamped to their last row, as the JAX
    package's indexing does; the tokens stay equal to the JAX engine's."""
    cfg = _cfg(max_position_embeddings=32)
    rng = np.random.default_rng(1)
    prompt = lambda n: rng.integers(0, SMALL["vocab_size"], n).tolist()  # noqa: E731
    requests = [(prompt(3), 28), (prompt(11), 3), (prompt(10), 2)]
    eng = _check_token_exact(cfg, layout, 4, requests, sharpen=2.0)
    lens = eng._dev_state[1].numpy()
    assert lens.max() > cfg["max_position_embeddings"]


def test_rotary_clamps_like_jax_indexing():
    """Positions past the table read its last row, negative ones count
    from the end (jnp indexing); both rotary forms."""
    import jax.numpy as jnp
    from rten_tpu.ops.attention import _rotary as jrotary
    from rten_tpu_torch.ops.attention import rotary

    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 5, 64)).astype(np.float32)
    x[:, :, 3] = x[:, :, 2]
    cos = rng.standard_normal((6, 16)).astype(np.float32)  # rotates 32 of 64 dims
    sin = rng.standard_normal((6, 16)).astype(np.float32)
    pos = np.array([[0, 5, 6, 40, -1], [3, -6, -7, 2, 1]], np.int32)
    for interleaved in (False, True):
        got = rotary(torch.from_numpy(x), torch.from_numpy(cos), torch.from_numpy(sin),
                     torch.from_numpy(pos), interleaved).numpy()
        want = np.asarray(jrotary(jnp.asarray(x), cos, sin, jnp.asarray(pos), interleaved))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        # Positions 6 and 40 (the same x) both read row 5, the table's last.
        np.testing.assert_array_equal(got[0, :, 2], got[0, :, 3])


# --- what the slice does not cover raises ------------------------------------


@pytest.mark.parametrize("kwargs,item", [
    (dict(deferred_kv=True, gather_last=False), 10),
    (dict(kv_dtype=JDataType.BFloat16, deferred_kv=True, gather_last=False), 10),
    (dict(kv_dtype=JDataType.BFloat16, recent_dtype=JDataType.BFloat16, gather_last=False), 10),
    (dict(kv_quant=True, kv_bits=4, gather_last=False), 10),
    (dict(kv_quant=True, kv_bits=4, deferred_kv=True, gather_last=False), 10),
    (dict(kv_quant=True, gather_last=False), 10),
])
def test_builder_options_off_the_slice_raise(kwargs, item):
    """What the slice still does not build raises, naming its ROADMAP.md
    item: the full-bucket lm_head, on every cache form (f32/bf16 caches and
    pools are built: tests/test_torch_kv_dtypes.py; int4 and deferred KV:
    tests/test_torch_int4_kv.py, tests/test_torch_deferred_kv.py)."""
    from rten_tpu_torch.dtypes import DataType

    kwargs = {k: DataType[v.name] if isinstance(v, JDataType) else v for k, v in kwargs.items()}
    cfg = tllama.LlamaConfig(**SMALL)
    opts = dict(capacity=CAP, gather_last=True)
    opts.update(kwargs)
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md queue 1 item {item}"):
        tllama.build_graph_static_cache(cfg, tllama.random_weights(cfg), **opts)


def test_model_needs_a_card_or_an_explicit_cpu(monkeypatch):
    """With no card and no device, Model refuses before it optimizes."""
    cfg = _cfg()
    tg, _ = _graphs(cfg, tllama.random_weights(tllama.LlamaConfig(**cfg), 0), "s8_head_major")
    n_ops = len(list(tg.operators()))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TModel(tg)
    assert len(list(tg.operators())) == n_ops


def test_decode_mha_routes_by_rows_per_kv_head():
    """The decode step (S 1, group 8) takes the fold, an admission the
    per-head form; on CPU tensors both run the plain version."""
    q1 = torch.zeros(2, 32, 1, 64)
    q128 = torch.zeros(2, 32, 128, 64)
    k = torch.zeros(2, 4, 256, 64)
    lens = torch.zeros(2, dtype=torch.int32)
    calls = []
    orig = tfa.decode_mha_plain
    try:
        tfa.decode_mha_plain = lambda *a, **kw: calls.append(a[0].shape[2]) or orig(*a, **kw)
        tfa.decode_mha(q1, k, k, lens)
        tfa.decode_mha(q128, k, k, lens)
    finally:
        tfa.decode_mha_plain = orig
    assert calls == [1, 128]
    assert 32 // 4 * 1 <= tfa.FOLD_MAX_ROWS < 32 // 4 * 128
