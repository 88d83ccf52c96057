"""Multi-LoRA serving in the port: the GPT-2 builder's ``lora_rank`` branch
(stacked ``lora.*`` adapters and a ``slot_adapter`` input, each selected by
Gather, added through two Einsums), the Einsum op, and the engine's
adapter plumbing (``set_lora_adapters``, ``submit(adapter_id=)``).

Against the JAX package on the same seeded weights and adapters: the
graph, the Einsum op, and the engine token for token with three adapters
mixed in one batch at 1 and 4 steps a dispatch (the LoRA config of
tests/test_lora_serving.py: vocab 96, E 32, 4 heads, f32 weights). On the
port alone: adapter j gives the tokens of a model with A_j @ B_j merged
into its weights, adapter 0 (all zeros) those of the base model, and the
reference's refusals.
"""

import numpy as np
import pytest
import torch

from rten_tpu.model import Model as JModel
from rten_tpu.model import ModelOptions as JOptions
from rten_tpu.models import gpt2 as jgpt2
from rten_tpu.ops.einsum import _einsum as jeinsum
from rten_tpu.serving import ContinuousBatchingEngine as JEngine
from rten_tpu_torch.model import Model as TModel
from rten_tpu_torch.models import gpt2 as tgpt2
from rten_tpu_torch.ops.registry import get_op
from rten_tpu_torch.serving import ContinuousBatchingEngine as TEngine
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

CFG = dict(vocab_size=96, n_positions=64, n_embd=32, n_layer=2, n_head=4)
RANK, N_ADAPTERS = 4, 3
TARGETS = [("attn.c_attn", 32, 96), ("attn.c_proj", 32, 32)]
PROMPTS = [[5, 9, 23, 40], [7, 3, 60], [12, 44]]


def _adapters(seed=5):
    rng = np.random.default_rng(seed)
    by_name = {}
    for i in range(CFG["n_layer"]):
        for tgt, kin, kout in TARGETS:
            a = rng.standard_normal((N_ADAPTERS, kin, RANK)) * 0.3
            b = rng.standard_normal((N_ADAPTERS, RANK, kout)) * 0.3
            a[0] = b[0] = 0.0  # adapter 0: the base model
            by_name[f"lora.{i}.{tgt}.A"] = a.astype(np.float32)
            by_name[f"lora.{i}.{tgt}.B"] = b.astype(np.float32)
    return by_name


def _weights():
    w = tgpt2.random_weights(tgpt2.GPT2Config(**CFG), seed=2)
    return {k: v * np.float32(4) if (".attn." in k or ".mlp." in k) else v for k, v in w.items()}


def _merged(adapters, j):
    merged = {k: v.copy() for k, v in _weights().items()}
    for i in range(CFG["n_layer"]):
        for tgt, _, _ in TARGETS:
            merged[f"transformer.h.{i}.{tgt}.weight"] += (
                adapters[f"lora.{i}.{tgt}.A"][j] @ adapters[f"lora.{i}.{tgt}.B"][j])
    return merged


def _engine(cls, weights, k, **build):
    mod = tgpt2 if cls is TEngine else jgpt2
    g = mod.build_graph_static_cache(mod.GPT2Config(**CFG), weights, capacity=64, **build)
    model = TModel(g, device="cpu") if cls is TEngine else JModel(g, JOptions())
    return cls(model, n_layer=2, n_head=4, head_dim=8, slots=3, capacity=64, prefill_bucket=8,
               greedy_on_device=True, steps_per_dispatch=k)


def _lora_tokens(cls, k, ids=(0, 1, 2)):
    eng = _engine(cls, _weights(), k, lora_rank=RANK, n_adapters=N_ADAPTERS)
    eng.set_lora_adapters(_adapters())
    reqs = [eng.submit(p, max_new_tokens=8, adapter_id=j) for j, p in zip(ids, PROMPTS)]
    eng.run()
    return [r.generated for r in reqs]


@pytest.mark.parametrize("k", [1, 4])
def test_mixed_adapters_match_jax(k):
    got = _lora_tokens(TEngine, k)
    assert got == _lora_tokens(JEngine, k)
    assert len({t for g in got for t in g}) > 3


@pytest.mark.parametrize("k", [1, 4])
def test_each_adapter_matches_its_merged_model(k):
    """Request j under adapter j: the tokens of a model whose weights carry
    A_j @ B_j; one batch mixes all three adapters."""
    got = _lora_tokens(TEngine, k)
    for j, p in enumerate(PROMPTS):
        eng = _engine(TEngine, _merged(_adapters(), j), k)
        r = eng.submit(p, max_new_tokens=8)
        eng.run()
        assert got[j] == r.generated, j
    assert got != _lora_tokens(TEngine, k, ids=(0, 0, 0))


def test_einsum_op_matches_jax():
    """The LoRA graph's two contractions against the JAX lowering (f32 at
    HIGHEST precision)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32)
    a = rng.standard_normal((3, 32, 4)).astype(np.float32)
    b = rng.standard_normal((3, 4, 96)).astype(np.float32)
    einsum = get_op("Einsum").lower
    for eq, args in (("bse,ber->bsr", (x, a)), ("bsr,bro->bso", (x @ a, b))):
        got = einsum(None, [torch.from_numpy(t) for t in args], {"equation": eq})
        want = np.asarray(jeinsum(None, list(args), {"equation": eq}))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_lora_graph_matches_jax():
    w = _weights()
    tg = tgpt2.build_graph_static_cache(tgpt2.GPT2Config(**CFG), w, capacity=64,
                                        lora_rank=RANK, n_adapters=N_ADAPTERS)
    jg = jgpt2.build_graph_static_cache(jgpt2.GPT2Config(**CFG), w, capacity=64,
                                        lora_rank=RANK, n_adapters=N_ADAPTERS)
    sig = [(nid, g.node_name(nid), getattr(n, "op_type", None), getattr(n, "shape", None))
           for g in (tg,) for nid, n in sorted(g.nodes.items())]
    assert sig == [(nid, jg.node_name(nid), getattr(n, "op_type", None),
                    getattr(n, "shape", None)) for nid, n in sorted(jg.nodes.items())]
    assert sum(op.op_type == "Einsum" for _, op in tg.operators()) == 8
    with pytest.raises(ValueError, match="n_adapters"):
        tgpt2.build_graph_static_cache(tgpt2.GPT2Config(**CFG), w, capacity=64, lora_rank=2)


def test_lora_guards():
    """The reference's refusals: an adapter id on a graph without LoRA, a
    graph without LoRA given adapters, missing or misshapen adapters, an
    adapter id out of range (it would gather NaN on the device)."""
    base = _engine(TEngine, _weights(), 1)
    with pytest.raises(ValueError, match="lora_rank"):
        base.submit([1, 2], max_new_tokens=8, adapter_id=1)
    with pytest.raises(ValueError, match="lora_rank"):
        base.set_lora_adapters({})
    eng = _engine(TEngine, _weights(), 1, lora_rank=RANK, n_adapters=N_ADAPTERS)
    with pytest.raises(ValueError, match="missing adapter"):
        eng.set_lora_adapters({})
    bad = dict(_adapters())
    bad["lora.0.attn.c_attn.A"] = bad["lora.0.attn.c_attn.A"][:2]
    with pytest.raises(ValueError, match="expected shape"):
        eng.set_lora_adapters(bad)
    eng.set_lora_adapters(_adapters())
    for adapter_id in (N_ADAPTERS, -1):
        with pytest.raises(ValueError, match="out of range"):
            eng.submit([1, 2], max_new_tokens=8, adapter_id=adapter_id)
    r = eng.submit([1, 2], max_new_tokens=4, adapter_id=N_ADAPTERS - 1)
    eng.run()
    assert r.adapter_id == N_ADAPTERS - 1 and len(r.generated) == 4
    assert eng.slot_adapter[0] == N_ADAPTERS - 1
