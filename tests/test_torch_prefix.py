"""Shared-prefix caching in the port's engine (``set_shared_prefix``),
against the JAX engine on the same seeded weights: slot-major caches (f32
and int8 head-major, int8 cat with the in-kernel append), where the cached
prefix rows are stamped into each admission's fresh caches, and paged pools,
where the prefix's full blocks are shared read-only through every table row
and its boundary block is copied into each admitted slot's first own block.
Then the reference's checks and its accounting of the prefix's blocks, on
the port alone.

Small GPT-2 (2 layers, E 128, H 2, D 64, vocab 512, weights sharpened 10x),
3 slots, cap 64, prefill bucket 8; a 19-token prefix (one full block of 16
and a boundary block on pools of 16-row blocks).
"""

import numpy as np
import pytest

from rten_tpu.model import Model as JModel
from rten_tpu.model import ModelOptions as JOptions
from rten_tpu.models import gpt2 as jgpt2
from rten_tpu.quantize_pass import quantize_dynamic as jquantize
from rten_tpu.serving import ContinuousBatchingEngine as JEngine
from rten_tpu_torch.model import Model as TModel
from rten_tpu_torch.models import gpt2 as tgpt2
from rten_tpu_torch.quantize_pass import quantize_dynamic as tquantize
from rten_tpu_torch.serving import ContinuousBatchingEngine as TEngine
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

SMALL = dict(vocab_size=512, n_positions=128, n_embd=128, n_layer=2, n_head=2)
PREFIX = [11, 3, 42, 9, 27, 60, 100, 200, 300, 400, 5, 6, 7, 8, 9, 10, 11, 12, 13]
PAGED = dict(paged_blocks=8, block_size=16)
FORMS = {
    "f32": dict(kv_quant=False),
    "s8": dict(kv_quant=True),
    "s8_cat": dict(kv_quant=True, kernel_append=True, gather_last=True),
    "s8_cat_paged": dict(kv_quant=True, kernel_append=True, gather_last=True, **PAGED),
    "s8_paged": dict(kv_quant=True, **PAGED),
}


def _weights(sharpen=10.0):
    w = tgpt2.random_weights(tgpt2.GPT2Config(**SMALL), seed=0)
    return {k: v * np.float32(sharpen) if (".attn." in k or ".mlp." in k) else v
            for k, v in w.items()}


def _model(mod, form, quantize=True, **extra):
    g = mod.build_graph_static_cache(mod.GPT2Config(**SMALL), _weights(), capacity=64,
                                     **FORMS[form], **extra)
    if quantize:
        (tquantize if mod is tgpt2 else jquantize)(g)
    return TModel(g, device="cpu") if mod is tgpt2 else JModel(g, JOptions())


def _engine(cls, model, k=4, **kw):
    return cls(model, n_layer=2, n_head=2, head_dim=64, slots=3, capacity=64,
               prefill_bucket=8, greedy_on_device=True, steps_per_dispatch=k, **kw)


def _wave(prefix=PREFIX, n=5, seed=0):
    rng = np.random.default_rng(seed)
    return [(list(prefix) + rng.integers(0, 512, int(rng.integers(1, 9))).tolist(),
             int(rng.integers(3, 14))) for _ in range(n)]


def _serve(eng, wave):
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in wave]
    eng.run()
    return [r.generated for r in reqs]


def _prefixed(eng, prefix=PREFIX):
    eng.set_shared_prefix(prefix)
    return _serve(eng, _wave(prefix))


@pytest.mark.parametrize("form", ["f32", "s8", "s8_cat", "s8_cat_paged"])
def test_prefix_token_exact_against_jax(form):
    """5 requests over 3 slots (re-admissions reuse the prefix): the JAX
    engine's tokens; a paged engine holds exactly the prefix's blocks at the
    end."""
    teng = _engine(TEngine, _model(tgpt2, form))
    got = _prefixed(teng)
    want = _prefixed(_engine(JEngine, _model(jgpt2, form)))
    assert got == want
    assert len({t for g in got for t in g}) > 5
    if teng.paged:
        assert teng._prefix_shared == [1] and teng._prefix_tmpl == 2
        assert sorted(teng._free_blocks) == list(range(3, teng.n_blocks))


@pytest.mark.parametrize("form", ["s8_cat", "s8_paged"])
def test_prefix_equals_full_prefill_on_f32_weights(form):
    """With f32 weights (no per-tensor activation scale to move) a prefixed
    engine gives the tokens of an engine that prefills whole prompts."""
    model = _model(tgpt2, form, quantize=False)
    want = _serve(_engine(TEngine, model), _wave())
    assert _prefixed(_engine(TEngine, model)) == want


def test_paged_prefix_blocks_and_pool():
    """The prefix reserves its full blocks and a template once; each
    request owns its blocks past the shared ones; restart() and
    fail_inflight() write the prefix into the zeroed pool again (the same
    tokens after; f32 weights, so that the order of re-admission moves no
    activation scale); clearing the prefix returns every block."""
    model = _model(tgpt2, "s8_cat_paged", quantize=False)
    eng = _engine(TEngine, model)
    eng.set_shared_prefix(PREFIX)
    assert eng._prefix_nblocks == 2 and len(eng._free_blocks) == eng.n_blocks - 3
    # 19 + 8 prompt tokens, 13 new, 2 x 4 of overrun: 48 rows, 3 blocks, 1 shared.
    assert eng._blocks_needed(27, 13) == 2
    first = _serve(eng, _wave())
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in _wave()]
    eng.step()
    assert all(row[0] == 1 for row, r in zip(eng.block_table, eng.slot_req) if r is not None)
    eng.restart()
    assert not any(eng._slot_blocks) and len(eng._free_blocks) == eng.n_blocks - 3
    eng.run()
    assert [r.generated for r in reqs] == first
    eng.submit(*_wave()[0])
    eng.step()
    eng.fail_inflight("boom")
    assert _serve(eng, _wave()) == first
    eng.set_shared_prefix([])
    assert eng.prefix_tokens is None and sorted(eng._free_blocks) == list(range(1, eng.n_blocks))
    assert eng._blocks_needed(27, 13) == 3


def test_prefix_checks():
    """The reference's refusals, each a ValueError at the call: a prompt
    that does not extend the prefix, a busy engine, a prefix past the
    capacity, a pool too small to keep a block for requests, a one-token
    prefix on a deferred graph, a LoRA graph; an empty prefix clears it."""
    model = _model(tgpt2, "s8_cat")
    eng = _engine(TEngine, model)
    eng.set_shared_prefix(PREFIX)
    with pytest.raises(ValueError, match="extend it"):
        eng.submit(PREFIX, max_new_tokens=4)
    with pytest.raises(ValueError, match="extend it"):
        eng.submit([9] + PREFIX[1:] + [5], max_new_tokens=4)
    eng.submit(PREFIX + [5], max_new_tokens=4)
    with pytest.raises(ValueError, match="idle"):
        eng.set_shared_prefix(PREFIX)
    eng.run()
    with pytest.raises(ValueError, match="capacity"):
        eng.set_shared_prefix(list(range(64)))
    eng.set_shared_prefix([])
    r = eng.submit([1, 2, 3], max_new_tokens=4)
    eng.run()
    assert len(r.generated) == 4
    small_pool = _engine(TEngine, _model(tgpt2, "s8_cat", paged_blocks=4, block_size=16))
    with pytest.raises(ValueError, match="reclaimable"):
        small_pool.set_shared_prefix(list(range(1, 40)))  # 3 blocks of the 3
    assert small_pool.prefix_tokens is None
    deferred = _engine(TEngine, _model(tgpt2, "s8", quantize=True, kv_bits=4, deferred_kv=True))
    with pytest.raises(ValueError, match=">= 2 tokens"):
        deferred.set_shared_prefix([7])
    lora = _engine(TEngine, _model(tgpt2, "s8_cat", lora_rank=2, n_adapters=2))
    with pytest.raises(ValueError, match="LoRA"):
        lora.set_shared_prefix(PREFIX)
