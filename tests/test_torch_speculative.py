"""Speculative decoding in the port (``rten_tpu_torch/serving/speculative.py``):
a draft proposes gamma tokens a round, the target verifies them in one
S = gamma + 1 forward at per-slot lengths and keeps the longest matching
prefix, so the tokens are the target's greedy ones whatever the draft.

Against the JAX package's SpeculativeEngine on the same seeded weights,
token for token, at (draft seed, gamma) in (0, 4), (99, 4), (99, 2); then
the properties of tests/test_speculative.py on the port alone (the plain
greedy engine's tokens, a perfect draft accepting every round, eos within
a round, slot reuse, the capacity guard, a shared prefix) and the
reference's refusals.

The config of tests/test_speculative.py (vocab 96, E 64, 4 heads, f32
weights and caches, cap 128, 2 slots) with the attention and MLP weights
sharpened 4x, so that greedy tokens depend on the context and an unrelated
draft is often rejected.
"""

import numpy as np
import pytest

from rten_tpu.model import Model as JModel
from rten_tpu.model import ModelOptions as JOptions
from rten_tpu.models import gpt2 as jgpt2
from rten_tpu.serving import SpeculativeEngine as JSpec
from rten_tpu_torch.generate.sampler import DeviceSampler
from rten_tpu_torch.model import Model as TModel
from rten_tpu_torch.models import gpt2 as tgpt2
from rten_tpu_torch.serving import ContinuousBatchingEngine as TEngine
from rten_tpu_torch.serving import SpeculativeEngine as TSpec
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

PROMPTS = [[5, 9, 23, 40], [7, 3, 60, 11, 2]]
ENGINE = dict(n_head=4, head_dim=16, slots=2, capacity=128, prefill_bucket=8)


def _cfg(n_layer=2):
    return dict(vocab_size=96, n_positions=128, n_embd=64, n_layer=n_layer, n_head=4)


def _model(mod, n_layer=2, seed=0, **build):
    w = mod.random_weights(mod.GPT2Config(**_cfg(n_layer)), seed=seed)
    w = {k: v * np.float32(4) if (".attn." in k or ".mlp." in k) else v for k, v in w.items()}
    g = mod.build_graph_static_cache(mod.GPT2Config(**_cfg(n_layer)), w, capacity=128, **build)
    return TModel(g, device="cpu") if mod is tgpt2 else JModel(g, JOptions())


def _spec(cls, mod, draft_seed, gamma, slots=2, draft_layers=1):
    return cls(_model(mod), _model(mod, draft_layers, draft_seed), gamma=gamma, n_layer=2,
               **{**ENGINE, "slots": slots})


def _greedy(n_new=12, prompts=PROMPTS, **kw):
    eng = TEngine(_model(tgpt2), n_layer=2, greedy_on_device=True, **ENGINE, **kw)
    reqs = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
    eng.run()
    return [r.generated for r in reqs]


def _run(eng, n_new=12):
    reqs = [eng.submit(p, max_new_tokens=n_new) for p in PROMPTS]
    eng.run()
    return [r.generated for r in reqs]


@pytest.mark.parametrize("draft_seed,gamma", [(0, 4), (99, 4), (99, 2)])
def test_speculative_matches_jax_and_plain_greedy(draft_seed, gamma):
    teng = _spec(TSpec, tgpt2, draft_seed, gamma)
    got = _run(teng)
    assert got == _run(_spec(JSpec, jgpt2, draft_seed, gamma))
    assert got == _greedy()
    assert 1.0 <= teng.stats()["spec_tokens_per_round"] <= gamma + 1
    assert len({t for g in got for t in g}) > 3


def test_unrelated_draft_is_rejected_and_perfect_draft_accepted():
    """A draft of other weights loses rounds; the target as its own draft
    accepts all gamma + 1 tokens of every round."""
    unrelated = _spec(TSpec, tgpt2, 99, 4)
    _run(unrelated)
    assert unrelated.stats()["spec_tokens_per_round"] < 5
    perfect = _spec(TSpec, tgpt2, 0, 4, draft_layers=2)
    assert _run(perfect, 15) == _greedy(15)
    assert perfect.stats()["spec_tokens_per_round"] == pytest.approx(5)


def test_eos_within_a_round_and_slot_reuse():
    """An eos mid-round trims the accepted block (the first eos wins); a
    freed slot re-admits from the queue with the draft caches in sync."""
    want = _greedy(10)
    eos = want[0][4]
    eng = _spec(TSpec, tgpt2, 7, 3, slots=1)
    r1 = eng.submit(PROMPTS[0], max_new_tokens=10, eos_id=eos)
    r2 = eng.submit(PROMPTS[1], max_new_tokens=6)
    eng.run()
    cut = want[0].index(eos) + 1
    assert r1.generated == want[0][:cut] and r1.generated[-1] == eos
    assert r2.generated == want[1][:6]


def test_with_shared_prefix():
    """The target admits through the prefix path, the draft prefills the
    whole prompt: the plain engine's tokens with the same prefix."""
    prefix = [11, 3, 42, 9]
    prompts = [prefix + s for s in ([5, 9], [7, 3, 60])]
    plain = TEngine(_model(tgpt2), n_layer=2, greedy_on_device=True, **ENGINE)
    plain.set_shared_prefix(prefix)
    want = [plain.submit(p, max_new_tokens=10) for p in prompts]
    plain.run()
    eng = _spec(TSpec, tgpt2, 3, 3)
    eng.set_shared_prefix(prefix)
    got = [eng.submit(p, max_new_tokens=10) for p in prompts]
    eng.run()
    assert [r.generated for r in got] == [r.generated for r in want]


def test_restart_resyncs_the_draft():
    want = _greedy()
    eng = _spec(TSpec, tgpt2, 99, 4)
    reqs = [eng.submit(p, max_new_tokens=12) for p in PROMPTS]
    eng.step()
    eng.step()
    assert eng.restart()
    assert not any(c.any() for c in eng.draft_caches) and not eng.slot_prev_tok.any()
    eng.run()
    assert [r.generated for r in reqs] == want


def test_refusals():
    """The reference's ValueErrors: a sampler, steps_per_dispatch, a
    deferred, gather_last or paged target, a deferred draft, and prompts
    without the headroom of a round."""
    target, draft = _model(tgpt2), _model(tgpt2, 1, 3)
    kw = dict(n_layer=2, **ENGINE)
    with pytest.raises(ValueError, match="greedy-only"):
        TSpec(target, draft, device_sampler=DeviceSampler(temperature=0.8), **kw)
    with pytest.raises(ValueError, match="owned by speculation"):
        TSpec(target, draft, steps_per_dispatch=4, **kw)
    for build, match in ((dict(kv_quant=True, kv_bits=4, deferred_kv=True), "deferred_kv"),
                         (dict(gather_last=True), "gather_last"),
                         (dict(paged_blocks=9, block_size=16), "paged")):
        with pytest.raises(ValueError, match=match):
            TSpec(_model(tgpt2, **build), draft, **kw)
    with pytest.raises(ValueError, match="draft graph"):
        TSpec(target, _model(tgpt2, 1, 3, kv_quant=True, kv_bits=4, deferred_kv=True), **kw)
    eng = TSpec(target, draft, gamma=4, **kw)
    with pytest.raises(ValueError, match="headroom"):
        eng.submit(list(range(1, 60)), max_new_tokens=65)
