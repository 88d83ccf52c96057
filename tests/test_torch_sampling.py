"""Sampling in the port (``rten_tpu_torch/generate/sampler.py`` and the
engine's host and device sampling) against the JAX package's.

* ``DeviceSampler.transform`` against the jitted reference (under jit XLA
  multiplies by the temperature's f32 reciprocal): the -inf masks equal,
  the kept values within 1 ulp, for the four samplers of
  tests/test_device_sampling.py; at the hard config's [96, 50257] the
  port's f64 top-p sum may flip a mask only within 1e-6 of top_p.
* ``DeviceSampler.sample`` fed ``jax.random.gumbel`` of the reference's
  sub-key picks the reference's tokens; ``sample_host`` is the reference's
  numpy code, token for token.
* The engine token for token against the JAX engine: host ArgMaxSampler,
  host MultinomialSampler (sharpened weights, so the draws do not sit on
  near ties), near-zero temperature on the device, and the admissions of a
  device-sampled engine (drawn on the host from the seed's numpy
  generator, as in the reference).
* The properties of tests/test_device_sampling.py on the port's own
  engine: the fused dispatch kept, seed determinism, restart resets the
  sampling state, top_k 1 and temperature 1e-6 equal greedy.

Small GPT-2 (2 layers, E 128, H 2, D 64, vocab 512), 3 slots, cap 64.
"""

import jax
import numpy as np
import pytest
import torch

from rten_tpu.generate.sampler import ArgMaxSampler as JArgMax
from rten_tpu.generate.sampler import DeviceSampler as JDS
from rten_tpu.generate.sampler import MultinomialSampler as JMultinomial
from rten_tpu.model import Model as JModel
from rten_tpu.model import ModelOptions as JOptions
from rten_tpu.models import gpt2 as jgpt2
from rten_tpu.quantize_pass import quantize_dynamic as jquantize
from rten_tpu.serving import ContinuousBatchingEngine as JEngine
from rten_tpu_torch.generate.sampler import ArgMaxSampler as TArgMax
from rten_tpu_torch.generate.sampler import DeviceSampler as TDS
from rten_tpu_torch.generate.sampler import MultinomialSampler as TMultinomial
from rten_tpu_torch.model import Model as TModel
from rten_tpu_torch.models import gpt2 as tgpt2
from rten_tpu_torch.quantize_pass import quantize_dynamic as tquantize
from rten_tpu_torch.serving import ContinuousBatchingEngine as TEngine
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

SAMPLERS = [dict(temperature=0.7), dict(top_k=5), dict(top_p=0.8),
            dict(temperature=0.9, top_k=10, top_p=0.9)]
SMALL = dict(vocab_size=512, n_positions=128, n_embd=128, n_layer=2, n_head=2)
BUILD = dict(capacity=64, kv_quant=True, kernel_append=True, gather_last=True)
TOP_P_BAND = 1e-6  # the band around top_p where the f64 and f32 nuclei may differ


def _logits(seed, shape=(4, 50), scale=3.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("spec", SAMPLERS)
@pytest.mark.parametrize("seed", [0, 1])
def test_transform_matches_jitted_reference(spec, seed):
    logits = _logits(seed)
    want = np.asarray(jax.jit(JDS(**spec).transform)(logits))
    got = TDS(**spec).transform(torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    kept = ~np.isinf(want)
    assert _ulps(got[kept], want[kept]).max() <= 1
    # The kept set is the numpy mirror's too.
    np.testing.assert_array_equal(np.isinf(got), np.isinf(TDS(**spec).transform_host(logits)))


def test_transform_at_the_full_vocabulary_against_jitted_reference():
    """At [96, 50257] the port sums the top-p softmax in f64 (an f32 sum
    over 50k tokens depends on the device's order) where the reference sums
    in f32: a mask may differ only on a token whose exclusive cumulative
    probability lies within TOP_P_BAND of top_p (N(0, 1) logits, the
    widest nucleus: about 26k tokens kept a row). Kept values within 1 ulp."""
    spec = dict(temperature=0.8, top_p=0.9)
    logits = _logits(0, (96, 50257), scale=1.0)
    want = np.asarray(jax.jit(JDS(**spec).transform)(logits))
    got = TDS(**spec).transform(torch.from_numpy(logits))
    pre = TDS(temperature=0.8).transform(torch.from_numpy(logits))
    sx, order = torch.sort(pre, dim=-1, descending=True)
    probs = torch.softmax(sx.double(), dim=-1)
    gap = torch.zeros_like(probs).scatter(-1, order, (torch.cumsum(probs, -1) - probs - 0.9).abs())
    got = got.numpy()
    differ = np.isinf(got) != np.isinf(want)
    assert not differ[gap.numpy() >= TOP_P_BAND].any()
    assert differ.sum() <= 4  # 1 of 4.8M on these logits
    kept = ~np.isinf(want) & ~differ
    assert kept.sum() > 96 * 20000
    assert _ulps(got[kept], want[kept]).max() <= 1


def test_top_k_keeps_ties_with_the_kth_value():
    logits = np.array([[3.0, 1.0, 2.0, 2.0, 2.0, 0.5]], np.float32)
    want = np.asarray(jax.jit(JDS(top_k=2).transform)(logits))
    got = TDS(top_k=2).transform(torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (~np.isinf(got)).sum() == 4


@pytest.mark.parametrize("spec,seed", [(s, i) for i, s in enumerate(
    SAMPLERS + [dict(temperature=0.8, top_k=40)])])
def test_sample_with_the_reference_gumbel_noise_matches(spec, seed):
    """The reference draws ``jax.random.categorical(sub, transform(x))``
    with ``key, sub = split(key)``: fed ``jax.random.gumbel(sub)``, the
    port's Gumbel-max picks the same tokens."""
    logits = _logits(seed, (6, 512))
    jds = JDS(seed=seed, **spec)
    key = jds.init_key()
    want, _ = jax.jit(jds.sample)(logits, key)
    _, sub = jax.random.split(key)
    noise = np.array(jax.random.gumbel(sub, logits.shape))
    got, gen = TDS(seed=seed, **spec).sample(torch.from_numpy(logits), None,
                                             noise=torch.from_numpy(noise))
    assert gen is None
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32


@pytest.mark.parametrize("spec", SAMPLERS)
def test_sample_host_matches_reference(spec):
    logits = _logits(5, (5, 80))
    want = JDS(**spec).sample_host(logits, np.random.default_rng(9))
    got = TDS(**spec).sample_host(logits, np.random.default_rng(9))
    np.testing.assert_array_equal(got, want)


def test_sample_draws_from_the_generator():
    """Drawn from an explicit generator: the same seed gives the same
    tokens, every token is a kept one, and the generator advances."""
    logits = torch.from_numpy(_logits(2, (8, 512)))
    ds = TDS(temperature=0.8, top_k=20, top_p=0.9, seed=4)
    a, gen = ds.sample(logits, ds.init_generator("cpu"))
    b, gen = ds.sample(logits, gen)
    c, _ = ds.sample(logits, ds.init_generator("cpu"))
    assert torch.equal(a, c) and not torch.equal(a, b)
    kept = ~torch.isinf(ds.transform(logits))
    assert kept.gather(1, a.long()[:, None]).all() and kept.gather(1, b.long()[:, None]).all()


# --- the engine ------------------------------------------------------------------


def _weights(sharpen):
    w = tgpt2.random_weights(tgpt2.GPT2Config(**SMALL), seed=0)
    return {k: v * np.float32(sharpen) if (".attn." in k or ".mlp." in k) else v
            for k, v in w.items()}


@pytest.fixture(scope="module")
def models():
    """(port model, JAX model) on weights sharpened 10x, shared by the
    module's engines so that the JAX engines reuse their compiled steps."""
    w = _weights(10.0)
    tg = tgpt2.build_graph_static_cache(tgpt2.GPT2Config(**SMALL), w, **BUILD)
    jg = jgpt2.build_graph_static_cache(jgpt2.GPT2Config(**SMALL), w, **BUILD)
    tquantize(tg)
    jquantize(jg)
    return {10.0: (TModel(tg, device="cpu"), JModel(jg, JOptions()))}


def _run(cls, model, k=1, **kw):
    eng = cls(model, n_layer=2, n_head=2, head_dim=64, slots=3, capacity=64,
              prefill_bucket=8, steps_per_dispatch=k, **kw)
    rng = np.random.default_rng(0)
    reqs = [eng.submit(rng.integers(0, 512, int(rng.integers(3, 9))).tolist(),
                       max_new_tokens=int(rng.integers(3, 14))) for _ in range(5)]
    eng.run()
    return eng, [r.generated for r in reqs]


@pytest.mark.parametrize("case", ["argmax", "multinomial", "near_zero_temperature"])
def test_engine_sampling_matches_jax(models, case):
    """Host sampling fetches the logits (the argmax kernel does not run)
    and steps one token a dispatch; near-zero temperature samples on the
    device inside the fused dispatch: the JAX engine's tokens."""
    tm, jm = models[10.0]
    kw = {
        "argmax": lambda T: dict(sampler=(TArgMax if T else JArgMax)()),
        "multinomial": lambda T: dict(sampler=(TMultinomial if T else JMultinomial)(seed=3)),
        "near_zero_temperature": lambda T: dict(
            device_sampler=(TDS if T else JDS)(temperature=1e-6, seed=1)),
    }[case]
    k = 4 if case == "near_zero_temperature" else 1
    teng, got = _run(TEngine, tm, k, **kw(True))
    _, want = _run(JEngine, jm, k, **kw(False))
    assert got == want
    assert not teng.greedy_on_device and teng.g.node_name(teng.out_ids[0]) == "logits"
    assert teng.steps_per_dispatch == k
    assert len({t for g in got for t in g}) > 3


def test_device_sampled_admissions_match_jax(models):
    """A device-sampled engine draws each admission's first token on the
    host from a numpy generator seeded like the sampler: the JAX engine's
    first tokens (the later ones come from the device's generator)."""
    tm, jm = models[10.0]
    _, got = _run(TEngine, tm, 4, device_sampler=TDS(temperature=0.8, top_k=20, seed=7))
    _, want = _run(JEngine, jm, 4, device_sampler=JDS(temperature=0.8, top_k=20, seed=7))
    assert [g[0] for g in got] == [w[0] for w in want]
    assert [len(g) for g in got] == [len(w) for w in want]


def test_sampled_serving_keeps_fused_dispatch(models):
    eng, toks = _run(TEngine, models[10.0][0], 4,
                     device_sampler=TDS(temperature=0.8, top_k=20, seed=7))
    assert eng.steps_per_dispatch == 4 and not eng.greedy_on_device
    assert all(len(t) > 0 for t in toks)
    assert eng.steps % 4 == 0


def test_sampling_deterministic_for_a_fixed_seed(models):
    tm = models[10.0][0]
    runs = [_run(TEngine, tm, 4, device_sampler=TDS(temperature=0.8, top_k=20, seed=s))[1]
            for s in (123, 123, 124)]
    assert runs[0] == runs[1]
    assert runs[0] != runs[2]


@pytest.mark.parametrize("spec", [dict(top_k=1), dict(temperature=1e-6)])
def test_degenerate_samplers_match_greedy(models, spec):
    tm = models[10.0][0]
    _, want = _run(TEngine, tm, 4, greedy_on_device=True)
    _, got = _run(TEngine, tm, 4, device_sampler=TDS(seed=2, **spec))
    assert got == want


def test_restart_resets_sampling_state(models):
    """A sampled request restarted mid-flight regenerates the tokens of an
    engine that never restarted (both generators reseeded)."""
    tm = models[10.0][0]
    ds = TDS(temperature=0.8, top_k=20, seed=5)

    def engine():
        return TEngine(tm, n_layer=2, n_head=2, head_dim=64, slots=3, capacity=64,
                       prefill_bucket=8, steps_per_dispatch=4, device_sampler=ds)

    first = engine()
    r1 = first.submit([3, 14, 15], max_new_tokens=12)
    first.run()
    second = engine()
    r2 = second.submit([3, 14, 15], max_new_tokens=12)
    second.step()
    assert r2.generated and not r2.done
    assert r2 in second.restart() and not r2.generated
    second.run()
    assert r2.generated == r1.generated
    third = engine()
    r3 = third.submit([3, 14, 15], max_new_tokens=12)
    third.step()
    third.fail_inflight("boom")
    assert r3.error == "boom"
    r4 = third.submit([3, 14, 15], max_new_tokens=12)
    third.run()
    assert r4.generated == r1.generated
