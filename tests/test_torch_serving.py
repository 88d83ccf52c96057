"""The port's serving path against the JAX package's, end to end, at a
small GPT-2 (2 layers, E=128, H=2, D=64, vocab 512, cap 64): the model's
admission forward and decode steps on identical inputs, and the
continuous-batching engine token for token.

Both packages build their graph from the same seeded weights. JAX runs on
the CPU (its kernels take their XLA fallbacks); the port runs on the CPU,
where each kernel wrapper runs its plain PyTorch version.
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
from rten_tpu_torch.serving import QueueFull
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

SMALL = dict(vocab_size=512, n_positions=128, n_embd=128, n_layer=2, n_head=2)
SLOTS, CAP, BUCKET = 3, 64, 8
MAIN_PATH = dict(capacity=CAP, kv_quant=True, kernel_append=True, gather_last=True)


def _weights(sharpen: float = 1.0):
    """``random_weights(seed=0)``; ``sharpen`` scales the attention and MLP
    weights so that greedy tokens depend on the context (at GPT-2's
    initialization scale the tied lm_head mostly repeats the input)."""
    w = tgpt2.random_weights(tgpt2.GPT2Config(**SMALL), seed=0)
    for name in w:
        if ".attn." in name or ".mlp." in name:
            w[name] = w[name] * np.float32(sharpen)
    return w


def _models(weights):
    tg = tgpt2.build_graph_static_cache(tgpt2.GPT2Config(**SMALL), weights, **MAIN_PATH)
    jg = jgpt2.build_graph_static_cache(jgpt2.GPT2Config(**SMALL), weights, **MAIN_PATH)
    tquantize(tg)
    jquantize(jg)
    return TModel(tg, device="cpu"), JModel(jg, JOptions(optimize=True))


def _engine(cls, model, k, **kw):
    kw = {"greedy_on_device": True, **kw}
    return cls(model, n_layer=SMALL["n_layer"], n_head=SMALL["n_head"], head_dim=64,
               slots=SLOTS, capacity=CAP, prefill_bucket=BUCKET, steps_per_dispatch=k, **kw)


# --- the model: one admission forward, then three decode steps --------------


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_model_forward_and_decode_match_jax(seed):
    """next_token equal; logits within 1e-3 * max|logit|; cache scales to
    rtol 1e-5; s8 caches equal in >= 99.9 % of entries and off by at most
    1 elsewhere (torch and XLA reduce in different orders, and one ulp can
    move a value across a .5 rounding boundary).

    The weights are sharpened: at GPT-2's initialization scale the
    residual stream is ~0.1 wide and each LayerNorm multiplies the effect
    of a one-step u8 flip in an activation by ~30, so one flip moves the
    logits by ~5e-3 of their maximum. The engine test below runs the
    initialization scale token for token."""
    tm, jm = _models(_weights(10.0))
    cache_names = [n for n, _, _ in tm.input_info() if n.startswith("past_key_values.")]
    present = ["present." + n[len("past_key_values."):] for n in cache_names]
    rng = np.random.default_rng(seed)
    T = BUCKET
    ids = rng.integers(0, SMALL["vocab_size"], (SLOTS, T)).astype(np.int32)
    last = np.array([T - 1, 3, 0], np.int32)
    feed = {
        "input_ids": ids, "past_lens": np.zeros(SLOTS, np.int32),
        "position_ids": np.tile(np.arange(T, dtype=np.int32), (SLOTS, 1)),
        "last_pos": last,
    }
    for name, dt, shape in tm.input_info():
        if name.startswith("past_key_values."):
            feed[name] = np.zeros((SLOTS,) + tuple(shape[1:]), dt.np_dtype)
    tfeed, jfeed = dict(feed), dict(feed)
    lens = last + 1
    outs = ["logits", "next_token"] + present
    for step in range(4):
        got = [t.numpy() for t in tm.run(tfeed, outs)]
        want = [np.asarray(a) for a in jm.run(jfeed, outs)]
        np.testing.assert_array_equal(got[1], want[1], err_msg=f"step {step}")
        scale = np.abs(want[0]).max()
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-3 * scale)
        for name, g, w in zip(present, got[2:], want[2:]):
            if name.endswith("_scale"):
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=0, err_msg=name)
            else:
                diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
                assert diff.max() <= 1, name
                assert (diff == 0).mean() >= 0.999, name
        tok = want[1][:, :1].astype(np.int32)
        step_feed = {"input_ids": tok, "past_lens": lens, "position_ids": lens[:, None],
                     "last_pos": np.zeros(SLOTS, np.int32)}
        tfeed = {**step_feed, **{c: g for c, g in zip(cache_names, got[2:])}}
        jfeed = {**step_feed, **{c: w for c, w in zip(cache_names, want[2:])}}
        lens = lens + 1


# --- the engine: token-exact against the JAX engine -------------------------


def _serve(cls, model, k, seed=0):
    eng = _engine(cls, model, k)
    rng = np.random.default_rng(seed)
    reqs = [
        eng.submit(rng.integers(0, SMALL["vocab_size"], int(rng.integers(3, 12))).tolist(),
                   max_new_tokens=int(rng.integers(3, 14)))
        for _ in range(5)
    ]
    finished = eng.run()
    return eng, reqs, finished


@pytest.mark.parametrize("sharpen", [1.0, 10.0])
@pytest.mark.parametrize("k", [1, 4])
def test_engine_token_exact(k, sharpen):
    """5 requests on 3 slots (two re-admissions), steps_per_dispatch k:
    every request's tokens equal the JAX engine's, in the same order of
    completion."""
    tm, jm = _models(_weights(sharpen))
    teng, treqs, tfin = _serve(TEngine, tm, k)
    jeng, jreqs, jfin = _serve(JEngine, jm, k)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert [r.request_id for r in tfin] == [r.request_id for r in jfin]
    assert all(r.done and len(r.generated) == r.max_new_tokens for r in treqs)
    assert teng.steps == jeng.steps
    assert teng.stats()["decode_tokens"] == jeng.stats()["decode_tokens"]


def test_engine_cancel_queue_full_and_timeouts():
    tm, _ = _models(_weights())
    eng = _engine(TEngine, tm, 4, max_queue=4)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, 5).tolist() for _ in range(5)]
    reqs = [eng.submit(p, max_new_tokens=6) for p in prompts[:4]]
    with pytest.raises(QueueFull):
        eng.submit(prompts[4], max_new_tokens=6)
    with pytest.raises(ValueError):
        eng.submit([], max_new_tokens=4)
    with pytest.raises(ValueError):
        eng.submit(prompts[0], max_new_tokens=CAP)
    # Cancel a queued request: it never runs.
    assert eng.cancel(reqs[3])
    assert reqs[3].done and reqs[3].cancelled and reqs[3].generated == []
    eng.step()  # admits the first three
    assert eng.health()["active_slots"] == 3
    # Cancel a running request: its slot frees at the next step.
    assert eng.cancel(reqs[1])
    late = eng.submit(prompts[4], max_new_tokens=6, timeout_s=0.0)
    eng.step()
    assert reqs[1].done and reqs[1].cancelled and eng.slot_req[1] is None
    assert late.done and late.timed_out and late.generated == []
    eng.run()
    assert reqs[0].done and len(reqs[0].generated) == 6
    assert not eng.cancel(reqs[0])  # already finished
    h, st = eng.health(), eng.stats()
    assert h["status"] == "ok" and h["queued"] == 0 and h["active_slots"] == 0
    assert st["finished_requests"] == 5 and st["ttft_p50_s"] is not None
    drained = eng.drain_finished()
    assert {r.request_id for r in drained} == {r.request_id for r in reqs + [late]}
    assert eng.drain_finished() == []


@pytest.mark.parametrize("kwargs", [
    dict(chunked_prefill=True),
    dict(pipeline_dispatch=True),
    dict(dispatches_per_drain=2),
    dict(device_sampler="temperature 0.8, top-k 20, seed 0"),
    dict(greedy_on_device=False),
])
def test_engine_options_off_the_slice_raise(kwargs):
    """Options an earlier slice refused, now served as the JAX engine serves
    them (tests/test_torch_chunked.py and tests/test_torch_sampling.py hold
    each token for token against it): pipelined dispatch, 2 dispatches a
    drain and host sampling (greedy_on_device=False, one step a dispatch)
    give the serial greedy engine's tokens; chunked prefill (its chunks move the per-tensor
    activation scale) and a device sampler serve every request its tokens,
    all in the vocabulary."""
    from rten_tpu_torch.generate.sampler import DeviceSampler

    tg = tgpt2.build_graph_static_cache(tgpt2.GPT2Config(**SMALL), _weights(10.0), **MAIN_PATH)
    tquantize(tg)
    tm = TModel(tg, device="cpu")
    opts = dict(kwargs)
    if "device_sampler" in opts:
        opts["device_sampler"] = DeviceSampler(temperature=0.8, top_k=20, seed=0)
    # Host sampling steps one token a dispatch: the serial engine at k 1.
    k = 1 if kwargs.get("greedy_on_device") is False else 4
    _, want, _ = _serve(TEngine, tm, k)
    eng = _engine(TEngine, tm, 4, **opts)
    rng = np.random.default_rng(0)
    reqs = [eng.submit(rng.integers(0, SMALL["vocab_size"], int(rng.integers(3, 12))).tolist(),
                       max_new_tokens=int(rng.integers(3, 14))) for _ in range(5)]
    eng.run()
    assert all(r.done and len(r.generated) == r.max_new_tokens for r in reqs)
    assert all(0 <= t < SMALL["vocab_size"] for r in reqs for t in r.generated)
    if not ("device_sampler" in kwargs or "chunked_prefill" in kwargs):
        assert [r.generated for r in reqs] == [r.generated for r in want]
