"""The port's engine scheduling against the JAX engine: chunked prefill (a
long prompt admitted in prefill_bucket chunks while another slot is
mid-decode), several dispatches a drain, and pipelined dispatch (the next
dispatch issued before the last is read); then their properties on the
port alone: the in-flight dispatch, the KV margin, the refusals.

Chunks run over copies of the live caches and only the admitted slots'
rows are copied back: without that, a chunk's rows that are not admitted
(zero ids at ``past_lens = 0``) would overwrite the first rows of the slot
that is decoding.

Small GPT-2 (2 layers, E 128, H 2, D 64, vocab 512, weights sharpened
10x), 3 slots, cap 64, prefill bucket 8.
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
FORMS = {"s8_cat": dict(kv_quant=True, kernel_append=True, gather_last=True)}


def _weights():
    w = tgpt2.random_weights(tgpt2.GPT2Config(**SMALL), seed=0)
    return {k: v * np.float32(10) if (".attn." in k or ".mlp." in k) else v
            for k, v in w.items()}


def _model(mod, form, **extra):
    g = mod.build_graph_static_cache(mod.GPT2Config(**SMALL), _weights(), capacity=64,
                                     **FORMS[form], **extra)
    (tquantize if mod is tgpt2 else jquantize)(g)
    return TModel(g, device="cpu") if mod is tgpt2 else JModel(g, JOptions())


def _engine(cls, model, k=4, **kw):
    return cls(model, n_layer=2, n_head=2, head_dim=64, slots=3, capacity=64,
               prefill_bucket=8, greedy_on_device=True, steps_per_dispatch=k, **kw)


LONG = np.random.default_rng(7).integers(1, 500, 30).tolist()  # 4 chunks of 8


def _chunked(eng):
    """A short request decodes first; the long one is then admitted in
    chunks against the live decode state."""
    short = eng.submit([5, 9, 12], max_new_tokens=10)
    eng.step()
    long_ = eng.submit(LONG, max_new_tokens=10)
    eng.run()
    return [short.generated, long_.generated]


@pytest.mark.parametrize("form", list(FORMS))
def test_chunked_prefill_matches_jax(form):
    teng = _engine(TEngine, _model(tgpt2, form), chunked_prefill=True)
    got = _chunked(teng)
    assert got == _chunked(_engine(JEngine, _model(jgpt2, form), chunked_prefill=True))
    assert all(len(t) == 10 for t in got)


def _wave(eng, n=6):
    rng = np.random.default_rng(1)
    reqs = [eng.submit(rng.integers(0, 512, int(rng.integers(2, 12))).tolist(),
                       max_new_tokens=int(rng.integers(3, 30))) for _ in range(n)]
    eng.run()
    return [r.generated for r in reqs]


@pytest.mark.parametrize("mode", [dict(dispatches_per_drain=2), dict(pipeline_dispatch=True)])
def test_drains_and_pipelining_match_jax(mode):
    """Up to 2 dispatches before a read, or the next dispatch issued before
    the last is read: the JAX engine's tokens and decode steps."""
    teng = _engine(TEngine, _model(tgpt2, "s8_cat"), **mode)
    got = _wave(teng)
    jeng = _engine(JEngine, _model(jgpt2, "s8_cat"), **mode)
    assert got == _wave(jeng)
    assert teng.steps == jeng.steps
    assert not teng.has_pending_results()


def test_chunked_prefill_leaves_the_decoding_slot_alone():
    """The decoding slot's cache rows are the same after a chunked
    admission as before it, but for the rows its own decode wrote."""
    eng = _engine(TEngine, _model(tgpt2, "s8_cat"), k=1, chunked_prefill=True)
    short = eng.submit([5, 9, 12], max_new_tokens=20)
    eng.step()
    n = int(eng.slot_len[0])
    before = [c[0].clone() for c in eng.caches]
    eng.submit(LONG, max_new_tokens=4)
    eng._admit([(1, eng.queue.popleft())])
    for b, c in zip(before, eng.caches):
        assert (b == c[0]).all()
    assert eng.slot_len[1] == len(LONG) and int(eng.slot_len[0]) == n
    eng.run()
    assert short.done


def test_pipelining_state():
    """A pipelined engine keeps one dispatch in flight between steps
    (has_work and has_pending_results say so, health reports it) and uses
    a KV margin of two dispatches; the serial tail drains it."""
    eng = _engine(TEngine, _model(tgpt2, "s8_cat"), pipeline_dispatch=True)
    assert eng.pipeline_dispatch
    r = eng.submit([1, 2, 3], max_new_tokens=30)
    eng.step()  # admits and issues the first dispatch
    assert eng.has_pending_results() and eng.health()["inflight_dispatch"]
    assert len(r.generated) == 1
    eng.step()  # issues the second, reads the first
    assert eng.has_pending_results() and len(r.generated) == 5
    eng.run()
    assert len(r.generated) == 30 and not eng.has_work()
    # No fused dispatch at k == 1, so no pipelining either.
    assert not _engine(TEngine, _model(tgpt2, "s8_cat"), k=1, pipeline_dispatch=True
                       ).pipeline_dispatch


def test_chunked_prefill_refused_on_paged_graphs():
    for cls, mod in ((TEngine, tgpt2), (JEngine, jgpt2)):
        with pytest.raises(ValueError, match="paged"):
            _engine(cls, _model(mod, "s8_cat", paged_blocks=8, block_size=16),
                    chunked_prefill=True)
