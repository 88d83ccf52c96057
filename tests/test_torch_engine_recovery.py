"""The engine's recovery paths, ``restart()`` and ``fail_inflight()`` (the
JAX package's serving/engine.py:727-754 and :792-830), on flat caches,
paged pools and deferred-KV graphs: a restart re-queues every running
request with its tokens cleared and then regenerates the same tokens (the
logic of tests/test_serving_robustness.py:71); fail_inflight fails every
running and queued request (tests/test_advice_fixes_r3.py:148); both
release every block and zero the caches and windows.

Small GPT-2 (2 layers, E 128, H 2, D 64, vocab 512), 3 slots, cap 64.
"""

import numpy as np
import pytest
import torch

from rten_tpu_torch.model import Model
from rten_tpu_torch.models import gpt2
from rten_tpu_torch.quantize_pass import quantize_dynamic
from rten_tpu_torch.serving import ContinuousBatchingEngine
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

CFG = gpt2.GPT2Config(vocab_size=512, n_positions=128, n_embd=128, n_layer=2, n_head=2)
# name: builder options
FORMS = {
    "flat": dict(kv_quant=True, kernel_append=True),
    "paged": dict(kv_quant=True, kernel_append=True, paged_blocks=8, block_size=16),
    "deferred_int4": dict(kv_quant=True, kv_bits=4, deferred_kv=True),
}


def _engine(form, k=4):
    w = gpt2.random_weights(CFG, seed=0)
    w = {n: a * np.float32(10.0) if (".attn." in n or ".mlp." in n) else a for n, a in w.items()}
    graph = gpt2.build_graph_static_cache(CFG, w, capacity=64, gather_last=True, **FORMS[form])
    quantize_dynamic(graph)
    return ContinuousBatchingEngine(
        Model(graph, device="cpu"), n_layer=2, n_head=2, head_dim=64, slots=3, capacity=64,
        prefill_bucket=8, greedy_on_device=True, steps_per_dispatch=k)


PROMPTS = [[3, 9, 27, 81], [5, 1, 400, 22, 7], [11, 12], [300, 301, 302]]


def _assert_reset(eng):
    """No request holds a slot, every block is free, the caches and windows
    are zero."""
    assert all(r is None for r in eng.slot_req) and not eng.slot_len.any()
    assert all(not c.any() for c in eng.caches)
    assert all(not r.any() for r in eng._recents)
    if eng.paged:
        assert sorted(eng._free_blocks) == list(range(1, eng.n_blocks))
        assert not eng.block_table.any()


@pytest.mark.parametrize("form", list(FORMS))
def test_restart_is_deterministic(form):
    """A request partly decoded, then restart(): it is re-queued with its
    tokens cleared, the device state is reset, and the run regenerates the
    tokens of an engine that never restarted."""
    ref = _engine(form)
    done = ref.submit(PROMPTS[0], max_new_tokens=8)
    ref.run()

    eng = _engine(form)
    r = eng.submit(PROMPTS[0], max_new_tokens=8)
    eng.step()  # admitted and partly decoded
    assert r.generated and not r.done
    requeued = eng.restart()
    assert requeued == [r] and not r.generated and r.first_token_at is None
    _assert_reset(eng)
    eng.run()
    assert r.generated == done.generated


@pytest.mark.parametrize("form", list(FORMS))
def test_restart_requeues_running_requests_first(form):
    """With more requests than slots: the running ones go back to the head
    of the queue (slot by slot, each in front of the last, as the reference
    re-queues them), the waiting one stays behind them, and every request
    then runs to its budget. (Which slot a request lands in changes the idle
    slots' rows that share the per-tensor activation scale, so tokens are
    compared one request at a time above.)"""
    eng = _engine(form)
    reqs = [eng.submit(p, max_new_tokens=8) for p in PROMPTS]
    eng.step()  # three admitted and decoded one dispatch; the fourth waits
    assert all(r.generated for r in reqs[:3]) and not reqs[3].generated
    requeued = eng.restart()
    assert requeued == reqs[:3] and not any(r.generated for r in requeued)
    assert list(eng.queue) == [reqs[2], reqs[1], reqs[0], reqs[3]]
    _assert_reset(eng)
    eng.run()
    assert all(r.done and len(r.generated) == 8 and r.error is None for r in reqs)


@pytest.mark.parametrize("form", list(FORMS))
def test_fail_inflight_fails_running_and_queued(form):
    """fail_inflight(error): every running and queued request ends done
    with the error, none is left in a slot or the queue, the device state is
    reset, and the engine serves new requests afterwards."""
    eng = _engine(form)
    reqs = [eng.submit(p, max_new_tokens=8) for p in PROMPTS]
    eng.step()
    failed = eng.fail_inflight("boom")
    assert {r.request_id for r in failed} == {r.request_id for r in reqs}
    assert all(r.done and r.error == "boom" and r.finished_at is not None for r in failed)
    assert not eng.queue and not eng.has_work()
    assert eng.stats()["finished_requests"] == len(reqs)
    _assert_reset(eng)
    again = eng.submit(PROMPTS[0], max_new_tokens=8)
    eng.run()
    ref = _engine(form)
    want = ref.submit(PROMPTS[0], max_new_tokens=8)
    ref.run()
    assert again.generated == want.generated and again.error is None


def test_fail_inflight_with_nothing_in_flight():
    """With no request, fail_inflight fails nothing and leaves the engine
    usable."""
    eng = _engine("flat")
    assert eng.fail_inflight("boom") == []
    _assert_reset(eng)
    r = eng.submit(PROMPTS[1], max_new_tokens=3)
    eng.run()
    assert len(r.generated) == 3 and torch.is_tensor(eng.caches[0])
