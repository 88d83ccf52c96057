"""The port's HTTP front end (``rten_tpu_torch/serving/http_server.py``) over
its engine on the CPU, with the properties of tests/test_http_serving.py:
a round trip, the tokens of the engine called directly, concurrent
requests, /health, /stats and /metrics, and the status codes (400 for a bad
request, 404, 429 when the queue is full, 500 when a step fails, after
which the loop serves on).

Small GPT-2 (2 layers, E 128, H 2, D 64, vocab 512, int8 weights and cat KV
caches), 2 slots, cap 64, 4 steps a dispatch.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from rten_tpu_torch.model import Model
from rten_tpu_torch.models import gpt2
from rten_tpu_torch.quantize_pass import quantize_dynamic
from rten_tpu_torch.serving import ContinuousBatchingEngine
from rten_tpu_torch.serving.http_server import serve_background
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

CFG = gpt2.GPT2Config(vocab_size=512, n_positions=128, n_embd=128, n_layer=2, n_head=2)


@pytest.fixture(scope="module")
def model():
    w = gpt2.random_weights(CFG, seed=0)
    w = {k: v * np.float32(10) if (".attn." in k or ".mlp." in k) else v for k, v in w.items()}
    g = gpt2.build_graph_static_cache(CFG, w, capacity=64, kv_quant=True, kernel_append=True,
                                      gather_last=True)
    quantize_dynamic(g)
    return Model(g, device="cpu")


def _engine(model, **kw):
    return ContinuousBatchingEngine(model, n_layer=2, n_head=2, head_dim=64, slots=2,
                                    capacity=64, prefill_bucket=8, greedy_on_device=True,
                                    steps_per_dispatch=4, **kw)


@pytest.fixture(scope="module")
def server(model):
    engine = _engine(model)
    srv, loop = serve_background(engine)
    yield f"http://127.0.0.1:{srv.server_address[1]}", engine, model
    srv.shutdown()
    srv.server_close()
    loop.shutdown()


def _post(url, payload, path="/generate"):
    req = urllib.request.Request(url + path, json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=30) as r:
        return r.read().decode()


def _status(fn):
    try:
        fn()
    except urllib.error.HTTPError as e:
        return e.code
    return 200


def test_generate_roundtrip_matches_the_engine(server):
    url, _, model = server
    out = _post(url, {"prompt": [3, 9, 27], "max_new_tokens": 8})
    assert len(out["tokens"]) == 8 and out["ttft_ms"] > 0
    assert not out["cancelled"] and not out["timed_out"]
    direct = _engine(model)
    r = direct.submit([3, 9, 27], max_new_tokens=8)
    direct.run()
    assert out["tokens"] == r.generated
    assert _post(url, {"prompt": [3, 9, 27], "max_new_tokens": 8})["tokens"] == r.generated


def test_concurrent_requests(server):
    url, _, _ = server
    results = {}

    def worker(i):
        results[i] = _post(url, {"prompt": [i + 1, i + 2], "max_new_tokens": 6})

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert len(results) == 4
    assert all(len(r["tokens"]) == 6 for r in results.values())
    assert len({r["request_id"] for r in results.values()}) == 4


def test_health_stats_metrics(server):
    url, _, _ = server
    _post(url, {"prompt": [5], "max_new_tokens": 2})
    health = json.loads(_get(url, "/health"))
    assert health["status"] == "ok" and health["inflight_dispatch"] is False
    stats = json.loads(_get(url, "/stats"))
    assert stats["finished_requests"] >= 1 and stats["decode_tokens"] >= 1
    body = _get(url, "/metrics")
    assert "rten_finished_requests" in body and "rten_decode_tokens" in body


def test_bad_requests(server):
    url, _, _ = server
    assert _status(lambda: _post(url, {"max_new_tokens": 4})) == 400
    assert _status(lambda: _post(url, {"prompt": [], "max_new_tokens": 4})) == 400
    assert _status(lambda: _post(url, {"prompt": [1] * 70, "max_new_tokens": 4})) == 400
    assert _status(lambda: _post(url, {"prompt": [1]}, path="/nowhere")) == 404
    assert _status(lambda: _get(url, "/nowhere")) == 404


def test_queue_full_is_429(model):
    srv, loop = serve_background(_engine(model, max_queue=0))
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        assert _status(lambda: _post(url, {"prompt": [1, 2], "max_new_tokens": 2})) == 429
    finally:
        srv.shutdown()
        srv.server_close()
        loop.shutdown()


def test_failed_step_is_500_and_the_loop_serves_on(model):
    """A step that raises fails the in-flight requests (500, the error
    named) through fail_inflight; the next request is served."""
    engine = _engine(model)
    inner, calls = engine._step_inner, []

    def flaky():
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("device lost")
        inner()

    engine._step_inner = flaky
    srv, loop = serve_background(engine)
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            _post(url, {"prompt": [1, 2], "max_new_tokens": 3})
            raise AssertionError("expected 500")
        except urllib.error.HTTPError as e:
            assert e.code == 500 and "device lost" in json.loads(e.read())["error"]
        assert len(_post(url, {"prompt": [1, 2], "max_new_tokens": 3})["tokens"]) == 3
    finally:
        srv.shutdown()
        srv.server_close()
        loop.shutdown()
