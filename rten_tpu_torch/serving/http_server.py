"""Minimal HTTP front end over the continuous-batching engine (the port of
``rten_tpu/serving/http_server.py``): a stdlib-only JSON API running the
engine loop on a thread of its own, with the engine's backpressure,
timeouts and health probe wired to HTTP status codes.

    POST /generate   {"prompt": [ids...], "max_new_tokens": 64,
                      "eos_id": null, "timeout_s": null}
        -> {"request_id", "tokens", "ttft_ms", "latency_ms"}   (blocks)
        -> 429 when the admission queue is full, 400 on a bad request,
           504 when the wait times out, 500 when the engine failed it
    GET  /health     -> engine.health() JSON (503 on device errors)
    GET  /stats      -> engine.stats() JSON
    GET  /metrics    -> the stats in Prometheus text form

Run: ``serve(engine, port=8080)``, or ``serve_background`` to embed. The
loop's thread (and every call into the engine from a request's thread)
makes the engine's CUDA device current first.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import torch

from .engine import ContinuousBatchingEngine, QueueFull


def _device_scope(engine):
    """The engine's CUDA device as the current device (nothing on the CPU)."""
    dev = getattr(engine, "device", None)
    if dev is not None and dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


class EngineLoop:
    """Drives engine.step() on one thread; requests join through events."""

    def __init__(self, engine: ContinuousBatchingEngine):
        self.engine = engine
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._done_events = {}
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        with _device_scope(self.engine):
            while not self._stop:
                with self._lock:
                    has = self.engine.has_work()
                    if has:
                        # A step that raises must not kill this thread (every
                        # later /generate would hang for its whole wait): the
                        # in-flight requests fail instead (a 500 each) and
                        # the loop serves on.
                        try:
                            self.engine.step()
                        except Exception as e:  # noqa: BLE001 - engine state is
                            # unrecoverable mid-step; surface it to the waiters.
                            self.engine.fail_inflight(repr(e))
                        for req in self.engine.drain_finished():
                            ev = self._done_events.pop(req.request_id, None)
                            if ev is not None:
                                ev.set()
                if not has:
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()

    def submit_and_wait(self, prompt, max_new_tokens, eos_id=None,
                        timeout_s: Optional[float] = None, wait_s: float = 300.0):
        ev = threading.Event()
        with self._lock:
            req = self.engine.submit(
                prompt, max_new_tokens=max_new_tokens, eos_id=eos_id,
                timeout_s=timeout_s,
            )
            self._done_events[req.request_id] = ev
        self._wake.set()
        if not ev.wait(wait_s):
            with self._lock:
                self.engine.cancel(req)
            raise TimeoutError("generation did not finish in time")
        return req

    def call(self, fn):
        with self._lock, _device_scope(self.engine):
            return fn(self.engine)

    def shutdown(self):
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=5)


def make_handler(loop: EngineLoop):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                h = loop.call(lambda e: e.health())
                self._json(200 if h["status"] == "ok" else 503, h)
            elif self.path == "/stats":
                self._json(200, loop.call(lambda e: e.stats()))
            elif self.path == "/metrics":
                # Prometheus text exposition of the engine counters.
                s = loop.call(lambda e: e.stats())
                lines = [f"rten_{key} {float(val)}" for key, val in s.items()
                         if val is not None]
                body = ("\n".join(lines) + "\n").encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/generate":
                self._json(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(n) or b"{}")
                req = loop.submit_and_wait(
                    payload["prompt"],
                    int(payload.get("max_new_tokens", 64)),
                    payload.get("eos_id"),
                    payload.get("timeout_s"),
                )
            except QueueFull as e:
                self._json(429, {"error": str(e)})
                return
            except (KeyError, ValueError, TypeError) as e:
                self._json(400, {"error": str(e)})
                return
            except TimeoutError as e:
                self._json(504, {"error": str(e)})
                return
            if req.error is not None:
                self._json(500, {"error": req.error, "request_id": req.request_id})
                return
            self._json(200, {
                "request_id": req.request_id,
                "tokens": req.generated,
                "cancelled": req.cancelled,
                "timed_out": req.timed_out,
                "ttft_ms": round((req.ttft_s or 0) * 1e3, 1),
                "latency_ms": round(
                    ((req.finished_at or time.perf_counter()) - req.submitted_at) * 1e3, 1
                ),
            })

    return Handler


def serve(engine: ContinuousBatchingEngine, host: str = "127.0.0.1", port: int = 8080):
    """Serve until interrupted (``serve_background`` returns the server and
    the loop instead)."""
    loop = EngineLoop(engine)
    server = ThreadingHTTPServer((host, port), make_handler(loop))
    try:
        server.serve_forever()
    finally:
        loop.shutdown()
        server.server_close()


def serve_background(engine: ContinuousBatchingEngine, host: str = "127.0.0.1",
                     port: int = 0):
    loop = EngineLoop(engine)
    server = ThreadingHTTPServer((host, port), make_handler(loop))
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server, loop
