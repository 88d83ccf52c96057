"""The port's CLI (``python -m rten_tpu_torch``) with ``--device cpu``
against the JAX package's CLI (``python -m rten_tpu``) on the same files:
the model summary and ``--infer-shapes`` print the same lines, the timing
modes run (f32, ``--quantize int8``, ``--quantize int4``), outputs saved by
the JAX CLI pass the port's ``--check-outputs`` and the other way round,
``--save-model`` writes files the JAX package loads, ``--profile`` names
every op, and ``--serve`` answers over HTTP with the greedy tokens of the
JAX package's engine on the same saved file. Without a card and without
``--device cpu`` the CLI raises.
"""

import json
import os
import re
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import gpt2_onnx  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401

from rten_tpu import cli as jcli  # noqa: E402
from rten_tpu_torch import cli as tcli  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = gpt2_onnx.GPT2Shape(vocab_size=256, n_positions=64, n_embd=64, n_layer=2, n_head=2)
SIZES = ["--size", "batch=2", "--size", "seq=7"]


@pytest.fixture(scope="module")
def onnx_path(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    return gpt2_onnx.export(gpt2_onnx.GPT2Module(SMALL, seed=2, sharpen=8.0), d / "g.onnx")


def _run(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


def _summary(out):
    """The lines that describe the model (the load time left out)."""
    return [ln for ln in out.splitlines() if ln.startswith(("  ", "inputs", "outputs"))]


def test_summary_and_infer_shapes_match(onnx_path, capsys):
    rc, t = _run(tcli.main, [onnx_path, "--device", "cpu", "--infer-shapes"], capsys)
    assert rc == 0
    rc, j = _run(jcli.main, [onnx_path, "--infer-shapes"], capsys)
    assert rc == 0
    assert _summary(t) == _summary(j) and len(_summary(t)) > 50


@pytest.mark.parametrize("quantize", [None, "int8", "int4"])
def test_timing_modes(onnx_path, quantize, capsys):
    argv = [onnx_path, "--device", "cpu", "-n", "3", *SIZES]
    rc, out = _run(tcli.main, argv + (["--quantize", quantize] if quantize else []), capsys)
    assert rc == 0
    assert re.search(r"then mean [0-9.]+ ms, stddev [0-9.]+ ms over 2 iters", out), out


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_outputs_check_across_the_packages(onnx_path, tmp_path, quantize, capsys):
    """Inputs from a file; the JAX CLI's saved outputs pass the port's
    --check-outputs (rtol 1e-3, atol 1e-4), and the port's pass the JAX
    CLI's."""
    ids = np.random.default_rng(4).integers(0, SMALL.vocab_size, (2, 9)).astype(np.int32)
    inputs = str(tmp_path / "in.npz")
    np.savez(inputs, input_ids=ids)
    q = ["--quantize", quantize] if quantize else []
    for save, check in ((jcli.main, tcli.main), (tcli.main, jcli.main)):
        out = str(tmp_path / f"out_{save.__module__}.safetensors")
        dev = ["--device", "cpu"] if save is tcli.main else []
        assert _run(save, [onnx_path, *dev, *q, "--inputs", inputs, "--save-outputs", out,
                           "-q"], capsys)[0] == 0
        dev = ["--device", "cpu"] if check is tcli.main else []
        rc, text = _run(check, [onnx_path, *dev, *q, "--inputs", inputs, "--check-outputs",
                                out, "-q"], capsys)
        assert rc == 0 and "OK logits" in text, text


@pytest.mark.parametrize("ext", ["rtpu", "rten"])
def test_save_model_loads_in_the_jax_package(onnx_path, tmp_path, ext, capsys):
    from rten_tpu.model import Model as JModel

    out = str(tmp_path / f"m.{ext}")
    q = ["--quantize", "int8"] if ext == "rtpu" else []
    rc, text = _run(tcli.main, [onnx_path, "--device", "cpu", *q, "--save-model", out,
                                *SIZES], capsys)
    assert rc == 0 and f"saved {out}" in text
    ops = [op.op_type for _, op in JModel.load_file(out).graph.operators()]
    assert ("MatMulIntegerToFloat" in ops) == (ext == "rtpu")


def test_profile_names_every_op(onnx_path, capsys):
    from rten_tpu_torch.model import Model

    rc, out = _run(tcli.main, [onnx_path, "--device", "cpu", "--profile", *SIZES], capsys)
    assert rc == 0
    m = Model.load_file(onnx_path, device="cpu")
    n_ops = len(list(m.graph.operators()))
    assert re.search(rf"across {n_ops} op runs", out), out
    for op_type in {op.op_type for _, op in m.graph.operators()}:
        assert re.search(rf"^  {op_type} ", out, re.M), op_type


def test_module_entry_point_and_the_card_rule(onnx_path, monkeypatch):
    """``python -m rten_tpu_torch`` runs with --device cpu; with no card
    and no --device the CLI raises, naming the CPU option."""
    import torch

    env = {**os.environ, "PYTHONPATH": ROOT, "CUDA_VISIBLE_DEVICES": ""}
    r = subprocess.run([sys.executable, "-m", "rten_tpu_torch", onnx_path, "--device", "cpu",
                        "--print", *SIZES], env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "logits (2, 7, 256) float32" in r.stdout
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main([onnx_path])


# --- --serve --------------------------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(port, prompt, n):
    body = json.dumps({"prompt": prompt, "max_new_tokens": n}).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate", data=body,
                                 headers={"Content-Type": "application/json"})
    deadline, last = time.time() + 120, None
    while time.time() < deadline:
        try:
            with urllib.request.urlopen(req, timeout=90) as resp:
                return json.loads(resp.read())["tokens"]
        except Exception as e:  # the server is still starting
            last = e
            time.sleep(0.3)
    raise AssertionError(f"server never answered: {last}")


def test_serve_gives_the_jax_engines_tokens(tmp_path):
    """A static-cache GPT-2 (int8 weights, int8 cat KV) saved by the port;
    the port's CLI serves it; the JAX package's engine, on the same file
    with the CLI's settings, gives the same greedy tokens."""
    from rten_tpu.model import Model as JModel
    from rten_tpu.serving import ContinuousBatchingEngine as JEngine
    from rten_tpu_torch.model import Model
    from rten_tpu_torch.models import gpt2
    from rten_tpu_torch.quantize_pass import quantize_dynamic

    cfg = gpt2.GPT2Config(vocab_size=512, n_positions=128, n_embd=128, n_layer=2, n_head=2)
    w = gpt2.random_weights(cfg, seed=0)
    w = {k: v * np.float32(10) if (".attn." in k or ".mlp." in k) else v for k, v in w.items()}
    g = gpt2.build_graph_static_cache(cfg, w, capacity=64, kv_quant=True, kernel_append=True,
                                      gather_last=True)
    quantize_dynamic(g)
    path = str(tmp_path / "lm.rtpu")
    Model(g, device="cpu").save(path)

    port = _free_port()
    threading.Thread(target=tcli.main, daemon=True, args=(
        [path, "--device", "cpu", "--serve", str(port), "--slots", "2", "--prefill-bucket", "8",
         "--steps-per-dispatch", "4", "-q"],)).start()
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 512, int(n)).tolist() for n in (5, 11)]
    got = [_post(port, p, 7) for p in prompts]

    engine = JEngine(JModel.load_file(path), n_layer=0, n_head=0, head_dim=0, slots=2,
                     capacity=64, prefill_bucket=8, greedy_on_device=True, steps_per_dispatch=4)
    want = []
    for p in prompts:
        r = engine.submit(p, max_new_tokens=7)
        engine.run()
        want.append(r.generated)
    assert got == want and all(len(t) == 7 for t in got)
