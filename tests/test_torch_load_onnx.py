"""Exported ONNX models through both packages' loaders: ``Model.load_file``
of the port (on the CPU) against the JAX package's on the same file and
the same seeded inputs.

The modules are the JAX tests' exported modules that use only the core
op families (``tests/test_model_onnx.py``'s MLP and attention block,
``tests/example_models.py``'s QA, embedding and masked-LM models) and the
GPT-2-shaped module of ``tests/gpt2_onnx.py`` at 2 layers, E 64. For each:
the optimized operator lists are identical and in order, and the outputs
agree within 1e-5 relative (f32; the two libraries' transcendental
functions differ by ulps). After ``quantize_dynamic`` the GPT-2 logits
agree within 1e-3 of max|logit| with the weights sharpened 8x, so that no
u8 activation code sits on a rounding tie between the two (ROADMAP.md's
rule). Dynamic batch, ``run_one``, ``partial_run`` and ``find_node`` are
held against the JAX package's too.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import example_models as em  # noqa: E402
import gpt2_onnx  # noqa: E402
from onnx_export_util import export_onnx  # noqa: E402
from test_model_onnx import Mlp, TinyAttention  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401

from rten_tpu.model import Model as JModel  # noqa: E402
from rten_tpu.quantize_pass import quantize_dynamic as jquantize  # noqa: E402
from rten_tpu_torch.cli import quantize_model  # noqa: E402
from rten_tpu_torch.model import Model as TModel  # noqa: E402

SMALL = gpt2_onnx.GPT2Shape(vocab_size=256, n_positions=64, n_embd=64, n_layer=2, n_head=2)


def _ops(model):
    return [op.op_type for _, op in model.graph.operators()]


def _both(path):
    return TModel.load_file(path, device="cpu"), JModel.load_file(path)


def _close(got, want, rtol=1e-5):
    """Within rtol of the largest |want| (elementwise rtol is meaningless
    next to exact zeros)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rtol * scale, np.abs(got - want).max() / scale


def _export_tiny(name, tmp_path):
    """(path, feed) of one of the JAX tests' exported modules."""
    torch.manual_seed(0)
    rng = np.random.default_rng(5)
    path = str(tmp_path / f"{name}.onnx")
    if name == "mlp":
        export_onnx(Mlp(), torch.randn(3, 784), path, ["x"], ["logits"])
        return path, {"x": rng.standard_normal((3, 784)).astype(np.float32)}
    if name == "attention_block":
        export_onnx(TinyAttention(), torch.randn(2, 10, 32), path, ["x"], ["y"])
        return path, {"x": rng.standard_normal((2, 10, 32)).astype(np.float32)}
    ids = rng.integers(0, 128, (2, 8)).astype(np.int32)
    mask = np.ones((2, 8), np.int32)
    mask[1, 6:] = 0
    if name == "mlm":
        em.export_mlm_model(path)
    elif name == "qa":
        em.export_qa_model(path)
    else:
        em.export_embed_model(path)
    return path, {"input_ids": ids, "attention_mask": mask}


@pytest.mark.parametrize("name", ["mlp", "attention_block", "mlm", "qa", "embed"])
def test_exported_modules(name, tmp_path):
    path, feed = _export_tiny(name, tmp_path)
    tm, jm = _both(path)
    assert _ops(tm) == _ops(jm)
    got = [t.numpy() for t in tm.run(feed)]
    want = [np.asarray(a) for a in jm.run(feed)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.fixture(scope="module")
def gpt2_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("gpt2")
    module = gpt2_onnx.GPT2Module(SMALL, seed=0)
    path = gpt2_onnx.export(module, d / "gpt2.onnx", batch=1, seq=8)
    sharp = gpt2_onnx.GPT2Module(SMALL, seed=0, sharpen=8.0)
    sharp_path = gpt2_onnx.export(sharp, d / "gpt2_sharp.onnx", batch=1, seq=8)
    return module, path, sharp_path


def _ids(batch, seq, seed=0):
    return np.random.default_rng(seed).integers(0, SMALL.vocab_size, (batch, seq)).astype(np.int32)


def test_gpt2_export_graph_and_logits(gpt2_file):
    """Both attentions fuse into Attention (no Softmax left), the operator
    lists agree, and the logits match the module and the JAX package."""
    module, path, _ = gpt2_file
    tm, jm = _both(path)
    ops = _ops(tm)
    assert ops == _ops(jm)
    assert ops.count("Attention") == SMALL.n_layer and "Softmax" not in ops
    ids = _ids(3, 11)
    got = tm.run({"input_ids": ids})[0].numpy()
    _close(got, np.asarray(jm.run({"input_ids": ids})[0]))
    with torch.no_grad():
        _close(got, module(torch.from_numpy(ids).long()).numpy(), rtol=1e-5)


@pytest.mark.parametrize("batch,seq", [(1, 8), (2, 5), (4, 16)])
def test_gpt2_dynamic_batch_and_sequence(gpt2_file, batch, seq):
    _, path, _ = gpt2_file
    tm, jm = _both(path)
    ids = _ids(batch, seq, seed=batch)
    got = tm.run({"input_ids": ids})[0].numpy()
    assert got.shape == (batch, seq, SMALL.vocab_size)
    _close(got, np.asarray(jm.run({"input_ids": ids})[0]))


def test_gpt2_quantized(gpt2_file):
    """quantize_dynamic in both packages (the port's CLI path also
    prepacks the weights) after an f32 run: 9 MatMulIntegerToFloat (4 a
    layer and the tied lm_head), logits within 1e-3 of max|logit|."""
    _, _, path = gpt2_file
    tm, jm = _both(path)
    ids = _ids(2, 12, seed=3)
    tm.run({"input_ids": ids})  # a run before the rewrite: its cached plan must go
    quantize_model(tm, "int8")
    jquantize(jm.graph)
    jm.executor._weights = None
    assert _ops(tm).count("MatMulIntegerToFloat") == 9
    assert _ops(jm).count("MatMulIntegerToFloat") == 9
    _close(tm.run({"input_ids": ids})[0].numpy(),
           np.asarray(jm.run({"input_ids": ids})[0]), rtol=1e-3)


def test_run_one_partial_run_find_node(gpt2_file):
    _, path, _ = gpt2_file
    tm, jm = _both(path)
    ids = _ids(1, 6)
    _close(tm.run_one(ids).numpy(), np.asarray(jm.run_one(ids)))
    for name in ("input_ids", "logits", "no such value"):
        assert (tm.find_node(name) is None) == (jm.find_node(name) is None)
        assert tm.find_node(name) == jm.find_node(name)
    # The first LayerNormalization's output, reached from the input alone.
    ln = next(tm.graph.node_name(op.outputs[0]) for _, op in tm.graph.operators()
              if op.op_type == "LayerNormalization")
    got = tm.partial_run({"input_ids": ids}, [ln])
    want = jm.partial_run({"input_ids": ids}, [ln])
    assert [nid for nid, _ in got] == [nid for nid, _ in want]
    for (_, g), (_, w) in zip(got, want):
        _close(g, w)


def test_unoptimized_load_runs_the_exporter_ops(gpt2_file):
    """Without the optimizer the graph keeps Softmax, Div, Constant and
    Identity; the port runs them as the JAX package does."""
    from rten_tpu.model import ModelOptions as JOptions
    from rten_tpu_torch.model import ModelOptions as TOptions

    _, path, _ = gpt2_file
    tm = TModel.load_file(path, TOptions(optimize=False), device="cpu")
    jm = JModel.load_file(path, JOptions(optimize=False))
    assert {"Softmax", "Div", "Constant", "Identity"} <= set(_ops(tm))
    ids = _ids(2, 7)
    _close(tm.run({"input_ids": ids})[0].numpy(), np.asarray(jm.run({"input_ids": ids})[0]))


class _Noisy(torch.nn.Module):
    def forward(self, x):
        return torch.relu(x) + torch.rand_like(x)


def test_unported_op_loads_and_raises_when_run(tmp_path):
    """A graph holding a random op (RandomUniformLike, which the port once
    refused) loads with the op left unfolded, as the JAX package leaves it;
    each run gives relu(x) plus a fresh draw in [0, 1)."""
    path = export_onnx(_Noisy(), torch.randn(5, 4), str(tmp_path / "noisy.onnx"), ["x"], ["y"])
    tm, jm = _both(path)
    assert "RandomUniformLike" in _ops(tm) and _ops(tm) == _ops(jm)
    x = np.random.default_rng(0).standard_normal((5, 4)).astype(np.float32)
    a, b = (tm.run({"x": x})[0].numpy() - np.maximum(x, 0) for _ in range(2))
    for d in (a, b):
        assert ((d >= 0) & (d < 1)).all()
    assert not np.array_equal(a, b)
