"""ResNet (``tests/torch_models.resnet_tiny``: ResNet-50's bottleneck
structure with one block a stage) exported once to ONNX at 64x64 with a
dynamic batch, loaded by both packages' ``Model.load_file`` and run on the
same seeded batch of 2 on the CPU:

* f32: the optimized graphs equal node for node, logits within 1e-5 of
  max|logit| of the JAX package's and of the module's own forward;
* int8 with the default ``quantize_dynamic`` (the classifier becomes
  MatMulIntegerToFloat, the convs stay f32) and with
  ``RTEN_QUANT_CONV=all`` (every conv of group 1, C·k >= 128 and O >= 64
  becomes DynamicQuantizeLinear + ConvIntegerToFloat): both passes leave
  the same graph node for node (through the ``.rtpu`` JSON form, as
  ``tests/torch_graph_compare.py`` copies graphs), the logits lie within
  1e-3 of max|logit| of the JAX package's (no u8 activation flips on this
  seed), and top-1 equals the module's with a correlation above 0.99 (the
  JAX package's own criteria, ``tests/test_models_e2e.py``);
* ``RunConfig(prefer_bf16=True)``: on the CPU both packages compute in f32
  and agree as in f32, and no run changes PyTorch's process-wide TF32
  flags.
"""

import numpy as np
import pytest
import torch

from onnx_export_util import export_onnx
from torch_graph_compare import clone_both, sig
from torch_models import resnet_tiny
from torch_one_thread import one_torch_thread  # noqa: F401

from rten_tpu.model import Model as JModel
from rten_tpu.model import ModelOptions as JOptions
from rten_tpu.quantize_pass import quantize_dynamic as jquantize
from rten_tpu.runtime.executor import RunConfig as JRunConfig
from rten_tpu_torch.model import Model as TModel
from rten_tpu_torch.model import ModelOptions as TOptions
from rten_tpu_torch.quantize_pass import quantize_dynamic as tquantize
from rten_tpu_torch.runtime.executor import RunConfig as TRunConfig


@pytest.fixture(scope="module")
def resnet(tmp_path_factory):
    torch.manual_seed(0)
    module = resnet_tiny().eval()
    x = torch.from_numpy(np.random.default_rng(3).normal(0, 1, (2, 3, 64, 64)).astype(np.float32))
    path = str(tmp_path_factory.mktemp("resnet") / "resnet_tiny.onnx")
    export_onnx(module, x[:1], path, ["image"], ["logits"],
                dynamic_axes={"image": {0: "batch"}, "logits": {0: "batch"}})
    with torch.no_grad():
        want = module(x).numpy()
    return path, x.numpy(), want


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def _tf32_flags():
    return (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision())


def test_f32_matches_the_jax_package_and_the_module(resnet):
    path, x, want = resnet
    tm = TModel.load_file(path, device="cpu")
    jm = JModel.load_file(path)
    assert sig(tm.graph) == sig(jm.graph)
    ops = [op.op_type for _, op in tm.graph.operators()]
    assert {"Conv", "MaxPool", "GlobalAveragePool", "Gemm"} <= set(ops)
    got = tm.run({"image": x})[0].numpy()
    ref = np.asarray(jm.run({"image": x})[0])
    assert got.shape == (2, 10)
    assert _rel(got, ref) < 1e-5
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("quant_conv,n_conv_q", [("none", 0), ("all", 14)])
def test_int8_matches_the_jax_package(resnet, monkeypatch, quant_conv, n_conv_q):
    """The same graph after both packages' quantize_dynamic (on copies of
    one optimized graph with the same ids), and the user's path (load_file,
    quantize_dynamic, run) giving the JAX package's logits."""
    path, x, want = resnet
    monkeypatch.setenv("RTEN_QUANT_CONV", quant_conv)
    jg, tg = clone_both(JModel.load_file(path).graph)
    jquantize(jg)
    tquantize(tg)
    assert sig(tg) == sig(jg)
    ops = [op.op_type for _, op in tg.operators()]
    assert ops.count("ConvIntegerToFloat") == n_conv_q
    assert ops.count("MatMulIntegerToFloat") == 1

    tm = TModel.load_file(path, device="cpu")
    tquantize(tm.graph)
    tm.executor.invalidate_weights()
    jm = JModel.load_file(path)
    jquantize(jm.graph)
    jm.executor._weights = None  # new q8 constants must be lifted
    got = tm.run({"image": x})[0].numpy()
    ref = np.asarray(jm.run({"image": x})[0])
    assert _rel(got, ref) < 1e-3
    assert (np.argmax(got, -1) == np.argmax(want, -1)).all()
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.99


def test_prefer_bf16_on_the_cpu_matches_the_jax_package(resnet):
    """On the CPU the JAX package computes f32 whatever prefer_bf16 says,
    and so does the port; the run reads no TF32 flag and sets none."""
    path, x, _ = resnet
    before = _tf32_flags()
    tm = TModel.load_file(path, TOptions(run_config=TRunConfig(prefer_bf16=True)), device="cpu")
    jm = JModel.load_file(path, JOptions(run_config=JRunConfig(prefer_bf16=True)))
    got = tm.run({"image": x})[0].numpy()
    ref = np.asarray(jm.run({"image": x})[0])
    assert _rel(got, ref) < 1e-5
    assert _tf32_flags() == before
