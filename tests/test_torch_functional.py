"""The port's eager op helpers (``rten_tpu_torch/functional.py``) against
the JAX package's ``functional`` on the CPU, from the same seeded numpy
inputs: each helper's tensors equal within the stated tolerance (1e-6
elementwise; 1e-5 relative for products and norms; exact for indices and
integer outputs), on the device asked for; ``arg_max`` over the last axis
of f32 through the argmax wrapper, as the executor routes it."""

import numpy as np
import pytest
import torch

from rten_tpu import functional as JF
from rten_tpu_torch import functional as F

RNG = np.random.default_rng(0)
X = RNG.standard_normal((3, 8)).astype(np.float32)
W8 = RNG.standard_normal(8).astype(np.float32)
B8 = RNG.standard_normal(8).astype(np.float32)
A = RNG.standard_normal((2, 5, 6)).astype(np.float32)
B = RNG.standard_normal((6, 4)).astype(np.float32)
IMG = RNG.standard_normal((1, 3, 9, 11)).astype(np.float32)
KER = RNG.standard_normal((4, 3, 3, 3)).astype(np.float32)
KB = RNG.standard_normal(4).astype(np.float32)
BOXES = np.concatenate([RNG.random((1, 12, 2)) * 20, RNG.random((1, 12, 2)) * 20 + 25],
                       -1).astype(np.float32)
SCORES = RNG.random((1, 2, 12)).astype(np.float32)
Q = (RNG.standard_normal((2, 3, 4)) * 3).astype(np.float32)
QS = np.asarray([0.05, 0.1, 0.2], np.float32)
QZ = np.asarray([3, 128, 250], np.uint8)

CASES = {
    "softmax": (lambda f: f.softmax(X), 1e-6),
    "softmax_axis0": (lambda f: f.softmax(X, axis=0), 1e-6),
    "log_softmax": (lambda f: f.log_softmax(X), 1e-6),
    "gelu": (lambda f: f.gelu(X), 1e-6),
    "gelu_tanh": (lambda f: f.gelu(X, approximate="tanh"), 1e-6),
    "silu": (lambda f: f.silu(X), 1e-6),
    "erf": (lambda f: f.erf(X), 1e-6),
    "sigmoid": (lambda f: f.sigmoid(X), 1e-6),
    "layer_norm": (lambda f: f.layer_norm(X, W8, B8), 1e-5),
    "rms_norm": (lambda f: f.rms_norm(X, W8), 1e-5),
    "matmul": (lambda f: f.matmul(A, B), 1e-5),
    "conv2d": (lambda f: f.conv2d(IMG, KER, KB, strides=(2, 1), pads=(1, 0, 1, 2)), 1e-5),
    "resize_nearest": (lambda f: f.resize(IMG, [1, 3, 18, 5]), 0.0),
    "resize_linear": (lambda f: f.resize(IMG, [1, 3, 14, 22], mode="linear"), 1e-5),
    "top_k": (lambda f: f.top_k(X, 3), 0.0),
    "top_k_smallest_axis0": (lambda f: f.top_k(X, 2, axis=0, largest=False), 0.0),
    "arg_max": (lambda f: f.arg_max(X), 0.0),
    "arg_max_axis0_keep": (lambda f: f.arg_max(X, axis=0, keepdims=True), 0.0),
    "nms": (lambda f: f.non_max_suppression(BOXES, SCORES, 5, 0.3, 0.2), 0.0),
    "pad": (lambda f: f.pad(X, [1, 2, 0, 3], value=1.5), 0.0),
    "pad_reflect": (lambda f: f.pad(X, [0, 2, 1, 3], mode="reflect"), 0.0),
    "quantize_linear": (lambda f: f.quantize_linear(Q, QS, QZ), 0.0),
    "dequantize_linear": (lambda f: f.dequantize_linear(QZ.reshape(1, 3, 1), QS, QZ), 1e-6),
}


def _call(fn, module, **kw):
    if module is F:
        return fn(_Bound(F, **kw))
    return fn(module)


class _Bound:
    """``F`` with keyword arguments added to every helper call."""

    def __init__(self, mod, **kw):
        self.mod, self.kw = mod, kw

    def __getattr__(self, name):
        return lambda *a, **k: getattr(self.mod, name)(*a, **{**self.kw, **k})


@pytest.mark.parametrize("name", sorted(CASES))
def test_helper_matches_jax(name):
    fn, tol = CASES[name]
    got = _call(fn, F, device="cpu")
    want = _call(fn, JF)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        w = np.asarray(w)
        assert g.shape == w.shape and g.numpy().dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_allclose(g.numpy(), w, rtol=tol, atol=tol)


def test_tensor_inputs_and_the_argmax_route(monkeypatch):
    """Tensors in, tensors out on the same device; ArgMax over the last axis
    of an f32 tensor of two or more dimensions goes through the argmax
    wrapper (the kernel on the card), other axes and dtypes do not."""
    from rten_tpu_torch.kernels import argmax

    calls = []
    real = argmax.argmax_lastdim
    monkeypatch.setattr("rten_tpu_torch.ops.reduce.argmax_lastdim",
                        lambda x: calls.append(tuple(x.shape)) or real(x))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((4, 3, 50)).astype(np.float32))
    got = F.arg_max(x, device="cpu")
    assert got.dtype == torch.int32 and got.tolist() == x.argmax(-1).tolist()
    assert calls == [(12, 50)]
    assert F.arg_max(x, axis=1, device="cpu").tolist() == x.argmax(1).tolist()
    assert F.arg_max(x.double(), device="cpu").tolist() == x.argmax(-1).tolist()
    assert calls == [(12, 50)]
    np.testing.assert_allclose(F.softmax(x, device="cpu").numpy(), JF.softmax(x.numpy()),
                               rtol=1e-6, atol=1e-6)


def test_no_card_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        F.softmax(X)
