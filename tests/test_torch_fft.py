"""DFT and STFT in the port (``rten_tpu_torch/ops/fft.py``, ``torch.fft``)
against the JAX package's (``jnp.fft``) as one-node graphs on the same
seeded signals, within 1e-5 of max|X|: DFT forward on real and complex
inputs, inverse, onesided, with ``dft_length`` and the axis as an
attribute or an input; STFT with a window, with a frame length, onesided
or not."""

import numpy as np
import pytest

from rten_tpu.dtypes import DataType as JDataType
from rten_tpu.ir.builder import GraphBuilder as JBuilder
from rten_tpu.model import Model as JModel
from rten_tpu.model import ModelOptions as JOptions
from rten_tpu_torch.dtypes import DataType as TDataType
from rten_tpu_torch.ir.builder import GraphBuilder as TBuilder
from rten_tpu_torch.model import Model as TModel
from rten_tpu_torch.model import ModelOptions as TOptions
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

R = np.random.default_rng(7)
REAL = R.standard_normal((2, 48, 1)).astype(np.float32)
CPLX = R.standard_normal((2, 48, 2)).astype(np.float32)
SIG = R.standard_normal((2, 700)).astype(np.float32)
HANN = np.hanning(129)[:-1].astype(np.float32)


def _const(v, dtype=np.int32):
    return ("const", np.asarray(v, dtype))


# (id, op, inputs (arrays are graph inputs, _const(...) constants), attrs)
CASES = [
    ("dft-real", "DFT", [REAL], {}),
    ("dft-complex", "DFT", [CPLX], {}),
    ("dft-inverse", "DFT", [CPLX], {"inverse": 1}),
    ("dft-onesided", "DFT", [REAL], {"onesided": 1}),
    ("dft-length-pad", "DFT", [REAL, _const(64)], {}),
    ("dft-length-cut", "DFT", [CPLX, _const(40)], {"inverse": 1}),
    ("dft-axis-attr", "DFT", [R.standard_normal((3, 5, 32, 2)).astype(np.float32)],
     {"axis": 2}),
    ("dft-axis-input", "DFT", [R.standard_normal((4, 24, 6, 1)).astype(np.float32), None,
                               _const(1)], {}),
    ("stft-window", "STFT", [SIG, _const(64), ("const", HANN)], {}),
    ("stft-window-twosided", "STFT", [SIG, _const(50), ("const", HANN)], {"onesided": 0}),
    ("stft-frame-length", "STFT", [SIG[..., None], _const(100), None, _const(200)], {}),
]


def _build(GB, DT, op, inputs, attrs):
    b = GB()
    ins, feed = [], {}
    for i, x in enumerate(inputs):
        if x is None:
            ins.append(None)
        elif isinstance(x, tuple):
            ins.append(b.constant(f"c{i}", x[1]))
        else:
            ins.append(b.input(f"x{i}", DT.Float, x.shape))
            feed[f"x{i}"] = x
    b.output(b.op(op, ins, attrs, output_names=["y"]))
    return b.finish(), feed


@pytest.mark.parametrize("op,inputs,attrs", [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_spectral_op(op, inputs, attrs):
    tg, feed = _build(TBuilder, TDataType, op, inputs, attrs)
    jg, _ = _build(JBuilder, JDataType, op, inputs, attrs)
    got = TModel(tg, TOptions(optimize=False), device="cpu").run(feed, ["y"])[0].numpy()
    want = np.asarray(JModel(jg, JOptions(optimize=False)).run(feed, ["y"])[0])
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_stft_frames_and_bins():
    """STFT [B, L] with frame step s and a window of n gives [B, 1 + (L -
    n) // s, n // 2 + 1, 2], each frame the windowed rfft of its samples."""
    tg, feed = _build(TBuilder, TDataType, "STFT", [SIG, _const(64), ("const", HANN)], {})
    got = TModel(tg, TOptions(optimize=False), device="cpu").run(feed, ["y"])[0].numpy()
    n_frames = 1 + (SIG.shape[1] - 128) // 64
    assert got.shape == (2, n_frames, 65, 2)
    want = np.fft.rfft(SIG[1, 3 * 64:3 * 64 + 128] * HANN)
    assert np.abs(got[1, 3, :, 0] + 1j * got[1, 3, :, 1] - want).max() <= 1e-5 * np.abs(want).max()
