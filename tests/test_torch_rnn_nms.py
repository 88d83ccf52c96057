"""LSTM, GRU and NonMaxSuppression in the port (``rten_tpu_torch/ops/
rnn.py``, ``ops/nms.py``) against the JAX package's, as
``tests/test_ops_extended.py`` sets them up (torch's weights reordered to
ONNX's gate orders): LSTM forward and bidirectional, GRU with and without
``linear_before_reset``, with sequence lengths, initial states and layout
1, within 1e-5; an LSTM exported from torch through ONNX in both
packages; NMS exact, on the test's boxes and on seeded ones."""

import numpy as np
import pytest
import torch

from onnx_export_util import export_onnx
from rten_tpu.dtypes import DataType as JDataType
from rten_tpu.ir.builder import GraphBuilder as JBuilder
from rten_tpu.model import Model as JModel
from rten_tpu.model import ModelOptions as JOptions
from rten_tpu_torch.dtypes import DataType as TDataType
from rten_tpu_torch.ir.builder import GraphBuilder as TBuilder
from rten_tpu_torch.model import Model as TModel
from rten_tpu_torch.model import ModelOptions as TOptions
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-5


def _build(GB, DT, op, inputs, attrs, n_out, consts):
    b = GB()
    ins, feed = [], {}
    for i, x in enumerate(inputs):
        if x is None:
            ins.append(None)
        elif i in consts:
            ins.append(b.constant(f"c{i}", x))
        else:
            ins.append(b.input(f"x{i}", DT.from_np(x.dtype), x.shape))
            feed[f"x{i}"] = x
    names = [f"y{i}" for i in range(n_out)]
    outs = b.op(op, ins, attrs, n_outputs=n_out, output_names=names)
    b.output(*(outs if n_out > 1 else (outs,)))
    return b.finish(), feed, names


def _run_both(op, inputs, attrs, n_out, consts=()):
    tg, feed, names = _build(TBuilder, TDataType, op, inputs, attrs, n_out, set(consts))
    jg, _, _ = _build(JBuilder, JDataType, op, inputs, attrs, n_out, set(consts))
    got = [t.numpy() for t in TModel(tg, TOptions(optimize=False), device="cpu").run(feed, names)]
    want = [np.asarray(a) for a in JModel(jg, JOptions(optimize=False)).run(feed, names,
                                                                             jit=False)]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, g.shape, w.dtype, w.shape)
    return got, want


def _lstm_weights(m, dirs):
    """torch's LSTM weights in ONNX's layout (gates ifgo -> iofc)."""
    def reorder(w):
        i, f, g, o = np.split(w, 4, axis=0)
        return np.concatenate([i, o, f, g], axis=0)

    Ws, Rs, Bs = [], [], []
    for d in range(dirs):
        sfx = "_reverse" if d == 1 else ""
        p = {n: getattr(m, f"{n}_l0{sfx}").detach().numpy()
             for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")}
        Ws.append(reorder(p["weight_ih"]))
        Rs.append(reorder(p["weight_hh"]))
        Bs.append(np.concatenate([reorder(p["bias_ih"][:, None])[:, 0],
                                  reorder(p["bias_hh"][:, None])[:, 0]]))
    return [np.stack(a).astype(np.float32) for a in (Ws, Rs, Bs)]


@pytest.mark.parametrize("bidirectional", [False, True])
def test_lstm_against_jax_and_torch(bidirectional):
    I, H, T, B = 8, 12, 5, 3
    torch.manual_seed(0)
    m = torch.nn.LSTM(I, H, bidirectional=bidirectional)
    x = torch.randn(T, B, I)
    with torch.no_grad():
        want_y, (want_h, want_c) = m(x)
    dirs = 2 if bidirectional else 1
    W, Rw, Bias = _lstm_weights(m, dirs)
    attrs = {"hidden_size": H, "direction": "bidirectional" if bidirectional else "forward"}
    got, want = _run_both("LSTM", [x.numpy(), W, Rw, Bias], attrs, 3)
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= TOL
    y_torch = want_y.numpy().reshape(T, B, dirs, H).transpose(0, 2, 1, 3)
    for g, w in zip(got, (y_torch, want_h.numpy(), want_c.numpy())):
        assert np.abs(g - w).max() <= TOL


@pytest.mark.parametrize("direction", ["forward", "reverse", "bidirectional"])
def test_lstm_lengths_and_initial_states(direction):
    """sequence_lens, initial h and c, and the reverse direction: past a
    batch entry's length its state stays and its output is 0."""
    rng = np.random.default_rng(3)
    I, H, T, B = 4, 6, 7, 3
    dirs = 2 if direction == "bidirectional" else 1
    W = rng.standard_normal((dirs, 4 * H, I)).astype(np.float32) * 0.5
    Rw = rng.standard_normal((dirs, 4 * H, H)).astype(np.float32) * 0.5
    Bias = rng.standard_normal((dirs, 8 * H)).astype(np.float32) * 0.1
    x = rng.standard_normal((T, B, I)).astype(np.float32)
    lens = np.int32([7, 3, 5])
    h0, c0 = (rng.standard_normal((dirs, B, H)).astype(np.float32) for _ in "hc")
    got, want = _run_both("LSTM", [x, W, Rw, Bias, lens, h0, c0],
                          {"hidden_size": H, "direction": direction}, 3)
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= TOL
    assert (got[0][3:, :, 1] == 0).all()  # entry 1 ends after 3 steps


@pytest.mark.parametrize("linear_before_reset", [0, 1])
@pytest.mark.parametrize("direction", ["forward", "bidirectional"])
def test_gru_against_jax(linear_before_reset, direction):
    rng = np.random.default_rng(linear_before_reset)
    I, H, T, B = 6, 10, 4, 2
    dirs = 2 if direction == "bidirectional" else 1
    W = rng.standard_normal((dirs, 3 * H, I)).astype(np.float32) * 0.4
    Rw = rng.standard_normal((dirs, 3 * H, H)).astype(np.float32) * 0.4
    Bias = rng.standard_normal((dirs, 6 * H)).astype(np.float32) * 0.2
    x = rng.standard_normal((T, B, I)).astype(np.float32)
    h0 = rng.standard_normal((dirs, B, H)).astype(np.float32)
    got, want = _run_both("GRU", [x, W, Rw, Bias, None, h0],
                          {"hidden_size": H, "direction": direction,
                           "linear_before_reset": linear_before_reset}, 2)
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= TOL


def test_gru_matches_torch_with_linear_before_reset():
    """torch's GRU is ONNX's with linear_before_reset = 1 (gates rzn -> zrh)."""
    I, H, T, B = 6, 10, 4, 2
    torch.manual_seed(1)
    m = torch.nn.GRU(I, H)
    x = torch.randn(T, B, I)
    with torch.no_grad():
        want_y, want_h = m(x)

    def reorder(w):
        r, z, n = np.split(w, 3, axis=0)
        return np.concatenate([z, r, n], axis=0)

    W = reorder(m.weight_ih_l0.detach().numpy())[None]
    Rw = reorder(m.weight_hh_l0.detach().numpy())[None]
    Bias = np.concatenate([reorder(m.bias_ih_l0.detach().numpy()[:, None])[:, 0],
                           reorder(m.bias_hh_l0.detach().numpy()[:, None])[:, 0]])[None]
    got, _ = _run_both("GRU", [x.numpy(), W, Rw, Bias], {"hidden_size": H,
                                                         "linear_before_reset": 1}, 2)
    assert np.abs(got[0][:, 0] - want_y.numpy()).max() <= TOL
    assert np.abs(got[1] - want_h.numpy()).max() <= TOL


def test_rnn_layout_1():
    """layout 1: X [B, T, I] -> Y [B, T, dirs, H], Y_h [B, dirs, H]."""
    rng = np.random.default_rng(9)
    I, H, T, B = 5, 4, 6, 3
    W = rng.standard_normal((2, 3 * H, I)).astype(np.float32) * 0.5
    Rw = rng.standard_normal((2, 3 * H, H)).astype(np.float32) * 0.5
    x = rng.standard_normal((B, T, I)).astype(np.float32)
    got, want = _run_both("GRU", [x, W, Rw], {"hidden_size": H, "direction": "bidirectional",
                                              "layout": 1}, 2)
    assert got[0].shape == (B, T, 2, H) and got[1].shape == (B, 2, H)
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= TOL


def test_exported_lstm_runs_in_both_packages(tmp_path):
    """torch.nn.LSTM exported to ONNX and loaded by both packages' Model."""
    torch.manual_seed(2)
    lstm = torch.nn.LSTM(4, 3, bidirectional=True)
    path = export_onnx(lstm, torch.randn(5, 1, 4), str(tmp_path / "lstm.onnx"), ["x"], ["y"])
    tm = TModel.load_file(path, device="cpu")
    jm = JModel.load_file(path)
    assert "LSTM" in {op.op_type for _, op in tm.graph.operators()}
    x = np.random.default_rng(2).standard_normal((5, 1, 4)).astype(np.float32)
    got = tm.run({"x": x})[0].numpy()
    want = np.asarray(jm.run({"x": x})[0])
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL
    with torch.no_grad():
        assert np.abs(got - lstm(torch.from_numpy(x))[0].numpy()).max() <= TOL


# --- NonMaxSuppression --------------------------------------------------------


def test_nms_extended_case():
    boxes = np.float32([[[0, 0, 1, 1], [0, 0.05, 1, 1.05], [2, 2, 3, 3]]])
    scores = np.float32([[[0.9, 0.8, 0.7]]])
    got, want = _run_both("NonMaxSuppression", [boxes, scores, np.int32(10), np.float32(0.5)],
                          {}, 1, consts=(0, 1, 2, 3))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0], np.int32([[0, 0, 0], [0, 0, 2]]))


@pytest.mark.parametrize("center,score_thresh,max_out", [
    (0, None, 100), (1, None, 100), (0, 0.3, 100), (0, 0.1, 2),
])
def test_nms_seeded_boxes(center, score_thresh, max_out):
    """Seeded boxes in two batches and three classes, as graph inputs (the
    op reads them back on the host): the same selections in the same
    order."""
    rng = np.random.default_rng(4)
    B, C, N = 2, 3, 40
    xy = rng.uniform(0, 10, (B, N, 2)).astype(np.float32)
    wh = rng.uniform(0.5, 3, (B, N, 2)).astype(np.float32)
    boxes = (np.concatenate([xy, wh], -1) if center
             else np.concatenate([xy[..., ::-1], xy[..., ::-1] + wh], -1)).astype(np.float32)
    scores = rng.uniform(0, 1, (B, C, N)).astype(np.float32)
    ins = [boxes, scores, np.int32(max_out), np.float32(0.4)]
    if score_thresh is not None:
        ins.append(np.float32(score_thresh))
    got, want = _run_both("NonMaxSuppression", ins, {"center_point_box": center}, 1,
                          consts=range(2, len(ins)))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].shape[0] > B * C
