"""The sequence ops of the port (``rten_tpu_torch/ops/sequence.py``)
against the JAX package's, exact: every op in small graphs that build
their sequences themselves (SequenceEmpty, SequenceConstruct,
SplitToSequence), with the data as graph inputs and, where every value is
a host value, as constants (the port then runs the ops on the host); and
torch.jit.script loops over lists, which export as these ops inside a
Loop. The JAX package runs eagerly (``jit=False``); neither package
optimizes the graphs (the JAX package's constant propagation folds a
sequence into an array)."""

import numpy as np
import pytest
import torch
from typing import List

from onnx_export_util import export_onnx
from rten_tpu.dtypes import DataType as JDataType
from rten_tpu.ir import builder as jbuilder
from rten_tpu.model import Model as JModel
from rten_tpu.model import ModelOptions as JOptions
from rten_tpu_torch.dtypes import DataType as TDataType
from rten_tpu_torch.ir import builder as tbuilder
from rten_tpu_torch.model import Model as TModel
from rten_tpu_torch.model import ModelOptions as TOptions
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

R = np.random.default_rng(5)
X = [R.standard_normal((2, 3)).astype(np.float32) for _ in range(3)]
BIG = R.standard_normal((6, 4)).astype(np.float32)
SHAPES = [np.int32([2, 3]), np.int32([4, 1]), np.int32([7, 7])]


def _seq(b, DT, data, mode):
    """SequenceConstruct of ``data``, graph inputs or constants."""
    if mode == "const":
        ins = [b.constant(f"x{i}", a) for i, a in enumerate(data)]
    else:
        ins = [b.input(f"x{i}", DT.from_np(a.dtype), a.shape) for i, a in enumerate(data)]
    return b.op("SequenceConstruct", ins)


def _c(b, v):
    return b.constant(None, np.asarray(v, np.int32))


# (id, data, build(b, DT, seq, data, mode) -> output exprs)
CASES = [
    ("length", X, lambda b, DT, s, d, m: [b.op("SequenceLength", [s])]),
    ("at-1", X, lambda b, DT, s, d, m: [b.op("SequenceAt", [s, _c(b, 1)])]),
    ("at-neg", X, lambda b, DT, s, d, m: [b.op("SequenceAt", [s, _c(b, -1)])]),
    ("insert-end", X, lambda b, DT, s, d, m: [b.op(
        "ConcatFromSequence", [b.op("SequenceInsert", [s, b.op("Neg", [b.op(
            "SequenceAt", [s, _c(b, 0)])])])], {"axis": 0})]),
    ("insert-pos", X, lambda b, DT, s, d, m: [b.op(
        "ConcatFromSequence", [b.op("SequenceInsert", [s, b.op("SequenceAt", [s, _c(b, 2)]),
                                                       _c(b, -1)])], {"axis": 1})]),
    ("erase-pos", X, lambda b, DT, s, d, m: [b.op(
        "ConcatFromSequence", [b.op("SequenceErase", [s, _c(b, 1)])], {"axis": 0})]),
    ("erase-last", X, lambda b, DT, s, d, m: [b.op("SequenceLength", [
        b.op("SequenceErase", [s])])]),
    ("concat-new-axis", X, lambda b, DT, s, d, m: [b.op(
        "ConcatFromSequence", [s], {"axis": 1, "new_axis": 1})]),
    ("empty-then-insert", X, lambda b, DT, s, d, m: [b.op(
        "ConcatFromSequence", [b.op("SequenceInsert", [b.op("SequenceInsert", [
            b.op("SequenceEmpty", [], {"dtype": 1}), b.op("SequenceAt", [s, _c(b, 1)])]),
            b.op("SequenceAt", [s, _c(b, 0)]), _c(b, 0)])], {"axis": 0})]),
    ("shapes-on-the-host", SHAPES, lambda b, DT, s, d, m: [
        b.op("ConcatFromSequence", [s], {"axis": 0}), b.op("SequenceLength", [s])]),
]


def _split_case(split, keepdims):
    def build(b, DT, s, d, m):
        x = b.op("SequenceAt", [s, _c(b, 0)])
        ins = [x] if split is None else [x, _c(b, split)]
        parts = b.op("SplitToSequence", ins, {"axis": 0, "keepdims": keepdims})
        return [b.op("SequenceLength", [parts]), b.op("SequenceAt", [parts, _c(b, -1)]),
                b.op("ConcatFromSequence", [parts], {"axis": 0})]
    return build


for sid, split, keep in [("none", None, 1), ("none-squeeze", None, 0), ("scalar", 4, 1),
                         ("sizes", [1, 2, 3], 1)]:
    CASES.append((f"split-{sid}", [BIG], _split_case(split, keep)))


def _graph(bm, DT, data, build, mode):
    b = bm.GraphBuilder()
    outs = build(b, DT, _seq(b, DT, data, mode), data, mode)
    names = [f"y{i}" for i in range(len(outs))]
    for o, n in zip(outs, names):
        b.graph.nodes[o.node_id].name = n
        b.graph._name_to_id[n] = o.node_id
    b.output(*outs)
    return b.finish(), names


@pytest.mark.parametrize("mode", ["input", "const"])
@pytest.mark.parametrize("cid,data,build", CASES, ids=[c[0] for c in CASES])
def test_sequence_op(cid, data, build, mode):
    tg, names = _graph(tbuilder, TDataType, data, build, mode)
    jg, _ = _graph(jbuilder, JDataType, data, build, mode)
    feed = {} if mode == "const" else {f"x{i}": a for i, a in enumerate(data)}
    got = [t.numpy() for t in TModel(tg, TOptions(optimize=False), device="cpu").run(feed, names)]
    want = [np.asarray(a) for a in JModel(jg, JOptions(optimize=False)).run(feed, names,
                                                                             jit=False)]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, g.shape, w.dtype, w.shape)
        np.testing.assert_array_equal(g, w)


def test_sequence_output_is_a_list_of_tensors():
    """A graph whose output is a sequence returns a list of tensors, equal
    to the JAX package's list element by element."""
    def build(b, DT, s, d, m):
        return [b.op("SplitToSequence", [b.op("SequenceAt", [s, _c(b, 0)]), _c(b, [2, 4])],
                     {"axis": 0})]

    tg, names = _graph(tbuilder, TDataType, [BIG], build, "input")
    jg, _ = _graph(jbuilder, JDataType, [BIG], build, "input")
    got = TModel(tg, TOptions(optimize=False), device="cpu").run({"x0": BIG}, names)[0]
    want = JModel(jg, JOptions(optimize=False)).run({"x0": BIG}, names, jit=False)[0]
    assert isinstance(got, list) and all(isinstance(t, torch.Tensor) for t in got)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


class AppendLoop(torch.nn.Module):
    def forward(self, x, n: int):
        outs: List[torch.Tensor] = []
        for i in range(n):
            outs.append(x * float(i + 1))
        return torch.cat(outs, 0)


class SplitLoop(torch.nn.Module):
    def forward(self, x):
        outs: List[torch.Tensor] = []
        for p in torch.split(x, 2, 0):
            outs.append(p * 2.0 - 1.0)
        return torch.stack(outs, 0)


@pytest.mark.parametrize("net,args,feeds", [
    (AppendLoop, (torch.randn(3), 4), [{"n": np.int64(1)}, {"n": np.int64(3)}]),
    (SplitLoop, (torch.randn(6, 3),), [{}]),
], ids=["append", "split"])
def test_scripted_list_loops(tmp_path, net, args, feeds):
    names = ["x", "n"][:len(args)]
    path = export_onnx(torch.jit.script(net()), args, str(tmp_path / "seq.onnx"), names, ["y"])
    tm = TModel.load_file(path, TOptions(optimize=False), device="cpu")
    jm = JModel.load_file(path, JOptions(optimize=False))
    ops = {op.op_type for _, op in tm.graph.operators()}
    assert "Loop" in ops and ops & {"SequenceEmpty", "SplitToSequence"}
    x = R.standard_normal(tuple(args[0].shape)).astype(np.float32)
    for extra in feeds:
        feed = {"x": x, **extra}
        got = tm.run(feed)[0].numpy()
        np.testing.assert_array_equal(got, np.asarray(jm.run(feed, jit=False)[0]))
        want = net()(torch.from_numpy(x), *[int(v) for v in extra.values()]).numpy()
        np.testing.assert_array_equal(got, want)
    # The port's optimizer leaves sequences unfolded, so the optimized graph
    # gives the same result.
    opt = TModel.load_file(path, device="cpu")
    np.testing.assert_array_equal(opt.run(feed)[0].numpy(), got)
