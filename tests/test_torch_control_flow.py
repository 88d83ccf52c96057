"""If and Loop in the port (``rten_tpu_torch/ops/control_flow.py`` and the
executor's subgraphs) against the JAX package, exact: torch.jit.script
exports (a scripted loop, a scripted branch) and hand-built graphs with
captures nested two scopes deep, a Loop with scan outputs and a Loop whose
condition ends it early. The JAX package runs eagerly (``jit=False``),
the port on the CPU; both take the same graphs on the same inputs."""

import numpy as np
import pytest
import torch

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


class LoopNet(torch.nn.Module):
    def forward(self, x, n: int):
        out = x
        for i in range(n):
            out = out * 2.0 + float(i)
        return out


class CondNet(torch.nn.Module):
    def forward(self, x):
        if bool(x.sum() > 0):
            return x * 2.0
        else:
            return x - 1.0


class WhileNet(torch.nn.Module):
    def forward(self, x, limit: float):
        while bool(x.sum() < limit):
            x = x * 1.5 + 0.25
        return x


def _both(path, opt):
    return (TModel.load_file(path, TOptions(optimize=opt), device="cpu"),
            JModel.load_file(path, JOptions(optimize=opt)))


def _same(tm, jm, feed, names=None, **kw):
    got = [t.numpy() for t in tm.run(feed, names, **kw)]
    want = [np.asarray(a) for a in jm.run(feed, names, jit=False, **kw)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, g.shape, w.dtype, w.shape)
        np.testing.assert_array_equal(g, w)
    return got


@pytest.mark.parametrize("opt", [False, True])
def test_scripted_loop(tmp_path, opt):
    path = export_onnx(torch.jit.script(LoopNet()), (torch.randn(3), 4),
                       str(tmp_path / "loop.onnx"), ["x", "n"], ["y"])
    tm, jm = _both(path, opt)
    assert "Loop" in {op.op_type for _, op in tm.graph.operators()}
    x = np.float32([1, 2, 3])
    for n in (0, 1, 4):
        y = _same(tm, jm, {"x": x, "n": np.int64(n)})[0]
        want = x.copy()
        for i in range(n):
            want = want * 2 + i
        np.testing.assert_array_equal(y, want)


@pytest.mark.parametrize("opt", [False, True])
def test_scripted_if(tmp_path, opt):
    path = export_onnx(torch.jit.script(CondNet()), (torch.randn(3),),
                       str(tmp_path / "if.onnx"), ["x"], ["y"])
    tm, jm = _both(path, opt)
    assert "If" in {op.op_type for _, op in tm.graph.operators()}
    for x in (np.float32([1, 2, 3]), np.float32([-1, -2, -3])):
        y = _same(tm, jm, {"x": x})[0]
        np.testing.assert_array_equal(y, x * 2 if x.sum() > 0 else x - 1)


def test_scripted_while_ends_on_its_condition(tmp_path):
    """A data-dependent while loop exports as a Loop with no trip count:
    its condition, read after every iteration, ends it."""
    path = export_onnx(torch.jit.script(WhileNet()), (torch.ones(2), 10.0),
                       str(tmp_path / "while.onnx"), ["x", "limit"], ["y"])
    tm, jm = _both(path, False)
    for limit in (0.0, 3.0, 50.0):
        x = np.float32([0.5, 1.0])
        y = _same(tm, jm, {"x": x, "limit": np.float32(limit)})[0]
        want = x.copy()
        while want.sum() < limit:
            want = want * np.float32(1.5) + np.float32(0.25)
        np.testing.assert_array_equal(y, want)


# --- hand-built graphs -------------------------------------------------------


def _capture(bm, b, name):
    """A value ``name`` of an enclosing scope, captured by the subgraph
    ``b`` builds."""
    nid = b.graph.add_value(name)
    b.graph.captures.append(name)
    return bm.Expr(b, nid)


def _nested_graph(bm, DT, early_exit):
    """x [3] f32, flag bool, n int32; s = x + x. If(flag):
    then: Loop(n, cond, acc = s) whose body captures x (two scopes up) and s
          (one scope up): acc' = acc + x * i, scan acc' * s; with
          ``early_exit`` the body's condition is sum(acc') < 40, so the loop
          may end before n iterations. The branch returns (acc, scans).
    else: (-x, x stacked with s), captured from the main graph."""
    GB = bm.GraphBuilder
    body = GB()
    i = body.input("i", DT.Int32, ())
    cond_in = body.input("cond_in", DT.Bool, ())
    acc = body.input("acc_in", DT.Float, (3,))
    x_cap, s_cap = _capture(bm, body, "x"), _capture(bm, body, "s")
    acc2 = body.op("Add", [acc, body.op("Mul", [x_cap, body.op("Cast", [i], {"to": DT.Float})])])
    if early_exit:
        total = body.op("ReduceSum", [acc2], {"keepdims": 0})
        cond_out = body.op("Less", [total, body.constant("limit", np.float32(40.0))])
    else:
        cond_out = body.op("Identity", [cond_in])
    body.output(cond_out, acc2, body.op("Mul", [acc2, s_cap]))

    then = GB()
    n_cap, s_then = _capture(bm, then, "n"), _capture(bm, then, "s")
    fin, scans = then.op("Loop", [n_cap, then.constant("true", np.bool_(True)), s_then],
                         {"body": body.finish()}, n_outputs=2)
    then.output(fin, scans)

    other = GB()
    x_else, s_else = _capture(bm, other, "x"), _capture(bm, other, "s")
    stacked = other.op("Concat", [other.op("Unsqueeze", [v, other.constant("ax", np.int32([0]))])
                                  for v in (x_else, s_else)], {"axis": 0})
    other.output(other.op("Neg", [x_else]), stacked)

    b = GB()
    x = b.input("x", DT.Float, (3,))
    flag = b.input("flag", DT.Bool, ())
    b.input("n", DT.Int32, ())
    s = b.op("Add", [x, x], output_names=["s"])
    out, seq = b.op("If", [flag], {"then_branch": then.finish(), "else_branch": other.finish()},
                    n_outputs=2, output_names=["out", "seq"])
    b.output(out, seq, s)
    return b.finish()


@pytest.mark.parametrize("early_exit", [False, True], ids=["trip-count", "early-exit"])
@pytest.mark.parametrize("flag,n", [(True, 0), (True, 1), (True, 5), (False, 3)])
def test_nested_captures_and_scan_outputs(early_exit, flag, n):
    tm = TModel(_nested_graph(tbuilder, TDataType, early_exit), TOptions(optimize=False),
                device="cpu")
    jm = JModel(_nested_graph(jbuilder, JDataType, early_exit), JOptions(optimize=False))
    x = np.float32([1.0, 2.0, 3.0])
    feed = {"x": x, "flag": np.bool_(flag), "n": np.int32(n)}
    out, seq, _ = _same(tm, jm, feed)
    if flag:
        acc, rows = 2 * x, []
        for i in range(n):
            acc = acc + x * np.float32(i)
            rows.append(acc * 2 * x)
            if early_exit and not acc.sum() < 40:
                break
        np.testing.assert_array_equal(out, acc)
        np.testing.assert_array_equal(seq, np.stack(rows) if rows else np.zeros(0, np.float32))
        if early_exit and n == 5:
            assert len(rows) < n  # the condition ended the loop
    else:
        np.testing.assert_array_equal(out, -x)


def test_if_on_a_static_flag_reads_no_device_value(monkeypatch):
    """``static_inputs`` keeps a flag a host value: the If reads a numpy
    array (no device sync); fed as an ordinary input, the flag is a tensor.
    Both give the same result, a tensor."""
    from rten_tpu_torch.ops import control_flow

    seen = []
    real = control_flow.host_value

    def spy(x):
        seen.append(type(x))
        return real(x)

    monkeypatch.setattr(control_flow, "host_value", spy)
    tm = TModel(_nested_graph(tbuilder, TDataType, False), TOptions(optimize=False),
                device="cpu")
    feed = {"x": np.float32([1, 2, 3]), "flag": np.bool_(True), "n": np.int32(2)}
    a = tm.run(feed, ["out"], static_inputs=["flag"])[0]
    assert seen[0] is np.ndarray
    seen.clear()
    b = tm.run(feed, ["out"])[0]
    assert seen[0] is torch.Tensor
    assert isinstance(a, torch.Tensor) and torch.equal(a, b)


def test_unresolved_capture_raises():
    """A subgraph that captures a name no enclosing scope holds fails,
    naming it."""
    from rten_tpu_torch.ops.registry import OpError

    branch = tbuilder.GraphBuilder()
    branch.output(branch.op("Neg", [_capture(tbuilder, branch, "nowhere")]))
    b = tbuilder.GraphBuilder()
    flag = b.input("flag", TDataType.Bool, ())
    b.output(b.op("If", [flag], {"then_branch": branch.finish(), "else_branch": branch.graph},
                  output_names=["y"]))
    tm = TModel(b.finish(), TOptions(optimize=False), device="cpu")
    with pytest.raises(OpError, match="unresolved capture 'nowhere'"):
        tm.run({"flag": np.bool_(True)})
