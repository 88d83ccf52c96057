"""The port's model files against the JAX package's: ONNX parsing, the
``.rtpu`` and ``.rten`` containers in both directions, malformed files and
external tensor data.

* An export parses to the same ``ModelProto`` in both packages (every
  field, the tensors' raw bytes included).
* A file written by either package loads in the other to the graph that
  the writer's own package loads from it: node ids, names, op types,
  attributes, subgraphs and constants (dtype, shape and bytes) equal, for
  an exported GPT-2-shaped model, its prepacked int8 graph (``.rtpu``
  only: contrib ops have no ``.rten`` encoding) and an If with captured
  subgraphs.
* Malformed bytes raise the port's typed errors, case for case with
  ``tests/test_malformed_models.py``, within the same time bound.
* External data loads, and a path escape or a missing file fails, as in
  ``tests/test_onnx_external_data.py``.
"""

import dataclasses
import os
import struct
import sys
import time

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import gpt2_onnx  # noqa: E402
import test_malformed_models as tmm  # noqa: E402
from test_onnx_external_data import make_model_with_external_weight  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401

from rten_tpu.dtypes import DataType as JDataType  # noqa: E402
from rten_tpu.formats import onnx as jonnx  # noqa: E402
from rten_tpu.ir.graph import Graph as JGraph  # noqa: E402
from rten_tpu.model import Model as JModel  # noqa: E402
from rten_tpu.model import ModelOptions as JOptions  # noqa: E402
from rten_tpu.quantize_pass import quantize_dynamic as jquantize  # noqa: E402
from rten_tpu_torch.cli import quantize_model  # noqa: E402
from rten_tpu_torch.dtypes import DataType as TDataType  # noqa: E402
from rten_tpu_torch.formats import onnx as tonnx  # noqa: E402
from rten_tpu_torch.formats.protobuf import ProtobufError  # noqa: E402
from rten_tpu_torch.formats.rten import RtenFormatError  # noqa: E402
from rten_tpu_torch.ir.graph import Graph as TGraph  # noqa: E402
from rten_tpu_torch.model import LoadError, Model as TModel  # noqa: E402
from rten_tpu_torch.model import ModelOptions as TOptions  # noqa: E402

TYPED = (LoadError, ProtobufError, RtenFormatError)
SMALL = gpt2_onnx.GPT2Shape(vocab_size=256, n_positions=64, n_embd=64, n_layer=2, n_head=2)


def _plain(x):
    """A parsed message as plain python: dataclasses to (class name, fields),
    memoryviews to bytes, numpy to (dtype, shape, bytes)."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,
                {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, memoryview):
        return bytes(x)
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


def _sig(g):
    """A graph as plain python, node ids kept: values (name, dtype, shape),
    constants (name, dtype, shape, bytes), ops (name, type, inputs, outputs,
    attributes; Graph attributes recursively), IO and captures."""
    def attr(v):
        if isinstance(v, (TGraph, JGraph)):
            return ("graph", _sig(v))
        if isinstance(v, (TDataType, JDataType)):
            return ("dtype", v.value)
        if isinstance(v, np.ndarray):
            return ("array", v.dtype.str, v.shape, v.tobytes())
        if isinstance(v, (list, tuple)):
            return [attr(x) for x in v]
        return v

    nodes = {}
    for nid, n in g.nodes.items():
        kind = type(n).__name__
        if kind == "Value":
            nodes[nid] = (kind, n.name, n.dtype.value if n.dtype else None,
                          None if n.shape is None else tuple(n.shape))
        elif kind == "Constant":
            a = np.asarray(n.array)
            nodes[nid] = (kind, n.name, a.dtype.str, a.shape, a.tobytes())
        else:
            nodes[nid] = (kind, n.name, n.op_type, list(n.inputs), list(n.outputs),
                          {k: attr(v) for k, v in sorted(n.attrs.items())})
    return nodes, list(g.input_ids), list(g.output_ids), list(g.captures)


@pytest.fixture(scope="module")
def gpt2_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("fmt") / "gpt2.onnx"
    return gpt2_onnx.export(gpt2_onnx.GPT2Module(SMALL, seed=1), path, batch=2, seq=6)


def test_onnx_parses_to_the_same_model_proto(gpt2_path):
    data = open(gpt2_path, "rb").read()
    t, j = tonnx.parse_model(data), jonnx.parse_model(data)
    assert len(t.graph.node) > 50 and len(t.graph.initializer) > 10
    assert _plain(t) == _plain(j)


def _if_graph(G, DT):
    """If(cond) with branches x*2 and x*3, x captured by name."""
    g = G()
    cond = g.add_value("cond", DT.Bool, ())
    xv = g.add_value("x", DT.Float, (2,))
    out = g.add_value("out", DT.Float, (2,))

    def branch(mult):
        sg = G()
        cap = sg.add_value("x")
        sg.captures.append("x")
        k = sg.add_constant("k", np.float32(mult))
        o = sg.add_value(f"o{mult}", DT.Float, (2,))
        sg.add_op("Mul", [cap, k], [o])
        sg.output_ids = [o]
        return sg

    g.add_op("If", [cond], [out], {"then_branch": branch(2.0), "else_branch": branch(3.0)})
    g.input_ids, g.output_ids = [cond, xv], [out]
    return g


def _model(pkg, kind, gpt2_path):
    """A model of ``kind`` built by package ``pkg`` ("port" or "jax")."""
    if kind == "if":
        if pkg == "port":
            return TModel(_if_graph(TGraph, TDataType), TOptions(optimize=False), device="cpu")
        return JModel(_if_graph(JGraph, JDataType), JOptions(optimize=False))
    m = TModel.load_file(gpt2_path, device="cpu") if pkg == "port" else JModel.load_file(gpt2_path)
    if kind == "int8":
        if pkg == "port":
            quantize_model(m, "int8")
        else:
            from rten_tpu.optimize import eliminate_dead_constants, prepack_int8_weights

            jquantize(m.graph)
            prepack_int8_weights(m.graph)
            eliminate_dead_constants(m.graph)
        assert any(op.op_type == "MatMulIntegerToFloat" and len(op.inputs) == 8
                   for _, op in m.graph.operators())
    return m


def _load(pkg, path):
    if pkg == "port":
        return TModel.load_file(path, TOptions(optimize=False), device="cpu")
    return JModel.load_file(path, JOptions(optimize=False))


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("fmt,kind", [("rtpu", "f32"), ("rtpu", "int8"), ("rtpu", "if"),
                                      ("rten", "f32"), ("rten", "if")])
def test_files_load_in_the_other_package(writer, fmt, kind, gpt2_path, tmp_path):
    path = str(tmp_path / f"m.{fmt}")
    _model(writer, kind, gpt2_path).save(path)
    reader = "jax" if writer == "port" else "port"
    assert _sig(_load(reader, path).graph) == _sig(_load(writer, path).graph)


def test_port_rtpu_keeps_the_graph_it_saved(gpt2_path, tmp_path):
    """The port's own round trip returns its graph unchanged, 0-d constants
    included (the JAX package's writer stores them as [1])."""
    m = _model("port", "int8", gpt2_path)
    path = str(tmp_path / "m.rtpu")
    m.save(path)
    nodes, ins, outs, caps = _sig(_load("port", path).graph)
    want_nodes, want_ins, want_outs, _ = _sig(m.graph)
    assert (sorted(str(n[:2]) for n in nodes.values())
            == sorted(str(n[:2]) for n in want_nodes.values()))
    consts = {n[1]: n[2:] for n in nodes.values() if n[0] == "Constant"}
    assert consts == {n[1]: n[2:] for n in want_nodes.values() if n[0] == "Constant"}
    ids = np.random.default_rng(0).integers(0, SMALL.vocab_size, (2, 5)).astype(np.int32)
    np.testing.assert_array_equal(_load("port", path).run({"input_ids": ids})[0].numpy(),
                                  m.run({"input_ids": ids})[0].numpy())


def test_if_graph_loads_and_names_its_roadmap_item(tmp_path):
    """The port loads an If graph the JAX package saved and runs it (both
    branches, JAX's answers); a saved graph holding a random op
    (RandomUniform, which the port once refused) loads, and each run draws
    anew in [0, 1), the same as the JAX package on its own file."""
    path = str(tmp_path / "if.rtpu")
    _model("jax", "if", None).save(path)
    m, jm = _load("port", path), _load("jax", path)
    x = np.float32([1.5, -2.0])
    for cond in (True, False):
        feed = {"cond": np.array(cond), "x": x}
        got = m.run(feed)[0].numpy()
        np.testing.assert_array_equal(got, np.asarray(jm.run(feed, jit=False)[0]))
        np.testing.assert_array_equal(got, x * (2 if cond else 3))
    g = TGraph()
    y = g.add_value("y", TDataType.Float, (2,))
    g.add_op("RandomUniform", [], [y], {"shape": [2]})
    g.output_ids = [y]
    path = str(tmp_path / "random.rtpu")
    TModel(g, TOptions(optimize=False), device="cpu").save(path)
    m = _load("port", path)
    a, b = (m.run({})[0].numpy() for _ in range(2))
    want = np.asarray(_load("jax", path).run({})[0])
    for x in (a, b, want):
        assert x.shape == (2,) and x.dtype == np.float32 and ((x >= 0) & (x < 1)).all()
    assert not np.array_equal(a, b)


# --- malformed files: the cases of tests/test_malformed_models.py ------------


def _load_bytes(data):
    return TModel.load(data, device="cpu")


def _rejects(data, what):
    t0 = time.monotonic()
    with pytest.raises(TYPED):
        _load_bytes(data)
    assert time.monotonic() - t0 < tmm.TIME_BOUND_S, what


def _loads_or_rejects(data, bound=tmm.TIME_BOUND_S):
    t0 = time.monotonic()
    try:
        _load_bytes(data)
    except TYPED:
        pass
    assert time.monotonic() - t0 < bound


@pytest.fixture(scope="module")
def valid_onnx():
    graph = (tmm._field_bytes(1, tmm._node("Relu", ["x"], ["y"]))
             + tmm._field_bytes(11, tmm._value_info("x"))
             + tmm._field_bytes(12, tmm._value_info("y")))
    data = tmm._model(graph)
    assert _load_bytes(data).run({"x": np.array([-1.0], np.float32)})[0].tolist() == [0.0]
    return data


@pytest.fixture(scope="module")
def valid_rten(tmp_path_factory):
    from rten_tpu_torch.ir.builder import GraphBuilder

    b = GraphBuilder()
    x = b.input("x", TDataType.Float, (2, 2))
    b.output(b.op("MatMul", [x, b.constant("w", np.eye(2, dtype=np.float32))]))
    path = tmp_path_factory.mktemp("rten") / "m.rten"
    TModel(b.finish(), device="cpu").save(str(path))
    return path.read_bytes()


def _giant_dims():
    tensor = (tmm._field_bytes(8, b"w") + tmm._field_varint(1, 1 << 31)
              + tmm._field_varint(1, 1 << 30) + tmm._field_varint(2, 1)
              + tmm._field_bytes(9, struct.pack("<f", 1.0)))
    return tmm._model(tmm._field_bytes(5, tensor)
                      + tmm._field_bytes(1, tmm._node("Add", ["x", "w"], ["y"]))
                      + tmm._field_bytes(11, tmm._value_info("x"))
                      + tmm._field_bytes(12, tmm._value_info("y")))


def _giant_typed_dims():
    tensor = (tmm._field_bytes(8, b"w") + tmm._field_varint(1, 1 << 40)
              + tmm._field_varint(2, 1) + tmm._field_bytes(4, struct.pack("<f", 1.0)))
    return tmm._model(tmm._field_bytes(5, tensor)
                      + tmm._field_bytes(1, tmm._node("Identity", ["w"], ["y"]))
                      + tmm._field_bytes(12, tmm._value_info("y")))


def _cyclic():
    return tmm._model(tmm._field_bytes(1, tmm._node("Relu", ["x"], ["a"]))
                      + tmm._field_bytes(1, tmm._node("Relu", ["b"], ["c"]))
                      + tmm._field_bytes(1, tmm._node("Add", ["a", "c"], ["b"]))
                      + tmm._field_bytes(11, tmm._value_info("x"))
                      + tmm._field_bytes(12, tmm._value_info("b")))


def _self_loop():
    return tmm._model(tmm._field_bytes(1, tmm._node("Relu", ["y"], ["y"]))
                      + tmm._field_bytes(11, tmm._value_info("x"))
                      + tmm._field_bytes(12, tmm._value_info("y")))


def _nested_ifs(depth=200):
    flat = tmm._field_bytes(12, tmm._value_info("z"))
    inner = flat
    for _ in range(depth):
        then_attr = (tmm._field_bytes(1, b"then_branch") + tmm._field_bytes(6, inner)
                     + tmm._field_varint(20, 5))
        else_attr = (tmm._field_bytes(1, b"else_branch") + tmm._field_bytes(6, flat)
                     + tmm._field_varint(20, 5))
        node = (tmm._node("If", ["cond"], ["z"]) + tmm._field_bytes(5, then_attr)
                + tmm._field_bytes(5, else_attr))
        inner = tmm._field_bytes(1, node) + tmm._field_bytes(12, tmm._value_info("z"))
    return tmm._model(inner + tmm._field_bytes(11, tmm._value_info("cond", elem_type=9)))


def _flips(base, seed=2, n=200):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        data = bytearray(base)
        data[int(rng.integers(0, len(base)))] ^= 1 << int(rng.integers(0, 8))
        yield bytes(data)


@pytest.mark.parametrize("case", [
    "truncated_onnx", "truncated_rten", "empty_and_tiny", "random_bytes",
    "random_bytes_with_rten_magic", "bit_flips_onnx", "bit_flips_rten", "giant_dims",
    "giant_typed_dims", "cyclic", "self_loop", "deeply_nested_subgraphs",
    "rten_vtable_offsets", "rten_header_lengths", "load_file_empty_and_garbage",
])
def test_malformed_files_raise_typed_errors(case, valid_onnx, valid_rten, tmp_path):
    rng = np.random.default_rng(0 if case == "random_bytes" else 1)
    if case == "truncated_onnx":
        for frac in (0.1, 0.3, 0.5, 0.7, 0.9):
            _loads_or_rejects(valid_onnx[:max(1, int(len(valid_onnx) * frac))])
    elif case == "truncated_rten":
        for frac in (0.01, 0.1, 0.5, 0.9, 0.99):
            _rejects(valid_rten[:max(1, int(len(valid_rten) * frac))], frac)
    elif case == "empty_and_tiny":
        for data in (b"", b"\x00", b"RTEN", b"RTEN\x00\x01", b"\x08", b"\xff" * 7):
            _rejects(data, data)
    elif case == "random_bytes":
        for size in (16, 256, 4096):
            for _ in range(8):
                _loads_or_rejects(rng.integers(0, 256, size, dtype=np.uint8).tobytes())
    elif case == "random_bytes_with_rten_magic":
        for size in (32, 512):
            for _ in range(16):
                _rejects(b"RTEN" + rng.integers(0, 256, size, dtype=np.uint8).tobytes(), size)
    elif case.startswith("bit_flips"):
        for data in _flips(valid_onnx if case.endswith("onnx") else valid_rten):
            _loads_or_rejects(data)
    elif case == "giant_dims":
        _rejects(_giant_dims(), case)
    elif case == "giant_typed_dims":
        _rejects(_giant_typed_dims(), case)
    elif case == "cyclic":
        _rejects(_cyclic(), case)
    elif case == "self_loop":
        _rejects(_self_loop(), case)
    elif case == "deeply_nested_subgraphs":
        _loads_or_rejects(_nested_ifs(), bound=30.0)
    elif case == "rten_vtable_offsets":
        for pos in range(min(128, len(valid_rten))):
            data = bytearray(valid_rten)
            data[pos] = 0xFF
            _loads_or_rejects(bytes(data))
    elif case == "rten_header_lengths":
        for off in (8, 16, 24, 32):
            data = bytearray(valid_rten)
            data[off:off + 8] = struct.pack("<Q", 1 << 60)
            _rejects(bytes(data), off)
    else:
        p = tmp_path / "empty.onnx"
        p.write_bytes(b"")
        with pytest.raises(TYPED):
            TModel.load_file(str(p), device="cpu")
        p2 = tmp_path / "garbage.rten"
        p2.write_bytes(b"RTEN" + b"\xde\xad\xbe\xef" * 16)
        with pytest.raises(TYPED):
            TModel.load_file(str(p2), device="cpu")


# --- external data: the cases of tests/test_onnx_external_data.py ------------


def test_external_data_loads_and_runs(tmp_path):
    w = np.arange(12, dtype=np.float32).reshape(3, 4)
    m = TModel.load_file(make_model_with_external_weight(tmp_path, w), device="cpu")
    x = np.ones((2, 3), np.float32)
    np.testing.assert_allclose(m.run({"x": x})[0].numpy(), x @ w, rtol=1e-6)


def test_external_data_path_escape_rejected(tmp_path):
    path = make_model_with_external_weight(tmp_path, np.zeros((3, 4), np.float32))
    evil = tmp_path / "evil.onnx"
    evil.write_bytes(open(path, "rb").read().replace(b"weights.bin", b"../evil.bin"))
    with pytest.raises(LoadError):
        TModel.load_file(str(evil), device="cpu")


def test_missing_external_file_errors(tmp_path):
    path = make_model_with_external_weight(tmp_path, np.zeros((3, 4), np.float32))
    (tmp_path / "weights.bin").unlink()
    with pytest.raises((LoadError, FileNotFoundError)):
        TModel.load_file(path, device="cpu")
