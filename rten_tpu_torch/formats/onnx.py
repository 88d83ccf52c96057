"""ONNX model parsing: ModelProto/GraphProto/NodeProto/TensorProto (a copy
of ``rten_tpu/formats/onnx.py``; ``ml_dtypes`` is imported only for a
bfloat16 tensor).

Structured after the reference's from-scratch ONNX reader
(rten-onnx/src/onnx.rs:105-661), using the public ONNX protobuf schema's
field numbers. Tensors decode to numpy; external data resolves relative to
the model path (rten src/model/external_data.rs).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Union

import numpy as np

from .protobuf import (
    ProtobufError,
    as_f32,
    as_f64,
    fields,
    packed_varints,
    signed64,
)

# --- message structs -------------------------------------------------------


@dataclasses.dataclass
class TensorProto:
    name: str = ""
    dims: List[int] = dataclasses.field(default_factory=list)
    data_type: int = 0
    raw_data: Optional[memoryview] = None
    float_data: List[float] = dataclasses.field(default_factory=list)
    int32_data: List[int] = dataclasses.field(default_factory=list)
    int64_data: List[int] = dataclasses.field(default_factory=list)
    double_data: List[float] = dataclasses.field(default_factory=list)
    uint64_data: List[int] = dataclasses.field(default_factory=list)
    string_data: List[bytes] = dataclasses.field(default_factory=list)
    external_data: Dict[str, str] = dataclasses.field(default_factory=dict)
    data_location: int = 0  # 0 = DEFAULT, 1 = EXTERNAL


@dataclasses.dataclass
class AttributeProto:
    name: str = ""
    type: int = 0
    f: float = 0.0
    i: int = 0
    s: bytes = b""
    t: Optional[TensorProto] = None
    g: Optional["GraphProto"] = None
    floats: List[float] = dataclasses.field(default_factory=list)
    ints: List[int] = dataclasses.field(default_factory=list)
    strings: List[bytes] = dataclasses.field(default_factory=list)
    tensors: List[TensorProto] = dataclasses.field(default_factory=list)
    graphs: List["GraphProto"] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class NodeProto:
    op_type: str = ""
    name: str = ""
    domain: str = ""
    input: List[str] = dataclasses.field(default_factory=list)
    output: List[str] = dataclasses.field(default_factory=list)
    attribute: List[AttributeProto] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Dim:
    value: Optional[int] = None
    param: Optional[str] = None


@dataclasses.dataclass
class ValueInfoProto:
    name: str = ""
    elem_type: int = 0
    shape: Optional[List[Dim]] = None  # None = unknown rank


@dataclasses.dataclass
class GraphProto:
    name: str = ""
    node: List[NodeProto] = dataclasses.field(default_factory=list)
    initializer: List[TensorProto] = dataclasses.field(default_factory=list)
    input: List[ValueInfoProto] = dataclasses.field(default_factory=list)
    output: List[ValueInfoProto] = dataclasses.field(default_factory=list)
    value_info: List[ValueInfoProto] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ModelProto:
    ir_version: int = 0
    producer_name: str = ""
    graph: Optional[GraphProto] = None
    opset_imports: Dict[str, int] = dataclasses.field(default_factory=dict)
    metadata_props: Dict[str, str] = dataclasses.field(default_factory=dict)


# --- parsers ---------------------------------------------------------------


def _parse_tensor(buf: memoryview) -> TensorProto:
    t = TensorProto()
    for field, wire, val in fields(buf):
        if field == 1:  # dims
            if wire == 2:
                t.dims.extend(packed_varints(val))
            else:
                t.dims.append(signed64(val))
        elif field == 2:
            t.data_type = val
        elif field == 4:  # float_data
            if wire == 2:
                t.float_data = np.frombuffer(val, "<f4").tolist()
            else:
                t.float_data.append(as_f32(val))
        elif field == 5:  # int32_data
            if wire == 2:
                t.int32_data.extend(packed_varints(val))
            else:
                t.int32_data.append(signed64(val))
        elif field == 6:
            t.string_data.append(bytes(val))
        elif field == 7:  # int64_data
            if wire == 2:
                t.int64_data.extend(packed_varints(val))
            else:
                t.int64_data.append(signed64(val))
        elif field == 8:
            t.name = str(val, "utf-8")
        elif field == 9:
            t.raw_data = val
        elif field == 10:  # double_data
            if wire == 2:
                t.double_data = np.frombuffer(val, "<f8").tolist()
            else:
                t.double_data.append(as_f64(val))
        elif field == 11:  # uint64_data
            if wire == 2:
                pos = 0
                from .protobuf import read_varint

                while pos < len(val):
                    v, pos = read_varint(val, pos)
                    t.uint64_data.append(v)
            else:
                t.uint64_data.append(val)
        elif field == 13:  # external_data (StringStringEntry)
            key = value = ""
            for f2, _, v2 in fields(val):
                if f2 == 1:
                    key = str(v2, "utf-8")
                elif f2 == 2:
                    value = str(v2, "utf-8")
            t.external_data[key] = value
        elif field == 14:
            t.data_location = val
    return t


def _parse_attribute(buf: memoryview) -> AttributeProto:
    a = AttributeProto()
    for field, wire, val in fields(buf):
        if field == 1:
            a.name = str(val, "utf-8")
        elif field == 2:
            a.f = as_f32(val)
        elif field == 3:
            a.i = signed64(val)
        elif field == 4:
            a.s = bytes(val)
        elif field == 5:
            a.t = _parse_tensor(val)
        elif field == 6:
            a.g = _parse_graph(val)
        elif field == 7:  # floats
            if wire == 2:
                a.floats = np.frombuffer(val, "<f4").tolist()
            else:
                a.floats.append(as_f32(val))
        elif field == 8:  # ints
            if wire == 2:
                a.ints.extend(packed_varints(val))
            else:
                a.ints.append(signed64(val))
        elif field == 9:
            a.strings.append(bytes(val))
        elif field == 10:
            a.tensors.append(_parse_tensor(val))
        elif field == 11:
            a.graphs.append(_parse_graph(val))
        elif field == 20:
            a.type = val
    return a


def _parse_node(buf: memoryview) -> NodeProto:
    n = NodeProto()
    for field, _, val in fields(buf):
        if field == 1:
            n.input.append(str(val, "utf-8"))
        elif field == 2:
            n.output.append(str(val, "utf-8"))
        elif field == 3:
            n.name = str(val, "utf-8")
        elif field == 4:
            n.op_type = str(val, "utf-8")
        elif field == 5:
            n.attribute.append(_parse_attribute(val))
        elif field == 7:
            n.domain = str(val, "utf-8")
    return n


def _parse_value_info(buf: memoryview) -> ValueInfoProto:
    vi = ValueInfoProto()
    for field, _, val in fields(buf):
        if field == 1:
            vi.name = str(val, "utf-8")
        elif field == 2:  # TypeProto
            for f2, _, v2 in fields(val):
                if f2 == 1:  # tensor_type
                    for f3, _, v3 in fields(v2):
                        if f3 == 1:
                            vi.elem_type = v3
                        elif f3 == 2:  # TensorShapeProto
                            dims: List[Dim] = []
                            for f4, _, v4 in fields(v3):
                                if f4 == 1:  # Dimension
                                    d = Dim()
                                    for f5, _, v5 in fields(v4):
                                        if f5 == 1:
                                            d.value = signed64(v5)
                                        elif f5 == 2:
                                            d.param = str(v5, "utf-8")
                                    dims.append(d)
                            vi.shape = dims
    return vi


def _parse_graph(buf: memoryview) -> GraphProto:
    g = GraphProto()
    for field, _, val in fields(buf):
        if field == 1:
            g.node.append(_parse_node(val))
        elif field == 2:
            g.name = str(val, "utf-8")
        elif field == 5:
            g.initializer.append(_parse_tensor(val))
        elif field == 11:
            g.input.append(_parse_value_info(val))
        elif field == 12:
            g.output.append(_parse_value_info(val))
        elif field == 13:
            g.value_info.append(_parse_value_info(val))
    return g


def parse_model(data: Union[bytes, memoryview, bytearray]) -> ModelProto:
    buf = memoryview(data)
    m = ModelProto()
    for field, _, val in fields(buf):
        if field == 1:
            m.ir_version = val
        elif field == 2:
            m.producer_name = str(val, "utf-8")
        elif field == 7:
            m.graph = _parse_graph(val)
        elif field == 8:  # OperatorSetIdProto
            domain, version = "", 0
            for f2, _, v2 in fields(val):
                if f2 == 1:
                    domain = str(v2, "utf-8")
                elif f2 == 2:
                    version = signed64(v2)
            m.opset_imports[domain] = version
        elif field == 14:
            key = value = ""
            for f2, _, v2 in fields(val):
                if f2 == 1:
                    key = str(v2, "utf-8")
                elif f2 == 2:
                    value = str(v2, "utf-8")
            m.metadata_props[key] = value
    if m.graph is None:
        raise ProtobufError("model has no graph")
    return m


# --- tensor decoding -------------------------------------------------------

# ONNX TensorProto.DataType -> numpy dtype (pre-narrowing).
ONNX_DTYPES: Dict[int, np.dtype] = {
    1: np.dtype("float32"),
    2: np.dtype("uint8"),
    3: np.dtype("int8"),
    4: np.dtype("uint16"),
    5: np.dtype("int16"),
    6: np.dtype("int32"),
    7: np.dtype("int64"),
    9: np.dtype("bool"),
    10: np.dtype("float16"),
    11: np.dtype("float64"),
    12: np.dtype("uint32"),
    13: np.dtype("uint64"),
}


def onnx_dtype_name(code: int) -> str:
    if code == 16:
        return "bfloat16"
    dt = ONNX_DTYPES.get(code)
    return dt.name if dt is not None else f"onnx<{code}>"


class ExternalDataLoader:
    """Resolves TensorProto external_data refs against a base directory.

    Mirrors rten's DataLoader/FileLoader (src/model/external_data.rs:142,183)
    with per-file mmap so giant weight files are not copied.
    """

    def __init__(self, base_dir: Optional[str]):
        self.base_dir = base_dir
        self._files: Dict[str, np.memmap] = {}

    def load(self, location: str, offset: int, length: Optional[int]) -> memoryview:
        if self.base_dir is None:
            raise ProtobufError(
                f"model references external data '{location}' but no base "
                f"directory is known (load from a file path, or pass "
                f"external_data dir)"
            )
        base = os.path.realpath(self.base_dir)
        path = os.path.realpath(os.path.join(base, location))
        # commonpath (not a string prefix) so '../foo-evil' can't slip past a
        # base of '/models/foo'; realpath also resolves symlink escapes.
        if os.path.commonpath([base, path]) != base:
            raise ProtobufError(f"external data path escapes model dir: {location}")
        mm = self._files.get(path)
        if mm is None:
            mm = np.memmap(path, dtype=np.uint8, mode="r")
            self._files[path] = mm
        end = offset + length if length is not None else len(mm)
        return memoryview(mm)[offset:end]


def tensor_to_numpy(
    t: TensorProto, external: Optional[ExternalDataLoader] = None
) -> np.ndarray:
    """Decode a TensorProto to numpy (ONNX dtypes, not yet narrowed)."""
    shape = tuple(t.dims)
    code = t.data_type

    raw = t.raw_data
    if t.data_location == 1 or (raw is None and t.external_data):
        loc = t.external_data.get("location", "")
        offset = int(t.external_data.get("offset", "0"))
        length = t.external_data.get("length")
        raw = (external or ExternalDataLoader(None)).load(
            loc, offset, int(length) if length is not None else None
        )

    if code == 16:  # bfloat16
        import ml_dtypes

        if raw is not None:
            arr = np.frombuffer(raw, dtype=ml_dtypes.bfloat16)
        else:
            arr = np.array(t.int32_data, np.uint16).view(ml_dtypes.bfloat16)
        return arr.reshape(shape)
    if code == 8:  # string
        return np.array(
            [s.decode("utf-8", "replace") for s in t.string_data], object
        ).reshape(shape)

    dt = ONNX_DTYPES.get(code)
    if dt is None:
        raise ProtobufError(f"unsupported tensor dtype {onnx_dtype_name(code)}")
    if raw is not None:
        return np.frombuffer(raw, dtype=dt.newbyteorder("<")).astype(dt, copy=False).reshape(shape)

    # Typed repeated fields.
    if code == 1:
        data = np.array(t.float_data, np.float32)
    elif code == 7:
        data = np.array(t.int64_data, np.int64)
    elif code == 11:
        data = np.array(t.double_data, np.float64)
    elif code in (12, 13):
        data = np.array(t.uint64_data, np.uint64).astype(dt)
    elif code == 10:
        data = np.array(t.int32_data, np.uint16).view(np.float16)
    else:  # int32-backed small ints/bool
        data = np.array(t.int32_data, np.int32).astype(dt)
    return data.reshape(shape)
