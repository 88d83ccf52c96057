"""Model: the user-facing entry point (the port of ``rten_tpu/model.py``).

``Model.load_file`` reads an ONNX model (protobuf, with external data), a
``.rten`` file (the reference's flatbuffers container) or an ``.rtpu``
file (the JAX package's safetensors container), sniffing which from the
bytes; ``Model.load`` takes the bytes themselves, and ``Model.save``
writes ``.rtpu`` or ``.rten``. Files either package writes load in the
other. An ONNX graph is optimized on load (``optimize.optimize_graph``);
``Model(graph, options, device=None)`` does the same for an IR graph.

A model runs by name on one device: the CUDA card unless the caller
passes ``device="cpu"``, where every kernel runs its plain PyTorch
version. The port registers every operator the JAX package registers; a
graph that holds an op neither registers loads, and running that op raises
``OpError``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .dtypes import DataType, narrow_array
from .formats import onnx as onnx_format
from .formats.onnx import ExternalDataLoader, GraphProto, parse_model, tensor_to_numpy
from .ir.graph import Graph, Value
from .runtime.executor import Executor, RunConfig, resolve_device


class LoadError(Exception):
    """Model deserialization failure (rten src/model/load_error.rs)."""


def _sniff_rtpu(path: str) -> bool:
    """File-type sniffing (rten src/model/file_type.rs): .rtpu models are
    safetensors containers (8-byte LE header length then '{'); ONNX
    protobuf starts with a field-1 varint tag (0x08)."""
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            head = f.read(9)
        if len(head) < 9:
            return False
        hlen = int.from_bytes(head[:8], "little")
        return head[8:9] == b"{" and hlen <= size
    except OSError:
        return False


@dataclasses.dataclass
class ModelOptions:
    """Load-time options (rten ModelOptions, src/model.rs:672-757)."""

    optimize: bool = True
    run_config: RunConfig = dataclasses.field(default_factory=RunConfig)
    external_data_dir: Optional[str] = None


# ONNX elem_type -> engine DataType (with the i64->i32 narrowing policy).
_ELEM_TO_DTYPE = {
    1: DataType.Float,
    2: DataType.UInt8,
    3: DataType.Int8,
    4: DataType.Int32,
    5: DataType.Int32,
    6: DataType.Int32,
    7: DataType.Int32,
    9: DataType.Bool,
    10: DataType.Float,
    11: DataType.Float,
    12: DataType.Int32,
    13: DataType.Int32,
    16: DataType.BFloat16,
}


def _attr_value(a: onnx_format.AttributeProto, external, graph_builder):
    """Decode an AttributeProto into a plain python value."""
    t = a.type
    if t == 1:
        return a.f
    if t == 2:
        return a.i
    if t == 3:
        return a.s.decode("utf-8")
    if t == 4:
        return narrow_array(tensor_to_numpy(a.t, external))
    if t == 5:
        return graph_builder(a.g)
    if t == 6:
        return list(a.floats)
    if t == 7:
        return list(a.ints)
    if t == 8:
        return [s.decode("utf-8") for s in a.strings]
    if t == 9:
        return [narrow_array(tensor_to_numpy(x, external)) for x in a.tensors]
    if t == 10:
        return [graph_builder(g) for g in a.graphs]
    # Type tag missing: infer from populated fields (some exporters omit it).
    if a.g is not None:
        return graph_builder(a.g)
    if a.t is not None:
        return narrow_array(tensor_to_numpy(a.t, external))
    if a.ints:
        return list(a.ints)
    if a.floats:
        return list(a.floats)
    if a.s:
        return a.s.decode("utf-8")
    return a.i if a.i else a.f


def _value_shape(vi: onnx_format.ValueInfoProto):
    if vi.shape is None:
        return None
    dims = []
    for d in vi.shape:
        if d.value is not None and d.value >= 0:
            dims.append(int(d.value))
        elif d.param:
            dims.append(d.param)
        else:
            dims.append(None)
    return tuple(dims)


def graph_from_onnx(
    gp: GraphProto,
    external: Optional[ExternalDataLoader] = None,
    is_subgraph: bool = False,
) -> Graph:
    """Build an IR Graph from a GraphProto (rten src/model/onnx_loader.rs:38),
    subgraphs included."""
    g = Graph()
    name_to_id: Dict[str, int] = {}

    init_names = set()
    for tp in gp.initializer:
        arr = narrow_array(tensor_to_numpy(tp, external))
        name_to_id[tp.name] = g.add_constant(tp.name, arr)
        init_names.add(tp.name)

    for vi in gp.input:
        if vi.name in init_names:
            continue
        dtype = _ELEM_TO_DTYPE.get(vi.elem_type)
        nid = g.add_value(vi.name, dtype, _value_shape(vi))
        name_to_id[vi.name] = nid
        g.input_ids.append(nid)

    # Declared intermediate shapes (advisory).
    value_shapes = {vi.name: vi for vi in gp.value_info}

    def sub_builder(sub_gp: GraphProto) -> Graph:
        return graph_from_onnx(sub_gp, external, is_subgraph=True)

    for node in gp.node:
        attrs: Dict[str, Any] = {}
        for a in node.attribute:
            attrs[a.name] = _attr_value(a, external, sub_builder)
        if node.op_type in ("Cast", "CastLike") and "to" in attrs:
            dt = _ELEM_TO_DTYPE.get(attrs["to"])
            if dt is None:
                raise LoadError(
                    f"Cast to unsupported dtype "
                    f"{onnx_format.onnx_dtype_name(attrs['to'])}"
                )
            attrs["to"] = dt

        in_ids: List[Optional[int]] = []
        for in_name in node.input:
            if in_name == "":
                in_ids.append(None)
                continue
            nid = name_to_id.get(in_name)
            if nid is None:
                if is_subgraph:
                    # Captured from an enclosing scope, resolved by name
                    # when the subgraph runs (rten src/graph.rs:212-219).
                    nid = g.add_value(in_name)
                    name_to_id[in_name] = nid
                    g.captures.append(in_name)
                else:
                    raise LoadError(
                        f"node '{node.name}' ({node.op_type}) references "
                        f"undefined value '{in_name}'"
                    )
            in_ids.append(nid)

        out_ids = []
        for out_name in node.output:
            vi = value_shapes.get(out_name)
            dtype = _ELEM_TO_DTYPE.get(vi.elem_type) if vi else None
            nid = g.add_value(out_name, dtype, _value_shape(vi) if vi else None)
            name_to_id[out_name] = nid
            out_ids.append(nid)

        g.add_op(node.op_type, in_ids, out_ids, attrs, name=node.name or None)

    for vo in gp.output:
        nid = name_to_id.get(vo.name)
        if nid is None:
            if is_subgraph:
                nid = g.add_value(vo.name)
                name_to_id[vo.name] = nid
                g.captures.append(vo.name)
            else:
                raise LoadError(f"graph output '{vo.name}' is not produced")
        g.output_ids.append(nid)
    return g


class Model:
    """An optimized, runnable model on one device."""

    def __init__(
        self,
        graph: Graph,
        options: Optional[ModelOptions] = None,
        device=None,
        metadata: Optional[Dict[str, str]] = None,
    ):
        self.options = options or ModelOptions()
        self.metadata = metadata or {}
        if self.options.optimize:
            from .optimize import optimize_graph

            graph = optimize_graph(graph)
        self.graph = graph
        self.executor = Executor(graph, self.options.run_config, device=device)
        self.device = self.executor.device

    # -- loading and saving ------------------------------------------------

    @classmethod
    def load_file(
        cls,
        path: Union[str, os.PathLike],
        options: Optional[ModelOptions] = None,
        device=None,
    ) -> "Model":
        """Load an .onnx, .rten or .rtpu file (sniffed from its bytes)."""
        path = os.fspath(path)
        device = resolve_device(device)
        if _sniff_rtpu(path):
            from .formats.rtpu import load_model_graph

            graph, meta = load_model_graph(path)
            # .rtpu models were optimized when they were saved.
            opts = dataclasses.replace(options or ModelOptions(), optimize=False)
            return cls(graph, opts, device=device, metadata=meta)
        # mmap so giant models are paged, not copied (rten Model::load_mmap).
        if os.path.getsize(path) == 0:
            raise LoadError(f"empty model file: {path}")
        data = np.memmap(path, dtype=np.uint8, mode="r")
        return cls.load(
            memoryview(data),
            options,
            base_dir=os.path.dirname(os.path.abspath(path)),
            device=device,
        )

    @staticmethod
    def _sniff_rten(head: bytes) -> bool:
        """.rten magic: V2 has 'RTEN' at offset 0; V1 is a bare flatbuffers
        buffer with the file identifier at offset 4 (rten
        src/model/file_type.rs behavior)."""
        return head[:4] == b"RTEN" or head[4:8] == b"RTEN"

    def save(self, path: Union[str, os.PathLike], metadata: Dict[str, str] = None):
        """Write the (optimized, quantized) graph as a .rtpu container, or a
        reference-compatible .rten file when the path ends in '.rten'
        (rten-convert parity; contrib and fused ops have no .rten
        encoding)."""
        path = os.fspath(path)
        meta = {**self.metadata, **(metadata or {})}
        if path.endswith(".rten"):
            from .formats.rten import save_rten

            save_rten(self.graph, path, metadata=meta)
            return
        from .formats.rtpu import save_model

        save_model(self.graph, path, metadata=meta)

    @classmethod
    def load(
        cls,
        data: Union[bytes, memoryview],
        options: Optional[ModelOptions] = None,
        base_dir: Optional[str] = None,
        device=None,
    ) -> "Model":
        """Load an ONNX or .rten model from its bytes."""
        options = options or ModelOptions()
        device = resolve_device(device)
        head = bytes(data[:8])
        if cls._sniff_rten(head):
            from .formats.rten import RtenFormatError, load_rten

            try:
                graph, meta = load_rten(data)
            except RtenFormatError as e:
                raise LoadError(f"failed to parse .rten model: {e}") from e
            except Exception as e:
                # Residual IndexError/ValueError on hostile bytes surfaces
                # as a typed load failure too.
                raise LoadError(f"malformed .rten model: {e}") from e
            try:
                return cls(graph, options, device=device, metadata=meta)
            except LoadError:
                raise
            except Exception as e:
                raise LoadError(f"failed to build model: {e}") from e
        try:
            proto = parse_model(data)
        except Exception as e:
            raise LoadError(f"failed to parse ONNX model: {e}") from e
        external = ExternalDataLoader(options.external_data_dir or base_dir)
        try:
            # Graph build AND load-time optimization (constant propagation
            # runs real ops): a structurally valid but semantically broken
            # model fails here, typed.
            graph = graph_from_onnx(proto.graph, external)
            return cls(graph, options, device=device, metadata=dict(proto.metadata_props))
        except LoadError:
            raise
        except Exception as e:
            raise LoadError(f"failed to build graph: {e}") from e

    # -- introspection ---------------------------------------------------

    def input_names(self) -> List[str]:
        return [self.graph.node_name(i) for i in self.graph.input_ids]

    def output_names(self) -> List[str]:
        return [self.graph.node_name(i) for i in self.graph.output_ids]

    def input_info(self):
        out = []
        for nid in self.graph.input_ids:
            node = self.graph.nodes[nid]
            assert isinstance(node, Value)
            out.append((node.name, node.dtype, node.shape))
        return out

    def find_node(self, name: str):
        return self.graph.find_node(name)

    # -- running ---------------------------------------------------------

    def run(
        self,
        inputs: Dict[str, Any],
        outputs: Optional[Sequence[str]] = None,
        static_inputs: Sequence[str] = (),
    ) -> List[torch.Tensor]:
        """Run with name-keyed inputs (numpy arrays or tensors; a sequence
        input as a list of them); returns tensors on the model's device.
        Tensor inputs are never modified. ``static_inputs`` (the names the
        JAX package specializes its compiled trace on) stay numpy arrays on
        the host, so an op that reads one (an If on ``use_cache_branch``)
        reads it without a device sync."""
        feed = {}
        for name, val in inputs.items():
            nid = self.graph.find_node(name)
            if nid is None:
                raise KeyError(f"model has no input named '{name}'")
            feed[nid] = val
        if outputs is None:
            out_ids = list(self.graph.output_ids)
        else:
            out_ids = []
            for name in outputs:
                nid = self.graph.find_node(name)
                if nid is None:
                    raise KeyError(f"model has no value named '{name}'")
                out_ids.append(nid)
        static = [self.graph.find_node(n) for n in static_inputs]
        return self.executor.run(feed, out_ids, static=[n for n in static if n is not None])

    def run_one(self, input_value):
        """Single unnamed input -> single output convenience."""
        if len(self.graph.input_ids) != 1:
            raise ValueError("run_one requires a single-input model")
        name = self.graph.node_name(self.graph.input_ids[0])
        outs = self.run({name: input_value})
        return outs[0] if len(outs) == 1 else outs

    def partial_run(self, inputs: Dict[str, Any], outputs: Sequence[str]):
        """Evaluate whichever of ``outputs`` the constants and ``inputs``
        reach: [(node id, numpy array or None)]."""
        feed = {
            self.graph.find_node(k): narrow_array(np.asarray(v))
            for k, v in inputs.items()
        }
        out_ids = [self.graph.find_node(n) for n in outputs]
        return self.executor.partial_run(feed, out_ids)
