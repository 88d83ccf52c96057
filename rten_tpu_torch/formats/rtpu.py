"""`.rtpu` native model format: the `.rten` container analog (a copy of
``rten_tpu/formats/rtpu.py``; files either package writes load in the
other).

The reference defines a flatbuffers container for optimized models
(rten-model-file, docs/rten-file-format.md). Here the optimized/quantized
graph serializes into a single **safetensors** file: every Constant tensor
is an entry (zero-copy mmap on load), and the graph structure (nodes,
edges, attrs, IO) rides in the safetensors `__metadata__` JSON. One file,
aligned tensor data, partial reads — the same goals as the reference's
format, built on the engine's own safetensors codec (serialize.py).

Saving after load applies the optimizer + quantization offline, the
rten-convert workflow analog.
"""

from __future__ import annotations

import base64
import json
from typing import Any, Dict, Tuple

import numpy as np

from ..dtypes import DataType
from ..ir.graph import Constant, Graph, Operator, Value

FORMAT_VERSION = 1


def _attr_to_json(v) -> Any:
    if isinstance(v, Graph):
        return {"__graph__": _graph_to_json(v, inline_consts=True)}
    if isinstance(v, np.ndarray):
        return {
            "__ndarray__": base64.b64encode(np.ascontiguousarray(v).tobytes()).decode(),
            "dtype": v.dtype.name,
            "shape": list(v.shape),
        }
    if isinstance(v, DataType):
        return {"__dtype__": v.value}
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (list, tuple)):
        return [_attr_to_json(x) for x in v]
    if isinstance(v, bytes):
        return {"__bytes__": base64.b64encode(v).decode()}
    return v


def _attr_from_json(v) -> Any:
    if isinstance(v, dict):
        if "__graph__" in v:
            return _graph_from_json(v["__graph__"], {})
        if "__ndarray__" in v:
            return np.frombuffer(
                base64.b64decode(v["__ndarray__"]), dtype=v["dtype"]
            ).reshape(v["shape"])
        if "__dtype__" in v:
            return DataType(v["__dtype__"])
        if "__bytes__" in v:
            return base64.b64decode(v["__bytes__"])
    if isinstance(v, list):
        return [_attr_from_json(x) for x in v]
    return v


def _graph_to_json(g: Graph, inline_consts: bool = False) -> Dict:
    nodes = []
    for nid in sorted(g.nodes):
        node = g.nodes[nid]
        if isinstance(node, Value):
            nodes.append({
                "id": nid, "kind": "value", "name": node.name,
                "dtype": node.dtype.value if node.dtype else None,
                "shape": list(node.shape) if node.shape is not None else None,
            })
        elif isinstance(node, Constant):
            rec = {"id": nid, "kind": "const", "name": node.name}
            if inline_consts:
                # Nested (control-flow) graphs keep constants inline in the
                # JSON — they have no tensor-table of their own.
                rec["data"] = _attr_to_json(node.array)
            nodes.append(rec)
        else:
            assert isinstance(node, Operator)
            nodes.append({
                "id": nid, "kind": "op", "name": node.name,
                "op_type": node.op_type,
                "inputs": node.inputs,
                "outputs": node.outputs,
                "attrs": {k: _attr_to_json(v) for k, v in node.attrs.items()},
            })
    return {
        "nodes": nodes,
        "inputs": g.input_ids,
        "outputs": g.output_ids,
        "captures": g.captures,
    }


def _graph_from_json(data: Dict, tensors: Dict[str, np.ndarray]) -> Graph:
    g = Graph()
    id_map: Dict[int, int] = {}
    for node in data["nodes"]:
        old = node["id"]
        if node["kind"] == "value":
            dt = DataType(node["dtype"]) if node.get("dtype") else None
            shape = tuple(node["shape"]) if node.get("shape") is not None else None
            id_map[old] = g.add_value(node.get("name"), dt, shape)
        elif node["kind"] == "const":
            if "data" in node:
                arr = _attr_from_json(node["data"])
            else:
                arr = tensors[f"c{old}"]
            id_map[old] = g.add_constant(node.get("name"), arr)
        else:
            id_map[old] = None  # ops added after all values exist
    for node in data["nodes"]:
        if node["kind"] != "op":
            continue
        id_map[node["id"]] = g.add_op(
            node["op_type"],
            [id_map[i] if i is not None else None for i in node["inputs"]],
            [id_map[o] for o in node["outputs"]],
            {k: _attr_from_json(v) for k, v in node.get("attrs", {}).items()},
            name=node.get("name"),
        )
    g.input_ids = [id_map[i] for i in data["inputs"]]
    g.output_ids = [id_map[o] for o in data["outputs"]]
    g.captures = list(data.get("captures", []))
    return g


def save_model(graph: Graph, path, metadata: Dict[str, str] = None) -> None:
    from ..serialize import write_safetensors

    tensors = {}
    for nid in sorted(graph.nodes):
        node = graph.nodes[nid]
        if isinstance(node, Constant):
            tensors[f"c{nid}"] = node.array
    meta = {
        "rtpu_version": str(FORMAT_VERSION),
        "graph": json.dumps(_graph_to_json(graph)),
    }
    if metadata:
        meta.update({k: str(v) for k, v in metadata.items()})
    write_safetensors(path, tensors, metadata=meta)


def load_model_graph(path) -> Tuple[Graph, Dict[str, str]]:
    import struct

    from ..serialize import read_safetensors

    # Read metadata + tensors.
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen))
    meta = header.get("__metadata__", {})
    if "graph" not in meta:
        raise ValueError(f"{path} is not an .rtpu model (no graph metadata)")
    tensors = read_safetensors(path)
    g = _graph_from_json(json.loads(meta["graph"]), tensors)
    extra = {k: v for k, v in meta.items() if k not in ("graph",)}
    return g, extra
