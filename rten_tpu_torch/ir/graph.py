"""Graph intermediate representation.

A copy of ``rten_tpu/ir/graph.py`` (numpy only), kept in the port so that
the port imports nothing of the JAX package. The IR is an ONNX-shaped DAG
of constants, values and operator nodes; the port's executor
(``rten_tpu_torch/runtime/executor.py``) walks ``Graph.plan`` eagerly,
calling one PyTorch lowering per node. The mutation API (`add_op`,
`remove_nodes`, `replace_input`) mirrors what the reference optimizer needs
(rten `src/graph.rs:323,420,635`).

Node kinds (rten `src/graph/node.rs`):
  * ``Value``    — graph input or operator output; carries optional
                   dtype + symbolic shape.
  * ``Constant`` — weights / initializers, a numpy array.
  * ``Operator`` — op_type + attrs + input/output edges. ``inputs`` may
                   contain ``None`` for omitted optional inputs.

Control-flow subgraphs (If/Loop) are stored in operator attrs as nested
``Graph`` objects and may *capture* values from enclosing scopes by name
(rten `src/graph.rs:212-219`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..dtypes import DataType

NodeId = int

# A shape dimension: concrete int, or a named symbolic dim ("batch"), or None
# (fully unknown).
Dim = Union[int, str, None]


@dataclasses.dataclass
class Value:
    name: Optional[str] = None
    dtype: Optional[DataType] = None
    shape: Optional[Tuple[Dim, ...]] = None


@dataclasses.dataclass
class Constant:
    name: Optional[str]
    array: np.ndarray

    @property
    def dtype(self) -> DataType:
        return DataType.from_np(self.array.dtype)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.array.shape)


@dataclasses.dataclass
class Operator:
    op_type: str
    name: Optional[str] = None
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    inputs: List[Optional[NodeId]] = dataclasses.field(default_factory=list)
    outputs: List[NodeId] = dataclasses.field(default_factory=list)

    def subgraphs(self) -> List["Graph"]:
        out = []
        for v in self.attrs.values():
            if isinstance(v, Graph):
                out.append(v)
            elif isinstance(v, (list, tuple)):
                out.extend(g for g in v if isinstance(g, Graph))
        return out


Node = Union[Value, Constant, Operator]

# Dtypes that mark a constant as model-weight-like (vs shape/axes metadata).
_WEIGHT_DTYPES = ("float32", "bfloat16", "float16", "int8", "uint8")


def is_weight_constant(node: "Constant", min_size: int = 16) -> bool:
    """True for constants that should be runtime arguments (weights), not
    trace-time literals. Small int32 shape/axes constants must stay
    embedded — ops like Reshape/Unsqueeze need their values while tracing;
    big weights must NOT be embedded — XLA would fold megabytes of
    literals into the executable (and remote-compile request bodies)."""
    return node.array.dtype.name in _WEIGHT_DTYPES and node.array.size >= min_size


class Graph:
    """A DAG of values, constants and operators keyed by integer NodeId."""

    def __init__(self) -> None:
        self.nodes: Dict[NodeId, Node] = {}
        self.input_ids: List[NodeId] = []
        self.output_ids: List[NodeId] = []
        # Names of values captured from an enclosing scope (control-flow
        # subgraphs only; rten src/graph.rs:212-219).
        self.captures: List[str] = []
        self._next_id: NodeId = 0
        self._name_to_id: Dict[str, NodeId] = {}

    # ---- construction -----------------------------------------------------

    def _alloc(self, node: Node) -> NodeId:
        nid = self._next_id
        self._next_id += 1
        self.nodes[nid] = node
        name = getattr(node, "name", None)
        if name is not None:
            self._name_to_id[name] = nid
        return nid

    def add_value(
        self,
        name: Optional[str] = None,
        dtype: Optional[DataType] = None,
        shape: Optional[Sequence[Dim]] = None,
    ) -> NodeId:
        return self._alloc(
            Value(name=name, dtype=dtype, shape=tuple(shape) if shape is not None else None)
        )

    def add_constant(self, name: Optional[str], array: np.ndarray) -> NodeId:
        return self._alloc(Constant(name=name, array=np.asarray(array)))

    def add_op(
        self,
        op_type: str,
        inputs: Sequence[Optional[NodeId]],
        outputs: Sequence[NodeId],
        attrs: Optional[Dict[str, Any]] = None,
        name: Optional[str] = None,
    ) -> NodeId:
        op = Operator(
            op_type=op_type,
            name=name,
            attrs=dict(attrs or {}),
            inputs=list(inputs),
            outputs=list(outputs),
        )
        nid = self._alloc(op)
        return nid

    # ---- lookup -----------------------------------------------------------

    def node(self, nid: NodeId) -> Node:
        return self.nodes[nid]

    def find_node(self, name: str) -> Optional[NodeId]:
        return self._name_to_id.get(name)

    def node_name(self, nid: NodeId) -> str:
        n = self.nodes[nid]
        return getattr(n, "name", None) or f"%{nid}"

    def operators(self) -> Iterable[Tuple[NodeId, Operator]]:
        for nid, n in self.nodes.items():
            if isinstance(n, Operator):
                yield nid, n

    def producer_of(self, value_id: NodeId) -> Optional[Tuple[NodeId, Operator]]:
        for nid, op in self.operators():
            if value_id in op.outputs:
                return nid, op
        return None

    def consumers_of(self, value_id: NodeId) -> List[Tuple[NodeId, Operator]]:
        return [
            (nid, op)
            for nid, op in self.operators()
            if value_id in op.inputs
        ]

    # ---- mutation (optimizer API) ------------------------------------------

    def remove_nodes(self, ids: Iterable[NodeId]) -> None:
        for nid in ids:
            node = self.nodes.pop(nid, None)
            if node is not None:
                name = getattr(node, "name", None)
                if name is not None and self._name_to_id.get(name) == nid:
                    del self._name_to_id[name]

    def replace_input(self, old: NodeId, new: NodeId) -> None:
        """Rewire every operator input (and graph output) from `old` to `new`."""
        for _, op in self.operators():
            op.inputs = [new if i == old else i for i in op.inputs]
        self.output_ids = [new if i == old else i for i in self.output_ids]

    # ---- planning -----------------------------------------------------------

    def plan(
        self,
        inputs: Sequence[NodeId],
        outputs: Sequence[NodeId],
        allow_missing_inputs: bool = False,
    ) -> List[NodeId]:
        """Topologically-ordered operator ids needed to compute `outputs`.

        Equivalent to the reference Planner (rten src/graph/planner.rs:97-200).
        With ``allow_missing_inputs`` the plan covers whatever subset of
        `outputs` is reachable (used for partial evaluation / const-prop).
        """
        available = set(inputs)
        for nid, n in self.nodes.items():
            if isinstance(n, Constant):
                available.add(nid)

        producer: Dict[NodeId, NodeId] = {}
        for nid, op in self.operators():
            for out in op.outputs:
                producer[out] = nid

        def capture_deps(op: Operator) -> List[NodeId]:
            """Values this graph must provide to the op's subgraphs.

            Subgraph captures resolve by name at trace time (rten CaptureEnv)
            — the planner must treat them as inputs, else the producing op
            is left out of the plan (e.g. a Constant op consumed only inside
            an ONNX If branch). Unresolved names may bind in an enclosing
            scope, so they are skipped, not errors.
            """
            names: List[str] = []

            def walk(g: "Graph"):
                names.extend(g.captures)
                for _, sub_op in g.operators():
                    for sg in sub_op.subgraphs():
                        walk(sg)

            for sg in op.subgraphs():
                walk(sg)
            deps = []
            for name in names:
                nid = self._name_to_id.get(name)
                if nid is not None:
                    deps.append(nid)
            return deps

        def effective_inputs(op: Operator) -> List[Optional[NodeId]]:
            if not op.subgraphs():
                return op.inputs
            return list(op.inputs) + capture_deps(op)

        plan: List[NodeId] = []
        # Memoized iterative post-order DFS: each operator is expanded once
        # ('queued' -> 'visiting' -> 'planned'|'failed'); shared deps are
        # never re-explored (the naive version was exponential on DAGs with
        # heavy sharing — e.g. a transformer's residual stream).
        status: Dict[NodeId, str] = {}

        def schedule(root: NodeId) -> None:
            if status.get(root) is not None:
                return
            stack: List[Tuple[NodeId, bool]] = [(root, False)]
            status[root] = "queued"
            while stack:
                oid, processed = stack.pop()
                st = status.get(oid)
                if st in ("planned", "failed"):
                    continue
                op = self.nodes[oid]
                assert isinstance(op, Operator)
                if not processed:
                    if st == "visiting":
                        # Duplicate stack entry for an op already expanded.
                        continue
                    status[oid] = "visiting"
                    stack.append((oid, True))
                    for inp in effective_inputs(op):
                        if inp is None or inp in available:
                            continue
                        dep = producer.get(inp)
                        # Re-push 'queued' deps so they finalize before this
                        # op's processed phase (the stale entry deeper in the
                        # stack becomes a no-op duplicate).
                        if dep is not None and status.get(dep) in (None, "queued"):
                            status[dep] = "queued"
                            stack.append((dep, False))
                else:
                    ok = all(
                        inp is None
                        or inp in available
                        or (
                            producer.get(inp) is not None
                            and status.get(producer[inp]) == "planned"
                        )
                        for inp in op.inputs
                    )
                    # Capture deps are best-effort: missing ones may bind in
                    # an enclosing scope at trace time, so they don't fail
                    # the op — but those that CAN be computed here must be.
                    if ok:
                        status[oid] = "planned"
                        plan.append(oid)
                        available.update(op.outputs)
                    else:
                        status[oid] = "failed"

        def resolve(value_id: NodeId) -> bool:
            if value_id in available:
                return True
            op_id = producer.get(value_id)
            if op_id is None:
                return False
            schedule(op_id)
            return value_id in available

        missing = []
        for out in outputs:
            if not resolve(out):
                missing.append(out)
        if missing and not allow_missing_inputs:
            names = ", ".join(self.node_name(m) for m in missing)
            raise ValueError(f"cannot compute outputs: {names}")
        return plan

    # ---- misc ---------------------------------------------------------------

    def __repr__(self) -> str:
        n_ops = sum(1 for _ in self.operators())
        n_const = sum(1 for n in self.nodes.values() if isinstance(n, Constant))
        return (
            f"Graph(ops={n_ops}, constants={n_const}, "
            f"inputs={len(self.input_ids)}, outputs={len(self.output_ids)})"
        )
