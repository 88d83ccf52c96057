"""Expression-style graph builder (a copy of ``rten_tpu/ir/builder.py``).

A convenience layer for constructing IR graphs in tests and in the model
zoo, analogous to the reference's test-only builder DSL
(rten `src/graph/builder.rs`) — but promoted to a public API here because
model-zoo architectures (GPT-2, ResNet, ...) are constructed directly in IR
rather than imported from torch.

Example::

    b = GraphBuilder()
    x = b.input("x", DataType.Float, ("batch", 16))
    w = b.constant("w", np.random.randn(16, 4).astype("float32"))
    y = b.op("MatMul", [x, w])
    b.output(y.relu())
    graph = b.finish()
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Union

import numpy as np

from ..dtypes import DataType
from .graph import Dim, Graph, NodeId


class Expr:
    """A handle to a value node, with operator sugar."""

    __slots__ = ("builder", "node_id")

    def __init__(self, builder: "GraphBuilder", node_id: NodeId):
        self.builder = builder
        self.node_id = node_id

    def _bin(self, op: str, other) -> "Expr":
        other = self.builder.as_expr(other)
        return self.builder.op(op, [self, other])

    def __add__(self, other):
        return self._bin("Add", other)

    def __sub__(self, other):
        return self._bin("Sub", other)

    def __mul__(self, other):
        return self._bin("Mul", other)

    def __truediv__(self, other):
        return self._bin("Div", other)

    def __matmul__(self, other):
        return self._bin("MatMul", other)

    def __neg__(self):
        return self.builder.op("Neg", [self])

    def relu(self):
        return self.builder.op("Relu", [self])

    def sigmoid(self):
        return self.builder.op("Sigmoid", [self])

    def softmax(self, axis: int = -1):
        return self.builder.op("Softmax", [self], {"axis": axis})

    def transpose(self, perm: Optional[Sequence[int]] = None):
        attrs = {"perm": list(perm)} if perm is not None else {}
        return self.builder.op("Transpose", [self], attrs)

    def reshape(self, shape: Sequence[int]):
        s = self.builder.constant(None, np.asarray(shape, dtype=np.int32))
        return self.builder.op("Reshape", [self, s])

    def cast(self, dtype: DataType):
        return self.builder.op("Cast", [self], {"to": dtype})

    def shape(self):
        return self.builder.op("Shape", [self])


ExprLike = Union[Expr, NodeId, int, float, np.ndarray]


class GraphBuilder:
    def __init__(self, graph: Optional[Graph] = None):
        self.graph = graph if graph is not None else Graph()
        self._auto = 0

    def _auto_name(self, prefix: str) -> str:
        self._auto += 1
        return f"{prefix}_{self._auto}"

    def as_expr(self, v: ExprLike) -> Expr:
        if isinstance(v, Expr):
            return v
        if isinstance(v, int) and not isinstance(v, bool):
            return self.constant(None, np.asarray(v, dtype=np.int32))
        if isinstance(v, float):
            return self.constant(None, np.asarray(v, dtype=np.float32))
        if isinstance(v, np.ndarray):
            return self.constant(None, v)
        raise TypeError(f"cannot convert {type(v)} to Expr")

    def input(
        self,
        name: str,
        dtype: Optional[DataType] = None,
        shape: Optional[Sequence[Dim]] = None,
    ) -> Expr:
        nid = self.graph.add_value(name, dtype, shape)
        self.graph.input_ids.append(nid)
        return Expr(self, nid)

    def value(self, name: Optional[str] = None) -> Expr:
        return Expr(self, self.graph.add_value(name))

    def constant(self, name: Optional[str], array: np.ndarray) -> Expr:
        return Expr(self, self.graph.add_constant(name, np.asarray(array)))

    def op(
        self,
        op_type: str,
        inputs: Sequence[Optional[ExprLike]],
        attrs: Optional[Dict[str, Any]] = None,
        n_outputs: int = 1,
        name: Optional[str] = None,
        output_names: Optional[Sequence[str]] = None,
    ):
        in_ids = [
            None if i is None else self.as_expr(i).node_id for i in inputs
        ]
        if output_names is not None:
            out_ids = [self.graph.add_value(n) for n in output_names]
        else:
            out_ids = [
                self.graph.add_value(self._auto_name(op_type.lower()))
                for _ in range(n_outputs)
            ]
        self.graph.add_op(op_type, in_ids, out_ids, attrs, name=name)
        exprs = [Expr(self, o) for o in out_ids]
        return exprs[0] if len(exprs) == 1 else tuple(exprs)

    def output(self, *exprs: Expr) -> None:
        for e in exprs:
            self.graph.output_ids.append(e.node_id)

    def finish(self) -> Graph:
        return self.graph
