"""The rank-local graph: explicit partitioning where the JAX package let
GSPMD partition (``rten_tpu/parallel/sharding.py:1-11``,
``rten_tpu/serving/engine.py:99-102``).

PyTorch has no sharding propagation through a graph of hand-written
kernels, so each rank runs a graph of its own. ``partition_graph`` makes it
from the model's (optimized) graph, a plan {constant id: P}, the input
rules and the mesh:

* Tensor parallelism (the 'model' axis). A matmul whose weight the plan
  cuts P(None, 'model') is column-parallel, P('model', None) row-parallel.
  From each column-parallel output the region of values it shards is
  walked forward through element-wise ops, Split, Reshape, Transpose and
  the attention ops, up to the row-parallel products it feeds.
  - Column weights, scales, zero points, biases and column sums are cut by
    columns; where the product feeds an equal Split on its last axis
    (GPT-2's fused ``c_attn``, split into q, k and v) each third is cut
    apart, so a rank's columns are its heads of q, of k and of v.
  - Row weights are cut by rows. An f32 product's partial result is
    all-reduced (``AllReduce`` sum) and its bias added once, after it. An
    int8 product (``MatMulIntegerToFloat``) runs in the kernel's int32 mode
    on the rank's K rows, with the column sums of those rows, and the exact
    int32 partials are all-reduced before the dequantisation (a Cast and
    the two scales, in the kernel's order, then the bias), so the int8
    forward is bit-equal to the unsharded one. Its activation's
    DynamicQuantizeLinear, per tensor, becomes
    ``ShardedDynamicQuantizeLinear`` (an all-reduce of min and max).
  - Inside a region: the attention ops' head counts, the Reshape targets
    (their first dimension that is not 0 or -1: [0, 0, H, D], [0, 0, E])
    and explicit Split sizes are divided by the axis size (an attention op
    keeps the unsharded kv head count as ``rten_plan_kv_heads``, which the
    cat-cache decode kernel plans its column splits from, so each head's
    sums run in the unsharded order), and the caches
    the attention ops take become inputs at the local head count (axis 1 of
    a 4-D cache or scale, the last axis of a 3-D cat cache), which the
    serving engine allocates from the declared shapes.
  - A region that reaches a graph output or an op it cannot shard through
    is gathered there (``AllGather`` on the last axis, sizes per rank for a
    padded lm_head, whose padding columns every rank drops); an ArgMax on
    it becomes ``ShardedArgMax``, so the greedy token is the same on every
    rank. A region that could only be gathered in a layout other than
    contiguous columns (a fused QKV output, a reshaped value) makes its
    column product replicated instead, and so does an attention op whose q,
    k and v are not all sharded or whose heads do not divide.
* Expert parallelism: a MoE op whose w_up the plan cuts P('model') holds
  its rank's experts (``rten_expert_offset``) and its output is summed over
  the ranks.
* Sequence parallelism: input rules that cut ``input_ids`` over 'model'
  (``SP_PREFILL_INPUT_RULES``) leave the weights whole; every Attention op
  all-gathers K and V along the token axis and masks causally at the rank's
  global token offset (``rten_sp_group``), and the graph's outputs but the
  presents are gathered along the token axis.
* Data parallelism: where the input rules cut the batch over 'data' and
  the axis is larger than 1, every graph output is gathered along the
  batch, so each rank returns the global value, as the JAX program does.

Weights the plan leaves replicated, or whose dimension does not divide the
axis, stay whole. Node ids and names are kept: a weight's shard sits at its
constant's id, and every value the original graph names keeps its name.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..dtypes import DataType
from ..ir.graph import Constant, Graph, NodeId, Operator, Value, is_weight_constant
from ..model import Model, ModelOptions
from .sharding import (
    ShardedParams, _MATMUL_OPS, _weight_input, cut, input_spec, normalize,
)

_UNARY = {"Gelu", "Silu", "Relu", "Tanh", "Sigmoid", "Erf", "Cast", "Identity", "Neg", "Exp",
          "FastGelu", "QuickGelu", "Softplus", "HardSigmoid", "HardSwish", "LeakyRelu", "Elu",
          "Abs", "Sqrt"}
_BINARY = {"Add", "Sub", "Mul", "Div"}
_ATTENTION = {"Attention", "QuantizedKVAttention", "GroupQueryAttention",
              "MultiHeadAttention"}
_HEAD_ATTRS = ("num_heads", "kv_num_heads", "q_num_heads")
# The cache operands of ops whose other graph-input operands are not caches.
_CACHE_POSITIONS = {"Attention": (4, 5), "MultiHeadAttention": (6, 7)}


@dataclasses.dataclass
class Layout:
    """A sharded value's last axis: global width and the equal chunks each
    cut apart (1: contiguous columns); None where the sharded axis is not
    the last one any more (after a Reshape or Transpose)."""

    width: Optional[int]
    chunks: int = 1


def _cols(arr: np.ndarray, axis: int, chunks: int, size: int, index: int) -> np.ndarray:
    """Rank ``index``'s columns of ``arr`` along ``axis``: of each of
    ``chunks`` equal chunks, its 1/size part."""
    axis %= arr.ndim
    shape = arr.shape
    w = shape[axis] // (chunks * size)
    a = arr.reshape(shape[:axis] + (chunks, size, w) + shape[axis + 1:])
    a = np.take(a, index, axis=axis + 1)
    return np.ascontiguousarray(a.reshape(shape[:axis] + (chunks * w,) + shape[axis + 1:]))


def _clone(graph: Graph) -> Graph:
    """A copy whose operators and values may be changed (constants shared
    until replaced)."""
    g = Graph()
    for nid, node in graph.nodes.items():
        if isinstance(node, Operator):
            node = dataclasses.replace(node, attrs=dict(node.attrs), inputs=list(node.inputs),
                                       outputs=list(node.outputs))
        elif isinstance(node, Value):
            node = dataclasses.replace(node)
        g.nodes[nid] = node
    g.input_ids = list(graph.input_ids)
    g.output_ids = list(graph.output_ids)
    g.captures = list(graph.captures)
    g._next_id = graph._next_id
    g._name_to_id = dict(graph._name_to_id)
    return g


class _Partitioner:
    def __init__(self, graph: Graph, plan, input_rules, shape: Dict[str, int],
                 coords: Dict[str, int], keys: Dict[str, str]):
        self.g = _clone(graph)
        self.plan = {k: normalize(v) for k, v in plan.items()}
        self.input_rules = input_rules
        self.tp, self.r = shape["model"], coords["model"]
        self.shape, self.keys = shape, keys
        self.input_axes: Dict[NodeId, Dict[int, str]] = {}
        self.roles: Dict[NodeId, str] = {}
        self._sliced: Dict[NodeId, Tuple] = {}
        self.consumers: Dict[NodeId, List[Tuple[NodeId, Operator, int]]] = {}
        for nid, op in self.g.operators():
            for k, i in enumerate(op.inputs):
                if i is not None:
                    self.consumers.setdefault(i, []).append((nid, op, k))

    # -- helpers --------------------------------------------------------------

    def const(self, nid) -> Optional[np.ndarray]:
        node = self.g.nodes.get(nid) if nid is not None else None
        return node.array if isinstance(node, Constant) else None

    def set_const(self, nid: NodeId, arr: np.ndarray, how: Tuple) -> None:
        """Replace weight ``nid`` by its shard (once; a second, different
        cut of a shared weight raises)."""
        done = self._sliced.get(nid)
        if done is not None:
            if done != how:
                raise ValueError(f"{self.g.node_name(nid)} is cut two ways: {done}, {how}")
            return
        self._sliced[nid] = how
        self.replace_const(nid, arr)

    def replace_const(self, nid: NodeId, arr: np.ndarray) -> None:
        self.g.nodes[nid] = Constant(self.g.nodes[nid].name, np.ascontiguousarray(arr))

    def new_const(self, arr) -> NodeId:
        return self.g.add_constant(None, np.asarray(arr))

    def op(self, op_type: str, inputs, attrs=None, output: Optional[NodeId] = None) -> NodeId:
        out = self.g.add_value() if output is None else output
        self.g.add_op(op_type, inputs, [out], attrs)
        return out

    def detach_output(self, op: Operator, k: int = 0) -> Tuple[NodeId, NodeId]:
        """Give op's k-th output a fresh value; returns (fresh, original):
        what the op now computes and the id its consumers read."""
        orig = op.outputs[k]
        fresh = self.g.add_value()
        op.outputs[k] = fresh
        return fresh, orig

    def gather_output(self, vid: NodeId, axis: int, group_axis: str, sizes=None) -> None:
        """Make graph output ``vid`` the all-gather of what computed it;
        the ops inside the graph that read it go on reading the rank's
        value."""
        for nid, op in list(self.g.operators()):
            if vid in op.outputs:
                fresh, orig = self.detach_output(op, op.outputs.index(vid))
                for _, user in self.g.operators():
                    user.inputs = [fresh if i == orig else i for i in user.inputs]
                attrs = {"axis": axis, "group": self.keys[group_axis]}
                if sizes:
                    attrs["sizes"] = list(sizes)
                self.op("AllGather", [fresh], attrs, output=orig)
                return
        raise ValueError(f"output {self.g.node_name(vid)} has no producer")

    # -- tensor parallelism -----------------------------------------------------

    def candidates(self):
        col, row = {}, {}
        for nid, op in self.g.operators():
            if op.op_type not in _MATMUL_OPS or op.op_type == "MatMulNBits":
                continue
            w = _weight_input(self.g, op)
            if w is None:
                continue
            spec = self.plan.get(w, ())
            K, N = self.const(w).shape
            trans_b = op.op_type == "Gemm" and op.attrs.get("transB", 0)
            if op.op_type == "Gemm" and op.attrs.get("transA", 0):
                continue
            if spec == (None, "model") and not trans_b or spec == ("model",) and trans_b:
                if (K if trans_b else N) % self.tp == 0:
                    col[nid] = op
            elif (spec == ("model",) and not trans_b) and op.op_type != "Gemm":
                if K % self.tp == 0:
                    row[nid] = op
        return col, row

    def chunks_of(self, op: Operator, width: int) -> int:
        """The equal chunks a column product's output is split into (a
        fused QKV): 1 unless its one consumer is an equal Split on the last
        axis whose chunks divide by the axis size."""
        cons = self.consumers.get(op.outputs[0], [])
        if len(cons) != 1 or cons[0][1].op_type != "Split":
            return 1
        sp = cons[0][1]
        if sp.attrs.get("axis", 0) != -1:
            return 1
        n = len(sp.outputs)
        sizes = self.const(sp.inputs[1]) if len(sp.inputs) > 1 else None
        if sizes is not None and len(set(np.asarray(sizes).tolist())) != 1:
            return 1
        return n if width % (n * self.tp) == 0 else 1

    def walk(self, col, row, blocked_ops: Set[NodeId]):
        """The sharded regions of the column products ``col``: (layout of
        every sharded value, the ops inside, the row products fed, the
        DynamicQuantizeLinear ops to shard, the ArgMax ops to shard, the
        exits (value, consumer op or None for a graph output, input index),
        the column products each value comes from, the attention ops)."""
        layout: Dict[NodeId, Layout] = {}
        source: Dict[NodeId, Set[NodeId]] = {}
        region: Dict[NodeId, Operator] = {}
        fed, dqls, argmaxes, attn = {}, set(), set(), set()
        exits = []
        stack = []
        for nid, op in col.items():
            W = self.col_width(op)
            v = op.outputs[0]
            layout[v] = Layout(W, self.chunks_of(op, W))
            source[v] = {nid}
            stack.append(v)
        outputs = set(self.g.output_ids)
        seen = set()
        while stack:
            v = stack.pop()
            if v in seen:
                continue
            seen.add(v)
            if v in outputs:
                exits.append((v, None, None))
            for c_id, c_op, k in self.consumers.get(v, ()):
                def push(out, lay):
                    layout.setdefault(out, lay)
                    source.setdefault(out, set()).update(source[v])
                    stack.append(out)
                if c_id in blocked_ops:
                    exits.append((v, c_id, k))
                elif c_id in row and k == 0:
                    fed[c_id] = v
                elif c_op.op_type == "DynamicQuantizeLinear":
                    q = c_op.outputs[0]
                    users = self.consumers.get(q, [])
                    if users and all(u in row and kk == 0 and o.op_type == "MatMulIntegerToFloat"
                                     for u, o, kk in users) and q not in outputs:
                        dqls.add(c_id)
                        fed.update((u, v) for u, _, _ in users)
                    else:
                        exits.append((v, c_id, k))
                elif (c_op.op_type == "ArgMax" and c_op.attrs.get("axis", 0) == -1
                        and not c_op.attrs.get("select_last_index", 0)
                        and layout[v].width is not None and layout[v].chunks == 1):
                    argmaxes.add(c_id)
                elif c_op.op_type in _UNARY or c_op.op_type in _BINARY:
                    region[c_id] = c_op
                    push(c_op.outputs[0], layout[v])
                elif c_op.op_type == "Split" and k == 0:
                    region[c_id] = c_op
                    lay = layout[v]
                    n = len(c_op.outputs)
                    sub = (Layout(lay.width // n) if lay.width is not None and lay.chunks == n
                           else Layout(None))
                    for o in c_op.outputs:
                        push(o, sub)
                elif c_op.op_type in ("Reshape", "Transpose") and k == 0:
                    region[c_id] = c_op
                    push(c_op.outputs[0], Layout(None))
                elif c_op.op_type in _ATTENTION and k <= 2:
                    region[c_id] = c_op
                    attn.add(c_id)
                    push(c_op.outputs[0], Layout(None))
                else:
                    exits.append((v, c_id, k))
        return layout, source, region, fed, dqls, argmaxes, exits, attn

    def col_width(self, op: Operator) -> int:
        """A column product's logical output width (the prepack's padding
        aside)."""
        w = self.const(op.inputs[1])
        trans_b = op.op_type == "Gemm" and op.attrs.get("transB", 0)
        return op.attrs.get("rten_orig_n", w.shape[0] if trans_b else w.shape[1])

    def check(self, layout, source, region, attn, exits, fed) -> Tuple[Set[NodeId], Set[NodeId]]:
        """(ops to block, column products to leave replicated) of one walk."""
        bad_ops, bad_cols = set(), set()
        for c_id, op in region.items():
            if op.op_type == "Split" and layout[op.inputs[0]].chunks != len(op.outputs):
                bad_ops.add(c_id)
        for r_id, v in fed.items():
            # A row product's K rows are the rank's features in order: a
            # chunked (fused, unsplit) layout cannot feed it.
            if layout[v].chunks != 1:
                bad_cols.update(source[v])
        for c_id in attn:
            op = region[c_id]
            qkv = [op.inputs[i] if i < len(op.inputs) else None for i in range(3)]
            present = [i for i in qkv if i is not None]
            heads_ok = all(op.attrs[a] % self.tp == 0 for a in _HEAD_ATTRS if a in op.attrs)
            if not all(i in layout for i in present) or not heads_ok:
                bad_ops.add(c_id)
        for c_id, op in region.items():
            if op.op_type not in _BINARY:
                continue
            for i in op.inputs:
                if i in layout:
                    continue
                arr = self.const(i)
                if arr is not None and arr.size == 1:
                    continue
                lay = next(layout[j] for j in op.inputs if j in layout)
                if arr is not None and lay.width is not None and arr.shape[-1] == lay.width:
                    continue
                bad_ops.add(c_id)
        for v, c_id, _ in exits:
            lay = layout[v]
            if lay.width is None or lay.chunks != 1:
                bad_cols.update(source[v])
        return bad_ops, bad_cols

    def tensor_parallel(self) -> None:
        col, row = self.candidates()
        blocked: Set[NodeId] = set()
        while True:
            walk = self.walk(col, row, blocked)
            layout, source, region, fed, dqls, argmaxes, exits, attn = walk
            bad_ops, bad_cols = self.check(layout, source, region, attn, exits, fed)
            if not bad_ops and not bad_cols:
                break
            blocked |= bad_ops
            for c in bad_cols:
                col.pop(c)
        key = self.keys["model"]
        sizes_of: Dict[NodeId, List[int]] = {}
        offset_of: Dict[NodeId, int] = {}
        for nid, op in col.items():
            self.roles[nid] = "col"
            lay = layout[op.outputs[0]]
            sizes, offset = self.cut_col(op, lay.chunks)
            for v in (v for v in layout if nid in source[v]):
                sizes_of[v] = sizes
                offset_of[v] = offset
        for c_id, op in region.items():
            self.rewrite_region_op(op, layout)
        for nid in fed:
            self.roles[nid] = "row"
            self.cut_row(row[nid], key)
        for nid in dqls:
            op = self.g.nodes[nid]
            op.op_type = "ShardedDynamicQuantizeLinear"
            op.attrs["group"] = key
        for nid in argmaxes:
            op = self.g.nodes[nid]
            v = op.inputs[0]
            op.op_type = "ShardedArgMax"
            op.attrs.update(group=key, axis=-1, offset=offset_of[v])
        for v, c_id, k in exits:
            sizes = sizes_of.get(v)
            if c_id is None:
                self.gather_output(v, -1, "model", sizes)
            else:
                attrs = {"axis": -1, "group": key}
                if sizes:
                    attrs["sizes"] = list(sizes)
                self.g.nodes[c_id].inputs[k] = self.op("AllGather", [v], attrs)

    def cut_col(self, op: Operator, chunks: int):
        """Cut a column product's operands; returns (each rank's output
        width where the ranks' widths differ (a padded lm_head), else None;
        this rank's first global column).

        The int8 prepack pads N to a multiple of 128 and the op slices its
        output back to ``rten_orig_n``. Where the logical width divides,
        the padding is dropped first and the logical columns are cut (the
        kernel takes any N). Where it does not (GPT-2's vocabulary of
        50257), the padded columns are cut and the last ranks hold the
        padding, which each rank's ``rten_orig_n`` slices off."""
        tp, r = self.tp, self.r
        how = ("col", chunks, tp, r)
        w_id = op.inputs[1]
        trans_b = op.op_type == "Gemm" and op.attrs.get("transB", 0)
        w_axis = 0 if trans_b else 1
        width = self.const(w_id).shape[w_axis]
        vec_inputs = [i for i in {"MatMulAdd": (2,), "Gemm": (2,),
                                  "MatMulIntegerToFloat": (3, 5, 6, 7)}.get(op.op_type, ())
                      if i < len(op.inputs) and self.const(op.inputs[i]) is not None]
        orig = op.attrs.get("rten_orig_n")
        if any(op.inputs[i] in self._sliced for i in [1] + vec_inputs):
            raise ValueError(f"{op.name}: its weights are shared with another product")
        if orig is not None and orig != width and orig % (chunks * tp) == 0:
            self.replace_const(w_id, np.take(self.const(w_id), np.arange(orig), axis=w_axis))
            for i in vec_inputs:
                arr = self.const(op.inputs[i])
                if arr.ndim and arr.shape[-1] == width:
                    self.replace_const(op.inputs[i], arr[..., :orig])
            del op.attrs["rten_orig_n"]
            width, orig = orig, None
        if orig is not None and orig != width and chunks != 1:
            raise ValueError(f"{op.name}: a padded product split {chunks} ways does not "
                             f"divide by {tp}")
        self.set_const(w_id, _cols(self.const(w_id), w_axis, chunks, tp, r), how)
        local = width // tp
        sizes = (None if orig is None or orig == width
                 else [int(min(max(orig - i * local, 0), local)) for i in range(tp)])
        for i in vec_inputs:
            arr = self.const(op.inputs[i])
            if not arr.ndim:
                continue
            if arr.shape[-1] == width:
                self.set_const(op.inputs[i], _cols(arr, -1, chunks, tp, r), how)
            elif sizes and arr.shape[-1] == orig:  # a bias at the logical width
                self.set_const(op.inputs[i], np.ascontiguousarray(
                    arr[..., r * local:r * local + sizes[r]]), how)
        if sizes is not None:
            op.attrs["rten_orig_n"] = sizes[r]
        return sizes, r * local

    def rewrite_region_op(self, op: Operator, layout) -> None:
        tp, r = self.tp, self.r
        if op.op_type in _BINARY:
            lay = next(layout[j] for j in op.inputs if j in layout)
            for k, i in enumerate(op.inputs):
                arr = self.const(i)
                if i not in layout and arr is not None and arr.size > 1:
                    op.inputs[k] = self.new_const(_cols(arr, -1, lay.chunks, tp, r))
        elif op.op_type == "Split" and len(op.inputs) > 1 and op.inputs[1] is not None:
            sizes = np.asarray(self.const(op.inputs[1]))
            if np.any(sizes % tp):
                raise ValueError(f"Split sizes {sizes.tolist()} do not divide by {tp}")
            op.inputs[1] = self.new_const((sizes // tp).astype(sizes.dtype))
        elif op.op_type == "Reshape":
            shape = self.const(op.inputs[1])
            if shape is None:
                raise ValueError("a Reshape inside a tensor-parallel region needs a constant "
                                 "target")
            shape = np.array(shape)
            d = next(d for d, s in enumerate(shape.tolist()) if s not in (0, -1))
            if shape[d] % tp:
                raise ValueError(f"Reshape target {shape.tolist()} does not divide by {tp}")
            shape[d] //= tp
            op.inputs[1] = self.new_const(shape)
        elif op.op_type in _ATTENTION:
            kv = op.attrs.get("kv_num_heads", op.attrs.get("num_heads"))
            if kv is not None:
                # The kernels plan their splits as for the unsharded heads,
                # so each head sums in the unsharded order (ops/attention.py).
                op.attrs["rten_plan_kv_heads"] = kv
            for a in _HEAD_ATTRS:
                if a in op.attrs:
                    op.attrs[a] //= tp
            positions = _CACHE_POSITIONS.get(op.op_type, range(3, len(op.inputs)))
            for k in positions:
                i = op.inputs[k] if k < len(op.inputs) else None
                if i is None or i not in self.g.input_ids:
                    continue
                node = self.g.nodes[i]
                if not node.shape or len(node.shape) not in (3, 4):
                    continue
                axis = 1 if len(node.shape) == 4 else 2
                shape = list(node.shape)
                if isinstance(shape[axis], int):
                    if shape[axis] % tp:
                        raise ValueError(f"{node.name}: {shape} does not divide by {tp}")
                    shape[axis] //= tp
                node.shape = tuple(shape)
                self.input_axes.setdefault(i, {})[axis] = "model"

    def cut_row(self, op: Operator, key: str) -> None:
        tp, r = self.tp, self.r
        how = ("row", tp, r)
        w_id = op.inputs[1]
        w = self.const(w_id)
        K = w.shape[0]
        rows = slice(r * K // tp, (r + 1) * K // tp)
        local = np.ascontiguousarray(w[rows])
        self.set_const(w_id, local, how)
        if op.op_type == "MatMulIntegerToFloat":
            cs = op.inputs[7] if len(op.inputs) > 7 else None
            if cs is not None:
                # The column sums of this rank's K rows: its share of the
                # zero-point correction (the JAX plan keeps full-K sums).
                arr = self.const(cs)
                sums = local.astype(np.int64).sum(axis=0).astype(arr.dtype).reshape(arr.shape)
                self.set_const(cs, sums, how)
            fresh, orig = self.detach_output(op)
            bias = op.inputs[6] if len(op.inputs) > 6 else None
            if bias is not None:
                op.inputs[6] = None
            op.attrs["rten_int32_out"] = 1
            b_scale = op.inputs[3]
            n_out = op.attrs.get("rten_orig_n")
            scales = self.const(b_scale)
            if n_out is not None and scales is not None and scales.ndim and \
                    scales.shape[-1] != n_out:
                # The op slices a padded N off its int32 output; the scales too.
                b_scale = self.new_const(np.ascontiguousarray(scales[..., :n_out]))
            acc = self.op("AllReduce", [fresh], {"reduce": "sum", "group": key})
            y = self.op("Cast", [acc], {"to": DataType.Float})
            y = self.op("Mul", [y, op.inputs[2]])
            y = self.op("Mul", [y, b_scale], output=None if bias is not None else orig)
            if bias is not None:
                self.op("Add", [y, bias], output=orig)
            return
        fresh, orig = self.detach_output(op)
        if op.op_type == "MatMulAdd":
            bias = op.inputs[2]
            op.op_type = "MatMul"
            op.inputs = op.inputs[:2]
            total = self.op("AllReduce", [fresh], {"reduce": "sum", "group": key})
            self.op("Add", [total, bias], output=orig)
        else:
            self.op("AllReduce", [fresh], {"reduce": "sum", "group": key}, output=orig)

    # -- expert, sequence and data parallelism ------------------------------------

    def expert_parallel(self) -> None:
        tp, r = self.tp, self.r
        for nid, op in list(self.g.operators()):
            if op.op_type != "MoE" or len(op.inputs) < 4:
                continue
            up = self.const(op.inputs[2])
            if up is None or self.plan.get(op.inputs[2], ()) != ("model",) or up.shape[0] % tp:
                continue
            X = up.shape[0]
            mine = slice(r * X // tp, (r + 1) * X // tp)
            for k in (2, 3, 4, 5):
                i = op.inputs[k] if k < len(op.inputs) else None
                arr = self.const(i)
                if arr is not None:
                    self.set_const(i, np.ascontiguousarray(arr[mine]), ("expert", tp, r))
            op.attrs["rten_expert_offset"] = r * X // tp
            fresh, orig = self.detach_output(op)
            self.op("AllReduce", [fresh], {"reduce": "sum", "group": self.keys["model"]},
                    output=orig)
            self.roles[nid] = "expert"

    def sequence_parallel(self) -> None:
        key = self.keys["model"]
        presents = set()
        for nid, op in list(self.g.operators()):
            if op.op_type in _ATTENTION and op.op_type != "Attention":
                raise NotImplementedError(
                    f"sequence-parallel prefill runs the ONNX Attention op only, not "
                    f"{op.op_type}")
            if op.op_type != "Attention":
                continue
            for k in (1, 2):
                op.inputs[k] = self.op("AllGather", [op.inputs[k]], {"axis": 2, "group": key})
            op.attrs["rten_sp_group"] = key
            presents.update(op.outputs[1:])
            self.roles[nid] = "sequence"
        for v in list(self.g.output_ids):
            if v not in presents:
                self.gather_output(v, 1, "model")

    def run(self) -> Graph:
        specs = {}
        for nid in self.g.input_ids:
            node = self.g.nodes[nid]
            ndim = len(node.shape) if node.shape else 0
            specs[nid] = input_spec(node.name, ndim, self.input_rules)
        main = self.g.find_node("input_ids")
        sp = main is not None and "model" in specs.get(main, ())
        for nid, spec in specs.items():
            for d, axis in enumerate(spec):
                if axis == "data" or (axis == "model" and sp):
                    self.input_axes.setdefault(nid, {})[d] = axis
        if self.tp > 1:
            if sp:
                if any("model" in s for s in self.plan.values()):
                    raise NotImplementedError("sequence-parallel prefill takes replicated "
                                              "weights")
                self.sequence_parallel()
            else:
                self.tensor_parallel()
                self.expert_parallel()
        if self.shape["data"] > 1 and any("data" in a.values() for a in self.input_axes.values()):
            for v in list(self.g.output_ids):
                self.gather_output(v, 0, "data")
        return self.g


def partition_graph(graph: Graph, plan, input_rules, mesh):
    """(the rank's graph, {input id: {dim: mesh axis}} of the inputs it
    takes cut, {operator id: role}); see the module doc."""
    keys = {axis: mesh.key(axis) for axis in mesh.shape}
    p = _Partitioner(graph, plan, input_rules, mesh.shape, mesh.coords, keys)
    g = p.run()
    return g, p.input_axes, p.roles


class ShardedModel(Model):
    """This rank's model: the partitioned graph on the mesh's device, its
    weights (``params``, a ``ShardedParams``) moved there once. ``run``
    takes the rank's blocks, ``run_whole`` the whole feed (cut by
    ``shard_inputs``); outputs are gathered where the module doc says, else
    the rank's own (a head-sharded cache)."""

    def __init__(self, graph: Graph, mesh, plan, input_rules, dtype=None, min_size: int = 16,
                 run_config=None):
        local, self.input_axes, self.roles = partition_graph(graph, plan, input_rules, mesh)
        opts = ModelOptions(optimize=False)
        if run_config is not None:
            opts.run_config = run_config
        super().__init__(local, opts, device=mesh.device)
        self.mesh, self.plan = mesh, plan
        weights = self.executor._weight_args()
        if dtype is not None:
            for nid, t in list(weights.items()):
                if t.dtype == torch.float32 and is_weight_constant(local.nodes[nid], min_size):
                    weights[nid] = t.to(dtype)
            self.executor._weight_ids = {id(t) for t in weights.values()}
        params = ShardedParams({nid: weights[nid] for nid, node in local.nodes.items()
                                if nid in weights and isinstance(node, Constant)
                                and is_weight_constant(node, min_size)})
        params.model = self
        self.params = params

    def shard_inputs(self, feed: Dict) -> Dict[NodeId, torch.Tensor]:
        """{node id: this rank's block} of a feed {name or id: whole value}."""
        from ..runtime.executor import to_tensor

        out = {}
        for k, val in feed.items():
            nid = self.graph.find_node(k) if isinstance(k, str) else k
            t = to_tensor(val, self.device)
            axes = self.input_axes.get(nid, {})
            spec = [axes.get(d) for d in range(t.ndim)]
            out[nid] = cut(t, spec, self.mesh)
        return out

    def run_whole(self, inputs: Dict, outputs=None):
        """``run`` on the whole feed {name: value}, cut for this rank (``run``
        itself takes the rank's blocks, as the Generator and the serving
        engine feed them)."""
        return self.run({self.graph.node_name(n): v
                         for n, v in self.shard_inputs(inputs).items()}, outputs)
