"""Symbolic shape & dtype inference over the IR (a copy of
``rten_tpu/shape_inference.py``, numpy only).

Analog of rten-shape-inference (sym_expr.rs/sym_tensor.rs + per-op rules)
and the glue in rten src/infer_shapes.rs:47-179. Dims are `int`, a symbol
name (`"batch"`), or `None` (unknown). The executor itself is shape-
concrete, so inference serves validation, model
inspection (CLI --infer-shapes), and optimizer passes — matching the
reference's ShapeInference=On mode rather than Strict.

Rules cover the op families real models exercise; unknown ops yield
unknown shapes rather than failing (reference behavior for opt-in mode).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .dtypes import DataType
from .ir.graph import Constant, Dim, Graph, NodeId, Operator, Value

Shape = Optional[Tuple[Dim, ...]]
Info = Tuple[Optional[DataType], Shape]

RULES: Dict[str, Callable] = {}


def rule(*names):
    def deco(fn):
        for n in names:
            RULES[n] = fn
        return fn

    return deco


class ShapeError(Exception):
    pass


def _dim_eq(a: Dim, b: Dim) -> bool:
    return a == b or a is None or b is None


def broadcast_dims(a: Dim, b: Dim) -> Dim:
    if a == 1:
        return b
    if b == 1:
        return a
    if a is None:
        return b if b is not None else None
    if b is None:
        return a
    if a != b:
        raise ShapeError(f"cannot broadcast dims {a} and {b}")
    return a


def broadcast_shapes(a: Shape, b: Shape) -> Shape:
    if a is None or b is None:
        return None
    la, lb = len(a), len(b)
    n = max(la, lb)
    out: List[Dim] = []
    for i in range(n):
        da = a[la - n + i] if la - n + i >= 0 else 1
        db = b[lb - n + i] if lb - n + i >= 0 else 1
        out.append(broadcast_dims(da, db))
    return tuple(out)


# --- rules -----------------------------------------------------------------

_ELEMENTWISE = (
    "Add Sub Mul Div Pow Mod Max Min Sum Mean And Or Xor PRelu "
    "Greater GreaterOrEqual Less LessOrEqual Equal"
).split()

_UNARY = (
    "Abs Acos Acosh Asin Asinh Atan Atanh Ceil Clip Cos Cosh Elu Erf Exp "
    "Floor Gelu HardSigmoid HardSwish Identity LeakyRelu Log Neg Not "
    "Reciprocal Relu Round Sigmoid Sign Sin Sinh Softplus Sqrt Swish Tan "
    "Tanh Softmax LogSoftmax SafeSoftmax Dropout LpNormalization "
    "QuickGelu GeluMicrosoft Silu Trilu CumSum ReverseSequence IsInf IsNaN "
    "FastGelu ScatterElements Scatter ScatterND GatherElements "
    "RotaryEmbedding RotaryEmbeddingMS"
).split()

_BOOL_OUT = {"Greater", "GreaterOrEqual", "Less", "LessOrEqual", "Equal",
             "And", "Or", "Xor", "Not", "IsInf", "IsNaN"}


@rule(*_ELEMENTWISE)
def _r_elementwise(op, ins, g=None):
    # An operand of UNKNOWN shape poisons the result: its rank could exceed
    # every known operand's, so "broadcast of the known ones" would be a
    # wrong (rank-collapsed) shape — Shape-of-Add chains then fold to bogus
    # constants inside subgraphs whose captures are unannotated.
    shape = None
    dtype = None
    unknown = False
    for dt, sh in ins:
        if sh is None:
            unknown = True
        elif not unknown:
            shape = sh if shape is None else broadcast_shapes(shape, sh)
        if dtype is None:
            dtype = dt
    if unknown:
        shape = None
    if op.op_type in _BOOL_OUT:
        dtype = DataType.Bool
    return [(dtype, shape)]


@rule(*_UNARY)
def _r_unary(op, ins, g=None):
    dt, sh = ins[0]
    if op.op_type in _BOOL_OUT:
        dt = DataType.Bool
    return [(dt, sh)]


@rule("Cast", "CastLike")
def _r_cast(op, ins, g=None):
    to = op.attrs.get("to")
    dt = to if isinstance(to, DataType) else (ins[1][0] if len(ins) > 1 else None)
    return [(dt, ins[0][1])]


@rule("MatMul", "MatMulAdd", "FusedMatMul")
def _r_matmul(op, ins, g=None):
    (da, a), (_, b) = ins[0], ins[1]
    if a is None or b is None:
        return [(da, None)]
    if len(a) == 0 or len(b) == 0:
        return [(da, None)]
    if len(a) == 1:
        a = (1,) + tuple(a)
    if len(b) == 1:
        b = tuple(b) + (1,)
    batch = broadcast_shapes(a[:-2], b[:-2])
    if batch is None:
        return [(da, None)]
    if not _dim_eq(a[-1], b[-2]):
        raise ShapeError(f"matmul K mismatch: {a} x {b}")
    return [(da, tuple(batch) + (a[-2], b[-1]))]


@rule("Gemm")
def _r_gemm(op, ins, g=None):
    (da, a), (_, b) = ins[0], ins[1]
    if a is None or b is None:
        return [(da, None)]
    m = a[1] if op.attrs.get("transA") else a[0]
    n = b[0] if op.attrs.get("transB") else b[1]
    return [(da, (m, n))]


@rule("MatMulInteger")
def _r_matmul_int(op, ins, g=None):
    out = _r_matmul(op, ins[:2])
    return [(DataType.Int32, out[0][1])]


@rule("MatMulIntegerToFloat")
def _r_mmitf(op, ins, g=None):
    out = _r_matmul(op, ins[:2])
    return [(DataType.Float, out[0][1])]


def _conv_spatial(x_sp, kernel, strides, pads, dilations):
    out = []
    for i, d in enumerate(x_sp):
        if not isinstance(d, int):
            out.append(None)
            continue
        k_eff = (kernel[i] - 1) * dilations[i] + 1
        out.append((d + pads[i] + pads[i + len(x_sp)] - k_eff) // strides[i] + 1)
    return out


@rule("Conv", "ConvInteger", "ConvIntegerToFloat")
def _r_conv(op, ins, g=None):
    (dx, x), (dw, w) = ins[0], ins[1]
    dtype = {
        "Conv": dx, "ConvInteger": DataType.Int32,
        "ConvIntegerToFloat": DataType.Float,
    }[op.op_type]
    if x is None or w is None:
        return [(dtype, None)]
    n_sp = len(x) - 2
    kernel = [k if isinstance(k, int) else None for k in w[2:]]
    if any(k is None for k in kernel):
        return [(dtype, None)]
    strides = op.attrs.get("strides", [1] * n_sp)
    dilations = op.attrs.get("dilations", [1] * n_sp)
    pads = op.attrs.get("pads", [0] * (2 * n_sp))
    if op.attrs.get("auto_pad", "NOTSET") not in ("NOTSET", "", None):
        return [(dtype, (x[0], w[0]) + (None,) * n_sp)]
    sp = _conv_spatial(x[2:], kernel, strides, pads, dilations)
    return [(dtype, (x[0], w[0]) + tuple(sp))]


@rule("MaxPool", "AveragePool")
def _r_pool(op, ins, g=None):
    """The ops' own arithmetic (``ops/pool.py``): ``auto_pad``, dilations
    and the right pad ``ceil_mode`` widens. The JAX package's rule reads
    neither ``auto_pad`` nor dilations."""
    dx, x = ins[0]
    if x is None:
        return [(dx, None)]
    n_sp = len(x) - 2
    kernel = op.attrs.get("kernel_shape")
    if kernel is None:
        return [(dx, None)]
    strides = op.attrs.get("strides", [1] * n_sp)
    dilations = op.attrs.get("dilations", [1] * n_sp)
    pads = op.attrs.get("pads", [0] * (2 * n_sp))
    auto_pad = op.attrs.get("auto_pad", "NOTSET")
    if isinstance(auto_pad, bytes):
        auto_pad = auto_pad.decode()
    sp = []
    for i, d in enumerate(x[2:]):
        if not isinstance(d, int):
            sp.append(None)
            continue
        eff_k = (kernel[i] - 1) * dilations[i] + 1
        if auto_pad in ("SAME_UPPER", "SAME_LOWER"):
            total = max(0, (-(-d // strides[i]) - 1) * strides[i] + eff_k - d)
        elif auto_pad == "VALID":
            total = 0
        else:
            total = pads[i] + pads[i + n_sp]
        span = d + total - eff_k
        sp.append(-(-span // strides[i]) + 1 if op.attrs.get("ceil_mode", 0)
                  else span // strides[i] + 1)
    return [(dx, (x[0], x[1]) + tuple(sp))]


@rule("GlobalAveragePool", "GlobalMaxPool")
def _r_global_pool(op, ins, g=None):
    dx, x = ins[0]
    if x is None:
        return [(dx, None)]
    return [(dx, (x[0], x[1]) + (1,) * (len(x) - 2))]


@rule("Transpose")
def _r_transpose(op, ins, g=None):
    dx, x = ins[0]
    if x is None:
        return [(dx, None)]
    perm = op.attrs.get("perm") or list(range(len(x)))[::-1]
    return [(dx, tuple(x[p] for p in perm))]


@rule("Shape")
def _r_shape(op, ins, g=None):
    _, x = ins[0]
    return [(DataType.Int32, (len(x),) if x is not None else None)]


@rule("Size")
def _r_size(op, ins, g=None):
    return [(DataType.Int32, ())]


@rule("LayerNormalization", "RMSNormalization", "BatchNormalization",
      "InstanceNormalization", "SimplifiedLayerNormalization",
      "SkipLayerNormalization", "SkipSimplifiedLayerNormalization")
def _r_norm(op, ins, g=None):
    return [ins[0]] * max(op.attrs.get("__n_outputs__", 1), 1)


@rule("Concat")
def _r_concat(op, ins, g=None):
    shapes = [sh for _, sh in ins if True]
    dt = ins[0][0]
    if any(sh is None for sh in shapes):
        return [(dt, None)]
    axis = op.attrs.get("axis", 0)
    rank = len(shapes[0])
    axis = axis + rank if axis < 0 else axis
    total = 0
    for sh in shapes:
        d = sh[axis]
        if not isinstance(d, int):
            total = None
            break
        total += d
    out = list(shapes[0])
    out[axis] = total
    return [(dt, tuple(out))]


@rule("Unsqueeze")
def _r_unsqueeze(op, ins, g=None):
    dt, sh = ins[0]
    axes = op.attrs.get("axes")
    if sh is None or axes is None:
        # axes may be a (constant) input; without it rank is unknown
        return [(dt, None)]
    rank = len(sh) + len(axes)
    axes = sorted(a + rank if a < 0 else a for a in axes)
    out = list(sh)
    for a in axes:
        out.insert(a, 1)
    return [(dt, tuple(out))]


@rule("Attention")
def _r_attention(op, ins, g=None):
    dq, q = ins[0]
    n_out = max(op.attrs.get("__n_outputs__", 1), 1)
    outs = [(dq, q)]
    # present K/V = concat(past, new) along the sequence axis.
    for kv_idx in (1, 2):
        if len(outs) >= n_out:
            break
        dk, k = ins[kv_idx] if kv_idx < len(ins) else (None, None)
        past = ins[3 + kv_idx][1] if len(ins) > 3 + kv_idx else None
        if k is not None and len(k) == 4:
            seq = k[2]
            if past is not None:
                seq = (
                    past[2] + k[2]
                    if isinstance(past[2], int) and isinstance(k[2], int)
                    else None
                )
            outs.append((dk, (k[0], k[1], seq, k[3])))
        else:
            outs.append((dk, None))
    while len(outs) < n_out:
        outs.append((dq, None))
    return outs


@rule("Where")
def _r_where(op, ins, g=None):
    _, c = ins[0]
    dt, a = ins[1]
    _, b = ins[2]
    return [(dt, broadcast_shapes(broadcast_shapes(c, a), b))]


def _reduce_shape(sh, axes, keepdims):
    if sh is None:
        return None
    rank = len(sh)
    if axes is None:
        axes = list(range(rank))
    axes = [a + rank if a < 0 else a for a in axes]
    out = []
    for i, d in enumerate(sh):
        if i in axes:
            if keepdims:
                out.append(1)
        else:
            out.append(d)
    return tuple(out)


@rule("ReduceSum", "ReduceMean", "ReduceMax", "ReduceMin", "ReduceProd",
      "ReduceL1", "ReduceL2", "ReduceLogSum", "ReduceLogSumExp",
      "ReduceSumSquare")
def _r_reduce(op, ins, g=None):
    dt, sh = ins[0]
    axes = op.attrs.get("axes")
    return [(dt, _reduce_shape(sh, axes, op.attrs.get("keepdims", 1)))]


@rule("ArgMax", "ArgMin")
def _r_arg(op, ins, g=None):
    _, sh = ins[0]
    axis = op.attrs.get("axis", 0)
    return [(DataType.Int32, _reduce_shape(sh, [axis], op.attrs.get("keepdims", 1)))]


@rule("Gather")
def _r_gather(op, ins, g=None):
    dt, data = ins[0]
    _, idx = ins[1]
    if data is None or idx is None:
        return [(dt, None)]
    axis = op.attrs.get("axis", 0)
    axis = axis + len(data) if axis < 0 else axis
    return [(dt, tuple(data[:axis]) + tuple(idx) + tuple(data[axis + 1:]))]


@rule("Flatten")
def _r_flatten(op, ins, g=None):
    dt, sh = ins[0]
    if sh is None:
        return [(dt, None)]
    axis = op.attrs.get("axis", 1)

    def prod(dims):
        out = 1
        for d in dims:
            if not isinstance(d, int):
                return None
            out *= d
        return out

    return [(dt, (prod(sh[:axis]), prod(sh[axis:])))]


@rule("DynamicQuantizeLinear")
def _r_dql(op, ins, g=None):
    _, sh = ins[0]
    return [(DataType.UInt8, sh), (DataType.Float, ()), (DataType.UInt8, ())]


@rule("QuantizeLinear")
def _r_quant(op, ins, g=None):
    zp_dt = ins[2][0] if len(ins) > 2 and ins[2] else DataType.UInt8
    return [(zp_dt or DataType.UInt8, ins[0][1])]


@rule("DequantizeLinear")
def _r_dequant(op, ins, g=None):
    return [(DataType.Float, ins[0][1])]


def _const_ints(g, op, idx):
    """Constant-input values as an int list, else None."""
    if g is None or idx >= len(op.inputs) or op.inputs[idx] is None:
        return None
    node = g.nodes.get(op.inputs[idx])
    if isinstance(node, Constant):
        return np.asarray(node.array).reshape(-1).astype(np.int64).tolist()
    return None


@rule("Split")
def _r_split(op, ins, g=None):
    dt, sh = ins[0]
    n_out = max(op.attrs.get("__n_outputs__", op.attrs.get("num_outputs", 1)), 1)
    if sh is None:
        return [(dt, None)] * n_out
    axis = op.attrs.get("axis", 0)
    axis = axis + len(sh) if axis < 0 else axis
    sizes = op.attrs.get("split") or _const_ints(g, op, 1)
    dim = sh[axis]
    outs = []
    if sizes is None:
        if isinstance(dim, int):
            chunk = -(-dim // n_out)
            rem = dim
            for _ in range(n_out):
                s = list(sh)
                s[axis] = min(chunk, rem)
                rem -= s[axis]
                outs.append((dt, tuple(s)))
            return outs
        return [(dt, tuple(None if i == axis else d for i, d in enumerate(sh)))] * n_out
    for size in sizes:
        s = list(sh)
        s[axis] = int(size)
        outs.append((dt, tuple(s)))
    return outs


@rule("Reshape")
def _r_reshape(op, ins, g=None):
    dt, sh = ins[0]
    target = _const_ints(g, op, 1)
    if target is None:
        return [(dt, None)]
    out: List[Dim] = []
    neg_idx = None
    known = 1
    for i, d in enumerate(target):
        if d == 0 and not op.attrs.get("allowzero", 0):
            src = sh[i] if sh is not None and i < len(sh) else None
            out.append(src)
        elif d == -1:
            neg_idx = i
            out.append(None)
        else:
            out.append(int(d))
    if neg_idx is not None and sh is not None and all(
        isinstance(d, int) for d in sh
    ) and all(isinstance(d, int) for i, d in enumerate(out) if i != neg_idx):
        total = int(np.prod([d for d in sh])) if sh else 1
        rest = int(np.prod([d for i, d in enumerate(out) if i != neg_idx]) or 1)
        if rest:
            out[neg_idx] = total // rest
    return [(dt, tuple(out))]


@rule("Squeeze")
def _r_squeeze(op, ins, g=None):
    dt, sh = ins[0]
    axes = op.attrs.get("axes") or _const_ints(g, op, 1)
    if sh is None:
        return [(dt, None)]
    if axes is None:
        if any(not isinstance(d, int) for d in sh):
            return [(dt, None)]
        return [(dt, tuple(d for d in sh if d != 1))]
    rank = len(sh)
    axes = {a + rank if a < 0 else a for a in axes}
    return [(dt, tuple(d for i, d in enumerate(sh) if i not in axes))]


@rule("Slice")
def _r_slice(op, ins, g=None):
    dt, sh = ins[0]
    if sh is None:
        return [(dt, None)]
    starts = op.attrs.get("starts") or _const_ints(g, op, 1)
    ends = op.attrs.get("ends") or _const_ints(g, op, 2)
    axes = op.attrs.get("axes") or _const_ints(g, op, 3)
    steps = _const_ints(g, op, 4)
    if starts is None or ends is None:
        return [(dt, None)]
    if axes is None:
        axes = list(range(len(starts)))
    if steps is None:
        steps = [1] * len(starts)
    out = list(sh)
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        ax = ax + len(sh) if ax < 0 else ax
        d = sh[ax]
        if not isinstance(d, int):
            out[ax] = None
            continue
        st_c = min(max(st + d if st < 0 else st, 0), d)
        en_c = min(max(en + d if en < 0 else en, 0), d)
        out[ax] = max(0, -(-(en_c - st_c) // sp)) if sp > 0 else max(
            0, -(-(st_c - en_c) // -sp)
        )
    return [(dt, tuple(out))]


@rule("Expand")
def _r_expand(op, ins, g=None):
    dt, sh = ins[0]
    target = _const_ints(g, op, 1)
    if target is None:
        return [(dt, None)]
    try:
        return [(dt, broadcast_shapes(sh, tuple(int(t) for t in target)))]
    except ShapeError:
        return [(dt, None)]


@rule("GroupQueryAttention", "MultiHeadAttention")
def _r_gqa(op, ins, g=None):
    dq, q = ins[0]
    n_out = max(op.attrs.get("__n_outputs__", 1), 1)
    outs = [(dq, q)]
    # presents: the past buffers' shapes (static-cache) or unknown.
    past_idx = 3 if op.op_type == "GroupQueryAttention" else 6
    for kv in range(2):
        if len(outs) >= n_out:
            break
        pd, psh = ins[past_idx + kv] if past_idx + kv < len(ins) else (None, None)
        outs.append((pd, psh if op.attrs.get("rten_past_lens") else None))
    if op.attrs.get("rten_recent_kv"):
        # deferred-KV serving graphs: outputs 3,4 are the recent window
        for kv in range(2):
            if len(outs) >= n_out:
                break
            rd, rsh = ins[9 + kv] if 9 + kv < len(ins) else (None, None)
            outs.append((rd, rsh))
    while len(outs) < n_out:
        outs.append((dq, None))
    return outs


@rule("Range")
def _r_range(op, ins, g=None):
    vals = [_const_ints(g, op, i) for i in range(3)]
    if all(v is not None and len(v) == 1 for v in vals):
        n = max(0, -(-(vals[1][0] - vals[0][0]) // vals[2][0]))
        return [(ins[0][0] or DataType.Int32, (n,))]
    return [(ins[0][0] or DataType.Int32, None)]


@rule("Unsqueeze")
def _r_unsqueeze2(op, ins, g=None):
    dt, sh = ins[0]
    axes = op.attrs.get("axes") or _const_ints(g, op, 1)
    if sh is None or axes is None:
        return [(dt, None)]
    rank = len(sh) + len(axes)
    axes = sorted(a + rank if a < 0 else a for a in axes)
    out = list(sh)
    for a in axes:
        out.insert(a, 1)
    return [(dt, tuple(out))]


@rule("Pad")
def _r_pad(op, ins, g=None):
    dt, sh = ins[0]
    if sh is None:
        return [(dt, None)]
    pads = _const_ints(g, op, 1)
    if pads is None:
        return [(dt, (None,) * len(sh))]
    n = len(sh)
    out = []
    for i, d in enumerate(sh):
        if pads[i] == 0 and pads[i + n] == 0:
            out.append(d)  # zero pad keeps symbolic dims
        elif isinstance(d, int):
            out.append(d + pads[i] + pads[i + n])
        else:
            out.append(None)
    return [(dt, tuple(out))]


@rule("Tile")
def _r_tile(op, ins, g=None):
    dt, sh = ins[0]
    reps = _const_ints(g, op, 1)
    if sh is None or reps is None:
        return [(dt, None)]
    return [(dt, tuple(
        d if r == 1 else (d * r if isinstance(d, int) else None)
        for d, r in zip(sh, reps)
    ))]


@rule("TopK")
def _r_topk(op, ins, g=None):
    dt, sh = ins[0]
    k = _const_ints(g, op, 1)
    if sh is None:
        return [(dt, None), (DataType.Int32, None)]
    axis = op.attrs.get("axis", -1)
    axis = axis + len(sh) if axis < 0 else axis
    out = list(sh)
    out[axis] = int(k[0]) if k is not None else None
    return [(dt, tuple(out)), (DataType.Int32, tuple(out))]


@rule("OneHot")
def _r_onehot(op, ins, g=None):
    dt_idx, sh = ins[0]
    depth = _const_ints(g, op, 1)
    dt_val = ins[2][0] if len(ins) > 2 else None
    if sh is None:
        return [(dt_val, None)]
    axis = op.attrs.get("axis", -1)
    d = int(depth[0]) if depth is not None else None
    out = list(sh)
    pos = axis + len(sh) + 1 if axis < 0 else axis
    out.insert(pos, d)
    return [(dt_val, tuple(out))]


@rule("EyeLike")
def _r_eyelike(op, ins, g=None):
    dt, sh = ins[0]
    out_dt = op.attrs.get("dtype")
    return [(out_dt if isinstance(out_dt, DataType) else dt, sh)]


@rule("DepthToSpace")
def _r_d2s(op, ins, g=None):
    dt, sh = ins[0]
    b = op.attrs.get("blocksize")
    if sh is None or not b:
        return [(dt, None)]
    N, C, H, W = sh
    f = lambda d, m: d * m if isinstance(d, int) else None
    g_ = lambda d, m: d // m if isinstance(d, int) else None
    return [(dt, (N, g_(C, b * b), f(H, b), f(W, b)))]


@rule("SpaceToDepth")
def _r_s2d(op, ins, g=None):
    dt, sh = ins[0]
    b = op.attrs.get("blocksize")
    if sh is None or not b:
        return [(dt, None)]
    N, C, H, W = sh
    f = lambda d, m: d * m if isinstance(d, int) else None
    g_ = lambda d, m: d // m if isinstance(d, int) else None
    return [(dt, (N, f(C, b * b), g_(H, b), g_(W, b)))]


@rule("Resize", "Upsample")
def _r_resize(op, ins, g=None):
    dt, sh = ins[0]
    if sh is None:
        return [(dt, None)]
    sizes = _const_ints(g, op, 3)
    if sizes is not None and len(sizes) == len(sh):
        return [(dt, tuple(int(x) for x in sizes))]
    return [(dt, tuple(sh[:2]) + (None,) * (len(sh) - 2))]


@rule("ConvTranspose")
def _r_conv_t(op, ins, g=None):
    (dx, x), (_, w) = ins[0], ins[1]
    if x is None or w is None:
        return [(dx, None)]
    n_sp = len(x) - 2
    group = op.attrs.get("group", 1)
    c_out = w[1] * group if isinstance(w[1], int) else None
    strides = op.attrs.get("strides", [1] * n_sp)
    pads = op.attrs.get("pads", [0] * 2 * n_sp)
    dil = op.attrs.get("dilations", [1] * n_sp)
    outp = op.attrs.get("output_padding", [0] * n_sp)
    if op.attrs.get("output_shape") is not None:
        # The op derives its pads from it (the JAX package's rule does not).
        return [(dx, (x[0], c_out) + tuple(int(d) for d in op.attrs["output_shape"][:n_sp]))]
    sp = []
    for i, d in enumerate(x[2:]):
        k = w[2 + i]
        if not isinstance(d, int) or not isinstance(k, int):
            sp.append(None)
            continue
        sp.append((d - 1) * strides[i] - pads[i] - pads[i + n_sp]
                  + (k - 1) * dil[i] + 1 + outp[i])
    return [(dx, (x[0], c_out) + tuple(sp))]


@rule("GridSample")
def _r_grid_sample(op, ins, g=None):
    """[N, C, Ho, Wo] from x [N, C, H, W] and grid [N, Ho, Wo, 2]; the JAX
    package's rule gives x's shape."""
    (dx, x), (_, grid) = ins[0], ins[1]
    if x is None or grid is None or len(x) != 4 or len(grid) != 4:
        return [(dx, None)]
    return [(dx, (x[0], x[1], grid[1], grid[2]))]


@rule("LSTM")
def _r_lstm(op, ins, g=None):
    dx, x = ins[0]
    if x is None:
        return [(dx, None)] * 3
    T, B = x[0], x[1]
    hidden = op.attrs.get("hidden_size")
    dirs = {"forward": 1, "reverse": 1, "bidirectional": 2}.get(
        op.attrs.get("direction", "forward"), 1)
    return [(dx, (T, dirs, B, hidden)), (dx, (dirs, B, hidden)),
            (dx, (dirs, B, hidden))]


@rule("GRU")
def _r_gru(op, ins, g=None):
    outs = _r_lstm(op, ins, g)
    return outs[:2]


@rule("NonZero")
def _r_nonzero(op, ins, g=None):
    _, sh = ins[0]
    return [(DataType.Int32, (len(sh), None) if sh is not None else None)]


@rule("NonMaxSuppression")
def _r_nms_rule(op, ins, g=None):
    return [(DataType.Int32, (None, 3))]


@rule("ConstantOfShape")
def _r_const_of_shape(op, ins, g=None):
    val = op.attrs.get("value")
    dt = None
    if val is not None:
        try:
            dt = DataType.from_np(np.asarray(val).dtype)
        except Exception:
            dt = DataType.Float
    shape = _const_ints(g, op, 0)
    return [(dt or DataType.Float,
             tuple(int(x) for x in shape) if shape is not None else None)]


@rule("RandomNormal", "RandomUniform")
def _r_random(op, ins, g=None):
    sh = op.attrs.get("shape")
    return [(DataType.Float, tuple(sh) if sh is not None else None)]


@rule("RandomNormalLike", "RandomUniformLike")
def _r_random_like(op, ins, g=None):
    return [(DataType.Float, ins[0][1])]


@rule("Multinomial")
def _r_multinomial(op, ins, g=None):
    _, sh = ins[0]
    n = op.attrs.get("sample_size", 1)
    return [(DataType.Int32, (sh[0], n) if sh is not None else None)]


@rule("MatMulNBits")
def _r_nbits(op, ins, g=None):
    dt, a = ins[0]
    N = op.attrs.get("N")
    if a is None:
        return [(DataType.Float, None)]
    return [(DataType.Float, tuple(a[:-1]) + (N,))]


@rule("STFT")
def _r_stft(op, ins, g=None):
    _, sig = ins[0]
    return [(DataType.Float, None if sig is None else (sig[0], None, None, 2))]


@rule("Einsum")
def _r_einsum(op, ins, g=None):
    """Symbolic einsum shapes: explicit AND implicit (no '->') equations,
    ellipsis broadcasting, repeated labels. Mirrors the reference's
    einsum parser semantics (rten-shape-inference/src/einsum_parser.rs:
    implicit output = labels appearing exactly once, sorted, after the
    broadcast ellipsis)."""
    eq = op.attrs.get("equation", "").replace(" ", "")
    if "->" in eq:
        lhs, rhs = eq.split("->")
    else:
        lhs, rhs = eq, None
    terms = lhs.split(",")
    dt = next((d for d, _ in ins if d is not None), None)

    dim_map: Dict[str, Dim] = {}
    ell_shape: Shape = None
    ell_unknown = False

    def merge(ch, d):
        prev = dim_map.get(ch)
        if prev is None or prev == 1:
            dim_map[ch] = d
        # conflicting concrete dims: leave the first (runtime will error)

    for term, (_, sh) in zip(terms, ins):
        if sh is None:
            if "..." in term:
                ell_unknown = True
            continue
        if "..." in term:
            head, tail = term.split("...")
            n_ell = len(sh) - len(head) - len(tail)
            if n_ell < 0:
                return [(dt, None)]
            ell = tuple(sh[len(head): len(sh) - len(tail)])
            if ell_shape is None:
                ell_shape = ell
            else:
                try:
                    ell_shape = broadcast_shapes(ell_shape, ell)
                except ShapeError:
                    ell_unknown = True
            for ch, d in zip(head, sh[: len(head)]):
                merge(ch, d)
            for ch, d in zip(tail, sh[len(sh) - len(tail):]):
                merge(ch, d)
        else:
            for ch, d in zip(term, sh):
                merge(ch, d)

    if rhs is None:
        # Implicit form: ellipsis first, then labels appearing exactly once
        # across all terms, in sorted order (numpy.einsum convention).
        counts: Dict[str, int] = {}
        for term in terms:
            for ch in term.replace(".", ""):
                counts[ch] = counts.get(ch, 0) + 1
        rhs = ("..." if any("..." in t for t in terms) else "") + "".join(
            sorted(ch for ch, n in counts.items() if n == 1)
        )

    out: List[Dim] = []
    if "..." in rhs:
        head, tail = rhs.split("...")
        if ell_unknown or ell_shape is None:
            return [(dt, None)]
        out.extend(dim_map.get(ch) for ch in head)
        out.extend(ell_shape)
        out.extend(dim_map.get(ch) for ch in tail)
    else:
        out = [dim_map.get(ch) for ch in rhs]
    return [(dt, tuple(out))]


@rule("AddSoftmax")
def _r_add_softmax(op, ins, g=None):
    dt = ins[0][0]
    return [(dt, broadcast_shapes(ins[0][1], ins[1][1]))]


@rule("BiasGelu")
def _r_bias_gelu(op, ins, g=None):
    dt = ins[0][0]
    return [(dt, broadcast_shapes(ins[0][1], ins[1][1]))]


@rule("Constant")
def _r_constant(op, ins, g=None):
    for key in ("value", "value_float", "value_int", "value_floats",
                "value_ints"):
        if key in op.attrs:
            a = np.asarray(op.attrs[key])
            return [(DataType.from_np(a.dtype), tuple(int(d) for d in a.shape))]
    return [(None, None)]


@rule("GatherND")
def _r_gather_nd(op, ins, g=None):
    dt, data = ins[0]
    _, idx = ins[1]
    if data is None or idx is None:
        return [(dt, None)]
    b = int(op.attrs.get("batch_dims", 0))
    last = idx[-1]
    if not isinstance(last, int):
        return [(dt, None)]
    # out = indices[:-1] ++ data[b + last :]
    return [(dt, tuple(idx[:-1]) + tuple(data[b + last:]))]


@rule("DFT")
def _r_dft(op, ins, g=None):
    dt, sh = ins[0]
    if sh is None:
        return [(dt, None)]
    axis_vals = _const_ints(g, op, 2)
    axis = int(axis_vals[0]) if axis_vals else int(op.attrs.get("axis", 1))
    axis = axis + len(sh) if axis < 0 else axis
    out = list(sh)
    out[-1] = 2  # complex output
    n_vals = _const_ints(g, op, 1)
    if n_vals:
        out[axis] = int(n_vals[0])
    if op.attrs.get("onesided"):
        d = out[axis]
        out[axis] = d // 2 + 1 if isinstance(d, int) else None
    return [(dt, tuple(out))]


# --- sequences ---------------------------------------------------------------
# A sequence value's "shape" is unknown at the tensor level (it is a list
# of tensors); rules propagate the ELEMENT dtype so downstream tensor ops
# still see types (reference models sequences the same way).

@rule("SequenceEmpty")
def _r_sequence_empty(op, ins, g=None):
    return [(op.attrs.get("dtype"), None)]


@rule("SequenceConstruct", "SequenceInsert", "SequenceErase",
      "SplitToSequence")
def _r_sequence_like(op, ins, g=None):
    dt = next((d for d, _ in ins if d is not None), None)
    return [(dt, None)]


@rule("SequenceAt")
def _r_sequence_at(op, ins, g=None):
    return [(ins[0][0], None)]


@rule("SequenceLength")
def _r_sequence_length(op, ins, g=None):
    return [(DataType.Int32, ())]


@rule("ConcatFromSequence")
def _r_concat_from_sequence(op, ins, g=None):
    return [(ins[0][0], None)]


# --- control flow ------------------------------------------------------------

def _capture_overrides(sub, g) -> Dict[str, Shape]:
    """Shapes for a subgraph's captures, read from the outer graph's node
    annotations (infer walks in plan order, so capture producers were
    already annotated)."""
    overrides: Dict[str, Shape] = {}
    if g is None:
        return overrides
    for name in sub.captures:
        oid = g.find_node(name)
        node = g.nodes.get(oid) if oid is not None else None
        shape = getattr(node, "shape", None)
        if shape is not None:
            overrides[name] = tuple(shape)
    return overrides


def _merge_info(a: Info, b: Info) -> Info:
    dt = a[0] if a[0] == b[0] else None
    if a[1] is None or b[1] is None or len(a[1]) != len(b[1]):
        return (dt, None)
    dims = tuple(x if x == y else None for x, y in zip(a[1], b[1]))
    return (dt, dims)


@rule("If")
def _r_if(op, ins, g=None):
    """Recurse into both branches (reference infers control-op shapes,
    rten-shape-inference/src/ops/): output = per-dim agreement of the
    then/else branch outputs."""
    branch_infos = []
    for key in ("then_branch", "else_branch"):
        sub = op.attrs.get(key)
        if sub is None:
            return [(None, None)] * len(op.outputs)
        sub_info = infer_shapes(sub, overrides=_capture_overrides(sub, g))
        branch_infos.append([
            sub_info.get(oid, (None, None)) for oid in sub.output_ids
        ])
    then_i, else_i = branch_infos
    n = len(op.outputs)
    outs = []
    for i in range(n):
        a = then_i[i] if i < len(then_i) else (None, None)
        b = else_i[i] if i < len(else_i) else (None, None)
        outs.append(_merge_info(a, b))
    return outs


@rule("Loop")
def _r_loop(op, ins, g=None):
    body = op.attrs.get("body")
    if body is None:
        return [(None, None)] * len(op.outputs)
    n_deps = max(len(op.inputs) - 2, 0)
    overrides = _capture_overrides(body, g)
    # Body inputs: iteration count (scalar i32), condition (scalar bool),
    # then the N loop-carried deps with the Loop op's dep shapes.
    names = [getattr(body.nodes.get(i), "name", None) for i in body.input_ids]
    if len(names) >= 1 and names[0]:
        overrides[names[0]] = ()
    if len(names) >= 2 and names[1]:
        overrides[names[1]] = ()
    for i in range(n_deps):
        if len(names) > 2 + i and names[2 + i] and ins[2 + i][1] is not None:
            overrides[names[2 + i]] = tuple(ins[2 + i][1])
    body_info = infer_shapes(body, overrides=overrides)
    body_outs = [body_info.get(oid, (None, None)) for oid in body.output_ids]
    # Loop outputs: final deps, then scan outputs stacked along a new
    # leading axis whose extent is the executed trip count — static only
    # when the trip count is constant and there is no early-exit condition.
    trip_vals = _const_ints(g, op, 0)
    cond_in = op.inputs[1] if len(op.inputs) > 1 else None
    trip: Dim = (
        int(trip_vals[0]) if trip_vals and cond_in is None else None
    )
    outs: List[Info] = []
    for i in range(n_deps):
        bi = body_outs[1 + i] if 1 + i < len(body_outs) else (None, None)
        # The dep's shape must be loop-invariant; prefer the input shape.
        outs.append(bi if ins[2 + i][1] is None else (bi[0] or ins[2 + i][0], ins[2 + i][1]))
    for j in range(1 + n_deps, len(body_outs)):
        dt, sh = body_outs[j]
        outs.append((dt, ((trip,) + tuple(sh)) if sh is not None else None))
    return outs


@rule("MoE")
def _r_moe(op, ins, g=None):
    # x [B,T,E] in, [B,T,E] out (ops/moe.py: gate-weighted expert combine).
    return [ins[0]]


@rule("QuantizedKVAttention")
def _r_quantized_kv_attention(op, ins, g=None):
    # outputs: out [B,S,H*D] f32, new_k_q8, new_k_scales, new_v_q8,
    # new_v_scales (cache buffers pass through shapes; ops/attention.py:323),
    # plus the recent window pair under rten_recent_kv (deferred-KV serving).
    outs = [(DataType.Float, ins[0][1]), ins[3], ins[4], ins[5], ins[6]]
    if op.attrs.get("rten_recent_kv") and len(ins) > 9:
        outs += [ins[8], ins[9]]
    return outs


# --- symbolic VALUE tracking ------------------------------------------------
#
# The reference tracks not just shapes but small symbolic VALUES through
# shape-computation chains (Shape -> Gather -> Slice -> Concat ...), so a
# graph whose batch dim is symbolic can still fold the concrete parts of
# its shape arithmetic (rten-shape-inference/src/lib.rs:40-62). A symbolic
# value is a SymVal: a list of Dims (int | symbol-name | None) plus a
# scalar flag (0-d tensors).

class SymVal:
    __slots__ = ("dims", "scalar")

    def __init__(self, dims: List[Dim], scalar: bool = False):
        self.dims = list(dims)
        self.scalar = scalar

    def concrete(self) -> Optional[np.ndarray]:
        if all(isinstance(d, (int, np.integer)) for d in self.dims):
            a = np.asarray(self.dims, np.int32)
            return a.reshape(()) if self.scalar else a
        return None

    def __repr__(self):
        return f"SymVal({self.dims}{', scalar' if self.scalar else ''})"


def _sym_binop(op_type: str, a: SymVal, b: SymVal) -> Optional[SymVal]:
    fns = {
        "Add": lambda x, y: x + y,
        "Sub": lambda x, y: x - y,
        "Mul": lambda x, y: x * y,
        "Div": lambda x, y: x // y if y else None,
    }
    fn = fns.get(op_type)
    if fn is None:
        return None
    da, db = a.dims, b.dims
    if len(da) == 1 and len(db) > 1:
        da = da * len(db)
    if len(db) == 1 and len(da) > 1:
        db = db * len(da)
    if len(da) != len(db):
        return None
    out: List[Dim] = []
    for x, y in zip(da, db):
        if isinstance(x, (int, np.integer)) and isinstance(y, (int, np.integer)):
            out.append(fn(int(x), int(y)))
        elif op_type == "Mul" and (x == 1 or y == 1):
            out.append(y if x == 1 else x)
        elif op_type in ("Add", "Sub") and y == 0:
            out.append(x)
        else:
            out.append(None)
    return SymVal(out, a.scalar and b.scalar)


def _sym_value_rule(op, in_infos, in_vals, g) -> Optional[List[Optional[SymVal]]]:
    """Propagate symbolic values through one op; None = no rule."""
    t = op.op_type
    v0 = in_vals[0] if in_vals else None
    if t == "Shape":
        sh = in_infos[0][1]
        if sh is None:
            return None
        start = op.attrs.get("start", 0) or 0
        end = op.attrs.get("end")
        dims = list(sh)[start : end if end is not None else len(sh)]
        return [SymVal(dims)]
    if t == "Size":
        sh = in_infos[0][1]
        if sh is None:
            return None
        n = 1
        for d in sh:
            if not isinstance(d, (int, np.integer)):
                return None
            n *= int(d)
        return [SymVal([n], scalar=True)]
    if v0 is None:
        return None
    if t == "Gather" and (op.attrs.get("axis", 0) == 0):
        idx = _const_ints(g, op, 1)
        if idx is None and len(in_vals) > 1 and in_vals[1] is not None:
            c = in_vals[1].concrete()
            idx = c.reshape(-1).tolist() if c is not None else None
            scalar = in_vals[1].scalar
        else:
            idx_node = g.nodes.get(op.inputs[1]) if len(op.inputs) > 1 else None
            scalar = (
                idx_node is not None
                and isinstance(idx_node, Constant)
                and idx_node.array.ndim == 0
            )
        if idx is None:
            return None
        try:
            dims = [v0.dims[i] for i in idx]
        except IndexError:
            return None
        return [SymVal(dims, scalar=scalar and len(dims) == 1)]
    if t == "Slice" and not v0.scalar:
        starts = _const_ints(g, op, 1)
        ends = _const_ints(g, op, 2)
        axes = _const_ints(g, op, 3)
        steps = _const_ints(g, op, 4)
        if starts is None or ends is None or len(starts) != 1:
            return None
        if axes is not None and list(axes) not in ([0], [-1]):
            return None
        step = steps[0] if steps else 1
        n = len(v0.dims)
        s, e = starts[0], ends[0]
        s = max(0, s + n) if s < 0 else min(s, n)
        e = max(0, e + n) if e < 0 else min(e, n)
        return [SymVal(v0.dims[s:e:step])]
    if t == "Concat" and op.attrs.get("axis", 0) in (0, -1):
        dims: List[Dim] = []
        for v in in_vals:
            if v is None or v.scalar:
                return None
            dims.extend(v.dims)
        return [SymVal(dims)]
    if t in ("Squeeze", "Unsqueeze"):
        return [SymVal(v0.dims, scalar=(t == "Squeeze" and len(v0.dims) == 1))]
    if t in ("Cast", "Identity"):
        return [SymVal(v0.dims, v0.scalar)]
    if t in ("Add", "Sub", "Mul", "Div") and len(in_vals) > 1 and in_vals[1] is not None:
        r = _sym_binop(t, v0, in_vals[1])
        return [r] if r is not None else None
    if t in ("ReduceProd", "ReduceSum") and not v0.scalar:
        n = 1
        for d in v0.dims:
            if not isinstance(d, (int, np.integer)):
                return None
            n = n * int(d) if t == "ReduceProd" else n + int(d)
        # ONNX default keepdims=1 -> 1-elem vector; keepdims=0 -> scalar.
        keep = bool(op.attrs.get("keepdims", 1))
        return [SymVal([n], scalar=not keep)]
    return None


# --- entry points ----------------------------------------------------------


def infer_shapes(g: Graph, overrides: Optional[Dict[str, Shape]] = None) -> Dict[NodeId, Info]:
    """Walk operators in plan order, applying rules; annotates Value nodes
    in place (only filling unknowns) and returns {value_id: (dtype, shape)}.
    """
    info, _ = infer_shapes_and_values(g, overrides)
    return info


def infer_shapes_and_values(
    g: Graph, overrides: Optional[Dict[str, Shape]] = None
) -> Tuple[Dict[NodeId, Info], Dict[NodeId, SymVal]]:
    """infer_shapes + symbolic VALUE propagation through shape-computation
    chains (rten-shape-inference lib.rs:40-62). The value map feeds the
    optimizer's fold_shape_computations pass."""
    info: Dict[NodeId, Info] = {}
    sym_vals: Dict[NodeId, SymVal] = {}
    for nid, node in g.nodes.items():
        if isinstance(node, Constant):
            info[nid] = (node.dtype, tuple(node.shape))
            a = node.array
            if a.dtype.kind in "iu" and a.ndim <= 1 and a.size <= 32:
                sym_vals[nid] = SymVal(
                    [int(x) for x in a.reshape(-1)], scalar=a.ndim == 0
                )
        elif isinstance(node, Value):
            shape = node.shape
            if overrides and node.name in overrides:
                shape = overrides[node.name]
            info[nid] = (node.dtype, shape)

    produced = {o for _, op in g.operators() for o in op.outputs}
    free_values = [
        nid for nid, node in g.nodes.items()
        if isinstance(node, Value) and nid not in produced
    ]
    plan = g.plan(free_values, list(g.output_ids), allow_missing_inputs=True)
    for op_id in plan:
        op = g.nodes[op_id]
        assert isinstance(op, Operator)
        rule_fn = RULES.get(op.op_type)
        ins = [
            info.get(i, (None, None)) if i is not None else (None, None)
            for i in op.inputs
        ]
        attrs = dict(op.attrs)
        attrs["__n_outputs__"] = len(op.outputs)
        op_view = Operator(op.op_type, op.name, attrs, op.inputs, op.outputs)
        if rule_fn is None:
            outs = [(None, None)] * len(op.outputs)
        else:
            try:
                outs = rule_fn(op_view, ins, g)
            except ShapeError:
                raise
            except Exception:
                outs = [(None, None)] * len(op.outputs)
        while len(outs) < len(op.outputs):
            outs.append((None, None))
        for out_id, (dt, sh) in zip(op.outputs, outs):
            # A rule returning unknown must not DISCARD a more precise
            # pre-existing annotation (loader value_info or a previous
            # inference pass with capture overrides).
            prev_dt, prev_sh = info.get(out_id, (None, None))
            if sh is None:
                sh = prev_sh
            if dt is None:
                dt = prev_dt
            info[out_id] = (dt, sh)
            node = g.nodes.get(out_id)
            if isinstance(node, Value):
                if node.dtype is None:
                    node.dtype = dt
                if node.shape is None and sh is not None:
                    node.shape = sh
        in_vals = [
            sym_vals.get(i) if i is not None else None for i in op.inputs
        ]
        try:
            val_outs = _sym_value_rule(op_view, ins, in_vals, g)
        except Exception:
            val_outs = None
        if val_outs:
            for out_id, v in zip(op.outputs, val_outs):
                if v is not None:
                    sym_vals[out_id] = v
    return info, sym_vals
