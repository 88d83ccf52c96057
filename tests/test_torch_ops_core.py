"""Every op of the port's core families as a one-node graph in both
packages, on the same seeded inputs: the elementwise ops (all 57), the
layout ops (all 26), the reductions with ArgMax, ArgMin, CumSum, TopK and
NonZero, the normalizations and softmaxes, Gemm, MatMulInteger,
FusedMatMul, MatMulIntegerToFloat on batched weights, QuantizeLinear and
DequantizeLinear.

Each case runs in mode "input" (the data are graph inputs; inputs that
carry shapes, axes or bounds are constants, as the JAX package needs them
static); the cases on integer and bool data (the layout ops on shape
vectors among them) also in mode "const" (every input a constant: the JAX
executor evaluates the op eagerly at trace time, the port on the host, its
results numpy arrays; this is how shape chains run). The dtype and shape of every
output must match. Integer, bool and layout results are exact; so are the
float ops whose IEEE result is fixed (adds, compares, selects, min/max,
casts). The rest are held within the tolerance of their group:
``ULP`` (2e-6 relative, 1e-6 absolute: one transcendental function or a
division the two libraries may round apart) and ``SUM`` (1e-5 relative,
1e-6 absolute: reductions and normalizations, which sum in another order).
"""

import numpy as np
import pytest

from rten_tpu.dtypes import DataType as JDataType
from rten_tpu.ir.builder import GraphBuilder as JBuilder
from rten_tpu.model import Model as JModel
from rten_tpu.model import ModelOptions as JOptions
from rten_tpu_torch.dtypes import DataType as TDataType
from rten_tpu_torch.ir.builder import GraphBuilder as TBuilder
from rten_tpu_torch.model import Model as TModel
from rten_tpu_torch.model import ModelOptions as TOptions

from torch_one_thread import one_torch_thread  # noqa: F401

EXACT, ULP, SUM = (0.0, 0.0), (2e-6, 1e-6), (1e-5, 1e-6)
R = np.random.default_rng(11)


def f32(*shape, lo=-3.0, hi=3.0):
    return R.uniform(lo, hi, shape).astype(np.float32)


def i32(*shape, lo=-9, hi=10):
    return R.integers(lo, hi, shape).astype(np.int32)


def S(a, dtype=np.int32):
    """A static input (shape, axes, bounds): a constant in every mode."""
    return ("static", np.asarray(a, dtype))


X = f32(3, 4, 5)
XP = f32(3, 4, 5, lo=0.1, hi=4.0)
BOOL_A, BOOL_B = R.random((3, 4)) > 0.5, R.random((3, 4)) > 0.5
XS = np.array([[-2.5, -1.5, -0.5, 0.5], [1.5, 2.5, np.nan, np.inf], [-np.inf, 0.0, 3.7, -3.2]],
              np.float32)

# (id, op, inputs, attrs, outputs, tolerance); an input is an array, None
# (an omitted optional input) or S(...).
CASES = []


# The ops that shape computations use (exporters' Shape -> Gather ->
# Unsqueeze -> Concat -> Reshape chains and their arithmetic).
SHAPE_OPS = {"Shape", "Size", "Gather", "Unsqueeze", "Squeeze", "Slice", "Concat", "Reshape",
             "Expand", "Tile", "Cast", "Range", "ConstantOfShape", "Constant", "NonZero",
             "Identity", "Add", "Sub", "Mul", "Div", "Mod", "Equal", "Where", "Max", "Min",
             "ReduceProd", "ReduceSum"}


def case(cid, op, inputs, attrs=None, n_out=1, tol=EXACT, modes=None):
    """One case per mode; by default the "const" mode runs for the ops of
    shape computations where every input is integer or bool."""
    if modes is None:
        ints = all(np.asarray(x[1] if isinstance(x, tuple) else x).dtype.kind in "iub"
                   for x in inputs if x is not None)
        modes = ("input", "const") if ints and op in SHAPE_OPS else ("input",)
    for mode in modes:
        CASES.append(pytest.param(op, inputs, attrs or {}, n_out, tol, mode,
                                  id=f"{cid}-{mode}"))


# --- elementwise -------------------------------------------------------------
for op, x, tol in [
    ("Abs", X, EXACT), ("Acos", f32(3, 4, lo=-1, hi=1), ULP), ("Acosh", XP + 1, ULP),
    ("Asin", f32(3, 4, lo=-1, hi=1), ULP), ("Asinh", X, ULP), ("Atan", X, ULP),
    ("Atanh", f32(3, 4, lo=-0.9, hi=0.9), ULP), ("Ceil", X, EXACT), ("Cos", X, ULP),
    ("Cosh", X, ULP), ("Erf", X, ULP), ("Exp", X, ULP), ("Floor", X, EXACT), ("Log", XP, ULP),
    ("Neg", X, EXACT), ("Not", BOOL_A, EXACT), ("Reciprocal", XP, ULP), ("Relu", X, EXACT),
    ("Sigmoid", X, ULP), ("Sign", XS, EXACT), ("Sin", X, ULP), ("Sinh", X, ULP),
    ("Softplus", X * 10, ULP), ("Sqrt", XP, ULP), ("Tan", f32(3, 4, lo=-1.5, hi=1.5), ULP),
    ("Tanh", X, ULP), ("IsNaN", XS, EXACT), ("Silu", X, ULP), ("Round", XS, EXACT),
    ("HardSwish", X * 3, ULP),
]:
    case(op, op, [x], tol=tol)
for op in ("Abs", "Neg"):
    case(f"{op}_int", op, [i32(4, 5)])
case("IsInf", "IsInf", [XS])
case("IsInf_pos", "IsInf", [XS], {"detect_negative": 0})
case("IsInf_neg", "IsInf", [XS], {"detect_positive": 0})
case("Elu", "Elu", [X], {"alpha": 0.7}, tol=ULP)
case("LeakyRelu", "LeakyRelu", [X], {"alpha": 0.1})
case("PRelu", "PRelu", [X, f32(5)])
case("Gelu", "Gelu", [X], tol=ULP)
case("Gelu_tanh", "Gelu", [X], {"approximate": "tanh"}, tol=ULP)
case("HardSigmoid", "HardSigmoid", [X], {"alpha": 0.3, "beta": 0.4}, tol=ULP)
case("Swish", "Swish", [X], {"alpha": 1.5}, tol=ULP)
case("Clip_inputs", "Clip", [X, np.float32(-1.0), np.float32(1.5)])
case("Clip_max_only", "Clip", [X, None, np.float32(0.5)])
case("Clip_attrs", "Clip", [X], {"min": -0.5, "max": 2.0})
case("Clip_int", "Clip", [i32(3, 4), np.int32(-2), np.int32(3)])
for op in ("Add", "Sub", "Mul", "Equal", "Greater", "GreaterOrEqual", "Less", "LessOrEqual"):
    case(op, op, [X, f32(4, 5)])
for op in ("Add", "Sub", "Mul", "Equal", "Less"):
    case(f"{op}_int", op, [i32(3, 4), i32(4)])
for op in ("And", "Or", "Xor"):
    case(op, op, [BOOL_A, BOOL_B])
case("Add_mixed_int_float", "Add", [i32(3, 4), f32(3, 4)])
case("Div", "Div", [X, XP[0]], tol=ULP)
case("Div_int", "Div", [i32(3, 4), np.array([3, -3, 4, -7], np.int32)])
case("Mod_int", "Mod", [i32(3, 4), np.array([3, -3, 4, -7], np.int32)])
case("Mod_fmod", "Mod", [X, np.float32(1.3)], {"fmod": 1}, tol=ULP)
case("Mod_float", "Mod", [X, np.float32(1.3)], tol=ULP)
case("Pow", "Pow", [XP, f32(4, 5)], tol=ULP)
case("Pow_int_exponent", "Pow", [X, np.int32(3)], tol=ULP)
case("Where", "Where", [BOOL_A, f32(3, 4), f32(4)])
for op in ("Max", "Min", "Sum"):
    case(op, op, [X, f32(4, 5), f32(5)])
case("Mean", "Mean", [X, f32(4, 5), f32(5)], tol=ULP)
case("Max_int", "Max", [i32(3, 4), i32(4)])

# --- layout ------------------------------------------------------------------
# The shape-chain forms: int32 shape vectors and scalars.
SHAPE = np.array([2, 7, 64], np.int32)
case("Gather_shape", "Gather", [SHAPE, S(1)], {"axis": 0})
case("Unsqueeze_scalar", "Unsqueeze", [np.int32(7), S([0])])
case("Squeeze_vector", "Squeeze", [SHAPE[:1], S([0])])
case("Slice_shape", "Slice", [SHAPE, S([-2]), S([1000])])
case("Concat_shape", "Concat", [SHAPE[:1], np.array([-1, 4], np.int32)], {"axis": 0})
case("Reshape_int", "Reshape", [i32(2, 6), S([3, -1])])
case("Expand_int", "Expand", [i32(1, 3), S([2, 3])])
case("Tile_int", "Tile", [i32(3), S([2])])
case("Identity", "Identity", [X])
case("Dropout", "Dropout", [X])
case("Reshape", "Reshape", [X, S([0, -1])])
case("Reshape_allowzero", "Reshape", [X, S([5, 12])], {"allowzero": 1})
case("Flatten", "Flatten", [X], {"axis": 2})
case("Flatten_0", "Flatten", [X], {"axis": 0})
case("Transpose", "Transpose", [X], {"perm": [2, 0, 1]})
case("Transpose_default", "Transpose", [X])
case("Squeeze", "Squeeze", [X[:, :1], S([1])])
case("Squeeze_all", "Squeeze", [X[:1, :, :1]])
case("Unsqueeze", "Unsqueeze", [X, S([0, -1])])
case("Expand", "Expand", [f32(3, 1, 5), S([2, 1, 4, 1])])
case("Tile", "Tile", [f32(2, 3), S([2, 3])])
case("Slice", "Slice", [X, S([1, -4]), S([3, 100]), S([0, 2]), S([1, 2])])
case("Slice_negative_step", "Slice", [X, S([-1]), S([-100]), S([1]), S([-2])])
case("Slice_all_axes", "Slice", [X, S([0, 1, 1]), S([2, 4, 4])])
case("Slice_empty", "Slice", [X, S([3]), S([1]), S([2])])
case("Split_sizes", "Split", [X, S([1, 3])], {"axis": 1}, n_out=2)
case("Split_outputs", "Split", [X], {"axis": 2}, n_out=2)
case("Concat", "Concat", [X, f32(3, 2, 5)], {"axis": 1})
case("Concat_int", "Concat", [i32(2), i32(3), i32(1)], {"axis": 0})
case("Pad_constant", "Pad", [X, S([0, 1, 2, 1, 0, 0]), np.float32(9.0)])
case("Pad_reflect", "Pad", [X, S([0, 1, 2, 0, 2, 1])], {"mode": "reflect"})
case("Pad_edge", "Pad", [X, S([1, 0, 1, 1, 2, 0])], {"mode": "edge"})
case("Pad_wrap", "Pad", [X, S([0, 2, 1, 0, 1, 3])], {"mode": "wrap"})
case("Pad_negative", "Pad", [X, S([0, -1, 1, 0, 0, -2])])
case("Pad_axes", "Pad", [X, S([1, 2]), np.float32(0.5), S([2])])
case("Trilu_upper", "Trilu", [f32(2, 4, 5), S(1)])
case("Trilu_lower", "Trilu", [f32(2, 4, 5), S(-1)], {"upper": 0})
case("DepthToSpace", "DepthToSpace", [f32(1, 8, 2, 3)], {"blocksize": 2})
case("DepthToSpace_CRD", "DepthToSpace", [f32(1, 8, 2, 3)], {"blocksize": 2, "mode": "CRD"})
case("SpaceToDepth", "SpaceToDepth", [f32(1, 2, 4, 6)], {"blocksize": 2})
case("ReverseSequence", "ReverseSequence", [f32(5, 3, 2), np.array([5, 2, 0], np.int32)],
     {"batch_axis": 1, "time_axis": 0})
case("Shape", "Shape", [X])
case("Shape_slice", "Shape", [X], {"start": 1, "end": -1})
case("Size", "Size", [X])
case("Cast_to_int", "Cast", [XS[:1, :2] * 0 + X[0, :1, :2]], {"to": "Int32"})
case("Cast_to_float", "Cast", [i32(3, 4)], {"to": "Float"})
case("Cast_to_bool", "Cast", [i32(3, 4)], {"to": "Bool"})
case("CastLike", "CastLike", [i32(3, 4), np.float32(0)])
case("Constant_tensor", "Constant", [], {"value": np.arange(6, dtype=np.float32).reshape(2, 3)},
     modes=("const",))
case("Constant_ints", "Constant", [], {"value_ints": [3, 1, 4]}, modes=("const",))
case("Constant_float", "Constant", [], {"value_float": 2.5}, modes=("const",))
case("ConstantOfShape", "ConstantOfShape", [S([2, 3])], {"value": np.array([7], np.int32)},
     modes=("const",))
case("ConstantOfShape_default", "ConstantOfShape", [S([4])], modes=("const",))
case("EyeLike", "EyeLike", [f32(3, 5)], {"k": 1})
case("Range_int", "Range", [S(2), S(17), S(3)], modes=("const",))
case("Range_float", "Range", [S(0.5, np.float32), S(3.0, np.float32), S(0.75, np.float32)],
     modes=("const",))
case("OneHot", "OneHot", [np.array([[0, 3], [-1, 5]], np.int32), S(4),
                          np.array([0.5, 2.0], np.float32)], {"axis": 1})

# --- reductions --------------------------------------------------------------
for op in ("ReduceSum", "ReduceMean", "ReduceMax", "ReduceMin", "ReduceProd", "ReduceL1",
           "ReduceL2", "ReduceSumSquare", "ReduceLogSumExp"):
    exact = op in ("ReduceMax", "ReduceMin")
    case(op, op, [X, S([1])], tol=EXACT if exact else SUM)
for op in ("ReduceSum", "ReduceMax", "ReduceL2"):
    case(f"{op}_all_keep0", op, [X], {"keepdims": 0}, tol=SUM)
case("ReduceLogSum", "ReduceLogSum", [XP, S([0, 2])], tol=SUM)
case("ReduceSum_int", "ReduceSum", [i32(3, 4, 5), S([0, 2])])
case("ReduceProd_int", "ReduceProd", [i32(3, 4, lo=-3, hi=4), S([1])])
case("ReduceMean_noop", "ReduceMean", [X, S([], np.int32)], {"noop_with_empty_axes": 1})
case("ArgMax_last", "ArgMax", [f32(4, 33)], {"axis": -1})
case("ArgMax_axis0_keep0", "ArgMax", [X], {"axis": 0, "keepdims": 0})
case("ArgMax_select_last", "ArgMax", [np.array([[1, 3, 3], [2, 2, 0]], np.float32)],
     {"axis": 1, "select_last_index": 1})
case("ArgMax_int", "ArgMax", [i32(3, 7)], {"axis": 1})
case("ArgMin", "ArgMin", [X], {"axis": 1})
case("ArgMin_select_last", "ArgMin", [np.array([[1, 0, 0], [2, 2, 5]], np.float32)],
     {"axis": 1, "select_last_index": 1})
case("CumSum", "CumSum", [X, S(1)], tol=SUM)
case("CumSum_exclusive_reverse", "CumSum", [i32(3, 6), S(1)], {"exclusive": 1, "reverse": 1})
case("TopK", "TopK", [np.array([[3, 1, 3, 2, 1], [0, 5, 5, 5, 1]], np.float32), S([3])],
     n_out=2)
case("TopK_smallest_axis0", "TopK", [f32(6, 3), S([2])], {"largest": 0, "axis": 0}, n_out=2)
case("NonZero", "NonZero", [np.array([[1, 0, 2], [0, 0, 3]], np.int32)], modes=("const",))

# --- normalization and softmax -------------------------------------------------
case("Softmax", "Softmax", [X], {"axis": 1}, tol=SUM)
case("LogSoftmax", "LogSoftmax", [X], tol=SUM)
case("AddSoftmax", "AddSoftmax", [X, f32(4, 5)], tol=SUM)
case("SafeSoftmax", "SafeSoftmax",
     [np.array([[1.0, 2.0, -np.inf], [-np.inf, -np.inf, -np.inf]], np.float32)], tol=SUM)
case("LayerNormalization", "LayerNormalization", [X, f32(5), f32(5)], {"epsilon": 1e-3}, tol=SUM)
case("RMSNormalization", "RMSNormalization", [X, f32(5)], tol=SUM)
case("BatchNormalization", "BatchNormalization",
     [f32(2, 3, 4, 4), f32(3), f32(3), f32(3), f32(3, lo=0.5, hi=2.0)], tol=SUM)
case("InstanceNormalization", "InstanceNormalization", [f32(2, 3, 4, 4), f32(3), f32(3)],
     tol=SUM)
case("LpNormalization_p2", "LpNormalization", [X], {"axis": 1}, tol=SUM)
case("LpNormalization_p1", "LpNormalization", [X], {"p": 1}, tol=SUM)

# --- matmul and quantization ------------------------------------------------------
U8 = R.integers(0, 256, (2, 3, 8)).astype(np.uint8)
S8 = R.integers(-128, 128, (8, 6)).astype(np.int8)
case("Gemm", "Gemm", [f32(4, 3), f32(5, 4), f32(5)],
     {"transA": 1, "transB": 1, "alpha": 0.5, "beta": 2.0}, tol=SUM)
case("Gemm_plain", "Gemm", [f32(3, 4), f32(4, 5)], tol=SUM)
case("FusedMatMul", "FusedMatMul", [f32(2, 3, 4), f32(4, 5)], {"alpha": 0.25}, tol=SUM)
case("MatMulInteger", "MatMulInteger", [U8, S8, np.uint8(131), np.int8(-3)])
case("MatMulInteger_s8", "MatMulInteger", [S8[:3, :].reshape(3, 6)[:, :6].astype(np.int8),
                                           R.integers(-128, 128, (6, 4)).astype(np.int8)])
case("MatMulInteger_col_zp", "MatMulInteger",
     [U8[0], S8, None, R.integers(-4, 4, 6).astype(np.int8)])
case("MatMulIntegerToFloat_batched", "MatMulIntegerToFloat",
     [U8, R.integers(-128, 128, (2, 8, 6)).astype(np.int8), np.float32(0.02),
      f32(6, lo=0.01, hi=0.1), np.uint8(120)], tol=ULP)
case("QuantizeLinear", "QuantizeLinear", [X, np.float32(0.05), np.uint8(128)])
case("QuantizeLinear_no_zp", "QuantizeLinear", [XP, np.float32(0.02)])
case("QuantizeLinear_axis_s8", "QuantizeLinear",
     [X, f32(4, lo=0.01, hi=0.1), np.array([0, 1, -1, 3], np.int8)], {"axis": 1})
case("QuantizeLinear_block", "QuantizeLinear",
     [f32(3, 8), f32(3, 4, lo=0.01, hi=0.1), np.zeros((3, 4), np.int8)],
     {"axis": 1, "block_size": 2})
case("DequantizeLinear", "DequantizeLinear", [U8, np.float32(0.05), np.uint8(128)])
case("DequantizeLinear_axis", "DequantizeLinear",
     [S8, f32(6, lo=0.01, hi=0.1), R.integers(-4, 4, 6).astype(np.int8)], {"axis": 1})
case("DequantizeLinear_block", "DequantizeLinear",
     [S8, f32(4, 6, lo=0.01, hi=0.1)], {"axis": 0, "block_size": 2})


def _build(GB, DT, op, inputs, attrs, n_out, mode):
    b = GB()
    ins, feed = [], {}
    for i, x in enumerate(inputs):
        if x is None:
            ins.append(None)
            continue
        static = isinstance(x, tuple)
        arr = np.asarray(x[1] if static else x)
        if static or mode == "const":
            ins.append(b.constant(f"c{i}", arr))
        else:
            ins.append(b.input(f"x{i}", DT.from_np(arr.dtype), arr.shape))
            feed[f"x{i}"] = arr
    if "to" in attrs:
        attrs = {**attrs, "to": getattr(DT, attrs["to"])}
    outs = b.op(op, ins, attrs, n_outputs=n_out, output_names=[f"y{i}" for i in range(n_out)])
    b.output(*(outs if n_out > 1 else (outs,)))
    return b.finish(), feed


@pytest.mark.parametrize("op,inputs,attrs,n_out,tol,mode", CASES)
def test_op(op, inputs, attrs, n_out, tol, mode):
    tg, feed = _build(TBuilder, TDataType, op, inputs, attrs, n_out, mode)
    jg, _ = _build(JBuilder, JDataType, op, inputs, attrs, n_out, mode)
    names = [f"y{i}" for i in range(n_out)]
    got = [t.numpy() for t in TModel(tg, TOptions(optimize=False), device="cpu").run(feed, names)]
    want = [np.asarray(a) for a in JModel(jg, JOptions(optimize=False)).run(feed, names)]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, g.shape, w.dtype, w.shape)
        if tol == EXACT or g.dtype.kind != "f":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=tol[0], atol=tol[1])


def test_every_op_of_the_families_is_held():
    """The cases cover every op the JAX package registers in the families'
    modules (and the port registers them all)."""
    import rten_tpu.ops  # noqa: F401
    import rten_tpu_torch.ops.registry as treg
    from rten_tpu.ops import elementwise, layout, norm, reduce
    from rten_tpu.ops.registry import REGISTRY as JREG

    family = {name for name, d in JREG.items()
              if d.lower.__module__ in {m.__name__ for m in (elementwise, layout, norm, reduce)}}
    family |= {"Gemm", "MatMulInteger", "FusedMatMul", "MatMulIntegerToFloat", "QuantizeLinear",
               "DequantizeLinear"}
    held = {p.values[0] for p in CASES}
    assert family - held == set()
    assert family - set(treg.REGISTRY) == set()
    assert len([n for n in family if JREG[n].lower.__module__.endswith("elementwise")]) == 57
    assert len([n for n in family if JREG[n].lower.__module__.endswith("layout")]) == 26
