"""Every op of the port's vision families as a one-node graph in both
packages, on the same seeded inputs: Conv (1-D to 3-D, groups and
depthwise, strides, dilations, every ``auto_pad``, pads that differ on the
two sides, with and without bias), ConvInteger, ConvIntegerToFloat,
ConvTranspose (groups, ``output_padding``, ``output_shape`` with
``auto_pad``, dilations, 1-D and 2-D), MaxPool, AveragePool,
GlobalAveragePool, GlobalMaxPool, Resize (opset 10 and >= 11 input forms,
scales and sizes, every coordinate transformation and nearest mode, cubic
with ``exclude_outside``, integer inputs), Upsample and GridSample (every
mode, padding mode and ``align_corners``).

The data are graph inputs; weights, scales and zero points are inputs
too, and shapes and scales constants. The dtype and shape of every output
must match, and both packages' shape inference must give the same dtype
and shape of it, equal to the run's where it is concrete. Integer results
are exact, and so are max pools, nearest resizes and nearest samples. The
rest are held within the tolerance of their group: ``ULP`` (2e-6 relative,
1e-6 absolute: a product of two scales, or weights applied in another
order), ``SUM`` (1e-5 relative, 2e-6 absolute: a sum of a few products or
window values) and ``CONV`` (1e-5 relative, 1e-5 absolute: a conv's sums
of up to 108 products of values in [-3, 3], which XLA and oneDNN sum in
other orders).
"""

import numpy as np
import pytest

from rten_tpu.dtypes import DataType as JDataType
from rten_tpu.ir.builder import GraphBuilder as JBuilder
from rten_tpu.model import Model as JModel
from rten_tpu.model import ModelOptions as JOptions
from rten_tpu.shape_inference import infer_shapes as j_infer
from rten_tpu_torch.dtypes import DataType as TDataType
from rten_tpu_torch.ir.builder import GraphBuilder as TBuilder
from rten_tpu_torch.model import Model as TModel
from rten_tpu_torch.model import ModelOptions as TOptions
from rten_tpu_torch.shape_inference import infer_shapes as t_infer

from torch_one_thread import one_torch_thread  # noqa: F401

EXACT, ULP, SUM, CONV = (0.0, 0.0), (2e-6, 1e-6), (1e-5, 2e-6), (1e-5, 1e-5)
R = np.random.default_rng(17)


def f32(*shape, lo=-3.0, hi=3.0):
    return R.uniform(lo, hi, shape).astype(np.float32)


def u8(*shape):
    return R.integers(0, 256, shape).astype(np.uint8)


def s8(*shape, lo=-127, hi=128):
    return R.integers(lo, hi, shape).astype(np.int8)


def S(a, dtype=np.float32):
    """A static input (scales, sizes): a constant."""
    return ("static", np.asarray(a, dtype))


# (id, op, inputs, attrs, tolerance); an input is an array, None (an
# omitted optional input) or S(...).
CASES = []


def case(cid, op, inputs, attrs=None, tol=EXACT):
    CASES.append(pytest.param(op, inputs, attrs or {}, tol, id=cid))


# --- Conv --------------------------------------------------------------------
X4 = f32(2, 4, 9, 8)
W3 = f32(6, 4, 3, 3)
B6 = f32(6)
case("conv2d_bias_pad1", "Conv", [X4, W3, B6], {"pads": [1, 1, 1, 1]}, CONV)
case("conv2d_nobias", "Conv", [X4, W3], {}, CONV)
case("conv2d_stride2_dil2", "Conv", [X4, W3, B6],
     {"strides": [2, 2], "dilations": [2, 2], "pads": [2, 2, 2, 2]}, CONV)
case("conv2d_stride_2x1", "Conv", [X4, W3], {"strides": [2, 1], "pads": [1, 0, 1, 0]}, CONV)
case("conv2d_pads_asym", "Conv", [X4, W3, B6], {"pads": [0, 1, 2, 0]}, CONV)
case("conv2d_group2", "Conv", [X4, f32(6, 2, 3, 3), B6], {"group": 2, "pads": [1, 1, 1, 1]},
     CONV)
case("conv2d_depthwise", "Conv", [X4, f32(4, 1, 3, 3), f32(4)],
     {"group": 4, "pads": [1, 1, 1, 1]}, CONV)
case("conv2d_depthwise_mult2", "Conv", [X4, f32(8, 1, 3, 3)], {"group": 4}, CONV)
for ap in ("SAME_UPPER", "SAME_LOWER", "VALID"):
    case(f"conv2d_{ap}_k2_s2", "Conv", [X4, f32(6, 4, 2, 2), B6],
         {"auto_pad": ap, "strides": [2, 2]}, CONV)
    case(f"conv2d_{ap}_k3_dil2", "Conv", [X4, W3], {"auto_pad": ap, "dilations": [2, 2]}, CONV)
case("conv2d_1x1", "Conv", [X4, f32(6, 4, 1, 1), B6], {}, CONV)
case("conv1d", "Conv", [f32(2, 3, 11), f32(5, 3, 3), f32(5)],
     {"pads": [2, 1], "strides": [2], "dilations": [2]}, CONV)
case("conv1d_same_upper_even", "Conv", [f32(2, 3, 10), f32(5, 3, 4)], {"auto_pad": "SAME_UPPER"},
     CONV)
case("conv3d", "Conv", [f32(1, 2, 5, 6, 7), f32(3, 2, 2, 3, 3), f32(3)],
     {"pads": [1, 0, 1, 0, 1, 1], "strides": [1, 2, 1]}, CONV)
case("conv3d_group2", "Conv", [f32(1, 4, 4, 5, 5), f32(4, 2, 3, 3, 3)],
     {"group": 2, "auto_pad": "SAME_LOWER"}, CONV)

# --- ConvInteger and ConvIntegerToFloat ------------------------------------------
XU = u8(2, 3, 7, 6)
WS = s8(5, 3, 3, 3)
case("convinteger_zps", "ConvInteger", [XU, WS, np.uint8(131), np.int8(3)], {"pads": [1, 1, 1, 1]})
case("convinteger_no_zps", "ConvInteger", [XU, WS], {"strides": [2, 2]})
case("convinteger_xzp_only_pad_asym", "ConvInteger", [XU, WS, np.uint8(7)],
     {"pads": [0, 2, 1, 0], "dilations": [1, 2]})
case("convinteger_per_channel_wzp", "ConvInteger",
     [XU, WS, np.uint8(120), s8(5, lo=-4, hi=5)], {"auto_pad": "SAME_UPPER"})
case("convinteger_u8_weights", "ConvInteger", [XU, u8(5, 3, 2, 2), np.uint8(100), np.uint8(128)],
     {"strides": [1, 2]})
case("convinteger_group3", "ConvInteger", [u8(1, 6, 5, 5), s8(6, 2, 3, 3), np.uint8(9)],
     {"group": 3, "pads": [1, 1, 1, 1]})
case("convinteger_1d", "ConvInteger", [u8(2, 4, 9), s8(3, 4, 3), np.uint8(77), np.int8(-2)],
     {"pads": [1, 2]})
case("convinteger_3d", "ConvInteger", [u8(1, 2, 4, 4, 5), s8(3, 2, 2, 2, 3), np.uint8(60)],
     {"strides": [1, 1, 2]})
WSC = f32(5, lo=1e-3, hi=2e-2)
case("citf_bias_pads", "ConvIntegerToFloat",
     [XU, WS, np.float32(0.02), WSC, np.uint8(131), None, f32(5)], {"pads": [1, 1, 1, 1]}, ULP)
case("citf_stride2_no_bias", "ConvIntegerToFloat",
     [XU, WS, np.float32(0.013), WSC, np.uint8(0)], {"strides": [2, 2], "pads": [1, 0, 0, 1]},
     ULP)
case("citf_scalar_wscale_wzp", "ConvIntegerToFloat",
     [XU, WS, np.float32(0.02), np.float32(0.004), np.uint8(99), np.int8(2), f32(5)],
     {"dilations": [2, 1]}, ULP)
case("citf_per_channel_wzp", "ConvIntegerToFloat",
     [XU, WS, np.float32(0.02), WSC, np.uint8(99), s8(5, lo=-3, hi=4)], {"pads": [2, 2, 2, 2]},
     ULP)
case("citf_1x1_k64_n70", "ConvIntegerToFloat",
     [u8(1, 64, 4, 4), s8(70, 64, 1, 1), np.float32(0.01), f32(70, lo=1e-3, hi=2e-2),
      np.uint8(128), None, f32(70)], {}, ULP)
case("citf_group2", "ConvIntegerToFloat",
     [u8(1, 4, 5, 5), s8(4, 2, 3, 3), np.float32(0.03), f32(4, lo=1e-3, hi=2e-2), np.uint8(5)],
     {"group": 2}, ULP)

# --- ConvTranspose -------------------------------------------------------------------
XT = f32(2, 4, 5, 6)
WT = f32(4, 3, 3, 3)
case("convT2d_bias", "ConvTranspose", [XT, WT, f32(3)], {}, CONV)
case("convT2d_stride2_outpad", "ConvTranspose", [XT, WT, f32(3)],
     {"strides": [2, 2], "output_padding": [1, 0], "pads": [1, 1, 1, 1]}, CONV)
case("convT2d_pads_asym", "ConvTranspose", [XT, WT], {"strides": [2, 1], "pads": [0, 2, 1, 0]},
     CONV)
case("convT2d_dil2", "ConvTranspose", [XT, WT], {"dilations": [2, 2], "pads": [1, 1, 2, 0]},
     CONV)
case("convT2d_group2", "ConvTranspose", [XT, f32(4, 2, 3, 3), f32(4)],
     {"group": 2, "strides": [2, 2]}, CONV)
case("convT2d_output_shape_upper", "ConvTranspose", [XT, WT],
     {"strides": [2, 2], "output_shape": [10, 12], "auto_pad": "SAME_UPPER"}, CONV)
case("convT2d_output_shape_lower", "ConvTranspose", [XT, WT, f32(3)],
     {"strides": [2, 2], "output_shape": [9, 11]}, CONV)
case("convT2d_k4_s2_p1", "ConvTranspose", [XT, f32(4, 3, 4, 4)],
     {"strides": [2, 2], "pads": [1, 1, 1, 1]}, CONV)
case("convT1d", "ConvTranspose", [f32(2, 3, 7), f32(3, 2, 4), f32(2)],
     {"strides": [3], "pads": [1, 2], "output_padding": [2]}, CONV)

# --- pools -----------------------------------------------------------------------------
XP = f32(2, 3, 9, 10)
for name, attrs in [
    ("k3_s2_p1", {"kernel_shape": [3, 3], "strides": [2, 2], "pads": [1, 1, 1, 1]}),
    ("k2_s2", {"kernel_shape": [2, 2], "strides": [2, 2]}),
    ("k3_s2_ceil", {"kernel_shape": [3, 3], "strides": [2, 2], "ceil_mode": 1}),
    ("k2_s3_ceil_p1", {"kernel_shape": [2, 2], "strides": [3, 3], "ceil_mode": 1,
                       "pads": [1, 0, 1, 1]}),
    ("k3_dil2", {"kernel_shape": [3, 3], "dilations": [2, 2], "pads": [2, 1, 0, 2]}),
    ("k3_dil2_ceil", {"kernel_shape": [3, 2], "dilations": [2, 2], "strides": [2, 2],
                      "ceil_mode": 1}),
    ("same_upper_k2", {"kernel_shape": [2, 2], "strides": [2, 2], "auto_pad": "SAME_UPPER"}),
    ("same_lower_k3", {"kernel_shape": [3, 3], "auto_pad": "SAME_LOWER"}),
    ("valid_k3_s1x2", {"kernel_shape": [3, 3], "strides": [1, 2], "auto_pad": "VALID"}),
]:
    case(f"maxpool_{name}", "MaxPool", [XP], attrs)
    case(f"avgpool_{name}", "AveragePool", [XP], attrs, SUM)
    case(f"avgpool_{name}_include_pad", "AveragePool", [XP], {**attrs, "count_include_pad": 1},
         SUM)
case("maxpool_int32_1d", "MaxPool", [R.integers(-9, 10, (2, 3, 11)).astype(np.int32)],
     {"kernel_shape": [3], "strides": [2], "pads": [1, 1]})
case("maxpool_1d", "MaxPool", [f32(2, 3, 12)], {"kernel_shape": [4], "strides": [3],
                                                 "ceil_mode": 1})
case("maxpool_3d", "MaxPool", [f32(1, 2, 5, 6, 7)],
     {"kernel_shape": [2, 3, 2], "strides": [2, 2, 1], "pads": [1, 1, 0, 0, 1, 1]})
case("avgpool_1d", "AveragePool", [f32(2, 3, 12)], {"kernel_shape": [3], "pads": [1, 2]}, SUM)
case("avgpool_3d_ceil", "AveragePool", [f32(1, 2, 5, 6, 7)],
     {"kernel_shape": [2, 2, 3], "strides": [2, 2, 2], "ceil_mode": 1}, SUM)
case("avgpool_3d_include_pad", "AveragePool", [f32(1, 2, 5, 6, 7)],
     {"kernel_shape": [3, 3, 3], "pads": [1, 1, 1, 1, 1, 1], "count_include_pad": 1}, SUM)
for op in ("GlobalAveragePool", "GlobalMaxPool"):
    tol = EXACT if op == "GlobalMaxPool" else SUM
    case(f"{op}_2d", op, [f32(2, 5, 7, 6)], tol=tol)
    case(f"{op}_1d", op, [f32(3, 4, 9)], tol=tol)
    case(f"{op}_3d", op, [f32(1, 3, 4, 5, 6)], tol=tol)

# --- Resize and Upsample -----------------------------------------------------------
XR = f32(2, 3, 5, 6)
ROI = S(np.zeros(0))
UP = S([1, 1, 2.0, 1.5])
DOWN = S([1, 1, 0.6, 0.5])
for coord in ("half_pixel", "half_pixel_symmetric", "pytorch_half_pixel", "asymmetric",
              "align_corners"):
    for tag, scales in (("up", UP), ("down", DOWN)):
        case(f"resize_linear_{coord}_{tag}", "Resize", [XR, ROI, scales],
             {"mode": "linear", "coordinate_transformation_mode": coord}, SUM)
        case(f"resize_cubic_{coord}_{tag}", "Resize", [XR, ROI, scales],
             {"mode": "cubic", "coordinate_transformation_mode": coord}, SUM)
    case(f"resize_cubic_{coord}_exclude_outside", "Resize", [XR, ROI, UP],
         {"mode": "cubic", "coordinate_transformation_mode": coord, "exclude_outside": 1}, SUM)
for coord in ("half_pixel", "asymmetric", "align_corners", "tf_half_pixel_for_nn",
              "pytorch_half_pixel"):
    for nearest in ("round_prefer_floor", "round_prefer_ceil", "floor", "ceil"):
        case(f"resize_nearest_{coord}_{nearest}", "Resize", [XR, ROI, S([1, 1, 2.5, 1.5])],
             {"mode": "nearest", "coordinate_transformation_mode": coord,
              "nearest_mode": nearest})
case("resize_nearest_default_down", "Resize", [XR, ROI, DOWN])
case("resize_sizes_linear", "Resize", [XR, ROI, None, S([2, 3, 7, 13], np.int32)],
     {"mode": "linear"}, SUM)
case("resize_sizes_cubic_align", "Resize", [XR, ROI, None, S([2, 3, 9, 4], np.int32)],
     {"mode": "cubic", "coordinate_transformation_mode": "align_corners"}, SUM)
case("resize_sizes_nearest_to_1", "Resize", [XR, ROI, None, S([2, 3, 1, 4], np.int32)],
     {"mode": "nearest", "coordinate_transformation_mode": "pytorch_half_pixel"})
case("resize_empty_scales_sizes", "Resize", [XR, ROI, S(np.zeros(0)), S([2, 3, 10, 3], np.int32)],
     {"mode": "linear", "coordinate_transformation_mode": "asymmetric"}, SUM)
case("resize_opset10_form", "Resize", [XR, S([1, 1, 2.0, 2.0])], {"mode": "linear"}, SUM)
case("resize_all_axes", "Resize", [XR, ROI, S([2.0, 1.0, 1.4, 1.0])], {"mode": "linear"}, SUM)
case("resize_uint8_linear", "Resize", [u8(1, 2, 5, 6), ROI, UP], {"mode": "linear"})
case("resize_uint8_nearest", "Resize", [u8(1, 2, 5, 6), ROI, UP], {"mode": "nearest"})
case("resize_int32_linear_align", "Resize",
     [R.integers(-50, 50, (1, 2, 4, 5)).astype(np.int32), ROI, S([1, 1, 2.5, 2.0])],
     {"mode": "linear", "coordinate_transformation_mode": "align_corners"})
# A smooth ramp: the cubic weights' overshoot stays inside uint8's range
# (a cast out of range is not defined in either package).
RAMP = (np.arange(30).reshape(1, 1, 5, 6) * 4 + 60).astype(np.uint8)
case("resize_uint8_cubic_ramp", "Resize", [RAMP, ROI, UP], {"mode": "cubic"})
case("upsample_nearest", "Upsample", [XR, S([1, 1, 2.0, 3.0])], {"mode": "nearest"})
case("upsample_linear", "Upsample", [XR, S([1, 1, 2.0, 1.5])], {"mode": "linear"}, SUM)
case("upsample_scales_attr", "Upsample", [XR], {"mode": "nearest", "scales": [1.0, 1.0, 2.0, 2.0]})

# --- GridSample --------------------------------------------------------------------
XG = f32(2, 3, 5, 7)
GRID = f32(2, 4, 6, 2, lo=-1.3, hi=1.3)
# Coordinates that land on half pixels and on the edges.
HALF = np.stack(np.meshgrid(np.linspace(-1, 1, 5), np.linspace(-1.2, 1.2, 4)), -1)
HALF = np.broadcast_to(HALF, (2, 4, 5, 2)).astype(np.float32)
for mode in ("bilinear", "nearest"):
    for padding in ("zeros", "border", "reflection"):
        for align in (0, 1):
            tol = EXACT if mode == "nearest" else SUM
            attrs = {"mode": mode, "padding_mode": padding, "align_corners": align}
            case(f"gridsample_{mode}_{padding}_align{align}", "GridSample", [XG, GRID], attrs,
                 tol)
            case(f"gridsample_{mode}_{padding}_align{align}_half", "GridSample", [XG, HALF],
                 attrs, tol)
case("gridsample_linear_reflection", "GridSample", [XG, GRID],
     {"mode": "linear", "padding_mode": "reflection"}, SUM)
case("gridsample_defaults", "GridSample", [XG, GRID], {}, SUM)
case("gridsample_reflection_size1", "GridSample", [f32(1, 2, 1, 6), GRID[:1]],
     {"padding_mode": "reflection", "align_corners": 1}, SUM)


def _build(GB, DT, op, inputs, attrs):
    b = GB()
    ins, feed = [], {}
    for i, x in enumerate(inputs):
        if x is None:
            ins.append(None)
            continue
        static = isinstance(x, tuple)
        arr = np.asarray(x[1] if static else x)
        if static:
            ins.append(b.constant(f"c{i}", arr))
        else:
            ins.append(b.input(f"x{i}", DT.from_np(arr.dtype), arr.shape))
            feed[f"x{i}"] = arr
    b.output(b.op(op, ins, attrs, output_names=["y"]))
    return b.finish(), feed


@pytest.mark.parametrize("op,inputs,attrs,tol", CASES)
def test_op(op, inputs, attrs, tol):
    tg, feed = _build(TBuilder, TDataType, op, inputs, attrs)
    jg, _ = _build(JBuilder, JDataType, op, inputs, attrs)
    got = TModel(tg, TOptions(optimize=False), device="cpu").run(feed, ["y"])[0].numpy()
    want = np.asarray(JModel(jg, JOptions(optimize=False)).run(feed, ["y"])[0])
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, got.shape,
                                                                  want.dtype, want.shape)
    if tol == EXACT or got.dtype.kind != "f":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=tol[0], atol=tol[1])
    # Shape inference: the port's dtype and shape are the run's where they
    # are concrete, and the JAX package's, but where the JAX package's rule
    # gives a concrete shape that its own op does not produce.
    (tdt, tshape), (jdt, jshape) = (
        infer(g)[g.output_ids[0]] for infer, g in ((t_infer, tg), (j_infer, jg)))
    assert tdt is not None and tdt.np_dtype == got.dtype and tdt.value == jdt.value
    if tshape is not None and all(isinstance(d, int) for d in tshape):
        assert tuple(tshape) == got.shape
    if jshape is not None and all(isinstance(d, int) for d in jshape) \
            and tuple(jshape) != want.shape:
        assert op in REPAIRED_RULES and tuple(tshape) == got.shape
    else:
        assert tshape == jshape


# The port's shape rules that give the ops' output shapes where the JAX
# package's do not: GridSample's (it gives x's shape), the pools' (they
# read neither auto_pad nor dilations) and ConvTranspose's (it reads no
# output_shape).
REPAIRED_RULES = {"GridSample", "MaxPool", "AveragePool", "ConvTranspose"}


@pytest.mark.parametrize("dtype", [np.int8, np.uint8])
def test_integer_max_pool_pads_with_the_dtype_minimum(dtype):
    """MaxPool on 8-bit integers (the JAX op's reduce_window refuses their
    int32 initial value): equal to the port's f32 max pool of the same
    values, windows reaching into the pads and past the edge (ceil_mode)."""
    info = np.iinfo(dtype)
    x = R.integers(info.min, info.max + 1, (2, 3, 8, 9)).astype(dtype)
    x[0, 0, :2, :2] = info.min
    attrs = {"kernel_shape": [3, 3], "strides": [2, 2], "pads": [1, 1, 0, 1], "ceil_mode": 1}
    got, ref = (
        TModel(_build(TBuilder, TDataType, "MaxPool", [v], attrs)[0], TOptions(optimize=False),
               device="cpu").run({"x0": v}, ["y"])[0].numpy()
        for v in (x, x.astype(np.float32)))
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, ref.astype(dtype))


@pytest.mark.parametrize("op,inputs,attrs", [
    ("Resize", [XR, ROI, UP], {"coordinate_transformation_mode": "tf_crop_and_resize"}),
    ("Resize", [XR, ROI], {}),
    ("GridSample", [XG, GRID], {"mode": "cubic"}),
    ("GridSample", [f32(1, 1, 2, 3, 3), GRID[:1]], {}),
], ids=["resize_tf_crop_and_resize", "resize_no_scales_or_sizes", "gridsample_cubic",
        "gridsample_5d"])
def test_refused_as_the_jax_package_refuses(op, inputs, attrs):
    """What the JAX ops refuse, the port refuses, at run time."""
    from rten_tpu.ops.registry import OpError as JOpError
    from rten_tpu_torch.ops.registry import OpError as TOpError

    tg, feed = _build(TBuilder, TDataType, op, inputs, attrs)
    jg, _ = _build(JBuilder, JDataType, op, inputs, attrs)
    with pytest.raises(TOpError):
        TModel(tg, TOptions(optimize=False), device="cpu").run(feed, ["y"])
    with pytest.raises(JOpError):
        JModel(jg, JOptions(optimize=False)).run(feed, ["y"])


def test_every_op_of_the_families_is_held():
    """The cases cover every op the JAX package registers in its conv,
    pool, resize and grid_sample modules, and the port registers them all
    (a graph holding one no longer stops with NotImplementedError)."""
    import rten_tpu.ops  # noqa: F401
    import rten_tpu_torch.ops.registry as treg
    from rten_tpu.ops import conv, grid_sample, pool, resize
    from rten_tpu.ops.registry import REGISTRY as JREG

    family = {name for name, d in JREG.items()
              if d.lower.__module__ in {m.__name__ for m in (conv, pool, resize, grid_sample)}}
    assert family == {"Conv", "ConvInteger", "ConvIntegerToFloat", "ConvTranspose", "MaxPool",
                      "AveragePool", "GlobalAveragePool", "GlobalMaxPool", "Resize", "Upsample",
                      "GridSample"}
    assert family - {p.values[0] for p in CASES} == set()
    assert family - set(treg.REGISTRY) == set()
    for name in family:
        treg.get_op(name)  # raises OpError for an op not registered


def test_conv_integer_to_float_lays_out_a_constant_weight_once():
    """ConvIntegerToFloat with constant s8 weights at C·k = 147 (not a
    multiple of 4): equal to the JAX op on two runs; the [C·k, O] weight
    matrix, widened with zero rows to 148, is made on the first run, kept
    by the executor for the second and dropped by ``invalidate_weights``;
    the patches come widened with x_zp columns, which add nothing."""
    import torch

    from rten_tpu_torch.ops.conv import im2col, weight_matrix

    x, w = u8(2, 3, 13, 11), s8(16, 3, 7, 7)
    inputs = [x, S(w, np.int8), S(0.02), S(R.uniform(1e-3, 1e-2, 16)), S(131, np.uint8), None,
              S(f32(16))]
    attrs = {"strides": [2, 2], "pads": [3, 2, 3, 2]}
    tg, feed = _build(TBuilder, TDataType, "ConvIntegerToFloat", inputs, attrs)
    jg, _ = _build(JBuilder, JDataType, "ConvIntegerToFloat", inputs, attrs)
    want = np.asarray(JModel(jg, JOptions(optimize=False)).run(feed, ["y"])[0])
    model = TModel(tg, TOptions(optimize=False), device="cpu")
    ex = model.executor
    first = model.run(feed, ["y"])[0].numpy()
    (made,) = [v for _, v in ex._derived.values()]
    second = model.run(feed, ["y"])[0].numpy()
    assert [v for _, v in ex._derived.values()] == [made]
    np.testing.assert_allclose(first, want, rtol=ULP[0], atol=ULP[1])
    np.testing.assert_array_equal(second, first)
    assert made.shape == (148, 16) and not made[147].any()
    np.testing.assert_array_equal(made[:147].numpy(), w.reshape(16, 147).T)
    ex.invalidate_weights()
    assert ex._derived == {}

    zp = torch.tensor(131, dtype=torch.uint8)
    xt = torch.from_numpy(x)
    narrow, sp = im2col(xt, [7, 7], [2, 2], [1, 1], [(3, 3), (2, 2)], zp)
    wide, wide_sp = im2col(xt, [7, 7], [2, 2], [1, 1], [(3, 3), (2, 2)], zp, ck_multiple=4)
    assert sp == wide_sp and narrow.shape == (2 * 7 * 5, 147) and wide.shape == (70, 148)
    assert torch.equal(wide[:, :147], narrow) and bool((wide[:, 147] == 131).all())
    assert torch.equal(weight_matrix(torch.from_numpy(w), 147), made[:147])
