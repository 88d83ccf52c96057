"""`.rten` model container: read + write (a copy of
``rten_tpu/formats/rten.py``, numpy and the ``flatbuffers`` runtime only).

The reference's own model format (rten `rten-model-file/src/schema.fbs:12-796`,
header `header.rs:62-136`, format doc `docs/rten-file-format.md:30-78`):

    V2: [header][model_data: flatbuffers][tensor_data]
        header = RTEN magic | u32 version | u64 model_data_offset |
                 u64 model_data_len | u64 tensor_data_offset
    V1: the whole file is the flatbuffers model (identifier "RTEN" at
        buffer offset 4), tensors inline.

This module is hand-written against the schema (no generated bindings): a
compact vtable walker over the `flatbuffers` runtime for reads, and the
`flatbuffers.Builder` for writes. Supporting both directions makes the
engine a drop-in consumer of existing `.rten` files AND gives `rten-convert`
parity (ONNX -> .rten) via `Model.save_rten` / the CLI.

Field slots are the schema's declaration order; union fields occupy two
slots (type tag, value). Enum values are positional per the schema.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..dtypes import DataType
from ..ir.graph import Constant, Graph, Operator, Value


class RtenFormatError(Exception):
    pass


# --- schema enums (positional; rten-model-file/src/schema.fbs) -------------

OPERATOR_TYPES = [
    "Add", "ArgMin", "ArgMax", "AveragePool", "BatchNormalization", "Cast",
    "Clip", "Concat", "ConstantOfShape", "Conv", "ConvTranspose", "Cos",
    "CumSum", "Div", "Equal", "Erf", "Expand", "Flatten", "Gather", "Gemm",
    "GlobalAveragePool", "Greater", "GRU", "Identity", "LeakyRelu", "Less",
    "LessOrEqual", "Log", "LogSoftmax", "LSTM", "MatMul", "MaxPool", "Mod",
    "Mul", "Pad", "Pow", "Range", "ReduceMean", "ReduceL2", "Relu",
    "Reshape", "Resize", "Shape", "Sigmoid", "Sin", "Slice", "Split",
    "Sqrt", "Squeeze", "Softmax", "Sub", "Tanh", "Transpose", "Unsqueeze",
    "Where", "ReduceProd", "ReduceSum", "ReduceMin", "ReduceMax", "NonZero",
    "ScatterElements", "Tile", "Not", "Abs", "Max", "Mean", "Min", "Sum",
    "OneHot", "Round", "Floor", "Ceil", "Reciprocal", "TopK", "Neg", "Exp",
    "GreaterOrEqual", "Size", "Tan", "Acos", "Asin", "Atan",
    "InstanceNormalization", "HardSigmoid", "HardSwish", "And", "Or", "Xor",
    "Trilu", "ScatterND", "NonMaxSuppression", "Sign", "GatherElements",
    "LayerNormalization", "ReduceSumSquare", "RandomUniform", "Elu",
    "RandomUniformLike", "RandomNormal", "RandomNormalLike", "Softplus",
    "GatherND", "Gelu", "Einsum", "If", "DequantizeLinear", "QuantizeLinear",
    "DynamicQuantizeLinear", "MatMulInteger", "DepthToSpace", "ConvInteger",
    "CastLike", "Dropout", "EyeLike", "IsNaN", "IsInf", "Loop",
    "SequenceEmpty", "SequenceAt", "SequenceInsert", "ConcatFromSequence",
    "SplitToSequence", "SequenceLength", "SequenceConstruct", "SequenceErase",
    "GridSample", "PRelu", "STFT", "GlobalMaxPool", "ReduceL1", "Acosh",
    "Asinh", "Atanh", "Cosh", "Sinh", "Multinomial", "ReverseSequence",
    "DFT", "Scatter", "Upsample", "RotaryEmbedding", "Attention",
    "LpNormalization", "ReduceLogSum", "ReduceLogSumExp",
]
OP_TYPE_INDEX = {n: i for i, n in enumerate(OPERATOR_TYPES)}

# DataType enum (value-node / cast dtypes).
FBS_DTYPES = [DataType.Int32, DataType.Float, DataType.Int8, DataType.UInt8]
# ConstantDataType enum (constant-node dtypes; ushort).
FBS_CONST_DTYPES = [np.int32, np.float32, np.int8, np.uint8]

AUTO_PAD = ["SAME_UPPER", "NOTSET"]            # AutoPad: Same, NotSet
RNN_DIRECTIONS = ["forward", "reverse", "bidirectional"]
COORD_MODES = ["half_pixel", "asymmetric", "align_corners", "pytorch_half_pixel"]
NEAREST_MODES = ["floor", "ceil", "round_prefer_floor", "round_prefer_ceil"]
RESIZE_MODES = ["nearest", "linear"]
SCATTER_REDUCTIONS = ["none", "add", "mul", "min", "max"]
PAD_MODES = ["constant", "reflect", "edge", "wrap"]
DTS_MODES = ["DCR", "CRD"]
GELU_APPROX = ["none", "tanh"]


# --- low-level flatbuffers table walker ------------------------------------

# The ``flatbuffers`` runtime is imported by ``load_rten`` and ``save_rten``
# only (``_import_flatbuffers``), so the package imports where it is absent.
flatbuffers = None
NT = None


def _import_flatbuffers():
    global flatbuffers, NT
    if flatbuffers is None:
        import flatbuffers as fb
        from flatbuffers import number_types

        flatbuffers, NT = fb, number_types


class FbTable:
    """Read access to one flatbuffers table (slot = field declaration index)."""

    def __init__(self, buf, pos: int):
        self.tab = flatbuffers.table.Table(buf, pos)

    def _off(self, slot: int) -> int:
        return self.tab.Offset(4 + 2 * slot)

    def has(self, slot: int) -> bool:
        return self._off(slot) != 0

    def scalar(self, slot: int, flags, default=None):
        o = self._off(slot)
        if not o:
            return default
        return self.tab.Get(flags, self.tab.Pos + o)

    def i32(self, slot, default=0):
        return self.scalar(slot, NT.Int32Flags, default)

    def u32(self, slot, default=0):
        return self.scalar(slot, NT.Uint32Flags, default)

    def u64(self, slot, default=0):
        return self.scalar(slot, NT.Uint64Flags, default)

    def f32(self, slot, default=0.0):
        return self.scalar(slot, NT.Float32Flags, default)

    def u8(self, slot, default=0):
        return self.scalar(slot, NT.Uint8Flags, default)

    def u16(self, slot, default=0):
        return self.scalar(slot, NT.Uint16Flags, default)

    def bool_(self, slot, default=False):
        v = self.scalar(slot, NT.Uint8Flags, None)
        return default if v is None else bool(v)

    def string(self, slot) -> Optional[str]:
        o = self._off(slot)
        if not o:
            return None
        s = self.tab.String(self.tab.Pos + o)
        return s.decode("utf-8") if s is not None else None

    def table(self, slot) -> Optional["FbTable"]:
        o = self._off(slot)
        if not o:
            return None
        return FbTable(self.tab.Bytes, self.tab.Indirect(self.tab.Pos + o))

    def vec_np(self, slot, flags) -> Optional[np.ndarray]:
        o = self._off(slot)
        if not o:
            return None
        return self.tab.GetVectorAsNumpy(flags, o)

    def vec_len(self, slot) -> int:
        o = self._off(slot)
        return self.tab.VectorLen(o) if o else 0

    def vec_table(self, slot, i) -> "FbTable":
        o = self._off(slot)
        start = self.tab.Vector(o) + i * 4
        return FbTable(self.tab.Bytes, self.tab.Indirect(start))

    def vec_str(self, slot, i) -> Optional[str]:
        o = self._off(slot)
        start = self.tab.Vector(o) + i * 4
        s = self.tab.String(start)
        return s.decode("utf-8") if s is not None else None


# --- attribute codecs -------------------------------------------------------
#
# Each attr table is described by a field spec list (declaration order =
# slot order):  (our_attr_name, kind, default, enum_list_or_None)
# kind: i32 u32 f32 bool u8e (enum byte) uvec ivec str dtype cdtype graph
# A trailing "also used for" op mapping lives in OP_TO_ATTRS below.
#
# IMPORTANT: `default` is the *schema.fbs field default* (what a generated
# flatbuffers accessor returns for an ABSENT field), NOT the ONNX default.
# The reference's generated reader decodes absent scalars this way, so we
# must too — e.g. DequantizeLinearAttrs.axis is 0 when absent even though
# ONNX's default is 1 (rten-convert materializes the ONNX default at
# convert time, so non-schema-default values are always physically present).
# ONNX-default materialization for OUR writer lives in ONNX_WRITE_DEFAULTS.

SPECS: Dict[str, List[Tuple]] = {
    "ArgMaxAttrs": [("axis", "i32", 0, None), ("keepdims", "bool", False, None)],
    "AveragePoolAttrs": [
        ("kernel_shape", "uvec", None, None), ("auto_pad", "u8e", 0, AUTO_PAD),
        ("pads", "uvec", None, None), ("strides", "uvec", None, None),
        ("count_include_pad", "bool", False, None), ("ceil_mode", "bool", False, None),
    ],
    "BatchNormalizationAttrs": [("epsilon", "f32", 0.0, None)],
    "CastAttrs": [("to", "dtype", DataType.Int32, None)],
    "ConcatAttrs": [("axis", "i32", 0, None)],
    # ConstantOfShapeAttrs handled specially (Scalar union).
    "ConvAttrs": [
        ("auto_pad", "u8e", 0, AUTO_PAD), ("pads", "uvec", None, None),
        ("group", "u32", 0, None), ("strides", "uvec", None, None),
        ("dilations", "uvec", None, None),
    ],
    "ConvTransposeAttrs": [
        ("strides", "uvec", None, None), ("auto_pad", "u8e", 1, AUTO_PAD),
        ("pads", "uvec", None, None), ("group", "u32", 1, None),
        ("output_padding", "uvec", None, None), ("dilations", "uvec", None, None),
    ],
    "FlattenAttrs": [("axis", "i32", 0, None)],
    "GatherAttrs": [("axis", "i32", 0, None)],
    "GemmAttrs": [
        ("alpha", "f32", 0.0, None), ("beta", "f32", 0.0, None),
        ("transA", "bool", False, None), ("transB", "bool", False, None),
    ],
    "GRUAttrs": [
        ("direction", "u8e", 0, RNN_DIRECTIONS), ("hidden_size", "u32", 0, None),
        ("linear_before_reset", "bool", False, None),
    ],
    "LeakyReluAttrs": [("alpha", "f32", 0.0, None)],
    "LSTMAttrs": [("direction", "u8e", 0, RNN_DIRECTIONS), ("hidden_size", "u32", 0, None)],
    "MaxPoolAttrs": [
        ("kernel_shape", "uvec", None, None), ("auto_pad", "u8e", 0, AUTO_PAD),
        ("pads", "uvec", None, None), ("strides", "uvec", None, None),
        ("ceil_mode", "bool", False, None),
    ],
    "ReduceMeanAttrs": [
        ("axes", "ivec", None, None), ("keepdims", "bool", False, None),
        ("noop_with_empty_axes", "bool", False, None),
    ],
    "ReshapeAttrs": [("allowzero", "bool", False, None)],
    "ResizeAttrs": [
        ("mode", "u8e", 0, RESIZE_MODES),
        ("coordinate_transformation_mode", "u8e", 0, COORD_MODES),
        ("nearest_mode", "u8e", 0, NEAREST_MODES),
    ],
    "SplitAttrs": [("axis", "i32", 0, None), ("num_outputs", "i32", None, None)],
    "SoftmaxAttrs": [("axis", "i32", 0, None)],
    "TransposeAttrs": [("perm", "uvec", None, None)],
    "ModAttrs": [("fmod", "bool", False, None)],
    "ScatterElementsAttrs": [
        ("axis", "i32", 0, None), ("reduction", "u8e", 0, SCATTER_REDUCTIONS),
    ],
    "OneHotAttrs": [("axis", "i32", 0, None)],
    "TopKAttrs": [
        ("axis", "i32", 0, None), ("largest", "bool", False, None),
        ("sorted", "bool", False, None),
    ],
    "HardSigmoidAttrs": [("alpha", "f32", 0.0, None), ("beta", "f32", 0.0, None)],
    "TriluAttrs": [("upper", "bool", False, None)],
    "ScatterNDAttrs": [("reduction", "u8e", 0, SCATTER_REDUCTIONS)],
    "NonMaxSuppressionAttrs": [("center_point_box", "u8e", 0, None)],
    "LayerNormalizationAttrs": [("axis", "i32", 0, None), ("epsilon", "f32", 0.0, None)],
    "RandomUniformAttrs": [
        ("shape", "uvec", None, None), ("high", "f32", 0.0, None),
        ("low", "f32", 0.0, None), ("seed", "f32", None, None),
    ],
    "EluAttrs": [("alpha", "f32", 0.0, None)],
    "RandomUniformLikeAttrs": [
        ("high", "f32", 0.0, None), ("low", "f32", 0.0, None),
        ("seed", "f32", None, None),
    ],
    "RandomNormalAttrs": [
        ("mean", "f32", 0.0, None), ("scale", "f32", 0.0, None),
        ("seed", "f32", None, None), ("shape", "uvec", None, None),
    ],
    "RandomNormalLikeAttrs": [
        ("mean", "f32", 0.0, None), ("scale", "f32", 0.0, None),
        ("seed", "f32", None, None),
    ],
    "GatherNDAttrs": [("batch_dims", "i32", 0, None)],
    "GeluAttrs": [("approximate", "u8e", 0, GELU_APPROX)],
    "EinsumAttrs": [("equation", "str", None, None)],
    "IfAttrs": [("then_branch", "graph", None, None), ("else_branch", "graph", None, None)],
    "PadAttrs": [("mode", "u8e", 0, PAD_MODES)],
    "DequantizeLinearAttrs": [("axis", "i32", 0, None)],
    "QuantizeLinearAttrs": [("axis", "i32", 0, None), ("output_dtype", "dtype", None, None)],
    "DepthToSpaceAttrs": [("mode", "u8e", 0, DTS_MODES), ("blocksize", "u32", 0, None)],
    "CastLikeAttrs": [],
    "ShapeAttrs": [("start", "i32", None, None), ("end", "i32", None, None)],
    "DropoutAttrs": [("seed", "i32", None, None)],
    "EyeLikeAttrs": [("dtype", "dtype", None, None), ("k", "i32", 0, None)],
    "IsInfAttrs": [],
    "LoopAttrs": [("body", "graph", None, None)],
    "SequenceEmptyAttrs": [("dtype", "dtype", None, None)],
    "ConcatFromSequenceAttrs": [("axis", "i32", 0, None), ("new_axis", "bool", False, None)],
    "SplitToSequenceAttrs": [("axis", "i32", 0, None), ("keepdims", "bool", True, None)],
    "GridSampleAttrs": [("align_corners", "bool", False, None)],
    "STFTAttrs": [("onesided", "bool", True, None)],
    "MultinomialAttrs": [("sample_size", "i32", 0, None), ("seed", "f32", None, None)],
    "ReverseSequenceAttrs": [("batch_axis", "i32", 1, None), ("time_axis", "i32", 0, None)],
    "DFTAttrs": [("inverse", "bool", False, None), ("onesided", "bool", False, None)],
    "UpsampleAttrs": [("mode", "u8e", 0, RESIZE_MODES)],
    "RotaryEmbeddingAttrs": [
        ("interleaved", "bool", False, None), ("num_heads", "u32", 0, None),
        ("rotary_embedding_dim", "u32", 0, None),
    ],
    "AttentionAttrs": [
        ("is_causal", "bool", False, None), ("q_num_heads", "u32", None, None),
        ("kv_num_heads", "u32", None, None), ("scale", "f32", None, None),
        ("softcap", "f32", 0.0, None),
    ],
    "CumSumAttrs": [("exclusive", "bool", False, None), ("reverse", "bool", False, None)],
    "LpNormalizationAttrs": [("axis", "i32", -1, None), ("p", "u32", 2, None)],
}

# OperatorAttrs union member order (1-based; 0 = NONE).
ATTRS_UNION = [
    "ArgMaxAttrs", "AveragePoolAttrs", "BatchNormalizationAttrs", "CastAttrs",
    "ConcatAttrs", "ConstantOfShapeAttrs", "ConvAttrs", "ConvTransposeAttrs",
    "FlattenAttrs", "GatherAttrs", "GemmAttrs", "GRUAttrs", "LeakyReluAttrs",
    "LSTMAttrs", "MaxPoolAttrs", "ReduceMeanAttrs", "ReshapeAttrs",
    "ResizeAttrs", "SplitAttrs", "SoftmaxAttrs", "TransposeAttrs", "ModAttrs",
    "ScatterElementsAttrs", "OneHotAttrs", "TopKAttrs", "HardSigmoidAttrs",
    "TriluAttrs", "ScatterNDAttrs", "NonMaxSuppressionAttrs",
    "LayerNormalizationAttrs", "RandomUniformAttrs", "EluAttrs",
    "RandomUniformLikeAttrs", "RandomNormalAttrs", "RandomNormalLikeAttrs",
    "GatherNDAttrs", "GeluAttrs", "EinsumAttrs", "IfAttrs", "PadAttrs",
    "DequantizeLinearAttrs", "QuantizeLinearAttrs", "DepthToSpaceAttrs",
    "CastLikeAttrs", "ShapeAttrs", "DropoutAttrs", "EyeLikeAttrs",
    "IsInfAttrs", "LoopAttrs", "SequenceEmptyAttrs", "ConcatFromSequenceAttrs",
    "SplitToSequenceAttrs", "GridSampleAttrs", "STFTAttrs", "MultinomialAttrs",
    "ReverseSequenceAttrs", "DFTAttrs", "UpsampleAttrs", "RotaryEmbeddingAttrs",
    "AttentionAttrs", "CumSumAttrs", "LpNormalizationAttrs",
]
ATTRS_UNION_INDEX = {n: i + 1 for i, n in enumerate(ATTRS_UNION)}

# op_type -> attrs table used when saving (schema "Also used for" comments).
OP_TO_ATTRS: Dict[str, str] = {
    "ArgMax": "ArgMaxAttrs", "ArgMin": "ArgMaxAttrs",
    "AveragePool": "AveragePoolAttrs",
    "BatchNormalization": "BatchNormalizationAttrs",
    "InstanceNormalization": "BatchNormalizationAttrs",
    "Cast": "CastAttrs", "Concat": "ConcatAttrs",
    "ConstantOfShape": "ConstantOfShapeAttrs",
    "Conv": "ConvAttrs", "ConvInteger": "ConvAttrs",
    "ConvTranspose": "ConvTransposeAttrs", "Flatten": "FlattenAttrs",
    "Gather": "GatherAttrs", "GatherElements": "GatherAttrs",
    "Gemm": "GemmAttrs", "GRU": "GRUAttrs", "LeakyRelu": "LeakyReluAttrs",
    "LSTM": "LSTMAttrs", "MaxPool": "MaxPoolAttrs",
    "ReduceMean": "ReduceMeanAttrs", "ReduceL1": "ReduceMeanAttrs",
    "ReduceL2": "ReduceMeanAttrs", "ReduceProd": "ReduceMeanAttrs",
    "ReduceSum": "ReduceMeanAttrs", "ReduceMin": "ReduceMeanAttrs",
    "ReduceMax": "ReduceMeanAttrs", "ReduceSumSquare": "ReduceMeanAttrs",
    "ReduceLogSum": "ReduceMeanAttrs", "ReduceLogSumExp": "ReduceMeanAttrs",
    "Reshape": "ReshapeAttrs", "Resize": "ResizeAttrs", "Split": "SplitAttrs",
    "Softmax": "SoftmaxAttrs", "LogSoftmax": "SoftmaxAttrs",
    "Transpose": "TransposeAttrs", "Mod": "ModAttrs",
    "ScatterElements": "ScatterElementsAttrs", "Scatter": "ScatterElementsAttrs",
    "OneHot": "OneHotAttrs", "TopK": "TopKAttrs",
    "HardSigmoid": "HardSigmoidAttrs", "Trilu": "TriluAttrs",
    "ScatterND": "ScatterNDAttrs", "NonMaxSuppression": "NonMaxSuppressionAttrs",
    "LayerNormalization": "LayerNormalizationAttrs",
    "RandomUniform": "RandomUniformAttrs", "Elu": "EluAttrs",
    "RandomUniformLike": "RandomUniformLikeAttrs",
    "RandomNormal": "RandomNormalAttrs", "RandomNormalLike": "RandomNormalLikeAttrs",
    "GatherND": "GatherNDAttrs", "Gelu": "GeluAttrs", "Einsum": "EinsumAttrs",
    "If": "IfAttrs", "Pad": "PadAttrs",
    "DequantizeLinear": "DequantizeLinearAttrs",
    "QuantizeLinear": "QuantizeLinearAttrs", "DepthToSpace": "DepthToSpaceAttrs",
    "CastLike": "CastLikeAttrs", "Shape": "ShapeAttrs", "Dropout": "DropoutAttrs",
    "EyeLike": "EyeLikeAttrs", "IsInf": "IsInfAttrs", "Loop": "LoopAttrs",
    "SequenceEmpty": "SequenceEmptyAttrs",
    "ConcatFromSequence": "ConcatFromSequenceAttrs",
    "SplitToSequence": "SplitToSequenceAttrs", "GridSample": "GridSampleAttrs",
    "STFT": "STFTAttrs", "Multinomial": "MultinomialAttrs",
    "ReverseSequence": "ReverseSequenceAttrs", "DFT": "DFTAttrs",
    "Upsample": "UpsampleAttrs", "RotaryEmbedding": "RotaryEmbeddingAttrs",
    "Attention": "AttentionAttrs", "CumSum": "CumSumAttrs",
    "LpNormalization": "LpNormalizationAttrs",
}


# ONNX defaults that differ from the schema.fbs field defaults. rten-convert
# materializes ONNX defaults at convert time (op_reader.get_attr(name, dflt)),
# so values like Gemm alpha=1.0 are physically present in reference-written
# files. Our writer must do the same: an attrs dict that omits these (because
# the ONNX export relied on the spec default) gets them written explicitly,
# otherwise the reference's generated accessors would decode the schema
# default (0/0.0/false) and change semantics.
ONNX_WRITE_DEFAULTS: Dict[str, Dict[str, Any]] = {
    "ArgMaxAttrs": {"keepdims": True},
    "ConvAttrs": {"group": 1},
    "ConvTransposeAttrs": {"group": 1},
    "BatchNormalizationAttrs": {"epsilon": 1e-5},
    "FlattenAttrs": {"axis": 1},
    "GemmAttrs": {"alpha": 1.0, "beta": 1.0},
    "LeakyReluAttrs": {"alpha": 0.01},
    "SoftmaxAttrs": {"axis": -1},
    "OneHotAttrs": {"axis": -1},
    "TopKAttrs": {"axis": -1, "largest": True, "sorted": True},
    "HardSigmoidAttrs": {"alpha": 0.2, "beta": 0.5},
    "TriluAttrs": {"upper": True},
    "LayerNormalizationAttrs": {"axis": -1, "epsilon": 1e-5},
    "RandomUniformAttrs": {"high": 1.0, "low": 0.0},
    "RandomUniformLikeAttrs": {"high": 1.0, "low": 0.0},
    "RandomNormalAttrs": {"mean": 0.0, "scale": 1.0},
    "RandomNormalLikeAttrs": {"mean": 0.0, "scale": 1.0},
    "EluAttrs": {"alpha": 1.0},
    "DequantizeLinearAttrs": {"axis": 1},
    "QuantizeLinearAttrs": {"axis": 1},
    "MultinomialAttrs": {"sample_size": 1},
    "ReduceMeanAttrs": {"keepdims": True},
    "ResizeAttrs": {"nearest_mode": "round_prefer_floor"},
    "SplitToSequenceAttrs": {"keepdims": True},
    "STFTAttrs": {"onesided": True},
}


def _decode_attrs(name: str, t: Optional[FbTable], load_graph) -> Dict[str, Any]:
    """Decode one attrs table into our ONNX-named attrs dict."""
    attrs: Dict[str, Any] = {}
    if name == "ConstantOfShapeAttrs":
        if t is None:
            return attrs
        # union Scalar: slot0 = type, slot1 = value table
        sc_type = t.u8(0, 0)
        sc = t.table(1)
        if sc is not None:
            if sc_type == 1:  # IntScalar
                attrs["value"] = np.array([sc.i32(0, 0)], np.int32)
            elif sc_type == 2:  # FloatScalar
                attrs["value"] = np.array([sc.f32(0, 0.0)], np.float32)
        return attrs
    spec = SPECS.get(name)
    if spec is None:
        raise RtenFormatError(f"unknown attrs table {name}")
    if t is None:
        # All defaults.
        for attr_name, kind, default, enum in spec:
            if default is not None and kind != "graph":
                attrs[attr_name] = enum[default] if (enum and kind == "u8e") else default
        return attrs
    for slot, (attr_name, kind, default, enum) in enumerate(spec):
        if kind == "i32":
            v = t.i32(slot) if t.has(slot) else default
        elif kind == "u32":
            v = t.u32(slot) if t.has(slot) else default
        elif kind == "f32":
            v = t.f32(slot) if t.has(slot) else default
        elif kind == "bool":
            v = t.bool_(slot, default if default is not None else False)
        elif kind == "u8e":
            idx = t.u8(slot, default if default is not None else 0)
            v = enum[idx] if enum is not None else idx
        elif kind == "uvec":
            arr = t.vec_np(slot, NT.Uint32Flags)
            v = [int(x) for x in arr] if arr is not None else default
        elif kind == "ivec":
            arr = t.vec_np(slot, NT.Int32Flags)
            v = [int(x) for x in arr] if arr is not None else default
        elif kind == "str":
            v = t.string(slot)
        elif kind == "dtype":
            raw = t.u8(slot, None) if t.has(slot) else None
            v = FBS_DTYPES[raw] if raw is not None else default
        elif kind == "graph":
            sub = t.table(slot)
            v = load_graph(sub) if sub is not None else None
        else:  # pragma: no cover
            raise RtenFormatError(f"bad kind {kind}")
        if v is not None:
            attrs[attr_name] = v
    # rten pools store pads as [top,left,bottom,right] == ONNX begin/end order.
    return attrs


# --- reading ---------------------------------------------------------------

HEADER_FMT = "<4sI Q Q Q".replace(" ", "")
HEADER_LEN = struct.calcsize(HEADER_FMT)


def load_rten(data: bytes | memoryview) -> Tuple[Graph, Dict[str, str]]:
    """Parse a .rten file (V1 or V2) into an IR Graph + metadata dict."""
    _import_flatbuffers()
    buf = bytes(data) if not isinstance(data, (bytes, bytearray)) else data
    if len(buf) < 8:
        raise RtenFormatError("file too short")
    if buf[:4] == b"RTEN":
        magic, version, md_off, md_len, td_off = struct.unpack_from(HEADER_FMT, buf, 0)
        if version != 2:
            raise RtenFormatError(f"unsupported .rten version {version}")
        if md_off + md_len > len(buf) or td_off > len(buf):
            raise RtenFormatError("corrupt header offsets")
        model_buf = buf[md_off : md_off + md_len]
        tensor_data: Optional[memoryview] = memoryview(buf)[td_off:]
    else:
        # V1: the whole file is the flatbuffers model. rten-convert's V1
        # output carries NO file identifier (serialize_model calls
        # builder.Finish without one, converter.py:1392), so the only
        # V1 signature is "header magic absent + parseable buffer" —
        # the same fallback the reference loader uses.
        model_buf = buf
        tensor_data = None

    root_pos = struct.unpack_from("<I", model_buf, 0)[0]
    if root_pos + 4 > len(model_buf):
        raise RtenFormatError("not a .rten file (bad root offset)")
    model = FbTable(model_buf, root_pos)
    graph_t = model.table(1)
    if graph_t is None:
        raise RtenFormatError("model has no graph")

    meta: Dict[str, str] = {}
    meta_t = model.table(2)
    if meta_t is not None:
        for i, key in enumerate(
            ["onnx_hash", "description", "license", "commit", "code_repository",
             "model_repository", "run_id", "run_url"]
        ):
            v = meta_t.string(i)
            if v is not None:
                meta[key] = v

    graph = _load_graph(graph_t, tensor_data)
    return graph, meta


def _load_graph(gt: FbTable, tensor_data: Optional[memoryview]) -> Graph:
    g = Graph()
    n_nodes = gt.vec_len(0)
    idx_to_id: List[int] = []

    def load_subgraph(sub_t: FbTable) -> Graph:
        return _load_graph(sub_t, tensor_data)

    # First pass: create all nodes so operator edges can be resolved in a
    # second pass regardless of serialized order.
    node_tables = [gt.vec_table(0, i) for i in range(n_nodes)]
    kinds = []
    for nt_ in node_tables:
        name = nt_.string(0)
        kind = nt_.u8(1, 0)  # NodeKind union tag: 1 op, 2 const, 3 value
        data = nt_.table(2)
        kinds.append((name, kind, data))
        if kind == 2:  # ConstantNode
            idx_to_id.append(g.add_constant(name, _load_constant(data, tensor_data)))
        elif kind == 3:  # ValueNode
            dtype = None
            shape = None
            if data is not None:
                if data.has(1):
                    dtype = FBS_DTYPES[data.u8(1, 0)]
                ndims = data.vec_len(0)
                if ndims:
                    shape = []
                    for i in range(ndims):
                        dim = data.vec_table(0, i)
                        nm = dim.string(1)
                        shape.append(nm if nm else int(dim.u32(0, 0)))
            idx_to_id.append(g.add_value(name, dtype, shape))
        elif kind == 1:  # OperatorNode: placeholder, filled in pass 2
            idx_to_id.append(g.add_value(name))  # replaced below
        else:
            raise RtenFormatError(f"node '{name}' has unknown kind {kind}")

    # Second pass: operators.
    for i, (name, kind, data) in enumerate(kinds):
        if kind != 1:
            continue
        op_code = data.u8(0, 0)
        if op_code >= len(OPERATOR_TYPES):
            raise RtenFormatError(f"unknown OperatorType {op_code}")
        op_type = OPERATOR_TYPES[op_code]
        attrs_tag = data.u8(1, 0)
        attrs_t = data.table(2)
        if attrs_tag:
            attrs = _decode_attrs(ATTRS_UNION[attrs_tag - 1], attrs_t, load_subgraph)
        else:
            attrs = {}
        ins_arr = data.vec_np(3, NT.Int32Flags)
        outs_arr = data.vec_np(4, NT.Int32Flags)
        inputs = [
            (idx_to_id[x] if x >= 0 else None)
            for x in (ins_arr.tolist() if ins_arr is not None else [])
        ]
        outputs = []
        for x in (outs_arr.tolist() if outs_arr is not None else []):
            if x >= 0:
                outputs.append(idx_to_id[x])
            else:
                outputs.append(g.add_value(None))  # unused output
        nid = idx_to_id[i]
        # Replace the placeholder Value with the Operator under the same id.
        g.nodes[nid] = Operator(
            op_type=op_type, name=name, attrs=attrs,
            inputs=inputs, outputs=outputs,
        )

    inputs_arr = gt.vec_np(1, NT.Uint32Flags)
    outputs_arr = gt.vec_np(2, NT.Uint32Flags)
    captures_arr = gt.vec_np(3, NT.Uint32Flags)
    g.input_ids = [idx_to_id[int(x)] for x in (inputs_arr if inputs_arr is not None else [])]
    g.output_ids = [idx_to_id[int(x)] for x in (outputs_arr if outputs_arr is not None else [])]
    if captures_arr is not None:
        for x in captures_arr:
            g.captures.append(g.node_name(idx_to_id[int(x)]))
    return g


def _load_constant(ct: FbTable, tensor_data: Optional[memoryview]) -> np.ndarray:
    import math

    shape_arr = ct.vec_np(0, NT.Uint32Flags)
    shape = tuple(int(x) for x in shape_arr) if shape_arr is not None else ()
    # Python-int product: hostile 4B-element dims must not wrap through an
    # int64 np.prod into a small/negative byte count.
    n_elems = math.prod(shape) if shape else 1
    if ct.has(4):  # data_offset -> external tensor data section
        if tensor_data is None:
            raise RtenFormatError("constant references tensor data in a V1 file")
        if not ct.has(3):
            raise RtenFormatError("external constant missing dtype")
        dtype_code = ct.u16(3, 0)
        if not 0 <= dtype_code < len(FBS_CONST_DTYPES):
            raise RtenFormatError(f"unknown constant dtype {dtype_code}")
        np_dtype = FBS_CONST_DTYPES[dtype_code]
        offset = ct.u64(4, 0)
        nbytes = n_elems * np.dtype(np_dtype).itemsize
        if offset + nbytes > len(tensor_data):
            raise RtenFormatError(
                f"constant data [{offset}, {offset + nbytes}) exceeds tensor "
                f"data section ({len(tensor_data)} bytes)"
            )
        raw = tensor_data[offset : offset + nbytes]
        return np.frombuffer(raw, dtype=np_dtype).reshape(shape)
    # Inline data union: slot1 = tag (1 Float,2 Int32,3 Int8,4 UInt8), slot2 = table
    tag = ct.u8(1, 0)
    dt = ct.table(2)
    if dt is None:
        raise RtenFormatError("constant has no data")
    flags, np_dtype = {
        1: (NT.Float32Flags, np.float32),
        2: (NT.Int32Flags, np.int32),
        3: (NT.Int8Flags, np.int8),
        4: (NT.Uint8Flags, np.uint8),
    }[tag]
    arr = dt.vec_np(0, flags)
    if arr is None:
        arr = np.zeros(0, np_dtype)
    return np.asarray(arr, dtype=np_dtype).reshape(shape)


# --- writing ---------------------------------------------------------------

TENSOR_ALIGN = 64


def _narrow_for_rten(arr: np.ndarray) -> np.ndarray:
    """Map to the 4 supported dtypes (reference i64/bool->i32 policy)."""
    k = arr.dtype.kind
    if arr.dtype in (np.float32, np.int32, np.int8, np.uint8):
        return arr
    if k == "f":
        return arr.astype(np.float32)
    if k == "b":
        return arr.astype(np.int32)
    if k in "iu":
        if arr.dtype == np.uint8:
            return arr
        return arr.astype(np.int32)
    raise RtenFormatError(f"dtype {arr.dtype} not representable in .rten")


def save_rten(
    graph: Graph, path: str, metadata: Optional[Dict[str, str]] = None,
    v1: bool = False,
):
    """Write graph as a .rten file (rten-convert parity). V2 by default
    (header + external tensor-data section); ``v1`` writes the legacy
    bare-flatbuffers format with inline tensor data."""
    _import_flatbuffers()
    fb = flatbuffers

    tensor_blobs: List[bytes] = []
    cur = [0]

    def alloc_tensor(data: bytes) -> int:
        off = (cur[0] + TENSOR_ALIGN - 1) // TENSOR_ALIGN * TENSOR_ALIGN
        pad = off - cur[0]
        if pad:
            tensor_blobs.append(b"\0" * pad)
        tensor_blobs.append(data)
        cur[0] = off + len(data)
        return off

    b = fb.Builder(1024 * 1024)
    graph_off = _write_graph(b, graph, None if v1 else alloc_tensor)

    meta_off = None
    if metadata:
        keys = ["onnx_hash", "description", "license", "commit",
                "code_repository", "model_repository", "run_id", "run_url"]
        strs = {k: b.CreateString(metadata[k]) for k in keys if k in metadata}
        b.StartObject(8)
        for i, k in enumerate(keys):
            if k in strs:
                b.PrependUOffsetTRelativeSlot(i, strs[k], 0)
        meta_off = b.EndObject()

    # Model table: schema_version, graph, metadata
    b.StartObject(3)
    b.PrependInt32Slot(0, 1, 0)
    b.PrependUOffsetTRelativeSlot(1, graph_off, 0)
    if meta_off is not None:
        b.PrependUOffsetTRelativeSlot(2, meta_off, 0)
    model_off = b.EndObject()
    b.Finish(model_off, file_identifier=b"RTEN")
    model_data = bytes(b.Output())

    if v1:
        with open(path, "wb") as f:
            f.write(model_data)
        return
    md_off = HEADER_LEN
    md_len = len(model_data)
    td_off = (md_off + md_len + TENSOR_ALIGN - 1) // TENSOR_ALIGN * TENSOR_ALIGN
    header = struct.pack(HEADER_FMT, b"RTEN", 2, md_off, md_len, td_off)
    with open(path, "wb") as f:
        f.write(header)
        f.write(model_data)
        f.write(b"\0" * (td_off - md_off - md_len))
        for blob in tensor_blobs:
            f.write(blob)


def _op_constant_value(op: Operator) -> Optional[np.ndarray]:
    for key in ("value", "value_float", "value_int", "value_floats", "value_ints"):
        if key in op.attrs:
            return np.asarray(op.attrs[key])
    return None


def _write_graph(b, graph: Graph, alloc_tensor: Callable[[bytes], int]) -> int:
    # ONNX `Constant` operators become constant NODES (rten-convert does the
    # same; the schema has no Constant operator).
    const_outputs: Dict[int, np.ndarray] = {}
    skip_ops = set()
    for nid, node in graph.nodes.items():
        if isinstance(node, Operator) and node.op_type == "Constant":
            val = _op_constant_value(node)
            if val is None:
                raise RtenFormatError("Constant op without a value attr")
            const_outputs[node.outputs[0]] = val
            skip_ops.add(nid)

    # Emit values+constants first, then operators (referents precede
    # referrers, required by the reference loader: schema.fbs:744-747).
    order: List[int] = []
    for nid, node in graph.nodes.items():
        if not isinstance(node, Operator):
            order.append(nid)
    for nid, node in graph.nodes.items():
        if isinstance(node, Operator) and nid not in skip_ops:
            order.append(nid)
    id_to_idx = {nid: i for i, nid in enumerate(order)}

    node_offsets = []
    for nid in order:
        node = graph.nodes[nid]
        if nid in const_outputs:
            node = Constant(name=getattr(node, "name", None), array=const_outputs[nid])
        name = getattr(node, "name", None)
        name_off = b.CreateString(name) if name else None
        if isinstance(node, Constant):
            kind_tag, data_off = 2, _write_constant(b, node.array, alloc_tensor)
        elif isinstance(node, Value):
            kind_tag, data_off = 3, _write_value(b, node)
        else:
            kind_tag, data_off = 1, _write_operator(b, graph, node, id_to_idx, alloc_tensor)
        b.StartObject(3)
        if name_off is not None:
            b.PrependUOffsetTRelativeSlot(0, name_off, 0)
        b.PrependUint8Slot(1, kind_tag, 0)
        b.PrependUOffsetTRelativeSlot(2, data_off, 0)
        node_offsets.append(b.EndObject())

    nodes_vec = _write_offset_vec(b, node_offsets)
    inputs_vec = _write_u32_vec(b, [id_to_idx[i] for i in graph.input_ids])
    outputs_vec = _write_u32_vec(b, [id_to_idx[i] for i in graph.output_ids])
    cap_ids = []
    for cname in graph.captures:
        cid = graph.find_node(cname)
        if cid is not None and cid in id_to_idx:
            cap_ids.append(id_to_idx[cid])
    captures_vec = _write_u32_vec(b, cap_ids) if cap_ids else None

    b.StartObject(4)
    b.PrependUOffsetTRelativeSlot(0, nodes_vec, 0)
    b.PrependUOffsetTRelativeSlot(1, inputs_vec, 0)
    b.PrependUOffsetTRelativeSlot(2, outputs_vec, 0)
    if captures_vec is not None:
        b.PrependUOffsetTRelativeSlot(3, captures_vec, 0)
    return b.EndObject()


def _write_offset_vec(b, offsets: List[int]) -> int:
    b.StartVector(4, len(offsets), 4)
    for off in reversed(offsets):
        b.PrependUOffsetTRelative(off)
    return b.EndVector()


def _write_u32_vec(b, vals: List[int]) -> int:
    b.StartVector(4, len(vals), 4)
    for v in reversed(vals):
        b.PrependUint32(int(v))
    return b.EndVector()


def _write_i32_vec(b, vals: List[int]) -> int:
    b.StartVector(4, len(vals), 4)
    for v in reversed(vals):
        b.PrependInt32(int(v))
    return b.EndVector()


def _write_constant(b, arr: np.ndarray, alloc_tensor) -> int:
    arr = _narrow_for_rten(np.ascontiguousarray(arr))
    shape_vec = _write_u32_vec(b, list(arr.shape))
    cdtype = {
        np.dtype(np.int32): 0, np.dtype(np.float32): 1,
        np.dtype(np.int8): 2, np.dtype(np.uint8): 3,
    }[arr.dtype]
    if alloc_tensor is not None:  # V2: external tensor-data section
        offset = alloc_tensor(arr.tobytes())
        b.StartObject(5)
        b.PrependUOffsetTRelativeSlot(0, shape_vec, 0)
        b.PrependUint16Slot(3, cdtype, None)
        b.PrependUint64Slot(4, offset, None)
        return b.EndObject()
    # V1: inline ConstantData union.
    flat = arr.reshape(-1)
    tag = {0: 2, 1: 1, 2: 3, 3: 4}[cdtype]  # ConstantData member index
    elem = arr.dtype.itemsize
    b.StartVector(elem, flat.size, elem)
    # Prepend raw little-endian bytes in one shot (head moves backwards).
    b.head = b.head - flat.nbytes
    b.Bytes[b.head : b.head + flat.nbytes] = flat.tobytes()
    data_vec = b.EndVector()
    b.StartObject(1)
    b.PrependUOffsetTRelativeSlot(0, data_vec, 0)
    data_off = b.EndObject()
    b.StartObject(5)
    b.PrependUOffsetTRelativeSlot(0, shape_vec, 0)
    b.PrependUint8Slot(1, tag, 0)
    b.PrependUOffsetTRelativeSlot(2, data_off, 0)
    b.PrependUint16Slot(3, cdtype, None)
    return b.EndObject()


def _write_value(b, node: Value) -> int:
    dim_offsets = []
    if node.shape is not None:
        for d in node.shape:
            name_off = b.CreateString(d) if isinstance(d, str) else None
            b.StartObject(2)
            if isinstance(d, int):
                b.PrependUint32Slot(0, d, 0)
            elif name_off is not None:
                b.PrependUOffsetTRelativeSlot(1, name_off, 0)
            # None (fully unknown) -> Dim with neither field; loader sees 0.
            dim_offsets.append(b.EndObject())
    shape_vec = _write_offset_vec(b, dim_offsets) if dim_offsets else None
    b.StartObject(2)
    if shape_vec is not None:
        b.PrependUOffsetTRelativeSlot(0, shape_vec, 0)
    if node.dtype is not None and node.dtype in FBS_DTYPES:
        b.PrependUint8Slot(1, FBS_DTYPES.index(node.dtype), None)
    return b.EndObject()


def _encode_attrs(b, table_name: str, attrs: Dict[str, Any], alloc_tensor) -> Optional[int]:
    if table_name == "ConstantOfShapeAttrs":
        value = attrs.get("value")
        if value is None:
            value = np.zeros(1, np.float32)
        value = np.asarray(value).reshape(-1)
        if value.dtype.kind == "f":
            b.StartObject(1)
            b.PrependFloat32Slot(0, float(value[0]), 0.0)
            sc_off, sc_tag = b.EndObject(), 2
        else:
            b.StartObject(1)
            b.PrependInt32Slot(0, int(value[0]), 0)
            sc_off, sc_tag = b.EndObject(), 1
        b.StartObject(2)
        b.PrependUint8Slot(0, sc_tag, 0)
        b.PrependUOffsetTRelativeSlot(1, sc_off, 0)
        return b.EndObject()

    spec = SPECS[table_name]
    write_defaults = ONNX_WRITE_DEFAULTS.get(table_name)
    if write_defaults:
        attrs = {**write_defaults, **attrs}
    # Pre-build offset-typed fields.
    prebuilt: Dict[int, int] = {}
    for slot, (attr_name, kind, default, enum) in enumerate(spec):
        v = attrs.get(attr_name)
        if v is None:
            continue
        if kind == "uvec":
            prebuilt[slot] = _write_u32_vec(b, [int(x) for x in v])
        elif kind == "ivec":
            prebuilt[slot] = _write_i32_vec(b, [int(x) for x in v])
        elif kind == "str":
            prebuilt[slot] = b.CreateString(v)
        elif kind == "graph":
            prebuilt[slot] = _write_graph(b, v, alloc_tensor)

    b.StartObject(len(spec))
    for slot, (attr_name, kind, default, enum) in enumerate(spec):
        v = attrs.get(attr_name)
        if attr_name == "auto_pad" and v is None:
            # Schema default is Same (backwards compat); ONNX default is
            # NOTSET — always write it out (rten-convert sets Fixed too,
            # schema.fbs:169-172).
            v = "NOTSET"
        if slot in prebuilt:
            b.PrependUOffsetTRelativeSlot(slot, prebuilt[slot], 0)
            continue
        if v is None:
            continue
        if kind == "i32":
            b.PrependInt32Slot(slot, int(v), None)
        elif kind == "u32":
            b.PrependUint32Slot(slot, int(v), None)
        elif kind == "f32":
            b.PrependFloat32Slot(slot, float(v), None)
        elif kind == "bool":
            b.PrependBoolSlot(slot, bool(v), None)
        elif kind == "u8e":
            if enum is not None:
                if isinstance(v, (bytes, str)):
                    sv = v.decode() if isinstance(v, bytes) else v
                    # tolerate ONNX caps e.g. SAME_UPPER/NOTSET already mapped
                    idx = enum.index(sv) if sv in enum else 0
                else:
                    idx = int(v)
            else:
                idx = int(v)
            b.PrependUint8Slot(slot, idx, None)
        elif kind == "dtype":
            if isinstance(v, DataType) and v in FBS_DTYPES:
                b.PrependUint8Slot(slot, FBS_DTYPES.index(v), None)
    return b.EndObject()


def _write_operator(b, graph: Graph, op: Operator, id_to_idx, alloc_tensor) -> int:
    if op.op_type not in OP_TYPE_INDEX:
        raise RtenFormatError(
            f"operator {op.op_type} has no .rten encoding (rten schema has "
            f"no contrib ops; save as .rtpu instead)"
        )
    attrs_table = OP_TO_ATTRS.get(op.op_type)
    attrs_off = attrs_tag = None
    if attrs_table is not None:
        attrs_off = _encode_attrs(b, attrs_table, op.attrs, alloc_tensor)
        attrs_tag = ATTRS_UNION_INDEX[attrs_table]
    ins_vec = _write_i32_vec(
        b, [(id_to_idx[i] if i is not None else -1) for i in op.inputs]
    )
    outs_vec = _write_i32_vec(b, [id_to_idx[o] for o in op.outputs])
    b.StartObject(5)
    b.PrependUint8Slot(0, OP_TYPE_INDEX[op.op_type], 0)
    if attrs_off is not None:
        b.PrependUint8Slot(1, attrs_tag, 0)
        b.PrependUOffsetTRelativeSlot(2, attrs_off, 0)
    b.PrependUOffsetTRelativeSlot(3, ins_vec, 0)
    b.PrependUOffsetTRelativeSlot(4, outs_vec, 0)
    return b.EndObject()
