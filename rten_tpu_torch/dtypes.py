"""Data types supported by the engine (the port of ``rten_tpu/dtypes.py``).

The runtime supports a small closed set of element types; wider types
arriving from outside are narrowed at the boundary (i64 -> i32,
f64 -> f32), as in the reference (rten `src/value.rs:20`,
`src/lib.rs:83-88`). ``DataType.torch_dtype`` and ``DataType.from_torch``
map the set onto ``torch.dtype``.
"""

from __future__ import annotations

import enum

import numpy as np
import torch


class DataType(enum.Enum):
    """Engine-native tensor element types."""

    Float = "float32"
    BFloat16 = "bfloat16"
    Int32 = "int32"
    Int8 = "int8"
    UInt8 = "uint8"
    Bool = "bool"

    @property
    def np_dtype(self) -> np.dtype:
        if self is DataType.BFloat16:
            import ml_dtypes

            return np.dtype(ml_dtypes.bfloat16)
        return np.dtype(self.value)

    @property
    def torch_dtype(self) -> torch.dtype:
        return _TO_TORCH[self]

    @classmethod
    def from_np(cls, dtype) -> "DataType":
        dtype = np.dtype(dtype)
        name = dtype.name
        if name in _NARROWING:
            name = _NARROWING[name]
        for dt in cls:
            if dt.value == name:
                return dt
        raise ValueError(f"unsupported dtype {dtype}")

    @classmethod
    def from_torch(cls, dtype: torch.dtype) -> "DataType":
        for dt, tdt in _TO_TORCH.items():
            if tdt == dtype:
                return dt
        raise ValueError(f"unsupported dtype {dtype}")


_TO_TORCH = {
    DataType.Float: torch.float32,
    DataType.BFloat16: torch.bfloat16,
    DataType.Int32: torch.int32,
    DataType.Int8: torch.int8,
    DataType.UInt8: torch.uint8,
    DataType.Bool: torch.bool,
}

# Boundary narrowing policy (reference: rten src/lib.rs:83-88).
_NARROWING = {
    "float64": "float32",
    "int64": "int32",
    "int16": "int32",
    "uint16": "int32",
    "uint32": "int32",
    "uint64": "int32",
    "float16": "float32",
}


def narrow_array(arr: np.ndarray) -> np.ndarray:
    """Apply the boundary narrowing policy to a numpy array.

    i64 values outside i32 range are clamped (clamping keeps INT64_MIN/MAX
    sentinel values meaningful after narrowing).
    """
    name = arr.dtype.name
    if name not in _NARROWING:
        return arr
    target = _NARROWING[name]
    if target == "int32" and arr.dtype.itemsize > 4:
        arr = np.clip(arr, np.iinfo(np.int32).min, np.iinfo(np.int32).max)
    return arr.astype(target)
