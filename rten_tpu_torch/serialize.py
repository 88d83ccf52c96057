"""Tensor files in numpy (the port of ``rten_tpu/serialize.py``): .npy,
.npz and safetensors, read and write. safetensors is an 8-byte
little-endian header length, a JSON header, then the raw little-endian
buffers. Used by the Generator's saved state, the ``.rtpu`` model format and
the CLI's ``--inputs``/``--check-outputs``/``--save-outputs``. bfloat16,
which numpy has no type for, needs ``ml_dtypes`` (imported only for a BF16
tensor).
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Union

import numpy as np

_ST_DTYPES = {
    "F64": np.dtype("<f8"),
    "F32": np.dtype("<f4"),
    "F16": np.dtype("<f2"),
    "I64": np.dtype("<i8"),
    "I32": np.dtype("<i4"),
    "I16": np.dtype("<i2"),
    "I8": np.dtype("i1"),
    "U8": np.dtype("u1"),
    "U16": np.dtype("<u2"),
    "U32": np.dtype("<u4"),
    "U64": np.dtype("<u8"),
    "BOOL": np.dtype("bool"),
}
_NP_TO_ST = {dt.name: name for name, dt in _ST_DTYPES.items()}
_NP_TO_ST["bfloat16"] = "BF16"


def read_safetensors(path: Union[str, os.PathLike]) -> Dict[str, np.ndarray]:
    """name -> array; the arrays are views over one read-only memory map."""
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    (header_len,) = struct.unpack("<Q", bytes(mm[:8]))
    header = json.loads(bytes(mm[8 : 8 + header_len]))
    data_start = 8 + header_len
    out: Dict[str, np.ndarray] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] == "BF16":
            import ml_dtypes

            dt = np.dtype(ml_dtypes.bfloat16)
        else:
            dt = _ST_DTYPES.get(info["dtype"])
        if dt is None:
            raise ValueError(f"unsupported safetensors dtype {info['dtype']}")
        start, end = info["data_offsets"]
        raw = mm[data_start + start : data_start + end]
        out[name] = np.frombuffer(raw, dtype=dt).reshape(info["shape"])
    return out


def write_safetensors(
    path: Union[str, os.PathLike],
    tensors: Dict[str, np.ndarray],
    metadata: Dict[str, str] = None,
) -> None:
    header = {}
    offset = 0
    blobs = []
    for name, arr in tensors.items():
        # np.ascontiguousarray makes a 0-d array 1-d; the header keeps the
        # tensor's own shape.
        arr = np.ascontiguousarray(arr).reshape(np.shape(arr))
        if arr.dtype.byteorder == ">":
            arr = arr.astype(arr.dtype.newbyteorder("<"))
        st_dtype = _NP_TO_ST.get(arr.dtype.name)
        if st_dtype is None:
            raise ValueError(f"unsupported dtype for safetensors: {arr.dtype.name}")
        raw = arr.tobytes()
        header[name] = {
            "dtype": st_dtype,
            "shape": list(arr.shape),
            "data_offsets": [offset, offset + len(raw)],
        }
        offset += len(raw)
        blobs.append(raw)
    if metadata:
        header["__metadata__"] = metadata
    hjson = json.dumps(header).encode("utf-8")
    hjson += b" " * ((-(8 + len(hjson))) % 8)  # 8-byte alignment of the data
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for raw in blobs:
            f.write(raw)


def read_tensors(path: Union[str, os.PathLike]) -> Dict[str, np.ndarray]:
    """Sniff .npy/.npz/.safetensors by magic and load; a .npy holds one
    tensor, named "0"."""
    path = os.fspath(path)
    with open(path, "rb") as f:
        magic = f.read(8)
    if magic[:6] == b"\x93NUMPY":
        return {"0": np.load(path)}
    if magic[:2] == b"PK":
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    return read_safetensors(path)


def write_tensors(path: Union[str, os.PathLike], tensors: Dict[str, np.ndarray]):
    """.npy (one tensor), .npz, or safetensors for any other extension."""
    path = os.fspath(path)
    if path.endswith(".npy"):
        if len(tensors) != 1:
            raise ValueError(".npy holds exactly one tensor")
        np.save(path, next(iter(tensors.values())))
    elif path.endswith(".npz"):
        np.savez(path, **tensors)
    else:
        write_safetensors(path, tensors)
