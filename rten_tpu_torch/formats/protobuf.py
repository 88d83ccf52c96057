"""Minimal protobuf wire-format reader (a copy of
``rten_tpu/formats/protobuf.py``).

Hand-rolled for zero dependencies, mirroring the reference's choice to parse
ONNX protobuf itself (rten-onnx/src/protobuf/). Works over ``memoryview`` so
large embedded tensors (raw_data) are zero-copy slices of the input buffer.

Wire types: 0 = varint, 1 = 64-bit, 2 = length-delimited, 5 = 32-bit.
"""

from __future__ import annotations

import struct
from typing import Iterator, Tuple, Union


class ProtobufError(Exception):
    pass


def read_varint(buf, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise ProtobufError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift > 63:
            raise ProtobufError("varint too long")


def zigzag(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def signed64(v: int) -> int:
    """Interpret a varint as a two's-complement int64 (proto int64 fields)."""
    return v - (1 << 64) if v >= (1 << 63) else v


FieldValue = Union[int, memoryview]


def fields(buf: memoryview) -> Iterator[Tuple[int, int, FieldValue]]:
    """Yield (field_number, wire_type, value) for each field in ``buf``.

    Length-delimited values are memoryview slices; varints are ints;
    fixed32/fixed64 are returned as raw little-endian ints.
    """
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = read_varint(buf, pos)
        field = tag >> 3
        wire = tag & 7
        if wire == 0:
            val, pos = read_varint(buf, pos)
        elif wire == 1:
            if pos + 8 > n:
                raise ProtobufError("truncated fixed64")
            val = int.from_bytes(buf[pos : pos + 8], "little")
            pos += 8
        elif wire == 2:
            ln, pos = read_varint(buf, pos)
            if pos + ln > n:
                raise ProtobufError("truncated bytes field")
            val = buf[pos : pos + ln]
            pos += ln
        elif wire == 5:
            if pos + 4 > n:
                raise ProtobufError("truncated fixed32")
            val = int.from_bytes(buf[pos : pos + 4], "little")
            pos += 4
        else:
            raise ProtobufError(f"unsupported wire type {wire}")
        yield field, wire, val


def as_f32(fixed32: int) -> float:
    return struct.unpack("<f", fixed32.to_bytes(4, "little"))[0]


def as_f64(fixed64: int) -> float:
    return struct.unpack("<d", fixed64.to_bytes(8, "little"))[0]


def packed_varints(buf: memoryview) -> list:
    out = []
    pos = 0
    while pos < len(buf):
        v, pos = read_varint(buf, pos)
        out.append(signed64(v))
    return out
