"""QuantizeLinear, DequantizeLinear and DynamicQuantizeLinear (the port of
``rten_tpu/ops/quantize.py``). Scales and zero points are per tensor, per
axis or blockwise (``block_size``); rounding is half to even.

DynamicQuantizeLinear (``quantize.py:75-96``):

One per-tensor u8 scale and zero point over the whole activation, rows of
idle serving slots included; rounding is half-to-even (``torch.round``),
as in ONNX and the JAX package. Same arithmetic, in the same order, as the
JAX package's compiled graph, so the u8 output, scale and zero point are
bit-exact for the same input. XLA compiles the division by the constant
255 into a multiply by its f32 reciprocal; the port writes that multiply
out (a true division differs by an ulp in about three scales of four).
"""

from __future__ import annotations

import numpy as np
import torch

from .registry import as_tensor, get_input, opt_input, register


_INV_QRANGE = float(np.float32(1.0) / np.float32(255.0))  # exact in f32


def dynamic_quantize(x: torch.Tensor, bounds=None):
    """Per-tensor u8 dynamic quantization (ONNX DynamicQuantizeLinear).

    Returns (y u8, scale f32 0-d, zero_point u8 0-d), all on x's device.
    ``bounds``: the (min, max) of the whole tensor where ``x`` is one
    rank's shard of it (``ops/collective.py``); x's own by default.
    """
    qmin, qmax = 0.0, 255.0
    lo, hi = torch.aminmax(x) if bounds is None else bounds
    x_min = torch.clamp(lo, max=0.0)
    x_max = torch.clamp(hi, min=0.0)
    scale = (x_max - x_min) * _INV_QRANGE
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    zp_fp = qmin - x_min / scale
    zp = torch.clamp(torch.round(zp_fp), qmin, qmax).to(torch.uint8)
    y = torch.clamp(torch.round(x / scale) + zp.to(torch.int32), qmin, qmax).to(torch.uint8)
    return y, scale.to(torch.float32), zp


@register("DynamicQuantizeLinear")
def _dynamic_quantize_linear(ctx, inputs, attrs):
    return dynamic_quantize(as_tensor(ctx, get_input(inputs, 0)))


def _qparam(p: torch.Tensor, x_shape, axis: int, block_size: int) -> torch.Tensor:
    """A scale or zero point shaped to broadcast over x: a scalar, a vector
    along ``axis``, or blocks of ``block_size`` along it."""
    if p.ndim == 0 or p.numel() == 1:
        return p.reshape(())
    if block_size:
        p = torch.repeat_interleave(p, block_size, dim=axis)
        return p.narrow(axis, 0, x_shape[axis])
    shape = [1] * len(x_shape)
    shape[axis] = p.numel()
    return p.reshape(shape)


_INT_RANGE = {torch.uint8: (0, 255), torch.int8: (-128, 127), torch.int32: (-2**31, 2**31 - 1)}


@register("QuantizeLinear")
def _quantize_linear(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    scale = as_tensor(ctx, get_input(inputs, 1, "scale"))
    zp = opt_input(inputs, 2)
    axis = attrs.get("axis", 1)
    if axis < 0:
        axis += x.ndim
    block_size = attrs.get("block_size", 0)
    s = _qparam(scale, x.shape, axis, block_size)
    out_dtype = torch.uint8
    q = torch.round(x / s)
    if zp is not None:
        zp = as_tensor(ctx, zp)
        out_dtype = zp.dtype
        q = q + _qparam(zp, x.shape, axis, block_size).to(torch.int32)
    lo, hi = _INT_RANGE[out_dtype]
    return torch.clamp(q, lo, hi).to(out_dtype)


@register("DequantizeLinear")
def _dequantize_linear(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    scale = as_tensor(ctx, get_input(inputs, 1, "scale"))
    zp = opt_input(inputs, 2)
    axis = attrs.get("axis", 1)
    if axis < 0:
        axis += x.ndim
    block_size = attrs.get("block_size", 0)
    s = _qparam(scale, x.shape, axis, block_size)
    xi = x.to(torch.int32)
    if zp is not None:
        xi = xi - _qparam(as_tensor(ctx, zp), x.shape, axis, block_size).to(torch.int32)
    return xi.to(s.dtype) * s
