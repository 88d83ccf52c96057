"""DynamicQuantizeLinear (the port of ``rten_tpu/ops/quantize.py:75-96``).

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

from .registry import as_tensor, get_input, register


_INV_QRANGE = float(np.float32(1.0) / np.float32(255.0))  # exact in f32


def dynamic_quantize(x: torch.Tensor):
    """Per-tensor u8 dynamic quantization (ONNX DynamicQuantizeLinear).

    Returns (y u8, scale f32 0-d, zero_point u8 0-d), all on x's device.
    """
    qmin, qmax = 0.0, 255.0
    lo, hi = torch.aminmax(x)
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
