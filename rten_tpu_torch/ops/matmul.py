"""MatMul family (the port of ``rten_tpu/ops/matmul.py``): MatMul,
MatMulAdd, MatMulIntegerToFloat and MatMulNBits.

* MatMul / MatMulAdd: the JAX package leaves f32 products to XLA at HIGHEST
  precision; here they are ``torch.matmul`` in full f32 (TF32 is off for
  matmuls unless a caller turns it on).
* MatMulIntegerToFloat (``matmul.py:132-178``), inputs (a, b, a_scale,
  b_scale, a_zero_point, b_zero_point, bias, b_colsums): routed to the int8
  kernel (``rten_tpu_torch/kernels/int8_matmul.py``), sliced back to the
  logical width ``rten_orig_n`` when the prepack padded N, then the bias is
  added.
* MatMulNBits (``matmul.py:181-232``), inputs (a, packed nibbles
  [N, nb, bs/2], scales, zero points): routed to the int4 kernel
  (``rten_tpu_torch/kernels/int4_matmul.py``, where ``dequant_nbits``
  is the reference's dequantization).
"""

from __future__ import annotations

import torch

from ..kernels.int4_matmul import int4_matmul
from ..kernels.int8_matmul import int8_matmul_dequant
from .registry import OpError, as_tensor, get_input, opt_input, register


@register("MatMul")
def _matmul(ctx, inputs, attrs):
    a = as_tensor(ctx, get_input(inputs, 0, "a"))
    return torch.matmul(a, as_tensor(ctx, get_input(inputs, 1, "b")))


@register("MatMulAdd")
def _matmul_add(ctx, inputs, attrs):
    """Optimizer-produced MatMul + bias (rten fusions MatMulAdd)."""
    a = as_tensor(ctx, get_input(inputs, 0, "a"))
    b = as_tensor(ctx, get_input(inputs, 1, "b"))
    bias = as_tensor(ctx, get_input(inputs, 2, "bias"))
    return torch.matmul(a, b) + bias


@register("MatMulIntegerToFloat")
def _matmul_integer_to_float(ctx, inputs, attrs):
    a = as_tensor(ctx, get_input(inputs, 0, "a"))
    b = as_tensor(ctx, get_input(inputs, 1, "b"))
    a_scale = as_tensor(ctx, get_input(inputs, 2, "a_scale"))
    b_scale = as_tensor(ctx, get_input(inputs, 3, "b_scale"))
    a_zp = opt_input(inputs, 4)
    b_zp = opt_input(inputs, 5)
    bias = opt_input(inputs, 6)
    b_colsums = opt_input(inputs, 7)
    orig_n = attrs.get("rten_orig_n")
    if b.ndim != 2:
        raise NotImplementedError(
            "batched MatMulIntegerToFloat weights: ROADMAP.md queue 1 item 12"
        )
    lead = a.shape[:-1]
    a2 = a.reshape(-1, a.shape[-1])
    out = int8_matmul_dequant(
        a2, b, a_scale, b_scale,
        None if a_zp is None else as_tensor(ctx, a_zp),
        None if b_zp is None else as_tensor(ctx, b_zp),
        None if b_colsums is None else as_tensor(ctx, b_colsums),
    ).reshape(*lead, b.shape[-1])
    if orig_n is not None and out.shape[-1] != orig_n:
        out = out[..., :orig_n]
    if bias is not None:
        out = out + as_tensor(ctx, bias)
    return out


@register("MatMulNBits")
def _matmul_nbits(ctx, inputs, attrs):
    """int4 block-quantized matmul (MS contrib op; rten
    ``src/ops/matmul/contrib.rs:123``): weights [N, K/block, block/2]
    packed nibbles, per-block scales, optional zero points."""
    a = as_tensor(ctx, get_input(inputs, 0, "a"))
    b_packed = as_tensor(ctx, get_input(inputs, 1, "b"))
    scales = as_tensor(ctx, get_input(inputs, 2, "scales"))
    zero_points = opt_input(inputs, 3)
    bits = attrs.get("bits", 4)
    if bits != 4:
        raise OpError(f"MatMulNBits: only bits=4 supported (got {bits})")
    return int4_matmul(
        a, b_packed, scales, None if zero_points is None else as_tensor(ctx, zero_points),
        K=attrs["K"], N=attrs["N"], block_size=attrs.get("block_size", 32),
    )

