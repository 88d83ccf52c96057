"""MatMul family (the port of ``rten_tpu/ops/matmul.py``): MatMul,
MatMulAdd, FusedMatMul, Gemm, MatMulInteger, MatMulIntegerToFloat and
MatMulNBits.

* MatMul / MatMulAdd / FusedMatMul / Gemm: the JAX package leaves f32
  products to XLA at HIGHEST precision; here they are ``torch.matmul`` in
  full f32 (TF32 is off for matmuls unless a caller turns it on). Under
  ``RunConfig.prefer_bf16`` (the JAX package's DEFAULT precision) f32
  operands on the card take one bf16 pass, widened back to f32 (``contract``,
  the precision rule Conv and Einsum share).
* MatMulInteger (``matmul.py:71-129``): the zero-point-corrected integer
  product in int32. cuBLAS has no int32 matmul, so the product is taken in
  f64, which holds every u8/s8 product sum below 2^53 exactly, on both
  devices.
* MatMulIntegerToFloat (``matmul.py:132-178``), inputs (a, b, a_scale,
  b_scale, a_zero_point, b_zero_point, bias, b_colsums): a 2-D weight is
  routed to the int8 kernel (``rten_tpu_torch/kernels/int8_matmul.py``),
  sliced back to the logical width ``rten_orig_n`` when the prepack padded
  N, then the bias is added; a batched weight takes the JAX package's own
  non-kernel route, the exact integer product times the scales. With the
  attribute ``rten_int32_out`` (set only by the tensor-parallel partition,
  ``rten_tpu_torch/parallel/partition.py``, on a row-parallel product) the
  op returns the zero-point-corrected int32 accumulator, the kernel's int32
  mode: scales and bias are applied after the all-reduce.
* MatMulNBits (``matmul.py:181-232``), inputs (a, packed nibbles
  [N, nb, bs/2], scales, zero points): routed to the int4 kernel
  (``rten_tpu_torch/kernels/int4_matmul.py``, where ``dequant_nbits``
  is the reference's dequantization).
"""

from __future__ import annotations

import torch

from ..kernels.int4_matmul import int4_matmul, unpack_zero_points
from ..kernels.int8_matmul import int8_matmul_dequant
from .registry import OpError, as_tensor, get_input, opt_input, register


def contract(ctx, fn, *args: torch.Tensor, full=torch.float64, honour_bf16: bool = True):
    """``fn(*args)``, a float contraction, under the port's one precision
    rule. f32 operands on the card take one bf16 pass under
    ``RunConfig.prefer_bf16`` where the JAX op honours it (``honour_bf16``),
    else run in ``full``: f64 gives full f32 products whatever the TF32
    flags, and f32 suits cuBLAS matmuls, whose TF32 flag is off unless a
    caller turns it on. A result in another dtype is rounded back to f32.
    Anything else (the CPU, other dtypes) runs as it is."""
    if args[0].device.type != "cuda" or any(a.dtype != torch.float32 for a in args):
        return fn(*args)
    run = torch.bfloat16 if honour_bf16 and ctx is not None and ctx.config.prefer_bf16 else full
    if run == torch.float32:
        return fn(*args)
    return fn(*(a.to(run) for a in args)).to(torch.float32)


def _mm(ctx, a, b):
    return contract(ctx, torch.matmul, a, b, full=torch.float32)


@register("MatMul")
def _matmul(ctx, inputs, attrs):
    a = as_tensor(ctx, get_input(inputs, 0, "a"))
    return _mm(ctx, a, as_tensor(ctx, get_input(inputs, 1, "b")))


@register("MatMulAdd")
def _matmul_add(ctx, inputs, attrs):
    """Optimizer-produced MatMul + bias (rten fusions MatMulAdd)."""
    a = as_tensor(ctx, get_input(inputs, 0, "a"))
    b = as_tensor(ctx, get_input(inputs, 1, "b"))
    bias = as_tensor(ctx, get_input(inputs, 2, "bias"))
    return _mm(ctx, a, b) + bias


@register("FusedMatMul")
def _fused_matmul(ctx, inputs, attrs):
    """Optimizer-produced MatMul with a folded scalar multiplier (rten
    src/ops/matmul.rs:457 FusedMatMul{alpha})."""
    a = as_tensor(ctx, get_input(inputs, 0, "a"))
    b = as_tensor(ctx, get_input(inputs, 1, "b"))
    return _mm(ctx, a, b) * attrs.get("alpha", 1.0)


@register("Gemm")
def _gemm(ctx, inputs, attrs):
    a = as_tensor(ctx, get_input(inputs, 0, "a"))
    b = as_tensor(ctx, get_input(inputs, 1, "b"))
    c = opt_input(inputs, 2)
    alpha = attrs.get("alpha", 1.0)
    beta = attrs.get("beta", 1.0)
    if attrs.get("transA", 0):
        a = a.transpose(-1, -2)
    if attrs.get("transB", 0):
        b = b.transpose(-1, -2)
    out = _mm(ctx, a, b)
    if alpha != 1.0:
        out = out * alpha
    if c is not None and beta != 0.0:
        out = out + beta * as_tensor(ctx, c)
    return out


def int_matmul(a, b, a_zp=None, b_zp=None, b_colsums=None) -> torch.Tensor:
    """(A - zp_a) . (B - zp_b) in int32, in the JAX package's expanded form
    ``A.B - zp_a * colsums(B) - zp_b * rowsums(A) + K * zp_a * zp_b``; a
    per-row ``zp_a`` is a vector over A's rows. The products are exact."""
    k = a.shape[-1]
    prod = torch.matmul(a.to(torch.float64), b.to(torch.float64)).round().to(torch.int32)
    a32 = a.to(torch.int32)
    azp = bzp = None
    if a_zp is not None:
        azp = a_zp.to(torch.int32)
        if azp.ndim == 1:
            azp = azp[:, None]
        col_sums = (b_colsums.to(torch.int32).reshape(1, b.shape[-1]) if b_colsums is not None
                    else b.to(torch.int32).sum(dim=-2, keepdim=True, dtype=torch.int32))
        prod = prod - azp * col_sums
    if b_zp is not None:
        bzp = b_zp.to(torch.int32)
        prod = prod - a32.sum(dim=-1, keepdim=True, dtype=torch.int32) * bzp
    if azp is not None and bzp is not None:
        prod = prod + k * azp * bzp
    return prod


@register("MatMulInteger")
def _matmul_integer(ctx, inputs, attrs):
    a = as_tensor(ctx, get_input(inputs, 0, "a"))
    b = as_tensor(ctx, get_input(inputs, 1, "b"))
    a_zp, b_zp = (None if opt_input(inputs, i) is None else as_tensor(ctx, inputs[i])
                  for i in (2, 3))
    return int_matmul(a, b, a_zp, b_zp)


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
    a_zp, b_zp, b_colsums = (None if v is None else as_tensor(ctx, v)
                             for v in (a_zp, b_zp, b_colsums))
    if attrs.get("rten_int32_out"):
        if b.ndim != 2:
            out = int_matmul(a, b, a_zp, b_zp, b_colsums)
        else:
            lead = a.shape[:-1]
            out = int8_matmul_dequant(
                a.reshape(-1, a.shape[-1]), b, a_scale, b_scale, a_zp, b_zp, b_colsums,
                out_int32=True,
            ).reshape(*lead, b.shape[-1])
        return out if orig_n is None else out[..., :orig_n]
    if b.ndim != 2:
        out = int_matmul(a, b, a_zp, b_zp, b_colsums).to(torch.float32) * (
            a_scale.to(torch.float32) * b_scale.to(torch.float32))
    else:
        lead = a.shape[:-1]
        out = int8_matmul_dequant(
            a.reshape(-1, a.shape[-1]), b, a_scale, b_scale, a_zp, b_zp, b_colsums,
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
    K, N, bs = attrs["K"], attrs["N"], attrs.get("block_size", 32)
    if zero_points is not None:
        # u8 zero points unpacked to int32 [N, nb] once a weight (six small
        # ops a call otherwise, on every decode step).
        zp = as_tensor(ctx, zero_points)
        zero_points = ctx.executor.derived_weight(
            zp, "zero_points", lambda: unpack_zero_points(zp, N, -(-K // bs)))
    return int4_matmul(a, b_packed, scales, zero_points, K=K, N=N, block_size=bs)

