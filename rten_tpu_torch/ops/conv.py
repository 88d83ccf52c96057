"""Convolution ops (the port of ``rten_tpu/ops/conv.py``): Conv,
ConvInteger, ConvIntegerToFloat and ConvTranspose, 1-D to 3-D.

* Conv (``conv.py:79-104``): ``F.conv1d/2d/3d``, groups and dilations as
  they are. ONNX pads may differ on the two sides of an axis (SAME_UPPER
  with an even kernel, explicit ``pads``), and ``F.conv*d`` pads both sides
  alike, so the input is padded first with ``F.pad``. The JAX package
  computes f32 convs at ``Precision.HIGHEST``; cuDNN runs f32 convs in TF32
  unless ``torch.backends.cudnn.allow_tf32`` is off, and it is on by
  default. So on a CUDA device the port convolves f32 operands in f64 and
  rounds the result to f32 once: no TF32 flag changes it, and the op reads
  and writes no process-wide flag. ``RunConfig.prefer_bf16`` (the JAX
  package's DEFAULT precision, one bf16 pass of the TPU's matrix unit)
  convolves bf16 copies of the operands on the card instead, accumulated
  in f32 by cuDNN; its result is widened back to f32. On the CPU both are
  plain f32, as the JAX package computes on the CPU.
* ConvInteger (``conv.py:107-195``): the shifted-slice im2col of the JAX
  package (C outer, kernel positions inner; padded with the input's zero
  point, so a padded position adds exactly 0 after the zero-point
  correction), then the exact integer product ``int_matmul`` with the
  zero-point algebra; groups split into single convs.
* ConvIntegerToFloat (``conv.py:197-216``), the op
  ``optimize.fuse_conv_integer_to_float`` and the conv branch of
  ``quantize_dynamic`` make: s8 weights of a conv of group 1 take their
  im2col product through the int8 kernel (``kernels/int8_matmul.py``: u8 patches with the
  per-tensor x_zp, weights [C·k, O], per-output-channel scales), the same
  u8 x s8 -> f32 contract as MatMulIntegerToFloat; the bias is added after.
  Other convs take ConvInteger's exact product times the scales, as the
  JAX op does.
* ConvTranspose (``conv.py:218-295``): ``F.conv_transpose*d`` with no
  padding, then the ONNX pads and ``output_padding`` as a crop of the
  full output (pads that differ on the two sides; pads derived from
  ``output_shape`` and ``auto_pad``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.int8_matmul import int8_matmul_dequant
from .matmul import contract, int_matmul
from .registry import OpError, as_tensor, get_input, opt_input, register

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}


def _resolve_pads(
    auto_pad: str,
    pads,
    in_spatial: Sequence[int],
    kernel: Sequence[int],
    strides: Sequence[int],
    dilations: Sequence[int],
) -> List[Tuple[int, int]]:
    """(before, after) pads of each spatial axis from ONNX ``auto_pad`` and
    ``pads`` (a copy of the JAX package's rule)."""
    ndim = len(in_spatial)
    if isinstance(auto_pad, bytes):
        auto_pad = auto_pad.decode()
    if auto_pad in ("NOTSET", "", None):
        if pads is None:
            pads = [0] * (2 * ndim)
        return [(int(pads[i]), int(pads[i + ndim])) for i in range(ndim)]
    if auto_pad == "VALID":
        return [(0, 0)] * ndim
    out = []
    for i in range(ndim):
        out_size = -(-in_spatial[i] // strides[i])
        eff_k = (kernel[i] - 1) * dilations[i] + 1
        total = max(0, (out_size - 1) * strides[i] + eff_k - in_spatial[i])
        if auto_pad == "SAME_UPPER":
            out.append((total // 2, total - total // 2))
        elif auto_pad == "SAME_LOWER":
            out.append((total - total // 2, total // 2))
        else:
            raise OpError(f"unsupported auto_pad {auto_pad}")
    return out


def _conv_params(x, w, attrs):
    n_spatial = x.ndim - 2
    strides = list(attrs.get("strides", [1] * n_spatial))
    dilations = list(attrs.get("dilations", [1] * n_spatial))
    kernel = list(w.shape[2:])
    pads = _resolve_pads(
        attrs.get("auto_pad", "NOTSET"),
        attrs.get("pads"),
        x.shape[2:],
        kernel,
        strides,
        dilations,
    )
    return strides, dilations, pads, attrs.get("group", 1)


def pad_spatial(x: torch.Tensor, pads, value=0) -> torch.Tensor:
    """``x`` [N, C, *spatial] padded by (before, after) on each spatial
    axis."""
    flat = [p for before_after in reversed(pads) for p in before_after]
    return F.pad(x, flat, value=value) if any(flat) else x


def _bias_shape(bias, n_sp):
    return bias.reshape((1, -1) + (1,) * n_sp)


@register("Conv")
def _conv(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    w = as_tensor(ctx, get_input(inputs, 1, "weight"))
    bias = opt_input(inputs, 2)
    n_sp = x.ndim - 2
    if n_sp not in _CONV:
        raise OpError(f"Conv: {n_sp} spatial dims (1 to 3 supported)")
    strides, dilations, pads, group = _conv_params(x, w, attrs)
    out = contract(ctx, lambda a, b: _CONV[n_sp](pad_spatial(a, pads), b, None, strides, 0,
                                                 dilations, group), x, w)
    if bias is not None:
        out = out + _bias_shape(as_tensor(ctx, bias), n_sp)
    return out


def im2col(x: torch.Tensor, kernel, strides, dilations, pads, pad_value=0, ck_multiple=1):
    """Shifted-slice im2col (``_im2col_int`` of the JAX package): patches
    [N * P, CK] in the input's dtype, laid out C outer, kernel positions
    inner, and the output's spatial shape. The input is padded with
    ``pad_value`` (the input zero point), and so are the columns past
    C * prod(kernel) that round CK up to a multiple of ``ck_multiple``."""
    n_sp = x.ndim - 2
    if any(p for pp in pads for p in pp):
        shape = (*x.shape[:2], *(x.shape[2 + i] + sum(pads[i]) for i in range(n_sp)))
        if isinstance(pad_value, torch.Tensor):  # a device value: no host read
            if pad_value.numel() != 1:
                raise OpError("ConvInteger: the input zero point must be one value")
            xp = pad_value.reshape((1,) * x.ndim).to(x.dtype).expand(shape).contiguous()
        else:
            xp = torch.full(shape, pad_value, dtype=x.dtype, device=x.device)
        xp[(slice(None), slice(None), *(slice(p[0], p[0] + x.shape[2 + i])
                                          for i, p in enumerate(pads)))] = x
        x = xp
    in_sp = x.shape[2:]
    out_sp = [
        (in_sp[i] - (kernel[i] - 1) * dilations[i] - 1) // strides[i] + 1
        for i in range(n_sp)
    ]
    pieces = []
    for kidx in np.ndindex(*kernel):
        slices = [slice(None), slice(None)]
        for i in range(n_sp):
            start = kidx[i] * dilations[i]
            stop = start + (out_sp[i] - 1) * strides[i] + 1
            slices.append(slice(start, stop, strides[i]))
        pieces.append(x[tuple(slices)])
    # [K_positions, N, C, *out_sp] -> [N, *out_sp, C, K_positions]
    stacked = torch.stack(pieces, dim=0).permute(1, *range(3, 3 + n_sp), 2, 0)
    N, C = x.shape[:2]
    ck = C * len(pieces)
    ck_padded = -(-ck // ck_multiple) * ck_multiple
    if ck_padded == ck:
        return stacked.reshape(-1, ck), out_sp
    patches = torch.empty((stacked.shape[:-2].numel(), ck_padded), dtype=x.dtype,
                          device=x.device)
    patches[:, ck:] = pad_value.reshape(()) if isinstance(pad_value, torch.Tensor) else pad_value
    patches[:, :ck].view(stacked.shape).copy_(stacked)
    return patches, out_sp


def weight_matrix(w: torch.Tensor, ck: int) -> torch.Tensor:
    """Conv weights [O, C, *kernel] as the im2col product's [ck, O]
    operand, its rows past C * prod(kernel) zero."""
    m = w.reshape(w.shape[0], -1).t()
    return F.pad(m, (0, 0, 0, ck - m.shape[0])) if ck > m.shape[0] else m.contiguous()


def _integer_conv(x, w, x_zp, attrs, product, weights=weight_matrix, ck_multiple=1):
    """Split into groups, im2col, and ``product(patches [N*P, CK],
    weights(w, CK) [CK, O])`` -> [N*P, O], back to [N, O, *out_sp]."""
    strides, dilations, pads, group = _conv_params(x, w, attrs)
    if group != 1:
        xg = torch.chunk(x, group, dim=1)
        wg = torch.chunk(w, group, dim=0)
        return torch.cat([_integer_conv(a, b, x_zp, {**attrs, "group": 1}, product)
                          for a, b in zip(xg, wg)], dim=1)
    patches, out_sp = im2col(x, list(w.shape[2:]), strides, dilations, pads,
                             pad_value=x_zp if x_zp is not None else 0,
                             ck_multiple=ck_multiple)
    out = product(patches, weights(w, patches.shape[-1]))
    out = out.reshape(x.shape[0], *out_sp, w.shape[0])
    return out.permute(0, out.ndim - 1, *range(1, out.ndim - 1)).contiguous()


def conv_integer_impl(x, w, x_zp, w_zp, attrs):
    """ConvInteger: the exact int32 conv of (x - x_zp) and (w - w_zp)."""
    return _integer_conv(x, w, x_zp, attrs, lambda a, b: int_matmul(a, b, x_zp, w_zp))


@register("ConvInteger")
def _conv_integer(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    w = as_tensor(ctx, get_input(inputs, 1, "weight"))
    x_zp, w_zp = (None if opt_input(inputs, i) is None else as_tensor(ctx, inputs[i])
                  for i in (2, 3))
    return conv_integer_impl(x, w, x_zp, w_zp, attrs)


@register("ConvIntegerToFloat")
def _conv_integer_to_float(ctx, inputs, attrs):
    """Fused ConvInteger + dequant (+ bias), inputs (x, w, x_scale,
    w_scale, x_zp, w_zp, bias) (rten src/ops/conv.rs:552)."""
    x = as_tensor(ctx, get_input(inputs, 0))
    w = as_tensor(ctx, get_input(inputs, 1, "weight"))
    x_scale = as_tensor(ctx, get_input(inputs, 2, "x_scale")).to(torch.float32)
    w_scale = as_tensor(ctx, get_input(inputs, 3, "w_scale")).to(torch.float32)
    x_zp, w_zp, bias = (None if opt_input(inputs, i) is None else as_tensor(ctx, inputs[i])
                        for i in (4, 5, 6))
    n_sp = x.ndim - 2
    if (w.dtype == torch.int8 and x.dtype in (torch.uint8, torch.int8)
            and x_scale.numel() == 1 and attrs.get("group", 1) == 1):
        # The kernel takes K in multiples of 4: im2col widens the patches
        # with x_zp columns, and the weight matrix, laid out and widened
        # with zero rows once a weight, is kept beside the device weights.
        out = _integer_conv(
            x, w, x_zp, attrs,
            lambda a, b: int8_matmul_dequant(
                a, b, x_scale.reshape(()), w_scale.reshape(-1) if w_scale.numel() > 1
                else w_scale.reshape(()), x_zp, w_zp),
            weights=lambda w, ck: ctx.executor.derived_weight(
                w, ("im2col", ck), lambda: weight_matrix(w, ck)),
            ck_multiple=4)
    else:
        acc = conv_integer_impl(x, w, x_zp, w_zp, attrs)
        scale = x_scale * w_scale
        if scale.ndim == 1:  # per-output-channel
            scale = _bias_shape(scale, n_sp)
        out = acc.to(torch.float32) * scale
    if bias is not None:
        out = out + _bias_shape(bias, n_sp)
    return out


@register("ConvTranspose")
def _conv_transpose(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    w = as_tensor(ctx, get_input(inputs, 1, "weight"))  # [C_in, C_out/group, k...]
    bias = opt_input(inputs, 2)
    n_sp = x.ndim - 2
    if n_sp not in _CONV_T:
        raise OpError(f"ConvTranspose: {n_sp} spatial dims (1 to 3 supported)")
    strides = list(attrs.get("strides", [1] * n_sp))
    dilations = list(attrs.get("dilations", [1] * n_sp))
    group = attrs.get("group", 1)
    kernel = list(w.shape[2:])
    output_padding = list(attrs.get("output_padding", [0] * n_sp))
    pads = attrs.get("pads")
    auto_pad = attrs.get("auto_pad", "NOTSET")
    if isinstance(auto_pad, bytes):
        auto_pad = auto_pad.decode()
    output_shape = attrs.get("output_shape")

    if output_shape is not None:
        # Derive pads from the requested output shape.
        pads_resolved = []
        for i in range(n_sp):
            eff_k = (kernel[i] - 1) * dilations[i] + 1
            total = max(0, strides[i] * (x.shape[2 + i] - 1) + output_padding[i] + eff_k
                        - output_shape[i])
            if auto_pad == "SAME_UPPER":
                pads_resolved.append((total // 2, total - total // 2))
            else:
                pads_resolved.append((total - total // 2, total // 2))
    elif pads is None:
        pads_resolved = [(0, 0)] * n_sp
    else:
        pads_resolved = [(int(pads[i]), int(pads[i + n_sp])) for i in range(n_sp)]

    # The JAX op leaves ConvTranspose at the default precision, which is
    # f32 on the CPU; the card matches it in f64, prefer_bf16 or not.
    # The full output, (in - 1) * stride + (k - 1) * dilation + 1 on each
    # axis; output_padding adds positions past its end that no input
    # reaches, and the pads crop both ends.
    full = contract(ctx, lambda a, b: _CONV_T[n_sp](a, b, None, strides, 0, 0, group, dilations),
                    x, w, honour_bf16=False)
    full = pad_spatial(full, [(0, op) for op in output_padding])
    out = full[(slice(None), slice(None),
                *(slice(lo, full.shape[2 + i] - hi) for i, (lo, hi) in enumerate(pads_resolved)))]
    if bias is not None:
        out = out + _bias_shape(as_tensor(ctx, bias), n_sp)
    return out
