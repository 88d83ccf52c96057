"""LayerNormalization and RMSNormalization (the port of
``rten_tpu/ops/norm.py``), with the JAX package's formulas:
``(x - mean) * rsqrt(var + eps) * scale + bias`` and
``x * rsqrt(mean(x^2) + eps) * scale``."""

from __future__ import annotations

import torch

from .registry import as_tensor, get_input, opt_input, register


def layer_norm(x, scale, bias, dims, epsilon):
    mean = x.mean(dim=dims, keepdim=True)
    var = torch.square(x - mean).mean(dim=dims, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + epsilon)
    if scale is not None:
        out = out * scale
    if bias is not None:
        out = out + bias
    return out


@register("LayerNormalization")
def _layer_normalization(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    scale = opt_input(inputs, 1)
    bias = opt_input(inputs, 2)
    axis = attrs.get("axis", -1)
    eps = attrs.get("epsilon", 1e-5)
    if axis < 0:
        axis += x.ndim
    dims = tuple(range(axis, x.ndim))
    return layer_norm(
        x,
        None if scale is None else as_tensor(ctx, scale),
        None if bias is None else as_tensor(ctx, bias),
        dims, eps,
    )


def rms_norm(x, scale, dims, epsilon):
    ms = torch.square(x).mean(dim=dims, keepdim=True)
    out = x * torch.rsqrt(ms + epsilon)
    if scale is not None:
        out = out * scale
    return out


@register("RMSNormalization")
def _rms_normalization(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    scale = opt_input(inputs, 1)
    axis = attrs.get("axis", -1)
    eps = attrs.get("epsilon", 1e-5)
    if axis < 0:
        axis += x.ndim
    dims = tuple(range(axis, x.ndim))
    return rms_norm(x, None if scale is None else as_tensor(ctx, scale), dims, eps)
