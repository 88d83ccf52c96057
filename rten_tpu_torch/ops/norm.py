"""Normalization and softmax ops (the port of ``rten_tpu/ops/norm.py``):
LayerNormalization, RMSNormalization, Softmax, LogSoftmax, AddSoftmax,
SafeSoftmax, BatchNormalization, InstanceNormalization and
LpNormalization, with the JAX package's formulas (LayerNorm
``(x - mean) * rsqrt(var + eps) * scale + bias``, RMSNorm
``x * rsqrt(mean(x^2) + eps) * scale``)."""

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
    """``x * rsqrt(mean(x^2) + eps) * scale`` in f64, rounded once to x's
    dtype: the card and the CPU reduce in another order, and in f32 their
    results part by an ulp (enough to move a u8 activation code that sits
    on a rounding tie, ROADMAP fault 5); in f64 both round alike."""
    x64 = x.double()
    ms = torch.square(x64).mean(dim=dims, keepdim=True)
    out = x64 * torch.rsqrt(ms + epsilon)
    if scale is not None:
        out = out * scale.double()
    return out.to(x.dtype)


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


@register("Softmax")
def _softmax(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    return torch.softmax(x, dim=attrs.get("axis", -1))


@register("LogSoftmax")
def _log_softmax(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    return torch.log_softmax(x, dim=attrs.get("axis", -1))


@register("AddSoftmax")
def _add_softmax(ctx, inputs, attrs):
    """The fused mask add and softmax (rten src/ops/attention.rs:79)."""
    x = as_tensor(ctx, get_input(inputs, 0))
    mask = as_tensor(ctx, get_input(inputs, 1, "mask"))
    return torch.softmax(x + mask, dim=attrs.get("axis", -1))


@register("SafeSoftmax")
def _safe_softmax(ctx, inputs, attrs):
    """Softmax that gives zeros, not NaN, on a row that is all -inf."""
    x = as_tensor(ctx, get_input(inputs, 0))
    axis = attrs.get("axis", -1)
    m = torch.amax(x, dim=axis, keepdim=True)
    e = torch.exp(x - m)
    e = torch.where(torch.isfinite(m), e, torch.zeros_like(e))
    s = torch.sum(e, dim=axis, keepdim=True)
    return torch.where(s > 0, e / s, torch.zeros_like(e))


def _per_channel(p: torch.Tensor, ndim: int) -> torch.Tensor:
    """A per-channel statistic [C] shaped to broadcast over NC... (axis 1)."""
    return p.reshape((1, -1) + (1,) * (ndim - 2))


@register("BatchNormalization")
def _batch_normalization(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    scale, bias, mean, var = (
        _per_channel(as_tensor(ctx, get_input(inputs, i, n)), x.ndim)
        for i, n in ((1, "scale"), (2, "bias"), (3, "mean"), (4, "var")))
    eps = attrs.get("epsilon", 1e-5)
    return (x - mean) * (scale * torch.rsqrt(var + eps)) + bias


@register("InstanceNormalization")
def _instance_normalization(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    scale = _per_channel(as_tensor(ctx, get_input(inputs, 1, "scale")), x.ndim)
    bias = _per_channel(as_tensor(ctx, get_input(inputs, 2, "bias")), x.ndim)
    eps = attrs.get("epsilon", 1e-5)
    dims = tuple(range(2, x.ndim))
    mean = x.mean(dim=dims, keepdim=True)
    var = torch.square(x - mean).mean(dim=dims, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


@register("LpNormalization")
def _lp_normalization(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    axis = attrs.get("axis", -1)
    if attrs.get("p", 2) == 1:
        norm = torch.sum(torch.abs(x), dim=axis, keepdim=True)
    else:
        norm = torch.sqrt(torch.sum(torch.square(x), dim=axis, keepdim=True))
    return x / norm
