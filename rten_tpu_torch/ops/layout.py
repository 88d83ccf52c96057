"""Reshape, Split, Transpose, Unsqueeze and Cast (the port of
``rten_tpu/ops/layout.py``). All but Cast return views where PyTorch can."""

from __future__ import annotations

import numpy as np
import torch

from ..dtypes import DataType
from .registry import OpError, as_tensor, get_input, opt_input, register, static_value


@register("Reshape")
def _reshape(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    shape = static_value(get_input(inputs, 1, "shape"), "shape").astype(np.int64)
    allowzero = attrs.get("allowzero", 0)
    out = []
    for i, d in enumerate(shape):
        if d == 0 and not allowzero:
            out.append(x.shape[i])
        else:
            out.append(int(d))
    return x.reshape(out)


@register("Split")
def _split(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    axis = attrs.get("axis", 0)
    if axis < 0:
        axis += x.ndim
    split = opt_input(inputs, 1, attrs.get("split"))
    n_out = attrs.get("__n_outputs__", attrs.get("num_outputs"))
    if split is not None:
        sizes = np.atleast_1d(static_value(split, "split")).astype(int).tolist()
    else:
        if n_out is None:
            raise OpError("Split requires split sizes or num_outputs")
        dim = x.shape[axis]
        chunk = -(-dim // n_out)
        sizes = [min(chunk, dim - s) for s in range(0, dim, chunk)]
    return tuple(torch.split(x, sizes, dim=axis))


@register("Transpose")
def _transpose(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    perm = attrs.get("perm")
    if perm is None:
        perm = list(reversed(range(x.ndim)))
    return x.permute(*perm)


@register("Unsqueeze")
def _unsqueeze(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    axes = opt_input(inputs, 1, attrs.get("axes"))
    axes = np.atleast_1d(static_value(axes, "axes")).astype(int)
    out_ndim = x.ndim + len(axes)
    for a in sorted(int(a) % out_ndim for a in axes):
        x = x.unsqueeze(a)
    return x


@register("Cast")
def _cast(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    to = attrs["to"]
    if not isinstance(to, DataType):
        to = DataType.from_np(np.dtype(to))
    return x.to(to.torch_dtype)
