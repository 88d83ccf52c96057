"""Reshape and Split (the port of ``rten_tpu/ops/layout.py``). Both return
views where PyTorch can."""

from __future__ import annotations

import numpy as np
import torch

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
