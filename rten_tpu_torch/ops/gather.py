"""Gather and GatherND (the port of ``rten_tpu/ops/gather.py``).

Negative indices are normalized. Out-of-range indices follow ``jnp.take``,
which the JAX lowerings use: the gathered row is filled with NaN (floats)
instead of faulting — on a CUDA tensor an out-of-range index would
otherwise raise a device-side assert.
"""

from __future__ import annotations

import numpy as np
import torch

from .registry import OpError, as_tensor, get_input, register


def _take_rows(x: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """``x[idx]`` along dim 0 with ``jnp.take``'s NaN fill out of range."""
    oob = (idx < 0) | (idx >= n)
    out = x[idx.clamp(0, n - 1).long()]
    if x.is_floating_point():
        out = out.masked_fill(oob.reshape(oob.shape + (1,) * (out.ndim - oob.ndim)),
                              float("nan"))
    return out


@register("Gather")
def _gather(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    indices = as_tensor(ctx, get_input(inputs, 1, "indices"))
    axis = attrs.get("axis", 0)
    if axis < 0:
        axis += x.ndim
    n = x.shape[axis]
    idx = torch.where(indices < 0, indices + n, indices)
    xt = x.movedim(axis, 0)
    out = _take_rows(xt, idx, n)  # [*idx.shape, *rest]
    return out.movedim(tuple(range(idx.ndim)), tuple(range(axis, axis + idx.ndim)))


@register("GatherND")
def _gather_nd(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    indices = as_tensor(ctx, get_input(inputs, 1, "indices")).to(torch.int32)
    batch_dims = attrs.get("batch_dims", 0)
    if batch_dims != 1:
        raise NotImplementedError(
            "GatherND with batch_dims != 1: ROADMAP.md queue 1 item 12"
        )
    if indices.shape[0] != x.shape[0]:
        raise OpError("GatherND: batch dims of data and indices differ")
    B = x.shape[0]
    k = indices.shape[-1]
    dims = x.shape[1:1 + k]
    rest = x.shape[1 + k:]
    flat = torch.zeros(indices.shape[:-1], dtype=torch.int32, device=x.device)
    stride = 1
    for i in reversed(range(k)):
        comp = indices[..., i]
        comp = torch.where(comp < 0, comp + dims[i], comp)
        flat = flat + comp * stride
        stride *= dims[i]
    lead = int(np.prod(dims))
    xf = x.reshape((B, lead) + tuple(rest))
    mid = flat.shape[1:]
    bidx = torch.arange(B, device=x.device).reshape((B,) + (1,) * len(mid))
    oob = (flat < 0) | (flat >= lead)
    out = xf[bidx, flat.clamp(0, lead - 1).long()]  # [B, *mid, *rest]
    if x.is_floating_point():
        out = out.masked_fill(oob.reshape(oob.shape + (1,) * len(rest)), float("nan"))
    return out
