"""Gathers and scatters (the port of ``rten_tpu/ops/gather.py``): Gather,
GatherElements, GatherND at any ``batch_dims``, ScatterElements (and its
deprecated alias Scatter) and ScatterND, with reductions none, add, mul,
max and min.

Indices follow the JAX lowerings case by case (no index faults, unlike
the reference, which errors):

* gathers: a negative index is normalized once by the op (``i + n``) and
  once more by ``jnp.take`` / ``jnp.take_along_axis``; an index still out
  of range reads ``jnp.take``'s fill value (NaN for floats, the most
  negative value for signed integers, the largest for unsigned ones, True
  for bools) instead of faulting, which on a CUDA tensor would be a
  device-side assert;
* scatters: ``x.at[locs]`` normalizes a negative index once more and drops
  an update whose index is still out of range. With reduction "none" the
  last of several updates to one element, in the updates' row-major order,
  wins, as XLA's scatter applies them on the CPU. The port resolves such
  duplicates before it writes, so the card's unordered writes give the
  same answer; add, mul, max and min combine duplicates, float add in an
  order the card does not fix.
"""

from __future__ import annotations

import numpy as np
import torch

from .registry import OpError, as_tensor, get_input, register


def _norm(idx: torch.Tensor, n: int) -> torch.Tensor:
    return torch.where(idx < 0, idx + n, idx)


def _fill_value(dtype: torch.dtype):
    """``jnp.take``'s out-of-range fill for ``dtype``."""
    if dtype.is_floating_point:
        return float("nan")
    if dtype == torch.bool:
        return True
    return torch.iinfo(dtype).min if dtype.is_signed else torch.iinfo(dtype).max


def _take_rows(x: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """``jnp.take(x, idx, axis=0)``: a negative index counts from the end,
    one still out of range reads the fill value."""
    idx = _norm(idx.to(torch.int64), n)
    oob = (idx < 0) | (idx >= n)
    out = x[idx.clamp(0, n - 1)]
    return out.masked_fill(oob.reshape(oob.shape + (1,) * (out.ndim - oob.ndim)),
                           _fill_value(x.dtype))


@register("Gather")
def _gather(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    indices = as_tensor(ctx, get_input(inputs, 1, "indices"))
    axis = attrs.get("axis", 0)
    if axis < 0:
        axis += x.ndim
    n = x.shape[axis]
    idx = _norm(indices, n)
    out = _take_rows(x.movedim(axis, 0), idx, n)  # [*idx.shape, *rest]
    return out.movedim(tuple(range(idx.ndim)), tuple(range(axis, axis + idx.ndim)))


@register("GatherElements")
def _gather_elements(ctx, inputs, attrs):
    """``jnp.take_along_axis`` of the normalized indices."""
    x = as_tensor(ctx, get_input(inputs, 0))
    indices = as_tensor(ctx, get_input(inputs, 1, "indices")).to(torch.int64)
    axis = attrs.get("axis", 0)
    if axis < 0:
        axis += x.ndim
    n = x.shape[axis]
    idx = _norm(_norm(indices, n), n)
    oob = (idx < 0) | (idx >= n)
    out = torch.gather(x, axis, idx.clamp(0, n - 1))
    return out.masked_fill(oob, _fill_value(x.dtype))


@register("GatherND")
def _gather_nd(ctx, inputs, attrs):
    """The JAX lowering's ``gather_one`` under ``batch_dims`` vmaps: each
    index component normalized, the components flattened to one row index
    into the data's first k dims, ``jnp.take`` of that row."""
    x = as_tensor(ctx, get_input(inputs, 0))
    indices = as_tensor(ctx, get_input(inputs, 1, "indices")).to(torch.int64)
    bd = int(attrs.get("batch_dims", 0))
    if tuple(indices.shape[:bd]) != tuple(x.shape[:bd]):
        raise OpError("GatherND: batch dims of data and indices differ")
    batch = tuple(x.shape[:bd])
    k = indices.shape[-1]
    dims = x.shape[bd:bd + k]
    rest = tuple(x.shape[bd + k:])
    nb = int(np.prod(batch))
    idx = indices.reshape((nb,) + tuple(indices.shape[bd:]))
    flat = torch.zeros(idx.shape[:-1], dtype=torch.int64, device=x.device)
    for i in range(k):
        flat = flat * dims[i] + _norm(idx[..., i], dims[i])
    lead = int(np.prod(dims))
    xf = x.reshape((nb, lead) + rest)
    mid = flat.shape[1:]
    flat = _norm(flat, lead)
    oob = (flat < 0) | (flat >= lead)
    bidx = torch.arange(nb, device=x.device).reshape((nb,) + (1,) * len(mid))
    out = xf[bidx, flat.clamp(0, lead - 1)]  # [nb, *mid, *rest]
    out = out.masked_fill(oob.reshape(oob.shape + (1,) * len(rest)), _fill_value(x.dtype))
    return out.reshape(batch + tuple(mid) + rest)


def _reduction(attrs) -> str:
    r = attrs.get("reduction", "none")
    r = r.decode() if isinstance(r, bytes) else r
    if r not in ("none", "add", "mul", "max", "min"):
        raise OpError(f"unsupported scatter reduction {r}")
    return r


def scatter(x: torch.Tensor, coords, updates: torch.Tensor, reduction: str) -> torch.Tensor:
    """``x.at[coords].set / add / multiply / max / min(updates)``: ``coords``
    one integer tensor per dim of x, each shaped like ``updates``. A
    negative coordinate counts from the end; an update with a coordinate
    still out of range is dropped. Returns a new tensor."""
    valid = torch.ones(updates.shape, dtype=torch.bool, device=x.device)
    target = torch.zeros(updates.shape, dtype=torch.int64, device=x.device)
    for c, n in zip(coords, x.shape):
        c = _norm(c.to(torch.int64), n)
        valid &= (c >= 0) & (c < n)
        target = target * n + c
    target, upd = target[valid], updates[valid].to(x.dtype)
    out = x.clone().reshape(-1)
    if reduction == "none":
        # The last update to each element wins: keep, for each target,
        # only the update of the highest position, then write unique rows.
        order = torch.arange(target.numel(), device=x.device)
        last = torch.full((out.numel(),), -1, dtype=torch.int64, device=x.device)
        last.scatter_reduce_(0, target, order, reduce="amax")
        keep = last[target] == order
        out[target[keep]] = upd[keep]
    elif reduction == "add":
        out.index_add_(0, target, upd)
    else:
        out.scatter_reduce_(0, target, upd, reduce={"mul": "prod", "max": "amax",
                                                    "min": "amin"}[reduction])
    return out.reshape(x.shape)


def _grid(shape, device):
    """Coordinate tensors of every element of ``shape``, one per dim."""
    if not shape:
        return []
    return list(torch.meshgrid(*(torch.arange(s, device=device) for s in shape),
                               indexing="ij"))


@register("ScatterElements")
def _scatter_elements(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    indices = as_tensor(ctx, get_input(inputs, 1, "indices")).to(torch.int64)
    updates = as_tensor(ctx, get_input(inputs, 2, "updates"))
    axis = attrs.get("axis", 0)
    if axis < 0:
        axis += x.ndim
    coords = _grid(updates.shape, x.device)
    coords[axis] = _norm(indices, x.shape[axis]).expand(updates.shape)
    return scatter(x, coords, updates, _reduction(attrs))


@register("Scatter")
def _scatter(ctx, inputs, attrs):
    """The deprecated ONNX alias of ScatterElements."""
    return _scatter_elements(ctx, inputs, attrs)


@register("ScatterND")
def _scatter_nd(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    indices = as_tensor(ctx, get_input(inputs, 1, "indices")).to(torch.int32).to(torch.int64)
    updates = as_tensor(ctx, get_input(inputs, 2, "updates"))
    k = indices.shape[-1]
    lead = tuple(indices.shape[:-1])
    shape = lead + tuple(x.shape[k:])
    tail = (1,) * (x.ndim - k)
    coords = [indices[..., i].reshape(lead + tail).expand(shape) for i in range(k)]
    coords += [g.reshape((1,) * len(lead) + tuple(g.shape)).expand(shape)
               for g in _grid(x.shape[k:], x.device)]
    return scatter(x, coords, updates.expand(shape), _reduction(attrs))
