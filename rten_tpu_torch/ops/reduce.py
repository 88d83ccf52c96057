"""Reductions (the port of ``rten_tpu/ops/reduce.py``): Reduce*, ArgMax,
ArgMin, CumSum, TopK and NonZero.

ArgMax of first occurrence over the last axis of a >= 2-D f32 tensor (the
serving graphs' greedy head) runs the argmax kernel
(``rten_tpu_torch/kernels/argmax.py``), as the JAX package routes it to
its Pallas kernel; every other ArgMax and ArgMin is ``torch.argmax``/
``argmin``, which also return the first occurrence. Integer sums and
products keep the input's dtype (torch widens them to int64), and every
index output is int32, as in the JAX package. NonZero's output shape
depends on the data, so its input must be a host value.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.argmax import argmax_lastdim
from .registry import as_tensor, get_input, opt_input, register, static_value


def _axes_of(inputs, attrs, x):
    axes = opt_input(inputs, 1, attrs.get("axes"))
    noop_with_empty = attrs.get("noop_with_empty_axes", 0)
    if axes is None:
        return None, noop_with_empty
    axes = np.atleast_1d(static_value(axes, "axes")).astype(int)
    if axes.size == 0:
        return None, noop_with_empty
    return tuple(sorted({int(a) % x.ndim for a in axes})), noop_with_empty


def _sum(x, dims, keepdim):
    out = torch.sum(x, dim=dims, keepdim=keepdim)
    return out if x.is_floating_point() else out.to(x.dtype)


def _prod(x, dims, keepdim):
    out = x
    for d in sorted(dims, reverse=True):
        out = torch.prod(out, dim=d, keepdim=keepdim)
    return out if x.is_floating_point() else out.to(x.dtype)


def _mean(x, dims, keepdim):
    return torch.mean(x if x.is_floating_point() else x.to(torch.float32),
                      dim=dims, keepdim=keepdim)


def _amax(x, dims, keepdim):
    return torch.amax(x, dim=dims, keepdim=keepdim)


def _amin(x, dims, keepdim):
    return torch.amin(x, dim=dims, keepdim=keepdim)


def _logsumexp(x, dims, keepdim):
    return torch.logsumexp(x, dim=dims, keepdim=keepdim)


def _reduce(name, fn, pre=None, post=None):
    @register(name)
    def lower(ctx, inputs, attrs, _fn=fn, _pre=pre, _post=post):
        x = as_tensor(ctx, get_input(inputs, 0))
        axes, noop = _axes_of(inputs, attrs, x)
        if axes is None and noop:
            return x
        if axes is None:
            axes = tuple(range(x.ndim))
        keepdims = bool(attrs.get("keepdims", 1))
        if not axes:  # a 0-d input: nothing to reduce
            out = _pre(x) if _pre else x
            return _post(out) if _post else out
        out = _fn(_pre(x) if _pre else x, axes, keepdims)
        return _post(out) if _post else out

    return lower


_reduce("ReduceSum", _sum)
_reduce("ReduceMean", _mean)
_reduce("ReduceMax", _amax)
_reduce("ReduceMin", _amin)
_reduce("ReduceProd", _prod)
_reduce("ReduceL1", _sum, pre=torch.abs)
_reduce("ReduceL2", _sum, pre=torch.square, post=torch.sqrt)
_reduce("ReduceSumSquare", _sum, pre=torch.square)
_reduce("ReduceLogSum", _sum, post=torch.log)
_reduce("ReduceLogSumExp", _logsumexp)


def _arg_reduce(name, fn):
    @register(name)
    def lower(ctx, inputs, attrs, _fn=fn):
        x = as_tensor(ctx, get_input(inputs, 0))
        axis = attrs.get("axis", 0)
        if axis < 0:
            axis += x.ndim
        keepdims = bool(attrs.get("keepdims", 1))
        select_last = attrs.get("select_last_index", 0)
        if (name == "ArgMax" and not select_last and x.ndim >= 2 and axis == x.ndim - 1
                and x.dtype == torch.float32):
            rows = x.reshape(-1, x.shape[-1])
            if rows.stride(1) != 1:
                rows = rows.contiguous()
            idx = argmax_lastdim(rows).reshape(x.shape[:-1])
        elif select_last:
            idx = x.shape[axis] - 1 - _fn(torch.flip(x, [axis]), dim=axis)
        else:
            idx = _fn(x, dim=axis)
        idx = idx.to(torch.int32)
        return idx.unsqueeze(axis) if keepdims else idx

    return lower


_arg_reduce("ArgMax", torch.argmax)
_arg_reduce("ArgMin", torch.argmin)


@register("CumSum")
def _cumsum(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    axis = int(static_value(get_input(inputs, 1, "axis"), "axis").reshape(()))
    reverse = attrs.get("reverse", 0)
    if reverse:
        x = torch.flip(x, [axis])
    out = torch.cumsum(x, dim=axis).to(x.dtype)
    if attrs.get("exclusive", 0):
        out = out - x
    if reverse:
        out = torch.flip(out, [axis])
    return out


@register("TopK")
def _topk(ctx, inputs, attrs):
    """jax.lax.top_k: sorted, and among equal values the lower index first
    (a stable sort); the smallest k through top_k of -x, which a stable
    ascending sort reproduces."""
    x = as_tensor(ctx, get_input(inputs, 0))
    k = int(static_value(get_input(inputs, 1, "k"), "k").reshape(()))
    axis = attrs.get("axis", -1)
    if axis < 0:
        axis += x.ndim
    moved = x.movedim(axis, -1)
    vals, idx = torch.sort(moved, dim=-1, descending=bool(attrs.get("largest", 1)),
                           stable=True)
    vals = vals[..., :k].movedim(-1, axis)
    idx = idx[..., :k].movedim(-1, axis).to(torch.int32)
    return vals, idx


@register("NonZero")
def _nonzero(ctx, inputs, attrs):
    x = static_value(get_input(inputs, 0), "NonZero input")
    return np.stack(np.nonzero(x)).astype(np.int32)
