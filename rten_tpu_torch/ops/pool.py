"""Pooling ops (the port of ``rten_tpu/ops/pool.py``): MaxPool,
AveragePool, GlobalAveragePool, GlobalMaxPool.

The JAX package lowers MaxPool and AveragePool to ``lax.reduce_window``
over the padded input; the port does the same with strided views of the
padded input, one a kernel position (``windows``), which takes any dtype,
dilations and pads that differ on the two sides. ``F.max_pool*d`` and
``F.avg_pool*d`` do not: no integer max pool on the CPU, no dilation for
the average, and another divisor under ``ceil_mode``.

* ``ceil_mode`` widens the right pad so the last partial window counts
  (the JAX package's rule).
* MaxPool pads with -inf for floats and the dtype's minimum for integers.
* AveragePool divides window sums over the zero-padded input by
  ``prod(kernel)`` under ``count_include_pad`` (the ``ceil_mode`` pad
  counts too, as in the JAX package), else by the window sums of a ones
  array padded the same way: the real positions a window covers.
"""

from __future__ import annotations

import numpy as np
import torch

from .conv import _resolve_pads, pad_spatial
from .registry import as_tensor, get_input, register


def _pool_params(x, attrs):
    n_sp = x.ndim - 2
    kernel = list(attrs["kernel_shape"])
    strides = list(attrs.get("strides", [1] * n_sp))
    dilations = list(attrs.get("dilations", [1] * n_sp))
    pads = _resolve_pads(
        attrs.get("auto_pad", "NOTSET"),
        attrs.get("pads"),
        x.shape[2:],
        kernel,
        strides,
        dilations,
    )
    if attrs.get("ceil_mode", 0):
        # Extend the right pad so the last partial window is included.
        pads = [list(p) for p in pads]
        for i in range(n_sp):
            eff_k = (kernel[i] - 1) * dilations[i] + 1
            padded = x.shape[2 + i] + pads[i][0] + pads[i][1]
            rem = (padded - eff_k) % strides[i]
            if rem != 0:
                pads[i][1] += strides[i] - rem
        pads = [tuple(p) for p in pads]
    return kernel, strides, dilations, pads


def windows(x: torch.Tensor, kernel, strides, dilations):
    """One strided view of the (already padded) ``x`` [N, C, *sp] for each
    kernel position: element o of view k is the input under position k of
    output o's window."""
    n_sp = x.ndim - 2
    out_sp = [(x.shape[2 + i] - (kernel[i] - 1) * dilations[i] - 1) // strides[i] + 1
              for i in range(n_sp)]
    for kidx in np.ndindex(*kernel):
        yield x[(slice(None), slice(None),
                 *(slice(kidx[i] * dilations[i],
                         kidx[i] * dilations[i] + (out_sp[i] - 1) * strides[i] + 1, strides[i])
                   for i in range(n_sp)))]


def _window_sums(x, kernel, strides, dilations):
    out = None
    for v in windows(x, kernel, strides, dilations):
        out = v.clone() if out is None else out.add_(v)
    return out


@register("MaxPool")
def _max_pool(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    kernel, strides, dilations, pads = _pool_params(x, attrs)
    init = float("-inf") if x.dtype.is_floating_point else torch.iinfo(x.dtype).min
    out = None
    for v in windows(pad_spatial(x, pads, init), kernel, strides, dilations):
        out = v.clone() if out is None else torch.maximum(out, v, out=out)
    return out


@register("AveragePool")
def _average_pool(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    kernel, strides, dilations, pads = _pool_params(x, attrs)
    sums = _window_sums(pad_spatial(x, pads), kernel, strides, dilations)
    if attrs.get("count_include_pad", 0):
        return sums / float(np.prod(kernel))
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype, device=x.device)
    return sums / _window_sums(pad_spatial(ones, pads), kernel, strides, dilations)


@register("GlobalAveragePool")
def _global_average_pool(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    return torch.mean(x, dim=tuple(range(2, x.ndim)), keepdim=True)


@register("GlobalMaxPool")
def _global_max_pool(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    return torch.amax(x, dim=tuple(range(2, x.ndim)), keepdim=True)
