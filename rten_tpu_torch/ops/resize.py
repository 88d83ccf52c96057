"""Resize and Upsample (the port of ``rten_tpu/ops/resize.py``; rten
src/ops/resize.rs).

Scales and sizes must be graph constants (host values after constant
propagation). Interpolation is separable, as in the JAX package: each
resized axis becomes an ``index_select`` at tap indices, times weights,
both computed with numpy on the host (``_src_coord``, ``_nearest_index``,
``_cubic_weights``: copies of the JAX package's tables), summed tap by tap
in f32. ``F.interpolate`` covers neither every coordinate transformation
nor every nearest mode, nor cubic with ``exclude_outside``.

Supported: nearest (every ONNX ``nearest_mode``), linear, cubic (a =
-0.75, ``exclude_outside``); coordinate transformations half_pixel,
half_pixel_symmetric, pytorch_half_pixel, asymmetric, align_corners,
tf_half_pixel_for_nn (tf_crop_and_resize is refused, as the JAX op
refuses it). Integer inputs interpolate in f32 and round half to even
back to their dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from .registry import OpError, as_tensor, get_input, opt_input, register, static_value


def _src_coord(i: np.ndarray, scale: float, in_size: int, out_size: int, mode: str):
    if mode in ("half_pixel", "half_pixel_symmetric"):
        return (i + 0.5) / scale - 0.5
    if mode == "pytorch_half_pixel":
        return (i + 0.5) / scale - 0.5 if out_size > 1 else np.zeros_like(i, np.float64)
    if mode == "asymmetric":
        return i / scale
    if mode == "align_corners":
        if out_size == 1:
            return np.zeros_like(i, np.float64)
        return i * (in_size - 1) / (out_size - 1)
    if mode == "tf_half_pixel_for_nn":
        return (i + 0.5) / scale
    raise OpError(f"unsupported coordinate_transformation_mode {mode}")


def _nearest_index(x: np.ndarray, mode: str):
    if mode == "round_prefer_floor":
        return np.ceil(x - 0.5)
    if mode == "round_prefer_ceil":
        return np.floor(x + 0.5)
    if mode == "floor":
        return np.floor(x)
    if mode == "ceil":
        return np.ceil(x)
    raise OpError(f"unsupported nearest_mode {mode}")


def _cubic_weights(f: np.ndarray, a: float = -0.75):
    # Keys cubic kernel; taps at offsets -1, 0, 1, 2 from floor(x).
    def w(d):
        d = np.abs(d)
        return np.where(
            d <= 1,
            ((a + 2) * d - (a + 3)) * d * d + 1,
            np.where(d < 2, (((d - 5) * d + 8) * d - 4) * a, 0.0),
        )

    return [w(f + 1), w(f), w(1 - f), w(2 - f)]


def _taps(in_size, out_size, scale, mode, coord_mode, nearest_mode, exclude_outside):
    """[(int64 indices [out_size], f32 weights [out_size] or None)]: the
    taps of one axis, each index clamped into the input."""
    i = np.arange(out_size, dtype=np.float64)
    src = _src_coord(i, scale, in_size, out_size, coord_mode)
    if mode == "nearest":
        idx = np.clip(_nearest_index(src, nearest_mode), 0, in_size - 1)
        return [(idx.astype(np.int64), None)]
    lo = np.floor(src)
    f = src - lo
    if mode == "linear":
        taps = [(lo, 1.0 - f), (lo + 1, f)]
    elif mode == "cubic":
        ws = _cubic_weights(f)
        taps = [(lo - 1 + t, ws[t]) for t in range(4)]
    else:
        raise OpError(f"unsupported resize mode {mode}")
    ws = []
    for idx, w in taps:
        if exclude_outside:
            w = np.where((idx >= 0) & (idx <= in_size - 1), w, 0.0)
        ws.append(w)
    if exclude_outside:
        total = np.sum(ws, axis=0)
        total = np.where(total == 0, 1.0, total)
        ws = [w / total for w in ws]
    return [(np.clip(idx, 0, in_size - 1).astype(np.int64), w.astype(np.float32))
            for (idx, _), w in zip(taps, ws)]


def _resize_axis(x, axis, out_size, scale, mode, coord_mode, nearest_mode, exclude_outside):
    in_size = x.shape[axis]
    if out_size == in_size:
        return x
    out = None
    shape = [1] * x.ndim
    shape[axis] = out_size
    for idx, w in _taps(in_size, out_size, scale, mode, coord_mode, nearest_mode,
                        exclude_outside):
        g = torch.index_select(x, axis, torch.from_numpy(idx).to(x.device))
        if w is None:
            return g
        term = g * torch.from_numpy(w).to(x.device).reshape(shape)
        out = term if out is None else out + term
    return out


def _resize_impl(x, scales, sizes, mode, coord_mode, nearest_mode, exclude_outside):
    nd = x.ndim
    if sizes is not None:
        out_sizes = [int(s) for s in np.asarray(sizes).reshape(-1)]
        eff_scales = [out_sizes[i] / x.shape[i] for i in range(nd)]
    else:
        eff_scales = [float(s) for s in np.asarray(scales).reshape(-1)]
        out_sizes = [int(np.floor(x.shape[i] * eff_scales[i])) for i in range(nd)]
    compute = x
    if mode != "nearest" and not x.dtype.is_floating_point:
        compute = x.to(torch.float32)
    for axis in range(nd):
        compute = _resize_axis(compute, axis, out_sizes[axis], eff_scales[axis], mode,
                               coord_mode, nearest_mode, exclude_outside)
    if compute.dtype != x.dtype:
        compute = torch.round(compute).to(x.dtype)
    return compute


def _str_attr(attrs, name, default):
    v = attrs.get(name, default)
    return v.decode() if isinstance(v, bytes) else v


@register("Resize", static=(1, 2, 3))
def _resize(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    # opset >= 11: (X, roi, scales, sizes); opset 10: (X, scales).
    if len(inputs) == 2:
        scales = opt_input(inputs, 1)
        sizes = None
    else:
        scales = opt_input(inputs, 2)
        sizes = opt_input(inputs, 3)
    if scales is not None and np.asarray(scales).size == 0:
        scales = None
    if scales is None and sizes is None:
        raise OpError("Resize requires scales or sizes")
    scales = static_value(scales, "scales") if scales is not None else None
    sizes = static_value(sizes, "sizes") if sizes is not None else None
    coord_mode = _str_attr(attrs, "coordinate_transformation_mode", "half_pixel")
    if coord_mode == "tf_crop_and_resize":
        raise OpError("Resize tf_crop_and_resize is not supported")
    return _resize_impl(
        x, scales, sizes, _str_attr(attrs, "mode", "nearest"), coord_mode,
        _str_attr(attrs, "nearest_mode", "round_prefer_floor"),
        bool(attrs.get("exclude_outside", 0)),
    )


@register("Upsample", static=(1,))
def _upsample(ctx, inputs, attrs):
    """The deprecated opset-9 op: Resize with asymmetric coordinates and
    floor nearest."""
    x = as_tensor(ctx, get_input(inputs, 0))
    scales = opt_input(inputs, 1)
    if scales is None:
        scales = attrs.get("scales")
    scales = static_value(scales, "scales")
    return _resize_impl(x, scales, None, _str_attr(attrs, "mode", "nearest"), "asymmetric",
                        "floor", False)
