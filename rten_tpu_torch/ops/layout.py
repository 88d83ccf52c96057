"""Layout and shape ops (the port of ``rten_tpu/ops/layout.py``, all 26:
Identity through OneHot).

Shape-carrying inputs (Reshape targets, Slice bounds, Expand shapes, Range
limits, ...) must be host values (``registry.static_value``); Shape and
Size return numpy int32 arrays, so the chains that compute them stay on
the host (see ``runtime/executor.py``). Reshape, Transpose, Squeeze,
Unsqueeze, Expand and positive-step Slices return views where PyTorch can.
"""

from __future__ import annotations

import numpy as np
import torch

from ..dtypes import DataType
from .elementwise import promote
from .registry import OpError, as_tensor, get_input, opt_input, register, static_value


def _opt_static(x, default=None):
    return default if x is None else static_value(x)


@register("Identity")
def _identity(ctx, inputs, attrs):
    return get_input(inputs, 0)


@register("Dropout")
def _dropout(ctx, inputs, attrs):
    """Inference mode: the identity (no mask output, as in the JAX package)."""
    return get_input(inputs, 0)


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


@register("Flatten")
def _flatten(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    axis = attrs.get("axis", 1)
    if axis < 0:
        axis += x.ndim
    lead = int(np.prod(x.shape[:axis])) if axis > 0 else 1
    return x.reshape(lead, -1)


@register("Transpose")
def _transpose(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    perm = attrs.get("perm")
    if perm is None:
        perm = list(reversed(range(x.ndim)))
    return x.permute(*perm)


@register("Squeeze")
def _squeeze(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    axes = opt_input(inputs, 1, attrs.get("axes"))
    if axes is None:
        return x.reshape([d for d in x.shape if d != 1])
    axes = {int(a) % x.ndim for a in np.atleast_1d(static_value(axes, "axes"))}
    for a in axes:
        if x.shape[a] != 1:
            raise OpError(f"cannot squeeze axis {a} of size {x.shape[a]}")
    return x.reshape([d for i, d in enumerate(x.shape) if i not in axes])


@register("Unsqueeze")
def _unsqueeze(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    axes = opt_input(inputs, 1, attrs.get("axes"))
    axes = np.atleast_1d(static_value(axes, "axes")).astype(int)
    out_ndim = x.ndim + len(axes)
    for a in sorted(int(a) % out_ndim for a in axes):
        x = x.unsqueeze(a)
    return x


@register("Expand")
def _expand(ctx, inputs, attrs):
    """Bidirectional broadcast: each output dim is the larger of the input's
    and the requested one."""
    x = as_tensor(ctx, get_input(inputs, 0))
    shape = static_value(get_input(inputs, 1, "shape"), "shape").astype(int).tolist()
    ndim = max(x.ndim, len(shape))
    in_shape = (1,) * (ndim - x.ndim) + tuple(x.shape)
    shape = [1] * (ndim - len(shape)) + list(shape)
    out_shape = [max(a, b) for a, b in zip(in_shape, shape)]
    return x.reshape(in_shape).expand(out_shape)


@register("Tile")
def _tile(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    reps = static_value(get_input(inputs, 1, "repeats"), "repeats").astype(int).tolist()
    reps = [1] * (x.ndim - len(reps)) + reps  # jnp.tile pads the repeats with 1s
    return x.repeat(*reps)


def _slice_axis(x: torch.Tensor, ax: int, st: int, en: int, sp: int) -> torch.Tensor:
    """``x[..., st:en:sp, ...]`` on axis ``ax`` with Python's (and numpy's)
    semantics, negative steps included (a flip, then a positive step)."""
    r = range(*slice(st, en, sp).indices(x.shape[ax]))
    if len(r) == 0:
        return x.narrow(ax, 0, 0)
    idx = [slice(None)] * x.ndim
    if sp > 0:
        idx[ax] = slice(r.start, r.stop, sp)
        return x[tuple(idx)]
    idx[ax] = slice(r[-1], r[0] + 1)
    seg = torch.flip(x[tuple(idx)], [ax])
    idx[ax] = slice(None, None, -sp)
    return seg[tuple(idx)]


@register("Slice")
def _slice(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    if len(inputs) > 1 and inputs[1] is not None:
        starts = static_value(inputs[1], "starts").astype(np.int64)
        ends = static_value(get_input(inputs, 2, "ends"), "ends").astype(np.int64)
        axes = _opt_static(opt_input(inputs, 3))
        steps = _opt_static(opt_input(inputs, 4))
    else:  # opset < 10: attributes
        starts = np.asarray(attrs["starts"], dtype=np.int64)
        ends = np.asarray(attrs["ends"], dtype=np.int64)
        axes = attrs.get("axes")
        steps = None
    starts = np.atleast_1d(starts)
    ends = np.atleast_1d(ends)
    if axes is None:
        axes = np.arange(len(starts))
    axes = np.atleast_1d(np.asarray(axes, dtype=np.int64))
    if steps is None:
        steps = np.ones(len(starts), dtype=np.int64)
    steps = np.atleast_1d(np.asarray(steps, dtype=np.int64))
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        ax = int(ax) % x.ndim
        st, en, sp = int(st), int(en), int(sp)
        dim = x.shape[ax]
        # Clamp the INT64 sentinels used for "to the end", as the JAX
        # lowering does.
        st = min(max(st, -dim), dim)
        en = min(max(en, -dim - 1), dim)
        x = _slice_axis(x, ax, st, en, sp)
    return x


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


@register("Concat")
def _concat(ctx, inputs, attrs):
    vals = promote(*(as_tensor(ctx, v) for v in inputs if v is not None))
    return torch.cat(vals, dim=attrs.get("axis", 0))


@register("Pad")
def _pad(ctx, inputs, attrs):
    """constant, reflect, edge and wrap modes, as ``jnp.pad``; negative pads
    crop first."""
    x = as_tensor(ctx, get_input(inputs, 0))
    pads = opt_input(inputs, 1, attrs.get("pads"))
    pads = np.atleast_1d(static_value(pads, "pads")).astype(int)
    cval = opt_input(inputs, 2, attrs.get("value", 0.0))
    axes = opt_input(inputs, 3)
    mode = attrs.get("mode", "constant")
    if isinstance(mode, bytes):
        mode = mode.decode()
    n = x.ndim
    full = np.zeros((n, 2), dtype=int)
    if axes is not None:
        axes = np.atleast_1d(static_value(axes, "axes")).astype(int)
        k = len(axes)
        for i, ax in enumerate(axes):
            full[int(ax) % n] = (pads[i], pads[i + k])
    else:
        for i in range(n):
            full[i] = (pads[i], pads[i + n])
    if np.any(full < 0):
        x = x[tuple(slice(-min(lo, 0), x.shape[i] + min(hi, 0))
                    for i, (lo, hi) in enumerate(full))]
        full = np.maximum(full, 0)
    if mode == "constant":
        if cval is None:
            cval = 0.0
        out_shape = [d + lo + hi for d, (lo, hi) in zip(x.shape, full)]
        out = as_tensor(ctx, cval).to(device=x.device, dtype=x.dtype).reshape(())
        out = out.expand(out_shape).clone()
        out[tuple(slice(lo, lo + d) for d, (lo, _) in zip(x.shape, full))] = x
        return out
    np_mode = {"reflect": "reflect", "edge": "edge", "wrap": "wrap"}[mode]
    for ax, (lo, hi) in enumerate(full):
        if lo or hi:
            idx = np.pad(np.arange(x.shape[ax]), (int(lo), int(hi)), mode=np_mode)
            x = x.index_select(ax, torch.as_tensor(idx, device=x.device))
    return x


@register("Trilu")
def _trilu(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    k = int(_opt_static(opt_input(inputs, 1), 0))
    return torch.triu(x, k) if attrs.get("upper", 1) else torch.tril(x, k)


@register("DepthToSpace")
def _depth_to_space(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    b = attrs["blocksize"]
    mode = attrs.get("mode", "DCR")
    if isinstance(mode, bytes):
        mode = mode.decode()
    N, C, H, W = x.shape
    if mode == "DCR":
        x = x.reshape(N, b, b, C // (b * b), H, W).permute(0, 3, 4, 1, 5, 2)
    else:  # CRD
        x = x.reshape(N, C // (b * b), b, b, H, W).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(N, C // (b * b), H * b, W * b)


@register("SpaceToDepth")
def _space_to_depth(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    b = attrs["blocksize"]
    N, C, H, W = x.shape
    x = x.reshape(N, C, H // b, b, W // b, b).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(N, C * b * b, H // b, W // b)


@register("ReverseSequence")
def _reverse_sequence(ctx, inputs, attrs):
    """out[b, t] = x[b, L_b - 1 - t] for t < L_b, else x[b, t]."""
    x = as_tensor(ctx, get_input(inputs, 0))
    lens = as_tensor(ctx, get_input(inputs, 1, "sequence_lens")).to(torch.int64)
    batch_axis = attrs.get("batch_axis", 1)
    time_axis = attrs.get("time_axis", 0)
    xt = x.movedim((batch_axis, time_axis), (0, 1))
    t = torch.arange(xt.shape[1], device=x.device)[None, :]
    L = lens.to(x.device)[:, None]
    src = torch.where(t < L, L - 1 - t, t)  # [B, T]
    src = src.reshape(src.shape + (1,) * (xt.ndim - 2)).expand(xt.shape)
    return torch.gather(xt, 1, src).movedim((0, 1), (batch_axis, time_axis))


# ---- shape queries and generators -------------------------------------------


@register("Shape")
def _shape(ctx, inputs, attrs):
    x = get_input(inputs, 0)
    shape = np.asarray(tuple(x.shape), dtype=np.int32)
    n = len(shape)
    start = attrs.get("start", 0)
    end = attrs.get("end")
    start = max(start + n, 0) if start < 0 else min(start, n)
    if end is None:
        end = n
    end = max(end + n, 0) if end < 0 else min(end, n)
    return shape[start:end]


@register("Size")
def _size(ctx, inputs, attrs):
    x = get_input(inputs, 0)
    return np.asarray(int(np.prod(tuple(x.shape))), dtype=np.int32)


@register("Cast")
def _cast(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    to = attrs["to"]
    if not isinstance(to, DataType):
        to = DataType.from_np(np.dtype(to))
    return x.to(to.torch_dtype)


@register("CastLike")
def _cast_like(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    return x.to(as_tensor(ctx, get_input(inputs, 1, "target_type")).dtype)


@register("Constant")
def _constant(ctx, inputs, attrs):
    """An ONNX Constant node (the optimizer folds them; this runs them in an
    unoptimized graph): a host value."""
    for key in ("value", "value_float", "value_int", "value_floats", "value_ints"):
        if key in attrs:
            v = np.asarray(attrs[key])
            if key in ("value_int", "value_ints"):
                v = v.astype(np.int32)
            if key in ("value_float", "value_floats"):
                v = v.astype(np.float32)
            return v
    raise OpError("Constant node has no value attribute")


@register("ConstantOfShape")
def _constant_of_shape(ctx, inputs, attrs):
    shape = static_value(get_input(inputs, 0, "shape"), "shape").astype(int)
    value = attrs.get("value")
    value = np.zeros(1, np.float32) if value is None else np.asarray(value)
    return torch.full(tuple(shape.tolist()), value.reshape(-1)[0].item(),
                      dtype=DataType.from_np(value.dtype).torch_dtype, device=ctx.device)


@register("EyeLike")
def _eye_like(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    k = attrs.get("k", 0)
    dtype = attrs.get("dtype")
    dtype = x.dtype if dtype is None else (
        dtype if isinstance(dtype, DataType) else DataType.from_np(np.dtype(dtype))
    ).torch_dtype
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    cols = torch.arange(x.shape[1], device=x.device)[None, :]
    return (cols - rows == k).to(dtype)


@register("Range")
def _range(ctx, inputs, attrs):
    start = static_value(get_input(inputs, 0, "start"), "start")
    limit = static_value(get_input(inputs, 1, "limit"), "limit")
    delta = static_value(get_input(inputs, 2, "delta"), "delta")
    return torch.as_tensor(
        np.arange(start.item(), limit.item(), delta.item(), dtype=start.dtype),
        device=ctx.device,
    )


@register("OneHot")
def _one_hot(ctx, inputs, attrs):
    """jax.nn.one_hot(indices % depth) scaled to values [off, on]."""
    indices = as_tensor(ctx, get_input(inputs, 0, "indices"))
    depth = int(static_value(get_input(inputs, 1, "depth"), "depth").reshape(()))
    values = as_tensor(ctx, get_input(inputs, 2, "values"))
    axis = attrs.get("axis", -1)
    idx = torch.remainder(indices.to(torch.int64), depth)
    oh = (idx.unsqueeze(-1) == torch.arange(depth, device=idx.device)).to(values.dtype)
    if axis < 0:
        axis += oh.ndim
    oh = oh.movedim(-1, axis)
    off, on = values[0], values[1]
    return oh * (on - off) + off
