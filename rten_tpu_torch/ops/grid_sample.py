"""GridSample (the port of ``rten_tpu/ops/grid_sample.py``; rten
src/ops/grid_sample.rs:335): 4-D bilinear or nearest sampling.

x [N, C, H, W], grid [N, Ho, Wo, 2] of normalized coordinates in [-1, 1]
(x, then y). The JAX package's arithmetic, step for step: unnormalize,
clamp (border) or reflect (reflection, in continuous coordinates), then
gathers at the integer corners, zeroed outside the input under zeros
padding. ``F.grid_sample`` rounds nearest coordinates half to even where
the JAX op takes floor(x + 0.5), and reflects in another order, so it is
not used.
"""

from __future__ import annotations

import torch

from .registry import OpError, as_tensor, get_input, register


def _unnormalize(coord, size, align_corners):
    if align_corners:
        return (coord + 1) * (size - 1) / 2
    return ((coord + 1) * size - 1) / 2


def _reflect(coord, size, align_corners):
    """Reflection padding in continuous coordinates."""
    if align_corners:
        span = 2 * (size - 1)
        if span == 0:
            return torch.zeros_like(coord)
        c = torch.remainder(coord.abs(), span)
        return torch.where(c > size - 1, span - c, c)
    span = 2 * size
    c = torch.remainder((coord + 0.5).abs(), span)
    c = torch.where(c > size, span - c, c) - 0.5
    return torch.clamp(c, 0, size - 1)


def _str_attr(attrs, name, default):
    v = attrs.get(name, default)
    return v.decode() if isinstance(v, bytes) else v


@register("GridSample")
def _grid_sample(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    grid = as_tensor(ctx, get_input(inputs, 1, "grid"))
    if x.ndim != 4:
        raise OpError("GridSample: only 4D inputs supported")
    mode = _str_attr(attrs, "mode", "linear")
    if mode == "bilinear":
        mode = "linear"
    padding = _str_attr(attrs, "padding_mode", "zeros")
    align = bool(attrs.get("align_corners", 0))

    N, C, H, W = x.shape
    gx = _unnormalize(grid[..., 0].to(torch.float32), W, align)  # [N, Ho, Wo]
    gy = _unnormalize(grid[..., 1].to(torch.float32), H, align)
    if padding == "border":
        gx = torch.clamp(gx, 0, W - 1)
        gy = torch.clamp(gy, 0, H - 1)
    elif padding == "reflection":
        gx = _reflect(gx, W, align)
        gy = _reflect(gy, H, align)
    flat = x.reshape(N, C, H * W)

    def gather(ix, iy):
        """x at integer (iy, ix) [N, Ho, Wo] -> [N, C, Ho, Wo]."""
        idx = (iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)).reshape(N, 1, -1)
        vals = torch.gather(flat, 2, idx.expand(N, C, idx.shape[-1]))
        vals = vals.reshape(N, C, *ix.shape[1:])
        if padding == "zeros":
            inside = (ix >= 0) & (ix <= W - 1) & (iy >= 0) & (iy <= H - 1)
            vals = vals * inside[:, None].to(vals.dtype)
        return vals

    if mode == "nearest":
        return gather(torch.floor(gx + 0.5).to(torch.int64), torch.floor(gy + 0.5).to(torch.int64))
    if mode != "linear":
        raise OpError(f"GridSample mode {mode} not supported")
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    fx = (gx - x0)[:, None]
    fy = (gy - y0)[:, None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    out = (
        gather(x0i, y0i) * (1 - fx) * (1 - fy)
        + gather(x0i + 1, y0i) * fx * (1 - fy)
        + gather(x0i, y0i + 1) * (1 - fx) * fy
        + gather(x0i + 1, y0i + 1) * fx * fy
    )
    return out.to(x.dtype)
