"""Collectives as operators: what XLA's GSPMD inserted into the JAX
package's sharded programs, written into a rank-local graph by
``rten_tpu_torch/parallel/partition.py``.

The JAX package annotates weights with shardings and lets XLA partition the
program (``rten_tpu/parallel/sharding.py:1-11``). The port runs one graph a
rank instead, and these ops move values between the ranks of one mesh axis:

* ``AllReduce`` {reduce: sum | min | max, group}: the element-wise reduction
  over the group (after a row-parallel product, on its int32 accumulator for
  ``MatMulIntegerToFloat``; after an expert-parallel MoE's partial combine).
* ``AllGather`` {axis, group, sizes}: the shards concatenated along ``axis``
  in rank order; ``sizes`` (optional) gives each rank's length where they
  differ (a padded lm_head's last shard), every shard sent at the largest.
* ``ShardedDynamicQuantizeLinear`` {group}: DynamicQuantizeLinear of a
  tensor sharded over the group: one all-reduce of (-min, max), then the
  per-tensor u8 scale and zero point of the whole tensor, so every rank
  quantizes its shard exactly as the unsharded op would.
* ``ShardedArgMax`` {axis = -1, keepdims, group, offset}: the arg-max of a
  vocabulary-sharded last axis: the local arg-max (the argmax kernel on the
  card), then a gather of (value, global index) from every rank; the
  largest value wins, ties to the lowest global index, as ``jnp.argmax``
  breaks them. Every rank returns the same token.

``group`` names a process group that ``register_group`` recorded (the
mesh does, one name an axis). With the gloo backend a card tensor is staged
through host memory explicitly (a copy to the host, the collective, a copy
back); NCCL takes card tensors as they are. ``STATS`` counts each kind's
calls and their host seconds (the staging copies included), for the
serving phase's report.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from ..kernels.argmax import argmax_lastdim
from .quantize import dynamic_quantize
from .registry import OpError, as_tensor, get_input, register

_GROUPS: Dict[str, object] = {}

# {kind: [calls, host seconds]}
STATS: Dict[str, List[float]] = {}


def register_group(key: str, group) -> None:
    """Record ``group`` (a torch.distributed process group) under ``key``,
    the name a local graph's collective ops carry."""
    _GROUPS[key] = group


def group_of(key: str):
    """The process group registered under ``key``."""
    if key not in _GROUPS:
        raise OpError(f"no process group '{key}' is registered on this rank "
                      f"(make the mesh with rten_tpu_torch.parallel.make_mesh)")
    return _GROUPS[key]


def reset_stats() -> None:
    STATS.clear()


def _count(kind: str, t0: float) -> None:
    s = STATS.setdefault(kind, [0, 0.0])
    s[0] += 1
    s[1] += time.perf_counter() - t0


def _staged(t: torch.Tensor, group) -> bool:
    import torch.distributed as dist

    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, reduce: str, group) -> torch.Tensor:
    """``t`` reduced element-wise over ``group`` (a new tensor)."""
    import torch.distributed as dist

    op = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}[reduce]
    t0 = time.perf_counter()
    staged = _staged(t, group)
    buf = t.cpu() if staged else t.clone()
    dist.all_reduce(buf, op=op, group=group)
    out = buf.to(t.device) if staged else buf
    _count("all_reduce", t0)
    return out


def all_gather(t: torch.Tensor, axis: int, group, sizes=None) -> torch.Tensor:
    """The group's shards of ``t`` concatenated along ``axis`` in rank
    order; ``sizes``: each rank's length along ``axis`` where they differ."""
    import torch.distributed as dist

    axis = axis % t.ndim
    n = dist.get_world_size(group)
    full = max(sizes) if sizes else t.shape[axis]
    t0 = time.perf_counter()
    x = t
    if x.shape[axis] < full:
        pad = list(x.shape)
        pad[axis] = full - x.shape[axis]
        x = torch.cat([x, x.new_zeros(pad)], dim=axis)
    staged = _staged(x, group)
    x = (x.cpu() if staged else x).contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    if sizes:
        parts = [p.narrow(axis, 0, s) for p, s in zip(parts, sizes)]
    out = torch.cat(parts, dim=axis)
    out = out.to(t.device) if staged else out
    _count("all_gather", t0)
    return out


@register("AllReduce")
def _all_reduce(ctx, inputs, attrs):
    return all_reduce(as_tensor(ctx, get_input(inputs, 0)), attrs.get("reduce", "sum"),
                      group_of(attrs.get("group")))


@register("AllGather")
def _all_gather(ctx, inputs, attrs):
    return all_gather(as_tensor(ctx, get_input(inputs, 0)), int(attrs.get("axis", -1)),
                      group_of(attrs.get("group")), attrs.get("sizes"))


@register("ShardedDynamicQuantizeLinear")
def _sharded_dql(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    lo, hi = torch.aminmax(x)
    both = all_reduce(torch.stack([-lo, hi]), "max", group_of(attrs.get("group")))
    return dynamic_quantize(x, (-both[0], both[1]))


def sharded_argmax(x: torch.Tensor, offset: int, group) -> torch.Tensor:
    """Global first-occurrence arg-max (int32) of the last axis of ``x``,
    a rank's shard that starts at global column ``offset``."""
    rows = x.reshape(-1, x.shape[-1])
    if rows.dtype == torch.float32:
        idx = argmax_lastdim(rows.contiguous()).to(torch.int64)
    else:
        idx = torch.argmax(rows, dim=-1)
    val = rows.gather(1, idx[:, None])[:, 0].to(torch.float64)
    pair = torch.stack([val, (idx + offset).to(torch.float64)])  # exact in f64
    everyone = all_gather(pair[None], 0, group)                   # [ranks, 2, M]
    vals, gidx = everyone[:, 0], everyone[:, 1]
    best = vals.max(dim=0).values
    # Ranks hold increasing column ranges, so the first rank holding the
    # maximum holds its lowest index.
    first = (vals == best).to(torch.int32).argmax(dim=0)
    out = gidx.gather(0, first[None])[0]
    return out.to(torch.int32).reshape(x.shape[:-1])


@register("ShardedArgMax")
def _sharded_argmax(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    if attrs.get("axis", -1) % x.ndim != x.ndim - 1:
        raise OpError("ShardedArgMax reduces the last axis only")
    idx = sharded_argmax(x, int(attrs.get("offset", 0)), group_of(attrs.get("group")))
    return idx.unsqueeze(-1) if attrs.get("keepdims", 1) else idx
