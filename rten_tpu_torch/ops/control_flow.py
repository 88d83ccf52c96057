"""Control flow: If, Loop (the port of ``rten_tpu/ops/control_flow.py``;
rten ``src/ops/control_flow.rs``, subgraph operators with name-based
captures, src/graph.rs:212-219).

The port runs eagerly, as the JAX package does outside jit: an If reads
its condition on the host (one device-to-host read for a card tensor, none
for a host value such as a static ``use_cache_branch``) and runs only the
taken branch; a Loop reads its trip count once and its condition after
each iteration, and runs the body once an iteration (the JAX package's
concrete unroll), the iteration counter and condition fed as host values.
Branches and bodies run through ``ctx.run_subgraph`` on the executor's
device, and may change shapes from one run or iteration to the next.
"""

from __future__ import annotations

import numpy as np
import torch

from .registry import OpError, as_tensor, get_input, host_value, opt_input, register


def _outputs(outs):
    return tuple(outs) if len(outs) > 1 else outs[0]


@register("If")
def _if(ctx, inputs, attrs):
    cond = get_input(inputs, 0, "cond")
    then_g = attrs.get("then_branch")
    else_g = attrs.get("else_branch")
    if then_g is None or else_g is None:
        raise OpError("If requires then_branch and else_branch subgraphs")
    taken = then_g if bool(host_value(cond).reshape(())) else else_g
    return _outputs(ctx.run_subgraph(taken, []))


def _stack(ctx, values):
    """A Loop's scan output: its iterations' values stacked on axis 0 (a
    host value when every one is)."""
    if all(isinstance(v, np.ndarray) for v in values):
        return np.stack(values, axis=0)
    return torch.stack([as_tensor(ctx, v) for v in values], dim=0)


@register("Loop")
def _loop(ctx, inputs, attrs):
    body = attrs.get("body")
    if body is None:
        raise OpError("Loop requires a body subgraph")
    max_trip = opt_input(inputs, 0)
    cond_init = opt_input(inputs, 1)
    deps = list(inputs[2:])
    n_deps = len(deps)
    n_scan = len(body.output_ids) - 1 - n_deps  # body outputs: cond, deps..., scans...

    trip = int(host_value(max_trip).reshape(())) if max_trip is not None else None
    cond = bool(host_value(cond_init).reshape(())) if cond_init is not None else True
    scans = [[] for _ in range(n_scan)]
    i = 0
    while cond and (trip is None or i < trip):
        outs = ctx.run_subgraph(body, [np.asarray(i, np.int32), np.asarray(cond)] + deps)
        cond = bool(host_value(outs[0]).reshape(()))
        deps = list(outs[1:1 + n_deps])
        for s in range(n_scan):
            scans[s].append(outs[1 + n_deps + s])
        i += 1
        if trip is None and i > 10_000_000:
            raise OpError("Loop ran more than 1e7 iterations")
    scan_outs = [_stack(ctx, s) if s else np.zeros((0,), np.float32) for s in scans]
    return _outputs(deps + scan_outs)
