"""Pipeline parallelism (GPipe-style), forward only (the port of
``rten_tpu/parallel/pipeline.py``).

Stages are carved out of the same graph IR the rest of the port runs:

1. ``find_cut_values`` computes the dataflow DOMINATORS of the requested
   output w.r.t. the main input — the values every path from ``input_ids``
   to ``logits`` passes through (a transformer's residual stream).
2. ``plan_pipeline`` hashes the op-signature of each inter-cut segment and
   detects the repeating layer period, yielding prologue (embeddings),
   N isomorphic trunk layers, and epilogue (final norm + lm head); the
   trunk is grouped into ``n_stages`` equal superblocks. This planning half
   is numpy graph analysis, copied from the JAX package.
3. ``PipelineRunner.run`` executes the prologue (on every rank), the GPipe
   schedule and the epilogue, returning what ``Model.run`` returns. Rank s
   of the mesh axis runs stage s's own operators on its microbatch of each
   tick (M microbatches, M + S - 1 ticks); the activations move stage to
   stage by point-to-point sends, where the JAX package stacked the stage
   weights under ``shard_map`` and moved them with ``lax.ppermute``. The
   last stage's outputs are broadcast to every rank for the epilogue.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..ir.graph import Constant, Graph, NodeId, Operator, is_weight_constant


def find_cut_values(graph: Graph, main_id: NodeId, out_id: NodeId) -> List[NodeId]:
    """Topologically-ordered dataflow dominators of ``out_id``: values that
    every path from ``main_id`` passes through. Side inputs (masks, caches)
    are ignored — they re-enter each stage as auxiliary feeds."""
    producer: Dict[NodeId, Operator] = {}
    order: List[NodeId] = []  # value ids in plan (topological) order
    plan = graph.plan(list(graph.input_ids), [out_id], allow_missing_inputs=True)
    for op_id in plan:
        op = graph.nodes[op_id]
        for o in op.outputs:
            producer[o] = op
            order.append(o)

    # dom[v] = set of value ids on EVERY main->v path (v included); only
    # defined for values that depend on main at all.
    dom: Dict[NodeId, set] = {main_id: {main_id}}
    for vid in order:
        op = producer[vid]
        dep_doms = [dom[i] for i in op.inputs if i is not None and i in dom]
        if not dep_doms:
            continue
        inter = set(dep_doms[0])
        for d in dep_doms[1:]:
            inter &= d
        inter.add(vid)
        dom[vid] = inter
    if out_id not in dom:
        raise ValueError("output does not depend on the main input")
    pos = {vid: i for i, vid in enumerate(order)}
    cuts = sorted(dom[out_id] - {main_id}, key=lambda v: pos.get(v, -1))
    return [main_id] + cuts


def _segment_ops(graph: Graph, cut_in: NodeId, cut_out: NodeId) -> List[NodeId]:
    """Operator ids computing ``cut_out`` from ``cut_in`` + runtime inputs
    (side values like mask preprocessing are recomputed inside the segment
    — a few VPU ops per stage, irrelevant next to the matmuls)."""
    avail = [cut_in] + [i for i in graph.input_ids if i != cut_in]
    return graph.plan(avail, [cut_out])


def _attr_token(v) -> str:
    if isinstance(v, np.ndarray):
        return f"nd{v.shape}{v.dtype}:{hashlib.md5(v.tobytes()).hexdigest()[:8]}"
    return repr(v)


def _segment_signature(graph: Graph, ops: Sequence[NodeId]) -> str:
    """Structural hash of a segment: op types + attrs + weight shapes (NOT
    weight values or node ids — isomorphic layers must collide)."""
    parts = []
    for op_id in ops:
        op = graph.nodes[op_id]
        ws = []
        for i in op.inputs:
            n = graph.nodes.get(i) if i is not None else None
            if isinstance(n, Constant):
                ws.append(f"{n.array.shape}{n.array.dtype}")
        attrs = ",".join(
            f"{k}={_attr_token(v)}" for k, v in sorted(op.attrs.items())
        )
        parts.append(f"{op.op_type}({attrs})[{';'.join(ws)}]")
    return hashlib.md5("|".join(parts).encode()).hexdigest()


def _find_period(sigs: List[str]) -> Tuple[int, int, int]:
    """(start, period, reps) of the longest repeated signature block —
    the transformer trunk. Brute force: len(sigs) is O(layers * cuts/layer)."""
    n = len(sigs)
    best = (0, 1, 1)
    for p in range(1, n // 2 + 1):
        for s in range(0, n - 2 * p + 1):
            reps = 1
            while (
                s + (reps + 1) * p <= n
                and sigs[s + reps * p : s + (reps + 1) * p] == sigs[s : s + p]
            ):
                reps += 1
            if reps >= 2 and reps * p > best[1] * best[2]:
                best = (s, p, reps)
    return best


@dataclasses.dataclass
class PipelinePlan:
    boundaries: List[NodeId]          # n_stages+1 cut values (stage i: [i]->[i+1])
    weight_ids: List[List[NodeId]]    # per stage, first-use order
    staged_side: List[List[NodeId]]   # per-stage exclusive runtime inputs
    shared_side: List[NodeId]         # runtime inputs every stage consumes
    n_stages: int
    layers: int                       # trunk layers detected
    main_id: NodeId
    out_id: NodeId


def plan_pipeline(
    graph: Graph,
    n_stages: int,
    main_input: str = "input_ids",
    output: str = "logits",
) -> PipelinePlan:
    """Detect the repeating trunk and split it into ``n_stages`` isomorphic
    superblocks. Raises when the trunk layer count doesn't divide evenly
    (GPipe stacking needs identical stages)."""
    main_id = graph.find_node(main_input)
    out_id = graph.find_node(output)
    if main_id is None or out_id is None:
        raise ValueError(f"graph lacks '{main_input}' or '{output}'")
    cuts = find_cut_values(graph, main_id, out_id)
    if len(cuts) < 3:
        raise ValueError("no interior cut points — graph is not pipelineable")
    seg_ops = [
        _segment_ops(graph, cuts[i], cuts[i + 1]) for i in range(len(cuts) - 1)
    ]
    sigs = [_segment_signature(graph, ops) for ops in seg_ops]
    start, period, reps = _find_period(sigs)
    if reps < 2:
        raise ValueError("no repeating trunk detected")
    if reps % n_stages != 0:
        raise ValueError(
            f"{reps} trunk layers do not split into {n_stages} equal stages"
        )
    lps = reps // n_stages  # layers per stage
    boundaries = [
        cuts[start + s * lps * period] for s in range(n_stages + 1)
    ]

    input_set = set(graph.input_ids)
    weight_ids: List[List[NodeId]] = []
    side_ids: List[List[NodeId]] = []
    lit_sigs: List[List[bytes]] = []
    for s in range(n_stages):
        ops: List[NodeId] = []
        for li in range(lps * period):
            ops.extend(seg_ops[start + s * lps * period + li])
        ws, sides, lits = [], [], []
        seen_w, seen_s = set(), set()
        for op_id in ops:
            op = graph.nodes[op_id]
            for i in op.inputs:
                if i is None or i == boundaries[s]:
                    continue
                n = graph.nodes.get(i)
                if isinstance(n, Constant) and is_weight_constant(n):
                    if i not in seen_w:
                        seen_w.add(i)
                        ws.append(i)
                elif isinstance(n, Constant):
                    # Small constants embed as trace-time literals from
                    # STAGE 0's trace — they must be value-identical across
                    # stages (shape vectors, eps scalars are; a per-layer
                    # small constant would silently reuse layer 0's).
                    lits.append(n.array.tobytes())
                elif i in input_set and i != main_id and i not in seen_s:
                    seen_s.add(i)
                    sides.append(i)
        weight_ids.append(ws)
        side_ids.append(sides)
        lit_sigs.append(lits)
    if any(l != lit_sigs[0] for l in lit_sigs[1:]):
        raise ValueError(
            "stages embed differing small constants — cannot share one "
            "stage trace (promote them to weight constants)"
        )

    # Positional classification: same id in every stage -> shared feed;
    # all-distinct -> per-stage (stacked, e.g. per-layer KV inputs).
    n_side = {len(s) for s in side_ids}
    if len(n_side) != 1:
        raise ValueError("stages consume differing side-input counts")
    shared, staged = [], [[] for _ in range(n_stages)]
    for j in range(n_side.pop()):
        col = [side_ids[s][j] for s in range(n_stages)]
        if all(c == col[0] for c in col):
            shared.append(col[0])
        elif len(set(col)) == n_stages:
            for s in range(n_stages):
                staged[s].append(col[s])
        else:
            raise ValueError(
                "side input shared by SOME stages only — unsupported split"
            )
    # Homogeneity: stacked weights must agree positionally.
    for j in range(len(weight_ids[0])):
        shapes = {
            (graph.nodes[weight_ids[s][j]].array.shape,
             graph.nodes[weight_ids[s][j]].array.dtype.name)
            for s in range(n_stages)
        }
        if len(shapes) != 1:
            raise ValueError(f"stage weights diverge at position {j}: {shapes}")
    return PipelinePlan(
        boundaries=boundaries,
        weight_ids=weight_ids,
        staged_side=staged,
        shared_side=shared,
        n_stages=n_stages,
        layers=reps,
        main_id=main_id,
        out_id=out_id,
    )


class PipelineRunner:
    """Run a Model pipeline-parallel over ``mesh``'s ``axis`` (one rank a
    stage; every rank calls ``run`` with the same feed).

    ``n_micro`` microbatches must divide the batch; the trunk layer count
    must divide the axis size. Outputs match ``Model.run`` numerically
    (same ops, same order — only the partitioning differs). Forward only.
    """

    def __init__(self, model, mesh, axis: str = "model", n_micro: int = 2,
                 main_input: str = "input_ids", output: str = "logits"):
        self.model = model
        self.g = model.graph
        self.executor = model.executor
        self.mesh = mesh
        self.axis = axis
        self.n_micro = n_micro
        self.plan = plan_pipeline(self.g, mesh.shape[axis], main_input, output)
        self.stage = mesh.coords[axis]

    def _send(self, t: torch.Tensor, to: int, group):
        import torch.distributed as dist

        staged = t.device.type == "cuda" and dist.get_backend(group) == "gloo"
        return dist.isend((t.cpu() if staged else t).contiguous(), to, group)

    def _recv(self, like: torch.Tensor, frm: int, group) -> torch.Tensor:
        import torch.distributed as dist

        staged = like.device.type == "cuda" and dist.get_backend(group) == "gloo"
        buf = torch.empty(like.shape, dtype=like.dtype,
                          device="cpu" if staged else like.device)
        dist.recv(buf, frm, group)
        return buf.to(like.device)

    def run(self, feed: Dict[str, Any]):
        """``feed``: {input name: array} covering every graph input. Returns
        the pipeline output (same value Model.run would produce)."""
        import torch.distributed as dist

        g, p, M, S = self.g, self.plan, self.n_micro, self.plan.n_stages
        s = self.stage
        group = self.mesh.group(self.axis)
        ranks = dist.get_process_group_ranks(group)
        env = {g.find_node(k): v for k, v in feed.items()}
        B = np.shape(env[p.main_id])[0]
        if B % M:
            raise ValueError(f"batch {B} not divisible by {M} microbatches")
        mb = B // M

        # Prologue (embeddings), on every rank.
        x = self.executor.run(dict(env), [p.boundaries[0]])[0]

        def micro(m):
            """The feed of stage s's operators for microbatch m: every
            input whose leading axis is the batch cut to the microbatch."""
            out = {}
            for nid, v in env.items():
                if nid == p.main_id:
                    continue
                if np.ndim(v) and np.shape(v)[0] == B:
                    v = v[m * mb:(m + 1) * mb]
                out[nid] = v
            return out

        outs: List[torch.Tensor] = []
        pending = []
        for t in range(M + S - 1):
            m = t - s
            if not 0 <= m < M:
                continue
            like = x[m * mb:(m + 1) * mb]
            inp = like if s == 0 else self._recv(like, ranks[s - 1], group)
            step = micro(m)
            step[p.boundaries[s]] = inp
            y = self.executor.run(step, [p.boundaries[s + 1]])[0]
            if s < S - 1:
                pending.append(self._send(y, ranks[s + 1], group))
            else:
                outs.append(y)
        for req in pending:
            req.wait()
        # The last stage holds the trunk's output: every rank gets it.
        if s == S - 1:
            y = torch.cat(outs)
        else:
            y = torch.empty((B,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        staged = y.device.type == "cuda" and dist.get_backend(group) == "gloo"
        buf = y.cpu() if staged else y
        dist.broadcast(buf, ranks[S - 1], group)
        env[p.boundaries[-1]] = buf.to(x.device)

        # Epilogue: final norm + head from the trunk-end value.
        return self.executor.run(env, [p.out_id])[0]
