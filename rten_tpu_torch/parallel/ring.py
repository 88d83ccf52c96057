"""Ring attention: context-parallel attention over a sequence-sharded mesh
axis (the port of ``rten_tpu/parallel/ring.py``; Liu et al. 2023's
blockwise ring).

Each rank holds one sequence chunk of Q, K and V; the K/V chunks travel
around the ring by point-to-point sends (``torch.distributed.isend`` /
``irecv`` where the JAX package used ``lax.ppermute``) while each rank
accumulates its Q chunk's online softmax against every chunk. The JAX
function is plain jnp with no Pallas kernel, so this port is plain torch.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..kernels.flash_attention import NEG_INF


def _rotate(t: torch.Tensor, group, send_to: int, recv_from: int) -> torch.Tensor:
    """Send ``t`` to global rank ``send_to``, receive its like from
    ``recv_from`` (a card tensor goes through host memory under gloo)."""
    import torch.distributed as dist

    staged = t.device.type == "cuda" and dist.get_backend(group) == "gloo"
    src = (t.cpu() if staged else t).contiguous()
    dst = torch.empty_like(src)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, src, send_to, group),
                                   dist.P2POp(dist.irecv, dst, recv_from, group)])
    for r in reqs:
        r.wait()
    return dst.to(t.device) if staged else dst


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   axis: str = "model", *, causal: bool = True,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Attention over [B, H, T, D] inputs with T sharded over ``axis``.

    Every rank passes the global q, k, v (replicated, or host arrays) and
    gets the global output; each computes its own chunk of T and the chunks
    are gathered at the end. T must divide by the axis size. GQA accepted
    (K/V heads divide Q heads)."""
    import torch.distributed as dist

    from ..ops.collective import all_gather

    q, k, v = (torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x,
                               device=mesh.device) for x in (q, k, v))
    B, Hq, T, D = q.shape
    Hkv = k.shape[1]
    S = mesh.shape[axis]
    if T % S:
        raise ValueError(f"sequence {T} not divisible by {S} ring devices")
    if scale is None:
        scale = 1.0 / float(np.sqrt(D))
    group = mesh.group(axis)
    idx = mesh.coords[axis]
    ranks = dist.get_process_group_ranks(group)
    Tl = T // S
    mine = slice(idx * Tl, (idx + 1) * Tl)
    qf = q[:, :, mine].to(torch.float32)
    k_c = k[:, :, mine].to(torch.float32).repeat_interleave(Hq // Hkv, dim=1)
    v_c = v[:, :, mine].to(torch.float32).repeat_interleave(Hq // Hkv, dim=1)
    q_pos = idx * Tl + torch.arange(Tl, device=q.device)

    m = torch.full((B, Hq, Tl, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Hq, Tl, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hq, Tl, D), dtype=torch.float32, device=q.device)
    for s in range(S):
        # After s rotations this rank holds global chunk (idx - s).
        j = (idx - s) % S
        scores = torch.einsum("bhqd,bhkd->bhqk", qf, k_c) * scale
        if causal:
            k_pos = j * Tl + torch.arange(Tl, device=q.device)
            scores = torch.where(k_pos[None, None, None, :] <= q_pos[None, None, :, None],
                                 scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        p = torch.exp(scores - m_new)
        p = torch.where(m_new <= NEG_INF / 2, 0.0, p)
        alpha = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(m - m_new))
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p, v_c)
        m = m_new
        if s + 1 < S:
            nxt, prv = ranks[(idx + 1) % S], ranks[(idx - 1) % S]
            k_c = _rotate(k_c, group, nxt, prv)
            v_c = _rotate(v_c, group, nxt, prv)
    l = torch.where(l == 0.0, 1.0, l)
    out = (acc / l).to(q.dtype)
    return all_gather(out, 2, group)
