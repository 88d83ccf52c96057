"""Attention: the wrappers of the CUDA kernels in ``csrc/flash_attention.cu``,
``csrc/decode_mha.cu`` (bf16 caches: ``csrc/decode_mha_bf16.cu``),
``csrc/paged_decode_mha.cu`` (bf16 pools: ``csrc/paged_decode_mha_bf16.cu``)
and ``csrc/mha.cu``, and their plain PyTorch versions.

* ``mha`` (``csrc/mha.cu``) replaces
  ``rten_tpu/kernels/flash_attention.py:mha_pallas``: flash attention of
  q [B,Hq,Tq,D] over whole K/V [B,Hkv,Tk,D] (f32 or bf16), an optional 2-D
  additive mask, softcap, causal anchored at the KV end; ``mha_plain`` is
  the reference's ``mha_xla``. The Attention ops route between the two
  (``ops/attention.py:_attend``).
* ``decode_mha`` replaces ``rten_tpu/kernels/flash_attention.py:decode_mha``
  and its ``_decode_mha_folded``: S query rows per slot over head-major
  caches ``[B, Hkv, cap, D]``, s8 with scales ``[B, Hkv, cap]``, f32 or
  bf16 (``csrc/decode_mha_bf16.cu``). Two launch forms, each with its own
  launch counter: ``decode_mha_folded`` (every decode step) and
  ``decode_mha_heads`` (every admission).
* ``decode_mha_append_cat`` replaces
  ``rten_tpu/kernels/flash_attention.py:decode_mha_append_cat``: one decode
  step that writes the new K/V row in place at row ``min(lens[b], cap -
  1)`` (s8 caches: quantized, with its scale; f32/bf16: rounded to the
  cache dtype) and attends rows ``<= lens[b]``.
  With ``block_table`` (``decode_mha_append_cat_paged``, its own launch
  counter) the caches are block pools read and written through the table.
* ``prefill_mha_cat`` replaces
  ``rten_tpu/kernels/flash_attention.py:prefill_mha_cat``: prefill off
  caches that already hold the chunk's rows; row r attends ``<= lens[b]+r``.
* ``paged_decode_mha`` (``csrc/paged_decode_mha.cu``) replaces
  ``rten_tpu/kernels/flash_attention.py:paged_decode_mha``: a decode step
  over head-major block pools ``[NB, Hkv, BS, D]`` (s8, f32 or bf16) through
  a block table;
  ``paged_attention`` routes paged attention by shape.

The cat-layout caches are ``[B, cap, Hkv*D]``: s8 with scales ``[B, Hkv,
cap, 1]`` f32 (the engine's canonical shape), or f32 or bf16 with no
scales. The kernels read every cache element type through ``KV_KINDS``; an
s8 cache needs its scales and an f32/bf16 cache takes none. The attention
always computes in f32 from the values the cache holds, so the new row is
attended as it was rounded into the cache, as the reference attends the
cache it wrote.

Paged KV: block pools shared by all slots, ``[NB, Hkv, BS, D]``
(head-major) or ``[NB, BS, Hkv*D]`` (cat), with scale pools
``[NB, Hkv, 1, BS]`` (positions lane-major per block); slot b's logical
position p lives in block ``bt[b, p // BS]``, row ``p % BS``. Block 0 is
the engine's garbage sink: idle slots' table rows are all 0, so several
slots can write one pool row in the same step. The reference writes the
rows in slot order, the last one winning, before anything reads them;
``paged_targets`` gives every writer of a row the last writer's data, so a
single ``index_put_`` leaves the same pool on the CPU and on the card.

The plain versions repeat the JAX package's CPU path
(``decode_attention_append_cat``'s fallback and ``decode_mha_xla``):
dequantize (or widen f32/bf16 to f32), materialize the scores with an
additive -1e30 mask, softmax.
For CPU tensors the wrappers run them; for CUDA tensors they launch the
kernel or raise — they never fall back.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from ._build import load_library
from .common import check_cuda_tensor, kernel_device

NEG_INF = -1e30

# Cache element types the kernels take, by the code their C entry points
# use (csrc/decode_fold.cuh, KvKind).
KV_KINDS = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}


def _kv_kind(name, c, k_scale, v_scale) -> int:
    """The kernels' code for cache ``c``'s dtype; s8 caches need both
    scales, f32/bf16 caches take none."""
    if c.dtype not in KV_KINDS:
        raise TypeError(f"{name}: dtype {c.dtype}, expected int8, float32 or bfloat16")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale: both or neither")
    if (c.dtype == torch.int8) != (k_scale is not None):
        raise ValueError(f"{name}: int8 caches need scales, float32/bfloat16 caches take none")
    return KV_KINDS[c.dtype]


def _head_dims(kind):
    """The head dims the cat-cache kernels take for an element kind."""
    return (32, 64, 128) if kind == KV_KINDS[torch.int8] else (64, 128)


def _ptr(t):
    return None if t is None else t.data_ptr()


def cat_to_heads(c: torch.Tensor, Hkv: int) -> torch.Tensor:
    """[B, cap, Hkv*D] cat rows -> [B, Hkv, cap, D] head-major view (also
    splits an op's [B, S, H*D] activations into heads)."""
    B, cap, HkvD = c.shape
    return c.reshape(B, cap, Hkv, HkvD // Hkv).permute(0, 2, 1, 3)


def heads_to_cat(x: torch.Tensor) -> torch.Tensor:
    """[B, Hkv, S, D] head-major rows -> [B, S, Hkv*D] cat rows (also
    merges heads)."""
    B, Hkv, S, D = x.shape
    return x.permute(0, 2, 1, 3).reshape(B, S, Hkv * D)


def quantize_rows(x: torch.Tensor):
    """Per-row int8 quantization of KV rows: scale max(absmax/127, 1e-8),
    round half to even, clip to [-127, 127] -> (s8, f32 scales [..., 1])."""
    x = x.to(torch.float32)
    s = torch.clamp_min(x.abs().amax(dim=-1, keepdim=True) / 127.0, 1e-8)
    q8 = torch.round(x / s).clamp(-127, 127).to(torch.int8)
    return q8, s


def mha_plain(q, k, v, mask=None, *, scale=None, causal: bool = False,
              softcap: float = 0.0):
    """Materialized-score attention, the JAX package's ``mha_xla``: q
    [B,Hq,Tq,D], k/v [B,Hkv,Tk,D] (query head h reads KV head h // group),
    an additive mask of any rank that broadcasts to [B,Hq,Tq,Tk], softcap,
    and causal anchored at the KV end (column <= row + Tk - Tq). A row with
    no column left gets the mean of V (the kernel gives 0 there). Returns
    q's dtype."""
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / float(np.sqrt(D))
    if Hq != Hkv:
        k = k.repeat_interleave(Hq // Hkv, dim=1)
        v = v.repeat_interleave(Hq // Hkv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    if mask is not None:
        s = s + mask.float()
    if causal:
        q_pos = torch.arange(Tq, device=q.device)[:, None]
        k_pos = torch.arange(Tk, device=q.device)[None, :]
        s = torch.where(k_pos <= q_pos + (Tk - Tq), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


MHA_HEAD_DIMS = (32, 64, 128)
_MHA_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def mha(q, k, v, mask=None, *, scale: Optional[float] = None, causal: bool = False,
        softcap: float = 0.0):
    """Flash attention, the kernel of ``csrc/mha.cu`` (replaces
    ``rten_tpu/kernels/flash_attention.py:mha_pallas``): q [B,Hq,Tq,D], k/v
    [B,Hkv,Tk,D] in q's dtype (f32 or bf16), each with a unit-stride last
    axis; ``mask`` an optional additive f32 mask of at most 2 dims that
    broadcasts to [Tq, Tk] (the Attention op folds leading unit dims);
    softcap; causal with offset Tk - Tq -> [B,Hq,Tq,D] in q's dtype. A row
    whose every column is masked gives 0 (the plain version gives the mean
    of V). For CPU tensors, ``mha_plain``."""
    if mask is not None and mask.dim() > 2:
        raise ValueError(f"mask: expected at most 2 dims broadcasting to [Tq, Tk], "
                         f"got {tuple(mask.shape)}")
    if kernel_device(q, k, v, mask) == "cpu":
        return mha_plain(q, k, v, mask, scale=scale, causal=causal, softcap=softcap)
    device = q.device
    B, Hq, Tq, D = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k/v: expected [B, Hkv, Tk, {D}], got {tuple(k.shape)} / "
                         f"{tuple(v.shape)}")
    Hkv, Tk = k.shape[1], k.shape[2]
    if D not in MHA_HEAD_DIMS or Hq % Hkv or Tq < 1 or Tk < 1:
        raise ValueError(f"head dim {D} (supported: {MHA_HEAD_DIMS}), heads {Hq}/{Hkv}, "
                         f"Tq {Tq}, Tk {Tk} not supported")
    if q.dtype not in _MHA_DTYPES:
        raise TypeError(f"q: dtype {q.dtype}, expected float32 or bfloat16")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_cuda_tensor(name, t, q.dtype, device, contiguous=False)
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the last axis must be unit-stride")
    m_ptr, m_sq, m_sk = None, 0, 0
    if mask is not None:
        mask = mask.to(torch.float32).expand(Tq, Tk)
        check_cuda_tensor("mask", mask, torch.float32, device, contiguous=False)
        m_ptr, m_sq, m_sk = mask.data_ptr(), mask.stride(0), mask.stride(1)
    if scale is None:
        scale = 1.0 / float(np.sqrt(D))
    out = torch.empty((B, Hq, Tq, D), dtype=q.dtype, device=device)
    err = _mha_kernel_lib().rten_mha(
        _MHA_DTYPES[q.dtype], q.data_ptr(), *q.stride()[:3], k.data_ptr(), *k.stride()[:3],
        v.data_ptr(), *v.stride()[:3], m_ptr, m_sq, m_sk, out.data_ptr(), *out.stride()[:3],
        B, Hq, Hkv, Tq, Tk, D, int(bool(causal)), float(softcap or 0.0), float(scale),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"mha launch failed: CUDA error {err}")
    mha.launches += 1
    return out


mha.launches = 0


def decode_mha_plain(q, k, v, lens, k_scale=None, v_scale=None, *,
                     scale=None, window: int = 0):
    """The JAX package's ``decode_mha_xla``: q [B,H,S,D], k/v [B,Hkv,cap,D]
    f32 or bf16 (widened to f32), or s8 with scales [B,Hkv,cap]; row r of
    slot b attends cache
    columns <= lens[b] + r (and > lens[b] + r - window). A row with no such
    column gets the mean of V, as the reference's additive -1e30 mask
    gives it (the kernels give 0 there, as the TPU kernel does)."""
    B, H, S, D = q.shape
    Hkv, cap = k.shape[1], k.shape[2]
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    if k_scale is not None:
        kf = kf * k_scale.reshape(B, Hkv, cap, 1)
        vf = vf * v_scale.reshape(B, Hkv, cap, 1)
    lens = lens.reshape(B).to(torch.int64)
    j = torch.arange(cap, device=q.device)[None, None, None, :]
    qpos = lens[:, None, None, None] + torch.arange(S, device=q.device)[None, None, :, None]
    valid = j <= qpos
    if window:
        valid &= j > qpos - window
    mask = torch.where(valid, 0.0, NEG_INF).to(torch.float32)
    return mha_plain(q, kf, vf, mask, scale=scale)


def paged_targets(starts, S: int, bt, n_blocks: int, block_size: int, *,
                  clamp: bool = False):
    """Where a per-slot write of S rows lands in a block pool, over the
    write list flattened slot-major to N = B * S entries: (blk [N], off [N],
    src [N]) int64, the pool block, the row in it, and the entry whose data
    the row receives.

    Position p = starts[b] + s of slot b lives at block bt[b, p // BS], row
    p % BS. Past the table (p // BS >= MB) it goes to block 0, the garbage
    sink (the head-major and scale pools' rule, ``_paged_kv_update``);
    with ``clamp`` p is first clamped to cap - 1 (the cat-pool append's
    rule, ``_append_cat_paged_fallback``). Entries that share a row resolve
    as the reference's in-order writes do: the last one wins, so ``src``
    points every entry at the last entry with its row."""
    B, MB = bt.shape
    BS = block_size
    dev = bt.device
    pos = starts.reshape(B).to(torch.int64)[:, None] + torch.arange(S, device=dev)[None]
    if clamp:
        pos = pos.clamp(max=MB * BS - 1)
    jb = pos // BS
    blk = torch.where(jb < MB, bt.to(torch.int64).gather(1, jb.clamp(max=MB - 1)), 0)
    blk, off = blk.reshape(-1), (pos % BS).reshape(-1)
    row = blk * BS + off
    order = torch.arange(row.numel(), device=dev)
    last = torch.full((n_blocks * BS,), -1, dtype=torch.int64, device=dev)
    last.scatter_reduce_(0, row, order, "amax")
    return blk, off, last[row]


def paged_gather_kv(pool, bt):
    """Head-major pool [NB, H, BS, D] gathered per slot -> contiguous
    [B, H, MB*BS, D]."""
    g = pool[bt.long()]  # [B, MB, H, BS, D]
    B, MB, H, BS, D = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(B, H, MB * BS, D)


def paged_gather_scales(spool, bt):
    """Scale pool [NB, Hkv, 1, BS] gathered per slot -> contiguous
    [B, Hkv, MB*BS]."""
    g = spool[bt.long()]  # [B, MB, Hkv, 1, BS]
    B, MB, Hkv, _, BS = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(B, Hkv, MB * BS)


def paged_gather_cat(pool, bt):
    """Cat pool [NB, BS, Hkv*D] gathered per slot -> contiguous
    [B, MB*BS, Hkv*D]."""
    B, MB = bt.shape
    return pool[bt.long()].reshape(B, MB * pool.shape[1], pool.shape[2])


def _paged_gather(pool_k, pool_v, pool_ks, pool_vs, bt):
    """Head-major pools (and scale pools, or None) gathered per slot ->
    (k, v, k_scale, v_scale) as ``decode_mha`` takes them."""
    ks = vs = None
    if pool_ks is not None:
        ks, vs = paged_gather_scales(pool_ks, bt), paged_gather_scales(pool_vs, bt)
    return paged_gather_kv(pool_k, bt), paged_gather_kv(pool_v, bt), ks, vs


def decode_mha_append_cat_plain(q, kc, vc, lens, k_scale=None, v_scale=None, *,
                                k_new, v_new, scale=None, window: int = 0):
    """Plain version of ``decode_mha_append_cat`` (same contract): write the
    new rows in place at the clamped row (s8 caches: quantized, with their
    scales; f32/bf16 caches: rounded to the cache dtype), attend in f32
    over the cache values."""
    B, Hkv = k_new.shape[0], k_new.shape[1]
    cap = kc.shape[1]
    lens = lens.reshape(B)
    wpos = lens.clamp(0, cap - 1).to(torch.int64)
    bidx = torch.arange(B, device=kc.device)
    ks = vs = None
    if k_scale is not None:
        k_q, ks_new = quantize_rows(k_new)
        v_q, vs_new = quantize_rows(v_new)
        kc[bidx, wpos] = heads_to_cat(k_q)[:, 0]
        vc[bidx, wpos] = heads_to_cat(v_q)[:, 0]
        k_scale[bidx, :, wpos] = ks_new.reshape(B, Hkv, 1).to(k_scale.dtype)
        v_scale[bidx, :, wpos] = vs_new.reshape(B, Hkv, 1).to(v_scale.dtype)
        ks, vs = k_scale.reshape(B, Hkv, cap), v_scale.reshape(B, Hkv, cap)
    else:
        kc[bidx, wpos] = heads_to_cat(k_new)[:, 0].to(kc.dtype)
        vc[bidx, wpos] = heads_to_cat(v_new)[:, 0].to(vc.dtype)
    out = heads_to_cat(decode_mha_plain(
        q, cat_to_heads(kc, Hkv), cat_to_heads(vc, Hkv), lens, ks, vs,
        scale=scale, window=window,
    ))
    return (out, kc, vc, k_scale, v_scale) if ks is not None else (out, kc, vc)


def _check_common(q, kc, vc, lens, k_scale, v_scale, Hkv):
    """Check what the flat cat-cache kernels take -> (kind, B, cap, D)."""
    device = q.device
    if q.dtype != torch.float32 or q.stride(-1) != 1:
        raise ValueError("q: float32 with a unit-stride last axis required")
    kind = _kv_kind("kc", kc, k_scale, v_scale)
    check_cuda_tensor("kc", kc, kc.dtype, device)
    check_cuda_tensor("vc", vc, kc.dtype, device)
    check_cuda_tensor("lens", lens, torch.int32, device)
    B, cap, HkvD = kc.shape
    if vc.shape != kc.shape or HkvD % Hkv:
        raise ValueError(f"cache shapes {tuple(kc.shape)} / {tuple(vc.shape)}")
    D = HkvD // Hkv
    if k_scale is not None:
        for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
            check_cuda_tensor(name, s, torch.float32, device)
            if s.numel() != B * Hkv * cap:
                raise ValueError(f"{name}: expected [B, Hkv, cap, 1] = "
                                 f"{(B, Hkv, cap, 1)}, got {tuple(s.shape)}")
    if lens.numel() != B:
        raise ValueError(f"lens: expected {B} values, got {tuple(lens.shape)}")
    if kc.data_ptr() % 16 or vc.data_ptr() % 16:
        raise ValueError("caches must be 16-byte aligned")
    return kind, B, cap, D


def decode_mha_append_cat(q, kc, vc, lens, k_scale=None, v_scale=None, *,
                          k_new, v_new, scale: Optional[float] = None,
                          window: int = 0, block_table=None):
    """Decode attention + in-place append on cat-layout caches (S == 1).

    q [B,H,1,D] f32; kc/vc [B,cap,Hkv*D] holding rows < lens[b]: s8 with
    scales [B,Hkv,cap,1] f32, or f32 or bf16 with none; k_new/v_new
    [B,Hkv,1,D] f32 rows for position lens[b]; lens [B] int32. The caches
    (and scales) are updated in place. Returns (out [B,1,H*D] in cat layout,
    kc, vc, k_scale, v_scale), or (out, kc, vc) for f32/bf16 caches, as the
    reference returns them. Head dims 32, 64 and 128 (s8), 64 and 128
    (f32, bf16).

    With ``block_table`` [B, MB] int32, kc/vc are block pools
    [NB, BS, Hkv*D] and the scales pools [NB, Hkv, 1, BS]
    (``decode_mha_append_cat_paged``).
    """
    if block_table is not None:
        return decode_mha_append_cat_paged(
            q, kc, vc, lens, k_scale, v_scale, k_new=k_new, v_new=v_new,
            block_table=block_table, scale=scale, window=window,
        )
    if kernel_device(q, kc, vc, lens, k_scale, v_scale, k_new, v_new) == "cpu":
        return decode_mha_append_cat_plain(
            q, kc, vc, lens, k_scale, v_scale, k_new=k_new, v_new=v_new,
            scale=scale, window=window,
        )
    B, H, S, Dq = q.shape
    Hkv = k_new.shape[1]
    if S != 1:
        raise ValueError("decode_mha_append_cat is a single-token decode kernel")
    kind, _, cap, D = _check_common(q, kc, vc, lens, k_scale, v_scale, Hkv)
    if Dq != D or H % Hkv or D not in _head_dims(kind):
        raise ValueError(f"head dim {D} (q {Dq}), heads {H}/{Hkv} not supported "
                         f"on {kc.dtype} caches")
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        if t.shape != (B, Hkv, 1, D) or t.dtype != torch.float32 or t.stride(-1) != 1:
            raise ValueError(f"{name}: expected float32 {(B, Hkv, 1, D)}")
    if scale is None:
        scale = 1.0 / float(np.sqrt(D))
    out = torch.empty((B, 1, H * D), dtype=torch.float32, device=q.device)
    err = _lib().rten_decode_append_cat(
        kind, q.data_ptr(), q.stride(0), q.stride(1),
        k_new.data_ptr(), k_new.stride(0), k_new.stride(1),
        v_new.data_ptr(), v_new.stride(0), v_new.stride(1),
        kc.data_ptr(), vc.data_ptr(), _ptr(k_scale), _ptr(v_scale),
        lens.data_ptr(), out.data_ptr(), B, H, Hkv, D, cap, int(window),
        float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"decode_mha_append_cat launch failed: CUDA error {err}")
    decode_mha_append_cat.launches += 1
    return (out, kc, vc, k_scale, v_scale) if k_scale is not None else (out, kc, vc)


decode_mha_append_cat.launches = 0


def decode_mha_append_cat_paged_plain(q, pool_kc, pool_vc, lens, k_scale_pool=None,
                                      v_scale_pool=None, *, k_new, v_new, block_table,
                                      scale=None, window: int = 0):
    """Plain version of ``decode_mha_append_cat_paged`` (the JAX package's
    ``_append_cat_paged_fallback``): write the new rows (s8: quantized, with
    their scales; f32/bf16: rounded to the pool dtype) into the pools
    through the table at row min(lens, cap - 1), the last slot winning a
    shared row, then attend over per-slot gathered views."""
    B, Hkv = k_new.shape[0], k_new.shape[1]
    NB, BS, _ = pool_kc.shape
    bt = block_table
    lens = lens.reshape(B)
    blk, off, src = paged_targets(lens, 1, bt, NB, BS, clamp=True)
    ks = vs = None
    if k_scale_pool is not None:
        k_q, ks_new = quantize_rows(k_new)
        v_q, vs_new = quantize_rows(v_new)
        pool_kc[blk, off] = heads_to_cat(k_q)[:, 0][src]
        pool_vc[blk, off] = heads_to_cat(v_q)[:, 0][src]
        k_scale_pool.select(2, 0)[blk, :, off] = ks_new.reshape(B, Hkv)[src]
        v_scale_pool.select(2, 0)[blk, :, off] = vs_new.reshape(B, Hkv)[src]
        ks, vs = paged_gather_scales(k_scale_pool, bt), paged_gather_scales(v_scale_pool, bt)
    else:
        pool_kc[blk, off] = heads_to_cat(k_new)[:, 0].to(pool_kc.dtype)[src]
        pool_vc[blk, off] = heads_to_cat(v_new)[:, 0].to(pool_vc.dtype)[src]
    out = heads_to_cat(decode_mha_plain(
        q, cat_to_heads(paged_gather_cat(pool_kc, bt), Hkv),
        cat_to_heads(paged_gather_cat(pool_vc, bt), Hkv), lens, ks, vs,
        scale=scale, window=window,
    ))
    if ks is None:
        return out, pool_kc, pool_vc
    return out, pool_kc, pool_vc, k_scale_pool, v_scale_pool


def _check_table(bt, lens, B, device):
    check_cuda_tensor("block_table", bt, torch.int32, device)
    if bt.dim() != 2 or bt.shape[0] != B or bt.shape[1] < 1:
        raise ValueError(f"block_table: expected [{B}, MB], got {tuple(bt.shape)}")
    check_cuda_tensor("lens", lens, torch.int32, device)
    if lens.numel() != B:
        raise ValueError(f"lens: expected {B} values, got {tuple(lens.shape)}")
    return bt.shape[1]


def decode_mha_append_cat_paged(q, pool_kc, pool_vc, lens, k_scale_pool=None,
                                v_scale_pool=None, *, k_new, v_new, block_table,
                                scale: Optional[float] = None, window: int = 0):
    """``decode_mha_append_cat`` through a block table (replaces the TPU
    kernel's ``block_table=`` form): q [B,H,1,D] f32; pools [NB,BS,Hkv*D]
    s8 with scale pools [NB,Hkv,1,BS] f32, or f32 or bf16 with none,
    updated in place; block_table [B,MB] int32; lens [B] int32. Slot b's
    new row lands at position min(lens[b], cap - 1), cap = MB * BS. Two
    launches on the stream: the rows are written (the last slot winning a
    shared row), then every slot attends through the table (``decode_mha``'s
    fold, so group = H / Hkv <= ``FOLD_MAX_ROWS``; f32/bf16 pools through
    ``paged_decode_mha``'s entry point on the cat pools' strides).
    Returns (out [B,1,H*D], pools, scale pools), or (out, pools) for
    f32/bf16 pools."""
    if kernel_device(q, pool_kc, pool_vc, lens, k_scale_pool, v_scale_pool, k_new,
                     v_new, block_table) == "cpu":
        return decode_mha_append_cat_paged_plain(
            q, pool_kc, pool_vc, lens, k_scale_pool, v_scale_pool, k_new=k_new,
            v_new=v_new, block_table=block_table, scale=scale, window=window,
        )
    device = q.device
    B, H, S, D = q.shape
    Hkv = k_new.shape[1]
    if S != 1:
        raise ValueError("decode_mha_append_cat is a single-token decode kernel")
    if q.dtype != torch.float32 or q.stride(-1) != 1:
        raise ValueError("q: float32 with a unit-stride last axis required")
    if pool_kc.dim() != 3 or pool_vc.shape != pool_kc.shape:
        raise ValueError(f"pools: expected two [NB, BS, Hkv*D] tensors, got "
                         f"{tuple(pool_kc.shape)} / {tuple(pool_vc.shape)}")
    kind = _kv_kind("pool_kc", pool_kc, k_scale_pool, v_scale_pool)
    NB, BS, HkvD = pool_kc.shape
    if (HkvD != Hkv * D or H % Hkv or H // Hkv > FOLD_MAX_ROWS
            or D not in _head_dims(kind)):
        raise ValueError(f"head dim {D}, heads {H}/{Hkv}, pool rows {HkvD} not supported "
                         f"on {pool_kc.dtype} pools")
    for name, t in (("pool_kc", pool_kc), ("pool_vc", pool_vc)):
        check_cuda_tensor(name, t, pool_kc.dtype, device)
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: must be 16-byte aligned")
    if k_scale_pool is not None:
        for name, t in (("k_scale_pool", k_scale_pool), ("v_scale_pool", v_scale_pool)):
            check_cuda_tensor(name, t, torch.float32, device)
            if t.shape != (NB, Hkv, 1, BS):
                raise ValueError(f"{name}: expected {(NB, Hkv, 1, BS)}, got {tuple(t.shape)}")
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        if t.shape != (B, Hkv, 1, D) or t.dtype != torch.float32 or t.stride(-1) != 1:
            raise ValueError(f"{name}: expected float32 {(B, Hkv, 1, D)}")
    MB = _check_table(block_table, lens, B, device)
    if scale is None:
        scale = 1.0 / float(np.sqrt(D))
    out = torch.empty((B, 1, H * D), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    new_rows = (k_new.data_ptr(), k_new.stride(0), k_new.stride(1),
                v_new.data_ptr(), v_new.stride(0), v_new.stride(1))
    if k_scale_pool is not None:
        err = _lib().rten_decode_append_cat_paged(
            q.data_ptr(), q.stride(0), q.stride(1), *new_rows,
            pool_kc.data_ptr(), pool_vc.data_ptr(), k_scale_pool.data_ptr(),
            v_scale_pool.data_ptr(), block_table.data_ptr(), MB, BS, lens.data_ptr(),
            out.data_ptr(), B, H, Hkv, D, int(window), float(scale), stream,
        )
    else:
        err = _lib().rten_append_cat_write(
            kind, *new_rows, pool_kc.data_ptr(), pool_vc.data_ptr(), None, None,
            block_table.data_ptr(), MB, BS, lens.data_ptr(), B, Hkv, D, stream,
        )
        if not err:  # the fold over the cat pools: rows of Hkv * D, heads D apart
            err = _paged_lib(pool_kc.dtype).rten_paged_decode_mha(
                kind, q.data_ptr(), q.stride(0), q.stride(1), pool_kc.data_ptr(),
                pool_vc.data_ptr(), BS * HkvD, D, HkvD, None, None, 0, 0, 0,
                block_table.data_ptr(), MB, BS, lens.data_ptr(), out.data_ptr(), H * D, D,
                B, H, Hkv, D, int(window), float(scale), stream,
            )
    if err:
        raise RuntimeError(f"decode_mha_append_cat (block table) launch failed: CUDA error {err}")
    decode_mha_append_cat_paged.launches += 1
    if k_scale_pool is None:
        return out, pool_kc, pool_vc
    return out, pool_kc, pool_vc, k_scale_pool, v_scale_pool


decode_mha_append_cat_paged.launches = 0


def prefill_mha_cat_plain(q, kc, vc, lens, k_scale=None, v_scale=None, *, scale=None,
                          window: int = 0):
    """Plain version of ``prefill_mha_cat``: head-major views of the caches
    through ``decode_mha_plain`` -> [B, H, S, D]."""
    B, D = q.shape[0], q.shape[3]
    cap, Hkv = kc.shape[1], kc.shape[2] // D
    ks = vs = None
    if k_scale is not None:
        ks, vs = k_scale.reshape(B, Hkv, cap), v_scale.reshape(B, Hkv, cap)
    return decode_mha_plain(q, cat_to_heads(kc, Hkv), cat_to_heads(vc, Hkv), lens, ks, vs,
                            scale=scale, window=window)


def prefill_mha_cat(q, kc, vc, lens, k_scale=None, v_scale=None, *,
                    scale: Optional[float] = None, window: int = 0):
    """Prefill attention on cat-layout caches: q [B,H,S,D] f32, kc/vc
    [B,cap,Hkv*D] holding rows < lens[b]+S (the chunk's rows included), s8
    with scales [B,Hkv,cap,1] (D 32, 64, 128) or f32 or bf16 with none (D
    64, 128) -> [B,H,S,D] f32. On the card the result is a head-major view
    of a [B,S,H*D] buffer, so merging heads is free."""
    if kernel_device(q, kc, vc, lens, k_scale, v_scale) == "cpu":
        return prefill_mha_cat_plain(
            q, kc, vc, lens, k_scale, v_scale, scale=scale, window=window
        )
    B, H, S, Dq = q.shape
    if kc.dim() != 3 or kc.shape[2] % Dq:
        raise ValueError(f"kc: expected [B, cap, Hkv * {Dq}], got {tuple(kc.shape)}")
    Hkv = kc.shape[2] // Dq
    kind, _, cap, D = _check_common(q, kc, vc, lens, k_scale, v_scale, Hkv)
    if H % Hkv or D not in _head_dims(kind):
        raise ValueError(f"head dim {D}, heads {H}/{Hkv} not supported on {kc.dtype} caches")
    if scale is None:
        scale = 1.0 / float(np.sqrt(D))
    out_cat = torch.empty((B, S, H * D), dtype=torch.float32, device=q.device)
    err = _lib().rten_prefill_cat(
        kind, q.data_ptr(), q.stride(0), q.stride(1), q.stride(2),
        kc.data_ptr(), vc.data_ptr(), _ptr(k_scale), _ptr(v_scale),
        lens.data_ptr(), out_cat.data_ptr(), S * H * D, D, H * D,
        B, H, Hkv, S, D, cap, int(window), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"prefill_mha_cat launch failed: CUDA error {err}")
    prefill_mha_cat.launches += 1
    return out_cat.reshape(B, S, H, D).permute(0, 2, 1, 3)


prefill_mha_cat.launches = 0


FOLD_MAX_ROWS = 16  # group * S query rows one fold block holds


def decode_mha(q, k, v, lens, k_scale=None, v_scale=None, *,
               scale: Optional[float] = None, window: int = 0):
    """Per-slot attention over head-major caches (the serving hot path of
    Llama-family graphs): q [B,H,S,D] f32; k/v [B,Hkv,cap,D] f32 or bf16,
    or s8 with per-position scales k_scale/v_scale [B,Hkv,cap] f32; lens [B]
    int32 past lengths. Row r of slot b attends columns <= lens[b] + r (and
    > lens[b] + r - window when window > 0) -> [B,H,S,D] f32.

    Routing (the port's own): the fold (one block per slot and kv head,
    ``decode_mha_folded``) when its group * S query rows fit one block
    (``FOLD_MAX_ROWS``), which covers every decode step of a model with
    group <= 16 (TinyLlama: 8); per head (``decode_mha_heads``) otherwise,
    which covers every admission."""
    group = q.shape[1] // k.shape[1]
    if group * q.shape[2] <= FOLD_MAX_ROWS:
        return decode_mha_folded(q, k, v, lens, k_scale, v_scale,
                                 scale=scale, window=window)
    return decode_mha_heads(q, k, v, lens, k_scale, v_scale,
                            scale=scale, window=window)


def _decode_mha_launch(form, q, k, v, lens, k_scale, v_scale, scale, window):
    """Check what the kernels take, then launch ``rten_decode_mha_<form>``
    (``csrc/decode_mha.cu`` for s8 and f32 caches, ``csrc/decode_mha_bf16.cu``
    for bf16). Returns [B,H,S,D] f32, a head-major view of a [B,S,H*D]
    buffer, so merging heads afterwards is free."""
    device = q.device
    B, H, S, D = q.shape
    if q.dtype != torch.float32 or q.stride(-1) != 1:
        raise ValueError("q: float32 with a unit-stride last axis required")
    kind = _kv_kind("k", k, k_scale, v_scale)
    quant = k_scale is not None
    if k.dim() != 4 or k.shape != v.shape or k.stride() != v.stride():
        raise ValueError(f"caches: expected two [B, Hkv, cap, D] tensors with one "
                         f"layout, got {tuple(k.shape)} / {tuple(v.shape)}")
    _, Hkv, cap, Dk = k.shape
    if k.shape[0] != B or Dk != D or H % Hkv or D not in (64, 128):
        raise ValueError(f"head dim {D} (caches {Dk}), heads {H}/{Hkv}, "
                         f"slots {B}/{k.shape[0]} not supported")
    for name, t in (("k", k), ("v", v)):
        check_cuda_tensor(name, t, k.dtype, device, contiguous=False)
        row_bytes = [s * t.element_size() for s in t.stride()[:3]]
        if t.stride(-1) != 1 or t.data_ptr() % 16 or any(s % 16 for s in row_bytes):
            raise ValueError(f"{name}: rows must be unit-stride and 16-byte aligned")
    if quant:
        ks = k_scale.reshape(B, Hkv, cap)
        vs = v_scale.reshape(B, Hkv, cap)
        check_cuda_tensor("k_scale", ks, torch.float32, device, contiguous=False)
        check_cuda_tensor("v_scale", vs, torch.float32, device, contiguous=False)
        if ks.stride() != vs.stride():
            raise ValueError("k_scale and v_scale: one layout required")
        sc_ptrs, sc_strides = (ks.data_ptr(), vs.data_ptr()), ks.stride()
    else:
        sc_ptrs, sc_strides = (None, None), (0, 0, 0)
    check_cuda_tensor("lens", lens, torch.int32, device)
    if lens.numel() != B:
        raise ValueError(f"lens: expected {B} values, got {tuple(lens.shape)}")
    if scale is None:
        scale = 1.0 / float(np.sqrt(D))
    out_cat = torch.empty((B, S, H * D), dtype=torch.float32, device=device)
    lib = _mha_lib("decode_mha_bf16" if k.dtype == torch.bfloat16 else "decode_mha")
    fn = getattr(lib, f"rten_decode_mha_{form}")
    err = fn(
        kind, q.data_ptr(), *q.stride()[:3],
        k.data_ptr(), v.data_ptr(), *k.stride()[:3],
        *sc_ptrs, *sc_strides, lens.data_ptr(), out_cat.data_ptr(),
        S * H * D, D, H * D, B, H, Hkv, S, D, cap, int(window), float(scale),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")
    return out_cat.reshape(B, S, H, D).permute(0, 2, 1, 3)


def decode_mha_folded(q, k, v, lens, k_scale=None, v_scale=None, *,
                      scale: Optional[float] = None, window: int = 0):
    """``decode_mha``'s fold form (replaces
    ``rten_tpu/kernels/flash_attention.py:_decode_mha_folded``): one block
    per (slot, kv head) holding its group * S <= ``FOLD_MAX_ROWS`` rows."""
    if kernel_device(q, k, v, lens, k_scale, v_scale) == "cpu":
        return decode_mha_plain(q, k, v, lens, k_scale, v_scale,
                                scale=scale, window=window)
    group = q.shape[1] // k.shape[1]
    if group * q.shape[2] > FOLD_MAX_ROWS:
        raise ValueError(f"the fold holds {FOLD_MAX_ROWS} rows per kv head, "
                         f"got group {group} x S {q.shape[2]}")
    out = _decode_mha_launch("folded", q, k, v, lens, k_scale, v_scale, scale, window)
    decode_mha_folded.launches += 1
    return out


decode_mha_folded.launches = 0


def decode_mha_heads(q, k, v, lens, k_scale=None, v_scale=None, *,
                     scale: Optional[float] = None, window: int = 0):
    """``decode_mha``'s per-head form (replaces
    ``rten_tpu/kernels/flash_attention.py:decode_mha``'s per-head grid):
    one block per (32-row query tile, head, slot)."""
    if kernel_device(q, k, v, lens, k_scale, v_scale) == "cpu":
        return decode_mha_plain(q, k, v, lens, k_scale, v_scale,
                                scale=scale, window=window)
    out = _decode_mha_launch("heads", q, k, v, lens, k_scale, v_scale, scale, window)
    decode_mha_heads.launches += 1
    return out


decode_mha_heads.launches = 0


def paged_decode_mha_plain(q, pool_k, pool_v, lens, block_table, pool_ks=None,
                           pool_vs=None, *, scale=None, window: int = 0):
    """Plain version of ``paged_decode_mha`` (the JAX package's
    ``paged_attention`` fallback): gather each slot's blocks into a
    contiguous view, then ``decode_mha_plain``."""
    k, v, ks, vs = _paged_gather(pool_k, pool_v, pool_ks, pool_vs, block_table)
    return decode_mha_plain(q, k, v, lens, ks, vs, scale=scale, window=window)


def paged_decode_mha(q, pool_k, pool_v, lens, block_table, pool_ks=None,
                     pool_vs=None, *, scale: Optional[float] = None, window: int = 0):
    """Paged decode attention (S == 1; replaces
    ``rten_tpu/kernels/flash_attention.py:paged_decode_mha``): q [B,H,1,D]
    f32 against pools [NB,Hkv,BS,D], s8 with scale pools [NB,Hkv,1,BS] f32,
    or f32 or bf16 without, read through block_table [B,MB] int32 at lens [B]
    int32. Slot b's query sits at position lens[b] (its row already
    written) and attends columns <= lens[b] (all of them once lens >= cap,
    cap = MB * BS), and > lens[b] - window with a window -> [B,H,1,D] f32,
    a head-major view of a [B,1,H*D] buffer. group = H / Hkv <=
    ``FOLD_MAX_ROWS``; D 64 or 128."""
    if kernel_device(q, pool_k, pool_v, lens, block_table, pool_ks, pool_vs) == "cpu":
        return paged_decode_mha_plain(q, pool_k, pool_v, lens, block_table, pool_ks,
                                      pool_vs, scale=scale, window=window)
    device = q.device
    B, H, S, D = q.shape
    if S != 1:
        raise ValueError("paged_decode_mha is S == 1 (admissions gather, then decode_mha)")
    if q.dtype != torch.float32 or q.stride(-1) != 1:
        raise ValueError("q: float32 with a unit-stride last axis required")
    kind = _kv_kind("pool_k", pool_k, pool_ks, pool_vs)
    quant = pool_ks is not None
    if pool_k.dim() != 4 or pool_k.shape != pool_v.shape or pool_k.stride() != pool_v.stride():
        raise ValueError(f"pools: expected two [NB, Hkv, BS, D] tensors with one layout, "
                         f"got {tuple(pool_k.shape)} / {tuple(pool_v.shape)}")
    NB, Hkv, BS, Dk = pool_k.shape
    if Dk != D or H % Hkv or H // Hkv > FOLD_MAX_ROWS or D not in (64, 128):
        raise ValueError(f"head dim {D} (pools {Dk}), heads {H}/{Hkv} not supported")
    for name, t in (("pool_k", pool_k), ("pool_v", pool_v)):
        check_cuda_tensor(name, t, pool_k.dtype, device, contiguous=False)
        row_bytes = [s * t.element_size() for s in t.stride()[:3]]
        if t.stride(-1) != 1 or t.data_ptr() % 16 or any(s % 16 for s in row_bytes):
            raise ValueError(f"{name}: rows must be unit-stride and 16-byte aligned")
    if quant:
        for name, t in (("pool_ks", pool_ks), ("pool_vs", pool_vs)):
            check_cuda_tensor(name, t, torch.float32, device, contiguous=False)
            if t.shape != (NB, Hkv, 1, BS) or t.stride() != pool_ks.stride():
                raise ValueError(f"{name}: expected {(NB, Hkv, 1, BS)} in one layout, "
                                 f"got {tuple(t.shape)}")
        sc_ptrs = (pool_ks.data_ptr(), pool_vs.data_ptr())
        sc_strides = (pool_ks.stride(0), pool_ks.stride(1), pool_ks.stride(3))
    else:
        sc_ptrs, sc_strides = (None, None), (0, 0, 0)
    MB = _check_table(block_table, lens, B, device)
    if scale is None:
        scale = 1.0 / float(np.sqrt(D))
    out_cat = torch.empty((B, 1, H * D), dtype=torch.float32, device=device)
    err = _paged_lib(pool_k.dtype).rten_paged_decode_mha(
        kind, q.data_ptr(), q.stride(0), q.stride(1),
        pool_k.data_ptr(), pool_v.data_ptr(), pool_k.stride(0), pool_k.stride(1),
        pool_k.stride(2), *sc_ptrs, *sc_strides, block_table.data_ptr(), MB, BS,
        lens.data_ptr(), out_cat.data_ptr(), H * D, D, B, H, Hkv, D, int(window),
        float(scale), torch.cuda.current_stream(device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"paged_decode_mha launch failed: CUDA error {err}")
    paged_decode_mha.launches += 1
    return out_cat.reshape(B, 1, H, D).permute(0, 2, 1, 3)


paged_decode_mha.launches = 0


def paged_attention(q, pool_k, pool_v, lens, block_table, pool_ks=None, pool_vs=None, *,
                    scale: Optional[float] = None, window: int = 0):
    """Attention of q [B,H,S,D] over head-major block pools, routed by shape
    alone (the JAX package's ``paged_attention``): a decode step (S == 1,
    group <= ``FOLD_MAX_ROWS``) reads the pools through the table in
    ``paged_decode_mha``; anything else (an admission) gathers each slot's
    blocks into a contiguous view for ``decode_mha``."""
    group = q.shape[1] // pool_k.shape[1]
    if q.shape[2] == 1 and group <= FOLD_MAX_ROWS:
        return paged_decode_mha(q, pool_k, pool_v, lens, block_table, pool_ks, pool_vs,
                                scale=scale, window=window)
    k, v, ks, vs = _paged_gather(pool_k, pool_v, pool_ks, pool_vs, block_table)
    return decode_mha(q, k, v, lens, ks, vs, scale=scale, window=window)


def _mha_lib(name):
    lib = load_library(name)
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    for fn in (lib.rten_decode_mha_folded, lib.rten_decode_mha_heads):
        if fn.argtypes is None:
            fn.argtypes = [I, P, L, L, L, P, P, L, L, L, P, P, L, L, L, P, P,
                           L, L, L, I, I, I, I, I, I, I, F, P]
            fn.restype = I
    return lib


def _mha_kernel_lib():
    lib = load_library("mha")
    fn = lib.rten_mha
    if fn.argtypes is None:
        P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        fn.argtypes = [I, P, L, L, L, P, L, L, L, P, L, L, L, P, L, L, P, L, L, L,
                       I, I, I, I, I, I, I, F, F, P]
        fn.restype = I
    return lib


def _paged_lib(dtype):
    """``csrc/paged_decode_mha_bf16.cu``'s library for bf16 pools,
    ``csrc/paged_decode_mha.cu``'s for s8 and f32."""
    lib = load_library("paged_decode_mha_bf16" if dtype == torch.bfloat16
                       else "paged_decode_mha")
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    fn = lib.rten_paged_decode_mha
    if fn.argtypes is None:
        fn.argtypes = [I, P, L, L, P, P, L, L, L, P, P, L, L, L, P, I, I, P, P,
                       L, L, I, I, I, I, I, F, P]
        fn.restype = I
    return lib


def _lib():
    lib = load_library("flash_attention")
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    if lib.rten_decode_append_cat.argtypes is None:
        lib.rten_decode_append_cat.argtypes = [
            I, P, L, L, P, L, L, P, L, L, P, P, P, P, P, P,
            I, I, I, I, I, I, F, P,
        ]
        lib.rten_decode_append_cat.restype = I
        lib.rten_prefill_cat.argtypes = [
            I, P, L, L, L, P, P, P, P, P, P, L, L, L,
            I, I, I, I, I, I, I, F, P,
        ]
        lib.rten_prefill_cat.restype = I
        lib.rten_decode_append_cat_paged.argtypes = [
            P, L, L, P, L, L, P, L, L, P, P, P, P, P, I, I, P, P,
            I, I, I, I, I, F, P,
        ]
        lib.rten_decode_append_cat_paged.restype = I
        lib.rten_append_cat_write.argtypes = [
            I, P, L, L, P, L, L, P, P, P, P, P, I, I, P, I, I, I, P,
        ]
        lib.rten_append_cat_write.restype = I
    return lib
