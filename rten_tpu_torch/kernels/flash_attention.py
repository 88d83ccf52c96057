"""Attention: the wrappers of the CUDA kernels in ``csrc/decode_append*.cu``
and ``csrc/flash_attention.cu`` (the append), ``csrc/decode_mha*.cu`` (one
library per cache type, int4's deferred folds apart, and D 129-512),
``csrc/paged_decode_mha*.cu`` (one per pool type) and ``csrc/mha.cu``, and
their plain PyTorch versions.

* ``mha`` (``csrc/mha.cu``) replaces
  ``rten_tpu/kernels/flash_attention.py:mha_pallas``: flash attention of
  q [B,Hq,Tq,D] over whole K/V [B,Hkv,Tk,D] (f32 or bf16), an optional 2-D
  additive mask, softcap, causal anchored at the KV end; ``mha_plain`` is
  the reference's ``mha_xla``. D <= 128 runs on tensor cores (f32 in
  3xTF32), D 129-256 on CUDA cores (``mha_form``, ``mha_key_warps``). The
  Attention ops route between the two (``ops/attention.py:_attend``).
* ``decode_mha`` replaces ``rten_tpu/kernels/flash_attention.py:decode_mha``
  and its ``_decode_mha_folded``: S query rows per slot over head-major
  caches ``[B, Hkv, cap, D]``, s8 with scales ``[B, Hkv, cap]``, int4 (u8
  ``[B, Hkv, cap, D/2]``, ``pack_int4``) with the same scales, f32 or bf16
  (``csrc/decode_mha{,_f32,_bf16,_u4,_u4_win,_wide}.cu``). Two launch forms, each with
  its own launch counter: ``decode_mha_folded`` (every decode step, and the
  deferred-KV step with a recent window: ``decode_attention_deferred``),
  split over blocks, on tensor cores for s8, int4 and bf16 caches at D <=
  128 with no window or a bf16 one and on CUDA cores otherwise
  (``fold_form``); and ``decode_mha_heads`` (every admission), on tensor
  cores at every head dim (f32 caches in 3xTF32; ``heads_plan`` names the
  kernel and its tiling).
* ``decode_mha_append`` replaces
  ``rten_tpu/kernels/flash_attention.py:decode_mha_append``: the in-kernel
  append of ``decode_mha_append_cat`` on head-major caches (the same CUDA
  kernel, ``csrc/decode_append*.cu``, addressed through strides).
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
  It is ``decode_mha_heads``'s function on the cat caches' head-major
  views, so it launches that form's kernels (``csrc/decode_mha*.cu``)
  through the views' strides, under its own launch counters.
* ``paged_decode_mha`` (``csrc/paged_decode_mha.cu``) replaces
  ``rten_tpu/kernels/flash_attention.py:paged_decode_mha``: a decode step
  over head-major block pools ``[NB, Hkv, BS, D]`` (s8, f32 or bf16) through
  a block table;
  ``paged_attention`` routes paged attention by shape.

Split-K: the decode steps' kernels (``decode_mha_folded``,
``paged_decode_mha``, the block-table append's attention and the flat
append, ``csrc/decode_append*.cu``) cut each (slot, kv head)'s
columns into chunks, one block each (``decode_split_plan``, from the shapes
alone), so that a decode step at 16 slots fills the card, and fold the
group's query rows into the block; the last block of a (slot, kv head) merges the
chunks' softmax states in chunk order. The states and the arrival counters
live in a workspace kept per device and stream and grown as needed
(``_split_workspace``). The wrappers read nothing back from the card.

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

Head dims: every kernel takes any even D up to 256 (the decode kernels and
the head-major append up to 512), running it in the smallest instance that
holds it with the dims past D masked; 16-byte loads where the rows are
16-byte aligned, element loads otherwise.

The plain versions repeat the JAX package's CPU path
(``decode_attention_append_cat``'s fallback and ``decode_mha_xla``):
dequantize (or widen f32/bf16 to f32), materialize the scores with an
additive -1e30 mask, softmax.
For CPU tensors the wrappers run them; for CUDA tensors they launch the
kernel or raise — they never fall back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ._build import load_library
from .common import check_cuda_tensor, kernel_device, sm_count

NEG_INF = -1e30
SMS = 132  # the H100's SMs: the split plans' and mha_key_warps' target

# A watcher of the attention kernel wrappers marked ``@_holdable`` (the
# smoke test's check of every call against its plain version): while set,
# each call runs as ``hold(name, wrapper, args, kwargs)``, which returns the
# wrapper's result. None in normal use.
hold = None


def _holdable(fn):
    """Routes the wrapper's calls through ``hold`` while one is set; the
    launch counter stays the wrapper's own."""
    @functools.wraps(fn)
    def call(*args, **kw):
        if hold is None:
            return fn(*args, **kw)
        return hold(fn.__name__, fn, args, kw)
    return call

# Cache element types the kernels take, by the code their C entry points
# use (csrc/decode_fold.cuh, KvKind); u8 is the int4 cache of pack_int4
# (decode_mha only).
KV_KINDS = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2, torch.uint8: 3}
QUANT_KV = (torch.int8, torch.uint8)

# int4 KV caches: codes biased by 8 (0..15) so a byte needs no sign, and
# split-half packing: the low nibble of byte i is dim i, the high nibble dim
# i + D/2 (the JAX package's pack_int4 / unpack_int4).
INT4_BIAS = 8
# The reference computes the scale as absmax / 7.0; under jit (its serving
# path) XLA compiles the division by the constant as a multiply by its f32
# reciprocal, and so does the port, so that the scales match bit for bit.
_INV7 = float(np.float32(1.0) / np.float32(7.0))


def pack_int4(x: torch.Tensor):
    """Quantize rows x [..., D] to nibble-packed int4 -> (u8 [..., D/2], f32
    scales [..., 1]): per-row scale max(absmax * f32(1/7), 1e-8), codes
    round(x / scale) (IEEE division, half to even) clipped to [-8, 7], then
    biased by 8."""
    D = x.shape[-1]
    if D % 2:
        raise ValueError(f"int4 packing needs an even head dim, got {D}")
    x = x.to(torch.float32)
    s = torch.clamp_min(x.abs().amax(dim=-1, keepdim=True) * _INV7, 1e-8)
    q = torch.round(x / s).clamp(-8, 7).to(torch.int32) + INT4_BIAS
    return (q[..., : D // 2] | (q[..., D // 2:] << 4)).to(torch.uint8), s


def unpack_int4(packed: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """[..., D/2] u8 -> [..., D] codes in ``dtype`` (the low nibbles, then the
    high ones, each minus the bias)."""
    b = packed.to(torch.int32)
    return torch.cat([(b & 0xF) - INT4_BIAS, (b >> 4) - INT4_BIAS], dim=-1).to(dtype)


def _kv_kind(name, c, k_scale, v_scale) -> int:
    """The kernels' code for cache ``c``'s dtype; s8 and int4 (u8) caches
    need both scales, f32/bf16 caches take none."""
    if c.dtype not in KV_KINDS:
        raise TypeError(f"{name}: dtype {c.dtype}, expected int8, uint8 (int4), float32 "
                        f"or bfloat16")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale: both or neither")
    if (c.dtype in QUANT_KV) != (k_scale is not None):
        raise ValueError(f"{name}: int8 and int4 caches need scales, float32/bfloat16 caches "
                         f"take none")
    return KV_KINDS[c.dtype]


def _check_head_dim(D: int, max_d: int, what: str = "") -> None:
    """The kernels take any even head dim up to ``max_d`` (a masked tail in
    the smallest instance that holds it)."""
    if D < 2 or D % 2 or D > max_d:
        raise ValueError(f"{what}head dim {D} not supported (any even D up to {max_d})")


def _vec16(t: torch.Tensor, row_elems: int, strides) -> int:
    """1 when every row of ``row_elems`` elements that ``strides`` (in
    elements) address in ``t`` starts 16-byte aligned and is a whole number
    of 16-byte words, so the kernels may load 16 bytes at a time."""
    es = t.element_size()
    return int(t.data_ptr() % 16 == 0 and (row_elems * es) % 16 == 0
               and all((s * es) % 16 == 0 for s in strides))


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
    round half to even, clip to [-127, 127] -> (s8, f32 scales [..., 1]).
    The division is elementwise by a tensor: PyTorch divides a CUDA tensor
    by a Python number as a multiply by its reciprocal, which would round
    some scales an ulp away from the CPU's (and the kernels') IEEE
    division."""
    x = x.to(torch.float32)
    absmax = x.abs().amax(dim=-1, keepdim=True)
    s = torch.clamp_min(absmax / torch.full_like(absmax, 127.0), 1e-8)
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


MHA_MAX_HEAD_DIM = 256
MHA_TC_MAX_HEAD_DIM = 128  # tensor cores up to here, CUDA cores above
_MHA_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def mha_form(D: int) -> str:
    """The kernel ``mha`` launches at head dim D: "tensor_core" (D <= 128)
    or "cuda_core" (D 129-256, counted by ``mha.cuda_core_launches``)."""
    return "tensor_core" if D <= MHA_TC_MAX_HEAD_DIM else "cuda_core"


def mha_key_warps(B: int, Hq: int, Tq: int, causal: bool, sms: int = SMS) -> int:
    """How many of a tensor-core mha block's four warps split each key tile
    (the rest hold 16 query rows each): 1 where blocks of 64 rows fill the
    SMs with even work (GQA 32/4 at 256 rows: 256 blocks); 2 where they fill
    them but a causal prompt of 512 rows or more leaves the last blocks with
    most of the keys (GPT-2's 1024-token prefill: 384 blocks of 32 rows),
    or where blocks of 32 rows are needed to fill them; else 4 (its
    128-token prefill: 96 blocks of 16 rows, each key tile split four
    ways)."""
    blocks = -(-Tq // 64) * Hq * B
    if blocks >= sms and not (causal and Tq >= 512):
        return 1
    return 2 if 2 * blocks >= sms else 4


def _rows16(t: torch.Tensor) -> bool:
    """Rows of ``t`` (a unit-stride last axis) start on 16-byte boundaries."""
    el = t.element_size()
    return t.data_ptr() % 16 == 0 and all((st * el) % 16 == 0 for st in t.stride()[:-1])


def mha(q, k, v, mask=None, *, scale: Optional[float] = None, causal: bool = False,
        softcap: float = 0.0):
    """Flash attention, the kernels of ``csrc/mha.cu`` (replace
    ``rten_tpu/kernels/flash_attention.py:mha_pallas``): q [B,Hq,Tq,D], k/v
    [B,Hkv,Tk,D] in q's dtype (f32 or bf16; any even D up to 256), each with
    a unit-stride last axis; ``mask`` an optional additive f32 mask of at most 2 dims that
    broadcasts to [Tq, Tk] (the Attention op folds leading unit dims);
    softcap; causal with offset Tk - Tq -> [B,Hq,Tq,D] in q's dtype. A row
    whose every column is masked gives 0 (the plain version gives the mean
    of V). D <= 128 runs on tensor cores (``mha_form``; f32 in 3xTF32),
    D 129-256 on CUDA cores. For CPU tensors, ``mha_plain``."""
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
    _check_head_dim(D, MHA_MAX_HEAD_DIM)
    if Hq % Hkv or Tq < 1 or Tk < 1:
        raise ValueError(f"heads {Hq}/{Hkv}, Tq {Tq}, Tk {Tk} not supported")
    if q.dtype not in _MHA_DTYPES:
        raise TypeError(f"q: dtype {q.dtype}, expected float32 or bfloat16")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_cuda_tensor(name, t, q.dtype, device, contiguous=False)
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the last axis must be unit-stride")
    if q.dtype == torch.bfloat16:  # the 4-byte copies take bf16 pairs
        q, k, v = (t if t.data_ptr() % 4 == 0 and all(st % 2 == 0 for st in t.stride()[:-1])
                   else t.contiguous() for t in (q, k, v))
    m_ptr, m_sq, m_sk = None, 0, 0
    if mask is not None:
        mask = mask.to(torch.float32).expand(Tq, Tk)
        check_cuda_tensor("mask", mask, torch.float32, device, contiguous=False)
        m_ptr, m_sq, m_sk = mask.data_ptr(), mask.stride(0), mask.stride(1)
    if scale is None:
        scale = 1.0 / float(np.sqrt(D))
    out = torch.empty((B, Hq, Tq, D), dtype=q.dtype, device=device)
    form = mha_form(D)
    key_warps = mha_key_warps(B, Hq, Tq, bool(causal), sm_count(device.index))
    vec = int(all(_rows16(t) for t in (q, k, v)))
    err = _mha_kernel_lib().rten_mha(
        _MHA_DTYPES[q.dtype], q.data_ptr(), *q.stride()[:3], k.data_ptr(), *k.stride()[:3],
        v.data_ptr(), *v.stride()[:3], m_ptr, m_sq, m_sk, out.data_ptr(), *out.stride()[:3],
        B, Hq, Hkv, Tq, Tk, D, int(bool(causal)), float(softcap or 0.0), float(scale),
        key_warps, vec, torch.cuda.current_stream(device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"mha ({form}) launch failed: CUDA error {err}")
    mha.launches += 1
    if form == "cuda_core":
        mha.cuda_core_launches += 1
    return out


# Every launch, and (of them) those on CUDA cores (D 129-256).
mha.launches = 0
mha.cuda_core_launches = 0


def decode_mha_plain(q, k, v, lens, k_scale=None, v_scale=None, *,
                     scale=None, window: int = 0, recent_k=None, recent_v=None, t=None):
    """The JAX package's ``decode_mha_xla``: q [B,H,S,D], k/v [B,Hkv,cap,D]
    f32 or bf16 (widened to f32), or s8 [B,Hkv,cap,D] or int4 u8
    [B,Hkv,cap,D/2] (``unpack_int4``) with scales [B,Hkv,cap]; row r of
    slot b attends cache columns <= lens[b] + r (and > lens[b] + r - window).
    A row with no such column gets the mean of V, as the reference's
    additive -1e30 mask gives it (the kernels give 0 there, as the TPU
    kernel does).

    Deferred KV (``recent_k``/``recent_v`` [B,Hkv,W,D] f32 or bf16, the step
    ``t``): every row attends the cache strictly below lens[b] (lens is the
    dispatch's lens0) and window rows r <= t, the same for every slot;
    ``window`` is not read."""
    B, H, S, D = q.shape
    Hkv, cap = k.shape[1], k.shape[2]
    if k.dtype == torch.uint8:
        kf, vf = unpack_int4(k), unpack_int4(v)
    else:
        kf, vf = k.to(torch.float32), v.to(torch.float32)
    if k_scale is not None:
        kf = kf * k_scale.reshape(B, Hkv, cap, 1)
        vf = vf * v_scale.reshape(B, Hkv, cap, 1)
    lens = lens.reshape(B).to(torch.int64)
    j = torch.arange(cap, device=q.device)[None, None, None, :]
    if recent_k is not None:
        W = recent_k.shape[2]
        tt = torch.as_tensor(t, device=q.device).reshape(-1)[0].to(torch.int64)
        valid = torch.cat([
            (j < lens[:, None, None, None]).expand(B, 1, 1, cap),
            (torch.arange(W, device=q.device) <= tt).expand(B, 1, 1, W),
        ], dim=3).expand(B, 1, S, cap + W)
        mask = torch.where(valid, 0.0, NEG_INF).to(torch.float32)
        kf = torch.cat([kf, recent_k.to(torch.float32)], dim=2)
        vf = torch.cat([vf, recent_v.to(torch.float32)], dim=2)
        return mha_plain(q, kf, vf, mask, scale=scale)
    qpos = lens[:, None, None, None] + torch.arange(S, device=q.device)[None, None, :, None]
    valid = j <= qpos
    if window:
        valid &= j > qpos - window
    mask = torch.where(valid, 0.0, NEG_INF).to(torch.float32)
    return mha_plain(q, kf, vf, mask, scale=scale)


def write_recent(recent_k, recent_v, t, k_new, v_new):
    """The deferred step's window write, in place: the new rows k_new/v_new
    [B,Hkv,1,D] rounded to the window's dtype into row t of recent_k/recent_v
    [B,Hkv,W,D] (t clamped to [0, W - 1], as ``dynamic_update_slice``
    clamps it)."""
    W = recent_k.shape[2]
    tw = torch.as_tensor(t, device=recent_k.device).reshape(-1)[:1].to(torch.int64)
    tw = tw.clamp(0, W - 1)
    recent_k.index_copy_(2, tw, k_new.to(recent_k.dtype))
    recent_v.index_copy_(2, tw, v_new.to(recent_v.dtype))
    return recent_k, recent_v


def decode_attention_deferred_plain(q, k, v, lens0, k_scale=None, v_scale=None, *,
                                    scale=None, recent_k, recent_v, t, k_new, v_new):
    """Plain version of ``decode_attention_deferred`` (the JAX package's
    route off the TPU): write the new row into window row t, then
    ``decode_mha_plain`` over the cache below lens0 and the window rows
    <= t. Returns (out, recent_k, recent_v), the windows written in place."""
    write_recent(recent_k, recent_v, t, k_new, v_new)
    out = decode_mha_plain(q, k, v, lens0, k_scale, v_scale, scale=scale,
                           recent_k=recent_k, recent_v=recent_v, t=t)
    return out, recent_k, recent_v


def decode_attention_deferred(q, k, v, lens0, k_scale=None, v_scale=None, *,
                              scale=None, recent_k, recent_v, t, k_new, v_new):
    """A deferred-KV decode step (replaces
    ``rten_tpu/kernels/flash_attention.py:decode_attention_deferred``): q
    [B,H,S,D] f32 against the big caches (any kind ``decode_mha`` takes),
    valid strictly below lens0 [B] int32, and the recent windows
    recent_k/recent_v [B,Hkv,W,D] f32 or bf16, whose rows <= t (``t``: the
    step, an int or a one-element int32 tensor) every slot attends. The new
    row k_new/v_new [B,Hkv,1,D] f32 is first written into window row t,
    rounded to the window's dtype, and scored as the window holds it. Returns
    (out [B,H,S,D], recent_k, recent_v), the windows updated in place.

    On the card the fold writes the row itself, at any D and window dtype
    (the reference writes it in the kernel only on its aligned route, D %
    128 == 0 with an f32 window, and with a ``dynamic_update_slice`` first
    otherwise; both compute the same math). On the CPU,
    ``decode_attention_deferred_plain``."""
    out = decode_mha(q, k, v, lens0, k_scale, v_scale, scale=scale, recent_k=recent_k,
                     recent_v=recent_v, t=t, k_new=k_new, v_new=v_new)
    return out, recent_k, recent_v


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


SPLIT_TILE = 32    # keys a warp scores at once (csrc/decode_fold.cuh, fold_tile)
SPLIT_WARPS = 4    # warps of a split block, taking its chunk's tiles in turn
MAX_SPLITS = 64    # csrc/decode_fold.cuh, FOLD_MAX_SPLITS


def decode_split_plan(units: int, cap: int, sms: int = SMS) -> Tuple[int, int]:
    """(splits, chunk): a decode-attention call of ``units`` (slot, kv head)
    pairs over ``cap`` columns cuts each pair's columns [0, cap) into
    ``splits`` chunks of ``chunk`` columns, a multiple of the 32-key tile
    (the last chunk may be shorter, none is empty), one block of
    SPLIT_WARPS warps each, the warps taking the chunk's tiles in turn. The
    chunks are as long as lets units * splits blocks give each of ``sms``
    SMs one, at most MAX_SPLITS of them; where the units alone fill the
    card, one split. Shapes only: the kernels read lens on the card. 8
    chunks of 32 at Qwen2.5-1.5B's 16 x 2 and cap 256 (256 blocks), 4 of
    64 at TinyLlama's 16 x 4, one at GPT-2's 120 x 12."""
    tiles = max(1, -(-cap // SPLIT_TILE))
    want = -(-sms // max(units, 1))  # splits for one block an SM
    per = max(1, tiles // want, -(-tiles // MAX_SPLITS))  # tiles a chunk
    return -(-tiles // per), per * SPLIT_TILE


# (device index, stream) -> (counters int32, states float32)
_split_ws: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _split_workspace(device, stream: int, units: int, floats: int):
    """The arrival counters (all 0 between calls: each call's last blocks
    reset theirs) and the state storage of this device and stream, grown to
    ``units`` counters and ``floats`` floats. Kernels on one stream run in
    order, so one workspace serves every call made on it."""
    key = (device.index, stream)
    count, ws = _split_ws.get(key, (None, None))
    if count is None or count.numel() < units:
        count = torch.zeros(max(units, 2 * (0 if count is None else count.numel())),
                            dtype=torch.int32, device=device)
    if ws is None or ws.numel() < floats:
        ws = torch.empty(max(floats, 2 * (0 if ws is None else ws.numel())),
                         dtype=torch.float32, device=device)
    _split_ws[key] = (count, ws)
    return count, ws


def _split_args(device, stream: int, B: int, H: int, Hkv: int, D: int, cap: int):
    """(splits, chunk, workspace pointer, counters pointer) of a call; no
    workspace with one split. ``H``: the query rows of a slot (heads, times
    S for the fold's S > 1 rows)."""
    splits, chunk = decode_split_plan(B * Hkv, cap, sm_count(device.index))
    if splits == 1:
        return splits, chunk, None, None
    count, ws = _split_workspace(device, stream, B * Hkv, B * H * splits * (D + 2))
    return splits, chunk, ws.data_ptr(), count.data_ptr()


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
    if kc.dtype == torch.uint8:
        raise TypeError("kc: int4 (uint8) caches are head-major only")
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
    return kind, B, cap, D


@_holdable
def decode_mha_append_cat(q, kc, vc, lens, k_scale=None, v_scale=None, *,
                          k_new, v_new, scale: Optional[float] = None,
                          window: int = 0, block_table=None):
    """Decode attention + in-place append on cat-layout caches (S == 1).

    q [B,H,1,D] f32; kc/vc [B,cap,Hkv*D] holding rows < lens[b]: s8 with
    scales [B,Hkv,cap,1] f32, or f32 or bf16 with none; k_new/v_new
    [B,Hkv,1,D] f32 rows for position lens[b]; lens [B] int32. The caches
    (and scales) are updated in place. Returns (out [B,1,H*D] in cat layout,
    kc, vc, k_scale, v_scale), or (out, kc, vc) for f32/bf16 caches, as the
    reference returns them. Any even head dim up to 512 (the block-table
    mode: 256).

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
    _check_head_dim(D, 512)
    if Dq != D or H % Hkv:
        raise ValueError(f"head dim {D} (q {Dq}), heads {H}/{Hkv} not supported")
    HkvD = Hkv * D
    strides = (cap * HkvD, HkvD)
    out = _launch_append(q, kc, vc, (cap * HkvD, D, HkvD), k_scale, v_scale,
                         (Hkv * cap, cap, 1), lens, k_new, v_new, kind, D, cap, scale,
                         window, _vec16(kc, D, strides) & _vec16(vc, D, strides))
    decode_mha_append_cat.launches += 1
    return (out, kc, vc, k_scale, v_scale) if k_scale is not None else (out, kc, vc)


decode_mha_append_cat.launches = 0


def _launch_append(q, kc, vc, kv_strides, k_scale, v_scale, sc_strides, lens, k_new,
                   v_new, kind, D, cap, scale, window, vec):
    """The append on caches of either layout, addressed through (slot, kv
    head, row) strides -> out [B,1,H*D]: the split fold
    ``rten_decode_append_split`` (csrc/decode_append*.cu,
    ``decode_split_plan``)."""
    B, H = q.shape[0], q.shape[1]
    Hkv = k_new.shape[1]
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        if t.shape != (B, Hkv, 1, D) or t.dtype != torch.float32 or t.stride(-1) != 1:
            raise ValueError(f"{name}: expected float32 {(B, Hkv, 1, D)}")
    if scale is None:
        scale = 1.0 / float(np.sqrt(D))
    out = torch.empty((B, 1, H * D), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (q.data_ptr(), q.stride(0), q.stride(1),
            k_new.data_ptr(), k_new.stride(0), k_new.stride(1),
            v_new.data_ptr(), v_new.stride(0), v_new.stride(1),
            kc.data_ptr(), vc.data_ptr(), *kv_strides, _ptr(k_scale), _ptr(v_scale), *sc_strides,
            lens.data_ptr(), out.data_ptr(), B, H, Hkv, D, cap, int(window), float(scale), vec)
    split = _split_args(q.device, stream, B, H, Hkv, D, cap)
    fn = _append_lib(kc.dtype).rten_decode_append_split
    err = fn(kind, *args, *split, stream)
    if err:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")
    return out


def decode_mha_append_plain(q, k, v, lens, k_scale=None, v_scale=None, *, k_new, v_new,
                            scale=None, window: int = 0):
    """Plain version of ``decode_mha_append`` (the JAX package's
    ``decode_attention_append`` fallback): s8 caches quantize the new rows
    (scale max(absmax/127, 1e-8)); f32/bf16 caches round them to the cache
    dtype; each is written at row min(lens, cap - 1), then every row attends
    cache rows <= lens (``decode_mha_plain``). Updates the caches in place
    and returns what ``decode_mha_append`` returns."""
    B, Hkv = k_new.shape[0], k_new.shape[1]
    cap = k.shape[2]
    lens = lens.reshape(B)
    rows = lens.to(torch.int64).clamp(0, cap - 1)
    bidx = torch.arange(B, device=k.device)
    ks = vs = None
    if k_scale is not None:
        k_q, ks_new = quantize_rows(k_new)
        v_q, vs_new = quantize_rows(v_new)
        k[bidx, :, rows] = k_q[:, :, 0]
        v[bidx, :, rows] = v_q[:, :, 0]
        ks, vs = k_scale.view(B, Hkv, cap), v_scale.view(B, Hkv, cap)
        ks[bidx, :, rows] = ks_new.reshape(B, Hkv).to(ks.dtype)
        vs[bidx, :, rows] = vs_new.reshape(B, Hkv).to(vs.dtype)
    else:
        k[bidx, :, rows] = k_new[:, :, 0].to(k.dtype)
        v[bidx, :, rows] = v_new[:, :, 0].to(v.dtype)
    out = decode_mha_plain(q, k, v, lens, ks, vs, scale=scale, window=window)
    return (out, k, v, k_scale, v_scale) if ks is not None else (out, k, v)


@_holdable
def decode_mha_append(q, k, v, lens, k_scale=None, v_scale=None, *, k_new, v_new,
                      scale: Optional[float] = None, window: int = 0):
    """Decode attention with the in-kernel row write on head-major caches
    (S == 1; replaces ``rten_tpu/kernels/flash_attention.py:decode_mha_append``):
    q [B,H,1,D] f32; k/v [B,Hkv,cap,D] holding rows < lens[b]: s8 with
    scales [B,Hkv,cap,1] (or [B,Hkv,cap]) f32, or f32 or bf16 with none;
    k_new/v_new [B,Hkv,1,D] f32; lens [B] int32. The kernel is
    ``decode_mha_append_cat``'s (csrc/decode_append*.cu) on the caches'
    strides: it writes the new row at min(lens[b], cap - 1) (s8: quantized,
    with its scale) and attends rows <= lens[b] (> lens[b] - window with a
    window). Any even D up to 512. Returns (out [B,H,1,D], k, v, k_scale,
    v_scale), or (out, k, v) for f32/bf16 caches; out is a head-major view of
    a [B,1,H*D] buffer."""
    if kernel_device(q, k, v, lens, k_scale, v_scale, k_new, v_new) == "cpu":
        return decode_mha_append_plain(q, k, v, lens, k_scale, v_scale, k_new=k_new,
                                       v_new=v_new, scale=scale, window=window)
    device = q.device
    B, H, S, D = q.shape
    if S != 1:
        raise ValueError("decode_mha_append is a single-token decode kernel")
    if q.dtype != torch.float32 or q.stride(-1) != 1:
        raise ValueError("q: float32 with a unit-stride last axis required")
    kind = _kv_kind("k", k, k_scale, v_scale)
    if k.dtype == torch.uint8:
        raise TypeError("k: int4 (uint8) caches take the deferred path, not the append")
    if k.dim() != 4 or k.shape != v.shape or k.stride() != v.stride():
        raise ValueError(f"caches: expected two [B, Hkv, cap, D] tensors with one layout, "
                         f"got {tuple(k.shape)} / {tuple(v.shape)}")
    _, Hkv, cap, Dk = k.shape
    _check_head_dim(D, 512)
    if k.shape[0] != B or Dk != D or H % Hkv:
        raise ValueError(f"head dim {D} (caches {Dk}), heads {H}/{Hkv} not supported")
    for name, t in (("k", k), ("v", v)):
        check_cuda_tensor(name, t, k.dtype, device, contiguous=False)
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: rows must be unit-stride")
    sc_strides = (0, 0, 0)
    if k_scale is not None:
        ks, vs = k_scale.view(B, Hkv, cap), v_scale.view(B, Hkv, cap)
        for name, t in (("k_scale", ks), ("v_scale", vs)):
            check_cuda_tensor(name, t, torch.float32, device, contiguous=False)
        if ks.stride() != vs.stride():
            raise ValueError("k_scale and v_scale: one layout required")
        sc_strides = ks.stride()
    check_cuda_tensor("lens", lens, torch.int32, device)
    if lens.numel() != B:
        raise ValueError(f"lens: expected {B} values, got {tuple(lens.shape)}")
    vec = _vec16(k, D, k.stride()[:3]) & _vec16(v, D, v.stride()[:3])
    out = _launch_append(q, k, v, k.stride()[:3], k_scale, v_scale, sc_strides, lens, k_new,
                         v_new, kind, D, cap, scale, window, vec)
    decode_mha_append.launches += 1
    out = out.reshape(B, 1, H, D).permute(0, 2, 1, 3)
    return (out, k, v, k_scale, v_scale) if k_scale is not None else (out, k, v)


decode_mha_append.launches = 0


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
    shared row), then every slot attends through the table
    (``paged_decode_mha``'s split fold on the cat pools' strides, so group =
    H / Hkv <= ``fold_max_rows(D)``).
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
    if pool_kc.dtype == torch.uint8:
        raise TypeError("pool_kc: int4 (uint8) pools are not taken")
    NB, BS, HkvD = pool_kc.shape
    _check_head_dim(D, 256)
    if HkvD != Hkv * D or H % Hkv or H // Hkv > fold_max_rows(D):
        raise ValueError(f"head dim {D}, heads {H}/{Hkv}, pool rows {HkvD} not supported")
    for name, t in (("pool_kc", pool_kc), ("pool_vc", pool_vc)):
        check_cuda_tensor(name, t, pool_kc.dtype, device)
    if k_scale_pool is not None:
        for name, t in (("k_scale_pool", k_scale_pool), ("v_scale_pool", v_scale_pool)):
            check_cuda_tensor(name, t, torch.float32, device)
            if t.shape != (NB, Hkv, 1, BS):
                raise ValueError(f"{name}: expected {(NB, Hkv, 1, BS)}, got {tuple(t.shape)}")
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        if t.shape != (B, Hkv, 1, D) or t.dtype != torch.float32 or t.stride(-1) != 1:
            raise ValueError(f"{name}: expected float32 {(B, Hkv, 1, D)}")
    MB = _check_table(block_table, lens, B, device)
    out = torch.empty((B, 1, H * D), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _lib().rten_append_cat_write(
        kind, k_new.data_ptr(), k_new.stride(0), k_new.stride(1), v_new.data_ptr(),
        v_new.stride(0), v_new.stride(1), pool_kc.data_ptr(), pool_vc.data_ptr(),
        _ptr(k_scale_pool), _ptr(v_scale_pool), block_table.data_ptr(), MB, BS,
        lens.data_ptr(), B, Hkv, D, stream,
    )
    if not err:  # the fold over the cat pools: rows of Hkv * D, heads D apart
        vec = _vec16(pool_kc, D, (BS * HkvD, HkvD)) & _vec16(pool_vc, D, (BS * HkvD, HkvD))
        err = _paged_fold(kind, q, pool_kc, pool_vc, Hkv, (BS * HkvD, D, HkvD), k_scale_pool,
                          v_scale_pool, (Hkv * BS, BS, 1), block_table, MB, BS, lens, out,
                          window, scale, vec, stream)
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


@_holdable
def prefill_mha_cat(q, kc, vc, lens, k_scale=None, v_scale=None, *,
                    scale: Optional[float] = None, window: int = 0):
    """Prefill attention on cat-layout caches: q [B,H,S,D] f32, kc/vc
    [B,cap,Hkv*D] holding rows < lens[b]+S (the chunk's rows included), s8
    with scales [B,Hkv,cap,1] or f32 or bf16 with none (any even D up to
    256) -> [B,H,S,D] f32. On the card the result is a head-major view
    of a [B,S,H*D] buffer, so merging heads is free.

    The function is ``decode_mha``'s per-head form on the head-major views
    ``cat_to_heads`` gives (no copy: strides (cap*Hkv*D, D, Hkv*D)), so the
    card runs that form's tensor-core kernels (``heads_plan``), under this
    wrapper's own counters (``prefill_mha_cat.tf32_launches``: f32 caches
    at D <= 128; ``prefill_mha_cat.wide_launches``: D 129-256)."""
    if kernel_device(q, kc, vc, lens, k_scale, v_scale) == "cpu":
        return prefill_mha_cat_plain(
            q, kc, vc, lens, k_scale, v_scale, scale=scale, window=window
        )
    B, H, S, Dq = q.shape
    if kc.dim() != 3 or kc.shape[2] % Dq:
        raise ValueError(f"kc: expected [B, cap, Hkv * {Dq}], got {tuple(kc.shape)}")
    Hkv = kc.shape[2] // Dq
    _, _, cap, D = _check_common(q, kc, vc, lens, k_scale, v_scale, Hkv)
    _check_head_dim(D, 256)
    if H % Hkv:
        raise ValueError(f"heads {H}/{Hkv} not supported")
    ks = vs = None
    if k_scale is not None:
        ks, vs = k_scale.reshape(B, Hkv, cap), v_scale.reshape(B, Hkv, cap)
    out, plan = _heads_launch(q, cat_to_heads(kc, Hkv), cat_to_heads(vc, Hkv), lens, ks, vs,
                              scale, window)
    _count_heads(prefill_mha_cat, plan)
    return out


# Every launch, and (of them) decode_heads_tf32.cuh's (f32 caches at D <=
# 128) and decode_heads_wide.cuh's (D 129-512).
prefill_mha_cat.launches = 0
prefill_mha_cat.tf32_launches = 0
prefill_mha_cat.wide_launches = 0


FOLD_MAX_ROWS = 16  # group * S query rows one fold block holds at D <= 128


def fold_max_rows(D: int) -> int:
    """The query rows (group * S) one fold block holds at head dim D: 16 up
    to D 128, 8 up to 256, 4 up to 512 (its shared memory stays at 40 KB)."""
    return FOLD_MAX_ROWS if D <= 128 else 8 if D <= 256 else 4


def decode_mha(q, k, v, lens, k_scale=None, v_scale=None, *,
               scale: Optional[float] = None, window: int = 0,
               recent_k=None, recent_v=None, t=None, k_new=None, v_new=None):
    """Per-slot attention over head-major caches (the serving hot path of
    Llama-family graphs): q [B,H,S,D] f32; k/v [B,Hkv,cap,D] f32 or bf16,
    s8 with per-position scales k_scale/v_scale [B,Hkv,cap] f32, or int4
    (u8 [B,Hkv,cap,D/2], ``pack_int4``) with the same scales; lens [B] int32
    past lengths. Row r of slot b attends columns <= lens[b] + r (and
    > lens[b] + r - window when window > 0) -> [B,H,S,D] f32. Any even D up
    to 512.

    With ``recent_k``/``recent_v`` [B,Hkv,W,D] (f32 or bf16) and the step
    ``t``, the deferred-KV form: the cache strictly below lens[b] and the
    window rows <= t (with ``k_new``/``v_new`` [B,Hkv,1,D] f32 written into
    window row t first); see ``decode_attention_deferred``. The reference's
    refusals hold: a sliding window with a recent window, and int4 caches at
    S > 1 with a recent window, raise ``NotImplementedError``.

    Routing (the port's own): the fold (blocks per slot, kv head and split
    of the columns, ``decode_mha_folded``) when its group * S query rows fit
    one block (``fold_max_rows``), which covers every decode step of a model
    with group <= 16 at D <= 128 (TinyLlama: 8) and every deferred step; per
    head (``decode_mha_heads``) otherwise, which covers every admission."""
    S = q.shape[2]
    if recent_k is not None:
        if window:
            raise NotImplementedError(
                "sliding window + deferred-KV recent windows is unsupported "
                "(build the serving graph with deferred_kv=False)"
            )
        if k.dtype == torch.uint8 and S > 1:
            raise NotImplementedError("int4 KV with S>1 and a recent window is unsupported")
        return decode_mha_folded(q, k, v, lens, k_scale, v_scale, scale=scale,
                                 recent_k=recent_k, recent_v=recent_v, t=t, k_new=k_new,
                                 v_new=v_new)
    group = q.shape[1] // k.shape[1]
    if group * S <= fold_max_rows(q.shape[3]):
        return decode_mha_folded(q, k, v, lens, k_scale, v_scale,
                                 scale=scale, window=window)
    return decode_mha_heads(q, k, v, lens, k_scale, v_scale,
                            scale=scale, window=window)


# Cache dtypes whose values bf16 holds exactly: the fold and the per-head
# form run them on tensor cores in bf16 parts (csrc/decode_fold_tc.cuh,
# csrc/decode_heads_tc.cuh) up to D 128.
TENSOR_CORE_KV = (torch.int8, torch.uint8, torch.bfloat16)
TENSOR_CORE_MAX_D = 128


def heads_form(dtype, D: int) -> str:
    """The kernel family ``decode_mha_heads`` launches for a cache dtype and
    head dim: "tensor_core" at every head dim the kernels take (D even, up
    to 512) and every cache kind; ``heads_plan`` names the kernel."""
    _check_head_dim(D, 512)
    return "tensor_core"


class HeadsPlan(NamedTuple):
    """How the per-head form runs a cache dtype and head dim on the card,
    mirroring the kernels' constants (``csrc/decode_heads_tc.cuh`` TcTile,
    ``decode_heads_tf32.cuh`` Tf32Tile, ``decode_heads_wide.cuh``
    WideTile): the ``kernel`` ("tc": three bf16 parts at D <= 128; "tf32":
    f32 caches at D <= 128; "wide": every kind at D 129-512), the head-dim
    instance ``dp``, the query ``rows`` a block and the ``threads`` a block,
    the ``keys`` of a tile, the ``slices`` of the output dims (warps that
    share 16 rows, each owning 128 dims) and the dynamic shared bytes
    ``smem`` a block takes (at most ``MAX_SMEM``)."""
    kernel: str
    dp: int
    rows: int
    threads: int
    keys: int
    slices: int
    smem: int


MAX_SMEM = 232448  # shared bytes one block may use on the H100


def heads_plan(dtype, D: int) -> HeadsPlan:
    """The plan of a per-head call on ``dtype`` caches at head dim ``D``."""
    _check_head_dim(D, 512)
    dp = 64 if D <= 64 else 128 if D <= 128 else 256 if D <= 256 else 512
    quant, f32 = dtype in QUANT_KV, dtype == torch.float32
    raw_row = dp // 2 if dtype == torch.uint8 else dp  # staged bytes a row (s8, int4)
    if dp <= 128:
        if f32:
            pitch, keys = dp + 4, 32
            return HeadsPlan("tf32", dp, 64, 128, keys, 1,
                             (64 * pitch + 3 * 2 * keys * pitch) * 4)
        tile = 64 * (dp + 8)  # bf16 elements of a 64-key K or V tile
        smem = 2 * tile * 2 + 4 * 64 * raw_row + 4 * 64 * 4 if quant else 4 * tile * 2
        return HeadsPlan("tc", dp, 64, 128, 64, 1, smem)
    slices = dp // 128
    rows = 16 * 8 // slices
    keys = 16 if dp == 512 else 32
    pitch = dp + 4 if f32 else dp + 8  # q's and a tile's elements a row
    q_bytes = rows * pitch * 4 if f32 else 3 * rows * pitch * 2  # f32 rows, or three bf16 planes
    tile = keys * pitch
    kv = (2 * tile * 2 + 4 * keys * raw_row + 4 * keys * 4 if quant
          else 4 * tile * (4 if f32 else 2))
    psum = 8 * (keys // 8) * 32 * 16  # each warp's partial scores
    return HeadsPlan("wide", dp, rows, 256, keys, slices, q_bytes + kv + psum)


def fold_form(dtype, D: int, recent_dtype=None) -> str:
    """The kernel ``decode_mha_folded`` launches for a cache dtype, head dim
    and recent window dtype (None: no window): "tensor_core"
    (``csrc/decode_fold_tc.cuh``: bf16 ``mma.sync``, keys on the M side,
    q and p * vs in three bf16 parts) for s8, int4 and bf16 caches at D <=
    128 with no window or a bf16 one; "cuda_core" (``csrc/decode_fold.cuh``,
    f32 FMAs) for f32 caches and f32 windows, whose values bf16 does not
    hold, and for D 129-512. Both split each (slot, kv head)'s columns over
    blocks (``decode_split_plan``)."""
    return ("tensor_core" if dtype in TENSOR_CORE_KV and D <= TENSOR_CORE_MAX_D
            and recent_dtype in (None, torch.bfloat16) else "cuda_core")


def _heads_launch(q, k, v, lens, k_scale, v_scale, scale, window):
    """The per-head form's kernel (``heads_plan``), launched on head-major
    caches (or views) -> (out, plan)."""
    plan = heads_plan(k.dtype, q.shape[3])
    out = _decode_mha_launch("heads_tc", q, k, v, lens, k_scale, v_scale, scale, window)
    return out, plan


def _count_heads(fn, plan: HeadsPlan) -> None:
    """One launch of a per-head wrapper, and of the kernel ``plan`` names."""
    fn.launches += 1
    if plan.kernel == "tf32":
        fn.tf32_launches += 1
    elif plan.kernel == "wide":
        fn.wide_launches += 1


def _decode_lib_name(dtype, D: int, entry: str) -> str:
    """The library that holds decode_mha's ``entry`` (``rten_decode_mha_
    <entry>``) for a cache dtype and head dim (csrc/decode_mha*.cu): int4
    keeps its CUDA-core fold (f32 windows) apart; past D 128 the per-head
    form has libraries of its own, f32 apart."""
    if D > 128:
        if entry != "heads_tc":
            return "decode_mha_wide"
        return "decode_mha_wide_heads_f32" if dtype == torch.float32 else "decode_mha_wide_heads"
    if dtype == torch.uint8:
        return "decode_mha_u4_win" if entry == "folded" else "decode_mha_u4"
    return {torch.bfloat16: "decode_mha_bf16", torch.float32: "decode_mha_f32"}.get(
        dtype, "decode_mha")


def _decode_mha_launch(form, q, k, v, lens, k_scale, v_scale, scale, window,
                       recent=None):
    """Check what the kernels take, then launch ``rten_decode_mha_<form>``
    (``_decode_lib_name``; the folds with the split of ``decode_split_plan``).
    ``recent``: (recent_k, recent_v, t, k_new, v_new) for the deferred fold.
    Returns [B,H,S,D] f32, a head-major view of a [B,S,H*D] buffer, so
    merging heads afterwards is free."""
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
    _check_head_dim(D, 512)
    row = D // 2 if k.dtype == torch.uint8 else D
    if k.shape[0] != B or Dk != row or H % Hkv:
        raise ValueError(f"head dim {D} (caches {Dk}), heads {H}/{Hkv}, "
                         f"slots {B}/{k.shape[0]} not supported")
    for name, t in (("k", k), ("v", v)):
        check_cuda_tensor(name, t, k.dtype, device, contiguous=False)
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: rows must be unit-stride")
    vec = _vec16(k, row, k.stride()[:3]) & _vec16(v, row, v.stride()[:3])
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
    win = (None, None, 0, 0, 0, 0, 0, 0, None, None, None, 0, 0)
    if recent is not None:
        rk, rv, t, kn, vn = recent
        W = rk.shape[2]
        if rk.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"recent_k: dtype {rk.dtype}, expected float32 or bfloat16")
        if (rk.dim() != 4 or rk.shape != (B, Hkv, W, D) or rv.shape != rk.shape
                or rv.stride() != rk.stride() or W < 1 or rk.stride(-1) != 1):
            raise ValueError(f"recent windows: expected two {(B, Hkv, 'W', D)} tensors with "
                             f"one layout, got {tuple(rk.shape)} / {tuple(rv.shape)}")
        for name, x in (("recent_k", rk), ("recent_v", rv)):
            check_cuda_tensor(name, x, rk.dtype, device, contiguous=False)
        t = torch.as_tensor(t, dtype=torch.int32, device=device).reshape(-1)
        check_cuda_tensor("t", t, torch.int32, device)
        kn_ptrs, n_strides = (None, None), (0, 0)
        if kn is not None:
            for name, x in (("k_new", kn), ("v_new", vn)):
                check_cuda_tensor(name, x, torch.float32, device, contiguous=False)
                if (x.shape != (B, Hkv, 1, D) or x.stride(-1) != 1
                        or x.stride()[:2] != kn.stride()[:2]):
                    raise ValueError(f"{name}: expected float32 {(B, Hkv, 1, D)} rows in one "
                                     f"layout")
            kn_ptrs, n_strides = (kn.data_ptr(), vn.data_ptr()), kn.stride()[:2]
        win = (rk.data_ptr(), rv.data_ptr(), *rk.stride()[:3], W,
               int(rk.dtype == torch.bfloat16), _vec16(rk, D, rk.stride()[:3]), t.data_ptr(),
               *kn_ptrs, *n_strides)
    if scale is None:
        scale = 1.0 / float(np.sqrt(D))
    out_cat = torch.empty((B, S, H * D), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    split = (_split_args(device, stream, B, H * S, Hkv, D, cap) if form.startswith("folded")
             else (0, 0, None, None))
    fn = getattr(_mha_lib(_decode_lib_name(k.dtype, D, form)), f"rten_decode_mha_{form}")
    err = fn(
        kind, q.data_ptr(), *q.stride()[:3],
        k.data_ptr(), v.data_ptr(), *k.stride()[:3],
        *sc_ptrs, *sc_strides, lens.data_ptr(), out_cat.data_ptr(),
        S * H * D, D, H * D, B, H, Hkv, S, D, cap, int(window), float(scale), vec, *win,
        *split, stream,
    )
    if err:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")
    return out_cat.reshape(B, S, H, D).permute(0, 2, 1, 3)


@_holdable
def decode_mha_folded(q, k, v, lens, k_scale=None, v_scale=None, *,
                      scale: Optional[float] = None, window: int = 0,
                      recent_k=None, recent_v=None, t=None, k_new=None, v_new=None):
    """``decode_mha``'s fold form (replaces
    ``rten_tpu/kernels/flash_attention.py:_decode_mha_folded``): a block per
    (slot, kv head, split of its columns) holding its group * S <=
    ``fold_max_rows(D)`` rows, the last block of a (slot, kv head) merging
    the splits; with a recent window the deferred form (``decode_mha``).
    Routed by ``fold_form``: on tensor cores or (counted by
    ``decode_mha_folded.cuda_core_launches``) on CUDA cores."""
    if kernel_device(q, k, v, lens, k_scale, v_scale, recent_k, recent_v, t, k_new,
                     v_new) == "cpu":
        if recent_k is None:
            return decode_mha_plain(q, k, v, lens, k_scale, v_scale,
                                    scale=scale, window=window)
        if k_new is not None:
            write_recent(recent_k, recent_v, t, k_new, v_new)
        return decode_mha_plain(q, k, v, lens, k_scale, v_scale, scale=scale,
                                recent_k=recent_k, recent_v=recent_v, t=t)
    group = q.shape[1] // k.shape[1]
    if group * q.shape[2] > fold_max_rows(q.shape[3]):
        raise ValueError(f"the fold holds {fold_max_rows(q.shape[3])} rows per kv head at "
                         f"D {q.shape[3]}, got group {group} x S {q.shape[2]}")
    recent = None if recent_k is None else (recent_k, recent_v, t, k_new, v_new)
    form = fold_form(k.dtype, q.shape[3], None if recent_k is None else recent_k.dtype)
    out = _decode_mha_launch("folded_tc" if form == "tensor_core" else "folded", q, k, v, lens,
                             k_scale, v_scale, scale, window, recent)
    decode_mha_folded.launches += 1
    if form == "cuda_core":
        decode_mha_folded.cuda_core_launches += 1
    return out


# Every launch, and (of them) the CUDA-core form's.
decode_mha_folded.launches = 0
decode_mha_folded.cuda_core_launches = 0


@_holdable
def decode_mha_heads(q, k, v, lens, k_scale=None, v_scale=None, *,
                     scale: Optional[float] = None, window: int = 0):
    """``decode_mha``'s per-head form (replaces
    ``rten_tpu/kernels/flash_attention.py:decode_mha``'s per-head grid),
    on tensor cores at every head dim (``heads_plan``): one block per
    (query tile of ``rows``, head, slot)."""
    if kernel_device(q, k, v, lens, k_scale, v_scale) == "cpu":
        return decode_mha_plain(q, k, v, lens, k_scale, v_scale,
                                scale=scale, window=window)
    out, plan = _heads_launch(q, k, v, lens, k_scale, v_scale, scale, window)
    _count_heads(decode_mha_heads, plan)
    return out


# Every launch, and (of them) decode_heads_tf32.cuh's (f32 caches at D <=
# 128) and decode_heads_wide.cuh's (D 129-512).
decode_mha_heads.launches = 0
decode_mha_heads.tf32_launches = 0
decode_mha_heads.wide_launches = 0


def paged_decode_mha_plain(q, pool_k, pool_v, lens, block_table, pool_ks=None,
                           pool_vs=None, *, scale=None, window: int = 0):
    """Plain version of ``paged_decode_mha`` (the JAX package's
    ``paged_attention`` fallback): gather each slot's blocks into a
    contiguous view, then ``decode_mha_plain``."""
    k, v, ks, vs = _paged_gather(pool_k, pool_v, pool_ks, pool_vs, block_table)
    return decode_mha_plain(q, k, v, lens, ks, vs, scale=scale, window=window)


@_holdable
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
    ``fold_max_rows(D)``; any even D up to 512."""
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
    if pool_k.dtype == torch.uint8:
        raise TypeError("pool_k: int4 (uint8) pools are not taken")
    quant = pool_ks is not None
    if pool_k.dim() != 4 or pool_k.shape != pool_v.shape or pool_k.stride() != pool_v.stride():
        raise ValueError(f"pools: expected two [NB, Hkv, BS, D] tensors with one layout, "
                         f"got {tuple(pool_k.shape)} / {tuple(pool_v.shape)}")
    NB, Hkv, BS, Dk = pool_k.shape
    _check_head_dim(D, 512)
    if Dk != D or H % Hkv or H // Hkv > fold_max_rows(D):
        raise ValueError(f"head dim {D} (pools {Dk}), heads {H}/{Hkv} not supported")
    for name, t in (("pool_k", pool_k), ("pool_v", pool_v)):
        check_cuda_tensor(name, t, pool_k.dtype, device, contiguous=False)
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: rows must be unit-stride")
    vec = _vec16(pool_k, D, pool_k.stride()[:3]) & _vec16(pool_v, D, pool_v.stride()[:3])
    if quant:
        for name, t in (("pool_ks", pool_ks), ("pool_vs", pool_vs)):
            check_cuda_tensor(name, t, torch.float32, device, contiguous=False)
            if t.shape != (NB, Hkv, 1, BS) or t.stride() != pool_ks.stride():
                raise ValueError(f"{name}: expected {(NB, Hkv, 1, BS)} in one layout, "
                                 f"got {tuple(t.shape)}")
        sc_strides = (pool_ks.stride(0), pool_ks.stride(1), pool_ks.stride(3))
    else:
        sc_strides = (0, 0, 0)
    MB = _check_table(block_table, lens, B, device)
    out_cat = torch.empty((B, 1, H * D), dtype=torch.float32, device=device)
    err = _paged_fold(kind, q, pool_k, pool_v, Hkv, pool_k.stride()[:3], pool_ks, pool_vs,
                      sc_strides, block_table, MB, BS, lens, out_cat, window, scale, vec,
                      torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_decode_mha launch failed: CUDA error {err}")
    paged_decode_mha.launches += 1
    return out_cat.reshape(B, 1, H, D).permute(0, 2, 1, 3)


paged_decode_mha.launches = 0


def _paged_fold(kind, q, k, v, Hkv, kv_strides, ks, vs, sc_strides, bt, MB, BS, lens, out,
                window, scale, vec, stream) -> int:
    """``rten_paged_decode_mha`` (csrc/paged_decode_mha*.cu): the split fold
    of q [B,H,1,D] over the pools k/v of Hkv heads addressed through (block,
    kv head, row) strides and the table, into out [B,1,H*D]; returns the
    CUDA error code."""
    B, H, _, D = q.shape
    if scale is None:
        scale = 1.0 / float(np.sqrt(D))
    split = _split_args(q.device, stream, B, H, Hkv, D, MB * BS)
    return _paged_lib(k.dtype).rten_paged_decode_mha(
        kind, q.data_ptr(), q.stride(0), q.stride(1), k.data_ptr(), v.data_ptr(), *kv_strides,
        _ptr(ks), _ptr(vs), *sc_strides, bt.data_ptr(), MB, BS, lens.data_ptr(),
        out.data_ptr(), H * D, D, B, H, Hkv, D, int(window), float(scale), vec, *split, stream,
    )


def paged_attention(q, pool_k, pool_v, lens, block_table, pool_ks=None, pool_vs=None, *,
                    scale: Optional[float] = None, window: int = 0):
    """Attention of q [B,H,S,D] over head-major block pools, routed by shape
    alone (the JAX package's ``paged_attention``): a decode step (S == 1,
    group <= ``fold_max_rows(D)``) reads the pools through the table in
    ``paged_decode_mha``; anything else (an admission) gathers each slot's
    blocks into a contiguous view for ``decode_mha``."""
    group = q.shape[1] // pool_k.shape[1]
    if q.shape[2] == 1 and group <= fold_max_rows(q.shape[3]):
        return paged_decode_mha(q, pool_k, pool_v, lens, block_table, pool_ks, pool_vs,
                                scale=scale, window=window)
    k, v, ks, vs = _paged_gather(pool_k, pool_v, pool_ks, pool_vs, block_table)
    return decode_mha(q, k, v, lens, ks, vs, scale=scale, window=window)


def _mha_lib(name):
    """A decode_mha library (``_decode_lib_name``) with its entry points'
    argument types."""
    lib = load_library(name)
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    for fn in (lib.rten_decode_mha_folded, lib.rten_decode_mha_folded_tc,
               lib.rten_decode_mha_heads_tc):
        if fn.argtypes is None:
            fn.argtypes = [I, P, L, L, L, P, P, L, L, L, P, P, L, L, L, P, P,
                           L, L, L, I, I, I, I, I, I, I, F, I,
                           P, P, L, L, L, I, I, I, P, P, P, L, L, I, I, P, P, P]
            fn.restype = I
    return lib


def _mha_kernel_lib():
    lib = load_library("mha")
    fn = lib.rten_mha
    if fn.argtypes is None:
        P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        fn.argtypes = [I, P, L, L, L, P, L, L, L, P, L, L, L, P, L, L, P, L, L, L,
                       I, I, I, I, I, I, I, F, F, I, I, P]
        fn.restype = I
    return lib


def _paged_lib(dtype):
    """``csrc/paged_decode_mha.cu``'s library for s8 pools,
    ``paged_decode_mha_f32.cu``'s for f32, ``paged_decode_mha_bf16.cu``'s
    for bf16."""
    lib = load_library({torch.bfloat16: "paged_decode_mha_bf16",
                        torch.float32: "paged_decode_mha_f32"}.get(dtype, "paged_decode_mha"))
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    fn = lib.rten_paged_decode_mha
    if fn.argtypes is None:
        fn.argtypes = [I, P, L, L, P, P, L, L, L, P, P, L, L, L, P, I, I, P, P,
                       L, L, I, I, I, I, I, F, I, I, I, P, P, P]
        fn.restype = I
    return lib


# The flat append's entry point's arguments after the kind, before the split's
# (csrc/decode_append*.cu, rten_decode_append_split).
_APPEND_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong] * 3 + [
    ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [
    ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [
    ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int]


def _append_lib(dtype):
    """``csrc/decode_append.cu``'s library for s8 caches,
    ``decode_append_f32.cu``'s for f32, ``decode_append_bf16.cu``'s for
    bf16."""
    lib = load_library({torch.bfloat16: "decode_append_bf16",
                        torch.float32: "decode_append_f32"}.get(dtype, "decode_append"))
    fn = lib.rten_decode_append_split
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [I, *_APPEND_ARGS, I, I, P, P, P]
        fn.restype = I
    return lib


def _lib():
    lib = load_library("flash_attention")
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    if lib.rten_append_cat_write.argtypes is None:
        lib.rten_append_cat_write.argtypes = [
            I, P, L, L, P, L, L, P, P, P, P, P, I, I, P, I, I, I, P,
        ]
        lib.rten_append_cat_write.restype = I
    return lib
