"""Attention over int8 cat-layout KV caches: the wrappers of the CUDA
kernels in ``csrc/flash_attention.cu`` and their plain PyTorch versions.

* ``decode_mha_append_cat`` replaces
  ``rten_tpu/kernels/flash_attention.py:decode_mha_append_cat``: one decode
  step that quantizes the new K/V row, writes it in place at row
  ``min(lens[b], cap - 1)`` and attends rows ``<= lens[b]``.
* ``prefill_mha_cat`` replaces
  ``rten_tpu/kernels/flash_attention.py:prefill_mha_cat``: prefill off
  caches that already hold the chunk's rows; row r attends ``<= lens[b]+r``.

Caches are ``[B, cap, Hkv*D]`` s8 with scales ``[B, Hkv, cap, 1]`` f32
(the engine's canonical shape). Only s8 caches are covered; f32/bf16
caches and paged block pools raise (ROADMAP.md queue 1 items 7 and 8).

The plain versions repeat the JAX package's CPU path
(``decode_attention_append_cat``'s fallback and ``decode_mha_xla``):
dequantize, materialize the scores with an additive -1e30 mask, softmax.
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


def mha_plain(q, k, v, mask=None, *, scale=None):
    """Materialized-score attention (the JAX package's ``mha_xla``)."""
    B, Hq, Tq, D = q.shape
    Hkv = k.shape[1]
    if scale is None:
        scale = 1.0 / float(np.sqrt(D))
    if Hq != Hkv:
        k = k.repeat_interleave(Hq // Hkv, dim=1)
        v = v.repeat_interleave(Hq // Hkv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        s = s + mask
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float())


def decode_mha_plain(q, k, v, lens, k_scale, v_scale, *, scale=None,
                     window: int = 0):
    """The JAX package's ``decode_mha_xla`` for s8 caches: q [B,H,S,D],
    k/v [B,Hkv,cap,D] s8, scales [B,Hkv,cap]; row r of slot b attends
    cache columns <= lens[b] + r (and > lens[b] + r - window)."""
    B, H, S, D = q.shape
    Hkv, cap = k.shape[1], k.shape[2]
    kf = k.to(torch.float32) * k_scale.reshape(B, Hkv, cap, 1)
    vf = v.to(torch.float32) * v_scale.reshape(B, Hkv, cap, 1)
    lens = lens.reshape(B).to(torch.int64)
    j = torch.arange(cap, device=q.device)[None, None, None, :]
    qpos = lens[:, None, None, None] + torch.arange(S, device=q.device)[None, None, :, None]
    valid = j <= qpos
    if window:
        valid &= j > qpos - window
    mask = torch.where(valid, 0.0, NEG_INF).to(torch.float32)
    return mha_plain(q, kf, vf, mask, scale=scale)


def _check_quant(k_scale, v_scale):
    if k_scale is None or v_scale is None:
        raise NotImplementedError(
            "f32/bf16 cat caches: ROADMAP.md queue 1 item 7"
        )


def decode_mha_append_cat_plain(q, kc, vc, lens, k_scale, v_scale, *, k_new,
                                v_new, scale=None, window: int = 0):
    """Plain version of ``decode_mha_append_cat`` (same contract): quantize
    the new rows, write them in place at the clamped row, attend."""
    _check_quant(k_scale, v_scale)
    B, Hkv = k_new.shape[0], k_new.shape[1]
    cap = kc.shape[1]
    lens = lens.reshape(B)
    wpos = lens.clamp(0, cap - 1).to(torch.int64)
    bidx = torch.arange(B, device=kc.device)
    k_q, ks_new = quantize_rows(k_new)
    v_q, vs_new = quantize_rows(v_new)
    kc[bidx, wpos] = heads_to_cat(k_q)[:, 0]
    vc[bidx, wpos] = heads_to_cat(v_q)[:, 0]
    k_scale[bidx, :, wpos] = ks_new.reshape(B, Hkv, 1).to(k_scale.dtype)
    v_scale[bidx, :, wpos] = vs_new.reshape(B, Hkv, 1).to(v_scale.dtype)
    out = decode_mha_plain(
        q, cat_to_heads(kc, Hkv), cat_to_heads(vc, Hkv), lens,
        k_scale.reshape(B, Hkv, cap), v_scale.reshape(B, Hkv, cap),
        scale=scale, window=window,
    )
    return heads_to_cat(out), kc, vc, k_scale, v_scale


def _check_common(q, kc, vc, lens, k_scale, v_scale, Hkv):
    device = q.device
    if q.dtype != torch.float32 or q.stride(-1) != 1:
        raise ValueError("q: float32 with a unit-stride last axis required")
    check_cuda_tensor("kc", kc, torch.int8, device)
    check_cuda_tensor("vc", vc, torch.int8, device)
    check_cuda_tensor("k_scale", k_scale, torch.float32, device)
    check_cuda_tensor("v_scale", v_scale, torch.float32, device)
    check_cuda_tensor("lens", lens, torch.int32, device)
    B, cap, HkvD = kc.shape
    if vc.shape != kc.shape or HkvD % Hkv:
        raise ValueError(f"cache shapes {tuple(kc.shape)} / {tuple(vc.shape)}")
    D = HkvD // Hkv
    for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
        if s.numel() != B * Hkv * cap:
            raise ValueError(f"{name}: expected [B, Hkv, cap, 1] = "
                             f"{(B, Hkv, cap, 1)}, got {tuple(s.shape)}")
    if lens.numel() != B:
        raise ValueError(f"lens: expected {B} values, got {tuple(lens.shape)}")
    if kc.data_ptr() % 16 or vc.data_ptr() % 16:
        raise ValueError("caches must be 16-byte aligned")
    return B, cap, D


def decode_mha_append_cat(q, kc, vc, lens, k_scale=None, v_scale=None, *,
                          k_new, v_new, scale: Optional[float] = None,
                          window: int = 0):
    """Decode attention + in-place append on cat-layout s8 caches (S == 1).

    q [B,H,1,D] f32; kc/vc [B,cap,Hkv*D] s8 holding rows < lens[b];
    k_new/v_new [B,Hkv,1,D] f32 rows for position lens[b]; scales
    [B,Hkv,cap,1] f32; lens [B] int32. The caches and scales are updated in
    place. Returns (out [B,1,H*D] in cat layout, kc, vc, k_scale, v_scale).
    """
    _check_quant(k_scale, v_scale)
    if kernel_device(q, kc, vc, lens, k_scale, v_scale, k_new, v_new) == "cpu":
        return decode_mha_append_cat_plain(
            q, kc, vc, lens, k_scale, v_scale, k_new=k_new, v_new=v_new,
            scale=scale, window=window,
        )
    B, H, S, Dq = q.shape
    Hkv = k_new.shape[1]
    if S != 1:
        raise ValueError("decode_mha_append_cat is a single-token decode kernel")
    _, cap, D = _check_common(q, kc, vc, lens, k_scale, v_scale, Hkv)
    if Dq != D or H % Hkv or D not in (32, 64, 128):
        raise ValueError(f"head dim {D} (q {Dq}), heads {H}/{Hkv} not supported")
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        if t.shape != (B, Hkv, 1, D) or t.dtype != torch.float32 or t.stride(-1) != 1:
            raise ValueError(f"{name}: expected float32 {(B, Hkv, 1, D)}")
    if scale is None:
        scale = 1.0 / float(np.sqrt(D))
    out = torch.empty((B, 1, H * D), dtype=torch.float32, device=q.device)
    err = _lib().rten_decode_append_cat(
        q.data_ptr(), q.stride(0), q.stride(1),
        k_new.data_ptr(), k_new.stride(0), k_new.stride(1),
        v_new.data_ptr(), v_new.stride(0), v_new.stride(1),
        kc.data_ptr(), vc.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
        lens.data_ptr(), out.data_ptr(), B, H, Hkv, D, cap, int(window),
        float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"decode_mha_append_cat launch failed: CUDA error {err}")
    decode_mha_append_cat.launches += 1
    return out, kc, vc, k_scale, v_scale


decode_mha_append_cat.launches = 0


def prefill_mha_cat_plain(q, kc, vc, lens, k_scale, v_scale, *, scale=None,
                          window: int = 0):
    """Plain version of ``prefill_mha_cat``: head-major views of the caches
    through ``decode_mha_plain`` -> [B, H, S, D]."""
    _check_quant(k_scale, v_scale)
    B = q.shape[0]
    Hkv = k_scale.shape[1]
    cap = kc.shape[1]
    return decode_mha_plain(
        q, cat_to_heads(kc, Hkv), cat_to_heads(vc, Hkv), lens,
        k_scale.reshape(B, Hkv, cap), v_scale.reshape(B, Hkv, cap),
        scale=scale, window=window,
    )


def prefill_mha_cat(q, kc, vc, lens, k_scale=None, v_scale=None, *,
                    scale: Optional[float] = None, window: int = 0):
    """Prefill attention on cat-layout s8 caches: q [B,H,S,D] f32, kc/vc
    [B,cap,Hkv*D] holding rows < lens[b]+S (the chunk's rows included),
    scales [B,Hkv,cap,1] -> [B,H,S,D] f32. On the card the result is a
    head-major view of a [B,S,H*D] buffer, so merging heads is free."""
    _check_quant(k_scale, v_scale)
    if kernel_device(q, kc, vc, lens, k_scale, v_scale) == "cpu":
        return prefill_mha_cat_plain(
            q, kc, vc, lens, k_scale, v_scale, scale=scale, window=window
        )
    B, H, S, Dq = q.shape
    Hkv = k_scale.shape[1]
    _, cap, D = _check_common(q, kc, vc, lens, k_scale, v_scale, Hkv)
    if Dq != D or H % Hkv or D not in (32, 64):
        raise ValueError(f"head dim {D} (q {Dq}), heads {H}/{Hkv} not supported")
    if scale is None:
        scale = 1.0 / float(np.sqrt(D))
    out_cat = torch.empty((B, S, H * D), dtype=torch.float32, device=q.device)
    err = _lib().rten_prefill_cat(
        q.data_ptr(), q.stride(0), q.stride(1), q.stride(2),
        kc.data_ptr(), vc.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
        lens.data_ptr(), out_cat.data_ptr(), S * H * D, D, H * D,
        B, H, Hkv, S, D, cap, int(window), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"prefill_mha_cat launch failed: CUDA error {err}")
    prefill_mha_cat.launches += 1
    return out_cat.reshape(B, S, H, D).permute(0, 2, 1, 3)


prefill_mha_cat.launches = 0


def _lib():
    lib = load_library("flash_attention")
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    if lib.rten_decode_append_cat.argtypes is None:
        lib.rten_decode_append_cat.argtypes = [
            P, L, L, P, L, L, P, L, L, P, P, P, P, P, P,
            I, I, I, I, I, I, F, P,
        ]
        lib.rten_decode_append_cat.restype = I
        lib.rten_prefill_cat.argtypes = [
            P, L, L, L, P, P, P, P, P, P, L, L, L,
            I, I, I, I, I, I, I, F, P,
        ]
        lib.rten_prefill_cat.restype = I
    return lib
