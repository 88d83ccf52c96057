"""The arithmetic of ``decode_mha_heads`` on tensor cores
(``rten_tpu_torch/csrc/decode_heads_tc.cuh``), emulated on the CPU in
PyTorch: bf16 operands with f32 sums, K and V as the bf16 values of their
codes (exact: s8, int4 and bf16 caches), q and p * vs each split into
bf16 parts (hi = bf16(x), then the rounding of what is left, three parts
in the kernel) with the parts' products summed, an online softmax in base
2 (the scale times log2(e), p = 2^(s - m)) over the kernel's 64-key tiles,
l summing the unscaled p, 0 for a row with no column. Small
TinyLlama-shaped inputs (2 slots, H 8 over 2, D 64 and 80, S 24, cap 64),
s8, bf16 and int4 caches, with and without a window, one slot whose rows
have no column at all.

The emulation stays within 1e-5 x max|out| (in fact 1e-6) of the port's
``decode_mha_plain`` and of the JAX package's ``decode_mha_xla`` (both f32
throughout) on every row with a column. One bf16 rounding of q and of p *
vs (the TPU kernel's ``_dot_f32``) lands 1e-3 away; two parts (hi and lo)
land 2-5e-6 away, close enough for 1e-4 but not for the card-against-CPU
engine references, whose u8 activations then round apart on the card (the
reason the kernel takes three).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rten_tpu.kernels import flash_attention as jfa
from rten_tpu_torch.kernels import flash_attention as tfa

B, H, HKV, S, CAP = 2, 8, 2, 24, 64
TILE = 64  # the kernel's key tile
LIMIT = 1e-5  # of max|out|
PARTS = 3     # the kernel's bf16 parts of q and of p * vs


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _parts(x, n):
    """x as n bf16 parts (hi, then the rounding of each remainder), as the
    kernel feeds it to bf16 products."""
    parts = []
    for _ in range(n):
        parts.append(_bf16(x))
        x = x - parts[-1]
    return parts


def tc_attention(q, k, v, lens, ks, vs, *, scale, window=0, parts=PARTS):
    """The tensor-core per-head form's function and rounding points."""
    scale2 = np.float32(scale) * np.float32(np.log2(np.e))
    if k.dtype == torch.uint8:
        kf, vf = tfa.unpack_int4(k), tfa.unpack_int4(v)  # codes (nibble - 8)
    else:
        kf, vf = k.to(torch.float32), v.to(torch.float32)
    assert torch.equal(_bf16(kf), kf) and torch.equal(_bf16(vf), vf)  # exact in bf16
    group = q.shape[1] // k.shape[1]
    kf, vf = kf.repeat_interleave(group, 1), vf.repeat_interleave(group, 1)
    ks = torch.ones(kf.shape[:3]) if ks is None else ks.repeat_interleave(group, 1)
    vs = torch.ones(kf.shape[:3]) if vs is None else vs.repeat_interleave(group, 1)
    qpos = lens.long()[:, None, None, None] + torch.arange(q.shape[2])[None, None, :, None]
    m = torch.full(q.shape[:3] + (1,), -torch.inf)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape)
    for k0 in range(0, k.shape[2], TILE):
        cols = torch.arange(k0, min(k0 + TILE, k.shape[2]))
        kt, vt = kf[:, :, cols], vf[:, :, cols]
        s = sum(torch.matmul(p, kt.transpose(2, 3)) for p in _parts(q, parts))
        s = s * scale2 * ks[:, :, None, cols]
        ok = cols <= qpos
        if window:
            ok &= cols > qpos - window
        s = torch.where(ok, s, -torch.inf)
        m_new = torch.maximum(m, s.amax(3, keepdim=True))
        mu = torch.where(m_new == -torch.inf, 0.0, m_new)
        alpha = torch.exp2(m - mu)
        p = torch.exp2(s - mu)
        l = l * alpha + p.sum(3, keepdim=True)
        w = p * vs[:, :, None, cols]
        acc = acc * alpha + sum(torch.matmul(x, vt) for x in _parts(w, parts))
        m = m_new
    return torch.where(l > 0, acc / torch.where(l > 0, l, 1.0), 0.0)


def _inputs(kv, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, S, D)).astype(np.float32)
    if kv == "s8":
        k, v = (rng.integers(-127, 128, (B, HKV, CAP, D)).astype(np.int8) for _ in "kv")
        ks, vs = ((rng.random((B, HKV, CAP)) * 0.015 + 0.005).astype(np.float32) for _ in "kv")
    elif kv == "int4":
        k, v = (rng.integers(0, 256, (B, HKV, CAP, D // 2)).astype(np.uint8) for _ in "kv")
        ks, vs = ((rng.random((B, HKV, CAP)) * 0.3 + 0.05).astype(np.float32) for _ in "kv")
    else:
        k, v = (rng.standard_normal((B, HKV, CAP, D)).astype(np.float32) for _ in "kv")
        ks = vs = None
    # Slot 0 mid-cache; slot 1 at cap + 20: with a window every row of it
    # starts past the cache's end and has no column to attend.
    lens = np.array([20, CAP + 20], np.int32)
    return q, k, v, lens, ks, vs


def _torch(a, kv=None):
    if a is None:
        return None
    t = torch.from_numpy(a)
    return t.to(torch.bfloat16) if kv == "bf16" else t


def _jax(a, kv=None):
    if a is None:
        return None
    return jnp.asarray(a, jnp.bfloat16 if kv == "bf16" else None)


def _live(lens, window, D):
    qpos = lens.astype(np.int64)[:, None] + np.arange(S)[None]
    live = (qpos - window < CAP - 1) if window else np.ones_like(qpos, bool)
    return np.broadcast_to(live[:, None, :, None], (B, H, S, D))


CASES = [(kv, D, window) for kv in ("s8", "bf16", "int4") for D in (64, 80) for window in (0, 16)]


@pytest.mark.parametrize("kv,D,window", CASES)
def test_split_bf16_matches_f32_references(kv, D, window):
    q, k, v, lens, ks, vs = _inputs(kv, D, D + window + len(kv))
    scale = 1.0 / np.sqrt(D)
    tq, tk, tv, tl, tks, tvs = (_torch(a, kv if a is k or a is v else None)
                                for a in (q, k, v, lens, ks, vs))
    got = tc_attention(tq, tk, tv, tl, tks, tvs, scale=scale, window=window).numpy()
    plain = tfa.decode_mha_plain(tq, tk, tv, tl, tks, tvs, scale=scale, window=window).numpy()
    xla = np.asarray(jfa.decode_mha_xla(_jax(q), _jax(k, kv), _jax(v, kv), _jax(lens),
                                        _jax(ks), _jax(vs), scale=scale, window=window))
    live = _live(lens, window, D)
    limit = LIMIT * np.abs(plain[live]).max()
    for want in (plain, xla):
        assert np.abs(got - want)[live].max() <= limit / 10
    if window:  # slot 1: no column for any row -> 0 (the references give the mean of V)
        assert not live[1].any() and not got[1].any()


@pytest.mark.parametrize("kv", ["s8", "bf16", "int4"])
def test_single_bf16_rounding_misses_the_limit(kv):
    """One bf16 rounding of q and of p * vs, the TPU kernel's arithmetic,
    lands some 1e-3 of max|out| away: 100 times the split's limit. Two
    parts land between 1e-6 and 1e-5; three parts under 1e-6."""
    D = 64
    q, k, v, lens, ks, vs = _inputs(kv, D, 7)
    scale = 1.0 / np.sqrt(D)
    tq, tk, tv, tl, tks, tvs = (_torch(a, kv if a is k or a is v else None)
                                for a in (q, k, v, lens, ks, vs))
    plain = tfa.decode_mha_plain(tq, tk, tv, tl, tks, tvs, scale=scale).numpy()
    top = np.abs(plain).max()
    err = {n: np.abs(tc_attention(tq, tk, tv, tl, tks, tvs, scale=scale, parts=n).numpy()
                      - plain).max() / top for n in (1, 2, 3)}
    assert err[3] <= LIMIT / 10 < err[2] <= LIMIT
    assert err[1] > 10 * LIMIT
