"""The arithmetic of ``decode_mha``'s per-head form on f32 caches at head
dims up to 128 (``rten_tpu_torch/csrc/decode_heads_tf32.cuh``), modelled on
the CPU in PyTorch and held against the JAX package.

The model repeats the kernel's order and rounding points: per (slot, head),
the keys in the kernel's 32-key tiles from the first column a window lets
the block's rows attend; both products in 3xTF32 (every f32 operand split
as big = cvt.rna.tf32(x), small = the same rounding of x - big; a product
big.big + big.small + small.big with f32 sums); an online softmax in base 2
(the scale times log2(e), p = 2^(s - m)); a row with no column gives 0. It
is held within 1e-5 of max|out| against the JAX package's ``decode_mha_xla``
and the port's ``decode_mha_plain`` (f32 throughout), and against the
interpreted Pallas per-head grid (``decode_mha(..., interpret=True)`` at S
past the fold's 8 rows), on seeded numpy inputs: D 64, 80 and 128, GQA, a
window, rows with no column. One TF32 pass misses the limit: the reason
the kernel takes three.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rten_tpu.kernels import flash_attention as jfa
from rten_tpu_torch.kernels import flash_attention as tfa

TILE, ROWS = 32, 64  # the kernel's key tile and query rows a block
LIMIT = 1e-5  # of max|out|
LOG2E = np.float32(np.log2(np.e))
XLA = jax.jit(jfa.decode_mha_xla, static_argnames=("scale", "window"))


def tf32(x):
    """cvt.rna.tf32.f32 on finite f32 values: the low 13 bits of the
    magnitude rounded off, ties away from zero."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def mm3(a, b):
    """a @ b in 3xTF32 (f32 sums), the small terms first."""
    ab, bb = tf32(a), tf32(b)
    asm, bsm = tf32(a - ab), tf32(b - bb)
    return (asm @ bb + ab @ bsm) + ab @ bb


def mm1(a, b):
    return tf32(a) @ tf32(b)


def heads_tf32(q, k, v, lens, *, scale, window=0, mm=mm3):
    """The 3xTF32 per-head form: q [B,H,S,D], k/v [B,Hkv,cap,D] f32."""
    B, H, S, D = q.shape
    cap = k.shape[2]
    k = k.repeat_interleave(H // k.shape[1], 1)
    v = v.repeat_interleave(H // v.shape[1], 1)
    scale2 = np.float32(scale) * LOG2E
    out = torch.zeros(B, H, S, D)
    for b in range(B):
        n = int(lens[b])
        for r0 in range(0, S, ROWS):
            rows = torch.arange(r0, min(r0 + ROWS, S))
            pos = n + rows
            kmax = min(n + int(rows[-1]), cap - 1)
            kmin = max(0, n + r0 - window + 1) if window else 0
            m = torch.full((H, len(rows)), -torch.inf)
            l = torch.zeros(H, len(rows))
            acc = torch.zeros(H, len(rows), D)
            for k0 in range(kmin // TILE * TILE, kmax + 1, TILE):
                j = torch.arange(k0, min(k0 + TILE, kmax + 1))
                s = mm(q[b, :, rows], k[b, :, j].transpose(1, 2)) * scale2
                ok = j[None] <= pos[:, None]
                if window:
                    ok &= j[None] > pos[:, None] - window
                s = torch.where(ok, s, -torch.inf)
                m_new = torch.maximum(m, s.amax(2))
                mu = torch.where(m_new == -torch.inf, 0.0, m_new)
                alpha = torch.exp2(m - mu)
                p = torch.exp2(s - mu[..., None])
                l = l * alpha + p.sum(2)
                acc = acc * alpha[..., None] + mm(p, v[b, :, j])
                m = m_new
            out[b, :, rows] = torch.where(l[..., None] > 0,
                                          acc / torch.where(l > 0, l, 1.0)[..., None], 0.0)
    return out


def _inputs(B, H, Hkv, S, D, cap, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, S, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, Hkv, cap, D)).astype(np.float32) for _ in "kv")
    return q, k, v


def _close(got, want, live, limit=LIMIT):
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want)[live].max()
    assert err <= limit * np.abs(want[live]).max(), (err, np.abs(want[live]).max())


@pytest.mark.parametrize("B,H,Hkv,S,D,cap,window", [
    (2, 8, 2, 70, 64, 128, 0),    # GQA, a ragged second 64-row tile
    (2, 4, 4, 24, 80, 96, 0),     # D 80: a masked tail
    (2, 4, 2, 40, 128, 96, 20),   # D 128, a window; rows with no column
])
def test_heads_tf32_model_matches_f32_references(B, H, Hkv, S, D, cap, window):
    q, k, v = _inputs(B, H, Hkv, S, D, cap, S + D + window)
    lens = np.array([5, cap + window + 3], np.int32) if window else np.array([0, cap - S],
                                                                              np.int32)
    scale = 1.0 / np.sqrt(D)
    tq, tk, tv, tl = (torch.from_numpy(a) for a in (q, k, v, lens))
    got = heads_tf32(tq, tk, tv, tl, scale=scale, window=window)
    plain = tfa.decode_mha_plain(tq, tk, tv, tl, scale=scale, window=window)
    xla = XLA(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens), None, None,
              scale=scale, window=window)
    qpos = lens.astype(np.int64)[:, None] + np.arange(S)[None]
    live = (qpos - window < cap - 1) if window else np.ones_like(qpos, bool)
    live = np.broadcast_to(live[:, None, :, None], got.shape)
    for want in (plain, xla):
        _close(got, want, live)
    assert not got.numpy()[~live].any()  # no column: 0 (the references give the mean of V)


def test_heads_tf32_model_matches_pallas_interpret():
    """Against the interpreted Pallas per-head grid (S 24 > the fold's 8
    rows), f32 caches: the same 1e-5 of max|out| (the reference's f32 path
    scores in f32)."""
    B, H, Hkv, S, D, cap = 2, 4, 2, 24, 64, 128
    q, k, v = _inputs(B, H, Hkv, S, D, cap, 5)
    lens = np.array([10, 90], np.int32)
    scale = 1.0 / np.sqrt(D)
    got = heads_tf32(*(torch.from_numpy(a) for a in (q, k, v, lens)), scale=scale)
    want = np.asarray(jfa.decode_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(lens), scale=scale, interpret=True))
    _close(got, want, np.ones(got.shape, bool))


def test_one_tf32_pass_misses_the_limit():
    B, H, Hkv, S, D, cap = 2, 4, 2, 24, 64, 96
    q, k, v = _inputs(B, H, Hkv, S, D, cap, 9)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    lens = torch.tensor([7, 60], dtype=torch.int32)
    plain = tfa.decode_mha_plain(tq, tk, tv, lens, scale=0.125)
    top = plain.abs().max()
    err3 = (heads_tf32(tq, tk, tv, lens, scale=0.125) - plain).abs().max() / top
    err1 = (heads_tf32(tq, tk, tv, lens, scale=0.125, mm=mm1) - plain).abs().max() / top
    assert err3 <= LIMIT / 10 and err1 > 10 * LIMIT
