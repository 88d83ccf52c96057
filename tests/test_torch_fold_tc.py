"""The arithmetic of ``decode_mha``'s fold on tensor cores
(``rten_tpu_torch/csrc/decode_fold_tc.cuh``), modelled on the CPU in
PyTorch and held against the JAX package.

The model repeats the kernel's order and rounding points: each (slot, kv
head)'s columns cut into the wrapper's real chunks (``decode_split_plan``),
one block each; the block's 16-key tiles (in the last split of a deferred
step the recent window's first, then the cache's from the chunk's first
live column rounded down to 16) taken in turn by four warps; every warp an
online
softmax in base 2 over its tiles (the scale times log2(e), p = 2^(s - m))
for the block's group * S query rows (keys on the M side: the score is
S^T = K . q^T, the value product O^T = V^T . (p vs)^T); K and V as the bf16
values of their codes (exact for s8, int4 and bf16 caches), q and p * vs
each split into three bf16 parts whose products are summed; the warps'
states merged in warp order, then the splits' in split order; a row with
no column gives 0.

It is held within 1e-5 of max|out| against the JAX package's XLA paths
(``decode_mha_xla``, ``decode_attention_deferred(use_flash=False)``) and
against the port's plain versions, and at the reference's bf16 bound (rtol
2e-2, atol 5e-3) against the interpreted Pallas fold (``decode_mha(...,
interpret=True)``, which reaches ``_decode_mha_folded``), on seeded numpy
inputs: s8, int4 and bf16 caches; groups 1, 6 and 8; S 1 and 2; a sliding
window; the deferred bf16 window; rows with no column.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rten_tpu.kernels import flash_attention as jfa
from rten_tpu_torch.kernels import flash_attention as tfa

KEYS, WARPS, PARTS = 16, 4, 3  # the kernel's tile, warps a block, bf16 parts
LIMIT = 1e-5  # of max|out|
LOG2E = np.float32(np.log2(np.e))
# The XLA references, each one compiled program a shape (op-by-op dispatch
# compiles every op of them apart).
XLA = jax.jit(jfa.decode_mha_xla, static_argnames=("scale", "window"))
DEFERRED = jax.jit(jfa.decode_attention_deferred, static_argnames=("scale", "use_flash"))


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _parts(x, n=None):
    n = PARTS if n is None else n
    parts = []
    for _ in range(n):
        parts.append(_bf16(x))
        x = x - parts[-1]
    return parts


def _codes(k):
    """The values the kernel's tiles hold: s8 and int4 codes, bf16 values."""
    kf = tfa.unpack_int4(k) if k.dtype == torch.uint8 else k.to(torch.float32)
    assert torch.equal(_bf16(kf), kf)
    return kf


def _online(state, s, w_parts, vt):
    """One tile into a warp's (m, l, acc): s [R, n] scores in base 2."""
    m, l, acc = state
    m_new = torch.maximum(m, s.amax(1))
    mu = torch.where(m_new == -torch.inf, 0.0, m_new)
    alpha = torch.exp2(m - mu)
    p = torch.exp2(s - mu[:, None])
    w = w_parts(p)
    return m_new, l * alpha + p.sum(1), acc * alpha[:, None] + sum(x @ vt for x in _parts(w))


def _merge(states):
    """States merged in order (warps, or the splits online as the last
    block does): M = max m, c = 2^(m - M), L = sum c l, O = sum c acc."""
    m = torch.stack([s[0] for s in states])
    mx = m.amax(0)
    mu = torch.where(mx == -torch.inf, 0.0, mx)
    c = torch.exp2(m - mu)
    return (mx, sum(ci * s[1] for ci, s in zip(c, states)),
            sum(ci[:, None] * s[2] for ci, s in zip(c, states)))


def fold_tc(q, k, v, lens, ks, vs, *, scale, window=0, recent=None, sms=tfa.SMS):
    """The tensor-core fold's function and rounding points. ``recent``:
    (rk, rv, t) with rk/rv the bf16 windows after the new row's write."""
    B, H, S, D = q.shape
    Hkv, cap = k.shape[1], k.shape[2]
    group, R = H // Hkv, (H // Hkv) * S
    splits, chunk = tfa.decode_split_plan(B * Hkv, cap, sms)
    kf, vf = _codes(k), _codes(v)
    ksc = torch.ones(B, Hkv, cap) if ks is None else ks
    vsc = torch.ones(B, Hkv, cap) if vs is None else vs
    scale2 = np.float32(scale) * LOG2E
    out = torch.zeros(B, H, S, D)
    rows = torch.arange(R)
    for b in range(B):
        n = int(lens[b])
        pos = n + rows % S
        if recent is not None:
            hi, lo = min(n - 1, cap - 1), 0
            wlast = min(int(recent[2]), recent[0].shape[2] - 1)
        else:
            hi, lo = min(n + S - 1, cap - 1), (max(0, n - window + 1) if window else 0)
        for hk in range(Hkv):
            qr = q[b, hk * group + rows // S, rows % S]  # [R, D]
            qp = _parts(qr)
            states = []
            for z in range(splits):
                blo, bhi = max(lo, z * chunk), min(hi, z * chunk + chunk - 1)
                kstart = blo // KEYS * KEYS
                tiles = []  # (valid [R, n], K rows, V rows, k scales, v scales)
                if recent is not None and z == splits - 1:
                    for k0 in range(0, wlast + 1, KEYS):
                        j = torch.arange(k0, min(k0 + KEYS, wlast + 1))
                        ok = torch.ones(R, len(j), dtype=torch.bool)
                        tiles.append((ok, recent[0][b, hk, j], recent[1][b, hk, j],
                                      torch.ones(len(j)), torch.ones(len(j))))
                if bhi >= blo:
                    for k0 in range(kstart, bhi + 1, KEYS):
                        j = torch.arange(k0, min(k0 + KEYS, bhi + 1))
                        ok = (j[None] <= bhi) & (j[None] <= (bhi if recent is not None
                                                               else pos[:, None]))
                        if window and recent is None:
                            ok &= j[None] > pos[:, None] - window
                        tiles.append((ok, kf[b, hk, j], vf[b, hk, j], ksc[b, hk, j],
                                      vsc[b, hk, j]))
                warps = [(torch.full((R,), -torch.inf), torch.zeros(R), torch.zeros(R, D))
                         for _ in range(WARPS)]
                for i, (ok, kt, vt, kst, vst) in enumerate(tiles):
                    s = sum(x @ kt.T for x in qp) * scale2 * kst
                    s = torch.where(ok, s, -torch.inf)
                    warps[i % WARPS] = _online(warps[i % WARPS], s, lambda p: p * vst, vt)
                states.append(_merge(warps))
            _, L, O = _merge(states)
            o = torch.where(L[:, None] > 0, O / torch.where(L > 0, L, 1.0)[:, None], 0.0)
            out[b, hk * group + rows // S, rows % S] = o
    return out


def _inputs(kv, B, H, Hkv, S, D, cap, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, S, D)).astype(np.float32)
    if kv == "s8":
        k, v = (rng.integers(-127, 128, (B, Hkv, cap, D)).astype(np.int8) for _ in "kv")
        ks, vs = ((rng.random((B, Hkv, cap)) * 0.015 + 0.005).astype(np.float32) for _ in "kv")
    elif kv == "int4":
        k, v = (rng.integers(0, 256, (B, Hkv, cap, D // 2)).astype(np.uint8) for _ in "kv")
        ks, vs = ((rng.random((B, Hkv, cap)) * 0.3 + 0.05).astype(np.float32) for _ in "kv")
    else:
        k, v = (rng.standard_normal((B, Hkv, cap, D)).astype(np.float32) for _ in "kv")
        ks = vs = None
    return q, k, v, ks, vs


def _torch(a, bf16=False):
    if a is None:
        return None
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(torch.bfloat16) if bf16 else t


def _jax(a, bf16=False):
    return None if a is None else jnp.asarray(a, jnp.bfloat16 if bf16 else None)


def _close(got, want, live, limit=LIMIT):
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want)[live].max()
    assert err <= limit * np.abs(want[live]).max(), (err, np.abs(want[live]).max())


# (kv, B, H, Hkv, S, D, cap, window): groups 1, 6, 8; S 1 and 2; a window;
# D 80 (a masked tail); the smallest shapes that still split.
CASES = [
    ("s8", 3, 16, 2, 1, 64, 128, 0),
    ("bf16", 3, 16, 2, 1, 64, 128, 0),
    ("int4", 3, 16, 2, 1, 64, 128, 0),
    ("s8", 2, 12, 2, 2, 64, 96, 0),      # group 6, S 2: 12 rows, two n-tiles
    ("bf16", 2, 4, 4, 2, 80, 96, 0),     # group 1, S 2, D 80
    ("int4", 2, 6, 1, 2, 64, 96, 20),    # group 6, S 2, a window
    ("s8", 4, 8, 1, 1, 64, 128, 24),     # group 8, a window; rows with no column
    ("bf16", 4, 2, 2, 1, 64, 160, 0),    # group 1
]


@pytest.mark.parametrize("kv,B,H,Hkv,S,D,cap,window", CASES)
def test_fold_tc_model_matches_f32_references(kv, B, H, Hkv, S, D, cap, window):
    q, k, v, ks, vs = _inputs(kv, B, H, Hkv, S, D, cap, B * H + S + D + window + len(kv))
    lens = np.array([0, 17, cap - S, cap + window + 5, cap // 2][:B], np.int32)
    scale = 1.0 / np.sqrt(D)
    bf = kv == "bf16"
    tq, tk, tv, tks, tvs = _torch(q), _torch(k, bf), _torch(v, bf), _torch(ks), _torch(vs)
    got = fold_tc(tq, tk, tv, torch.from_numpy(lens), tks, tvs, scale=scale, window=window)
    plain = tfa.decode_mha_plain(tq, tk, tv, torch.from_numpy(lens), tks, tvs, scale=scale,
                                 window=window)
    xla = XLA(_jax(q), _jax(k, bf), _jax(v, bf), _jax(lens), _jax(ks), _jax(vs), scale=scale,
              window=window)
    qpos = lens.astype(np.int64)[:, None] + np.arange(S)[None]
    live = (qpos - window < cap - 1) if window else np.ones_like(qpos, bool)
    live = np.broadcast_to(live[:, None, :, None], got.shape)
    for want in (plain, xla):
        _close(got, want, live)
    assert not got.numpy()[~live].any()  # no column: 0 (the references give the mean of V)
    splits, _ = tfa.decode_split_plan(B * Hkv, cap)
    assert splits > 1


@pytest.mark.parametrize("kv", ["s8", "int4", "bf16"])
@pytest.mark.parametrize("B,H,Hkv,W,t,sms,cap", [(3, 16, 2, 8, 7, 132, 96),
                                                 (2, 4, 4, 40, 33, 8, 256)])
def test_fold_tc_deferred_matches_references(kv, B, H, Hkv, W, t, sms, cap):
    """The deferred step: the new row written (rounded to bf16) into window
    row t of its own (slot, kv head), then the cache below lens0 and the
    window rows <= t, the window's tiles first in the last split's turns
    (at sms 8 and cap 256 one split of 256 keys)."""
    D = 64
    q, k, v, ks, vs = _inputs(kv, B, H, Hkv, 1, D, cap, W + t + len(kv))
    rng = np.random.default_rng(W * t)
    rk, rv = (rng.standard_normal((B, Hkv, W, D)).astype(np.float32) for _ in "kv")
    kn, vn = (rng.standard_normal((B, Hkv, 1, D)).astype(np.float32) for _ in "kv")
    lens0 = np.array([0, cap - 7, cap][:B], np.int32)
    scale = 1.0 / np.sqrt(D)
    bf = kv == "bf16"
    tq, tk, tv, tks, tvs = _torch(q), _torch(k, bf), _torch(v, bf), _torch(ks), _torch(vs)
    trk, trv = _torch(rk, True), _torch(rv, True)
    want_t, wk, wv = tfa.decode_attention_deferred_plain(
        tq, tk, tv, torch.from_numpy(lens0), tks, tvs, scale=scale, recent_k=trk.clone(),
        recent_v=trv.clone(), t=t, k_new=_torch(kn), v_new=_torch(vn))
    got = fold_tc(tq, tk, tv, torch.from_numpy(lens0), tks, tvs, scale=scale,
                  recent=(wk.float(), wv.float(), t), sms=sms)
    want_j, jk, jv = DEFERRED(
        _jax(q), _jax(k, bf), _jax(v, bf), _jax(lens0), _jax(ks), _jax(vs), scale=scale,
        recent_k=_jax(rk, True), recent_v=_jax(rv, True), t=t, k_new=_jax(kn), v_new=_jax(vn),
        use_flash=False)
    assert np.array_equal(np.asarray(jk.astype(jnp.float32)), wk.float().numpy())
    live = np.ones(got.shape, bool)
    for want in (want_t, want_j):
        _close(got, want, live)


@pytest.mark.parametrize("kv", ["s8", "int4"])
def test_fold_tc_long_chunks_match_references(kv):
    """GPT-2's shape in small (group 1; units that fill the SMs: one split
    of 256 keys)."""
    B, H, Hkv, S, D, cap, sms = 2, 8, 8, 1, 64, 256, 8
    q, k, v, ks, vs = _inputs(kv, B, H, Hkv, S, D, cap, 21 + len(kv))
    lens = np.array([200, cap + 3], np.int32)
    assert tfa.decode_split_plan(B * Hkv, cap, sms) == (1, 256)
    tq, tk, tv, tks, tvs = _torch(q), _torch(k), _torch(v), _torch(ks), _torch(vs)
    got = fold_tc(tq, tk, tv, torch.from_numpy(lens), tks, tvs, scale=0.125, sms=sms)
    want = XLA(_jax(q), _jax(k), _jax(v), _jax(lens), _jax(ks), _jax(vs), scale=0.125, window=0)
    _close(got, want, np.ones(got.shape, bool))


@pytest.mark.parametrize("kv", ["s8", "int4", "bf16"])
def test_fold_tc_model_matches_pallas_interpret(kv):
    """Against the interpreted Pallas fold (``_decode_mha_folded`` at cap
    128), whose dots round q and p to bf16: the reference's bf16 bound."""
    B, H, Hkv, S, D, cap = 2, 8, 2, 1, 64, 128
    q, k, v, ks, vs = _inputs(kv, B, H, Hkv, S, D, cap, 11 + len(kv))
    lens = np.array([30, 100], np.int32)
    scale = 1.0 / np.sqrt(D)
    bf = kv == "bf16"
    got = fold_tc(_torch(q), _torch(k, bf), _torch(v, bf), torch.from_numpy(lens), _torch(ks),
                  _torch(vs), scale=scale).numpy()
    want = np.asarray(jfa.decode_mha(_jax(q), _jax(k, bf), _jax(v, bf), _jax(lens), _jax(ks),
                                     _jax(vs), scale=scale, interpret=True))
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=5e-3)


def test_one_bf16_part_misses_the_limit():
    """Three parts of q and p * vs land within the limit; one (the TPU
    kernel's bf16 dots) lands some 1e-3 of max|out| away."""
    B, H, Hkv, S, D, cap = 2, 8, 2, 1, 64, 128
    q, k, v, ks, vs = _inputs("s8", B, H, Hkv, S, D, cap, 3)
    lens = torch.tensor([40, 120], dtype=torch.int32)
    tq, tk, tv, tks, tvs = (_torch(a) for a in (q, k, v, ks, vs))
    plain = tfa.decode_mha_plain(tq, tk, tv, lens, tks, tvs, scale=0.125)
    top = plain.abs().max()
    err3 = (fold_tc(tq, tk, tv, lens, tks, tvs, scale=0.125) - plain).abs().max() / top
    global PARTS
    PARTS, saved = 1, PARTS
    try:
        err1 = (fold_tc(tq, tk, tv, lens, tks, tvs, scale=0.125) - plain).abs().max() / top
    finally:
        PARTS = saved
    assert err3 <= LIMIT / 10 and err1 > 10 * LIMIT


@pytest.mark.parametrize("B,Hkv,cap,want", [
    (16, 4, 256, (4, 64)),     # TinyLlama's decode step: 256 blocks
    (16, 2, 256, (8, 32)),     # Qwen2.5-1.5B's: 256 blocks
    (120, 12, 256, (1, 256)),  # GPT-2's: 1440 units fill the card alone
])
def test_flat_fold_split_plan(B, Hkv, cap, want):
    """The flat fold's units (slots x kv heads) through the plan the wrapper
    runs, one block per SM wherever the columns allow it."""
    splits, chunk = tfa.decode_split_plan(B * Hkv, cap)
    assert (splits, chunk) == want
    assert chunk % KEYS == 0 and (splits - 1) * chunk < cap <= splits * chunk
    assert B * Hkv * splits >= tfa.SMS
