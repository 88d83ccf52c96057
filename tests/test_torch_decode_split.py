"""Split-K decode attention (``csrc/decode_fold.cuh``'s split fold:
``paged_decode_mha``, the block-table append's attention and the flat
append of a grouped model) modelled on the CPU in PyTorch.

The model repeats the kernels' arithmetic and order: each (slot, kv head)'s
live columns cut into the wrapper's real chunks (``decode_split_plan``),
each chunk's live 32-key tiles taken in turn by KW tile groups of warps (4
where the chunk has 4 live tiles or more, 2 where it has 2 or 3, else 1:
the other warps of a group take other query rows, which changes no row's
arithmetic), every group keeping an online softmax per query row (scores
q . k_code * scale * k_scale, p = exp(s - m), P.V with p * v_scale), the
groups' states merged in group order, then the chunks' states merged in
chunk order; a row with no column gives 0. It is held within 1e-5 x
max|out| against the JAX package's XLA paths
(``decode_attention_append_cat(use_flash=False)``, ``paged_attention(
use_flash=False)``, both f32 throughout) and against the port's plain
versions, on seeded numpy inputs; against the interpreted Pallas kernels,
whose dots round q and p to bf16, at their bf16 bound (rtol 2e-2, atol
5e-3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rten_tpu.kernels import flash_attention as jfa
from rten_tpu_torch.kernels import flash_attention as tfa

TILE, WARPS = tfa.SPLIT_TILE, tfa.SPLIT_WARPS


def tile_groups(ntiles):
    """KW: the warp groups that take a split block's live tiles in turn."""
    return WARPS if ntiles >= WARPS else 2 if ntiles >= 2 else 1
LIMIT = 1e-5  # of max|out|
BF16 = jnp.bfloat16


def _merge(ms, ls, accs):
    """Online-softmax states (m [N, R], l [N, R], acc [N, R, D]) merged in
    order -> (m, l, acc) [R], [R], [R, D]."""
    mx = ms.max(0).values
    c = torch.where(ms == -torch.inf, torch.zeros_like(ms), torch.exp(ms - mx))
    return mx, (ls * c).sum(0), (accs * c[..., None]).sum(0)


def split_attention(q, kf, vf, ksc, vsc, lens, *, scale, window, splits, chunk):
    """The split fold's function: q [B, H, 1, D] f32 against kf/vf [B, Hkv,
    cap, D] (the values the kernel reads: s8 codes, bf16 widened) with scales
    ksc/vsc [B, Hkv, cap] (ones for unquantized caches) -> [B, H, 1, D]."""
    B, H, _, D = q.shape
    Hkv, cap = kf.shape[1], kf.shape[2]
    group = H // Hkv
    out = torch.zeros(B, H, 1, D)
    for b in range(B):
        n = int(lens[b])
        hi = min(n, cap - 1)
        lo = max(0, n - window + 1) if window else 0
        for hk in range(Hkv):
            qh = q[b, hk * group:(hk + 1) * group, 0]
            states = []
            for z in range(splits):
                zlo, zhi = max(lo, z * chunk), min(hi, z * chunk + chunk - 1)
                ntiles = (zhi - zlo) // TILE + 1 if zhi >= zlo else 0
                kw = tile_groups(ntiles)
                m = torch.full((kw, group), -torch.inf)
                l = torch.zeros(kw, group)
                acc = torch.zeros(kw, group, D)
                for t in range(ntiles):
                    j = torch.arange(zlo + TILE * t, min(zlo + TILE * (t + 1), zhi + 1))
                    s = (qh @ kf[b, hk, j].T) * scale * ksc[b, hk, j]
                    w = t % kw
                    m_new = torch.maximum(m[w], s.max(1).values)
                    alpha = torch.exp(m[w] - m_new)  # 0 while m is -inf; s is finite
                    p = torch.exp(s - m_new[:, None])
                    l[w] = l[w] * alpha + p.sum(1)
                    acc[w] = acc[w] * alpha[:, None] + (p * vsc[b, hk, j]) @ vf[b, hk, j]
                    m[w] = m_new
                states.append(_merge(m, l, acc))
            if splits > 1:
                _, L, O = _merge(*(torch.stack(x) for x in zip(*states)))
            else:
                _, L, O = states[0]
            out[b, hk * group:(hk + 1) * group, 0] = torch.where(
                L[:, None] > 0, O / torch.where(L > 0, L, 1)[:, None], 0.0)
    return out


def _live(lens, cap, window):
    """[B] True where the slot's decode row has a column to attend."""
    lens = np.asarray(lens, np.int64)
    return lens - window < cap - 1 if window else np.ones(lens.shape, bool)


def _close(got, want, live, limit=LIMIT):
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want)[live].max()
    assert err <= limit * np.abs(want[live]).max(), (err, np.abs(want[live]).max())


def _lens(cap, chunk, window, B):
    """0 (every chunk but the first empty), a chunk's edge, the last row,
    past cap, a window wholly past cap (no column), mid-range."""
    edges = [0, chunk - 1, cap - 1, cap + 5] + ([cap + window + 3] if window else [])
    mid = [cap // 2 + 7 * i for i in range(B)]
    return np.asarray((edges + mid)[:B], np.int32)


# --- the plan ------------------------------------------------------------------


@pytest.mark.parametrize("units,cap,sms", [
    (32, 256, 132), (64, 256, 132), (1440, 256, 132), (120, 256, 132), (16, 1024, 132),
    (4, 4096, 132), (1, 32, 132), (3, 96, 132), (100, 200, 132), (8, 256, 8), (2, 64, 4),
    (7, 33, 132), (128, 2048, 132),
])
def test_decode_split_plan(units, cap, sms):
    """Chunks of whole 32-key tiles cover [0, cap), none empty, at most
    MAX_SPLITS; one block per SM wherever the columns allow it."""
    splits, chunk = tfa.decode_split_plan(units, cap, sms)
    assert chunk % TILE == 0 and 1 <= splits <= tfa.MAX_SPLITS
    assert (splits - 1) * chunk < cap <= splits * chunk
    tiles = -(-cap // TILE)
    assert units * splits >= min(sms, units * min(tiles, tfa.MAX_SPLITS))


def test_split_plan_shapes():
    """GPT-2's headline (120 slots x 12 heads) keeps one split; Qwen2.5-1.5B's
    (16 x 2) and TinyLlama's (16 x 4) decode steps give every one of the
    H100's 132 SMs a block."""
    assert tfa.decode_split_plan(120 * 12, 256) == (1, 256)
    for units, want in ((16 * 2, (8, 32)), (16 * 4, (4, 64))):
        splits, chunk = tfa.decode_split_plan(units, 256)
        assert (splits, chunk) == want and units * splits >= 132


# --- the flat append -------------------------------------------------------------


def _append_inputs(seed, dt, B, H, Hkv, D, cap):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, 1, D)).astype(np.float32)
    kn = rng.standard_normal((B, Hkv, 1, D)).astype(np.float32)
    vn = rng.standard_normal((B, Hkv, 1, D)).astype(np.float32)
    if dt == "s8":
        kc = rng.integers(-127, 128, (B, cap, Hkv * D)).astype(np.int8)
        vc = rng.integers(-127, 128, (B, cap, Hkv * D)).astype(np.int8)
        sc = [rng.uniform(0.005, 0.02, (B, Hkv, cap, 1)).astype(np.float32) for _ in "kv"]
    else:
        kc, vc = (np.asarray(jnp.asarray(rng.standard_normal((B, cap, Hkv * D)), BF16))
                  for _ in "kv")
        sc = [None, None]
    return q, kn, vn, kc, vc, sc


def _torch(x):
    if x is None:
        return None
    if x.dtype == BF16:
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


def _emulate_append(q, kn, vn, kc, vc, sc, lens, window, sms):
    """The new row written as the kernel writes it (the port's plain
    version, bit-exact with the kernel on the card), then the split fold
    over the written caches."""
    B, H, _, D = q.shape
    Hkv, cap = kn.shape[1], kc.shape[1]
    args = [_torch(x) for x in (q, kc, vc, lens, *sc)]
    written = tfa.decode_mha_append_cat_plain(*args, k_new=_torch(kn), v_new=_torch(vn),
                                              window=window)
    kf = tfa.cat_to_heads(written[1], Hkv).float()
    vf = tfa.cat_to_heads(written[2], Hkv).float()
    ones = torch.ones(B, Hkv, cap)
    ksc, vsc = ((written[i].reshape(B, Hkv, cap) for i in (3, 4)) if sc[0] is not None
                else (ones, ones))
    splits, chunk = tfa.decode_split_plan(B * Hkv, cap, sms)
    out = split_attention(args[0], kf, vf, ksc, vsc, lens, scale=1.0 / np.sqrt(D),
                          window=window, splits=splits, chunk=chunk)
    return out, written[0].reshape(B, 1, H, D).permute(0, 2, 1, 3), splits


@pytest.mark.parametrize("dt,H,Hkv,window,sms", [
    ("s8", 12, 2, 0, 132),    # group 6 (Qwen2.5-1.5B's), 8 chunks of one tile
    ("bf16", 12, 2, 0, 132),
    ("s8", 16, 2, 24, 132),   # group 8, a window and a row with no column
    ("bf16", 4, 4, 0, 132),   # group 1 at few slots
    ("bf16", 16, 2, 0, 8),    # two chunks of four tiles, one a warp
    ("s8", 12, 2, 24, 2),     # one split, the warps taking two tiles each
])
def test_split_append_matches_jax(dt, H, Hkv, window, sms):
    """The model of the split append against decode_attention_append_cat(
    use_flash=False) and the port's plain version, within 1e-5 x max|out|
    on rows with a column; 0 on the others."""
    B, D, cap = 5, 64, 256
    splits, chunk = tfa.decode_split_plan(B * Hkv, cap, sms)
    lens = _lens(cap, chunk, window, B)
    q, kn, vn, kc, vc, sc = _append_inputs(H + window + sms, dt, B, H, Hkv, D, cap)
    got, plain, n = _emulate_append(q, kn, vn, kc, vc, sc, lens, window, sms)
    assert n == splits and (sms < 132 or splits > 1)
    jargs = [jnp.asarray(x) for x in (q, kc, vc, lens)] + [
        None if s is None else jnp.asarray(s) for s in sc]
    want = np.asarray(jfa.decode_attention_append_cat(
        *jargs, k_new=jnp.asarray(kn), v_new=jnp.asarray(vn), window=window,
        use_flash=False)[0]).reshape(B, 1, H, D).transpose(0, 2, 1, 3)
    live = _live(lens, cap, window)
    _close(got.numpy(), want, live)
    _close(got.numpy(), plain.numpy(), live)
    assert (got.numpy()[~live] == 0).all() and (~live).sum() == (1 if window else 0)


def test_split_append_matches_pallas_interpret():
    """Against the Pallas append kernel in interpret mode (cap 128, its
    dots in bf16): rtol 2e-2, atol 5e-3."""
    B, H, Hkv, D, cap = 3, 12, 2, 64, 128
    lens = np.array([0, 40, cap - 1], np.int32)
    q, kn, vn, kc, vc, sc = _append_inputs(3, "s8", B, H, Hkv, D, cap)
    q = np.asarray(jnp.asarray(q).astype(BF16).astype(jnp.float32))  # on the bf16 grid
    got, _, splits = _emulate_append(q, kn, vn, kc, vc, sc, lens, 0, 132)
    assert splits == 4
    want = np.asarray(jfa.decode_mha_append_cat(
        *map(jnp.asarray, (q, kc, vc, lens, *sc)), k_new=jnp.asarray(kn),
        v_new=jnp.asarray(vn), interpret=True)[0]).reshape(B, 1, H, D).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=5e-3)


# --- paged_decode_mha ---------------------------------------------------------------


def _paged_inputs(seed, dt, B, H, Hkv, D, BS, MB):
    rng = np.random.default_rng(seed)
    NB = 1 + B * MB
    q = np.asarray(jnp.asarray(rng.standard_normal((B, H, 1, D)).astype(np.float32))
                   .astype(BF16).astype(jnp.float32))
    if dt == "s8":
        pk, pv = (rng.integers(-127, 128, (NB, Hkv, BS, D)).astype(np.int8) for _ in "kv")
        sc = [rng.uniform(0.005, 0.02, (NB, Hkv, 1, BS)).astype(np.float32) for _ in "kv"]
    else:
        src = {"bf16": BF16, "f32": np.float32}[dt]
        pk, pv = (np.asarray(jnp.asarray(rng.standard_normal((NB, Hkv, BS, D)), src))
                  for _ in "kv")
        sc = []
    bt = (rng.permutation(np.arange(1, NB))[: B * MB].reshape(B, MB)).astype(np.int32)
    bt[-1] = 0  # an idle slot: every row of its table the garbage sink
    return q, pk, pv, bt, sc


def _emulate_paged(q, pk, pv, bt, sc, lens, window, sms):
    B, H, _, D = q.shape
    Hkv, BS = pk.shape[1], pk.shape[2]
    cap = bt.shape[1] * BS
    tbt = _torch(bt)
    kf = tfa.paged_gather_kv(_torch(pk), tbt).float()
    vf = tfa.paged_gather_kv(_torch(pv), tbt).float()
    if sc:
        ksc, vsc = (tfa.paged_gather_scales(_torch(s), tbt) for s in sc)
    else:
        ksc = vsc = torch.ones(B, Hkv, cap)
    splits, chunk = tfa.decode_split_plan(B * Hkv, cap, sms)
    out = split_attention(_torch(q), kf, vf, ksc, vsc, lens, scale=1.0 / np.sqrt(D),
                          window=window, splits=splits, chunk=chunk)
    return out, splits


@pytest.mark.parametrize("dt,window,sms", [("s8", 0, 132), ("bf16", 0, 132), ("s8", 40, 132),
                                           ("bf16", 40, 16)])
def test_split_paged_matches_jax(dt, window, sms):
    """The model of the split paged fold (TinyLlama's group of 8, blocks of
    64) against paged_attention(use_flash=False) and the port's plain
    version within 1e-5 x max|out| on rows with a column, 0 on the others."""
    B, H, Hkv, D, BS, MB = 5, 16, 2, 64, 64, 4
    cap = MB * BS
    q, pk, pv, bt, sc = _paged_inputs(7 + window, dt, B, H, Hkv, D, BS, MB)
    splits, chunk = tfa.decode_split_plan(B * Hkv, cap, sms)
    lens = _lens(cap, chunk, window, B)
    got, _ = _emulate_paged(q, pk, pv, bt, sc, lens, window, sms)
    assert splits > 1
    want = np.asarray(jfa.paged_attention(*map(jnp.asarray, (q, pk, pv, lens, bt, *sc)),
                                          window=window, use_flash=False))
    plain = tfa.paged_decode_mha(*(_torch(x) for x in (q, pk, pv, lens, bt, *sc)),
                                 window=window)
    live = _live(lens, cap, window)
    _close(got.numpy(), want, live)
    _close(got.numpy(), plain.numpy(), live)
    assert (got.numpy()[~live] == 0).all()


@pytest.mark.parametrize("dt", ["s8", "f32"])
def test_split_paged_matches_pallas_interpret(dt):
    """Against the interpreted Pallas paged_decode_mha (cap 128; q on the
    bf16 grid, p rounded to bf16 in its dots): rtol 2e-2, atol 5e-3."""
    B, H, Hkv, D, BS, MB = 4, 8, 2, 64, 32, 4
    q, pk, pv, bt, sc = _paged_inputs(11, dt, B, H, Hkv, D, BS, MB)
    bt[-1] = np.arange(1 + 3 * MB, 1 + 4 * MB)  # the kernel's DMA reads every slot's blocks
    lens = np.array([0, 31, 32, 127], np.int32)
    got, splits = _emulate_paged(q, pk, pv, bt, sc, lens, 0, 132)
    assert splits == 4
    want = np.asarray(jfa.paged_decode_mha(*map(jnp.asarray, (q, pk, pv, lens, bt, *sc)),
                                           interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=5e-3)
