"""The f32 arithmetic of ``mha`` on tensor cores (``rten_tpu_torch/csrc/mha.cu``,
mha_tc_kernel), modelled on the CPU.

Every f32 operand of both products is split into TF32 parts, big =
cvt.rna.tf32(x) (11 significant bits: the low 13 bits rounded off, ties
away from zero, emulated here on the bit patterns) and small = the same
rounding of x - big, and a product is big.big + big.small + small.big
with f32 sums (3xTF32). The model walks the keys in the kernel's tiles of
32 (each of KW warps taking its own 32 keys of a KW x 32-key tile and the
warps' states merged in order at the end), with the kernel's online
softmax in base 2 and its guards (p = 0 while the running max is at most
NEG_INF / 2; a row with no column comes out 0). It is held against the JAX
package's ``mha_pallas`` in interpret mode within 1e-5, over softcap, GQA,
a left-pad mask and causal attention with Tq != Tk, and fully masked rows
come out 0 in both. One TF32 pass, at the same shapes, lands past the
card tests' 1e-4, which is why the kernel takes three.
"""

import numpy as np
import pytest
import torch

from rten_tpu.kernels.flash_attention import mha_pallas

NEG_INF = -1e30
LOG2E = 1.4426950408889634
BK = 32  # keys a warp scores a tile, f32 (csrc/mha.cu, TcShape)


def tf32(x):
    """cvt.rna.tf32.f32 on finite f32 values: round the low 13 bits of the
    magnitude off, ties away from zero (on the bit pattern: sign apart, the
    magnitude's bits are a monotone integer)."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def parts(x):
    big = tf32(x)
    return big, tf32(x - big)


def mm3(a, b):
    """a @ b in 3xTF32 (f32 sums), the small terms first."""
    ab, asm = parts(a)
    bb, bsm = parts(b)
    return (asm @ bb + ab @ bsm) + ab @ bb


def mm1(a, b):
    """One TF32 pass."""
    return tf32(a) @ tf32(b)


def model(q, k, v, mask, *, causal, softcap, kw=1, mm=mm3):
    """The kernel's arithmetic on f32 tensors q [B,Hq,Tq,D], k/v
    [B,Hkv,Tk,D], an additive mask broadcasting to [Tq, Tk] or None."""
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    k = k.repeat_interleave(Hq // Hkv, dim=1)
    v = v.repeat_interleave(Hq // Hkv, dim=1)
    scale = 1.0 / float(np.sqrt(D))
    offset = Tk - Tq
    rows = torch.arange(Tq)[:, None]
    full = None if mask is None else mask.expand(Tq, Tk)
    # One state a warp: (m, l, o).
    st = [[torch.full((B, Hq, Tq, 1), NEG_INF), torch.zeros(B, Hq, Tq, 1),
           torch.zeros(B, Hq, Tq, D)] for _ in range(kw)]
    for t0 in range(0, Tk, kw * BK):
        for w in range(kw):
            k0 = t0 + w * BK
            if k0 >= Tk:
                continue
            k1 = min(Tk, k0 + BK)
            s = mm(q, k[:, :, k0:k1].transpose(-1, -2)) * scale
            if softcap:
                s = softcap * torch.tanh(s / softcap)
            if full is not None:
                s = s + full[:, k0:k1]
            cols = torch.arange(k0, k1)[None, :]
            ok = (cols <= rows + offset) if causal else torch.ones_like(cols, dtype=torch.bool)
            s = torch.where(ok, s, torch.tensor(NEG_INF))
            m, l, o = st[w]
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            empty = m_new <= NEG_INF / 2
            alpha = torch.where(m <= NEG_INF / 2, torch.tensor(0.0),
                                torch.exp2((m - m_new) * LOG2E))
            p = torch.where(empty, torch.tensor(0.0), torch.exp2(s * LOG2E - m_new * LOG2E))
            st[w] = [m_new, l * alpha + p.sum(-1, keepdim=True),
                     o * alpha + mm(p, v[:, :, k0:k1])]
    m, l, o = st[0]
    for mw, lw, ow in st[1:]:  # the warps' states merged in warp order
        mn = torch.maximum(m, mw)
        sa = torch.where(m <= NEG_INF / 2, torch.tensor(0.0), torch.exp2((m - mn) * LOG2E))
        sb = torch.where(mw <= NEG_INF / 2, torch.tensor(0.0), torch.exp2((mw - mn) * LOG2E))
        m, l, o = mn, l * sa + lw * sb, o * sa + ow * sb
    return o / torch.where(l == 0, torch.tensor(1.0), l)


CASES = [  # B, Hq, Hkv, Tq, Tk, D, causal, softcap, mask
    (1, 4, 4, 40, 40, 64, True, 0.0, "left_pad"),   # a Generator prefill's shape, 5 pad columns
    (1, 4, 2, 24, 56, 32, True, 30.0, None),        # GQA, softcap, causal Tq != Tk
    (2, 4, 1, 16, 48, 64, False, 50.0, "full"),     # group 4, a [Tq, Tk] mask
    (1, 2, 2, 33, 70, 32, True, 0.0, "row"),        # ragged tiles, a [1, Tk] mask
]


def _inputs(B, Hq, Hkv, Tq, Tk, D, mask, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, Tq, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, Tk, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Tk, D)).astype(np.float32)
    m = {None: None,
         "left_pad": np.where(np.arange(Tk) < 5, -1e30, 0.0)[None],
         "row": np.where(np.arange(Tk) < 3, -1e30, 0.0)[None],
         "full": np.where(rng.random((Tq, Tk)) > 0.2, 0.0, -1e30)}[mask]
    return q, k, v, None if m is None else m.astype(np.float32)


def _live(Tq, Tk, causal, m):
    ok = np.ones((Tq, Tk), bool)
    if causal:
        ok &= np.arange(Tk)[None] <= np.arange(Tq)[:, None] + Tk - Tq
    if m is not None:
        ok &= np.broadcast_to(m, (Tq, Tk)) > -1e29
    return ok.any(-1)


@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D,causal,softcap,mask", CASES)
def test_3xtf32_model_matches_mha_pallas(B, Hq, Hkv, Tq, Tk, D, causal, softcap, mask):
    """The model (the rows on one warp, or each key tile split over two and
    over four warps) within 1e-5 of mha_pallas(interpret=True) on every row
    with a column to attend; the rows with none are 0 in both."""
    q, k, v, m = _inputs(B, Hq, Hkv, Tq, Tk, D, mask, Tq * Tk + D)
    kwargs = dict(causal=causal, softcap=softcap)
    want = np.asarray(mha_pallas(q, k, v, m, interpret=True, **kwargs))
    live = _live(Tq, Tk, causal, m)
    assert (want[:, :, ~live] == 0).all()
    for kw in (1, 2, 4):
        got = model(*(torch.from_numpy(x) for x in (q, k, v)),
                    None if m is None else torch.from_numpy(m), kw=kw, **kwargs).numpy()
        assert np.abs(got[:, :, live] - want[:, :, live]).max() <= 1e-5, kw
        assert (got[:, :, ~live] == 0).all()


def test_tf32_parts():
    """big keeps 11 significant bits, x - big is exact in f32, and big +
    small carries x to about 22 bits."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    big, small = parts(x)
    assert ((big.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((small.view(torch.int32) & 0x1FFF) == 0).all()
    assert torch.equal((x.double() - big.double()).float(), x - big)  # exact
    rel = ((big.double() + small.double() - x.double()).abs() / x.double().abs()).max()
    assert rel <= 2.0**-21
    assert ((big.double() - x.double()).abs() / x.double().abs()).max() > 2.0**-13


def test_one_tf32_pass_is_not_enough():
    """At a Generator prefill's shape (D 64) one TF32 pass for both products
    lands past the 1e-4 the card tests hold the kernel to; 3xTF32 stays
    within 1e-5."""
    q, k, v, m = _inputs(1, 4, 4, 40, 40, 64, "left_pad", 3)
    want = np.asarray(mha_pallas(q, k, v, m, causal=True, interpret=True))
    args = [torch.from_numpy(x) for x in (q, k, v, m)]
    live = _live(40, 40, True, m)
    one = model(*args, causal=True, softcap=0.0, mm=mm1).numpy()
    three = model(*args, causal=True, softcap=0.0).numpy()
    assert np.abs(one[:, :, live] - want[:, :, live]).max() > 1e-4
    assert np.abs(three[:, :, live] - want[:, :, live]).max() <= 1e-5
