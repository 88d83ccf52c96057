"""The arithmetic of ``bd_decode``/``nt_decode``'s split kernel
(``rten_tpu_torch/csrc/bench_decode_attn.cu``, ``fold_split_kernel``),
modelled in PyTorch in this file and held against the JAX tool
(``tools/bench_decode_attn.py``, its Pallas kernels run with
``interpret=True``) and against the port's plain versions; and the split
plan the wrapper gives it (``fold_plan``).

The model follows the kernel step by step: the plan's chunks of the kept
keys, each chunk's 16-key tiles dealt to the block's warps in turn, q in
one bf16 part or three (hi, mid, lo) where the kernel feeds the tensor
cores, each warp's online softmax over its tiles with p rounded to bf16
against the warp's running max (for bf16 V), the warps' states merged in
warp order and the splits' states merged online in split order. Its sums
run in another order than the card's (f32 rounding only).

Tolerances: against the JAX tool the bf16 rule (rtol 2e-2, atol 5e-3, the
reference's own for interpreted bf16 dots: a p rounding to bf16 on the
other side of a boundary moves one term by 2^-8); f32 K/V and q against
the plain version within 1e-5 of max|out| (f32 sums in another order).
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from rten_tpu_torch.kernels.flash_attention import SMS
from rten_tpu_torch.tools import bench_decode_attn as tb

TOOL = pathlib.Path(__file__).resolve().parents[1] / "tools" / "bench_decode_attn.py"
NEG_INF = tb.NEG_INF


@pytest.fixture(scope="module")
def jt():
    """The JAX tool, loaded from its file (tools/ is no package) with its
    compilation cache left off."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RTEN_JAX_CACHE", "0")
        spec = importlib.util.spec_from_file_location("jax_bench_decode_attn", TOOL)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    return mod


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def split_model(form, q, k, v, lens, scale, block_k=256):
    """The kernel's arithmetic: q [B, H, 1, D] (f32 or bf16), k natural
    [B, Hkv, cap, D] whatever the form (bd's kt is its transpose), v, lens
    -> [B, H, 1, D] in q's dtype."""
    B, H, _, D = q.shape
    Hkv, cap = k.shape[1], k.shape[2]
    group = H // Hkv
    bf16 = v.dtype == torch.bfloat16
    plan = tb.fold_plan(B, H, Hkv, cap, D, v.dtype, block_k, SMS)
    qf = q[:, :, 0].reshape(B, Hkv, group, D).float()
    kf, vf = k.float(), v.float()
    if bf16 and form == "bd" and q.dtype == torch.float32:
        parts = []  # three bf16 parts: the f32 score of the widened K
        rest = qf
        for _ in range(3):
            parts.append(_bf16(rest))
            rest = rest - parts[-1]
    else:
        parts = [_bf16(qf) if bf16 else qf]  # nt and a bf16 q: one part
    if not bf16 and form == "bd" and q.dtype == torch.bfloat16:
        kf = _bf16(kf)  # bd casts f32 kt to q's bf16
    kend = torch.where(lens < 0, 0, torch.clamp(lens.long() + 1, max=plan.kept))
    shape = (B, Hkv, group, 1)
    M, L, O = None, None, None
    for z in range(plan.splits):
        c0 = z * plan.chunk
        c1 = torch.clamp(kend, min=c0, max=min(c0 + plan.chunk, plan.kept))  # per slot
        ntile = -(-min(plan.chunk, plan.kept - c0) // tb.FOLD_TILE)
        states = []
        for w in range(plan.warps):
            m = torch.full(shape, NEG_INF)
            l = torch.zeros(shape)
            acc = torch.zeros((B, Hkv, group, D))
            for t in range(w, ntile, plan.warps):
                key0 = c0 + t * tb.FOLD_TILE
                keys = key0 + torch.arange(tb.FOLD_TILE)
                live = keys[None, :] < c1[:, None]  # [B, 16]
                kk = torch.zeros(B, Hkv, tb.FOLD_TILE, D)
                vv = torch.zeros(B, Hkv, tb.FOLD_TILE, D)
                n = min(tb.FOLD_TILE, plan.kept - key0)
                kk[:, :, :n], vv[:, :, :n] = kf[:, :, key0:key0 + n], vf[:, :, key0:key0 + n]
                s = sum(p @ kk.transpose(2, 3) for p in parts) * scale
                s = torch.where(live[:, None, None, :], s, NEG_INF)
                m_new = torch.maximum(m, s.amax(3, keepdim=True))
                alpha = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(m - m_new))
                p = torch.where(m_new <= NEG_INF / 2, 0.0, torch.exp(s - m_new))
                l = l * alpha + p.sum(3, keepdim=True)
                acc = acc * alpha + (_bf16(p) if bf16 else p) @ vv
                m = m_new
            states.append((m, l, acc))
        mw = torch.stack([s[0] for s in states])
        Mz = mw.amax(0)
        c = torch.where(mw <= NEG_INF / 2, 0.0, torch.exp(mw - Mz))
        Lz = sum(c[i] * states[i][1] for i in range(plan.warps))
        Oz = sum(c[i] * states[i][2] for i in range(plan.warps))
        if M is None:
            M, L, O = Mz, Lz, Oz
            continue
        mn = torch.maximum(M, Mz)
        a = torch.where(M <= NEG_INF / 2, 0.0, torch.exp(M - mn))
        cz = torch.where(Mz <= NEG_INF / 2, 0.0, torch.exp(Mz - mn))
        L, O, M = L * a + Lz * cz, O * a + Oz * cz, mn
    out = O / torch.where(L == 0.0, 1.0, L)
    return out.reshape(B, H, 1, D).to(q.dtype)


# (B, H, Hkv, cap, D, block_k): the tool's shape cut to 4 slots, TinyLlama's
# attention (group 8) cut to 4 slots, group 10 at D 80 with a dropped tail.
SHAPES = {
    "tool": (4, 12, 12, 256, 64, 256),
    "tinyllama": (4, 32, 4, 256, 64, 256),
    "group10_d80": (4, 20, 2, 200, 80, 64),
}


def _inputs(name):
    B, H, Hkv, cap, D, bk = SHAPES[name]
    rng = np.random.default_rng(B * H + cap + D)
    q = rng.standard_normal((B, H, 1, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, cap, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, cap, D)).astype(np.float32)
    lens = np.asarray([-1, 0, cap + 5, cap // 2 + 7], np.int32)
    return q, k, v, lens, 1.0 / np.sqrt(D), bk


@pytest.mark.parametrize("form", ["bd", "nt"])
@pytest.mark.parametrize("name,qdt", [(n, "f32") for n in SHAPES] + [("tool", "bf16")])
def test_model_matches_jax_bf16(jt, name, qdt, form):
    """bf16 K/V (an f32 q at every shape, a bf16 q at the tool's): the
    model against the interpreted Pallas kernel at the bf16 rule; lens -1
    gives 0."""
    import jax.numpy as jnp

    q, k, v, lens, scale, bk = _inputs(name)
    jq = jnp.asarray(q, jnp.float32 if qdt == "f32" else jnp.bfloat16)
    jv = jnp.asarray(v, jnp.bfloat16)
    if form == "bd":
        want = jt.bd_decode(jq, jnp.asarray(np.swapaxes(k, 2, 3), jnp.bfloat16), jv, lens,
                            scale=scale, block_k=bk, interpret=True)
    else:
        want = jt.nt_decode(jq, jnp.asarray(k, jnp.bfloat16), jv, lens, scale=scale,
                            block_k=bk, interpret=True)
    tq = torch.from_numpy(q).to(torch.float32 if qdt == "f32" else torch.bfloat16)
    got = split_model(form, tq, torch.from_numpy(k).bfloat16(), torch.from_numpy(v).bfloat16(),
                      torch.from_numpy(lens), scale, bk)
    assert got.dtype == tq.dtype and got.shape == tuple(want.shape)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2e-2, atol=5e-3)
    assert not got[0].any()


@pytest.mark.parametrize("form", ["bd", "nt"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_model_matches_plain_f32(name, form):
    """f32 q and K/V: the model against the port's plain version within
    1e-5 of max|out|."""
    q, k, v, lens, scale, bk = _inputs(name)
    tq, tk, tv, tl = (torch.from_numpy(a) for a in (q, k, v, lens))
    got = split_model(form, tq, tk, tv, tl, scale, bk)
    plain = (tb.bd_decode_plain(tq, tk.transpose(2, 3).contiguous(), tv, tl, scale=scale,
                                block_k=bk) if form == "bd"
             else tb.nt_decode_plain(tq, tk, tv, tl, scale=scale, block_k=bk))
    assert (got - plain).abs().max().item() <= 1e-5 * plain.abs().max().item()
    assert not got[0].any()


@pytest.mark.parametrize("B,H,Hkv,cap,D,bk", [
    (32, 12, 12, 256, 64, 256),   # the tool's shape
    (16, 32, 4, 256, 64, 256),    # TinyLlama's attention
    (128, 12, 12, 256, 64, 256),  # slots 128
    (16, 12, 2, 256, 128, 256),   # Qwen2.5-1.5B's attention
    (3, 20, 2, 200, 80, 64),      # group 10, D 80: 8 keys dropped
    (4, 8, 2, 8192, 32, 8192),    # one key block of 8192
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_covers_the_kept_keys_once(B, H, Hkv, cap, D, bk, dtype):
    plan = tb.fold_plan(B, H, Hkv, cap, D, dtype, bk, SMS)
    assert plan.kept == (cap // min(bk, cap)) * min(bk, cap)
    assert plan.chunk % 32 == 0 and plan.splits * plan.chunk >= plan.kept
    assert (plan.splits - 1) * plan.chunk < plan.kept  # no empty split
    covered = np.zeros(plan.kept, int)
    for z in range(plan.splits):
        covered[z * plan.chunk:min((z + 1) * plan.chunk, plan.kept)] += 1
    assert (covered == 1).all()
    assert plan.rows * plan.row_tiles >= H // Hkv > plan.rows * (plan.row_tiles - 1)


def test_plan_fills_the_card_at_tinyllama():
    """TinyLlama's attention (16 slots x 4 kv heads, one row tile) splits
    its keys so that at least one block lands on every SM; the tool's
    shape and slots 128 fill it with one split."""
    for dtype in (torch.float32, torch.bfloat16):
        plan = tb.fold_plan(16, 32, 4, 256, 64, dtype, 256, SMS)
        assert plan.splits > 1 and 16 * 4 * plan.row_tiles * plan.splits >= SMS, plan
        assert tb.fold_plan(32, 12, 12, 256, 64, dtype, 256, SMS).splits == 1
        assert tb.fold_plan(128, 12, 12, 256, 64, dtype, 256, SMS).splits == 1
    assert tb.fold_plan(3, 20, 2, 200, 80, torch.bfloat16, 64, SMS).rows == 16  # two n-tiles
    assert tb.fold_plan(3, 20, 2, 200, 80, torch.float32, 64, SMS).rows == 8
