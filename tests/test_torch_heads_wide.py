"""The arithmetic of ``decode_mha``'s per-head form at head dims 129-512
(``rten_tpu_torch/csrc/decode_heads_wide.cuh``), modelled on the CPU in
PyTorch and held against the JAX package, and the routing and shared-memory
plan that the wrapper mirrors.

The model repeats the kernel's order and rounding points, from the plan
the wrapper keeps (``heads_plan``: query rows a block, keys a tile, head
dims split into 128-dim slices, one warp each): per (slot, head, block of
rows), the keys in the plan's tiles from the first column a window lets the
block's rows attend; each slice's partial score over its own dims, in three
bf16 parts of q against K's exact bf16 values (s8 codes, int4 codes, bf16
values) or in 3xTF32 (f32 caches: every operand split as big =
cvt.rna.tf32(x), small = the same rounding of x - big), each part summed
apart and then (lo + mid) + hi, and the slices' partials summed in slice
order; the K scale on the score, the V scale on p; an online softmax in
base 2 (the scale times log2(e)); p * vs into the value product in three
bf16 parts (3xTF32 for f32), slice by slice of the output dims; a row with
no column gives 0. It is held within 1e-5 of max|out| against the JAX
package's ``decode_mha_xla`` and the port's ``decode_mha_plain`` (f32
throughout) at D 160 (a masked tail), 256 and 512, on seeded numpy inputs
with GQA, a window and a slot whose rows have no column, and against the
interpreted Pallas per-head grid at one case (f32 caches, cap 128, S past
the fold's 8 rows).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rten_tpu.kernels import flash_attention as jfa
from rten_tpu_torch.kernels import flash_attention as tfa

B, H, HKV, S, CAP = 2, 4, 2, 40, 96
LIMIT = 1e-5  # of max|out|
LOG2E = np.float32(np.log2(np.e))
KINDS = ("s8", "int4", "bf16", "f32")
DTYPES = {"s8": torch.int8, "int4": torch.uint8, "bf16": torch.bfloat16, "f32": torch.float32}


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _parts3(x):
    """x as three bf16 parts (hi, then the rounding of each remainder)."""
    parts = []
    for _ in range(3):
        parts.append(_bf16(x))
        x = x - parts[-1]
    return parts


def _tf32(x):
    """cvt.rna.tf32.f32 on finite f32 values: the low 13 bits of the
    magnitude rounded off, ties away from zero."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm3(a, b):
    """a @ b in 3xTF32 (f32 sums), each term apart, the small ones first."""
    ab, bb = _tf32(a), _tf32(b)
    asm, bsm = _tf32(a - ab), _tf32(b - bb)
    return (asm @ bb + ab @ bsm) + ab @ bb


def _mm_parts(a, b):
    """a @ b with a in three bf16 parts and b exact in bf16 (f32 sums),
    each part apart: (lo + mid) + hi."""
    hi, mid, lo = (p @ b for p in _parts3(a))
    return (lo + mid) + hi


def wide_attention(q, k, v, lens, ks=None, vs=None, *, scale, window=0):
    """The wide per-head form's function and rounding points: q [B,H,S,D]
    f32, caches [B,Hkv,cap,D] (int4: u8 [.., D/2]) with scales [B,Hkv,cap]
    for s8 and int4."""
    plan = tfa.heads_plan(k.dtype, q.shape[3])
    assert plan.kernel == "wide"
    f32 = k.dtype == torch.float32
    Bq, Hq, Sq, D = q.shape
    cap = k.shape[2]
    if k.dtype == torch.uint8:
        kf, vf = tfa.unpack_int4(k), tfa.unpack_int4(v)  # codes (nibble - 8)
    else:
        kf, vf = k.to(torch.float32), v.to(torch.float32)
    if not f32:
        assert torch.equal(_bf16(kf), kf) and torch.equal(_bf16(vf), vf)  # exact in bf16
    group = Hq // k.shape[1]
    kf, vf = kf.repeat_interleave(group, 1), vf.repeat_interleave(group, 1)
    ks = torch.ones(kf.shape[:3]) if ks is None else ks.repeat_interleave(group, 1)
    vs = torch.ones(kf.shape[:3]) if vs is None else vs.repeat_interleave(group, 1)
    mm = _mm3 if f32 else _mm_parts
    scale2 = np.float32(scale) * LOG2E
    out = torch.zeros(Bq, Hq, Sq, D)
    for b in range(Bq):
        n = int(lens[b])
        for r0 in range(0, Sq, plan.rows):
            rows = torch.arange(r0, min(r0 + plan.rows, Sq))
            pos = n + rows
            kmax = min(n + int(rows[-1]), cap - 1)
            kmin = max(0, n + r0 - window + 1) if window else 0
            m = torch.full((Hq, len(rows)), -torch.inf)
            l = torch.zeros(Hq, len(rows))
            acc = torch.zeros(Hq, len(rows), D)
            for k0 in range(kmin // plan.keys * plan.keys, kmax + 1, plan.keys):
                j = torch.arange(k0, min(k0 + plan.keys, kmax + 1))
                # Each slice's partial score over its dims, summed in slice order.
                s = 0.0
                for d0 in range(0, plan.dp, 128):
                    sl = slice(d0, min(d0 + 128, D))
                    if d0 < D:
                        s = s + mm(q[b, :, rows, sl], kf[b, :, j, sl].transpose(1, 2))
                s = s * scale2 * ks[b, :, None, j]
                ok = j[None] <= pos[:, None]
                if window:
                    ok &= j[None] > pos[:, None] - window
                s = torch.where(ok, s, -torch.inf)
                m_new = torch.maximum(m, s.amax(2))
                mu = torch.where(m_new == -torch.inf, 0.0, m_new)
                alpha = torch.exp2(m - mu)
                p = torch.exp2(s - mu[..., None])
                l = l * alpha + p.sum(2)
                w = p * vs[b, :, None, j]
                for d0 in range(0, D, 128):  # the warps' output slices
                    sl = slice(d0, min(d0 + 128, D))
                    acc[..., sl] = acc[..., sl] * alpha[..., None] + mm(w, vf[b, :, j, sl])
                m = m_new
            out[b, :, rows] = torch.where(l[..., None] > 0,
                                          acc / torch.where(l > 0, l, 1.0)[..., None], 0.0)
    return out


def _inputs(kind, D, seed, b=B, h=H, hkv=HKV, s=S, cap=CAP):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, s, D)).astype(np.float32)
    ks = vs = None
    if kind == "s8":
        k, v = (rng.integers(-127, 128, (b, hkv, cap, D)).astype(np.int8) for _ in "kv")
        ks, vs = ((rng.random((b, hkv, cap)) * 0.015 + 0.005).astype(np.float32) for _ in "kv")
    elif kind == "int4":
        k, v = (rng.integers(0, 256, (b, hkv, cap, D // 2)).astype(np.uint8) for _ in "kv")
        ks, vs = ((rng.random((b, hkv, cap)) * 0.3 + 0.05).astype(np.float32) for _ in "kv")
    else:
        k, v = (rng.standard_normal((b, hkv, cap, D)).astype(np.float32) for _ in "kv")
    return q, k, v, ks, vs


def _torch(a, kind=None):
    if a is None:
        return None
    t = torch.from_numpy(a)
    return t.to(torch.bfloat16) if kind == "bf16" else t


def _jax(a, kind=None):
    if a is None:
        return None
    return jnp.asarray(a, jnp.bfloat16 if kind == "bf16" else None)


# D 160: a masked tail in the DP 256 instance (its second slice holds 32
# dims); D 512: four slices, 32 rows a block, 16-key tiles.
CASES = [(kind, D, window) for kind in KINDS for D, window in ((160, 16), (256, 0), (512, 24))]


@pytest.mark.parametrize("kind,D,window", CASES)
def test_wide_model_matches_f32_references(kind, D, window):
    q, k, v, ks, vs = _inputs(kind, D, D + window + len(kind))
    # Slot 0 mid-cache (its last rows past cap attend every column); slot 1
    # at cap - S, or with a window past the cache's end, where no row has a
    # column.
    lens = np.array([30, CAP + window + 3 if window else CAP - S], np.int32)
    scale = 1.0 / np.sqrt(D)
    tq, tk, tv, tl, tks, tvs = (_torch(a, kind if a is k or a is v else None)
                                for a in (q, k, v, lens, ks, vs))
    got = wide_attention(tq, tk, tv, tl, tks, tvs, scale=scale, window=window).numpy()
    plain = tfa.decode_mha_plain(tq, tk, tv, tl, tks, tvs, scale=scale, window=window).numpy()
    xla = np.asarray(jfa.decode_mha_xla(_jax(q), _jax(k, kind), _jax(v, kind), _jax(lens),
                                        _jax(ks), _jax(vs), scale=scale, window=window))
    qpos = lens.astype(np.int64)[:, None] + np.arange(S)[None]
    live = (qpos - window < CAP - 1) if window else np.ones_like(qpos, bool)
    live = np.broadcast_to(live[:, None, :, None], got.shape)
    limit = LIMIT * np.abs(plain[live]).max()
    for want in (plain, xla):
        assert np.abs(got - want)[live].max() <= limit
    if window:  # slot 1: no column for any row -> 0 (the references give the mean of V)
        assert not live[1].any() and not got[1].any()


def test_wide_model_matches_pallas_interpret():
    """Against the interpreted Pallas per-head grid (S 24, past the fold's 8
    rows) on f32 caches at D 256, cap 128: the same 1e-5 of max|out| (the
    reference scores f32 caches in f32; on s8, int4 and bf16 caches it
    rounds q and p to bf16 once, 2e-3 away, the reason the kernels take
    three parts)."""
    D, cap = 256, 128
    q, k, v, _, _ = _inputs("f32", D, 3, b=2, h=4, hkv=2, s=24, cap=cap)
    lens = np.array([10, 90], np.int32)
    scale = 1.0 / np.sqrt(D)
    got = wide_attention(*(torch.from_numpy(a) for a in (q, k, v, lens)), scale=scale)
    want = np.asarray(jfa.decode_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(lens), scale=scale, interpret=True))
    assert np.abs(got.numpy() - want).max() <= LIMIT * np.abs(want).max()


@pytest.mark.parametrize("kind", KINDS)
def test_heads_form_routes_every_head_dim(kind):
    """Every even head dim up to 512 runs on tensor cores: decode_heads_tc.cuh
    (bf16 parts) or decode_heads_tf32.cuh (f32) to 128, decode_heads_wide.cuh
    past it, 64 rows a block at DP 256 (two 128-dim slices) and 32 at DP 512
    (four); odd or larger head dims are refused."""
    dt = DTYPES[kind]
    for D in (2, 64, 80, 128, 130, 160, 256, 300, 512):
        plan = tfa.heads_plan(dt, D)
        assert tfa.heads_form(dt, D) == "tensor_core"
        assert plan.kernel == ("wide" if D > 128 else "tf32" if kind == "f32" else "tc")
        assert plan.dp >= D and (plan.dp == 64 or plan.dp // 2 < D)
        if plan.kernel == "wide":
            assert (plan.rows, plan.slices, plan.threads) == (
                (64, 2, 256) if D <= 256 else (32, 4, 256))
            assert plan.keys == (16 if D > 256 else 32)
            assert plan.threads // 32 == plan.rows // 16 * plan.slices
    for D in (0, 3, 514):
        with pytest.raises(ValueError):
            tfa.heads_form(dt, D)


def test_every_instance_fits_a_blocks_shared_memory():
    """Every per-head instance (kind x DP), as the wrapper's plan mirrors the
    kernels' constants, stays within the 227 KB a block may use; the wide
    instances take one block an SM (over half of it)."""
    for kind in KINDS:
        for dp in (64, 128, 256, 512):
            plan = tfa.heads_plan(DTYPES[kind], dp)
            assert 0 < plan.smem <= tfa.MAX_SMEM == 232448, (kind, dp, plan)
            if plan.kernel == "wide":
                assert plan.smem > tfa.MAX_SMEM // 2
