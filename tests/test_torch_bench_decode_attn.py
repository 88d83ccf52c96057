"""The port's decode-attention microbenchmark
(``rten_tpu_torch/tools/bench_decode_attn.py``) against the JAX tool
(``tools/bench_decode_attn.py``): each plain version against the tool's
Pallas kernel on the same numpy inputs, the Pallas kernels run on the CPU
(``interpret=True`` for bd/nt, ``pltpu.force_tpu_interpret_mode()`` for the
floor and the VPU kernel), and the port's ``main`` at a tiny CPU size.

Tolerances: f32 attention atol 1e-5 (sums in another order); the floor
rtol 1e-5, atol 1e-4 (up to 2 * Hkv * cap terms summed in another order);
bf16 modes rtol 2e-2, atol 5e-3 (the reference's own rule for interpreted
bf16 dots, tests/test_kernel_append.py: a p rounding to bf16 on the other
side of a boundary moves one term by 2^-8).
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rten_tpu_torch.tools import bench_decode_attn as tb
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

TOOL = pathlib.Path(__file__).resolve().parents[1] / "tools" / "bench_decode_attn.py"


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


def _inputs(seed, B, H, Hkv, cap, D, lens):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, 1, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, cap, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, cap, D)).astype(np.float32)
    return q, k, v, np.asarray(lens, np.int32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("cap", [128, 256])
def test_dma_floor_matches_jax(jt, cap):
    q, k, v, lens = _inputs(cap, 3, 2, 2, cap, 64, [5, 0, cap - 1])
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jt.dma_floor(q, k, v, lens))
    tq, tk, tv, tl = _t(q, k, v, lens)
    got = tb.dma_floor_plain(tq, tk, tv, tl)
    assert got.shape == (3, 1, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    assert torch.equal(tb.dma_floor(tq, tk, tv, tl), got)


@pytest.mark.parametrize("D", [32, 64])
def test_vpu_attn_matches_jax(jt, D):
    cap = 256
    q, k, v, lens = _inputs(D, 4, 2, 2, cap, D, [-1, 0, 100, cap + 5])
    scale = 1.0 / np.sqrt(D)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jt.vpu_attn(q, k, v, lens, scale))
    tq, tk, tv, tl = _t(q, k, v, lens)
    got = tb.vpu_attn_plain(tq, tk, tv, tl, scale)
    assert got.shape == (4, 2, 1, D)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # lens -1: every column masked with no guard -> the mean of V.
    np.testing.assert_allclose(got[0, :, 0].numpy(), v[0].mean(1), rtol=0, atol=1e-6)
    assert torch.equal(tb.vpu_attn(tq, tk, tv, tl, scale), got)


def vpu_one_pass(q, k, v, lens, scale, sms=132):
    """The one-pass ``vpu_attn`` kernel's order (csrc/bench_decode_attn.cu,
    vpu_attn_kernel), in f32: per (slot, head), the live columns (all cap of
    them, every score the mask's -1e30, when lens < 0) cut by ``vpu_plan``
    into splits; a split's keys in batches of 4 warps x 4 lane groups x U =
    8 / NV keys (NV: the 16-byte pieces of a row a lane holds), each lane
    group keeping an online softmax with one rescale a batch; the groups
    merged pairwise (g ^ 1, then ^ 2), the warps in warp order, the splits
    in split order."""
    Bq, Hq, cap, D = k.shape
    nv = 1 if D <= 32 else 2 if D <= 64 else 4 if D <= 128 else 8
    u_keys, warps, groups = 8 // nv, 4, 4
    batch = groups * u_keys
    splits, chunk = tb.vpu_plan(Bq, Hq, cap, sms)
    f = torch.float32
    ninf = torch.tensor(-torch.inf)

    def merge(a, b):
        m = torch.maximum(a[0], b[0])
        mu = torch.where(m == -torch.inf, 0.0, m)
        fa, fb = torch.exp(a[0] - mu), torch.exp(b[0] - mu)
        return m, a[1] * fa + b[1] * fb, a[2] * fa + b[2] * fb

    out = torch.zeros(Bq, Hq, 1, D)
    for b in range(Bq):
        n = int(lens[b])
        jend = cap if n < 0 else min(n, cap - 1) + 1
        for h in range(Hq):
            states = []
            for z in range(splits):
                j0, j1 = z * chunk, min(z * chunk + chunk, jend)
                ws = []
                for w in range(warps):
                    gs = [(ninf, torch.tensor(0.0), torch.zeros(D)) for _ in range(groups)]
                    for base in range(j0 + w * batch, j1, warps * batch):
                        for g in range(groups):
                            m, l, acc = gs[g]
                            js = [base + u * groups + g for u in range(u_keys)]
                            s = torch.stack([
                                (torch.tensor(-1e30, dtype=f) if n < 0
                                 else (q[b, h, 0] * k[b, h, j]).sum() * np.float32(scale))
                                if j < j1 else ninf for j in js])
                            m_new = torch.maximum(m, s.max())
                            mu = torch.where(m_new == -torch.inf, 0.0, m_new)
                            alpha = torch.exp(m - mu)
                            l, acc = l * alpha, acc * alpha
                            for j, sj in zip(js, s):
                                p = torch.exp(sj - mu)
                                l = l + p
                                if j < j1:
                                    acc = acc + p * v[b, h, j]
                            gs[g] = (m_new, l, acc)
                    ws.append(merge(merge(gs[0], gs[1]), merge(gs[2], gs[3])))
                m = torch.stack([x[0] for x in ws]).max()
                mu = torch.where(m == -torch.inf, 0.0, m)
                c = [torch.exp(x[0] - mu) for x in ws]
                states.append((m, sum(ci * x[1] for ci, x in zip(c, ws)),
                               sum(ci * x[2] for ci, x in zip(c, ws))))
            st = states[0]
            for x in states[1:]:
                st = merge(st, x)
            out[b, h, 0] = st[2] / st[1]
    return out


@pytest.mark.parametrize("D", [32, 64, 128])
def test_vpu_one_pass_model_matches_jax(jt, D):
    """The kernel's one-pass order against the interpreted JAX kernel, lens
    -1 (the mean of V), 0, mid and cap + 5, atol 1e-5; 2 slots x 2 heads on
    132 SMs split each head's columns (8 splits of 32 keys at cap 256), and
    the tool's 384 (slot, head) pairs take one split."""
    cap = 256
    q, k, v, lens = _inputs(D + 1, 4, 2, 2, cap, D, [-1, 0, 100, cap + 5])
    scale = 1.0 / np.sqrt(D)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jt.vpu_attn(q, k, v, lens, scale))
    assert tb.vpu_plan(4, 2, cap) == (8, 32) and tb.vpu_plan(32, 12, cap)[0] == 1
    got = vpu_one_pass(*_t(q, k, v, lens), scale)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[0, :, 0].numpy(), v[0].mean(1), rtol=0, atol=1e-6)


def test_vpu_attn_head_dims():
    """The kernel takes D a multiple of 4 up to 256 (any cap: no score buffer
    a cap long); the wrapper refuses the rest on every device."""
    for D in (6, 260):
        with pytest.raises(ValueError, match="head dim"):
            tb.vpu_attn(*_t(*_inputs(0, 1, 1, 1, 8, D, [3])), 1.0)
    q, k, v, lens = _inputs(1, 1, 1, 1, 20000, 4, [19999])
    assert tb.vpu_attn(*_t(q, k, v, lens), 0.5).shape == (1, 1, 1, 4)


FOLD_CASES = [(H, Hkv, cap, bk, dt)
              for H, Hkv in ((2, 2), (8, 2))
              for cap, bk in ((256, 128), (256, 256), (384, 128), (384, 256))
              for dt in ("f32", "bf16")]


@pytest.mark.parametrize("H,Hkv,cap,bk,dt", FOLD_CASES)
def test_bd_nt_decode_match_jax(jt, H, Hkv, cap, bk, dt):
    """bd gets kt = K^T of the K that nt gets; both plain versions against
    the interpreted kernels, lens -1 (0 out), 0, a middle value and cap - 1;
    at cap 384 with key blocks of 256 the last 128 keys are dropped."""
    import jax.numpy as jnp

    D = 64
    q, k, v, lens = _inputs(H * cap + bk, 4, H, Hkv, cap, D, [-1, 0, cap // 2 + 7, cap - 1])
    scale = 1.0 / np.sqrt(D)
    kt = np.swapaxes(k, 2, 3)
    jdt = jnp.float32 if dt == "f32" else jnp.bfloat16
    tdt = torch.float32 if dt == "f32" else torch.bfloat16
    jk, jkt, jv = (jnp.asarray(a, jdt) for a in (k, kt, v))
    want_bd = np.asarray(jt.bd_decode(q, jkt, jv, lens, scale=scale, block_k=bk, interpret=True))
    want_nt = np.asarray(jt.nt_decode(q, jk, jv, lens, scale=scale, block_k=bk, interpret=True))
    tq, tk, tkt, tv, tl = _t(q, k, kt, v, lens)
    tk, tkt, tv = tk.to(tdt), tkt.to(tdt), tv.to(tdt)
    got_bd = tb.bd_decode_plain(tq, tkt, tv, tl, scale=scale, block_k=bk)
    got_nt = tb.nt_decode_plain(tq, tk, tv, tl, scale=scale, block_k=bk)
    assert got_bd.shape == got_nt.shape == (4, H, 1, D)
    assert got_bd.dtype == got_nt.dtype == torch.float32
    tol = dict(rtol=0, atol=1e-5) if dt == "f32" else dict(rtol=2e-2, atol=5e-3)
    np.testing.assert_allclose(got_bd.numpy(), want_bd, **tol)
    np.testing.assert_allclose(got_nt.numpy(), want_nt, **tol)
    assert not got_nt[0].any() and not got_bd[0].any()  # lens -1 -> 0
    if dt == "f32":
        np.testing.assert_allclose(got_bd.numpy(), got_nt.numpy(), rtol=0, atol=1e-5)
    kept = (cap // bk) * bk
    if kept < cap:  # the dropped tail: the output of the kept keys alone
        short = tb.nt_decode_plain(tq, tk[:, :, :kept].contiguous(), tv[:, :, :kept].contiguous(),
                                   tl.clamp(max=kept - 1), scale=scale, block_k=bk)
        assert torch.equal(short, got_nt)
    assert torch.equal(tb.bd_decode(tq, tkt, tv, tl, scale=scale, block_k=bk), got_bd)
    assert torch.equal(tb.nt_decode(tq, tk, tv, tl, scale=scale, block_k=bk), got_nt)


@pytest.mark.parametrize("H,Hkv,cap,bk", [(2, 2, 256, 128), (8, 2, 384, 256)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_bd_nt_decode_bf16_q_match_jax(jt, H, Hkv, cap, bk, dt):
    """A bf16 q: the reference's bd casts kt to q's dtype (f32 K rounds to
    bf16 for the score), nt widens q against f32 K, and both return bf16.
    Against the interpreted kernels at the bf16 rule (rtol 2e-2, atol 5e-3);
    the plain versions' bf16 outputs are the f32 outputs of the same
    arithmetic rounded once."""
    import jax.numpy as jnp

    D = 64
    q, k, v, lens = _inputs(H * cap + bk + 1, 4, H, Hkv, cap, D, [-1, 0, cap // 2 + 7, cap - 1])
    scale = 1.0 / np.sqrt(D)
    kt = np.swapaxes(k, 2, 3)
    jdt = jnp.float32 if dt == "f32" else jnp.bfloat16
    tdt = torch.float32 if dt == "f32" else torch.bfloat16
    jq = jnp.asarray(q, jnp.bfloat16)
    jk, jkt, jv = (jnp.asarray(a, jdt) for a in (k, kt, v))
    want_bd = jt.bd_decode(jq, jkt, jv, lens, scale=scale, block_k=bk, interpret=True)
    want_nt = jt.nt_decode(jq, jk, jv, lens, scale=scale, block_k=bk, interpret=True)
    assert want_bd.dtype == want_nt.dtype == jnp.bfloat16
    tq, tk, tkt, tv, tl = _t(q, k, kt, v, lens)
    tq = tq.to(torch.bfloat16)
    tk, tkt, tv = tk.to(tdt), tkt.to(tdt), tv.to(tdt)
    got_bd = tb.bd_decode_plain(tq, tkt, tv, tl, scale=scale, block_k=bk)
    got_nt = tb.nt_decode_plain(tq, tk, tv, tl, scale=scale, block_k=bk)
    assert got_bd.dtype == got_nt.dtype == torch.bfloat16
    assert got_bd.shape == got_nt.shape == (4, H, 1, D)
    for got, want in ((got_bd, want_bd), (got_nt, want_nt)):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=2e-2, atol=5e-3)
        assert not got[0].any()  # lens -1 -> 0
    # f32 K: nt scores q against K as it is, bd against bf16(K).
    q32 = tq.float()
    if dt == "f32":
        nt32 = tb.nt_decode_plain(q32, tk, tv, tl, scale=scale, block_k=bk)
        assert torch.equal(got_nt, nt32.to(torch.bfloat16))
        bd32 = tb.bd_decode_plain(q32, tkt.to(torch.bfloat16).float(), tv, tl, scale=scale,
                                  block_k=bk)
        assert torch.equal(got_bd, bd32.to(torch.bfloat16))
    assert torch.equal(tb.bd_decode(tq, tkt, tv, tl, scale=scale, block_k=bk), got_bd)
    assert torch.equal(tb.nt_decode(tq, tk, tv, tl, scale=scale, block_k=bk), got_nt)


def _fold_args(H=4, Hkv=2, cap=64, D=32, dt=torch.float32, qdt=torch.float32, B=2):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(B, H, 1, D, generator=g).to(qdt)
    k = torch.randn(B, Hkv, cap, D, generator=g).to(dt)
    v = torch.randn(B, Hkv, cap, D, generator=g).to(dt)
    return q, k, v, torch.tensor([3, cap - 1], dtype=torch.int32)


def _kt(args):
    q, k, v, lens = args
    return q, k.transpose(2, 3).contiguous(), v, lens


REFUSALS = {
    "bd f16 K/V": (TypeError, lambda: tb.bd_decode(*_kt(_fold_args(dt=torch.float16)), scale=1.0)),
    "nt f16 K/V": (TypeError, lambda: tb.nt_decode(*_fold_args(dt=torch.float16), scale=1.0)),
    "nt f16 q": (TypeError, lambda: tb.nt_decode(*_fold_args(qdt=torch.float16), scale=1.0)),
    "nt K/V of two dtypes": (TypeError, lambda: tb.nt_decode(
        *(lambda a: (a[0], a[1], a[2].bfloat16(), a[3]))(_fold_args()), scale=1.0)),
    "nt group 3/2": (ValueError, lambda: tb.nt_decode(*_fold_args(H=3), scale=1.0)),
    "nt odd D": (ValueError, lambda: tb.nt_decode(*_fold_args(D=33), scale=1.0)),
    "nt D 512": (ValueError, lambda: tb.nt_decode(*_fold_args(D=512), scale=1.0)),
    "bd natural K": (ValueError, lambda: tb.bd_decode(*_fold_args(), scale=1.0)),
    "nt lens int64": (ValueError, lambda: tb.nt_decode(
        *_fold_args()[:3], torch.tensor([3, 5]), scale=1.0)),
    "vpu GQA": (ValueError, lambda: tb.vpu_attn(*_fold_args(), 1.0)),
    "vpu bf16 K/V": (TypeError, lambda: tb.vpu_attn(*_fold_args(Hkv=4, dt=torch.bfloat16), 1.0)),
    "floor bf16 K/V": (TypeError, lambda: tb.dma_floor(*_fold_args(dt=torch.bfloat16))),
    "floor D 30": (ValueError, lambda: tb.dma_floor(*_fold_args(D=30))),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_wrappers_refuse_what_their_kernels_do_not_take(case):
    err, call = REFUSALS[case]
    with pytest.raises(err):
        call()


def test_main_on_cpu_prints_every_line(capsys):
    res = tb.main(["--device", "cpu", "--slots", "2", "--cap", "128", "--heads", "2",
                   "--d", "32"])
    out = capsys.readouterr().out.splitlines()
    labels = ["current folded-loop kernel", "pure DMA floor (same layout)",
              "VPU-vectorized kernel", "blockdiag kernel (K^T)", "blockdiag bf16 (K^T)",
              "CHAINED current kernel", "CHAINED bf16-KV kernel", "CHAINED DMA floor",
              "CHAINED blockdiag (K^T)", "CHAINED blockdiag bf16", "NT natural-layout kernel",
              "CHAINED NT natural", "CHAINED NT bf16"]
    assert len(out) == 1 + len(labels)
    assert out[0].startswith("the CPU") and "B=2 H=2 cap=128 D=32" in out[0]
    for label, text in zip(labels, out[1:]):
        assert text.startswith(label + ":") and text.endswith("[cpu]"), text
        assert res[label] > 0
    # The formulations agree with the fold (f32 to 1e-5, bf16 K/V to bf16's
    # rounding of K, V and p).
    for label in ("VPU-vectorized kernel", "blockdiag kernel (K^T)", "NT natural-layout kernel"):
        assert res[label + " maxerr"] <= 1e-5
    assert res["blockdiag bf16 (K^T) maxerr"] <= 5e-2


def test_main_needs_a_card_unless_told_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.main([])
    assert capsys.readouterr().out == ""
