"""The port's kernel plain versions against the JAX package's references.

Inputs are made with numpy from a seed and handed to both packages; JAX
runs on the CPU (its XLA fallbacks, and the Pallas kernels in interpret
mode). On the CPU the port's wrappers run their plain versions, which is
what these tests hold against the reference; the CUDA kernels themselves
are held against the plain versions on the card (test_torch_on_card.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rten_tpu.kernels import argmax as jargmax
from rten_tpu.kernels import flash_attention as jfa
from rten_tpu.kernels import int8_matmul as jmm
from rten_tpu_torch.kernels import argmax as targmax
from rten_tpu_torch.kernels import flash_attention as tfa
from rten_tpu_torch.kernels import int4_matmul as t4
from rten_tpu_torch.kernels import int8_matmul as tmm
from rten_tpu_torch.kernels.common import u8_to_s8_shift


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# --- int8 matmul -----------------------------------------------------------


@pytest.mark.parametrize("M", [1, 3, 40])
def test_int8_matmul_plain_matches_jax(M):
    """u8 activations with a zero point, padded N with colsums, per-column
    scales. The integer part is exact; the f32 epilogue ``acc * sa * sb``
    rounds in the same order on both sides, so rtol 1e-6 covers it."""
    rng = np.random.default_rng(M)
    K, N, Np = 128, 200, 256
    a = rng.integers(0, 256, (M, K)).astype(np.uint8)
    b = np.zeros((K, Np), np.int8)
    b[:, :N] = rng.integers(-127, 128, (K, N))
    sa = np.float32(0.013)
    sb = np.ones(Np, np.float32)
    sb[:N] = rng.uniform(1e-4, 2e-3, N)
    zp = np.uint8(127)
    cs = b.astype(np.int32).sum(0)[None, :]

    got = tmm.int8_matmul_dequant(
        _t(a), _t(b), torch.tensor(sa), _t(sb), torch.tensor(zp), None, _t(cs)
    ).numpy()
    want_xla = np.asarray(jmm.int8_matmul_dequant_xla(
        jnp.asarray(a), jnp.asarray(b), sa, jnp.asarray(sb), zp
    ))
    want_pallas = np.asarray(jmm.int8_matmul_dequant(
        jnp.asarray(a), jnp.asarray(b), sa, jnp.asarray(sb), zp, None,
        jnp.asarray(cs), interpret=True,
    ))
    np.testing.assert_allclose(got, want_xla, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got, want_pallas, rtol=1e-6, atol=0)
    # Integer part exact: divide the scales back out.
    acc = got[:, :N] / (sa * sb[None, :N])
    ref = (a.astype(np.int64) - 127) @ b[:, :N].astype(np.int64)
    np.testing.assert_allclose(acc, ref, rtol=1e-5, atol=1e-2)


def test_int8_matmul_plain_both_zero_points():
    """s8 activations with per-row zero points and a per-column b zp."""
    rng = np.random.default_rng(7)
    M, K, N = 5, 64, 128
    a = rng.integers(-128, 128, (M, K)).astype(np.int8)
    b = rng.integers(-127, 128, (K, N)).astype(np.int8)
    azp = rng.integers(-3, 4, M).astype(np.int32)
    bzp = rng.integers(-2, 3, N).astype(np.int32)
    sa = rng.uniform(0.01, 0.02, M).astype(np.float32)
    sb = rng.uniform(0.01, 0.02, N).astype(np.float32)
    got = tmm.int8_matmul_dequant(
        _t(a), _t(b), _t(sa), _t(sb), _t(azp), _t(bzp)
    ).numpy()
    want = np.asarray(jmm.int8_matmul_dequant_xla(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(sa), jnp.asarray(sb),
        jnp.asarray(azp), jnp.asarray(bzp),
    ))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_u8_to_s8_shift_matches_jax():
    from rten_tpu.kernels.common import u8_to_s8_shift as j_shift

    a = np.arange(256, dtype=np.uint8).reshape(16, 16)
    got, gzp = u8_to_s8_shift(_t(a), torch.tensor(np.uint8(200)))
    want, wzp = j_shift(jnp.asarray(a), jnp.asarray(np.uint8(200)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(gzp) == int(wzp) == 72


# --- argmax ------------------------------------------------------------------


def test_argmax_plain_matches_jax_with_ties_and_stride():
    """First occurrence wins; a column slice of a wider matrix (the padded
    lm_head output) is read through its row stride. Exact."""
    rng = np.random.default_rng(3)
    full = rng.standard_normal((6, 2304)).astype(np.float32)
    full[0, 5] = full[0, 1000] = 50.0       # tie: index 5
    full[1, 2047] = full[1, 2048] = 60.0    # tie across the Pallas block edge
    full[2, 2099] = 70.0                     # last logical column
    full[3, 2200] = 99.0                     # beyond the slice: ignored
    n = 2100
    x = _t(full)[:, :n]
    assert x.stride(0) == 2304
    got = targmax.argmax_lastdim(x).numpy()
    xs = np.ascontiguousarray(full[:, :n])
    want_jnp = np.asarray(jnp.argmax(jnp.asarray(xs), axis=-1))
    want_pallas = np.asarray(jargmax.argmax_lastdim_pallas(jnp.asarray(xs), interpret=True))
    np.testing.assert_array_equal(got, want_jnp)
    np.testing.assert_array_equal(got, want_pallas)
    assert got[0] == 5 and got[1] == 2047 and got[2] == 2099
    assert got.dtype == np.int32


# --- decode attention + append ------------------------------------------------

B, H, D, CAP = 3, 2, 64, 64


def _decode_inputs(seed, lens, H_=H, Hkv=H, cap=CAP):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H_, 1, D)).astype(np.float32)
    kn = rng.standard_normal((B, Hkv, 1, D)).astype(np.float32)
    vn = rng.standard_normal((B, Hkv, 1, D)).astype(np.float32)
    kc = rng.integers(-127, 128, (B, cap, Hkv * D)).astype(np.int8)
    vc = rng.integers(-127, 128, (B, cap, Hkv * D)).astype(np.int8)
    ks = rng.uniform(0.005, 0.02, (B, Hkv, cap, 1)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, (B, Hkv, cap, 1)).astype(np.float32)
    # .5 ties in the quantizer: a row whose elements sit exactly halfway.
    kn[0, 0, 0, :4] = [0.5, 1.5, -2.5, 127.0]
    return q, kc, vc, np.asarray(lens, np.int32), ks, vs, kn, vn


def _port_decode(args, window=0):
    q, kc, vc, lens, ks, vs, kn, vn = (_t(x.copy()) for x in args)
    return [t.numpy() for t in tfa.decode_mha_append_cat(
        q, kc, vc, lens, ks, vs, k_new=kn, v_new=vn, window=window
    )]


def _jax(args, fn, window=0, **kw):
    q, kc, vc, lens, ks, vs, kn, vn = (jnp.asarray(x) for x in args)
    return [np.asarray(t) for t in fn(
        q, kc, vc, lens, ks, vs, k_new=kn, v_new=vn, window=window, **kw
    )]


def _check_caches(got, want, args, lens):
    """s8 rows bit-exact, scales to rtol 5e-6 (XLA may compile x/127 as a
    multiply by 1/127), rows the kernel does not own unchanged."""
    for i in (1, 2):
        np.testing.assert_array_equal(got[i], want[i])
    for i in (3, 4):
        np.testing.assert_allclose(got[i], want[i], rtol=5e-6, atol=0)
    cap = args[1].shape[1]
    wpos = np.minimum(lens, cap - 1)
    for b in range(B):
        keep = np.ones(cap, bool)
        keep[wpos[b]] = False
        np.testing.assert_array_equal(got[1][b, keep], args[1][b, keep])
        np.testing.assert_array_equal(got[3][b, :, keep], args[4][b, :, keep])


@pytest.mark.parametrize("lens", [[0, 31, CAP - 1], [CAP - 1, CAP, CAP + 7]])
def test_decode_append_plain_matches_xla_fallback(lens):
    """lens 0, 31, cap-1 and >= cap (the write clamps to row cap-1 and
    every row is attended). Output atol 1e-5 against the f32 fallback:
    same math, summation order differs."""
    args = _decode_inputs(1, lens)
    got = _port_decode(args)
    want = _jax(args, jfa.decode_attention_append_cat, use_flash=False)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    _check_caches(got, want, args, np.asarray(lens))


def test_decode_append_plain_matches_pallas_interpret():
    """Against the Pallas kernel in interpret mode, whose dots run in bf16:
    rtol 2e-2 / atol 5e-3 (tests/test_kernel_append.py:64-80). The Pallas
    kernel tiles the cache in blocks of 128 rows, so cap is 128 here."""
    cap = 128
    lens = [0, 31, cap - 1]
    args = _decode_inputs(2, lens, cap=cap)
    got = _port_decode(args)
    want = _jax(args, jfa.decode_mha_append_cat, interpret=True)
    np.testing.assert_allclose(got[0], want[0], rtol=2e-2, atol=5e-3)
    _check_caches(got, want, args, np.asarray(lens))


def test_decode_append_plain_gqa_window():
    """GQA (4 query heads on 2 kv heads) with a 16-row window."""
    lens = [5, 40, CAP - 1]
    args = _decode_inputs(3, lens, H_=4, Hkv=2)
    got = _port_decode(args, window=16)
    want = _jax(args, jfa.decode_attention_append_cat, use_flash=False, window=16)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    _check_caches(got, want, args, np.asarray(lens))


def test_decode_append_quantizer_rounds_half_to_even():
    """Row values chosen so that x / s lands exactly on .5: half-to-even."""
    args = list(_decode_inputs(4, [0, 0, 0]))
    kn = np.zeros((B, H, 1, D), np.float32)
    kn[:, :, 0, :5] = [127.0, 0.5, 1.5, 2.5, -0.5]  # s = 1.0 exactly
    args[6] = kn
    got = _port_decode(tuple(args))
    np.testing.assert_array_equal(got[1][0, 0, :5], [127, 0, 2, 2, 0])


# --- prefill attention --------------------------------------------------------


def _prefill_inputs(seed, lens, S, H_=H, Hkv=H, cap=CAP):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H_, S, D)).astype(np.float32)
    kc = rng.integers(-127, 128, (B, cap, Hkv * D)).astype(np.int8)
    vc = rng.integers(-127, 128, (B, cap, Hkv * D)).astype(np.int8)
    ks = rng.uniform(0.005, 0.02, (B, Hkv, cap, 1)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, (B, Hkv, cap, 1)).astype(np.float32)
    return q, kc, vc, np.asarray(lens, np.int32), ks, vs


@pytest.mark.parametrize("lens,S", [([0, 0, 0], 8), ([0, 10, 112], 8), ([3, 20, 40], 16)])
def test_prefill_plain_matches_jax(lens, S):
    """Against decode_mha_xla (the JAX engine's CPU path, atol 1e-5: same
    math) and the Pallas prefill kernel in interpret mode (bf16 dots:
    rtol 2e-2 / atol 5e-3). The Pallas kernel tiles the cache in blocks of
    128 rows, so cap is 128 here."""
    cap = 128
    q, kc, vc, lens_, ks, vs = _prefill_inputs(5, lens, S, cap=cap)
    got = tfa.prefill_mha_cat(
        _t(q), _t(kc), _t(vc), _t(lens_), _t(ks), _t(vs)
    ).numpy()
    want_xla = np.asarray(jfa.decode_mha_xla(
        jnp.asarray(q), jfa.cat_to_heads(jnp.asarray(kc), H),
        jfa.cat_to_heads(jnp.asarray(vc), H), jnp.asarray(lens_),
        jnp.asarray(ks).reshape(B, H, cap), jnp.asarray(vs).reshape(B, H, cap),
    ))
    want_pallas = np.asarray(jfa.prefill_mha_cat(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lens_),
        jnp.asarray(ks), jnp.asarray(vs), interpret=True,
    ))
    np.testing.assert_allclose(got, want_xla, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, want_pallas, rtol=2e-2, atol=5e-3)


def test_prefill_plain_gqa_window():
    q, kc, vc, lens_, ks, vs = _prefill_inputs(6, [0, 7, 30], 8, H_=4, Hkv=2)
    got = tfa.prefill_mha_cat(
        _t(q), _t(kc), _t(vc), _t(lens_), _t(ks), _t(vs), window=12
    ).numpy()
    want = np.asarray(jfa.decode_mha_xla(
        jnp.asarray(q), jfa.cat_to_heads(jnp.asarray(kc), 2),
        jfa.cat_to_heads(jnp.asarray(vc), 2), jnp.asarray(lens_),
        jnp.asarray(ks).reshape(B, 2, CAP), jnp.asarray(vs).reshape(B, 2, CAP),
        window=12,
    ))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_cat_layout_helpers_match_jax():
    x = np.arange(2 * 3 * 4 * 8, dtype=np.float32).reshape(2, 3, 4, 8)
    np.testing.assert_array_equal(
        tfa.heads_to_cat(_t(x)).numpy(), np.asarray(jfa.heads_to_cat(jnp.asarray(x)))
    )
    c = x.reshape(2, 4, 24)
    np.testing.assert_array_equal(
        tfa.cat_to_heads(_t(c), 3).numpy(), np.asarray(jfa.cat_to_heads(jnp.asarray(c), 3))
    )


def test_wrappers_refuse_mixed_devices():
    """A wrapper runs the plain version only when every tensor is on the
    CPU; anything else raises instead of falling back."""
    a = torch.zeros((2, 4), dtype=torch.uint8, device="meta")
    b = torch.zeros((4, 4), dtype=torch.int8)
    with pytest.raises(ValueError):
        tmm.int8_matmul_dequant(a, b, 1.0, 1.0)
    with pytest.raises(ValueError):
        targmax.argmax_lastdim(torch.zeros((2, 4), device="meta"))


# --- decode_mha on head-major caches ------------------------------------------


def _head_major_inputs(seed, S, H_, Hkv, lens, quant, cap=CAP):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H_, S, D)).astype(np.float32)
    if quant:
        k = rng.integers(-127, 128, (B, Hkv, cap, D)).astype(np.int8)
        v = rng.integers(-127, 128, (B, Hkv, cap, D)).astype(np.int8)
        ks = rng.uniform(0.005, 0.02, (B, Hkv, cap)).astype(np.float32)
        vs = rng.uniform(0.005, 0.02, (B, Hkv, cap)).astype(np.float32)
    else:
        k = rng.standard_normal((B, Hkv, cap, D)).astype(np.float32)
        v = rng.standard_normal((B, Hkv, cap, D)).astype(np.float32)
        ks = vs = None
    return q, k, v, np.asarray(lens, np.int32), ks, vs


def _both(args, window):
    """(port decode_mha on the CPU, JAX decode_mha_xla) on the same inputs."""
    got = tfa.decode_mha(*(None if a is None else _t(a) for a in args),
                         window=window).numpy()
    want = np.asarray(jfa.decode_mha_xla(
        *(None if a is None else jnp.asarray(a) for a in args), window=window))
    return got, want


@pytest.mark.parametrize("quant", [True, False])
@pytest.mark.parametrize("S,H_,Hkv,window,lens", [
    (1, 2, 2, 0, [0, 31, CAP - 1]),           # decode, group 1
    (1, 8, 2, 0, [CAP - 1, CAP, CAP + 7]),    # group 4; rows past cap see every column
    (1, 8, 2, 16, [5, 40, CAP - 1]),          # sliding window
    (16, 2, 2, 0, [0, 10, CAP - 16]),         # admission-sized chunk
    (16, 8, 2, 12, [0, 7, 30]),
    (16, 8, 2, 0, [CAP - 16, CAP - 1, CAP + 3]),
])
def test_decode_mha_plain_matches_xla(quant, S, H_, Hkv, window, lens):
    """Against the JAX engine's CPU path (decode_mha_xla): the same math,
    another summation order: atol 1e-5."""
    args = _head_major_inputs(S * 10 + H_, S, H_, Hkv, lens, quant)
    got, want = _both(args, window)
    assert got.shape == (B, H_, S, D)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("quant", [True, False])
@pytest.mark.parametrize("S,H_,Hkv,window", [
    (1, 2, 2, 0), (1, 8, 2, 16), (16, 2, 2, 0), (16, 8, 2, 12),
])
def test_decode_mha_plain_matches_pallas_interpret(quant, S, H_, Hkv, window):
    """Against the Pallas decode_mha in interpret mode (S 1 takes its
    head-folded body, S 16 its per-head grid), at cap 128 (the Pallas
    kernel tiles keys in blocks of 128). The reference's own tolerances
    (tests/test_kernels.py:156-158): s8 rtol/atol 5e-3 (its s8 dots round
    q and p to bf16), f32 rtol 2e-4, atol 2e-5. Those were set at D 32; at
    D 64 q's rounding alone can exceed them, so q lies on the bf16 grid
    here and only p's rounding remains."""
    cap = 128
    lens = [0, 50, cap - S]
    q, k, v, lens_, ks, vs = _head_major_inputs(S + H_ + window, S, H_, Hkv, lens,
                                                quant, cap=cap)
    q = np.asarray(jnp.asarray(q).astype(jnp.bfloat16).astype(jnp.float32))
    got = tfa.decode_mha(_t(q), _t(k), _t(v), _t(lens_),
                         *((_t(ks), _t(vs)) if quant else ()), window=window).numpy()
    want = np.asarray(jfa.decode_mha(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens_),
        *((jnp.asarray(ks), jnp.asarray(vs)) if quant else ()),
        window=window, interpret=True))
    tol = dict(rtol=5e-3, atol=5e-3) if quant else dict(rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got, want, **tol)


def test_decode_mha_reads_kv_head_h_over_group():
    """Query head h reads kv head h // group (kv-major grouping): with every
    kv head but one zeroed, only that head's group sees its values."""
    q, k, v, lens, _, _ = _head_major_inputs(9, 1, 8, 2, [20, 20, 20], False)
    v[:, 0] = 0.0
    out = tfa.decode_mha(_t(q), _t(k), _t(v), _t(lens)).numpy()
    assert np.abs(out[:, :4]).max() == 0.0
    assert np.abs(out[:, 4:]).min(axis=-1).max() > 0.0


def test_decode_mha_refuses_mixed_devices():
    q = torch.zeros((1, 2, 1, 64), device="meta")
    k = torch.zeros((1, 2, 8, 64))
    with pytest.raises(ValueError):
        tfa.decode_mha(q, k, k, torch.zeros(1, dtype=torch.int32))


# --- flash attention (mha) -----------------------------------------------------


def _mha_inputs(B, Hq, Hkv, Tq, Tk, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Hq, Tq, D), (B, Hkv, Tk, D), (B, Hkv, Tk, D))]


def _live_rows(Tq, Tk, causal, mask):
    """[Tq] rows with at least one column to attend (the kernels give 0 on
    the others, the XLA fallback and the plain version the mean of V)."""
    live = np.ones((Tq, Tk), bool)
    if causal:
        live &= np.arange(Tk)[None] <= np.arange(Tq)[:, None] + Tk - Tq
    if mask is not None:
        live &= np.broadcast_to(mask, (Tq, Tk)) > -1e29
    return live.any(-1)


@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D,causal,softcap,mask,bq", [
    (1, 2, 2, 24, 40, 16, False, 0.0, "random", 8),     # test_kernels.py:73-87
    (1, 2, 2, 24, 40, 16, False, 0.0, "random", 16),
    (1, 2, 2, 12, 24, 8, True, 0.0, "row", 8),          # the [1, Tk] regression, :119-131
    (1, 4, 2, 40, 56, 32, False, 0.0, None, 16),        # GQA, test_ops_extended.py:77-91
    (1, 4, 2, 40, 56, 32, True, 0.0, None, 16),
    (1, 4, 2, 40, 56, 32, False, 30.0, None, 16),
    (1, 4, 2, 40, 56, 32, True, 30.0, None, 16),
    (1, 2, 2, 16, 16, 64, True, 0.0, "left_pad", 8),    # a left-padded prefill
    (2, 4, 1, 9, 30, 32, True, 5.0, "full", 8),         # group 4, Tq != Tk, a [Tq, Tk] mask
])
def test_mha_plain_matches_jax(B, Hq, Hkv, Tq, Tk, D, causal, softcap, mask, bq):
    """mha_plain (the CPU path of the mha wrapper) against mha_xla on every
    row, and against mha_pallas(interpret=True) on the rows that have a
    column to attend: rtol 1e-4, atol 1e-5, the reference's own tolerance.
    On rows with none the Pallas kernel gives 0, as the CUDA kernel does."""
    from rten_tpu.kernels.flash_attention import mha_pallas, mha_xla

    q, k, v = _mha_inputs(B, Hq, Hkv, Tq, Tk, D, Tq * Tk + D)
    rng = np.random.default_rng(D)
    m = {None: None,
         "random": np.where(rng.random((Tq, Tk)) > 0.2, 0.0, -1e30),
         "full": np.where(rng.random((Tq, Tk)) > 0.3, 0.0, -1e30),
         "row": np.where(np.arange(Tk) < 5, -1e30, 0.0)[None],
         "left_pad": np.where(np.arange(Tk) < 5, -1e30, 0.0)[None]}[mask]
    m = None if m is None else m.astype(np.float32)
    kw = dict(causal=causal, softcap=softcap)
    got = tfa.mha(_t(q), _t(k), _t(v), None if m is None else _t(m), **kw).numpy()
    want = np.asarray(mha_xla(q, k, v, m, **kw))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    pallas = np.asarray(mha_pallas(q, k, v, m, block_q=bq, block_k=128, interpret=True, **kw))
    live = _live_rows(Tq, Tk, causal, m)
    np.testing.assert_allclose(got[:, :, live], pallas[:, :, live], rtol=1e-4, atol=1e-5)
    assert (pallas[:, :, ~live] == 0).all()


def test_mha_plain_keeps_bf16_and_broadcasts_masks():
    """q's dtype comes back (bf16 in, bf16 out) and masks of rank 1-4
    broadcast as in mha_xla."""
    from rten_tpu.kernels.flash_attention import mha_xla

    q, k, v = _mha_inputs(2, 2, 2, 8, 8, 16, 1)
    m4 = np.where(np.random.default_rng(2).random((2, 1, 1, 8)) > 0.3, 0.0, -1e30)
    m4 = m4.astype(np.float32)
    got = tfa.mha_plain(_t(q), _t(k), _t(v), _t(m4), causal=True).numpy()
    np.testing.assert_allclose(got, np.asarray(mha_xla(q, k, v, m4, causal=True)),
                               rtol=1e-4, atol=1e-5)
    bf = tfa.mha_plain(_t(q).bfloat16(), _t(k).bfloat16(), _t(v).bfloat16())
    assert bf.dtype == torch.bfloat16


@pytest.mark.parametrize("shape", [(1, 8, 8), (1, 1, 8, 8)])
def test_mha_refuses_masks_above_two_dims(shape):
    """The kernel wrapper takes a mask of at most 2 dims; folding leading
    unit dims is the Attention op's job."""
    q, k, v = (_t(a) for a in _mha_inputs(1, 2, 2, 8, 8, 16, 3))
    with pytest.raises(ValueError, match="at most 2 dims"):
        tfa.mha(q, k, v, torch.zeros(shape))


# --- int4 matmul ----------------------------------------------------------------------


@pytest.mark.parametrize("m,k,n,bs", [(4, 256, 96, 32), (17, 512, 130, 64)])
@pytest.mark.parametrize("with_zp", [False, True])
def test_int4_matmul_plain_matches_jax(m, k, n, bs, with_zp):
    """int4_matmul (the CPU path: unpack the zero points, int4_matmul_plain)
    against the reference's int4_matmul_xla and int4_matmul_pallas in
    interpret mode at the reference's shapes (test_kernels.py:99-116):
    rtol 1e-4, atol 1e-4."""
    from rten_tpu.kernels.int4_matmul import (
        _unpack_zero_points, int4_matmul_pallas, int4_matmul_xla,
    )

    rng = np.random.default_rng(m * k + n)
    nb = k // bs
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.integers(0, 255, (n, k // 2)).astype(np.uint8)
    scales = rng.uniform(0.01, 0.1, (n, nb)).astype(np.float32)
    zp = rng.integers(0, 255, (n * ((nb + 1) // 2),)).astype(np.uint8) if with_zp else None
    zps = _unpack_zero_points(zp, n, nb)
    got = t4.int4_matmul(_t(a), _t(b), _t(scales), None if zp is None else _t(zp),
                         K=k, N=n, block_size=bs).numpy()
    want = np.asarray(int4_matmul_xla(a, b, scales, zps, K=k, N=n, block_size=bs))
    pallas = np.asarray(int4_matmul_pallas(a, b, scales, zps, K=k, N=n, block_size=bs,
                                           block_m=32, block_n=64, block_k=256,
                                           interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, pallas, rtol=1e-4, atol=1e-4)
    tz = t4.unpack_zero_points(None if zp is None else _t(zp), n, nb)
    assert (tz is None) == (zp is None)
    if zp is not None:
        np.testing.assert_array_equal(tz.numpy(), np.asarray(zps))


@pytest.mark.parametrize("K,bs,zp", [(100, 32, "u8"), (96, 16, None), (80, 16, "u8"),
                                     (64, 32, "i32")])
def test_dequant_nbits_matches_jax(K, bs, zp):
    """Dequantized weights bit-exact against the reference's dequant_nbits:
    K not a multiple of the block (trimmed), an odd block count with u8
    zero points (each column padded to a byte), int32 zero points."""
    from rten_tpu.ops.matmul import dequant_nbits as jdequant

    N = 6
    nb = -(-K // bs)
    rng = np.random.default_rng(K + bs)
    packed = rng.integers(0, 256, (N, nb, bs // 2)).astype(np.uint8)
    scales = rng.uniform(0.01, 0.1, (N, nb)).astype(np.float32)
    zps = {None: None, "u8": rng.integers(0, 256, N * ((nb + 1) // 2)).astype(np.uint8),
           "i32": rng.integers(0, 16, (N, nb)).astype(np.int32)}[zp]
    got = t4.dequant_nbits(_t(packed), _t(scales), None if zps is None else _t(zps),
                           K=K, N=N, block_size=bs).numpy()
    want = np.asarray(jdequant(packed, scales, zps, K=K, N=N, block_size=bs))
    np.testing.assert_array_equal(got, want)
