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
