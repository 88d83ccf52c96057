"""Serving on f32 and bf16 KV caches (no scales) in the port against the JAX
package: the unquantized modes of the attention kernels' plain versions
(the cat-cache append, flat and through a block table; the cat-cache
prefill at D 64 and 128; decode_mha and paged_decode_mha on bf16), the
GroupQueryAttention branches that feed them, the builders' f32/bf16 and
head-major options, and the engine token for token.

Sizes: GPT-2 2 layers, E 128, H 2, D 64, vocab 512, slots 3, cap 64;
Llama at D 64 (E 256, 4 query heads over 2 KV heads) and at D 128 (E 512,
the same heads, Qwen2's q/k/v biases and tied embeddings). Inputs are numpy
from a seed, handed to both packages; bf16 arrays are ``ml_dtypes``'
bfloat16, compared bit for bit as int16. JAX runs on the CPU (its XLA
fallbacks, and the Pallas kernels in interpret mode, which need cap % 128
== 0, so those cases run at cap 128); on the CPU the port's kernel
wrappers run their plain versions. Tolerances are the reference's own
(tests/test_kernel_append.py:64-80): atol 1e-5 against the f32 fallbacks,
rtol 2e-2 / atol 5e-3 against the interpreted kernels (bf16 dots; q lies
on the bf16 grid), cache rows bit-exact.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from rten_tpu.dtypes import DataType as JDataType
from rten_tpu.ir.builder import GraphBuilder as JBuilder
from rten_tpu.kernels import flash_attention as jfa
from rten_tpu.model import Model as JModel
from rten_tpu.model import ModelOptions as JOptions
from rten_tpu.models import gpt2 as jgpt2
from rten_tpu.models import llama as jllama
from rten_tpu.quantize_pass import quantize_dynamic as jquantize
from rten_tpu.serving import ContinuousBatchingEngine as JEngine
from rten_tpu_torch.dtypes import DataType as TDataType
from rten_tpu_torch.ir.builder import GraphBuilder as TBuilder
from rten_tpu_torch.kernels import flash_attention as tfa
from rten_tpu_torch.model import Model as TModel
from rten_tpu_torch.model import ModelOptions as TOptions
from rten_tpu_torch.models import gpt2 as tgpt2
from rten_tpu_torch.models import llama as tllama
from rten_tpu_torch.quantize_pass import quantize_dynamic as tquantize
from rten_tpu_torch.serving import ContinuousBatchingEngine as TEngine
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

BF16 = np.dtype(ml_dtypes.bfloat16)
DTYPES = {"f32": np.dtype(np.float32), "bf16": BF16}


def _t(a):
    """numpy (bf16 included) -> torch, the same bits."""
    a = np.ascontiguousarray(a)
    if a.dtype == BF16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _np(t):
    """torch (bf16 included) -> numpy, the same bits."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16)
    return t.numpy()


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == BF16 else a


def _bf16_grid(x):
    """q on the bf16 grid: the interpreted kernels' dots round q to bf16."""
    return x.astype(BF16).astype(np.float32)


def _cat_rows(x):
    """[B, Hkv, 1, D] -> [B, Hkv*D] (the cat row of each slot)."""
    B = x.shape[0]
    return x.transpose(0, 2, 1, 3).reshape(B, -1)


# --- decode_mha_append_cat, flat (flash_attention.py:2597, fallback :3109) ----------


def _append_inputs(seed, dt, B, H_, Hkv, D, rows):
    """q, k_new, v_new and two caches/pools of ``rows`` positions."""
    rng = np.random.default_rng(seed)
    q = _bf16_grid(rng.standard_normal((B, H_, 1, D)).astype(np.float32))
    kn = rng.standard_normal((B, Hkv, 1, D)).astype(np.float32)
    vn = rng.standard_normal((B, Hkv, 1, D)).astype(np.float32)
    kn[0, 0, 0, :3] = [1.00390625, -1.01171875, 3.0]  # bf16 ties: round to even
    kc = rng.standard_normal(rows + (Hkv * D,)).astype(DTYPES[dt])
    vc = rng.standard_normal(rows + (Hkv * D,)).astype(DTYPES[dt])
    return q, kn, vn, kc, vc


def _port_append(q, kn, vn, kc, vc, lens, **kw):
    out = tfa.decode_mha_append_cat(_t(q), _t(kc.copy()), _t(vc.copy()), _t(lens),
                                    k_new=_t(kn), v_new=_t(vn), **kw)
    assert len(out) == 3  # f32/bf16 caches: (out, kc, vc), as the reference returns
    return [_np(t) for t in out]


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("H_,Hkv,D,window", [(4, 4, 64, 0), (8, 2, 128, 0), (4, 4, 64, 20)])
def test_append_plain_matches_jax_fallback(dt, H_, Hkv, D, window):
    """Against decode_attention_append_cat(use_flash=False): output atol
    1e-5; caches bit-exact, the written row equal to the new row rounded to
    the cache dtype (ties to even), every other row unchanged. lens cover
    an empty cache, the last row and past cap (the write clamps)."""
    B, cap = 5, 64
    lens = np.array([0, 31, cap - 1, cap, cap + 7], np.int32)
    q, kn, vn, kc, vc = _append_inputs(H_ + D + window, dt, B, H_, Hkv, D, (B, cap))
    got = _port_append(q, kn, vn, kc, vc, lens, window=window)
    want = [np.asarray(a) for a in jfa.decode_attention_append_cat(
        *map(jnp.asarray, (q, kc, vc, lens)), k_new=jnp.asarray(kn), v_new=jnp.asarray(vn),
        window=window, use_flash=False)]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    for g, w, new, old in ((got[1], want[1], kn, kc), (got[2], want[2], vn, vc)):
        assert g.dtype == DTYPES[dt]
        np.testing.assert_array_equal(_bits(g), _bits(w))
        wpos = np.minimum(lens, cap - 1)
        np.testing.assert_array_equal(_bits(g[np.arange(B), wpos]),
                                      _bits(_cat_rows(new).astype(DTYPES[dt])))
        keep = np.ones((B, cap), bool)
        keep[np.arange(B), wpos] = False
        np.testing.assert_array_equal(_bits(g[keep]), _bits(old[keep]))


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("H_,Hkv,D", [(4, 4, 64), (8, 2, 128)])
def test_append_plain_matches_pallas_interpret(dt, H_, Hkv, D):
    """Against the Pallas kernel in interpret mode (cap 128): output rtol
    2e-2, atol 5e-3; caches bit-exact (the kernel writes the row rounded to
    the cache dtype too). lens stay below cap here: past it the interpreted
    kernel and the reference's own fallback disagree on f32/bf16 caches,
    and the port follows the fallback (the test above)."""
    B, cap = 4, 128
    lens = np.array([0, 63, 100, cap - 1], np.int32)
    q, kn, vn, kc, vc = _append_inputs(7 * D + H_, dt, B, H_, Hkv, D, (B, cap))
    got = _port_append(q, kn, vn, kc, vc, lens)
    want = [np.asarray(a) for a in jfa.decode_mha_append_cat(
        *map(jnp.asarray, (q, kc, vc, lens)), k_new=jnp.asarray(kn), v_new=jnp.asarray(vn),
        interpret=True)]
    np.testing.assert_allclose(got[0], want[0], rtol=2e-2, atol=5e-3)
    for i in (1, 2):
        np.testing.assert_array_equal(_bits(got[i]), _bits(want[i]))


# --- decode_mha_append_cat through a block table (fallback :3032) ------------------


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("H_,Hkv,window", [(4, 4, 0), (8, 2, 20)])
def test_paged_append_plain_matches_jax_fallback(dt, H_, Hkv, window):
    """Against decode_attention_append_cat(use_flash=False, block_table=)
    with idle slots colliding in block 0 and lens at 0, BS - 1 and past cap:
    output atol 1e-5, pools bit-exact, the later slot's row left where two
    slots write one row, blocks no slot owns unchanged."""
    D, BS, MB, NB = 64, 16, 3, 10
    bt = np.zeros((6, MB), np.int32)
    bt[:3] = np.random.default_rng(0).permutation(np.arange(1, NB))[:9].reshape(3, MB)
    lens = np.array([0, BS - 1, 60, 5, 5, 47], np.int32)  # slots 3-5 idle
    q, kn, vn, pk, pv = _append_inputs(H_ + window, dt, 6, H_, Hkv, D, (NB, BS))
    got = _port_append(q, kn, vn, pk, pv, lens, window=window, block_table=_t(bt))
    want = [np.asarray(a) for a in jfa.decode_attention_append_cat(
        *map(jnp.asarray, (q, pk, pv, lens)), k_new=jnp.asarray(kn), v_new=jnp.asarray(vn),
        window=window, use_flash=False, block_table=jnp.asarray(bt))]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    for i in (1, 2):
        np.testing.assert_array_equal(_bits(got[i]), _bits(want[i]))
    # Slots 3 and 4 write row 5 of block 0: slot 4's row stays.
    np.testing.assert_array_equal(_bits(got[1][0, 5]),
                                  _bits(_cat_rows(kn)[4].astype(DTYPES[dt])))
    free = [b for b in range(1, NB) if b not in bt]
    np.testing.assert_array_equal(_bits(got[1][free]), _bits(pk[free]))


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("H_,Hkv,D", [(4, 4, 64), (8, 2, 128)])
def test_paged_append_plain_matches_pallas_interpret(dt, H_, Hkv, D):
    """Against the Pallas block-table kernel in interpret mode (cap 128,
    distinct blocks per slot): output rtol 2e-2, atol 5e-3; pools
    bit-exact."""
    BS, MB, NB = 64, 2, 6
    bt = np.array([[1, 2], [3, 4]], np.int32)
    q, kn, vn, pk, pv = _append_inputs(D + H_, dt, 2, H_, Hkv, D, (NB, BS))
    for lens_l in ([0, 100], [63, 127]):
        lens = np.array(lens_l, np.int32)
        got = _port_append(q, kn, vn, pk, pv, lens, block_table=_t(bt))
        want = [np.asarray(a) for a in jfa.decode_mha_append_cat(
            *map(jnp.asarray, (q, pk, pv, lens)), k_new=jnp.asarray(kn),
            v_new=jnp.asarray(vn), interpret=True, block_table=jnp.asarray(bt))]
        np.testing.assert_allclose(got[0], want[0], rtol=2e-2, atol=5e-3)
        for i in (1, 2):
            np.testing.assert_array_equal(_bits(got[i]), _bits(want[i]))


# --- prefill_mha_cat (flash_attention.py:3301) -------------------------------------


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("D,Hkv", [(64, 4), (64, 2), (128, 4), (128, 2)])
def test_prefill_plain_matches_jax(dt, D, Hkv):
    """Groups 1 and 2 at D 64 and 128, cap 128: against the interpreted
    Pallas kernel rtol 2e-2, atol 5e-3, and against decode_mha_xla on the
    widened caches (the reference's CPU path) atol 1e-5; with a window of
    24 against the latter. The f32 caches hold values on the bf16 grid, as
    q does: the interpreted kernel's dots round K and V to bf16, which on
    arbitrary f32 values alone moves an output past atol 5e-3."""
    B, H_, S, cap = 3, 4, 16, 128
    rng = np.random.default_rng(D + Hkv)
    q = _bf16_grid(rng.standard_normal((B, H_, S, D)).astype(np.float32))
    kc, vc = (_bf16_grid(rng.standard_normal((B, cap, Hkv * D))).astype(DTYPES[dt])
              for _ in range(2))
    lens = np.array([0, 40, cap - S], np.int32)
    kh, vh = (jfa.cat_to_heads(jnp.asarray(c), Hkv).astype(jnp.float32) for c in (kc, vc))
    for window in (0, 24):
        got = tfa.prefill_mha_cat(_t(q), _t(kc), _t(vc), _t(lens), window=window).numpy()
        xla = np.asarray(jfa.decode_mha_xla(jnp.asarray(q), kh, vh, jnp.asarray(lens),
                                            window=window))
        np.testing.assert_allclose(got, xla, rtol=0, atol=1e-5)
    got = tfa.prefill_mha_cat(_t(q), _t(kc), _t(vc), _t(lens)).numpy()
    want = np.asarray(jfa.prefill_mha_cat(*map(jnp.asarray, (q, kc, vc, lens)),
                                          interpret=True))
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=5e-3)


# --- decode_mha and paged_decode_mha on bf16 (:935, :772, :3425) -------------------


@pytest.mark.parametrize("S,window", [(1, 0), (1, 24), (8, 0)])
def test_decode_mha_plain_bf16_matches_jax(S, window):
    """bf16 head-major caches, TinyLlama's group (32 / 4 heads at D 64, cut
    to 16 / 2): against decode_mha_xla atol 1e-5 and the interpreted Pallas
    decode_mha (cap 128) rtol 2e-2, atol 5e-3. S 1 is the fold's step, S 8
    an admission."""
    B, H_, Hkv, D, cap = 3, 16, 2, 64, 128
    rng = np.random.default_rng(S + window)
    q = _bf16_grid(rng.standard_normal((B, H_, S, D)).astype(np.float32))
    k = rng.standard_normal((B, Hkv, cap, D)).astype(BF16)
    v = rng.standard_normal((B, Hkv, cap, D)).astype(BF16)
    lens = np.array([0, 50, cap - S], np.int32)
    got = tfa.decode_mha(_t(q), _t(k), _t(v), _t(lens), window=window).numpy()
    jargs = tuple(map(jnp.asarray, (q, k, v, lens)))
    xla = np.asarray(jfa.decode_mha_xla(*jargs, window=window))
    np.testing.assert_allclose(got, xla, rtol=0, atol=1e-5)
    want = np.asarray(jfa.decode_mha(*jargs, window=window, interpret=True))
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=5e-3)


@pytest.mark.parametrize("window", [0, 24])
def test_paged_decode_mha_plain_bf16_matches_jax(window):
    """bf16 head-major pools through a shuffled table: against
    paged_attention(use_flash=False) atol 1e-5 (S 1 and an admission of
    S 6) and the interpreted Pallas paged_decode_mha (cap 128) rtol 2e-2,
    atol 5e-3."""
    B, H_, Hkv, D, BS, MB, NB = 4, 8, 2, 64, 32, 4, 18
    rng = np.random.default_rng(5 + window)
    pk = rng.standard_normal((NB, Hkv, BS, D)).astype(BF16)
    pv = rng.standard_normal((NB, Hkv, BS, D)).astype(BF16)
    bt = rng.permutation(np.arange(1, NB))[: B * MB].reshape(B, MB).astype(np.int32)
    lens = np.array([0, 31, 32, 127], np.int32)
    for S in (1, 6):
        q = _bf16_grid(rng.standard_normal((B, H_, S, D)).astype(np.float32))
        lens_s = np.minimum(lens, MB * BS - S).astype(np.int32)
        got = tfa.paged_attention(*map(_t, (q, pk, pv, lens_s, bt)), window=window).numpy()
        jargs = tuple(map(jnp.asarray, (q, pk, pv, lens_s, bt)))
        want = np.asarray(jfa.paged_attention(*jargs, window=window, use_flash=False))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        if S == 1:
            want = np.asarray(jfa.paged_decode_mha(*jargs, window=window, interpret=True))
            np.testing.assert_allclose(got, want, rtol=2e-2, atol=5e-3)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """The checks a CUDA tensor meets (run here on CPU tensors, which pass
    the device checks): f16 caches, int8 caches without scales, f32 caches
    with scales, int4 (u8) cat caches, and an odd or too large head dim
    raise before any launch; D 32 on f32/bf16 caches is taken (a masked
    tail in the D 64 instance)."""
    q = torch.zeros(2, 2, 1, 32)
    lens = torch.zeros(2, dtype=torch.int32)
    sc = torch.ones(2, 2, 8, 1)
    with pytest.raises(TypeError, match="float16"):
        tfa._check_common(q, torch.zeros(2, 8, 64, dtype=torch.float16),
                          torch.zeros(2, 8, 64, dtype=torch.float16), lens, None, None, 2)
    with pytest.raises(ValueError, match="scales"):
        tfa._check_common(q, torch.zeros(2, 8, 64, dtype=torch.int8),
                          torch.zeros(2, 8, 64, dtype=torch.int8), lens, None, None, 2)
    with pytest.raises(ValueError, match="scales"):
        tfa._check_common(q, torch.zeros(2, 8, 64), torch.zeros(2, 8, 64), lens, sc, sc, 2)
    with pytest.raises(TypeError, match="head-major only"):
        tfa._check_common(q, torch.zeros(2, 8, 64, dtype=torch.uint8),
                          torch.zeros(2, 8, 64, dtype=torch.uint8), lens, sc[..., 0], sc[..., 0], 2)
    kind, _, _, D = tfa._check_common(q, torch.zeros(2, 8, 64, dtype=torch.bfloat16),
                                      torch.zeros(2, 8, 64, dtype=torch.bfloat16), lens,
                                      None, None, 2)
    assert D == 32 and kind == tfa.KV_KINDS[torch.bfloat16]
    tfa._check_head_dim(D, 256)
    for bad in (33, 0, 514):
        with pytest.raises(ValueError, match="head dim"):
            tfa._check_head_dim(bad, 512)


# --- GroupQueryAttention's cat, pool and bf16 branches (ops/attention.py:470-676) ----

GB, GH, GHKV, GD, GCAP, GBS = 3, 4, 2, 64, 64, 16
GQA_LAYOUTS = {
    # name: (cache dtype, cat layout, paged)
    "f32_cat": ("f32", True, False),
    "bf16_cat": ("bf16", True, False),
    "bf16_head_major": ("bf16", False, False),
    "f32_cat_pools": ("f32", True, True),
    "bf16_cat_pools": ("bf16", True, True),
    "bf16_head_major_pools": ("bf16", False, True),
}


def _gqa_build(dt, kernel_append, paged, rope):
    """One rten_past_lens GroupQueryAttention node with rotary on f32/bf16
    caches or pools (a block table as input 9 when paged)."""

    def build(GB_, DT):
        b = GB_()
        q, k, v = (b.input(n, DT.Float) for n in ("q", "k", "v"))
        cdt = DT.BFloat16 if dt == "bf16" else DT.Float
        pk, pv, lens = b.input("kc", cdt), b.input("vc", cdt), b.input("lens", DT.Int32)
        cos, sin = b.constant("cos", rope[0]), b.constant("sin", rope[1])
        ins = [q, k, v, pk, pv, lens, None, cos, sin]
        attrs = {"num_heads": GH, "kv_num_heads": GHKV, "do_rotary": 1, "rten_past_lens": 1}
        if paged:
            ins.append(b.input("bt", DT.Int32))
            attrs["rten_paged"] = 1
        if kernel_append:
            attrs["rten_kernel_append"] = 1
        b.output(*b.op("GroupQueryAttention", ins, attrs, n_outputs=3,
                       output_names=["out", "nkc", "nvc"]))
        return b.finish()

    return build


@pytest.mark.parametrize("S", [1, 8])
@pytest.mark.parametrize("layout", list(GQA_LAYOUTS))
def test_group_query_attention_matches_jax(layout, S):
    """Each cache layout at a decode step (S 1; cat layouts through the
    in-kernel append) and an admission (S 8), built and run in both
    packages: output atol 1e-5; bf16 caches and pools bit-exact, f32 ones
    atol 1e-6 (the rows are rotated in f32, where XLA may fuse a
    multiply-add into one rounding, then rounded to the cache dtype, which
    absorbs that ulp at these inputs). lens cover an empty cache, a mid row
    and a chunk past cap (the write clamps)."""
    dt, cat, paged = GQA_LAYOUTS[layout]
    rng = np.random.default_rng(S + len(layout))
    ang = rng.uniform(0, 6.3, (96, GD // 2))
    rope = (np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))
    feed = {n: rng.standard_normal((GB, S, h * GD)).astype(np.float32)
            for n, h in (("q", GH), ("k", GHKV), ("v", GHKV))}
    lens = np.array([0, 21, GCAP + 3], np.int32)
    if paged:
        nb = 1 + GB * GCAP // GBS
        shape = (nb, GBS, GHKV * GD) if cat else (nb, GHKV, GBS, GD)
        feed["bt"] = rng.permutation(np.arange(1, nb)).reshape(GB, -1).astype(np.int32)
    else:
        shape = (GB, GCAP, GHKV * GD) if cat else (GB, GHKV, GCAP, GD)
    for n in ("kc", "vc"):
        feed[n] = rng.standard_normal(shape).astype(DTYPES[dt])
    feed["lens"] = lens
    build = _gqa_build(dt, cat and S == 1, paged, rope)
    tm = TModel(build(TBuilder, TDataType), TOptions(optimize=False), device="cpu")
    jm = JModel(build(JBuilder, JDataType), JOptions(optimize=False))
    got = [_np(t) for t in tm.run(dict(feed), ["out", "nkc", "nvc"])]
    want = [np.asarray(a) for a in jm.run(dict(feed), ["out", "nkc", "nvc"])]
    assert got[0].shape == (GB, S, GH * GD)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == DTYPES[dt]
        if dt == "bf16":
            np.testing.assert_array_equal(_bits(g), _bits(w))
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


# --- the builders ------------------------------------------------------------------

GPT2_SMALL = dict(vocab_size=512, n_positions=128, n_embd=128, n_layer=2, n_head=2)
LLAMA_SMALL = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
                   num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                   max_position_embeddings=128)
# D 128, group 2, Qwen2's biases and tied embeddings.
LLAMA_D128 = dict(LLAMA_SMALL, hidden_size=512, attention_bias=True, tie_word_embeddings=True)
SLOTS, CAP, BUCKET, PBS = 3, 64, 8, 16
BF16_KV = dict(kv_quant=False, kv_dtype="BFloat16")
# name: (family, config, builder options)
FORMS = {
    "gpt2_bf16_cat": ("gpt2", GPT2_SMALL, dict(BF16_KV, kernel_append=True)),
    "gpt2_f32_cat": ("gpt2", GPT2_SMALL, dict(kv_quant=False, kernel_append=True)),
    "gpt2_bf16_head_major": ("gpt2", GPT2_SMALL, BF16_KV),
    "gpt2_s8_head_major": ("gpt2", GPT2_SMALL, dict(kv_quant=True)),
    "llama_bf16_cat": ("llama", LLAMA_SMALL, dict(BF16_KV, kernel_append=True)),
    "llama_d128_bf16_cat": ("llama", LLAMA_D128, dict(BF16_KV, kernel_append=True)),
    "llama_f32_cat": ("llama", LLAMA_SMALL, dict(kv_quant=False, kernel_append=True)),
    "llama_bf16_head_major": ("llama", LLAMA_SMALL, BF16_KV),
}


def _weights(family, cfg):
    """Seeded weights, sharpened so that greedy tokens depend on the
    context: GPT-2's attention and MLP x10 (at its initialization scale the
    tied lm_head mostly repeats the input), Llama's projections x2 (see
    tests/test_torch_llama.py: a per-tensor activation flip at a near tie
    would otherwise decide tokens)."""
    if family == "gpt2":
        w = tgpt2.random_weights(tgpt2.GPT2Config(**cfg), seed=0)
        return {k: v * np.float32(10.0) if (".attn." in k or ".mlp." in k) else v
                for k, v in w.items()}
    w = tllama.random_weights(tllama.LlamaConfig(**cfg), seed=0)
    return {k: v * np.float32(2.0) if "_proj." in k else v for k, v in w.items()}


def _graphs(form, paged_blocks=0, quantize=True):
    family, cfg, opts = FORMS[form]
    kw = dict(capacity=CAP, gather_last=True, **opts)
    if paged_blocks:
        kw.update(paged_blocks=paged_blocks, block_size=PBS)
    w = _weights(family, cfg)
    tkw = {k: TDataType[v] if k == "kv_dtype" else v for k, v in kw.items()}
    jkw = {k: JDataType[v] if k == "kv_dtype" else v for k, v in kw.items()}
    if family == "gpt2":
        tg = tgpt2.build_graph_static_cache(tgpt2.GPT2Config(**cfg), w, **tkw)
        jg = jgpt2.build_graph_static_cache(jgpt2.GPT2Config(**cfg), w, **jkw)
    else:
        tg = tllama.build_graph_static_cache(tllama.LlamaConfig(**cfg), w, **tkw)
        jg = jllama.build_graph_static_cache(jllama.LlamaConfig(**cfg), w, **jkw)
    if quantize:
        tquantize(tg)
        jquantize(jg)
    return tg, jg


def _constants(g):
    return {nid: (node.name, np.asarray(node.array)) for nid, node in g.nodes.items()
            if type(node).__name__ == "Constant"}


@pytest.mark.parametrize("paged_blocks", [0, 10])
@pytest.mark.parametrize("form", list(FORMS))
def test_builder_matches_jax(form, paged_blocks):
    """Every new builder option, flat and paged: the same operators with the
    same ids, attributes, inputs and outputs, the same graph inputs by name,
    dtype and shape (the caches' and pools' declared dtype), and every
    constant equal by name and value (Qwen2's biases and the tied lm_head
    at D 128 included)."""
    tg, jg = _graphs(form, paged_blocks, quantize=False)
    assert tg.input_ids == jg.input_ids and tg.output_ids == jg.output_ids
    assert len(list(tg.operators())) == len(list(jg.operators()))
    for (tid, top), (jid, jop) in zip(tg.operators(), jg.operators()):
        assert (tid, top.op_type, top.attrs, top.inputs, top.outputs) == \
            (jid, jop.op_type, jop.attrs, jop.inputs, jop.outputs)
    for nid in tg.input_ids:
        t, j = tg.nodes[nid], jg.nodes[nid]
        assert (t.name, t.dtype.name, tuple(t.shape)) == (j.name, j.dtype.name, tuple(j.shape))
    tc, jc = _constants(tg), _constants(jg)
    assert tc.keys() == jc.keys()
    for nid in tc:
        assert tc[nid][0] == jc[nid][0]
        np.testing.assert_array_equal(tc[nid][1], jc[nid][1], err_msg=str(tc[nid][0]))
    names = {tg.node_name(n) for n in tg.input_ids}
    kv = tg.nodes[tg.find_node("past_key_values.0.key")]
    assert kv.dtype.name == ("Int8" if "s8" in form else
                             "BFloat16" if "bf16" in form else "Float")
    assert ("past_key_values.0.key_scale" in names) == ("s8" in form)
    if form == "llama_d128_bf16_cat":
        assert "model.layers.0.self_attn.k_proj.bias" in {n for n, _ in tc.values()}
        assert "lm_head.weight.T" not in {n for n, _ in tc.values()}


# --- the engine: token-exact against the JAX engine --------------------------------


def _serve(cls, model, form, k, requests):
    family, cfg, _ = FORMS[form]
    n_head = cfg["n_head"] if family == "gpt2" else cfg["num_attention_heads"]
    head_dim = (cfg["n_embd"] // n_head if family == "gpt2"
                else cfg["hidden_size"] // n_head)
    eng = cls(model, n_layer=2, n_head=n_head, head_dim=head_dim, slots=SLOTS, capacity=CAP,
              prefill_bucket=BUCKET, greedy_on_device=True, steps_per_dispatch=k)
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in requests]
    eng.run()
    return eng, reqs


ENGINE_CASES = [
    # (form, paged_blocks): 4 blocks of 16 rows are 3 usable, for requests
    # of 1 or 2 blocks, so admissions wait for blocks.
    ("gpt2_bf16_cat", 0), ("gpt2_bf16_cat", 4), ("gpt2_f32_cat", 0),
    ("llama_bf16_cat", 0), ("llama_d128_bf16_cat", 0), ("llama_f32_cat", 0),
    ("llama_bf16_head_major", 0), ("llama_bf16_head_major", 4),
]


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("form,paged_blocks", ENGINE_CASES)
def test_engine_token_exact(form, paged_blocks, k):
    """5 requests on 3 slots (prompts of 3 to 11 tokens, two re-admissions),
    steps_per_dispatch k, through builder, quantize_dynamic, Model and the
    engine: every request's tokens equal the JAX engine's, in the same order
    of completion, with the same number of steps; the tokens depend on the
    context; a paged engine ends with every block but 0 free."""
    tg, jg = _graphs(form, paged_blocks)
    tm, jm = TModel(tg, device="cpu"), JModel(jg, JOptions(optimize=True))
    rng = np.random.default_rng(2)
    requests = [(rng.integers(0, 512, int(rng.integers(3, 12))).tolist(),
                 int(rng.integers(3, 14))) for _ in range(5)]
    teng, treqs = _serve(TEngine, tm, form, k, requests)
    jeng, jreqs = _serve(JEngine, jm, form, k, requests)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert [r.request_id for r in teng.finished] == [r.request_id for r in jeng.finished]
    assert all(r.done and len(r.generated) == r.max_new_tokens for r in treqs)
    assert teng.steps == jeng.steps
    assert len({t for r in treqs for t in r.generated}) > len(treqs)
    assert teng.caches[0].dtype == (torch.bfloat16 if "bf16" in form else torch.float32)
    if paged_blocks:
        assert teng.paged and sorted(teng._free_blocks) == list(range(1, teng.n_blocks))
        assert not teng.block_table.any()
