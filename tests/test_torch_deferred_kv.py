"""Deferred KV (recent windows committed once per dispatch) and the
head-major in-kernel append in the port against the JAX package:
decode_mha's plain version with a recent window, decode_attention_deferred,
decode_mha_append, the deferred and kernel-append branches of
GroupQueryAttention and QuantizedKVAttention on single-op graphs, the
builders' deferred graphs and the engine token for token.

Sizes: GPT-2 2 layers, E 128, H 2, D 64, vocab 512, slots 3, cap 64; Llama
4 over 2 heads, D 64. Inputs are numpy from a seed, handed to both
packages; bf16 arrays are ``ml_dtypes``' bfloat16, compared bit for bit as
int16. Tolerances are the reference's own (tests/test_kernel_append.py:64-80):
atol 1e-5 against the XLA fallbacks, rtol 2e-2 / atol 5e-3 against the
interpreted kernels (their dots run in bf16; cap 128, which they need),
cache rows and windows bit-exact, s8 scales rtol 5e-6, rows the kernels do
not own unchanged.
"""

import json
import os
import subprocess
import sys

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
from rten_tpu_torch.ops.registry import OpError
from rten_tpu_torch.quantize_pass import quantize_dynamic as tquantize
from rten_tpu_torch.serving import ContinuousBatchingEngine as TEngine

BF16 = np.dtype(ml_dtypes.bfloat16)
WDT = {"f32": np.dtype(np.float32), "bf16": BF16}
B, HQ, HKV, D, CAP, W = 3, 4, 2, 64, 64, 8


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
    return a.view(np.int16) if a.dtype == BF16 else a


def _caches(rng, kv, cap=CAP, d=D):
    """(k, v, k_scale, v_scale) of a cache kind as numpy: s8, int4 (u8
    nibbles), f32 or bf16."""
    if kv == "int4":
        kq, ks = jfa.pack_int4(jnp.asarray(rng.standard_normal((B, HKV, cap, d)), jnp.float32))
        vq, vs = jfa.pack_int4(jnp.asarray(rng.standard_normal((B, HKV, cap, d)), jnp.float32))
        return (np.asarray(kq), np.asarray(vq), np.asarray(ks)[..., 0], np.asarray(vs)[..., 0])
    if kv == "s8":
        return (rng.integers(-127, 128, (B, HKV, cap, d)).astype(np.int8),
                rng.integers(-127, 128, (B, HKV, cap, d)).astype(np.int8),
                rng.uniform(0.005, 0.02, (B, HKV, cap)).astype(np.float32),
                rng.uniform(0.005, 0.02, (B, HKV, cap)).astype(np.float32))
    dt = WDT[kv]
    return (rng.standard_normal((B, HKV, cap, d)).astype(dt),
            rng.standard_normal((B, HKV, cap, d)).astype(dt), None, None)


def _window_inputs(rng, rdt, d=D):
    return (rng.standard_normal((B, HKV, W, d)).astype(WDT[rdt]),
            rng.standard_normal((B, HKV, W, d)).astype(WDT[rdt]),
            rng.standard_normal((B, HKV, 1, d)).astype(np.float32),
            rng.standard_normal((B, HKV, 1, d)).astype(np.float32))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _tt(a):
    return None if a is None else _t(a)


@pytest.mark.parametrize("kv", ["s8", "int4", "f32", "bf16"])
@pytest.mark.parametrize("rdt", ["f32", "bf16"])
@pytest.mark.parametrize("t", [0, 5])
def test_decode_attention_deferred_matches_jax(kv, rdt, t):
    """decode_attention_deferred's plain version against the JAX package's
    (use_flash=False: the window's dus write, then decode_mha_xla over the
    cache strictly below lens0 and the window rows <= t): out atol 1e-5,
    both windows bit-exact."""
    rng = np.random.default_rng(len(kv) + 3 * t)
    q = rng.standard_normal((B, HQ, 1, D)).astype(np.float32)
    k, v, ks, vs = _caches(rng, kv)
    rk, rv, kn, vn = _window_inputs(rng, rdt)
    lens0 = np.array([0, 17, CAP - W], np.int32)
    got = tfa.decode_attention_deferred(
        _t(q), _t(k), _t(v), _t(lens0), _tt(ks), _tt(vs), recent_k=_t(rk.copy()),
        recent_v=_t(rv.copy()), t=torch.tensor([t], dtype=torch.int32), k_new=_t(kn),
        v_new=_t(vn))
    want = jfa.decode_attention_deferred(
        *(jnp.asarray(a) for a in (q, k, v, lens0)), _j(ks), _j(vs), recent_k=jnp.asarray(rk),
        recent_v=jnp.asarray(rv), t=jnp.int32(t), k_new=jnp.asarray(kn), v_new=jnp.asarray(vn),
        use_flash=False)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(_bits(_np(g)), _bits(np.asarray(w)))


@pytest.mark.parametrize("kv", ["int4"])
def test_decode_mha_plain_with_window_matches_pallas_interpret(kv):
    """decode_mha with a recent window (the deferred fold) against the
    interpreted Pallas fold with its in-kernel append (the reference's
    aligned route: D 128, an f32 window), cap 128: rtol 2e-2, atol 5e-3,
    the windows bit-exact."""
    cap, d, t = 128, 128, 3
    rng = np.random.default_rng(11)
    q = np.asarray(jnp.asarray(rng.standard_normal((B, HQ, 1, d)), jnp.float32)
                   .astype(jnp.bfloat16).astype(jnp.float32))
    k, v, ks, vs = _caches(rng, kv, cap, d)
    rk, rv, kn, vn = _window_inputs(rng, "f32", d)
    lens0 = np.array([0, 60, cap - W], np.int32)
    got = tfa.decode_attention_deferred(
        _t(q), _t(k), _t(v), _t(lens0), _tt(ks), _tt(vs), recent_k=_t(rk.copy()),
        recent_v=_t(rv.copy()), t=t, k_new=_t(kn), v_new=_t(vn))
    want = jfa.decode_attention_deferred(
        *(jnp.asarray(a) for a in (q, k, v, lens0)), _j(ks), _j(vs), recent_k=jnp.asarray(rk),
        recent_v=jnp.asarray(rv), t=jnp.int32(t), k_new=jnp.asarray(kn), v_new=jnp.asarray(vn),
        interpret=True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=2e-2, atol=5e-3)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_decode_mha_refuses_what_the_reference_refuses():
    """A sliding window with a recent window, and int4 caches at S > 1 with
    a recent window, raise the reference's NotImplementedError."""
    rng = np.random.default_rng(0)
    rk, rv, _, _ = _window_inputs(rng, "f32")
    for kv, S, window, match in (("s8", 1, 4, "sliding window"),
                                 ("int4", 2, 0, "int4 KV with S>1")):
        k, v, ks, vs = _caches(rng, kv)
        q = rng.standard_normal((B, HQ, S, D)).astype(np.float32)
        args = (_t(q), _t(k), _t(v), torch.zeros(B, dtype=torch.int32), _t(ks), _t(vs))
        with pytest.raises(NotImplementedError, match=match):
            tfa.decode_mha(*args, window=window, recent_k=_t(rk), recent_v=_t(rv), t=0)
        with pytest.raises(NotImplementedError, match=match):
            jfa.decode_mha(*(jnp.asarray(a.numpy()) for a in args), window=window,
                           recent_k=jnp.asarray(rk), recent_v=jnp.asarray(rv), t=0,
                           interpret=True)


# --- decode_mha_append (kernel row 7) ---------------------------------------------


def _append_inputs(rng, kv, cap=CAP, d=D):
    q = rng.standard_normal((B, HQ, 1, d)).astype(np.float32)
    kn = rng.standard_normal((B, HKV, 1, d)).astype(np.float32)
    kn[0, 0, 0, :4] = [0.5, 1.5, -2.5, 127.0]  # .5 ties
    vn = rng.standard_normal((B, HKV, 1, d)).astype(np.float32)
    k, v, ks, vs = _caches(rng, kv, cap, d)
    if ks is not None:
        ks, vs = ks[..., None], vs[..., None]  # the graph's [B, Hkv, cap, 1]
    return q, k, v, ks, vs, kn, vn


@pytest.mark.parametrize("kv", ["s8", "f32", "bf16"])
@pytest.mark.parametrize("lens,window", [([0, 31, CAP - 1], 0), ([5, CAP, CAP + 7], 0),
                                         ([3, 40, CAP - 1], 16)])
def test_decode_mha_append_matches_jax(kv, lens, window):
    """decode_mha_append's plain version against decode_attention_append
    (use_flash=False): s8 rows bit-exact and scales rtol 5e-6, f32/bf16 rows
    bit-exact, rows other than min(lens, cap - 1) unchanged, out atol 1e-5."""
    rng = np.random.default_rng(len(kv) + lens[1] + window)
    q, k, v, ks, vs, kn, vn = _append_inputs(rng, kv)
    lens = np.asarray(lens, np.int32)
    got = tfa.decode_mha_append(_t(q), _t(k.copy()), _t(v.copy()), _t(lens), _tt(ks),
                                _tt(vs), k_new=_t(kn), v_new=_t(vn), window=window)
    want = jfa.decode_attention_append(
        *(jnp.asarray(a) for a in (q, k, v, lens)), _j(ks), _j(vs), k_new=jnp.asarray(kn),
        v_new=jnp.asarray(vn), window=window, use_flash=False)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-5)
    for i in (1, 2):
        np.testing.assert_array_equal(_bits(_np(got[i])), _bits(np.asarray(want[i])))
    if ks is not None:
        for i in (3, 4):
            np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), rtol=5e-6, atol=0)
    for bb, n in enumerate(lens):
        keep = np.arange(CAP) != min(n, CAP - 1)
        np.testing.assert_array_equal(_bits(_np(got[1]))[bb, :, keep],
                                      _bits(k)[bb, :, keep])


@pytest.mark.parametrize("kv", ["s8", "bf16"])
def test_decode_mha_append_matches_pallas_interpret(kv):
    """Against the interpreted Pallas decode_mha_append, cap 128, lens below
    cap: out rtol 2e-2 / atol 5e-3 (q on the bf16 grid), rows bit-exact,
    scales rtol 5e-6."""
    cap = 128
    rng = np.random.default_rng(5)
    q, k, v, ks, vs, kn, vn = _append_inputs(rng, kv, cap)
    q = np.asarray(jnp.asarray(q).astype(jnp.bfloat16).astype(jnp.float32))
    lens = np.array([0, 70, cap - 1], np.int32)
    got = tfa.decode_mha_append(_t(q), _t(k.copy()), _t(v.copy()), _t(lens), _tt(ks),
                                _tt(vs), k_new=_t(kn), v_new=_t(vn))
    want = jfa.decode_mha_append(
        *(jnp.asarray(a) for a in (q, k, v, lens)), _j(ks), _j(vs), k_new=jnp.asarray(kn),
        v_new=jnp.asarray(vn), interpret=True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=2e-2, atol=5e-3)
    for i in (1, 2):
        np.testing.assert_array_equal(_bits(_np(got[i])), _bits(np.asarray(want[i])))
    if ks is not None:
        for i in (3, 4):
            np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), rtol=5e-6, atol=0)


# --- the ops on single-op graphs ---------------------------------------------------


def _op_build(op, kv, *, deferred=False, kernel_append=False, window=0, softcap=0.0,
              rdt="f32"):
    """One GroupQueryAttention (f32/bf16 caches) or QuantizedKVAttention
    (s8 or int4 caches) node on head-major caches, with rotary; with
    ``deferred`` the windows and step_t as inputs and outputs."""

    def build(GB, DT):
        b = GB()
        q, k, v = (b.input(n, DT.Float) for n in ("q", "k", "v"))
        rng = np.random.default_rng(3)
        ang = rng.uniform(0, 3, (96, D // 2)).astype(np.float32)
        cos, sin = b.constant("cos", np.cos(ang)), b.constant("sin", np.sin(ang))
        attrs = {"num_heads": HQ, "kv_num_heads": HKV, "do_rotary": 1}
        if window:
            attrs["local_window_size"] = window
        if softcap:
            attrs["softcap"] = softcap
        if kernel_append:
            attrs["rten_kernel_append"] = 1
        lens = b.input("lens", DT.Int32)
        recent, rnames = [], []
        if deferred:
            rt = DT.BFloat16 if rdt == "bf16" else DT.Float
            recent = [b.input("rk", rt), b.input("rv", rt), b.input("step", DT.Int32)]
            rnames = ["nrk", "nrv"]
            attrs["rten_recent_kv"] = 1
        if op == "GroupQueryAttention":
            ct = DT.BFloat16 if kv == "bf16" else DT.Float
            pk, pv = b.input("kc", ct), b.input("vc", ct)
            outs = b.op(op, [q, k, v, pk, pv, lens, None, cos, sin] + recent,
                        {**attrs, "rten_past_lens": 1}, n_outputs=3 + len(rnames),
                        output_names=["out", "nkc", "nvc"] + rnames)
        else:
            ct = DT.UInt8 if kv == "int4" else DT.Int8
            kc, ks = b.input("kc", ct), b.input("ks", DT.Float)
            vc, vs = b.input("vc", ct), b.input("vs", DT.Float)
            outs = b.op(op, [q, k, v, kc, ks, vc, vs, lens] + recent + [cos, sin],
                        {**attrs, "bits": 4 if kv == "int4" else 8},
                        n_outputs=5 + len(rnames),
                        output_names=["out", "nkc", "nks", "nvc", "nvs"] + rnames)
        b.output(*outs)
        return b.finish()

    return build


def _op_feed(rng, S, kv, lens, deferred=False, rdt="f32", t=0):
    feed = {n: rng.standard_normal((B, S, h * D)).astype(np.float32)
            for n, h in (("q", HQ), ("k", HKV), ("v", HKV))}
    k, v, ks, vs = _caches(rng, kv)
    feed.update(kc=k, vc=v, lens=np.asarray(lens, np.int32))
    if ks is not None:
        feed.update(ks=ks[..., None].copy(), vs=vs[..., None].copy())
    if deferred:
        rk, rv, _, _ = _window_inputs(rng, rdt)
        feed.update(rk=rk, rv=rv, step=np.array([t], np.int32))
    return feed


def _run_both(build, feed, outputs):
    tm = TModel(build(TBuilder, TDataType), TOptions(optimize=False), device="cpu")
    jm = JModel(build(JBuilder, JDataType), JOptions(optimize=False))
    tfeed = {n: _t(a) if a.dtype == BF16 else a for n, a in feed.items()}
    got = [_np(x) for x in tm.run(tfeed, outputs)]
    want = [np.asarray(a) for a in jm.run(dict(feed), outputs)]
    return got, want


def _assert_rows(name, got, want, n_written):
    """Cache, scale and window rows an op wrote, against the JAX op's. The
    rotary rounds differently by an ulp where XLA fuses a multiply-add
    (tests/test_torch_ops.py): f32 rows atol 1e-6, bf16 rows within one bf16
    step, s8 and int4 codes equal but for one step in at most 1 % of the
    ``n_written`` entries, scales rtol 5e-6."""
    if got.dtype == np.int8 or got.dtype == np.uint8:
        if got.dtype == np.uint8:
            got, want = (np.asarray(jfa.unpack_int4(jnp.asarray(a))) for a in (got, want))
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).sum() <= 0.01 * n_written, name
    elif got.dtype == BF16:
        np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32),
                                   rtol=2.0 ** -7, atol=0, err_msg=name)
    elif name in ("nks", "nvs"):
        np.testing.assert_allclose(got, want, rtol=5e-6, atol=0, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=name)


OP_FORMS = [("QuantizedKVAttention", "s8"), ("QuantizedKVAttention", "int4"),
            ("GroupQueryAttention", "f32"), ("GroupQueryAttention", "bf16")]


@pytest.mark.parametrize("op,kv", OP_FORMS)
@pytest.mark.parametrize("S,t", [(1, 0), (1, 5), (8, 0)])
def test_deferred_ops_match_jax(op, kv, S, t):
    """The rten_recent_kv branches: at S 1 the caches pass through and the
    step's rows land in window row t, attention over the cache below
    lens - t and the window; at S 8 the caches take the rows and the
    windows pass through. Out atol 1e-5; rows as ``_assert_rows`` says."""
    rdt = "bf16" if kv in ("int4", "bf16") else "f32"
    rng = np.random.default_rng(S + t + len(kv))
    lens = [t, 20 + t, CAP - S]
    feed = _op_feed(rng, S, kv, lens, deferred=True, rdt=rdt, t=t)
    build = _op_build(op, kv, deferred=True, rdt=rdt)
    names = (["out", "nkc", "nks", "nvc", "nvs", "nrk", "nrv"] if op == "QuantizedKVAttention"
             else ["out", "nkc", "nvc", "nrk", "nrv"])
    got, want = _run_both(build, feed, names)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    for name, g, w in zip(names[1:], got[1:], want[1:]):
        _assert_rows(name, g, w, B * HKV * S * D)
    if S == 1:  # the caches passed through, the windows took one row
        np.testing.assert_array_equal(_bits(got[1]), _bits(feed["kc"]))
        keep = np.arange(W) != t
        np.testing.assert_array_equal(_bits(got[-2])[:, :, keep], _bits(feed["rk"])[:, :, keep])


@pytest.mark.parametrize("op,kv", [("QuantizedKVAttention", "s8"),
                                   ("GroupQueryAttention", "f32"),
                                   ("GroupQueryAttention", "bf16")])
@pytest.mark.parametrize("lens,window", [([0, 31, CAP - 1], 0), ([CAP, 9, 40], 12)])
def test_kernel_append_ops_on_head_major_caches(op, kv, lens, window):
    """rten_kernel_append on head-major caches (no builder emits it):
    decode_mha_append writes the rows and attends; against the JAX op
    (decode_attention_append's fallback). Out atol 1e-5, rows as
    ``_assert_rows`` says."""
    rng = np.random.default_rng(lens[1] + window)
    feed = _op_feed(rng, 1, kv, lens)
    build = _op_build(op, kv, kernel_append=True, window=window)
    names = (["out", "nkc", "nks", "nvc", "nvs"] if op == "QuantizedKVAttention"
             else ["out", "nkc", "nvc"])
    got, want = _run_both(build, feed, names)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    for name, g, w in zip(names[1:], got[1:], want[1:]):
        _assert_rows(name, g, w, B * HKV * D)


@pytest.mark.parametrize("op,kv,kw,match", [
    ("GroupQueryAttention", "f32", dict(window=8), "local_window_size with deferred KV"),
    ("GroupQueryAttention", "f32", dict(softcap=30.0), "does not support softcap"),
    ("QuantizedKVAttention", "s8", dict(window=8), "local_window_size with deferred KV"),
])
def test_deferred_ops_refuse_what_the_reference_refuses(op, kv, kw, match):
    """A local window or softcap with deferred KV raises the reference's
    OpError, with its wording."""
    feed = _op_feed(np.random.default_rng(0), 1, kv, [1, 2, 3], deferred=True)
    build = _op_build(op, kv, deferred=True, **kw)
    tm = TModel(build(TBuilder, TDataType), TOptions(optimize=False), device="cpu")
    jm = JModel(build(JBuilder, JDataType), JOptions(optimize=False))
    with pytest.raises(OpError, match=match) as te:
        tm.run(dict(feed), ["out"])
    with pytest.raises(Exception, match=match) as je:
        jm.run(dict(feed), ["out"])
    assert str(te.value).split(": ", 1)[-1] == str(je.value).split(": ", 1)[-1]


# --- the builders and the engine ------------------------------------------------

GPT2_SMALL = dict(vocab_size=512, n_positions=128, n_embd=128, n_layer=2, n_head=2)
LLAMA_SMALL = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
                   num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                   max_position_embeddings=128)
# name: (family, config, builder options; dtypes by name)
FORMS = {
    "gpt2_int4": ("gpt2", GPT2_SMALL, dict(kv_quant=True, kv_bits=4, deferred_kv=True)),
    "gpt2_int4_bf16": ("gpt2", GPT2_SMALL, dict(kv_quant=True, kv_bits=4, deferred_kv=True,
                                                recent_dtype="BFloat16")),
    "gpt2_s8": ("gpt2", GPT2_SMALL, dict(kv_quant=True, deferred_kv=True)),
    "gpt2_f32": ("gpt2", GPT2_SMALL, dict(kv_quant=False, deferred_kv=True)),
    "llama_f32": ("llama", LLAMA_SMALL, dict(kv_quant=False, deferred_kv=True)),
    "llama_bf16": ("llama", LLAMA_SMALL, dict(kv_quant=False, kv_dtype="BFloat16",
                                              deferred_kv=True, recent_dtype="BFloat16")),
    "llama_int4": ("llama", LLAMA_SMALL, dict(kv_quant=True, kv_bits=4, deferred_kv=True)),
}


def _weights(family, cfg):
    """Seeded weights, sharpened so that greedy tokens follow the context
    (GPT-2's attention and MLP x10, Llama's projections x2)."""
    if family == "gpt2":
        w = tgpt2.random_weights(tgpt2.GPT2Config(**cfg), seed=0)
        return {k: v * np.float32(10.0) if (".attn." in k or ".mlp." in k) else v
                for k, v in w.items()}
    w = tllama.random_weights(tllama.LlamaConfig(**cfg), seed=0)
    return {k: v * np.float32(2.0) if "_proj." in k else v for k, v in w.items()}


def _graphs(form, **extra):
    family, cfg, opts = FORMS[form]
    w = _weights(family, cfg)
    kw = dict(capacity=CAP, gather_last=True, **opts, **extra)
    tkw = {k: TDataType[v] if k.endswith("dtype") else v for k, v in kw.items()}
    jkw = {k: JDataType[v] if k.endswith("dtype") else v for k, v in kw.items()}
    if family == "gpt2":
        return (tgpt2.build_graph_static_cache(tgpt2.GPT2Config(**cfg), w, **tkw),
                jgpt2.build_graph_static_cache(jgpt2.GPT2Config(**cfg), w, **jkw))
    return (tllama.build_graph_static_cache(tllama.LlamaConfig(**cfg), w, **tkw),
            jllama.build_graph_static_cache(jllama.LlamaConfig(**cfg), w, **jkw))


@pytest.mark.parametrize("form", list(FORMS))
def test_builder_deferred_matches_jax(form):
    """deferred_kv: the step_t input, the recent.N.* windows (in
    recent_dtype) and their recent_present.N.* outputs, with the same ids,
    attributes, inputs and outputs as the JAX builder's."""
    tg, jg = _graphs(form)
    assert tg.input_ids == jg.input_ids and tg.output_ids == jg.output_ids
    for (tid, top), (jid, jop) in zip(tg.operators(), jg.operators()):
        assert (tid, top.op_type, top.attrs, top.inputs, top.outputs) == \
            (jid, jop.op_type, jop.attrs, jop.inputs, jop.outputs)
    for nid in tg.input_ids:
        t, j = tg.nodes[nid], jg.nodes[nid]
        assert (t.name, t.dtype.name, tuple(t.shape)) == (j.name, j.dtype.name, tuple(j.shape))
    assert tg.find_node("step_t") is not None and tg.find_node("recent_present.1.value")


@pytest.mark.parametrize("form,extra,match", [
    ("gpt2_s8", dict(kernel_append=True), "kernel_append"),
    ("gpt2_f32", dict(paged_blocks=8, block_size=16), "paged_blocks"),
    ("llama_f32", dict(kernel_append=True), "kernel_append"),
    ("llama_int4", dict(paged_blocks=8, block_size=16), "paged_blocks"),
])
def test_builder_deferred_refusals_match_jax(form, extra, match):
    """Deferred KV with kernel_append or paged_blocks raises the reference's
    ValueError, with its wording."""
    family, cfg, opts = FORMS[form]
    with pytest.raises(ValueError, match=match) as te:
        _graphs(form, **extra)
    jbuild, jcfg = ((jgpt2.build_graph_static_cache, jgpt2.GPT2Config) if family == "gpt2"
                    else (jllama.build_graph_static_cache, jllama.LlamaConfig))
    with pytest.raises(ValueError) as je:
        jbuild(jcfg(**cfg), _weights(family, cfg), capacity=CAP, gather_last=True, **opts,
               **extra)
    assert str(te.value) == str(je.value)


def _dims(form):
    cfg = FORMS[form][1]
    n_head = cfg.get("n_head", cfg.get("num_attention_heads"))
    return n_head, cfg.get("n_embd", cfg.get("hidden_size")) // n_head


def _serve(cls, model, form, k, requests, slots=3, eos=None):
    n_head, head_dim = _dims(form)
    eng = cls(model, n_layer=2, n_head=n_head, head_dim=head_dim, slots=slots, capacity=CAP,
              prefill_bucket=8, greedy_on_device=True, steps_per_dispatch=k)
    reqs = [eng.submit(p, max_new_tokens=n, eos_id=eos) for p, n in requests]
    eng.run()
    return [r.generated for r in reqs], eng


def _jax_tokens_in_fresh_process(form, k, requests):
    """The JAX engine's tokens for ``requests`` from a fresh interpreter with
    synchronous CPU dispatch (``jax_cpu_enable_async_dispatch`` off, which
    takes effect only before JAX first runs). The JAX engine's deferred
    single-step path (steps_per_dispatch 1) races with asynchronous dispatch
    on the CPU: in one process its tokens change from run to run, while the
    same engine with synchronous dispatch gives the same tokens every run."""
    here = os.path.dirname(os.path.abspath(__file__))
    code = (
        "import json, sys\n"
        "import jax\n"
        "jax.config.update('jax_cpu_enable_async_dispatch', False)\n"
        f"sys.path[:0] = [{os.path.dirname(here)!r}, {here!r}]\n"
        "import test_torch_deferred_kv as T\n"
        f"_, jg = T._graphs({form!r})\n"
        "T.jquantize(jg)\n"
        f"toks, _ = T._serve(T.JEngine, T.JModel(jg, T.JOptions()), {form!r}, {k}, "
        f"{requests!r})\n"
        "print(json.dumps(toks))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"), timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def _requests(seed=2, n=5):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 512, int(rng.integers(3, 12))).tolist(), int(rng.integers(3, 14)))
            for _ in range(n)]


@pytest.mark.parametrize("form,k", [("gpt2_int4", 1), ("gpt2_int4", 4), ("gpt2_int4_bf16", 4),
                                    ("gpt2_s8", 4), ("llama_f32", 4)])
def test_engine_deferred_token_exact(form, k):
    """Greedy serving on deferred-KV graphs (k-step dispatches with windows,
    the commit per dispatch; k 1: one step committed at once) gives the JAX
    engine's tokens: 5 seeded requests on 3 slots, so admissions wait and
    idle slots commit rows too. At k 1 the JAX engine runs in a fresh
    process with synchronous dispatch (``_jax_tokens_in_fresh_process``)."""
    requests = _requests()
    tg, jg = _graphs(form)
    tquantize(tg)
    jquantize(jg)
    got, eng = _serve(TEngine, TModel(tg, device="cpu"), form, k, requests)
    if k == 1:
        want = _jax_tokens_in_fresh_process(form, k, requests)
    else:
        want, _ = _serve(JEngine, JModel(jg, JOptions()), form, k, requests)
    assert got == want
    assert len({t for g in got for t in g}) > len(got)  # tokens follow the context
    assert eng.deferred_kv and len(eng._recents) == 2 * 2


def test_engine_deferred_eos_mid_dispatch():
    """Requests that stop at an eos in the middle of a dispatch (the JAX
    package's tests/test_serving_deferred_kv.py:158 case, on its config: f32
    deferred KV, 2 slots, 4 steps a dispatch) do not corrupt the later
    ones: the JAX engine's tokens, each request cut at its eos."""
    cfg_d = dict(vocab_size=128, n_positions=128, n_embd=32, n_layer=2, n_head=4)
    w = tgpt2.random_weights(tgpt2.GPT2Config(**cfg_d), seed=7)
    prompts = [[5, 9, 23, 40, 7], [3, 8, 11], [77, 2, 19, 50, 4, 33, 6], [120, 14], [9, 9, 9, 9]]
    out = {}
    for name, mod, M, E, opts in (
            ("jax", jgpt2, lambda g: JModel(g, JOptions()), JEngine, {}),
            ("port", tgpt2, lambda g: TModel(g, device="cpu"), TEngine, {})):
        toks = {}
        for eos in (None, "pick"):
            g = mod.build_graph_static_cache(mod.GPT2Config(**cfg_d), w, capacity=64,
                                             deferred_kv=True, gather_last=True, **opts)
            eng = E(M(g), n_layer=2, n_head=4, head_dim=8, slots=2, capacity=64,
                    prefill_bucket=8, greedy_on_device=True, steps_per_dispatch=4)
            eos_id = toks[None][0][3] if eos else None
            reqs = [eng.submit(p, max_new_tokens=10, eos_id=eos_id) for p in prompts]
            eng.run()
            toks[eos] = [r.generated for r in reqs]
        out[name] = toks
    assert out["port"] == out["jax"]
    eos_id = out["port"][None][0][3]
    for full, cut in zip(out["port"][None], out["port"]["pick"]):
        if eos_id in full[:len(cut)]:
            assert cut == full[:full.index(eos_id) + 1]


def test_engine_deferred_needs_a_prefill_bucket_of_two():
    """A one-token prefill would run as a decode step on a deferred graph:
    the engine refuses prefill_bucket < 2, as the reference does."""
    tg, _ = _graphs("gpt2_s8")
    with pytest.raises(ValueError, match="prefill_bucket"):
        TEngine(TModel(tg, device="cpu"), n_layer=2, n_head=2, head_dim=64, slots=2,
                capacity=CAP, prefill_bucket=1, greedy_on_device=True, steps_per_dispatch=4)
