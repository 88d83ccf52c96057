"""int4 KV caches in the port against the JAX package: the nibble packing,
decode_mha's plain version on u8 caches (against the XLA fallback and the
interpreted Pallas kernel), QuantizedKVAttention with ``bits=4``, the
builders' ``kv_bits=4`` graphs and the engine token for token.

Sizes: GPT-2 2 layers, E 128, H 2, D 64, vocab 512, slots 3, cap 64; Llama
4 over 2 heads at D 64 (E 256) and D 128 (E 512). Inputs are numpy from a
seed, handed to both packages. Tolerances are the reference's own
(tests/test_kernel_append.py:64-80): packed bytes bit-exact, atol 1e-5
against the XLA fallback, rtol 2e-2 / atol 5e-3 against the interpreted
kernel (its dots run in bf16; cap 128, which it needs).
"""

import jax
import jax.numpy as jnp
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

B, HQ, HKV, D, CAP = 3, 4, 2, 64, 64


def _rows_with_ties(rng, n, d):
    """Random rows, and rows whose scale is exactly 1 (absmax 7) holding
    x / scale at .5 ties, which round half to even."""
    x = rng.standard_normal((n, d)).astype(np.float32) * rng.uniform(0.01, 10, (n, 1)).astype(
        np.float32)
    ties = np.tile(np.array([7.0, 0.5, 1.5, -2.5, 3.5, -0.5, 6.5, -6.5], np.float32),
                   d // 8)[:d]
    x[:4] = ties * np.array([1, 1, -1, 1], np.float32)[:, None]
    x[4] = 0.0  # an all-zero row: the scale floor 1e-8
    return x


@pytest.mark.parametrize("d", [64, 128, 80])
def test_pack_int4_matches_jax(d):
    """The packed bytes equal the JAX package's pack_int4 bit for bit, eager
    and under jit; the scales equal the jitted form's (XLA compiles absmax /
    7.0 as a multiply by the f32 reciprocal there, the serving path's
    arithmetic); unpack_int4 inverts the packing as the reference's does."""
    x = _rows_with_ties(np.random.default_rng(d), 256, d)
    got_q, got_s = tfa.pack_int4(torch.from_numpy(x))
    eager_q, _ = jfa.pack_int4(jnp.asarray(x))
    jit_q, jit_s = jax.jit(jfa.pack_int4)(jnp.asarray(x))
    assert got_q.dtype == torch.uint8 and got_q.shape == (256, d // 2)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(eager_q))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(jit_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(jit_s))
    # The ties rounded half to even: 0.5 -> 0, 1.5 -> 2, -2.5 -> -2.
    codes = tfa.unpack_int4(got_q)
    np.testing.assert_array_equal(codes[0, 1:4].numpy(), [0, 2, -2])
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jfa.unpack_int4(jit_q)))
    with pytest.raises(ValueError, match="even"):
        tfa.pack_int4(torch.zeros(2, 7))


def _int4_inputs(rng, S, cap=CAP, d=D):
    q = rng.standard_normal((B, HQ, S, d)).astype(np.float32)
    k = rng.standard_normal((B, HKV, cap, d)).astype(np.float32)
    v = rng.standard_normal((B, HKV, cap, d)).astype(np.float32)
    kq, ks = jfa.pack_int4(jnp.asarray(k))
    vq, vs = jfa.pack_int4(jnp.asarray(v))
    return q, np.asarray(kq), np.asarray(vq), np.asarray(ks)[..., 0], np.asarray(vs)[..., 0]


@pytest.mark.parametrize("S,window", [(1, 0), (1, 9), (4, 0), (9, 5)])
def test_decode_mha_plain_int4_matches_jax(S, window):
    """decode_mha on u8 caches (the fold's and the per-head form's plain
    version) against decode_mha_xla: atol 1e-5; lens cover an empty cache,
    a clamped chunk and a slot past cap."""
    q, kq, vq, ks, vs = _int4_inputs(np.random.default_rng(S + window), S)
    lens = np.array([0, CAP - S, CAP + 3], np.int32)
    got = tfa.decode_mha(*(torch.from_numpy(a) for a in (q, kq, vq, lens, ks, vs)),
                         window=window).numpy()
    want = np.asarray(jfa.decode_mha_xla(*(jnp.asarray(a) for a in (q, kq, vq, lens, ks, vs)),
                                         window=window))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("S", [1, 9])
def test_decode_mha_plain_int4_matches_pallas_interpret(S):
    """Against the interpreted Pallas kernel (the int4 NT fold at S 1, the
    per-head grid at S 9), cap 128: rtol 2e-2, atol 5e-3, q on the bf16
    grid."""
    cap = 128
    q, kq, vq, ks, vs = _int4_inputs(np.random.default_rng(7 + S), S, cap)
    q = np.asarray(jnp.asarray(q).astype(jnp.bfloat16).astype(jnp.float32))
    lens = np.array([0, 50, cap - S], np.int32)
    got = tfa.decode_mha(*(torch.from_numpy(a) for a in (q, kq, vq, lens, ks, vs))).numpy()
    want = np.asarray(jfa.decode_mha(*(jnp.asarray(a) for a in (q, kq, vq, lens, ks, vs)),
                                     interpret=True))
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=5e-3)


def _int4_op_build(kernel_append=False):
    def build(GB, DT):
        b = GB()
        q, k, v = (b.input(n, DT.Float) for n in ("q", "k", "v"))
        kc, ks = b.input("kc", DT.UInt8), b.input("ks", DT.Float)
        vc, vs = b.input("vc", DT.UInt8), b.input("vs", DT.Float)
        attrs = {"num_heads": HQ, "kv_num_heads": HKV, "bits": 4}
        if kernel_append:
            attrs["rten_kernel_append"] = 1
        outs = b.op("QuantizedKVAttention", [q, k, v, kc, ks, vc, vs, b.input("lens", DT.Int32)],
                    attrs, n_outputs=5, output_names=["out", "nkc", "nks", "nvc", "nvs"])
        b.output(*outs)
        return b.finish()

    return build


@pytest.mark.parametrize("S,lens", [(1, [0, 31, CAP + 2]), (8, [0, 20, CAP - 3])])
def test_quantized_kv_attention_int4_matches_jax(S, lens):
    """QuantizedKVAttention with bits=4 on head-major u8 caches: the rows
    packed (bit-exact), written at each slot's clamped start, the scales
    bit-exact, attention atol 1e-5."""
    rng = np.random.default_rng(S)
    feed = {n: rng.standard_normal((B, S, h * D)).astype(np.float32)
            for n, h in (("q", HQ), ("k", HKV), ("v", HKV))}
    feed.update(kc=rng.integers(0, 256, (B, HKV, CAP, D // 2)).astype(np.uint8),
                vc=rng.integers(0, 256, (B, HKV, CAP, D // 2)).astype(np.uint8),
                ks=rng.uniform(0.05, 0.3, (B, HKV, CAP, 1)).astype(np.float32),
                vs=rng.uniform(0.05, 0.3, (B, HKV, CAP, 1)).astype(np.float32),
                lens=np.asarray(lens, np.int32))
    names = ["out", "nkc", "nks", "nvc", "nvs"]
    build = _int4_op_build()
    tm = TModel(build(TBuilder, TDataType), TOptions(optimize=False), device="cpu")
    jm = JModel(build(JBuilder, JDataType), JOptions(optimize=False))
    got = [t.numpy() for t in tm.run(dict(feed), names)]
    want = [np.asarray(a) for a in jm.run(dict(feed), names)]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    for i in (1, 2, 3, 4):
        np.testing.assert_array_equal(got[i], want[i])


def test_int4_kernel_append_is_refused():
    """The in-kernel append takes 8 bits only: bits=4 raises the reference's
    OpError."""
    from rten_tpu_torch.ops.registry import OpError

    rng = np.random.default_rng(0)
    feed = {n: rng.standard_normal((B, 1, h * D)).astype(np.float32)
            for n, h in (("q", HQ), ("k", HKV), ("v", HKV))}
    feed.update(kc=np.zeros((B, HKV, CAP, D // 2), np.uint8),
                vc=np.zeros((B, HKV, CAP, D // 2), np.uint8),
                ks=np.ones((B, HKV, CAP, 1), np.float32), vs=np.ones((B, HKV, CAP, 1), np.float32),
                lens=np.zeros(B, np.int32))
    tm = TModel(_int4_op_build(True)(TBuilder, TDataType), TOptions(optimize=False),
                device="cpu")
    with pytest.raises(OpError, match="rten_kernel_append supports bits=8 only"):
        tm.run(feed, ["out"])


# --- the builders and the engine ------------------------------------------------

GPT2_SMALL = dict(vocab_size=512, n_positions=128, n_embd=128, n_layer=2, n_head=2)
LLAMA_SMALL = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
                   num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                   max_position_embeddings=128)
LLAMA_D128 = dict(LLAMA_SMALL, hidden_size=512)
INT4 = dict(kv_quant=True, kv_bits=4)
FORMS = {
    "gpt2": ("gpt2", GPT2_SMALL),
    "llama": ("llama", LLAMA_SMALL),
    "llama_d128": ("llama", LLAMA_D128),
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


def _dims(form):
    """(query heads, head dim) of a form's config."""
    cfg = FORMS[form][1]
    n_head = cfg.get("n_head", cfg.get("num_attention_heads"))
    return n_head, cfg.get("n_embd", cfg.get("hidden_size")) // n_head


def _graphs(form, **opts):
    family, cfg = FORMS[form]
    w = _weights(family, cfg)
    kw = dict(capacity=CAP, gather_last=True, **INT4, **opts)
    if family == "gpt2":
        return (tgpt2.build_graph_static_cache(tgpt2.GPT2Config(**cfg), w, **kw),
                jgpt2.build_graph_static_cache(jgpt2.GPT2Config(**cfg), w, **kw))
    return (tllama.build_graph_static_cache(tllama.LlamaConfig(**cfg), w, **kw),
            jllama.build_graph_static_cache(jllama.LlamaConfig(**cfg), w, **kw))


@pytest.mark.parametrize("form", list(FORMS))
def test_builder_int4_matches_jax(form):
    """kv_bits=4: the same operators, inputs (u8 caches at D/2 lanes) and
    outputs with the same ids as the JAX builder's."""
    tg, jg = _graphs(form)
    assert tg.input_ids == jg.input_ids and tg.output_ids == jg.output_ids
    for (tid, top), (jid, jop) in zip(tg.operators(), jg.operators()):
        assert (tid, top.op_type, top.attrs, top.inputs, top.outputs) == \
            (jid, jop.op_type, jop.attrs, jop.inputs, jop.outputs)
    for nid in tg.input_ids:
        t, j = tg.nodes[nid], jg.nodes[nid]
        assert (t.name, t.dtype.name, tuple(t.shape)) == (j.name, j.dtype.name, tuple(j.shape))
    kv = tg.nodes[tg.find_node("past_key_values.0.key")]
    assert kv.dtype.name == "UInt8" and kv.shape[-1] == _dims(form)[1] // 2


@pytest.mark.parametrize("form", ["gpt2", "llama"])
def test_builder_int4_refusals_match_jax(form):
    """int4 with kernel_append or paged_blocks raises the reference's
    ValueError, with its wording."""
    family, cfg = FORMS[form]
    jbuild, jcfg = ((jgpt2.build_graph_static_cache, jgpt2.GPT2Config) if family == "gpt2"
                    else (jllama.build_graph_static_cache, jllama.LlamaConfig))
    for opts, match in ((dict(kernel_append=True), "kernel_append"),
                        (dict(paged_blocks=8, block_size=16), "paged_blocks")):
        with pytest.raises(ValueError, match=match) as te:
            _graphs(form, **opts)
        with pytest.raises(ValueError) as je:
            jbuild(jcfg(**cfg), _weights(family, cfg), capacity=CAP, gather_last=True,
                   **INT4, **opts)
        assert str(te.value) == str(je.value)


def _serve(cls, model, n_head, head_dim, k, requests):
    eng = cls(model, n_layer=2, n_head=n_head, head_dim=head_dim, slots=3, capacity=CAP,
              prefill_bucket=8, greedy_on_device=True, steps_per_dispatch=k)
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in requests]
    eng.run()
    return [r.generated for r in reqs]


@pytest.mark.parametrize("form,k", [("gpt2", 1), ("gpt2", 4), ("llama", 4), ("llama_d128", 4)])
def test_engine_int4_token_exact(form, k):
    """Greedy serving on int4 head-major caches (int8 weights) gives the JAX
    engine's tokens: 5 seeded requests on 3 slots, so admissions wait."""
    n_head, head_dim = _dims(form)
    rng = np.random.default_rng(2)
    requests = [(rng.integers(0, 512, int(rng.integers(3, 12))).tolist(),
                 int(rng.integers(3, 14))) for _ in range(5)]
    tg, jg = _graphs(form)
    tquantize(tg)
    jquantize(jg)
    got = _serve(TEngine, TModel(tg, device="cpu"), n_head, head_dim, k, requests)
    want = _serve(JEngine, JModel(jg, JOptions()), n_head, head_dim, k, requests)
    assert got == want
    assert len({t for g in got for t in g}) > len(got)  # tokens follow the context
