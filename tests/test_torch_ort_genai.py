"""The ONNX (ORT) form of GroupQueryAttention, RotaryEmbedding(MS) and the
onnxruntime-genai int4 layout (``tests/ort_genai_llama.py``) in the port
against the JAX package, on the CPU.

* GroupQueryAttention, one-node graphs, one case per branch of the JAX
  lowering (``rten_tpu/ops/attention.py:380-715``): packed and separate
  QKV, no past, the past concatenated, a preallocated buffer updated at
  seqlens_k's offset (tail mask with causal), rotary at the past length or
  at position_ids, interleaved rotary, softcap, a local window, an
  attention bias, head sinks, a decode step; seqlens_k fed (the JAX
  package's tracer: the past length is the past's own) and as a constant
  (concrete: read). Also the ``rten_past_lens`` form's explicit-mask branch
  (softcap, bias, sinks, position ids on head-major caches). Outputs and
  presents within 1e-5.
* RotaryEmbedding and RotaryEmbeddingMS: 3-D input with num_heads, 1-D and
  2-D position ids (and none), interleaved and half-split, a partial
  rotary dim, caches given at the full ``rotary_embedding_dim``; 1e-6.
* The genai layout at a small config (2 layers, E 256, 4 query heads over
  2 KV heads, D 64, vocabulary 512, int4 block 32 with zero points), packed
  and separate QKV, exported once and loaded by both packages: the prompt's
  logits within 1e-5 of max|logit| (and of the module's own forward), and
  16 greedy tokens of the port's Generator at bucket 1 equal to the JAX
  Generator's and the module's.
* The default bucket (128): the Generator left-pads the prompt and pads
  the past with zero rows, and the ORT form, which takes no mask, attends
  them and rotates at the padded position. The port gives the JAX
  package's tokens there too, and they part from the module's (ROADMAP.md,
  reference behaviours).
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import ort_genai_llama as og  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401

from rten_tpu.dtypes import DataType as JDataType  # noqa: E402
from rten_tpu.generate import Generator as JGenerator  # noqa: E402
from rten_tpu.generate import GeneratorConfig as JConfig  # noqa: E402
from rten_tpu.ir.builder import GraphBuilder as JBuilder  # noqa: E402
from rten_tpu.model import Model as JModel  # noqa: E402
from rten_tpu.model import ModelOptions as JOptions  # noqa: E402
from rten_tpu_torch.dtypes import DataType as TDataType  # noqa: E402
from rten_tpu_torch.generate import Generator as TGenerator  # noqa: E402
from rten_tpu_torch.generate import GeneratorConfig as TConfig  # noqa: E402
from rten_tpu_torch.ir.builder import GraphBuilder as TBuilder  # noqa: E402
from rten_tpu_torch.model import Model as TModel  # noqa: E402
from rten_tpu_torch.model import ModelOptions as TOptions  # noqa: E402

B, S, HQ, HKV, D, P = 2, 9, 4, 2, 16, 6


def _node(op, slots, attrs, n_out):
    """A one-node graph builder: ``slots`` [(kind, name, array)] with kind
    "in" (a graph input), "const" (a constant) or None (an omitted input)."""

    def build(GB, DT):
        b = GB()
        ins = []
        for kind, name, arr in slots:
            if kind is None:
                ins.append(None)
            elif kind == "const":
                ins.append(b.constant(name, arr))
            else:
                ins.append(b.input(name, DT.Int32 if arr.dtype == np.int32 else DT.Float))
        outs = b.op(op, ins, attrs, n_outputs=n_out,
                    output_names=[f"y{i}" for i in range(n_out)])
        b.output(*(outs if n_out > 1 else (outs,)))
        return b.finish()

    return build


def _run_both(op, slots, attrs, n_out):
    build = _node(op, slots, attrs, n_out)
    feed = {name: arr for kind, name, arr in slots if kind == "in"}
    names = [f"y{i}" for i in range(n_out)]
    got = [t.numpy() for t in TModel(build(TBuilder, TDataType), TOptions(optimize=False),
                                     device="cpu").run(dict(feed), names)]
    want = [np.asarray(a) for a in JModel(build(JBuilder, JDataType),
                                          JOptions(optimize=False)).run(dict(feed), names)]
    return got, want


def _f(*shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _rope(rows=64, half=D // 2):
    ang = np.random.default_rng(5).uniform(0, 6.3, (rows, half))
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _gqa_slots(case, seqlens):
    """The inputs of one ORT-form case; ``seqlens`` "fed" or "const"."""
    q, k, v = _f(B, S, HQ * D, seed=1), _f(B, S, HKV * D, seed=2), _f(B, S, HKV * D, seed=3)
    past = 0 if case in ("no past", "packed, no past") else P
    cap = P + S + 4 if case == "buffer" else past
    pk, pv = _f(B, HKV, cap, D, seed=4), _f(B, HKV, cap, D, seed=6)
    total = past + S
    seq = np.full(B, total - 1, np.int32)
    cos, sin = _rope()
    slots = [("in", "q", q), ("in", "k", k), ("in", "v", v)]
    if case.startswith("packed"):
        slots = [("in", "q", np.concatenate([q, k, v], -1)), (None, "", None), (None, "", None)]
    slots += [("in", "pk", pk), ("in", "pv", pv)] if cap else [(None, "", None)] * 2
    slots.append(("in" if seqlens == "fed" else "const", "seqlens_k", seq))
    slots += [(None, "", None), ("const", "cos", cos), ("const", "sin", sin)]
    extra = {"position ids": [("in", "pos", (np.arange(S) * 2 + 3).astype(np.int32)[None]
                                .repeat(B, 0))],
             "attention bias": [(None, "", None), ("in", "bias", _f(B, 1, S, cap + S, seed=7))],
             "head sinks": [(None, "", None), (None, "", None), ("in", "sink", _f(HQ, seed=8))],
             "sinks and softcap": [(None, "", None), (None, "", None),
                                   ("in", "sink", _f(HQ, seed=8) * 4)]}
    return slots + extra.get(case, [])


GQA_CASES = {  # case -> extra attributes
    "no past": {}, "packed, no past": {}, "packed": {}, "past": {}, "buffer": {},
    "position ids": {}, "interleaved": {"rotary_interleaved": 1}, "softcap": {"softcap": 6.0},
    "window": {"local_window_size": 4}, "attention bias": {}, "head sinks": {},
    "sinks and softcap": {"softcap": 6.0}, "no rotary": {"do_rotary": 0},
}


@pytest.mark.parametrize("seqlens", ["fed", "const"])
@pytest.mark.parametrize("case", list(GQA_CASES))
def test_ort_gqa_matches_jax(case, seqlens):
    attrs = {"num_heads": HQ, "kv_num_heads": HKV, "do_rotary": 1, **GQA_CASES[case]}
    got, want = _run_both("GroupQueryAttention", _gqa_slots(case, seqlens), attrs, 3)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


def test_ort_gqa_reads_a_host_seqlens():
    """seqlens_k as a constant over a longer buffer takes the buffer branch
    (rows written at its offset, the tail masked): the presents keep the
    buffer's length; fed, the past's own length is taken and the rows are
    concatenated after it."""
    attrs = {"num_heads": HQ, "kv_num_heads": HKV, "do_rotary": 1}
    const = _run_both("GroupQueryAttention", _gqa_slots("buffer", "const"), attrs, 3)[0]
    fed = _run_both("GroupQueryAttention", _gqa_slots("buffer", "fed"), attrs, 3)[0]
    cap = P + S + 4
    assert const[1].shape[2] == cap and fed[1].shape[2] == cap + S
    kept = np.r_[0:P, P + S:cap]  # the buffer's rows the new ones do not replace
    np.testing.assert_array_equal(const[1][:, :, kept], _f(B, HKV, cap, D, seed=4)[:, :, kept])


def test_ort_gqa_decode_step_matches_jax():
    """One new row over a past of 12 (Tq 1: mha_plain in the port, as the
    JAX dispatch sends it)."""
    q, k, v = _f(B, 1, HQ * D, seed=11), _f(B, 1, HKV * D, seed=12), _f(B, 1, HKV * D, seed=13)
    cos, sin = _rope()
    slots = [("in", "q", q), ("in", "k", k), ("in", "v", v),
             ("in", "pk", _f(B, HKV, 12, D, seed=14)), ("in", "pv", _f(B, HKV, 12, D, seed=15)),
             ("in", "seqlens_k", np.full(B, 12, np.int32)), (None, "", None),
             ("const", "cos", cos), ("const", "sin", sin)]
    got, want = _run_both("GroupQueryAttention", slots,
                          {"num_heads": HQ, "kv_num_heads": HKV, "do_rotary": 1}, 3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


@pytest.mark.parametrize("extra", ["softcap", "bias", "sinks", "position ids"])
def test_serving_gqa_explicit_mask_matches_jax(extra):
    """The ``rten_past_lens`` form on head-major f32 caches with softcap, an
    attention bias, head sinks or position ids: the rows written at each
    slot's offset, then the explicit-mask attention over the whole cache
    (``attention.py:641-662``); output and caches within 1e-5."""
    cap = 16
    lens = np.array([0, 5], np.int32)
    q, k, v = _f(B, 3, HQ * D, seed=21), _f(B, 3, HKV * D, seed=22), _f(B, 3, HKV * D, seed=23)
    cos, sin = _rope()
    slots = [("in", "q", q), ("in", "k", k), ("in", "v", v),
             ("in", "kc", _f(B, HKV, cap, D, seed=24)), ("in", "vc", _f(B, HKV, cap, D, seed=25)),
             ("in", "lens", lens), (None, "", None), ("const", "cos", cos), ("const", "sin", sin)]
    attrs = {"num_heads": HQ, "kv_num_heads": HKV, "do_rotary": 1, "rten_past_lens": 1}
    if extra == "softcap":
        attrs["softcap"] = 5.0
    elif extra == "bias":
        slots += [(None, "", None), ("in", "bias", _f(B, 1, 3, cap, seed=26))]
    elif extra == "sinks":
        slots += [(None, "", None), (None, "", None), ("in", "sink", _f(HQ, seed=27))]
    else:
        slots += [("in", "pos", np.array([[3, 4, 9], [1, 7, 8]], np.int32))]
    got, want = _run_both("GroupQueryAttention", slots, attrs, 3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


ROT_CASES = [  # x shape, cache half-width, attrs, position ids
    ((B, HQ, S, D), D // 2, {}, "2d"),
    ((B, HQ, S, D), D // 2, {"interleaved": 1}, "1d"),
    ((B, S, HQ * D), D // 4, {"num_heads": HQ}, "2d"),
    ((B, S, HQ * D), D // 2, {"num_heads": HQ, "interleaved": 1}, None),
    ((B, HQ, S, D), D, {"rotary_embedding_dim": D}, "2d"),
    ((B, HQ, S, D), D // 2, {"rotary_embedding_dim": D // 2}, "1d"),
]


@pytest.mark.parametrize("op", ["RotaryEmbedding", "RotaryEmbeddingMS"])
@pytest.mark.parametrize("shape,half,attrs,pos", ROT_CASES)
def test_rotary_embedding_matches_jax(op, shape, half, attrs, pos):
    cos, sin = _rope(40, half)
    slots = [("in", "x", _f(*shape, seed=31)), ("const", "cos", cos), ("const", "sin", sin)]
    if pos == "2d":
        slots.append(("in", "pos", np.random.default_rng(2).integers(0, 40, (B, S))
                      .astype(np.int32)))
    elif pos == "1d":
        slots.append(("in", "pos", (np.arange(S) * 3).astype(np.int32)))
    got, want = _run_both(op, slots, attrs, 1)
    assert got[0].shape == shape
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)


# --- the onnxruntime-genai int4 layout ----------------------------------------


@pytest.fixture(scope="module")
def genai(tmp_path_factory):
    """The small genai export, packed and separate QKV: {packed: (module,
    path)}."""
    d = tmp_path_factory.mktemp("genai")
    out = {}
    for packed in (True, False):
        m = og.GenaiLlama(dataclasses.replace(og.SMALL, packed_qkv=packed), seed=0)
        out[packed] = (m, og.export(m, d / f"genai_{packed}.onnx"))
    return out


PROMPT = np.random.default_rng(1).integers(0, 512, (1, 11))


@pytest.mark.parametrize("packed", [True, False])
def test_genai_export_logits_match_jax(genai, packed):
    """Both packages load the file (the same operators after their
    optimizers); the prompt's logits within 1e-5 of max|logit| of the JAX
    package's and of the module's forward."""
    module, path = genai[packed]
    tm, jm = TModel.load_file(path, device="cpu"), JModel.load_file(path)
    ops = [op.op_type for _, op in tm.graph.operators()]
    assert ops == [op.op_type for _, op in jm.graph.operators()]
    assert ops.count("GroupQueryAttention") == 2 and ops.count("MatMulNBits") == (
        11 if packed else 15)
    feed = {"input_ids": PROMPT, "attention_mask": np.ones_like(PROMPT),
            **{f"past_key_values.{i}.{n}": np.zeros((1, 2, 0, 64), np.float32)
               for i in range(2) for n in ("key", "value")}}
    got = tm.run(dict(feed))[0].numpy()
    want = np.asarray(jm.run(dict(feed))[0])
    with torch.no_grad():
        eager = module(torch.as_tensor(PROMPT), torch.ones(1, 11, dtype=torch.int64),
                       *module.empty_past())[0].numpy()
    for ref in (want, eager):
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("packed", [True, False])
def test_genai_generator_tokens_match_jax_at_bucket_1(genai, packed):
    """16 greedy tokens of the port's Generator at bucket 1 (the exact
    past): the JAX Generator's and the module's own decode loop's."""
    module, path = genai[packed]
    got = TGenerator(TModel.load_file(path, device="cpu"), PROMPT,
                     TConfig(bucket_size=1)).generate(16)
    want = JGenerator(JModel.load_file(path), PROMPT, JConfig(bucket_size=1)).generate(16)
    np.testing.assert_array_equal(got, want)
    assert got[0].tolist() == module.greedy(PROMPT[0], 16)[0]
    assert len(set(got[0].tolist())) >= 8


def test_genai_default_bucket_is_the_jax_packages(genai):
    """At the Generator's default bucket of 128 the prompt is left-padded
    and the past padded with zero rows; the ORT form takes no mask (its
    past length is the padded length under the JAX package's jit), so the
    padding is attended and the new token rotated at the padded position.
    The port gives the JAX package's tokens, which part from the module's
    exact-past decode."""
    module, path = genai[True]
    got = TGenerator(TModel.load_file(path, device="cpu"), PROMPT, TConfig()).generate(6)
    want = JGenerator(JModel.load_file(path), PROMPT, JConfig()).generate(6)
    np.testing.assert_array_equal(got, want)
    assert got[0].tolist() != module.greedy(PROMPT[0], 6)[0]
