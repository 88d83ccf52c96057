"""The port's Generator path against the JAX package's: the Optimum-style
GPT-2 graph (``build_graph``), the int4 weight-only pass, the Generator
(bucketed left-padded prefill, padded past, appended rows, eos, filters,
samplers, sessions), and the int4 weight-only serving graph behind the
engine.

Weights and prompts are made with numpy from seeds and handed to both
packages; JAX runs on the CPU (its XLA fallbacks), the port on the CPU
(the kernels' plain versions). The attention and MLP projections are
sharpened 4x (``_weights``): at GPT-2's initialization scale a small model
repeats one token whatever the context, which would hide a wrong cache.
"""

import collections

import numpy as np
import pytest
import torch

from rten_tpu.generate import Generator as JGenerator
from rten_tpu.generate import GeneratorConfig as JConfig
from rten_tpu.generate import filter as jfilter
from rten_tpu.generate.sampler import MultinomialSampler as JMultinomial
from rten_tpu.model import Model as JModel
from rten_tpu.model import ModelOptions as JOptions
from rten_tpu.models import gpt2 as jgpt2
from rten_tpu.quantize_pass import pack_int4_weight as jpack
from rten_tpu.quantize_pass import quantize_dynamic as jquant8
from rten_tpu.quantize_pass import quantize_weight_only_int4 as jquant4
from rten_tpu.serving import ContinuousBatchingEngine as JEngine
from rten_tpu_torch.generate import Generator as TGenerator
from rten_tpu_torch.generate import GeneratorConfig as TConfig
from rten_tpu_torch.generate import filter as tfilter
from rten_tpu_torch.generate.sampler import MultinomialSampler as TMultinomial
from rten_tpu_torch.ir.graph import Constant as TConstant
from rten_tpu_torch.model import Model as TModel
from rten_tpu_torch.models import gpt2 as tgpt2
from rten_tpu_torch.optimize import optimize_graph as toptimize
from rten_tpu_torch.quantize_pass import pack_int4_weight as tpack
from rten_tpu_torch.quantize_pass import quantize_dynamic as tquant8
from rten_tpu_torch.quantize_pass import quantize_weight_only_int4 as tquant4
from rten_tpu_torch.serving import ContinuousBatchingEngine as TEngine
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

SMALL = dict(vocab_size=512, n_positions=128, n_embd=128, n_layer=2, n_head=2)
BUCKET = 8


def _weights(seed=0, sharpen=4.0):
    w = tgpt2.random_weights(tgpt2.GPT2Config(**SMALL), seed)
    for k in w:
        if (".attn.c_" in k or ".mlp.c_" in k) and k.endswith(".weight"):
            w[k] = w[k] * np.float32(sharpen)
    return w


def _models(quantize, weights=None):
    """Both packages' GPT-2 ``load`` of the same weights: (port, JAX)."""
    w = _weights() if weights is None else weights
    tm = tgpt2.load(tgpt2.GPT2Config(**SMALL), w, quantize=quantize, device="cpu")
    jm = jgpt2.load(jgpt2.GPT2Config(**SMALL), w, quantize=quantize)
    return tm, jm


@pytest.fixture(scope="module", params=[None, "int8", "int4"])
def models(request):
    return request.param, _models(request.param)


# --- graphs -----------------------------------------------------------------------


def _plan_ops(g):
    return [g.nodes[n].op_type for n in g.plan(g.input_ids, g.output_ids)]


def _constants(g):
    from rten_tpu.ir.graph import Constant as JConstant

    return {nid: (node.name, node.array) for nid, node in g.nodes.items()
            if isinstance(node, (TConstant, JConstant))}


@pytest.mark.parametrize("quantize", [None, "int8", "int4"])
@pytest.mark.parametrize("optimized", [False, True])
def test_build_graph_matches_jax(quantize, optimized):
    """``build_graph`` (+ the quantize pass, + optimize) node for node: the
    same operators in plan order, node ids, input and output names, and
    every constant equal by name, dtype and value. The JAX optimizer
    changes no operator of these graphs (only the int8 prepack rewrites
    constants), so the op-type multisets before and after match too."""
    w = _weights(seed=2)
    tg = tgpt2.build_graph(tgpt2.GPT2Config(**SMALL), w)
    jg = jgpt2.build_graph(jgpt2.GPT2Config(**SMALL), w)
    quant = {None: (lambda g: g, lambda g: g), "int8": (tquant8, jquant8),
             "int4": (tquant4, jquant4)}[quantize]
    quant[0](tg)
    quant[1](jg)
    before = collections.Counter(op.op_type for _, op in tg.operators())
    if optimized:
        tg = toptimize(tg)
        jg = JModel(jg, JOptions(optimize=True)).graph
    assert _plan_ops(tg) == _plan_ops(jg)
    assert collections.Counter(op.op_type for _, op in tg.operators()) == before
    assert [tg.node_name(i) for i in tg.input_ids] == [jg.node_name(i) for i in jg.input_ids]
    assert [tg.node_name(i) for i in tg.output_ids] == [jg.node_name(i) for i in jg.output_ids]
    for g in (tg, jg):
        assert {g.node_name(n) for n in g.input_ids} >= {"input_ids", "attention_mask"}
    tc, jc = _constants(tg), _constants(jg)
    assert tc.keys() == jc.keys()
    for nid in tc:
        (tn, ta), (jn, ja) = tc[nid], jc[nid]
        assert tn == jn and ta.dtype == ja.dtype and ta.shape == ja.shape, tn
        np.testing.assert_array_equal(ta, ja, err_msg=str(tn))
    if quantize == "int4":
        nbits = [op for _, op in tg.operators() if op.op_type == "MatMulNBits"]
        assert len(nbits) == 4 * SMALL["n_layer"] + 1


@pytest.mark.parametrize("K,N,bs", [(128, 96, 32), (100, 36, 32), (72, 10, 16), (256, 7, 64)])
def test_pack_int4_weight_byte_identical(K, N, bs):
    """The same packed bytes and scales as the JAX package's pass, K not a
    multiple of the block included, and an all-zero block (scale 1)."""
    w = np.random.default_rng(K + N).standard_normal((K, N)).astype(np.float32)
    w[:bs, 0] = 0.0
    tp, ts = tpack(w, bs)
    jp, js = jpack(w, bs)
    assert tp.dtype == jp.dtype == np.uint8 and tp.shape == jp.shape
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(ts, js)
    assert ts[0, 0] == 1.0


def test_weights_from_torch_matches_jax():
    """The same dict from a transformers-shaped module's state dict: the
    causal-mask buffers and the tied lm_head left out."""
    class Fake(torch.nn.Module):
        def state_dict(self):
            w = torch.arange(6.0).reshape(2, 3)
            return {"transformer.wte.weight": w, "transformer.h.0.attn.bias": torch.ones(2),
                    "transformer.h.0.attn.masked_bias": torch.ones(1),
                    "lm_head.weight": w, "transformer.ln_f.bias": torch.zeros(3)}

    got, want = tgpt2.weights_from_torch(Fake()), jgpt2.weights_from_torch(Fake())
    assert got.keys() == want.keys() == {"transformer.wte.weight", "transformer.ln_f.bias"}
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


# --- the Generator ------------------------------------------------------------------


def _prompt(B, T, seed=0):
    return np.random.default_rng(seed).integers(0, SMALL["vocab_size"], (B, T))


@pytest.mark.parametrize("B,T", [(1, 5), (1, BUCKET), (2, 11), (2, BUCKET)])
def test_generator_token_exact(models, B, T):
    """Greedy tokens equal to the JAX Generator's, for f32, int8 and int4
    weights; a prompt shorter than the bucket (left padding), one exactly
    at it, and batch 2. 14 new tokens cross a bucket boundary of the
    padded past."""
    quantize, (tm, jm) = models
    prompt = _prompt(B, T, seed=B * 100 + T)
    got = TGenerator(tm, prompt, TConfig(bucket_size=BUCKET)).generate(14)
    want = JGenerator(jm, prompt, JConfig(bucket_size=BUCKET)).generate(14)
    np.testing.assert_array_equal(got, want)
    assert len({int(t) for t in got[0]}) > 1  # the tokens follow the context


def test_generator_prefill_logits_match_jax(models):
    """The prefill's last-position logits (left padding masked): f32 and
    int4 within 1e-5 of max|logit| (f32 products in another summation
    order); int8 within 2e-2 (an ulp in a per-tensor activation scale can
    move a u8 code, ROADMAP Faults)."""
    quantize, (tm, jm) = models
    prompt = _prompt(2, 6, seed=7)
    got = TGenerator(tm, prompt, TConfig(bucket_size=BUCKET))._pending_logits
    want = JGenerator(jm, prompt, JConfig(bucket_size=BUCKET))._pending_logits
    tol = 2e-2 if quantize == "int8" else 1e-5
    assert got.shape == want.shape == (2, SMALL["vocab_size"])
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_generator_eos_filters_and_multinomial():
    """eos ids stop a row (batch 2: the iterator ends when both finished),
    a filter chain (temperature, top-k, top-p, repetition penalty, a
    suppressed id) and ``MultinomialSampler(seed)``: the same tokens as
    the JAX Generator (same numpy generator, same float64 probabilities)."""
    tm, jm = _models(None)
    prompt = _prompt(2, 6, seed=3)

    def chain(f):
        return [f.Temperature(0.8), f.TopK(40), f.TopP(0.9), f.RepetitionPenalty(1.3),
                f.token_id_filter([0, 1, 2])]

    greedy = TGenerator(tm, prompt, TConfig(bucket_size=BUCKET)).generate(10)
    eos = [int(greedy[0, 3]), int(greedy[1, 6])]
    outs = []
    for G, C, f, S, m in ((TGenerator, TConfig, tfilter, TMultinomial, tm),
                          (JGenerator, JConfig, jfilter, JMultinomial, jm)):
        sampled = G(m, prompt, C(bucket_size=BUCKET, logits_filters=chain(f),
                                 sampler=S(seed=11))).generate(12)
        stopped = G(m, prompt, C(bucket_size=BUCKET, eos_ids=eos)).generate(12)
        outs.append((sampled, stopped))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    assert not np.isin(outs[0][0], [0, 1, 2]).any()
    # Each row finishes at its first eos token; the run ends when both have.
    ends = [int(np.flatnonzero(np.isin(row, eos))[0]) + 1 for row in greedy]
    np.testing.assert_array_equal(outs[0][1], greedy[:, :max(ends)])


def test_generator_session_resumes_token_exact(tmp_path):
    """save_session after 5 tokens, restore into a fresh Generator, 7 more:
    the same 12 tokens as an uninterrupted run, and as the JAX Generator's
    session file restored by the port (the same safetensors layout)."""
    tm, jm = _models("int4")
    prompt = _prompt(1, 9, seed=5)
    cfg = TConfig(bucket_size=BUCKET)
    full = TGenerator(tm, prompt, cfg).generate(12)
    g = TGenerator(tm, prompt, cfg)
    head = g.generate(5)
    g.save_session(tmp_path / "s.safetensors")
    g2 = TGenerator(tm, _prompt(1, 3, seed=9), cfg)
    g2.restore_session(tmp_path / "s.safetensors")
    tail = g2.generate(7)
    np.testing.assert_array_equal(np.concatenate([head, tail], 1), full)
    jg = JGenerator(jm, prompt, JConfig(bucket_size=BUCKET))
    jg.generate(5)
    jg.save_session(tmp_path / "j.safetensors")
    g3 = TGenerator(tm, _prompt(1, 3, seed=9), cfg)
    g3.restore_session(tmp_path / "j.safetensors")
    np.testing.assert_array_equal(g3.generate(7), tail)


def test_safetensors_round_trip_matches_jax(tmp_path):
    from rten_tpu.serialize import read_safetensors as jread
    from rten_tpu_torch.serialize import read_safetensors, write_safetensors

    rng = np.random.default_rng(0)
    t = {"f": rng.standard_normal((2, 3)).astype(np.float32), "i": np.arange(5, dtype=np.int32),
         "b": np.array([True, False]), "u": np.zeros((0, 4), np.uint8)}
    write_safetensors(tmp_path / "x.safetensors", t, metadata={"k": "v"})
    for read in (read_safetensors, jread):
        back = read(tmp_path / "x.safetensors")
        assert back.keys() == t.keys()
        for k in t:
            assert back[k].dtype == t[k].dtype
            np.testing.assert_array_equal(back[k], t[k])


V_SMALL = 32
BONUS = 7  # the first run's token where the graph reads use_cache_branch


def _graph_with_inputs(names, GB, DT):
    """input_ids plus the inputs ``names``: logits = 10 * onehot(3 * id + 1
    mod V) at every position, and where ``use_cache_branch`` is an input,
    100 * onehot(BONUS) added while it is False (the first run); each
    ``past_key_values.*`` input grows by the ids' rows ([B, 2, S, 4]) into
    its ``present.*`` output."""
    b = GB()
    ids = b.input("input_ids", DT.Int32, ("batch", "seq"))
    table = np.zeros((V_SMALL, V_SMALL), np.float32)
    table[np.arange(V_SMALL), (3 * np.arange(V_SMALL) + 1) % V_SMALL] = 10.0
    logits = b.op("Gather", [b.constant("table", table), ids], {"axis": 0})
    if "use_cache_branch" in names:
        flag = b.input("use_cache_branch", DT.Bool, ())
        first = b.op("Cast", [b.op("Not", [flag])], {"to": DT.Float})
        bonus = np.zeros(V_SMALL, np.float32)
        bonus[BONUS] = 100.0
        logits = b.op("Add", [logits, b.op("Mul", [first, b.constant("bonus", bonus)])])
    outs = [b.op("Identity", [logits], output_names=["logits"])]
    row = b.op("Mul", [b.op("Unsqueeze", [b.op("Cast", [ids], {"to": DT.Float}),
                                           b.constant("axes", np.int32([1, 3]))]),
                       b.constant("ones", np.ones((1, 2, 1, 4), np.float32))])
    for n in names:
        if n.startswith("past_key_values"):
            past = b.input(n, DT.Float, ("batch", 2, "past", 4))
            outs.append(b.op("Concat", [past, row], {"axis": 2},
                             output_names=[n.replace("past_key_values", "present")]))
    b.output(*outs)
    return b.finish()


@pytest.mark.parametrize("names", [
    ["past_key_values.0.decoder.key", "past_key_values.0.encoder.key"],
    ["use_cache_branch"],
])
def test_generator_encoder_decoder_graphs_run(names):
    """Cross-attention caches and a merged decoder's use_cache_branch run
    through the Generator, the same tokens as the JAX Generator's: the
    cross cache made on the first run (from an empty one) and kept, the
    decoder cache grown a row a step, the flag False on the first run
    only."""
    from rten_tpu.dtypes import DataType as JDataType
    from rten_tpu.ir.builder import GraphBuilder as JBuilder
    from rten_tpu_torch.dtypes import DataType as TDataType
    from rten_tpu_torch.ir.builder import GraphBuilder as TBuilder

    prompt = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    gen = TGenerator(TModel(_graph_with_inputs(names, TBuilder, TDataType), device="cpu"),
                     prompt)
    got = gen.generate(5)
    want = JGenerator(JModel(_graph_with_inputs(names, JBuilder, JDataType)), prompt).generate(5)
    np.testing.assert_array_equal(got, want)
    first = np.full(2, BONUS) if "use_cache_branch" in names else (3 * prompt[:, -1] + 1) % V_SMALL
    chain = [first]
    for _ in range(4):
        chain.append((3 * chain[-1] + 1) % V_SMALL)
    np.testing.assert_array_equal(got, np.stack(chain, 1))
    if "use_cache_branch" in names:
        assert gen.kv == [] and gen.cross_kv == []
        return
    assert [e.input_name for e in gen.cross_kv] == ["past_key_values.0.encoder.key"]
    cross = gen._cross["past_key_values.0.encoder.key"]
    np.testing.assert_array_equal(cross.numpy()[:, 0, :, 0], prompt.astype(np.float32))
    assert tuple(gen._cache[0].shape) == (2, 2, 3 + 5, 4)  # the prompt, a row a token


def test_model_run_accepts_static_inputs():
    tm, _ = _models(None, _weights(sharpen=1.0))
    feed = {"input_ids": np.array([[3, 4]], np.int32),
            "attention_mask": np.ones((1, 2), np.int32),
            "position_ids": np.array([[0, 1]], np.int32)}
    for i in range(SMALL["n_layer"]):
        for kv in ("key", "value"):
            feed[f"past_key_values.{i}.{kv}"] = np.zeros((1, 2, 0, 64), np.float32)
    a = tm.run(feed, ["logits"])[0]
    b = tm.run(feed, ["logits"], static_inputs=["attention_mask"])[0]
    assert torch.equal(a, b) and a.shape == (1, 2, SMALL["vocab_size"])
    assert "input_ids" in tm.input_names()


# --- int4 weight-only serving ---------------------------------------------------------


@pytest.mark.parametrize("k", [1, 4])
def test_int4_serve_graph_token_exact(k):
    """``build_graph_static_cache(kv_quant=True, kernel_append=True,
    gather_last=True)`` + ``quantize_weight_only_int4`` (``bench.py``'s
    RTEN_BENCH_QUANT=int4 graph) behind the engine: the same tokens as the
    JAX engine, k steps per dispatch."""
    w = _weights(seed=1)
    kw = dict(capacity=64, kv_quant=True, kernel_append=True, gather_last=True)
    out = []
    for g, q, mk, E in ((tgpt2, tquant4, lambda gr: TModel(gr, device="cpu"), TEngine),
                        (jgpt2, jquant4, lambda gr: JModel(gr, JOptions()), JEngine)):
        gr = g.build_graph_static_cache(g.GPT2Config(**SMALL), w, **kw)
        q(gr)
        assert sum(op.op_type == "MatMulNBits" for _, op in gr.operators()) == 9
        e = E(mk(gr), n_layer=2, n_head=2, head_dim=64, slots=3, capacity=64,
              prefill_bucket=8, greedy_on_device=True, steps_per_dispatch=k)
        rng = np.random.default_rng(0)
        rs = [e.submit(rng.integers(0, 512, int(rng.integers(3, 12))).tolist(),
                       max_new_tokens=int(rng.integers(3, 14))) for _ in range(5)]
        e.run()
        out.append([r.generated for r in rs])
    assert out[0] == out[1]
    assert len({t for g in out[0] for t in g}) > 5


def test_engine_refuses_the_generator_graph():
    """The Generator's graph has growing caches ([B, H, past_seq, D]): the
    engine refuses it with the JAX engine's ValueError (a slot cache needs
    concrete trailing dims)."""
    tm, jm = _models(None, _weights(sharpen=1.0))
    for cls, model in ((TEngine, tm), (JEngine, jm)):
        with pytest.raises(ValueError, match="concrete trailing"):
            cls(model, n_layer=2, n_head=2, head_dim=64, slots=2, capacity=64,
                prefill_bucket=8, greedy_on_device=True)
