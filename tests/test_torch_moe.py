"""The port's MoE op (``rten_tpu_torch/ops/moe.py``) and MoE LM
(``rten_tpu_torch/models/moe.py``) against the JAX package's, on the CPU,
with the same numpy inputs from a seed.

* The op, one-node graphs: dense and capacity dispatch (at a capacity
  factor that drops tokens, and at one that keeps them all), top_k 1 and
  2, with and without biases, the three activations, softmax and sigmoid
  gates: within 1e-5 of max|out|.
* The LM: ``random_weights`` gives the same numpy dict in both packages;
  both ``build_graph``s give the same operators, and the logits of a
  prompt agree within 1e-5 of max|logit|, in dense and capacity dispatch;
  greedy tokens, decoded step by step in both packages, are equal.
"""

import numpy as np
import pytest

from torch_one_thread import one_torch_thread  # noqa: F401

from rten_tpu.dtypes import DataType as JDataType
from rten_tpu.ir.builder import GraphBuilder as JBuilder
from rten_tpu.model import Model as JModel
from rten_tpu.model import ModelOptions as JOptions
from rten_tpu.models import moe as jmoe
from rten_tpu_torch.dtypes import DataType as TDataType
from rten_tpu_torch.ir.builder import GraphBuilder as TBuilder
from rten_tpu_torch.model import Model as TModel
from rten_tpu_torch.model import ModelOptions as TOptions
from rten_tpu_torch.models import moe as tmoe

TOL = 1e-5
X, E, F = 6, 32, 24


def _op_graph(GB, DT, consts, attrs):
    b = GB()
    ins = [b.input("x", DT.Float)] + [None if a is None else b.constant(n, a)
                                      for n, a in consts]
    b.output(b.op("MoE", ins, attrs, output_names=["y"]))
    return b.finish()


def _close(got, want, tol=TOL):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("dispatch,cf", [("dense", None), ("capacity", 0.5),
                                         ("capacity", 4.0)])
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("act,biases", [("gelu", False), ("silu", True), ("swiglu", True)])
def test_moe_op_matches_jax(dispatch, cf, top_k, act, biases):
    rng = np.random.default_rng(top_k * 7 + len(act))
    fu = 2 * F if act == "swiglu" else F

    def n(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    consts = [("rw", n(E, X)), ("up", n(X, E, fu) * 0.3), ("down", n(X, F, E) * 0.3),
              ("bu", n(X, fu) if biases else None), ("bd", n(X, E) if biases else None)]
    attrs = {"top_k": top_k, "activation": act, "dispatch": dispatch,
             "normalize_gates": int(top_k == 2)}
    if cf is not None:
        attrs["capacity_factor"] = cf
    x = n(2, 13, E)
    got = TModel(_op_graph(TBuilder, TDataType, consts, attrs), TOptions(optimize=False),
                 device="cpu").run({"x": x})[0].numpy()
    want = np.asarray(JModel(_op_graph(JBuilder, JDataType, consts, attrs),
                             JOptions(optimize=False)).run({"x": x})[0])
    _close(got, want)


SMALL = dict(vocab_size=128, n_positions=64, n_embd=64, n_layer=2, n_head=2, n_experts=4,
             top_k=2, ffn_dim=48)


def _sharpened(w):
    """Projections x20, so that greedy tokens vary with the context at this
    width (at 0.02, and at x8, a small model repeats one token)."""
    return {k: v * np.float32(20) if (".attn." in k and k.endswith("weight")) or ".moe." in k
            else v for k, v in w.items()}


def test_random_weights_are_the_jax_draws():
    t = tmoe.random_weights(tmoe.MoEConfig(**SMALL), 3)
    j = jmoe.random_weights(jmoe.MoEConfig(**SMALL), 3)
    assert sorted(t) == sorted(j)
    for k in t:
        np.testing.assert_array_equal(t[k], j[k])


def _feed(ids):
    B, T = ids.shape
    return {"input_ids": ids.astype(np.int32), "attention_mask": np.ones((B, T), np.int32),
            "position_ids": np.tile(np.arange(T, dtype=np.int32), (B, 1)),
            **{f"past_key_values.{i}.{n}": np.zeros((B, 2, 0, 32), np.float32)
               for i in range(2) for n in ("key", "value")}}


@pytest.mark.parametrize("dispatch", ["dense", "capacity"])
def test_moe_lm_logits_match_jax(dispatch):
    w = _sharpened(jmoe.random_weights(jmoe.MoEConfig(**SMALL), 0))
    graphs = []
    for pkg in (tmoe, jmoe):
        g = pkg.build_graph(pkg.MoEConfig(**SMALL), w)
        for _, op in g.operators():
            if op.op_type == "MoE":
                op.attrs["dispatch"] = dispatch
        graphs.append(g)
    t = TModel(graphs[0], TOptions(optimize=False), device="cpu")
    j = JModel(graphs[1], JOptions(optimize=False))
    assert [o.op_type for _, o in t.graph.operators()] == [
        o.op_type for _, o in j.graph.operators()]
    feed = _feed(np.random.default_rng(1).integers(0, 128, (2, 11)))
    _close(t.run(dict(feed), ["logits"])[0].numpy(),
           np.asarray(j.run(dict(feed), ["logits"])[0]))


def test_moe_lm_greedy_tokens_match_jax():
    """Greedy decoding of both packages' LMs on the same weights (the graph
    keeps no caches as outputs: each step runs the whole sequence): the
    same 8 tokens, not all one."""
    w = _sharpened(jmoe.random_weights(jmoe.MoEConfig(**SMALL), 0))
    t = TModel(tmoe.build_graph(tmoe.MoEConfig(**SMALL), w), device="cpu")
    j = JModel(jmoe.build_graph(jmoe.MoEConfig(**SMALL), w))
    out = []
    for run in (lambda f: t.run(f, ["logits"])[0].numpy(),
                lambda f: np.asarray(j.run(f, ["logits"])[0])):
        ids = np.random.default_rng(2).integers(0, 128, (1, 5))
        for _ in range(8):
            ids = np.concatenate([ids, [[int(np.argmax(run(_feed(ids))[0, -1]))]]], 1)
        out.append(ids[0, 5:].tolist())
    assert out[0] == out[1] and len(set(out[0])) > 2, out
