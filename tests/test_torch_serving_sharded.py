"""The tensor-parallel serving engine of the port over two gloo ranks on
the CPU (``torch_parallel_worker.py``: MeshConfig(1, 2), one thread a
rank, a file store under ``tmp_path``, every wait bounded), against the
JAX package's unsharded engine, which runs here in the parent.

* ``test_serving_sharded.py``'s f32 engine (name rules), the int8 engine
  of ``test_int8_tp.py`` and a small Llama (4 query heads over 2 KV heads)
  with the derived plan: the same greedy tokens.
* The main path's int8 graph (cat caches, kernel append, gather_last; a
  padded lm_head: vocabulary 500 in 512 columns) with the derived plan:
  the same tokens, caches at one head a rank, and one admission forward's
  logits and tokens bit-equal to the port's unsharded forward.
* A ``DeviceSampler`` wave: every rank draws the same tokens, the unsharded
  engine's.
"""

import numpy as np
import pytest

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)
from torch_parallel_worker import (
    INT8_TP, LLAMA, MAIN_PATH, SERVE_INT8, TINY, run_ranks, serve_prompts, sharpened_gpt2,
)

from rten_tpu.model import Model as JModel
from rten_tpu.model import ModelOptions as JOptions
from rten_tpu.models import gpt2 as jgpt2
from rten_tpu.models import llama as jllama
from rten_tpu.quantize_pass import quantize_dynamic as jquantize
from rten_tpu.serving import ContinuousBatchingEngine as JEngine


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("serve"), 2, (1, 2),
                     ["serve_f32", "serve_int8", "int8_tp", "llama", "sampler"])


def _jax_tokens(graph, n_head, head_dim, prompts, **kw):
    kw = {"slots": 3, "capacity": 64, "prefill_bucket": 8, "greedy_on_device": True,
          "steps_per_dispatch": 4, **kw}
    eng = JEngine(JModel(graph, JOptions(optimize=True)), n_layer=2, n_head=n_head,
                  head_dim=head_dim, **kw)
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in prompts]
    eng.run()
    return [r.generated for r in reqs]


def _unpad(tokens):
    return [[t for t in row if t >= 0] for row in np.asarray(tokens).tolist()]


def _every_rank(outs, key, want):
    for rank, out in enumerate(outs):
        assert _unpad(out[key]) == want, f"rank {rank}"


def test_sharded_engine_matches_jax(ranks):
    """test_serving_sharded.py: f32 static caches, shard_constants' name
    rules; the caches hold 4 of the 8 heads a rank."""
    cfg = jgpt2.GPT2Config(**TINY)
    g = jgpt2.build_graph_static_cache(cfg, jgpt2.random_weights(cfg, seed=5), capacity=64)
    want = _jax_tokens(g, 8, 8, [([5, 9, 23], 6), ([40, 7, 12, 3], 6)], slots=2,
                       steps_per_dispatch=2)
    _every_rank(ranks["serve_f32"], "tokens", want)
    for out in ranks["serve_f32"]:
        assert out["cache_shape"].tolist() == [2, 4, 64, 8]


@pytest.mark.parametrize("sharpen", [1, 10])
def test_int8_main_path_tokens_match_jax(ranks, sharpen):
    g = jgpt2.build_graph_static_cache(jgpt2.GPT2Config(**SERVE_INT8),
                                       sharpened_gpt2(SERVE_INT8, 0, sharpen), **MAIN_PATH)
    jquantize(g)
    want = _jax_tokens(g, 2, 64, serve_prompts(SERVE_INT8["vocab_size"]))
    _every_rank(ranks["serve_int8"], f"tokens_{sharpen}", want)


@pytest.mark.parametrize("sharpen", [1, 10])
def test_int8_logits_bit_equal_to_unsharded(ranks, sharpen):
    """One admission forward: the int32 partials are all-reduced before the
    dequantisation and the sharded DynamicQuantizeLinear sees the global
    range, so every rank's logits (gathered, the padding columns dropped)
    and greedy tokens are the unsharded forward's, bit for bit."""
    for out in ranks["serve_int8"]:
        got, want = out[f"logits_{sharpen}"], out[f"want_logits_{sharpen}"]
        assert got.shape == want.shape == (3, 1, SERVE_INT8["vocab_size"])
        assert np.array_equal(got.view(np.int32), want.view(np.int32))
        assert np.array_equal(out[f"token_{sharpen}"], out[f"want_token_{sharpen}"])


def test_int8_rank_graph(ranks):
    """The rank's graph: cat caches and scales at one of the two heads,
    the collectives as operators."""
    out = ranks["serve_int8"][0]
    assert out["cache_past_key_values.0.key"].tolist() == [3, 64, 64]
    assert out["cache_past_key_values.0.key_scale"].tolist() == [3, 1, 64, 1]
    assert {"AllReduce", "AllGather", "ShardedArgMax",
            "ShardedDynamicQuantizeLinear"} <= set(out["ops"].tolist())


def test_int8_tp_engine_matches_jax(ranks):
    """test_int8_tp.py's quantized engine with the derived plan."""
    cfg = jgpt2.GPT2Config(**INT8_TP)
    g = jgpt2.build_graph_static_cache(cfg, jgpt2.random_weights(cfg, seed=11), capacity=64)
    jquantize(g)
    want = _jax_tokens(g, 8, 8, [([5, 9, 23], 8), ([40, 7, 12, 3], 8)], slots=2,
                       steps_per_dispatch=2)
    _every_rank(ranks["int8_tp"], "tokens", want)


def test_llama_derived_plan_matches_jax(ranks):
    """GQA: 4 query heads over 2 KV heads, int8 weights and KV caches; every
    rank holds 2 query heads and 1 KV head."""
    w = jllama.random_weights(jllama.LlamaConfig(**LLAMA), 0)
    w = {k: v * np.float32(2.0) if "_proj." in k else v for k, v in w.items()}
    g = jllama.build_graph_static_cache(jllama.LlamaConfig(**LLAMA), w, capacity=64,
                                        kv_quant=True, gather_last=True)
    jquantize(g)
    want = _jax_tokens(g, 4, 16, serve_prompts(LLAMA["vocab_size"], seed=2))
    _every_rank(ranks["llama"], "tokens", want)
    roles = ranks["llama"][0]["roles"].tolist()
    assert roles.count("col") == 2 * 5 + 1 and roles.count("row") == 2 * 2


def test_device_sampler_same_tokens_every_rank(ranks):
    outs = ranks["sampler"]
    assert all(np.array_equal(o["tokens"], outs[0]["tokens"]) for o in outs)
    assert np.array_equal(outs[0]["tokens"], outs[0]["plain"])
    assert (outs[0]["tokens"] >= 0).sum() > 20
