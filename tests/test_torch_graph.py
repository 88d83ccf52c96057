"""The port's graph pipeline against the JAX package's: the GPT-2 serving
graph builder, ``quantize_dynamic`` and ``optimize_graph`` must give the
same operators in the same plan order and the same constants, bit for bit,
from the same seeded weights. Also the weight hand-over
(``load_numpy_constants``) and the branches the slice does not cover.
"""

import numpy as np
import pytest

from rten_tpu.model import Model as JModel
from rten_tpu.model import ModelOptions as JOptions
from rten_tpu.models import gpt2 as jgpt2
from rten_tpu.quantize_pass import quantize_dynamic as jquantize
from rten_tpu.quantize_pass import quantize_weight_per_col as jquant_w
from rten_tpu_torch.ir.graph import Constant as TConstant
from rten_tpu_torch.model import Model as TModel
from rten_tpu_torch.models import gpt2 as tgpt2
from rten_tpu_torch.optimize import optimize_graph as toptimize
from rten_tpu_torch.quantize_pass import quantize_dynamic as tquantize
from rten_tpu_torch.quantize_pass import quantize_weight_per_col as tquant_w
from rten_tpu_torch.weights import load_numpy_constants

SMALL = dict(vocab_size=512, n_positions=128, n_embd=128, n_layer=2, n_head=2)
CAP = 64
MAIN_PATH = dict(capacity=CAP, kv_quant=True, kernel_append=True, gather_last=True)


def _constants(g):
    from rten_tpu.ir.graph import Constant as JConstant

    return {
        nid: (node.name, node.array) for nid, node in g.nodes.items()
        if isinstance(node, (TConstant, JConstant))
    }


def _plan_ops(g):
    return [g.nodes[n].op_type for n in g.plan(g.input_ids, g.output_ids)]


def test_random_weights_match():
    cfg = SMALL
    tw = tgpt2.random_weights(tgpt2.GPT2Config(**cfg), seed=3)
    jw = jgpt2.random_weights(jgpt2.GPT2Config(**cfg), seed=3)
    assert tw.keys() == jw.keys()
    for k in tw:
        assert tw[k].dtype == jw[k].dtype
        np.testing.assert_array_equal(tw[k], jw[k])


def test_configs_match():
    assert tgpt2.CONFIGS.keys() == jgpt2.CONFIGS.keys()
    for name in tgpt2.CONFIGS:
        t, j = tgpt2.CONFIGS[name], jgpt2.CONFIGS[name]
        assert (t.vocab_size, t.n_positions, t.n_embd, t.n_layer, t.n_head,
                t.layer_norm_epsilon) == (j.vocab_size, j.n_positions, j.n_embd,
                                          j.n_layer, j.n_head, j.layer_norm_epsilon)


def test_quantize_weight_per_col_matches():
    w = np.random.default_rng(4).standard_normal((96, 40)).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero column: scale 1
    tq, ts = tquant_w(w)
    jq, js = jquant_w(w)
    np.testing.assert_array_equal(tq, jq)
    np.testing.assert_array_equal(ts, js)


@pytest.mark.parametrize("stage,vocab", [
    ("built", 512), ("quantized", 512), ("optimized", 512),
    ("optimized", 500),  # the lm_head pads 500 -> 512 (rten_orig_n)
])
def test_pipeline_matches_jax(stage, vocab):
    """Same operators in plan order, same node ids, same inputs and
    outputs, every constant equal by name, dtype and value."""
    cfg = {**SMALL, "vocab_size": vocab}
    weights = tgpt2.random_weights(tgpt2.GPT2Config(**cfg), seed=0)
    tg = tgpt2.build_graph_static_cache(tgpt2.GPT2Config(**cfg), weights, **MAIN_PATH)
    jg = jgpt2.build_graph_static_cache(jgpt2.GPT2Config(**cfg), weights, **MAIN_PATH)
    if stage != "built":
        tquantize(tg)
        jquantize(jg)
    if stage == "optimized":
        tg = toptimize(tg)
        jg = JModel(jg, JOptions(optimize=True)).graph
    assert _plan_ops(tg) == _plan_ops(jg)
    assert [tg.node_name(i) for i in tg.input_ids] == [jg.node_name(i) for i in jg.input_ids]
    assert [tg.node_name(i) for i in tg.output_ids] == [jg.node_name(i) for i in jg.output_ids]
    tc, jc = _constants(tg), _constants(jg)
    assert tc.keys() == jc.keys()
    for nid in tc:
        (tn, ta), (jn, ja) = tc[nid], jc[nid]
        assert tn == jn
        assert ta.dtype == ja.dtype and ta.shape == ja.shape, tn
        np.testing.assert_array_equal(ta, ja, err_msg=str(tn))
    if stage == "optimized":
        ops = set(_plan_ops(tg))
        assert ops == {
            "Add", "ArgMax", "DynamicQuantizeLinear", "Gather", "GatherND",
            "Gelu", "LayerNormalization", "MatMulIntegerToFloat",
            "QuantizedKVAttention", "Reshape", "Split",
        }
        mm = [op for _, op in tg.operators() if op.op_type == "MatMulIntegerToFloat"]
        assert len(mm) == 4 * SMALL["n_layer"] + 1
        assert all(op.inputs[7] is not None for op in mm)  # colsums prepacked
        lm = [op for op in mm if op.attrs.get("rten_orig_n")]
        assert len(lm) == (vocab % 128 != 0)
        if lm:
            assert lm[0].attrs["rten_orig_n"] == vocab


def _small_models(vocab=500):
    """Both packages' optimized models; vocab 500 makes the prepack pad the
    lm_head to 512."""
    cfg = {**SMALL, "vocab_size": vocab}
    weights = tgpt2.random_weights(tgpt2.GPT2Config(**cfg), seed=0)
    tg = tgpt2.build_graph_static_cache(tgpt2.GPT2Config(**cfg), weights, **MAIN_PATH)
    jg = jgpt2.build_graph_static_cache(jgpt2.GPT2Config(**cfg), weights, **MAIN_PATH)
    tquantize(tg)
    jquantize(jg)
    return TModel(tg, device="cpu"), JModel(jg, JOptions(optimize=True))


def test_load_numpy_constants_round_trip():
    """The JAX model's optimized constants (s8 weights, scales, colsums,
    padded lm_head) carried into the port model by name."""
    tm, jm = _small_models()
    arrays = {
        node.name: np.asarray(node.array) * (2 if node.array.dtype == np.float32 else 1)
        for node in jm.graph.nodes.values()
        if type(node).__name__ == "Constant" and node.name
        and node.array.size >= 16
    }
    assert any(k.endswith(".colsums") for k in arrays)
    assert any(k.endswith(".prepack") for k in arrays)
    _ = tm.run(_zero_feed(tm), ["next_token"])  # weights uploaded once
    load_numpy_constants(tm, arrays)
    for name, arr in arrays.items():
        node = tm.graph.nodes[tm.graph.find_node(name)]
        np.testing.assert_array_equal(node.array, arr)
    # The next run uses the replaced constants on the device.
    w = tm.executor._weight_args()
    nid = tm.graph.find_node("transformer.wte.weight")
    np.testing.assert_array_equal(w[nid].numpy(), arrays["transformer.wte.weight"])


def _zero_feed(model, slots=3, T=4):
    feed = {
        "input_ids": np.zeros((slots, T), np.int32),
        "past_lens": np.zeros(slots, np.int32),
        "position_ids": np.tile(np.arange(T, dtype=np.int32), (slots, 1)),
        "last_pos": np.full(slots, T - 1, np.int32),
    }
    for name, dt, shape in model.input_info():
        if name.startswith("past_key_values."):
            feed[name] = np.zeros((slots,) + tuple(shape[1:]), dt.np_dtype)
    return feed


@pytest.mark.parametrize("bad", ["name", "shape", "dtype"])
def test_load_numpy_constants_checks(bad):
    tm, _ = _small_models()
    name = "transformer.wte.weight"
    arr = tm.graph.nodes[tm.graph.find_node(name)].array
    before = arr.copy()
    args = {
        "name": ({"no.such.constant": arr}, KeyError),
        "shape": ({name: arr[:-1]}, ValueError),
        "dtype": ({name: arr.astype(np.float64)}, ValueError),
    }[bad]
    with pytest.raises(args[1]):
        load_numpy_constants(tm, args[0])
    np.testing.assert_array_equal(tm.graph.nodes[tm.graph.find_node(name)].array, before)


@pytest.mark.parametrize("kwargs", [
    dict(kv_quant=False, kernel_append=False, deferred_kv=True, gather_last=False),
    dict(kv_bits=4, kernel_append=False, lora_rank=4, n_adapters=2),
    dict(kernel_append=False, deferred_kv=True, lora_rank=2, n_adapters=1),
    dict(kv_bits=4, kernel_append=False, gather_last=False),   # int4, full-bucket lm_head
    dict(lora_rank=4, n_adapters=2),
    dict(kv_quant=False, lora_rank=4, n_adapters=2),
    dict(gather_last=False),
])
def test_builder_branches_off_the_slice_raise(kwargs):
    """What the slice still does not build raises, naming its ROADMAP.md
    item: LoRA and the full-bucket lm_head, on every cache form (f32/bf16
    and head-major caches and pools are built: tests/test_torch_kv_dtypes.py;
    int4 and deferred KV: tests/test_torch_int4_kv.py,
    tests/test_torch_deferred_kv.py)."""
    cfg = tgpt2.GPT2Config(**SMALL)
    opts = {**MAIN_PATH, **kwargs}
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tgpt2.build_graph_static_cache(cfg, tgpt2.random_weights(cfg), **opts)


def test_dtype_map_matches_jax():
    """The port's DataType is the JAX package's, plus the torch.dtype map
    both ways."""
    import torch
    from rten_tpu.dtypes import DataType as JDataType
    from rten_tpu_torch.dtypes import DataType as TDataType

    assert [d.name for d in TDataType] == [d.name for d in JDataType]
    for d in TDataType:
        assert d.np_dtype == JDataType[d.name].np_dtype
        assert TDataType.from_torch(d.torch_dtype) is d
        if d.name != "BFloat16":  # numpy has no bf16; ml_dtypes supplies it
            assert torch.empty(0, dtype=d.torch_dtype).numpy().dtype == d.np_dtype
