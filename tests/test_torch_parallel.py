"""The port's ``parallel`` package against the JAX package's, on the CPU.

The plans (``derive_tp_plan``, ``tp_weight_shardings``,
``fsdp_weight_shardings``, the rule tables) are compared in this process.
The sharded runs are real gloo groups of 2 and 4 processes
(``torch_parallel_worker.py``: MeshConfig(1, 2) and (2, 2), one thread a
rank, rendezvous through a file store under ``tmp_path``, every wait
bounded) in place of the JAX tests' 8 virtual devices; the JAX package's
unsharded results are computed here, in the parent.
"""

import numpy as np
import pytest

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)
from torch_parallel_worker import (
    TINY, gpt2_feed, moe_feed, moe_graph, run_ranks,
)

from rten_tpu.model import Model as JModel
from rten_tpu.model import ModelOptions as JOptions
from rten_tpu.models import gpt2 as jgpt2
from rten_tpu.models import llama as jllama
from rten_tpu.parallel import sharding as jsh
from rten_tpu.parallel import MeshConfig as JMeshConfig, make_mesh as jmake_mesh
from rten_tpu.quantize_pass import quantize_dynamic as jquantize
from rten_tpu_torch.model import Model as TModel
from rten_tpu_torch.models import gpt2 as tgpt2
from rten_tpu_torch.models import llama as tllama
from rten_tpu_torch.parallel import sharding as tsh
from rten_tpu_torch.parallel import MeshConfig, init_distributed, make_mesh
from rten_tpu_torch.quantize_pass import quantize_dynamic as tquantize

WORKER_CASES = ["process_info", "tp_forward", "sp_prefill", "moe"]


@pytest.fixture(scope="module")
def ranks_12(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("r12"), 2, (1, 2),
                     WORKER_CASES + ["tp_derived", "generator"])


@pytest.fixture(scope="module")
def ranks_22(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("r22"), 4, (2, 2), WORKER_CASES)


def _ranks(request, mesh):
    return request.getfixturevalue("ranks_12" if mesh == (1, 2) else "ranks_22")


def _jax_tiny():
    cfg = jgpt2.GPT2Config(**TINY)
    return jgpt2.load(cfg, jgpt2.random_weights(cfg, seed=3))


def _norm(spec):
    return tsh.normalize(tuple(spec))


# --- the plans ----------------------------------------------------------------


def _graphs(kind):
    """The same optimized graph built by both packages."""
    if kind == "gpt2":
        cfg = dict(vocab_size=96, n_positions=64, n_embd=64, n_layer=2, n_head=4)
        w = tgpt2.random_weights(tgpt2.GPT2Config(**cfg), seed=0)
        tg = tgpt2.build_graph(tgpt2.GPT2Config(**cfg), w)
        jg = jgpt2.build_graph(jgpt2.GPT2Config(**cfg), w)
    elif kind == "gpt2_int8":
        cfg = dict(vocab_size=128, n_positions=64, n_embd=64, n_layer=2, n_head=8)
        w = tgpt2.random_weights(tgpt2.GPT2Config(**cfg), seed=11)
        tg = tgpt2.build_graph_static_cache(tgpt2.GPT2Config(**cfg), w, capacity=64)
        jg = jgpt2.build_graph_static_cache(jgpt2.GPT2Config(**cfg), w, capacity=64)
        tquantize(tg)
        jquantize(jg)
    else:
        cfg = dict(vocab_size=96, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                   num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)
        w = tllama.random_weights(tllama.LlamaConfig(**cfg), seed=0)
        tg = tllama.build_graph_static_cache(tllama.LlamaConfig(**cfg), w, capacity=32)
        jg = jllama.build_graph_static_cache(jllama.LlamaConfig(**cfg), w, capacity=32)
    return (TModel(tg, device="cpu").graph, JModel(jg, JOptions(optimize=True)).graph)


@pytest.mark.parametrize("kind", ["gpt2", "gpt2_int8", "llama"])
def test_tp_plans_match_jax(kind):
    """derive_tp_plan and tp_weight_shardings give the JAX package's plan,
    node for node, on the same graph."""
    tg, jg = _graphs(kind)
    tkinds, jkinds = tsh.derive_tp_plan(tg), jsh.derive_tp_plan(jg)
    assert tkinds == jkinds
    assert {"col", "row", "lm_head"} <= set(tkinds.values())
    mesh = jmake_mesh(JMeshConfig(1, 8))
    tplan = tsh.tp_weight_shardings(tg, MeshConfig(1, 8))
    jplan = jsh.tp_weight_shardings(jg, mesh)
    assert tplan and {k: _norm(v) for k, v in tplan.items()} == {
        k: _norm(v) for k, v in jplan.items()}


def test_fsdp_plan_matches_jax():
    tg, jg = _graphs("gpt2")
    tplan = tsh.fsdp_weight_shardings(tg, MeshConfig(4, 2), axis="data")
    jplan = jsh.fsdp_weight_shardings(jg, jmake_mesh(JMeshConfig(4, 2)), axis="data")
    assert tplan and {k: tuple(v) for k, v in tplan.items()} == {
        k: tuple(v) for k, v in jplan.items()}


@pytest.mark.parametrize("table", ["GPT2_SHARDING_RULES", "GPT2_INPUT_RULES",
                                   "SP_PREFILL_INPUT_RULES", "MOE_EP_RULES"])
def test_rule_tables_match_jax(table):
    t, j = getattr(tsh, table), getattr(jsh, table)
    assert [(p, tuple(s)) for p, s in t] == [(p, tuple(s)) for p, s in j]
    for name in ("transformer.h.3.attn.c_attn.weight.q8", "lm_head.weight_t", "input_ids",
                 "past_key_values.0.key", "m.moe.w_up", "x.scales"):
        assert _norm(tsh.sharding_for_name(name, t) or ()) == _norm(
            jsh.sharding_for_name(name, j) or ())


# --- init and meshes ---------------------------------------------------------------


def test_backend_is_never_chosen_silently(tmp_path):
    """No card a rank: backend=None refuses (NCCL needs a card a rank, and
    gloo is not picked behind the caller's back); the timeout must be
    finite."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this check needs a host without a card")
    store = f"file://{tmp_path / 'store'}"
    with pytest.raises(ValueError, match="backend='gloo'"):
        init_distributed(init_method=store, world_size=2, rank=0)
    with pytest.raises(ValueError, match="finite"):
        init_distributed(backend="gloo", init_method=store, world_size=1, rank=0,
                         timeout=float("inf"))


def test_mesh_larger_than_world_raises(tmp_path):
    import torch.distributed as dist

    init_distributed(backend="gloo", init_method=f"file://{tmp_path / 'store'}",
                     world_size=1, rank=0, timeout=30)
    try:
        assert dist.get_backend() == "gloo"
        with pytest.raises(ValueError, match="needs 2 devices, have 1"):
            make_mesh(MeshConfig(1, 2))
        mesh = make_mesh(MeshConfig(1, 1), device="cpu")
        assert mesh.shape == {"data": 1, "model": 1} and str(mesh.device) == "cpu"
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)])
def test_two_and_four_process_init(request, mesh):
    """process_info's keys on every rank; rank d * model + m sits at (d, m)."""
    ranks = _ranks(request, mesh)["process_info"]
    world = mesh[0] * mesh[1]
    for rank, info in enumerate(ranks):
        assert int(info["process_index"]) == rank
        assert int(info["process_count"]) == world == int(info["global_devices"])
        assert int(info["local_devices"]) == 1
        assert info["coords"].tolist() == [rank // mesh[1], rank % mesh[1]]


# --- sharded forwards against the JAX package -----------------------------------------


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)])
def test_tp_dp_forward_matches_jax(request, mesh):
    """test_parallel.py's TP(+DP) forward: the name rules, the input rules;
    every rank's logits within its rtol 1e-3 / atol 1e-4 of the JAX
    package's unsharded forward."""
    ids = np.arange(2 * 8, dtype=np.int32).reshape(2, 8) % TINY["vocab_size"]
    want = np.asarray(_jax_tiny().run(gpt2_feed(TINY, ids), ["logits"])[0])
    for out in _ranks(request, mesh)["tp_forward"]:
        np.testing.assert_allclose(out["logits"], want, rtol=1e-3, atol=1e-4)
        # Four column-parallel products and the lm_head, four row-parallel.
        assert out["roles"].tolist() == ["col"] * 5 + ["row"] * 4


def test_derived_plan_forward_matches_jax(ranks_12):
    """test_tp_derive.py's derived-plan forward, its rtol 2e-4 / atol 1e-5."""
    ids = np.arange(16, dtype=np.int32).reshape(2, 8) % TINY["vocab_size"]
    want = np.asarray(_jax_tiny().run(gpt2_feed(TINY, ids), ["logits"])[0])
    for out in ranks_12["tp_derived"]:
        np.testing.assert_allclose(out["logits"], want, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)])
def test_sp_prefill_matches_jax(request, mesh):
    """Sequence-parallel prefill (SP_PREFILL_INPUT_RULES): each rank holds
    16 / model tokens; the logits within test_parallel.py's 1e-3 / 1e-4."""
    B, T = 2, 16
    ids = (np.arange(B * T, dtype=np.int32).reshape(B, T) * 5) % TINY["vocab_size"]
    want = np.asarray(_jax_tiny().run(gpt2_feed(TINY, ids), ["logits"])[0])
    for out in _ranks(request, mesh)["sp_prefill"]:
        assert int(out["local_tokens"]) == T // mesh[1]
        np.testing.assert_allclose(out["logits"], want, rtol=1e-3, atol=1e-4)


def test_sharded_generator_matches_jax(ranks_12):
    """test_parallel.py's Generator with sharded weights as constant
    inputs: the JAX package's unsharded tokens on every rank."""
    from rten_tpu.generate import Generator, GeneratorConfig

    want = Generator(_jax_tiny(), [[3, 17, 5, 40]], GeneratorConfig(bucket_size=8)).generate(6)
    for out in ranks_12["generator"]:
        np.testing.assert_array_equal(out["tokens"], np.asarray(want[0]))


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)])
@pytest.mark.parametrize("dispatch", ["dense", "capacity"])
def test_moe_expert_parallel(request, mesh, dispatch):
    """MOE_EP_RULES: each rank holds its experts; the logits within 1e-5
    relative of the port's unsharded forward and within test_moe_ep.py's
    1e-4 / 1e-5 of the JAX package's."""
    from rten_tpu.models import moe as jmoe

    capacity = dispatch == "capacity"
    _, tg = moe_graph(capacity)
    cfg = jmoe.MoEConfig(n_layer=1 if capacity else 2, n_experts=4, top_k=2)
    jg = jmoe.build_graph(cfg, jmoe.random_weights(cfg, seed=10 if capacity else 7))
    if capacity:
        for _, op in jg.operators():
            if op.op_type == "MoE":
                op.attrs.update(dispatch="capacity", capacity_factor=4.0)
    want = np.asarray(JModel(jg, JOptions(optimize=True)).run(moe_feed(cfg))[0])
    for out in _ranks(request, mesh)["moe"]:
        assert set(out[f"{dispatch}_roles"].tolist()) == {"expert"}
        got, plain = out[dispatch], out[f"{dispatch}_want"]
        np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5 * np.abs(plain).max())
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


# --- ONNX exports with decomposed norms (test_pattern_fusions.py's TP cases) ----------


def _export_two_layer(tmp_path, opset, seed):
    import torch

    import test_pattern_fusions as tpf
    from onnx_export_util import export_onnx

    torch.manual_seed(seed)
    m = tpf._TwoLayerTransformer()
    ids = torch.arange(10, dtype=torch.long).reshape(2, 5) % 96
    return export_onnx(m, ids, str(tmp_path / f"t{opset}_{seed}.onnx"), ["ids"], ["logits"],
                       opset_version=opset)


@pytest.mark.parametrize("opset", [11, 13])
def test_tp_derivation_old_opset_matches_new(tmp_path, opset):
    """The port's optimizer restores the norms an old opset decomposes, so
    its derived plan is the opset-17 export's and the JAX package's: 2
    blocks x (qkv col + proj row + fc col + proj row) + lm_head."""
    from rten_tpu.model import Model as JM

    old, new = (_export_two_layer(tmp_path, o, 0) for o in (opset, 17))
    kinds = [sorted(tsh.derive_tp_plan(TModel.load_file(p, device="cpu").graph).values())
             for p in (old, new)]
    assert kinds[0] == kinds[1]
    assert (kinds[0].count("col"), kinds[0].count("row"), kinds[0].count("lm_head")) == (4, 4, 1)
    assert tsh.derive_tp_plan(TModel.load_file(old, device="cpu").graph) == jsh.derive_tp_plan(
        JM.load_file(old).graph)


def test_tp_sharded_numerics_old_opset(tmp_path):
    """The opset-11 export sharded over two ranks with the derived plan:
    within the JAX test's rtol 2e-4 / atol 1e-5 of the JAX package's
    unsharded forward."""
    from rten_tpu.model import Model as JM

    path = _export_two_layer(tmp_path, 11, 1)
    ids = (np.arange(10).reshape(2, 5) % 96).astype(np.int64)
    want = np.asarray(JM.load_file(path).run({"ids": ids})[0])
    outs = run_ranks(tmp_path / "ranks", 2, (1, 2), ["onnx_tp"], model_file=path)["onnx_tp"]
    for out in outs:
        np.testing.assert_allclose(out["logits"], want, rtol=2e-4, atol=1e-5)
        assert "row" in out["roles"].tolist()
