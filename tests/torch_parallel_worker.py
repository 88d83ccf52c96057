"""One rank of the port's multi-process tests (not collected by pytest).

    python tests/torch_parallel_worker.py RANK WORLD STORE OUT DATA MODEL CASE...

joins a gloo group of WORLD processes through the file store STORE (every
wait bounded by the group's timeout), makes a MeshConfig(DATA, MODEL) mesh
on the CPU (every rank on the device ``RTEN_RANK_DEVICE`` names, where it
is set) and runs each CASE, writing its arrays to OUT/CASE.RANK.npz.
The cases import only the port: the parent test holds their results
against the JAX package's, which it computes itself. ``run_ranks`` starts
the ranks from a test and collects their results.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GROUP_TIMEOUT_S = 60


def run_ranks(tmp_path, world, mesh, cases, timeout=120, device="cpu", model_file=None):
    """Start ``world`` ranks running ``cases`` on a ``mesh`` (data, model),
    every rank on ``device`` (``model_file``: a file the cases load), and
    wait for them (at most ``timeout``
    seconds, after which every rank is killed and the test fails with their
    output); returns {case: [each rank's arrays]}."""
    store = tmp_path / "store"
    out = tmp_path / "out"
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", RTEN_RANK_DEVICE=device,
               RTEN_RANK_MODEL_FILE=str(model_file or ""))
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_parallel_worker.py"), str(rank), str(world),
         str(store), str(out), str(mesh[0]), str(mesh[1]), *cases],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=os.path.dirname(HERE)) for rank in range(world)]
    logs = []
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            try:
                logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
            except subprocess.TimeoutExpired:
                logs.append("(timed out)")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed (rc {p.returncode}):\n{log[-4000:]}"
    return {c: [dict(np.load(out / f"{c}.{rank}.npz")) for rank in range(world)]
            for c in cases}


# --- shared model builders ------------------------------------------------------

TINY = dict(vocab_size=96, n_positions=64, n_embd=64, n_layer=2, n_head=8)
SERVE_INT8 = dict(vocab_size=500, n_positions=128, n_embd=128, n_layer=2, n_head=2)
INT8_TP = dict(vocab_size=128, n_positions=64, n_embd=64, n_layer=2, n_head=8)
LLAMA = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)
MAIN_PATH = dict(capacity=64, kv_quant=True, kernel_append=True, gather_last=True)


def gpt2_feed(cfg, ids):
    """The f32 GPT-2 graph's whole feed for ``ids`` [B, T], empty caches."""
    B, T = ids.shape
    feed = {
        "input_ids": ids.astype(np.int32),
        "attention_mask": np.ones((B, T), np.int32),
        "position_ids": np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy(),
    }
    D = cfg["n_embd"] // cfg["n_head"]
    for i in range(cfg["n_layer"]):
        for kv in ("key", "value"):
            feed[f"past_key_values.{i}.{kv}"] = np.zeros((B, cfg["n_head"], 0, D), np.float32)
    return feed


def sharpened_gpt2(cfg, seed, sharpen):
    from rten_tpu_torch.models import gpt2

    w = gpt2.random_weights(gpt2.GPT2Config(**cfg), seed)
    return {k: v * np.float32(sharpen) if (".attn." in k or ".mlp." in k) else v
            for k, v in w.items()}


def serve_prompts(vocab, seed=0, n=5):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, int(rng.integers(3, 12))).tolist(), int(rng.integers(3, 14)))
            for _ in range(n)]


def moe_feed(cfg, B=4, T=8, seed=0):
    rng = np.random.default_rng(seed)
    feed = {
        "input_ids": rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
        "attention_mask": np.ones((B, T), np.int32),
        "position_ids": np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy(),
    }
    for i in range(cfg.n_layer):
        z = np.zeros((B, cfg.n_head, 0, cfg.head_dim), np.float32)
        feed[f"past_key_values.{i}.key"] = z
        feed[f"past_key_values.{i}.value"] = z.copy()
    return feed


def moe_graph(capacity: bool):
    from rten_tpu_torch.models import moe

    cfg = moe.MoEConfig(n_layer=1 if capacity else 2, n_experts=4, top_k=2)
    g = moe.build_graph(cfg, moe.random_weights(cfg, seed=10 if capacity else 7))
    if capacity:
        for _, op in g.operators():
            if op.op_type == "MoE":
                op.attrs["dispatch"] = "capacity"
                op.attrs["capacity_factor"] = 4.0
    return cfg, g


def pipeline_model(n_layer=4):
    from rten_tpu_torch.model import Model, ModelOptions
    from rten_tpu_torch.models import gpt2

    cfg = dict(vocab_size=97, n_positions=32, n_embd=32, n_layer=n_layer, n_head=4)
    w = gpt2.random_weights(gpt2.GPT2Config(**cfg), seed=3)
    g = gpt2.build_graph(gpt2.GPT2Config(**cfg), w)
    return cfg, Model(g, ModelOptions(optimize=False), device="cpu")


def pipeline_feed(cfg, B=4, T=8):
    rng = np.random.default_rng(0)
    feed = gpt2_feed(cfg, rng.integers(0, cfg["vocab_size"], (B, T)))
    return feed


def ring_inputs(gqa: bool):
    rng = np.random.default_rng(1 if gqa else 0)
    if gqa:
        B, Hq, Hkv, T, D = 1, 8, 2, 16, 8
    else:
        B, Hq, Hkv, T, D = 2, 3, 3, 32, 16
    q = rng.standard_normal((B, Hq, T, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, T, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, T, D)).astype(np.float32)
    return q, k, v


# --- the cases ----------------------------------------------------------------------


def _tiny_model():
    from rten_tpu_torch.models import gpt2

    cfg = gpt2.GPT2Config(**TINY)
    return gpt2.load(cfg, gpt2.random_weights(cfg, seed=3), device="cpu")


def case_process_info(mesh):
    from rten_tpu_torch.parallel import process_info

    info = process_info()
    return {k: np.int64(v) for k, v in info.items()} | {
        "coords": np.array([mesh.coords["data"], mesh.coords["model"]])}


def case_tp_forward(mesh):
    """test_parallel.py's TP(+DP) forward: name rules, input rules."""
    from rten_tpu_torch.parallel import GPT2_INPUT_RULES, shard_constants, shard_inputs

    model = _tiny_model()
    g = model.graph
    ids = np.arange(2 * 8, dtype=np.int32).reshape(2, 8) % TINY["vocab_size"]
    params = shard_constants(g, mesh)
    feed = shard_inputs(g, mesh, {g.find_node(k): v for k, v in gpt2_feed(TINY, ids).items()},
                        GPT2_INPUT_RULES)
    feed.update(params)
    local = params.model
    logits = local.executor.run(feed, [g.find_node("logits")])[0]
    roles = sorted(local.roles.values())
    return {"logits": logits.numpy(), "roles": np.array(roles)}


def case_tp_derived(mesh):
    """The derived plan (tp_weight_shardings) on the same model."""
    from rten_tpu_torch.parallel import shard_constants_by_plan, tp_weight_shardings

    model = _tiny_model()
    g = model.graph
    B, T = 2, 8
    ids = np.arange(B * T, dtype=np.int32).reshape(B, T) % TINY["vocab_size"]
    params = shard_constants_by_plan(g, mesh, tp_weight_shardings(g, mesh))
    logits = params.model.run_whole(gpt2_feed(TINY, ids), ["logits"])[0]
    return {"logits": logits.numpy()}


def case_sp_prefill(mesh):
    """Sequence-parallel prefill: weights replicated, tokens cut."""
    from rten_tpu_torch.parallel import SP_PREFILL_INPUT_RULES, shard_constants, shard_inputs

    model = _tiny_model()
    g = model.graph
    B, T = 2, 16
    ids = (np.arange(B * T, dtype=np.int32).reshape(B, T) * 5) % TINY["vocab_size"]
    params = shard_constants(g, mesh, rules=[], input_rules=SP_PREFILL_INPUT_RULES)
    feed = shard_inputs(g, mesh, {g.find_node(k): v for k, v in gpt2_feed(TINY, ids).items()},
                        SP_PREFILL_INPUT_RULES)
    local_ids = feed[g.find_node("input_ids")]
    feed.update(params)
    logits = params.model.executor.run(feed, [g.find_node("logits")])[0]
    return {"logits": logits.numpy(), "local_tokens": np.int64(local_ids.shape[1])}


def _engine(model, n_head, head_dim, params=None, **kw):
    from rten_tpu_torch.serving import ContinuousBatchingEngine

    kw = {"slots": 3, "capacity": 64, "prefill_bucket": 8, "greedy_on_device": True,
          "steps_per_dispatch": 4, **kw}
    return ContinuousBatchingEngine(model, n_layer=2, n_head=n_head, head_dim=head_dim,
                                    params=params, **kw)


def _serve(engine, prompts):
    reqs = [engine.submit(p, max_new_tokens=n) for p, n in prompts]
    engine.run()
    return [r.generated for r in reqs]


def _tokens_array(tokens):
    return np.array([t + [-1] * (16 - len(t)) for t in tokens], np.int64)


def case_serve_f32(mesh):
    """test_serving_sharded.py's engine: f32 static caches, name rules."""
    from rten_tpu_torch.model import Model
    from rten_tpu_torch.models import gpt2
    from rten_tpu_torch.parallel import shard_constants

    cfg = dict(TINY)
    w = gpt2.random_weights(gpt2.GPT2Config(**cfg), seed=5)
    graph = gpt2.build_graph_static_cache(gpt2.GPT2Config(**cfg), w, capacity=64)
    model = Model(graph, device="cpu")
    params = shard_constants(model.graph, mesh)
    eng = _engine(model, 8, 8, params, slots=2, steps_per_dispatch=2)
    toks = _serve(eng, [([5, 9, 23], 6), ([40, 7, 12, 3], 6)])
    heads = [s for s in eng._cache_alloc[0][0]]
    return {"tokens": _tokens_array(toks), "cache_shape": np.array(heads)}


def _int8_serving_model(sharpen):
    from rten_tpu_torch.model import Model
    from rten_tpu_torch.models import gpt2
    from rten_tpu_torch.quantize_pass import quantize_dynamic

    w = sharpened_gpt2(SERVE_INT8, 0, sharpen)
    g = gpt2.build_graph_static_cache(gpt2.GPT2Config(**SERVE_INT8), w, **MAIN_PATH)
    quantize_dynamic(g)
    return Model(g, device="cpu")


def case_serve_int8(mesh):
    """The main path's int8 cat kernel-append graph (a padded lm_head:
    vocab 500 in 512 columns), derived plan: engine tokens, and one
    admission forward's logits and token against the unsharded model's."""
    from rten_tpu_torch.parallel import shard_constants_by_plan, tp_weight_shardings

    out = {}
    for sharpen in (1.0, 10.0):
        model = _int8_serving_model(sharpen)
        g = model.graph
        params = shard_constants_by_plan(g, mesh, tp_weight_shardings(g, mesh))
        local = params.model
        toks = _serve(_engine(model, 2, 64, params), serve_prompts(SERVE_INT8["vocab_size"]))
        out[f"tokens_{sharpen:g}"] = _tokens_array(toks)
        # One admission forward on both graphs: logits bit-equal.
        rng = np.random.default_rng(3)
        slots, T = 3, 8
        feed = {"input_ids": rng.integers(0, 500, (slots, T)).astype(np.int32),
                "past_lens": np.zeros(slots, np.int32),
                "position_ids": np.tile(np.arange(T, dtype=np.int32), (slots, 1)),
                "last_pos": np.array([7, 3, 5], np.int32)}
        for name in (n for n in model.input_names() if n.startswith("past_key_values.")):
            node = g.nodes[g.find_node(name)]
            lnode = local.graph.nodes[local.graph.find_node(name)]
            feed_whole = np.zeros((slots,) + tuple(node.shape[1:]), node.dtype.np_dtype)
            out[f"cache_{name}"] = np.array((slots,) + tuple(lnode.shape[1:]))
            feed[name] = feed_whole
        want = model.run(feed, ["logits", "next_token"])
        lfeed = {k: (np.zeros((slots,) + tuple(local.graph.nodes[local.graph.find_node(k)]
                                                .shape[1:]), v.dtype)
                     if k.startswith("past_key_values.") else v) for k, v in feed.items()}
        got = local.run(lfeed, ["logits", "next_token"])
        out[f"logits_{sharpen:g}"] = got[0].numpy()
        out[f"want_logits_{sharpen:g}"] = want[0].numpy()
        out[f"token_{sharpen:g}"] = got[1].numpy()
        out[f"want_token_{sharpen:g}"] = want[1].numpy()
    out["ops"] = np.array(sorted({op.op_type for _, op in local.graph.operators()}))
    return out


def case_int8_tp(mesh):
    """test_int8_tp.py's quantized sharded engine (f32 static caches)."""
    from rten_tpu_torch.model import Model
    from rten_tpu_torch.models import gpt2
    from rten_tpu_torch.parallel import shard_constants_by_plan, tp_weight_shardings
    from rten_tpu_torch.quantize_pass import quantize_dynamic

    cfg = gpt2.GPT2Config(**INT8_TP)
    graph = gpt2.build_graph_static_cache(cfg, gpt2.random_weights(cfg, seed=11), capacity=64)
    quantize_dynamic(graph)
    model = Model(graph, device="cpu")
    params = shard_constants_by_plan(model.graph, mesh, tp_weight_shardings(model.graph, mesh))
    eng = _engine(model, 8, 8, params, slots=2, steps_per_dispatch=2)
    return {"tokens": _tokens_array(_serve(eng, [([5, 9, 23], 8), ([40, 7, 12, 3], 8)]))}


def llama_serving_model():
    from rten_tpu_torch.model import Model
    from rten_tpu_torch.models import llama
    from rten_tpu_torch.quantize_pass import quantize_dynamic

    w = llama.random_weights(llama.LlamaConfig(**LLAMA), 0)
    w = {k: v * np.float32(2.0) if "_proj." in k else v for k, v in w.items()}
    g = llama.build_graph_static_cache(llama.LlamaConfig(**LLAMA), w, capacity=64,
                                       kv_quant=True, gather_last=True)
    quantize_dynamic(g)
    return Model(g, device="cpu")


def case_llama(mesh):
    """A small Llama (4 query heads over 2 KV heads), int8 weights and KV,
    derived plan: engine tokens."""
    from rten_tpu_torch.parallel import shard_constants_by_plan, tp_weight_shardings

    model = llama_serving_model()
    params = shard_constants_by_plan(model.graph, mesh, tp_weight_shardings(model.graph, mesh))
    eng = _engine(model, 4, 16, params)
    toks = _serve(eng, serve_prompts(LLAMA["vocab_size"], seed=2))
    return {"tokens": _tokens_array(toks), "roles": np.array(sorted(params.model.roles.values()))}


def case_sampler(mesh):
    """A DeviceSampler wave on the sharded int8 engine: every rank's tokens."""
    from rten_tpu_torch.generate.sampler import DeviceSampler
    from rten_tpu_torch.parallel import shard_constants_by_plan, tp_weight_shardings

    model = _int8_serving_model(10.0)
    params = shard_constants_by_plan(model.graph, mesh, tp_weight_shardings(model.graph, mesh))
    ds = DeviceSampler(temperature=0.8, top_k=40, seed=0)
    eng = _engine(model, 2, 64, params, device_sampler=ds, greedy_on_device=False)
    sharded = _serve(eng, serve_prompts(SERVE_INT8["vocab_size"], seed=4))
    plain = _serve(_engine(model, 2, 64, device_sampler=DeviceSampler(temperature=0.8, top_k=40,
                                                                        seed=0),
                           greedy_on_device=False),
                   serve_prompts(SERVE_INT8["vocab_size"], seed=4))
    return {"tokens": _tokens_array(sharded), "plain": _tokens_array(plain)}


def case_generator(mesh):
    """test_parallel.py's Generator with sharded constant inputs."""
    from rten_tpu_torch.generate import Generator, GeneratorConfig
    from rten_tpu_torch.parallel import shard_constants

    model = _tiny_model()
    params = shard_constants(model.graph, mesh)
    gen = Generator(model, [[3, 17, 5, 40]],
                    GeneratorConfig(bucket_size=8, constant_inputs=params.by_name()))
    return {"tokens": np.asarray(gen.generate(6)[0], np.int64)}


def case_moe(mesh):
    """Expert parallelism (MOE_EP_RULES), dense and capacity dispatch:
    the sharded logits and the port's unsharded ones."""
    from rten_tpu_torch.model import Model, ModelOptions
    from rten_tpu_torch.parallel import MOE_EP_RULES, shard_constants

    out = {}
    for capacity in (False, True):
        cfg, g = moe_graph(capacity)
        m = Model(g, ModelOptions(optimize=True), device="cpu")
        feed = moe_feed(cfg)
        params = shard_constants(m.graph, mesh, rules=MOE_EP_RULES)
        tag = "capacity" if capacity else "dense"
        out[f"{tag}_want"] = m.run(feed, ["logits"])[0].numpy()
        out[tag] = params.model.run_whole(feed, ["logits"])[0].numpy()
        out[f"{tag}_roles"] = np.array(sorted(params.model.roles.values()))
    return out


def case_pipeline(mesh):
    """GPipe over the model axis: M = the axis size microbatches."""
    from rten_tpu_torch.parallel import PipelineRunner

    cfg, model = pipeline_model()
    S = mesh.shape["model"]
    runner = PipelineRunner(model, mesh, axis="model", n_micro=S)
    feed = pipeline_feed(cfg)
    return {"logits": runner.run(feed).numpy(), "want": model.run(feed)[0].numpy()}


def case_ring(mesh):
    from rten_tpu_torch.parallel.ring import ring_attention

    out = {}
    for causal in (True, False):
        q, k, v = ring_inputs(False)
        out[f"causal_{causal}"] = ring_attention(q, k, v, mesh, causal=causal).numpy()
    q, k, v = ring_inputs(True)
    out["gqa"] = ring_attention(q, k, v, mesh, causal=True).numpy()
    try:
        x = np.zeros((1, 1, mesh.shape["model"] * 3 + 1, 8), np.float32)
        ring_attention(x, x, x, mesh)
        out["indivisible"] = np.array("no error")
    except ValueError as e:
        out["indivisible"] = np.array(str(e))
    return out


def case_onnx_tp(mesh):
    """An ONNX export (``RTEN_RANK_MODEL_FILE``) loaded and optimized by the
    port, cut by the derived plan: the logits of ids [2, 5]."""
    from rten_tpu_torch.model import Model
    from rten_tpu_torch.parallel import shard_constants_by_plan, tp_weight_shardings

    model = Model.load_file(os.environ["RTEN_RANK_MODEL_FILE"], device="cpu")
    g = model.graph
    params = shard_constants_by_plan(g, mesh, tp_weight_shardings(g, mesh))
    ids = (np.arange(10).reshape(2, 5) % 96).astype(np.int64)
    out = params.model.run_whole({g.node_name(g.input_ids[0]): ids},
                                 [g.node_name(g.output_ids[0])])[0]
    return {"logits": out.numpy(), "roles": np.array(sorted(params.model.roles.values()))}


def case_card_wave(mesh):
    """The main path's int8 graph served over the ranks on one card (gloo):
    the sharded tokens, the unsharded engine's on the same card, and the
    rank's launches of the int8 kernel's int32 mode and of the argmax."""
    from rten_tpu_torch.kernels.argmax import argmax_lastdim
    from rten_tpu_torch.kernels.int8_matmul import int8_matmul_dequant
    from rten_tpu_torch.model import Model
    from rten_tpu_torch.parallel import shard_constants_by_plan, tp_weight_shardings

    cpu = _int8_serving_model(10.0)
    model = Model(cpu.graph, device=mesh.device)
    plain = _serve(_engine(model, 2, 64), serve_prompts(SERVE_INT8["vocab_size"]))
    params = shard_constants_by_plan(model.graph, mesh, tp_weight_shardings(model.graph, mesh))
    i32, am = int8_matmul_dequant.int32_launches, argmax_lastdim.launches
    sharded = _serve(_engine(model, 2, 64, params), serve_prompts(SERVE_INT8["vocab_size"]))
    return {"tokens": _tokens_array(sharded), "plain": _tokens_array(plain),
            "int32_launches": np.int64(int8_matmul_dequant.int32_launches - i32),
            "argmax_launches": np.int64(argmax_lastdim.launches - am)}


CASES = {n[len("case_"):]: f for n, f in globals().items() if n.startswith("case_")}


def main():
    rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    data, model, cases = int(sys.argv[5]), int(sys.argv[6]), sys.argv[7:]
    sys.path.insert(0, os.path.dirname(HERE))
    import torch

    torch.set_num_threads(1)
    from rten_tpu_torch.parallel import MeshConfig, init_distributed, make_mesh

    init_distributed(backend="gloo", init_method=f"file://{store}", world_size=world,
                     rank=rank, timeout=GROUP_TIMEOUT_S)
    mesh = make_mesh(MeshConfig(data, model), device=os.environ.get("RTEN_RANK_DEVICE", "cpu"))
    for case in cases:
        np.savez(os.path.join(out, f"{case}.{rank}.npz"), **CASES[case](mesh))
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    print(f"RANK_{rank}_OK", flush=True)


if __name__ == "__main__":
    main()
