"""GPT-2 built in engine IR for the serving engine (the port of
``rten_tpu/models/gpt2.py``).

Only the serving graph of the main path is built here: int8 KV caches in
cat layout ``[slots, cap, H*D]`` with per-position scales
``[slots, H, cap, 1]``, the new KV row appended inside the decode attention
kernel, and the lm_head run on one gathered row per slot. The builder
issues the same sequence of builder calls as the JAX package's
``build_graph_static_cache`` on that branch, so both graphs have the same
node ids, names and constants for the same weights. Every other option
raises ``NotImplementedError`` naming the ROADMAP.md item that lifts it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from ..dtypes import DataType
from ..ir.builder import GraphBuilder
from ..ir.graph import Graph


@dataclasses.dataclass
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    layer_norm_epsilon: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head


# Standard HF checkpoints: gpt2 (124M), gpt2-medium (355M), ...
CONFIGS = {
    "gpt2": GPT2Config(),
    "gpt2-medium": GPT2Config(n_embd=1024, n_layer=24, n_head=16),
    "gpt2-large": GPT2Config(n_embd=1280, n_layer=36, n_head=20),
    "gpt2-xl": GPT2Config(n_embd=1600, n_layer=48, n_head=25),
}


def build_graph_static_cache(
    cfg: GPT2Config, weights: Dict[str, np.ndarray], capacity: int,
    kv_quant: bool = False, deferred_kv: bool = False,
    recent_dtype: "DataType" = None, kv_dtype: "DataType" = None,
    kv_bits: int = 8, lora_rank: int = 0, n_adapters: int = 0,
    paged_blocks: int = 0, block_size: int = 64,
    kernel_append: bool = False, gather_last: bool = False,
) -> Graph:
    """Serving graph with preallocated slot-major int8 KV caches.

    Inputs: input_ids [slots, T], past_lens [slots], position_ids
    [slots, T], last_pos [slots], past_key_values.N.{key,value}
    [slots, cap, H*D] s8 and past_key_values.N.{key,value}_scale
    [slots, H, cap, 1] f32. Outputs: logits [slots, 1, V], the updated
    caches present.N.*, and next_token [slots, 1] (greedy, on device).

    Supported: ``kv_quant=True, kv_bits=8, kernel_append=True,
    gather_last=True`` with everything else at its default.
    """
    if paged_blocks:
        raise NotImplementedError("paged KV caches: ROADMAP.md queue 1 item 8")
    if deferred_kv or recent_dtype is not None:
        raise NotImplementedError("deferred KV: ROADMAP.md queue 1 item 9")
    if lora_rank or n_adapters:
        raise NotImplementedError("multi-LoRA serving: ROADMAP.md queue 1 item 9")
    if not kv_quant or kv_dtype is not None:
        raise NotImplementedError(
            "f32/bf16 KV caches (GroupQueryAttention serving): "
            "ROADMAP.md queue 1 item 7"
        )
    if kv_bits != 8:
        raise NotImplementedError("int4 KV caches: ROADMAP.md queue 1 item 11")
    if not kernel_append:
        raise NotImplementedError(
            "head-major KV caches without in-kernel append: "
            "ROADMAP.md queue 1 item 7"
        )
    if not gather_last:
        raise NotImplementedError(
            "full-bucket lm_head (gather_last=False): ROADMAP.md queue 1 item 10"
        )
    b = GraphBuilder()
    E, H, D = cfg.n_embd, cfg.n_head, cfg.head_dim

    def w(name):
        return b.constant(name, np.ascontiguousarray(weights[name], np.float32))

    ids = b.input("input_ids", DataType.Int32, ("slots", "seq"))
    past_lens = b.input("past_lens", DataType.Int32, ("slots",))
    pos = b.input("position_ids", DataType.Int32, ("slots", "seq"))

    x = b.op("Gather", [w("transformer.wte.weight"), ids])
    x = x + b.op("Gather", [w("transformer.wpe.weight"), pos])

    def layer_norm(h, prefix):
        return b.op(
            "LayerNormalization",
            [h, w(f"{prefix}.weight"), w(f"{prefix}.bias")],
            {"epsilon": cfg.layer_norm_epsilon},
        )

    presents = []
    for i in range(cfg.n_layer):
        p = f"transformer.h.{i}"
        h = layer_norm(x, f"{p}.ln_1")
        qkv = b.op(
            "MatMulAdd", [h, w(f"{p}.attn.c_attn.weight"), w(f"{p}.attn.c_attn.bias")],
            name=f"{p}.attn.c_attn",
        )
        q, k, v = b.op("Split", [qkv], {"axis": -1, "num_outputs": 3}, n_outputs=3)
        kv_shape = ("slots", capacity, H * D)
        past_k = b.input(f"past_key_values.{i}.key", DataType.Int8, kv_shape)
        k_sc = b.input(
            f"past_key_values.{i}.key_scale", DataType.Float,
            ("slots", H, capacity, 1),
        )
        past_v = b.input(f"past_key_values.{i}.value", DataType.Int8, kv_shape)
        v_sc = b.input(
            f"past_key_values.{i}.value_scale", DataType.Float,
            ("slots", H, capacity, 1),
        )
        attn, pk, pks, pv, pvs = b.op(
            "QuantizedKVAttention",
            [q, k, v, past_k, k_sc, past_v, v_sc, past_lens],
            {"num_heads": H, "bits": kv_bits, "rten_kernel_append": 1},
            n_outputs=5,
            output_names=[
                f"attn_out_{i}", f"present.{i}.key", f"present.{i}.key_scale",
                f"present.{i}.value", f"present.{i}.value_scale",
            ],
        )
        presents.extend([pk, pks, pv, pvs])
        proj = b.op(
            "MatMulAdd",
            [attn, w(f"{p}.attn.c_proj.weight"), w(f"{p}.attn.c_proj.bias")],
            name=f"{p}.attn.c_proj",
        )
        x = x + proj
        h2 = layer_norm(x, f"{p}.ln_2")
        fc = b.op(
            "MatMulAdd", [h2, w(f"{p}.mlp.c_fc.weight"), w(f"{p}.mlp.c_fc.bias")],
            name=f"{p}.mlp.c_fc",
        )
        act = b.op("Gelu", [fc], {"approximate": "tanh"})
        mlp = b.op(
            "MatMulAdd", [act, w(f"{p}.mlp.c_proj.weight"), w(f"{p}.mlp.c_proj.bias")],
            name=f"{p}.mlp.c_proj",
        )
        x = x + mlp

    x = layer_norm(x, "transformer.ln_f")
    # Serving prefill needs only the prompt-final position's logits: gather
    # one row per slot before the lm_head; decode steps feed last_pos = 0.
    last_pos = b.input("last_pos", DataType.Int32, ("slots",))
    idx3 = b.op(
        "Reshape",
        [last_pos, b.constant("last_pos_shape", np.array([0, 1, 1], np.int64))],
    )
    x = b.op("GatherND", [x, idx3], {"batch_dims": 1})  # [slots,1,E]
    lm_w = b.constant(
        "lm_head.weight_t",
        np.ascontiguousarray(weights["transformer.wte.weight"].T, np.float32),
    )
    logits = b.op("MatMul", [x, lm_w], name="lm_head", output_names=["logits"])
    # On-device greedy token: [slots, T] ints instead of [slots, T, V] logits.
    next_tok = b.op(
        "ArgMax", [logits], {"axis": -1, "keepdims": 0},
        output_names=["next_token"],
    )
    b.output(logits, *presents)
    b.graph.output_ids.append(next_tok.node_id)
    return b.finish()


def random_weights(cfg: GPT2Config, seed: int = 0) -> Dict[str, np.ndarray]:
    """GPT-2-initialization random weights from a seed (same shapes and
    names as HF `GPT2LMHeadModel.state_dict()`, Conv1D weights [in, out]);
    the same arrays as ``rten_tpu.models.gpt2.random_weights`` for the same
    seed."""
    rng = np.random.default_rng(seed)
    E = cfg.n_embd
    wdict: Dict[str, np.ndarray] = {}

    def nrm(*shape, std=0.02):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    wdict["transformer.wte.weight"] = nrm(cfg.vocab_size, E)
    wdict["transformer.wpe.weight"] = nrm(cfg.n_positions, E, std=0.01)
    for i in range(cfg.n_layer):
        p = f"transformer.h.{i}"
        wdict[f"{p}.ln_1.weight"] = np.ones(E, np.float32)
        wdict[f"{p}.ln_1.bias"] = np.zeros(E, np.float32)
        wdict[f"{p}.attn.c_attn.weight"] = nrm(E, 3 * E)
        wdict[f"{p}.attn.c_attn.bias"] = np.zeros(3 * E, np.float32)
        wdict[f"{p}.attn.c_proj.weight"] = nrm(E, E, std=0.02 / np.sqrt(2 * cfg.n_layer))
        wdict[f"{p}.attn.c_proj.bias"] = np.zeros(E, np.float32)
        wdict[f"{p}.ln_2.weight"] = np.ones(E, np.float32)
        wdict[f"{p}.ln_2.bias"] = np.zeros(E, np.float32)
        wdict[f"{p}.mlp.c_fc.weight"] = nrm(E, 4 * E)
        wdict[f"{p}.mlp.c_fc.bias"] = np.zeros(4 * E, np.float32)
        wdict[f"{p}.mlp.c_proj.weight"] = nrm(4 * E, E, std=0.02 / np.sqrt(2 * cfg.n_layer))
        wdict[f"{p}.mlp.c_proj.bias"] = np.zeros(E, np.float32)
    wdict["transformer.ln_f.weight"] = np.ones(E, np.float32)
    wdict["transformer.ln_f.bias"] = np.zeros(E, np.float32)
    return wdict
