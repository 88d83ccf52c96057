"""GPT-2 built in engine IR (the port of ``rten_tpu/models/gpt2.py``).

``build_graph`` is the Optimum-style KV-cached causal-LM graph the
Generator drives (inputs input_ids / attention_mask / position_ids /
past_key_values.N.{key,value} [B, H, past, D], outputs logits /
present.N.*); ``load`` builds it, optionally quantized (int8 dynamic or
int4 weight-only), into a ``Model``; ``weights_from_torch`` reads a
transformers GPT2LMHeadModel. The same builder calls as the JAX package's,
so both graphs have the same node ids, names and constants.

``build_graph_static_cache`` builds the serving graph, the lm_head run on
one gathered row per slot. Its KV caches: int8 (``kv_quant=True``) with
per-position scales ``[slots, H, cap, 1]``, int4 (``kv_bits=4``: u8
nibbles at D/2 lanes, the same scales; ``bench.py``'s ``RTEN_BENCH_KV=int4``
graph), or f32 or bf16 (``kv_dtype=BFloat16``, ``bench.py``'s
``RTEN_BENCH_KV=bf16`` graph) with none; in cat layout ``[slots, cap,
H*D]`` with ``kernel_append`` (the new KV row appended inside the decode
attention kernel) or head-major ``[slots, H, cap, D]`` without; with
``paged_blocks`` the same on block pools ``[paged_blocks, block_size,
H*D]`` or ``[paged_blocks, H, block_size, D]`` (scale pools
``[paged_blocks, H, 1, block_size]``) and a ``block_table`` input
(``bench.py``'s ``RTEN_BENCH_PAGED`` graph). ``deferred_kv`` adds a
``step_t`` input and per-layer recent windows ``recent.N.{key,value}``
``[slots, H, recent, D]`` in ``recent_dtype`` (f32 by default) with their
``recent_present.N.*`` outputs: decode steps keep their rows there and the
engine commits them once per dispatch. The builder issues the same sequence
of builder calls as the JAX package's ``build_graph_static_cache`` on each
branch, so both graphs have the same node ids, names and constants for the
same weights. LoRA and the full-bucket lm_head raise
``NotImplementedError`` naming the ROADMAP.md item that lifts them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from ..dtypes import DataType
from ..ir.builder import GraphBuilder
from ..ir.graph import Graph
from ..model import Model, ModelOptions
from ..quantize_pass import quantize_dynamic, quantize_weight_only_int4


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


def build_graph(cfg: GPT2Config, weights: Dict[str, np.ndarray]) -> Graph:
    """Build the KV-cached causal-LM graph (``rten_tpu/models/gpt2.py:49-148``)."""
    b = GraphBuilder()
    E, H, D = cfg.n_embd, cfg.n_head, cfg.head_dim

    def w(name):
        return b.constant(name, np.ascontiguousarray(weights[name], np.float32))

    ids = b.input("input_ids", DataType.Int32, ("batch", "seq"))
    mask = b.input("attention_mask", DataType.Int32, ("batch", "total_seq"))
    pos = b.input("position_ids", DataType.Int32, ("batch", "seq"))

    x = b.op("Gather", [w("transformer.wte.weight"), ids])
    x = x + b.op("Gather", [w("transformer.wpe.weight"), pos])

    # Additive attention mask [B,1,1,S]: 0 keep, -1e30 drop.
    mask_f = b.op("Cast", [mask], {"to": DataType.Float})
    neg = b.constant(None, np.float32(-1e30))
    one = b.constant(None, np.float32(1.0))
    add_mask = b.op("Mul", [b.op("Sub", [one, mask_f]), neg])
    add_mask = b.op("Unsqueeze", [add_mask, b.constant(None, np.int32([1, 2]))])

    def layer_norm(h, prefix):
        return b.op(
            "LayerNormalization",
            [h, w(f"{prefix}.weight"), w(f"{prefix}.bias")],
            {"epsilon": cfg.layer_norm_epsilon},
        )

    def to_heads(h):  # [B,T,E] -> [B,H,T,D]
        r = b.op("Reshape", [h, b.constant(None, np.int32([0, 0, H, D]))])
        return b.op("Transpose", [r], {"perm": [0, 2, 1, 3]})

    def from_heads(h):
        r = b.op("Transpose", [h], {"perm": [0, 2, 1, 3]})
        return b.op("Reshape", [r, b.constant(None, np.int32([0, 0, E]))])

    presents = []
    for i in range(cfg.n_layer):
        p = f"transformer.h.{i}"
        past_k = b.input(f"past_key_values.{i}.key", DataType.Float, ("batch", H, "past_seq", D))
        past_v = b.input(f"past_key_values.{i}.value", DataType.Float,
                         ("batch", H, "past_seq", D))
        h = layer_norm(x, f"{p}.ln_1")
        qkv = b.op(
            "MatMulAdd", [h, w(f"{p}.attn.c_attn.weight"), w(f"{p}.attn.c_attn.bias")],
            name=f"{p}.attn.c_attn",
        )
        q, k, v = b.op("Split", [qkv], {"axis": -1, "num_outputs": 3}, n_outputs=3)
        q, k, v = to_heads(q), to_heads(k), to_heads(v)
        attn, pk, pv = b.op(
            "Attention", [q, k, v, add_mask, past_k, past_v], {"is_causal": 1}, n_outputs=3,
            output_names=[f"attn_out_{i}", f"present.{i}.key", f"present.{i}.value"],
        )
        presents.extend([pk, pv])
        attn = from_heads(attn)
        proj = b.op(
            "MatMulAdd", [attn, w(f"{p}.attn.c_proj.weight"), w(f"{p}.attn.c_proj.bias")],
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
    lm_w = b.constant(
        "lm_head.weight_t",
        np.ascontiguousarray(weights["transformer.wte.weight"].T, np.float32),
    )
    logits = b.op("MatMul", [x, lm_w], name="lm_head", output_names=["logits"])
    b.output(logits, *presents)
    return b.finish()


def build_graph_static_cache(
    cfg: GPT2Config, weights: Dict[str, np.ndarray], capacity: int,
    kv_quant: bool = False, deferred_kv: bool = False,
    recent_dtype: "DataType" = None, kv_dtype: "DataType" = None,
    kv_bits: int = 8, lora_rank: int = 0, n_adapters: int = 0,
    paged_blocks: int = 0, block_size: int = 64,
    kernel_append: bool = False, gather_last: bool = False,
) -> Graph:
    """Serving graph with preallocated slot-major KV caches (or block
    pools), written in place at per-slot offsets.

    Inputs: input_ids [slots, T], past_lens [slots], position_ids
    [slots, T], block_table [slots, capacity // block_size] (paged graphs),
    past_key_values.N.{key,value} (the module docstring lists the layouts)
    and, with ``kv_quant``, past_key_values.N.{key,value}_scale, last_pos
    [slots]. Outputs: logits [slots, 1, V], the updated caches present.N.*,
    and next_token [slots, 1] (greedy, on device).

    Supported: ``gather_last=True``, ``kv_quant=True`` with ``kv_bits`` 8
    or 4 or ``kv_quant=False`` with ``kv_dtype`` None (f32), Float or
    BFloat16, with or without ``kernel_append`` (8 bits or unquantized, not
    deferred), ``paged_blocks`` (8 bits or unquantized, not deferred) and
    ``deferred_kv`` (head-major caches).
    """
    if paged_blocks:
        if deferred_kv or (kv_quant and kv_bits != 8):
            raise ValueError(
                "paged_blocks is incompatible with deferred_kv and with "
                "int4 (kv_bits=4) caches"
            )
        if capacity % block_size or block_size % 8:
            raise ValueError(
                "capacity must be a multiple of block_size, and block_size "
                f"a multiple of 8 (got {capacity=}, {block_size=})"
            )
    if kernel_append and (deferred_kv or kv_bits != 8):
        raise ValueError(
            "kernel_append (in-kernel cache append) is incompatible with "
            "deferred_kv and int4 caches"
        )
    if lora_rank or n_adapters:
        raise NotImplementedError("multi-LoRA serving: ROADMAP.md queue 1 item 9")
    if not gather_last:
        raise NotImplementedError(
            "full-bucket lm_head (gather_last=False): ROADMAP.md queue 1 item 10"
        )
    b = GraphBuilder()
    E, H, D = cfg.n_embd, cfg.n_head, cfg.head_dim

    def w(name):
        return b.constant(name, np.ascontiguousarray(weights[name], np.float32))

    ka_attr = {"rten_kernel_append": 1} if kernel_append else {}

    ids = b.input("input_ids", DataType.Int32, ("slots", "seq"))
    past_lens = b.input("past_lens", DataType.Int32, ("slots",))
    pos = b.input("position_ids", DataType.Int32, ("slots", "seq"))
    block_table = (
        b.input("block_table", DataType.Int32, ("slots", capacity // block_size))
        if paged_blocks else None
    )
    step_t = b.input("step_t", DataType.Int32, (1,)) if deferred_kv else None

    x = b.op("Gather", [w("transformer.wte.weight"), ids])
    x = x + b.op("Gather", [w("transformer.wpe.weight"), pos])

    def layer_norm(h, prefix):
        return b.op(
            "LayerNormalization",
            [h, w(f"{prefix}.weight"), w(f"{prefix}.bias")],
            {"epsilon": cfg.layer_norm_epsilon},
        )

    # Cache (or pool) shapes: cat rows with kernel_append, head-major without;
    # int4 rows hold D/2 bytes.
    kv_d = D // 2 if kv_quant and kv_bits == 4 else D
    if paged_blocks:
        kv_shape = ((paged_blocks, block_size, H * D) if kernel_append
                    else (paged_blocks, H, block_size, D))
        sc_shape = (paged_blocks, H, 1, block_size)
    else:
        kv_shape = (("slots", capacity, H * kv_d) if kernel_append
                    else ("slots", H, capacity, kv_d))
        sc_shape = ("slots", H, capacity, 1)
    paged_in = [block_table] if paged_blocks else []
    paged_attr = {"rten_paged": 1} if paged_blocks else {}
    presents = []
    for i in range(cfg.n_layer):
        p = f"transformer.h.{i}"
        h = layer_norm(x, f"{p}.ln_1")
        qkv = b.op(
            "MatMulAdd", [h, w(f"{p}.attn.c_attn.weight"), w(f"{p}.attn.c_attn.bias")],
            name=f"{p}.attn.c_attn",
        )
        q, k, v = b.op("Split", [qkv], {"axis": -1, "num_outputs": 3}, n_outputs=3)
        if deferred_kv:
            rdt = recent_dtype or DataType.Float
            recent_k = b.input(f"recent.{i}.key", rdt, ("slots", H, "recent", D))
            recent_v = b.input(f"recent.{i}.value", rdt, ("slots", H, "recent", D))
            recent_in = [recent_k, recent_v, step_t]
            recent_out = [f"recent_present.{i}.key", f"recent_present.{i}.value"]
        else:
            recent_in, recent_out = [], []
        deferred_attr = {"rten_recent_kv": 1} if deferred_kv else {}
        if kv_quant:
            kv_elem = DataType.UInt8 if kv_bits == 4 else DataType.Int8
            past_k = b.input(f"past_key_values.{i}.key", kv_elem, kv_shape)
            k_sc = b.input(f"past_key_values.{i}.key_scale", DataType.Float, sc_shape)
            past_v = b.input(f"past_key_values.{i}.value", kv_elem, kv_shape)
            v_sc = b.input(f"past_key_values.{i}.value_scale", DataType.Float, sc_shape)
            attn, *outs = b.op(
                "QuantizedKVAttention",
                [q, k, v, past_k, k_sc, past_v, v_sc, past_lens] + paged_in + recent_in,
                {"num_heads": H, **deferred_attr, "bits": kv_bits, **paged_attr, **ka_attr},
                n_outputs=5 + len(recent_out),
                output_names=[
                    f"attn_out_{i}", f"present.{i}.key", f"present.{i}.key_scale",
                    f"present.{i}.value", f"present.{i}.value_scale",
                ] + recent_out,
            )
            presents.extend(outs)
        elif deferred_kv:
            kdt = kv_dtype or DataType.Float
            past_k = b.input(f"past_key_values.{i}.key", kdt, ("slots", H, capacity, D))
            past_v = b.input(f"past_key_values.{i}.value", kdt, ("slots", H, capacity, D))
            attn, *outs = b.op(
                "GroupQueryAttention",
                [q, k, v, past_k, past_v, past_lens, None, None, None] + recent_in,
                {"num_heads": H, "kv_num_heads": H, "rten_past_lens": 1,
                 "rten_recent_kv": 1},
                n_outputs=5,
                output_names=[
                    f"attn_out_{i}", f"present.{i}.key", f"present.{i}.value",
                ] + recent_out,
            )
            presents.extend(outs)
        else:
            kdt = kv_dtype or DataType.Float
            past_k = b.input(f"past_key_values.{i}.key", kdt, kv_shape)
            past_v = b.input(f"past_key_values.{i}.value", kdt, kv_shape)
            attn, pk, pv = b.op(
                "GroupQueryAttention",
                [q, k, v, past_k, past_v, past_lens]
                + ([None, None, None, block_table] if paged_blocks else []),
                {"num_heads": H, "kv_num_heads": H, "rten_past_lens": 1,
                 **paged_attr, **ka_attr},
                n_outputs=3,
                output_names=[
                    f"attn_out_{i}", f"present.{i}.key", f"present.{i}.value",
                ],
            )
            presents.extend([pk, pv])
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


def weights_from_torch(module) -> Dict[str, np.ndarray]:
    """Weights of a transformers GPT2LMHeadModel (its causal-mask buffers
    and the tied lm_head left out)."""
    sd = module.state_dict()
    return {
        k: v.detach().cpu().numpy()
        for k, v in sd.items()
        if not k.endswith(".attn.bias") and not k.endswith(".attn.masked_bias")
        and k != "lm_head.weight"
    }


def load(
    cfg: GPT2Config | str = "gpt2",
    weights: Optional[Dict[str, np.ndarray]] = None,
    quantize: Optional[str] = None,
    options: Optional[ModelOptions] = None,
    seed: int = 0,
    device=None,
) -> Model:
    """A runnable GPT-2 ``Model`` of ``build_graph``: ``weights``, or random
    weights from ``seed``; quantize None | 'int8' (dynamic) | 'int4'
    (weight-only). Runs on the card unless ``device`` says otherwise."""
    if isinstance(cfg, str):
        cfg = CONFIGS[cfg]
    if weights is None:
        weights = random_weights(cfg, seed)
    graph = build_graph(cfg, weights)
    if quantize == "int8":
        graph = quantize_dynamic(graph)
    elif quantize == "int4":
        graph = quantize_weight_only_int4(graph)
    elif quantize is not None:
        raise ValueError(f"unknown quantize mode {quantize}")
    return Model(graph, options, device=device)
