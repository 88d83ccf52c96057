"""Llama-family causal LM (RMSNorm, rotary, GQA, SwiGLU) built in engine IR
for the serving engine (the port of ``rten_tpu/models/llama.py``).

The serving graph keeps preallocated per-slot KV caches that the attention
op writes at each slot's offset, with rotary applied inside the op at
positions ``past_lens + s``. The supported branches:

* ``kv_quant=True, kv_bits=8``: QuantizedKVAttention on int8 caches,
  head-major ``[slots, Hkv, cap, D]`` (``kernel_append=False``, attended
  by ``decode_mha``) or cat layout ``[slots, cap, Hkv*D]``
  (``kernel_append=True``, ``decode_mha_append_cat`` / ``prefill_mha_cat``),
  with scales ``[slots, Hkv, cap, 1]``;
* ``kv_quant=True, kv_bits=4``: the same op on int4 head-major caches (u8
  ``[slots, Hkv, cap, D/2]``, ``pack_int4``), attended by ``decode_mha``;
* ``deferred_kv``: a ``step_t`` input and per-layer recent windows
  ``recent.N.{key,value}`` ``[slots, Hkv, recent, D]`` (``recent_dtype``,
  f32 by default) with their ``recent_present.N.*`` outputs, on head-major
  int8, int4, f32 or bf16 caches (decode steps attend
  ``decode_attention_deferred``; the engine commits the windows);
* ``kv_quant=False``: GroupQueryAttention on f32 or (``kv_dtype=BFloat16``)
  bf16 caches, head-major ``[slots, Hkv, cap, D]`` (``decode_mha``) or, with
  ``kernel_append``, cat layout ``[slots, cap, Hkv*D]``
  (``decode_mha_append_cat`` / ``prefill_mha_cat`` without scales);
* ``paged_blocks > 0``: the same forms on block pools shared by all slots
  (head-major ``[paged_blocks, Hkv, block_size, D]``, cat
  ``[paged_blocks, block_size, Hkv*D]`` with ``kernel_append``), int8
  pools with scale pools ``[paged_blocks, Hkv, 1, block_size]``, and a
  ``block_table`` input ``[slots, capacity // block_size]`` int32;
* ``attention_bias`` (Qwen2), ``tie_word_embeddings`` (the lm_head reads
  the embedding table) and ``sliding_window`` (Mistral) on each;
* ``gather_last=True``: the lm_head runs on one gathered row per slot.

The builder issues the same sequence of builder calls as the JAX package's
``build_graph_static_cache`` on each of those branches, so both graphs have
the same node ids, names and constants for the same weights. Every other
option raises ``NotImplementedError`` naming the ROADMAP.md item.

Weight naming follows HF ``LlamaForCausalLM.state_dict()``:
``model.embed_tokens.weight``, ``model.layers.N.self_attn.{q,k,v,o}_proj``,
``model.layers.N.{input_layernorm,post_attention_layernorm}.weight``,
``model.layers.N.mlp.{gate,up,down}_proj.weight``, ``model.norm.weight``,
``lm_head.weight``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from ..dtypes import DataType
from ..ir.builder import GraphBuilder
from ..ir.graph import Graph


@dataclasses.dataclass
class LlamaConfig:
    """Defaults: TinyLlama-1.1B's published shape."""

    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 5632
    num_hidden_layers: int = 22
    num_attention_heads: int = 32
    num_key_value_heads: int = 4
    max_position_embeddings: int = 2048
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    # Qwen2-style q/k/v projection biases.
    attention_bias: bool = False
    # Mistral-style sliding-window attention (0 = full attention).
    sliding_window: int = 0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def rope_tables(cfg: LlamaConfig):
    """Rotary angles [max_pos, D/2] (the builder stores their cos and sin)."""
    D = cfg.head_dim
    inv = 1.0 / (cfg.rope_theta ** (np.arange(0, D, 2, dtype=np.float64) / D))
    t = np.arange(cfg.max_position_embeddings, dtype=np.float64)
    freqs = np.outer(t, inv)
    return freqs.astype(np.float32), freqs.astype(np.float32)




def build_graph_static_cache(
    cfg: LlamaConfig, weights: Dict[str, np.ndarray], capacity: int,
    deferred_kv: bool = False, recent_dtype: DataType = None,
    kv_dtype: DataType = None, kv_quant: bool = False, kv_bits: int = 8,
    paged_blocks: int = 0, block_size: int = 64,
    kernel_append: bool = False, gather_last: bool = False,
) -> Graph:
    """Serving graph. Inputs: input_ids [slots, seq], past_lens [slots],
    position_ids [slots, seq] (unused: rotary positions come from
    past_lens; kept for the engine's IO), block_table [slots,
    capacity // block_size] (paged graphs), the caches
    past_key_values.N.{key,value}[_scale], last_pos [slots]. Outputs:
    logits [slots, 1, V], present.N.*, next_token [slots, 1] (on-device
    argmax)."""
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
    if not gather_last:
        raise NotImplementedError(
            "full-bucket lm_head (gather_last=False): ROADMAP.md queue 1 item 10"
        )
    b = GraphBuilder()
    Hq, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim

    def w_t(name):
        # torch Linear stores [out, in]; matmul wants [in, out].
        return b.constant(
            name + ".T", np.ascontiguousarray(weights[name].T, np.float32)
        )

    def w(name):
        return b.constant(name, np.ascontiguousarray(weights[name], np.float32))

    ka_attr = {"rten_kernel_append": 1} if kernel_append else {}
    window_attr = (
        {"local_window_size": cfg.sliding_window} if cfg.sliding_window else {}
    )

    ids = b.input("input_ids", DataType.Int32, ("slots", "seq"))
    past_lens = b.input("past_lens", DataType.Int32, ("slots",))
    step_t = b.input("step_t", DataType.Int32, (1,)) if deferred_kv else None
    b.input("position_ids", DataType.Int32, ("slots", "seq"))
    block_table = (
        b.input("block_table", DataType.Int32, ("slots", capacity // block_size))
        if paged_blocks else None
    )

    cos_np, sin_np = rope_tables(cfg)
    cos_c = b.constant("rope.cos", np.cos(cos_np))
    sin_c = b.constant("rope.sin", np.sin(sin_np))

    x = b.op("Gather", [w("model.embed_tokens.weight"), ids])

    def rms(h, name):
        return b.op(
            "RMSNormalization", [h, w(name)], {"epsilon": cfg.rms_norm_eps}
        )

    def block_tail(x, attn, p):
        """o_proj residual + RMSNorm + SwiGLU MLP."""
        x = x + b.op("MatMul", [attn, w_t(f"{p}.self_attn.o_proj.weight")],
                     name=f"{p}.self_attn.o_proj")
        h2 = rms(x, f"{p}.post_attention_layernorm.weight")
        gate = b.op("MatMul", [h2, w_t(f"{p}.mlp.gate_proj.weight")],
                    name=f"{p}.mlp.gate_proj")
        up = b.op("MatMul", [h2, w_t(f"{p}.mlp.up_proj.weight")],
                  name=f"{p}.mlp.up_proj")
        act = b.op("Mul", [b.op("Silu", [gate]), up])
        return x + b.op("MatMul", [act, w_t(f"{p}.mlp.down_proj.weight")],
                        name=f"{p}.mlp.down_proj")

    def proj(h, name):
        if cfg.attention_bias:
            return b.op(
                "MatMulAdd", [h, w_t(f"{name}.weight"), w(f"{name}.bias")],
                name=name,
            )
        return b.op("MatMul", [h, w_t(f"{name}.weight")], name=name)

    def recent(i):
        """Layer i's deferred-KV windows: (their inputs and step_t, their
        output names)."""
        if not deferred_kv:
            return [], []
        rdt = recent_dtype or DataType.Float
        rk = b.input(f"recent.{i}.key", rdt, ("slots", Hkv, "recent", D))
        rv = b.input(f"recent.{i}.value", rdt, ("slots", Hkv, "recent", D))
        return [rk, rv, step_t], [f"recent_present.{i}.key", f"recent_present.{i}.value"]

    deferred_attr = {"rten_recent_kv": 1} if deferred_kv else {}
    presents = []
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}"
        h = rms(x, f"{p}.input_layernorm.weight")
        q = proj(h, f"{p}.self_attn.q_proj")
        k = proj(h, f"{p}.self_attn.k_proj")
        v = proj(h, f"{p}.self_attn.v_proj")
        if paged_blocks:
            pool_shape = (
                (paged_blocks, block_size, Hkv * D) if kernel_append
                else (paged_blocks, Hkv, block_size, D)
            )
        if kv_quant and paged_blocks:
            scale_shape = (paged_blocks, Hkv, 1, block_size)
            past_k = b.input(f"past_key_values.{i}.key", DataType.Int8, pool_shape)
            k_sc = b.input(f"past_key_values.{i}.key_scale", DataType.Float, scale_shape)
            past_v = b.input(f"past_key_values.{i}.value", DataType.Int8, pool_shape)
            v_sc = b.input(f"past_key_values.{i}.value_scale", DataType.Float, scale_shape)
            qattrs = {
                "num_heads": Hq, "kv_num_heads": Hkv, "bits": kv_bits,
                "do_rotary": 1, "rten_paged": 1, **ka_attr, **window_attr,
            }
            outs = b.op(
                "QuantizedKVAttention",
                [q, k, v, past_k, k_sc, past_v, v_sc, past_lens, block_table,
                 cos_c, sin_c],
                qattrs,
                n_outputs=5,
                output_names=[
                    f"attn_out_{i}", f"present.{i}.key",
                    f"present.{i}.key_scale", f"present.{i}.value",
                    f"present.{i}.value_scale",
                ],
            )
            presents.extend(outs[1:])
            x = block_tail(x, outs[0], p)
            continue
        if kv_quant:
            # int4 rows hold D/2 bytes (u8 nibbles, pack_int4).
            kv_elem = DataType.UInt8 if kv_bits == 4 else DataType.Int8
            kv_d = D // 2 if kv_bits == 4 else D
            kv_shape = (
                ("slots", capacity, Hkv * kv_d) if kernel_append
                else ("slots", Hkv, capacity, kv_d)
            )
            past_k = b.input(f"past_key_values.{i}.key", kv_elem, kv_shape)
            k_sc = b.input(
                f"past_key_values.{i}.key_scale", DataType.Float,
                ("slots", Hkv, capacity, 1),
            )
            past_v = b.input(f"past_key_values.{i}.value", kv_elem, kv_shape)
            v_sc = b.input(
                f"past_key_values.{i}.value_scale", DataType.Float,
                ("slots", Hkv, capacity, 1),
            )
            qattrs = {
                "num_heads": Hq, "kv_num_heads": Hkv, "bits": kv_bits,
                "do_rotary": 1, **window_attr,
            }
            recent_in, recent_out = recent(i)
            outs = b.op(
                "QuantizedKVAttention",
                [q, k, v, past_k, k_sc, past_v, v_sc, past_lens] + recent_in + [cos_c, sin_c],
                {**qattrs, **deferred_attr, **ka_attr},
                n_outputs=5 + len(recent_out),
                output_names=[
                    f"attn_out_{i}", f"present.{i}.key",
                    f"present.{i}.key_scale", f"present.{i}.value",
                    f"present.{i}.value_scale",
                ] + recent_out,
            )
            presents.extend(outs[1:])
            x = block_tail(x, outs[0], p)
            continue
        kdt = kv_dtype or DataType.Float
        if paged_blocks:
            kv_shape = pool_shape
        else:
            kv_shape = (("slots", capacity, Hkv * D) if kernel_append
                        else ("slots", Hkv, capacity, D))
        past_k = b.input(f"past_key_values.{i}.key", kdt, kv_shape)
        past_v = b.input(f"past_key_values.{i}.value", kdt, kv_shape)
        recent_in, recent_out = recent(i)
        gqa_inputs = [q, k, v, past_k, past_v, past_lens, None, cos_c, sin_c] + recent_in
        gqa_attrs = {"num_heads": Hq, "kv_num_heads": Hkv, "rten_past_lens": 1,
                     "do_rotary": 1, **deferred_attr}
        if paged_blocks:
            gqa_inputs.append(block_table)
            gqa_attrs["rten_paged"] = 1
        attn, *outs = b.op(
            "GroupQueryAttention", gqa_inputs, {**gqa_attrs, **ka_attr, **window_attr},
            n_outputs=3 + len(recent_out),
            output_names=[
                f"attn_out_{i}", f"present.{i}.key", f"present.{i}.value",
            ] + recent_out,
        )
        presents.extend(outs)
        x = block_tail(x, attn, p)

    x = rms(x, "model.norm.weight")
    # Only the prompt-final row's logits are consumed at admission; gather
    # it before the lm_head (decode steps feed last_pos = 0).
    last_pos = b.input("last_pos", DataType.Int32, ("slots",))
    idx3 = b.op(
        "Reshape",
        [last_pos, b.constant("last_pos_shape", np.array([0, 1, 1], np.int64))],
    )
    x = b.op("GatherND", [x, idx3], {"batch_dims": 1})
    lm_name = (
        "model.embed_tokens.weight" if cfg.tie_word_embeddings else "lm_head.weight"
    )
    logits = b.op("MatMul", [x, w_t(lm_name)], name="lm_head",
                  output_names=["logits"])
    next_tok = b.op(
        "ArgMax", [logits], {"axis": -1, "keepdims": 0},
        output_names=["next_token"],
    )
    b.output(logits, *presents)
    b.graph.output_ids.append(next_tok.node_id)
    return b.finish()


def random_weights(cfg: LlamaConfig, seed: int = 0) -> Dict[str, np.ndarray]:
    """Random weights from a seed, with HF ``LlamaForCausalLM`` names and
    shapes; the same arrays as ``rten_tpu.models.llama.random_weights`` for
    the same seed."""
    rng = np.random.default_rng(seed)
    E, F, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    Hq, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim

    def nrm(*shape, std=0.02):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    wd = {"model.embed_tokens.weight": nrm(V, E), "model.norm.weight": np.ones(E, np.float32)}
    if not cfg.tie_word_embeddings:
        wd["lm_head.weight"] = nrm(V, E)
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}"
        wd[f"{p}.self_attn.q_proj.weight"] = nrm(Hq * D, E)
        wd[f"{p}.self_attn.k_proj.weight"] = nrm(Hkv * D, E)
        wd[f"{p}.self_attn.v_proj.weight"] = nrm(Hkv * D, E)
        if cfg.attention_bias:
            wd[f"{p}.self_attn.q_proj.bias"] = nrm(Hq * D)
            wd[f"{p}.self_attn.k_proj.bias"] = nrm(Hkv * D)
            wd[f"{p}.self_attn.v_proj.bias"] = nrm(Hkv * D)
        wd[f"{p}.self_attn.o_proj.weight"] = nrm(E, Hq * D)
        wd[f"{p}.mlp.gate_proj.weight"] = nrm(F, E)
        wd[f"{p}.mlp.up_proj.weight"] = nrm(F, E)
        wd[f"{p}.mlp.down_proj.weight"] = nrm(E, F)
        wd[f"{p}.input_layernorm.weight"] = np.ones(E, np.float32)
        wd[f"{p}.post_attention_layernorm.weight"] = np.ones(E, np.float32)
    return wd


_LLAMA_LIKE_NAMES = {
    "q_proj.weight": "self_attn.q_proj.weight",
    "k_proj.weight": "self_attn.k_proj.weight",
    "v_proj.weight": "self_attn.v_proj.weight",
    "q_proj.bias": "self_attn.q_proj.bias",
    "k_proj.bias": "self_attn.k_proj.bias",
    "v_proj.bias": "self_attn.v_proj.bias",
    "o_proj.weight": "self_attn.o_proj.weight",
    "gate_proj.weight": "mlp.gate_proj.weight",
    "up_proj.weight": "mlp.up_proj.weight",
    "down_proj.weight": "mlp.down_proj.weight",
    "input_norm.weight": "input_layernorm.weight",
    "post_norm.weight": "post_attention_layernorm.weight",
}


def weights_from_torch(module) -> Dict[str, np.ndarray]:
    """Numpy weights with HF names from an HF ``LlamaForCausalLM`` or a
    module with the flat naming (``embed_tokens``, ``layers.N.q_proj``,
    ``layers.N.input_norm``, ``norm``, ``lm_head``)."""
    sd = {k: v.detach().cpu().numpy() for k, v in module.state_dict().items()}
    if "model.embed_tokens.weight" in sd:
        return sd
    top = {
        "embed_tokens.weight": "model.embed_tokens.weight",
        "norm.weight": "model.norm.weight",
        "lm_head.weight": "lm_head.weight",
    }
    out = {}
    for k, v in sd.items():
        if k in top:
            out[top[k]] = v
        elif k.startswith("layers."):
            _, i, rest = k.split(".", 2)
            out[f"model.layers.{i}.{_LLAMA_LIKE_NAMES.get(rest, rest)}"] = v
    return out
