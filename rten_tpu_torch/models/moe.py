"""Mixtral-style sparse-MoE causal LM (the port of ``rten_tpu/models/moe.py``).

The graph of ``models/gpt2.py``'s shape (learned positions, LayerNorm,
``Attention`` over past K/V) with each block's MLP the stacked-expert
``MoE`` op (``ops/moe.py``): router top-k gating over ``n_experts`` SwiGLU
experts, softmax over the selected gates. The architecture follows the
public Mixtral design (top 2 of 8 SwiGLU experts); Mixtral-8x7B's widths
are n_embd 4096, 32 heads, 8 experts, top 2, ffn 14336 per expert,
vocabulary 32000.

``random_weights`` makes the JAX module's numpy draws, so both packages
build the same weights from one seed, and ``build_graph`` issues the JAX
builder's calls in the same order (same node ids, names and constants).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from ..dtypes import DataType
from ..ir.builder import GraphBuilder
from ..ir.graph import Graph


@dataclasses.dataclass
class MoEConfig:
    vocab_size: int = 128
    n_positions: int = 64
    n_embd: int = 32
    n_layer: int = 2
    n_head: int = 4
    n_experts: int = 4
    top_k: int = 2
    ffn_dim: int = 64  # per expert

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head


def random_weights(cfg: MoEConfig, seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    E, F, X = cfg.n_embd, cfg.ffn_dim, cfg.n_experts

    def n(*shape, scale=0.02):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    w = {
        "wte.weight": n(cfg.vocab_size, E),
        "wpe.weight": n(cfg.n_positions, E),
        "ln_f.weight": np.ones(E, np.float32),
        "ln_f.bias": np.zeros(E, np.float32),
    }
    for i in range(cfg.n_layer):
        p = f"h.{i}"
        w[f"{p}.ln_1.weight"] = np.ones(E, np.float32)
        w[f"{p}.ln_1.bias"] = np.zeros(E, np.float32)
        w[f"{p}.attn.c_attn.weight"] = n(E, 3 * E)
        w[f"{p}.attn.c_attn.bias"] = np.zeros(3 * E, np.float32)
        w[f"{p}.attn.c_proj.weight"] = n(E, E)
        w[f"{p}.attn.c_proj.bias"] = np.zeros(E, np.float32)
        w[f"{p}.ln_2.weight"] = np.ones(E, np.float32)
        w[f"{p}.ln_2.bias"] = np.zeros(E, np.float32)
        w[f"{p}.moe.router_w"] = n(E, X)
        # SwiGLU: gate+up merged on the last axis (ops/moe.py act='swiglu').
        w[f"{p}.moe.w_up"] = n(X, E, 2 * F)
        w[f"{p}.moe.w_down"] = n(X, F, E)
    return w


def build_graph(cfg: MoEConfig, weights: Dict[str, np.ndarray]) -> Graph:
    b = GraphBuilder()
    E, H, D = cfg.n_embd, cfg.n_head, cfg.head_dim

    def w(name):
        return b.constant(name, np.ascontiguousarray(weights[name], np.float32))

    ids = b.input("input_ids", DataType.Int32, ("batch", "seq"))
    mask = b.input("attention_mask", DataType.Int32, ("batch", "total_seq"))
    pos = b.input("position_ids", DataType.Int32, ("batch", "seq"))

    x = b.op("Gather", [w("wte.weight"), ids])
    x = x + b.op("Gather", [w("wpe.weight"), pos])

    mask_f = b.op("Cast", [mask], {"to": DataType.Float})
    neg = b.constant(None, np.float32(-1e30))
    one = b.constant(None, np.float32(1.0))
    add_mask = b.op("Mul", [b.op("Sub", [one, mask_f]), neg])
    add_mask = b.op("Unsqueeze", [add_mask, b.constant(None, np.int32([1, 2]))])

    def layer_norm(h, prefix):
        return b.op(
            "LayerNormalization",
            [h, w(f"{prefix}.weight"), w(f"{prefix}.bias")],
            {"epsilon": 1e-5},
        )

    def to_heads(h):
        r = b.op("Reshape", [h, b.constant(None, np.int32([0, 0, H, D]))])
        return b.op("Transpose", [r], {"perm": [0, 2, 1, 3]})

    def from_heads(h):
        r = b.op("Transpose", [h], {"perm": [0, 2, 1, 3]})
        return b.op("Reshape", [r, b.constant(None, np.int32([0, 0, E]))])

    for i in range(cfg.n_layer):
        p = f"h.{i}"
        past_k = b.input(
            f"past_key_values.{i}.key", DataType.Float,
            ("batch", H, "past_seq", D),
        )
        past_v = b.input(
            f"past_key_values.{i}.value", DataType.Float,
            ("batch", H, "past_seq", D),
        )
        h = layer_norm(x, f"{p}.ln_1")
        qkv = b.op(
            "MatMulAdd",
            [h, w(f"{p}.attn.c_attn.weight"), w(f"{p}.attn.c_attn.bias")],
            name=f"{p}.attn.c_attn",
        )
        q, k, v = b.op("Split", [qkv], {"axis": -1, "num_outputs": 3}, n_outputs=3)
        attn, _, _ = b.op(
            "Attention",
            [to_heads(q), to_heads(k), to_heads(v), add_mask, past_k, past_v],
            {"is_causal": 1},
            n_outputs=3,
            output_names=[
                f"attn_out_{i}", f"present.{i}.key", f"present.{i}.value",
            ],
        )
        proj = b.op(
            "MatMulAdd",
            [from_heads(attn), w(f"{p}.attn.c_proj.weight"),
             w(f"{p}.attn.c_proj.bias")],
            name=f"{p}.attn.c_proj",
        )
        x = x + proj
        h2 = layer_norm(x, f"{p}.ln_2")
        moe = b.op(
            "MoE",
            [h2, w(f"{p}.moe.router_w"), w(f"{p}.moe.w_up"),
             w(f"{p}.moe.w_down")],
            {"top_k": cfg.top_k, "activation": "swiglu",
             "normalize_gates": 1},
            name=f"{p}.moe",
        )
        x = x + moe

    x = layer_norm(x, "ln_f")
    lm_w = b.constant(
        "lm_head.weight_t",
        np.ascontiguousarray(weights["wte.weight"].T, np.float32),
    )
    logits = b.op("MatMul", [x, lm_w], name="lm_head", output_names=["logits"])
    b.output(logits)
    return b.finish()
