"""A Llama-architecture ``nn.Module`` whose TorchScript export writes the
int4 graph layout of onnxruntime-genai's model builder
(``onnxruntime_genai/models/builder.py``, ``-p int4 -e cpu``), shared by
the port's tests and ``chip_smoke.py``.

Published genai exports cannot be fetched here, so this module writes the
same layout from seeded weights. TinyLlama-1.1B's published widths are the
default (``GenaiShape()``: E 2048, 32 query heads over 4 KV heads, D 64,
FFN 5632, vocabulary 32000, 22 layers, rope theta 10000, RMS epsilon
1e-5). The layout:

* inputs ``input_ids`` [B, S] and ``attention_mask`` [B, total] (int64),
  ``past_key_values.{i}.key`` / ``.value`` [B, Hkv, past, D] (f32);
  outputs ``logits`` [B, S, V] and ``present.{i}.key`` / ``.value``;
* ``seqlens_k = Cast(ReduceSum(attention_mask, 1) - 1, int32)`` and
  ``total_sequence_length = Cast(Shape(attention_mask)[1], int32)``;
* the first layer's ``SimplifiedLayerNormalization``, then a
  ``com.microsoft::SkipSimplifiedLayerNormalization`` after each attention
  and each MLP (the last one is the final norm), its outputs 0 (normed)
  and 3 (the residual sum) used;
* ``com.microsoft::MatMulNBits`` (bits 4, block 32, RTN asymmetric
  quantization with u8 packed zero points) for the packed QKV projection
  (``packed_qkv=False``: q, k and v apart), o_proj, gate, up, down and the
  lm_head;
* ``com.microsoft::GroupQueryAttention`` with ``do_rotary=1`` and cos/sin
  caches [max_pos, D/2] (half-split rotation), its key and value inputs
  empty when the QKV projection is packed;
* SiLU as ``Sigmoid`` times ``Mul``.

Each contrib op is a ``torch.autograd.Function`` whose ``symbolic`` emits
the node and whose ``forward`` computes the op in torch, so the module's
eager forward is the yardstick of what the graph computes. The attention
forward takes the past as exact (its own length is the past length), the
onnxruntime-genai decode loop's contract. Weights are normal from a seeded
``torch.Generator`` (optionally on the card, which makes full-width
weights in seconds), projections at ``sharpen / sqrt(fan_in)`` so that
greedy tokens vary with the context; the module keeps only the quantized
buffers (nibbles, scales, zero points), the embedding, the norms and the
rotary tables.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclasses.dataclass
class GenaiShape:
    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 5632
    num_hidden_layers: int = 22
    num_attention_heads: int = 32
    num_key_value_heads: int = 4
    max_position_embeddings: int = 2048
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    block_size: int = 32
    packed_qkv: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


SMALL = GenaiShape(vocab_size=512, hidden_size=256, intermediate_size=512,
                   num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                   max_position_embeddings=256)


def quantize_rtn(w: torch.Tensor, block: int):
    """RTN asymmetric int4 of w [N, K] per block of ``block`` along K, the
    builder's layout: nibbles u8 [N, nb, block / 2] (element 2i low, 2i + 1
    high), scales f32 [N * nb], zero points u8 [N * ceil(nb / 2)] (block 2j
    low, 2j + 1 high). Each block's range includes 0."""
    N, K = w.shape
    nb = -(-K // block)
    wb = F.pad(w, (0, nb * block - K)).reshape(N, nb, block)
    lo = wb.amin(-1).clamp(max=0.0)
    hi = wb.amax(-1).clamp(min=0.0)
    scale = (hi - lo) / 15.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    zp = torch.round(-lo / scale).clamp(0, 15)
    q = torch.clamp(torch.round(wb / scale[..., None]) + zp[..., None], 0, 15).to(torch.uint8)
    packed = q[..., 0::2] | (q[..., 1::2] << 4)
    zq = F.pad(zp.to(torch.uint8), (0, nb % 2))
    zpk = zq[:, 0::2] | (zq[:, 1::2] << 4)
    return packed.contiguous(), scale.reshape(-1).contiguous(), zpk.reshape(-1).contiguous()


def dequantize(packed: torch.Tensor, scales: torch.Tensor, zps: torch.Tensor, K: int):
    """The f32 weight [N, K] of ``quantize_rtn``'s buffers."""
    N, nb, half = packed.shape
    q = torch.stack([packed & 0x0F, packed >> 4], -1).reshape(N, nb, 2 * half)
    z = zps.reshape(N, -1)
    z = torch.stack([z & 0x0F, z >> 4], -1).reshape(N, -1)[:, :nb]
    w = (q.float() - z.float()[..., None]) * scales.reshape(N, nb, 1)
    return w.reshape(N, nb * 2 * half)[:, :K]


class _MatMulNBits(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, packed, scales, zps, K, N, block):
        if torch.onnx.is_in_onnx_export():
            return a.new_zeros(a.shape[:-1] + (N,))
        return a @ dequantize(packed, scales, zps, K).t()

    @staticmethod
    def symbolic(g, a, packed, scales, zps, K, N, block):
        return g.op("com.microsoft::MatMulNBits", a, packed, scales, zps, K_i=K, N_i=N,
                    bits_i=4, block_size_i=block)


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


class _SimplifiedLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps):
        return _rms(x, w, eps)

    @staticmethod
    def symbolic(g, x, w, eps):
        return g.op("SimplifiedLayerNormalization", x, w, axis_i=-1, epsilon_f=eps)


class _SkipSimplifiedLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, skip, w, eps):
        total = x + skip
        return _rms(total, w, eps), x.new_zeros(()), x.new_zeros(()), total

    @staticmethod
    def symbolic(g, x, skip, w, eps):
        return g.op("com.microsoft::SkipSimplifiedLayerNormalization", x, skip, w,
                    epsilon_f=eps, outputs=4)


class _TotalSeqLen(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mask):
        return torch.tensor(mask.shape[1], dtype=torch.int32)

    @staticmethod
    def symbolic(g, mask):
        shape = g.op("Shape", mask)
        n = g.op("Gather", shape, g.op("Constant", value_t=torch.tensor(1, dtype=torch.int64)))
        return g.op("Cast", n, to_i=6)  # int32


def _rotate_half(x, cos, sin):
    h = x.shape[-1] // 2
    x1, x2 = x[..., :h], x[..., h:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


class _GroupQueryAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, query, key, value, past_k, past_v, seqlens_k, total, cos, sin, Hq, Hkv):
        B, S, _ = query.shape
        D = past_k.shape[3]
        if key is None:
            key = query[..., Hq * D:(Hq + Hkv) * D]
            value = query[..., (Hq + Hkv) * D:]
            query = query[..., :Hq * D]
        q, k, v = (t.reshape(B, S, h, D).transpose(1, 2)
                   for t, h in ((query, Hq), (key, Hkv), (value, Hkv)))
        P = past_k.shape[2]
        pos = torch.arange(P, P + S, device=q.device)
        c, s = cos[pos][None, None], sin[pos][None, None]
        q, k = _rotate_half(q, c, s), _rotate_half(k, c, s)
        k, v = torch.cat([past_k, k], 2), torch.cat([past_v, v], 2)
        kr, vr = (t.repeat_interleave(Hq // Hkv, 1) for t in (k, v))
        sc = q @ kr.transpose(-1, -2) / math.sqrt(D)
        band = torch.arange(P + S, device=q.device)[None] <= pos[:, None]
        sc = sc.masked_fill(~band, float("-inf"))
        out = (torch.softmax(sc, -1) @ vr).transpose(1, 2).reshape(B, S, Hq * D)
        return out, k, v

    @staticmethod
    def symbolic(g, query, key, value, past_k, past_v, seqlens_k, total, cos, sin, Hq, Hkv):
        from torch.onnx._internal.torchscript_exporter.symbolic_helper import (
            _optional_input_placeholder_tensor,
        )

        if key is None:
            key = _optional_input_placeholder_tensor(g)
            value = _optional_input_placeholder_tensor(g)
        return g.op("com.microsoft::GroupQueryAttention", query, key, value, past_k, past_v,
                    seqlens_k, total, cos, sin, num_heads_i=Hq, kv_num_heads_i=Hkv,
                    do_rotary_i=1, rotary_interleaved_i=0, local_window_size_i=-1,
                    outputs=3)


class _QLinear(nn.Module):
    """One MatMulNBits projection: w [N, K] quantized at construction."""

    def __init__(self, w: torch.Tensor, block: int):
        super().__init__()
        self.N, self.K, self.block = w.shape[0], w.shape[1], block
        packed, scales, zps = quantize_rtn(w, block)
        self.register_buffer("qweight", packed.cpu())
        self.register_buffer("scales", scales.cpu())
        self.register_buffer("qzeros", zps.cpu())

    def forward(self, x):
        return _MatMulNBits.apply(x, self.qweight, self.scales, self.qzeros, self.K, self.N,
                                  self.block)


class GenaiLlama(nn.Module):
    def __init__(self, shape: GenaiShape = GenaiShape(), seed: int = 0, sharpen: float = 2.0,
                 device="cpu"):
        super().__init__()
        s = self.shape = shape
        E, F_, D = s.hidden_size, s.intermediate_size, s.head_dim
        Hq, Hkv = s.num_attention_heads, s.num_key_value_heads
        gen = torch.Generator(device=device).manual_seed(seed)

        def w(n, k):
            return torch.randn(n, k, generator=gen, device=device) * (sharpen / math.sqrt(k))

        self.embed_tokens = nn.Parameter(
            torch.randn(s.vocab_size, E, generator=gen, device=device).cpu(), requires_grad=False)
        self.layers = nn.ModuleList()
        for _ in range(s.num_hidden_layers):
            layer = nn.Module()
            if s.packed_qkv:
                layer.qkv_proj = _QLinear(w((Hq + 2 * Hkv) * D, E), s.block_size)
            else:
                layer.q_proj = _QLinear(w(Hq * D, E), s.block_size)
                layer.k_proj = _QLinear(w(Hkv * D, E), s.block_size)
                layer.v_proj = _QLinear(w(Hkv * D, E), s.block_size)
            layer.o_proj = _QLinear(w(E, Hq * D), s.block_size)
            layer.gate_proj = _QLinear(w(F_, E), s.block_size)
            layer.up_proj = _QLinear(w(F_, E), s.block_size)
            layer.down_proj = _QLinear(w(E, F_), s.block_size)
            layer.input_layernorm = nn.Parameter(torch.ones(E), requires_grad=False)
            layer.post_attention_layernorm = nn.Parameter(torch.ones(E), requires_grad=False)
            self.layers.append(layer)
        self.norm = nn.Parameter(torch.ones(E), requires_grad=False)
        self.lm_head = _QLinear(w(s.vocab_size, E), s.block_size)
        inv = 1.0 / (s.rope_theta ** (torch.arange(0, D, 2, dtype=torch.float64) / D))
        ang = torch.arange(s.max_position_embeddings, dtype=torch.float64)[:, None] * inv[None]
        self.register_buffer("cos_cache", torch.cos(ang).float())
        self.register_buffer("sin_cache", torch.sin(ang).float())

    def forward(self, input_ids, attention_mask, *past):
        s, eps = self.shape, self.shape.rms_norm_eps
        Hq, Hkv = s.num_attention_heads, s.num_key_value_heads
        seqlens_k = (attention_mask.sum(1) - 1).to(torch.int32)
        total = _TotalSeqLen.apply(attention_mask)
        x = F.embedding(input_ids, self.embed_tokens)
        h = _SimplifiedLayerNorm.apply(x, self.layers[0].input_layernorm, eps)
        residual = x
        presents = []
        for i, layer in enumerate(self.layers):
            if s.packed_qkv:
                q, k, v = layer.qkv_proj(h), None, None
            else:
                q, k, v = layer.q_proj(h), layer.k_proj(h), layer.v_proj(h)
            attn, pk, pv = _GroupQueryAttention.apply(
                q, k, v, past[2 * i], past[2 * i + 1], seqlens_k, total, self.cos_cache,
                self.sin_cache, Hq, Hkv)
            presents += [pk, pv]
            h, _, _, residual = _SkipSimplifiedLayerNorm.apply(
                layer.o_proj(attn), residual, layer.post_attention_layernorm, eps)
            g = layer.gate_proj(h)
            mlp = layer.down_proj(g * torch.sigmoid(g) * layer.up_proj(h))
            nxt = self.layers[i + 1].input_layernorm if i + 1 < len(self.layers) else self.norm
            h, _, _, residual = _SkipSimplifiedLayerNorm.apply(mlp, residual, nxt, eps)
        return (self.lm_head(h), *presents)

    def empty_past(self, batch: int = 1, device="cpu"):
        s = self.shape
        z = torch.zeros(batch, s.num_key_value_heads, 0, s.head_dim, device=device)
        return [z] * (2 * s.num_hidden_layers)

    def greedy(self, prompt, n_new: int):
        """The onnxruntime-genai decode loop on the eager module: the prompt,
        then one token a step against the exact past; (tokens, the logits
        row after the prompt and after each token)."""
        ids = torch.as_tensor(prompt, dtype=torch.int64).reshape(1, -1)
        past, rows, toks = self.empty_past(), [], []
        mask = torch.ones_like(ids)
        with torch.no_grad():
            for _ in range(n_new + 1):
                out = self(ids, mask, *past)
                rows.append(out[0][0, -1].clone())
                past = list(out[1:])
                toks.append(int(torch.argmax(rows[-1])))
                ids = torch.tensor([[toks[-1]]])
                mask = torch.ones(1, mask.shape[1] + 1, dtype=torch.int64)
        return toks[:n_new], rows


def export(module: GenaiLlama, path) -> str:
    """``module`` as ONNX at ``path`` (opset 17, the com.microsoft domain
    version 1): dynamic batch, sequence, total and past lengths."""
    from torch.onnx._internal.torchscript_exporter import onnx_proto_utils

    onnx_proto_utils._add_onnxscript_fn = lambda model_bytes, custom_opsets: model_bytes
    s = module.shape
    L = s.num_hidden_layers
    ids = torch.zeros((1, 2), dtype=torch.int64)
    mask = torch.ones((1, 3), dtype=torch.int64)
    past = [torch.zeros(1, s.num_key_value_heads, 1, s.head_dim) for _ in range(2 * L)]
    kv = [f"past_key_values.{i}.{n}" for i in range(L) for n in ("key", "value")]
    present = [f"present.{i}.{n}" for i in range(L) for n in ("key", "value")]
    axes = {"input_ids": {0: "batch", 1: "seq"}, "attention_mask": {0: "batch", 1: "total"},
            "logits": {0: "batch", 1: "seq"},
            **{n: {0: "batch", 2: "past"} for n in kv},
            **{n: {0: "batch", 2: "total"} for n in present}}
    with torch.no_grad():
        torch.onnx.export(module.eval(), (ids, mask, *past), str(path),
                          input_names=["input_ids", "attention_mask", *kv],
                          output_names=["logits", *present], dynamic_axes=axes,
                          opset_version=17, custom_opsets={"com.microsoft": 1}, dynamo=False)
    return str(path)
