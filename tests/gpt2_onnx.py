"""A GPT-2-shaped ``nn.Module`` and its ONNX export, shared by the port's
tests and ``chip_smoke.py``.

``GPT2Module`` follows GPT-2's published layout (Radford et al. 2019, the
124M configuration by default: E 768, 12 heads, 12 layers, vocabulary
50257, 1024 positions): learned token and position embeddings, pre-norm
blocks of causal self-attention and a tanh-GELU MLP, a final LayerNorm and
an lm_head tied to the token embedding. The causal mask is an additive
[positions, positions] buffer, sliced to the sequence, as in exports of
GPT-2 implementations that keep one. Weights are normal with std 0.02 from
a seeded ``torch.Generator`` (LayerNorms at 1 and 0).

``export`` writes it at opset 17 with dynamic batch and sequence axes
through torch's TorchScript exporter (``dynamo=False``), with the
exporter's onnxscript post-processing (the one step that needs the
``onnx`` package) patched out, as ``tests/onnx_export_util.py`` does.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn


@dataclasses.dataclass
class GPT2Shape:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12


class _Block(nn.Module):
    def __init__(self, s: GPT2Shape):
        super().__init__()
        E = s.n_embd
        self.n_head = s.n_head
        self.ln_1 = nn.LayerNorm(E)
        self.c_attn = nn.Linear(E, 3 * E)
        self.attn_proj = nn.Linear(E, E)
        self.ln_2 = nn.LayerNorm(E)
        self.c_fc = nn.Linear(E, 4 * E)
        self.mlp_proj = nn.Linear(4 * E, E)

    def forward(self, x, mask):
        B, T, E = x.shape
        H = self.n_head
        D = E // H
        q, k, v = self.c_attn(self.ln_1(x)).split(E, dim=2)
        q, k, v = (t.view(B, T, H, D).transpose(1, 2) for t in (q, k, v))
        att = (q @ k.transpose(-2, -1)) / math.sqrt(D)
        att = torch.softmax(att + mask[:T, :T], dim=-1)
        y = (att @ v).transpose(1, 2).reshape(B, T, E)
        x = x + self.attn_proj(y)
        h = nn.functional.gelu(self.c_fc(self.ln_2(x)), approximate="tanh")
        return x + self.mlp_proj(h)


class GPT2Module(nn.Module):
    def __init__(self, shape: GPT2Shape = GPT2Shape(), seed: int = 0, sharpen: float = 1.0):
        super().__init__()
        s = shape
        self.wte = nn.Embedding(s.vocab_size, s.n_embd)
        self.wpe = nn.Embedding(s.n_positions, s.n_embd)
        self.blocks = nn.ModuleList(_Block(s) for _ in range(s.n_layer))
        self.ln_f = nn.LayerNorm(s.n_embd)
        P = s.n_positions
        self.register_buffer(
            "mask", torch.triu(torch.full((P, P), -1e9), diagonal=1), persistent=False)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if "ln_" not in name:
                    p.normal_(0.0, 0.02, generator=gen)
                    if sharpen != 1.0 and name.startswith("blocks."):
                        p.mul_(sharpen)

    def forward(self, input_ids):
        T = input_ids.shape[1]
        pos = torch.arange(T, device=input_ids.device)
        x = self.wte(input_ids) + self.wpe(pos)
        for block in self.blocks:
            x = block(x, self.mask)
        return self.ln_f(x) @ self.wte.weight.t()


def _patch_exporter():
    """Skip the exporter's onnxscript post-processing, the one step that
    imports the ``onnx`` package."""
    from torch.onnx._internal.torchscript_exporter import onnx_proto_utils

    onnx_proto_utils._add_onnxscript_fn = lambda model_bytes, custom_opsets: model_bytes


def export(module: GPT2Module, path, batch: int = 1, seq: int = 8) -> str:
    """``module`` as ONNX at ``path``: input ``input_ids`` [batch, seq]
    int64, output ``logits`` [batch, seq, vocab], both axes dynamic."""
    _patch_exporter()
    ids = torch.zeros((batch, seq), dtype=torch.int64)
    axes = {0: "batch", 1: "seq"}
    with torch.no_grad():
        torch.onnx.export(
            module.eval(), (ids,), str(path), input_names=["input_ids"],
            output_names=["logits"], dynamic_axes={"input_ids": axes, "logits": axes},
            opset_version=17, dynamo=False,
        )
    return str(path)
