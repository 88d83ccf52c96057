"""Einsum (the port of ``rten_tpu/ops/einsum.py``; rten src/ops/einsum.rs:22).

``torch.einsum`` plans the contractions as ``jnp.einsum`` does. The JAX
lowering asks for ``Precision.HIGHEST`` on f32 operands, so the products
here are full f32 whatever the caller's TF32 setting: on a CUDA device f32
operands are contracted in f64 and the result is rounded back to f32. The
op reads and writes no process-wide flag, so it is safe to call from any
thread while other threads run their own matmuls. Under
``RunConfig.prefer_bf16`` (the JAX package's DEFAULT precision) f32
operands on the card take one bf16 pass instead.
"""

from __future__ import annotations

import torch

from .matmul import contract
from .registry import OpError, as_tensor, register


@register("Einsum")
def _einsum(ctx, inputs, attrs):
    equation = attrs.get("equation")
    if equation is None:
        raise OpError("Einsum requires an equation")
    if isinstance(equation, bytes):
        equation = equation.decode()
    equation = equation.replace(" ", "")
    args = [as_tensor(ctx, x) for x in inputs if x is not None]
    return contract(ctx, lambda *ops: torch.einsum(equation, *ops), *args)
