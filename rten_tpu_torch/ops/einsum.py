"""Einsum (the port of ``rten_tpu/ops/einsum.py``; rten src/ops/einsum.rs:22).

``torch.einsum`` plans the contractions as ``jnp.einsum`` does. The JAX
lowering asks for ``Precision.HIGHEST`` on f32 operands, so the products
here are full f32 whatever the caller's TF32 setting: on a CUDA device f32
operands are contracted in f64 and the result is rounded back to f32. The
op reads and writes no process-wide flag, so it is safe to call from any
thread while other threads run their own matmuls.
"""

from __future__ import annotations

import torch

from .registry import OpError, as_tensor, register


def full_f32_einsum(equation: str, *args: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with f32 products that TF32 never touches: on a CUDA
    device, f32 operands go through f64 (cuBLAS has no TF32 path for f64)."""
    if args[0].device.type != "cuda" or any(a.dtype != torch.float32 for a in args):
        return torch.einsum(equation, *args)
    return torch.einsum(equation, *(a.double() for a in args)).float()


@register("Einsum")
def _einsum(ctx, inputs, attrs):
    equation = attrs.get("equation")
    if equation is None:
        raise OpError("Einsum requires an equation")
    if isinstance(equation, bytes):
        equation = equation.decode()
    args = [as_tensor(ctx, x) for x in inputs if x is not None]
    return full_f32_einsum(equation.replace(" ", ""), *args)
