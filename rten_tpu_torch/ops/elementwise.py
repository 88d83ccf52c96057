"""Elementwise ops of the serving and generation graphs (the port of
``rten_tpu/ops/elementwise.py``: Add, Sub, Mul, Gelu and Silu).

The JAX package lowers these to jnp expressions that XLA fuses into the
neighbouring matmuls; here each is a plain PyTorch expression, written in
the JAX package's arithmetic order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .registry import as_tensor, get_input, register

# jax.nn.gelu's constant, rounded to f32 as JAX rounds it.
_SQRT_2_OVER_PI = float(np.float32(math.sqrt(2.0 / math.pi)))
_SQRT_HALF = float(np.float32(math.sqrt(0.5)))


@register("Add")
def _add(ctx, inputs, attrs):
    a = as_tensor(ctx, get_input(inputs, 0))
    b = as_tensor(ctx, get_input(inputs, 1))
    return a + b


@register("Sub")
def _sub(ctx, inputs, attrs):
    a = as_tensor(ctx, get_input(inputs, 0))
    b = as_tensor(ctx, get_input(inputs, 1))
    return a - b


@register("Mul")
def _mul(ctx, inputs, attrs):
    a = as_tensor(ctx, get_input(inputs, 0))
    b = as_tensor(ctx, get_input(inputs, 1))
    return a * b


def gelu(x: torch.Tensor, approximate: bool) -> torch.Tensor:
    """jax.nn.gelu: ``x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3)))``
    with ``approximate``, else ``0.5 * x * erfc(-x / sqrt(2))``."""
    if approximate:
        cdf = 0.5 * (1.0 + torch.tanh(_SQRT_2_OVER_PI * (x + 0.044715 * (x * x * x))))
        return x * cdf
    return 0.5 * x * torch.special.erfc(-x * _SQRT_HALF)


@register("Gelu")
def _gelu(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    return gelu(x, attrs.get("approximate", "none") == "tanh")


@register("Silu")
def _silu(ctx, inputs, attrs):
    """``x * sigmoid(x)``, as ``x * jax.nn.sigmoid(x)``."""
    x = as_tensor(ctx, get_input(inputs, 0))
    return x * torch.sigmoid(x)
