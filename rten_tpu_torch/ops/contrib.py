"""Microsoft contrib ops, com.microsoft domain (the port of
``rten_tpu/ops/contrib.py``; rten src/op_registry/onnx_registry.rs:275-295):
the GELU variants and the skip / simplified layer norms that ORT-optimized
and onnxruntime-genai exports carry.

* ``BiasGelu`` and ``GeluMicrosoft``: the exact erf GELU; ``FastGelu``:
  the tanh form, with an optional bias; ``QuickGelu``: ``x * sigmoid(alpha
  * x)``, alpha 1.702 by default.
* ``SimplifiedLayerNormalization`` and ``SkipSimplifiedLayerNormalization``
  go through ``norm.rms_norm``, which computes in f64 and rounds once to
  f32 (the card and the CPU then round alike, ROADMAP fault 5), over the one
  axis ``axis`` names, as the JAX lowering reduces it.
* ``SkipLayerNormalization`` and ``SkipSimplifiedLayerNormalization``
  normalize ``x + skip (+ bias)`` over the last axis and return the JAX
  lowering's outputs: zero scalars for mean and inv_std_var, and the sum
  itself as output 3 when four outputs are asked for.
"""

from __future__ import annotations

import torch

from .elementwise import gelu
from .norm import layer_norm, rms_norm
from .registry import as_tensor, get_input, opt_input, register


def _biased(ctx, inputs, i):
    """Input 0 plus the optional bias at input ``i``."""
    x = as_tensor(ctx, get_input(inputs, 0))
    bias = opt_input(inputs, i)
    return x if bias is None else x + as_tensor(ctx, bias)


@register("BiasGelu")
def _bias_gelu(ctx, inputs, attrs):
    get_input(inputs, 1, "bias")
    return gelu(_biased(ctx, inputs, 1), approximate=False)


@register("FastGelu")
def _fast_gelu(ctx, inputs, attrs):
    return gelu(_biased(ctx, inputs, 1), approximate=True)


@register("GeluMicrosoft")
def _gelu_ms(ctx, inputs, attrs):
    return gelu(as_tensor(ctx, get_input(inputs, 0)), approximate=False)


@register("QuickGelu")
def _quick_gelu(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    return x * torch.sigmoid(attrs.get("alpha", 1.702) * x)


@register("SimplifiedLayerNormalization")
def _simplified_layer_norm(ctx, inputs, attrs):
    """RMSNormalization over ``axis`` (rten norm/contrib.rs:86)."""
    x = as_tensor(ctx, get_input(inputs, 0))
    scale = as_tensor(ctx, get_input(inputs, 1, "scale"))
    return rms_norm(x, scale, attrs.get("axis", -1), attrs.get("epsilon", 1e-5))


def _skip_outputs(out, total, attrs):
    """``out`` alone, or with the mean and inv_std_var outputs (zero
    scalars) and, as output 3, the residual sum (rten norm/contrib.rs:123)."""
    n_out = attrs.get("__n_outputs__", 1)
    if n_out == 1:
        return out
    zero = torch.zeros((), dtype=torch.float32, device=out.device)
    if n_out >= 4:
        return (out, zero, zero, total)
    return (out,) + (zero,) * (n_out - 1)


def _skip_sum(ctx, inputs, bias_at):
    total = as_tensor(ctx, get_input(inputs, 0)) + as_tensor(ctx, get_input(inputs, 1, "skip"))
    bias = opt_input(inputs, bias_at)
    return total if bias is None else total + as_tensor(ctx, bias)


@register("SkipLayerNormalization")
def _skip_layer_norm(ctx, inputs, attrs):
    """LayerNorm(x + skip (+ bias)); inputs x, skip, gamma, beta, bias."""
    total = _skip_sum(ctx, inputs, 4)
    gamma = as_tensor(ctx, get_input(inputs, 2, "gamma"))
    beta = opt_input(inputs, 3)
    out = layer_norm(total, gamma, None if beta is None else as_tensor(ctx, beta), -1,
                     attrs.get("epsilon", 1e-5))
    return _skip_outputs(out, total, attrs)


@register("SkipSimplifiedLayerNormalization")
def _skip_simplified_layer_norm(ctx, inputs, attrs):
    """RMSNorm(x + skip (+ bias)); inputs x, skip, gamma, bias."""
    total = _skip_sum(ctx, inputs, 3)
    gamma = as_tensor(ctx, get_input(inputs, 2, "gamma"))
    out = rms_norm(total, gamma, -1, attrs.get("epsilon", 1e-5))
    return _skip_outputs(out, total, attrs)
