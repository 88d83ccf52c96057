"""Unary, binary and variadic elementwise ops (the port of
``rten_tpu/ops/elementwise.py``: all of its 57 ops, Abs through Xor).

The JAX package lowers these to jnp expressions that XLA fuses into the
neighbouring matmuls; here each is a plain PyTorch expression, written in
the JAX package's arithmetic order. Binary and variadic ops promote their
operands as ``jnp`` does for arrays (``torch.promote_types`` on both, so a
0-d operand is no weaker than any other); Python-number attributes stay
weak, as in JAX.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .registry import OpError, as_tensor, get_input, opt_input, register

# jax.nn.gelu's constant, rounded to f32 as JAX rounds it.
_SQRT_2_OVER_PI = float(np.float32(math.sqrt(2.0 / math.pi)))
_SQRT_HALF = float(np.float32(math.sqrt(0.5)))


def promote(*xs: torch.Tensor):
    """The operands cast to their common ``jnp`` dtype."""
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return [x if x.dtype == dt else x.to(dt) for x in xs]


def _float(x: torch.Tensor) -> torch.Tensor:
    """Float ops on an integer or bool tensor compute in f32, as jnp's do."""
    return x if x.is_floating_point() else x.to(torch.float32)


def _unary(name: str, fn, floats: bool = True):
    @register(name)
    def lower(ctx, inputs, attrs, _fn=fn):
        x = as_tensor(ctx, get_input(inputs, 0))
        return _fn(_float(x) if floats else x)

    return lower


_unary("Abs", torch.abs, floats=False)
_unary("Acos", torch.acos)
_unary("Acosh", torch.acosh)
_unary("Asin", torch.asin)
_unary("Asinh", torch.asinh)
_unary("Atan", torch.atan)
_unary("Atanh", torch.atanh)
_unary("Ceil", torch.ceil, floats=False)
_unary("Cos", torch.cos)
_unary("Cosh", torch.cosh)
_unary("Erf", torch.erf)
_unary("Exp", torch.exp)
_unary("Floor", torch.floor, floats=False)
_unary("Log", torch.log)
_unary("Neg", torch.neg, floats=False)
_unary("Not", torch.logical_not, floats=False)
_unary("Reciprocal", lambda x: 1.0 / x, floats=False)
_unary("Relu", torch.relu, floats=False)
_unary("Sigmoid", torch.sigmoid)
# jnp.sign keeps NaN, where torch.sign gives 0.
_unary("Sign", lambda x: torch.where(torch.isnan(x), x, torch.sign(x)), floats=False)
_unary("Sin", torch.sin)
_unary("Sinh", torch.sinh)
# jax.nn.softplus is logaddexp(x, 0), with no threshold.
_unary("Softplus", lambda x: torch.logaddexp(x, torch.zeros_like(x)))
_unary("Sqrt", torch.sqrt)
_unary("Tan", torch.tan)
_unary("Tanh", torch.tanh)
_unary("IsNaN", torch.isnan, floats=False)
# x * sigmoid(x) in f64, rounded once: the two devices' f32 sigmoids part
# by an ulp (ROADMAP fault 5), their f64 results round alike.
_unary("Silu", lambda x: (x.double() * torch.sigmoid(x.double())).to(x.dtype))
# ONNX Round is round half to even, as torch.round and jnp.round are.
_unary("Round", torch.round, floats=False)


@register("IsInf")
def _isinf(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    out = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    if attrs.get("detect_positive", 1):
        out = out | (x == math.inf)
    if attrs.get("detect_negative", 1):
        out = out | (x == -math.inf)
    return out


@register("Elu")
def _elu(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    alpha = attrs.get("alpha", 1.0)
    return torch.where(x > 0, x, alpha * (torch.exp(x) - 1.0))


@register("LeakyRelu")
def _leaky_relu(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    return torch.where(x >= 0, x, attrs.get("alpha", 0.01) * x)


@register("PRelu")
def _prelu(ctx, inputs, attrs):
    x, slope = promote(as_tensor(ctx, get_input(inputs, 0)),
                       as_tensor(ctx, get_input(inputs, 1, "slope")))
    return torch.where(x >= 0, x, slope * x)


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


@register("HardSigmoid")
def _hard_sigmoid(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    return torch.clamp(attrs.get("alpha", 0.2) * x + attrs.get("beta", 0.5), 0.0, 1.0)


@register("HardSwish")
def _hard_swish(ctx, inputs, attrs):
    x = as_tensor(ctx, get_input(inputs, 0))
    return x * torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)


@register("Swish")
def _swish(ctx, inputs, attrs):
    """rten's fused Swish (alpha); ORT's contrib op calls it beta."""
    x = as_tensor(ctx, get_input(inputs, 0))
    beta = attrs.get("beta", attrs.get("alpha", 1.0))
    return x * torch.sigmoid(beta * x)


@register("Clip")
def _clip(ctx, inputs, attrs):
    """min/max as optional inputs (opset >= 11) or attributes."""
    x = as_tensor(ctx, get_input(inputs, 0))
    for i, key, fn in ((1, "min", torch.maximum), (2, "max", torch.minimum)):
        bound = opt_input(inputs, i, attrs.get(key))
        if bound is None:
            continue
        if isinstance(bound, (int, float)):
            x = torch.clamp(x, **{key: bound})
        else:
            x, b = promote(x, as_tensor(ctx, bound))
            x = fn(x, b)
    return x


# ---- binary -------------------------------------------------------------


def _binary(name: str, fn):
    @register(name)
    def lower(ctx, inputs, attrs, _fn=fn):
        a, b = promote(as_tensor(ctx, get_input(inputs, 0, "a")),
                       as_tensor(ctx, get_input(inputs, 1, "b")))
        return _fn(a, b)

    return lower


_binary("Add", torch.add)
_binary("Sub", torch.sub)
_binary("Mul", torch.mul)
_binary("And", torch.logical_and)
_binary("Or", torch.logical_or)
_binary("Xor", torch.logical_xor)
_binary("Equal", torch.eq)
_binary("Greater", torch.gt)
_binary("GreaterOrEqual", torch.ge)
_binary("Less", torch.lt)
_binary("LessOrEqual", torch.le)


@register("Div")
def _div(ctx, inputs, attrs):
    """Integer Div truncates toward zero (C semantics), as the JAX
    lowering's ``where((a < 0) ^ (b < 0), -q, q)`` does."""
    a, b = promote(as_tensor(ctx, get_input(inputs, 0, "a")),
                   as_tensor(ctx, get_input(inputs, 1, "b")))
    if a.is_floating_point():
        return a / b
    return torch.div(a, b, rounding_mode="trunc")


@register("Mod")
def _mod(ctx, inputs, attrs):
    """``fmod`` takes the dividend's sign, else the divisor's (jnp.mod)."""
    a, b = promote(as_tensor(ctx, get_input(inputs, 0, "a")),
                   as_tensor(ctx, get_input(inputs, 1, "b")))
    return torch.fmod(a, b) if attrs.get("fmod", 0) else torch.remainder(a, b)


@register("Pow")
def _pow(ctx, inputs, attrs):
    """The exponent is cast to the base's dtype first."""
    a = as_tensor(ctx, get_input(inputs, 0, "a"))
    b = as_tensor(ctx, get_input(inputs, 1, "b"))
    return torch.pow(a, b.to(a.dtype))


@register("Where")
def _where(ctx, inputs, attrs):
    cond = as_tensor(ctx, get_input(inputs, 0, "condition"))
    x, y = promote(as_tensor(ctx, get_input(inputs, 1, "x")),
                   as_tensor(ctx, get_input(inputs, 2, "y")))
    return torch.where(cond.to(torch.bool), x, y)


# ---- variadic -------------------------------------------------------------


def _operands(ctx, name, inputs):
    vals = [as_tensor(ctx, v) for v in inputs if v is not None]
    if not vals:
        raise OpError(f"{name} requires at least one input")
    return promote(*vals)


def _variadic(name: str, fn2):
    @register(name)
    def lower(ctx, inputs, attrs, _fn=fn2):
        vals = _operands(ctx, name, inputs)
        out = vals[0]
        for v in vals[1:]:
            out = _fn(out, v)
        return out

    return lower


_variadic("Max", torch.maximum)
_variadic("Min", torch.minimum)
_variadic("Sum", torch.add)


@register("Mean")
def _mean(ctx, inputs, attrs):
    vals = _operands(ctx, "Mean", inputs)
    out = vals[0]
    for v in vals[1:]:
        out = out + v
    return out / len(vals)
