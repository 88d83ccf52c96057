"""Random ops (the port of ``rten_tpu/ops/random.py``; rten
src/ops/random.rs): RandomNormal, RandomNormalLike, RandomUniform,
RandomUniformLike and Multinomial.

Each draw takes its own ``torch.Generator`` on the executor's device from
``TraceContext.next_rng``, seeded from ``RunConfig.seed``, the run and the
draw's counter, so a run is reproducible per executor and an unseeded op
draws anew on every run. A ``seed`` attribute pins the draw, as ONNX
specifies. The executor runs these ops on its device even when they have no
input (``RANDOM_OPS``), and the optimizer never folds them.

Deliberate departure: the draws are PyTorch's, not ``jax.random``'s
threefry streams, so the two packages agree in distribution, not bit for
bit (``tests/test_torch_random.py`` holds the moments and the seed rules).
"""

from __future__ import annotations

import numpy as np
import torch

from ..dtypes import DataType
from .registry import as_tensor, get_input, register

RANDOM_OPS = frozenset({"RandomNormal", "RandomNormalLike", "RandomUniform",
                        "RandomUniformLike", "Multinomial"})


def seeded_generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def _generator(ctx, attrs) -> torch.Generator:
    seed = attrs.get("seed")
    if seed is not None:
        return seeded_generator(np.int64(np.float64(seed)).item() & 0x7FFFFFFF, ctx.device)
    return ctx.next_rng()


def _dtype(attrs) -> torch.dtype:
    """The ``dtype`` attribute as the JAX lowering maps it: a DataType as it
    is, an ONNX code (float, double, float16) or none as f32."""
    dt = attrs.get("dtype")
    if isinstance(dt, DataType):
        return dt.torch_dtype
    return torch.float32


def _shape(inputs, attrs, like: bool):
    return tuple(get_input(inputs, 0).shape) if like else tuple(attrs.get("shape", ()))


def _normal(ctx, inputs, attrs, like: bool):
    x = torch.randn(_shape(inputs, attrs, like), generator=_generator(ctx, attrs),
                    dtype=_dtype(attrs), device=ctx.device)
    return x * attrs.get("scale", 1.0) + attrs.get("mean", 0.0)


def _uniform(ctx, inputs, attrs, like: bool):
    low, high = attrs.get("low", 0.0), attrs.get("high", 1.0)
    x = torch.rand(_shape(inputs, attrs, like), generator=_generator(ctx, attrs),
                   dtype=_dtype(attrs), device=ctx.device)
    return x * (high - low) + low


register("RandomNormal")(lambda ctx, inputs, attrs: _normal(ctx, inputs, attrs, False))
register("RandomNormalLike")(lambda ctx, inputs, attrs: _normal(ctx, inputs, attrs, True))
register("RandomUniform")(lambda ctx, inputs, attrs: _uniform(ctx, inputs, attrs, False))
register("RandomUniformLike")(lambda ctx, inputs, attrs: _uniform(ctx, inputs, attrs, True))


@register("Multinomial")
def _multinomial(ctx, inputs, attrs):
    """``sample_size`` draws per row of unnormalized log-probabilities
    [batch, classes] -> int32 [batch, sample_size]."""
    logits = as_tensor(ctx, get_input(inputs, 0)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    out = torch.multinomial(probs, int(attrs.get("sample_size", 1)), replacement=True,
                            generator=_generator(ctx, attrs))
    return out.to(torch.int32)
