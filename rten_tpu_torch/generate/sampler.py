"""Samplers (the port of ``rten_tpu/generate/sampler.py``,
rten rten-generate/src/sampler.rs:12-95).

Host samplers run numpy over the [B, V] logits. ``DeviceSampler`` samples
inside the serving engine's fused k-step decode on the logits' device:
temperature, top-k and top-p, then a Gumbel-max draw from an explicit
``torch.Generator`` where the reference chains a JAX PRNG key. Its numpy
mirror (``sample_host``) serves the admission steps, whose logits are
already on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


class Sampler:
    def sample(self, logits: np.ndarray) -> np.ndarray:
        """logits [B, V] -> token ids [B]."""
        raise NotImplementedError


class ArgMaxSampler(Sampler):
    def sample(self, logits):
        return np.argmax(logits, axis=-1).astype(np.int32)


@dataclasses.dataclass
class DeviceSampler:
    """On-device sampling for the fused multi-step decode.

    ``transform`` and ``sample`` run on tensors on any device;
    ``sample_host`` applies the same filters in numpy. Both are
    deterministic for a fixed seed (``init_generator``)."""

    temperature: float = 1.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    seed: int = 0

    # -- device ---------------------------------------------------------------

    def transform(self, logits: torch.Tensor) -> torch.Tensor:
        """Temperature, then top-k, then top-p, on [B, V] logits; the
        dropped tokens become -inf."""
        x = logits.to(torch.float32)
        if self.temperature != 1.0:
            # The reference divides by the temperature under jit, where XLA
            # multiplies by the f32 reciprocal instead: so does this.
            x = x * float(np.float32(1) / np.float32(max(self.temperature, 1e-6)))
        neg_inf = float("-inf")
        if self.top_k is not None and 0 < self.top_k < x.shape[-1]:
            # The k-th largest value is the threshold; ties with it stay
            # (the reference's approx_max_k at recall 1.0 is exact).
            kth = torch.topk(x, self.top_k, dim=-1).values[..., -1:]
            x = x.masked_fill(x < kth, neg_inf)
        if self.top_p is not None and self.top_p < 1.0:
            sorted_x = torch.sort(x, dim=-1, descending=True).values
            # In f64: over a 50k vocabulary the f32 softmax's normalizer and
            # running sum differ between the CPU and the card by more than
            # the gap between neighbouring tokens' sums, so an f32 nucleus
            # would depend on the device.
            probs = torch.softmax(sorted_x.double(), dim=-1)
            cum = torch.cumsum(probs, dim=-1)
            keep_sorted = (cum - probs) < self.top_p  # top-1 always kept
            # The smallest kept logit of each row is its nucleus threshold.
            thresh = torch.where(keep_sorted, sorted_x, float("inf")).amin(-1, keepdim=True)
            x = x.masked_fill(x < thresh, neg_inf)
        return x

    def sample(self, logits: torch.Tensor, generator: Optional[torch.Generator],
               noise: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Optional[torch.Generator]]:
        """[B, V] logits -> (tokens [B] int32, the generator, advanced).

        Gumbel-max, as ``jax.random.categorical`` draws:
        ``argmax(transform(x) + g)`` with ``g = -log(-log(u))``, ``u``
        uniform from ``generator`` on the logits' device, clamped below at
        the smallest normal f32. ``noise`` replaces ``g`` (a caller's own
        Gumbel draw); the generator is then not read."""
        x = self.transform(logits)
        if noise is None:
            u = torch.rand(x.shape, generator=generator, device=x.device,
                           dtype=torch.float32)
            noise = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
        toks = torch.argmax(x + noise.to(x.device, torch.float32), dim=-1)
        return toks.to(torch.int32), generator

    def init_generator(self, device) -> torch.Generator:
        """A generator on ``device`` seeded with ``seed``."""
        return torch.Generator(device=torch.device(device)).manual_seed(self.seed)

    # -- host (numpy, for admission steps) --------------------------------------

    def transform_host(self, logits: np.ndarray) -> np.ndarray:
        x = np.asarray(logits, np.float64)
        if self.temperature != 1.0:
            x = x / max(self.temperature, 1e-6)
        if self.top_k is not None and 0 < self.top_k < x.shape[-1]:
            kth = np.partition(x, -self.top_k, axis=-1)[:, -self.top_k][:, None]
            x = np.where(x < kth, -np.inf, x)
        if self.top_p is not None and self.top_p < 1.0:
            order = np.argsort(-x, axis=-1)
            sx = np.take_along_axis(x, order, axis=-1)
            probs = np.exp(sx - sx[:, :1])
            probs /= probs.sum(axis=-1, keepdims=True)
            cum = np.cumsum(probs, axis=-1)
            keep_sorted = cum - probs < self.top_p
            keep = np.zeros_like(keep_sorted)
            np.put_along_axis(keep, order, keep_sorted, axis=-1)
            x = np.where(keep, x, -np.inf)
        return x

    def sample_host(self, logits: np.ndarray, rng: np.random.Generator):
        x = self.transform_host(logits)
        x = x - x.max(axis=-1, keepdims=True)
        probs = np.exp(x)
        probs /= probs.sum(axis=-1, keepdims=True)
        out = np.empty(probs.shape[0], np.int32)
        for b in range(probs.shape[0]):
            out[b] = rng.choice(probs.shape[-1], p=probs[b])
        return out


class MultinomialSampler(Sampler):
    """Softmax sampling from a numpy generator seeded with ``seed``,
    optionally with a temperature (also available as a filter)."""

    def __init__(self, seed: int = 0, temperature: float = 1.0):
        self.rng = np.random.default_rng(seed)
        self.temperature = temperature

    def sample(self, logits):
        logits = np.asarray(logits, np.float64)
        if self.temperature != 1.0:
            logits = logits / max(self.temperature, 1e-6)
        logits = logits - logits.max(axis=-1, keepdims=True)
        probs = np.exp(logits)
        probs /= probs.sum(axis=-1, keepdims=True)
        out = np.empty(probs.shape[0], np.int32)
        for b in range(probs.shape[0]):
            out[b] = self.rng.choice(probs.shape[-1], p=probs[b])
        return out
