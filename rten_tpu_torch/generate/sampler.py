"""Host samplers (the port of ``rten_tpu/generate/sampler.py``,
rten rten-generate/src/sampler.rs:12-95). On-device sampling
(``DeviceSampler``) waits for ROADMAP.md queue 1 item 6."""

from __future__ import annotations

import numpy as np


class Sampler:
    def sample(self, logits: np.ndarray) -> np.ndarray:
        """logits [B, V] -> token ids [B]."""
        raise NotImplementedError


class ArgMaxSampler(Sampler):
    def sample(self, logits):
        return np.argmax(logits, axis=-1).astype(np.int32)


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
