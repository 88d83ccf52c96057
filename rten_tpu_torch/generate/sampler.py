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
