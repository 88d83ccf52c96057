"""Logits filters (a copy of ``rten_tpu/generate/filter.py``; rten
rten-generate/src/filter.rs:45-308).

A filter maps [B, V] logits -> [B, V] logits before sampling; compose with
``Chain``. Filters run on host numpy (tiny vs the model step).
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

NEG_INF = -np.inf


class LogitsFilter:
    def apply(self, logits: np.ndarray, prev_ids) -> np.ndarray:
        raise NotImplementedError


class Temperature(LogitsFilter):
    def __init__(self, temperature: float):
        self.t = max(temperature, 1e-6)

    def apply(self, logits, prev_ids):
        return logits / self.t


class TopK(LogitsFilter):
    def __init__(self, k: int):
        self.k = k

    def apply(self, logits, prev_ids):
        if self.k <= 0 or self.k >= logits.shape[-1]:
            return logits
        kth = np.partition(logits, -self.k, axis=-1)[:, -self.k][:, None]
        return np.where(logits < kth, NEG_INF, logits)


class TopP(LogitsFilter):
    """Nucleus sampling: keep the smallest set of tokens with cumulative
    probability >= p."""

    def __init__(self, p: float):
        self.p = p

    def apply(self, logits, prev_ids):
        if self.p >= 1.0:
            return logits
        order = np.argsort(-logits, axis=-1)
        sorted_logits = np.take_along_axis(logits, order, axis=-1)
        lmax = sorted_logits[:, :1]
        probs = np.exp(sorted_logits - lmax)
        probs /= probs.sum(axis=-1, keepdims=True)
        cum = np.cumsum(probs, axis=-1)
        keep_sorted = cum - probs < self.p  # always keep at least the top-1
        keep = np.zeros_like(keep_sorted)
        np.put_along_axis(keep, order, keep_sorted, axis=-1)
        return np.where(keep, logits, NEG_INF)


class RepetitionPenalty(LogitsFilter):
    """Divide (positive) / multiply (negative) logits of seen tokens."""

    def __init__(self, penalty: float):
        self.penalty = penalty

    def apply(self, logits, prev_ids):
        if self.penalty == 1.0 or prev_ids is None:
            return logits
        out = logits.copy()
        for b in range(out.shape[0]):
            seen = np.unique(np.asarray(prev_ids[b], np.int64))
            seen = seen[(seen >= 0) & (seen < out.shape[-1])]
            vals = out[b, seen]
            out[b, seen] = np.where(
                vals > 0, vals / self.penalty, vals * self.penalty
            )
        return out


def token_id_filter(suppress: Iterable[int]) -> "Chain":
    """Suppress specific token ids (rten filter.rs token_id_filter)."""
    ids = np.asarray(list(suppress), np.int64)

    class _Suppress(LogitsFilter):
        def apply(self, logits, prev_ids):
            out = logits.copy()
            out[:, ids] = NEG_INF
            return out

    return _Suppress()


class Chain(LogitsFilter):
    def __init__(self, *filters: LogitsFilter):
        self.filters = list(filters)

    def apply(self, logits, prev_ids):
        for f in self.filters:
            logits = f.apply(logits, prev_ids)
        return logits
