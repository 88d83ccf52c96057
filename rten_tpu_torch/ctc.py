"""CTC decoding (the port of ``rten_tpu/ctc.py``): greedy and (n-best)
beam search.

Analog of rten src/ctc.rs (:27 CtcDecoder, :153 greedy, :184 beam,
:212 n-best): post-processing for wav2vec2/TrOCR-style models over a
[sequence, class] probability matrix, with class 0 = blank.

Greedy decoding takes its arg-max where the probabilities live: a tensor
goes through ``functional.arg_max`` on its device (on the card, the argmax
kernel for f32), and only the [T] best classes and T best scores come back
to the host for the collapse; a numpy array through ``np.argmax``. Beam
search runs on the host in f64, as the JAX package runs it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np
import torch

from . import functional


@dataclasses.dataclass
class CtcHypothesis:
    labels: List[int]
    score: float  # log-probability


def ctc_greedy_decode(probs, blank: int = 0) -> CtcHypothesis:
    """probs [T, C] (linear or log; numpy, or a tensor on any device);
    collapse repeats, drop blanks. The score is the sum over steps of each
    step's best log-probability (log of the best probability where the
    input is linear: no entry is negative)."""
    if isinstance(probs, torch.Tensor):
        best = functional.arg_max(probs, axis=-1, device=probs.device).cpu().numpy()
        top = probs.amax(dim=-1).double().cpu().numpy()
        log_domain = bool((probs < 0).any())
    else:
        p = np.asarray(probs)
        best, log_domain = np.argmax(p, axis=-1), p.min() < 0
        top = p.max(axis=-1).astype(np.float64)
    if not log_domain:
        top = np.log(np.maximum(top, 1e-30))
    score = float(top.sum())
    labels: List[int] = []
    prev = -1
    for c in best.tolist():
        if c != blank and c != prev:
            labels.append(c)
        prev = c
    return CtcHypothesis(labels=labels, score=score)


def ctc_beam_search_decode(
    probs, beam_width: int = 10, n_best: int = 1, blank: int = 0
) -> List[CtcHypothesis]:
    """Prefix beam search (log domain, on the host). Returns n_best
    hypotheses."""
    if isinstance(probs, torch.Tensor):
        probs = probs.detach().cpu().numpy()
    probs = np.asarray(probs, np.float64)
    logp = probs if np.min(probs) < 0 else np.log(np.maximum(probs, 1e-30))
    T, C = logp.shape
    NEG = -math.inf

    def logaddexp(a, b):
        if a == NEG:
            return b
        if b == NEG:
            return a
        return np.logaddexp(a, b)

    # prefix -> (log P ending in blank, log P ending in non-blank)
    beams = {(): (0.0, NEG)}
    for t in range(T):
        # Prune classes: only top candidates matter.
        order = np.argsort(-logp[t])[: max(beam_width * 2, 8)]
        nxt: dict = {}
        for prefix, (pb, pnb) in beams.items():
            total = logaddexp(pb, pnb)
            for c in order:
                c = int(c)
                p = logp[t, c]
                if c == blank:
                    entry = nxt.setdefault(prefix, [NEG, NEG])
                    entry[0] = logaddexp(entry[0], total + p)
                elif prefix and c == prefix[-1]:
                    # Same as last label: extends non-blank path only after a
                    # blank; repeating without blank stays the same prefix.
                    entry = nxt.setdefault(prefix, [NEG, NEG])
                    entry[1] = logaddexp(entry[1], pnb + p)
                    ext = prefix + (c,)
                    entry2 = nxt.setdefault(ext, [NEG, NEG])
                    entry2[1] = logaddexp(entry2[1], pb + p)
                else:
                    ext = prefix + (c,)
                    entry = nxt.setdefault(ext, [NEG, NEG])
                    entry[1] = logaddexp(entry[1], total + p)
        # Keep top beams by total probability.
        scored = sorted(
            nxt.items(), key=lambda kv: -logaddexp(kv[1][0], kv[1][1])
        )[:beam_width]
        beams = {k: tuple(v) for k, v in scored}

    ranked = sorted(
        beams.items(), key=lambda kv: -logaddexp(kv[1][0], kv[1][1])
    )[:n_best]
    return [
        CtcHypothesis(labels=list(prefix), score=float(logaddexp(pb, pnb)))
        for prefix, (pb, pnb) in ranked
    ]


class CtcDecoder:
    """Interface mirror of rten CtcDecoder (src/ctc.rs:27)."""

    def __init__(self, blank: int = 0):
        self.blank = blank

    def decode_greedy(self, probs) -> CtcHypothesis:
        return ctc_greedy_decode(probs, self.blank)

    def decode_beam(self, probs, beam_width: int = 10) -> CtcHypothesis:
        return ctc_beam_search_decode(probs, beam_width, 1, self.blank)[0]

    def decode_beam_nbest(self, probs, beam_width: int = 10, n: int = 5):
        return ctc_beam_search_decode(probs, beam_width, n, self.blank)
