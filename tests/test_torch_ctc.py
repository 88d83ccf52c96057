"""The port's CTC decoders (``rten_tpu_torch/ctc.py``) against the JAX
package's: greedy, beam and n-best on seeded [T, C] probabilities and
log-probabilities, as numpy arrays and as tensors; the same labels, and
scores within 1e-5 relative (the greedy score sums in f64 here, in the
input's dtype there)."""

from itertools import product

import numpy as np
import pytest
import torch

from rten_tpu import ctc as jctc
from rten_tpu_torch import ctc, functional
from rten_tpu_torch.kernels import argmax

RTOL = 1e-5


def _probs(seed, T, C, log, sharp=3.0):
    x = np.random.default_rng(seed).standard_normal((T, C)).astype(np.float32) * sharp
    x = x - x.max(-1, keepdims=True)
    p = np.exp(x) / np.exp(x).sum(-1, keepdims=True)
    return np.log(p).astype(np.float32) if log else p.astype(np.float32)


def _same(a, b):
    assert a.labels == b.labels
    assert a.score == pytest.approx(b.score, rel=RTOL)


@pytest.mark.parametrize("log", [False, True], ids=["probs", "logp"])
@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_beam_nbest_match_jax(seed, as_tensor, log):
    p = _probs(seed, 40, 12, log)
    x = torch.from_numpy(p) if as_tensor else p
    _same(ctc.ctc_greedy_decode(x), jctc.ctc_greedy_decode(p))
    for width in (1, 4, 10):
        got = ctc.ctc_beam_search_decode(x, beam_width=width, n_best=3)
        want = jctc.ctc_beam_search_decode(p, beam_width=width, n_best=3)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b)
    dec, jdec = ctc.CtcDecoder(blank=2), jctc.CtcDecoder(blank=2)
    _same(dec.decode_greedy(x), jdec.decode_greedy(p))
    _same(dec.decode_beam(x, 6), jdec.decode_beam(p, 6))
    for a, b in zip(dec.decode_beam_nbest(x, 6, 4), jdec.decode_beam_nbest(p, 6, 4)):
        _same(a, b)


def test_greedy_of_a_tensor_takes_its_argmax_through_functional(monkeypatch):
    """A tensor's arg-max runs through ``functional.arg_max`` on the
    tensor's device (the argmax wrapper for f32; on the card its kernel);
    log-probs from ``functional.log_softmax`` decode as the JAX package
    decodes them."""
    calls = []
    real = argmax.argmax_lastdim

    def spy(x):
        calls.append(tuple(x.shape))
        return real(x)

    monkeypatch.setattr("rten_tpu_torch.ops.reduce.argmax_lastdim", spy)
    logits = np.random.default_rng(5).standard_normal((30, 9)).astype(np.float32) * 4
    logp = functional.log_softmax(logits, device="cpu")
    hyp = ctc.ctc_greedy_decode(logp)
    assert calls == [(30, 9)]
    _same(hyp, jctc.ctc_greedy_decode(logp.numpy()))
    _same(ctc.ctc_beam_search_decode(logp, 8)[0], jctc.ctc_beam_search_decode(logp.numpy(), 8)[0])


def test_beam_search_finds_the_best_labelling():
    """tests/test_aux.py's case where greedy is not the best labelling:
    the beam's best equals brute force over every path."""
    probs = np.array([[0.4, 0.6, 0.0], [0.4, 0.0, 0.6], [0.5, 0.5, 0.0]])
    totals = {}
    for path in product(range(3), repeat=3):
        lab, prev = [], -1
        for c in path:
            if c != 0 and c != prev:
                lab.append(c)
            prev = c
        totals[tuple(lab)] = totals.get(tuple(lab), 0.0) + np.prod(
            [probs[t, c] for t, c in enumerate(path)])
    best = max(totals.items(), key=lambda kv: kv[1])
    beams = ctc.ctc_beam_search_decode(torch.from_numpy(probs), beam_width=8, n_best=3)
    assert tuple(beams[0].labels) == best[0]
    assert abs(np.exp(beams[0].score) - best[1]) < 1e-6
    assert ctc.ctc_greedy_decode(probs).labels == jctc.ctc_greedy_decode(probs).labels
