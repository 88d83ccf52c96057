"""The split argmax of ``rten_tpu_torch/kernels/argmax.py`` (``csrc/argmax.cu``)
modelled on the CPU: each row cut into the wrapper's real column chunks
(``chunk_plan``), a first-occurrence (value, index) pair per chunk, the
pairs merged in chunk order under the kernel's rule (a NaN first, then the
larger value, then the lower index). The model is held against
``jnp.argmax`` and the reference's Pallas kernel
(``argmax_lastdim_pallas(interpret=True)``) on numpy inputs, and against the
port's plain version, which the wrapper runs on CPU tensors. Exact
equality: an argmax has no tolerance.

The reference kernel departs from ``jnp.argmax`` on two inputs, and the
port keeps ``jnp.argmax``'s answer (the reference's own router sends every
device but the TPU there, and its docstring promises jnp.argmax's): a row
holding a NaN, and a row of all -inf (the kernel's running maximum starts
at -3e38 and a strictly-greater compare never takes -inf, so it returns
2**31 - 1, past the row's end).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rten_tpu.kernels.argmax import argmax_lastdim_pallas
from rten_tpu_torch.kernels import argmax as targmax

SMS = 132  # the H100's SMs: the plan the kernel runs on the card


def _better(v, i, bv, bi):
    """csrc/argmax.cu's better(): True when (v, i) replaces (bv, bi)."""
    if bi < 0:
        return i >= 0
    if i < 0:
        return False
    vn, bn = np.isnan(v), np.isnan(bv)
    if vn or bn:
        return bool(vn and (not bn or i < bi))
    return bool(v > bv or (v == bv and i < bi))


def split_argmax(x: np.ndarray, sms: int = SMS) -> np.ndarray:
    """The two stages of the kernel: per-chunk pairs, merged in chunk order."""
    M, N = x.shape
    chunks, length = targmax.chunk_plan(M, N, sms)
    out = np.empty(M, np.int32)
    for m in range(M):
        bv, bi = 0.0, -1
        for c in range(chunks):
            seg = x[m, c * length:min(N, (c + 1) * length)]
            j = int(np.argmax(seg))  # numpy: the first NaN, else the first maximum
            if _better(seg[j], c * length + j, bv, bi):
                bv, bi = seg[j], c * length + j
        out[m] = bi
    return out


def _check(x: np.ndarray, pallas: bool = True):
    """The model against jnp.argmax, the interpreted Pallas kernel and the
    port's wrapper (its plain version on CPU tensors)."""
    want = np.asarray(jnp.argmax(jnp.asarray(x), axis=-1)).astype(np.int32)
    got = split_argmax(x)
    np.testing.assert_array_equal(got, want)
    if pallas:
        np.testing.assert_array_equal(
            np.asarray(argmax_lastdim_pallas(jnp.asarray(x), interpret=True)), want)
    np.testing.assert_array_equal(targmax.argmax_lastdim(torch.from_numpy(x)).numpy(), want)
    return got


@pytest.mark.parametrize("M,N,want", [
    (16, 151936, (25, 6080)),   # Qwen's vocabulary at 16 slots
    (120, 50257, (4, 12568)),   # GPT-2 at the headline's 120 slots
    (16, 32000, (8, 4000)),     # TinyLlama
    (1, 1000, (1, 1000)),       # shorter than one chunk
    (1, 50257, (13, 3868)),
    (120, 3, (1, 4)),
    (4, 0, (1, 0)),
])
def test_chunk_plan(M, N, want):
    """Chunks fill 132 SMs about three times over, each at least 4096
    columns where the row allows; lengths are multiples of 4 (16-byte
    vectors) and no chunk is empty."""
    chunks, length = targmax.chunk_plan(M, N, SMS)
    assert (chunks, length) == want
    assert length % 4 == 0
    if N:
        assert (chunks - 1) * length < N <= chunks * length


def test_ties_straddling_chunk_boundaries():
    """At [16, 151936] (25 chunks of 6080): equal maxima on both sides of a
    boundary, in two chunks far apart, and three in a row over a boundary;
    the lowest index wins, whichever chunk's block would finish first."""
    rng = np.random.default_rng(0)
    M, N = 16, 151936
    x = rng.standard_normal((M, N), dtype=np.float32)
    C, L = targmax.chunk_plan(M, N, SMS)
    x[0, L - 1] = x[0, L] = 50.0                    # the last column of chunk 0, the first of 1
    x[1, 5 * L + 7] = x[1, (C - 2) * L] = 50.0      # chunks 5 and C - 2
    x[2, 2 * L - 1] = x[2, 2 * L] = x[2, 2 * L + 1] = 50.0
    x[3, (C - 1) * L] = x[3, (C - 1) * L - 1] = 50.0  # into the last (short) chunk
    got = _check(x)
    assert list(got[:4]) == [L - 1, 5 * L + 7, 2 * L - 1, (C - 1) * L - 1]


def test_maximum_in_first_and_last_column_of_a_strided_view():
    """The engine's view: the padded [120, 51200] lm_head output sliced to
    GPT-2's 50257 (odd) columns, 4 chunks a row; the maximum in column 0
    and in column N - 1."""
    rng = np.random.default_rng(1)
    full = rng.standard_normal((120, 51200), dtype=np.float32)
    full[:, 50257:] = 100.0  # past the slice: never read
    x = full[:, :50257]
    x[0, 0] = x[1, 50256] = 60.0
    x[2, 0] = x[2, 50256] = 60.0
    got = _check(np.ascontiguousarray(x))
    assert list(got[:3]) == [0, 50256, 0]
    view = torch.from_numpy(full)[:, :50257]
    assert view.stride() == (51200, 1)
    np.testing.assert_array_equal(targmax.argmax_lastdim(view).numpy(), got)


@pytest.mark.parametrize("M,N", [(1, 1000), (1, 50257), (3, 4097), (5, 8191)])
def test_one_row_short_rows_and_odd_n(M, N):
    """N below one chunk (one block writes the row's result), N odd, one
    row; the maximum placed at chunk edges and the row ends."""
    rng = np.random.default_rng(N)
    x = rng.standard_normal((M, N), dtype=np.float32)
    _, L = targmax.chunk_plan(M, N, SMS)
    x[0, min(L, N - 1)] = 9.0
    x[-1, N - 1] = 9.0
    _check(x)


def test_quirk_nan_rows_keep_jnp_argmax():
    """A NaN counts as the maximum and the first NaN wins (jnp.argmax, the
    kernel's better()), also across chunks; the reference Pallas kernel
    returns an arbitrary index on such rows, which the port does not
    mirror."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 50257), dtype=np.float32)
    x[0, 100] = x[0, 4000] = np.nan          # two NaNs, one chunk apart
    x[1, 10] = np.nan
    x[1, 30000] = np.nan
    x[2, 20000] = np.nan                     # a NaN after a large finite value
    x[2, 5] = 1e30
    got = _check(x, pallas=False)
    assert list(got[:3]) == [100, 10, 20000]
    ref = np.asarray(argmax_lastdim_pallas(jnp.asarray(x), interpret=True))
    assert ref[3] == got[3]                   # no NaN: the same answer
    assert (ref[:3] != got[:3]).any()         # the reference's quirk, recorded


def test_quirk_all_minus_inf_row_keeps_jnp_argmax():
    """A row of all -inf gives 0, as jnp.argmax does (every value ties);
    the reference Pallas kernel gives 2**31 - 1. A row of -inf but for one
    finite value gives that value's index on every side."""
    x = np.full((3, 5000), -np.inf, np.float32)
    x[1, 4321] = -1e30
    x[2, :] = np.random.default_rng(3).standard_normal(5000, dtype=np.float32)
    got = _check(x, pallas=False)
    assert list(got) == [0, 4321, int(np.argmax(x[2]))]
    ref = np.asarray(argmax_lastdim_pallas(jnp.asarray(x), interpret=True))
    assert ref[0] == 2**31 - 1 and list(ref[1:]) == list(got[1:])
