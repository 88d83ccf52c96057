"""The port's gathers and scatters (``rten_tpu_torch/ops/gather.py``)
against the JAX package's lowerings (``rten_tpu/ops/gather.py``), one-node
graphs built by both packages and run on the CPU on the same numpy inputs
from a seed: negative, out-of-range and duplicate indices, every
reduction, GatherND at batch_dims 0, 1 and 2. Integer results and
reduction "none" equal, element for element (NaN where JAX fills NaN);
float add and mul, whose order of combination differs, within 1e-6 of
max|out|.

The JAX package's treatment, which the port matches: a gather normalizes a
negative index once itself and once more in ``jnp.take`` /
``jnp.take_along_axis``, and an index still out of range reads the fill
value (NaN, the most negative signed integer); ``x.at[...]`` normalizes a
negative index once more and drops an update still out of range, and of
several updates to one element with reduction "none" the last in the
updates' row-major order wins."""

import numpy as np
import pytest

from rten_tpu.dtypes import DataType as JDataType
from rten_tpu.ir.builder import GraphBuilder as JBuilder
from rten_tpu.model import Model as JModel
from rten_tpu.model import ModelOptions as JOptions
from rten_tpu_torch.dtypes import DataType as TDataType
from rten_tpu_torch.ir.builder import GraphBuilder as TBuilder
from rten_tpu_torch.model import Model as TModel
from rten_tpu_torch.model import ModelOptions as TOptions

DT = {np.dtype(np.float32): "Float", np.dtype(np.int32): "Int32"}


def _run_both(op, feed, attrs):
    def build(GB, D):
        b = GB()
        ins = [b.input(n, getattr(D, DT[a.dtype])) for n, a in feed.items()]
        b.output(b.op(op, ins, attrs, output_names=["y"]))
        return b.finish()

    got = TModel(build(TBuilder, TDataType), TOptions(optimize=False),
                 device="cpu").run(dict(feed), ["y"])[0].numpy()
    want = np.asarray(JModel(build(JBuilder, JDataType), JOptions(optimize=False)).run(
        dict(feed), ["y"])[0])
    assert got.shape == want.shape and got.dtype == want.dtype
    return got, want


def _data(dtype, *shape, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == np.int32:
        return rng.integers(-50, 50, shape).astype(np.int32)
    return rng.standard_normal(shape).astype(np.float32)


def _idx(lo, hi, *shape, seed=1):
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(np.int32)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("axis", [0, 1, -1])
def test_gather_elements_matches_jax(dtype, axis):
    """Indices from -3n to 3n along the axis: each side normalizes, reads,
    or fills alike."""
    x = _data(dtype, 5, 6, 7)
    n = x.shape[axis]
    shape = list(x.shape)
    shape[axis] = 9
    got, want = _run_both("GatherElements", {"x": x, "i": _idx(-3 * n, 3 * n, *shape)},
                          {"axis": axis})
    np.testing.assert_array_equal(got, want)
    if dtype == np.float32:
        assert np.isnan(got).any() and not np.isnan(got).all()


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_gather_matches_jax_out_of_range(dtype):
    """Gather with indices from -2n to 2n: the second normalization of
    ``jnp.take`` and its fill."""
    x = _data(dtype, 6, 5)
    got, want = _run_both("Gather", {"x": x, "i": _idx(-12, 12, 4, 3)}, {"axis": 0})
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("batch_dims", [0, 1, 2])
@pytest.mark.parametrize("k", [1, 2])
def test_gather_nd_matches_jax(dtype, batch_dims, k):
    """GatherND at batch_dims 0, 1 and 2, one or two index components,
    negative and out-of-range components."""
    x = _data(dtype, 3, 4, 5, 6)
    lead = (3, 4)[:batch_dims]
    dims = x.shape[batch_dims:batch_dims + k]
    i = _idx(-max(dims) - 2, max(dims) + 2, *(lead + (7, k)))
    got, want = _run_both("GatherND", {"x": x, "i": i}, {"batch_dims": batch_dims})
    np.testing.assert_array_equal(got, want)


REDUCTIONS = ["none", "add", "mul", "max", "min"]


def _check(got, want, reduction, dtype):
    if reduction in ("add", "mul") and dtype == np.float32:
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op,reduction", [("ScatterElements", r) for r in REDUCTIONS]
                         + [("Scatter", "none")])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("axis", [0, -1])
def test_scatter_elements_matches_jax(op, dtype, reduction, axis):
    """Forty updates a column into 5 rows (or rows into 5 columns), indices
    from -8 to 8: duplicates, negatives normalized twice, and updates
    dropped out of range; Scatter, the deprecated alias, as ONNX defines
    it (no reduction)."""
    x = _data(dtype, 5, 5)
    shape = (40, 5) if axis == 0 else (5, 40)
    feed = {"x": x, "i": _idx(-8, 8, *shape), "u": _data(dtype, *shape, seed=2)}
    got, want = _run_both(op, feed, {"axis": axis, "reduction": reduction})
    _check(got, want, reduction, dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("k", [1, 2, 3])
def test_scatter_nd_matches_jax(dtype, reduction, k):
    """ScatterND into [4, 5, 6] with k index components (slices of the rest),
    30 updates: duplicates, negative and out-of-range components."""
    x = _data(dtype, 4, 5, 6)
    i = _idx(-7, 7, 30, k)
    u = _data(dtype, *((30,) + x.shape[k:]), seed=3)
    got, want = _run_both("ScatterND", {"x": x, "i": i, "u": u}, {"reduction": reduction})
    _check(got, want, reduction, dtype)


def test_last_duplicate_wins():
    """Reduction "none": of the updates to one element, the last in the
    updates' order is written (JAX's answer on the CPU, which the port
    resolves before it writes, so the card gives it too)."""
    x = np.zeros(4, np.float32)
    i = np.array([1, 3, 1, 1, -1, 9], np.int32)
    u = np.array([10, 20, 30, 40, 50, 60], np.float32)
    got, want = _run_both("ScatterElements", {"x": x, "i": i, "u": u}, {"axis": 0})
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [0, 40, 0, 50])
