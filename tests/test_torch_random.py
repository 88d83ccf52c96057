"""The port's random ops (``rten_tpu_torch/ops/random.py``) and the
executor's seed rules (``rten_tpu_torch/runtime/executor.py``) against the
JAX package's, on the CPU.

The draws are PyTorch's, not ``jax.random``'s threefry streams (a
deliberate departure, ROADMAP.md), so the packages are held to the same
rules and the same distributions, not the same bits:

* an unseeded op draws anew on every run of one model; two models at one
  ``RunConfig.seed`` draw the same sequence, and other seeds other draws;
  a ``seed`` attribute pins the draw on every run and in every model;
* the moments of 2^16 draws within 5 sigma of the distribution's, in both
  packages; Multinomial's frequencies against softmax of its logits by a
  chi-square test at p > 1e-4, in both; shapes and dtypes as the JAX
  lowering gives them (``dtype`` codes mapped as ``_dtype`` maps them,
  Multinomial int32 [batch, sample_size]);
* constant propagation leaves a random op and what it feeds unfolded, and
  the op draws on the executor's device even when it has no input.
"""

import numpy as np
import pytest
from scipy.stats import chi2

from rten_tpu.dtypes import DataType as JDataType
from rten_tpu.ir.builder import GraphBuilder as JBuilder
from rten_tpu.model import Model as JModel
from rten_tpu.model import ModelOptions as JOptions
from rten_tpu.runtime.executor import RunConfig as JRunConfig
from rten_tpu_torch.dtypes import DataType as TDataType
from rten_tpu_torch.ir.builder import GraphBuilder as TBuilder
from rten_tpu_torch.model import Model as TModel
from rten_tpu_torch.model import ModelOptions as TOptions
from rten_tpu_torch.runtime.executor import RunConfig as TRunConfig

N = 2 ** 16


def _graph(GB, DT, op, attrs, like=None):
    b = GB()
    ins = [] if like is None else [b.input("x", DT.Float, like)]
    y = b.op(op, ins, attrs, output_names=["y"])
    b.output(y)
    return b.finish()


def _models(op, attrs, like=None, seed=0, optimize=False):
    t = TModel(_graph(TBuilder, TDataType, op, attrs, like),
               TOptions(optimize=optimize, run_config=TRunConfig(seed=seed)), device="cpu")
    j = JModel(_graph(JBuilder, JDataType, op, attrs, like),
               JOptions(optimize=optimize, run_config=JRunConfig(seed=seed)))
    return t, j


def _draw(t, j, feed):
    return t.run(dict(feed))[0].numpy(), np.asarray(j.run(dict(feed))[0])


CASES = [  # op, attrs, like, mean, variance, fourth central moment
    ("RandomNormal", {"shape": [N], "mean": 1.5, "scale": 2.0}, None, 1.5, 4.0, 48.0),
    ("RandomNormalLike", {"mean": -1.0, "scale": 0.5}, (N,), -1.0, 0.25, 3 * 0.0625),
    ("RandomUniform", {"shape": [N], "low": -2.0, "high": 4.0}, None, 1.0, 3.0, 6.0 ** 4 / 80),
    ("RandomUniformLike", {}, (N,), 0.5, 1 / 12, 1 / 80),
]


def _feed(like):
    return {} if like is None else {"x": np.zeros(like, np.float32)}


@pytest.mark.parametrize("op,attrs,like,mean,var,mu4", CASES)
def test_moments_and_seed_rules_match_jax(op, attrs, like, mean, var, mu4):
    t, j = _models(op, attrs, like, seed=7)
    feed = _feed(like)
    (a, ja), (b, jb) = _draw(t, j, feed), _draw(t, j, feed)
    assert a.shape == ja.shape == (N,) and a.dtype == ja.dtype == np.float32
    for x, y in ((a, b), (ja, jb)):  # an unseeded op draws anew on every run
        assert not np.array_equal(x, y)
    t2, j2 = _models(op, attrs, like, seed=7)
    np.testing.assert_array_equal(t2.run(dict(feed))[0].numpy(), a)
    np.testing.assert_array_equal(np.asarray(j2.run(dict(feed))[0]), ja)
    t3, _ = _models(op, attrs, like, seed=8)
    assert not np.array_equal(t3.run(dict(feed))[0].numpy(), a)
    for x in (a, b, ja):
        z_mean = (x.astype(np.float64).mean() - mean) / np.sqrt(var / N)
        z_var = (x.astype(np.float64).var() - var) / np.sqrt((mu4 - var ** 2) / N)
        assert abs(z_mean) < 5 and abs(z_var) < 5, (z_mean, z_var)
    if op.startswith("RandomUniform"):
        lo, hi = attrs.get("low", 0.0), attrs.get("high", 1.0)
        assert (a >= lo).all() and (a < hi).all()


@pytest.mark.parametrize("op,attrs,like", [(c[0], c[1], c[2]) for c in CASES])
def test_seed_attribute_pins_the_draw(op, attrs, like):
    """A ``seed`` attribute: the same draw on every run and in every model,
    whatever RunConfig.seed; another seed attribute, another draw."""
    feed = _feed(like)
    t, j = _models(op, {**attrs, "seed": 3.0}, like, seed=1)
    a = t.run(dict(feed))[0].numpy()
    np.testing.assert_array_equal(t.run(dict(feed))[0].numpy(), a)
    np.testing.assert_array_equal(
        _models(op, {**attrs, "seed": 3.0}, like, seed=2)[0].run(dict(feed))[0].numpy(), a)
    assert not np.array_equal(
        _models(op, {**attrs, "seed": 4.0}, like)[0].run(dict(feed))[0].numpy(), a)
    ja, jb = (np.asarray(j.run(dict(feed))[0]) for _ in range(2))
    np.testing.assert_array_equal(ja, jb)


@pytest.mark.parametrize("code", [1, 10, 11, None])
def test_dtype_codes_as_jax_maps_them(code):
    """The ``dtype`` attribute's ONNX codes (float, float16, double) and its
    absence all draw f32, as the JAX lowering's ``_dtype`` maps them."""
    attrs = {"shape": [3, 4]} if code is None else {"shape": [3, 4], "dtype": code}
    a, ja = _draw(*_models("RandomNormal", attrs), {})
    assert a.dtype == ja.dtype == np.float32 and a.shape == ja.shape == (3, 4)


def test_multinomial_frequencies_match_softmax():
    """Multinomial: int32 [batch, sample_size], classes drawn with the
    softmax of the row's logits in both packages (chi-square, 7 degrees of
    freedom, p > 1e-4)."""
    logits = np.array([[0.0, 1.0, 2.0, -1.0, 0.5, 3.0, -2.0, 1.5],
                       [2.0, 2.0, 0.0, 0.0, -1.0, 1.0, 0.5, 0.0]], np.float32)

    def build(GB, DT):
        b = GB()
        y = b.op("Multinomial", [b.input("x", DT.Float, (2, 8))], {"sample_size": N // 4},
                 output_names=["y"])
        b.output(y)
        return b.finish()

    t = TModel(build(TBuilder, TDataType), TOptions(optimize=False), device="cpu")
    j = JModel(build(JBuilder, JDataType), JOptions(optimize=False))
    for draws in (t.run({"x": logits})[0].numpy(), np.asarray(j.run({"x": logits})[0])):
        assert draws.dtype == np.int32 and draws.shape == (2, N // 4)
        for row in range(2):
            counts = np.bincount(draws[row], minlength=8).astype(np.float64)
            p = np.exp(logits[row] - logits[row].max())
            expect = p / p.sum() * counts.sum()
            assert chi2.sf(((counts - expect) ** 2 / expect).sum(), 7) > 1e-4


def test_random_ops_are_never_folded():
    """Constant propagation at load leaves a random op with no input, and
    the Add it feeds, unfolded (else one sample would be frozen into the
    graph), in both packages; each run then draws anew."""
    def build(GB, DT):
        b = GB()
        r = b.op("RandomUniform", [], {"shape": [4]})
        y = b.op("Add", [r, b.constant("one", np.ones(4, np.float32))], output_names=["y"])
        b.output(y)
        return b.finish()

    t = TModel(build(TBuilder, TDataType), TOptions(optimize=True), device="cpu")
    j = JModel(build(JBuilder, JDataType), JOptions(optimize=True))
    for m in (t, j):
        assert [op.op_type for _, op in m.graph.operators()] == ["RandomUniform", "Add"]
    a, b = (t.run({})[0].numpy() for _ in range(2))
    assert ((a >= 1) & (a < 2)).all() and not np.array_equal(a, b)


def test_random_op_draws_on_the_executor_device():
    """An op whose inputs are all host values runs on the host and gives a
    host array; a random op (here with no input at all) takes the
    executor's device context, as If and Loop do: its result stays a tensor
    on the executor's device, and so does the Add it feeds with a host
    constant."""
    import torch

    from rten_tpu_torch.runtime.executor import Executor

    def build(GB, DT):
        b = GB()
        r = b.op("RandomNormal", [], {"shape": [2, 3]}, output_names=["r"])
        y = b.op("Add", [r, b.constant("c", np.float32(1.0))], output_names=["y"])
        s = b.op("Shape", [b.constant("s", np.zeros((2, 3), np.int32))], output_names=["s"])
        b.output(y, s)
        return b.finish()

    graph = build(TBuilder, TDataType)
    ex = Executor(graph, device="cpu")
    y, s = ex.trace(dict(ex._weight_args()), graph.output_ids)
    assert isinstance(y, torch.Tensor) and y.device == ex.device and y.shape == (2, 3)
    assert isinstance(s, np.ndarray)  # the host rule, for contrast
