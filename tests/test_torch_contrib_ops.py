"""The Microsoft contrib ops of the port (``rten_tpu_torch/ops/contrib.py``)
against the JAX package's lowerings (``rten_tpu/ops/contrib.py``), one-node
graphs built by both packages' GraphBuilders and run on the CPU on the same
numpy inputs from a seed: every output within 1e-6 of max|out| (the two
libraries' erf, tanh and exp differ by ulps; the port's RMS norms compute
in f64 and round once, the JAX ones in f32). The registry test: the port
registers every operator the JAX package does."""

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

TOL = 1e-6


def _graph(op, feed, consts, attrs, n_out):
    def build(GB, DT):
        b = GB()
        ins = [b.input(n, DT.Float) for n in feed]
        ins += [None if a is None else b.constant(n, a) for n, a in consts]
        outs = b.op(op, ins, attrs, n_outputs=n_out,
                    output_names=[f"y{i}" for i in range(n_out)])
        b.output(*(outs if n_out > 1 else (outs,)))
        return b.finish()

    return build


def _run_both(op, feed, consts=(), attrs=None, n_out=1):
    build = _graph(op, feed, consts, attrs or {}, n_out)
    names = [f"y{i}" for i in range(n_out)]
    got = [t.numpy() for t in TModel(build(TBuilder, TDataType), TOptions(optimize=False),
                                     device="cpu").run(dict(feed), names)]
    want = [np.asarray(a) for a in JModel(build(JBuilder, JDataType),
                                          JOptions(optimize=False)).run(dict(feed), names)]
    return got, want


def _close(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert np.abs(g - w).max() <= TOL * max(np.abs(w).max(), 1e-30)


def _x(*shape, seed=0, scale=2.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("op,consts,attrs", [
    ("BiasGelu", [("bias", _x(48, seed=1))], {}),
    ("FastGelu", [("bias", _x(48, seed=1))], {}),
    ("FastGelu", [], {}),
    ("GeluMicrosoft", [], {}),
    ("QuickGelu", [], {}),
    ("QuickGelu", [], {"alpha": 1.25}),
])
def test_gelus_match_jax(op, consts, attrs):
    """BiasGelu and GeluMicrosoft the exact erf GELU, FastGelu the tanh form
    (with and without its bias), QuickGelu x * sigmoid(alpha x) at the
    default and another alpha."""
    _close(*_run_both(op, {"x": _x(3, 7, 48)}, consts, attrs))


@pytest.mark.parametrize("axis", [-1, 1])
def test_simplified_layer_norm_matches_jax(axis):
    """SimplifiedLayerNormalization, RMS over the one axis named, through
    rms_norm (f64, one rounding)."""
    scale = _x(*((48,) if axis == -1 else (7, 1)), seed=2)
    _close(*_run_both("SimplifiedLayerNormalization", {"x": _x(3, 7, 48)},
                      [("scale", scale)], {"axis": axis, "epsilon": 1e-6}))


@pytest.mark.parametrize("op", ["SkipLayerNormalization", "SkipSimplifiedLayerNormalization"])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("n_out", [1, 2, 4])
def test_skip_norms_match_jax(op, bias, n_out):
    """The skip norms of x + skip (+ bias): the normed output, the zero
    scalars of mean and inv_std_var, and the residual sum as output 3."""
    feed = {"x": _x(2, 5, 64), "skip": _x(2, 5, 64, seed=3)}
    consts = [("gamma", _x(64, seed=4))]
    if op == "SkipLayerNormalization":
        consts.append(("beta", _x(64, seed=5)))
    consts.append(("bias", _x(64, seed=6) if bias else None))
    got, want = _run_both(op, feed, consts, {"epsilon": 1e-5}, n_out)
    _close(got, want)
    if n_out == 4:
        assert got[1].shape == () and got[1] == 0 and got[2] == 0
        total = feed["x"] + feed["skip"] + (consts[-1][1] if bias else 0)
        np.testing.assert_allclose(got[3], total, rtol=0, atol=0)


def test_norms_round_once_from_f64():
    """The contrib RMS norms give rms_norm's f64 result rounded once to f32
    (the rule that keeps card and CPU alike), not an f32 RMS."""
    import torch

    from rten_tpu_torch.ops.norm import rms_norm

    feed = {"x": _x(4, 96, scale=30.0), "skip": _x(4, 96, seed=7, scale=30.0)}
    g = _x(96, seed=8)
    got = _run_both("SkipSimplifiedLayerNormalization", feed, [("gamma", g)], {}, 4)[0]
    total = torch.from_numpy(feed["x"] + feed["skip"])
    want = rms_norm(total, torch.from_numpy(g), -1, 1e-5).numpy()
    np.testing.assert_array_equal(got[0], want)
    x64 = total.double()
    exact = (x64 * torch.rsqrt(x64.square().mean(-1, keepdim=True) + 1e-5)
             * torch.from_numpy(g).double()).float().numpy()
    np.testing.assert_array_equal(got[0], exact)


def test_registry_holds_every_jax_op():
    """Every operator the JAX package registers, the port registers too, and
    an unknown name is an OpError from both."""
    import rten_tpu.ops  # noqa: F401
    import rten_tpu_torch.ops  # noqa: F401
    from rten_tpu.ops.registry import REGISTRY as JREG
    from rten_tpu.ops.registry import OpError as JOpError
    from rten_tpu.ops.registry import get_op as jget
    from rten_tpu_torch.ops.registry import REGISTRY as TREG
    from rten_tpu_torch.ops.registry import OpError, get_op

    assert set(JREG) - set(TREG) == set()
    for name in JREG:
        assert get_op(name).name == name
    with pytest.raises(OpError, match="not registered"):
        get_op("NoSuchOp")
    with pytest.raises(JOpError, match="not registered"):
        jget("NoSuchOp")
