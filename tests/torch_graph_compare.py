"""Run the JAX package's optimizer and shape-inference tests with the port
shadowing each graph pass they call.

``shadowed(names)`` patches the JAX functions named (``optimize_graph``,
the fusions, ``infer_shapes``, ...) in ``rten_tpu.optimize``,
``rten_tpu.shape_inference`` and the given test module: each call first
copies its graph into both packages (through the ``.rtpu`` JSON form, so
node ids agree), runs the JAX pass and the port's pass of the same name on
the copies and compares what they give and the graphs they leave, then
runs the JAX pass on the caller's graph and returns its result, so the JAX
test's own assertions still hold it. ``cases(module, skip)`` expands a JAX
test module's test functions over their parametrize marks.
"""

from __future__ import annotations

import contextlib
import inspect
import itertools
import json

import numpy as np

import rten_tpu.optimize as jopt
import rten_tpu.shape_inference as jshape
import rten_tpu_torch.optimize as topt
import rten_tpu_torch.shape_inference as tshape
from rten_tpu.formats import rtpu as jrtpu
from rten_tpu_torch.formats import rtpu as trtpu


def _attr(v):
    if hasattr(v, "nodes") and hasattr(v, "operators"):
        return ("graph", sig(v))
    if hasattr(v, "np_dtype"):  # a DataType of either package
        return ("dtype", v.value)
    if isinstance(v, np.ndarray):
        return ("array", v.dtype.str, v.shape, v.tobytes())
    if isinstance(v, (list, tuple)):
        return [_attr(x) for x in v]
    if isinstance(v, (np.floating, float)):
        return float(np.float32(v))
    return v


class _Floats:
    """A float constant's values, equal to another's within 1e-6 relative:
    a constant the two packages fold may differ by the libraries' ulps."""

    def __init__(self, a):
        self.a = a

    def __eq__(self, other):
        return (isinstance(other, _Floats) and self.a.shape == other.a.shape
                and np.allclose(self.a, other.a, rtol=1e-6, atol=0, equal_nan=True))

    def __repr__(self):
        return f"_Floats({self.a!r})"


def sig(g):
    """A graph as plain python with its node ids: values, constants (dtype,
    shape and bytes; float values within 1e-6), operators, IO."""
    nodes = {}
    for nid, n in g.nodes.items():
        kind = type(n).__name__
        if kind == "Value":
            nodes[nid] = (kind, n.name, n.dtype.value if n.dtype else None,
                          None if n.shape is None else tuple(n.shape))
        elif kind == "Constant":
            a = np.asarray(n.array)
            data = _Floats(a) if a.dtype.kind == "f" else a.tobytes()
            nodes[nid] = (kind, n.name, a.dtype.str, a.shape, data)
        else:
            nodes[nid] = (kind, n.name, n.op_type, list(n.inputs), list(n.outputs),
                          {k: _attr(v) for k, v in sorted(n.attrs.items())})
    return nodes, list(g.input_ids), list(g.output_ids), list(g.captures)


def clone_both(g):
    """(JAX graph, port graph): copies of a JAX graph with the same ids."""
    data = json.loads(json.dumps(jrtpu._graph_to_json(g, inline_consts=True)))
    return jrtpu._graph_from_json(data, {}), trtpu._graph_from_json(data, {})


def _plain_result(r):
    """A pass's result as plain python: graphs by sig, shape maps by value,
    symbolic values by their fields."""
    if hasattr(r, "nodes") and hasattr(r, "operators"):
        return sig(r)
    if isinstance(r, tuple):
        return tuple(_plain_result(x) for x in r)
    if isinstance(r, dict):
        return {k: _plain_result(v) for k, v in r.items()}
    if hasattr(r, "np_dtype"):
        return r.value
    if type(r).__name__ == "SymVal":
        return ("sym", [str(d) for d in r.dims], r.scalar)
    return r


class Shadow:
    """The patched passes and the number of comparisons they made."""

    def __init__(self):
        self.compared = 0

    def wrap(self, name, jfn, tfn):
        def shadow(g, *args, **kwargs):
            jg, tg = clone_both(g)
            want = _plain_result(jfn(jg, *args, **kwargs))
            got = _plain_result(tfn(tg, *args, **kwargs))
            assert got == want, f"{name}: the port's result differs from the JAX package's"
            assert sig(tg) == sig(jg), f"{name}: the port leaves another graph"
            self.compared += 1
            return jfn(g, *args, **kwargs)

        return shadow


@contextlib.contextmanager
def shadowed(monkeypatch, test_module, names):
    sh = Shadow()
    wrappers = {}
    for name in names:
        for jmod, tmod in ((jopt, topt), (jshape, tshape)):
            if hasattr(jmod, name):
                jfn, tfn = getattr(jmod, name), getattr(tmod, name)
                wrappers[name] = sh.wrap(name, jfn, tfn)
                monkeypatch.setattr(jmod, name, wrappers[name])
                if getattr(test_module, name, None) is jfn:
                    monkeypatch.setattr(test_module, name, wrappers[name])
                break
    monkeypatch.setattr(jopt, "FUSIONS", [wrappers.get(f.__name__, f) for f in jopt.FUSIONS])
    yield sh


def cases(module, skip=()):
    """[(test name, function, kwargs)] of a JAX test module's tests, one per
    combination of their parametrize marks."""
    out = []
    for name, fn in sorted(vars(module).items()):
        if not name.startswith("test_") or not callable(fn) or name in skip:
            continue
        grids = []
        for mark in getattr(fn, "pytestmark", []):
            if mark.name != "parametrize":
                continue
            argnames, values = mark.args[0], mark.args[1]
            argnames = [a.strip() for a in argnames.split(",")] if isinstance(argnames, str) \
                else list(argnames)
            rows = []
            for v in values:
                v = v.values if hasattr(v, "values") and not isinstance(v, (tuple, list)) else v
                v = tuple(v) if len(argnames) > 1 else (v[0] if isinstance(v, tuple)
                                                        and len(v) == 1 else v,)
                rows.append(dict(zip(argnames, v)))
            grids.append(rows)
        for combo in itertools.product(*grids) if grids else [()]:
            kwargs = {}
            for part in combo:
                kwargs.update(part)
            label = name + ("[" + "-".join(str(v) for v in kwargs.values()) + "]" if kwargs else "")
            out.append((label, fn, kwargs))
    return out


def call(fn, kwargs, tmp_path):
    """Call a JAX test function with its parameters and, where it asks for
    one, a temporary directory."""
    if "tmp_path" in inspect.signature(fn).parameters:
        kwargs = {**kwargs, "tmp_path": tmp_path}
    fn(**kwargs)
