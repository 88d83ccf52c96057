"""The port's shape inference (a copy of ``rten_tpu/shape_inference.py``)
against the JAX package's on the cases of ``tests/test_shape_inference.py``
and ``tests/test_shape_rules_complete.py``: each case runs with
``infer_shapes`` and ``infer_shapes_and_values`` shadowed by the port's
(``tests/torch_graph_compare.py``), which must give the same shapes,
dtypes and symbolic values on a copy of the same graph and annotate it the
same way; the symbolic-value chain of ``tests/test_symbolic_shape_fold.py``
too.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import test_shape_inference  # noqa: E402
import test_shape_rules_complete  # noqa: E402
import test_symbolic_shape_fold  # noqa: E402
from torch_graph_compare import call, cases, shadowed  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401

import rten_tpu.shape_inference as jshape  # noqa: E402
import rten_tpu_torch.shape_inference as tshape  # noqa: E402

PASSES = ["infer_shapes", "infer_shapes_and_values"]
# Cases that call no inference pass: they are held below by their own
# functions (broadcast_shapes, the rule table).
NO_PASS = {"test_broadcast", "test_every_registered_op_has_a_rule"}

CASES = [(mod, label, fn, kw)
         for mod in (test_shape_inference, test_shape_rules_complete)
         for label, fn, kw in cases(mod)]
CASES += [(test_symbolic_shape_fold, label, fn, kw)
          for label, fn, kw in cases(test_symbolic_shape_fold)
          if label == "test_symval_propagation_through_chain"]


@pytest.mark.parametrize("mod,label,fn,kwargs", CASES,
                         ids=[f"{m.__name__}::{label}" for m, label, _, _ in CASES])
def test_shape_case_matches_the_jax_package(mod, label, fn, kwargs, monkeypatch, tmp_path):
    with shadowed(monkeypatch, mod, PASSES) as sh:
        call(fn, kwargs, tmp_path)
    if label.split("[")[0] not in NO_PASS:
        assert sh.compared > 0, "the case called no inference pass"


def test_rules_and_broadcasting_match():
    assert sorted(tshape.RULES) == sorted(jshape.RULES)
    for a, b in [((2, 3), (3,)), ((1, "n", 4), ("m", 1, 4)), ((5, 1), (1, 6)), ((), (2,)),
                 (("b", 1), (None, 7))]:
        assert tshape.broadcast_shapes(a, b) == jshape.broadcast_shapes(a, b)
    with pytest.raises(tshape.ShapeError):
        tshape.broadcast_shapes((2, 3), (4, 3))
