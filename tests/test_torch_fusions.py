"""The port's optimizer against the JAX package's on the JAX package's own
optimizer tests: ``tests/test_pattern_fusions.py``,
``test_attention_fusion.py``, ``test_symbolic_shape_fold.py``,
``test_optimizer_negative.py`` and ``test_opset_compat.py``, each case run
with every graph pass it calls (``optimize_graph``, each fusion,
``fold_shape_computations``, ``propagate_constants``) shadowed by the
port's (``tests/torch_graph_compare.py``): on a copy of the same graph the
port's pass gives the same answer and leaves the same graph, node for
node, the fusions that must not fire and the ORT-style MatMulInteger
chain included. The two tensor-parallel cases of
``test_pattern_fusions.py`` are left out: they test the JAX package's
sharding, and their graphs are those of ``test_old_opset_exports_fuse``.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import test_attention_fusion  # noqa: E402
import test_opset_compat  # noqa: E402
import test_optimizer_negative  # noqa: E402
import test_pattern_fusions  # noqa: E402
import test_symbolic_shape_fold  # noqa: E402
from torch_graph_compare import call, cases, shadowed  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401

PASSES = ["optimize_graph", "propagate_constants", "fold_shape_computations",
          "fuse_identity", "fuse_cast_elimination", "fuse_layer_norm", "fuse_rms_norm",
          "fuse_gelu", "fuse_silu_swish", "fuse_matmul_integer_to_float",
          "fuse_conv_integer_to_float", "fuse_attention", "prepack_int8_weights"]
TP_CASES = ("test_tp_derivation_old_opset_matches_new", "test_tp_sharded_numerics_old_opset")
# Cases that call no graph pass: the symbolic-value chain reads shape
# inference only (tests/test_torch_shape_inference.py holds it).
NO_PASS = {"test_symval_propagation_through_chain"}

CASES = [(mod, label, fn, kw)
         for mod in (test_pattern_fusions, test_attention_fusion, test_symbolic_shape_fold,
                     test_optimizer_negative, test_opset_compat)
         for label, fn, kw in cases(mod, skip=TP_CASES)]


@pytest.mark.parametrize("mod,label,fn,kwargs", CASES,
                         ids=[f"{m.__name__}::{label}" for m, label, _, _ in CASES])
def test_optimizer_case_matches_the_jax_package(mod, label, fn, kwargs, monkeypatch, tmp_path):
    with shadowed(monkeypatch, mod, PASSES) as sh:
        call(fn, kwargs, tmp_path)
    if label.split("[")[0] not in NO_PASS:
        assert sh.compared > 0, "the case called no graph pass"


def test_the_cases_are_collected():
    names = {label.split("[")[0] for _, label, _, _ in CASES}
    assert "test_attention_fusion_fires_and_matches" in names
    assert "test_int_mm_fusion_fires_on_clean_pattern" in names
    assert len(CASES) >= 30
