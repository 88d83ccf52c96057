"""The port's GPipe forward (``rten_tpu_torch/parallel/pipeline.py``)
against the JAX package's: the planning half (cut values, the detected
trunk, the equal-stages error) on the same graph in this process, and the
pipelined forward over 2 and 4 gloo ranks on the CPU
(``torch_parallel_worker.py``, M = S microbatches) within
``test_pipeline_parallel.py``'s rtol 1e-4 / atol 1e-5 of the JAX package's
unsharded ``Model.run``.
"""

import numpy as np
import pytest

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)
from torch_parallel_worker import pipeline_feed, pipeline_model, run_ranks

from rten_tpu.model import Model as JModel
from rten_tpu.model import ModelOptions as JOptions
from rten_tpu.models import gpt2 as jgpt2
from rten_tpu.parallel import pipeline as jpipe
from rten_tpu_torch.parallel import pipeline as tpipe


def _jax_model(n_layer):
    cfg = jgpt2.GPT2Config(vocab_size=97, n_positions=32, n_embd=32, n_layer=n_layer, n_head=4)
    g = jgpt2.build_graph(cfg, jgpt2.random_weights(cfg, seed=3))
    return JModel(g, JOptions(optimize=False))


def test_cut_points_match_jax():
    """The residual stream's dominators: main + wte-gather + embed-sum + 2
    residual adds a layer + ln_f + logits, the JAX package's node ids."""
    _, tm = pipeline_model(n_layer=3)
    jm = _jax_model(3)
    tg, jg = tm.graph, jm.graph
    t = tpipe.find_cut_values(tg, tg.find_node("input_ids"), tg.find_node("logits"))
    j = jpipe.find_cut_values(jg, jg.find_node("input_ids"), jg.find_node("logits"))
    assert t == j and len(t) == 3 + 2 * 3 + 2


def test_plan_matches_jax():
    _, tm = pipeline_model(n_layer=4)
    t, j = tpipe.plan_pipeline(tm.graph, 2), jpipe.plan_pipeline(_jax_model(4).graph, 2)
    assert t.layers == 4 and t.n_stages == 2
    assert len(t.staged_side[0]) == 4  # 2 layers x (key, value)
    assert "attention_mask" in [tm.graph.node_name(i) for i in t.shared_side]
    assert (t.boundaries, t.weight_ids, t.staged_side, t.shared_side) == (
        j.boundaries, j.weight_ids, j.staged_side, j.shared_side)


def test_pipeline_rejects_uneven_split():
    _, tm = pipeline_model(n_layer=3)
    with pytest.raises(ValueError, match="equal stages"):
        tpipe.plan_pipeline(tm.graph, 2)


@pytest.mark.parametrize("n_stages", [2, 4])
def test_pipeline_matches_jax(tmp_path, n_stages):
    """(n_stages, n_micro) = (2, 2) and (4, 4): every rank returns the
    logits of the whole batch."""
    cfg, _ = pipeline_model()
    want = np.asarray(_jax_model(4).run(pipeline_feed(cfg))[0])
    outs = run_ranks(tmp_path, n_stages, (1, n_stages), ["pipeline"])["pipeline"]
    for out in outs:
        np.testing.assert_allclose(out["logits"], want, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(out["want"], want, rtol=1e-4, atol=1e-5)
