"""Ring attention in the port (``rten_tpu_torch/parallel/ring.py``): K/V
chunks sent around 4 gloo ranks on the CPU (``torch_parallel_worker.py``)
against the JAX package's full attention (``mha_xla``, computed here),
within ``test_ring_attention.py``'s rtol 1e-4 / atol 1e-5: causal, full
and GQA, and the error for a sequence that does not divide.
"""

import numpy as np
import pytest

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)
from torch_parallel_worker import ring_inputs, run_ranks


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("ring"), 4, (1, 4), ["ring"])["ring"]


def _full_attention(q, k, v, causal):
    import jax.numpy as jnp

    from rten_tpu.kernels.flash_attention import mha_xla

    T = q.shape[2]
    mask = None
    if causal:
        mask = jnp.asarray(np.where(np.arange(T)[None, :] <= np.arange(T)[:, None], 0.0, -1e30),
                           jnp.float32)
    return np.asarray(mha_xla(q, k, v, mask))


@pytest.mark.parametrize("causal", [True, False])
def test_ring_matches_full_attention(ring, causal):
    want = _full_attention(*ring_inputs(False), causal)
    for out in ring:
        np.testing.assert_allclose(out[f"causal_{causal}"], want, rtol=1e-4, atol=1e-5)


def test_ring_gqa(ring):
    want = _full_attention(*ring_inputs(True), True)
    for out in ring:
        np.testing.assert_allclose(out["gqa"], want, rtol=1e-4, atol=1e-5)


def test_ring_rejects_indivisible_seq(ring):
    for out in ring:
        assert "not divisible by 4 ring devices" in str(out["indivisible"])
