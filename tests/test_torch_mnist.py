"""The MNIST MLP and CNN (``models/mnist.py``, BASELINE config 2) in both
packages through ``mnist.load``, f32 and int8, on the same seeded batch on
the CPU; and the int8 wrapper's widening of K and N to multiples of 4
(``kernels/int8_matmul.py:pad_operands``), which the int8 classifier's N
of 10 takes on the card.

f32 logits agree within 1e-5 of max|logit|; int8 logits (MatMulAdd ->
MatMulIntegerToFloat, the convs left f32) within 1e-5 too, as no u8
activation flips on this seed. The widened operands give the plain
version's product bit for bit.
"""

import numpy as np
import pytest
import torch

from torch_one_thread import one_torch_thread  # noqa: F401

from rten_tpu.models import mnist as jmnist
from rten_tpu_torch.kernels import int8_matmul as tmm
from rten_tpu_torch.models import mnist as tmnist

X = np.random.default_rng(5).normal(0, 0.3, (8, 1, 28, 28)).astype(np.float32)


@pytest.mark.parametrize("quantize", [None, "int8"])
@pytest.mark.parametrize("arch", ["mlp", "cnn"])
def test_load_matches_the_jax_package(arch, quantize):
    x = X.reshape(8, 784) if arch == "mlp" else X
    tm = tmnist.load(arch, quantize=quantize, device="cpu")
    jm = jmnist.load(arch, quantize=quantize)
    ops = [op.op_type for _, op in tm.graph.operators()]
    assert ops == [op.op_type for _, op in jm.graph.operators()]
    assert ("MatMulIntegerToFloat" in ops) == (quantize == "int8")
    if arch == "cnn":
        assert ops.count("Conv") == 2 and ops.count("MaxPool") == 2
    got = tm.run({"image": x})[0].numpy()
    want = np.asarray(jm.run({"image": x})[0])
    assert got.shape == want.shape == (8, 10)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_weights_are_the_jax_package_weights():
    for name in ("random_mlp_weights", "random_cnn_weights"):
        t, j = getattr(tmnist, name)(3), getattr(jmnist, name)(3)
        assert t.keys() == j.keys()
        for k in t:
            np.testing.assert_array_equal(t[k], j[k])
    with pytest.raises(ValueError):
        tmnist.load("lenet", device="cpu")


@pytest.mark.parametrize("M,K,N", [(1, 2, 10), (96, 147, 10), (4096, 147, 64), (3, 5, 1),
                                   (17, 3, 6), (2, 64, 10)])
@pytest.mark.parametrize("zp", ["u8", "u8_colsums_per_col", "s8_both_per_row"])
def test_pad_operands_keeps_the_product(M, K, N, zp):
    """Widening K with a's zero point and zero weight rows, and N with
    zero columns (scale 1, zero point 0, column sum 0), leaves the first N
    columns of the plain version's output bit-identical."""
    g = torch.Generator().manual_seed(M * 31 + K * 7 + N)
    b = torch.randint(-127, 128, (K, N), generator=g, dtype=torch.int8)
    sb = torch.rand(N, generator=g) * 1e-3 + 1e-4
    cs = bzp = None
    if zp == "s8_both_per_row":
        a = torch.randint(-128, 128, (M, K), generator=g, dtype=torch.int8)
        azp = torch.randint(-3, 4, (M,), generator=g, dtype=torch.int8)
        bzp = torch.randint(-2, 3, (N,), generator=g, dtype=torch.int32)
        sa = torch.rand(M, generator=g) * 0.01 + 0.01
    else:
        a = torch.randint(0, 256, (M, K), generator=g, dtype=torch.uint8)
        azp, sa = torch.tensor(131, dtype=torch.uint8), torch.tensor(0.02)
        if zp == "u8_colsums_per_col":
            cs = b.to(torch.int32).sum(0, keepdim=True)
            bzp = torch.randint(-2, 3, (N,), generator=g, dtype=torch.int8)
    want = tmm.int8_matmul_dequant_plain(a, b, sa, sb, azp, bzp, cs)
    pa, pb, psb, pbzp, pcs = tmm.pad_operands(a, b, azp, sb, bzp, cs)
    assert pa.shape[1] % 4 == 0 and pb.shape == (pa.shape[1], -(-N // 4) * 4)
    if cs is not None:
        assert pcs.numel() == pb.shape[1]
    got = tmm.int8_matmul_dequant_plain(pa, pb, sa, psb, azp, pbzp, pcs)[:, :N]
    assert torch.equal(got, want)
