"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes and at the edges (ragged tiles, clamped writes, GQA,
windows, strided rows), and the serving engine on the card against the
same engine on the CPU.

Every test here needs an NVIDIA card and carries the ``gpu`` marker; the
``card`` fixture skips it where there is none. This file imports nothing
of JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_on_card.py -q
"""

import numpy as np
import pytest
import torch

from rten_tpu_torch.kernels import argmax as targmax
from rten_tpu_torch.kernels import flash_attention as tfa
from rten_tpu_torch.kernels import int8_matmul as tmm

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("M,K,N", [(1, 64, 128), (3, 768, 2304), (40, 100, 36),
                                   (130, 3072, 768), (16, 768, 51200)])
@pytest.mark.parametrize("zp", ["u8_colsums", "u8", "s8_both"])
def test_int8_matmul_kernel(card, M, K, N, zp):
    """The integer part is exact; the f32 epilogue (acc * sa) * sb rounds
    the same way in both: rtol 1e-6 of the largest output."""
    g = _gen(M * 7 + N)
    b = torch.randint(-127, 128, (K, N), generator=g, dtype=torch.int8)
    sb = torch.rand(N, generator=g) * 1e-3 + 1e-4
    if zp == "s8_both":
        a = torch.randint(-128, 128, (M, K), generator=g, dtype=torch.int8)
        azp = torch.randint(-3, 4, (M,), generator=g, dtype=torch.int32)
        bzp = torch.randint(-2, 3, (N,), generator=g, dtype=torch.int32)
        sa = torch.rand(M, generator=g) * 0.01 + 0.01
        cs = None
    else:
        a = torch.randint(0, 256, (M, K), generator=g, dtype=torch.uint8)
        azp, bzp, sa = torch.tensor(131, dtype=torch.uint8), None, torch.tensor(0.02)
        cs = b.to(torch.int32).sum(0, keepdim=True).to(torch.int32) if zp == "u8_colsums" else None
    args = [t if t is None else t.to(card) for t in (a, b, sa, sb, azp, bzp, cs)]
    before = tmm.int8_matmul_dequant.launches
    got = tmm.int8_matmul_dequant(*args)
    want = tmm.int8_matmul_dequant_plain(*args)
    torch.cuda.synchronize()
    assert tmm.int8_matmul_dequant.launches == before + 1
    assert got.shape == (M, N) and got.device.type == "cuda"
    assert (got - want).abs().max().item() <= 1e-6 * want.abs().max().item()


def test_argmax_kernel(card):
    g = _gen(1)
    full = torch.randn(37, 5000, generator=g)
    full[0, 3] = full[0, 4000] = 99.0   # tie: the lower index wins
    full[1, 4999] = 99.0                # beyond the slice: ignored
    full[2, 4096] = 99.0                # the last column of the slice
    x = full.to(card)[:, :4097]
    got = targmax.argmax_lastdim(x)
    want = targmax.argmax_plain(x)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert got[0].item() == 3 and got[2].item() == 4096


def _decode_inputs(card, B, H, Hkv, D, cap, lens, seed):
    g = _gen(seed)
    q = torch.randn(B, H, 1, D, generator=g)
    kn = torch.randn(B, Hkv, 1, D, generator=g)
    vn = torch.randn(B, Hkv, 1, D, generator=g)
    kc = torch.randint(-127, 128, (B, cap, Hkv * D), generator=g, dtype=torch.int8)
    vc = torch.randint(-127, 128, (B, cap, Hkv * D), generator=g, dtype=torch.int8)
    ks = torch.rand(B, Hkv, cap, 1, generator=g) * 0.015 + 0.005
    vs = torch.rand(B, Hkv, cap, 1, generator=g) * 0.015 + 0.005
    kn[0, 0, 0, :4] = torch.tensor([0.5, 1.5, -2.5, 127.0])  # .5 ties
    lens = torch.tensor(lens, dtype=torch.int32)
    return [t.to(card) for t in (q, kc, vc, lens, ks, vs, kn, vn)]


@pytest.mark.parametrize("H,Hkv,D,window", [(2, 2, 64, 0), (12, 12, 64, 0),
                                            (8, 2, 128, 0), (4, 4, 32, 16)])
def test_decode_append_kernel(card, H, Hkv, D, window):
    """s8 rows bit-exact and rows the kernel does not own untouched;
    scales rtol 5e-6; out atol 1e-4 (summation order differs)."""
    cap = 96
    lens = [0, 31, 32, cap - 1, cap, cap + 7]
    q, kc, vc, lens_t, ks, vs, kn, vn = _decode_inputs(card, 6, H, Hkv, D, cap, lens, H + D)
    a = [t.clone() for t in (kc, vc, ks, vs)]
    p = [t.clone() for t in (kc, vc, ks, vs)]
    got = tfa.decode_mha_append_cat(q, a[0], a[1], lens_t, a[2], a[3], k_new=kn,
                                    v_new=vn, window=window)
    want = tfa.decode_mha_append_cat_plain(q, p[0], p[1], lens_t, p[2], p[3],
                                           k_new=kn, v_new=vn, window=window)
    torch.cuda.synchronize()
    assert (got[0] - want[0]).abs().max().item() <= 1e-4
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert torch.allclose(got[3], want[3], rtol=5e-6, atol=0)
    assert torch.allclose(got[4], want[4], rtol=5e-6, atol=0)
    wpos = [min(n, cap - 1) for n in lens]
    for bb, w in enumerate(wpos):
        keep = torch.ones(cap, dtype=torch.bool, device=card)
        keep[w] = False
        assert torch.equal(got[1][bb, keep], kc[bb, keep])


@pytest.mark.parametrize("H,Hkv,D,S,window", [(2, 2, 64, 8, 0), (12, 12, 64, 45, 0),
                                              (8, 2, 64, 33, 0), (4, 4, 32, 16, 5)])
def test_prefill_kernel(card, H, Hkv, D, S, window):
    """Row r of slot b attends columns <= lens[b] + r: atol 1e-4 against
    the plain version (summation order differs)."""
    cap, B = 96, 4
    g = _gen(S)
    q = torch.randn(B, H, S, D, generator=g).to(card)
    kc = torch.randint(-127, 128, (B, cap, Hkv * D), generator=g, dtype=torch.int8).to(card)
    vc = torch.randint(-127, 128, (B, cap, Hkv * D), generator=g, dtype=torch.int8).to(card)
    ks = (torch.rand(B, Hkv, cap, 1, generator=g) * 0.015 + 0.005).to(card)
    vs = (torch.rand(B, Hkv, cap, 1, generator=g) * 0.015 + 0.005).to(card)
    lens = torch.tensor([0, 7, cap - S, 31], dtype=torch.int32, device=card)
    got = tfa.prefill_mha_cat(q, kc, vc, lens, ks, vs, window=window)
    want = tfa.prefill_mha_cat_plain(q, kc, vc, lens, ks, vs, window=window)
    torch.cuda.synchronize()
    assert got.shape == (B, H, S, D)
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("k", [1, 4])
def test_engine_on_card_matches_cpu(card, k):
    """The small GPT-2 served on the card and on the CPU (the plain
    versions) from the same weights: the same tokens."""
    from rten_tpu_torch.model import Model
    from rten_tpu_torch.models import gpt2
    from rten_tpu_torch.quantize_pass import quantize_dynamic
    from rten_tpu_torch.serving import ContinuousBatchingEngine

    cfg = gpt2.GPT2Config(vocab_size=512, n_positions=128, n_embd=128, n_layer=2, n_head=2)
    weights = gpt2.random_weights(cfg, seed=0)
    out = {}
    for dev in (card, torch.device("cpu")):
        graph = gpt2.build_graph_static_cache(cfg, weights, capacity=64, kv_quant=True,
                                              kernel_append=True, gather_last=True)
        quantize_dynamic(graph)
        eng = ContinuousBatchingEngine(
            Model(graph, device=dev), n_layer=2, n_head=2, head_dim=64, slots=3,
            capacity=64, prefill_bucket=8, greedy_on_device=True, steps_per_dispatch=k)
        rng = np.random.default_rng(0)
        reqs = [eng.submit(rng.integers(0, 512, int(rng.integers(3, 12))).tolist(),
                           max_new_tokens=int(rng.integers(3, 14))) for _ in range(5)]
        eng.run()
        out[dev.type] = [r.generated for r in reqs]
    assert out["cuda"] == out["cpu"]
