"""The arithmetic of ``int4_matmul`` on tensor cores
(``rten_tpu_torch/csrc/int4_matmul.cu``), emulated on the CPU, and its
split-K plan.

(a) The emulation: the activations a split into bf16 parts (hi = bf16(a),
then the rounding of what is left; three in the kernels), the codes
nibble - zp exact in bf16, each quantization block's partial sum of part x
code products accumulated in f32 (bf16 x bf16 products are exact in f32),
then folded into the output as acc += s[n, blk] * partial, block by block.
At GPT-2's K 768 and 3072, with and without zero points, it stays within
1e-6 of max|out| of the JAX package's ``int4_matmul_xla`` (dequantize, then
an f32 product at HIGHEST precision; 5-6e-7 here, the f32 sums' own
noise). Two parts land at 2-3e-6, past that limit, which is why the
kernels take three.

(b) ``int4_split_plan`` at GPT-2's five MatMulNBits shapes: every split
covers whole quantization blocks and whole 64-k stages, the splits cover K
once, the stream form's staged activations fit their shared memory, and
the stream form's N 768 projections put at least 132 blocks on the card.
"""

import numpy as np
import pytest
import torch

from rten_tpu.kernels.int4_matmul import _unpack_zero_points, int4_matmul_xla
from rten_tpu_torch.kernels import int4_matmul as t4

LIMIT = 1e-6  # of max|out|
E = 768       # GPT-2 124M's width
SMS = 132     # the H100's SMs
# GPT-2's five MatMulNBits shapes (K, N): qkv, attn.c_proj, mlp.c_fc,
# mlp.c_proj, lm_head.
GPT2 = [(E, 3 * E), (E, E), (E, 4 * E), (4 * E, E), (E, 50257)]


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _parts(x, n):
    """x as n bf16-valued f32 tensors whose sum approximates it: each the
    bf16 rounding of what the previous ones leave (exact differences)."""
    out = []
    for _ in range(n):
        p = _bf16(x)
        out.append(p)
        x = x - p
    return out


def _emulate(a, b_packed, scales, zps, K, N, bs, parts):
    """The kernels' arithmetic: [M, K] f32 activations, [N, K / 2] packed
    nibbles, [N, nb] scales, [N, nb] int32 zero points -> [M, N] f32."""
    nb = K // bs
    b = torch.from_numpy(b_packed).to(torch.int32)
    codes = torch.stack([b & 15, b >> 4], dim=-1).reshape(N, nb, bs)
    codes = (codes - torch.from_numpy(zps)[:, :, None]).to(torch.float32)
    assert torch.equal(_bf16(codes), codes)  # exact in bf16
    ps = [p.reshape(-1, nb, bs) for p in _parts(torch.from_numpy(a), parts)]
    s = torch.from_numpy(scales)
    acc = torch.zeros(a.shape[0], N, dtype=torch.float32)
    for blk in range(nb):
        partial = sum(p[:, blk] @ codes[:, blk].T for p in ps)  # f32 sums of exact products
        acc = acc + s[:, blk][None, :] * partial
    return acc.numpy()


@pytest.mark.parametrize("K", [E, 4 * E])
@pytest.mark.parametrize("with_zp", [False, True])
def test_int4_tensor_core_arithmetic_matches_jax(K, with_zp):
    """Three bf16 parts of a, exact codes, per-block partial sums scaled in
    f32: within 1e-6 of max|out| of int4_matmul_xla; two parts land past
    1e-6 and at least 3x further away."""
    M, N, bs = 4, 96, 32
    nb = K // bs
    rng = np.random.default_rng(K + with_zp)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.integers(0, 256, (N, K // 2)).astype(np.uint8)
    scales = rng.uniform(0.001, 0.003, (N, nb)).astype(np.float32)
    zp = rng.integers(0, 256, (N * ((nb + 1) // 2),)).astype(np.uint8) if with_zp else None
    zps = np.asarray(_unpack_zero_points(zp, N, nb))
    want = np.asarray(int4_matmul_xla(a, b, scales, zps, K=K, N=N, block_size=bs))
    scale = np.abs(want).max()
    err3 = np.abs(_emulate(a, b, scales, zps, K, N, bs, 3) - want).max() / scale
    err2 = np.abs(_emulate(a, b, scales, zps, K, N, bs, 2) - want).max() / scale
    assert err3 <= LIMIT, err3
    assert err2 > LIMIT and err2 >= 3 * err3, (err2, err3)


@pytest.mark.parametrize("M", [1, 16, 128])
@pytest.mark.parametrize("K,N", GPT2)
def test_int4_split_plan_covers_k_in_whole_blocks(M, K, N):
    """Every split covers whole 32-k quantization blocks and whole 64-k
    stages, the splits cover K once (none empty), the stream form (M <= 16)
    stages at most ACT_SMEM of activation parts and puts GPT-2's N 768
    projections on at least 132 blocks, the tiled form (M 128) takes at most
    TILED_MAX_SPLITS splits."""
    splits, kchunk, tiles = t4.int4_split_plan(M, N, K, 32, SMS)
    assert kchunk % 32 == 0 and kchunk % t4.K_STAGE == 0
    assert (splits - 1) * kchunk < K <= splits * kchunk
    if t4.int4_form(M, 32) == "stream":
        assert tiles == -(-N // t4.STREAM_COLS)
        assert 3 * M * (2 * kchunk + 64) <= t4.ACT_SMEM
        if N == E:  # the split-K decode form fills the card
            assert tiles * splits >= SMS
    else:
        assert tiles == -(-M // t4.TILE_M) * -(-N // t4.TILE_N)
        assert splits <= t4.TILED_MAX_SPLITS
    if tiles >= SMS:
        assert splits == 1


@pytest.mark.parametrize("bs", [16, 48, 64, 128, 256])
def test_int4_split_plan_other_block_sizes(bs):
    """Block sizes the kernels take beside 32: each split a whole number of
    blocks and of 64-k stages (the least common multiple), K covered once."""
    K = 3 * 768
    for M in (1, 16, 130):
        splits, kchunk, _ = t4.int4_split_plan(M, 768, K, bs, SMS)
        assert kchunk % bs == 0 and kchunk % t4.K_STAGE == 0
        assert (splits - 1) * kchunk < K <= splits * kchunk


def test_int4_form_routes_by_rows_and_block_size():
    """M <= 16 streams, above it tiles, on tensor cores for block sizes that
    are a multiple of 16; block size 8 on CUDA cores at any M."""
    assert [t4.int4_form(m, 32) for m in (1, 16, 17, 2048)] == [
        "stream", "stream", "tiled", "tiled"]
    assert {t4.int4_form(m, 8) for m in (1, 16, 17)} == {"cuda_core"}
    assert t4.int4_form(1, 16) == "stream" and t4.int4_form(64, 128) == "tiled"
