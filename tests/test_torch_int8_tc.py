"""The arithmetic of ``int8_matmul_dequant`` on s8 tensor cores
(``rten_tpu_torch/csrc/int8_matmul.cu``), modelled on the CPU, and its form
choice and split plan.

(a) The byte transpose: ldmatrix.x4.trans over a stage of raw weight rows
(k rows of 16 bytes), each lane naming its matrix row's k as
``trans_row_k`` does, then one __byte_perm a register (selectors 0x6420 and
0x7531), must give every lane the s8 B fragment of mma.m16n8k32 (k 4t ..
4t + 3 of column g) for the even and the odd columns of the 16, and the
shared-memory layouts must put the eight rows of every matrix in eight
bank groups. The model runs the lanes' registers through an mma's
arithmetic and matches the plain integer product.

(b) The split-K sums: each split's partial with its share of the
zero-point terms (its own column and row sums, klen * zp_a * zp_b), the
splits summed in int32, then the given colsums' term and (float)acc * s_a
* s_b: equal, bit for bit, to ``int8_matmul_dequant_plain``, with the
splits ``int8_split_plan`` picks, for u8 activations (a per-tensor zero
point, colsums given or not) and s8 ones with per-row and per-column zero
points.

(c) The plain version against the JAX package's Pallas kernel (interpret
mode) and ``int8_matmul_dequant_xla`` at small shapes.

(d) ``int8_form`` and ``int8_split_plan`` at every main-path shape: every
column tile covered once, every split non-empty, the staged activations
within shared memory, and K split only where the tiles do not fill the
132 SMs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rten_tpu.kernels import int8_matmul as jmm
from rten_tpu_torch.kernels import int8_matmul as tmm

SMS = 132


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# --- (a) the byte transpose -----------------------------------------------------------


def trans_row_k(lane):
    """csrc/int8_matmul.cu, trans_row_k."""
    j, r = lane >> 3, lane & 7
    return 16 * (j >> 1) + 4 * (r >> 1) + (r & 1) + 2 * (j & 1)


def byte_perm(x, y, sel):
    """__byte_perm(x, y, sel) for selectors whose nibbles are 0..7."""
    b = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(b[(sel >> (4 * i)) & 7] << (8 * i) for i in range(4))


def ldmatrix_x4_trans(stage):
    """ldmatrix.sync.aligned.m8n8.x4.trans.b16 over a [32, 16] byte stage whose
    matrix j row r is stage row trans_row_k(8 j + r): lane l gets, from each
    matrix, the 16-bit elements [row 2 (l % 4)][col l / 4] (low half) and
    [row 2 (l % 4) + 1][col l / 4] (high half)."""
    regs = np.zeros((32, 4), np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for j in range(4):
            lo_row = stage[trans_row_k(8 * j + 2 * t)]
            hi_row = stage[trans_row_k(8 * j + 2 * t + 1)]
            lo = int(lo_row[2 * g]) | int(lo_row[2 * g + 1]) << 8
            hi = int(hi_row[2 * g]) | int(hi_row[2 * g + 1]) << 8
            regs[lane, j] = lo | hi << 16
    return regs


def weight_frags(w):
    """csrc/int8_matmul.cu, weight_frags: (even b0, even b1, odd b0, odd b1)."""
    return (byte_perm(w[0], w[1], 0x6420), byte_perm(w[2], w[3], 0x6420),
            byte_perm(w[0], w[1], 0x7531), byte_perm(w[2], w[3], 0x7531))


def _s8(word, i):
    v = (word >> (8 * i)) & 0xFF
    return v - 256 if v > 127 else v


def test_byte_transpose_gives_the_b_fragments():
    """Every lane's four words are the B fragments of the even and the odd
    columns (k 4t + i of column 2g / 2g + 1 in byte i of b0, k 16 + 4t + i
    in b1), and an mma over them is the stage's integer product."""
    rng = np.random.default_rng(0)
    w = rng.integers(-127, 128, (32, 16)).astype(np.int8)  # k rows x 16 columns
    a = rng.integers(-128, 128, (16, 32)).astype(np.int8)  # an m16 tile, k 32
    regs = ldmatrix_x4_trans(w.view(np.uint8))
    bfrag = np.zeros((32, 16), np.int64)  # the B tile [k, column] the lanes hold
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        frags = weight_frags([int(x) for x in regs[lane]])
        for tile, (b0, b1) in enumerate(((frags[0], frags[1]), (frags[2], frags[3]))):
            col = 2 * g + tile
            for i in range(4):
                assert _s8(b0, i) == w[4 * t + i, col]
                assert _s8(b1, i) == w[16 + 4 * t + i, col]
                bfrag[4 * t + i, col] = _s8(b0, i)
                bfrag[16 + 4 * t + i, col] = _s8(b1, i)
    assert torch.equal(_t(a.astype(np.int64)) @ _t(bfrag), _t(a.astype(np.int64) @ w.astype(np.int64)))


def test_stage_layouts_spread_every_matrix_over_eight_bank_groups():
    """The stream form's stage (64 rows of 16 bytes, row k at 16-byte unit k ^
    ((k >> 2) & 2)) and the tiled form's (64 rows of 128 bytes, column group
    c of row k at unit c ^ ((k & 1) | ((k >> 1) & 6))): the eight rows of
    each ldmatrix.trans matrix land in eight different 16-byte bank groups
    (byte offset mod 128), and each layout is a permutation."""
    def stream_unit(k):
        return k ^ ((k >> 2) & 2)

    def tiled_unit(k, c):
        return c ^ ((k & 1) | ((k >> 1) & 6))

    assert sorted(stream_unit(k) for k in range(64)) == list(range(64))
    for k0 in (0, 32):
        for j in range(4):
            rows = [k0 + trans_row_k(8 * j + r) for r in range(8)]
            assert len({(16 * stream_unit(k)) % 128 for k in rows}) == 8
            for c in range(8):
                assert len({(128 * k + 16 * tiled_unit(k, c)) % 128 for k in rows}) == 8
    for k in range(64):
        assert sorted(tiled_unit(k, c) for c in range(8)) == list(range(8))


# --- (b) the split-K sums -------------------------------------------------------------


def _operands(rng, M, K, N, kind):
    b = rng.integers(-127, 128, (K, N)).astype(np.int8)
    sb = rng.uniform(1e-4, 2e-3, N).astype(np.float32)
    if kind == "s8_both":
        a = rng.integers(-128, 128, (M, K)).astype(np.int8)
        azp = rng.integers(-3, 4, M).astype(np.int32)
        bzp = rng.integers(-2, 3, N).astype(np.int32)
        sa = rng.uniform(0.01, 0.02, M).astype(np.float32)
        cs = None
    else:
        a = rng.integers(0, 256, (M, K)).astype(np.uint8)
        azp, bzp, sa = np.uint8(131), None, np.float32(0.02)
        cs = b.astype(np.int32).sum(0)[None, :] if kind == "u8_colsums" else None
    return a, b, sa, sb, azp, bzp, cs


def _kernel_model(a, b, sa, sb, azp, bzp, cs, splits, kchunk):
    """The kernels' integer sums and epilogue: a's u8 flip (a ^ 0x80, zp -
    128), a partial a split with its zero-point terms, the splits summed in
    int32, the given colsums' term, then ((float)acc * s_a) * s_b."""
    M, K = a.shape
    a_u8 = a.dtype == np.uint8
    a8 = (a ^ 0x80).view(np.int8) if a_u8 else a
    A = torch.from_numpy(a8.astype(np.int64))
    B = torch.from_numpy(b.astype(np.int64))
    zpa = torch.zeros(M, 1, dtype=torch.int64)
    has_azp = a_u8 or azp is not None
    if azp is not None:
        zpa = torch.from_numpy(np.asarray(azp, np.int64).reshape(-1, 1)).expand(M, 1)
    if a_u8:
        zpa = zpa - 128
    zpb = None if bzp is None else torch.from_numpy(np.asarray(bzp, np.int64).reshape(1, -1))
    acc = torch.zeros(M, b.shape[1], dtype=torch.int32)
    for s in range(splits):
        k0, k1 = s * kchunk, min(K, (s + 1) * kchunk)
        assert k0 < k1  # no split is empty
        part = A[:, k0:k1] @ B[k0:k1]
        if has_azp and cs is None:
            part = part - zpa * B[k0:k1].sum(0, keepdim=True)
        if zpb is not None:
            part = part - A[:, k0:k1].sum(1, keepdim=True) * zpb
            if has_azp:
                part = part + (k1 - k0) * zpa * zpb
        assert part.abs().max() < 2**31
        acc = acc + part.to(torch.int32)
    if has_azp and cs is not None:
        acc = acc - (zpa * torch.from_numpy(cs.astype(np.int64))).to(torch.int32)
    sa_t = torch.from_numpy(np.asarray(sa, np.float32).reshape(-1, 1) if np.ndim(sa)
                            else np.asarray(sa, np.float32))
    return acc.to(torch.float32) * sa_t * torch.from_numpy(sb)[None, :]


@pytest.mark.parametrize("M,K,N", [(16, 2048, 256), (16, 3072, 768), (120, 1536, 256),
                                   (256, 512, 256), (5, 772, 36)])
@pytest.mark.parametrize("kind", ["u8", "u8_colsums", "s8_both"])
def test_split_sums_equal_the_plain_version(M, K, N, kind):
    """The model of the split kernels' integer sums, at the splits the plan
    picks (TinyLlama's k/v projection and GPT-2's c_proj at 16 rows: 8
    splits; a K 1536 projection at 120 rows: 2; the tiled form at 256
    rows: 4;
    also 3 and 1 split at every shape), equals the plain version bit for
    bit."""
    rng = np.random.default_rng(M * 31 + K + N)
    ops = _operands(rng, M, K, N, kind)
    splits, kchunk, _, _ = tmm.int8_split_plan(M, N, K, SMS)
    if (M, K, N) in ((16, 2048, 256), (16, 3072, 768), (120, 1536, 256), (256, 512, 256)):
        assert splits > 1
    for sp, kc in ((splits, kchunk), (3, -(-K // 3 // 64) * 64), (1, -(-K // 64) * 64)):
        if (sp - 1) * kc >= K:
            continue
        got = _kernel_model(*ops, sp, kc)
        want = tmm.int8_matmul_dequant_plain(*[None if x is None else torch.as_tensor(x)
                                               for x in ops])
        assert torch.equal(got, want), (sp, kc)


# --- (c) the plain version against the JAX package --------------------------------------


@pytest.mark.parametrize("M,K,N,zp", [(1, 128, 256, "per_tensor"), (16, 256, 128, "per_tensor"),
                                      (40, 128, 384, "per_row_and_column")])
def test_plain_matches_the_jax_kernel(M, K, N, zp):
    """u8 activations with a per-tensor u8 zero point, or a per-row one with
    a per-column b zero point: the plain version equals the JAX package's
    Pallas kernel (interpret mode) and its XLA version."""
    rng = np.random.default_rng(M + K + N)
    a = rng.integers(0, 256, (M, K)).astype(np.uint8)
    b = rng.integers(-127, 128, (K, N)).astype(np.int8)
    sb = rng.uniform(1e-4, 2e-3, N).astype(np.float32)
    if zp == "per_tensor":
        sa, azp, bzp = np.float32(0.013), np.uint8(127), None
    else:
        sa = rng.uniform(0.01, 0.02, M).astype(np.float32)
        azp = rng.integers(100, 156, M).astype(np.int32)
        bzp = rng.integers(-2, 3, N).astype(np.int32)
    got = tmm.int8_matmul_dequant(
        _t(a), _t(b), torch.as_tensor(sa), _t(sb), torch.as_tensor(azp),
        None if bzp is None else _t(bzp)).numpy()
    jb = None if bzp is None else jnp.asarray(bzp)
    want_xla = np.asarray(jmm.int8_matmul_dequant_xla(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(sa), jnp.asarray(sb), jnp.asarray(azp), jb))
    want_pallas = np.asarray(jmm.int8_matmul_dequant(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(sa), jnp.asarray(sb), jnp.asarray(azp), jb,
        interpret=True))
    np.testing.assert_allclose(got, want_xla, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got, want_pallas, rtol=1e-6, atol=0)


# --- (d) the form choice and the split plan --------------------------------------------


E, NP = 768, 51200
GPT2 = [(E, 3 * E), (E, E), (E, 4 * E), (4 * E, E), (E, NP)]
TINYLLAMA = [(2048, 2048), (2048, 256), (2048, 5632), (5632, 2048), (2048, 32768)]
QWEN = [(1536, 1536), (1536, 256), (1536, 8960), (8960, 1536), (1536, 151936)]
# (rows, shapes): decode steps (GPT-2's Generator at 1, the serve phases at
# 16, the bench headline at 120) and admissions (16 or 120 slots x 128).
MAIN_PATH = ([(M, GPT2) for M in (1, 16, 120, 2048, 15360)]
             + [(M, TINYLLAMA) for M in (16, 2048)] + [(M, QWEN) for M in (16, 2048)])


@pytest.mark.parametrize("M,shapes", MAIN_PATH)
def test_form_and_split_plan(M, shapes):
    form = tmm.int8_form(M)
    assert form == ("stream" if M <= 16 else "rows" if M <= 128 else "tiled")
    for K, N in shapes:
        if M > 128 and N > 50000:
            continue  # an admission's lm_head runs at one row a slot
        splits, kchunk, tiles, grid_x = tmm.int8_split_plan(M, N, K, SMS)
        assert kchunk % 64 == 0 and (splits - 1) * kchunk < K <= splits * kchunk
        if form == "tiled":
            assert tiles == -(-M // 128) * -(-N // 128) and grid_x == tiles
            assert splits == 1 or 2 * tiles <= SMS  # split only where half the card idles
            assert splits <= tmm.TILED_MAX_SPLITS
            continue
        assert tiles == -(-N // 64)
        assert tmm.stream_smem(M, kchunk) <= tmm.SMEM_BLOCK
        if splits > 1:
            assert grid_x == tiles  # one column tile a block
            target = (2 if form == "stream" else 1) * SMS
            assert tiles < target and splits <= tmm.MAX_SPLITS
            # The fewest splits whose chunks reach 8 * M k (the partials at
            # most half a chunk's weight bytes), then evened out.
            assert splits <= -(-K // (-(-8 * M // 64) * 64))
        else:
            # Blocks walk tiles cg = blockIdx.x, + grid_x, ...: each tile once.
            assert 1 <= grid_x <= tiles
            walked = sorted(x + i * grid_x for x in range(grid_x)
                            for i in range(-(-(tiles - x) // grid_x)))
            assert walked == list(range(tiles))


def test_k_and_v_projections_split_at_decode():
    """TinyLlama's k/v projections (N 256: 4 column tiles) split K 8 ways at
    16 rows; its lm_head (512 tiles) is not split."""
    assert tmm.int8_split_plan(16, 256, 2048, SMS)[:2] == (8, 256)
    assert tmm.int8_split_plan(16, 32768, 2048, SMS)[0] == 1
