"""int4 block-dequant matmul (MatMulNBits): the wrapper of the CUDA kernels
in ``csrc/int4_matmul.cu`` and their plain PyTorch version.

Replaces ``rten_tpu/kernels/int4_matmul.py:int4_matmul_pallas``: f32
activations a [..., K] times int4 weights W [N, K] held as MatMulNBits
operands, packed nibbles [N, nb * block_size / 2] (byte p of a row holds
k = 2p in its low nibble and k = 2p + 1 in its high one), per-block scales
[N, nb] and optional zero points (int32 [N, nb], or u8-packed two to a byte,
``ceil(nb / 2)`` bytes per column; none means 8), nb = ceil(K / block_size).
Each weight is ``(nibble - zp) * scale``; the reference runs the product at
HIGHEST precision (f32).

For CPU tensors ``int4_matmul`` runs the plain version (the JAX package's
``int4_matmul_xla``: dequantize, then an f32 product); for CUDA tensors it
launches a kernel or raises — it never falls back. ``int4_form`` picks the
kernel from M and the block size, each form with its own launch counter:
"stream" (M <= 16: a weight-streaming tensor-core kernel, K split over
blocks where the column tiles alone do not fill the card), "tiled" (M > 16:
a tiled tensor-core kernel, split the same way at small M) and "cuda_core"
(block sizes that are no multiple of 16). The tensor-core forms take the
activations as three bf16 parts and scale each quantization block's
partial sum (the kernel's source note says why, and what bounds it).
``int4_split_plan`` sizes the split from the shapes alone (no host sync);
its workspace and arrival counters are kept per device and stream. Zero
points are unpacked and the activations zero-padded to nb * block_size
here, as the JAX wrapper does; without zero points the kernels read none.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ._build import load_library
from .common import check_cuda_tensor, kernel_device, sm_count, split_workspace

SMS = 132           # the H100's SMs: the split plan's target
STREAM_MAX_M = 16   # rows the stream form takes (one m16 tile of the product)
STREAM_COLS = 64    # weight columns a stream block (4 warps x 16)
TILE_M, TILE_N = 64, 128  # a tiled block's output tile
K_STAGE = 64        # k a pipeline stage of both tensor-core forms
ACT_SMEM = 96 * 1024  # the stream form's staged activations (3 bf16 parts) at most
STREAM_BLOCKS_PER_SM = 2  # the stream form's split target at M <= 8 (small blocks, in pairs)
TILED_MAX_SPLITS = 6  # the tiled form's splits at most
FORMS = ("stream", "tiled", "cuda_core")


def unpack_zero_points(zero_points, N: int, n_blocks: int) -> Optional[torch.Tensor]:
    """Zero points -> int32 [N, n_blocks], or None for none (the constant
    8, the unsigned-int4 mid). u8 zero points are packed
    ``ceil(n_blocks / 2)`` bytes per column (each column padded to a byte
    boundary), so they are unpacked per row (``_unpack_zero_points``)."""
    if zero_points is None:
        return None
    zp = zero_points
    if zp.dtype == torch.uint8:
        bpc = (n_blocks + 1) // 2
        zp = zp.reshape(N, bpc)
        lo = (zp & 0x0F).to(torch.int32)
        hi = ((zp >> 4) & 0x0F).to(torch.int32)
        zp = torch.stack([lo, hi], dim=-1).reshape(N, bpc * 2)[:, :n_blocks]
    return zp.reshape(N, n_blocks).to(torch.int32)


def dequant_nbits(b_packed, scales, zero_points, *, K: int, N: int, block_size: int):
    """Dequantize [N, ceil(K/bs), bs/2]-packed int4 nibbles to f32 [N, K]
    (the JAX package's ``dequant_nbits``): ``(nibble - zp) * scale``, with
    zero points as ``unpack_zero_points`` takes them (none: 8)."""
    n_blocks = -(-K // block_size)
    b = b_packed.reshape(N, n_blocks, block_size // 2)
    lo = (b & 0x0F).to(torch.int32)
    hi = ((b >> 4) & 0x0F).to(torch.int32)
    # Nibbles are packed little-endian: element 2i in low nibble, 2i+1 high.
    vals = torch.stack([lo, hi], dim=-1).reshape(N, n_blocks, block_size)
    zp = unpack_zero_points(zero_points, N, n_blocks)
    zp = 8 if zp is None else zp[:, :, None]
    w = (vals - zp).to(torch.float32) * scales.reshape(N, n_blocks, 1).to(torch.float32)
    return w.reshape(N, n_blocks * block_size)[:, :K]


def int4_matmul_plain(a2, b2, scales2, zps2, *, K: int, N: int, block_size: int):
    """The JAX package's ``int4_matmul_xla``: dequantize every weight to f32
    [N, K], then a2 [M, K] @ W^T -> f32 [M, N]."""
    w = dequant_nbits(b2, scales2, zps2, K=K, N=N, block_size=block_size)
    return a2.to(torch.float32) @ w.T


def int4_form(M: int, block_size: int) -> str:
    """The kernel ``int4_matmul`` launches for M rows: "stream" (M <= 16) or
    "tiled" (M > 16) on tensor cores for block sizes that are a multiple of
    16 (MatMulNBits emits 16, 32, 64, 128), "cuda_core" for the others (8)."""
    if block_size % 16:
        return "cuda_core"
    return "stream" if M <= STREAM_MAX_M else "tiled"


def int4_split_plan(M: int, N: int, K: int, block_size: int,
                    sms: int = SMS) -> Tuple[int, int, int]:
    """(splits, kchunk, tiles) of a tensor-core call: K (a multiple of the
    block size) cut into ``splits`` chunks of ``kchunk`` (whole 64-k stages
    and whole quantization blocks; the last chunk may be shorter, none is
    empty), one block per (output tile, chunk), ``tiles`` output tiles
    (64-column tiles for the stream form, 64 x 128 for the tiled one).

    The chunks are as long as lets tiles * splits blocks reach the target:
    two blocks an SM for the stream form at M <= 8 (its blocks are small),
    one otherwise; where the tiles alone reach it, one split. The stream
    form stages a chunk's activations in shared memory, three bf16 parts,
    so ``3 * M * (2 * kchunk + 64)`` bytes stay within ACT_SMEM; the tiled
    form takes at most TILED_MAX_SPLITS splits, each of which writes and
    merges a whole 64 x 128 partial tile. Shapes only: at GPT-2's N 768
    projections 12 or 24 splits of the stream form (144 or 288 blocks) and
    6 of the tiled one, at its lm_head one."""
    form = int4_form(M, block_size)
    unit = K_STAGE * block_size // math.gcd(K_STAGE, block_size)
    units = max(1, -(-K // unit))
    if form == "stream":
        tiles = -(-N // STREAM_COLS)
        target = (STREAM_BLOCKS_PER_SM if M <= 8 else 1) * sms
        per_max = max(1, (ACT_SMEM // (3 * M) - 64) // 2 // unit)
        per_min = 1
    else:
        tiles = -(-M // TILE_M) * -(-N // TILE_N)
        target = sms
        per_max = units
        per_min = -(-units // TILED_MAX_SPLITS)
    want = -(-target // tiles)  # splits for the target's blocks
    per = max(per_min, min(per_max, max(1, units // want)))
    return -(-units // per), per * unit, tiles


def int4_matmul(a, b_packed, scales, zero_points=None, *, K: int, N: int,
                block_size: int):
    """MatMulNBits: a [..., K] x int4 weights -> [..., N] (a's float dtype,
    else f32)."""
    n_blocks = -(-K // block_size)
    b2 = b_packed.reshape(N, n_blocks * block_size // 2)
    scales2 = scales.reshape(N, n_blocks)
    zps2 = unpack_zero_points(zero_points, N, n_blocks)
    lead = a.shape[:-1]
    a2 = a.reshape(-1, K)
    out_dtype = a.dtype if a.is_floating_point() else torch.float32
    if kernel_device(a2, b2, scales2, zps2) == "cpu":
        out = int4_matmul_plain(a2, b2, scales2, zps2, K=K, N=N, block_size=block_size)
        return out.reshape(*lead, N).to(out_dtype)
    device = a.device
    if block_size < 8 or block_size % 8:
        raise ValueError(f"block_size {block_size}: the kernels take multiples of 8")
    check_cuda_tensor("b_packed", b2, torch.uint8, device)
    check_cuda_tensor("scales", scales2, torch.float32, device)
    if zps2 is not None:
        zps2 = zps2.contiguous()
    if b2.data_ptr() % 4:
        raise ValueError("b_packed must be 4-byte aligned")
    # Weight rows span n_blocks * block_size K positions: zero-pad the
    # activations so the padded weight columns contribute nothing.
    k_data = n_blocks * block_size
    a2 = a2.to(torch.float32)
    if k_data != K:
        a2 = torch.nn.functional.pad(a2, (0, k_data - K))
    a2 = a2.contiguous()
    M = a2.shape[0]
    out = torch.empty((M, N), dtype=torch.float32, device=device)
    if M:
        form = int4_form(M, block_size)
        stream = torch.cuda.current_stream(device).cuda_stream
        splits, kchunk, tiles, ws, count, grid_x = 1, k_data, 1, None, None, 1
        if form != "cuda_core":
            sms = sm_count(device.index)
            splits, kchunk, tiles = int4_split_plan(M, N, k_data, block_size, sms)
            # Stream tiles loop over a grid of at most two blocks an SM above
            # 8 rows, where each block's staged activations are worth reusing.
            grid_x = tiles if M <= 8 or splits > 1 else min(tiles, 2 * sms)
            if splits > 1:
                count, ws = split_workspace(device, stream, tiles, splits * M * N)
                count, ws = count.data_ptr(), ws.data_ptr()
        err = _lib().rten_int4_matmul(
            FORMS.index(form), a2.data_ptr(), a2.stride(0), b2.data_ptr(), scales2.data_ptr(),
            None if zps2 is None else zps2.data_ptr(), out.data_ptr(), ws, count, M, N,
            k_data, block_size, splits, kchunk, grid_x, stream,
        )
        if err:
            raise RuntimeError(f"int4_matmul ({form}) launch failed: CUDA error {err}")
        int4_matmul.launches += 1
        setattr(int4_matmul, f"{form}_launches", getattr(int4_matmul, f"{form}_launches") + 1)
    return out.reshape(*lead, N).to(out_dtype)


# Every launch, and (of them) each form's.
int4_matmul.launches = 0
int4_matmul.stream_launches = 0
int4_matmul.tiled_launches = 0
int4_matmul.cuda_core_launches = 0


def _lib():
    lib = load_library("int4_matmul")
    fn = lib.rten_int4_matmul
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [I, P, L, P, P, P, P, P, P, I, I, I, I, I, I, I, P]
        fn.restype = I
    return lib
