"""Fused int8 matmul + dequant: the wrapper of the CUDA kernel in
``csrc/int8_matmul.cu`` and its plain PyTorch version.

Replaces ``rten_tpu/kernels/int8_matmul.py:int8_matmul_dequant``:

    C = ((A - zp_a) . (B - zp_b)) * scale_a * scale_b

with A [M, K] u8 or s8 (u8 is shifted to s8 as ``a ^ 0x80``, ``zp - 128``),
B [K, N] s8 (prepacked), per-tensor or per-row ``scale_a``/``zp_a``,
per-tensor or per-column ``scale_b``/``zp_b``, and optional precomputed
int32 column sums of B (``MatMulIntegerToFloat`` input 7). The kernels'
source note says what bounds them on the H100 and how they are built.

For CPU tensors the wrapper runs the plain version; for CUDA tensors it
launches a kernel or raises — it never falls back. ``int8_form`` picks the
kernel from M, each form on s8 tensor cores with its own launch counter:
"stream" (M <= 16: a weight-streaming kernel, K split over blocks where the
column tiles alone do not fill the card), "rows" (16 < M <= 128: the same
kernel with up to eight m16 tiles of activations) and "tiled" (M > 128: a
128 x 128 tiled kernel). ``int8_split_plan`` sizes the split from the
shapes alone (no host sync); its workspace and arrival counters are kept
per device and stream (``common.split_workspace``). Every form's output is
bit-identical to the plain version's.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ._build import load_library
from .common import (
    check_cuda_tensor, kernel_device, sm_count, split_workspace, u8_to_s8_shift,
)

SMS = 132            # the H100's SMs: the split plan's target
STREAM_MAX_M = 16    # rows the stream form takes (one m16 tile)
ROWS_MAX_M = 128     # rows the rows form takes (eight m16 tiles)
STREAM_COLS = 64     # weight columns a stream / rows block (4 warps x 16)
TILE = 128           # a tiled block's output tile, rows and columns
K_STAGE = 64         # k a pipeline stage of every form
RING_BYTES = 4 * 8 * 1024  # a stream / rows block's weight rings (4 warps x 8 stages of 1 KB)
SMEM_BLOCK = 227 * 1024  # shared memory a block can use
SMEM_SM = 228 * 1024     # ... and an SM holds
MAX_SPLITS = 8       # stream / rows splits at most: the merge's loads stay in flight together
TILED_MAX_SPLITS = 4
FORMS = ("stream", "rows", "tiled")

_ZP_KIND = {torch.uint8: 1, torch.int8: 2, torch.int32: 3}


def int8_matmul_dequant_plain(a, b, a_scale, b_scale, a_zp=None, b_zp=None,
                              b_colsums=None):
    """Plain version (the JAX package's ``int8_matmul_dequant_xla``):
    subtract the zero points, take the exact integer product, scale.

    u8 activations are shifted to s8 as the kernel shifts them
    (``u8_to_s8_shift``). The product runs in float64, which holds every
    partial sum of s8 x s8 over K < 2**37 exactly, so the integer part is
    exact on any device; ``b_colsums`` is accepted for the kernel's
    signature and not needed.
    """
    if a.dtype == torch.uint8:
        zp = torch.zeros((), dtype=torch.uint8, device=a.device) if a_zp is None else a_zp
        a, a_zp = u8_to_s8_shift(a, torch.as_tensor(zp, device=a.device))
    a64 = a.to(torch.float64)
    b64 = b.to(torch.float64)
    if a_zp is not None:
        azp = torch.as_tensor(a_zp, device=a.device).to(torch.float64)
        a64 = a64 - (azp[:, None] if azp.ndim else azp)
    if b_zp is not None:
        bzp = torch.as_tensor(b_zp, device=a.device).to(torch.float64)
        b64 = b64 - (bzp[None, :] if bzp.ndim else bzp)
    acc = a64 @ b64
    sa = torch.as_tensor(a_scale, dtype=torch.float32, device=a.device)
    sb = torch.as_tensor(b_scale, dtype=torch.float32, device=a.device)
    if sa.ndim == 1:
        sa = sa[:, None]
    if sb.ndim == 1:
        sb = sb[None, :]
    return acc.to(torch.float32) * sa * sb


def _vec(name, v, n, dtype, device):
    """A scalar-or-[n] parameter as a contiguous device tensor + stride."""
    t = torch.as_tensor(v, device=device)
    if dtype is not None and t.dtype != dtype:
        t = t.to(dtype)
    t = t.contiguous()
    if t.numel() == 1:
        return t, 0
    if t.numel() != n:
        raise ValueError(f"{name}: expected a scalar or {n} values, got {tuple(t.shape)}")
    return t, 1


def int8_form(M: int) -> str:
    """The kernel ``int8_matmul_dequant`` launches for M rows: "stream"
    (M <= 16), "rows" (16 < M <= 128) or "tiled" (M > 128)."""
    return "stream" if M <= STREAM_MAX_M else "rows" if M <= ROWS_MAX_M else "tiled"


def row_tiles(M: int) -> int:
    """The m16 tiles of activations a stream / rows block holds: 1, 2, 4 or 8."""
    need = -(-M // 16)
    return 1 if need <= 1 else 2 if need <= 2 else 4 if need <= 4 else 8


def stream_smem(M: int, kchunk: int) -> int:
    """A stream / rows block's shared memory: the split's activations
    (16 * row_tiles rows of kchunk + 16 bytes) and the warps' rings."""
    return 16 * row_tiles(M) * (kchunk + 16) + RING_BYTES


def int8_split_plan(M: int, N: int, K: int, sms: int = SMS) -> Tuple[int, int, int, int]:
    """(splits, kchunk, tiles, grid_x) of a call: K cut into ``splits``
    chunks of ``kchunk`` (whole 64-k stages; the chunks as even as 64-k
    stages allow, none empty), one block per (column tile, chunk); ``tiles``
    output tiles (64 columns for stream / rows, 128 x 128 for tiled);
    ``grid_x`` the blocks along the tiles.

    Stream / rows: K is split where the tiles alone do not reach the target
    (two blocks an SM for stream, one for rows), into no more chunks than
    reach 8 * M k each (the int32 partials, 4 * M bytes a column a split,
    stay near half a chunk's weight bytes) and than MAX_SPLITS; the staged
    activations must fit the block's shared memory. Unsplit calls
    run at most as many blocks as the SMs hold at once, each walking its
    tiles. Tiled: split (at most TILED_MAX_SPLITS ways) only where the tiles
    fill less than half the SMs. Shapes only: TinyLlama's k/v projections
    (N 256) at 16 rows take 8 splits, its lm_head one."""
    form = int8_form(M)
    units = max(1, -(-K // K_STAGE))
    if form == "tiled":
        tiles = -(-M // TILE) * -(-N // TILE)
        want = 1 if 2 * tiles > sms else min(TILED_MAX_SPLITS, -(-sms // tiles))
        per = -(-units // want)
    else:
        tiles = -(-N // STREAM_COLS)
        per_max = max(1, ((SMEM_BLOCK - RING_BYTES) // (16 * row_tiles(M)) - 16) // K_STAGE)
        per_min = max(-(-units // MAX_SPLITS), -(-8 * M // K_STAGE))
        want = -(-(2 if form == "stream" else 1) * sms // tiles)
        per = min(per_max, max(per_min, units // want, 1))
    splits = -(-units // per)
    per = -(-units // splits)  # the same splits, chunks as even as whole stages allow
    grid_x = tiles
    if form != "tiled" and splits == 1:
        per_sm = max(1, min(8, SMEM_SM // stream_smem(M, per * K_STAGE)))
        grid_x = min(tiles, per_sm * sms)
    return splits, per * K_STAGE, tiles, grid_x


def int8_matmul_dequant(a, b, a_scale, b_scale, a_zp=None, b_zp=None,
                        b_colsums=None):
    """a [M, K] (u8|s8) x b [K, N] s8 -> f32 [M, N]; see the module doc."""
    dev = kernel_device(a, b)
    if dev == "cpu":
        return int8_matmul_dequant_plain(
            a, b, a_scale, b_scale, a_zp, b_zp, b_colsums
        )
    device = a.device
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"shapes {tuple(a.shape)} x {tuple(b.shape)}")
    if a.dtype not in (torch.uint8, torch.int8):
        raise TypeError(f"a: dtype {a.dtype}, expected uint8 or int8")
    check_cuda_tensor("a", a, a.dtype, device)
    check_cuda_tensor("b", b, torch.int8, device)
    M, K = a.shape
    N = b.shape[1]
    if K < 1 or K % 4 or N % 4 or a.data_ptr() % 4 or b.data_ptr() % 4:
        raise ValueError("K (at least 4) and N must be multiples of 4 with 4-byte-aligned data")
    sa, sa_stride = _vec("a_scale", a_scale, M, torch.float32, device)
    sb, sb_stride = _vec("b_scale", b_scale, N, torch.float32, device)
    keep = [sa, sb]
    azp_ptr, azp_kind, azp_stride = None, 0, 0
    if a_zp is not None:
        azp, azp_stride = _vec("a_zp", a_zp, M, None, device)
        if azp.dtype not in _ZP_KIND:
            azp = azp.to(torch.int32)
        azp_ptr, azp_kind = azp.data_ptr(), _ZP_KIND[azp.dtype]
        keep.append(azp)
    bzp_ptr, bzp_kind, bzp_stride = None, 0, 0
    if b_zp is not None:
        bzp, bzp_stride = _vec("b_zp", b_zp, N, None, device)
        if bzp.dtype not in _ZP_KIND:
            bzp = bzp.to(torch.int32)
        bzp_ptr, bzp_kind = bzp.data_ptr(), _ZP_KIND[bzp.dtype]
        keep.append(bzp)
    cs_ptr = None
    if b_colsums is not None:
        cs = b_colsums
        check_cuda_tensor("b_colsums", cs, torch.int32, device)
        if cs.numel() != N:
            raise ValueError(f"b_colsums: expected {N} values, got {tuple(cs.shape)}")
        cs_ptr = cs.data_ptr()
    out = torch.empty((M, N), dtype=torch.float32, device=device)
    if M == 0 or N == 0:
        return out
    form = int8_form(M)
    splits, kchunk, tiles, grid_x = int8_split_plan(M, N, K, sm_count(device.index))
    stream = torch.cuda.current_stream(device).cuda_stream
    ws_ptr = count_ptr = None
    if splits > 1:
        count, ws = split_workspace(device, stream, tiles, splits * M * N)
        ws_ptr, count_ptr = ws.data_ptr(), count.data_ptr()
    err = _lib().rten_int8_matmul_dequant(
        FORMS.index(form), a.data_ptr(), int(a.dtype == torch.uint8), b.data_ptr(), M, N, K,
        sa.data_ptr(), sa_stride, sb.data_ptr(), sb_stride,
        azp_ptr, azp_kind, azp_stride, bzp_ptr, bzp_kind, bzp_stride,
        cs_ptr, out.data_ptr(), ws_ptr, count_ptr, kchunk, splits, grid_x, stream,
    )
    if err:
        raise RuntimeError(f"int8_matmul_dequant ({form}) launch failed: CUDA error {err}")
    int8_matmul_dequant.launches += 1
    setattr(int8_matmul_dequant, f"{form}_launches",
            getattr(int8_matmul_dequant, f"{form}_launches") + 1)
    del keep
    return out


# Every launch, and (of them) each form's.
int8_matmul_dequant.launches = 0
int8_matmul_dequant.stream_launches = 0
int8_matmul_dequant.rows_launches = 0
int8_matmul_dequant.tiled_launches = 0


def _lib():
    lib = load_library("int8_matmul")
    fn = lib.rten_int8_matmul_dequant
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [I, P, I, P, I, I, I, P, I, P, I, P, I, I, P, I, I, P, P, P, P,
                       I, I, I, P]
        fn.restype = I
    return lib
