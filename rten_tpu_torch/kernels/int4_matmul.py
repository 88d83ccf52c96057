"""int4 block-dequant matmul (MatMulNBits): the wrapper of the CUDA kernel
in ``csrc/int4_matmul.cu`` and its plain PyTorch version.

Replaces ``rten_tpu/kernels/int4_matmul.py:int4_matmul_pallas``: f32
activations a [..., K] times int4 weights W [N, K] held as MatMulNBits
operands, packed nibbles [N, nb * block_size / 2] (byte p of a row holds
k = 2p in its low nibble and k = 2p + 1 in its high one), per-block scales
[N, nb] and optional zero points (int32 [N, nb], or u8-packed two to a byte,
``ceil(nb / 2)`` bytes per column; none means 8), nb = ceil(K / block_size).
Each weight is ``(nibble - zp) * scale`` and the product runs in f32 (no
TF32: the reference runs HIGHEST precision). The kernel's source note says
what bounds it on the H100.

For CPU tensors ``int4_matmul`` runs the plain version (the JAX package's
``int4_matmul_xla``: dequantize, then an f32 product); for CUDA tensors it
launches the kernel or raises — it never falls back. Zero points are
unpacked and the activations zero-padded to nb * block_size here, as the
JAX wrapper does; without zero points the kernel reads none.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ._build import load_library
from .common import check_cuda_tensor, kernel_device


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
        raise ValueError(f"block_size {block_size}: the kernel takes multiples of 8")
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
        err = _lib().rten_int4_matmul(
            a2.data_ptr(), a2.stride(0), b2.data_ptr(), scales2.data_ptr(),
            None if zps2 is None else zps2.data_ptr(), out.data_ptr(), M, N, k_data,
            block_size, torch.cuda.current_stream(device).cuda_stream,
        )
        if err:
            raise RuntimeError(f"int4_matmul launch failed: CUDA error {err}")
        int4_matmul.launches += 1
    return out.reshape(*lead, N).to(out_dtype)


int4_matmul.launches = 0


def _lib():
    lib = load_library("int4_matmul")
    fn = lib.rten_int4_matmul
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, L, P, P, P, P, I, I, I, I, P]
        fn.restype = I
    return lib
