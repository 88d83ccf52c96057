"""Fused int8 matmul + dequant: the wrapper of the CUDA kernel in
``csrc/int8_matmul.cu`` and its plain PyTorch version.

Replaces ``rten_tpu/kernels/int8_matmul.py:int8_matmul_dequant``:

    C = ((A - zp_a) . (B - zp_b)) * scale_a * scale_b

with A [M, K] u8 or s8 (u8 is shifted to s8 as ``a ^ 0x80``, ``zp - 128``),
B [K, N] s8 (prepacked), per-tensor or per-row ``scale_a``/``zp_a``,
per-tensor or per-column ``scale_b``/``zp_b``, and optional precomputed
int32 column sums of B (``MatMulIntegerToFloat`` input 7). The kernel's
source note says what bounds it on the H100 and how it is built.

For CPU tensors the wrapper runs the plain version; for CUDA tensors it
launches the kernel or raises — it never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import load_library
from .common import check_cuda_tensor, kernel_device, u8_to_s8_shift

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
    if K % 4 or N % 4 or a.data_ptr() % 4 or b.data_ptr() % 4:
        raise ValueError("K and N must be multiples of 4 with 4-byte-aligned data")
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
    lib = _lib()
    err = lib.rten_int8_matmul_dequant(
        a.data_ptr(), int(a.dtype == torch.uint8), b.data_ptr(), M, N, K,
        sa.data_ptr(), sa_stride, sb.data_ptr(), sb_stride,
        azp_ptr, azp_kind, azp_stride, bzp_ptr, bzp_kind, bzp_stride,
        cs_ptr, out.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"int8_matmul_dequant launch failed: CUDA error {err}")
    int8_matmul_dequant.launches += 1
    del keep
    return out


int8_matmul_dequant.launches = 0


def _lib():
    lib = load_library("int8_matmul")
    fn = lib.rten_int8_matmul_dequant
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, I, P, I, I, I, P, I, P, I, P, I, I, P, I, I, P, P, P]
        fn.restype = I
    return lib
