"""Last-axis argmax, the serving engine's greedy head: the wrapper of the
CUDA kernel in ``csrc/argmax.cu`` and its plain PyTorch version.

Replaces ``rten_tpu/kernels/argmax.py:argmax_lastdim_pallas``. The first
occurrence of the maximum wins, as in ``jnp.argmax``. The kernel takes a
row stride, so a column slice of a wider matrix (the padded lm_head
output cut to the vocabulary) is read in place.

For CPU tensors the wrapper runs the plain version; for CUDA tensors it
launches the kernel or raises — it never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import load_library
from .common import kernel_device


def argmax_plain(x: torch.Tensor) -> torch.Tensor:
    """[M, N] -> int32 [M]: first-occurrence argmax over the last axis."""
    return torch.argmax(x, dim=-1).to(torch.int32)


def argmax_lastdim(x: torch.Tensor) -> torch.Tensor:
    """First-occurrence argmax over the last axis of a 2-D f32 tensor whose
    last axis is unit-stride (rows may be strided) -> int32 [M]."""
    if kernel_device(x) == "cpu":
        return argmax_plain(x)
    if x.ndim != 2 or x.dtype != torch.float32:
        raise ValueError(f"expected a 2-D float32 tensor, got {tuple(x.shape)} {x.dtype}")
    M, N = x.shape
    if x.stride(1) != 1 and N > 1:
        raise ValueError("the last axis must be unit-stride")
    out = torch.empty((M,), dtype=torch.int32, device=x.device)
    if M == 0:
        return out
    err = _lib().rten_argmax_rows(
        x.data_ptr(), x.stride(0), M, N, out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"argmax launch failed: CUDA error {err}")
    argmax_lastdim.launches += 1
    return out


argmax_lastdim.launches = 0


def _lib():
    lib = load_library("argmax")
    fn = lib.rten_argmax_rows
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
