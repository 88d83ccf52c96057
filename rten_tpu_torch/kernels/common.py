"""Shared helpers of the port's kernel wrappers (the port of
``rten_tpu/kernels/common.py``; its ``round_up`` has no caller here, as
the CUDA kernels mask ragged tiles instead of padding operands)."""

from __future__ import annotations

import torch


def u8_to_s8_shift(a: torch.Tensor, a_zp: torch.Tensor):
    """Reinterpret u8 data as s8 by flipping the sign bit, adjusting the zp.

    u8 value v == (s8 reinterpretation of v^0x80) + 128, so
    (v - zp) == (v^0x80 viewed as s8) - (zp - 128). The int8 kernel applies
    the same flip to each loaded word instead of materializing the copy.
    """
    shifted = (a ^ 0x80).view(torch.int8)
    new_zp = a_zp.to(torch.int32) - 128
    return shifted, new_zp


def check_cuda_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                      device: torch.device, contiguous: bool = True) -> None:
    """Validate a tensor handed to a CUDA kernel; raise on anything the
    kernel does not take."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def kernel_device(*tensors: torch.Tensor) -> str:
    """'cpu' when every tensor lies on the CPU (the plain version runs),
    'cuda' when every tensor lies on one CUDA device (the kernel launches).
    Anything else raises: there is no fallback from a CUDA tensor."""
    types = {t.device.type for t in tensors if isinstance(t, torch.Tensor)}
    if types == {"cpu"}:
        return "cpu"
    if types == {"cuda"}:
        if len({t.device for t in tensors if isinstance(t, torch.Tensor)}) != 1:
            raise ValueError("kernel inputs lie on different CUDA devices")
        return "cuda"
    raise ValueError(f"kernel inputs on unsupported devices: {sorted(types)}")
