"""Last-axis argmax, the serving engine's greedy head: the wrapper of the
CUDA kernel in ``csrc/argmax.cu`` and its plain PyTorch version.

Replaces ``rten_tpu/kernels/argmax.py:argmax_lastdim_pallas``. The first
occurrence of the maximum wins and a NaN counts as the maximum, as in
``jnp.argmax`` (the reference's router sends every non-TPU device there).
The kernel takes a row stride, so a column slice of a wider matrix (the
padded lm_head output cut to the vocabulary) is read in place.

The kernel splits each row into column chunks, one block each
(``chunk_plan``), and the row's last block to finish merges the chunks'
(value, index) pairs. The pairs and the per-row counters live in a
workspace kept per device and stream and grown as needed, so a call
allocates nothing but its output.

For CPU tensors the wrapper runs the plain version; for CUDA tensors it
launches the kernel or raises — it never falls back.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from ._build import load_library
from .common import kernel_device, sm_count

BLOCKS_PER_SM = 3      # blocks a call aims to put on each SM
MIN_CHUNK_COLS = 4096  # columns a block reads at least (one pass of 256 threads, 4 vectors each)


def chunk_plan(M: int, N: int, sms: int = 132) -> Tuple[int, int]:
    """(chunks, length): the kernel splits each of M rows of N columns into
    ``chunks`` column chunks of ``length`` columns (a multiple of 4; the
    last chunk may be shorter, none is empty), one block each, so that
    M * chunks blocks fill ``sms`` SMs about BLOCKS_PER_SM times over,
    where the rows are long enough for chunks of MIN_CHUNK_COLS. 25 chunks
    at [16, 151936], 4 at [120, 50257], 8 at [16, 32000] on 132 SMs."""
    if N <= 0:
        return 1, 0
    want = max(1, -(-BLOCKS_PER_SM * sms // max(M, 1)))
    chunks = min(want, -(-N // MIN_CHUNK_COLS))
    length = -(-N // chunks)
    length += -length % 4
    return -(-N // length), length


def argmax_plain(x: torch.Tensor) -> torch.Tensor:
    """[M, N] -> int32 [M]: first-occurrence argmax over the last axis."""
    return torch.argmax(x, dim=-1).to(torch.int32)


# (device index, stream) -> (counters int32 [rows], pairs int32 [2, pairs])
_workspaces: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace(device, stream: int, M: int, pairs: int):
    """The counters (all 0 between calls: each call's last blocks reset
    theirs) and the pair storage of this device and stream, grown to hold M
    rows and ``pairs`` pairs. Kernels on one stream run in order, so one
    workspace serves every call made on it."""
    key = (device.index, stream)
    count, part = _workspaces.get(key, (None, None))
    if count is None or count.numel() < M:
        count = torch.zeros(max(M, 2 * (0 if count is None else count.numel())),
                            dtype=torch.int32, device=device)
    if part is None or part.shape[1] < pairs:
        part = torch.empty((2, max(pairs, 2 * (0 if part is None else part.shape[1]))),
                           dtype=torch.int32, device=device)
    _workspaces[key] = (count, part)
    return count, part


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
    chunks, length = chunk_plan(M, N, sm_count(x.device.index))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    count, part = _workspace(x.device, stream, M, M * chunks)
    err = _lib().rten_argmax_rows(
        x.data_ptr(), x.stride(0), M, N, chunks, length, part[0].data_ptr(),
        part[1].data_ptr(), count.data_ptr(), out.data_ptr(), stream,
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
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, ctypes.c_longlong, I, I, I, I, P, P, P, P, P]
        fn.restype = I
    return lib
