"""Microbenchmark of decode attention at the serving headline's shape: the
port's folded kernel (``kernels.flash_attention.decode_mha``) against a
streaming floor and three other formulations, each a CUDA kernel in
``csrc/bench_decode_attn.cu`` beside its plain PyTorch version.

    python3 -m rten_tpu_torch.tools.bench_decode_attn [--slots 32] [--cap 256]
        [--heads 12] [--d 64] [--device cuda]

The port of ``tools/bench_decode_attn.py``:

* ``dma_floor`` (replaces ``tools/bench_decode_attn.py:51``): streams every
  slot's whole f32 K and V and sums them, plus q's first head row: the
  memory floor of a decode step.
* ``vpu_attn`` (``:89``): decode attention per (slot, head) on CUDA cores,
  K of H heads, one pass with an online softmax (the keys split over
  blocks by ``vpu_plan`` where the (slot, head) pairs would not fill the
  card); a slot with ``lens < 0`` gets the mean of V.
* ``bd_decode`` (``:214``): decode attention from K stored transposed,
  ``kt [B, Hkv, D, cap]``; ``nt_decode`` (``:318``): the same from natural
  ``[B, Hkv, cap, D]`` K. f32 or bf16 K/V, f32 or bf16 q, kv-major GQA,
  an online softmax over key blocks of ``min(block_k, cap)`` columns whose
  grid drops the keys past ``(cap // bk) * bk``; a slot with no valid
  column gives 0. With bf16 K/V ``bd`` scores an f32 q in f32 from the
  widened K, ``nt`` rounds q to bf16 for the score, and both round p to
  bf16 for the value product. With a bf16 q ``bd`` rounds f32 K to bf16 for
  the score (the reference casts kt to q's dtype), ``nt`` scores f32 K as
  it is, and both return bf16 (the reference's output has q's dtype).

Every wrapper checks dtypes, shapes and groups on any device and raises on
what its kernel does not take; given CPU tensors it then runs its plain
version, given CUDA tensors it launches its kernel (counted in its
``launches``; ``vpu_attn``, ``bd_decode`` and ``nt_decode`` also count in
``split_launches`` the calls whose plan, ``vpu_plan`` or ``fold_plan``,
splits the keys over blocks) or raises. Nothing runs at import: no argument parsing, no
build.

``main`` prints the reference's lines. ``timed`` is CUDA events around
back-to-back calls; ``timed_chained`` makes call i + 1's q depend on call
i's output (the serving regime, where layers run in turn) and differences
two loop lengths so that fixed costs cancel. In eager PyTorch each link of
the chain also launches the small update ``q + 1e-9 * o``, which the
reference's ``lax.scan`` ran too. With ``--device cpu`` (for the tests)
the plain versions run, the loops are shorter, and every line says
``[cpu]``: those times are the CPU's, not the card's.
"""

from __future__ import annotations

import argparse
import ctypes
import time
from typing import NamedTuple

import numpy as np
import torch

from ..kernels._build import load_library
from ..kernels.common import check_cuda_tensor, kernel_device, sm_count
from ..kernels.flash_attention import SMS, _split_workspace, decode_mha, decode_split_plan

NEG_INF = -1e30
H100_HBM_GBPS = 3350.0  # H100 SXM device memory, GB/s
THREADS = 256           # dma_floor's block size (csrc/bench_decode_attn.cu)
VPU_MAX_D = 256         # vpu_attn's largest head dim (csrc/bench_decode_attn.cu, VPU_MAXD)


def _shape(name, t, ndim):
    if not isinstance(t, torch.Tensor) or t.dim() != ndim:
        raise ValueError(f"{name}: expected a {ndim}-D tensor, got "
                         f"{tuple(t.shape) if isinstance(t, torch.Tensor) else type(t).__name__}")


def _check_lens(lens, B):
    if not isinstance(lens, torch.Tensor) or lens.dtype != torch.int32 or lens.numel() != B:
        raise ValueError(f"lens: expected {B} int32 values")


def _check_q(q, B, H, D, dtypes=(torch.float32,)):
    _shape("q", q, 4)
    if q.dtype not in dtypes:
        raise TypeError(f"q: dtype {q.dtype}, expected one of {dtypes}")
    if tuple(q.shape) != (B, H, 1, D):
        raise ValueError(f"q: expected {(B, H, 1, D)}, got {tuple(q.shape)}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(fn, *args):
    err = fn(*args)
    if err:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")


def _on_card(dev, *named, align=4):
    """Device, contiguity and ``align``-byte alignment of the kernel's
    operands (dtypes and shapes are checked on every device before)."""
    for name, t in named:
        check_cuda_tensor(name, t, t.dtype, dev)
        if t.data_ptr() % align:
            raise ValueError(f"{name}: its data must be {align}-byte aligned")


# --- 1. dma_floor -----------------------------------------------------------


def dma_floor_plain(q, k, v, lens):
    """[B, 1, D]: each slot's K and V summed over (Hkv, cap) plus q[b, 0, 0];
    ``lens`` is taken and unused, as in the reference."""
    return (k.sum((1, 2)) + v.sum((1, 2)) + q[:, 0, 0]).reshape(k.shape[0], 1, k.shape[3])


def dma_floor(q, k, v, lens):
    """q [B, H, 1, D] f32, k/v [B, Hkv, cap, D] f32 -> [B, 1, D] f32 (see
    ``dma_floor_plain``). D a multiple of 4 up to 1024."""
    _shape("k", k, 4)
    B, Hkv, cap, D = k.shape
    _check_q(q, B, q.shape[1] if q.dim() == 4 else 0, D)
    if k.dtype != torch.float32 or v.dtype != torch.float32 or v.shape != k.shape:
        raise TypeError(f"k/v: expected two float32 {tuple(k.shape)} tensors, got "
                        f"{k.dtype} {tuple(k.shape)} / {v.dtype} {tuple(v.shape)}")
    if D % 4 or D > 4 * THREADS:
        raise ValueError(f"head dim {D} not supported (a multiple of 4 up to {4 * THREADS})")
    _check_lens(lens, B)
    if kernel_device(q, k, v, lens) == "cpu":
        return dma_floor_plain(q, k, v, lens)
    dev = q.device
    _on_card(dev, ("q", q), ("lens", lens))
    _on_card(dev, ("k", k), ("v", v), align=16)  # 16-byte vector loads
    # Split each slot's 2 * Hkv * cap rows over enough blocks to fill the
    # card (four per SM), each covering at least one pass of its threads.
    rows, sweep = 2 * Hkv * cap, THREADS // (D // 4)
    sms = sm_count(dev.index)
    chunks = max(1, min(-(-4 * sms // B), -(-rows // sweep)))
    per = -(-rows // chunks)
    chunks = -(-rows // per)
    partial = torch.empty((B, chunks, D), dtype=torch.float32, device=dev)
    out = torch.empty((B, 1, D), dtype=torch.float32, device=dev)
    _launch(_lib().rten_dma_floor, q.data_ptr(), k.data_ptr(), v.data_ptr(), partial.data_ptr(),
            out.data_ptr(), B, q.shape[1], Hkv, cap, D, chunks, per,
            torch.cuda.current_stream(dev).cuda_stream)
    dma_floor.launches += 1
    return out


dma_floor.launches = 0


# --- 2. vpu_attn ------------------------------------------------------------


def vpu_attn_plain(q, k, v, lens, scale):
    """softmax(q . K^T * scale) V per (slot, head) over columns <= lens[b];
    masked scores are -1e30 with no guard, so a slot with lens < 0 gets the
    mean of V."""
    cap = k.shape[2]
    s = torch.einsum("bhd,bhcd->bhc", q[:, :, 0], k) * scale
    col = torch.arange(cap, device=q.device)
    s = torch.where(col[None, None, :] <= lens.to(torch.int64)[:, None, None], s, NEG_INF)
    p = torch.exp(s - s.amax(2, keepdim=True))
    o = torch.einsum("bhc,bhcd->bhd", p, v) / p.sum(2, keepdim=True)
    return o[:, :, None, :]


def vpu_plan(B, H, cap, sms=SMS):
    """(splits, chunk) of a ``vpu_attn`` call, from the shapes alone: each
    (slot, head)'s columns cut into ``splits`` chunks of ``chunk`` keys, one
    block each, where the B * H pairs alone would not give every SM a block
    (``decode_split_plan`` over them); one split at the tool's shape."""
    return decode_split_plan(B * H, cap, sms)


def vpu_attn(q, k, v, lens, scale):
    """q [B, H, 1, D] f32, k/v [B, H, cap, D] f32 (K has H heads) ->
    [B, H, 1, D] f32 (see ``vpu_attn_plain``). D a multiple of 4 up to
    ``VPU_MAX_D``, any cap."""
    _shape("k", k, 4)
    B, H, cap, D = k.shape
    _check_q(q, B, q.shape[1] if q.dim() == 4 else 0, D)
    if q.shape[1] != H:
        raise ValueError(f"vpu_attn: K has {H} heads, q {q.shape[1]}; it takes no GQA")
    if k.dtype != torch.float32 or v.dtype != torch.float32 or v.shape != k.shape:
        raise TypeError("k/v: expected two float32 tensors of one shape")
    if D % 4 or D > VPU_MAX_D:
        raise ValueError(f"head dim {D} not supported (a multiple of 4 up to {VPU_MAX_D})")
    _check_lens(lens, B)
    if kernel_device(q, k, v, lens) == "cpu":
        return vpu_attn_plain(q, k, v, lens, scale)
    dev = q.device
    _on_card(dev, ("lens", lens))
    _on_card(dev, ("q", q), ("k", k), ("v", v), align=16)  # 16-byte loads along D
    splits, chunk = vpu_plan(B, H, cap, sm_count(dev.index))
    stream = torch.cuda.current_stream(dev).cuda_stream
    count = ws = None
    if splits > 1:
        count, ws = _split_workspace(dev, stream, B * H, B * H * splits * (D + 2))
    out = torch.empty((B, H, 1, D), dtype=torch.float32, device=dev)
    _launch(_lib().rten_vpu_attn, q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
            out.data_ptr(), _ptr(ws), _ptr(count), B, H, cap, D, splits, chunk, float(scale),
            stream)
    vpu_attn.launches += 1
    if splits > 1:
        vpu_attn.split_launches += 1
    return out


vpu_attn.launches = vpu_attn.split_launches = 0


# --- 3./4. bd_decode, nt_decode --------------------------------------------


def _fold_plain(q, k, v, lens, scale, block_k, round_q, round_k=False):
    """The reference's online softmax, block by block, with its rounding
    points: k [B, Hkv, cap, D] natural; bf16 K/V round p to bf16 for the
    value product (and q for the score when ``round_q``, K when
    ``round_k``); the output has q's dtype."""
    B, H, _, D = q.shape
    Hkv, cap = k.shape[1], k.shape[2]
    group = H // Hkv
    bk = min(block_k, cap)
    bf16 = v.dtype == torch.bfloat16
    qh = q[:, :, 0, :].reshape(B, Hkv, group, D).to(torch.float32)
    if round_q:
        qh = qh.to(torch.bfloat16).to(torch.float32)
    last = lens.to(torch.int64)[:, None, None, None]
    m = torch.full((B, Hkv, group, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, group, D), dtype=torch.float32, device=q.device)
    for i in range(cap // bk):
        kb = k[:, :, i * bk:(i + 1) * bk]
        kb = (kb.to(torch.bfloat16) if round_k else kb).to(torch.float32)
        vb = v[:, :, i * bk:(i + 1) * bk].to(torch.float32)
        s = torch.matmul(qh, kb.transpose(2, 3)) * scale
        col = i * bk + torch.arange(bk, device=q.device)
        s = torch.where(col <= last, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(3, keepdim=True))
        p = torch.where(m_new <= NEG_INF / 2, 0.0, torch.exp(s - m_new))
        alpha = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(m - m_new))
        l = l * alpha + p.sum(3, keepdim=True)
        if bf16:
            p = p.to(torch.bfloat16).to(torch.float32)
        acc = acc * alpha + torch.matmul(p, vb)
        m = m_new
    l = torch.where(l == 0.0, 1.0, l)
    return (acc / l).reshape(B, H, 1, D).to(q.dtype)


def bd_decode_plain(q, kt, v, lens, *, scale, block_k=256):
    """``bd_decode``'s function in plain PyTorch (K transposed back)."""
    return _fold_plain(q, kt.transpose(2, 3), v, lens, scale, block_k, round_q=False,
                       round_k=q.dtype == torch.bfloat16)


def nt_decode_plain(q, k, v, lens, *, scale, block_k=256):
    """``nt_decode``'s function in plain PyTorch."""
    return _fold_plain(q, k, v, lens, scale, block_k, round_q=k.dtype == torch.bfloat16)


def _check_fold(q, k, v, lens, transposed, block_k):
    """The shapes bd/nt take; returns (B, H, Hkv, cap, D, bk)."""
    _shape("k", k, 4)
    _shape("v", v, 4)
    B, Hkv, cap, D = v.shape
    want_k = (B, Hkv, D, cap) if transposed else (B, Hkv, cap, D)
    if tuple(k.shape) != want_k:
        raise ValueError(f"k: expected {want_k}, got {tuple(k.shape)}")
    if k.dtype != v.dtype or k.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"k/v: expected float32 or bfloat16 of one dtype, got {k.dtype}/{v.dtype}")
    H = q.shape[1] if q.dim() == 4 else 0
    _check_q(q, B, H, D, (torch.float32, torch.bfloat16))
    if H % Hkv:
        raise ValueError(f"{H} query heads over {Hkv} kv heads: not a whole group")
    if D % 2 or D > 256:
        raise ValueError(f"head dim {D} not supported (even, up to 256)")
    bk = min(int(block_k), cap)
    if bk < 1:
        raise ValueError(f"block_k {block_k}: no key block")
    _check_lens(lens, B)
    return B, H, Hkv, cap, D, bk


FOLD_TILE = 16  # keys of a warp's tile (csrc/bench_decode_attn.cu, FT_KEYS)


class FoldPlan(NamedTuple):
    """How ``bd_decode``/``nt_decode``'s kernel cuts one call, from the
    shapes alone: ``rows`` query rows a block (two 8-row mma n-tiles for
    bf16 K/V at groups above 8 and D <= 128, else one), ``row_tiles`` of
    them a (slot, kv head), the ``kept`` keys (the reference's grid drops
    those at or past ``(cap // bk) * bk``) cut into ``splits`` chunks of
    ``chunk`` keys (``decode_split_plan`` over the units B * Hkv *
    row_tiles), and ``warps`` a block, each taking the chunk's 16-key tiles
    in turn."""
    rows: int
    row_tiles: int
    kept: int
    splits: int
    chunk: int
    warps: int


def fold_plan(B, H, Hkv, cap, D, dtype, block_k=256, sms=SMS):
    """The plan of a call at these shapes on a card of ``sms`` SMs."""
    group = H // Hkv
    bk = min(int(block_k), cap)
    kept = (cap // bk) * bk
    bf16 = dtype == torch.bfloat16
    rows = 16 if bf16 and group > 8 and D <= 128 else 8
    row_tiles = -(-group // rows)
    splits, chunk = decode_split_plan(B * Hkv * row_tiles, kept, sms)
    return FoldPlan(rows, row_tiles, kept, splits, chunk, 2 if not bf16 and D > 128 else 4)


def _copy_bytes(t, row_bytes):
    """The piece the kernel copies a row of ``t`` in: 16-byte cp.async where
    every row starts 16-byte aligned, else 4 bytes, else (bf16 kt of odd
    cap) 2."""
    for n in (16, 4):
        if row_bytes % n == 0 and t.data_ptr() % n == 0:
            return n
    return 2


def _fold(fn, shape, q, k, v, lens, scale, transposed):
    B, H, Hkv, cap, D, bk = shape
    dev = q.device
    _on_card(dev, ("q", q), ("lens", lens))
    _on_card(dev, ("k", k), ("v", v), align=2 * k.element_size())  # the pieces' alignment
    plan = fold_plan(B, H, Hkv, cap, D, k.dtype, bk, sm_count(dev.index))
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = count = None
    if plan.splits > 1:
        count, ws = _split_workspace(dev, stream, B * Hkv * plan.row_tiles,
                                     B * H * plan.splits * (D + 2))
    es = k.element_size()
    out = torch.empty((B, H, 1, D), dtype=q.dtype, device=dev)
    _launch(_lib().rten_fold_attn, int(k.dtype == torch.bfloat16), int(transposed),
            int(q.dtype == torch.bfloat16), plan.rows, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            lens.data_ptr(), out.data_ptr(), _ptr(ws), _ptr(count), B, H, Hkv, cap, D, plan.kept,
            plan.splits, plan.chunk, _copy_bytes(k, (cap if transposed else D) * es),
            _copy_bytes(v, D * es), float(scale), stream)
    fn.launches += 1
    if plan.splits > 1:
        fn.split_launches += 1
    return out


def bd_decode(q, kt, v, lens, *, scale, block_k=256):
    """q [B, H, 1, D] f32 or bf16, kt [B, Hkv, D, cap] and v [B, Hkv, cap, D]
    (f32 or bf16), lens [B] int32 -> [B, H, 1, D] in q's dtype. Any even D
    up to 256, any group H / Hkv."""
    shape = _check_fold(q, kt, v, lens, True, block_k)
    if kernel_device(q, kt, v, lens) == "cpu":
        return bd_decode_plain(q, kt, v, lens, scale=scale, block_k=block_k)
    return _fold(bd_decode, shape, q, kt, v, lens, scale, transposed=True)


bd_decode.launches = bd_decode.split_launches = 0


def nt_decode(q, k, v, lens, *, scale, block_k=256):
    """``bd_decode``'s function from natural k [B, Hkv, cap, D]."""
    shape = _check_fold(q, k, v, lens, False, block_k)
    if kernel_device(q, k, v, lens) == "cpu":
        return nt_decode_plain(q, k, v, lens, scale=scale, block_k=block_k)
    return _fold(nt_decode, shape, q, k, v, lens, scale, transposed=False)


nt_decode.launches = nt_decode.split_launches = 0

KERNELS = (dma_floor, vpu_attn, bd_decode, nt_decode)


def _lib():
    lib = load_library("bench_decode_attn")
    if lib.rten_fold_attn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.rten_dma_floor.argtypes = [P, P, P, P, P, I, I, I, I, I, I, I, P]
        lib.rten_vpu_attn.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I, F, P]
        lib.rten_fold_attn.argtypes = [I, I, I, I, P, P, P, P, P, P, P,
                                       I, I, I, I, I, I, I, I, I, I, F, P]
        for fn in (lib.rten_dma_floor, lib.rten_vpu_attn, lib.rten_fold_attn):
            fn.restype = ctypes.c_int
    return lib


# --- timing and the report --------------------------------------------------


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _clock(device, run):
    """Milliseconds of run(): CUDA events on the card, the host clock on
    the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        run()
        return (time.perf_counter() - t0) * 1e3
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    run()
    t1.record()
    torch.cuda.synchronize(device)
    return t0.elapsed_time(t1)


def timed(fn, *args, iters=30):
    """(microseconds per call, output): a warm-up call and a synchronize,
    then ``iters`` back-to-back calls between two CUDA events."""
    device = args[0].device
    out = fn(*args)
    _sync(device)

    def run():
        for _ in range(iters):
            fn(*args)

    return _clock(device, run) / iters * 1e3, out


def timed_chained(fn, q, *rest, iters=400):
    """Serialized per-call latency in microseconds: call i + 1's q is
    ``q + 1e-9 * o`` of call i's output o. Loops of 8 and ``iters`` calls,
    the fastest of three walls each, differenced so that fixed costs
    cancel; each link also launches the update."""

    def chain(n):
        x = q
        for _ in range(n):
            x = x + 1e-9 * fn(x, *rest).reshape(x.shape)
        return x

    chain(8)
    chain(iters)
    _sync(q.device)
    ws = min(_clock(q.device, lambda: chain(8)) for _ in range(3))
    wl = min(_clock(q.device, lambda: chain(iters)) for _ in range(3))
    return (wl - ws) / (iters - 8) * 1e3


def main(argv=None):
    """Print the reference's report at one shape on one device; returns
    {line label: microseconds (and "<label> maxerr")}. ``--device cuda``
    (the default) fails without a card."""
    ap = argparse.ArgumentParser(prog="python3 -m rten_tpu_torch.tools.bench_decode_attn")
    ap.add_argument("--slots", type=int, default=32)
    ap.add_argument("--cap", type=int, default=256)
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--d", type=int, default=64)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: run on the card, or pass --device cpu")
    device = torch.device(args.device)
    where = "cuda" if device.type == "cuda" else "cpu"
    # The plain versions on the CPU are slow: shorter loops there.
    iters, chain = (30, 400) if where == "cuda" else (3, 24)
    B, H, cap, D = args.slots, args.heads, args.cap, args.d

    rng = np.random.default_rng(0)
    q = torch.as_tensor(rng.standard_normal((B, H, 1, D)), dtype=torch.float32).to(device)
    k = torch.as_tensor(rng.standard_normal((B, H, cap, D)), dtype=torch.float32).to(device)
    v = torch.as_tensor(rng.standard_normal((B, H, cap, D)), dtype=torch.float32).to(device)
    lens = torch.as_tensor(rng.integers(cap // 2, cap - 2, B), dtype=torch.int32).to(device)
    scale = 1.0 / float(np.sqrt(D))
    kv_mb = 2 * B * H * cap * D * 4 / 1e6
    name = torch.cuda.get_device_name(device) if where == "cuda" else "the CPU (plain versions)"
    res = {}

    def line(label, us, mb=kv_mb, eff="", err=None):
        res[label] = us
        text = f"{label + ':':28s}{us:9.1f} us  ({mb / us * 1e6 / 1e3:.0f} GB/s{eff})"
        if err is not None:
            res[label + " maxerr"] = err
            text += f"  maxerr {err:.2e}"
        print(f"{text}  [{where}]", flush=True)

    print(f"{name}: shape B={B} H={H} cap={cap} D={D}; KV={kv_mb:.0f}MB -> floor "
          f"{kv_mb / (H100_HBM_GBPS * 1e3) * 1e6:.1f}us at {H100_HBM_GBPS:.0f}GB/s "
          f"(H100 SXM)  [{where}]", flush=True)

    def err(got, ref):
        return float((got.float() - ref).abs().max())

    t, ref = timed(lambda *a: decode_mha(*a, scale=scale), q, k, v, lens, iters=iters)
    line("current folded-loop kernel", t)
    t, _ = timed(dma_floor, q, k, v, lens, iters=iters)
    line("pure DMA floor (same layout)", t)
    t, got = timed(lambda *a: vpu_attn(*a, scale), q, k, v, lens, iters=iters)
    line("VPU-vectorized kernel", t, err=err(got, ref))

    kt = k.transpose(2, 3).contiguous()  # [B, H, D, cap]
    t, got = timed(lambda *a: bd_decode(*a, scale=scale), q, kt, v, lens, iters=iters)
    line("blockdiag kernel (K^T)", t, err=err(got, ref))
    ktb, vb = kt.to(torch.bfloat16), v.to(torch.bfloat16)
    t, got = timed(lambda *a: bd_decode(*a, scale=scale), q, ktb, vb, lens, iters=iters)
    line("blockdiag bf16 (K^T)", t, kv_mb / 2, " eff", err(got, ref))

    t = timed_chained(lambda x, *r: decode_mha(x, *r, scale=scale), q, k, v, lens, iters=chain)
    line("CHAINED current kernel", t)
    kb16 = k.to(torch.bfloat16)
    t = timed_chained(lambda x, *r: decode_mha(x, *r, scale=scale), q, kb16, vb, lens,
                      iters=chain)
    line("CHAINED bf16-KV kernel", t, kv_mb / 2, " eff")

    def floor_fn(x, k, v, lens):
        return dma_floor(x, k, v, lens)[:, None].expand(B, H, 1, D)

    line("CHAINED DMA floor", timed_chained(floor_fn, q, k, v, lens, iters=chain))
    t = timed_chained(lambda x, *r: bd_decode(x, *r, scale=scale), q, kt, v, lens, iters=chain)
    line("CHAINED blockdiag (K^T)", t)
    t = timed_chained(lambda x, *r: bd_decode(x, *r, scale=scale), q, ktb, vb, lens, iters=chain)
    line("CHAINED blockdiag bf16", t, kv_mb / 2, " eff")

    t, got = timed(lambda *a: nt_decode(*a, scale=scale), q, k, v, lens, iters=iters)
    line("NT natural-layout kernel", t, err=err(got, ref))
    t = timed_chained(lambda x, *r: nt_decode(x, *r, scale=scale), q, k, v, lens, iters=chain)
    line("CHAINED NT natural", t)
    t = timed_chained(lambda x, *r: nt_decode(x, *r, scale=scale), q, kb16, vb, lens,
                      iters=chain)
    line("CHAINED NT bf16", t, kv_mb / 2, " eff")
    return res


if __name__ == "__main__":
    main()
