"""Chip smoke test of the PyTorch/CUDA port (rten_tpu_torch) on one NVIDIA card.

Run from the repository root:  python3 chip_smoke.py

1. Builds every CUDA kernel of the port from ``rten_tpu_torch/csrc`` (one
   nvcc per source, in parallel, in the background: each phase's first
   launch of a kernel waits for its own library) and prints, at the end,
   when each library was ready.
2. Kernel phases: each kernel against its plain PyTorch version on the same
   inputs on the card, then the times of the kernel, the plain version and
   one PyTorch library call computing the same function (a yardstick only;
   the port never calls it), beside the least time the card could take.
   Each time is the card's busy time from torch.profiler, held to the
   call's byte floor (a window that reads below it is profiled again and
   the run fails if every window does; calls whose bytes fit the 50 MB L2
   have none); the CUDA-event time of back-to-back calls, which includes
   the host's launch overhead, is printed beside it as "wall" (see
   ``timed``). GPT-2 124M's kernels at the serving headline's shapes
   (slots 120, cap 256, prompt 128: E 768, H 12, D 64, vocab 50257); the
   int8 matmul and the argmax also at the TinyLlama serve phase's shapes,
   the int8 matmul's GPT-2 step also at 16 rows (the serve phases' slots),
   1 (a Generator step) and 96 (the hard config's slots), each case on its
   form (stream, rows, tiled) and equal to its plain version bit for bit,
   one admission's per-layer calls totalled; decode_mha_append_cat and
   prefill_mha_cat also at the hard config's shapes (96 slots over cap
   1024, lengths 128-512 and the edges; a 96 x 128 admission);
   decode_mha's two forms at TinyLlama's attention shape (H 32 over 4 KV
   heads, D 64, slots 16, cap 256; S 1 and S 128; s8 and f32 caches; a
   window: the fold split over blocks, on tensor cores for s8 and on CUDA
   cores for f32, the per-head form on tensor cores, f32 in 3xTF32), the
   CUDA-core per-head kernel (D 129-512) at D 256; paged_decode_mha at the same shape on block pools (block size
   64, a shuffled table); decode_mha_append_cat through a block table at
   the GPT-2 headline shape (a pool of 1 + 480 blocks of 64 rows, idle
   slots colliding in block 0); mha at the Generator's prefill (B 1, H 12,
   T 128, D 64, causal, 37 left-pad columns), at T 1024, and with GQA 32/4
   and softcap 30 (B 2, Tq 256, Tk 512), all on tensor cores, the first two
   also in bf16 beside SDPA in bf16; int4_matmul over one GPT-2 124M
   forward's 49 MatMulNBits calls at M 1, 16, 128 and a serve admission's
   2048 (the lm_head there at 16), and with u8 zero points. The f32/bf16
   modes (no scales) of the attention kernels: the flat append and
   prefill_mha_cat at GPT-2's headline in bf16 and f32 and at
   Qwen2.5-1.5B's attention (H 12 over 2 KV heads, D 128, slots 16, 28
   calls) in bf16, the block-table append on bf16 pools of 1 + 480 blocks,
   decode_mha's two forms and paged_decode_mha on bf16 at TinyLlama's
   attention shape; the argmax also at [16, 151936] (Qwen's vocabulary).
   The decode-attention microbenchmark's four kernels (dma_floor,
   vpu_attn, bd_decode, nt_decode) at its shape (slots 32, H 12, cap 256,
   D 64), at slots 128 and, for bd/nt, at TinyLlama's attention, then the
   tool's own report, its launch counters zeroed just before
   (phase_decode_attn_tool).
3. Serve phases, each through the user's entry points (builder,
   quantize_dynamic, Model, ContinuousBatchingEngine) with every launch
   counter zeroed just before and read just after (each kernel of the path
   must have run, as often as the path's forwards say; the int8 matmul on
   its stream form at every decode step and tiled at every admission, mha
   never on CUDA cores, decode_mha's fold never on CUDA cores, GPT-2's bf16
   paged admissions on the 3xTF32 per-head kernel):
   - TinyLlama-1.1B's shape at full width, its depth cut to 2 of 22 layers
     (random weights from seed 0), int8 weights, int8 head-major KV caches;
   - the same TinyLlama weights on paged int8 head-major pools (41 blocks
     of 64 rows: 40 usable, 3 per request, so at most 13 requests run and
     admissions wait for blocks);
   - GPT-2 124M at full width (12 layers), int8 weights, int8 cat KV;
   - GPT-2 on paged int8 cat pools (``bench.py``'s RTEN_BENCH_PAGED graph,
     the same 41-block pool);
   - GPT-2 on the int4 weight-only graph (``bench.py``'s
     RTEN_BENCH_QUANT=int4: int4 weights, int8 cat KV);
   - TinyLlama's shape again, the same 2 layers, on bf16 head-major
     caches, then on paged bf16 head-major pools, then on int4 head-major
     caches (kv_bits=4), then on int8 head-major caches with the attention
     nodes marked ``rten_kernel_append`` (no builder emits it; decode steps
     through decode_mha_append);
   - GPT-2 on bf16 cat caches (``bench.py``'s RTEN_BENCH_KV=bf16), then on
     paged bf16 cat pools (the same 41-block pool);
   - GPT-2 on ``bench.py``'s RTEN_BENCH_KV=int4 graph: int8 weights, int4
     head-major KV caches, deferred KV with bf16 recent windows (the fold's
     window mode at decode steps, the per-head form on int4 caches at
     admissions, the windows committed once per dispatch);
   - Qwen2.5-1.5B's published shape at full width, 4 of its 28 layers
     (random weights from seed 0, int8 weights) on bf16 cat caches: D 128,
     group 6 through prefill_mha_cat and decode_mha_append_cat;
   each behind the engine with 16 slots, cap 256, prefill bucket 128, 8
   steps per dispatch, answering 24 requests of 128 seeded tokens with
   16-48 new tokens each; then a profiled wave of 16 more requests. The
   paged phases end with every block back in the pool.
4. Generate phases: GPT-2 124M at full width through ``gpt2.load`` and the
   ``Generator`` (batch 1, a 91-token prompt in the bucket of 128, 64 new
   greedy tokens), f32 and int4 weight-only: TTFT, decode tok/s, host wall
   against the card's busy time per step, and the launches (mha 12 per
   prefill, int4_matmul 49 per forward).
5. Reference phases, the card against the CPU (the plain versions): small
   GPT-2 and Llama models behind the engine give the same tokens (each
   supported cache layout: s8, f32 and bf16, cat and head-major; paged too,
   on a pool small enough that admissions wait; Llama also at D 128; int4
   and deferred caches; the small int4 Llama at D 64 and 128 also held
   forward by forward, every quantizer code equal but for flips on a
   rounding boundary, see int4_engine_lockstep), and
   the full widths cut to 2 layers (TinyLlama's s8, paged and bf16,
   GPT-2's s8 and bf16, Qwen2.5-1.5B's bf16 cat) give finite logits close
   to the CPU's (see logits_card_vs_cpu); small GPT-2 Generators (f32 and int4, batch 1 and
   2) give the same tokens, and the full width cut to 2 layers gives
   prefill logits within 1e-5 of max|logit| (phase_reference_generate);
   and the rest of the serving stack (phase_reference_serving): host
   sampling, the full-bucket lm_head, chunked prefill, shared prefixes flat
   and paged, mixed LoRA adapters, speculative decoding, 2 dispatches a
   drain and pipeline_dispatch give the CPU's tokens, and one HTTP round
   trip through serve_background on the card gives the card engine's.
6. The hard config (``bench.py:run_hard_config``, phase_serve_hard): GPT-2
   124M at cap 1024, int8 weights and cat KV, 96 slots, sampled on the
   device (temperature 0.8, top-k 40), 64 steps a dispatch and 2 dispatches
   a drain, a wave of 96 128-token prompts with 384 new tokens: tok/s,
   TTFT, host wall and card busy time per forward, the host's seconds
   issuing against draining; the argmax never launches. Then the device
   sampler (phase_sampling): its filters on the card against the CPU, top-k
   1 and temperature 1e-6 against the greedy engine, seed determinism with
   drains and pipelining, and 2^16 draws against their probabilities.

7. Loading phases: GPT-2 124M's published layout as a
   hand-written module (tests/gpt2_onnx.py, weights from seed 0) exported
   to ONNX and loaded by ``Model.load_file`` onto the card
   (``phase_load_onnx``: the optimizer's graph equal to the CPU's, 12
   Attention nodes; 4 prompts of 128 tokens in f32 against the module's
   forward, mha 12 a forward; int8 against the port's CPU run, 49
   int8_matmul_dequant a forward); then the CLI in this process
   (``phase_cli``): the GPT-2 serving graph saved as .rtpu and served by
   ``--serve``, its tokens equal to the in-process engine's, and the
   timing mode on the ONNX file with ``--quantize int8`` and ``int4``.
8. Vision phases: ResNet-50 (tests/torch_models.resnet50, weights from
   seed 0) exported to ONNX and loaded onto the card by
   ``Model.load_file``, batch 16 at 224 x 224 in f32 (logits against the
   module's f64 forward), int8 with the default ``quantize_dynamic`` (row
   1 once a forward, the classifier) and with ``RTEN_QUANT_CONV=all`` (48
   ConvIntegerToFloat, each one row-1 launch), the int8 forms held to the
   JAX package's criteria against the module's forward; row 1 timed at
   the classifier's and conv1's im2col shapes (``phase_resnet50``); every
   vision op as a one-node graph against the CPU, the f32 conv's precision
   with cuDNN's TF32 flag on, and prefer_bf16 (``phase_vision_ops``); row
   1 at K and N that are not multiples of 4 (``phase_int8_any_kn``).
9. Encoder-decoder phases: Whisper-tiny at its published widths
   (``phase_whisper``; tests/whisper_weights.py from seed 0): 30 s of
   seeded 16 kHz audio through the STFT mel front end graph on the card,
   ``WhisperModel.encode`` and a greedy ``Generator`` of 64 tokens after
   the start-of-transcript prompt, every mha call (4 an encode at [1, 6,
   1500, 64], 8 in the 32-row prefill) held against mha_plain within
   1e-4, the mel and the logits held against the port's CPU run; the
   front end's, the encode's and cross_kv's device ms, TTFT, decode tok/s,
   host wall against busy per step, and mha timed at the encoder's shape.
   Then the Optimum-style merged decoder (tests/merged_decoder_model.py:
   an ONNX If on use_cache_branch, cross caches made on the first run)
   exported, loaded onto the card and driven by the Generator: the torch
   module's own greedy tokens (``phase_merged_decoder``).
10. Text and host-library phases: text in, text out at GPT-2 124M's full
   width in int8 (``phase_text_generate``): tests/torch_tokenizer_spec.py's
   50257-entry byte-level BPE loaded by ``Tokenizer.from_file`` on its
   native core (built with g++ at first use; its encode equal to the Python
   core's on the prompt and on 1 MB of text, both cores' MB/s), a prompt
   string through ``gpt2.load(quantize="int8")``, the ``Generator`` (bucket
   128, greedy) and ``TextDecoder.wrap``, 64 tokens streamed (row 1 49 a
   forward, row 5 12 at the prefill; TTFT, tok/s and the decoder's share of
   the host wall). Then ``phase_host_libs``: every ``functional`` helper on
   the card against the CPU (``arg_max`` through row 4), CTC greedy and
   beam decoding of log-probs from ``functional.log_softmax`` on the card,
   ``normalize_image`` on the card, and the native contour tracing and NMS
   against their Python cores on the host.
11. The tensor-parallel serve phase (``phase_tensor_parallel``, after
   ``gpt2_serve``): rows 1-4 held at a rank's shapes (row 1 in every form,
   the row-parallel products in its int32 mode, bit for bit; rows 2 and 3
   at 6 heads; row 4 on a [16, 25152] vocabulary shard), then two ranks
   (``python3 chip_smoke.py --tp-rank R STORE OUT``, gloo, both on the one
   card, group and parent waits bounded) serve GPT-2 124M int8 cut by the
   derived plan over MeshConfig(1, 2) as ``gpt2_serve`` serves it: both
   ranks' tokens must equal that phase's, request for request; each rank's
   launches by row and form, its collectives a forward and their host ms,
   and rank 0's TTFT, tok/s, host wall and busy a forward are printed.

Prints a ``{"kernels": [...]}`` line, the card's name and power limit, and
as its last line ``{"ok": true, "device": {...}}``. Exits nonzero, printing
no result, when there is no CUDA device or any phase fails. TF32 is off for
matmuls and cuDNN, so every f32 product on the card is full f32, but in the
vision phases, which run the port with cuDNN's TF32 flag at PyTorch's
default (on): the port's f32 convs must not depend on it.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
INT8_OPS_PER_S = 1.979e15     # int8 tensor cores, dense
F32_FLOPS_PER_S = 67e12       # f32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12     # TF32 tensor cores, dense
BF16_FLOPS_PER_S = 989e12     # bf16 tensor cores, dense

SLOTS, CAP, PROMPT = 120, 256, 128
E, H, D, VOCAB, NP = 768, 12, 64, 50257, 51200


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def device_events(prof):
    """The card's work that a stopped torch.profiler run recorded: (name,
    count, total microseconds) for each kernel or copy name. Read from the
    profiler's raw results, which skips building its Python event tree
    (seconds for a serve wave); its key_averages() where those are not
    exposed."""
    from torch.autograd import DeviceType

    try:
        totals = {}
        for e in prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA or PRIME_KERNEL in e.name() or (
                    hasattr(e, "is_user_annotation") and e.is_user_annotation()):
                continue
            ns = e.duration_ns() if hasattr(e, "duration_ns") else e.duration_us() * 1e3
            if ns > 0:
                c, t = totals.get(e.name(), (0, 0.0))
                totals[e.name()] = (c + 1, t + ns / 1e3)
        return [(name, c, t) for name, (c, t) in totals.items()]
    except AttributeError:
        return [(e.key, e.count, e.self_device_time_total) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                and PRIME_KERNEL not in e.key]


def event_counts(prof):
    """{name: (events, of them of zero duration)} of the card's work in a
    stopped profile, zero-duration events included (``device_events``
    leaves them out): what a short window is printed as beside a full one."""
    from torch.autograd import DeviceType

    out = {}
    try:
        events = list(prof.profiler.kineto_results.events())
    except AttributeError:
        return out
    for e in events:
        if e.device_type() != DeviceType.CUDA or PRIME_KERNEL in e.name() or (
                hasattr(e, "is_user_annotation") and e.is_user_annotation()):
            continue
        ns = e.duration_ns() if hasattr(e, "duration_ns") else e.duration_us() * 1e3
        c, z = out.get(e.name(), (0, 0))
        out[e.name()] = (c + 1, z + int(ns <= 0))
    return out


def timeline(prof, h0, calls=(), h1=None):
    """A stopped profile on the host's clock, in ms from ``h0``
    (``time.time_ns()`` on entering it): the trace's start, each call's
    launch and the window's end on the host, the spin kernels of the
    prime recorded, and the card's first and last four other events (name,
    start, duration)."""
    from torch.autograd import DeviceType

    res = prof.profiler.kineto_results
    evs = sorted((e for e in res.events() if e.device_type() == DeviceType.CUDA),
                 key=lambda e: e.start_ns())
    primes = sum(PRIME_KERNEL in e.name() for e in evs)
    evs = [e for e in evs if PRIME_KERNEL not in e.name()]
    ms = lambda t: round((t - h0) / 1e6, 3)  # noqa: E731
    brief = [(e.name()[:40], ms(e.start_ns()), round(e.duration_ns() / 1e3, 1))
             for e in (evs if len(evs) <= 8 else evs[:4] + evs[-4:])]
    return {"trace_start": ms(res.trace_start_ns()), "calls": [ms(t) for t in calls],
            "end": None if h1 is None else ms(h1), "primes": primes, "n": len(evs),
            "events": brief}


# A profile loses the card's events of the first launches made in it
# (ROADMAP fault 8): a window's first call went unrecorded, whole or in
# part, while every later call was recorded, and idling 20 ms in the
# profile before the work did not help. So each profile first launches
# spin kernels for at least PROFILE_PRIME_MS of the host's time and waits
# for them: they take the loss in the work's place, and ``device_events``
# leaves them out.
PROFILE_PRIME_MS = 5.0
PRIME_KERNEL = "spin_kernel"  # torch.cuda._sleep's kernel


@contextlib.contextmanager
def card_profile():
    """torch.profiler over the card's activity, primed (PROFILE_PRIME_MS)."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < PROFILE_PRIME_MS / 1e3:
            for _ in range(64):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
        yield prof


PROFILE_ATTEMPTS = 8  # profiled windows a timing may take before it fails
L2_BYTES = 50 * 2**20  # the H100's L2


def byte_floor_ms(nbytes: float):
    """The least device time of a call that must move ``nbytes`` bytes,
    timed back to back: the bytes that cannot stay in the 50 MB L2 between
    calls, over the HBM rate. None where they all fit (an L2-warm call,
    which may beat the HBM bound: no floor)."""
    return None if nbytes <= L2_BYTES else (nbytes - L2_BYTES) / HBM_BYTES_PER_S * 1e3


def timed(fn, iters: int = 20, warmup: int = 3, *, nbytes: float):
    """Mean milliseconds of one fn() over iters, two ways: (device, wall).

    device: the summed duration of every kernel (and copy) that fn()
    launched on the card, from torch.profiler; the host's time between
    launches is left out (checked against one profiled call's count of
    device events). wall: CUDA events around iters back-to-back
    calls; where the card finishes a call before the host has launched the
    next, this is the host's launch rate, not the kernel's time. Where the
    profiler records no device time in any window, device is None.
    ``nbytes``: the bytes one fn() must move at least (its inputs read
    once, its outputs written once). The profiler has dropped events of a
    window, and all of them, and has read a window short before: a window
    with no events or fewer than iters times one call's, or whose device
    time is below the call's byte floor (``byte_floor_ms``; none for an
    L2-warm call), is profiled again, and the run fails if every attempt
    that recorded events falls short."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    wall = t0.elapsed_time(t1) / iters
    floor = byte_floor_ms(nbytes)
    # One call's device events, then iters calls'.
    recorded = False
    for attempt in range(PROFILE_ATTEMPTS):
        h_one = time.time_ns()
        with card_profile() as one:
            fn()
            torch.cuda.synchronize()
        per_call = sum(c for _, c, _ in device_events(one))
        h0 = time.time_ns()
        with card_profile() as prof:
            calls = []
            for _ in range(iters):
                calls.append(time.time_ns())
                fn()
            torch.cuda.synchronize()
            h1 = time.time_ns()
        events = device_events(prof)
        busy, count = sum(t for _, _, t in events), sum(c for _, c, _ in events)
        device = busy / iters / 1e3 if busy > 0 else None
        recorded = recorded or count > 0
        if count == 0 or count < per_call * iters:
            print(f"  (the profiler recorded {count} of {per_call * iters} device events: "
                  f"profiling again; one call's events {json.dumps(event_counts(one))}, the "
                  f"window's {json.dumps(event_counts(prof))}, as (events, of zero "
                  f"duration); timelines, ms from entering the profile: one call "
                  f"{json.dumps(timeline(one, h_one))}, the window "
                  f"{json.dumps(timeline(prof, h0, calls, h1))})",
                  flush=True)
        elif floor is not None and device is not None and device < floor:
            print(f"  (device time {device:.4f} ms is below the byte floor {floor:.4f} ms of "
                  f"{nbytes / 1e6:.1f} MB: profiling again)", flush=True)
        else:
            return device, wall
    if not recorded:
        return None, wall
    fail(f"the profiler dropped device events, or read below the byte floor "
         f"({'none' if floor is None else f'{floor:.4f} ms'}), in {PROFILE_ATTEMPTS} windows "
         f"running")


def ms_of(t):
    """The reported time of a ``timed`` pair: the device time, or the wall
    time where the profiler recorded none."""
    return t[1] if t[0] is None else t[0]


def fmt(t, scale: float = 1.0) -> str:
    return f"{scale * ms_of(t):.4f} ms (wall {scale * t[1]:.4f})"


def time_keys(kernel, plain, library, scale: float = 1.0):
    """A kernel row's times from three ``timed`` pairs, each times scale."""
    def both(t, key):
        return {key: None if t is None else scale * ms_of(t),
                key.replace("ms", "wall_ms"): None if t is None else scale * t[1]}
    return {**both(kernel, "ms"), **both(plain, "plain_ms"), **both(library, "library_ms")}


def bound_ms(nbytes: float, ops: float, peak_ops: float):
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak_ops * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def sdpa_bytes(q, kv_rows, Hkv, Dh, el):
    """The bytes an SDPA yardstick must move at least: its q read and its
    output (q's shape and dtype) written, and ``kv_rows`` (slot, position)
    rows of K and V at ``Hkv`` heads of ``Dh`` ``el``-byte elements read."""
    return 2 * q.numel() * q.element_size() + 2 * kv_rows * Hkv * Dh * el


def split_plan(B, Hkv, cap):
    """(splits, chunk) of a split decode-attention call at this shape on this
    card (kernels/flash_attention.py, decode_split_plan, as the wrappers
    run it)."""
    from rten_tpu_torch.kernels.common import sm_count
    from rten_tpu_torch.kernels.flash_attention import decode_split_plan

    return decode_split_plan(B * Hkv, cap, sm_count(0))


def attn_peak(kv) -> float:
    """The operations peak of an attention call's bound: the bf16 tensor
    cores for s8, int4 and bf16 caches, whose values bf16 holds exactly (the
    reference feeds its matrix unit bf16 for them, and the port's kernels
    run there), the TF32 tensor cores for f32 K/V (the port's 3xTF32
    kernels run there; rows that ran on CUDA cores also give the f32 rate's
    figure, ``bound_ms_f32_cuda_cores``)."""
    return TF32_FLOPS_PER_S if kv in ("f32", torch.float32) else BF16_FLOPS_PER_S


# --- kernel phases ------------------------------------------------------------


INT_MM_MIN_ROWS = 32  # cuBLAS's _int_mm refuses M <= 16; smaller M is padded to this


def int_mm_ms(a, b):
    """``timed`` torch._int_mm on the same operands (the s8 view of a), the
    library yardstick; a with at most 16 rows, which cuBLAS refuses, is
    padded with zero rows to INT_MM_MIN_ROWS (the printout says so). None
    where cuBLAS refuses the shape or layout anyway."""
    a_s8 = (a ^ 0x80).view(torch.int8)
    if a_s8.shape[0] <= 16:
        a_s8 = torch.cat([a_s8, a_s8.new_zeros(INT_MM_MIN_ROWS - a_s8.shape[0], a_s8.shape[1])])
    refusal = ""
    for bb in (b, b.t().contiguous().t()):
        try:
            torch._int_mm(a_s8, bb)
        except RuntimeError as e:
            refusal = str(e).splitlines()[0]
            continue
        nbytes = a_s8.numel() + bb.numel() + 4 * a_s8.shape[0] * bb.shape[1]
        return timed(lambda: torch._int_mm(a_s8, bb), iters=10, nbytes=nbytes)
    print(f"  _int_mm refused {tuple(a_s8.shape)} x {tuple(b.shape)}: {refusal}", flush=True)
    return None


# One decode step's int8 matmuls, (K, N, calls): GPT-2 at slots 120 (four
# projections per layer plus the padded lm_head) and the Llama serve
# phase's TinyLlama at slots 16 (q, k, v, o, gate, up, down per layer plus
# the lm_head padded to 32768). Admission adds the per-layer shapes at
# M = slots * 128.
GPT2_INT8 = [(768, 2304, 12), (768, 768, 12), (768, 3072, 12), (3072, 768, 12),
             (768, NP, 1)]
LLAMA_INT8 = [(2048, 2048, 44), (2048, 256, 44), (2048, 5632, 44), (5632, 2048, 22),
              (2048, 32768, 1)]


def _int8_case(gen, dev, M, K, N, tag, time_it=True, int32=False):
    """int8_matmul_dequant at [M, K] x [K, N] (u8 activations with a zero
    point, per-column scales and column sums) against its plain version:
    equal bits, the same bits on a second call, the form int8_form names
    (``int32``: the int32 mode, the corrected accumulator a row-parallel
    rank all-reduces, its counter moving too). With ``time_it``, the
    kernel, plain and ``_int_mm`` times and the bound (a dict for the
    kernels line)."""
    from rten_tpu_torch.kernels.common import sm_count
    from rten_tpu_torch.kernels.int8_matmul import (
        int8_form, int8_matmul_dequant, int8_matmul_dequant_plain, int8_split_plan,
    )

    a = torch.randint(0, 256, (M, K), generator=gen, dtype=torch.uint8).to(dev)
    b = torch.randint(-127, 128, (K, N), generator=gen, dtype=torch.int8).to(dev)
    sa = torch.tensor(0.02, device=dev)
    sb = (torch.rand(N, generator=gen) * 1e-3 + 1e-4).to(dev)
    zp = torch.tensor(131, dtype=torch.uint8, device=dev)
    cs = b.to(torch.int32).sum(0, keepdim=True).to(torch.int32)
    form = int8_form(M)
    before = getattr(int8_matmul_dequant, f"{form}_launches")
    before32 = int8_matmul_dequant.int32_launches
    got = int8_matmul_dequant(a, b, sa, sb, zp, None, cs, out_int32=int32)
    again = int8_matmul_dequant(a, b, sa, sb, zp, None, cs, out_int32=int32)
    want = int8_matmul_dequant_plain(a, b, sa, sb, zp, None, cs, out_int32=int32)
    torch.cuda.synchronize()
    if (got.shape != (M, N) or not torch.equal(got, want) or not torch.equal(got, again)
            or getattr(int8_matmul_dequant, f"{form}_launches") != before + 2
            or int8_matmul_dequant.int32_launches != before32 + 2 * int32):
        fail(f"int8_matmul_dequant [{tag}] M={M} K={K} N={N}{' int32' if int32 else ''}: not "
             f"equal to its plain version, two calls differ, or not the {form} form")
    if int32 and not torch.equal((got.float() * sa) * sb,
                                 int8_matmul_dequant(a, b, sa, sb, zp, None, cs)):
        fail(f"int8_matmul_dequant [{tag}] M={M} K={K} N={N}: the int32 mode scaled is not the "
             f"f32 output")
    if not time_it:
        return form
    nbytes = M * K + K * N + 8 * N + 4 * M * N
    k_ms = timed(lambda: int8_matmul_dequant(a, b, sa, sb, zp, None, cs, out_int32=int32),
                 iters=10, nbytes=nbytes)
    p_ms = timed(lambda: int8_matmul_dequant_plain(a, b, sa, sb, zp, None, cs, out_int32=int32),
                 iters=3, warmup=1, nbytes=nbytes)
    lib = int_mm_ms(a, b)
    bms, by = bound_ms(nbytes, 2.0 * M * N * K, INT8_OPS_PER_S)
    splits = int8_split_plan(M, N, K, sm_count(0))[0]
    pad = f" (M padded to {INT_MM_MIN_ROWS})" if M <= 16 else ""
    print(f"  int8_matmul [{tag}] M={M} K={K} N={N}{' int32 mode' if int32 else ''} ({form}, {splits} "
          f"split{'s' if splits > 1 else ''}): kernel {fmt(k_ms)}, plain {fmt(p_ms)}, "
          f"_int_mm{pad} {'refused' if lib is None else fmt(lib)}, bound {bms:.4f} ms ({by}); "
          f"equal to the plain version, two calls bit-identical", flush=True)
    return {"unit": f"{tag}: M {M}, K {K}, N {N}{', int32 mode' if int32 else ''}",
            "form": form, "int32_mode": int32, "max_abs_err": 0.0,
            **time_keys(k_ms, p_ms, lib), "bound_ms": bms, "bound_by": by}


def phase_int8_matmul(gen, dev, decode=GPT2_INT8, slots=SLOTS, tag="GPT-2", steps=()):
    """int8_matmul_dequant (rten_tpu_torch/csrc/int8_matmul.cu) over one
    decode step's calls at ``slots`` rows and at each of ``steps`` (GPT-2:
    16, the serve phases' slots, 1, a Generator step, and 96, the hard
    config's slots), and one
    admission's per-layer calls at slots x 128 rows: each case on the form
    int8_form names (its counter moves by the two calls), equal to
    int8_matmul_dequant_plain bit for bit, the same bits on a second call,
    its form and split count printed beside its times. Returns the step at
    ``slots`` as the row, the other steps and the admission (the four
    per-layer shapes x layers) as ``other_shapes``."""
    from rten_tpu_torch.kernels.int8_matmul import int8_form

    admission = slots * PROMPT
    calls = [(M, K, N, n) for M in (slots, *steps) for K, N, n in decode]
    calls += [(admission, K, N, n) for K, N, n in decode[:-1]]
    per_shape = [(M, K, N, n, _int8_case(gen, dev, M, K, N, tag)) for M, K, N, n in calls]

    step_shapes = [(K, N) for K, N, _ in decode]

    def unit(M, what):
        rows = [(r, n) for m, K, N, n, r in per_shape
                if m == M and (M == admission or (K, N) in step_shapes)]

        def tot(key):
            return sum(r[key] * n for r, n in rows)

        lib = None if any(r["library_ms"] is None for r, _ in rows) else tot("library_ms")
        bound = tot("bound_ms")
        bytes_bound = sum(r["bound_ms"] * n for r, n in rows if r["bound_by"] == "bytes")
        r = {"unit": what, "form": int8_form(M), "max_abs_err": 0.0, "ms": tot("ms"),
             "plain_ms": tot("plain_ms"), "bound_ms": bound,
             "bound_by": "bytes" if 2 * bytes_bound >= bound else "operations",
             "library_ms": lib, "wall_ms": tot("wall_ms"), "plain_wall_ms": tot("plain_wall_ms"),
             "library_wall_ms": None if lib is None else tot("library_wall_ms")}
        print(f"  int8_matmul [{tag}] {what} ({r['form']}): kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f}, _int_mm {lib if lib is None else f'{lib:.4f}'}, "
              f"bound {bound:.4f} ms", flush=True)
        return r

    calls_step = sum(n for _, _, n in decode)
    calls_adm = sum(n for _, _, n in decode[:-1])
    head = unit(slots, f"one {tag} decode step at slots {slots}: {calls_step} calls")
    others = [unit(M, f"one {tag} decode step at M {M}: {calls_step} calls") for M in steps]
    others.append(unit(admission, f"one {tag} admission at M {admission} (slots {slots} x "
                                  f"{PROMPT}): the per-layer calls, {calls_adm}"))
    return {
        "name": "int8_matmul_dequant", "route": "cuda",
        "source": "rten_tpu_torch/csrc/int8_matmul.cu",
        "replaces": "rten_tpu/kernels/int8_matmul.py:121", **head,
        "library_call": "torch._int_mm (integer product only, no epilogue; cuBLAS refuses "
                        f"M <= 16, so M <= 16 is padded to {INT_MM_MIN_ROWS} rows)",
        "other_shapes": others,
    }


def _caches(gen, dev, B, Hkv, cap=CAP):
    """Random s8 cat caches and their scales, drawn on the card from a
    generator seeded from ``gen`` (on the host, the hard config's 13 sets
    of cap-1024 caches took about 15 s)."""
    g = torch.Generator(device=dev).manual_seed(
        int(torch.randint(2**62, (1,), generator=gen).item()))
    kc = torch.randint(-127, 128, (B, cap, Hkv * D), generator=g, dtype=torch.int8, device=dev)
    vc = torch.randint(-127, 128, (B, cap, Hkv * D), generator=g, dtype=torch.int8, device=dev)
    ks = torch.rand(B, Hkv, cap, 1, generator=g, device=dev) * 0.015 + 0.005
    vs = torch.rand(B, Hkv, cap, 1, generator=g, device=dev) * 0.015 + 0.005
    return kc, vc, ks, vs


def _sdpa_inputs(q, kc, vc, ks, vs, lens, S):
    from rten_tpu_torch.kernels.flash_attention import cat_to_heads

    B, Hkv, cap = ks.shape[:3]
    kf = cat_to_heads(kc, Hkv).float() * ks
    vf = cat_to_heads(vc, Hkv).float() * vs
    j = torch.arange(cap, device=q.device)
    qpos = lens.long()[:, None, None, None] + torch.arange(S, device=q.device)[None, None, :, None]
    return kf, vf, j <= qpos


def _decode_append_case(gen, dev, B, cap, lo, hi, unit, heads=H, plan_kv_heads=None):
    """decode_mha_append_cat at B slots over cap-row cat caches, the slots'
    lengths drawn from [lo, hi) but for four edges (an empty cache, 31, the
    last row, past cap): one call against its plain version (the output
    within 1e-3, the s8 caches equal, the scales within 5e-6), then timed
    over 12 layers' caches, as one decode step reads them. ``heads``: a
    tensor-parallel rank's share of GPT-2's 12, whose calls plan their
    splits for ``plan_kv_heads`` (the unsharded 12), as the rank does."""
    H = heads  # noqa: N806 (the global H, the unsharded count, elsewhere)
    from rten_tpu_torch.kernels.flash_attention import (
        decode_mha_append_cat, decode_mha_append_cat_plain,
    )

    q = torch.randn(B, H, 1, D, generator=gen).to(dev)
    kn = torch.randn(B, H, 1, D, generator=gen).to(dev)
    vn = torch.randn(B, H, 1, D, generator=gen).to(dev)
    lens = torch.randint(lo, hi, (B,), generator=gen, dtype=torch.int32)
    lens[:4] = torch.tensor([0, 31, cap - 1, cap + 5], dtype=torch.int32)
    lens = lens.to(dev)
    kc, vc, ks, vs = _caches(gen, dev, B, H, cap)
    k1 = [t.clone() for t in (kc, vc, ks, vs)]
    k2 = [t.clone() for t in (kc, vc, ks, vs)]
    got = decode_mha_append_cat(q, *k1[:2], lens, *k1[2:], k_new=kn, v_new=vn,
                                 plan_kv_heads=plan_kv_heads)
    want = decode_mha_append_cat_plain(q, *k2[:2], lens, *k2[2:], k_new=kn, v_new=vn)
    torch.cuda.synchronize()
    err = (got[0] - want[0]).abs().max().item()
    tag = f"decode_mha_append_cat B={B} H={H} cap={cap}"
    if not err <= 1e-3:  # summation order differs
        fail(f"{tag} out: max err {err} > 1e-3")
    for i, name in ((1, "kc"), (2, "vc")):
        if not torch.equal(got[i], want[i]):
            fail(f"{tag} {name}: s8 caches differ")
    for i, name in ((3, "k_scale"), (4, "v_scale")):
        if not torch.allclose(got[i], want[i], rtol=5e-6, atol=0):
            fail(f"{tag} {name}: scales differ")
    del kc, vc, ks, vs, k1, k2, got, want
    layers = [_caches(gen, dev, B, H, cap) for _ in range(12)]
    # Rows attended: lens + 1 (the new row comes from registers, so only
    # lens rows are read back); the new row and its scale are written.
    read = lens.clamp(max=cap - 1).long().sum().item()
    per_call_bytes = (4 * B * H * D * 2 + 4 * B * H * D * 2 + 4 * B
                      + 2 * read * H * (D + 4) + 2 * B * H * (D + 4))
    k_ms = timed(lambda: [decode_mha_append_cat(q, c[0], c[1], lens, c[2], c[3], k_new=kn, v_new=vn,
                                                 plan_kv_heads=plan_kv_heads)
                          for c in layers], iters=10, nbytes=12 * per_call_bytes)
    p_ms = timed(lambda: [decode_mha_append_cat_plain(q, c[0], c[1], lens, c[2], c[3], k_new=kn, v_new=vn)
                          for c in layers], iters=3, warmup=1, nbytes=12 * per_call_bytes)
    sd = [_sdpa_inputs(q, *c, lens, 1) for c in layers]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = timed(lambda: [sdpa(q, kf, vf, attn_mask=m) for kf, vf, m in sd], iters=10,
                nbytes=12 * sdpa_bytes(q, read + B, H, D, 4))
    per_call_ops = 4.0 * (read + B) * H * D
    bms, by = bound_ms(12 * per_call_bytes, 12 * per_call_ops, attn_peak("s8"))
    splits = split_plan(B, plan_kv_heads or H, cap)
    print(f"  {tag} x12 (lens {lo}-{hi - 1} and the edges; splits {splits[0]} of {splits[1]} "
          f"columns): max err {err:.2e}, caches equal; kernel {fmt(k_ms)}, plain {fmt(p_ms)}, "
          f"sdpa {fmt(lib)}, bound {bms:.4f} ms ({by})", flush=True)
    return {"unit": unit, "splits": splits[0], "max_abs_err": err,
            **time_keys(k_ms, p_ms, lib), "bound_ms": bms, "bound_by": by}


def phase_decode_attention(gen, dev):
    """Row 2 at the serve phases' shape (slots 120, cap 256, mid-decode
    lengths 128-191) and at the hard config's (96 slots over cap 1024, the
    lengths a wave of 128-token prompts reaches over 384 new tokens)."""
    head = _decode_append_case(gen, dev, SLOTS, CAP, 128, 192,
                               "one decode step at slots 120, cap 256: 12 calls (one per layer)")
    hard = _decode_append_case(gen, dev, HARD_SLOTS, HARD_CAP, PROMPT, PROMPT + HARD_NEW + 1,
                               f"one decode step of the hard config at slots {HARD_SLOTS}, cap "
                               f"{HARD_CAP}, lens {PROMPT}-{PROMPT + HARD_NEW}: 12 calls")
    torch.cuda.empty_cache()
    return {**head,
        "name": "decode_mha_append_cat", "route": "cuda", "kv": "s8",
        "source": "rten_tpu_torch/csrc/decode_append.cu",
        "replaces": "rten_tpu/kernels/flash_attention.py:2597",
        "max_abs_err": max(head["max_abs_err"], hard["max_abs_err"]),
        "library_call": "scaled_dot_product_attention on pre-dequantized f32 K/V (no quantize, no append)",
        "other_shapes": [hard],
    }


def _prefill_cat_case(gen, dev, B, cap, unit, heads=H):
    """prefill_mha_cat over an admission of B x 128 tokens on cap-row cat
    caches: at lens 0 and at random offsets (lens + 128 <= cap) against
    its plain version (within 1e-3), then timed at lens 0 (one call, x12
    for the admission's layers). ``heads``: a tensor-parallel rank's share
    of GPT-2's 12."""
    H, E = heads, heads * D  # noqa: N806 (the globals: the unsharded counts)
    from rten_tpu_torch.kernels.flash_attention import prefill_mha_cat, prefill_mha_cat_plain

    # q as the op hands it over: a head-major view of a [B, S, 3E] qkv.
    qkv = torch.randn(B, PROMPT, 3 * E, generator=gen).to(dev)
    q = qkv[..., :E].reshape(B, PROMPT, H, D).permute(0, 2, 1, 3)
    lens = torch.zeros(B, dtype=torch.int32, device=dev)
    kc, vc, ks, vs = _caches(gen, dev, B, H, cap)
    tag = f"prefill_mha_cat B={B} H={H} cap={cap}"
    err = (prefill_mha_cat(q, kc, vc, lens, ks, vs)
           - prefill_mha_cat_plain(q, kc, vc, lens, ks, vs)).abs().max().item()
    if not err <= 1e-3:
        fail(f"{tag}: max err {err} > 1e-3")
    # Also a chunk at nonzero offsets (lens + S <= cap).
    lens2 = torch.randint(0, cap - PROMPT, (B,), generator=gen, dtype=torch.int32).to(dev)
    err2 = (prefill_mha_cat(q, kc, vc, lens2, ks, vs)
            - prefill_mha_cat_plain(q, kc, vc, lens2, ks, vs)).abs().max().item()
    if not err2 <= 1e-3:
        fail(f"{tag} (offsets): max err {err2} > 1e-3")
    pairs = B * H * PROMPT * (PROMPT + 1) / 2  # causal (row, column) pairs
    nbytes = 4 * B * H * PROMPT * D * 2 + 2 * B * PROMPT * H * (D + 4) + 4 * B
    k_ms = timed(lambda: prefill_mha_cat(q, kc, vc, lens, ks, vs), iters=10, nbytes=nbytes)
    p_ms = timed(lambda: prefill_mha_cat_plain(q, kc, vc, lens, ks, vs), iters=3, warmup=1,
                 nbytes=nbytes)
    kf, vf, m = _sdpa_inputs(q, kc, vc, ks, vs, lens, PROMPT)
    lib = timed(lambda: torch.nn.functional.scaled_dot_product_attention(q, kf, vf, attn_mask=m),
                iters=10, nbytes=sdpa_bytes(q, B * PROMPT, H, D, 4))
    bms, by = bound_ms(12 * nbytes, 12 * 4.0 * pairs * D, attn_peak("s8"))
    print(f"  {tag} x12: max err {max(err, err2):.2e} (lens 0 and offsets); kernel "
          f"{fmt(k_ms, 12)}, plain {fmt(p_ms, 12)}, sdpa {fmt(lib, 12)}, bound {bms:.4f} ms "
          f"({by})", flush=True)
    return {"unit": unit, "max_abs_err": max(err, err2), **time_keys(k_ms, p_ms, lib, 12),
            "bound_ms": bms, "bound_by": by}


def phase_prefill_attention(gen, dev):
    """Row 3 at the serve phases' admission (120 x 128 over cap 256) and at
    the hard config's (96 x 128 over cap 1024)."""
    head = _prefill_cat_case(gen, dev, SLOTS, CAP,
                             "one admission of 120 x 128 tokens: 12 calls (one per layer)")
    hard = _prefill_cat_case(gen, dev, HARD_SLOTS, HARD_CAP,
                             f"one admission of the hard config, {HARD_SLOTS} x {PROMPT} tokens "
                             f"over cap {HARD_CAP}: 12 calls")
    torch.cuda.empty_cache()
    return {**head,
        "name": "prefill_mha_cat", "route": "cuda", "kv": "s8",
        "counter": "prefill_mha_cat_tensor_core",
        "source": "rten_tpu_torch/csrc/decode_heads_tc.cuh (decode_mha.cu's per-head form on "
                  "the cat caches' head-major views)",
        "replaces": "rten_tpu/kernels/flash_attention.py:3301",
        "max_abs_err": max(head["max_abs_err"], hard["max_abs_err"]),
        "library_call": "scaled_dot_product_attention on pre-dequantized f32 K/V with a mask",
        "other_shapes": [hard],
    }


# TinyLlama-1.1B's published shape (rten_tpu_torch.models.llama defaults)
# and the Llama serve phase's slots.
L_LAYERS, L_H, L_HKV, L_D, L_VOCAB, L_SLOTS = 22, 32, 4, 64, 32000, 16
# The depth of the TinyLlama serve phases (flat, paged, bf16, int4), cut to
# keep the whole run near half its time limit (8 until the hard config's
# phases came in, 4 until the loading phases did); the kernel phases keep
# all 22 layers.
L_CUT_LAYERS = 2


def _head_major_caches(gen, dev, B, quant):
    shape = (B, L_HKV, CAP, L_D)
    if quant:
        k = torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8).to(dev)
        v = torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8).to(dev)
        ks = (torch.rand(B, L_HKV, CAP, generator=gen) * 0.015 + 0.005).to(dev)
        vs = (torch.rand(B, L_HKV, CAP, generator=gen) * 0.015 + 0.005).to(dev)
        return k, v, ks, vs
    return torch.randn(shape, generator=gen).to(dev), torch.randn(shape, generator=gen).to(dev), \
        None, None


def _mask(lens, S, window=0):
    """[B, 1, S, cap] columns row s of slot b attends."""
    j = torch.arange(CAP, device=lens.device)
    qpos = lens.long()[:, None, None, None] + torch.arange(S, device=lens.device)[None, None, :, None]
    m = j <= qpos
    if window:
        m &= j > qpos - window
    return m


def phase_decode_mha(gen, dev):
    """decode_mha at TinyLlama's attention shape (H 32 over Hkv 4, D 64)
    on head-major caches at slots 16, cap 256: the fold at S 1 (a decode
    step) and the per-head form at S 128 (an admission), s8 and f32
    caches, and a window. Each against decode_mha_plain on the same
    inputs, within 1e-4 (f32 accumulation on both sides, other summation
    order). A row with no column to attend (a window wholly past cap)
    gives 0 from the kernel, as on the TPU, and the mean of V from the
    plain version; such rows are checked apart. The fold runs split over
    blocks, on tensor cores for s8 caches and on CUDA cores for f32 caches
    (fold_form); the per-head form on tensor cores for both, f32 in 3xTF32
    (heads_plan). Then times over 22 layers' s8 and f32 caches, and the
    wide per-head kernel (D 129-512) at D 256 and 512."""
    from rten_tpu_torch.kernels.flash_attention import (
        decode_mha, decode_mha_folded, decode_mha_heads, decode_mha_plain,
    )

    B, tol = L_SLOTS, 1e-4
    edges = torch.tensor([0, CAP - 1, CAP + 5], dtype=torch.int32)
    lens_by_S = {
        # Mid-decode lengths, plus an empty cache, the last row and past cap.
        1: torch.cat([edges, torch.randint(128, 192, (B - 3,), generator=gen,
                                            dtype=torch.int32)]).to(dev),
        # An admission chunk at offsets that keep it inside the cache, plus
        # the same edges (rows past cap attend every column).
        PROMPT: torch.cat([edges, torch.randint(0, CAP - PROMPT + 1, (B - 3,), generator=gen,
                                                 dtype=torch.int32)]).to(dev),
    }
    forms = {1: decode_mha_folded, PROMPT: decode_mha_heads}
    errs = {1: 0.0, PROMPT: 0.0, "f32 heads": 0.0, "f32 fold": 0.0}
    for S, quant, window in ((1, True, 0), (1, False, 0), (1, True, 64),
                             (PROMPT, True, 0), (PROMPT, False, 0), (PROMPT, True, 64)):
        q = torch.randn(B, L_H, S, L_D, generator=gen).to(dev)
        k, v, ks, vs = _head_major_caches(gen, dev, B, quant)
        lens = lens_by_S[S]
        before = {s: f.launches for s, f in forms.items()}
        core = (decode_mha_heads.wide_launches, decode_mha_heads.tf32_launches,
                decode_mha_folded.cuda_core_launches)
        got = decode_mha(q, k, v, lens, ks, vs, window=window)
        want = decode_mha_plain(q, k, v, lens, ks, vs, window=window)
        torch.cuda.synchronize()
        if {s: f.launches - before[s] for s, f in forms.items()} != \
                {s: int(s == S) for s in forms} or \
                (decode_mha_heads.wide_launches - core[0],
                 decode_mha_heads.tf32_launches - core[1],
                 decode_mha_folded.cuda_core_launches - core[2]) != \
                (0, int(S > 1 and not quant), int(S == 1 and not quant)):
            fail(f"decode_mha S={S}: routed to the wrong form")
        live = _mask(lens, S, window).any(-1, keepdim=True).expand(B, L_H, S, L_D)
        err = (got - want)[live].abs().max().item()
        tag = f"decode_mha S={S} {'s8' if quant else 'f32'} window={window}"
        if not err <= tol or not (got[~live] == 0).all() or not torch.isfinite(got).all():
            fail(f"{tag}: max err {err} > {tol}, or a row with no column is not 0")
        print(f"  {tag}: max abs err {err:.3e} (bound {tol})", flush=True)
        key = S if quant else "f32 heads" if S > 1 else "f32 fold"
        errs[key] = max(errs[key], err)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for S, name, line in ((1, "decode_mha_folded", 772), (PROMPT, "decode_mha_heads", 935)):
        lens, fn = lens_by_S[S], forms[S]
        q = torch.randn(B, L_H, S, L_D, generator=gen).to(dev)
        m = _mask(lens, S)
        # This run's work: every (row, column) pair the mask admits, and
        # each live K/V row (s8 plus its scale, or f32) read once.
        pairs = m.sum().item()
        kv_rows = (lens.long() + S).clamp(max=CAP).sum().item()
        bounds, nbytes = {}, {}
        for kv, row_bytes in (("s8", L_D + 4), ("f32", 4 * L_D)):
            nbytes[kv] = L_LAYERS * (2 * 4 * B * L_H * S * L_D + 4 * B
                                     + 2 * kv_rows * L_HKV * row_bytes)
            bounds[kv] = bound_ms(nbytes[kv], L_LAYERS * 4.0 * pairs * L_H * L_D,
                                  attn_peak(kv))
        cuda_core_bound = bound_ms(nbytes["f32"], L_LAYERS * 4.0 * pairs * L_H * L_D,
                                   F32_FLOPS_PER_S)
        times = {}
        for quant in (True, False):
            layers = [_head_major_caches(gen, dev, B, quant) for _ in range(L_LAYERS)]
            nb = nbytes["s8" if quant else "f32"]
            k_ms = timed(lambda: [fn(q, *c[:2], lens, *c[2:]) for c in layers], iters=10,
                         nbytes=nb)
            p_ms = timed(lambda: [decode_mha_plain(q, *c[:2], lens, *c[2:]) for c in layers],
                         iters=3, warmup=1, nbytes=nb)
            deq = [(c[0].float() * c[2][..., None], c[1].float() * c[3][..., None]) if quant
                   else c[:2] for c in layers]
            lib = timed(lambda: [sdpa(q, kf, vf, attn_mask=m, enable_gqa=True)
                                 for kf, vf in deq], iters=10,
                        nbytes=L_LAYERS * sdpa_bytes(q, kv_rows, L_HKV, L_D, 4))
            times[quant] = (k_ms, p_ms, lib)
            del layers, deq
        unit = (f"one TinyLlama {'decode step' if S == 1 else 'admission'} at slots {B}, cap "
                f"{CAP}{'' if S == 1 else f', {S} tokens'}: {L_LAYERS} calls (one per layer)")
        for quant, kv in ((True, "s8"), (False, "f32")):
            (bms, by), (k_ms, p_ms, lib) = bounds[kv], times[quant]
            label = name + ("" if quant else " [f32 caches]")
            print(f"  {label} x{L_LAYERS}: kernel {fmt(k_ms)}, plain {fmt(p_ms)}, sdpa {fmt(lib)}, "
                  f"bound {bms:.4f} ms ({by})", flush=True)
        (bms, by), (k_ms, p_ms, lib) = bounds["s8"], times[True]
        (fbms, fby), (fk_ms, fp_ms, flib) = bounds["f32"], times[False]
        rows.append({
            "name": name, "route": "cuda", "kv": "s8",
            "counter": f"{name}_tensor_core",
            "source": ("rten_tpu_torch/csrc/decode_fold_tc.cuh" if S == 1
                       else "rten_tpu_torch/csrc/decode_heads_tc.cuh"),
            "replaces": f"rten_tpu/kernels/flash_attention.py:{line}",
            "unit": unit + ", s8 caches",
            "max_abs_err": errs[S], **time_keys(k_ms, p_ms, lib), "bound_ms": bms,
            "bound_by": by,
            "library_call": "scaled_dot_product_attention(enable_gqa=True) on "
                            "pre-dequantized f32 K/V with the same mask",
        })
        # f32 caches: the CUDA-core fold (split), the 3xTF32 per-head kernel;
        # rows of their own, their launches those of their kernels.
        rows.append({
            "name": f"{name}[f32]", "route": "cuda", "kv": None,
            "counter": "decode_mha_folded_cuda_core" if S == 1 else "decode_mha_heads_tf32",
            "source": ("rten_tpu_torch/csrc/decode_fold.cuh" if S == 1
                       else "rten_tpu_torch/csrc/decode_heads_tf32.cuh"),
            "replaces": f"rten_tpu/kernels/flash_attention.py:{line}",
            "unit": unit + ", f32 caches",
            "max_abs_err": errs["f32 fold" if S == 1 else "f32 heads"],
            **time_keys(fk_ms, fp_ms, flib), "bound_ms": fbms, "bound_by": fby,
            "library_call": "scaled_dot_product_attention(enable_gqa=True) on the f32 K/V "
                            "with the same mask",
        })
        if S > 1:
            rows[-1]["bound_ms_f32_cuda_cores"] = cuda_core_bound[0]
    rows.append(_heads_wide_case(gen, dev))
    return rows


WIDE_CASES = (("f32", 256), ("s8", 256), ("int4", 256), ("bf16", 256), ("f32", 512))


def _heads_wide_case(gen, dev, calls=8):
    """The wide per-head kernel (csrc/decode_heads_wide.cuh, D 129-512) at
    an admission of 16 x 128 tokens, H 8 over 1 KV head (Gemma's head dim
    256), cap 256, for every cache kind at D 256 and f32 at D 512: each
    against decode_mha_plain within 1e-4, the same bits twice, counted by
    ``wide_launches``; then the times of ``calls`` calls (one per layer's
    caches), the plain version's and SDPA's (on the f32 values of the K/V,
    dequantized, with the same mask; for bf16 caches also on the bf16 K/V
    with a bf16 q), beside the bound (at the bf16 tensor-core peak for s8,
    int4 and bf16 caches, the TF32 one for f32). The row's numbers are the
    f32 D 256 case's (PERF.md's unit); the others are in ``other_shapes``."""
    from rten_tpu_torch.kernels.flash_attention import decode_mha_heads, decode_mha_plain

    B, Hq, Hkv = L_SLOTS, 8, 1
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lens = torch.randint(0, CAP - PROMPT + 1, (B,), generator=gen, dtype=torch.int32).to(dev)
    m = _mask(lens, PROMPT)
    pairs = m.sum().item() * Hq
    kv_rows = (lens.long() + PROMPT).clamp(max=CAP).sum().item()
    cases = {}
    for kv, Dh in WIDE_CASES:
        q = torch.randn(B, Hq, PROMPT, Dh, generator=gen).to(dev)
        layers = [_quant_head_major(gen, dev, kv, B, Hkv, Dh) for _ in range(calls)]
        wide = decode_mha_heads.wide_launches
        got, again = (decode_mha_heads(q, *layers[0][:2], lens, *layers[0][2:]) for _ in range(2))
        want = decode_mha_plain(q, *layers[0][:2], lens, *layers[0][2:])
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if (decode_mha_heads.wide_launches != wide + 2 or not err <= 1e-4
                or not torch.equal(got, again)):
            fail(f"decode_mha_heads [wide, {kv}, D {Dh}]: wrong kernel, max err {err} > 1e-4, "
                 f"or two calls differ")
        del got, again, want
        nbytes = 2 * 4 * B * Hq * PROMPT * Dh + 4 * B + 2 * kv_rows * Hkv * _row_bytes(kv, Dh)
        k_ms = timed(lambda: [decode_mha_heads(q, c[0], c[1], lens, c[2], c[3]) for c in layers],
                     iters=5, nbytes=calls * nbytes)
        p_ms = timed(lambda: [decode_mha_plain(q, c[0], c[1], lens, c[2], c[3]) for c in layers],
                     iters=2, warmup=1, nbytes=calls * nbytes)
        deq = [_dequant(*c) for c in layers]
        lib = timed(lambda: [sdpa(q, kf, vf, attn_mask=m, enable_gqa=True) for kf, vf in deq],
                    iters=5, nbytes=calls * sdpa_bytes(q, kv_rows, Hkv, Dh, 4))
        del deq
        bms, by = bound_ms(calls * nbytes, calls * 4.0 * pairs * Dh, attn_peak(kv))
        case = {"unit": (f"an admission at slots {B}, cap {CAP}, {PROMPT} tokens, H {Hq} over "
                         f"{Hkv}, D {Dh}, {kv} caches: {calls} calls"),
                "max_abs_err": err, **time_keys(k_ms, p_ms, lib), "bound_ms": bms,
                "bound_by": by,
                "library_call": "scaled_dot_product_attention(enable_gqa=True) on the f32 "
                                "values of the K/V with the same mask"}
        note = ""
        if kv == "bf16":
            qb = q.to(torch.bfloat16)
            lb = timed(lambda: [sdpa(qb, c[0], c[1], attn_mask=m, enable_gqa=True)
                                for c in layers],
                       iters=5, nbytes=calls * sdpa_bytes(qb, kv_rows, Hkv, Dh, 2))
            case["library_bf16_ms"] = ms_of(lb)
            note = f", sdpa on the bf16 K/V (bf16 q) {fmt(lb)}"
        print(f"  decode_mha_heads [wide, {kv}, D {Dh}] x{calls}: max abs err {err:.3e} (bound "
              f"1e-4), two calls bit-identical; kernel {fmt(k_ms)}, plain {fmt(p_ms)}, sdpa "
              f"{fmt(lib)}{note}, bound {bms:.4f} ms ({by})", flush=True)
        cases[f"{kv} D {Dh}"] = case
        del layers, q
        torch.cuda.empty_cache()
    head = cases.pop("f32 D 256")
    return {"name": "decode_mha_heads[wide]", "route": "cuda", "kv": None,
            "counter": "decode_mha_heads_wide",
            "source": "rten_tpu_torch/csrc/decode_heads_wide.cuh",
            "replaces": "rten_tpu/kernels/flash_attention.py:935", **head,
            "max_abs_err": max([head["max_abs_err"]] + [c["max_abs_err"] for c in cases.values()]),
            "other_shapes": cases}


def _d256_modes(gen, dev, calls=8):
    """Two CUDA-core modes of redesigned rows that PERF.md's table lacked,
    timed (not changed) beside SDPA at Gemma's head dim 256, H 8 over 1 KV
    head: mha (row 5, ``mha_form`` "cuda_core") at a causal prefill of T
    1024, B 1, f32; and the split fold (row 6a, ``fold_form`` "cuda_core")
    at a decode step of 16 slots, cap 256, lens in [128, 192), on s8 and
    bf16 caches. Each against its plain version within 1e-4 on its CUDA-core
    counter, then ``calls`` calls (one per layer) of the kernel, the plain
    version and SDPA (causal; the fold's on the dequantized f32 K/V, or the
    bf16 K/V with a bf16 q, with the same mask), beside the bound (TF32 or
    bf16 tensor-core peak, the f32 rate's in ``bound_ms_f32_cuda_cores``).
    Returns {row name: {case: its numbers}}."""
    from rten_tpu_torch.kernels.flash_attention import (
        decode_mha_folded, decode_mha_plain, fold_form, mha, mha_form, mha_plain,
    )

    sdpa = torch.nn.functional.scaled_dot_product_attention
    Dh, Hq, Hkv, T, B = 256, 8, 1, 1024, L_SLOTS
    out = {"mha": {}, "decode_mha_folded": {}}
    q = torch.randn(1, Hq, T, Dh, generator=gen).to(dev)
    layers = [tuple(torch.randn(1, Hkv, T, Dh, generator=gen).to(dev) for _ in "kv")
              for _ in range(calls)]
    cc = mha.cuda_core_launches
    got = mha(q, *layers[0], causal=True)
    want = mha_plain(q, *layers[0], causal=True)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if mha_form(Dh) != "cuda_core" or mha.cuda_core_launches != cc + 1 or not err <= 1e-4:
        fail(f"mha at D {Dh}: not on its CUDA-core kernel, or max err {err} > 1e-4")
    nbytes = 4 * (2 * Hq * T * Dh + 2 * Hkv * T * Dh)
    ops = 4.0 * Hq * T * (T + 1) / 2 * Dh
    k_ms = timed(lambda: [mha(q, k, v, causal=True) for k, v in layers], iters=5,
                 nbytes=calls * nbytes)
    p_ms = timed(lambda: [mha_plain(q, k, v, causal=True) for k, v in layers], iters=2, warmup=1,
                 nbytes=calls * nbytes)
    lib = timed(lambda: [sdpa(q, k, v, is_causal=True, enable_gqa=True) for k, v in layers],
                iters=5, nbytes=calls * nbytes)
    bms, by = bound_ms(calls * nbytes, calls * ops, TF32_FLOPS_PER_S)
    cc_bms = bound_ms(calls * nbytes, calls * ops, F32_FLOPS_PER_S)[0]
    out["mha"]["f32, B 1, T 1024, causal"] = {
        "unit": f"a causal prefill, B 1, T {T}, H {Hq} over {Hkv}, D {Dh}, f32: {calls} calls",
        "max_abs_err": err, **time_keys(k_ms, p_ms, lib), "bound_ms": bms, "bound_by": by,
        "bound_ms_f32_cuda_cores": cc_bms,
        "library_call": "scaled_dot_product_attention(is_causal=True, enable_gqa=True)"}
    print(f"  mha [cuda_core, D {Dh}, T {T}, f32] x{calls}: max abs err {err:.3e}; kernel "
          f"{fmt(k_ms)}, plain {fmt(p_ms)}, sdpa {fmt(lib)}, bound {bms:.4f} ms ({by}) [f32 "
          f"rate: {cc_bms:.4f}]", flush=True)
    del layers, q
    lens = torch.randint(128, 192, (B,), generator=gen, dtype=torch.int32).to(dev)
    m = _mask(lens, 1)
    kv_rows = (lens.long() + 1).sum().item()
    for kv in ("s8", "bf16"):
        q = torch.randn(B, Hq, 1, Dh, generator=gen).to(dev)
        layers = [_quant_head_major(gen, dev, kv, B, Hkv, Dh) for _ in range(calls)]
        cc = decode_mha_folded.cuda_core_launches
        got = decode_mha_folded(q, *layers[0][:2], lens, *layers[0][2:])
        want = decode_mha_plain(q, *layers[0][:2], lens, *layers[0][2:])
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if (fold_form(layers[0][0].dtype, Dh) != "cuda_core"
                or decode_mha_folded.cuda_core_launches != cc + 1 or not err <= 1e-4):
            fail(f"decode_mha_folded [{kv}, D {Dh}]: not on its CUDA-core kernel, or max err "
                 f"{err} > 1e-4")
        nbytes = 2 * 4 * B * Hq * Dh + 4 * B + 2 * kv_rows * Hkv * _row_bytes(kv, Dh)
        ops = 4.0 * kv_rows * Hq * Dh
        k_ms = timed(lambda: [decode_mha_folded(q, c[0], c[1], lens, c[2], c[3]) for c in layers],
                     iters=10, nbytes=calls * nbytes)
        p_ms = timed(lambda: [decode_mha_plain(q, c[0], c[1], lens, c[2], c[3]) for c in layers],
                     iters=3, warmup=1, nbytes=calls * nbytes)
        if kv == "bf16":
            qb = q.to(torch.bfloat16)
            lib = timed(lambda: [sdpa(qb, c[0], c[1], attn_mask=m, enable_gqa=True)
                                 for c in layers],
                        iters=10, nbytes=calls * sdpa_bytes(qb, kv_rows, Hkv, Dh, 2))
            call = "scaled_dot_product_attention(enable_gqa=True) on the bf16 K/V, a bf16 q"
        else:
            deq = [_dequant(*c) for c in layers]
            lib = timed(lambda: [sdpa(q, kf, vf, attn_mask=m, enable_gqa=True) for kf, vf in deq],
                        iters=10, nbytes=calls * sdpa_bytes(q, kv_rows, Hkv, Dh, 4))
            call = "scaled_dot_product_attention(enable_gqa=True) on the dequantized f32 K/V"
            del deq
        bms, by = bound_ms(calls * nbytes, calls * ops, attn_peak(kv))
        cc_bms = bound_ms(calls * nbytes, calls * ops, F32_FLOPS_PER_S)[0]
        out["decode_mha_folded"][f"{kv}, slots {B}, step"] = {
            "unit": (f"a decode step at slots {B}, cap {CAP}, H {Hq} over {Hkv}, D {Dh}, {kv} "
                     f"caches: {calls} calls"),
            "max_abs_err": err, **time_keys(k_ms, p_ms, lib), "bound_ms": bms, "bound_by": by,
            "bound_ms_f32_cuda_cores": cc_bms, "library_call": call + ", the same mask"}
        print(f"  decode_mha_folded [cuda_core, {kv}, D {Dh}, step] x{calls}: max abs err "
              f"{err:.3e}; kernel {fmt(k_ms)}, plain {fmt(p_ms)}, sdpa {fmt(lib)}, bound "
              f"{bms:.4f} ms ({by})", flush=True)
        del layers
    torch.cuda.empty_cache()
    return out


# Paged pools: blocks of 64 rows, cap 256 (4 table entries a slot).
BLOCK = 64
MAXB = CAP // BLOCK


def _shuffled_table(gen, dev, B, owners):
    """[B, MAXB] int32: slots < owners hold shuffled distinct blocks of a
    pool of 1 + owners * MAXB; the others are idle (rows of 0, the garbage
    sink)."""
    bt = torch.zeros(B, MAXB, dtype=torch.int32)
    bt[:owners] = (torch.randperm(owners * MAXB, generator=gen) + 1).reshape(owners, MAXB)
    return bt.to(dev)


def _pools(gen, dev, NB, Hkv, kv, cat=False, Dh=L_D):
    """K and V pools of NB blocks (cat rows or head-major) and, for s8, their
    scale pools (None otherwise); ``kv`` "s8", "f32" or "bf16"."""
    shape = (NB, BLOCK, Hkv * Dh) if cat else (NB, Hkv, BLOCK, Dh)
    if kv != "s8":
        return (*_float_kv(gen, dev, shape, kv), None, None)
    return (torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8).to(dev),
            torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8).to(dev),
            (torch.rand(NB, Hkv, 1, BLOCK, generator=gen) * 0.015 + 0.005).to(dev),
            (torch.rand(NB, Hkv, 1, BLOCK, generator=gen) * 0.015 + 0.005).to(dev))


def _deq(k, v, ks, vs):
    """Gathered K/V as SDPA's yardstick takes them: s8 dequantized to f32,
    f32/bf16 as they are."""
    if ks is None:
        return k, v
    return k.float() * ks[..., None], v.float() * vs[..., None]


def phase_paged_decode_mha(gen, dev, kv="s8"):
    """paged_decode_mha at TinyLlama's attention shape (slots 16, H 32 over
    4 KV heads, D 64) on pools of 1 + 64 blocks of 64 rows through a
    shuffled table: lens 128-191 plus 0, 63, 64, 255 and 261; ``kv`` pools
    (s8: also f32 pools) and a window of 64. Against its plain version
    (gather, then decode_mha_plain) within 1e-4, and the same bits on a
    second call. Then times over 22 layers' ``kv`` pools beside the bound
    (live bytes / 3.35 TB/s), with two yardsticks on the gathered
    contiguous caches: the flat fold decode_mha_folded and SDPA
    (enable_gqa) on the dequantized (s8) or cache-dtype K/V."""
    from rten_tpu_torch.kernels.flash_attention import (
        decode_mha_folded, paged_decode_mha, paged_decode_mha_plain, paged_gather_kv,
        paged_gather_scales,
    )

    B, tol = L_SLOTS, 1e-4
    NB = 1 + B * MAXB
    lens = torch.cat([torch.tensor([0, 63, 64, CAP - 1, CAP + 5], dtype=torch.int32),
                      torch.randint(128, 192, (B - 5,), generator=gen, dtype=torch.int32)]).to(dev)
    bt = _shuffled_table(gen, dev, B, B)
    err = 0.0
    checks = ((kv, 0), ("f32", 0), (kv, 64)) if kv == "s8" else ((kv, 0), (kv, 64))
    for ckv, window in checks:
        q = torch.randn(B, L_H, 1, L_D, generator=gen).to(dev)
        pk, pv, ks, vs = _pools(gen, dev, NB, L_HKV, ckv)
        got = paged_decode_mha(q, pk, pv, lens, bt, ks, vs, window=window)
        again = paged_decode_mha(q, pk, pv, lens, bt, ks, vs, window=window)
        want = paged_decode_mha_plain(q, pk, pv, lens, bt, ks, vs, window=window)
        torch.cuda.synchronize()
        e = (got - want).abs().max().item()
        tag = f"paged_decode_mha {ckv} window={window}"
        if not e <= tol or not torch.equal(got, again):
            fail(f"{tag}: max err {e} > {tol}, or two calls differ")
        print(f"  {tag}: max abs err {e:.3e} (bound {tol}), two calls bit-identical", flush=True)
        err = max(err, e)

    q = torch.randn(B, L_H, 1, L_D, generator=gen).to(dev)
    # This run's work: each slot's live rows (columns <= lens, at most cap)
    # read once (s8 plus a scale, or the f32/bf16 row), K and V; q read and
    # out written once.
    rows = (lens.long().clamp(max=CAP - 1) + 1).sum().item()
    row_bytes = L_D + 4 if kv == "s8" else L_D * FLOAT_KV[kv].itemsize
    nbytes = 2 * 4 * B * L_H * L_D + 4 * B + 4 * B * MAXB + 2 * rows * L_HKV * row_bytes
    layers = [_pools(gen, dev, NB, L_HKV, kv) for _ in range(L_LAYERS)]
    k_ms = timed(lambda: [paged_decode_mha(q, c[0], c[1], lens, bt, c[2], c[3]) for c in layers],
                 iters=10, nbytes=L_LAYERS * nbytes)
    p_ms = timed(lambda: [paged_decode_mha_plain(q, c[0], c[1], lens, bt, c[2], c[3])
                          for c in layers], iters=3, warmup=1, nbytes=L_LAYERS * nbytes)
    flat = [(paged_gather_kv(c[0], bt), paged_gather_kv(c[1], bt),
             None if c[2] is None else paged_gather_scales(c[2], bt),
             None if c[3] is None else paged_gather_scales(c[3], bt)) for c in layers]
    f_ms = timed(lambda: [decode_mha_folded(q, *c[:2], lens, *c[2:]) for c in flat], iters=10,
                 nbytes=L_LAYERS * (nbytes - 4 * B * MAXB))
    m = _mask(lens, 1)
    deq = [_deq(*c) for c in flat]
    qd = q if kv == "s8" else q.to(FLOAT_KV[kv])
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = timed(lambda: [sdpa(qd, kf, vf, attn_mask=m, enable_gqa=True) for kf, vf in deq],
                iters=10, nbytes=L_LAYERS * sdpa_bytes(qd, rows, L_HKV, L_D,
                                                       deq[0][0].element_size()))
    del layers, flat, deq
    bms, by = bound_ms(L_LAYERS * nbytes, L_LAYERS * 4.0 * rows * L_H * L_D, attn_peak(kv))
    splits = split_plan(B, L_HKV, CAP)
    print(f"  paged_decode_mha {kv} x{L_LAYERS} (splits {splits[0]} of {splits[1]} columns): "
          f"kernel {fmt(k_ms)}, plain {fmt(p_ms)}, flat fold on gathered caches {fmt(f_ms)}, "
          f"sdpa {fmt(lib)}, bound {bms:.4f} ms ({by})", flush=True)
    return {"splits": splits[0],
        "name": "paged_decode_mha" + ("" if kv == "s8" else f"[{kv}]"), "kv": kv,
        "counter": "paged_decode_mha",
        "source": f"rten_tpu_torch/csrc/paged_decode_mha{'_bf16' * (kv == 'bf16')}.cu",
        "replaces": "rten_tpu/kernels/flash_attention.py:3425",
        "unit": (f"one TinyLlama decode step at slots {B}, cap {CAP}, blocks of {BLOCK}: "
                 f"{L_LAYERS} calls (one per layer), {kv} pools"),
        "max_abs_err": err, **time_keys(k_ms, p_ms, lib), "bound_ms": bms, "bound_by": by,
        "flat_fold_ms": ms_of(f_ms), "flat_fold_wall_ms": f_ms[1],
        "library_call": "scaled_dot_product_attention(enable_gqa=True) on gathered "
                        + ("pre-dequantized f32" if kv == "s8" else f"{kv}")
                        + " K/V with the same mask",
    }


def phase_paged_append(gen, dev, kv="s8"):
    """decode_mha_append_cat through a block table at the GPT-2 headline
    shape: slots 120, cap 256, ``kv`` pools of 1 + 480 blocks of 64 rows, a
    shuffled table for 112 slots and 8 idle slots (rows of 0) whose new
    rows collide in block 0. Against its plain version: output within
    1e-4, pools bit-exact, s8 scale pools rtol 5e-6, and two runs from the
    same inputs bit-identical. Then times over 12 layers' pools."""
    from rten_tpu_torch.kernels.flash_attention import (
        decode_mha_append_cat, decode_mha_append_cat_paged_plain, paged_gather_scales,
    )
    from rten_tpu_torch.ops.attention import paged_gather_cat

    B, owners, NB = SLOTS, SLOTS - 8, 1 + 480
    bt = _shuffled_table(gen, dev, B, owners)
    lens = torch.randint(128, 192, (B,), generator=gen, dtype=torch.int32)
    lens[:6] = torch.tensor([0, 31, 63, 64, CAP - 1, CAP + 5], dtype=torch.int32)
    lens[owners:] = torch.tensor([5, 5, 70, 5, 200, 300, 261, 0], dtype=torch.int32)
    lens = lens.to(dev)
    q = torch.randn(B, H, 1, D, generator=gen).to(dev)
    kn = torch.randn(B, H, 1, D, generator=gen).to(dev)
    vn = torch.randn(B, H, 1, D, generator=gen).to(dev)
    pools = _pools(gen, dev, NB, H, kv, cat=True)
    n = 4 if kv == "s8" else 2  # pools, and s8 scale pools

    def fresh():
        return [t.clone() for t in pools[:n]] + [None] * (4 - n)

    runs = []
    for _ in range(2):
        c = fresh()
        runs.append(decode_mha_append_cat(q, c[0], c[1], lens, c[2], c[3], k_new=kn, v_new=vn,
                                          block_table=bt))
    c = fresh()
    want = decode_mha_append_cat_paged_plain(q, c[0], c[1], lens, c[2], c[3], k_new=kn,
                                             v_new=vn, block_table=bt)
    torch.cuda.synchronize()
    got = runs[0]
    err = (got[0] - want[0]).abs().max().item()
    tag = f"decode_mha_append_cat (block table, {kv})"
    if not err <= 1e-4:
        fail(f"{tag} out: max err {err} > 1e-4")
    if not (torch.equal(_bits(got[1]), _bits(want[1])) and torch.equal(_bits(got[2]), _bits(want[2]))):
        fail(f"{tag}: pools differ from the plain version")
    if kv == "s8" and not all(torch.allclose(got[i], want[i], rtol=5e-6, atol=0) for i in (3, 4)):
        fail(f"{tag}: scale pools differ")
    if not all(torch.equal(_bits(a), _bits(b)) for a, b in zip(runs[0], runs[1])):
        fail(f"{tag}: two runs from the same inputs differ")
    print(f"  {tag}: max abs err {err:.3e} (bound 1e-4), pools bit-exact, two runs "
          f"bit-identical", flush=True)
    del runs, want, c
    # The flat row's count on this run's lens: rows read back (the new row
    # is read too, from the pool), the new rows (and s8 scales) written.
    read = (lens.long().clamp(max=CAP - 1) + 1).sum().item()
    row_bytes = D + 4 if kv == "s8" else D * FLOAT_KV[kv].itemsize
    per_call_bytes = (4 * B * H * D * 2 + 4 * B * H * D * 2 + 4 * B + 4 * B * MAXB
                      + 2 * read * H * row_bytes + 2 * B * H * row_bytes)
    layers = [_pools(gen, dev, NB, H, kv, cat=True) for _ in range(12)]
    k_ms = timed(lambda: [decode_mha_append_cat(q, c[0], c[1], lens, c[2], c[3], k_new=kn,
                                                v_new=vn, block_table=bt) for c in layers],
                 iters=10, nbytes=12 * per_call_bytes)
    p_ms = timed(lambda: [decode_mha_append_cat_paged_plain(q, c[0], c[1], lens, c[2], c[3],
                                                            k_new=kn, v_new=vn, block_table=bt)
                          for c in layers], iters=3, warmup=1, nbytes=12 * per_call_bytes)
    if kv == "s8":
        sd = [_sdpa_inputs(q, paged_gather_cat(c[0], bt), paged_gather_cat(c[1], bt),
                           paged_gather_scales(c[2], bt)[..., None],
                           paged_gather_scales(c[3], bt)[..., None], lens, 1) for c in layers]
        qd = q
    else:
        from rten_tpu_torch.kernels.flash_attention import cat_to_heads

        m = _mask(lens, 1)
        sd = [(cat_to_heads(paged_gather_cat(c[0], bt), H),
               cat_to_heads(paged_gather_cat(c[1], bt), H), m) for c in layers]
        qd = q.to(FLOAT_KV[kv])
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = timed(lambda: [sdpa(qd, kf, vf, attn_mask=m) for kf, vf, m in sd], iters=10,
                nbytes=12 * sdpa_bytes(qd, read, H, D, sd[0][0].element_size()))
    del layers, sd
    bms, by = bound_ms(12 * per_call_bytes, 12 * 4.0 * read * H * D, attn_peak(kv))
    splits = split_plan(B, H, CAP)
    print(f"  {tag} x12 (splits {splits[0]} of {splits[1]} columns): kernel {fmt(k_ms)}, plain "
          f"{fmt(p_ms)}, sdpa {fmt(lib)}, bound {bms:.4f} ms ({by})", flush=True)
    return {"splits": splits[0],
        "name": "decode_mha_append_cat_paged" + ("" if kv == "s8" else f"[{kv}]"), "kv": kv,
        "counter": "decode_mha_append_cat_paged",
        "source": ("rten_tpu_torch/csrc/flash_attention.cu (write) and rten_tpu_torch/csrc/"
                   f"paged_decode_mha{'_bf16' * (kv == 'bf16')}.cu (attend)"),
        "replaces": "rten_tpu/kernels/flash_attention.py:2597",
        "unit": (f"block_table= mode: one GPT-2 decode step at slots {B}, cap {CAP}, {kv} "
                 f"pools of {NB} blocks of {BLOCK}: 12 calls (one per layer), two launches each"),
        "max_abs_err": err, **time_keys(k_ms, p_ms, lib), "bound_ms": bms, "bound_by": by,
        "library_call": "scaled_dot_product_attention on gathered "
                        + ("pre-dequantized f32" if kv == "s8" else kv)
                        + " K/V (no append)",
    }


# --- f32 and bf16 KV caches (no scales) ----------------------------------------

FLOAT_KV = {"bf16": torch.bfloat16, "f32": torch.float32}
# Qwen2.5-1.5B's published shape (Qwen/Qwen2.5-1.5B, config.json): hidden
# 1536, intermediate 8960, 28 layers, 12 query heads over 2 KV heads (D 128,
# group 6), vocab 151936, rope_theta 1e6, rms_norm_eps 1e-6, q/k/v biases,
# tied embeddings, no sliding window; its serve phase's slots.
Q_LAYERS, Q_H, Q_HKV, Q_D, Q_VOCAB, Q_SLOTS = 28, 12, 2, 128, 151936, 16
# The depth of its serve phase, cut to keep the whole run near half its
# time limit (14 until the hard config's phases came in, 8 until the
# loading phases did, 4 until the genai, MoE and registry phases did; at 2
# it shares the Qwen
# reference's weights); its kernel phases keep all 28 layers.
Q_SERVE_LAYERS = 2
QWEN = dict(vocab_size=Q_VOCAB, hidden_size=1536, intermediate_size=8960,
            num_attention_heads=Q_H, num_key_value_heads=Q_HKV,
            max_position_embeddings=131072, rms_norm_eps=1e-6, rope_theta=1e6,
            attention_bias=True, tie_word_embeddings=True)


def _float_kv(gen, dev, shape, dt):
    """Two random f32/bf16 caches or pools (K and V) of ``shape``."""
    return tuple(torch.randn(shape, generator=gen).to(FLOAT_KV[dt]).to(dev) for _ in range(2))


def _bits(t):
    """A tensor's bits, comparable with torch.equal (bf16 as int16)."""
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _append_case(gen, dev, dt, B, Hq, Hkv, Dh, layers, tag):
    """decode_mha_append_cat on f32/bf16 cat caches at one shape: against
    its plain version (out within 1e-4, cache rows bit-exact), the same bits
    on a second call from the same caches; then the times of ``layers``
    calls (one per layer), the plain version's and SDPA's (enable_gqa where
    grouped) on the cache-dtype K/V, beside the bound from this run's lens."""
    from rten_tpu_torch.kernels.flash_attention import (
        cat_to_heads, decode_mha_append_cat, decode_mha_append_cat_plain,
    )

    q = torch.randn(B, Hq, 1, Dh, generator=gen).to(dev)
    kn = torch.randn(B, Hkv, 1, Dh, generator=gen).to(dev)
    vn = torch.randn(B, Hkv, 1, Dh, generator=gen).to(dev)
    lens = torch.randint(128, 192, (B,), generator=gen, dtype=torch.int32)
    lens[:4] = torch.tensor([0, 31, CAP - 1, CAP + 5], dtype=torch.int32)
    lens = lens.to(dev)
    kc, vc = _float_kv(gen, dev, (B, CAP, Hkv * Dh), dt)
    runs = [decode_mha_append_cat(q, kc.clone(), vc.clone(), lens, k_new=kn, v_new=vn)
            for _ in range(2)]
    want = decode_mha_append_cat_plain(q, kc.clone(), vc.clone(), lens, k_new=kn, v_new=vn)
    torch.cuda.synchronize()
    err = (runs[0][0] - want[0]).abs().max().item()
    exact = all(torch.equal(_bits(runs[0][i]), _bits(want[i])) for i in (1, 2))
    same = all(torch.equal(_bits(a), _bits(b)) for a, b in zip(*runs))
    if not err <= 1e-4 or not exact or not same:
        fail(f"decode_mha_append_cat [{tag}]: max err {err} > 1e-4, cache rows bit-exact "
             f"{exact}, two calls bit-identical {same}")
    del runs, want
    # Rows read back: lens (the new row is scored from shared memory); the
    # new rows written; q, k_new, v_new read and out written in f32.
    el = FLOAT_KV[dt].itemsize
    read = lens.clamp(max=CAP - 1).long().sum().item()
    nbytes = (4 * B * Hq * Dh * 2 + 4 * B * Hkv * Dh * 2 + 4 * B
              + 2 * read * Hkv * Dh * el + 2 * B * Hkv * Dh * el)
    layer_kv = [_float_kv(gen, dev, (B, CAP, Hkv * Dh), dt) for _ in range(layers)]
    k_ms = timed(lambda: [decode_mha_append_cat(q, k, v, lens, k_new=kn, v_new=vn)
                          for k, v in layer_kv], iters=10, nbytes=layers * nbytes)
    p_ms = timed(lambda: [decode_mha_append_cat_plain(q, k, v, lens, k_new=kn, v_new=vn)
                          for k, v in layer_kv], iters=3, warmup=1, nbytes=layers * nbytes)
    qd, m = q.to(FLOAT_KV[dt]), _mask(lens, 1)
    sd = [(cat_to_heads(k, Hkv), cat_to_heads(v, Hkv)) for k, v in layer_kv]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = timed(lambda: [sdpa(qd, k, v, attn_mask=m, enable_gqa=Hq != Hkv) for k, v in sd],
                iters=10, nbytes=layers * sdpa_bytes(qd, read, Hkv, Dh, el))
    del layer_kv, sd
    bms, by = bound_ms(layers * nbytes, layers * 4.0 * (read + B) * Hq * Dh, attn_peak(dt))
    splits = split_plan(B, Hkv, CAP)
    print(f"  decode_mha_append_cat [{tag}] x{layers} (splits {splits[0]} of {splits[1]} "
          f"columns): max abs err {err:.3e} (bound 1e-4), rows bit-exact, two calls "
          f"bit-identical; kernel {fmt(k_ms)}, plain {fmt(p_ms)}, sdpa {fmt(lib)}, bound "
          f"{bms:.4f} ms ({by})", flush=True)
    return {"unit": f"{tag}: {layers} calls (one per layer)", "max_abs_err": err,
            "splits": splits[0],
            **time_keys(k_ms, p_ms, lib), "bound_ms": bms, "bound_by": by}


def _prefill_case(gen, dev, dt, B, Hq, Hkv, Dh, layers, tag):
    """prefill_mha_cat on f32/bf16 cat caches for an admission of B x 128
    tokens (q a head-major view of a [B, 128, (Hq + 2 Hkv) * D] qkv, as the
    op hands it over): against its plain version within 1e-4 from empty
    slots and at offsets, the same bits on a second call; then the times
    of ``layers`` calls, the plain version's and SDPA's with the same mask."""
    from rten_tpu_torch.kernels.flash_attention import (
        cat_to_heads, prefill_mha_cat, prefill_mha_cat_plain,
    )

    qkv = torch.randn(B, PROMPT, (Hq + 2 * Hkv) * Dh, generator=gen).to(dev)
    q = qkv[..., :Hq * Dh].reshape(B, PROMPT, Hq, Dh).permute(0, 2, 1, 3)
    kc, vc = _float_kv(gen, dev, (B, CAP, Hkv * Dh), dt)
    lens = torch.zeros(B, dtype=torch.int32, device=dev)
    lens2 = torch.randint(0, CAP - PROMPT, (B,), generator=gen, dtype=torch.int32).to(dev)
    err = 0.0
    for ln in (lens, lens2):
        got = prefill_mha_cat(q, kc, vc, ln)
        again = prefill_mha_cat(q, kc, vc, ln)
        want = prefill_mha_cat_plain(q, kc, vc, ln)
        torch.cuda.synchronize()
        e = (got - want).abs().max().item()
        if not e <= 1e-4 or not torch.equal(got, again):
            fail(f"prefill_mha_cat [{tag}]: max err {e} > 1e-4, or two calls differ")
        err = max(err, e)
    del got, again, want
    pairs = B * Hq * PROMPT * (PROMPT + 1) / 2  # causal (row, column) pairs from empty slots
    nbytes = 4 * B * Hq * PROMPT * Dh * 2 + 2 * B * PROMPT * Hkv * Dh * FLOAT_KV[dt].itemsize + 4 * B
    layer_kv = [_float_kv(gen, dev, (B, CAP, Hkv * Dh), dt) for _ in range(layers)]
    k_ms = timed(lambda: [prefill_mha_cat(q, k, v, lens) for k, v in layer_kv], iters=5,
                 nbytes=layers * nbytes)
    p_ms = timed(lambda: [prefill_mha_cat_plain(q, k, v, lens) for k, v in layer_kv],
                 iters=2, warmup=1, nbytes=layers * nbytes)
    qd, m = q.to(FLOAT_KV[dt]), _mask(lens, PROMPT)
    sd = [(cat_to_heads(k, Hkv), cat_to_heads(v, Hkv)) for k, v in layer_kv]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = timed(lambda: [sdpa(qd, k, v, attn_mask=m, enable_gqa=Hq != Hkv) for k, v in sd],
                iters=5, nbytes=layers * sdpa_bytes(qd, B * PROMPT, Hkv, Dh,
                                                    FLOAT_KV[dt].itemsize))
    del layer_kv, sd
    bms, by = bound_ms(layers * nbytes, layers * 4.0 * pairs * Dh, attn_peak(dt))
    print(f"  prefill_mha_cat [{tag}] x{layers}: max abs err {err:.3e} (bound 1e-4), two calls "
          f"bit-identical; kernel {fmt(k_ms)}, plain {fmt(p_ms)}, sdpa {fmt(lib)}, "
          f"bound {bms:.4f} ms ({by})", flush=True)
    return {"unit": f"{tag}: {layers} calls (one per layer)", "max_abs_err": err,
            **time_keys(k_ms, p_ms, lib), "bound_ms": bms, "bound_by": by}


def _head_major_bf16_case(gen, dev, S, window, layers):
    """decode_mha on bf16 head-major caches at TinyLlama's attention shape
    (slots 16, H 32 over 4, D 64, cap 256): the fold at S 1, the per-head
    form at S 128. Against decode_mha_plain within 1e-4 on rows with a
    column to attend (0 on the others), the same bits on a second call;
    with ``layers``, the times over that many layers' caches."""
    from rten_tpu_torch.kernels.flash_attention import (
        decode_mha, decode_mha_folded, decode_mha_heads, decode_mha_plain,
    )

    B = L_SLOTS
    edges = torch.tensor([0, CAP - 1, CAP + 5], dtype=torch.int32)
    hi = 192 if S == 1 else CAP - PROMPT + 1
    lo = 128 if S == 1 else 0
    lens = torch.cat([edges, torch.randint(lo, hi, (B - 3,), generator=gen,
                                           dtype=torch.int32)]).to(dev)
    q = torch.randn(B, L_H, S, L_D, generator=gen).to(dev)
    k, v = _float_kv(gen, dev, (B, L_HKV, CAP, L_D), "bf16")
    form = decode_mha_folded if S == 1 else decode_mha_heads
    before = form.launches
    got = decode_mha(q, k, v, lens, window=window)
    again = decode_mha(q, k, v, lens, window=window)
    want = decode_mha_plain(q, k, v, lens, window=window)
    torch.cuda.synchronize()
    live = _mask(lens, S, window).any(-1, keepdim=True).expand(B, L_H, S, L_D)
    err = (got - want)[live].abs().max().item()
    tag = f"decode_mha S={S} bf16 window={window}"
    if (form.launches != before + 2 or not err <= 1e-4 or not (got[~live] == 0).all()
            or not torch.equal(got, again)):
        fail(f"{tag}: wrong form, max err {err} > 1e-4, a row with no column not 0, or two "
             f"calls differ")
    print(f"  {tag}: max abs err {err:.3e} (bound 1e-4), two calls bit-identical", flush=True)
    if not layers:
        return err, None
    pairs = _mask(lens, S).sum().item()
    kv_rows = (lens.long() + S).clamp(max=CAP).sum().item()
    nbytes = 2 * 4 * B * L_H * S * L_D + 4 * B + 2 * kv_rows * L_HKV * L_D * 2
    layer_kv = [_float_kv(gen, dev, (B, L_HKV, CAP, L_D), "bf16") for _ in range(layers)]
    k_ms = timed(lambda: [form(q, kk, vv, lens) for kk, vv in layer_kv], iters=10,
                 nbytes=layers * nbytes)
    p_ms = timed(lambda: [decode_mha_plain(q, kk, vv, lens) for kk, vv in layer_kv],
                 iters=3, warmup=1, nbytes=layers * nbytes)
    qd, m = q.to(torch.bfloat16), _mask(lens, S)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = timed(lambda: [sdpa(qd, kk, vv, attn_mask=m, enable_gqa=True) for kk, vv in layer_kv],
                iters=10, nbytes=layers * sdpa_bytes(qd, kv_rows, L_HKV, L_D, 2))
    del layer_kv
    bms, by = bound_ms(layers * nbytes, layers * 4.0 * pairs * L_H * L_D, attn_peak("bf16"))
    print(f"  {form.__name__} bf16 x{layers}: kernel {fmt(k_ms)}, plain {fmt(p_ms)}, sdpa on "
          f"bf16 {fmt(lib)}, bound {bms:.4f} ms ({by})", flush=True)
    return err, {"max_abs_err": err, **time_keys(k_ms, p_ms, lib), "bound_ms": bms,
                 "bound_by": by}


def phase_float_kv_kernels(gen, dev):
    """The f32/bf16 modes of the four attention kernels (kernel rows 2, 3,
    6a/6b and 8) at the serve paths' shapes: the flat append and
    prefill_mha_cat at GPT-2's headline (slots 120, cap 256; an admission
    of 120 x 128) in bf16 and f32, and at Qwen2.5-1.5B's attention (slots
    16, cap 256, D 128, group 6, 28 calls) in bf16; the block-table append
    on bf16 pools of 1 + 480 blocks; decode_mha's two forms and
    paged_decode_mha on bf16 at TinyLlama's attention shape (22 calls).
    Returns one row per kernel, its bf16 mode, the other shapes nested."""
    rows = []
    gpt2 = f"GPT-2 decode step at slots {SLOTS}, cap {CAP}, H 12, D 64"
    qwen = f"Qwen2.5-1.5B decode step at slots {Q_SLOTS}, cap {CAP}, H 12/2, D 128"
    cases = [_append_case(gen, dev, dt, *shape, f"{dt}, {unit}") for dt, shape, unit in (
        ("bf16", (SLOTS, H, H, D, 12), gpt2), ("f32", (SLOTS, H, H, D, 12), gpt2),
        ("bf16", (Q_SLOTS, Q_H, Q_HKV, Q_D, Q_LAYERS), qwen))]
    rows.append({"name": "decode_mha_append_cat[bf16]", "kv": "bf16",
                 "counter": "decode_mha_append_cat",
                 "source": "rten_tpu_torch/csrc/decode_append_bf16.cu (f32: decode_append_f32.cu)",
                 "replaces": "rten_tpu/kernels/flash_attention.py:2597", **cases[0],
                 "max_abs_err": max(c["max_abs_err"] for c in cases),
                 "library_call": "scaled_dot_product_attention (enable_gqa where grouped) on "
                                 "the cache-dtype K/V with the same mask (no append)",
                 "other_shapes": cases[1:]})
    gpt2 = f"GPT-2 admission of {SLOTS} x {PROMPT} tokens, H 12, D 64"
    qwen = f"Qwen2.5-1.5B admission of {Q_SLOTS} x {PROMPT} tokens, H 12/2, D 128"
    cases = [_prefill_case(gen, dev, dt, *shape, f"{dt}, {unit}") for dt, shape, unit in (
        ("bf16", (SLOTS, H, H, D, 12), gpt2), ("f32", (SLOTS, H, H, D, 12), gpt2),
        ("bf16", (Q_SLOTS, Q_H, Q_HKV, Q_D, Q_LAYERS), qwen))]
    rows.append({"name": "prefill_mha_cat[bf16]", "kv": "bf16",
                 "counter": "prefill_mha_cat_tensor_core",
                 "source": "rten_tpu_torch/csrc/decode_heads_tc.cuh (decode_mha_bf16.cu's "
                           "per-head form; f32: decode_heads_tf32.cuh, 3xTF32)",
                 "replaces": "rten_tpu/kernels/flash_attention.py:3301", **cases[0],
                 "max_abs_err": max(c["max_abs_err"] for c in cases),
                 "library_call": "scaled_dot_product_attention (enable_gqa where grouped) on "
                                 "the cache-dtype K/V with the same mask",
                 "other_shapes": cases[1:]})
    rows.append(phase_paged_append(gen, dev, "bf16"))
    errs = [_head_major_bf16_case(gen, dev, 1, 64, 0)[0],
            _head_major_bf16_case(gen, dev, PROMPT, 64, 0)[0]]
    for S, name, line in ((1, "decode_mha_folded", 772), (PROMPT, "decode_mha_heads", 935)):
        err, timing = _head_major_bf16_case(gen, dev, S, 0, L_LAYERS)
        rows.append({"name": f"{name}[bf16]", "kv": "bf16",
                     "counter": f"{name}_tensor_core",
                     "source": ("rten_tpu_torch/csrc/decode_fold_tc.cuh" if S == 1
                                else "rten_tpu_torch/csrc/decode_heads_tc.cuh"),
                     "replaces": f"rten_tpu/kernels/flash_attention.py:{line}",
                     "unit": (f"one TinyLlama {'decode step' if S == 1 else 'admission'} at "
                              f"slots {L_SLOTS}, cap {CAP}{'' if S == 1 else f', {S} tokens'}: "
                              f"{L_LAYERS} calls (one per layer), bf16 caches"),
                     **timing, "max_abs_err": max(err, *errs),
                     "library_call": "scaled_dot_product_attention(enable_gqa=True) on the "
                                     "bf16 K/V with the same mask"})
    rows.append(phase_paged_decode_mha(gen, dev, "bf16"))
    return rows


# --- int4 KV caches, deferred KV, the head-major append, head dims -----------


def _quant_head_major(gen, dev, kv, B, Hkv, Dh=L_D):
    """Head-major caches of kind ``kv`` [B, Hkv, CAP, Dh] and their scales
    [B, Hkv, CAP] (None for f32/bf16): "int4" u8 nibbles [.., Dh/2], "s8",
    "f32" or "bf16" values."""
    cap = CAP
    if kv == "int4":
        k, v = (torch.randint(0, 256, (B, Hkv, cap, Dh // 2), generator=gen,
                              dtype=torch.uint8).to(dev) for _ in "kv")
        ks, vs = ((torch.rand(B, Hkv, cap, generator=gen) * 0.3 + 0.05).to(dev) for _ in "kv")
        return k, v, ks, vs
    if kv == "s8":
        k, v = (torch.randint(-127, 128, (B, Hkv, cap, Dh), generator=gen,
                              dtype=torch.int8).to(dev) for _ in "kv")
        ks, vs = ((torch.rand(B, Hkv, cap, generator=gen) * 0.015 + 0.005).to(dev) for _ in "kv")
        return k, v, ks, vs
    return (*_float_kv(gen, dev, (B, Hkv, cap, Dh), kv), None, None)


def _dequant(k, v, ks, vs):
    """f32 K/V of head-major caches (SDPA's inputs)."""
    from rten_tpu_torch.kernels.flash_attention import unpack_int4

    if ks is None:
        return k.float(), v.float()
    if k.dtype == torch.uint8:
        k, v = unpack_int4(k), unpack_int4(v)
    return k.float() * ks[..., None], v.float() * vs[..., None]


def _row_bytes(kv, Dh):
    """Bytes of one cache row of one kv head, its scale included."""
    return {"int4": Dh // 2 + 4, "s8": Dh + 4, "f32": 4 * Dh, "bf16": 2 * Dh}[kv]


def _fold_case(gen, dev, kv, B, Hq, Hkv, layers, tag, W=0):
    """decode_mha's fold at one decode step (S 1) on head-major ``kv``
    caches, or (W > 0) a deferred step: a bf16 recent window of W rows at
    step t = W - 1, the new row written into it. Against the plain version
    (out within 1e-4 on rows with a column to attend, 0 on the others;
    windows bit-exact), the same bits twice; then the times of ``layers``
    calls, the plain version's and SDPA's (enable_gqa) on the dequantized
    K/V (with the window's rows appended), beside the bound."""
    from rten_tpu_torch.kernels.flash_attention import (
        decode_attention_deferred, decode_attention_deferred_plain, decode_mha,
        decode_mha_folded, decode_mha_plain,
    )

    q = torch.randn(B, Hq, 1, L_D, generator=gen).to(dev)
    if W:
        lens = torch.randint((CAP - W) // 2, CAP - W, (B,), generator=gen, dtype=torch.int32)
        lens[:3] = torch.tensor([0, 1, CAP - W], dtype=torch.int32)
    else:
        lens = torch.randint(128, 192, (B,), generator=gen, dtype=torch.int32)
        lens[:3] = torch.tensor([0, CAP - 1, CAP + 5], dtype=torch.int32)
    lens = lens.to(dev)
    k, v, ks, vs = _quant_head_major(gen, dev, kv, B, Hkv)
    t = torch.tensor([W - 1], dtype=torch.int32, device=dev)
    if W:
        rk, rv = _float_kv(gen, dev, (B, Hkv, W, L_D), "bf16")
        kn, vn = (torch.randn(B, Hkv, 1, L_D, generator=gen).to(dev) for _ in "kv")
        runs = [decode_attention_deferred(q, k, v, lens, ks, vs, recent_k=rk.clone(),
                                          recent_v=rv.clone(), t=t, k_new=kn, v_new=vn)
                for _ in range(2)]
        want = decode_attention_deferred_plain(q, k, v, lens, ks, vs, recent_k=rk.clone(),
                                               recent_v=rv.clone(), t=t, k_new=kn, v_new=vn)
        torch.cuda.synchronize()
        err = (runs[0][0] - want[0]).abs().max().item()
        ok = all(torch.equal(_bits(runs[0][i]), _bits(want[i])) for i in (1, 2))
        same = all(torch.equal(_bits(a), _bits(b)) for a, b in zip(*runs))
    else:
        before = decode_mha_folded.launches
        runs = [decode_mha(q, k, v, lens, ks, vs) for _ in range(2)]
        want = decode_mha_plain(q, k, v, lens, ks, vs)
        torch.cuda.synchronize()
        live = _mask(lens, 1).any(-1, keepdim=True).expand_as(runs[0])
        err = (runs[0] - want)[live].abs().max().item()
        ok = decode_mha_folded.launches == before + 2 and (runs[0][~live] == 0).all()
        same = torch.equal(runs[0], runs[1])
    if not err <= 1e-4 or not ok or not same:
        fail(f"decode_mha fold [{tag}]: max err {err} > 1e-4, windows/dead rows/form {ok}, "
             f"two calls bit-identical {same}")
    del runs, want
    layer_kv = [_quant_head_major(gen, dev, kv, B, Hkv) for _ in range(layers)]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if W:
        wins = [_float_kv(gen, dev, (B, Hkv, W, L_D), "bf16") for _ in range(layers)]
        read = lens.clamp(max=CAP).long().sum().item()
        kv_rows = read + B * W
        pairs = kv_rows * Hq
        nbytes = (2 * 4 * B * Hq * L_D + 4 * B + 2 * read * Hkv * _row_bytes(kv, L_D)
                  + 2 * B * Hkv * (W - 1) * L_D * 2 + 2 * B * Hkv * L_D * (4 + 2))
        k_ms = timed(lambda: [decode_attention_deferred(q, *c[:2], lens, *c[2:], recent_k=w[0],
                                                        recent_v=w[1], t=t, k_new=kn, v_new=vn)
                              for c, w in zip(layer_kv, wins)], iters=10, nbytes=layers * nbytes)
        p_ms = timed(lambda: [decode_attention_deferred_plain(
            q, *c[:2], lens, *c[2:], recent_k=w[0], recent_v=w[1], t=t, k_new=kn, v_new=vn)
            for c, w in zip(layer_kv, wins)], iters=3, warmup=1, nbytes=layers * nbytes)
        j = torch.arange(CAP + W, device=dev)
        m = torch.where(j < CAP, j < lens.long()[:, None], True)[:, None, None, :]
        deq = [tuple(torch.cat([x, w_.float()], 2) for x, w_ in zip(_dequant(*c), w))
               for c, w in zip(layer_kv, wins)]
        del wins
    else:
        m = _mask(lens, 1)
        pairs = m.sum().item() * Hq
        kv_rows = (lens.long() + 1).clamp(max=CAP).sum().item()
        nbytes = 2 * 4 * B * Hq * L_D + 4 * B + 2 * kv_rows * Hkv * _row_bytes(kv, L_D)
        k_ms = timed(lambda: [decode_mha_folded(q, *c[:2], lens, *c[2:]) for c in layer_kv],
                     iters=10, nbytes=layers * nbytes)
        p_ms = timed(lambda: [decode_mha_plain(q, *c[:2], lens, *c[2:]) for c in layer_kv],
                     iters=3, warmup=1, nbytes=layers * nbytes)
        deq = [_dequant(*c) for c in layer_kv]
    lib = timed(lambda: [sdpa(q, kf, vf, attn_mask=m, enable_gqa=Hq != Hkv) for kf, vf in deq],
                iters=10, nbytes=layers * sdpa_bytes(q, kv_rows, Hkv, L_D, 4))
    del layer_kv, deq
    bms, by = bound_ms(layers * nbytes, layers * 4.0 * pairs * L_D, attn_peak(kv))
    print(f"  decode_mha fold [{tag}] x{layers}: max abs err {err:.3e} (bound 1e-4), two calls "
          f"bit-identical; kernel {fmt(k_ms)}, plain {fmt(p_ms)}, sdpa {fmt(lib)}, "
          f"bound {bms:.4f} ms ({by})", flush=True)
    return {"unit": f"{tag}: {layers} calls (one per layer)", "max_abs_err": err,
            **time_keys(k_ms, p_ms, lib), "bound_ms": bms, "bound_by": by}


def _heads_int4_case(gen, dev, layers):
    """decode_mha's per-head form on int4 caches at TinyLlama's admission
    (16 x 128 tokens): against the plain version within 1e-4, the same bits
    twice; the times of ``layers`` calls beside the bound."""
    from rten_tpu_torch.kernels.flash_attention import decode_mha, decode_mha_heads, decode_mha_plain

    B = L_SLOTS
    lens = torch.randint(0, CAP - PROMPT + 1, (B,), generator=gen, dtype=torch.int32)
    lens[:2] = torch.tensor([0, CAP - 1], dtype=torch.int32)
    lens = lens.to(dev)
    q = torch.randn(B, L_H, PROMPT, L_D, generator=gen).to(dev)
    k, v, ks, vs = _quant_head_major(gen, dev, "int4", B, L_HKV)
    before = decode_mha_heads.launches
    got, again = (decode_mha(q, k, v, lens, ks, vs) for _ in range(2))
    want = decode_mha_plain(q, k, v, lens, ks, vs)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if decode_mha_heads.launches != before + 2 or not err <= 1e-4 or not torch.equal(got, again):
        fail(f"decode_mha_heads [int4]: wrong form, max err {err} > 1e-4, or two calls differ")
    del got, again, want
    lens = torch.zeros(B, dtype=torch.int32, device=dev)
    nbytes = 2 * 4 * B * L_H * PROMPT * L_D + 4 * B + 2 * B * PROMPT * L_HKV * _row_bytes(
        "int4", L_D)
    layer_kv = [_quant_head_major(gen, dev, "int4", B, L_HKV) for _ in range(layers)]
    k_ms = timed(lambda: [decode_mha_heads(q, *c[:2], lens, *c[2:]) for c in layer_kv], iters=5,
                 nbytes=layers * nbytes)
    p_ms = timed(lambda: [decode_mha_plain(q, *c[:2], lens, *c[2:]) for c in layer_kv],
                 iters=2, warmup=1, nbytes=layers * nbytes)
    m = _mask(lens, PROMPT)
    deq = [_dequant(*c) for c in layer_kv]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = timed(lambda: [sdpa(q, kf, vf, attn_mask=m, enable_gqa=True) for kf, vf in deq],
                iters=5, nbytes=layers * sdpa_bytes(q, B * PROMPT, L_HKV, L_D, 4))
    del layer_kv, deq
    pairs = m.sum().item() * L_H
    bms, by = bound_ms(layers * nbytes, layers * 4.0 * pairs * L_D, attn_peak("int4"))
    print(f"  decode_mha_heads [int4] x{layers}: max abs err {err:.3e} (bound 1e-4), two calls "
          f"bit-identical; kernel {fmt(k_ms)}, plain {fmt(p_ms)}, sdpa {fmt(lib)}, bound "
          f"{bms:.4f} ms ({by})", flush=True)
    return {"max_abs_err": err, **time_keys(k_ms, p_ms, lib), "bound_ms": bms, "bound_by": by}


def _ulps(a, b):
    """The largest distance in f32 units in the last place between two
    positive f32 tensors."""
    return (a.view(torch.int32).long() - b.view(torch.int32).long()).abs().max().item()


def _append_hm_case(gen, dev, kv, B, Hq, Hkv, Dh, layers, tag):
    """decode_mha_append on head-major ``kv`` caches (s8, f32, bf16): against
    its plain version (out within 1e-4, cache rows bit-exact, s8 scales
    within 1 ULP, rows it does not own untouched), the same bits twice; with
    ``layers``, the times of that many calls, the plain version's and SDPA's
    on the dequantized K/V beside the bound."""
    from rten_tpu_torch.kernels.flash_attention import decode_mha_append, decode_mha_append_plain

    q = torch.randn(B, Hq, 1, Dh, generator=gen).to(dev)
    kn, vn = (torch.randn(B, Hkv, 1, Dh, generator=gen).to(dev) for _ in "kv")
    lens = torch.randint(128, 192, (B,), generator=gen, dtype=torch.int32)
    lens[:4] = torch.tensor([0, 31, CAP - 1, CAP + 5], dtype=torch.int32)
    lens = lens.to(dev)
    k, v, ks, vs = _quant_head_major(gen, dev, kv, B, Hkv, Dh)
    if ks is not None:
        ks, vs = ks[..., None], vs[..., None]
    args = [x for x in (k, v, ks, vs)]

    def fresh():
        return [None if x is None else x.clone() for x in args]

    runs = []
    for _ in range(2):
        a = fresh()
        runs.append(decode_mha_append(q, *a[:2], lens, *a[2:], k_new=kn, v_new=vn))
    p = fresh()
    want = decode_mha_append_plain(q, *p[:2], lens, *p[2:], k_new=kn, v_new=vn)
    torch.cuda.synchronize()
    err = (runs[0][0] - want[0]).abs().max().item()
    exact = all(torch.equal(_bits(runs[0][i]), _bits(want[i])) for i in (1, 2))
    ulps = max(_ulps(runs[0][i], want[i]) for i in (3, 4)) if ks is not None else 0
    same = all(torch.equal(_bits(x), _bits(y)) for x, y in zip(runs[0], runs[1])
               if x is not None)
    keep = torch.ones(B, CAP, dtype=torch.bool, device=dev)
    keep[torch.arange(B, device=dev), lens.long().clamp(max=CAP - 1)] = False
    untouched = torch.equal(_bits(runs[0][1]).permute(0, 2, 1, 3)[keep],
                            _bits(k).permute(0, 2, 1, 3)[keep])
    if not err <= 1e-4 or not exact or ulps > 1 or not same or not untouched:
        fail(f"decode_mha_append [{tag}]: max err {err} > 1e-4, rows bit-exact {exact}, "
             f"scales {ulps} ULP apart, two calls bit-identical {same}, other rows untouched "
             f"{untouched}")
    del runs, want
    if not layers:
        return err, None
    layer_kv = [_quant_head_major(gen, dev, kv, B, Hkv, Dh) for _ in range(layers)]
    layer_kv = [(c[0], c[1], None if c[2] is None else c[2][..., None],
                 None if c[3] is None else c[3][..., None]) for c in layer_kv]
    read = lens.clamp(max=CAP - 1).long().sum().item()
    rb = _row_bytes(kv, Dh)
    nbytes = (4 * B * Hq * Dh * 2 + 4 * B * Hkv * Dh * 2 + 4 * B + 2 * read * Hkv * rb
              + 2 * B * Hkv * rb)
    k_ms = timed(lambda: [decode_mha_append(q, *c[:2], lens, *c[2:], k_new=kn, v_new=vn)
                          for c in layer_kv], iters=10, nbytes=layers * nbytes)
    p_ms = timed(lambda: [decode_mha_append_plain(q, *c[:2], lens, *c[2:], k_new=kn, v_new=vn)
                          for c in layer_kv], iters=3, warmup=1, nbytes=layers * nbytes)
    m = _mask(lens, 1)
    deq = [_dequant(c[0], c[1], None if c[2] is None else c[2][..., 0],
                    None if c[3] is None else c[3][..., 0]) for c in layer_kv]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = timed(lambda: [sdpa(q, kf, vf, attn_mask=m, enable_gqa=Hq != Hkv) for kf, vf in deq],
                iters=10, nbytes=layers * sdpa_bytes(q, read, Hkv, Dh, deq[0][0].element_size()))
    del layer_kv, deq
    bms, by = bound_ms(layers * nbytes, layers * 4.0 * (read + B) * Hq * Dh, attn_peak(kv))
    splits = split_plan(B, Hkv, CAP)
    print(f"  decode_mha_append [{tag}] x{layers} (splits {splits[0]} of {splits[1]} columns): "
          f"max abs err {err:.3e} (bound 1e-4), rows bit-exact, scales within {ulps} ULP; "
          f"kernel {fmt(k_ms)}, plain {fmt(p_ms)}, sdpa {fmt(lib)}, bound {bms:.4f} ms ({by})",
          flush=True)
    return err, {"unit": f"{tag}: {layers} calls (one per layer)", "max_abs_err": err,
                 "splits": splits[0],
                 **time_keys(k_ms, p_ms, lib), "bound_ms": bms, "bound_by": by}


def phase_int4_deferred_kernels(gen, dev):
    """The modes this slice added to kernel rows 6a, 6b and 7, each against
    its plain version on the card and timed: the int4 fold at TinyLlama's
    decode step (slots 16, cap 256, H 32 over 4, D 64, 22 calls) and at
    GPT-2's headline (slots 120, H 12, 12 calls); the fold with a bf16
    recent window of 8 rows and of 64 (the bench's steps per dispatch) on s8
    and int4 caches at GPT-2's headline; the int4 per-head form at
    TinyLlama's admission (16 x 128, 22 calls); decode_mha_append on s8, f32
    and bf16 head-major caches at TinyLlama's decode step (22 calls)."""
    rows = []
    tiny = f"TinyLlama decode step at slots {L_SLOTS}, cap {CAP}, H 32/4, D 64"
    gpt2 = f"GPT-2 decode step at slots {SLOTS}, cap {CAP}, H 12, D 64"
    folds = [_fold_case(gen, dev, "int4", L_SLOTS, L_H, L_HKV, L_LAYERS, f"int4, {tiny}"),
             _fold_case(gen, dev, "int4", SLOTS, H, H, 12, f"int4, {gpt2}")]
    rows.append({"name": "decode_mha_folded[int4]", "kv": "u4",
                 "counter": "decode_mha_folded_tensor_core",
                 "source": "rten_tpu_torch/csrc/decode_fold_tc.cuh (decode_mha_u4.cu)",
                 "replaces": "rten_tpu/kernels/flash_attention.py:772", **folds[0],
                 "max_abs_err": max(c["max_abs_err"] for c in folds),
                 "library_call": "scaled_dot_product_attention(enable_gqa) on pre-dequantized "
                                 "f32 K/V with the same mask",
                 "other_shapes": folds[1:]})
    wins = [_fold_case(gen, dev, kv, SLOTS, H, H, 12, f"{kv} + bf16 window of {W}, {gpt2}", W)
            for kv in ("int4", "s8") for W in (8, 64)]
    rows.append({"name": "decode_mha_folded[window]", "kv": "u4-deferred",
                 "counter": "decode_mha_folded_tensor_core",
                 "source": "rten_tpu_torch/csrc/decode_fold_tc.cuh (decode_mha_u4.cu; s8: "
                           "decode_mha.cu)",
                 "replaces": "rten_tpu/kernels/flash_attention.py:772", **wins[1],
                 "max_abs_err": max(c["max_abs_err"] for c in wins),
                 "library_call": "scaled_dot_product_attention on pre-dequantized f32 K/V with "
                                 "the window's rows appended, the same mask (no row write)",
                 "other_shapes": [wins[0]] + wins[2:]})
    heads = _heads_int4_case(gen, dev, L_LAYERS)
    rows.append({"name": "decode_mha_heads[int4]", "kv": ("u4", "u4-deferred"),
                 "counter": "decode_mha_heads_tensor_core",
                 "source": "rten_tpu_torch/csrc/decode_heads_tc.cuh",
                 "replaces": "rten_tpu/kernels/flash_attention.py:935",
                 "unit": f"one TinyLlama admission at slots {L_SLOTS}, cap {CAP}, {PROMPT} "
                         f"tokens: {L_LAYERS} calls, int4 caches", **heads,
                 "library_call": "scaled_dot_product_attention(enable_gqa=True) on "
                                 "pre-dequantized f32 K/V with the same mask"})
    appends = [_append_hm_case(gen, dev, kv, L_SLOTS, L_H, L_HKV, L_D, L_LAYERS, f"{kv}, {tiny}")
               for kv in ("s8", "f32", "bf16")]
    rows.append({"name": "decode_mha_append", "kv": "head-major append",
                 "source": "rten_tpu_torch/csrc/decode_append.cu (f32, bf16: decode_append_f32.cu, "
                           "decode_append_bf16.cu)",
                 "replaces": "rten_tpu/kernels/flash_attention.py:1442", **appends[0][1],
                 "max_abs_err": max(e for e, _ in appends),
                 "library_call": "scaled_dot_product_attention(enable_gqa=True) on the "
                                 "dequantized K/V with the same mask (no append)",
                 "other_shapes": [t for _, t in appends[1:]]})
    return rows


def phase_head_dims(gen, dev):
    """Head dims 80, 96 and 256 (and 512 where the reference takes it) in
    every attention kernel the masked tail touched, each against its plain
    version within 1e-4 (bf16 mha 1e-2): decode_mha's fold and per-head
    form (int4, s8, bf16), paged_decode_mha (s8, bf16), the cat append flat
    and through a block table (s8, bf16), prefill_mha_cat (s8, bf16), mha
    (f32, bf16) and decode_mha_append (s8, bf16). Slots 8, cap 256, 8 query
    heads over 2 KV heads (4 at D 512). Returns {kernel: {D: max err}}."""
    from rten_tpu_torch.kernels import flash_attention as fa

    B, Hq, S = 8, 8, 32
    errs = {}

    def note(name, Dh, err, tol=1e-4):
        if not err <= tol:
            fail(f"{name} at D {Dh}: max err {err} > {tol}")
        errs.setdefault(name, {})[str(Dh)] = max(errs.get(name, {}).get(str(Dh), 0.0), err)

    def live_err(got, want, lens, S_):
        live = _mask(lens, S_).any(-1, keepdim=True).expand_as(got)
        if not (got[~live] == 0).all():
            return float("inf")
        return (got - want)[live].abs().max().item()

    for Dh in (80, 96, 256, 512):
        Hkv = 2 if Dh < 512 else 4
        lens = torch.randint(0, CAP - S, (B,), generator=gen, dtype=torch.int32)
        lens[:2] = torch.tensor([0, CAP - 1], dtype=torch.int32)
        lens = lens.to(dev)
        for kv in ("int4", "s8", "bf16"):
            k, v, ks, vs = _quant_head_major(gen, dev, kv, B, Hkv, Dh)
            for S_ in (1, S):
                q = torch.randn(B, Hq, S_, Dh, generator=gen).to(dev)
                got = fa.decode_mha(q, k, v, lens, ks, vs)
                want = fa.decode_mha_plain(q, k, v, lens, ks, vs)
                torch.cuda.synchronize()
                note("decode_mha_folded" if S_ == 1 else "decode_mha_heads", Dh,
                     live_err(got, want, lens, S_))
        q1 = torch.randn(B, Hq, 1, Dh, generator=gen).to(dev)
        kn, vn = (torch.randn(B, Hkv, 1, Dh, generator=gen).to(dev) for _ in "kv")
        for kv in ("s8", "bf16"):
            err, _ = _append_hm_case(gen, dev, kv, B, Hq, Hkv, Dh, 0, f"{kv}, D {Dh}")
            note("decode_mha_append", Dh, err)
            # paged_decode_mha on pools of 1 + B * 4 blocks of 64.
            NB = 1 + B * MAXB
            pk, pv, pks, pvs = _pools(gen, dev, NB, Hkv, kv, Dh=Dh)
            bt = _shuffled_table(gen, dev, B, B)
            got = fa.paged_decode_mha(q1, pk, pv, lens, bt, pks, pvs)
            want = fa.paged_decode_mha_plain(q1, pk, pv, lens, bt, pks, pvs)
            torch.cuda.synchronize()
            note("paged_decode_mha", Dh, (got - want).abs().max().item())
            if Dh > 256:
                continue
            # The cat kernels: the flat append, through a block table, prefill.
            if kv == "s8":
                kc, vc = (torch.randint(-127, 128, (B, CAP, Hkv * Dh), generator=gen,
                                        dtype=torch.int8).to(dev) for _ in "kv")
                sc = [(torch.rand(B, Hkv, CAP, 1, generator=gen) * 0.01 + 0.005).to(dev)
                      for _ in "kv"]
            else:
                kc, vc = _float_kv(gen, dev, (B, CAP, Hkv * Dh), kv)
                sc = [None, None]
            a = [None if x is None else x.clone() for x in (kc, vc, *sc)]
            p = [None if x is None else x.clone() for x in (kc, vc, *sc)]
            got = fa.decode_mha_append_cat(q1, a[0], a[1], lens, a[2], a[3], k_new=kn, v_new=vn)
            want = fa.decode_mha_append_cat_plain(q1, p[0], p[1], lens, p[2], p[3], k_new=kn,
                                                  v_new=vn)
            torch.cuda.synchronize()
            if not all(torch.equal(_bits(got[i]), _bits(want[i])) for i in (1, 2)):
                fail(f"decode_mha_append_cat at D {Dh}: cache rows differ")
            note("decode_mha_append_cat", Dh, (got[0] - want[0]).abs().max().item())
            pools = _pools(gen, dev, NB, Hkv, kv, cat=True, Dh=Dh)
            a = [None if x is None else x.clone() for x in pools]
            p = [None if x is None else x.clone() for x in pools]
            got = fa.decode_mha_append_cat(q1, a[0], a[1], lens, a[2], a[3], k_new=kn, v_new=vn,
                                           block_table=bt)
            want = fa.decode_mha_append_cat_paged_plain(q1, p[0], p[1], lens, p[2], p[3],
                                                        k_new=kn, v_new=vn, block_table=bt)
            torch.cuda.synchronize()
            if not all(torch.equal(_bits(got[i]), _bits(want[i])) for i in (1, 2)):
                fail(f"decode_mha_append_cat (block table) at D {Dh}: pools differ")
            note("decode_mha_append_cat_paged", Dh, (got[0] - want[0]).abs().max().item())
            qs = torch.randn(B, Hq, S, Dh, generator=gen).to(dev)
            got = fa.prefill_mha_cat(qs, kc, vc, lens.clamp(max=CAP - S), *sc)
            want = fa.prefill_mha_cat_plain(qs, kc, vc, lens.clamp(max=CAP - S), *sc)
            torch.cuda.synchronize()
            note("prefill_mha_cat", Dh, (got - want).abs().max().item())
        if Dh <= 256:
            for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
                qm = torch.randn(2, Hq, 100, Dh, generator=gen).to(dt).to(dev)
                km, vm = (torch.randn(2, Hkv, 140, Dh, generator=gen).to(dt).to(dev)
                          for _ in "kv")
                got = fa.mha(qm, km, vm, causal=True)
                want = fa.mha_plain(qm.float(), km.float(), vm.float(), causal=True)
                torch.cuda.synchronize()
                note("mha", Dh, (got.float() - want).abs().max().item(), tol)
    print(f"  head dims (any even D; 512 where the reference takes it): max abs err by kernel "
          f"and D {json.dumps(errs)}", flush=True)
    return errs


def phase_argmax(gen, dev, slots=SLOTS, vocab=VOCAB, padded=NP):
    """The argmax on the engine's strided view of [slots, padded] logits cut
    to the vocabulary, against its plain version: a tie (the lower index
    wins), the last column, two calls giving the same bits; on a copy, a tie
    over a chunk boundary, two NaNs (the first wins) and an all -inf row
    (0). Then the times beside torch.argmax and the byte bound."""
    from rten_tpu_torch.kernels.argmax import argmax_lastdim, argmax_plain, chunk_plan

    logits = torch.randn(slots, padded, generator=gen).to(dev)
    x = logits[:, :vocab]                       # the engine's strided view
    x[0, 7] = x[0, 9] = 1e4                     # a tie: the lower index wins
    x[1, vocab - 1] = 1e4                       # the last column
    got = argmax_lastdim(x)
    again = argmax_lastdim(x)
    want = argmax_plain(x)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if err != 0 or int(got[0]) != 7 or not torch.equal(got, again):
        fail("argmax_lastdim disagrees with its plain version, or two calls differ")
    chunks, length = chunk_plan(slots, vocab, torch.cuda.get_device_properties(dev)
                                .multi_processor_count)
    edge = logits.clone()[:, :vocab]
    edge[2, length - 1] = edge[2, length] = 1e4  # a tie over a chunk boundary
    edge[3, 11] = edge[3, vocab - 2] = float("nan")
    edge[4] = float("-inf")
    got = argmax_lastdim(edge)
    torch.cuda.synchronize()
    if not torch.equal(got, argmax_plain(edge)) or got[2:5].tolist() != [
            length - 1 if chunks > 1 else int(got[2]), 11, 0]:
        fail(f"argmax_lastdim on the edge rows: {got[2:5].tolist()}")
    nbytes = 4.0 * slots * vocab + 4 * slots
    k_ms = timed(lambda: argmax_lastdim(x), nbytes=nbytes)
    p_ms = timed(lambda: argmax_plain(x), nbytes=nbytes)
    lib = timed(lambda: torch.argmax(x, dim=-1), nbytes=nbytes)
    bms, by = bound_ms(nbytes, float(slots * vocab), F32_FLOPS_PER_S)
    print(f"  argmax_lastdim [{slots}, {vocab}] ({chunks} chunks of {length} columns a row; "
          f"edges, two calls bit-identical): kernel {fmt(k_ms)}, plain {fmt(p_ms)}, "
          f"torch.argmax {fmt(lib)}, bound {bms:.4f} ms ({by})", flush=True)
    return {
        "name": "argmax_lastdim", "route": "cuda",
        "source": "rten_tpu_torch/csrc/argmax.cu",
        "replaces": "rten_tpu/kernels/argmax.py:60",
        "unit": f"one call on [{slots}, {vocab}] logits (row stride {padded})",
        "max_abs_err": float(err), **time_keys(k_ms, p_ms, lib), "bound_ms": bms,
        "bound_by": by, "library_call": "torch.argmax",
    }


# The Generator's shapes: GPT-2 124M at batch 1, a 91-token prompt left-padded
# to the bucket of 128 (37 padding columns), 64 new tokens.
GEN_PROMPT, GEN_BUCKET, GEN_NEW = 91, 128, 64


def _mha_case(gen, dev, tag, B, Hq, Hkv, T_q, T_k, causal, softcap, pad, calls,
              dt=torch.float32):
    """One mha shape in ``dt``: against mha_plain within 1e-4 (f32; bf16 2e-2,
    one bf16 rounding of the output) on the rows with a column to attend, 0
    on the others (the left padding under causal), the same bits on a second
    call, on tensor cores (the CUDA-core counter does not move); then the
    times of ``calls`` calls (one per layer) of the kernel, the plain
    version and SDPA in ``dt`` with the mask and the causal band folded into
    one float mask (enable_gqa), beside the bound from this run's (row,
    column) pairs: the operations at the TF32 (f32) or bf16 tensor-core
    peak, or the bytes, whichever is larger (the f32 CUDA-core figure beside
    it)."""
    from rten_tpu_torch.kernels.common import sm_count
    from rten_tpu_torch.kernels.flash_attention import mha, mha_plain, mha_key_warps

    q = torch.randn(B, Hq, T_q, D, generator=gen).to(dev, dt)
    k = torch.randn(B, Hkv, T_k, D, generator=gen).to(dev, dt)
    v = torch.randn(B, Hkv, T_k, D, generator=gen).to(dev, dt)
    cc = mha.cuda_core_launches
    # The Generator's folded [1, Tk] additive mask: -1e30 on the pad columns.
    m = torch.where(torch.arange(T_k, device=dev) < pad, -1e30, 0.0)[None] if pad else None
    kw = dict(causal=causal, softcap=softcap)
    got = mha(q, k, v, m, **kw)
    again = mha(q, k, v, m, **kw)
    want = mha_plain(q, k, v, m, **kw)
    torch.cuda.synchronize()
    admitted = torch.ones(T_q, T_k, dtype=torch.bool, device=dev)
    if causal:
        admitted &= (torch.arange(T_k, device=dev)[None]
                     <= torch.arange(T_q, device=dev)[:, None] + T_k - T_q)
    if m is not None:
        admitted &= m > -1e29
    live = admitted.any(-1)[None, None, :, None].expand_as(got)
    err = (got.float() - want.float())[live].abs().max().item()
    tol = 1e-4 if dt == torch.float32 else 2e-2
    if (not err <= tol or not (got[~live] == 0).all() or not torch.equal(got, again)
            or mha.cuda_core_launches != cc):
        fail(f"mha [{tag}]: max err {err} > {tol}, a fully masked row is not 0, two "
             f"calls differ, or not on tensor cores")
    layers = [(torch.randn_like(k), torch.randn_like(v)) for _ in range(calls)]
    pairs = admitted.sum().item() * B * Hq
    el = q.element_size()
    nbytes = el * (2 * B * Hq * T_q * D + 2 * B * Hkv * T_k * D) + (4 * T_k if pad else 0)
    k_ms = timed(lambda: [mha(q, kk, vv, m, **kw) for kk, vv in layers], iters=10,
                 nbytes=calls * nbytes)
    p_ms = timed(lambda: [mha_plain(q, kk, vv, m, **kw) for kk, vv in layers], iters=3, warmup=1,
                 nbytes=calls * nbytes)
    fmask = torch.where(admitted, 0.0, float("-inf")).to(dt)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sd = timed(lambda: [sdpa(q, kk, vv, attn_mask=fmask, enable_gqa=Hq != Hkv)
                        for kk, vv in layers], iters=10, nbytes=calls * nbytes)
    # SDPA has no softcap: with one it is a yardstick only, not the library
    # time of the same function.
    lib = None if softcap else sd
    ops = calls * 4.0 * pairs * D
    bms, by = bound_ms(calls * nbytes, ops,
                       TF32_FLOPS_PER_S if dt == torch.float32 else BF16_FLOPS_PER_S)
    old_bms, old_by = bound_ms(calls * nbytes, ops, F32_FLOPS_PER_S)
    key_warps = mha_key_warps(B, Hq, T_q, causal, sm_count(0))
    print(f"  mha [{tag}] x{calls}: max abs err {err:.3e} (bound {tol:g}), "
          f"{int((~live).sum()) // D} fully masked rows 0, two calls bit-identical, tensor "
          f"cores ({key_warps} key warp{'s' if key_warps > 1 else ''} a block); kernel "
          f"{fmt(k_ms)}, plain {fmt(p_ms)}, "
          f"sdpa{' without the softcap' if softcap else ''} {fmt(sd)}, bound {bms:.4f} ms ({by}; "
          f"at the f32 CUDA-core rate {old_bms:.4f} ms, {old_by})", flush=True)
    return {"unit": f"{tag}: {calls} call{'s' if calls > 1 else ''}", "max_abs_err": err,
            **time_keys(k_ms, p_ms, lib), "bound_ms": bms, "bound_by": by,
            "bound_ms_f32_cuda_cores": old_bms, "key_warps": key_warps,
            **({"sdpa_without_softcap_ms": ms_of(sd)} if softcap else {})}


def phase_mha(gen, dev):
    """mha (rten_tpu_torch/csrc/mha.cu) at the Generator's prefill (B 1, H 12,
    Tq = Tk = 128, D 64, causal, a [1, 128] mask with 37 left-pad columns;
    12 calls, one per layer), at GPT-2's longest prompt (the same at 1024),
    with GQA and softcap (B 2, 32 query heads over 4 KV heads, Tq 256, Tk
    512, softcap 30, causal and not, no mask), all f32, and the first two
    again in bf16 beside SDPA in bf16. Every case runs on tensor cores."""
    rows = [
        _mha_case(gen, dev, "Generator prefill, B 1, H 12, T 128, D 64, causal, 37 pad columns",
                  1, H, H, GEN_BUCKET, GEN_BUCKET, True, 0.0, GEN_BUCKET - GEN_PROMPT, 12),
        _mha_case(gen, dev, "GPT-2's longest prompt, T 1024, causal, 37 pad columns",
                  1, H, H, 1024, 1024, True, 0.0, 37, 12),
    ]
    for causal in (True, False):
        rows.append(_mha_case(gen, dev, f"GQA 32/4, B 2, Tq 256, Tk 512, softcap 30, "
                                        f"{'causal' if causal else 'not causal'}",
                              2, 32, 4, 256, 512, causal, 30.0, 0, 1))
    rows += [
        _mha_case(gen, dev, "Generator prefill in bf16, T 128", 1, H, H, GEN_BUCKET, GEN_BUCKET,
                  True, 0.0, GEN_BUCKET - GEN_PROMPT, 12, torch.bfloat16),
        _mha_case(gen, dev, "GPT-2's longest prompt in bf16, T 1024", 1, H, H, 1024, 1024, True,
                  0.0, 37, 12, torch.bfloat16),
    ]
    head = rows[0]
    return {
        "name": "mha", "route": "cuda", "source": "rten_tpu_torch/csrc/mha.cu",
        "replaces": "rten_tpu/kernels/flash_attention.py:139",
        **head, "max_abs_err": max(r["max_abs_err"] for r in rows[:4]),
        "bf16_max_abs_err": max(r["max_abs_err"] for r in rows[4:]),
        "library_call": "scaled_dot_product_attention(enable_gqa) with the mask and the causal "
                        "band folded into one float mask",
        "other_shapes": rows[1:],
    }


# One GPT-2 124M forward's MatMulNBits calls, (K, N, calls): c_attn, attn
# c_proj, c_fc, mlp c_proj per layer, and the lm_head.
GPT2_INT4 = [(E, 3 * E, 12), (E, E, 12), (E, 4 * E, 12), (4 * E, E, 12), (E, VOCAB, 1)]
# Rows per call: a Generator decode step, a serve decode step, a Generator
# prefill, a serve admission.
INT4_MS = (1, 16, 128, 2048)


def _int4_weights(gen, dev, K, N, zp=False):
    nb = K // 32
    packed = torch.randint(0, 256, (N, nb, 16), generator=gen, dtype=torch.uint8).to(dev)
    scales = (torch.rand(N, nb, generator=gen) * 0.002 + 0.001).to(dev)
    zps = (torch.randint(0, 256, (N * ((nb + 1) // 2),), generator=gen, dtype=torch.uint8).to(dev)
           if zp else None)
    return packed, scales, zps


def _int4_rows(M, N):
    """The rows a MatMulNBits call gets on its path at M: a serve admission
    (M = 16 slots x bucket 128 = 2048) runs its 48 projections at 2048 rows
    and the lm_head at 16 (gather_last keeps one row per slot)."""
    return 16 if M == 2048 and N == VOCAB else M


def phase_int4_matmul(gen, dev):
    """int4_matmul (rten_tpu_torch/csrc/int4_matmul.cu) over one GPT-2 124M
    forward's 49 MatMulNBits calls (every layer its own weights, block 32,
    no zero points, as quantize_weight_only_int4 packs them) at M = 1 (a
    Generator decode step), 16 (a serve decode step), 128 (a Generator
    prefill) and 2048 (a serve admission, the lm_head at 16), and one shape
    with u8 zero points: within 1e-4 of max|out| of int4_matmul_plain, the
    same bits on a second call, on the form int4_form names (M <= 16 the
    stream kernel, above it the tiled one; each call's split plan printed).
    The bound counts one product's operations at the bf16 tensor-core rate,
    where both forms run it (three parts of the activations are the
    design's cost, not the function's). The yardstick, torch.matmul on the
    pre-dequantized f32 weights, reads 8x the bytes and is not the same
    function."""
    from rten_tpu_torch.kernels.common import sm_count
    from rten_tpu_torch.kernels.int4_matmul import (
        FORMS, dequant_nbits, int4_form, int4_matmul, int4_matmul_plain, int4_split_plan,
        unpack_zero_points,
    )

    layers = [[_int4_weights(gen, dev, K, N) for _ in range(n)] for K, N, n in GPT2_INT4]
    err = 0.0
    for (K, N, _), ws in zip(GPT2_INT4 + [(E, 4 * E, 1)], layers + [
            [_int4_weights(gen, dev, E, 4 * E, zp=True)]]):
        for M in sorted({_int4_rows(M, N) for M in INT4_MS}):
            a = torch.randn(M, K, generator=gen).to(dev)
            packed, scales, zps = ws[0]
            form = int4_form(M, 32)
            before = getattr(int4_matmul, f"{form}_launches")
            got = int4_matmul(a, packed, scales, zps, K=K, N=N, block_size=32)
            again = int4_matmul(a, packed, scales, zps, K=K, N=N, block_size=32)
            want = int4_matmul_plain(a, packed.reshape(N, -1), scales,
                                     unpack_zero_points(zps, N, K // 32), K=K, N=N,
                                     block_size=32)
            torch.cuda.synchronize()
            e = (got - want).abs().max().item() / want.abs().max().item()
            if (not e <= 1e-4 or not torch.equal(got, again)
                    or getattr(int4_matmul, f"{form}_launches") != before + 2):
                fail(f"int4_matmul M={M} K={K} N={N} zp={zps is not None}: max err {e} of "
                     f"max|out| > 1e-4, two calls differ, or not the {form} form")
            err = max(err, e)
    print(f"  int4_matmul: every shape at M 1, 16, 128, 2048 (and u8 zero points) within "
          f"{err:.3e} of max|out| (bound 1e-4), two calls bit-identical", flush=True)
    for M in INT4_MS:
        plans = {f"{K}x{N}": int4_split_plan(_int4_rows(M, N), N, K, 32, sm_count(0))[:2]
                 for K, N, _ in GPT2_INT4}
        print(f"  int4_matmul M={M} ({int4_form(M, 32)}; lm_head {int4_form(_int4_rows(M, VOCAB), 32)}): "
              f"(splits, kchunk) by K x N {json.dumps(plans)}", flush=True)
    deq = [[dequant_nbits(p, s, None, K=K, N=N, block_size=32).T.contiguous() for p, s, _ in ws]
           for (K, N, _), ws in zip(GPT2_INT4, layers)]
    calls = [(K, N, w, d) for (K, N, _), ws, ds in zip(GPT2_INT4, layers, deq)
             for w, d in zip(ws, ds)]
    per_m = {}
    for M in INT4_MS:
        xs = {(K, N): torch.randn(_int4_rows(M, N), K, generator=gen).to(dev)
              for K, N, _ in GPT2_INT4}
        before = {f: getattr(int4_matmul, f"{f}_launches") for f in FORMS}
        for K, N, (p, s, _), _ in calls:
            int4_matmul(xs[K, N], p, s, None, K=K, N=N, block_size=32)
        by_form = {f: getattr(int4_matmul, f"{f}_launches") - before[f] for f in FORMS}
        rows = [(_int4_rows(M, N), K, N) for K, N, _, _ in calls]
        nbytes = sum(K * N // 2 + 4 * N * (K // 32) + 4 * m * (K + N) for m, K, N in rows)
        k_ms = timed(lambda: [int4_matmul(xs[K, N], p, s, None, K=K, N=N, block_size=32)
                              for K, N, (p, s, _), _ in calls], iters=10, nbytes=nbytes)
        p_ms = timed(lambda: [int4_matmul_plain(xs[K, N], p.reshape(N, -1), s, None, K=K, N=N,
                                                block_size=32)
                              for K, N, (p, s, _), _ in calls], iters=3, warmup=1, nbytes=nbytes)
        # torch.matmul reads the f32 weights: its own floor.
        lib = timed(lambda: [torch.matmul(xs[K, N], d) for K, N, _, d in calls], iters=10,
                    nbytes=sum(4 * (K * N + m * (K + N)) for m, K, N in rows))
        ops = sum(2.0 * m * K * N for m, K, N in rows)
        bms, by = bound_ms(nbytes, ops, BF16_FLOPS_PER_S)
        print(f"  int4_matmul x49, M={M} (launches by form {json.dumps(by_form)}): kernel "
              f"{fmt(k_ms)}, plain {fmt(p_ms)}, torch.matmul on f32 weights {fmt(lib)}, bound "
              f"{bms:.4f} ms ({by}, operations at the bf16 tensor-core rate)", flush=True)
        unit = (f"one GPT-2 124M forward at M = {M}: 49 calls" if M != 2048 else
                "one GPT-2 124M serve admission (16 x 128 rows): 48 calls at M = 2048, "
                "the lm_head at M = 16")
        per_m[M] = {"unit": unit, "max_abs_err": err, "calls_by_form": by_form,
                    **time_keys(k_ms, p_ms, lib), "bound_ms": bms, "bound_by": by}
        del xs
    del layers, deq, calls
    return {
        "name": "int4_matmul", "route": "cuda", "source": "rten_tpu_torch/csrc/int4_matmul.cu",
        "replaces": "rten_tpu/kernels/int4_matmul.py:97", **per_m[1],
        "library_call": "torch.matmul on the pre-dequantized f32 weights (8x the weight bytes; "
                        "not the same function)",
        "other_shapes": [per_m[M] for M in INT4_MS[1:]],
    }


# --- the decode-attention microbenchmark (rten_tpu_torch.tools) ---------------


TOOL = dict(B=32, H=12, cap=256, D=64)  # the tool's default shape (group 1)
TOOL_TL = dict(B=16, H=32, Hkv=4, cap=256, D=64)  # TinyLlama's attention
TOOL_PAST_L2 = 128  # slots at which the tool's f32 KV (201 MB) is 4x the L2


def _tool_inputs(dev, B, H, cap, D, Hkv=None, seed=0):
    """The tool's inputs (numpy default_rng(seed), drawn in its order: q, k,
    v standard normal, lens in [cap // 2, cap - 2)), K/V with Hkv heads."""
    rng = np.random.default_rng(seed)
    Hkv = Hkv or H
    q = torch.as_tensor(rng.standard_normal((B, H, 1, D)), dtype=torch.float32).to(dev)
    k = torch.as_tensor(rng.standard_normal((B, Hkv, cap, D)), dtype=torch.float32).to(dev)
    v = torch.as_tensor(rng.standard_normal((B, Hkv, cap, D)), dtype=torch.float32).to(dev)
    lens = torch.as_tensor(rng.integers(cap // 2, cap - 2, B), dtype=torch.int32).to(dev)
    return q, k, v, lens


def _excess(got, want, rtol, atol):
    """The largest |got - want| beyond atol + rtol |want| (<= 0: within)."""
    got, want = got.float(), want.float()
    return ((got - want).abs() - (atol + rtol * want.abs())).max().item()


def _floor_note(nbytes):
    """How ``timed`` holds a call of ``nbytes`` bytes: to its byte floor, or
    not at all where they fit the L2 (back-to-back calls find them
    there)."""
    floor = byte_floor_ms(nbytes)
    return ("L2-warm: the bytes fit the 50 MB L2, no byte floor" if floor is None
            else f"byte floor {floor:.4f} ms")


def _fold_plan_note(plan):
    return (f"plan: {plan.rows} rows a block x {plan.row_tiles} row tiles, "
            f"{plan.splits} split{'s' if plan.splits > 1 else ''} of {plan.chunk} keys")


def _tool_case(name, form, dev, shape, dt, tag):
    """One kernel of the tool against its plain version on the same inputs
    (failing the run beyond the tolerance), then its time, the plain
    version's and one PyTorch call's, and the byte bound: the bytes this
    call's data needs (rows past lens are not needed, but for the floor,
    which sums them all, and the mean of V of a slot with lens < 0 in
    vpu_attn) and the whole K/V's (the reference's floor). bd/nt: the
    split plan beside the time (the kernel's split counter must agree),
    and bd's SDPA also on the natural contiguous K of the same values
    (``library_contiguous_ms``, the yardstick row 12 is judged by: the kt
    view transposed back costs SDPA a layout pass)."""
    from rten_tpu_torch.kernels.common import sm_count
    from rten_tpu_torch.tools import bench_decode_attn as tb

    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v, lens = _tool_inputs(dev, **shape)
    B, H, _, D = q.shape
    Hkv, cap = k.shape[1], k.shape[2]
    scale = 1.0 / float(np.sqrt(D))
    es = 2 if dt == torch.bfloat16 else 4
    kk, vv = k.to(dt), v.to(dt)
    last = lens.long().clamp(max=cap - 1)
    kv_all = 2 * B * Hkv * cap * D * es
    io = B * H * D * 4 * 2 + 4 * B  # q read, out written, lens
    plan, extra = None, {}
    if form == "floor":
        args, kern, plain = (q, k, v, lens), tb.dma_floor, tb.dma_floor_plain
        rtol, atol = 1e-5, 1e-4
        nbytes, ops = kv_all + B * D * 8 + 4 * B, 2.0 * B * Hkv * cap * D
        lib_bytes = kv_all + 2 * B * D * 4
        lib_name = "torch.sum over K and torch.sum over V (two calls)"
        lib = lambda: (torch.sum(k, (1, 2)), torch.sum(v, (1, 2)))  # noqa: E731
    else:
        bk = cap  # block_k 256 >= cap at these shapes
        rows = (last + 1).clamp(min=0)
        kdims = None
        if form == "vpu":
            args, kern = (q, k, v, lens), lambda *a: tb.vpu_attn(*a, scale)
            plain = lambda *a: tb.vpu_attn_plain(*a, scale)  # noqa: E731
            kv_rows = (2 * rows + (lens < 0).long() * cap).sum().item()
        else:
            kx = kk.transpose(2, 3).contiguous() if form == "bd" else kk
            args = (q, kx, vv, lens)
            kern = lambda *a: (tb.bd_decode if form == "bd" else tb.nt_decode)(  # noqa: E731
                *a, scale=scale)
            plain = lambda *a: (tb.bd_decode_plain if form == "bd"  # noqa: E731
                                else tb.nt_decode_plain)(*a, scale=scale)
            kv_rows = 2 * rows.clamp(max=(cap // bk) * bk).sum().item()
            kdims = kx
            plan = tb.fold_plan(B, H, Hkv, cap, D, dt, bk, sm_count(0))
        rtol, atol = (2e-2, 5e-3) if dt == torch.bfloat16 else (0.0, 1e-5)
        nbytes = io + kv_rows * Hkv * D * es
        ops = 2.0 * kv_rows * D * H  # 2 flops a K or V element, for each query head
        mask = (torch.arange(cap, device=dev)[None, :] <= last[:, None])[:, None, None, :]
        qs = q.to(dt)
        ks = kdims.transpose(2, 3) if form == "bd" else kk
        lib_bytes = sdpa_bytes(qs, rows.sum().item(), Hkv, D, es)
        lib_name = (f"scaled_dot_product_attention{'(enable_gqa=True)' if Hkv != H else ''} "
                    f"on the same {'bf16 q, ' if dt == torch.bfloat16 else ''}K/V"
                    f"{' (kt transposed back)' if form == 'bd' else ''} with the mask")
        lib = lambda: sdpa(qs, ks, vv, attn_mask=mask, enable_gqa=Hkv != H)  # noqa: E731
    fn = {"bd": tb.bd_decode, "nt": tb.nt_decode, "vpu": tb.vpu_attn}.get(form)
    splits = plan.splits if plan else tb.vpu_plan(B, H, cap, sm_count(0))[0]
    splits_before = fn.split_launches if fn else 0
    got = kern(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    if fn and fn.split_launches - splits_before != int(splits > 1):
        fail(f"{name} [{tag}]: the split counter moved by {fn.split_launches - splits_before} "
             f"for a plan of {splits} splits")
    bad = _excess(got, want, rtol, atol)
    err = (got.float() - want.float()).abs().max().item()
    if not bad <= 0:
        fail(f"{name} [{tag}]: max err {err} beyond rtol {rtol}, atol {atol}")
    k_ms = timed(lambda: kern(*args), iters=20, nbytes=nbytes)
    p_ms = timed(lambda: plain(*args), iters=5, warmup=1, nbytes=nbytes)
    l_ms = timed(lib, iters=20, nbytes=lib_bytes)
    note = (f"; {_fold_plan_note(plan)}" if plan else
            f"; {splits} split{'s' if splits > 1 else ''}" if form == "vpu" else "")
    if form == "bd":
        c_ms = timed(lambda: sdpa(qs, kk, vv, attn_mask=mask, enable_gqa=Hkv != H), iters=20,
                     nbytes=lib_bytes)
        extra = {"library_contiguous_ms": ms_of(c_ms), "library_contiguous_wall_ms": c_ms[1],
                 "library_contiguous_call": lib_name.replace(" (kt transposed back)",
                                                             " (natural contiguous K)")}
        note += f"; sdpa on contiguous K {fmt(c_ms)}"
    peak = BF16_FLOPS_PER_S if dt == torch.bfloat16 else F32_FLOPS_PER_S
    bms, by = bound_ms(nbytes, ops, peak)
    full_ms = (kv_all + io) / HBM_BYTES_PER_S * 1e3
    warm = byte_floor_ms(nbytes) is None
    print(f"  {name} [{tag}] ({_floor_note(nbytes)}): kernel {fmt(k_ms)}, plain {fmt(p_ms)}, "
          f"library {fmt(l_ms)}{note}, bound {bms:.4f} ms ({by}; whole K/V {full_ms:.4f}), "
          f"max err {err:.3e}", flush=True)
    return {"unit": f"one call, {tag}", "max_abs_err": err, "tolerance": [rtol, atol],
            **time_keys(k_ms, p_ms, l_ms), "bound_ms": bms, "bound_by": by,
            "whole_kv_bound_ms": full_ms, "l2_warm": warm, "library_call": lib_name, **extra,
            **({"plan": plan._asdict()} if plan else {})}


def phase_decode_attn_tool(dev):
    """The decode-attention microbenchmark (kernel rows 10-13).

    1. Each of its four kernels against its plain version on the tool's
       inputs (seeded as the tool seeds them) at the tool's shape (slots 32,
       H 12, cap 256, D 64; bd/nt on f32 and bf16 K/V) and, for bd/nt, at
       TinyLlama's attention (slots 16, H 32 over 4, D 64): the time of the
       kernel, of its plain version and of one PyTorch call, beside the byte
       bound; bd/nt with their split plan (``fold_plan``) and bd's SDPA
       also on natural contiguous K; vpu also at slots 8 (96 (slot, head)
       pairs, its keys split over blocks by ``vpu_plan``). The tool's f32 KV (50.3 MB) fits the
       H100's 50 MB L2, so back-to-back calls there are L2-warm (printed
       so, and held to no byte floor); each case is timed again at slots
       128 (201 MB f32), past the L2.
    2. The tool itself, ``main([])`` in-process at its default shape, with
       the four kernels' launch counters zeroed just before and read just
       after: each must have launched, and each formulation's maxerr
       against the port's fold must be within the f32 (1e-4) or bf16
       (5e-2) bound. Returns the four kernel rows."""
    from rten_tpu_torch.kernels.common import sm_count
    from rten_tpu_torch.tools import bench_decode_attn as tb

    kernels = (("dma_floor", "floor", 51), ("vpu_attn", "vpu", 89),
               ("bd_decode", "bd", 214), ("nt_decode", "nt", 318))
    past = dict(TOOL, B=TOOL_PAST_L2)
    rows = []
    for name, form, line in kernels:
        cases = {"f32": _tool_case(name, form, dev, TOOL, torch.float32, "tool shape, f32")}
        cases["f32 slots 128"] = _tool_case(name, form, dev, past, torch.float32,
                                            "slots 128, f32")
        if form == "vpu":
            cases["f32 slots 8"] = _tool_case(name, form, dev, dict(TOOL, B=8), torch.float32,
                                              "slots 8 (split), f32")
        if form in ("bd", "nt"):
            cases["bf16"] = _tool_case(name, form, dev, TOOL, torch.bfloat16, "tool shape, bf16")
            cases["bf16 slots 128"] = _tool_case(name, form, dev, past, torch.bfloat16,
                                                 "slots 128, bf16")
            for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
                cases[f"TinyLlama {tag}"] = _tool_case(name, form, dev, TOOL_TL, dt,
                                                       f"TinyLlama attention, {tag}")
        torch.cuda.empty_cache()
        source = "rten_tpu_torch/csrc/bench_decode_attn.cu"
        if form in ("bd", "nt"):
            source += " (fold_split_kernel; its note, 3. bd_decode and 4. nt_decode)"
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": f"tools/bench_decode_attn.py:{line}", **cases["f32"],
                     "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
                     "other_shapes": {k: c for k, c in cases.items() if k != "f32"}})
    # A bf16 q (the output bf16): each of bd/nt against its plain version on
    # f32 and bf16 K/V at the tool's shape, then the kernel's time, the plain
    # version's and SDPA's on the same bf16 q and K/V, beside the byte bound.
    q, k, v, lens = _tool_inputs(dev, **TOOL)
    B, Hq, _, Dh = q.shape
    scale = 1.0 / float(np.sqrt(Dh))
    rows_read = (lens.long().clamp(max=TOOL["cap"] - 1) + 1).clamp(min=0).sum().item()
    mask = (torch.arange(TOOL["cap"], device=dev)[None, :]
            <= lens.long().clamp(max=TOOL["cap"] - 1)[:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for row, (kern, plain) in zip(rows[2:], ((tb.bd_decode, tb.bd_decode_plain),
                                             (tb.nt_decode, tb.nt_decode_plain))):
        errs, times = {}, {}
        for dt, (rtol, atol) in ((torch.float32, (2.0 ** -7, 1e-5)),
                                 (torch.bfloat16, (2e-2, 5e-3))):
            tag = str(dt).split(".")[1]
            kk = k.to(dt).transpose(2, 3).contiguous() if kern is tb.bd_decode else k.to(dt)
            args = (q.to(torch.bfloat16), kk, v.to(dt), lens)
            plan = tb.fold_plan(B, Hq, k.shape[1], TOOL["cap"], Dh, dt, 256, sm_count(0))
            got = kern(*args, scale=scale)
            want = plain(*args, scale=scale)
            torch.cuda.synchronize()
            errs[tag] = (got.float() - want.float()).abs().max().item()
            if got.dtype != torch.bfloat16 or not _excess(got, want, rtol, atol) <= 0:
                fail(f"{row['name']} with a bf16 q on {dt} K/V: {got.dtype}, max err "
                     f"{errs[tag]} beyond rtol {rtol}, atol {atol}")
            es = 2 if dt == torch.bfloat16 else 4
            nbytes = B * Hq * Dh * 2 * 2 + 4 * B + 2 * rows_read * k.shape[1] * Dh * es
            k_ms = timed(lambda: kern(*args, scale=scale), iters=20, nbytes=nbytes)
            p_ms = timed(lambda: plain(*args, scale=scale), iters=5, warmup=1, nbytes=nbytes)
            # SDPA takes one dtype: the K/V in the query's bf16 (natural,
            # contiguous K for bd too).
            kb, vb = k.to(torch.bfloat16), v.to(torch.bfloat16)
            l_ms = timed(lambda: sdpa(args[0], kb, vb, attn_mask=mask), iters=20,
                         nbytes=sdpa_bytes(args[0], rows_read, k.shape[1], Dh, 2))
            bms, by = bound_ms(nbytes, 4.0 * rows_read * Hq * Dh, BF16_FLOPS_PER_S)
            times[tag] = {**time_keys(k_ms, p_ms, l_ms), "bound_ms": bms, "bound_by": by,
                          "plan": plan._asdict()}
            print(f"  {row['name']} [bf16 q, bf16 out, tool shape, {tag} K/V] "
                  f"({_floor_note(nbytes)}; {_fold_plan_note(plan)}): kernel {fmt(k_ms)}, "
                  f"plain {fmt(p_ms)}, sdpa on bf16 K/V (contiguous) {fmt(l_ms)}, bound "
                  f"{bms:.4f} ms ({by}), max err {errs[tag]:.3e}", flush=True)
        row["bf16_q_max_abs_err"] = errs
        row["bf16_q"] = times
    print("  the tool (python3 -m rten_tpu_torch.tools.bench_decode_attn, in-process):",
          flush=True)
    splitting = (tb.vpu_attn, tb.bd_decode, tb.nt_decode)
    for fn in tb.KERNELS:
        fn.launches = 0
    for fn in splitting:
        fn.split_launches = 0
    torch.cuda.synchronize()
    res = tb.main([])
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in tb.KERNELS}
    split_launches = {fn.__name__: fn.split_launches for fn in splitting}
    print(f"  tool launches: {json.dumps(launches)}; of them split over blocks "
          f"{json.dumps(split_launches)} (the tool's shape takes one split)", flush=True)
    for name, n in launches.items():
        if n == 0:
            fail(f"the tool's run never launched {name}")
    for label, bound in (("VPU-vectorized kernel", 1e-4), ("blockdiag kernel (K^T)", 1e-4),
                         ("NT natural-layout kernel", 1e-4), ("blockdiag bf16 (K^T)", 5e-2)):
        if not res[label + " maxerr"] <= bound:
            fail(f"the tool's {label}: maxerr {res[label + ' maxerr']} against the fold > {bound}")
    for row in rows:
        row["launches"] = launches[row["name"]]
        row["launches_by_path"] = {"bench_decode_attn": row["launches"]}
        if row["name"] in split_launches:
            row["split_launches"] = split_launches[row["name"]]
    return rows


# --- serve and reference phases -----------------------------------------------


def kv_options(kv):
    """The builders' cache options for ``kv``: "s8" (int8 with scales),
    "bf16" or "f32" (no scales), "int4" (nibbles with scales); with the
    suffix "-deferred" (f32 window) or "-deferred-bf16" (bf16 window) the
    deferred-KV graph."""
    from rten_tpu_torch.dtypes import DataType

    base, _, deferred = kv.partition("-")
    opts = {"s8": dict(kv_quant=True), "f32": dict(kv_quant=False),
            "bf16": dict(kv_quant=False, kv_dtype=DataType.BFloat16),
            "int4": dict(kv_quant=True, kv_bits=4)}[base]
    if deferred:
        opts["deferred_kv"] = True
        if deferred.endswith("bf16"):
            opts["recent_dtype"] = DataType.BFloat16
    return opts


_WEIGHTS = {}


def random_weights(module, cfg):
    """``module.random_weights(cfg, seed=0)`` (GPT-2 or Llama), kept for the
    run (a few GB of host memory): a reference check builds the same model
    on the CPU and then on the card, and the TinyLlama and Qwen references
    take the serve phases' weights."""
    key = (module.__name__, repr(cfg))
    if key not in _WEIGHTS:
        _WEIGHTS[key] = module.random_weights(cfg, seed=0)
    return _WEIGHTS[key]


def build_model(n_layer, capacity, device, vocab=VOCAB, n_embd=E, n_head=H, kv="s8",
                gather_last=True, quantize=True, **options):
    """GPT-2 through the user's entry points, on ``kv`` cat caches (int4
    and deferred-KV caches are head-major: no in-kernel append there), int8
    weights unless ``quantize`` is false; ``options``: the builder's
    paged_blocks and block_size for the paged cat pools, lora_rank and
    n_adapters."""
    from rten_tpu_torch.model import Model
    from rten_tpu_torch.models import gpt2
    from rten_tpu_torch.quantize_pass import quantize_dynamic

    cfg = gpt2.GPT2Config(vocab_size=vocab, n_layer=n_layer, n_embd=n_embd, n_head=n_head)
    weights = random_weights(gpt2, cfg)
    graph = gpt2.build_graph_static_cache(
        cfg, weights, capacity=capacity, gather_last=gather_last,
        kernel_append=not kv.startswith("int4") and "deferred" not in kv,
        **kv_options(kv), **options,
    )
    if quantize:
        quantize_dynamic(graph)
    return Model(graph, device=device)


class FormCounter:
    """A wrapper's launches of one of its kernels (``fn.<attr>``, which
    ``fn.launches`` also counts) as a counter of their own: decode_mha_folded's
    CUDA-core kernel (f32 caches and windows, D 129-512), decode_mha_heads'
    and prefill_mha_cat's wide kernel (D 129-512) and 3xTF32 kernel (f32
    caches at D <= 128), mha's CUDA-core kernel (D 129-256), int4_matmul's and
    int8_matmul_dequant's forms."""

    def __init__(self, fn, attr):
        self.fn, self.attr = fn, attr

    @property
    def launches(self):
        return getattr(self.fn, self.attr)

    @launches.setter
    def launches(self, n):
        setattr(self.fn, self.attr, n)


def counters():
    from rten_tpu_torch.kernels import argmax, flash_attention, int4_matmul, int8_matmul

    return {
        "int4_matmul": int4_matmul.int4_matmul,
        "mha": flash_attention.mha,
        "int8_matmul_dequant": int8_matmul.int8_matmul_dequant,
        "decode_mha_append_cat": flash_attention.decode_mha_append_cat,
        "prefill_mha_cat": flash_attention.prefill_mha_cat,
        "argmax_lastdim": argmax.argmax_lastdim,
        "decode_mha_folded": flash_attention.decode_mha_folded,
        "decode_mha_heads": flash_attention.decode_mha_heads,
        "decode_mha_folded_cuda_core": FormCounter(flash_attention.decode_mha_folded,
                                                   "cuda_core_launches"),
        "decode_mha_heads_wide": FormCounter(flash_attention.decode_mha_heads,
                                             "wide_launches"),
        "decode_mha_heads_tf32": FormCounter(flash_attention.decode_mha_heads, "tf32_launches"),
        "prefill_mha_cat_wide": FormCounter(flash_attention.prefill_mha_cat, "wide_launches"),
        "prefill_mha_cat_tf32": FormCounter(flash_attention.prefill_mha_cat, "tf32_launches"),
        **{f"int4_matmul_{form}": FormCounter(int4_matmul.int4_matmul, f"{form}_launches")
           for form in int4_matmul.FORMS},
        **{f"int8_matmul_dequant_{form}": FormCounter(int8_matmul.int8_matmul_dequant,
                                                      f"{form}_launches")
           for form in (*int8_matmul.FORMS, "int32")},
        "mha_cuda_core": FormCounter(flash_attention.mha, "cuda_core_launches"),
        "paged_decode_mha": flash_attention.paged_decode_mha,
        "decode_mha_append_cat_paged": flash_attention.decode_mha_append_cat_paged,
        "decode_mha_append": flash_attention.decode_mha_append,
    }


def serve(engine, prompts, budgets, vocab, want_per_forward, tag, on_zero=None):
    """Serve one warm-up request (the first forward uploads the weights),
    then zero every launch counter (and call ``on_zero``), serve the
    requests, read the counters:
    each must equal ``want_per_forward(decode steps, admissions)`` (0 for
    the kernels this path does not run), and every kernel the path runs
    must have launched. Returns (requests, wall seconds, forwards,
    launches)."""
    t0 = time.perf_counter()
    engine.submit(prompts[0], max_new_tokens=2)
    engine.run()
    torch.cuda.synchronize()
    print(f"  warm-up [{tag}]: one request in {time.perf_counter() - t0:.3f} s "
          f"(weights uploaded)", flush=True)
    steps0 = engine.steps
    torch.cuda.reset_peak_memory_stats()
    for fn in counters().values():
        fn.launches = 0
    if on_zero is not None:
        on_zero()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [engine.submit(p, max_new_tokens=n) for p, n in zip(prompts, budgets)]
    engine.run()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    steps = engine.steps - steps0
    launches = {k: fn.launches for k, fn in counters().items()}
    for r, n in zip(reqs, budgets):
        if not r.done or len(r.generated) != n or r.error:
            fail(f"{tag} request {r.request_id}: {len(r.generated)} of {n} tokens")
        if not all(0 <= t < vocab for t in r.generated):
            fail(f"{tag} request {r.request_id}: token out of range")
    # One admission stamps the first token of all its requests at once.
    admissions = len({r.first_token_at for r in reqs})
    want = want_per_forward(steps, admissions)
    for k, n in launches.items():
        if n != want.get(k, 0):
            fail(f"{tag}: {k} launched {n} times on the served path, expected "
                 f"{want.get(k, 0)}")
        if k in want and n == 0:
            fail(f"{tag}: {k} never launched on the served path")
    toks = sum(len(r.generated) for r in reqs)
    forwards = steps + admissions
    print(f"  serve [{tag}]: {len(reqs)} requests, {toks} tokens in {elapsed:.3f} s = "
          f"{toks / elapsed:.1f} tok/s, TTFT p50 "
          f"{statistics.median(r.ttft_s for r in reqs) * 1e3:.1f} ms, {admissions} "
          f"admissions, {steps} decode steps, host wall per forward "
          f"{elapsed / forwards * 1e3:.3f} ms, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print(f"  serve launches [{tag}]: {json.dumps(launches)}", flush=True)
    check_pool(engine, tag)
    return reqs, elapsed, forwards, launches


def check_pool(engine, tag):
    """A paged engine with no work left holds no block: all but block 0
    are back in the free list and the table is all 0."""
    if not engine.paged:
        return
    if sorted(engine._free_blocks) != list(range(1, engine.n_blocks)) or engine.block_table.any():
        fail(f"{tag}: {len(engine._free_blocks)} of {engine.n_blocks - 1} blocks free at the end")
    print(f"  pool [{tag}]: all {engine.n_blocks - 1} usable blocks free at the end", flush=True)


# Each GPT-2 serve phase's tokens and numbers by tag, for the tensor-parallel
# phase to hold its own against.
SERVE_TOKENS, SERVE_NUMBERS = {}, {}


def serve_numbers(reqs, elapsed, forwards):
    """TTFT p50, tok/s and host wall per forward of a served wave."""
    toks = sum(len(r.generated) for r in reqs)
    return {"ttft_p50_ms": statistics.median(r.ttft_s for r in reqs) * 1e3,
            "tok_per_s": toks / elapsed, "wall_ms_per_forward": elapsed / forwards * 1e3}


# The paged serve phases' pool: 40 usable blocks of 64 rows. A request of
# 128 prompt tokens and up to 48 new ones reserves ceil((128 + 48 + 2 * 8)
# / 64) = 3 blocks, so at most 13 of the 16 slots run at once.
PAGED = dict(paged_blocks=41, block_size=BLOCK)


def phase_serve(dev, paged=False, kv="s8"):
    """GPT-2 124M at full width, int8 weights, behind the engine: ``kv`` cat
    KV caches (``bench.py``'s default int8, its RTEN_BENCH_KV=bf16), or
    (``paged``) paged cat pools with the block-table append."""
    from rten_tpu_torch.serving import ContinuousBatchingEngine

    model = build_model(12, CAP, dev, kv=kv, **(PAGED if paged else {}))
    engine = ContinuousBatchingEngine(
        model, n_layer=12, n_head=H, head_dim=D, slots=16, capacity=CAP,
        prefill_bucket=128, greedy_on_device=True, steps_per_dispatch=8,
    )
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, VOCAB, PROMPT).tolist() for _ in range(24)]
    budgets = [int(rng.integers(16, 49)) for _ in range(24)]
    if paged:  # admissions gather the pools, then decode_mha (per head; bf16 pools widened
        # to f32, as the reference widens them, run in 3xTF32 on tensor cores)
        want = lambda steps, adm: {  # noqa: E731
            "int8_matmul_dequant": 49 * (steps + adm),
            # decode steps (16 rows) and the admissions' lm_head (one row a
            # slot) on the stream form, the admissions' 48 projections tiled
            "int8_matmul_dequant_stream": 49 * steps + adm,
            "int8_matmul_dequant_tiled": 48 * adm,
            "decode_mha_append_cat_paged": 12 * steps,
            "decode_mha_heads": 12 * adm,
            **({"decode_mha_heads_tf32": 12 * adm} if kv == "bf16" else {}),
            "argmax_lastdim": steps + adm,
        }
    else:
        want = lambda steps, adm: {  # noqa: E731
            "int8_matmul_dequant": 49 * (steps + adm),
            # decode steps (16 rows) and the admissions' lm_head (one row a
            # slot) on the stream form, the admissions' 48 projections tiled
            "int8_matmul_dequant_stream": 49 * steps + adm,
            "int8_matmul_dequant_tiled": 48 * adm,
            "decode_mha_append_cat": 12 * steps,
            "prefill_mha_cat": 12 * adm,
            "argmax_lastdim": steps + adm,
        }
    tag = "GPT-2" + ("" if kv == "s8" else f" {kv}") + (" paged" if paged else "")
    reqs, elapsed, forwards, launches = serve(engine, prompts, budgets, VOCAB, want, tag)
    SERVE_TOKENS[tag] = [r.generated for r in reqs]
    SERVE_NUMBERS[tag] = serve_numbers(reqs, elapsed, forwards)
    SERVE_NUMBERS[tag]["busy_ms_per_forward"] = (
        profile_wave(engine, prompts[:16], elapsed / forwards) or (None,))[0]
    check_pool(engine, tag)
    return launches


def phase_serve_int4(dev):
    """GPT-2 124M at full width behind the engine as ``phase_serve`` runs it,
    on the int4 weight-only graph (``bench.py``'s RTEN_BENCH_QUANT=int4:
    the serving graph, then quantize_weight_only_int4): int8 cat KV caches,
    49 MatMulNBits per forward."""
    from rten_tpu_torch.model import Model
    from rten_tpu_torch.models import gpt2
    from rten_tpu_torch.quantize_pass import quantize_weight_only_int4
    from rten_tpu_torch.serving import ContinuousBatchingEngine

    cfg = gpt2.GPT2Config()
    graph = gpt2.build_graph_static_cache(cfg, gpt2.random_weights(cfg, seed=0), capacity=CAP,
                                          kv_quant=True, kernel_append=True, gather_last=True)
    quantize_weight_only_int4(graph)
    engine = ContinuousBatchingEngine(
        Model(graph, device=dev), n_layer=12, n_head=H, head_dim=D, slots=16, capacity=CAP,
        prefill_bucket=128, greedy_on_device=True, steps_per_dispatch=8,
    )
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, VOCAB, PROMPT).tolist() for _ in range(24)]
    budgets = [int(rng.integers(16, 49)) for _ in range(24)]
    # Decode steps (16 rows) and the admissions' lm_head (one row a slot) on
    # the stream form, the admissions' 48 projections (16 x 128 rows) tiled.
    want = lambda steps, adm: {  # noqa: E731
        "int4_matmul": 49 * (steps + adm),
        "int4_matmul_stream": 49 * steps + adm,
        "int4_matmul_tiled": 48 * adm,
        "decode_mha_append_cat": 12 * steps,
        "prefill_mha_cat": 12 * adm,
        "argmax_lastdim": steps + adm,
    }
    _, elapsed, forwards, launches = serve(engine, prompts, budgets, VOCAB, want, "GPT-2 int4")
    profile_wave(engine, prompts[:16], elapsed / forwards)
    return launches


def phase_serve_int4_kv(dev):
    """GPT-2 124M at full width behind the engine on ``bench.py``'s
    RTEN_BENCH_KV=int4 graph: int8 weights, int4 head-major KV caches,
    deferred KV with bf16 recent windows (decode steps through the fold's
    window mode, admissions through the per-head form on int4 caches, the
    windows committed once per dispatch)."""
    from rten_tpu_torch.serving import ContinuousBatchingEngine

    model = build_model(12, CAP, dev, kv="int4-deferred-bf16")
    engine = ContinuousBatchingEngine(
        model, n_layer=12, n_head=H, head_dim=D, slots=16, capacity=CAP,
        prefill_bucket=128, greedy_on_device=True, steps_per_dispatch=8,
    )
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, VOCAB, PROMPT).tolist() for _ in range(24)]
    budgets = [int(rng.integers(16, 49)) for _ in range(24)]
    want = lambda steps, adm: {  # noqa: E731
        "int8_matmul_dequant": 49 * (steps + adm),
        "int8_matmul_dequant_stream": 49 * steps + adm,
        "int8_matmul_dequant_tiled": 48 * adm,
        "decode_mha_folded": 12 * steps,
        "decode_mha_heads": 12 * adm,
        "argmax_lastdim": steps + adm,
    }
    _, elapsed, forwards, launches = serve(engine, prompts, budgets, VOCAB, want,
                                           "GPT-2 int4 KV, deferred")
    profile_wave(engine, prompts[:16], elapsed / forwards)
    return launches


# The tensor-parallel serve phase: GPT-2 124M int8 over two ranks on one
# card. Each rank's shapes: 6 of the 12 heads, c_attn N 1152 (its heads of
# q, k and v), c_fc N 1536, the row-parallel c_proj at K 384 and 1536, and
# 25152 of the lm_head's 50304 padded columns.
TP_RANKS = 2
TP_GROUP_TIMEOUT_S = 120   # every collective of a rank's group
TP_WAIT_S = 300            # the parent's wait for both ranks
NP_TP = -(-VOCAB // 128) * 128  # the int8 prepack's padded lm_head: 50304 columns
TP_HEADS, TP_VOCAB_SHARD = H // TP_RANKS, NP_TP // TP_RANKS
TP_INT8 = [(768, 3 * E // TP_RANKS, 12, False), (E // TP_RANKS, 768, 12, True),
           (768, 4 * E // TP_RANKS, 12, False), (4 * E // TP_RANKS, 768, 12, True),
           (768, TP_VOCAB_SHARD, 1, False)]


def tp_kernel_holds(gen, dev):
    """Rows 1-4 at a rank's shapes against their plain versions: row 1 in
    every form (stream at the 16 slots of a decode step, rows at 120,
    tiled at an admission's 2048 rows), in the f32 mode for the column-
    parallel products and the int32 mode for the row-parallel ones, bit for
    bit; rows 2 and 3 at 6 heads within their tolerances; row 4 on a
    rank's vocabulary shard. Returns {row name: [other_shapes entries]}."""
    slots = 16
    step = [_int8_case(gen, dev, slots, K, N, f"GPT-2 TP rank{' int32' if i32 else ''}",
                       int32=i32) | {"calls": n} for K, N, n, i32 in TP_INT8]
    adm = [_int8_case(gen, dev, slots * PROMPT, K, N, "GPT-2 TP rank admission", int32=i32)
           | {"calls": n} for K, N, n, i32 in TP_INT8[:-1]]
    for K, N, _, i32 in TP_INT8[:-1]:  # the rows form, untimed
        _int8_case(gen, dev, SLOTS, K, N, "GPT-2 TP rank, rows form", time_it=False, int32=i32)

    def unit(rows, what):
        tot = {k: sum(r[k] * r["calls"] for r in rows)
               for k in ("ms", "plain_ms", "bound_ms", "wall_ms", "plain_wall_ms")}
        libs = [r["library_ms"] for r in rows]
        lib = None if None in libs else sum(l * r["calls"] for l, r in zip(libs, rows))
        by_bytes = sum(r["bound_ms"] * r["calls"] for r in rows if r["bound_by"] == "bytes")
        return {"unit": what, "form": rows[0]["form"], "max_abs_err": 0.0, **tot,
                "bound_by": "bytes" if 2 * by_bytes >= tot["bound_ms"] else "operations",
                "library_ms": lib, "int32_mode_calls": sum(r["calls"] for r in rows
                                                           if r["int32_mode"]),
                "calls": [r["unit"] for r in rows]}

    holds = {"int8_matmul_dequant": [
        unit(step, f"one decode step of a tensor-parallel rank (MeshConfig(1, {TP_RANKS})) at "
                   f"slots {slots}: 49 calls, 24 of them in the int32 mode"),
        unit(adm, f"one admission of a tensor-parallel rank at M {slots * PROMPT}: 48 calls, "
                  f"24 in the int32 mode")]}
    holds["decode_mha_append_cat"] = [_decode_append_case(
        gen, dev, slots, CAP, 128, 192, f"one decode step of a tensor-parallel rank: "
        f"{TP_HEADS} heads, slots {slots}, cap {CAP}: 12 calls", heads=TP_HEADS, plan_kv_heads=H)]
    holds["prefill_mha_cat"] = [_prefill_cat_case(
        gen, dev, slots, CAP, f"one admission of a tensor-parallel rank: {TP_HEADS} heads, "
        f"{slots} x {PROMPT} tokens: 12 calls", heads=TP_HEADS)]
    arg = phase_argmax(gen, dev, slots, TP_VOCAB_SHARD, TP_VOCAB_SHARD)
    holds["argmax_lastdim"] = [{k: arg[k] for k in (
        "unit", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "wall_ms", "plain_wall_ms", "library_wall_ms")}]
    holds["argmax_lastdim"][0]["unit"] += " (a tensor-parallel rank's vocabulary shard)"
    torch.cuda.empty_cache()
    return holds


def tp_want(steps, adm):
    """A rank's launches on the served wave: every product on the int8
    kernel (the 24 row-parallel ones in the int32 mode), the attention
    kernels at 6 heads, and the sharded arg-max's local argmax."""
    return {
        "int8_matmul_dequant": 49 * (steps + adm),
        "int8_matmul_dequant_stream": 49 * steps + adm,
        "int8_matmul_dequant_tiled": 48 * adm,
        "int8_matmul_dequant_int32": 24 * (steps + adm),
        "decode_mha_append_cat": 12 * steps,
        "prefill_mha_cat": 12 * adm,
        "argmax_lastdim": steps + adm,
    }


def tp_rank(rank, store, out_path):
    """One rank of the tensor-parallel phase (``chip_smoke.py --tp-rank R
    STORE OUT``): gloo, named explicitly (NCCL refuses two ranks of one
    communicator on one card), rendezvous through the file ``STORE``, the
    group's timeout finite; the main path's graph (GPT-2 124M,
    build_graph_static_cache(kv_quant, kernel_append, gather_last),
    quantize_dynamic, the int8 prepack), cut by the derived plan over
    MeshConfig(1, 2), served by the engine as ``phase_serve`` serves it (the
    warm-up request, then its 24 requests), then one profiled wave. Writes
    its tokens, launches, collectives and numbers to ``OUT`` as JSON."""
    from rten_tpu_torch.ops import collective
    from rten_tpu_torch.parallel import (
        MeshConfig, init_distributed, make_mesh, shard_constants_by_plan, tp_weight_shardings,
    )
    from rten_tpu_torch.serving import ContinuousBatchingEngine

    t0 = time.perf_counter()
    init_distributed(backend="gloo", init_method=f"file://{store}", world_size=TP_RANKS,
                     rank=rank, timeout=TP_GROUP_TIMEOUT_S)
    dev = torch.device("cuda:0")
    mesh = make_mesh(MeshConfig(1, TP_RANKS), device=dev)
    model = build_model(12, CAP, dev)
    params = shard_constants_by_plan(model.graph, mesh, tp_weight_shardings(model.graph, mesh))
    roles = params.model.roles
    engine = ContinuousBatchingEngine(
        model, n_layer=12, n_head=H, head_dim=D, slots=16, capacity=CAP,
        prefill_bucket=128, greedy_on_device=True, steps_per_dispatch=8, params=params,
    )
    cache = [list(shape) for shape, _ in engine._cache_alloc[:4]]
    print(f"  rank {rank}: {sum(r == 'col' for r in roles.values())} column- and "
          f"{sum(r == 'row' for r in roles.values())} row-parallel products, caches "
          f"{cache}, ready in {time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, VOCAB, PROMPT).tolist() for _ in range(24)]
    budgets = [int(rng.integers(16, 49)) for _ in range(24)]
    reqs, elapsed, forwards, launches = serve(engine, prompts, budgets, VOCAB, tp_want,
                                              f"GPT-2 TP rank {rank}",
                                              on_zero=collective.reset_stats)
    coll = {k: list(v) for k, v in collective.STATS.items()}
    numbers = serve_numbers(reqs, elapsed, forwards)
    busy = profile_wave(engine, prompts[:16], elapsed / forwards)
    numbers["busy_ms_per_forward"] = None if busy is None else busy[0]
    json.dump({"tokens": [r.generated for r in reqs], "launches": launches,
               "collectives": coll, "forwards": forwards, "numbers": numbers,
               "roles": sorted(roles.values())}, open(out_path, "w"))
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


def phase_tensor_parallel(dev, gen):
    """GPT-2 124M int8 served tensor-parallel over two ranks on this one
    card (``tp_rank``), after rows 1-4 are held at a rank's shapes
    (``tp_kernel_holds``). Both ranks' tokens must equal the unsharded
    ``gpt2_serve`` phase's on the card, request for request (the int8
    forward of a rank is bit-equal to the unsharded one: the int32
    partials are all-reduced before the dequantisation). Prints each rank's
    launches by row and form, the collectives a forward and their host ms,
    and rank 0's TTFT, tok/s, host wall and busy per forward beside the
    unsharded phase's. Returns (rank 0's launches, the holds)."""
    import tempfile

    want = SERVE_TOKENS.get("GPT-2")
    if want is None:
        fail("tensor-parallel phase: the unsharded gpt2_serve phase's tokens are missing")
    holds = tp_kernel_holds(gen, dev)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as tmp:
        store = os.path.join(tmp, "store")
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(TP_RANKS)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--tp-rank", str(r), store, outs[r]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(TP_RANKS)]
        logs = []
        deadline = time.perf_counter() + TP_WAIT_S
        try:
            for p in procs:
                try:
                    logs.append(p.communicate(timeout=max(1.0, deadline - time.perf_counter()))[0])
                except subprocess.TimeoutExpired:
                    logs.append("(no end within the wait)")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, (p, log) in enumerate(zip(procs, logs)):
            print(log.rstrip(), flush=True)
            if p.returncode != 0:
                fail(f"tensor-parallel rank {r} failed (rc {p.returncode}):\n{log[-3000:]}")
        res = [json.load(open(o)) for o in outs]
    for r, out in enumerate(res):
        if out["tokens"] != want:
            bad = [i for i, (a, b) in enumerate(zip(out["tokens"], want)) if a != b]
            fail(f"tensor-parallel rank {r}: requests {bad} differ from the unsharded engine's "
                 f"tokens")
        per_fwd = {k: {"calls": c / out["forwards"], "host_ms": t / out["forwards"] * 1e3}
                   for k, (c, t) in out["collectives"].items()}
        out["collectives_per_forward"] = per_fwd
        by_form = {f: out["launches"][f"int8_matmul_dequant_{f}"]
                   for f in ("stream", "rows", "tiled", "int32")}
        print(f"  TP rank {r}: tokens equal to the unsharded engine's, all 24 requests; "
              f"launches: int8_matmul_dequant {out['launches']['int8_matmul_dequant']} "
              f"(by form {json.dumps(by_form)}), decode_mha_append_cat "
              f"{out['launches']['decode_mha_append_cat']}, prefill_mha_cat "
              f"{out['launches']['prefill_mha_cat']}, argmax_lastdim "
              f"{out['launches']['argmax_lastdim']}; collectives a forward "
              f"{json.dumps({k: {q: round(v, 4) for q, v in d.items()} for k, d in per_fwd.items()})}",
              flush=True)
    base = SERVE_NUMBERS.get("GPT-2", {})
    tp = res[0]["numbers"]
    coll_ms = sum(d["host_ms"] for d in res[0]["collectives_per_forward"].values())
    print(f"  TP rank 0 vs unsharded gpt2_serve: TTFT p50 {tp['ttft_p50_ms']:.1f} ms vs "
          f"{base.get('ttft_p50_ms', float('nan')):.1f}, {tp['tok_per_s']:.1f} vs "
          f"{base.get('tok_per_s', float('nan')):.1f} tok/s, host wall per forward "
          f"{tp['wall_ms_per_forward']:.3f} vs {base.get('wall_ms_per_forward', float('nan')):.3f} "
          f"ms, busy per forward {tp['busy_ms_per_forward']} vs "
          f"{base.get('busy_ms_per_forward')} ms; the collectives' host ms a forward "
          f"{coll_ms:.3f}", flush=True)
    print(f"  TP numbers: {json.dumps({'rank0': tp, 'unsharded': base, 'collectives_host_ms_per_forward': coll_ms, 'collectives_per_forward': res[0]['collectives_per_forward']})}",
          flush=True)
    return res[0]["launches"], holds


def generator_prompt(vocab=VOCAB, T=GEN_PROMPT, B=1, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, T))


def phase_generate(dev, quantize):
    """GPT-2 124M at full width (``random_weights(0)``) through the user's
    entry points (``gpt2.load``, ``Generator``): batch 1, a 91-token prompt
    in the bucket of 128, 64 new tokens, greedy; f32 or int4 weight-only
    weights. After a warm-up generation (the first run uploads the weights),
    every launch counter is zeroed, the 64 tokens generated and the
    counters read: mha 12 per prefill, int4_matmul 49 per forward (int4),
    nothing else. TTFT and decode tok/s from the Generator's Metrics; then
    a profiled run of 16 tokens gives the card's busy time per step against
    the host's wall time per step."""
    from rten_tpu_torch.generate import Generator, GeneratorConfig
    from rten_tpu_torch.models import gpt2

    tag = f"GPT-2 generate {quantize or 'f32'}"
    t0 = time.perf_counter()
    model = gpt2.load(gpt2.GPT2Config(), quantize=quantize, seed=0, device=dev)
    prompt = generator_prompt()
    cfg = GeneratorConfig(bucket_size=GEN_BUCKET)
    Generator(model, prompt, cfg).generate(2)
    torch.cuda.synchronize()
    print(f"  build and warm-up [{tag}]: {time.perf_counter() - t0:.1f} s", flush=True)
    for fn in counters().values():
        fn.launches = 0
    gen = Generator(model, prompt, cfg)
    toks = gen.generate(GEN_NEW)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters().items()}
    forwards = 1 + gen.metrics.generated_tokens  # the prefill, then a step per token
    # int4: the prefill (128 rows, the lm_head on every position) tiled, each
    # step (one row) on the stream form.
    want = {"mha": 12, **({"int4_matmul": 49 * forwards, "int4_matmul_tiled": 49,
                           "int4_matmul_stream": 49 * (forwards - 1)}
                          if quantize == "int4" else {})}
    for k, n in launches.items():
        if n != want.get(k, 0):
            fail(f"{tag}: {k} launched {n} times, expected {want.get(k, 0)}")
    if toks.shape != (1, GEN_NEW) or not ((toks >= 0) & (toks < VOCAB)).all():
        fail(f"{tag}: tokens {toks.shape}, in range: {((toks >= 0) & (toks < VOCAB)).all()}")
    m = gen.metrics
    wall_step = sum(m.step_times_s[1:]) / len(m.step_times_s[1:])
    with card_profile() as prof:
        t0 = time.perf_counter()
        Generator(model, prompt, cfg).generate(16)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    busy = sum(t for _, _, t in device_events(prof)) / 1e3
    print(f"  generate [{tag}]: {GEN_NEW} tokens after a {GEN_PROMPT}-token prompt (bucket "
          f"{GEN_BUCKET}), TTFT {m.ttft_s() * 1e3:.3f} ms, decode {m.tokens_per_sec():.1f} tok/s "
          f"(host wall per step {wall_step * 1e3:.3f} ms); profiled 16 tokens: device busy "
          f"{busy:.3f} ms in {prof_wall * 1e3:.3f} ms wall, busy per forward "
          f"{busy / 17:.3f} ms over its 17 forwards, the prefill included ("
          f"{busy / 17 / (wall_step * 1e3):.3f} of the unprofiled wall per step)", flush=True)
    print(f"  generate launches [{tag}]: {json.dumps(launches)}", flush=True)
    del model
    return launches


def build_llama(n_layer, capacity, device, sharpen=1.0, weights=None, kv="s8",
                head_major_append=False, **options):
    """A Llama-family model through the user's entry points: ``weights``, or
    random weights from seed 0 (the projections scaled by ``sharpen``), the
    serving graph on ``kv`` caches (head-major unless ``options`` say
    kernel_append), int8 weights, and ``Model``. ``options``: LlamaConfig
    fields and builder options. ``head_major_append``: the attention nodes
    of the head-major graph marked ``rten_kernel_append``, which no builder
    emits (decode steps then write and attend through decode_mha_append).
    Returns the model and the seconds each step took."""
    from rten_tpu_torch.model import Model
    from rten_tpu_torch.models import llama
    from rten_tpu_torch.quantize_pass import quantize_dynamic

    fields = set(llama.LlamaConfig.__dataclass_fields__)
    cfg = llama.LlamaConfig(num_hidden_layers=n_layer,
                            **{k: v for k, v in options.items() if k in fields})
    build = {**kv_options(kv), **{k: v for k, v in options.items() if k not in fields}}
    secs = {}
    if weights is None:
        t0 = time.perf_counter()
        weights = {name: w * np.float32(sharpen) if sharpen != 1.0 and "_proj." in name
                   else w for name, w in random_weights(llama, cfg).items()}
        secs["weights"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    graph = llama.build_graph_static_cache(cfg, weights, capacity=capacity,
                                           **{"gather_last": True, **build})
    if head_major_append:
        for _, node in graph.operators():
            if node.op_type in ("QuantizedKVAttention", "GroupQueryAttention"):
                node.attrs = {**node.attrs, "rten_kernel_append": 1}
    secs["graph"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    quantize_dynamic(graph)
    secs["quantize"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = Model(graph, device=device)
    secs["Model (optimize, upload)"] = time.perf_counter() - t0
    return model, secs


def tinyllama_weights():
    """TinyLlama-1.1B's shape at full width, L_CUT_LAYERS deep: random
    weights from seed 0 (one dict for every TinyLlama serve phase)."""
    from rten_tpu_torch.models import llama

    t0 = time.perf_counter()
    weights = random_weights(llama, llama.LlamaConfig(num_hidden_layers=L_CUT_LAYERS))
    print(f"  TinyLlama random weights (seed 0): {time.perf_counter() - t0:.1f} s", flush=True)
    return weights


def phase_serve_llama(dev, weights, paged=False, n_layer=L_CUT_LAYERS, kv="s8",
                      head_major_append=False):
    """TinyLlama-1.1B's shape at full width (``n_layer`` layers of
    ``weights``), int8 weights, ``kv`` head-major KV caches or (``paged``)
    paged head-major pools, behind the engine; with ``head_major_append``
    the decode steps through decode_mha_append (``build_llama``)."""
    tag = "TinyLlama" + ("" if kv == "s8" else f" {kv}") + (" paged" if paged else "")
    tag += (" head-major append" if head_major_append else "") + f" ({n_layer} layers)"
    decode = ("paged_decode_mha" if paged else "decode_mha_append" if head_major_append
              else "decode_mha_folded")
    return serve_llama_family(
        dev, tag, n_layer, L_H, L_D, L_VOCAB,
        dict(weights=weights, kv=kv, head_major_append=head_major_append,
             **(PAGED if paged else {})),
        lambda steps, adm: {
            "int8_matmul_dequant": (7 * n_layer + 1) * (steps + adm),
            "int8_matmul_dequant_stream": (7 * n_layer + 1) * steps + adm,
            "int8_matmul_dequant_tiled": 7 * n_layer * adm,
            decode: n_layer * steps,
            "decode_mha_heads": n_layer * adm,
            "argmax_lastdim": steps + adm,
        })


def phase_serve_qwen(dev):
    """Qwen2.5-1.5B's published shape at full width, Q_SERVE_LAYERS of its
    28 layers (random weights from seed 0), int8 weights, bf16 cat KV caches
    (D 128, group 6: ``prefill_mha_cat`` at admissions,
    ``decode_mha_append_cat`` at decode steps), behind the engine."""
    n = Q_SERVE_LAYERS
    return serve_llama_family(
        dev, f"Qwen2.5-1.5B bf16 cat ({n} layers)", n, Q_H, Q_D, Q_VOCAB,
        dict(QWEN, kv="bf16", kernel_append=True),
        lambda steps, adm: {
            "int8_matmul_dequant": (7 * n + 1) * (steps + adm),
            "int8_matmul_dequant_stream": (7 * n + 1) * steps + adm,
            "int8_matmul_dequant_tiled": 7 * n * adm,
            "decode_mha_append_cat": n * steps,
            "prefill_mha_cat": n * adm,
            "argmax_lastdim": steps + adm,
        })


def serve_llama_family(dev, tag, n_layer, n_head, head_dim, vocab, build_kw, want):
    """A Llama-family model (``build_llama(**build_kw)``) behind the engine:
    16 slots, cap 256, bucket 128, 8 steps per dispatch, 24 requests of 128
    seeded tokens with 16-48 new tokens each, the launches checked against
    ``want``; then the profiled wave."""
    import resource

    from rten_tpu_torch.serving import ContinuousBatchingEngine

    model, secs = build_llama(n_layer, CAP, dev, **build_kw)
    torch.cuda.synchronize()
    n_ops = sum(1 for _ in model.graph.operators())
    print(f"  build [{tag}]: {', '.join(f'{k} {v:.1f} s' for k, v in secs.items())}; "
          f"{n_ops} graph operators after optimize; peak host RSS "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB "
          f"(the whole process so far)", flush=True)
    engine = ContinuousBatchingEngine(
        model, n_layer=n_layer, n_head=n_head, head_dim=head_dim, slots=L_SLOTS, capacity=CAP,
        prefill_bucket=128, greedy_on_device=True, steps_per_dispatch=8,
    )
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, PROMPT).tolist() for _ in range(24)]
    budgets = [int(rng.integers(16, 49)) for _ in range(24)]
    _, elapsed, forwards, launches = serve(engine, prompts, budgets, vocab, want, tag)
    profile_wave(engine, prompts[:16], elapsed / forwards)
    check_pool(engine, tag)
    return launches


def profiled_run(engine, prompts, new_tokens):
    """One more full wave of ``prompts`` with ``new_tokens`` each under
    torch.profiler, recording CUDA activity only (only device events are
    read; a CPU trace of every op cost minutes to stop and summarize).
    Returns (device busy ms, profiled wall ms, decode steps, admissions,
    device events)."""
    reqs = [engine.submit(p, max_new_tokens=new_tokens) for p in prompts]
    steps0 = engine.steps
    torch.cuda.synchronize()
    with card_profile() as prof:
        t0 = time.perf_counter()
        engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t_trace = time.perf_counter()
    if not all(r.done and len(r.generated) == new_tokens for r in reqs):
        fail("profiled wave: a request did not finish with its tokens")
    events = device_events(prof)
    print(f"  profile: the trace took {time.perf_counter() - t_trace:.1f} s to stop and "
          f"summarize", flush=True)
    return (sum(t for _, _, t in events) / 1e3, wall * 1e3, engine.steps - steps0,
            len({r.first_token_at for r in reqs}), events)


def profile_wave(engine, prompts, wall_per_forward, new_tokens=17):
    """One more full wave (16 requests of 17 tokens: an admission and two
    dispatches of 8 steps; a paged pool that holds 13 admits the rest once
    blocks free) under ``profiled_run``: the card's busy time, by kernel,
    against the host's wall time. The profiler slows the host, so the idle
    share is stated against the unprofiled wall time per forward of the
    serve run as well. Returns (busy ms per forward, busy share of the
    unprofiled wall), or None where the profiler recorded no device time."""
    busy_ms, wall_ms, steps, adm, events = profiled_run(engine, prompts, new_tokens)
    forwards = steps + adm
    if busy_ms <= 0:
        print("  profile: the profiler recorded no device time (not measured)", flush=True)
        return None
    print(f"  profile: {forwards} forwards, device busy {busy_ms:.3f} ms in "
          f"{wall_ms:.3f} ms profiled wall ({busy_ms / wall_ms:.3f} busy); "
          f"busy per forward {busy_ms / forwards:.3f} ms vs unprofiled wall per "
          f"forward {wall_per_forward * 1e3:.3f} ms "
          f"({busy_ms / forwards / (wall_per_forward * 1e3):.3f} busy)", flush=True)
    print_top_kernels(events, busy_ms)
    return busy_ms / forwards, busy_ms / forwards / (wall_per_forward * 1e3)


def print_top_kernels(events, busy_ms):
    # The port's own kernels live in an anonymous namespace; PyTorch's
    # (the plain ops between the kernels) under at::.
    ours = [e for e in events if "(anonymous namespace)::" in e[0] and "at::" not in e[0]]
    ours_ms = sum(t for _, _, t in ours) / 1e3
    print(f"  profile: the port's CUDA kernels {ours_ms:.3f} ms, PyTorch's own kernels "
          f"and copies {busy_ms - ours_ms:.3f} ms", flush=True)
    top = sorted(events, key=lambda e: -e[2])[:8]
    for name, count, t in top + [e for e in ours if e not in top]:
        print(f"    {t / 1e3:9.3f} ms  {count:6d} x  {name[:90]}", flush=True)


def phase_reference(dev):
    """The card against the CPU (the kernels' plain versions), two ways.

    1. A small GPT-2 (2 layers, E 128, H 2, vocab 512, cap 64) behind the
       engine, 5 requests on 3 slots, 4 steps per dispatch: the same tokens,
       on int8, bf16 and f32 cat caches and on paged int8 and bf16 cat pools
       (SMALL_PAGED: 3 usable blocks of 16 rows, so admissions wait for
       blocks); on int4 head-major caches, flat and deferred (bf16
       windows); on int8 deferred caches (f32 windows).
    2. GPT-2 at full width cut to 2 layers, int8 and bf16 cat caches and
       int4 deferred caches (bf16 windows): one admission and 3 decode
       steps from the same inputs: finite logits of the right shape, the
       same greedy tokens unless the CPU's top two are within the logit
       tolerance, and logits within 5e-2 of their maximum. The activations
       are quantized per tensor, so where the two devices' sums round one
       activation to the neighbouring u8 code the logits move by up to
       ~1.5e-2 of their maximum (measured on the CPU against the JAX
       package); a kernel fault moves them by far more.
    """
    for kv, paged in (("s8", {}), ("s8", SMALL_PAGED), ("bf16", {}), ("bf16", SMALL_PAGED),
                      ("f32", {}), ("int4", {}), ("int4-deferred-bf16", {}),
                      ("s8-deferred", {})):
        tag = f"GPT-2 {kv}{' paged' if paged else ''}"
        toks = small_engine_tokens(dev, lambda device: build_model(
            2, 64, device, vocab=512, n_embd=128, n_head=2, kv=kv, **paged), 2, tag)
        if toks["cuda"] != toks["cpu"]:
            fail(f"reference [{tag}]: small engine tokens differ: {toks['cuda']} vs "
                 f"{toks['cpu']}")
    print("  reference [GPT-2]: small engine tokens equal on card and CPU (s8, bf16, f32 cat "
          "caches; s8, bf16 paged pools; int4 head-major caches, flat and deferred with a "
          "bf16 window; s8 deferred with an f32 window)", flush=True)
    for kv in ("s8", "bf16", "int4-deferred-bf16"):
        worst, equal = logits_card_vs_cpu(dev, lambda device: build_model(2, 64, device, kv=kv),
                                          VOCAB, f"GPT-2 {kv}")
        print(f"  reference [GPT-2 {kv}]: full width, 2 layers: logits max err {worst:.3e} of "
              f"max|logit|, tokens {'equal' if equal else 'differ only at near ties'}",
              flush=True)


# The small reference engines' pool: 3 usable blocks of 16 rows for
# requests of 1 or 2 blocks, so admissions wait for blocks.
SMALL_PAGED = dict(paged_blocks=4, block_size=16)


def small_engine_tokens(dev, make_model, n_head, tag, head_dim=64):
    """A small model behind the engine on the card and on the CPU: 5 seeded
    requests on 3 slots, cap 64, 4 steps per dispatch, each attention
    kernel call on the card held against its plain version on the same
    inputs (``hold_calls``). Returns the tokens by device type; a paged
    engine must end with every block free."""
    from rten_tpu_torch.serving import ContinuousBatchingEngine

    toks = {}
    for device in (dev, torch.device("cpu")):
        eng = ContinuousBatchingEngine(
            make_model(device), n_layer=2, n_head=n_head, head_dim=head_dim, slots=3, capacity=64,
            prefill_bucket=8, greedy_on_device=True, steps_per_dispatch=4,
        )
        rng = np.random.default_rng(0)
        reqs = [eng.submit(rng.integers(0, 512, int(rng.integers(3, 12))).tolist(),
                           max_new_tokens=int(rng.integers(3, 14))) for _ in range(5)]
        with hold_calls():
            eng.run()
        if eng.paged and sorted(eng._free_blocks) != list(range(1, eng.n_blocks)):
            fail(f"reference [{tag}]: blocks not returned on {device}")
        toks[device.type] = [r.generated for r in reqs]
    return toks


def _host(v):
    """A copy of a feed or result value as a CPU tensor."""
    return (v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))).detach().cpu().clone()


def _same_input(a, b):
    """Two devices' engine inputs agree: f32 (scales) within rtol 1e-5, the
    rest bit for bit."""
    if a.dtype == torch.float32:
        return torch.allclose(a, b, rtol=1e-5, atol=0)
    return torch.equal(_bits(a), _bits(b))


# A code the two devices may round apart: the CPU's and the card's
# x / scale both within this distance of the same half-integer.
NEAR_HALF = 1e-3
# A forward's logits with no such flip: within this share of max|logit|.
LOCKSTEP_TIGHT = 1e-4


@contextlib.contextmanager
def _recording_quantizers(calls):
    """Within the block, every call of the port's three quantizers (the
    activations' per-tensor u8 ``dynamic_quantize``, the KV caches'
    ``pack_int4`` and s8 ``quantize_rows``) appends (kind, x / scale, codes,
    scale, zero-point ratio or None) to ``calls``, on the host."""
    from rten_tpu_torch.ops import attention as ops
    from rten_tpu_torch.ops import quantize as qmod

    real = {"u8": qmod.dynamic_quantize, "int4": ops.pack_int4, "s8": ops.quantize_rows}

    def dq(x):
        y, s, zp = real["u8"](x)
        lo = torch.clamp(torch.aminmax(x)[0], max=0.0)
        calls.append(("u8", _host(x / s), _host(y).to(torch.int32), _host(s),
                      _host(0.0 - lo / s)))
        return y, s, zp

    def int4(x):
        q, s = real["int4"](x)
        codes = torch.cat([q & 15, q >> 4], dim=-1).to(torch.int32) - 8
        calls.append(("int4", _host(x.float() / s), _host(codes), _host(s), None))
        return q, s

    def s8(x):
        q, s = real["s8"](x)
        calls.append(("s8", _host(x.float() / s), _host(q).to(torch.int32), _host(s), None))
        return q, s

    qmod.dynamic_quantize, ops.pack_int4, ops.quantize_rows = dq, int4, s8
    try:
        yield
    finally:
        qmod.dynamic_quantize, ops.pack_int4, ops.quantize_rows = (
            real["u8"], real["int4"], real["s8"])


def _boundary(rg, rc):
    """Whether two devices' pre-rounding values sit on the same rounding
    boundary (a half-integer), each within NEAR_HALF of it."""
    half = np.floor(rc) + 0.5
    return abs(rc - half) <= NEAR_HALF and abs(rg - half) <= NEAR_HALF


def int4_engine_lockstep(dev, make_model, n_head, tag, head_dim=64, tol=5e-2):
    """The small int4 engine of ``small_engine_tokens`` (5 seeded requests on
    3 slots, cap 64, 4 steps per dispatch), held against the CPU forward by
    forward through the engine, in three runs:

    1. On the CPU: every forward's inputs, outputs, logits and quantizer
       calls (``_recording_quantizers``: the activations' u8 codes, the
       caches' int4 codes, each with its x / scale).
    2. On the card, replaying the CPU run: each forward's inputs, as the
       card's engine builds them, must equal the CPU's bit for bit; the
       card's results are checked (``_lockstep_forward``), then the CPU's
       are handed back, so that every forward starts from the CPU's state.
       Every attention kernel call is also held against its plain version
       (``hold_calls``).
    3. On the card, free running, each forward checked as in run 2 while
       its inputs equal the CPU run's (f32 scales within rtol 1e-5): the
       inputs may part only after a forward with a flip or a token at a
       near tie (a flipped code stays in the card's cache); when they never
       part, the tokens are equal.

    At the first flip it prints where it is and both devices' x / scale,
    and every graph operator that, run on the card from the CPU's inputs
    of that forward, gives another result than on the CPU (where the two
    devices' arithmetic parts). Returns (tokens by device, the flips of
    runs 2 and 3)."""
    from rten_tpu_torch.serving import ContinuousBatchingEngine

    def engine(device):
        eng = ContinuousBatchingEngine(
            make_model(device), n_layer=2, n_head=n_head, head_dim=head_dim, slots=3,
            capacity=64, prefill_bucket=8, greedy_on_device=True, steps_per_dispatch=4)
        rng = np.random.default_rng(0)
        reqs = [eng.submit(rng.integers(0, 512, int(rng.integers(3, 12))).tolist(),
                           max_new_tokens=int(rng.integers(3, 14))) for _ in range(5)]
        return eng, reqs

    calls = []
    rec, flips, parts = [], [], set()

    def checked(run, eng, i, feed, out_ids, donate, flips, parts):
        calls.clear()
        outs = run(feed, list(out_ids) + [eng.g.find_node("logits")], donate)
        _lockstep_forward(tag, i, rec[i], [_host(o) for o in outs[:-1]], _host(outs[-1]),
                          list(calls), flips, parts)
        return outs[:-1]

    with _recording_quantizers(calls):
        # 1. The CPU run.
        cpu, cpu_reqs = engine(torch.device("cpu"))
        run_cpu = cpu.executor.run

        def record(feed, out_ids, donate=()):
            calls.clear()
            before = {nid: _host(v) for nid, v in feed.items()}
            outs = run_cpu(feed, list(out_ids) + [cpu.g.find_node("logits")], donate)
            rec.append(dict(feed=before, out_ids=list(out_ids),
                            outs=[_host(o) for o in outs[:-1]], logits=_host(outs[-1]),
                            after={nid: _host(feed[nid]) for nid in donate if nid in feed},
                            calls=list(calls)))
            return outs[:-1]

        cpu.executor.run = record
        cpu.run()
        toks = {"cpu": [r.generated for r in cpu_reqs]}

        # 2. The card, replaying the CPU run forward by forward.
        card, _ = engine(dev)
        run_card, n = card.executor.run, [0]

        def replay(feed, out_ids, donate=()):
            i = n[0]
            n[0] += 1
            if i >= len(rec):
                fail(f"lockstep [{tag}]: the card ran more forwards than the CPU's {len(rec)}")
            for nid, v in feed.items():
                if not torch.equal(_bits(_host(v)), _bits(rec[i]["feed"][nid])):
                    fail(f"lockstep [{tag}]: forward {i}: the engine's input "
                         f"{card.g.node_name(nid)} differs from the CPU's")
            checked(run_card, card, i, feed, out_ids, donate, flips, parts)
            for nid, after in rec[i]["after"].items():
                feed[nid].copy_(after.to(dev))
            return [o.to(dev) for o in rec[i]["outs"]]

        card.executor.run = replay
        with hold_calls():
            card.run()
        if n[0] != len(rec):
            fail(f"lockstep [{tag}]: the card ran {n[0]} forwards, the CPU {len(rec)}")

        # 3. The card, free running.
        free, free_reqs = engine(dev)
        run_free, m, parted, free_flips, free_parts = free.executor.run, [0], [], [], set()

        def watch(feed, out_ids, donate=()):
            i = m[0]
            m[0] += 1
            if not parted and i < len(rec) and all(
                    _same_input(_host(v), rec[i]["feed"][nid]) for nid, v in feed.items()):
                return checked(run_free, free, i, feed, out_ids, donate, free_flips, free_parts)
            if not parted:
                parted.append(i)
                parted.append([free.g.node_name(nid) for nid, v in feed.items()
                               if i < len(rec) and not _same_input(_host(v), rec[i]["feed"][nid])])
            return run_free(feed, out_ids, donate)

        free.executor.run = watch
        with hold_calls():
            free.run()

    seen = flips or free_flips
    if seen:
        _explain_flip(dev, make_model, tag, seen[0], rec[seen[0]["forward"]])
    toks["cuda"] = [r.generated for r in free_reqs]
    if parted and not any(p < parted[0] for p in free_parts):
        fail(f"lockstep [{tag}]: the free-running card engine's inputs first differ from the "
             f"CPU's at forward {parted[0]} ({', '.join(parted[1])}), with no flip and no "
             f"token at a near tie before it")
    if not parted and toks["cuda"] != toks["cpu"]:
        fail(f"lockstep [{tag}]: tokens differ with equal inputs: {toks['cuda']} vs "
             f"{toks['cpu']}")
    at = sorted({f["forward"] for f in flips})
    print(f"  lockstep [{tag}]: {len(rec)} forwards replayed on the card from the CPU's "
          f"inputs, every check held; flips at forwards {at}; free running, "
          f"{'the inputs stay equal' if not parted else f'checked to forward {parted[0] - 1}, where a flip or near tie before has parted the inputs'}"
          f" (flips at {sorted({f['forward'] for f in free_flips})}), tokens "
          f"{'equal' if toks['cuda'] == toks['cpu'] else 'part'}", flush=True)
    return toks, flips + free_flips


def _lockstep_forward(tag, i, r, outs, logits, calls, flips, parts, tol=5e-2):
    """Forward ``i`` of ``int4_engine_lockstep``: the card's results against
    the CPU's record ``r``, from the same inputs. The first quantizer call
    whose codes differ is the root: every code of it that differs must be
    one step from the CPU's, with both devices' x / scale on the same
    rounding boundary (a flip; the zero point of a u8 call likewise). Before
    a root, the two devices' codes are equal; after one, they may differ by
    what it moved. With no flip, the logits are within LOCKSTEP_TIGHT of
    max|logit| and every KV cache code and non-f32 output is bit-equal;
    with one, within ``tol``. A next token may differ only where the CPU's
    top two are closer than twice the logits' difference. Adds the flips to
    ``flips``, and ``i`` to ``parts`` when a flip or a token may part a
    free-running engine from the CPU's."""
    if len(calls) != len(r["calls"]):
        fail(f"lockstep [{tag}]: forward {i}: {len(calls)} quantizer calls on the card, "
             f"{len(r['calls'])} on the CPU")
    root = None
    for c, ((kind, rg, cg, sg, zg), (_, rc, cc, sc, zc)) in enumerate(zip(calls, r["calls"])):
        if torch.equal(cg, cc):
            continue
        if zc is not None and not torch.equal(torch.round(zg), torch.round(zc)):
            if not _boundary(zg.item(), zc.item()):
                fail(f"lockstep [{tag}]: forward {i}: {kind} call {c}: zero points "
                     f"{zg.item()!r} / {zc.item()!r} apart, not on a rounding boundary")
            root = c
            parts.add(i)
            flips.append(dict(forward=i, call=c, kind=kind, zero_point=(zg.item(), zc.item())))
            break
        for idx in torch.nonzero(cg != cc).tolist():
            idx = tuple(idx)
            g_, c_ = rg[idx].item(), rc[idx].item()
            if abs(cg[idx].item() - cc[idx].item()) != 1 or not _boundary(g_, c_):
                fail(f"lockstep [{tag}]: forward {i}: {kind} call {c} at {list(idx)}: code "
                     f"{cg[idx].item()} on the card, {cc[idx].item()} on the CPU, x / scale "
                     f"{g_!r} vs {c_!r}: not a rounding-boundary flip")
            sidx = tuple(min(k, n - 1) for k, n in zip(idx, sc.shape)) if sc.dim() else ()
            flips.append(dict(forward=i, call=c, kind=kind, index=list(idx), ratio_card=g_,
                              ratio_cpu=c_, code_card=cg[idx].item(), code_cpu=cc[idx].item(),
                              scale_card=sg[sidx].item(), scale_cpu=sc[sidx].item()))
        root = c
        parts.add(i)
        break
    V = r["logits"].shape[-1]
    lc, lg = r["logits"].reshape(-1, V), logits.reshape(-1, V)
    scale = lc.abs().max().item()
    diff = (lg - lc).abs().max().item()
    bound = LOCKSTEP_TIGHT if root is None else tol
    if not diff <= bound * scale:
        fail(f"lockstep [{tag}]: forward {i}: logits differ by {diff / scale:.3e} of "
             f"max|logit| (bound {bound}, flip: {root is not None})")
    tg, tc = outs[0].reshape(-1), r["outs"][0].reshape(-1)
    for s in torch.nonzero(tg != tc).reshape(-1).tolist():
        top2 = torch.sort(lc[s]).values[-2:]
        if (top2[1] - top2[0]).item() > 2 * diff:
            fail(f"lockstep [{tag}]: forward {i}: slot {s} token {tg[s].item()} vs CPU "
                 f"{tc[s].item()}: the CPU's top two {(top2[1] - top2[0]).item():.3e} apart, "
                 f"the logits {diff:.3e}")
        parts.add(i)
    if root is None:
        for o_card, o_cpu in zip(outs[1:], r["outs"][1:]):
            if not _same_input(o_card, o_cpu):
                fail(f"lockstep [{tag}]: forward {i}: a {o_card.dtype} cache differs from the "
                     f"CPU's with no flip")


def _explain_flip(dev, make_model, tag, flip, r):
    """Prints the first flip, and every operator that, run alone on the card
    from the CPU's values of that forward (``r``), gives another result
    than on the CPU: the places where the two devices' arithmetic parts,
    one of which moved the flipped code's x."""
    print(f"  lockstep [{tag}]: first flip: {json.dumps(flip)}", flush=True)
    cpu, card = make_model(torch.device("cpu")), make_model(dev)
    g = cpu.graph
    ops_ = [(op_id, g.nodes[op_id]) for op_id in cpu.executor._plan(
        list(r["feed"]), r["out_ids"] + [g.find_node("logits")])]
    outs = [o for _, op in ops_ for o in op.outputs]
    feed = {nid: v.clone() for nid, v in r["feed"].items()}
    vals = dict(zip(outs, (_host(v) for v in cpu.executor.run(feed, outs))))
    parted = []
    for op_id, op in ops_:
        ins = {i: (vals[i] if i in vals else r["feed"][i]) for i in op.inputs
               if i is not None and (i in vals or i in r["feed"])}
        got = card.executor.run({i: v.clone().to(dev) for i, v in ins.items()}, op.outputs)
        diffs = []
        for o, v in zip(op.outputs, got):
            a, b = _host(v), vals[o]
            if not torch.equal(_bits(a), _bits(b)):
                d = (a.double() - b.double()).abs().max().item()
                diffs.append(d / max(b.double().abs().max().item(), 1e-30))
        if diffs:
            parted.append(f"{op.op_type} '{g.node_name(op.outputs[0])}' "
                          f"(rel {max(diffs):.2e})")
    print(f"  lockstep [{tag}]: operators that, from the CPU's inputs of forward "
          f"{flip['forward']}, give other bits on the card ({len(parted)} of {len(ops_)}): "
          f"{'; '.join(parted)}", flush=True)


def logits_card_vs_cpu(dev, make_model, vocab, tag, tol=5e-2):
    """One admission of 16 seeded tokens on 4 slots and 3 decode steps, on
    the CPU and then on the card from the same inputs (each decode step
    takes the CPU's greedy tokens on both, so that a token flipped at a
    near tie does not change the card's next input): finite logits of the
    right shape, within ``tol`` of max|logit|, and the same greedy tokens
    unless the CPU's top two are within that tolerance. A paged model gets
    pools at their declared shape and a shuffled table; a deferred-KV model
    one-row windows at the admission, then the three decode steps as one
    dispatch (windows of 3 rows, step_t 0, 1, 2). The card's model runs
    the CPU model's optimized graph (built, quantized and optimized once;
    the passes do not depend on the device). Returns (worst error, whether
    every token was equal)."""
    from rten_tpu_torch.model import Model, ModelOptions

    outs = {}
    slots, T = 4, 16
    cpu_model = make_model(torch.device("cpu"))
    for device in (torch.device("cpu"), dev):
        model = (cpu_model if device.type == "cpu"
                 else Model(cpu_model.graph, ModelOptions(optimize=False), device=device))
        rng = np.random.default_rng(1)
        ids = rng.integers(0, vocab, (slots, T)).astype(np.int32)
        info = {name: (dt, tuple(shape)) for name, dt, shape in model.input_info()}
        paged = "block_table" in info
        caches = {name: torch.zeros(shape if paged else (slots,) + shape[1:],
                                    dtype=dt.torch_dtype)
                  for name, (dt, shape) in info.items() if name.startswith("past_key_values.")}
        fixed = {}
        if paged:
            nb, mb = next(iter(caches.values())).shape[0], info["block_table"][1][1]
            fixed["block_table"] = (rng.permutation(np.arange(1, nb))[: slots * mb]
                                    .reshape(slots, mb).astype(np.int32))
        names = [n for n in model.output_names() if n.startswith("present.")]
        # Deferred-KV graphs: the three decode steps are one dispatch's,
        # their rows in windows of 3 rows carried from step to step (the
        # prompt, written by the admission, is the committed cache).
        recent = {n: spec for n, spec in info.items() if n.startswith("recent.")}
        rnames = [n for n in model.output_names() if n.startswith("recent_present.")]

        def windows(rows):
            return {n: torch.zeros((slots, shape[1], rows, shape[3]), dtype=dt.torch_dtype)
                    for n, (dt, shape) in recent.items()}

        if recent:
            fixed["step_t"] = np.zeros(1, np.int32)
        feed = dict(caches, **fixed, **windows(1), input_ids=ids,
                    past_lens=np.zeros(slots, np.int32),
                    position_ids=np.tile(np.arange(T, dtype=np.int32), (slots, 1)),
                    last_pos=np.full(slots, T - 1, np.int32))
        res = []
        lens = np.full(slots, T, np.int32)
        for step in range(4):
            got = model.run(feed, ["logits", "next_token"] + names + rnames)
            logits, tok = got[0][:, 0].cpu().numpy(), got[1][:, 0].cpu().numpy()
            if logits.shape != (slots, vocab) or not np.isfinite(logits).all():
                fail(f"reference [{tag}]: logits {logits.shape} on {device}, finite: "
                     f"{np.isfinite(logits).all()}")
            res.append((logits, tok))
            if device.type == "cuda":
                tok = outs["cpu"][step][1]
            feed = {"past_key_values." + n[len("present."):]: t
                    for n, t in zip(names, got[2:2 + len(names)])}
            if recent:
                fixed["step_t"] = np.array([step], np.int32)
                feed.update(windows(3) if step == 0 else {
                    "recent." + n[len("recent_present."):]: t
                    for n, t in zip(rnames, got[2 + len(names):])})
            feed.update(fixed, input_ids=tok.astype(np.int32)[:, None], past_lens=lens,
                        position_ids=lens[:, None], last_pos=np.zeros(slots, np.int32))
            lens = lens + 1
        outs[device.type] = res
        del model
    del cpu_model
    worst = 0.0
    for step, ((lg, tg), (lc, tc)) in enumerate(zip(outs["cuda"], outs["cpu"])):
        scale = np.abs(lc).max()
        err = np.abs(lg - lc).max() / scale
        worst = max(worst, err)
        if err > tol:
            by_slot = np.abs(lg - lc).max(axis=1) / scale
            fail(f"reference [{tag}]: step {step}: logits differ by {err:.2e} of max|logit| "
                 f"(by slot {np.round(by_slot, 4).tolist()}; max|logit| {np.abs(lg).max():.4f} "
                 f"on the card, {scale:.4f} on the CPU)")
        for s in np.nonzero(tg != tc)[0]:
            top2 = np.sort(lc[s])[-2:]
            if top2[1] - top2[0] > tol * scale:
                fail(f"reference [{tag}]: slot {s} token {tg[s]} vs CPU {tc[s]}")
    return worst, all((a[1] == b[1]).all() for a, b in zip(outs["cuda"], outs["cpu"]))


def phase_reference_llama(dev):
    """The card against the CPU (the plain versions) for the Llama family.

    1. A small Llama (2 layers, E 256, 4 query heads over 2 KV heads, D 64,
       vocab 512; the projections sharpened 2x, so that greedy tokens depend
       on the context) behind the engine, 5 requests on 3 slots, cap 64,
       4 steps per dispatch: the same tokens for each supported cache
       layout (s8, f32 and bf16 head-major; s8, f32 and bf16 cat), flat and
       paged (SMALL_PAGED); at D 128 (E 512, Qwen2's biases and tied
       embeddings) on bf16 cat caches; on f32 deferred caches with f32
       windows; on int4 head-major caches at D 64 and 128, where
       ``int4_engine_lockstep`` also holds every forward against the CPU's.
       At D 64 the tokens may part, and only after a flip that it located:
       an int4 code one step apart where both devices' x / scale sit on a
       rounding boundary (an int4 step is 1/7 of the row's absmax, so one
       flip moves this sharpened model's later tokens; an s8 step, 1/127,
       does not).
    2. TinyLlama's width cut to 2 layers (s8 head-major caches, paged s8
       head-major pools, bf16 and int4 head-major caches) and
       Qwen2.5-1.5B's (bf16 cat caches): logits as in the GPT-2 reference
       phase, within 5e-2 of max|logit|, every attention kernel call held
       against its plain version (``hold_calls``).
    """
    small = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
                 num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128)
    layouts = {f"{kv} {form}": dict(kv=kv, kernel_append=form == "cat")
               for kv in ("s8", "f32", "bf16") for form in ("head-major", "cat")}
    layouts.update({f"paged {k}": dict(v, **SMALL_PAGED) for k, v in list(layouts.items())})
    layouts["D 128 bf16 cat"] = dict(kv="bf16", kernel_append=True, hidden_size=512,
                                     attention_bias=True, tie_word_embeddings=True)
    layouts["f32 deferred, f32 window"] = dict(kv="f32-deferred")
    layouts["int4 head-major"] = dict(kv="int4")
    layouts["D 128 int4 head-major"] = dict(kv="int4", hidden_size=512)
    for layout, opts in layouts.items():
        head_dim = opts.get("hidden_size", 256) // 4

        def make(device, opts=opts):
            return build_llama(2, 64, device, sharpen=2.0, **{**small, **opts})[0]

        if opts["kv"] == "int4":
            toks, flips = int4_engine_lockstep(dev, make, 4, f"Llama, {layout}", head_dim)
        else:
            toks, flips = small_engine_tokens(dev, make, 4, f"Llama, {layout}", head_dim), []
        # Tokens part only after a flip that int4_engine_lockstep located,
        # and only at D 64.
        if toks["cuda"] != toks["cpu"] and not (flips and layout == "int4 head-major"):
            fail(f"reference [Llama, {layout}]: small engine tokens differ: "
                 f"{toks['cuda']} vs {toks['cpu']}")
        if len({t for g in toks["cuda"] for t in g}) <= len(toks["cuda"]):
            fail(f"reference [Llama, {layout}]: the tokens do not depend on the context")
    print(f"  reference [Llama]: small engine tokens equal on card and CPU for "
          f"{', '.join(layouts)}, unless a located int4 flip parts them (above)", flush=True)
    # 4 slots x 4 blocks of 16 rows, plus the garbage block.
    for tag, opts, vocab in (
            ("TinyLlama", {}, L_VOCAB),
            ("TinyLlama paged", dict(paged_blocks=17, block_size=16), L_VOCAB),
            ("TinyLlama bf16", dict(kv="bf16"), L_VOCAB),
            ("TinyLlama int4", dict(kv="int4"), L_VOCAB),
            ("Qwen2.5-1.5B bf16 cat", dict(QWEN, kv="bf16", kernel_append=True), Q_VOCAB)):
        # Every attention kernel call of the card's run is also held against
        # its plain version on the same inputs.
        with hold_calls() as held:
            worst, equal = logits_card_vs_cpu(
                dev, lambda device: build_llama(2, 64, device, **opts)[0], vocab, tag)
        calls = {k: f"{len(v)} calls, max err {max(v):.3e}" for k, v in held.items()}
        print(f"  reference [{tag}]: full width, 2 layers: logits max err {worst:.3e} "
              f"of max|logit|, tokens {'equal' if equal else 'differ only at near ties'}; "
              f"each attention call against its plain version (bound {HELD_TOL}): "
              f"{json.dumps(calls)}", flush=True)


HELD_TOL = 1e-4  # an attention kernel call against its plain version


def _folded_plain(q, k, v, lens, k_scale=None, v_scale=None, *, scale=None, window=0,
                  recent_k=None, recent_v=None, t=None, k_new=None, v_new=None):
    """decode_mha_folded's arithmetic in plain PyTorch on any device (the
    window write included)."""
    from rten_tpu_torch.kernels.flash_attention import (
        decode_attention_deferred_plain, decode_mha_plain,
    )

    if recent_k is None:
        return decode_mha_plain(q, k, v, lens, k_scale, v_scale, scale=scale, window=window)
    return decode_attention_deferred_plain(q, k, v, lens, k_scale, v_scale, scale=scale,
                                           recent_k=recent_k, recent_v=recent_v, t=t,
                                           k_new=k_new, v_new=v_new)[0]


def _mha_f64(q, k, v, mask=None, *, scale=None, causal=False, softcap=0.0):
    """mha_plain's arithmetic in f64 (query head h reads KV head h // group):
    the exact answer both the kernel and its f32 plain version are held
    against for the record."""
    Tq, Tk, D = q.shape[2], k.shape[2], q.shape[3]
    if q.shape[1] != k.shape[1]:
        k, v = (t.repeat_interleave(q.shape[1] // k.shape[1], dim=1) for t in (k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q.double(), k.double()) * (
        1.0 / float(np.sqrt(D)) if scale is None else scale)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    if mask is not None:
        s = s + mask.double()
    if causal:
        band = (torch.arange(Tk, device=q.device)[None]
                <= torch.arange(Tq, device=q.device)[:, None] + Tk - Tq)
        s = torch.where(band, s, -1e300)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v.double())


def _mha_live_rows(q, k, v, mask=None, *, causal=False, **_):
    """[Tq] bool: the rows of an mha call with a column to attend (the
    kernel gives 0 on the others, its plain version the mean of V)."""
    Tq, Tk = q.shape[2], k.shape[2]
    admitted = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device)
    if causal:
        admitted &= (torch.arange(Tk, device=q.device)[None]
                     <= torch.arange(Tq, device=q.device)[:, None] + Tk - Tq)
    if mask is not None:
        admitted &= mask.expand(Tq, Tk) > -1e29
    return admitted.any(-1)


@contextlib.contextmanager
def hold_calls(tol=HELD_TOL, mha_tol=None):
    """Within the block, every call of an attention kernel wrapper on card
    tensors (decode_mha's two forms, the cat append, the head-major append,
    prefill_mha_cat, paged_decode_mha; with ``mha_tol``, mha too) also runs
    the kernel's plain version on clones of the same inputs: the outputs
    within ``tol`` of each other, every tensor the two write (caches,
    scales, windows) equal (s8 scales within rtol 5e-6). An mha call is
    held within ``mha_tol`` on the rows with a column to attend and must
    give 0 on the others. Yields {kernel: [max abs error of each call]};
    fails on the first call out of bound."""
    from rten_tpu_torch.kernels import flash_attention as fa

    plain = {"decode_mha_folded": _folded_plain, "decode_mha_heads": fa.decode_mha_plain,
             "decode_mha_append_cat": fa.decode_mha_append_cat_plain,
             "decode_mha_append": fa.decode_mha_append_plain,
             "prefill_mha_cat": fa.prefill_mha_cat_plain,
             "paged_decode_mha": fa.paged_decode_mha_plain}
    errs = {}

    def held_mha(kernel, args, kw):
        got = kernel(*args, **kw)
        want = fa.mha_plain(*args, **kw)
        live = _mha_live_rows(*args, **kw)
        err = (got.float() - want.float())[:, :, live].abs().max().item()
        errs.setdefault("mha", []).append(err)
        exact = _mha_f64(*args, **kw)[:, :, live]
        errs.setdefault("mha_f64", []).append(
            [(t.double()[:, :, live] - exact).abs().max().item() for t in (got, want)])
        errs.setdefault("mha_first_call", (args, kw))
        if not err <= mha_tol or not (got[:, :, ~live] == 0).all():
            fail(f"mha call {len(errs['mha'])} {tuple(args[0].shape)} over "
                 f"{tuple(args[1].shape)}: max err {err} > {mha_tol} against mha_plain, or a "
                 f"row with no column to attend is not 0")
        return got

    def held(name, kernel, args, kw):
        if not isinstance(args[0], torch.Tensor) or args[0].device.type != "cuda":
            return kernel(*args, **kw)
        if name == "mha":
            return kernel(*args, **kw) if mha_tol is None else held_mha(kernel, args, kw)

        def clone(x):
            return x.clone() if isinstance(x, torch.Tensor) else x

        pargs, pkw = [clone(a) for a in args], {k: clone(x) for k, x in kw.items()}
        got = kernel(*args, **kw)
        want = (fa.decode_mha_append_cat_paged_plain if "block_table" in pkw
                and pkw["block_table"] is not None else plain[name])(*pargs, **pkw)
        g0 = got[0] if isinstance(got, tuple) else got
        w0 = want[0] if isinstance(want, tuple) else want
        err = (g0.float() - w0.float()).abs().max().item()
        errs.setdefault(name, []).append(err)
        written = [(a, b) for a, b in zip(list(args) + list(kw.values()),
                                          pargs + list(pkw.values()))
                   if isinstance(a, torch.Tensor)]
        same = all(torch.equal(_bits(a), _bits(b)) if a.dtype != torch.float32
                   or a.dim() < 4 or a.shape[-1] > 1
                   else torch.allclose(a, b, rtol=5e-6, atol=0) for a, b in written)
        if not err <= tol or not same:
            fail(f"{name} call {len(errs[name])}: max err {err} > {tol} against its plain "
                 f"version, or the tensors it writes differ ({same})")
        return got

    fa.hold = held
    try:
        yield errs
    finally:
        fa.hold = None


def sanitizer_target():
    """The TinyLlama bf16 head-major 2-layer reference (phase_reference_llama's
    logits check), the program phase_sanitizer runs under compute-sanitizer."""
    dev = torch.device("cuda")
    worst, _ = logits_card_vs_cpu(dev, lambda device: build_llama(2, 64, device, kv="bf16")[0],
                                  L_VOCAB, "TinyLlama bf16 (sanitizer)")
    print(f"sanitizer target: logits max err {worst:.3e} of max|logit|", flush=True)


def phase_sanitizer(out_dir):
    """The TinyLlama bf16 head-major 2-layer reference once under
    ``compute-sanitizer --tool racecheck`` and once under ``--tool memcheck``
    (the toolkit's own, under /usr/local/cuda/bin), each in a subprocess
    with a time limit. A hazard or bad access reported in one of the port's
    kernels fails the run; a tool that is missing, refuses to run, or runs
    out of time is reported as such; each report goes to ``out_dir``.
    Returns {tool: outcome}."""
    tool = "/usr/local/cuda/bin/compute-sanitizer"
    if not os.path.exists(tool):
        print(f"  sanitizer: {tool} not found (not run)", flush=True)
        return {"racecheck": "not found", "memcheck": "not found"}
    ours = ("decode_mha_fold_kernel", "decode_fold_tc_kernel", "decode_mha_heads_wide_kernel",
            "decode_mha_heads_tc_kernel", "decode_mha_heads_tf32_kernel",
            "append_cat_write_kernel", "mha_kernel")
    code = f"import sys; sys.path.insert(0, {ROOT!r}); import chip_smoke; chip_smoke.sanitizer_target()"
    # One tiny launch first: a tool that refuses the card says so before
    # the reference spends its time building the model.
    probe = subprocess.run([tool, "--tool", "memcheck", sys.executable, "-c",
                            "import torch; torch.ones(1, device='cuda').sum().item()"],
                           capture_output=True, text=True, timeout=SANITIZER_S, cwd=ROOT)
    if "Device not supported" in probe.stdout + probe.stderr:
        out = {name: "the tool refused the card (Error: Device not supported); not run"
               for name in ("racecheck", "memcheck")}
        print(f"  sanitizer: {out['memcheck']}", flush=True)
        return out
    out = {}
    for name in ("racecheck", "memcheck"):
        t0 = time.perf_counter()
        try:
            r = subprocess.run([tool, "--tool", name, sys.executable, "-c", code],
                               capture_output=True, text=True, timeout=SANITIZER_S, cwd=ROOT)
        except subprocess.TimeoutExpired:
            out[name] = f"ran out of its {SANITIZER_S} s"
            print(f"  sanitizer [{name}]: {out[name]}", flush=True)
            continue
        text = r.stdout + r.stderr
        with open(os.path.join(out_dir, f"sanitizer_{name}.txt"), "w") as f:
            f.write(text)
        if "Device not supported" in text:
            out[name] = "the tool refused the card (Error: Device not supported); not run"
            print(f"  sanitizer [{name}]: {out[name]}", flush=True)
            continue
        summary = [ln.strip() for ln in text.splitlines() if "SUMMARY" in ln]
        flagged = [ln.strip() for ln in text.splitlines()
                   if ("Error" in ln or "Hazard" in ln or "hazard" in ln)
                   and any(k in ln for k in ours)]
        out[name] = (f"exit {r.returncode} in {time.perf_counter() - t0:.1f} s; "
                     f"{'; '.join(summary) or text.strip().splitlines()[-1:] }")
        print(f"  sanitizer [{name}]: {out[name]}", flush=True)
        if flagged:
            fail(f"compute-sanitizer {name} reports the port's kernels: {flagged[:5]}")
    return out


SANITIZER_S = 120  # each sanitizer run's time limit


def phase_reference_generate(dev):
    """The Generator on the card against the CPU (the plain versions).

    1. A small GPT-2 (2 layers, E 128, H 2, vocab 512; attention and MLP
       projections sharpened 4x so tokens follow the context) through
       ``gpt2.load`` and ``Generator`` (bucket 8, 14 new tokens): the same
       greedy tokens, f32 and int4 weights, batch 1 (a 5-token prompt: the
       prefill's 8 rows go through the mha kernel with 3 padding rows) and
       batch 2 (a per-batch mask: the plain version on both).
    2. GPT-2 at full width cut to 2 layers, f32 and int4: the prefill's
       last-position logits of a 91-token prompt (bucket 128) within 1e-5 of
       max|logit| (f32 products on both sides, no quantized activations).
       Attention moves these logits: scaling every attention output by
       1 + 1e-4 moves them by 6.4e-5 of max|logit| on the CPU.
    """
    from rten_tpu_torch.generate import Generator, GeneratorConfig
    from rten_tpu_torch.models import gpt2

    small = gpt2.GPT2Config(vocab_size=512, n_positions=128, n_embd=128, n_layer=2, n_head=2)
    w = gpt2.random_weights(small, 0)
    for k in w:
        if (".attn.c_" in k or ".mlp.c_" in k) and k.endswith(".weight"):
            w[k] = w[k] * np.float32(4.0)
    for quantize in (None, "int4"):
        for B, T in ((1, 5), (2, 11)):
            prompt = generator_prompt(512, T, B, seed=B)
            card, cpu = (Generator(gpt2.load(small, w, quantize=quantize, device=device),
                                   prompt, GeneratorConfig(bucket_size=8)).generate(14)
                         for device in (dev, torch.device("cpu")))
            if not np.array_equal(card, cpu):
                fail(f"reference [Generator {quantize or 'f32'}, batch {B}]: tokens differ: "
                     f"{card.tolist()} vs {cpu.tolist()}")
    full = gpt2.GPT2Config(n_layer=2)
    wf = gpt2.random_weights(full, 0)
    worst = {}
    for quantize in (None, "int4"):
        lg, lc = (Generator(gpt2.load(full, wf, quantize=quantize, device=device),
                            generator_prompt(), GeneratorConfig(bucket_size=GEN_BUCKET))
                  ._pending_logits for device in (dev, torch.device("cpu")))
        if lg.shape != (1, VOCAB) or not np.isfinite(lg).all():
            fail(f"reference [GPT-2 {quantize or 'f32'} prefill]: logits {lg.shape}, finite: "
                 f"{np.isfinite(lg).all()}")
        worst[quantize or "f32"] = np.abs(lg - lc).max() / np.abs(lc).max()
        if not worst[quantize or "f32"] <= 1e-5:
            fail(f"reference [GPT-2 {quantize or 'f32'} prefill]: logits differ by "
                 f"{worst[quantize or 'f32']:.2e} of max|logit| > 1e-5")
    print(f"  reference [Generator]: small GPT-2 tokens equal on card and CPU (f32 and int4, "
          f"batch 1 and 2); full width, 2 layers, prefill logits max err "
          f"{json.dumps({k: float(v) for k, v in worst.items()})} of max|logit| (bound 1e-5)",
          flush=True)


# --- the rest of the serving stack: the hard config, sampling, references -----

# bench.py's hard config (run_hard_config): GPT-2 124M at cap 1024, int8 KV,
# sampled on the device, 64 steps a dispatch, 2 dispatches a drain, 96 slots;
# a warm-up wave of 2 new tokens, then a wave of 384.
HARD_SLOTS, HARD_CAP, HARD_K, HARD_D, HARD_NEW = 96, 1024, 64, 2, 384
HARD_SAMPLER = dict(temperature=0.8, top_k=40, seed=0)


def hard_engine(model, n_layer=12, **kw):
    """The hard config's engine over ``model``: 96 slots, cap 1024, prefill
    bucket 128, 64 steps a dispatch, 2 dispatches a drain, the device
    sampler at temperature 0.8 and top-k 40 from seed 0 (``kw`` overrides
    any of these)."""
    from rten_tpu_torch.generate.sampler import DeviceSampler
    from rten_tpu_torch.serving import ContinuousBatchingEngine

    opts = dict(device_sampler=DeviceSampler(**HARD_SAMPLER), steps_per_dispatch=HARD_K,
                dispatches_per_drain=HARD_D)
    opts.update(kw)
    return ContinuousBatchingEngine(model, n_layer=n_layer, n_head=H, head_dim=D,
                                    slots=HARD_SLOTS, capacity=HARD_CAP, prefill_bucket=PROMPT,
                                    **opts)


def hard_prompts(rng, n=HARD_SLOTS):
    return [rng.integers(0, VOCAB, PROMPT).tolist() for _ in range(n)]


def phase_serve_hard(dev):
    """``bench.py``'s hard config at full width through the user's entry
    points (builder with int8 cat KV, the in-kernel append and the gathered
    lm_head at cap 1024, quantize_dynamic, Model, the engine above): a
    warm-up wave of 96 seeded 128-token prompts with 2 new tokens, then,
    every launch counter zeroed, a wave of 96 with 384 new tokens. Every
    request must get its 384 tokens, all in [0, V); the int8 matmul runs on
    its rows form at every decode step (96 rows) and tiled at every
    admission, the append 12 times a step, prefill_mha_cat 12 times an
    admission and the argmax never (the tokens are sampled). Prints tok/s,
    TTFT p50, the host's wall per forward, the host's seconds issuing
    dispatches against draining them (the drain waits for the card), and
    the card's busy time of an admission and of a decode step, weighted by
    the timed wave's forwards (``hard_busy``)."""
    model = build_model(12, HARD_CAP, dev)
    engine = hard_engine(model)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for p in hard_prompts(rng):
        engine.submit(p, max_new_tokens=2)
    engine.run()
    torch.cuda.synchronize()
    engine.finished.clear()
    print(f"  warm-up [hard config]: {HARD_SLOTS} requests of 2 tokens in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    # The host's seconds issuing dispatches and draining them.
    host = {"issue_s": 0.0, "drain_s": 0.0, "dispatches": 0}
    issue, drain = engine._issue_multi, engine._drain_record

    def timed_issue(from_host):
        t = time.perf_counter()
        issue(from_host)
        host["issue_s"] += time.perf_counter() - t
        host["dispatches"] += 1

    def timed_drain(rec):
        t = time.perf_counter()
        drain(rec)
        host["drain_s"] += time.perf_counter() - t

    engine._issue_multi, engine._drain_record = timed_issue, timed_drain
    steps0 = engine.steps
    for fn in counters().values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [engine.submit(p, max_new_tokens=HARD_NEW) for p in hard_prompts(rng)]
    engine.run()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters().items()}
    del engine._issue_multi, engine._drain_record
    for r in reqs:
        if not r.done or len(r.generated) != HARD_NEW or r.error:
            fail(f"hard config request {r.request_id}: {len(r.generated)} of {HARD_NEW} tokens")
        if not all(0 <= t < VOCAB for t in r.generated):
            fail(f"hard config request {r.request_id}: token out of range")
    steps = engine.steps - steps0
    adm = len({r.first_token_at for r in reqs})
    want = {
        "int8_matmul_dequant": 49 * (steps + adm),
        # 96 rows a decode step and the admission's gathered lm_head on the
        # rows form, the admission's 48 projections (96 x 128 rows) tiled
        "int8_matmul_dequant_rows": 49 * steps + adm,
        "int8_matmul_dequant_tiled": 48 * adm,
        "decode_mha_append_cat": 12 * steps,
        "prefill_mha_cat": 12 * adm,
    }
    for k, n in launches.items():
        if n != want.get(k, 0):
            fail(f"hard config: {k} launched {n} times, expected {want.get(k, 0)}")
    toks = sum(len(r.generated) for r in reqs)
    forwards = steps + adm
    ttft = statistics.median(r.ttft_s for r in reqs)
    print(f"  serve [hard config]: {len(reqs)} requests, {toks} tokens in {elapsed:.3f} s = "
          f"{toks / elapsed:.1f} tok/s, TTFT p50 {ttft * 1e3:.1f} ms, {adm} admissions, "
          f"{steps} decode steps in {host['dispatches']} dispatches, host wall per forward "
          f"{elapsed / forwards * 1e3:.3f} ms; host issuing {host['issue_s']:.3f} s, "
          f"draining {host['drain_s']:.3f} s", flush=True)
    print(f"  serve launches [hard config]: {json.dumps(launches)}", flush=True)
    busy = hard_busy(engine, rng, steps, adm, elapsed / forwards)
    print("HARD_CONFIG " + json.dumps({
        "tok_s": toks / elapsed, "ttft_p50_ms": ttft * 1e3, "forwards": forwards,
        "decode_steps": steps, "admissions": adm, "dispatches": host["dispatches"],
        "host_wall_per_forward_ms": elapsed / forwards * 1e3,
        "host_issue_s": host["issue_s"], "host_drain_s": host["drain_s"],
        **(busy or {"busy": "not measured"})}), flush=True)
    return launches


def hard_busy(engine, rng, steps, adm, wall_per_forward):
    """The card's busy time in the hard config, split between its two kinds
    of forward: a profiled wave of admissions alone (96 requests of 1
    token) and one of an admission and one dispatch (17 tokens) give two
    equations in an admission's and a decode step's busy time. Weighted by
    the timed wave's ``adm`` admissions and ``steps`` decode steps, they
    give its busy time per forward and busy share of its unprofiled wall
    per forward. None where the profiler recorded no device time."""
    busy_a, _, s_a, a_a, _ = profiled_run(engine, hard_prompts(rng), 1)
    busy_b, wall_b, s_b, a_b, events = profiled_run(engine, hard_prompts(rng), 17)
    det = a_a * s_b - a_b * s_a
    if busy_a <= 0 or busy_b <= 0 or det == 0:
        print("  profile [hard config]: no device time recorded, or the waves' mixes are "
              "the same (not measured)", flush=True)
        return None
    per_adm = (busy_a * s_b - busy_b * s_a) / det
    per_step = (a_a * busy_b - a_b * busy_a) / det
    forwards = steps + adm
    per_forward = (adm * per_adm + steps * per_step) / forwards
    share = per_forward / (wall_per_forward * 1e3)
    print(f"  profile [hard config]: {a_a} admissions and {s_a} steps busy {busy_a:.3f} ms; "
          f"{a_b} admissions and {s_b} steps busy {busy_b:.3f} ms in {wall_b:.3f} ms "
          f"profiled wall: an admission {per_adm:.3f} ms, a decode step {per_step:.3f} ms; "
          f"over the timed wave's {adm} admissions and {steps} steps, {per_forward:.3f} ms "
          f"a forward against {wall_per_forward * 1e3:.3f} ms of unprofiled wall "
          f"({share:.3f} busy)", flush=True)
    print_top_kernels(events, busy_b)
    return {"busy_per_admission_ms": per_adm, "busy_per_decode_step_ms": per_step,
            "busy_per_forward_ms": per_forward, "busy_share": share}


def _near_top_p(ds, x, eps=1e-6):
    """The tokens whose exclusive cumulative probability (the top-p test's
    ``cum - probs``) lies within ``eps`` of ``top_p`` on ``x``'s device."""
    from rten_tpu_torch.generate.sampler import DeviceSampler

    if ds.top_p is None:
        return torch.zeros(x.shape, dtype=torch.bool)
    pre = DeviceSampler(temperature=ds.temperature, top_k=ds.top_k).transform(x)
    sx, order = torch.sort(pre, dim=-1, descending=True)
    probs = torch.softmax(sx.double(), dim=-1)  # as the sampler sums them
    near = ((torch.cumsum(probs, dim=-1) - probs) - ds.top_p).abs() < eps
    return torch.zeros_like(near).scatter(-1, order, near).cpu()


def phase_sampling(dev):
    """The device sampler on the card.

    1. ``transform`` on the card against the CPU on the same seeded
       [96, 50257] logits: the kept values within 1 ulp, the masks equal but
       for top-p tokens whose cumulative probability lies within 1e-6 of
       top_p on either device (the devices sum in different orders; their
       count is printed). Then one ``sample`` at the hard config's shape,
       timed.
    2. The hard config's engine cut to 2 layers: top_k 1 and temperature
       1e-6 give the greedy engine's tokens; the same seed twice gives the
       same tokens with 2 dispatches a drain and with pipeline_dispatch.
    3. 2^16 draws from one fixed row at temperature 0.8, top-k 40, top-p
       0.9: every draw in the kept set, each token's count within 5 sigma
       of its probability (binomial).
    """
    from rten_tpu_torch.generate.sampler import DeviceSampler

    g = torch.Generator().manual_seed(3)
    logits = torch.randn(HARD_SLOTS, VOCAB, generator=g) * 4
    for spec in (dict(temperature=0.8, top_k=40), dict(top_p=0.9),
                 dict(temperature=0.8, top_k=40, top_p=0.9), dict(temperature=0.7)):
        ds = DeviceSampler(**spec)
        cpu, card = ds.transform(logits), ds.transform(logits.to(dev)).cpu()
        near = _near_top_p(ds, logits) | _near_top_p(ds, logits.to(dev))
        differ = torch.isinf(cpu) != torch.isinf(card)
        if (differ & ~near).any():
            fail(f"sampling {spec}: {int((differ & ~near).sum())} mask entries differ away "
                 f"from the top-p boundary")
        both = ~torch.isinf(cpu) & ~torch.isinf(card)
        ulps = (cpu[both].view(torch.int32).long() - card[both].view(torch.int32).long()).abs()
        if ulps.numel() and int(ulps.max()) > 1:
            fail(f"sampling {spec}: kept values {int(ulps.max())} ulps apart")
        print(f"  sampling {json.dumps(spec)}: transform card vs CPU: masks equal but for "
              f"{int(differ.sum())} entries ({int(near.sum())} tokens within 1e-6 of top_p), "
              f"kept values within {int(ulps.max()) if ulps.numel() else 0} ulp, "
              f"{int(both.sum(-1).float().mean())} kept a row", flush=True)
    ds = DeviceSampler(**HARD_SAMPLER)
    gen = ds.init_generator(dev)
    x = logits.to(dev)
    t = timed(lambda: ds.sample(x, gen), nbytes=x.numel() * 4)
    print(f"  sampling: one sample() at [{HARD_SLOTS}, {VOCAB}] (temperature, top-k 40, "
          f"Gumbel-max): {fmt(t)}", flush=True)

    model = build_model(2, HARD_CAP, dev)
    rng = np.random.default_rng(1)
    prompts = hard_prompts(rng)

    def tokens(engine, n_new=100):
        reqs = [engine.submit(p, max_new_tokens=n_new) for p in prompts]
        engine.run()
        return [r.generated for r in reqs]

    greedy = tokens(hard_engine(model, 2, device_sampler=None, greedy_on_device=True), 40)
    for spec in (dict(top_k=1), dict(temperature=1e-6)):
        got = tokens(hard_engine(model, 2, device_sampler=DeviceSampler(seed=0, **spec)), 40)
        if got != greedy:
            n = sum(a != b for a, b in zip(got, greedy))
            fail(f"sampling {spec}: {n} of {len(got)} requests differ from the greedy engine")
    print("  sampling: top_k 1 and temperature 1e-6 give the greedy engine's tokens "
          f"({HARD_SLOTS} requests of 40 tokens, 2 layers)", flush=True)
    runs = {}
    for mode, kw in (("2 dispatches a drain", {}),
                     ("pipeline_dispatch", dict(dispatches_per_drain=1, pipeline_dispatch=True))):
        a, b = tokens(hard_engine(model, 2, **kw)), tokens(hard_engine(model, 2, **kw))
        if a != b:
            fail(f"sampling: the same seed gave different tokens with {mode}")
        runs[mode] = a
    print(f"  sampling: the same seed twice gives the same tokens with 2 dispatches a drain "
          f"and with pipeline_dispatch ({HARD_SLOTS} requests of 100 tokens; the two modes "
          f"{'agree' if runs['pipeline_dispatch'] == runs['2 dispatches a drain'] else 'differ'})",
          flush=True)
    del model
    torch.cuda.empty_cache()

    ds = DeviceSampler(temperature=0.8, top_k=40, top_p=0.9)
    row = logits[:1].to(dev)
    kept_logits = ds.transform(row)[0].double().cpu()
    kept = ~torch.isinf(kept_logits)
    p = torch.softmax(kept_logits, dim=0)
    n, batch = 2 ** 16, 4096
    counts = torch.zeros(VOCAB, dtype=torch.float64, device=dev)
    gen = ds.init_generator(dev)
    for _ in range(n // batch):
        toks, gen = ds.sample(row.expand(batch, VOCAB), gen)
        counts += torch.bincount(toks.long(), minlength=VOCAB).double()
    counts = counts.cpu()
    if counts[~kept].sum() > 0:
        fail(f"sampling: {int(counts[~kept].sum())} draws outside the kept set")
    sigma = (n * p * (1 - p)).sqrt()
    z = ((counts - n * p).abs() / sigma)[kept]
    if z.max() > 5:
        fail(f"sampling: a token's count is {float(z.max()):.2f} sigma from its probability")
    print(f"  sampling: {n} draws from one row (temperature 0.8, top-k 40, top-p 0.9): all in "
          f"the kept set of {int(kept.sum())} tokens, the largest deviation {float(z.max()):.2f} "
          f"sigma", flush=True)


SERVING_PREFIX = [11, 3, 42, 9, 27, 60, 100, 200, 300, 400, 5, 6, 7, 8, 9, 10, 11, 12, 13]
PREFIX_PAGED = dict(paged_blocks=8, block_size=16)  # 7 usable blocks: the prefix takes 2


def _wave(prefix=()):
    """Five seeded (prompt, new tokens) pairs for the small models: prompts
    of 3-11 tokens, or the prefix and 1-8 more."""
    rng = np.random.default_rng(0)
    lo, hi = (1, 9) if prefix else (3, 12)
    return [(list(prefix) + rng.integers(0, 512, int(rng.integers(lo, hi))).tolist(),
             int(rng.integers(3, 14))) for _ in range(5)]


def _serve_wave(eng, wave, adapter_ids=None):
    reqs = [eng.submit(p, max_new_tokens=n, **({} if adapter_ids is None
                                                else dict(adapter_id=adapter_ids[i])))
            for i, (p, n) in enumerate(wave)]
    eng.run()
    return [r.generated for r in reqs]


def card_vs_cpu(dev, tag, make_engine, drive):
    """``drive(make_engine(device))`` on the card and on the CPU: the same
    tokens, or fail. Returns the card's."""
    card, cpu = (drive(make_engine(device)) for device in (dev, torch.device("cpu")))
    if card != cpu:
        fail(f"reference [{tag}]: tokens differ on card and CPU: {card} vs {cpu}")
    return card


# --- loading model files: an exported GPT-2 124M, and the CLI ------------------


ONNX_BATCH, ONNX_T = 4, 128


def _gpt2_onnx(n_layer=12):
    """The shared GPT-2-shaped module (tests/gpt2_onnx.py) at GPT-2 124M's
    published layout (``n_layer`` of its 12 layers), weights from seed 0,
    exported to ONNX under build/ (opset 17, dynamic batch and sequence
    axes). Returns (module, path, export seconds)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import gpt2_onnx

    t0 = time.perf_counter()
    module = gpt2_onnx.GPT2Module(gpt2_onnx.GPT2Shape(n_layer=n_layer), seed=0)
    d = os.path.join(ROOT, "build", "load_onnx")
    os.makedirs(d, exist_ok=True)
    path = gpt2_onnx.export(module, os.path.join(d, f"gpt2_124m_{n_layer}.onnx"))
    return module, path, time.perf_counter() - t0


def _forward_times(model, feed, iters=5):
    """(busy ms, wall ms) per forward of model.run(feed): the card's busy
    time from torch.profiler, the wall time from CUDA events."""

    model.run(feed)
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        model.run(feed)
    t1.record()
    torch.cuda.synchronize()
    wall = t0.elapsed_time(t1) / iters
    with card_profile() as prof:
        for _ in range(iters):
            model.run(feed)
        torch.cuda.synchronize()
    busy = sum(t for _, _, t in device_events(prof)) / 1e3 / iters
    return busy, wall


def phase_load_onnx(dev, n_layer=12):
    """GPT-2 124M exported to ONNX from a hand-written module
    (tests/gpt2_onnx.py), loaded by ``Model.load_file`` onto the card and
    optimized there: 12 Attention nodes, no Softmax, and the same operator
    list as the port's optimizer gives on the CPU. A batch of 4 prompts of
    128 tokens in f32: logits within 1e-3 of max|logit| of the module's own
    forward on the card (TF32 off), mha 12 launches a forward, none on CUDA
    cores. Then ``quantize_dynamic`` (with the int8 prepack, which pads the
    50257-wide lm_head to 51200; ``cli.quantize_model``): 49
    int8_matmul_dequant launches a forward, all tiled (512 rows), and, on
    one prompt, logits within 5e-2 of max|logit| of the port's CPU run of
    the same quantized graph. The counters are zeroed just before the two
    forwards and read just after. ``n_layer`` cuts the depth (the card
    tests); the counts scale with it."""
    from rten_tpu_torch.cli import quantize_model
    from rten_tpu_torch.formats.onnx import ExternalDataLoader, parse_model
    from rten_tpu_torch.model import Model, ModelOptions, graph_from_onnx
    from rten_tpu_torch.optimize import optimize_graph

    tag = f"GPT-2 124M from ONNX ({n_layer} layers)"
    mm_calls = 4 * n_layer + 1
    module, path, export_s = _gpt2_onnx(n_layer)
    t0 = time.perf_counter()
    proto = parse_model(memoryview(np.memmap(path, dtype=np.uint8, mode="r")))
    graph = graph_from_onnx(proto.graph, ExternalDataLoader(os.path.dirname(path)))
    parse_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_ops = [op.op_type for _, op in optimize_graph(graph).operators()]
    optimize_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = Model.load_file(path, device=dev)
    load_s = time.perf_counter() - t0
    ops = [op.op_type for _, op in model.graph.operators()]
    if ops != cpu_ops:
        fail(f"{tag}: the card's optimized graph differs from the CPU optimizer's")
    if ops.count("Attention") != n_layer or "Softmax" in ops:
        fail(f"{tag}: {ops.count('Attention')} Attention nodes, Softmax left: {'Softmax' in ops}")
    print(f"  {tag}: export {export_s:.1f} s ({os.path.getsize(path) / 1e6:.0f} MB); parse "
          f"{parse_s:.2f} s, optimize {optimize_s:.2f} s on the CPU; Model.load_file on the "
          f"card {load_s:.2f} s; {len(ops)} operators: {json.dumps(sorted(set(ops)))}",
          flush=True)

    ids = np.random.default_rng(0).integers(0, VOCAB, (ONNX_BATCH, ONNX_T)).astype(np.int32)
    feed = {"input_ids": ids}
    model.run(feed)  # uploads the weights
    torch.cuda.synchronize()
    for fn in counters().values():
        fn.launches = 0
    logits = model.run(feed)[0]
    torch.cuda.synchronize()
    f32 = {k: fn.launches for k, fn in counters().items()}
    with torch.no_grad():
        want = module.to(dev)(torch.from_numpy(ids).long().to(dev))
    err = (logits - want).abs().max().item() / want.abs().max().item()
    module.cpu()
    if not torch.isfinite(logits).all() or err > 1e-3:
        fail(f"{tag}: f32 logits {err:.3e} of max|logit| from the module's forward")
    if f32["mha"] != n_layer or f32["mha_cuda_core"] or f32["int8_matmul_dequant"]:
        fail(f"{tag}: f32 forward launched {json.dumps(f32)}")
    busy, wall = _forward_times(model, feed)
    print(f"  {tag} f32 [{ONNX_BATCH}, {ONNX_T}]: logits {err:.3e} of max|logit| from the "
          f"module's forward; mha {f32['mha']} launches, {f32['mha_cuda_core']} on CUDA cores; "
          f"busy {busy:.3f} ms, wall {wall:.3f} ms a forward", flush=True)

    t0 = time.perf_counter()
    quantize_model(model, "int8")
    quantize_s = time.perf_counter() - t0
    model.run(feed)
    torch.cuda.synchronize()
    n0 = {k: fn.launches for k, fn in counters().items()}
    model.run(feed)
    torch.cuda.synchronize()
    int8 = {k: fn.launches - n0[k] for k, fn in counters().items()}
    want8 = {"mha": n_layer, "int8_matmul_dequant": mm_calls,
             "int8_matmul_dequant_tiled": mm_calls}
    for k, n in int8.items():
        if n != want8.get(k, 0):
            fail(f"{tag} int8: {k} launched {n} times a forward, expected {want8.get(k, 0)}")
    launches = {k: f32[k] + int8[k] for k in f32}
    one = {"input_ids": ids[:1]}
    got = model.run(one)[0].cpu()
    cpu = Model(model.graph, ModelOptions(optimize=False), device="cpu").run(one)[0]
    err8 = (got - cpu).abs().max().item() / cpu.abs().max().item()
    if not torch.isfinite(got).all() or err8 > 5e-2:
        fail(f"{tag} int8: logits {err8:.3e} of max|logit| from the CPU run")
    busy8, wall8 = _forward_times(model, feed)
    print(f"  {tag} int8: quantize {quantize_s:.2f} s; logits [1, {ONNX_T}] {err8:.3e} of "
          f"max|logit| from the port's CPU run; busy {busy8:.3f} ms, wall {wall8:.3f} ms a "
          f"forward [{ONNX_BATCH}, {ONNX_T}]", flush=True)
    print(f"  load_onnx launches [{tag}]: {json.dumps(launches)}", flush=True)
    return launches, path


def phase_cli(dev, onnx_path, n_layer=12):
    """The CLI (``rten_tpu_torch.cli.main``, what ``python -m
    rten_tpu_torch`` runs) in this process, so the launch counters hold its
    kernels: the GPT-2 124M serving graph of the serve phases (int8 weights,
    int8 cat KV) saved with ``Model.save`` as .rtpu and served by
    ``--serve`` (16 slots, prefill bucket 128, 8 steps a dispatch) from a
    thread; 4 prompts of 128 tokens, 32 new tokens each, one request at a
    time over HTTP, must give the in-process engine's greedy tokens for the
    same prompts one at a time; the kernels launch as the served forwards
    say (``/stats``). Then the timing mode on the exported ONNX file,
    ``-n 3 --quantize int8`` and ``--quantize int4`` at [4, 128]: 49 int8
    (row 1) or int4 (row 9) launches and 12 mha a forward. ``n_layer`` cuts
    the depth of both graphs (the card tests; ``onnx_path`` then holds as
    many layers)."""
    import contextlib
    import io
    import socket
    import threading
    import urllib.request

    from rten_tpu_torch import cli
    from rten_tpu_torch.serving import ContinuousBatchingEngine

    tag = f"CLI ({n_layer} layers)"
    mm_calls = 4 * n_layer + 1
    model = build_model(n_layer, CAP, dev)
    path = os.path.join(ROOT, "build", "load_onnx", f"gpt2_124m_serve_{n_layer}.rtpu")
    t0 = time.perf_counter()
    model.save(path)
    print(f"  {tag}: saved the serving graph in {time.perf_counter() - t0:.2f} s "
          f"({os.path.getsize(path) / 1e6:.0f} MB)", flush=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    threading.Thread(target=cli.main, daemon=True, args=(
        [path, "--serve", str(port), "--slots", "16", "--prefill-bucket", "128",
         "--steps-per-dispatch", "8", "-q"],)).start()
    url = f"http://127.0.0.1:{port}"

    def call(route, payload=None):
        data = None if payload is None else json.dumps(payload).encode()
        req = urllib.request.Request(url + route, data=data,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            return json.loads(r.read())

    deadline = time.time() + 300
    while True:
        try:
            call("/health")
            break
        except Exception as e:  # the server is still loading
            if time.time() > deadline:
                fail(f"{tag}: the server never answered: {e}")
            time.sleep(0.5)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, VOCAB, PROMPT).tolist() for _ in range(4)]
    call("/generate", {"prompt": prompts[0], "max_new_tokens": 2})  # uploads the weights
    steps0 = call("/stats")["decode_steps"]
    torch.cuda.synchronize()
    for fn in counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    got = [call("/generate", {"prompt": p, "max_new_tokens": 32})["tokens"] for p in prompts]
    serve_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    served = {k: fn.launches for k, fn in counters().items()}
    steps, adm = call("/stats")["decode_steps"] - steps0, len(prompts)
    want = {"int8_matmul_dequant": mm_calls * (steps + adm),
            "int8_matmul_dequant_stream": mm_calls * steps + adm,
            "int8_matmul_dequant_tiled": (mm_calls - 1) * adm,
            "decode_mha_append_cat": n_layer * steps, "prefill_mha_cat": n_layer * adm,
            "argmax_lastdim": steps + adm}
    for k, n in served.items():
        if n != want.get(k, 0):
            fail(f"{tag} --serve: {k} launched {n} times, expected {want.get(k, 0)}")
    engine = ContinuousBatchingEngine(model, n_layer=n_layer, n_head=H, head_dim=D, slots=16,
                                      capacity=CAP, prefill_bucket=128, greedy_on_device=True,
                                      steps_per_dispatch=8)
    engine.submit(prompts[0], max_new_tokens=2)
    engine.run()
    ref = []
    for p in prompts:
        r = engine.submit(p, max_new_tokens=32)
        engine.run()
        ref.append(r.generated)
    if got != ref or any(len(t) != 32 for t in got):
        fail(f"{tag} --serve: the server's tokens differ from the in-process engine's")
    print(f"  {tag} --serve: {len(prompts)} requests of {PROMPT} tokens, 32 new each, one at a "
          f"time in {serve_s:.3f} s ({steps} decode steps, {adm} admissions), tokens equal to "
          f"the in-process engine's", flush=True)
    del engine, model
    torch.cuda.empty_cache()

    launches = dict(served)
    for q in ("int8", "int4"):
        argv = [onnx_path, "-n", "3", "--quantize", q, "--size", f"batch={ONNX_BATCH}",
                "--size", f"seq={ONNX_T}", "--range", f"0:{VOCAB}"]
        n0 = {k: fn.launches for k, fn in counters().items()}
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        secs = time.perf_counter() - t0
        torch.cuda.synchronize()
        ran = {k: fn.launches - n0[k] for k, fn in counters().items()}
        mm = "int8_matmul_dequant" if q == "int8" else "int4_matmul"
        if (rc != 0 or ran[mm] != mm_calls * 3 or ran["mha"] != n_layer * 3
                or ran["mha_cuda_core"]):
            fail(f"{tag} --quantize {q}: rc {rc}, launches {json.dumps(ran)}")
        for line in out.getvalue().splitlines():
            print(f"  {tag} --quantize {q} | {line}", flush=True)
        print(f"  {tag} --quantize {q}: {secs:.1f} s in all; {ran[mm]} {mm} and {ran['mha']} "
              f"mha launches over 3 forwards", flush=True)
        for k in launches:
            launches[k] += ran[k]
    print(f"  cli launches [{tag}]: {json.dumps(launches)}", flush=True)
    os.remove(path)
    return launches


# --- vision: ResNet-50 from ONNX, the vision op families, row 1 at any K and N --------


# Row 1 at K and N that are not multiples of 4 (the wrapper widens them,
# kernels/int8_matmul.py:pad_operands): the MNIST and resnet_tiny
# classifiers' N 10, ResNet-50 conv1's im2col K 147 (3 x 7 x 7), K 2.
ODD_KN = ((147, 64), (2048, 10), (147, 10), (2, 12), (2, 1))


def phase_int8_any_kn(gen, dev):
    """int8_matmul_dequant at every form (M 1, 96, 4096) and each of ODD_KN,
    bit-identical to its plain version."""
    seen = []
    for M in (1, 96, 4096):
        for K, N in ODD_KN:
            seen.append(f"M {M} K {K} N {N} {_int8_case(gen, dev, M, K, N, 'odd K, N', False)}")
    print(f"  int8_matmul at K, N not multiples of 4: {len(seen)} cases equal to the plain "
          f"version bit for bit: {'; '.join(seen)}", flush=True)


RESNET_BATCH, RESNET_HW = 16, 224
RESNET_FORWARDS = 3  # timed forwards, then profiled ones, a variant


def _resnet50_onnx():
    """tests/torch_models.resnet50() (He et al. 2015, 1000 classes), weights
    from torch.manual_seed(0), exported at 1 x 3 x 224 x 224 with a
    dynamic batch under build/resnet50 (opset 17, no ``onnx`` package).
    Returns (module, path, export seconds)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from onnx_export_util import export_onnx
    from torch_models import resnet50

    t0 = time.perf_counter()
    torch.manual_seed(0)
    module = resnet50().eval()
    d = os.path.join(ROOT, "build", "resnet50")
    os.makedirs(d, exist_ok=True)
    path = export_onnx(module, torch.randn(1, 3, RESNET_HW, RESNET_HW),
                       os.path.join(d, "resnet50.onnx"), ["image"], ["logits"],
                       dynamic_axes={"image": {0: "batch"}, "logits": {0: "batch"}})
    return module, path, time.perf_counter() - t0


def _int8_criteria(tag, got, want):
    """The JAX package's criteria for a quantized ResNet
    (tests/test_models_e2e.py): top-1 equal to the module's on every image
    and a correlation above 0.99; and, as the random weights' classifier
    bias makes the top-1 the same class for every image, the logits less
    their batch mean (what depends on the image) correlated above 0.95."""
    got, want = got.double(), want.double()
    top = bool((got.argmax(-1) == want.argmax(-1)).all())
    corr = torch.corrcoef(torch.stack([got.flatten(), want.flatten()]))[0, 1].item()
    g, w = got - got.mean(0), want - want.mean(0)
    centered = torch.corrcoef(torch.stack([g.flatten(), w.flatten()]))[0, 1].item()
    if not torch.isfinite(got).all() or not top or corr <= 0.99 or centered <= 0.95:
        fail(f"{tag}: top-1 equal {top}, correlation {corr:.6f}, image-dependent part "
             f"{centered:.6f}")
    return f"top-1 equal to the module's on all {got.shape[0]} images, correlation {corr:.6f} " \
           f"(the image-dependent part {centered:.6f})"


def phase_resnet50(dev):
    """ResNet-50 int8 at batch 16, 224 x 224 (BASELINE.md's second headline
    config; ``tools/bench_models.py:bench_resnet50``'s path) through the
    user's entry points: exported from tests/torch_models.resnet50() to
    ONNX, ``Model.load_file`` onto the card (optimized there), then

    * f32: logits of the first 2 images within 1e-4 of max|logit| of the
      module's own forward on the CPU in f64 (the port convolves f32 in
      f64 on the card: no TF32), no kernel launched;
    * int8 with the default ``quantize_dynamic``: the convs stay f32 and
      the 2048 x 1000 classifier becomes MatMulIntegerToFloat, row 1's
      stream form once a forward;
    * int8 with ``RTEN_QUANT_CONV=all``: every conv of group 1 with C·k >=
      128 and O >= 64 becomes DynamicQuantizeLinear + ConvIntegerToFloat,
      whose im2col product is one row-1 launch (conv1: M 200704, K 147,
      widened to 148 by im2col), plus the classifier's;

    both int8 forms meeting ``_int8_criteria`` against the module's forward
    on the card (TF32 off). The port runs with cuDNN's TF32 flag at
    PyTorch's default (on), which no run may change. Launch counters are
    zeroed just before each variant's forward and read just after; busy
    and wall ms a forward (``_forward_times``). Row 1 is also held against
    its plain version, bit for bit, at every im2col shape the all-convs
    forward gives it (``_conv_im2col_shapes``), and timed at the
    classifier's shape and at conv1's im2col shape. Returns ({path: launches}, [row-1 dicts])."""
    from rten_tpu_torch.model import Model
    from rten_tpu_torch.quantize_pass import quantize_dynamic

    module, path, export_s = _resnet50_onnx()
    x = np.random.default_rng(0).normal(0, 1, (RESNET_BATCH, 3, RESNET_HW, RESNET_HW)) \
        .astype(np.float32)
    feed = {"image": x}
    with torch.no_grad():
        xd = torch.from_numpy(x).to(dev)
        want = module.to(dev)(xd).cpu()

        class _Module:  # the module's forward as a model.run for _forward_times
            def run(self, _):
                return module(xd)

        # The same network in cuDNN's f32 (TF32 off, as this script sets it):
        # what a scoped flag would give the port's convs, beside its f64.
        module_busy, module_wall = _forward_times(_Module(), None, RESNET_FORWARDS)
        del xd
        ref64 = module.cpu().double()(torch.from_numpy(x[:2]).double())
    module.float()
    tf32_default = True  # PyTorch's default for cuDNN convs
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32_default
    launches, rows, lines = {}, [], []

    def forward(model, variant, want_mm):
        model.run(feed)  # uploads the weights
        torch.cuda.synchronize()
        for fn in counters().values():
            fn.launches = 0
        logits = model.run(feed)[0]
        torch.cuda.synchronize()
        ran = {k: fn.launches for k, fn in counters().items()}
        for k, n in ran.items():
            if n != want_mm.get(k, 0):
                fail(f"ResNet-50 {variant}: {k} launched {n} times a forward, expected "
                     f"{want_mm.get(k, 0)}")
        launches[f"resnet50_{variant}"] = ran
        busy, wall = _forward_times(model, feed, RESNET_FORWARDS)
        if (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) != \
                (tf32_default, flags[1]):
            fail(f"ResNet-50 {variant}: the run changed PyTorch's TF32 flags")
        return logits.cpu(), busy, wall

    t0 = time.perf_counter()
    model = Model.load_file(path, device=dev)
    load_s = time.perf_counter() - t0
    ops = [op.op_type for _, op in model.graph.operators()]
    logits, busy, wall = forward(model, "f32", {})
    err = (logits[:2].double() - ref64).abs().max().item() / ref64.abs().max().item()
    if logits.shape != (RESNET_BATCH, 1000) or not torch.isfinite(logits).all() or err > 1e-4:
        fail(f"ResNet-50 f32: logits {tuple(logits.shape)}, {err:.3e} of max|logit| from the "
             f"module's f64 forward")
    lines.append(f"f32: logits [2 images] {err:.3e} of max|logit| from the module's f64 "
                 f"forward on the CPU; busy {busy:.3f} ms, wall {wall:.3f} ms a forward")

    t0 = time.perf_counter()
    quantize_dynamic(model.graph)
    model.executor.invalidate_weights()
    quantize_s = time.perf_counter() - t0
    want_mm = {"int8_matmul_dequant": 1, "int8_matmul_dequant_stream": 1}
    logits, busy, wall = forward(model, "int8", want_mm)
    lines.append(f"int8 (default quantize_dynamic, quantize {quantize_s:.2f} s): "
                 f"{_int8_criteria('ResNet-50 int8', logits, want)}; busy {busy:.3f} ms, wall "
                 f"{wall:.3f} ms a forward")
    del model

    saved = os.environ.get("RTEN_QUANT_CONV")
    os.environ["RTEN_QUANT_CONV"] = "all"
    try:
        model = Model.load_file(path, device=dev)
        t0 = time.perf_counter()
        quantize_dynamic(model.graph)
        model.executor.invalidate_weights()
        quantize_all_s = time.perf_counter() - t0
    finally:
        if saved is None:
            del os.environ["RTEN_QUANT_CONV"]
        else:
            os.environ["RTEN_QUANT_CONV"] = saved
    n_q = sum(op.op_type == "ConvIntegerToFloat" for _, op in model.graph.operators())
    # Every quantized conv's im2col has at least batch x 7 x 7 = 784 rows
    # (tiled); the classifier's 16 (stream).
    want_all = {"int8_matmul_dequant": n_q + 1, "int8_matmul_dequant_tiled": n_q,
                "int8_matmul_dequant_stream": 1}
    logits, busy, wall = forward(model, "int8_all_convs", want_all)
    lines.append(f"int8, RTEN_QUANT_CONV=all ({n_q} ConvIntegerToFloat, quantize "
                 f"{quantize_all_s:.2f} s): {_int8_criteria('ResNet-50 int8 all convs', logits, want)}"
                 f"; busy {busy:.3f} ms, wall {wall:.3f} ms a forward")
    conv_shapes = _conv_im2col_shapes(model.graph)
    del model
    torch.backends.cudnn.allow_tf32 = flags[0]
    os.remove(path)
    print(f"  ResNet-50 [{RESNET_BATCH}, 3, {RESNET_HW}, {RESNET_HW}]: export {export_s:.1f} s, "
          f"Model.load_file on the card {load_s:.2f} s; {len(ops)} operators: "
          f"{json.dumps(sorted(set(ops)))}; the module's own forward (cuDNN f32, TF32 off): "
          f"busy {module_busy:.3f} ms, wall {module_wall:.3f} ms", flush=True)
    for line in lines:
        print(f"  ResNet-50 {line}", flush=True)
    for variant, n in launches.items():
        print(f"  resnet50 launches [{variant}]: int8_matmul_dequant "
              f"{n['int8_matmul_dequant']} (stream {n['int8_matmul_dequant_stream']}, rows "
              f"{n['int8_matmul_dequant_rows']}, tiled {n['int8_matmul_dequant_tiled']})",
              flush=True)
    gen = torch.Generator().manual_seed(17)
    if sum(conv_shapes.values()) != n_q:
        fail(f"ResNet-50 int8 all convs: im2col shapes of {sum(conv_shapes.values())} of the "
             f"{n_q} ConvIntegerToFloat inferred")
    for M, K, N in conv_shapes:
        _int8_case(gen, dev, M, K, N, "ResNet-50 conv im2col", time_it=False)
    print(f"  int8_matmul at every im2col shape of the all-convs forward, equal to the plain "
          f"version bit for bit: {len(conv_shapes)} shapes (M, K, N) x convs: "
          f"{'; '.join(f'{m} {k} {n} x{c}' for (m, k, n), c in conv_shapes.items())}",
          flush=True)
    rows.append(_int8_case(gen, dev, RESNET_BATCH, 2048, 1000, "ResNet-50 classifier"))
    rows.append(_int8_case(gen, dev, RESNET_BATCH * 112 * 112, 148, 64,
                           "ResNet-50 conv1 im2col (RTEN_QUANT_CONV=all)"))
    return launches, rows


def _conv_im2col_shapes(graph):
    """{(M, K, N): convs} of the row-1 launches the ConvIntegerToFloat of
    ``graph`` make at batch RESNET_BATCH, from the port's shape inference:
    M = batch x output positions, K = C·k widened to a multiple of 4 as
    im2col gives it, N = output channels."""
    from rten_tpu_torch.shape_inference import infer_shapes

    info = infer_shapes(graph, {"image": (RESNET_BATCH, 3, RESNET_HW, RESNET_HW)})
    shapes = {}
    for _, op in graph.operators():
        if op.op_type != "ConvIntegerToFloat":
            continue
        out = info.get(op.outputs[0], (None, None))[1]
        w = graph.nodes[op.inputs[1]].array.shape
        if out is None or not all(isinstance(d, int) for d in out):
            continue
        key = (int(np.prod(out)) // out[1], -(-int(np.prod(w[1:])) // 4) * 4, w[0])
        shapes[key] = shapes.get(key, 0) + 1
    return shapes


def _vision_cases(gen):
    """(tag, op, inputs, attrs, exact) one-node graphs of every op of the
    vision families; an input is a tensor (a graph input) or ("const",
    array) (a graph constant)."""
    def f32(*shape):
        return torch.rand(shape, generator=gen) * 6 - 3

    def u8(*shape):
        return torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8)

    def s8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8)

    def const(a, dtype=np.float32):
        return ("const", np.asarray(a, dtype))

    x, xp = f32(2, 16, 20, 20), f32(2, 8, 17, 18)
    grid = torch.rand((2, 9, 11, 2), generator=gen) * 2.6 - 1.3
    return [
        ("conv2d, pads 0/1/2/0, bias", "Conv", [x, f32(32, 16, 3, 3), f32(32)],
         {"pads": [0, 1, 2, 0]}, False),
        ("conv2d, SAME_UPPER k2 s2, group 4", "Conv", [x, f32(32, 4, 2, 2)],
         {"auto_pad": "SAME_UPPER", "strides": [2, 2], "group": 4}, False),
        ("conv2d depthwise, dilation 2", "Conv", [x, f32(16, 1, 3, 3), f32(16)],
         {"group": 16, "dilations": [2, 2], "pads": [2, 2, 2, 2]}, False),
        ("conv1d", "Conv", [f32(2, 8, 31), f32(12, 8, 5)], {"strides": [2], "pads": [2, 1]},
         False),
        ("conv3d", "Conv", [f32(1, 4, 6, 7, 8), f32(6, 4, 3, 3, 3), f32(6)],
         {"pads": [1, 1, 0, 1, 1, 1]}, False),
        ("ConvInteger, zero points, pads", "ConvInteger",
         [u8(2, 8, 12, 12), s8(16, 8, 3, 3), const(131, np.uint8), const(3, np.int8)],
         {"pads": [1, 1, 1, 1]}, True),
        ("ConvIntegerToFloat K 147 N 10 (row 1 widened)", "ConvIntegerToFloat",
         [u8(2, 3, 30, 30), s8(10, 3, 7, 7), const(0.02), f32(10).abs() * 1e-2,
          const(128, np.uint8), None, f32(10)], {"strides": [2, 2], "pads": [3, 3, 3, 3]}, True),
        ("ConvTranspose s2, output_padding, group 2", "ConvTranspose",
         [xp, f32(8, 3, 3, 3), f32(6)],
         {"strides": [2, 2], "output_padding": [1, 0], "pads": [1, 0, 1, 2], "group": 2}, False),
        ("ConvTranspose 1d", "ConvTranspose", [f32(2, 4, 15), f32(4, 5, 4)],
         {"strides": [3], "pads": [1, 2]}, False),
        ("MaxPool k3 s2 p1", "MaxPool", [xp], {"kernel_shape": [3, 3], "strides": [2, 2],
                                               "pads": [1, 1, 1, 1]}, True),
        ("MaxPool ceil, dilation 2", "MaxPool", [xp],
         {"kernel_shape": [2, 3], "strides": [2, 2], "dilations": [2, 2], "ceil_mode": 1}, True),
        ("MaxPool int8", "MaxPool", [s8(2, 4, 9, 9)],
         {"kernel_shape": [3, 3], "strides": [2, 2], "pads": [1, 0, 1, 1], "ceil_mode": 1}, True),
        ("AveragePool ceil", "AveragePool", [xp],
         {"kernel_shape": [3, 3], "strides": [2, 2], "ceil_mode": 1, "pads": [1, 1, 0, 0]},
         False),
        ("AveragePool count_include_pad, 3-D", "AveragePool", [f32(1, 3, 6, 7, 8)],
         {"kernel_shape": [3, 3, 2], "pads": [1, 1, 1, 1, 1, 0], "count_include_pad": 1}, False),
        ("GlobalAveragePool", "GlobalAveragePool", [xp], {}, False),
        ("GlobalMaxPool", "GlobalMaxPool", [xp], {}, True),
        ("Resize linear half_pixel x2", "Resize",
         [xp, const(np.zeros(0)), const([1, 1, 2.0, 2.0])], {"mode": "linear"}, False),
        ("Resize cubic align_corners exclude_outside, sizes", "Resize",
         [xp, const(np.zeros(0)), None, const([2, 8, 25, 9], np.int64)],
         {"mode": "cubic", "coordinate_transformation_mode": "align_corners",
          "exclude_outside": 1}, False),
        ("Resize nearest asymmetric round_prefer_ceil", "Resize",
         [xp, const(np.zeros(0)), const([1, 1, 1.5, 0.5])],
         {"mode": "nearest", "coordinate_transformation_mode": "asymmetric",
          "nearest_mode": "round_prefer_ceil"}, True),
        ("Resize uint8 linear", "Resize", [u8(1, 3, 10, 10), const(np.zeros(0)),
                                           const([1, 1, 1.7, 2.3])], {"mode": "linear"}, True),
        ("Upsample nearest", "Upsample", [xp, const([1, 1, 2.0, 3.0])], {"mode": "nearest"},
         True),
        ("GridSample bilinear reflection", "GridSample", [xp, grid],
         {"padding_mode": "reflection"}, False),
        ("GridSample nearest zeros align_corners", "GridSample", [xp, grid],
         {"mode": "nearest", "align_corners": 1}, True),
        ("GridSample bilinear border align_corners", "GridSample", [xp, grid],
         {"padding_mode": "border", "align_corners": 1}, False),
    ]


def _one_node(op, inputs, attrs, n_out=1):
    """A one-node graph and its feed (tensors become inputs, (name, array)
    pairs constants), its output "y" (with ``n_out`` > 1: y0, y1, ...)."""
    from rten_tpu_torch.dtypes import DataType
    from rten_tpu_torch.ir.builder import GraphBuilder

    b = GraphBuilder()
    ins, feed = [], {}
    for i, v in enumerate(inputs):
        if v is None:
            ins.append(None)
        elif isinstance(v, tuple):
            ins.append(b.constant(f"c{i}", v[1]))
        else:
            arr = v.numpy()
            ins.append(b.input(f"x{i}", DataType.from_np(arr.dtype), arr.shape))
            feed[f"x{i}"] = arr
    names = ["y"] if n_out == 1 else [f"y{i}" for i in range(n_out)]
    outs = b.op(op, ins, attrs, n_outputs=n_out, output_names=names)
    b.output(*(outs if n_out > 1 else (outs,)))
    return b.finish(), feed


def phase_vision_ops(dev):
    """Every op of the vision families (Conv 1-D to 3-D with groups,
    dilations and pads that differ on the two sides, ConvInteger,
    ConvIntegerToFloat through row 1 at K 147 and N 10, ConvTranspose,
    MaxPool, AveragePool, the global pools, Resize, Upsample, GridSample)
    as one-node graphs on the card against the port's CPU run of the same
    graph: integer results, max pools and nearest resizes and samples
    equal, the rest within 1e-5 of max|out| (the f32 convs: f64 on the
    card, oneDNN's f32 on the CPU). Then the precision of f32 convs with
    cuDNN's TF32 flag on (PyTorch's default): a conv of K 576 within 1e-6
    of max|out| of its f64 value, where cuDNN's own f32 conv under the same
    flag reads TF32's error; and ``RunConfig(prefer_bf16=True)``: Conv,
    MatMul and Einsum through one bf16 pass, within bf16's rounding of the
    f64 product of the bf16-rounded operands. No run changes the TF32
    flags."""
    from rten_tpu_torch.model import Model, ModelOptions
    from rten_tpu_torch.runtime.executor import RunConfig

    gen = torch.Generator().manual_seed(23)
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    worst = {}
    for tag, op, inputs, attrs, exact in _vision_cases(gen):
        graph, feed = _one_node(op, inputs, attrs)
        got = Model(graph, ModelOptions(optimize=False), device=dev).run(feed, ["y"])[0]
        want = Model(graph, ModelOptions(optimize=False), device="cpu").run(feed, ["y"])[0]
        got = got.cpu()
        if got.shape != want.shape or got.dtype != want.dtype:
            fail(f"vision op [{tag}]: {tuple(got.shape)} {got.dtype} on the card, "
                 f"{tuple(want.shape)} {want.dtype} on the CPU")
        if exact:
            if not torch.equal(got, want):
                fail(f"vision op [{tag}]: the card's result differs from the CPU's")
            worst[tag] = 0.0
        else:
            err = (got - want).abs().max().item() / max(want.abs().max().item(), 1e-30)
            if not torch.isfinite(got).all() or err > 1e-5:
                fail(f"vision op [{tag}]: {err:.3e} of max|out| from the CPU's")
            worst[tag] = err
    print(f"  vision ops, card against CPU ({len(worst)} one-node graphs): "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in worst.items()})}", flush=True)

    x = torch.rand((4, 64, 28, 28), generator=gen) * 2 - 1
    w = (torch.rand((64, 64, 3, 3), generator=gen) * 2 - 1) * 0.05
    graph, feed = _one_node("Conv", [x, ("const", w.numpy())], {"pads": [1, 1, 1, 1]})
    ref = torch.nn.functional.conv2d(x.double().to(dev), w.double().to(dev), padding=1)
    scale = ref.abs().max().item()
    got = Model(graph, ModelOptions(optimize=False), device=dev).run(feed, ["y"])[0]
    port_err = (got.double() - ref).abs().max().item() / scale
    cudnn = torch.nn.functional.conv2d(x.to(dev), w.to(dev), padding=1)
    tf32_err = (cudnn.double() - ref).abs().max().item() / scale
    if port_err > 1e-6:
        fail(f"f32 Conv on the card: {port_err:.3e} of max|out| from f64 (TF32?)")
    msg = [f"f32 Conv K 576 with cuDNN's TF32 flag on: the port {port_err:.3e} of max|out| "
           f"from f64, cuDNN's f32 conv {tf32_err:.3e}"]

    a = torch.rand((64, 256), generator=gen) * 2 - 1
    bm = torch.rand((256, 96), generator=gen) * 2 - 1
    bf = RunConfig(prefer_bf16=True)
    for tag, op, inputs, attrs, ref_fn in (
            ("Conv", "Conv", [x, ("const", w.numpy())], {"pads": [1, 1, 1, 1]},
             lambda p, q: torch.nn.functional.conv2d(p, q, padding=1)),
            ("MatMul", "MatMul", [a, ("const", bm.numpy())], {}, torch.matmul),
            ("Einsum", "Einsum", [a, bm], {"equation": "ik,kj->ij"}, torch.matmul)):
        graph, feed = _one_node(op, inputs, attrs)
        got = Model(graph, ModelOptions(optimize=False, run_config=bf), device=dev) \
            .run(feed, ["y"])[0]
        p, q = (torch.as_tensor(v[1] if isinstance(v, tuple) else v) for v in inputs)
        ref = ref_fn(p.bfloat16().double().to(dev), q.bfloat16().double().to(dev))
        full = ref_fn(p.double().to(dev), q.double().to(dev))
        scale = full.abs().max().item()
        err_bf = (got.double() - ref).abs().max().item() / scale
        err_full = (got.double() - full).abs().max().item() / scale
        # One bf16 pass: every value on bf16's grid, nearly all the bf16
        # rounding of the exact product of the bf16-rounded operands.
        on_grid = torch.equal(got, got.bfloat16().float())
        same = (got == ref.to(torch.bfloat16).float()).double().mean().item()
        if got.dtype != torch.float32 or not on_grid or same < 0.99 or err_bf > 2 ** -8:
            fail(f"prefer_bf16 {tag}: {got.dtype}, on bf16's grid {on_grid}, {same:.4f} equal to "
                 f"the rounded bf16 product, {err_bf:.3e} of max|out| from it")
        msg.append(f"prefer_bf16 {tag}: f32 values on bf16's grid, {same:.4f} of them the "
                   f"rounded f64 product of the bf16 operands ({err_bf:.3e} of max|out|), "
                   f"{err_full:.3e} of max|out| from the f32 operands' product")
    if (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) != \
            (True, flags[1]):
        fail("a vision op changed PyTorch's TF32 flags")
    torch.backends.cudnn.allow_tf32 = flags[0]
    for line in msg:
        print(f"  {line}", flush=True)


# --- Whisper-tiny and the merged encoder-decoder --------------------------------------

WHISPER_SAMPLES = 480000  # 30 s of 16 kHz audio: mel [1, 80, 3000], 1500 encoder positions
# <|startoftranscript|> <|en|> <|transcribe|> <|notimestamps|> in Whisper's vocabulary
WHISPER_PROMPT = [50258, 50259, 50359, 50363]
WHISPER_NEW = 64
WHISPER_SHARPEN = 3.0  # tests/whisper_weights.py: greedy tokens then vary with the context
WHISPER_MHA_TOL = 2e-5  # each held mha call against mha_plain (6xTF32 scores: phase_whisper)
WHISPER_F64_RATIO = 1.5  # the kernel's largest error from f64 over mha_plain's, at most
WHISPER_MEL_TOL = 1e-4
WHISPER_LOGIT_TOL = 5e-2


def _whisper_audio(seed=0):
    """30 s of seeded audio: noise under a modulated 220 Hz tone and a 1 kHz one."""
    rng = np.random.default_rng(seed)
    t = np.arange(WHISPER_SAMPLES, dtype=np.float64) / 16000
    audio = (0.05 * rng.standard_normal(WHISPER_SAMPLES)
             + 0.3 * np.sin(2 * np.pi * 220 * t) * (1 + np.sin(2 * np.pi * 3 * t)) / 2
             + 0.1 * np.sin(2 * np.pi * 1000 * t))
    return audio.astype(np.float32)[None]


class _Replay:
    """A sampler that feeds the given tokens and records the argmax of the
    logits it is handed."""

    def __init__(self, tokens):
        self.tokens, self.argmax = list(tokens), []

    def sample(self, logits):
        self.argmax.append(int(np.argmax(logits[0])))
        return np.array([self.tokens[len(self.argmax) - 1]], np.int32)


def _whisper_greedy(model, mel, n, sampler=None):
    """``WhisperModel.generator`` (its default config: bucket 32, at most
    448 positions) for n tokens: (tokens, the logits row of each step: the
    prefill's, then one after each token, the Generator)."""
    from rten_tpu_torch.generate import GeneratorConfig

    cfg = GeneratorConfig(bucket_size=32, max_seq_len=model.cfg.max_target_positions)
    if sampler is not None:
        cfg.sampler = sampler
    gen = model.generator(mel, [WHISPER_PROMPT], cfg)
    rows, toks = [gen._pending_logits.copy()], []
    for _ in range(n):
        toks.append(int(next(gen)))
        rows.append(gen._pending_logits.copy())
    return toks, rows, gen


def phase_whisper(dev, gen_t):
    """Whisper-tiny at its published widths (``WhisperConfig()``: 80 mels,
    d_model 384, 4 + 4 layers, 6 heads, vocab 51865, 1500 source and 448
    target positions; tests/whisper_weights.py from seed 0, projections
    sharpened x3) through the user's entry points: 30 s of seeded 16 kHz
    audio through ``build_mel_frontend`` (STFT on the card) into mel [1, 80,
    3000], ``WhisperModel.encode`` and a greedy ``Generator`` of 64 tokens
    after the 4-token start-of-transcript prompt (the default bucket of 32:
    the prefill is 32 rows). After a warm-up transcription the counters are
    zeroed, the transcription runs with every mha call held against
    mha_plain (within 2e-5 on the rows with a column to attend, 0 on the
    others; both also against f64: over the encoder's calls the kernel's
    largest error at most 1.5x mha_plain's, which its 6xTF32 score product
    reaches and 3xTF32's 22 bits did not), and the counters are read: mha 4 an encode at [1, 6, 1500, 64],
    and 8 in the prefill (causal self-attention at 32 rows, cross-attention
    over 1500), nothing else. The card's mel is held against the port's CPU
    run of the same graph (within 1e-4 of max|mel|), and its logits, step by
    step, against the port's CPU run at the same full width (within 5e-2 of
    max|logit|): the greedy tokens equal, or where they part the CPU's top
    two closer than that (then the card replays the CPU's tokens, so each
    step's inputs agree, and the gap is printed). Then the device ms of the
    mel front end, the encode and cross_kv, TTFT, decode tok/s, host wall
    against busy time per decode step, and row 5 timed at the encoder's
    shape. Returns (launches, the timed case)."""
    from rten_tpu_torch.generate import Generator, GeneratorConfig
    from rten_tpu_torch.model import Model
    from rten_tpu_torch.models import whisper

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import whisper_weights

    tag = "Whisper-tiny"
    cfg = whisper.WhisperConfig()
    t0 = time.perf_counter()
    weights = whisper_weights.random_weights(cfg, seed=0, sharpen=WHISPER_SHARPEN)
    audio = _whisper_audio()
    front = Model(whisper.build_mel_frontend(WHISPER_SAMPLES), device=dev)
    model = whisper.WhisperModel(cfg, weights, device=dev)
    mel = front.run({"audio": audio})[0]
    _whisper_greedy(model, mel, 2)  # uploads the weights
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0

    for fn in counters().values():
        fn.launches = 0
    with hold_calls(mha_tol=WHISPER_MHA_TOL) as held:
        mel = front.run({"audio": audio})[0]
        toks, rows, g = _whisper_greedy(model, mel, WHISPER_NEW)
        torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters().items()}
    want = {"mha": cfg.encoder_layers + 2 * cfg.decoder_layers}
    for k, n in launches.items():
        if n != want.get(k, 0):
            fail(f"{tag}: {k} launched {n} times, expected {want.get(k, 0)}")
    errs = held.get("mha", [])
    if len(errs) != want["mha"]:
        fail(f"{tag}: {len(errs)} mha calls held, {want['mha']} launched")
    if mel.shape != (1, cfg.n_mels, WHISPER_SAMPLES // 160) or not torch.isfinite(mel).all():
        fail(f"{tag}: mel {tuple(mel.shape)}, finite: {bool(torch.isfinite(mel).all())}")

    t0 = time.perf_counter()
    cpu_front = Model(front.graph, device="cpu")
    mel_cpu = cpu_front.run({"audio": audio})[0]
    mel_err = (mel.cpu() - mel_cpu).abs().max().item() / mel_cpu.abs().max().item()
    if not mel_err <= WHISPER_MEL_TOL:
        fail(f"{tag}: mel {mel_err:.3e} of max|mel| from the CPU's")
    cpu = whisper.WhisperModel(cfg, weights, device="cpu")
    toks_cpu, rows_cpu, _ = _whisper_greedy(cpu, mel_cpu, WHISPER_NEW)
    cpu_s = time.perf_counter() - t0
    if toks != toks_cpu:  # the card replays the CPU's tokens: each step's inputs agree
        replay = _Replay(toks_cpu)
        _, rows, _ = _whisper_greedy(model, mel, WHISPER_NEW, replay)
        card_tokens = replay.argmax + [int(np.argmax(rows[-1][0]))]
    else:
        card_tokens = toks + [int(np.argmax(rows[-1][0]))]
    cpu_tokens = toks_cpu + [int(np.argmax(rows_cpu[-1][0]))]
    worst, gaps = 0.0, []
    for step, (lg, lc) in enumerate(zip(rows, rows_cpu)):
        scale = np.abs(lc).max()
        if lg.shape != (1, cfg.vocab_size) or not np.isfinite(lg).all():
            fail(f"{tag}: step {step} logits {lg.shape}, finite: {np.isfinite(lg).all()}")
        err = np.abs(lg - lc).max() / scale
        worst = max(worst, err)
        if err > WHISPER_LOGIT_TOL:
            fail(f"{tag}: step {step}: logits {err:.3e} of max|logit| from the CPU's")
        if card_tokens[step] != cpu_tokens[step]:
            top2 = np.sort(lc[0])[-2:]
            gaps.append((step, float((top2[1] - top2[0]) / scale)))
            if top2[1] - top2[0] > WHISPER_LOGIT_TOL * scale:
                fail(f"{tag}: step {step}: token {card_tokens[step]} on the card, "
                     f"{cpu_tokens[step]} on the CPU, top-2 gap {gaps[-1][1]:.3e} of max|logit|")
    print(f"  {tag}: weights, audio, models and a warm-up {build_s:.1f} s; mel "
          f"{tuple(mel.shape)} {mel_err:.3e} of max|mel| from the CPU's; {WHISPER_NEW} greedy "
          f"tokens {'equal to' if toks == toks_cpu else 'parted from'} the CPU's "
          f"({len(set(toks))} distinct; first 16: {toks[:16]}), parted at "
          f"{json.dumps(gaps)} (step, the CPU's top-2 gap of max|logit|); logits at most "
          f"{worst:.3e} of max|logit| from the CPU's over {len(rows)} steps; the CPU run "
          f"{cpu_s:.1f} s", flush=True)
    print(f"  {tag}: mha {launches['mha']} launches a transcription ({cfg.encoder_layers} an "
          f"encode at [1, {cfg.heads}, 1500, {cfg.head_dim}], {2 * cfg.decoder_layers} in the "
          f"32-row prefill), each held against mha_plain: max abs err {max(errs):.3e} (bound "
          f"{WHISPER_MHA_TOL:g}; by call {json.dumps([float(f'{e:.3e}') for e in errs])}); "
          f"against f64, kernel and plain by call "
          f"{json.dumps([[float(f'{e:.3e}') for e in p] for p in held['mha_f64']])}",
          flush=True)
    enc_f64 = held["mha_f64"][:cfg.encoder_layers]
    kernel_f64, plain_f64 = (max(p[i] for p in enc_f64) for i in (0, 1))
    if not kernel_f64 <= WHISPER_F64_RATIO * plain_f64:
        fail(f"{tag}: over the encoder's calls the kernel lands {kernel_f64:.3e} from f64, "
             f"more than {WHISPER_F64_RATIO:g}x mha_plain's {plain_f64:.3e}")
    del cpu, cpu_front

    # Row 5's error from f64 at the encoder's first call with its keys cut
    # to 23 whole tiles or padded to 24 (is it the tail tile of 28?), and
    # on randn inputs of the same shape at two scales.
    from rten_tpu_torch.kernels.flash_attention import mha

    (q, k, v, *_), kw = held["mha_first_call"]
    cases = {"keys 1472": (q, k[:, :, :1472], v[:, :, :1472]), "keys 1500": (q, k, v),
             "keys 1536": (q, torch.cat([k, k[:, :, :36]], 2), torch.cat([v, v[:, :, :36]], 2))}
    g = torch.Generator().manual_seed(1)
    for scale in (1.0, 3.0):
        cases[f"randn x{scale:g}"] = tuple(
            scale * torch.randn(q.shape, generator=g).to(dev) for _ in range(3))
    tail = {name: float(f"{(mha(*t).double() - _mha_f64(*t)).abs().max().item():.3e}")
            for name, t in cases.items()}
    print(f"  {tag}: row 5 from f64 at [1, {cfg.heads}, {cfg.max_source_positions}, "
          f"{cfg.head_dim}] (the encoder's first call, its keys cut or padded; randn): "
          f"{json.dumps(tail)}", flush=True)
    del held, cases

    # Times: the front end, the encode, cross_kv (busy and wall a run), then
    # the Generator's TTFT and decode rate, and a profiled 16 tokens.
    enc = model.encoder.run({"mel": mel})[0]
    times = {name: _forward_times(m, feed) for name, m, feed in (
        ("mel front end", front, {"audio": audio}), ("encode", model.encoder, {"mel": mel}),
        ("cross_kv", model.cross_kv, {"encoder_hidden_states": enc}))}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mel = front.run({"audio": audio})[0]
    gen = model.generator(mel, [WHISPER_PROMPT])
    first = next(gen)
    audio_to_first = time.perf_counter() - t0
    gen.generate(WHISPER_NEW - 1)
    torch.cuda.synchronize()
    m = gen.metrics
    wall_step = sum(m.step_times_s[1:]) / len(m.step_times_s[1:])
    cross, _ = model.encode(mel)
    cfg16 = GeneratorConfig(bucket_size=32, max_seq_len=cfg.max_target_positions,
                            constant_inputs=cross)
    with card_profile() as prof:
        t0 = time.perf_counter()
        Generator(model.decoder, [WHISPER_PROMPT], cfg16).generate(16)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    busy = sum(t for _, _, t in device_events(prof)) / 1e3
    print(f"  {tag} times: " + "; ".join(
        f"{name} busy {b:.3f} ms, wall {w:.3f} ms" for name, (b, w) in times.items())
        + f"; TTFT {m.ttft_s() * 1e3:.3f} ms (the 32-row prefill), audio to first token "
        f"{audio_to_first * 1e3:.3f} ms (front end, encode, cross_kv, prefill; token {first}); "
        f"decode {m.tokens_per_sec():.1f} tok/s (host wall per step {wall_step * 1e3:.3f} ms); "
        f"profiled 16 tokens: busy {busy:.3f} ms in {prof_wall * 1e3:.3f} ms wall, busy per "
        f"forward {busy / 17:.3f} ms over its 17 forwards, the prefill included "
        f"({busy / 17 / (wall_step * 1e3):.3f} of the unprofiled wall per step)", flush=True)
    del model, front, weights
    torch.cuda.empty_cache()
    case = _mha_case(gen_t, dev, "Whisper-tiny's encoder, B 1, H 6, T 1500, D 64, not causal",
                     1, cfg.heads, cfg.heads, 1500, 1500, False, 0.0, 0, cfg.encoder_layers)
    case["launches_per_transcription"] = launches["mha"]
    case["held_max_abs_err"] = max(errs)
    return launches, case


def phase_merged_decoder(dev):
    """The Optimum-style merged decoder of tests/merged_decoder_model.py (an
    ONNX If on use_cache_branch, growing decoder caches, encoder caches made
    on the first run only) exported with torch into build/merged_decoder/,
    loaded by ``Model.load_file`` onto the card and driven by the port's
    ``Generator`` (use_cache_branch a static input, the cross caches kept
    on the card): its greedy tokens equal the torch module's own greedy
    decode on the card, for two prompts. Returns the launches (counters
    zeroed just before the Generator, read just after)."""
    from rten_tpu_torch.generate import Generator, GeneratorConfig
    from rten_tpu_torch.model import Model

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import merged_decoder_model

    tag = "merged decoder"
    d = os.path.join(ROOT, "build", "merged_decoder")
    os.makedirs(d, exist_ok=True)
    t0 = time.perf_counter()
    module = merged_decoder_model.export_merged_decoder(os.path.join(d, "merged.onnx"))
    model = Model.load_file(os.path.join(d, "merged.onnx"), device=dev)
    load_s = time.perf_counter() - t0
    ops = [op.op_type for _, op in model.graph.operators()]
    if "If" not in ops:
        fail(f"{tag}: no If in the loaded graph")
    module = module.to(dev)
    H, D = module.layers[0].H, module.layers[0].D
    launches = {k: 0 for k in counters()}
    for seed, prompt, n_new in ((3, [1, 7, 2], 12), (4, [4, 9], 10)):
        enc = torch.randn(1, 5, module.layers[0].E,
                          generator=torch.Generator().manual_seed(seed)).to(dev)
        z = torch.zeros(1, H, 0, D, device=dev)
        caches, ids, want = [z] * 8, torch.tensor([prompt], device=dev), []
        with torch.no_grad():
            for step in range(n_new):
                out = module(ids, enc, torch.tensor(step > 0), *caches)
                if step == 0:
                    cross = [out[3], out[4], out[7], out[8]]
                caches = [out[1], out[2], cross[0], cross[1], out[5], out[6], cross[2], cross[3]]
                want.append(int(torch.argmax(out[0][0, -1])))
                ids = torch.tensor([[want[-1]]], device=dev)
        for fn in counters().values():
            fn.launches = 0
        gen = Generator(model, prompt, GeneratorConfig(
            max_seq_len=64, constant_inputs={"encoder_hidden_states": enc}))
        got = [int(t) for t in gen.generate(n_new)[0]]
        torch.cuda.synchronize()
        for k, fn in counters().items():
            launches[k] += fn.launches
        if got != want:
            fail(f"{tag}: prompt {prompt}: the port's tokens {got}, the module's {want}")
        cross = [(t.device.type, tuple(t.shape)) for t in gen._cross.values()]
        if len(cross) != 4 or any(d != "cuda" or shape[2] != 5 for d, shape in cross):
            fail(f"{tag}: cross caches {cross}")
    print(f"  {tag}: export and Model.load_file {load_s:.1f} s ({len(ops)} operators, "
          f"{ops.count('If')} If); greedy tokens equal to the module's on the card for 2 "
          f"prompts (last: {got}); launches {json.dumps({k: n for k, n in launches.items() if n})}",
          flush=True)
    del model, module
    return launches


def phase_reference_serving(dev):
    """The rest of the serving stack, the card against the CPU (the plain
    versions), each at the small configs (GPT-2: 2 layers, E 128, H 2,
    vocab 512, cap 64, 3 slots; Llama: 2 layers, E 256, 4 query heads over
    2 KV heads, projections sharpened 2x): the same tokens for host sampling
    through ArgMaxSampler, the full-bucket lm_head (gather_last=False:
    GPT-2 s8 cat, Llama s8 head-major), chunked prefill with a slot
    mid-decode, a shared prefix flat (s8 cat) and paged (GPT-2 s8 cat
    pools, Llama s8 head-major pools; every block back in the pool once
    the prefix is cleared), mixed LoRA adapters at 1 and 4 steps a
    dispatch, speculative decoding with an unrelated draft (gamma 4), 2
    dispatches a drain and pipeline_dispatch; then one HTTP round trip
    through serve_background on the card, against the card engine's own
    tokens."""
    from rten_tpu_torch.generate.sampler import ArgMaxSampler
    from rten_tpu_torch.model import Model
    from rten_tpu_torch.models import gpt2
    from rten_tpu_torch.serving import ContinuousBatchingEngine, SpeculativeEngine
    from rten_tpu_torch.serving.http_server import serve_background

    small = dict(vocab=512, n_embd=128, n_head=2)

    def gpt2_engine(device, k=4, kv="s8", model_kw=None, **kw):
        model = build_model(2, 64, device, kv=kv, **small, **(model_kw or {}))
        return ContinuousBatchingEngine(model, n_layer=2, n_head=2, head_dim=64, slots=3,
                                        capacity=64, prefill_bucket=8, greedy_on_device=True,
                                        steps_per_dispatch=k, **kw)

    llama_small = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
                       num_attention_heads=4, num_key_value_heads=2,
                       max_position_embeddings=128)

    def llama_engine(device, **opts):
        model = build_llama(2, 64, device, sharpen=2.0, **llama_small, **opts)[0]
        return ContinuousBatchingEngine(model, n_layer=2, n_head=4, head_dim=64, slots=3,
                                        capacity=64, prefill_bucket=8, greedy_on_device=True,
                                        steps_per_dispatch=4)

    def wave(eng):
        return _serve_wave(eng, _wave())

    done = []
    card_vs_cpu(dev, "host ArgMaxSampler",
                lambda d: gpt2_engine(d, k=1, sampler=ArgMaxSampler()), wave)
    done.append("host ArgMaxSampler")
    card_vs_cpu(dev, "GPT-2 gather_last=False",
                lambda d: gpt2_engine(d, model_kw=dict(gather_last=False)), wave)
    card_vs_cpu(dev, "Llama gather_last=False",
                lambda d: llama_engine(d, gather_last=False), wave)
    done.append("gather_last=False (GPT-2 s8 cat, Llama s8 head-major)")

    def chunked(eng):
        long_prompt = np.random.default_rng(7).integers(1, 500, 30).tolist()
        short = eng.submit([5, 9, 12], max_new_tokens=10)
        eng.step()  # the short request decodes while the long one prefills
        long_ = eng.submit(long_prompt, max_new_tokens=10)
        eng.run()
        return [short.generated, long_.generated]

    card_vs_cpu(dev, "chunked prefill", lambda d: gpt2_engine(d, chunked_prefill=True), chunked)
    done.append("chunked prefill with a slot mid-decode")

    def prefixed(eng):
        eng.set_shared_prefix(SERVING_PREFIX)
        toks = _serve_wave(eng, _wave(prefix=SERVING_PREFIX))
        if eng.paged:
            held = 1 + len(eng._prefix_shared)  # block 0 and the shared blocks
            held += eng._prefix_tmpl is not None
            if len(eng._free_blocks) != eng.n_blocks - held:
                fail(f"reference [paged prefix]: {len(eng._free_blocks)} blocks free, "
                     f"expected {eng.n_blocks - held}")
            eng.set_shared_prefix([])
            if sorted(eng._free_blocks) != list(range(1, eng.n_blocks)):
                fail("reference [paged prefix]: the pool is not whole once the prefix is cleared")
        return toks

    card_vs_cpu(dev, "GPT-2 prefix flat", gpt2_engine, prefixed)
    card_vs_cpu(dev, "GPT-2 prefix paged",
                lambda d: gpt2_engine(d, model_kw=PREFIX_PAGED), prefixed)
    card_vs_cpu(dev, "Llama prefix paged", lambda d: llama_engine(d, **PREFIX_PAGED), prefixed)
    done.append("shared prefix (GPT-2 flat and paged, Llama paged head-major; pool whole)")

    adapters = {}
    rng = np.random.default_rng(5)
    for i in range(2):
        for tgt, kin, kout in (("attn.c_attn", 128, 384), ("attn.c_proj", 128, 128)):
            a = rng.standard_normal((3, kin, 4)) * 0.1
            b = rng.standard_normal((3, 4, kout)) * 0.1
            a[0] = b[0] = 0.0  # adapter 0: the base model
            adapters[f"lora.{i}.{tgt}.A"] = a.astype(np.float32)
            adapters[f"lora.{i}.{tgt}.B"] = b.astype(np.float32)

    def lora(eng):
        eng.set_lora_adapters(adapters)
        return _serve_wave(eng, _wave(), [i % 3 for i in range(5)])

    for k in (1, 4):
        card_vs_cpu(dev, f"LoRA k {k}", lambda d: gpt2_engine(
            d, k=k, model_kw=dict(lora_rank=4, n_adapters=3)), lora)
    done.append("mixed LoRA adapters (1 and 4 steps a dispatch)")

    draft_w = gpt2.random_weights(gpt2.GPT2Config(vocab_size=512, n_embd=128, n_head=2,
                                                  n_layer=1), seed=99)

    # f32 weights: the verify's rows would otherwise move the per-tensor
    # activation scale away from the greedy engine's.
    def spec_engine(device):
        target = build_model(2, 64, device, kv="s8", gather_last=False, quantize=False,
                             **small)
        dgraph = gpt2.build_graph_static_cache(
            gpt2.GPT2Config(vocab_size=512, n_embd=128, n_head=2, n_layer=1), draft_w,
            capacity=64, kv_quant=True, kernel_append=True)
        return SpeculativeEngine(target, Model(dgraph, device=device), gamma=4, n_layer=2,
                                 n_head=2, head_dim=64, slots=3, capacity=64, prefill_bucket=8)

    spec_rounds = []

    def spec(eng):
        toks = wave(eng)
        spec_rounds.append(eng.stats()["spec_tokens_per_round"])
        return toks

    spec_toks = card_vs_cpu(dev, "speculative", spec_engine, spec)
    greedy_full = card_vs_cpu(dev, "greedy, gather_last=False, f32 weights", lambda d: gpt2_engine(
        d, model_kw=dict(gather_last=False, quantize=False)), wave)
    if spec_toks != greedy_full:
        fail("reference [speculative]: the tokens differ from the greedy engine's")
    done.append(f"speculative decoding, an unrelated draft (gamma 4, "
                f"{spec_rounds[0]:.2f} tokens a round)")
    card_vs_cpu(dev, "2 dispatches a drain", lambda d: gpt2_engine(d, dispatches_per_drain=2),
                wave)
    card_vs_cpu(dev, "pipeline_dispatch", lambda d: gpt2_engine(d, pipeline_dispatch=True), wave)
    done.append("2 dispatches a drain, pipeline_dispatch")
    print(f"  reference [serving]: tokens equal on card and CPU for {'; '.join(done)}",
          flush=True)

    import urllib.request

    # One request at a time, as the HTTP client below sends them.
    direct = gpt2_engine(dev)
    want = [_serve_wave(direct, [pn])[0] for pn in _wave()]
    server, loop = serve_background(gpt2_engine(dev))
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        got = []
        for p, n in _wave():
            req = urllib.request.Request(
                url + "/generate", json.dumps({"prompt": p, "max_new_tokens": n}).encode(),
                {"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                got.append(json.loads(r.read())["tokens"])
        with urllib.request.urlopen(url + "/health", timeout=30) as r:
            health = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        loop.shutdown()
    if got != want or health["status"] != "ok":
        fail(f"reference [HTTP]: tokens {got} vs the engine's {want}, health {health}")
    print(f"  reference [HTTP]: {len(got)} requests through serve_background on the card give "
          f"the card engine's tokens; /health ok", flush=True)


# --- the onnxruntime-genai int4 path, MoE, the contrib/rotary/scatter/random ops ---


GENAI_LAYERS = 22          # TinyLlama-1.1B's depth: the path runs at full depth
GENAI_CUT = 2              # layers of the card-against-CPU check (full width)
GENAI_PROMPT, GENAI_NEW = 128, 32
GENAI_CHECK_STEPS = 16
GENAI_LOGIT_TOL = 1e-4     # of max|logit|, card against the port's CPU run


def _genai_export(n_layer, dev):
    """tests/ort_genai_llama.py's module at TinyLlama-1.1B's published widths
    (``n_layer`` of its 22 layers; weights from seed 0, drawn and quantized
    on the card), exported under build/ort_genai/. Returns (path, weights
    seconds, export seconds)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import dataclasses

    import ort_genai_llama as og

    t0 = time.perf_counter()
    module = og.GenaiLlama(dataclasses.replace(og.GenaiShape(), num_hidden_layers=n_layer),
                           seed=0, device=dev)
    torch.cuda.synchronize()
    weights_s = time.perf_counter() - t0
    d = os.path.join(ROOT, "build", "ort_genai")
    os.makedirs(d, exist_ok=True)
    t0 = time.perf_counter()
    path = og.export(module, os.path.join(d, f"tinyllama_int4_{n_layer}.onnx"))
    return path, weights_s, time.perf_counter() - t0


def _genai_greedy(model, prompt, n):
    """The Generator at bucket 1 for n tokens: (tokens, the logits row of the
    prompt and of each step, the Generator)."""
    from rten_tpu_torch.generate import Generator, GeneratorConfig

    gen = Generator(model, prompt, GeneratorConfig(bucket_size=1, max_seq_len=2048))
    rows, toks = [gen._pending_logits.copy()], []
    for _ in range(n):
        toks.append(int(next(gen)))
        rows.append(gen._pending_logits.copy())
    return toks, rows, gen


GENAI_INT4 = ((2048, 2560), (2048, 2048), (2048, 5632), (2048, 5632), (5632, 2048))
GENAI_LM_HEAD = (2048, 32000)


def _genai_int4_case(gen, dev, M):
    """int4_matmul at one genai layer's five MatMulNBits shapes (packed QKV,
    o_proj, gate, up, down) and the lm_head, with u8 zero points, at M
    rows: within 1e-4 of max|out| of the plain version; the times of the
    six calls beside the bound (one product's operations at the bf16
    rate, or the bytes) and torch.matmul on the dequantized f32 weights."""
    from rten_tpu_torch.kernels.int4_matmul import (
        dequant_nbits, int4_matmul, int4_matmul_plain, unpack_zero_points,
    )

    shapes = list(GENAI_INT4) + [GENAI_LM_HEAD]
    ws = [_int4_weights(gen, dev, K, N, zp=True) for K, N in shapes]
    xs = [torch.randn(M, K, generator=gen).to(dev) for K, _ in shapes]
    err = 0.0
    for (K, N), (p, s, z), x in zip(shapes, ws, xs):
        got = int4_matmul(x, p, s, z, K=K, N=N, block_size=32)
        want = int4_matmul_plain(x, p.reshape(N, -1), s, unpack_zero_points(z, N, K // 32),
                                 K=K, N=N, block_size=32)
        torch.cuda.synchronize()
        err = max(err, (got - want).abs().max().item() / want.abs().max().item())
    if not err <= 1e-4:
        fail(f"int4_matmul at the genai shapes, M {M}: {err:.3e} of max|out| > 1e-4")
    nbytes = sum(K * N // 2 + 4 * N * (K // 32) + N * (K // 64) + 4 * M * (K + N)
                 for K, N in shapes)
    deq = [dequant_nbits(p, s, z, K=K, N=N, block_size=32).T.contiguous()
           for (K, N), (p, s, z) in zip(shapes, ws)]
    k_ms = timed(lambda: [int4_matmul(x, p, s, z, K=K, N=N, block_size=32)
                          for (K, N), (p, s, z), x in zip(shapes, ws, xs)], iters=10,
                 nbytes=nbytes)
    p_ms = timed(lambda: [int4_matmul_plain(x, p.reshape(N, -1), s,
                                            unpack_zero_points(z, N, K // 32), K=K, N=N,
                                            block_size=32)
                          for (K, N), (p, s, z), x in zip(shapes, ws, xs)], iters=3, warmup=1,
                 nbytes=nbytes)
    lib = timed(lambda: [torch.matmul(x, d) for x, d in zip(xs, deq)], iters=10,
                nbytes=sum(4 * (K * N + M * (K + N)) for K, N in shapes))
    bms, by = bound_ms(nbytes, sum(2.0 * M * K * N for K, N in shapes), BF16_FLOPS_PER_S)
    print(f"  int4_matmul at the genai layer's 5 shapes and the lm_head, u8 zero points, M "
          f"{M}: max err {err:.3e} of max|out|; kernel {fmt(k_ms)}, plain {fmt(p_ms)}, "
          f"torch.matmul on f32 weights {fmt(lib)}, bound {bms:.4f} ms ({by})", flush=True)
    return {"unit": f"one TinyLlama genai layer's 5 MatMulNBits and the lm_head, u8 zero "
                    f"points, M = {M}", "max_abs_err": err, **time_keys(k_ms, p_ms, lib),
            "bound_ms": bms, "bound_by": by}


def phase_ort_genai(dev, gen_t):
    """The onnxruntime-genai int4 layout (tests/ort_genai_llama.py) at
    TinyLlama-1.1B's published widths and full depth (22 layers, E 2048, 32
    query heads over 4 KV heads, D 64, FFN 5632, vocabulary 32000; RTN int4
    at block 32 with u8 zero points, packed QKV, f32 activations), exported
    to ONNX, loaded by ``Model.load_file`` onto the card and driven by the
    port's ``Generator`` at bucket 1: a prompt of 128 tokens, 32 greedy
    tokens. The seconds of weights, export, parse, optimize and load_file.
    After a warm-up the counters are zeroed, the Generator runs with every
    mha call held against mha_plain (``HELD_TOL``) and the counters are
    read: int4_matmul once per MatMulNBits node of the loaded graph per
    forward (the prompt's and the 32 steps'), mha 22 (one per layer at the
    prompt; decode steps go to mha_plain), nothing else. Then TTFT and
    decode tok/s from the Generator's Metrics of an unheld run, and busy
    per forward (torch.profiler, CUDA activity) against host wall per
    forward. Then the same export cut to 2 layers at full width on the card
    and through the port's CPU run of the same file: logits within 1e-4 of
    max|logit| at the prompt and each of 16 steps, the tokens equal, at
    least 4 of them distinct. Then rows 9 and 5 timed at this path's shapes
    (``_genai_int4_case`` at M 1 and 128; mha at the prompt's 22 calls).
    Returns (launches, {row: the timed cases})."""
    from rten_tpu_torch.formats.onnx import ExternalDataLoader, parse_model
    from rten_tpu_torch.generate import Generator, GeneratorConfig
    from rten_tpu_torch.model import Model, graph_from_onnx
    from rten_tpu_torch.optimize import optimize_graph

    tag = f"TinyLlama-1.1B int4 (genai layout) from ONNX, {GENAI_LAYERS} layers"
    path, weights_s, export_s = _genai_export(GENAI_LAYERS, dev)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proto = parse_model(memoryview(np.memmap(path, dtype=np.uint8, mode="r")))
    graph = graph_from_onnx(proto.graph, ExternalDataLoader(os.path.dirname(path)))
    parse_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_ops = [op.op_type for _, op in optimize_graph(graph).operators()]
    optimize_s = time.perf_counter() - t0
    del proto, graph
    t0 = time.perf_counter()
    model = Model.load_file(path, device=dev)
    load_s = time.perf_counter() - t0
    ops = [op.op_type for _, op in model.graph.operators()]
    n_nbits = ops.count("MatMulNBits")
    if ops != cpu_ops or ops.count("GroupQueryAttention") != GENAI_LAYERS or n_nbits != (
            5 * GENAI_LAYERS + 1):
        fail(f"{tag}: {ops.count('GroupQueryAttention')} GroupQueryAttention and {n_nbits} "
             f"MatMulNBits nodes, the CPU optimizer's list the same: {ops == cpu_ops}")
    print(f"  {tag}: weights {weights_s:.1f} s (on the card), export {export_s:.1f} s "
          f"({os.path.getsize(path) / 1e6:.0f} MB), parse {parse_s:.1f} s, optimize "
          f"{optimize_s:.1f} s on the CPU, Model.load_file on the card {load_s:.1f} s; "
          f"{len(ops)} operators: {json.dumps(sorted(set(ops)))}", flush=True)

    prompt = np.random.default_rng(0).integers(0, 32000, (1, GENAI_PROMPT))
    _genai_greedy(model, prompt, 2)  # uploads the weights
    torch.cuda.synchronize()
    for fn in counters().values():
        fn.launches = 0
    with hold_calls(mha_tol=HELD_TOL) as held:
        toks, _, _ = _genai_greedy(model, prompt, GENAI_NEW)
        torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters().items()}
    forwards = 1 + GENAI_NEW
    want = {"int4_matmul": n_nbits * forwards, "mha": GENAI_LAYERS,
            "int4_matmul_stream": n_nbits * GENAI_NEW, "int4_matmul_tiled": n_nbits}
    for k, n in launches.items():
        if n != want.get(k, 0):
            fail(f"{tag}: {k} launched {n} times, expected {want.get(k, 0)}")
    errs = held.get("mha", [])
    if len(errs) != GENAI_LAYERS:
        fail(f"{tag}: {len(errs)} mha calls held, {GENAI_LAYERS} launched")
    f64 = held["mha_f64"]

    gen = Generator(model, prompt, GeneratorConfig(bucket_size=1, max_seq_len=2048))
    gen.generate(GENAI_NEW)
    torch.cuda.synchronize()
    m = gen.metrics
    wall_step = sum(m.step_times_s[1:]) / len(m.step_times_s[1:])
    with card_profile() as prof:
        t0 = time.perf_counter()
        Generator(model, prompt, GeneratorConfig(bucket_size=1, max_seq_len=2048)).generate(16)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    busy = sum(t for _, _, t in device_events(prof)) / 1e3
    print(f"  {tag}: {GENAI_NEW} greedy tokens after {GENAI_PROMPT} ({len(set(toks))} distinct; "
          f"first 16: {toks[:16]}); int4_matmul {launches['int4_matmul']} launches ({n_nbits} a "
          f"forward x {forwards}: tiled {launches['int4_matmul_tiled']} at M {GENAI_PROMPT}, "
          f"stream {launches['int4_matmul_stream']} at M 1), mha {launches['mha']} (one a layer "
          f"at the prompt, causal, GQA 32/4, f32), each held against mha_plain: max abs err "
          f"{max(errs):.3e} (bound {HELD_TOL:g}); from f64, kernel {max(e[0] for e in f64):.3e}, "
          f"plain {max(e[1] for e in f64):.3e}", flush=True)
    print(f"  {tag}: TTFT {m.ttft_s() * 1e3:.3f} ms (the {GENAI_PROMPT}-token prompt), decode "
          f"{m.tokens_per_sec():.1f} tok/s (host wall per step {wall_step * 1e3:.3f} ms); "
          f"profiled 16 tokens: busy {busy:.3f} ms in {prof_wall * 1e3:.3f} ms wall, busy per "
          f"forward {busy / 17:.3f} ms over 17 forwards (the prompt's included), host wall per "
          f"forward {prof_wall * 1e3 / 17:.3f} ms", flush=True)
    del model, gen
    torch.cuda.empty_cache()

    cut = f"the same layout cut to {GENAI_CUT} layers"
    path2, _, _ = _genai_export(GENAI_CUT, dev)
    card = Model.load_file(path2, device=dev)
    toks, rows, _ = _genai_greedy(card, prompt, GENAI_CHECK_STEPS)
    t0 = time.perf_counter()
    cpu = Model.load_file(path2, device="cpu")
    toks_cpu, rows_cpu, _ = _genai_greedy(cpu, prompt, GENAI_CHECK_STEPS)
    cpu_s = time.perf_counter() - t0
    worst = 0.0
    for step, (lg, lc) in enumerate(zip(rows, rows_cpu)):
        if lg.shape != (1, 32000) or not np.isfinite(lg).all():
            fail(f"{tag}, {cut}: step {step} logits {lg.shape}, finite {np.isfinite(lg).all()}")
        err = np.abs(lg - lc).max() / np.abs(lc).max()
        worst = max(worst, err)
        if err > GENAI_LOGIT_TOL:
            fail(f"{tag}, {cut}: step {step}: logits {err:.3e} of max|logit| from the CPU's")
    if toks != toks_cpu or len(set(toks)) < 4:
        fail(f"{tag}, {cut}: tokens {toks} on the card, {toks_cpu} on the CPU")
    print(f"  {tag}, {cut}: the card against the port's CPU run of the same file: logits at "
          f"most {worst:.3e} of max|logit| over the prompt and {GENAI_CHECK_STEPS} steps, the "
          f"{GENAI_CHECK_STEPS} tokens equal ({len(set(toks))} distinct: {toks}); the CPU run "
          f"{cpu_s:.1f} s", flush=True)
    os.remove(path)
    os.remove(path2)
    del card, cpu
    torch.cuda.empty_cache()
    cases = {"int4_matmul": [_genai_int4_case(gen_t, dev, M) for M in (1, GENAI_PROMPT)],
             "mha": _mha_case(gen_t, dev, "the genai prompt: B 1, H 32 over 4, T 128, causal",
                              1, 32, 4, GENAI_PROMPT, GENAI_PROMPT, True, 0.0, 0, GENAI_LAYERS)}
    cases["mha"]["held_max_abs_err"] = max(errs)
    return launches, cases


MIXTRAL = dict(vocab_size=32000, n_positions=4096, n_embd=4096, n_layer=1, n_head=32,
               n_experts=8, top_k=2, ffn_dim=14336)
MOE_TOKENS = 16
MOE_TOL = 1e-5  # of max|logit|, card against the port's CPU run


def _mixtral_weights(cfg, dev):
    """``models/moe.random_weights``' names and shapes, the normal draws
    made on the card from a seeded generator and brought back as numpy
    (numpy's draws of 1.6e9 values take about 40 s of host time), scaled
    by 0.02; norms at 1, biases at 0."""
    gen = torch.Generator(device=dev).manual_seed(0)
    E, F, X = cfg.n_embd, cfg.ffn_dim, cfg.n_experts

    def n(*shape):
        return (torch.randn(shape, generator=gen, device=dev) * 0.02).cpu().numpy()

    w = {"wte.weight": n(cfg.vocab_size, E), "wpe.weight": n(cfg.n_positions, E),
         "ln_f.weight": np.ones(E, np.float32), "ln_f.bias": np.zeros(E, np.float32)}
    for i in range(cfg.n_layer):
        p = f"h.{i}"
        w.update({f"{p}.ln_1.weight": np.ones(E, np.float32),
                  f"{p}.ln_1.bias": np.zeros(E, np.float32),
                  f"{p}.attn.c_attn.weight": n(E, 3 * E),
                  f"{p}.attn.c_attn.bias": np.zeros(3 * E, np.float32),
                  f"{p}.attn.c_proj.weight": n(E, E),
                  f"{p}.attn.c_proj.bias": np.zeros(E, np.float32),
                  f"{p}.ln_2.weight": np.ones(E, np.float32),
                  f"{p}.ln_2.bias": np.zeros(E, np.float32),
                  f"{p}.moe.router_w": n(E, X), f"{p}.moe.w_up": n(X, E, 2 * F),
                  f"{p}.moe.w_down": n(X, F, E)})
    torch.cuda.empty_cache()
    return w


def phase_moe(dev):
    """``models/moe.py`` at Mixtral-8x7B's published widths (n_embd 4096, 32
    heads, 8 experts, top 2, ffn 14336 per expert, vocabulary 32000), cut to
    1 layer (32 layers of f32 experts would take about 180 GB, the card has
    80) and n_positions 4096: 16 tokens through dense and capacity dispatch
    on the card against the port's CPU run of the same graph, logits within
    1e-5 of max|logit|; busy and wall per forward. The expert products run
    in f32 (f64 on the card, whatever the TF32 flags). The weights are
    drawn on the card (``_mixtral_weights``), not by ``random_weights``,
    whose numpy draws the tier-1 tests use at small widths. Returns the
    launches of the two card forwards (counters zeroed just before)."""
    from rten_tpu_torch.model import Model, ModelOptions
    from rten_tpu_torch.models import moe

    cfg = moe.MoEConfig(**MIXTRAL)
    tag = "Mixtral-8x7B widths, 1 layer (MoE)"
    t0 = time.perf_counter()
    graph = moe.build_graph(cfg, _mixtral_weights(cfg, dev))
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(1)
    feed = {"input_ids": rng.integers(0, cfg.vocab_size, (1, MOE_TOKENS)).astype(np.int32),
            "attention_mask": np.ones((1, MOE_TOKENS), np.int32),
            "position_ids": np.arange(MOE_TOKENS, dtype=np.int32)[None],
            "past_key_values.0.key": np.zeros((1, cfg.n_head, 0, cfg.head_dim), np.float32),
            "past_key_values.0.value": np.zeros((1, cfg.n_head, 0, cfg.head_dim), np.float32)}
    launches = {k: 0 for k in counters()}
    out = []
    card = Model(graph, ModelOptions(optimize=False), device=dev)
    cpu = Model(graph, ModelOptions(optimize=False), device="cpu")
    for dispatch in ("dense", "capacity"):  # the op reads its attributes at each run
        for _, op in graph.operators():
            if op.op_type == "MoE":
                op.attrs["dispatch"] = dispatch
        card.run(feed)  # uploads the weights (the first time)
        torch.cuda.synchronize()
        for fn in counters().values():
            fn.launches = 0
        got = card.run(feed, ["logits"])[0]
        torch.cuda.synchronize()
        for k, fn in counters().items():
            launches[k] += fn.launches
        busy, wall = _forward_times(card, feed, iters=3)
        got = got.cpu()
        t0 = time.perf_counter()
        want = cpu.run(feed, ["logits"])[0]
        cpu_s = time.perf_counter() - t0
        err = (got - want).abs().max().item() / want.abs().max().item()
        if got.shape != (1, MOE_TOKENS, cfg.vocab_size) or not torch.isfinite(got).all() \
                or err > MOE_TOL:
            fail(f"{tag} {dispatch}: logits {tuple(got.shape)} {err:.3e} of max|logit| from "
                 f"the CPU's")
        out.append(f"{dispatch}: logits {err:.3e} of max|logit| from the CPU's, busy "
                   f"{busy:.3f} ms, wall {wall:.3f} ms a forward (CPU {cpu_s:.1f} s)")
    del card, cpu, graph
    torch.cuda.empty_cache()
    if launches["mha"] != 2 or sum(launches.values()) - launches["mha"]:
        fail(f"{tag}: launches {json.dumps(launches)}, expected mha 2 (one a forward)")
    print(f"  {tag}: graph {build_s:.1f} s; {MOE_TOKENS} tokens; " + "; ".join(out)
          + "; mha 1 a forward", flush=True)
    return launches


def _gqa_cases(gen):
    """The ORT form of GroupQueryAttention at each branch of the JAX
    lowering, as (tag, inputs, attrs): B 2, 16 new rows, 8 query heads over
    2 KV heads, D 64, rotary tables of 256 rows."""
    B, S, Hq, Hkv, Dh, P = 2, 16, 8, 2, 64, 32

    def r(*shape):
        return torch.randn(*shape, generator=gen)

    ang = torch.rand(256, Dh // 2, generator=gen) * 6.3
    rope = [("cos", torch.cos(ang).numpy()), ("sin", torch.sin(ang).numpy())]
    q, k, v = r(B, S, Hq * Dh), r(B, S, Hkv * Dh), r(B, S, Hkv * Dh)
    pk, pv = r(B, Hkv, P, Dh), r(B, Hkv, P, Dh)
    big_k, big_v = r(B, Hkv, 64, Dh), r(B, Hkv, 64, Dh)
    packed = torch.cat([q, k, v], -1)
    base = {"num_heads": Hq, "kv_num_heads": Hkv, "do_rotary": 1}
    pos = ("pos", (torch.arange(S)[None] * 3 + 5).repeat(B, 1).to(torch.int32).numpy())
    seq_const = ("seqlens_k", np.full(B, P + S - 1, np.int32))
    buf_const = ("seqlens_k", np.full(B, 20 + S - 1, np.int32))
    return [
        ("packed QKV", [packed, None, None, pk, pv, None, None, *rope], base),
        ("separate, past concatenated", [q, k, v, pk, pv, None, None, *rope], base),
        ("position ids", [q, k, v, pk, pv, None, None, *rope, pos], base),
        ("attention bias", [q, k, v, pk, pv, None, None, *rope, None, r(B, 1, S, P + S)], base),
        ("head sinks", [q, k, v, pk, pv, None, None, *rope, None, None, r(Hq)], base),
        ("softcap", [q, k, v, pk, pv, None, None, *rope], {**base, "softcap": 8.0}),
        ("window", [q, k, v, pk, pv, None, None, *rope], {**base, "local_window_size": 24}),
        ("seqlens_k constant, past exact", [q, k, v, pk, pv, seq_const, None, *rope], base),
        ("seqlens_k constant, shared buffer", [q, k, v, big_k, big_v, buf_const, None, *rope],
         base),
        ("no past", [q, k, v, None, None, None, None, *rope], base),
    ]


def _registry_cases(gen):
    """(tag, op, inputs, attrs, n_outputs, exact) one-node cases of every op
    of the contrib, rotary, gather and scatter and MoE families."""
    def r(*shape):
        return torch.randn(*shape, generator=gen)

    def ri(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int32)

    x, b = r(4, 16, 256), r(256)
    cases = [("BiasGelu", "BiasGelu", [x, b], {}, 1, False),
             ("FastGelu", "FastGelu", [x, b], {}, 1, False),
             ("FastGelu, no bias", "FastGelu", [x], {}, 1, False),
             ("GeluMicrosoft", "GeluMicrosoft", [x], {}, 1, False),
             ("QuickGelu", "QuickGelu", [x], {"alpha": 1.5}, 1, False),
             ("SimplifiedLayerNormalization", "SimplifiedLayerNormalization",
              [x, ("w", (r(256) + 1).numpy())], {"epsilon": 1e-6}, 1, False),
             ("SkipLayerNormalization", "SkipLayerNormalization",
              [x, r(4, 16, 256), ("g", (r(256) + 1).numpy()), ("b", r(256).numpy()),
               ("bias", r(256).numpy())], {}, 4, False),
             ("SkipSimplifiedLayerNormalization", "SkipSimplifiedLayerNormalization",
              [x, r(4, 16, 256), ("g", (r(256) + 1).numpy())], {}, 4, False),
             ("RotaryEmbedding 4-D, half", "RotaryEmbedding",
              [r(2, 4, 16, 64), ("cos", r(64, 32).numpy()), ("sin", r(64, 32).numpy()),
               ri(0, 64, 2, 16)], {}, 1, False),
             ("RotaryEmbedding 3-D, interleaved, partial", "RotaryEmbedding",
              [r(2, 16, 4 * 64), ("cos", r(64, 16).numpy()), ("sin", r(64, 16).numpy()),
               ri(0, 64, 16)], {"num_heads": 4, "interleaved": 1}, 1, False),
             ("RotaryEmbeddingMS, full-dim caches", "RotaryEmbeddingMS",
              [r(2, 4, 16, 64), ("cos", r(64, 64).numpy()), ("sin", r(64, 64).numpy())],
              {"rotary_embedding_dim": 64}, 1, False),
             ("GatherElements, negative and out of range", "GatherElements",
              [r(6, 40), ri(-8, 8, 6, 25)], {"axis": 0}, 1, True)]
    for bd in (0, 1, 2):
        data = r(3, 4, 5, 6)
        idx = ri(-5, 5, *((3, 4)[:bd] + (7, 2)))
        cases.append((f"GatherND batch_dims {bd}", "GatherND", [data, idx], {"batch_dims": bd},
                      1, True))
    for red in ("none", "add", "mul", "max", "min"):
        upd = r(64, 8)
        idx = ri(-6, 6, 64, 8)  # many duplicates along axis 0 of 5 rows
        cases.append((f"ScatterElements {red}, duplicates", "ScatterElements",
                      [r(5, 8), idx, upd], {"axis": 0, "reduction": red}, 1, red == "none"))
        cases.append((f"ScatterND {red}, duplicates", "ScatterND",
                      [r(4, 6, 8), ri(-4, 4, 50, 2), r(50, 8)], {"reduction": red}, 1,
                      red == "none"))
        cases.append((f"ScatterElements {red} int32", "ScatterElements",
                      [ri(-9, 9, 5, 8), ri(-5, 5, 40, 8), ri(-9, 9, 40, 8)],
                      {"axis": 0, "reduction": red}, 1, True))
    cases.append(("Scatter (alias)", "Scatter", [r(5, 8), ri(0, 5, 9, 8), r(9, 8)],
                  {"axis": 0}, 1, True))
    X, E, F = 4, 64, 32
    for dispatch, act in (("dense", "swiglu"), ("capacity", "gelu"), ("capacity", "silu")):
        Fu = 2 * F if act == "swiglu" else F
        cases.append((f"MoE {dispatch} {act}", "MoE",
                      [r(2, 9, E), ("rw", r(E, X).numpy()), ("up", r(X, E, Fu).numpy()),
                       ("down", r(X, F, E).numpy()), ("bu", r(X, Fu).numpy()),
                       ("bd", r(X, E).numpy())],
                      {"top_k": 2, "activation": act, "dispatch": dispatch,
                       "capacity_factor": 0.75}, 1, False))
    return cases


REGISTRY_TOL = 1e-6  # of max|out|, card against CPU (float results)
RANDOM_N = 2 ** 20


def _random_checks(dev):
    """The random ops on the card: two runs of one executor differ, two
    executors at one seed draw the same, a ``seed`` attribute draws the same
    every run, the moments of 2^20 draws within 5 sigma of the
    distribution's, and Multinomial's frequencies against softmax of its
    logits by a chi-square test at p > 1e-4."""
    from scipy.stats import chi2

    from rten_tpu_torch.model import Model, ModelOptions
    from rten_tpu_torch.runtime.executor import RunConfig

    def model(op, inputs, attrs, seed=0):
        graph, feed = _one_node(op, inputs, attrs)
        opts = ModelOptions(optimize=False, run_config=RunConfig(seed=seed))
        return Model(graph, opts, device=dev), feed

    n = RANDOM_N
    report = {}
    like = torch.zeros(n)
    for op, inputs, attrs, mean, var, mu4 in (
            ("RandomNormal", [], {"shape": [n], "mean": 1.5, "scale": 2.0}, 1.5, 4.0, 3 * 16.0),
            ("RandomNormalLike", [like], {"mean": -1.0, "scale": 0.5}, -1.0, 0.25, 3 * 0.0625),
            ("RandomUniform", [], {"shape": [n], "low": -2.0, "high": 4.0}, 1.0, 3.0,
             6.0 ** 4 / 80),
            ("RandomUniformLike", [like], {"low": 0.0, "high": 1.0}, 0.5, 1 / 12, 1 / 80)):
        m, feed = model(op, inputs, attrs, seed=7)
        a, b = (m.run(feed)[0] for _ in range(2))
        c = model(op, inputs, attrs, seed=7)[0].run(feed)[0]
        s = model(op, inputs, {**attrs, "seed": 3.0})[0]
        s1, s2 = s.run(feed)[0], s.run(feed)[0]
        if a.device.type != "cuda" or torch.equal(a, b) or not torch.equal(a, c) \
                or not torch.equal(s1, s2):
            fail(f"{op}: on {a.device}, two runs differ {not torch.equal(a, b)}, one seed's "
                 f"executors agree {torch.equal(a, c)}, the seed attribute pins the draw "
                 f"{torch.equal(s1, s2)}")
        x = a.double()
        z_mean = (x.mean().item() - mean) / (var / n) ** 0.5
        z_var = (x.var().item() - var) / ((mu4 - var ** 2) / n) ** 0.5
        if abs(z_mean) > 5 or abs(z_var) > 5:
            fail(f"{op}: mean {z_mean:.2f} sigma, variance {z_var:.2f} sigma from the "
                 f"distribution's")
        report[op] = [round(z_mean, 2), round(z_var, 2)]
    logits = torch.tensor([[0.0, 1.0, 2.0, -1.0, 0.5, 3.0, -2.0, 1.5],
                           [2.0, 2.0, 0.0, 0.0, -1.0, 1.0, 0.5, 0.0]])
    m, feed = model("Multinomial", [logits], {"sample_size": n // 8})
    draws = m.run(feed)[0]
    if draws.dtype != torch.int32 or draws.shape != (2, n // 8):
        fail(f"Multinomial: {draws.dtype} {tuple(draws.shape)}")
    ps = []
    for row in range(2):
        counts = torch.bincount(draws[row].long().cpu(), minlength=8).double()
        expect = torch.softmax(logits[row].double(), -1) * counts.sum()
        ps.append(float(chi2.sf(((counts - expect) ** 2 / expect).sum().item(), 7)))
    if min(ps) <= 1e-4:
        fail(f"Multinomial: chi-square p {ps}")
    report["Multinomial chi-square p"] = [float(f"{p:.3g}") for p in ps]
    return report


def phase_registry_ops(dev):
    """Every op of the contrib, rotary, gather, scatter, MoE and random
    families as a one-node graph on the
    card against the port's CPU run of the same graph: the gathers and
    scatters with reduction "none" (duplicates included) and every integer
    result exactly, the rest within 1e-6 of max|out|; the ORT form of
    GroupQueryAttention at each branch (packed QKV, position ids, attention
    bias, head sinks, softcap, window, seqlens_k as a constant over an exact
    past and over a shared buffer, no past) within ``HELD_TOL``; the random
    ops' seed rules and statistics on the card (``_random_checks``).
    Returns the launches of the GroupQueryAttention cases (row 5 where the
    mask is at most 2-D)."""
    from rten_tpu_torch.model import Model, ModelOptions

    gen = torch.Generator().manual_seed(19)
    worst = {}
    for tag, op, inputs, attrs, n_out, exact in _registry_cases(gen):
        graph, feed = _one_node(op, inputs, attrs, n_out)
        outs = ["y"] if n_out == 1 else [f"y{i}" for i in range(n_out)]
        got = Model(graph, ModelOptions(optimize=False), device=dev).run(feed, outs)
        want = Model(graph, ModelOptions(optimize=False), device="cpu").run(feed, outs)
        for g, w in zip(got, want):
            if g.device.type != "cuda" or g.shape != w.shape or g.dtype != w.dtype:
                fail(f"{tag}: {g.device} {tuple(g.shape)} {g.dtype} against {tuple(w.shape)} "
                     f"{w.dtype}")
            g = g.cpu()
            if exact or not w.is_floating_point():
                if not torch.equal(torch.nan_to_num(g.double(), 7.5),
                                   torch.nan_to_num(w.double(), 7.5)):
                    fail(f"{tag}: the card's result is not the CPU's")
                worst[tag] = 0.0
                continue
            scale = max(w.abs().max().item(), 1e-30)
            err = (g - w).abs().max().item() / scale
            worst[tag] = max(worst.get(tag, 0.0), err)
            if not err <= REGISTRY_TOL:
                fail(f"{tag}: {err:.3e} of max|out| from the CPU's")
    for fn in counters().values():
        fn.launches = 0
    for tag, inputs, attrs in _gqa_cases(gen):
        graph, feed = _one_node("GroupQueryAttention", inputs, attrs, 3)
        outs = ["y0", "y1", "y2"]
        got = Model(graph, ModelOptions(optimize=False), device=dev).run(feed, outs)
        want = Model(graph, ModelOptions(optimize=False), device="cpu").run(feed, outs)
        err = max((g.cpu() - w).abs().max().item() for g, w in zip(got, want))
        worst[f"GroupQueryAttention, {tag}"] = err
        if not err <= HELD_TOL or any(g.device.type != "cuda" for g in got):
            fail(f"GroupQueryAttention, {tag}: {err:.3e} from the CPU's (bound {HELD_TOL:g})")
    launches = {k: fn.launches for k, fn in counters().items()}
    random = _random_checks(dev)
    print(f"  registry ops, card against CPU (largest error of max|out|; 0: equal): "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in worst.items()})}", flush=True)
    print(f"  random ops on the card: every seed rule held; moments (mean, variance) in "
          f"sigma and Multinomial's chi-square p: {json.dumps(random)}; GroupQueryAttention "
          f"cases' launches: mha {launches['mha']}", flush=True)
    return launches


def _spec_module():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_tokenizer_spec

    return torch_tokenizer_spec


def _encode_rate(tok, text):
    """(ids, MB/s) of one encode of ``text``."""
    t0 = time.perf_counter()
    ids = tok.encode(text).ids
    return ids, len(text.encode()) / (time.perf_counter() - t0) / 1e6


def phase_text_generate(dev):
    """Text in, text out at GPT-2 124M's full width in int8, through the
    user's entry points (``examples/generate_text.py``'s path):
    ``Tokenizer.from_file`` of tests/torch_tokenizer_spec.py's 50257-entry
    byte-level BPE (written to a temporary file), its native core built and
    asserted, ``gpt2.load(quantize="int8")`` (weights from seed 0), a
    ``Generator`` (bucket 128, greedy) and ``TextDecoder.wrap`` streaming 64
    tokens. The native encode equals the Python encode on the prompt and on
    about 1 MB of text (each core's first, cold-cache encode and a second one
    timed); after a warm-up every launch counter is zeroed, the text streamed
    and the counters read: row 1 49 a forward (the prefill's 128 rows on its
    rows form, each step's one row on its stream form), row 5 12 at the
    prefill, nothing else. The streamed pieces join to a prefix of
    ``tok.decode`` of the tokens, equal to it unless that ends in U+FFFD.
    Row 1 is then held bit for bit against its plain version at the
    prefill's 128 rows (each step's one row is held in the kernel phases).
    Prints TTFT, decode tok/s, the cores' MB/s and TextDecoder's host time a
    token and its share of the streaming loop's host wall (each push decodes
    the whole sequence, so the share grows with the length); then a profiled
    run of 16 streamed tokens gives the card's busy time per forward."""
    import itertools
    import tempfile


    from rten_tpu_torch.generate import Generator, GeneratorConfig, TextDecoder
    from rten_tpu_torch.kernels.int8_matmul import int8_form
    from rten_tpu_torch.models import gpt2
    from rten_tpu_torch.text import Tokenizer

    spec_mod = _spec_module()
    tag = "GPT-2 text generate int8"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        path = spec_mod.write_spec(os.path.join(d, "tokenizer.json"), seed=0)
        spec_s = time.perf_counter() - t0
        tok = Tokenizer.from_file(path)
        native_s = time.perf_counter() - t0 - spec_s
        tok_py = Tokenizer.from_file(path, native=False)
    if tok.core != "native" or tok_py.core != "python" or tok.vocab_size != VOCAB:
        fail(f"{tag}: tokenizer cores {tok.core}/{tok_py.core}, vocabulary {tok.vocab_size}")
    prompt = spec_mod.PROMPT
    ids = tok.encode(prompt).ids
    if ids != tok_py.encode(prompt).ids or len(ids) != len(prompt.split()) + 2:
        fail(f"{tag}: the prompt encodes to {ids} (native) and {tok_py.encode(prompt).ids}")
    text = spec_mod.corpus(1_000_000, seed=0)
    rates = {}
    for core, t in (("native", tok), ("python", tok_py)):
        first, cold = _encode_rate(t, text)
        again, warm = _encode_rate(t, text)
        rates[core] = (first, cold, warm)
        if again != first:
            fail(f"{tag}: two {core} encodes of the corpus differ")
    if rates["native"][0] != rates["python"][0]:
        fail(f"{tag}: the native encode of the corpus is not the Python encode")
    n_bytes = len(text.encode())
    print(f"  tokenizer [{tag}]: spec {spec_s:.2f} s, native core built and loaded "
          f"{native_s:.2f} s; prompt {len(ids)} tokens (native == python); {n_bytes} bytes "
          f"-> {len(rates['native'][0])} tokens, native == python; encode MB/s, first "
          f"(cold cache) / second: native {rates['native'][1]:.3f} / {rates['native'][2]:.3f}, "
          f"python {rates['python'][1]:.3f} / {rates['python'][2]:.3f}", flush=True)

    t0 = time.perf_counter()
    cfg = gpt2.GPT2Config()
    model = gpt2.load(cfg, random_weights(gpt2, cfg), quantize="int8", device=dev)
    gcfg = GeneratorConfig(bucket_size=GEN_BUCKET)
    Generator(model, [ids], gcfg).generate(2)
    torch.cuda.synchronize()
    print(f"  build and warm-up [{tag}]: {time.perf_counter() - t0:.1f} s", flush=True)
    for fn in counters().values():
        fn.launches = 0
    gen = Generator(model, [ids], gcfg)
    decoder = TextDecoder(tok)
    step_s, push_s = [], []

    def tokens():
        for _ in range(GEN_NEW):
            t = time.perf_counter()
            tid = next(gen)
            step_s.append(time.perf_counter() - t)
            t = time.perf_counter()
            yield tid
            push_s.append(time.perf_counter() - t)  # the decoder's push of tid

    pieces = list(decoder.wrap(tokens()))
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters().items()}
    forwards = 1 + gen.metrics.generated_tokens
    prefill_form, step_form = int8_form(GEN_BUCKET), int8_form(1)
    want = {"mha": 12, "int8_matmul_dequant": 49 * forwards,
            f"int8_matmul_dequant_{prefill_form}": 49,
            f"int8_matmul_dequant_{step_form}": 49 * (forwards - 1)}
    for k, n in launches.items():
        if n != want.get(k, 0):
            fail(f"{tag}: {k} launched {n} times, expected {want.get(k, 0)}")
    generated = decoder.ids
    streamed, full = "".join(pieces), tok.decode(generated)
    if len(generated) != GEN_NEW or not all(0 <= t < VOCAB for t in generated):
        fail(f"{tag}: {len(generated)} tokens, in range: {all(0 <= t < VOCAB for t in generated)}")
    if not full.startswith(streamed) or (streamed != full and not full.endswith("�")):
        fail(f"{tag}: the streamed text {streamed!r} is not the decoded {full!r}")
    m = gen.metrics
    push_ms = [s * 1e3 for s in push_s]
    share = sum(push_s) / (sum(push_s) + sum(step_s))
    q = GEN_NEW // 4
    print(f"  text generate [{tag}]: a {len(ids)}-token prompt (bucket {GEN_BUCKET}) -> "
          f"{GEN_NEW} tokens streamed as {len(pieces)} pieces, {len(streamed)} characters; "
          f"TTFT {m.ttft_s() * 1e3:.3f} ms, decode {m.tokens_per_sec():.1f} tok/s (host wall "
          f"per step {statistics.mean(step_s[1:]) * 1e3:.3f} ms); TextDecoder host time per "
          f"token {statistics.mean(push_ms):.4f} ms (first {q} tokens "
          f"{statistics.mean(push_ms[:q]):.4f}, last {q} {statistics.mean(push_ms[-q:]):.4f}), "
          f"{share:.4f} of the streaming loop's host wall", flush=True)
    print(f"  streamed text [{tag}]: {json.dumps(streamed[:160])}", flush=True)
    print(f"  text generate launches [{tag}]: {json.dumps(launches)}", flush=True)
    held = torch.Generator().manual_seed(20)
    forms = {_int8_case(held, dev, GEN_BUCKET, K, VOCAB if N == NP else N, tag, time_it=False)
             for K, N, _ in GPT2_INT8}
    print(f"  row 1 at the prefill's {GEN_BUCKET} rows, the 5 GPT-2 shapes (lm_head N "
          f"{VOCAB}): equal to its plain version bit for bit, {sorted(forms)} form", flush=True)
    with card_profile() as prof:
        t = time.perf_counter()
        profiled = Generator(model, [ids], gcfg)
        "".join(TextDecoder(tok).wrap(itertools.islice(profiled, 16)))
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t
    busy = sum(t for _, _, t in device_events(prof)) / 1e3
    print(f"  profiled 16 streamed tokens [{tag}]: device busy {busy:.3f} ms in "
          f"{prof_wall * 1e3:.3f} ms wall, busy per forward {busy / 17:.3f} ms over its 17 "
          f"forwards, the prefill included ({busy / 17 / (statistics.mean(step_s[1:]) * 1e3):.3f} "
          f"of the unprofiled wall per step)", flush=True)
    del model
    return launches


HOST_LIBS_TOL = 1e-5


def _functional_cases(gen):
    """(tag, helper name, args, kwargs, exact): seeded inputs for every
    ``functional`` helper, at small sizes and at a greedy head's [16, 50257]."""
    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).numpy()

    x, w8, b8 = rn(3, 8), rn(8), rn(8)
    img, ker = rn(1, 3, 33, 41), rn(4, 3, 3, 3)
    boxes = np.concatenate([rn(1, 40, 2, scale=20) + 20, rn(1, 40, 2, scale=20) + 60], -1)
    q = rn(2, 3, 4, scale=3)
    qs, qz = np.asarray([0.05, 0.1, 0.2], np.float32), np.asarray([3, 128, 250], np.uint8)
    head = rn(16, VOCAB, scale=4)
    return [
        ("softmax", "softmax", (head,), {}, False),
        ("log_softmax", "log_softmax", (head,), {}, False),
        ("gelu", "gelu", (x,), {}, False),
        ("gelu tanh", "gelu", (x,), {"approximate": "tanh"}, False),
        ("silu", "silu", (x,), {}, False),
        ("erf", "erf", (x,), {}, False),
        ("sigmoid", "sigmoid", (x,), {}, False),
        ("layer_norm", "layer_norm", (x, w8, b8), {}, False),
        ("rms_norm", "rms_norm", (x, w8), {}, False),
        ("matmul", "matmul", (rn(2, 64, 96), rn(96, 80)), {}, False),
        ("conv2d", "conv2d", (img, ker, b8[:4]), {"strides": (2, 1), "pads": (1, 0, 1, 2)},
         False),
        ("resize nearest", "resize", (img, [1, 3, 66, 20]), {}, True),
        ("resize linear", "resize", (img, [1, 3, 50, 60]), {"mode": "linear"}, False),
        ("top_k", "top_k", (head, 5), {}, True),
        ("arg_max [16, 50257]", "arg_max", (head,), {}, True),
        ("arg_max axis 0", "arg_max", (x,), {"axis": 0, "keepdims": True}, True),
        ("non_max_suppression", "non_max_suppression",
         (boxes.astype(np.float32), rn(1, 3, 40) ** 2, 10, 0.4, 0.1), {}, True),
        ("pad", "pad", (x, [1, 2, 0, 3]), {"value": 1.5}, True),
        ("pad reflect", "pad", (x, [0, 2, 1, 3]), {"mode": "reflect"}, True),
        ("quantize_linear", "quantize_linear", (q, qs, qz), {}, True),
        ("dequantize_linear", "dequantize_linear", (qz.reshape(1, 3, 1), qs, qz), {}, False),
    ]


def phase_host_libs(dev):
    """The host libraries' card paths against the port's CPU runs, from the
    same seeded inputs: every ``functional`` helper (exact where the result
    is an index or an integer, else within ``HOST_LIBS_TOL`` of max|out|),
    ``arg_max`` on f32 over the last axis through row 4 (a greedy head's
    [16, 50257]); CTC greedy and beam decoding (width 8, 3 best) of log-probs
    made by ``functional.log_softmax`` on the card ([200, 32], greedy's
    arg-max through row 4) against the CPU's (the same labels, scores within
    1e-5 relative); ``normalize_image`` of a 3 x 224 x 224 image on the card.
    Every launch counter is zeroed before and read after; row 4 must launch
    once for each f32 last-axis arg-max. Then row 4 is held against its plain
    version at these shapes (not counted), and the native host geometry
    (contours of a 512 x 512 mask, NMS of 2000 boxes) against its Python
    core, with both times."""
    from rten_tpu_torch import ctc, functional, imageproc
    from rten_tpu_torch.kernels.argmax import argmax_lastdim, argmax_plain

    gen = torch.Generator().manual_seed(20)
    cases = _functional_cases(gen)
    logits = (torch.randn(200, 32, generator=gen) * 3).numpy()
    image = torch.rand(3, 224, 224, generator=gen).numpy()
    mean, std = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
    for fn in counters().values():
        fn.launches = 0
    worst = {}
    t0 = time.perf_counter()
    card = {tag: getattr(functional, name)(*args, **kw, device=dev)
            for tag, name, args, kw, _ in cases}
    logp = functional.log_softmax(logits, device=dev)
    greedy, beams = ctc.ctc_greedy_decode(logp), ctc.ctc_beam_search_decode(logp, 8, 3)
    norm = imageproc.normalize_image(torch.from_numpy(image).to(dev), mean, std)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters().items()}
    want = {"argmax_lastdim": 2}  # the greedy head's arg_max and CTC greedy's
    for k, n in launches.items():
        if n != want.get(k, 0):
            fail(f"host libraries: {k} launched {n} times, expected {want.get(k, 0)}")
    for tag, name, args, kw, exact in cases:
        got = card[tag] if isinstance(card[tag], tuple) else (card[tag],)
        ref = getattr(functional, name)(*args, **kw, device="cpu")
        ref = ref if isinstance(ref, tuple) else (ref,)
        for g, w in zip(got, ref):
            if g.device.type != "cuda" or g.shape != w.shape or g.dtype != w.dtype:
                fail(f"functional {tag}: {g.device} {tuple(g.shape)} {g.dtype} against "
                     f"{tuple(w.shape)} {w.dtype}")
            g = g.cpu()
            if exact:
                if not torch.equal(g, w):
                    fail(f"functional {tag}: the card's result is not the CPU's")
                worst[tag] = 0.0
                continue
            err = (g - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
            worst[tag] = max(worst.get(tag, 0.0), err)
            if not err <= HOST_LIBS_TOL:
                fail(f"functional {tag}: {err:.3e} of max|out| from the CPU's")
    logp_cpu = functional.log_softmax(logits, device="cpu")
    for got, ref in zip([greedy, *beams], [ctc.ctc_greedy_decode(logp_cpu),
                                          *ctc.ctc_beam_search_decode(logp_cpu, 8, 3)]):
        if got.labels != ref.labels or abs(got.score - ref.score) > 1e-5 * abs(ref.score):
            fail(f"CTC on the card: {got} against the CPU's {ref}")
    norm_ref = imageproc.normalize_image(image, mean, std, device="cpu")
    norm_err = (norm.cpu() - norm_ref).abs().max().item()
    if norm.device.type != "cuda" or not norm_err <= 1e-6:
        fail(f"normalize_image on the card: {norm_err:.3e} from the CPU's")
    head = torch.from_numpy(cases[0][2][0]).to(dev)
    for x in (head, logp):
        got, ref = argmax_lastdim(x), argmax_plain(x)
        if not torch.equal(got, ref):
            fail(f"argmax_lastdim {tuple(x.shape)} disagrees with its plain version")
    rng = np.random.default_rng(20)
    mask = (rng.random((512, 512)) > 0.7).astype(np.uint8)
    tl = rng.random((2000, 2)) * 500
    boxes = np.concatenate([tl, tl + rng.random((2000, 2)) * 60 + 1], 1).astype(np.float32)
    scores = rng.random(2000).astype(np.float32)
    geo = {}
    for native in (True, False):
        t = time.perf_counter()
        contours = imageproc.find_contours(mask, native=native)
        c_s = time.perf_counter() - t
        t = time.perf_counter()
        kept = imageproc.nms_boxes(boxes, scores, 0.45, 0.1, 300, native=native)
        geo[native] = (contours, kept, c_s, time.perf_counter() - t)
    if geo[True][1] != geo[False][1] or len(geo[True][0]) != len(geo[False][0]) or not all(
            np.array_equal(a, b) for a, b in zip(geo[True][0], geo[False][0])):
        fail("imageproc: the native contours or NMS differ from the Python core's")
    print(f"  host libraries, card against CPU (largest error of max|out|; 0: equal): "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in worst.items()})}; CTC greedy "
          f"{len(greedy.labels)} labels, score {greedy.score:.4f}, beams equal; "
          f"normalize_image {norm_err:.2e}; the card's calls {card_s:.3f} s; launches "
          f"{json.dumps({k: n for k, n in launches.items() if n})}", flush=True)
    print(f"  host geometry: contours of a 512 x 512 mask ({len(geo[True][0])} contours) "
          f"native {geo[True][2] * 1e3:.2f} ms, python {geo[False][2] * 1e3:.2f} ms; NMS of "
          f"2000 boxes ({len(geo[True][1])} kept) native {geo[True][3] * 1e3:.3f} ms, python "
          f"{geo[False][3] * 1e3:.2f} ms (host wall)", flush=True)
    return launches


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi unavailable"
    name = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}; TF32 off for matmul and cuDNN", flush=True)

    from rten_tpu_torch.kernels import _build

    # Every kernel compiles in the background; each phase's first launch
    # waits for its own library only.
    _build.start_build()
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    secs = {"start": time.perf_counter() - t_start}
    last = [time.perf_counter()]  # the end of the last phase

    def lap(phase):
        now = time.perf_counter()
        secs[phase] = now - last[0]
        last[0] = now

    print("kernel phases:", flush=True)
    kernels = [
        phase_int8_matmul(gen, dev, steps=(16, 1, HARD_SLOTS)),
        phase_decode_attention(gen, dev),
        phase_prefill_attention(gen, dev),
        phase_argmax(gen, dev),
    ]
    # The kernels every serve path runs, at the TinyLlama and Qwen paths'
    # shapes too.
    nested = ("unit", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
              "wall_ms", "plain_wall_ms", "library_wall_ms")
    for row, key, other in (
            (kernels[0], "llama", phase_int8_matmul(gen, dev, LLAMA_INT8, L_SLOTS, "TinyLlama")),
            (kernels[3], "llama", phase_argmax(gen, dev, L_SLOTS, L_VOCAB, 32768)),
            (kernels[3], "qwen", phase_argmax(gen, dev, Q_SLOTS, Q_VOCAB, Q_VOCAB))):
        row[key] = {k: other[k] for k in (*nested, "other_shapes") if k in other}
        row["max_abs_err"] = max(row["max_abs_err"], other["max_abs_err"])
    kernels += phase_decode_mha(gen, dev)
    lap("kernels of PRs 1-2")
    kernels.append(phase_paged_decode_mha(gen, dev))
    kernels.append(phase_paged_append(gen, dev))
    lap("paged kernels")
    kernels.append(phase_mha(gen, dev))
    kernels.append(phase_int4_matmul(gen, dev))
    lap("mha and int4_matmul kernels")
    kernels += phase_float_kv_kernels(gen, dev)
    lap("f32/bf16 KV kernels")
    kernels += phase_int4_deferred_kernels(gen, dev)
    lap("int4, recent-window and head-major append kernels")
    head_dims = phase_head_dims(gen, dev)
    for k in kernels:
        errs = head_dims.get(k.get("counter")) or head_dims.get(k["name"])
        if errs and "[" not in k["name"]:
            k["head_dims_max_abs_err"] = errs
    lap("head dims 80, 96, 256, 512")
    d256 = _d256_modes(gen, dev)
    for k in kernels:
        if k["name"] in d256:
            k["cuda_core_d256"] = d256[k["name"]]
    lap("CUDA-core modes of rows 5 and 6a at D 256")
    torch.cuda.empty_cache()
    kernels += phase_decode_attn_tool(dev)
    lap("the decode-attention tool (rows 10-13)")
    torch.cuda.empty_cache()
    print("serve phases:", flush=True)
    weights = tinyllama_weights()
    # path -> the KV cache type it serves from (None: no KV cache kernel)
    path_kv = {}

    def run(path, cache_kv, fn, *args, **kw):
        torch.cuda.empty_cache()
        by_path[path] = fn(dev, *args, **kw)
        path_kv[path] = cache_kv

    by_path = {}
    run("tinyllama_serve", "s8", phase_serve_llama, weights)
    lap(f"TinyLlama serve ({L_CUT_LAYERS} layers, weights included)")
    run("tinyllama_paged_serve", "s8", phase_serve_llama, weights, paged=True)
    lap(f"TinyLlama paged serve ({L_CUT_LAYERS} layers)")
    run("tinyllama_bf16_serve", "bf16", phase_serve_llama, weights, kv="bf16")
    lap(f"TinyLlama bf16 serve ({L_CUT_LAYERS} layers)")
    run("tinyllama_bf16_paged_serve", "bf16", phase_serve_llama, weights, paged=True,
        kv="bf16")
    lap(f"TinyLlama bf16 paged serve ({L_CUT_LAYERS} layers)")
    run("tinyllama_int4_serve", "u4", phase_serve_llama, weights, kv="int4")
    lap(f"TinyLlama int4 serve ({L_CUT_LAYERS} layers)")
    run("tinyllama_append_serve", "head-major append", phase_serve_llama, weights,
        head_major_append=True)
    lap(f"TinyLlama head-major append serve ({L_CUT_LAYERS} layers)")
    del weights
    run("gpt2_serve", "s8", phase_serve)
    lap("GPT-2 serve")
    torch.cuda.empty_cache()
    by_path["gpt2_tp_serve"], tp_holds = phase_tensor_parallel(dev, gen)
    path_kv["gpt2_tp_serve"] = "s8"
    for k in kernels:
        for held in tp_holds.get(k["name"], ()):
            k.setdefault("other_shapes", []).append(held)
            k["max_abs_err"] = max(k["max_abs_err"], held["max_abs_err"])
    lap("GPT-2 tensor-parallel serve (2 ranks on the card, gloo; rows 1-4 at a rank's shapes)")
    run("gpt2_paged_serve", "s8", phase_serve, paged=True)
    lap("GPT-2 paged serve")
    run("gpt2_int4_serve", "s8", phase_serve_int4)
    lap("GPT-2 int4 serve")
    run("gpt2_bf16_serve", "bf16", phase_serve, kv="bf16")
    lap("GPT-2 bf16 serve")
    run("gpt2_bf16_paged_serve", "bf16", phase_serve, paged=True, kv="bf16")
    lap("GPT-2 bf16 paged serve")
    run("gpt2_int4_kv_serve", "u4-deferred", phase_serve_int4_kv)
    lap("GPT-2 int4 KV deferred serve")
    # The GPT-2 phases' weights are still cached here.
    run("gpt2_hard_serve", "s8", phase_serve_hard)
    lap("GPT-2 hard config (cap 1024, sampled, 96 slots)")
    run("qwen_bf16_serve", "bf16", phase_serve_qwen)
    lap(f"Qwen2.5-1.5B bf16 serve ({Q_SERVE_LAYERS} layers, weights included)")
    torch.cuda.empty_cache()
    phase_sampling(dev)
    lap("the device sampler")
    print("generate phases:", flush=True)
    for quantize in (None, "int4"):
        run(f"gpt2_generate_{quantize or 'f32'}", None, phase_generate, quantize)
    lap("GPT-2 generate (f32, int4)")
    print("loading phases:", flush=True)
    torch.cuda.empty_cache()
    by_path["gpt2_onnx_load"], onnx_path = phase_load_onnx(dev)
    path_kv["gpt2_onnx_load"] = None
    lap("GPT-2 124M from ONNX (export, load, f32 and int8 forwards)")
    run("gpt2_cli", "s8", phase_cli, onnx_path)
    os.remove(onnx_path)
    lap("the CLI (--serve, --quantize int8 and int4)")
    print("vision phases:", flush=True)
    torch.cuda.empty_cache()
    resnet_launches, kernels[0]["resnet50"] = phase_resnet50(dev)
    for path, n in resnet_launches.items():
        by_path[path], path_kv[path] = n, None
    lap("ResNet-50 from ONNX (export, load; f32, int8, int8 all convs at batch 16)")
    torch.cuda.empty_cache()
    phase_vision_ops(dev)
    phase_int8_any_kn(gen, dev)
    lap("vision ops card against CPU; int8_matmul_dequant at any K and N")
    print("encoder-decoder phases:", flush=True)
    torch.cuda.empty_cache()
    by_path["whisper_tiny"], whisper_case = phase_whisper(dev, gen)
    path_kv["whisper_tiny"] = None
    mha_row = next(k for k in kernels if k["name"] == "mha")
    mha_row["whisper"] = whisper_case
    mha_row["max_abs_err"] = max(mha_row["max_abs_err"], whisper_case["max_abs_err"],
                                 whisper_case["held_max_abs_err"])
    lap("Whisper-tiny (mel front end, encode, 64 greedy tokens; the CPU reference)")
    by_path["merged_decoder"], path_kv["merged_decoder"] = phase_merged_decoder(dev), None
    lap("the merged encoder-decoder from ONNX through the Generator")
    print("genai, MoE and registry phases:", flush=True)
    torch.cuda.empty_cache()
    by_path["ort_genai"], genai_cases = phase_ort_genai(dev, gen)
    path_kv["ort_genai"] = None
    int4_row = next(k for k in kernels if k["name"] == "int4_matmul")
    int4_row["ort_genai"] = genai_cases["int4_matmul"]
    mha_row["ort_genai"] = genai_cases["mha"]
    mha_row["max_abs_err"] = max(mha_row["max_abs_err"], genai_cases["mha"]["max_abs_err"],
                                 genai_cases["mha"]["held_max_abs_err"])
    lap("TinyLlama-1.1B int4 in the onnxruntime-genai layout from ONNX (22 layers; the "
        "2-layer card against CPU check)")
    torch.cuda.empty_cache()
    by_path["moe"], path_kv["moe"] = phase_moe(dev), None
    lap("Mixtral-8x7B widths, 1 layer, dense and capacity MoE")
    torch.cuda.empty_cache()
    by_path["registry_ops"], path_kv["registry_ops"] = phase_registry_ops(dev), None
    lap("the registry's new ops card against CPU, the random ops")
    print("text and host-library phases:", flush=True)
    torch.cuda.empty_cache()
    by_path["gpt2_text_generate"], path_kv["gpt2_text_generate"] = phase_text_generate(dev), None
    lap("GPT-2 124M int8 text in, text out (tokenizer, Generator, TextDecoder)")
    by_path["host_libs"], path_kv["host_libs"] = phase_host_libs(dev), None
    lap("functional, CTC and imageproc card against CPU")
    for phase in list(secs)[-12:]:
        print(f"  {phase}: {secs[phase]:.1f} s", flush=True)
    # A row's launches: its counter over the paths that serve from its KV
    # cache type (every path for the kernels that read no KV cache). A
    # wrapper's bf16-part tensor-core launches are its launches less those of
    # its CUDA-core and 3xTF32 kernels.
    for n in by_path.values():
        for fn in ("decode_mha_heads", "prefill_mha_cat"):
            n[f"{fn}_tensor_core"] = n[fn] - n[f"{fn}_wide"] - n[f"{fn}_tf32"]
        n["decode_mha_folded_tensor_core"] = (n["decode_mha_folded"]
                                              - n["decode_mha_folded_cuda_core"])
    for k in kernels:
        if "launches" in k:  # the tool's rows: counted on the tool's run
            continue
        kv = k.get("kv")
        kvs = (kv,) if isinstance(kv, str) else kv
        k["launches_by_path"] = {path: n[k.get("counter", k["name"])]
                                 for path, n in by_path.items()
                                 if kv is None or path_kv[path] in (*kvs, None)}
        k["launches"] = sum(k["launches_by_path"].values())
        k.setdefault("route", "cuda")
        if k["name"] == "int4_matmul":  # each form's share of the launches
            k["launches_by_form"] = {f: sum(n[f"int4_matmul_{f}"] for n in by_path.values())
                                     for f in ("stream", "tiled", "cuda_core")}
        if k["name"] == "int8_matmul_dequant":
            k["launches_by_form"] = {f: sum(n[f"int8_matmul_dequant_{f}"]
                                            for n in by_path.values())
                                     for f in ("stream", "rows", "tiled")}
            k["int32_mode_launches"] = sum(n["int8_matmul_dequant_int32"]
                                           for n in by_path.values())
        if k["name"] == "mha":
            k["cuda_core_launches"] = sum(n["mha_cuda_core"] for n in by_path.values())
    print("reference phases:", flush=True)
    sanitizer = phase_sanitizer(out_dir)
    lap("compute-sanitizer (racecheck, memcheck)")
    phase_reference(dev)
    lap("references (GPT-2: small engines, full width)")
    phase_reference_llama(dev)
    lap("references (Llama: small engines, full widths)")
    phase_reference_generate(dev)
    lap("references (Generator)")
    phase_reference_serving(dev)
    lap("references (sampling, full-bucket lm_head, chunks, prefixes, LoRA, speculative, "
        "drains, HTTP)")

    libs = _build.build_all()
    print(f"build: {len(libs)} libraries, in the background from the start "
          f"({_build.build_dir()}); seconds from the start to each nvcc's end: "
          f"{json.dumps({k: round(v, 1) for k, v in _build.BUILD_SECONDS.items()})}", flush=True)
    with open(os.path.join(out_dir, "ptxas.txt"), "w") as f:
        for lib in libs:
            f.write(f"=== {lib} ===\n{_build.ptxas_report(lib)}\n")
    print(f"sanitizer: {json.dumps(sanitizer)}", flush=True)
    print(f"phase seconds: {json.dumps({k: round(v, 1) for k, v in secs.items()})}", flush=True)
    print(f"total: {time.perf_counter() - t_start:.1f} s (build included)", flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {**{k: kern[k] for k in keys}, "kernel_ms": kern["ms"],
         **{k: v for k, v in kern.items() if k not in keys}}
        for kern in kernels
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tp-rank"]:
        tp_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
        sys.exit(0)
    sys.exit(main())
