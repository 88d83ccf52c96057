"""Chip smoke test of the PyTorch/CUDA port (rten_tpu_torch) on one NVIDIA card.

Run from the repository root:  python3 chip_smoke.py

1. Builds every CUDA kernel of the port from ``rten_tpu_torch/csrc`` (one
   nvcc per source, in parallel) and prints the build time.
2. Kernel phases at the serving headline's shapes (slots 120, cap 256,
   prompt 128, GPT-2 124M: E 768, H 12, D 64, vocab 50257): each kernel
   against its plain PyTorch version on the same inputs on the card, then
   CUDA-event times of the kernel, the plain version and one PyTorch
   library call computing the same function (a yardstick only; the port
   never calls it), beside the least time the card could take.
3. Serve phase: GPT-2 124M at full width (12 layers, random weights from
   seed 0, int8 weights, int8 cat KV) behind ContinuousBatchingEngine
   (16 slots, cap 256, prefill bucket 128, 8 steps per dispatch) answering
   24 requests of 128 seeded tokens. The kernels' launch counters are zeroed
   just before and read just after: every kernel must have run.
4. Reference phase: the card against the CPU (the plain versions): a small
   GPT-2 behind the engine gives the same tokens, and GPT-2 at full width cut
   to 2 layers gives finite logits close to the CPU's (see phase_reference).

Prints a ``{"kernels": [...]}`` line, the card's name and power limit, and
as its last line ``{"ok": true, "device": {...}}``. Exits nonzero, printing
no result, when there is no CUDA device or any phase fails. TF32 is off for
matmuls and cuDNN, so every f32 product on the card is full f32.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
INT8_OPS_PER_S = 1.979e15     # int8 tensor cores, dense
F32_FLOPS_PER_S = 67e12       # f32 outside the tensor cores

SLOTS, CAP, PROMPT = 120, 256, 128
E, H, D, VOCAB, NP = 768, 12, 64, 50257, 51200


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def timed(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of fn() over iters, by CUDA events."""
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
    return t0.elapsed_time(t1) / iters


def bound_ms(nbytes: float, ops: float, peak_ops: float):
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak_ops * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# --- kernel phases ------------------------------------------------------------


def int_mm_ms(a, b):
    """Time of torch._int_mm on the same operands (the s8 view of a), the
    library yardstick; None where cuBLAS refuses the layout."""
    a_s8 = (a ^ 0x80).view(torch.int8)
    for bb in (b, b.t().contiguous().t()):
        try:
            torch._int_mm(a_s8, bb)
        except RuntimeError as e:
            print(f"  _int_mm refused {tuple(a.shape)} x {tuple(b.shape)}: {e}".splitlines()[0])
            continue
        return timed(lambda: torch._int_mm(a_s8, bb), iters=10)
    return None


def phase_int8_matmul(gen, dev):
    from rten_tpu_torch.kernels.int8_matmul import (
        int8_matmul_dequant, int8_matmul_dequant_plain,
    )

    # One decode step at slots 120: four projections per layer plus the
    # padded lm_head; admission adds the same four at M = 120 * 128.
    decode = [(768, 2304, 12), (768, 768, 12), (768, 3072, 12), (3072, 768, 12),
              (768, NP, 1)]
    calls = [(SLOTS, K, N, n) for K, N, n in decode]
    calls += [(SLOTS * PROMPT, K, N, 1) for K, N, _ in decode[:4]]
    max_err = 0.0
    per_shape = []
    for M, K, N, _ in calls:
        a = torch.randint(0, 256, (M, K), generator=gen, dtype=torch.uint8).to(dev)
        b = torch.randint(-127, 128, (K, N), generator=gen, dtype=torch.int8).to(dev)
        sa = torch.tensor(0.02, device=dev)
        sb = (torch.rand(N, generator=gen) * 1e-3 + 1e-4).to(dev)
        zp = torch.tensor(131, dtype=torch.uint8, device=dev)
        cs = b.to(torch.int32).sum(0, keepdim=True).to(torch.int32)
        got = int8_matmul_dequant(a, b, sa, sb, zp, None, cs)
        want = int8_matmul_dequant_plain(a, b, sa, sb, zp, None, cs)
        torch.cuda.synchronize()
        # The integer part is exact; the f32 epilogue rounds identically.
        err = (got - want).abs().max().item()
        tol = 1e-6 * want.abs().max().item()
        if not err <= tol:
            fail(f"int8_matmul_dequant M={M} K={K} N={N}: max err {err} > {tol}")
        max_err = max(max_err, err)
        lib = int_mm_ms(a, b)
        k_ms = timed(lambda: int8_matmul_dequant(a, b, sa, sb, zp, None, cs), iters=10)
        p_ms = timed(lambda: int8_matmul_dequant_plain(a, b, sa, sb, zp, None, cs), iters=3, warmup=1)
        nbytes = M * K + K * N + 8 * N + 4 * M * N
        bms, by = bound_ms(nbytes, 2.0 * M * N * K, INT8_OPS_PER_S)
        per_shape.append((M, K, N, k_ms, p_ms, lib, bms, by))
        print(f"  int8_matmul M={M} K={K} N={N}: kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms, _int_mm {lib if lib is None else round(lib, 4)} ms, "
              f"bound {bms:.4f} ms ({by})", flush=True)
        del a, b, got, want
    # The reported unit: one decode step at slots 120 (49 calls).
    step = [(s, n) for s, (_, _, _, n) in zip(per_shape, calls) if s[0] == SLOTS]
    tot = lambda i: sum(s[i] * n for s, n in step)
    lib_tot = None if any(s[5] is None for s, _ in step) else tot(5)
    bytes_bound = sum(s[6] * n for s, n in step if s[7] == "bytes")
    return {
        "name": "int8_matmul_dequant", "route": "cuda",
        "source": "rten_tpu_torch/csrc/int8_matmul.cu",
        "replaces": "rten_tpu/kernels/int8_matmul.py:121",
        "unit": "one decode step at slots 120: 49 calls (12 x 4 projections + lm_head)",
        "max_abs_err": max_err, "ms": tot(3), "plain_ms": tot(4),
        "bound_ms": tot(6),
        "bound_by": "bytes" if bytes_bound >= tot(6) / 2 else "operations",
        "library_ms": lib_tot,
        "library_call": "torch._int_mm (integer product only, no epilogue)",
    }


def _caches(gen, dev, B, Hkv):
    kc = torch.randint(-127, 128, (B, CAP, Hkv * D), generator=gen, dtype=torch.int8).to(dev)
    vc = torch.randint(-127, 128, (B, CAP, Hkv * D), generator=gen, dtype=torch.int8).to(dev)
    ks = (torch.rand(B, Hkv, CAP, 1, generator=gen) * 0.015 + 0.005).to(dev)
    vs = (torch.rand(B, Hkv, CAP, 1, generator=gen) * 0.015 + 0.005).to(dev)
    return kc, vc, ks, vs


def _sdpa_inputs(q, kc, vc, ks, vs, lens, S):
    from rten_tpu_torch.kernels.flash_attention import cat_to_heads

    B, Hkv = ks.shape[:2]
    kf = cat_to_heads(kc, Hkv).float() * ks
    vf = cat_to_heads(vc, Hkv).float() * vs
    j = torch.arange(CAP, device=q.device)
    qpos = lens.long()[:, None, None, None] + torch.arange(S, device=q.device)[None, None, :, None]
    return kf, vf, j <= qpos


def phase_decode_attention(gen, dev):
    from rten_tpu_torch.kernels.flash_attention import (
        decode_mha_append_cat, decode_mha_append_cat_plain,
    )

    B = SLOTS
    q = torch.randn(B, H, 1, D, generator=gen).to(dev)
    kn = torch.randn(B, H, 1, D, generator=gen).to(dev)
    vn = torch.randn(B, H, 1, D, generator=gen).to(dev)
    # Mid-decode lengths, plus the edges: empty cache, last row, past cap.
    lens = torch.randint(128, 192, (B,), generator=gen, dtype=torch.int32)
    lens[:4] = torch.tensor([0, 31, CAP - 1, CAP + 5], dtype=torch.int32)
    lens = lens.to(dev)
    kc, vc, ks, vs = _caches(gen, dev, B, H)
    k1 = [t.clone() for t in (kc, vc, ks, vs)]
    k2 = [t.clone() for t in (kc, vc, ks, vs)]
    got = decode_mha_append_cat(q, *k1[:2], lens, *k1[2:], k_new=kn, v_new=vn)
    want = decode_mha_append_cat_plain(q, *k2[:2], lens, *k2[2:], k_new=kn, v_new=vn)
    torch.cuda.synchronize()
    err = (got[0] - want[0]).abs().max().item()
    if not err <= 1e-3:  # summation order differs
        fail(f"decode_mha_append_cat out: max err {err} > 1e-3")
    for i, name in ((1, "kc"), (2, "vc")):
        if not torch.equal(got[i], want[i]):
            fail(f"decode_mha_append_cat {name}: s8 caches differ")
    for i, name in ((3, "k_scale"), (4, "v_scale")):
        if not torch.allclose(got[i], want[i], rtol=5e-6, atol=0):
            fail(f"decode_mha_append_cat {name}: scales differ")
    # Time over 12 layers' caches, as one decode step reads them.
    layers = [_caches(gen, dev, B, H) for _ in range(12)]
    k_ms = timed(lambda: [decode_mha_append_cat(q, c[0], c[1], lens, c[2], c[3], k_new=kn, v_new=vn)
                          for c in layers], iters=10)
    p_ms = timed(lambda: [decode_mha_append_cat_plain(q, c[0], c[1], lens, c[2], c[3], k_new=kn, v_new=vn)
                          for c in layers], iters=3, warmup=1)
    sd = [_sdpa_inputs(q, *c, lens, 1) for c in layers]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = timed(lambda: [sdpa(q, kf, vf, attn_mask=m) for kf, vf, m in sd], iters=10)
    # Rows attended: lens + 1 (the new row comes from registers, so only
    # lens rows are read back); the new row and its scale are written.
    read = lens.clamp(max=CAP - 1).long().sum().item()
    per_call_bytes = (4 * B * H * D * 2 + 4 * B * H * D * 2 + 4 * B
                      + 2 * read * H * (D + 4) + 2 * B * H * (D + 4))
    per_call_ops = 4.0 * (read + B) * H * D
    bms, by = bound_ms(12 * per_call_bytes, 12 * per_call_ops, F32_FLOPS_PER_S)
    print(f"  decode_mha_append_cat x12: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
          f"sdpa {lib:.4f} ms, bound {bms:.4f} ms ({by})", flush=True)
    return {
        "name": "decode_mha_append_cat", "route": "cuda",
        "source": "rten_tpu_torch/csrc/flash_attention.cu",
        "replaces": "rten_tpu/kernels/flash_attention.py:2597",
        "unit": "one decode step at slots 120, cap 256: 12 calls (one per layer)",
        "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": bms,
        "bound_by": by, "library_ms": lib,
        "library_call": "scaled_dot_product_attention on pre-dequantized f32 K/V (no quantize, no append)",
    }


def phase_prefill_attention(gen, dev):
    from rten_tpu_torch.kernels.flash_attention import (
        prefill_mha_cat, prefill_mha_cat_plain,
    )

    B = SLOTS
    # q as the op hands it over: a head-major view of a [B, S, 3E] qkv.
    qkv = torch.randn(B, PROMPT, 3 * E, generator=gen).to(dev)
    q = qkv[..., :E].reshape(B, PROMPT, H, D).permute(0, 2, 1, 3)
    lens = torch.zeros(B, dtype=torch.int32, device=dev)
    kc, vc, ks, vs = _caches(gen, dev, B, H)
    got = prefill_mha_cat(q, kc, vc, lens, ks, vs)
    want = prefill_mha_cat_plain(q, kc, vc, lens, ks, vs)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not err <= 1e-3:
        fail(f"prefill_mha_cat: max err {err} > 1e-3")
    # Also a chunk at nonzero offsets (lens + S <= cap).
    lens2 = torch.randint(0, CAP - PROMPT, (B,), generator=gen, dtype=torch.int32).to(dev)
    err2 = (prefill_mha_cat(q, kc, vc, lens2, ks, vs)
            - prefill_mha_cat_plain(q, kc, vc, lens2, ks, vs)).abs().max().item()
    if not err2 <= 1e-3:
        fail(f"prefill_mha_cat (offsets): max err {err2} > 1e-3")
    k_ms = timed(lambda: prefill_mha_cat(q, kc, vc, lens, ks, vs), iters=10)
    p_ms = timed(lambda: prefill_mha_cat_plain(q, kc, vc, lens, ks, vs), iters=3, warmup=1)
    kf, vf, m = _sdpa_inputs(q, kc, vc, ks, vs, lens, PROMPT)
    lib = timed(lambda: torch.nn.functional.scaled_dot_product_attention(q, kf, vf, attn_mask=m), iters=10)
    pairs = B * H * PROMPT * (PROMPT + 1) / 2  # causal (row, column) pairs
    nbytes = 4 * B * H * PROMPT * D * 2 + 2 * B * PROMPT * H * (D + 4) + 4 * B
    bms, by = bound_ms(12 * nbytes, 12 * 4.0 * pairs * D, F32_FLOPS_PER_S)
    print(f"  prefill_mha_cat x12: kernel {12 * k_ms:.4f} ms, plain {12 * p_ms:.4f} ms, "
          f"sdpa {12 * lib:.4f} ms, bound {bms:.4f} ms ({by})", flush=True)
    return {
        "name": "prefill_mha_cat", "route": "cuda",
        "source": "rten_tpu_torch/csrc/flash_attention.cu",
        "replaces": "rten_tpu/kernels/flash_attention.py:3301",
        "unit": "one admission of 120 x 128 tokens: 12 calls (one per layer)",
        "max_abs_err": max(err, err2), "ms": 12 * k_ms, "plain_ms": 12 * p_ms,
        "bound_ms": bms, "bound_by": by, "library_ms": 12 * lib,
        "library_call": "scaled_dot_product_attention on pre-dequantized f32 K/V with a mask",
    }


def phase_argmax(gen, dev):
    from rten_tpu_torch.kernels.argmax import argmax_lastdim, argmax_plain

    logits = torch.randn(SLOTS, NP, generator=gen).to(dev)
    x = logits[:, :VOCAB]                       # the engine's strided view
    x[0, 7] = x[0, 9] = 1e4                     # a tie: the lower index wins
    x[1, VOCAB - 1] = 1e4                       # the last column
    got = argmax_lastdim(x)
    want = argmax_plain(x)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if err != 0 or int(got[0]) != 7:
        fail("argmax_lastdim disagrees with its plain version")
    k_ms = timed(lambda: argmax_lastdim(x))
    p_ms = timed(lambda: argmax_plain(x))
    lib = timed(lambda: torch.argmax(x, dim=-1))
    bms, by = bound_ms(4.0 * SLOTS * VOCAB + 4 * SLOTS, float(SLOTS * VOCAB), F32_FLOPS_PER_S)
    print(f"  argmax_lastdim: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
          f"torch.argmax {lib:.4f} ms, bound {bms:.4f} ms ({by})", flush=True)
    return {
        "name": "argmax_lastdim", "route": "cuda",
        "source": "rten_tpu_torch/csrc/argmax.cu",
        "replaces": "rten_tpu/kernels/argmax.py:60",
        "unit": "one call on [120, 50257] logits (row stride 51200)",
        "max_abs_err": float(err), "ms": k_ms, "plain_ms": p_ms, "bound_ms": bms,
        "bound_by": by, "library_ms": lib, "library_call": "torch.argmax",
    }


# --- serve and reference phases -----------------------------------------------


def build_model(n_layer, capacity, device, vocab=VOCAB, n_embd=E, n_head=H):
    from rten_tpu_torch.model import Model
    from rten_tpu_torch.models import gpt2
    from rten_tpu_torch.quantize_pass import quantize_dynamic

    cfg = gpt2.GPT2Config(vocab_size=vocab, n_layer=n_layer, n_embd=n_embd, n_head=n_head)
    weights = gpt2.random_weights(cfg, seed=0)
    graph = gpt2.build_graph_static_cache(
        cfg, weights, capacity=capacity, kv_quant=True, kernel_append=True,
        gather_last=True,
    )
    quantize_dynamic(graph)
    return Model(graph, device=device)


def counters():
    from rten_tpu_torch.kernels import argmax, flash_attention, int8_matmul

    return {
        "int8_matmul_dequant": int8_matmul.int8_matmul_dequant,
        "decode_mha_append_cat": flash_attention.decode_mha_append_cat,
        "prefill_mha_cat": flash_attention.prefill_mha_cat,
        "argmax_lastdim": argmax.argmax_lastdim,
    }


def phase_serve(dev, name):
    from rten_tpu_torch.serving import ContinuousBatchingEngine

    model = build_model(12, CAP, dev)
    engine = ContinuousBatchingEngine(
        model, n_layer=12, n_head=H, head_dim=D, slots=16, capacity=CAP,
        prefill_bucket=128, greedy_on_device=True, steps_per_dispatch=8,
    )
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, VOCAB, PROMPT).tolist() for _ in range(24)]
    budgets = [int(rng.integers(16, 49)) for _ in range(24)]
    for fn in counters().values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [engine.submit(p, max_new_tokens=n) for p, n in zip(prompts, budgets)]
    engine.run()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters().items()}
    for r, n in zip(reqs, budgets):
        if not r.done or len(r.generated) != n or r.error:
            fail(f"request {r.request_id}: {len(r.generated)} of {n} tokens")
        if not all(0 <= t < VOCAB for t in r.generated):
            fail(f"request {r.request_id}: token out of range")
    # One admission stamps the first token of all its requests at once.
    admissions = len({r.first_token_at for r in reqs})
    forwards = engine.steps + admissions
    want = {
        "int8_matmul_dequant": 49 * forwards,
        "decode_mha_append_cat": 12 * engine.steps,
        "prefill_mha_cat": 12 * admissions,
        "argmax_lastdim": forwards,
    }
    for k, n in launches.items():
        if n == 0 or n != want[k]:
            fail(f"{k}: {n} launches on the served path, expected {want[k]}")
    toks = sum(len(r.generated) for r in reqs)
    ttft = statistics.median(r.ttft_s for r in reqs)
    print(f"  serve: {len(reqs)} requests, {toks} tokens in {elapsed:.3f} s = "
          f"{toks / elapsed:.1f} tok/s, TTFT p50 {ttft * 1e3:.1f} ms, "
          f"{admissions} admissions, {engine.steps} decode steps [{name}]", flush=True)
    print(f"  serve launches: {json.dumps(launches)}", flush=True)
    profile_wave(engine, prompts[:16], elapsed / forwards)
    return launches


def profile_wave(engine, prompts, wall_per_forward):
    """One more full wave (16 requests of 17 tokens: an admission and two
    dispatches of 8 steps) under torch.profiler: the card's busy time, by
    kernel, against the host's wall time. The profiler slows the host, so
    the idle share is stated against the unprofiled wall time per forward
    of the serve run as well."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    reqs = [engine.submit(p, max_new_tokens=17) for p in prompts]
    forwards = 1 + 16
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if not all(r.done and len(r.generated) == 17 for r in reqs):
        fail("profiled wave: a request did not finish with its tokens")
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    if busy_ms <= 0:
        print("  profile: the profiler recorded no device time (not measured)", flush=True)
        return
    print(f"  profile: {forwards} forwards, device busy {busy_ms:.3f} ms in "
          f"{wall * 1e3:.3f} ms profiled wall ({busy_ms / (wall * 1e3):.3f} busy); "
          f"busy per forward {busy_ms / forwards:.3f} ms vs unprofiled wall per "
          f"forward {wall_per_forward * 1e3:.3f} ms "
          f"({busy_ms / forwards / (wall_per_forward * 1e3):.3f} busy)", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d} x  {e.key[:90]}",
              flush=True)


def phase_reference(dev):
    """The card against the CPU (the kernels' plain versions), two ways.

    1. A small GPT-2 (2 layers, E 128, H 2, vocab 512, cap 64) behind the
       engine, 5 requests on 3 slots, 4 steps per dispatch: the same tokens.
    2. GPT-2 at full width cut to 2 layers: one admission and 3 decode
       steps from the same inputs: finite logits of the right shape, the
       same greedy tokens unless the CPU's top two are within the logit
       tolerance, and logits within 5e-2 of their maximum. The activations
       are quantized per tensor, so where the two devices' sums round one
       activation to the neighbouring u8 code the logits move by up to
       ~1.5e-2 of their maximum (measured on the CPU against the JAX
       package); a kernel fault moves them by far more.
    """
    from rten_tpu_torch.serving import ContinuousBatchingEngine

    toks = {}
    for device in (dev, torch.device("cpu")):
        model = build_model(2, 64, device, vocab=512, n_embd=128, n_head=2)
        eng = ContinuousBatchingEngine(
            model, n_layer=2, n_head=2, head_dim=64, slots=3, capacity=64,
            prefill_bucket=8, greedy_on_device=True, steps_per_dispatch=4,
        )
        rng = np.random.default_rng(0)
        reqs = [eng.submit(rng.integers(0, 512, int(rng.integers(3, 12))).tolist(),
                           max_new_tokens=int(rng.integers(3, 14))) for _ in range(5)]
        eng.run()
        toks[device.type] = [r.generated for r in reqs]
    if toks["cuda"] != toks["cpu"]:
        fail(f"reference: small engine tokens differ: {toks['cuda']} vs {toks['cpu']}")

    outs = {}
    slots, T = 4, 16
    for device in (dev, torch.device("cpu")):
        model = build_model(2, 64, device)
        rng = np.random.default_rng(1)
        ids = rng.integers(0, VOCAB, (slots, T)).astype(np.int32)
        caches = {}
        for name, _, shape in model.input_info():
            if name.startswith("past_key_values."):
                dt = np.int8 if name.endswith(("key", "value")) else np.float32
                caches[name] = np.zeros((slots,) + tuple(shape[1:]), dt)
        names = [n for n in model.output_names() if n.startswith("present.")]
        feed = dict(caches, input_ids=ids, past_lens=np.zeros(slots, np.int32),
                    position_ids=np.tile(np.arange(T, dtype=np.int32), (slots, 1)),
                    last_pos=np.full(slots, T - 1, np.int32))
        res = []
        lens = np.full(slots, T, np.int32)
        for step in range(4):
            got = model.run(feed, ["logits", "next_token"] + names)
            logits, tok = got[0][:, 0].cpu().numpy(), got[1][:, 0].cpu().numpy()
            if logits.shape != (slots, VOCAB) or not np.isfinite(logits).all():
                fail(f"reference: logits {logits.shape} on {device}, finite: "
                     f"{np.isfinite(logits).all()}")
            res.append((logits, tok))
            feed = {"past_key_values." + n[len("present."):]: t
                    for n, t in zip(names, got[2:])}
            feed.update(input_ids=tok.astype(np.int32)[:, None], past_lens=lens,
                        position_ids=lens[:, None], last_pos=np.zeros(slots, np.int32))
            lens = lens + 1
        outs[device.type] = res
    worst, tol = 0.0, 5e-2
    for (lg, tg), (lc, tc) in zip(outs["cuda"], outs["cpu"]):
        scale = np.abs(lc).max()
        err = np.abs(lg - lc).max() / scale
        worst = max(worst, err)
        if err > tol:
            fail(f"reference: logits differ by {err:.2e} of max|logit|")
        for s in np.nonzero(tg != tc)[0]:
            top2 = np.sort(lc[s])[-2:]
            if top2[1] - top2[0] > tol * scale:
                fail(f"reference: slot {s} token {tg[s]} vs CPU {tc[s]}")
    print(f"  reference: small engine tokens equal on card and CPU; full width, "
          f"2 layers: logits max err {worst:.3e} of max|logit|, tokens "
          f"{'equal' if all((a[1] == b[1]).all() for a, b in zip(outs['cuda'], outs['cpu'])) else 'differ only at near ties'}",
          flush=True)


def main() -> int:
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

    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"build: {len(libs)} libraries in {time.perf_counter() - t0:.1f} s "
          f"({_build.build_dir()})", flush=True)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "ptxas.txt"), "w") as f:
        for lib in libs:
            f.write(f"=== {lib} ===\n{_build.ptxas_report(lib)}\n")

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    print("kernel phases:", flush=True)
    kernels = [
        phase_int8_matmul(gen, dev),
        phase_decode_attention(gen, dev),
        phase_prefill_attention(gen, dev),
        phase_argmax(gen, dev),
    ]
    torch.cuda.empty_cache()
    print("serve phase:", flush=True)
    launches = phase_serve(dev, name)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print("reference phase:", flush=True)
    phase_reference(dev)

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
    sys.exit(main())
