"""Times kernel calls of this tree against the same calls of another copy of
the package (say, the parent commit's), on one card, on the same inputs, in
turns (other, this, this, other), each beside its plain version.

    mkdir -p build/parent && git archive <rev> rten_tpu_torch | tar -x -C build/parent
    python3 -m rten_tpu_torch.tools.ab_time build/parent [--cases heads,prefill,vpu]

The other copy is imported under the name ``rten_parent`` (``build/parent``
is ignored by git; its libraries build under ``build/parent/build``). Each
copy builds only the libraries its cases launch. Cases:

* ``heads``: ``decode_mha_heads`` at an admission of 16 slots x 128 rows, H
  8 over 1 KV head, cap 256, lens in [0, 128] (``chip_smoke.py``'s D 256
  case): s8, int4 and bf16 caches at D 256 and f32 caches at D 256 and 512,
  8 calls (one per layer's caches) a unit; SDPA on the same K/V (the
  quantized kinds dequantized to f32) with the same mask beside them.
* ``prefill``: ``prefill_mha_cat`` (the per-head kernels through the
  strides of cat caches' head-major views) at the same admission on f32
  and bf16 cat caches at D 256.
* ``vpu``: the tool's ``vpu_attn`` at its shape (slots 32, H 12, cap 256,
  D 64), at slots 128 and at slots 8 (the keys split over blocks), one
  call a unit; SDPA with the same mask beside it.

Device time per unit from ``chip_smoke.timed`` (torch.profiler, CUDA
activity), one JSON line per case with the card's name and power limit.
Needs the card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
HEADS_LIBS = {"this": ("decode_mha_wide_heads", "decode_mha_wide_heads_f32"),
              "other": ("decode_mha_wide", "decode_mha_wide_heads", "decode_mha_wide_heads_f32")}
LIBS = {"heads": HEADS_LIBS, "prefill": HEADS_LIBS,
        "vpu": {"this": ("bench_decode_attn",), "other": ("bench_decode_attn",)}}


def _restrict(build, names):
    """Build only the libraries ``names`` (and the headers) of a copy."""
    every = build._sources

    def sources():
        return [p for p in every() if p.suffix == ".cuh" or p.stem in names]

    build._sources = sources


def _load_other(path, libs):
    pkg = os.path.join(os.path.abspath(path), "rten_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "rten_parent", os.path.join(pkg, "__init__.py"), submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["rten_parent"] = mod
    spec.loader.exec_module(mod)
    from rten_parent.kernels import _build as other_build  # noqa: E402

    _restrict(other_build, libs)
    import rten_parent.kernels.flash_attention as ofa  # noqa: E402
    import rten_parent.tools.bench_decode_attn as otb  # noqa: E402

    return ofa, otb


def case_heads(this, other, dev, timed, ms_of):
    from chip_smoke import _dequant, _quant_head_major, _row_bytes  # noqa: E402

    B, H, Hkv, S, cap, calls = 16, 8, 1, 128, 256, 8
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for kind, D in (("s8", 256), ("int4", 256), ("bf16", 256), ("f32", 256), ("f32", 512)):
        gen = torch.Generator().manual_seed(D + len(kind))
        lens = torch.randint(0, cap - S + 1, (B,), generator=gen, dtype=torch.int32).to(dev)
        q = torch.randn(B, H, S, D, generator=gen).to(dev)
        layers = []
        for _ in range(calls):
            c = _quant_head_major(gen, dev, kind, B, Hkv, D)
            layers.append((c, _dequant(*c)))
        qpos = lens.long()[:, None] + torch.arange(S, device=dev)[None]
        mask = (torch.arange(cap, device=dev)[None, None, :] <= qpos[:, :, None])[:, None]
        kv_rows = (lens.long() + S).clamp(max=cap).sum().item()
        nbytes = calls * (2 * 4 * B * H * S * D + 4 * B + 2 * kv_rows * Hkv * _row_bytes(kind, D))
        res = {"case": "heads", "kv": kind, "D": D, "unit": f"{calls} calls, {B} x {S} rows, "
               f"H {H} over {Hkv}, cap {cap}"}
        want = this.decode_mha_plain(q, *layers[0][0][:2], lens, *layers[0][0][2:])
        for name, fa in (("other", other), ("this", this)):
            got = fa.decode_mha_heads(q, *layers[0][0][:2], lens, *layers[0][0][2:])
            torch.cuda.synchronize()
            res[f"{name}_max_abs_err"] = (got - want).abs().max().item()
        for turn, (name, fa) in enumerate((("other", other), ("this", this), ("this", this),
                                           ("other", other))):
            t = timed(lambda: [fa.decode_mha_heads(q, c[0], c[1], lens, c[2], c[3])
                               for c, _ in layers], iters=5, nbytes=nbytes)
            res[f"{name}_ms_{turn}"] = ms_of(t)
        t = timed(lambda: [sdpa(q, kf, vf, attn_mask=mask, enable_gqa=True)
                           for _, (kf, vf) in layers],
                  iters=5, nbytes=nbytes)
        res["sdpa_ms"] = ms_of(t)
        if kind == "bf16":  # SDPA on the same bf16 K/V, a bf16 q
            qb = q.to(torch.bfloat16)
            t = timed(lambda: [sdpa(qb, c[0], c[1], attn_mask=mask, enable_gqa=True)
                               for c, _ in layers], iters=5, nbytes=nbytes // 2)
            res["sdpa_bf16_ms"] = ms_of(t)
        t = timed(lambda: [this.decode_mha_plain(q, c[0], c[1], lens, c[2], c[3])
                           for c, _ in layers], iters=2, warmup=1, nbytes=nbytes)
        res["plain_ms"] = ms_of(t)
        rows.append(res)
        print(json.dumps(res), flush=True)
        del layers
        torch.cuda.empty_cache()
    return rows


def case_prefill(this, other, dev, timed, ms_of):
    B, H, Hkv, S, cap, D, calls = 16, 8, 1, 128, 256, 256, 8
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for kind, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        gen = torch.Generator().manual_seed(7 + len(kind))
        lens = torch.randint(0, cap - S + 1, (B,), generator=gen, dtype=torch.int32).to(dev)
        q = torch.randn(B, H, S, D, generator=gen).to(dev)
        layers = [tuple(torch.randn(B, cap, Hkv * D, generator=gen).to(dt).to(dev) for _ in "kv")
                  for _ in range(calls)]
        qpos = lens.long()[:, None] + torch.arange(S, device=dev)[None]
        mask = (torch.arange(cap, device=dev)[None, None, :] <= qpos[:, :, None])[:, None]
        kv_rows = (lens.long() + S).clamp(max=cap).sum().item()
        es = 4 if kind == "f32" else 2
        nbytes = calls * (2 * 4 * B * H * S * D + 4 * B + 2 * kv_rows * Hkv * D * es)
        res = {"case": "prefill", "kv": kind, "D": D, "unit": f"{calls} calls, {B} x {S} rows, "
               f"H {H} over {Hkv}, cap {cap}, cat caches"}
        want = this.prefill_mha_cat_plain(q, *layers[0], lens)
        for name, fa in (("other", other), ("this", this)):
            got = fa.prefill_mha_cat(q, *layers[0], lens)
            torch.cuda.synchronize()
            res[f"{name}_max_abs_err"] = (got - want).abs().max().item()
        for turn, (name, fa) in enumerate((("other", other), ("this", this), ("this", this),
                                           ("other", other))):
            t = timed(lambda: [fa.prefill_mha_cat(q, k, v, lens) for k, v in layers], iters=5,
                      nbytes=nbytes)
            res[f"{name}_ms_{turn}"] = ms_of(t)
        heads = [tuple(this.cat_to_heads(x, Hkv).to(q.dtype) for x in c) for c in layers]
        t = timed(lambda: [sdpa(q, k, v, attn_mask=mask, enable_gqa=True) for k, v in heads],
                  iters=5, nbytes=nbytes)
        res["sdpa_ms"] = ms_of(t)
        t = timed(lambda: [this.prefill_mha_cat_plain(q, k, v, lens) for k, v in layers],
                  iters=2, warmup=1, nbytes=nbytes)
        res["plain_ms"] = ms_of(t)
        rows.append(res)
        print(json.dumps(res), flush=True)
        del layers, heads
        torch.cuda.empty_cache()
    return rows


def case_vpu(this, other, dev, timed, ms_of):
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for B in (32, 128, 8):
        H, cap, D = 12, 256, 64
        rng = np.random.default_rng(0)
        q, k, v = (torch.as_tensor(rng.standard_normal(s), dtype=torch.float32).to(dev)
                   for s in ((B, H, 1, D), (B, H, cap, D), (B, H, cap, D)))
        lens = torch.as_tensor(rng.integers(cap // 2, cap - 2, B), dtype=torch.int32).to(dev)
        scale = 1.0 / float(np.sqrt(D))
        live = (lens.long() + 1).sum().item()
        nbytes = 2 * B * H * D * 4 + 4 * B + 2 * live * H * D * 4
        want = this.vpu_attn_plain(q, k, v, lens, scale)
        res = {"case": "vpu", "B": B, "H": H, "cap": cap, "D": D,
               "splits": this.vpu_plan(B, H, cap)[0]}
        for name, tb in (("other", other), ("this", this)):
            got = tb.vpu_attn(q, k, v, lens, scale)
            torch.cuda.synchronize()
            res[f"{name}_max_abs_err"] = (got - want).abs().max().item()
        for turn, (name, tb) in enumerate((("other", other), ("this", this), ("this", this),
                                           ("other", other))):
            t = timed(lambda: tb.vpu_attn(q, k, v, lens, scale), iters=20, nbytes=nbytes)
            res[f"{name}_ms_{turn}"] = ms_of(t)
        mask = (torch.arange(cap, device=dev)[None, :] <= lens.long()[:, None])[:, None, None]
        res["sdpa_ms"] = ms_of(timed(lambda: sdpa(q, k, v, attn_mask=mask), iters=20,
                                     nbytes=nbytes))
        rows.append(res)
        print(json.dumps(res), flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m rten_tpu_torch.tools.ab_time")
    ap.add_argument("other", help="a directory holding another copy of rten_tpu_torch/")
    ap.add_argument("--cases", default="heads,prefill,vpu")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this tool times kernels on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cases = args.cases.split(",")
    sys.path.insert(0, ROOT)
    from chip_smoke import ms_of, timed  # noqa: E402
    from rten_tpu_torch.kernels import _build  # noqa: E402

    _restrict(_build, {n for c in cases for n in LIBS[c]["this"]})
    ofa, otb = _load_other(args.other, {n for c in cases for n in LIBS[c]["other"]})
    from rten_tpu_torch.kernels import flash_attention as fa  # noqa: E402
    from rten_tpu_torch.tools import bench_decode_attn as tb  # noqa: E402

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    if "heads" in cases:
        case_heads(fa, ofa, dev, timed, ms_of)
    if "prefill" in cases:
        case_prefill(fa, ofa, dev, timed, ms_of)
    if "vpu" in cases:
        case_vpu(tb, otb, dev, timed, ms_of)


if __name__ == "__main__":
    main()
