"""Where a call of the wide per-head kernel (``csrc/decode_heads_wide.cuh``,
decode_mha's per-head form at D 129-512) spends its cycles: per-phase
``clock64()`` totals in a patched copy of the port's CUDA sources.

    python3 -m rten_tpu_torch.tools.wide_trace        # needs the card

Copies ``rten_tpu_torch/csrc`` under ``build/wide_trace/csrc`` (ignored by
git) and patches the kernel: lane 0 of warps 0 and 7 of every block adds
up, over the block's key tiles, the cycles from each mark to the next (the
value product of the tile before, the tile's copies landed and the block
barrier; the next tile's copies issued and, for s8 and int4, the tile
widened; the partial score product; the exchange of partials in the row
group; the softmax), and writes them with the block's
tile count into a ``__device__`` array that an added ``extern "C"`` reader
copies out. The marks read the clock where they are issued: an
``mma.sync`` result is waited for where it is next used. Then it builds
the two wide libraries of that copy under ``build/wide_trace/build``, runs
``decode_mha_heads`` three times at an admission of 16 slots x 128 rows, H
8 over 1 KV head, cap 256 (bf16 and s8 caches at D 256, f32 at D 256 and
512), times one more call with ``chip_smoke.timed`` and prints one JSON
line per case: the call's device milliseconds, the blocks and tiles, and
for each of the two warps the mean cycles a tile of each phase and a
block's total.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
# Each total is the cycles from the mark before it: the first runs from the
# previous tile's softmax (its value product, then this tile's wait and
# barrier), the last from the last tile's softmax to the kernel's end.
PHASES = ("value product, copies landed, barrier", "next copies issued, widen", "scores",
          "exchange", "softmax", "last value product")
MAX_BLOCKS = 4096

HEADER = ("namespace {\n\nconstexpr int WD_THREADS", """__device__ long long rt_trace[%d * 2 * 8];
extern "C" int rt_trace_read(void* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, rt_trace, (size_t)n * 8);
}
namespace {

constexpr int WD_THREADS""" % MAX_BLOCKS)
MARKS = [
    ("  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};\n  float o[OT][4];",
     "  long long rt_acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n  long long rt_prev = clock64();\n"
     "#define RT_MARK(i) { const long long now = clock64(); rt_acc[i] += now - rt_prev; "
     "rt_prev = now; }\n"
     "  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};\n  float o[OT][4];"),
    ("    __syncthreads();     // ... and every thread's; tile t - 1 is consumed\n",
     "    __syncthreads();     // ... and every thread's; tile t - 1 is consumed\n"
     "    RT_MARK(0);\n"),
    ("      __syncthreads();  // the widened tile is whole\n    }\n",
     "      __syncthreads();  // the widened tile is whole\n    }\n    RT_MARK(1);\n"),
    ("    group_sync(1 + rg, SLICES * 32);\n", "    RT_MARK(2);\n    group_sync(1 + rg, SLICES * 32);\n"),
    ("    // Scale (base 2), mask, the online softmax of rows g (e < 2) and g + 8.\n",
     "    RT_MARK(3);\n    // Scale (base 2), mask, the online softmax of rows g (e < 2) and g + 8.\n"),
    ("    if (!dims_live) continue;\n", "    RT_MARK(4);\n    if (!dims_live) continue;\n"),
    ("  cp_async_wait<0>();\n\n  if (!rows_live || !dims_live) return;",
     "  cp_async_wait<0>();\n  RT_MARK(5);\n"
     "  if (lane == 0 && (warp == 0 || warp == 7)) {\n"
     "    const long long blk = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;\n"
     "    if (blk < %d) {\n"
     "      long long* tr = rt_trace + (blk * 2 + (warp == 7)) * 8;\n"
     "      for (int i = 0; i < 6; ++i) tr[i] = rt_acc[i];\n"
     "      tr[6] = ntiles;\n"
     "    }\n"
     "  }\n"
     "  if (!rows_live || !dims_live) return;" % MAX_BLOCKS),
]


def prepare() -> Path:
    """The patched copy of csrc; returns its directory."""
    dst = ROOT / "build" / "wide_trace" / "csrc"
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(ROOT / "rten_tpu_torch" / "csrc", dst)
    path = dst / "decode_heads_wide.cuh"
    src = path.read_text()
    for old, new in (HEADER, *MARKS):
        if src.count(old) != 1:
            raise RuntimeError(f"decode_heads_wide.cuh changed: no single {old.strip()[:40]!r}")
        src = src.replace(old, new)
    path.write_text(src)
    return dst


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this tool traces a kernel on the card")
    sys.path.insert(0, str(ROOT))
    from chip_smoke import _quant_head_major, ms_of, timed  # noqa: E402
    from rten_tpu_torch.kernels import _build  # noqa: E402
    from rten_tpu_torch.kernels import flash_attention as fa  # noqa: E402

    _build.CSRC = prepare()
    _build.BUILD_ROOT = ROOT / "build" / "wide_trace" / "build"
    every = _build._sources
    keep = {"decode_mha_wide_heads", "decode_mha_wide_heads_f32"}
    _build._sources = lambda: [p for p in every() if p.suffix == ".cuh" or p.stem in keep]
    dev = torch.device("cuda")
    B, H, Hkv, S, cap = 16, 8, 1, 128, 256
    for kind, D in (("bf16", 256), ("s8", 256), ("f32", 256), ("f32", 512)):
        gen = torch.Generator().manual_seed(1)
        lens = torch.randint(0, cap - S + 1, (B,), generator=gen, dtype=torch.int32).to(dev)
        q = torch.randn(B, H, S, D, generator=gen).to(dev)
        k, v, ks, vs = _quant_head_major(gen, dev, kind, B, Hkv, D)

        def call():
            return fa.decode_mha_heads(q, k, v, lens, ks, vs)

        for _ in range(3):
            call()
        t = timed(call, iters=10, nbytes=0)
        plan = fa.heads_plan(k.dtype, D)
        blocks = -(-S // plan.rows) * H * B
        lib = fa._mha_lib(fa._decode_lib_name(k.dtype, D, "heads_tc"))
        lib.rt_trace_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.rt_trace_read.restype = ctypes.c_int
        call()
        torch.cuda.synchronize()
        n = min(blocks, MAX_BLOCKS)
        buf = np.zeros(n * 16, np.int64)
        if lib.rt_trace_read(buf.ctypes.data, n * 16):
            raise RuntimeError("rt_trace_read failed")
        tr = buf.reshape(n, 2, 8)
        res = {"kv": kind, "D": D, "ms_a_call": ms_of(t), "blocks": blocks,
               "tiles_a_block": float(tr[:, 0, 6].mean()), "tiles_most": int(tr[:, 0, 6].max())}
        for w, name in ((0, "warp 0"), (1, "warp 7")):
            tiles = max(1, int(tr[:, w, 6].sum()))
            res[name] = {ph: round(float(tr[:, w, i].sum()) / tiles, 1)
                         for i, ph in enumerate(PHASES)}
            res[name]["cycles a block"] = round(float(tr[:, w, :6].sum(1).mean()), 1)
        print(json.dumps(res), flush=True)
    shutil.rmtree(ROOT / "build" / "wide_trace", ignore_errors=True)


if __name__ == "__main__":
    main()
