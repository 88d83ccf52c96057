"""Where a call of the flat decode fold spends its cycles: per-block
``clock64()`` marks in a patched copy of the port's CUDA sources.

Two steps, from the repository root:

    python3 -m rten_tpu_torch.tools.fold_trace prepare <rev>   # needs git
    python3 -m rten_tpu_torch.tools.fold_trace run <rev>       # needs the card

``prepare`` unpacks ``rten_tpu_torch/`` of commit ``<rev>`` (or, for
``worktree``, copies the working tree's) under ``build/fold_trace/<rev>``
(ignored by git) and patches its fold: thread 0 of every block writes the
global timer at its start and end, the cycles to q staged (the first
barrier), to the end of its (warp 0's) key tiles and to its output or split
state written, and its SM id into a ``__device__`` array, which an added
``extern "C"`` reader copies out. Commits before the fold was split over
blocks (those without ``csrc/decode_fold_tc.cuh``) get
``csrc/decode_fold.cuh``'s fold patched (its one-split blocks); later ones
``csrc/decode_fold_tc.cuh``'s tensor-core fold (split blocks record before they arrive, so the last block's merge is
not in the split). ``run`` imports that copy of the package (its libraries
build under ``build/fold_trace/<rev>/build``), times one call of its
``decode_mha_folded`` after three warm-ups at TinyLlama's bf16 decode step
(16 slots, 32 heads over 4, D 64, cap 256, lens 128-191), at GPT-2's int4
deferred step with a bf16 window of 8 (120 slots, 12 heads, t 7) and at
GPT-2's int4 step without one, and prints one JSON line per case: the
blocks, the call's span by the global timer, and the median, least and
most cycles of each phase.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SLOTS = 8192  # blocks the trace array holds

HEADER = ("#include <type_traits>\n", """#include <type_traits>

__device__ unsigned long long rten_trace[%d * 6];
extern "C" int rten_trace_read(void* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, rten_trace, (size_t)n * 8);
}
__device__ __forceinline__ unsigned long long rt_gt() {
  unsigned long long t;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ unsigned rt_smid() {
  unsigned r;
  asm volatile("mov.u32 %%0, %%%%smid;" : "=r"(r));
  return r;
}
""" % SLOTS)
RECORD = """
  if (threadIdx.x == 0 && rt_slot < %d) {
    unsigned long long* tr = rten_trace + rt_slot * 6;
    tr[0] = rt_g0;
    tr[1] = rt_cq - rt_c0;
    tr[2] = rt_ct - rt_c0;
    tr[3] = clock64() - rt_c0;
    tr[4] = rt_smid();
    tr[5] = rt_gt();
  }
""" % SLOTS
START = """
  const unsigned long long rt_g0 = rt_gt();
  const long long rt_c0 = clock64();
  long long rt_cq = 0, rt_ct = 0;
  const int rt_slot = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
"""
# The parent's CUDA-core fold (one split a block).
MARKS = [
    HEADER,
    ("  float (*part_acc)[MAXR][DP] = reinterpret_cast<float (*)[MAXR][DP]>(pool);\n",
     "  float (*part_acc)[MAXR][DP] = reinterpret_cast<float (*)[MAXR][DP]>(pool);\n" + START),
    ("    __syncthreads();  // q in shared memory; the new window or append row written\n",
     """    __syncthreads();  // q in shared memory; the new window or append row written
    if (r0 == 0) rt_cq = clock64();
"""),
    ("    if (KW == 1) {\n      // Each warp holds whole rows",
     "    if (r0 == 0) rt_ct = clock64();\n    if (KW == 1) {\n      // Each warp holds whole rows"),
    ("  if constexpr (SPLIT) {\n    if (splits == 1) return;\n    // Arrive",
     "  if (!SPLIT)" + RECORD.lstrip("\n").replace("  if (threadIdx.x", " if (threadIdx.x", 1)
     + "  if constexpr (SPLIT) {\n    if (splits == 1) return;\n    // Arrive"),
]
# The tensor-core fold (split over blocks).
TC_MARKS = [
    ("  const int g = lane >> 2, tg = lane & 3, lm = lane >> 3, lr = lane & 7;\n",
     "  const int g = lane >> 2, tg = lane & 3, lm = lane >> 3, lr = lane & 7;\n" + START),
    ("  __syncthreads();  // q staged; the window's new row written\n",
     "  __syncthreads();  // q staged; the window's new row written\n  rt_cq = clock64();\n"),
    ("  cp_async_wait<0>();\n\n  // The warps' states",
     "  cp_async_wait<0>();\n  rt_ct = clock64();\n\n  // The warps' states"),
    ("  if (splits == 1) return;\n  // Arrive:", RECORD + "  if (splits == 1) return;\n  // Arrive:"),
]


def tree(rev: str) -> str:
    return os.path.join(ROOT, "build", "fold_trace", rev)


def _patch(path, marks):
    with open(path) as f:
        src = f.read()
    for old, new in marks:
        if src.count(old) != 1:
            raise SystemExit(f"{path}: the patch does not fit (anchor {old.strip()[:60]!r})")
        src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src)


def prepare(rev: str) -> None:
    dst = tree(rev)
    if os.path.exists(dst):
        shutil.rmtree(dst)
    os.makedirs(dst)
    if rev == "worktree":
        shutil.copytree(os.path.join(ROOT, "rten_tpu_torch"), os.path.join(dst, "rten_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
    else:
        archive = subprocess.run(["git", "archive", rev, "rten_tpu_torch"], cwd=ROOT,
                                 check=True, capture_output=True).stdout
        subprocess.run(["tar", "-x", "-C", dst], input=archive, check=True)
    csrc = os.path.join(dst, "rten_tpu_torch", "csrc")
    tc = os.path.join(csrc, "decode_fold_tc.cuh")
    if os.path.exists(tc):
        _patch(os.path.join(csrc, "decode_fold.cuh"), [HEADER])
        _patch(tc, TC_MARKS)
    else:
        _patch(os.path.join(csrc, "decode_fold.cuh"), MARKS)
    print(f"prepared {dst}")


def _stats(x):
    import numpy as np

    return {"median": float(np.median(x)), "min": int(x.min()), "max": int(x.max())}


def _trace(build, name, case, fn, nblocks):
    import numpy as np
    import torch

    lib = build.load_library(name)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    fn()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (nblocks * 6))()
    if lib.rten_trace_read(buf, nblocks * 6):
        raise SystemExit("reading the trace failed")
    a = np.frombuffer(buf, dtype=np.uint64).reshape(nblocks, 6).astype(np.int64)
    per_sm = np.bincount(a[:, 4])
    print(json.dumps({
        "case": case, "library": name, "blocks": nblocks,
        "span_us": float((a[:, 5].max() - a[:, 0].min()) / 1e3),
        "block_start_spread_us": float((a[:, 0].max() - a[:, 0].min()) / 1e3),
        "cycles_to_q_staged": _stats(a[:, 1]), "cycles_tiles": _stats(a[:, 2] - a[:, 1]),
        "cycles_merge_and_write": _stats(a[:, 3] - a[:, 2]), "cycles_total": _stats(a[:, 3]),
        "sms_used": int((per_sm > 0).sum()), "most_blocks_on_an_sm": int(per_sm.max()),
    }), flush=True)


def run(rev: str) -> None:
    import torch

    sys.path.insert(0, tree(rev))
    for mod in [m for m in sys.modules if m == "rten_tpu_torch" or m.startswith("rten_tpu_torch.")]:
        del sys.modules[mod]
    from rten_tpu_torch.kernels import _build
    from rten_tpu_torch.kernels import flash_attention as fa

    if not str(_build.CSRC).startswith(tree(rev)):
        raise SystemExit(f"imported {_build.CSRC}, not the prepared copy")
    every = _build._sources
    _build._sources = lambda: [p for p in every() if p.suffix == ".cuh" or p.stem in (
        "decode_mha_bf16", "decode_mha_u4_win", "decode_mha_u4")]
    # The int4 deferred fold's library: the window's (the parent's) or the
    # one that holds the tensor-core fold (and, in both, the fold without
    # a window).
    u4 = "decode_mha_u4" if (_build.CSRC / "decode_fold_tc.cuh").exists() else "decode_mha_u4_win"
    dev, g, cap = torch.device("cuda"), torch.Generator().manual_seed(0), 256
    B, H, Hkv, D = 16, 32, 4, 64
    q = torch.randn(B, H, 1, D, generator=g).to(dev)
    k, v = (torch.randn(B, Hkv, cap, D, generator=g).to(torch.bfloat16).to(dev) for _ in "kv")
    lens = torch.randint(128, 192, (B,), generator=g, dtype=torch.int32).to(dev)
    _trace(_build, "decode_mha_bf16", "TinyLlama bf16 step",
           lambda: fa.decode_mha_folded(q, k, v, lens), B * Hkv)
    B, H, W = 120, 12, 8
    q = torch.randn(B, H, 1, D, generator=g).to(dev)
    k, v = (torch.randint(0, 256, (B, H, cap, D // 2), generator=g, dtype=torch.uint8).to(dev)
            for _ in "kv")
    ks, vs = ((torch.rand(B, H, cap, generator=g) * 0.3 + 0.05).to(dev) for _ in "kv")
    lens = torch.randint((cap - W) // 2, cap - W, (B,), generator=g, dtype=torch.int32).to(dev)
    rk, rv = (torch.randn(B, H, W, D, generator=g).to(torch.bfloat16).to(dev) for _ in "kv")
    kn, vn = (torch.randn(B, H, 1, D, generator=g).to(dev) for _ in "kv")
    t = torch.tensor([W - 1], dtype=torch.int32, device=dev)
    _trace(_build, u4, "GPT-2 int4 step, bf16 window of 8", lambda: fa.decode_attention_deferred(
        q, k, v, lens, ks, vs, recent_k=rk, recent_v=rv, t=t, k_new=kn, v_new=vn), B * H)
    _trace(_build, "decode_mha_u4", "GPT-2 int4 step",
           lambda: fa.decode_mha_folded(q, k, v, lens, ks, vs), B * H)


if __name__ == "__main__":
    if len(sys.argv) != 3 or sys.argv[1] not in ("prepare", "run"):
        raise SystemExit(__doc__)
    (prepare if sys.argv[1] == "prepare" else run)(sys.argv[2])
