"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file compiles with ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds). All sources compile in parallel, one ``nvcc`` each, at
first use. Libraries go into ``build/rten_tpu_torch/<hash>/`` beside the
package (ignored by git), keyed by a hash of the sources and flags, so a
changed source rebuilds and an unchanged one is reused. A library is
written under a temporary name and renamed into place, so concurrent
builders never load a half-written file.

Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "rten_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Dict[str, Path]:
    """Compile every ``csrc/*.cu`` not yet built, one nvcc each, all in
    parallel; returns {name: library path}. Raises with the compiler's
    output if any build fails."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    targets = {p.stem: (p, out_dir / f"lib{p.stem}.so")
               for p in _sources() if p.suffix == ".cu"}
    todo = {n: t for n, t in targets.items() if not t[1].exists()}
    if todo:
        nvcc = _nvcc()
        procs = {}
        for name, (src, lib) in todo.items():
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            log = open(out_dir / f"{name}.log", "w")
            procs[name] = (subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)],
                stdout=log, stderr=subprocess.STDOUT,
            ), tmp, lib, log)
        failed = []
        for name, (proc, tmp, lib, log) in procs.items():
            rc = proc.wait()
            log.close()
            if rc == 0:
                os.replace(tmp, lib)
            else:
                failed.append(name)
        if failed:
            msgs = "\n".join(
                f"--- {n} ---\n{(out_dir / f'{n}.log').read_text()}" for n in failed
            )
            raise RuntimeError(f"nvcc failed for {failed}:\n{msgs}")
    return {n: t[1] for n, t in targets.items()}


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (building all
    sources first if needed)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            libs = build_all()
            lib = ctypes.CDLL(str(libs[name]))
            _libs[name] = lib
        return lib


def ptxas_report(name: str) -> str:
    """The compiler's register/shared-memory report for ``name``."""
    log = build_dir() / f"{name}.log"
    return log.read_text() if log.exists() else ""
