"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file compiles with ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds). All sources compile in parallel, one ``nvcc`` each, at
first use (or from ``start_build``, which returns at once: each
``load_library`` then waits for its own library only, so a program can
run what is built while the rest compiles). Libraries go into ``build/rten_tpu_torch/<hash>/`` beside the
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
import time
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
# The nvcc runs in flight: name -> (process, temporary file, library, log).
_procs: Dict[str, tuple] = {}
_started = [0.0]  # perf_counter() when the runs in flight were started
# Seconds from the start of this process's last build to each library's
# nvcc finishing (the libraries it found built are not listed).
BUILD_SECONDS: Dict[str, float] = {}


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


def _targets() -> Dict[str, tuple]:
    out_dir = build_dir()
    return {p.stem: (p, out_dir / f"lib{p.stem}.so") for p in _sources() if p.suffix == ".cu"}


def _start() -> None:
    """Start nvcc for every library not built and not in flight (caller
    holds ``_lock``)."""
    todo = {n: t for n, t in _targets().items() if not t[1].exists() and n not in _procs}
    if not todo:
        return
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    if not _procs:
        BUILD_SECONDS.clear()
        _started[0] = time.perf_counter()
    for name, (src, lib) in todo.items():
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        log = open(out_dir / f"{name}.log", "w")
        _procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)],
            stdout=log, stderr=subprocess.STDOUT,
        ), tmp, lib, log)


def _wait(names) -> None:
    """Wait until no library of ``names`` is in flight, recording every run
    that finishes meanwhile (caller holds ``_lock``); raises with the
    compiler's output if one of ``names`` failed."""
    failed = []
    while any(n in _procs for n in names):
        for name in [n for n, p in _procs.items() if p[0].poll() is not None]:
            proc, tmp, lib, log = _procs.pop(name)
            BUILD_SECONDS[name] = time.perf_counter() - _started[0]
            log.close()
            if proc.returncode == 0:
                os.replace(tmp, lib)
            elif name in names:
                failed.append(name)
        time.sleep(0.05)
    if failed:
        out_dir = build_dir()
        msgs = "\n".join(f"--- {n} ---\n{(out_dir / f'{n}.log').read_text()}" for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{msgs}")


def start_build() -> None:
    """Start compiling every ``csrc/*.cu`` not yet built, one nvcc each, all
    in parallel, and return without waiting."""
    with _lock:
        _start()


def build_all() -> Dict[str, Path]:
    """Compile every ``csrc/*.cu`` not yet built (or wait for the runs
    ``start_build`` began); returns {name: library path}. Raises with the
    compiler's output if any build fails."""
    with _lock:
        _start()
        targets = _targets()
        _wait(list(targets))
        missing = [n for n, t in targets.items() if not t[1].exists()]
    if missing:
        raise RuntimeError(f"nvcc failed for {missing}: see their logs in {build_dir()}")
    return {n: t[1] for n, t in targets.items()}


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (starting the build
    of every missing library if none is in flight, and waiting for this
    one)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _start()
            _wait([name])
            path = _targets()[name][1]
            if not path.exists():
                raise RuntimeError(f"nvcc failed for {name}: see {build_dir() / name}.log")
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib


def ptxas_report(name: str) -> str:
    """The compiler's register/shared-memory report for ``name``."""
    log = build_dir() / f"{name}.log"
    return log.read_text() if log.exists() else ""
