"""The port's native host core: the tokenizer's BPE and WordPiece encode
loops (``bpe.cpp``) and imageproc's contour tracing and NMS
(``imageproc.cpp``), bound with ``ctypes``.

These are host C++ (no kernel of the card): the per-piece encode loop runs
per request in serving, and contour tracing crawls in Python on real image
sizes. The library builds with ``g++ -O3 -std=c++17 -shared -fPIC`` at
first use into ``build/rten_tpu_torch/native-<hash>/`` beside the package
(ignored by git), keyed by a hash of the sources and flags; it is written
under a temporary name and renamed into place, so a process building it
beside another never loads a half-written file. Nothing is built at import time.

A failed build or load raises :class:`NativeLibraryError` with the compiler's
log: the callers that asked for the native core never fall back to Python
on their own. The Python cores run only where a caller asks for them
(``Tokenizer(..., native=False)``, ``find_contours(..., native=False)``).

The tokenizer hands over all the pieces of a text in one call. Output
buffers are sized to the input (a BPE piece gives at most one id per UTF-8
byte, a WordPiece piece at most one per character or the one unknown id),
and the contour buffers grow and retry when they fill, so every input
encodes or traces as the Python core does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List

import numpy as np

SOURCES = [Path(__file__).resolve().parent / n for n in ("bpe.cpp", "imageproc.cpp")]
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "rten_tpu_torch"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None


class NativeLibraryError(RuntimeError):
    """The native library did not build or load; the message holds the
    compiler's command and log."""


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for p in SOURCES:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / f"native-{h.hexdigest()[:16]}" / "librten_native.so"


def _build(path: Path) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise NativeLibraryError("g++ not found: the native core cannot be built")
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise NativeLibraryError(f"{' '.join(cmd)}\nfailed: {e}") from e
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeLibraryError(f"{' '.join(cmd)}\nexited {r.returncode}:\n{r.stdout}{r.stderr}")
    os.replace(tmp, path)


def get_lib() -> ctypes.CDLL:
    """The loaded native library, built first if needed. Raises
    ``NativeLibraryError`` (with the compiler's log) if it cannot be built or
    loaded; never returns None."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise NativeLibraryError(f"cannot load {path}: {e}") from e
            _configure(lib)
            _lib = lib
    return _lib


def _configure(lib):
    c_char_pp = ctypes.POINTER(ctypes.c_char_p)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.rten_bpe_create.restype = ctypes.c_void_p
    lib.rten_bpe_create.argtypes = [
        c_char_pp, i32p, ctypes.c_int32, c_char_pp, c_char_pp, ctypes.c_int32,
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int32,
    ]
    lib.rten_bpe_destroy.argtypes = [ctypes.c_void_p]
    lib.rten_bpe_encode.restype = ctypes.c_int32
    lib.rten_bpe_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32, i32p, ctypes.c_int32,
    ]
    for name in ("rten_bpe_encode_batch", "rten_wordpiece_encode_batch"):
        getattr(lib, name).restype = ctypes.c_int32
        getattr(lib, name).argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, i32p, ctypes.c_int32, i32p, ctypes.c_int32,
        ]
    lib.rten_wordpiece_create.restype = ctypes.c_void_p
    lib.rten_wordpiece_create.argtypes = [
        c_char_pp, i32p, ctypes.c_int32, ctypes.c_char_p, ctypes.c_int32,
        ctypes.c_int32,
    ]
    lib.rten_wordpiece_destroy.argtypes = [ctypes.c_void_p]
    lib.rten_wordpiece_encode.restype = ctypes.c_int32
    lib.rten_wordpiece_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32, i32p, ctypes.c_int32,
    ]
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.rten_find_contours.restype = ctypes.c_int32
    lib.rten_find_contours.argtypes = [
        u8p, ctypes.c_int32, ctypes.c_int32, i32p, ctypes.c_int32,
        i32p, ctypes.c_int32,
    ]
    lib.rten_nms.restype = ctypes.c_int32
    lib.rten_nms.argtypes = [
        f32p, f32p, ctypes.c_int32, ctypes.c_float, ctypes.c_float,
        ctypes.c_int32, i32p,
    ]


def _string_table(strings: List[str]):
    """A C array of the strings' UTF-8 bytes (the array keeps them alive)."""
    encoded = [s.encode("utf-8") for s in strings]
    return (ctypes.c_char_p * len(encoded))(*encoded)


class _Encoder:
    """An encode handle. Its output buffer grows to each call's bound:
    ``extra`` ids a piece past the pieces' UTF-8 length."""

    extra = 0

    def encode_piece(self, piece: str) -> List[int]:
        return self.encode_pieces([piece])

    def encode_pieces(self, pieces: List[str]) -> List[int]:
        """The ids of ``pieces``, one piece after another, in one call."""
        data = [p.encode("utf-8") for p in pieces]
        lens = np.fromiter(map(len, data), np.int32, len(data))
        blob = b"".join(data)
        need = len(blob) + self.extra * len(data)
        if need > len(self._buf):
            self._buf = np.empty(max(need, 2 * len(self._buf)), np.int32)
        n = self._batch(self._h, blob, _ptr(lens, ctypes.c_int32), len(data),
                        _ptr(self._buf, ctypes.c_int32), len(self._buf))
        if n < 0:  # the bound above makes this unreachable
            raise RuntimeError(f"native encode overflowed {len(self._buf)} ids")
        return self._buf[:n].tolist()


class NativeBpe(_Encoder):
    """The C++ BPE encoder over a vocabulary and merge list."""

    def __init__(self, vocab: dict, merges, csp: str = "", eows: str = "",
                 unk_id: int = -1):
        lib = get_lib()
        self._lib, self._batch = lib, lib.rten_bpe_encode_batch
        tokens = list(vocab.keys())
        ids = (ctypes.c_int32 * len(tokens))(*[vocab[t] for t in tokens])
        self._h = lib.rten_bpe_create(
            _string_table(tokens), ids, len(tokens), _string_table([m[0] for m in merges]),
            _string_table([m[1] for m in merges]), len(merges),
            csp.encode(), eows.encode(), unk_id,
        )
        self._buf = np.empty(4096, np.int32)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.rten_bpe_destroy(self._h)


class NativeWordPiece(_Encoder):
    """The C++ WordPiece encoder (greedy longest match)."""

    extra = 1

    def __init__(self, vocab: dict, prefix: str, unk_id: int, max_chars: int):
        lib = get_lib()
        self._lib, self._batch = lib, lib.rten_wordpiece_encode_batch
        tokens = list(vocab.keys())
        ids = (ctypes.c_int32 * len(tokens))(*[vocab[t] for t in tokens])
        self._h = lib.rten_wordpiece_create(
            _string_table(tokens), ids, len(tokens), prefix.encode(), unk_id, max_chars
        )
        self._buf = np.empty(4096, np.int32)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.rten_wordpiece_destroy(self._h)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def find_contours(grid: np.ndarray) -> List[np.ndarray]:
    """The C++ tracer over a 2-D u8 mask (nonzero = foreground): one [N, 2]
    int32 (y, x) array per contour. The point and contour buffers start at
    the mask's size and double when they fill; a trace that needs more
    than eight points a pixel does not close, and raises."""
    lib = get_lib()
    grid = np.ascontiguousarray(grid != 0, np.uint8)
    H, W = grid.shape
    max_pts, max_contours = H * W + 16, H * W // 2 + 16
    while True:
        pts = np.empty(max_pts * 2, np.int32)
        sizes = np.empty(max_contours, np.int32)
        n = lib.rten_find_contours(_ptr(grid, ctypes.c_uint8), H, W,
                                   _ptr(pts, ctypes.c_int32), max_pts,
                                   _ptr(sizes, ctypes.c_int32), max_contours)
        if n >= 0:
            break
        if max_pts > 8 * H * W + 16:
            raise RuntimeError(f"contour tracing of a {H}x{W} mask did not close")
        max_pts, max_contours = 2 * max_pts, 2 * max_contours
    out = []
    cur = 0
    for c in sizes[:n].tolist():
        out.append(pts[cur:cur + 2 * c].reshape(c, 2).copy())
        cur += 2 * c
    return out


def nms(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float,
        score_threshold: float, max_detections: int) -> List[int]:
    """The C++ greedy NMS over [N, 4] (top, left, bottom, right) boxes:
    the kept indices, by descending score."""
    lib = get_lib()
    b = np.ascontiguousarray(boxes, np.float32)
    s = np.ascontiguousarray(scores, np.float32)
    out = np.empty(len(s), np.int32)
    n = lib.rten_nms(_ptr(b, ctypes.c_float), _ptr(s, ctypes.c_float), len(s),
                     float(iou_threshold), float(score_threshold), int(max_detections),
                     _ptr(out, ctypes.c_int32))
    return out[:n].tolist()

