"""ctypes bindings of the port's native host-side helpers
(`csrc/womd_native.cc`, the port's copy of native/womd_native.cc): the
polyline splitter of the map tokenizer and a TFRecord index.

At first use the source is compiled with g++ under native/Makefile's flags
into `build/libwomd_native.so` at the repository root (beside the CUDA
kernels' library), and rebuilt when the source is newer. The committed
native/libwomd_native.so is never loaded: each machine builds its own. A
failed build or load raises, with the compiler's output; nothing falls back
to the numpy splitter.
"""

import ctypes
import os
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "csrc" / "womd_native.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
LIB_PATH = BUILD_DIR / "libwomd_native.so"
CXX = "g++"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall"]

_lib = None


def build(force: bool = False) -> float:
    """Compile the library if it is missing or older than its source (always
    with `force`). Returns the seconds spent. Each build writes a file of
    its own and renames it into place, so processes that build at once
    (test workers, loader workers) do not read a half-written library."""
    import time

    if not force and LIB_PATH.exists() and \
            LIB_PATH.stat().st_mtime >= SRC.stat().st_mtime:
        return 0.0
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_name(f"{LIB_PATH.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run([CXX, *CXX_FLAGS, "-o", str(tmp), str(SRC)],
                              capture_output=True, text=True, timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError(f"{CXX} not found: the native data helpers build "
                           f"with a C++ compiler") from e
    if proc.returncode != 0:
        raise RuntimeError(f"{CXX} failed on {SRC.name}:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, LIB_PATH)
    return time.perf_counter() - t0


def _load():
    global _lib
    if _lib is not None:
        return _lib
    build()
    try:
        lib = ctypes.CDLL(str(LIB_PATH))
    except OSError as e:
        raise RuntimeError(f"cannot load {LIB_PATH}: {e}") from e
    lib.interpolate_polyline.restype = ctypes.c_int
    lib.interpolate_polyline.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
    ]
    lib.tfrecord_index.restype = ctypes.c_int64
    lib.tfrecord_index.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
    ]
    _lib = lib
    return _lib


def interpolate_polyline_native(points: np.ndarray, headings: np.ndarray,
                                distance: float = 0.5,
                                split_distance: float = 5.0
                                ) -> Optional[np.ndarray]:
    """The native 5 m pt-token segment split of one polyline: [n_seg, 3, 3]
    float32 (x, y, theta), as map_tokenizer.interpolate_polyline returns
    it, or None for no segments. Like the JAX package's binding, at most
    max(n, 8) segments come back for n points."""
    lib = _load()
    pts = np.ascontiguousarray(np.asarray(points)[:, :2], np.float64)
    hds = np.ascontiguousarray(headings, np.float64)
    n = pts.shape[0]
    if hds.shape != (n,):
        raise ValueError(f"headings {hds.shape} for {n} points")
    max_out = max(n, 8)
    out = np.empty((max_out, 3, 3), np.float32)
    n_seg = lib.interpolate_polyline(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        hds.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n, distance, split_distance,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_out)
    if n_seg <= 0:
        return None
    return out[:n_seg].copy()


def tfrecord_index(path: str, max_records: int = 1_000_000
                   ) -> List[Tuple[int, int]]:
    """(offset, length) of each record's data in a TFRecord file (native
    scan, CRCs skipped)."""
    lib = _load()
    buf = np.empty(2 * max_records, np.int64)
    n = lib.tfrecord_index(os.fsencode(path), buf.ctypes.data_as(
        ctypes.POINTER(ctypes.c_int64)), max_records)
    if n < 0:
        raise IOError(f"failed to scan {path}")
    pairs = buf[:2 * n].reshape(-1, 2)
    return [(int(o), int(l)) for o, l in pairs]
