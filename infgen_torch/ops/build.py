"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` compiles with `nvcc` for sm_90a into one shared library
with a plain C interface, `build/libinfgen_kernels.so` at the repository
root, at first use; it is loaded with ctypes. One `nvcc -c` runs per source,
all started together, then one link; `csrc/common.cuh` holds the device
code the sources share, `csrc/mma_tiles.cuh` the tensor-core fragments of
the bf16 paths, `csrc/dense_row.cuh` the per-row DenseAttention code of the
trunk column's fp32 path, `csrc/cluster_stack.cuh` the seed stack over a
thread-block cluster (seed_eval and seed_eval_full). Nothing here runs at import
time.
"""

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
LIB_PATH = BUILD_DIR / "libinfgen_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_lib = None


def nvcc_path() -> str:
    cands = [os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"]
    for home in cands:
        p = Path(home) / "bin" / "nvcc"
        if home and p.exists():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def build(force: bool = False, verbose: bool = False) -> float:
    """Compile the kernels if the library is missing or older than a
    source (always with `force`). Returns the seconds spent."""
    sources = sorted(CSRC.glob("*.cu"))
    inputs = sources + sorted(CSRC.glob("*.cuh"))
    if not force and LIB_PATH.exists() and all(
            LIB_PATH.stat().st_mtime >= s.stat().st_mtime for s in inputs):
        return 0.0
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    extra = ["-Xptxas", "-v"] if verbose else []
    procs = []
    for src in sources:
        obj = BUILD_DIR / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    for src, _, proc in procs:
        out, _ = proc.communicate()
        if verbose and out:
            print(out, flush=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
    tmp = LIB_PATH.with_suffix(".so.tmp")
    link = subprocess.run(
        [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp),
         *(str(o) for _, o, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, LIB_PATH)
    return time.perf_counter() - t0


def _declare(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name, n_ptrs, n_ints in (("infgen_seed_eval", 12, 7),
                                 ("infgen_seed_eval_lanes", 13, 8),
                                 ("infgen_seed_eval_full", 20, 9),
                                 ("infgen_refine", 12, 7),
                                 ("infgen_motion_column", 14, 7),
                                 ("infgen_motion_column_lanes", 14, 8),
                                 ("infgen_fused_block", 6, 7),
                                 ("infgen_r_biased_attention", 9, 6)):
        fn = getattr(lib, name)
        fn.argtypes = [ci] + [vp] * n_ptrs + [ci] * n_ints + [vp]
        fn.restype = ci
    for name, n_ints in (("infgen_fused_block_smem", 5),
                         ("infgen_seed_eval_smem", 7),
                         ("infgen_seed_eval_full_smem", 7),
                         ("infgen_refine_smem", 4)):
        getattr(lib, name).argtypes = [ci] * n_ints
        getattr(lib, name).restype = ci


def library():
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(LIB_PATH))
        _declare(lib)
        _lib = lib
    return _lib
