"""Where the time of the refine and seed_eval kernels goes on the card:
phase stamps of an instrumented copy of the sources.

    python scripts/kernel_stamps.py [--calls 30] [--dtype bfloat16]

Copies this checkout's csrc into build/stamps/csrc and inserts the stamps
there (the shipped sources carry none): `stamp(i)` calls at the points of
POINTS in refine.cu and cluster_stack.cuh, each after the first line equal
to its target that follows the one line holding its anchor (thread 0 of
each of the first 8 CTAs records %globaltimer as point i), the stamp
buffer and stamp() itself (STAMP_CODE) at the top of common.cuh's
namespace, and one reader entry (READER) at the end of refine.cu and
seed_eval.cu. An anchor that is not found exactly once stops the script:
after a kernel edit, move the point. Then builds the copy, calls each
kernel through its wrapper on chip_smoke.py's inputs at the flagship
shapes (refine: the latency preset's pass; seed_eval: the flagship's
evaluation, some keys masked) and prints one JSON line per kernel: for CTA
0, the median over the calls of the microseconds from one point to the
next, summed over the sublayers by phase and per sublayer kind, and the
stamped total; the card's name and power limit first. Needs a GPU.
"""

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

STAMP_CODE = """
// phase stamps (inserted by scripts/kernel_stamps.py)
constexpr int kStampBlocks = 8, kStampPoints = 128;
__device__ unsigned long long g_stamps[kStampBlocks][kStampPoints];
__device__ __forceinline__ void stamp(int i) {
  if (threadIdx.x == 0 && blockIdx.x < kStampBlocks && i < kStampPoints) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_stamps[blockIdx.x][i] = t;
  }
}
"""
READER = """
extern "C" int {name}(void* host) {{
  return (int)cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));
}}
"""
# (file, anchor: text of exactly one line, target: the first line after it
# equal to this, "" = the anchor's own line; the stamp's index), in the
# order of the phase names below. refine: 0, 1, then 8 points per sublayer
# j from 2 + 8j, 3 for the heads; the stack: 0, then 8 per sublayer j from
# 1 + 8j, 2 for the heads.
POINTS = (
    ("refine.cu", "cl.sync();  // every CTA of the cluster runs before", "",
     "0"),
    ("refine.cu", "ln_params(V(LNR_S, 0, D), V(LNR_B, 0, D), D), 0);",
     "  cl.sync();", "1"),
    ("refine.cu", "s.q[n0 + acc_col(1)] = a4[1] + bq[n0 + acc_col(1)];",
     "      __syncthreads();", "2 + 8 * j"),
    ("refine.cu", "cl.sync();  // (1)", "", "3 + 8 * j"),
    ("refine.cu", "s.ag[n] = to_t<T>(a + g * (s.s0[n] - a));",
     "      __syncthreads();", "4 + 8 * j"),
    ("refine.cu", "cl.sync();  // (2)", "", "5 + 8 * j"),
    ("refine.cu", "post_ffp_rows<T, 4>(s.x, s.ob, s.dn, ld, D, pp, pf);",
     "      __syncthreads();", "6 + 8 * j"),
    ("refine.cu", "cl.sync();  // (3)", "", "7 + 8 * j"),
    ("refine.cu", "cl.sync();  // (4)", "", "8 + 8 * j"),
    ("refine.cu", "map ? s.sn + (size_t)kRows * ld : nullptr, ld, pq,",
     "      __syncthreads();", "9 + 8 * j"),
    ("refine.cu", "s.hop[i] = to_t<T>(s.x[i]);", "  __syncthreads();",
     "2 + 8 * J"),
    ("refine.cu", "cl.map_shared_rank(s.hb, rr)[hi * D + c0 + n] = h;",
     "  cl.sync();", "3 + 8 * J"),
    ("refine.cu", "p.out_off[c * lay.co + n] = acc + p.v[BH_OFF]", "  }",
     "4 + 8 * J"),
    ("cluster_stack.cuh", "cl.sync();  // every CTA of the cluster runs",
     "", "0"),
    ("cluster_stack.cuh", "const T* wa = acquire();", "", "1 + 8 * j"),
    ("cluster_stack.cuh", "gather(cl, s.ys, wc, s.q, c0);", "", "2 + 8 * j"),
    ("cluster_stack.cuh", "s.mp, s.part, s.agg);", "    }", "3 + 8 * j"),
    ("cluster_stack.cuh", "gather(cl, s.ys, wc, s.gag, c0);", "",
     "4 + 8 * j"),
    ("cluster_stack.cuh", "gather(cl, s.ys, wc, s.o, c0);", "", "5 + 8 * j"),
    ("cluster_stack.cuh", "const T* wf = acquire();", "", "6 + 8 * j"),
    ("cluster_stack.cuh", "gather(cl, s.ys, 4 * wc, s.h, 4 * c0);", "",
     "7 + 8 * j"),
    ("cluster_stack.cuh", "s.sd[i] = s.x[i] + s.t2[i];", "    ++st;",
     "8 + 8 * j"),
    ("cluster_stack.cuh", "const T* wh = acquire();", "", "1 + 8 * J"),
    ("cluster_stack.cuh", "out_pos[c] = acc + w.bpos[c];", "  }",
     "2 + 8 * J"))
READERS = (("refine.cu", "infgen_refine_stamps"),
           ("seed_eval.cu", "infgen_seed_eval_stamps"))


def instrument(src: Path, dst: Path):
    """Copy the sources `src` to `dst` with the stamps inserted."""
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    text = {}
    read = lambda f: text.setdefault(f, (dst / f).read_text().splitlines())
    for f, anchor, target, index in POINTS:
        lines = read(f)
        at = [i for i, line in enumerate(lines) if anchor in line]
        assert len(at) == 1, f"{f}: {len(at)} lines hold {anchor!r}"
        i = at[0]
        if target:
            i = next(k for k in range(i + 1, len(lines))
                     if lines[k] == target)
        indent = lines[i][:len(lines[i]) - len(lines[i].lstrip())]
        lines.insert(i + 1, f"{indent}stamp({index});")
    lines = read("common.cuh")
    i = lines.index("namespace {")
    lines[i + 1:i + 1] = STAMP_CODE.splitlines()
    for f, name in READERS:
        read(f).extend(READER.format(name=name).splitlines())
    for f, lines in text.items():
        (dst / f).write_text("\n".join(lines) + "\n")


# phase names, in time order, of the points of one sublayer and the heads
REFINE_PHASES = ("products_a", "attend_exchange", "row0_gate",
                 "to_out_exchange", "post_ffp_layernorms", "ff0_exchange",
                 "ff1_exchange", "ffq_next_layernorms")
REFINE_HEADS = ("heads_stage_wait", "heads_dense0_exchange", "heads_out")
STACK_PHASES = ("layernorm_stage_wait", "q_exchange", "attend",
                "gate_exchange", "to_out_exchange", "post_ffp_stage_wait",
                "ff0_exchange", "ff1_exchange_ffq")
STACK_HEADS = ("heads_stage_wait", "heads")


def stamps(reader, fn, calls):
    """[calls, 8, 128] stamps (ns) of `fn`'s kernel, one call each."""
    out = []
    for _ in range(calls):
        fn()
        torch.cuda.synchronize()
        buf = np.zeros((8, 128), np.uint64)
        err = reader(buf.ctypes.data)
        assert err == 0, f"stamp reader: cudaError {err}"
        out.append(buf.astype(np.int64))
    return np.stack(out)


def phases(st, first, names, heads, J, skip=()):
    """Median us per phase of CTA 0, summed over the J sublayers (sublayer
    j's points first + len(names) j + k, after point 0 and, from 1 to
    first - 1, a prologue), with the prologue's, the heads' and the
    total; `skip`: (j, k) points a sublayer does not stamp (its time goes
    to the next phase)."""
    p = st[:, 0].astype(np.float64) / 1e3
    per = len(names)
    med = lambda a: float(np.median(a))
    sums, kinds = {n: np.zeros(len(p)) for n in names}, []
    for j in range(J):
        prev = p[:, first + per * j - 1]
        kind = {}
        for k, n in enumerate(names):
            if (j, k) in skip:
                continue
            cur = p[:, first + per * j + k]
            sums[n] += cur - prev
            kind[n] = med(cur - prev)
            prev = cur
        kinds.append(kind)
    res = {"prologue": med(p[:, first - 1] - p[:, 0])} if first > 1 else {}
    res.update({n: med(v) for n, v in sums.items()})
    prev = p[:, first + per * J - 1]
    for k, n in enumerate(heads):
        cur = p[:, first + per * J + k]
        res[n] = med(cur - prev)
        prev = cur
    return dict(phases_us=res, total_us=med(prev - p[:, 0]),
                per_sublayer_us=kinds)


def main(argv=None):
    p = argparse.ArgumentParser("kernel_stamps")
    p.add_argument("--calls", type=int, default=30)
    p.add_argument("--dtype", default="bfloat16",
                   choices=("bfloat16", "float32"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_stamps needs a GPU", file=sys.stderr)
        return 1
    import chip_smoke as S
    from ab_kernels import build_tree
    from infgen_torch.cli import build_tokenizers
    from infgen_torch.config import load_config
    from infgen_torch.ops import build as B
    from infgen_torch.ops import refine_kernel as RK
    from infgen_torch.ops import seed_kernel as SK

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps(dict(item="device", nvidia_smi=smi)), flush=True)
    csrc = B.BUILD_DIR / "stamps" / "csrc"
    instrument(B.CSRC, csrc)
    lib_path = csrc.parent / "libinfgen_kernels.so"
    secs = build_tree(csrc, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    B._declare(lib)
    for name in ("infgen_refine_stamps", "infgen_seed_eval_stamps"):
        getattr(lib, name).argtypes = [ctypes.c_void_p]
        getattr(lib, name).restype = ctypes.c_int
    print(json.dumps(dict(item="build", seconds=secs)), flush=True)
    dtype = getattr(torch, args.dtype)
    pdt = None if dtype == torch.float32 else dtype
    cfg, lat = load_config(S.FLAGSHIP), load_config(S.LATENCY)
    attr = build_tokenizers(cfg)[0]
    with mock.patch.object(B, "_lib", lib), torch.no_grad():
        L = lat.num_seed_layers
        dec = S.decoder_for(lat, attr, dtype, dev)
        pack = RK.pack_refine_params(dec, L, attr.angle_size, pdt)
        rargs = S.refine_inputs(dec, lat, pdt, np.random.default_rng(31),
                                "masked", dev)
        st = stamps(lib.infgen_refine_stamps, lambda: RK.refine_kernel(
            pack, *rargs, lat.num_heads, lat.head_dim), args.calls)
        clocks = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
        print(json.dumps(dict(
            item="refine", dtype=args.dtype, clocks_sm_and_max=clocks,
            **phases(st, 2, REFINE_PHASES, REFINE_HEADS, 2 * L))),
            flush=True)
        L, G = cfg.num_seed_layers, attr.grid_size
        dec = S.decoder_for(cfg, attr, dtype, dev)
        pack = SK.pack_seed_params(dec, L, G, pdt)
        sargs = S.seed_eval_inputs(dec, cfg, G, pdt,
                                   np.random.default_rng(23), "masked", dev)
        st = stamps(lib.infgen_seed_eval_stamps, lambda: SK.seed_eval_kernel(
            pack, *sargs, cfg.num_heads, cfg.head_dim), args.calls)
        occ = {(j, 1) for j in range(0, 3 * L, 3)}   # occ2sa: no query
        print(json.dumps(dict(item="seed_eval", dtype=args.dtype, **phases(
            st, 1, STACK_PHASES, STACK_HEADS, 3 * L, occ))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
