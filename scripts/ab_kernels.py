"""A/B of the port's CUDA kernels between another commit's sources and
this checkout's, on one card, in one process. The A/B numbers of PERF.md's
kernel redesigns come from this script.

    git archive 1617e9f infgen_torch/ops/csrc | tar -x -C snapshot/parent
    python scripts/ab_kernels.py --parent 1617e9f \
        --parent-csrc snapshot/parent/infgen_torch/ops/csrc \
        --kernels refine,seed_eval

--parent names the other tree's C interface (PARENT_ARGS): 3bd251f, the
commit before seed_eval_full and fused_attention_block were redesigned
(seed_eval_full with 7 ints, fused_block with a key-projection scratch
pointer), 2018a19, the one before motion_column and r_biased_attention
were (motion_column without the tile pointer), or 1617e9f, the one before
refine and seed_eval were (refine with one pointer array for matrices and
vectors, no tiles and no trace); another tree is refused by the loader or
misread. The other tree is built into build/parent/. Then,
on chip_smoke.py's inputs at the flagship shapes, for each kernel of
--kernels (the ones the change redesigned):
  - median ms per call of each build (CUDA events around each call, as
    chip_smoke.py times, both builds called through equally lean host
    code: parent_* / change_* below, no argument checks), in turns parent,
    change, change, parent; the device ms per call of each build's kernels
    under torch.profiler; the host microseconds to enqueue one call; the
    largest difference between the two builds' outputs (where the change
    keeps a path, as motion_column's fp32 one, whether it is bit for bit);
      seed_eval_full   the latency preset's call, bf16 and fp32, with the
                       change's two stages apart (parent 3bd251f);
      fused_attention_block  the rollout's three calls, bf16 tensors and
                       fp32 (parent 3bd251f);
      motion_column    the latency preset's column, bf16 (the main path's
                       type) and fp32, every row live;
      r_biased_attention  the rollout's agent-agent call, fp32;
      refine           the latency preset's pass, bf16 and fp32 (parent
                       1617e9f);
      seed_eval        the flagship's evaluation, bf16 and fp32 (parent
                       1617e9f);
  - for every other kernel, whether the two builds' outputs are equal bit
    for bit on the smoke's cases.
A call whose host time exceeds its device time reads its host time in the
event timing; the profiler's device ms does not. One JSON line per item,
the card's name and power limit first. Needs a GPU.
"""

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def build_tree(csrc: Path, lib_path: Path) -> float:
    """Compile every .cu of `csrc` into `lib_path` with the port's nvcc
    flags, one nvcc per source, all started together. Returns seconds."""
    from infgen_torch.ops import build as B

    t0 = time.perf_counter()
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    nvcc = B.nvcc_path()
    procs = []
    for src in sorted(csrc.glob("*.cu")):
        obj = lib_path.parent / (src.stem + ".o")
        procs.append((src, obj, subprocess.Popen(
            [nvcc, *B.NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for src, _, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
    link = subprocess.run(
        [nvcc, "-shared", *B.NVCC_FLAGS[:2], "-o", str(lib_path),
         *(str(o) for _, o, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    return time.perf_counter() - t0


# (pointers, ints) of each entry point of another tree's C interface
PARENT_ARGS = {
    "3bd251f": {"infgen_seed_eval": (12, 7), "infgen_seed_eval_full": (19, 7),
                "infgen_refine": (9, 6), "infgen_motion_column": (13, 7),
                "infgen_fused_block": (7, 6),
                "infgen_r_biased_attention": (9, 6)},
    "2018a19": {"infgen_seed_eval": (12, 7), "infgen_seed_eval_full": (19, 8),
                "infgen_refine": (9, 6), "infgen_motion_column": (13, 7),
                "infgen_fused_block": (6, 6),
                "infgen_r_biased_attention": (9, 6)},
    "1617e9f": {"infgen_seed_eval": (12, 7), "infgen_seed_eval_full": (19, 8),
                "infgen_refine": (9, 6), "infgen_motion_column": (14, 7),
                "infgen_fused_block": (6, 6),
                "infgen_r_biased_attention": (9, 6)}}
KERNELS = ("seed_eval", "seed_eval_full", "refine", "motion_column",
           "fused_attention_block", "r_biased_attention")
# the kernels whose redesign each parent precedes: only these are timed
# against it
TIMED = {"3bd251f": ("seed_eval_full", "fused_attention_block"),
         "2018a19": ("motion_column", "r_biased_attention"),
         "1617e9f": ("refine", "seed_eval")}
# the parents whose motion_column takes the tile pointer
COLUMN_TILES = ("1617e9f",)


def _declare_parent(lib, parent):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name, (n_ptrs, n_ints) in PARENT_ARGS[parent].items():
        fn = getattr(lib, name)
        fn.argtypes = [ci] + [vp] * n_ptrs + [ci] * n_ints + [vp]
        fn.restype = ci


def _stream():
    return torch.cuda.current_stream().cuda_stream


def parent_seed_full(lib, pack, args, H, Hd):
    """The parent build's seed_eval_full on the wrapper's inputs."""
    from infgen_torch.ops.seed_kernel import _DTYPE_CODE, SMALL_COLS

    sd0, k0, v0, r_pl, mask_pl, col, r_sa, mask_a, occ = args
    base = pack.base
    L, D, G = base.L, base.D, base.G
    P, A = k0.shape[1], col.shape[0]
    f32 = dict(dtype=torch.float32, device=sd0.device)
    pre = (torch.empty((L, D), **f32), torch.empty((L, P, D), **f32),
           torch.empty((L, P, D), **f32), torch.empty((L, A, D), **f32),
           torch.empty((L, A, D), **f32))
    small = torch.empty((3, SMALL_COLS), **f32)
    pos = torch.empty((G,), **f32)
    err = lib.infgen_seed_eval_full(
        _DTYPE_CODE[pack.dtype], *(t.data_ptr() for t in args),
        base.weights.data_ptr(), base.vectors.data_ptr(),
        ctypes.addressof(pack.ptrs), *(t.data_ptr() for t in pre),
        small.data_ptr(), pos.data_ptr(), L, P, A, D, H, Hd, G, _stream())
    assert err == 0, f"parent seed_eval_full: cudaError {err}"
    return small, pos


def parent_fused(lib, pack, x, src, r, mask, H):
    """The parent build's fused block (its key-projection scratch
    included) on the wrapper's inputs."""
    from infgen_torch.ops.seed_kernel import _DTYPE_CODE

    Q, D = x.shape
    K = r.shape[1]
    per_query = int(src is not None and src.dim() == 3)
    out = torch.empty((Q, D), dtype=x.dtype, device=x.device)
    scratch = torch.empty((2, K, D) if not per_query else (1,),
                          dtype=torch.float32, device=x.device)
    err = lib.infgen_fused_block(
        _DTYPE_CODE[x.dtype], x.data_ptr(),
        0 if src is None else src.data_ptr(), r.data_ptr(), mask.data_ptr(),
        ctypes.addressof(pack.ptrs), out.data_ptr(), scratch.data_ptr(), Q,
        K, D, H, D // H, per_query, _stream())
    assert err == 0, f"parent fused_block: cudaError {err}"
    return out


def change_fused(lib, pack, x, src, r, mask, H):
    """This build's fused block on the same inputs, called as lean as
    parent_fused (no argument checks), so that both sides' host time per
    call is alike."""
    from infgen_torch.ops.seed_kernel import _DTYPE_CODE

    Q, D = x.shape
    K = r.shape[1]
    out = torch.empty((Q, D), dtype=x.dtype, device=x.device)
    err = lib.infgen_fused_block(
        _DTYPE_CODE[x.dtype], x.data_ptr(),
        0 if src is None else src.data_ptr(), r.data_ptr(), mask.data_ptr(),
        ctypes.addressof(pack.ptrs), out.data_ptr(), Q, K, D, H, D // H,
        int(src is not None and src.dim() == 3), _stream())
    assert err == 0, f"fused_block: cudaError {err}"
    return out


def column_call(lib, pack, args, H, Hd, with_tiles):
    """One motion_column call through `lib`, as lean as the others: the
    parent's interface without the tile pointer, the change's with it."""
    from infgen_torch.ops.column_kernel import scratch_floats
    from infgen_torch.ops.seed_kernel import _DTYPE_CODE

    x0, key_stack = args[0], args[1]
    L, D = pack.L, pack.D
    A, W, K = x0.shape[0], key_stack.shape[2], args[4].shape[1]
    f32 = dict(dtype=torch.float32, device=x0.device)
    out = torch.empty((L, A, D), **f32)
    n = scratch_floats(pack.dtype, L, A, W, K, D) if with_tiles \
        else 5 * A * D
    scratch = torch.empty((n,), **f32)
    tiles = () if not with_tiles else (
        0 if pack.tiles is None else pack.tiles.data_ptr(),)
    err = lib.infgen_motion_column(
        _DTYPE_CODE[pack.dtype], *(t.data_ptr() for t in args), 0,
        ctypes.addressof(pack.ptrs), *tiles, out.data_ptr(),
        scratch.data_ptr(), L, A, W, K, D, H, Hd, _stream())
    assert err == 0, f"motion_column: cudaError {err}"
    return out


def rba_call(lib, args, H):
    """One r_biased_attention call through `lib` (the interface is the same
    in both trees)."""
    q, k, v, r, w_kr, w_vr, mask, drop = args
    B, Q, HD = q.shape
    out = torch.empty((B, Q, HD), dtype=torch.float32, device=q.device)
    err = lib.infgen_r_biased_attention(
        0, q.data_ptr(), k.data_ptr(), v.data_ptr(), r.data_ptr(),
        w_kr.data_ptr(), w_vr.data_ptr(), mask.data_ptr(),
        0 if drop is None else drop.data_ptr(), out.data_ptr(), B, Q,
        k.shape[1], HD, r.shape[-1], H, _stream())
    assert err == 0, f"r_biased_attention: cudaError {err}"
    return out


def parent_refine(lib, pack, args, H, Hd):
    """The parent build's refine (one pointer array for the pack's
    matrices and vectors) on the wrapper's inputs."""
    from infgen_torch.ops.seed_kernel import _DTYPE_CODE, ptr_array

    x = args[0]
    R, D = x.shape
    if not hasattr(pack, "parent_ptrs"):
        pack.parent_ptrs = ptr_array(pack.views())
    f32 = dict(dtype=torch.float32, device=x.device)
    head = torch.empty((pack.angle_size,), **f32)
    off = torch.empty((2,), **f32)
    err = lib.infgen_refine(
        _DTYPE_CODE[pack.dtype], *(t.data_ptr() for t in args),
        ctypes.addressof(pack.parent_ptrs), head.data_ptr(), off.data_ptr(),
        pack.L, R, D, H, Hd, pack.angle_size, _stream())
    assert err == 0, f"parent refine: cudaError {err}"
    return head, off


def change_refine(lib, pack, args, H, Hd):
    """This build's refine on the same inputs, as lean as parent_refine."""
    from infgen_torch.ops.seed_kernel import _DTYPE_CODE

    x = args[0]
    R, D = x.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    head = torch.empty((pack.angle_size,), **f32)
    off = torch.empty((2,), **f32)
    err = lib.infgen_refine(
        _DTYPE_CODE[pack.dtype], *(t.data_ptr() for t in args),
        ctypes.addressof(pack.ptrs), pack.tiles.data_ptr(), head.data_ptr(),
        off.data_ptr(), 0, pack.L, R, D, H, Hd, pack.angle_size, _stream())
    assert err == 0, f"refine: cudaError {err}"
    return head, off


def seed_eval_call(lib, pack, args, H, Hd):
    """One seed_eval call through `lib`, no argument checks (the interface
    is the same in both trees)."""
    from infgen_torch.ops.seed_kernel import _DTYPE_CODE, SMALL_COLS

    sd0, K_pt, K_a = args[0], args[2], args[5]
    f32 = dict(dtype=torch.float32, device=sd0.device)
    small = torch.empty((3, SMALL_COLS), **f32)
    pos = torch.empty((pack.G,), **f32)
    err = lib.infgen_seed_eval(
        _DTYPE_CODE[pack.dtype], *(t.data_ptr() for t in args),
        pack.weights.data_ptr(), pack.vectors.data_ptr(), small.data_ptr(),
        pos.data_ptr(), pack.L, K_pt.shape[1], K_a.shape[1], pack.D, H, Hd,
        pack.G, _stream())
    assert err == 0, f"seed_eval: cudaError {err}"
    return small, pos


def stage_ms(fn, n=50):
    """Device ms per call of fn's kernels by kind (precompute, stack,
    other) under torch.profiler."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        kind = ("precompute" if "precompute" in e.name else
                "stack" if "stack_kernel" in e.name else "other")
        out[kind] = out.get(kind, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3 / n
    return out


def host_us(fn, n=200):
    """Host microseconds per call of fn (enqueue only, no synchronise)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def in_turns(fns, n):
    """Median ms of each of fns['parent'], fns['change'], timed in turns
    parent, change, change, parent; the mean of each one's two runs."""
    import chip_smoke as S

    runs = {"parent": [], "change": []}
    for who in ("parent", "change", "change", "parent"):
        runs[who].append(S.median_ms(fns[who], n))
    return {k: dict(ms=sum(v) / len(v), runs=v) for k, v in runs.items()}


def ab_seed_full(lib, lat, attr, dev, emit):
    import chip_smoke as S
    from infgen_torch.ops import seed_kernel as SK

    G, H, Hd, L = (attr.grid_size, lat.num_heads, lat.head_dim,
                   lat.num_seed_layers)
    for dtype in (S.BF16, S.F32):
        dec = S.decoder_for(lat, attr, dtype, dev)
        pdt = None if dtype == S.F32 else dtype
        pack = SK.pack_seed_params_full(dec, L, G, pdt)
        args = S.seed_full_inputs(dec, lat, G, pdt, np.random.default_rng(29),
                                  "masked", dev)
        with torch.no_grad():
            fns = {"parent": lambda: parent_seed_full(lib, pack, args, H, Hd),
                   "change": lambda: SK.seed_eval_full_launch(
                       pack, *args, H, Hd)[:2]}
            diff = S._err(fns["change"](), fns["parent"](), "seed_full A/B")
            t = in_turns(fns, S.KERNEL_LAUNCHES)
            for who, fn in fns.items():
                t[who]["stages"] = stage_ms(fn)
                t[who]["host_us"] = host_us(fn)
        emit("seed_eval_full", dtype=str(dtype)[6:], builds=t,
             ratio=t["change"]["ms"] / t["parent"]["ms"],
             max_abs_diff=diff[0], mean_abs_diff=diff[1])


def ab_fused(lib, lib_c, cfg, attr, dev, emit):
    import chip_smoke as S
    from infgen_torch.ops import fused_block as FB

    H = cfg.num_heads
    dec = S.decoder_for(cfg, attr, S.F32, dev)
    for dtype in (S.BF16, S.F32):
        per_call = {}
        for kind, name, mode in S.FUSED_CASES[:3]:
            pack = FB.pack_fused_block(getattr(dec, name))
            x, src, r, mask = S.fused_inputs(dec, cfg, kind, mode, "random",
                                             np.random.default_rng(43), dev)
            mask = torch.as_tensor(np.random.default_rng(47).uniform(
                size=mask.shape) < (0.5 if kind == "agent" else 0.8),
                device=dev)
            x, src, r = (None if a is None else a.to(dtype)
                         for a in (x, src, r))
            with torch.no_grad():
                fns = {"parent": lambda: parent_fused(lib, pack, x, src, r,
                                                      mask, H),
                       "change": lambda: change_fused(lib_c, pack, x, src, r,
                                                      mask, H)}
                diff = S._err(fns["change"]().float(),
                              fns["parent"]().float(), "fused A/B")
                t = in_turns(fns, S.KERNEL_LAUNCHES)
                for who, fn in fns.items():
                    t[who]["device_ms"] = sum(stage_ms(fn).values())
                    t[who]["host_us"] = host_us(fn)
            per_call[kind] = dict(builds=t, max_abs_diff=diff[0])
        mean = lambda key: {
            who: sum(c["builds"][who][key] for c in per_call.values())
            / len(per_call) for who in ("parent", "change")}
        ms, dev_ms = mean("ms"), mean("device_ms")
        emit("fused_attention_block", dtype=str(dtype)[6:], calls=per_call,
             mean_ms=ms, ratio=ms["change"] / ms["parent"],
             mean_device_ms=dev_ms,
             device_ratio=dev_ms["change"] / dev_ms["parent"])


def ab_column(lib_p, lib_c, lat, attr, dev, emit):
    import chip_smoke as S
    from infgen_torch.ops import column_kernel as CK

    H, Hd, L = lat.num_heads, lat.head_dim, lat.num_agent_layers
    for dtype in (S.BF16, S.F32):
        dec = S.decoder_for(lat, attr, dtype, dev)
        pdt = None if dtype == S.F32 else dtype
        pack = CK.pack_column_params(dec, L, pdt)
        args, _ = S.column_inputs(dec, lat, pdt, np.random.default_rng(37),
                                  "masked", dev)
        with torch.no_grad():
            fns = {"parent": lambda: column_call(lib_p, pack, args, H, Hd,
                                                 False),
                   "change": lambda: column_call(lib_c, pack, args, H, Hd,
                                                 True)}
            a, b = fns["change"](), fns["parent"]()
            diff = S._err(a, b, "motion_column A/B")
            t = in_turns(fns, S.KERNEL_LAUNCHES)
            for who, fn in fns.items():
                t[who]["device_ms"] = sum(stage_ms(fn).values())
                t[who]["host_us"] = host_us(fn)
        emit("motion_column", dtype=str(dtype)[6:], builds=t,
             ratio=t["change"]["ms"] / t["parent"]["ms"],
             device_ratio=t["change"]["device_ms"] / t["parent"]["device_ms"],
             max_abs_diff=diff[0], mean_abs_diff=diff[1],
             bitwise_equal=bool(torch.equal(a, b)))


def ab_rba(lib_p, lib_c, cfg, attr, dev, emit):
    import chip_smoke as S

    A, D, H = cfg.max_agents, cfg.hidden_dim, cfg.num_heads
    a2a = S.decoder_for(cfg, attr, S.F32, dev).a2a_attn_layers[0]
    w = (a2a.w_kr.detach(), a2a.w_vr.detach())
    args = S.rba_inputs(np.random.default_rng(59), 1, A, A, D, D, H, False,
                        dev, w)
    with torch.no_grad():
        fns = {"parent": lambda: rba_call(lib_p, args, H),
               "change": lambda: rba_call(lib_c, args, H)}
        diff = S._err(fns["change"](), fns["parent"](), "rba A/B")
        t = in_turns(fns, S.KERNEL_LAUNCHES)
        for who, fn in fns.items():
            t[who]["device_ms"] = sum(stage_ms(fn).values())
            t[who]["host_us"] = host_us(fn)
    emit("r_biased_attention", dtype="float32", builds=t,
         ratio=t["change"]["ms"] / t["parent"]["ms"],
         device_ratio=t["change"]["device_ms"] / t["parent"]["device_ms"],
         max_abs_diff=diff[0], mean_abs_diff=diff[1])


def _ab(lib_p, lib_c, fns, what, emit, name, dtype):
    """Time fns['parent'] / fns['change'] in turns, with their device ms
    and host enqueue time, and emit their outputs' difference."""
    import chip_smoke as S

    with torch.no_grad():
        a, b = fns["change"](), fns["parent"]()
        diff = S._err(a, b, what)
        t = in_turns(fns, S.KERNEL_LAUNCHES)
        for who, fn in fns.items():
            t[who]["device_ms"] = sum(stage_ms(fn).values())
            t[who]["host_us"] = host_us(fn)
    emit(name, dtype=str(dtype)[6:], builds=t,
         ratio=t["change"]["ms"] / t["parent"]["ms"],
         device_ratio=t["change"]["device_ms"] / t["parent"]["device_ms"],
         max_abs_diff=diff[0], mean_abs_diff=diff[1],
         bitwise_equal=all(torch.equal(x, y) for x, y in zip(a, b)))


def ab_refine(lib_p, lib_c, lat, attr, dev, emit):
    import chip_smoke as S
    from infgen_torch.ops import refine_kernel as RK

    H, Hd, L = lat.num_heads, lat.head_dim, lat.num_seed_layers
    for dtype in (S.BF16, S.F32):
        dec = S.decoder_for(lat, attr, dtype, dev)
        pdt = None if dtype == S.F32 else dtype
        pack = RK.pack_refine_params(dec, L, attr.angle_size, pdt)
        args = S.refine_inputs(dec, lat, pdt, np.random.default_rng(31),
                               "masked", dev)
        _ab(lib_p, lib_c,
            {"parent": lambda: parent_refine(lib_p, pack, args, H, Hd),
             "change": lambda: change_refine(lib_c, pack, args, H, Hd)},
            "refine A/B", emit, "refine", dtype)


def ab_seed_eval(lib_p, lib_c, cfg, attr, dev, emit):
    import chip_smoke as S
    from infgen_torch.ops import seed_kernel as SK

    G, H, Hd, L = (attr.grid_size, cfg.num_heads, cfg.head_dim,
                   cfg.num_seed_layers)
    for dtype in (S.BF16, S.F32):
        dec = S.decoder_for(cfg, attr, dtype, dev)
        pdt = None if dtype == S.F32 else dtype
        pack = SK.pack_seed_params(dec, L, G, pdt)
        args = S.seed_eval_inputs(dec, cfg, G, pdt, np.random.default_rng(23),
                                  "masked", dev)
        _ab(lib_p, lib_c,
            {"parent": lambda: seed_eval_call(lib_p, pack, args, H, Hd),
             "change": lambda: seed_eval_call(lib_c, pack, args, H, Hd)},
            "seed_eval A/B", emit, "seed_eval", dtype)


def _both(lib_change, lib_parent, fn):
    """fn() through each build: the wrappers load the library through
    build.library(), which returns build._lib once it is set."""
    from infgen_torch.ops import build as B

    outs = []
    for lib in (lib_change, lib_parent):
        with mock.patch.object(B, "_lib", lib), torch.no_grad():
            out = fn()
            outs.append(tuple(o.clone() for o in out)
                        if isinstance(out, tuple) else out.clone())
    torch.cuda.synchronize()
    return outs


def _equal(a, b):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return all(torch.equal(x, y) for x, y in zip(a, b))


def ab_unchanged(lib_c, lib_p, kernels, cfg, lat, attr, dev, emit,
                 parent_tiles=False):
    """`kernels`, the ones outside the change: outputs of both builds on
    the smoke's cases, equal bit for bit (each wrapper called once with
    each build's library; motion_column through column_call and refine
    through change_refine / parent_refine, whose interfaces differ;
    `parent_tiles`: the parent's column takes the tile pointer too)."""
    import chip_smoke as S
    from infgen_torch.ops import column_kernel as CK
    from infgen_torch.ops import fused_block as FB
    from infgen_torch.ops import pallas_attention as PA
    from infgen_torch.ops import refine_kernel as RK
    from infgen_torch.ops import seed_kernel as SK

    G, H, Hd = attr.grid_size, cfg.num_heads, cfg.head_dim
    res = {}
    for dtype in (S.F32, S.BF16):
        pdt = None if dtype == S.F32 else dtype
        tag = str(dtype)[6:]
        dec = S.decoder_for(cfg, attr, dtype, dev)
        ldec = S.decoder_for(lat, attr, dtype, dev)
        if "seed_eval" in kernels:
            pack = SK.pack_seed_params(dec, cfg.num_seed_layers, G, pdt)
            for case in ("masked", "map_all_masked", "agents_all_masked"):
                args = S.seed_eval_inputs(dec, cfg, G, pdt,
                                          np.random.default_rng(23), case,
                                          dev)
                res[f"seed_eval/{tag}/{case}"] = _equal(*_both(
                    lib_c, lib_p, lambda: SK.seed_eval_kernel(
                        pack, *args, H, Hd)))
        if "seed_eval_full" in kernels:
            fpack = SK.pack_seed_params_full(ldec, lat.num_seed_layers, G,
                                             pdt)
            for case in ("masked", "map_all_masked", "agents_all_masked"):
                args = S.seed_full_inputs(ldec, lat, G, pdt,
                                          np.random.default_rng(29), case,
                                          dev)
                res[f"seed_eval_full/{tag}/{case}"] = _equal(*_both(
                    lib_c, lib_p, lambda: SK.seed_eval_full_kernel(
                        fpack, *args, H, Hd)))
        if "refine" in kernels:
            rpack = RK.pack_refine_params(ldec, lat.num_seed_layers,
                                          attr.angle_size, pdt)
            for case in ("masked", "map_all_masked", "agents_all_masked"):
                args = S.refine_inputs(ldec, lat, pdt,
                                       np.random.default_rng(31), case, dev)
                with torch.no_grad():
                    a = change_refine(lib_c, rpack, args, H, Hd)
                    b = parent_refine(lib_p, rpack, args, H, Hd)
                res[f"refine/{tag}/{case}"] = _equal(a, b)
        if "motion_column" in kernels:
            cpack = CK.pack_column_params(ldec, lat.num_agent_layers, pdt)
            for case in ("masked", "aa_all_masked", "n_rows"):
                args, _ = S.column_inputs(ldec, lat, pdt,
                                          np.random.default_rng(37), case,
                                          dev)
                with torch.no_grad():
                    a = column_call(lib_c, cpack, args, H, Hd, True)
                    b = column_call(lib_p, cpack, args, H, Hd,
                                    parent_tiles)
                res[f"motion_column/{tag}/{case}"] = _equal(a, b)
        if "fused_attention_block" in kernels:
            fdec = S.decoder_for(cfg, attr, S.F32, dev)
            for kind, name, mode in S.FUSED_CASES:
                fb = FB.pack_fused_block(getattr(fdec, name))
                for mc in S.MASK_CASES:
                    x, src, r, mask = S.fused_inputs(
                        fdec, cfg, kind, mode, mc, np.random.default_rng(41),
                        dev)
                    if dtype == S.BF16:   # bf16 tensors, as the rollout's
                        x, src, r = (None if t is None else t.to(S.BF16)
                                     for t in (x, src, r))
                    res[f"fused_attention_block/{tag}/{kind}/{mc}"] = \
                        _equal(*_both(lib_c, lib_p,
                                      lambda: FB.fused_attention_block(
                                          fb, x, src, r, mask, H)))
    if "r_biased_attention" in kernels:
        a2a = S.decoder_for(cfg, attr, S.F32, dev).a2a_attn_layers[0]
        w = (a2a.w_kr.detach(), a2a.w_vr.detach())
        for name, (B_, Q, K, ww) in {"rollout": (1, cfg.max_agents,
                                                 cfg.max_agents, w),
                                     "bipartite": (2, 40, 300, None)}.items():
            for drop in (False, True):
                args = S.rba_inputs(np.random.default_rng(53), B_, Q, K,
                                    cfg.hidden_dim, cfg.hidden_dim, H, drop,
                                    dev, ww)
                res[f"r_biased_attention/{name}/{drop}"] = _equal(*_both(
                    lib_c, lib_p, lambda: PA.r_biased_attention(
                        *args[:7], H, args[7])))
    emit("unchanged_kernels", kernels=list(kernels),
         bitwise_equal=all(res.values()), cases=res)


def main(argv=None):
    p = argparse.ArgumentParser("ab_kernels")
    p.add_argument("--parent", required=True, choices=sorted(PARENT_ARGS),
                   help="the other tree's commit, which fixes its interface")
    p.add_argument("--parent-csrc", required=True)
    p.add_argument("--kernels", required=True,
                   help="comma-separated: the kernels the change redesigned")
    p.add_argument("--out", default=None, help="also append the lines here")
    args = p.parse_args(argv)
    timed = args.kernels.split(",")
    bad = [k for k in timed if k not in TIMED[args.parent]]
    if bad:
        p.error(f"{bad} are not timed against {args.parent}: "
                f"{TIMED[args.parent]}")
    if not torch.cuda.is_available():
        print("ab_kernels needs a GPU", file=sys.stderr)
        return 1
    import chip_smoke as S
    from infgen_torch.cli import build_tokenizers
    from infgen_torch.config import load_config
    from infgen_torch.ops import build as B

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    def emit(item, **fields):
        line = json.dumps({"item": item, **fields})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         parent=args.parent, kernels=timed)
    parent_lib = B.BUILD_DIR / "parent" / "libinfgen_kernels.so"
    emit("build", change_s=B.build(force=True),
         parent_s=build_tree(Path(args.parent_csrc), parent_lib))
    lib_c = B.library()
    lib_p = ctypes.CDLL(str(parent_lib))
    _declare_parent(lib_p, args.parent)
    cfg, lat = load_config(S.FLAGSHIP), load_config(S.LATENCY)
    attr = build_tokenizers(cfg)[0]
    if "seed_eval_full" in timed:
        ab_seed_full(lib_p, lat, attr, dev, emit)
    if "fused_attention_block" in timed:
        ab_fused(lib_p, lib_c, cfg, attr, dev, emit)
    if "motion_column" in timed:
        ab_column(lib_p, lib_c, lat, attr, dev, emit)
    if "r_biased_attention" in timed:
        ab_rba(lib_p, lib_c, cfg, attr, dev, emit)
    if "refine" in timed:
        ab_refine(lib_p, lib_c, lat, attr, dev, emit)
    if "seed_eval" in timed:
        ab_seed_eval(lib_p, lib_c, cfg, attr, dev, emit)
    ab_unchanged(lib_c, lib_p, [k for k in KERNELS if k not in timed], cfg,
                 lat, attr, dev, emit, args.parent in COLUMN_TILES)
    return 0


if __name__ == "__main__":
    sys.exit(main())
