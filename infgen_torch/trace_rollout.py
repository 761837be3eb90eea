"""Where a rollout's time goes on the card: one profiled flagship rollout.

    python -m infgen_torch.trace_rollout [--config configs/ours_long_term.yaml]
        [--fused-block] [--pallas-attention] [--batch B]

(`--config configs/ours_long_term_latency.yaml` traces the latency preset,
with its three kernels; `--fused-block` and `--pallas-attention` the
flagship's two variants, as the command line's rollout takes them;
`--batch B` serves B synthetic scenarios through the command line's
batched rollout, RolloutServer.rollout_batch with at most B lanes, and
reports per batched token step.)

Builds the model from the config's seed, runs one short warm-up rollout,
times one full rollout without the profiler (host clock around work that
ends in a synchronise), then runs the same rollout under `torch.profiler`
(CPU and CUDA activities) and prints one JSON line:

  wall_ms_per_step      unprofiled wall time per token step
  device_busy_ms        union of the device's kernel and copy intervals
  device_idle_share     1 - busy / profiled wall
  kernels_per_step      device kernels launched per token step
  spans                 host ms, kernel launches and device ms inside the
                        rollout's `rollout.insertion` / `rollout.motion`
                        spans
  top_kernels           the ten kernels with the most device time
  port_kernels          count and device ms of each of the port's own
                        kernels (infgen_torch/ops/csrc), by name

It needs a GPU and fails without one.
"""

import argparse
import bisect
import json
import re
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from infgen_torch.cli import (add_variant_flags, apply_variant_flags,
                              build_model, build_tokenizers, run_batched,
                              run_rollouts)
from infgen_torch.config import SHIFT, load_config
from infgen_torch.utils.device import resolve_device

SPANS = ("rollout.insertion", "rollout.motion")


def _port_kernel_names():
    """The __global__ functions of the port's CUDA sources."""
    from infgen_torch.ops.build import CSRC

    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                     r"(\w+)\s*\(")
    return {n for f in CSRC.glob("*.cu") for n in pat.findall(f.read_text())}


def _union_ms(intervals):
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total / 1e3


def _span_of(ranges):
    """t -> index of the range in `ranges` (sorted, disjoint) holding t,
    or -1."""
    starts = [r.start for r in ranges]

    def find(t):
        i = bisect.bisect_right(starts, t) - 1
        return i if i >= 0 and t <= ranges[i].end else -1
    return find


def summarize(prof, n_steps, wall_ms, spans=SPANS):
    """The JSON summary of one profiled rollout (times in ms; `spans`: the
    record_function names to break it down by). A device kernel is
    attributed to the span in which it starts: with the device mostly
    idle, a kernel starts within microseconds of its launch."""
    events = prof.events()
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not e.is_user_annotation and e.name not in spans]
    by_name = {}
    for e in dev:
        t = by_name.setdefault(e.name, [0, 0.0])
        t[0] += 1
        t[1] += (e.time_range.end - e.time_range.start) / 1e3
    busy = _union_ms([(e.time_range.start, e.time_range.end) for e in dev])
    launches = [e.time_range.start for e in cpu
                if e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                              "cudaLaunchKernelExC")]
    span_rows = {}
    for s in spans:
        rs = sorted((e.time_range for e in cpu if e.name == s),
                    key=lambda r: r.start)
        find = _span_of(rs)
        span_rows[s] = dict(
            count=len(rs), host_ms=sum(r.end - r.start for r in rs) / 1e3,
            launches=sum(find(t) >= 0 for t in launches),
            device_ms=sum(e.time_range.end - e.time_range.start
                          for e in dev if find(e.time_range.start) >= 0)
            / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    port, names = {}, _port_kernel_names()
    for k, (c, ms) in by_name.items():
        m = re.search(r"\(anonymous namespace\)::(\w+)", k)
        if m and m.group(1) in names:
            name = k.split("(anonymous namespace)::", 1)[1].split("(", 1)[0]
            port[name] = dict(count=c, ms=ms)
    return dict(
        profiled_wall_ms=wall_ms, device_busy_ms=busy,
        device_idle_share=1.0 - busy / wall_ms,
        kernels=len(dev), kernels_per_step=len(dev) / n_steps,
        host_launches=len(launches), spans=span_rows,
        top_kernels=[dict(name=k[:80], count=c, ms=ms)
                     for k, (c, ms) in top],
        port_kernels=port)


def main(argv=None):
    p = argparse.ArgumentParser("infgen_torch.trace_rollout")
    p.add_argument("--config", default="configs/ours_long_term.yaml")
    add_variant_flags(p)
    p.add_argument("--batch", type=int, default=None,
                   help="trace B synthetic scenarios served in batches of "
                        "at most B lanes")
    args = p.parse_args(argv)
    dev = resolve_device("cuda")
    cfg = apply_variant_flags(load_config(args.config), args)
    tokenizers = build_tokenizers(cfg)
    model = build_model(cfg, tokenizers[0], dev)
    n_steps = cfg.num_recurrent_steps_val // SHIFT

    def once(frames=None):
        if args.batch:
            s = run_batched(cfg, dev, args.batch, args.batch, model=model,
                            tokenizers=tokenizers,
                            num_recurrent_steps=frames)[1]
            s["ms_per_token_step"] = [s["ms_per_batched_token_step"]]
            return s
        return run_rollouts(cfg, dev, 1, model=model, tokenizers=tokenizers,
                            num_recurrent_steps=frames)[1]

    once(frames=5 * SHIFT)                                  # warm-up
    plain = once()
    if args.batch:
        # kernels per batched token step: the steps of every batch
        n_steps *= len(plain["batches"])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        traced = once()
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    print(json.dumps(dict(
        device=torch.cuda.get_device_name(dev), config=args.config,
        fused_block=cfg.use_fused_block,
        pallas_attention=cfg.use_pallas_attention,
        batch=args.batch, batches=plain.get("batches"),
        agent_steps_per_s=plain.get("agent_steps_per_s"),
        token_steps=n_steps,
        wall_ms_per_step=plain["ms_per_token_step"][0],
        agents_inserted=(plain["agents_inserted"] if args.batch
                         else plain["agents_inserted"][0]),
        kernel_launches=traced["kernel_launches"],
        host_reads=traced["host_reads"],
        **summarize(prof, n_steps, wall_ms))), flush=True)


if __name__ == "__main__":
    main()
