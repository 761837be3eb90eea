"""Which host operations launch a rollout's device work, in two trees.

    python scripts/launch_diff.py TREE_A TREE_B [--steps N] [--out FILE]
        [--config configs/ours_long_term.yaml] [--device cuda]

TREE_A and TREE_B are checkouts of this repository (for example a parent
commit unpacked with `git archive` beside the working tree). For each, in
a process of its own with that tree first on the path, the script builds
the flagship (or --config's model, with the config's seed) as
`infgen_torch.trace_rollout` does, runs one short warm-up rollout and
then one rollout of N token steps (`cli.run_rollouts`, unforced) under
`torch.profiler`. It counts

  device_events_per_step  the device's kernels, copies and fills per
                          token step, as trace_rollout's kernels_per_step
                          counts them
  launches_per_step       the host's kernel launches, copies and fills
                          per token step

and attributes every host launch to the innermost and the outermost aten
operation around it (aten::copy_ inside aten::index: a copy the index
op makes). It prints one JSON line: both trees' counts and the
(operation, outer operation) rows whose launches differ, largest
difference first. With --out it also
writes each tree's full table there.

Run from the root of a tree; it needs a GPU.
"""

import argparse
import collections
import json
import os
import subprocess
import sys

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync",
                "cudaMemcpy", "cudaMemset")


def attribute(events, launch_calls=LAUNCH_CALLS):
    """{(aten op, outermost aten op): host launches inside them} and the
    number of launches, from a profile's events: each launch call goes to
    the innermost and the outermost aten op whose time ranges hold its
    start. The rollout launches from one thread."""
    rows = collections.Counter()
    items = [e for e in events if e.device_type.name == "CPU" and (
        e.name in launch_calls or e.name.startswith("aten::"))]
    # outer events first where two start together
    items.sort(key=lambda e: (e.time_range.start, -e.time_range.end))
    open_, n = [], 0
    for e in items:
        start = e.time_range.start
        while open_ and open_[-1].time_range.end < start:
            open_.pop()
        if e.name not in launch_calls:
            open_.append(e)
            continue
        n += 1
        rows[(open_[-1].name, open_[0].name) if open_
             else ("(no aten op)", "")] += 1
    return rows, n


def one(config, steps, device):
    """Profile this tree's flagship rollout; print its table as JSON."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from infgen_torch.cli import build_model, build_tokenizers, run_rollouts
    from infgen_torch.config import SHIFT, load_config

    dev = torch.device(device)
    cfg = load_config(config)
    tokenizers = build_tokenizers(cfg)
    model = build_model(cfg, tokenizers[0], dev)

    def once(n):
        return run_rollouts(cfg, dev, 1, model=model, tokenizers=tokenizers,
                            num_recurrent_steps=n * SHIFT)[1]

    once(5)                                                  # warm-up
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        summary = once(steps)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    events = prof.events()
    dev_events = sum(1 for e in events if e.device_type.name == "CUDA"
                     and not e.is_user_annotation)
    rows, n = attribute(events)
    print(json.dumps(dict(
        steps=steps, agents_inserted=summary["agents_inserted"][0],
        device_events_per_step=dev_events / steps,
        launches_per_step=n / steps,
        rows=[[*k, c] for k, c in rows.items()])), flush=True)


def main(argv=None):
    p = argparse.ArgumentParser("launch_diff")
    p.add_argument("trees", nargs="*")
    p.add_argument("--config", default="configs/ours_long_term.yaml")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--device", default="cuda")
    p.add_argument("--one", action="store_true",
                   help="profile the tree this runs from (internal)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if args.one:
        return one(args.config, args.steps, args.device)
    if len(args.trees) != 2:
        p.error("give two trees")
    res = {}
    for tree in args.trees:
        tree = os.path.abspath(tree)
        env = dict(os.environ, PYTHONPATH=tree)
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one",
             "--config", args.config, "--steps", str(args.steps),
             "--device", args.device],
            cwd=tree, env=env, capture_output=True, text=True, check=True)
        res[tree] = json.loads(out.stdout.strip().splitlines()[-1])
    a, b = (res[os.path.abspath(t)] for t in args.trees)
    ca = {tuple(r[:2]): r[2] for r in a["rows"]}
    cb = {tuple(r[:2]): r[2] for r in b["rows"]}
    diff = sorted(((*k, ca.get(k, 0), cb.get(k, 0)) for k in set(ca) | set(cb)
                   if ca.get(k, 0) != cb.get(k, 0)),
                  key=lambda r: -abs(r[3] - r[2]))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f)
    print(json.dumps(dict(
        trees=args.trees, steps=args.steps,
        **{k: [a[k], b[k]] for k in ("agents_inserted",
                                     "device_events_per_step",
                                     "launches_per_step")},
        differ=[dict(op=op, outer=outer, a=x, b=y,
                     per_step=(y - x) / args.steps)
                for op, outer, x, y in diff])), flush=True)


if __name__ == "__main__":
    main()
