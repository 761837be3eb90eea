"""Where a training step's time goes on the card: profiled steps of the
training main path.

    python -m infgen_torch.trace_train [--config configs/ours_long_term.yaml]
        [--pallas-attention] [--batch 2] [--steps 4]

Builds the Trainer (weights from the config's seed) with the flags as the
command line's `train` takes them, on one batch of synthetic scenarios
(seeds 0, 1, ...), runs two warm-up steps, times `--steps` steps without
the profiler (host clock around work that ends in a synchronise), then
runs one more step under `torch.profiler` (CPU and CUDA activities) and
prints one JSON line: wall ms per step (median), peak memory, and
trace_rollout.summarize's breakdown of the profiled step (device busy ms,
idle share, kernels, the spans `train.forward` / `train.backward` /
`train.optimizer` with their host ms, launches and device ms, the top
kernels and the port's own kernels). It needs a GPU and fails without one.
"""

import argparse
import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from infgen_torch.cli import add_variant_flags, apply_variant_flags
from infgen_torch.config import load_config
from infgen_torch.data.scenario import stack_scenarios, to_device
from infgen_torch.trace_rollout import summarize
from infgen_torch.train.loop import SyntheticDataset
from infgen_torch.train.train_step import Trainer
from infgen_torch.utils.device import resolve_device

SPANS = ("train.forward", "train.backward", "train.optimizer")


def main(argv=None):
    p = argparse.ArgumentParser("infgen_torch.trace_train")
    p.add_argument("--config", default="configs/ours_long_term.yaml")
    add_variant_flags(p)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--steps", type=int, default=4)
    args = p.parse_args(argv)
    dev = resolve_device("cuda")
    cfg = apply_variant_flags(load_config(args.config), args)
    data = SyntheticDataset(cfg, size=args.batch)
    batch = to_device(stack_scenarios([data[i] for i in range(args.batch)]),
                      dev)
    trainer = Trainer(cfg, dev)
    trainer.init_state()
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)

    def step():
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        logs = trainer.train_step(batch, gen)
        torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0) * 1e3, float(logs["loss"])

    for _ in range(2):
        step()
    torch.cuda.reset_peak_memory_stats(dev)
    ms = [step()[0] for _ in range(args.steps)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_ms, loss = step()
    print(json.dumps(dict(
        device=torch.cuda.get_device_name(dev), config=args.config,
        fused_block=cfg.use_fused_block,
        pallas_attention=cfg.use_pallas_attention,
        compute_dtype=cfg.compute_dtype, batch=args.batch,
        wall_ms_per_step=float(np.median(ms)), wall_ms=ms, loss=loss,
        max_memory_allocated=torch.cuda.max_memory_allocated(dev),
        **summarize(prof, 1, wall_ms, SPANS))), flush=True)


if __name__ == "__main__":
    main()
