"""Profiling and timing helpers (port of infgen_tpu/utils/profiling.py):
a torch.profiler trace, a wall-clock phase timer and the devices' memory
statistics."""

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block (the CPU, and the card when there is
    one); on exit the trace goes to <log_dir>/trace.json (Chrome /
    Perfetto format)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Accumulating wall-clock phase timer:

        with timer.phase("step"): ...
        print(timer.summary())

    Host time only: a phase that must hold its device work ends in a
    synchronise or a host read."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        lines = []
        for k in sorted(self.totals):
            n = self.counts[k]
            lines.append(f"{k}: total {self.totals[k]:.3f}s, n={n}, "
                         f"mean {self.totals[k] / max(n, 1) * 1e3:.1f}ms")
        return "\n".join(lines)


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    """Per CUDA device, bytes in use and the peak, in GiB
    (torch.cuda.memory_stats); empty without CUDA."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use_gib": s.get("allocated_bytes.all.current", 0)
            / 2 ** 30,
            "peak_bytes_gib": s.get("allocated_bytes.all.peak", 0) / 2 ** 30,
        }
    return out
