"""Checkpoints of a Trainer (port of infgen_tpu/train/checkpoint.py): a
full-state save and resume, and a weights-only non-strict warm start.

One `torch.save` file per saved step, `step_{N}.pt`, holding the step, the
model's state dict, the optimizer's and the metrics given to `save`. A
manager keeps the newest `max_to_keep` files, or with `best_fn` the
`max_to_keep` best by that value of their metrics (the JAX package's
orbax best-k mode, kept in `metrics.json` beside the files).
`restore_raw` returns a saved dict as it is, and `load_weights` loads its
model entries by state-dict key and shape, keeping the module's own tensor
wherever the saved one is missing or mismatched.
"""

import json
import os
import re
from typing import Callable, Dict, List, Optional

import torch


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5,
                 best_fn: Optional[Callable[[Dict], float]] = None,
                 best_mode: str = "min"):
        if best_mode not in ("min", "max"):
            raise ValueError(f"best_mode {best_mode!r}: 'min' or 'max'")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.best_fn, self.best_mode = best_fn, best_mode
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def _metrics_path(self) -> str:
        return os.path.join(self.directory, "metrics.json")

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)\.pt", name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def metrics(self) -> Dict[int, Dict]:
        """{step: the metrics saved with it} of the files kept."""
        path = self._metrics_path()
        if not os.path.exists(path):
            return {}
        with open(path) as f:
            return {int(k): v for k, v in json.load(f).items()}

    def _ranked(self, steps: List[int], metrics: Dict[int, Dict]
                ) -> List[int]:
        """`steps` best first by best_fn (ties: the newer first); steps
        without metrics last."""
        sign = 1.0 if self.best_mode == "min" else -1.0
        return sorted(steps, key=lambda s: (
            s not in metrics,
            sign * self.best_fn(metrics[s]) if s in metrics else 0.0, -s))

    def save(self, step: int, trainer, metrics: Optional[Dict] = None
             ) -> str:
        """Write `trainer`'s state at `step` (with `metrics`), then drop the
        files beyond max_to_keep: the oldest, or with best_fn the worst."""
        path = self._path(step)
        tmp = path + ".tmp"
        torch.save(dict(step=step, model=trainer.model.state_dict(),
                        optimizer=trainer.optimizer.state_dict(),
                        metrics=metrics), tmp)
        os.replace(tmp, path)
        steps = self.all_steps()
        recorded = self.metrics()
        if metrics is not None:
            recorded[step] = metrics
        if self.best_fn is not None:
            keep = set(self._ranked(steps, recorded)[:self.max_to_keep])
        else:
            keep = set(steps[-self.max_to_keep:])
        for old in steps:
            if old not in keep:
                os.remove(self._path(old))
        recorded = {s: m for s, m in recorded.items() if s in keep}
        if recorded or os.path.exists(self._metrics_path()):
            with open(self._metrics_path(), "w") as f:
                json.dump({str(s): m for s, m in sorted(recorded.items())},
                          f)
        return path

    def restore_raw(self, step: Optional[int] = None) -> Optional[Dict]:
        """The dict saved at `step` (default the latest) on the CPU, as it
        was written, without a template; None when nothing is saved."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return torch.load(self._path(step), map_location="cpu",
                          weights_only=True)

    def restore(self, trainer, step: Optional[int] = None) -> Optional[int]:
        """Load the state of `step` (default the latest) into `trainer`,
        strictly: a model or optimizer whose entries differ from the saved
        ones raises (RuntimeError or KeyError). Returns the step, or None
        when nothing is saved."""
        state = self.restore_raw(step)
        if state is None:
            return None
        trainer.model.load_state_dict(state["model"])
        trainer.optimizer.load_state_dict(state["optimizer"])
        trainer.step = state["step"]
        return state["step"]


def load_weights(module: torch.nn.Module, saved: Dict[str, torch.Tensor],
                 log_fn: Callable[[str], None] = print) -> List[str]:
    """Non-strict weights-only load: every entry of `module`'s state dict
    takes the saved tensor of the same key and shape (cast to the entry's
    dtype); an entry whose saved counterpart is missing or of another
    shape keeps the module's own tensor, and `log_fn` names them. Returns
    the kept keys."""
    own = module.state_dict()
    merged, kept = {}, []
    for key, tensor in own.items():
        src = saved.get(key)
        if src is not None and tuple(src.shape) == tuple(tensor.shape):
            merged[key] = src
        else:
            merged[key] = tensor
            kept.append(key)
    module.load_state_dict(merged)
    if kept:
        more = "..." if len(kept) > 5 else ""
        log_fn(f"load_weights: kept {len(kept)} module entries "
               f"(missing/mismatched): {kept[:5]}{more}")
    return kept
