"""Checkpoints of a Trainer (the part of infgen_tpu/train/checkpoint.py
that `train()` needs): the model's and the optimizer's state dicts and the
step, one `torch.save` file per saved step, the newest `max_to_keep`
kept."""

import os
import re
from typing import List, Optional

import torch


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

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

    def save(self, step: int, trainer) -> str:
        """Write `trainer`'s state at `step`, then drop the oldest files
        beyond max_to_keep."""
        path = self._path(step)
        tmp = path + ".tmp"
        torch.save(dict(step=step, model=trainer.model.state_dict(),
                        optimizer=trainer.optimizer.state_dict()), tmp)
        os.replace(tmp, path)
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self._path(old))
        return path

    def restore(self, trainer, step: Optional[int] = None) -> Optional[int]:
        """Load the state of `step` (default the latest) into `trainer`;
        returns the step, or None when nothing is saved."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        state = torch.load(self._path(step), map_location=trainer.device,
                           weights_only=True)
        trainer.model.load_state_dict(state["model"])
        trainer.optimizer.load_state_dict(state["optimizer"])
        trainer.step = state["step"]
        return step
