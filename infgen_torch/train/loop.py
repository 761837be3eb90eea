"""Training loop on one device (port of the single-device core of
infgen_tpu/train/loop.py): epochs over a dataset of synthetic scenarios,
one JSON line of logs per step, a checkpoint at the end. Validation, the
multi-process BatchLoader and staged prefetch are not ported (ROADMAP
Queue 1 item 8)."""

import json
import os
import time
from typing import Callable, Optional

import torch

from infgen_torch.config import Config
from infgen_torch.data.scenario import Scenario, stack_scenarios, to_device
from infgen_torch.data.synthetic import make_synthetic_scenario
from infgen_torch.tokenizers.map_tokenizer import MapTokenizer
from infgen_torch.tokenizers.vocab import load_map_vocab
from infgen_torch.train.checkpoint import CheckpointManager
from infgen_torch.train.train_step import Trainer


class SyntheticDataset:
    """Deterministic synthetic scenarios (seed i for item i), host-side
    numpy."""

    def __init__(self, cfg: Config, size: int = 64):
        self.cfg = cfg
        self.size = size
        self._map_tok = MapTokenizer(load_map_vocab())
        self._cache = {}

    def __len__(self):
        return self.size

    def __getitem__(self, i: int) -> Scenario:
        if i not in self._cache:
            self._cache[i] = make_synthetic_scenario(
                self.cfg, seed=i, map_tokenizer=self._map_tok)
        return self._cache[i]


class OverfitDataset:
    """One fixed batch, repeated: its length is the batch size, so every
    epoch yields that batch."""

    def __init__(self, dataset, batch_size: int):
        self._items = [dataset[i] for i in range(batch_size)]

    def __len__(self):
        return len(self._items)

    def __getitem__(self, i: int):
        return self._items[i]


def train(cfg: Config, dataset, save_dir: Optional[str] = "runs/default",
          max_steps: Optional[int] = None, device=None,
          log_fn: Callable[[str], None] = print):
    """Train on `dataset` in order, `cfg.train_batch_size` scenarios per
    step, for `cfg.max_epochs` epochs or `max_steps` steps, weights from
    cfg.seed, on `device` (the card unless it says "cpu"); print one JSON
    line of logs per step (step, epoch, ms, every loss, grad_norm). With a `save_dir`, resume from its latest checkpoint
    and save one at the end. Returns (trainer, the per-step log dicts)."""
    trainer = Trainer(cfg, device)
    dev = trainer.device
    trainer.init_state()
    ckpt = CheckpointManager(os.path.join(save_dir, "ckpt")) \
        if save_dir else None
    if ckpt is not None and ckpt.restore(trainer) is not None:
        log_fn(json.dumps({"resumed_step": trainer.step}))
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    B = max(cfg.train_batch_size, 1)
    n_batches = max(len(dataset) // B, 1)
    history = []
    for epoch, b in ((e, b) for e in range(cfg.max_epochs)
                     for b in range(n_batches)):
        if max_steps is not None and trainer.step >= max_steps:
            break
        batch = to_device(stack_scenarios(
            [dataset[(b * B + i) % len(dataset)] for i in range(B)]), dev)
        t0 = time.perf_counter()
        logs = trainer.train_step(batch, gen)
        logs = {k: float(v) for k, v in logs.items()}   # waits for the step
        history.append(dict(step=trainer.step, epoch=epoch,
                            ms=(time.perf_counter() - t0) * 1e3, **logs))
        log_fn(json.dumps(history[-1]))
    if ckpt is not None:
        ckpt.save(trainer.step, trainer)
    return trainer, history
