"""Batch loading with worker processes and prefetch to the device (port of
infgen_tpu/data/loader.py):

  spawn workers -> numpy scenarios -> host stacking -> pinned copies
  enqueued to the device `depth` batches ahead of the step

Workers build host-side numpy scenarios only and never touch CUDA; the
parent stacks them and copies each batch with `non_blocking=True` from
pinned memory, so that the copies overlap the steps already enqueued.
"""

import multiprocessing as mp
import warnings
from collections import deque
from typing import Iterator, List

import numpy as np
import torch

from infgen_torch.data.scenario import stack_scenarios, tree_map

_WORKER_DATASET = None


def _worker_init(dataset):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _worker_get(i: int):
    return _WORKER_DATASET[int(i)]


class BatchLoader:
    """Batched epoch iterator over an indexable dataset of host-side
    scenarios.

    num_workers = 0 loads inline; > 0 uses a pool of spawn processes (fork
    is unsafe once torch has started its threads), so the dataset must be
    picklable (SyntheticDataset and OverfitDataset are). At most
    num_workers + prefetch_batches x batch_size scenarios are in flight.
    `close` ends the pool."""

    def __init__(self, dataset, batch_size: int, num_workers: int = 0,
                 prefetch_batches: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.prefetch_batches = max(prefetch_batches, 1)
        self._pool = None

    def _ensure_pool(self):
        if self._pool is None and self.num_workers > 0:
            ctx = mp.get_context("spawn")
            self._pool = ctx.Pool(self.num_workers, initializer=_worker_init,
                                  initargs=(self.dataset,))
        return self._pool

    def close(self):
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def epoch(self, shuffle: bool = True, seed: int = 0) -> Iterator[List]:
        """Yield lists of batch_size scenarios (callers stack and copy):
        the dataset in the order of a numpy shuffle from `seed` (the same
        order with or without workers), the last partial batch dropped."""
        n = len(self.dataset)
        order = np.arange(n)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        order = order[: (n // self.batch_size) * self.batch_size]
        if len(order) == 0:
            warnings.warn(
                f"BatchLoader.epoch: dataset size {n} < batch size "
                f"{self.batch_size}: the epoch yields no batch", stacklevel=2)
        if self.num_workers == 0:
            for i in range(0, len(order), self.batch_size):
                yield [self.dataset[j] for j in order[i:i + self.batch_size]]
            return
        pool = self._ensure_pool()
        # a bounded window of requests: imap would buffer results without
        # back-pressure when the steps are slower than the workers
        max_inflight = self.num_workers + \
            self.prefetch_batches * self.batch_size
        it = iter(order)
        pending = deque()
        for i in it:
            pending.append(pool.apply_async(_worker_get, (int(i),)))
            if len(pending) >= max_inflight:
                break
        batch: List = []
        while pending:
            scen = pending.popleft().get()
            nxt = next(it, None)
            if nxt is not None:
                pending.append(pool.apply_async(_worker_get, (int(nxt),)))
            batch.append(scen)
            if len(batch) == self.batch_size:
                yield batch
                batch = []


def stage_batch(scenarios, device) -> object:
    """Stack host scenarios (numpy leaves) and copy them to `device`: on a
    card from pinned memory with non_blocking=True (the copy is enqueued on
    the current stream, after the steps already there)."""
    stacked = stack_scenarios(scenarios)
    if device.type != "cuda":
        return tree_map(lambda x: torch.as_tensor(x, device=device), stacked)
    return tree_map(lambda x: torch.from_numpy(np.ascontiguousarray(x))
                    .pin_memory().to(device, non_blocking=True), stacked)


def staged(batches: Iterator, stage_fn, depth: int = 4) -> Iterator:
    """Keep `depth` batches staged ahead through `stage_fn` (stage_batch:
    copies enqueued to the device), yielding them in order."""
    q: deque = deque()
    it = iter(batches)
    for b in it:
        q.append(stage_fn(b))
        if len(q) >= depth:
            break
    while q:
        out = q.popleft()
        nxt = next(it, None)
        if nxt is not None:
            q.append(stage_fn(nxt))
        yield out
