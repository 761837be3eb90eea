"""Training and open-loop validation on one device (port of
infgen_tpu/train/loop.py): epochs over a dataset through the worker
BatchLoader and staged copies to the device, one JSON line of logs per
logged step, periodic open-loop validation with best-k checkpoints by
validation loss, warm starts and resume; `validate_open_loop` and
`check_inputs`."""

import contextlib
import dataclasses
import json
import os
import time
from typing import Callable, Dict, List, Optional

import torch

from infgen_torch.config import Config
from infgen_torch.data.features import build_model_inputs
from infgen_torch.data.loader import BatchLoader, stage_batch, staged
from infgen_torch.data.scenario import Scenario, to_device
from infgen_torch.data.synthetic import make_synthetic_scenario
from infgen_torch.metrics.train_metrics import (grid_overlap_rate,
                                                state_accuracy,
                                                token_cls_accuracy)
from infgen_torch.tokenizers.attr_tokenizer import AttrTokenizer
from infgen_torch.tokenizers.map_tokenizer import MapTokenizer
from infgen_torch.tokenizers.motion_tokenizer import MotionTokenizer
from infgen_torch.tokenizers.vocab import load_map_vocab
from infgen_torch.train.checkpoint import CheckpointManager, load_weights
from infgen_torch.train.targets import roll_targets, token_state_eval_masks
from infgen_torch.train.train_step import Trainer
from infgen_torch.utils.backup import backup_source
from infgen_torch.utils.device import resolve_device
from infgen_torch.utils.logging import (close_log_file, get_logger,
                                        maybe_wandb_init)
from infgen_torch.utils.profiling import StepTimer, device_memory_stats, trace

# INFGEN_PROFILE=<dir>: the steps of this run traced (past the warm-up)
PROFILE_STEPS = (10, 14)


class SyntheticDataset:
    """Deterministic synthetic scenarios (seed i for item i), host-side
    numpy; picklable, so spawn loader workers can build them."""

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
    """One fixed batch, repeated (the reference's OVERFIT debug mode): its
    length is the batch size, so every epoch yields that batch."""

    def __init__(self, dataset, batch_size: int):
        self._items = [dataset[i] for i in range(batch_size)]

    def __len__(self):
        return len(self._items)

    def __getitem__(self, i: int):
        return self._items[i]


def _warm_start(trainer: Trainer, raw: Dict, log_fn) -> List[str]:
    """Weights only, non-strict, from a saved dict (restore_raw)."""
    return load_weights(trainer.model, raw.get("model", raw), log_fn)


def train(cfg: Config, dataset, save_dir: Optional[str] = "runs/default",
          max_steps: Optional[int] = None, device=None,
          log_fn: Optional[Callable[[str], None]] = None, log_every: int = 1,
          resume: bool = True, pretrain_ckpt: Optional[str] = None,
          val_dataset=None, ckpt_path: Optional[str] = None):
    """Train on `dataset` for `cfg.max_epochs` epochs or `max_steps` steps,
    `cfg.train_batch_size` scenarios per step in the order of a shuffle
    from cfg.seed + epoch (BatchLoader with cfg.num_workers spawn workers,
    cfg.prefetch_batches batches staged on the device), weights from
    cfg.seed, on `device` (the card unless it says "cpu").

    Every `log_every` steps `log_fn` (default: the run's logger) gets one
    JSON line: step, epoch, ms (host clock to the read of the logs),
    input_ms (of it, the wait for the next staged batch), every loss and
    grad_norm. With a `save_dir`: the source tree is copied to
    save_dir/backup_source, the logged records and the validation records
    go to save_dir/metrics.jsonl, a checkpoint is saved at the end in
    save_dir/ckpt; `resume` restores the latest one there (or the latest
    in `ckpt_path` when given) and falls back to a weights-only warm start
    when its entries no longer match the model. `pretrain_ckpt` (a
    checkpoint directory) warm-starts the weights non-strictly first.
    With `val_dataset`, every cfg.val_every_n_epochs epochs the model is
    validated open-loop on cfg.val_num_scenarios scenarios (a `val/*`
    record; none after the step that reaches max_steps), and
    save_dir/ckpt_best keeps the 5 best by validation loss. Under
    INFGEN_PROFILE=<dir> the steps PROFILE_STEPS of this run are traced
    to <dir>/trace.json. Returns (trainer, the logged step dicts)."""
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        backup_source(save_dir)
    log_file = os.path.join(save_dir, "train.log") if save_dir else None
    logger = get_logger(log_file=log_file)
    log_fn = log_fn or logger.info
    wandb_run = maybe_wandb_init("simagent", dataclasses.asdict(cfg))
    trainer = Trainer(cfg, device)
    dev = trainer.device
    trainer.init_state()

    ckpt = CheckpointManager(os.path.join(save_dir, "ckpt")) \
        if save_dir else None
    validate = val_dataset is not None and cfg.val_every_n_epochs > 0
    ckpt_best = None
    if save_dir and validate:
        ckpt_best = CheckpointManager(
            os.path.join(save_dir, "ckpt_best"), max_to_keep=5,
            best_fn=lambda m: m["val_loss"], best_mode="min")
    if pretrain_ckpt:
        raw = CheckpointManager(pretrain_ckpt).restore_raw()
        if raw is not None:
            kept = _warm_start(trainer, raw, log_fn)
            log_fn(json.dumps({"warm_started": pretrain_ckpt,
                               "kept": len(kept)}))
    source = CheckpointManager(ckpt_path) if ckpt_path else ckpt
    if resume and source is not None and source.latest_step() is not None:
        try:
            source.restore(trainer)
            log_fn(json.dumps({"resumed_step": trainer.step}))
        except (RuntimeError, KeyError) as e:
            # the saved entries differ from the model's (a head added
            # since, another optimizer wrapping): weights only, the
            # optimizer and the step start afresh
            trainer.init_state()
            _warm_start(trainer, source.restore_raw(), log_fn)
            log_fn(f"resume: checkpoint tree mismatches the current model "
                   f"({type(e).__name__}); warm-started weights only, "
                   f"optimizer state and step reset")

    metrics_log = open(os.path.join(save_dir, "metrics.jsonl"), "a") \
        if save_dir else None

    def record(rec):
        if metrics_log is not None:
            metrics_log.write(json.dumps(rec) + "\n")
            metrics_log.flush()
        if wandb_run is not None:
            wandb_run.log(rec, step=rec["step"])

    B = max(cfg.train_batch_size, 1)
    loader = BatchLoader(dataset, B, num_workers=cfg.num_workers,
                         prefetch_batches=cfg.prefetch_batches)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    profile_dir = os.environ.get("INFGEN_PROFILE")
    timer = StepTimer()
    profiler = contextlib.ExitStack()
    steps_this_run, history = 0, []
    t_last, input_last = time.perf_counter(), 0.0
    try:
        for epoch in range(cfg.max_epochs):
            batches = iter(staged(
                loader.epoch(shuffle=True, seed=cfg.seed + epoch),
                lambda bl: stage_batch(bl, dev), depth=cfg.prefetch_batches))
            while max_steps is None or trainer.step < max_steps:
                with timer.phase("input"):
                    batch = next(batches, None)
                if batch is None:
                    break
                if profile_dir and steps_this_run == PROFILE_STEPS[0]:
                    profiler.enter_context(trace(profile_dir))
                with timer.phase("step"):
                    logs = trainer.train_step(batch, gen)
                steps_this_run += 1
                if steps_this_run == PROFILE_STEPS[1] + 1:
                    profiler.close()
                if trainer.step % log_every == 0:
                    logs = {k: float(v) for k, v in logs.items()}  # waits
                    now = time.perf_counter()
                    waited = timer.totals["input"] - input_last
                    rec = dict(step=trainer.step, epoch=epoch,
                               ms=(now - t_last) * 1e3 / log_every,
                               input_ms=waited * 1e3 / log_every, **logs)
                    t_last, input_last = now, timer.totals["input"]
                    history.append(rec)
                    log_fn(json.dumps(rec))
                    record(rec)
            if max_steps is not None and trainer.step >= max_steps:
                break
            if validate and (epoch + 1) % cfg.val_every_n_epochs == 0:
                val = validate_open_loop(trainer, val_dataset,
                                         cfg.val_num_scenarios, log_fn)
                rec = {f"val/{k}": v for k, v in val.items()}
                rec.update(step=trainer.step, epoch=epoch)
                record(rec)
                if ckpt_best is not None:
                    ckpt_best.save(trainer.step, trainer,
                                   metrics={"val_loss": val["loss"]})
                t_last = time.perf_counter()
        if ckpt is not None:
            ckpt.save(trainer.step, trainer)
        return trainer, history
    finally:
        profiler.close()
        loader.close()
        if metrics_log is not None:
            metrics_log.close()
        if wandb_run is not None:
            wandb_run.finish()
        if timer.counts.get("step"):
            logger.info("phase timings:\n" + timer.summary())
            logger.info(f"device memory: {device_memory_stats()}")
        close_log_file(logger, log_file)


def accuracy_forward(trainer: Trainer, scenario, generator, draws: Dict):
    """The open-loop accuracy forward: the deterministic model on inputs
    built anew (the JAX function's second build, from the scenario's
    unsplit key). Returns (next-token logits, next-state logits, their
    targets, their evaluation masks) as dicts keyed "token" and "state".
    `draws`: `pt_uniform` and `sa_uniform`, else from `generator`."""
    cfg = trainer.cfg
    inputs = build_model_inputs(cfg, trainer.motion_tok, trainer.attr,
                                scenario, generator,
                                pt_uniform=draws.get("pt_uniform"))
    pred = trainer.model(inputs, scenario.map, trainer.agent_vocab,
                         trainer.map_traj, generator,
                         sa_uniform=draws.get("sa_uniform"))
    tok = inputs.tokens
    tok_gt, state_gt = roll_targets(tok.token_idx, tok.state_idx)
    tok_mask, state_mask = token_state_eval_masks(
        tok.raw_token_valid, tok.state_idx, inputs.av_index,
        inputs.slot_mask)
    return (dict(token=pred["next_token_logits"],
                 state=pred["next_state_logits"]),
            dict(token=tok_gt, state=state_gt),
            dict(token=tok_mask, state=state_mask))


def _accuracy_sums(trainer: Trainer, scenario, generator, draws: Dict):
    """Top-1 token and state hits and counts of accuracy_forward: (token
    hits, token count, state hits, state count) tensors."""
    logits, gt, mask = accuracy_forward(trainer, scenario, generator, draws)
    out = []
    for k in ("token", "state"):
        out += token_cls_accuracy(logits[k].argmax(-1)[..., None], gt[k],
                                  mask[k])
    return out


@torch.no_grad()
def validate_open_loop(trainer: Trainer, dataset, num_scenarios: int = 8,
                       log_fn: Callable[[str], None] = print,
                       draws: Optional[List[Dict]] = None) -> Dict:
    """Open-loop validation (the reference's val_open_loop): per scenario
    the deterministic loss and its logs (Trainer.loss_fn in eval mode),
    and the top-1 token and state accuracy of a second deterministic
    forward on inputs built anew, as the JAX package builds them twice.
    Returns the logs' means over the first `num_scenarios` scenarios and
    `token_accuracy` / `state_accuracy` (hits over counts, summed over
    the scenarios; the occupancy decoder predicts neither, so its result
    has the losses only). Draws come from a generator seeded cfg.seed +
    99 on the trainer's device, or per scenario from `draws[i]`: "loss"
    (Trainer.loss_fn's draws) and "accuracy" (`pt_uniform`,
    `sa_uniform`). Values are summed on the device and read once."""
    cfg = trainer.cfg
    dev = trainer.device
    was_training = trainer.model.training
    trainer.model.eval()
    gen = torch.Generator(device=dev).manual_seed(cfg.seed + 99)
    n = min(num_scenarios, len(dataset))
    totals: Dict[str, torch.Tensor] = {}
    acc = torch.zeros(4, dtype=torch.float64, device=dev)
    try:
        for i in range(n):
            scen = to_device(dataset[i], dev)
            d = draws[i] if draws else {}
            _, logs = trainer.loss_fn(scen, gen, d.get("loss"))
            for k, v in logs.items():
                totals[k] = totals.get(k, 0.0) + v.double()
            if not trainer.is_occ_decoder:
                acc += torch.stack(_accuracy_sums(
                    trainer, scen, gen, d.get("accuracy", {}))).double()
    finally:
        trainer.model.train(was_training)
    keys = sorted(totals)
    host = torch.stack([totals[k] for k in keys] + list(acc)).cpu().numpy()
    out = {k: float(v) / n for k, v in zip(keys, host)}
    if not trainer.is_occ_decoder:
        tok_s, tok_n, st_s, st_n = host[len(keys):]
        out["token_accuracy"] = float(tok_s / max(tok_n, 1))
        out["state_accuracy"] = float(st_s / max(st_n, 1))
    log_fn("open-loop val: " + " ".join(
        f"{k}={v:.4f}" for k, v in sorted(out.items())
        if k in ("loss", "token_cls_loss", "state_cls_loss",
                 "agent_occ_cls_loss", "pt_occ_cls_loss", "token_accuracy",
                 "state_accuracy")))
    return out


def edge_map_masks(cfg: Config, tokens, slot_mask) -> Dict[str, torch.Tensor]:
    """The dense attention masks of one scenario's tokenised ground truth,
    as the training forward builds them without its random history drop:
    {"a2a": [T, A, A], "temporal": [A, T, T]} (bool). `tokens` is the
    motion tokenizer's TokenizedAgents, `slot_mask` [A]."""
    from infgen_torch.model import edges as E

    _, hv = E.build_motion_vectors(tokens.token_pos, tokens.token_heading,
                                   tokens.state_idx)
    interact = (tokens.raw_token_valid | (tokens.state_idx == 2)) \
        & slot_mask[:, None]
    a2a = E.build_a2a_edges(tokens.token_pos, tokens.token_heading,
                            tokens.state_idx, hv, interact, cfg.a2a_radius)
    hist = E.training_hist_mask(tokens.raw_token_valid,
                                tokens.state_idx) & slot_mask[:, None]
    temporal = E.build_temporal_edges(
        tokens.token_pos, tokens.token_heading, tokens.state_idx, hv, hist,
        cfg.time_span // cfg.shift)
    return {"a2a": a2a.mask, "temporal": temporal.mask}


@torch.no_grad()
def check_inputs(cfg: Config, dataset, num_scenarios: int = 8,
                 log_fn: Callable[[str], None] = print, device=None):
    """Check the tokenisation itself on the ground truth (the reference's
    CHECK_INPUTS mode): state accuracy and grid overlap of the tokenised
    inputs of the first `num_scenarios` scenarios, built on `device` (the
    card unless it says "cpu"; the map mask's draw from a generator
    seeded i for scenario i, which neither count reads). Returns
    (totals, overlap): the four state-accuracy counts as ints and the
    per-step grid-overlap counts (numpy), summed over the scenarios.

    With the environment variable PLOT_EDGE set, scenario 0's dense a2a
    and temporal attention masks (`edge_map_masks`) are plotted into
    PLOT_EDGE_DIR (default runs/edge_maps); that mode needs matplotlib
    and raises at once without it."""
    dev = resolve_device(device)
    plot_edge = bool(os.environ.get("PLOT_EDGE"))
    if plot_edge:
        from infgen_torch.utils.visualization import (plot_attention_masks,
                                                      require_matplotlib)
        require_matplotlib()
    attr = AttrTokenizer(cfg.grid_range, cfg.grid_interval,
                         cfg.pl2seed_radius, cfg.angle_interval)
    mt = MotionTokenizer()
    keys = ("valid_sum", "valid_count", "invalid_sum", "invalid_count")
    sums, overlap = None, None
    for i in range(min(num_scenarios, len(dataset))):
        gen = torch.Generator(device=dev).manual_seed(i)
        inputs = build_model_inputs(cfg, mt, attr, to_device(dataset[i], dev),
                                    gen)
        if i == 0 and plot_edge:
            masks = edge_map_masks(cfg, inputs.tokens, inputs.slot_mask)
            plot_attention_masks(
                "check_inputs", {k: v.cpu().numpy() for k, v in masks.items()},
                os.environ.get("PLOT_EDGE_DIR", "runs/edge_maps"))
        sa = state_accuracy(inputs.tokens.state_idx)
        sa = torch.stack([sa[k] for k in keys]).long()
        go = grid_overlap_rate(inputs.tokens.state_idx,
                               inputs.grid_token_idx, attr.grid_size,
                               cfg.num_seed_feature)
        sums = sa if sums is None else sums + sa
        overlap = go if overlap is None else {k: overlap[k] + go[k]
                                              for k in go}
    totals = dict(zip(keys, (int(v) for v in sums.cpu())))
    overlap = {k: v.cpu().numpy() for k, v in overlap.items()}
    log_fn(f"StateAccuracy: valid={totals['valid_sum']}/"
           f"{totals['valid_count']} invalid={totals['invalid_sum']}/"
           f"{totals['invalid_count']}")
    n_over = int(overlap["num_overlap_t"].sum())
    n_ins = int(overlap["num_insert_agent_t"].sum())
    log_fn(f"GridOverlapRate: {n_over / max(n_ins, 1):.4f} "
           f"(overlaps={n_over}, inserts={n_ins})")
    return totals, overlap
