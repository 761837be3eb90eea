"""Learning dynamics of the port: train the flagship on synthetic scenarios,
scoring closed-loop rollouts with the WOSAC metametric and the simulated
collision rate before, during and after (the port's counterpart of
scripts/validate_learning.py).

    python -m infgen_torch.validate_learning [--steps 500] [--scenarios 8] \
        [--val-every 100] [--config configs/ours_long_term.yaml] \
        [--out LEARNING_DYNAMICS_TORCH.json] [--device cuda|cpu] [--seed S] \
        [--ckpt-dir D]

Scenarios are the synthetic generator's seeds 0 .. N-1 at 48 agents, their
model inputs built once. Each scenario's logged features make its own
histograms; the logs scored against them give the GT-replay ceiling, the
metametric a simulator that replays the logs would get. `score` rolls the
N scenarios out as the lanes of one batched rollout (a generator per lane,
seeded from a fixed key) and scores each lane against its scenario's
histograms. Training is Trainer.train_step on batches of two scenarios
(i, i + 1 mod N) for even i, cycled, each step's draws from a generator
seeded by the step; with --val-every K the model is scored every K steps.

The result goes to --out (default LEARNING_DYNAMICS_TORCH.json at the
repository's root; never the JAX package's LEARNING_DYNAMICS.json), with
the JAX script's keys plus the device, every step's loss, the median ms
per train step, the ms of each scoring, seed_eval's launches and the
seconds taken. It is rewritten after every curve point, so that a run cut
short keeps what it measured. --seed draws the initial weights from
another seed; --ckpt-dir D saves the trained state as the port's
checkpoint (`cli rollout|stream|validate --ckpt-path D`). Runs on the card
unless --device cpu.
"""

import argparse
import json
import os
import subprocess
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from infgen_torch.cli import _sync, kernel_launches
from infgen_torch.config import Config, load_config
from infgen_torch.data.features import build_model_inputs
from infgen_torch.data.scenario import stack_scenarios, to_device
from infgen_torch.data.synthetic import make_synthetic_scenario
from infgen_torch.metrics.offline import log_features, rollout_features
from infgen_torch.metrics.wosac import (WosacConfig,
                                        compute_scenario_metrics,
                                        make_log_distributions)
from infgen_torch.rollout.closed_loop import make_rollout_fn
from infgen_torch.rollout.streaming import seed_of
from infgen_torch.tokenizers.vocab import load_map_vocab
from infgen_torch.train.checkpoint import CheckpointManager
from infgen_torch.train.train_step import Trainer
from infgen_torch.utils.device import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(ROOT, "LEARNING_DYNAMICS_TORCH.json")
JAX_RECORD = "LEARNING_DYNAMICS.json"     # the JAX package's: never written
AGENTS = 48
# generator keys: the inputs' (the JAX script's PRNGKey(0) split per
# scenario), the scoring rollouts' (its PRNGKey(7) split per lane) and the
# train steps' (its host-side [1, step] key)
INPUT_KEY, ROLLOUT_KEY, STEP_KEY = 0, 7, 1
LOSS_EVERY = 100


def device_name(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or
    "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _means(metrics: List[Dict[str, torch.Tensor]]) -> Dict[str, float]:
    return dict(
        metametric=float(np.mean([float(m["metametric"]) for m in metrics])),
        collision_rate=float(np.mean(
            [float(m["simulated_collision_rate"]) for m in metrics])))


def score(trainer: Trainer, rollout, scens, inputs, log_dists, tag: str,
          log_fn: Callable[[str], None] = print) -> Dict[str, float]:
    """The trainer's model in eval mode, the scenarios (tensors on its
    device) rolled out as the lanes of one batched rollout, each lane's
    features scored against its scenario's histograms: the mean
    metametric and simulated collision rate, and the mean share of the
    active agents' future frames that are valid (`valid_share`: an agent
    the model removes collides with nothing)."""
    dev = trainer.device
    trainer.model.eval()
    gens = [torch.Generator(device=dev).manual_seed(seed_of(ROLLOUT_KEY, i))
            for i in range(len(scens))]
    out = rollout(stack_scenarios(scens), stack_scenarios(inputs), gens)
    # features and metrics one lane at a time: the [A, A, T] pair tensors
    # of every lane at once need not fit beside the rollout
    wcfg = WosacConfig()
    metrics, valid = [], []
    for i in range(len(scens)):
        f = rollout_features({k: v[i] for k, v in out.items()})
        metrics.append(compute_scenario_metrics(wcfg, log_dists[i], f))
        valid.append(float(f.valid.sum()) / max(
            float(out["slot_active"][i].sum()) * f.valid.shape[1], 1.0))
    res = dict(_means(metrics), valid_share=float(np.mean(valid)))
    log_fn(f"{tag}: metametric={res['metametric']:.4f} "
           f"collision_rate={res['collision_rate']:.3f} "
           f"valid_share={res['valid_share']:.3f}")
    return res


def _result(cfg: Config, steps: int, curve, gt, after, extra) -> dict:
    best = max(curve, key=lambda r: r["metametric"])
    gap = gt["metametric"] - best["metametric"]
    return dict(
        steps=steps, compute_dtype=cfg.compute_dtype,
        before={k: v for k, v in curve[0].items()
                if k not in ("step", "loss")},
        after=after, curve=curve,
        best=dict(step=best["step"], metametric=best["metametric"]),
        gt_replay_metametric=gt["metametric"],
        gt_replay_collision_rate=gt["collision_rate"],
        model_vs_ceiling_gap=gap,
        interpretation=(
            f"gt_replay_metametric is the score of the synthetic logs "
            f"against their own histograms: the ceiling any model can reach "
            f"on this data. Best model metametric {best['metametric']:.4f} "
            f"at step {best['step']} vs ceiling {gt['metametric']:.4f}: gap "
            f"{gap:+.4f}."),
        **extra)


def learning_dynamics(cfg: Config, device=None, steps: int = 500,
                      scenarios: int = 8, val_every: int = 0,
                      out: Optional[str] = DEFAULT_OUT,
                      log_fn: Callable[[str], None] = print, *,
                      agents: int = AGENTS, weights: Optional[dict] = None,
                      draws: Optional[Callable[[int], list]] = None,
                      ckpt_dir: Optional[str] = None) -> dict:
    """Train `cfg` (its total_steps set to `steps`) for `steps` steps on
    `scenarios` synthetic scenarios of `agents` agents, scored before,
    every `val_every` steps (0: never) and after; returns the result and,
    unless `out` is None, writes it there after every curve point.
    `weights` is a state dict to start from (default: the config's seed);
    `draws(step)` the random inputs of the step's scenarios
    (Trainer.train_step's `draws`; default: from the step's generator).
    With `ckpt_dir` the trained state is saved there as the port's
    checkpoint (step_{steps}.pt; `cli ... --ckpt-path ckpt_dir` reads
    it)."""
    t_start = time.perf_counter()
    if out is not None and os.path.basename(out) == JAX_RECORD:
        raise ValueError(f"{JAX_RECORD} is the JAX package's record")
    dev = resolve_device(device)
    cfg = cfg.replace(total_steps=steps)
    trainer = Trainer(cfg, dev)
    trainer.init_state()
    if weights is not None:
        trainer.model.load_state_dict(weights)
    host = [make_synthetic_scenario(cfg, seed=s, num_agents=agents)
            for s in range(scenarios)]
    scens = [to_device(s, dev) for s in host]
    inputs = [build_model_inputs(
        cfg, trainer.motion_tok, trainer.attr, s,
        torch.Generator(device=dev).manual_seed(seed_of(INPUT_KEY, i)))
        for i, s in enumerate(scens)]

    # each scenario's logged histograms, and the logs scored against them
    wcfg = WosacConfig()
    log_feats = [log_features(s, x) for s, x in zip(scens, inputs)]
    log_dists = [make_log_distributions(wcfg, f) for f in log_feats]
    gt = _means([compute_scenario_metrics(wcfg, d, f)
                 for d, f in zip(log_dists, log_feats)])
    log_fn(f"gt_replay ceiling: metametric={gt['metametric']:.4f} "
           f"collision_rate={gt['collision_rate']:.3f}")

    rollout = make_rollout_fn(trainer.model, cfg, trainer.attr,
                              trainer.motion_tok, load_map_vocab())
    name = device_name(dev)
    ms_scoring, scoring_launches, losses, ms_steps = [], [], [], []

    def scored(tag):
        _sync(dev)
        n0, t0 = kernel_launches()["seed_eval"], time.perf_counter()
        res = score(trainer, rollout, scens, inputs, log_dists, tag, log_fn)
        ms_scoring.append((time.perf_counter() - t0) * 1e3)
        scoring_launches.append(kernel_launches()["seed_eval"] - n0)
        return res

    def write(after=None):
        res = _result(cfg, steps, curve, gt, after, dict(
            device=name, steps_done=len(losses), losses=losses,
            ms_per_train_step=(float(np.median(ms_steps[1:] or ms_steps))
                               if ms_steps else None),
            ms_scoring=ms_scoring, seed_eval_launches=sum(scoring_launches),
            seconds=time.perf_counter() - t_start))
        if out is not None:
            with open(out, "w") as f:
                json.dump(res, f, indent=2)
        return res

    curve = [dict(step=0, loss=None, **scored("untrained"))]
    write()
    batches = [to_device(stack_scenarios(
        [host[i], host[(i + 1) % scenarios]]), dev)
        for i in range(0, scenarios, 2)]
    for step in range(steps):
        gen = torch.Generator(device=dev).manual_seed(seed_of(STEP_KEY, step))
        _sync(dev)
        t0 = time.perf_counter()
        logs = trainer.train_step(batches[step % len(batches)], gen,
                                  draws(step) if draws else None)
        losses.append(float(logs["loss"]))
        ms_steps.append((time.perf_counter() - t0) * 1e3)
        if step % LOSS_EVERY == 0:
            log_fn(f"step {step}: loss={losses[-1]:.3f}")
        if val_every and (step + 1) % val_every == 0 and step + 1 < steps:
            curve.append(dict(step=step + 1, loss=losses[-1],
                              **scored(f"val@{step + 1}")))
            write()
    if ckpt_dir:
        CheckpointManager(ckpt_dir).save(trainer.step, trainer)
    after = scored(f"trained({steps})")
    curve.append(dict(step=steps, loss=losses[-1] if losses else None,
                      **after))
    res = write(after)
    if out is not None:
        log_fn(f"wrote {os.path.abspath(out)}")
    return res


def main(argv=None):
    p = argparse.ArgumentParser("infgen_torch.validate_learning")
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--scenarios", type=int, default=8)
    p.add_argument("--val-every", type=int, default=100,
                   help="score every N steps (0: before and after only)")
    p.add_argument("--config", default=os.path.join(
        ROOT, "configs", "ours_long_term.yaml"))
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; no fallback between them")
    p.add_argument("--seed", type=int, default=None,
                   help="the initial weights' seed (default the config's)")
    p.add_argument("--ckpt-dir", default=None,
                   help="save the trained state there (the port's "
                        "checkpoint, read by --ckpt-path)")
    args = p.parse_args(argv)
    cfg = load_config(args.config)
    if args.seed is not None:
        cfg = cfg.replace(seed=args.seed)
    learning_dynamics(cfg, args.device, args.steps,
                      args.scenarios, args.val_every, args.out,
                      lambda msg: print(msg, flush=True),
                      ckpt_dir=args.ckpt_dir)


if __name__ == "__main__":
    main()
