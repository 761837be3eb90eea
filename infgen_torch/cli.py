"""Command line of the PyTorch port: the `rollout`, `stream`, `validate`,
`train`, `check-inputs` and `export` sub-commands.

  python -m infgen_torch.cli rollout --config configs/ours_long_term.yaml \
      --synthetic [--device cuda|cpu] [--force-insert] [--num-scenarios N] \
      [--batch B] [--params converted.npz] [--fused-block] \
      [--pallas-attention]

Scenarios come from `--data-dir D`, a directory of WOMD pickles written by
`python -m infgen_torch.data.preprocess --input-dir <tfrecords>
--output-dir D` (data/waymo.WaymoDataset: every mode; `train` trains on
them and validates on the same directory in eval mode), or, with
`--synthetic` or without a data directory, from the synthetic generator
(seeds 0, 1, ...), the JAX package's choice of source. Each mode takes the
first min(--num-scenarios, the dataset's size) scenarios; a data directory
that yields none is an error.

Weights come from `cfg.seed` through a torch.Generator, from a flax
params tree converted with `convert.save_npz` (`--params`), or from the
port's own checkpoint directory (`--ckpt-path D/ckpt` after `train
--save-dir D`; `rollout`, `stream` and `validate`). The command runs
`--num-scenarios` closed-loop rollouts and prints one
JSON summary line: one scenario after another, or with `--batch B` through
the occupancy-bucketed server (`rollout/serving.RolloutServer.
rollout_batch`, at most B lanes per batched rollout; the JAX package's
batched `rollout_many` on one card), whose summary adds the lanes of each
batch, ms per batched token step and agent-steps/s (active agents x token
steps / wall time). `--fused-block` and `--pallas-attention` turn on
`use_fused_block` / `use_pallas_attention` on the loaded config (the JAX
package's `scripts/profile_rollout.py --fused` and bench.py's
INFGEN_BENCH_FUSED / INFGEN_BENCH_PALLAS).

  python -m infgen_torch.cli train --synthetic | --data-dir D \
      [--config ...] [--pallas-attention] [--steps N] [--batch B] \
      [--device cuda|cpu] [--save-dir D] [--overfit] [--pretrain-ckpt P] \
      [--ckpt-path C]

trains from weights drawn from `cfg.seed` on WOMD scenarios (training
mode: train agents scored, perception clipped; validated open-loop on the
directory in eval mode) or synthetic ones (seeds 0,
1, ...; B per step, default the config's train_batch_size; `--overfit`
repeats the first batch for at least 100 epochs) for N steps
(train/loop.train: one JSON line of logs per step, a checkpoint in
D/ckpt with --save-dir, resumed from D/ckpt or C; `--pretrain-ckpt`
warm-starts the weights non-strictly; open-loop validation on the
held-out seeds [10000 - val_num_scenarios, 10000) every
val_every_n_epochs epochs, the best five in D/ckpt_best), then prints a
summary line: steps, the last loss, ms per step (median after two warm-up
steps) and each kernel's launches. Every YAML under configs/ trains,
`decoder_type: occ_decoder` through model/occ_decoder.py.

  python -m infgen_torch.cli validate --open-loop --synthetic \
      [--config ...] [--num-scenarios N] [--ckpt-path C | --params ...]
  python -m infgen_torch.cli check-inputs --synthetic [--config ...] \
      [--num-scenarios N]

`validate --open-loop` (or a config with val_open_loop) prints the
open-loop losses and top-1 token / state accuracy of N scenarios
(default 8; train/loop.validate_open_loop); `check-inputs` the state
accuracy and grid overlap of their tokenised ground truth
(train/loop.check_inputs).

  python -m infgen_torch.cli validate --synthetic [--config ...] \
      [--num-scenarios N] [--device cuda|cpu] [--save-dir D] \
      [--log-features total_features.npz] [--dump-rollouts] \
      [--plot-rollouts] [--params ...]

rolls out N scenarios (n_rollout_close_val rollouts each, as
lanes of one batched rollout) and scores them with the WOSAC metrics
(`run_validate`): the logged features of the scenario set (or of
--log-features) make the histograms, each rollout's features are scored
against them on the device, and the aggregated realism metametric, its
buckets and the validation metrics go to D/rollout_metrics.json and three
printed lines. `rollout --save-dir D` scores its rollouts the same way
after its timed window and adds the metametric to its summary line.
`--plot-rollouts` draws each scenario's first rollout into D/vis; the
environment variable PLOT_EDGE_INFERENCE plots its agent-agent masks
(PLOT_EDGE_DIR, default D/edge_maps), and PLOT_EDGE the tokenised ground
truth's masks under `check-inputs` (default runs/edge_maps). These need
matplotlib: without it they are refused before anything runs.

  python -m infgen_torch.cli stream --synthetic [--config ...] \
      [--total-steps 900] [--segment-steps R] [--fused-stream] \
      [--num-scenarios N] [--device cuda|cpu] [--save-dir D] [--params ...] \
      [--fused-block] [--pallas-attention]

simulates `--total-steps` future 10 Hz frames of each scenario (rounded up
to whole segments of R frames, default num_recurrent_steps_val) through
`rollout/streaming.py` (`run_stream`): the host loop re-buckets each
segment through RolloutServer (agent buckets 32, 64 and max_agents) and
recycles the slots of agents that exited; `--fused-stream` runs every
segment at full capacity with the continuation on the device. Each
scenario's stitched registry goes to D/stream_{i:06d}.npz (default
runs/default), then one JSON summary line: ms per segment and per token
step, agents ever alive, buckets per segment, host reads, agent-steps/s and
each kernel's launches.

  python -m infgen_torch.cli export --synthetic | --data-dir D \
      [--config ...] [--device cuda|cpu] [--out F] [--save-dir D] \
      [--ckpt-path C | --params ...] [--num-recurrent-steps R] \
      [--force-insert] [--fused-block] [--pallas-attention]

exports the rollout at the config's (A, P) capacity for deployment without
the model code (`run_export`, rollout/export.py): its template is one
synthetic scenario or the data directory's first, its weights the
config's seed's, --params' or --ckpt-path's; the artifact (F, default
D/rollout_a{A}.pt2, D runs/default) runs on the device it was exported on
and takes any state dict of the same architecture. It prints one JSON
line: artifact, bytes, max_agents, max_map_tokens.
"""

import argparse
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from infgen_torch.config import INVALID_STATE, SHIFT, Config, load_config
from infgen_torch.convert import load_flax_params, load_npz
from infgen_torch.data.features import build_model_inputs
from infgen_torch.data.scenario import stack_scenarios, to_device
from infgen_torch.data.waymo import make_dataset
from infgen_torch.metrics import train_metrics as TM
from infgen_torch.metrics.features import concat_features
from infgen_torch.metrics.map_distance import packed_road_edges
from infgen_torch.metrics.offline import (
    _device_tensor,
    _load_features,
    log_features,
    rollout_features,
    save_rollout_dump,
)
from infgen_torch.metrics.wosac import (
    WosacConfig,
    aggregate_scenario_metrics,
    compute_scenario_metrics,
    make_log_distributions,
    metrics_to_host,
)
from infgen_torch.model.infgen import InfGenModel
from infgen_torch.model.layers import init_params
from infgen_torch.ops import column_kernel as CK
from infgen_torch.ops import fused_block as FB
from infgen_torch.ops import pallas_attention as PA
from infgen_torch.ops import refine_kernel as RFK
from infgen_torch.ops import seed_kernel as SKN
from infgen_torch.rollout.closed_loop import make_rollout_fn
from infgen_torch.rollout.serving import RolloutServer
from infgen_torch.rollout.streaming import (StreamingRollout, make_stream_fn,
                                            seed_of, stitch_stream_outputs)
from infgen_torch.tokenizers.attr_tokenizer import AttrTokenizer
from infgen_torch.tokenizers.motion_tokenizer import MotionTokenizer
from infgen_torch.tokenizers.vocab import load_map_vocab
from infgen_torch.train.checkpoint import CheckpointManager
from infgen_torch.utils.device import resolve_device


# every hand-written kernel of the port, by name: each wrapper counts its
# launches in `.launches`
KERNELS = {"seed_eval": SKN.seed_eval_kernel,
           "seed_eval_full": SKN.seed_eval_full_kernel,
           "refine": RFK.refine_kernel,
           "motion_column": CK.motion_column_kernel,
           "fused_attention_block": FB.fused_attention_block,
           "r_biased_attention": PA.r_biased_attention}


def kernel_launches():
    """{kernel name: launches so far}."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def add_variant_flags(p: argparse.ArgumentParser):
    """The rollout variants' flags, shared with trace_rollout."""
    p.add_argument("--fused-block", action="store_true",
                   help="use_fused_block=True: each trunk sublayer as one "
                        "fused_attention_block kernel")
    p.add_argument("--pallas-attention", action="store_true",
                   help="use_pallas_attention=True: eligible attention "
                        "through the r_biased_attention kernel")


def apply_variant_flags(cfg: Config, args) -> Config:
    if args.fused_block:
        cfg = cfg.replace(use_fused_block=True)
    if args.pallas_attention:
        cfg = cfg.replace(use_pallas_attention=True)
    return cfg


def build_tokenizers(cfg: Config):
    """(AttrTokenizer, MotionTokenizer, map vocab) for `cfg`."""
    attr = AttrTokenizer(cfg.grid_range, cfg.grid_interval,
                         cfg.pl2seed_radius, cfg.angle_interval)
    return attr, MotionTokenizer(), load_map_vocab()


def build_model(cfg: Config, attr: AttrTokenizer, device,
                params: Optional[str] = None,
                ckpt_path: Optional[str] = None) -> InfGenModel:
    """InfGenModel on `device`: weights from a converted .npz when `params`
    is given, from the port's own latest checkpoint in the directory
    `ckpt_path` (load_checkpoint_weights), else drawn from `cfg.seed` (on
    the CPU, so one seed gives the same weights on every device)."""
    if params and ckpt_path:
        raise ValueError("weights from --params or --ckpt-path, not both")
    model = InfGenModel(cfg, attr.grid, attr.grid_size, attr.angle_size)
    if params:
        load_flax_params(model, load_npz(params))
    elif ckpt_path:
        load_checkpoint_weights(model, ckpt_path)
    else:
        init_params(model, torch.Generator().manual_seed(cfg.seed))
    return model.to(device).eval()


def load_checkpoint_weights(model: torch.nn.Module, ckpt_path: str) -> int:
    """Load the model entries of the latest checkpoint that `cli train`
    (train/loop.train) wrote in the directory `ckpt_path` (its
    save_dir/ckpt) into `model`, strictly, cast to the model's dtype.
    Returns the checkpoint's step."""
    if not os.path.isdir(ckpt_path):
        raise FileNotFoundError(f"no checkpoint directory {ckpt_path}")
    raw = CheckpointManager(ckpt_path).restore_raw()
    if raw is None:
        raise FileNotFoundError(f"no step_*.pt checkpoint in {ckpt_path}")
    model.load_state_dict(raw["model"])
    return raw["step"]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_export(cfg: Config, device, out: Optional[str] = None,
               save_dir: Optional[str] = None,
               params: Optional[str] = None,
               num_recurrent_steps: Optional[int] = None,
               force_insert: bool = False, model=None, tokenizers=None,
               dataset=None) -> dict:
    """Export the rollout (rollout/export.export_rollout) at `cfg`'s
    capacity on `device`, the first scenario of `dataset` (default the
    synthetic seed 0) as its template and the model's weights (built from
    `params` or the config's seed unless given) as its template state
    dict, to `out` (default save_dir/rollout_a{A}.pt2). Returns the
    printed summary."""
    from infgen_torch.rollout.export import (export_rollout,
                                             save_rollout_artifact)
    device = resolve_device(device)
    tokenizers = tokenizers or build_tokenizers(cfg)
    attr, motion_tok, map_vocab = tokenizers
    model = model or build_model(cfg, attr, device, params)
    dataset = dataset or make_dataset(cfg, None, 1)
    scenario = to_device(dataset[0], device)
    inputs = build_model_inputs(
        cfg, motion_tok, attr, scenario,
        torch.Generator(device=device).manual_seed(cfg.seed))
    blob = export_rollout(cfg, attr, motion_tok, map_vocab, scenario, inputs,
                          torch.Generator(device=device), model.state_dict(),
                          num_recurrent_steps, force_insert)
    out = out or os.path.join(save_dir or "runs/default",
                              f"rollout_a{cfg.max_agents}.pt2")
    save_rollout_artifact(out, blob)
    return {"artifact": out, "bytes": len(blob),
            "max_agents": cfg.max_agents,
            "max_map_tokens": cfg.max_map_tokens}


def run_rollouts(cfg: Config, device=None, num_scenarios: int = 1,
                 force_insert: bool = False, params: Optional[str] = None,
                 num_recurrent_steps: Optional[int] = None, model=None,
                 tokenizers=None, dataset=None):
    """Closed-loop rollouts of the first `num_scenarios` scenarios of
    `dataset` (default: synthetic seeds 0, 1, ...). Returns (outputs,
    summary): the rollout dicts and one summary of wall time per token
    step, inserted agents, the launches of every kernel (`kernel_launches`,
    by name; `seed_kernel_launches` sums the two seed-evaluation kernels)
    and host reads. `model` / `tokenizers` reuse built ones."""
    device = resolve_device(device)
    attr, motion_tok, map_vocab = tokenizers or build_tokenizers(cfg)
    model = model or build_model(cfg, attr, device, params)
    rollout = make_rollout_fn(model, cfg, attr, motion_tok, map_vocab,
                              num_recurrent_steps=num_recurrent_steps,
                              force_insert=force_insert)
    R = num_recurrent_steps or cfg.num_recurrent_steps_val
    n_steps = R // SHIFT
    if dataset is None:
        dataset = make_dataset(cfg, num_scenarios=num_scenarios)
    num_scenarios = min(num_scenarios, len(dataset))
    launches0 = kernel_launches()
    outputs, ms_per_step, inserted, host_reads = [], [], [], 0
    for i in range(num_scenarios):
        scenario = to_device(dataset[i], device)
        gen = torch.Generator(device=device).manual_seed(cfg.seed + i)
        inputs = build_model_inputs(cfg, motion_tok, attr, scenario, gen)
        _sync(device)
        t0 = time.perf_counter()
        out = rollout(scenario, inputs, gen)
        _sync(device)
        ms_per_step.append((time.perf_counter() - t0) * 1e3 / n_steps)
        inserted.append(int(out["n_inserted"]))
        host_reads += rollout.host_reads
        outputs.append(out)
    summary = dict(
        _summary_head(cfg, device, num_scenarios, n_steps, force_insert),
        ms_per_token_step=ms_per_step,
        agents_inserted=inserted,
        **_launch_counts(launches0),
        host_reads=host_reads,
    )
    return outputs, summary


def _summary_head(cfg: Config, device, num_scenarios, n_steps, force_insert):
    return dict(
        device=str(device),
        device_name=(torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
        compute_dtype=cfg.compute_dtype,
        scenarios=num_scenarios,
        token_steps=n_steps,
        force_insert=force_insert)


def _launch_counts(launches0):
    """Each kernel's launches since `launches0`, and the two seed-evaluation
    kernels' sum."""
    launches = {k: n - launches0[k] for k, n in kernel_launches().items()}
    return dict(kernel_launches=launches,
                seed_kernel_launches=(launches["seed_eval"]
                                      + launches["seed_eval_full"]))


def run_batched(cfg: Config, device=None, num_scenarios: int = 1,
                batch: int = 1, force_insert: bool = False,
                params: Optional[str] = None,
                num_recurrent_steps: Optional[int] = None, model=None,
                tokenizers=None, agent_buckets=(32, 64, 128), dataset=None):
    """The first `num_scenarios` scenarios of `dataset` (default: synthetic
    seeds 0, 1, ...) through RolloutServer.rollout_batch with at most
    `batch` lanes per batched rollout. Returns (outputs, summary): one
    rollout dict per scenario and a summary of the dispatch (bucket, lanes
    and real scenarios of each batch), wall time, ms per batched token
    step, agent-steps and agent-steps/s (also per agent bucket, from the
    server's per-batch times: `by_bucket`), inserted agents, kernel
    launches and host reads."""
    device = resolve_device(device)
    attr, motion_tok, map_vocab = tokenizers or build_tokenizers(cfg)
    model = model or build_model(cfg, attr, device, params)
    server = RolloutServer(cfg, attr, motion_tok, map_vocab,
                           agent_buckets=agent_buckets,
                           num_recurrent_steps=num_recurrent_steps,
                           force_insert=force_insert)
    R = num_recurrent_steps or cfg.num_recurrent_steps_val
    n_steps = R // SHIFT
    if dataset is None:
        dataset = make_dataset(cfg, num_scenarios=num_scenarios)
    num_scenarios = min(num_scenarios, len(dataset))
    scenarios = [dataset[i] for i in range(num_scenarios)]
    launches0 = kernel_launches()
    _sync(device)
    t0 = time.perf_counter()
    outputs = server.rollout_batch(model, scenarios, cfg.seed,
                                   max_batch=batch)
    _sync(device)
    wall_ms = (time.perf_counter() - t0) * 1e3
    dispatch = server.last_dispatch
    batches = dispatch["batches"]
    by_bucket = {}
    for (A, _, _, k), ms, steps in zip(batches, dispatch["batch_ms"],
                                       dispatch["batch_agent_steps"]):
        b = by_bucket.setdefault(A, dict(scenarios=0, wall_ms=0.0,
                                         agent_steps=0.0))
        b["scenarios"] += k
        b["wall_ms"] += ms
        b["agent_steps"] += steps
    for b in by_bucket.values():
        b["agent_steps_per_s"] = b["agent_steps"] / (b["wall_ms"] / 1e3)
    steps = sum(dispatch["batch_agent_steps"])
    summary = dict(
        _summary_head(cfg, device, num_scenarios, n_steps, force_insert),
        batch=batch,
        batches=[dict(A=a, P=p, lanes=b, scenarios=k)
                 for a, p, b, k in batches],
        wall_ms=wall_ms,
        ms_per_batched_token_step=wall_ms / (len(batches) * n_steps),
        agent_steps=steps,
        agent_steps_per_s=steps / (wall_ms / 1e3),
        by_bucket=by_bucket,
        agents_inserted=[int(o["n_inserted"]) for o in outputs],
        **_launch_counts(launches0),
        host_reads=dispatch["host_reads"],
    )
    return outputs, summary


class _ValOffset:
    """The last `k` items of a dataset: held-out synthetic seeds [size - k,
    size) for the validation during training (training takes seeds 0, 1,
    ...)."""

    def __init__(self, dataset, k: int):
        self._dataset = dataset
        self._base = len(dataset) - k
        self._k = k

    def __len__(self):
        return self._k

    def __getitem__(self, i: int):
        return self._dataset[self._base + i]


def run_train(cfg: Config, device=None, steps: int = 8,
              batch: Optional[int] = None, save_dir: Optional[str] = None,
              log_fn=print, overfit: bool = False,
              pretrain_ckpt: Optional[str] = None,
              ckpt_path: Optional[str] = None,
              data_dir: Optional[str] = None):
    """`steps` training steps (train/loop.train), `batch` scenarios per
    step, on the WOMD pickles under `data_dir` in training mode, validated
    open-loop on the same directory in eval mode, or without `data_dir` on
    synthetic scenarios (seeds 0, 1, ...), validated on the held-out seeds
    [10000 - val_num_scenarios, 10000); validation every
    val_every_n_epochs epochs. With `overfit` the first batch, repeated,
    for at least 100 epochs; `pretrain_ckpt` warm-starts the weights,
    `ckpt_path` is the checkpoint directory to resume from. Returns
    (trainer, summary)."""
    from infgen_torch.train.loop import OverfitDataset, SyntheticDataset, train

    device = resolve_device(device)
    if batch:
        cfg = cfg.replace(train_batch_size=batch)
    B = max(cfg.train_batch_size, 1)
    dataset = make_dataset(cfg, data_dir, B if overfit else B * steps,
                           training=True)
    if overfit:
        dataset = OverfitDataset(dataset, B)
        cfg = cfg.replace(max_epochs=max(cfg.max_epochs, 100))
    if cfg.val_every_n_epochs <= 0:
        val = None
    elif data_dir:
        from infgen_torch.data.waymo import WaymoDataset

        # the JAX package catches any exception here; only "no scenario
        # there" means "no validation"
        val = WaymoDataset(data_dir, cfg, training=False)
        val = val if len(val) else None
    else:
        val = _ValOffset(SyntheticDataset(cfg, size=10_000),
                         cfg.val_num_scenarios)
    launches0 = kernel_launches()
    backward0 = PA.r_biased_attention_trainable.backward_calls
    trainer, history = train(cfg, dataset, save_dir, max_steps=steps,
                             device=device, log_fn=log_fn,
                             pretrain_ckpt=pretrain_ckpt, val_dataset=val,
                             ckpt_path=ckpt_path)
    ms = sorted(h["ms"] for h in history[2:] or history)
    summary = dict(
        device=str(device),
        device_name=(torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
        decoder_type=cfg.decoder_type,
        compute_dtype=cfg.compute_dtype, param_dtype=cfg.param_dtype,
        use_pallas_attention=cfg.use_pallas_attention,
        steps=len(history), batch=B, overfit=overfit,
        first_loss=history[0]["loss"], last_loss=history[-1]["loss"],
        ms_per_step=ms[len(ms) // 2],
        **_launch_counts(launches0),
        rba_backward_calls=(PA.r_biased_attention_trainable.backward_calls
                            - backward0))
    return trainer, summary


def run_validate_open_loop(cfg: Config, device=None, num_scenarios: int = 8,
                           params: Optional[str] = None,
                           ckpt_path: Optional[str] = None, log_fn=print,
                           dataset=None):
    """Open-loop validation (train/loop.validate_open_loop) of the weights
    from cfg.seed, a converted .npz (`params`) or the port's checkpoint
    (`ckpt_path`) on the first `num_scenarios` scenarios of `dataset`
    (default: synthetic seeds 0, 1, ...). Returns a summary: its results,
    ms per scenario (host clock to the read) and each kernel's launches."""
    from infgen_torch.train.loop import validate_open_loop
    from infgen_torch.train.train_step import Trainer

    if params and ckpt_path:
        raise ValueError("weights from --params or --ckpt-path, not both")
    trainer = Trainer(cfg, device)
    trainer.init_state()
    if params:
        load_flax_params(trainer.model, load_npz(params))
    elif ckpt_path:
        load_checkpoint_weights(trainer.model, ckpt_path)
    if dataset is None:
        dataset = make_dataset(cfg, num_scenarios=num_scenarios)
    n = min(num_scenarios, len(dataset))
    launches0 = kernel_launches()
    _sync(trainer.device)
    t0 = time.perf_counter()
    out = validate_open_loop(trainer, dataset, n, log_fn)
    ms = (time.perf_counter() - t0) * 1e3
    return dict(_summary_head(cfg, trainer.device, n, 0, False),
                open_loop=out, ms_per_scenario=ms / n,
                **_launch_counts(launches0))


def run_check_inputs(cfg: Config, device=None, num_scenarios: int = 8,
                     log_fn=print, dataset=None):
    """check_inputs (train/loop.py) on the first `num_scenarios` scenarios
    of `dataset` (default: synthetic seeds 0, 1, ...); returns a summary of
    its counts."""
    from infgen_torch.train.loop import check_inputs

    device = resolve_device(device)
    if dataset is None:
        dataset = make_dataset(cfg, num_scenarios=num_scenarios)
    num_scenarios = min(num_scenarios, len(dataset))
    totals, overlap = check_inputs(cfg, dataset, num_scenarios, log_fn,
                                   device)
    return dict(device=str(device), scenarios=num_scenarios,
                state_accuracy=totals,
                grid_overlap={k: int(v.sum()) for k, v in overlap.items()})


def run_stream(cfg: Config, device=None, num_scenarios: int = 1,
               total_steps: int = 900, segment_steps: Optional[int] = None,
               fused: bool = False, params: Optional[str] = None,
               save_dir: Optional[str] = None, model=None, tokenizers=None,
               dataset=None):
    """Stream the first `num_scenarios` scenarios of `dataset` (default:
    synthetic seeds 0, 1, ...; stream seed `seed_of(cfg.seed, i)`) for
    `total_steps` future 10 Hz frames in
    segments of `segment_steps` (default num_recurrent_steps_val): through
    StreamingRollout over a RolloutServer with agent buckets 32, 64 and
    cfg.max_agents (the JAX package's `cli stream`), or with `fused`
    through make_stream_fn at full capacity, stitched on the host. With
    `save_dir` each scenario's registry goes to stream_{i:06d}.npz (the
    JAX package's keys). Returns (results, summary): the stitched dicts and
    ms per segment and per token step (host clock around each stream,
    stitching included, ending in a synchronise), agents ever alive,
    buckets, alive and inserted agents per segment, host reads,
    agent-steps (non-invalid 10 Hz states after the history, as the JAX
    bench counts a stream's) and agent-steps/s, and each kernel's
    launches."""
    device = resolve_device(device)
    attr, mt, mv = tokenizers or build_tokenizers(cfg)
    model = model or build_model(cfg, attr, device, params)
    R = segment_steps or cfg.num_recurrent_steps_val
    n_seg = -(-total_steps // R)
    Hs = cfg.num_historical_steps
    if fused:
        stream_fn = make_stream_fn(model, cfg, attr, mt, mv, R, n_seg)
    else:
        streamer = StreamingRollout(RolloutServer(
            cfg, attr, mt, mv, num_recurrent_steps=R,
            agent_buckets=(32, 64, cfg.max_agents)), R)
    if dataset is None:
        dataset = make_dataset(cfg, num_scenarios=num_scenarios)
    num_scenarios = min(num_scenarios, len(dataset))
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
    launches0 = kernel_launches()
    results, wall_ms, host_reads = [], [], 0
    for i in range(num_scenarios):
        seed = seed_of(cfg.seed, i)
        _sync(device)
        t0 = time.perf_counter()
        if fused:
            res = stitch_stream_outputs(stream_fn(dataset[i], seed), Hs)
            host_reads += stream_fn.host_reads
        else:
            res = streamer.run(model, dataset[i], seed, total_steps)
            host_reads += streamer.host_reads
        _sync(device)
        wall_ms.append((time.perf_counter() - t0) * 1e3)
        results.append(res)
        if save_dir:
            np.savez_compressed(
                os.path.join(save_dir, f"stream_{i:06d}.npz"),
                av_gid=np.int64(res["av_gid"]),
                frames_per_segment=np.asarray(res["frames_per_segment"],
                                              np.int64),
                segment_buckets=np.asarray(
                    [s["bucket"] for s in res["segments"]], np.int64),
                **{k: v for k, v in res.items()
                   if isinstance(v, np.ndarray)})
    steps = [float((r["state"][:, Hs:] != INVALID_STATE).sum())
             for r in results]
    summary = dict(
        _summary_head(cfg, device, num_scenarios, n_seg * R // SHIFT, False),
        fused=fused, segment_steps=R, segments=n_seg,
        frames=[int(r["state"].shape[1]) for r in results],
        wall_ms=wall_ms,
        ms_per_segment=[w / n_seg for w in wall_ms],
        ms_per_token_step=[w / (n_seg * R // SHIFT) for w in wall_ms],
        agents_ever_alive=[int(r["state"].shape[0]) for r in results],
        buckets=[[s["bucket"] for s in r["segments"]] for r in results],
        alive_per_segment=[[s["n_alive"] for s in r["segments"]]
                           for r in results],
        inserted_per_segment=[[s["n_inserted"] for s in r["segments"]]
                              for r in results],
        agent_steps=sum(steps),
        agent_steps_per_s=sum(steps) / (sum(wall_ms) / 1e3),
        **_launch_counts(launches0),
        host_reads=host_reads)
    return results, summary


def _val_metrics(cfg: Config, grid_size: int, scen, inputs, out):
    """The validation metric set of one rollout against its log: minADE /
    minFDE over the logged future window, state accuracy, grid overlap and
    insertion-count error, as (sum, count) tensors on the device."""
    Hs = cfg.num_historical_steps
    ag = scen.agents
    eval_mask = out["slot_active"] & ag.valid[:, Hs - 1]
    To = min(ag.position.shape[1] - Hs, out["pred_traj"].shape[1] - Hs)
    gt = ag.position[:, Hs:Hs + To, :2]
    pred = out["pred_traj"][:, Hs:Hs + To]
    vm = ag.valid[:, Hs:Hs + To] & eval_mask[:, None]
    sa = TM.state_accuracy(out["next_state_idx"])
    go = TM.grid_overlap_rate(out["next_state_idx"], out["grid_index"],
                              grid_size, cfg.num_seed_feature)
    Tg = min(inputs.tokens.state_idx.shape[1],
             out["next_state_idx"].shape[1])
    return {
        "min_ade": TM.min_ade(pred, gt, vm),
        "min_fde": TM.min_fde(pred, gt, vm),
        "state_acc_valid": (sa["valid_sum"], sa["valid_count"]),
        "state_acc_invalid": (sa["invalid_sum"], sa["invalid_count"]),
        "grid_overlap": (go["num_overlap_t"].sum(),
                         go["num_insert_agent_t"].sum()),
        "num_insert_err": TM.num_insert_accuracy(
            out["next_state_idx"][:, :Tg], inputs.tokens.state_idx[:, :Tg]),
    }


def _multi_metrics(cfg: Config, scen, outs):
    """minADE / minFDE over a scenario's several rollouts."""
    Hs = cfg.num_historical_steps
    ag = scen.agents
    pred_k = torch.stack([o["pred_traj"] for o in outs], 1)  # [A, K, T, 2]
    eval_mask = ag.slot_mask & ag.valid[:, Hs - 1]
    To = min(ag.position.shape[1] - Hs, pred_k.shape[2] - Hs)
    gt = ag.position[:, Hs:Hs + To, :2]
    pk = pred_k[:, :, Hs:Hs + To]
    vm = ag.valid[:, Hs:Hs + To] & eval_mask[:, None]
    return {"min_multi_ade": TM.min_multi_ade(pk, gt, vm),
            "min_multi_fde": TM.min_multi_fde(pk, gt, vm)}


class Scorer:
    """WOSAC scoring of a scenario set's rollouts on one device.

    `log_feats` (MetricFeatures of the whole set, on the device) make the
    logged histograms once. `score` extracts one scenario's rollout
    features (several rollouts concatenated along the agent axis), scores
    them and adds its validation metrics, all on the device; only the
    per-scenario scalars and curves are read back. `finish` aggregates them
    and writes rollout_metrics.json. `keep=True` keeps each scenario's
    device features and metrics in `.kept` (the smoke's card-against-CPU
    check reads them)."""

    def __init__(self, cfg: Config, grid_size: int, log_feats,
                 log_fn=print, keep: bool = False):
        self.cfg, self.grid_size, self.log_fn = cfg, grid_size, log_fn
        self.wcfg = WosacConfig()
        self.log_feats = log_feats
        self.log_dist = make_log_distributions(self.wcfg, log_feats)
        self.rows, self.kept, self.keep = [], [], keep
        self.val_totals = {}
        self.ms_features, self.ms_scoring, self.peak_bytes = [], [], []

    def _acc(self, m):
        for k, (s, n) in m.items():
            ts, tn = self.val_totals.get(k, (0.0, 0.0))
            self.val_totals[k] = (ts + s.double(), tn + n.double())

    def score(self, i: int, scen, inputs, outs, road_edges=None,
              road_cyclic=None) -> dict:
        """Score scenario i's rollouts `outs` (one dict per rollout, tensors
        on the device); `scen` / `inputs` are its tensors there."""
        dev = outs[0]["pred_traj"].device
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        _sync(dev)
        t0 = time.perf_counter()
        sim = concat_features([rollout_features(o, road_edges, road_cyclic)
                               for o in outs])
        _sync(dev)
        t1 = time.perf_counter()
        m_dev = compute_scenario_metrics(self.wcfg, self.log_dist, sim)
        m = metrics_to_host(m_dev)
        t2 = time.perf_counter()
        self.ms_features.append((t1 - t0) * 1e3)
        self.ms_scoring.append((t2 - t1) * 1e3)
        if dev.type == "cuda":
            self.peak_bytes.append(torch.cuda.max_memory_allocated(dev))
        m["scenario"] = i
        m["n_inserted"] = int(outs[0]["n_inserted"])
        self._acc(_val_metrics(self.cfg, self.grid_size, scen, inputs,
                               outs[0]))
        if len(outs) > 1:
            self._acc(_multi_metrics(self.cfg, scen, outs))
        self.rows.append(m)
        if self.keep:
            self.kept.append(dict(index=i, features=sim, metrics=m_dev))
        self.log_fn(f"scenario {i}: metametric={m['metametric']:.4f} "
                    f"collision_rate={m['simulated_collision_rate']:.3f} "
                    f"offroad_rate={m['simulated_offroad_rate']:.3f} "
                    f"inserted={m['n_inserted']}")
        return m

    def finish(self, save_dir: Optional[str]):
        """Aggregate, write save_dir/rollout_metrics.json (the JAX
        package's schema: wosac, val_metrics, scenarios) and print the
        summary lines. Returns (wosac, val_metrics)."""
        keys = sorted(self.val_totals)
        if keys:
            host = torch.stack([torch.stack(self.val_totals[k])
                                for k in keys]).cpu().numpy()
        val = {k: (float(s / n) if n > 0 else 0.0)
               for k, (s, n) in zip(keys, host if keys else [])}
        wosac = aggregate_scenario_metrics(self.wcfg, self.rows)
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
            with open(os.path.join(save_dir, "rollout_metrics.json"),
                      "w") as f:
                json.dump({"wosac": wosac, "val_metrics": val,
                           "scenarios": self.rows}, f, indent=2)
        self.log_fn("val metrics: " + " ".join(
            f"{k}={v:.4f}" for k, v in sorted(val.items())))
        self.log_fn("wosac buckets: " + " ".join(
            f"{k.split('/')[1]}={wosac[k]:.4f}" for k in (
                "wosac/realism_meta_metric", "wosac/kinematic_metrics",
                "wosac/interactive_metrics", "wosac/map_based_metrics",
                "wosac/placement_based_metrics")))
        self.log_fn(f"realism metametric over {len(self.rows)} scenarios "
                    f"(split-aggregated log features): "
                    f"{wosac['wosac/realism_meta_metric']:.4f}")
        return wosac, val


def validation_inputs(cfg: Config, tokenizers, device, num_scenarios: int,
                      dataset=None):
    """The validation set, the first `num_scenarios` scenarios of
    `dataset` (default: synthetic seeds 0, 1, ...): per scenario its host
    arrays, its tensors on `device` and its model inputs (the map mask's
    draw from its own generator)."""
    attr, mt, _ = tokenizers
    if dataset is None:
        dataset = make_dataset(cfg, num_scenarios=num_scenarios)
    items = []
    for i in range(min(num_scenarios, len(dataset))):
        scen = dataset[i]
        s = to_device(scen, device)
        gen = torch.Generator(device=device).manual_seed(
            seed_of(cfg.seed + 1, 2 * i))
        items.append((scen, s, build_model_inputs(cfg, mt, attr, s, gen)))
    return items


def split_log_features(items):
    """The logged features of the whole validation set, concatenated along
    the agent axis on the device (road edges left out, as the JAX package's
    validation does)."""
    return concat_features([log_features(s, inputs)
                            for _, s, inputs in items])


def _road_edges(scen, device):
    """The scenario's packed road edges (host arrays, or Nones) and the
    same as tensors on `device`."""
    packed = packed_road_edges(scen.map)
    return packed, [_device_tensor(x, device) for x in packed]


def run_validate(cfg: Config, device=None, num_scenarios: int = 8,
                 save_dir: Optional[str] = "runs/default",
                 params: Optional[str] = None,
                 log_features_path: Optional[str] = None,
                 dump_rollouts: bool = False,
                 num_recurrent_steps: Optional[int] = None, model=None,
                 tokenizers=None, keep: bool = False, log_fn=print,
                 dataset=None, plot_rollouts: bool = False):
    """Closed-loop validation with WOSAC scoring (the JAX package's `cli
    validate`), on the card unless `device` says cpu.

    The logged features of the first `num_scenarios` scenarios of
    `dataset` (default: synthetic seeds 0, 1, ...; or of
    `log_features_path`, an aggregated .npz) make the histograms. Each
    scenario is rolled out `cfg.n_rollout_close_val` times, as lanes of one
    batched rollout with a generator each; the rollouts' features are
    concatenated along the agent axis and scored, on the device. With
    `dump_rollouts` each scenario's first rollout goes to
    save_dir/rollout_{i:06d}.npz for offline scoring, and a scenario whose
    dump exists is skipped (resume). With `plot_rollouts` each scenario's
    first rollout is drawn into save_dir/vis/scenario_{i:06d}_rollout.png;
    with the environment variable PLOT_EDGE_INFERENCE set, its agent-agent
    masks at columns 2, middle and last (visualization.a2a_inference_masks)
    into PLOT_EDGE_DIR (default save_dir/edge_maps). Either needs
    matplotlib and raises before any rollout without it.
    Returns (summary, scorer): the summary
    has ms per scenario of the rollout, of the feature extraction and of
    the scoring, the peak memory of each scoring on a card, the
    metametric, its buckets and every kernel's launches; the scorer holds
    the rows, and with `keep` (in `.kept`) each scenario's tensors,
    inputs, rollout outputs, road edges and device features and metrics.
    """
    device = resolve_device(device)
    plot_edges = bool(os.environ.get("PLOT_EDGE_INFERENCE"))
    if plot_rollouts or plot_edges:
        from infgen_torch.utils import visualization as VIS
        VIS.require_matplotlib()
    tokenizers = tokenizers or build_tokenizers(cfg)
    attr, mt, mv = tokenizers
    model = model or build_model(cfg, attr, device, params)
    n_roll = max(cfg.n_rollout_close_val, 1)
    rollout = make_rollout_fn(model, cfg, attr, mt, mv,
                              num_recurrent_steps=num_recurrent_steps)
    items = validation_inputs(cfg, tokenizers, device, num_scenarios, dataset)
    if log_features_path:
        log_feats = _load_features(log_features_path, device)
        log_fn(f"loaded aggregated log features from {log_features_path}")
    else:
        log_feats = split_log_features(items)
    scorer = Scorer(cfg, attr.grid_size, log_feats, log_fn, keep)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
    launches0 = kernel_launches()
    ms_rollout = []
    for i, (scen, s, inputs) in enumerate(items):
        dump = os.path.join(save_dir or ".", f"rollout_{i:06d}.npz")
        if dump_rollouts and os.path.exists(dump):
            continue
        gens = [torch.Generator(device=device).manual_seed(
            seed_of(cfg.seed + 1, 2 * i + 1, k)) for k in range(n_roll)]
        _sync(device)
        t0 = time.perf_counter()
        if n_roll == 1:
            outs = [rollout(s, inputs, gens[0])]
        else:
            # the scenario's rollouts as lanes of one batched rollout
            out = rollout(stack_scenarios([s] * n_roll),
                          stack_scenarios([inputs] * n_roll), gens)
            outs = [{k: v[j] for k, v in out.items()} for j in range(n_roll)]
        _sync(device)
        ms_rollout.append((time.perf_counter() - t0) * 1e3)
        packed, road = _road_edges(scen, device)
        if dump_rollouts:
            save_rollout_dump(dump, outs[0], *packed)
        if plot_rollouts or plot_edges:
            _plot_rollout(cfg, i, scen, outs[0], save_dir or ".",
                          plot_rollouts, plot_edges)
        scorer.score(i, s, inputs, outs, *road)
        if keep:
            scorer.kept[-1].update(scenario=s, inputs=inputs, outputs=outs,
                                   road_edges=road[0], road_cyclic=road[1])
    wosac, val = scorer.finish(save_dir)
    R = num_recurrent_steps or cfg.num_recurrent_steps_val
    summary = dict(
        _summary_head(cfg, device, len(items), R // SHIFT, False),
        n_rollouts=n_roll,
        scored=len(scorer.rows),
        ms_rollout=ms_rollout,
        ms_features=scorer.ms_features,
        ms_scoring=scorer.ms_scoring,
        scoring_peak_bytes=scorer.peak_bytes,
        realism_meta_metric=wosac["wosac/realism_meta_metric"],
        buckets={k.split("/")[1]: wosac[k] for k in wosac
                 if k.startswith("wosac/") and k.endswith("_metrics")},
        val_metrics=val,
        agents_inserted=[m["n_inserted"] for m in scorer.rows],
        **_launch_counts(launches0))
    return summary, scorer


def _plot_rollout(cfg: Config, i: int, scen, out, save_dir: str,
                  rollout: bool, edges: bool):
    """Scenario i's rollout drawn into save_dir/vis, and with `edges` its
    agent-agent masks rebuilt on the host into PLOT_EDGE_DIR (default
    save_dir/edge_maps)."""
    from infgen_torch.utils import visualization as VIS

    o = {k: out[k].cpu().numpy() for k in (
        "pred_traj", "pred_head", "pred_state", "pred_type", "av_index",
        "slot_active", "pos_a", "next_state_idx")}
    if rollout:
        VIS.plot_scenario_rollout(
            f"scenario_{i:06d}", np.asarray(scen.map.position),
            o["pred_traj"], o["pred_head"], o["pred_state"], o["pred_type"],
            int(o["av_index"]), os.path.join(save_dir, "vis"),
            slot_active=o["slot_active"])
    if edges:
        VIS.plot_attention_masks(
            f"rollout_{i:06d}", VIS.a2a_inference_masks(
                o["pos_a"], o["next_state_idx"], o["slot_active"],
                cfg.a2a_radius),
            os.environ.get("PLOT_EDGE_DIR",
                           os.path.join(save_dir, "edge_maps")))


def score_rollouts(cfg: Config, outputs, save_dir: str, device=None,
                   tokenizers=None, log_fn=print, dataset=None):
    """Score the rollouts of the first scenarios of `dataset` (default:
    synthetic seeds 0, 1, ...; `outputs`, one dict each, as run_rollouts
    returns them) against the set's logged features; writes
    save_dir/rollout_metrics.json. Returns the aggregated WOSAC dict."""
    device = resolve_device(device)
    tokenizers = tokenizers or build_tokenizers(cfg)
    items = validation_inputs(cfg, tokenizers, device, len(outputs), dataset)
    scorer = Scorer(cfg, tokenizers[0].grid_size, split_log_features(items),
                    log_fn)
    for i, ((scen, s, inputs), out) in enumerate(zip(items, outputs)):
        scorer.score(i, s, inputs, [out], *_road_edges(scen, device)[1])
    return scorer.finish(save_dir)[0]


def main(argv=None):
    p = argparse.ArgumentParser("infgen_torch")
    p.add_argument("mode", choices=["rollout", "stream", "validate",
                                    "train", "check-inputs", "export"])
    p.add_argument("--config", default="configs/ours_long_term.yaml",
                   help="YAML config path")
    p.add_argument("--synthetic", action="store_true",
                   help="use the synthetic scenario generator (also the "
                        "source when no --data-dir is given)")
    p.add_argument("--data-dir", default=None,
                   help="directory of preprocessed WOMD pickles "
                        "(python -m infgen_torch.data.preprocess)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; no fallback between them")
    p.add_argument("--force-insert", action="store_true",
                   help="every insertion iteration proposes an agent")
    p.add_argument("--out", default=None,
                   help="export: the artifact's path (default "
                        "<save-dir>/rollout_a<max_agents>.pt2)")
    p.add_argument("--num-scenarios", type=int, default=None,
                   help="scenarios to roll out, stream or validate (default "
                        "1; check-inputs and validate --open-loop: 8)")
    p.add_argument("--batch", type=int, default=None,
                   help="rollout: serve the scenarios through RolloutServer."
                        "rollout_batch, at most this many lanes per batch; "
                        "train: scenarios per step")
    p.add_argument("--steps", type=int, default=8,
                   help="train: optimizer steps")
    p.add_argument("--save-dir", default=None,
                   help="train: checkpoint directory (resumes from it); "
                        "validate: where rollout_metrics.json and the dumps "
                        "go (default runs/default); rollout: score the "
                        "rollouts and write rollout_metrics.json there; "
                        "stream: where the stream_*.npz go (default "
                        "runs/default)")
    p.add_argument("--total-steps", type=int, default=900,
                   help="stream: future 10 Hz frames to simulate")
    p.add_argument("--segment-steps", type=int, default=None,
                   help="stream: frames per segment (default "
                        "num_recurrent_steps_val)")
    p.add_argument("--fused-stream", action="store_true",
                   help="stream: every segment at full capacity with the "
                        "continuation on the device (no re-bucketing)")
    p.add_argument("--log-features", default=None,
                   help="validate: aggregated log features (.npz from "
                        "metrics.offline --aggregate-log) instead of the "
                        "scenario set's own")
    p.add_argument("--dump-rollouts", action="store_true",
                   help="validate: write each scenario's rollout for "
                        "offline scoring (skips scenarios already dumped)")
    p.add_argument("--plot-rollouts", action="store_true",
                   help="validate: draw each scenario's first rollout into "
                        "<save-dir>/vis (needs matplotlib)")
    p.add_argument("--num-recurrent-steps", type=int, default=None,
                   help="10 Hz frames to roll out (default from the config)")
    p.add_argument("--params", default=None,
                   help="converted flax params (.npz from convert.save_npz)")
    p.add_argument("--ckpt-path", default=None,
                   help="the port's own checkpoint directory (cli train's "
                        "<save-dir>/ckpt; its latest step_*.pt): the weights "
                        "of rollout, stream and validate; train resumes "
                        "from it")
    p.add_argument("--pretrain-ckpt", default=None,
                   help="train: warm-start the weights from this checkpoint "
                        "directory, non-strictly (entries missing or of "
                        "another shape keep their init)")
    p.add_argument("--overfit", action="store_true",
                   help="train: one batch, repeated, for at least 100 "
                        "epochs (the reference's OVERFIT debug mode)")
    p.add_argument("--open-loop", action="store_true",
                   help="validate: open-loop losses and token / state "
                        "accuracy instead of scored rollouts (also when the "
                        "config sets val_open_loop)")
    add_variant_flags(p)
    args = p.parse_args(argv)
    # the JAX package's choice of source: synthetic unless a data
    # directory is given without --synthetic
    data_dir = None if args.synthetic else args.data_dir
    if args.mode == "rollout" and args.batch and args.save_dir:
        p.error("--save-dir scores one-lane rollouts: served rollouts come "
                "back repadded to their bucket and compacted; drop --batch")
    if args.params and args.ckpt_path:
        p.error("give --params or --ckpt-path, not both")
    plots = [what for what, on in (
        ("--plot-rollouts", args.plot_rollouts),
        ("PLOT_EDGE", args.mode == "check-inputs"
         and os.environ.get("PLOT_EDGE")),
        ("PLOT_EDGE_INFERENCE", args.mode == "validate"
         and os.environ.get("PLOT_EDGE_INFERENCE"))) if on]
    if plots:
        from infgen_torch.utils.visualization import require_matplotlib
        try:
            require_matplotlib()
        except RuntimeError as e:
            p.error(f"{' and '.join(plots)}: {e}")
    cfg = apply_variant_flags(load_config(args.config), args)
    open_loop = args.mode == "validate" and (args.open_loop
                                             or cfg.val_open_loop)
    if args.mode == "check-inputs" or open_loop:
        n = args.num_scenarios or 8
        dataset = make_dataset(cfg, data_dir, n)
        summary = (run_check_inputs(cfg, args.device, n, dataset=dataset)
                   if not open_loop
                   else run_validate_open_loop(cfg, args.device, n,
                                               args.params, args.ckpt_path,
                                               dataset=dataset))
        print(json.dumps(summary))
        return
    n = args.num_scenarios or 1
    dataset = make_dataset(cfg, data_dir, n) if args.mode != "train" \
        else None
    model = tokenizers = None
    if args.ckpt_path and args.mode != "train":
        tokenizers = build_tokenizers(cfg)
        model = build_model(cfg, tokenizers[0], resolve_device(args.device),
                            ckpt_path=args.ckpt_path)
    if args.mode == "export":
        print(json.dumps(run_export(
            cfg, args.device, args.out, args.save_dir, args.params,
            args.num_recurrent_steps, args.force_insert, model, tokenizers,
            dataset)))
        return
    if args.mode == "validate":
        run_validate(cfg, args.device, n, args.save_dir or "runs/default",
                     args.params, args.log_features, args.dump_rollouts,
                     args.num_recurrent_steps, model, tokenizers,
                     dataset=dataset, plot_rollouts=args.plot_rollouts)
        return
    if args.mode == "stream":
        results, summary = run_stream(
            cfg, args.device, n, args.total_steps, args.segment_steps,
            args.fused_stream, args.params, args.save_dir or "runs/default",
            model, tokenizers, dataset=dataset)
        for i, r in enumerate(results):
            print(f"scenario {i}: {r['state'].shape[1]} frames "
                  f"({len(r['segments'])} segments), {r['state'].shape[0]} "
                  f"agents ever alive, buckets {summary['buckets'][i]}")
    elif args.mode == "train":
        _, summary = run_train(cfg, args.device, args.steps, args.batch,
                               args.save_dir, overfit=args.overfit,
                               pretrain_ckpt=args.pretrain_ckpt,
                               ckpt_path=args.ckpt_path, data_dir=data_dir)
    elif args.batch:
        outputs, summary = run_batched(
            cfg, args.device, n, args.batch, args.force_insert, args.params,
            args.num_recurrent_steps, model, tokenizers, dataset=dataset)
    else:
        outputs, summary = run_rollouts(
            cfg, args.device, n, args.force_insert, args.params,
            args.num_recurrent_steps, model, tokenizers, dataset=dataset)
    if args.mode == "rollout" and args.save_dir:
        # after the timed window
        wosac = score_rollouts(cfg, outputs, args.save_dir, args.device,
                               dataset=dataset)
        summary["realism_meta_metric"] = wosac["wosac/realism_meta_metric"]
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
