"""Command line of the PyTorch port: the `rollout` and `train` sub-commands.

  python -m infgen_torch.cli rollout --config configs/ours_long_term.yaml \
      --synthetic [--device cuda|cpu] [--force-insert] [--num-scenarios N] \
      [--batch B] [--params converted.npz] [--fused-block] \
      [--pallas-attention]

Weights come from `cfg.seed` through a torch.Generator, or from a flax
params tree converted with `convert.save_npz`. The command runs
`--num-scenarios` closed-loop rollouts on synthetic scenarios and prints one
JSON summary line: one scenario after another, or with `--batch B` through
the occupancy-bucketed server (`rollout/serving.RolloutServer.
rollout_batch`, at most B lanes per batched rollout; the JAX package's
batched `rollout_many` on one card), whose summary adds the lanes of each
batch, ms per batched token step and agent-steps/s (active agents x token
steps / wall time). `--fused-block` and `--pallas-attention` turn on
`use_fused_block` / `use_pallas_attention` on the loaded config (the JAX
package's `scripts/profile_rollout.py --fused` and bench.py's
INFGEN_BENCH_FUSED / INFGEN_BENCH_PALLAS).

  python -m infgen_torch.cli train --synthetic [--config ...] \
      [--pallas-attention] [--steps N] [--batch B] [--device cuda|cpu] \
      [--save-dir D]

trains from weights drawn from `cfg.seed` on synthetic scenarios (seeds 0,
1, ...; B per step, default the config's train_batch_size) for N steps
(train/loop.train: one JSON line of logs per step, a checkpoint in
D/ckpt with --save-dir), then prints a summary line: steps, the last loss,
ms per step (median after two warm-up steps) and each kernel's launches.
WOSAC scoring and the Waymo loader belong to later slices of the port.
"""

import argparse
import json
import time
from typing import Optional

import torch

from infgen_torch.config import INVALID_STATE, SHIFT, Config, load_config
from infgen_torch.convert import load_flax_params, load_npz
from infgen_torch.data.features import build_model_inputs
from infgen_torch.data.scenario import to_device
from infgen_torch.data.synthetic import make_synthetic_scenario
from infgen_torch.model.infgen import InfGenModel
from infgen_torch.model.layers import init_params
from infgen_torch.ops import column_kernel as CK
from infgen_torch.ops import fused_block as FB
from infgen_torch.ops import pallas_attention as PA
from infgen_torch.ops import refine_kernel as RFK
from infgen_torch.ops import seed_kernel as SKN
from infgen_torch.rollout.closed_loop import make_rollout_fn
from infgen_torch.rollout.serving import RolloutServer
from infgen_torch.tokenizers.attr_tokenizer import AttrTokenizer
from infgen_torch.tokenizers.map_tokenizer import MapTokenizer
from infgen_torch.tokenizers.motion_tokenizer import MotionTokenizer
from infgen_torch.tokenizers.vocab import load_map_vocab
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
                params: Optional[str] = None) -> InfGenModel:
    """InfGenModel on `device`: weights from a converted .npz when `params`
    is given, else drawn from `cfg.seed` (on the CPU, so one seed gives the
    same weights on every device)."""
    model = InfGenModel(cfg, attr.grid, attr.grid_size, attr.angle_size)
    if params:
        load_flax_params(model, load_npz(params))
    else:
        init_params(model, torch.Generator().manual_seed(cfg.seed))
    return model.to(device).eval()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_rollouts(cfg: Config, device=None, num_scenarios: int = 1,
                 force_insert: bool = False, params: Optional[str] = None,
                 num_recurrent_steps: Optional[int] = None, model=None,
                 tokenizers=None):
    """Closed-loop rollouts of `num_scenarios` synthetic scenarios (seeds
    0, 1, ...). Returns (outputs, summary): the rollout dicts and one
    summary of wall time per token step, inserted agents, the launches of
    every kernel (`kernel_launches`, by name; `seed_kernel_launches` sums
    the two seed-evaluation kernels) and host reads. `model` / `tokenizers`
    reuse built ones."""
    device = resolve_device(device)
    attr, motion_tok, map_vocab = tokenizers or build_tokenizers(cfg)
    model = model or build_model(cfg, attr, device, params)
    rollout = make_rollout_fn(model, cfg, attr, motion_tok, map_vocab,
                              num_recurrent_steps=num_recurrent_steps,
                              force_insert=force_insert)
    R = num_recurrent_steps or cfg.num_recurrent_steps_val
    n_steps = R // SHIFT
    map_tok = MapTokenizer(map_vocab)
    launches0 = kernel_launches()
    outputs, ms_per_step, inserted, host_reads = [], [], [], 0
    for i in range(num_scenarios):
        scenario = to_device(make_synthetic_scenario(
            cfg, seed=i, map_tokenizer=map_tok), device)
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


def agent_steps(out, cfg: Config) -> float:
    """Active agents x token steps of one rollout: its non-invalid 10 Hz
    states after the history (as the JAX bench counts them), over SHIFT."""
    state = out["pred_state"][..., cfg.num_historical_steps:]
    return float((state != INVALID_STATE).sum()) / SHIFT


def run_batched(cfg: Config, device=None, num_scenarios: int = 1,
                batch: int = 1, force_insert: bool = False,
                params: Optional[str] = None,
                num_recurrent_steps: Optional[int] = None, model=None,
                tokenizers=None, agent_buckets=(32, 64, 128)):
    """The `num_scenarios` synthetic scenarios (seeds 0, 1, ...) through
    RolloutServer.rollout_batch with at most `batch` lanes per batched
    rollout. Returns (outputs, summary): one rollout dict per scenario and
    a summary of the dispatch (bucket, lanes and real scenarios of each
    batch), wall time, ms per batched token step, agent-steps and
    agent-steps/s, inserted agents, kernel launches and host reads."""
    device = resolve_device(device)
    attr, motion_tok, map_vocab = tokenizers or build_tokenizers(cfg)
    model = model or build_model(cfg, attr, device, params)
    server = RolloutServer(cfg, attr, motion_tok, map_vocab,
                           agent_buckets=agent_buckets,
                           num_recurrent_steps=num_recurrent_steps,
                           force_insert=force_insert)
    R = num_recurrent_steps or cfg.num_recurrent_steps_val
    n_steps = R // SHIFT
    map_tok = MapTokenizer(map_vocab)
    scenarios = [make_synthetic_scenario(cfg, seed=i, map_tokenizer=map_tok)
                 for i in range(num_scenarios)]
    launches0 = kernel_launches()
    _sync(device)
    t0 = time.perf_counter()
    outputs = server.rollout_batch(model, scenarios, cfg.seed,
                                   max_batch=batch)
    _sync(device)
    wall_ms = (time.perf_counter() - t0) * 1e3
    batches = server.last_dispatch["batches"]
    steps = sum(agent_steps(o, cfg) for o in outputs)
    summary = dict(
        _summary_head(cfg, device, num_scenarios, n_steps, force_insert),
        batch=batch,
        batches=[dict(A=a, P=p, lanes=b, scenarios=k)
                 for a, p, b, k in batches],
        wall_ms=wall_ms,
        ms_per_batched_token_step=wall_ms / (len(batches) * n_steps),
        agent_steps=steps,
        agent_steps_per_s=steps / (wall_ms / 1e3),
        agents_inserted=[int(o["n_inserted"]) for o in outputs],
        **_launch_counts(launches0),
        host_reads=server.last_dispatch["host_reads"],
    )
    return outputs, summary


def run_train(cfg: Config, device=None, steps: int = 8,
              batch: Optional[int] = None, save_dir: Optional[str] = None,
              log_fn=print):
    """`steps` training steps on synthetic scenarios (train/loop.train),
    `batch` scenarios per step. Returns (trainer, summary)."""
    from infgen_torch.train.loop import SyntheticDataset, train

    device = resolve_device(device)
    if batch:
        cfg = cfg.replace(train_batch_size=batch)
    B = max(cfg.train_batch_size, 1)
    launches0 = kernel_launches()
    backward0 = PA.r_biased_attention_trainable.backward_calls
    trainer, history = train(cfg, SyntheticDataset(cfg, size=B * steps),
                             save_dir, max_steps=steps, device=device,
                             log_fn=log_fn)
    ms = sorted(h["ms"] for h in history[2:] or history)
    summary = dict(
        device=str(device),
        device_name=(torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
        compute_dtype=cfg.compute_dtype,
        use_pallas_attention=cfg.use_pallas_attention,
        steps=len(history), batch=B,
        first_loss=history[0]["loss"], last_loss=history[-1]["loss"],
        ms_per_step=ms[len(ms) // 2],
        **_launch_counts(launches0),
        rba_backward_calls=(PA.r_biased_attention_trainable.backward_calls
                            - backward0))
    return trainer, summary


def main(argv=None):
    p = argparse.ArgumentParser("infgen_torch")
    p.add_argument("mode", choices=["rollout", "train"])
    p.add_argument("--config", default="configs/ours_long_term.yaml",
                   help="YAML config path")
    p.add_argument("--synthetic", action="store_true",
                   help="use the synthetic scenario generator (the only "
                        "data source of this port so far)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; no fallback between them")
    p.add_argument("--force-insert", action="store_true",
                   help="every insertion iteration proposes an agent")
    p.add_argument("--num-scenarios", type=int, default=1)
    p.add_argument("--batch", type=int, default=None,
                   help="rollout: serve the scenarios through RolloutServer."
                        "rollout_batch, at most this many lanes per batch; "
                        "train: scenarios per step")
    p.add_argument("--steps", type=int, default=8,
                   help="train: optimizer steps")
    p.add_argument("--save-dir", default=None,
                   help="train: checkpoint directory (resumes from it)")
    p.add_argument("--num-recurrent-steps", type=int, default=None,
                   help="10 Hz frames to roll out (default from the config)")
    p.add_argument("--params", default=None,
                   help="converted flax params (.npz from convert.save_npz)")
    add_variant_flags(p)
    args = p.parse_args(argv)
    if not args.synthetic:
        p.error("only --synthetic scenarios are ported so far")
    cfg = apply_variant_flags(load_config(args.config), args)
    if args.mode == "train":
        _, summary = run_train(cfg, args.device, args.steps, args.batch,
                               args.save_dir)
    elif args.batch:
        _, summary = run_batched(
            cfg, args.device, args.num_scenarios, args.batch,
            args.force_insert, args.params, args.num_recurrent_steps)
    else:
        _, summary = run_rollouts(
            cfg, args.device, args.num_scenarios, args.force_insert,
            args.params, args.num_recurrent_steps)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
