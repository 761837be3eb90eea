"""Offline WOSAC scoring (port of infgen_tpu/metrics/offline.py):

  --dump-log        per-scenario log (ground-truth) features -> .npz
  --aggregate-log   concatenate them into total_features.npz (the log
                    histograms' source)
  --compute-metric  score dumped rollouts against the aggregated histograms

    python -m infgen_torch.metrics.offline --dump-log --aggregate-log \
        --synthetic --num-scenarios 16 [--config ...] [--device cpu]
    python -m infgen_torch.metrics.offline --dump-log --aggregate-log \
        --data-dir <preprocessed WOMD pickles> [--config ...]

`--dump-log` dumps every scenario of a data directory (WaymoDataset in eval
mode), or `--num-scenarios` synthetic ones.

Rollout dumps come from `python -m infgen_torch.cli validate
--dump-rollouts`. The .npz files carry the JAX package's field names, so a
file written by either package loads in the other. Jobs resume: an output
file that exists is skipped.
"""

import argparse
import glob
import json
import os
from typing import List

import numpy as np
import torch

from infgen_torch.config import Config, load_config
from infgen_torch.metrics.features import (
    MetricFeatures,
    compute_metric_features,
    concat_features,
)
from infgen_torch.metrics.wosac import (
    WosacConfig,
    aggregate_scenario_metrics,
    compute_scenario_metrics,
    make_log_distributions,
    metrics_to_host,
)
from infgen_torch.utils.device import resolve_device

_FIELDS = MetricFeatures._fields


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _save_features(path: str, f: MetricFeatures):
    np.savez_compressed(path, **{k: _np(v) for k, v in f._asdict().items()})


def _load_features(path: str, device="cpu") -> MetricFeatures:
    with np.load(path) as data:
        return MetricFeatures(**{k: torch.as_tensor(data[k], device=device)
                                 for k in _FIELDS})


def _device_tensor(x, device):
    """A host array as a tensor on `device` (None stays None)."""
    return None if x is None else torch.as_tensor(x, device=device)


def log_features(scenario, inputs, road_edges=None,
                 road_cyclic=None) -> MetricFeatures:
    """The log (ground-truth) features of one scenario of tensors and its
    model inputs: 3D kinematics from the logged elevation."""
    ag = scenario.agents
    return compute_metric_features(
        ag.position[..., :2], ag.heading, ag.valid, ag.shape[:, 0],
        ag.shape[:, 1], ag.slot_mask, ag.av_index, inputs.tokens.token_pos,
        inputs.tokens.state_idx, road_edges, road_cyclic,
        traj_z=ag.elevation)


def rollout_features(out: dict, road_edges=None,
                     road_cyclic=None) -> MetricFeatures:
    """The features of one rollout (one lane's output dict): planar
    kinematics, as the reference simulates z = 0."""
    return compute_metric_features(
        out["pred_traj"], out["pred_head"], out["pred_valid"],
        out["eval_shape"][:, 0], out["eval_shape"][:, 1], out["slot_active"],
        out["av_index"], out["pos_a"], out["next_state_idx"], road_edges,
        road_cyclic)


def dump_log_features(dataset, cfg: Config, out_dir: str, device=None):
    """Per-scenario log features, one .npz each."""
    from infgen_torch.cli import build_tokenizers
    from infgen_torch.data.features import build_model_inputs
    from infgen_torch.data.scenario import to_device
    from infgen_torch.metrics.map_distance import packed_road_edges

    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    attr, mt, _ = build_tokenizers(cfg)
    for i in range(len(dataset)):
        out = os.path.join(out_dir, f"log_features_{i:06d}.npz")
        if os.path.exists(out):
            continue
        scen = dataset[i]
        s = to_device(scen, device)
        inputs = build_model_inputs(
            cfg, mt, attr, s, torch.Generator(device=device).manual_seed(0))
        road_edges, road_cyclic = packed_road_edges(scen.map)
        _save_features(out, log_features(
            s, inputs, _device_tensor(road_edges, device),
            _device_tensor(road_cyclic, device)))
    return out_dir


def aggregate_log_features(log_dir: str, out_path: str = None
                           ) -> MetricFeatures:
    """Concatenate the per-scenario dumps into total_features.npz."""
    files = sorted(glob.glob(os.path.join(log_dir, "log_features_*.npz")))
    if not files:
        raise FileNotFoundError(f"no log feature dumps in {log_dir}")
    agg = concat_features([_load_features(f) for f in files])
    _save_features(out_path or os.path.join(log_dir, "total_features.npz"),
                   agg)
    return agg


def compute_metrics_offline(rollout_dir: str, total_features_path: str,
                            out_path: str = None, device=None) -> List[dict]:
    """Score the dumped rollouts of `rollout_dir` (rollout_*.npz) against
    the aggregated log features; writes wosac_metrics.json."""
    device = resolve_device(device)
    wcfg = WosacConfig()
    log_dist = make_log_distributions(
        wcfg, _load_features(total_features_path, device))
    results = []
    for f in sorted(glob.glob(os.path.join(rollout_dir, "rollout_*.npz"))):
        with np.load(f) as d:
            arrays = {k: d[k] for k in d.files}
        road_edges = arrays.get("road_edges")
        road_cyclic = arrays.get("road_cyclic")
        if road_edges is not None and road_edges.shape[0] == 0:
            road_edges = road_cyclic = None
        t = lambda k, dtype=None: torch.as_tensor(arrays[k], device=device,
                                                  dtype=dtype)
        sim = compute_metric_features(
            t("pred_traj"), t("pred_head"), t("pred_valid", torch.bool),
            t("length"), t("width"), t("slot_active", torch.bool),
            int(arrays["av_index"]), t("token_pos"), t("token_state"),
            _device_tensor(road_edges, device),
            _device_tensor(road_cyclic, device))
        m = metrics_to_host(compute_scenario_metrics(wcfg, log_dist, sim))
        m["file"] = os.path.basename(f)
        results.append(m)

    out_path = out_path or os.path.join(rollout_dir, "wosac_metrics.json")
    summary = aggregate_scenario_metrics(wcfg, results) if results else {}
    with open(out_path, "w") as fo:
        json.dump({"summary": summary, "scenarios": results}, fo, indent=2)
    print(json.dumps(summary, indent=2))
    return results


def save_rollout_dump(path: str, out: dict, road_edges=None,
                      road_cyclic=None):
    """Write one rollout's arrays for offline scoring. The road-edge
    polylines ride along, so that offline scoring needs no map."""
    np.savez_compressed(
        path,
        pred_traj=_np(out["pred_traj"]),
        pred_head=_np(out["pred_head"]),
        pred_valid=_np(out["pred_valid"]),
        length=_np(out["eval_shape"][:, 0]),
        width=_np(out["eval_shape"][:, 1]),
        slot_active=_np(out["slot_active"]),
        av_index=int(out["av_index"]),
        token_pos=_np(out["pos_a"]),
        token_state=_np(out["next_state_idx"]),
        road_edges=(np.asarray(road_edges) if road_edges is not None
                    else np.zeros((0, 2, 4), np.float32)),
        road_cyclic=(np.asarray(road_cyclic) if road_cyclic is not None
                     else np.zeros((0,), bool)),
    )


def main(argv=None):
    p = argparse.ArgumentParser("infgen_torch.metrics.offline")
    p.add_argument("--dump-log", action="store_true")
    p.add_argument("--aggregate-log", action="store_true")
    p.add_argument("--compute-metric", action="store_true")
    p.add_argument("--config", default=None)
    p.add_argument("--data-dir", default=None,
                   help="--dump-log: directory of preprocessed WOMD pickles "
                        "(python -m infgen_torch.data.preprocess), eval "
                        "mode; without it, or with --synthetic, synthetic "
                        "scenarios")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--log-dir", default="runs/log_features")
    p.add_argument("--rollout-dir", default="runs/default")
    p.add_argument("--num-scenarios", type=int, default=16)
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; no fallback between them")
    args = p.parse_args(argv)
    cfg = load_config(args.config) if args.config else Config()

    if args.dump_log:
        from infgen_torch.data.waymo import make_dataset
        dump_log_features(make_dataset(
            cfg, None if args.synthetic else args.data_dir,
            args.num_scenarios), cfg, args.log_dir, args.device)
    if args.aggregate_log:
        aggregate_log_features(args.log_dir)
    if args.compute_metric:
        compute_metrics_offline(
            args.rollout_dir, os.path.join(args.log_dir,
                                           "total_features.npz"),
            device=args.device)


if __name__ == "__main__":
    main()
