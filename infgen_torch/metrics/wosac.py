"""WOSAC-long realism metrics: histogram likelihoods and the metametric
(port of infgen_tpu/metrics/wosac.py).

The logged features make one smoothed histogram per field
(`make_log_distributions`); each rollout's features are scored against
them per 80-frame window (`compute_scenario_metrics`), on the device of the
features. `aggregate_scenario_metrics` averages the per-scenario results on
the host in float64, with the reference's output schema. Defaults are the
reference's metric_config.textproto.
"""

from dataclasses import dataclass
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from infgen_torch.config import SHIFT
from infgen_torch.metrics.features import (
    MetricFeatures,
    N_SIMULATION_STEPS,
    compute_kinematic_validity,
    unfold_axis,
    unfold_features,
)


@dataclass(frozen=True)
class HistogramSpec:
    min_val: float
    max_val: float
    num_bins: int
    pseudocount: float = 0.1
    weight: float = 0.0


@dataclass(frozen=True)
class WosacConfig:
    """Defaults of the reference's metric_config.textproto. The metametric's
    fields leave out road-edge distance and offroad, as the reference's do."""

    linear_speed: HistogramSpec = HistogramSpec(0.0, 25.0, 10, 0.1, 0.05)
    linear_acceleration: HistogramSpec = HistogramSpec(-12.0, 12.0, 11, 0.1, 0.05)
    angular_speed: HistogramSpec = HistogramSpec(-0.628, 0.628, 11, 0.1, 0.05)
    angular_acceleration: HistogramSpec = HistogramSpec(-3.14, 3.14, 11, 0.1, 0.05)
    distance_to_nearest_object: HistogramSpec = HistogramSpec(-5.0, 40.0, 10, 0.1, 0.1)
    collision_indication: HistogramSpec = HistogramSpec(-0.5, 0.5, 2, 0.1, 0.25)
    time_to_collision: HistogramSpec = HistogramSpec(0.0, 5.0, 10, 0.1, 0.1)
    num_placement: HistogramSpec = HistogramSpec(0.0, 10.0, 5, 0.1, 0.1)
    num_removement: HistogramSpec = HistogramSpec(0.0, 10.0, 5, 0.1, 0.1)
    distance_placement: HistogramSpec = HistogramSpec(0.0, 75.0, 10, 0.1, 0.1)
    distance_removement: HistogramSpec = HistogramSpec(0.0, 75.0, 10, 0.1, 0.1)

    def fields(self):
        return ("linear_speed", "linear_acceleration", "angular_speed",
                "angular_acceleration", "distance_to_nearest_object",
                "collision_indication", "time_to_collision", "num_placement",
                "num_removement", "distance_placement", "distance_removement")

    @classmethod
    def from_textproto(cls, path: str) -> "WosacConfig":
        """Parse a reference-format SimAgentMetricsConfig textproto without
        protobuf."""
        import re

        with open(path) as f:
            text = f.read()
        text = re.sub(r"#.*", "", text)                 # comments
        kwargs = {}
        for m in re.finditer(r"(\w+)\s*:\s*\{(.*?)\n\}", text, re.DOTALL):
            name, body = m.group(1), m.group(2)
            if name not in cls().fields() and name not in (
                    "distance_to_road_edge", "offroad_indication"):
                continue

            def grab(key, default=None):
                mm = re.search(rf"{key}\s*:\s*([-\d.eE]+)", body)
                return float(mm.group(1)) if mm else default

            weight = grab("metametric_weight", 0.0)
            if "bernoulli" in body:
                spec = HistogramSpec(-0.5, 0.5, 2,
                                     grab("additive_smoothing_pseudocount", 0.1),
                                     weight)
            else:
                spec = HistogramSpec(grab("min_val", 0.0), grab("max_val", 1.0),
                                     int(grab("num_bins", 10)),
                                     grab("additive_smoothing_pseudocount", 0.1),
                                     weight)
            if name in cls().fields():
                kwargs[name] = spec
        return cls(**kwargs)


def bin_edges(spec: HistogramSpec) -> np.ndarray:
    """The num_bins + 1 histogram edges in float32, bit for bit those of
    the JAX package's jitted scoring. There jnp.linspace's start * (1 - i/n)
    + stop * (i/n) has constant ends, and XLA rewrites it as start * (1 - i
    * r) + i * (stop * r) with r the float32 reciprocal of n; the last edge
    is stop. torch.linspace, and jnp.linspace called eagerly, differ from
    it in the last bit for four of the eleven default specs, which moves a
    value that lies on an edge into another bin."""
    f32 = np.float32
    i = np.arange(spec.num_bins, dtype=f32)
    r = f32(1) / f32(spec.num_bins)
    out = f32(spec.min_val) * (f32(1) - i * r) + i * (f32(spec.max_val) * r)
    return np.append(out, f32(spec.max_val)).astype(f32)


def _uniform_bin_index(spec: HistogramSpec, v):
    """Histogram bin of each value: the count of edges <= v, less one,
    clipped to the bins (searchsorted side="right" on the edges). A NaN
    compares false everywhere and lands in bin 0."""
    ss = sum((v >= float(e)).to(torch.int32) for e in bin_edges(spec))
    return torch.clamp(ss - 1, 0, spec.num_bins - 1)


def _histogram_log_probs(spec: HistogramSpec, values, valid=None):
    """Smoothed log-probability of each bin from logged feature values:
    clamp to the range, histogram, add the pseudocount, normalise.
    values: any shape; valid: an optional bool mask of the same."""
    v = values.reshape(-1).to(torch.float32)
    ok = torch.isfinite(v)
    if valid is not None:
        ok = ok & valid.reshape(-1)
    v = torch.clamp(v, spec.min_val, spec.max_val)
    bin_idx = _uniform_bin_index(spec, v)
    counts = torch.stack([((bin_idx == i) & ok).sum().to(torch.float32)
                          for i in range(spec.num_bins)])
    counts = counts + spec.pseudocount
    return torch.log(counts / counts.sum())


def _value_log_likelihood(spec: HistogramSpec, log_probs, sim_values):
    """Per-value log-likelihood under the logged histogram. Values outside
    the range or NaN fall into bin 0 (the reference's quirk)."""
    v = sim_values.to(torch.float32)
    in_range = torch.isfinite(v) & (v >= spec.min_val) & (v <= spec.max_val)
    bin_idx = torch.where(in_range, _uniform_bin_index(spec, v), 0)
    return log_probs[bin_idx.long()]


def _avg_valid(x, validity):
    """Masked average over the last axis, -inf where nothing is valid."""
    s = torch.where(validity, x, 0.0).sum(-1)
    n = validity.sum(-1)
    return torch.where(n > 0, s / torch.clamp(n, min=1), -torch.inf)


def _mean_finite(x, dim=None):
    """Mean over the finite entries (0 where none is)."""
    ok = torch.isfinite(x)
    zero = torch.where(ok, x, 0.0)
    s = zero.sum() if dim is None else zero.sum(dim)
    n = ok.sum() if dim is None else ok.sum(dim)
    return torch.where(n > 0, s / torch.clamp(n, min=1), 0.0)


class LogDistributions(NamedTuple):
    """Per-field smoothed log histogram [num_bins]."""
    linear_speed: torch.Tensor
    linear_acceleration: torch.Tensor
    angular_speed: torch.Tensor
    angular_acceleration: torch.Tensor
    distance_to_nearest_object: torch.Tensor
    collision_indication: torch.Tensor
    time_to_collision: torch.Tensor
    num_placement: torch.Tensor
    num_removement: torch.Tensor
    distance_placement: torch.Tensor
    distance_removement: torch.Tensor


def make_log_distributions(cfg: WosacConfig, log_features: MetricFeatures
                           ) -> LogDistributions:
    """The logged histograms from the aggregated log features. Distance
    fields keep in-range values only; num_placement drops its last two
    steps (the reference's)."""
    f = log_features
    hist = _histogram_log_probs
    speed_v, accel_v = compute_kinematic_validity(f.valid)
    coll = torch.where(f.valid, f.collision_per_step, False).any(-1)
    dist_pl_ok = (f.distance_placement > cfg.distance_placement.min_val) & \
                 (f.distance_placement < cfg.distance_placement.max_val)
    dist_rm_ok = (f.distance_removement > cfg.distance_removement.min_val) & \
                 (f.distance_removement < cfg.distance_removement.max_val)
    f32 = torch.float32
    return LogDistributions(
        linear_speed=hist(cfg.linear_speed, f.linear_speed, speed_v),
        linear_acceleration=hist(cfg.linear_acceleration,
                                 f.linear_acceleration, accel_v),
        angular_speed=hist(cfg.angular_speed, f.angular_speed, speed_v),
        angular_acceleration=hist(cfg.angular_acceleration,
                                  f.angular_acceleration, accel_v),
        distance_to_nearest_object=hist(cfg.distance_to_nearest_object,
                                        f.distance_to_nearest_object, f.valid),
        collision_indication=hist(cfg.collision_indication, coll.to(f32)),
        time_to_collision=hist(cfg.time_to_collision, f.time_to_collision,
                               f.valid),
        num_placement=hist(cfg.num_placement,
                           f.num_placement[:, :-2].to(f32)),
        num_removement=hist(cfg.num_removement, f.num_removement.to(f32)),
        distance_placement=hist(cfg.distance_placement, f.distance_placement,
                                dist_pl_ok),
        distance_removement=hist(cfg.distance_removement,
                                 f.distance_removement, dist_rm_ok),
    )


def compute_scenario_metrics(cfg: WosacConfig, log_dist: LogDistributions,
                             sim: MetricFeatures) -> Dict[str, torch.Tensor]:
    """Score one scenario's rollout(s) against the logged distributions.

    Returns, as tensors on the features' device: the likelihood of each
    field, the metametric, the simulated collision and offroad rates, and
    per-window `wosac_long/*` curves.
    """
    flat = sim
    simw = unfold_features(sim)          # windows: [..., n_window, size]
    out, long = {}, {}

    # the kinematic fields share validity windows
    size = min(N_SIMULATION_STEPS, int(flat.valid.shape[-1]))
    speed_v, accel_v = compute_kinematic_validity(flat.valid)
    speed_vw = unfold_axis(speed_v, size, SHIFT)
    accel_vw = unfold_axis(accel_v, size, SHIFT)

    def score(name, spec, values, validity):
        ll = _value_log_likelihood(spec, getattr(log_dist, name), values)
        per_win = torch.exp(_avg_valid(ll, validity))     # [A, n_window]
        out[name] = _mean_finite(per_win)
        long[name] = _mean_finite(per_win, dim=0)         # [n_window]

    score("linear_speed", cfg.linear_speed, simw.linear_speed, speed_vw)
    score("angular_speed", cfg.angular_speed, simw.angular_speed, speed_vw)
    score("linear_acceleration", cfg.linear_acceleration,
          simw.linear_acceleration, accel_vw)
    score("angular_acceleration", cfg.angular_acceleration,
          simw.angular_acceleration, accel_vw)

    # collision: bernoulli over any collision per window
    coll_w = torch.where(simw.valid, simw.collision_per_step, False).any(-1)
    ll_coll = _value_log_likelihood(
        cfg.collision_indication, log_dist.collision_indication,
        coll_w.to(torch.float32))
    out["collision_indication"] = torch.exp(ll_coll.mean())
    long["collision_indication"] = _mean_finite(torch.exp(ll_coll), dim=0)

    dno = simw.distance_to_nearest_object
    dno_valid = simw.valid & (dno >= cfg.distance_to_nearest_object.min_val) \
        & (dno <= cfg.distance_to_nearest_object.max_val)
    score("distance_to_nearest_object", cfg.distance_to_nearest_object, dno,
          dno_valid)
    score("time_to_collision", cfg.time_to_collision, simw.time_to_collision,
          simw.valid)

    # placement: per-scenario series [1, n_window, size] (the leading axis
    # is the rollout, not agents), reduced over it with a mean
    for name in ("num_placement", "num_removement"):
        ll = _value_log_likelihood(getattr(cfg, name),
                                   getattr(log_dist, name),
                                   getattr(simw, name).to(torch.float32))
        out[name] = torch.exp(ll.mean())
        long[name] = torch.exp(ll.mean(-1)).mean(0)

    # token-rate validity for the placement distances
    tok_valid = flat.valid[..., ::SHIFT]
    tok_valid_w = unfold_axis(tok_valid, size // SHIFT, SHIFT // SHIFT)
    for name in ("distance_placement", "distance_removement"):
        spec = getattr(cfg, name)
        vals = getattr(simw, name)
        validity = tok_valid_w & (vals > spec.min_val) & (vals < spec.max_val)
        score(name, spec, vals, validity)

    # the metametric
    metametric = sum(getattr(cfg, n).weight * out[n] for n in cfg.fields())
    meta_long = sum(getattr(cfg, n).weight * long[n] for n in cfg.fields())
    zero_any = sum((long[n] == 0).to(torch.float32)
                   for n in cfg.fields()) > 0
    meta_long = torch.where(zero_any, 0.0, meta_long)

    coll_ind = torch.where(flat.valid, flat.collision_per_step,
                           False).any(-1)
    # the reference defines simulated_offroad_rate but leaves it at 0; this
    # computes it as the collision rate is computed
    offroad_ind = torch.where(flat.valid, flat.offroad_per_step,
                              False).any(-1)
    return {
        **{f"{k}_likelihood": v for k, v in out.items()},
        "metametric": metametric,
        "simulated_collision_rate": coll_ind.to(torch.float32).mean(),
        "simulated_offroad_rate": offroad_ind.to(torch.float32).mean(),
        "wosac_long/metametric": meta_long,
        **{f"wosac_long/{k}_likelihood": v for k, v in long.items()},
    }


# the feature each histogram-scored field bins (collision_indication bins a
# boolean, held by its distance instead)
BINNED_FEATURES = ("linear_speed", "linear_acceleration", "angular_speed",
                   "angular_acceleration", "distance_to_nearest_object",
                   "time_to_collision", "num_placement", "num_removement",
                   "distance_placement", "distance_removement")


def bin_flips(cfg: WosacConfig, a: MetricFeatures, b: MetricFeatures,
              rel: float = 1e-5) -> Dict[str, tuple]:
    """Where two feature sets of one shape (two devices' or two packages'
    extraction of the same rollout) put a value into different histogram
    bins under the scoring's rule (out of range or NaN is bin 0), per
    binned field: (flips, flips that no edge certifies). A flip is
    certified when either side's value lies within rel * max(|edge|, 1) of
    one of the field's edges: float32 noise then decides the bin."""
    out = {}
    for name in BINNED_FEATURES:
        spec = getattr(cfg, name)
        edges = torch.as_tensor(bin_edges(spec), device=getattr(a, name).device)
        bins, vals = [], []
        for f in (a, b):
            v = getattr(f, name).to(torch.float32)
            ok = torch.isfinite(v) & (v >= spec.min_val) & (v <= spec.max_val)
            bins.append(torch.where(ok, _uniform_bin_index(spec, v), 0))
            vals.append(v)
        flip = bins[0] != bins[1]
        near = torch.zeros_like(flip)
        for v in vals:
            gap = torch.abs(v[..., None] - edges)
            near |= (gap <= rel * torch.clamp(edges.abs(), min=1.0)).any(-1)
        out[name] = (int(flip.sum()), int((flip & ~near).sum()))
    return out


def metrics_to_host(m: Dict[str, torch.Tensor]) -> Dict[str, object]:
    """compute_scenario_metrics' tensors as Python floats (scalars) and
    lists (curves), read from the device in one copy."""
    keys = list(m)
    flat = torch.cat([m[k].reshape(-1).to(torch.float32) for k in keys])
    host = flat.cpu().numpy()
    res, o = {}, 0
    for k in keys:
        n = m[k].numel()
        res[k] = float(host[o]) if m[k].dim() == 0 else \
            [float(x) for x in host[o:o + n]]
        o += n
    return res


# --------------------------------------------------------------------- #
# cross-scenario aggregation and bucketed summary (host, float64)
# --------------------------------------------------------------------- #

# the reference's metric fields by bucket; map_based is empty there
# (road-edge and offroad commented out), so it aggregates to 0
METRIC_FIELDS_BY_BUCKET = {
    "kinematic": ("linear_speed", "linear_acceleration",
                  "angular_speed", "angular_acceleration"),
    "interactive": ("distance_to_nearest_object", "collision_indication",
                    "time_to_collision"),
    "map_based": (),
    "placement_based": ("num_placement", "num_removement",
                        "distance_placement", "distance_removement"),
}


def _reduce_mean_curves(rows: np.ndarray) -> np.ndarray:
    """Per-window mean over scenarios of the entries in (0, 1] (zeroed
    windows, -inf and NaN left out). rows: [S, n_window]."""
    ok = (rows > 0.0) & (rows <= 1.0)
    s = np.where(ok, rows, 0.0).sum(0)
    n = np.maximum(ok.sum(0), 1)
    return s / n


def aggregate_scenario_metrics(cfg: WosacConfig,
                               per_scenario: List[dict]) -> Dict[str, object]:
    """Scenario-set WOSAC aggregation and bucketed summary, as the
    reference's LongMetric computes them:
      - scalar likelihoods are averaged over scenarios, except
        distance_placement / distance_removement, which divide by the
        count of scenarios where that likelihood is > 0;
      - per-window `*_long` curves are averaged over scenarios counting only
        entries in (0, 1];
      - bucket scores are metametric-weighted means of the aggregated
        likelihoods.

    per_scenario: dicts as compute_scenario_metrics returns them, with host
    floats and lists (metrics_to_host) or CPU tensors. Returns the
    reference's keys ('wosac/...', 'wosac_likelihood/...', 'wosac_long/...').
    """
    S = len(per_scenario)
    fields = list(cfg.fields())
    scalar_keys = (["metametric", "simulated_collision_rate",
                    "simulated_offroad_rate"]
                   + [f"{f}_likelihood" for f in fields])

    def col(key):
        return np.array([float(np.asarray(m[key])) for m in per_scenario],
                        np.float64)

    means: Dict[str, float] = {}
    for k in scalar_keys:
        if S == 0 or k not in per_scenario[0]:
            continue
        v = col(k)
        if k in ("distance_placement_likelihood",
                 "distance_removement_likelihood"):
            n_valid = max(int((v > 0).sum()), 1)
            means[k] = float(v.sum() / n_valid)
        else:
            means[k] = float(v.sum() / max(S, 1))

    def bucket_score(names, get):
        w_sum, acc = 0.0, None
        for f in names:
            w = getattr(cfg, f).weight
            x = get(f)
            acc = (w * x) if acc is None else acc + w * x
            w_sum += w
        if acc is None:
            return 0.0
        return acc / (w_sum if w_sum else 1.0)

    out: Dict[str, object] = {
        "wosac/realism_meta_metric": means.get("metametric", 0.0),
        "wosac/scenario_counter": S,
    }
    for bucket, names in METRIC_FIELDS_BY_BUCKET.items():
        out[f"wosac/{bucket}_metrics"] = float(bucket_score(
            names, lambda f: means.get(f"{f}_likelihood", 0.0)))
    for k, v in means.items():
        out[f"wosac_likelihood/{k}"] = v

    long_means: Dict[str, np.ndarray] = {}
    long_keys = ["metametric"] + [f"{f}_likelihood" for f in fields]
    for k in long_keys:
        src = f"wosac_long/{k}"
        if S == 0 or src not in per_scenario[0]:
            continue
        rows = np.stack([np.asarray(m[src], np.float64).reshape(-1)
                         for m in per_scenario])
        long_means[k] = _reduce_mean_curves(rows)
    if long_means:
        out["wosac_long/realism_meta_metric"] = [
            round(float(x), 4) for x in long_means["metametric"]]
        for bucket, names in METRIC_FIELDS_BY_BUCKET.items():
            curve = bucket_score(
                names,
                lambda f: long_means[f"{f}_likelihood"]) if names else \
                np.zeros_like(long_means["metametric"])
            out[f"wosac_long/{bucket}_metrics"] = [
                round(float(x), 4) for x in np.atleast_1d(curve)]
        for k, v in long_means.items():
            out[f"wosac_long_likelihood/{k}"] = [
                round(float(x), 4) for x in v]
    return out
