"""Waymo preprocessed-pkl loader -> fixed-shape Scenario (the port's copy of
infgen_tpu/data/waymo.py; host-side numpy, the Scenario of
infgen_torch/data/scenario.py).

Consumes the per-scenario pickles produced by the reference's offline
extraction (data_preprocess.py:802-841; agent schema :151-226, map schema
:226-425) so existing preprocessed WOMD datasets work unchanged. Host-side:
unpickling, train-agent scoring (WaymoTargetBuilder._score_trained_agents,
scalable_dataset.py:113-138), map tokenization, then padding.
"""

import json
import os
import pickle
from typing import Optional

import numpy as np

from infgen_torch.config import Config
from infgen_torch.data.preprocess import _to_numpy, tokenize_pkl_map
from infgen_torch.data.scenario import Scenario, build_scenario
from infgen_torch.tokenizers.map_tokenizer import MapTokenizer


def score_trained_agents(position, valid, role, max_num: int = 32,
                         num_historical_steps: int = 11,
                         rng: Optional[np.random.Generator] = None):
    """Train-agent selection (scalable_dataset.py:113-138).

    Returns (valid, train_mask): perception clipped to 150 m of ego; train on
    role agents + up to `max_num` nearby agents with >=5 future valid steps.
    """
    rng = rng or np.random.default_rng(0)
    step_current = num_historical_steps - 1
    av_index = int(np.nonzero(role[:, 0])[0][0])
    distance = np.linalg.norm(position - position[av_index], axis=-1)
    valid = valid & (distance < 150)

    role_mask = role.any(-1)
    extra = (distance[:, step_current] < 100) & \
            (valid[:, step_current + 1:].sum(-1) >= 5)
    train_mask = extra | role_mask
    if train_mask.sum() > max_num:
        cand = np.nonzero(extra & ~role_mask)[0]
        sel = rng.permutation(cand)[: max_num - role_mask.sum()]
        train_mask = role_mask.copy()
        train_mask[sel] = True
    return valid, train_mask


def pkl_to_scenario(data: dict, cfg: Config, map_tokenizer: MapTokenizer,
                    scenario_id: int = 0, training: bool = True) -> Scenario:
    """Convert one reference-format pkl dict into a Scenario."""
    ag = data["agent"]
    position = _to_numpy(ag["position"]).astype(np.float32)
    valid = _to_numpy(ag["valid_mask"]).astype(bool)
    heading = _to_numpy(ag["heading"]).astype(np.float32)
    velocity = _to_numpy(ag["velocity"]).astype(np.float32)
    type_ = _to_numpy(ag["type"]).astype(np.int32)
    shape = _to_numpy(ag["shape"]).astype(np.float32)
    role = _to_numpy(ag.get("role", np.zeros((len(type_), 3), bool))).astype(bool)
    av_idx = int(ag.get("av_idx", ag.get("av_index", 0)))
    if not role[:, 0].any():
        role[av_idx, 0] = True

    if training:
        valid, train_mask = score_trained_agents(
            position, valid, role, cfg.max_num, cfg.num_historical_steps)
    else:
        train_mask = np.ones(len(type_), bool)

    # per-agent static shape: first step with nonzero shape (preprocess.py:520-522)
    nz = np.all(shape != 0, axis=-1)
    first_nz = np.argmax(nz, axis=1)
    static_shape = shape[np.arange(len(type_)), first_nz]

    agent_arrays = dict(
        valid=valid, position=position[..., :2], heading=heading,
        velocity=velocity[..., :2], shape=static_shape, type=type_,
        av_index=av_idx, train_mask=train_mask,
        # logged z for 3D GT metric kinematics (compute_metrics.py:560+)
        elevation=(position[..., 2] if position.shape[-1] > 2
                   else np.zeros_like(heading)),
    )

    # --- map: cached tokenization if the pkl carries it (our preprocess
    # writes "map_token"; see tokenize_pkl_map), else tokenize on the fly
    # like the reference's WaymoTargetBuilder (scalable_dataset.py:145)
    if "map_token" in data:
        map_arrays = {k: _to_numpy(v) for k, v in data["map_token"].items()}
    else:
        map_arrays = tokenize_pkl_map(data, map_tokenizer)

    return build_scenario(agent_arrays, map_arrays, cfg.max_agents,
                          cfg.max_map_tokens, scenario_id=scenario_id)


class WaymoDataset:
    """pkl-per-scenario dataset with meta filtering (scalable_dataset.py:17-97).

    Filters scenarios by 8 <= num_agents < buffer_size using meta_infos.json
    when available. Items are host-side numpy Scenarios; the dataset
    pickles into BatchLoader's spawn workers (a path, a config and the
    map tokenizer's vocab).
    """

    def __init__(self, raw_dir: str, cfg: Config, training: bool = True):
        self.raw_dir = raw_dir
        self.cfg = cfg
        self.training = training
        self.map_tokenizer = MapTokenizer()

        files = sorted(f for f in os.listdir(raw_dir) if f.endswith(".pkl"))
        meta_path = os.path.join(raw_dir, "meta_infos.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            files = [f for f in files
                     if 8 <= meta.get(f.split(".")[0], {}).get(
                         "num_agents", 8) < cfg.buffer_size]
        self.files = files

    def __len__(self):
        return len(self.files)

    def __getitem__(self, i: int) -> Scenario:
        with open(os.path.join(self.raw_dir, self.files[i]), "rb") as f:
            data = pickle.load(f)
        return pkl_to_scenario(data, self.cfg, self.map_tokenizer,
                               scenario_id=i, training=self.training)


def make_dataset(cfg: Config, data_dir: Optional[str] = None,
                 num_scenarios: int = 1, training: bool = False):
    """The scenarios of an entry point: the WOMD pickles under `data_dir`
    (WaymoDataset, in training or eval mode) or, without one,
    `num_scenarios` synthetic scenarios (train/loop.SyntheticDataset, seeds
    0, 1, ...). A data directory that yields no scenario raises."""
    if not data_dir:
        from infgen_torch.train.loop import SyntheticDataset

        return SyntheticDataset(cfg, size=num_scenarios)
    dataset = WaymoDataset(data_dir, cfg, training=training)
    if len(dataset) == 0:
        raise ValueError(f"no scenario in {data_dir}: it holds no .pkl that "
                         f"meta_infos.json lets through (8 <= agents < "
                         f"buffer_size = {cfg.buffer_size})")
    return dataset
