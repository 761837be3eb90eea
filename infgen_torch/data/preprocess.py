"""Offline WOMD extraction: scenario tfrecords -> per-scenario pickles (the
port's copy of infgen_tpu/data/preprocess.py).

Port of the reference's data_preprocess.py (:66-933): decode tracks, map
features, and traffic-light states; interpolate agent tracks over invalid
gaps; emit pickles in the same schema the loaders consume
(infgen_torch/data/waymo.py), plus meta_infos.json. Uses the clean-room proto
decoder (womd_proto.py) instead of waymo_open_dataset. Each pickle caches
its map tokenization (`map_token`, `tokenize_pkl_map`). Numpy only: it
imports no torch. Workers are spawned processes, one tfrecord file each.

  python -m infgen_torch.data.preprocess --input-dir <tfrecords> \
      --output-dir <out> [--num-workers N]
"""

import argparse
import json
import multiprocessing as mp
import os
import pickle
from typing import Dict, List, Optional

import numpy as np

from infgen_torch.data.womd_proto import iter_tfrecord, parse_scenario
from infgen_torch.tokenizers.map_tokenizer import (MapTokenizer,
                                                   tokenize_map_polylines)

MIN_VALID_STEPS = 2

# point-type mapping (embedding ids 0..16; 13 excluded by the map tokenizer
# like the reference's crosswalk skip, preprocess.py:722-723)
_LANE_TYPE_BASE = 0        # lane sub_type 0..3      -> 0..3
_ROAD_LINE_BASE = 4        # road_line sub_type 0..8 -> 4..12
_CROSSWALK_TYPE = 13       # excluded from pt tokens
_ROAD_EDGE_BASE = 14       # road_edge sub_type 0..2 -> 14..16
_PL_TYPE = {"lane": 0, "road_line": 1, "road_edge": 2, "crosswalk": 3,
            "speed_bump": 3, "driveway": 3, "stop_sign": 3}

# traffic light: WOMD states (0..9) -> 4 classes {unknown, stop, caution, go}
_LIGHT_CLASS = {0: 0, 1: 1, 2: 2, 3: 3, 4: 1, 5: 2, 6: 3, 7: 1, 8: 2, 9: 0}


def _interp_gaps(valid: np.ndarray, arr: np.ndarray, unwrap: bool = False):
    """Linear interpolation across invalid gaps (data_preprocess.py:208-219)."""
    steps = np.nonzero(valid)[0]
    if len(steps) < 2:
        return arr, valid
    t0, t1 = steps[0], steps[-1]
    t_in = np.arange(t0, t1 + 1)
    src = arr[steps]
    if unwrap:
        src = np.unwrap(src, axis=0)
    if arr.ndim == 1:
        arr[t0:t1 + 1] = np.interp(t_in, steps, src)
    else:
        for d in range(arr.shape[1]):
            arr[t0:t1 + 1, d] = np.interp(t_in, steps, src[:, d])
    valid = valid.copy()
    valid[t0:t1 + 1] = True
    return arr, valid


def decode_agents(scenario: dict, num_steps: int = 91) -> Optional[Dict]:
    """Tracks -> padded agent arrays (data_preprocess.py:151-226)."""
    tracks = scenario["tracks"]
    rows = []
    for idx, tr in enumerate(tracks):
        ot = tr["object_type"]
        if ot not in (1, 2, 3):  # vehicle / pedestrian / cyclist
            continue
        states = tr["states"][:num_steps]
        valid = np.array([s["valid"] for s in states], bool)
        if valid.sum() < MIN_VALID_STEPS:
            continue
        rows.append((idx, tr, states, valid))
    if not rows:
        return None

    A = len(rows)
    out = dict(
        valid_mask=np.zeros((A, num_steps), bool),
        position=np.zeros((A, num_steps, 3), np.float32),
        heading=np.zeros((A, num_steps), np.float32),
        velocity=np.zeros((A, num_steps, 2), np.float32),
        shape=np.zeros((A, num_steps, 3), np.float32),
        type=np.zeros(A, np.int32),
        id=np.zeros(A, np.int64),
        role=np.zeros((A, 3), bool),
        category=np.zeros(A, np.int32),
    )
    av_idx = 0
    for i, (idx, tr, states, valid) in enumerate(rows):
        T = len(states)
        out["type"][i] = tr["object_type"] - 1
        out["id"][i] = tr["id"]
        pos = np.array([[s["x"], s["y"], s["z"]] for s in states], np.float32)
        head = np.array([s["heading"] for s in states], np.float32)
        vel = np.array([[s["vx"], s["vy"]] for s in states], np.float32)
        shape = np.array([[s["length"], s["width"], s["height"]]
                          for s in states], np.float32)
        v = valid.copy()
        pos, _ = _interp_gaps(valid, pos)
        head, _ = _interp_gaps(valid, head, unwrap=True)
        vel, v = _interp_gaps(valid, vel)
        out["valid_mask"][i, :T] = v
        out["position"][i, :T] = pos
        out["heading"][i, :T] = head
        out["velocity"][i, :T] = vel
        out["shape"][i, :T] = np.where(valid[:, None], shape,
                                       shape[valid].mean(0, keepdims=True))
        if idx == scenario["sdc_track_index"]:
            av_idx = i
            out["role"][i, 0] = True
        if idx in scenario["tracks_to_predict"]:
            out["category"][i] = 1
            out["role"][i, 2] = True
    out["av_idx"] = av_idx
    out["num_nodes"] = A
    return out


def decode_map(scenario: dict) -> Dict:
    """Map features -> point/polygon arrays (data_preprocess.py:226-425)."""
    pt_pos, pt_orient, pt_type, pt2pl = [], [], [], []
    pl_type, pl_light, pl_ids = [], [], []

    # traffic lights at the current step
    light_by_lane = {}
    ct = scenario["current_time_index"]
    dms = scenario["dynamic_map_states"]
    if 0 <= ct < len(dms):
        for ls in dms[ct]["lane_states"]:
            light_by_lane[ls["lane"]] = _LIGHT_CLASS.get(ls["state"], 0)

    pl_i = 0
    for feat in scenario["map_features"]:
        kind = feat["feature_type"]
        poly = feat["polyline"]
        if kind is None or poly is None or poly.shape[0] < 2:
            continue
        if kind == "lane":
            ptype = _LANE_TYPE_BASE + min(feat.get("sub_type", 0), 3)
        elif kind == "road_line":
            ptype = _ROAD_LINE_BASE + min(feat.get("sub_type", 0), 8)
        elif kind == "road_edge":
            ptype = _ROAD_EDGE_BASE + min(feat.get("sub_type", 0), 2)
        elif kind == "crosswalk":
            ptype = _CROSSWALK_TYPE
        else:
            continue
        xy = poly[:, :2]
        theta = np.arctan2(np.diff(xy[:, 1]), np.diff(xy[:, 0]))
        theta = np.concatenate([theta, theta[-1:]])
        n = xy.shape[0]
        pt_pos.append(poly.astype(np.float32))
        pt_orient.append(theta.astype(np.float32))
        pt_type.append(np.full(n, ptype, np.int32))
        pt2pl.append(np.stack([np.arange(n) + sum(len(p) for p in pt_pos[:-1]),
                               np.full(n, pl_i)], axis=0))
        pl_type.append(_PL_TYPE[kind])
        pl_light.append(light_by_lane.get(feat["id"], 0))
        pl_ids.append(feat["id"])
        pl_i += 1

    if not pt_pos:
        return dict(map_point=dict(position=np.zeros((0, 3), np.float32),
                                   orientation=np.zeros(0, np.float32),
                                   type=np.zeros(0, np.int32)),
                    map_polygon=dict(type=np.zeros(0, np.int32),
                                     light_type=np.zeros(0, np.int32)),
                    edge_index=np.zeros((2, 0), np.int64))
    return dict(
        map_point=dict(position=np.concatenate(pt_pos),
                       orientation=np.concatenate(pt_orient),
                       type=np.concatenate(pt_type)),
        map_polygon=dict(type=np.asarray(pl_type, np.int32),
                         light_type=np.asarray(pl_light, np.int32)),
        edge_index=np.concatenate(pt2pl, axis=1).astype(np.int64),
    )


def scenario_to_pkl_dict(raw: bytes, map_tokenizer=None) -> Optional[Dict]:
    scenario = parse_scenario(raw)
    agents = decode_agents(scenario)
    if agents is None:
        return None
    m = decode_map(scenario)
    out = {
        "scenario_id": scenario["scenario_id"],
        "city": "waymo",
        "agent": agents,
        "map_point": m["map_point"],
        "map_polygon": m["map_polygon"],
        ("map_point", "to", "map_polygon"): {"edge_index": m["edge_index"]},
    }
    if map_tokenizer is not None:
        # cache map tokenization offline so the train loader skips the
        # polyline split + vocab match per access (waymo.py reads this)
        out["map_token"] = tokenize_pkl_map(out, map_tokenizer)
    return out


def _to_numpy(x):
    """Arrays of a pkl: numpy, or the torch tensors of the reference's own
    pickles (read through their `.numpy()`, so that this module needs no
    torch)."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    if hasattr(x, "numpy"):
        return x.numpy()
    return np.asarray(x)


def tokenize_pkl_map(data: dict, map_tokenizer: MapTokenizer) -> dict:
    """Group pkl map points by (polygon, type), split into 5 m segments, and
    match against the map vocab (the JAX package's waymo.tokenize_pkl_map;
    here so that preprocessing caches it without importing torch)."""
    pt2pl = _to_numpy(data[("map_point", "to", "map_polygon")]["edge_index"])
    pt_pos = _to_numpy(data["map_point"]["position"])[:, :2]
    pt_orient = _to_numpy(data["map_point"]["orientation"])
    pt_type = _to_numpy(data["map_point"]["type"]).astype(np.int32)
    pl_type = _to_numpy(data["map_polygon"]["type"]).astype(np.int32)
    pl_light = _to_numpy(data["map_polygon"].get(
        "light_type", np.zeros(pl_type.shape[0]))).astype(np.int32)

    polylines = []
    for pl in np.unique(pt2pl[1]):
        idx = pt2pl[0, pt2pl[1] == pl]
        for tv in np.unique(pt_type[idx]):
            if tv == 13:  # skip crosswalk-boundary type (preprocess.py:722-723)
                continue
            sel = idx[pt_type[idx] == tv]
            if len(sel) <= 2:
                continue
            polylines.append(dict(
                points=pt_pos[sel], headings=pt_orient[sel], pt_type=int(tv),
                side=0, pl_type=int(pl_type[pl]), pl_id=int(pl),
                light=int(pl_light[pl]),
            ))

    map_arrays = tokenize_map_polylines(polylines)
    map_arrays["token_idx"] = np.asarray(map_tokenizer.match(
        map_arrays["traj_pos"], map_arrays["traj_theta"]))
    map_arrays["position"] = map_arrays["traj_pos"][:, 0]
    map_arrays["orientation"] = map_arrays["traj_theta"]
    return map_arrays


def process_file(tfrecord_path: str, output_dir: str) -> List[Dict]:
    map_tokenizer = MapTokenizer()
    metas = []
    for raw in iter_tfrecord(tfrecord_path):
        d = scenario_to_pkl_dict(raw, map_tokenizer)
        if d is None:
            continue
        out = os.path.join(output_dir, f"{d['scenario_id']}.pkl")
        if not os.path.exists(out):  # idempotent (data_preprocess.py:813)
            with open(out, "wb") as f:
                pickle.dump(d, f)
        metas.append({"scenario_id": d["scenario_id"],
                      "num_agents": int(d["agent"]["num_nodes"])})
    return metas


def main(argv=None):
    p = argparse.ArgumentParser("infgen_torch.data.preprocess")
    p.add_argument("--input-dir", required=True,
                   help="directory of WOMD scenario tfrecord files")
    p.add_argument("--output-dir", required=True,
                   help="where the per-scenario pickles and meta_infos.json "
                        "go")
    p.add_argument("--num-workers", type=int, default=8,
                   help="spawned worker processes (one tfrecord file each); "
                        "1 runs inline")
    args = p.parse_args(argv)

    os.makedirs(args.output_dir, exist_ok=True)
    files = sorted(os.path.join(args.input_dir, f)
                   for f in os.listdir(args.input_dir)
                   if "tfrecord" in f)
    if args.num_workers > 1:
        # spawn: fork is unsafe in a process that has started threads
        with mp.get_context("spawn").Pool(args.num_workers) as pool:
            results = pool.starmap(process_file,
                                   [(f, args.output_dir) for f in files])
    else:
        results = [process_file(f, args.output_dir) for f in files]

    meta = {m["scenario_id"]: {"num_agents": m["num_agents"]}
            for metas in results for m in metas}
    with open(os.path.join(args.output_dir, "meta_infos.json"), "w") as f:
        json.dump(meta, f)
    print(f"wrote {len(meta)} scenarios to {args.output_dir}")
    return meta


if __name__ == "__main__":
    main()
