"""Synthetic WOMD scenario protos, from a seeded numpy generator.

Writes Scenario messages in the protobuf wire format, with the public
scenario.proto / map.proto field numbers that data/womd_proto.py decodes,
framed as TFRecord files (length, length CRC, data, data CRC; the CRCs are
zeros, as the decoders skip them). Real WOMD files are not in the
repository; these bytes stand in for them in the tests and on the card.

A scenario holds `num_agents` vehicle / pedestrian / cyclist tracks of
`num_steps` 10 Hz states (some tracks with an invalid gap, or entering late,
or leaving early), `num_other` tracks of type "other" that preprocessing
drops, an SDC valid throughout, tracks to predict, traffic-light states for
the history steps, and a map of lanes, road lines and road edges on a grid
(points 1 m apart), crosswalks, a speed bump and a stop sign. The map's
polylines add up to at least `map_length_m` metres. `write_womd_files`
writes a directory of such files.
"""

import os
import struct
from typing import List, Sequence

import numpy as np

CURRENT_TIME_INDEX = 10
# WOMD object types: 1 vehicle, 2 pedestrian, 3 cyclist, 4 other
_SHAPES = {1: (4.5, 2.0, 1.6), 2: (0.8, 0.8, 1.8), 3: (1.8, 0.8, 1.6),
           4: (1.0, 1.0, 1.0)}
_SPEEDS = {1: (2.0, 15.0), 2: (0.3, 2.0), 3: (2.0, 7.0), 4: (0.0, 1.0)}


# ---- wire format ----

def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(num: int, wt: int) -> bytes:
    return _varint((num << 3) | wt)


def _msg(num: int, payload: bytes) -> bytes:
    return _key(num, 2) + _varint(len(payload)) + payload


def _double(num: int, v: float) -> bytes:
    return _key(num, 1) + struct.pack("<d", v)


def _float(num: int, v: float) -> bytes:
    return _key(num, 5) + struct.pack("<f", v)


def _vint(num: int, v: int) -> bytes:
    return _key(num, 0) + _varint(int(v))


def _points(num: int, pts: np.ndarray) -> bytes:
    return b"".join(_msg(num, _double(1, x) + _double(2, y) + _double(3, z))
                    for x, y, z in np.asarray(pts, np.float64))


def encode_track(tid: int, object_type: int, states: np.ndarray,
                 valid: np.ndarray) -> bytes:
    """Track message; `states` [T, 9]: x, y, z, length, width, height,
    heading, vx, vy."""
    body = _vint(1, tid) + _vint(2, object_type)
    for s, v in zip(np.asarray(states, np.float64), valid):
        body += _msg(3, _double(2, s[0]) + _double(3, s[1])
                     + _double(4, s[2]) + _float(5, s[3]) + _float(6, s[4])
                     + _float(7, s[5]) + _float(8, s[6]) + _float(9, s[7])
                     + _float(10, s[8]) + _vint(11, bool(v)))
    return body


def encode_map_feature(fid: int, kind: str, pts: np.ndarray,
                       sub_type: int = 0) -> bytes:
    """MapFeature message of one kind ("lane", "road_line", "road_edge",
    "crosswalk", "speed_bump", "stop_sign")."""
    if kind == "lane":
        body = _msg(3, _double(1, 25.0) + _vint(2, sub_type)
                    + _points(8, pts))
    elif kind in ("road_line", "road_edge"):
        body = _msg(4 if kind == "road_line" else 5,
                    _vint(1, sub_type) + _points(2, pts))
    elif kind in ("crosswalk", "speed_bump"):
        body = _msg(8 if kind == "crosswalk" else 9, _points(1, pts))
    elif kind == "stop_sign":
        body = _msg(7, _points(2, pts[:1]))
    else:
        raise ValueError(f"unknown map feature kind {kind}")
    return _vint(1, fid) + body


# ---- random content ----

def _tracks(rng, num_agents: int, num_other: int, num_steps: int,
            extent: float):
    """Track arrays: types [N], states [N, T, 9], valid [N, T]; track 0 is
    the SDC (a vehicle, valid throughout)."""
    n = num_agents + num_other
    types = rng.choice([1, 1, 1, 2, 3], size=n)
    types[0] = 1
    types[num_agents:] = 4
    t = np.arange(num_steps) * 0.1
    states = np.zeros((n, num_steps, 9))
    valid = np.ones((n, num_steps), bool)
    for i, ot in enumerate(types):
        lo, hi = _SPEEDS[int(ot)]
        speed = rng.uniform(lo, hi)
        h0 = rng.uniform(-np.pi, np.pi)
        turn = rng.normal(0.0, 0.05)
        head = h0 + turn * t
        vx, vy = speed * np.cos(head), speed * np.sin(head)
        x0 = rng.uniform(-extent, extent, 2) * (0.2 if i == 0 else 1.0)
        x = x0[0] + np.cumsum(vx) * 0.1
        y = x0[1] + np.cumsum(vy) * 0.1
        size = np.asarray(_SHAPES[int(ot)]) * rng.uniform(0.9, 1.1, 3)
        states[i] = np.stack([x, y, np.full_like(t, rng.uniform(-1, 1)),
                              *np.broadcast_to(size[:, None],
                                               (3, num_steps)),
                              np.angle(np.exp(1j * head)), vx, vy], -1)
        if i == 0:
            continue
        case = rng.integers(0, 5)
        if case == 1:    # an invalid gap inside the track
            a = rng.integers(5, num_steps - 20)
            valid[i, a:a + rng.integers(2, 15)] = False
        elif case == 2:  # enters late
            valid[i, :rng.integers(1, num_steps - 5)] = False
        elif case == 3:  # leaves early
            valid[i, rng.integers(CURRENT_TIME_INDEX + 2, num_steps):] = False
    # invalid states carry zeros, as WOMD's do
    states[~valid] = 0.0
    return types, states, valid


def _polyline(start, heading, length, spacing=1.0, bend=0.0):
    """Points `spacing` m apart along an arc of `length` m: [n, 3]."""
    s = np.arange(0.0, length + 1e-9, spacing)
    h = heading + bend * s / max(length, 1.0)
    x = start[0] + np.concatenate([[0.0], np.cumsum(np.cos(h[:-1]))]) \
        * spacing
    y = start[1] + np.concatenate([[0.0], np.cumsum(np.sin(h[:-1]))]) \
        * spacing
    return np.stack([x, y, np.zeros_like(x)], -1)


def _map_features(rng, map_length_m: float, extent: float):
    """[(id, kind, points, sub_type)] on a grid of roads until the lanes,
    road lines and road edges add up to `map_length_m` metres."""
    feats, total, fid = [], 0.0, 1000
    while total < map_length_m:
        vertical = rng.random() < 0.5
        off = rng.uniform(-extent, extent)
        length = rng.uniform(0.6, 1.6) * extent
        start = (off, -length / 2) if vertical else (-length / 2, off)
        heading = np.pi / 2 if vertical else 0.0
        bend = rng.normal(0.0, 0.3)
        normal = np.array([-np.sin(heading), np.cos(heading)])
        for k, (kind, sub) in enumerate((
                ("lane", int(rng.integers(1, 4))),
                ("lane", int(rng.integers(1, 4))),
                ("road_line", int(rng.integers(1, 9))),
                ("road_edge", int(rng.integers(1, 3))))):
            shift = normal * 3.5 * (k - 1.5)
            pts = _polyline(np.asarray(start) + shift, heading, length,
                            bend=bend)
            feats.append((fid, kind, pts, sub))
            fid += 1
            total += length
    for _ in range(3):
        c = rng.uniform(-extent / 2, extent / 2, 2)
        box = c + np.array([[0, 0], [8, 0], [8, 3], [0, 3]], float)
        feats.append((fid, "crosswalk",
                      np.concatenate([box, np.zeros((4, 1))], 1), 0))
        fid += 1
    c = rng.uniform(-extent / 2, extent / 2, 2)
    feats.append((fid, "speed_bump", np.array(
        [[c[0], c[1], 0], [c[0] + 4, c[1], 0], [c[0] + 4, c[1] + 1, 0]]), 0))
    feats.append((fid + 1, "stop_sign", np.array([[c[0], c[1] - 5, 0.0]]),
                  0))
    return feats


def random_scenario(rng: np.random.Generator, scenario_id: str,
                    num_agents: int, num_other: int = 3,
                    map_length_m: float = 600.0, num_steps: int = 91,
                    extent: float = None) -> bytes:
    """One serialised Scenario (see the module docstring); `extent` (m,
    default from the map's length) bounds where agents and roads start."""
    extent = extent or float(np.clip(np.sqrt(map_length_m) * 2.0, 40, 160))
    types, states, valid = _tracks(rng, num_agents, num_other, num_steps,
                                   extent)
    feats = _map_features(rng, map_length_m, extent)
    lanes = [f[0] for f in feats if f[1] == "lane"]
    lit = rng.choice(lanes, size=min(len(lanes), 6), replace=False)
    light_states = rng.integers(0, 10, size=len(lit))
    lights = b"".join(
        _msg(7, b"".join(_msg(1, _vint(1, int(ln)) + _vint(2, int(st)))
                         for ln, st in zip(lit, light_states)))
        for _ in range(CURRENT_TIME_INDEX + 1))
    sdc = 0
    predict = rng.choice(np.arange(1, num_agents),
                         size=min(4, num_agents - 1), replace=False)
    body = _msg(1, struct.pack(f"<{num_steps}d",
                               *(np.arange(num_steps) * 0.1)))
    body += b"".join(_msg(2, encode_track(100 + i, int(types[i]), states[i],
                                          valid[i]))
                     for i in range(len(types)))
    body += b"".join(_msg(8, encode_map_feature(*f)) for f in feats)
    body += lights
    body += _msg(5, scenario_id.encode()) + _vint(6, sdc) \
        + _vint(10, CURRENT_TIME_INDEX)
    body += b"".join(_msg(11, _vint(1, int(p))) for p in predict)
    return body


def write_tfrecord(path: str, records: Sequence[bytes]) -> str:
    """TFRecord framing of `records` (zero CRCs)."""
    with open(path, "wb") as f:
        for r in records:
            f.write(struct.pack("<Q", len(r)) + b"\0" * 4 + r + b"\0" * 4)
    return path


def write_womd_files(out_dir: str, seed: int = 0, files: int = 2,
                     per_file: int = 4, agents=(60, 120),
                     map_length_m: float = 6000.0,
                     extra_agents: Sequence[int] = ()) -> List[str]:
    """`files` tfrecord files of `per_file` scenarios each (agents drawn
    from [agents[0], agents[1]]), then one more file holding a scenario per
    entry of `extra_agents` (that many agents each). Scenario ids are
    "s{seed}_{k}". Returns the paths."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    counts = [[int(rng.integers(agents[0], agents[1] + 1))
               for _ in range(per_file)] for _ in range(files)]
    if extra_agents:
        counts.append(list(extra_agents))
    paths, k = [], 0
    for fi, group in enumerate(counts):
        recs = []
        for n in group:
            recs.append(random_scenario(rng, f"s{seed}_{k}", n,
                                        map_length_m=map_length_m))
            k += 1
        paths.append(write_tfrecord(
            os.path.join(out_dir, f"scenario.tfrecord-{fi:05d}"), recs))
    return paths
