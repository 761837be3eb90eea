"""Minimal clean-room protobuf wire-format decoder for WOMD Scenario protos
(the port's copy of infgen_tpu/data/womd_proto.py; numpy only).

Parses exactly the fields the preprocessing pipeline needs, using the public
WOMD schema's field numbers — no dependency on waymo_open_dataset or
generated bindings. Wire format per the protobuf spec: varint keys
(field_number << 3 | wire_type); wire types 0=varint, 1=fixed64,
2=length-delimited, 5=fixed32.

Schema field numbers (public waymo scenario.proto / map.proto):
  Scenario: timestamps_seconds=1, tracks=2, objects_of_interest=4,
            scenario_id=5, sdc_track_index=6, dynamic_map_states=7,
            map_features=8, current_time_index=10, tracks_to_predict=11
  Track: id=1, object_type=2, states=3
  ObjectState: center_x=2, center_y=3, center_z=4, length=5, width=6,
               height=7, heading=8, velocity_x=9, velocity_y=10, valid=11
  MapFeature: id=1, lane=3, road_line=4, road_edge=5, stop_sign=7,
              crosswalk=8, speed_bump=9, driveway=10
  LaneCenter: speed_limit_mph=1, type=2, interpolating=3, polyline=8
  RoadEdge/RoadLine: type=1, polyline=2
  Crosswalk/SpeedBump/Driveway: polygon=1
  MapPoint: x=1, y=2, z=3
  DynamicMapState: lane_states=1
  TrafficSignalLaneState: lane=1, state=2
  RequiredPrediction: track_index=1
"""

import struct
from typing import Dict, Iterator, List, Tuple

import numpy as np


def _read_varint(buf: memoryview, i: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7


def parse_fields(buf) -> Dict[int, List[Tuple[int, object]]]:
    """Parse one message into {field_number: [(wire_type, raw_value), ...]}."""
    buf = memoryview(buf)
    out: Dict[int, List[Tuple[int, object]]] = {}
    i = 0
    n = len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        field, wt = key >> 3, key & 7
        if wt == 0:
            val, i = _read_varint(buf, i)
        elif wt == 1:
            val = bytes(buf[i:i + 8]); i += 8
        elif wt == 2:
            ln, i = _read_varint(buf, i)
            val = bytes(buf[i:i + ln]); i += ln
        elif wt == 5:
            val = bytes(buf[i:i + 4]); i += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        out.setdefault(field, []).append((wt, val))
    return out


def _f32(fields, num, default=0.0):
    v = fields.get(num)
    return struct.unpack("<f", v[-1][1])[0] if v else default


def _f64(fields, num, default=0.0):
    v = fields.get(num)
    return struct.unpack("<d", v[-1][1])[0] if v else default


def _int(fields, num, default=0):
    v = fields.get(num)
    return int(v[-1][1]) if v else default


def _packed_or_repeated_f64(fields, num):
    vals = []
    for wt, raw in fields.get(num, []):
        if wt == 2:  # packed
            vals.extend(struct.unpack(f"<{len(raw) // 8}d", raw))
        else:
            vals.append(struct.unpack("<d", raw)[0])
    return vals


def _map_points(fields, num) -> np.ndarray:
    pts = []
    for _, raw in fields.get(num, []):
        p = parse_fields(raw)
        pts.append((_f64(p, 1), _f64(p, 2), _f64(p, 3)))
    return np.asarray(pts, np.float64).reshape(-1, 3)


def parse_object_state(raw: bytes) -> dict:
    f = parse_fields(raw)
    return dict(
        x=_f64(f, 2), y=_f64(f, 3), z=_f64(f, 4),
        length=_f32(f, 5), width=_f32(f, 6), height=_f32(f, 7),
        heading=_f32(f, 8), vx=_f32(f, 9), vy=_f32(f, 10),
        valid=bool(_int(f, 11)),
    )


def parse_track(raw: bytes) -> dict:
    f = parse_fields(raw)
    states = [parse_object_state(r) for _, r in f.get(3, [])]
    return dict(id=_int(f, 1), object_type=_int(f, 2), states=states)


def parse_map_feature(raw: bytes) -> dict:
    f = parse_fields(raw)
    out = dict(id=_int(f, 1), feature_type=None, polyline=None, sub_type=0)
    kinds = {3: "lane", 4: "road_line", 5: "road_edge", 7: "stop_sign",
             8: "crosswalk", 9: "speed_bump", 10: "driveway"}
    for num, name in kinds.items():
        if num in f:
            sub = parse_fields(f[num][-1][1])
            out["feature_type"] = name
            if name == "lane":
                out["polyline"] = _map_points(sub, 8)
                out["sub_type"] = _int(sub, 2)
                out["speed_limit_mph"] = _f64(sub, 1)
            elif name in ("road_line", "road_edge"):
                out["polyline"] = _map_points(sub, 2)
                out["sub_type"] = _int(sub, 1)
            elif name in ("crosswalk", "speed_bump", "driveway"):
                out["polyline"] = _map_points(sub, 1)
            elif name == "stop_sign":
                out["polyline"] = _map_points(sub, 2)  # position (field 2)
            break
    return out


def parse_dynamic_map_state(raw: bytes) -> dict:
    f = parse_fields(raw)
    lane_states = []
    for _, r in f.get(1, []):
        s = parse_fields(r)
        lane_states.append(dict(lane=_int(s, 1), state=_int(s, 2)))
    return dict(lane_states=lane_states)


def parse_scenario(raw: bytes) -> dict:
    f = parse_fields(raw)
    sid = f.get(5, [(2, b"")])[-1][1].decode("utf-8", "ignore")
    return dict(
        scenario_id=sid,
        timestamps_seconds=_packed_or_repeated_f64(f, 1),
        tracks=[parse_track(r) for _, r in f.get(2, [])],
        sdc_track_index=_int(f, 6),
        current_time_index=_int(f, 10),
        dynamic_map_states=[parse_dynamic_map_state(r) for _, r in f.get(7, [])],
        map_features=[parse_map_feature(r) for _, r in f.get(8, [])],
        tracks_to_predict=[_int(parse_fields(r), 1) for _, r in f.get(11, [])],
        objects_of_interest=[v for wt, v in f.get(4, []) if wt == 0],
    )


def iter_tfrecord(path: str) -> Iterator[bytes]:
    """Raw TFRecord reader (length-prefixed records; CRCs skipped)."""
    with open(path, "rb") as fh:
        while True:
            header = fh.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            data = fh.read(length)
            fh.read(4)  # data crc
            yield data
