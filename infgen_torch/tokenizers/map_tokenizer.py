"""Map tokenization: raw polylines -> 5 m "pt tokens" matched to the map vocab.

Port of infgen_tpu/tokenizers/map_tokenizer.py's host-side path (offline
preprocessing): polyline splitting and vocab matching. The split runs in the
port's native C++ helper (data/native.py, built with g++ at first use), as
the JAX package's does where its library loads; `use_native=False` takes the
numpy twin. The two agree only within 1e-4 (float64 resampling in another
order, float32 output), so a segment near a tie between two vocab tokens
can match another token: the port splits natively so that its token ids
equal the JAX package's. The training-time top-8 match noise is not ported.
"""

import math
from typing import Dict, List, Optional

import numpy as np

from infgen_torch.tokenizers.vocab import load_map_vocab


def interpolate_polyline(points: np.ndarray, headings: np.ndarray,
                         distance: float = 0.5, split_distance: float = 5.0,
                         use_native: bool = True) -> Optional[np.ndarray]:
    """Resample a polyline at `distance` m and split into 5 m 3-point segments.

    Returns [n_seg, 3, 3] (x, y, theta) or None. Mirrors
    interplating_polyline (preprocess.py:58-139): break the polyline where
    heading jumps or gaps occur, upsample each piece with linear interp,
    window into (split/distance+1)-point chunks, and keep every 5th point.
    With `use_native` the C++ helper computes it (data/native.py; a failed
    build raises), else numpy.
    """
    if use_native:
        from infgen_torch.data.native import interpolate_polyline_native
        return interpolate_polyline_native(
            np.asarray(points, np.float64), np.asarray(headings, np.float64),
            distance, split_distance)
    points = np.asarray(points, np.float64)
    headings = np.asarray(headings, np.float64)

    # 1. break into continuous pieces (preprocess.py:60-80)
    dist_lists: List[List[float]] = [[0.0]]
    poly_lists: List[List[np.ndarray]] = [[points[0]]]
    for i in range(1, points.shape[0]):
        d = float(np.linalg.norm(points[i, :2] - points[i - 1, :2]))
        hi, hj = headings[i], headings[i - 1]
        # reference quirk: uses heading[1] in the min() term (preprocess.py:64-65)
        h1 = headings[1] if headings.shape[0] > 1 else headings[0]
        diff = min(abs(max(hi, hj) - min(h1, hj)), abs(max(hi, hj) - min(h1, hj) + math.pi))
        if (diff > 0.1 and d > 3) or d > 10:
            dist_lists.append([0.0])
            poly_lists.append([points[i]])
        else:
            dist_lists[-1].append(dist_lists[-1][-1] + d)
            poly_lists[-1].append(points[i])

    polyline_size = int(split_distance / distance)  # 10
    segments = []
    for dlist, plist in zip(dist_lists, poly_lists):
        if len(dlist) < 2:
            continue
        s = np.asarray(dlist)
        pts = np.asarray(plist)
        new_s = np.concatenate([np.arange(0, s[-1], distance), s[[-1]]])
        new_x = np.interp(new_s, s, pts[:, 0])
        new_y = np.interp(new_s, s, pts[:, 1])
        poly = np.stack([new_x, new_y], axis=-1)

        n = poly.shape[0]
        if n >= polyline_size + 1:
            padding_size = (n - (polyline_size + 1)) % polyline_size
            final_index = (n - (polyline_size + 1)) // polyline_size + 1
        else:
            padding_size = n
            final_index = 0

        theta = np.arctan2(np.diff(poly[:, 1]), np.diff(poly[:, 0]))
        theta = np.concatenate([theta, theta[-1:]])
        poly3 = np.concatenate([poly, theta[:, None]], axis=-1)  # [n, 3]

        chunks = None
        if n >= polyline_size + 1:
            starts = np.arange(final_index) * polyline_size
            chunks = np.stack([poly3[st:st + polyline_size + 1] for st in starts])
            chunks = chunks[:, ::5, :]  # 11 points -> 3 sample points
        if padding_size >= 3:
            tail = poly3[final_index * polyline_size:]
            sel = np.linspace(0, tail.shape[0] - 1, 3).astype(int)
            tail3 = tail[sel][None]
            chunks = tail3 if chunks is None else np.concatenate([chunks, tail3])
        if chunks is not None:
            segments.append(chunks)

    if not segments:
        return None
    return np.concatenate(segments, axis=0)


def tokenize_map_polylines(polylines: List[Dict]) -> Dict[str, np.ndarray]:
    """Split raw map polylines into pt-token segments (host side).

    Each entry of `polylines`: dict with keys
      points [n, 2], headings [n], pt_type int, side int, pl_type int,
      pl_id int, light int.
    Returns per-token arrays incl. 3-sample-point geometry for matching.
    Mirrors TokenProcessor._tokenize_map (preprocess.py:693-760).
    """
    traj, pt_type, side, pl_type, pl_id, light = [], [], [], [], [], []
    chain_id, chain_pos = [], []
    next_chain = 0
    for pl in polylines:
        segs = interpolate_polyline(pl["points"], pl["headings"])
        if segs is None:
            continue
        n = segs.shape[0]
        traj.append(segs)
        pt_type += [pl["pt_type"]] * n
        side += [pl.get("side", 0)] * n
        pl_type += [pl.get("pl_type", 0)] * n
        pl_id += [pl.get("pl_id", next_chain)] * n
        light += [pl.get("light", 0)] * n
        chain_id += [next_chain] * n
        chain_pos += list(range(n))
        next_chain += 1

    if not traj:
        traj_arr = np.zeros((0, 3, 3), np.float32)
    else:
        traj_arr = np.concatenate(traj).astype(np.float32)
    return dict(
        traj_pos=traj_arr[:, :, :2],
        traj_theta=traj_arr[:, 0, 2],
        pt_type=np.asarray(pt_type, np.int32),
        pt_side=np.asarray(side, np.int32),
        pl_type=np.asarray(pl_type, np.int32),
        pl_id=np.asarray(pl_id, np.int32),
        light_type=np.asarray(light, np.int32),
        chain_id=np.asarray(chain_id, np.int32),
        chain_pos=np.asarray(chain_pos, np.int32),
    )


class MapTokenizer:
    """Match pt-token segments against the 1024-entry map vocab.

    Reference: InfGen.match_token_map (model/infgen.py:918-942) — rotate each
    3-point segment into its local frame and argmin L2 distance to the vocab's
    3 sample points; training adds top-8 noise sampling.
    """

    def __init__(self, vocab=None):
        self.vocab = vocab if vocab is not None else load_map_vocab()
        self.sample_pt = self.vocab["sample_pt"]  # [1024, 3, 2]

    def match(self, traj_pos, traj_theta):
        """traj_pos: [N, 3, 2]; traj_theta: [N]. Returns token ids [N] int32."""
        tp = np.asarray(traj_pos, np.float32)
        th = np.asarray(traj_theta, np.float32)
        cos, sin = np.cos(th), np.sin(th)
        rot = np.stack([np.stack([cos, -sin], -1), np.stack([sin, cos], -1)], -2)
        local = np.einsum("npi,nij->npj", tp - tp[:, 0:1], rot)
        sp = np.asarray(self.sample_pt)
        d2 = ((sp[None] - local[:, None]) ** 2).sum((-2, -1))
        return d2.argmin(axis=-1).astype(np.int32)
