"""Distance-to-road-edge and offroad features (port of
infgen_tpu/metrics/map_distance.py).

The signed 2D distance of every box corner to the nearest road-edge
polyline segment (counter-clockwise winding: negative is on the road), with
the reference's z-stretch to tell overpasses apart and its handling of
cyclic polylines. The metametric leaves these features out, as the
reference does; they feed the offroad rate.

Polylines are packed host-side into a fixed-shape [n_poly, max_len, 4]
array (xyz and validity) by `pack_polylines`; the distances run on the
device of the query points.
"""

from typing import List

import numpy as np
import torch

from infgen_torch.metrics.features import box_corners_2d

EXTREMELY_LARGE_DISTANCE = 1e10
OFFROAD_DISTANCE_THRESHOLD = 0.0
_CYCLIC_TOLERANCE_M2 = 1.0
_Z_STRETCH = 3.0
# query points per chunk of signed_distance_to_polylines: a chunk of Pc
# points against L x S segments makes [Pc, L, S, 3] fp32 intermediates;
# this bounds Pc * L * S to 2^24 (each 3-vector tensor 201 MB, each scalar
# one 67 MB)
POINT_CHUNK_ELEMENTS = 1 << 24


def pack_polylines(polylines: List[np.ndarray]):
    """[n_poly, max_len, 4] xyz+valid array and cyclic flags (host side)."""
    polys = [np.asarray(p, np.float32) for p in polylines if len(p) >= 2]
    if not polys:
        return np.zeros((0, 2, 4), np.float32), np.zeros((0,), bool)
    max_len = max(p.shape[0] for p in polys)
    packed = np.zeros((len(polys), max_len, 4), np.float32)
    cyclic = np.zeros(len(polys), bool)
    for i, p in enumerate(polys):
        if p.shape[1] == 2:
            p = np.concatenate([p, np.zeros((p.shape[0], 1), np.float32)], -1)
        packed[i, :p.shape[0], :3] = p[:, :3]
        packed[i, :p.shape[0], 3] = 1.0
        cyclic[i] = ((p[0] - p[-1]) ** 2).sum() < _CYCLIC_TOLERANCE_M2
    return packed, cyclic


def road_edge_polylines_from_map(map_data, pt_type_min: int = 14,
                                 pt_type_max: int = 16):
    """Road-edge polylines rebuilt from a scenario's pt tokens (host side):
    the 5 m token chains (chain_id / chain_pos order) of pt_type 14..16,
    the road-edge sub-types. Returns `pack_polylines` output."""
    pt_type = np.asarray(map_data.pt_type)
    mask = np.asarray(map_data.mask)
    chain_id = np.asarray(map_data.chain_id)
    chain_pos = np.asarray(map_data.chain_pos)
    pos = np.asarray(map_data.position)
    sel = mask & (pt_type >= pt_type_min) & (pt_type <= pt_type_max)
    polys = []
    for c in np.unique(chain_id[sel]):
        idx = np.nonzero(sel & (chain_id == c))[0]
        order = idx[np.argsort(chain_pos[idx])]
        if len(order) >= 2:
            polys.append(pos[order])
    return pack_polylines(polys)


def pad_packed_polylines(packed, cyclic, round_polys: int = 8,
                         round_len: int = 32):
    """Round the packed shape up to multiples, so that scenarios with
    different road-edge counts share few shapes."""
    L, S, _ = packed.shape
    Lp = max(((L + round_polys - 1) // round_polys) * round_polys, round_polys)
    Sp = max(((S + round_len - 1) // round_len) * round_len, round_len)
    out = np.zeros((Lp, Sp, 4), np.float32)
    out[:L, :S] = packed
    cyc = np.zeros(Lp, bool)
    cyc[:L] = cyclic
    return out, cyc


def packed_road_edges(map_data):
    """(packed, cyclic) road-edge arrays for `compute_metric_features`, or
    (None, None) when the scenario has no road edge. Host side."""
    packed, cyclic = road_edge_polylines_from_map(map_data)
    if packed.shape[0] == 0:
        return None, None
    return pad_packed_polylines(packed, cyclic)


def _signed_distance_chunk(xyzs, starts, s2e, seg_valid, prior_valid,
                           next_valid, convex, cyclic, stretch):
    """signed_distance_to_polylines for one chunk of query points."""
    P = xyzs.shape[0]
    s2p = xyzs[:, None, None, :] - starts                # [P, L, S, 3]

    dot2 = lambda a, b: a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
    cross2 = lambda a, b: a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]

    num = dot2(s2p, s2e)
    den = dot2(s2e, s2e)
    rel_t = torch.where(den != 0, num / torch.where(den != 0, den, 1.0), 0.0)
    n = torch.sign(cross2(s2p, s2e))

    seg2pt = s2p - s2e * torch.clamp(rel_t, 0.0, 1.0)[..., None]
    d3 = torch.linalg.vector_norm(seg2pt * stretch, dim=-1)
    d2 = torch.linalg.vector_norm(seg2pt[..., :2], dim=-1)

    cyc = cyclic[None, :, None]
    n_prior = torch.cat([torch.where(cyc, n[:, :, -1:], n[:, :, :1]),
                         n[:, :, :-1]], dim=-1)
    n_next = torch.cat([n[:, :, 1:],
                        torch.where(cyc, n[:, :, :1], n[:, :, -1:])], dim=-1)
    sign_before = torch.where(convex[..., :-1], torch.maximum(n, n_prior),
                              torch.minimum(n, n_prior))
    sign_after = torch.where(convex[..., 1:], torch.maximum(n, n_next),
                             torch.minimum(n, n_next))
    sign = torch.where((rel_t < 0) & prior_valid, sign_before,
                       torch.where((rel_t > 1) & next_valid, sign_after, n))

    d3 = torch.where(seg_valid, d3, EXTREMELY_LARGE_DISTANCE).reshape(P, -1)
    d2 = torch.where(seg_valid, d2, EXTREMELY_LARGE_DISTANCE).reshape(P, -1)
    idx = torch.argmin(d3, dim=-1, keepdim=True)
    return (torch.gather(sign.reshape(P, -1), 1, idx)[:, 0]
            * torch.gather(d2, 1, idx)[:, 0])


def signed_distance_to_polylines(xyzs, polylines, is_cyclic=None,
                                 z_stretch: float = 1.0,
                                 chunk_elements: int = POINT_CHUNK_ELEMENTS):
    """Signed 2D distance from query points to the polyline boundary.

    xyzs [P, 3]; polylines [L, S+1, 4]; is_cyclic [L] bool. The points run
    in chunks of at most `chunk_elements // (L * S)`; each point's distance
    reads its own row only, so the result does not depend on the chunk.
    """
    L, S1, _ = polylines.shape
    S = S1 - 1
    valid_pt = polylines[:, :, 3] > 0
    seg_valid = valid_pt[:, :-1] & valid_pt[:, 1:]                 # [L, S]
    if is_cyclic is None:
        is_cyclic = torch.zeros(L, dtype=torch.bool, device=xyzs.device)
    cyc = is_cyclic[:, None]

    starts = polylines[None, :, :-1, :3]
    s2e = polylines[None, :, 1:, :3] - starts                      # [1, L, S, 3]
    s2e_pad = torch.cat([s2e[:, :, -1:, :2], s2e[..., :2],
                         s2e[:, :, :1, :2]], dim=-2)
    a, b = s2e_pad[:, :, :-1], s2e_pad[:, :, 1:]
    convex = (a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]) > 0   # [1, L, S+1]
    prior_valid = torch.cat([torch.where(cyc, seg_valid[:, -1:],
                                         seg_valid[:, :1]),
                             seg_valid[:, :-1]], dim=-1)
    next_valid = torch.cat([seg_valid[:, 1:],
                            torch.where(cyc, seg_valid[:, :1],
                                        seg_valid[:, -1:])], dim=-1)
    stretch = torch.tensor([1.0, 1.0, z_stretch], dtype=polylines.dtype,
                           device=polylines.device)

    pc = max(1, chunk_elements // max(L * S, 1))
    return torch.cat([
        _signed_distance_chunk(xyzs[p0:p0 + pc], starts, s2e, seg_valid,
                               prior_valid, next_valid, convex, is_cyclic,
                               stretch)
        for p0 in range(0, xyzs.shape[0], pc)])


def compute_distance_to_road_edge(cx, cy, length, width, heading, valid,
                                  slot_mask, polylines, is_cyclic):
    """[A, T] signed distance of each box's most off-road corner (z = 0)."""
    A, T = cx.shape
    corners = box_corners_2d(cx, cy, length[:, None].expand(A, T),
                             width[:, None].expand(A, T),
                             heading)                             # [A, T, 4, 2]
    flat = corners.reshape(A * T * 4, 2)
    xyz = torch.cat([flat, torch.zeros_like(flat[:, :1])], -1)
    sd = signed_distance_to_polylines(xyz, polylines, is_cyclic, _Z_STRETCH)
    sd = sd.reshape(A, T, 4).amax(-1)
    ok = valid & slot_mask[:, None]
    return torch.where(ok, sd, -EXTREMELY_LARGE_DISTANCE)
