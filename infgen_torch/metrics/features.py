"""WOSAC metric features (port of infgen_tpu/metrics/features.py).

The reference's feature extractors as tensor math on whatever device the
inputs lie on:
  - kinematics: linear / angular speed and acceleration (central
    differences, angles wrapped by floor-mod);
  - interaction: signed distance to the nearest other box (Minkowski sums
    of corner-rounded boxes), collisions, time to collision with the
    object in front;
  - placement: per-token-step enter / exit counts and distances to the ego.

Every function takes one scenario: padded [A, T] tensors plus an active-slot
mask [A]. Nothing here leaves the device.
"""

import math
from typing import NamedTuple

import numpy as np
import torch

from infgen_torch.config import ENTER_STATE, EXIT_STATE, SHIFT

EXTREMELY_LARGE_DISTANCE = 1e10
COLLISION_DISTANCE_THRESHOLD = 0.0
CORNER_ROUNDING_FACTOR = 0.7
MAX_HEADING_DIFF = math.radians(75.0)
MAX_HEADING_DIFF_FOR_SMALL_OVERLAP = math.radians(10.0)
SMALL_OVERLAP_THRESHOLD = 0.5
MAXIMUM_TIME_TO_COLLISION = 5.0
CURRENT_TIME_INDEX = 10
N_SIMULATION_STEPS = 80  # WOSAC window length
SECONDS_PER_STEP = 0.1


# ------------------------------------------------------------------ #
# kinematics
# ------------------------------------------------------------------ #

def _wrap(a):
    # floor-mod, as Python's and jnp's `%`: torch.fmod would keep the sign
    # of the dividend and wrap negative angles to (-3pi, -pi]
    return torch.remainder(a + math.pi, 2 * math.pi) - math.pi


def central_diff(t, pad_value):
    pad = torch.full((*t.shape[:-1], 1), pad_value, dtype=t.dtype,
                     device=t.device)
    return torch.cat([pad, (t[..., 2:] - t[..., :-2]) / 2, pad], dim=-1)


def central_logical_and(t, pad_value: bool):
    pad = torch.full((*t.shape[:-1], 1), pad_value, dtype=torch.bool,
                     device=t.device)
    return torch.cat([pad, t[..., 2:] & t[..., :-2], pad], dim=-1)


def _norm_fma(xs):
    """Euclidean norm over the first axis of float32 `xs`, rounded as the
    JAX package's jnp.linalg.norm is on XLA's CPU backend: one fused
    multiply-add per component after the first, i.e. each product exact
    and each sum rounded to float32 (done here in float64, where products
    of float32 values are exact). A last-bit difference in a speed would
    otherwise reach the accelerations amplified by 1 / dt."""
    acc = (xs[0].double() ** 2).float()
    for x in xs[1:]:
        acc = (x.double() ** 2 + acc.double()).float()
    return torch.sqrt(acc)


def _per(x, dt):
    """x / dt for a constant dt as XLA computes it: x times the float32
    reciprocal of dt (x / 0.1 becomes x * 10, which rounds differently)."""
    return x * float(np.float32(1) / np.float32(dt))


def compute_kinematic_features(x, y, z, heading,
                               seconds_per_step=SECONDS_PER_STEP):
    """(linear_speed, linear_accel, angular_speed, angular_accel), NaN-padded.
    Rounded as the JAX package's jitted features are (_norm_fma, _per)."""
    dpos = central_diff(torch.stack([x, y, z]), math.nan)
    linear_speed = _per(_norm_fma(dpos), seconds_per_step)
    linear_accel = _per(central_diff(linear_speed, math.nan),
                        seconds_per_step)
    dh_step = _wrap(central_diff(heading, math.nan) * 2) / 2
    dh = _per(dh_step, seconds_per_step)
    d2h_step = _wrap(central_diff(dh_step, math.nan) * 2) / 2
    d2h = _per(d2h_step, seconds_per_step ** 2)
    return linear_speed, linear_accel, dh, d2h


def compute_kinematic_validity(valid):
    speed_validity = central_logical_and(valid, False)
    accel_validity = central_logical_and(speed_validity, False)
    return speed_validity, accel_validity


# ------------------------------------------------------------------ #
# box geometry
# ------------------------------------------------------------------ #

def box_corners_2d(cx, cy, length, width, heading):
    """The 4 bottom corners of upright boxes, counter-clockwise: [..., 4, 2]."""
    l2, w2 = length * 0.5, width * 0.5
    lx = torch.stack([l2, -l2, -l2, l2], -1)                 # [..., 4]
    ly = torch.stack([w2, w2, -w2, -w2], -1)
    cos, sin = torch.cos(heading)[..., None], torch.sin(heading)[..., None]
    wx = cos * lx - sin * ly + cx[..., None]
    wy = sin * lx + cos * ly + cy[..., None]
    return torch.stack([wx, wy], -1)


def _take(x, idx):
    """x [..., 4, T] at vertex idx [..., 1, T] (broadcast over the leading
    axes) -> [..., 1, T]."""
    shape = torch.broadcast_shapes(x.shape[:-2], idx.shape[:-2])
    return torch.gather(x.expand(*shape, *x.shape[-2:]), -2,
                        idx.expand(*shape, *idx.shape[-2:]))


def _downmost_edge_xy(bx, by):
    """The downmost edge of counter-clockwise boxes, time minor: bx / by
    [..., 4, T] -> (start vertex [..., 1, T], unit direction x, y
    [..., 1, T]). The lowest vertex is the first of equal ones."""
    idx = torch.argmin(by, dim=-2, keepdim=True)
    sx, sy = _take(bx, idx), _take(by, idx)
    nxt = (idx + 1) % 4
    ex = _take(bx, nxt) - sx
    ey = _take(by, nxt) - sy
    n = torch.sqrt(ex * ex + ey * ey)
    return idx, ex / n, ey / n


_MINK_ORDER1 = (0, 0, 1, 1, 2, 2, 3, 3)
_MINK_ORDER2 = (0, 1, 1, 2, 2, 3, 3, 0)


def _select_vertex(bx, order):
    """bx [..., 4, T] (broadcastable), order [..., 8, T] in {0..3} ->
    [..., 8, T]: the vertex each entry of `order` names."""
    out = bx[..., 3:4, :]
    for k in (2, 1, 0):
        out = torch.where(order == k, bx[..., k:k + 1, :], out)
    return out


def _minkowski_sum_xy(b1x, b1y, s1, d1x, d1y, b2x, b2y, s2, d2x, d2y):
    """Minkowski sum of two counter-clockwise boxes -> an 8-gon [..., 8, T].
    Each box's downmost edge (s, d) comes precomputed: it depends on one
    box only."""
    cross = d1x * d2y - d1y * d2x                        # [..., 1, T]
    cond = cross >= 0.0
    o1 = torch.tensor(_MINK_ORDER1, device=b1x.device)[:, None]
    o2 = torch.tensor(_MINK_ORDER2, device=b1x.device)[:, None]
    box1_order = (torch.where(cond, o2, o1) + s1) % 4    # [..., 8, T]
    box2_order = (torch.where(cond, o1, o2) + s2) % 4
    px = _select_vertex(b1x, box1_order) + _select_vertex(b2x, box2_order)
    py = _select_vertex(b1y, box1_order) + _select_vertex(b2y, box2_order)
    return px, py


def _signed_distance_origin_xy(px, py):
    """Signed distance of the origin to convex polygons px / py [..., P, T]
    (negative inside) -> [..., T]."""
    ex = torch.roll(px, -1, dims=-2) - px
    ey = torch.roll(py, -1, dims=-2) - py
    edge_len = torch.sqrt(ex * ex + ey * ey)
    eps = torch.finfo(px.dtype).eps
    tx, ty = ex / (edge_len + eps), ey / (edge_len + eps)
    nx, ny = -ty, tx                                     # left normal
    # from each vertex to the origin: (-px, -py)
    vert_dist = torch.sqrt(px * px + py * py)
    perp = nx * px + ny * py                             # (-n) . v2q
    is_inside = (perp <= 0).all(dim=-2)
    proj = (tx * -px + ty * -py) / (edge_len + eps)
    on_edge = (proj >= 0) & (proj <= 1)
    edge_dist = torch.where(on_edge, torch.abs(perp), math.inf)
    min_dist = torch.minimum(edge_dist.amin(-2), vert_dist.amin(-2))
    return torch.where(is_inside, -min_dist, min_dist)


# ------------------------------------------------------------------ #
# interactive features
# ------------------------------------------------------------------ #

def compute_distance_to_nearest_object(cx, cy, length, width, heading, valid,
                                       slot_mask,
                                       corner_rounding=CORNER_ROUNDING_FACTOR,
                                       eval_chunk=32):
    """[A, T] signed distance of each box to the nearest other active box.

    The pair tensors are [Ac, A, 8, T] (time minor) for Ac = `eval_chunk`
    evaluated agents at a time. Eager PyTorch keeps every intermediate of a
    chunk, so the peak is a few dozen such tensors: at the flagship's A =
    128, T = 311 one is 41 MB in fp32, where the whole [A, A, 8, T] pair
    set would be 163 MB each.
    """
    shrink = torch.minimum(length, width) * corner_rounding / 2.0
    l_s = length - 2 * shrink
    w_s = width - 2 * shrink
    corners = box_corners_2d(cx, cy, l_s[:, None] * torch.ones_like(cx),
                             w_s[:, None] * torch.ones_like(cx),
                             heading)                     # [A, T, 4, 2]
    bx = corners[..., 0].transpose(-1, -2)                # [A, 4, T]
    by = corners[..., 1].transpose(-1, -2)

    # each box's downmost edge, once per agent; the "other" box enters the
    # Minkowski sum negated
    s1, d1x, d1y = _downmost_edge_xy(bx, by)              # [A, 1, T]
    s2, d2x, d2y = _downmost_edge_xy(-bx, -by)

    A, T = cx.shape
    row_valid = valid & slot_mask[:, None]                # [A, T]
    ids = torch.arange(A, device=cx.device)
    out = []
    for a0 in range(0, A, eval_chunk):
        e = slice(a0, a0 + eval_chunk)
        # eval rows [Ac, 1, ...] x all rows [1, A, ...]
        px, py = _minkowski_sum_xy(
            bx[e, None], by[e, None], s1[e, None], d1x[e, None],
            d1y[e, None], -bx[None], -by[None], s2[None], d2x[None],
            d2y[None])                                    # [Ac, A, 8, T]
        sd = _signed_distance_origin_xy(px, py)           # [Ac, A, T]
        sd = sd - shrink[e, None, None] - shrink[None, :, None]
        self_pair = (ids[e, None] == ids[None])[..., None]
        sd = sd + self_pair * EXTREMELY_LARGE_DISTANCE
        pair_valid = row_valid[e, None] & row_valid[None]
        sd = torch.where(pair_valid, sd, EXTREMELY_LARGE_DISTANCE)
        out.append(sd.amin(dim=1))                        # [Ac, T]
    return torch.cat(out, 0)


def compute_time_to_collision(cx, cy, length, width, heading, valid, slot_mask,
                              seconds_per_step=SECONDS_PER_STEP):
    """[A, T] time to collision with the object in front."""
    speed = compute_kinematic_features(cx, cy, torch.zeros_like(cx), heading,
                                       seconds_per_step)[0]     # [A, T]
    # [T, A, ...] layout
    tr = lambda x: x.transpose(0, 1)
    xy = torch.stack([tr(cx), tr(cy)], -1)                      # [T, A, 2]
    sizes = torch.stack([length[:, None].expand(cx.shape),
                         width[:, None].expand(cx.shape)], -1).transpose(0, 1)
    yaw = tr(heading)
    v = tr(valid & slot_mask[:, None])

    yaw_diff = torch.abs(yaw[:, None, :] - yaw[:, :, None])     # [T, Ae, Ao]
    ydc, yds = torch.cos(yaw_diff), torch.sin(yaw_diff)
    half = sizes[:, None] / 2                                   # [T, 1, Ao, 2]
    other_long = (half * torch.abs(torch.stack([ydc, yds], -1))).sum(-1)
    other_lat = (half * torch.abs(torch.stack([yds, ydc], -1))).sum(-1)

    rel = xy[:, None, :] - xy[:, :, None, :]                    # [T, Ae, Ao, 2]
    cos_e, sin_e = torch.cos(-yaw), torch.sin(-yaw)
    rx = cos_e[:, :, None] * rel[..., 0] - sin_e[:, :, None] * rel[..., 1]
    ry = sin_e[:, :, None] * rel[..., 0] + cos_e[:, :, None] * rel[..., 1]

    long_d = rx - sizes[:, :, None, 0] / 2 - other_long
    lat_ov = torch.abs(ry) - sizes[:, :, None, 1] / 2 - other_lat

    follow = (long_d > 0) & (yaw_diff <= MAX_HEADING_DIFF) & (lat_ov < 0) & (
        (lat_ov < -SMALL_OVERLAP_THRESHOLD) |
        (yaw_diff <= MAX_HEADING_DIFF_FOR_SMALL_OVERLAP))
    vmask = v[:, None, :] & follow
    masked_long = long_d + (1.0 - vmask.to(long_d.dtype)) \
        * EXTREMELY_LARGE_DISTANCE
    # many masked entries round to exactly 1e10 in fp32: the first of equal
    # ones is taken, as jnp.argmin takes it, and its time is 5.0 either way
    ahead = masked_long.argmin(-1)                              # [T, Ae]
    dist_ahead = torch.gather(masked_long, -1, ahead[..., None])[..., 0]
    speed_t = tr(speed)                                         # [T, A]
    speed_ahead = torch.gather(speed_t, -1, ahead)
    rel_speed = speed_t - speed_ahead
    ttc = torch.where(rel_speed > 0,
                      torch.clamp(dist_ahead / rel_speed,
                                  max=MAXIMUM_TIME_TO_COLLISION),
                      MAXIMUM_TIME_TO_COLLISION)
    return ttc.transpose(0, 1)


# ------------------------------------------------------------------ #
# placement features
# ------------------------------------------------------------------ #

def _placement_states(state, av_index, slot_mask):
    """`state` with the ego's row and inactive slots set to -1."""
    ego = (torch.arange(state.shape[0], device=state.device)
           == av_index)[:, None]
    st = torch.where(ego, -1, state)
    return torch.where(slot_mask[:, None], st, -1)


def compute_num_placement(state, av_index, slot_mask):
    """Per-token-step enter / exit counts, the ego excluded."""
    st = _placement_states(state, av_index, slot_mask)
    return (st == ENTER_STATE).sum(0), (st == EXIT_STATE).sum(0)


def compute_distance_placement(position, state, av_index, slot_mask):
    """Per-agent enter / exit distance to the ego."""
    st = _placement_states(state, av_index, slot_mask)
    dist = torch.linalg.vector_norm(position - position[av_index][None],
                                    dim=-1)
    # a select where the JAX package multiplies by the bool (XLA makes the
    # product a select): a NaN position counts as 0 off its enter / exit
    return (torch.where(st == ENTER_STATE, dist, 0.0),
            torch.where(st == EXIT_STATE, dist, 0.0))


# ------------------------------------------------------------------ #
# bundle
# ------------------------------------------------------------------ #

class MetricFeatures(NamedTuple):
    """Future-horizon features. 10 Hz tensors are [A, T_future];
    token-rate placement tensors are [., T_future / SHIFT]."""

    valid: torch.Tensor
    linear_speed: torch.Tensor
    linear_acceleration: torch.Tensor
    angular_speed: torch.Tensor
    angular_acceleration: torch.Tensor
    distance_to_nearest_object: torch.Tensor
    collision_per_step: torch.Tensor
    time_to_collision: torch.Tensor
    distance_to_road_edge: torch.Tensor  # [A, T_future]
    offroad_per_step: torch.Tensor       # [A, T_future] bool
    num_placement: torch.Tensor          # [1, T_tok]
    num_removement: torch.Tensor         # [1, T_tok]
    distance_placement: torch.Tensor     # [A, T_tok]
    distance_removement: torch.Tensor    # [A, T_tok]


def compute_metric_features(traj_xy, traj_heading, valid, length, width,
                            slot_mask, av_index, token_pos, token_state,
                            road_edge_polylines=None, road_edge_cyclic=None,
                            traj_z=None) -> MetricFeatures:
    """Features of one rollout or log.

    traj_xy [A, T10, 2] the whole 10 Hz trajectory (history and future);
    valid [A, T10]; length / width [A]; token_pos [A, T_tok, 2];
    token_state [A, T_tok].

    traj_z [A, T10]: elevation for 3D linear speed and acceleration. Pass
    the logged z for log features and omit it for rollouts, whose
    kinematics are planar (the reference's simulated z is 0).

    road_edge_polylines [L, S, 4] and road_edge_cyclic [L]
    (map_distance.pack_polylines, as tensors on the device) give
    distance_to_road_edge and offroad_per_step; without them both are
    filled with on-road values.
    """
    x, y = traj_xy[..., 0], traj_xy[..., 1]
    z = torch.zeros_like(x) if traj_z is None else traj_z
    cut = CURRENT_TIME_INDEX + 1

    ls, la, as_, aa = compute_kinematic_features(x, y, z, traj_heading)
    ls, la, as_, aa = (t[:, cut:] for t in (ls, la, as_, aa))

    d_nearest = compute_distance_to_nearest_object(
        x, y, length, width, traj_heading, valid, slot_mask)[:, cut:]
    collision = d_nearest < COLLISION_DISTANCE_THRESHOLD

    ttc = compute_time_to_collision(x, y, length, width, traj_heading, valid,
                                    slot_mask)[:, cut:]

    if road_edge_polylines is not None and road_edge_polylines.shape[0] > 0:
        from infgen_torch.metrics.map_distance import (
            OFFROAD_DISTANCE_THRESHOLD,
            compute_distance_to_road_edge,
        )
        d_road = compute_distance_to_road_edge(
            x, y, length, width, traj_heading, valid, slot_mask,
            road_edge_polylines, road_edge_cyclic)[:, cut:]
        offroad = d_road > OFFROAD_DISTANCE_THRESHOLD
    else:
        d_road = torch.full_like(ls, -EXTREMELY_LARGE_DISTANCE)
        offroad = torch.zeros_like(collision)

    n_place, n_remove = compute_num_placement(token_state, av_index,
                                              slot_mask)
    tok_cut = CURRENT_TIME_INDEX // SHIFT
    d_place, d_remove = compute_distance_placement(token_pos, token_state,
                                                   av_index, slot_mask)
    return MetricFeatures(
        valid=valid[:, cut:] & slot_mask[:, None],
        linear_speed=ls, linear_acceleration=la,
        angular_speed=as_, angular_acceleration=aa,
        distance_to_nearest_object=d_nearest,
        collision_per_step=collision,
        time_to_collision=ttc,
        distance_to_road_edge=d_road,
        offroad_per_step=offroad,
        num_placement=n_place[None, tok_cut:],
        num_removement=n_remove[None, tok_cut:],
        distance_placement=d_place[:, tok_cut:],
        distance_removement=d_remove[:, tok_cut:],
    )


def concat_features(parts) -> MetricFeatures:
    """Several rollouts' features as one set, along the agent axis (the
    reference stacks a scenario's rollouts so)."""
    return MetricFeatures(*(torch.cat(xs, 0) for xs in zip(*parts)))


def unfold_axis(x, size: int, step: int):
    """Sliding windows over the last axis -> [..., n_window, size]."""
    return x.unfold(-1, size, step)


def unfold_features(f: MetricFeatures, size: int = N_SIMULATION_STEPS,
                    step: int = SHIFT) -> MetricFeatures:
    """Sliding windows along time -> [..., n_window, size].

    The long-horizon form: placement features use token-rate windows
    (size // SHIFT, step // SHIFT). Windows clamp to the available horizon
    for short rollouts.
    """
    size = min(size, int(f.valid.shape[-1]))
    token_rate = ("num_placement", "num_removement", "distance_placement",
                  "distance_removement")
    return MetricFeatures(**{
        k: (unfold_axis(v, size // SHIFT, step // SHIFT) if k in token_rate
            else unfold_axis(v, size, step))
        for k, v in f._asdict().items()})
