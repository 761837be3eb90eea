"""Motion vectors, relative-geometry sentinels and the training forward's
dense mask / geometry builders (port of infgen_tpu/model/edges.py).

Sentinel handling of invalid steps (agent_decoder.py:591-601 of the
reference, as trained):
  key invalid, query valid   -> rel_pos = -motion_gap, rel_head = -heading_gap
  key valid,   query invalid -> rel_pos = +motion_gap, rel_head unchanged
  both invalid               -> rel_pos = invalid_motion, rel_head = invalid_head
"""

from typing import NamedTuple

import torch
import torch.nn.functional as F

from infgen_torch.config import ENTER_STATE, EXIT_STATE, INVALID_STATE
from infgen_torch.ops.neighbors import topk_neighbors
from infgen_torch.utils.geometry import angle_between_2d_vectors, wrap_angle

MOTION_GAP = 1.0
HEADING_GAP = 1.0
INVALID_MOTION_VALUE = -2.0
INVALID_HEAD_VALUE = -2.0


def build_motion_vectors(pos, head, state):
    """Per-step motion vector with invalid-transition sentinels.

    pos [..., A, T, 2]; head [..., A, T]; state [..., A, T] (leading dims:
    the rollout's lanes). Returns (motion [..., A, T, 2], head_vector
    [..., A, T, 2]).
    """
    motion = torch.cat([torch.zeros_like(pos[..., :1, :]),
                        pos[..., 1:, :] - pos[..., :-1, :]], dim=-2)
    is_invalid = state == INVALID_STATE
    motion = torch.where(is_invalid[..., None], INVALID_MOTION_VALUE, motion)

    prev_invalid = torch.roll(is_invalid, 1, dims=-1)
    became_valid = prev_invalid & ~is_invalid
    became_valid[..., 0] = state[..., 0] == ENTER_STATE
    motion = torch.where(became_valid[..., None], MOTION_GAP, motion)

    became_invalid = ~prev_invalid & is_invalid
    became_invalid[..., 0] = False
    motion = torch.where(became_invalid[..., None], -MOTION_GAP, motion)

    head_vector = torch.stack([torch.cos(head), torch.sin(head)], dim=-1)
    return motion, head_vector


def _apply_invalid_sentinels(rel_pos, rel_head, inv_key, inv_query):
    """inv_key / inv_query broadcastable to rel_head's shape."""
    rel_pos = torch.where((inv_key & ~inv_query)[..., None], -MOTION_GAP,
                          rel_pos)
    rel_pos = torch.where((~inv_key & inv_query)[..., None], MOTION_GAP,
                          rel_pos)
    rel_head = torch.where(inv_key & ~inv_query, -HEADING_GAP, rel_head)
    # no rel_head rewrite for (valid key, invalid query): the reference's
    # assignment is dead code (`==` typo, agent_decoder.py:598)
    both = inv_key & inv_query
    rel_pos = torch.where(both[..., None], INVALID_MOTION_VALUE, rel_pos)
    rel_head = torch.where(both, INVALID_HEAD_VALUE, rel_head)
    return rel_pos, rel_head


# --------------------------------------------------------------------- #
# training builders: dense masks and relative geometry over [A, T]
# --------------------------------------------------------------------- #

class TemporalEdges(NamedTuple):
    mask: torch.Tensor   # [A, Tq, Tk] bool
    r_raw: torch.Tensor  # [A, Tq, Tk, 4]


def build_temporal_edges(pos, head, state, head_vector, hist_mask,
                         time_span_steps: int, query_mask=None
                         ) -> TemporalEdges:
    """Per-agent causal-window temporal attention.

    hist_mask [A, T]: attendable key steps (after the bos clamp and the
    random drop); query_mask [A, T]: optional restriction of the queries.
    """
    A, T = state.shape
    q_mask = hist_mask if query_mask is None else query_mask
    tq = torch.arange(T, device=pos.device)
    gap = tq[:, None] - tq[None, :]
    window = (gap > 0) & (gap <= time_span_steps)
    mask = hist_mask[:, None, :] & q_mask[:, :, None] & window[None]

    rel_pos = pos[:, None, :, :] - pos[:, :, None, :]   # key - query
    rel_head = wrap_angle(head[:, None, :] - head[:, :, None])
    inv = state == INVALID_STATE
    rel_pos, rel_head = _apply_invalid_sentinels(
        rel_pos, rel_head, inv[:, None, :], inv[:, :, None])
    r = torch.stack([
        torch.linalg.norm(rel_pos, dim=-1),
        angle_between_2d_vectors(head_vector[:, :, None, :], rel_pos),
        rel_head,
        (tq[None, :] - tq[:, None])[None].expand(A, T, T).to(pos.dtype),
    ], dim=-1)
    return TemporalEdges(mask=mask, r_raw=r)


class StepEdges(NamedTuple):
    mask: torch.Tensor   # [T, Q, K] bool
    r_raw: torch.Tensor  # [T, Q, K, 3]


def build_a2a_edges(pos, head, state, head_vector, node_mask, radius: float,
                    query_mask=None, key_mask=None) -> StepEdges:
    """Agent-agent attention per step within `radius`; node_mask [A, T]
    applies to both sides. Returns [T, A(query), A(key)] layouts."""
    pos_t = pos.transpose(0, 1)
    head_t = head.transpose(0, 1)
    hv_t = head_vector.transpose(0, 1)
    nm_t = node_mask.transpose(0, 1)
    qm = nm_t if query_mask is None else query_mask.transpose(0, 1)
    km = nm_t if key_mask is None else key_mask.transpose(0, 1)

    d2 = ((pos_t[:, :, None] - pos_t[:, None, :]) ** 2).sum(-1)
    A = pos.shape[0]
    eye = torch.eye(A, dtype=torch.bool, device=pos.device)
    mask = (d2 <= radius * radius) & ~eye[None]
    mask = mask & km[:, None, :] & qm[:, :, None]

    rel_pos = pos_t[:, None, :, :] - pos_t[:, :, None, :]
    rel_head = wrap_angle(head_t[:, None, :] - head_t[:, :, None])
    inv = (state == INVALID_STATE).transpose(0, 1)
    rel_pos, rel_head = _apply_invalid_sentinels(
        rel_pos, rel_head, inv[:, None, :], inv[:, :, None])
    r = torch.stack([
        torch.linalg.norm(rel_pos, dim=-1),
        angle_between_2d_vectors(hv_t[:, :, None, :], rel_pos),
        rel_head,
    ], dim=-1)
    return StepEdges(mask=mask, r_raw=r)


class GatherEdges(NamedTuple):
    idx: torch.Tensor    # [A, T, k] neighbour indices into the key set
    mask: torch.Tensor   # [A, T, k]
    r_raw: torch.Tensor  # [A, T, k, 3]


def build_pl2a_edges(pos, head, state, head_vector, query_mask, pt_pos,
                     pt_orient, pt_mask, radius: float, k: int
                     ) -> GatherEdges:
    """Map -> agent: the k nearest map tokens within `radius` per (agent,
    step); invalid-state queries get sentinel geometry."""
    A, T, _ = pos.shape
    k = min(k, pt_pos.shape[0])
    idx, valid = topk_neighbors(pos.reshape(A * T, 2), pt_pos, k, radius,
                                key_mask=pt_mask)
    idx = idx.reshape(A, T, k)
    valid = valid.reshape(A, T, k) & query_mask[..., None]

    rel_pos = pt_pos[idx] - pos[:, :, None, :]
    rel_orient = wrap_angle(pt_orient[idx] - head[:, :, None])
    inv = state == INVALID_STATE
    rel_pos = torch.where(inv[..., None, None], MOTION_GAP, rel_pos)
    rel_orient = torch.where(inv[..., None], HEADING_GAP, rel_orient)
    r = torch.stack([
        torch.linalg.norm(rel_pos, dim=-1),
        angle_between_2d_vectors(head_vector[:, :, None, :], rel_pos),
        rel_orient,
    ], dim=-1)
    return GatherEdges(idx=idx, mask=valid, r_raw=r)


def build_a2sa_edges(pos, head, state, head_vector, key_mask, seed_pos,
                     seed_head, seed_head_vector, radius: float,
                     seq_mask=None) -> StepEdges:
    """Agents -> seed queries per step within `radius` of the seed.

    pos [A, T, 2]; seed_pos [S, T, 2]; seq_mask [T, S, A] optional
    insertion-order mask. Layout [T, S(query), A(key)]. Seeds are
    invalid-state queries attending valid keys: raw geometry, no sentinel
    rewrite on the seed side."""
    pos_k = pos.transpose(0, 1)
    head_k = head.transpose(0, 1)
    sp = seed_pos.transpose(0, 1)
    sh = seed_head.transpose(0, 1)
    shv = seed_head_vector.transpose(0, 1)

    d2 = ((sp[:, :, None] - pos_k[:, None, :]) ** 2).sum(-1)
    mask = (d2 <= radius * radius) & key_mask.transpose(0, 1)[:, None, :]
    if seq_mask is not None:
        mask = mask & seq_mask
    rel_pos = pos_k[:, None, :, :] - sp[:, :, None, :]
    rel_head = wrap_angle(head_k[:, None, :] - sh[:, :, None])
    r = torch.stack([
        torch.linalg.norm(rel_pos, dim=-1),
        angle_between_2d_vectors(shv[:, :, None, :], rel_pos),
        rel_head,
    ], dim=-1)
    return StepEdges(mask=mask, r_raw=r)


def build_pl2sa_edges(seed_pos, seed_head, seed_head_vector, pt_pos,
                      pt_orient, pt_mask, radius: float):
    """Map -> seed keys per step, shared by every seed (all sit on the ego
    trajectory seed_pos [T, 2]). Returns (mask [T, P], r_raw [T, P, 3])."""
    d2 = ((seed_pos[:, None, :] - pt_pos[None]) ** 2).sum(-1)
    mask = (d2 <= radius * radius) & pt_mask[None]
    rel_pos = pt_pos[None] - seed_pos[:, None, :]
    rel_orient = wrap_angle(pt_orient[None] - seed_head[:, None])
    r = torch.stack([
        torch.linalg.norm(rel_pos, dim=-1),
        angle_between_2d_vectors(seed_head_vector[:, None, :], rel_pos),
        rel_orient,
    ], dim=-1)
    return mask, r


def build_seq_mask(sort_indices, av_index, num_seed: int, num_agents: int):
    """Insertion-order mask [T, S, A]: seed s may attend agent a at step t
    iff a is not at insertion order >= s (every non-entering agent, the
    ones inserted before s), and always the AV."""
    onehot = F.one_hot(sort_indices.long(), num_agents)     # [A(order), T, A]
    suffix = torch.flip(torch.cumsum(torch.flip(onehot, [0]), 0), [0])
    mask = ~(suffix[:num_seed] > 0)                          # [S, T, A]
    mask = mask.permute(1, 0, 2).clone()
    mask[:, :, av_index.long()] = True
    return mask


def training_hist_mask(raw_valid, state, generator=None, drop=None,
                       num_drop: int = 10):
    """Temporal key mask for training: ones outside the motion window, raw
    validity inside; clamped to t >= bos; then `num_drop` random steps
    dropped per agent. The drop is `drop` ([A, num_drop] step indices)
    when given, else drawn from `generator`; with neither, nothing is
    dropped (the deterministic forward)."""
    A, T = state.shape
    dev = state.device
    is_bos = state == ENTER_STATE
    is_eos = state == EXIT_STATE
    bos = torch.where(is_bos.any(1), is_bos.int().argmax(1), 0)
    eos = torch.where(is_eos.any(1), is_eos.int().argmax(1), T - 1)
    t = torch.arange(T, device=dev)[None]
    motion_win = (t > bos[:, None]) & (t <= eos[:, None])
    hist = torch.where(motion_win, raw_valid, True)
    hist = hist & (t >= bos[:, None])
    if drop is None and generator is not None:
        drop = torch.randint(0, T, (A, num_drop), generator=generator,
                             device=generator.device).to(dev)
    if drop is not None:
        hist = hist & ~F.one_hot(drop.long(), T).bool().any(1)
    return hist
