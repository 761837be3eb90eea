"""Motion-vector and relative-geometry sentinels the rollout uses (port of
the rollout part of infgen_tpu/model/edges.py).

Sentinel handling of invalid steps (agent_decoder.py:591-601 of the
reference, as trained):
  key invalid, query valid   -> rel_pos = -motion_gap, rel_head = -heading_gap
  key valid,   query invalid -> rel_pos = +motion_gap, rel_head unchanged
  both invalid               -> rel_pos = invalid_motion, rel_head = invalid_head
"""

import torch

from infgen_torch.config import ENTER_STATE, INVALID_STATE

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
