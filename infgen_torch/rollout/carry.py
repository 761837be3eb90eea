"""The closed-loop rollout's state between token steps (rollout/closed_loop.py),
kept apart from the model code so that an exported rollout's loader
(rollout/export.py) can name it without importing the model."""

from typing import NamedTuple

import torch


class RolloutCarry(NamedTuple):
    pos: torch.Tensor          # [B, A, Ti, 2]
    head: torch.Tensor         # [B, A, Ti]
    state: torch.Tensor        # [B, A, Ti] int32
    token: torch.Tensor        # [B, A, Ti] int32
    grid: torch.Tensor         # [B, A, Ti] int32
    valid: torch.Tensor        # [B, A, Ti] bool (agent_valid_mask)
    interact: torch.Tensor     # [B, A, Ti] bool
    temporal: torch.Tensor     # [B, A, Ti] bool
    slot_active: torch.Tensor  # [B, A] bool
    type_: torch.Tensor        # [B, A] int32
    shape: torch.Tensor        # [B, A, 3]
    raw_feat: torch.Tensor     # [B, A, Ti, D]
    cache: torch.Tensor        # [L, B, A, Ti, D]
    pred_traj: torch.Tensor    # [B, A, R, 2] 10 Hz
    pred_head: torch.Tensor    # [B, A, R]
    pred_state: torch.Tensor   # [B, A, R]
    n_inserted: torch.Tensor   # [B] int32
