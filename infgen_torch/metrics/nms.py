"""Trajectory-mode NMS helpers (port of infgen_tpu/metrics/nms.py; reference
infgen/utils/metrics.py:143-314).

Greedy farthest-goal mode selection over predicted trajectory sets:
repeatedly pick the highest-scoring mode, then suppress every mode whose
endpoint falls inside the picked mode's cover region. Not called from the
training or evaluation paths; kept for the component inventory.

The reference's bookkeeping quirks are kept exactly: the suppression
multiplies survivor scores by 0 rather than masking them out, and every
past selection re-contributes a -1 penalty per round (`point_val +=
point_val_selected` accumulates), so ties after full suppression resolve
to the first index, as torch.argmax and jnp.argmax do. Sorts are stable
(jnp.argsort's order).
"""

from typing import Tuple

import torch


def _sort_desc(scores):
    """argsort descending, stable (ties keep the lower index first)."""
    return torch.argsort(-scores, dim=-1, stable=True)


def _greedy_select(sorted_scores, cover_mask, num_ret_modes: int):
    """Shared greedy loop (reference utils/metrics.py:180-196,246-260,
    296-310). sorted_scores [B, N] in selection order; cover_mask
    [B, N, N], cover_mask[b, i, j]: picking i suppresses j. Returns
    positions into the sorted arrays [B, num_ret_modes]."""
    B = sorted_scores.shape[0]
    point_val = sorted_scores
    selected_pen = torch.zeros_like(sorted_scores)
    picks = []
    b_idx = torch.arange(B, device=sorted_scores.device)
    for _ in range(num_ret_modes):
        cur = torch.argmax(point_val, dim=-1)                      # [B]
        picks.append(cur)
        new_cover = cover_mask[b_idx, cur]                         # [B, N]
        point_val = point_val * (~new_cover).to(point_val.dtype)
        selected_pen[b_idx, cur] = -1.0
        point_val = point_val + selected_pen
    return torch.stack(picks, dim=1)                               # [B, K]


def _gather_rows(x, idx):
    """x[b, idx[b, k]] for arbitrary trailing dims."""
    b = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[b, idx]


def _goal_dist(goals):
    return torch.linalg.norm(goals[:, :, None, 0:2] - goals[:, None, :, 0:2],
                             dim=-1)


def new_batch_nms(pred_trajs, dist_thresh: float, num_ret_modes: int = 6
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Density-scored NMS (reference utils/metrics.py:143-197): each mode
    scored by the fraction of modes whose goals land within `dist_thresh`
    of its own goal, then greedy selection.

    pred_trajs [B, M, T, F] with xy in features 0:2. Returns (ret_trajs
    [B, K, T, F], ret_scores [B, K], ret_idxs [B, K])."""
    M = pred_trajs.shape[1]
    goals = pred_trajs[:, :, -1, :]
    scores = (_goal_dist(goals) < dist_thresh).sum(-1) / M         # [B, M]

    order = _sort_desc(scores)
    s_scores = _gather_rows(scores, order)
    s_trajs = _gather_rows(pred_trajs, order)
    cover = _goal_dist(s_trajs[:, :, -1, :]) < dist_thresh

    picks = _greedy_select(s_scores, cover, num_ret_modes)
    return (_gather_rows(s_trajs, picks), _gather_rows(s_scores, picks),
            _gather_rows(order, picks))


def batch_nms(pred_trajs, pred_scores, dist_thresh: float,
              num_ret_modes: int = 6, mode: str = "static", speed=None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Score-ordered NMS (reference utils/metrics.py:200-260).

    mode="static": isotropic goal-distance cover (< dist_thresh).
    mode="speed":  anisotropic box cover (|dx| < 4, |dy| < 0.5); the
                   reference hardcodes the thresholds (`speed` unused).

    pred_trajs [B, M, T, F], pred_scores [B, M]. Returns (ret_trajs
    [B, K, T, F], ret_scores [B, K], ret_idxs [B, K])."""
    order = _sort_desc(pred_scores)
    s_scores = _gather_rows(pred_scores, order)
    s_trajs = _gather_rows(pred_trajs, order)
    s_goals = s_trajs[:, :, -1, :]

    if mode == "speed":
        lon = torch.abs(s_goals[:, :, None, 0] - s_goals[:, None, :, 0])
        lat = torch.abs(s_goals[:, :, None, 1] - s_goals[:, None, :, 1])
        cover = (lon < 4.0) & (lat < 0.5)
    else:
        cover = _goal_dist(s_goals) < dist_thresh

    picks = _greedy_select(s_scores, cover, num_ret_modes)
    return (_gather_rows(s_trajs, picks), _gather_rows(s_scores, picks),
            _gather_rows(order, picks))


def batch_nms_token(pred_goals, pred_scores, dist_thresh: float,
                    num_ret_modes: int = 6, mode: str = "static", speed=None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Goal-point (token) NMS (reference utils/metrics.py:263-314).

    mode="nearby": adaptive per-mode radius, the 5th-smallest pairwise goal
    distance (reference :286-290; the cover excludes the threshold itself).

    pred_goals [B, M, F] with xy in features 0:2. Returns (ret_goals
    [B, K, F], ret_scores [B, K], ret_idxs [B, K])."""
    order = _sort_desc(pred_scores)
    s_scores = _gather_rows(pred_scores, order)
    s_goals = _gather_rows(pred_goals, order)

    dist = _goal_dist(s_goals)
    if mode == "nearby":
        k = min(5, dist.shape[-1])
        thresh = torch.sort(dist, dim=-1).values[..., k - 1]
        cover = dist < thresh[..., None]
    else:
        cover = dist < dist_thresh

    picks = _greedy_select(s_scores, cover, num_ret_modes)
    return (_gather_rows(s_goals, picks), _gather_rows(s_scores, picks),
            _gather_rows(order, picks))
