"""Training and validation scalar metrics (port of
infgen_tpu/metrics/train_metrics.py).

The reference's TokenCls, minADE, minFDE, StateAccuracy, GridOverlapRate,
minMultiADE / minMultiFDE and NumInsertAccuracy as stateless functions that
return (sum, count) tensors on the inputs' device; callers add them up
across scenarios. Masks select (torch.where) where the JAX package
multiplies by a bool: XLA rewrites that product as a select, so a NaN on a
masked-out step counts as 0 there too.
"""

from typing import Dict

import torch

from infgen_torch.config import ENTER_STATE, EXIT_STATE, INVALID_STATE, VALID_STATE


def token_cls_accuracy(pred_topk, target, valid_mask, max_guesses: int = 1):
    """pred_topk [..., K] token ids; target [...]."""
    hit = (pred_topk[..., :max_guesses] == target[..., None]).any(-1) \
        & valid_mask
    return hit.sum(), valid_mask.sum()


def min_ade(pred, target, valid_mask, eval_timestep: int = 70):
    """minADE with the reference's normalisation: it divides by the whole
    horizon's length."""
    t = min(eval_timestep, pred.shape[1])
    err = torch.linalg.vector_norm(pred[:, :t] - target[:, :t], dim=-1)
    err = torch.where(valid_mask[:, :t], err, 0.0)
    per_agent = err.sum(-1) / pred.shape[1]
    count = valid_mask[:, :t].any(-1)
    return torch.where(count, per_agent, 0.0).sum(), count.sum()


def min_fde(pred, target, valid_mask, eval_timestep: int = 70):
    """minFDE at index min(eval_timestep, T) - 2: the reference takes
    eval_timestep = min(70, T) - 1 and then reads pred[:, eval_timestep - 1].
    The double offset is its behaviour, kept on purpose."""
    t = min(eval_timestep, pred.shape[1]) - 1
    err = torch.linalg.vector_norm(pred[:, t - 1] - target[:, t - 1], dim=-1)
    m = valid_mask[:, t - 1]
    return torch.where(m, err, 0.0).sum(), m.sum()


def _first_true(x):
    """Index of the first True along the last axis (0 where none is): an
    argmax over an integer cast, since torch has no bool argmax."""
    return torch.argmax(x.to(torch.int32), -1)


def state_accuracy(state_idx) -> Dict[str, torch.Tensor]:
    """Within-lifecycle state correctness: `valid` is the share of steps
    strictly inside (bos, eos) predicted valid, `invalid` the share of steps
    outside [bos, eos] predicted invalid."""
    A, T = state_idx.shape
    is_bos = state_idx == ENTER_STATE
    is_eos = state_idx == EXIT_STATE
    has_bos = is_bos.any(-1)
    has_eos = is_eos.any(-1)
    bos = torch.where(has_bos, _first_true(is_bos), 0)
    eos = torch.where(has_eos, _first_true(is_eos), T - 1)
    t = torch.arange(T, device=state_idx.device)[None]

    # padded or wholly invalid slots are not in the reference's agent set
    exists = (state_idx != INVALID_STATE).any(-1)[:, None]
    before = has_bos[:, None] & (t < bos[:, None]) & exists
    after = has_eos[:, None] & (t > eos[:, None]) & exists
    inside = (t > bos[:, None]) & (t < eos[:, None]) & exists

    inv_ok = ((state_idx == INVALID_STATE) & (before | after)).sum()
    inv_cnt = (before | after).sum()
    val_ok = ((state_idx == VALID_STATE) & inside).sum()
    val_cnt = inside.sum()
    return dict(valid_sum=val_ok, valid_count=val_cnt,
                invalid_sum=inv_ok, invalid_count=inv_cnt)


def grid_overlap_rate(state_token, grid_index, grid_size: int,
                      seed_size: int = 10) -> Dict[str, torch.Tensor]:
    """Insertion-grid collisions per step: how many entering agents landed
    on a cell that a non-entering agent or an earlier entering agent
    holds. Per-cell counts by scatter-add ([T, G] integers), the JAX
    package's one-hot sums."""
    A, T = state_token.shape
    inrange = grid_index != -1
    entering = (state_token == ENTER_STATE) & inrange
    occupied_src = inrange & (state_token != ENTER_STATE)
    gi = torch.where(inrange, grid_index, 0).long().T          # [T, A]

    def per_cell(mask):
        return torch.zeros(T, grid_size, dtype=torch.int32,
                           device=gi.device).scatter_add_(
            1, gi, mask.T.to(torch.int32))

    occ = per_cell(occupied_src) > 0                           # [T, G]
    enter_counts = per_cell(entering)
    dup_overlaps = torch.clamp(enter_counts - 1, min=0).sum(-1)
    occ_overlaps = ((enter_counts > 0) & occ).sum(-1)
    return dict(
        num_overlap_t=dup_overlaps + occ_overlaps,
        num_insert_agent_t=entering.sum(0),
        num_total_agent_t=inrange.sum(0),
        num_exceed_seed_t=(entering.sum(0) >= seed_size).to(torch.int32),
    )


def _last_valid(valid_mask):
    """Index of each row's last valid step (0 where none is)."""
    T = valid_mask.shape[-1]
    steps = torch.arange(1, T + 1, device=valid_mask.device)
    return torch.argmax(valid_mask * steps, -1)


def min_multi_ade(pred_k, target, valid_mask, min_criterion: str = "FDE"):
    """minADE over K guesses. pred_k [A, K, T, 2]; target [A, T, 2];
    valid_mask [A, T]."""
    A, K, T, _ = pred_k.shape
    err = torch.linalg.vector_norm(pred_k - target[:, None], dim=-1)  # [A, K, T]
    n_valid = torch.clamp(valid_mask.sum(-1), min=1)
    if min_criterion == "FDE":
        last = _last_valid(valid_mask)
        fde = torch.gather(err, 2, last[:, None, None].expand(A, K, 1))[..., 0]
        best = fde.argmin(-1)                                          # [A]
        err_best = torch.gather(err, 1, best[:, None, None].expand(A, 1, T))[:, 0]
        ade = torch.where(valid_mask, err_best, 0.0).sum(-1) / n_valid
    else:
        ade_k = torch.where(valid_mask[:, None], err, 0.0).sum(-1) \
            / n_valid[:, None]
        ade = ade_k.amin(-1)
    has = valid_mask.any(-1)
    return torch.where(has, ade, 0.0).sum(), has.sum()


def min_multi_fde(pred_k, target, valid_mask):
    """minFDE over K guesses."""
    A, K, T, _ = pred_k.shape
    last = _last_valid(valid_mask)
    pred_last = torch.gather(
        pred_k, 2, last[:, None, None, None].expand(A, K, 1, 2))[:, :, 0]
    tgt_last = torch.gather(target, 1,
                            last[:, None, None].expand(A, 1, 2))[:, 0]
    fde = torch.linalg.vector_norm(pred_last - tgt_last[:, None],
                                   dim=-1).amin(-1)
    has = valid_mask.any(-1)
    return torch.where(has, fde, 0.0).sum(), has.sum()


def num_insert_accuracy(pred_state, gt_state):
    """Per-step inserted-agent count agreement: |#enter_pred - #enter_gt|
    summed over steps, over the logged entries (at least 1)."""
    pe = (pred_state == ENTER_STATE).sum(0)
    ge = (gt_state == ENTER_STATE).sum(0)
    return torch.abs(pe - ge).sum(), torch.clamp(ge.sum(), min=1)
