"""Loss assembly for one scenario (port of infgen_tpu/train/losses.py):
masked means as masked reductions, an empty mask giving 0. Every loss is
computed in fp32, whatever the compute dtype of the logits."""

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from infgen_torch.config import Config, ENTER_STATE
from infgen_torch.train.targets import (roll_targets, seed_targets,
                                        token_state_eval_masks)


def _masked_mean(per, w):
    denom = w.sum()
    return torch.where(denom > 0, (per * w).sum() / denom.clamp_min(1e-9),
                       0.0)


def masked_ce(logits, labels, mask, label_smoothing=0.0, class_weights=None):
    """Cross entropy over the masked entries, the weighted mean
    sum(w_y ce) / sum(w_y) as the JAX package writes it: label smoothing
    mixes in the mean -log p over classes, and the class weights weight
    the smoothed loss per label. (F.cross_entropy with both
    label_smoothing and weight normalises differently.)"""
    logits = logits.float()
    labels_c = labels.long().clamp(0, logits.shape[-1] - 1)
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels_c[..., None])[..., 0]
    if label_smoothing > 0.0:
        nll = (1.0 - label_smoothing) * nll \
            + label_smoothing * (-logp.mean(-1))
    w = mask.float()
    if class_weights is not None:
        w = w * torch.as_tensor(class_weights, dtype=torch.float32,
                                device=logits.device)[labels_c]
    return _masked_mean(nll, w)


def masked_mse(pred, target, mask):
    pred, target = pred.float(), target.float()
    w = mask.float()
    if pred.dim() > mask.dim():
        w = w[..., None]
    return _masked_mean((pred - target) ** 2, w.expand(pred.shape))


def masked_bce_logits(logits, target, mask, pos_weight=1.0):
    """BCEWithLogits with pos_weight, masked mean over elements."""
    logits, target = logits.float(), target.float()
    per = -(pos_weight * target * F.logsigmoid(logits)
            + (1.0 - target) * F.logsigmoid(-logits))
    w = mask.float()
    if w.dim() != per.dim():
        w = w[..., None]
    return _masked_mean(per, w.expand(per.shape))


def compute_losses(cfg: Config, grid_size: int, pred: Dict, inputs
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total loss, logs) of one scenario's training forward; every log key
    of the JAX package's, the token loss's s0-s9 breakdown by steps after
    entry included."""
    lw = cfg.loss_weight
    tok = inputs.tokens
    logs = {}
    total = 0.0

    next_token_gt, next_state_gt = roll_targets(tok.token_idx,
                                                tok.state_idx)
    tok_mask, state_mask = token_state_eval_masks(
        tok.raw_token_valid, tok.state_idx, inputs.av_index,
        inputs.slot_mask)

    if cfg.predict_motion:
        m = tok_mask & inputs.train_mask[:, None]
        loss = masked_ce(pred["next_token_logits"], next_token_gt, m,
                         label_smoothing=0.1) * lw.token_cls_loss
        logs["token_cls_loss"] = loss
        total = total + loss
        A, T = tok.state_idx.shape
        is_bos = tok.state_idx == ENTER_STATE
        bos = torch.where(is_bos.any(1), is_bos.int().argmax(1), T)
        t_idx = torch.arange(T, device=is_bos.device)[None]
        for i in range(10):
            at_i = (t_idx == (bos + 1 + i)[:, None]) & (t_idx < T - 1)
            logs[f"s{i}"] = masked_ce(pred["next_token_logits"],
                                      next_token_gt, m & at_i,
                                      label_smoothing=0.1)

    if cfg.predict_state:
        loss = masked_ce(pred["next_state_logits"], next_state_gt,
                         state_mask, class_weights=lw.state_weight) \
            * lw.state_cls_loss
        logs["state_cls_loss"] = loss
        total = total + loss

        st = seed_targets(inputs, grid_size, cfg.num_seed_feature)
        l_sst = masked_ce(pred["seed_state_logits"], st["seed_state_gt"],
                          st["seed_state_mask"],
                          class_weights=lw.seed_state_weight) \
            * lw.state_cls_loss
        l_typ = masked_ce(pred["seed_type_logits"], st["seed_type_gt"],
                          st["seed_attr_mask"],
                          class_weights=lw.seed_type_weight) \
            * lw.type_cls_loss
        l_shp = masked_mse(pred["seed_shape"], st["seed_shape_gt"],
                           st["seed_attr_mask"]) * lw.shape_reg_loss
        logs["seed_state_cls_loss"] = l_sst
        logs["seed_type_cls_loss"] = l_typ
        logs["seed_shape_reg_loss"] = l_shp
        total = total + l_sst + l_typ + l_shp

        if cfg.use_grid_token:
            l_pos = masked_ce(pred["seed_pos_logits"],
                              st["seed_pos_idx_gt"], st["seed_attr_mask"],
                              label_smoothing=0.1) * lw.pos_cls_loss
            l_off = masked_mse(pred["offset_xy"], inputs.grid_offset_xy,
                               pred["mask_sa"]) * lw.offset_reg_loss
            logs["seed_pos_cls_loss"] = l_pos
            logs["seed_offset_reg_loss"] = l_off
            total = total + l_pos + l_off
        else:
            l_pos = masked_mse(pred["seed_pos_xy"],
                               st["seed_pos_xy_gt"] / cfg.pl2seed_radius,
                               st["seed_attr_mask"]) * lw.pos_reg_loss
            logs["seed_pos_reg_loss"] = l_pos
            total = total + l_pos

        if cfg.use_head_token:
            l_head = masked_ce(pred["head_logits"], inputs.heading_token_idx,
                               pred["mask_sa"]) * lw.head_cls_loss
            logs["seed_head_cls_loss"] = l_head
        else:
            l_head = masked_mse(pred["head_theta"],
                                inputs.heading_theta / math.pi,
                                pred["mask_sa"]) * lw.head_reg_loss
            logs["seed_head_reg_loss"] = l_head
        total = total + l_head

    if cfg.predict_occ and pred["occ_agent_logits"] is not None:
        S, T, G = pred["occ_agent_logits"].shape
        occ_mask = torch.ones(S, T, G, dtype=torch.bool,
                              device=pred["occ_agent_logits"].device)
        occ_mask[:, 0] = False
        occ_mask[..., grid_size // 2] = False
        l_aocc = masked_bce_logits(
            pred["occ_agent_logits"], pred["occ_agent_gt"], occ_mask,
            pos_weight=lw.agent_occ_pos_weight) * lw.agent_occ_loss
        l_pocc = masked_bce_logits(
            pred["occ_pt_logits"], pred["occ_pt_gt"], occ_mask,
            pos_weight=lw.pt_occ_pos_weight) * lw.pt_occ_loss
        logs["agent_occ_loss"] = l_aocc
        logs["pt_occ_loss"] = l_pocc
        total = total + l_aocc + l_pocc

    if cfg.predict_map:
        l_map = masked_ce(pred["map_next_token_logits"],
                          inputs.pt_next_token_idx,
                          inputs.pt_pred_mask
                          & (inputs.pt_next_token_idx >= 0),
                          label_smoothing=0.1) * lw.map_token_loss
        logs["map_token_loss"] = l_map
        total = total + l_map

    logs["loss"] = total
    return total, logs
