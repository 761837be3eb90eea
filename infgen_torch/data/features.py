"""Model-input preparation: tokenize a Scenario into fixed-shape model inputs
(port of infgen_tpu/data/features.py).

Runs on the scenario's device. The map-token prediction mask draws P
uniforms, from a `torch.Generator` or handed in directly (`pt_uniform`), so
that a test can give the JAX and torch versions the same numbers.
"""

from typing import Optional

import torch

from infgen_torch.config import Config, ENTER_STATE, INVALID_STATE
from infgen_torch.data.scenario import (ModelInputs, Scenario,
                                        TokenizedAgents, lane_of,
                                        stack_scenarios)
from infgen_torch.tokenizers.attr_tokenizer import AttrTokenizer
from infgen_torch.tokenizers.motion_tokenizer import MotionTokenizer
from infgen_torch.utils.geometry import angle_between_2d_vectors, wrap_angle


def fetch_enterings(attr: AttrTokenizer, cfg: Config,
                    tokens: TokenizedAgents, av_index, pt_pos, pt_mask):
    """Per token step: ego-relative grid/heading tokens for all agents,
    in-range masks, and the ego-angle order of entering agents."""
    pos_a = tokens.token_pos
    head_a = tokens.token_heading
    state = tokens.state_idx
    av = av_index.long()
    ego_pos = pos_a[av]
    ego_head = head_a[av]

    is_bos = state == ENTER_STATE
    is_invalid = state == INVALID_STATE
    rel = pos_a - ego_pos[None]
    dist = torch.linalg.norm(rel, dim=-1)
    inrange = dist <= cfg.pl2seed_radius
    sel = (~is_invalid) & inrange

    # [T, A] per step, then back to [A, T]
    grid_idx, offset_xy = attr.encode_pos(pos_a.transpose(0, 1),
                                          ego_pos[:, None], ego_head[:, None])
    grid_idx, offset_xy = grid_idx.transpose(0, 1), offset_xy.transpose(0, 1)
    grid_token_idx = torch.where(sel, grid_idx, -1).to(torch.int32)
    grid_offset_xy = torch.where(sel[..., None], offset_xy, 0.0)
    pos_xy = torch.where(sel[..., None], rel, 0.0)

    rel_heading = head_a - ego_head[None]
    heading_token_idx = attr.encode_heading(rel_heading)
    heading_theta = wrap_angle(rel_heading)

    head_vec = torch.stack([torch.cos(ego_head), torch.sin(ego_head)], -1)
    ang = angle_between_2d_vectors(head_vec[None], rel)
    ang = torch.where(is_bos & inrange, ang, torch.inf)
    order = torch.argsort(ang, dim=0, stable=True)
    sorted_vals = torch.gather(ang, 0, order)
    sort_indices = torch.where(torch.isinf(sorted_vals), av,
                               order).to(torch.int32)

    pt_dist = torch.linalg.norm(pt_pos[None] - ego_pos[:, None], dim=-1)
    pt_inrange = (pt_dist <= cfg.pl2seed_radius) & pt_mask[None]
    pt_grid = torch.stack([attr.encode_pos(pt_pos, ego_pos[t][None],
                                           ego_head[t])[0]
                           for t in range(ego_pos.shape[0])])
    pt_grid_token_idx = torch.where(pt_inrange, pt_grid, -1).to(torch.int32)

    return dict(
        grid_token_idx=grid_token_idx, grid_offset_xy=grid_offset_xy,
        heading_token_idx=heading_token_idx, pos_xy=pos_xy,
        heading_theta=heading_theta, sort_indices=sort_indices,
        inrange_mask=inrange, bos_mask=is_bos,
        pt_grid_token_idx=pt_grid_token_idx, ego_pos=ego_pos,
        ego_head=ego_head,
    )


def sample_pt_pred_masks(chain_id, chain_pos, mask, uniform, token_idx):
    """Random map-token masking: drop ~1/3 of each chain's non-initial
    tokens (`uniform` [P] in [0, 1)); a prediction site is an unmasked
    token whose successor was dropped; the target is that successor."""
    drop = (uniform < (1.0 / 3.0)) & (chain_pos > 0) & mask
    pt_valid = mask & ~drop
    same_chain = (chain_id[:, None] == chain_id[None, :]) \
        & (chain_id[:, None] >= 0)
    succ = same_chain & (chain_pos[None, :] == chain_pos[:, None] + 1)
    succ_dropped = (succ & drop[None, :]).any(dim=1)
    pt_pred = pt_valid & succ_dropped
    pt_target = (succ.T & pt_pred[None, :]).any(dim=1) & drop
    succ_idx = torch.argmax(succ.to(torch.int32), dim=1)
    has_succ = succ.any(dim=1)
    next_token_idx = torch.where(has_succ, token_idx[succ_idx], -1)
    return pt_valid, pt_pred, pt_target, next_token_idx.to(torch.int32)


def build_model_inputs(cfg: Config, motion_tok: MotionTokenizer,
                       attr: AttrTokenizer, scenario: Scenario,
                       generator: Optional[torch.Generator] = None,
                       pt_uniform: Optional[torch.Tensor] = None
                       ) -> ModelInputs:
    """Full input chain for one scenario of tensors. The map mask's uniforms
    come from `pt_uniform` when given, else from `generator`."""
    ag = scenario.agents
    tokens = motion_tok.tokenize(ag.valid, ag.position, ag.heading,
                                 ag.velocity, ag.type)
    ent = fetch_enterings(attr, cfg, tokens, ag.av_index,
                          scenario.map.position, scenario.map.mask)
    m = scenario.map
    if pt_uniform is None:
        gen_dev = generator.device if generator is not None else m.mask.device
        pt_uniform = torch.rand(m.mask.shape[0], generator=generator,
                                device=gen_dev).to(m.mask.device)
    pt_valid, pt_pred, pt_target, pt_next = sample_pt_pred_masks(
        m.chain_id, m.chain_pos, m.mask, pt_uniform, m.token_idx)
    return ModelInputs(
        tokens=tokens,
        agent_shape=ag.shape,
        agent_type=ag.type,
        av_index=ag.av_index,
        slot_mask=ag.slot_mask,
        train_mask=ag.train_mask & ag.slot_mask,
        pt_valid_mask=pt_valid, pt_pred_mask=pt_pred,
        pt_target_mask=pt_target, pt_next_token_idx=pt_next,
        **ent,
    )


def build_model_inputs_batch(cfg: Config, motion_tok: MotionTokenizer,
                             attr: AttrTokenizer, scenarios: Scenario,
                             generators) -> ModelInputs:
    """build_model_inputs for a stack of scenarios (leading lane axis, from
    stack_scenarios): each lane with its own generator, then stacked, as
    `jax.vmap(build_model_inputs)` gives it with one key per lane."""
    return stack_scenarios([
        build_model_inputs(cfg, motion_tok, attr, lane_of(scenarios, b), g)
        for b, g in enumerate(generators)])
