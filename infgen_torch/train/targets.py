"""Next-token targets and evaluation masks (port of
infgen_tpu/train/targets.py): the BOS/EOS mask logic of the reference
forward and the seed-target assembly, vectorised over [A, T]."""

from typing import Dict

import torch

from infgen_torch.config import ENTER_STATE, EXIT_STATE


def roll_targets(token_idx, state_idx):
    """next_token / next_state ground truth = roll(-1); exit (3) becomes
    class 2 of the 3-way {invalid, valid, exit} state head."""
    next_token = torch.roll(token_idx, -1, dims=1)
    next_state = torch.roll(state_idx, -1, dims=1)
    next_state = torch.where(next_state == EXIT_STATE, 2, next_state)
    return next_token, next_state


def _first(x):
    """Index of the first True per row (0 where none), as jnp.argmax."""
    return x.int().argmax(1)


def token_state_eval_masks(raw_valid, state_idx, av_index, slot_mask):
    """(token_mask, state_mask) [A, T] bool:
      base   = m & roll(m,-1) & roll(m,+1)
      bos tb : token[tb]=1, token[tb+1]=m[tb+2]  (no-op when tb+2 == T)
               state[:tb]=0, state[tb]=1, state[tb+1]=m[tb+2]
      eos te : token[te]=0
               state[te+1:]=1, state[te]=m[te-1]
      both   : [:,0]=m0&m1, [:,-1]=0;  state[av]=0
    """
    A, T = state_idx.shape
    m = raw_valid
    mf = torch.roll(m, -1, dims=1)
    mb = torch.roll(m, 1, dims=1)
    base = m & mf & mb

    is_bos = state_idx == ENTER_STATE
    is_eos = state_idx == EXIT_STATE
    t = torch.arange(T, device=m.device)[None]
    has_bos = is_bos.any(1)
    has_eos = is_eos.any(1)
    bos = torch.where(has_bos, _first(is_bos), T)   # T = "never"
    eos = torch.where(has_eos, _first(is_eos), T)

    after_bos = has_bos[:, None] & (t == (bos + 1)[:, None]) & (t < T)
    tok = base
    tok = torch.where(is_bos, True, tok)
    tok = torch.where(after_bos & (t < T - 1), mf, tok)
    tok = torch.where(is_eos, False, tok)

    st = base
    st = torch.where(has_bos[:, None] & (t < bos[:, None]), False, st)
    st = torch.where(is_bos, True, st)
    st = torch.where(after_bos & (t < T - 1), mf, st)
    st = torch.where(has_eos[:, None] & (t > eos[:, None]), True, st)
    st = torch.where(is_eos & (t > 0), mb, st)

    first = m[:, 0] & m[:, 1]
    tok, st = tok.clone(), st.clone()
    tok[:, 0] = first
    st[:, 0] = first
    tok[:, -1] = False
    st[:, -1] = False
    st[av_index.long()] = False       # no state supervision for the ego

    return tok & slot_mask[:, None], st & slot_mask[:, None]


def seed_targets(inputs, grid_size: int, num_seed: int
                 ) -> Dict[str, torch.Tensor]:
    """Seed supervision by ego-angle matching: seed slot s is the agent at
    insertion order s (sort_indices[s, t]); 'enter' where it enters, else
    'invalid'. Attribute losses apply only at enter events outside the ego
    cell and not at t = 0. Returns ground truths of leading shape [S, T]."""
    tok = inputs.tokens
    gt_idx = inputs.sort_indices[:num_seed].long()          # [S, T]
    take = lambda x: torch.gather(x, 0, gt_idx)
    state_g = take(tok.state_idx)
    pos_idx_gt = take(inputs.grid_token_idx)
    pos_xy_gt = torch.gather(inputs.pos_xy, 0,
                             gt_idx[..., None].expand(*gt_idx.shape, 2))
    attr_mask = (state_g == ENTER_STATE).clone()
    attr_mask[:, 0] = False
    attr_mask = attr_mask & (pos_idx_gt != grid_size // 2)
    state_mask = torch.ones_like(attr_mask)
    state_mask[:, 0] = False
    return dict(
        seed_state_gt=(state_g == ENTER_STATE).long(),
        seed_state_mask=state_mask,
        seed_type_gt=inputs.agent_type[gt_idx],
        seed_shape_gt=inputs.agent_shape[gt_idx],
        seed_pos_idx_gt=pos_idx_gt,
        seed_pos_xy_gt=pos_xy_gt,
        seed_attr_mask=attr_mask,
    )
