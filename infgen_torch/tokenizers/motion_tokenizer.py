"""Motion / state tokenizer: 10 Hz trajectories -> 2 Hz motion + state tokens
(port of infgen_tpu/tokenizers/motion_tokenizer.py).

The greedy contour matching chains each agent's pose through the previously
matched token, so it is a loop over token steps; the rest is vectorised with
masks. Inputs are fixed-shape padded tensors:
    valid [A, T10] bool; pos [A, T10, 2]; heading [A, T10]; vel [A, T10, 2];
    type_ [A] int (0 veh / 1 ped / 2 cyc)
"""

import numpy as np
import torch

from infgen_torch.config import (ENTER_STATE, EXIT_STATE, INVALID_STATE,
                                 SHIFT, VALID_STATE)
from infgen_torch.data.scenario import TokenizedAgents
from infgen_torch.tokenizers.vocab import load_agent_vocab
from infgen_torch.utils.geometry import (cal_polygon_contour,
                                         heading_from_contour, rot_mat_2d,
                                         wrap_angle)


def _argmax_first(x, dim):
    """Index of the first True/maximum along `dim` (jnp.argmax's order)."""
    return torch.argmax(x.to(torch.int32), dim=dim)


def clean_heading(valid, heading):
    """Suppress >1.5 rad single-step heading jumps by forward-filling
    (sequential: each fix feeds the next comparison)."""
    valid_pairs = valid[:, :-1] & valid[:, 1:]
    out = [heading[:, 0]]
    h_prev = heading[:, 0]
    for t in range(1, heading.shape[1]):
        h_next = heading[:, t]
        diff = torch.abs(wrap_angle(h_prev - h_next))
        h_prev = torch.where((diff > 1.5) & valid_pairs[:, t - 1], h_prev,
                             h_next)
        out.append(h_prev)
    return torch.stack(out, dim=1)


def extrapolate_to_prev_token_step(valid, pos, heading, vel,
                                   current_step: int = 10):
    """Back-extrapolate each agent so its first valid step lands on a token
    boundary (constant-velocity backward rollout)."""
    A, T = valid.shape
    first = _argmax_first(valid, 1)
    any_valid = valid.any(dim=1)
    n_extra = first % SHIFT
    special = (first == current_step) & (~valid[:, current_step - SHIFT]) \
        & any_valid
    n_extra = torch.where(special, SHIFT, n_extra)
    n_extra = torch.where(any_valid, n_extra, 0)

    steps = torch.arange(T, device=valid.device)[None, :]
    fill = (steps >= (first - n_extra)[:, None]) & (steps < first[:, None])

    vel_t = torch.gather(vel, 1, first[:, None, None].expand(A, 1, 2))
    head_t = torch.gather(heading, 1, first[:, None])
    pos_t = torch.gather(pos, 1, first[:, None, None].expand(A, 1, 2))

    k = (first[:, None] - steps).to(pos.dtype)
    extrap_pos = pos_t - k[..., None] * vel_t * 0.1

    valid = valid | fill
    pos = torch.where(fill[..., None], extrap_pos, pos)
    heading = torch.where(fill, head_t, heading)
    vel = torch.where(fill[..., None], vel_t, vel)
    return valid, pos, heading, vel


def matching_agent_shape(type_):
    """Width/length used for contour matching."""
    width = torch.where(type_ == 0, 2.0, 1.0)
    length = torch.where(type_ == 0, 4.8, torch.where(type_ == 1, 2.0, 1.0))
    return torch.stack([width, length], dim=-1)


def _match(valid, pos, heading, shape_wl, token_traj):
    """Greedy sequential contour matching. token_traj [A, V, 4, 2] per-agent
    final-step vocab contours in the local frame. Returns (token_idx [A, T]
    int32, token_contour [A, T, 4, 2])."""
    A, T10 = valid.shape
    prev_pos, prev_heading = pos[:, 0], heading[:, 0]
    idxs, contours = [], []
    for i in range(SHIFT, T10, SHIFT):
        _valid = valid[:, i - SHIFT] & valid[:, i]
        rot = rot_mat_2d(prev_heading)
        world = torch.einsum("avcj,ajk->avck", token_traj, rot) \
            + prev_pos[:, None, None, :]
        pos_i, head_i = pos[:, i], heading[:, i]
        cur_contour = cal_polygon_contour(pos_i, head_i, shape_wl)
        d = torch.linalg.norm(world - cur_contour[:, None], dim=-1).sum(-1)
        idx = torch.argmin(d, dim=-1)
        contour = world[torch.arange(A, device=world.device), idx]
        matched_heading = heading_from_contour(contour)
        prev_heading = torch.where(_valid, matched_heading, head_i)
        prev_pos = torch.where(_valid[:, None], contour.mean(dim=1), pos_i)
        idxs.append(idx.to(torch.int32))
        contours.append(contour)
    return torch.stack(idxs, 1), torch.stack(contours, 1)


def derive_state_tokens(token_valid):
    """State tokens [A, T] int32 from token-level validity [A, T] bool."""
    A, T = token_valid.shape
    tv = token_valid.to(torch.int32)
    bos = torch.argmax(tv, dim=1)
    eos = T - 1 - torch.argmax(torch.flip(tv, dims=[1]), dim=1)
    steps = torch.arange(T, device=tv.device)[None, :]
    state = torch.full((A, T), VALID_STATE, dtype=torch.int32,
                       device=tv.device)
    state = torch.where(steps == bos[:, None], ENTER_STATE, state)
    state = torch.where(steps == eos[:, None], EXIT_STATE, state)
    state = torch.where((steps < bos[:, None]) | (steps > eos[:, None]),
                        INVALID_STATE, state)
    # a last-step exit converts back to valid
    last_exit = state[:, -1] == EXIT_STATE
    state[:, -1] = torch.where(last_exit, VALID_STATE, state[:, -1])
    state = torch.where(token_valid.any(dim=1)[:, None], state, INVALID_STATE)
    return state.to(torch.int32)


class MotionTokenizer:
    """Agent tokenization with a fixed vocab."""

    def __init__(self, vocab=None, current_step: int = 10):
        self.vocab = vocab if vocab is not None else load_agent_vocab()
        # host-side numpy: [3, V, 6, 4, 2] stacked veh/ped/cyc
        self.token_traj_all = np.stack(
            [np.asarray(self.vocab[k]) for k in ("veh", "ped", "cyc")], 0)
        self.token_traj = self.token_traj_all[:, :, -1]  # [3, V, 4, 2]
        self.current_step = current_step

    def tokenize(self, valid, pos, heading, vel, type_) -> TokenizedAgents:
        A, T10 = valid.shape
        dev = valid.device
        heading = clean_heading(valid, heading)
        valid, pos, heading, vel = extrapolate_to_prev_token_step(
            valid, pos, heading, vel, self.current_step)
        shape_wl = matching_agent_shape(type_)
        per_agent_vocab = torch.as_tensor(self.token_traj, device=dev)[
            torch.clamp(type_.long(), 0, 2)]
        token_idx, token_contour = _match(valid, pos, heading, shape_wl,
                                          per_agent_vocab)

        T = T10 // SHIFT
        v0 = valid[:, 0:T10 - SHIFT:SHIFT][:, :T]
        v1 = valid[:, SHIFT::SHIFT][:, :T]
        raw_token_valid = v0 & v1
        state_idx = derive_state_tokens(raw_token_valid)

        token_pos = token_contour.mean(dim=2)
        token_heading = heading_from_contour(token_contour)

        token_valid = raw_token_valid & (state_idx != ENTER_STATE)
        is_invalid = state_idx == INVALID_STATE
        token_pos = torch.where(is_invalid[..., None], 0.0, token_pos)
        token_heading = torch.where(is_invalid, 0.0, token_heading)
        is_bos = state_idx == ENTER_STATE
        raw_pos_at_boundary = pos[:, SHIFT::SHIFT][:, :T]
        token_pos = torch.where(is_bos[..., None], raw_pos_at_boundary,
                                token_pos)
        token_idx = torch.where(is_invalid, -1, token_idx)
        token_idx = torch.where(is_bos, -2, token_idx).to(torch.int32)
        return TokenizedAgents(
            token_idx=token_idx, state_idx=state_idx, token_pos=token_pos,
            token_heading=token_heading, token_contour=token_contour,
            token_valid=token_valid, raw_token_valid=raw_token_valid)
