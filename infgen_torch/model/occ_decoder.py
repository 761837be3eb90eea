"""Standalone occupancy-grid decoder, `decoder_type: occ_decoder` (port of
infgen_tpu/model/occ_decoder.py).

For AGENT_LIMIT agent slots and PT_LIMIT map tokens drawn at random per
scenario, the ego-relative geometry of each token step (distance, angle
against the ego's heading vector, relative heading) is Fourier-embedded,
averaged over the drawn set, and classified over the ego grid's cells by
one MLP head per set; the loss is the cross entropy at the cells that
exist. The occupancy pre-training task of
configs/ours_standard_decode_occ.yaml.

The draws are `torch.randperm` from a `torch.Generator`, or handed in as
`sel_a` / `sel_p`: the JAX package draws them with
`jax.random.permutation`, which torch cannot reproduce, so a test passes
in the JAX draws. Parameter names follow the flax module (convert.py).
The two heads end in plain products (128 -> 1,961 -> 19,610 for the map
tokens' at full width) through `Dense`.
"""

from typing import Dict, Optional

import torch
from torch import nn

from infgen_torch.config import Config
from infgen_torch.model.edges import build_motion_vectors
from infgen_torch.model.layers import FourierEmbedding, MLPLayer
from infgen_torch.train.losses import masked_ce
from infgen_torch.utils.geometry import angle_between_2d_vectors

AGENT_LIMIT = 3   # agent slots drawn per scenario
PT_LIMIT = 10     # map tokens drawn per scenario


class OccDecoder(nn.Module):
    def __init__(self, cfg: Config, grid_size: int):
        super().__init__()
        D = cfg.hidden_dim
        self.grid_size = grid_size
        self.r_a2a_emb = FourierEmbedding(3, D, cfg.num_freq_bands)
        self.r_pt2a_emb = FourierEmbedding(3, D, cfg.num_freq_bands)
        self.grid_agent_occ_head = MLPLayer(D, grid_size,
                                            AGENT_LIMIT * grid_size)
        self.grid_pt_occ_head = MLPLayer(D, grid_size, PT_LIMIT * grid_size)

    @staticmethod
    def draw(num_agents: int, num_pt: int, generator: torch.Generator):
        """(sel_a [AGENT_LIMIT], sel_p [PT_LIMIT]): the first entries of a
        random permutation of the agent slots and of the map tokens."""
        perm = lambda n: torch.randperm(n, generator=generator,
                                        device=generator.device)
        return perm(num_agents)[:AGENT_LIMIT], perm(num_pt)[:PT_LIMIT]

    def forward(self, inputs, pt_pos, pt_orient,
                generator: Optional[torch.Generator] = None,
                sel_a=None, sel_p=None) -> Dict[str, torch.Tensor]:
        """inputs: ModelInputs of one scenario; pt_pos [P, 2], pt_orient
        [P]. `sel_a` / `sel_p` (slot and token indices) or `generator`
        give the drawn sets. Returns the logits [T, k, grid_size], their
        ground-truth cells [T, k] (-1 where none) and the masks."""
        tok = inputs.tokens
        pos_a, head_a = tok.token_pos, tok.token_heading     # [A, T, 2], [A, T]
        A, T = head_a.shape
        if sel_a is None or sel_p is None:
            if generator is None:
                raise ValueError("OccDecoder.forward: draws without a "
                                 "torch.Generator")
            sel_a, sel_p = self.draw(A, pt_pos.shape[0], generator)
        dev = pos_a.device
        sel_a, sel_p = sel_a.to(dev).long(), sel_p.to(dev).long()

        ego_pos, ego_head = inputs.ego_pos, inputs.ego_head   # [T, 2], [T]
        _, head_vec = build_motion_vectors(pos_a, head_a, tok.state_idx)
        ego_hv = head_vec[inputs.av_index.long()]             # [T, 2]

        rel_a = pos_a[sel_a] - ego_pos[None]                  # [k, T, 2]
        r_a2a = torch.stack([
            torch.linalg.norm(rel_a, dim=-1),
            angle_between_2d_vectors(ego_hv[None], rel_a),
            head_a[sel_a] - ego_head[None],
        ], dim=-1)
        rel_p = pt_pos[sel_p][:, None] - ego_pos[None]        # [k, T, 2]
        r_pl2a = torch.stack([
            torch.linalg.norm(rel_p, dim=-1),
            angle_between_2d_vectors(ego_hv[None], rel_p),
            pt_orient[sel_p][:, None].expand(PT_LIMIT, T) - ego_head[None],
        ], dim=-1)

        # the drawn set's mean, one feature per token step
        feat_a = self.r_a2a_emb(r_a2a).mean(0)                # [T, D]
        feat_p = self.r_pt2a_emb(r_pl2a).mean(0)
        G = self.grid_size
        agent_occ = self.grid_agent_occ_head(feat_a).reshape(T, AGENT_LIMIT,
                                                             G)
        pt_occ = self.grid_pt_occ_head(feat_p).reshape(T, PT_LIMIT, G)
        agent_occ_gt = inputs.grid_token_idx[sel_a].transpose(0, 1)  # [T, k]
        pt_occ_gt = inputs.pt_grid_token_idx[:, sel_p]               # [T, k]
        return {
            "occ_decoder": True,
            "agent_occ": agent_occ,
            "agent_occ_gt": agent_occ_gt,
            "agent_occ_eval_mask": agent_occ_gt != -1,
            "pt_occ": pt_occ,
            "pt_occ_gt": pt_occ_gt,
            "pt_occ_eval_mask": pt_occ_gt != -1,
        }


def occ_decoder_loss(pred: Dict[str, torch.Tensor]):
    """Cross entropy over grid cells at the cells that exist: (loss, logs)
    as train/losses.compute_losses returns them."""
    l_a = masked_ce(pred["agent_occ"], pred["agent_occ_gt"],
                    pred["agent_occ_eval_mask"])
    l_p = masked_ce(pred["pt_occ"], pred["pt_occ_gt"],
                    pred["pt_occ_eval_mask"])
    return l_a + l_p, {"agent_occ_cls_loss": l_a, "pt_occ_cls_loss": l_p,
                       "loss": l_a + l_p}
