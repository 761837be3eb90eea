"""Map ("pt token") encoder (port of infgen_tpu/model/map_encoder.py).

Map-vocab token embeddings plus categorical embeddings, then
`num_map_layers` of neighbour attention over a fixed-k (k=32) radius table
with relative-geometry bias. The masked next-map-token head
(`next_token_logits`) is the training forward's; the rollout reads only
the features.
"""

import torch
from torch import nn

from infgen_torch.config import Config
from infgen_torch.model.layers import (DenseAttention, Embed,
                                       FourierEmbedding, MLPEmbedding,
                                       MLPLayer)
from infgen_torch.ops.neighbors import gather_rows, topk_neighbors
from infgen_torch.ops.precision import compute_dtype_of
from infgen_torch.utils.geometry import angle_between_2d_vectors, wrap_angle

PT2PT_K = 32


class MapEncoder(nn.Module):
    def __init__(self, cfg: Config, map_vocab_len: int = 11):
        super().__init__()
        self.cfg = cfg
        D = cfg.hidden_dim
        dt = compute_dtype_of(cfg.compute_dtype)
        self.token_emb = MLPEmbedding(2 * map_vocab_len, D, dtype=dt)
        self.type_pt_emb = Embed(17, D, dtype=dt)
        self.polygon_type_emb = Embed(4, D, dtype=dt)
        self.light_pl_emb = Embed(4, D, dtype=dt)
        self.r_pt2pt_emb = FourierEmbedding(3, D, cfg.num_freq_bands,
                                            dtype=dt)
        for i in range(cfg.num_map_layers):
            setattr(self, f"pt2pt_{i}",
                    DenseAttention(D, cfg.num_heads, cfg.head_dim,
                                   bipartite=False, has_pos_emb=True,
                                   use_pallas=cfg.use_pallas_attention,
                                   dtype=dt, dropout=cfg.dropout,
                                   remat=cfg.remat_attention))
        self.token_predict_head = MLPLayer(D, D, cfg.map_token_size)

    def forward(self, map_data, map_vocab_traj, pt_valid_mask=None,
                generator=None):
        """map_data: MapData of tensors (fields [..., P, ...]: leading dims
        are the rollout's lanes, one map each); map_vocab_traj
        [V_map, 11, 2]; pt_valid_mask: the tokens left visible by the
        masked-token training (default map_data.mask); generator: the
        dropout masks' in train mode (DenseAttention). Returns x_pt
        [..., P, D]."""
        pos = map_data.position
        orient = map_data.orientation
        if pt_valid_mask is None:
            pt_valid_mask = map_data.mask

        vocab_flat = map_vocab_traj.reshape(map_vocab_traj.shape[0], -1)
        x_pt = self.token_emb(vocab_flat)[map_data.token_idx.long()]
        x_pt = (x_pt + self.type_pt_emb(map_data.pt_type)
                + self.polygon_type_emb(map_data.pl_type)
                + self.light_pl_emb(map_data.light_type))

        nb = pos.dim() - 2                       # leading (lane) dims
        nbr_idx, nbr_valid = topk_neighbors(
            pos, pos, PT2PT_K, self.cfg.pl2pl_radius,
            query_mask=pt_valid_mask, key_mask=pt_valid_mask,
            exclude_self=True)
        rel_pos = gather_rows(pos, nbr_idx, nb) - pos[..., None, :]
        rel_orient = wrap_angle(gather_rows(orient, nbr_idx, nb)
                                - orient[..., None])
        orient_vec = torch.stack([torch.cos(orient), torch.sin(orient)], -1)
        r = torch.stack([
            torch.linalg.norm(rel_pos, dim=-1),
            angle_between_2d_vectors(orient_vec[..., None, :], rel_pos),
            rel_orient,
        ], dim=-1)
        r = self.r_pt2pt_emb(r)

        for i in range(self.cfg.num_map_layers):
            x_src = gather_rows(x_pt, nbr_idx, nb)
            x_pt = getattr(self, f"pt2pt_{i}")(
                x_pt[..., None, :], x_src, r[..., None, :, :],
                nbr_valid[..., None, :], generator)[..., 0, :]
        return x_pt

    def next_token_logits(self, x_pt):
        """The masked next-map-token head [..., P, map_token_size] (fp32,
        as the JAX head carries no compute dtype)."""
        return self.token_predict_head(x_pt)
