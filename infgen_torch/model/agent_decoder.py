"""Agent decoder: the rollout methods (port of
infgen_tpu/model/agent_decoder.py).

Every parameter of the flax module has its counterpart here, by the same
name, including the training-only heads (occupancy, grid-index). The
training forward (`__call__`, `run_trunk`, `run_seed_stack`, `run_refine`,
`embed_agents`, `embed_seeds`) belongs to the training slice; this module
carries what the closed-loop rollout calls.
"""

import torch
from torch import nn

from infgen_torch.config import Config
from infgen_torch.model.layers import (DenseAttention, Embed,
                                       FourierEmbedding, MLPEmbedding,
                                       MLPLayer)
from infgen_torch.ops import column_kernel as CK
from infgen_torch.ops import fused_block as FB
from infgen_torch.ops.precision import compute_dtype_of
from infgen_torch.utils.geometry import angle_between_2d_vectors

SEED_TYPE = 3  # AGENT_TYPE.index('seed')
INVALID_SHAPE_VALUE = 0.1


def map_token_index(idx, vocab_size: int):
    """Sentinel token ids (-2 bos, -1 invalid) -> embedding-table rows of
    the [vocab | bos | no-token] table."""
    return torch.where(idx >= 0, idx, vocab_size + 2 + idx)


class AgentDecoder(nn.Module):
    def __init__(self, cfg: Config, grid_xy, grid_size: int, angle_size: int):
        super().__init__()
        self.cfg = cfg
        self.grid_size = grid_size
        self.angle_size = angle_size
        self.register_buffer("grid_xy",
                             torch.as_tensor(grid_xy, dtype=torch.float32),
                             persistent=False)
        D = cfg.hidden_dim
        dt = compute_dtype_of(cfg.compute_dtype)
        self.dtype = dt

        self.type_a_emb = Embed(4, D, dtype=dt)
        self.shape_emb = MLPEmbedding(3, D, dtype=dt)
        self.state_a_emb = Embed(4, D, dtype=dt)

        F_ = cfg.num_freq_bands
        self.x_a_emb = FourierEmbedding(2, D, F_, dtype=dt)
        self.r_t_emb = FourierEmbedding(4, D, F_, dtype=dt)
        self.r_pt2a_emb = FourierEmbedding(3, D, F_, dtype=dt)
        self.r_a2a_emb = FourierEmbedding(3, D, F_, dtype=dt)
        self.r_pt2sa_emb = FourierEmbedding(3, D, F_, dtype=dt)
        self.r_a2sa_emb = FourierEmbedding(3, D, F_, dtype=dt)

        self.token_emb_veh = MLPEmbedding(8, D, dtype=dt)
        self.token_emb_ped = MLPEmbedding(8, D, dtype=dt)
        self.token_emb_cyc = MLPEmbedding(8, D, dtype=dt)
        self.token_emb_grid = MLPEmbedding(2, D, dtype=dt)
        self.no_token_emb = Embed(1, D, dtype=dt)
        self.bos_token_emb = Embed(1, D, dtype=dt)
        self.invalid_offset_token_emb = Embed(1, D, dtype=dt)

        n_inputs = 4 if cfg.use_grid_token else 3
        self.fusion_emb = MLPEmbedding(D * n_inputs, D, dtype=dt)

        def mk(bip, pos, name, n):
            layers = []
            for i in range(n):
                layer = DenseAttention(
                    D, cfg.num_heads, cfg.head_dim, bipartite=bip,
                    has_pos_emb=pos, use_pallas=cfg.use_pallas_attention,
                    dtype=dt)
                setattr(self, f"{name}_{i}", layer)
                layers.append(layer)
            return layers

        # plain lists of the registered layers (the names above are the
        # parameter names)
        self.t_attn_layers = mk(False, True, "t_attn", cfg.num_agent_layers)
        self.pt2a_attn_layers = mk(True, True, "pt2a", cfg.num_agent_layers)
        self.a2a_attn_layers = mk(False, True, "a2a", cfg.num_agent_layers)
        self.pt2sa_attn_layers = mk(True, True, "pt2sa", cfg.num_seed_layers)
        self.a2sa_attn_layers = mk(False, True, "a2sa", cfg.num_seed_layers)
        # flax creates occ2sa parameters only where they are called: with a
        # grid token
        self.occ2sa_attn_layers = mk(
            True, False, "occ2sa",
            cfg.num_seed_layers if cfg.use_grid_token else 0)

        G = grid_size
        self.token_predict_head = MLPLayer(D, D, cfg.token_size)
        self.state_predict_head = MLPLayer(D, D, 3)
        self.seed_state_predict_head = MLPLayer(D, D, 2)
        self.seed_type_predict_head = MLPLayer(D, D, 3)
        self.seed_shape_predict_head = MLPLayer(D, D, 3)
        if cfg.use_grid_token:
            self.seed_pos_rel_token_predict_head = MLPLayer(D, D, G)
            self.seed_offset_xy_predict_head = MLPLayer(D, D, 2)
            self.seed_agent_occ_embed = MLPLayer(G, D, D)
        else:
            self.seed_pos_rel_xy_predict_head = MLPLayer(D, D, 2)
        if cfg.use_head_token:
            self.seed_heading_rel_token_predict_head = MLPLayer(D, D,
                                                                angle_size)
        else:
            self.seed_heading_rel_theta_predict_head = MLPLayer(D, D, 1)
        if cfg.predict_occ:
            self.grid_agent_occ_head = MLPLayer(D, D, G)
            self.grid_pt_occ_head = MLPLayer(D, D, G)
        if cfg.use_grid_index_head:
            self.grid_index_head = MLPLayer(D, D, G)

    # ------------------------------------------------------------------ #
    # embedding tables and fused features
    # ------------------------------------------------------------------ #

    def token_emb_tables(self, agent_vocab):
        """[3, V+2, D] motion-token tables (vocab + bos + no-token), built
        from the last contour of each vocab entry."""
        V = self.cfg.token_size
        zero = torch.zeros(1, dtype=torch.long, device=self.grid_xy.device)
        tables = []
        for key, emb in (("veh", self.token_emb_veh),
                         ("ped", self.token_emb_ped),
                         ("cyc", self.token_emb_cyc)):
            base = emb(agent_vocab[key][:, -1].reshape(V, 8))
            tables.append(torch.cat([base, self.bos_token_emb(zero),
                                     self.no_token_emb(zero)], 0))
        return torch.stack(tables)

    def grid_emb_table(self):
        """[G+1, D]: grid-cell embeddings + a trailing invalid row."""
        zero = torch.zeros(1, dtype=torch.long, device=self.grid_xy.device)
        return torch.cat([self.token_emb_grid(self.grid_xy),
                          self.invalid_offset_token_emb(zero)], 0)

    def rollout_tables(self, agent_vocab):
        """Constant embedding tables the rollout reads."""
        zero = torch.zeros(1, dtype=torch.long, device=self.grid_xy.device)
        return dict(
            token_tables=self.token_emb_tables(agent_vocab),
            grid_table=self.grid_emb_table(),
            no_token=self.no_token_emb(zero)[0],
            bos_token=self.bos_token_emb(zero)[0],
        )

    def fuse_features(self, token_emb, motion_vector, head_vector, type_t,
                      shape_t, state, grid_emb):
        """Per-(agent, step) fused feature.

        token_emb [..., D]; motion_vector [..., 2]; head_vector [..., 2];
        type_t [...] int; shape_t [..., 3]; state [...] int; grid_emb [..., D].
        """
        feat = torch.stack([
            torch.linalg.norm(motion_vector, dim=-1),
            angle_between_2d_vectors(head_vector, motion_vector),
        ], dim=-1)
        cat = [self.type_a_emb(type_t), self.shape_emb(shape_t)]
        x_a = self.x_a_emb(feat, categorical_embs=cat)
        s_a = self.state_a_emb(state)
        parts = [token_emb, x_a, s_a]
        if self.cfg.use_grid_token:
            parts.append(grid_emb)
        return self.fusion_emb(torch.cat(parts, dim=-1))

    # ------------------------------------------------------------------ #
    # incremental (rollout) column methods
    # ------------------------------------------------------------------ #

    def motion_column(self, x_c, key_stack, t_r_raw, t_mask, a2a_r_raw,
                      a2a_mask, pl_keys, pl_r_raw, pl_mask, n_rows=None,
                      column_pack=None, fused_packs=None):
        """The trunk for ONE token column.

        x_c [..., A, D]; key_stack [L, ..., A, W, D]; t_r_raw [..., A, W, 4];
        t_mask [..., A, W]; a2a_r_raw [..., A, A, 3]; a2a_mask [..., A, A];
        pl_keys [..., A, K, D]; pl_r_raw / pl_mask per (agent, map key).
        The leading dims are the rollout's lanes (one scenario each).
        Returns (new_cols [L, ..., A, D], out [..., A, D]); new_cols[i] is
        what the cache stores for layer i+1.

        With `cfg.use_column_kernel` the whole column is one call of
        ops/column_kernel (the relation embeddings stay modules here), its
        parameters from `column_pack` (pack_column_params, built once per
        rollout; packed here when None). n_rows: optional int32 device
        scalar, the occupancy bound the kernel skips rows at; rows at or
        above it must have every key masked. The module path ignores it.

        With `cfg.use_fused_block` (and not the column kernel, which takes
        precedence) each of the 3L sublayers is one call of
        ops/fused_block, its parameters from `fused_packs`
        (pack_column_blocks, built once per rollout; packed here when
        None).

        Both kernels take one scenario's [A, ...] rows: with a lane axis
        they take one lane (n_rows then [1]) and refuse more.
        """
        if (self.cfg.use_column_kernel or self.cfg.use_fused_block) \
                and x_c.dim() == 3:
            if x_c.shape[0] != 1:
                flag = "use_column_kernel" if self.cfg.use_column_kernel \
                    else "use_fused_block"
                raise ValueError(f"{flag}: the kernel takes one lane, got "
                                 f"{x_c.shape[0]}")
            cols, out = self.motion_column(
                x_c[0], key_stack[:, 0], t_r_raw[0], t_mask[0], a2a_r_raw[0],
                a2a_mask[0], pl_keys[0], pl_r_raw[0], pl_mask[0],
                n_rows=None if n_rows is None else n_rows[0],
                column_pack=column_pack, fused_packs=fused_packs)
            return cols[:, None], out[None]
        r_t = self.r_t_emb(t_r_raw)
        r_aa = self.r_a2a_emb(a2a_r_raw)
        r_pl = self.r_pt2a_emb(pl_r_raw)
        if self.cfg.use_column_kernel:
            pack = column_pack or CK.pack_column_params(
                self, self.cfg.num_agent_layers, self.dtype)
            cdt = pack.dtype
            cols = CK.motion_column_kernel(
                pack, x_c.float().contiguous(), key_stack.to(cdt), r_t.to(cdt),
                t_mask.contiguous(), pl_keys.to(cdt).contiguous(),
                r_pl.to(cdt), pl_mask.contiguous(), r_aa.to(cdt),
                a2a_mask.contiguous(), self.cfg.num_heads, self.cfg.head_dim,
                n_rows=n_rows)
            # the cache carries the compute dtype, like the module path's
            # layer outputs; the column stayed fp32 inside the kernel
            if self.dtype is not None:
                cols = cols.to(self.dtype)
            return cols, cols[-1]
        x = x_c
        new_cols = []
        L, H = self.cfg.num_agent_layers, self.cfg.num_heads
        if self.cfg.use_fused_block:
            packs = fused_packs or FB.pack_column_blocks(self, L)
            x = x_c.contiguous()
            for i in range(L):
                x = FB.fused_attention_block(packs[3 * i], x, key_stack[i],
                                             r_t, t_mask, H)
                x = FB.fused_attention_block(packs[3 * i + 1], x, pl_keys,
                                             r_pl, pl_mask, H)
                x = FB.fused_attention_block(packs[3 * i + 2], x, None, r_aa,
                                             a2a_mask, H)
                new_cols.append(x)
            return torch.stack(new_cols), x
        for i in range(L):
            x = self.t_attn_layers[i](
                x[..., None, :], key_stack[i], r_t[..., None, :, :],
                t_mask[..., None, :])[..., 0, :]
            x = self.pt2a_attn_layers[i](
                x[..., None, :], pl_keys, r_pl[..., None, :, :],
                pl_mask[..., None, :])[..., 0, :]
            x = self.a2a_attn_layers[i](x, None, r_aa, a2a_mask)
            new_cols.append(x)
        return torch.stack(new_cols), x

    def prefill_column(self, x_c):
        """Zero-aggregate trunk chain for history column 0: [L, ..., A, D]."""
        x = x_c
        cols = []
        for i in range(self.cfg.num_agent_layers):
            x = self.t_attn_layers[i].zero_agg(x)
            x = self.pt2a_attn_layers[i].zero_agg(x)
            x = self.a2a_attn_layers[i].zero_agg(x)
            cols.append(x)
        return torch.stack(cols)

    def embed_pl2a_r(self, r_raw):
        return self.r_pt2a_emb(r_raw)

    def embed_a2a_r(self, r_raw):
        return self.r_a2a_emb(r_raw)

    def embed_pl2sa_r(self, pl_r_raw):
        return self.r_pt2sa_emb(pl_r_raw)

    def embed_a2sa_r(self, a2sa_r_raw):
        return self.r_a2sa_emb(a2sa_r_raw)

    def embed_occ(self, occ_vec):
        """Occupancy-vector embedding (the occ2sa key), fp32."""
        return self.seed_agent_occ_embed(occ_vec.float())

    def seed_key_chain(self, agent_col):
        """[num_seed_layers, ..., A, D]: the agent-row key snapshots each
        a2sa layer of the seed stack consumes (zero-aggregate chains,
        independent of the seed query)."""
        ag = agent_col
        keys = []
        for i in range(self.cfg.num_seed_layers):
            if self.cfg.use_grid_token:
                ag = self.occ2sa_attn_layers[i].zero_agg(ag)
            ag = self.pt2sa_attn_layers[i].zero_agg(ag)
            keys.append(ag)
            ag = self.a2sa_attn_layers[i].zero_agg(ag)
        return torch.stack(keys)

    def refine_column_sub(self, x_sub, pl_keys, pl_r_raw, pl_mask,
                          a2a_r_raw, a2a_mask):
        """Heading/offset refine on the inserted agent's subgraph.

        x_sub [..., 1+K, D]: row 0 the inserted agent, rows 1: its agent
        neighbours; only row 0 attends, the rest take the zero-aggregate
        path. pl_keys [..., Km, D]; pl_r_raw [..., Km, 3]; pl_mask
        [..., Km]; a2a_r_raw [..., K, 3]; a2a_mask [..., K]; leading dims
        are the rollout's lanes. Returns row 0's refined feature [..., D].
        """
        r_pl = self.r_pt2a_emb(pl_r_raw)
        r_aa = self.r_a2a_emb(a2a_r_raw)
        x = x_sub
        for i in range(self.cfg.num_seed_layers):
            q = self.pt2a_attn_layers[i](
                x[..., 0:1, None, :], pl_keys[..., None, :, :],
                r_pl[..., None, None, :, :],
                pl_mask[..., None, None, :])[..., 0, :]
            rest = self.pt2a_attn_layers[i].zero_agg(x[..., 1:, :])
            x = torch.cat([q, rest], -2)
            q = self.a2a_attn_layers[i](
                x[..., 0:1, None, :], x[..., None, 1:, :],
                r_aa[..., None, None, :, :],
                a2a_mask[..., None, None, :])[..., 0, :]
            rest = self.a2a_attn_layers[i].zero_agg(x[..., 1:, :])
            x = torch.cat([q, rest], -2)
        return x[..., 0, :]

    def motion_heads(self, feat_c):
        return self.token_predict_head(feat_c), self.state_predict_head(feat_c)

    def seed_heads(self, seed_feat):
        out = dict(
            state_logits=self.seed_state_predict_head(seed_feat),
            type_logits=self.seed_type_predict_head(seed_feat),
            shape=self.seed_shape_predict_head(seed_feat),
        )
        if self.cfg.use_grid_token:
            out["pos_logits"] = self.seed_pos_rel_token_predict_head(seed_feat)
        else:
            out["pos_xy"] = torch.tanh(
                self.seed_pos_rel_xy_predict_head(seed_feat))
        return out

    def refine_heads(self, feat):
        out = {}
        if self.cfg.use_head_token:
            out["head_logits"] = self.seed_heading_rel_token_predict_head(feat)
        else:
            out["head_theta"] = torch.tanh(
                self.seed_heading_rel_theta_predict_head(feat))[..., 0]
        if self.cfg.use_grid_token:
            out["offset_xy"] = torch.tanh(
                self.seed_offset_xy_predict_head(feat)) * 2.0
        return out
