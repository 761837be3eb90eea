"""Agent decoder: the training forward and the rollout methods (port of
infgen_tpu/model/agent_decoder.py).

Every parameter of the flax module has its counterpart here, by the same
name, including the grid-index head (its parameters exist for checkpoint
transplants; neither forward reads it). The training forward (`forward`,
the flax module's `__call__`) runs
  trunk   num_agent_layers x [temporal -> map2agent -> agent2agent]
  seeds   num_seed_layers x [occ2sa -> pt2sa -> a2sa]
  refine  num_seed_layers x [pt2a -> a2a] (the trunk's first layers)
over the padded node set (agents + seed rows). The rollout methods
(`motion_column`, `prefill_column`, `seed_key_chain`, `refine_column_sub`,
the heads) serve rollout/closed_loop.py. `seed_column`,
`seed_column_cached` and `refine_column` are the full-node-set forms of
one column that the rollout's forms are exact subsets of (the tests hold
them against each other); the rollout does not call them.
"""

import torch
import torch.nn.functional as F
from torch import nn

from infgen_torch.config import Config, ENTER_STATE, INVALID_STATE
from infgen_torch.model import edges as E
from infgen_torch.model.layers import (DenseAttention, Embed,
                                       FourierEmbedding, MLPEmbedding,
                                       MLPLayer)
from infgen_torch.ops import column_kernel as CK
from infgen_torch.ops import fused_block as FB
from infgen_torch.ops.neighbors import topk_neighbors
from infgen_torch.ops.precision import compute_dtype_of
from infgen_torch.utils.geometry import angle_between_2d_vectors, wrap_angle

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
                    dtype=dt, dropout=cfg.dropout,
                    remat=cfg.remat_attention)
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

    def embed_agents(self, inputs, agent_vocab):
        """Fused features of the real agents [A, T, D] and their heading
        vectors [A, T, 2]."""
        cfg = self.cfg
        tok = inputs.tokens
        tables = self.token_emb_tables(agent_vocab)              # [3, V+2, D]
        t_idx = map_token_index(tok.token_idx, cfg.token_size).long()
        token_emb = tables[inputs.agent_type.clamp(0, 2).long()[:, None],
                           t_idx]
        g_idx = torch.where(inputs.grid_token_idx >= 0,
                            inputs.grid_token_idx, self.grid_size).long()
        grid_emb = self.grid_emb_table()[g_idx]
        motion, head_vec = E.build_motion_vectors(
            tok.token_pos, tok.token_heading, tok.state_idx)
        is_invalid = tok.state_idx == INVALID_STATE
        type_t = torch.where(is_invalid, SEED_TYPE,
                             inputs.agent_type[:, None])
        shape_t = torch.where(is_invalid[..., None], INVALID_SHAPE_VALUE,
                              inputs.agent_shape[:, None, :])
        feat = self.fuse_features(token_emb, motion, head_vec, type_t,
                                  shape_t, tok.state_idx, grid_emb)
        return feat, head_vec

    def invalid_shape(self, *size, device):
        """The seeds' shape input, INVALID_SHAPE_VALUE, in the dtype of the
        shape embedding's weights: the JAX package's constant is weakly
        typed and takes the dtype it meets, so bf16-stored weights
        (param_dtype) embed it in bf16."""
        return torch.full(size, INVALID_SHAPE_VALUE, device=device,
                          dtype=self.shape_emb.Dense_0.weight.dtype)

    def embed_seeds(self, num_seed: int, T: int):
        """Seed-slot features [S, T, D]: invalid-state agents at the
        origin."""
        S, D = num_seed, self.cfg.hidden_dim
        dev = self.grid_xy.device
        zero = torch.zeros(1, dtype=torch.long, device=dev)
        token_emb = self.no_token_emb(zero)[0].expand(S, T, D)
        grid_emb = self.grid_emb_table()[self.grid_size // 2].expand(S, T, D)
        pos = torch.zeros(S, T, 2, device=dev)
        head = torch.zeros(S, T, device=dev)
        state = torch.full((S, T), INVALID_STATE, dtype=torch.long,
                           device=dev)
        motion, head_vec = E.build_motion_vectors(pos, head, state)
        type_t = torch.full((S, T), SEED_TYPE, dtype=torch.long, device=dev)
        shape_t = self.invalid_shape(S, T, 3, device=dev)
        return self.fuse_features(token_emb, motion, head_vec, type_t,
                                  shape_t, state, grid_emb)

    # ------------------------------------------------------------------ #
    # training forward
    # ------------------------------------------------------------------ #

    def _zero_agg(self, layer, x, generator=None):
        """Rows with no incident edges through `layer` (aggregate 0). In
        eval mode the closed form (DenseAttention.zero_agg); in train mode
        the module against one masked dummy key, so that its FFN dropout
        applies, as the JAX package does for deterministic=False."""
        if not self.training:
            return layer.zero_agg(x)
        dummy = torch.zeros(*x.shape[:-1], 1, x.shape[-1], dtype=x.dtype,
                            device=x.device)
        mask = torch.zeros(*x.shape[:-1], 1, 1, dtype=torch.bool,
                           device=x.device)
        return layer(x[..., None, :], dummy, None, mask,
                     generator)[..., 0, :]

    def run_trunk(self, feat, temporal, a2a, pl2a, x_pt, generator=None):
        """num_agent_layers x [temporal -> pt2a -> a2a] over the padded
        node set: feat [N, T, D]; temporal: TemporalEdges over N; a2a:
        StepEdges [T, N, N]; pl2a: GatherEdges [N, T, k]."""
        r_t = self.r_t_emb(temporal.r_raw)
        r_a2a = self.r_a2a_emb(a2a.r_raw)
        r_pl2a = self.r_pt2a_emb(pl2a.r_raw)
        for i in range(self.cfg.num_agent_layers):
            feat = self.t_attn_layers[i](feat, None, r_t, temporal.mask,
                                         generator)
            keys = x_pt[pl2a.idx]                               # [N, T, k, D]
            feat = self.pt2a_attn_layers[i](
                feat[:, :, None, :], keys, r_pl2a[:, :, None, :, :],
                pl2a.mask[:, :, None, :], generator)[:, :, 0, :]
            ft = self.a2a_attn_layers[i](feat.transpose(0, 1), None, r_a2a,
                                         a2a.mask, generator)
            feat = ft.transpose(0, 1)
        return feat

    def run_seed_stack(self, feat, num_seed: int, occ_emb, pl2sa_mask,
                       r_pl2sa_raw, a2sa, x_pt, generator=None):
        """num_seed_layers x [occ2sa -> pt2sa -> a2sa]. feat [N, T, D], its
        last `num_seed` rows the seeds; agent rows take the zero-aggregate
        path in every sublayer. occ_emb [S, T, D] or None; pl2sa_mask
        [T, P]; r_pl2sa_raw [T, P, 3]; a2sa: StepEdges [T, S, A]."""
        S = num_seed
        A = feat.shape[0] - S
        r_pl2sa = self.r_pt2sa_emb(r_pl2sa_raw)                 # [T, P, D]
        r_a2sa = self.r_a2sa_emb(a2sa.r_raw)                    # [T, S, A, D]
        for i in range(self.cfg.num_seed_layers):
            ag, sd = feat[:A], feat[A:]
            if self.cfg.use_grid_token and occ_emb is not None:
                ones = torch.ones(S, sd.shape[1], 1, 1, dtype=torch.bool,
                                  device=sd.device)
                sd = self.occ2sa_attn_layers[i](
                    sd[:, :, None, :], occ_emb[:, :, None, :], None, ones,
                    generator)[:, :, 0, :]
                ag = self._zero_agg(self.occ2sa_attn_layers[i], ag,
                                    generator)
            sd_t = sd.transpose(0, 1)                            # [T, S, D]
            T = sd_t.shape[0]
            keys = x_pt[None].expand(T, *x_pt.shape)
            sd_t = self.pt2sa_attn_layers[i](
                sd_t, keys, r_pl2sa,
                pl2sa_mask[:, None, :].expand(T, S, pl2sa_mask.shape[1]),
                generator)
            ag = self._zero_agg(self.pt2sa_attn_layers[i], ag, generator)
            sd_t = self.a2sa_attn_layers[i](sd_t, ag.transpose(0, 1),
                                            r_a2sa, a2sa.mask, generator)
            ag = self._zero_agg(self.a2sa_attn_layers[i], ag, generator)
            feat = torch.cat([ag, sd_t.transpose(0, 1)], 0)
        return feat

    def run_refine(self, feat, pl2sa, a2sa_idx, a2sa_mask, a2sa_r_raw, x_pt,
                   generator=None):
        """num_seed_layers x [pt2a -> a2a] on the trunk's layers 0.. :
        feat [A, T, D]; pl2sa: map keys per (a, t); a2sa_*: agent keys per
        (a, t), gathered from the evolving features."""
        r_pl = self.r_pt2a_emb(pl2sa.r_raw)
        r_aa = self.r_a2a_emb(a2sa_r_raw)
        T = feat.shape[1]
        t_ix = torch.arange(T, device=feat.device)[None, :, None]
        for i in range(self.cfg.num_seed_layers):
            feat = self.pt2a_attn_layers[i](
                feat[:, :, None, :], x_pt[pl2sa.idx], r_pl[:, :, None, :, :],
                pl2sa.mask[:, :, None, :], generator)[:, :, 0, :]
            feat = self.a2a_attn_layers[i](
                feat[:, :, None, :], feat[a2sa_idx, t_ix],
                r_aa[:, :, None, :, :], a2sa_mask[:, :, None, :],
                generator)[:, :, 0, :]
        return feat

    def forward(self, inputs, x_pt, agent_vocab, pt_pos, pt_orient, pt_mask,
                generator=None, hist_drop=None, sa_uniform=None):
        """The training forward of one scenario (the flax module's
        `__call__`): inputs, ModelInputs of [A, T] tensors; x_pt [P, D] the
        map features. Returns the dict of predictions, ground truths and
        masks that train/losses.compute_losses reads.

        Random draws: in train mode the temporal key drop
        (training_hist_mask: `hist_drop` [A, 10] step indices, else from
        `generator`) and the dropout masks (from `generator`); in both
        modes the refine pass's pseudo-seed scores (`sa_uniform` [A, T] in
        [0, 1), else from `generator`). Eval mode drops nothing, as
        deterministic=True does in JAX."""
        cfg = self.cfg
        tok = inputs.tokens
        A, T = tok.token_idx.shape
        S = cfg.num_seed_feature
        dev = x_pt.device
        train = self.training
        if generator is None and (sa_uniform is None or (train and (
                hist_drop is None or cfg.dropout > 0.0))):
            raise ValueError("AgentDecoder.forward: draws without a "
                             "torch.Generator")
        gen = generator if train else None       # the layers' dropout

        feat_a, head_vec = self.embed_agents(inputs, agent_vocab)
        feat_seed = self.embed_seeds(S, T)
        pos, head, state = tok.token_pos, tok.token_heading, tok.state_idx
        slot = inputs.slot_mask
        ego_pos, ego_head = inputs.ego_pos, inputs.ego_head
        ego_hv = torch.stack([torch.cos(ego_head), torch.sin(ego_head)], -1)

        # ---- masks ----
        hist = E.training_hist_mask(tok.raw_token_valid, state,
                                    gen, hist_drop if train else None)
        hist = hist & slot[:, None]
        interact = (tok.raw_token_valid | (state == ENTER_STATE)) \
            & slot[:, None]

        # padded node set: agents + seeds (seeds sit on ego)
        no = torch.zeros(S, T, dtype=torch.bool, device=dev)
        pos_p = torch.cat([pos, ego_pos.expand(S, T, 2)], 0)
        head_p = torch.cat([head, ego_head.expand(S, T)], 0)
        state_p = torch.cat([state, torch.full((S, T), INVALID_STATE,
                                               dtype=state.dtype,
                                               device=dev)], 0)
        hv_p = torch.cat([head_vec, ego_hv.expand(S, T, 2)], 0)
        temporal = E.build_temporal_edges(
            pos_p, head_p, state_p, hv_p, torch.cat([hist, no], 0),
            cfg.time_span // cfg.shift)
        interact_p = torch.cat([interact, no], 0)
        a2a = E.build_a2a_edges(pos_p, head_p, state_p, hv_p, interact_p,
                                cfg.a2a_radius)
        pl2a = E.build_pl2a_edges(pos_p, head_p, state_p, hv_p, interact_p,
                                  pt_pos, pt_orient, pt_mask,
                                  cfg.pl2a_radius, cfg.pl2a_num_neighbors)

        # ---- trunk ----
        feat = self.run_trunk(torch.cat([feat_a, feat_seed], 0), temporal,
                              a2a, pl2a, x_pt, gen)
        trunk_feat = feat[:A]
        out = dict(next_token_logits=self.token_predict_head(trunk_feat),
                   next_state_logits=self.state_predict_head(trunk_feat))

        # ---- seed stack (insertion prediction) ----
        seq_mask = E.build_seq_mask(inputs.sort_indices, inputs.av_index, S,
                                    A)
        a2sa = E.build_a2sa_edges(
            pos, head, state, head_vec, interact, ego_pos.expand(S, T, 2),
            ego_head.expand(S, T), ego_hv.expand(S, T, 2),
            cfg.pl2seed_radius, seq_mask=seq_mask)
        pl2sa_mask, r_pl2sa_raw = E.build_pl2sa_edges(
            ego_pos, ego_head, ego_hv, pt_pos, pt_orient, pt_mask,
            cfg.pl2seed_radius)

        # occupancy ground truth: the occ2sa input and the occ targets
        G = self.grid_size
        gidx = inputs.grid_token_idx
        grid_oh = F.one_hot(torch.where(gidx >= 0, gidx, 0).long(),
                            G).float() * (gidx >= 0)[..., None]
        occ_agent_gt = (torch.einsum("tsa,atg->stg", a2sa.mask.float(),
                                     grid_oh) > 0).float()     # [S, T, G]
        pidx = inputs.pt_grid_token_idx                          # [T, P]
        occ_pt = torch.zeros(T, G + 1, device=dev).scatter_(
            1, torch.where(pidx >= 0, pidx, G).long(), 1.0)[:, :G]
        occ_emb = self.seed_agent_occ_embed(occ_agent_gt) \
            if cfg.use_grid_token else None

        feat_sa = self.run_seed_stack(torch.cat([feat_a, feat_seed], 0), S,
                                      occ_emb, pl2sa_mask, r_pl2sa_raw, a2sa,
                                      x_pt, gen)
        seed_feat = feat_sa[A:]
        heads = self.seed_heads(seed_feat)
        out.update(seed_state_logits=heads["state_logits"],
                   seed_type_logits=heads["type_logits"],
                   seed_shape=heads["shape"],
                   seed_pos_logits=heads.get("pos_logits"),
                   seed_pos_xy=heads.get("pos_xy"),
                   occ_agent_logits=None, occ_pt_logits=None,
                   occ_agent_gt=occ_agent_gt,
                   occ_pt_gt=occ_pt[None].expand(S, T, G))
        if cfg.predict_occ:
            out.update(occ_agent_logits=self.grid_agent_occ_head(seed_feat),
                       occ_pt_logits=self.grid_pt_occ_head(seed_feat))

        # ---- refine stage: pseudo-seed rows, up to 10 random eligible
        # in-grid rows per step plus every enter row; never step 0 nor the
        # AV ----
        eligible = (state != INVALID_STATE) & (gidx != -1) & slot[:, None]
        if sa_uniform is None:
            sa_uniform = torch.rand(A, T, generator=generator,
                                    device=generator.device)
        scores = torch.where(eligible, sa_uniform.to(dev), -torch.inf)
        kth = torch.sort(scores, dim=0).values[-10][None]      # 10 per step
        mask_sa = (eligible & (scores >= kth)) | (state == ENTER_STATE)
        mask_sa[:, 0] = False
        mask_sa[inputs.av_index.long()] = False

        state_sa = torch.where(mask_sa, ENTER_STATE, INVALID_STATE)
        head_sa = torch.where(mask_sa, ego_head[None], head)
        motion_sa, hv_sa = E.build_motion_vectors(pos, head_sa, state_sa)
        motion_sa = torch.where(mask_sa[..., None], E.MOTION_GAP, motion_sa)
        g_idx = torch.where(gidx >= 0, gidx, G).long()
        zero = torch.zeros(1, dtype=torch.long, device=dev)
        refine_token_emb = torch.where(mask_sa[..., None],
                                       self.bos_token_emb(zero)[0],
                                       self.no_token_emb(zero)[0])
        refine_feat = self.fuse_features(
            refine_token_emb, motion_sa, hv_sa,
            inputs.agent_type[:, None].expand(A, T),
            inputs.agent_shape[:, None].expand(A, T, 3), state_sa,
            self.grid_emb_table()[g_idx])
        refine_feat = torch.where(mask_sa[..., None], refine_feat, feat_a)

        # refine edges: agents within a2sa_radius (k = 8) per step, map
        # tokens within pl2sa_radius (k = 32)
        pos_t = pos.transpose(0, 1)
        idx8, val8 = topk_neighbors(
            pos_t, pos_t, 8, cfg.a2sa_radius,
            key_mask=(interact & ~mask_sa).transpose(0, 1),
            exclude_self=True)
        idx8 = idx8.transpose(0, 1)                              # [A, T, 8]
        val8 = val8.transpose(0, 1) & mask_sa[..., None]
        t_ix = torch.arange(T, device=dev)[None, :, None]
        rel_pos8 = pos[idx8, t_ix] - pos[:, :, None]
        r8 = torch.stack([
            torch.linalg.norm(rel_pos8, dim=-1),
            angle_between_2d_vectors(hv_sa[:, :, None], rel_pos8),
            wrap_angle(head[idx8, t_ix] - head_sa[:, :, None]),
        ], dim=-1)
        pl_refine = E.build_pl2a_edges(pos, head_sa, state_sa, hv_sa,
                                       mask_sa, pt_pos, pt_orient, pt_mask,
                                       cfg.pl2sa_radius, 32)
        # drop sampled rows with no neighbours at all
        mask_sa = mask_sa & (val8.any(-1) | pl_refine.mask.any(-1))

        refine_out = self.run_refine(refine_feat, pl_refine, idx8, val8, r8,
                                     x_pt, gen)
        rh = self.refine_heads(refine_out)
        out.update(head_logits=rh.get("head_logits"),
                   head_theta=rh.get("head_theta"),
                   offset_xy=rh.get("offset_xy"),
                   mask_sa=mask_sa, trunk_feat=trunk_feat)
        return out

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
        rollout; packed here when None); with a lane axis one call takes
        every lane's [B, A, ...] rows, the agent-agent keys within each
        lane. n_rows: optional int32 device scalar ([B] with lanes), the
        occupancy bound the kernel skips rows at; rows at or above it must
        have every key masked. The module path ignores it.

        With `cfg.use_fused_block` (and not the column kernel, which takes
        precedence) each of the 3L sublayers is one call of
        ops/fused_block, its parameters from `fused_packs`
        (pack_column_blocks, built once per rollout; packed here when
        None); with a lane axis one call takes every lane's [B, A, ...]
        rows, the agent-agent keys within each lane.
        """
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

    def seed_column(self, agent_col, seed_vec, occ_vec, pl_keys_mask, r_pl,
                    a2sa_r_raw, a2sa_mask, x_pt):
        """The insertion seed stack of one column over the full node set:
        agent_col [A, D]; seed_vec [D]; occ_vec [G] binary occupancy;
        pl_keys_mask [P]; r_pl [P, D] (embed_pl2sa_r); a2sa_r_raw [A, 3];
        a2sa_mask [A]; x_pt [P, D]. The agent rows ride through every
        sublayer with zero aggregate (no incident edges); returns the seed
        feature [D]."""
        cfg = self.cfg
        r_sa = self.r_a2sa_emb(a2sa_r_raw)                       # [A, D]
        occ_emb = self.embed_occ(occ_vec) if cfg.use_grid_token else None
        ones = torch.ones(1, 1, dtype=torch.bool, device=agent_col.device)
        ag, sd = agent_col, seed_vec
        for i in range(cfg.num_seed_layers):
            if occ_emb is not None:
                sd = self.occ2sa_attn_layers[i](sd[None], occ_emb[None],
                                                None, ones)[0]
                ag = self.occ2sa_attn_layers[i].zero_agg(ag)
            sd = self.pt2sa_attn_layers[i](sd[None], x_pt, r_pl,
                                           pl_keys_mask[None])[0]
            ag = self.pt2sa_attn_layers[i].zero_agg(ag)
            sd = self.a2sa_attn_layers[i](sd[None], ag, r_sa,
                                          a2sa_mask[None])[0]
            ag = self.a2sa_attn_layers[i].zero_agg(ag)
        return sd

    def seed_column_cached(self, ag_keys, seed_vec, occ_vec, pl_keys_mask,
                           r_pl, a2sa_r_raw, a2sa_mask, x_pt):
        """seed_column from the agent rows' key snapshots (seed_key_chain,
        [num_seed_layers, A, D]): only the seed row runs the stack. The
        same math."""
        cfg = self.cfg
        r_sa = self.r_a2sa_emb(a2sa_r_raw)
        occ_emb = self.embed_occ(occ_vec) if cfg.use_grid_token else None
        ones = torch.ones(1, 1, dtype=torch.bool, device=seed_vec.device)
        sd = seed_vec
        for i in range(cfg.num_seed_layers):
            if occ_emb is not None:
                sd = self.occ2sa_attn_layers[i](sd[None], occ_emb[None],
                                                None, ones)[0]
            sd = self.pt2sa_attn_layers[i](sd[None], x_pt, r_pl,
                                           pl_keys_mask[None])[0]
            sd = self.a2sa_attn_layers[i](sd[None], ag_keys[i], r_sa,
                                          a2sa_mask[None])[0]
        return sd

    def refine_column(self, x_col, query_onehot, pl_keys, pl_r_raw, pl_mask,
                      a2a_idx, a2a_r_raw, a2a_mask, x_pt):
        """The heading/offset refine of one column over the full node set,
        on the trunk's layers 0..num_seed_layers-1: x_col [A, D];
        query_onehot [A] bool (the inserted agent); pl_keys [A, Km] map key
        ids; pl_r_raw [A, Km, 3]; pl_mask [A, Km]; a2a_idx [A, Ka] agent
        key ids; a2a_r_raw [A, Ka, 3]; a2a_mask [A, Ka]; x_pt [P, D]. Only
        the query row has keys: every other row passes with zero
        aggregate. Returns [A, D]; refine_column_sub is the query row's.

        With `cfg.use_fused_block` each sublayer is one call of
        ops/fused_block at all A rows, keys per query (the map keys
        x_pt[pl_keys], then the agent keys x[a2a_idx] of the running
        column), fp32 throughout, as the JAX package's fused branch."""
        r_pl = self.r_pt2a_emb(pl_r_raw)                    # [A, Km, D]
        r_aa = self.r_a2a_emb(a2a_r_raw)                    # [A, Ka, D]
        pl_m = pl_mask & query_onehot[:, None]
        aa_m = a2a_mask & query_onehot[:, None]
        x = x_col
        if self.cfg.use_fused_block:
            f32, H = torch.float32, self.cfg.num_heads
            x = x.to(f32).contiguous()
            r_pl, r_aa = r_pl.to(f32).contiguous(), r_aa.to(f32).contiguous()
            x_pt = x_pt.to(f32)
            for i in range(self.cfg.num_seed_layers):
                x = FB.fused_attention_block(
                    FB.pack_fused_block(self.pt2a_attn_layers[i]), x,
                    x_pt[pl_keys].contiguous(), r_pl, pl_m, H)
                x = FB.fused_attention_block(
                    FB.pack_fused_block(self.a2a_attn_layers[i]), x,
                    x[a2a_idx].contiguous(), r_aa, aa_m, H)
            return x
        for i in range(self.cfg.num_seed_layers):
            x = self.pt2a_attn_layers[i](
                x[:, None, :], x_pt[pl_keys], r_pl[:, None],
                pl_m[:, None])[:, 0, :]
            x = self.a2a_attn_layers[i](
                x[:, None, :], x[a2a_idx], r_aa[:, None],
                aa_m[:, None])[:, 0, :]
        return x

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
