"""Closed-loop rollout: the flagship path (port of
infgen_tpu/rollout/closed_loop.py).

The JAX package compiles the rollout into one `lax.scan`; here it is three
tensor programs over the model, which `make_rollout_fn` builds and calls
(and exposes as attributes of the function it returns):

  prologue(scenario, inputs) -> (carry, ctx)
      map encoding, tables, the kernels' packs built from the parameters,
      carry init and the column-0 cache prefill
  step(carry, ctx, col, insert, u_ins, u_mot) -> (carry, out)
      one token step at column `col`, a 0-d int64 tensor: insertion (when
      `insert`), then motion, heads and de-tokenization. Nothing in it is
      keyed on the column's value: its column and window reads are
      fixed-width gathers and its writes index copies. Under the
      fixed-trip loop it is insertion_open (the first seed evaluation),
      insert_limit times insertion_iter, and close_step
  epilogue(carry, outs, scenario, inputs, ctx) -> dict
      the outputs

The eager rollout runs them under a Python loop over token steps (step 0
without insertion); rollout/export.py traces the same functions with
torch.export (the step as its three parts, the insertion loop's iteration
once) and loops over the programs. Within a step:

  - agent insertion = slot activation inside padded arrays: a bounded loop
    of at most `insert_limit` iterations per step, with occupancy rejection;
  - an incremental per-layer feature cache [L, A, Ti, D]: each step
    refreshes ONE token column;
  - top-k sampling on the device, by inverse CDF of uniform variates
    (ops/sampling.py);
  - trajectories stay on the device until the loop ends.

Random draws. Each lane draws uniform variates from its own
`torch.Generator`, per step in a fixed order: first the insertion's,
n_cand = max(insert_limit, 1) per seed evaluation, then the motion's, one
per agent slot. Under the early-exit insertion loop a lane draws only for
the evaluations it runs; under `cfg.insertion_fixed_trip` every lane draws
for all insert_limit + 1 evaluations at the step's start
(ops/sampling.step_variates) and the step takes the variates as tensors,
which is what the exported step program takes, so the eager rollout and
the artifact give the same results bit for bit. Nothing is drawn at beam
size 1.

Lanes. Every tensor of the rollout carries a leading lane axis B, one
scenario per lane (JAX's one rollout function under `vmap`): the scenario
and inputs are stacked (data.scenario.stack_scenarios) and each lane has a
generator of its own. A single scenario is one lane, the axis squeezed on
output. Per lane the result is the single rollout's of that scenario with
that generator. The insertion loop runs while any lane runs; a stopped
lane is frozen by the select of the fixed-trip form, and only running lanes
draw. Every kernel takes every lane in one launch (the seed and refine
kernels skip the lanes that stopped or do not insert; the column kernel
skips each lane's rows past its own occupancy bound).

The big rollout state (`RolloutCarry`, rollout/carry.py) is updated in
place, column by column; the small per-step insertion state is rebuilt
functionally, so that the fixed-trip form can keep or drop a whole
iteration with one select. `cfg.rollout_scan_unroll` is read and ignored:
an eager loop has no scan to unroll.

Host reads: the insertion loop's early exit reads the lanes' `running`
flags on the host once per iteration (at most `insert_limit + 1` times per
step, whatever the number of lanes); `cfg.insertion_fixed_trip` runs
exactly `insert_limit` masked iterations and reads nothing. Both give the
same results whenever no random draw is made (beam sizes 1); with
sampling, the fixed-trip form draws for the discarded iterations too, so
its stream differs.

Profiler spans (`torch.profiler.record_function`, near free when no
profiler runs): `rollout.insertion` and `rollout.motion` per token step;
`infgen_torch/trace_rollout.py` reads them.

Kernels, as in the JAX package (each flag picks a CUDA kernel, reached
through its registered op `infgen::*`; the op takes its plain twin for CPU
tensors):
  use_seed_kernel       the seed stack + heads from per-step K/V
                        (ops/seed_kernel.seed_eval_kernel)
  use_seed_kernel_full  the same with the per-step precompute folded in
                        (seed_eval_full_kernel); supersedes the former. Each
                        insert then patches only the raw feature row, its
                        geometry embedding, the mask row and the occupancy bit
  use_refine_kernel     the per-insert refine pass (ops/refine_kernel)
  use_column_kernel     the whole trunk column (ops/column_kernel), with the
                        occupancy bound n_rows computed on the device, one
                        per lane
  use_fused_block       each of the trunk's 3L sublayers as one call
                        (ops/fused_block); the column kernel takes
                        precedence
  use_pallas_attention  the attention core of every eligible DenseAttention
                        call (ops/pallas_attention.r_biased_attention): in
                        a rollout, the agent-agent sublayers of the trunk
All packs are built once per rollout, by the prologue.

Column convention (num_historical_steps=11, SHIFT=5): token columns 0..1
hold history; rollout step t has "current" column c = 1 + t and writes
c + 1.
"""

import math
from typing import Any, Dict

import numpy as np
import torch
from torch.profiler import record_function

from infgen_torch.config import (Config, ENTER_STATE, EXIT_STATE,
                                 INVALID_STATE, SHIFT, VALID_STATE)
from infgen_torch.data.scenario import tree_map
from infgen_torch.model import edges as E
from infgen_torch.model.agent_decoder import (INVALID_SHAPE_VALUE, SEED_TYPE,
                                              map_token_index)
from infgen_torch.model.layers import lane_products
from infgen_torch.ops import column_kernel as CK
from infgen_torch.ops import fused_block as FB
from infgen_torch.ops import refine_kernel as RFK
from infgen_torch.ops import seed_fast as SF
from infgen_torch.ops import seed_kernel as SKN
from infgen_torch.ops.neighbors import (arange_on, gather_rows,
                                        topk_neighbors)
from infgen_torch.ops.precision import compute_dtype_of
from infgen_torch.ops.sampling import (draw_uniforms, sample_from_topk,
                                       step_variates, topk_inverse_cdf,
                                       topk_stable)
from infgen_torch.rollout.carry import RolloutCarry
from infgen_torch.utils.geometry import (angle_between_2d_vectors,
                                         heading_from_contour, rot_mat_2d,
                                         wrap_angle)

REFINE_A2SA_K = 24   # reference max_num_neighbors=24
REFINE_PL2SA_K = 32  # 10 m radius holds far fewer map tokens


def _argmax_first(x, dim=-1):
    """First index of the maximum (jnp.argmax's order); bool allowed."""
    if x.dtype == torch.bool:
        x = x.to(torch.int32)
    return torch.argmax(x, dim=dim)


def _rows(x, idx):
    """x[b, idx[b, ...]] in every lane b (x [B, N, ...], idx [B, ...]):
    a gather on the device, no host read."""
    return gather_rows(x, idx, 1)


def _put(x, idx, val, mask=None, dim=1):
    """x with x[b, ..., idx[b], ...] = val[b] along `dim` in every lane b
    where mask[b] (idx, mask [B]), as a new tensor. An index out of range
    writes nothing (JAX's scatter drop)."""
    n = x.shape[dim]
    hit = arange_on(n, x.device)[None] == idx[:, None]
    if mask is not None:
        hit = hit & mask[:, None]
    shape = [x.shape[0]] + [1] * (x.dim() - 1)
    shape[dim] = n
    val = torch.as_tensor(val, dtype=x.dtype, device=x.device)
    val = val.unsqueeze(dim) if val.dim() == x.dim() - 1 else val
    return torch.where(hit.reshape(shape), val, x)


def _tree_where(pred, new, old):
    """new where the lane flag pred [B] holds, else old, leaf by leaf."""
    if isinstance(new, dict):
        return {k: _tree_where(pred, new[k], old[k]) for k in new}
    if isinstance(new, tuple):
        return tuple(_tree_where(pred, a, b) for a, b in zip(new, old))
    return torch.where(pred.reshape(-1, *[1] * (new.dim() - 1)), new, old)


def _vecmat(x, m):
    """x[b] @ m[b] for every lane (x [B, n], m [B, n, k]) as one vector-
    matrix product per lane: the single rollout's product, bit for bit."""
    return _stack_lanes([xb @ mb for xb, mb in zip(x, m)])


def _stack_lanes(xs):
    """The per-lane results xs along a new lane axis: one lane is a view,
    with no copy launched."""
    return xs[0][None] if len(xs) == 1 else torch.stack(xs)


def _at(x, col, dim=2):
    """x's column `col` (a 0-d index tensor) along `dim`, the axis dropped:
    a gather on the device, no host read."""
    return x.index_select(dim, col.reshape(1)).squeeze(dim)


def _set_at(x, col, val, dim=2):
    """x's column `col` along `dim` = val (x's shape without that axis), in
    place."""
    x.index_copy_(dim, col.reshape(1), val.to(x.dtype).unsqueeze(dim))


def _span_cols(start, n, device):
    """The n columns from `start` (a 0-d tensor) on: [n] int64."""
    return start + arange_on(n, device)


def make_rollout_fn(model, cfg: Config, attr, motion_tok, map_vocab,
                    num_recurrent_steps: int = None,
                    force_insert: bool = False, debug: bool = False):
    """Build `rollout(scenario, inputs, generator) -> dict`.

    `model` is an InfGenModel on the device the rollout runs on; `scenario`
    and `inputs` are tensors on that device (data.scenario.to_device,
    data.features.build_model_inputs) and `generator` a torch.Generator on
    it. With a list of generators, one per lane, `scenario` and `inputs`
    are stacked along a leading lane axis (data.scenario.stack_scenarios,
    data.features.build_model_inputs_batch) and every output gains it.
    Every kernel takes the lanes in one launch per call.
    force_insert=True makes every insertion iteration propose
    an agent whatever the seed-state head says (bounds the trained-model
    insertion cost for benchmarking). The returned function counts its
    host reads in `rollout.host_reads` (reset at each call), and carries
    its three programs (the module docstring) as `rollout.prologue`,
    `rollout.step` and `rollout.epilogue`, the fixed-trip step's three
    parts as `rollout.insertion_open`, `rollout.insertion_iter` and
    `rollout.close_step`, with `rollout.n_steps`,
    `rollout.variate_counts(insert)` (the counts ops/sampling.step_variates
    takes for a step) and `rollout.flat_ctx` / `rollout.unflat_ctx` (the
    step's context with every pack as its buffers, and back), which an
    exported rollout (rollout/export.py) needs.

    debug=True adds the JAX package's per-step debug outputs
    `debug_token_logits` [n_steps, A, V], `debug_state_logits` [n_steps,
    A, 3] (the motion heads' fp32 logits) and `debug_layer_cols` [n_steps,
    L, A, D] (the trunk's per-layer column, the last one the heads' input),
    and the port's insertion records: for each head that decides an
    insertion, `debug_{head}_top2` [n_steps, E, 2] (the indices of its two
    largest fp32 logits, the first its choice; -1 past the step's last
    evaluation) and `debug_{head}_gap` [n_steps, E] (their logit gap; inf
    there), evaluation j of the step deciding its insert j (or ending the
    step). The heads: `seed_type` and `seed_grid` (with grid tokens) over
    E = insert_limit + 1 seed evaluations, and `refine_head` (the heading,
    with head tokens) over E = max(insert_limit, 1) refine passes. A lane that stopped while others
    ran (or under insertion_fixed_trip) also records the evaluations made
    past its stop, which the loop discarded. A lane axis leads each, as on
    every output. For bisecting two rollouts'
    decisions; it keeps every step's logits.
    """
    R = num_recurrent_steps or cfg.num_recurrent_steps_val
    if R < SHIFT or R % SHIFT:
        raise ValueError(f"num_recurrent_steps is in 10 Hz frames and must be"
                         f" a positive multiple of SHIFT={SHIFT}, got {R}")
    n_steps = R // SHIFT
    Ti = (R + cfg.num_historical_steps) // SHIFT
    H = (cfg.num_historical_steps - 1) // SHIFT          # 2 history columns
    A = cfg.max_agents
    D = cfg.hidden_dim
    L = cfg.num_agent_layers
    L_s = cfg.num_seed_layers
    W = min(cfg.time_span // SHIFT, Ti)                  # temporal window 12
    G = attr.grid_size
    limit = cfg.insert_limit
    dec = model.agent_decoder
    device = next(model.parameters()).device
    sf_dt = compute_dtype_of(cfg.compute_dtype)          # seed-path dtype
    use_sknf = cfg.use_seed_kernel_full and cfg.use_grid_token
    use_skn = ((cfg.use_seed_kernel or cfg.use_seed_kernel_full)
               and cfg.use_grid_token and not use_sknf)
    use_refk = (cfg.use_refine_kernel and cfg.use_head_token
                and cfg.use_grid_token)
    use_fused = cfg.use_fused_block and not cfg.use_column_kernel

    f32, i32 = torch.float32, torch.int32
    token_traj_all = torch.as_tensor(np.stack(
        [np.asarray(motion_tok.vocab[k]) for k in ("veh", "ped", "cyc")]),
        device=device)                                   # [3, V, 6, 4, 2]
    agent_vocab = {k: torch.as_tensor(np.asarray(v), device=device)
                   for k, v in motion_tok.vocab.items()}
    map_traj = torch.as_tensor(np.asarray(map_vocab["traj_src"]),
                               device=device)
    grid_xy = attr.grid_on(device)

    # debug: the current step's insertion decisions, per head one (top-two
    # indices [B, 2], gap [B]) per evaluation
    picks = {}
    pick_width = dict(seed_type=limit + 1)
    if cfg.use_grid_token:
        pick_width["seed_grid"] = limit + 1
    if cfg.use_head_token:
        pick_width["refine_head"] = max(limit, 1)

    def note_pick(head, logits):
        if debug:
            top = torch.topk(logits.to(f32), 2, dim=-1)
            picks.setdefault(head, []).append(
                (top.indices, top.values[..., 0] - top.values[..., 1]))

    def vec(*xs, dtype=f32):
        return torch.tensor(xs, dtype=dtype, device=device)

    def stack3(a, b, c):
        return torch.stack([a, b, c], dim=-1)

    def hv_of(theta):
        return torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)

    # ---------------------------------------------------------------- #

    n_cand = max(limit, 1)   # grid draws per seed evaluation (0 limit:
                             # eval-only profiling)
    draws_ins = cfg.use_grid_token and cfg.insert_beam_size > 1
    draws_mot = cfg.motion_beam_size > 1

    @torch.no_grad()
    def rollout(scenario, inputs, generator) -> Dict[str, Any]:
        rollout.host_reads = 0
        picks.clear()
        lanes = isinstance(generator, (list, tuple))
        if not lanes:
            scenario, inputs = (tree_map(lambda x: x[None], t)
                                for t in (scenario, inputs))
            generator = [generator]
        B = len(generator)
        if inputs.slot_mask.shape[0] != B:
            raise ValueError(f"{B} generators for "
                             f"{inputs.slot_mask.shape[0]} lanes")
        out = _rollout(scenario, inputs, list(generator))
        return out if lanes else {k: v[0] for k, v in out.items()}

    def _rollout(scenario, inputs, gens):
        carry, ctx = prologue(scenario, inputs)
        cols = arange_on(Ti, device)
        outs = []
        for t in range(n_steps):
            insert = not cfg.disable_insertion and t > 0
            if cfg.insertion_fixed_trip:
                u_ins, u_mot = step_variates(gens, device,
                                             *variate_counts(insert))
                carry, out = step(carry, ctx, cols[t + 1], insert, u_ins,
                                  u_mot)
            else:
                carry, out = step(carry, ctx, cols[t + 1], insert,
                                  gens=gens)
            outs.append(out)
        outs = {k: torch.stack([o[k] for o in outs], 1) for k in outs[0]}
        return epilogue(carry, outs, scenario, inputs, ctx)

    def variate_counts(insert: bool):
        """(insertion evaluations, variates per evaluation, motion
        variates) that a fixed-trip step draws per lane."""
        return (limit + 1 if insert and draws_ins else 0, n_cand,
                A if draws_mot else 0)

    def prologue(scenario, inputs):
        """The rollout's start from lane-stacked `scenario` and `inputs`:
        (carry, ctx), ctx holding what every step reads (map keys, tables,
        the ego index, the initial slots, the insertion's invariant state
        and the kernels' packs)."""
        B = inputs.slot_mask.shape[0]
        lane = arange_on(B, device)
        av = inputs.av_index.long()                      # [B]
        x_pt = model.encode_map(scenario.map, map_traj)  # [B, P, D]
        pt = dict(pos=scenario.map.position, orient=scenario.map.orientation,
                  mask=scenario.map.mask, x=x_pt)
        tables = dec.rollout_tables(agent_vocab)

        # rollout-invariant insertion state: the seed feature vector and the
        # map-token K/V projections of every pt2sa layer
        if cfg.disable_insertion:
            seed = None
        else:
            ptkv0 = [SF.precompute_src_kv(dec.pt2sa_attn_layers[i], x_pt,
                                          sf_dt) for i in range(L_s)]
            seed = dict(vec=_seed_vector(tables), ptkv0=ptkv0)
            if use_sknf:
                seed["pack"] = SKN.pack_seed_params_full(dec, L_s, G, sf_dt)
                seed["k0"] = torch.stack([kv[0] for kv in ptkv0], 1)
                seed["v0"] = torch.stack([kv[1] for kv in ptkv0], 1)
            elif use_skn:
                seed["pack"] = SKN.pack_seed_params(dec, L_s, G, sf_dt)
            if use_refk:
                seed["refine_pack"] = RFK.pack_refine_params(
                    dec, L_s, attr.angle_size, sf_dt)
        # the trunk's kernel parameters: the column kernel's pack, or the
        # fused blocks' 3L packs
        trunk_pack = None
        if cfg.use_column_kernel:
            trunk_pack = CK.pack_column_params(dec, L, sf_dt)
        elif use_fused:
            trunk_pack = FB.pack_column_blocks(dec, L)

        tok = inputs.tokens
        T0 = tok.token_idx.shape[2]

        # --- slot filtering ---
        slot_active = inputs.slot_mask & (tok.state_idx[..., H - 1]
                                          != INVALID_STATE)
        eval_mask = slot_active & scenario.agents.valid[
            ..., cfg.num_historical_steps - 1]

        def pad_t(x, fill):
            if T0 >= Ti:
                return x[:, :, :Ti].clone()
            return torch.cat([x, torch.full((B, A, Ti - T0, *x.shape[3:]),
                                            fill, dtype=x.dtype,
                                            device=device)], 2)
        pos = pad_t(tok.token_pos, 0.0)
        head = pad_t(tok.token_heading, 0.0)
        state = pad_t(tok.state_idx, INVALID_STATE)
        token = pad_t(tok.token_idx, -1)
        grid = pad_t(inputs.grid_token_idx, -1)
        valid = pad_t(tok.raw_token_valid, True)

        col = torch.arange(Ti, device=device)[None, None]
        fut = col >= H
        pos = torch.where(fut[..., None], 0.0, pos)
        head = torch.where(fut, 0.0, head)
        state = torch.where(fut, INVALID_STATE, state)
        token = torch.where(fut, -1, token)
        grid = torch.where(fut, -1, grid)
        valid = torch.where(fut, True, valid) & eval_mask[..., None]

        # deactivated slots are fully inert
        act = slot_active[..., None]
        state = torch.where(act, state, INVALID_STATE)
        token = torch.where(act, token, -1)
        grid = torch.where(act, grid, -1)
        pos = torch.where(act[..., None], pos, 0.0)

        # --- masks ---
        is_bos = state == ENTER_STATE
        is_eos = state == EXIT_STATE
        bos = torch.where(is_bos.any(-1), _argmax_first(is_bos, -1), 0)
        eos = torch.where(is_eos.any(-1), _argmax_first(is_eos, -1), Ti - 1)
        motion_win = (col > bos[..., None]) & (col <= eos[..., None]) \
            & (col < H)
        temporal = torch.where(motion_win, valid, True) | fut
        non_motion = (~motion_win) & (col < H)
        interact = ~non_motion
        interact = torch.where(state == ENTER_STATE, True, interact)
        interact[lane, av] = True
        interact = (interact | fut) & act
        temporal = temporal & act

        type_ = inputs.agent_type.to(i32)
        shape = inputs.agent_shape.to(f32)

        # --- embeddings for all rows ---
        type_t = torch.where(state == INVALID_STATE, SEED_TYPE,
                             type_[..., None])
        shape_t = torch.where((state == INVALID_STATE)[..., None],
                              INVALID_SHAPE_VALUE, shape[..., None, :])
        t_idx = map_token_index(token, cfg.token_size).long()
        token_emb = tables["token_tables"][
            torch.clamp(type_, 0, 2).long()[..., None], t_idx]
        motion, hv = E.build_motion_vectors(pos, head, state)
        raw_feat = _fuse(tables, token_emb, motion, hv, type_t, shape_t,
                         state, grid)

        carry = RolloutCarry(
            pos=pos, head=head, state=state.to(i32), token=token.to(i32),
            grid=grid.to(i32), valid=valid, interact=interact,
            temporal=temporal, slot_active=slot_active, type_=type_,
            shape=shape, raw_feat=raw_feat,
            cache=torch.zeros((L, B, A, Ti, D), dtype=raw_feat.dtype,
                              device=device),
            pred_traj=torch.zeros((B, A, R, 2), device=device),
            pred_head=torch.zeros((B, A, R), device=device),
            pred_state=torch.zeros((B, A, R), device=device),
            n_inserted=torch.zeros(B, dtype=i32, device=device))

        # --- prefill cache column 0: the reference never queries column 0,
        # so its cached value per layer is the zero-aggregate transform of
        # the raw fused feature, not an attended motion pass
        carry.cache[:, :, :, 0] = dec.prefill_column(carry.raw_feat[:, :, 0])
        ctx = dict(pt=pt, tables=tables, av=av, init_active=slot_active,
                   seed=seed, trunk=trunk_pack)
        return carry, ctx

    def _flat_ctx(ctx):
        """ctx with every kernel pack as a dict of its buffers: a tree of
        tensors, which a traced program takes and returns (the views are
        rebuilt from the buffers by _unflat_ctx)."""
        bufs = lambda pack, *names: {n: getattr(pack, n) for n in names
                                     if getattr(pack, n) is not None}
        seed, trunk = ctx["seed"], ctx["trunk"]
        if seed is not None:
            seed = dict(seed)
            if use_sknf:
                seed["pack"] = dict(
                    base_weights=seed["pack"].base.weights,
                    base_vectors=seed["pack"].base.vectors,
                    **bufs(seed["pack"], "weights", "vectors", "tiles"))
            elif use_skn:
                seed["pack"] = bufs(seed["pack"], "weights", "vectors")
            if use_refk:
                seed["refine_pack"] = bufs(seed["refine_pack"], "weights",
                                           "vectors", "tiles")
        if cfg.use_column_kernel:
            trunk = bufs(trunk, "weights", "vectors", "tiles")
        elif use_fused:
            trunk = [dict(bufs(p, "weights", "vectors"), **p.heads)
                     for p in trunk]
        return dict(ctx, seed=seed, trunk=trunk)

    def _unflat_ctx(flat):
        """_flat_ctx's inverse."""
        seed, trunk = flat["seed"], flat["trunk"]
        if seed is not None:
            seed = dict(seed)
            pk = seed.get("pack")
            if use_sknf:
                base = SKN.SeedPack.of(pk["base_weights"], pk["base_vectors"],
                                       L_s, D, G)
                seed["pack"] = SKN.SeedFullPack.of(
                    base, pk["weights"], pk["vectors"], pk.get("tiles"))
            elif use_skn:
                seed["pack"] = SKN.SeedPack.of(pk["weights"], pk["vectors"],
                                               L_s, D, G)
            if use_refk:
                rp = seed["refine_pack"]
                seed["refine_pack"] = RFK.RefinePack.of(
                    rp["weights"], rp["vectors"], rp.get("tiles"), L_s, D,
                    attr.angle_size)
        if cfg.use_column_kernel:
            trunk = CK.ColumnPack.of(trunk["weights"], trunk["vectors"],
                                     trunk.get("tiles"), L, D)
        elif use_fused:
            trunk = [FB.FusedPack.of(p["weights"], p["vectors"],
                                     dict(wkh=p["wkh"], wkrh=p["wkrh"]), D,
                                     cfg.num_heads) for p in trunk]
        return dict(flat, seed=seed, trunk=trunk)

    def epilogue(carry, outs, scenario, inputs, ctx):
        """The rollout's outputs from the last carry and the steps' outputs
        `outs` (each [B, n_steps, ...])."""
        return _finalize(carry, outs, scenario, inputs, ctx["init_active"])

    def _fuse(tables, token_emb, motion, head_vec, type_t, shape_t, state,
              grid_idx):
        grid_emb = tables["grid_table"][
            torch.where(grid_idx >= 0, grid_idx, G).long()]
        return dec.fuse_features(token_emb, motion, head_vec, type_t,
                                 shape_t, state, grid_emb)

    # ---------------------------------------------------------------- #
    # motion pass for one column
    # ---------------------------------------------------------------- #

    def _motion_pass(carry, c, pt, trunk_pack):
        B = carry.pos.shape[0]
        pos_c, head_c = _at(carry.pos, c), _at(carry.head, c)
        state_c, inter_c = _at(carry.state, c), _at(carry.interact, c)
        hv_c = hv_of(head_c)

        # temporal keys: sliding window of W columns ending at c-1, a
        # gather of W columns from start = clamp(c - W, 0, Ti - W)
        k_cols = _span_cols(torch.clamp(c - W, 0, Ti - W), W, device)
        sl = lambda x: x.index_select(2, k_cols)
        key_pos, key_head = sl(carry.pos), sl(carry.head)
        key_state, key_hist = sl(carry.state), sl(carry.temporal)

        is_bos = carry.state == ENTER_STATE
        bos = torch.where(is_bos.any(-1), _argmax_first(is_bos, -1), 0)
        k_valid = ((k_cols < c) & key_hist
                   & (k_cols >= bos[..., None])
                   & carry.slot_active[..., None])
        if cfg.ref_rollout_quirks:
            # reference quirk: the last num_seed_feature active rows get no
            # temporal attention at inference (its temporal masks are sliced
            # by the TRAINING seed-row count). Active slots are a prefix
            # (slots fill in order), so those are the highest-indexed ones.
            n_act = carry.slot_active.sum(-1, keepdim=True)
            quirk = torch.arange(A, device=device) >= n_act \
                - cfg.num_seed_feature
            k_valid = k_valid & ~quirk[..., None]

        rel_pos = key_pos - pos_c[:, :, None]
        rel_head = wrap_angle(key_head - head_c[..., None])
        inv_k = key_state == INVALID_STATE
        inv_q = (state_c == INVALID_STATE)[..., None]
        rel_pos, rel_head = E._apply_invalid_sentinels(rel_pos, rel_head,
                                                       inv_k, inv_q)
        t_r_raw = torch.stack([
            torch.linalg.norm(rel_pos, dim=-1),
            angle_between_2d_vectors(hv_c[:, :, None], rel_pos),
            rel_head,
            (k_cols - c).to(f32) * torch.ones((B, A, 1), device=device),
        ], dim=-1)
        key_stack = torch.cat([sl(carry.raw_feat)[None],
                               carry.cache[:-1].index_select(3, k_cols)], 0)

        # a2a at column c
        km = inter_c & carry.slot_active
        d2 = ((pos_c[:, :, None] - pos_c[:, None]) ** 2).sum(-1)
        eye = torch.eye(A, dtype=torch.bool, device=device)
        a2a_mask = ((d2 <= cfg.a2a_radius ** 2) & ~eye & km[:, None, :]
                    & km[:, :, None])
        rel_pos_aa = pos_c[:, None] - pos_c[:, :, None]
        rel_head_aa = wrap_angle(head_c[:, None] - head_c[:, :, None])
        inv_c = state_c == INVALID_STATE
        rel_pos_aa, rel_head_aa = E._apply_invalid_sentinels(
            rel_pos_aa, rel_head_aa, inv_c[:, None, :], inv_c[:, :, None])
        a2a_r_raw = stack3(torch.linalg.norm(rel_pos_aa, dim=-1),
                           angle_between_2d_vectors(hv_c[:, :, None],
                                                    rel_pos_aa),
                           rel_head_aa)

        # pl2a at column c
        idx5, val5 = topk_neighbors(pos_c, pt["pos"], cfg.pl2a_num_neighbors,
                                    cfg.pl2a_radius, key_mask=pt["mask"])
        val5 = val5 & km[..., None]
        rel_pl = _rows(pt["pos"], idx5) - pos_c[:, :, None]
        rel_or = wrap_angle(_rows(pt["orient"], idx5) - head_c[..., None])
        rel_pl = torch.where(inv_c[..., None, None], E.MOTION_GAP, rel_pl)
        rel_or = torch.where(inv_c[..., None], E.HEADING_GAP, rel_or)
        pl_r_raw = stack3(torch.linalg.norm(rel_pl, dim=-1),
                          angle_between_2d_vectors(hv_c[:, :, None], rel_pl),
                          rel_or)
        pl_keys = _rows(pt["x"], idx5)

        n_rows = None
        if cfg.use_column_kernel:
            # occupancy bound: 1 + the highest active slot (slots fill
            # lowest-free first), 0 with none; rows past it are inactive
            # with every key masked. A device scalar per lane: no host read.
            act = carry.slot_active
            n_rows = torch.where(act.any(-1), A - _argmax_first(act.flip(-1)),
                                 0).to(i32)
        new_cols, out = dec.motion_column(
            _at(carry.raw_feat, c), key_stack, t_r_raw, k_valid, a2a_r_raw,
            a2a_mask, pl_keys, pl_r_raw, val5, n_rows=n_rows,
            column_pack=None if use_fused else trunk_pack,
            fused_packs=trunk_pack if use_fused else None)
        _set_at(carry.cache, c, new_cols, 3)
        return carry, out

    # ---------------------------------------------------------------- #
    # insertion loop for one step
    # ---------------------------------------------------------------- #

    # The insertion of one step, in three parts: insertion_open (the
    # step's invariants `ins` and the first seed evaluation), one loop
    # iteration (iter_body: insert the current proposal, evaluate the
    # next), and insertion_close (the accepted inserts into the carry). The
    # loop carries only column-c slices plus a bounded record buffer
    # (`recs`, <= insert_limit rows); accepted insertions are written into
    # the full carry once per step by `_apply_inserts`. A loop state is
    # (slim, prop, n_new, probs, p, fast, recs).

    def insertion_open(carry, ctx, c, u0=None):
        """(loop, ins) at the current column c: the step's invariants and
        the loop state after the first seed evaluation, whose grid draw
        takes the variates u0 [B, n_cand] (None at beam 1)."""
        pt, tables, av, seed = ctx["pt"], ctx["tables"], ctx["av"], \
            ctx["seed"]
        B = carry.pos.shape[0]
        pos_c0, head_c0 = _at(carry.pos, c), _at(carry.head, c)
        grid_c0, inter_c0 = _at(carry.grid, c), _at(carry.interact, c)
        rawf_c0 = _at(carry.raw_feat, c)
        ego_pos = _rows(pos_c0, av)                       # [B, 2]
        ego_head = _rows(head_c0, av)                     # [B]
        ego_hv = hv_of(ego_head)

        # map keys within pl2seed radius of ego (shared by all iterations)
        rel_pl = pt["pos"] - ego_pos[:, None]
        d_pl = torch.linalg.norm(rel_pl, dim=-1)
        pl_mask = (d_pl <= cfg.pl2seed_radius) & pt["mask"]
        pl_r_raw = stack3(d_pl,
                          angle_between_2d_vectors(ego_hv[:, None], rel_pl),
                          wrap_angle(pt["orient"] - ego_head[:, None]))

        # per-step precompute for the decomposed seed evaluation: the map
        # K/V ride in from the rollout scope, geometry contributions and
        # agent-row projections are computed once per step, and single rows
        # are patched per insert
        r_pl_emb = dec.embed_pl2sa_r(pl_r_raw)
        ins = dict(ego_pos=ego_pos, ego_head=ego_head, ego_hv=ego_hv,
                   pl_mask=pl_mask, r_pl_emb=r_pl_emb)
        if not use_sknf:
            K_pt, V_pt = [], []
            for i in range(L_s):
                kr, vr = SF.r_contrib(dec.pt2sa_attn_layers[i], r_pl_emb,
                                      sf_dt)
                K_pt.append(seed["ptkv0"][i][0] + kr)
                V_pt.append(seed["ptkv0"][i][1] + vr)
            if use_skn:
                ins.update(K_pt_s=torch.stack(K_pt, 1),
                           V_pt_s=torch.stack(V_pt, 1))
            else:
                ins.update(K_pt=K_pt, V_pt=V_pt)

        # per-step refine map-candidate subset: every insert lands within
        # pl2seed_radius of ego and its refine keys within pl2sa_radius of
        # the insert. Candidates are re-sorted to ORIGINAL index order so
        # the per-insert top-k breaks ties as the full-P computation does.
        P_ = pt["pos"].shape[1]
        NC = min(cfg.refine_map_candidates or P_, P_)
        if NC < P_:
            cand_idx, cand_ok = topk_neighbors(
                ego_pos[:, None], pt["pos"], NC,
                cfg.pl2seed_radius + cfg.pl2sa_radius, key_mask=pt["mask"])
            cand_idx, cand_ok = cand_idx[:, 0], cand_ok[:, 0]
            order = torch.argsort(torch.where(cand_ok, cand_idx, P_), dim=-1,
                                  stable=True)
            cand_idx = torch.gather(cand_idx, 1, order)
            cand_ok = torch.gather(cand_ok, 1, order)
            ins["cand"] = dict(pos=_rows(pt["pos"], cand_idx),
                               orient=_rows(pt["orient"], cand_idx),
                               x=_rows(pt["x"], cand_idx), ok=cand_ok)
        else:
            ins["cand"] = dict(pos=pt["pos"], orient=pt["orient"],
                               x=pt["x"], ok=pt["mask"])

        # agent-row key snapshots (zero-aggregate chains, independent of
        # the seed query), once per step; only the inserted row changes.
        # The full kernel computes the chains itself from the raw column.
        # The occupancy scatter adds within each lane's row of cells.
        occ_hit = (grid_c0 >= 0) & carry.slot_active
        occ_vec0 = torch.zeros((B, G), device=device).scatter_add_(
            1, torch.where(grid_c0 >= 0, grid_c0, 0).long(),
            occ_hit.to(f32)) > 0
        km0 = inter_c0 & carry.slot_active
        rel_a0 = pos_c0 - ego_pos[:, None]
        d_a0 = torch.linalg.norm(rel_a0, dim=-1)
        r_sa_emb0 = dec.embed_a2sa_r(stack3(
            d_a0, angle_between_2d_vectors(ego_hv[:, None], rel_a0),
            wrap_angle(head_c0 - ego_head[:, None])))
        fast0 = dict(a2sa_mask=km0 & (d_a0 <= cfg.pl2seed_radius),
                     occ_vec=occ_vec0)
        if use_sknf:
            fast0.update(agent_col=rawf_c0.contiguous(), r_sa=r_sa_emb0)
        else:
            ag_keys0 = dec.seed_key_chain(rawf_c0)
            K_a0, V_a0 = [], []
            for i in range(L_s):
                layer = dec.a2sa_attn_layers[i]
                ka, va = SF.precompute_src_kv(layer, ag_keys0[i], sf_dt)
                kar, var_ = SF.r_contrib(layer, r_sa_emb0, sf_dt)
                K_a0.append(ka + kar)
                V_a0.append(va + var_)
            fast0.update(K_a=torch.stack(K_a0, 1), V_a=torch.stack(V_a0, 1))
            if cfg.use_grid_token:
                fast0["v_occ"] = _occ_values(occ_vec0)

        # The loop exits as soon as the seed head says stop, the budget runs
        # out, or a proposal's retries exhausted the budget while occupied.
        # Every multinomial draw consumes one of the insert_limit units, as
        # every seed-stack evaluation (rejection retries included) does in
        # the reference.
        K_rec = max(limit, 1)
        zeros = lambda *s, dtype=f32: torch.zeros((B, *s), dtype=dtype,
                                                  device=device)
        recs0 = dict(ok=zeros(K_rec, dtype=torch.bool),
                     slot=zeros(K_rec, dtype=i32), pos_pre=zeros(K_rec, 2),
                     pos=zeros(K_rec, 2), head=zeros(K_rec),
                     g=zeros(K_rec, dtype=i32), type=zeros(K_rec, dtype=i32),
                     shape=zeros(K_rec, 3),
                     feat=zeros(K_rec, D, dtype=carry.raw_feat.dtype))
        slim0 = dict(active=carry.slot_active, pos_c=pos_c0, head_c=head_c0,
                     inter_c=inter_c0, rawf_c=rawf_c0)
        prop0 = eval_seed(ins, ctx, slim0, fast0, zeros(dtype=i32), u0)
        loop = (slim0, prop0, zeros(dtype=i32), zeros(limit + 1),
                prop0["n_draws"], fast0, recs0)
        return loop, ins


    def eval_seed(ins, ctx, slim, fast, p_used, u, run=None):
        """One seed-head evaluation per lane: the seed stack + heads +
        grid-cell sampling. Occupied-cell rejections are retried HERE
        with fresh draws instead of re-running the seed stack: a retry
        evaluates identical inputs, so one retry is one fresh draw from
        the same top-k, and each draw consumes one unit of the shared
        insert_limit budget. All potential retries are drawn at once;
        "first free candidate among insert_limit draws, budget
        permitting" has the same joint distribution of (accepted cell,
        draws consumed). p_used: budget already consumed; the proposal
        reports n_draws >= 1. u: the grid draw's variates [B, n_cand]
        (None at beam 1). run: the lanes still running, a device mask
        (the seed kernel skips the others); None: every lane."""
        seed, B = ctx["seed"], slim["active"].shape[0]
        r_pl_emb, pl_mask = ins["r_pl_emb"], ins["pl_mask"]
        occ_vec = fast["occ_vec"]
        if use_sknf:
            # precompute + stack + heads of every lane from raw inputs,
            # one call
            small, posl = SKN.seed_eval_full_kernel(
                seed["pack"], seed["vec"].to(f32), seed["k0"],
                seed["v0"], r_pl_emb, pl_mask, fast["agent_col"],
                fast["r_sa"], fast["a2sa_mask"], occ_vec, cfg.num_heads,
                cfg.head_dim, lanes=run)
        elif use_skn:
            # the whole stack + heads of every lane in one CUDA kernel
            small, posl = SKN.seed_eval_kernel(
                seed["pack"], seed["vec"].to(f32), fast["v_occ"],
                ins["K_pt_s"], ins["V_pt_s"], pl_mask, fast["K_a"],
                fast["V_a"], fast["a2sa_mask"], cfg.num_heads, cfg.head_dim,
                lanes=run)
        if use_sknf or use_skn:
            heads = dict(state_logits=small[:, 0, :2],
                         type_logits=small[:, 1, :3],
                         shape=small[:, 2, :3], pos_logits=posl[:, :G])
        else:
            sd = seed["vec"].expand(B, D)
            for i in range(L_s):
                if cfg.use_grid_token:
                    sd = SF.attn_1q_single_key(
                        dec.occ2sa_attn_layers[i], sd,
                        fast["v_occ"][:, i], sf_dt)
                sd = SF.attn_1q(dec.pt2sa_attn_layers[i], sd,
                                ins["K_pt"][i], ins["V_pt"][i], pl_mask,
                                cfg.num_heads, sf_dt)
                sd = SF.attn_1q(dec.a2sa_attn_layers[i], sd,
                                fast["K_a"][:, i], fast["V_a"][:, i],
                                fast["a2sa_mask"], cfg.num_heads, sf_dt,
                                bipartite=False)
            heads = dec.seed_heads(sd)

        heads = {k: v.to(f32) for k, v in heads.items()}
        enter_prob = torch.softmax(heads["state_logits"], -1)[:, 1]
        if force_insert:
            want_enter = torch.ones(B, dtype=torch.bool, device=device)
        else:
            want_enter = _argmax_first(heads["state_logits"]) == 1
        type_idx = _argmax_first(heads["type_logits"]).to(i32)
        shape_pred = heads["shape"]
        note_pick("seed_type", heads["type_logits"])
        if cfg.use_grid_token:
            note_pick("seed_grid", heads["pos_logits"])

        if cfg.use_grid_token:
            pos_probs = torch.softmax(heads["pos_logits"], -1)
            topk_p, topk_idx = topk_stable(pos_probs,
                                           cfg.insert_beam_size)
            if cfg.insert_beam_size == 1:
                choices = torch.zeros((B, n_cand), dtype=torch.long,
                                      device=device)
            else:
                # each lane's n_cand variates (drawn from its own
                # generator only while it runs, as its single rollout
                # draws) by inverse CDF over its top-k
                choices = topk_inverse_cdf(topk_p, u)
            g_cands = torch.gather(topk_idx, 1, choices)    # [B, limit]
            remaining = limit - p_used
            in_budget = arange_on(n_cand, device)[None] \
                < remaining[:, None]
            free_ok = ~torch.gather(occ_vec, 1, g_cands) & in_budget
            any_free = free_ok.any(-1)
            first = _argmax_first(free_ok)
            g_idx = _rows(g_cands, first).to(i32)
            occupied = ~any_free
            n_draws = torch.where(any_free, first + 1,
                                  torch.clamp(remaining, min=1)).to(i32)
            next_pos = _decode_pos(g_idx, ins["ego_pos"],
                                   ins["ego_head"])
        else:
            g_idx = torch.full((B,), -1, dtype=i32, device=device)
            next_pos = heads["pos_xy"] * cfg.pl2seed_radius \
                + ins["ego_pos"]
            occupied = torch.zeros(B, dtype=torch.bool, device=device)
            n_draws = torch.ones(B, dtype=i32, device=device)
        # stop when the head declines or no free slot remains
        stop = ~want_enter | slim["active"].all(-1)
        return dict(enter_prob=enter_prob, type_idx=type_idx,
                    shape=shape_pred, g_idx=g_idx, next_pos=next_pos,
                    occupied=occupied, n_draws=n_draws, stop=stop)

    def iter_body(ins, ctx, loop, u, run=None):
        """Insert the current (free-cell) proposal, then evaluate the
        next one (its grid draw's variates u). A step whose first
        evaluation declines pays one seed evaluation and no
        insert/refine pass. run: eval_seed's."""
        slim, prop, n_new, probs, p, fast, recs = loop
        ego_pos, ego_head = ins["ego_pos"], ins["ego_head"]
        slot = _argmax_first(~slim["active"])
        do_insert = ~prop["occupied"] & ~prop["stop"]

        slim, recs, new_feat, ins_pos, ins_head = _do_insert(
            slim, recs, n_new, slot, do_insert, prop["next_pos"],
            prop["g_idx"], prop["type_idx"], prop["shape"], ego_pos,
            ego_head, ins["cand"], ctx["tables"], ctx["seed"], run)

        # ---- patch the inserted row into the fast-eval state ----
        rel = ins_pos - ego_pos
        d_row = torch.linalg.norm(rel, dim=-1)
        r_row_emb = dec.embed_a2sa_r(torch.stack([
            d_row, angle_between_2d_vectors(ins["ego_hv"], rel),
            wrap_angle(ins_head - ego_head)], -1)[:, None])
        fast = dict(fast)
        if use_sknf:
            # the full kernel recomputes chains and K/V from the raw
            # inputs: only the raw row and its geometry embedding change
            fast["agent_col"] = _put(fast["agent_col"], slot, new_feat,
                                     do_insert)
            fast["r_sa"] = _put(fast["r_sa"], slot, r_row_emb[:, 0],
                                do_insert)
        else:
            row_chain = dec.seed_key_chain(new_feat[:, None, :])
            K_rows, V_rows = [], []
            for i in range(L_s):
                layer = dec.a2sa_attn_layers[i]
                ka, va = SF.precompute_src_kv(layer, row_chain[i], sf_dt)
                kar, var_ = SF.r_contrib(layer, r_row_emb, sf_dt)
                K_rows.append((ka + kar)[:, 0])
                V_rows.append((va + var_)[:, 0])
            fast["K_a"] = _put(fast["K_a"], slot,
                               torch.stack(K_rows, 1), do_insert, dim=2)
            fast["V_a"] = _put(fast["V_a"], slot,
                               torch.stack(V_rows, 1), do_insert, dim=2)
        fast["a2sa_mask"] = _put(fast["a2sa_mask"], slot,
                                 d_row <= cfg.pl2seed_radius, do_insert)
        if cfg.use_grid_token:
            fast["occ_vec"] = _put(fast["occ_vec"], prop["g_idx"], True,
                                   do_insert)
            if not use_sknf:
                fast["v_occ"] = _occ_values(fast["occ_vec"])

        # the reference records the enter prob at index num_new_agents
        # after a successful insert
        probs = _put(probs, n_new + 1, prop["enter_prob"], do_insert)
        n_new = n_new + do_insert.to(i32)
        prop = eval_seed(ins, ctx, slim, fast, p, u, run)
        return slim, prop, n_new, probs, p + prop["n_draws"], fast, recs

    def running(loop):
        """The lanes whose insertion loop goes on: budget left, the seed
        head's proposal accepted and its cell free."""
        return ((loop[4] <= limit) & ~loop[1]["stop"]
                & ~loop[1]["occupied"])

    def insertion_iter(ins, ctx, loop, u=None):
        """One iteration of the fixed-trip loop: iter_body, a stopped lane
        frozen by a full-state select; no host read. u: the variates of the
        evaluation it makes [B, n_cand] (None at beam 1)."""
        return _tree_where(running(loop), iter_body(ins, ctx, loop, u), loop)

    def insertion_close(carry, ins, loop, c):
        """The loop's accepted inserts written into the carry at column c:
        (carry, n_new [B], enter probabilities [B, insert_limit + 1])."""
        slim, _, n_new, probs, _, _, recs = loop
        carry = _apply_inserts(carry, slim, recs, n_new, c, ins["ego_head"])
        return carry, n_new, probs

    def _insertion(carry, ctx, c, u_ins, gens):
        """The whole insertion of one step (the module docstring's two
        loops): with `gens`, the early-exit loop, each running lane drawing
        its variates as it goes; otherwise the fixed-trip loop on u_ins
        [B, insert_limit + 1, n_cand] (None at beam 1)."""
        if gens is None:
            u = (lambda j: None) if u_ins is None else (lambda j: u_ins[:, j])
            loop, ins = insertion_open(carry, ctx, c, u(0))
            for j in range(1, limit + 1):
                loop = insertion_iter(ins, ctx, loop, u(j))
            return insertion_close(carry, ins, loop, c)
        draw = lambda live: draw_uniforms(gens, (n_cand,), device, live) \
            if draws_ins else None
        loop, ins = insertion_open(carry, ctx, c, draw(None))
        # while any lane runs: one host read of the lanes' flags per
        # iteration; the stopped lanes' new state is discarded, and only
        # the running lanes draw
        while True:
            rollout.host_reads += 1
            run = running(loop)
            live = run.tolist()
            if not any(live):
                break
            if all(live):
                loop = iter_body(ins, ctx, loop, draw(None))
            else:
                loop = _tree_where(run, iter_body(ins, ctx, loop, draw(live),
                                                  run), loop)
        return insertion_close(carry, ins, loop, c)

    def _occ_values(occ_vec):
        """[B, L_s, D] occ2sa values (the single key's value projection) of
        each lane's occupancy vector."""
        occ_emb = dec.embed_occ(occ_vec)
        return torch.stack([SF.occ_value(dec.occ2sa_attn_layers[i], occ_emb,
                                         sf_dt) for i in range(L_s)], 1)

    def _decode_pos(g_idx, ego_pos, ego_head):
        centered = grid_xy[g_idx.long()]
        return _vecmat(centered, rot_mat_2d(ego_head - math.pi / 2)) \
            + ego_pos

    def _decode_heading(idx):
        return (idx * cfg.angle_interval - 180.0) / 360.0 * (2 * math.pi)

    def _seed_vector(tables):
        return dec.fuse_features(
            tables["no_token"][None],
            torch.full((1, 2), E.INVALID_MOTION_VALUE, device=device),
            vec(1.0, 0.0)[None], vec(SEED_TYPE, dtype=i32),
            dec.invalid_shape(1, 3, device=device),
            vec(INVALID_STATE, dtype=i32),
            tables["grid_table"][G // 2][None])[0]

    def _insert_col_feat(tables, head_slot, g_idx, type_idx, shape_pred):
        """Fused feature [B, D] of each lane's inserted agent at its enter
        column only (pre-bos columns are masked by the temporal bos clamp,
        later ones refreshed by each motion step): motion = MOTION_GAP, bos
        token embedding, enter state."""
        B = head_slot.shape[0]
        return _fuse(tables, tables["bos_token"].expand(B, D),
                     torch.full((B, 2), E.MOTION_GAP, device=device),
                     hv_of(head_slot), type_idx, shape_pred,
                     torch.full((B,), ENTER_STATE, dtype=i32, device=device),
                     g_idx)

    def _do_insert(slim, recs, n_new, slot, do_insert, next_pos, g_idx,
                   type_idx, shape_pred, ego_pos, ego_head, cand, tables,
                   seed, run=None):
        """Refine + record one insertion per lane against the column-c loop
        state; every write is masked by `do_insert`. Full-carry row writes
        are deferred to `_apply_inserts` after the loop. run: the lanes
        still running (None: every lane); the refine kernel skips the
        lanes that do not insert."""
        B = slot.shape[0]
        onehot = torch.arange(A, device=device) == slot[:, None]   # [B, A]
        m1 = onehot & do_insert[:, None]

        # column-slice activation at the pre-refine pose
        active = slim["active"] | m1
        pos_c = torch.where(m1[..., None], next_pos[:, None], slim["pos_c"])
        head_c = torch.where(m1, ego_head[:, None], slim["head_c"])
        inter_c = slim["inter_c"] | m1

        # ---- heading/offset refine on the inserted agent's SUBGRAPH: only
        # its row is read downstream and rows outside its neighbour set
        # cannot influence it, so the pass runs on [1 + K] gathered rows
        col_feat = _insert_col_feat(tables, ego_head, g_idx, type_idx,
                                    shape_pred)
        slot_pos, slot_head = _rows(pos_c, slot), _rows(head_c, slot)
        slot_hv = hv_of(slot_head)
        key_ok = inter_c & active & ~onehot
        idx_a, val_a = topk_neighbors(slot_pos[:, None], pos_c,
                                      REFINE_A2SA_K, cfg.a2sa_radius,
                                      key_mask=key_ok)
        idx_a, val_a = idx_a[:, 0], val_a[:, 0]
        rel = _rows(pos_c, idx_a) - slot_pos[:, None]
        r_aa = stack3(torch.linalg.norm(rel, dim=-1),
                      angle_between_2d_vectors(slot_hv[:, None], rel),
                      wrap_angle(_rows(head_c, idx_a) - slot_head[:, None]))
        idx_p, val_p = topk_neighbors(slot_pos[:, None], cand["pos"],
                                      REFINE_PL2SA_K, cfg.pl2sa_radius,
                                      key_mask=cand["ok"])
        idx_p, val_p = idx_p[:, 0], val_p[:, 0]
        rel_p = _rows(cand["pos"], idx_p) - slot_pos[:, None]
        r_pp = stack3(torch.linalg.norm(rel_p, dim=-1),
                      angle_between_2d_vectors(slot_hv[:, None], rel_p),
                      wrap_angle(_rows(cand["orient"], idx_p)
                                 - slot_head[:, None]))

        x_sub = torch.cat([col_feat[:, None], _rows(slim["rawf_c"], idx_a)],
                          1)
        pl_x = _rows(cand["x"], idx_p)
        if use_refk:
            # the whole refine pass of every inserting lane in one kernel
            # launch on a padded 32-row neighbourhood per lane: row 0 the
            # insert, rows 1..24 its agent keys (their relations there,
            # zero rows past them, all masked but the real ones); map key k
            # and its relation in row k. Built on the device: no host read
            R_, Ka = REFINE_PL2SA_K, idx_a.shape[1]
            rdt = seed["refine_pack"].dtype
            x_pad = torch.zeros((B, R_, D), device=device)
            x_pad[:, :1 + Ka] = x_sub
            raa_pad = torch.zeros((B, R_, D), dtype=rdt, device=device)
            raa_pad[:, 1:1 + Ka] = dec.embed_a2a_r(r_aa)
            ma_pad = torch.zeros((B, R_), dtype=torch.bool, device=device)
            ma_pad[:, 1:1 + Ka] = val_a
            head_logits, off = RFK.refine_kernel(
                seed["refine_pack"], x_pad, pl_x.contiguous(),
                dec.embed_pl2a_r(r_pp).contiguous(), val_p.contiguous(),
                raa_pad, ma_pad, cfg.num_heads, cfg.head_dim,
                lanes=do_insert if run is None else do_insert & run)
            heads = dict(head_logits=head_logits,
                         offset_xy=torch.tanh(off) * 2.0)
        else:
            # lane by lane in its products (on the CPU): each lane's insert
            # refines as its single rollout's does
            with lane_products():
                refined = dec.refine_column_sub(x_sub, pl_x, r_pp, val_p,
                                                r_aa, val_a)
                heads = {k: v.to(f32)
                         for k, v in dec.refine_heads(refined).items()}
        if cfg.use_head_token:
            note_pick("refine_head", heads["head_logits"])
            h_idx = _argmax_first(heads["head_logits"]).to(i32)
            new_head = wrap_angle(_decode_heading(h_idx) + ego_head)
        else:
            new_head = heads["head_theta"] * math.pi + ego_head
        new_pos = next_pos + (heads["offset_xy"] if cfg.use_grid_token
                              else 0.0)

        # refined pose into the column state (the next iterations' refine
        # neighbours see it)
        pos_c = torch.where(m1[..., None], new_pos[:, None], pos_c)
        head_c = torch.where(m1, new_head[:, None], head_c)

        # final feature with the refined pose at the enter column only
        final_feat = _insert_col_feat(tables, new_head, g_idx, type_idx,
                                      shape_pred)
        new_row_c = torch.where(do_insert[:, None], final_feat,
                                _rows(slim["rawf_c"], slot))
        rawf_c = torch.where(onehot[..., None], new_row_c[:, None],
                             slim["rawf_c"])
        slim = dict(slim, active=active, pos_c=pos_c, head_c=head_c,
                    inter_c=inter_c, rawf_c=rawf_c)

        # record the accepted insertion for the post-loop write (record
        # index n_new: each accept bumps n_new, so indices never collide)
        rec = lambda a, v: _put(a, n_new, v, do_insert)
        recs = dict(ok=rec(recs["ok"], True), slot=rec(recs["slot"], slot),
                    pos_pre=rec(recs["pos_pre"], next_pos),
                    pos=rec(recs["pos"], new_pos),
                    head=rec(recs["head"], new_head),
                    g=rec(recs["g"], g_idx), type=rec(recs["type"], type_idx),
                    shape=rec(recs["shape"], shape_pred),
                    feat=rec(recs["feat"], final_feat))
        return slim, recs, new_row_c, new_pos, new_head

    def _apply_inserts(carry, slim, recs, n_new, c, ego_head):
        """Write each lane's <= insert_limit accepted insertions of one step
        into the full carry in one vectorised pass (in place), plus the
        prediction placeholders of the elapsed segment. Each accepted
        record owns a distinct free slot."""
        hits = recs["ok"][..., None] & (
            recs["slot"][..., None].long()
            == torch.arange(A, device=device))                # [B, K, A]
        hit = hits.any(1)                                     # [B, A]
        sel = _argmax_first(hits, 1)                          # [B, A]
        pick = lambda x: _rows(x, sel)
        h1, h2 = hit[..., None], hit[..., None, None]
        colr = torch.arange(Ti, device=device)[None, None]
        patch = lambda x, h, v: _set_at(x, c, torch.where(h, v, _at(x, c)))
        patch(carry.pos, h1, pick(recs["pos"]))
        patch(carry.head, hit, pick(recs["head"]))
        patch(carry.state, hit, ENTER_STATE)
        # -2 at the enter column = bos sentinel (token emb -> bos row); the
        # rest of the row is already -1 (inactive-slot init)
        patch(carry.token, hit, -2)
        patch(carry.grid, hit, pick(recs["g"]))
        patch(carry.raw_feat, h1, pick(recs["feat"]))
        carry = carry._replace(
            valid=torch.where(h1, colr > c, carry.valid),
            interact=torch.where(h1, colr >= c, carry.interact),
            temporal=carry.temporal | h1,
            slot_active=slim["active"],
            type_=torch.where(hit, pick(recs["type"]), carry.type_),
            shape=torch.where(h1, pick(recs["shape"]), carry.shape),
            n_inserted=carry.n_inserted + n_new)

        # pred placeholders for the elapsed segment (of step t - 1, t = c - 1
        # >= 1: step 0 inserts nothing): pre-refine pose, ego heading, ENTER
        # state
        cols = _span_cols(torch.clamp((c - 2) * SHIFT, 0, R - SHIFT), SHIFT,
                          device)
        for x, h, v in ((carry.pred_traj, h2,
                         pick(recs["pos_pre"])[:, :, None]),
                        (carry.pred_head, h1, ego_head[:, None, None]),
                        (carry.pred_state, h1, float(ENTER_STATE))):
            x.index_copy_(2, cols, torch.where(h, v, x.index_select(2, cols)))
        return carry

    # ---------------------------------------------------------------- #
    # one token step
    # ---------------------------------------------------------------- #

    def step(carry, ctx, c, insert: bool, u_ins=None, u_mot=None,
             gens=None):
        """One token step at the current column c = 1 + t (a 0-d int64
        tensor on the device), in place on `carry`; returns (carry, out).
        insert: whether the step runs the insertion loop (never at step 0,
        nor with cfg.disable_insertion). The variates: with `gens` (a
        generator per lane) each lane draws them as it goes, under the
        early-exit loop; otherwise u_ins [B, insert_limit + 1, n_cand] and
        u_mot [B, A] (ops/sampling.step_variates with variate_counts;
        None where nothing is drawn), under the fixed-trip loop. An
        exported step (rollout/export.py) is insertion_open, then
        insertion_iter insert_limit times, then close_step."""
        B = carry.pos.shape[0]
        picks.clear()
        # 1. insertion (skipped at t=0)
        if not insert:
            n_new = torch.zeros(B, dtype=i32, device=device)
            seed_probs = torch.zeros((B, limit + 1), device=device)
        else:
            with record_function("rollout.insertion"):
                carry, n_new, seed_probs = _insertion(carry, ctx, c, u_ins,
                                                      gens)
        return motion_step(carry, ctx, c, n_new, seed_probs, u_mot, gens)

    def close_step(carry, ctx, ins, loop, c, u_mot=None):
        """The step after its fixed-trip insertion loop: insertion_close,
        then motion_step."""
        carry, n_new, seed_probs = insertion_close(carry, ins, loop, c)
        return motion_step(carry, ctx, c, n_new, seed_probs, u_mot)

    def motion_step(carry, ctx, c, n_new, seed_probs, u_mot=None,
                    gens=None):
        """The step's motion, heads and de-tokenization at column c after
        its insertion (n_new inserts, the enter probabilities seed_probs):
        (carry, out)."""
        B = carry.pos.shape[0]
        lane = arange_on(B, device)
        pt, tables, av = ctx["pt"], ctx["tables"], ctx["av"]

        # 2. motion for all agents
        with record_function("rollout.motion"):
            carry, feat_c = _motion_pass(carry, c, pt, ctx["trunk"])
        token_logits, state_logits = dec.motion_heads(feat_c)
        token_logits, state_logits = token_logits.to(f32), state_logits.to(f32)
        probs = torch.softmax(token_logits, -1)
        if draws_mot and gens is not None:
            u_mot = draw_uniforms(gens, (A,), device)
        next_token = sample_from_topk(u_mot, probs, cfg.motion_beam_size)

        next_state = _argmax_first(state_logits, -1).to(i32)
        next_state = torch.where(next_state == 2, EXIT_STATE, next_state)
        next_state[lane, av] = VALID_STATE
        if not cfg.use_state_token:
            next_state = torch.where(next_state == EXIT_STATE, VALID_STATE,
                                     next_state)
        if cfg.disable_insertion:
            next_state = torch.full_like(next_state, VALID_STATE)
        next_state = torch.where(carry.slot_active, next_state,
                                 INVALID_STATE).to(i32)

        # 3. de-tokenize: contour trajectory in the world frame
        pos_c, head_c = _at(carry.pos, c), _at(carry.head, c)
        # direct (type, token) gather
        tokc = token_traj_all[torch.clamp(carry.type_, 0, 2).long(),
                              torch.clamp(next_token, min=0).long()]
        world = torch.einsum("basci,baij->bascj", tokc, rot_mat_2d(head_c)) \
            + pos_c[:, :, None, None, :]
        seg_traj = world[:, :, 1:].mean(dim=3)                  # [B, A, 5, 2]
        seg_head = heading_from_contour(world[:, :, 1:])        # [B, A, 5]

        is_invalid = next_state == INVALID_STATE
        new_pos = torch.where(is_invalid[..., None], 0.0,
                              world[:, :, -1].mean(dim=2))
        new_head = torch.where(is_invalid, 0.0,
                               heading_from_contour(world[:, :, -1]))

        # ego-relative grid for the new column
        g_new, _ = attr.encode_pos(new_pos, _rows(new_pos, av)[:, None],
                                   _rows(new_head, av)[:, None])
        g_new = torch.where(is_invalid | ~carry.slot_active, -1,
                            g_new).to(i32)
        tok_new = torch.where(is_invalid, -1, next_token).to(i32)

        c1 = c + 1
        prev_inv = _at(carry.state, c) == INVALID_STATE
        for x, v in ((carry.pos, new_pos), (carry.head, new_head),
                     (carry.state, next_state), (carry.token, tok_new),
                     (carry.grid, g_new),
                     (carry.valid, _at(carry.valid, c1) & ~is_invalid),
                     (carry.interact, _at(carry.interact, c1) & ~is_invalid)):
            _set_at(x, c1, v)

        # token / categorical embeddings at c+1
        t_idx = map_token_index(tok_new, cfg.token_size).long()
        tok_emb_new = tables["token_tables"][
            torch.clamp(carry.type_, 0, 2).long(), t_idx]

        # reference quirk 2 (Config.ref_rollout_quirks): initial agents
        # keep seed-type / invalid-shape categorical embeddings on every
        # rollout column; agents inserted during the rollout carry their
        # real type / shape
        as_seed = is_invalid | ctx["init_active"] if cfg.ref_rollout_quirks \
            else is_invalid
        te_new = dec.type_a_emb(torch.where(as_seed, SEED_TYPE, carry.type_))
        se_new = dec.shape_emb(torch.where(as_seed[..., None],
                                           INVALID_SHAPE_VALUE, carry.shape))

        # 4. refresh fused features at c+1 (incremental)
        motion_new = new_pos - pos_c
        inv_new = is_invalid
        motion_new = torch.where(inv_new[..., None], E.INVALID_MOTION_VALUE,
                                 motion_new)
        motion_new = torch.where((prev_inv & ~inv_new)[..., None],
                                 E.MOTION_GAP, motion_new)
        motion_new = torch.where((~prev_inv & inv_new)[..., None],
                                 -E.MOTION_GAP, motion_new)
        hv_new = hv_of(new_head)
        feat = torch.stack([torch.linalg.norm(motion_new, dim=-1),
                            angle_between_2d_vectors(hv_new, motion_new)], -1)
        parts = [tok_emb_new,
                 dec.x_a_emb(feat, categorical_embs=[te_new, se_new]),
                 dec.state_a_emb(next_state)]
        if cfg.use_grid_token:
            parts.append(tables["grid_table"][
                torch.where(g_new >= 0, g_new, G).long()])
        feat_new = dec.fusion_emb(torch.cat(parts, dim=-1))
        _set_at(carry.raw_feat, c1, feat_new)

        # 5. write 10 Hz predictions for this segment (step t = c - 1)
        seg = _span_cols((c - 1) * SHIFT, SHIFT, device)
        carry.pred_traj.index_copy_(2, seg, seg_traj)
        carry.pred_head.index_copy_(2, seg, seg_head)
        carry.pred_state.index_copy_(
            2, seg, next_state[..., None].to(f32).expand(-1, -1, SHIFT))

        out = dict(n_inserted=n_new, seed_probs=seed_probs)
        if debug:
            out.update(token_logits=token_logits, state_logits=state_logits,
                       layer_cols=_at(carry.cache, c, 3).transpose(0, 1))
            for head, width in pick_width.items():
                got = picks.get(head, [])[:width]
                pad = width - len(got)
                out[f"{head}_top2"] = torch.stack(
                    [i for i, _ in got] + [torch.full(
                        (B, 2), -1, dtype=torch.long, device=device)] * pad, 1)
                out[f"{head}_gap"] = torch.stack([g for _, g in got] + [
                    torch.full((B,), math.inf, device=device)] * pad, -1)
        return carry, out

    # ---------------------------------------------------------------- #
    # outputs
    # ---------------------------------------------------------------- #

    def _finalize(carry, outs, scenario, inputs, init_active):
        Hs = cfg.num_historical_steps
        B = carry.pos.shape[0]
        tok = inputs.tokens
        zeros = lambda *s: torch.zeros((B, A, *s), device=device)
        pred_traj = torch.cat([zeros(Hs, 2), carry.pred_traj], 2)
        pred_head = torch.cat([zeros(Hs), carry.pred_head], 2)
        pred_state = torch.cat([zeros(Hs), carry.pred_state], 2)

        # stitch history from tokens
        hist_tok = torch.clamp(tok.token_idx[:, :, :H], min=0).long()
        htraj = token_traj_all[torch.clamp(carry.type_, 0, 2).long()[
            ..., None], hist_tok]                       # [B, A, H, 6, 4, 2]
        rot = rot_mat_2d(tok.token_heading[:, :, 0])
        htraj = torch.einsum("bahsci,baij->bahscj", htraj, rot) \
            + tok.token_pos[:, :, 0][:, :, None, None, None, :]
        hist_xy = htraj[:, :, :, 1:].mean(dim=4).reshape(B, A, H * SHIFT, 2)
        hist_hd = heading_from_contour(htraj[:, :, :, 1:]).reshape(
            B, A, H * SHIFT)
        ia = init_active
        pred_traj[:, :, 1:Hs] = torch.where(ia[..., None, None], hist_xy, 0.0)
        pred_head[:, :, 1:Hs] = torch.where(ia[..., None], hist_hd, 0.0)
        pred_traj[:, :, 0] = torch.where(
            ia[..., None], scenario.agents.position[:, :, 0, :2], 0.0)
        pred_head[:, :, 0] = torch.where(ia, scenario.agents.heading[:, :, 0],
                                         0.0)
        hist_state = torch.repeat_interleave(tok.state_idx[:, :, :H], SHIFT,
                                             2)
        pred_state[:, :, 1:Hs] = torch.where(ia[..., None],
                                             hist_state.to(f32), 0.0)
        pred_valid = (pred_state != INVALID_STATE) & \
            (pred_state != ENTER_STATE)

        ty = carry.type_
        eval_shape = torch.stack([
            torch.where(ty == 0, 4.3, torch.where(ty == 1, 0.5, 1.9)),
            torch.where(ty == 0, 1.8, torch.where(ty == 1, 0.5, 0.5)),
            torch.ones_like(ty, dtype=f32)], dim=-1)

        return dict(
            av_index=inputs.av_index,
            slot_active=carry.slot_active,
            valid_mask=carry.valid,
            pos_a=carry.pos,
            head_a=carry.head,
            pred_traj=pred_traj,
            pred_head=pred_head,
            pred_state=pred_state,
            pred_valid=pred_valid,
            pred_type=carry.type_,
            pred_shape=carry.shape,
            eval_shape=eval_shape,
            # history columns keep the raw -2 bos sentinel; rollout columns
            # map it to -1 (the reference pads inserted rows with -1)
            next_token_idx=torch.where(
                (carry.token == -2)
                & (torch.arange(Ti, device=device)[None, None] >= H),
                -1, carry.token).to(i32),
            next_state_idx=carry.state.to(i32),
            grid_index=carry.grid,
            n_inserted=carry.n_inserted,
            per_step_inserted=outs["n_inserted"],
            seed_probs=outs["seed_probs"],
            **{f"debug_{k}": v for k, v in outs.items() if k not in (
                "n_inserted", "seed_probs")},
        )

    rollout.host_reads = 0
    rollout.prologue, rollout.step, rollout.epilogue = prologue, step, epilogue
    rollout.insertion_open, rollout.insertion_iter = insertion_open, \
        insertion_iter
    rollout.close_step = close_step
    rollout.n_steps = n_steps
    rollout.variate_counts = variate_counts
    rollout.flat_ctx, rollout.unflat_ctx = _flat_ctx, _unflat_ctx
    return rollout
