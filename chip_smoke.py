#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`infgen_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (a failure raises and exits non-zero
before the last line):

  device   the card's name and power limit (nvidia-smi), torch and CUDA
  build    seconds to compile every kernel under infgen_torch/ops/csrc,
           and the data pipeline's native helper (g++)
  kernels  each hand-written kernel (seed_eval, seed_eval_full, refine,
           motion_column, fused_attention_block, r_biased_attention)
           against its plain PyTorch version on the card at the flagship
           shapes, fp32 and bf16 (r_biased_attention: fp32, its only type),
           over its mask cases, with its time (seed_eval_full: its two
           stages' too), the plain version's time and its bound (the
           column, the fused block and the attention kernel: their least
           time, with the direct form's as `bound_ms_direct`); refine and
           the column are held stage by stage too; `seed_eval_widths`,
           `refine_widths`, `fused_block_widths` and `rba_widths` hold those
           kernels at their narrowest widths and check a width each
           refuses
           `seed_eval_lanes` holds the lane form (B = 8 lanes, two masked
           off, in one launch) against its plain version and against the
           single launch, with its time, per-lane time and bound; after
           `serving`, again at the shapes its batches gave the kernel;
           `seed_eval_full_lanes`, `refine_lanes` and `fused_block_lanes`
           do the same for those three kernels' lane forms (the fused
           block has no lane mask: every lane on), again after
           `serving_kernels` at the shapes its batches gave them;
           `column_lanes` the same for motion_column's lane form (8 lanes
           at the latency preset's A = 128, two with occupancy bound 0,
           one with a small bound; each lane bit for bit its single call,
           a lane with bound 0 bit for bit the call without the bound),
           again after `serving_latency` at the shapes its batches gave
           it, with seed_eval_full's and refine's lane forms there; the
           fused block's checks include refine_column's two calls (all A
           rows, keys per query, one query row's keys)
  parity   a small closed-loop rollout (70 frames, past the temporal
           window) on the card (through the kernels) equal to the same
           rollout on the CPU (through the plain versions), both from one
           set of model inputs built on the CPU, with the
           flagship's flags and, as `parity_latency`, `parity_fused` and
           `parity_pallas`, with the latency preset's three kernel flags,
           with use_fused_block, with use_pallas_attention;
           `parity_serving` the same for three scenarios served as one
           batched rollout of four lanes (RolloutServer.rollout_batch),
           with the flagship's flags, with use_pallas_attention, with
           use_fused_block + use_seed_kernel_full + use_refine_kernel, and
           with the latency preset's three kernel flags
  serving  the flagship at full width serving 8 synthetic scenarios
           (150 frames each) through RolloutServer.rollout_batch (agent
           buckets 32 / 64 / 128), in batches of up to 8 lanes and one
           scenario at a time,
           unforced and forced: ms per batched token step, agent-steps/s,
           launches, host reads and peak memory; `serving_kernels` the
           same with use_fused_block, use_seed_kernel_full and
           use_refine_kernel on the flagship (the JAX bench's
           INFGEN_BENCH_FUSED + _SEEDK_FULL + _REFK program), all three
           kernels launched at B = 8; `serving_latency` the same for the
           latency preset (configs/ours_long_term_latency.yaml: its three
           kernels, the column's lane form among them, at B = 8)
  trainable_grad  r_biased_attention_trainable (the kernel's forward, the
           plain recompute backward) at the training forward's three
           shapes in fp32, without and with dropout: forward and six
           gradients against autograd through the plain version, a fully
           masked query's output and dq 0; kernel ms beside its bound, the
           backward's ms
  train    the training main path: the flagship with use_pallas_attention
           (cli train --pallas-attention) at full width, bf16, dropout,
           remat, batch 2 (synthetic seeds 0 and 1), 8 steps of
           Trainer.train_step: finite losses, the last below the first,
           ms per step, peak memory, and per step exactly the kernel
           launches and backward calls of 15 eligible sublayers per
           scenario forward (remat recompute included); then one fp32 step
           without dropout with the kernel path against the plain one
  train_configs  every YAML under configs/ (13) at its own full width:
           init, 2 steps at batch 2 (use_pallas_attention on the agent
           decoder's configs), finite losses and gradient norms, init and
           step ms, peak memory, and per step exactly r_biased_attention's
           launches and backward calls (train_step_counts);
           then one step of ours_standard_decode_occ.yaml (the occupancy
           decoder) on the card against the CPU, fp32
  open_loop  validate_open_loop of the flagship with use_pallas_attention
           over 8 synthetic scenarios, bf16: ms per scenario, exactly 2
           forwards x 15 launches per scenario; two scenarios in fp32 on
           the card against the CPU (logs within OPEN_LOOP_TOL, accuracies
           equal or apart only by certified near-tie flips)
  check_inputs  the flagship's tokenised inputs of 8 scenarios: state
           accuracy and grid overlap counts equal card to CPU
  warm_start  the flagship trained 2 steps into a checkpoint (cli.run_train),
           `cli rollout --ckpt-path` from it (70 frames, seed_eval launched)
           making the decisions of the trainer's in-memory weights, and
           ours_standard.yaml warm-started from it (`--pretrain-ckpt`)
  learning the learning-dynamics path (python -m
           infgen_torch.validate_learning) at the flagship's full width:
           2 synthetic 48-agent scenarios, 4 train steps at batch 2, scored
           before and after at 150 frames (production beams, seed_eval),
           each kernel count set to 0 before and read after: finite losses
           and metametrics, seed_eval launched in the scorings only; seconds,
           ms per train step and per scoring, the scores and the share of
           the active agents' future frames that are valid
  womd     the WOMD input pipeline at the flagship's full width: synthetic
           WOMD tfrecords from a seeded generator (8 scenarios of 60-120
           agents and more than 6 km of map, one more of 132 agents),
           preprocessed by two spawned workers, WaymoDataset's meta filter
           (the 132-agent scenario dropped) and truncation to A and P;
           `cli rollout --data-dir` one scenario at a time and with
           --batch 8 (agent-steps/s per agent bucket), `cli train
           --data-dir --pallas-attention` (2 steps at batch 2, two spawned
           loader workers: ms per step and the input wait), `cli validate
           --data-dir` on one scenario at production beams, each kernel
           count set to 0 before and read after; `parity_womd` one
           preprocessed scenario at parity_config, card against CPU; the
           numpy splitter's token ids against the native ones
  scoring  the scored closed loop (cli.run_validate): the flagship at full
           width and depth, production beams (motion 5, insertion 10),
           bf16, seed_eval, over 4 synthetic scenarios (seeds 0-3):
           rollouts, WOSAC features, log histograms and likelihoods on the
           card; the card's outputs then go through the same port code on
           the CPU, and features, booleans, histogram bins, likelihoods and
           the metametric must agree (limits at SCORING_SCENARIOS); ms per
           scenario of the rollout, the features and the scoring, the
           scoring's peak memory, the metametric and its buckets; then one
           scenario as two rollouts (n_rollout_close_val = 2, two lanes):
           [2A, ...] features and a finite score
  parity_stream  parity_config's rollout as a stream of three 70-frame
           segments on the card, through StreamingRollout.run (one bucket)
           and through make_stream_fn, with the flagship's flags and the
           latency preset's; each segment run again on the CPU from the
           card's seam: decisions equal, headings within POSE_TOL,
           positions within POSE_TOL scaled by the segment's distance
           from the origin (check_parity_stream)
  parity_latency_bf16  the latency preset at full width in bf16, beams 1,
           forced insertion, 300 frames, on its three kernels against its
           plain modules (both on the card): decisions compared step by
           step up to the first difference, which must be certified from
           the plain side's logits against limits taken from E2E_TOL
  stream   the streaming main path at full width, bf16, production beams:
           the flagship through cli.run_stream (900 frames in 300-frame
           segments, re-bucketed), 8 scenarios as lanes through the chunked
           runner (plan 128 / 64 / 64), the latency preset for two
           segments, and its fleet of 8 through the chunked runner (plan
           128 / 64): ms per segment and per token step, agent-steps/s,
           agents ever alive, buckets, host reads, peak memory, launches;
           the registries' invariants
  export   the exported rollout (rollout/export.py) of the latency preset
           and of the flagship, each at full width, bf16, forced
           insertion, insertion_fixed_trip, SERVING_FRAMES (150) frames:
           exported through the command line's function (cli.run_export)
           into a file and loaded back in a spawned process per config,
           started after `build` (tracing, saving and loading are
           host-bound Python, minutes of it, beside the phases between);
           at its turn this process runs the direct make_rollout_fn
           rollout on the same inputs, then the artifact runs in its
           process with a generator of the same seed: every output equal
           bit for bit, each kernel's launches in the two runs equal and
           above zero for the config's kernels (seed_eval_full, refine and
           motion_column; seed_eval). Readings: seconds to export and to
           load, bytes per program, ms per token step of each.
           use_fused_block and use_pallas_attention are exported in the
           CPU tests (tests/test_torch_export.py)
  rollout  the flagship rollout (configs/ours_long_term.yaml), its two
           variants (use_fused_block, use_pallas_attention: the command
           line's --fused-block / --pallas-attention) and the latency
           preset's (configs/ours_long_term_latency.yaml), each at full
           width, 300 frames = 60 token steps, bf16, random weights from the
           config's seed, through the command line's rollout function: once
           without forced insertion (the seed head biased to decline) and
           once with it, with every kernel's launch count of that run

then the summary line of every kernel ({"kernels": [...]}; every entry but
r_biased_attention's also carries its lane form's time, bound and
launches in the served batches (`serving`, `serving_kernels`,
`serving_latency`), each kernel that `stream` launched its
`stream_launches`, each kernel that `export`'s artifacts launched its
`export_launches`; seed_eval's `warm_start_launches`,
`learning_launches` and `womd_launches`,
r_biased_attention's `train_configs_launches`,
`train_configs_backward_calls`, `open_loop_launches` and `womd_launches`)
and, last, the device line {"ok": true, "device": {...}}. Without CUDA it
exits non-zero and prints no result. fp32 checks run with TF32 off for matmuls and cuDNN.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(ROOT, "configs", "ours_long_term.yaml")
LATENCY = os.path.join(ROOT, "configs", "ours_long_term_latency.yaml")

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, and operations/s
# for fp32 outside the tensor cores and for bf16 operands
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}

F32, BF16 = torch.float32, torch.bfloat16
# Kernel tolerances: max abs error against the plain version on the same
# inputs and card, outputs of order 1-10. fp32: both sides compute in fp32
# and differ only in summation order. bf16: both round the same matmul
# operands to bf16 and sum in fp32, so again only summation order differs,
# until a last-bit difference in an fp32 sum rounds an operand to the
# neighbouring bf16 value (a relative 2^-8) in one of them. Over many rows
# and sublayers such flips cascade, so the kernels with stages are held
# stage by stage, each stage on the same inputs as the kernel's: the column
# one layer at a time (the plain layer l starts from the kernel's layer
# l - 1), the full seed evaluation's precompute and its stack (the plain
# stack reads the kernel's precompute), refine one sublayer at a time and
# its heads (refine_errors). Flips are sparse: they set the max
# abs error (TOL) but hardly the mean abs error (MEAN_TOL), while a kernel
# that skipped the operand rounding would be off by up to 2^-9 on every
# operand, so every output moves. Each bf16 limit sits above the error read
# on an H100 at these shapes, and MEAN_TOL below what such a kernel reads
# (PERF.md, the mutant). E2E_TOL holds the whole call, whose bf16 error is
# the whole cascade's.
# Readings on an H100 (bf16 max / mean; the mutant's in brackets):
# seed_eval 3.6e-5 / 4.3e-8 (1.1e-2 / 2.4e-3) on the one-block kernel;
# on the cluster stack 2.4e-7 / 1.5e-8, one case explained by one flip
# (raw 8.1e-3) (1.9e-2 / 4.4e-3), seed_eval_full 9.7e-3 / 8.0e-4
# (2.3e-2 / 3.3e-3), motion_column 2.0e-2 / 1.1e-3 since its tensor-core
# redesign (2.3e-2 / 8.1e-4 before); fp32 all below 2e-5. refine since its
# cluster redesign: stage-wise 2.9e-3 / 2.2e-5, whole call 7.0e-3 (2.8e-2
# / 4.8e-3, whole call 1.1e-2 to 1.9e-2 by case, so E2E_TOL refuses each
# case on its own); the one-block kernel's whole call read
# 2.4e-7 / 2.4e-8 against limits of 1e-3 / 1e-4. The tensor-core paths
# (column, refine) take bf16 operands only, so their mutant rounds every
# operand toward zero instead of to nearest (scripts/rounding_mutant.py,
# which does the same to the seed stack): the column's 6.7e-2 / 8.6e-3,
# refused by the mean limit (the earlier design's copy without rounding:
# 3.5e-2 / 5.2e-3).
TOL = {"seed_eval": {F32: 1e-4, BF16: 1e-3},
       "seed_eval_full": {F32: 1e-4, BF16: 3e-2},
       "refine": {F32: 1e-4, BF16: 1e-2},
       "motion_column": {F32: 1e-4, BF16: 0.1}}
MEAN_TOL = {"seed_eval": {F32: 1e-5, BF16: 1e-4},
            "seed_eval_full": {F32: 1e-5, BF16: 1.6e-3},
            "refine": {F32: 1e-5, BF16: 1e-4},
            "motion_column": {F32: 1e-5, BF16: 2e-3}}
E2E_TOL = {"seed_eval_full": {F32: 1e-4, BF16: 5e-2},
           "refine": {F32: 1e-4, BF16: 1e-2},
           "motion_column": {F32: 1e-4, BF16: 0.5}}
# fused_attention_block and r_biased_attention compute in fp32 whatever
# their inputs' type (the TPU kernels' recipe: no operand rounding), so both
# are held to fp32 limits, the bf16 policy's check too: there the fused
# block takes bf16-valued inputs as fp32 tensors. With bf16 tensors (the
# rollout's) the block rounds its fp32 result to bf16 on both sides, and a
# last-bit difference may round to the neighbouring bf16 value: each output
# is held to the fp32 limit plus one bf16 step of the plain version's
# (BF16_STEP |ref|).
TOL.update({"fused_attention_block": {F32: 1e-4, BF16: 1e-4},
            "r_biased_attention": {F32: 1e-4}})
MEAN_TOL.update({"fused_attention_block": {F32: 1e-5, BF16: 1e-5},
                 "r_biased_attention": {F32: 1e-5}})
BF16_STEP = 2.0 ** -7
SOURCES = {"seed_eval": ("infgen_torch/ops/csrc/seed_eval.cu",
                         "infgen_tpu/ops/seed_kernel.py:286"),
           "seed_eval_full": ("infgen_torch/ops/csrc/seed_eval_full.cu",
                              "infgen_tpu/ops/seed_kernel.py:404"),
           "refine": ("infgen_torch/ops/csrc/refine.cu",
                      "infgen_tpu/ops/refine_kernel.py:192"),
           "motion_column": ("infgen_torch/ops/csrc/motion_column.cu",
                             "infgen_tpu/ops/column_kernel.py:291"),
           "fused_attention_block": ("infgen_torch/ops/csrc/fused_block.cu",
                                     "infgen_tpu/ops/fused_block.py:123"),
           "r_biased_attention": (
               "infgen_torch/ops/csrc/r_biased_attention.cu",
               "infgen_tpu/ops/pallas_attention.py:111")}
# why library_ms is null: no single PyTorch call computes the function
NO_LIBRARY = {
    "seed_eval": "no single PyTorch call computes the nine-sublayer chain",
    "seed_eval_full": "no single call computes the precompute and stack",
    "refine": "no single call computes the six-sublayer pass and heads",
    "motion_column": "no single call computes 18 relation-biased sublayers",
    "fused_attention_block": "no single call computes a whole DenseAttention "
                             "layer (attention, gated update, FFN)",
    "r_biased_attention": "scaled_dot_product_attention takes an additive "
                          "score bias but cannot add a per-pair bias to V"}
KERNEL_LAUNCHES, PLAIN_CALLS = 200, 30   # timed calls per kernel / plain
# the main paths, in the order driven: (config, flags replaced on it, the
# kernels whose launches the kernels line reports from it)
MAIN_PATHS = (
    (FLAGSHIP, {}, ("seed_eval",)),
    (FLAGSHIP, dict(use_fused_block=True), ("fused_attention_block",)),
    (FLAGSHIP, dict(use_pallas_attention=True), ("r_biased_attention",)),
    (LATENCY, {}, ("seed_eval_full", "refine", "motion_column")))
# the unforced rollouts: shift of the seed state head's "enter" logit (see
# run_preset)
ENTER_LOGIT_SHIFT = -30.0
POSE_TOL = 1e-3          # parity poses: fp32 reduction order only
PARITY_FRAMES = 70       # 14 token steps: Ti = 16 columns > W = 12
SEED_LANES, SEED_LANES_OFF = 8, (2, 5)   # the lane check's lanes, masked
SERVING_SCENARIOS = 8    # synthetic scenarios (seeds 0..7) of `serving`
# frames each served scenario rolls out, cut from the configs' 300 (the
# plain flagship served one scenario at a time was a sixth of the run) to
# keep the whole run within its time beside the training phases
SERVING_FRAMES = 150
SERVING_BUCKETS = (32, 64, 128)
REFINE_ROWS, REFINE_AGENTS = 32, 24   # the rollout's refine neighbourhood


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def median_ms(fn, n, warmup=3):
    """Median device time of `fn` over n calls (one CUDA event pair each)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


# --------------------------------------------------------------------- #
# kernels
# --------------------------------------------------------------------- #

def randomize(model, seed):
    """Every parameter from a numpy seed, with non-zero biases and
    LayerNorm offsets so that every packed vector matters."""
    from infgen_torch.model.layers import LayerNorm

    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in sorted(model.named_parameters()):
            owner = model.get_submodule(name.rsplit(".", 1)[0])
            if isinstance(owner, LayerNorm):
                val = (1.0 if name.endswith("weight") else 0.0) \
                    + rng.normal(0, 0.1, p.shape)
            elif p.dim() == 2:        # Dense [out, in]; w_kr / w_vr [in, out]
                fan_in = p.shape[0] if name.endswith(("w_kr", "w_vr")) \
                    else p.shape[1]
                val = rng.normal(0, fan_in ** -0.5, p.shape)
            else:
                val = rng.normal(0, 0.1, p.shape)
            p.copy_(torch.as_tensor(val, dtype=torch.float32))


def decoder_for(cfg, attr, dtype, dev):
    """The agent decoder with the compute dtype of a check and the same
    numpy-seeded weights for every dtype."""
    from infgen_torch.model.infgen import InfGenModel

    model = InfGenModel(cfg.replace(compute_dtype=str(dtype)[6:]),
                        attr.grid, attr.grid_size, attr.angle_size)
    randomize(model, seed=17)
    return model.to(dev).eval().agent_decoder


def _tensor(dev):
    return lambda a, dt=F32: torch.as_tensor(
        np.asarray(a, np.float32), device=dev).to(dt)


def _geo(rng, t, *shape, radius=75.0):
    """Relation features (distance, angle, heading) of `shape` pairs."""
    return t(np.stack([rng.uniform(0, radius, shape),
                       rng.uniform(-3, 3, shape),
                       rng.uniform(-3, 3, shape)], -1))


def seed_eval_inputs(dec, cfg, G, dtype, rng, case, dev):
    """The kernel's inputs at the main path's shapes, built as the rollout
    builds them (ops/seed_fast.py) from numpy-seeded raw features."""
    from infgen_torch.ops import seed_fast as SF

    L, P, A, D = (cfg.num_seed_layers, cfg.max_map_tokens, cfg.max_agents,
                  cfg.hidden_dim)
    t = _tensor(dev)
    x_pt, agent_col = t(rng.normal(size=(P, D))), t(rng.normal(size=(A, D)))
    pl_mask = torch.as_tensor(rng.uniform(size=P) < 0.7, device=dev)
    a_mask = torch.as_tensor(rng.uniform(size=A) < 0.8, device=dev)
    if case == "map_all_masked":
        pl_mask[:] = False
    if case == "agents_all_masked":
        a_mask[:] = False
    occ = torch.as_tensor(rng.uniform(size=G) < 0.05, device=dev)
    with torch.no_grad():
        r_pl, r_sa = dec.embed_pl2sa_r(_geo(rng, t, P)), \
            dec.embed_a2sa_r(_geo(rng, t, A))
        occ_emb = dec.embed_occ(occ)
        chain = dec.seed_key_chain(agent_col)
        K_pt, V_pt, K_a, V_a, v_occ = [], [], [], [], []
        for i in range(L):
            pt, ag = dec.pt2sa_attn_layers[i], dec.a2sa_attn_layers[i]
            v_occ.append(SF.occ_value(dec.occ2sa_attn_layers[i], occ_emb,
                                      dtype))
            k0, v0 = SF.precompute_src_kv(pt, x_pt, dtype)
            kr, vr = SF.r_contrib(pt, r_pl, dtype)
            K_pt.append(k0 + kr)
            V_pt.append(v0 + vr)
            ka, va = SF.precompute_src_kv(ag, chain[i], dtype)
            kar, var_ = SF.r_contrib(ag, r_sa, dtype)
            K_a.append(ka + kar)
            V_a.append(va + var_)
        sd0 = t(rng.normal(size=D))
    return (sd0, torch.stack(v_occ), torch.stack(K_pt), torch.stack(V_pt),
            pl_mask, torch.stack(K_a), torch.stack(V_a), a_mask)


def _nbytes(*ts):
    return sum(x.numel() * x.element_size() for x in ts)


def seed_eval_cost(pack, args, outs):
    """(bytes, multiply-adds) one evaluation needs: each input read once,
    each output written once; the mat-vecs, scores and aggregates. A masked
    key's K and V rows take no part in the result (its softmax weight is
    exactly 0), so only the valid keys' rows are counted, as this run's
    masks give them. The pack holds only what the evaluation reads (no
    query projection for occ2sa)."""
    sd0, v_occ, K_pt, _, mask_pl, K_a, _, mask_a = args
    L, D, G = pack.L, pack.D, pack.G
    n_pl, n_a = int(mask_pl.sum()), int(mask_a.sum())
    kv_rows = 2 * L * (n_pl + n_a)             # K and V, every layer
    nbytes = kv_rows * D * K_pt.element_size() + _nbytes(
        pack.weights, pack.vectors, sd0, v_occ, mask_pl, mask_a, *outs)
    return nbytes, _stack_macs(L, D, G, kv_rows)


def seed_lanes_cost(pack, sd0, lanes, outs, on):
    """(bytes, multiply-adds) of one lane-form launch: what the lanes share
    (the pack, sd0, the lane mask) read once, each active lane's valid K/V
    rows, v_occ and masks read once, the outputs written once; each active
    lane's mat-vecs, scores and aggregates. `lanes` holds the stacked
    (v_occ, K_pt, V_pt, mask_pl, K_a, V_a, mask_a)."""
    v_occ, K_pt, _, mask_pl, _, _, mask_a = lanes
    L, D, G = pack.L, pack.D, pack.G
    nbytes = _nbytes(pack.weights, pack.vectors, sd0, on, *outs)
    macs = 0
    for b in on.nonzero().flatten().tolist():
        kv_rows = 2 * L * (int(mask_pl[b].sum()) + int(mask_a[b].sum()))
        nbytes += kv_rows * D * K_pt.element_size() + _nbytes(
            v_occ[b], mask_pl[b], mask_a[b])
        macs += _stack_macs(L, D, G, kv_rows)
    return nbytes, macs


def _stack_macs(L, D, G, kv_rows):
    macs = 3 * L * 12 * D * D                  # wg 2, ws, wo, wf0 4, wf1 4
    macs += 2 * L * D * D                      # wq of pt2sa and a2sa
    macs += kv_rows * D                        # scores + aggregates
    return macs + 4 * D * D + 8 * D + D * G    # heads


def seed_full_inputs(dec, cfg, G, dtype, rng, case, dev):
    """The full kernel's raw inputs as the rollout passes them: k0 / v0
    from the map features, the geometry embeddings from the model, the
    agent column in the compute dtype."""
    from infgen_torch.ops import seed_fast as SF

    L, P, A, D = (cfg.num_seed_layers, cfg.max_map_tokens, cfg.max_agents,
                  cfg.hidden_dim)
    t = _tensor(dev)
    cdt = dtype or F32
    x_pt = t(rng.normal(size=(P, D)))
    pl_mask = torch.as_tensor(rng.uniform(size=P) < 0.7, device=dev)
    a_mask = torch.as_tensor(rng.uniform(size=A) < 0.8, device=dev)
    if case == "map_all_masked":
        pl_mask[:] = False
    if case == "agents_all_masked":
        a_mask[:] = False
    with torch.no_grad():
        kv = [SF.precompute_src_kv(dec.pt2sa_attn_layers[i], x_pt, dtype)
              for i in range(L)]
        args = (t(rng.normal(size=D)), torch.stack([k for k, _ in kv]),
                torch.stack([v for _, v in kv]),
                dec.embed_pl2sa_r(_geo(rng, t, P)), pl_mask,
                t(rng.normal(size=(A, D)), cdt),
                dec.embed_a2sa_r(_geo(rng, t, A)), a_mask,
                torch.as_tensor(rng.uniform(size=G) < 0.05, device=dev))
    return args


def seed_full_cost(pack, args, outs):
    """(bytes, multiply-adds in the compute dtype, fp32 multiply-adds) of
    one full evaluation: the stack as seed_eval_cost counts it, plus the
    precompute of the rows it reads. Masked map and agent rows' k0 / v0,
    geometry, chain and K/V take no part in the result; the occupancy MLP
    reads the W0 rows of the occupied cells only (the others add 0)."""
    sd0, k0, _, _, mask_pl, _, _, mask_a, occ = args
    base = pack.base
    L, D, G = base.L, base.D, base.G
    n_pl, n_a, n_occ = (int(mask_pl.sum()), int(mask_a.sum()),
                        int(occ.sum()))
    es = k0.element_size()
    nbytes = (2 * L * n_pl + n_pl + 2 * n_a) * D * es  # k0 v0 r_pl col r_sa
    nbytes += _nbytes(base.weights, base.vectors, pack.weights, sd0,
                      mask_pl, mask_a, occ, *outs)
    nbytes += (pack.vectors.numel() - (G - n_occ) * D) * 4
    return (nbytes, _full_macs(L, D, G, n_pl, n_a),
            n_occ * D + D * D)                          # occupancy MLP


def _full_macs(L, D, G, n_pl, n_a):
    """Multiply-adds in the compute dtype of one full evaluation with n_pl
    valid map rows and n_a valid agent rows."""
    macs = n_pl * L * 2 * D * D                         # map geometry terms
    macs += n_a * ((3 * L - 1) * 11 * D * D + L * 4 * D * D)  # chain, K/V
    macs += L * D * D                                   # occ2sa values
    return macs + _stack_macs(L, D, G, 2 * L * (n_pl + n_a))


def seed_full_lanes_cost(pack, sd0, lanes, outs, on):
    """(bytes, multiply-adds, fp32 multiply-adds) of one lane-form launch of
    seed_eval_full, as seed_lanes_cost counts seed_eval's: what the lanes
    share (the packs, sd0, the lane mask; the occupancy MLP's W0 rows of
    the cells some active lane occupies) read once, each active lane's rows
    as seed_full_cost counts one evaluation's, the outputs written once.
    `lanes` holds the stacked (k0, v0, r_pl, mask_pl, col, r_sa, mask_a,
    occ)."""
    k0, _, _, mask_pl, _, _, mask_a, occ = lanes
    base = pack.base
    L, D, G = base.L, base.D, base.G
    act = on.nonzero().flatten().tolist()
    es = k0.element_size()
    nbytes = _nbytes(base.weights, base.vectors, pack.weights, sd0, on,
                     *outs)
    nbytes += (pack.vectors.numel()
               - (G - int(occ[act].any(0).sum())) * D) * 4
    macs = macs_f32 = 0
    for b in act:
        n_pl, n_a = int(mask_pl[b].sum()), int(mask_a[b].sum())
        nbytes += (2 * L * n_pl + n_pl + 2 * n_a) * D * es + _nbytes(
            mask_pl[b], mask_a[b], occ[b])
        macs += _full_macs(L, D, G, n_pl, n_a)
        macs_f32 += int(occ[b].sum()) * D + D * D
    return nbytes, macs, macs_f32


def refine_inputs(dec, cfg, dtype, rng, case, dev):
    """The refine pass's padded inputs as the rollout builds them: row 0
    the inserted agent, rows 1..24 its neighbours, map key k in row k."""
    R, Ka, D = REFINE_ROWS, REFINE_AGENTS, cfg.hidden_dim
    t = _tensor(dev)
    cdt = dtype or F32
    x = torch.zeros((R, D), device=dev)
    x[:1 + Ka] = t(rng.normal(size=(1 + Ka, D)), cdt).float()
    r_aa = torch.zeros((R, D), dtype=cdt, device=dev)
    mask_a = torch.zeros(R, dtype=torch.bool, device=dev)
    mask_pl = torch.as_tensor(rng.uniform(size=R) < 0.6, device=dev)
    with torch.no_grad():
        r_pl = dec.embed_pl2a_r(_geo(rng, t, R, radius=10.0))
        r_aa[1:1 + Ka] = dec.embed_a2a_r(_geo(rng, t, Ka, radius=10.0))
    mask_a[1:1 + Ka] = torch.as_tensor(rng.uniform(size=Ka) < 0.6,
                                       device=dev)
    if case == "agents_all_masked":
        mask_a[:] = False
    if case == "map_all_masked":
        mask_pl[:] = False
    return (x, t(rng.normal(size=(R, D)), cdt), r_pl, mask_pl, r_aa, mask_a)


def refine_cost(pack, args, outs):
    """(bytes, multiply-adds) of one refine pass as this run's masks need
    it: K/V of the valid map keys and agent rows, the epilogue of row 0 and
    of the valid agent rows (their features are row 0's later keys; after
    the last agent sublayer only row 0 is read), the heads. Each input row
    that takes part is read once, the pack once, the outputs written
    once."""
    x, pl_keys, _, mask_pl, _, mask_a = args
    L, D = pack.L, pack.D
    n_pl, n_a = int(mask_pl.sum()), int(mask_a.sum())
    es = pl_keys.element_size()
    nbytes = (1 + n_a) * D * 4 + (2 * n_pl + n_a) * D * es + _nbytes(
        pack.weights, pack.vectors, mask_pl, mask_a, *outs)
    macs = 0
    for j in range(2 * L):
        n_keys = n_pl if j % 2 == 0 else n_a
        macs += n_keys * (4 * D * D + 2 * D) + D * D    # K/V, scores, q
        macs += 12 * D * D                               # row 0 epilogue
        if j < 2 * L - 1:
            macs += n_a * 11 * D * D                     # zero-agg rows
    macs += 2 * D * D + D * (pack.angle_size + 2)        # heads
    return nbytes, macs


def column_inputs(dec, cfg, dtype, rng, case, dev, n_rows=None):
    """The column's inputs at cfg's shapes, as the rollout builds them
    (relation embeddings from the model; keys and relations in the compute
    dtype; the column fp32). Returns (args, n_rows): rows at or above
    n_rows (77 in case "n_rows", else A, unless given) are inactive slots
    with every key masked."""
    from infgen_torch.config import SHIFT

    L, A, D = cfg.num_agent_layers, cfg.max_agents, cfg.hidden_dim
    Ti = (cfg.num_recurrent_steps_val + cfg.num_historical_steps) // SHIFT
    W, K = min(cfg.time_span // SHIFT, Ti), cfg.pl2a_num_neighbors
    t = _tensor(dev)
    cdt = dtype or F32
    if n_rows is None:
        n_rows = 77 if case == "n_rows" else A
    act = torch.arange(A, device=dev) < n_rows
    m = lambda *s, p: torch.as_tensor(rng.uniform(size=s) < p, device=dev)
    t_mask = m(A, W, p=0.8) & act[:, None]
    pl_mask = m(A, K, p=0.8) & act[:, None]
    aa_mask = (m(A, A, p=0.5) & act[:, None] & act[None]
               & ~torch.eye(A, dtype=torch.bool, device=dev))
    t_mask[5] = False                       # rows with no temporal key,
    pl_mask[5] = False                      # no map key, no agent key
    aa_mask[9] = False
    if case == "aa_all_masked":
        aa_mask[:] = False
    t_raw = torch.cat([_geo(rng, t, A, W),
                       t(rng.integers(-W, 0, (A, W, 1)))], -1)
    with torch.no_grad():
        args = (t(rng.normal(size=(A, D)), cdt).float(),
                t(rng.normal(size=(L, A, W, D)), cdt),
                dec.r_t_emb(t_raw).to(cdt), t_mask,
                t(rng.normal(size=(A, K, D)), cdt),
                dec.r_pt2a_emb(_geo(rng, t, A, K, radius=30.0)).to(cdt),
                pl_mask,
                dec.r_a2a_emb(_geo(rng, t, A, A, radius=60.0)).to(cdt),
                aa_mask)
    return args, n_rows


def column_cost(pack, args, n_rows):
    """(bytes, multiply-adds) of one column as this run's masks need it:
    the valid (query, key) pairs' key / relation projections (4 D^2 for a
    temporal or map pair, 2 D^2 for an agent pair, whose key side is the
    row's shared projection), scores and aggregates, the shared K/V of the
    rows that are some live query's agent key, the query and aggregate
    projections of live rows and the epilogue of every row, in every layer.
    Inputs that take part are read once, the output written once."""
    x0, key_stack, _, t_mask, _, _, pl_mask, _, aa_mask = args
    L, D = pack.L, pack.D
    A = x0.shape[0]
    live = (torch.arange(A, device=x0.device) < n_rows)[:, None]
    n_t, n_pl = int((t_mask & live).sum()), int((pl_mask & live).sum())
    n_aa = int((aa_mask & live).sum())
    key_rows = int((aa_mask & live).any(0).sum())
    n_live = min(n_rows, A)
    es = key_stack.element_size()
    nbytes = ((L + 1) * n_t + 2 * n_pl + n_aa) * D * es + _nbytes(
        x0, t_mask, pl_mask, aa_mask, pack.weights, pack.vectors)
    nbytes += L * A * D * 4                                   # output
    per_layer = (n_t + n_pl) * 4 * D * D + n_aa * 2 * D * D
    per_layer += (n_t + n_pl + n_aa) * 2 * D
    per_layer += 3 * (A * 11 * D * D + n_live * 2 * D * D)
    per_layer += key_rows * 2 * D * D
    return nbytes, L * per_layer


def _least(dtype, *forms):
    """The (multiply-adds at `dtype`, fp32 multiply-adds) form of one term
    that takes the least time at the peaks of PEAK_OPS."""
    return min(forms, key=lambda f: f[0] / PEAK_OPS[dtype]
               + f[1] / PEAK_OPS[F32])


def column_cost_least(pack, args, n_rows, num_heads):
    """(bytes, multiply-adds at the pack's dtype, fp32 multiply-adds) of one
    column in the least time known for it: column_cost's bytes and row
    products (the epilogue of every row, q and the aggregate's gate of live
    rows, the shared k / v of the rows some live query reads), and each
    sublayer's key and relation terms in the form of least time at the
    peak of the type its products run in. Direct (column_cost): a relation
    costs its two projections per valid pair (2 D^2, operands in the
    pack's dtype); keys cost their projections (2 D^2 per pair with
    per-query keys, per key row read for the agent-agent sublayer) and the
    score and value sums (2 D per pair, fp32). Reassociated
    (csrc/fused_block.cu's form, fp32 throughout): per valid pair two dot
    products with per-head query vectors and two per-head weighted sums
    (2 H D each term), and per query row with a valid key the products
    that make those vectors and project the sums (2 D^2 each term)."""
    x0, key_stack, _, t_mask, _, _, pl_mask, _, aa_mask = args
    L, D, H = pack.L, pack.D, num_heads
    A = x0.shape[0]
    dt = key_stack.dtype
    live = (torch.arange(A, device=x0.device) < n_rows)[:, None]
    nbytes, _ = column_cost(pack, args, n_rows)
    key_rows = int((aa_mask & live).any(0).sum())
    n_live = min(n_rows, A)
    row = 3 * (A * 11 * D * D + n_live * 2 * D * D)
    macs, macs_f32 = L * row, 0
    for kind, mask in enumerate((t_mask, pl_mask, aa_mask)):
        n = int((mask & live).sum())
        q = int((mask & live).any(1).sum())
        reassociated = (0, n * 2 * H * D + q * 2 * D * D)
        rel = _least(dt, (n * 2 * D * D, 0), reassociated)
        direct_keys = (n * 2 * D * D, n * 2 * D) if kind < 2 else \
            (key_rows * 2 * D * D, n * 2 * D)
        keys = _least(dt, direct_keys, reassociated)
        macs += L * (rel[0] + keys[0])
        macs_f32 += L * (rel[1] + keys[1])
    return nbytes, macs, macs_f32


def bound_of(nbytes, macs, macs_f32, dtype):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the multiply-adds (`macs` of `dtype`, `macs_f32` of
    fp32) over their peak rates."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (2 * macs / PEAK_OPS[dtype] + 2 * macs_f32 / PEAK_OPS[F32]) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def finish(kernel, dtype, errs, means, ms, plain_ms, nbytes, macs,
           macs_f32=0, e2e=None, **extra):
    """Emit one `kernels` line (with the bound computed from this run's
    inputs) and hold the errors to the kernel's tolerances: the stage-wise
    max and mean abs errors `errs` and `means` (per case), and the whole
    call's max abs error `e2e` where the kernel has stages."""
    bound_ms, bound_by = bound_of(nbytes, macs, macs_f32, dtype)
    tol = TOL[kernel][dtype]
    if e2e is not None:
        extra.update(end_to_end_err=max(e2e.values()), end_to_end_errors=e2e,
                     end_to_end_tolerance=E2E_TOL[kernel][dtype])
    mean_tol = MEAN_TOL[kernel][dtype]
    res = dict(dtype=str(dtype).replace("torch.", ""),
               max_abs_err=max(errs.values()), errors=errs, tolerance=tol,
               mean_abs_err=max(means.values()), mean_errors=means,
               mean_tolerance=mean_tol, ms=ms, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by,
               bytes=nbytes, operations=2 * (macs + macs_f32),
               library_ms=None, library_none=NO_LIBRARY[kernel], **extra)
    emit("kernels", kernel=kernel, **res)
    require(res["max_abs_err"] <= tol and res["mean_abs_err"] <= mean_tol,
            f"{kernel} {dtype} disagrees with its plain version: max {errs} "
            f"> {tol} or mean {means} > {mean_tol}")
    require(e2e is None or res["end_to_end_err"] <= E2E_TOL[kernel][dtype],
            f"{kernel} {dtype}: the whole call disagrees with its plain "
            f"version: {e2e}")
    return res


def _flat(out):
    return torch.cat([o.reshape(-1) for o in out]) \
        if isinstance(out, tuple) else out.reshape(-1)


def _err(got, ref, what):
    """(max, mean) abs error of `got` against `ref`."""
    got, ref = _flat(got), _flat(ref)
    require(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    d = (got - ref).abs()
    return float(d.max()), float(d.mean())


class NearTieRounder:
    """Rounds matmul operands to bf16 as the plain version does (its
    `round_operand` hook), listing every operand that lies within `eps` bf16
    steps of a rounding midpoint, where a kernel summing in another order
    may round to the other neighbour; with `flip` = (call, index) it rounds
    that one operand the other way, with `flips` each of those."""

    def __init__(self, flip=None, eps=1e-3, flips=()):
        self.flips = set(flips) | ({flip} if flip is not None else set())
        self.eps, self.calls, self.sites = eps, 0, []

    def __call__(self, x):
        r = x.to(BF16).float()
        bits = r.to(BF16).view(torch.int16).to(torch.int32)
        # the neighbour on x's side of r: one step away from 0 when |x| >
        # |r|, one step towards it otherwise (bf16 bits order by magnitude)
        away = (x.abs() > r.abs()).to(torch.int32) * 2 - 1
        other = (bits + away).to(torch.int16).view(BF16).float()
        ok = (r != 0) & (x != r) & torch.isfinite(other)
        tie = ((x - (r + other) / 2).abs() / (other - r).abs()).masked_fill(
            ~ok, float("inf"))
        for i in torch.nonzero(tie.reshape(-1) < self.eps).flatten().tolist():
            self.sites.append((self.calls, i, float(tie.reshape(-1)[i])))
        mine = [i for c, i in self.flips if c == self.calls]
        if mine:
            r = r.reshape(-1).clone()
            r[mine] = other.reshape(-1)[mine]
            r = r.reshape(x.shape)
        self.calls += 1
        return r


def explain_by_one_flip(plain, got, limit):
    """Whether the kernel's output `got` is the plain version's with one
    bf16 rounding near-tie resolved the other way: `plain(rounder)` runs
    the plain version with a NearTieRounder. Returns (max abs error after
    the best flip, that flip's (call, index, distance to the midpoint in
    bf16 steps), near-ties found) or None when no near-tie exists."""
    finder = NearTieRounder()
    plain(finder)
    best = None
    for site in sorted(finder.sites, key=lambda t: t[2])[:32]:
        e = _err(got, plain(NearTieRounder(flip=site[:2])), "flip search")[0]
        if best is None or e < best[0]:
            best = (e, site)
        if e <= limit:
            break
    return None if best is None else (*best, len(finder.sites))


def diagnose_flips(plain, got, tries=16, eps=1e-3):
    """What explains a kernel's output `got` that no one flip does: the one
    or two near-tie flips (operands within `eps` bf16 steps of a midpoint)
    that bring the plain version `plain(rounder)` closest to `got` in max
    abs error, the first of the `tries` operands nearest a midpoint, the
    second of the `tries` nearest once the first is flipped (a flip moves
    every later operand). A diagnosis, never a hold: returns the (max,
    mean) abs error before any flip and after the best flips, those flips
    and the near-ties found."""
    near = lambda rounder, made=(): sorted(
        (t for t in rounder.sites if t[:2] not in made),
        key=lambda t: t[2])[:tries]
    err = lambda rounder: _err(got, plain(rounder), "flip diagnosis")
    finder = NearTieRounder(eps=eps)
    before = err(finder)
    best = (before, ())
    for first in near(finder):
        one = NearTieRounder(eps=eps, flips={first[:2]})
        best = min(best, (err(one), (first,)), key=lambda t: t[0][0])
        for second in near(one, {first[:2]}):
            two = NearTieRounder(eps=eps, flips={first[:2], second[:2]})
            best = min(best, (err(two), (first, second)),
                       key=lambda t: t[0][0])
    return dict(errors=before, after_flips=best[0], near_ties=len(
        finder.sites), flips=[dict(operand_call=c, operand_index=i,
                                   bf16_steps_from_midpoint=d)
                              for c, i, d in best[1]])


def seed_eval_errors(pack, args, H, Hd, dtype, what):
    """(max, mean, raw max, one-flip explanation or None) of seed_eval on
    the card against seed_eval_reference on the same inputs. A bf16 case
    over the limits is held instead by its one-flip explanation: a one-row
    chain carries one rounding near-tie, resolved the other way by the
    kernel's summation order, into every later value; then the plain
    version with that one operand flipped must give the kernel's output
    within the fp32 limit."""
    from infgen_torch.ops import seed_kernel as SK

    with torch.no_grad():
        got = SK.seed_eval_kernel(pack, *args, H, Hd)
    torch.cuda.synchronize()
    return seed_errors_of(pack, args, got, H, Hd, dtype, what)


def seed_errors_of(pack, args, got, H, Hd, dtype, what):
    """seed_eval_errors of the kernel's output `got` on `args`."""
    from infgen_torch.ops import seed_kernel as SK

    with torch.no_grad():
        ref = SK.seed_eval_reference(pack, *args, H, Hd)
    err, mean = _err(got, ref, what)
    flip = None
    if dtype == BF16 and (err > TOL["seed_eval"][dtype]
                          or mean > MEAN_TOL["seed_eval"][dtype]):
        with torch.no_grad():
            found = explain_by_one_flip(
                lambda rnd: SK.seed_eval_reference(pack, *args, H, Hd,
                                                   round_operand=rnd),
                got, TOL["seed_eval"][F32])
        if found is not None and found[0] <= TOL["seed_eval"][F32]:
            flip = dict(after_flip_max_abs_err=found[0],
                        operand_call=found[1][0], operand_index=found[1][1],
                        bf16_steps_from_midpoint=found[1][2],
                        near_ties=found[2])
            return found[0], found[0], err, flip
    return err, mean, err, flip


def small_config(cfg, D, H):
    """cfg at width D with H heads of D / H, at the parity phases' sizes
    (16 agent slots, 128 map tokens, 3 agent and seed layers)."""
    return cfg.replace(max_agents=16, max_map_tokens=128, num_agent_layers=3,
                       num_seed_layers=3, num_map_layers=1, hidden_dim=D,
                       num_heads=H, head_dim=D // H)


def check_seed_eval_widths(cfg, dev):
    """seed_eval at its narrowest widths (fp32: D = 32 with 2 heads, the
    parity rollout's; bf16: D = 64 with 4 heads) against its plain version
    at its limits; and bf16 at D = 32 refused (seed_kernel.
    seed_eval_accepts: the stack's bf16 column slices are 8 columns)."""
    from infgen_torch.cli import build_tokenizers
    from infgen_torch.ops import seed_kernel as SK

    name = "seed_eval"
    errs, means, raw, flips = {}, {}, {}, {}
    for dtype, D, H in ((F32, 32, 2), (BF16, 64, 4)):
        small = small_config(cfg, D, H)
        attr = build_tokenizers(small)[0]
        G, L = attr.grid_size, small.num_seed_layers
        dec = decoder_for(small, attr, dtype, dev)
        pdt = None if dtype == F32 else dtype
        pack = SK.pack_seed_params(dec, L, G, pdt)
        for case in ("masked", "agents_all_masked"):
            args = seed_eval_inputs(dec, small, G, pdt,
                                    np.random.default_rng(71), case, dev)
            key = f"{str(dtype)[6:]}/D{D}H{H}/{case}"
            errs[key], means[key], raw[key], flip = seed_eval_errors(
                pack, args, H, D // H, dtype, f"{name} {key}")
            if flip:
                flips[key] = flip
    small = small_config(cfg, 32, 2)
    attr = build_tokenizers(small)[0]
    dec = decoder_for(small, attr, BF16, dev)
    pack = SK.pack_seed_params(dec, 3, attr.grid_size, BF16)
    args = seed_eval_inputs(dec, small, attr.grid_size, BF16,
                            np.random.default_rng(71), "masked", dev)
    try:
        SK.seed_eval_kernel(pack, *args, 2, 16)
        refused = False
    except ValueError:
        refused = True
    emit("seed_eval_widths", errors=errs, mean_errors=means, raw_errors=raw,
         explained_by_one_flip=flips, refused_bf16_D32=refused)
    for key in errs:
        dt = F32 if key.startswith("float32") else BF16
        require(errs[key] <= TOL[name][dt]
                and means[key] <= MEAN_TOL[name][dt],
                f"{name} {key} disagrees with its plain version: max "
                f"{errs[key]}, mean {means[key]}")
    require(refused or dev.type != "cuda",
            f"{name} launched in bf16 at D = 32, a width its kernel does "
            "not take")


def check_seed_eval(cfg, attr, dev):
    """seed_eval kernel vs seed_eval_reference on the card at the flagship
    shapes, in fp32 and bf16, over three mask cases; times at each dtype.
    Narrow widths first: check_seed_eval_widths."""
    from infgen_torch.ops import seed_kernel as SK

    check_seed_eval_widths(cfg, dev)
    G = attr.grid_size
    H, Hd, L = cfg.num_heads, cfg.head_dim, cfg.num_seed_layers
    results = {}
    for dtype in (F32, BF16):
        dec = decoder_for(cfg, attr, dtype, dev)
        pdt = None if dtype == F32 else dtype
        pack = SK.pack_seed_params(dec, L, G, pdt)
        errs, means = {}, {}
        raw, flips = {}, {}
        for case in ("masked", "map_all_masked", "agents_all_masked"):
            args = seed_eval_inputs(dec, cfg, G, pdt,
                                    np.random.default_rng(23), case, dev)
            errs[case], means[case], raw[case], flip = seed_eval_errors(
                pack, args, H, Hd, dtype, f"seed_eval {dtype} {case}")
            if flip:
                flips[case] = flip
        args = seed_eval_inputs(dec, cfg, G, pdt, np.random.default_rng(23),
                                "masked", dev)
        with torch.no_grad():
            ms = median_ms(lambda: SK.seed_eval_kernel(pack, *args, H, Hd),
                           KERNEL_LAUNCHES)
            plain_ms = median_ms(
                lambda: SK.seed_eval_reference(pack, *args, H, Hd),
                PLAIN_CALLS)
            outs = SK.seed_eval_kernel(pack, *args, H, Hd)
        results[dtype] = finish("seed_eval", dtype, errs, means, ms,
                                plain_ms,
                                *seed_eval_cost(pack, args, outs),
                                raw_max_abs_err=max(raw.values()),
                                raw_errors=raw, explained_by_one_flip=flips)
    return results


def check_seed_eval_lanes(cfg, attr, dev, n_lanes=SEED_LANES):
    """seed_eval's lane form at cfg's shapes (the flagship's, and the
    serving phase's buckets): n_lanes lanes of their own inputs in one
    launch, the lanes SEED_LANES_OFF masked off, in fp32 and bf16. Each
    active lane is held against the plain version on its inputs at
    seed_eval's limits (with its one-flip rule) and must equal the single
    launch on those inputs bit for bit; a masked-off lane's outputs must be
    zeros. Times: the batched launch, per active lane, beside the single
    launch; bound: seed_lanes_cost (the shared operands once, each active
    lane's own). Returns {dtype: result}."""
    from infgen_torch.ops import seed_kernel as SK

    G = attr.grid_size
    H, Hd, L = cfg.num_heads, cfg.head_dim, cfg.num_seed_layers
    on = lanes_on(n_lanes, dev)
    results = {}
    for dtype in (F32, BF16):
        dec = decoder_for(cfg, attr, dtype, dev)
        pdt = None if dtype == F32 else dtype
        pack = SK.pack_seed_params(dec, L, G, pdt)
        per = [seed_eval_inputs(dec, cfg, G, pdt,
                                np.random.default_rng(100 + b),
                                "agents_all_masked" if b == 3 else "masked",
                                dev) for b in range(n_lanes)]
        sd0 = per[0][0]
        lanes = [torch.stack([a[i] for a in per]) for i in range(1, 8)]
        with torch.no_grad():
            small, pos = SK.seed_eval_kernel(pack, sd0, *lanes, H, Hd,
                                             lanes=on)
            singles = [SK.seed_eval_kernel(pack, sd0, *a[1:], H, Hd)
                       for a in per]
        torch.cuda.synchronize()
        errs, means, raw, flips, same = {}, {}, {}, {}, {}
        for b in range(n_lanes):
            got = (small[b], pos[b])
            if not on[b]:
                require(not small[b].any() and not pos[b].any(),
                        f"seed_eval lane {b} is masked off but wrote")
                continue
            key = f"lane{b}"
            same[key] = bool(torch.equal(got[0], singles[b][0])
                             and torch.equal(got[1], singles[b][1]))
            args = (sd0, *per[b][1:])
            errs[key], means[key], raw[key], flip = seed_errors_of(
                pack, args, got, H, Hd, dtype, f"seed_eval lanes {key}")
            if flip:
                flips[key] = flip
        with torch.no_grad():
            ms = median_ms(lambda: SK.seed_eval_kernel(
                pack, sd0, *lanes, H, Hd, lanes=on), KERNEL_LAUNCHES)
            single_ms = median_ms(lambda: SK.seed_eval_kernel(
                pack, sd0, *per[0][1:], H, Hd), KERNEL_LAUNCHES)
        nbytes, macs = seed_lanes_cost(pack, sd0, lanes, (small, pos), on)
        bound_ms, bound_by = bound_of(nbytes, macs, 0, dtype)
        n_on = int(on.sum())
        res = dict(dtype=str(dtype)[6:], A=cfg.max_agents,
                   P=cfg.max_map_tokens, lanes=n_lanes,
                   lanes_off=[b for b in SEED_LANES_OFF if b < n_lanes],
                   max_abs_err=max(
                       errs.values()), errors=errs,
                   mean_abs_err=max(means.values()), mean_errors=means,
                   raw_max_abs_err=max(raw.values()), raw_errors=raw,
                   explained_by_one_flip=flips, tolerance=TOL[
                       "seed_eval"][dtype],
                   mean_tolerance=MEAN_TOL["seed_eval"][dtype],
                   equal_to_single_launch=same, ms=ms, ms_per_lane=ms / n_on,
                   single_ms=single_ms, bound_ms=bound_ms, bound_by=bound_by,
                   bytes=nbytes, operations=2 * macs)
        emit("seed_eval_lanes", **res)
        require(res["max_abs_err"] <= TOL["seed_eval"][dtype]
                and res["mean_abs_err"] <= MEAN_TOL["seed_eval"][dtype],
                f"seed_eval lanes {dtype} disagree with the plain version: "
                f"{errs} / {means}")
        require(all(same.values()),
                f"seed_eval lanes {dtype}: a lane differs from the single "
                f"launch on its inputs: {same}")
        results[dtype] = res
    return results


def seed_full_stages(pack, args, pre, what):
    """The two stages of one full evaluation: the (max, mean) abs error of
    the kernel's precompute `pre` against the plain one over the rows it
    computes (the valid keys'), and the arguments of the plain stack on the
    kernel's own precompute (the masked rows, which the kernel leaves
    unwritten, zeroed: their weight is 0)."""
    from infgen_torch.ops import seed_kernel as SK

    sd0, k0, v0, r_pl, mask_pl, col, r_sa, mask_a, occ = args
    twin = SK.seed_eval_full_precompute(pack, k0, v0, r_pl, col, r_sa, occ)
    rows = (mask_pl, mask_pl, mask_a, mask_a)
    pre_err = _err(
        tuple([pre[0]] + [a[:, m] for a, m in zip(pre[1:], rows)]),
        tuple([twin[0]] + [b[:, m] for b, m in zip(twin[1:], rows)]), what)
    z = lambda t, m: t.masked_fill(~m[None, :, None], 0.0)
    return pre_err, (sd0, pre[0], z(pre[1], mask_pl), z(pre[2], mask_pl),
                     mask_pl, z(pre[3], mask_a), z(pre[4], mask_a), mask_a)


def seed_full_stage_errors(pack, args, got, pre, H, Hd, what):
    """(max, mean) abs error of one full evaluation's two stages, the larger
    of each: the precompute's and the output's against the plain stack run
    on the kernel's own precompute (seed_full_stages)."""
    from infgen_torch.ops import seed_kernel as SK

    pre_err, stack_args = seed_full_stages(pack, args, pre, what)
    ref = SK.seed_eval_reference(pack.base, *stack_args, H, Hd)
    stack_err = _err(got, ref, what)
    return max(pre_err[0], stack_err[0]), max(pre_err[1], stack_err[1])


def seed_full_lane_errors(pack, args, got, pre, H, Hd, dtype, what):
    """One lane of seed_eval_full's lane form against its plain version:
    its stages as seed_full_stage_errors reads them, the stack stage held
    as seed_eval's cluster stack (which it is, on fp32 K/V) is held
    (seed_errors_of): a bf16 reading over seed_eval's limits counts by its
    one-flip explanation when one flipped near-tie operand of the one-row
    chain gives the kernel's output within seed_eval's fp32 limit. A stack
    reading over those limits that no one flip explains is diagnosed
    (diagnose_flips), never held by it. Returns (held max, held mean, a
    dict of the raw readings, the explanation, the diagnosis)."""
    from infgen_torch.ops import seed_kernel as SK

    pre_err, stack_args = seed_full_stages(pack, args, pre, what)
    raw = _err(got, SK.seed_eval_reference(pack.base, *stack_args, H, Hd),
               what)
    err, mean, _, flip = seed_errors_of(pack.base, stack_args, got, H, Hd,
                                        dtype, what)
    readings = dict(max=max(pre_err[0], raw[0]),
                    mean=max(pre_err[1], raw[1]), precompute=pre_err,
                    stack=raw)
    diagnosis = None
    if flip is None and (raw[0] > TOL["seed_eval"][dtype]
                         or raw[1] > MEAN_TOL["seed_eval"][dtype]):
        diagnosis = diagnose_flips(
            lambda rnd: SK.seed_eval_reference(pack.base, *stack_args, H, Hd,
                                               round_operand=rnd), got)
    return (max(pre_err[0], err), max(pre_err[1], mean), readings, flip,
            diagnosis)


def seed_full_stage_ms(pack, args, H, Hd):
    """The full evaluation's two kernels timed apart (median ms): the
    precompute alone, then the stack alone on the precompute's results."""
    from infgen_torch.ops import seed_kernel as SK

    launch = lambda **kw: SK.seed_eval_full_launch(pack, *args, H, Hd, **kw)
    pre = launch()[2]
    return dict(precompute_ms=median_ms(lambda: launch(stages=1, pre=pre),
                                        KERNEL_LAUNCHES),
                stack_ms=median_ms(lambda: launch(stages=2, pre=pre),
                                   KERNEL_LAUNCHES))


def check_seed_eval_full(cfg, attr, dev):
    """seed_eval_full kernel vs its plain version at the flagship shapes, in
    fp32 and bf16, over three mask cases, stage by stage (see TOL) and as a
    whole; times at each dtype, the whole call's and each stage's."""
    from infgen_torch.ops import seed_kernel as SK

    G = attr.grid_size
    H, Hd, L = cfg.num_heads, cfg.head_dim, cfg.num_seed_layers
    results = {}
    for dtype in (F32, BF16):
        dec = decoder_for(cfg, attr, dtype, dev)
        pdt = None if dtype == F32 else dtype
        pack = SK.pack_seed_params_full(dec, L, G, pdt)
        run = lambda fn, args, **kw: fn(pack, *args, H, Hd, **kw)
        errs, means, e2e = {}, {}, {}
        for case in ("masked", "map_all_masked", "agents_all_masked"):
            args = seed_full_inputs(dec, cfg, G, pdt,
                                    np.random.default_rng(29), case, dev)
            what = f"seed_eval_full {dtype} {case}"
            with torch.no_grad():
                *got, pre = run(SK.seed_eval_full_kernel, args,
                                return_precompute=True)
                ref = run(SK.seed_eval_full_reference, args)
                errs[case], means[case] = seed_full_stage_errors(
                    pack, args, tuple(got), pre, H, Hd, what)
            torch.cuda.synchronize()
            e2e[case] = _err(tuple(got), ref, what)[0]
        args = seed_full_inputs(dec, cfg, G, pdt, np.random.default_rng(29),
                                "masked", dev)
        with torch.no_grad():
            ms = median_ms(lambda: run(SK.seed_eval_full_kernel, args),
                           KERNEL_LAUNCHES)
            plain_ms = median_ms(
                lambda: run(SK.seed_eval_full_reference, args), PLAIN_CALLS)
            outs = run(SK.seed_eval_full_kernel, args)
            stages = seed_full_stage_ms(pack, args, H, Hd)
        results[dtype] = finish("seed_eval_full", dtype, errs, means, ms,
                                plain_ms,
                                *seed_full_cost(pack, args, outs), e2e=e2e,
                                **stages)
    return results


def refine_errors(pack, args, H, Hd, what):
    """(max, mean, whole-call max) abs error of one refine pass on the card,
    through the wrapper: sublayer by sublayer, each against the plain
    sublayer run on the kernel's own input (the traced call's x after the
    previous sublayer; after the last one, row 0, the only row the heads
    read), the heads on the kernel's last row 0 (see TOL); max and mean are
    the largest over the stages. The untraced call, which must equal the
    traced one bit for bit, against refine_reference as a whole."""
    from infgen_torch.ops import refine_kernel as RK

    with torch.no_grad():
        head, off, tr = RK.refine_kernel(pack, *args, H, Hd, trace=True)
        got = RK.refine_kernel(pack, *args, H, Hd)
    torch.cuda.synchronize()
    require(torch.equal(got[0], head) and torch.equal(got[1], off),
            f"{what}: the traced call's output differs from the untraced "
            "one's")
    return refine_errors_of(pack, args, head, off, tr, got, H, Hd, what)


def refine_errors_of(pack, args, head, off, tr, got, H, Hd, what):
    """refine_errors of the kernel's traced output (head, off, tr) and
    untraced output `got` on `args`."""
    from infgen_torch.ops import refine_kernel as RK

    x, plk, rpl, mpl, raa, ma = args
    with torch.no_grad():
        ref = RK.refine_reference(pack, *args, H, Hd)
        stages = []
        for j in range(2 * pack.L):
            want = RK.refine_sublayer(pack, j, x if j == 0 else tr[j - 1],
                                      plk, rpl, mpl, raa, ma, H, Hd)
            rows = slice(0, 1) if j == 2 * pack.L - 1 else slice(None)
            stages.append(_err(tr[j][rows], want[rows], f"{what} sublayer "
                               f"{j}"))
        stages.append(_err((head, off), RK.refine_heads(pack, tr[-1][0]),
                           f"{what} heads"))
    return (max(e for e, _ in stages), max(m for _, m in stages),
            _err(got, ref, what)[0])


def check_refine_widths(cfg, dev, wide):
    """refine at its narrowest clusters (D = 32 with 2 heads, the parity
    rollout's width, and D = 48 with 3), fp32 and bf16, against its plain
    version at its limits (refine_errors); and `wide` = (pack, args) of the
    flagship width called with 16 heads of 8, refused (refine_kernel.
    kernel_accepts: one CTA per head of 16)."""
    from infgen_torch.cli import build_tokenizers
    from infgen_torch.ops import refine_kernel as RK

    name = "refine"
    errs, means, e2e = {}, {}, {}
    for D, H in ((32, 2), (48, 3)):
        small = small_config(cfg, D, H)
        attr = build_tokenizers(small)[0]
        for dtype in (F32, BF16):
            dec = decoder_for(small, attr, dtype, dev)
            pdt = None if dtype == F32 else dtype
            pack = RK.pack_refine_params(dec, small.num_seed_layers,
                                         attr.angle_size, pdt)
            args = refine_inputs(dec, small, pdt, np.random.default_rng(73),
                                 "masked", dev)
            key = f"{str(dtype)[6:]}/D{D}H{H}"
            errs[key], means[key], e2e[key] = refine_errors(
                pack, args, H, D // H, f"{name} {key}")
    try:
        RK.refine_kernel(wide[0], *wide[1], 16, 8)
        refused = False
    except ValueError:
        refused = True
    emit("refine_widths", errors=errs, mean_errors=means,
         end_to_end_errors=e2e, refused_H16=refused)
    for key in errs:
        dt = F32 if key.startswith("float32") else BF16
        require(errs[key] <= TOL[name][dt] and means[key] <= MEAN_TOL[name][dt]
                and e2e[key] <= E2E_TOL[name][dt],
                f"{name} {key} disagrees with its plain version: max "
                f"{errs[key]}, mean {means[key]}, whole call {e2e[key]}")
    require(refused or dev.type != "cuda",
            f"{name} launched with 16 heads of 8, a width its kernel does "
            "not take")


def check_refine(cfg, attr, dev):
    """refine kernel vs its plain version at the flagship shapes, in fp32
    and bf16, over three mask cases, sublayer by sublayer and as a whole
    (refine_errors); times at each dtype, and the timed calls' output held
    as a whole too. Narrow widths after the fp32 pass:
    check_refine_widths."""
    from infgen_torch.ops import refine_kernel as RK

    H, Hd, L = cfg.num_heads, cfg.head_dim, cfg.num_seed_layers
    results = {}
    for dtype in (F32, BF16):
        dec = decoder_for(cfg, attr, dtype, dev)
        pdt = None if dtype == F32 else dtype
        pack = RK.pack_refine_params(dec, L, attr.angle_size, pdt)
        run = lambda fn, args: fn(pack, *args, H, Hd)
        errs, means, e2e = {}, {}, {}
        for case in ("masked", "map_all_masked", "agents_all_masked"):
            args = refine_inputs(dec, cfg, pdt, np.random.default_rng(31),
                                 case, dev)
            errs[case], means[case], e2e[case] = refine_errors(
                pack, args, H, Hd, f"refine {dtype} {case}")
        args = refine_inputs(dec, cfg, pdt, np.random.default_rng(31),
                             "masked", dev)
        if dtype == F32:
            check_refine_widths(cfg, dev, (pack, args))
        with torch.no_grad():
            ms = median_ms(lambda: run(RK.refine_kernel, args),
                           KERNEL_LAUNCHES)
            plain_ms = median_ms(lambda: run(RK.refine_reference, args),
                                 PLAIN_CALLS)
            outs = run(RK.refine_kernel, args)
            timed = _err(outs, run(RK.refine_reference, args),
                         f"refine {dtype} timed")[0]
        require(timed <= E2E_TOL["refine"][dtype],
                f"refine {dtype}: the timed calls' output is off its plain "
                f"version by {timed}")
        results[dtype] = finish("refine", dtype, errs, means, ms,
                                plain_ms,
                                *refine_cost(pack, args, outs), e2e=e2e)
    return results


def check_motion_column(cfg, attr, dev):
    """motion_column kernel vs motion_column_reference at the flagship
    shapes, fp32 and bf16, one layer at a time (see TOL) and as a whole:
    some keys masked (rows with a whole key set masked among them), every
    agent key masked, and an occupancy bound n_rows = 77 < A, where the
    kernel with the bound must equal the kernel without it bit for bit.
    Timed with every row live."""
    from infgen_torch.ops import column_kernel as CK

    H, Hd, L = cfg.num_heads, cfg.head_dim, cfg.num_agent_layers
    results = {}
    for dtype in (F32, BF16):
        dec = decoder_for(cfg, attr, dtype, dev)
        pdt = None if dtype == F32 else dtype
        pack = CK.pack_column_params(dec, L, pdt)
        run = lambda fn, args, nr=None: fn(pack, *args, H, Hd, n_rows=nr)
        errs, means, e2e = {}, {}, {}
        for case in ("masked", "aa_all_masked", "n_rows"):
            args, n_rows = column_inputs(dec, cfg, pdt,
                                         np.random.default_rng(37), case,
                                         dev)
            nr = torch.tensor(n_rows, dtype=torch.int32, device=dev)
            what = f"motion_column {dtype} {case}"
            with torch.no_grad():
                got = run(CK.motion_column_kernel, args, nr)
                full = run(CK.motion_column_kernel, args)
                layers = CK.motion_column_reference(
                    pack, *args, H, Hd, n_rows=nr, layer_inputs=got)
                ref = run(CK.motion_column_reference, args, nr)
            torch.cuda.synchronize()
            require(torch.equal(got, full),
                    f"{what}: the n_rows={n_rows} skip changed the output")
            errs[case], means[case] = _err(got, layers, what)
            e2e[case] = _err(got, ref, what)[0]
        args, n_rows = column_inputs(dec, cfg, pdt,
                                     np.random.default_rng(37), "masked",
                                     dev)
        with torch.no_grad():
            ms = median_ms(lambda: run(CK.motion_column_kernel, args),
                           KERNEL_LAUNCHES)
            plain_ms = median_ms(
                lambda: run(CK.motion_column_reference, args), PLAIN_CALLS)
        nbytes, macs = column_cost(pack, args, n_rows)
        _, least, least_f32 = column_cost_least(pack, args, n_rows, H)
        results[dtype] = finish(
            "motion_column", dtype, errs, means, ms, plain_ms, nbytes, least,
            macs_f32=least_f32, e2e=e2e,
            launches_per_call=CK.launches_per_call(dtype, L),
            bound_ms_direct=bound_of(nbytes, macs, 0, dtype)[0],
            operations_direct=2 * macs)
    return results


# the fused block's cases: (name, the trunk sublayer whose module it
# takes, key mode); the first three are the rollout's calls
FUSED_CASES = (("temporal", "t_attn_0", "per_query"),
               ("map", "pt2a_0", "per_query"),
               ("agent", "a2a_0", "self"),
               ("shared", "t_attn_0", "shared"),
               ("shared_bipartite", "pt2a_0", "shared"),
               # AgentDecoder.refine_column's fused branch: all A rows, map
               # keys x_pt[pl_keys], then agent keys x[a2a_idx], per query
               ("refine_map", "pt2a_0", "per_query"),
               ("refine_agent", "a2a_0", "per_query"))
# query_row: refine_column's masks, the keys of one query row only
MASK_CASES = ("random", "half", "all_valid", "query_row")


def fused_inputs(dec, cfg, kind, mode, mask_case, rng, dev):
    """(x [A, D], x_src, r, mask) of one fused-block case at the flagship
    shapes, fp32: the rollout's key counts (W = 12 temporal, 5 map, A agent
    keys; 100 shared keys; refine_column's 32 map and 24 agent keys, the
    rollout's refine neighbourhood), relations from the model's
    embeddings. Mask
    cases: random (p 0.5, row 3 fully masked, row 7 all valid), half (every
    other key valid in every row), all valid, query_row (row 11's keys at
    p 0.8, every other row fully masked)."""
    from infgen_torch.config import SHIFT

    A, D = cfg.max_agents, cfg.hidden_dim
    Ti = (cfg.num_recurrent_steps_val + cfg.num_historical_steps) // SHIFT
    W = min(cfg.time_span // SHIFT, Ti)
    K = {"temporal": W, "map": cfg.pl2a_num_neighbors, "agent": A,
         "refine_map": REFINE_ROWS, "refine_agent": REFINE_AGENTS}.get(
        kind, 100)
    t = _tensor(dev)
    x = t(rng.normal(size=(A, D)))
    src = {"self": None, "per_query": (A, K, D), "shared": (K, D)}[mode]
    src = None if src is None else t(rng.normal(size=src))
    with torch.no_grad():
        if kind in ("temporal", "shared"):
            r = dec.r_t_emb(torch.cat([_geo(rng, t, A, K),
                                       t(rng.integers(-W, 0, (A, K, 1)))],
                                      -1))
        elif kind in ("agent", "refine_agent"):
            r = dec.r_a2a_emb(_geo(rng, t, A, K, radius=60.0))
        else:
            r = dec.r_pt2a_emb(_geo(rng, t, A, K, radius=30.0))
    if mask_case == "random":
        mask = torch.as_tensor(rng.uniform(size=(A, K)) < 0.5, device=dev)
        mask[3] = False
        mask[7] = True
    elif mask_case == "half":
        mask = (torch.arange(K, device=dev) % 2 == 0)[None].expand(A, K)
    elif mask_case == "query_row":
        mask = torch.zeros((A, K), dtype=torch.bool, device=dev)
        mask[11] = torch.as_tensor(rng.uniform(size=K) < 0.8, device=dev)
    else:
        mask = torch.ones((A, K), dtype=torch.bool, device=dev)
    return x, src, r.float(), mask.contiguous()


def fused_cost(pack, x, src, r, mask):
    """(bytes, fp32 multiply-adds) of one fused-block call as this run's
    mask needs it: the query projection and epilogue (wga, wgd, ws, wo, the
    4D FFN: 13 D^2) of every row; per valid pair its relation projections
    (2 D^2), score and aggregate (2 D), and with per-query keys its key's
    projections (2 D^2); with shared or self keys the projections of the
    keys some query reads, once. Each input row that takes part is read
    once, the pack once, the output written once."""
    Q, D = x.shape
    n_pairs = int(mask.sum())
    es = x.element_size()
    nbytes = _nbytes(x, mask, pack.weights, pack.vectors) + Q * D * es
    nbytes += n_pairs * D * r.element_size()
    macs = Q * 13 * D * D + n_pairs * (2 * D * D + 2 * D)
    if src is not None and src.dim() == 3:
        nbytes += n_pairs * D * es
        macs += n_pairs * 2 * D * D
    else:
        key_rows = int(mask.any(0).sum())
        nbytes += 0 if src is None else key_rows * D * es
        macs += key_rows * 2 * D * D
    return nbytes, macs


def fused_cost_least(pack, x, src, r, mask):
    """(bytes, fp32 multiply-adds) of one fused-block call in the least work
    known for it: fused_cost's bytes; the row products of every query
    (13 D^2, as fused_cost); and the key and the relation terms each in the
    cheaper of two forms. Direct (fused_cost): a relation costs its two
    projections per valid pair (2 D^2); keys cost their projections (2 D^2
    per pair with per-query keys, per key row some query reads otherwise)
    and the score and value sums (2 D per pair). Reassociated
    (csrc/fused_block.cu): per valid pair two dot products with per-head
    query vectors and two per-head weighted sums (2 H D each term), and per
    query row with a valid key the two products that make those vectors
    and project the sums (2 D^2 each term)."""
    Q, D = x.shape
    H = pack.H
    n_pairs = int(mask.sum())
    live = int(mask.any(1).sum())
    nbytes, _ = fused_cost(pack, x, src, r, mask)
    reassociated = n_pairs * 2 * H * D + live * 2 * D * D
    if src is not None and src.dim() == 3:
        keys = n_pairs * (2 * D * D + 2 * D)
    else:
        keys = int(mask.any(0).sum()) * 2 * D * D + n_pairs * 2 * D
    macs = (Q * 13 * D * D + min(n_pairs * 2 * D * D, reassociated)
            + min(keys, reassociated))
    return nbytes, macs


def check_fused_widths(dev):
    """The fused kernel at the narrowest heads it takes (head_dim 4: D = 32
    with 8 heads, where its head products leave half the block's threads
    idle, and D = 64 with 16 heads, num_heads * D at its limit of 1024) in
    the three key modes, fp32, against its plain version at the fp32 limits;
    and D = 128 with 16 heads refused (fused_block.kernel_accepts)."""
    from infgen_torch.model.layers import DenseAttention
    from infgen_torch.ops import fused_block as FB

    name = "fused_attention_block"
    t = _tensor(dev)
    errs, means = {}, {}
    for D, H in ((32, 8), (64, 16)):
        for i, mode in enumerate(("per_query", "shared", "self")):
            rng = np.random.default_rng(59 + i)
            mod = DenseAttention(D, H, D // H, bipartite=mode == "per_query")
            randomize(torch.nn.ModuleList([mod]), seed=19)
            pack = FB.pack_fused_block(mod.to(dev))
            Q = 37
            K = {"per_query": 12, "shared": 53, "self": Q}[mode]
            x, r = t(rng.normal(size=(Q, D))), t(rng.normal(size=(Q, K, D)))
            src = {"per_query": (Q, K, D), "shared": (K, D)}.get(mode)
            src = None if src is None else t(rng.normal(size=src))
            mask = torch.as_tensor(rng.uniform(size=(Q, K)) < 0.5,
                                   device=dev)
            mask[3] = False
            mask[7] = True
            args = (pack, x, src, r, mask, H)
            with torch.no_grad():
                got = FB.fused_attention_block(*args)
                ref = FB.fused_attention_block_reference(*args)
            errs[f"D{D}H{H}/{mode}"], means[f"D{D}H{H}/{mode}"] = _err(
                got, ref, f"{name} D={D} H={H} {mode}")
    wide = FB.pack_fused_block(DenseAttention(128, 16, 8).to(dev))
    x = t(np.zeros((4, 128)))
    try:
        FB.fused_attention_block(wide, x, None, t(np.zeros((4, 4, 128))),
                                 torch.ones((4, 4), dtype=torch.bool,
                                            device=dev), 16)
        refused = False
    except ValueError:
        refused = True
    emit("fused_block_widths", errors=errs, mean_errors=means,
         tolerance=TOL[name][F32], mean_tolerance=MEAN_TOL[name][F32],
         refused_D128_H16=refused)
    require(max(errs.values()) <= TOL[name][F32]
            and max(means.values()) <= MEAN_TOL[name][F32],
            f"{name} at narrow heads disagrees with its plain version: "
            f"max {errs}, mean {means}")
    require(refused or dev.type != "cuda",
            f"{name} launched at D = 128 with 16 heads, a width its kernel "
            "does not take")


def check_fused_block(cfg, attr, dev):
    """fused_attention_block kernel vs fused_attention_block_reference at
    the flagship shapes: every key mode (per query, shared, self), bipartite
    and not, over the mask cases, in fp32 and with bf16-valued inputs (held
    to the fp32 limits, see TOL; and as bf16 tensors, each output within
    one bf16 step). Timed on the rollout's three calls with bf16 tensors
    (the bf16 policy) or fp32 ones: ms, plain ms and bound are per call,
    averaged over the three. The bound counts the least work known for the
    layer (fused_cost_least); `bound_ms_direct` counts the direct form
    (fused_cost). Narrow heads: check_fused_widths."""
    from infgen_torch.ops import fused_block as FB

    check_fused_widths(dev)
    H, kernel_name = cfg.num_heads, "fused_attention_block"
    dec = decoder_for(cfg, attr, F32, dev)
    packs = {name: FB.pack_fused_block(getattr(dec, name))
             for _, name, _ in FUSED_CASES}
    results = {}
    for dtype in (F32, BF16):
        errs, means, steps = {}, {}, {}
        cast = (lambda a: a) if dtype == F32 else \
            (lambda a: None if a is None else a.to(BF16).float())
        for kind, name, mode in FUSED_CASES:
            for mc in MASK_CASES:
                x, src, r, mask = fused_inputs(
                    dec, cfg, kind, mode, mc, np.random.default_rng(41), dev)
                x, src, r = cast(x), cast(src), cast(r)
                what = f"fused_attention_block {dtype} {kind} {mc}"
                args = (packs[name], x, src, r, mask, H)
                with torch.no_grad():
                    got = FB.fused_attention_block(*args)
                    ref = FB.fused_attention_block_reference(*args)
                    if dtype == BF16:   # the same values as bf16 tensors
                        b = lambda a: None if a is None else a.to(BF16)
                        bargs = (packs[name], b(x), b(src), b(r), mask, H)
                        got_b = FB.fused_attention_block(*bargs)
                        ref_b = FB.fused_attention_block_reference(*bargs)
                torch.cuda.synchronize()
                errs[f"{kind}/{mc}"], means[f"{kind}/{mc}"] = _err(
                    got, ref, what)
                if dtype == BF16:
                    require(got_b.dtype == BF16, f"{what}: output dtype")
                    gb, rb = got_b.float(), ref_b.float()
                    _err(gb, rb, what)
                    # steps beyond the fp32 limit, in bf16 steps of |ref|
                    over = ((gb - rb).abs() - TOL[kernel_name][F32]) \
                        / (BF16_STEP * rb.abs()).clamp(min=1e-30)
                    steps[f"{kind}/{mc}"] = float(over.max())
        extra = {}
        if dtype == BF16:
            extra = dict(bf16_tensor_steps=max(steps.values()),
                         bf16_tensor_limit=1.0)
            require(extra["bf16_tensor_steps"] <= 1.0,
                    f"fused_attention_block with bf16 tensors is more than "
                    f"one bf16 step from its plain version: {steps}")
        ms, plain_ms, nbytes, macs, least = [], [], 0, 0, 0
        for kind, name, mode in FUSED_CASES[:3]:
            x, src, r, mask = fused_inputs(
                dec, cfg, kind, mode, "random", np.random.default_rng(43),
                dev)
            mask = torch.as_tensor(np.random.default_rng(47).uniform(
                size=mask.shape) < (0.5 if kind == "agent" else 0.8),
                device=dev)
            if dtype == BF16:
                x, src, r = (None if a is None else a.to(BF16)
                             for a in (x, src, r))
            args = (packs[name], x, src, r, mask, H)
            with torch.no_grad():
                ms.append(median_ms(lambda: FB.fused_attention_block(*args),
                                    KERNEL_LAUNCHES))
                plain_ms.append(median_ms(
                    lambda: FB.fused_attention_block_reference(*args),
                    PLAIN_CALLS))
            b, m = fused_cost(packs[name], x, src, r, mask)
            nbytes, macs = nbytes + b, macs + m
            least += fused_cost_least(packs[name], x, src, r, mask)[1]
        n = len(ms)
        results[dtype] = finish(
            "fused_attention_block", dtype, errs, means, sum(ms) / n,
            sum(plain_ms) / n, nbytes / n, 0, macs_f32=least / n,
            bound_ms_direct=bound_of(nbytes / n, 0, macs / n, dtype)[0],
            operations_direct=2 * macs / n,
            ms_by_call=dict(zip(("temporal", "map", "agent"), ms)),
            plain_ms_by_call=dict(zip(("temporal", "map", "agent"),
                                      plain_ms)), **extra)
    return results


# --------------------------------------------------------------------- #
# the lane forms of seed_eval_full, refine and fused_attention_block
# --------------------------------------------------------------------- #

def lanes_on(n_lanes, dev):
    """The lane mask of a lane check: SEED_LANES_OFF switched off."""
    return torch.tensor([b not in SEED_LANES_OFF for b in range(n_lanes)],
                        device=dev)


def lanes_result(phase, kernel, dtype, cfg, on, errs, means, same, zero, ms,
                 single_ms, cost, e2e=None, hold_errors=True, **extra):
    """Emit one lane check's line and hold it: every active lane equal to
    its single launch bit for bit, every masked-off lane's outputs zero,
    and (hold_errors) every active lane within the kernel's TOL / MEAN_TOL
    (and E2E_TOL, `e2e`) of its plain version. `cost` = (bytes,
    multiply-adds of dtype, fp32 multiply-adds) of the launch."""
    nbytes, macs, macs_f32 = cost
    bound_ms, bound_by = bound_of(nbytes, macs, macs_f32, dtype)
    n_lanes, n_on = on.numel(), int(on.sum())
    res = dict(dtype=str(dtype)[6:], A=cfg.max_agents, P=cfg.max_map_tokens,
               lanes=n_lanes, lanes_off=[b for b in range(n_lanes)
                                         if not on[b]],
               max_abs_err=max(errs.values()), errors=errs,
               mean_abs_err=max(means.values()), mean_errors=means,
               tolerance=TOL[kernel][dtype],
               mean_tolerance=MEAN_TOL[kernel][dtype],
               equal_to_single_launch=same, masked_lanes_zero=zero, ms=ms,
               ms_per_lane=ms / n_on, single_ms=single_ms, bound_ms=bound_ms,
               bound_by=bound_by, bytes=nbytes,
               operations=2 * (macs + macs_f32), **extra)
    if e2e is not None:
        res.update(end_to_end_err=max(e2e.values()), end_to_end_errors=e2e,
                   end_to_end_tolerance=E2E_TOL[kernel][dtype])
    emit(phase, **res)
    require(all(same.values()), f"{phase} {dtype}: a lane differs from the "
            f"single launch on its inputs: {same}")
    require(all(zero.values()), f"{phase} {dtype}: a masked-off lane "
            f"wrote: {zero}")
    require(not hold_errors or (
        res["max_abs_err"] <= TOL[kernel][dtype]
        and res["mean_abs_err"] <= MEAN_TOL[kernel][dtype]),
        f"{phase} {dtype} disagree with the plain version: {errs} / {means}")
    require(e2e is None or res["end_to_end_err"] <= E2E_TOL[kernel][dtype],
            f"{phase} {dtype}: a whole call disagrees with the plain "
            f"version: {e2e}")
    return res


def check_seed_eval_full_lanes(cfg, attr, dev, n_lanes=SEED_LANES):
    """seed_eval_full's lane form at cfg's shapes (the flagship's, and the
    shapes the served batches gave it): n_lanes lanes of their own raw
    inputs (lane 3 with every agent key masked) in one call, the lanes
    SEED_LANES_OFF masked off, fp32 and bf16. Each active lane's output
    must equal the single call on its inputs bit for bit and is held
    against the plain version stage by stage on its own precompute, its
    stack stage as seed_eval's is held, and as a whole
    (seed_full_lane_errors; the raw readings beside); a masked-off lane's
    outputs must be zeros. Times: the lane call, per active lane, beside the single call;
    bound: seed_full_lanes_cost. Returns {dtype: result}."""
    from infgen_torch.ops import seed_kernel as SK

    G = attr.grid_size
    H, Hd, L = cfg.num_heads, cfg.head_dim, cfg.num_seed_layers
    on = lanes_on(n_lanes, dev)
    results = {}
    for dtype in (F32, BF16):
        dec = decoder_for(cfg, attr, dtype, dev)
        pdt = None if dtype == F32 else dtype
        pack = SK.pack_seed_params_full(dec, L, G, pdt)
        per = [seed_full_inputs(dec, cfg, G, pdt,
                                np.random.default_rng(100 + b),
                                "agents_all_masked" if b == 3 else "masked",
                                dev) for b in range(n_lanes)]
        sd0 = per[0][0]
        lanes = [torch.stack([a[i] for a in per]) for i in range(1, 9)]
        with torch.no_grad():
            small, pos, pre = SK.seed_eval_full_kernel(
                pack, sd0, *lanes, H, Hd, return_precompute=True, lanes=on)
            singles = [SK.seed_eval_full_kernel(pack, sd0, *a[1:], H, Hd)
                       for a in per]
        torch.cuda.synchronize()
        errs, means, e2e, same, zero = {}, {}, {}, {}, {}
        raw, flips, diagnosed = {}, {}, {}
        for b in range(n_lanes):
            key, got = f"lane{b}", (small[b], pos[b])
            if not on[b]:
                zero[key] = not small[b].any() and not pos[b].any()
                continue
            same[key] = all(torch.equal(g, w) for g, w in zip(got,
                                                              singles[b]))
            args = (sd0, *per[b][1:])
            what = f"seed_eval_full lanes {dtype} {key}"
            with torch.no_grad():
                errs[key], means[key], raw[key], flip, diag = \
                    seed_full_lane_errors(pack, args, got,
                                          tuple(p[b] for p in pre), H, Hd,
                                          dtype, what)
                e2e[key] = _err(got, SK.seed_eval_full_reference(
                    pack, *args, H, Hd), what)[0]
            if flip:
                flips[key] = flip
            if diag:
                diagnosed[key] = diag
        with torch.no_grad():
            ms = median_ms(lambda: SK.seed_eval_full_kernel(
                pack, sd0, *lanes, H, Hd, lanes=on), KERNEL_LAUNCHES)
            single_ms = median_ms(lambda: SK.seed_eval_full_kernel(
                pack, sd0, *per[0][1:], H, Hd), KERNEL_LAUNCHES)
        results[dtype] = lanes_result(
            "seed_eval_full_lanes", "seed_eval_full", dtype, cfg, on, errs,
            means, same, zero, ms, single_ms,
            seed_full_lanes_cost(pack, sd0, lanes, (small, pos), on),
            e2e=e2e, raw_max_abs_err=max(r["max"] for r in raw.values()),
            raw_mean_abs_err=max(r["mean"] for r in raw.values()),
            raw_errors=raw, explained_by_one_flip=flips,
            unexplained_by_one_flip=diagnosed)
    return results


def check_refine_lanes(cfg, attr, dev, n_lanes=SEED_LANES):
    """refine's lane form at the flagship width: n_lanes lanes of their own
    padded 32-row neighbourhoods (lane 3 with every agent key masked) in
    one launch, the lanes SEED_LANES_OFF masked off, fp32 and bf16. Each
    active lane must equal the single launch on its inputs bit for bit and
    is held against the plain version sublayer by sublayer from the lane
    launch's own trace and as a whole (refine_errors_of); the untraced lane
    launch must equal the traced one; a masked-off lane's outputs must be
    zeros. Times: the lane launch, per active lane, beside the single
    launch; bound: refine_cost of each active lane, the pack once."""
    from infgen_torch.ops import refine_kernel as RK

    H, Hd, L = cfg.num_heads, cfg.head_dim, cfg.num_seed_layers
    on = lanes_on(n_lanes, dev)
    results = {}
    for dtype in (F32, BF16):
        dec = decoder_for(cfg, attr, dtype, dev)
        pdt = None if dtype == F32 else dtype
        pack = RK.pack_refine_params(dec, L, attr.angle_size, pdt)
        per = [refine_inputs(dec, cfg, pdt, np.random.default_rng(100 + b),
                             "agents_all_masked" if b == 3 else "masked",
                             dev) for b in range(n_lanes)]
        lanes = [torch.stack([a[i] for a in per]) for i in range(6)]
        with torch.no_grad():
            head, off, tr = RK.refine_kernel(pack, *lanes, H, Hd, trace=True,
                                             lanes=on)
            got = RK.refine_kernel(pack, *lanes, H, Hd, lanes=on)
            singles = [RK.refine_kernel(pack, *a, H, Hd) for a in per]
        torch.cuda.synchronize()
        require(torch.equal(got[0], head) and torch.equal(got[1], off),
                f"refine lanes {dtype}: the traced launch's output differs "
                "from the untraced one's")
        errs, means, e2e, same, zero = {}, {}, {}, {}, {}
        nbytes, macs = _nbytes(pack.weights, pack.vectors, on, *got), 0
        for b in range(n_lanes):
            key = f"lane{b}"
            if not on[b]:
                zero[key] = not got[0][b].any() and not got[1][b].any()
                continue
            same[key] = torch.equal(got[0][b], singles[b][0]) \
                and torch.equal(got[1][b], singles[b][1])
            errs[key], means[key], e2e[key] = refine_errors_of(
                pack, per[b], head[b], off[b], tr[b], (got[0][b], got[1][b]),
                H, Hd, f"refine lanes {dtype} {key}")
            nb, mc = refine_cost(pack, per[b], singles[b])
            nbytes += nb - _nbytes(pack.weights, pack.vectors, *singles[b])
            macs += mc
        with torch.no_grad():
            ms = median_ms(lambda: RK.refine_kernel(pack, *lanes, H, Hd,
                                                    lanes=on),
                           KERNEL_LAUNCHES)
            single_ms = median_ms(lambda: RK.refine_kernel(pack, *per[0], H,
                                                           Hd),
                                  KERNEL_LAUNCHES)
        results[dtype] = lanes_result(
            "refine_lanes", "refine", dtype, cfg, on, errs, means, same, zero,
            ms, single_ms, (nbytes, macs, 0), e2e=e2e)
    return results


def check_fused_block_lanes(cfg, attr, dev, n_lanes=SEED_LANES):
    """fused_attention_block's lane form at cfg's shapes (A query rows per
    lane): the rollout's three calls (temporal and map keys per query, the
    agent-agent call's keys the lane's own rows) with n_lanes lanes of
    their own inputs in one launch each, with fp32 and with bf16 tensors
    (the bf16 policy). The block takes no lane mask (the trunk runs every
    lane), so every lane is on. Each lane must equal the single call on its
    inputs bit for bit and is held against the plain version: fp32 at the
    fp32 limits, bf16 tensors within the fp32 limit plus one bf16 step of
    the plain output (as check_fused_block holds them). Times per launch,
    averaged over the three calls as check_fused_block averages, beside
    the single call; bound: fused_cost_least of each lane, the pack once
    per launch."""
    from infgen_torch.ops import fused_block as FB

    H, name_k = cfg.num_heads, "fused_attention_block"
    dec = decoder_for(cfg, attr, F32, dev)
    on = torch.ones(n_lanes, dtype=torch.bool, device=dev)
    results = {}
    for dtype in (F32, BF16):
        errs, means, same, steps = {}, {}, {}, {}
        ms, single_ms, nbytes, least = [], [], 0, 0
        for kind, name, mode in FUSED_CASES[:3]:
            pack = FB.pack_fused_block(getattr(dec, name))
            per = []
            for b in range(n_lanes):
                x, src, r, mask = fused_inputs(
                    dec, cfg, kind, mode, "random",
                    np.random.default_rng(100 + b), dev)
                per.append(tuple(None if a is None else a.to(dtype)
                                 for a in (x, src, r)) + (mask,))
            st = lambda i: None if per[0][i] is None else torch.stack(
                [a[i] for a in per])
            args = (pack, st(0), st(1), st(2), st(3), H)
            with torch.no_grad():
                got = FB.fused_attention_block(*args)
                singles = [FB.fused_attention_block(pack, *a, H)
                           for a in per]
                refs = [FB.fused_attention_block_reference(pack, *a, H)
                        for a in per]
            torch.cuda.synchronize()
            require(got.dtype == dtype, f"fused lanes {dtype}: output dtype")
            for b in range(n_lanes):
                key = f"{kind}/lane{b}"
                same[key] = torch.equal(got[b], singles[b])
                g, ref = got[b].float(), refs[b].float()
                errs[key], means[key] = _err(g, ref, f"fused lanes {key}")
                if dtype == BF16:
                    over = ((g - ref).abs() - TOL[name_k][F32]) \
                        / (BF16_STEP * ref.abs()).clamp(min=1e-30)
                    steps[key] = float(over.max())
                nb, _ = fused_cost(pack, *per[b])
                nbytes += nb - (_nbytes(pack.weights, pack.vectors)
                                if b else 0)
                least += fused_cost_least(pack, *per[b])[1]
            with torch.no_grad():
                ms.append(median_ms(lambda: FB.fused_attention_block(*args),
                                    KERNEL_LAUNCHES))
                single_ms.append(median_ms(
                    lambda: FB.fused_attention_block(pack, *per[0], H),
                    KERNEL_LAUNCHES))
        n = len(ms)
        extra = {}
        if dtype == BF16:
            extra = dict(bf16_tensor_steps=max(steps.values()),
                         bf16_tensor_limit=1.0)
            require(extra["bf16_tensor_steps"] <= 1.0,
                    f"fused_attention_block lanes with bf16 tensors are more "
                    f"than one bf16 step from the plain version: {steps}")
        results[dtype] = lanes_result(
            "fused_block_lanes", name_k, dtype, cfg, on, errs, means, same,
            {}, sum(ms) / n, sum(single_ms) / n, (nbytes / n, 0, least / n),
            hold_errors=dtype == F32,
            ms_by_call=dict(zip(("temporal", "map", "agent"), ms)),
            single_ms_by_call=dict(zip(("temporal", "map", "agent"),
                                       single_ms)), **extra)
    return results


LANE_CHECKS = {"seed_eval_full": check_seed_eval_full_lanes,
               "refine": check_refine_lanes,
               "fused_attention_block": check_fused_block_lanes}


# --------------------------------------------------------------------- #
# the lane form of motion_column
# --------------------------------------------------------------------- #

COLUMN_SMALL_LANE, COLUMN_SMALL_ROWS = 3, 7   # a lane with few live rows


def column_lanes_cost(pack, per, rows, num_heads):
    """(bytes, multiply-adds at the pack's dtype, fp32 multiply-adds) of one
    lane call: column_cost_least of each lane on its own inputs and
    occupancy bound (its keys and relations read once, its epilogues), the
    packed weights once per launch."""
    pack_bytes = _nbytes(pack.weights, pack.vectors)
    nbytes, macs, macs_f32 = pack_bytes, 0, 0
    for args, n in zip(per, rows):
        b, m, m32 = column_cost_least(pack, args, n, num_heads)
        nbytes, macs, macs_f32 = nbytes + b - pack_bytes, macs + m, \
            macs_f32 + m32
    return nbytes, macs, macs_f32


def check_column_lanes(cfg, attr, dev, n_lanes=SEED_LANES):
    """motion_column's lane form at cfg's shapes (the latency preset's
    A = 128, and the shapes the served batches gave it): n_lanes lanes of
    their own inputs in one call, the lanes SEED_LANES_OFF with occupancy
    bound 0 (no active slot), lane COLUMN_SMALL_LANE with COLUMN_SMALL_ROWS
    live rows, the others every row; fp32 and bf16. Each lane must equal
    the single call on its inputs and bound bit for bit; a lane with bound
    0 must equal the call without the bound on its inputs (every row's
    zero-aggregate epilogue, what the full computation gives) bit for bit;
    each lane is held against the plain version one layer at a time and as
    a whole, as check_motion_column holds the single call. Times: the lane
    call, per lane with live rows, the single call in the same run; bound:
    column_lanes_cost. Returns {dtype: result}."""
    from infgen_torch.ops import column_kernel as CK

    H, Hd, L, A = cfg.num_heads, cfg.head_dim, cfg.num_agent_layers, \
        cfg.max_agents
    rows = [0 if b in SEED_LANES_OFF else COLUMN_SMALL_ROWS
            if b == COLUMN_SMALL_LANE else A for b in range(n_lanes)]
    on = torch.tensor([n > 0 for n in rows], device=dev)
    nr = torch.tensor(rows, dtype=torch.int32, device=dev)
    results = {}
    for dtype in (F32, BF16):
        dec = decoder_for(cfg, attr, dtype, dev)
        pdt = None if dtype == F32 else dtype
        pack = CK.pack_column_params(dec, L, pdt)
        per = [column_inputs(dec, cfg, pdt, np.random.default_rng(100 + b),
                             "masked", dev, n_rows=rows[b])[0]
               for b in range(n_lanes)]
        lanes = [torch.stack([a[i] for a in per], 1 if i == 1 else 0)
                 for i in range(len(per[0]))]
        run = lambda args, n: CK.motion_column_kernel(pack, *args, H, Hd,
                                                      n_rows=n)
        with torch.no_grad():
            got = run(lanes, nr)
            singles = [run(a, nr[b]) for b, a in enumerate(per)]
            fulls = {b: run(per[b], None) for b in range(n_lanes)
                     if not rows[b]}
        torch.cuda.synchronize()
        require(got.shape == (L, n_lanes, A, cfg.hidden_dim),
                f"column lanes {dtype}: output shape {tuple(got.shape)}")
        errs, means, e2e, same, empty = {}, {}, {}, {}, {}
        for b in range(n_lanes):
            key, g = f"lane{b}", got[:, b]
            same[key] = torch.equal(g, singles[b])
            if not rows[b]:
                empty[key] = torch.equal(g, fulls[b])
            what = f"motion_column lanes {dtype} {key}"
            with torch.no_grad():
                layers = CK.motion_column_reference(
                    pack, *per[b], H, Hd, n_rows=nr[b], layer_inputs=g)
                ref = CK.motion_column_reference(pack, *per[b], H, Hd,
                                                 n_rows=nr[b])
            errs[key], means[key] = _err(g, layers, what)
            e2e[key] = _err(g, ref, what)[0]
        with torch.no_grad():
            ms = median_ms(lambda: run(lanes, nr), KERNEL_LAUNCHES)
            single_ms = median_ms(lambda: run(per[0], nr[0]),
                                  KERNEL_LAUNCHES)
        W, K = per[0][1].shape[2], per[0][4].shape[1]
        results[dtype] = lanes_result(
            "column_lanes", "motion_column", dtype, cfg, on, errs, means,
            same, {}, ms, single_ms,
            column_lanes_cost(pack, per, rows, H), e2e=e2e, n_rows=rows,
            empty_lanes_zero_aggregate=empty,
            launches_per_call=CK.launches_per_call(dtype, L),
            scratch_bytes=4 * n_lanes * CK.scratch_floats(
                pack.dtype, L, A, W, K, cfg.hidden_dim))
        require(all(empty.values()), f"column lanes {dtype}: a lane with "
                f"bound 0 differs from its full computation: {empty}")
    return results


def rba_inputs(rng, B, Q, K, Dr, HD, H, drop, dev, w=None):
    """q, k, v, r, w_kr, w_vr, mask, drop of one r_biased_attention call:
    normal values (r as the LayerNorm'd relations it stands for), a random
    mask (p 0.5) with a fully masked query row and an all-valid one, an
    attention-dropout multiplier (p 0.1) or None."""
    t = _tensor(dev)
    f = lambda *s: t(rng.normal(size=s))
    w_kr, w_vr = w if w is not None else (f(Dr, HD) * Dr ** -0.5,
                                          f(Dr, HD) * Dr ** -0.5)
    mask = torch.as_tensor(rng.uniform(size=(B, Q, K)) < 0.5, device=dev)
    mask[0, 3] = False
    mask[0, 5] = True
    d = None
    if drop:
        d = t((rng.uniform(size=(B, Q, K, H)) < 0.9) / 0.9)
    return (f(B, Q, HD), f(B, K, HD), f(B, K, HD), f(B, Q, K, Dr),
            w_kr.contiguous(), w_vr.contiguous(), mask, d)


def rba_cost(args):
    """(bytes, fp32 multiply-adds) of one call as this run's mask needs it:
    per valid pair the two relation projections (2 Dr HD), score and
    aggregate (2 HD); its relation row and dropout row read once; the k / v
    rows that some query reads, the queries, weights and mask once, the
    output written once."""
    q, k, v, r, w_kr, w_vr, mask, drop = args
    B, Q, HD = q.shape
    Dr = r.shape[-1]
    n_pairs = int(mask.sum())
    key_rows = int(mask.any(1).sum())
    nbytes = _nbytes(q, w_kr, w_vr, mask) + q.numel() * 4       # + output
    nbytes += key_rows * 2 * HD * 4 + n_pairs * Dr * 4
    if drop is not None:
        nbytes += n_pairs * drop.shape[-1] * 4
    return nbytes, n_pairs * (2 * Dr * HD + 2 * HD)


def rba_cost_least(args, num_heads):
    """(bytes, fp32 multiply-adds) of one call in the least work known for
    it: rba_cost's bytes and per valid pair its score and aggregate against
    k and v (2 HD); the relation term in the cheaper of two forms: direct
    (rba_cost), the two projections per valid pair (2 Dr HD); reassociated
    (csrc/r_biased_attention.cu), per valid pair a dot product with each
    head's ur_h = W_kr[:, h] q_h and a per-head weighted sum of the
    relation row (2 H Dr), and per query row with a valid key the products
    that make ur and project the sums through W_vr (2 Dr HD)."""
    q, _, _, r, _, _, mask, _ = args
    HD, Dr = q.shape[-1], r.shape[-1]
    n_pairs = int(mask.sum())
    rows = int(mask.any(-1).sum())
    nbytes, _ = rba_cost(args)
    rel = min(n_pairs * 2 * Dr * HD,
              n_pairs * 2 * num_heads * Dr + rows * 2 * Dr * HD)
    return nbytes, n_pairs * 2 * HD + rel


def check_rba_widths(dev):
    """The attention kernel at widths other than the rollout's (fp32 limits,
    a fully masked query exactly 0): the parity rollout's (HD = Dr = 32, 2
    heads), head_dim 4 (64 wide, 16 heads), heads not a multiple of four
    (48 wide, 6 heads, with dropout), the widest relation sums it takes
    (Dr = 256 with 8 heads: H Dr = 2048) and HD = 256; and 32 heads refused
    (pallas_attention.kernel_accepts)."""
    from infgen_torch.ops import pallas_attention as PA

    name = "r_biased_attention"
    errs, means = {}, {}
    for i, (B, Q, K, HD, Dr, H, drop) in enumerate((
            (1, 16, 16, 32, 32, 2, False), (1, 37, 53, 64, 64, 16, False),
            (2, 21, 70, 48, 48, 6, True), (1, 9, 40, 128, 256, 8, False),
            (1, 9, 40, 256, 64, 4, False))):
        args = rba_inputs(np.random.default_rng(61 + i), B, Q, K, Dr, HD, H,
                          drop, dev)
        with torch.no_grad():
            got = PA.r_biased_attention(*args[:7], H, args[7])
            ref = PA.r_biased_attention_reference(*args[:7], H, args[7])
        torch.cuda.synchronize()
        case = f"HD{HD}Dr{Dr}H{H}"
        errs[case], means[case] = _err(got, ref, f"{name} {case}")
        require(float(got[0, 3].abs().max()) == 0.0,
                f"{name} {case}: a fully masked query is not 0")
    try:
        PA.r_biased_attention(*rba_inputs(np.random.default_rng(67), 1, 8, 8,
                                          128, 128, 32, False, dev)[:7], 32)
        refused = False
    except ValueError:
        refused = True
    emit("rba_widths", errors=errs, mean_errors=means,
         tolerance=TOL[name][F32], mean_tolerance=MEAN_TOL[name][F32],
         refused_H32=refused)
    require(max(errs.values()) <= TOL[name][F32]
            and max(means.values()) <= MEAN_TOL[name][F32],
            f"{name} at other widths disagrees with its plain version: max "
            f"{errs}, mean {means}")
    require(refused or dev.type != "cuda",
            f"{name} launched with 32 heads, a width its kernel does not "
            "take")


def check_r_biased_attention(cfg, attr, dev):
    """r_biased_attention kernel vs r_biased_attention_reference in fp32
    (its only type): the rollout's agent-agent call (B = 1, Q = K = A,
    Dr = HD = D, the flagship's a2a_0 projections) and a bipartite call
    (B = 2, Q = 40, K = 300: three key tiles of the TPU kernel), each
    without and with an attention-dropout multiplier. Timed at the
    rollout's shape without dropout."""
    from infgen_torch.ops import pallas_attention as PA

    check_rba_widths(dev)
    A, D, H = cfg.max_agents, cfg.hidden_dim, cfg.num_heads
    a2a = decoder_for(cfg, attr, F32, dev).a2a_attn_layers[0]
    w = (a2a.w_kr.detach(), a2a.w_vr.detach())
    shapes = {"rollout": (1, A, A, D, w), "bipartite": (2, 40, 300, D, None)}
    errs, means = {}, {}
    for name, (B, Q, K, Dr, ww) in shapes.items():
        for drop in (False, True):
            args = rba_inputs(np.random.default_rng(53), B, Q, K, Dr, D, H,
                              drop, dev, ww)
            with torch.no_grad():
                got = PA.r_biased_attention(*args[:7], H, args[7])
                ref = PA.r_biased_attention_reference(*args[:7], H, args[7])
            torch.cuda.synchronize()
            case = f"{name}{'/drop' if drop else ''}"
            errs[case], means[case] = _err(got, ref,
                                           f"r_biased_attention {case}")
            require(float(got.detach()[0, 3].abs().max()) == 0.0,
                    f"r_biased_attention {case}: a fully masked query is "
                    "not 0")
    args = rba_inputs(np.random.default_rng(59), 1, A, A, D, D, H, False,
                      dev, w)
    with torch.no_grad():
        ms = median_ms(lambda: PA.r_biased_attention(*args[:7], H),
                       KERNEL_LAUNCHES)
        plain_ms = median_ms(
            lambda: PA.r_biased_attention_reference(*args[:7], H),
            PLAIN_CALLS)
    nbytes, macs = rba_cost(args)
    least = rba_cost_least(args, H)[1]
    return {F32: finish("r_biased_attention", F32, errs, means, ms,
                        plain_ms, nbytes, 0, macs_f32=least,
                        bound_ms_direct=bound_of(nbytes, 0, macs, F32)[0],
                        operations_direct=2 * macs)}


# --------------------------------------------------------------------- #
# training
# --------------------------------------------------------------------- #

TRAIN_STEPS, TRAIN_WARMUP, TRAIN_SEEDS = 8, 2, (0, 1)
# one step's forward against backward with use_pallas_attention on and off
# (fp32, no dropout): both the port's paths, the same math in another order
TRAIN_PARITY_TOL = 1e-4
# gradients of the trainable function against autograd through the plain
# version: its backward is that recompute, so only the cotangent's path
# differs (none): held to fp32 summation order relative to each max |g|
GRAD_TOL = 1e-4


def train_eligible(cfg):
    """Sublayers of one scenario's training forward that reach
    r_biased_attention_trainable: per agent layer the temporal (T queries)
    and the agent-agent one (A + S), per seed layer the a2sa one (S seed
    queries), each where it has at least 8 queries (the JAX package's
    eligibility rule; pt2a, pt2sa, occ2sa, the refine pass's and the map
    encoder's calls are 4-D, share r or have one query). 15 at the
    flagship's 6 agent and 3 seed layers (T = 18, A + S = 138, S = 10)."""
    A, S, T = cfg.max_agents, cfg.num_seed_feature, cfg.num_token_steps
    return (cfg.num_agent_layers * ((T >= 8) + (A + S >= 8))
            + cfg.num_seed_layers * (S >= 8))


def train_step_counts(cfg, batch):
    """(r_biased_attention launches, backward calls) of one training step
    at `batch`: each eligible sublayer launches in the forward; those whose
    outputs reach a loss run the recompute backward, and under remat their
    forward again. The agent layers' reach the motion, state and occupancy
    losses; the seed layers' a2sa only the state and insertion heads
    (predict_state). The map pre-training config trains neither."""
    A, S, T = cfg.max_agents, cfg.num_seed_feature, cfg.num_token_steps
    agent = cfg.num_agent_layers * ((T >= 8) + (A + S >= 8))
    seed = cfg.num_seed_layers * (S >= 8)
    trained = (agent * (cfg.predict_motion or cfg.predict_state
                        or cfg.predict_occ)
               + seed * cfg.predict_state)
    launches = train_eligible(cfg) + (trained if cfg.remat_attention else 0)
    return batch * launches, batch * trained


def train_shapes(cfg):
    """(B, Q, K) of the training forward's calls of
    r_biased_attention_trainable: the temporal sublayers ([N, T, D], B = N
    = A + S, Q = K = T), the agent-agent ones ([T, N, D], B = T, Q = K = N)
    and the seed stack's a2sa ones (B = T, Q = S, K = A). The flagship's:
    (138, 18, 18), (18, 138, 138), (18, 10, 128), with Dr = HD = 128 and 8
    heads."""
    A, S, T = cfg.max_agents, cfg.num_seed_feature, cfg.num_token_steps
    return {"temporal": (A + S, T, T), "agent_agent": (T, A + S, A + S),
            "a2sa": (T, S, A)}


def check_trainable_grad(cfg, dev):
    """r_biased_attention_trainable at each training shape in fp32, without
    and with a dropout multiplier (numpy-seeded inputs, rba_inputs: a
    fully masked query row included): its forward (the kernel) against
    r_biased_attention_reference, its six gradients against autograd
    through r_biased_attention_reference on the card, a fully masked
    query's output and dq exactly 0. Times per shape (without dropout): the
    kernel's forward beside its bound (rba_cost_least), the plain forward,
    and the backward (the recompute) beside its bound (rba_backward_cost),
    each a median of CUDA-event times. Returns {shape: readings}."""
    from infgen_torch.ops import pallas_attention as PA

    D, H = cfg.hidden_dim, cfg.num_heads
    out = {}
    for name, (B, Q, K) in train_shapes(cfg).items():
        errs, grad_errs = {}, {}
        for drop in (False, True):
            args = rba_inputs(np.random.default_rng(71 + Q + drop), B, Q, K,
                              D, D, H, drop, dev)
            leaves = [a.clone().requires_grad_() for a in args[:6]]
            got = PA.r_biased_attention_trainable(*leaves, args[6], H,
                                                  args[7])
            g = torch.randn(got.shape, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(Q))
            grads = torch.autograd.grad(got, leaves, g)
            ref_leaves = [a.clone().requires_grad_() for a in args[:6]]
            ref = PA.r_biased_attention_reference(*ref_leaves, args[6], H,
                                                  args[7])
            ref_grads = torch.autograd.grad(ref, ref_leaves, g)
            torch.cuda.synchronize()
            case = f"{name}{'/drop' if drop else ''}"
            errs[case] = _err(got.detach(), ref.detach(),
                              f"trainable {case}")[0]
            grad_errs[case] = max(
                float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                for a, b in zip(grads, ref_grads))
            require(float(got.detach()[0, 3].abs().max()) == 0.0
                    and float(grads[0][0, 3].abs().max()) == 0.0,
                    f"trainable {case}: a fully masked query's output or dq "
                    "is not 0")
        args = rba_inputs(np.random.default_rng(79 + Q), B, Q, K, D, D, H,
                          False, dev)
        with torch.no_grad():
            ms = median_ms(lambda: PA.r_biased_attention(*args[:7], H),
                           KERNEL_LAUNCHES)
            plain_ms = median_ms(
                lambda: PA.r_biased_attention_reference(*args[:7], H),
                PLAIN_CALLS)
        leaves = [a.clone().requires_grad_() for a in args[:6]]
        got = PA.r_biased_attention_trainable(*leaves, args[6], H)
        g = torch.ones_like(got)
        bwd_ms = median_ms(lambda: torch.autograd.grad(
            got, leaves, g, retain_graph=True), PLAIN_CALLS)
        nbytes, macs = rba_cost_least(args, H)
        bound_ms, bound_by = bound_of(nbytes, 0, macs, F32)
        bwd_bytes, bwd_macs = rba_backward_cost(args, H)
        bwd_bound_ms, bwd_bound_by = bound_of(bwd_bytes, 0, bwd_macs, F32)
        out[name] = dict(B=B, Q=Q, K=K, max_abs_err=max(errs.values()),
                         errors=errs, grad_rel_errors=grad_errs, ms=ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         plain_ms=plain_ms, backward_ms=bwd_ms,
                         backward_bound_ms=bwd_bound_ms,
                         backward_bound_by=bwd_bound_by,
                         backward_bytes=bwd_bytes,
                         backward_operations=2 * bwd_macs)
    emit("trainable_grad", shapes=out, tolerance=TOL["r_biased_attention"][
        F32], grad_tolerance=GRAD_TOL, backward="plain recompute, as "
         "_rba_bwd")
    for name, r in out.items():
        require(r["max_abs_err"] <= TOL["r_biased_attention"][F32]
                and max(r["grad_rel_errors"].values()) <= GRAD_TOL,
                f"trainable at {name}: forward {r['errors']} or gradients "
                f"{r['grad_rel_errors']} off")
    return out


def check_train(dev, path=FLAGSHIP):
    """The training main path: the config at `path` (the flagship) with
    use_pallas_attention (the command line's train --pallas-attention), at
    full width, bf16 policy, dropout on, remat on, weights from
    init_params with cfg.seed, TRAIN_STEPS steps of Trainer.train_step on
    one batch of the synthetic scenarios TRAIN_SEEDS, a seeded generator.
    Every count is set to 0 just before the steps and read after each:
    per step r_biased_attention launches its kernel for each eligible
    sublayer of each scenario's forward and again in the remat recompute,
    and r_biased_attention_trainable's backward runs once per eligible
    call. Then, in fp32 without dropout on the same weights and batch, one
    step with use_pallas_attention against one without: loss and gradient
    norm within TRAIN_PARITY_TOL relative. Returns the readings."""
    from infgen_torch.cli import KERNELS
    from infgen_torch.config import load_config
    from infgen_torch.data.scenario import stack_scenarios, to_device
    from infgen_torch.ops import pallas_attention as PA
    from infgen_torch.train.loop import SyntheticDataset
    from infgen_torch.train.train_step import Trainer

    cfg = load_config(path).replace(use_pallas_attention=True)
    data = SyntheticDataset(cfg, size=len(TRAIN_SEEDS))
    batch = to_device(stack_scenarios([data[s] for s in TRAIN_SEEDS]), dev)
    per_fwd = train_eligible(cfg)
    launches_per_step = len(TRAIN_SEEDS) * per_fwd * (
        2 if cfg.remat_attention else 1)
    backward_per_step = len(TRAIN_SEEDS) * per_fwd

    trainer = Trainer(cfg, dev)
    trainer.init_state(torch.Generator().manual_seed(cfg.seed))
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in KERNELS.values():
        fn.launches = 0
    PA.r_biased_attention_trainable.backward_calls = 0
    losses, ms, launches, backward = [], [], [], []
    rba = KERNELS["r_biased_attention"]
    for _ in range(TRAIN_STEPS):
        n0 = rba.launches
        b0 = PA.r_biased_attention_trainable.backward_calls
        t0 = time.perf_counter()
        logs = trainer.train_step(batch, gen)
        losses.append(float(logs["loss"]))       # waits for the step
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(rba.launches - n0)
        backward.append(PA.r_biased_attention_trainable.backward_calls - b0)
    total_launches = {k: fn.launches for k, fn in KERNELS.items()}
    peak = torch.cuda.max_memory_allocated(dev)

    # fp32, no dropout: the kernel path against the plain one, one step
    parity = {}
    for pallas in (True, False):
        c = cfg.replace(compute_dtype="float32", dropout=0.0,
                        use_pallas_attention=pallas)
        tr = Trainer(c, dev)
        tr.init_state(torch.Generator().manual_seed(cfg.seed))
        lg = tr.train_step(batch, torch.Generator(device=dev).manual_seed(3))
        parity[pallas] = (float(lg["loss"]), float(lg["grad_norm"]))
        del tr
    gap = {k: abs(parity[True][i] - parity[False][i])
           / max(abs(parity[False][i]), 1e-30)
           for i, k in enumerate(("loss", "grad_norm"))}
    res = dict(
        config=os.path.relpath(path, ROOT), use_pallas_attention=True,
        width=dict(D=cfg.hidden_dim, agent_layers=cfg.num_agent_layers,
                   seed_layers=cfg.num_seed_layers, map_layers=cfg.num_map_layers,
                   A=cfg.max_agents, P=cfg.max_map_tokens, S=cfg.num_seed_feature),
        compute_dtype=cfg.compute_dtype, dropout=cfg.dropout,
        remat_attention=cfg.remat_attention, batch=len(TRAIN_SEEDS),
        steps=TRAIN_STEPS, losses=losses, ms_per_step=ms,
        ms_per_step_median=float(np.median(ms[TRAIN_WARMUP:])),
        max_memory_allocated=peak, eligible_per_forward=per_fwd,
        launches_per_step=launches, expected_launches_per_step=(
            launches_per_step), backward_calls_per_step=backward,
        expected_backward_calls_per_step=backward_per_step,
        launches=total_launches,
        fp32_parity=dict(pallas=parity[True], plain=parity[False],
                         relative_gap=gap, tolerance=TRAIN_PARITY_TOL))
    emit("train", **res)
    require(all(np.isfinite(losses)), f"train: non-finite loss {losses}")
    require(losses[-1] < losses[0], f"train: the loss did not fall {losses}")
    require(all(n == launches_per_step for n in launches),
            f"train: r_biased_attention launched {launches} times per step, "
            f"not {launches_per_step}")
    require(all(n == backward_per_step for n in backward),
            f"train: {backward} backward calls per step, not "
            f"{backward_per_step}")
    require(max(gap.values()) <= TRAIN_PARITY_TOL,
            f"train: the kernel path and the plain path differ by {gap}")
    return res


# --------------------------------------------------------------------- #
# every experiment config, open-loop validation, input checks, warm starts
# --------------------------------------------------------------------- #

CONFIG_DIR = os.path.join(ROOT, "configs")
CONFIG_STEPS = 2
OCC_CONFIG = "ours_standard_decode_occ.yaml"
# the occupancy step card against CPU, fp32, TF32 off: loss, logs and
# grad_norm relative, summation order only
OCC_PARITY_TOL = 1e-4
OPEN_LOOP_SCENARIOS, OPEN_LOOP_PARITY = 8, 2
# open_loop's fp32 card against CPU: each mean log relative (fp32 sums of
# the two forwards in another order); a top-1 decision may differ only
# where the CPU's two best logits lie within NEAR_TIE and the card chose
# the other of them (PARITY.md's certified flip)
OPEN_LOOP_TOL = 1e-4
NEAR_TIE = 5e-3
CHECK_INPUTS_SCENARIOS = 8
WARM_START_DIR = os.path.join(ROOT, "build", "warm_start")


def config_files():
    """Every YAML under configs/, recursively, sorted."""
    return sorted(os.path.join(d, f) for d, _, fs in os.walk(CONFIG_DIR)
                  for f in fs if f.endswith(".yaml"))


def _zero_counts():
    from infgen_torch.cli import KERNELS
    from infgen_torch.ops import pallas_attention as PA

    for fn in KERNELS.values():
        fn.launches = 0
    PA.r_biased_attention_trainable.backward_calls = 0


def _batch(cfg, dev):
    from infgen_torch.data.scenario import stack_scenarios, to_device
    from infgen_torch.train.loop import SyntheticDataset

    data = SyntheticDataset(cfg, size=len(TRAIN_SEEDS))
    return to_device(stack_scenarios([data[s] for s in TRAIN_SEEDS]), dev)


def check_occ_parity(path, dev):
    """One Trainer step of the occupancy config at full width, fp32, on the
    card and on the CPU from the same weights (init_params from cfg.seed)
    and draws (numpy-seeded selections and map uniforms): loss, logs and
    grad_norm within OCC_PARITY_TOL; the largest per-parameter gradient gap
    relative to that parameter's max |g| is reported."""
    from infgen_torch.config import load_config
    from infgen_torch.model.occ_decoder import AGENT_LIMIT, PT_LIMIT
    from infgen_torch.train.train_step import Trainer

    cfg = load_config(path).replace(compute_dtype="float32")
    rng = np.random.default_rng(31)
    A, P = cfg.max_agents, cfg.max_map_tokens
    draws = [dict(sel_a=rng.permutation(A)[:AGENT_LIMIT],
                  sel_p=rng.permutation(P)[:PT_LIMIT],
                  pt_uniform=rng.uniform(size=P).astype(np.float32))
             for _ in TRAIN_SEEDS]
    logs, grads = {}, {}
    for key, d in (("card", dev), ("cpu", torch.device("cpu"))):
        tr = Trainer(cfg, d)
        tr.init_state(torch.Generator().manual_seed(cfg.seed))
        lg = tr.train_step(_batch(cfg, d), draws=[
            {k: torch.as_tensor(v, device=d) for k, v in dr.items()}
            for dr in draws])
        logs[key] = {k: float(v) for k, v in lg.items()}
        grads[key] = {n: p.grad.detach().cpu()
                      for n, p in tr.model.named_parameters()}
        del tr
    gap = {k: abs(logs["card"][k] - v) / max(abs(v), 1e-30)
           for k, v in logs["cpu"].items()}
    grad_gap = max(float((grads["card"][n] - g).abs().max()
                         / g.abs().max().clamp_min(1e-30))
                   for n, g in grads["cpu"].items())
    return dict(card=logs["card"], cpu=logs["cpu"], relative_gap=gap,
                max_grad_gap=grad_gap, tolerance=OCC_PARITY_TOL)


def check_train_configs(dev):
    """Every YAML under configs/ at its own full width on the card: the
    Trainer built and initialised (init_params from cfg.seed), then
    CONFIG_STEPS steps at batch 2 (synthetic seeds TRAIN_SEEDS) with the
    agent decoder's configs under use_pallas_attention. Each config's
    counts are set to 0 before its steps and read after each: per step
    r_biased_attention launches and its trainable form's recompute backward
    runs exactly as train_step_counts says (the flagship: 2 (remat) x 15 x
    batch launches, 15 x batch backward calls); no other kernel launches;
    the occupancy decoder launches none. Per config: init ms, ms and loss and grad_norm per
    step, peak memory. Then check_occ_parity. Returns the launches and
    backward calls summed over the configs."""
    from infgen_torch.cli import KERNELS
    from infgen_torch.config import load_config
    from infgen_torch.ops import pallas_attention as PA
    from infgen_torch.train.train_step import Trainer

    rba = KERNELS["r_biased_attention"]
    rows, totals = {}, dict(launches=0, backward_calls=0)
    for path in config_files():
        name = os.path.relpath(path, CONFIG_DIR)
        cfg = load_config(path)
        occ = cfg.decoder_type == "occ_decoder"
        if not occ:
            cfg = cfg.replace(use_pallas_attention=True)
        want, want_bwd = (0, 0) if occ else train_step_counts(
            cfg, len(TRAIN_SEEDS))
        batch = _batch(cfg, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer = Trainer(cfg, dev)
        trainer.init_state(torch.Generator().manual_seed(cfg.seed))
        torch.cuda.synchronize()
        init_ms = (time.perf_counter() - t0) * 1e3
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        _zero_counts()
        steps = []
        for _ in range(CONFIG_STEPS):
            n0 = rba.launches
            b0 = PA.r_biased_attention_trainable.backward_calls
            t0 = time.perf_counter()
            logs = {k: float(v) for k, v in
                    trainer.train_step(batch, gen).items()}   # waits
            torch.cuda.synchronize()
            steps.append(dict(
                ms=(time.perf_counter() - t0) * 1e3, loss=logs["loss"],
                grad_norm=logs["grad_norm"], launches=rba.launches - n0,
                backward_calls=(PA.r_biased_attention_trainable.backward_calls
                                - b0)))
        others = {k: fn.launches for k, fn in KERNELS.items()
                  if fn is not rba and fn.launches}
        rows[name] = dict(
            decoder=cfg.decoder_type, D=cfg.hidden_dim,
            agent_layers=cfg.num_agent_layers,
            seed_layers=cfg.num_seed_layers, map_layers=cfg.num_map_layers,
            A=cfg.max_agents, P=cfg.max_map_tokens,
            compute_dtype=cfg.compute_dtype, param_dtype=cfg.param_dtype,
            remat=cfg.remat_attention, use_pallas_attention=not occ,
            parameters=sum(p.numel() for p in trainer.model.parameters()),
            init_ms=init_ms, steps=steps,
            max_memory_allocated=torch.cuda.max_memory_allocated(dev),
            expected_launches_per_step=want,
            expected_backward_calls_per_step=want_bwd, other_launches=others)
        totals["launches"] += sum(s["launches"] for s in steps)
        totals["backward_calls"] += sum(s["backward_calls"] for s in steps)
        del trainer, batch
        torch.cuda.empty_cache()
        require(all(np.isfinite([s["loss"], s["grad_norm"]]).all()
                    for s in steps), f"train_configs {name}: {steps}")
        require(all(s["launches"] == want and s["backward_calls"] == want_bwd
                    for s in steps) and not others,
                f"train_configs {name}: launches {steps}, others {others}, "
                f"not {want} / {want_bwd} per step")
    occ = check_occ_parity(os.path.join(CONFIG_DIR, OCC_CONFIG), dev)
    emit("train_configs", configs=rows, batch=len(TRAIN_SEEDS),
         steps=CONFIG_STEPS, launches=totals, occ_parity=occ)
    require(len(rows) == 13, f"train_configs: {len(rows)} configs, not 13")
    require(max(occ["relative_gap"].values()) <= OCC_PARITY_TOL,
            f"train_configs: the occupancy step card against CPU {occ}")
    return totals


def _top1_decisions(trainer, scen, draws):
    """The open-loop accuracy forward's (loop.accuracy_forward) evaluation
    masks, and the two best logits' indices and gap per cell (numpy)."""
    from infgen_torch.train.loop import accuracy_forward

    with torch.no_grad():
        logits, _, masks = accuracy_forward(trainer, scen, None, draws)
        out = {}
        for name in ("token", "state"):
            top = logits[name].float().topk(2, -1)
            out[name] = dict(
                mask=masks[name].cpu().numpy(),
                top2=top.indices.cpu().numpy(),
                gap=(top.values[..., 0] - top.values[..., 1]).cpu().numpy())
    return out


def certify_flips(card, cpu):
    """Cells whose top-1 choice differs card to CPU: (count, certified),
    certified when each lies within NEAR_TIE on the CPU and the card chose
    the CPU's second best."""
    n, ok = 0, True
    for name in ("token", "state"):
        c, g = card[name], cpu[name]
        m = c["mask"] & g["mask"]
        diff = m & (c["top2"][..., 0] != g["top2"][..., 0])
        n += int(diff.sum())
        ok &= bool((g["gap"][diff] < NEAR_TIE).all()
                   and (c["top2"][..., 0][diff] == g["top2"][..., 1][diff])
                   .all())
    return n, ok


def check_open_loop(dev):
    """validate_open_loop of the flagship with use_pallas_attention at full
    width, bf16, on OPEN_LOOP_SCENARIOS synthetic scenarios (weights from
    cfg.seed): ms per scenario (host clock to the read), peak memory and,
    counts set to 0 just before, r_biased_attention's launches, exactly 2
    forwards x train_eligible per scenario (no remat without gradients).
    Then OPEN_LOOP_PARITY scenarios in fp32 on the card and the CPU from the
    same weights and draws (numpy-seeded): every mean log within
    OPEN_LOOP_TOL relative, token and state accuracy equal or apart only by
    certified flips (certify_flips on the accuracy forward's decisions).
    Returns the launches."""
    from infgen_torch.cli import KERNELS
    from infgen_torch.config import load_config
    from infgen_torch.data.scenario import to_device
    from infgen_torch.train.loop import SyntheticDataset, validate_open_loop
    from infgen_torch.train.train_step import Trainer

    quiet = lambda msg: None
    cfg = load_config(FLAGSHIP).replace(use_pallas_attention=True)
    data = SyntheticDataset(cfg, size=OPEN_LOOP_SCENARIOS)
    trainer = Trainer(cfg, dev)
    trainer.init_state(torch.Generator().manual_seed(cfg.seed))
    validate_open_loop(trainer, data, 1, quiet)                 # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    out = validate_open_loop(trainer, data, OPEN_LOOP_SCENARIOS, quiet)
    ms = (time.perf_counter() - t0) * 1e3 / OPEN_LOOP_SCENARIOS
    launches = KERNELS["r_biased_attention"].launches
    peak = torch.cuda.max_memory_allocated(dev)
    want = 2 * train_eligible(cfg) * OPEN_LOOP_SCENARIOS
    del trainer

    c32 = cfg.replace(compute_dtype="float32")
    rng = np.random.default_rng(41)
    A, T, P = c32.max_agents, c32.num_token_steps, c32.max_map_tokens
    draw = lambda: dict(pt_uniform=rng.uniform(size=P),
                        sa_uniform=rng.uniform(size=(A, T)))
    draws = [dict(loss=draw(), accuracy=draw())
             for _ in range(OPEN_LOOP_PARITY)]
    res, decisions = {}, {}
    for key, d in (("card", dev), ("cpu", torch.device("cpu"))):
        on = lambda x: torch.as_tensor(x, dtype=torch.float32, device=d)
        dd = [{k: {n: on(v) for n, v in part.items()}
               for k, part in per.items()} for per in draws]
        tr = Trainer(c32, d)
        tr.init_state(torch.Generator().manual_seed(cfg.seed))
        res[key] = validate_open_loop(tr, data, OPEN_LOOP_PARITY, quiet, dd)
        tr.model.eval()
        decisions[key] = [_top1_decisions(tr, to_device(data[i], d),
                                             dd[i]["accuracy"])
                             for i in range(OPEN_LOOP_PARITY)]
        del tr
    gap = {k: abs(res["card"][k] - v) / max(abs(v), 1e-30)
           for k, v in res["cpu"].items() if not k.endswith("_accuracy")}
    flips = [certify_flips(c, g) for c, g in zip(decisions["card"],
                                                 decisions["cpu"])]
    n_flips = sum(n for n, _ in flips)
    emit("open_loop", config=os.path.relpath(FLAGSHIP, ROOT),
         use_pallas_attention=True, compute_dtype=cfg.compute_dtype,
         scenarios=OPEN_LOOP_SCENARIOS, results=out, ms_per_scenario=ms,
         max_memory_allocated=peak, launches=launches,
         launches_per_scenario=launches / OPEN_LOOP_SCENARIOS,
         expected_launches=want,
         fp32_parity=dict(scenarios=OPEN_LOOP_PARITY, card=res["card"],
                          cpu=res["cpu"], relative_gap=gap,
                          tolerance=OPEN_LOOP_TOL, flips=n_flips,
                          near_tie=NEAR_TIE))
    require(all(np.isfinite(v) for v in out.values()),
            f"open_loop: non-finite results {out}")
    require(launches == want, f"open_loop: r_biased_attention launched "
            f"{launches} times, not {want}")
    require(max(gap.values()) <= OPEN_LOOP_TOL,
            f"open_loop: card and CPU logs differ by {gap}")
    require(all(ok for _, ok in flips), f"open_loop: uncertified top-1 "
            f"flips between card and CPU {flips}")
    require(n_flips > 0 or all(
        res["card"][k] == res["cpu"][k]
        for k in ("token_accuracy", "state_accuracy")),
        f"open_loop: accuracies differ without a flip {res}")
    return launches


def check_check_inputs(dev):
    """check_inputs of the flagship config on CHECK_INPUTS_SCENARIOS
    synthetic scenarios on the card and on the CPU: every count equal;
    ms on the card."""
    from infgen_torch.config import load_config
    from infgen_torch.train.loop import SyntheticDataset, check_inputs

    cfg = load_config(FLAGSHIP)
    data = SyntheticDataset(cfg, size=CHECK_INPUTS_SCENARIOS)
    quiet = lambda msg: None
    check_inputs(cfg, data, 1, quiet, dev)                      # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = check_inputs(cfg, data, CHECK_INPUTS_SCENARIOS, quiet, dev)
    ms = (time.perf_counter() - t0) * 1e3
    cpu = check_inputs(cfg, data, CHECK_INPUTS_SCENARIOS, quiet, "cpu")
    equal = card[0] == cpu[0] and all(
        np.array_equal(card[1][k], cpu[1][k]) for k in cpu[1])
    emit("check_inputs", config=os.path.relpath(FLAGSHIP, ROOT),
         scenarios=CHECK_INPUTS_SCENARIOS, state_accuracy=card[0],
         grid_overlap={k: int(v.sum()) for k, v in card[1].items()},
         ms=ms, equal_to_cpu=equal)
    require(equal, f"check_inputs: card {card} against CPU {cpu}")


def check_warm_start(dev):
    """The port's own checkpoints on the card: `cli.run_train` trains the
    flagship (use_pallas_attention) for 2 steps at batch 2 into
    WARM_START_DIR/ckpt; `cli rollout --ckpt-path` rolls out from it
    (PARITY_FRAMES frames, forced insertion, counts set to 0 just before:
    seed_eval launches), and the same rollout of a model that took the
    trainer's in-memory weights must make the same decisions; then
    ours_standard.yaml warm-starts from the checkpoint (`--pretrain-ckpt`)
    for one step, and the tensors it kept from its own init are counted.
    Returns seed_eval's launches in the command line's rollout."""
    import contextlib
    import io
    import shutil

    from infgen_torch import cli
    from infgen_torch.config import load_config

    shutil.rmtree(WARM_START_DIR, ignore_errors=True)
    quiet = lambda msg: None
    cfg = load_config(FLAGSHIP).replace(use_pallas_attention=True)
    trainer, train_summary = cli.run_train(cfg, dev, steps=2, batch=2,
                                           save_dir=WARM_START_DIR,
                                           log_fn=quiet)
    ckpt = os.path.join(WARM_START_DIR, "ckpt")
    _zero_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["rollout", "--synthetic", "--config", FLAGSHIP,
                  "--device", dev.type, "--ckpt-path", ckpt,
                  "--num-recurrent-steps",
                  str(PARITY_FRAMES), "--force-insert"])
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    launches = cli.kernel_launches()["seed_eval"]

    roll = load_config(FLAGSHIP)
    tok = cli.build_tokenizers(roll)
    in_memory = cli.build_model(roll, tok[0], dev)
    in_memory.load_state_dict(trainer.model.state_dict())
    del trainer
    outs = {}
    for name, model in (("checkpoint", cli.build_model(roll, tok[0], dev,
                                                       ckpt_path=ckpt)),
                        ("in_memory", in_memory)):
        out, _ = cli.run_rollouts(roll, dev, 1, True, None, PARITY_FRAMES,
                                  model=model, tokenizers=tok)
        outs[name] = {k: v.detach().cpu().numpy() for k, v in out[0].items()}
    a, b = outs["checkpoint"], outs["in_memory"]
    mismatched = [k for k in PARITY_EXACT if not np.array_equal(a[k], b[k])]
    pose_gap = max(float(np.abs(a[k] - b[k]).max()) for k in PARITY_CLOSE)

    lines = []
    std = load_config(os.path.join(CONFIG_DIR, "ours_standard.yaml"))
    _, std_summary = cli.run_train(std, dev, steps=1, batch=2,
                                   log_fn=lines.append, pretrain_ckpt=ckpt)
    warm = [json.loads(x) for x in lines if x.startswith('{"warm_started"')]
    from infgen_torch.train.train_step import Trainer
    n_tensors = len(Trainer(std, "cpu").model.state_dict())
    shutil.rmtree(WARM_START_DIR, ignore_errors=True)
    emit("warm_start", config=os.path.relpath(FLAGSHIP, ROOT),
         train=dict(steps=train_summary["steps"],
                    last_loss=train_summary["last_loss"],
                    ms_per_step=train_summary["ms_per_step"],
                    r_biased_attention=train_summary["kernel_launches"][
                        "r_biased_attention"]),
         rollout_frames=PARITY_FRAMES, cli_rollout=dict(
             agents_inserted=line["agents_inserted"],
             ms_per_token_step=line["ms_per_token_step"],
             kernel_launches=line["kernel_launches"]),
         seed_eval_launches=launches, decisions_mismatched=mismatched,
         max_pose_gap=pose_gap,
         standard_warm_start=dict(
             kept=warm[0]["kept"] if warm else None, tensors=n_tensors,
             first_loss=std_summary["first_loss"]))
    require(launches > 0, "warm_start: the rollout from the checkpoint "
            "launched no seed_eval")
    require(not mismatched, f"warm_start: the checkpoint's rollout and the "
            f"in-memory weights' differ in {mismatched}")
    require(bool(warm) and np.isfinite(std_summary["first_loss"]),
            f"warm_start: ours_standard.yaml did not warm-start {lines[:3]}")
    return launches


LEARNING_SCENARIOS = 2   # synthetic 48-agent scenarios (seeds 0, 1)
LEARNING_STEPS = 4
LEARNING_FRAMES = 150


def check_learning(dev):
    """The learning-dynamics path (validate_learning.learning_dynamics) at
    the flagship's full width on the card: LEARNING_SCENARIOS scenarios,
    LEARNING_STEPS train steps at batch 2, scored before and after at
    LEARNING_FRAMES frames (production beams, bf16, seed_eval), every
    count set to 0 just before and read just after: finite losses and
    metametrics, seed_eval launched in the scorings (and only there).
    Returns seed_eval's launches."""
    from infgen_torch.cli import kernel_launches
    from infgen_torch.config import load_config
    from infgen_torch.validate_learning import learning_dynamics

    cfg = load_config(FLAGSHIP).replace(
        num_recurrent_steps_val=LEARNING_FRAMES)
    _zero_counts()
    t0 = time.perf_counter()
    res = learning_dynamics(cfg, dev, LEARNING_STEPS, LEARNING_SCENARIOS,
                            out=None, log_fn=lambda msg: None)
    seconds = time.perf_counter() - t0
    launches = kernel_launches()
    emit("learning", config=os.path.relpath(FLAGSHIP, ROOT),
         scenarios=LEARNING_SCENARIOS, steps=LEARNING_STEPS,
         frames=LEARNING_FRAMES, seconds=seconds,
         ms_per_train_step=res["ms_per_train_step"],
         ms_scoring=res["ms_scoring"],
         seed_eval_launches=res["seed_eval_launches"],
         kernel_launches=launches, losses=res["losses"],
         before=res["before"], after=res["after"],
         gt_replay=[res["gt_replay_metametric"],
                    res["gt_replay_collision_rate"]], device=res["device"])
    require(np.isfinite(res["losses"]).all(),
            f"learning: a loss is not finite {res['losses']}")
    require(all(np.isfinite(r["metametric"]) for r in res["curve"]),
            f"learning: a metametric is not finite {res['curve']}")
    require(res["seed_eval_launches"] > 0,
            "learning: the scorings launched no seed_eval")
    require(launches["seed_eval"] == res["seed_eval_launches"],
            f"learning: seed_eval launched outside the scorings {launches}")
    return res["seed_eval_launches"]


# --------------------------------------------------------------------- #
# the WOMD input pipeline
# --------------------------------------------------------------------- #

WOMD_DIR = os.path.join(ROOT, "build", "womd")
WOMD_SEED = 14
WOMD_FILES, WOMD_PER_FILE = 2, 4
WOMD_AGENTS = (60, 120)      # vehicle / pedestrian / cyclist tracks
WOMD_MAP_M = 6000.0          # > 1,024 x 5 m of polyline: P = 1024 truncates
WOMD_FILTERED = 132          # one more scenario, >= buffer_size: dropped
WOMD_FRAMES = 150            # rollouts and validation (30 token steps)
WOMD_TRAIN_WORKERS = 2


def _cli_line(argv):
    """cli.main(argv) with its printed lines kept apart: its last line,
    parsed."""
    import contextlib
    import io

    from infgen_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def numpy_split_token_gap(data):
    """Token ids of one pickle's map split by the numpy splitter against
    the cached ones (the native splitter's): (ids that differ, tokens)."""
    from infgen_torch.data import preprocess
    from infgen_torch.tokenizers import map_tokenizer as MT

    native_split = MT.interpolate_polyline
    MT.interpolate_polyline = lambda *a, **k: native_split(
        *a, **{**k, "use_native": False})
    try:
        ids = preprocess.tokenize_pkl_map(data, MT.MapTokenizer())["token_idx"]
    finally:
        MT.interpolate_polyline = native_split
    cached = np.asarray(data["map_token"]["token_idx"])
    if ids.shape != cached.shape:
        return max(len(ids), len(cached)), len(cached)
    return int((ids != cached).sum()), len(cached)


def check_womd(dev, smi):
    """The port's WOMD input pipeline at the flagship's full width. A numpy
    generator seeded WOMD_SEED writes WOMD_FILES tfrecord files of
    WOMD_PER_FILE scenarios (data/womd_synthetic.py: 91 steps, WOMD_AGENTS
    tracks with invalid gaps, three "other" tracks, lights, a map of more
    than WOMD_MAP_M metres) and one more of WOMD_FILTERED agents; they are
    preprocessed with two spawned workers (data/preprocess.py) and loaded
    by WaymoDataset, whose meta filter drops that one. Then, counts set to
    0 before each: `cli rollout --data-dir` one scenario at a time and
    with `--batch 8` (agent-steps/s per agent bucket, seed_eval launched),
    `cli train --data-dir --pallas-attention` for 2 steps at batch 2 fed
    by WOMD_TRAIN_WORKERS spawned loader workers (ms per step, the input
    wait's share, r_biased_attention launched), `cli validate --data-dir`
    on one scenario at production beams, and a parity rollout of one
    preprocessed scenario at parity_config (card kernels against the CPU's
    plain versions). The numpy splitter's token ids are counted against
    the native ones on every map. Returns the launches of seed_eval and
    r_biased_attention in the phase."""
    import pickle
    import shutil
    import tempfile

    from infgen_torch import cli
    from infgen_torch.config import load_config
    from infgen_torch.data import preprocess, womd_synthetic
    from infgen_torch.data.waymo import WaymoDataset

    shutil.rmtree(WOMD_DIR, ignore_errors=True)
    raw, pkl = os.path.join(WOMD_DIR, "raw"), os.path.join(WOMD_DIR, "pkl")
    t0 = time.perf_counter()
    womd_synthetic.write_womd_files(
        raw, WOMD_SEED, WOMD_FILES, WOMD_PER_FILE, WOMD_AGENTS, WOMD_MAP_M,
        extra_agents=(WOMD_FILTERED,))
    write_s = time.perf_counter() - t0
    written = WOMD_FILES * WOMD_PER_FILE + 1
    t0 = time.perf_counter()
    meta = preprocess.main(["--input-dir", raw, "--output-dir", pkl,
                            "--num-workers", "2"])
    preprocess_ms = (time.perf_counter() - t0) * 1e3 / written
    require(len(meta) == written, f"womd: preprocessed {len(meta)} of "
            f"{written} scenarios")
    agents, tokens, split_gap = {}, {}, [0, 0]
    for sid in sorted(meta):
        with open(os.path.join(pkl, f"{sid}.pkl"), "rb") as f:
            data = pickle.load(f)
        agents[sid] = int(data["agent"]["num_nodes"])
        tokens[sid] = int(len(data["map_token"]["token_idx"]))
        gap = numpy_split_token_gap(data)
        split_gap = [split_gap[0] + gap[0], split_gap[1] + gap[1]]

    cfg = load_config(FLAGSHIP)
    ds = WaymoDataset(pkl, cfg, training=False)
    t0 = time.perf_counter()
    scens = [ds[i] for i in range(len(ds))]
    load_ms = (time.perf_counter() - t0) * 1e3 / len(ds)
    kept = [f.split(".")[0] for f in ds.files]
    dropped = sorted(set(meta) - set(kept))
    require(len(kept) == written - 1 and
            [agents[s] for s in dropped] == [WOMD_FILTERED],
            f"womd: the meta filter kept {kept} (agents {agents})")
    require(all(tokens[s] > cfg.max_map_tokens for s in kept)
            and all(bool(s.map.mask.all()) for s in scens),
            "womd: a map did not fill P = max_map_tokens")

    common = ["--data-dir", pkl, "--config", FLAGSHIP, "--device", dev.type,
              "--num-recurrent-steps", str(WOMD_FRAMES)]
    _zero_counts()
    one = _cli_line(["rollout", *common, "--num-scenarios", "1"])
    _zero_counts()
    served = _cli_line(["rollout", *common, "--num-scenarios",
                        str(len(kept)), "--batch", "8"])
    for what, line in (("one lane", one), ("--batch 8", served)):
        require(line["kernel_launches"]["seed_eval"] > 0,
                f"womd: cli rollout ({what}) launched no seed_eval")

    _zero_counts()
    lines = []
    train_cfg = cfg.replace(use_pallas_attention=True,
                            num_workers=WOMD_TRAIN_WORKERS)
    torch.cuda.reset_peak_memory_stats()
    _, train = cli.run_train(train_cfg, dev, steps=2, batch=2,
                             log_fn=lines.append, data_dir=pkl)
    train_peak = torch.cuda.max_memory_allocated(dev)
    steps = [json.loads(x) for x in lines if x.startswith('{"step"')]
    require(len(steps) == 2 and all(np.isfinite(s["loss"]) for s in steps),
            f"womd: cli train gave {lines}")
    require(train["kernel_launches"]["r_biased_attention"] > 0,
            "womd: cli train launched no r_biased_attention")

    _zero_counts()
    with tempfile.TemporaryDirectory() as save:
        val, _ = cli.run_validate(cfg, dev, 1, save, log_fn=lambda m: None,
                                  num_recurrent_steps=WOMD_FRAMES,
                                  dataset=ds)
    require(val["scored"] == 1 and np.isfinite(val["realism_meta_metric"]),
            f"womd: cli validate scored {val['scored']}")

    check_parity(dev, "parity_womd", scen=WaymoDataset(
        pkl, parity_config(), training=False)[0])

    launches = {"seed_eval": (one["kernel_launches"]["seed_eval"]
                              + served["kernel_launches"]["seed_eval"]
                              + val["kernel_launches"]["seed_eval"]),
                "r_biased_attention":
                    train["kernel_launches"]["r_biased_attention"]}
    emit("womd", nvidia_smi=smi, config=os.path.relpath(FLAGSHIP, ROOT),
         seed=WOMD_SEED, scenarios_written=written, scenarios_kept=len(kept),
         dropped_by_meta_filter={s: agents[s] for s in dropped},
         agents_before_truncation=[agents[s] for s in kept],
         map_tokens_before_truncation=[tokens[s] for s in kept],
         max_agents=cfg.max_agents, max_map_tokens=cfg.max_map_tokens,
         write_s=write_s, preprocess_ms_per_scenario=preprocess_ms,
         load_ms_per_scenario=load_ms,
         numpy_split_token_ids_differing=split_gap[0],
         map_tokens_compared=split_gap[1],
         rollout_frames=WOMD_FRAMES,
         one_lane=dict(ms_per_token_step=one["ms_per_token_step"],
                       agents_inserted=one["agents_inserted"],
                       seed_eval=one["kernel_launches"]["seed_eval"]),
         served=dict(batches=served["batches"],
                     ms_per_batched_token_step=served[
                         "ms_per_batched_token_step"],
                     agent_steps_per_s=served["agent_steps_per_s"],
                     agent_steps_per_s_by_bucket={
                         A: b["agent_steps_per_s"]
                         for A, b in served["by_bucket"].items()},
                     agents_inserted=served["agents_inserted"],
                     seed_eval=served["kernel_launches"]["seed_eval"],
                     host_reads=served["host_reads"]),
         train=dict(workers=WOMD_TRAIN_WORKERS, batch=2,
                    ms_per_step=[s["ms"] for s in steps],
                    input_ms=[s["input_ms"] for s in steps],
                    input_share_step2=steps[1]["input_ms"] / steps[1]["ms"],
                    losses=[s["loss"] for s in steps],
                    r_biased_attention=train["kernel_launches"][
                        "r_biased_attention"],
                    max_memory_allocated=train_peak),
         validate=dict(n_rollouts=val["n_rollouts"],
                       motion_beam_size=cfg.motion_beam_size,
                       insert_beam_size=cfg.insert_beam_size,
                       ms_rollout=val["ms_rollout"],
                       ms_features=val["ms_features"],
                       ms_scoring=val["ms_scoring"],
                       realism_meta_metric=val["realism_meta_metric"],
                       seed_eval=val["kernel_launches"]["seed_eval"]),
         launches=launches)
    shutil.rmtree(WOMD_DIR, ignore_errors=True)
    return launches


# --------------------------------------------------------------------- #
# rollouts
# --------------------------------------------------------------------- #

def check_rollout(out, cfg, n_steps, A=None):
    """The invariants of the JAX package's rollout tests
    (tests/test_rollout.py): shapes, finite values, zero positions on
    invalid steps, the ego valid throughout, inactive slots inert, bounded
    token motion, consistent insertion counts. A: the agent slots of the
    rollout's bucket (default cfg.max_agents)."""
    from infgen_torch.config import INVALID_STATE, SHIFT

    A, R, Hs = A or cfg.max_agents, cfg.num_recurrent_steps_val, \
        cfg.num_historical_steps
    Ti = (R + Hs) // SHIFT
    o = {k: v.detach().cpu().numpy() for k, v in out.items()}
    require(o["pred_traj"].shape == (A, Hs + R, 2), "pred_traj shape")
    require(o["next_token_idx"].shape == (A, Ti), "next_token_idx shape")
    require(o["next_state_idx"].shape == (A, Ti), "next_state_idx shape")
    for k in ("pred_traj", "pred_head", "pos_a", "head_a"):
        require(np.isfinite(o[k]).all(), f"{k} not finite")
    state, pos, active = o["next_state_idx"], o["pos_a"], o["slot_active"]
    av = int(o["av_index"])
    require(np.all(pos[state == INVALID_STATE] == 0),
            "invalid steps must carry zero positions")
    require(np.all(state[av, 2:] == 1), "the ego must stay valid")
    require(np.all(state[~active] == INVALID_STATE) or active.all(),
            "inactive slots produced states")
    jump = np.linalg.norm(np.diff(pos[active][:, 2:], axis=1), axis=-1)
    pairs = (state[active][:, 2:-1] != 0) & (state[active][:, 3:] != 0)
    require(not pairs.any() or jump[pairs].max() < 40.0,
            "token motion left the vocabulary's range")
    per_step = o["per_step_inserted"]
    require(per_step.shape == (n_steps,), "per_step_inserted shape")
    require(per_step.sum() == int(o["n_inserted"]), "insert counts")
    require(per_step[0] == 0, "no insertion at t=0")
    require((per_step <= cfg.insert_limit).all(), "insert_limit exceeded")
    require(active.sum() <= A, "more active slots than slots")


PARITY_EXACT = ("next_token_idx", "next_state_idx", "slot_active",
                "n_inserted", "per_step_inserted", "grid_index", "pred_type",
                "valid_mask")
PARITY_CLOSE = ("pos_a", "head_a", "pred_traj", "pred_head", "pred_state",
                "pred_shape", "seed_probs")
PARITY_DESC = (f"A=16 P=128 D=32 L=3 fp32 beam 1 force_insert "
               f"{PARITY_FRAMES} frames")


def parity_config(**flags):
    """The parity phases' small config (tests/test_torch_rollout.py's)."""
    from infgen_torch.config import Config

    return Config(max_agents=16, max_map_tokens=128, num_agent_layers=3,
                  num_seed_layers=3, num_map_layers=1, hidden_dim=32,
                  num_heads=2, head_dim=16, num_freq_bands=8,
                  num_recurrent_steps_val=PARITY_FRAMES,
                  use_seed_kernel=True, compute_dtype="float32",
                  motion_beam_size=1, insert_beam_size=1, **flags)


# the parity phases: name -> kernel flags on top of the flagship's
PARITY_FLAGS = {
    "parity": {},
    "parity_latency": dict(use_seed_kernel_full=True, use_refine_kernel=True,
                           use_column_kernel=True),
    "parity_fused": dict(use_fused_block=True),
    "parity_pallas": dict(use_pallas_attention=True)}


def logged_extent(scen):
    """The largest |coordinate| (m) of a scenario's valid logged
    positions."""
    ag = scen.agents
    return float(np.abs(np.asarray(ag.position)[np.asarray(ag.valid)]).max())


def check_parity(dev, phase, scen=None):
    """A small rollout on the card (kernels in fp32) against the same
    rollout on the CPU (plain versions), both from one set of model inputs
    built on the CPU: beam 1 makes both deterministic, so token, state and
    insertion decisions must be equal and poses agree within POSE_TOL, on
    every row. The readings give each key's largest error, the largest
    position error of each token column and the scenario's logged_extent
    (the error grows with both, ROADMAP Queue 3), and, not held, the rows
    whose logged tokens differ when the card builds the inputs itself
    (its contour matching meets near ties, ROADMAP Queue 3). `phase`
    names the kernel flags (PARITY_FLAGS; a name not there: the
    flagship's); `scen` a scenario at parity_config's shapes (default:
    synthetic, 10 agents), which must insert agents unless it fills every
    slot."""
    from infgen_torch.cli import (KERNELS, build_model, build_tokenizers,
                                  kernel_launches)
    from infgen_torch.data.features import build_model_inputs
    from infgen_torch.data.scenario import to_device
    from infgen_torch.data.synthetic import make_synthetic_scenario
    from infgen_torch.rollout.closed_loop import make_rollout_fn

    flags = PARITY_FLAGS.get(phase, {})
    cfg = parity_config(**flags)
    attr, mt, mv = build_tokenizers(cfg)
    if scen is None:
        scen = make_synthetic_scenario(cfg, seed=2, num_agents=10)
    uniform = np.random.default_rng(5).uniform(size=cfg.max_map_tokens)

    def inputs_on(d):
        return build_model_inputs(
            cfg, mt, attr, to_device(scen, d),
            pt_uniform=torch.as_tensor(uniform, dtype=torch.float32,
                                       device=d))

    cpu_inputs = inputs_on("cpu")
    card_ids = inputs_on(dev).tokens.token_idx.cpu()
    outs = {}
    for fn in KERNELS.values():
        fn.launches = 0
    for d in ("cpu", dev):
        model = build_model(cfg, attr, d)
        fn = make_rollout_fn(model, cfg, attr, mt, mv, force_insert=True)
        out = fn(to_device(scen, d), to_device(cpu_inputs, d),
                 torch.Generator(device=d).manual_seed(0))
        outs[str(d)] = {k: v.detach().cpu().numpy() for k, v in out.items()}
    launches = kernel_launches()
    cpu, gpu = outs["cpu"], outs[str(dev)]
    mismatched = [k for k in PARITY_EXACT if not np.array_equal(cpu[k],
                                                                gpu[k])]
    err = {k: float(np.abs(cpu[k] - gpu[k]).max()) for k in PARITY_CLOSE}
    pose_err = max(err.values())
    differ = (card_ids != cpu_inputs.tokens.token_idx).any(1)
    emit(phase, config=PARITY_DESC,
         flags=flags, launches={k: n for k, n in launches.items() if n},
         agents=int(scen.agents.slot_mask.sum()),
         inserted=int(gpu["n_inserted"]), mismatched=mismatched,
         max_pose_err=pose_err, tolerance=POSE_TOL, max_err=err,
         pos_err_by_column=np.abs(cpu["pos_a"] - gpu["pos_a"]).max(
             axis=(0, 2)).tolist(),
         logged_extent=logged_extent(scen),
         card_input_rows_differing=torch.nonzero(differ).flatten().tolist())
    require(not mismatched, f"cuda and cpu rollouts differ in {mismatched}")
    require(pose_err <= POSE_TOL, f"pose error {pose_err} > {POSE_TOL}")
    require(int(gpu["n_inserted"]) > 0 or scen.agents.slot_mask.all(),
            "parity run inserted no agent")
    for flag, kernel in (("use_fused_block", "fused_attention_block"),
                         ("use_pallas_attention", "r_biased_attention")):
        require(not flags.get(flag) or launches[kernel] > 0,
                f"{phase}: {kernel} never launched")


# the kernel flags whose kernels take lanes since their lane forms: the JAX
# bench's INFGEN_BENCH_FUSED + _SEEDK_FULL + _REFK program
LANE_KERNEL_FLAGS = dict(use_fused_block=True, use_seed_kernel_full=True,
                         use_refine_kernel=True)
SERVING_PARITY_FLAGS = {"flagship": {},
                        "pallas_attention": dict(use_pallas_attention=True),
                        "lane_kernels": LANE_KERNEL_FLAGS,
                        "latency": PARITY_FLAGS["parity_latency"]}


def served_kernels(cfg):
    """The kernels a served rollout under config `cfg` must launch: its
    seed kernel and the kernels its flags pick (the column kernel takes
    precedence over the fused block)."""
    out = ["seed_eval_full" if cfg.use_seed_kernel_full else "seed_eval"]
    fused = cfg.use_fused_block and not cfg.use_column_kernel
    for on, kernel in ((cfg.use_refine_kernel, "refine"),
                       (cfg.use_column_kernel, "motion_column"),
                       (fused, "fused_attention_block"),
                       (cfg.use_pallas_attention, "r_biased_attention")):
        if on:
            out.append(kernel)
    return out


def check_parity_serving(dev):
    """Three scenarios with 10, 6 and 3 agents served as one batched
    rollout (RolloutServer.rollout_batch: one bucket, a batch of four
    lanes, the last one padding) at the parity phases' config, on the card
    (kernels in fp32) against the CPU (plain versions): decisions equal,
    poses within POSE_TOL, per scenario; with the flagship's flags, with
    use_pallas_attention, with the three kernels that took lanes first
    (LANE_KERNEL_FLAGS), and with the latency preset's three kernels
    (the column kernel's lane form among them). Each run's kernels
    (served_kernels) must have launched."""
    from infgen_torch.cli import (KERNELS, build_model, build_tokenizers,
                                  kernel_launches)
    from infgen_torch.data.synthetic import make_synthetic_scenario
    from infgen_torch.rollout.serving import RolloutServer

    runs = {}
    for name, flags in SERVING_PARITY_FLAGS.items():
        cfg = parity_config(**flags)
        tok = build_tokenizers(cfg)
        scens = [make_synthetic_scenario(cfg, seed=s, num_agents=n)
                 for s, n in ((2, 10), (3, 6), (4, 3))]
        for fn in KERNELS.values():
            fn.launches = 0
        outs, dispatch = {}, {}
        for d in ("cpu", dev):
            srv = RolloutServer(cfg, *tok, agent_buckets=(cfg.max_agents,),
                                agent_headroom=0, force_insert=True)
            res = srv.rollout_batch(build_model(cfg, tok[0], d), scens,
                                    [0, 1, 2])
            outs[str(d)] = [{k: v.detach().cpu().numpy() for k, v in
                             o.items()} for o in res]
            dispatch[str(d)] = srv.last_dispatch["batches"]
        launches = kernel_launches()
        mismatched, pose_err = [], 0.0
        for i, (c, g) in enumerate(zip(outs["cpu"], outs[str(dev)])):
            mismatched += [f"{i}:{k}" for k in PARITY_EXACT
                           if not np.array_equal(c[k], g[k])]
            pose_err = max([pose_err] + [float(np.abs(c[k] - g[k]).max())
                                         for k in PARITY_CLOSE])
        inserted = [int(o["n_inserted"]) for o in outs[str(dev)]]
        runs[name] = dict(flags=flags, batches=dispatch[str(dev)],
                          launches={k: n for k, n in launches.items() if n},
                          inserted=inserted, mismatched=mismatched,
                          max_pose_err=pose_err)
        require(dispatch[str(dev)] == [(16, 128, 4, 3)],
                f"parity_serving {name}: dispatch {dispatch[str(dev)]}")
        require(not mismatched, f"parity_serving {name}: cuda and cpu "
                f"differ in {mismatched}")
        require(pose_err <= POSE_TOL, f"parity_serving {name}: pose error "
                f"{pose_err} > {POSE_TOL}")
        require(all(n > 0 for n in inserted),
                f"parity_serving {name}: a scenario inserted no agent")
        for kernel in served_kernels(cfg):
            require(launches[kernel] > 0,
                    f"parity_serving {name}: {kernel} never launched")
    emit("parity_serving", config=PARITY_DESC, scenarios=3, lanes=4,
         tolerance=POSE_TOL, runs=runs)


def check_serving(dev, phase="serving", flags=None, path=FLAGSHIP):
    """The served main path: the config at `path` (the flagship,
    configs/ours_long_term.yaml, by default; with `flags` replaced on it)
    at full width, SERVING_FRAMES frames, serving SERVING_SCENARIOS
    synthetic scenarios through RolloutServer.rollout_batch (the command
    line's --batch), in batches of up to SERVING_SCENARIOS lanes and, on
    the same scenarios, one at a time; unforced (the seed head's "enter"
    logit shifted by ENTER_LOGIT_SHIFT) and forced, as run_preset drives
    its rollouts. Every kernel count is set to 0 just before each run and
    read just after; check_rollout holds every lane. The config's seed
    kernel (and its trunk kernel, the fused block or the column) must
    launch in every run,
    and every kernel of served_kernels in the batched runs together (the
    refine pass runs only where an agent is inserted). Returns each
    kernel's launches in the batched runs and the (A, P, lanes) of each
    batch they dispatched."""
    from infgen_torch.cli import (KERNELS, build_model, build_tokenizers,
                                  kernel_launches, run_batched)
    from infgen_torch.config import SHIFT, load_config

    flags = flags or {}
    cfg = load_config(path).replace(num_recurrent_steps_val=SERVING_FRAMES,
                                    **flags)
    n_steps = cfg.num_recurrent_steps_val // SHIFT
    every_run = [k for k in served_kernels(cfg) if k != "refine"]
    tokenizers = build_tokenizers(cfg)
    model = build_model(cfg, tokenizers[0], dev)
    with torch.no_grad():
        model.agent_decoder.seed_state_predict_head.Dense_1.bias[1] += \
            ENTER_LOGIT_SHIFT
    runs, lanes_launches, shapes = [], {}, set()
    for force in (False, True):
        for batch in (SERVING_SCENARIOS, 1):
            torch.cuda.reset_peak_memory_stats()
            for fn in KERNELS.values():
                fn.launches = 0
            outs, summary = run_batched(
                cfg, dev, SERVING_SCENARIOS, batch, force, model=model,
                tokenizers=tokenizers, agent_buckets=SERVING_BUCKETS)
            launches = kernel_launches()
            for o in outs:
                check_rollout(o, cfg, n_steps, A=o["pred_traj"].shape[0])
            for kernel in every_run:
                require(launches[kernel] > 0,
                        f"{phase} (force={force}, batch={batch}): {kernel} "
                        "never launched")
            if batch > 1:
                for k, n in launches.items():
                    lanes_launches[k] = lanes_launches.get(k, 0) + n
                shapes |= {(b["A"], b["P"], b["lanes"])
                           for b in summary["batches"]}
            runs.append(dict(
                {k: summary[k] for k in (
                    "force_insert", "batch", "batches", "wall_ms",
                    "ms_per_batched_token_step", "agent_steps",
                    "agent_steps_per_s", "agents_inserted", "host_reads")},
                kernel_launches={k: n for k, n in launches.items() if n},
                max_memory_allocated=torch.cuda.max_memory_allocated(dev)))
    by = {(r["force_insert"], r["batch"]): r for r in runs}
    require(sum(by[True, 1]["agents_inserted"])
            > sum(by[False, 1]["agents_inserted"]),
            f"{phase}: the unforced runs did not decline")
    missing = [k for k in served_kernels(cfg) if not lanes_launches[k]]
    require(not missing, f"{phase}: {missing} never launched at B = "
            f"{SERVING_SCENARIOS}")
    emit(phase, config=os.path.relpath(path, ROOT), flags=flags,
         scenarios=SERVING_SCENARIOS, agent_buckets=SERVING_BUCKETS,
         token_steps=n_steps, enter_logit_shift=ENTER_LOGIT_SHIFT,
         runs=runs, same_inserts_batched_and_single={
             f"{'forced' if f else 'unforced'}":
             by[f, SERVING_SCENARIOS]["agents_inserted"]
             == by[f, 1]["agents_inserted"] for f in (False, True)},
         agent_steps_per_s={
             f"{'forced' if f else 'unforced'}_B{b}":
             by[f, b]["agent_steps_per_s"]
             for f in (False, True) for b in (SERVING_SCENARIOS, 1)})
    return lanes_launches, sorted(shapes)


def run_preset(path, dev, **flags):
    """The main path of one config (with `flags` replaced on it, as the
    command line's --fused-block / --pallas-attention do): the command
    line's rollout function on the card at full width, without and with
    forced insertion. Every kernel count is set to 0 just before and read
    just after; each run's summary carries its own counts.

    The random seed state head asks to enter on every evaluation, which
    would make the unforced run repeat the forced one. So its "enter" logit
    is shifted by ENTER_LOGIT_SHIFT: the unforced run then takes the decline
    branch (the head says stop) at full width. The forced run's decisions
    do not read that head."""
    from infgen_torch.cli import (KERNELS, build_model, build_tokenizers,
                                  kernel_launches, run_rollouts)
    from infgen_torch.config import SHIFT, load_config

    cfg = load_config(path).replace(**flags)
    n_steps = cfg.num_recurrent_steps_val // SHIFT
    tokenizers = build_tokenizers(cfg)
    model = build_model(cfg, tokenizers[0], dev)
    with torch.no_grad():
        model.agent_decoder.seed_state_predict_head.Dense_1.bias[1] += \
            ENTER_LOGIT_SHIFT
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for fn in KERNELS.values():
        fn.launches = 0
    runs = []
    for force in (False, True):
        outs, summary = run_rollouts(cfg, dev, 1, force_insert=force,
                                     model=model, tokenizers=tokenizers)
        check_rollout(outs[0], cfg, n_steps)
        runs.append(summary)
    launches = kernel_launches()
    emit("rollout", config=os.path.relpath(path, ROOT), flags=flags,
         width=dict(D=cfg.hidden_dim, agent_layers=cfg.num_agent_layers,
                    seed_layers=cfg.num_seed_layers, A=cfg.max_agents,
                    P=cfg.max_map_tokens, frames=cfg.num_recurrent_steps_val),
         runs=[{k: s[k] for k in ("force_insert", "token_steps",
                                  "ms_per_token_step", "agents_inserted",
                                  "kernel_launches", "host_reads")}
               for s in runs],
         enter_logit_shift=ENTER_LOGIT_SHIFT,
         launches=launches, seconds=time.perf_counter() - t0,
         max_memory_allocated=torch.cuda.max_memory_allocated(dev))
    free, forced = runs
    require(forced["token_steps"] == n_steps, "token steps")
    require(sum(forced["agents_inserted"]) > 0,
            "forced insertion inserted no agent")
    seed_kernel = "seed_eval_full" if cfg.use_seed_kernel_full \
        else "seed_eval"
    evals = lambda s: s["kernel_launches"][seed_kernel]
    require(evals(forced) >= n_steps,
            f"{seed_kernel} launched {evals(forced)} < {n_steps} times in "
            "the forced-insertion run")
    # the unforced run evaluated seeds and declined: fewer inserts and
    # fewer evaluations than the forced run, but at least one evaluation
    require(0 < evals(free) < evals(forced)
            and sum(free["agents_inserted"]) < sum(forced["agents_inserted"]),
            f"the unforced run did not decline: {free} vs {forced}")
    if cfg.use_seed_kernel_full:
        for s in runs:
            k = s["kernel_launches"]
            require(k["motion_column"] == n_steps,
                    f"motion_column launched {k['motion_column']} times in "
                    f"{n_steps} token steps")
            require(k["seed_eval"] == 0, "seed_eval ran under the preset")
            require(k["refine"] >= sum(s["agents_inserted"]),
                    f"refine launched {k['refine']} times for "
                    f"{sum(s['agents_inserted'])} inserts")
    # each trunk sublayer is one fused call; the agent-agent sublayer of
    # each layer is the only attention call that passes the eligibility
    # rule (the temporal and map calls have one query, the seed path runs
    # its kernel, the map encoder one query per token)
    per_step = {"fused_attention_block": 3 * cfg.num_agent_layers
                if cfg.use_fused_block and not cfg.use_column_kernel else 0,
                "r_biased_attention": cfg.num_agent_layers
                if cfg.use_pallas_attention and not (
                    cfg.use_fused_block or cfg.use_column_kernel) else 0}
    for s in runs:
        for k, n in per_step.items():
            require(s["kernel_launches"][k] == n * n_steps,
                    f"{k} launched {s['kernel_launches'][k]} times, not "
                    f"{n} x {n_steps}")
    used = [n for n, c in launches.items() if c > 0]
    require(used, f"no kernel of the path launched: {launches}")
    return launches


# --------------------------------------------------------------------- #
# scoring
# --------------------------------------------------------------------- #

SCORING_SCENARIOS = 4    # synthetic scenarios (seeds 0..3) of `scoring`
# the card's features and scores against the same port code on the CPU,
# on the card's rollout outputs: floats within FEATURE_ATOL or FEATURE_RTOL
# relative, whichever is larger (the card's compiler may contract to FMA
# where the CPU does not; sin / cos differ in their last bits); a boolean
# may differ only where its distance lies within NEAR_THRESHOLD of the
# threshold; a histogram bin only where a value lies within EDGE_REL
# (relative, at least absolute) of an edge (wosac.bin_flips); likelihoods,
# curves and the metametric within SCORE_TOL
FEATURE_ATOL, FEATURE_RTOL = 1e-4, 1e-5
NEAR_THRESHOLD = 1e-5
EDGE_REL = 1e-5
SCORE_TOL = 1e-4


def _to(tree, device):
    from infgen_torch.data.scenario import tree_map
    return tree_map(lambda x: x.to(device), tree)


def compare_features(card, cpu, what):
    """Hold the card's MetricFeatures against the CPU's; returns the max
    abs error of each float field and the certified boolean flips."""
    errs, flips = {}, {}
    for name in card._fields:
        g, r = getattr(card, name).cpu(), getattr(cpu, name)
        require(g.shape == r.shape and g.dtype == r.dtype,
                f"scoring {what}: {name} {tuple(g.shape)} {g.dtype} against "
                f"{tuple(r.shape)} {r.dtype}")
        if g.dtype == torch.bool:
            dist = {"collision_per_step": cpu.distance_to_nearest_object,
                    "offroad_per_step": cpu.distance_to_road_edge}.get(name)
            flip = g != r
            near = torch.zeros_like(flip) if dist is None \
                else dist.abs() < NEAR_THRESHOLD
            require(not (flip & ~near).any(),
                    f"scoring {what}: {name} differs off its threshold")
            flips[name] = int(flip.sum())
        elif not g.dtype.is_floating_point:
            require(torch.equal(g, r), f"scoring {what}: {name} differs")
        else:
            nan = torch.isnan(r)
            require(torch.equal(torch.isnan(g), nan),
                    f"scoring {what}: {name} NaN positions differ")
            err = (g - r).abs().masked_fill(nan, 0.0)
            tol = torch.clamp(FEATURE_RTOL * r.abs().masked_fill(nan, 0.0),
                              min=FEATURE_ATOL)
            require(bool((err <= tol).all()),
                    f"scoring {what}: {name} off by {float(err.max())}")
            errs[name] = float(err.max())
    return errs, flips


def _score_gap(a, b):
    """Max abs difference over two per-scenario metric dicts."""
    return max(float(np.max(np.abs(np.asarray(a[k], np.float64)
                                   - np.asarray(b[k], np.float64))))
               for k in a if k not in ("scenario", "n_inserted"))


def check_scoring(dev):
    """This slice's main path: the flagship (configs/ours_long_term.yaml:
    full width and depth, production beams, bf16, seed_eval) closed-loop
    validation of SCORING_SCENARIOS synthetic scenarios through
    cli.run_validate on the card: rollouts, WOSAC features, the logged
    histograms and each scenario's likelihoods on the device. Every kernel
    count is set to 0 just before and read just after. Then every
    scenario's rollout outputs (and the scenarios' tensors and inputs) go
    to the CPU and through the same port code there: features, bins,
    histograms, likelihoods and the aggregated metametric held to the
    limits above. Last, one scenario with n_rollout_close_val = 2 (two
    lanes): features of [2A, ...] and a finite score."""
    import tempfile

    from infgen_torch.cli import (KERNELS, build_model, build_tokenizers,
                                  kernel_launches, run_validate)
    from infgen_torch.config import load_config
    from infgen_torch.metrics import wosac as W
    from infgen_torch.metrics.features import concat_features
    from infgen_torch.metrics.offline import log_features, rollout_features

    cfg = load_config(FLAGSHIP)
    tok = build_tokenizers(cfg)
    model = build_model(cfg, tok[0], dev)
    lines = []
    with tempfile.TemporaryDirectory() as save:
        for fn in KERNELS.values():
            fn.launches = 0
        t0 = time.perf_counter()
        summary, scorer = run_validate(cfg, dev, SCORING_SCENARIOS, save,
                                       model=model, tokenizers=tok,
                                       keep=True, log_fn=lines.append)
        seconds = time.perf_counter() - t0
        launches = kernel_launches()
        printed = lines[-3:]
        with open(os.path.join(save, "rollout_metrics.json")) as f:
            written = json.load(f)
    require(launches["seed_eval"] > 0, "scoring: seed_eval never launched")
    require(list(written) == ["wosac", "val_metrics", "scenarios"],
            f"scoring: rollout_metrics.json keys {list(written)}")

    # the same port code on the CPU, on the card's outputs
    cpu = torch.device("cpu")
    wcfg = W.WosacConfig()
    t0 = time.perf_counter()
    log_cpu = concat_features([
        log_features(_to(k["scenario"], cpu), _to(k["inputs"], cpu))
        for k in scorer.kept])
    log_err, log_flips = compare_features(scorer.log_feats, log_cpu, "log")
    ld_cpu = W.make_log_distributions(wcfg, log_cpu)
    hist_gap = max(float((getattr(scorer.log_dist, f).cpu()
                          - getattr(ld_cpu, f)).abs().max())
                   for f in ld_cpu._fields)
    require(hist_gap <= SCORE_TOL, f"scoring: log histograms {hist_gap}")
    per_scenario, rows_cpu = [], []
    for kept, row in zip(scorer.kept, scorer.rows):
        outs = [{k: v.cpu() for k, v in o.items()} for o in kept["outputs"]]
        edges = [None if t is None else t.cpu()
                 for t in (kept["road_edges"], kept["road_cyclic"])]
        sim_cpu = concat_features([rollout_features(o, *edges)
                                   for o in outs])
        card = _to(kept["features"], cpu)
        errs, flips = compare_features(kept["features"], sim_cpu,
                                       f"scenario {kept['index']}")
        bins = W.bin_flips(wcfg, card, sim_cpu, EDGE_REL)
        require(not any(u for _, u in bins.values()),
                f"scoring: uncertified bin flips {bins}")
        n_flips = sum(n for n, _ in bins.values())
        m_cpu = W.metrics_to_host(
            W.compute_scenario_metrics(wcfg, ld_cpu, sim_cpu))
        m_cpu.update(scenario=row["scenario"], n_inserted=row["n_inserted"])
        rows_cpu.append(m_cpu)
        gap = _score_gap(m_cpu, row)
        # the scorer alone: the card's features scored on the CPU
        m_same = W.metrics_to_host(W.compute_scenario_metrics(
            wcfg, _to(scorer.log_dist, cpu), card))
        same_gap = _score_gap(m_same, row)
        require(same_gap <= SCORE_TOL,
                f"scoring: the CPU scores the card's features {same_gap} off")
        require(gap <= SCORE_TOL or n_flips,
                f"scoring: likelihoods {gap} off with no bin flip")
        per_scenario.append(dict(
            scenario=row["scenario"], inserted=row["n_inserted"],
            metametric=row["metametric"],
            metametric_cpu=m_cpu["metametric"], max_likelihood_gap=gap,
            same_features_gap=same_gap, certified_bin_flips=n_flips,
            bool_flips={k: n for k, n in flips.items() if n},
            max_feature_err=max(errs.values())))
    wosac_cpu = W.aggregate_scenario_metrics(wcfg, rows_cpu)
    meta_gap = abs(wosac_cpu["wosac/realism_meta_metric"]
                   - summary["realism_meta_metric"])
    require(meta_gap <= SCORE_TOL, f"scoring: metametric {meta_gap} off")
    cpu_seconds = time.perf_counter() - t0

    # two rollouts of one scenario, as two lanes
    for fn in KERNELS.values():
        fn.launches = 0
    two, two_scorer = run_validate(
        cfg.replace(n_rollout_close_val=2), dev, 1, None, model=model,
        tokenizers=tok, keep=True, log_fn=lines.append)
    two_launches = kernel_launches()
    feats = two_scorer.kept[0]["features"]
    A = cfg.max_agents
    require(tuple(feats.valid.shape[:1]) == (2 * A,)
            and feats.num_placement.shape[0] == 2,
            f"scoring: two rollouts gave {tuple(feats.valid.shape)}")
    require(np.isfinite(two["realism_meta_metric"])
            and 0 < two["realism_meta_metric"] <= 1,
            f"scoring: two rollouts scored {two['realism_meta_metric']}")
    require(two_launches["seed_eval"] > 0,
            "scoring: seed_eval never launched for two lanes")

    res = dict(
        config=os.path.relpath(FLAGSHIP, ROOT), scenarios=SCORING_SCENARIOS,
        width=dict(D=cfg.hidden_dim, agent_layers=cfg.num_agent_layers,
                   seed_layers=cfg.num_seed_layers, A=cfg.max_agents,
                   P=cfg.max_map_tokens, frames=cfg.num_recurrent_steps_val,
                   motion_beam=cfg.motion_beam_size,
                   insert_beam=cfg.insert_beam_size),
        compute_dtype=cfg.compute_dtype,
        ms_rollout=summary["ms_rollout"], ms_features=summary["ms_features"],
        ms_scoring=summary["ms_scoring"],
        scoring_peak_bytes=summary["scoring_peak_bytes"],
        realism_meta_metric=summary["realism_meta_metric"],
        realism_meta_metric_cpu=wosac_cpu["wosac/realism_meta_metric"],
        buckets=summary["buckets"], val_metrics=summary["val_metrics"],
        agents_inserted=summary["agents_inserted"], launches=launches,
        seconds=seconds, cpu_check_seconds=cpu_seconds,
        log_features_max_err=max(log_err.values()),
        log_bool_flips={k: n for k, n in log_flips.items() if n},
        log_histogram_gap=hist_gap, metametric_gap=meta_gap,
        per_scenario=per_scenario,
        tolerances=dict(feature_atol=FEATURE_ATOL, feature_rtol=FEATURE_RTOL,
                        near_threshold=NEAR_THRESHOLD, edge_rel=EDGE_REL,
                        score=SCORE_TOL),
        two_rollouts=dict(features_rows=int(feats.valid.shape[0]),
                          realism_meta_metric=two["realism_meta_metric"],
                          ms_rollout=two["ms_rollout"],
                          ms_features=two["ms_features"],
                          ms_scoring=two["ms_scoring"],
                          scoring_peak_bytes=two["scoring_peak_bytes"],
                          launches=two_launches),
        printed=printed)
    emit("scoring", **res)
    return res


# --------------------------------------------------------------------- #
# the latency preset's bf16 decisions: kernels against the plain modules
# --------------------------------------------------------------------- #

LATENCY_KERNEL_FLAGS = ("use_seed_kernel_full", "use_refine_kernel",
                        "use_column_kernel")
BF16_PARITY_SCENARIO = 0     # synthetic scenario (seed) of the bf16 parity


def _decision_cells(k, p, t, H):
    """The decisions of token step t on both sides (numpy outputs of a
    one-lane rollout), in the order the step makes them: its insertions
    (the count; then, on the rows that enter at column t + H - 1 on either
    side, the state, grid cell, type and heading written there) and its
    motion (the state, then the token, written at column t + H on every
    row that does not enter there at step t + 1). Returns (kind, row, field) of
    each differing cell, insertions first."""
    from infgen_torch.config import ENTER_STATE as ENTER

    c_in, c_mo = t + H - 1, t + H
    diff = []
    if k["per_step_inserted"][t] != p["per_step_inserted"][t]:
        diff.append(("insertion", -1, "count"))
    st_k, st_p = k["next_state_idx"], p["next_state_idx"]
    enters = (st_k[:, c_in] == ENTER) | (st_p[:, c_in] == ENTER)
    if t > 0:
        for r in np.nonzero(enters)[0]:
            for field, a, b in (
                    ("state", st_k[r, c_in], st_p[r, c_in]),
                    ("grid", k["grid_index"][r, c_in],
                     p["grid_index"][r, c_in]),
                    ("type", k["pred_type"][r], p["pred_type"][r]),
                    ("heading", k["head_a"][r, c_in], p["head_a"][r, c_in])):
                if a != b:
                    diff.append(("insertion", int(r), field))
    later = np.zeros_like(enters)
    if c_mo < st_k.shape[1]:
        later = (st_k[:, c_mo] == ENTER) | (st_p[:, c_mo] == ENTER)
        for r in np.nonzero(~later)[0]:
            # the state first: a row that leaves has no token
            for field, key in (("state", "next_state_idx"),
                               ("token", "next_token_idx")):
                if k[key][r, c_mo] != p[key][r, c_mo]:
                    diff.append(("motion", int(r), field))
                    break
    return diff


def _motion_gap_limit(head, feat, a, b, eps):
    """A first-order bound on how far a trunk output within eps (max abs) of
    `feat` can move the gap between the head's logits a and b:
    ||grad_f (l_a - l_b)||_1 x eps, the gradient at the plain side's
    feature."""
    f = feat.detach().float().clone().requires_grad_()
    with torch.enable_grad():
        lg = head(f).float()
        g, = torch.autograd.grad(lg[a] - lg[b], f)
    return float(g.abs().sum()) * eps


def certify_difference(k, p, outs, plain_model, t, diff, limits, H):
    """The first differing decision of check_parity_latency_bf16 (step t,
    its cells `diff` from _decision_cells; k / p the two sides' numpy
    outputs, `outs` their tensors) with the readings that certify it or
    not (its docstring)."""
    from infgen_torch.config import EXIT_STATE

    kind, row, field = diff[0]
    found = dict(step=t, kind=kind, row=row, field=field, cells=len(diff))
    if kind == "motion":
        key = "next_token_idx" if field == "token" else "next_state_idx"
        a, b = int(k[key][row, t + H]), int(p[key][row, t + H])
        if field == "state":
            # the rollout maps the state head's class 2 to EXIT_STATE
            a, b = (2 if x == EXIT_STATE else x for x in (a, b))
        lg = p["debug_token_logits" if field == "token"
               else "debug_state_logits"][t, row]
        dec = plain_model.agent_decoder
        head = dec.token_predict_head if field == "token" \
            else dec.state_predict_head
        feat_p = outs["plain"]["debug_layer_cols"][t, -1]
        feat_k = outs["kernels"]["debug_layer_cols"][t, -1]
        live = outs["plain"]["slot_active"]
        feat_err = float((feat_k.float() - feat_p.float())[live].abs().max())
        gap = abs(float(lg[a]) - float(lg[b]))
        limit = _motion_gap_limit(head, feat_p[row], a, b,
                                  limits["motion_feature"])
        top2 = set(np.argsort(lg)[::-1][:2].tolist()) == {a, b}
        found.update(kernel=a, plain=b, plain_gap=gap, gap_limit=limit,
                     top_two=top2, feature_err=feat_err,
                     certified=bool(top2 and gap <= limit
                                    and feat_err <= limits["motion_feature"]))
        return found
    # an insertion: the step's decisions in the order it makes them, seed
    # evaluation j (its heads' choices at once) then refine j (insert j's
    # heading), from each side's own records. The first evaluation whose
    # choices differ is the root; the rest of the step follows from it.
    # The phase forces insertion: the seed state head decides nothing.
    seed_heads = ["seed_type", "seed_grid"]
    order = []
    for j in range(k["debug_seed_type_top2"].shape[1]):
        order.append((j, "seed", seed_heads, limits["seed_gap"]))
        if j < k["debug_refine_head_top2"].shape[1]:
            order.append((j, "refine", ["refine_head"], limits["refine_gap"]))
    found.update(fields=sorted({f for kd, _, f in diff
                                if kd == "insertion"}),
                 certified=False, reason="no evaluation's choice differs")
    for j, stage, hs, limit in order:
        heads = {}
        for h in hs:
            a = int(k[f"debug_{h}_top2"][t, j, 0])
            b = int(p[f"debug_{h}_top2"][t, j, 0])
            if a == b:
                continue
            top2 = p[f"debug_{h}_top2"][t, j].tolist()
            gap = float(p[f"debug_{h}_gap"][t, j])
            ok = set(top2) == {a, b} and gap <= limit
            heads[h] = dict(kernel=a, plain=b, plain_top2=top2,
                            plain_gap=gap, top_two=set(top2) == {a, b},
                            certified=ok)
        if heads:
            found.update(insert=j, decided_by=stage, heads=heads,
                         gap_limit=limit, reason=None,
                         certified=all(x["certified"] for x in
                                       heads.values()))
            break
    return found


def check_parity_latency_bf16(dev):
    """The latency preset's decisions on its kernels against its plain
    modules, on the card at full width in its bf16 policy: the config at
    LATENCY, beams 1, forced insertion, 300 frames, random weights from its
    seed, one synthetic scenario; once with its three kernel flags (and
    seed_eval off), once with all of them off. Token, state, slot and
    insertion decisions (the grid cell, type and heading of each insert)
    are compared step by step up to the first difference, which is
    certified from the plain side's debug outputs:
      - a motion token or state: both choices must be the plain logits' top
        two, and their plain gap within the first-order reach of the
        column's whole-call limit E2E_TOL["motion_column"][bf16] through
        the head (_motion_gap_limit); the trunk output at that step must
        itself differ from the plain one by at most that limit;
      - an insertion: its root is the step's first evaluation (seed
        evaluation j, then refine pass j, j = 0, 1, ...) at which the two
        sides' own debug records (make_rollout_fn's `debug_{head}_top2`)
        chose differently. Every head that differs there is certified by
        itself: both choices must be the plain logits' top two at that
        evaluation, and the plain gap of that head within its limit: 2 x
        E2E_TOL["seed_eval_full"][bf16] for the grid cell or the type (each
        logit within the kernel's limit), 2 x E2E_TOL["refine"][bf16] for
        the heading. A differing insertion with no differing evaluation is
        not certified.
    A difference that is not certified fails the phase."""
    from infgen_torch.cli import (KERNELS, build_model, build_tokenizers,
                                  kernel_launches)
    from infgen_torch.config import SHIFT, load_config
    from infgen_torch.data.features import build_model_inputs
    from infgen_torch.data.scenario import to_device
    from infgen_torch.data.synthetic import make_synthetic_scenario
    from infgen_torch.rollout.closed_loop import make_rollout_fn
    from infgen_torch.tokenizers.map_tokenizer import MapTokenizer

    cfg = load_config(LATENCY).replace(motion_beam_size=1,
                                       insert_beam_size=1)
    plain_cfg = cfg.replace(use_seed_kernel=False,
                            **{f: False for f in LATENCY_KERNEL_FLAGS})
    attr, mt, mv = build_tokenizers(cfg)
    scen = to_device(make_synthetic_scenario(
        cfg, seed=BF16_PARITY_SCENARIO, map_tokenizer=MapTokenizer(mv)), dev)
    uniform = np.random.default_rng(5).uniform(size=cfg.max_map_tokens)
    inputs = build_model_inputs(
        cfg, mt, attr, scen, pt_uniform=torch.as_tensor(
            uniform, dtype=torch.float32, device=dev))
    n_steps = cfg.num_recurrent_steps_val // SHIFT
    outs, launches, seconds, models = {}, {}, {}, {}
    for side, c in (("kernels", cfg), ("plain", plain_cfg)):
        model = models[side] = build_model(c, attr, dev)
        for fn in KERNELS.values():
            fn.launches = 0
        roll = make_rollout_fn(model, c, attr, mt, mv, force_insert=True,
                               debug=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = roll(scen, inputs, torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        seconds[side] = time.perf_counter() - t0
        launches[side] = {k: n for k, n in kernel_launches().items() if n}
        outs[side] = out
    require(all(torch.equal(a, b) for a, b in zip(
        models["kernels"].state_dict().values(),
        models["plain"].state_dict().values())),
        "parity_latency_bf16: the two sides' weights differ")
    require(all(launches["kernels"].get(k, 0) > 0 for k in (
        "seed_eval_full", "refine", "motion_column")),
        f"parity_latency_bf16: a kernel never launched {launches}")
    require(not launches["plain"],
            f"parity_latency_bf16: the plain side launched {launches}")
    k = {n: v.detach().float().cpu().numpy() if v.is_floating_point()
         else v.detach().cpu().numpy() for n, v in outs["kernels"].items()}
    p = {n: v.detach().float().cpu().numpy() if v.is_floating_point()
         else v.detach().cpu().numpy() for n, v in outs["plain"].items()}
    H = (cfg.num_historical_steps - 1) // SHIFT
    first, diff = None, []
    for t in range(n_steps):
        diff = _decision_cells(k, p, t, H)
        if diff:
            first = t
            break
    limits = dict(
        motion_feature=E2E_TOL["motion_column"][BF16],
        seed_gap=2 * E2E_TOL["seed_eval_full"][BF16],
        refine_gap=2 * E2E_TOL["refine"][BF16])
    found = None if first is None else certify_difference(
        k, p, outs, models["plain"], first, diff, limits, H)
    emit("parity_latency_bf16", config=os.path.relpath(LATENCY, ROOT),
         compute_dtype=cfg.compute_dtype, beams=1, force_insert=True,
         frames=cfg.num_recurrent_steps_val, scenario=BF16_PARITY_SCENARIO,
         steps_equal=n_steps if first is None else first,
         token_steps=n_steps, first_difference=found, limits=limits,
         inserted={s: int(outs[s]["n_inserted"]) for s in outs},
         launches=launches, seconds=seconds)
    require(found is None or found["certified"],
            f"parity_latency_bf16: an uncertified difference {found}")
    return found


def rba_backward_cost(args, num_heads):
    """(bytes, fp32 multiply-adds) of the recompute backward of one call
    (r_biased_attention_trainable's `_rba_bwd`) at this run's mask: it
    reads what the forward reads (rba_cost_least's bytes, the output write
    there standing for the cotangent's read here) and writes the gradient
    of each of the six differentiable inputs (q, k, v, r, w_kr, w_vr, each
    as large as its input); it recomputes the forward (rba_cost_least's
    work) and forms each product's gradient against both its operands
    (twice that work)."""
    nbytes, macs = rba_cost_least(args, num_heads)
    return nbytes + _nbytes(*args[:6]), 3 * macs


# --------------------------------------------------------------------- #
# streaming
# --------------------------------------------------------------------- #

STREAM_PARITY_SEGMENTS = 3
STREAM_POS_KEYS = ("pos_a", "pred_traj")     # parity_stream's positions
STREAM_FRAMES = 900          # (a): cli stream's default horizon
STREAM_FLEET = 8             # (b): synthetic scenarios (seeds 0..7)
STREAM_PLAN = ((128, 1), (64, 1), (64, 1))   # the JAX bench's fleet plan
STREAM_LATENCY_SEGMENTS = 2  # (c)
STREAM_LATENCY_PLAN = ((128, 1), (64, 1))    # (d): two chunks


def check_parity_stream(dev):
    """parity_config's small rollout (70-frame segments) as a three-segment
    stream on the card (kernels in fp32): through StreamingRollout.run over
    a RolloutServer of one bucket, and through make_stream_fn; with the
    flagship's flags and with the latency preset's three kernel flags.
    Every segment the card ran is run again on the CPU (plain versions)
    from the same start: the scenario the card's segment started from (its
    seam, handed over by `on_segment`) and the same seed, through a
    RolloutServer like the card's. As in the parity* phases, its decisions
    (PARITY_EXACT) must be equal, and its headings, states, shapes and
    seed probabilities within POSE_TOL. Positions (STREAM_POS_KEYS) are
    held to POSE_TOL scaled by how far from the origin the segment runs:
    segment i's limit is POSE_TOL x max(1, X_i / X_0), X the largest
    |coordinate| the CPU side's segment holds. Segment 0 is the parity
    phases' rollout, held to POSE_TOL itself. The reason, measured on the
    H100 with every kernel off as well: the ego of this random-weight
    scenario moves about 20 m per token step and is 230-390 m out in
    segment 2, where a float32 ulp is 3e-5 m; the plain modules' headings
    there differ between CPU and card by up to 1.3e-5 rad, and the position
    error grows by about 1e-4 m per token step to 1.15e-3 m. Each segment's
    readings name the key, row and frame of its largest position error.
    The card's stitched registry must hold stream_invariants, and each
    kernel of the flags must have launched (the CPU runs launch none)."""
    from infgen_torch.cli import (KERNELS, build_model, build_tokenizers,
                                  kernel_launches)
    from infgen_torch.data.synthetic import make_synthetic_scenario
    from infgen_torch.rollout import streaming as ST
    from infgen_torch.rollout.serving import RolloutServer

    S, R = STREAM_PARITY_SEGMENTS, PARITY_FRAMES
    runs, faults = {}, []
    for name in ("parity", "parity_latency"):
        flags = PARITY_FLAGS[name]
        cfg = parity_config(**flags)
        tok = build_tokenizers(cfg)
        scen = make_synthetic_scenario(cfg, seed=2, num_agents=10)

        def server():
            return RolloutServer(cfg, *tok, agent_buckets=(cfg.max_agents,),
                                 agent_headroom=0, force_insert=True,
                                 num_recurrent_steps=R)

        cpu_model, cpu_srv = build_model(cfg, tok[0], "cpu"), server()
        segs = {"host": [], "fused": []}

        def replay(path):
            def on_segment(seg, start, seed, out):
                ref = cpu_srv.rollout(cpu_model, ST.to_host(start), seed,
                                      input_seed=seed)
                g, c = ({k: v.detach().cpu().numpy() for k, v in o.items()}
                        for o in (out, ref))
                err = {k: np.abs(c[k] - g[k]) for k in PARITY_CLOSE}
                worst = max(STREAM_POS_KEYS, key=lambda k: err[k].max())
                at = np.unravel_index(np.argmax(err[worst]), err[worst].shape)
                segs[path].append(dict(
                    mismatched=[k for k in PARITY_EXACT
                                if not np.array_equal(c[k], g[k])],
                    pos_err=float(err[worst].max()),
                    pos_err_at=dict(key=worst, row=int(at[0]),
                                    index=int(at[1])),
                    other_err=max(float(e.max()) for k, e in err.items()
                                  if k not in STREAM_POS_KEYS),
                    extent=max(float(np.abs(c[k]).max())
                               for k in STREAM_POS_KEYS),
                    inserted=int(g["n_inserted"])))
            return on_segment

        model = build_model(cfg, tok[0], dev)
        for fn in KERNELS.values():
            fn.launches = 0
        res = ST.StreamingRollout(server(), R).run(
            model, scen, 0, S * R, on_segment=replay("host"))
        ST.make_stream_fn(model, cfg, *tok, segment_steps=R, n_segments=S,
                          force_insert=True)(scen, 0,
                                             on_segment=replay("fused"))
        used = {k: n for k, n in kernel_launches().items() if n}
        stream_invariants(res, f"parity_stream {name}")
        runs[name] = dict(flags=flags, launches=used,
                          segments=res["segments"],
                          agents_ever_alive=int(res["state"].shape[0]),
                          per_segment=segs)
        for path, rows in segs.items():
            for i, r in enumerate(rows):
                r["pos_limit"] = POSE_TOL * max(
                    1.0, r["extent"] / rows[0]["extent"])
                if r["mismatched"] or r["pos_err"] > r["pos_limit"] \
                        or r["other_err"] > POSE_TOL:
                    faults.append(f"{name} {path} segment {i}: {r}")
            if len(rows) != S or not sum(r["inserted"] for r in rows):
                faults.append(f"{name} {path}: {len(rows)} segments, "
                              "or no agent inserted")
        want = ("seed_eval_full", "refine", "motion_column") if flags \
            else ("seed_eval",)
        if not all(used.get(k, 0) > 0 for k in want):
            faults.append(f"{name}: a kernel never launched: {used}")
    emit("parity_stream", config=PARITY_DESC.replace(
        f"{PARITY_FRAMES} frames", f"{S} segments of {PARITY_FRAMES} "
        "frames"), tolerance=POSE_TOL, runs=runs)
    require(not faults, f"parity_stream: {faults}")


def stream_invariants(res, what):
    """The stitched registry of one stream: finite poses, the ego alive in
    every frame after the first two, no gid alive again after it died at a
    segment's last frame, and the frame count that frames_per_segment
    gives."""
    from infgen_torch.config import EXIT_STATE, INVALID_STATE

    G, F = res["state"].shape
    require(F == sum(res["frames_per_segment"]),
            f"{what}: {F} frames, segments say {res['frames_per_segment']}")
    require(res["traj"].shape == (G, F, 2)
            and np.isfinite(res["traj"]).all()
            and np.isfinite(res["head"]).all(), f"{what}: poses not finite")
    require((res["state"][res["av_gid"], 2:] != INVALID_STATE).all(),
            f"{what}: the ego is not alive in every frame")
    bounds = np.cumsum(res["frames_per_segment"])[:-1]
    dead = res["state"] == INVALID_STATE
    for fb in bounds:
        gone = (np.isin(res["state"][:, fb - 1], (INVALID_STATE, EXIT_STATE))
                & (~dead[:, :fb]).any(1))
        require(dead[gone, fb:].all(),
                f"{what}: a gid came back after it died at frame {fb}")


def _stream_run(dev, drive):
    """Counts set to 0, peak memory reset, `drive()` timed on the host
    clock to a synchronise; returns (its result, seconds, launches, peak
    bytes)."""
    from infgen_torch.cli import KERNELS, kernel_launches

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in KERNELS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = drive()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return out, seconds, kernel_launches(), \
        torch.cuda.max_memory_allocated(dev)


def check_stream(dev):
    """This slice's main path at full width, bf16, random weights from each
    config's seed, production beams (the configs' own), unforced:
      (a) the flagship through cli.run_stream (the path of `cli stream`):
          one synthetic scenario, STREAM_FRAMES frames in segments of
          num_recurrent_steps_val (300), the host loop re-bucketing over
          agent buckets 32 / 64 / 128;
      (b) the fleet: STREAM_FLEET synthetic scenarios through
          make_chunked_stream_runner with the JAX bench's plan STREAM_PLAN,
          each chunk one segment of all the scenarios as lanes (seed_eval's
          lane form);
      (c) the latency preset through StreamingRollout.run (cli.run_stream):
          one scenario, STREAM_LATENCY_SEGMENTS segments;
      (d) the latency preset's fleet: the STREAM_FLEET scenarios through
          make_chunked_stream_runner with STREAM_LATENCY_PLAN, its three
          kernels over lanes (the column's lane form among them).
    Each: ms per segment and per token step, agent-steps/s (non-invalid
    10 Hz states after the history over wall time, as the JAX bench counts
    a stream's), agents ever alive, buckets, host reads, peak memory and
    each kernel's launches (counts set to 0 just before, read just after);
    the registry's invariants (stream_invariants) and a launch of every
    kernel the configuration runs. Returns {kernel: launches in the
    phase}."""
    from infgen_torch.cli import build_model, build_tokenizers, run_stream
    from infgen_torch.config import INVALID_STATE, SHIFT, load_config
    from infgen_torch.rollout import streaming as ST
    from infgen_torch.train.loop import SyntheticDataset

    runs, total = {}, {}

    def keep(name, summary, seconds, launches, peak, results):
        for r in results:
            stream_invariants(r, f"stream {name}")
        used = {k: n for k, n in launches.items() if n}
        for k, n in used.items():
            total[k] = total.get(k, 0) + n
        runs[name] = dict(summary, seconds=seconds, launches=used,
                          max_memory_allocated=peak)

    # (a) the flagship, cli stream's path
    cfg = load_config(FLAGSHIP)
    tok = build_tokenizers(cfg)
    model = build_model(cfg, tok[0], dev)
    (results, summary), seconds, launches, peak = _stream_run(
        dev, lambda: run_stream(
            cfg, dev, 1, STREAM_FRAMES, model=model, tokenizers=tok))
    keep("flagship", {k: summary[k] for k in (
        "segments", "segment_steps", "frames", "ms_per_segment",
        "ms_per_token_step", "agents_ever_alive", "buckets",
        "alive_per_segment", "inserted_per_segment", "agent_steps",
        "agent_steps_per_s", "host_reads")}, seconds, launches, peak,
        results)
    require(launches["seed_eval"] > 0, "stream flagship: seed_eval never "
            "launched")

    # (b) the fleet through the chunked runner, over lanes
    def fleet(c, tk, mdl, plan):
        """The STREAM_FLEET synthetic scenarios of config c through the
        chunked runner with `plan` (the runner kept on `fleet.runner`)."""
        data = SyntheticDataset(c, size=STREAM_FLEET)
        fleet.runner = ST.make_chunked_stream_runner(
            c, *tk, segment_steps=c.num_recurrent_steps_val)
        return fleet.runner(mdl, [data[i] for i in range(STREAM_FLEET)],
                            plan, c.seed)

    def fleet_summary(c, plan, outs, used, seconds, runner):
        """(the fleet's summary, its stitched per-scenario results)."""
        R, Hs = c.num_recurrent_steps_val, c.num_historical_steps
        host = [{k: v.detach().cpu().numpy() for k, v in o.items()}
                for o in outs]
        steps = float(sum((o["pred_state"][..., Hs:] != INVALID_STATE).sum()
                          for o in host))
        results = [
            ST.stitch_stream_outputs({k: v[i] for k, v in o.items()}, Hs)
            for o in host for i in range(STREAM_FLEET)]
        per_chunk = np.array([r["state"].shape[0] for r in results]
                             ).reshape(len(host), STREAM_FLEET)
        n_seg = sum(n for _, n in plan)
        require(all(a in (plan_a, c.max_agents)
                    for a, (plan_a, _) in zip(used, plan)),
                f"stream fleet: buckets {used} for the plan {plan}")
        return dict(
            scenarios=STREAM_FLEET, plan=[list(x) for x in plan],
            buckets=used, segments=n_seg, segment_steps=R,
            ms_per_segment=seconds * 1e3 / n_seg,
            ms_per_token_step=seconds * 1e3 / (n_seg * R // SHIFT),
            agents_ever_alive=runner.agents_ever_alive,
            agents_per_chunk=per_chunk.tolist(),
            agent_steps=steps, agent_steps_per_s=steps / seconds,
            host_reads=runner.host_reads), results

    (outs, used), seconds, launches, peak = _stream_run(
        dev, lambda: fleet(cfg, tok, model, STREAM_PLAN))
    summary, results = fleet_summary(cfg, STREAM_PLAN, outs, used, seconds,
                                     fleet.runner)
    keep("fleet", summary, seconds, launches, peak, results)
    require(launches["seed_eval"] > 0, "stream fleet: seed_eval never "
            "launched")

    # (c) the latency preset through StreamingRollout.run
    lat = load_config(LATENCY)
    ltok = build_tokenizers(lat)
    lmodel = build_model(lat, ltok[0], dev)
    (results, summary), seconds, launches, peak = _stream_run(
        dev, lambda: run_stream(
            lat, dev, 1, STREAM_LATENCY_SEGMENTS * lat.num_recurrent_steps_val,
            model=lmodel, tokenizers=ltok))
    keep("latency", {k: summary[k] for k in (
        "segments", "segment_steps", "frames", "ms_per_segment",
        "ms_per_token_step", "agents_ever_alive", "buckets",
        "alive_per_segment", "inserted_per_segment", "agent_steps",
        "agent_steps_per_s", "host_reads")}, seconds, launches, peak,
        results)
    require(all(launches[k] > 0 for k in ("seed_eval_full", "refine",
                                          "motion_column"))
            and launches["seed_eval"] == 0,
            f"stream latency: launches {launches}")

    # (d) the latency preset's fleet through the chunked runner
    (outs, used), seconds, launches, peak = _stream_run(
        dev, lambda: fleet(lat, ltok, lmodel, STREAM_LATENCY_PLAN))
    summary, results = fleet_summary(lat, STREAM_LATENCY_PLAN, outs, used,
                                     seconds, fleet.runner)
    keep("latency_fleet", summary, seconds, launches, peak, results)
    require(all(launches[k] > 0 for k in ("seed_eval_full", "refine",
                                          "motion_column"))
            and launches["seed_eval"] == 0,
            f"stream latency_fleet: launches {launches}")
    emit("stream", configs={"flagship": os.path.relpath(FLAGSHIP, ROOT),
                            "latency": os.path.relpath(LATENCY, ROOT)},
         compute_dtype=cfg.compute_dtype,
         beams=dict(motion=cfg.motion_beam_size, insert=cfg.insert_beam_size),
         agent_steps_unit="agents x 10 Hz frames", runs=runs,
         launches=total)
    return total


# --------------------------------------------------------------------- #
# export
# --------------------------------------------------------------------- #

# the exported rollout (rollout/export.py) of the latency preset and the
# flagship; the flagship with use_fused_block and with use_pallas_attention
# are exported in the CPU tests (tests/test_torch_export.py): with them the
# phase took 211-232 s and one whole run 1,173 s of its 1,200 (PERF.md)
EXPORT_PATHS = (MAIN_PATHS[3], MAIN_PATHS[0])


def _export_setup(path, flags, dev, frames):
    """(cfg, tokenizers, model, scenario, inputs) of an export check: the
    config at full width with insertion_fixed_trip and `frames` frames,
    its seed's weights, synthetic scenario 0 and its inputs."""
    from infgen_torch.cli import build_model, build_tokenizers
    from infgen_torch.config import load_config
    from infgen_torch.data.features import build_model_inputs
    from infgen_torch.data.scenario import to_device
    from infgen_torch.data.synthetic import make_synthetic_scenario

    cfg = load_config(path).replace(
        insertion_fixed_trip=True, num_recurrent_steps_val=frames, **flags)
    tok = build_tokenizers(cfg)
    model = build_model(cfg, tok[0], dev)
    scen = to_device(make_synthetic_scenario(cfg, seed=0), dev)
    inputs = build_model_inputs(
        cfg, tok[1], tok[0], scen,
        torch.Generator(device=dev).manual_seed(cfg.seed))
    return cfg, tok, model, scen, inputs


def _timed_run(fn, args, dev, n_steps):
    """fn(*args, generator of seed 7): (its outputs on the host, its ms per
    token step, its kernel launches)."""
    from infgen_torch.cli import KERNELS, kernel_launches
    sync = torch.cuda.synchronize if dev.type == "cuda" else lambda: None
    for k in KERNELS.values():
        k.launches = 0
    sync()
    t0 = time.perf_counter()
    out = fn(*args, torch.Generator(device=dev).manual_seed(7))
    sync()
    ms = (time.perf_counter() - t0) * 1e3 / n_steps
    return ({k: v.cpu().numpy() for k, v in out.items()}, ms,
            kernel_launches())


def export_artifact(path, flags, device, frames, conn):
    """In a spawned process on `device`: the config's rollout exported
    through the command line's function (cli.run_export, forced
    insertion) into a file and loaded back; then, once `conn` says go, run
    (_timed_run). Sends the readings, then the run's outputs and launches
    (or the error's traceback)."""
    import tempfile
    import traceback

    try:
        from infgen_torch.cli import run_export
        from infgen_torch.config import SHIFT
        from infgen_torch.rollout.export import load_rollout_artifact

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device(device)
        cfg, tok, model, scen, inputs = _export_setup(path, flags, dev,
                                                      frames)
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            line = run_export(cfg, dev, os.path.join(tmp, "rollout.pt2"),
                              force_insert=True, model=model, tokenizers=tok)
            export_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            served = load_rollout_artifact(line["artifact"])
            load_s = time.perf_counter() - t0
        conn.send(dict(export_s=export_s, bytes=line["bytes"], load_s=load_s,
                       programs=served.header["programs"]))
        conn.recv()
        out, ms, launches = _timed_run(
            served, (model.state_dict(), scen, inputs), dev, frames // SHIFT)
        conn.send(dict(ms=ms, out=out, launches=launches))
    except Exception:
        conn.send(dict(error=traceback.format_exc()))


def start_exports(dev, paths=EXPORT_PATHS):
    """Start export_artifact for each config of `paths`, a spawned process
    each, so that tracing, saving and loading (host-bound Python, about a
    millisecond a graph node each) run beside the earlier phases; the
    artifacts run only when check_export says go."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    jobs = []
    for path, flags, _ in paths:
        ours, theirs = ctx.Pipe()
        proc = ctx.Process(target=export_artifact, daemon=True, args=(
            path, flags, str(dev), SERVING_FRAMES, theirs))
        proc.start()
        jobs.append((proc, ours))
    return jobs


def _receive(conn, what):
    require(conn.poll(1200), f"export: no word from {what}")
    msg = conn.recv()
    require("error" not in msg, f"export: {what} failed:\n"
            f"{msg.get('error')}")
    return msg


def check_export(dev, jobs, paths=EXPORT_PATHS):
    """Each config of `paths` at full width, bf16, exported for the card
    with insertion_fixed_trip and forced insertion, written to a file and
    loaded back in its process of start_exports; here the direct
    make_rollout_fn rollout runs on the same inputs, then the artifact in
    its process, one after the other (SERVING_FRAMES frames, one seed's
    generator each). Every output of the artifact's run equals the direct
    run's bit for bit, and each kernel's launches in the two runs are
    equal, above zero for the kernels of the config's main path. Readings:
    seconds to export (the command line's run_export, the file written)
    and to load, bytes per program, ms per token step of each. Returns
    {kernel: launches of the artifacts' runs}."""
    from infgen_torch.config import SHIFT, load_config
    from infgen_torch.rollout.closed_loop import make_rollout_fn

    n_steps = SERVING_FRAMES // SHIFT
    t_phase = time.perf_counter()
    total = {}
    try:
        for (proc, conn), (path, flags, kernels) in zip(jobs, paths):
            what = f"{os.path.basename(path)} {flags}"
            res = _receive(conn, what)
            cfg, tok, model, scen, inputs = _export_setup(path, flags, dev,
                                                          SERVING_FRAMES)
            d_out, d_ms, d_n = _timed_run(
                make_rollout_fn(model, cfg, *tok, force_insert=True),
                (scen, inputs), dev, n_steps)
            conn.send("go")
            run = _receive(conn, what)
            a_out, a_n = run["out"], run["launches"]
            require(set(a_out) == set(d_out), "export: output keys differ")
            differ = [k for k in d_out
                      if not np.array_equal(a_out[k], d_out[k])]
            require(not differ, f"export: {differ} differ from the direct "
                    f"rollout ({what})")
            require(a_n == d_n, f"export: launches {a_n} != direct {d_n}")
            require(all(a_n[k] > 0 for k in kernels),
                    f"export: a kernel of {kernels} never launched: {a_n}")
            check_rollout({k: torch.as_tensor(v) for k, v in a_out.items()},
                          load_config(path).replace(
                              num_recurrent_steps_val=SERVING_FRAMES),
                          n_steps)
            for k, n in a_n.items():
                total[k] = total.get(k, 0) + n
            emit("export", config=os.path.relpath(path, ROOT), flags=flags,
                 frames=SERVING_FRAMES, force_insert=True,
                 export_s=res["export_s"], bytes=res["bytes"],
                 programs=res["programs"], load_s=res["load_s"],
                 ms_per_token_step=run["ms"], direct_ms_per_token_step=d_ms,
                 launches=a_n, agents_inserted=int(a_out["n_inserted"]))
            proc.join(60)
    finally:
        for proc, _ in jobs:
            if proc.is_alive():
                proc.terminate()
            proc.join()
    emit("export_phase", seconds=time.perf_counter() - t_phase)
    return total


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check runs only on "
              "a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    # train() starts a wandb run where the package is installed: none here
    # (no process of its own, nothing written beside the checkout)
    os.environ.setdefault("WANDB_MODE", "disabled")
    from infgen_torch.cli import build_tokenizers
    from infgen_torch.config import load_config
    from infgen_torch.ops.build import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())

    from infgen_torch.data import native
    emit("build", seconds=build(force=True, verbose=True),
         native_seconds=native.build(force=True))
    # the export phase's tracing, saving and loading run in processes of
    # their own beside the phases below; their artifacts run at its turn
    export_jobs = start_exports(dev)

    cfg, lat = load_config(FLAGSHIP), load_config(LATENCY)
    attr = build_tokenizers(cfg)[0]
    check_seed_eval_lanes(cfg, attr, dev)
    for lane_check in LANE_CHECKS.values():
        lane_check(cfg, attr, dev)
    check_column_lanes(lat, attr, dev)
    checks = {"seed_eval": check_seed_eval(cfg, attr, dev),
              "seed_eval_full": check_seed_eval_full(lat, attr, dev),
              "refine": check_refine(lat, attr, dev),
              "motion_column": check_motion_column(lat, attr, dev),
              "fused_attention_block": check_fused_block(cfg, attr, dev),
              "r_biased_attention": check_r_biased_attention(cfg, attr,
                                                             dev)}
    for phase in PARITY_FLAGS:
        check_parity(dev, phase)
    check_parity_serving(dev)
    check_parity_stream(dev)
    check_parity_latency_bf16(dev)
    # each kernel's launches on the main path that runs it
    launches = {}
    for path, flags, kernels in MAIN_PATHS:
        run = run_preset(path, dev, **flags)
        launches.update({k: run[k] for k in kernels})
    lanes_launches, served = check_serving(dev)
    # the lane form at the shapes the served batches gave it
    served_lanes = [check_seed_eval_lanes(
        cfg.replace(max_agents=A, max_map_tokens=P), attr, dev, n)
        for A, P, n in served]
    require(served_lanes, "serving dispatched no batch of lanes")
    # this slice's path: the three lane forms served at full width, then
    # each lane form at the shapes its served batches gave it
    kernel_lanes_launches, kernel_served = check_serving(
        dev, "serving_kernels", LANE_KERNEL_FLAGS)
    require(kernel_served, "serving_kernels dispatched no batch of lanes")
    served_kernel_lanes = {name: {(A, P, n): lane_check(
        cfg.replace(max_agents=A, max_map_tokens=P), attr, dev, n)
        for A, P, n in kernel_served}
        for name, lane_check in LANE_CHECKS.items()}
    # the latency preset served over lanes (the column's lane form), then
    # its three lane forms at the shapes its batches gave them (a check
    # already made at a shape is not made again)
    latency_lanes_launches, latency_served = check_serving(
        dev, "serving_latency", path=LATENCY)
    require(latency_served, "serving_latency dispatched no batch of lanes")
    served_kernel_lanes["motion_column"] = {}
    for name, lane_check in (("seed_eval_full", check_seed_eval_full_lanes),
                             ("refine", check_refine_lanes),
                             ("motion_column", check_column_lanes)):
        for A, P, n in latency_served:
            if (A, P, n) not in served_kernel_lanes[name]:
                served_kernel_lanes[name][A, P, n] = lane_check(
                    lat.replace(max_agents=A, max_map_tokens=P), attr, dev,
                    n)
    trainable = check_trainable_grad(cfg, dev)
    train = check_train(dev)
    configs = check_train_configs(dev)
    open_loop_launches = check_open_loop(dev)
    check_check_inputs(dev)
    warm_start_launches = check_warm_start(dev)
    learning_launches = check_learning(dev)
    womd_launches = check_womd(dev, smi)
    scoring = check_scoring(dev)
    stream_launches = check_stream(dev)
    export_launches = check_export(dev, export_jobs)
    missing = [k for k in checks if launches[k] == 0]
    require(not missing, f"kernels never launched on a main path: {missing}")

    main_dt = BF16 if cfg.compute_dtype in ("bfloat16", "bf16") else F32
    line = []
    for name, res in checks.items():
        r = res.get(main_dt, res[F32])
        source, replaces = SOURCES[name]
        line.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name],
            max_abs_err=r.get("raw_max_abs_err", r["max_abs_err"]),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None))
        if stream_launches.get(name):
            line[-1]["stream_launches"] = stream_launches[name]
        if export_launches.get(name):
            line[-1]["export_launches"] = export_launches[name]
    def lane_fields(lane, err_key, launched):
        return dict(lanes_A=lane["A"], lanes_P=lane["P"],
                    lanes=lane["lanes"],
                    lanes_on=lane["lanes"] - len(lane["lanes_off"]),
                    lanes_ms=lane["ms"], lanes_ms_per_lane=lane["ms_per_lane"],
                    lanes_single_ms=lane["single_ms"],
                    lanes_bound_ms=lane["bound_ms"],
                    lanes_bound_by=lane["bound_by"],
                    lanes_max_abs_err=lane[err_key],
                    lanes_launches=launched)

    lane = served_lanes[-1].get(main_dt, served_lanes[-1][F32])
    line[0].update(lane_fields(lane, "raw_max_abs_err",
                               lanes_launches["seed_eval"]),
                   scoring_launches=scoring["launches"]["seed_eval"],
                   warm_start_launches=warm_start_launches,
                   learning_launches=learning_launches,
                   womd_launches=womd_launches["seed_eval"])
    for entry in line:
        name = entry["name"]
        if name in served_kernel_lanes:
            # the lane form at the last shape its own served path gave it
            column = name == "motion_column"
            res = served_kernel_lanes[name][
                (latency_served if column else kernel_served)[-1]]
            launched = (latency_lanes_launches if column
                        else kernel_lanes_launches)[name]
            entry.update(lane_fields(res.get(main_dt, res[F32]),
                                     "max_abs_err", launched))
    rba = next(e for e in line if e["name"] == "r_biased_attention")
    rba.update(
        train_launches=train["launches"]["r_biased_attention"],
        train_configs_launches=configs["launches"],
        train_configs_backward_calls=configs["backward_calls"],
        open_loop_launches=open_loop_launches,
        womd_launches=womd_launches["r_biased_attention"],
        train_shapes_ms={k: r["ms"] for k, r in trainable.items()},
        train_shapes_bound_ms={k: r["bound_ms"] for k, r in
                               trainable.items()},
        train_backward_ms={k: r["backward_ms"] for k, r in
                           trainable.items()},
        train_backward_bound_ms={k: r["backward_bound_ms"] for k, r in
                                 trainable.items()},
        backward="plain recompute, as _rba_bwd")
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
