"""Configuration system: typed dataclasses loaded from YAML.

The PyTorch port's own copy of `infgen_tpu/config.py` (the port imports
nothing of the JAX package): the same fields, defaults and YAML loader, so
both packages read the same `configs/*.yaml`. Fields documented as
TPU-specific keep their names; the port reads the ones its path uses and
ignores the rest (`rollout_scan_unroll`, for example: an eager loop has no
scan to unroll).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import yaml

# Agent taxonomy. Reference: infgen/datasets/preprocess.py:19-20.
AGENT_TYPES = ("veh", "ped", "cyc", "seed")
AGENT_STATES = ("invalid", "valid", "enter", "exit")

# Agent state token ids. Reference: configs/ours_long_term.yaml:11-15.
INVALID_STATE = 0
VALID_STATE = 1
ENTER_STATE = 2
EXIT_STATE = 3

# Token stride: 10 Hz steps per 2 Hz motion token. Reference: preprocess.py:13.
SHIFT = 5

# Canonical evaluation shapes (reference: preprocess.py:14-18).
AGENT_SHAPE_EVAL = {
    "veh": (4.3, 1.8, 1.0),
    "ped": (0.5, 0.5, 1.0),
    "cyc": (1.9, 0.5, 1.0),
}


@dataclass
class LossWeights:
    """Loss weights. Reference: configs/ours_long_term.yaml:89-105."""

    token_cls_loss: float = 1.0
    map_token_loss: float = 1.0
    state_cls_loss: float = 10.0
    type_cls_loss: float = 5.0
    pos_cls_loss: float = 1.0
    head_cls_loss: float = 1.0
    offset_reg_loss: float = 5.0
    shape_reg_loss: float = 0.2
    pos_reg_loss: float = 10.0
    head_reg_loss: float = 1.0
    state_weight: List[float] = field(default_factory=lambda: [0.1, 0.1, 0.8])
    seed_state_weight: List[float] = field(default_factory=lambda: [0.9, 0.1])
    seed_type_weight: List[float] = field(default_factory=lambda: [0.8, 0.1, 0.1])
    agent_occ_pos_weight: float = 100.0
    pt_occ_pos_weight: float = 5.0
    agent_occ_loss: float = 10.0
    pt_occ_loss: float = 10.0


@dataclass
class Config:
    """Full model + experiment configuration.

    Field provenance is the reference YAML (configs/ours_long_term.yaml) unless
    marked TPU-specific.
    """

    # --- time / token info (yaml `time_info`) ---
    num_historical_steps: int = 11
    num_future_steps: int = 80
    token_size: int = 2048
    predict_motion: bool = True
    predict_state: bool = True
    predict_map: bool = True
    predict_occ: bool = True
    pl2seed_radius: float = 75.0
    grid_range: float = 150.0
    grid_interval: float = 3.0
    angle_interval: float = 3.0
    seed_size: int = 1
    buffer_size: int = 128
    max_num: int = 32

    # --- model ---
    decoder_type: str = "agent_decoder"  # or "occ_decoder"
    input_dim: int = 2
    hidden_dim: int = 128
    output_dim: int = 2
    num_heads: int = 8
    head_dim: int = 16
    dropout: float = 0.1
    num_freq_bands: int = 64
    num_map_layers: int = 3
    num_agent_layers: int = 6
    num_seed_layers: int = 3  # reference hardcodes seed_layers=3 (agent_decoder.py:235)
    a2a_radius: float = 60.0
    pl2pl_radius: float = 10.0
    pl2a_radius: float = 30.0
    a2sa_radius: float = 10.0
    pl2sa_radius: float = 10.0
    time_span: int = 60
    map_token_size: int = 1024  # reference hardcodes 1024 (map_decoder.py:58)
    num_seed_feature: int = 10  # reference hardcodes 10 (agent_decoder.py:292)
    motion_beam_size: int = 5  # agent_decoder.py:300
    insert_beam_size: int = 10  # agent_decoder.py:301
    insert_limit: int = 10  # agent_decoder.py:1738
    pl2a_num_neighbors: int = 5  # agent_decoder.py:711 (radius max_num_neighbors)

    # --- ablation flags (configs/experiments/*.yaml) ---
    use_grid_token: bool = True
    use_head_token: bool = True
    use_state_token: bool = True
    disable_insertion: bool = False
    # Reference-faithful rollout quirks (True = emulate the published
    # reference inference behavior exactly — required for rollout parity,
    # tests/test_rollout_parity.py; False = the "repaired" semantics):
    #  1. _build_temporal_edge masks the last num_seed_feature(=10) rows out
    #     of BOTH the temporal key and query sets (agent_decoder.py:553-556)
    #     — intended for the training graph's appended seed rows, but at
    #     inference no seed rows are appended, so the reference rollout
    #     silently runs the last 10 real agent rows (including every recently
    #     inserted agent) with zero-aggregate temporal attention.
    #  2. Per-step categorical embeddings: the reference refreshes type/shape
    #     embeddings only for rows that went invalid (:2237-2238), but the
    #     embeddings were initialized with state==invalid -> seed-type /
    #     invalid-shape for all future columns (:376-380). Initial agents
    #     therefore keep seed-type/invalid-shape categorical embeddings for
    #     every rollout column; only agents INSERTED during the rollout carry
    #     real type/shape embeddings (:1949,1993).
    ref_rollout_quirks: bool = True

    # --- training ---
    lr: float = 5e-4
    warmup_steps: int = 0
    total_steps: int = 32
    max_epochs: int = 32
    grad_clip_norm: float = 0.5
    accumulate_grad_batches: int = 1
    loss_weight: LossWeights = field(default_factory=LossWeights)

    # --- validation / rollout ---
    num_recurrent_steps_val: int = 300
    val_open_loop: bool = False
    val_close_loop: bool = True
    n_rollout_close_val: int = 1
    # periodic in-training validation cadence (reference
    # check_val_every_n_epoch=1, run.py:136); 0 disables
    val_every_n_epochs: int = 1
    val_num_scenarios: int = 8

    # --- TPU-specific: padded static shapes ---
    max_agents: int = 128  # A_max slots incl. room for inserted agents
    max_map_tokens: int = 1024  # P_max map ("pt") tokens per scenario
    num_token_steps: int = 18  # T for training (91 // SHIFT)

    # --- TPU-specific: parallelism / precision ---
    # auxiliary neighbor-grid-cell head: params-only fidelity (the reference
    # builds it unconditionally, agent_decoder.py:289-290, but its loss is
    # commented out at infgen.py:494; needed for full checkpoint transplants)
    use_grid_index_head: bool = True
    # eligible attention cores through ops/pallas_attention's kernel (the
    # rollout's and the training forward's)
    use_pallas_attention: bool = False
    # whole-layer fused kernel on the rollout column passes (ops/fused_block)
    use_fused_block: bool = False
    # whole-trunk-column kernel (ops/column_kernel): all num_agent_layers
    # x 3 sublayers of a token column in one launch
    use_column_kernel: bool = False
    # insertion seed evaluation as one kernel (ops/seed_kernel) instead of
    # the plain ops/seed_fast path, which it takes when off or when
    # use_grid_token is off
    use_seed_kernel: bool = False
    # fold the per-step eval precompute (occ embedding, geometry K/V
    # contributions, zero-agg key chains, agent K/V) into the seed kernel
    # too (seed_eval_full_kernel): one identical call per evaluation, only
    # raw inputs updated between insert iterations. Implies use_seed_kernel.
    use_seed_kernel_full: bool = False
    # fused per-insert heading/offset refine pass (ops/refine_kernel): the
    # whole subgraph refine (2*num_seed_layers attention sublayers +
    # zero-agg neighbor updates + both heads) in one pallas_call; requires
    # use_head_token and use_grid_token (the flagship setting)
    use_refine_kernel: bool = False
    # per-step cap on the per-insert refine map-token candidate set: the
    # NC nearest tokens to ego within pl2seed_radius + pl2sa_radius (every
    # insert lands <= pl2seed_radius from ego and its refine keys within
    # pl2sa_radius of the insert). Bitwise-identical to the full-P topk
    # whenever <= NC masked tokens are in that radius (candidates keep
    # original index order, so tie-breaks match). 0 disables the cap.
    # Default 0 = exact full-P refine (a dense >NC-token scene would
    # silently approximate); the flagship yamls opt into 512.
    refine_map_candidates: int = 0
    # run the insertion loop as a fixed-trip fori_loop (exactly insert_limit
    # iterations, all writes masked by a running flag) instead of the
    # early-exit while_loop. Bitwise-identical outputs (each while iteration
    # consumes >= 1 budget unit, so insert_limit trips is a strict upper
    # bound and frozen lanes select their old state, rng included). Under a
    # vmapped rollout the while_loop already runs to the max trip count
    # across lanes; the fixed form gives XLA a static trip count to pipeline
    # across at the cost of always paying the worst case per lane.
    insertion_fixed_trip: bool = False
    # unroll factor for the rollout `lax.scan` over token steps (lax.scan
    # unroll=N): duplicates the step body N times per loop trip so XLA can
    # schedule across adjacent steps. The carry dependence is serial, so any
    # win is overlap of per-step prep (neighbor topk, relation embeddings)
    # with the previous step's trunk. The port's eager loop does not read
    # it.
    rollout_scan_unroll: int = 1
    # rematerialize the attention layers in the training backward: each
    # DenseAttention keeps only its inputs and runs again in the backward
    # (torch.utils.checkpoint), trading compute for activation memory
    remat_attention: bool = True
    # Trainer mesh: {"data": d, "model": m}. data=0 means "all remaining
    # devices"; model>1 enables Megatron-style tensor parallelism over
    # attention heads + MLP (infgen_tpu/parallel/tp.py)
    mesh_shape: Dict[str, int] = field(default_factory=lambda: {"data": 0})
    # matmul compute dtype ("float32" | "bfloat16"); master params, LN stats,
    # softmax, and losses stay float32 (ops/precision.py)
    compute_dtype: str = "float32"
    # dtype params are stored in (checkpoints / inference-only deployments)
    param_dtype: str = "float32"
    seed: int = 2025

    # --- data ---
    train_raw_dir: Optional[str] = None
    val_raw_dir: Optional[str] = None
    train_batch_size: int = 1
    val_batch_size: int = 1
    num_workers: int = 0  # loader worker processes (reference Dataset yaml)
    prefetch_batches: int = 4  # device_put-staged batches ahead of the step

    @property
    def shift(self) -> int:
        return SHIFT

    @property
    def grid_size(self) -> int:
        """Number of in-disc grid cells. Mirrors Attr_Tokenizer (attr_tokenizer.py:24-43)."""
        num_grid = int(self.grid_range / self.grid_interval) + 1
        n = 0
        # count cells within radius pl2seed_radius of center
        half = num_grid // 2
        for i in range(num_grid):
            for j in range(num_grid):
                dx = (i - half) * self.grid_interval
                dy = (j - half) * self.grid_interval
                if math.sqrt(dx * dx + dy * dy) <= self.pl2seed_radius:
                    n += 1
        return n

    @property
    def angle_size(self) -> int:
        return int(360.0 / self.angle_interval)

    @property
    def num_infer_steps(self) -> int:
        """Token steps for closed-loop rollout (agent_decoder.py:1637)."""
        return (self.num_recurrent_steps_val + self.num_historical_steps) // SHIFT

    @property
    def num_hist_tokens(self) -> int:
        """History token steps: (11 - 1) // 5 = 2."""
        return (self.num_historical_steps - 1) // SHIFT

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)


def _flatten_reference_yaml(raw: Dict[str, Any]) -> Dict[str, Any]:
    """Accept both flat dicts and reference-style nested YAML (Model/Dataset/Trainer)."""
    out: Dict[str, Any] = {}
    known = {f.name for f in dataclasses.fields(Config)}

    def absorb(d: Dict[str, Any]):
        for k, v in d.items():
            if isinstance(v, dict) and k in ("Model", "Dataset", "Trainer", "decoder", "time_info"):
                absorb(v)
            elif k == "loss_weight" and isinstance(v, dict):
                lw_known = {f.name for f in dataclasses.fields(LossWeights)}
                out["loss_weight"] = LossWeights(**{kk: vv for kk, vv in v.items() if kk in lw_known})
            elif k in known:
                out[k] = v
            elif k == "disable_grid_token":
                out["use_grid_token"] = not v
            elif k == "disable_head_token":
                out["use_head_token"] = not v
            elif k == "disable_state_token":
                out["use_state_token"] = not v

    absorb(raw)
    return out


def load_config(path: str) -> Config:
    """Load YAML (flat or reference-style nested with anchors) into a Config."""
    with open(path, "r") as f:
        raw = yaml.safe_load(f)
    return Config(**_flatten_reference_yaml(raw))
