"""Fixed-shape scenario containers (port of infgen_tpu/data/scenario.py),
and the two NamedTuples built from them: the motion tokenizer's
`TokenizedAgents` and the model's `ModelInputs` (data/features.py), kept
here so that code which only carries them (an exported rollout's loader,
rollout/export.py) imports neither the tokenizers nor the model.

`build_scenario` pads host-side numpy arrays to static shapes, as the JAX
package does; `to_device` turns every leaf into a tensor on one device.
`stack_scenarios` puts a leading lane axis on a list of such trees (the
batched rollout's input) and `lane_of` takes one lane back out.
  A  = cfg.max_agents      agent slots
  T10= raw 10 Hz steps     (91 for WOMD 9.1 s logs)
  P  = cfg.max_map_tokens  map ("pt") tokens per scenario
"""

from typing import NamedTuple

import numpy as np
import torch


class AgentData(NamedTuple):
    valid: object       # [A, T10] bool
    position: object    # [A, T10, 2] f32
    elevation: object   # [A, T10] f32
    heading: object     # [A, T10] f32
    velocity: object    # [A, T10, 2] f32
    shape: object       # [A, 3] f32 (length, width, height)
    type: object        # [A] int32: 0 veh / 1 ped / 2 cyc
    slot_mask: object   # [A] bool
    train_mask: object  # [A] bool
    av_index: object    # [] int32 ego slot


class MapData(NamedTuple):
    position: object     # [P, 2] f32
    orientation: object  # [P] f32
    token_idx: object    # [P] int32
    pt_type: object      # [P] int32
    pt_side: object      # [P] int32
    pl_type: object      # [P] int32
    light_type: object   # [P] int32
    chain_id: object     # [P] int32
    chain_pos: object    # [P] int32
    mask: object         # [P] bool


class Scenario(NamedTuple):
    agents: AgentData
    map: MapData
    scenario_id: object  # [] int32


class TokenizedAgents(NamedTuple):
    """The motion tokenizer's output (tokenizers/motion_tokenizer.py)."""

    token_idx: torch.Tensor        # [A, T] int32; -1 invalid, -2 enter(bos)
    state_idx: torch.Tensor        # [A, T] int32
    token_pos: torch.Tensor        # [A, T, 2]
    token_heading: torch.Tensor    # [A, T]
    token_contour: torch.Tensor    # [A, T, 4, 2]
    token_valid: torch.Tensor      # [A, T] bool (enter steps forced False)
    raw_token_valid: torch.Tensor  # [A, T] bool


class ModelInputs(NamedTuple):
    """Everything the decoder consumes for one scenario. T token steps."""

    tokens: TokenizedAgents
    grid_token_idx: torch.Tensor     # [A, T] int32, -1 out of range/invalid
    grid_offset_xy: torch.Tensor     # [A, T, 2]
    heading_token_idx: torch.Tensor  # [A, T] int32
    pos_xy: torch.Tensor             # [A, T, 2] ego-relative raw offset
    heading_theta: torch.Tensor      # [A, T] wrapped relative heading
    sort_indices: torch.Tensor       # [A, T] int32 ego-angle order of enterers
    inrange_mask: torch.Tensor       # [A, T] bool
    bos_mask: torch.Tensor           # [A, T] bool
    pt_grid_token_idx: torch.Tensor  # [T, P] int32, -1 outside
    ego_pos: torch.Tensor            # [T, 2]
    ego_head: torch.Tensor           # [T]
    agent_shape: torch.Tensor        # [A, 3]
    agent_type: torch.Tensor         # [A]
    av_index: torch.Tensor           # []
    slot_mask: torch.Tensor          # [A]
    train_mask: torch.Tensor         # [A]
    pt_valid_mask: torch.Tensor      # [P] bool
    pt_pred_mask: torch.Tensor       # [P] bool
    pt_target_mask: torch.Tensor     # [P] bool
    pt_next_token_idx: torch.Tensor  # [P] int32 successor token id (-1 none)


def tree_map(fn, *trees):
    """fn over the leaves of NamedTuple trees of one structure."""
    t = trees[0]
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*(tree_map(fn, *xs) for xs in zip(*trees)))
    return fn(*trees)


def to_device(tree, device):
    """Every array leaf of a NamedTuple tree -> a tensor on `device`."""
    return tree_map(lambda x: torch.as_tensor(np.asarray(x), device=device),
                    tree)


def stack_scenarios(trees):
    """Stack a list of NamedTuple trees (Scenario, ModelInputs, ...) into
    one with a leading lane axis: numpy leaves host-side with np.stack (the
    port's copy of infgen_tpu/train/train_step.py::stack_scenarios),
    tensors with torch.stack."""
    def stack(*xs):
        if isinstance(xs[0], torch.Tensor):
            return torch.stack(xs)
        return np.stack([np.asarray(x) for x in xs])
    return tree_map(stack, *trees)


def lane_of(tree, i: int):
    """Lane `i` of a stacked tree (stack_scenarios' inverse, one lane)."""
    return tree_map(lambda x: x[i], tree)


def pad_axis(x: np.ndarray, size: int, axis: int = 0, fill=0):
    """Pad (or truncate) `x` along `axis` to `size` with `fill`."""
    x = np.asarray(x)
    n = x.shape[axis]
    if n == size:
        return x
    if n > size:
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(0, size)
        return x[tuple(sl)]
    pad_width = [(0, 0)] * x.ndim
    pad_width[axis] = (0, size - n)
    return np.pad(x, pad_width, constant_values=fill)


def build_scenario(agent_arrays: dict, map_arrays: dict, max_agents: int,
                   max_map_tokens: int, scenario_id: int = 0) -> Scenario:
    """Pad host-side numpy dicts into a fixed-shape Scenario of numpy."""
    A = max_agents
    P = max_map_tokens
    n_agent = agent_arrays["valid"].shape[0]
    n_pt = map_arrays["position"].shape[0]
    agents = AgentData(
        valid=pad_axis(agent_arrays["valid"], A).astype(bool),
        position=pad_axis(agent_arrays["position"], A).astype(np.float32),
        elevation=pad_axis(agent_arrays.get(
            "elevation",
            np.zeros(agent_arrays["valid"].shape, np.float32)), A
        ).astype(np.float32),
        heading=pad_axis(agent_arrays["heading"], A).astype(np.float32),
        velocity=pad_axis(agent_arrays["velocity"], A).astype(np.float32),
        shape=pad_axis(agent_arrays["shape"], A).astype(np.float32),
        type=pad_axis(agent_arrays["type"], A).astype(np.int32),
        slot_mask=np.arange(A) < n_agent,
        train_mask=pad_axis(agent_arrays.get(
            "train_mask", np.ones(n_agent, bool)), A).astype(bool),
        av_index=np.asarray(agent_arrays["av_index"], np.int32),
    )
    maps = MapData(
        position=pad_axis(map_arrays["position"], P).astype(np.float32),
        orientation=pad_axis(map_arrays["orientation"], P).astype(np.float32),
        token_idx=pad_axis(map_arrays["token_idx"], P).astype(np.int32),
        pt_type=pad_axis(map_arrays["pt_type"], P).astype(np.int32),
        pt_side=pad_axis(map_arrays["pt_side"], P).astype(np.int32),
        pl_type=pad_axis(map_arrays["pl_type"], P).astype(np.int32),
        light_type=pad_axis(map_arrays["light_type"], P).astype(np.int32),
        chain_id=pad_axis(map_arrays["chain_id"], P, fill=-1).astype(np.int32),
        chain_pos=pad_axis(map_arrays["chain_pos"], P,
                           fill=-1).astype(np.int32),
        mask=np.arange(P) < n_pt,
    )
    return Scenario(agents=agents, map=maps,
                    scenario_id=np.asarray(scenario_id, np.int32))
