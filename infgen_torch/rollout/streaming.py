"""Streaming ("infinite") closed-loop generation at bounded memory (port of
infgen_tpu/rollout/streaming.py).

A rollout has a fixed horizon R and capacity (A, P); this module chains it
into a simulation of any length:

  run one R-frame segment -> take its last `num_historical_steps` frames as
  the next segment's history (tokenized again like logged history) -> free
  the slots of agents that exited -> compact the live rows into a prefix
  (`compact_scenario`) and re-bucket (`RolloutServer`) -> continue.

Device memory and host memory per segment stay O(R x bucket); the horizon
and the number of agents ever simulated are unbounded (dead slots are
recycled between segments). The temporal window makes the restart nearly
exact: the trunk attends to the last `time_span // SHIFT` token columns
only, so a segment boundary differs from one long rollout only through the
motion tokenizer's contour match of the seam's rolled-out poses.

Two ways to run it:
  StreamingRollout       the host loop: every segment through
                         RolloutServer.rollout (or .rollout_batch for a
                         fleet), compacted and re-bucketed at each boundary
  make_stream_fn         the device loop: `n_segments` segments back to back
                         at one capacity, the continuation on the device
                         (`continuation_device`), no compaction; the JAX
                         package's `lax.scan` over segments is a Python loop
                         here, its `vmap` over (scenario, key) the rollout's
                         lane axis. `make_chunked_stream_runner` re-buckets a
                         fleet between such chunks.
`stitch_stream_outputs` turns the device loop's stacked outputs into the
host loop's result: every agent that ever lived gets a global id (gid).

Seeds: where the JAX package splits a PRNG key once per segment, the port
derives segment `seg`'s seed from the stream's integer seed as
`seed_of(seed, seg)` (numpy's SeedSequence, 63 bits). The segment's map
mask draw and its rollout each take a torch.Generator of that seed, as the
JAX package drives both with the segment's one key. The chunked runner
gives lane i of chunk ci the stream seed `seed_of(seed, ci, i)`.
"""

from typing import Dict, Optional

import numpy as np
import torch

from infgen_torch.config import EXIT_STATE, INVALID_STATE
from infgen_torch.data.features import (build_model_inputs,
                                        build_model_inputs_batch)
from infgen_torch.data.scenario import (AgentData, Scenario, lane_of,
                                        stack_scenarios, to_device, tree_map)
from infgen_torch.rollout.serving import (RolloutServer, _device_of,
                                          _generator, compact_scenario,
                                          repad_scenario)


# the per-segment rollout outputs a stream keeps
_STREAM_KEYS = ("pred_traj", "pred_head", "pred_state", "slot_active",
                "pred_type", "pred_shape", "n_inserted")


def seed_of(*key) -> int:
    """A 63-bit generator seed from a key of non-negative integers."""
    return int(np.random.SeedSequence(list(key)).generate_state(
        1, np.uint64)[0] >> 1)


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def to_host(tree):
    """Every leaf of a NamedTuple tree as a numpy array."""
    return tree_map(_host, tree)


def _alive(active, last_state, is_ego):
    """Who survives a segment boundary (numpy or torch, any lane dims): an
    active row whose last state is neither INVALID nor EXIT; the ego
    always."""
    return (active & (last_state != INVALID_STATE)
            & (last_state != EXIT_STATE)) | is_ego


def continuation_scenario(prev: Scenario, out: Dict, num_historical_steps: int
                          ) -> Scenario:
    """The next segment's Scenario (numpy) from a rollout output (tensors
    or arrays, one scenario).

    The last `num_historical_steps` 10 Hz frames of the rollout become the
    new history; slots whose final state is INVALID or EXIT are freed
    (slot_mask False) so that compaction can recycle them; the ego never
    exits. Row i of the result is row i of the rollout output.
    """
    Hs = num_historical_steps
    traj = _host(out["pred_traj"])[:, -Hs:]                 # [A, Hs, 2]
    head = _host(out["pred_head"])[:, -Hs:]
    state = _host(out["pred_state"])[:, -Hs:]
    active = _host(out["slot_active"])
    A = traj.shape[0]

    # a frame is a real pose for every non-INVALID state (ENTER included:
    # the insertion records the agent's pose from its enter column; EXIT
    # frames still carry the final pose)
    valid = (state != INVALID_STATE) & active[:, None]
    av = int(_host(out["av_index"]))
    alive = _alive(active, state[:, -1], np.arange(A) == av)

    # 10 Hz finite-difference velocity, zeroed where either endpoint of the
    # difference is invalid (frame 0 copies frame 1's estimate)
    vel = np.zeros_like(traj)
    vel[:, 1:] = (traj[:, 1:] - traj[:, :-1]) * 10.0
    vel[:, 0] = vel[:, 1]
    pair_ok = valid.copy()
    pair_ok[:, 1:] &= valid[:, :-1]
    pair_ok[:, 0] = pair_ok[:, 1]
    vel = np.where(pair_ok[:, :, None], vel, 0.0)

    # elevation: the model is planar; carry the previous scenario's last
    # logged z forward for rows that had one, 0 for inserted agents
    prev_elev = _host(prev.agents.elevation)
    last_z = np.zeros((A,), np.float32)
    n = min(A, prev_elev.shape[0])
    pv = _host(prev.agents.valid)[:n]
    has = pv.any(axis=1)
    idx = np.where(has, pv.shape[1] - 1 - np.argmax(pv[:, ::-1], axis=1), 0)
    last_z[:n] = np.where(has, prev_elev[np.arange(n), idx], 0.0)
    elev = np.broadcast_to(last_z[:, None], (A, Hs)).copy()

    agents = AgentData(
        valid=valid & alive[:, None],
        position=np.where(valid[:, :, None], traj, 0.0).astype(np.float32),
        elevation=elev.astype(np.float32),
        heading=np.where(valid, head, 0.0).astype(np.float32),
        velocity=vel.astype(np.float32),
        shape=_host(out["pred_shape"]).astype(np.float32),
        type=_host(out["pred_type"]).astype(np.int32),
        slot_mask=alive,
        train_mask=alive,
        av_index=np.asarray(av, np.int32),
    )
    return Scenario(agents=agents, map=to_host(prev.map),
                    scenario_id=_host(prev.scenario_id))


def _stitch(bufs, G, fill):
    """Per-segment [G_seg, F] blocks over a common G rows (later segments
    know more agents; earlier blocks pad with `fill`: the agent did not
    exist yet), concatenated along frames."""
    out = []
    for b in bufs:
        if b.shape[0] < G:
            b = np.concatenate(
                [b, np.full((G - b.shape[0],) + b.shape[1:], fill, b.dtype)])
        out.append(b)
    return np.concatenate(out, axis=1)


class _Registry:
    """The global agent registry of one scenario's stream: every agent that
    ever lived has a gid, its type and shape, and its frames per segment."""

    def __init__(self, Hs: int):
        self.Hs = Hs
        self.blocks = dict(traj=[], head=[], state=[])      # [G, F] growing
        self.gid_type: list = []
        self.gid_shape: list = []
        self.per_segment: list = []

    def new_gid(self, type_, shape) -> int:
        self.gid_type.append(int(type_))
        self.gid_shape.append(np.asarray(shape))
        return len(self.gid_type) - 1

    def add_segment(self, out: Dict, row2gid: np.ndarray, seg: int
                    ) -> np.ndarray:
        """One segment's host output (one scenario) over the row -> gid map
        it started with (-1: no agent yet): an active row without a gid is a
        new agent; then every mapped row's frames are appended, the whole
        Hs + R span for segment 0 and only the R generated frames
        afterwards (the first Hs re-derive the previous segment's tail).
        Returns the completed map."""
        row2gid = row2gid.copy()
        active = out["slot_active"]
        for r in np.nonzero(active & (row2gid < 0))[0]:
            row2gid[r] = self.new_gid(out["pred_type"][r],
                                      out["pred_shape"][r])
        lo = 0 if seg == 0 else self.Hs
        G, rows = len(self.gid_type), np.nonzero(row2gid >= 0)[0]
        for key, fill in (("traj", 0.0), ("head", 0.0),
                          ("state", INVALID_STATE)):
            src = out[f"pred_{key}"][:, lo:]
            block = np.full((G,) + src.shape[1:], fill, src.dtype)
            block[row2gid[rows]] = src[rows]
            self.blocks[key].append(block)
        self.per_segment.append(dict(
            bucket=active.shape[0], n_alive=int(active.sum()),
            n_inserted=int(out["n_inserted"])))
        return row2gid

    def result(self, av_gid: int, R: int) -> Dict:
        G = len(self.gid_type)
        S = len(self.per_segment)
        return dict(
            traj=_stitch(self.blocks["traj"], G, 0.0).astype(np.float32),
            head=_stitch(self.blocks["head"], G, 0.0).astype(np.float32),
            state=_stitch(self.blocks["state"], G, INVALID_STATE),
            type=np.asarray(self.gid_type, np.int32),
            shape=np.asarray(self.gid_shape, np.float32).reshape(G, 3),
            av_gid=av_gid,
            segments=self.per_segment,
            frames_per_segment=[self.Hs + R] + [R] * (S - 1),
        )


class _ScenarioStream:
    """Host-side stream of one scenario across segments: the registry, and
    each segment's bucket rows mapped back to gids through the compaction
    permutations (a gid is stable through compaction)."""

    def __init__(self, scenario: Scenario, Hs: int):
        self.scen = to_host(scenario)
        self.Hs = Hs
        self.reg = _Registry(Hs)
        self.slot2gid: Optional[np.ndarray] = None          # row -> gid
        self.av_gid = None
        self._scen_c: Optional[Scenario] = None

    def begin_segment(self) -> Scenario:
        # compact live rows into a prefix so that bucket_for can shrink; the
        # server then re-pads to its bucket without reordering rows
        scen_c, perm = compact_scenario(self.scen)
        if self.slot2gid is None:
            # first segment: every compacted live row is a new gid
            n_live = int(np.asarray(scen_c.agents.slot_mask).sum())
            self.slot2gid = np.full((perm.shape[0],), -1, np.int64)
            for r in range(n_live):
                self.slot2gid[r] = self.reg.new_gid(
                    np.asarray(scen_c.agents.type)[r],
                    np.asarray(scen_c.agents.shape)[r])
        else:
            self.slot2gid = self.slot2gid[perm]
        self.av_gid = int(
            self.slot2gid[int(np.asarray(scen_c.agents.av_index))])
        assert self.av_gid >= 0
        self._scen_c = scen_c
        return scen_c

    def absorb(self, out: Dict, seg: int) -> None:
        if "slot_perm" in out:
            # a compacting server compacted the compacted scenario again:
            # the live rows must have kept their places
            n_live = int(np.asarray(self._scen_c.agents.slot_mask).sum())
            assert np.array_equal(np.asarray(out["slot_perm"])[:n_live],
                                  np.arange(n_live)), "rows reordered"
        out = {k: _host(out[k]) for k in _STREAM_KEYS + ("av_index",)}
        # bucket rows beyond the previous capacity start unmapped
        A_b = out["pred_traj"].shape[0]
        row2gid = np.full((A_b,), -1, np.int64)
        n_map = min(A_b, self.slot2gid.shape[0])
        row2gid[:n_map] = self.slot2gid[:n_map]
        row2gid = self.reg.add_segment(out, row2gid, seg)

        self.scen = continuation_scenario(self._scen_c, out, self.Hs)
        # rows that did not survive the boundary lose their gid: a later
        # insertion into their slot is a NEW agent, not a resurrection
        self.slot2gid = np.where(np.asarray(self.scen.agents.slot_mask),
                                 row2gid, -1)

    def result(self, R: int) -> Dict:
        return self.reg.result(self.av_gid, R)


class StreamingRollout:
    """Drive a simulation of any length through a RolloutServer.

    `run` streams one scenario through the server's single rollouts;
    `run_batch` streams many at once, each segment dispatched through
    `RolloutServer.rollout_batch`, so scenarios sharing a capacity bucket
    run as lanes of one rollout and re-bucket independently as their live
    counts drift. Every kernel flag runs its lanes in one launch per call.

    Results are numpy arrays over [G, F] (G = agents ever alive, F = 10 Hz
    frames). `host_reads` holds the last run's rollout host reads.
    """

    def __init__(self, server: RolloutServer, segment_steps: int):
        if server.num_recurrent_steps not in (None, segment_steps):
            raise ValueError("server.num_recurrent_steps must match "
                             "segment_steps")
        self.server = server
        if server.num_recurrent_steps is None:
            server.num_recurrent_steps = segment_steps
        self.R = segment_steps
        self.Hs = server.cfg.num_historical_steps
        self.host_reads = 0

    def run(self, model, scenario: Scenario, seed: int,
            total_steps: int, on_segment=None) -> Dict:
        """Simulate >= total_steps future 10 Hz frames (rounded up to whole
        segments) of one scenario. Returns the stitched global registry.
        `on_segment(seg, scenario, seed, out)`, when given, is called after
        each segment's rollout with the (compacted) scenario it started
        from, its seed and its output: a check can run the same segment
        elsewhere from the same start."""
        n_seg = -(-total_steps // self.R)
        stream = _ScenarioStream(scenario, self.Hs)
        self.host_reads = 0
        for seg in range(n_seg):
            scen_c = stream.begin_segment()
            k = seed_of(seed, seg)
            out = self.server.rollout(model, scen_c, k, input_seed=k)
            self.host_reads += self.server.last_dispatch["host_reads"]
            if on_segment is not None:
                on_segment(seg, scen_c, k, out)
            stream.absorb(out, seg)
        return stream.result(self.R)

    def run_batch(self, model, scenarios, seeds, total_steps: int) -> list:
        """Stream a fleet; one result dict per scenario (`run`'s schema).
        `seeds`: one stream seed per scenario."""
        n_seg = -(-total_steps // self.R)
        streams = [_ScenarioStream(s, self.Hs) for s in scenarios]
        seeds = [int(s) for s in seeds]
        if len(seeds) != len(streams):
            raise ValueError(f"{len(seeds)} seeds for {len(streams)} "
                             "scenarios")
        self.host_reads = 0
        for seg in range(n_seg):
            keys = [seed_of(s, seg) for s in seeds]
            scens_c = [st.begin_segment() for st in streams]
            outs = self.server.rollout_batch(model, scens_c, keys,
                                             input_seeds=keys)
            self.host_reads += self.server.last_dispatch["host_reads"]
            for st, out in zip(streams, outs):
                st.absorb(out, seg)
        return [st.result(self.R) for st in streams]


# --------------------------------------------------------------------- #
# The device loop: segments back to back at one capacity, the continuation
# (`continuation_device`) and the input chain (`build_model_inputs`: motion
# tokenization, enterings, map masks) on the device, nothing read back
# between segments beyond the rollout's own insertion-loop reads. Slots are
# not compacted inside a chunk (row identity is stable; freed slots are
# re-activated in place by later insertions), so re-bucketing to a smaller
# capacity happens between chunks (`make_chunked_stream_runner`).
# --------------------------------------------------------------------- #


def continuation_device(prev: Scenario, out: Dict,
                        num_historical_steps: int) -> Scenario:
    """`continuation_scenario` in torch ops on the output's device, with no
    host read, bit for bit the same arrays. Any leading lane dims; out's
    capacity must be prev's."""
    Hs = num_historical_steps
    traj = out["pred_traj"][..., -Hs:, :]
    head = out["pred_head"][..., -Hs:]
    state = out["pred_state"][..., -Hs:]
    active = out["slot_active"]
    A = traj.shape[-3]
    dev = traj.device

    valid = (state != INVALID_STATE) & active[..., None]
    av = out["av_index"].long()
    alive = _alive(active, state[..., -1],
                   torch.arange(A, device=dev) == av[..., None])

    diff = (traj[..., 1:, :] - traj[..., :-1, :]) * 10.0
    vel = torch.cat([diff[..., :1, :], diff], dim=-2)
    po = valid[..., 1:] & valid[..., :-1]
    pair_ok = torch.cat([po[..., :1], po], dim=-1)
    vel = torch.where(pair_ok[..., None], vel, 0.0)

    prev_elev = prev.agents.elevation
    pv = prev.agents.valid
    has = pv.any(-1)
    T = pv.shape[-1]
    idx = torch.where(
        has, T - 1 - torch.argmax(pv.flip(-1).to(torch.int32), dim=-1), 0)
    last_z = torch.where(
        has, torch.gather(prev_elev, -1, idx[..., None])[..., 0], 0.0)
    elev = last_z[..., None].expand(*last_z.shape, Hs)

    agents = AgentData(
        valid=valid & alive[..., None],
        position=torch.where(valid[..., None], traj, 0.0).float(),
        elevation=elev.float().contiguous(),
        heading=torch.where(valid, head, 0.0).float(),
        velocity=vel.float(),
        shape=out["pred_shape"].float(),
        type=out["pred_type"].to(torch.int32),
        slot_mask=alive,
        train_mask=alive,
        av_index=av.to(torch.int32),
    )
    return Scenario(agents=agents, map=prev.map,
                    scenario_id=prev.scenario_id)


def make_stream_fn(model, cfg, attr, motion_tok, map_vocab,
                   segment_steps: int, n_segments: int,
                   return_final: bool = False, force_insert: bool = False):
    """Build `stream(scenario, seed) -> dict` running `n_segments`
    closed-loop segments of `segment_steps` 10 Hz frames back to back on
    the model's device, at the scenario's capacity (cfg.max_agents).

    Segment seg takes the seed `seed_of(seed, seg)` for its input draw and
    its rollout, as `StreamingRollout.run` does (without its compaction).
    Returns stacked outputs: pred_traj [S, A, Hs+R, 2], pred_head /
    pred_state [S, A, Hs+R], slot_active / pred_type [S, A], pred_shape [S,
    A, 3], n_inserted [S], av_index []; `stitch_stream_outputs` makes the
    global registry of them. With a list of seeds, one per lane, `scenario`
    is a stack of scenarios (stack_scenarios) and every output gains a
    leading lane axis: the JAX package's `vmap` of its stream function.

    return_final=True adds "final_agents": the AgentData of the
    continuation after the last segment ([A, Hs] history), from which a
    caller on the host compacts and re-buckets the fleet for another chunk.
    `stream(..., on_segment=f)` calls f(seg, scenario, seed, out) after each
    segment's rollout, as `StreamingRollout.run` does (one lane: the
    scenario on the device, the segment's seed).
    `stream.host_reads` counts the rollouts' host reads of the last call.
    """
    from infgen_torch.rollout.closed_loop import make_rollout_fn

    Hs = cfg.num_historical_steps
    roll = make_rollout_fn(model, cfg, attr, motion_tok, map_vocab,
                           num_recurrent_steps=segment_steps,
                           force_insert=force_insert)
    dev = _device_of(model)

    def stream(scenario, seed, on_segment=None):
        lanes = isinstance(seed, (list, tuple))
        seeds = [int(s) for s in seed] if lanes else [int(seed)]
        scen = to_device(scenario, dev)
        stream.host_reads = 0
        outs, av = [], None
        for seg in range(n_segments):
            keys = [seed_of(s, seg) for s in seeds]
            if lanes:
                inputs = build_model_inputs_batch(
                    cfg, motion_tok, attr, scen,
                    [_generator(dev, k) for k in keys])
                out = roll(scen, inputs, [_generator(dev, k) for k in keys])
            else:
                inputs = build_model_inputs(cfg, motion_tok, attr, scen,
                                            _generator(dev, keys[0]))
                out = roll(scen, inputs, _generator(dev, keys[0]))
            stream.host_reads += roll.host_reads
            if on_segment is not None:
                on_segment(seg, scen, keys if lanes else keys[0], out)
            outs.append({k: out[k] for k in _STREAM_KEYS})
            av = out["av_index"]
            scen = continuation_device(scen, out, Hs)
        axis = 1 if lanes else 0
        stacked = {k: torch.stack([o[k] for o in outs], axis)
                   for k in _STREAM_KEYS}
        stacked["av_index"] = av
        if return_final:
            stacked["final_agents"] = scen.agents
        return stacked

    stream.host_reads = 0
    return stream


def _new_gids(out: Dict):
    """Per lane of a chunk's stacked outputs ([B, S, A, ...]): the gids its
    stitched registry gives (rows active in its first segment, then in
    each later segment the active rows that did not survive the boundary
    before it), and the rows alive after its last segment."""
    active = out["slot_active"]
    alive = _alive(active, out["pred_state"][..., -1],
                   torch.arange(active.shape[-1], device=active.device)
                   == out["av_index"].long()[:, None, None])
    new = torch.cat([active[:, :1], active[:, 1:] & ~alive[:, :-1]], 1)
    return new.sum((1, 2)), alive[:, -1].sum(-1)


def make_chunked_stream_runner(cfg, attr, motion_tok, map_vocab,
                               segment_steps: int):
    """A host loop over a fleet stream in device-loop chunks: run each
    `(A_bucket, n_segments)` chunk of a plan through a `make_stream_fn`
    over the fleet's lanes, and between chunks compact the exited slots and
    re-bucket the fleet (the only data read back between chunks: the
    [A, Hs] continuation history of each lane).

    Returns `run(model, scenarios, plan, seed) -> (chunk_outs, buckets)`:
    chunk outputs with a leading lane axis ([B, n_segments, A_bucket, ...])
    on the device, and the capacity each chunk ran at. When a chunk's
    survivors do not fit its planned bucket it runs at full capacity
    (cfg.max_agents) instead. One stream function per (A, n_segments) is
    built at first use and kept across calls. `run.host_reads` counts the
    last call's rollout host reads; `run.agents_ever_alive` holds, per lane,
    the agents it simulated: the gids its chunks' stitched registries hold
    together less the survivors each chunk took over from the one before,
    counted on the device (`_new_gids`) and read once at the end.
    """
    fns = {}

    def stream_fn(model, A_c, n_seg):
        entry = fns.get((A_c, n_seg))
        if entry is None or entry[0] is not model:
            cfg_c = cfg.replace(max_agents=A_c)
            entry = fns[(A_c, n_seg)] = (model, make_stream_fn(
                model, cfg_c, attr, motion_tok, map_vocab,
                segment_steps=segment_steps, n_segments=n_seg,
                return_final=True))
        return entry[1]

    def run(model, scenarios, plan, seed):
        cur, outs, used = [to_host(s) for s in scenarios], [], []
        run.host_reads = 0
        ever = 0
        for ci, (A_c, n_seg) in enumerate(plan):
            comp = [compact_scenario(s)[0] for s in cur]
            n_live = max(int(np.asarray(s.agents.slot_mask).sum())
                         for s in comp)
            if n_live > A_c:            # too many survivors for the planned
                A_c = cfg.max_agents    # bucket: fall back to full capacity
            cur = [repad_scenario(s, A_c, cfg.max_map_tokens) for s in comp]
            fn = stream_fn(model, A_c, n_seg)
            out = fn(stack_scenarios(cur),
                     [seed_of(seed, ci, i) for i in range(len(cur))])
            run.host_reads += fn.host_reads
            new, survivors = _new_gids(out)
            ever = ever + new - (survivors if ci + 1 < len(plan) else 0)
            fin = out.pop("final_agents")
            if ci + 1 < len(plan):
                fin = to_host(fin)
                cur = [Scenario(agents=lane_of(fin, i), map=cur[i].map,
                                scenario_id=cur[i].scenario_id)
                       for i in range(len(cur))]
            used.append(A_c)
            outs.append(out)
        run.agents_ever_alive = ever.tolist()         # one host read
        return outs, used

    run.host_reads = 0
    run.agents_ever_alive = []
    return run


def stitch_stream_outputs(stacked: Dict, num_historical_steps: int) -> Dict:
    """Host-side global agent registry of one scenario's `make_stream_fn`
    outputs (tensors or arrays, no lane axis), in `StreamingRollout.run`'s
    result schema. Rows are slot-stable across segments (no compaction
    inside a chunk); a freed slot re-activated by a later insertion becomes
    a NEW agent, as at the host loop's segment boundaries."""
    Hs = num_historical_steps
    stacked = {k: _host(v) for k, v in stacked.items()
               if k != "final_agents"}
    state = stacked["pred_state"]
    S, A, F = state.shape
    R = F - Hs
    av = int(stacked["av_index"])

    reg = _Registry(Hs)
    row2gid = np.full((A,), -1, np.int64)
    av_gid = None
    for seg in range(S):
        out = {k: stacked[k][seg] for k in _STREAM_KEYS}
        row2gid = reg.add_segment(out, row2gid, seg)
        if av_gid is None:
            av_gid = int(row2gid[av])
            assert av_gid >= 0
        # survival across the boundary: continuation_device's rule
        row2gid = np.where(_alive(out["slot_active"], out["pred_state"][:, -1],
                                  np.arange(A) == av), row2gid, -1)
    return reg.result(av_gid, R)
