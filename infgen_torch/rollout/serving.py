"""Occupancy-bucketed rollout serving (port of infgen_tpu/rollout/serving.py).

A rollout's cost follows its capacity, `max_agents` x `max_map_tokens`: a
20-agent scene at A = 128 spends most of its attention and matmul work on
inactive slots. The server keeps one rollout function per (A, P) capacity
bucket and dispatches each scenario to the smallest bucket that holds its
live agents (plus insertion headroom) and its map tokens. The parameters do
not depend on capacity, so one `nn.Module` serves every bucket; a
per-(A, P) rollout function takes the place of the JAX package's
per-bucket executable, and one function serves every batch size (its
lane axis).

Semantics per bucket are the rollout's at that capacity: a smaller bucket
saturates insertion sooner. Pick `agent_headroom` accordingly.

Random streams: where the JAX package takes PRNG keys, this port takes
integer seeds, from which it makes one `torch.Generator` per scenario on
the model's device (one for the inputs' map-mask draw, one for the
rollout). A scenario rolled out alone and as a lane of a batch, with the
same seeds and bucket, gives the same decisions. The JAX package's mesh
arguments (`mesh`, `param_shardings`) are left out: this serves one card.
"""

import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from infgen_torch.config import INVALID_STATE, SHIFT, Config
from infgen_torch.data.features import (build_model_inputs,
                                        build_model_inputs_batch)
from infgen_torch.data.scenario import (AgentData, MapData, Scenario,
                                        pad_axis, stack_scenarios, to_device)


def repad_scenario(scenario: Scenario, max_agents: int,
                   max_map_tokens: int) -> Scenario:
    """Re-pad a fixed-shape Scenario of numpy arrays to a different (A, P)
    capacity. Shrinking requires that all real agents / map tokens still
    fit: real rows are never truncated (asserts host-side)."""
    ag, mp = scenario.agents, scenario.map
    # check the masks BEYOND the cut, not just counts: real rows may sit in
    # non-contiguous slots (e.g. after a rollout activated high slots)
    slot_mask = np.asarray(ag.slot_mask)
    pt_mask = np.asarray(mp.mask)
    assert not slot_mask[max_agents:].any(), (
        f"real agent rows beyond slot {max_agents}")
    assert not pt_mask[max_map_tokens:].any(), (
        f"real map tokens beyond index {max_map_tokens}")
    assert int(np.asarray(ag.av_index)) < max_agents

    def rag(x):
        return pad_axis(np.asarray(x), max_agents)

    agents = AgentData(
        valid=rag(ag.valid), position=rag(ag.position),
        elevation=rag(ag.elevation), heading=rag(ag.heading),
        velocity=rag(ag.velocity), shape=rag(ag.shape), type=rag(ag.type),
        slot_mask=rag(ag.slot_mask), train_mask=rag(ag.train_mask),
        av_index=np.asarray(ag.av_index))

    def rpt(x, fill=0):
        return pad_axis(np.asarray(x), max_map_tokens, fill=fill)

    maps = MapData(
        position=rpt(mp.position), orientation=rpt(mp.orientation),
        token_idx=rpt(mp.token_idx), pt_type=rpt(mp.pt_type),
        pt_side=rpt(mp.pt_side), pl_type=rpt(mp.pl_type),
        light_type=rpt(mp.light_type), chain_id=rpt(mp.chain_id, fill=-1),
        chain_pos=rpt(mp.chain_pos, fill=-1), mask=rpt(mp.mask))
    return Scenario(agents=agents, map=maps, scenario_id=scenario.scenario_id)


def compact_scenario(scenario: Scenario) -> Tuple[Scenario, np.ndarray]:
    """Pack live agent rows into a contiguous prefix (stable order).

    Scenarios resumed from a prior rollout can have live rows scattered
    across high slot indices, which forces `bucket_for` (it honours the
    highest real row, not the count) into a large bucket. Compaction
    permutes the agent axis so the N live rows occupy slots [0, N); the
    rollout is permutation-equivariant over agent slots.

    Returns (compacted scenario, perm) with perm[i] = original row index of
    new row i.
    """
    ag = scenario.agents
    mask = np.asarray(ag.slot_mask)
    perm = np.concatenate([np.nonzero(mask)[0], np.nonzero(~mask)[0]])

    def pg(x):
        return np.asarray(x)[perm]

    agents = AgentData(
        valid=pg(ag.valid), position=pg(ag.position),
        elevation=pg(ag.elevation), heading=pg(ag.heading),
        velocity=pg(ag.velocity), shape=pg(ag.shape), type=pg(ag.type),
        slot_mask=pg(ag.slot_mask), train_mask=pg(ag.train_mask),
        av_index=np.asarray(
            int(np.nonzero(perm == int(np.asarray(ag.av_index)))[0][0])))
    return scenario._replace(agents=agents), perm


def _live(scenario: Scenario) -> int:
    return int(np.asarray(scenario.agents.slot_mask).sum())


def _rows_needed(scenario: Scenario) -> Tuple[int, int]:
    """(highest real agent row + 1, highest real map token + 1)."""
    slot_mask = np.asarray(scenario.agents.slot_mask)
    pt_mask = np.asarray(scenario.map.mask)
    return (int(np.max(np.nonzero(slot_mask)[0], initial=-1)) + 1,
            int(np.max(np.nonzero(pt_mask)[0], initial=-1)) + 1)


class RolloutServer:
    """Dispatch scenarios (numpy Scenario trees) to the smallest rollout
    capacity that fits them. One instance owns the tokenizers and a cache of
    rollout functions keyed by (A, P), built at first use; every method
    takes the model (an InfGenModel on the device to serve on)."""

    def __init__(self, cfg: Config, attr, motion_tok, map_vocab,
                 agent_buckets: Sequence[int] = (32, 64, 128),
                 map_buckets: Optional[Sequence[int]] = None,
                 agent_headroom: int = 8,
                 num_recurrent_steps: Optional[int] = None,
                 force_insert: bool = False,
                 compact: bool = False,
                 bucket_cost_ms: Optional[Dict[int, float]] = None):
        self.cfg = cfg
        self.attr = attr
        self.motion_tok = motion_tok
        self.map_vocab = map_vocab
        self.agent_buckets = sorted(set(
            min(b, cfg.max_agents) for b in agent_buckets) | {cfg.max_agents})
        self.map_buckets = sorted(set(
            min(b, cfg.max_map_tokens) for b in
            (map_buckets or [cfg.max_map_tokens])) | {cfg.max_map_tokens})
        self.agent_headroom = agent_headroom
        self.num_recurrent_steps = num_recurrent_steps
        self.force_insert = force_insert
        # compact live rows into a prefix before bucketing
        # (compact_scenario); each output dict then gains "slot_perm" (new
        # row i = original agent slot_perm[i] for initially-live rows; -1
        # beyond the live count)
        self.compact = compact
        # measured per-bucket rollout cost (ms) on the serving hardware:
        # capacity order alone can pick a bucket that costs as much as a
        # larger one while capping insertion. When set, bucket_for picks the
        # cheapest feasible bucket and breaks near-ties (<= 3%) toward the
        # LARGER capacity (free headroom). Fill it with calibrate() or a
        # measured table; None = capacity order.
        self.bucket_cost_ms = dict(bucket_cost_ms) if bucket_cost_ms else None
        self._fns: Dict[Tuple[int, int], Tuple] = {}
        # the last rollout / rollout_batch call's dispatch: one (A, P,
        # lanes, real scenarios) per batch, and the host reads of its
        # rollouts; rollout_batch also records each batch's wall time
        # (batch_ms, input building included) and the agent-steps of its
        # real scenarios (batch_agent_steps)
        self.last_dispatch = dict(batches=[], host_reads=0)

    def bucket_for(self, scenario: Scenario) -> Tuple[int, int]:
        # highest real row +1, not the count: real rows may be non-contiguous
        n_agent, n_pt = _rows_needed(scenario)
        if n_agent > self.agent_buckets[-1] or n_pt > self.map_buckets[-1]:
            raise ValueError(
                f"scenario needs (A>={n_agent}, P>={n_pt}) but the largest "
                f"bucket is {(self.agent_buckets[-1], self.map_buckets[-1])}")
        need_a = n_agent + self.agent_headroom
        feasible = [b for b in self.agent_buckets
                    if b >= max(need_a, n_agent)] or [self.agent_buckets[-1]]
        costs = self.bucket_cost_ms
        if costs and all(b in costs for b in feasible):
            # cheapest feasible; within 3% of the cheapest, prefer the
            # LARGEST capacity: same wall clock, more insertion headroom
            cmin = min(costs[b] for b in feasible)
            A = max(b for b in feasible if costs[b] <= 1.03 * cmin)
        else:
            A = feasible[0]
        P = next((b for b in self.map_buckets if b >= n_pt),
                 self.map_buckets[-1])
        return A, P

    def calibrate(self, model, scenario: Scenario, seed: int = 0,
                  n_rep: int = 3) -> Dict[int, float]:
        """Measure each agent bucket's rollout wall clock on the model's
        device with a representative scenario, and install the table for
        bucket_for. One warm-up rollout, then the mean of n_rep; returns
        {A: ms}."""
        dev = _device_of(model)
        scenario, _ = self._maybe_compact(scenario)
        P = self.map_buckets[-1]
        n_agent = _rows_needed(scenario)[0]
        table: Dict[int, float] = {}
        for A in self.agent_buckets:
            if A < n_agent:
                continue
            fn, cfg = self._get(model, A, P)
            scen = to_device(repad_scenario(scenario, A, P), dev)
            inputs = build_model_inputs(cfg, self.motion_tok, self.attr,
                                        scen, _generator(dev, seed))
            fn(scen, inputs, _generator(dev, seed))
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(n_rep):
                fn(scen, inputs, _generator(dev, seed))
            _sync(dev)
            table[A] = (time.perf_counter() - t0) / n_rep * 1e3
        self.bucket_cost_ms = table
        return table

    def _get(self, model, A: int, P: int):
        """(rollout function, bucket config) of capacity (A, P) for
        `model` (rebuilt when another model is passed)."""
        entry = self._fns.get((A, P))
        if entry is None or entry[0] is not model:
            from infgen_torch.rollout.closed_loop import make_rollout_fn

            cfg = self.cfg.replace(max_agents=A, max_map_tokens=P)
            fn = make_rollout_fn(model, cfg, self.attr, self.motion_tok,
                                 self.map_vocab,
                                 num_recurrent_steps=self.num_recurrent_steps,
                                 force_insert=self.force_insert)
            entry = self._fns[(A, P)] = (model, fn, cfg)
        return entry[1], entry[2]

    def rollout(self, model, scenario: Scenario, seed: int,
                input_seed: Optional[int] = None) -> Dict:
        """Run one scenario at its bucket capacity. Output tensors are
        shaped to the chosen bucket (out["pred_traj"].shape[0] == bucket
        A)."""
        dev = _device_of(model)
        scenario, perm = self._maybe_compact(scenario)
        A, P = self.bucket_for(scenario)
        fn, cfg = self._get(model, A, P)
        scen = to_device(repad_scenario(scenario, A, P), dev)
        inputs = build_model_inputs(
            cfg, self.motion_tok, self.attr, scen,
            _generator(dev, seed if input_seed is None else input_seed))
        out = fn(scen, inputs, _generator(dev, seed))
        self.last_dispatch = dict(batches=[(A, P, 1, 1)],
                                  host_reads=fn.host_reads)
        if perm is not None:
            out = dict(out, slot_perm=self._perm_out(perm, A,
                                                     _live(scenario)))
        return out

    def _maybe_compact(self, scenario: Scenario):
        if not self.compact:
            return scenario, None
        return compact_scenario(scenario)

    @staticmethod
    def _perm_out(perm: np.ndarray, A: int, n_live: int) -> np.ndarray:
        """slot_perm[i] = original row of compacted row i for LIVE rows
        only; -1 beyond the live count (compact_scenario's full permutation
        places dead original slots inside the bucket: emitting those would
        mis-attribute padded or inserted rows)."""
        out = np.full((A,), -1, np.int64)
        n = min(A, perm.shape[0], n_live)
        out[:n] = perm[:n]
        return out

    def rollout_batch(self, model, scenarios: Sequence[Scenario], seeds,
                      input_seeds=None, max_batch: Optional[int] = None,
                      order_by_occupancy: bool = True) -> list:
        """Batched dispatch: group scenarios by capacity bucket, run each
        group as one rollout over a lane axis at the next batch-size bucket
        (powers of two), and return one output dict per scenario in input
        order.

        `seeds` is one integer (scenario i then takes seeds + i) or a
        sequence of per-scenario seeds; `input_seeds` likewise (default:
        the rollout seeds). Tail lanes of a padded batch re-run the group's
        last scenario and are discarded.

        `max_batch` chunks each bucket group into sub-batches of at most
        that many scenarios. With `order_by_occupancy`, group members are
        sorted by live-agent count (descending) first, so each sub-batch is
        homogeneous in free-slot count, the proxy for insertion activity:
        the insertion loop runs until every lane stops inserting, so one
        insertion-heavy scene holds its whole sub-batch.
        """
        n = len(scenarios)
        dev = _device_of(model)

        def per_scenario(s):
            if isinstance(s, (int, np.integer)):
                return [int(s) + i for i in range(n)]
            s = [int(x) for x in s]
            if len(s) != n:
                raise ValueError(f"{len(s)} seeds for {n} scenarios")
            return s

        seeds = per_scenario(seeds)
        input_seeds = seeds if input_seeds is None \
            else per_scenario(input_seeds)
        perms = [None] * n
        if self.compact:
            pairs = [compact_scenario(s) for s in scenarios]
            scenarios = [p[0] for p in pairs]
            perms = [p[1] for p in pairs]
        groups: Dict[Tuple[int, int], list] = {}
        for i, s in enumerate(scenarios):
            groups.setdefault(self.bucket_for(s), []).append(i)

        results: list = [None] * n
        self.last_dispatch = dict(batches=[], host_reads=0, batch_ms=[],
                                  batch_agent_steps=[])
        for (A, P), idxs in groups.items():
            if order_by_occupancy:
                idxs = sorted(idxs, key=lambda i: -_live(scenarios[i]))
            chunk = max_batch or len(idxs)
            fn, cfg = self._get(model, A, P)
            for lo in range(0, len(idxs), chunk):
                sub = idxs[lo:lo + chunk]
                _sync(dev)
                t0 = time.perf_counter()
                B = 1 << (len(sub) - 1).bit_length()   # next power of two
                pad = sub + [sub[-1]] * (B - len(sub))
                batch = to_device(stack_scenarios(
                    [repad_scenario(scenarios[i], A, P) for i in pad]), dev)
                inputs = build_model_inputs_batch(
                    cfg, self.motion_tok, self.attr, batch,
                    [_generator(dev, input_seeds[i]) for i in pad])
                out = fn(batch, inputs, [_generator(dev, seeds[i])
                                         for i in pad])
                steps = agent_steps(out["pred_state"][:len(sub)], cfg)
                _sync(dev)
                self.last_dispatch["batch_ms"].append(
                    (time.perf_counter() - t0) * 1e3)
                self.last_dispatch["batch_agent_steps"].append(steps)
                self.last_dispatch["batches"].append((A, P, B, len(sub)))
                self.last_dispatch["host_reads"] += fn.host_reads
                for j, i in enumerate(sub):
                    res = {k: v[j] for k, v in out.items()}
                    if perms[i] is not None:
                        res["slot_perm"] = self._perm_out(
                            perms[i], A, _live(scenarios[i]))
                    results[i] = res
        return results


def agent_steps(pred_state, cfg: Config) -> float:
    """Active agents x token steps of rollouts' pred_state [..., A, T]: the
    non-invalid 10 Hz states after the history (as the JAX bench counts
    them), over SHIFT."""
    state = pred_state[..., cfg.num_historical_steps:]
    return float((state != INVALID_STATE).sum()) / SHIFT


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
