"""The port's streaming rollout (`infgen_torch/rollout/streaming.py`) and
`cli stream`, on the CPU.

Against the JAX package (infgen_tpu/rollout/streaming.py), on the same
numpy data or the same converted weights:
- `continuation_scenario` of one rollout output with a row forced to EXIT:
  every field bit for bit;
- the model inputs of such a continuation (a history of Hs = 11 frames
  instead of a log's 91): tokens, enter columns and ego-relative grids
  exact, floats within 1e-5;
- `stitch_stream_outputs` of the same stacked outputs: equal;
- `StreamingRollout.run` at beam 1 with forced insertion, three segments
  whose bucket changes: stitched states, types, the ego's gid and the
  segment records exact, trajectories, headings and shapes within POSE_TOL
  (the rollout's parity limit). Each seam tokenizes rolled-out poses again,
  so a contour match may flip on float noise; none does here, and a flip
  would fail the comparison.

Port against port, mirroring tests/test_streaming.py: the first segment is
the long rollout's prefix; a stream is deterministic; `run_batch` equals
`run`; `continuation_device` equals `continuation_scenario` bit for bit; the
device loop equals the host loop without compaction; the stitched registry's
invariants, and lane 0 of a fleet equal to the single stream; the chunked
runner's planned re-bucket and its fallback to full capacity; a compacting
server streams the same; `cli stream` writes its npz files, and without a GPU
raises unless asked for the CPU.
"""

import json
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from infgen_tpu.config import Config as JConfig
from infgen_tpu.data import scenario as JS
from infgen_tpu.data.features import build_model_inputs as j_build_inputs
from infgen_tpu.rollout import streaming as JST
from infgen_tpu.rollout.serving import RolloutServer as JServer
from infgen_tpu.rollout.serving import repad_scenario as j_repad
from infgen_tpu.tokenizers.attr_tokenizer import AttrTokenizer as JAttr
from infgen_tpu.tokenizers.motion_tokenizer import MotionTokenizer as JMotion
from infgen_tpu.tokenizers.vocab import load_map_vocab as j_map_vocab

from infgen_torch import cli
from infgen_torch.config import (Config, ENTER_STATE, EXIT_STATE,
                                 INVALID_STATE, VALID_STATE)
from infgen_torch.convert import load_flax_params
from infgen_torch.data.features import build_model_inputs
from infgen_torch.data.scenario import (AgentData, lane_of, stack_scenarios,
                                        to_device)
from infgen_torch.data.synthetic import make_synthetic_scenario
from infgen_torch.model.infgen import InfGenModel
from infgen_torch.rollout import streaming as ST
from infgen_torch.rollout.closed_loop import make_rollout_fn
from infgen_torch.rollout.serving import RolloutServer

from test_torch_layers import (  # noqa: F401 (one_torch_thread: autouse)
    random_flax_params, one_torch_thread)

# tests/test_streaming.py's sizes
TINY = dict(max_agents=16, max_map_tokens=128, num_agent_layers=2,
            num_seed_layers=1, num_map_layers=1, hidden_dim=32,
            num_heads=2, head_dim=16, num_freq_bands=8,
            num_seed_feature=4, num_recurrent_steps_val=20)
BEAM1 = dict(motion_beam_size=1, insert_beam_size=1)
POSE_TOL = 1e-3          # the rollout's parity limit (PARITY.md)
LANE_POSE_TOL = 2e-5     # a lane against its single rollout (serving test)
R = 20                   # frames per segment against the JAX package
RP = 10                  # port against port: two token steps a segment


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@pytest.fixture(scope="module")
def tiny():
    """The port at TINY with weights from the config's seed."""
    cfg = Config(**TINY)
    tok = cli.build_tokenizers(cfg)
    return cfg, tok, cli.build_model(cfg, tok[0], "cpu")


def _rollout_out(cfg, tok, model, scen, seed, **kw):
    """One port rollout of a numpy scenario, its outputs as numpy."""
    attr, mt, mv = tok
    s = to_device(scen, "cpu")
    fn = make_rollout_fn(model, cfg, attr, mt, mv, **kw)
    inputs = build_model_inputs(cfg, mt, attr, s,
                                torch.Generator().manual_seed(seed))
    out = fn(s, inputs, torch.Generator().manual_seed(seed))
    return {k: _np(v).copy() for k, v in out.items()}


def _with_exit(out):
    """The output with one live non-ego row forced to EXIT at its last
    frame."""
    av = int(out["av_index"])
    victim = next(int(r) for r in np.nonzero(out["slot_active"])[0]
                  if r != av)
    out["pred_state"][victim, -1] = EXIT_STATE
    return out, victim


def _jax_scenario(scen):
    """The JAX package's Scenario of the port's numpy scenario."""
    return JS.Scenario(
        agents=JS.AgentData(*(np.asarray(x) for x in scen.agents)),
        map=JS.MapData(*(np.asarray(x) for x in scen.map)),
        scenario_id=np.asarray(scen.scenario_id))


def _equal_scenarios(a, b):
    for part in ("agents", "map"):
        for name in getattr(a, part)._fields:
            x = np.asarray(getattr(getattr(a, part), name))
            y = np.asarray(getattr(getattr(b, part), name))
            assert x.dtype == y.dtype, f"{part}.{name}"
            np.testing.assert_array_equal(x, y, err_msg=f"{part}.{name}")
    np.testing.assert_array_equal(np.asarray(a.scenario_id),
                                  np.asarray(b.scenario_id))


def _equal_results(a, b, pose_tol=0.0):
    for k in ("state", "type"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k in ("traj", "head", "shape"):
        np.testing.assert_allclose(a[k], b[k], atol=pose_tol, rtol=0,
                                   err_msg=k)
    assert a["av_gid"] == b["av_gid"]
    assert a["segments"] == b["segments"]
    assert a["frames_per_segment"] == b["frames_per_segment"]


# --------------------------------------------------------------------- #
# against the JAX package
# --------------------------------------------------------------------- #

# the servers of test_stream_run_matches_jax
STREAM_KW = dict(agent_buckets=(8, 16), agent_headroom=2, force_insert=True,
                 num_recurrent_steps=R)
STREAM_AGENTS = 7        # its buckets: 16, then 8 once agents have exited


def _compile_bucket(jsrv, params, jscen, A, T10):
    """Compile the JAX server's rollout and input build of A slots for a
    T10-frame history, on a copy of the scenario cut to that history."""
    ag = jscen.agents
    cut = ag._replace(**{f: np.asarray(getattr(ag, f))[:, :T10] for f in (
        "valid", "position", "elevation", "heading", "velocity")})
    P = jsrv.map_buckets[-1]
    scen = j_repad(jscen._replace(agents=cut), A, P)
    fn, build = jsrv._get(A, P)
    k = jax.random.PRNGKey(0)
    fn.lower(params, scen, build(scen, k), k).compile()


@pytest.fixture(scope="module")
def jax_side():
    """Both packages at TINY, beam 1, with the same converted weights; and
    the JAX server of test_stream_run_matches_jax, whose two executables
    (16 slots and a log's history, 8 slots and an Hs-frame one: they
    depend on shapes only) compile in threads while the tests that do not
    need them run."""
    jcfg = JConfig(**TINY, **BEAM1)
    jtok = (JAttr(jcfg.grid_range, jcfg.grid_interval, jcfg.pl2seed_radius,
                  jcfg.angle_interval), JMotion(), j_map_vocab())
    params = random_flax_params(jcfg, seed=0)
    cfg = Config(**TINY, **BEAM1)
    tok = cli.build_tokenizers(cfg)
    model = InfGenModel(cfg, tok[0].grid, tok[0].grid_size,
                        tok[0].angle_size)
    load_flax_params(model, params)
    jsrv = JServer(jcfg, *jtok, **STREAM_KW)
    jscen = _jax_scenario(make_synthetic_scenario(
        cfg, seed=0, num_agents=STREAM_AGENTS))
    with ThreadPoolExecutor(2) as pool:
        compiles = [pool.submit(_compile_bucket, jsrv, params, jscen, A, T)
                    for A, T in ((16, jscen.agents.valid.shape[1]),
                                 (8, cfg.num_historical_steps))]
        yield dict(jcfg=jcfg, jtok=jtok, params=params, cfg=cfg, tok=tok,
                   model=model.eval(), jsrv=jsrv, compiles=compiles)


def test_continuation_scenario_matches_jax(tiny):
    """Host twins on the same numpy rollout output (a row forced to EXIT):
    every field bit for bit, dtypes included. Host-side code only."""
    cfg, tok, model = tiny
    scen = make_synthetic_scenario(cfg, seed=0, num_agents=6)
    out, victim = _with_exit(_rollout_out(cfg, tok, model, scen, 1))
    Hs = cfg.num_historical_steps
    nxt = ST.continuation_scenario(scen, out, Hs)
    jnxt = JST.continuation_scenario(_jax_scenario(scen), out, Hs)
    _equal_scenarios(nxt, jnxt)
    assert not nxt.agents.slot_mask[victim]
    assert nxt.agents.slot_mask[int(out["av_index"])]
    assert nxt.agents.position.shape[1] == Hs


def test_continuation_inputs_match_jax(jax_side):
    """A continuation's history is Hs = 11 frames, not a log's 91: its
    model inputs (motion tokens with extrapolate_to_prev_token_step, the
    enter columns, grids, the map masks from the same uniforms) against
    the JAX package's jitted build on the same numpy continuation."""
    cfg, tok, model = jax_side["cfg"], jax_side["tok"], jax_side["model"]
    jcfg, jtok = jax_side["jcfg"], jax_side["jtok"]
    scen = make_synthetic_scenario(cfg, seed=0, num_agents=6)
    out, _ = _with_exit(_rollout_out(cfg, tok, model, scen, 1,
                                     force_insert=True))
    nxt = ST.continuation_scenario(scen, out, cfg.num_historical_steps)
    key = jax.random.PRNGKey(3)
    jin = jax.device_get(jax.jit(lambda s, k: j_build_inputs(
        jcfg, jtok[1], jtok[0], s, k))(_jax_scenario(nxt), key))
    uniform = np.array(jax.random.uniform(jax.random.split(key)[0],
                                          (cfg.max_map_tokens,)))
    pin = build_model_inputs(cfg, tok[1], tok[0], to_device(nxt, "cpu"),
                             pt_uniform=torch.as_tensor(uniform))
    assert pin.tokens.token_idx.shape[1] == 2     # Hs // SHIFT columns
    for name in pin.tokens._fields:
        a = _np(getattr(pin.tokens, name))
        b = np.asarray(getattr(jin.tokens, name))
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    for name in pin._fields:
        if name == "tokens":
            continue
        a, b = _np(getattr(pin, name)), np.asarray(getattr(jin, name))
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    # the enter column of the agents inserted in the rollout's last frames
    assert (_np(pin.tokens.state_idx) == ENTER_STATE).any() or \
        not (out["pred_state"][:, -11:] == ENTER_STATE).any()


def test_stitch_matches_jax(tiny):
    """stitch_stream_outputs of the same stacked numpy outputs (three
    segments of the device loop) gives the JAX package's registry."""
    cfg, tok, model = tiny
    fn = ST.make_stream_fn(model, cfg, *tok, segment_steps=R, n_segments=3)
    stacked = {k: _np(v) for k, v in fn(make_synthetic_scenario(
        cfg, seed=0, num_agents=6), 4).items()}
    Hs = cfg.num_historical_steps
    res = ST.stitch_stream_outputs(stacked, Hs)
    jres = JST.stitch_stream_outputs(stacked, Hs)
    assert set(res) == set(jres)
    _equal_results(res, jres)
    assert res["av_gid"] == jres["av_gid"]


def _staying(cfg, tok):
    """The TINY model whose motion state head never picks a state other
    than VALID (their logits lowered by 30): no agent leaves, so live
    counts only grow."""
    model = cli.build_model(cfg, tok[0], "cpu")
    with torch.no_grad():
        bias = model.agent_decoder.state_predict_head.Dense_1.bias
        bias[torch.arange(3) != VALID_STATE] -= 30.0
    return model


@pytest.mark.parametrize("case", ["shrink", "grow"])
def test_registry_matches_jax(tiny, case):
    """The host registry across buckets that shrink (16 -> 8, agents exit)
    or grow (8 -> 16, no agent leaves): the port's _ScenarioStream and the
    JAX package's fed the same rollout outputs (the port's server at beam
    1, forced insertion) agree on every compacted scenario and on the
    stitched result. Host-side code of the JAX package only."""
    cfg0, tok, model = tiny
    cfg = cfg0.replace(**BEAM1)
    if case == "grow":
        model, n_agents, want = _staying(cfg, tok), 6, [8, 16, 16]
    else:
        n_agents, want = 7, [16, 8, 8]
    srv = RolloutServer(cfg, *tok, agent_buckets=(8, 16), agent_headroom=2,
                        force_insert=True, num_recurrent_steps=R)
    scen = make_synthetic_scenario(cfg, seed=0, num_agents=n_agents)
    Hs = cfg.num_historical_steps
    st, jst = ST._ScenarioStream(scen, Hs), JST._ScenarioStream(
        _jax_scenario(scen), Hs)
    for seg in range(3):
        scen_c = st.begin_segment()
        _equal_scenarios(scen_c, jst.begin_segment())
        out = {k: _np(v) for k, v in srv.rollout(model, scen_c, seg).items()}
        st.absorb(out, seg)
        jst.absorb(out, seg)
    res, jres = st.result(R), jst.result(3, R)
    assert [s["bucket"] for s in res["segments"]] == want
    _equal_results(res, jres)


# --------------------------------------------------------------------- #
# port against port (tests/test_streaming.py's mirrors)
# --------------------------------------------------------------------- #

def test_prefix_matches_long_rollout(tiny):
    """Motion only, beam 1: the stream's first segment is the long
    rollout's prefix."""
    cfg0, tok, model = tiny
    cfg = cfg0.replace(motion_beam_size=1, insert_limit=0,
                       num_recurrent_steps_val=2 * RP)
    Hs = cfg.num_historical_steps
    scen = make_synthetic_scenario(cfg, seed=0, num_agents=6)
    long_out = _rollout_out(cfg, tok, model, scen, ST.seed_of(3, 0))
    srv = RolloutServer(cfg, *tok, agent_buckets=(16,),
                        num_recurrent_steps=RP)
    res = ST.StreamingRollout(srv, RP).run(model, scen, 3, total_steps=2 * RP)
    n = int(scen.agents.slot_mask.sum())
    F = Hs + RP
    # synthetic live rows are contiguous, so gid i is slot i
    np.testing.assert_allclose(res["traj"][:n, :F],
                               long_out["pred_traj"][:n, :F], atol=1e-4)
    np.testing.assert_array_equal(res["state"][:n, :F],
                                  long_out["pred_state"][:n, :F])
    assert res["traj"].shape[1] == Hs + 2 * RP
    assert res["frames_per_segment"] == [Hs + RP, RP]


def _invariants(res, Hs, n_seg):
    G, F = res["state"].shape
    assert F == Hs + n_seg * RP and len(res["segments"]) == n_seg
    assert res["frames_per_segment"] == [Hs + RP] + [RP] * (n_seg - 1)
    assert res["traj"].shape == (G, F, 2) and res["shape"].shape == (G, 3)
    assert np.isfinite(res["traj"]).all() and np.isfinite(res["head"]).all()
    assert set(np.unique(res["state"])) <= {INVALID_STATE, VALID_STATE,
                                            ENTER_STATE, EXIT_STATE}
    # the ego lives through every frame after the first
    assert (res["state"][res["av_gid"], 2:] != INVALID_STATE).all()
    # an agent dead at a segment's last frame never comes back (its slot
    # may be reused, as a new gid)
    bounds = np.cumsum(res["frames_per_segment"])
    for g in range(G):
        s = res["state"][g]
        for fb in bounds[:-1]:
            if s[fb - 1] in (INVALID_STATE, EXIT_STATE) and \
                    (s[:fb] != INVALID_STATE).any():
                assert (s[fb:] == INVALID_STATE).all(), (g, fb)


def test_invariants_and_determinism(tiny):
    """Sampled, with insertion, buckets (8, 16): the registry's invariants
    and the same seed giving the same arrays."""
    cfg, tok, model = tiny
    scen = make_synthetic_scenario(cfg, seed=0, num_agents=6)
    srv = RolloutServer(cfg, *tok, agent_buckets=(8, 16), agent_headroom=2,
                        num_recurrent_steps=RP)
    stream = ST.StreamingRollout(srv, RP)
    res = stream.run(model, scen, 5, total_steps=3 * RP)
    res2 = stream.run(model, scen, 5, total_steps=3 * RP)
    _invariants(res, cfg.num_historical_steps, 3)
    assert res["state"].shape[0] >= int(scen.agents.slot_mask.sum())
    assert stream.host_reads > 0
    _equal_results(res, res2)


def test_compacting_server_keeps_rows(tiny):
    """Over a server that compacts (its outputs then carry slot_perm) the
    stream is the same: each segment's scenario is compacted already, so
    the server's permutation is the identity on the live rows (absorb
    asserts it)."""
    cfg, tok, model = tiny
    scen = make_synthetic_scenario(cfg, seed=1, num_agents=7)
    res = [ST.StreamingRollout(RolloutServer(
        cfg, *tok, agent_buckets=(8, 16), agent_headroom=2,
        num_recurrent_steps=RP, compact=compact), RP).run(
            model, scen, 6, total_steps=2 * RP) for compact in (False, True)]
    _equal_results(*res)


def test_run_batch_matches_run(tiny):
    """run_batch streams a fleet as lanes of each segment's batches; each
    scenario gives its single stream's registry (decisions exact, poses
    within LANE_POSE_TOL)."""
    cfg0, tok, model = tiny
    cfg = cfg0.replace(**BEAM1)
    scens = [make_synthetic_scenario(cfg, seed=s, num_agents=n)
             for s, n in [(0, 6), (1, 12), (2, 5)]]
    srv = RolloutServer(cfg, *tok, agent_buckets=(8, 16), agent_headroom=2,
                        num_recurrent_steps=RP)
    stream = ST.StreamingRollout(srv, RP)
    seeds = [9, 10, 11]
    batch = stream.run_batch(model, scens, seeds, total_steps=2 * RP)
    for scen, seed, rb in zip(scens, seeds, batch):
        _equal_results(rb, stream.run(model, scen, seed, total_steps=2 * RP),
                       pose_tol=LANE_POSE_TOL)


def test_continuation_device_matches_host(tiny):
    """continuation_device is bit for bit continuation_scenario on the same
    output, in every AgentData field, for one scenario and over lanes."""
    cfg, tok, model = tiny
    Hs = cfg.num_historical_steps
    scens = [make_synthetic_scenario(cfg, seed=s, num_agents=n)
             for s, n in ((0, 6), (3, 9))]
    outs = [_with_exit(_rollout_out(cfg, tok, model, s, 2 + i))[0]
            for i, s in enumerate(scens)]
    lanes = ST.continuation_device(
        to_device(stack_scenarios(scens), "cpu"),
        {k: torch.as_tensor(np.stack([o[k] for o in outs])) for k in outs[0]},
        Hs)
    for i, (scen, out) in enumerate(zip(scens, outs)):
        host = ST.continuation_scenario(scen, out, Hs)
        dev = ST.continuation_device(
            to_device(scen, "cpu"),
            {k: torch.as_tensor(v) for k, v in out.items()}, Hs)
        for field in AgentData._fields:
            a = np.asarray(getattr(host.agents, field))
            for got in (getattr(dev.agents, field),
                        getattr(lane_of(lanes.agents, i), field)):
                assert a.dtype == _np(got).dtype, field
                np.testing.assert_array_equal(a, _np(got), err_msg=field)


def test_fused_stream_matches_host_loop(tiny):
    """make_stream_fn equals the segment-by-segment host loop with the same
    seed schedule, the numpy continuation and no compaction, bit for
    bit."""
    cfg, tok, model = tiny
    attr, mt, mv = tok
    Hs, n_seg = cfg.num_historical_steps, 3
    scen = make_synthetic_scenario(cfg, seed=0, num_agents=6)
    fn = ST.make_stream_fn(model, cfg, *tok, segment_steps=RP,
                           n_segments=n_seg)
    stacked = {k: _np(v) for k, v in fn(scen, 11).items()}
    assert stacked["pred_state"].shape == (n_seg, cfg.max_agents, Hs + RP)
    assert fn.host_reads > 0
    roll = make_rollout_fn(model, cfg, attr, mt, mv, num_recurrent_steps=RP)
    cur = scen
    for seg in range(n_seg):
        k = ST.seed_of(11, seg)
        s = to_device(cur, "cpu")
        out = roll(s, build_model_inputs(cfg, mt, attr, s,
                                         torch.Generator().manual_seed(k)),
                   torch.Generator().manual_seed(k))
        for key in ST._STREAM_KEYS:
            np.testing.assert_array_equal(stacked[key][seg], _np(out[key]),
                                          err_msg=f"seg {seg} {key}")
        cur = ST.continuation_scenario(cur, out, Hs)
    assert int(stacked["av_index"]) == int(scen.agents.av_index)


def test_stitch_invariants_and_lanes(tiny):
    """The stitched device loop keeps the registry's invariants; a fleet of
    two lanes gives, in lane 0, the single stream's decisions and its poses
    within LANE_POSE_TOL (beam 1)."""
    cfg0, tok, model = tiny
    cfg = cfg0.replace(**BEAM1)
    Hs = cfg.num_historical_steps
    scen = make_synthetic_scenario(cfg, seed=0, num_agents=6)
    fn = ST.make_stream_fn(model, cfg, *tok, segment_steps=RP, n_segments=3)
    single = fn(scen, 4)
    res = ST.stitch_stream_outputs(single, Hs)
    _invariants(res, Hs, 3)
    fleet = fn(stack_scenarios(
        [scen, make_synthetic_scenario(cfg, seed=3, num_agents=9)]), [4, 7])
    assert fleet["pred_state"].shape == (2, 3, cfg.max_agents, Hs + RP)
    lane0 = {k: v[0] for k, v in fleet.items()}
    for k in ("pred_state", "slot_active", "pred_type", "n_inserted"):
        np.testing.assert_array_equal(_np(lane0[k]), _np(single[k]),
                                      err_msg=k)
    _equal_results(ST.stitch_stream_outputs(lane0, Hs), res,
                   pose_tol=LANE_POSE_TOL)


def _survivors(out):
    """Live rows per lane after a chunk's last segment (ego included)."""
    state = _np(out["pred_state"])[:, -1, :, -1]
    alive = _np(out["slot_active"])[:, -1] & (state != INVALID_STATE) \
        & (state != EXIT_STATE)
    av = _np(out["av_index"])
    alive[np.arange(len(av)), av] = True
    return alive.sum(-1)


def test_chunked_runner_rebucket_and_fallback(tiny):
    """The chunked runner takes the planned bucket when the survivors fit
    and full capacity when they do not; a chunk at the same capacity and
    seed repeats itself; outputs are [B, n_segments, A_bucket, ...]."""
    cfg0, tok, _ = tiny
    # without insertion and with no agent leaving, the survivors are the
    # initial agents: 9 at most
    cfg = cfg0.replace(insert_limit=0)
    model = _staying(cfg, tok)
    scens = [make_synthetic_scenario(cfg, seed=0, num_agents=6),
             make_synthetic_scenario(cfg, seed=3, num_agents=9)]
    runner = ST.make_chunked_stream_runner(cfg, *tok, segment_steps=RP)
    outs, used = runner(model, scens, ((16, 1), (16, 1)), 5)
    assert used == [16, 16]
    n_live = int(_survivors(outs[0]).max())
    assert n_live == 9
    fit, _ = runner(model, scens, ((16, 1), (n_live, 1)), 5)
    over, used_over = runner(model, scens, ((16, 1), (n_live - 1, 1)), 5)
    assert [o["pred_traj"].shape[2] for o in fit] == [16, n_live]
    assert used_over == [16, 16]
    for o in fit + over:
        assert o["pred_traj"].shape[:2] == (2, 1)
        assert torch.isfinite(o["pred_traj"]).all()
    for o in (fit[0], over[0]):
        np.testing.assert_array_equal(_np(o["pred_state"]),
                                      _np(outs[0]["pred_state"]))
    assert runner.host_reads > 0
    assert runner.agents_ever_alive == [6, 9]


def test_chunked_runner_counts_agents_ever_alive(tiny):
    """With insertion, the runner's agents_ever_alive per lane is the gids
    of its chunks' stitched registries less the survivors each chunk took
    over from the one before."""
    cfg, tok, model = tiny
    Hs = cfg.num_historical_steps
    scens = [make_synthetic_scenario(cfg, seed=0, num_agents=6),
             make_synthetic_scenario(cfg, seed=3, num_agents=9)]
    # a live slot whose agent left before the current frame: no agent of
    # the rollout (its slot is free for an insertion)
    ag = scens[1].agents
    gone = 1 if int(ag.av_index) != 1 else 2
    valid = np.array(ag.valid)
    valid[gone, 6:] = False
    scens[1] = scens[1]._replace(agents=ag._replace(valid=valid))
    runner = ST.make_chunked_stream_runner(cfg, *tok, segment_steps=RP)
    outs, _ = runner(model, scens, ((16, 2), (16, 1)), 5)
    gids = np.array([[ST.stitch_stream_outputs(
        {k: v[i] for k, v in o.items()}, Hs)["state"].shape[0]
        for i in range(2)] for o in outs])
    want = gids.sum(0) - _survivors(outs[0])
    inserted = sum(_np(o["n_inserted"]).sum(-1) for o in outs)
    assert inserted.sum() > 0
    # live slots plus insertions would count the left agent's slot twice
    assert int(np.asarray(ag.slot_mask).sum()) + inserted[1] > want[1]
    assert runner.agents_ever_alive == want.tolist()


TINY_YAML = os.path.join(os.path.dirname(__file__), "..", "configs",
                         "tiny_smoke.yaml")


def test_cli_stream_needs_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["stream", "--config", TINY_YAML, "--synthetic",
                  "--save-dir", str(tmp_path)])


@pytest.mark.parametrize("fused", [False, True])
def test_cli_stream_writes_npz(tmp_path, capsys, fused):
    """`stream --synthetic --device cpu` writes one npz per scenario with
    the JAX package's keys and prints its summary line."""
    cli.main(["stream", "--config", TINY_YAML, "--synthetic", "--device",
              "cpu", "--total-steps", "20", "--segment-steps", "10",
              "--num-scenarios", "2", "--save-dir", str(tmp_path)]
             + (["--fused-stream"] if fused else []))
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["segments"] == 2 and summary["fused"] is fused
    assert len(summary["ms_per_segment"]) == 2
    assert summary["agent_steps_per_s"] > 0 and summary["host_reads"] > 0
    for i in range(2):
        with np.load(tmp_path / f"stream_{i:06d}.npz") as z:
            assert set(z.files) == {"av_gid", "frames_per_segment",
                                    "segment_buckets", "traj", "head",
                                    "state", "type", "shape"}
            assert list(z["frames_per_segment"]) == [21, 10]
            assert z["state"].shape == (summary["agents_ever_alive"][i], 31)
            assert list(z["segment_buckets"]) == summary["buckets"][i]


def test_stream_run_matches_jax(jax_side):
    """StreamingRollout.run at beam 1 with forced insertion, three segments
    through servers with buckets (8, 16), the bucket shrinking from 16 to 8
    as agents exit: the stitched registry of both packages from the same
    weights and scenario (at beam 1 no draw decides anything, so the port's
    seeds and the JAX package's keys need not align). Last in the file: the
    JAX executables compile while the other tests run."""
    cfg, tok, model = jax_side["cfg"], jax_side["tok"], jax_side["model"]
    for done in jax_side["compiles"]:
        done.result()
    scen = make_synthetic_scenario(cfg, seed=0, num_agents=STREAM_AGENTS)
    jres = JST.StreamingRollout(jax_side["jsrv"], R).run(
        jax_side["params"], _jax_scenario(scen), jax.random.PRNGKey(5),
        total_steps=3 * R)
    res = ST.StreamingRollout(RolloutServer(cfg, *tok, **STREAM_KW), R).run(
        model, scen, 5, total_steps=3 * R)
    assert [s["bucket"] for s in res["segments"]] == [16, 8, 8]
    assert sum(s["n_inserted"] for s in res["segments"]) > 0
    _equal_results(res, jres, pose_tol=POSE_TOL)
