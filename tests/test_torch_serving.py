"""The port's occupancy-bucketed serving (`infgen_torch/rollout/serving.py`)
and the rollout's lane axis, on the CPU.

- `repad_scenario`, `compact_scenario` and `RolloutServer.bucket_for`
  against the JAX package's own functions on the same numpy scenarios
  (host-side code: nothing is compiled).
- Mirrors of tests/test_serving.py's rollout tests, port against port at
  its TINY sizes (no insertion, beam 1): each lane of a batched rollout
  must give its single rollout's token ids, state ids, slot activity and
  insertion counts bitwise and its poses within 1e-5.
- A forced-insertion batch whose lanes stop inserting at different
  iterations, at beam 1 and sampled (one generator per lane): decisions
  bitwise, poses within LANE_POSE_TOL. A single rollout's one-row
  products (the insert's refine query, its key chain, the seed path) run
  as matrix-vector products, a batch's as B-row matrix products, whose
  fp32 sums round in another order; the closed loop carries those
  last-bit differences into the poses (largest gaps read: 9.5e-7 at beam
  1, 1.53e-5 sampled, two fp32 steps of a 97 m coordinate).
- `seed_eval_reference` over lanes against the unbatched one lane by lane
  (masked-off lanes give zeros), and one case against `jax.vmap` of the
  JAX package's Pallas `seed_eval_kernel` in interpret mode.
- The same for the lane forms of `seed_eval_full`, `refine` and
  `fused_attention_block`: each plain twin over lanes against the
  unbatched twin lane by lane, and each against `jax.vmap` of the JAX
  package's Pallas kernel in interpret mode, within that kernel's port
  test's tolerance.
- Under each of those three flags, each lane of a batched rollout gives its
  single rollout's decisions bitwise and its poses within LANE_POSE_TOL,
  with the host reads of the rollout with the flag off; a two-scenario
  fleet through the chunked stream runner under all three gives each
  scenario's own stream; and a two-lane rollout under all three equals
  `jax.jit(jax.vmap(...))` of the JAX package's rollout (PARITY.md's
  protocol; the JAX side traces and compiles in a process of its own,
  started by its module fixture, while the port-only tests run). The
  column kernel's lanes: tests/test_torch_column_lanes.py.
"""

import json
import multiprocessing
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infgen_tpu.config import Config as JConfig
from infgen_tpu.data.features import build_model_inputs as j_build_inputs
from infgen_tpu.data.synthetic import make_synthetic_scenario as j_synthetic
from infgen_tpu.model.agent_decoder import AgentDecoder as JDecoder
from infgen_tpu.model.infgen import InfGenModel as JModel
from infgen_tpu.ops import refine_kernel as JRK
from infgen_tpu.ops import seed_fast as JSF
from infgen_tpu.ops import seed_kernel as JSK
from infgen_tpu.ops.fused_block import fused_attention_block as j_fused
from infgen_tpu.rollout import serving as JS
from infgen_tpu.rollout.closed_loop import make_rollout_fn as j_rollout_fn
from infgen_tpu.tokenizers.attr_tokenizer import AttrTokenizer as JAttr
from infgen_tpu.tokenizers.motion_tokenizer import MotionTokenizer as JMotion
from infgen_tpu.tokenizers.vocab import load_map_vocab as j_map_vocab

from infgen_torch import cli
from infgen_torch.config import Config
from infgen_torch.convert import load_flax_params
from infgen_torch.data import scenario as S
from infgen_torch.data.features import (build_model_inputs,
                                        build_model_inputs_batch)
from infgen_torch.data.synthetic import make_synthetic_scenario
from infgen_torch.model.layers import Dense, DenseAttention, Embed, LayerNorm
from infgen_torch.ops import fused_block as FB
from infgen_torch.ops import refine_kernel as RK
from infgen_torch.ops import seed_fast as SF
from infgen_torch.ops import seed_kernel as SK
from infgen_torch.rollout import closed_loop as CL
from infgen_torch.rollout import streaming as ST
from infgen_torch.rollout.serving import (RolloutServer, agent_steps,
                                          compact_scenario, repad_scenario)
from infgen_torch.tokenizers.attr_tokenizer import AttrTokenizer

from test_torch_column_kernel import Layers, attention_tree, mlp_tree
from test_torch_layers import one_torch_thread  # noqa: F401 (autouse)
from test_torch_rollout import CFG as ROLLOUT_CFG
from test_torch_rollout import CLOSE, POSE_TOL


TINY = dict(max_agents=16, max_map_tokens=128, num_agent_layers=2,
            num_seed_layers=1, num_map_layers=1, hidden_dim=32,
            num_heads=2, head_dim=16, num_freq_bands=8,
            num_seed_feature=4, num_recurrent_steps_val=20,
            # deterministic: argmax motion token, no insertions
            motion_beam_size=1, insert_limit=0)
EXACT = ("next_token_idx", "next_state_idx", "slot_active", "n_inserted",
         "per_step_inserted", "grid_index", "pred_type", "valid_mask")
POSES = ("pos_a", "head_a", "pred_traj", "pred_head", "pred_shape")
LANE_POSE_TOL = {"beam1": 1e-5, "sampled": 2e-5}


@pytest.fixture(scope="module")
def tiny():
    cfg = Config(**TINY)
    attr, mt, mv = cli.build_tokenizers(cfg)
    model = cli.build_model(cfg, attr, "cpu")
    return cfg, (attr, mt, mv), model


def _server(tiny, **kw):
    cfg, tok, _ = tiny
    return RolloutServer(kw.pop("cfg", cfg), *tok, **kw)


def _same(out, ref, rows=None, pose_tol=1e-5):
    sl = slice(None) if rows is None else slice(0, rows)
    for k in EXACT:
        a, b = out[k].numpy(), ref[k].numpy()
        if a.ndim and k not in ("per_step_inserted",):
            a, b = a[sl], b[sl]
        np.testing.assert_array_equal(a, b, err_msg=k)
    for k in POSES:
        np.testing.assert_allclose(out[k].numpy()[sl], ref[k].numpy()[sl],
                                   atol=pose_tol, rtol=0, err_msg=k)


# --------------------------------------------------------------------- #
# host-side functions against the JAX package's
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def jax_side():
    jcfg = JConfig(**TINY)
    jattr = JAttr(jcfg.grid_range, jcfg.grid_interval, jcfg.pl2seed_radius,
                  jcfg.angle_interval)
    return jcfg, (jattr, JMotion(), j_map_vocab())


def _port(jscen):
    """The port's Scenario of the JAX scenario's numpy arrays."""
    return S.Scenario(
        agents=S.AgentData(*(np.asarray(x) for x in jscen.agents)),
        map=S.MapData(*(np.asarray(x) for x in jscen.map)),
        scenario_id=np.asarray(jscen.scenario_id))


def _equal_trees(a, b):
    for part in ("agents", "map"):
        for name in getattr(a, part)._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(getattr(a, part), name)),
                np.asarray(getattr(getattr(b, part), name)),
                err_msg=f"{part}.{name}")


def _scatter(scen, slots):
    """Move the live agent rows (stable order) to the given slot indices
    (tests/test_serving.py's _scatter_agents, on either package's
    Scenario)."""
    ag = scen.agents
    A = np.asarray(ag.slot_mask).shape[0]
    live = np.nonzero(np.asarray(ag.slot_mask))[0]
    perm = np.full((A,), -1, np.int64)
    perm[np.asarray(slots)] = live
    holes = np.setdiff1d(np.arange(A), np.asarray(slots))
    perm[holes] = np.setdiff1d(np.arange(A), live)
    fields = {f: np.asarray(getattr(ag, f))[perm]
              for f in ag._fields if f != "av_index"}
    fields["av_index"] = np.asarray(
        int(np.nonzero(perm == int(np.asarray(ag.av_index)))[0][0]))
    return scen._replace(agents=type(ag)(**fields))


def test_repad_matches_jax(jax_side):
    jcfg, _ = jax_side
    jscen = j_synthetic(jcfg, seed=0, num_agents=6)
    scen = _port(jscen)
    for A, P in ((8, 128), (16, 128), (24, 160)):
        _equal_trees(repad_scenario(scen, A, P),
                     JS.repad_scenario(jscen, A, P))
    back = repad_scenario(repad_scenario(scen, 8, 128), 16, 128)
    _equal_trees(back, JS.repad_scenario(JS.repad_scenario(jscen, 8, 128),
                                         16, 128))
    # real map tokens beyond the cut, real rows beyond the cut
    with pytest.raises(AssertionError):
        repad_scenario(scen, 8, 64)
    with pytest.raises(AssertionError):
        JS.repad_scenario(jscen, 8, 64)
    holed = _scatter(scen, [0, 1, 2, 3, 4, 15])
    with pytest.raises(AssertionError, match="beyond slot"):
        repad_scenario(holed, 8, 128)


def test_compact_matches_jax(jax_side):
    jcfg, _ = jax_side
    jscen = _scatter(j_synthetic(jcfg, seed=0, num_agents=6),
                     [0, 3, 5, 9, 12, 15])
    comp, perm = compact_scenario(_port(jscen))
    jcomp, jperm = JS.compact_scenario(jscen)
    np.testing.assert_array_equal(perm, jperm)
    _equal_trees(comp, jcomp)
    assert int(comp.agents.av_index) == int(np.asarray(jcomp.agents.av_index))
    for A in (8, 16):
        np.testing.assert_array_equal(
            RolloutServer._perm_out(perm, A, 6),
            JS.RolloutServer._perm_out(jperm, A, 6))


BUCKET_CASES = [
    dict(agent_buckets=(8, 16), map_buckets=(64, 128), agent_headroom=2),
    dict(agent_buckets=(8, 16), agent_headroom=8),
    dict(agent_buckets=(8,), agent_headroom=0),
    dict(agent_buckets=(8, 12, 16), agent_headroom=2,
         bucket_cost_ms={8: 5.0, 12: 10.0, 16: 10.1}),
    dict(agent_buckets=(8, 12, 16), agent_headroom=4,
         bucket_cost_ms={8: 1.0, 12: 6.0, 16: 6.05}),
    dict(agent_buckets=(8, 12, 16), agent_headroom=4,
         bucket_cost_ms={8: 1.0, 12: 6.0, 16: 10.0}),
    dict(agent_buckets=(8, 12, 16), agent_headroom=2,
         bucket_cost_ms={16: 1.0}),
]


@pytest.mark.parametrize("kw", BUCKET_CASES)
def test_bucket_for_matches_jax(tiny, jax_side, kw):
    """Capacity order and measured cost tables (cheapest feasible bucket,
    near-ties within 3% to the larger capacity) pick what the JAX server
    picks, for contiguous, scattered and oversize scenarios."""
    jcfg, jtok = jax_side
    cfg = tiny[0]
    srv, jsrv = _server(tiny, **kw), JS.RolloutServer(jcfg, *jtok, **kw)
    for seed, n in ((0, 6), (1, 3), (2, 11)):
        jscen = j_synthetic(jcfg, seed=seed, num_agents=n)
        for js in (jscen, _scatter(jscen, list(range(16 - n, 16)))):
            assert srv.bucket_for(_port(js)) == jsrv.bucket_for(js)
    small = dict(kw, agent_buckets=(8,), bucket_cost_ms=None)
    srv_s = RolloutServer(cfg.replace(max_agents=8), *tiny[1], **small)
    jsrv_s = JS.RolloutServer(jcfg.replace(max_agents=8), *jtok, **small)
    holed = _scatter(j_synthetic(jcfg, seed=0, num_agents=6),
                     [0, 1, 2, 3, 4, 15])
    with pytest.raises(ValueError, match="largest bucket"):
        srv_s.bucket_for(_port(holed))
    with pytest.raises(ValueError, match="largest bucket"):
        jsrv_s.bucket_for(holed)


# --------------------------------------------------------------------- #
# mirrors of tests/test_serving.py, port against port
# --------------------------------------------------------------------- #

def test_capacity_invariant_rollout(tiny):
    cfg, (attr, mt, mv), model = tiny
    scen = make_synthetic_scenario(cfg, seed=0, num_agents=6)
    sd = S.to_device(scen, "cpu")
    inputs = build_model_inputs(cfg, mt, attr, sd,
                                torch.Generator().manual_seed(3))
    full = CL.make_rollout_fn(model, cfg, attr, mt, mv)
    out_full = full(sd, inputs, torch.Generator().manual_seed(3))
    srv = _server(tiny, agent_buckets=(8, 16), map_buckets=(64, 128),
                  agent_headroom=2)
    out_small = srv.rollout(model, scen, 3)
    assert out_small["pred_traj"].shape[0] == 8          # ran in the bucket
    _same(out_small, out_full, rows=6)


def test_batched_dispatch_matches_single(tiny):
    """rollout_batch groups by bucket and pads to power-of-two batches;
    every scenario must reproduce its single-dispatch result. Beside each
    batch's (A, P, lanes, scenarios) it records its wall time and the
    agent-steps of its real scenarios (what cli.run_batched's by_bucket
    reads)."""
    cfg = tiny[0]
    scens = [make_synthetic_scenario(cfg, seed=s, num_agents=n)
             for s, n in [(0, 4), (1, 12), (2, 5)]]   # buckets 8, 16, 8
    srv = _server(tiny, agent_buckets=(8, 16), agent_headroom=2)
    outs = srv.rollout_batch(tiny[2], scens, [7, 8, 9])
    assert outs[0]["pred_traj"].shape[0] == 8
    assert outs[1]["pred_traj"].shape[0] == 16
    assert [b[2] for b in srv.last_dispatch["batches"]] == [2, 1]
    assert len(srv.last_dispatch["batch_ms"]) == 2
    assert min(srv.last_dispatch["batch_ms"]) > 0
    steps = [agent_steps(o["pred_state"], cfg) for o in outs]
    assert min(steps) > 0
    assert srv.last_dispatch["batch_agent_steps"] == pytest.approx(
        [steps[0] + steps[2], steps[1]])
    for scen, seed, out in zip(scens, [7, 8, 9], outs):
        _same(out, srv.rollout(tiny[2], scen, seed, input_seed=seed))


def test_batched_dispatch_chunked_and_ordered(tiny):
    """max_batch chunking and occupancy ordering change no scenario's
    result (same seeds and bucket; only the lane grouping differs), and
    results stay in input order."""
    cfg = tiny[0]
    scens = [make_synthetic_scenario(cfg, seed=s, num_agents=n)
             for s, n in [(0, 4), (1, 12), (2, 5), (3, 11), (4, 3)]]
    srv = _server(tiny, agent_buckets=(16,), agent_headroom=2)
    plain = srv.rollout_batch(tiny[2], scens, 7)
    assert [b[2:] for b in srv.last_dispatch["batches"]] == [(8, 5)]
    chunked = srv.rollout_batch(tiny[2], scens, 7, max_batch=2,
                                order_by_occupancy=True)
    assert [b[2:] for b in srv.last_dispatch["batches"]] == \
        [(2, 2), (2, 2), (1, 1)]
    for p, c in zip(plain, chunked):
        _same(c, p)


def test_compaction_enables_small_bucket(tiny):
    """compact=True packs scattered live rows into a prefix, so bucket_for
    picks the small bucket, and the rollout (permutation-equivariant over
    agent slots) reproduces the contiguous scenario's outputs; slot_perm
    maps bucket rows back to the caller's slots."""
    cfg, _, model = tiny
    scen = make_synthetic_scenario(cfg, seed=0, num_agents=6)
    slots = [0, 3, 5, 9, 12, 15]
    scattered = _scatter(scen, slots)
    comp, perm = compact_scenario(scattered)
    np.testing.assert_array_equal(perm[:6], slots)
    np.testing.assert_array_equal(comp.agents.position, scen.agents.position)

    assert _server(tiny, agent_buckets=(8, 16),
                   agent_headroom=2).bucket_for(scattered)[0] == 16
    srv = _server(tiny, agent_buckets=(8, 16), agent_headroom=2,
                  compact=True)
    out = srv.rollout(model, scattered, 3)
    assert out["pred_traj"].shape[0] == 8
    np.testing.assert_array_equal(out["slot_perm"][:6], slots)
    ref = srv.rollout(model, scen, 3)
    _same(out, ref, rows=6, pose_tol=0.0)

    outs = srv.rollout_batch(model, [scattered, scen], [3, 4])
    assert outs[0]["pred_traj"].shape[0] == 8
    np.testing.assert_array_equal(outs[0]["slot_perm"][:6], slots)


def test_calibrate_installs_cost_table(tiny):
    cfg, _, model = tiny
    scen = make_synthetic_scenario(cfg, seed=0, num_agents=6)
    srv = _server(tiny, agent_buckets=(8, 16), agent_headroom=0,
                  num_recurrent_steps=5)
    table = srv.calibrate(model, scen, n_rep=1)
    assert set(table) == {8, 16}
    assert all(v > 0 for v in table.values())
    assert srv.bucket_cost_ms == table
    assert srv.bucket_for(scen)[0] in (8, 16)


# --------------------------------------------------------------------- #
# forced insertion over lanes
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("beams", [(1, 1), (4, 3)], ids=["beam1", "sampled"])
def test_forced_insertion_lanes_stop_apart(beams, tmp_path):
    """Three lanes with 13, 9 and 4 live agents in 16 slots: forced
    insertion fills the first within a few iterations and the last only
    when its budget runs out, so the lanes leave their insertion loops at
    different iterations; stopped lanes are frozen while the others run.
    Each lane's decisions equal its single rollout's (sampled: the lane's
    generator draws exactly the single rollout's stream), with one host
    read per loop iteration, not one per lane."""
    cfg = Config(**dict(TINY, insert_limit=4, num_recurrent_steps_val=25,
                        use_seed_kernel=True, motion_beam_size=beams[0],
                        insert_beam_size=beams[1]))
    attr, mt, mv = cli.build_tokenizers(cfg)
    model = cli.build_model(cfg, attr, "cpu")
    fn = CL.make_rollout_fn(model, cfg, attr, mt, mv, force_insert=True)
    scens = [make_synthetic_scenario(cfg, seed=s, num_agents=n)
             for s, n in ((5, 13), (6, 9), (7, 4))]
    singles, reads = [], []
    for i, sc in enumerate(scens):
        sd = S.to_device(sc, "cpu")
        inp = build_model_inputs(cfg, mt, attr, sd,
                                 torch.Generator().manual_seed(40 + i))
        singles.append(fn(sd, inp, torch.Generator().manual_seed(50 + i)))
        reads.append(fn.host_reads)
    batch = S.to_device(S.stack_scenarios(scens), "cpu")
    inputs = build_model_inputs_batch(
        cfg, mt, attr, batch,
        [torch.Generator().manual_seed(40 + i) for i in range(3)])
    out = fn(batch, inputs,
             [torch.Generator().manual_seed(50 + i) for i in range(3)])
    per_step = out["per_step_inserted"].numpy()
    assert (per_step.sum(1) > 0).all()
    assert any(len(set(col)) > 1 for col in per_step.T), per_step
    assert max(reads) <= fn.host_reads < sum(reads)
    for b, single in enumerate(singles):
        lane = {k: v[b] for k, v in out.items()}
        _same(lane, single, pose_tol=LANE_POSE_TOL[
            "beam1" if beams == (1, 1) else "sampled"])


# --------------------------------------------------------------------- #
# seed_eval over lanes
# --------------------------------------------------------------------- #

SEED_CFG = dict(max_agents=12, max_map_tokens=32, hidden_dim=32,
                num_heads=2, head_dim=16, num_freq_bands=8,
                num_agent_layers=2, num_seed_layers=2, num_map_layers=1,
                dropout=0.0, grid_range=60.0, grid_interval=3.0,
                pl2seed_radius=30.0, remat_attention=False)
A_, P_, D_, H_, L_ = 12, 32, 32, 2, 2
LANES = 3


def _decoder_tree(dec, rng):
    """Random weights for a port module (the agent decoder, or the whole
    InfGenModel) and the same weights as a flax params tree (convert.py's
    names read backwards), without tracing the JAX model: kernels
    ~ N(0, 1/fan_in), biases and embeddings ~ N(0, 0.1^2), LayerNorm
    scales ~ 1 + N(0, 0.1^2)."""
    tree = {}
    with torch.no_grad():
        for name, prm in sorted(dec.named_parameters()):
            *path, leaf = name.split(".")
            owner = dec.get_submodule(".".join(path))
            if isinstance(owner, LayerNorm):
                val = (leaf == "weight") + rng.normal(0, 0.1, prm.shape)
                leaf = "scale" if leaf == "weight" else leaf
            elif prm.dim() == 2 and not isinstance(owner, Embed):
                fan_in = prm.shape[0] if leaf in ("w_kr", "w_vr") \
                    else prm.shape[1]
                val = rng.normal(0, fan_in ** -0.5, prm.shape)
            else:
                val = rng.normal(0, 0.1, prm.shape)
            prm.copy_(torch.as_tensor(val, dtype=torch.float32))
            if isinstance(owner, Dense) and leaf == "weight":
                leaf, val = "kernel", val.T
            elif isinstance(owner, Embed):
                leaf = "embedding"
            node = tree
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = np.asarray(val, np.float32)
    return tree


@pytest.fixture(scope="module")
def seed_setup():
    jcfg = JConfig(**SEED_CFG)
    jattr = JAttr(jcfg.grid_range, jcfg.grid_interval, jcfg.pl2seed_radius,
                  jcfg.angle_interval)
    jdec = JDecoder(jcfg, grid_xy=jattr.grid, grid_size=jattr.grid_size,
                    angle_size=jattr.angle_size)
    model = cli.build_model(Config(**SEED_CFG), AttrTokenizer(
        jcfg.grid_range, jcfg.grid_interval, jcfg.pl2seed_radius,
        jcfg.angle_interval), "cpu")
    tree = _decoder_tree(model.agent_decoder, np.random.default_rng(29))
    G = jattr.grid_size
    rng = np.random.default_rng(31)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    lanes = []
    for b in range(LANES):
        x = dict(agent_col=f(A_, D_), occ_vec=rng.uniform(size=G) < 0.1,
                 pl_mask=rng.uniform(size=P_) < 0.7, pl_r_raw=f(P_, 3),
                 a2sa_r_raw=f(A_, 3), a2sa_mask=rng.uniform(size=A_) < 0.8,
                 x_pt=f(P_, D_))
        if b == 1:
            x["a2sa_mask"][:] = False
        lanes.append(x)
    return dict(jdec=jdec, p=tree, model=model, G=G,
                lanes=lanes, sd0=f(D_))


def _torch_args(model, G, x):
    """One lane's seed_eval inputs as the rollout builds them."""
    dec = model.agent_decoder
    t = lambda a: torch.as_tensor(np.asarray(a))
    with torch.no_grad():
        r_pl = dec.embed_pl2sa_r(t(x["pl_r_raw"]))
        r_sa = dec.embed_a2sa_r(t(x["a2sa_r_raw"]))
        occ_emb = dec.embed_occ(t(x["occ_vec"]))
        chain = dec.seed_key_chain(t(x["agent_col"]))
        K_pt, V_pt, K_a, V_a, v_occ = [], [], [], [], []
        for i in range(L_):
            pt, a = dec.pt2sa_attn_layers[i], dec.a2sa_attn_layers[i]
            v_occ.append(SF.occ_value(dec.occ2sa_attn_layers[i], occ_emb))
            k0, v0 = SF.precompute_src_kv(pt, t(x["x_pt"]))
            kr, vr = SF.r_contrib(pt, r_pl)
            K_pt.append(k0 + kr)
            V_pt.append(v0 + vr)
            ka, va = SF.precompute_src_kv(a, chain[i])
            kar, var_ = SF.r_contrib(a, r_sa)
            K_a.append(ka + kar)
            V_a.append(va + var_)
    return (torch.stack(v_occ), torch.stack(K_pt), torch.stack(V_pt),
            t(x["pl_mask"]), torch.stack(K_a), torch.stack(V_a),
            t(x["a2sa_mask"]))


def _lane_args(s):
    per = [_torch_args(s["model"], s["G"], x) for x in s["lanes"]]
    return [torch.stack(parts) for parts in zip(*per)], per


def test_seed_eval_reference_lanes(seed_setup):
    """Each lane of the lane form equals the unbatched evaluation of that
    lane bit for bit; a masked-off lane gives zeros; the wrapper takes the
    lane form on CPU tensors."""
    s = seed_setup
    pack = SK.pack_seed_params(s["model"].agent_decoder, L_, s["G"])
    sd0 = torch.as_tensor(s["sd0"])
    stacked, per = _lane_args(s)
    mask = torch.tensor([True, False, True])
    with torch.no_grad():
        small, pos = SK.seed_eval_reference(pack, sd0, *stacked, H_, 16,
                                            lanes=mask)
        small_k, pos_k = SK.seed_eval_kernel(pack, sd0, *stacked, H_, 16,
                                             lanes=mask)
        assert small.shape == (LANES, 3, SK.SMALL_COLS)
        assert pos.shape == (LANES, s["G"])
        for b in range(LANES):
            if not mask[b]:
                assert not small[b].any() and not pos[b].any()
                continue
            ref = SK.seed_eval_reference(pack, sd0, *per[b], H_, 16)
            assert torch.equal(small[b], ref[0]) and torch.equal(pos[b],
                                                                 ref[1])
    assert torch.equal(small_k, small) and torch.equal(pos_k, pos)


def test_seed_eval_lanes_match_jax_vmap(seed_setup):
    """The lane form against jax.vmap of the Pallas seed_eval_kernel in
    interpret mode (its pallas_call gains a grid axis over lanes), fp32,
    atol 1e-5 (summation order only)."""
    s = seed_setup
    p, jdec, G = s["p"], s["jdec"], s["G"]

    def args(x):
        def prep(mdl):
            return (mdl.embed_pl2sa_r(x["pl_r_raw"]),
                    mdl.embed_a2sa_r(x["a2sa_r_raw"]),
                    mdl.embed_occ(x["occ_vec"]),
                    mdl.seed_key_chain(x["agent_col"]))
        r_pl, r_sa, occ_emb, chain = jdec.apply({"params": p}, method=prep)
        K_pt, V_pt, K_a, V_a, v_occ = [], [], [], [], []
        for i in range(L_):
            p_pt, p_a = p[f"pt2sa_{i}"], p[f"a2sa_{i}"]
            v_occ.append(JSF.occ_value(p[f"occ2sa_{i}"], occ_emb, None))
            k0, v0 = JSF.precompute_src_kv(p_pt, x["x_pt"], None)
            kr, vr = JSF.r_contrib(p_pt, r_pl, None)
            K_pt.append(k0 + kr)
            V_pt.append(v0 + vr)
            ka, va = JSF.precompute_src_kv(p_a, chain[i], None)
            kar, var_ = JSF.r_contrib(p_a, r_sa, None)
            K_a.append(ka + kar)
            V_a.append(va + var_)
        lane = lambda m, n: jnp.broadcast_to(m[:, None], (n, D_)).astype(
            jnp.float32)
        return (jnp.stack(v_occ), jnp.stack(K_pt), jnp.stack(V_pt),
                lane(x["pl_mask"], P_), jnp.stack(K_a), jnp.stack(V_a),
                lane(x["a2sa_mask"], A_))

    pack = JSK.pack_seed_params(p, L_, G, jnp.float32)
    sel = JSK.selector(D_, H_, 16)
    sd0 = jnp.asarray(s["sd0"])[None]

    @jax.jit
    def run(xs):
        return jax.vmap(lambda x: JSK.seed_eval_kernel(
            pack, sd0, *args(x), sel, H_, 16, interpret=True))(xs)

    xs = {k: jnp.stack([jnp.asarray(x[k]) for x in s["lanes"]])
          for k in s["lanes"][0]}
    jsmall, jpos = (np.asarray(a) for a in run(xs))
    stacked, _ = _lane_args(s)
    tpack = SK.pack_seed_params(s["model"].agent_decoder, L_, G)
    with torch.no_grad():
        small, pos = SK.seed_eval_kernel(tpack, torch.as_tensor(s["sd0"]),
                                         *stacked, H_, 16)
    for b in range(LANES):
        want = np.concatenate([jsmall[b, 0, :2], jsmall[b, 1, :3],
                               jsmall[b, 2, :3], jpos[b, 0, :G]])
        got = np.concatenate([small[b, 0, :2], small[b, 1, :3],
                              small[b, 2, :3], pos[b]])
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0,
                                   err_msg=f"lane {b}")


# --------------------------------------------------------------------- #
# the lane forms of seed_eval_full, refine and fused_attention_block
# --------------------------------------------------------------------- #

LANE_MASK = (True, False, True)          # lane 1 switched off
FULL_L = 1          # seed_eval_full lanes: the first seed layer of the tree
REF_L, REF_R, REF_KA, REF_AH = 1, 32, 24, 120   # refine lanes: layers, rows
FUSED_QK = {"per_query": (9, 5), "shared": (9, 7), "self": (9, 9)}
D_F, H_F = 32, 2                         # the fused block's lane cases
TOL_LANES = {"seed_eval_full": 1e-5, "refine": 2e-5,
             "fused_attention_block": 2e-5}   # each kernel's port test's


def _full_lane_args(s):
    """seed_eval_full's lane inputs ([B, ...], sd0 apart) as the rollout
    builds them: k0 / v0 of every lane's map features, the geometry
    embeddings, the raw agent column, masks and occupancy rows."""
    dec = s["model"].agent_decoder
    t = lambda k: torch.as_tensor(np.stack([np.asarray(x[k])
                                            for x in s["lanes"]]))
    with torch.no_grad():
        x_pt = t("x_pt")
        kv = [SF.precompute_src_kv(dec.pt2sa_attn_layers[i], x_pt)
              for i in range(FULL_L)]
        return (torch.stack([k for k, _ in kv], 1),
                torch.stack([v for _, v in kv], 1),
                dec.embed_pl2sa_r(t("pl_r_raw")), t("pl_mask"),
                t("agent_col"), dec.embed_a2sa_r(t("a2sa_r_raw")),
                t("a2sa_mask"), t("occ_vec"))


@pytest.fixture(scope="module")
def refine_setup():
    """The refine pass's flax subtrees (REF_L trunk layers and the two
    heads), the port's layers loaded from them, and LANES lanes of padded
    inputs (row 0 the insert, rows 1..24 its neighbours; lane 1 with every
    agent key masked)."""
    rng = np.random.default_rng(67)
    specs = {}
    for i in range(REF_L):
        specs[f"pt2a_{i}"] = ("attn", True, True)
        specs[f"a2a_{i}"] = ("attn", False, True)
    specs["seed_heading_rel_token_predict_head"] = ("mlp", D_F, REF_AH)
    specs["seed_offset_xy_predict_head"] = ("mlp", D_F, 2)
    tree = {name: (attention_tree(rng, sp[1]) if sp[0] == "attn"
                   else mlp_tree(rng, sp[1], sp[2]))
            for name, sp in specs.items()}
    R, Ka = REF_R, REF_KA
    f = lambda *sh: rng.normal(size=sh).astype(np.float32)
    lanes = []
    for b in range(LANES):
        x = dict(x_sub=np.zeros((R, D_F), np.float32), pl_keys=f(R, D_F),
                 r_pl=f(R, D_F), mask_pl=rng.uniform(size=R) < 0.7,
                 r_aa=np.zeros((R, D_F), np.float32),
                 mask_a=np.zeros(R, bool))
        x["x_sub"][:1 + Ka] = f(1 + Ka, D_F)
        x["r_aa"][1:1 + Ka] = f(Ka, D_F)
        x["mask_a"][1:1 + Ka] = (rng.uniform(size=Ka) < 0.6) & (b != 1)
        lanes.append(x)
    return tree, Layers(tree, specs).eval(), lanes


_REF_ARGS = ("x_sub", "pl_keys", "r_pl", "mask_pl", "r_aa", "mask_a")


def _fused_lanes(mode):
    """(flax subtree, port module, x [B, Q, D], x_src, r, mask) of a
    fused-block lane case: LANES lanes of their own rows and keys, one
    query row of lane 0 fully masked."""
    rng = np.random.default_rng(83 + sorted(FUSED_QK).index(mode))
    Q, K = FUSED_QK[mode]
    bipartite = mode == "per_query"
    tree = attention_tree(rng, bipartite)
    mod = DenseAttention(D_F, H_F, D_F // H_F, bipartite=bipartite)
    load_flax_params(mod, tree)
    f = lambda *sh: rng.normal(size=sh).astype(np.float32)
    x, r = f(LANES, Q, D_F), f(LANES, Q, K, D_F)
    mask = rng.uniform(size=(LANES, Q, K)) < 0.5
    mask[0, 2] = False
    src = {"per_query": (LANES, Q, K, D_F), "shared": (LANES, K, D_F)}.get(
        mode)
    return tree, mod.eval(), x, None if src is None else f(*src), r, mask


@pytest.mark.parametrize("kernel", sorted(TOL_LANES))
def test_lane_twins_match_single(seed_setup, refine_setup, kernel):
    """Each lane of a kernel's lane form (its plain twin, through the
    wrapper on CPU tensors: nothing launches) equals the unbatched twin on
    that lane's inputs bit for bit; a lane switched off gives zeros. The
    fused block (no lane mask) in each key mode: self-attention reads its
    own lane's rows only."""
    t = lambda a: None if a is None else torch.as_tensor(a)
    on = torch.tensor(LANE_MASK)
    before = (SK.seed_eval_full_kernel.launches, RK.refine_kernel.launches,
              FB.fused_attention_block.launches)
    with torch.no_grad():
        if kernel == "seed_eval_full":
            pack = SK.pack_seed_params_full(seed_setup["model"].agent_decoder,
                                            FULL_L, seed_setup["G"])
            sd0, args = t(seed_setup["sd0"]), _full_lane_args(seed_setup)
            got = SK.seed_eval_full_kernel(pack, sd0, *args, H_, 16,
                                           lanes=on)
            want = [SK.seed_eval_full_reference(
                pack, sd0, *(a[b] for a in args), H_, 16)
                for b in range(LANES)]
        elif kernel == "refine":
            _, layers, lanes = refine_setup
            pack = RK.pack_refine_params(layers, REF_L, REF_AH)
            args = [t(np.stack([x[k] for x in lanes])) for k in _REF_ARGS]
            got = RK.refine_kernel(pack, *args, H_F, 16, lanes=on)
            want = [RK.refine_reference(pack, *(a[b] for a in args), H_F,
                                        16) for b in range(LANES)]
        else:
            for mode in sorted(FUSED_QK):
                _, mod, x, src, r, mask = _fused_lanes(mode)
                pack = FB.pack_fused_block(mod)
                out = FB.fused_attention_block(pack, t(x), t(src), t(r),
                                               t(mask), H_F)
                assert out.shape == x.shape
                for b in range(LANES):
                    one = FB.fused_attention_block_reference(
                        pack, t(x[b]), None if src is None else t(src[b]),
                        t(r[b]), t(mask[b]), H_F)
                    assert torch.equal(out[b], one), (mode, b)
            got = None
    assert before == (SK.seed_eval_full_kernel.launches,
                      RK.refine_kernel.launches,
                      FB.fused_attention_block.launches)
    if got is None:
        return
    for part in got:
        assert part.shape[0] == LANES
    for b in range(LANES):
        if not LANE_MASK[b]:
            assert not any(part[b].any() for part in got), b
            continue
        for part, ref in zip(got, want[b]):
            assert torch.equal(part[b], ref), (kernel, b)


def _jax_full_lanes(s):
    """jax.vmap of the Pallas seed_eval_full_kernel (interpret mode) over
    the lanes' raw inputs, jitted once."""
    p, jdec, G = s["p"], s["jdec"], s["G"]
    Gp = -(-G // 128) * 128
    pack = JSK.pack_seed_params_full(p, FULL_L, G, jnp.float32)
    sel = JSK.selector(D_, H_, 16)
    sd0 = jnp.asarray(s["sd0"])[None]
    lane = lambda m, n: jnp.broadcast_to(m[:, None], (n, D_)).astype(
        jnp.float32)

    def one(x):
        def prep(mdl):
            return (mdl.embed_pl2sa_r(x["pl_r_raw"]),
                    mdl.embed_a2sa_r(x["a2sa_r_raw"]))
        r_pl, r_sa = jdec.apply({"params": p}, method=prep)
        kv = [JSF.precompute_src_kv(p[f"pt2sa_{i}"], x["x_pt"], None)
              for i in range(FULL_L)]
        occ = jnp.pad(x["occ_vec"].astype(jnp.float32), (0, Gp - G))[None]
        return JSK.seed_eval_full_kernel(
            pack, sd0, jnp.stack([k for k, _ in kv]),
            jnp.stack([v for _, v in kv]), r_pl, lane(x["pl_mask"], P_),
            x["agent_col"], r_sa, lane(x["a2sa_mask"], A_), occ, sel, H_, 16,
            interpret=True)

    xs = {k: jnp.stack([jnp.asarray(x[k]) for x in s["lanes"]])
          for k in s["lanes"][0]}
    small, pos = (np.asarray(a) for a in jax.jit(jax.vmap(one))(xs))
    return [np.concatenate([small[b, 0, :2], small[b, 1, :3],
                            small[b, 2, :3], pos[b, 0, :G]])
            for b in range(LANES)]


def _jax_refine_lanes(tree, lanes):
    """jax.vmap of the Pallas refine_kernel (interpret mode) over lanes,
    the [2, 128] output of each cut to its heading logits and offsets."""
    R = REF_R
    lane = lambda m: jnp.broadcast_to(m[:, None], (R, D_F)).astype(
        jnp.float32)

    def one(x):
        return JRK.refine_kernel(
            JRK.pack_refine_params(tree, REF_L, REF_AH, None), x["x_sub"],
            x["pl_keys"], x["r_pl"], lane(x["mask_pl"]), x["r_aa"],
            lane(x["mask_a"]), JRK.selector(D_F, H_F, 16), H_F, 16,
            interpret=True)

    xs = {k: jnp.stack([jnp.asarray(x[k]) for x in lanes]) for k in _REF_ARGS}
    out = np.asarray(jax.jit(jax.vmap(one))(xs))
    return [np.concatenate([out[b, 0, :REF_AH], out[b, 1, :2]])
            for b in range(LANES)]


@pytest.mark.parametrize("kernel", sorted(TOL_LANES))
def test_lane_forms_match_jax_vmap(seed_setup, refine_setup, kernel):
    """The lane form of each kernel (its plain twin) against jax.vmap of the
    JAX package's Pallas kernel in interpret mode, on the same numpy
    inputs and converted weights, fp32, lane by lane, within the tolerance
    of the kernel's own port test (summation order only). The fused block
    in self mode, whose keys are the lane's own rows (the rollout's other
    calls gather keys per query row, where lanes are only more rows)."""
    tol = TOL_LANES[kernel]
    t = lambda a: None if a is None else torch.as_tensor(a)
    if kernel == "seed_eval_full":
        want = _jax_full_lanes(seed_setup)
        pack = SK.pack_seed_params_full(seed_setup["model"].agent_decoder,
                                        FULL_L, seed_setup["G"])
        with torch.no_grad():
            small, pos = SK.seed_eval_full_kernel(
                pack, t(seed_setup["sd0"]), *_full_lane_args(seed_setup),
                H_, 16)
        got = [torch.cat([small[b, 0, :2], small[b, 1, :3], small[b, 2, :3],
                          pos[b]]).numpy() for b in range(LANES)]
    elif kernel == "refine":
        tree, layers, lanes = refine_setup
        want = _jax_refine_lanes(tree, lanes)
        pack = RK.pack_refine_params(layers, REF_L, REF_AH)
        with torch.no_grad():
            head, off = RK.refine_kernel(
                pack, *(t(np.stack([x[k] for x in lanes]))
                        for k in _REF_ARGS), H_F, 16)
        got = [torch.cat([head[b], off[b]]).numpy() for b in range(LANES)]
    else:
        tree, mod, x, _, r, mask = _fused_lanes("self")
        fn = jax.jit(jax.vmap(lambda x_, r_, m_: j_fused(
            tree, x_, None, r_, m_, H_F, interpret=True)))
        want = list(np.asarray(fn(x, r, mask)))
        with torch.no_grad():
            got = list(FB.fused_attention_block(
                FB.pack_fused_block(mod), t(x), None, t(r), t(mask),
                H_F).numpy())
    assert len(got) == len(want)
    for b, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, atol=tol, rtol=0,
                                   err_msg=f"{kernel} lane {b}")


# --------------------------------------------------------------------- #
# the three kernel flags over lanes
# --------------------------------------------------------------------- #

LANE_FLAGS = {"use_fused_block": dict(use_fused_block=True),
              "use_seed_kernel_full": dict(use_seed_kernel_full=True),
              "use_refine_kernel": dict(use_refine_kernel=True)}
ALL_THREE = {k: v for f in LANE_FLAGS.values() for k, v in f.items()}
# tests/test_torch_variant_rollouts.py's config (one agent and one seed
# layer), 30 frames, forced insertion; the two lanes' scenarios
ROLL = {**ROLLOUT_CFG, "num_agent_layers": 1, "num_seed_layers": 1,
        "num_recurrent_steps_val": 30}
ROLL_SCENS = ((2, 10), (3, 6))           # (seed, agents)
ROLL_KEY = 0                             # the JAX input key


def _jax_vmapped_rollout(params):
    """The map uniforms of the JAX input key, and the JAX package's rollout
    with the flax `params` under all three flags as jax.jit(jax.vmap) over
    the two lanes (the JAX server's batched program), beam 1, forced
    insertion."""
    jcfg = JConfig(**ROLL, **ALL_THREE)
    jattr = JAttr(jcfg.grid_range, jcfg.grid_interval, jcfg.pl2seed_radius,
                  jcfg.angle_interval)
    jmt, jmv = JMotion(), j_map_vocab()
    key = jax.random.PRNGKey(ROLL_KEY)
    uniforms = np.array(jax.random.uniform(jax.random.split(key)[0],
                                           (jcfg.max_map_tokens,)))
    jscens = [j_synthetic(jcfg, seed=s, num_agents=n) for s, n in ROLL_SCENS]
    build = jax.jit(lambda sc, k: j_build_inputs(jcfg, jmt, jattr, sc, k))
    stack = lambda trees: jax.tree.map(lambda *a: jnp.stack(a), *trees)
    jfn = j_rollout_fn(JModel(jcfg, jattr.grid, jattr.grid_size,
                              jattr.angle_size), jcfg, jattr, jmt, jmv,
                       jit=False, force_insert=True)
    keys = jax.random.split(jax.random.PRNGKey(7), len(ROLL_SCENS))
    out = jax.device_get(jax.jit(jax.vmap(jfn, in_axes=(None, 0, 0, 0)))(
        params, stack(jscens), stack([build(sc, key) for sc in jscens]),
        keys))
    return uniforms, out


@pytest.fixture(scope="module", autouse=True)
def jax_lanes_rollout():
    """The port at ROLL under all three flags with random weights, and the
    JAX side of test_lane_flags_rollout_matches_jax_vmap on the same
    weights (its trace, compile and run), started at the module's first
    test in a process of its own, since its trace is Python-bound and
    would hold this process's interpreter lock from the tests beside it.
    The last test of the module collects it; without that test the
    process ends unread when the module does."""
    cfg = Config(**ROLL, **ALL_THREE)
    tok = cli.build_tokenizers(cfg)
    model = cli.build_model(cfg, tok[0], "cpu")
    params = _decoder_tree(model, np.random.default_rng(0))
    pool = multiprocessing.get_context("spawn").Pool(1)
    try:
        yield cfg, tok, model.eval(), pool.apply_async(_jax_vmapped_rollout,
                                                       (params,))
    finally:
        pool.terminate()
        pool.join()


@pytest.fixture(scope="module")
def stop_apart():
    """test_forced_insertion_lanes_stop_apart's beam-1 setup (insert_limit
    4, seed_eval) over 15 frames, lanes of 13 and 4 live agents: forced
    insertion fills the first within a few iterations and the second only
    when its budget runs out, so the kernels' lane masks switch the lanes
    off at different iterations. With the batch's lanes and host reads
    with every kernel flag but seed_eval's off."""
    cfg = Config(**dict(TINY, insert_limit=4, num_recurrent_steps_val=15,
                        use_seed_kernel=True))
    tok = cli.build_tokenizers(cfg)
    model = cli.build_model(cfg, tok[0], "cpu")
    scens = [make_synthetic_scenario(cfg, seed=s, num_agents=n)
             for s, n in ((5, 13), (7, 4))]
    off, reads_off, _ = _lane_rollouts(cfg, tok, model, scens, {},
                                       singles=False)
    return cfg, tok, model, scens, off, reads_off


def _lane_rollouts(cfg, tok, model, scens, flags, singles=True):
    """(the lanes of a batched rollout of `scens` under `flags`, its host
    reads, each scenario's single rollout or None), beam 1, forced
    insertion, the inputs from generator seeds 40 + i."""
    attr, mt, mv = tok
    c = cfg.replace(**flags)
    fn = CL.make_rollout_fn(model, c, attr, mt, mv, force_insert=True)
    lanes = [S.to_device(sc, "cpu") for sc in scens]
    inputs = [build_model_inputs(c, mt, attr, sd,
                                 torch.Generator().manual_seed(40 + i))
              for i, sd in enumerate(lanes)]
    gens = lambda: [torch.Generator().manual_seed(50 + i)
                    for i in range(len(lanes))]
    out = fn(S.stack_scenarios(lanes), S.stack_scenarios(inputs), gens())
    reads = fn.host_reads
    if singles:
        singles = [fn(sd, inp, g)
                   for sd, inp, g in zip(lanes, inputs, gens())]
    return ([{k: v[b] for k, v in out.items()} for b in range(len(lanes))],
            reads, singles or None)


@pytest.mark.parametrize("flag", sorted(LANE_FLAGS))
def test_lane_flags_serve_lanes(stop_apart, flag):
    """Under each of the three flags a two-lane rollout runs (their kernels
    take lanes now) whose lanes stop inserting at different iterations:
    each lane gives its single rollout's decisions bitwise and its poses
    within LANE_POSE_TOL, and the batch reads the host as often as with
    the flag off."""
    cfg, tok, model, scens, off, reads_off = stop_apart
    lanes, reads, singles = _lane_rollouts(cfg, tok, model, scens,
                                           LANE_FLAGS[flag])
    assert reads == reads_off
    per_step = np.stack([lane["per_step_inserted"].numpy()
                         for lane in lanes])
    assert any(len(set(col)) > 1 for col in per_step.T), per_step
    for lane, single, plain in zip(lanes, singles, off):
        _same(lane, single, pose_tol=LANE_POSE_TOL["beam1"])
        np.testing.assert_array_equal(lane["next_token_idx"].numpy(),
                                      plain["next_token_idx"].numpy())


def test_chunked_fleet_under_lane_flags(tiny):
    """A fleet of two scenarios through make_chunked_stream_runner under
    all three flags (one chunk of two segments, beam 1) gives in each lane
    the scenario's own stream with the seed the runner gives that lane:
    states and types bitwise, poses within LANE_POSE_TOL, the same agents
    ever alive."""
    cfg0, tok, model = tiny
    cfg = cfg0.replace(insert_limit=2, insert_beam_size=1, **ALL_THREE)
    Hs, P, seg = cfg.num_historical_steps, cfg.max_map_tokens, 10
    scens = [make_synthetic_scenario(cfg, seed=s, num_agents=n)
             for s, n in ((0, 6), (3, 9))]
    runner = ST.make_chunked_stream_runner(cfg, *tok, segment_steps=seg)
    outs, used = runner(model, scens, ((cfg.max_agents, 2),), 5)
    assert used == [cfg.max_agents]
    fn = ST.make_stream_fn(model, cfg, *tok, segment_steps=seg,
                           n_segments=2)
    ever = []
    for i, sc in enumerate(scens):
        own = fn(repad_scenario(compact_scenario(sc)[0], cfg.max_agents, P),
                 ST.seed_of(5, 0, i))
        want = ST.stitch_stream_outputs(own, Hs)
        got = ST.stitch_stream_outputs(
            {k: v[i] for k, v in outs[0].items() if k != "final_agents"}, Hs)
        for k in ("state", "type"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k in ("traj", "head", "shape"):
            np.testing.assert_allclose(got[k], want[k], rtol=0, err_msg=k,
                                       atol=LANE_POSE_TOL["beam1"])
        ever.append(want["state"].shape[0])
    assert runner.agents_ever_alive == ever
    assert sum(int(o["n_inserted"].sum()) for o in outs) > 0


def test_lane_flags_rollout_matches_jax_vmap(jax_lanes_rollout):
    """A two-lane rollout of the port under all three flags against
    jax.jit(jax.vmap) of the JAX package's rollout under the same flags
    (both sides' kernels as their plain versions: the Pallas kernels in
    interpret mode, the port's twins), beam 1, fp32, forced insertion, the
    same converted weights and map uniforms: per lane, token ids, state
    ids, slot activity and insertion counts bitwise (PARITY.md), poses
    within POSE_TOL."""
    cfg, (attr, mt, mv), model, jax_side = jax_lanes_rollout
    uniforms, jout = jax_side.get()
    fn = CL.make_rollout_fn(model, cfg, attr, mt, mv, force_insert=True)
    scens = [S.to_device(make_synthetic_scenario(cfg, seed=s, num_agents=n),
                         "cpu") for s, n in ROLL_SCENS]
    inputs = [build_model_inputs(cfg, mt, attr, sd,
                                 pt_uniform=torch.as_tensor(uniforms))
              for sd in scens]
    out = fn(S.stack_scenarios(scens), S.stack_scenarios(inputs),
             [torch.Generator().manual_seed(7 + i) for i in range(2)])
    lanes = [{k: v[b] for k, v in out.items()} for b in range(2)]
    for b, lane in enumerate(lanes):
        assert set(lane) == set(jout)
        for k in EXACT:
            np.testing.assert_array_equal(lane[k].numpy(),
                                          np.asarray(jout[k])[b],
                                          err_msg=f"lane {b} {k}")
        for k in CLOSE:
            np.testing.assert_allclose(lane[k].numpy(),
                                       np.asarray(jout[k])[b], atol=POSE_TOL,
                                       rtol=0, err_msg=f"lane {b} {k}")
        assert int(lane["n_inserted"]) > 0


# --------------------------------------------------------------------- #
# the command line
# --------------------------------------------------------------------- #

def test_cli_batched_rollout_on_cpu(capsys):
    """`rollout --batch B` serves the scenarios through rollout_batch and
    reports its batches, ms per batched token step and agent-steps/s."""
    cfg_path = os.path.join(os.path.dirname(__file__), "..", "configs",
                            "tiny_smoke.yaml")
    cli.main(["rollout", "--config", cfg_path, "--synthetic", "--device",
              "cpu", "--force-insert", "--num-recurrent-steps", "10",
              "--num-scenarios", "3", "--batch", "2"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["token_steps"] == 2 and summary["batch"] == 2
    assert sum(b["scenarios"] for b in summary["batches"]) == 3
    assert all(b["lanes"] <= 2 for b in summary["batches"])
    assert summary["agent_steps"] > 0 and summary["agent_steps_per_s"] > 0
    assert len(summary["agents_inserted"]) == 3
