"""The PyTorch port's closed-loop rollout, held against the JAX package's on
the CPU (the parity protocol of PARITY.md).

At motion_beam_size = insert_beam_size = 1 top-k sampling is an argmax, so
both rollouts are deterministic functions of the same weights and no random
streams need aligning. The JAX side runs its seed kernel in Pallas interpret
mode, as its own tests do; the port's wrapper takes the plain version for
CPU tensors. Token ids, state ids, slot activity and insertion counts must be
bitwise equal; poses agree within 1e-3 (fp32 reduction order only).

The horizon, 70 frames, gives 14 token steps: Ti = 16 columns, past the
temporal window of W = 12, so the window evicts columns and inserted agents'
bos columns leave it while they live (tests/test_rollout_parity_long.py's
forced-insertion regime). There, as in that test, a token id may differ
only as a certified near-tie argmax flip (PARITY.md): the JAX logits of the
two candidates within 5e-3 of each other and the top two, in at most 1% of
cells; states, insertion counts and attributes stay bitwise. The JAX
logits come from a debug compile made only when a token differs.
"""

import filecmp
import json
import multiprocessing
import os

import jax
import numpy as np
import pytest
import torch

from infgen_tpu.config import Config as JConfig
from infgen_tpu.data import preprocess as JPP
from infgen_tpu.data.waymo import pkl_to_scenario as j_pkl_to_scenario
from infgen_tpu.data.features import build_model_inputs as j_build_inputs
from infgen_tpu.data.synthetic import make_synthetic_scenario as j_synthetic
from infgen_tpu.model.infgen import InfGenModel as JModel
from infgen_tpu.rollout.closed_loop import make_rollout_fn as j_rollout_fn
from infgen_tpu.tokenizers.attr_tokenizer import AttrTokenizer as JAttr
from infgen_tpu.tokenizers.map_tokenizer import MapTokenizer as JMapTok
from infgen_tpu.tokenizers.motion_tokenizer import MotionTokenizer as JMotion
from infgen_tpu.tokenizers.vocab import load_map_vocab as j_map_vocab

from infgen_torch import cli
from infgen_torch.config import Config
from infgen_torch.convert import load_flax_params
from infgen_torch.data import preprocess as PP
from infgen_torch.data import womd_synthetic as WS
from infgen_torch.data.features import build_model_inputs
from infgen_torch.data.scenario import to_device
from infgen_torch.data.synthetic import make_synthetic_scenario
from infgen_torch.data.waymo import pkl_to_scenario
from infgen_torch.model.infgen import InfGenModel
from infgen_torch.rollout.closed_loop import make_rollout_fn
from infgen_torch.rollout.serving import RolloutServer
from infgen_torch.tokenizers.attr_tokenizer import AttrTokenizer
from infgen_torch.tokenizers.map_tokenizer import MapTokenizer
from infgen_torch.tokenizers.motion_tokenizer import MotionTokenizer
from infgen_torch.tokenizers.vocab import load_map_vocab
from infgen_torch.utils.device import resolve_device

import test_torch_export as TE
from test_torch_layers import (  # noqa: F401 (one_torch_thread: autouse)
    random_flax_params, one_torch_thread)

CFG = dict(max_agents=16, max_map_tokens=128, num_agent_layers=3,
           num_seed_layers=3, num_map_layers=1, hidden_dim=32, num_heads=2,
           head_dim=16, num_freq_bands=8, num_recurrent_steps_val=70,
           use_seed_kernel=True, compute_dtype="float32",
           motion_beam_size=1, insert_beam_size=1)
POSE_TOL = 1e-3
NEAR_TIE = 5e-3          # PARITY.md's certified flip: logit gap below this
EXACT = ("next_token_idx", "next_state_idx", "slot_active", "n_inserted",
         "per_step_inserted", "grid_index", "pred_type", "valid_mask")
CLOSE = ("pos_a", "head_a", "pred_traj", "pred_head", "pred_state",
         "pred_shape", "seed_probs")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    jcfg = JConfig(**CFG)
    jattr = JAttr(jcfg.grid_range, jcfg.grid_interval, jcfg.pl2seed_radius,
                  jcfg.angle_interval)
    jmt = JMotion()
    jmv = j_map_vocab()
    jscen = j_synthetic(jcfg, seed=2, num_agents=10)
    key = jax.random.PRNGKey(0)
    jbuild = jax.jit(lambda s, k: j_build_inputs(jcfg, jmt, jattr, s, k))
    jinputs = jbuild(jscen, key)
    pt_uniform = np.array(jax.random.uniform(
        jax.random.split(key)[0], (jcfg.max_map_tokens,)))
    params = random_flax_params(jcfg, seed=0)

    cfg = Config(**CFG)
    attr = AttrTokenizer(cfg.grid_range, cfg.grid_interval,
                         cfg.pl2seed_radius, cfg.angle_interval)
    mt, mv = MotionTokenizer(), load_map_vocab()
    scen = to_device(make_synthetic_scenario(cfg, seed=2, num_agents=10),
                     "cpu")
    inputs = build_model_inputs(cfg, mt, attr, scen,
                                pt_uniform=torch.as_tensor(pt_uniform))
    model = InfGenModel(cfg, attr.grid, attr.grid_size, attr.angle_size)
    load_flax_params(model, params)
    model.eval()
    # the insert mode's exported rollout (test_artifact_matches_jax), made
    # in a spawned process while the JAX side compiles
    pool = multiprocessing.get_context("spawn").Pool(1)
    artifact = pool.apply_async(TE.export_and_run, (
        CFG, model.state_dict(), scen, inputs,
        str(tmp_path_factory.mktemp("export") / "rollout.pt2"), True, 7))

    runs, logits, jfns = {}, {}, {}
    for mode, over, force in (("insert", {}, True),
                              ("motion", {"disable_insertion": True}, False)):
        jc, c = jcfg.replace(**over), cfg.replace(**over)
        jmodel = JModel(jc, jattr.grid, jattr.grid_size, jattr.angle_size)
        jfn = j_rollout_fn(jmodel, jc, jattr, jmt, jmv, jit=True,
                           force_insert=force)
        jfns[mode] = (jfn, jmodel, jc)
        jout = jax.device_get(jfn(params, jscen, jinputs,
                                  jax.random.PRNGKey(7)))
        fn = make_rollout_fn(model, c, attr, mt, mv, force_insert=force)
        out = fn(scen, inputs, torch.Generator().manual_seed(7))
        runs[mode] = (jout, {k: _np(v) for k, v in out.items()})
        logits[mode] = _debug_logits(jmodel, jc, (jattr, jmt, jmv), force,
                                     (params, jscen, jinputs))
    try:
        yield dict(jscen=jscen, jinputs=jinputs, scen=scen, inputs=inputs,
                   runs=runs, logits=logits, model=model, cfg=cfg,
                   tok=(attr, mt, mv), jtok=(jattr, jmt, jmv), jfns=jfns,
                   jbuild=jbuild, params=params, pt_uniform=pt_uniform,
                   artifact=artifact)
    finally:
        pool.terminate()
        pool.join()


def _debug_logits(jmodel, jcfg, jtok, force, args):
    """The JAX rollout's per-step token logits [step, A, V] (or another of
    its debug outputs, `key`), from a second compile with debug=True, made
    only when first called: only a token flip and the debug test need
    them."""
    cache = {}

    def get(key="debug_token_logits"):
        if not cache:
            jfn = j_rollout_fn(jmodel, jcfg, *jtok, jit=True,
                               force_insert=force, debug=True)
            cache.update(jax.device_get(jfn(*args, jax.random.PRNGKey(7))))
        return np.asarray(cache[key], np.float64)
    return get


def certified_flips(port_tok, jax_tok, logits, H=2):
    """Rows whose token ids differ from JAX's, each difference certified as
    a near-tie argmax flip as tests/test_rollout_parity_long.py certifies
    them: at most 1% of cells, and at each the two tokens are the top two
    of the JAX logits (`logits()` [step, A, V]; step s predicts column
    s + H) with a gap below NEAR_TIE."""
    diff = np.argwhere(port_tok != jax_tok)
    assert len(diff) <= max(1, port_tok.size // 100), \
        f"{len(diff)} token flips of {port_tok.size} cells"
    if len(diff):
        logits = logits()
    for r, c in diff:
        lg = logits[c - H, r]
        gap = abs(lg[port_tok[r, c]] - lg[jax_tok[r, c]])
        assert gap < NEAR_TIE, (f"row {r} col {c}: port {port_tok[r, c]} vs"
                                f" jax {jax_tok[r, c]}, logit gap {gap:.2e}")
        assert set(np.argsort(lg)[::-1][:2]) == {port_tok[r, c],
                                                 jax_tok[r, c]}
    return sorted({int(r) for r, _ in diff})


def assert_matches_jax(out, jout, logits):
    """EXACT bitwise (token ids up to certified flips) and CLOSE within
    POSE_TOL on the rows without a flip."""
    flipped = certified_flips(out["next_token_idx"],
                              np.asarray(jout["next_token_idx"]), logits)
    for k in EXACT:
        if k != "next_token_idx":
            np.testing.assert_array_equal(out[k], np.asarray(jout[k]),
                                          err_msg=k)
    keep = np.setdiff1d(np.arange(out["pos_a"].shape[0]), flipped)
    for k in CLOSE:
        a, b = out[k], np.asarray(jout[k])
        if k != "seed_probs":
            a, b = a[keep], b[keep]
        np.testing.assert_allclose(a, b, atol=POSE_TOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("mode", ["insert", "motion"])
def test_rollout_matches_jax(both, mode):
    jout, out = both["runs"][mode]
    assert set(out) == set(jout)
    # the horizon crosses the temporal window
    assert out["next_token_idx"].shape[1] > both["cfg"].time_span // 5
    if mode == "insert":
        assert_matches_jax(out, jout, both["logits"][mode])
        # forced insertion really inserted agents and ran the seed path
        assert int(out["n_inserted"]) > 0
        return
    # motion mode: bitwise through every window roll, no flip allowed
    for k in EXACT:
        np.testing.assert_array_equal(out[k], np.asarray(jout[k]), err_msg=k)
    for k in CLOSE:
        np.testing.assert_allclose(out[k], np.asarray(jout[k]),
                                   atol=POSE_TOL, rtol=0, err_msg=k)
    assert int(out["n_inserted"]) == 0


def test_rollout_batch_lane_matches_jax(both):
    """The fixture's scenario as lane 0 of a two-lane batch through
    RolloutServer.rollout_batch, beside another scenario: lane 0 equals the
    JAX package's rollout of it as the single rollout does. No new JAX
    compile: the fixture's insert-mode output."""
    attr, mt, mv = both["tok"]
    cfg = both["cfg"]
    srv = RolloutServer(cfg, attr, mt, mv, agent_buckets=(cfg.max_agents,),
                        agent_headroom=0, force_insert=True)
    scens = [make_synthetic_scenario(cfg, seed=2, num_agents=10),
             make_synthetic_scenario(cfg, seed=3, num_agents=7)]
    outs = srv.rollout_batch(both["model"], scens, [7, 8])
    assert srv.last_dispatch["batches"] == [(cfg.max_agents,
                                             cfg.max_map_tokens, 2, 2)]
    jout, single = both["runs"]["insert"]
    lane0 = {k: _np(v) for k, v in outs[0].items()}
    assert_matches_jax(lane0, jout, both["logits"]["insert"])
    assert int(lane0["n_inserted"]) == int(single["n_inserted"]) > 0
    assert int(outs[1]["n_inserted"]) > 0


def test_model_inputs_match_jax(both):
    """The port's synthetic scenario and input chain equal the JAX ones on
    the same seed and the same map-mask uniforms."""
    jscen, scen = both["jscen"], both["scen"]
    for part in ("agents", "map"):
        for name in getattr(jscen, part)._fields:
            a = np.asarray(getattr(getattr(jscen, part), name))
            b = _np(getattr(getattr(scen, part), name))
            np.testing.assert_allclose(b, a, atol=1e-5, rtol=0,
                                       err_msg=f"{part}.{name}")
    jin, tin = both["jinputs"], both["inputs"]
    for name in jin._fields:
        if name == "tokens":
            for f in jin.tokens._fields:
                np.testing.assert_allclose(
                    _np(getattr(tin.tokens, f)),
                    np.asarray(getattr(jin.tokens, f)), atol=1e-4, rtol=0,
                    err_msg=f"tokens.{f}")
            continue
        a, b = np.asarray(getattr(jin, name)), _np(getattr(tin, name))
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, atol=1e-4, rtol=0,
                                       err_msg=name)


def test_womd_scenario_matches_jax(both):
    """A preprocessed WOMD scenario (data/womd_synthetic.py's bytes, 12
    agents, through each package's preprocessing and pkl loader, padded to
    CFG) rolled out by the JAX package and the port under PARITY.md, with
    forced insertion. The fixture's jitted JAX rollout and input builder
    run again at the same shapes: no new compile."""
    cfg, jcfg = both["cfg"], JConfig(**CFG)
    attr, mt, mv = both["tok"]
    raw = WS.random_scenario(np.random.default_rng(5), "womd", 12,
                             map_length_m=300.0)
    jscen = j_pkl_to_scenario(JPP.scenario_to_pkl_dict(raw, JMapTok()), jcfg,
                              JMapTok(), training=False)
    scen = pkl_to_scenario(PP.scenario_to_pkl_dict(raw, MapTokenizer()), cfg,
                           MapTokenizer(), training=False)
    for part in ("agents", "map"):
        for name in getattr(jscen, part)._fields:
            np.testing.assert_array_equal(
                getattr(getattr(scen, part), name),
                getattr(getattr(jscen, part), name), err_msg=name)
    jfn, jmodel, jc = both["jfns"]["insert"]
    jinputs = both["jbuild"](jscen, jax.random.PRNGKey(0))
    args = (both["params"], jscen, jinputs)
    jout = jax.device_get(jfn(*args, jax.random.PRNGKey(7)))
    s = to_device(scen, "cpu")
    inputs = build_model_inputs(cfg, mt, attr, s, pt_uniform=torch.as_tensor(
        both["pt_uniform"]))
    out = make_rollout_fn(both["model"], cfg, attr, mt, mv,
                          force_insert=True)(
        s, inputs, torch.Generator().manual_seed(7))
    out = {k: _np(v) for k, v in out.items()}
    assert_matches_jax(out, jout, _debug_logits(jmodel, jc, both["jtok"],
                                                True, args))
    assert int(scen.agents.slot_mask.sum()) == 12
    assert int(out["n_inserted"]) > 0


def test_fixed_trip_matches_early_exit(both):
    """insertion_fixed_trip (insert_limit masked iterations, no host read)
    gives the early-exit loop's results when no random draw is made."""
    attr, mt, mv = both["tok"]
    fn = make_rollout_fn(both["model"],
                         both["cfg"].replace(insertion_fixed_trip=True),
                         attr, mt, mv, force_insert=True)
    out = {k: _np(v) for k, v in fn(both["scen"], both["inputs"],
                                     torch.Generator().manual_seed(7)).items()}
    assert fn.host_reads == 0      # the ego index is gathered on the device
    ref = both["runs"]["insert"][1]
    for k in EXACT:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    for k in CLOSE:
        np.testing.assert_allclose(out[k], ref[k], atol=1e-6, rtol=0,
                                   err_msg=k)


def test_debug_outputs_match_jax(both):
    """debug=True (motion mode): the per-step head logits and trunk columns
    against the JAX package's debug outputs, and nothing else changed;
    insert mode: the port's per-head insertion records, each choice the
    decision the rollout made with it, -1 / inf where a step made no
    decision of the kind."""
    from infgen_torch.config import ENTER_STATE
    attr, mt, mv = both["tok"]
    cfg = both["cfg"]
    heads = ["seed_type"] \
        + ["seed_grid"] * cfg.use_grid_token \
        + ["refine_head"] * cfg.use_head_token
    for mode, over, force in (("motion", {"disable_insertion": True}, False),
                              ("insert", {}, True)):
        fn = make_rollout_fn(both["model"], cfg.replace(**over), attr, mt,
                             mv, force_insert=force, debug=True)
        out = {k: _np(v) for k, v in fn(
            both["scen"], both["inputs"],
            torch.Generator().manual_seed(7)).items()}
        ref = both["runs"][mode][1]
        assert set(out) - set(ref) == {
            f"debug_{k}" for k in ("token_logits", "state_logits",
                                   "layer_cols")} | {
            f"debug_{h}_{r}" for h in heads for r in ("top2", "gap")}
        for k in ref:
            np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
        n_steps = cfg.num_recurrent_steps_val // 5
        assert out["debug_layer_cols"].shape == (
            n_steps, cfg.num_agent_layers, cfg.max_agents, cfg.hidden_dim)
        if mode == "motion":
            get = both["logits"][mode]
            for k in ("token_logits", "state_logits", "layer_cols"):
                np.testing.assert_allclose(out[f"debug_{k}"],
                                           get(f"debug_{k}"), atol=1e-4,
                                           rtol=0, err_msg=k)
            for h in heads:
                assert np.isinf(out[f"debug_{h}_gap"]).all()
                assert (out[f"debug_{h}_top2"] == -1).all()
            continue
        # one seed evaluation per insert plus the one that stops the step;
        # one refine per insertion iteration
        H = (cfg.num_historical_steps - 1) // 5
        n_ins = out["per_step_inserted"]
        assert n_ins[1:].sum() > 0
        for h in heads:
            E = cfg.insert_limit + (h != "refine_head")
            top2, gap = out[f"debug_{h}_top2"], out[f"debug_{h}_gap"]
            assert top2.shape == (n_steps, E, 2) and gap.shape == (n_steps, E)
            assert np.isinf(gap[0]).all() and (top2[0] == -1).all()
            for t in range(1, n_steps):
                m = n_ins[t] + (h != "refine_head")
                assert np.isfinite(gap[t, :m]).all() and (gap[t, :m] >= 0).all()
                assert (top2[t, :m, 0] != top2[t, :m, 1]).all()
                assert np.isinf(gap[t, m:]).all() and (top2[t, m:] == -1).all()
                # the step's inserts fill the free slots in ascending order;
                # evaluation j chose insert j's type and grid cell
                rows = np.nonzero(
                    out["next_state_idx"][:, t + H - 1] == ENTER_STATE)[0]
                assert len(rows) == n_ins[t]
                if h == "seed_type":
                    np.testing.assert_array_equal(
                        top2[t, :n_ins[t], 0], out["pred_type"][rows])
                if h == "seed_grid":
                    np.testing.assert_array_equal(
                        top2[t, :n_ins[t], 0],
                        out["grid_index"][rows, t + H - 1])


def test_cli_rollout_on_cpu(capsys):
    """The command line's rollout sub-command, asked for the CPU, prints one
    JSON summary line."""
    cfg_path = os.path.join(os.path.dirname(__file__), "..", "configs",
                            "tiny_smoke.yaml")
    cli.main(["rollout", "--config", cfg_path, "--synthetic", "--device",
              "cpu", "--force-insert", "--num-recurrent-steps", "10"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["device"] == "cpu" and summary["token_steps"] == 2
    assert summary["seed_kernel_launches"] == 0
    assert len(summary["ms_per_token_step"]) == 1


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("name", ["agent_vocab.npz", "map_vocab.npz"])
def test_vocab_copies_identical(name):
    root = os.path.join(os.path.dirname(__file__), "..")
    assert filecmp.cmp(os.path.join(root, "infgen_tpu", "tokens", name),
                       os.path.join(root, "infgen_torch", "tokens", name),
                       shallow=False)


def test_artifact_matches_jax(both):
    """The exported rollout (infgen_torch/rollout/export.py) of the insert
    mode, beam 1, forced insertion, loaded back and run on the fixture's
    inputs, against the JAX package's rollout the fixture compiled:
    decisions bitwise, poses within POSE_TOL. Exported and run in a
    spawned process started by the fixture."""
    out, ops, header = both["artifact"].get(timeout=900)
    jout = both["runs"]["insert"][0]
    assert set(out) == set(jout)
    assert "seed_eval" in ops and header["force_insert"]
    for k in EXACT:
        np.testing.assert_array_equal(out[k], np.asarray(jout[k]),
                                      err_msg=k)
    for k in CLOSE:
        np.testing.assert_allclose(out[k], np.asarray(jout[k]),
                                   atol=POSE_TOL, rtol=0, err_msg=k)
    assert int(out["n_inserted"]) > 0
