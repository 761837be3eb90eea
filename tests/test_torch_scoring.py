"""The scored closed-loop flow of the port on the CPU: a rollout of the
rollout tests' tiny config (90 frames) scored through the JAX package's
compute_metric_features -> compute_scenario_metrics (jitted once) and
through the port's; `cli validate`; the offline npz files across the two
packages; several rollouts per scenario.

Tolerances: on the same output arrays the two packages' features agree as
tests/test_torch_metrics.py holds them (1e-5 abs and relative, distances
1e-4 abs, accelerations on top of their speeds' difference, booleans
exact unless certified) and their likelihoods within 1e-5,
unless a value sits within 1e-5 (relative, at least absolute) of a
histogram edge and lands in the neighbouring bin (a certified near-edge
flip, counted by wosac.bin_flips). Given the same feature arrays, the two
scorers agree within 1e-6.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
import yaml

from infgen_tpu.metrics import features as JF
from infgen_tpu.metrics import map_distance as JMD
from infgen_tpu.metrics import offline as JOFF
from infgen_tpu.metrics import wosac as JW

from infgen_torch import cli
from infgen_torch.config import Config
from infgen_torch.data.synthetic import make_synthetic_scenario
from infgen_torch.metrics import features as F
from infgen_torch.metrics import offline as OFF
from infgen_torch.metrics import wosac as W
from infgen_torch.train.loop import SyntheticDataset

from test_torch_layers import one_torch_thread  # noqa: F401 (autouse)
from test_torch_metrics import assert_accel
from test_torch_rollout import CFG

FRAMES = 90              # 101 frames with the history: 3 windows of 80
SCORE_TOL = 1e-5         # likelihoods, each package on its own features
SAME_TOL = 1e-6          # likelihoods, both scorers on the same features
FEAT_TOL, DIST_TOL = 1e-5, 1e-4


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _jax_score(log_args, sim_args):
    wcfg = JW.WosacConfig()
    log = JF.compute_metric_features(*log_args[:-1], traj_z=log_args[-1])
    sim = JF.compute_metric_features(*sim_args)
    ld = JW.make_log_distributions(wcfg, log)
    return log, sim, ld, JW.compute_scenario_metrics(wcfg, ld, sim)


@pytest.fixture(scope="module")
def scored():
    """One port rollout of the tiny config on the CPU (random weights from
    the config's seed, forced insertion so placements occur), its log and
    model inputs, and the JAX package's features and scores of it. The
    tiny map keeps 128 tokens and no road edge, so the rollout is scored
    against the road edges of the same synthetic map at 1024 tokens."""
    cfg = Config(**dict(CFG, num_recurrent_steps_val=FRAMES))
    tok = cli.build_tokenizers(cfg)
    model = cli.build_model(cfg, tok[0], "cpu")
    (scen, s, inputs), = cli.validation_inputs(cfg, tok, "cpu", 1)
    fn = cli.make_rollout_fn(model, cfg, *tok, force_insert=True)
    out = fn(s, inputs, torch.Generator().manual_seed(3))
    edges, cyclic = JMD.packed_road_edges(make_synthetic_scenario(
        cfg.replace(max_map_tokens=1024), seed=0).map)
    o = {k: _np(v) for k, v in out.items()}
    ag = scen.agents
    log_args = (ag.position[..., :2], ag.heading, ag.valid, ag.shape[:, 0],
                ag.shape[:, 1], ag.slot_mask, ag.av_index,
                _np(inputs.tokens.token_pos), _np(inputs.tokens.state_idx),
                None, None, ag.elevation)
    sim_args = (o["pred_traj"], o["pred_head"], o["pred_valid"],
                o["eval_shape"][:, 0], o["eval_shape"][:, 1],
                o["slot_active"], o["av_index"], o["pos_a"],
                o["next_state_idx"], edges, cyclic)
    jax_res = jax.tree.map(np.asarray, jax.jit(_jax_score)(log_args,
                                                           sim_args))
    return dict(cfg=cfg, tok=tok, scen=scen, s=s, inputs=inputs, out=out,
                edges=torch.as_tensor(edges), cyclic=torch.as_tensor(cyclic),
                jax=jax_res)


def _port_features(d):
    log = OFF.log_features(d["s"], d["inputs"])
    sim = OFF.rollout_features(d["out"], d["edges"], d["cyclic"])
    return log, sim


def test_rollout_features_match_jax(scored):
    log, sim = _port_features(scored)
    jlog, jsim = scored["jax"][:2]
    assert int(scored["out"]["n_inserted"]) > 0
    for got, ref in ((log, jlog), (sim, jsim)):
        for name in got._fields:
            g, r = _np(getattr(got, name)), np.asarray(getattr(ref, name))
            assert g.shape == r.shape, name
            if r.dtype == bool:
                dist = ref.distance_to_road_edge if name == "offroad_per_step" \
                    else ref.distance_to_nearest_object
                near = np.abs(np.asarray(dist)) < 1e-5
                assert not ((g != r) & ~near).any(), name
            elif r.dtype.kind in "iu":
                np.testing.assert_array_equal(g, r, err_msg=name)
            elif name == "linear_acceleration":
                assert_accel(g, r, got.linear_speed, ref.linear_speed)
            else:
                tol = DIST_TOL if "distance" in name else FEAT_TOL
                np.testing.assert_allclose(g, r, atol=tol, rtol=FEAT_TOL,
                                           equal_nan=True, err_msg=name)
    # the map bucket's features ran: the boxes cross the road edges' sides
    assert np.asarray(jsim.offroad_per_step).any()


def test_scores_match_jax(scored):
    """Each package scores its own features of the same rollout; then the
    port scores the JAX package's features."""
    wcfg = W.WosacConfig()
    log, sim = _port_features(scored)
    jlog, jsim, jld, jm = scored["jax"]
    got = W.compute_scenario_metrics(
        wcfg, W.make_log_distributions(wcfg, log), sim)
    jsim_t = F.MetricFeatures(*(torch.as_tensor(v) for v in jsim))
    flips = W.bin_flips(wcfg, sim, jsim_t)
    assert not any(u for _, u in flips.values()), flips
    assert sorted(got) == sorted(jm)
    n_flips = sum(n for n, _ in flips.values())
    for k in jm:
        err = np.abs(_np(got[k]) - np.asarray(jm[k])).max()
        assert err <= SCORE_TOL or n_flips, (k, err)
    same = W.compute_scenario_metrics(
        wcfg, W.LogDistributions(*(torch.as_tensor(v) for v in jld)), jsim_t)
    for k in jm:
        np.testing.assert_allclose(_np(same[k]), np.asarray(jm[k]),
                                   atol=SAME_TOL, rtol=0, err_msg=k)
    assert 0 < float(got["metametric"]) <= 1


def _tiny_yaml(tmp_path):
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(CFG))
    return str(path)


def test_cli_validate_writes_jax_schema(tmp_path, capsys):
    """`cli validate --synthetic --device cpu --num-scenarios 2` at the tiny
    config writes rollout_metrics.json with the JAX package's keys, prints
    its three summary lines, and dumps rollouts that score offline to the
    same metametric; a second run with --dump-rollouts skips them."""
    save = tmp_path / "val"
    argv = ["validate", "--config", _tiny_yaml(tmp_path), "--synthetic",
            "--device", "cpu", "--num-scenarios", "2",
            "--num-recurrent-steps", "30", "--save-dir", str(save),
            "--dump-rollouts"]
    cli.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-3].startswith("val metrics: ")
    assert lines[-2].startswith("wosac buckets: realism_meta_metric=")
    assert lines[-1].startswith("realism metametric over 2 scenarios")
    res = json.loads((save / "rollout_metrics.json").read_text())
    assert list(res) == ["wosac", "val_metrics", "scenarios"]
    rows = res["scenarios"]
    assert [r["scenario"] for r in rows] == [0, 1]
    jkeys = set(JW.aggregate_scenario_metrics(JW.WosacConfig(), rows))
    assert set(res["wosac"]) == jkeys
    assert set(res["val_metrics"]) == {
        "min_ade", "min_fde", "state_acc_valid", "state_acc_invalid",
        "grid_overlap", "num_insert_err"}
    # the dumps hold the JAX package's fields and score offline the same
    dumps = sorted(os.listdir(save))
    assert dumps[:2] == ["rollout_000000.npz", "rollout_000001.npz"]
    with np.load(save / dumps[0]) as d:
        assert set(d.files) == {
            "pred_traj", "pred_head", "pred_valid", "length", "width",
            "slot_active", "av_index", "token_pos", "token_state",
            "road_edges", "road_cyclic"}
    cfg = Config(**CFG)
    log_dir = str(tmp_path / "log")
    OFF.dump_log_features(SyntheticDataset(cfg, size=2), cfg, log_dir,
                          "cpu")
    OFF.aggregate_log_features(log_dir)
    off = OFF.compute_metrics_offline(
        str(save), os.path.join(log_dir, "total_features.npz"),
        device="cpu")
    for r, o in zip(rows, off):
        assert abs(r["metametric"] - o["metametric"]) < 1e-6
    capsys.readouterr()
    cli.main(argv)                     # resume: nothing left to roll out
    res = json.loads((save / "rollout_metrics.json").read_text())
    assert res["scenarios"] == []


def test_offline_npz_across_packages(scored, tmp_path):
    """A feature file written by either package loads in the other, field
    for field."""
    log, sim = _port_features(scored)
    port_path, jax_path = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    OFF._save_features(port_path, sim)
    JOFF._save_features(jax_path, scored["jax"][1])
    from_port = JOFF._load_features(port_path)
    from_jax = OFF._load_features(jax_path)
    assert from_port._fields == from_jax._fields == F.MetricFeatures._fields
    for name in F.MetricFeatures._fields:
        np.testing.assert_array_equal(np.asarray(getattr(from_port, name)),
                                      _np(getattr(sim, name)), err_msg=name)
        np.testing.assert_array_equal(
            _np(getattr(from_jax, name)),
            np.asarray(getattr(scored["jax"][1], name)), err_msg=name)


def test_several_rollouts_per_scenario(tmp_path):
    """n_rollout_close_val = 2: the scenario's two rollouts are lanes of
    one batched rollout; their features stack to [2A, ...], and the
    multi-rollout metrics join the validation set."""
    cfg = Config(**dict(CFG, num_recurrent_steps_val=30,
                        n_rollout_close_val=2))
    summary, scorer = cli.run_validate(cfg, "cpu", 1, str(tmp_path),
                                       keep=True, log_fn=lambda *_: None)
    kept = scorer.kept[0]
    A = cfg.max_agents
    f = kept["features"]
    assert f.valid.shape == (2 * A, 30) and f.num_placement.shape[0] == 2
    assert len(kept["outputs"]) == 2
    assert summary["n_rollouts"] == 2
    assert {"min_multi_ade", "min_multi_fde"} <= set(summary["val_metrics"])
    assert np.isfinite(summary["realism_meta_metric"])
    assert 0 < summary["realism_meta_metric"] <= 1


def test_rollout_mode_scores_with_save_dir(tmp_path, capsys):
    """`cli rollout --save-dir` keeps its summary line and adds the
    metametric to it, after writing rollout_metrics.json."""
    cli.main(["rollout", "--config", _tiny_yaml(tmp_path), "--synthetic",
              "--device", "cpu", "--num-recurrent-steps", "20",
              "--save-dir", str(tmp_path / "r")])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["token_steps"] == 4 and len(summary["ms_per_token_step"])
    assert 0 < summary["realism_meta_metric"] <= 1
    assert (tmp_path / "r" / "rollout_metrics.json").exists()
