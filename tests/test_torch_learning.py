"""Learning dynamics of the port (`infgen_torch/validate_learning.py`) on
the CPU at a tiny size: D = 32, one layer of each kind, 12 agent slots, 128
map tokens, 10 agents per scenario, fp32, beams 1 (the rollout is then
deterministic, PARITY.md), 30 frames per scoring, dropout 0.

Against the JAX package: scripts/validate_learning.py's steps, reproduced
in tests/jax_reference.py (`learning_scores`, `learning_losses`) and run in
two spawned processes of the module's fixture while the port-only cases
run, on the same weights (a flax tree, converted by convert.py for the
port) and 2 scenarios:
  - the GT-replay ceiling (each scenario's logs scored against its own
    histograms): mean metametric and collision rate within SCORE_TOL
    (test_torch_scoring.py's: each package on its own features);
  - the untrained score (the scenarios as lanes of one batched rollout):
    within UNTRAINED_TOL (below);
  - the first two losses of training (the batch of scenarios 0 and 1, the
    JAX key [1, step]'s draws handed to the port): within LOG_RTOL
    relative (test_torch_train.py's), the second after one AdamW update
    on each side's own gradients.
Port only: the loss falls over 10 steps on one repeated batch; the JSON
carries the JAX file's keys and is rewritten after each curve point; the
trained checkpoint scores as the run's last scoring did; the JAX
package's record is never written.
"""

import json
import multiprocessing
import os

import numpy as np
import pytest
import torch

import jax_reference as J
from infgen_torch import cli
from infgen_torch.config import Config
from infgen_torch.convert import load_flax_params
from infgen_torch.validate_learning import learning_dynamics

from test_torch_layers import one_torch_thread  # noqa: F401 (autouse)
from test_torch_scoring import SCORE_TOL
from test_torch_serving import _decoder_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(max_agents=12, max_map_tokens=128, num_agent_layers=1,
           num_seed_layers=1, num_map_layers=1, hidden_dim=32, num_heads=2,
           head_dim=16, num_freq_bands=8, dropout=0.0,
           remat_attention=False, use_seed_kernel=True,
           compute_dtype="float32", motion_beam_size=1, insert_beam_size=1,
           num_recurrent_steps_val=30)
N_SCEN, AGENTS, STEPS = 2, 10, 2
LOG_RTOL = 1e-5
# the untrained rollouts agree to fp32 reduction order (poses within
# PARITY.md's 1e-3, decisions equal at beam 1); their features then differ
# in the last bits and may land one histogram bin apart
UNTRAINED_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def jax_side():
    """The weights (a flax tree, and the port's state dict converted from
    it) and the JAX side's scores and losses in a spawn pool of two."""
    cfg = Config(**CFG)
    attr = cli.build_tokenizers(cfg)[0]
    tree = _decoder_tree(cli.build_model(cfg, attr, "cpu"),
                         np.random.default_rng(0))
    model = cli.build_model(cfg, attr, "cpu")
    load_flax_params(model, tree)
    # XLA's default optimisation level: at level 0 (J.spawn_pool) the JAX
    # train step's loss read 2.6e-5 relative apart from the default's, and
    # compiled no faster here
    pool = multiprocessing.get_context("spawn").Pool(2)
    try:
        yield dict(
            weights=model.state_dict(),
            scores=pool.apply_async(J.learning_scores, (
                CFG, tree, N_SCEN, AGENTS, STEPS)),
            losses=pool.apply_async(J.learning_losses, (
                CFG, tree, N_SCEN, AGENTS, STEPS, STEPS)))
    finally:
        pool.terminate()
        pool.join()


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """learning_dynamics from the config's seed: 10 steps on the one batch
    of 2 scenarios, scored every 4 steps; the curve points the file held
    as each scoring was logged."""
    out = str(tmp_path_factory.mktemp("learning") / "ld.json")
    seen = []

    def log_fn(msg):
        if "metametric=" in msg:
            seen.append((msg.split(":")[0], len(json.load(open(out))["curve"])
                         if os.path.exists(out) else 0))

    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    res = learning_dynamics(Config(**CFG), "cpu", steps=10,
                            scenarios=N_SCEN, val_every=4, out=out,
                            log_fn=log_fn, agents=AGENTS, ckpt_dir=ckpt)
    return res, json.load(open(out)), seen, ckpt


def test_loss_falls_on_one_batch(port_run):
    res, _, _, _ = port_run
    losses = res["losses"]
    assert len(losses) == 10 and np.isfinite(losses).all(), losses
    assert losses[-1] < losses[0], losses
    assert [r["step"] for r in res["curve"]] == [0, 4, 8, 10]
    assert all(np.isfinite(r["metametric"]) for r in res["curve"])


def test_json_keys_and_rewrites(port_run):
    """The written file holds the JAX file's keys (and the port's
    additions), equal to the returned result; before each scoring was
    logged it held every earlier curve point."""
    res, written, seen, _ = port_run
    with open(os.path.join(ROOT, "LEARNING_DYNAMICS.json")) as f:
        jax_keys = set(json.load(f))
    assert jax_keys <= set(written)
    assert {"device", "losses", "ms_per_train_step", "ms_scoring",
            "seed_eval_launches", "seconds"} <= set(written)
    assert written["curve"] == res["curve"] and written["device"] == "cpu"
    assert written["after"] == {k: v for k, v in res["curve"][-1].items()
                                if k not in ("step", "loss")}
    assert 0 <= written["after"]["valid_share"] <= 1
    assert len(written["ms_scoring"]) == 4
    assert seen == [("gt_replay ceiling", 0), ("untrained", 0), ("val@4", 1),
                    ("val@8", 2), ("trained(10)", 3)]


def test_trained_checkpoint_loads(port_run):
    """--ckpt-dir's checkpoint is the trained state: a model from it rolls
    out as the run's last scoring did (same metametric)."""
    res, _, _, ckpt = port_run
    cfg = Config(**CFG)
    tok = cli.build_tokenizers(cfg)
    model = cli.build_model(cfg, tok[0], "cpu", ckpt_path=ckpt)
    assert cli.load_checkpoint_weights(model, ckpt) == 10
    res2 = learning_dynamics(cfg, "cpu", steps=0, scenarios=N_SCEN, out=None,
                             log_fn=lambda msg: None, agents=AGENTS,
                             weights=model.state_dict())
    assert res2["before"] == res["after"]


def test_jax_record_is_never_written(tmp_path):
    with pytest.raises(ValueError, match="LEARNING_DYNAMICS.json"):
        learning_dynamics(Config(**CFG), "cpu", steps=1, scenarios=2,
                          out=str(tmp_path / "LEARNING_DYNAMICS.json"))
    assert not os.path.exists(tmp_path / "LEARNING_DYNAMICS.json")


def test_matches_jax(jax_side):
    """The GT-replay ceiling, the untrained score and the first two losses
    against the JAX script's steps on the same weights and draws."""
    jl, jdraws = jax_side["losses"].get(timeout=600)
    draws = lambda step: [{k: torch.as_tensor(v) for k, v in d.items()}
                          for d in jdraws[step]]
    res = learning_dynamics(Config(**CFG), "cpu", steps=STEPS,
                            scenarios=N_SCEN, out=None,
                            log_fn=lambda msg: None, agents=AGENTS,
                            weights=jax_side["weights"], draws=draws)
    js = jax_side["scores"].get(timeout=600)
    gt, before = js["gt_replay"], js["before"]
    np.testing.assert_allclose(res["gt_replay_metametric"],
                               np.mean(gt["metametric"]), atol=SCORE_TOL)
    np.testing.assert_allclose(res["gt_replay_collision_rate"],
                               np.mean(gt["collision_rate"]), atol=SCORE_TOL)
    np.testing.assert_allclose(res["before"]["metametric"],
                               np.mean(before["metametric"]),
                               atol=UNTRAINED_TOL)
    np.testing.assert_allclose(res["before"]["collision_rate"],
                               np.mean(before["collision_rate"]),
                               atol=UNTRAINED_TOL)
    np.testing.assert_allclose(res["losses"], jl, rtol=LOG_RTOL)
