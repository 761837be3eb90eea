"""Every experiment config of the repository in the port, on the CPU:

- each YAML under configs/ (recursively) builds the port's Trainer and
  takes one finite train step, with the shrink of
  tests/test_train.py::test_every_config_inits_and_trains_one_step (the
  flags under test come from the YAML unchanged), torch only;
- the deterministic training loss and every log against the JAX package's
  Trainer.loss_fn for LOSS_CONFIGS (the SMART baseline, map pre-training,
  the standard config and two token ablations), on the same converted
  weights, scenario and draws (the map uniforms from the JAX input key,
  the pseudo-seed uniforms from its forward key): 1e-5 relative (fp32,
  summation order);
- one forced-insertion beam-1 rollout with use_state_token,
  use_grid_token and use_head_token all false against the JAX package's
  (PARITY.md's protocol: token ids, state ids, slot activity and
  insertion counts bitwise, poses within 1e-3).

The JAX side (five jitted loss functions and a jitted rollout,
tests/jax_reference.py) runs in three spawned processes started by this
module's autouse fixture, while the torch-only cases run here; each JAX
trace holds its process's interpreter lock, which would stall the tests
beside it in this one.
"""

import glob
import os

import numpy as np
import pytest
import torch

import jax_reference as J
from infgen_torch import cli
from infgen_torch.config import Config, load_config
from infgen_torch.data.features import build_model_inputs
from infgen_torch.data.scenario import stack_scenarios, to_device
from infgen_torch.data.synthetic import make_synthetic_scenario
from infgen_torch.rollout.closed_loop import make_rollout_fn
from infgen_torch.train.train_step import Trainer

from test_torch_layers import one_torch_thread  # noqa: F401 (autouse)
from test_torch_rollout import CFG as ROLLOUT_CFG
from test_torch_rollout import CLOSE, EXACT, POSE_TOL
from test_torch_serving import _decoder_tree

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")
CONFIG_FILES = sorted(glob.glob(CONFIG_DIR + "/**/*.yaml", recursive=True))
# tests/test_train.py's shrink
SHRINK = dict(max_agents=16, max_map_tokens=128, num_agent_layers=1,
              num_seed_layers=1, num_map_layers=1, hidden_dim=32,
              num_heads=2, head_dim=16, num_freq_bands=8,
              num_seed_feature=4)
LOSS_CONFIGS = ("smart.yaml", "pretrain_scalable_map.yaml",
                "ours_standard.yaml",
                "experiments/ablate_state_and_grid_tokens.yaml",
                "experiments/ablate_head_tokens.yaml")
LOSS_SEED, LOSS_AGENTS, LOSS_KEY = 3, 10, 5
LOG_RTOL = 1e-5
TOKEN_FLAGS_OFF = dict(use_state_token=False, use_grid_token=False,
                       use_head_token=False)
ROLL = {**ROLLOUT_CFG, "num_agent_layers": 1, "num_seed_layers": 1,
        **TOKEN_FLAGS_OFF}
ROLL_SEED, ROLL_AGENTS = 2, 10
# the JAX losses' tasks, submitted after the rollout, heaviest first (the
# last goes to the first of the three processes free): about even work per
# process
LOSS_PARTS = (("experiments/ablate_state_and_grid_tokens.yaml",
               "experiments/ablate_head_tokens.yaml"),
              ("smart.yaml", "ours_standard.yaml"),
              ("pretrain_scalable_map.yaml",))


def _config_id(path):
    return os.path.relpath(path, CONFIG_DIR)


def _shrunk(path):
    return load_config(path).replace(**SHRINK)


@pytest.fixture(scope="module", autouse=True)
def jax_side():
    """Random weights for the port's models of LOSS_CONFIGS and of ROLL
    (as flax trees, convert.py's names read backwards), and the JAX side
    of each comparison on them, started in a spawn pool of three
    processes at the module's first test (LOSS_PARTS).
    The comparisons collect the results; the pool ends with the module."""
    trainers = {name: Trainer(_shrunk(os.path.join(CONFIG_DIR, name)),
                              "cpu") for name in LOSS_CONFIGS}
    cfg = Config(**ROLL)
    tok = cli.build_tokenizers(cfg)
    model = cli.build_model(cfg, tok[0], "cpu")
    params = _decoder_tree(model, np.random.default_rng(9))
    trees = {name: _decoder_tree(trainers[name].model,
                                 np.random.default_rng(i))
             for i, name in enumerate(LOSS_CONFIGS)}
    specs = {name: (name, os.path.join(CONFIG_DIR, name), SHRINK,
                    trees[name], LOSS_SEED, LOSS_AGENTS, LOSS_KEY)
             for name in LOSS_CONFIGS}
    pool = J.spawn_pool(3)
    try:
        rollout = pool.apply_async(J.forced_rollout,
                                   (ROLL, params, ROLL_SEED, ROLL_AGENTS))
        losses = {}
        for part in LOSS_PARTS:
            pending = pool.apply_async(J.config_losses,
                                       ([specs[n] for n in part],))
            losses.update({n: pending for n in part})
        yield dict(trainers=trainers, losses=losses,
                   rollout=(cfg, tok, model.eval(), rollout))
    finally:
        pool.terminate()
        pool.join()


@pytest.mark.parametrize("path", CONFIG_FILES, ids=_config_id)
def test_every_config_trains_one_step(path):
    """Mirror of tests/test_train.py::test_every_config_inits_and_trains_
    one_step on the port: init from the config's seed and one finite step
    on one synthetic scenario."""
    cfg = _shrunk(path)
    trainer = Trainer(cfg, "cpu")
    trainer.init_state()
    batch = to_device(stack_scenarios([make_synthetic_scenario(
        cfg, seed=0, num_agents=10)]), "cpu")
    logs = trainer.train_step(batch, torch.Generator().manual_seed(1))
    assert all(np.isfinite(float(v)) for v in logs.values()), (path, logs)
    assert trainer.step == 1


def test_config_files_cover_the_experiment_matrix():
    """The matrix the JAX package trains: 9 configs and 4 ablations,
    the occupancy decoder and the SMART baseline among them."""
    ids = [_config_id(p) for p in CONFIG_FILES]
    assert len(ids) == 13
    assert set(LOSS_CONFIGS) < set(ids)
    assert load_config(os.path.join(CONFIG_DIR, "ours_standard_decode_occ"
                                    ".yaml")).decoder_type == "occ_decoder"


@pytest.mark.parametrize("name", LOSS_CONFIGS)
def test_config_loss_matches_jax(jax_side, name):
    """The deterministic training loss and every log of the config against
    the JAX package's loss_fn on the same weights, scenario and draws."""
    jloss, jlogs, pt_uniform, sa_uniform = jax_side["losses"][name].get()[
        name]
    trainer = jax_side["trainers"][name]
    trainer.model.eval()
    scen = to_device(make_synthetic_scenario(
        trainer.cfg, seed=LOSS_SEED, num_agents=LOSS_AGENTS), "cpu")
    with torch.no_grad():
        loss, logs = trainer.loss_fn(scen, None, dict(
            pt_uniform=torch.as_tensor(pt_uniform),
            sa_uniform=torch.as_tensor(sa_uniform)))
    assert set(logs) == set(jlogs)
    np.testing.assert_allclose(float(loss), jloss, rtol=LOG_RTOL)
    for k, v in jlogs.items():
        np.testing.assert_allclose(float(logs[k]), float(v), rtol=LOG_RTOL,
                                   atol=1e-12, err_msg=k)


def test_token_flags_off_rollout_matches_jax(jax_side):
    """A forced-insertion beam-1 rollout with the state, grid and head
    tokens all off (the ablations' and SMART's flags, with insertion on)
    against the JAX package's on the same weights and map uniforms."""
    cfg, (attr, mt, mv), model, pending = jax_side["rollout"]
    uniforms, jout = pending.get()
    scen = to_device(make_synthetic_scenario(cfg, seed=ROLL_SEED,
                                             num_agents=ROLL_AGENTS), "cpu")
    inputs = build_model_inputs(cfg, mt, attr, scen,
                                pt_uniform=torch.as_tensor(uniforms))
    fn = make_rollout_fn(model, cfg, attr, mt, mv, force_insert=True)
    out = {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
           for k, v in fn(scen, inputs, torch.Generator().manual_seed(7)
                          ).items()}
    assert set(out) == set(jout)
    for k in EXACT:
        np.testing.assert_array_equal(out[k], np.asarray(jout[k]), err_msg=k)
    for k in CLOSE:
        np.testing.assert_allclose(out[k], np.asarray(jout[k]),
                                   atol=POSE_TOL, rtol=0, err_msg=k)
    assert int(out["n_inserted"]) > 0
