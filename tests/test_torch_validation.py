"""Open-loop validation, input checks, checkpoints, warm starts, the loader,
bf16-stored parameters and the new command-line modes of the port, on the
CPU at a tiny size (D = 32, one layer of each kind, 12 agent slots, 128
map tokens).

Against the JAX package (its side in two spawned processes started by the
module's autouse fixture, while the port-only cases run here):
  - `validate_open_loop` on two synthetic scenarios with the same weights
    and the JAX function's draws (its key cfg.seed + 99, split once per
    scenario; the loss from the split rng_in / rng_fwd, the accuracies
    from inputs built anew from the unsplit key): every mean log within
    1e-5 relative (fp32), token and state accuracy exactly equal;
  - `check_inputs` on the same scenarios: every count equal;
  - param_dtype bfloat16 (fp32 compute; the weights, their gradients and
    the optimizer's moments stored in bf16): one training step of the
    occupancy config (the JAX key's draws) at a learning rate that moves
    a weight by many bf16 steps (BF16_STEP_CFG; clipping off, since the
    port's global norm sums in fp32 where optax sums bf16 squares in
    bf16: ROADMAP Queue 3): the loss and every log within 1e-5 relative,
    grad_norm within 1e-5 of the fp32 norm of JAX's gradients, every
    gradient within one bf16 step of JAX's (a value at the fp32 noise
    floor excepted), and the port's optimizer fed JAX's gradients: mu, nu
    and the updated weights within one bf16 step of optax's; the agent
    decoder's deterministic loss and every log within 1e-5 relative. The
    JAX side's bf16 programs are jitted with XLA's excess precision off
    (tests/jax_reference.py, EXACT_BF16), so that they round where the
    JAX package's code says.
Port only, mirrors of the JAX package's tests of the same names
(tests/test_checkpoint.py, tests/test_data.py), the best-k checkpoints,
the bf16 kernel branch and the command line with --device cpu.
"""

import json
import logging

import numpy as np
import pytest
import torch

import jax_reference as J
from infgen_torch import cli
from infgen_torch.config import Config
from infgen_torch.convert import flatten_tree, load_flax_params
from infgen_torch.data.loader import BatchLoader
from infgen_torch.data.scenario import lane_of, stack_scenarios, to_device
from infgen_torch.data.synthetic import make_synthetic_scenario
from infgen_torch.ops import pallas_attention as PA
from infgen_torch.train.checkpoint import CheckpointManager, load_weights
from infgen_torch.train.loop import (SyntheticDataset, check_inputs, train,
                                     validate_open_loop)
from infgen_torch.train.train_step import Trainer
from infgen_torch.utils.logging import get_logger

from test_torch_layers import one_torch_thread  # noqa: F401 (autouse)
from test_torch_serving import _decoder_tree
from test_torch_train import _torch_leaf

CFG = dict(max_agents=12, max_map_tokens=128, num_agent_layers=1,
           num_seed_layers=1, num_map_layers=1, hidden_dim=32, num_heads=2,
           head_dim=16, num_freq_bands=8, dropout=0.0,
           remat_attention=False)
OCC_CFG = dict(decoder_type="occ_decoder", predict_occ=True, max_agents=16,
               max_map_tokens=128, hidden_dim=32, num_heads=2, head_dim=16,
               num_freq_bands=8, grid_interval=10.0)
N_VAL = 2
BF16_SEED, BF16_AGENTS, BF16_KEY = 2, 15, 6
# the bf16 step: a learning rate of many bf16 steps of a weight (about 20
# at |w| = 0.1), no warm-up, clipping off
BF16_STEP_CFG = dict(OCC_CFG, param_dtype="bfloat16", lr=0.02,
                     warmup_steps=0, grad_clip_norm=1e9)
LOG_RTOL = 1e-5
# a gradient below this fraction of its leaf's largest is at the fp32
# noise floor of the two backward passes (or past a ReLU kink one side
# did not take): its bf16 value may differ by more than a step
GRAD_FLOOR = 1e-5


@pytest.fixture(scope="module", autouse=True)
def jax_side():
    """Port trainers with random weights (validation; the bf16 agent loss;
    the bf16 occupancy step) and the JAX side of each comparison on the
    same weights, in a spawn pool of two processes."""
    val_trainer = Trainer(Config(**CFG), "cpu")
    val_tree = _decoder_tree(val_trainer.model, np.random.default_rng(0))
    trees = dict(
        occ=_decoder_tree(Trainer(Config(**OCC_CFG), "cpu").model,
                          np.random.default_rng(2)),
        agent=_decoder_tree(Trainer(Config(**CFG), "cpu").model,
                            np.random.default_rng(1)))
    pool = J.spawn_pool(2)
    try:
        yield dict(val_trainer=val_trainer, trees=trees,
                   val=pool.apply_async(J.open_loop, (CFG, val_tree, N_VAL)),
                   bf16=pool.apply_async(J.bf16_sides, (
                       (BF16_STEP_CFG, trees["occ"], BF16_SEED, BF16_AGENTS,
                        BF16_KEY),
                       (dict(CFG, param_dtype="bfloat16"), trees["agent"],
                        BF16_SEED, BF16_AGENTS, BF16_KEY))))
    finally:
        pool.terminate()
        pool.join()


def _t(draws):
    return {k: torch.as_tensor(v) for k, v in draws.items()}


# --------------------------------------------------------------------- #
# checkpoints, warm starts, the loader (port only)
# --------------------------------------------------------------------- #

class _Three(torch.nn.Module):
    def __init__(self, b: int):
        super().__init__()
        self.a = torch.nn.Parameter(torch.zeros(2, 2))
        self.b = torch.nn.Parameter(torch.zeros(b))
        self.c = torch.nn.Parameter(torch.zeros(4))


def test_load_weights_nonstrict():
    """Mirror of tests/test_checkpoint.py::test_load_weights_nonstrict: a
    matching entry loads, a mismatched or missing one keeps the module's
    own tensor, and the kept keys are named."""
    module = _Three(3)
    lines = []
    kept = load_weights(module, {"a": torch.ones(2, 2), "b": torch.ones(5)},
                        lines.append)
    with torch.no_grad():
        assert float(module.a.sum()) == 4
        assert float(module.b.sum()) == 0 and float(module.c.sum()) == 0
    assert kept == ["b", "c"] and "kept 2" in lines[0]


def _loop_cfg(**over):
    """tests/test_checkpoint.py::test_resume_tree_mismatch_warm_start's
    config, with `over`."""
    return Config(**{**dict(
        max_agents=16, max_map_tokens=32, hidden_dim=16, num_heads=2,
        head_dim=8, num_freq_bands=4, num_agent_layers=1, num_seed_layers=1,
        num_map_layers=1, num_token_steps=6, num_historical_steps=11,
        num_future_steps=20, train_batch_size=1, predict_occ=False,
        dropout=0.0, use_grid_index_head=False), **over})


def test_resume_tree_mismatch_warm_start(tmp_path):
    """Mirror of tests/test_checkpoint.py::test_resume_tree_mismatch_warm_
    start: resuming over a checkpoint whose entries no longer match the
    model (a head added since) falls back to a weights-only warm start,
    the optimizer and the step reset, instead of raising."""
    cfg = _loop_cfg()
    ds = SyntheticDataset(cfg, size=2)
    logs = []
    train(cfg, ds, str(tmp_path), max_steps=1, device="cpu",
          log_fn=logs.append)
    saved = CheckpointManager(str(tmp_path / "ckpt")).restore_raw()
    cfg2 = cfg.replace(use_grid_index_head=True)
    _, hist = train(cfg2, ds, str(tmp_path), max_steps=1, device="cpu",
                    log_fn=logs.append)
    assert any("warm-started weights only" in m for m in logs), logs
    assert [h["step"] for h in hist] == [1]
    # what the fallback kept: the new head's entries
    warm = Trainer(cfg2, "cpu")
    kept = load_weights(warm.model, saved["model"], lambda m: None)
    assert kept and all("grid_index" in k for k in kept)


def test_batch_loader_workers_and_backpressure():
    """Mirror of tests/test_data.py::test_batch_loader_workers_and_
    backpressure: two spawn workers yield every scenario exactly once per
    epoch, and in the inline loader's order for the same seed."""
    cfg = Config(max_agents=16, max_map_tokens=64)
    ds = SyntheticDataset(cfg, size=6)
    loader = BatchLoader(ds, batch_size=2, num_workers=2, prefetch_batches=2)
    try:
        seen = []
        for batch in loader.epoch(shuffle=True, seed=0):
            assert len(batch) == 2
            seen.extend(int(s.scenario_id) for s in batch)
        assert sorted(seen) == list(range(6))
        seen0 = [int(s.scenario_id) for b in BatchLoader(
            ds, batch_size=2).epoch(shuffle=True, seed=0) for s in b]
        assert seen0 == seen
    finally:
        loader.close()


def test_warm_start_restore_raw(tmp_path):
    """Mirror of tests/test_data.py::test_warm_start_restore_raw:
    restore_raw + load_weights warm-start a trainer whose optimizer state
    has another structure (gradient accumulation) with the saved
    weights."""
    cfg = Config(**CFG)
    trainer = Trainer(cfg, "cpu")
    trainer.init_state(torch.Generator().manual_seed(0))
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    ckpt.save(1, trainer)
    trainer2 = Trainer(cfg.replace(accumulate_grad_batches=2), "cpu")
    trainer2.init_state(torch.Generator().manual_seed(1))
    raw = CheckpointManager(str(tmp_path / "ckpt")).restore_raw()
    assert raw["step"] == 1 and raw["optimizer"]["acc"] is None
    assert load_weights(trainer2.model, raw["model"]) == []
    for a, b in zip(trainer.model.parameters(), trainer2.model.parameters()):
        assert torch.equal(a, b)


def test_best_k_keeps_the_lowest_val_loss(tmp_path):
    """best_fn / best_mode "min": of 8 saves the 5 with the lowest
    val_loss stay, whatever their order, each with its metrics."""
    trainer = Trainer(_loop_cfg(), "cpu")
    ckpt = CheckpointManager(str(tmp_path), max_to_keep=5,
                             best_fn=lambda m: m["val_loss"], best_mode="min")
    losses = [0.9, 0.4, 0.7, 0.2, 0.8, 0.5, 0.1, 0.6]
    for step, v in enumerate(losses, 1):
        ckpt.save(step, trainer, metrics={"val_loss": v})
    want = sorted(range(1, 9), key=lambda s: losses[s - 1])[:5]
    assert ckpt.all_steps() == sorted(want)
    assert set(ckpt.metrics()) == set(want)
    assert CheckpointManager(str(tmp_path)).restore_raw(7)["metrics"] == {
        "val_loss": 0.1}


def test_train_validates_and_keeps_best(tmp_path):
    """train() with a validation set: a `val/*` record after each epoch in
    metrics.jsonl (none after the step that reaches max_steps), the best
    checkpoint in ckpt_best, the source tree in backup_source, the run's
    log in train.log, whose handler the run closes at its end (a later
    run in the same process writes to its own file only)."""
    cfg = _loop_cfg(train_batch_size=2, val_num_scenarios=1)
    data = SyntheticDataset(cfg, size=2)
    train(cfg, data, str(tmp_path), max_steps=3, device="cpu",
          log_fn=lambda m: None, val_dataset=SyntheticDataset(cfg, size=1))
    recs = [json.loads(x) for x in open(tmp_path / "metrics.jsonl")]
    vals = [r for r in recs if "val/loss" in r]
    assert [r["step"] for r in recs if "loss" in r] == [1, 2, 3]
    assert [r["step"] for r in vals] == [1, 2]
    assert {"val/token_accuracy", "val/state_accuracy"} <= set(vals[0])
    assert CheckpointManager(str(tmp_path / "ckpt_best")).all_steps() == \
        [1, 2]
    assert (tmp_path / "backup_source" / "infgen_torch" / "cli.py").exists()
    assert "phase timings" in (tmp_path / "train.log").read_text()
    assert not [h for h in get_logger().handlers
                if isinstance(h, logging.FileHandler)]


# --------------------------------------------------------------------- #
# the command line
# --------------------------------------------------------------------- #

@pytest.fixture
def tiny_yaml(tmp_path):
    path = tmp_path / "tiny.yaml"
    path.write_text("\n".join(f"{k}: {v}" for k, v in dict(
        CFG, train_batch_size=1, val_num_scenarios=1,
        num_recurrent_steps_val=20).items()))
    return str(path)


def test_cli_check_inputs_and_open_loop(tiny_yaml, capsys):
    cli.main(["check-inputs", "--synthetic", "--config", tiny_yaml,
              "--device", "cpu", "--num-scenarios", "2"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["scenarios"] == 2
    assert summary["state_accuracy"]["valid_count"] > 0
    cli.main(["validate", "--open-loop", "--synthetic", "--config",
              tiny_yaml, "--device", "cpu", "--num-scenarios", "2",
              "--pallas-attention"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("open-loop val: ")
    summary = json.loads(out[-1])
    assert summary["scenarios"] == 2
    assert 0.0 <= summary["open_loop"]["state_accuracy"] <= 1.0
    # CPU: the plain twin, no launch
    assert summary["kernel_launches"]["r_biased_attention"] == 0


def test_cli_train_overfit_then_rollout_from_its_checkpoint(tiny_yaml,
                                                            tmp_path,
                                                            capsys):
    """`train --overfit --steps 2` saves a checkpoint; `rollout
    --ckpt-path` rolls out from its weights, equal to the trainer's;
    `--params` with `--ckpt-path` is refused."""
    run = str(tmp_path / "run")
    cli.main(["train", "--synthetic", "--config", tiny_yaml, "--device",
              "cpu", "--steps", "2", "--overfit", "--save-dir", run])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["overfit"] and summary["steps"] == 2
    ckpt = f"{run}/ckpt"
    cli.main(["rollout", "--synthetic", "--config", tiny_yaml, "--device",
              "cpu", "--ckpt-path", ckpt])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["scenarios"] == 1 and summary["token_steps"] == 4
    cfg = cli.load_config(tiny_yaml)
    model = cli.build_model(cfg, cli.build_tokenizers(cfg)[0], "cpu",
                            ckpt_path=ckpt)
    saved = CheckpointManager(ckpt).restore_raw()
    for k, v in model.state_dict().items():
        assert torch.equal(v, saved["model"][k]), k
    with pytest.raises(SystemExit):
        cli.main(["rollout", "--synthetic", "--config", tiny_yaml,
                  "--device", "cpu", "--ckpt-path", ckpt, "--params",
                  "x.npz"])
    capsys.readouterr()
    # a warm start of another width keeps what does not fit
    wide = tmp_path / "wide.yaml"
    wide.write_text(open(tiny_yaml).read().replace("hidden_dim: 32",
                                                   "hidden_dim: 64"))
    cli.main(["train", "--synthetic", "--config", str(wide), "--device",
              "cpu", "--steps", "1", "--pretrain-ckpt", ckpt])
    out = capsys.readouterr().out.strip().splitlines()
    warm = [json.loads(x) for x in out if x.startswith('{"warm_started"')]
    assert warm and warm[0]["kept"] > 0


# --------------------------------------------------------------------- #
# against the JAX package (last in the file: the port-only cases above run
# while its processes trace and compile)
# --------------------------------------------------------------------- #

def test_validate_open_loop_matches_jax(jax_side):
    jval, _, _, jdraws = jax_side["val"].get()
    trainer = jax_side["val_trainer"]
    draws = [{k: _t(d) for k, d in per.items()} for per in jdraws]
    lines = []
    out = validate_open_loop(trainer, SyntheticDataset(trainer.cfg, N_VAL),
                             N_VAL, lines.append, draws)
    assert set(out) == set(jval)
    for k, v in jval.items():
        if k.endswith("_accuracy"):
            assert out[k] == v, (k, out[k], v)
        else:
            np.testing.assert_allclose(out[k], v, rtol=LOG_RTOL, atol=1e-12,
                                       err_msg=k)
    assert lines and lines[0].startswith("open-loop val: ")
    assert trainer.model.training        # the mode it had


def test_check_inputs_matches_jax(jax_side):
    _, jtotals, joverlap, _ = jax_side["val"].get()
    cfg = Config(**CFG)
    totals, overlap = check_inputs(cfg, SyntheticDataset(cfg, N_VAL), N_VAL,
                                   lambda m: None, "cpu")
    assert totals == {k: int(v) for k, v in jtotals.items()}
    assert set(overlap) == set(joverlap)
    for k, v in joverlap.items():
        np.testing.assert_array_equal(overlap[k], v, err_msg=k)
    assert totals["valid_count"] > 0 and overlap["num_insert_agent_t"].sum()


def _bf16_trainer(cfg, tree):
    trainer = Trainer(Config(**{**cfg, "param_dtype": "bfloat16"}), "cpu")
    load_flax_params(trainer.model, tree)      # rounded to bf16 on copy
    assert {p.dtype for p in trainer.model.parameters()} == {torch.bfloat16}
    assert {m.dtype for m in trainer.optimizer.mu} == {torch.bfloat16}
    return trainer


def _bf16_batch(cfg):
    return to_device(stack_scenarios([make_synthetic_scenario(
        cfg, seed=BF16_SEED, num_agents=BF16_AGENTS)]), "cpu")


def _bf16_step(a, b):
    """One bf16 step (unit in the last place) at the larger magnitude of
    `a` and `b`, elementwise."""
    m = np.maximum(np.abs(a), np.abs(b))
    return np.where(m > 0, 2.0 ** (np.floor(np.log2(np.where(m > 0, m, 1)))
                                   - 7), 0.0)


def _beyond_one_step(got, want, exempt=None):
    """{name: elements} of `got` ({torch name: tensor}) more than one bf16
    step from `want` (a flax tree), outside `exempt` ({name: bool mask})."""
    bad = {}
    for name, w in (_torch_leaf(p, v) for p, v in
                    flatten_tree(want).items()):
        a, w = got[name].detach().float().numpy(), w.numpy()
        over = np.abs(a - w) > _bf16_step(a, w)
        if exempt is not None:
            over &= ~exempt[name]
        if over.any():
            bad[name] = int(over.sum())
    return bad


def test_bf16_param_step_matches_jax(jax_side):
    """param_dtype bfloat16: the Trainer stores its weights, gradients and
    moments in bf16 and computes in fp32, as the JAX package's promotion
    does. One step of the occupancy config (BF16_STEP_CFG) against the JAX
    Trainer's: logs, grad_norm, gradients; then the port's optimizer on
    the JAX package's gradients against optax's moments and updated
    weights, each within one bf16 step. The update is many bf16 steps of
    most weights: a step that left them, or moved them the wrong way,
    would fail."""
    j = jax_side["bf16"].get()[0]
    assert j["dtypes"] == {"bfloat16"}
    trainer = _bf16_trainer(BF16_STEP_CFG, jax_side["trees"]["occ"])
    logs = trainer.train_step(_bf16_batch(trainer.cfg), draws=[_t(j["draws"])])
    assert set(logs) == set(j["logs"])
    for k, v in j["logs"].items():
        want = j["grad_norm_f32"] if k == "grad_norm" else v
        np.testing.assert_allclose(float(logs[k]), want, rtol=LOG_RTOL,
                                   atol=1e-12, err_msg=k)
    grads = {n: p.grad for n, p in trainer.model.named_parameters()}
    assert {g.dtype for g in grads.values()} == {torch.bfloat16}
    floor = {}
    for name, g in (_torch_leaf(p, v) for p, v in
                    flatten_tree(j["grads"]).items()):
        mag = np.minimum(np.abs(g.numpy()), np.abs(grads[name].float().numpy()))
        floor[name] = mag < GRAD_FLOOR * np.abs(g.numpy()).max()
    assert not _beyond_one_step(grads, j["grads"], floor)

    fed = _bf16_trainer(BF16_STEP_CFG, jax_side["trees"]["occ"])
    opt = fed.optimizer
    jgrads = dict(_torch_leaf(p, g) for p, g in
                  flatten_tree(j["grads"]).items())
    assert opt.step([jgrads[n].to(torch.bfloat16) for n in opt.names])
    named = lambda ts: dict(zip(opt.names, ts))
    assert not _beyond_one_step(named(opt.mu), j["mu"])
    assert not _beyond_one_step(named(opt.nu), j["nu"])
    assert not _beyond_one_step(named(opt.params), j["after"])
    moved = np.mean(np.concatenate([
        (a != b).ravel() for a, b in zip(
            flatten_tree(j["after"]).values(),
            flatten_tree(j["before"]).values())]))
    assert moved > 0.5, moved


def test_bf16_param_loss_matches_jax(jax_side):
    """The agent decoder's deterministic loss with bf16-stored weights
    (fp32 compute, JAX's promotion of a bf16 weight against fp32 inputs;
    the seeds' shape embedding in bf16, as the JAX package's weakly typed
    constant takes the weights' dtype) against the JAX package's."""
    jloss, jlogs, jdraws = jax_side["bf16"].get()[1]
    trainer = _bf16_trainer(CFG, jax_side["trees"]["agent"])
    trainer.model.eval()
    with torch.no_grad():
        loss, logs = trainer.loss_fn(lane_of(_bf16_batch(trainer.cfg), 0),
                                     None, _t(jdraws))
    assert set(logs) == set(jlogs)
    np.testing.assert_allclose(float(loss), jloss, rtol=LOG_RTOL)
    for k, v in jlogs.items():
        np.testing.assert_allclose(float(logs[k]), v, rtol=LOG_RTOL,
                                   atol=1e-12, err_msg=k)


def test_bf16_params_take_the_kernel_branch():
    """Under use_pallas_attention, bf16-stored w_kr / w_vr reach
    r_biased_attention_trainable cast up to fp32 (its wrapper checks for
    fp32) and every eligible sublayer takes that branch: one recompute
    backward per eligible call, as with fp32 weights."""
    cfg = Config(**CFG, param_dtype="bfloat16", use_pallas_attention=True)
    trainer = Trainer(cfg, "cpu")
    trainer.init_state(torch.Generator().manual_seed(0))
    batch = to_device(stack_scenarios([make_synthetic_scenario(
        cfg, seed=BF16_SEED, num_agents=BF16_AGENTS)]), "cpu")
    calls = PA.r_biased_attention_trainable.backward_calls
    logs = trainer.train_step(batch, torch.Generator().manual_seed(1))
    # eligible per forward at this depth: temporal, agent-agent, a2sa
    assert PA.r_biased_attention_trainable.backward_calls - calls == 3
    assert all(np.isfinite(float(v)) for v in logs.values())
    assert {p.dtype for p in trainer.model.parameters()} == {torch.bfloat16}
