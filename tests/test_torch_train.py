"""The port's training path (`infgen_torch/train/`, the training forward of
`model/`) held against the JAX package's on the CPU at a tiny size: D = 32,
2 heads of 16, one agent, seed and map layer, 12 agent slots, 10 seeds, 18
token steps, fp32, dropout 0 (the JAX side runs deterministic=False, so the
temporal key drop and the refine pass's pseudo-seed draw are live).

The same numpy-seeded synthetic scenario goes through both. The JAX side
(its loss_fn's body: inputs from rng_in, the forward from rng_fwd, losses,
value_and_grad) is jitted once per module (its trace and compile are most
of this file's time); its random draws (the map-token
mask's uniforms, the hist drop, the pseudo-seed uniforms) are taken from
the same keys and handed to the port as tensors. Model-level cases feed
the port the JAX package's ModelInputs, so that only the model differs;
the Trainer case builds its own inputs from the scenario.

Tolerances:
  - forward outputs: 1e-5 absolute (fp32, summation order); masks and
    integer outputs equal;
  - the total loss and every log: 1e-5 relative; the logged grad_norm
    1e-4 relative (a gradient quantity, see below);
  - gradients, per flax leaf: 1e-4 of the leaf's max |g| plus an fp32
    noise floor of 1e-7 x the largest |g| of the model (a leaf whose true
    gradient is zero reads noise on both sides). A ReLU whose input lies
    within the two sides' fp32 noise of 0 takes another derivative on each
    side (one such unit moved the temporal layer's q/k gradients by
    3.5e-3 of their max here, and a quarter of the leaves, those upstream
    of it, beyond the tolerance), so a leaf beyond the tolerance is accepted
    only if another of the port's evaluations of the same math meets it
    (float64; for use_pallas_attention the plain path in fp32 and float64,
    as the kernel branch computes its core in fp32 in any type): the
    port's math then equals the JAX package's, and the gap is fp32
    rounding at a kink. Its fp32 gap must stay within 1e-2 of its max;
  - the optimizer (OptaxAdamW against optax's chain, MultiSteps for
    accumulate_grad_batches = 2): updated parameters within 1e-6 from the
    same gradients (the JAX package's). From each side's own gradients the
    first AdamW step, u ~ g / |g|, would turn noise-level gradients into
    updates of order lr.

The JAX side runs with use_pallas_attention: its eligible sublayers go
through the Pallas kernel in interpret mode, and their VJP (_rba_bwd)
recomputes through the XLA reference, so it is one program for both of
the port's paths (the JAX package's own tests hold its Pallas path equal
to the plain one, values and gradients). The port runs both: the plain
modules, and the kernel branch, whose CPU path is the plain twin and
whose backward is the recompute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from infgen_tpu.config import Config as JConfig
from infgen_tpu.data.features import build_model_inputs as j_build
from infgen_tpu.data.synthetic import make_synthetic_scenario as j_synth
from infgen_tpu.train.losses import compute_losses as j_losses
from infgen_tpu.train.train_step import Trainer as JTrainer

from infgen_torch.config import Config
from infgen_torch.convert import (flatten_tree, load_flax_params,
                                  to_flax_tree, torch_name)
from infgen_torch.data.features import ModelInputs
from infgen_torch.data.scenario import stack_scenarios, to_device, tree_map
from infgen_torch.data.synthetic import make_synthetic_scenario
from infgen_torch.ops import pallas_attention as PA
from infgen_torch.tokenizers.motion_tokenizer import TokenizedAgents
from infgen_torch.train.losses import compute_losses
from infgen_torch.train.train_step import Trainer

from test_torch_layers import (  # noqa: F401 (one_torch_thread: autouse)
    one_torch_thread, random_flax_params)

# remat off: it changes no value on either side (the port's remat is held
# bit for bit against the plain layer in test_torch_pallas_attention.py)
# and its JAX trace costs seconds
CFG = dict(max_agents=12, max_map_tokens=128, num_agent_layers=1,
           num_seed_layers=1, num_map_layers=1, hidden_dim=32, num_heads=2,
           head_dim=16, num_freq_bands=8, dropout=0.0, remat_attention=False)
SEED, N_AGENTS = 3, 10
KEYS = (5, 6)           # one JAX key per step / micro-batch
ATOL, LOG_RTOL, GNORM_RTOL = 1e-5, 1e-5, 1e-4
GRAD_TOL, GRAD_FLOOR, KINK_TOL, PARAM_TOL = 1e-4, 1e-7, 1e-2, 1e-6
# the eligible sublayers of one forward at CFG: temporal and agent-agent of
# the agent layer, a2sa of the seed layer
ELIGIBLE = 3


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's loss_fn body for one scenario under
    use_pallas_attention (jitted value_and_grad with its predictions) and
    the random draws of each key in KEYS."""
    jcfg = JConfig(**CFG, use_pallas_attention=True)
    jt = JTrainer(jcfg, mesh=Mesh(np.array(jax.devices()[:1]), ("data",)))
    vocab, traj = jt.motion_tok.vocab, jt.map_vocab["traj_src"]
    scen = j_synth(jcfg, seed=SEED, num_agents=N_AGENTS)
    build = jax.jit(lambda s, k: j_build(jcfg, jt.motion_tok, jt.attr, s, k))

    def forward(params, inputs, rng_fwd):
        # dropout is 0: the dropout key is never read
        smap = jax.tree.map(jnp.asarray, scen.map)
        pred = jt.model.apply({"params": params}, inputs, smap, vocab, traj,
                              rng_fwd, deterministic=False,
                              rngs={"dropout": rng_fwd})
        loss, logs = j_losses(jcfg, jt.attr.grid_size, pred, inputs)
        return loss, (logs, pred)

    params = random_flax_params(jcfg, seed=0)
    A, T, P = jcfg.max_agents, jcfg.num_token_steps, jcfg.max_map_tokens
    grad_fn = jax.jit(jax.value_and_grad(forward, has_aux=True))
    runs = []
    for key in KEYS:
        # Trainer.batch_loss / loss_fn's keys for a batch of one
        r = jax.random.split(jax.random.PRNGKey(key), 1)[0]
        rng_in, rng_fwd, _ = jax.random.split(r, 3)
        inputs = build(scen, rng_in)
        (loss, (logs, pred)), grads = grad_fn(params, inputs, rng_fwd)
        rng_hist, rng_sa = jax.random.split(rng_fwd)
        draws = dict(
            pt_uniform=_t(jax.random.uniform(jax.random.split(rng_in)[0],
                                             (P,))),
            hist_drop=_t(jax.random.randint(rng_hist, (A, 10), 0, T)),
            sa_uniform=_t(jax.random.uniform(rng_sa, (A, T))))
        runs.append(dict(inputs=inputs, rng_fwd=rng_fwd, draws=draws,
                         loss=float(loss), logs=jax.device_get(logs),
                         pred=jax.device_get(pred),
                         grads=jax.device_get(grads)))
    return dict(params=params, runs=runs, jt=jt)


@pytest.fixture(scope="module")
def port_plain(jax_side):
    """The port's plain path (use_pallas_attention off) on the first run:
    fp32 (predictions, loss, logs, gradients) and float64 gradients."""
    trainer = _trainer(jax_side)
    run = jax_side["runs"][0]
    return _port_forward(trainer, run), \
        _port_forward(trainer, run, torch.float64)[3]


def _port_inputs(jinputs, dtype=torch.float32):
    """The JAX package's ModelInputs as the port's (floats in `dtype`)."""
    cv = lambda x: _t(x).to(dtype) if np.asarray(x).dtype.kind == "f" \
        else _t(x)
    return ModelInputs(tokens=TokenizedAgents(*map(cv, jinputs.tokens)),
                       **{f: cv(getattr(jinputs, f))
                          for f in jinputs._fields if f != "tokens"})


def _port_forward(trainer, run, dtype=torch.float32):
    """The port's forward, losses and gradients on the JAX run's inputs and
    draws, in train mode, in `dtype`."""
    model = trainer.model.to(dtype)
    model.train()
    model.zero_grad(set_to_none=True)
    dbl = lambda x: x.to(dtype) if x.is_floating_point() else x
    inputs = _port_inputs(run["inputs"], dtype)
    scen = to_device(make_synthetic_scenario(trainer.cfg, seed=SEED,
                                             num_agents=N_AGENTS), "cpu")
    draws = run["draws"]
    pred = model(inputs, tree_map(dbl, scen.map),
                 {k: dbl(v) for k, v in trainer.agent_vocab.items()},
                 dbl(trainer.map_traj), None, hist_drop=draws["hist_drop"],
                 sa_uniform=dbl(draws["sa_uniform"]))
    loss, logs = compute_losses(trainer.cfg, trainer.attr.grid_size, pred,
                                inputs)
    loss.backward()
    grads = flatten_tree(to_flax_tree(model, grads=True))
    model.float()
    return pred, loss.detach(), {k: v.detach() for k, v in logs.items()}, \
        grads


def _trainer(jax_side, **over):
    trainer = Trainer(Config(**CFG, **over), "cpu")
    load_flax_params(trainer.model, jax_side["params"])
    return trainer


def _check_forward(pred, jpred):
    assert set(pred) == set(jpred)
    for k, ref in jpred.items():
        if ref is None:
            assert pred[k] is None, k
            continue
        got, ref = _np(pred[k]), np.asarray(ref)
        assert got.shape == ref.shape, k
        if ref.dtype.kind == "f":
            np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got, ref, err_msg=k)


def _check_logs(loss, logs, run):
    assert set(logs) == set(run["logs"])
    np.testing.assert_allclose(float(loss), run["loss"], rtol=LOG_RTOL)
    for k, v in run["logs"].items():
        np.testing.assert_allclose(float(logs[k]), float(v), rtol=LOG_RTOL,
                                   atol=1e-12, err_msg=k)


def _check_grads(grads, jgrads, *exact):
    """Per leaf within GRAD_TOL of its max |g| plus the noise floor; a leaf
    beyond it only where one of the port's other evaluations of the same
    math (`exact`) meets that tolerance and the fp32 gap stays within
    KINK_TOL of the leaf's max (a ReLU kink flip: it moves every leaf
    upstream of the unit a little)."""
    ref = flatten_tree(jgrads)
    assert set(grads) == set(ref)
    floor = GRAD_FLOOR * max(np.abs(g).max() for g in ref.values())
    tol = {k: GRAD_TOL * np.abs(g).max() + floor for k, g in ref.items()}
    err = lambda g, k: np.abs(g[k] - ref[k]).max()
    bad = {"/".join(k): (err(grads, k), [err(g, k) for g in exact], tol[k])
           for k in ref if err(grads, k) > tol[k] and (
               min(err(g, k) for g in exact) > tol[k]
               or err(grads, k) > KINK_TOL * np.abs(ref[k]).max() + floor)}
    assert not bad, bad


def test_training_forward_loss_and_grads(jax_side, port_plain):
    """Every output of the training forward, the loss and its logs, and the
    gradients of every parameter, against the JAX package's."""
    run = jax_side["runs"][0]
    (pred, loss, logs, grads), grads64 = port_plain
    _check_forward(pred, run["pred"])
    _check_logs(loss, logs, run)
    _check_grads(grads, run["grads"], grads64)


def test_pallas_attention_training_path(jax_side, port_plain):
    """use_pallas_attention: the eligible sublayers through
    r_biased_attention_trainable (plain twin forward, recompute backward:
    one backward call per eligible call), held against the JAX package's
    run of the same flag."""
    run = jax_side["runs"][0]
    trainer = _trainer(jax_side, use_pallas_attention=True)
    calls = PA.r_biased_attention_trainable.backward_calls
    launches = PA.r_biased_attention.launches
    pred, loss, logs, grads = _port_forward(trainer, run)
    assert PA.r_biased_attention_trainable.backward_calls - calls == ELIGIBLE
    assert PA.r_biased_attention.launches == launches      # CPU: plain twin
    _check_forward(pred, run["pred"])
    _check_logs(loss, logs, run)
    # the same math on the plain path, in fp32 and float64 (the kernel
    # branch computes its core in fp32 whatever the model's type)
    (_, _, _, plain), plain64 = port_plain
    _check_grads(grads, run["grads"], plain, plain64)


def test_trainer_step_logs(jax_side):
    """Trainer.train_step on the port's own inputs of the same scenario
    (a batch of one, the JAX key's draws): its mean logs and grad_norm
    against the JAX package's."""
    run = jax_side["runs"][0]
    trainer = _trainer(jax_side)
    batch = to_device(stack_scenarios([make_synthetic_scenario(
        trainer.cfg, seed=SEED, num_agents=N_AGENTS)]), "cpu")
    logs = trainer.train_step(batch, draws=[run["draws"]])
    _check_logs(logs["loss"], {k: v for k, v in logs.items()
                               if k != "grad_norm"}, run)
    gnorm = float(optax.global_norm(run["grads"]))
    np.testing.assert_allclose(float(logs["grad_norm"]), gnorm,
                               rtol=GNORM_RTOL)
    assert trainer.step == 1


@pytest.mark.parametrize("k", [1, 2])
def test_optimizer_matches_optax(jax_side, k):
    """OptaxAdamW against the JAX Trainer's optax chain (clip, AdamW on
    the warmup-cosine schedule; MultiSteps for accumulate_grad_batches = 2)
    on the same gradients: parameters after each call within 1e-6. The
    chain runs on every leaf raveled into one vector (its transforms are
    elementwise but for the global norm, which the concatenation keeps),
    so that its jit is one small program."""
    jcfg = JConfig(**CFG, accumulate_grad_batches=k)
    tx = JTrainer(jcfg, mesh=jax_side["jt"].mesh).tx
    paths = sorted(flatten_tree(jax_side["params"]))
    ravel = lambda tree: np.concatenate(
        [np.ravel(flatten_tree(tree)[p]) for p in paths])
    params = ravel(jax_side["params"])
    state = tx.init(params)

    @jax.jit
    def update(grads, state, params):
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    trainer = _trainer(jax_side, accumulate_grad_batches=k)
    opt = trainer.optimizer
    for i, run in enumerate(jax_side["runs"][:k]):
        params, state = update(ravel(run["grads"]), state, params)
        tgrads = dict(_torch_leaf(p, g) for p, g in
                      flatten_tree(run["grads"]).items())
        updated = opt.step([tgrads[n] for n in opt.names])
        assert updated == (i == k - 1)
        got = ravel(to_flax_tree(trainer.model))
        np.testing.assert_allclose(got, np.asarray(params), atol=PARAM_TOL,
                                   rtol=0)
    assert opt.count == 1


def _torch_leaf(path, g):
    """(torch parameter name, gradient tensor) of a flax leaf."""
    g = np.array(g, np.float32)
    return torch_name(path), torch.as_tensor(g.T if path[-1] == "kernel"
                                             else g)


def _batch(cfg, seeds):
    return to_device(stack_scenarios([make_synthetic_scenario(
        cfg, seed=s, num_agents=N_AGENTS) for s in seeds]), "cpu")


def test_train_step_improves_loss():
    """Mirror of tests/test_train.py::test_train_step_improves_loss on the
    port: five steps on one scenario with dropout, weights from the
    config's seed; every loss finite, the last below the first."""
    cfg = Config(**dict(CFG, dropout=0.1, remat_attention=True))
    trainer = Trainer(cfg, "cpu")
    trainer.init_state()
    batch = _batch(cfg, [SEED])
    gen = torch.Generator().manual_seed(1)
    losses = []
    for _ in range(5):
        logs = trainer.train_step(batch, gen)
        losses.append(float(logs["loss"]))
        assert np.isfinite(losses[-1]), logs
    assert losses[-1] < losses[0], losses


def test_bf16_policy_step_is_finite():
    """One step under the bf16 compute policy with dropout, a batch of two:
    finite losses, gradient norm and updated parameters."""
    cfg = Config(**dict(CFG, dropout=0.1, compute_dtype="bfloat16",
                        remat_attention=True))
    trainer = Trainer(cfg, "cpu")
    trainer.init_state(torch.Generator().manual_seed(4))
    logs = trainer.train_step(_batch(cfg, [SEED, SEED + 1]),
                              torch.Generator().manual_seed(2))
    assert all(np.isfinite(float(v)) for v in logs.values()), logs
    assert float(logs["grad_norm"]) > 0
    assert all(torch.isfinite(p).all() for p in trainer.model.parameters())
