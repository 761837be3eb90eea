"""The JAX package's side of the port's parity tests that run it in spawned
processes (tests/test_torch_configs.py, tests/test_torch_validation.py,
tests/test_torch_learning.py).

This module imports JAX, optax, numpy and the JAX package only: a spawned
process imports the module of the function it runs, and this one starts
without torch or the test modules (the rollout and the training loop,
whose imports take seconds, only in the functions that run them). Each function takes its configuration
as a dict and its weights as a flax params tree of numpy arrays, and
returns numpy values.
"""

import multiprocessing
import os
from functools import partial
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh

from infgen_tpu.config import Config as JConfig
from infgen_tpu.config import load_config as j_load_config
from infgen_tpu.data.features import build_model_inputs as j_build_inputs
from infgen_tpu.data.synthetic import make_synthetic_scenario as j_synth
from infgen_tpu.model.infgen import InfGenModel as JModel
from infgen_tpu.ops.precision import cast_params_for_compute as j_cast
from infgen_tpu.train.train_step import Trainer as JTrainer
from infgen_tpu.train.train_step import stack_scenarios as j_stack


# bf16 as the JAX program writes it: without this XLA may keep a bf16 op's
# result in f32 for the op that reads it (its excess precision), which
# rounds as no line of the JAX package says (a LayerNorm of the seeds' bf16
# shape embedding read one bf16 step apart in a quarter of its values), and
# which values it keeps depends on its fusion
EXACT_BF16 = {"xla_allow_excess_precision": False}


def spawn_pool(processes: int):
    """A spawn pool for a module's JAX side, its XLA backend at
    optimisation level 0: a jitted training forward of the tiny model then
    compiles in 36 s of CPU instead of 58 (its HLO, which sets the
    numerics held here, is the same), which the rest of the suite running
    beside it needs."""
    flags = os.environ.get("XLA_FLAGS", "")
    os.environ["XLA_FLAGS"] = f"{flags} --xla_backend_optimization_level=0"
    try:
        return multiprocessing.get_context("spawn").Pool(processes)
    finally:
        os.environ["XLA_FLAGS"] = flags


def _trainer(jcfg):
    return JTrainer(jcfg, mesh=Mesh(np.array(jax.devices()[:1]), ("data",)))


def _uniform(key, shape):
    return np.array(jax.random.uniform(key, shape))


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def config_losses(specs):
    """Trainer.loss_fn (deterministic, jitted) of each config in `specs`,
    a list of (name, yaml path, overrides, flax params, scenario seed,
    number of agents, key): {name: (loss, logs, pt_uniform, sa_uniform)},
    the uniforms drawn from the input key and the forward key as loss_fn
    splits them."""
    out = {}
    for name, path, over, tree, seed, agents, key in specs:
        key = jax.random.PRNGKey(key)
        rng_in, rng_fwd, _ = jax.random.split(key, 3)
        jcfg = j_load_config(path).replace(**over)
        jt = _trainer(jcfg)
        scen = j_synth(jcfg, seed=seed, num_agents=agents)
        loss, logs = jax.jit(lambda p, s, r: jt.loss_fn(
            p, s, r, deterministic=True))(tree, scen, key)
        A, T = jcfg.max_agents, jcfg.num_token_steps
        out[name] = (float(loss), _np(logs),
                     _uniform(jax.random.split(rng_in)[0],
                              (jcfg.max_map_tokens,)),
                     _uniform(jax.random.split(rng_fwd)[1], (A, T)))
    return out


def forced_rollout(cfg, params, seed, agents):
    """The map uniforms of the input key PRNGKey(0) and the JAX package's
    rollout (jitted) at `cfg`, forced insertion, on the flax `params`, from
    PRNGKey(7)."""
    from infgen_tpu.rollout.closed_loop import make_rollout_fn as j_rollout_fn

    jcfg = JConfig(**cfg)
    jt = _trainer(jcfg)
    key = jax.random.PRNGKey(0)
    scen = j_synth(jcfg, seed=seed, num_agents=agents)
    inputs = jax.jit(lambda s, k: j_build_inputs(
        jcfg, jt.motion_tok, jt.attr, s, k))(scen, key)
    fn = j_rollout_fn(JModel(jcfg, jt.attr.grid, jt.attr.grid_size,
                             jt.attr.angle_size), jcfg, jt.attr,
                      jt.motion_tok, jt.map_vocab, jit=True,
                      force_insert=True)
    out = _np(fn(params, scen, inputs, jax.random.PRNGKey(7)))
    return _uniform(jax.random.split(key)[0], (jcfg.max_map_tokens,)), out


def open_loop(cfg, tree, n):
    """validate_open_loop and check_inputs on the synthetic scenarios
    0 .. n - 1 of `cfg` with the flax params `tree`, and validate_open_loop's
    draws per scenario (its key cfg.seed + 99, split once per scenario;
    the loss's from the split rng_in / rng_fwd, the accuracy forward's from
    the unsplit key): (logs, totals, overlap, draws)."""
    from infgen_tpu.train.loop import SyntheticDataset as JSyntheticDataset
    from infgen_tpu.train.loop import check_inputs as j_check_inputs
    from infgen_tpu.train.loop import validate_open_loop as j_validate

    jcfg = JConfig(**cfg)
    jt = _trainer(jcfg)
    data = JSyntheticDataset(jcfg, size=n)
    quiet = lambda msg: None
    val = j_validate(jt, SimpleNamespace(params=tree), data, n,
                     log_fn=quiet)
    totals, overlap = j_check_inputs(jcfg, data, n, log_fn=quiet)
    A, T, P = jcfg.max_agents, jcfg.num_token_steps, jcfg.max_map_tokens
    rng, draws = jax.random.PRNGKey(jcfg.seed + 99), []
    for _ in range(n):
        rng, sub = jax.random.split(rng)
        rng_in, rng_fwd, _ = jax.random.split(sub, 3)
        draws.append(dict(
            loss=dict(pt_uniform=_uniform(jax.random.split(rng_in)[0], (P,)),
                      sa_uniform=_uniform(jax.random.split(rng_fwd)[1],
                                          (A, T))),
            accuracy=dict(pt_uniform=_uniform(jax.random.split(sub)[0], (P,)),
                          sa_uniform=_uniform(jax.random.split(sub)[1],
                                              (A, T)))))
    return ({k: float(v) for k, v in val.items()}, totals, _np(overlap),
            draws)


def _adam_moments(opt_state):
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    return adam.mu, adam.nu


def bf16_occupancy_step(cfg, tree, seed, agents, key):
    """One training step of the occupancy decoder at `cfg` (param_dtype
    bfloat16) from `tree` cast as the JAX Trainer's init casts it, on a
    batch of one: its make_train_step (value_and_grad of batch_loss, tx's
    update, apply_updates; jitted, EXACT_BF16) returning the gradients and
    the optimizer's moments too. Returns a dict of the logs (grad_norm: optax.global_norm,
    which sums bf16 squares in bf16), `grad_norm_f32` (the same gradients'
    norm summed in fp32), the key's draws, and the parameters before and
    after, the gradients, mu and nu as float32 trees (all bf16 values),
    with the set of the parameters' dtypes."""
    jcfg = JConfig(**cfg)
    jt = _trainer(jcfg)
    batch = j_stack([j_synth(jcfg, seed=seed, num_agents=agents)])
    params = j_cast(jax.tree.map(jnp.asarray, tree), jcfg.param_dtype)

    @partial(jax.jit, compiler_options=EXACT_BF16)
    def step(params, opt_state, batch, rng):
        (_, logs), grads = jax.value_and_grad(
            jt.batch_loss, has_aux=True)(params, batch, rng)
        updates, opt_state = jt.tx.update(grads, opt_state, params)
        logs["grad_norm"] = optax.global_norm(grads)
        norm32 = jnp.sqrt(sum(jnp.sum(jnp.square(g.astype(jnp.float32)))
                              for g in jax.tree_util.tree_leaves(grads)))
        return (optax.apply_updates(params, updates), opt_state, logs,
                grads, norm32)

    key = jax.random.PRNGKey(key)
    new, opt_state, logs, grads, norm32 = step(
        params, jt.tx.init(params), batch, key)
    rng_in, rng_fwd, _ = jax.random.split(jax.random.split(key, 1)[0], 3)
    rng_a, rng_p = jax.random.split(rng_fwd)
    A, P = jcfg.max_agents, jcfg.max_map_tokens
    draws = dict(sel_a=np.array(jax.random.permutation(rng_a, A)[:3]),
                 sel_p=np.array(jax.random.permutation(rng_p, P)[:10]),
                 pt_uniform=_uniform(jax.random.split(rng_in)[0], (P,)))
    mu, nu = _adam_moments(opt_state)
    f32 = lambda t: jax.tree.map(lambda x: np.asarray(x, np.float32), t)
    return dict(logs={k: float(v) for k, v in logs.items()},
                grad_norm_f32=float(norm32), draws=draws,
                before=f32(params), after=f32(new), grads=f32(grads),
                mu=f32(mu), nu=f32(nu),
                dtypes={str(x.dtype) for x in
                        jax.tree_util.tree_leaves((new, grads, mu, nu))})


def bf16_agent_loss(cfg, tree, seed, agents, key):
    """The agent decoder's deterministic loss_fn (jitted, EXACT_BF16) at
    `cfg` (param_dtype bfloat16) from `tree` cast to bf16, and its key's
    draws: (loss, logs, draws)."""
    jcfg = JConfig(**cfg)
    jt = _trainer(jcfg)
    scen = j_synth(jcfg, seed=seed, num_agents=agents)
    params = j_cast(jax.tree.map(jnp.asarray, tree), jcfg.param_dtype)
    key = jax.random.PRNGKey(key)
    loss, logs = jax.jit(lambda p, s, r: jt.loss_fn(
        p, s, r, deterministic=True), compiler_options=EXACT_BF16)(
            params, scen, key)
    A, T, P = jcfg.max_agents, jcfg.num_token_steps, jcfg.max_map_tokens
    rin, rfwd, _ = jax.random.split(key, 3)      # loss_fn's own split
    draws = dict(pt_uniform=_uniform(jax.random.split(rin)[0], (P,)),
                 sa_uniform=_uniform(jax.random.split(rfwd)[1], (A, T)))
    return float(loss), {k: float(v) for k, v in logs.items()}, draws


def bf16_sides(occ, agent):
    """bf16_occupancy_step(*occ) and bf16_agent_loss(*agent) in one
    process."""
    return bf16_occupancy_step(*occ), bf16_agent_loss(*agent)


def learning_scores(cfg, tree, n, agents, steps):
    """scripts/validate_learning.py's set-up at `cfg` (total_steps set to
    `steps`; the synthetic scenarios 0 .. n - 1 of `agents` agents, their
    inputs from PRNGKey(0) split n ways), its GT-replay ceiling and its
    untrained score (`score`: the scenarios as lanes of one jit(vmap)
    rollout from PRNGKey(7) split n ways, features and metrics per
    scenario, jitted; the log histograms jitted too, where the script
    builds them op by op) on the flax params `tree`: {"gt_replay": ...,
    "before": ...}, each per-scenario lists of the metametric and the
    simulated collision rate."""
    from infgen_tpu.metrics.features import compute_metric_features
    from infgen_tpu.metrics.wosac import (WosacConfig,
                                          compute_scenario_metrics,
                                          make_log_distributions)
    from infgen_tpu.rollout.closed_loop import make_rollout_fn as j_rollout_fn

    jcfg = JConfig(**cfg).replace(total_steps=steps)
    jt = _trainer(jcfg)
    scens = [j_synth(jcfg, seed=s, num_agents=agents) for s in range(n)]
    inputs_b = jax.jit(jax.vmap(lambda s, r: j_build_inputs(
        jcfg, jt.motion_tok, jt.attr, s, r)))(
            j_stack(scens), jax.random.split(jax.random.PRNGKey(0), n))
    wcfg = WosacConfig()
    gt_fn = jax.jit(lambda s, i: compute_metric_features(
        s.agents.position[..., :2], s.agents.heading, s.agents.valid,
        s.agents.shape[:, 0], s.agents.shape[:, 1], s.agents.slot_mask,
        s.agents.av_index, i.tokens.token_pos, i.tokens.state_idx,
        traj_z=s.agents.elevation))
    score_fn = jax.jit(lambda ld, f: compute_scenario_metrics(wcfg, ld, f))
    dist_fn = jax.jit(lambda f: make_log_distributions(wcfg, f))
    log_dists, gt = [], []
    for i in range(n):
        f = gt_fn(scens[i], jax.tree.map(lambda x, i=i: x[i], inputs_b))
        log_dists.append(dist_fn(f))
        gt.append(score_fn(log_dists[i], f))
    rollout = jax.jit(jax.vmap(
        j_rollout_fn(jt.model, jcfg, jt.attr, jt.motion_tok, jt.map_vocab,
                     jit=False), in_axes=(None, 0, 0, 0)))
    out = rollout(jax.tree.map(jnp.asarray, tree), j_stack(scens), inputs_b,
                  jax.random.split(jax.random.PRNGKey(7), n))
    feats_fn = jax.jit(lambda o: compute_metric_features(
        o["pred_traj"], o["pred_head"], o["pred_valid"],
        o["eval_shape"][:, 0], o["eval_shape"][:, 1], o["slot_active"],
        o["av_index"], o["pos_a"], o["next_state_idx"]))
    before = [score_fn(log_dists[i], feats_fn(
        jax.tree.map(lambda x, i=i: x[i], out))) for i in range(n)]
    pick = lambda ms: dict(
        metametric=[float(m["metametric"]) for m in ms],
        collision_rate=[float(m["simulated_collision_rate"]) for m in ms])
    return dict(gt_replay=pick(gt), before=pick(before))


def learning_losses(cfg, tree, n, agents, steps, n_losses):
    """The script's training loop from the flax params `tree`: the losses
    of its first `n_losses` steps (Trainer.train_step on the batch of
    scenarios (i, i + 1 mod n) for even i, cycled, under the host-side key
    [1, step]). The step is Trainer.train_step's math with batch_loss's
    vmap written out: each scenario's value_and_grad of Trainer.loss_fn
    under its key of the batch's split (one jitted program for both: the
    vmapped step took 66 s to trace and compile here, this 43 s), their
    means, then the trainer's optax chain (jitted). Returns (losses,
    draws): draws[step] the random inputs of each scenario of the step's
    batch as loss_fn splits its key (the map mask's uniforms, the history
    drop, the pseudo-seed uniforms)."""
    jcfg = JConfig(**cfg).replace(total_steps=steps)
    jt = _trainer(jcfg)
    scens = [jax.tree.map(jnp.asarray, j_synth(jcfg, seed=s,
                                               num_agents=agents))
             for s in range(n)]
    grad_fn = jax.jit(jax.value_and_grad(jt.loss_fn, has_aux=True))

    @jax.jit
    def update(g0, g1, opt_state, params):
        grads = jax.tree.map(lambda a, b: (a + b) * 0.5, g0, g1)
        updates, opt_state = jt.tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    params = jax.tree.map(jnp.asarray, tree)
    opt_state = jt.tx.init(params)
    pairs = [(i, (i + 1) % n) for i in range(0, n, 2)]
    A, T, P = jcfg.max_agents, jcfg.num_token_steps, jcfg.max_map_tokens
    losses, draws = [], []
    for step in range(n_losses):
        keys = jax.random.split(jnp.asarray(np.array([1, step], np.uint32)),
                                2)
        (l0, _), g0 = grad_fn(params, scens[pairs[step % len(pairs)][0]],
                              keys[0])
        (l1, _), g1 = grad_fn(params, scens[pairs[step % len(pairs)][1]],
                              keys[1])
        losses.append(float(jnp.mean(jnp.stack([l0, l1]))))
        params, opt_state = update(g0, g1, opt_state, params)
        per = []
        for r in keys:
            rng_in, rng_fwd, _ = jax.random.split(r, 3)
            rng_hist, rng_sa = jax.random.split(rng_fwd)
            per.append(dict(
                pt_uniform=_uniform(jax.random.split(rng_in)[0], (P,)),
                hist_drop=np.array(jax.random.randint(rng_hist, (A, 10), 0,
                                                      T)),
                sa_uniform=_uniform(rng_sa, (A, T))))
        draws.append(per)
    return losses, draws
