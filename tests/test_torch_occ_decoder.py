"""The port's occupancy decoder (`decoder_type: occ_decoder`,
infgen_torch/model/occ_decoder.py) and its training step held against the
JAX package's on the CPU, fp32, at a tiny size: D = 32, 8 Fourier bands,
16 agent slots, 128 map tokens, a 10 m grid (177 cells within the 75 m
radius, so that the heads stay small).

The JAX side is the body of its Trainer.loss_fn for a batch of one (inputs
from rng_in, the selections from rng_fwd, value_and_grad), jitted once;
its random selections (jax.random.permutation, which torch cannot
reproduce) and map uniforms are handed to the port.

Tolerances: outputs and every log 1e-5 (fp32, summation order; the
ground-truth cells and masks equal); gradients per flax leaf within 1e-4
of the leaf's max |g| plus 1e-7 of the model's largest |g|; the optimizer
on the JAX package's own gradients within 1e-6 of optax's update (as
tests/test_torch_train.py::test_optimizer_matches_optax: Adam's first
step is about lr g / |g|).
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
from infgen_tpu.model.occ_decoder import occ_decoder_loss as j_occ_loss
from infgen_tpu.train.train_step import Trainer as JTrainer

from infgen_torch.config import Config
from infgen_torch.convert import flatten_tree, load_flax_params, to_flax_tree
from infgen_torch.data.scenario import stack_scenarios, to_device
from infgen_torch.data.synthetic import make_synthetic_scenario
from infgen_torch.model.occ_decoder import (AGENT_LIMIT, PT_LIMIT,
                                            OccDecoder, occ_decoder_loss)
from infgen_torch.train.train_step import Trainer

from test_torch_layers import fill_tree, one_torch_thread  # noqa: F401
from test_torch_train import _check_logs, _port_inputs, _torch_leaf

CFG = dict(decoder_type="occ_decoder", predict_occ=True, max_agents=16,
           max_map_tokens=128, hidden_dim=32, num_heads=2, head_dim=16,
           num_freq_bands=8, grid_interval=10.0)
SEED, N_AGENTS, KEY = 2, 15, 11
ATOL, PARAM_TOL, GRAD_TOL, GRAD_FLOOR = 1e-5, 1e-6, 1e-4, 1e-7


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def jax_side():
    """The JAX occupancy decoder's loss_fn body on one scenario: params
    (numpy-seeded), inputs, selections, outputs, loss, logs, gradients."""
    jcfg = JConfig(**CFG)
    jt = JTrainer(jcfg, mesh=Mesh(np.array(jax.devices()[:1]), ("data",)))
    scen = jax.tree.map(jnp.asarray,
                        j_synth(jcfg, seed=SEED, num_agents=N_AGENTS))
    r = jax.random.split(jax.random.PRNGKey(KEY), 1)[0]
    rng_in, rng_fwd, _ = jax.random.split(r, 3)
    inputs = jax.jit(lambda s, k: j_build(jcfg, jt.motion_tok, jt.attr, s,
                                          k))(scen, rng_in)
    pos, orient = scen.map.position, scen.map.orientation
    shapes = jax.eval_shape(lambda: jt.model.init(
        {"params": rng_fwd}, inputs, pos, orient, rng_fwd))["params"]
    params = fill_tree(shapes, np.random.default_rng(0))

    def loss(p):
        pred = jt.model.apply({"params": p}, inputs, pos, orient, rng_fwd)
        total, logs = j_occ_loss(pred)
        return total, (logs, pred)

    (total, (logs, pred)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)
    rng_a, rng_p = jax.random.split(rng_fwd)
    A, P = jcfg.max_agents, jcfg.max_map_tokens
    draws = dict(
        sel_a=_t(jax.random.permutation(rng_a, A)[:AGENT_LIMIT]),
        sel_p=_t(jax.random.permutation(rng_p, P)[:PT_LIMIT]),
        pt_uniform=_t(jax.random.uniform(jax.random.split(rng_in)[0],
                                         (P,))))
    return dict(jt=jt, params=params, inputs=inputs, draws=draws,
                loss=float(total), logs=jax.device_get(logs),
                pred=jax.device_get(pred), grads=jax.device_get(grads))


def _trainer(jax_side, **over):
    trainer = Trainer(Config(**CFG, **over), "cpu")
    load_flax_params(trainer.model, jax_side["params"])
    return trainer


def _batch(cfg):
    return to_device(stack_scenarios([make_synthetic_scenario(
        cfg, seed=SEED, num_agents=N_AGENTS)]), "cpu")


def test_occ_decoder_matches_jax(jax_side):
    """OccDecoder's outputs and occ_decoder_loss on the JAX package's
    inputs and selections, with the converted params."""
    model = OccDecoder(Config(**CFG), jax_side["jt"].attr.grid_size)
    load_flax_params(model, jax_side["params"])
    scen = to_device(make_synthetic_scenario(Config(**CFG), seed=SEED,
                                             num_agents=N_AGENTS), "cpu")
    d = jax_side["draws"]
    with torch.no_grad():
        pred = model(_port_inputs(jax_side["inputs"]), scen.map.position,
                     scen.map.orientation, sel_a=d["sel_a"],
                     sel_p=d["sel_p"])
    jpred = jax_side["pred"]
    assert set(pred) == set(jpred)
    for k, ref in jpred.items():
        got = pred[k]
        if k == "occ_decoder":
            assert got is True
            continue
        got, ref = got.detach().numpy(), np.asarray(ref)
        assert got.shape == ref.shape, k
        if ref.dtype.kind == "f":
            np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got, ref, err_msg=k)
    assert jpred["agent_occ_eval_mask"].any() and \
        jpred["pt_occ_eval_mask"].any()
    loss, logs = occ_decoder_loss(pred)
    _check_logs(loss, logs, jax_side)


def test_occ_trainer_step_matches_jax(jax_side):
    """One Trainer.train_step of the occupancy config on the port's own
    inputs of the same scenario (a batch of one, the JAX key's draws): its
    logs, grad_norm and per-leaf gradients against the JAX package's."""
    trainer = _trainer(jax_side)
    assert trainer.is_occ_decoder
    logs = trainer.train_step(_batch(trainer.cfg),
                              draws=[jax_side["draws"]])
    _check_logs(logs["loss"], {k: v for k, v in logs.items()
                               if k != "grad_norm"}, jax_side)
    np.testing.assert_allclose(float(logs["grad_norm"]),
                               float(optax.global_norm(jax_side["grads"])),
                               rtol=1e-4)
    grads = flatten_tree(to_flax_tree(trainer.model, grads=True))
    ref = flatten_tree(jax_side["grads"])
    assert set(grads) == set(ref)
    floor = GRAD_FLOOR * max(np.abs(g).max() for g in ref.values())
    bad = {"/".join(k): float(np.abs(grads[k] - g).max())
           for k, g in ref.items()
           if np.abs(grads[k] - g).max() > GRAD_TOL * np.abs(g).max() + floor}
    assert not bad, bad
    assert trainer.step == 1


def test_occ_optimizer_matches_optax(jax_side):
    """The occupancy Trainer's optimizer against the JAX Trainer's optax
    chain on the same (the JAX package's) gradients: updated parameters
    within 1e-6."""
    jt, params = jax_side["jt"], jax_side["params"]
    paths = sorted(flatten_tree(params))
    ravel = lambda tree: np.concatenate(
        [np.ravel(flatten_tree(tree)[p]) for p in paths])
    p0 = ravel(params)
    updates, _ = jax.jit(jt.tx.update)(ravel(jax_side["grads"]),
                                        jt.tx.init(p0), p0)
    want = np.asarray(optax.apply_updates(p0, updates))
    trainer = _trainer(jax_side)
    opt = trainer.optimizer
    tgrads = dict(_torch_leaf(p, g) for p, g in
                  flatten_tree(jax_side["grads"]).items())
    assert opt.step([tgrads[n] for n in opt.names])
    np.testing.assert_allclose(ravel(to_flax_tree(trainer.model)), want,
                               atol=PARAM_TOL, rtol=0)


def test_occ_draws_from_generator():
    """Without given selections the decoder draws AGENT_LIMIT distinct
    slots and PT_LIMIT distinct tokens from the generator: the same seed
    gives the same draws and loss, and the Trainer's step runs on them."""
    cfg = Config(**CFG)
    trainer = Trainer(cfg, "cpu")
    trainer.init_state(torch.Generator().manual_seed(1))
    sel_a, sel_p = OccDecoder.draw(16, 128, torch.Generator().manual_seed(3))
    assert len(set(sel_a.tolist())) == AGENT_LIMIT
    assert len(set(sel_p.tolist())) == PT_LIMIT
    assert int(sel_a.max()) < 16 and int(sel_p.max()) < 128
    scen = to_device(make_synthetic_scenario(cfg, seed=SEED,
                                             num_agents=N_AGENTS), "cpu")
    with torch.no_grad():
        losses = [float(trainer.loss_fn(
            scen, torch.Generator().manual_seed(5))[0]) for _ in range(2)]
    assert losses[0] == losses[1] and np.isfinite(losses[0])
    logs = trainer.train_step(_batch(cfg), torch.Generator().manual_seed(2))
    assert set(logs) == {"agent_occ_cls_loss", "pt_occ_cls_loss", "loss",
                         "grad_norm"}
    assert all(np.isfinite(float(v)) for v in logs.values())


def test_global_norm_of_a_large_leaf():
    """The logged grad_norm of a leaf the size of the occupancy decoder's
    point head: within 1e-6 of the float64 norm (one fp32 CPU norm of a
    38M-element tensor read 0.26% low)."""
    from infgen_torch.train.train_step import global_norm

    x = torch.randn(1 << 22, generator=torch.Generator().manual_seed(0))
    want = float(torch.linalg.vector_norm(x.double()))
    got = float(global_norm([x, x[:100].clone()]))
    want = (want ** 2 + float(x[:100].double().square().sum())) ** 0.5
    assert abs(got - want) / want < 1e-6
