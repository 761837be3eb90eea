"""The port's closed-loop rollout with the latency preset's three kernels
(use_seed_kernel_full, use_refine_kernel, use_column_kernel) held against
the JAX package's rollout with the same flags on the CPU, where both sides
run the kernels' plain versions: the JAX Pallas kernels in interpret mode,
the port's wrappers their plain twins.

Config of tests/test_torch_rollout.py (A=16, P=128, D=32, 30 frames, fp32,
beam 1, forced insertion) with 2 agent and 2 seed layers instead of 3, to
keep the jitted JAX rollout's compile short. Token ids, state ids,
slot activity and insertion counts must be bitwise equal; poses agree
within 1e-3 (fp32 reduction order only). The port's rollout with the flags
on must also equal its rollout with them off on the same inputs, as the
JAX package's kernel A/B tests check for its own.
"""

import jax
import numpy as np
import pytest
import torch

from infgen_tpu.config import Config as JConfig
from infgen_tpu.data.features import build_model_inputs as j_build_inputs
from infgen_tpu.data.synthetic import make_synthetic_scenario as j_synthetic
from infgen_tpu.model.infgen import InfGenModel as JModel
from infgen_tpu.rollout.closed_loop import make_rollout_fn as j_rollout_fn
from infgen_tpu.tokenizers.attr_tokenizer import AttrTokenizer as JAttr
from infgen_tpu.tokenizers.motion_tokenizer import MotionTokenizer as JMotion
from infgen_tpu.tokenizers.vocab import load_map_vocab as j_map_vocab

from infgen_torch.config import Config
from infgen_torch.convert import load_flax_params
from infgen_torch.data.features import build_model_inputs
from infgen_torch.data.scenario import to_device
from infgen_torch.data.synthetic import make_synthetic_scenario
from infgen_torch.model.infgen import InfGenModel
from infgen_torch.ops import column_kernel as CK
from infgen_torch.ops import refine_kernel as RFK
from infgen_torch.ops import seed_kernel as SKN
from infgen_torch.rollout.closed_loop import make_rollout_fn
from infgen_torch.tokenizers.attr_tokenizer import AttrTokenizer
from infgen_torch.tokenizers.motion_tokenizer import MotionTokenizer
from infgen_torch.tokenizers.vocab import load_map_vocab

from test_torch_layers import (  # noqa: F401 (one_torch_thread: autouse)
    random_flax_params, one_torch_thread)
from test_torch_rollout import CFG, CLOSE, EXACT, POSE_TOL, _np

LATENCY = dict(use_seed_kernel_full=True, use_refine_kernel=True,
               use_column_kernel=True)
BASE = {**CFG, "num_agent_layers": 2, "num_seed_layers": 2}
KERNEL_FLAGS = ("use_seed_kernel", "use_seed_kernel_full",
                "use_refine_kernel", "use_column_kernel", "use_fused_block",
                "use_pallas_attention")


@pytest.fixture(scope="module")
def runs():
    jcfg = JConfig(**BASE, **LATENCY)
    jattr = JAttr(jcfg.grid_range, jcfg.grid_interval, jcfg.pl2seed_radius,
                  jcfg.angle_interval)
    jmt, jmv = JMotion(), j_map_vocab()
    jscen = j_synthetic(jcfg, seed=2, num_agents=10)
    key = jax.random.PRNGKey(0)
    jinputs = jax.jit(lambda s, k: j_build_inputs(jcfg, jmt, jattr, s, k))(
        jscen, key)
    pt_uniform = np.array(jax.random.uniform(
        jax.random.split(key)[0], (jcfg.max_map_tokens,)))
    params = random_flax_params(jcfg, seed=0)
    jfn = j_rollout_fn(JModel(jcfg, jattr.grid, jattr.grid_size,
                              jattr.angle_size), jcfg, jattr, jmt, jmv,
                       jit=True, force_insert=True)
    jout = jax.device_get(jfn(params, jscen, jinputs, jax.random.PRNGKey(7)))

    cfg = Config(**BASE, **LATENCY)
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
    outs = {}
    for name, c in (("on", cfg), ("off", cfg.replace(
            use_seed_kernel_full=False, use_refine_kernel=False,
            use_column_kernel=False))):
        fn = make_rollout_fn(model, c, attr, mt, mv, force_insert=True)
        before = {f: f.launches for f in (SKN.seed_eval_kernel,
                                          SKN.seed_eval_full_kernel,
                                          RFK.refine_kernel,
                                          CK.motion_column_kernel)}
        out = fn(scen, inputs, torch.Generator().manual_seed(7))
        outs[name] = {k: _np(v) for k, v in out.items()}
        # CPU tensors take the plain twins: no kernel launches
        assert all(f.launches == n for f, n in before.items())
    return jout, outs, (model, cfg, attr, mt, mv)


def test_latency_rollout_matches_jax(runs):
    jout, outs, _ = runs
    out = outs["on"]
    assert set(out) == set(jout)
    for k in EXACT:
        np.testing.assert_array_equal(out[k], np.asarray(jout[k]), err_msg=k)
    for k in CLOSE:
        np.testing.assert_allclose(out[k], np.asarray(jout[k]),
                                   atol=POSE_TOL, rtol=0, err_msg=k)
    assert int(out["n_inserted"]) > 0


def test_latency_kernels_match_plain_path(runs):
    """Flags on against flags off, on the same inputs (the port's analogue
    of tests/test_rollout.py's kernel A/B tests): the kernels change only
    the reduction order of fp32 sums."""
    _, outs, _ = runs
    on, off = outs["on"], outs["off"]
    for k in EXACT:
        np.testing.assert_array_equal(on[k], off[k], err_msg=k)
    for k in CLOSE:
        np.testing.assert_allclose(on[k], off[k], atol=POSE_TOL, rtol=0,
                                   err_msg=k)
    assert int(on["n_inserted"]) > 0


def test_every_kernel_flag_accepted(runs):
    """make_rollout_fn takes each kernel flag, and all of them together:
    every TPU kernel's forward has its port."""
    model, cfg, attr, mt, mv = runs[2]
    off = cfg.replace(**{f: False for f in KERNEL_FLAGS})
    for flags in [{f: True} for f in KERNEL_FLAGS] + [
            {f: True for f in KERNEL_FLAGS}]:
        assert callable(make_rollout_fn(model, off.replace(**flags), attr,
                                        mt, mv))
