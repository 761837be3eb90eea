"""The flagship rollout's two kernel variants, `use_fused_block` and
`use_pallas_attention`, each held against the JAX package's rollout with the
same flag on the CPU, where both sides run the kernels' plain versions: the
JAX Pallas kernels in interpret mode, the port's wrappers their plain
twins.

Config of tests/test_torch_rollout.py (A=16, P=128, D=32, fp32, beam 1,
forced insertion) cut to one agent and one seed layer (the refine pass reads
the first seed-layer-count trunk layers) to keep the two jitted JAX rollouts
cheap; the scenario, params and inputs are built once for both variants.
PARITY.md's limits: token ids, state ids, slot activity and insertion
counts bitwise equal; poses within 1e-3 (fp32 reduction order only).
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
from infgen_torch.ops import fused_block as FB
from infgen_torch.ops import pallas_attention as PA
from infgen_torch.rollout.closed_loop import make_rollout_fn
from infgen_torch.tokenizers.attr_tokenizer import AttrTokenizer
from infgen_torch.tokenizers.motion_tokenizer import MotionTokenizer
from infgen_torch.tokenizers.vocab import load_map_vocab

from test_torch_layers import (  # noqa: F401 (one_torch_thread: autouse)
    random_flax_params, one_torch_thread)
from test_torch_rollout import CFG, CLOSE, EXACT, POSE_TOL, _np

VARIANTS = {"fused_block": dict(use_fused_block=True),
            "pallas_attention": dict(use_pallas_attention=True)}
BASE = {**CFG, "num_agent_layers": 1, "num_seed_layers": 1}


@pytest.fixture(scope="module")
def runs():
    jcfg = JConfig(**BASE)
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

    cfg = Config(**BASE)
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

    out = {}
    for name, flags in VARIANTS.items():
        jc = jcfg.replace(**flags)
        jfn = j_rollout_fn(JModel(jc, jattr.grid, jattr.grid_size,
                                  jattr.angle_size), jc, jattr, jmt, jmv,
                           jit=True, force_insert=True)
        jout = jax.device_get(jfn(params, jscen, jinputs,
                                  jax.random.PRNGKey(7)))
        fn = make_rollout_fn(model, cfg.replace(**flags), attr, mt, mv,
                             force_insert=True)
        before = (FB.fused_attention_block.launches,
                  PA.r_biased_attention.launches)
        tout = fn(scen, inputs, torch.Generator().manual_seed(7))
        # CPU tensors take the plain twins: no kernel launches
        assert before == (FB.fused_attention_block.launches,
                          PA.r_biased_attention.launches)
        out[name] = (jout, {k: _np(v) for k, v in tout.items()})
    return out


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_variant_rollout_matches_jax(runs, variant):
    jout, out = runs[variant]
    assert set(out) == set(jout)
    for k in EXACT:
        np.testing.assert_array_equal(out[k], np.asarray(jout[k]), err_msg=k)
    for k in CLOSE:
        np.testing.assert_allclose(out[k], np.asarray(jout[k]),
                                   atol=POSE_TOL, rtol=0, err_msg=k)
    assert int(out["n_inserted"]) > 0
