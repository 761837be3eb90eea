"""The port's sampled rollouts (top-k multinomial, beam > 1) held against
the JAX package's in distribution, on the CPU.

JAX keys and torch generators give different draws, so the two rollouts
can agree only in distribution. Over N seeded rollouts of one scenario per
side (the JAX package's rollout under jax.vmap over N keys; the port's as
one batched rollout of N lanes, a generator each), with the same converted
weights and the same inputs, the statistics of
tests/test_rollout_parity_sampled.py must agree:

  - motion mode (motion_beam_size = 5, insertion off): the sampled motion
    tokens, coarsened to 32 vocabulary bins (chi-square), and the 4 x 4
    state transitions (chi-square);
  - forced insertion (insert_beam_size = 10): the insertion count per
    rollout (two-sample KS) and the per-column enter counts (chi-square).

Each is accepted at p > 1e-3. The thresholds are not vacuous: the port
with +2 on the biases of the first vocabulary bin of token_predict_head's
last Dense (its converted weights only, in this file) must be rejected
against the unperturbed JAX runs at p < 1e-6. All seeds are fixed, so the
tests are deterministic.
"""

import copy

import jax
import numpy as np
import pytest
import torch
from scipy import stats

from infgen_tpu.config import Config as JConfig
from infgen_tpu.data.features import build_model_inputs as j_build_inputs
from infgen_tpu.data.synthetic import make_synthetic_scenario as j_synthetic
from infgen_tpu.model.infgen import InfGenModel as JModel
from infgen_tpu.rollout.closed_loop import make_rollout_fn as j_rollout_fn
from infgen_tpu.tokenizers.attr_tokenizer import AttrTokenizer as JAttr
from infgen_tpu.tokenizers.motion_tokenizer import MotionTokenizer as JMotion
from infgen_tpu.tokenizers.vocab import load_map_vocab as j_map_vocab

from infgen_torch.config import ENTER_STATE, Config
from infgen_torch.convert import load_flax_params
from infgen_torch.data.features import build_model_inputs
from infgen_torch.data.scenario import stack_scenarios, to_device
from infgen_torch.data.synthetic import make_synthetic_scenario
from infgen_torch.model.infgen import InfGenModel
from infgen_torch.rollout.closed_loop import make_rollout_fn
from infgen_torch.tokenizers.attr_tokenizer import AttrTokenizer
from infgen_torch.tokenizers.motion_tokenizer import MotionTokenizer
from infgen_torch.tokenizers.vocab import load_map_vocab

from test_torch_layers import (  # noqa: F401 (one_torch_thread: autouse)
    random_flax_params, one_torch_thread)
from test_torch_rollout import CFG

N_SEEDS = 8              # rollouts per side: the power case needs few
N_TOKEN_BINS = 32
ACCEPT_P = 1e-3          # accept agreement when p > 1e-3
REJECT_P = 1e-6          # the perturbed port must fail this hard
H = 2                    # history columns (deterministic, left out)
# (name, config changes, force_insert, frames): the JAX file's two cases
MODES = {"motion": (dict(motion_beam_size=5, disable_insertion=True), False,
                    25),
         "insert": (dict(motion_beam_size=5, insert_beam_size=10,
                         max_agents=40), True, 20)}


# the statistics of tests/test_rollout_parity_sampled.py (:104-136), copied:
# that file imports the absent reference checkout

def _token_hist(tokens, states, vocab):
    """Pooled histogram of sampled token ids (valid cells only) coarsened to
    N_TOKEN_BINS bins."""
    tok = np.asarray(tokens).reshape(-1)
    ok = (tok >= 0) & (np.asarray(states).reshape(-1) != 0)
    b = (tok[ok] * N_TOKEN_BINS) // vocab
    return np.bincount(b, minlength=N_TOKEN_BINS).astype(np.float64)


def _transition_hist(states, n_states=4):
    s = np.asarray(states)
    a, b = s[..., :-1].reshape(-1), s[..., 1:].reshape(-1)
    return np.bincount((a * n_states + b).astype(np.int64),
                       minlength=n_states * n_states).astype(np.float64)


def _chi2_two_sample(h1, h2):
    """Two-sample chi-square over pooled bins (bins with combined expected
    count < 5 merged into one)."""
    keep = (h1 + h2) >= 5
    a = np.append(h1[keep], h1[~keep].sum())
    b = np.append(h2[keep], h2[~keep].sum())
    live = (a + b) > 0
    a, b = a[live], b[live]
    n1, n2 = a.sum(), b.sum()
    e1 = (a + b) * n1 / (n1 + n2)
    e2 = (a + b) * n2 / (n1 + n2)
    chi2 = ((a - e1) ** 2 / np.maximum(e1, 1e-9)).sum() + \
           ((b - e2) ** 2 / np.maximum(e2, 1e-9)).sum()
    dof = max(len(a) - 1, 1)
    return stats.chi2.sf(chi2, dof)


def _enter_profile(states):
    """Enter counts per rollout column (the first column left out)."""
    return (np.asarray(states) == ENTER_STATE)[..., 1:].sum((0, 1)) \
        .astype(np.float64)


def _port_model(cfg, attr, params):
    model = InfGenModel(cfg, attr.grid, attr.grid_size, attr.angle_size)
    load_flax_params(model, params)
    return model.eval()


def _perturbed(params, vocab):
    """+2 on the first vocabulary bin's biases of the motion token head."""
    bad = copy.deepcopy(params)
    head = bad["agent_decoder"]["token_predict_head"]["Dense_1"]
    bias = np.array(head["bias"])
    bias[: vocab // N_TOKEN_BINS] += 2.0
    head["bias"] = bias
    return bad


@pytest.fixture(scope="module")
def params():
    """One converted weight tree for both modes (their changes leave the
    parameter shapes as they are)."""
    return random_flax_params(JConfig(**CFG), seed=0)


@pytest.fixture(scope="module", params=list(MODES))
def runs(request, params):
    """N JAX rollouts (one jitted vmap over N keys) and N port rollouts
    (one batched rollout of N lanes) of one scenario, same weights and
    inputs, and the perturbed port's N rollouts."""
    mode = request.param
    over, force, frames = MODES[mode]
    base = dict(CFG, num_recurrent_steps_val=frames, **over)
    jcfg = JConfig(**base)
    jattr = JAttr(jcfg.grid_range, jcfg.grid_interval, jcfg.pl2seed_radius,
                  jcfg.angle_interval)
    jmt, jmv = JMotion(), j_map_vocab()
    jscen = j_synthetic(jcfg, seed=2, num_agents=10)
    key = jax.random.PRNGKey(0)
    jinputs = jax.jit(lambda s, k: j_build_inputs(jcfg, jmt, jattr, s, k))(
        jscen, key)
    pt_uniform = np.array(jax.random.uniform(
        jax.random.split(key)[0], (jcfg.max_map_tokens,)))
    jmodel = JModel(jcfg, jattr.grid, jattr.grid_size, jattr.angle_size)
    jfn = j_rollout_fn(jmodel, jcfg, jattr, jmt, jmv, jit=False,
                       force_insert=force)
    keys = jax.random.split(jax.random.PRNGKey(7), N_SEEDS)
    jout = jax.device_get(jax.jit(jax.vmap(
        jfn, in_axes=(None, None, None, 0)))(params, jscen, jinputs, keys))

    cfg = Config(**base)
    attr = AttrTokenizer(cfg.grid_range, cfg.grid_interval,
                         cfg.pl2seed_radius, cfg.angle_interval)
    mt, mv = MotionTokenizer(), load_map_vocab()
    scen = to_device(make_synthetic_scenario(cfg, seed=2, num_agents=10),
                     "cpu")
    inputs = build_model_inputs(cfg, mt, attr, scen,
                                pt_uniform=torch.as_tensor(pt_uniform))
    lanes = (stack_scenarios([scen] * N_SEEDS),
             stack_scenarios([inputs] * N_SEEDS))

    def port_runs(p):
        fn = make_rollout_fn(_port_model(cfg, attr, p), cfg, attr, mt, mv,
                             force_insert=force)
        gens = [torch.Generator().manual_seed(1000 + i)
                for i in range(N_SEEDS)]
        return {k: v.numpy() for k, v in fn(*lanes, gens).items()}

    vocab = cfg.token_size
    return dict(mode=mode, vocab=vocab, jax=jout, port=port_runs(params),
                bad=port_runs(_perturbed(params, vocab)))


def _tokens(out, vocab):
    return _token_hist(out["next_token_idx"][..., H:],
                       out["next_state_idx"][..., H:], vocab)


def test_sampled_tokens_and_transitions(runs):
    """Motion mode: token frequencies and state transitions; forced
    insertion: the same two, beside the insertion statistics below."""
    j, p = runs["jax"], runs["port"]
    assert j["next_token_idx"].shape == p["next_token_idx"].shape
    # the draws really differ between rollouts
    assert len({t.tobytes() for t in p["next_token_idx"]}) > 1
    p_tok = _chi2_two_sample(_tokens(p, runs["vocab"]),
                             _tokens(j, runs["vocab"]))
    p_tr = _chi2_two_sample(_transition_hist(p["next_state_idx"]),
                            _transition_hist(j["next_state_idx"]))
    assert p_tok > ACCEPT_P, f"token frequencies differ (p={p_tok:.2e})"
    assert p_tr > ACCEPT_P, f"state transitions differ (p={p_tr:.2e})"


def test_sampled_power(runs):
    """The perturbed port's tokens are rejected against JAX's, in both
    modes."""
    p = _chi2_two_sample(_tokens(runs["bad"], runs["vocab"]),
                         _tokens(runs["jax"], runs["vocab"]))
    assert p < REJECT_P, f"perturbed logits were NOT rejected (p={p:.2e})"


def test_sampled_insertions(runs):
    """Forced insertion: insertion counts (KS) and the enter-column profile
    (chi-square); motion mode inserts nothing on either side."""
    j, p = runs["jax"], runs["port"]
    cj = np.asarray(j["n_inserted"], np.float64)
    cp = np.asarray(p["n_inserted"], np.float64)
    if runs["mode"] == "motion":
        assert not cj.any() and not cp.any()
        return
    assert len(set(cp)) > 1 and len(set(cj)) > 1, "counts do not vary"
    _, p_ks = stats.ks_2samp(cp, cj)
    p_col = _chi2_two_sample(_enter_profile(p["next_state_idx"]),
                             _enter_profile(j["next_state_idx"]))
    assert p_ks > ACCEPT_P, (f"insertion counts differ (p={p_ks:.2e}; port "
                             f"mean {cp.mean():.2f}, jax {cj.mean():.2f})")
    assert p_col > ACCEPT_P, f"enter-column profiles differ (p={p_col:.2e})"
