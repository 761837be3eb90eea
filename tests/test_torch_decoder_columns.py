"""The agent decoder's full-node-set columns (`seed_column`,
`seed_column_cached`, `refine_column`) against the JAX package's, and the
rollout's forms against them, on the CPU.

Weights: random port weights and the same weights as a flax tree
(test_torch_serving._decoder_tree), inputs from a numpy seed, fp32.
- `seed_column` against the JAX package's, atol 1e-5 (summation order
  only); `seed_column_cached` after `seed_key_chain` against
  `seed_column` at atol 1e-6, as tests/test_model.py holds the JAX pair.
- `refine_column` against `refine_column_sub` at the inserted row (atol
  2e-5, rtol 1e-5, tests/test_model.py's), and against the JAX package's
  `refine_column` (atol 2e-5, rtol 1e-5), with `use_fused_block` off and
  on: the fused branch calls `fused_attention_block` at all A rows with
  keys per query (the JAX side's Pallas kernel in interpret mode, jitted;
  the port's plain twin).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infgen_tpu.config import Config as JConfig
from infgen_tpu.model.agent_decoder import AgentDecoder as JDecoder
from infgen_tpu.tokenizers.attr_tokenizer import AttrTokenizer as JAttr

from infgen_torch import cli
from infgen_torch.config import Config
from infgen_torch.ops import fused_block as FB

from test_torch_layers import one_torch_thread  # noqa: F401 (autouse)
from test_torch_serving import _decoder_tree

# tests/test_model.py's seed and refine column configs, as one
CFG = dict(max_agents=16, max_map_tokens=64, hidden_dim=32, num_heads=2,
           head_dim=16, num_freq_bands=8, num_agent_layers=2,
           num_seed_layers=2, num_map_layers=1, num_seed_feature=4,
           dropout=0.0, grid_range=60.0, grid_interval=3.0,
           pl2seed_radius=30.0, remat_attention=False)
A, P, D = 12, 40, 32
KA, KM, SLOT = 5, 7, 3
TOL = dict(atol=2e-5, rtol=1e-5)       # tests/test_model.py's refine limits


@pytest.fixture(scope="module")
def decoders():
    """{use_fused_block: (port decoder, JAX decoder)} on the same weights,
    and the flax tree."""
    out, tree = {}, None
    for fused in (False, True):
        jcfg = JConfig(**CFG, use_fused_block=fused)
        jattr = JAttr(jcfg.grid_range, jcfg.grid_interval,
                      jcfg.pl2seed_radius, jcfg.angle_interval)
        model = cli.build_model(Config(**CFG, use_fused_block=fused), jattr,
                                "cpu")
        dec = model.agent_decoder.eval()
        if tree is None:
            tree = _decoder_tree(dec, np.random.default_rng(29))
            state = dec.state_dict()
        else:
            dec.load_state_dict(state)
        out[fused] = (dec, JDecoder(jcfg, grid_xy=jattr.grid,
                                    grid_size=jattr.grid_size,
                                    angle_size=jattr.angle_size))
    return out, tree


def _seed_inputs(G):
    rng = np.random.default_rng(17)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return dict(agent_col=f(A, D), seed_vec=f(D),
                occ_vec=rng.uniform(size=G) < 0.1,
                pl_mask=rng.uniform(size=P) < 0.7, r_pl=f(P, D),
                a2sa_r_raw=f(A, 3), a2sa_mask=rng.uniform(size=A) < 0.8,
                x_pt=f(P, D))


_SEED_ARGS = ("seed_vec", "occ_vec", "pl_mask", "r_pl", "a2sa_r_raw",
              "a2sa_mask", "x_pt")


def test_seed_column_matches_jax(decoders):
    (dec, jdec), tree = decoders[0][False], decoders[1]
    x = _seed_inputs(dec.grid_size)
    args = [x["agent_col"]] + [x[k] for k in _SEED_ARGS]
    want = jax.jit(lambda p, *a: jdec.apply(
        {"params": p}, *a, method=JDecoder.seed_column))(
        tree, *[jnp.asarray(a) for a in args])
    with torch.no_grad():
        got = dec.seed_column(*[torch.as_tensor(a) for a in args])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_seed_column_cached_matches_seed_column(decoders):
    """seed_key_chain + seed_column_cached == seed_column (the rollout
    caches the agent rows' zero-aggregate key snapshots per step)."""
    dec, _ = decoders[0][False]
    x = {k: torch.as_tensor(v) for k, v in _seed_inputs(
        dec.grid_size).items()}
    rest = [x[k] for k in _SEED_ARGS]
    with torch.no_grad():
        full = dec.seed_column(x["agent_col"], *rest)
        cached = dec.seed_column_cached(dec.seed_key_chain(x["agent_col"]),
                                        *rest)
    np.testing.assert_allclose(cached.numpy(), full.numpy(), atol=1e-6,
                               rtol=1e-6)


def _refine_inputs():
    """tests/test_model.py's refine case: the full node set's per-query
    tables, every row but SLOT masked out; and the subgraph's."""
    rng = np.random.default_rng(21)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    x_col, x_pt = f(A, D), f(P, D)
    idx_a = rng.choice([i for i in range(A) if i != SLOT], KA,
                       replace=False).astype(np.int64)
    val_a = rng.uniform(size=KA) < 0.8
    r_aa = f(KA, 3)
    idx_p = rng.integers(0, P, KM)
    val_p = rng.uniform(size=KM) < 0.8
    r_pp = f(KM, 3)

    def full(row, fill, dtype):
        out = np.full((A, *np.shape(row)), fill, dtype)
        out[SLOT] = row
        return out

    full_args = dict(
        x_col=x_col, query_onehot=np.arange(A) == SLOT,
        pl_keys=full(idx_p, 0, np.int64), pl_r_raw=full(r_pp, 0, np.float32),
        pl_mask=full(val_p, False, bool), a2a_idx=full(idx_a, 0, np.int64),
        a2a_r_raw=full(r_aa, 0, np.float32),
        a2a_mask=full(val_a, False, bool), x_pt=x_pt)
    sub_args = dict(x_sub=np.concatenate([x_col[SLOT][None], x_col[idx_a]]),
                    pl_keys=x_pt[idx_p], pl_r_raw=r_pp, pl_mask=val_p,
                    a2a_r_raw=r_aa, a2a_mask=val_a)
    return full_args, sub_args


@pytest.mark.parametrize("fused", [False, True], ids=["modules", "fused"])
def test_refine_column_matches_sub(decoders, fused):
    """refine_column_sub (the rollout's: the inserted row and its
    neighbours only) == refine_column at the inserted row."""
    dec, _ = decoders[0][fused]
    full_args, sub_args = _refine_inputs()
    t = lambda d: {k: torch.as_tensor(v) for k, v in d.items()}
    before = FB.fused_attention_block.launches
    with torch.no_grad():
        full = dec.refine_column(**t(full_args))
        sub = dec.refine_column_sub(**t(sub_args))
    assert full.shape == (A, D)
    np.testing.assert_allclose(sub.numpy(), full[SLOT].numpy(), **TOL)
    assert FB.fused_attention_block.launches == before


@pytest.mark.parametrize("fused", [False, True], ids=["modules", "fused"])
def test_refine_column_matches_jax(decoders, fused):
    """The port's refine_column against the JAX package's (its fused
    branch: the Pallas fused block in interpret mode) on every row."""
    (dec, jdec), tree = decoders[0][fused], decoders[1]
    full_args, _ = _refine_inputs()
    jargs = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64
                            else v) for k, v in full_args.items()}
    want = jax.jit(lambda p, a: jdec.apply(
        {"params": p}, **a, method=JDecoder.refine_column))(tree, jargs)
    with torch.no_grad():
        got = dec.refine_column(**{k: torch.as_tensor(v)
                                   for k, v in full_args.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
