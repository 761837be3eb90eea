"""The port's fused DenseAttention block (`ops/fused_block.py`: the pack of
one DenseAttention module and the plain `fused_attention_block_reference`,
which the CUDA kernel is held against on the card) against the JAX
package's Pallas `fused_attention_block` in interpret mode, on the CPU, and
the port's `AgentDecoder.motion_column` with `use_fused_block` against the
JAX package's.

Cases of tests/test_fused_block.py (square self-attention, shared keys,
keys gathered per query, bipartite gathered keys, one query; a fully masked
query row among them) at D=32, two heads of 16. Weights: a DenseAttention's
flax subtree from a numpy seed (test_torch_column_kernel.attention_tree),
taken by the port through `convert.load_flax_params`. Both sides compute in
fp32 and differ only in summation order: atol 2e-5. With bf16 inputs both
compute in fp32 from the same values and round only the output to bf16,
where a last-bit difference may round to the neighbouring bf16 value: one
bf16 step (rtol 2^-7) on outputs of order 1-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infgen_tpu.config import Config as JConfig
from infgen_tpu.model.agent_decoder import AgentDecoder as JAgentDecoder
from infgen_tpu.ops.fused_block import fused_attention_block as j_fused

from infgen_torch.config import Config
from infgen_torch.convert import load_flax_params
from infgen_torch.model.agent_decoder import AgentDecoder
from infgen_torch.model.layers import DenseAttention
from infgen_torch.ops import fused_block as FB

from test_torch_column_kernel import D, H, Hd, attention_tree
from test_torch_layers import fill_tree, one_torch_thread  # noqa: F401

ATOL = 2e-5
CASES = {"square": (37, 37), "shared_keys": (37, 53), "per_query": (37, 12),
         "bipartite_gathered": (37, 5), "q1": (1, 24)}


def _case(case, dtype=np.float32):
    """(flax subtree, port module, x, x_src, r, mask) of one case."""
    rng = np.random.default_rng(sorted(CASES).index(case) + 11)
    Q, K = CASES[case]
    bipartite = case == "bipartite_gathered"
    tree = attention_tree(rng, bipartite)
    mod = DenseAttention(D, H, Hd, bipartite=bipartite)
    load_flax_params(mod, tree)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    x, r = f(Q, D), f(Q, K, D)
    mask = rng.uniform(size=(Q, K)) < 0.5
    if Q > 3:
        mask[3] = False                     # a fully masked query row
    if case == "square":
        src = None
    elif case in ("per_query", "bipartite_gathered"):
        src = f(Q, K, D)
    else:
        src = f(K, D)
    return tree, mod.eval(), x, src, r, mask, bipartite


def _jax(tree, x, src, r, mask, bipartite, dt):
    cast = lambda a: None if a is None else jnp.asarray(a).astype(dt)
    fn = jax.jit(lambda p, x_, s_, r_, m_: j_fused(
        p, x_, s_, r_, m_, H, bipartite=bipartite, interpret=True))
    return np.asarray(fn(tree, cast(x), cast(src), cast(r),
                         jnp.asarray(mask)).astype(jnp.float32))


def _port(mod, x, src, r, mask, dt):
    t = lambda a: None if a is None else torch.as_tensor(a).to(dt)
    out = FB.fused_attention_block(FB.pack_fused_block(mod), t(x), t(src),
                                   t(r), torch.as_tensor(mask), H)
    assert out.dtype == dt
    return out.float().numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_block_matches_jax(case):
    tree, mod, x, src, r, mask, bip = _case(case)
    before = FB.fused_attention_block.launches
    got = _port(mod, x, src, r, mask, torch.float32)
    assert FB.fused_attention_block.launches == before   # CPU: plain twin
    ref = _jax(tree, x, src, r, mask, bip, jnp.float32)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    if mask.shape[0] > 3:
        # the fully masked row took the zero-aggregate path, not NaN
        assert np.isfinite(got[3]).all()


def test_fused_block_bf16_matches_jax():
    """bf16 inputs and output (the rollout's compute dtype)."""
    tree, mod, x, src, r, mask, bip = _case("per_query")
    got = _port(mod, x, src, r, mask, torch.bfloat16)
    ref = _jax(tree, x, src, r, mask, bip, jnp.bfloat16)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=2 ** -7)


def test_fused_block_refuses_more_than_128_keys():
    _, mod, *_ = _case("square")
    x = torch.zeros(4, D)
    with pytest.raises(ValueError):
        FB.fused_attention_block(FB.pack_fused_block(mod), x,
                                 torch.zeros(129, D), torch.zeros(4, 129, D),
                                 torch.ones(4, 129, dtype=torch.bool), H)


def test_motion_column_fused_matches_jax():
    """The trunk column through 3L fused blocks (use_fused_block), the
    relation embeddings included, against the JAX package's at fp32."""
    kw = dict(max_agents=16, max_map_tokens=32, hidden_dim=D, num_heads=H,
              head_dim=Hd, num_freq_bands=8, num_agent_layers=2,
              num_seed_layers=1, num_map_layers=1, time_span=12,
              compute_dtype="float32", use_fused_block=True)
    jcfg = JConfig(**kw, dropout=0.0, remat_attention=False)
    A, L, W, K = 16, 2, 12, jcfg.pl2a_num_neighbors
    grid = np.zeros((4, 2), np.float32)
    jdec = JAgentDecoder(jcfg, grid_xy=grid, grid_size=4, angle_size=4)
    rng = np.random.default_rng(41)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    args = dict(x_c=f(A, D), key_stack=f(L, A, W, D), t_r_raw=f(A, W, 4),
                t_mask=rng.uniform(size=(A, W)) < 0.7, a2a_r_raw=f(A, A, 3),
                a2a_mask=rng.uniform(size=(A, A)) < 0.4,
                pl_keys=f(A, K, D), pl_r_raw=f(A, K, 3),
                pl_mask=rng.uniform(size=(A, K)) < 0.8)
    args["t_mask"][3] = False
    args["a2a_mask"][7] = False
    shapes = jax.eval_shape(lambda: jdec.init(
        jax.random.PRNGKey(0), *args.values(),
        method=JAgentDecoder.motion_column))["params"]
    tree = fill_tree(shapes, rng)
    jcols, jout = jax.jit(lambda p, *a: jdec.apply(
        {"params": p}, *a, method=JAgentDecoder.motion_column))(
        tree, *args.values())

    dec = AgentDecoder(Config(**kw), grid, 4, 4)
    for name, sub in tree.items():
        load_flax_params(getattr(dec, name), sub)
    dec.eval()
    with torch.no_grad():
        cols, out = dec.motion_column(*(torch.as_tensor(a)
                                        for a in args.values()))
    np.testing.assert_allclose(cols.numpy(), np.asarray(jcols), atol=ATOL,
                               rtol=0)
    np.testing.assert_array_equal(out.numpy(), cols[-1].numpy())
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL,
                               rtol=0)
