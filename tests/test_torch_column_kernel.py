"""The port's trunk column (`ops/column_kernel.py`: `pack_column_params` +
the plain `motion_column_reference`, which the CUDA kernel is held against
on the card) against the JAX package's Pallas `motion_column_kernel` run in
interpret mode, on the CPU.

Shapes as tests/test_column_kernel.py (A=16, D=32, two heads of 16, three
layers, W=12 temporal keys, K=5 map keys). Weights: each DenseAttention's
flax subtree (structure from jax.eval_shape of the layer's init, leaves from
a numpy seed by test_torch_layers.fill_tree), taken by the port through
`convert.load_flax_params`.
Relation embeddings are inputs of the kernel and come from the numpy seed
too. fp32: atol 2e-5, the JAX kernel tests' own. bf16: both sides round the
same matmul operands to bf16 and sum in fp32, but a last-bit difference in
an fp32 sum can round an operand to the neighbouring bf16 value (a relative
step of 2^-8), and that propagates through the 3L = 9 sublayers: atol 3e-2
on outputs of order 1-10, as for the seed kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from infgen_tpu.model.layers import DenseAttention as JDenseAttention
from infgen_tpu.ops import column_kernel as JCK

from infgen_torch.convert import load_flax_params
from infgen_torch.model.layers import DenseAttention, MLPLayer
from infgen_torch.ops import column_kernel as CK

from test_torch_layers import fill_tree, one_torch_thread  # noqa: F401

A, D, H, Hd, L, W, K = 16, 32, 2, 16, 3, 12, 5
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
_KINDS = (("t_attn", False), ("pt2a", True), ("a2a", False))

_JAX_COLUMNS = {}        # compute dtype -> jitted JAX column


def attention_tree(rng, bipartite, has_pos_emb=True):
    """A random flax params subtree of one DenseAttention layer."""
    jmod = JDenseAttention(D, H, Hd, 0.0, bipartite=bipartite,
                           has_pos_emb=has_pos_emb)
    x = jnp.zeros((1, 1, D))
    src = jnp.zeros((1, 2, D))
    r = jnp.zeros((1, 1, 2, D)) if has_pos_emb else None
    shapes = jax.eval_shape(lambda: jmod.init(
        jax.random.PRNGKey(0), x, src, r, jnp.ones((1, 1, 2), bool),
        True))["params"]
    return fill_tree(shapes, rng)


def mlp_tree(rng, d_in, d_out):
    """A random flax params subtree of one MLPLayer."""
    f = lambda *s: rng.normal(0, 0.1, s).astype(np.float32)
    return {"Dense_0": {"kernel": rng.normal(0, d_in ** -0.5, (d_in, D))
                        .astype(np.float32), "bias": f(D)},
            "LayerNorm_0": {"scale": 1.0 + f(D), "bias": f(D)},
            "Dense_1": {"kernel": rng.normal(0, D ** -0.5, (D, d_out))
                        .astype(np.float32), "bias": f(d_out)}}


class Layers(nn.Module):
    """The named layers of an AgentDecoder that a pack reads, filled from
    their flax subtrees. specs: name -> ("attn", bipartite, has_pos_emb)
    or ("mlp", d_in, d_out)."""

    def __init__(self, tree, specs):
        super().__init__()
        for name, spec in specs.items():
            if spec[0] == "attn":
                mod = DenseAttention(D, H, Hd, bipartite=spec[1],
                                     has_pos_emb=spec[2])
            else:
                mod = MLPLayer(spec[1], D, spec[2])
            load_flax_params(mod, tree[name])
            setattr(self, name, mod)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(31)
    specs = {f"{name}_{i}": ("attn", bip, True)
             for i in range(L) for name, bip in _KINDS}
    tree = {name: attention_tree(rng, s[1]) for name, s in specs.items()}
    return tree, Layers(tree, specs).eval()


def _inputs(seed, n_act=A):
    """Relation embeddings, keys and masks; rows >= n_act are inactive
    slots with every key masked. Row 3 has no temporal and no map key and
    row 7 no agent key (fully masked queries)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    act = np.arange(A) < n_act
    x = dict(x0=f(A, D), key_stack=f(L, A, W, D), r_t=f(A, W, D),
             t_mask=(rng.uniform(size=(A, W)) < 0.7) & act[:, None],
             pl_keys=f(A, K, D), r_pl=f(A, K, D),
             pl_mask=(rng.uniform(size=(A, K)) < 0.8) & act[:, None],
             r_aa=f(A, A, D),
             aa_mask=((rng.uniform(size=(A, A)) < 0.4) & act[:, None]
                      & act[None] & ~np.eye(A, dtype=bool)))
    x["t_mask"][3] = False
    x["pl_mask"][3] = False
    x["aa_mask"][7] = False
    return x


_ARGS = ("x0", "key_stack", "r_t", "t_mask", "pl_keys", "r_pl", "pl_mask",
         "r_aa", "aa_mask")


def _jax_column(tree, x, dt, n_rows=None):
    """The Pallas kernel in interpret mode, jitted once per dtype."""
    if dt not in _JAX_COLUMNS:
        def run(p_, x_, nr):
            packed = JCK.pack_column_params(p_, L, dt)
            return JCK.motion_column_kernel(
                packed, *[x_[k] for k in _ARGS], H, Hd, compute_dtype=dt,
                chunk=4, interpret=True, n_rows=nr)
        _JAX_COLUMNS[dt] = jax.jit(run)
    nr = jnp.int32(A if n_rows is None else n_rows)
    return np.asarray(_JAX_COLUMNS[dt](tree, x, nr))


def _torch_column(layers, x, dt, n_rows=None, fn=CK.motion_column_reference):
    pack = CK.pack_column_params(layers, L, dt)
    cdt = pack.dtype
    t = lambda k: torch.as_tensor(x[k])
    args = [t("x0")] + [t(k).to(cdt) if x[k].dtype != bool else t(k)
                        for k in _ARGS[1:]]
    nr = None if n_rows is None else torch.tensor(n_rows, dtype=torch.int32)
    with torch.no_grad():
        return fn(pack, *args, H, Hd, n_rows=nr)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_column_matches_jax_kernel(setup, dtype):
    tree, layers = setup
    x = _inputs(5)
    jdt = None if dtype == "float32" else jnp.bfloat16
    tdt = None if dtype == "float32" else torch.bfloat16
    ref = _jax_column(tree, x, jdt)
    out = _torch_column(layers, x, tdt)
    assert out.dtype == torch.float32 and out.shape == (L, A, D)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("n_act", [0, 4, 11, 16])
def test_column_occupancy_skip_is_bitwise(setup, n_act):
    """n_rows is a pure skip: with every key of rows >= n_rows masked, the
    outputs equal the full computation's bit for bit (the JAX package's
    test_column_kernel_occupancy_skip); and the JAX kernel with the same
    bound agrees."""
    tree, layers = setup
    x = _inputs(7 + n_act, n_act)
    full = _torch_column(layers, x, None)
    skip = _torch_column(layers, x, None, n_rows=n_act)
    assert torch.equal(full, skip)
    if n_act == 11:
        np.testing.assert_allclose(skip.numpy(),
                                   _jax_column(tree, x, None, n_act),
                                   atol=TOL["float32"], rtol=0)


def test_wrapper_takes_plain_version_on_cpu(setup):
    """On CPU tensors the wrapper computes the plain version and launches
    (and counts) nothing."""
    _, layers = setup
    x = _inputs(5)
    before = CK.motion_column_kernel.launches
    out = _torch_column(layers, x, None, n_rows=9,
                        fn=CK.motion_column_kernel)
    assert torch.equal(out, _torch_column(layers, x, None, n_rows=9))
    assert CK.motion_column_kernel.launches == before


def test_wrapper_rejects_other_devices(setup):
    _, layers = setup
    pack = CK.pack_column_params(layers, L)
    meta = lambda *s, dtype=torch.float32: torch.empty(s, dtype=dtype,
                                                       device="meta")
    b = torch.bool
    with pytest.raises(ValueError):
        CK.motion_column_kernel(
            pack, meta(A, D), meta(L, A, W, D), meta(A, W, D),
            meta(A, W, dtype=b), meta(A, K, D), meta(A, K, D),
            meta(A, K, dtype=b), meta(A, A, D), meta(A, A, dtype=b), H, Hd)
