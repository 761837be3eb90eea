"""The PyTorch port's layers, neighbour selection, map encoder and weight
converter, held against the JAX package's on the CPU at fp32.

Weights: the flax params tree's structure comes from `jax.eval_shape` of
the JAX model's init (no init is run), its leaves are drawn from a numpy
seed with non-zero biases and LayerNorm offsets, and the port takes them
through `convert.load_flax_params`. Tolerance 1e-5 absolute: both sides
compute in fp32 and differ only in summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infgen_tpu.config import Config as JConfig
from infgen_tpu.data.features import build_model_inputs as j_build_inputs
from infgen_tpu.data.synthetic import make_synthetic_scenario as j_synthetic
from infgen_tpu.model.infgen import InfGenModel as JModel
from infgen_tpu.model.layers import DenseAttention as JDenseAttention
from infgen_tpu.model.layers import FourierEmbedding as JFourier
from infgen_tpu.model.layers import MLPEmbedding as JMLPEmbedding
from infgen_tpu.model.map_encoder import MapEncoder as JMapEncoder
from infgen_tpu.ops import neighbors as JN
from infgen_tpu.tokenizers.attr_tokenizer import AttrTokenizer as JAttr
from infgen_tpu.tokenizers.motion_tokenizer import MotionTokenizer as JMotion
from infgen_tpu.tokenizers.vocab import load_map_vocab as j_map_vocab

from infgen_torch.config import Config
from infgen_torch.convert import (flatten_tree, load_flax_params, load_npz,
                                  save_npz, torch_name)
from infgen_torch.data.scenario import to_device
from infgen_torch.model.infgen import InfGenModel
from infgen_torch.model.layers import Dense, sigmoid
from infgen_torch.ops import neighbors as N
from infgen_torch.tokenizers.attr_tokenizer import AttrTokenizer

ATOL = 1e-5
SMALL = dict(max_agents=16, max_map_tokens=64, num_agent_layers=2,
             num_seed_layers=2, num_map_layers=2, hidden_dim=32, num_heads=2,
             head_dim=16, num_freq_bands=8)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for each port test module: its ops are small, and
    the suite's parallel workers otherwise keep each other's threads
    spinning (on an 8-core CPU the port's files took 4.9 minutes of wall
    and 37 of CPU on 4 workers with torch's default threads, 0.9 and 3
    with one). Other modules in the worker get the count back."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_flax_params(jcfg, seed: int = 0) -> dict:
    """A complete flax params tree of the JAX InfGenModel for `jcfg`, its
    structure from jax.eval_shape (no init runs), its leaves from a numpy
    seed: kernels ~ N(0, 1/fan_in), biases ~ N(0, 0.1^2), LayerNorm scales
    ~ 1 + N(0, 0.1^2), embeddings ~ N(0, 0.3^2), Fourier frequencies
    ~ N(0, 0.2^2)."""
    attr = JAttr(jcfg.grid_range, jcfg.grid_interval, jcfg.pl2seed_radius,
                 jcfg.angle_interval)
    mt, mv = JMotion(), j_map_vocab()
    scen = jax.tree.map(jnp.asarray, j_synthetic(jcfg, seed=0, num_agents=8))
    key = jax.random.PRNGKey(0)
    inputs = jax.eval_shape(
        lambda s: j_build_inputs(jcfg, mt, attr, s, key), scen)
    model = JModel(jcfg, attr.grid, attr.grid_size, attr.angle_size)
    shapes = jax.eval_shape(lambda i: model.init(
        {"params": key, "dropout": key}, i, scen.map, mt.vocab,
        mv["traj_src"], key, deterministic=True), inputs)["params"]
    return fill_tree(shapes, np.random.default_rng(seed))


def fill_tree(shapes, rng) -> dict:
    """numpy leaves for a flax params structure, in traversal order:
    kernels ~ N(0, 1/fan_in), biases ~ N(0, 0.1^2), LayerNorm scales
    ~ 1 + N(0, 0.1^2), embeddings ~ N(0, 0.3^2), Fourier frequencies
    ~ N(0, 0.2^2)."""
    def fill(path, s):
        leaf = path[-1].key
        if leaf in ("kernel", "w_kr", "w_vr"):
            return rng.normal(0, s.shape[0] ** -0.5, s.shape)
        if leaf == "scale":
            return 1.0 + rng.normal(0, 0.1, s.shape)
        if leaf == "embedding":
            return rng.normal(0, 0.3, s.shape)
        if leaf == "freqs":
            return rng.normal(0, 0.2, s.shape)
        return rng.normal(0, 0.1, s.shape)            # bias, b_vr

    filled = jax.tree_util.tree_map_with_path(
        lambda p, s: fill(p, s).astype(np.float32), shapes)
    return jax.tree.map(np.asarray, filled)


def torch_model(cfg, tree) -> InfGenModel:
    attr = AttrTokenizer(cfg.grid_range, cfg.grid_interval,
                         cfg.pl2seed_radius, cfg.angle_interval)
    model = InfGenModel(cfg, attr.grid, attr.grid_size, attr.angle_size)
    load_flax_params(model, tree)
    return model.eval()


@pytest.fixture(scope="module")
def small():
    jcfg = JConfig(**SMALL)
    tree = random_flax_params(jcfg, seed=3)
    return jcfg, tree, torch_model(Config(**SMALL), tree)


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize("heads", ["grid_and_heading_tokens", "xy_and_theta"])
def test_converter_maps_every_leaf(small, heads):
    """Every flax leaf has a torch target and every torch parameter is
    written with that leaf's value (Dense kernels transposed), under both
    head layouts the config selects (`use_grid_token`, `use_head_token`)."""
    if heads == "grid_and_heading_tokens":
        _, tree, model = small
    else:
        cfg = dict(SMALL, use_grid_token=False, use_head_token=False,
                   num_agent_layers=1, num_seed_layers=1, num_map_layers=1)
        tree = random_flax_params(JConfig(**cfg), seed=8)
        model = torch_model(Config(**cfg), tree)
    params = dict(model.named_parameters())
    flat = flatten_tree(tree)
    assert {torch_name(p) for p in flat} == set(params)
    for path, arr in flat.items():
        got = params[torch_name(path)].detach().numpy()
        np.testing.assert_array_equal(got.T if path[-1] == "kernel" else got,
                                      arr, err_msg="/".join(path))


def test_npz_round_trip(small, tmp_path):
    _, tree, _ = small
    path = str(tmp_path / "params.npz")
    save_npz(tree, path)
    back = flatten_tree(load_npz(path))
    ref = flatten_tree(tree)
    assert set(back) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(back[k], ref[k])


# (layer name, bipartite, has_pos_emb, r layout, keys given)
ATTN_CASES = {
    "self_r_per_pair": ("t_attn_0", False, True, "pair", False),
    "bipartite_r_per_pair": ("pt2a_1", True, True, "pair", True),
    "src_r_shared": ("a2sa_0", False, True, "shared", True),
    "no_pos_emb": ("occ2sa_1", True, False, None, True),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_dense_attention(small, case):
    """DenseAttention with r, a mask and all-masked query rows."""
    jcfg, tree, model = small
    name, bip, pos, r_kind, keyed = ATTN_CASES[case]
    D, Q, K = jcfg.hidden_dim, 6, 9
    rng = np.random.default_rng(11)
    x_dst = rng.normal(size=(3, Q, D)).astype(np.float32)
    x_src = rng.normal(size=(3, K, D)).astype(np.float32) if keyed else None
    Kk = K if keyed else Q
    r = None
    if r_kind == "pair":
        r = rng.normal(size=(3, Q, Kk, D)).astype(np.float32)
    elif r_kind == "shared":
        r = rng.normal(size=(3, Kk, D)).astype(np.float32)
    mask = rng.uniform(size=(3, Q, Kk)) < 0.6
    mask[:, 0] = False                        # all-masked query rows
    p = tree["agent_decoder"][name]
    jmod = JDenseAttention(D, jcfg.num_heads, jcfg.head_dim, 0.0,
                           bipartite=bip, has_pos_emb=pos)
    ref = jax.jit(lambda p_: jmod.apply({"params": p_}, x_dst, x_src, r,
                                        mask, True))(p)
    layer = getattr(model.agent_decoder, name)
    with torch.no_grad():
        out = layer(_t(x_dst), None if x_src is None else _t(x_src),
                    None if r is None else _t(r), _t(mask))
        zero = layer.zero_agg(_t(x_dst[:, 0]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)
    # the closed form for a row without edges equals the module's output
    # for an all-masked row
    np.testing.assert_allclose(zero.numpy(), np.asarray(ref)[:, 0],
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("with_cats", [False, True])
def test_fourier_embedding(small, with_cats):
    jcfg, tree, model = small
    D = jcfg.hidden_dim
    rng = np.random.default_rng(5)
    x = rng.normal(size=(7, 2)).astype(np.float32) * 3
    cats = [rng.normal(size=(7, D)).astype(np.float32) for _ in range(2)]
    p = tree["agent_decoder"]["x_a_emb"]
    jmod = JFourier(2, D, jcfg.num_freq_bands)
    ref = jmod.apply({"params": p}, x, cats if with_cats else None)
    with torch.no_grad():
        out = model.agent_decoder.x_a_emb(
            _t(x), [_t(c) for c in cats] if with_cats else None)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


def test_mlp_embedding(small):
    jcfg, tree, model = small
    rng = np.random.default_rng(6)
    x = rng.normal(size=(9, 3)).astype(np.float32)
    ref = JMLPEmbedding(jcfg.hidden_dim).apply(
        {"params": tree["agent_decoder"]["shape_emb"]}, x)
    with torch.no_grad():
        out = model.agent_decoder.shape_emb(_t(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("op", ["dense", "sigmoid"])
def test_bf16_rounding_matches_flax(op):
    """Under the bf16 compute policy a Dense rounds x @ W to bf16 before it
    adds the bias, and a sigmoid rounds each of exp, 1 + e and 1 / (.), as
    flax and XLA do op by op: bitwise equal (a fused bias or torch.sigmoid
    rounds once, and about a quarter of the values then differ in the last
    bit)."""
    import flax.linen as nn

    rng = np.random.default_rng(12)
    x = (rng.normal(size=(64, 32)) * 3).astype(np.float32)
    if op == "dense":
        kernel = rng.normal(0, 32 ** -0.5, (32, 48)).astype(np.float32)
        bias = rng.normal(0, 0.1, 48).astype(np.float32)
        ref = nn.Dense(48, dtype=jnp.bfloat16).apply(
            {"params": {"kernel": kernel, "bias": bias}}, x)
        mod = Dense(32, 48, dtype=torch.bfloat16)
        load_flax_params(mod, {"kernel": kernel, "bias": bias})
        with torch.no_grad():
            got = mod(_t(x))
    else:
        ref = jax.nn.sigmoid(jnp.asarray(x, jnp.bfloat16))
        got = sigmoid(_t(x).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


def test_map_encoder(small):
    jcfg, tree, model = small
    scen = j_synthetic(jcfg, seed=4, num_agents=6)
    traj = j_map_vocab()["traj_src"]
    ref = jax.jit(lambda p, m: JMapEncoder(jcfg).apply(
        {"params": p}, m, traj)["x_pt"])(tree["map_encoder"],
                                         jax.tree.map(jnp.asarray, scen.map))
    with torch.no_grad():
        out = model.encode_map(to_device(scen.map, "cpu"), _t(traj))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_neighbors(masked):
    """topk_neighbors and pairwise_radius_mask against the JAX package's on
    integer points, where equal distances are common: torch.topk promises no
    order among ties, the port keeps lax.top_k's (lower index first)."""
    rng = np.random.default_rng(9)
    q = rng.integers(0, 5, size=(2, 6, 2)).astype(np.float32)
    kw = dict(query_mask=rng.uniform(size=(2, 6)) < 0.8,
              key_mask=rng.uniform(size=(2, 6)) < 0.6,
              exclude_self=True) if masked else {}
    j_idx, j_ok = JN.topk_neighbors(q, q, 4, 2.5, **kw)
    j_mask = JN.pairwise_radius_mask(q, q, 2.5, **kw)
    tkw = {k: _t(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    idx, ok = N.topk_neighbors(_t(q), _t(q), 4, 2.5, **tkw)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(j_ok))
    np.testing.assert_array_equal(
        N.pairwise_radius_mask(_t(q), _t(q), 2.5, **tkw).numpy(),
        np.asarray(j_mask))
