"""The port's seed evaluation (`ops/seed_kernel.py`: `pack_seed_params` +
the plain `seed_eval_reference`, which the CUDA kernel is held against on
the card) against the JAX package's Pallas `seed_eval_kernel` run in
interpret mode, on the CPU; and its full variant (`pack_seed_params_full` +
`seed_eval_full_reference`, the per-step precompute folded in) against the
Pallas `seed_eval_full_kernel`, from the same raw inputs.

Shapes as tests/test_model.py's seed-kernel test (A=12, P=32, D=32, two
heads of 16), with two seed layers instead of three: each interpret-mode
compile of the JAX kernels shrinks with the stack. fp32: atol 1e-5
(summation order only).
bf16: both sides round the same matmul operands to bf16 and accumulate in
fp32, but a last-bit difference in an fp32 sum can round an operand to the
neighbouring bf16 value (a relative step of 2^-8) and that propagates
through the six sublayers: atol 3e-2 on outputs of order 1-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infgen_tpu.config import Config as JConfig
from infgen_tpu.model.agent_decoder import AgentDecoder as JDecoder
from infgen_tpu.ops import seed_fast as JSF
from infgen_tpu.ops import seed_kernel as JSK
from infgen_tpu.tokenizers.attr_tokenizer import AttrTokenizer as JAttr

from infgen_torch.config import Config
from infgen_torch.ops import seed_fast as SF
from infgen_torch.ops import seed_kernel as SK

from test_torch_layers import (  # noqa: F401 (one_torch_thread: autouse)
    random_flax_params, torch_model, one_torch_thread)

CFG = dict(max_agents=12, max_map_tokens=32, hidden_dim=32, num_heads=2,
           head_dim=16, num_freq_bands=8, num_agent_layers=2,
           num_seed_layers=2, num_map_layers=1, dropout=0.0, grid_range=60.0,
           grid_interval=3.0, pl2seed_radius=30.0, remat_attention=False)
A, P, D, H, Hd, L = 12, 32, 32, 2, 16, 2
TOL = {"float32": 1e-5, "bfloat16": 3e-2}

_JAX_EVALS = {}          # compute dtype -> jitted JAX evaluation
_JAX_FULL_EVALS = {}     # compute dtype -> jitted JAX full evaluation


@pytest.fixture(scope="module")
def setup():
    jcfg = JConfig(**CFG)
    tree = random_flax_params(jcfg, seed=29)
    jattr = JAttr(jcfg.grid_range, jcfg.grid_interval, jcfg.pl2seed_radius,
                  jcfg.angle_interval)
    jdec = JDecoder(jcfg, grid_xy=jattr.grid, grid_size=jattr.grid_size,
                    angle_size=jattr.angle_size)
    model = torch_model(Config(**CFG), tree)
    return jcfg, tree["agent_decoder"], jdec, jattr.grid_size, model


def _inputs(G, all_masked: bool, map_masked: bool = False):
    rng = np.random.default_rng(29)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    x = dict(agent_col=f(A, D), seed_vec=f(D),
             occ_vec=rng.uniform(size=G) < 0.1,
             pl_mask=rng.uniform(size=P) < 0.7, pl_r_raw=f(P, 3),
             a2sa_r_raw=f(A, 3), a2sa_mask=rng.uniform(size=A) < 0.8,
             x_pt=f(P, D))
    if all_masked:
        x["a2sa_mask"][:] = False
    if map_masked:
        x["pl_mask"][:] = False
    return x


def _jax_eval(jdec, p, G, x, dt):
    """The JAX package's seed evaluation: per-step precompute in seed_fast,
    then the Pallas kernel in interpret mode. Compiled once per dtype and
    shared by the mask cases (interpreting it eagerly costs several times
    more)."""
    if dt not in _JAX_EVALS:
        _JAX_EVALS[dt] = jax.jit(lambda p_, x_: _jax_eval_body(jdec, p_, G,
                                                               x_, dt))
    small, pos = _JAX_EVALS[dt](p, x)
    small, pos = np.asarray(small), np.asarray(pos)
    return np.concatenate([small[0, :2], small[1, :3], small[2, :3],
                           pos[0, :G]])


def _jax_eval_body(jdec, p, G, x, dt):
    def prep(mdl):
        return (mdl.embed_pl2sa_r(x["pl_r_raw"]),
                mdl.embed_a2sa_r(x["a2sa_r_raw"]),
                mdl.embed_occ(jnp.asarray(x["occ_vec"])),
                mdl.seed_key_chain(x["agent_col"]))
    r_pl, r_sa, occ_emb, chain = jdec.apply({"params": p}, method=prep)
    K_pt, V_pt, K_a, V_a, v_occ = [], [], [], [], []
    for i in range(L):
        p_pt, p_a = p[f"pt2sa_{i}"], p[f"a2sa_{i}"]
        v_occ.append(JSF.occ_value(p[f"occ2sa_{i}"], occ_emb, dt))
        k0, v0 = JSF.precompute_src_kv(p_pt, x["x_pt"], dt)
        kr, vr = JSF.r_contrib(p_pt, r_pl, dt)
        K_pt.append(k0 + kr)
        V_pt.append(v0 + vr)
        ka, va = JSF.precompute_src_kv(p_a, chain[i], dt)
        kar, var_ = JSF.r_contrib(p_a, r_sa, dt)
        K_a.append(ka + kar)
        V_a.append(va + var_)
    lane = lambda m, n: jnp.broadcast_to(jnp.asarray(m)[:, None],
                                         (n, D)).astype(jnp.float32)
    return JSK.seed_eval_kernel(
        JSK.pack_seed_params(p, L, G, dt or jnp.float32),
        jnp.asarray(x["seed_vec"])[None], jnp.stack(v_occ), jnp.stack(K_pt),
        jnp.stack(V_pt), lane(x["pl_mask"], P), jnp.stack(K_a),
        jnp.stack(V_a), lane(x["a2sa_mask"], A), JSK.selector(D, H, Hd),
        H, Hd, interpret=True)


def _torch_eval(model, G, x, dt, use_kernel_wrapper=False):
    dec = model.agent_decoder
    t = lambda a: torch.as_tensor(np.asarray(a))
    with torch.no_grad():
        r_pl = dec.embed_pl2sa_r(t(x["pl_r_raw"]))
        r_sa = dec.embed_a2sa_r(t(x["a2sa_r_raw"]))
        occ_emb = dec.embed_occ(t(x["occ_vec"]))
        chain = dec.seed_key_chain(t(x["agent_col"]))
        K_pt, V_pt, K_a, V_a, v_occ = [], [], [], [], []
        for i in range(L):
            pt, a = dec.pt2sa_attn_layers[i], dec.a2sa_attn_layers[i]
            v_occ.append(SF.occ_value(dec.occ2sa_attn_layers[i], occ_emb, dt))
            k0, v0 = SF.precompute_src_kv(pt, t(x["x_pt"]), dt)
            kr, vr = SF.r_contrib(pt, r_pl, dt)
            K_pt.append(k0 + kr)
            V_pt.append(v0 + vr)
            ka, va = SF.precompute_src_kv(a, chain[i], dt)
            kar, var_ = SF.r_contrib(a, r_sa, dt)
            K_a.append(ka + kar)
            V_a.append(va + var_)
        pack = SK.pack_seed_params(dec, L, G, dt)
        fn = SK.seed_eval_kernel if use_kernel_wrapper \
            else SK.seed_eval_reference
        small, pos = fn(pack, t(x["seed_vec"]), torch.stack(v_occ),
                        torch.stack(K_pt), torch.stack(V_pt),
                        t(x["pl_mask"]), torch.stack(K_a), torch.stack(V_a),
                        t(x["a2sa_mask"]), H, Hd)
    return torch.cat([small[0, :2], small[1, :3], small[2, :3],
                      pos]).numpy()


@pytest.mark.parametrize("all_masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_seed_eval_matches_jax_kernel(setup, dtype, all_masked):
    _, p, jdec, G, model = setup
    x = _inputs(G, all_masked)
    jdt = None if dtype == "float32" else jnp.bfloat16
    tdt = None if dtype == "float32" else torch.bfloat16
    ref = _jax_eval(jdec, p, G, x, jdt)
    out = _torch_eval(model, G, x, tdt)
    np.testing.assert_allclose(out, ref, atol=TOL[dtype], rtol=0)


def test_wrapper_takes_plain_version_on_cpu(setup):
    """On CPU tensors the wrapper computes the plain version and launches
    (and counts) nothing."""
    _, _, _, G, model = setup
    x = _inputs(G, False)
    before = SK.seed_eval_kernel.launches
    out = _torch_eval(model, G, x, None, use_kernel_wrapper=True)
    np.testing.assert_array_equal(out, _torch_eval(model, G, x, None))
    assert SK.seed_eval_kernel.launches == before


def test_seed_eval_matches_seed_fast_chain(setup):
    """seed_eval_reference equals the port's plain decomposed chain
    (seed_fast attention sublayers + seed_heads) at fp32."""
    _, _, _, G, model = setup
    dec = model.agent_decoder
    x = _inputs(G, False)
    t = lambda a: torch.as_tensor(np.asarray(a))
    with torch.no_grad():
        r_pl = dec.embed_pl2sa_r(t(x["pl_r_raw"]))
        r_sa = dec.embed_a2sa_r(t(x["a2sa_r_raw"]))
        occ_emb = dec.embed_occ(t(x["occ_vec"]))
        chain = dec.seed_key_chain(t(x["agent_col"]))
        sd = t(x["seed_vec"])
        for i in range(L):
            pt, a = dec.pt2sa_attn_layers[i], dec.a2sa_attn_layers[i]
            sd = SF.attn_1q_single_key(
                dec.occ2sa_attn_layers[i], sd,
                SF.occ_value(dec.occ2sa_attn_layers[i], occ_emb))
            k0, v0 = SF.precompute_src_kv(pt, t(x["x_pt"]))
            kr, vr = SF.r_contrib(pt, r_pl)
            sd = SF.attn_1q(pt, sd, k0 + kr, v0 + vr, t(x["pl_mask"]), H)
            ka, va = SF.precompute_src_kv(a, chain[i])
            kar, var_ = SF.r_contrib(a, r_sa)
            sd = SF.attn_1q(a, sd, ka + kar, va + var_, t(x["a2sa_mask"]), H,
                            bipartite=False)
        heads = dec.seed_heads(sd)
    ref = torch.cat([heads["state_logits"], heads["type_logits"],
                     heads["shape"], heads["pos_logits"]]).numpy()
    np.testing.assert_allclose(_torch_eval(model, G, x, None), ref,
                               atol=1e-5, rtol=0)


def test_wrapper_rejects_other_devices(setup):
    _, _, _, G, model = setup
    pack = SK.pack_seed_params(model.agent_decoder, L, G)
    meta = lambda *s, dtype=torch.float32: torch.empty(s, dtype=dtype,
                                                       device="meta")
    with pytest.raises(ValueError):
        SK.seed_eval_kernel(pack, meta(D), meta(L, D), meta(L, P, D),
                            meta(L, P, D), meta(P, dtype=torch.bool),
                            meta(L, A, D), meta(L, A, D),
                            meta(A, dtype=torch.bool), H, Hd)


# --------------------------------------------------------------------- #
# the full variant
# --------------------------------------------------------------------- #

def _jax_eval_full(jdec, p, G, x, dt):
    """The JAX package's full evaluation: the Pallas kernel in interpret
    mode on raw inputs (the rollout-invariant k0 / v0 from seed_fast),
    compiled once per dtype."""
    if dt not in _JAX_FULL_EVALS:
        _JAX_FULL_EVALS[dt] = jax.jit(
            lambda p_, x_: _jax_full_body(jdec, p_, G, x_, dt))
    small, pos = _JAX_FULL_EVALS[dt](p, x)
    small, pos = np.asarray(small), np.asarray(pos)
    return np.concatenate([small[0, :2], small[1, :3], small[2, :3],
                           pos[0, :G]])


def _jax_full_body(jdec, p, G, x, dt):
    def prep(mdl):
        return (mdl.embed_pl2sa_r(x["pl_r_raw"]),
                mdl.embed_a2sa_r(x["a2sa_r_raw"]))
    r_pl, r_sa = jdec.apply({"params": p}, method=prep)
    kv = [JSF.precompute_src_kv(p[f"pt2sa_{i}"], x["x_pt"], dt)
          for i in range(L)]
    Gp = -(-G // 128) * 128
    occ_row = jnp.pad(jnp.asarray(x["occ_vec"], jnp.float32),
                      (0, Gp - G))[None]
    lane = lambda m, n: jnp.broadcast_to(jnp.asarray(m)[:, None],
                                         (n, D)).astype(jnp.float32)
    return JSK.seed_eval_full_kernel(
        JSK.pack_seed_params_full(p, L, G, dt or jnp.float32),
        jnp.asarray(x["seed_vec"])[None], jnp.stack([k for k, _ in kv]),
        jnp.stack([v for _, v in kv]), r_pl, lane(x["pl_mask"], P),
        jnp.asarray(x["agent_col"]), r_sa, lane(x["a2sa_mask"], A), occ_row,
        JSK.selector(D, H, Hd), H, Hd, interpret=True)


def _torch_eval_full(model, G, x, dt, fn=SK.seed_eval_full_reference):
    dec = model.agent_decoder
    t = lambda a: torch.as_tensor(np.asarray(a))
    with torch.no_grad():
        kv = [SF.precompute_src_kv(dec.pt2sa_attn_layers[i], t(x["x_pt"]),
                                   dt) for i in range(L)]
        small, pos = fn(
            SK.pack_seed_params_full(dec, L, G, dt), t(x["seed_vec"]),
            torch.stack([k for k, _ in kv]), torch.stack([v for _, v in kv]),
            dec.embed_pl2sa_r(t(x["pl_r_raw"])), t(x["pl_mask"]),
            t(x["agent_col"]), dec.embed_a2sa_r(t(x["a2sa_r_raw"])),
            t(x["a2sa_mask"]), t(x["occ_vec"]), H, Hd)
    return torch.cat([small[0, :2], small[1, :3], small[2, :3],
                      pos]).numpy()


@pytest.mark.parametrize("case", ["masked", "agents_all_masked",
                                  "map_all_masked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_seed_eval_full_matches_jax_kernel(setup, dtype, case):
    _, p, jdec, G, model = setup
    x = _inputs(G, case == "agents_all_masked", case == "map_all_masked")
    jdt = None if dtype == "float32" else jnp.bfloat16
    tdt = None if dtype == "float32" else torch.bfloat16
    np.testing.assert_allclose(_torch_eval_full(model, G, x, tdt),
                               _jax_eval_full(jdec, p, G, x, jdt),
                               atol=TOL[dtype], rtol=0)


def test_seed_eval_full_matches_precomputed_path(setup):
    """At fp32 nothing is rounded, so the full evaluation equals the
    evaluation from K/V precomputed outside (the two differ at bf16 only:
    the non-full path rounds the map K/V sum to bf16)."""
    _, _, _, G, model = setup
    x = _inputs(G, False)
    np.testing.assert_allclose(_torch_eval_full(model, G, x, None),
                               _torch_eval(model, G, x, None), atol=1e-5,
                               rtol=0)


def test_full_wrapper_takes_plain_version_on_cpu(setup):
    _, _, _, G, model = setup
    x = _inputs(G, False)
    before = SK.seed_eval_full_kernel.launches
    np.testing.assert_array_equal(
        _torch_eval_full(model, G, x, None, fn=SK.seed_eval_full_kernel),
        _torch_eval_full(model, G, x, None))
    assert SK.seed_eval_full_kernel.launches == before


def test_full_wrapper_rejects_other_devices(setup):
    _, _, _, G, model = setup
    pack = SK.pack_seed_params_full(model.agent_decoder, L, G)
    meta = lambda *s, dtype=torch.float32: torch.empty(s, dtype=dtype,
                                                       device="meta")
    b = torch.bool
    with pytest.raises(ValueError):
        SK.seed_eval_full_kernel(pack, meta(D), meta(L, P, D), meta(L, P, D),
                                 meta(P, D), meta(P, dtype=b), meta(A, D),
                                 meta(A, D), meta(A, dtype=b),
                                 meta(G, dtype=b), H, Hd)
