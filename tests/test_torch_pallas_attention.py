"""The port's relation-biased attention (`ops/pallas_attention.py`: the
plain `r_biased_attention_reference`, which the CUDA kernel is held against
on the card) against the JAX package's Pallas `r_biased_attention` in
interpret mode, and the port's `DenseAttention(use_pallas=True)` against
the JAX module with `use_pallas=True`, on the CPU.

Kernel cases of tests/test_pallas_attention.py (a B/N grid up to 130 keys,
dropout, rectangular bipartite Q != K) and one call over two full key
tiles of the TPU kernel (K = 260), H = 4 heads of 16, Dr = 32: atol 5e-5,
the JAX tests' own (fp32 on both sides, summation order only).

The module at fp32 and under the bf16 compute policy, unbatched [A, D] (the
rollout's agent-agent call) and batched [3, A, D], against the JAX module
jitted with `xla_allow_excess_precision` off (otherwise XLA fuses bf16
elementwise chains and rounds elsewhere than flax op by op, and than the
port). fp32: atol 2e-5. bf16: both sides round at the same places, so
only a last-bit difference of the fp32 attention sums can flip a bf16
rounding downstream; such flips are sparse. Mean abs error 1e-3 (read: 0):
each wrong cast of the branch's recipe (prenorm_r in bf16, b_vr added to
the relation term, w_kr / w_vr unrounded, the aggregate rounded to bf16)
reads 4e-3 or more on these inputs; max abs 0.1 for gross faults.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infgen_tpu.model.layers import DenseAttention as JDenseAttention
from infgen_tpu.ops.pallas_attention import r_biased_attention as j_rba

from infgen_torch.config import Config
from infgen_torch.convert import load_flax_params
from infgen_torch.data.scenario import to_device
from infgen_torch.data.synthetic import make_synthetic_scenario
from infgen_torch.model.layers import DenseAttention
from infgen_torch.model.map_encoder import MapEncoder
from infgen_torch.ops import pallas_attention as PA
from infgen_torch.tokenizers.vocab import load_map_vocab

from test_torch_layers import fill_tree, one_torch_thread  # noqa: F401

ATOL = 5e-5
KH, Kd, KDr = 4, 16, 32          # kernel cases: heads, head dim, r width
D, H, Hd = 32, 2, 16             # module cases


def _kernel_inputs(seed, B, Q, K, drop=False):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    HD = KH * Kd
    x = dict(q=f(B, Q, HD), k=f(B, K, HD), v=f(B, K, HD), r=f(B, Q, K, KDr),
             w_kr=f(KDr, HD) * 0.1, w_vr=f(KDr, HD) * 0.1,
             mask=rng.uniform(size=(B, Q, K)) < 0.5)
    x["mask"][0, min(3, Q - 1)] = False      # a fully masked query row
    if drop:
        x["drop"] = (rng.uniform(size=(B, Q, K, KH)) < 0.9).astype(
            np.float32) / 0.9
    return x


@pytest.mark.parametrize("B,Q,K,drop", [(2, 21, 21, False),
                                        (1, 48, 48, False),
                                        (3, 130, 130, False),
                                        (2, 40, 40, True),
                                        (3, 10, 130, False),
                                        (1, 16, 260, True)],
                         ids=["b2n21", "b1n48", "b3n130", "dropout",
                              "bipartite", "k260"])
def test_reference_matches_pallas(B, Q, K, drop):
    x = _kernel_inputs(Q * 7 + K, B, Q, K, drop)
    ref = np.asarray(j_rba(*(jnp.asarray(x[k]) for k in
                             ("q", "k", "v", "r", "w_kr", "w_vr", "mask")),
                           KH, jnp.asarray(x["drop"]) if drop else None,
                           interpret=True))
    before = PA.r_biased_attention.launches
    got = PA.r_biased_attention(
        *(torch.as_tensor(x[k]) for k in ("q", "k", "v", "r", "w_kr",
                                          "w_vr", "mask")), KH,
        torch.as_tensor(x["drop"]) if drop else None).numpy()
    assert PA.r_biased_attention.launches == before     # CPU: plain twin
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    assert np.abs(got[0, min(3, Q - 1)]).max() == 0.0


def _module_case(shape, dtype):
    """(flax tree, inputs) of one DenseAttention(use_pallas=True) case."""
    rng = np.random.default_rng(len(shape) * 5 + (dtype is None))
    jmod = JDenseAttention(D, H, Hd, 0.0, use_pallas=True, dtype=dtype)
    x = rng.normal(size=shape).astype(np.float32)
    rr = rng.normal(size=(*shape[:-1], shape[-2], D)).astype(np.float32)
    mask = rng.uniform(size=(*shape[:-1], shape[-2])) < 0.5
    mask[..., 2, :] = False
    shapes = jax.eval_shape(lambda: jmod.init(
        jax.random.PRNGKey(0), x, None, rr, mask, True))["params"]
    return jmod, fill_tree(shapes, rng), x, rr, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(24, D), (3, 24, D)],
                         ids=["unbatched", "batched"])
def test_dense_attention_pallas_matches_jax(shape, dtype, monkeypatch):
    jdt = None if dtype == "float32" else jnp.bfloat16
    tdt = None if dtype == "float32" else torch.bfloat16
    jmod, tree, x, rr, mask = _module_case(shape, jdt)
    ref = jax.jit(lambda p, *a: jmod.apply({"params": p}, *a, True)).lower(
        tree, x, None, rr, mask).compile(
        compiler_options={"xla_allow_excess_precision": False})(
        tree, x, None, rr, mask)
    mod = DenseAttention(D, H, Hd, use_pallas=True, dtype=tdt)
    load_flax_params(mod, tree)
    calls = _count_calls(monkeypatch)
    with torch.no_grad():
        got = mod.eval()(torch.as_tensor(x), None, torch.as_tensor(rr),
                         torch.as_tensor(mask))
    assert calls == [1]
    assert str(got.dtype)[6:] == str(ref.dtype)
    ref = np.asarray(ref.astype(jnp.float32))
    if tdt is None:
        np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=0)
    else:
        err = np.abs(got.float().numpy() - ref)
        assert err.mean() <= 1e-3 and err.max() <= 0.1, (err.mean(),
                                                          err.max())


def _count_calls(monkeypatch):
    """Patch a counter onto the kernel wrapper that DenseAttention calls."""
    calls = [0]
    real = PA.r_biased_attention

    def counted(*a, **k):
        calls[0] += 1
        return real(*a, **k)
    monkeypatch.setattr(PA, "r_biased_attention", counted)
    return calls


def test_ineligible_calls_never_reach_the_kernel(monkeypatch):
    """A call with Q < 8 queries, the rollout's one-query temporal and map
    calls, and the map encoder (one query per map token) keep the module
    path under use_pallas, as the JAX package's eligibility rule keeps
    them."""
    rng = np.random.default_rng(3)
    mod = DenseAttention(D, H, Hd, use_pallas=True)
    for p in mod.parameters():
        p.data = torch.as_tensor(rng.normal(0, 0.2, p.shape),
                                 dtype=torch.float32)
    t = lambda *s: torch.as_tensor(rng.normal(size=s), dtype=torch.float32)
    calls = _count_calls(monkeypatch)
    with torch.no_grad():
        mod(t(7, D), None, t(7, 7, D), torch.ones(7, 7, dtype=torch.bool))
        mod(t(16, 1, D), t(16, 12, D), t(16, 1, 12, D),
            torch.ones(16, 1, 12, dtype=torch.bool))
        assert calls == [0]
        mod(t(8, D), None, t(8, 8, D), torch.ones(8, 8, dtype=torch.bool))
        assert calls == [1]            # the patch sees an eligible call

        cfg = Config(max_agents=16, max_map_tokens=64, hidden_dim=D,
                     num_heads=H, head_dim=Hd, num_freq_bands=8,
                     num_map_layers=2, use_pallas_attention=True)
        enc = MapEncoder(cfg).eval()
        assert all(m.use_pallas for m in enc.modules()
                   if isinstance(m, DenseAttention))
        for p in enc.parameters():
            p.data = torch.as_tensor(rng.normal(0, 0.2, p.shape),
                                     dtype=torch.float32)
        scen = make_synthetic_scenario(cfg, seed=4, num_agents=6)
        traj = torch.as_tensor(np.asarray(load_map_vocab()["traj_src"]),
                               dtype=torch.float32)
        x_pt = enc(to_device(scen.map, "cpu"), traj)
    assert torch.isfinite(x_pt).all()
    assert calls == [1]
