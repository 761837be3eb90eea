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

The trainable form (`r_biased_attention_trainable`: the forward above, the
backward a recompute through the plain twin under autograd) against the
JAX package's custom-VJP function (its Pallas forward in interpret mode,
its VJP through the XLA reference) via jax.vjp, at two tiny shapes with
and without a dropout multiplier, fully masked queries included: the six
gradients within 1e-4 of each one's max |g| (fp32, summation order).
And the training layer: a `torch.utils.checkpoint`-wrapped DenseAttention
(remat) with dropout masks drawn before the region gives the unwrapped
layer's output and gradients exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infgen_tpu.model.layers import DenseAttention as JDenseAttention
from infgen_tpu.ops.pallas_attention import r_biased_attention as j_rba
from infgen_tpu.ops.pallas_attention import \
    r_biased_attention_trainable as j_rba_trainable

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


@pytest.mark.parametrize("drop", [False, True], ids=["nodrop", "dropout"])
@pytest.mark.parametrize("B,Q,K", [(2, 21, 21), (3, 10, 30)],
                         ids=["square", "bipartite"])
def test_trainable_gradients_match_jax_vjp(B, Q, K, drop):
    """dq, dk, dv, dr, dW_kr, dW_vr of r_biased_attention_trainable against
    jax.vjp of the JAX package's r_biased_attention_trainable (interpret
    mode) on the same cotangent; a fully masked query's dq is 0."""
    x = _kernel_inputs(Q * 11 + K + drop, B, Q, K, drop)
    names = ("q", "k", "v", "r", "w_kr", "w_vr")
    g = np.random.default_rng(B + Q).normal(
        size=(B, Q, KH * Kd)).astype(np.float32)
    d = jnp.asarray(x["drop"]) if drop else None
    _, vjp = jax.vjp(lambda *a: j_rba_trainable(
        *a, jnp.asarray(x["mask"]), KH, d, True),
        *(jnp.asarray(x[n]) for n in names))
    ref = vjp(jnp.asarray(g))
    leaves = [torch.tensor(x[n], requires_grad=True) for n in names]
    calls = PA.r_biased_attention_trainable.backward_calls
    out = PA.r_biased_attention_trainable(
        *leaves, torch.as_tensor(x["mask"]), KH,
        torch.as_tensor(x["drop"]) if drop else None)
    out.backward(torch.as_tensor(g))
    assert PA.r_biased_attention_trainable.backward_calls == calls + 1
    for n, t, r in zip(names, leaves, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(t.grad.numpy(), r, rtol=0,
                                   atol=1e-4 * np.abs(r).max(), err_msg=n)
    assert np.abs(leaves[0].grad[0, min(3, Q - 1)].numpy()).max() == 0.0


def test_remat_with_predrawn_dropout_matches_plain():
    """DenseAttention(remat=True) in train mode, checkpointed while grad is
    enabled, against the same layer unwrapped: the same generator seed
    draws the same masks before the region, and the recompute reuses them,
    so outputs and every gradient are equal bit for bit (the kernel branch
    and the module branch)."""
    rng = np.random.default_rng(9)
    t = lambda *s: torch.as_tensor(rng.normal(size=s), dtype=torch.float32)
    x, r = t(3, 12, D), t(3, 12, 12, D)
    mask = torch.as_tensor(rng.uniform(size=(3, 12, 12)) < 0.6)
    mask[0, 2] = False
    for use_pallas in (False, True):
        base = DenseAttention(D, H, Hd, use_pallas=use_pallas)
        for p in base.parameters():
            p.data = torch.as_tensor(rng.normal(0, 0.2, p.shape),
                                     dtype=torch.float32)
        grads = []
        for remat in (False, True):
            mod = DenseAttention(D, H, Hd, use_pallas=use_pallas,
                                 dropout=0.3, remat=remat).train()
            mod.load_state_dict(base.state_dict())
            xx = x.clone().requires_grad_()
            out = mod(xx, None, r, mask, torch.Generator().manual_seed(5))
            out.square().sum().backward()
            grads.append([out.detach(), xx.grad] + [p.grad for p in
                                                    mod.parameters()])
        for a, b in zip(*grads):
            assert torch.equal(a, b)
        with torch.no_grad():       # dropout acted
            assert not torch.equal(grads[0][0], base(x, None, r, mask))
