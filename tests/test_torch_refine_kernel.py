"""The port's refine pass (`ops/refine_kernel.py`: `pack_refine_params` +
the plain `refine_reference`, which the CUDA kernel is held against on the
card) against the JAX package's Pallas `refine_kernel` run in interpret
mode, on the CPU.

Shapes as tests/test_refine_kernel.py (D=32, two heads of 16, three refine
layers, a 1 + 24 row neighbourhood padded to R=32, 32 map keys, 120 heading
bins). Weights: the flax subtrees of the trunk layers pt2a_i / a2a_i and of
the two heads, taken by the port through `convert.load_flax_params`
(test_torch_column_kernel's helpers). fp32: atol 2e-5, the JAX kernel
tests' own. bf16: atol 3e-2, for the reason given in
test_torch_column_kernel.py (a last-bit fp32 difference can round an operand
to the neighbouring bf16 value, six sublayers deep).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infgen_tpu.ops import refine_kernel as JRK

from infgen_torch.ops import refine_kernel as RK

from test_torch_column_kernel import (D, H, Hd, Layers, attention_tree,
                                      mlp_tree)

from test_torch_layers import one_torch_thread  # noqa: F401 (autouse)

L, R, KA, AH = 3, 32, 24, 120
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
_HEADS = {"seed_heading_rel_token_predict_head": AH,
          "seed_offset_xy_predict_head": 2}

_JAX_REFINES = {}        # compute dtype -> jitted JAX refine


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(59)
    specs = {}
    for i in range(L):
        specs[f"pt2a_{i}"] = ("attn", True, True)
        specs[f"a2a_{i}"] = ("attn", False, True)
    specs.update({h: ("mlp", D, n) for h, n in _HEADS.items()})
    tree = {name: (attention_tree(rng, s[1]) if s[0] == "attn"
                   else mlp_tree(rng, s[1], s[2]))
            for name, s in specs.items()}
    return tree, Layers(tree, specs).eval()


def _inputs(case):
    """The padded kernel inputs the rollout builds: row 0 the inserted
    agent, rows 1..24 its agent neighbours (their relations in the same
    rows), rows 25.. padding; map key k and its relation in row k."""
    rng = np.random.default_rng(61)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    x = dict(x_sub=np.zeros((R, D), np.float32), pl_keys=f(R, D),
             r_pl=f(R, D), mask_pl=rng.uniform(size=R) < 0.7,
             r_aa=np.zeros((R, D), np.float32),
             mask_a=np.zeros(R, bool))
    x["x_sub"][:1 + KA] = f(1 + KA, D)
    x["r_aa"][1:1 + KA] = f(KA, D)
    x["mask_a"][1:1 + KA] = rng.uniform(size=KA) < 0.6
    if case == "agents_all_masked":
        x["mask_a"][:] = False
    if case == "map_all_masked":
        x["mask_pl"][:] = False
    if case == "padding_filled":
        # padding rows are masked keys: their content must not matter
        x["x_sub"][1 + KA:] = f(R - 1 - KA, D) * 100
        x["r_aa"][1 + KA:] = f(R - 1 - KA, D) * 100
    return x


_ARGS = ("x_sub", "pl_keys", "r_pl", "mask_pl", "r_aa", "mask_a")


def _jax_refine(tree, x, dt):
    """The Pallas kernel in interpret mode, jitted once per dtype; the
    [2, 128] output cut to the heading logits and the two offsets."""
    if dt not in _JAX_REFINES:
        def run(p_, x_):
            lane = lambda m: jnp.broadcast_to(m[:, None], (R, D)).astype(
                jnp.float32)
            return JRK.refine_kernel(
                JRK.pack_refine_params(p_, L, AH, dt), x_["x_sub"],
                x_["pl_keys"], x_["r_pl"], lane(x_["mask_pl"]), x_["r_aa"],
                lane(x_["mask_a"]), JRK.selector(D, H, Hd), H, Hd,
                interpret=True)
        _JAX_REFINES[dt] = jax.jit(run)
    out = np.asarray(_JAX_REFINES[dt](tree, x))
    return np.concatenate([out[0, :AH], out[1, :2]])


def _torch_refine(layers, x, dt, fn=RK.refine_reference):
    pack = RK.pack_refine_params(layers, L, AH, dt)
    args = [torch.as_tensor(x[k]) for k in _ARGS]
    with torch.no_grad():
        head, off = fn(pack, *args, H, Hd)
    assert head.shape == (AH,) and off.shape == (2,)
    return torch.cat([head, off])


@pytest.mark.parametrize("case", ["masked", "agents_all_masked",
                                  "map_all_masked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_refine_matches_jax_kernel(setup, dtype, case):
    tree, layers = setup
    x = _inputs(case)
    jdt = None if dtype == "float32" else jnp.bfloat16
    tdt = None if dtype == "float32" else torch.bfloat16
    np.testing.assert_allclose(_torch_refine(layers, x, tdt).numpy(),
                               _jax_refine(tree, x, jdt), atol=TOL[dtype],
                               rtol=0)


def test_refine_padding_rows_do_not_matter(setup):
    """Rows past the real neighbourhood are masked keys and take the
    zero-aggregate path: whatever they hold, the outputs are the same bit
    for bit."""
    _, layers = setup
    assert torch.equal(_torch_refine(layers, _inputs("padding_filled"), None),
                       _torch_refine(layers, _inputs("masked"), None))


def test_wrapper_takes_plain_version_on_cpu(setup):
    """On CPU tensors the wrapper computes the plain version and launches
    (and counts) nothing."""
    _, layers = setup
    x = _inputs("masked")
    before = RK.refine_kernel.launches
    assert torch.equal(_torch_refine(layers, x, None, fn=RK.refine_kernel),
                       _torch_refine(layers, x, None))
    assert RK.refine_kernel.launches == before


def test_wrapper_rejects_other_devices(setup):
    _, layers = setup
    pack = RK.pack_refine_params(layers, L, AH)
    meta = lambda *s, dtype=torch.float32: torch.empty(s, dtype=dtype,
                                                       device="meta")
    b = torch.bool
    with pytest.raises(ValueError):
        RK.refine_kernel(pack, meta(R, D), meta(R, D), meta(R, D),
                         meta(R, dtype=b), meta(R, D), meta(R, dtype=b),
                         H, Hd)
