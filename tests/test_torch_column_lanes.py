"""The lane form of the port's trunk column (`ops/column_kernel.py`) and the
latency preset served over lanes, on the CPU.

- The column's plain twin over three lanes (occupancy bounds A, a few and
  0) against `jax.jit(jax.vmap(...))` of the JAX package's Pallas
  `motion_column_kernel` in interpret mode, fp32 and bf16, within
  tests/test_torch_column_kernel.py's TOL (the same weights and shapes);
  and each lane against the unbatched twin on its own arrays, bit for bit.
- The rollout under the latency preset's three kernel flags
  (use_seed_kernel_full, use_refine_kernel, use_column_kernel) over lanes:
  a forced-insertion batch whose lanes stop inserting apart, each lane its
  single rollout's decisions bitwise and poses within LANE_POSE_TOL; a
  fleet of two through the chunked stream runner, each lane the scenario's
  own stream; `cli rollout --batch 2` with the latency config; and a
  two-lane rollout against `jax.jit(jax.vmap)` of the JAX package's
  rollout under the same flags (beam 1, fp32, forced insertion): token
  ids, state ids, slot activity and insertion counts bitwise, poses within
  POSE_TOL. The JAX side traces and compiles in a process of its own,
  started by the module's autouse fixture at its first test, and the test
  that reads it comes last.
"""

import json
import multiprocessing
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infgen_tpu.config import Config as JConfig
from infgen_tpu.data.features import build_model_inputs as j_build_inputs
from infgen_tpu.data.synthetic import make_synthetic_scenario as j_synthetic
from infgen_tpu.model.infgen import InfGenModel as JModel
from infgen_tpu.ops import column_kernel as JCK
from infgen_tpu.rollout.closed_loop import make_rollout_fn as j_rollout_fn
from infgen_tpu.tokenizers.attr_tokenizer import AttrTokenizer as JAttr
from infgen_tpu.tokenizers.motion_tokenizer import MotionTokenizer as JMotion
from infgen_tpu.tokenizers.vocab import load_map_vocab as j_map_vocab

from infgen_torch import cli
from infgen_torch.config import Config
from infgen_torch.data import scenario as S
from infgen_torch.data.features import build_model_inputs
from infgen_torch.data.synthetic import make_synthetic_scenario
from infgen_torch.ops import column_kernel as CK
from infgen_torch.rollout import closed_loop as CL
from infgen_torch.rollout import streaming as ST
from infgen_torch.rollout.serving import compact_scenario, repad_scenario

from test_torch_column_kernel import (  # noqa: F401 (setup: a fixture)
    _ARGS, _inputs, A, D, H, Hd, L, TOL, setup)
from test_torch_layers import one_torch_thread  # noqa: F401 (autouse)
from test_torch_rollout import CLOSE, POSE_TOL
from test_torch_serving import (EXACT, LANE_POSE_TOL, ROLL, ROLL_KEY,
                                ROLL_SCENS, TINY, _decoder_tree,
                                _lane_rollouts, _same)

N_ROWS = (A, 5, 0)        # the three lanes' occupancy bounds
LATENCY = dict(use_seed_kernel_full=True, use_refine_kernel=True,
               use_column_kernel=True)
LATENCY_YAML = os.path.join(os.path.dirname(__file__), "..", "configs",
                            "ours_long_term_latency.yaml")


def _jax_vmapped_latency_rollout(params):
    """The map uniforms of the JAX input key, and the JAX package's rollout
    with the flax `params` under the latency preset's three flags as
    jax.jit(jax.vmap) over the two lanes (the JAX server's batched
    program), beam 1, forced insertion."""
    jcfg = JConfig(**ROLL, **LATENCY)
    jattr = JAttr(jcfg.grid_range, jcfg.grid_interval, jcfg.pl2seed_radius,
                  jcfg.angle_interval)
    jmt, jmv = JMotion(), j_map_vocab()
    key = jax.random.PRNGKey(ROLL_KEY)
    uniforms = np.array(jax.random.uniform(jax.random.split(key)[0],
                                           (jcfg.max_map_tokens,)))
    jscens = [j_synthetic(jcfg, seed=s, num_agents=n) for s, n in ROLL_SCENS]
    build = jax.jit(lambda sc, k: j_build_inputs(jcfg, jmt, jattr, sc, k))
    stack = lambda trees: jax.tree.map(lambda *a: jnp.stack(a), *trees)
    jfn = j_rollout_fn(JModel(jcfg, jattr.grid, jattr.grid_size,
                              jattr.angle_size), jcfg, jattr, jmt, jmv,
                       jit=False, force_insert=True)
    keys = jax.random.split(jax.random.PRNGKey(7), len(ROLL_SCENS))
    out = jax.device_get(jax.jit(jax.vmap(jfn, in_axes=(None, 0, 0, 0)))(
        params, stack(jscens), stack([build(sc, key) for sc in jscens]),
        keys))
    return uniforms, out


@pytest.fixture(scope="module", autouse=True)
def jax_latency_rollout():
    """The port at ROLL under the latency flags with random weights, and the
    JAX side of test_latency_lanes_match_jax_vmap on the same weights (its
    trace, compile and run) in a process of its own, started at the
    module's first test: its trace is Python-bound and would hold this
    process's interpreter lock from the tests beside it. The module's last
    test collects it."""
    cfg = Config(**ROLL, **LATENCY)
    tok = cli.build_tokenizers(cfg)
    model = cli.build_model(cfg, tok[0], "cpu")
    params = _decoder_tree(model, np.random.default_rng(0))
    pool = multiprocessing.get_context("spawn").Pool(1)
    try:
        yield cfg, tok, model.eval(), pool.apply_async(
            _jax_vmapped_latency_rollout, (params,))
    finally:
        pool.terminate()
        pool.join()


# --------------------------------------------------------------------- #
# the column's lane form
# --------------------------------------------------------------------- #

def _lanes_np():
    """Three lanes of their own inputs, rows past each lane's bound with
    every key masked."""
    return [_inputs(40 + b, n) for b, n in enumerate(N_ROWS)]


def _torch_lanes(pack, xs):
    """The lanes' wrapper arguments: [B, ...] arrays, key_stack
    [L, B, A, W, D]; keys and relations in the pack's compute dtype."""
    cdt = pack.dtype
    t = lambda k, x: torch.as_tensor(x[k]) if x[k].dtype == bool or \
        k == "x0" else torch.as_tensor(x[k]).to(cdt)
    args = [torch.stack([t(k, x) for x in xs]) for k in _ARGS]
    args[1] = args[1].transpose(0, 1).contiguous()
    return args, torch.tensor(N_ROWS, dtype=torch.int32)


def _lane(args, b):
    return [(a[:, b] if i == 1 else a[b]).contiguous()
            for i, a in enumerate(args)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_column_lanes_match_jax_vmap(setup, dtype):
    """The lane twin (through the wrapper on CPU tensors) against
    jax.jit(jax.vmap) of the Pallas kernel in interpret mode, each lane its
    own bound, within TOL."""
    tree, layers = setup
    jdt = None if dtype == "float32" else jnp.bfloat16
    tdt = None if dtype == "float32" else torch.bfloat16
    xs = _lanes_np()

    @jax.jit
    def run(p_, x_, nr):
        packed = JCK.pack_column_params(p_, L, jdt)
        return jax.vmap(lambda x, n: JCK.motion_column_kernel(
            packed, *[x[k] for k in _ARGS], H, Hd, compute_dtype=jdt,
            chunk=4, interpret=True, n_rows=n))(x_, nr)

    xj = {k: jnp.stack([x[k] for x in xs]) for k in _ARGS}
    ref = np.asarray(run(tree, xj, jnp.asarray(N_ROWS, jnp.int32)))
    pack = CK.pack_column_params(layers, L, tdt)
    args, nr = _torch_lanes(pack, xs)
    with torch.no_grad():
        out = CK.motion_column_kernel(pack, *args, H, Hd, n_rows=nr)
    assert out.dtype == torch.float32 and out.shape == (L, len(xs), A, D)
    for b in range(len(xs)):
        np.testing.assert_allclose(out[:, b].numpy(), ref[b],
                                   atol=TOL[dtype], rtol=0,
                                   err_msg=f"lane {b}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_column_lanes_match_single(setup, dtype):
    """Each lane of the lane twin equals the unbatched twin on its arrays
    and bound bit for bit; the lane with bound 0 equals its full
    computation (the skip is exact); nothing launches on CPU tensors."""
    _, layers = setup
    pack = CK.pack_column_params(
        layers, L, None if dtype == "float32" else torch.bfloat16)
    args, nr = _torch_lanes(pack, _lanes_np())
    before = CK.motion_column_kernel.launches
    with torch.no_grad():
        out = CK.motion_column_kernel(pack, *args, H, Hd, n_rows=nr)
        for b in range(len(N_ROWS)):
            one = _lane(args, b)
            single = CK.motion_column_kernel(pack, *one, H, Hd,
                                             n_rows=nr[b])
            assert torch.equal(out[:, b], single), f"lane {b}"
        full = CK.motion_column_reference(pack, *_lane(args, 2), H, Hd)
    assert torch.equal(out[:, 2], full)
    assert CK.motion_column_kernel.launches == before


def test_column_wrapper_checks_lane_shapes(setup):
    """The wrapper raises on lane shapes it does not take: a bound per lane
    of the wrong count, a key stack without the lane axis, two lane
    axes."""
    _, layers = setup
    pack = CK.pack_column_params(layers, L)
    args, nr = _torch_lanes(pack, _lanes_np())
    with pytest.raises(ValueError, match="n_rows"):
        CK.motion_column_kernel(pack, *args, H, Hd, n_rows=nr[:2])
    bad = list(args)
    bad[1] = args[1][:, 0].contiguous()
    with pytest.raises(ValueError, match="key_stack"):
        CK.motion_column_kernel(pack, *bad, H, Hd, n_rows=nr)
    with pytest.raises(ValueError, match="x0"):
        CK.motion_column_kernel(pack, args[0][None], *args[1:], H, Hd)


# --------------------------------------------------------------------- #
# the latency preset over lanes
# --------------------------------------------------------------------- #

def test_latency_lanes_match_single():
    """Under the latency preset's three flags a forced-insertion batch of
    two lanes (13 and 4 live agents, insert_limit 4: the lanes stop
    inserting at different iterations) gives in each lane its single
    rollout's decisions bitwise and poses within LANE_POSE_TOL, and the
    host reads of the batch with the flags off."""
    cfg = Config(**dict(TINY, insert_limit=4, num_recurrent_steps_val=15))
    tok = cli.build_tokenizers(cfg)
    model = cli.build_model(cfg, tok[0], "cpu")
    scens = [make_synthetic_scenario(cfg, seed=s, num_agents=n)
             for s, n in ((5, 13), (7, 4))]
    _, reads_off, _ = _lane_rollouts(cfg, tok, model, scens, {},
                                     singles=False)
    lanes, reads, singles = _lane_rollouts(cfg, tok, model, scens, LATENCY)
    assert reads == reads_off
    per_step = np.stack([lane["per_step_inserted"].numpy()
                         for lane in lanes])
    assert any(len(set(col)) > 1 for col in per_step.T), per_step
    for lane, single in zip(lanes, singles):
        _same(lane, single, pose_tol=LANE_POSE_TOL["beam1"])


def test_chunked_fleet_under_column_flag():
    """A fleet of two scenarios through make_chunked_stream_runner under
    the latency preset's flags (one chunk of two segments, beam 1) gives
    in each lane the scenario's own stream with the seed the runner gives
    that lane: states and types bitwise, poses within LANE_POSE_TOL, the
    same agents ever alive."""
    cfg = Config(**dict(TINY, insert_limit=2, insert_beam_size=1,
                        **LATENCY))
    tok = cli.build_tokenizers(cfg)
    model = cli.build_model(cfg, tok[0], "cpu")
    Hs, P, seg = cfg.num_historical_steps, cfg.max_map_tokens, 10
    scens = [make_synthetic_scenario(cfg, seed=s, num_agents=n)
             for s, n in ((0, 6), (3, 9))]
    runner = ST.make_chunked_stream_runner(cfg, *tok, segment_steps=seg)
    outs, used = runner(model, scens, ((cfg.max_agents, 2),), 5)
    assert used == [cfg.max_agents]
    fn = ST.make_stream_fn(model, cfg, *tok, segment_steps=seg,
                           n_segments=2)
    ever = []
    for i, sc in enumerate(scens):
        own = fn(repad_scenario(compact_scenario(sc)[0], cfg.max_agents, P),
                 ST.seed_of(5, 0, i))
        want = ST.stitch_stream_outputs(own, Hs)
        got = ST.stitch_stream_outputs(
            {k: v[i] for k, v in outs[0].items() if k != "final_agents"}, Hs)
        for k in ("state", "type"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k in ("traj", "head", "shape"):
            np.testing.assert_allclose(got[k], want[k], rtol=0, err_msg=k,
                                       atol=LANE_POSE_TOL["beam1"])
        ever.append(want["state"].shape[0])
    assert runner.agents_ever_alive == ever
    assert sum(int(o["n_inserted"].sum()) for o in outs) > 0


def test_cli_batched_latency_rollout_on_cpu(capsys):
    """`rollout --batch 2` serves the latency config's scenarios (full
    width, one token step) through rollout_batch as one batch of two
    lanes."""
    cli.main(["rollout", "--config", LATENCY_YAML, "--synthetic", "--device",
              "cpu", "--force-insert", "--num-recurrent-steps", "5",
              "--num-scenarios", "2", "--batch", "2"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["token_steps"] == 1 and summary["batch"] == 2
    assert [b["lanes"] for b in summary["batches"]] == [2]
    assert summary["agent_steps"] > 0 and summary["agent_steps_per_s"] > 0


def test_latency_lanes_match_jax_vmap(jax_latency_rollout):
    """A two-lane rollout of the port under the latency preset's flags
    against jax.jit(jax.vmap) of the JAX package's rollout under the same
    flags (both sides' kernels as their plain versions), beam 1, fp32,
    forced insertion, the same converted weights and map uniforms: per
    lane, token ids, state ids, slot activity and insertion counts
    bitwise, poses within POSE_TOL."""
    cfg, (attr, mt, mv), model, jax_side = jax_latency_rollout
    uniforms, jout = jax_side.get()
    fn = CL.make_rollout_fn(model, cfg, attr, mt, mv, force_insert=True)
    scens = [S.to_device(make_synthetic_scenario(cfg, seed=s, num_agents=n),
                         "cpu") for s, n in ROLL_SCENS]
    inputs = [build_model_inputs(cfg, mt, attr, sd,
                                 pt_uniform=torch.as_tensor(uniforms))
              for sd in scens]
    out = fn(S.stack_scenarios(scens), S.stack_scenarios(inputs),
             [torch.Generator().manual_seed(7 + i) for i in range(2)])
    for b in range(2):
        lane = {k: v[b] for k, v in out.items()}
        assert set(lane) == set(jout)
        for k in EXACT:
            np.testing.assert_array_equal(lane[k].numpy(),
                                          np.asarray(jout[k])[b],
                                          err_msg=f"lane {b} {k}")
        for k in CLOSE:
            np.testing.assert_allclose(lane[k].numpy(),
                                       np.asarray(jout[k])[b], atol=POSE_TOL,
                                       rtol=0, err_msg=f"lane {b} {k}")
        assert int(lane["n_inserted"]) > 0
