"""The port's NMS helpers (metrics/nms.py) and guided samplers
(ops/sampling.py: sample_next_token_traj, sample_next_gmm_traj) against the
JAX package's, on the CPU.

NMS has no randomness: selections, scores and the selected trajectories
must equal the JAX package's bit for bit, on float32 inputs (the JAX side
runs without x64), including a fully covered set where the reference's
quirks (survivors scaled by 0, the -1 penalty accumulating) decide.

The samplers draw from a torch.Generator where the JAX package draws from
a key, so they agree only in distribution, except at their deterministic
limit: num_k = 1 (and for the GMM sampler ego_next_cov = 0) makes both a
function of their inputs. There the token ids and the gathered
trajectories must be equal bit for bit, and the GMM sampler's interpolated
contours (cos / sin of two libraries) within 1e-5. At num_k = 5 the
draws of many tiled rows must pass tests/test_torch_sampled.py's two-sample
chi-square (token ids per row) at p > 1e-3, and a KS test on the sampled
ego contour; the token sampler with one logit shifted by +1 must fail the
chi-square at p < 1e-6.
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from scipy import stats

from infgen_tpu.metrics import nms as _jnms
from infgen_tpu.ops import sampling as _jsampling

from infgen_torch.metrics import nms
from infgen_torch.ops import sampling

from test_torch_layers import one_torch_thread  # noqa: F401 (autouse)

# the JAX side jitted: eager dispatch compiles each op apart (3 s a call)
jnms = SimpleNamespace(**{
    f: jax.jit(getattr(_jnms, f), static_argnames=("num_ret_modes", "mode")
               if f != "new_batch_nms" else ("num_ret_modes",))
    for f in ("new_batch_nms", "batch_nms", "batch_nms_token")})
jsampling = SimpleNamespace(**{
    f: jax.jit(getattr(_jsampling, f), static_argnames=("criterium", "num_k"))
    for f in ("sample_next_token_traj", "sample_next_gmm_traj")})

A, V, K_GMM = 6, 16, 12
EGO_ROWS = np.array([1, 4])
N_DRAWS = 3000           # tiled copies of the rows per side
CONTOUR_TOL = 1e-5
ACCEPT_P = 1e-3          # tests/test_torch_sampled.py's limits
REJECT_P = 1e-6


def _chi2_two_sample(h1, h2):
    """tests/test_torch_sampled.py's two-sample chi-square, copied (that
    module imports the JAX rollout, about 10 s): bins with a combined count
    below 5 merged into one."""
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
    return stats.chi2.sf(chi2, max(len(a) - 1, 1))


def _assert_nms_equal(port, jax_out):
    for a, b, what in zip(port, jax_out, ("trajs", "scores", "idxs")):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=what)


def _trajs(rng, B=2, M=16, T=8, F=7, spread=12.0):
    trajs = (rng.normal(size=(B, M, T, F)) * 2.0).astype(np.float32)
    trajs[:, :, -1, 0:2] = rng.uniform(-spread, spread, size=(B, M, 2))
    return trajs


def test_new_batch_nms_matches_jax():
    """Density scores over goal clusters of sizes 1, 2, 3, 4, 6 (the JAX
    test's layout), and a set where every goal covers every other."""
    rng = np.random.default_rng(0)
    goals = np.asarray([[np.array([40.0 * k, 100.0 * b]) + [0.1 * i, 0.05 * i]
                         for k, size in enumerate([1, 2, 3, 4, 6])
                         for i in range(size)] for b in range(2)])
    trajs = rng.normal(size=(2, goals.shape[1], 6, 7)).astype(np.float32)
    trajs[:, :, -1, 0:2] = goals
    for t, thresh in ((trajs, 2.5), (trajs, 1e4)):
        _assert_nms_equal(nms.new_batch_nms(torch.from_numpy(t), thresh, 6),
                          jnms.new_batch_nms(t, thresh, 6))


@pytest.mark.parametrize("mode", ["static", "speed"])
def test_batch_nms_matches_jax(mode):
    rng = np.random.default_rng(1)
    trajs = _trajs(rng)
    scores = rng.normal(size=trajs.shape[:2]).astype(np.float32)
    for thresh in (8.0, 1e4):
        _assert_nms_equal(
            nms.batch_nms(torch.from_numpy(trajs), torch.from_numpy(scores),
                          thresh, 6, mode=mode),
            jnms.batch_nms(trajs, scores, thresh, 6, mode=mode))


@pytest.mark.parametrize("mode", ["static", "nearby"])
def test_batch_nms_token_matches_jax(mode):
    rng = np.random.default_rng(2)
    goals = (rng.normal(size=(2, 16, 7)) * 2.0).astype(np.float32)
    goals[..., 0:2] = rng.uniform(-12.0, 12.0, size=(2, 16, 2))
    scores = rng.normal(size=(2, 16)).astype(np.float32)
    _assert_nms_equal(
        nms.batch_nms_token(torch.from_numpy(goals), torch.from_numpy(scores),
                            8.0, 6, mode=mode),
        jnms.batch_nms_token(goals, scores, 8.0, 6, mode=mode))


def _sampler_inputs(seed=3):
    """The samplers' inputs (numpy float32), as tests/test_nms_gmm.py
    draws them, the vocab cut to V tokens."""
    rng = np.random.default_rng(seed)
    f = lambda x: np.asarray(x, np.float32)
    token_traj_all = f(rng.normal(size=(A, V, 6, 4, 2)) * 3.0)
    pos_now = f(rng.normal(size=(A, 2)) * 10.0)
    head_now = f(rng.uniform(-np.pi, np.pi, size=(A,)))
    return dict(
        token_traj=token_traj_all[:, :, -1], token_traj_all=token_traj_all,
        logits=f(rng.normal(size=(A, V)) * 1.5), pos_now=pos_now,
        head_now=head_now, pos_next_gt=f(pos_now + rng.normal(size=(A, 2))),
        head_next_gt=f(head_now + rng.normal(size=(A,)) * 0.2),
        valid_next_gt=rng.uniform(size=(A,)) > 0.3,
        shape=f(rng.uniform(0.5, 4.0, size=(A, 2))),
        next_token_idx=rng.integers(0, V, size=(A,)).astype(np.int32),
        ego_logits=f(rng.normal(size=(len(EGO_ROWS), K_GMM))),
        ego_poses=f(rng.normal(size=(len(EGO_ROWS), K_GMM, 3)) * 2.0))


def _tile(x, n):
    return np.concatenate([x] * n) if n > 1 else x


def _token_args(d, n=1):
    keys = ("token_traj", "token_traj_all", "logits", "pos_now", "head_now",
            "pos_next_gt", "head_next_gt", "valid_next_gt", "shape")
    return [_tile(d[k], n) for k in keys]


def _gmm_args(d, cov, n=1):
    ego = np.concatenate([EGO_ROWS + A * i for i in range(n)])
    return ([_tile(d["token_traj"], n), _tile(d["token_traj_all"], n), ego,
             _tile(d["ego_logits"], n), _tile(d["ego_poses"], n),
             np.asarray(cov, np.float32)]
            + [_tile(d[k], n) for k in ("pos_now", "head_now", "pos_next_gt",
                                        "head_next_gt", "valid_next_gt",
                                        "shape", "next_token_idx")])


def _port_token(args, seed, **kw):
    return sampling.sample_next_token_traj(
        torch.Generator().manual_seed(seed),
        *(torch.from_numpy(np.asarray(a)) for a in args), **kw)


def _port_gmm(args, seed, **kw):
    return sampling.sample_next_gmm_traj(
        torch.Generator().manual_seed(seed),
        *(torch.from_numpy(np.asarray(a)) for a in args), **kw)


CRITERIA = ["topk_prob", "topk_prob_sampled_with_dist",
            "topk_dist_sampled_with_prob"]


@pytest.mark.parametrize("criterium", CRITERIA)
def test_token_sampler_deterministic_limit(criterium):
    args = _token_args(_sampler_inputs())
    idx, traj = _port_token(args, 0, criterium=criterium, num_k=1)
    jidx, jtraj = jsampling.sample_next_token_traj(
        jax.random.PRNGKey(0), *args, criterium=criterium, num_k=1)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(traj.numpy(), np.asarray(jtraj))


@pytest.mark.parametrize("criterium", CRITERIA[:2])
def test_gmm_sampler_deterministic_limit(criterium):
    args = _gmm_args(_sampler_inputs(), [0.0, 0.0])
    idx, traj = _port_gmm(args, 0, criterium=criterium, num_k=1)
    jidx, jtraj = jsampling.sample_next_gmm_traj(
        jax.random.PRNGKey(0), *args, criterium=criterium, num_k=1)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    others = np.setdiff1d(np.arange(A), EGO_ROWS)
    np.testing.assert_array_equal(traj.numpy()[others],
                                  np.asarray(jtraj)[others])
    np.testing.assert_allclose(traj.numpy(), np.asarray(jtraj),
                               atol=CONTOUR_TOL, rtol=0)
    # the ego rows were resampled: their trajectories end off the decoded
    # tokens' ends
    assert not np.allclose(traj.numpy()[EGO_ROWS, -1],
                           args[1][EGO_ROWS, args[-1][EGO_ROWS], -1])


def _row_hist(idx, rows, vocab):
    """Histogram of (row, token) over the tiled draws."""
    idx = np.asarray(idx).reshape(-1, rows)
    cells = (np.arange(rows)[None] * vocab + idx).reshape(-1)
    return np.bincount(cells, minlength=rows * vocab).astype(np.float64)


@pytest.mark.parametrize("criterium", CRITERIA)
def test_token_sampler_in_distribution(criterium):
    d = _sampler_inputs()
    args = _token_args(d, N_DRAWS)
    idx, _ = _port_token(args, 1, criterium=criterium, num_k=5)
    jidx, _ = jsampling.sample_next_token_traj(
        jax.random.PRNGKey(1), *args, criterium=criterium, num_k=5)
    p = _chi2_two_sample(_row_hist(idx, A, V), _row_hist(jidx, A, V))
    assert p > ACCEPT_P, p
    if criterium == "topk_prob":
        # power: +1 on each row's second-best logit moves the port's draws
        shifted = d["logits"].copy()
        second = np.argsort(-shifted, axis=1)[:, 1]
        shifted[np.arange(A), second] += 1.0
        args[2] = _tile(shifted, N_DRAWS)
        bad, _ = _port_token(args, 1, criterium=criterium, num_k=5)
        p_bad = _chi2_two_sample(_row_hist(bad, A, V), _row_hist(jidx, A, V))
        assert p_bad < REJECT_P, p_bad


@pytest.mark.parametrize("criterium", CRITERIA[:2])
def test_gmm_sampler_in_distribution(criterium):
    args = _gmm_args(_sampler_inputs(), [0.3, 0.05], N_DRAWS)
    idx, traj = _port_gmm(args, 2, criterium=criterium, num_k=5)
    jidx, jtraj = jsampling.sample_next_gmm_traj(
        jax.random.PRNGKey(2), *args, criterium=criterium, num_k=5)
    ego = args[2]
    h = _row_hist(idx.numpy()[ego], len(EGO_ROWS), V)
    jh = _row_hist(np.asarray(jidx)[ego], len(EGO_ROWS), V)
    assert _chi2_two_sample(h, jh) > ACCEPT_P
    # the sampled end contour's first corner, per ego row
    end, jend = traj.numpy()[ego, -1, 0], np.asarray(jtraj)[ego, -1, 0]
    for r in range(len(EGO_ROWS)):
        for c in range(2):
            p = stats.ks_2samp(end[r::len(EGO_ROWS), c],
                               jend[r::len(EGO_ROWS), c]).pvalue
            assert p > ACCEPT_P, (r, c, p)
