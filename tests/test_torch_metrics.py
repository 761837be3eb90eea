"""The port's WOSAC metric modules (infgen_torch/metrics/{features,
map_distance,wosac,train_metrics}.py) held against the JAX package's on the
CPU, on the same seeded numpy inputs: A = 12 agent slots (two inactive,
one with NaN-padded invalid frames), T10 = 101 frames, so that the 90
frames past the history unfold into 3 windows of 80.

The JAX side runs jitted, as its command line and offline scorer run it:
one compile of every function at one shape (`jax_all`). Tolerances:
  - float features: 1e-5 abs and relative; distances 1e-4 abs; linear
    accelerations 1e-5 on top of what their speeds' difference carries
    into them (assert_accel);
  - booleans exact, except where certified near their threshold: a
    distance within 1e-5 of it, or a wrapped angle within 1e-5 of +-pi;
  - histogram bins exact, on every edge and on its float32 neighbours;
  - log-probabilities and likelihoods 1e-6 (on the same features);
  - the aggregation 1e-12 (float64 numpy on both sides).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infgen_tpu.metrics import features as JF
from infgen_tpu.metrics import map_distance as JMD
from infgen_tpu.metrics import train_metrics as JTM
from infgen_tpu.metrics import wosac as JW

from infgen_torch.config import Config
from infgen_torch.data.synthetic import make_synthetic_scenario
from infgen_torch.metrics import features as F
from infgen_torch.metrics import map_distance as MD
from infgen_torch.metrics import train_metrics as TM
from infgen_torch.metrics import wosac as W

from test_torch_layers import one_torch_thread  # noqa: F401 (autouse)

A, T10, T_TOK, K, GRID = 12, 101, 20, 3, 40
FEAT_TOL = 1e-5          # float features, abs and relative
DIST_TOL = 1e-4          # distances, abs
NEAR = 1e-5              # a certified near-threshold flip
LL_TOL = 1e-6            # log-probabilities and likelihoods
AGG_TOL = 1e-12          # float64 aggregation
WCFG, JWCFG = W.WosacConfig(), JW.WosacConfig()


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def make_inputs(seed=0):
    """One scenario's seeded numpy arrays."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    start = rng.uniform(-20, 20, (A, 1, 2))
    start[3] = start[0] + [2.5, 0.5]            # close pairs: collisions
    start[4] = start[0] + [-3.0, 1.0]
    vel = rng.normal(0, 4, (A, 1, 2))
    # agent 8 drives 8 m ahead of agent 1, slower: a time to collision
    start[8] = start[1] + 8.0 * vel[1] / np.linalg.norm(vel[1])
    vel[8] = 0.5 * vel[1]
    xy = start + vel * np.arange(T10)[None, :, None] * 0.1 \
        + np.cumsum(rng.normal(0, 0.05, (A, T10, 2)), 1)
    heading = np.arctan2(vel[..., 1], vel[..., 0]) \
        + np.cumsum(rng.normal(0, 0.03, (A, T10)), 1)
    heading[5] = math.pi - 0.02 + np.cumsum(rng.normal(0, 0.02, T10))
    heading = np.arctan2(np.sin(heading), np.cos(heading))  # wraps at +-pi
    z = np.cumsum(rng.normal(0, 0.05, (A, T10)), 1)
    valid = rng.uniform(size=(A, T10)) > 0.05
    valid[2, :15] = False
    valid[6, 60:] = False
    valid[7, :5] = False
    xy[7, :5] = np.nan                          # NaN padding, invalid
    heading[7, :5] = np.nan
    slot_mask = np.arange(A) < 10
    xy[10:] = 0.0
    heading[10:] = 0.0
    valid[10:] = False
    length = rng.uniform(2, 5, A)
    width = rng.uniform(1, 2, A)
    token_pos = xy[:, ::5][:, :T_TOK]
    state = rng.choice(4, (A, T_TOK), p=[0.2, 0.5, 0.15, 0.15])
    state[1] = 1                                # the ego
    grid_index = np.where(rng.uniform(size=(A, T_TOK)) < 0.2, -1,
                          rng.integers(0, GRID, (A, T_TOK)))
    xy0 = np.nan_to_num(xy)
    pred_k = xy0[:, None] + rng.normal(0, 1.0, (A, K, T10, 2))
    return dict(xy=xy.astype(f32), xy0=xy0.astype(f32),
                heading=heading.astype(f32),
                z=z.astype(f32), valid=valid, slot_mask=slot_mask,
                length=length.astype(f32), width=width.astype(f32),
                av_index=np.int32(1), token_pos=token_pos.astype(f32),
                token_state=state.astype(np.int32),
                gt_state=np.roll(state, 1, 1).astype(np.int32),
                grid_index=grid_index.astype(np.int32),
                pred_k=pred_k.astype(f32),
                pred_topk=rng.integers(0, 6, (A, T_TOK, 4)).astype(np.int32),
                target=rng.integers(0, 6, (A, T_TOK)).astype(np.int32))


def make_road_edges():
    """Two open road edges (one with elevation) and one closed loop,
    packed and padded as the rollout's are."""
    xs = np.linspace(-40, 40, 30)
    south = np.stack([xs, np.full_like(xs, -15.0) + 0.2 * np.sin(xs)], -1)
    north = np.stack([xs[::-1], np.full_like(xs, 18.0),
                      np.linspace(0, 2, 30)], -1)
    side = np.linspace(0, 8, 5)[:-1]
    loop = np.concatenate([
        np.stack([6 + side, np.full(4, 6.0)], -1),
        np.stack([np.full(4, 14.0), 6 + side], -1),
        np.stack([14 - side, np.full(4, 14.0)], -1),
        np.stack([np.full(4, 6.0), 14 - side], -1),
        [[6.0, 6.0]]])
    return JMD.pad_packed_polylines(*JMD.pack_polylines([south, north, loop]))


@pytest.fixture(scope="module")
def inputs():
    d = make_inputs()
    d["road_edges"], d["road_cyclic"] = make_road_edges()
    return d


def _jax_all(d):
    """Every JAX function of the test at the module's one shape."""
    x, y = d["xy"][..., 0], d["xy"][..., 1]
    box = (x, y, d["length"], d["width"], d["heading"], d["valid"],
           d["slot_mask"])
    out = {}
    out["kin3"] = JF.compute_kinematic_features(x, y, d["z"], d["heading"])
    out["kin_valid"] = JF.compute_kinematic_validity(d["valid"])
    out["nearest"] = JF.compute_distance_to_nearest_object(*box)
    out["ttc"] = JF.compute_time_to_collision(*box)
    out["road"] = JMD.compute_distance_to_road_edge(
        *box, d["road_edges"], d["road_cyclic"])
    out["num_place"] = JF.compute_num_placement(
        d["token_state"], d["av_index"], d["slot_mask"])
    out["dist_place"] = JF.compute_distance_placement(
        d["token_pos"], d["token_state"], d["av_index"], d["slot_mask"])
    common = (d["xy"], d["heading"], d["valid"], d["length"], d["width"],
              d["slot_mask"], d["av_index"], d["token_pos"],
              d["token_state"])
    log = JF.compute_metric_features(*common, d["road_edges"],
                                     d["road_cyclic"], traj_z=d["z"])
    sim = JF.compute_metric_features(*common)
    out["log"], out["sim"] = log, sim
    out["unfold"] = JF.unfold_features(log)
    out["log_dist"] = JW.make_log_distributions(JWCFG, log)
    out["metrics"] = JW.compute_scenario_metrics(JWCFG, out["log_dist"], sim)
    # train metrics, on positions without NaN (see test_train_metrics)
    pred, tgt = d["xy0"] + 0.5, d["xy0"]
    vm = d["valid"] & d["slot_mask"][:, None]
    out["train"] = dict(
        token_cls=JTM.token_cls_accuracy(d["pred_topk"], d["target"],
                                         d["token_state"] > 0, 2),
        min_ade=JTM.min_ade(pred, tgt, vm),
        min_fde=JTM.min_fde(pred, tgt, vm),
        state_acc=JTM.state_accuracy(d["token_state"]),
        grid=JTM.grid_overlap_rate(d["token_state"], d["grid_index"], GRID),
        multi_ade=JTM.min_multi_ade(d["pred_k"], tgt, vm),
        multi_ade_ade=JTM.min_multi_ade(d["pred_k"], tgt, vm, "ADE"),
        multi_fde=JTM.min_multi_fde(d["pred_k"], tgt, vm),
        insert=JTM.num_insert_accuracy(d["token_state"], d["gt_state"]))
    return out


@pytest.fixture(scope="module")
def jax_all(inputs):
    return jax.tree.map(np.asarray, jax.jit(_jax_all)(inputs))


def _port_box(d):
    return (_t(d["xy"][..., 0]), _t(d["xy"][..., 1]), _t(d["length"]),
            _t(d["width"]), _t(d["heading"]), _t(d["valid"]),
            _t(d["slot_mask"]))


def _port_common(d):
    return (_t(d["xy"]), _t(d["heading"]), _t(d["valid"]), _t(d["length"]),
            _t(d["width"]), _t(d["slot_mask"]), _t(d["av_index"]),
            _t(d["token_pos"]), _t(d["token_state"]))


def assert_float(port, ref, atol=FEAT_TOL, rtol=FEAT_TOL, what=""):
    np.testing.assert_allclose(_np(port), np.asarray(ref), atol=atol,
                               rtol=rtol, equal_nan=True, err_msg=what)


def assert_accel(a_port, a_ref, s_port, s_ref, dt=F.SECONDS_PER_STEP):
    """linear_acceleration, the central difference of linear_speed over
    dt: held to FEAT_TOL on top of what the two sides' speeds, each held
    to FEAT_TOL, carry into it ((|ds(t-1)| + |ds(t+1)|) / (2 dt), edges
    replicated). XLA's fusions round a speed's last bit in their own way
    (contracted multiply-adds), and 1 / (2 dt) = 5 amplifies it."""
    a_port, a_ref = _np(a_port), np.asarray(a_ref)
    ds = np.nan_to_num(np.abs(_np(s_port) - np.asarray(s_ref)))
    pad = np.pad(ds, [(0, 0)] * (ds.ndim - 1) + [(1, 1)], mode="edge")
    carry = (pad[..., :-2] + pad[..., 2:]) / (2 * dt)
    err = np.abs(a_port - a_ref)
    ok = (err <= FEAT_TOL + FEAT_TOL * np.abs(a_ref) + carry) | \
        (np.isnan(a_port) & np.isnan(a_ref))
    assert ok.all(), f"linear_acceleration: {int((~ok).sum())} beyond"


def assert_bool_certified(port, ref, dist, threshold=0.0, what=""):
    """Booleans equal, except where the JAX side's distance lies within
    NEAR of the threshold (both sides then decide on fp32 noise)."""
    port, ref = _np(port).astype(bool), np.asarray(ref).astype(bool)
    flip = port != ref
    near = np.abs(np.asarray(dist) - threshold) < NEAR
    assert not (flip & ~near).any(), \
        f"{what}: {int((flip & ~near).sum())} uncertified flips"


# --------------------------------------------------------------------- #
# features.py
# --------------------------------------------------------------------- #

def test_wrap_is_floor_mod():
    """_wrap at, near and far from +-pi (the rest of the file's inputs
    reach it through the kinematics)."""
    pi = np.float32(np.pi)
    a = np.concatenate([
        np.linspace(-12, 12, 241, dtype=np.float32),
        [pi, -pi, 3 * pi, -3 * pi, np.nextafter(pi, 4), np.nextafter(-pi, -4),
         0.0, np.nan]]).astype(np.float32)
    got = _np(F._wrap(_t(a)))
    ref = np.asarray(JF._wrap(a))
    # the same floor-mod; a value within NEAR of an odd multiple of pi may
    # land on either end of the range
    k = np.abs(np.remainder(a.astype(np.float64) + np.pi, 2 * np.pi))
    near_pi = (np.minimum(k, 2 * np.pi - k) < NEAR)
    ok = np.isclose(got, ref, atol=FEAT_TOL, rtol=FEAT_TOL, equal_nan=True)
    assert (ok | near_pi).all()
    assert (got[~np.isnan(got)] >= -np.pi - 1e-6).all()
    assert (got[~np.isnan(got)] < np.pi + 1e-6).all()


def test_central_diff_and_validity(inputs):
    d = inputs
    for pad in (np.nan, 0.0):
        assert_float(F.central_diff(_t(d["heading"]), pad),
                     JF.central_diff(d["heading"], pad))
    for got, ref in zip(F.compute_kinematic_validity(_t(d["valid"])),
                        JF.compute_kinematic_validity(d["valid"])):
        np.testing.assert_array_equal(_np(got), np.asarray(ref))
    np.testing.assert_array_equal(
        _np(F.central_logical_and(_t(d["valid"]), True)),
        np.asarray(JF.central_logical_and(d["valid"], True)))


def test_kinematic_features(inputs, jax_all):
    d = inputs
    x, y = _t(d["xy"][..., 0]), _t(d["xy"][..., 1])
    got = F.compute_kinematic_features(x, y, _t(d["z"]), _t(d["heading"]))
    for name, g, r in zip(("speed", "accel", "dh", "d2h"), got,
                          jax_all["kin3"]):
        if name == "accel":
            assert_accel(g, r, got[0], jax_all["kin3"][0])
        else:
            assert_float(g, r, what=name)


def test_box_geometry_helpers(inputs):
    """box_corners_2d, _downmost_edge_xy, _select_vertex,
    _minkowski_sum_xy and _signed_distance_origin_xy on one pair set, each
    JAX function jitted alone on the inputs the port's gets."""
    d = inputs
    x, y, h = d["xy"][:10, :, 0], d["xy"][:10, :, 1], d["heading"][:10]
    x, y, h = (np.nan_to_num(v) for v in (x, y, h))
    lw = [np.broadcast_to(d[k][:10, None], x.shape).astype(np.float32)
          for k in ("length", "width")]
    jc = np.asarray(jax.jit(JF.box_corners_2d)(x, y, *lw, h))
    tc = F.box_corners_2d(_t(x), _t(y), _t(lw[0]), _t(lw[1]), _t(h))
    assert_float(tc, jc, atol=DIST_TOL, what="corners")
    bx, by = jc[..., 0].swapaxes(-1, -2), jc[..., 1].swapaxes(-1, -2)
    edge = jax.jit(JF._downmost_edge_xy)
    js = edge(bx, by)
    ts = F._downmost_edge_xy(_t(bx), _t(by))
    np.testing.assert_array_equal(_np(ts[0]), np.asarray(js[0]))
    for g, r in zip(ts[1:], js[1:]):
        assert_float(g, r)
    order = np.random.default_rng(1).integers(0, 4, (10, 8, x.shape[1]))
    np.testing.assert_array_equal(
        _np(F._select_vertex(_t(bx), _t(order))),
        np.asarray(jax.jit(JF._select_vertex)(bx, order)))
    js2 = edge(-bx, -by)
    jp = jax.jit(JF._minkowski_sum_xy)(bx[:, None], by[:, None],
                                       js[0][:, None],
                              js[1][:, None], js[2][:, None], -bx[None],
                              -by[None], js2[0][None], js2[1][None],
                              js2[2][None])
    tp = F._minkowski_sum_xy(
        _t(bx)[:, None], _t(by)[:, None], _t(js[0])[:, None],
        _t(js[1])[:, None], _t(js[2])[:, None], -_t(bx)[None],
        -_t(by)[None], _t(js2[0])[None], _t(js2[1])[None], _t(js2[2])[None])
    # within DIST_TOL, not bitwise: jitted, XLA contracts the edges' cross
    # product into a fused multiply-add, so parallel edges (equal headings)
    # may take the other order, which lists the same 8-gon's vertices as
    # other float32 sums; a wrong order would be metres off
    for g, r in zip(tp, jp):
        assert_float(g, r, atol=DIST_TOL, rtol=0, what="minkowski")
    px, py = (np.asarray(v) for v in jp)
    assert_float(F._signed_distance_origin_xy(_t(px), _t(py)),
                 jax.jit(JF._signed_distance_origin_xy)(px, py),
                 atol=DIST_TOL,
                 rtol=0)


def test_distance_to_nearest_object(inputs, jax_all):
    ref = jax_all["nearest"]
    for chunk in (32, 5):                     # the chunk does not matter
        got = F.compute_distance_to_nearest_object(*_port_box(inputs),
                                                   eval_chunk=chunk)
        assert_float(got, ref, atol=DIST_TOL, rtol=0)
        assert_bool_certified(got < 0, ref < 0, ref, what="collision")
    assert (ref[:10] < 0).any(), "the inputs make no collision"


def test_time_to_collision(inputs, jax_all):
    got = F.compute_time_to_collision(*_port_box(inputs))
    ref = jax_all["ttc"]
    assert_float(got, ref, atol=DIST_TOL, rtol=FEAT_TOL)
    assert (ref < F.MAXIMUM_TIME_TO_COLLISION).any(), "no object in front"


def test_placement(inputs, jax_all):
    d = inputs
    args = (_t(d["token_state"]), _t(d["av_index"]), _t(d["slot_mask"]))
    for g, r in zip(F.compute_num_placement(*args), jax_all["num_place"]):
        np.testing.assert_array_equal(_np(g), np.asarray(r))
    got = F.compute_distance_placement(_t(d["token_pos"]), *args)
    for g, r in zip(got, jax_all["dist_place"]):
        assert_float(g, r, atol=DIST_TOL)


@pytest.mark.parametrize("kind", ["log", "sim"])
def test_metric_features(inputs, jax_all, kind):
    """The bundle: log features (elevation, road edges) and simulated ones
    (planar, no road edges)."""
    d = inputs
    extra = dict(traj_z=_t(d["z"])) if kind == "log" else {}
    edges = (_t(d["road_edges"]), _t(d["road_cyclic"])) if kind == "log" \
        else (None, None)
    got = F.compute_metric_features(*_port_common(d), *edges, **extra)
    ref = jax_all[kind]
    assert got._fields == JF.MetricFeatures._fields
    for name in got._fields:
        g, r = getattr(got, name), np.asarray(getattr(ref, name))
        assert tuple(g.shape) == r.shape, name
        if name == "collision_per_step":
            assert_bool_certified(g, r, ref.distance_to_nearest_object,
                                  what=name)
        elif name == "offroad_per_step":
            assert_bool_certified(g, r, ref.distance_to_road_edge, what=name)
        elif r.dtype.kind in "biu":
            np.testing.assert_array_equal(_np(g), r, err_msg=name)
        elif "distance" in name:
            assert_float(g, r, atol=DIST_TOL, rtol=0, what=name)
        elif name == "linear_acceleration":
            assert_accel(g, r, got.linear_speed, ref.linear_speed)
        else:
            assert_float(g, r, what=name)
    if kind == "log":
        assert np.asarray(ref.offroad_per_step).any()
        assert not np.asarray(ref.offroad_per_step).all()


def test_unfold_windows_bitwise(inputs, jax_all):
    """unfold_axis as Tensor.unfold: the same windows, bit for bit, on the
    JAX features; unfold_features' shapes and token-rate windows."""
    log = jax_all["log"]
    port = F.MetricFeatures(*(_t(v) for v in log))
    got, ref = F.unfold_features(port), jax_all["unfold"]
    for name in got._fields:
        np.testing.assert_array_equal(_np(getattr(got, name)),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert got.valid.shape[-2:] == (3, 80)
    assert got.num_placement.shape[-2:] == (3, 16)
    x = np.arange(2 * 37, dtype=np.float32).reshape(2, 37)
    np.testing.assert_array_equal(_np(F.unfold_axis(_t(x), 7, 3)),
                                  np.asarray(JF.unfold_axis(x, 7, 3)))


# --------------------------------------------------------------------- #
# map_distance.py
# --------------------------------------------------------------------- #

def test_pack_polylines_match():
    rng = np.random.default_rng(3)
    polys = [rng.normal(size=(n, d)).astype(np.float32)
             for n, d in ((5, 2), (1, 2), (9, 3), (3, 2))]
    polys.append(np.array([[0, 0], [1, 0], [1, 1], [0, 0.2]], np.float32))
    for got, ref in zip(MD.pack_polylines(polys), JMD.pack_polylines(polys)):
        np.testing.assert_array_equal(got, ref)
    for got, ref in zip(MD.pad_packed_polylines(*MD.pack_polylines(polys)),
                        JMD.pad_packed_polylines(*JMD.pack_polylines(polys))):
        np.testing.assert_array_equal(got, ref)
    for got, ref in zip(MD.pack_polylines([]), JMD.pack_polylines([])):
        np.testing.assert_array_equal(got, ref)


def test_road_edges_from_map():
    """The synthetic map's road edges (pt_type 15) through both packages'
    host-side rebuild; a map without road edges gives (None, None)."""
    scen = make_synthetic_scenario(Config(max_map_tokens=1024), seed=0)
    got = MD.packed_road_edges(scen.map)
    ref = JMD.packed_road_edges(scen.map)
    assert got[0] is not None and got[0].shape[0] > 0
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    for g, r in zip(MD.road_edge_polylines_from_map(scen.map, 1, 1),
                    JMD.road_edge_polylines_from_map(scen.map, 1, 1)):
        np.testing.assert_array_equal(g, r)
    none = scen.map._replace(pt_type=np.zeros_like(scen.map.pt_type))
    assert MD.packed_road_edges(none) == (None, None)


def test_signed_distance_to_polylines(inputs):
    """Points around and on the polylines; the result does not depend on
    the chunk of points."""
    poly, cyc = inputs["road_edges"], inputs["road_cyclic"]
    rng = np.random.default_rng(4)
    pts = np.concatenate([
        np.c_[rng.uniform(-45, 45, (300, 2)), rng.uniform(0, 2, 300)],
        np.c_[poly[2, :12, :2] + 1e-3, np.zeros(12)]]).astype(np.float32)
    ref = np.asarray(jax.jit(JMD.signed_distance_to_polylines)(
        pts, poly, cyc, 3.0))
    L, S = poly.shape[0], poly.shape[1] - 1
    for chunk in (MD.POINT_CHUNK_ELEMENTS, 7 * L * S):
        got = MD.signed_distance_to_polylines(_t(pts), _t(poly), _t(cyc),
                                              3.0, chunk_elements=chunk)
        assert_float(got, ref, atol=DIST_TOL, rtol=0)
    assert (ref < 0).any() and (ref > 0).any()


def test_distance_to_road_edge(inputs, jax_all):
    d = inputs
    got = MD.compute_distance_to_road_edge(
        *_port_box(d), _t(d["road_edges"]), _t(d["road_cyclic"]))
    assert_float(got, jax_all["road"], atol=DIST_TOL, rtol=0)


# --------------------------------------------------------------------- #
# wosac.py
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def edge_values():
    """Per spec: every JAX edge (jnp.linspace under jit, as the scoring
    computes it), its float32 neighbours, and values off the range."""
    edges = jax.tree.map(np.asarray, jax.jit(lambda: {
        f: jnp.linspace(getattr(JWCFG, f).min_val, getattr(JWCFG, f).max_val,
                        getattr(JWCFG, f).num_bins + 1)
        for f in JWCFG.fields()})())
    vals = {}
    for f, e in edges.items():
        up = np.nextafter(e, np.float32(np.inf))
        down = np.nextafter(e, np.float32(-np.inf))
        # an edge of 0 has subnormal neighbours, which XLA's CPU backend
        # flushes to zero (it bins -1e-45 as 0) while torch keeps them, on
        # the CPU and in CUDA: there the neighbours are the smallest normals
        tiny = np.finfo(np.float32).tiny
        up, down = np.where(e == 0, tiny, up), np.where(e == 0, -tiny, down)
        v = np.concatenate([e, up, down,
                            [np.nan, np.inf, -np.inf, e[0] - 1, e[-1] + 1,
                             (e[0] + e[-1]) / 2]]).astype(np.float32)
        vals[f] = v
    bins = jax.tree.map(np.asarray, jax.jit(lambda vs: {
        f: (JW._uniform_bin_index(getattr(JWCFG, f), v),
            JW._histogram_log_probs(getattr(JWCFG, f), v),
            JW._value_log_likelihood(
                getattr(JWCFG, f), JW._histogram_log_probs(
                    getattr(JWCFG, f), v), v))
        for f, v in vs.items()})(vals))
    return edges, vals, bins


def test_bin_edges_bitwise(edge_values):
    edges = edge_values[0]
    for f in WCFG.fields():
        np.testing.assert_array_equal(W.bin_edges(getattr(WCFG, f)),
                                      edges[f], err_msg=f)


def test_bin_index_and_histograms(edge_values):
    """_uniform_bin_index exact on every edge and its neighbours;
    _histogram_log_probs and _value_log_likelihood within LL_TOL."""
    _, vals, bins = edge_values
    for f in WCFG.fields():
        spec, v = getattr(WCFG, f), _t(vals[f])
        jb, jlp, jll = bins[f]
        np.testing.assert_array_equal(_np(W._uniform_bin_index(spec, v)), jb,
                                      err_msg=f)
        lp = W._histogram_log_probs(spec, v)
        assert_float(lp, jlp, atol=LL_TOL, rtol=0, what=f)
        assert_float(W._value_log_likelihood(spec, lp, v), jll, atol=LL_TOL,
                     rtol=0, what=f)


def test_avg_valid_and_mean_finite():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(6, 4, 9)).astype(np.float32)
    x[0, 0, 0] = np.inf
    x[1, 1] = -np.inf
    m = rng.uniform(size=x.shape) > 0.3
    m[2, 2] = False
    y, means = jax.jit(lambda x, m: (
        JW._avg_valid(x, m), [JW._mean_finite(JW._avg_valid(x, m), axis=a)
                              for a in (None, 0)]))(x, m)
    assert_float(W._avg_valid(_t(x), _t(m)), y, what="avg")
    y = np.asarray(y)
    for axis, ref in zip((None, 0), means):
        assert_float(W._mean_finite(_t(y), dim=axis), ref,
                     what=f"mean {axis}")


def test_make_log_distributions(jax_all):
    """The same log features through both packages' histograms."""
    log = F.MetricFeatures(*(_t(v) for v in jax_all["log"]))
    got = W.make_log_distributions(WCFG, log)
    assert got._fields == JW.LogDistributions._fields
    for name in got._fields:
        assert_float(getattr(got, name), getattr(jax_all["log_dist"], name),
                     atol=LL_TOL, rtol=0, what=name)


def test_compute_scenario_metrics(jax_all):
    """The same simulated features and log histograms through both
    packages' scoring: every key, every likelihood and curve within
    LL_TOL; metrics_to_host reads them in one copy."""
    sim = F.MetricFeatures(*(_t(v) for v in jax_all["sim"]))
    ld = W.LogDistributions(*(_t(v) for v in jax_all["log_dist"]))
    got = W.compute_scenario_metrics(WCFG, ld, sim)
    ref = jax_all["metrics"]         # its keys sorted by jax.tree
    assert sorted(got) == list(ref)
    for k in ref:
        assert_float(got[k], ref[k], atol=LL_TOL, rtol=0, what=k)
    host = W.metrics_to_host(got)
    assert list(host) == list(got)
    for k, v in host.items():
        assert isinstance(v, float if np.ndim(ref[k]) == 0 else list), k
        np.testing.assert_array_equal(np.asarray(v, np.float32), _np(got[k]))
    assert 0 < host["metametric"] <= 1


def _per_scenario(seed):
    """Scenario dicts as the scorer returns them, with zeros, -inf and NaN
    in the curves and zero placement likelihoods."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(5):
        m = {"metametric": rng.uniform(0.2, 0.8),
             "simulated_collision_rate": rng.uniform(),
             "simulated_offroad_rate": rng.uniform()}
        for f in WCFG.fields():
            m[f"{f}_likelihood"] = 0.0 if (f.startswith("distance_pl")
                                           and s % 2) else rng.uniform()
        for k in ["metametric"] + [f"{f}_likelihood" for f in WCFG.fields()]:
            curve = rng.uniform(size=3)
            curve[s % 3] = [0.0, -np.inf, np.nan][s % 3]
            m[f"wosac_long/{k}"] = curve.tolist()
        out.append(m)
    return out


def test_aggregate_scenario_metrics():
    rows = _per_scenario(6)
    got = W.aggregate_scenario_metrics(WCFG, rows)
    ref = JW.aggregate_scenario_metrics(JWCFG, rows)
    assert list(got) == list(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(v, np.float64), atol=AGG_TOL,
                                   rtol=0, err_msg=k)
    curves = np.stack([r["wosac_long/metametric"] for r in rows])
    np.testing.assert_allclose(W._reduce_mean_curves(curves),
                               JW._reduce_mean_curves(curves), atol=AGG_TOL,
                               rtol=0)
    assert W.aggregate_scenario_metrics(WCFG, []) == \
        JW.aggregate_scenario_metrics(JWCFG, [])


TEXTPROTO = """# a small metric config in the reference's format
linear_speed: {
  histogram: {
    min_val: 0.0
    max_val: 30.0
    num_bins: 12
    additive_smoothing_pseudocount: 0.2
  }
  metametric_weight: 0.1
}
collision_indication: {
  bernoulli: {
    additive_smoothing_pseudocount: 0.3
  }
  metametric_weight: 0.25
}
distance_to_road_edge: {
  histogram: {
    min_val: -20.0
    max_val: 40.0
    num_bins: 10
  }
  metametric_weight: 0.05
}
time_to_collision: {
  histogram: {
    min_val: 0.0
    max_val: 5.0
    num_bins: 10
  }
  # no weight: 0
}
"""


def test_wosac_config_from_textproto(tmp_path):
    path = tmp_path / "metric_config.textproto"
    path.write_text(TEXTPROTO)
    got = W.WosacConfig.from_textproto(str(path))
    ref = JW.WosacConfig.from_textproto(str(path))
    for f in WCFG.fields():
        assert dataclasses.astuple(getattr(got, f)) == \
            dataclasses.astuple(getattr(ref, f)), f
    assert got.linear_speed == W.HistogramSpec(0.0, 30.0, 12, 0.2, 0.1)
    assert got.time_to_collision.weight == 0.0
    assert got.angular_speed == WCFG.angular_speed      # default kept


# --------------------------------------------------------------------- #
# train_metrics.py
# --------------------------------------------------------------------- #

def test_train_metrics(inputs, jax_all):
    """The eight validation metrics. Their positions carry no NaN, as a
    rollout's and a log's do not (invalid frames hold 0): where a NaN sits
    on a masked-out step, the JAX package's bool products give 0 or NaN as
    XLA does or does not rewrite each one as a select; the port selects."""
    d = inputs
    pred, tgt = _t(d["xy0"] + 0.5), _t(d["xy0"])
    vm = _t(d["valid"] & d["slot_mask"][:, None])
    st = _t(d["token_state"])
    got = dict(
        token_cls=TM.token_cls_accuracy(_t(d["pred_topk"]), _t(d["target"]),
                                        st > 0, 2),
        min_ade=TM.min_ade(pred, tgt, vm),
        min_fde=TM.min_fde(pred, tgt, vm),
        state_acc=TM.state_accuracy(st),
        grid=TM.grid_overlap_rate(st, _t(d["grid_index"]), GRID),
        multi_ade=TM.min_multi_ade(_t(d["pred_k"]), tgt, vm),
        multi_ade_ade=TM.min_multi_ade(_t(d["pred_k"]), tgt, vm, "ADE"),
        multi_fde=TM.min_multi_fde(_t(d["pred_k"]), tgt, vm),
        insert=TM.num_insert_accuracy(st, _t(d["gt_state"])))
    ref = jax_all["train"]
    assert set(got) == set(ref)
    for k, r in ref.items():
        g = got[k]
        if isinstance(r, dict):
            assert set(g) == set(r), k
            pairs = [(f"{k}.{n}", g[n], r[n]) for n in r]
        else:
            pairs = [(f"{k}[{i}]", gi, ri) for i, (gi, ri) in
                     enumerate(zip(g, r))]
        for what, gi, ri in pairs:
            ri = np.asarray(ri)
            if ri.dtype.kind in "biu":
                np.testing.assert_array_equal(_np(gi), ri, err_msg=what)
            else:
                assert_float(gi, ri, atol=DIST_TOL, what=what)
    assert int(ref["grid"]["num_overlap_t"].sum()) > 0
    assert int(ref["state_acc"]["invalid_count"]) > 0
