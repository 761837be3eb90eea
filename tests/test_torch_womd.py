"""The port's WOMD input pipeline (data/womd_proto.py, native.py,
preprocess.py, waymo.py) held against the JAX package's on the CPU, on the
same protobuf bytes, and `--data-dir` through the port's entry points.

The bytes come from data/womd_synthetic.py (a seeded numpy generator:
tracks with invalid gaps, "other" tracks, lights, lanes, lines, edges,
crosswalks) and from hand-written wire-format messages (the cases of
tests/test_womd_proto_adversarial.py that need no reference checkout).
Decoding, preprocessing, pickles and WaymoDataset scenarios must equal the
JAX package's array for array; both sides split polylines natively (the
port's own build of its copy of the C++ helper, the JAX package's
committed library), and the two native splitters must agree bit for bit.
Against the port's numpy splitter the native one agrees within 1e-4.
"""

import json
import os
import pickle
import struct
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from infgen_tpu.config import Config as JConfig
from infgen_tpu.data import native as j_native
from infgen_tpu.data import preprocess as JPP
from infgen_tpu.data import womd_proto as JW
from infgen_tpu.data.features import build_model_inputs as j_build_inputs
from infgen_tpu.data.waymo import WaymoDataset as JWaymo
from infgen_tpu.data.waymo import pkl_to_scenario as j_pkl_to_scenario
from infgen_tpu.tokenizers.attr_tokenizer import AttrTokenizer as JAttr
from infgen_tpu.tokenizers.map_tokenizer import MapTokenizer as JMapTok
from infgen_tpu.tokenizers.map_tokenizer import \
    interpolate_polyline as j_interpolate
from infgen_tpu.tokenizers.motion_tokenizer import MotionTokenizer as JMotion

from infgen_torch import cli
from infgen_torch.config import Config
from infgen_torch.data import native
from infgen_torch.data import preprocess as PP
from infgen_torch.data import womd_proto as W
from infgen_torch.data import womd_synthetic as WS
from infgen_torch.data.features import build_model_inputs
from infgen_torch.data.scenario import to_device
from infgen_torch.data.waymo import WaymoDataset, pkl_to_scenario
from infgen_torch.metrics import offline
from infgen_torch.tokenizers.map_tokenizer import (MapTokenizer,
                                                   interpolate_polyline)

from test_torch_layers import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs", "tiny_smoke.yaml")
# the tiny config's widths (configs/tiny_smoke.yaml) on both sides
CFG = dict(max_agents=16, max_map_tokens=128, hidden_dim=32, num_heads=2,
           head_dim=16, num_freq_bands=8, num_agent_layers=2,
           num_seed_layers=1, num_map_layers=1, num_seed_feature=4)
FILTERED_AGENTS = 5      # below the meta filter's 8


# ---- the bytes ----

@pytest.fixture(scope="module")
def womd(tmp_path_factory):
    """Two tfrecord files of two scenarios (9-14 agents, 3 "other" tracks
    each, about 300 m of map), a third holding one scenario of
    FILTERED_AGENTS agents, preprocessed by the port (two spawned workers)
    and by the JAX package (inline)."""
    root = tmp_path_factory.mktemp("womd")
    raw = root / "raw"
    files = WS.write_womd_files(str(raw), seed=7, files=2, per_file=2,
                                agents=(9, 14), map_length_m=300.0,
                                extra_agents=(FILTERED_AGENTS,))
    port, jax_dir = root / "port", root / "jax"
    meta = PP.main(["--input-dir", str(raw), "--output-dir", str(port),
                    "--num-workers", "2"])
    JPP.main(["--input_dir", str(raw), "--output_dir", str(jax_dir),
              "--num_workers", "1"])
    records = [r for f in files for r in W.iter_tfrecord(f)]
    return dict(root=root, raw=raw, files=files, port=port, jax=jax_dir,
                meta=meta, records=records)


def assert_tree_equal(a, b, path=""):
    """Dicts, lists and arrays equal, dtype for dtype."""
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            assert_tree_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)) and not isinstance(a, str):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tree_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, \
            (path, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def assert_scenarios_equal(port, jax_scen):
    for part in ("agents", "map"):
        for name in getattr(jax_scen, part)._fields:
            a = np.asarray(getattr(getattr(port, part), name))
            b = np.asarray(getattr(getattr(jax_scen, part), name))
            assert a.dtype == b.dtype, (part, name, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=f"{part}.{name}")
    assert int(port.scenario_id) == int(jax_scen.scenario_id)


# ---- hand-written wire format ----

def _varint(v):
    out = b""
    while True:
        b7 = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b7 | 0x80])
        else:
            return out + bytes([b7])


def _tag(field, wt):
    return _varint(field << 3 | wt)


def _ld(field, payload):
    return _tag(field, 2) + _varint(len(payload)) + payload


def test_proto_decodes_hand_written_bytes():
    """tests/test_womd_proto_adversarial.py's cases without the reference
    bindings: unknown fields of every wire type skipped, fields out of
    schema order, a repeated scalar's last occurrence wins, packed and
    expanded repeated doubles mixed, missing optionals at their defaults;
    each decoded equal to the JAX package's decoder."""
    state = (_tag(99, 0) + _varint(12345)
             + _tag(8, 5) + struct.pack("<f", 0.7)
             + _tag(98, 1) + struct.pack("<d", 3.14)
             + _tag(2, 1) + struct.pack("<d", 5.0)
             + _ld(97, b"garbage-submessage")
             + _tag(2, 1) + struct.pack("<d", 6.0)
             + _tag(11, 0) + _varint(1))
    st = W.parse_object_state(state)
    assert st["x"] == pytest.approx(6.0)
    assert st["heading"] == pytest.approx(0.7, abs=1e-6)
    assert st["valid"] is True and st["y"] == 0.0
    assert st == JW.parse_object_state(state)

    mix = (_ld(1, struct.pack("<2d", 0.0, 0.1))
           + _tag(1, 1) + struct.pack("<d", 0.2) + _ld(5, b"mix"))
    out = W.parse_scenario(mix)
    assert out["timestamps_seconds"] == [0.0, 0.1, 0.2]
    assert out["scenario_id"] == "mix"
    assert_tree_equal(out, JW.parse_scenario(mix))

    empty = W.parse_scenario(b"")
    assert (empty["scenario_id"], empty["timestamps_seconds"],
            empty["tracks"], empty["map_features"],
            empty["sdc_track_index"]) == ("", [], [], [], 0)
    with pytest.raises(ValueError, match="wire type"):
        W.parse_fields(_tag(3, 3))


def test_proto_roundtrip_and_framing(womd, tmp_path):
    """The generator's bytes decode to what it wrote and to what the JAX
    package decodes; TFRecord framing with CRC bytes present."""
    raw = WS.random_scenario(np.random.default_rng(0), "round-trip", 10,
                             map_length_m=100.0)
    s = W.parse_scenario(raw)
    assert s["scenario_id"] == "round-trip" and s["sdc_track_index"] == 0
    assert s["current_time_index"] == WS.CURRENT_TIME_INDEX
    assert len(s["tracks"]) == 13 and len(s["tracks"][0]["states"]) == 91
    assert [t["object_type"] for t in s["tracks"][10:]] == [4, 4, 4]
    assert len(s["timestamps_seconds"]) == 91
    kinds = {f["feature_type"] for f in s["map_features"]}
    assert kinds == {"lane", "road_line", "road_edge", "crosswalk",
                     "speed_bump", "stop_sign"}
    assert len(s["dynamic_map_states"]) == WS.CURRENT_TIME_INDEX + 1
    for r in womd["records"][:2] + [raw]:
        assert_tree_equal(W.parse_scenario(r), JW.parse_scenario(r))

    path = tmp_path / "framed.tfrecord"
    payloads = [b"a" * 10, b"bb" * 50, raw]
    with open(path, "wb") as f:
        for p in payloads:
            f.write(struct.pack("<Q", len(p)) + b"\xde\xad\xbe\xef" + p
                    + b"\xca\xfe\xba\xbe")
    assert list(W.iter_tfrecord(str(path))) == payloads
    idx = native.tfrecord_index(str(path))
    assert idx == j_native.tfrecord_index(str(path))
    with open(path, "rb") as f:
        for (off, ln), want in zip(idx, payloads):
            f.seek(off)
            assert f.read(ln) == want


def test_decode_matches_jax(womd):
    """decode_agents, decode_map and scenario_to_pkl_dict (with and without
    the cached map tokens) equal the JAX package's, array for array; the
    "other" tracks are dropped and gaps interpolated."""
    mt, jmt = MapTokenizer(), JMapTok()
    gaps = 0
    for raw in womd["records"]:
        s = W.parse_scenario(raw)
        agents = PP.decode_agents(s)
        assert_tree_equal(agents, JPP.decode_agents(JW.parse_scenario(raw)))
        assert_tree_equal(PP.decode_map(s), JPP.decode_map(s))
        assert_tree_equal(PP.scenario_to_pkl_dict(raw),
                          JPP.scenario_to_pkl_dict(raw))
        assert_tree_equal(PP.scenario_to_pkl_dict(raw, mt),
                          JPP.scenario_to_pkl_dict(raw, jmt))
        n_tracks = len(s["tracks"])
        assert agents["num_nodes"] <= n_tracks - 3
        v = agents["valid_mask"]
        first, last = v.argmax(1), v.shape[1] - 1 - v[:, ::-1].argmax(1)
        assert all(v[i, first[i]:last[i] + 1].all() for i in range(len(v)))
        raw_valid = np.array([[st["valid"] for st in t["states"]]
                              for t in s["tracks"][:agents["num_nodes"]]])
        gaps += int((v & ~raw_valid).sum())
    assert gaps > 0, "no invalid gap was interpolated"


def _random_polylines(rng, n_trials=6):
    """The JAX test's polylines: smooth, and broken by a 50 m jump."""
    for trial in range(n_trials):
        n = int(rng.integers(5, 200))
        t = np.cumsum(rng.uniform(0.5, 2.0, n))
        pts = np.stack([t, 3 * np.sin(t * 0.1)], -1)
        if trial % 2:
            pts[n // 2:] += 50.0
        yield pts, np.arctan2(np.gradient(pts[:, 1]), np.gradient(pts[:, 0]))


def test_native_splitter_matches_numpy_and_jax():
    """The port's native splitter: bit for bit the JAX package's native
    one, within 1e-4 of the port's numpy one; the default path is native.
    Points more than 5 m apart give more segments than points, and both
    native bindings cap the output at max(n, 8) segments (ROADMAP Queue 3,
    hazards)."""
    for pts, hd in _random_polylines(np.random.default_rng(11)):
        nat = interpolate_polyline(pts, hd)
        np.testing.assert_array_equal(nat, native.interpolate_polyline_native(
            pts, hd))
        np.testing.assert_array_equal(nat, j_interpolate(pts, hd,
                                                         use_native=True))
        py = interpolate_polyline(pts, hd, use_native=False)
        assert nat.shape == py.shape and nat.dtype == np.float32
        np.testing.assert_allclose(nat, py, atol=1e-4)
    sparse = np.stack([np.arange(9) * 8.0, np.zeros(9)], -1)
    hd = np.zeros(9)
    nat = interpolate_polyline(sparse, hd)
    np.testing.assert_array_equal(nat, j_interpolate(sparse, hd))
    assert len(nat) == 9 < len(interpolate_polyline(sparse, hd,
                                                    use_native=False))


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A failed build raises with the compiler's output, and a library that
    does not load raises: nothing falls back to numpy."""
    pts = np.stack([np.arange(20.0), np.zeros(20)], -1)
    bad = tmp_path / "broken.cc"
    bad.write_text("extern \"C\" int interpolate_polyline( {\n")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "LIB_PATH", tmp_path / "build" / "lib.so")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on broken.cc"):
        interpolate_polyline(pts, np.zeros(20))
    (tmp_path / "build").mkdir(exist_ok=True)
    (tmp_path / "build" / "lib.so").write_bytes(b"not a library")
    with pytest.raises(RuntimeError, match="cannot load"):
        native.tfrecord_index(str(tmp_path / "none"))


def test_preprocess_matches_jax(womd):
    """The port's pickles and meta_infos.json equal the JAX package's;
    preprocessing again rewrites no pickle (idempotent)."""
    port, jdir = womd["port"], womd["jax"]
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(port)) == names and len(names) == 6
    for name in names:
        if name.endswith(".pkl"):
            with open(port / name, "rb") as f, open(jdir / name, "rb") as g:
                assert_tree_equal(pickle.load(f), pickle.load(g), name)
    meta = json.loads((port / "meta_infos.json").read_text())
    assert meta == json.loads((jdir / "meta_infos.json").read_text())
    assert sorted(m["num_agents"] for m in meta.values())[0] == \
        FILTERED_AGENTS
    stamps = {n: os.stat(port / n).st_mtime_ns for n in names}
    PP.main(["--input-dir", str(womd["raw"]), "--output-dir", str(port),
             "--num-workers", "1"])
    assert all(os.stat(port / n).st_mtime_ns == stamps[n]
               for n in names if n.endswith(".pkl"))


@pytest.mark.parametrize("training", [True, False])
def test_waymo_dataset_matches_jax(womd, training):
    """WaymoDataset items bitwise the JAX package's, cached map tokens
    (the pickles carry them) and the meta filter (the FILTERED_AGENTS
    scenario dropped); the dataset survives pickling (BatchLoader's spawn
    workers receive it so)."""
    cfg, jcfg = Config(**CFG), JConfig(**CFG)
    ds = WaymoDataset(str(womd["port"]), cfg, training=training)
    jds = JWaymo(str(womd["jax"]), jcfg, training=training)
    assert ds.files == jds.files and len(ds) == 4
    for i in range(len(ds)):
        assert_scenarios_equal(ds[i], jds[i])
    assert_scenarios_equal(pickle.loads(pickle.dumps(ds))[1], jds[1])
    # training mode scores the train agents (a mask that leaves some agent
    # out); eval mode trains on every slot
    left_out = [bool((ds[i].agents.train_mask != ds[i].agents.slot_mask)
                     .any()) for i in range(len(ds))]
    assert any(left_out) == training


def test_pkl_paths_match_jax(womd, tmp_path):
    """A pickle without cached map tokens (tokenised on the fly), and a
    reference-style one whose arrays are torch tensors, give the cached
    path's scenario and the JAX package's; without meta_infos.json no
    file is filtered."""
    cfg, jcfg = Config(**CFG), JConfig(**CFG)
    mt, jmt = MapTokenizer(), JMapTok()
    name = sorted(f for f in os.listdir(womd["port"]) if f.endswith(".pkl"))[0]
    with open(womd["port"] / name, "rb") as f:
        data = pickle.load(f)
    bare = {k: v for k, v in data.items() if k != "map_token"}

    def as_torch(x):
        if isinstance(x, dict):
            return {k: as_torch(v) for k, v in x.items()}
        return torch.from_numpy(x) if isinstance(x, np.ndarray) else x

    for training in (True, False):
        want = j_pkl_to_scenario(bare, jcfg, jmt, training=training)
        for d in (data, bare, as_torch(bare)):
            assert_scenarios_equal(
                pkl_to_scenario(d, cfg, mt, training=training), want)
    os.symlink(womd["port"] / name, tmp_path / name)
    assert WaymoDataset(str(tmp_path), cfg).files == [name]


def test_model_inputs_match_jax(womd):
    """build_model_inputs of a WOMD scenario equals the JAX package's on
    the same map-mask uniforms (the tolerance of test_torch_rollout's
    synthetic case)."""
    jcfg, cfg = JConfig(**CFG), Config(**CFG)
    jattr = JAttr(jcfg.grid_range, jcfg.grid_interval, jcfg.pl2seed_radius,
                  jcfg.angle_interval)
    jscen = JWaymo(str(womd["jax"]), jcfg, training=False)[0]
    key = jax.random.PRNGKey(0)
    jin = jax.jit(lambda s, k: j_build_inputs(jcfg, JMotion(), jattr, s, k))(
        jscen, key)
    uniform = np.array(jax.random.uniform(jax.random.split(key)[0],
                                          (jcfg.max_map_tokens,)))
    attr, mt, _ = cli.build_tokenizers(cfg)
    scen = to_device(WaymoDataset(str(womd["port"]), cfg,
                                  training=False)[0], "cpu")
    tin = build_model_inputs(cfg, mt, attr, scen,
                             pt_uniform=torch.as_tensor(uniform))
    for name in jin._fields:
        pairs = ([(f"tokens.{f}", getattr(jin.tokens, f),
                   getattr(tin.tokens, f)) for f in jin.tokens._fields]
                 if name == "tokens" else
                 [(name, getattr(jin, name), getattr(tin, name))])
        for what, a, b in pairs:
            a, b = np.asarray(a), b.numpy()
            if a.dtype.kind in "biu":
                np.testing.assert_array_equal(b, a, err_msg=what)
            else:
                np.testing.assert_allclose(b, a, atol=1e-4, rtol=0,
                                           err_msg=what)


def _cli(capsys, *argv):
    cli.main([*argv, "--config", TINY, "--device", "cpu"])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_data_dir(womd, capsys, tmp_path):
    """check-inputs, train (one step) and rollout with --data-dir on the
    CPU: each takes the directory's scenarios; a directory without one is
    an error; --synthetic wins over --data-dir."""
    d = str(womd["port"])
    ci = _cli(capsys, "check-inputs", "--data-dir", d)
    assert ci["scenarios"] == 4
    ci_syn = _cli(capsys, "check-inputs", "--data-dir", d, "--synthetic",
                  "--num-scenarios", "2")
    assert ci_syn["scenarios"] == 2 and ci_syn != ci
    tr = _cli(capsys, "train", "--data-dir", d, "--steps", "1", "--batch",
              "2")
    assert tr["steps"] == 1 and np.isfinite(tr["last_loss"])
    ro = _cli(capsys, "rollout", "--data-dir", d, "--num-scenarios", "9",
              "--num-recurrent-steps", "10")
    assert ro["scenarios"] == 4 and len(ro["ms_per_token_step"]) == 4
    with pytest.raises(ValueError, match="no scenario in"):
        cli.main(["rollout", "--data-dir", str(tmp_path), "--config", TINY,
                  "--device", "cpu"])


def test_offline_dump_log_data_dir(womd, tmp_path):
    """metrics.offline --dump-log --data-dir: one dump per scenario of the
    directory, aggregated over all of them."""
    log_dir = tmp_path / "log"
    offline.main(["--dump-log", "--aggregate-log", "--data-dir",
                  str(womd["port"]), "--config", TINY, "--log-dir",
                  str(log_dir), "--device", "cpu"])
    dumps = sorted(f for f in os.listdir(log_dir)
                   if f.startswith("log_features_"))
    assert len(dumps) == 4
    with np.load(log_dir / "total_features.npz") as z:
        rows = sum(np.load(log_dir / f)[z.files[0]].shape[0] for f in dumps)
        assert z[z.files[0]].shape[0] == rows


def test_preprocess_imports_no_torch():
    """Preprocessing needs no torch: its module tree imports none."""
    code = ("import sys\n"
            "import infgen_torch.data.preprocess\n"
            "print('torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "False", out.stderr
