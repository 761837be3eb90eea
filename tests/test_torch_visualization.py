"""The port's plots, edge-map debug modes and hub helpers on the CPU
(`infgen_torch/utils/visualization.py`, `utils/hub.py`, `check_inputs`
under PLOT_EDGE, `cli validate --plot-rollouts` and PLOT_EDGE_INFERENCE).

Against the JAX package: the PLOT_EDGE masks (`loop.edge_map_masks`)
equal, bit for bit, those that the JAX package's `check_inputs` builds
with its own edge functions (run op by op, as it runs them) from the same
tokens (the JAX package's tokenised inputs of one synthetic scenario).
Port only: every plot writes its file, a failing plot is swallowed, the
command line's plots and edge maps land where they should, and without
matplotlib (its import hidden) the three plot modes are refused before
anything runs. The hub helpers raise without huggingface_hub and, with a
fake module in its place, call it with the arguments given (no test
reaches the network).
"""

import glob
import os
import sys
import types

import jax
import numpy as np
import pytest
import torch

from infgen_tpu.config import Config as JConfig
from infgen_tpu.data.features import build_model_inputs as j_build
from infgen_tpu.data.synthetic import make_synthetic_scenario as j_synth
from infgen_tpu.model import edges as JE
from infgen_tpu.tokenizers.attr_tokenizer import AttrTokenizer as JAttr
from infgen_tpu.tokenizers.motion_tokenizer import MotionTokenizer as JMotion

from infgen_torch import cli
from infgen_torch.config import Config
from infgen_torch.data.scenario import TokenizedAgents
from infgen_torch.train.loop import SyntheticDataset, check_inputs, \
    edge_map_masks
from infgen_torch.utils import hub
from infgen_torch.utils import visualization as VIS

from test_torch_layers import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs", "tiny_smoke.yaml")
CFG = dict(max_agents=16, max_map_tokens=128, hidden_dim=32, num_heads=2,
           head_dim=16, num_freq_bands=8)


def test_plot_edge_masks_match_jax():
    """The a2a [T, A, A] and temporal [A, T, T] masks of scenario 0's
    tokens, port against the JAX package's edge functions, bit for bit."""
    jcfg = JConfig(**CFG)
    attr = JAttr(jcfg.grid_range, jcfg.grid_interval, jcfg.pl2seed_radius,
                 jcfg.angle_interval)
    inputs = jax.jit(lambda s, k: j_build(jcfg, JMotion(), attr, s, k))(
        j_synth(jcfg, seed=0, num_agents=12), jax.random.PRNGKey(0))
    tok = inputs.tokens
    _, hv = JE.build_motion_vectors(tok.token_pos, tok.token_heading,
                                    tok.state_idx)
    interact = (tok.raw_token_valid | (tok.state_idx == 2)) \
        & inputs.slot_mask[:, None]
    a2a = JE.build_a2a_edges(tok.token_pos, tok.token_heading, tok.state_idx,
                             hv, interact, jcfg.a2a_radius)
    hist = JE.training_hist_mask(tok.raw_token_valid, tok.state_idx, None) \
        & inputs.slot_mask[:, None]
    temporal = JE.build_temporal_edges(
        tok.token_pos, tok.token_heading, tok.state_idx, hv, hist,
        jcfg.time_span // jcfg.shift)

    ours = edge_map_masks(
        Config(**CFG), TokenizedAgents(*(torch.as_tensor(np.array(x))
                                         for x in tok)),
        torch.as_tensor(np.array(inputs.slot_mask)))
    for name, want in (("a2a", a2a.mask), ("temporal", temporal.mask)):
        got = ours[name].numpy()
        assert got.dtype == bool and got.shape == want.shape, name
        assert np.array_equal(got, np.asarray(want)), name
    assert ours["a2a"].any() and ours["temporal"].any()


def test_check_inputs_plots_edge_maps(tmp_path, monkeypatch):
    monkeypatch.setenv("PLOT_EDGE", "1")
    monkeypatch.setenv("PLOT_EDGE_DIR", str(tmp_path))
    cfg = Config(**CFG)
    totals, _ = check_inputs(cfg, SyntheticDataset(cfg, size=1), 1,
                             lambda msg: None, "cpu")
    assert totals["valid_count"] > 0
    assert sorted(os.listdir(tmp_path)) == [
        "check_inputs_a2a_edge_map.png", "check_inputs_temporal_edge_map.png"]


def test_plots_write_their_files(tmp_path):
    rng = np.random.default_rng(0)
    A, T, G, d = 6, 21, 5, str(tmp_path)
    traj = np.cumsum(rng.normal(size=(A, T, 2)), 1)
    state = np.ones((A, T), np.int64)
    state[0] = 0
    paths = [
        VIS.plot_scenario_rollout("s", rng.normal(size=(30, 2)), traj,
                                  rng.normal(size=(A, T)), state,
                                  np.arange(A) % 4, 1, d,
                                  slot_active=np.arange(A) < 5,
                                  make_gif=True),
        VIS.plot_insert_grid("s", rng.random((4, G * G)), G, d,
                             indices=[3, -1, 0, 24]),
        VIS.plot_occ_grid("s", rng.random((12, G * G)), G, d,
                          gt_occ_square=rng.random((12, G * G))),
        VIS.plot_prob_seed("s", rng.random((T, 4)), d),
        *VIS.plot_attention_masks("s", {"a": rng.random((3, 4, 4)) < 0.5,
                                        "b": rng.random((4, 5)) < 0.5}, d)]
    assert [os.path.basename(p) for p in paths] == [
        "s_rollout.png", "s_insert_grid.png", "s_occ_agent.png",
        "s_prob_seed.png", "s_a_edge_map.png", "s_b_edge_map.png"]
    assert all(os.path.getsize(p) > 0 for p in paths)
    assert os.path.getsize(tmp_path / "s_rollout.gif") > 0


def test_failing_plot_is_swallowed(tmp_path, capsys):
    assert VIS.plot_prob_seed("s", np.zeros((2, 3, 5)), str(tmp_path)) is None
    assert "[visualization] plot_prob_seed failed" in capsys.readouterr().out


def test_cli_validate_plots_rollouts_and_edge_maps(tmp_path, monkeypatch):
    """`cli validate --plot-rollouts` under PLOT_EDGE_INFERENCE on a tiny
    CPU run: the rollout's picture in D/vis and its three agent-agent maps
    (columns 2, middle, last) in D/edge_maps."""
    monkeypatch.setenv("PLOT_EDGE_INFERENCE", "1")
    monkeypatch.delenv("PLOT_EDGE_DIR", raising=False)
    cli.main(["validate", "--synthetic", "--config", TINY, "--device", "cpu",
              "--num-scenarios", "1", "--save-dir", str(tmp_path),
              "--plot-rollouts"])
    assert os.listdir(tmp_path / "vis") == ["scenario_000000_rollout.png"]
    prefix = str(tmp_path / "edge_maps" / "rollout_000000_a2a_col")
    cols = sorted(int(p[len(prefix):-len("_edge_map.png")])
                  for p in glob.glob(prefix + "*_edge_map.png"))
    # pos_a's token columns: Tc = the last one + 1
    assert cols == [2, (cols[-1] + 1) // 2, cols[-1]] and cols[-1] > 4


def test_inference_masks_rule():
    """a2a_inference_masks: live on both ends, within the radius, no self
    edge."""
    pos = np.zeros((3, 4, 2), np.float32)
    pos[1, :, 0], pos[2, :, 0] = 5.0, 50.0
    state = np.ones((3, 4), np.int64)
    state[2, 3] = 0
    masks = VIS.a2a_inference_masks(pos, state, np.array([True, True, True]),
                                    10.0)
    assert sorted(masks) == ["a2a_col2", "a2a_col3"]
    want = np.array([[0, 1, 0], [1, 0, 0], [0, 0, 0]], bool)
    assert np.array_equal(masks["a2a_col2"], want)
    assert np.array_equal(masks["a2a_col3"], want)
    assert VIS.a2a_inference_masks(pos, state, np.zeros(3, bool), 60.0)[
        "a2a_col2"].sum() == 0


@pytest.mark.parametrize("mode,flags,env", [
    ("validate", ["--plot-rollouts"], {}),
    ("validate", [], {"PLOT_EDGE_INFERENCE": "1"}),
    ("check-inputs", [], {"PLOT_EDGE": "1"})])
def test_plots_refused_without_matplotlib(tmp_path, monkeypatch, capsys,
                                          mode, flags, env):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit) as e:
        cli.main([mode, "--synthetic", "--config", TINY, "--device", "cpu",
                  "--save-dir", str(tmp_path / "run")] + flags)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "matplotlib" in err and (flags or list(env))[0] in err
    assert not os.path.exists(tmp_path / "run")


def test_hub_refused_without_package(monkeypatch):
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    for call in (hub._require_hub,
                 lambda: hub.upload_checkpoint("ckpt", "org/m"),
                 lambda: hub.download_checkpoint("org/m", "d")):
        with pytest.raises(RuntimeError, match="huggingface_hub"):
            call()


def test_hub_calls_the_module(tmp_path, monkeypatch, capsys):
    calls = []

    class HfApi:
        def __init__(self, token=None):
            calls.append(("HfApi", token))

        def create_repo(self, repo_id, **kw):
            calls.append(("create_repo", repo_id, kw))

        def upload_folder(self, **kw):
            calls.append(("upload_folder", kw))

    def snapshot_download(repo_id, **kw):
        calls.append(("snapshot_download", repo_id, kw))
        return kw["local_dir"]

    fake = types.ModuleType("huggingface_hub")
    fake.HfApi, fake.snapshot_download = HfApi, snapshot_download
    monkeypatch.setitem(sys.modules, "huggingface_hub", fake)
    monkeypatch.setenv("HF_TOKEN", "env-token")
    ckpt, local = str(tmp_path / "ckpt"), str(tmp_path / "hub")
    assert hub.upload_checkpoint(ckpt, "org/m", token="tok") == \
        "https://huggingface.co/org/m"
    assert hub.download_checkpoint("org/m", local) == local
    hub.main(["upload", "--repo_id", "org/n", "--ckpt_dir", ckpt])
    assert capsys.readouterr().out.strip() == "https://huggingface.co/org/n"
    assert calls == [
        ("HfApi", "tok"), ("create_repo", "org/m", {"exist_ok": True}),
        ("upload_folder", dict(folder_path=ckpt, repo_id="org/m",
                               path_in_repo="ckpt")),
        ("snapshot_download", "org/m", dict(local_dir=local,
                                            token="env-token")),
        ("HfApi", "env-token"), ("create_repo", "org/n", {"exist_ok": True}),
        ("upload_folder", dict(folder_path=ckpt, repo_id="org/n",
                               path_in_repo="ckpt"))]
