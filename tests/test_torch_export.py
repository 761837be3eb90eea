"""The exported rollout (infgen_torch/rollout/export.py), torch only:
export -> save -> load -> the direct fixed-trip rollout's outputs bit for
bit, with the weights as an argument and without the model or tokenizer
code; and the six hand-written kernels' registered ops (`infgen::*`)
under torch.library.opcheck.

Exporting and loading are CPU-bound Python: about a millisecond per graph
node of each program to trace, as much to save and more to load, some
20-35 s for one kernel-flag set on an 8-core CPU. So each flag set's
round trip runs in a spawned process of the module's autouse fixture, the
four side by side while the opchecks run, and the tests collect them; the
flagship's process also starts the process that loads its artifact.
`export_and_run` serves tests/test_torch_rollout.py's case against the JAX
package the same way. The module imports no JAX (nor test_torch_layers,
which does): its spawned processes start in a few seconds.
"""

import multiprocessing
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from infgen_torch import cli
from infgen_torch.config import Config
from infgen_torch.data.features import build_model_inputs
from infgen_torch.data.scenario import to_device
from infgen_torch.data.synthetic import make_synthetic_scenario
from infgen_torch.ops import column_kernel as CK
from infgen_torch.ops import fused_block as FB
from infgen_torch.ops import refine_kernel as RK
from infgen_torch.ops import seed_kernel as SK
from infgen_torch.rollout.closed_loop import make_rollout_fn
from infgen_torch.rollout.export import (
    export_rollout, load_rollout_artifact, save_rollout_artifact)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_export.py's TINY (default beams 5 / 10: draws are made)
TINY = dict(max_agents=16, max_map_tokens=128, num_agent_layers=2,
            num_seed_layers=1, num_map_layers=1, hidden_dim=32,
            num_heads=2, head_dim=16, num_freq_bands=8,
            num_seed_feature=4, num_recurrent_steps_val=20)
# the flagship's kernel flags, the latency preset's three, and the
# flagship with each variant flag; with the ops each set's graphs hold
FLAGS = {
    "flagship": (dict(use_seed_kernel=True), {"seed_eval"}),
    "latency": (dict(use_seed_kernel_full=True, use_refine_kernel=True,
                     use_column_kernel=True),
                {"seed_eval_full", "refine", "motion_column"}),
    "fused_block": (dict(use_seed_kernel=True, use_fused_block=True),
                    {"seed_eval", "fused_attention_block"}),
    "pallas_attention": (dict(use_seed_kernel=True,
                              use_pallas_attention=True),
                         {"seed_eval", "r_biased_attention"}),
}
SEED = 5
# a process that loads the flagship's artifact (imports the export module
# only) and calls it; its last line: whether the outputs equal the direct
# rollout's, and the model and tokenizer modules it imported
LOADER = """import sys, torch
from infgen_torch.rollout.export import load_rollout_artifact
d = torch.load({inputs!r}, weights_only=False)
fn = load_rollout_artifact({path!r})
out = fn(d['params'], d['scenario'], d['inputs'],
         torch.Generator().manual_seed({seed}))
same = all((out[k].numpy() == v).all() for k, v in d['ref'].items())
bad = sorted(m for m in sys.modules if m.startswith(
    ('infgen_torch.model', 'infgen_torch.tokenizers')))
print('ok', same, bad)
"""


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread, as test_torch_layers.one_torch_thread gives
    every port test module (that module imports JAX)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(out):
    return {k: v.numpy() for k, v in out.items()}


def export_and_run(cfg_kw, state_dict, scenario, inputs, path,
                   force_insert=True, seed=SEED):
    """Export the rollout of Config(**cfg_kw) on the CPU, save it to
    `path`, load it and run it with `state_dict` on `scenario` / `inputs`
    and a generator of `seed`: (outputs as numpy, the infgen ops of its
    graphs, its header). Runs in a spawned process."""
    torch.set_num_threads(1)
    cfg = Config(**cfg_kw)
    attr, mt, mv = cli.build_tokenizers(cfg)
    blob = export_rollout(cfg, attr, mt, mv, scenario, inputs,
                          torch.Generator(), state_dict,
                          force_insert=force_insert)
    save_rollout_artifact(path, blob)
    fn = load_rollout_artifact(path)
    out = fn(state_dict, scenario, inputs, torch.Generator().manual_seed(seed))
    ops = {str(n.target).split(".")[1] for ep in fn.programs.values()
           for n in ep.graph.nodes
           if n.op == "call_function" and str(n.target).startswith("infgen.")}
    return _np(out), ops, fn.header


def _setup(cfg):
    tok = cli.build_tokenizers(cfg)
    model = cli.build_model(cfg, tok[0], "cpu")
    scen = to_device(make_synthetic_scenario(cfg, seed=0, num_agents=6),
                     "cpu")
    inputs = build_model_inputs(cfg, tok[1], tok[0], scen,
                                torch.Generator().manual_seed(3))
    return tok, model, scen, inputs


def round_trip(name, path):
    """One flag set's export and load against the direct fixed-trip
    rollout, forced insertion; for the flagship also the artifact called
    with other weights and with wrong state dicts, and its inputs and
    direct outputs saved beside it for a process that loads it."""
    torch.set_num_threads(1)
    cfg = Config(**TINY, **FLAGS[name][0])
    tok, model, scen, inputs = _setup(cfg)
    params = model.state_dict()
    out, ops, header = export_and_run(dict(TINY, **FLAGS[name][0]), params,
                                      scen, inputs, path)
    direct = make_rollout_fn(model, cfg.replace(insertion_fixed_trip=True),
                             *tok, force_insert=True)
    res = dict(out=out, ops=ops, header=header,
               ref=_np(direct(scen, inputs,
                              torch.Generator().manual_seed(SEED))))
    if name != "flagship":
        return res
    torch.save(dict(params=params, scenario=scen, inputs=inputs,
                    ref=res["ref"]), path + ".inputs")
    loader = subprocess.Popen(
        [sys.executable, "-c", LOADER.format(inputs=path + ".inputs",
                                             path=path, seed=SEED)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    fn = load_rollout_artifact(path)
    other = cli.build_model(cfg.replace(seed=cfg.seed + 1), tok[0], "cpu")
    run = lambda f, *a: _np(f(*a, torch.Generator().manual_seed(SEED)))
    res["other"] = run(fn, other.state_dict(), scen, inputs)
    res["other_ref"] = run(make_rollout_fn(
        other, cfg.replace(insertion_fixed_trip=True), *tok,
        force_insert=True), scen, inputs)
    res["refused"] = []
    key = "agent_decoder.token_predict_head.Dense_0.weight"
    bad_shape = dict(params, **{key: torch.zeros(params[key].shape[0] + 1,
                                                 params[key].shape[1])})
    missing = {k: v for k, v in params.items() if k != key}
    for bad in (bad_shape, missing):
        try:
            fn(bad, scen, inputs, torch.Generator().manual_seed(SEED))
        except (KeyError, ValueError) as e:
            res["refused"].append(type(e).__name__)
    res["loader"] = loader.communicate(timeout=300) + (loader.returncode,)
    return res


def cli_export(out):
    """`python -m infgen_torch.cli export` on the CPU: its printed line."""
    import contextlib
    import io
    torch.set_num_threads(1)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["export", "--synthetic", "--config",
                  os.path.join(ROOT, "configs", "tiny_smoke.yaml"),
                  "--device", "cpu", "--out", out])
    return buf.getvalue()


@pytest.fixture(scope="module", autouse=True)
def round_trips(tmp_path_factory):
    """Each flag set's round trip, and the command line's export, in a
    spawned process of its own, all started at the module's first test."""
    d = tmp_path_factory.mktemp("export")
    pool = multiprocessing.get_context("spawn").Pool(len(FLAGS) + 1)
    try:
        runs = {name: (pool.apply_async(round_trip, (name, str(
            d / f"{name}.pt2"))), str(d / f"{name}.pt2")) for name in FLAGS}
        runs["cli"] = (pool.apply_async(cli_export, (str(d / "cli.pt2"),)),
                       str(d / "cli.pt2"))
        yield runs
    finally:
        pool.terminate()
        pool.join()


# --------------------------------------------------------------------- #
# the six registered ops
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def decoder():
    cfg = Config(**TINY)
    attr = cli.build_tokenizers(cfg)[0]
    return cfg, attr, cli.build_model(cfg, attr, "cpu").agent_decoder


def _op_args(name, cfg, attr, dec):
    """(op, args) of `name` at small CPU shapes, two lanes, the second
    switched off where the op takes a lane mask."""
    g = torch.Generator().manual_seed(11)
    rand = lambda *s: torch.randn(*s, generator=g)
    mask = lambda *s: torch.rand(*s, generator=g) < 0.7
    B, L, D, H, Hd = 2, cfg.num_seed_layers, cfg.hidden_dim, \
        cfg.num_heads, cfg.head_dim
    P, A, G, lanes = 8, 6, attr.grid_size, torch.tensor([True, False])
    if name == "seed_eval":
        pack = SK.pack_seed_params(dec, L, G)
        return torch.ops.infgen.seed_eval.default, (
            pack.weights, pack.vectors, rand(D), rand(B, L, D),
            rand(B, L, P, D), rand(B, L, P, D), mask(B, P),
            rand(B, L, A, D), rand(B, L, A, D), mask(B, A), L, G, H, Hd,
            lanes)
    if name == "seed_eval_full":
        pack = SK.pack_seed_params_full(dec, L, G)
        return torch.ops.infgen.seed_eval_full.default, (
            pack.base.weights, pack.base.vectors, pack.views(), pack.tiles,
            rand(D), rand(B, L, P, D), rand(B, L, P, D), rand(B, P, D),
            mask(B, P), rand(B, A, D), rand(B, A, D), mask(B, A),
            mask(B, G), L, G, H, Hd, lanes)
    if name == "refine":
        pack = RK.pack_refine_params(dec, L, attr.angle_size)
        R = RK.MAX_ROWS
        return torch.ops.infgen.refine.default, (
            pack.views(), pack.tiles, rand(B, R, D), rand(B, R, D),
            rand(B, R, D), mask(B, R), rand(B, R, D), mask(B, R), L,
            attr.angle_size, H, Hd, False, lanes)
    if name == "motion_column":
        Lt, W, K = cfg.num_agent_layers, 4, 5
        pack = CK.pack_column_params(dec, Lt)
        return torch.ops.infgen.motion_column.default, (
            pack.views(), pack.tiles, rand(B, A, D), rand(Lt, B, A, W, D),
            rand(B, A, W, D), mask(B, A, W), rand(B, A, K, D),
            rand(B, A, K, D), mask(B, A, K), rand(B, A, A, D),
            mask(B, A, A), Lt, H, Hd, torch.tensor([A, 3],
                                                   dtype=torch.int32))
    if name == "fused_attention_block":
        pack = FB.pack_fused_block(dec.a2a_attn_layers[0])
        return torch.ops.infgen.fused_attention_block.default, (
            pack.views(), rand(B, A, D), None, rand(B, A, A, D),
            mask(B, A, A), H)
    Dr = D
    return torch.ops.infgen.r_biased_attention.default, (
        rand(B, A, H * Hd), rand(B, P, H * Hd), rand(B, P, H * Hd),
        rand(B, A, P, Dr), rand(Dr, H * Hd), rand(Dr, H * Hd),
        mask(B, A, P), H, None)


@pytest.mark.parametrize("name", ["seed_eval", "seed_eval_full", "refine",
                                  "motion_column", "fused_attention_block",
                                  "r_biased_attention"])
def test_op_check(decoder, name):
    """Each kernel's op passes torch.library.opcheck on CPU tensors (its
    schema, its fake implementation against the plain twin's outputs, its
    dispatch under tracing) and runs its plain twin there."""
    op, args = _op_args(name, *decoder)
    torch.library.opcheck(op, args)
    outs = op(*args)
    outs = outs if isinstance(outs, tuple) else (outs,)
    assert all(torch.isfinite(t).all() for t in outs)


# --------------------------------------------------------------------- #
# round trips
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("name", list(FLAGS))
def test_round_trip(round_trips, name):
    """Export, save, load: every output of the artifact equals the direct
    rollout's with insertion_fixed_trip and a generator of the same seed,
    bit for bit, at default beams (the motion and grid draws are made);
    the graphs hold the registered ops of the set's kernels."""
    res = round_trips[name][0].get(timeout=600)
    out, ref = res["out"], res["ref"]
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    assert int(ref["n_inserted"]) > 0
    var = res["header"]["variates"]
    assert var["n_insert"] == TINY.get("insert_limit", 10) + 1
    assert var["n_motion"] == TINY["max_agents"] and var["n_cand"] > 0
    assert res["ops"] >= FLAGS[name][1], res["ops"]
    assert all(res["header"]["kernels"][k] for k in FLAGS[name][0])


def test_weights_are_an_argument(round_trips):
    """The flagship's artifact, exported with weights W0 and called with
    W1, gives the direct rollout's outputs with W1; a state dict with a
    wrong shape or a missing key raises."""
    res = round_trips["flagship"][0].get(timeout=600)
    for k, v in res["other_ref"].items():
        np.testing.assert_array_equal(res["other"][k], v, err_msg=k)
    assert not np.array_equal(res["other"]["pred_traj"],
                              res["out"]["pred_traj"])
    assert res["refused"] == ["ValueError", "KeyError"]


def test_load_imports_no_model_or_tokenizers(round_trips):
    """A process (python -c LOADER) that loads the flagship's artifact and
    calls it imports no module of infgen_torch.model or
    infgen_torch.tokenizers, and gets the direct rollout's outputs."""
    out, err, rc = round_trips["flagship"][0].get(timeout=600)["loader"]
    assert rc == 0, err
    assert out.strip().splitlines()[-1] == "ok True []", out


def test_cli_export(round_trips):
    """`cli export` writes the artifact and prints one JSON line of its
    path, size and capacity; the header holds the config's capacity."""
    import json
    from infgen_torch.rollout.export import read_header
    line, path = round_trips["cli"]
    line = json.loads(line.get(timeout=600).strip().splitlines()[-1])
    assert set(line) == {"artifact", "bytes", "max_agents",
                         "max_map_tokens"}
    assert line["artifact"] == path
    with open(path, "rb") as f:
        blob = f.read()
    assert line["bytes"] == len(blob) > 10 ** 6
    header = read_header(blob)
    assert (header["max_agents"], header["max_map_tokens"], header["device"]
            ) == (line["max_agents"], line["max_map_tokens"], "cpu") \
        == (16, 128, "cpu")
