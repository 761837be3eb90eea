"""The port stands alone: no module of `infgen_torch` and not `chip_smoke.py`
imports JAX, flax or the JAX package, at any depth of the code (function
bodies included), so the port runs where JAX is not installed."""

import ast
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "infgen_tpu"}
FILES = sorted((ROOT / "infgen_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
METRICS = ("features", "map_distance", "wosac", "train_metrics", "offline")
DATA = ("womd_proto", "native", "preprocess", "waymo", "womd_synthetic")


def _imported(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    assert len(FILES) > 30
    names = {str(p.relative_to(ROOT)) for p in FILES}
    assert {f"infgen_torch/train/{m}.py" for m in (
        "targets", "losses", "train_step", "loop", "checkpoint")} <= names
    assert {f"infgen_torch/metrics/{m}.py" for m in METRICS} <= names
    assert {"infgen_torch/rollout/streaming.py",
            "infgen_torch/rollout/export.py",
            "infgen_torch/rollout/carry.py"} <= names
    assert {"infgen_torch/model/occ_decoder.py", "infgen_torch/data/loader.py",
            "infgen_torch/utils/logging.py", "infgen_torch/utils/backup.py",
            "infgen_torch/utils/profiling.py"} <= names
    assert {f"infgen_torch/data/{m}.py" for m in DATA} <= names
    assert {"infgen_torch/metrics/nms.py", "infgen_torch/ops/sampling.py"} \
        <= names
    bad = {str(p.relative_to(ROOT)): sorted(
        {m for m in _imported(p) if m.split(".")[0] in FORBIDDEN})
        for p in FILES}
    assert not {k: v for k, v in bad.items() if v}


def test_train_modules_import_without_jax():
    """The training modules and the command line import in a process where
    JAX, flax, optax and the JAX package cannot be imported."""
    import subprocess
    import sys

    code = ("import sys\n"
            f"for m in {sorted(FORBIDDEN)!r}: sys.modules[m] = None\n"
            "import infgen_torch.train.loop, infgen_torch.cli\n"
            "import infgen_torch.model.occ_decoder, infgen_torch.data.loader\n"
            "import infgen_torch.utils.profiling\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_metrics_modules_import_without_jax():
    """The WOSAC metric modules import, and score a small feature set, in a
    process where JAX, flax, optax and the JAX package cannot be
    imported."""
    import subprocess
    import sys

    code = ("import sys\n"
            f"for m in {sorted(FORBIDDEN)!r}: sys.modules[m] = None\n"
            + "".join(f"import infgen_torch.metrics.{m}\n" for m in METRICS)
            + "import torch\n"
            "from infgen_torch.metrics import features as F, wosac as W\n"
            "A, T = 4, 101\n"
            "xy = torch.cumsum(torch.ones(A, T, 2), 1)\n"
            "f = F.compute_metric_features(\n"
            "    xy, torch.zeros(A, T), torch.ones(A, T, dtype=torch.bool),\n"
            "    torch.full((A,), 4.0), torch.full((A,), 2.0),\n"
            "    torch.ones(A, dtype=torch.bool), 0, xy[:, ::5][:, :20],\n"
            "    torch.ones(A, 20, dtype=torch.int32))\n"
            "c = W.WosacConfig()\n"
            "m = W.compute_scenario_metrics(c, W.make_log_distributions(c, f),"
            " f)\n"
            "print('ok', 0 < float(m['metametric']) <= 1)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok True", \
        out.stderr


def test_streaming_imports_without_jax():
    """The streaming module imports, and streams a tiny scenario for two
    segments on the CPU, in a process where JAX, flax, optax and the JAX
    package cannot be imported."""
    import subprocess
    import sys

    code = ("import sys\n"
            f"for m in {sorted(FORBIDDEN)!r}: sys.modules[m] = None\n"
            "import torch\n"
            "from infgen_torch import cli\n"
            "from infgen_torch.config import load_config\n"
            "from infgen_torch.data.synthetic import "
            "make_synthetic_scenario\n"
            "from infgen_torch.rollout import streaming as ST\n"
            "cfg = load_config('configs/tiny_smoke.yaml')\n"
            "tok = cli.build_tokenizers(cfg)\n"
            "model = cli.build_model(cfg, tok[0], 'cpu')\n"
            "fn = ST.make_stream_fn(model, cfg, *tok, segment_steps=10,\n"
            "                       n_segments=2)\n"
            "res = ST.stitch_stream_outputs(fn(make_synthetic_scenario(\n"
            "    cfg, seed=0, num_agents=4), 1), cfg.num_historical_steps)\n"
            "print('ok', res['frames_per_segment'])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok [21, 10]", \
        out.stderr


def test_data_modules_import_without_jax(tmp_path):
    """The input pipeline imports, and preprocesses one synthetic WOMD
    scenario into a WaymoDataset item, in a process where JAX, flax, optax
    and the JAX package cannot be imported; preprocessing imports no
    torch."""
    import subprocess
    import sys

    code = ("import sys\n"
            f"for m in {sorted(FORBIDDEN)!r}: sys.modules[m] = None\n"
            + "".join(f"import infgen_torch.data.{m}\n" for m in DATA
                      if m != "waymo")
            + "from infgen_torch.data import preprocess, womd_synthetic\n"
            f"d = {str(tmp_path)!r}\n"
            "womd_synthetic.write_womd_files(d + '/raw', files=1, "
            "per_file=1, agents=(9, 9), map_length_m=100.0)\n"
            "preprocess.main(['--input-dir', d + '/raw', '--output-dir', "
            "d + '/pkl', '--num-workers', '1'])\n"
            "no_torch = 'torch' not in sys.modules\n"
            "import infgen_torch.metrics.nms, infgen_torch.ops.sampling\n"
            "import infgen_torch.data.waymo as W\n"
            "from infgen_torch.config import load_config\n"
            "ds = W.WaymoDataset(d + '/pkl', load_config("
            "'configs/tiny_smoke.yaml'))\n"
            "print('ok', no_torch, len(ds), int(ds[0].agents.slot_mask.sum()))"
            "\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and \
        out.stdout.strip().splitlines()[-1] == "ok True 1 9", out.stderr


def test_export_imports_without_jax():
    """The export module imports where JAX, flax, optax and the JAX package
    cannot be imported, registers the six kernels' ops, and loading needs
    no model or tokenizer module: importing it imports none."""
    import subprocess
    import sys

    code = ("import sys\n"
            f"for m in {sorted(FORBIDDEN)!r}: sys.modules[m] = None\n"
            "import torch\n"
            "import infgen_torch.rollout.export\n"
            "ops = [n for n in ('seed_eval', 'seed_eval_full', 'refine',\n"
            "       'motion_column', 'fused_attention_block',\n"
            "       'r_biased_attention') if hasattr(torch.ops.infgen, n)]\n"
            "bad = [m for m in sys.modules if m.startswith(\n"
            "    ('infgen_torch.model', 'infgen_torch.tokenizers'))]\n"
            "print('ok', len(ops), bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok 6 []", \
        out.stderr + out.stdout


def test_learning_and_plot_modules_import_without_jax():
    """validate_learning, the plots and the hub helpers import where JAX,
    flax, optax, the JAX package, matplotlib and huggingface_hub cannot be
    imported; the plots and the hub then refuse with RuntimeError."""
    import subprocess
    import sys

    hidden = sorted(FORBIDDEN | {"matplotlib", "huggingface_hub"})
    code = ("import sys\n"
            f"for m in {hidden!r}: sys.modules[m] = None\n"
            "import infgen_torch.validate_learning\n"
            "from infgen_torch.utils import hub, visualization\n"
            "refused = []\n"
            "for fn in (visualization.require_matplotlib, hub._require_hub):\n"
            "    try:\n"
            "        fn()\n"
            "    except RuntimeError:\n"
            "        refused.append(fn.__name__)\n"
            "print('ok', *refused)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == \
        "ok require_matplotlib _require_hub", out.stderr + out.stdout
