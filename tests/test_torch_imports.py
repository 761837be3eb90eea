"""The port stands alone: no module of `infgen_torch` and not `chip_smoke.py`
imports JAX, flax or the JAX package, at any depth of the code (function
bodies included), so the port runs where JAX is not installed."""

import ast
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "infgen_tpu"}
FILES = sorted((ROOT / "infgen_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    assert len(FILES) > 30
    bad = {str(p.relative_to(ROOT)): sorted(
        {m for m in _imported(p) if m.split(".")[0] in FORBIDDEN})
        for p in FILES}
    assert not {k: v for k, v in bad.items() if v}
