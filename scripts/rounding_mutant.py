"""chip_smoke.py's bf16 limits against a copy of the kernels whose bf16
operands round toward zero: the limits must refuse it.

    python scripts/rounding_mutant.py [--kernels refine,seed_eval]

Copies this checkout's csrc into build/mutant/csrc, makes the bf16
operand rounding round toward zero (__float2bfloat16_rz in refine.cu's
to_t and in common.cuh's round_to, which the seed stack uses), builds the
copy, and runs chip_smoke.py's checks of the named kernels on it (fp32 and
bf16, their width phases included) with every reading printed and no
check stopping the run. Then one JSON line per kernel: the checks that
failed, and whether a bf16 one did (the mutant refused). Exits non-zero
if a mutant passed. Needs a GPU.
"""

import argparse
import ctypes
import json
import shutil
import sys
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# (file, the rounding to nearest, the same toward zero)
MUTATIONS = (
    ("refine.cu", "  return __float2bfloat16(x);\n",
     "  return __float2bfloat16_rz(x);\n"),
    ("common.cuh", "  return __bfloat162float(__float2bfloat16(x));\n",
     "  return __bfloat162float(__float2bfloat16_rz(x));\n"))


def main(argv=None):
    p = argparse.ArgumentParser("rounding_mutant")
    p.add_argument("--kernels", default="refine,seed_eval")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("rounding_mutant needs a GPU", file=sys.stderr)
        return 1
    import chip_smoke as S
    from ab_kernels import build_tree
    from infgen_torch.cli import build_tokenizers
    from infgen_torch.config import load_config
    from infgen_torch.ops import build as B

    csrc = B.BUILD_DIR / "mutant" / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(B.CSRC, csrc)
    for name, old, new in MUTATIONS:
        text = (csrc / name).read_text()
        assert text.count(old) == 1, f"{name}: the rounding to mutate"
        (csrc / name).write_text(text.replace(old, new))
    lib_path = csrc.parent / "libinfgen_kernels.so"
    build_tree(csrc, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    B._declare(lib)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg, lat = load_config(S.FLAGSHIP), load_config(S.LATENCY)
    attr = build_tokenizers(cfg)[0]
    checks = {"seed_eval": lambda: S.check_seed_eval(cfg, attr, dev),
              "refine": lambda: S.check_refine(lat, attr, dev)}
    passed = []
    for kernel in args.kernels.split(","):
        failed = []

        def soft(ok, what):
            if not ok:
                failed.append(what)
        with mock.patch.object(B, "_lib", lib), \
                mock.patch.object(S, "require", soft):
            checks[kernel]()
        refused = any("bfloat16" in f or "bf16" in f for f in failed)
        print(json.dumps(dict(item="mutant", kernel=kernel, refused=refused,
                              failed=failed)), flush=True)
        if not refused:
            passed.append(kernel)
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
