#!/usr/bin/env python3
"""A/B of the served flagship between checkouts, on one card, in one call.

    python scripts/ab_serving.py <tree> <tree> [<tree> ...] [--forced N]

Each tree is a checkout of the repository (unpack a commit with `git
archive <commit> | tar -x -C snapshot/<name>` into a git-ignored directory;
a variant is such a copy with one change made by hand). The trees run in
the order given and then in reverse (A, B, B, A), each run a fresh process
in its tree, whose kernels build into its own build/ at first use. By
default a run is chip_smoke.check_serving (the flagship's 8 serving
scenarios unforced and forced, in batches of 8 and one at a time) and
chip_smoke.run_preset on the flagship (one lane, 300 frames); with
--forced N it is N forced runs of the 8 scenarios at B = 8 through
cli.run_batched, the first of them the process's warm-up. Prints one JSON
line per reading: the tree, what ran, ms per (batched) token step.
"""

import argparse
import json
import os
import subprocess
import sys

SERVING = """
C.check_serving(dev)
C.run_preset(C.FLAGSHIP, dev)
"""
FORCED = """
from infgen_torch.cli import build_model, build_tokenizers, run_batched
from infgen_torch.config import load_config
cfg = load_config(C.FLAGSHIP).replace(
    num_recurrent_steps_val=C.SERVING_FRAMES)
tok = build_tokenizers(cfg)
model = build_model(cfg, tok[0], dev)
for i in range({n}):
    outs, s = run_batched(cfg, dev, C.SERVING_SCENARIOS, C.SERVING_SCENARIOS,
                          True, model=model, tokenizers=tok,
                          agent_buckets=C.SERVING_BUCKETS)
    print(json.dumps({{"phase": "forced_B8", "run": i,
                      "ms_per_batched_token_step":
                      s["ms_per_batched_token_step"],
                      "agents_inserted": sum(s["agents_inserted"])}}),
          flush=True)
"""
PRELUDE = """
import json, sys
sys.path.insert(0, '.')
import torch
import chip_smoke as C
from infgen_torch.ops.build import build
build()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device('cuda')
"""


def readings(line):
    """The JSON line's readings of ms per token step, or None."""
    d = json.loads(line)
    if d.get("phase") == "serving":
        return {"phase": "serving", "ms_per_batched_token_step": {
            f"{'forced' if r['force_insert'] else 'unforced'}_B{r['batch']}":
            r["ms_per_batched_token_step"] for r in d["runs"]}}
    if d.get("phase") == "rollout":
        return {"phase": "rollout", "ms_per_token_step": [
            r["ms_per_token_step"] for r in d["runs"]]}
    if d.get("phase") == "forced_B8":
        return d
    return None


def main():
    p = argparse.ArgumentParser("ab_serving")
    p.add_argument("trees", nargs="+")
    p.add_argument("--forced", type=int, default=0,
                   help="N forced B = 8 runs per process instead of the "
                        "serving phase and the flagship preset")
    args = p.parse_args()
    code = PRELUDE + (FORCED.format(n=args.forced) if args.forced
                      else SERVING)
    for tree in args.trees + args.trees[::-1]:
        out = subprocess.run([sys.executable, "-c", code], cwd=tree,
                             capture_output=True, text=True)
        for line in out.stdout.splitlines():
            if line.startswith("{"):
                r = readings(line)
                if r:
                    print(json.dumps({"tree": os.path.basename(
                        os.path.normpath(tree)), **r}), flush=True)
        if out.returncode:
            print(out.stderr[-3000:], file=sys.stderr, flush=True)
            return out.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
