"""Serve the main path of two source trees on one card and compare their
step times: DeepSeek-MoE-16B as served at full width and depth, the
seeded 16-request trace of ``chip_smoke.run_path``, in pairs A B, B A,
A B, ... Each run is a process of its own, started in its tree, so each
tree builds and runs its own kernels; host noise that drifts through
the call falls on both trees alike.

    python3 ab_main_path.py TREE_A [TREE_B] [--pairs N]

``TREE_B`` defaults to this checkout, ``--pairs`` to 2 (A B B A).
Prints each run's path line, then one JSON object: every run's p50 and
p99 step ms, wall and tok/s, and per metric each tree's median, A's
interquartile range and the pairs B reads lower in. Needs a CUDA card.
"""

import argparse
import json
import os
import re
import subprocess
import sys

import numpy as np

CHILD = r"""
import sys
import torch
import chip_smoke as cs
from triton_distributed_tpu_torch.kernels import _build
from triton_distributed_tpu_torch.models import presets

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.lib()
res = cs.Results()
cs.run_path(res, torch.device("cuda", 0), "deepseek_moe_16b",
            presets.deepseek_moe_16b())
for f in res.failures:
    print("FAIL", f, flush=True)
sys.exit(1 if res.failures else 0)
"""

KEYS = ("p50_step_ms", "p99_step_ms", "wall_s", "tok_s", "steps")


def run(tree: str) -> dict:
    env = dict(os.environ, PYTHONPATH=tree)
    out = subprocess.run([sys.executable, "-c", CHILD], cwd=tree, env=env,
                         capture_output=True, text=True, timeout=900)
    line = next((x for x in out.stdout.splitlines()
                 if x.startswith("path deepseek_moe_16b ")), "")
    print(f"[{tree}] {line}", flush=True)
    if out.returncode or not line:
        sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
        raise SystemExit(f"{tree}: the main path failed "
                         f"(rc {out.returncode})")
    got = {k: float(re.search(rf"\b{k}=([0-9.]+)", line).group(1))
           for k in KEYS}
    return {"tree": tree, **got}


def summary(pairs: list) -> dict:
    out = {}
    for k in ("p50_step_ms", "p99_step_ms", "wall_s"):
        a = np.array([p[0][k] for p in pairs])
        b = np.array([p[1][k] for p in pairs])
        q1, q3 = np.percentile(a, [25, 75])
        out[k] = {"median_a": float(np.median(a)),
                  "median_b": float(np.median(b)),
                  "iqr_a": float(q3 - q1),
                  "b_lower_in": int((b < a).sum()), "pairs": len(pairs)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree_a")
    ap.add_argument("tree_b", nargs="?",
                    default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--pairs", type=int, default=2)
    opts = ap.parse_args()
    a, b = os.path.abspath(opts.tree_a), os.path.abspath(opts.tree_b)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    pairs = []
    for i in range(opts.pairs):
        if i % 2:
            rb, ra = run(b), run(a)
        else:
            ra, rb = run(a), run(b)
        pairs.append((ra, rb))
    print(json.dumps({"card": smi, "pairs": pairs,
                      "summary": summary(pairs)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
