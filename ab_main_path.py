"""Serve the main path of two source trees on one card and compare their
step times: DeepSeek-MoE-16B as served at full width and depth, the
seeded 16-request trace of ``chip_smoke.run_path``, in pairs A B, B A,
A B, ... Each run is a process of its own, started in its tree, so each
tree builds and runs its own kernels; host noise that drifts through
the call falls on both trees alike.

    python3 ab_main_path.py TREE_A [TREE_B]

``TREE_B`` defaults to this checkout; runs go A B B A (``ab_common``).
Prints each run's path line, then one JSON object: every run's p50 and
p99 step ms, wall and tok/s, and per metric each tree's median, A's
interquartile range and the pairs B reads lower in. Needs a CUDA card.
"""

import json
import re
import sys

import numpy as np

import ab_common

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
    line = ab_common.run(tree, CHILD, prefix="path deepseek_moe_16b ")
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
    a, b, _ = ab_common.trees(__doc__)
    smi = ab_common.card()
    runs = [run(t) for t in ab_common.turns(a, b)]
    # each pair as (A's run, B's run), whatever order it ran in
    pairs = [tuple(sorted(runs[i:i + 2], key=lambda r: r["tree"] != a))
             for i in range(0, len(runs), 2)]
    print(json.dumps({"card": smi, "pairs": pairs,
                      "summary": summary(pairs)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
