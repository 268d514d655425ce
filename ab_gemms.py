"""Time the MoE router and the W8A16 lm_head of two source trees on one
card, at the shapes the serving and decode paths give them, in turns
A B, B A, ... Each run is a process of its own, started in its tree, so
each tree builds and runs its own kernels.

    python3 ab_gemms.py TREE_A [TREE_B] [--pairs N]

``TREE_B`` defaults to this checkout, ``--pairs`` to 2 (A B B A). The
shapes: ``Transformer._router_logits`` on bf16 x with DeepSeek-MoE-16B's
f32 router (K 2048, 64 experts) at M 768 (a serving step's packed rows)
and M 8 (a decode step), and at M 768 with K cut to 512 (how the time
follows K), from CUDA graphs over 12 copies of x; the W8A16 lm_head (bf16 x, int8 weights with per-column scales, f32 logits)
at DeepSeek-MoE-16B's M 16, K 2048, N 102400 (the serving slots) and
Llama-2-7B's M 8, K 4096, N 32000 (its decode batch), back to back.
Prints each run's times, then one JSON object: every run, and each
shape's median per tree. Needs a CUDA card.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np

CHILD = r"""
import json
import math
import torch
import chip_smoke as cs
from triton_distributed_tpu_torch.kernels import _build
from triton_distributed_tpu_torch.kernels import group_gemm as gg
from triton_distributed_tpu_torch.models import Transformer

torch.backends.cuda.matmul.allow_tf32 = False
_build.lib()
dev = torch.device("cuda", 0)
g = torch.Generator(device=dev).manual_seed(5)
out = {}
r = torch.randn((2048, 64), generator=g, device=dev)
for m, k in ((768, 2048), (8, 2048), (768, 512)):
    xs = [torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
          for _ in range(12)]
    rk = r[:k]
    key = f"router_m{m}_ms" if k == 2048 else f"router_m{m}_k{k}_ms"
    out[key] = cs.graph_time_ms(
        lambda i: Transformer._router_logits(xs[i % 12], rk))
be = torch.zeros((1,), dtype=torch.int32, device=dev)
for m, k, n in ((16, 2048, 102400), (8, 4096, 32000)):
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn((1, k, n), generator=g, device=dev,
                    dtype=torch.bfloat16) / math.sqrt(k)
    wq, ws = gg.quantize_grouped_weights(w)
    del w
    out[f"lm_head_m{m}_n{n}_ms"] = cs.time_ms(
        lambda: gg.grouped_matmul(x, wq, be, w_scale=ws,
                                  out_dtype=torch.float32), 20)
    del wq, ws
print("AB " + json.dumps(out), flush=True)
"""


def run(tree: str) -> dict:
    env = dict(os.environ, PYTHONPATH=tree)
    out = subprocess.run([sys.executable, "-c", CHILD], cwd=tree, env=env,
                         capture_output=True, text=True, timeout=900)
    line = next((x for x in out.stdout.splitlines() if x.startswith("AB ")),
                "")
    print(f"[{tree}] {line}", flush=True)
    if out.returncode or not line:
        sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
        raise SystemExit(f"{tree}: the timing run failed "
                         f"(rc {out.returncode})")
    return {"tree": tree, **json.loads(line[3:])}


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
    runs = []
    for i in range(opts.pairs):
        order = (b, a) if i % 2 else (a, b)
        runs += [run(t) for t in order]
    keys = [k for k in runs[0] if k.endswith("_ms")]
    median = {t: {k: float(np.median([r[k] for r in runs if r["tree"] == t]))
                  for k in keys} for t in (a, b)}
    print(json.dumps({"card": smi, "runs": runs, "median": median}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
