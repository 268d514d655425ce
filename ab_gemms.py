"""Time the MoE router and the W8A16 lm_head of two source trees on one
card, at the shapes the serving and decode paths give them, in turns
A B, B A, ... Each run is a process of its own, started in its tree, so
each tree builds and runs its own kernels.

    python3 ab_gemms.py TREE_A [TREE_B]

``TREE_B`` defaults to this checkout; runs go A B B A (``ab_common``). The
shapes: ``Transformer._router_logits`` on bf16 x with DeepSeek-MoE-16B's
f32 router (K 2048, 64 experts) at M 768 (a serving step's packed rows)
and M 8 (a decode step), and at M 768 with K cut to 512 (how the time
follows K), from CUDA graphs over 12 copies of x; the W8A16 lm_head (bf16 x, int8 weights with per-column scales, f32 logits)
at DeepSeek-MoE-16B's M 16, K 2048, N 102400 (the serving slots) and
Llama-2-7B's M 8, K 4096, N 32000 (its decode batch), back to back.
Prints each run's times, then one JSON object: every run, and each
shape's median per tree. Needs a CUDA card.
"""

import sys

import ab_common

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


if __name__ == "__main__":
    sys.exit(ab_common.main(__doc__, CHILD))
