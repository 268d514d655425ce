"""Time the MoE router, the W8A16 lm_head and W8A8 of two source trees on
one card, at the shapes the serving and decode paths give them, in turns
A B, B A, ... Each run is a process of its own, started in its tree, so
each tree builds and runs its own kernels.

    python3 ab_gemms.py TREE_A [TREE_B]

``TREE_B`` defaults to this checkout; runs go A B B A (``ab_common``). The
shapes: ``Transformer._router_logits`` on bf16 x with DeepSeek-MoE-16B's
f32 router (K 2048, 64 experts) at M 768 (a serving step's packed rows)
and M 8 (a decode step), and at M 768 with K cut to 512 (how the time
follows K), from CUDA graphs over 12 copies of x; the W8A16 lm_head (bf16 x, int8 weights with per-column scales, f32 logits)
at DeepSeek-MoE-16B's M 16, K 2048, N 102400 (the serving slots) and
Llama-2-7B's M 8, K 4096, N 32000 (its decode batch), back to back;
W8A8 (int8 x and weights, bf16 out) at DeepSeek-MoE-16B's serving
projections (M 768: wqkv, wo, layer 0's up and down), its experts (the
serving step's 8704 sorted rows in 64-row blocks over 64 experts, up and
down) and Llama-2-7B's decode projections at M 8, each from CUDA graphs
cycling through copies of the weight (over 100 MB, twice L2), in the
weight layout the tree's quantizer gives W8A8 (K-major where it takes
``k_major``); and the W8A8 wrapper's host time a call (``*_host_ms``: 200
calls enqueued behind a spinning kernel, the least of 15 such: other
work on the host only adds) at wqkv M 768 and wo M 8.
Prints each run's times, then one JSON object: every run, and each
shape's median per tree. Needs a CUDA card.
"""

import sys

import ab_common

CHILD = r"""
import inspect
import json
import math
import time
import torch
import chip_smoke as cs
from triton_distributed_tpu_torch.kernels import _build
from triton_distributed_tpu_torch.kernels import group_gemm as gg
from triton_distributed_tpu_torch.models import Transformer, presets

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

# W8A8: the weights in the layout the tree's quantizer gives W8A8
kmaj = "k_major" in inspect.signature(gg.quantize_grouped_weights).parameters


def quant(w):
    return (gg.quantize_grouped_weights(w, k_major=True) if kmaj
            else gg.quantize_grouped_weights(w))


def copies(w):
    n = max(1, min(8, math.ceil(100e6 / w.numel())))
    return [w] + [w.clone() for _ in range(n - 1)]


def host_ms(fn, n=200, reps=15):
    fn()
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(int(1e8))
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        ts.append((time.perf_counter() - t0) / n * 1e3)
    torch.cuda.synchronize()
    return min(ts)


ds = presets.deepseek_moe_16b()
llama = presets.llama_7b()
shapes = [(f"w8a8_{what}_m{m}_ms", m, k, n, 1)
          for what, (m, k, n), _ in cs.dense_shapes(ds)]
shapes += [(f"w8a8_llama_{w}_m8_ms", 8, k, n, 1) for w, k, n in (
    ("wqkv", 4096, 12288), ("wo", 4096, 4096), ("up", 4096, 11008),
    ("down", 11008, 4096))]
for key, m, k, n, _ in shapes:
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn((1, k, n), generator=g, device=dev,
                    dtype=torch.bfloat16) / math.sqrt(k)
    xq, xs = gg.quantize_act_rows(x)
    wq, ws = quant(w)
    del w
    wqs = copies(wq)
    out[key] = cs.graph_time_ms(lambda i: gg.grouped_matmul(
        xq, wqs[i % len(wqs)], be, w_scale=ws, x_scale=xs))
    if key in ("w8a8_wqkv_m768_ms", "w8a8_llama_wo_m8_ms"):
        out[key.replace("_ms", "_host_ms")] = host_ms(
            lambda: gg.grouped_matmul(xq, wq, be, w_scale=ws, x_scale=xs))
    del wqs, wq, ws
moe = cs.moe_step_inputs(dev, ds)
xe, bee = cs.expert_rows(moe)
del moe
for what, k, n in (("up", cs.MOE_H, cs.MOE_F), ("down", cs.MOE_F, cs.MOE_H)):
    x = xe if what == "up" else torch.randn(
        (xe.shape[0], k), generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn((cs.MOE_E, k, n), generator=g, device=dev,
                    dtype=torch.bfloat16) / math.sqrt(k)
    xq, xs = gg.quantize_act_rows(x)
    wq, ws = quant(w)
    del w
    out[f"w8a8_experts_{what}_ms"] = cs.graph_time_ms(
        lambda i: gg.grouped_matmul(xq, wq, bee, w_scale=ws, x_scale=xs))
    del wq, ws
print("AB " + json.dumps(out), flush=True)
"""


if __name__ == "__main__":
    sys.exit(ab_common.main(__doc__, CHILD))
