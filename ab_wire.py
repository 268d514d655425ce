"""Time the quantized wires' GEMMs of two source trees on one card, at the
shapes the Llama-2-7B tp = 4 wire path gives them, in turns A B, B A, ...
Each run is a process of its own, started in its tree, so each tree
builds and runs its own kernels.

    python3 ab_wire.py TREE_A [TREE_B]

``TREE_B`` defaults to this checkout; runs go A B B A (``ab_common``). A run
times, on a loopback mesh of 4 ranks of the card (A 4 x (2048, 4096)
bf16 row shards with an outlier row x1000 a shard, as
``chip_smoke.check_wire_kernels`` draws them):

- ``tdt_ag_gemm_w`` alone (``ag_gemm_w_launch`` on the shards' codes) for
  wqkv (B_r (4096, 3072)) and up (B_r (4096, 2752)) on fp8 and int8;
- ``tdt_gemm_rs_partials`` alone for wo (A_r (8192, 1024), B_r (1024,
  4096)) and down (A_r (8192, 2752), B_r (2752, 4096));
- a pass over 32 layers of ``ColumnParallelLinear`` (wqkv),
  ``RowParallelLinear`` (wo) and ``ParallelMLP`` (up, silu, down) on each
  wire (bf16, fp8, int8, int8-mxu), the weights drawn once before, from
  CUDA events around the pass, the best of three.

Each kernel time is the mean of back-to-back launches from CUDA events
(``chip_smoke.time_ms``); each run also reports the form every launch of
the two entries took, where the tree counts it. Prints each run's times,
then one JSON object: the card, every run, and each key's median per
tree. Needs a CUDA card.
"""

import sys

import ab_common

CHILD = r"""
import json
import torch
import chip_smoke as cs
from triton_distributed_tpu_torch import layers, ops
from triton_distributed_tpu_torch.kernels import _build
from triton_distributed_tpu_torch.kernels import ag_gemm as agm
from triton_distributed_tpu_torch.kernels import gemm_rs as grs
from triton_distributed_tpu_torch.kernels import wire as wk
from triton_distributed_tpu_torch.lang import wire as tw
from triton_distributed_tpu_torch.runtime import Mesh

torch.backends.cuda.matmul.allow_tf32 = False
_build.lib()
dev = torch.device("cuda", 0)
tp, m, h, f = 4, 2048, 4096, 11008
bf16 = torch.bfloat16
mesh = Mesh.loopback(tp, dev)
g = torch.Generator(device=dev).manual_seed(13)
x = cs.wire_operands(dev, g, (m, h), outlier=True)
out = {}
for what, n in (("wqkv", 3 * h // tp), ("up", f // tp)):
    b = cs.wire_operands(dev, g, (h, n), h ** -0.5)
    for wire in ("fp8", "int8"):
        fmt = tw.make_wire_format(wire, m)
        q, sc = wk.quantize_shards(x, fmt)
        out[f"ag_gemm_w_{wire}_{what}_ms"] = cs.time_ms(
            lambda: agm.ag_gemm_w_launch(x, q, sc, b, mesh, fmt, bf16), 10)
    del b
for what, k in (("wo", h // tp), ("down", f // tp)):
    a = cs.wire_operands(dev, g, (tp * m, k), outlier=True)
    b = cs.wire_operands(dev, g, (k, h), (tp * k) ** -0.5)
    out[f"gemm_rs_partials_{what}_ms"] = cs.time_ms(
        lambda: grs.gemm_rs_partials(a, b, mesh, bf16), 10)
    del a, b
torch.cuda.empty_cache()
attn = cs.wire_operands(dev, g, (tp * m, h // tp))
params = []
for layer in range(32):
    gl = torch.Generator(device=dev).manual_seed(1000 + layer)
    params.append({
        "wqkv": {"w": cs.wire_operands(dev, gl, (h, 3 * h // tp), h ** -0.5)},
        "wo": {"w": cs.wire_operands(dev, gl, (h // tp, h), h ** -0.5)},
        "mlp": {"up": {"w": cs.wire_operands(dev, gl, (h, f // tp),
                                             h ** -0.5)},
                "down": {"w": cs.wire_operands(dev, gl, (f // tp, h),
                                               f ** -0.5)}}})
for wire in (None, "fp8", "int8", "int8-mxu"):
    ctx = ops.OverlapContext(mesh, "tp", wire_dtype=wire)
    col, row = layers.ColumnParallelLinear(ctx), layers.RowParallelLinear(ctx)
    mlp = layers.ParallelMLP(layers.ColumnParallelLinear(ctx),
                             layers.RowParallelLinear(ctx), activation="silu")

    def one_pass():
        for p in params:
            col(p["wqkv"], x)
            row(p["wo"], attn)
            mlp(p["mlp"], x)

    one_pass()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        one_pass()
        e1.record()
        torch.cuda.synchronize()
        best = min(best, e0.elapsed_time(e1))
    out[f"pass_{wire or 'bf16'}_ms"] = best
forms = {name: dict(fn.by_variant) for name, fn in (
    ("ag_gemm_w", agm.ag_gemm_w_launch), ("gemm_rs_partials",
                                         grs.gemm_rs_partials))
    if hasattr(fn, "by_variant")}
print("AB " + json.dumps({**out, "forms": forms}), flush=True)
"""


if __name__ == "__main__":
    sys.exit(ab_common.main(__doc__, CHILD))
