"""Time the MoE-TP wire's grouped GEMMs of two source trees on one card, at
the shapes the DeepSeek-MoE-16B tp = 4 MoE wire path gives them, in turns
A B, B A, ... Each run is a process of its own, started in its tree, so
each tree builds and runs its own kernels.

    python3 ab_moe_wire.py TREE_A [TREE_B]

``TREE_B`` defaults to this checkout; runs go A B B A (``ab_common``). A
run draws, as ``chip_smoke.check_moe_wire_kernels`` does, 4 x 2048 tokens
of hidden 2048 with an outlier token x1000 a shard, one layer's router and
bf16 experts (64 of 2048 x 1408, F / 4 = 352 a rank) and its top-6
routing, each shard aligned on its own at block_m 128 (20480 sorted rows a
shard), on a loopback mesh of 4 ranks of the card, and times:

- ``tdt_ag_group_gemm_w`` alone (``ag_group_gemm_mesh_w`` on the sorted
  slabs' codes; K 2048, N 352 a rank) on fp8 and int8, given the slabs
  where the tree's wrapper takes them, and the peak device memory of the
  whole AG op (``ops.ag_group_gemm_fused``: the gather, the quantizer and
  the kernel) above what it found;
- ``tdt_moe_reduce_rs_partials`` alone once (``moe_reduce_rs_partials``;
  K 352 a rank, N 2048) on the bf16 up projection's silu;
- a pass over the 27 MoE layers of ``moe_tp_mlp_overlapped`` on each wire
  (bf16, fp8, int8, int8-mxu), each layer's weights drawn from a seed
  before its four calls, the calls' sum from CUDA events around each, and
  each wire's most device memory a call allocated above what it found
  (``torch.cuda.max_memory_allocated``).

Each kernel time is the mean of back-to-back launches from CUDA events
(``chip_smoke.time_ms``); each run also reports the form every launch of
the two entries took, where the tree counts it. Prints each run's times
and peaks, then one JSON object: the card, every run, and each time's
median per tree. Needs a CUDA card.
"""

import sys

import ab_common

CHILD = r"""
import inspect
import json
import torch
import torch.nn.functional as F
import chip_smoke as cs
from triton_distributed_tpu_torch import ops
from triton_distributed_tpu_torch.kernels import _build
from triton_distributed_tpu_torch.kernels import moe_tp_fused as mtf
from triton_distributed_tpu_torch.lang.shmem import stacked
from triton_distributed_tpu_torch.runtime import Mesh

torch.backends.cuda.matmul.allow_tf32 = False
_build.lib()
dev = torch.device("cuda", 0)
tp, bf16 = cs.TP, torch.bfloat16
mesh = Mesh.loopback(tp, dev)
g = torch.Generator(device=dev).manual_seed(15)
x_cat = cs.moe_wire_tokens(dev, g)
_, ids, w_up, w_down = cs.moe_wire_layer(dev, g, x_cat)
x = list(x_cat.chunk(tp))
ctx = {w: ops.MoETPContext(num_experts=cs.MOE_E, topk=cs.MOE_K,
                           block_m=cs.MOE_TP_BM, dtype=bf16, mesh=mesh,
                           wire_dtype=w) for w in cs.WIRES}
routing = ops.align_routing_sharded(ctx[None], ids)
sti, be, cap_s = routing.sti, routing.be, routing.cap_s
takes = "slabs" in inspect.signature(mtf.ag_group_gemm_mesh_w).parameters


def peak_mib(fn):
    # the most device memory fn allocated above what it found, in MiB
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated(dev) - base) / 2**20


out, peaks = {}, {}
for wire in ("fp8", "int8"):
    fmt = mtf._wire_fmt(wire, cap_s, cs.MOE_TP_BM)
    wired = mtf.quantize_sorted(x, sti, cs.MOE_K, fmt)
    q, sc = wired[:2]
    kw = {"slabs": wired[2]} if takes else {}
    del wired
    out[f"ag_group_gemm_w_{wire}_ms"] = cs.time_ms(
        lambda: mtf.ag_group_gemm_mesh_w(x, q, sc, sti, be, w_up, cs.MOE_K,
                                         mesh, fmt, **kw), 10)
    del q, sc, kw
    peaks[f"ag_op_{wire}_mib"] = peak_mib(lambda: ops.ag_group_gemm_fused(
        x_cat, routing, w_up, ctx[wire]))
hs = F.silu(stacked(ops.ag_group_gemm_fused(
    x_cat, routing, w_up, ctx[None])).float()).to(bf16)
y = list(hs.unbind(0))
out["moe_reduce_rs_partials_ms"] = cs.time_ms(
    lambda: mtf.moe_reduce_rs_partials(y, be, w_down, mesh), 10)
del hs, y, w_up, w_down
torch.cuda.empty_cache()
g = torch.Generator(device=dev).manual_seed(16)
x = cs.moe_wire_tokens(dev, g)
passes = {w: 0.0 for w in cs.WIRES}
for wire in cs.WIRES:
    peaks[f"mlp_{wire or 'bf16'}_mib"] = 0.0
for layer in range(27):
    gl = torch.Generator(device=dev).manual_seed(2000 + layer)
    wts, ids, w_up, w_down = cs.moe_wire_layer(dev, gl, x)
    ev = []
    for wire in cs.WIRES:
        ev.append(torch.cuda.Event(enable_timing=True))
        ev[-1].record()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ops.moe_tp_mlp_overlapped(x, ids, wts, w_up, w_down, ctx[wire])
        key = f"mlp_{wire or 'bf16'}_mib"
        peaks[key] = max(peaks[key], (torch.cuda.max_memory_allocated(dev)
                                      - base) / 2**20)
    ev.append(torch.cuda.Event(enable_timing=True))
    ev[-1].record()
    torch.cuda.synchronize()
    for i, wire in enumerate(cs.WIRES):
        passes[wire] += ev[i].elapsed_time(ev[i + 1])
    del wts, ids, w_up, w_down
for wire, ms in passes.items():
    out[f"pass_{wire or 'bf16'}_ms"] = ms
forms = {name: dict(fn.by_variant) for name, fn in (
    ("ag_group_gemm_w", mtf._ag_group_gemm_w_cuda),
    ("moe_reduce_rs_partials", mtf._moe_reduce_rs_partials_cuda))
    if hasattr(fn, "by_variant")}
print("AB " + json.dumps({**out, **peaks, "forms": forms}), flush=True)
"""


if __name__ == "__main__":
    sys.exit(ab_common.main(__doc__, CHILD))
