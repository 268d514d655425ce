"""Time the bf16 MoE-TP pair of two source trees on one card, at the shapes
the DeepSeek-MoE-16B prefill gives it, in turns A B, B A, ... Each run is a
process of its own, started in its tree, so each tree builds and runs its
own kernels.

    python3 ab_moe_tp.py TREE_A [TREE_B]

``TREE_B`` defaults to this checkout; runs go A B B A (``ab_common``). A
run draws its operands from seeds, as ``chip_smoke`` does, and times:

- the four bf16 entries alone: at world size 1 ``tdt_ag_group_gemm`` /
  ``tdt_moe_reduce_rs`` at the TP prefill's shapes
  (``chip_smoke.check_moe_tp_kernels``: 8 x 1024 tokens, top-6 over 64
  experts of 2048 x 1408, 57344 sorted rows at block_m 128), and over a
  loopback mesh of 4 ranks ``tdt_ag_group_gemm_mesh`` /
  ``tdt_moe_reduce_rs_mesh`` (``check_moe_tp_mesh_kernels``: 2048 tokens
  a rank, each shard aligned on its own, 20480 sorted rows a shard, F 352
  a rank);
- the up projection's whole op over the mesh (``ops.ag_group_gemm_fused``
  on the bf16 wire: the tokens' split and cast, any gather or slab the
  tree builds, the kernel);
- a pass over the 27 MoE layers of ``moe_tp_mlp_overlapped`` at tp = 4 on
  the bf16 wire (``chip_smoke.run_moe_wire_path``'s tokens and per-layer
  weights), the calls' sum from CUDA events around each, the best of three
  passes;
- the DeepSeek-MoE-16B TP flavour's prefill (bf16 experts, random weights
  from a seed; ``chip_smoke``'s decode prompts, 8 of up to 1024 tokens)
  at tp = 1 and at tp = 4 on the loopback mesh: the device's busy time of
  one prefill (``torch.profiler``) and the host clock around it, the best
  of two after a warm-up; then each prefill's device time by kernel and
  idle share (``chip_smoke.profile_prefill``), printed as ``profile``
  lines.

Each kernel time is the mean of 10 back-to-back calls from CUDA events
(``chip_smoke.time_ms``), and, as ``..._dev_ms``, the device time of a
call from ``torch.profiler``; ``..._kernel_dev_ms`` is the device time of
the grouped GEMM kernel alone (``wg_grouped_kernel`` or the tile loops'
``bf16_mma_kernel``). Each op's and each layer call's most device memory
above what it found (``torch.cuda.max_memory_allocated``) is reported as a
``*_mib`` key, and the form every launch of the four entries took, where
the tree counts it. Prints each run's line, then one JSON object: the
card, every run, and each time's median per tree. Needs a CUDA card.
"""

import sys

import ab_common

CHILD = r"""
import json
import time

import torch
import torch.nn.functional as F
import chip_smoke as cs
from triton_distributed_tpu_torch import ops
from triton_distributed_tpu_torch.kernels import _build
from triton_distributed_tpu_torch.kernels import moe_tp_fused as mtf
from triton_distributed_tpu_torch.kernels import moe_utils as mu
from triton_distributed_tpu_torch.lang.shmem import stacked
from triton_distributed_tpu_torch.models import Transformer, presets
from triton_distributed_tpu_torch.runtime import Mesh

torch.backends.cuda.matmul.allow_tf32 = False
_build.lib()
dev = torch.device("cuda", 0)
tp, bf16 = cs.TP, torch.bfloat16
E, H, FF, K = cs.MOE_E, cs.MOE_H, cs.MOE_F, cs.MOE_K
mesh = Mesh.loopback(tp, dev)
out, peaks = {}, {}
GEMMS = ("wg_grouped_kernel", "bf16_mma_kernel")


def timed(key, fn, iters=10):
    # key: the mean of iters back-to-back calls from CUDA events; + "_dev":
    # the device time a call, from torch.profiler; + "_kernel_dev": the
    # grouped GEMM kernel's share of it
    out[f"{key}_ms"] = cs.time_ms(fn, iters)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy, rows = cs.device_rows(prof)
    out[f"{key}_dev_ms"] = busy / 1e3 / iters
    out[f"{key}_kernel_dev_ms"] = sum(
        us for us, name, _ in rows if any(k in name for k in GEMMS)
    ) / 1e3 / iters


def peak(key, fn):
    # the most device memory fn allocated above what it found, in MiB
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fn()
    torch.cuda.synchronize()
    peaks[f"{key}_mib"] = (torch.cuda.max_memory_allocated(dev) - base) / 2**20


# world size 1: the TP prefill's shapes
x, sti, be, _, g = cs.moe_tp_inputs(dev, cs.DEC_B * cs.DEC_PROMPT, bf16, 9)
w_up = torch.randn((E, H, FF), generator=g, device=dev, dtype=bf16) / H ** 0.5
w_down = torch.randn((E, FF, H), generator=g, device=dev,
                     dtype=bf16) / FF ** 0.5
h = F.silu(mtf.ag_group_gemm(x, sti, be, w_up, K).float()).to(bf16)
up = lambda: mtf.ag_group_gemm(x, sti, be, w_up, K)
down = lambda: mtf.moe_reduce_rs(h, be, w_down)
timed("ag_group_gemm", up)
timed("moe_reduce_rs", down)
peak("ag_group_gemm", up)
peak("moe_reduce_rs", down)
del x, sti, be, w_up, w_down, h

# over the mesh: check_moe_tp_mesh_kernels' shapes
m_s, fl = cs.DEC_B * cs.DEC_PROMPT // tp, FF // tp
g = torch.Generator(device=dev).manual_seed(13)
logits = torch.randn((tp * m_s, E), generator=g, device=dev)
_, ids = mu.select_experts(logits, K)
ctx = ops.MoETPContext(num_experts=E, topk=K, block_m=cs.MOE_TP_BM,
                       dtype=bf16, mesh=mesh)
routing = ops.align_routing_sharded(ctx, ids)
sti, be = routing.sti, routing.be
x_cat = torch.randn((tp * m_s, H), generator=g, device=dev, dtype=bf16)
x = list(x_cat.chunk(tp))
w_up = list((torch.randn((tp, E, H, fl), generator=g, device=dev, dtype=bf16)
             / H ** 0.5).unbind(0))
w_down = list((torch.randn((tp, E, fl, H), generator=g, device=dev,
                           dtype=bf16) / FF ** 0.5).unbind(0))
hs = F.silu(stacked(mtf.ag_group_gemm_mesh(x, sti, be, w_up, K, mesh))
            .float()).to(bf16)
h = list(hs.unbind(0))
up = lambda: mtf.ag_group_gemm_mesh(x, sti, be, w_up, K, mesh)
down = lambda: mtf.moe_reduce_rs_mesh(h, be, w_down, mesh)
timed("ag_group_gemm_mesh", up)
timed("moe_reduce_rs_mesh", down)
peak("ag_group_gemm_mesh", up)
peak("moe_reduce_rs_mesh", down)
op = lambda: ops.ag_group_gemm_fused(x_cat, routing, w_up, ctx)
timed("ag_op", op)
peak("ag_op", op)
del x, x_cat, sti, be, w_up, w_down, h, hs, routing
torch.cuda.empty_cache()

# the bf16 27-layer pass at tp = 4, the best of three (the host's enqueue
# falls inside the events where it outlasts the device's work)
g = torch.Generator(device=dev).manual_seed(16)
x = cs.moe_wire_tokens(dev, g)
out["pass_bf16_ms"], peaks["mlp_bf16_mib"] = float("inf"), 0.0
for _ in range(3):
    total = 0.0
    for layer in range(27):
        gl = torch.Generator(device=dev).manual_seed(2000 + layer)
        wts, ids, w_up, w_down = cs.moe_wire_layer(dev, gl, x)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ops.moe_tp_mlp_overlapped(x, ids, wts, w_up, w_down, ctx)
        peaks["mlp_bf16_mib"] = max(peaks["mlp_bf16_mib"], (
            torch.cuda.max_memory_allocated(dev) - base) / 2**20)
        ev[1].record()
        torch.cuda.synchronize()
        total += ev[0].elapsed_time(ev[1])
        del wts, ids, w_up, w_down
    out["pass_bf16_ms"] = min(out["pass_bf16_ms"], total)
del x
torch.cuda.empty_cache()

# the TP flavour's prefill at tp = 1 and tp = 4
cfg = presets.deepseek_moe_16b(moe="tp", moe_weight_quant=None,
                               moe_act_quant=None)
one = Transformer(cfg, device=dev)
base = one.init(torch.Generator(device=dev).manual_seed(0),
                quantize=cfg.dense_weight_quant is not None)
rng = cs.np.random.default_rng(7)
lens = torch.as_tensor(rng.integers(128, cs.DEC_PROMPT + 1, cs.DEC_B),
                       dtype=torch.int32, device=dev)
tokens = torch.randint(0, cfg.vocab, (cs.DEC_B, cs.DEC_PROMPT),
                       generator=torch.Generator(device=dev).manual_seed(8),
                       device=dev, dtype=torch.int32)


def prefill(key, model, p):
    # the host clock around a prefill, the best of two after a warm-up;
    # then one more under torch.profiler: the device's busy time
    best = float("inf")
    for i in range(4):
        caches = model.init_cache(cs.DEC_B, cs.DEC_CAP)
        torch.cuda.synchronize()
        if i < 3:
            t0 = time.perf_counter()
            model.prefill(p, caches, tokens, lens)
            torch.cuda.synchronize()
            if i:
                best = min(best, (time.perf_counter() - t0) * 1e3)
        else:
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                model.prefill(p, caches, tokens, lens)
                torch.cuda.synchronize()
            out[f"prefill_{key}_dev_ms"] = cs.device_rows(prof)[0] / 1e3
        del caches
    out[f"prefill_{key}_ms"] = best


prefill("tp1", one, base)
cs.profile_prefill("deepseek_moe_16b tp", one, base, tokens, lens)
four = Transformer(cfg, mesh=mesh)
sharded = four.shard_params(base)
prefill("tp4", four, sharded)
cs.profile_prefill(f"deepseek_moe_16b tp tp{tp}", four, sharded, tokens,
                   lens)
forms = {name: dict(fn.by_variant) for name, fn in (
    ("ag_group_gemm", mtf._ag_group_gemm_cuda),
    ("moe_reduce_rs", mtf._moe_reduce_rs_cuda),
    ("ag_group_gemm_mesh", mtf._ag_group_gemm_mesh_cuda),
    ("moe_reduce_rs_mesh", mtf._moe_reduce_rs_mesh_cuda))
    if hasattr(fn, "by_variant")}
print("AB " + json.dumps({**out, **peaks, "forms": forms}), flush=True)
"""


if __name__ == "__main__":
    sys.exit(ab_common.main(__doc__, CHILD, echo="profile "))
