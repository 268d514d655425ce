"""Time the bf16 tensor-parallel GEMMs of two source trees on one card, at
the shapes the Llama-2-7B paths give them, in turns A B, B A, ... Each run
is a process of its own, started in its tree, so each tree builds and runs
its own kernels.

    python3 ab_tp.py TREE_A [TREE_B] [--profile]

``TREE_B`` defaults to this checkout; runs go A B B A (``ab_common``). A run
times, with bf16 operands drawn from a seed:

- the mesh AG-GEMM (``ag_gemm`` on a loopback mesh of 4 ranks: A 4 x
  (2048, 4096) row shards, B_r (4096, 3072) for wqkv and (4096, 2752) for
  up) and GEMM-RS (A_q (8192, 1024) for wo and (8192, 2752) for down,
  B_q (K_q, 4096)), ``chip_smoke.check_mesh_kernels``' shapes; and up /
  down again at the context-parallel prefill's 2016 rows a rank;
- the world-size-1 AG-GEMM and GEMM-RS (``ag_gemm`` / ``gemm_rs`` on
  tensors: M 8192, wqkv K 4096 N 12288, up N 11008, wo K 4096 N 4096,
  down K 11008 N 4096), ``chip_smoke.check_n1_gemms``' shapes;
- the bf16 wire pass of ``ab_wire.py``: 32 layers of
  ``ColumnParallelLinear`` (wqkv), ``RowParallelLinear`` (wo) and
  ``ParallelMLP`` (up, silu, down) on 4 x 2048 rows, from CUDA events,
  the best of three;
- Llama-2-7B (bf16, random weights from a seed) prefills, host clock
  around a synchronize, the best of two after a warm-up: tp = 1 and tp =
  4 on ``chip_smoke``'s decode prompts (8 of up to 1024 tokens), and the
  context-parallel prefill at ``attn`` ring, ulysses and tp on its 2
  prompts of 4032 and 2600 tokens (``chip_smoke.run_cp_prefill_path``).

Each kernel time is the mean of 10 back-to-back launches from CUDA
events (``chip_smoke.time_ms``), and, as ``..._dev_ms``, the device time
of a call from ``torch.profiler`` (no host time); each run also reports
the form every launch of the four GEMM entries took, where the tree
counts it, and with ``--profile`` logs a ``torch.profiler`` breakdown of
one tp = 4 prefill.
Prints each run's times, then one JSON object: the card, every run, and
each key's median per tree. Needs a CUDA card.
"""

import sys

import ab_common

CHILD = r"""
import dataclasses
import json
import sys
import time

import torch
import chip_smoke as cs
from triton_distributed_tpu_torch import layers, ops
from triton_distributed_tpu_torch.kernels import _build
from triton_distributed_tpu_torch.kernels import ag_gemm as agm
from triton_distributed_tpu_torch.kernels import gemm_rs as grs
from triton_distributed_tpu_torch.models import Transformer, presets
from triton_distributed_tpu_torch.runtime import Mesh

profile = sys.argv[1] == "1"
torch.backends.cuda.matmul.allow_tf32 = False
_build.lib()
dev = torch.device("cuda", 0)
tp, M, h, f = 4, 8192, 4096, 11008
bf16 = torch.bfloat16
mesh = Mesh.loopback(tp, dev)
g = torch.Generator(device=dev).manual_seed(12)
out = {}


def shards(shape, scale=1.0):
    t = torch.randn((tp, *shape), generator=g, device=dev, dtype=bf16)
    return list((t * scale).unbind(0))


def timed(key, fn, iters=10):
    # key: the mean of iters back-to-back calls from CUDA events (host
    # work included where it outlasts the kernel); key + "_dev": the
    # device time a call, from torch.profiler (0 where it sees none)
    out[f"{key}_ms"] = cs.time_ms(fn, iters)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out[f"{key}_dev_ms"] = cs.device_rows(prof)[0] / 1e3 / iters


for rows, tag in ((M // tp, ""), (cs.CP_B * cs.CP_S // tp, "_m2016")):
    for what, n in (("wqkv", 3 * h // tp), ("up", f // tp)):
        if tag and what == "wqkv":
            continue
        a, b = shards((rows, h)), shards((h, n), h ** -0.5)
        timed(f"ag_gemm_{what}{tag}", lambda: agm.ag_gemm(a, b, mesh))
    for what, k in (("wo", h // tp), ("down", f // tp)):
        if tag and what == "wo":
            continue
        a, b = shards((tp * rows, k)), shards((k, h), (tp * k) ** -0.5)
        timed(f"gemm_rs_{what}{tag}", lambda: grs.gemm_rs(a, b, mesh))
for name, what, k, n, fn in (("ag_gemm_n1", "wqkv", h, 3 * h, agm.ag_gemm),
                             ("ag_gemm_n1", "up", h, f, agm.ag_gemm),
                             ("gemm_rs_n1", "wo", h, h, grs.gemm_rs),
                             ("gemm_rs_n1", "down", f, h, grs.gemm_rs)):
    a = torch.randn((M, k), generator=g, device=dev, dtype=bf16)
    b = torch.randn((k, n), generator=g, device=dev, dtype=bf16) / k ** 0.5
    timed(f"{name}_{what}", lambda: fn(a, b))
del a, b

x = cs.wire_operands(dev, g, (M // tp, h), outlier=True)
attn = cs.wire_operands(dev, g, (M, h // tp))
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
ctx = ops.OverlapContext(mesh, "tp")
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
out["pass_bf16_ms"] = best
del params, x, attn
torch.cuda.empty_cache()


def prefill_ms(model, p, tokens, lens, cap):
    best = float("inf")
    for i in range(3):
        caches = model.init_cache(tokens.shape[0], cap)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(p, caches, tokens, lens)
        torch.cuda.synchronize()
        if i:
            best = min(best, (time.perf_counter() - t0) * 1e3)
        del caches
    return best


cfg = presets.llama_7b(param_dtype=bf16)
one = Transformer(cfg, device=dev)
base = one.init(torch.Generator(device=dev).manual_seed(0))
rng = cs.np.random.default_rng(7)
lens = torch.as_tensor(rng.integers(128, cs.DEC_PROMPT + 1, cs.DEC_B),
                       dtype=torch.int32, device=dev)
tokens = torch.randint(0, cfg.vocab, (cs.DEC_B, cs.DEC_PROMPT),
                       generator=torch.Generator(device=dev).manual_seed(8),
                       device=dev, dtype=torch.int32)
out["prefill_tp1_ms"] = prefill_ms(one, base, tokens, lens, cs.DEC_CAP)
models = {"tp": Transformer(cfg, mesh=mesh)}
sharded = models["tp"].shard_params(base)
out["prefill_tp4_ms"] = prefill_ms(models["tp"], sharded, tokens, lens,
                                   cs.DEC_CAP)
if profile:
    cs.profile_prefill(f"llama_7b bf16 tp{tp}", models["tp"], sharded,
                       tokens, lens)
shared = dict(base, blocks=[dict(blk, up=tb["up"], down=tb["down"])
                            for blk, tb in zip(base["blocks"],
                                               sharded["blocks"])])
cp_tokens = torch.randint(0, cfg.vocab, (cs.CP_B, cs.CP_S),
                          generator=torch.Generator(device=dev).manual_seed(31),
                          device=dev, dtype=torch.int32)
cp_lens = torch.tensor(cs.CP_LENS, dtype=torch.int32, device=dev)
for attn in ("ring", "ulysses", "tp"):
    model = (models["tp"] if attn == "tp" else
             Transformer(dataclasses.replace(cfg, attn=attn), mesh=mesh))
    p = sharded if attn == "tp" else shared
    out[f"prefill_cp_{attn}_ms"] = prefill_ms(model, p, cp_tokens, cp_lens,
                                              cs.CP_CAP)
forms = {name: dict(fn.by_variant) for name, fn in (
    ("ag_gemm", agm._ag_gemm_mesh_cuda), ("gemm_rs", grs._gemm_rs_mesh_cuda),
    ("ag_gemm_n1", agm._ag_gemm_cuda), ("gemm_rs_n1", grs._gemm_rs_cuda))
    if hasattr(fn, "by_variant")}
print("AB " + json.dumps({**out, "forms": forms}), flush=True)
"""


if __name__ == "__main__":
    sys.exit(ab_common.main(__doc__, CHILD, flags=("profile",),
                             echo="profile "))
