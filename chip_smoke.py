"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, all run every time:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions;
2. build: compile the CUDA kernels of ``triton_distributed_tpu_torch/
   csrc`` (timed);
3. kernels: each kernel against its plain PyTorch version on seeded
   inputs at the serving step's shapes, with its time, the plain
   version's, a PyTorch library call's where one exists, and the
   card's bound for the same work;
4. tiny: the int8 tiny model served on the card and on the CPU from the
   same weights — the token streams must be equal;
5. main: the continuous-batching engine serving a Poisson trace with
   the Llama-2-7B geometry (int8 KV, W8A8 projections, W8A16 lm_head,
   bf16), with the launches of every kernel counted over the run;
   ``--profile`` then profiles a few engine steps (device time by
   kernel, the device's idle share).

Exits non-zero, printing no result line, without a CUDA device or
without the port's package beside it. The last line is
``{"ok": true, "device": {...}}``; the line before it is the card's
name and power limit, and the line before that the ``{"kernels": ...}``
summary.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12       # HBM3, H100 SXM data sheet
H100_BF16_OPS = 989e12           # dense bf16 tensor-core rate
H100_INT8_OPS = 1979e12          # dense int8 tensor-core rate

# attention against its plain version in f32:
# |out - ref| <= ATTN_RTOL·|ref| + ATTN_ATOL, |lse - ref| <= ATTN_LSE_TOL
ATTN_RTOL, ATTN_ATOL, ATTN_LSE_TOL = 1e-2, 1e-4, 1e-4

KERNELS = {
    "ggemm_w8a8": dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/group_gemm.cu",
        replaces="triton_distributed_tpu/kernels/group_gemm.py:74"),
    "ggemm_w8a16": dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/group_gemm.cu",
        replaces="triton_distributed_tpu/kernels/group_gemm.py:50"),
    "ragged_paged_attention": dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/ragged_paged_attention.cu",
        replaces="triton_distributed_tpu/kernels/ragged_paged_attention.py:216"),
}


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls
    (CUDA events, after one warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def bound_ms(nbytes: float, ops: float, peak_ops: float):
    tb = nbytes / H100_BYTES_PER_S * 1e3
    to = ops / peak_ops * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


class Results:
    def __init__(self):
        self.rows = {}
        self.failures = []

    def check(self, name, err, tol, what, metric="max_abs_err"):
        ok = bool(np.isfinite(err)) and err <= tol
        log(f"check {name} {what}: {metric}={err:.6g} tol={tol:.6g} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            self.failures.append(f"{name} {what}: {err} > {tol}")

    def kernel(self, name, **kw):
        row = self.rows.setdefault(name, dict(
            name=name, **KERNELS[name], launches=0, max_abs_err=0.0,
            ms=None, plain_ms=None, bound_ms=None, bound_by=None,
            library_ms=None))
        row["max_abs_err"] = max(row["max_abs_err"], kw.pop("err", 0.0))
        row.update({k: v for k, v in kw.items() if v is not None})


# ------------------------------------------------------------------ kernels

def check_gemms(res: Results, dev):
    import torch

    from triton_distributed_tpu_torch.kernels import group_gemm as gg

    g = torch.Generator(device=dev).manual_seed(1)
    be = torch.zeros((1,), dtype=torch.int32, device=dev)
    # the four W8A8 projections of one Llama-7B layer at T = 768 packed
    # tokens: wqkv, wo, up (K = 4096) and down (K = 11008)
    for m, k, n in ((768, 4096, 12288), (768, 4096, 4096),
                    (768, 4096, 11008), (768, 11008, 4096)):
        x = torch.randn((m, k), generator=g, device=dev, dtype=torch.bfloat16)
        w = torch.randn((1, k, n), generator=g, device=dev,
                        dtype=torch.bfloat16) / math.sqrt(k)
        xq, xs = gg.quantize_act_rows(x)
        wq, ws = gg.quantize_grouped_weights(w)
        kw = dict(w_scale=ws, x_scale=xs, out_dtype=torch.bfloat16)
        out = gg.grouped_matmul(xq, wq, be, **kw)
        ref = gg.grouped_matmul_plain(xq, wq, be, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        # exact s32 sums on both sides and the same f32 epilogue: the
        # only allowed difference is one bf16 rounding step
        tol = ref.float().abs().max().item() * 2.0 ** -8
        res.check("ggemm_w8a8", err, tol, f"M={m} K={k} N={n}")
        ms = time_ms(lambda: gg.grouped_matmul(xq, wq, be, **kw), 10)
        plain = time_ms(lambda: gg.grouped_matmul_plain(xq, wq, be, **kw), 3)
        wcol = wq[0].t().contiguous().t()      # column-major for _int_mm
        try:
            lib = time_ms(lambda: (torch._int_mm(xq, wcol).float() * xs
                                   * ws).to(torch.bfloat16), 10)
        except RuntimeError as e:            # yardstick only
            log(f"library ggemm_w8a8 torch._int_mm unavailable: {e}")
            lib = None
        nbytes = m * k + 4 * m + k * n + 4 * n + 2 * m * n
        b, by = bound_ms(nbytes, 2.0 * m * n * k, H100_INT8_OPS)
        log(f"time ggemm_w8a8 M={m} K={k} N={n}: kernel_ms={ms:.4f} "
            f"plain_ms={plain:.4f} library_ms={lib} bound_ms={b:.4f} ({by})")
        if (k, n) == (4096, 12288):           # the row reports wqkv
            res.kernel("ggemm_w8a8", err=err, ms=ms, plain_ms=plain,
                       library_ms=lib, bound_ms=b, bound_by=by)
        else:
            res.kernel("ggemm_w8a8", err=err)

    # lm_head: 16 slots, W8A16 with f32 logits
    m, k, n = 16, 4096, 32000
    x = torch.randn((m, k), generator=g, device=dev, dtype=torch.bfloat16)
    w = torch.randn((1, k, n), generator=g, device=dev,
                    dtype=torch.bfloat16) / math.sqrt(k)
    wq, ws = gg.quantize_grouped_weights(w)
    kw = dict(w_scale=ws, out_dtype=torch.float32)
    out = gg.grouped_matmul(x, wq, be, **kw)
    ref = gg.grouped_matmul_plain(x, wq, be, **kw)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    # f32 sums of exact bf16 x int8 products in another order
    tol = 1e-5 * max(1.0, ref.abs().max().item()) * math.sqrt(k)
    res.check("ggemm_w8a16", err, tol, f"M={m} K={k} N={n}")
    ms = time_ms(lambda: gg.grouped_matmul(x, wq, be, **kw), 20)
    plain = time_ms(lambda: gg.grouped_matmul_plain(x, wq, be, **kw), 5)
    wdq = gg.dequantize_grouped_weights(wq, ws, torch.bfloat16)[0]
    lib = time_ms(lambda: torch.matmul(x, wdq), 20)
    nbytes = 2 * m * k + k * n + 4 * n + 4 * m * n
    b, by = bound_ms(nbytes, 2.0 * m * n * k, H100_BF16_OPS)
    log(f"time ggemm_w8a16 M={m} K={k} N={n}: kernel_ms={ms:.4f} "
        f"plain_ms={plain:.4f} library_ms={lib:.4f} bound_ms={b:.4f} ({by})")
    res.kernel("ggemm_w8a16", err=err, ms=ms, plain_ms=plain,
               library_ms=lib, bound_ms=b, bound_by=by)


def attention_batch(dev, quant: bool, seed: int = 2):
    """R = 16 rows at Hkv = 32, G = 1, D = 128, page 16: prefill chunks,
    decode rows, one q_len == 0 row, one SHARED_PREFIX, one TREE and
    one CP row."""
    import torch

    from triton_distributed_tpu_torch.kernels import quantize_kv
    from triton_distributed_tpu_torch.kernels import ragged_paged_attention as rpa

    hkv, g, d, page, pps = 32, 1, 128, 16, 64
    rng = np.random.default_rng(seed)
    #            kv_len, q_len
    rows = [(256, 256), (1000, 128), (384, 64), (700, 1), (1024, 1),
            (33, 1), (512, 1), (17, 1), (300, 0), (129, 1), (640, 1),
            (900, 1), (480, 32), (64, 8), (200, 5), (750, 1)]
    kinds = {9: ("shared", 64), 14: ("tree", [-1, 0, 0, 1]),
             13: ("cp", 40)}
    r = len(rows)
    kv_lens = np.array([a for a, _ in rows], np.int32)
    q_lens = np.array([b for _, b in rows], np.int32)
    q_starts = np.zeros((r,), np.int32)
    nxt = 0
    for i, (_, ql) in enumerate(rows):
        q_starts[i] = nxt
        nxt += -(-ql // 8) * 8
    block_q = rpa.auto_block_q(int(q_lens.max()), g)
    t = nxt + block_q
    q_starts[q_lens == 0] = nxt                  # the parking zone
    npages = r * pps
    table = rng.permutation(npages).astype(np.int32).reshape(r, pps)
    table[0, 20:] = -1                           # unallocated tail entries
    w = rpa.topo_width(block_q)
    topo = rpa.causal_topologies(r, w)
    for i, (kind, arg) in kinds.items():
        if kind == "shared":
            topo[i] = rpa.shared_prefix_topology_row(arg, w)
        elif kind == "tree":
            topo[i] = rpa.tree_topology_row(arg, w)
        else:
            topo[i] = rpa.cp_topology_row(arg, w)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = torch.bfloat16
    q = torch.randn((hkv, t * g, d), generator=gen, device=dev, dtype=dt)
    kf = torch.randn((npages, hkv, page, d), generator=gen, device=dev,
                     dtype=dt)
    vf = torch.randn((npages, hkv, page, d), generator=gen, device=dev,
                     dtype=dt)
    put = lambda a: torch.as_tensor(a, device=dev)   # noqa: E731
    args = [q]
    kw = dict(group=g, topologies=put(topo), block_q=block_q)
    if quant:
        kq, ks = quantize_kv(kf)
        vq, vs = quantize_kv(vf)
        args += [kq, vq]
        kw.update(k_scale=ks, v_scale=vs)
    else:
        args += [kf, vf]
    args += [put(kv_lens), put(q_lens), put(q_starts), put(table)]
    return args, kw, dict(rows=rows, page=page, hkv=hkv, g=g, d=d, t=t,
                          pps=pps, topo=topo)


def attention_work(info, quant: bool):
    """(bytes, operations) the batch needs: q, out and lse once, the
    pages each row walks once, and 4·D operations per visible
    (query, position) pair."""
    import torch

    from triton_distributed_tpu_torch.kernels.ragged_paged_attention import (
        _row_mask,
    )

    hkv, g, d, page, t = (info[k] for k in ("hkv", "g", "d", "page", "t"))
    topo = torch.as_tensor(info["topo"])
    el = 1 if quant else 2
    pages = pairs = 0
    for i, (kv, ql) in enumerate(info["rows"]):
        if ql == 0:
            continue
        pages += min(max(-(-kv // page), 1), info["pps"])
        s_len = -(-kv // page) * page
        w = (topo.shape[1] - 2) // 2
        ok = _row_mask(int(topo[i, 0]), int(topo[i, 1]), topo[i, 2:2 + w],
                       kv, ql, g, s_len, "cpu")
        pairs += int(ok.sum())
    kv_bytes = pages * hkv * page * (2 * d * el + (8 if quant else 0))
    nbytes = hkv * t * g * d * 2 * 2 + hkv * t * g * 4 + kv_bytes
    return nbytes, 4.0 * d * pairs * hkv


def check_attention(res: Results, dev):
    import torch
    import torch.nn.functional as F

    from triton_distributed_tpu_torch.kernels import ragged_paged_attention as rpa
    from triton_distributed_tpu_torch.kernels.ragged_paged_attention import (
        _row_mask,
    )

    for quant in (True, False):
        args, kw, info = attention_batch(dev, quant)
        out, lse = rpa.ragged_paged_attention(*args, **kw)
        # the plain version in f32 on the same values: q and bf16 pools
        # widened, int8 pools dequantized in f32. The kernel computes in
        # f32 too and folds the int8 scales exactly, so out differs only
        # by its rounding to bf16 (at most 2^-8·|ref|) and the f32
        # summation order, which the atol covers on outputs near 0
        q, kp, vp, *meta = args
        if not quant:
            kp, vp = kp.float(), vp.float()
        ref, rlse = rpa.ragged_paged_attention_plain(
            q.float(), kp, vp, *meta, **kw)
        torch.cuda.synchronize()
        tag = "int8 pools" if quant else "bf16 pools"
        diff = (out.float() - ref).abs()
        err = diff.max().item()
        lerr = (lse - rlse).abs().max().item()
        excess = (diff - ATTN_RTOL * ref.abs()).max().item()
        res.check("ragged_paged_attention", excess, ATTN_ATOL, f"{tag} out",
                  metric=f"max(|err|-{ATTN_RTOL:g}|ref|)")
        log(f"check ragged_paged_attention {tag} out: max_abs_err={err:.6g}")
        res.check("ragged_paged_attention", lerr, ATTN_LSE_TOL, f"{tag} lse")
        ms = time_ms(lambda: rpa.ragged_paged_attention(*args, **kw), 10)
        plain = time_ms(
            lambda: rpa.ragged_paged_attention_plain(*args, **kw), 2)
        # yardstick: SDPA per row on its gathered contiguous KV (bf16,
        # dequantized beforehand) with the row's mask (G = 1 here)
        q, kp, vp, _, _, q_starts, table = args
        topo = torch.as_tensor(info["topo"], device=dev)
        w = (topo.shape[1] - 2) // 2
        jobs = []
        for i, (kv, ql) in enumerate(info["rows"]):
            if ql == 0:
                continue
            nb = -(-kv // info["page"])
            pg = torch.clamp(table[i, :nb].long(), 0, kp.shape[0] - 1)
            kc, vc = kp[pg], vp[pg]
            if quant:
                kc = kc.float() * kw["k_scale"][pg][..., None]
                vc = vc.float() * kw["v_scale"][pg][..., None]
            kc = kc.to(torch.bfloat16).permute(1, 0, 2, 3).reshape(
                info["hkv"], -1, info["d"])[:, :kv]
            vc = vc.to(torch.bfloat16).permute(1, 0, 2, 3).reshape(
                info["hkv"], -1, info["d"])[:, :kv]
            qs = int(q_starts[i])
            mask = _row_mask(int(topo[i, 0]), int(topo[i, 1]),
                             topo[i, 2:2 + w], kv, ql, 1, kv, dev)
            jobs.append((q[:, qs:qs + ql][None], kc[None].contiguous(),
                         vc[None].contiguous(), mask[None, None]))

        def lib_call():
            for qr, kc, vc, mask in jobs:
                F.scaled_dot_product_attention(qr, kc, vc, attn_mask=mask)

        lib = time_ms(lib_call, 10)
        nbytes, ops = attention_work(info, quant)
        b, by = bound_ms(nbytes, ops, H100_BF16_OPS)
        log(f"time ragged_paged_attention {tag}: kernel_ms={ms:.4f} "
            f"plain_ms={plain:.4f} library_ms={lib:.4f} (SDPA per row) "
            f"bound_ms={b:.4f} ({by})")
        if quant:                              # the main path's pools
            res.kernel("ragged_paged_attention", err=max(err, lerr), ms=ms,
                       plain_ms=plain, library_ms=lib, bound_ms=b,
                       bound_by=by)
        else:
            res.kernel("ragged_paged_attention", err=max(err, lerr))


# -------------------------------------------------------------- end to end

def check_tiny(res: Results, dev):
    """The int8 tiny model on the card (kernels) and on the CPU (plain
    versions) from the same weights."""
    import torch

    from triton_distributed_tpu_torch.models import Transformer, presets
    from triton_distributed_tpu_torch.serving import (
        EngineConfig,
        ServingEngine,
        poisson_trace,
    )

    cfg = presets.tiny(kv_quant="int8", dense_weight_quant="int8",
                       dense_act_quant="int8")
    cpu = Transformer(cfg, device="cpu")
    params_cpu = cpu.quantize_dense_weights(
        cpu.init(torch.Generator().manual_seed(0)))
    gpu = Transformer(cfg, device=dev)

    def to_dev(node):
        if isinstance(node, dict):
            return {k: to_dev(v) for k, v in node.items()}
        if isinstance(node, list):
            return [to_dev(v) for v in node]
        return node.to(dev)

    params_gpu = to_dev(params_cpu)
    ecfg = EngineConfig(slots=4, token_budget=48, chunk=16, page=8,
                        npages=12)
    streams = []
    for model, params in ((gpu, params_gpu), (cpu, params_cpu)):
        trace = poisson_trace(7, 8, 1.0, 5, 30, 3, 6, cfg.vocab)
        stats = ServingEngine(model, params, ecfg).run(trace, max_steps=600)
        streams.append([r.generated for r in trace])
        if stats.completed != len(trace):
            res.failures.append(f"tiny: {stats.completed}/{len(trace)} "
                                "requests completed")
    same = streams[0] == streams[1]
    log(f"check tiny int8 engine: token streams card == cpu: {same} "
        f"({sum(map(len, streams[0]))} tokens)")
    if not same:
        res.failures.append("tiny: card and CPU token streams differ")


class _CheckedEngine:
    """Mixin: every batched row's logits must be finite."""

    bad_rows = 0

    def _advance_row(self, s, req, take, logits):
        if not np.isfinite(logits[s]).all():
            self.bad_rows += 1
        return super()._advance_row(s, req, take, logits)


def run_main(res: Results, dev):
    import torch

    from triton_distributed_tpu_torch.kernels import (
        launch_counts,
        reset_launch_counts,
    )
    from triton_distributed_tpu_torch.models import Transformer, presets
    from triton_distributed_tpu_torch.serving import (
        EngineConfig,
        ServingEngine,
        poisson_trace,
    )

    cfg = presets.llama_7b(kv_quant="int8", dense_weight_quant="int8",
                           dense_act_quant="int8")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Transformer(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        quantize=True)
    ecfg = EngineConfig(slots=16, token_budget=512, chunk=256, page=16,
                        npages=2048)
    Engine = type("Engine", (_CheckedEngine, ServingEngine), {})
    eng = Engine(model, params, ecfg)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    trace = poisson_trace(seed=11, n_requests=16, mean_interarrival=0.25,
                          len_lo=128, len_hi=1024, max_new_lo=16,
                          max_new_hi=32, vocab=cfg.vocab)
    reset_launch_counts()
    t1 = time.perf_counter()
    stats = eng.run(trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"main llama_7b int8 layers={cfg.n_layers}: setup_s={setup:.2f} "
        f"completed={stats.completed}/{len(trace)} "
        f"generated_tokens={stats.generated_tokens} "
        f"prefill_tokens={stats.prefill_tokens} steps={len(stats.step_times)}"
        f" evictions={stats.evictions} wall_s={wall:.2f} "
        f"tok_s={stats.generated_tokens / wall:.2f} "
        f"packed_tok_s={sum(stats.step_tokens) / wall:.2f} "
        f"p50_step_ms={stats.p50_step_ms:.2f} "
        f"p99_step_ms={stats.p99_step_ms:.2f} peak_mem_gib={peak:.2f}")
    log("kernels " + " ".join(f"{k}={v}" for k, v in counts.items()))
    for name, n in counts.items():
        res.kernel(name, launches=n)
        if n == 0:
            res.failures.append(f"main: {name} never launched")
    if stats.completed != len(trace):
        res.failures.append(
            f"main: {stats.completed}/{len(trace)} requests completed")
    if eng.bad_rows:
        res.failures.append(f"main: {eng.bad_rows} rows of non-finite "
                            "logits")
    return model, params, ecfg, trace


def run_profile(model, params, ecfg, trace, steps: int = 8):
    """Device time by kernel and the device's idle share over ``steps``
    engine steps of the same trace (torch.profiler, CUDA activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from triton_distributed_tpu_torch.serving import ServingEngine, Request

    eng = ServingEngine(model, params, ecfg)
    eng.submit_trace([Request(rid=r.rid, prompt=r.prompt, max_new=r.max_new,
                              arrival=r.arrival) for r in trace])
    for _ in range(3):                       # past the first arrivals
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for ev in prof.key_averages():
        # device-side entries only (kernels, memcpy, memset): the host
        # ops that launched them carry the same time again
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us, ev.key, ev.count))
    rows.sort(reverse=True)
    busy = sum(us for us, _, _ in rows)
    log(f"profile {steps} steps: wall_ms={wall_us / 1e3:.2f} "
        f"device_busy_ms={busy / 1e3:.2f} "
        f"idle_share={max(0.0, 1 - busy / wall_us):.4f}")
    for us, key, n in rows[:10]:
        log(f"  profile {us / 1e3:9.3f} ms {100 * us / busy:5.1f}% "
            f"x{n} {key[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="after the main path, profile a few engine steps")
    opts = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; nothing was run")
        return 2
    try:
        from triton_distributed_tpu_torch.kernels import _build
    except ImportError as e:
        log(f"chip_smoke: the port's package is missing ({e})")
        return 3
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    log(f"device {smi} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | {torch.cuda.get_device_name(0)}")
    res = Results()
    t0 = time.perf_counter()
    _build.lib()
    log(f"build {len(_build.sources())} sources in "
        f"{time.perf_counter() - t0:.2f} s")
    check_gemms(res, dev)
    check_attention(res, dev)
    check_tiny(res, dev)
    main_run = run_main(res, dev)
    if opts.profile:
        run_profile(*main_run)
    if res.failures:
        for f in res.failures:
            log(f"FAIL {f}")
        return 1
    log(json.dumps({"kernels": list(res.rows.values())}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
