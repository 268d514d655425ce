"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, all run every time:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions;
2. build: compile the CUDA kernels of ``triton_distributed_tpu_torch/
   csrc`` (timed);
3. kernels: each kernel against its plain PyTorch version on seeded
   inputs at the serving steps' shapes, with its time, the plain
   version's, a PyTorch library call's, and the card's bound for the
   same work — the dense W8A8 projections, the W8A16 lm_head and
   attention at the shapes of the Llama-2-7B step and of the
   DeepSeek-MoE-16B step, and the MoE step's chunked all-to-all (both
   legs, both modes, byte-exact) and expert GEMMs (bf16 and W8A8, 64
   experts); and the decode path's kernels at Llama-2-7B's full width:
   flash decode (bf16 and int8, contiguous bhsd and bshd, paged at page
   128, one soft-capped case) and the world-size-1 AG-GEMM / GEMM-RS at
   the prefill's shapes; the two MoE-TP kernels (AG + grouped GEMM with
   the gather fused into its tile load, grouped GEMM + RS) at the
   DeepSeek-MoE-16B TP prefill's shapes, and in f32 and bf16 with an
   empty expert; and the tensor-parallel kernels at the Llama-2-7B tp = 4
   path's shapes, four ranks of a loopback mesh in each launch: the
   AG-GEMM and GEMM-RS over the mesh (bf16, the prefill's wqkv / up and
   wo / down) and the all-gather of the decode's attention partials
   (byte-exact). The kernels line reports each kernel at the shapes of
   the path that launches it, its times averaged over them by their
   launches a step;
4. tiny: the int8 tiny dense model, the tiny DeepSeek-MoE preset and
   its float-expert variant, each served on the card and on the CPU
   from the same weights; the tiny f32 and int8 models, and the tiny
   DeepSeek-MoE preset as served (EP) and in its TP flavour, through
   prefill + generate, contiguous and paged, and the tiny int8 model at
   tp = 4 on a loopback mesh — the token streams must be equal, and the
   card's run must launch the kernels of its path;
5. the serving paths, each a continuous-batching engine serving the
   same Poisson trace with the launches of every kernel counted over
   the run: the Llama-2-7B geometry (int8 KV, W8A8 projections, W8A16
   lm_head); DeepSeek-MoE-16B with bf16 experts; and the main path,
   DeepSeek-MoE-16B at full width and depth (28 layers, 64 experts
   top-6 over an fp8 EP wire, W8A8 experts and projections, int8 KV),
   last. ``--profile`` then profiles a few of the main path's engine
   steps (device time by kernel, host enqueue time, the device's idle
   share), and a prefill and a few decode steps of each decode and MoE
   generation path;
6. the decode path, Llama-2-7B at full width and depth in bf16 (bf16
   weights and KV) and in int8 (int8 KV, W8A8): 8 seeded prompts of
   128–1024 tokens prefilled into contiguous caches of capacity 2048,
   a paged copy at page 128, 64 greedy steps on each; the first step's
   logits and the token streams of the two layouts must agree. Then the
   tensor-parallel path: the bf16 run's weights sharded over a loopback
   mesh of 4 ranks on the card (``Transformer(cfg, mesh=...)``), the same
   prompts prefilled through the mesh AG-GEMM / GEMM-RS (64 launches
   each, every launch covering the 4 ranks) into sequence-sharded
   caches (the first step's logits within 1e-3 of the largest tp = 1
   logit), 32 steps decoded in lockstep with the tp = 1 model, both fed
   its greedy tokens (every step's logits on every row within a stated
   bf16 tolerance, the tokens equal on the rows whose top-2 margin
   exceeds it; the last step again with one rank's partial lost must
   break that tolerance), and 32 timed greedy steps (the all-gather
   twice a layer and step). Then the port's ``tools.generate`` CLI on
   its default device once in bf16, and once with ``--tp 4``;
7. the MoE generation path, DeepSeek-MoE-16B at full width and depth as
   served (EP: fp8 wire, W8A8 int8 experts, int8 KV, W8A8 dense) and in
   its TP flavour with bf16 experts: the same batch, caches and layouts
   as the decode path, 32 greedy steps on each, the EP decode over its
   persistent workspaces; the TP prefill must launch each MoE-TP kernel
   once a MoE layer (27 times). Then ``tools.generate --preset
   deepseek_moe_16b`` once. The run's wall time is printed last before
   the result lines.

Exits non-zero, printing no result line, without a CUDA device or
without the port's package beside it. The last line is
``{"ok": true, "device": {...}}``; the line before it is the card's
name and power limit, and the line before that the ``{"kernels": ...}``
summary.
"""

from __future__ import annotations

import argparse
import contextlib
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
    "ggemm_bf16": dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/group_gemm.cu",
        replaces="triton_distributed_tpu/kernels/group_gemm.py:32"),
    "chunked_a2a": dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/moe_dispatch.cu",
        replaces="triton_distributed_tpu/kernels/moe_dispatch.py:346"),
    # the strided walk also stands for :51 (unaligned, bshd) and :331
    # (int8); the block-table walk for :470 (int8)
    "flash_decode": dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/flash_decode.cu",
        replaces="triton_distributed_tpu/kernels/flash_decode.py:144"),
    "paged_decode": dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/flash_decode.cu",
        replaces="triton_distributed_tpu/kernels/flash_decode.py:1005"),
    "ag_gemm_n1": dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/group_gemm.cu",
        replaces="triton_distributed_tpu/kernels/ag_gemm.py:227"),
    "gemm_rs_n1": dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/group_gemm.cu",
        replaces="triton_distributed_tpu/kernels/gemm_rs.py:248"),
    "ag_group_gemm": dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/moe_tp_fused.cu",
        replaces="triton_distributed_tpu/kernels/moe_tp_fused.py:172"),
    "moe_reduce_rs": dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/moe_tp_fused.cu",
        replaces="triton_distributed_tpu/kernels/moe_tp_fused.py:285"),
    # the two fused TP kernels again, over a mesh of 4 ranks (the rows
    # above are their GEMM bodies at world size 1)
    "ag_gemm": dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/ag_gemm.cu",
        replaces="triton_distributed_tpu/kernels/ag_gemm.py:227"),
    "gemm_rs": dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/gemm_rs.cu",
        replaces="triton_distributed_tpu/kernels/gemm_rs.py:248"),
    # also stands for the small-message push, allgather.py:199
    "all_gather": dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/allgather.cu",
        replaces="triton_distributed_tpu/kernels/allgather.py:42"),
    # the MoE path over the mesh: the all-to-all across 4 ranks (barrier
    # and LL modes) and the two MoE-TP kernels' mesh forms, each launch
    # covering every rank (the rows above are their one-rank forms)
    "chunked_a2a_mesh": dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/moe_dispatch.cu",
        replaces="triton_distributed_tpu/kernels/moe_dispatch.py:346"),
    "ag_group_gemm_mesh": dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/moe_tp_fused.cu",
        replaces="triton_distributed_tpu/kernels/moe_tp_fused.py:172"),
    "moe_reduce_rs_mesh": dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/moe_tp_fused.cu",
        replaces="triton_distributed_tpu/kernels/moe_tp_fused.py:285"),
}

#: the kernels of the decode path: their rows' launches and shapes come
#: from its runs (decode steps for the attention, prefills for the GEMMs)
DECODE_ROWS = ("flash_decode", "paged_decode", "ag_gemm_n1", "gemm_rs_n1")

#: the MoE-TP kernels: their rows' launches and shapes come from the MoE
#: generation path's TP prefill (27 MoE layers, one launch of each a layer)
MOE_TP_ROWS = ("ag_group_gemm", "moe_reduce_rs")

#: the tensor-parallel path: Llama-2-7B at tp = 4 on a loopback mesh, the
#: decode path's prompts and caches, 32 greedy steps; its GEMM rows'
#: launches come from its prefill (32 a shape), the all-gather's from
#: its timed decode steps (2 a layer)
TP, TP_STEPS = 4, 32
TP_ROWS = ("ag_gemm", "gemm_rs")
# its first-step logits against the tp = 1 run's, relative to the
# largest tp = 1 logit: the mesh GEMMs sum every output in the one-rank
# GEMMs' K order and each rank's attention is the same per-head
# arithmetic, so the prefill reads bit-equal; 1e-3 leaves room for a
# summation order change
TP_PREFILL_RTOL = 1e-3
# every teacher-forced decode step's logits against tp = 1's: the
# per-rank projections summed in f32 and the sequence-parallel combine
# round apart from the one-rank path. On an H100 the steps read at most
# 1.6 % of the largest logit, and losing the partial of a rank that
# holds positions at least 24 %: 5 % lies between
TP_DECODE_RTOL = 0.05
# the same for DeepSeek-MoE-16B at tp = 4 (W8A8 projections, int8 KV,
# top-6 routing): a last-bit difference of the per-rank sums can move an
# int8 activation code or a routing choice, which moves a row's logits
# far more than in the bf16 Llama path, so the steps are held by the
# largest difference and by the relative rms of the difference over
# every logit. On an H100 the 32 steps of either flavour read at most
# 10.2 % and 6.7 %, losing any rank's share of the MoE output at least
# 17.9 % and 17.0 %: 14 % and 10 % lie between
MOE_TP_DECODE_RTOL = 0.14
MOE_TP_DECODE_RMS = 0.10
#: the MoE path over the mesh: DeepSeek-MoE-16B at tp = 4 in both
#: flavours, from the MoE generation path's weights and prompts. The
#: MoE-TP mesh rows' launches come from its TP prefill (27 a kernel), the
#: all-to-all's from its EP run's timed greedy steps (54 a step)
MOE_MESH_ROWS = ("ag_group_gemm_mesh", "moe_reduce_rs_mesh")
# the reference's published dispatch: 128 tokens a rank, top-8, hidden
# 7168, fp8, on 32 H800s (SURVEY.md section 6)
REF_DISPATCH_US = 137.0
# the decode path: 8 rows, prompts of 128-1024 tokens padded to 1024,
# caches of capacity 2048, pages of 128, 64 greedy steps
DEC_B, DEC_PROMPT, DEC_CAP, DEC_PAGE, DEC_STEPS = 8, 1024, 2048, 128, 64
# the MoE generation path: the same batch and caches, 32 greedy steps
MOE_GEN_STEPS = 32
# its prefill's MoE-TP GEMMs at block_m 128: 8192 tokens, top-6
MOE_TP_BM = 128

# every serving step packs 768 rows (token_budget 512 plus the 256-row
# parking zone) for 16 slots
T_PAD, SLOTS = 768, 16
# the MoE main path's step: hidden 2048, 64 experts of ffn 1408, top-6
MOE_T, MOE_H, MOE_F, MOE_E, MOE_K = T_PAD, 2048, 1408, 64, 6

# bf16 expert GEMM against its plain version in f32:
# |out - ref| <= GG_RTOL·|ref| + GG_ATOL·max|ref| (one bf16 rounding of
# the output, and the f32 summation order)
GG_RTOL, GG_ATOL = 2.0 ** -8, 1e-4


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


def graph_time_ms(fn, iters: int = 24, reps: int = 10) -> float:
    """Device time of one ``fn(i)`` call, launched from a CUDA graph of
    ``iters`` calls (i = 0, 1, ...) replayed ``reps`` times: for a
    kernel shorter than its wrapper's host work, where back-to-back
    calls would time the host. ``fn`` cycles through buffers by ``i``
    so that the calls do not hit the 50 MB L2 cache."""
    import torch

    fn(0)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    return time_ms(graph.replay, reps) / iters


def bound_ms(nbytes: float, ops: float, peak_ops: float):
    tb = nbytes / H100_BYTES_PER_S * 1e3
    to = ops / peak_ops * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


class Results:
    """Checks, and the kernels line's rows. A row's ``ms``, ``plain_ms``,
    ``library_ms`` and ``bound_ms`` are per launch, averaged over the
    shapes its path launches it at, each weighted by its launches per
    step (:meth:`shape`), so that they belong to the launches counted
    beside them."""

    def __init__(self):
        self.rows = {}
        self.failures = []
        self.mix = {}

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

    def shape(self, name, per_step, ms, plain_ms, library_ms, nbytes, ops,
              peak_ops):
        """One shape at which the path launches ``name`` ``per_step``
        times a step, with its times and its work."""
        self.mix.setdefault(name, []).append(dict(
            n=per_step, ms=ms, plain=plain_ms, lib=library_ms,
            bytes=nbytes, ops=ops, peak=peak_ops))

    def finish_rows(self):
        for name, shapes in self.mix.items():
            total = sum(s["n"] for s in shapes)

            def mean(key):
                return sum(s["n"] * s[key] for s in shapes) / total

            lib = (mean("lib") if all(s["lib"] is not None for s in shapes)
                   else None)
            b, by = bound_ms(mean("bytes"), mean("ops"), shapes[0]["peak"])
            self.kernel(name, ms=mean("ms"), plain_ms=mean("plain"),
                        library_ms=lib, bound_ms=b, bound_by=by)
            log(f"row {name} over {len(shapes)} shapes, {total} launches a "
                f"step: kernel_ms={mean('ms'):.4f} plain_ms="
                f"{mean('plain'):.4f} library_ms={lib} bound_ms={b:.4f} "
                f"({by})")


# ------------------------------------------------------------------ kernels

def dense_shapes(cfg):
    """The W8A8 projections of one serving step at ``T_PAD`` packed
    rows: (what, (M, K, N), launches a step). The MLP runs only on the
    layers without experts."""
    dense = sum(1 for i in range(cfg.n_layers)
                if cfg.moe == "none" or i not in cfg.moe_layers)
    t, h, f = T_PAD, cfg.hidden, cfg.ffn
    shapes = [("wqkv", (t, h, cfg.qkv_dim), cfg.n_layers),
              ("wo", (t, cfg.q_dim, h), cfg.n_layers)]
    if dense:
        shapes += [("up", (t, h, f), dense), ("down", (t, f, h), dense)]
    return shapes


def check_gemms(res: Results, dev, path, cfg, main: bool):
    """The dense W8A8 projections and the W8A16 lm_head of ``path`` at
    its shapes, each against its plain version. The main path's shapes
    also feed the kernels line (:meth:`Results.shape`)."""
    import torch

    from triton_distributed_tpu_torch.kernels import group_gemm as gg

    g = torch.Generator(device=dev).manual_seed(1)
    be = torch.zeros((1,), dtype=torch.int32, device=dev)
    for what, (m, k, n), per_step in dense_shapes(cfg):
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
        tag = f"{path} {what} M={m} K={k} N={n}"
        res.check("ggemm_w8a8", err, tol, tag)
        res.kernel("ggemm_w8a8", err=err)
        ms = time_ms(lambda: gg.grouped_matmul(xq, wq, be, **kw), 10)
        plain = time_ms(lambda: gg.grouped_matmul_plain(xq, wq, be, **kw), 3)
        wcol = wq[0].t().contiguous().t()      # column-major for _int_mm
        lib = time_ms(lambda: (torch._int_mm(xq, wcol).float() * xs
                               * ws).to(torch.bfloat16), 10)
        nbytes = m * k + 4 * m + k * n + 4 * n + 2 * m * n
        ops = 2.0 * m * n * k
        b, by = bound_ms(nbytes, ops, H100_INT8_OPS)
        log(f"time ggemm_w8a8 {tag} ({per_step}/step): kernel_ms={ms:.4f} "
            f"plain_ms={plain:.4f} library_ms={lib:.4f} (torch._int_mm + "
            f"epilogue) bound_ms={b:.4f} ({by})")
        if main:
            res.shape("ggemm_w8a8", per_step, ms, plain, lib, nbytes, ops,
                      H100_INT8_OPS)

    # lm_head: the slots' last rows, W8A16 with f32 logits
    m, k, n = SLOTS, cfg.hidden, cfg.vocab
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
    tag = f"{path} lm_head M={m} K={k} N={n}"
    res.check("ggemm_w8a16", err, tol, tag)
    res.kernel("ggemm_w8a16", err=err)
    ms = time_ms(lambda: gg.grouped_matmul(x, wq, be, **kw), 20)
    plain = time_ms(lambda: gg.grouped_matmul_plain(x, wq, be, **kw), 5)
    wdq = gg.dequantize_grouped_weights(wq, ws, torch.bfloat16)[0]
    lib = time_ms(lambda: torch.matmul(x, wdq), 20)
    nbytes = 2 * m * k + k * n + 4 * n + 4 * m * n
    ops = 2.0 * m * n * k
    b, by = bound_ms(nbytes, ops, H100_BF16_OPS)
    log(f"time ggemm_w8a16 {tag} (1/step): kernel_ms={ms:.4f} "
        f"plain_ms={plain:.4f} library_ms={lib:.4f} (torch.matmul, "
        f"dequantized bf16 W) bound_ms={b:.4f} ({by})")
    if main:
        res.shape("ggemm_w8a16", 1, ms, plain, lib, nbytes, ops,
                  H100_BF16_OPS)


def attention_batch(dev, quant: bool, hkv: int, seed: int = 2):
    """R = 16 rows at ``hkv`` KV heads, G = 1, D = 128, page 16: prefill
    chunks, decode rows, one q_len == 0 row, one SHARED_PREFIX, one TREE
    and one CP row."""
    import torch

    from triton_distributed_tpu_torch.kernels import quantize_kv
    from triton_distributed_tpu_torch.kernels import ragged_paged_attention as rpa

    g, d, page, pps = 1, 128, 16, 64
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


def check_attention(res: Results, dev, path, cfg, main: bool):
    """Attention at ``path``'s heads (G = 1, D = 128 on both paths),
    over int8 pools (the serving paths') and bf16 pools."""
    import torch
    import torch.nn.functional as F

    from triton_distributed_tpu_torch.kernels import ragged_paged_attention as rpa
    from triton_distributed_tpu_torch.kernels.ragged_paged_attention import (
        _row_mask,
    )

    if (cfg.n_heads, cfg.head_dim) != (cfg.n_kv_heads, 128):
        raise AssertionError(f"{path}: the batch is built for G = 1, "
                             "D = 128")
    for quant in (True, False):
        args, kw, info = attention_batch(dev, quant, cfg.n_kv_heads)
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
        tag = (f"{path} Hkv={cfg.n_kv_heads} "
               + ("int8 pools" if quant else "bf16 pools"))
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
        res.kernel("ragged_paged_attention", err=max(err, lerr))
        if main and quant:                     # the serving paths' pools
            res.shape("ragged_paged_attention", cfg.n_layers, ms, plain, lib,
                      nbytes, ops, H100_BF16_OPS)


# ---------------------------------------------------------------- MoE step

def moe_step_inputs(dev, cfg, seed: int = 3):
    """The main path's MoE step on seeded inputs: 768 bf16 token rows
    routed by seeded softmax logits over 64 experts (top-6), staged
    for the fp8 wire exactly as ``ops.ep_moe`` stages them."""
    import torch

    from triton_distributed_tpu_torch import ops
    from triton_distributed_tpu_torch.kernels import moe_dispatch as md
    from triton_distributed_tpu_torch.kernels.moe_utils import select_experts

    got = (cfg.hidden, cfg.ffn, cfg.num_experts, cfg.topk, cfg.moe_wire_quant)
    if got != (MOE_H, MOE_F, MOE_E, MOE_K, "fp8"):
        raise AssertionError(f"MoE step built for (2048, 1408, 64, 6, fp8), "
                             f"the preset has {got}")
    ctx = ops.create_ep_moe_context(
        num_experts=MOE_E, topk=MOE_K, max_m=MOE_T * MOE_K, hidden=MOE_H,
        dtype=torch.bfloat16, block_m=64, quant="fp8", act_quant="int8")
    a2a = ctx.a2a
    geom = (a2a.max_m, md.slot_pad(a2a), md.m_cap(a2a))
    if geom != (4608, 4608, 4704):
        raise AssertionError(f"MoE geometry {geom} != (4608, 4608, 4704)")
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((MOE_T, MOE_H), generator=g, device=dev,
                    dtype=torch.bfloat16)
    logits = torch.randn((MOE_T, MOE_E), generator=g, device=dev)
    _, ids = select_experts(logits, MOE_K)
    flat_e = ids.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    splits = torch.zeros((MOE_E,), dtype=torch.int32, device=dev)
    splits.index_add_(0, flat_e.long(), torch.ones_like(flat_e))
    _, offs, offs_al, sendk = md.send_plan(a2a, splits)
    _, dest = md.assignment_dest(a2a, flat_e[order], offs, offs_al)
    payload, scales = md.stage_aligned(a2a, x, order // MOE_K, dest,
                                       flat_e.shape[0])
    meta = md.meta_payload(a2a, splits, scales, offs_al, sendk)
    return dict(ctx=ctx, a2a=a2a, payload=payload, meta=meta,
                offs_al=offs_al, sendk=sendk, g=g,
                n_moe=len(cfg.moe_layers))


def check_a2a(res: Results, dev, inp):
    """Dispatch and combine, in LL mode (both parities) and barrier
    mode, over windows pre-filled with a sentinel byte: the kernel's
    windows must equal the plain version's byte for byte (the rows past
    the shipped chunks keep the sentinel in both)."""
    import torch

    from triton_distributed_tpu_torch.kernels import moe_dispatch as md

    a2a, n_moe = inp["a2a"], inp["n_moe"]
    a = md.align(a2a)
    (tshape, tdt), (mshape, _) = md.ll_workspace_shapes(a2a)
    sp, mr = md.slot_pad(a2a), md.meta_rows(a2a)
    dispatch = (inp["payload"], inp["meta"].reshape(-1, 128),
                (inp["offs_al"] // a).to(torch.int32), inp["sendk"],
                torch.zeros_like(inp["sendk"]))
    toks, _ = md.recv_view(a2a, inp["payload"][:sp], inp["meta"])
    y_tok, y_meta = md.stage_return(a2a, toks)
    combine = (y_tok, y_meta.reshape(-1, 128),
               torch.zeros((1,), dtype=torch.int32, device=dev),
               inp["sendk"], inp["sendk"])

    def windows(n_windows):
        tok = torch.full((n_windows * sp, MOE_H), 0xA5, dtype=torch.uint8,
                         device=dev).view(tdt)
        meta = torch.full((n_windows * mr, 128), -0x5A5A5A5B,
                          dtype=torch.int32, device=dev)
        return tok, meta

    # at one rank every assignment ships, so the main path's window is
    # full; a push of half the chunks checks the rows past them too
    half = dispatch[:3] + (inp["sendk"] // 2,) + dispatch[4:]
    for leg, args in (("dispatch", dispatch), ("combine", combine),
                      ("half dispatch", half)):
        shipped = int(args[3][0]) * md.chunk_rows(a2a)
        for mode, nw, pars in (("LL", 2, (0, 1)), ("barrier", 1, (0,))):
            got, want = windows(nw), windows(nw)
            for par in pars:
                p = torch.tensor([par], dtype=torch.int32, device=dev)
                md.chunked_a2a(a2a, *args, *got, p)
                md.chunked_a2a_plain(a2a, *args, *want, p)
            torch.cuda.synchronize()
            bad = int((got[0].view(torch.uint8) != want[0].view(
                torch.uint8)).sum()) + int((got[1] != want[1]).sum())
            untouched = got[0].view(torch.uint8).reshape(nw, sp, -1)[
                :, shipped:]
            bad += int((untouched != 0xA5).sum())
            res.check("chunked_a2a", bad, 0, f"{leg} {mode} "
                      f"({shipped} of {sp} rows shipped)",
                      metric="bytes_differing")
    res.kernel("chunked_a2a", err=0.0)
    # the kernel and the copy_ take microseconds, their Python wrappers
    # tens: both are timed from CUDA graphs (the plain version reads the
    # counts back to the host and cannot be captured), each call on one
    # of 6 payload/window pairs (113 MB together, past the L2 cache).
    # Each MoE layer runs both legs once, in LL mode
    par = torch.zeros((1,), dtype=torch.int32, device=dev)
    wss = [windows(2) for _ in range(6)]
    for leg, args in (("dispatch", dispatch), ("combine", combine)):
        shipped = int(args[3][0]) * md.chunk_rows(a2a)
        pays = [args[0].clone() for _ in range(6)]

        def kernel(i):
            md.chunked_a2a(a2a, pays[i % 6], *args[1:], *wss[i % 6], par)

        ms = graph_time_ms(kernel)
        call = time_ms(lambda: kernel(0), 50)
        ws = wss[0]
        plain = time_ms(lambda: md.chunked_a2a_plain(a2a, *args, *ws, par),
                        10)
        srcs = [p.view(torch.uint8)[:shipped] for p in pays]
        dsts = [w[0].view(torch.uint8)[:shipped] for w in wss]
        lib = graph_time_ms(lambda i: dsts[i % 6].copy_(srcs[i % 6]))
        nbytes = 2 * (shipped * MOE_H * a2a.wire_itemsize + mr * 128 * 4)
        b, by = bound_ms(nbytes, 0.0, H100_BF16_OPS)
        log(f"time chunked_a2a {leg} fp8 {shipped} rows x {MOE_H} B "
            f"({n_moe}/step): kernel_ms={ms:.4f} (graph; back-to-back "
            f"wrapper calls {call:.4f}) plain_ms={plain:.4f} library_ms="
            f"{lib:.4f} (one copy_, graph) bound_ms={b:.4f} ({by})")
        res.shape("chunked_a2a", n_moe, ms, plain, lib, nbytes, 0.0,
                  H100_BF16_OPS)


def expert_rows(inp):
    """The up GEMM's sorted input exactly as the expert MLP builds it
    from the dispatched window: (8704, 2048) bf16 rows (zeros at the
    padding) and the expert of each 64-row block."""
    from triton_distributed_tpu_torch.kernels import moe_dispatch as md
    from triton_distributed_tpu_torch.ops.moe import _slot_tables, sort_rows

    ctx, a2a = inp["ctx"], inp["a2a"]
    sp = md.slot_pad(a2a)
    tok, meta = md.dispatch_device(a2a, inp["payload"], inp["offs_al"],
                                   inp["sendk"], inp["meta"])
    rows, rspl = md.recv_view(a2a, tok, meta)
    eid, valid = _slot_tables(ctx, rspl, sp)
    xs, be, _ = sort_rows(ctx, rows.reshape(sp, MOE_H), eid, valid)
    return xs.contiguous(), be


def check_expert_gemms(res: Results, dev, inp):
    """The expert MLP's two GEMMs at the main path's shapes (8704 sorted
    rows, 64 experts): the bf16 float mode (the bf16-expert run) and
    W8A8 (the main path), each against its plain version."""
    import torch
    import torch.nn.functional as F

    from triton_distributed_tpu_torch.kernels import group_gemm as gg

    xs, be = expert_rows(inp)
    cap, n_moe = xs.shape[0], inp["n_moe"]
    g = inp["g"]
    used = int(torch.unique(be).numel())
    w_up = torch.randn((MOE_E, MOE_H, MOE_F), generator=g, device=dev,
                       dtype=torch.bfloat16) / math.sqrt(MOE_H)
    w_down = torch.randn((MOE_E, MOE_F, MOE_H), generator=g, device=dev,
                         dtype=torch.bfloat16) / math.sqrt(MOE_F)
    h = F.silu(gg.grouped_matmul(xs, w_up, be))
    for what, x, w in (("up", xs, w_up), ("down", h, w_down)):
        k, n = w.shape[1], w.shape[2]
        out = gg.grouped_matmul(x, w, be)
        ref = gg.grouped_matmul_plain(x, w, be, out_dtype=torch.float32)
        torch.cuda.synchronize()
        diff = (out.float() - ref).abs()
        scale = ref.abs().max().item()
        excess = (diff - GG_RTOL * ref.abs()).max().item()
        res.check("ggemm_bf16", excess, GG_ATOL * scale,
                  f"{what} M={cap} K={k} N={n}",
                  metric=f"max(|err|-2^-8|ref|)")
        err = diff.max().item()
        ms = time_ms(lambda: gg.grouped_matmul(x, w, be), 10)
        plain = time_ms(lambda: gg.grouped_matmul_plain(x, w, be), 3)
        wg = w[be.long()]                      # gathered beforehand
        xb = x.reshape(-1, 64, k)
        lib = time_ms(lambda: torch.bmm(xb, wg), 10)
        del wg
        nbytes = 2 * cap * k + 2 * used * k * n + 2 * cap * n
        ops = 2.0 * cap * k * n
        b, by = bound_ms(nbytes, ops, H100_BF16_OPS)
        log(f"time ggemm_bf16 {what} M={cap} K={k} N={n} ({used} experts,"
            f" {n_moe}/step): kernel_ms={ms:.4f} plain_ms={plain:.4f} "
            f"library_ms={lib:.4f} (bmm, gathered W) bound_ms={b:.4f} "
            f"({by}) max_abs_err={err:.6g}")
        res.kernel("ggemm_bf16", err=err)
        res.shape("ggemm_bf16", n_moe, ms, plain, lib, nbytes, ops,
                  H100_BF16_OPS)
        # W8A8 at the same expert shapes (the main path's experts)
        wq, ws = gg.quantize_grouped_weights(w)
        xq, xsc = gg.quantize_act_rows(x)
        kw = dict(w_scale=ws, x_scale=xsc, out_dtype=torch.bfloat16)
        out = gg.grouped_matmul(xq, wq, be, **kw)
        ref = gg.grouped_matmul_plain(xq, wq, be, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        res.check("ggemm_w8a8", err, ref.float().abs().max().item()
                  * 2.0 ** -8, f"deepseek_moe_16b experts {what} M={cap} "
                  f"K={k} N={n}")
        res.kernel("ggemm_w8a8", err=err)
        ms = time_ms(lambda: gg.grouped_matmul(xq, wq, be, **kw), 10)
        plain = time_ms(lambda: gg.grouped_matmul_plain(xq, wq, be, **kw), 2)
        # no PyTorch call multiplies int8 per expert block (``_int_mm`` is
        # one 2-D product): the yardstick is ``bmm`` on the dequantized
        # bf16 rows and the dequantized weights gathered per block
        xdq = (xq.float() * xsc).to(torch.bfloat16).reshape(-1, 64, k)
        wg = gg.dequantize_grouped_weights(wq, ws, torch.bfloat16)[be.long()]
        lib = time_ms(lambda: torch.bmm(xdq, wg), 10)
        del wg, xdq
        nbytes = cap * k + 4 * cap + used * k * n + 4 * used * n + 2 * cap * n
        b, by = bound_ms(nbytes, ops, H100_INT8_OPS)
        log(f"time ggemm_w8a8 deepseek_moe_16b experts {what} M={cap} K={k} "
            f"N={n} ({n_moe}/step): kernel_ms={ms:.4f} plain_ms={plain:.4f} "
            f"library_ms={lib:.4f} (bmm, dequantized bf16) bound_ms={b:.4f} "
            f"({by})")
        res.shape("ggemm_w8a8", n_moe, ms, plain, lib, nbytes, ops,
                  H100_INT8_OPS)


# -------------------------------------------------------------- end to end

def _to(node, dev):
    if isinstance(node, dict):
        return {k: _to(v, dev) for k, v in node.items()}
    if isinstance(node, list):
        return [_to(v, dev) for v in node]
    return node.to(dev)


def check_tiny(res: Results, dev):
    """Tiny models on the card (kernels) and on the CPU (plain versions)
    from the same weights: the int8 dense preset, the DeepSeek-MoE
    preset (fp8 wire, W8A8 experts) and its float-expert variant (the
    f32 instantiation of the float grouped GEMM)."""
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

    #           name, config, kernels the card's run must launch
    cases = (
        ("int8", presets.tiny(kv_quant="int8", dense_weight_quant="int8",
                              dense_act_quant="int8"),
         ("ggemm_w8a8", "ragged_paged_attention")),
        ("deepseek_moe int8", presets.tiny(presets.deepseek_moe_16b()),
         ("ggemm_w8a8", "ragged_paged_attention", "chunked_a2a")),
        ("deepseek_moe float experts", presets.tiny(presets.deepseek_moe_16b(
            moe_weight_quant=None, moe_act_quant=None)),
         ("ggemm_f32", "ragged_paged_attention", "chunked_a2a")),
    )
    ecfg = EngineConfig(slots=4, token_budget=48, chunk=16, page=8,
                        npages=12)
    for name, cfg, kernels in cases:
        cpu = Transformer(cfg, device="cpu")
        params_cpu = cpu.init(torch.Generator().manual_seed(0))
        params_cpu = cpu.quantize_dense_weights(params_cpu)
        if cfg.moe == "ep":
            params_cpu = cpu.quantize_moe_weights(params_cpu)
        gpu = Transformer(cfg, device=dev)
        streams = []
        for model, params in ((gpu, _to(params_cpu, dev)),
                              (cpu, params_cpu)):
            trace = poisson_trace(7, 8, 1.0, 5, 30, 3, 6, cfg.vocab)
            reset_launch_counts()
            stats = ServingEngine(model, params, ecfg).run(trace,
                                                          max_steps=600)
            if model is gpu:
                counts = launch_counts()
                log(f"launches tiny {name} " + " ".join(
                    f"{k}={v}" for k, v in counts.items()))
                for k in kernels:
                    if counts[k] == 0:
                        res.failures.append(f"tiny {name}: {k} never "
                                            "launched")
            streams.append([r.generated for r in trace])
            if stats.completed != len(trace):
                res.failures.append(f"tiny {name}: {stats.completed}/"
                                    f"{len(trace)} requests completed")
        same = streams[0] == streams[1]
        log(f"check tiny {name} engine: token streams card == cpu: {same} "
            f"({sum(map(len, streams[0]))} tokens)")
        if not same:
            res.failures.append(f"tiny {name}: card and CPU token streams "
                                "differ")


class _CheckedEngine:
    """Mixin: every batched row's logits must be finite."""

    bad_rows = 0

    def _advance_row(self, s, req, take, logits):
        if not np.isfinite(logits[s]).all():
            self.bad_rows += 1
        return super()._advance_row(s, req, take, logits)


#: the kernels each serving path, and each MoE generation path, must
#: launch
PATH_KERNELS = {
    "deepseek_moe_16b ep": ("ag_gemm_n1", "gemm_rs_n1", "ggemm_bf16",
                            "chunked_a2a", "ggemm_w8a8", "ggemm_w8a16",
                            "flash_decode", "paged_decode"),
    "deepseek_moe_16b tp": ("ag_gemm_n1", "gemm_rs_n1", "ag_group_gemm",
                            "moe_reduce_rs", "ggemm_w8a8", "ggemm_w8a16",
                            "flash_decode", "paged_decode"),
    # the MoE path over the mesh (prefill and timed steps together)
    "deepseek_moe_16b ep tp4": ("ag_gemm", "gemm_rs", "ggemm_bf16",
                                "chunked_a2a_mesh", "ggemm_w8a8",
                                "ggemm_w8a16", "flash_decode", "all_gather"),
    "deepseek_moe_16b tp tp4": ("ag_gemm", "gemm_rs", "ag_group_gemm_mesh",
                                "moe_reduce_rs_mesh", "ggemm_w8a8",
                                "ggemm_w8a16", "flash_decode", "all_gather"),
    "llama_7b": ("ggemm_w8a8", "ggemm_w8a16", "ragged_paged_attention"),
    "deepseek_moe_16b": ("ggemm_w8a8", "ggemm_w8a16",
                         "ragged_paged_attention", "chunked_a2a"),
    "deepseek_moe_16b_bf16_experts": ("ggemm_w8a8", "ggemm_w8a16",
                                      "ragged_paged_attention", "ggemm_bf16",
                                      "chunked_a2a"),
}


def run_path(res: Results, dev, name, cfg, profile=False):
    """One serving path at full width: the engine serves the seeded
    Poisson trace (16 requests, prompts 128–1023 tokens) from random
    weights drawn in bf16 and quantized on the card; the launches of
    every kernel are counted over the run. Returns the launches and the
    number of engine steps."""
    import torch

    from triton_distributed_tpu_torch.kernels import (
        launch_counts,
        reset_launch_counts,
    )
    from triton_distributed_tpu_torch.models import Transformer
    from triton_distributed_tpu_torch.serving import (
        EngineConfig,
        ServingEngine,
        poisson_trace,
    )

    torch.cuda.empty_cache()
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
    steps = len(stats.step_times)
    log(f"path {name} layers={cfg.n_layers}: setup_s={setup:.2f} "
        f"completed={stats.completed}/{len(trace)} "
        f"generated_tokens={stats.generated_tokens} "
        f"prefill_tokens={stats.prefill_tokens} steps={steps}"
        f" evictions={stats.evictions} wall_s={wall:.2f} "
        f"tok_s={stats.generated_tokens / wall:.2f} "
        f"packed_tok_s={sum(stats.step_tokens) / wall:.2f} "
        f"p50_step_ms={stats.p50_step_ms:.2f} "
        f"p99_step_ms={stats.p99_step_ms:.2f} peak_mem_gib={peak:.2f}")
    log(f"launches {name} " + " ".join(
        f"{k}={v} ({v / max(steps, 1):g}/step)" for k, v in counts.items()))
    for k in PATH_KERNELS[name]:
        if counts[k] == 0:
            res.failures.append(f"{name}: {k} never launched")
    if stats.completed != len(trace):
        res.failures.append(
            f"{name}: {stats.completed}/{len(trace)} requests completed")
    if eng.bad_rows:
        res.failures.append(f"{name}: {eng.bad_rows} rows of non-finite "
                            "logits")
    if profile:
        run_profile(name, model, params, ecfg, trace)
    return counts, steps


def run_profile(name, model, params, ecfg, trace, steps: int = 8):
    """Device time by kernel and the device's idle share over ``steps``
    engine steps of the same trace (torch.profiler, CUDA activity).

    The same steps run twice from a fresh engine (the schedule and the
    greedy tokens repeat): first unprofiled, timing the step on the host
    clock and the host's enqueue of ``serving_step`` (its return, before
    the logits fetch waits for the card); then under the profiler, whose
    own host overhead stretches the wall. The idle share is reported
    against both walls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from triton_distributed_tpu_torch.serving import ServingEngine, Request

    def engine_past_arrivals():
        eng = ServingEngine(model, params, ecfg)
        eng.submit_trace([Request(rid=r.rid, prompt=r.prompt,
                                  max_new=r.max_new, arrival=r.arrival)
                          for r in trace])
        for _ in range(3):                   # past the first arrivals
            eng.step()
        torch.cuda.synchronize()
        return eng

    eng = engine_past_arrivals()
    enqueue = []
    serve = model.serving_step

    def timed(*a, **kw):
        t = time.perf_counter()
        out = serve(*a, **kw)
        enqueue.append(time.perf_counter() - t)
        return out

    model.serving_step = timed
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    plain_us = (time.perf_counter() - t0) * 1e6
    del model.serving_step
    eng = engine_past_arrivals()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy, rows = device_rows(prof)
    kernels = sum(n for _, _, n in rows)
    log(f"profile {name} {steps} steps: wall_ms={plain_us / 1e3:.2f} "
        f"host_enqueue_ms={sum(enqueue) * 1e3:.2f} "
        f"device_busy_ms={busy / 1e3:.2f} "
        f"device_ops_per_step={kernels / steps:.0f} "
        f"idle_share={max(0.0, 1 - busy / plain_us):.4f} | under the "
        f"profiler wall_ms={wall_us / 1e3:.2f} "
        f"idle_share={max(0.0, 1 - busy / wall_us):.4f}")
    log_rows(name, busy, rows)


def device_rows(prof):
    """(device busy µs, [(µs, kernel, launches)] by time) of a
    torch.profiler run: device-side entries only (kernels, memcpy,
    memset), whose host ops would count the same time again."""
    import torch

    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us, ev.key, ev.count))
    rows.sort(reverse=True)
    return sum(us for us, _, _ in rows), rows


def log_rows(name, busy, rows):
    for us, key, n in rows[:10]:
        log(f"  profile {name} {us / 1e3:9.3f} ms {100 * us / busy:5.1f}% "
            f"x{n} {key[:90]}")


# ------------------------------------------------------------- decode path

def decode_inputs(dev, kind: str, layout: str, seed: int = 4, tp: int = 1):
    """Llama-2-7B's decode attention: q (8, 32, 128) bf16 and a cache of
    capacity 2048 in ``kind`` ("bf16" or "int8") and ``layout`` ("bhsd",
    "bshd" or "paged" at page 128, pages in a seeded permutation), with
    seeded ragged lengths including 0, 1 and the capacity. ``tp`` > 1:
    the tp path's one local launch over its sequence-sharded caches, the
    ranks stacked as tp·8 rows of capacity 2048/tp, q repeated a rank
    and each row's length clamped to its rank's slice as the
    sequence-parallel decode clamps it. Returns (q, the cache's tensors,
    lens on the card, the entry's extra args, lens)."""
    import torch

    from triton_distributed_tpu_torch.kernels import quantize_kv

    h, d, cap = 32, 128, DEC_CAP
    rng = np.random.default_rng(seed)
    lens = np.concatenate([[0, 1, cap],
                           rng.integers(128, DEC_PROMPT + DEC_STEPS + 1,
                                        DEC_B - 3)]).astype(np.int32)
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((DEC_B, h, d), generator=g, device=dev,
                    dtype=torch.bfloat16)
    rows = DEC_B
    if tp > 1:
        cap //= tp
        lens = np.clip(lens[None, :] - cap * np.arange(tp)[:, None], 0,
                       cap).reshape(-1).astype(np.int32)
        q, rows = q.repeat(tp, 1, 1), tp * DEC_B
    if layout == "paged":
        pps = cap // DEC_PAGE
        shape = (rows * pps, h, DEC_PAGE, d)
        table = rng.permutation(rows * pps).astype(np.int32)
        extra = (torch.as_tensor(table.reshape(rows, pps), device=dev),)
    else:
        shape = (rows, h, cap, d) if layout == "bhsd" else (rows, cap, h, d)
        extra = ()
    k = torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)
    v = torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)
    # the entries' order: (kq, ks, vq, vs) or (k, v)
    cache = ((*quantize_kv(k), *quantize_kv(v)) if kind == "int8"
             else (k, v))
    return q, cache, torch.as_tensor(lens, device=dev), extra, lens


def decode_work(lens, kind: str):
    """(bytes, operations) of one decode call over ``lens`` (one a row,
    each within its cache): every valid K/V row once (int8: with its two
    f32 scales), q, out and lse once; 4·D operations per (head, valid
    position)."""
    h, d, b = 32, 128, len(lens)
    rows = int(np.sum(lens)) * h
    kv = rows * (2 * d * (1 if kind == "int8" else 2)
                 + (8 if kind == "int8" else 0))
    nbytes = kv + b * h * d * 2 * 2 + b * h * 4
    return nbytes, 4.0 * d * rows


def check_decode_kernels(res: Results, dev):
    """Both decode kernels against their plain versions, in f32 on the
    same values, at Llama-2-7B's decode shapes, each timed. The
    contiguous bhsd and paged cases of both dtypes are the decode path's
    (32 launches a step each in its configuration) and make the rows;
    so does the tp = 4 path's one launch a layer over its 4 ranks'
    stacked caches (32 rows of capacity 512), weighted 16 a step of the
    decode path's 64: its 32 steps of 32 launches; bshd (the TPU's
    static-grid kernel) and the soft cap are off the paths."""
    import torch
    import torch.nn.functional as F

    from triton_distributed_tpu_torch.kernels import flash_decode as fd

    # (kind, layout, soft cap, tp, launches a decode-path step)
    cases = (("bf16", "bhsd", 0.0, 1, 32), ("int8", "bhsd", 0.0, 1, 32),
             ("bf16", "paged", 0.0, 1, 32), ("int8", "paged", 0.0, 1, 32),
             ("bf16", "bhsd", 0.0, TP, 32 * TP_STEPS // DEC_STEPS),
             ("bf16", "bshd", 0.0, 1, 0), ("bf16", "bhsd", 30.0, 1, 0))
    for kind, layout, cap_, tp, per_step in cases:
        q, cache, lens, extra, lens_np = decode_inputs(dev, kind, layout,
                                                       tp=tp)
        cap_kv = DEC_CAP // tp
        quant = kind == "int8"
        kw = dict(soft_cap=cap_)
        if layout == "paged":
            name = "paged_decode"
            fn = (fd.paged_gqa_fwd_batch_decode_q8 if quant
                  else fd.paged_gqa_fwd_batch_decode)
            plain = (fd.paged_gqa_fwd_batch_decode_q8_plain if quant
                     else fd.paged_gqa_fwd_batch_decode_plain)
        else:
            name = "flash_decode"
            fn = fd.gqa_fwd_batch_decode_q8 if quant else fd.gqa_fwd_batch_decode
            plain = (fd.gqa_fwd_batch_decode_q8_plain if quant
                     else fd.gqa_fwd_batch_decode_plain)
            if not quant:
                kw["kv_layout"] = layout
        args = (q, *cache, lens, *extra)
        out, lse = fn(*args, **kw)
        # the plain version walks the kernel's 64-position tiles and
        # rounds p alike, in f32 on the same bf16/int8 values
        ref, rlse = plain(*args, **kw)
        torch.cuda.synchronize()
        tag = (f"llama_7b decode {kind} {layout} B={len(lens_np)} Hkv=32 "
               f"D=128 cap={cap_kv}" + (f" soft_cap={cap_:g}" if cap_ else "")
               + (f" (tp={tp}: {tp} ranks x {DEC_B} rows)" if tp > 1 else ""))
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        lerr = (lse - rlse).abs().max().item()
        excess = (diff - ATTN_RTOL * ref.float().abs()).max().item()
        res.check(name, excess, ATTN_ATOL, f"{tag} out",
                  metric=f"max(|err|-{ATTN_RTOL:g}|ref|)")
        res.check(name, lerr, ATTN_LSE_TOL, f"{tag} lse")
        empty = (out[0] == 0).all().item() and (lse[0] == fd.NEG_INF).all().item()
        if not empty:
            res.failures.append(f"{tag}: the empty row is not zero/NEG_INF")
        res.kernel(name, err=max(err, lerr))
        ms = graph_time_ms(lambda i: fn(*args, **kw))
        call = time_ms(lambda: fn(*args, **kw), 20)
        plain_ms = time_ms(lambda: plain(*args, **kw), 3)
        # yardstick: SDPA over the contiguous bf16 (or dequantized) cache
        # with a length mask and GQA; timed only
        if layout == "paged":
            kc = fd._gather_pages(cache[0], extra[0])
            vc = fd._gather_pages(cache[2 if quant else 1], extra[0])
            if quant:
                kc = fd._widen(kc, fd._gather_pages(cache[1], extra[0]),
                               torch.bfloat16)
                vc = fd._widen(vc, fd._gather_pages(cache[3], extra[0]),
                               torch.bfloat16)
        elif quant:
            kc = fd._widen(cache[0], cache[1], torch.bfloat16)
            vc = fd._widen(cache[2], cache[3], torch.bfloat16)
        elif layout == "bshd":
            kc, vc = (t.transpose(1, 2) for t in cache)
        else:
            kc, vc = cache
        mask = (torch.arange(cap_kv, device=dev)[None, None, None, :]
                < lens.long()[:, None, None, None])
        qs = q[:, :, None, :]
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qs, kc, vc, attn_mask=mask, enable_gqa=True), 20)
        del kc, vc
        nbytes, ops = decode_work(lens_np, kind)
        b, by = bound_ms(nbytes, ops, H100_BF16_OPS)
        where = ("off the path" if not per_step else "32/step"
                 if tp == 1 else f"32/step of the tp={tp} path")
        log(f"time {name} {tag} ({where})"
            f": kernel_ms={ms:.4f} (graph; back-to-back wrapper calls "
            f"{call:.4f}) plain_ms={plain_ms:.4f} library_ms={lib:.4f} (SDPA, "
            f"length mask, enable_gqa) bound_ms={b:.4f} ({by}) "
            f"max_abs_err={err:.6g}")
        if per_step:
            res.shape(name, per_step, ms, plain_ms, lib, nbytes, ops,
                      H100_BF16_OPS)


def check_n1_gemms(res: Results, dev):
    """The world-size-1 AG-GEMM / GEMM-RS at the prefill's shapes (8
    prompts of 1024 rows): wqkv and up through ``ag_gemm``, wo and down
    through ``gemm_rs``, 32 launches a prefill each."""
    import torch

    from triton_distributed_tpu_torch.kernels import ag_gemm as agm
    from triton_distributed_tpu_torch.kernels import gemm_rs as grs

    m, h, f, qkv = DEC_B * DEC_PROMPT, 4096, 11008, 3 * 4096
    g = torch.Generator(device=dev).manual_seed(6)
    shapes = (("ag_gemm_n1", "wqkv", h, qkv, agm.ag_gemm, agm.ag_gemm_plain),
              ("ag_gemm_n1", "up", h, f, agm.ag_gemm, agm.ag_gemm_plain),
              ("gemm_rs_n1", "wo", h, h, grs.gemm_rs, grs.gemm_rs_plain),
              ("gemm_rs_n1", "down", f, h, grs.gemm_rs, grs.gemm_rs_plain))
    for name, what, k, n, fn, plain in shapes:
        a = torch.randn((m, k), generator=g, device=dev, dtype=torch.bfloat16)
        b = torch.randn((k, n), generator=g, device=dev,
                        dtype=torch.bfloat16) / math.sqrt(k)
        out = fn(a, b)
        ref = plain(a, b, out_dtype=torch.float32)
        torch.cuda.synchronize()
        diff = (out.float() - ref).abs()
        scale = ref.abs().max().item()
        excess = (diff - GG_RTOL * ref.abs()).max().item()
        tag = f"llama_7b prefill {what} M={m} K={k} N={n}"
        res.check(name, excess, GG_ATOL * scale, tag,
                  metric="max(|err|-2^-8|ref|)")
        err = diff.max().item()
        res.kernel(name, err=err)
        ms = time_ms(lambda: fn(a, b), 5)
        plain_ms = time_ms(lambda: plain(a, b), 2)
        lib = time_ms(lambda: torch.matmul(a, b), 5)
        nbytes = 2 * (m * k + k * n + m * n)
        ops = 2.0 * m * k * n
        bnd, by = bound_ms(nbytes, ops, H100_BF16_OPS)
        log(f"time {name} {tag} (32/prefill): kernel_ms={ms:.4f} plain_ms="
            f"{plain_ms:.4f} library_ms={lib:.4f} (torch.matmul) bound_ms="
            f"{bnd:.4f} ({by}) max_abs_err={err:.6g}")
        res.shape(name, 32, ms, plain_ms, lib, nbytes, ops, H100_BF16_OPS)
        del a, b, out, ref, diff


def moe_tp_inputs(dev, m, dtype, seed, empty=None):
    """The TP prefill's routing over ``m`` tokens (seeded softmax logits
    over 64 experts, top-6; expert ``empty`` starved when given), its
    sorted ids and block table at block_m 128, and x (m, 2048) in
    ``dtype``."""
    import torch

    from triton_distributed_tpu_torch.kernels import moe_utils as mu

    g = torch.Generator(device=dev).manual_seed(seed)
    logits = torch.randn((m, MOE_E), generator=g, device=dev)
    if empty is not None:
        logits[:, empty] = -1e4
    _, ids = mu.select_experts(logits, MOE_K)
    sti, be, splits = mu.moe_align_block_size(ids, MOE_E, MOE_TP_BM)
    x = torch.randn((m, MOE_H), generator=g, device=dev, dtype=dtype)
    return x, sti, be, splits, g


def check_moe_tp_kernels(res: Results, dev):
    """The two MoE-TP kernels against their plain versions: at the TP
    prefill's shapes in bf16 (8 prompts of 1024 tokens, top-6 over 64
    experts: 57344 sorted rows; up K 2048 N 1408, down K 1408 N 2048),
    timed, and in f32 and bf16 at 1024 tokens with an empty expert."""
    import torch
    import torch.nn.functional as F

    from triton_distributed_tpu_torch.kernels import moe_tp_fused as mtf

    cases = (("bf16 prefill", DEC_B * DEC_PROMPT, torch.bfloat16, None),
             ("f32 expert 5 empty", 1024, torch.float32, 5),
             ("bf16 expert 5 empty", 1024, torch.bfloat16, 5))
    for what, m, dt, empty in cases:
        x, sti, be, splits, g = moe_tp_inputs(dev, m, dt, 9, empty)
        if empty is not None and int(splits[empty]) != 0:
            res.failures.append(f"moe_tp {what}: expert {empty} not empty")
        cap, nb = sti.shape[0], be.shape[0]
        used = int(torch.unique(be).numel())
        w_up = torch.randn((MOE_E, MOE_H, MOE_F), generator=g, device=dev,
                           dtype=dt) / math.sqrt(MOE_H)
        w_down = torch.randn((MOE_E, MOE_F, MOE_H), generator=g, device=dev,
                             dtype=dt) / math.sqrt(MOE_F)
        h = F.silu(mtf.ag_group_gemm(x, sti, be, w_up, MOE_K).float()).to(dt)
        valid = m * MOE_K
        rows = torch.clamp(sti.long() // MOE_K, 0, m - 1)
        ops = {
            "ag_group_gemm": (
                lambda: mtf.ag_group_gemm(x, sti, be, w_up, MOE_K),
                lambda **kw: mtf.ag_group_gemm_plain(x, sti, be, w_up, MOE_K,
                                                     **kw),
                w_up, "up"),
            "moe_reduce_rs": (
                lambda: mtf.moe_reduce_rs(h, be, w_down),
                lambda **kw: mtf.moe_reduce_rs_plain(h, be, w_down, **kw),
                w_down, "down"),
        }
        for name, (fn, plain, w, leg) in ops.items():
            k, n = w.shape[1], w.shape[2]
            out = fn()
            ref = plain(out_dtype=torch.float32)
            torch.cuda.synchronize()
            diff = (out.float() - ref).abs()
            scale = ref.abs().max().item()
            rt = GG_RTOL if dt == torch.bfloat16 else 0.0
            excess = (diff - rt * ref.abs()).max().item()
            tag = f"{what} {leg} M={m} cap={cap} K={k} N={n}"
            res.check(name, excess, GG_ATOL * scale, tag,
                      metric=f"max(|err|-{rt:g}|ref|)")
            err = diff.max().item()
            res.kernel(name, err=err)
            if name == "ag_group_gemm":
                pad = sti >= valid
                if not bool((out[pad] == 0).all()):
                    res.failures.append(f"{name} {tag}: padding rows not 0")
            if empty is not None:
                continue
            ms = time_ms(fn, 5)
            plain_ms = time_ms(plain, 2)
            # yardstick: bmm over the 128-row blocks, the weights
            # gathered per block beforehand; the up leg times the row
            # gather of x with it
            wg = w[be.long()]
            if name == "ag_group_gemm":
                lib = time_ms(lambda: torch.bmm(
                    x[rows].reshape(nb, MOE_TP_BM, k), wg), 5)
                a_bytes = 2 * m * k + 4 * cap
            else:
                hb = h.reshape(nb, MOE_TP_BM, k)
                lib = time_ms(lambda: torch.bmm(hb, wg), 5)
                a_bytes = 2 * cap * k
            del wg
            # bytes: A once, the used experts' weights once, the output
            # once; operations: the valid rows' products (the padding
            # rows are zeros)
            nbytes = a_bytes + 2 * used * k * n + 4 * nb + 2 * cap * n
            flops = 2.0 * valid * k * n
            b, by = bound_ms(nbytes, flops, H100_BF16_OPS)
            log(f"time {name} {tag} ({used} experts, 27/prefill): "
                f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms="
                f"{lib:.4f} (bmm, weights gathered per block"
                f"{', after the row gather' if leg == 'up' else ''}) "
                f"bound_ms={b:.4f} ({by}) max_abs_err={err:.6g}")
            res.shape(name, 27, ms, plain_ms, lib, nbytes, flops,
                      H100_BF16_OPS)
        del x, h, w_up, w_down


def check_mesh_kernels(res: Results, dev):
    """The tensor-parallel kernels over a loopback mesh of 4 ranks at the
    Llama-2-7B tp = 4 path's shapes, against their plain versions: the
    AG-GEMM (A 4 x (2048, 4096) bf16 row shards, B_r (4096, 3072) for
    wqkv and (4096, 2752) for up) and GEMM-RS (A_q (8192, 1024) for wo
    and (8192, 2752) for down, B_q (K_q, 4096)), 32 launches a prefill
    each shape, timed; and the all-gather of the decode's partials
    ((8, 32, 128) bf16 out and (8, 32) f32 lse a rank, 32 launches a
    step each), byte-exact, timed from a CUDA graph."""
    import torch

    from triton_distributed_tpu_torch.kernels import ag_gemm as agm
    from triton_distributed_tpu_torch.kernels import allgather as agk
    from triton_distributed_tpu_torch.kernels import gemm_rs as grs
    from triton_distributed_tpu_torch.runtime import Mesh

    mesh = Mesh.loopback(TP, dev)
    m, h, f = DEC_B * DEC_PROMPT, 4096, 11008
    g = torch.Generator(device=dev).manual_seed(12)

    def shards(shape, scale=1.0):
        t = torch.randn((TP, *shape), generator=g, device=dev,
                        dtype=torch.bfloat16) * scale
        return list(t.unbind(0))

    cases = (("ag_gemm", "wqkv", h, 3 * h // TP),
             ("ag_gemm", "up", h, f // TP),
             ("gemm_rs", "wo", h // TP, h),
             ("gemm_rs", "down", f // TP, h))
    for name, what, k, n in cases:
        if name == "ag_gemm":
            a, b = shards((m // TP, k)), shards((k, n), k ** -0.5)
            fn, plain = agm.ag_gemm, agm.ag_gemm_plain
            # the same products for every rank at once
            a_cat, b_cat = torch.cat(a), torch.cat(b, dim=1)
            out_elems, kk = TP * m * n, k
        else:
            a, b = shards((m, k)), shards((k, n), (TP * k) ** -0.5)
            fn, plain = grs.gemm_rs, grs.gemm_rs_plain
            a_cat, b_cat = torch.cat(a, dim=1), torch.cat(b)
            out_elems, kk = m * n, TP * k
        out = fn(a, b, mesh)
        ref = plain(a, b, mesh, out_dtype=torch.float32)
        torch.cuda.synchronize()
        err = excess = 0.0
        scale = max(r.abs().max().item() for r in ref)
        for o, r in zip(out, ref):
            diff = (o.float() - r).abs()
            err = max(err, diff.max().item())
            excess = max(excess, (diff - GG_RTOL * r.abs()).max().item())
        del ref, diff
        tag = (f"llama_7b tp={TP} prefill {what} A {TP} x "
               f"{tuple(a[0].shape)} B {TP} x {tuple(b[0].shape)}")
        res.check(name, excess, GG_ATOL * scale, tag,
                  metric="max(|err|-2^-8|ref|)")
        res.kernel(name, err=err)
        ms = time_ms(lambda: fn(a, b, mesh), 5)
        plain_ms = time_ms(lambda: plain(a, b, mesh), 2)
        lib = time_ms(lambda: torch.matmul(a_cat, b_cat), 5)
        # bytes: every rank's A and B read once, every output written
        # once; operations: all ranks' products
        nbytes = 2 * (a_cat.numel() + b_cat.numel() + out_elems)
        ops = 2.0 * m * kk * (TP * n if name == "ag_gemm" else n)
        bnd, by = bound_ms(nbytes, ops, H100_BF16_OPS)
        log(f"time {name} {tag} (32/prefill, one launch for {TP} ranks): "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms="
            f"{lib:.4f} (torch.matmul on the concatenated operands) "
            f"bound_ms={bnd:.4f} ({by}) max_abs_err={err:.6g}")
        res.shape(name, 32, ms, plain_ms, lib, nbytes, ops, H100_BF16_OPS)
        del a, b, a_cat, b_cat, out

    for what, shape, dt in (("out", (DEC_B, 32, 128), torch.bfloat16),
                            ("lse", (DEC_B, 32), torch.float32)):
        # 24 inputs apart, so that the graph's calls stream from memory
        ins = [list(torch.randn((TP, *shape), generator=g, device=dev)
                    .to(dt).unbind(0)) for _ in range(24)]
        x = ins[0]
        got = agk.all_gather(x, mesh)
        want = torch.cat(x)
        torch.cuda.synchronize()
        exact = all(torch.equal(o, want) for o in got)
        res.check("all_gather", 0.0 if exact else 1.0, 0.0,
                  f"llama_7b tp={TP} decode partial {what} {TP} x "
                  f"{tuple(shape)} {str(dt)[6:]}", metric="bytes differ")
        res.kernel("all_gather", err=0.0)
        ms = graph_time_ms(lambda i: agk.all_gather(ins[i], mesh))
        plain_ms = time_ms(lambda: agk.all_gather_plain(x, mesh), 20)
        # one call writing every rank's gathered copy end to end
        lib = time_ms(lambda: torch.cat(x * TP), 20)
        nb = x[0].numel() * x[0].element_size()
        nbytes = TP * nb + TP * TP * nb
        bnd, by = bound_ms(nbytes, 0.0, H100_BF16_OPS)
        log(f"time all_gather decode partial {what} ({TP} ranks, 32/step): "
            f"kernel_ms={ms:.4f} (graph) plain_ms={plain_ms:.4f} "
            f"library_ms={lib:.4f} (one torch.cat of every rank's copy) "
            f"bound_ms={bnd:.6f} ({by}; the launch bounds it)")
        res.shape("all_gather", 32, ms, plain_ms, lib, nbytes, 0.0,
                  H100_BF16_OPS)
        del ins, x, got


def a2a_mesh_inputs(dev, m_rank: int, seed: int):
    """Every rank's staged exchange at the EP path's geometry on a
    loopback mesh of ``TP`` ranks: ``m_rank`` bf16 token rows a rank
    routed by seeded softmax logits over 64 experts (top-6), staged for
    the fp8 wire exactly as ``ops.ep_moe`` stages them, and the combine
    leg returning what arrived. Returns the exchange's context and, per
    leg, (the transport's arguments, ``know_recv``, the (W, W) chunks
    receiver r gets in slot p)."""
    import torch

    from triton_distributed_tpu_torch import ops
    from triton_distributed_tpu_torch.kernels import moe_dispatch as md
    from triton_distributed_tpu_torch.kernels.moe_utils import select_experts
    from triton_distributed_tpu_torch.runtime import Mesh

    ctx = ops.create_ep_moe_context(
        num_experts=MOE_E, topk=MOE_K, max_m=m_rank * MOE_K, hidden=MOE_H,
        dtype=torch.bfloat16, block_m=64, quant="fp8", act_quant="int8",
        mesh=Mesh.loopback(TP, dev))
    a2a = ctx.a2a
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((TP, m_rank, MOE_H), generator=g, device=dev,
                    dtype=torch.bfloat16)
    logits = torch.randn((TP * m_rank, MOE_E), generator=g, device=dev)
    _, ids = select_experts(logits, MOE_K)
    flat_e = ids.reshape(TP, -1)
    order = torch.argsort(flat_e, dim=1, stable=True)
    splits = torch.zeros((TP, MOE_E), dtype=torch.int32, device=dev)
    splits.scatter_add_(1, flat_e.long(), torch.ones_like(flat_e))
    _, offs, offs_al, sendk = md.send_plan(a2a, splits)
    _, dest = md.assignment_dest(a2a, flat_e.gather(1, order), offs, offs_al)
    payload, scales = md.stage_aligned(a2a, x, order // MOE_K, dest,
                                       flat_e.shape[1])
    meta = md.meta_payload(a2a, splits, scales, offs_al, sendk)
    tok, tmeta = md.dispatch_device(a2a, payload, offs_al, sendk, meta)
    toks, rspl = md.recv_view(a2a, tok, tmeta)
    y_tok, y_meta = md.stage_return(a2a, toks)
    retk = (-(-rspl.sum(-1) // md.chunk_rows(a2a))).to(torch.int32)
    dispatch = (payload, meta.reshape(TP, -1, 128),
                (offs_al // md.align(a2a)).to(torch.int32), sendk,
                torch.zeros_like(sendk))
    combine = (y_tok, y_meta.reshape(TP, -1, 128),
               md._slot_offs(a2a, (TP,), dev), retk, sendk)
    return a2a, {"dispatch": (dispatch, False, sendk.t()),
                 "combine": (combine, True, sendk)}


def check_a2a_mesh(res: Results, dev, n_moe: int):
    """The all-to-all at n = 4 against its plain version, byte for byte:
    both legs, LL mode (both parities) and barrier mode, over windows
    pre-filled with a sentinel byte (the rows past the shipped chunks
    keep it), at the EP tp = 4 decode's shape (8 tokens, 2 a rank) and at
    the reference's benchmark size (128 tokens a rank; top-6 and hidden
    2048 here); each timed from a CUDA graph. The decode's shape makes
    the row, 27 launches a leg and step."""
    import torch

    from triton_distributed_tpu_torch.kernels import moe_dispatch as md

    par0 = torch.zeros((1,), dtype=torch.int32, device=dev)
    for what, m_rank, seed, on_path in (
            ("EP tp=4 decode", DEC_B // TP, 21, True),
            ("128 tokens a rank", 128, 22, False)):
        a2a, legs = a2a_mesh_inputs(dev, m_rank, seed)
        sp, mr, ck = md.slot_pad(a2a), md.meta_rows(a2a), md.chunk_rows(a2a)

        def windows(nw):
            tok = torch.full((TP, nw * TP * sp, MOE_H), 0xA5,
                             dtype=torch.uint8, device=dev).view(
                                 a2a.wire_dtype)
            meta = torch.full((TP, nw * TP * mr, 128), -0x5A5A5A5B,
                              dtype=torch.int32, device=dev)
            return tok, meta

        for leg, (args, know, counts) in legs.items():
            rows = torch.arange(TP * sp, device=dev)
            slot_rows = counts.long().repeat_interleave(sp, dim=1) * ck
            shipped = (rows % sp)[None, :] < slot_rows         # (W, W·sp)
            for mode, nw, pars in (("LL", 2, (0, 1)), ("barrier", 1, (0,))):
                got, want = windows(nw), windows(nw)
                for par in pars:
                    p = torch.tensor([par], dtype=torch.int32, device=dev)
                    md.chunked_a2a(a2a, *args, *got, p, know_recv=know)
                    md.chunked_a2a_plain(a2a, *args, *want, p,
                                         know_recv=know)
                torch.cuda.synchronize()
                bad = int((got[0].view(torch.uint8) != want[0].view(
                    torch.uint8)).sum()) + int((got[1] != want[1]).sum())
                kept = got[0].view(torch.uint8).reshape(TP, nw, TP * sp, -1)
                bad += int((kept[~shipped[:, None].expand(-1, nw, -1)]
                            != 0xA5).sum())
                res.check("chunked_a2a_mesh", bad, 0, f"{what} {leg} {mode} "
                          f"({int(shipped.sum())} of {TP * TP * sp} rows "
                          "shipped)", metric="bytes_differing")
            res.kernel("chunked_a2a_mesh", err=0.0)
            # timed from a CUDA graph (the wrapper's host work is longer
            # than the kernel), each call on one of 6 payload/window sets
            pays = [args[0].clone() for _ in range(6)]
            wss = [windows(2) for _ in range(6)]

            def kernel(i, args=args, know=know, pays=pays, wss=wss):
                md.chunked_a2a(a2a, pays[i % 6], *args[1:], *wss[i % 6],
                               par0, know_recv=know)

            ms = graph_time_ms(kernel)
            ws = wss[0]
            plain = time_ms(lambda: md.chunked_a2a_plain(
                a2a, *args, *ws, par0, know_recv=know), 5)
            row_b = MOE_H * a2a.wire_itemsize
            moved = int(counts.sum()) * ck * row_b + TP * TP * mr * 512
            srcs = [torch.empty(moved, dtype=torch.uint8, device=dev)
                    for _ in range(6)]
            dsts = [torch.empty_like(t) for t in srcs]
            lib = graph_time_ms(lambda i: dsts[i % 6].copy_(srcs[i % 6]))
            nbytes = 2 * moved
            b, by = bound_ms(nbytes, 0.0, H100_BF16_OPS)
            note = (f" (the reference: {REF_DISPATCH_US:.0f} us for 128 "
                    "tokens a rank, top-8, hidden 7168, fp8 on 32 H800s; a "
                    "loopback mesh on one card crosses no link, so the two "
                    "are not comparable)" if not on_path else
                    f" ({n_moe}/step)")
            log(f"time chunked_a2a_mesh {what} {leg} fp8, {TP} ranks, "
                f"{moved} bytes moved: kernel_ms={ms:.4f} (graph) "
                f"plain_ms={plain:.4f} library_ms={lib:.4f} (one copy_, "
                f"graph) bound_ms={b:.5f} ({by}){note}")
            if on_path:
                res.shape("chunked_a2a_mesh", n_moe, ms, plain, lib, nbytes,
                          0.0, H100_BF16_OPS)
            del pays, wss


def check_moe_tp_mesh_kernels(res: Results, dev, n_moe: int):
    """The mesh forms of the two MoE-TP kernels against their plain
    versions: at the DeepSeek-MoE-16B tp = 4 prefill's shapes in bf16 (8
    prompts of 1024 tokens, 2048 a rank, top-6 over 64 experts, each
    shard aligned on its own at block_m 128: 20480 sorted rows a shard;
    up K 2048 N 352 a rank, down K 352 a rank N 2048), timed, and in f32
    at 256 tokens a rank with an empty expert."""
    import torch
    import torch.nn.functional as F

    from triton_distributed_tpu_torch.kernels import moe_tp_fused as mtf
    from triton_distributed_tpu_torch.kernels import moe_utils as mu
    from triton_distributed_tpu_torch.lang.shmem import stacked
    from triton_distributed_tpu_torch.runtime import Mesh

    mesh = Mesh.loopback(TP, dev)
    fl = MOE_F // TP
    for what, m_s, dt, empty in (
            ("bf16 prefill", DEC_B * DEC_PROMPT // TP, torch.bfloat16, None),
            ("f32 expert 5 empty", 256, torch.float32, 5)):
        g = torch.Generator(device=dev).manual_seed(13)
        logits = torch.randn((TP * m_s, MOE_E), generator=g, device=dev)
        if empty is not None:
            logits[:, empty] = -1e4
        _, ids = mu.select_experts(logits, MOE_K)
        sti, be, splits = mu.moe_align_block_size(
            ids.reshape(TP, m_s, MOE_K), MOE_E, MOE_TP_BM)
        if empty is not None and int(splits[:, empty].sum()) != 0:
            res.failures.append(f"moe_tp mesh {what}: expert {empty} not "
                                "empty")
        cap_s, nb = sti.shape[1], be.shape[1]
        used = int(torch.unique(be).numel())
        x = list(torch.randn((TP, m_s, MOE_H), generator=g, device=dev,
                             dtype=dt).unbind(0))
        w_up = list((torch.randn((TP, MOE_E, MOE_H, fl), generator=g,
                                 device=dev, dtype=dt)
                     / math.sqrt(MOE_H)).unbind(0))
        w_down = list((torch.randn((TP, MOE_E, fl, MOE_H), generator=g,
                                   device=dev, dtype=dt)
                       / math.sqrt(MOE_F)).unbind(0))
        hs = F.silu(stacked(mtf.ag_group_gemm_mesh(
            x, sti, be, w_up, MOE_K, mesh)).float()).to(dt)
        h = list(hs.unbind(0))
        valid = TP * m_s * MOE_K
        cases = {
            "ag_group_gemm_mesh": (
                lambda: mtf.ag_group_gemm_mesh(x, sti, be, w_up, MOE_K,
                                               mesh),
                lambda **kw: mtf.ag_group_gemm_mesh_plain(
                    x, sti, be, w_up, MOE_K, mesh, **kw),
                MOE_H, fl, "up"),
            "moe_reduce_rs_mesh": (
                lambda: mtf.moe_reduce_rs_mesh(h, be, w_down, mesh),
                lambda **kw: mtf.moe_reduce_rs_mesh_plain(
                    h, be, w_down, mesh, **kw),
                fl, MOE_H, "down"),
        }
        for name, (fn, plain, k, n, leg) in cases.items():
            out = fn()
            ref = plain(out_dtype=torch.float32)
            torch.cuda.synchronize()
            scale = max(r.abs().max().item() for r in ref)
            rt = GG_RTOL if dt == torch.bfloat16 else 0.0
            err = excess = 0.0
            for o, r in zip(out, ref):
                diff = (o.float() - r).abs()
                err = max(err, diff.max().item())
                excess = max(excess, (diff - rt * r.abs()).max().item())
            del ref
            tag = (f"{what} {leg} {TP} ranks x {m_s} tokens cap_s={cap_s} "
                   f"K={k} N={n} a rank")
            res.check(name, excess, GG_ATOL * scale, tag,
                      metric=f"max(|err|-{rt:g}|ref|)")
            res.kernel(name, err=err)
            if leg == "up":
                pad = sti.reshape(-1) >= m_s * MOE_K
                if not all(bool((o[pad] == 0).all()) for o in out):
                    res.failures.append(f"{name} {tag}: padding rows not 0")
            del out
            if empty is not None:
                continue
            ms = time_ms(fn, 5)
            plain_ms = time_ms(plain, 1)
            # yardstick: bmm over every shard's 128-row blocks on the
            # concatenated operands (the weights of all ranks side by
            # side, gathered per block)
            be_all = be.reshape(-1).long()
            if leg == "up":
                rows = torch.clamp(sti.long() // MOE_K, 0, m_s - 1)
                xg = torch.cat([xs[r] for xs, r in zip(x, rows)]).reshape(
                    TP * nb, MOE_TP_BM, MOE_H)
                wg = torch.cat(w_up, dim=2)[be_all]
                lib = time_ms(lambda: torch.bmm(xg, wg), 3)
                a_bytes = 2 * TP * m_s * MOE_H + 4 * TP * cap_s
                out_b = 2 * TP * cap_s * MOE_F
                del xg
            else:
                yg = torch.cat(h, dim=1).reshape(TP * nb, MOE_TP_BM, MOE_F)
                wg = torch.cat(w_down, dim=1)[be_all]
                lib = time_ms(lambda: torch.bmm(yg, wg), 3)
                a_bytes = 2 * TP * cap_s * MOE_F
                out_b = 2 * TP * cap_s * MOE_H
                del yg
            del wg
            # bytes: A once, the used experts' weights of every rank once,
            # every output once; operations: the valid rows' products
            nbytes = a_bytes + 2 * used * MOE_H * MOE_F + 4 * TP * nb + out_b
            flops = 2.0 * valid * MOE_H * MOE_F
            b, by = bound_ms(nbytes, flops, H100_BF16_OPS)
            log(f"time {name} {tag} ({used} experts, {n_moe}/prefill, one "
                f"launch for {TP} ranks): kernel_ms={ms:.4f} plain_ms="
                f"{plain_ms:.4f} library_ms={lib:.4f} (bmm on the "
                f"concatenated operands, weights gathered per block) "
                f"bound_ms={b:.4f} ({by}) max_abs_err={err:.6g}")
            res.shape(name, n_moe, ms, plain_ms, lib, nbytes, flops,
                      H100_BF16_OPS)
        del x, h, hs, w_up, w_down


def check_tiny_moe_tp4(res: Results, dev):
    """The tiny DeepSeek-MoE preset as served (EP: fp8 wire, W8A8) and in
    its TP flavour at tp = 4 on a loopback mesh, on the card and on the
    CPU (plain versions) from the same weights, B = 3 (the EP decode
    pads it to 4): prefill and 16 greedy steps (EP over its persistent
    workspaces) must give equal token streams, and the card's run must
    launch the mesh kernels of its path and none of their one-rank
    forms."""
    import torch

    from triton_distributed_tpu_torch.kernels import (
        launch_counts,
        reset_launch_counts,
    )
    from triton_distributed_tpu_torch.models import Transformer, presets
    from triton_distributed_tpu_torch.runtime import Mesh

    #        name, preset overrides, kernels of prefill, kernels of decode
    cases = (("ep", {}, ("chunked_a2a_mesh", "ggemm_f32", "ag_gemm"),
              ("chunked_a2a_mesh", "ggemm_w8a8", "all_gather")),
             ("tp", dict(moe="tp", moe_weight_quant=None, moe_act_quant=None),
              MOE_MESH_ROWS, ("flash_decode", "all_gather")))
    for name, kw, pre_k, dec_k in cases:
        cfg = presets.tiny(presets.deepseek_moe_16b(**kw))
        one = Transformer(cfg, device="cpu")
        params = one.quantize_moe_weights(one.quantize_dense_weights(
            one.init(torch.Generator().manual_seed(0))))
        rng = np.random.default_rng(1)
        toks = rng.integers(0, cfg.vocab, (3, 24)).astype(np.int32)
        lens = np.array([24, 17, 5], np.int32)
        streams = {}
        for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
            model = Transformer(cfg, mesh=Mesh.loopback(TP, d))
            p = model.shard_params(_to(params, d))
            reset_launch_counts()
            last, caches, kl = model.prefill(
                p, model.init_cache(3, 48), torch.as_tensor(toks, device=d),
                torch.as_tensor(lens, device=d))
            pre = launch_counts()
            reset_launch_counts()
            out = model.generate(p, caches, kl,
                                 torch.argmax(last, -1).to(torch.int32), 16,
                                 moe_state=model.init_decode_state(3))
            streams[where] = out[0].cpu().tolist()
            if where == "card":
                dec = launch_counts()
                log(f"launches tiny moe {name} tp{TP} prefill " + " ".join(
                    f"{k}={v}" for k, v in pre.items() if v) + " decode "
                    + " ".join(f"{k}={v}" for k, v in dec.items() if v))
                for counts, kernels, phase in ((pre, pre_k, "prefill"),
                                               (dec, dec_k, "decode")):
                    for k in kernels:
                        if counts[k] == 0:
                            res.failures.append(f"tiny moe {name} tp{TP}: {k}"
                                                f" never launched in {phase}")
                    for k in ("chunked_a2a", "ag_group_gemm", "moe_reduce_rs",
                              "ag_gemm_n1", "gemm_rs_n1"):
                        if counts[k]:
                            res.failures.append(f"tiny moe {name} tp{TP}: "
                                                f"{k} launched in {phase}")
        same = streams["card"] == streams["cpu"]
        log(f"check tiny moe {name} tp{TP}: token streams card == cpu: "
            f"{same} ({3 * 16} tokens)")
        if not same:
            res.failures.append(f"tiny moe {name} tp{TP}: token streams "
                                "differ")


def check_tiny_tp(res: Results, dev):
    """The tiny int8 model (int8 KV, W8A8) at tp = 4 on a loopback mesh,
    on the card and on the CPU (plain versions) from the same weights:
    prefill and 16 greedy steps must give equal token streams, and the
    card's run must launch the three mesh kernels and no world-size-1
    GEMM."""
    import torch

    from triton_distributed_tpu_torch.kernels import (
        launch_counts,
        reset_launch_counts,
    )
    from triton_distributed_tpu_torch.models import Transformer, presets
    from triton_distributed_tpu_torch.runtime import Mesh

    cfg = presets.tiny(kv_quant="int8", dense_weight_quant="int8",
                       dense_act_quant="int8")
    one = Transformer(cfg, device="cpu")
    params = one.quantize_dense_weights(
        one.init(torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (4, 24)).astype(np.int32)
    lens = np.array([24, 17, 5, 1], np.int32)
    streams = {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        model = Transformer(cfg, mesh=Mesh.loopback(TP, d))
        p = model.shard_params(_to(params, d))
        reset_launch_counts()
        last, caches, kl = model.prefill(
            p, model.init_cache(4, 48), torch.as_tensor(toks, device=d),
            torch.as_tensor(lens, device=d))
        out, _, _ = model.generate(p, caches, kl,
                                   torch.argmax(last, -1).to(torch.int32), 16)
        streams[where] = out.cpu().tolist()
        if where == "card":
            counts = launch_counts()
            log(f"launches tiny tp{TP} int8 " + " ".join(
                f"{k}={v}" for k, v in counts.items() if v))
            for k in ("ag_gemm", "gemm_rs", "all_gather", "flash_decode",
                      "ggemm_w8a8"):
                if counts[k] == 0:
                    res.failures.append(f"tiny tp{TP}: {k} never launched")
            for k in ("ag_gemm_n1", "gemm_rs_n1"):
                if counts[k]:
                    res.failures.append(f"tiny tp{TP}: {k} launched")
    same = streams["card"] == streams["cpu"]
    log(f"check tiny tp{TP} int8: token streams card == cpu: {same} "
        f"({4 * 16} tokens)")
    if not same:
        res.failures.append(f"tiny tp{TP} int8: token streams differ")


def by_tpu_kernel() -> dict:
    """The decode kernels' launches since the last reset, by the TPU
    kernel each call stood for (the JAX entries' gates)."""
    from triton_distributed_tpu_torch.kernels import flash_decode as fd

    return {**fd._flash_decode_cuda.by_tpu_kernel,
            **fd._paged_decode_cuda.by_tpu_kernel}


def check_tiny_decode(res: Results, dev):
    """The tiny f32 and int8 models through prefill + generate on the
    card (kernels) and on the CPU (plain versions) from the same
    weights, contiguous and paged: the four token streams of a model
    must be equal, and the card's runs must launch the path's kernels."""
    import torch

    from triton_distributed_tpu_torch.kernels import (
        launch_counts,
        reset_launch_counts,
    )
    from triton_distributed_tpu_torch.models import Transformer, presets

    for name, cfg in (("f32", presets.tiny()),
                      ("int8", presets.tiny(kv_quant="int8",
                                            dense_weight_quant="int8",
                                            dense_act_quant="int8"))):
        cpu = Transformer(cfg, device="cpu")
        params = cpu.quantize_dense_weights(
            cpu.init(torch.Generator().manual_seed(0)))
        rng = np.random.default_rng(1)
        toks = rng.integers(0, cfg.vocab, (4, 24)).astype(np.int32)
        lens = np.array([24, 17, 5, 1], np.int32)
        streams = {}
        for where, model in (("card", Transformer(cfg, device=dev)),
                             ("cpu", cpu)):
            d = model.device
            p = _to(params, d)
            reset_launch_counts()
            last, caches, kl = model.prefill(
                p, model.init_cache(4, 48), torch.as_tensor(toks, device=d),
                torch.as_tensor(lens, device=d))
            first = torch.argmax(last, -1).to(torch.int32)
            pools, table = model.paginate_caches(caches, page=8)
            for layout, cc, tb in (("contiguous", caches, None),
                                   ("paged", pools, table)):
                out, _, _ = model.generate(p, cc, kl, first, 16,
                                           block_table=tb)
                streams[(where, layout)] = out.cpu().tolist()
            if where == "card":
                counts = launch_counts()
                log(f"launches tiny decode {name} " + " ".join(
                    f"{k}={v}" for k, v in counts.items() if v)
                    + f" by TPU kernel {by_tpu_kernel()}")
                for k in DECODE_ROWS:
                    if counts[k] == 0:
                        res.failures.append(f"tiny decode {name}: {k} never "
                                            "launched")
        want = streams[("cpu", "contiguous")]
        same = all(v == want for v in streams.values())
        log(f"check tiny decode {name}: token streams card == cpu, "
            f"contiguous == paged: {same} ({4 * 16} tokens each)")
        if not same:
            res.failures.append(f"tiny decode {name}: token streams differ")


def check_tiny_moe_decode(res: Results, dev):
    """The tiny DeepSeek-MoE preset as served (EP: fp8 wire, W8A8 int8
    experts, int8 KV and dense weights) and its TP flavour through
    prefill + generate on the card and on the CPU from the same weights,
    contiguous and paged, the EP decode over the persistent workspaces:
    the four token streams of a model must be equal. The card's EP run
    must launch the all-to-all and the f32 grouped GEMM in prefill (full
    precision on the widened experts) and the all-to-all and W8A8 in
    decode; its TP run both MoE-TP kernels in prefill."""
    import torch

    from triton_distributed_tpu_torch.kernels import (
        launch_counts,
        reset_launch_counts,
    )
    from triton_distributed_tpu_torch.models import Transformer, presets

    #        name, preset overrides, kernels of prefill, kernels of decode
    cases = (("ep", {}, ("chunked_a2a", "ggemm_f32"),
              ("chunked_a2a", "ggemm_w8a8")),
             ("tp", dict(moe="tp", moe_weight_quant=None, moe_act_quant=None),
              MOE_TP_ROWS, ("flash_decode",)))
    for name, kw, pre_k, dec_k in cases:
        cfg = presets.tiny(presets.deepseek_moe_16b(**kw))
        cpu = Transformer(cfg, device="cpu")
        params = cpu.quantize_moe_weights(cpu.quantize_dense_weights(
            cpu.init(torch.Generator().manual_seed(0))))
        rng = np.random.default_rng(1)
        toks = rng.integers(0, cfg.vocab, (4, 24)).astype(np.int32)
        lens = np.array([24, 17, 5, 1], np.int32)
        streams = {}
        for where, model in (("card", Transformer(cfg, device=dev)),
                             ("cpu", cpu)):
            d = model.device
            p = _to(params, d)
            reset_launch_counts()
            last, caches, kl = model.prefill(
                p, model.init_cache(4, 48), torch.as_tensor(toks, device=d),
                torch.as_tensor(lens, device=d))
            pre = launch_counts()
            first = torch.argmax(last, -1).to(torch.int32)
            pools, table = model.paginate_caches(caches, page=8)
            st = model.init_decode_state(4)
            reset_launch_counts()
            for layout, cc, tb in (("contiguous", caches, None),
                                   ("paged", pools, table)):
                out = model.generate(p, cc, kl, first, 16, moe_state=st,
                                     block_table=tb)
                if st is not None:
                    st = out[3]
                streams[(where, layout)] = out[0].cpu().tolist()
            if where == "card":
                dec = launch_counts()
                log(f"launches tiny moe {name} prefill " + " ".join(
                    f"{k}={v}" for k, v in pre.items() if v) + " decode "
                    + " ".join(f"{k}={v}" for k, v in dec.items() if v))
                for counts, kernels, phase in ((pre, pre_k, "prefill"),
                                               (dec, dec_k, "decode")):
                    for k in kernels:
                        if counts[k] == 0:
                            res.failures.append(f"tiny moe {name}: {k} never "
                                                f"launched in {phase}")
        want = streams[("cpu", "contiguous")]
        same = all(v == want for v in streams.values())
        log(f"check tiny moe {name}: token streams card == cpu, contiguous "
            f"== paged: {same} ({4 * 16} tokens each)")
        if not same:
            res.failures.append(f"tiny moe {name}: token streams differ")


def run_decode_path(res: Results, dev, name, cfg, steps=DEC_STEPS,
                    expect=None, profile=False, keep=False):
    """Prefill → generate at full width and depth: 8 seeded prompts
    (lengths 128-1024, padded to 1024) prefilled into contiguous caches
    of capacity 2048, a paged copy at page 128, ``steps`` greedy steps
    on each (an EP MoE model over its persistent workspaces, threaded
    from step to step). ``expect``: {kernel: (launches a prefill,
    launches a decode step)} the run must show. Returns {kernel:
    launches} over the prefill and both layouts' steps; with ``keep``
    also the run's model, weights, prompts, contiguous caches (which
    hold the prefill's K/V, and the decode's past the lengths) and its
    prefill logits, for :func:`run_tp_path`."""
    import torch

    from triton_distributed_tpu_torch.kernels import (
        launch_counts,
        reset_launch_counts,
    )
    from triton_distributed_tpu_torch.models import Transformer

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Transformer(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        quantize=cfg.dense_weight_quant is not None)
    rng = np.random.default_rng(7)
    lens = torch.as_tensor(rng.integers(128, DEC_PROMPT + 1, DEC_B),
                           dtype=torch.int32, device=dev)
    tokens = torch.randint(0, cfg.vocab, (DEC_B, DEC_PROMPT),
                           generator=torch.Generator(device=dev).manual_seed(8),
                           device=dev, dtype=torch.int32)
    caches = model.init_cache(DEC_B, DEC_CAP)
    st = model.init_decode_state(DEC_B)     # EP MoE only, else None
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    expect = expect or {}
    reset_launch_counts()
    t0 = time.perf_counter()
    last, caches, kl = model.prefill(params, caches, tokens, lens)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    log(f"path {name} prefill launches " + " ".join(
        f"{k}={v}" for k, v in counts.items() if v))
    for k, (per_prefill, _) in expect.items():
        if counts[k] != per_prefill:
            res.failures.append(f"{name}: {counts[k]} {k} launches in the "
                                f"prefill, expected {per_prefill}")
    first = torch.argmax(last, -1).to(torch.int32)
    if not torch.isfinite(last).all():
        res.failures.append(f"{name}: non-finite prefill logits")
    pools, table = model.paginate_caches(caches, page=DEC_PAGE)
    # the first step's logits in both layouts (each writes the new token's
    # K/V at the slot the timed run then writes again with equal values;
    # an EP model's workspaces are threaded from call to call)
    out = model.decode_step(params, caches, kl, first, moe_state=st)
    lc, st = out[0], out[3] if st is not None else None
    out = model.decode_step(params, pools, kl, first, moe_state=st,
                            block_table=table)
    lp, st = out[0], out[3] if st is not None else None
    torch.cuda.synchronize()
    lerr = (lc - lp).abs().max().item()
    res.check(name, lerr, 1e-3 * lc.abs().max().item(),
              "first decode step logits contiguous vs paged")
    streams, step_ms = {}, {}
    for layout, cc, tb in (("contiguous", caches, None),
                           ("paged", pools, table)):
        reset_launch_counts()
        t0 = time.perf_counter()
        out = model.generate(params, cc, kl, first, steps, moe_state=st,
                             block_table=tb)
        toks, klen = out[0], out[2]
        if st is not None:
            st = out[3]
        streams[layout] = toks.cpu()
        wall = time.perf_counter() - t0
        step_ms[layout] = wall / steps * 1e3
        c = launch_counts()
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
        log(f"path {name} decode {layout}: {steps} steps ms_per_step="
            f"{step_ms[layout]:.3f} tok_s={DEC_B * steps / wall:.2f} "
            f"launches " + " ".join(f"{k}={v}" for k, v in c.items() if v)
            + f" by TPU kernel {by_tpu_kernel()}")
        for k, (_, per_step) in expect.items():
            if c[k] != per_step * steps:
                res.failures.append(f"{name} {layout}: {c[k]} {k} launches "
                                    f"in {steps} steps, expected "
                                    f"{per_step} a step")
    same = int((streams["contiguous"] == streams["paged"]).sum())
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"path {name} layers={cfg.n_layers}: setup_s={setup:.2f} "
        f"prefill_ms={prefill_ms:.2f} ({DEC_B} x {DEC_PROMPT} rows, lens "
        f"{lens.tolist()}, prefill_tok_s="
        f"{int(lens.sum()) / prefill_ms * 1e3:.1f}) decode ms_per_step "
        f"contiguous={step_ms['contiguous']:.3f} paged="
        f"{step_ms['paged']:.3f} first-step logits max|contiguous-paged|="
        f"{lerr:.6g} tokens equal {same}/{DEC_B * steps} "
        f"peak_mem_gib={peak:.2f}")
    if same != DEC_B * steps:
        res.failures.append(f"{name}: the contiguous and paged token streams"
                            f" differ ({same}/{DEC_B * steps} equal)")
    if int(klen.max()) != int(kl.max()) + steps:
        res.failures.append(f"{name}: lengths did not advance")
    if profile:
        profile_prefill(name, model, params, tokens, lens)
        profile_decode(name, model, params, caches, kl, first)
    if keep:
        return counts, dict(model=model, params=params, caches=caches,
                            kl=kl, last=last, tokens=tokens, lens=lens)
    return counts


def run_tp_path(res: Results, dev, one, profile=False):
    """The Llama-2-7B bf16 decode path at tp = 4 on a loopback mesh of
    the card, from the tp = 1 run ``one`` (:func:`run_decode_path` with
    ``keep``): its weights sharded, its prompts prefilled into
    sequence-sharded caches (64 mesh AG-GEMM and 64 GEMM-RS launches,
    each covering the 4 ranks; no world-size-1 GEMM), the first step's
    logits within ``TP_PREFILL_RTOL`` of the tp = 1 prefill's, then
    ``TP_STEPS`` steps in lockstep with the tp = 1 model, both fed its
    greedy tokens: every step's logits within ``TP_DECODE_RTOL``, the
    tokens equal where the tp = 1 top-2 margin exceeds that tolerance
    (as tests/test_models.py gates them), and the last step, rerun with
    a rank's partial lost (:func:`_lost_partial`), outside it for every
    rank that holds positions; then ``TP_STEPS`` timed greedy steps
    (``generate``), which must launch the flash decode once a layer for
    all ranks and the all-gather twice. Returns {kernel: launches} of
    the prefill and the timed steps."""
    import torch

    from triton_distributed_tpu_torch.kernels import (
        launch_counts,
        reset_launch_counts,
    )
    from triton_distributed_tpu_torch.models import Transformer
    from triton_distributed_tpu_torch.runtime import Mesh

    name = f"llama_7b bf16 tp{TP}"
    m1, kl = one["model"], one["kl"]
    cfg = m1.config
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Transformer(cfg, mesh=Mesh.loopback(TP, dev))
    params = model.shard_params(one["params"])
    caches = model.init_cache(DEC_B, DEC_CAP)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    reset_launch_counts()
    t0 = time.perf_counter()
    last, caches, kl4 = model.prefill(params, caches, one["tokens"],
                                      one["lens"])
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    log(f"path {name} prefill launches " + " ".join(
        f"{k}={v}" for k, v in counts.items() if v))
    for k, want in (("ag_gemm", 2 * cfg.n_layers),
                    ("gemm_rs", 2 * cfg.n_layers), ("ag_gemm_n1", 0),
                    ("gemm_rs_n1", 0)):
        if counts[k] != want:
            res.failures.append(f"{name}: {counts[k]} {k} launches in the "
                                f"prefill, expected {want}")
    if not torch.equal(kl4, kl):
        res.failures.append(f"{name}: prefill lengths differ")
    scale = one["last"].abs().max().item()
    lerr = (last - one["last"]).abs().max().item()
    res.check(name, lerr, TP_PREFILL_RTOL * scale,
              "first-step logits tp4 vs tp1")
    # teacher-forced lockstep: both models fed the tp = 1 model's greedy
    # token each step, every step's logits compared on every row, and the
    # tokens on the rows whose tp = 1 top-2 margin exceeds the tolerance
    # (the gate of tests/test_models.py)
    tol = TP_DECODE_RTOL * scale
    l1, l4, k1, k4 = one["last"], last, kl, kl4
    c1 = one["caches"]
    compared = equal = 0
    drift = []      # max |logits tp4 - tp1| of each decode step
    for i in range(TP_STEPS + 1):
        top2 = torch.topk(l1, 2, dim=-1).values
        gate = (top2[:, 0] - top2[:, 1]) > tol
        t1 = torch.argmax(l1, -1).to(torch.int32)
        compared += int(gate.sum())
        equal += int((gate & (torch.argmax(l4, -1) == t1)).sum())
        if i == TP_STEPS:
            break
        prev = (k4, t1)
        l1, c1, k1 = m1.decode_step(one["params"], c1, k1, t1)
        l4, caches, k4 = model.decode_step(params, caches, k4, t1)
        drift.append((l4 - l1).abs().max().item())
    res.check(name, max(drift), tol, f"teacher-forced decode logits tp4 vs "
              f"tp1, {TP_STEPS} steps x {DEC_B} rows")
    log(f"check {name} teacher-forced: max|logits tp4-tp1| by step "
        + " ".join(f"{x:.4g}" for x in drift) + f"; tokens equal on "
        f"{equal}/{compared} gated (row, step) pairs (gate: tp1 top-2 "
        f"margin > {tol:.4g}) of {DEC_B * (TP_STEPS + 1)}")
    if compared == 0 or equal != compared:
        res.failures.append(f"{name}: {compared - equal} of {compared} "
                            "gated tokens differ from tp = 1")
    # the check's power: the last step again with one rank's (out, lse)
    # partial lost in the gather (its lse set to NEG_INF), against the
    # same tp = 1 logits; losing a rank that holds positions must move the
    # logits past the tolerance (an empty rank's partial weighs 0 anyway)
    held = torch.clamp(prev[0].long()[None, :] - DEC_CAP // TP
                       * torch.arange(TP, device=dev)[:, None], 0,
                       DEC_CAP // TP)                          # (W, B)
    for r in range(TP):
        with _lost_partial(r):
            lf, _, _ = model.decode_step(params, caches, *prev)
        err = (lf - l1).abs().max().item()
        n_r = held[r].tolist()
        log(f"check {name} rank {r}'s partial lost at the last step: "
            f"max|logits - tp1|={err:.6g} (tol {tol:.4g}); the rank holds "
            f"{min(n_r)}-{max(n_r)} positions a row")
        if max(n_r) and not err > tol:
            res.failures.append(f"{name}: losing rank {r}'s partial moves "
                                f"the logits by {err}, within the "
                                f"tolerance {tol}")
    first = torch.argmax(last, -1).to(torch.int32)
    reset_launch_counts()
    t0 = time.perf_counter()
    toks, _, klen = model.generate(params, caches, kl4, first, TP_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = launch_counts()
    log(f"path {name} decode contiguous: {TP_STEPS} steps ms_per_step="
        f"{wall / TP_STEPS * 1e3:.3f} tok_s={DEC_B * TP_STEPS / wall:.2f} "
        "launches " + " ".join(f"{k}={v}" for k, v in c.items() if v))
    for k, per_step in (("all_gather", 2 * cfg.n_layers),
                        ("flash_decode", cfg.n_layers), ("ag_gemm", 0),
                        ("gemm_rs", 0)):
        if c[k] != per_step * TP_STEPS:
            res.failures.append(f"{name}: {c[k]} {k} launches in "
                                f"{TP_STEPS} steps, expected {per_step} a "
                                "step")
    for k, v in c.items():
        counts[k] += v
    if toks.shape != (DEC_B, TP_STEPS) or int(klen.max()) != int(
            kl4.max()) + TP_STEPS:
        res.failures.append(f"{name}: wrong tokens or lengths")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"path {name} layers={cfg.n_layers}: setup_s={setup:.2f} "
        f"prefill_ms={prefill_ms:.2f} ({DEC_B} x {DEC_PROMPT} rows, "
        f"prefill_tok_s={int(one['lens'].sum()) / prefill_ms * 1e3:.1f}) "
        f"decode ms_per_step={wall / TP_STEPS * 1e3:.3f} first-step logits "
        f"max|tp4-tp1|={lerr:.6g} (max|logit| {scale:.4g}) "
        f"peak_mem_gib={peak:.2f} (both weight sets and both caches)")
    if profile:
        profile_prefill(name, model, params, one["tokens"], one["lens"])
        profile_decode(name, model, params, caches, kl4, first)
    return counts


def run_moe_tp4_path(res: Results, dev, name, one, profile=False):
    """DeepSeek-MoE-16B at tp = 4 on a loopback mesh of the card, from
    the MoE generation path's tp = 1 run ``one`` (:func:`run_decode_path`
    with ``keep``) in the same flavour: its weights sharded (EP: the
    experts split over the ranks; TP: their F dim), its prompts prefilled
    into sequence-sharded caches (the TP prefill must launch each mesh
    MoE-TP kernel once a MoE layer; the EP prefill the all-to-all over
    the mesh twice a MoE layer; no one-rank MoE form), the first step's
    logits within ``TP_PREFILL_RTOL`` of the tp = 1 prefill's, then
    ``TP_STEPS`` steps in lockstep with the tp = 1 model (the EP decode
    of each over its own persistent workspaces, 54 all-to-all launches a
    step at tp = 4), both fed its greedy tokens, as :func:`run_tp_path`
    holds them; the last step again with one rank's combine chunks lost
    (EP) or its partial lost (TP) must break the tolerance, for every
    rank. Then ``TP_STEPS`` timed greedy steps, their device ops a step
    (torch.profiler) and the peak memory. Returns {kernel: launches} of
    the prefill and of the timed steps."""
    import torch

    from triton_distributed_tpu_torch.kernels import (
        launch_counts,
        reset_launch_counts,
    )
    from triton_distributed_tpu_torch.models import Transformer
    from triton_distributed_tpu_torch.runtime import Mesh

    m1, kl = one["model"], one["kl"]
    cfg = m1.config
    n_moe = len(cfg.moe_layers)
    name = f"{name} tp{TP}"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Transformer(cfg, mesh=Mesh.loopback(TP, dev))
    params = model.shard_params(one["params"])
    caches = model.init_cache(DEC_B, DEC_CAP)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    reset_launch_counts()
    t0 = time.perf_counter()
    last, caches, kl4 = model.prefill(params, caches, one["tokens"],
                                      one["lens"])
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    pre = launch_counts()
    log(f"path {name} prefill launches " + " ".join(
        f"{k}={v}" for k, v in pre.items() if v))
    want = {"ag_gemm": cfg.n_layers + 1, "gemm_rs": cfg.n_layers + 1,
            "chunked_a2a": 0, "ag_group_gemm": 0, "moe_reduce_rs": 0}
    if cfg.moe == "tp":
        want.update(ag_group_gemm_mesh=n_moe, moe_reduce_rs_mesh=n_moe,
                    chunked_a2a_mesh=0)
    else:
        want.update(chunked_a2a_mesh=2 * n_moe, ag_group_gemm_mesh=0,
                    moe_reduce_rs_mesh=0)
    for k, v in want.items():
        if pre[k] != v:
            res.failures.append(f"{name}: {pre[k]} {k} launches in the "
                                f"prefill, expected {v}")
    if not torch.equal(kl4, kl):
        res.failures.append(f"{name}: prefill lengths differ")
    scale = one["last"].abs().max().item()
    lerr = (last - one["last"]).abs().max().item()
    res.check(name, lerr, TP_PREFILL_RTOL * scale,
              "first-step logits tp4 vs tp1")
    tol = MOE_TP_DECODE_RTOL * scale
    l1, l4, k1, k4 = one["last"], last, kl, kl4
    c1 = one["caches"]
    s1, s4 = m1.init_decode_state(DEC_B), model.init_decode_state(DEC_B)
    compared = equal = agree = 0
    drift, rms = [], []
    reset_launch_counts()
    for i in range(TP_STEPS + 1):
        top2 = torch.topk(l1, 2, dim=-1).values
        gate = (top2[:, 0] - top2[:, 1]) > tol
        t1 = torch.argmax(l1, -1).to(torch.int32)
        compared += int(gate.sum())
        equal += int((gate & (torch.argmax(l4, -1) == t1)).sum())
        agree += int((torch.argmax(l4, -1) == t1).sum())
        if i == TP_STEPS:
            break
        prev = (k4, t1, s4)
        r1 = m1.decode_step(one["params"], c1, k1, t1, moe_state=s1)
        r4 = model.decode_step(params, caches, k4, t1, moe_state=s4)
        (l1, c1, k1), (l4, caches, k4) = r1[:3], r4[:3]
        if s1 is not None:
            s1, s4 = r1[3], r4[3]
        drift.append((l4 - l1).abs().max().item())
        rms.append(_rel_rms(l4, l1))
    lock = launch_counts()
    if cfg.moe == "ep" and lock["chunked_a2a_mesh"] != 2 * n_moe * TP_STEPS:
        res.failures.append(f"{name}: {lock['chunked_a2a_mesh']} all-to-all "
                            f"launches in {TP_STEPS} lockstep steps, "
                            f"expected {2 * n_moe} a step")
    res.check(name, max(drift), tol, f"teacher-forced decode logits tp4 vs "
              f"tp1, {TP_STEPS} steps x {DEC_B} rows")
    res.check(name, max(rms), MOE_TP_DECODE_RMS, "teacher-forced decode "
              "logits tp4 vs tp1", metric="relative_rms")
    log(f"check {name} teacher-forced: max|logits tp4-tp1| by step "
        + " ".join(f"{x:.4g}" for x in drift) + "; relative rms by step "
        + " ".join(f"{x:.4g}" for x in rms) + f"; tokens equal on "
        f"{equal}/{compared} gated (row, step) pairs (gate: tp1 top-2 "
        f"margin > {tol:.4g}), on {agree} of all "
        f"{DEC_B * (TP_STEPS + 1)}")
    if compared == 0 or equal != compared:
        res.failures.append(f"{name}: {compared - equal} of {compared} "
                            "gated tokens differ from tp = 1")
    # the check's power: the last step again with one rank's share lost,
    # against the same tp = 1 logits
    for r in range(TP):
        with _lost_moe_rank(r, cfg.moe):
            lf = model.decode_step(params, caches, *prev[:2],
                                   moe_state=prev[2])[0]
        err, rel = (lf - l1).abs().max().item(), _rel_rms(lf, l1)
        what = "combine chunks" if cfg.moe == "ep" else "partial"
        log(f"check {name} rank {r}'s {what} lost at the last step: "
            f"max|logits - tp1|={err:.6g} (tol {tol:.4g}) relative rms "
            f"{rel:.4g} (tol {MOE_TP_DECODE_RMS:g})")
        if not (err > tol and rel > MOE_TP_DECODE_RMS):
            res.failures.append(f"{name}: losing rank {r}'s {what} moves the"
                                f" logits by {err} (relative rms {rel}), "
                                "within the tolerances")
    first = torch.argmax(last, -1).to(torch.int32)
    st = model.init_decode_state(DEC_B)
    reset_launch_counts()
    t0 = time.perf_counter()
    out = model.generate(params, caches, kl4, first, TP_STEPS, moe_state=st)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dec = launch_counts()
    toks, klen = out[0], out[2]
    log(f"path {name} decode contiguous: {TP_STEPS} steps ms_per_step="
        f"{wall / TP_STEPS * 1e3:.3f} tok_s={DEC_B * TP_STEPS / wall:.2f} "
        "launches " + " ".join(f"{k}={v}" for k, v in dec.items() if v))
    per_step = {"flash_decode": cfg.n_layers, "all_gather": 2 * cfg.n_layers,
                "chunked_a2a_mesh": 2 * n_moe if cfg.moe == "ep" else 0,
                "chunked_a2a": 0, "ag_group_gemm_mesh": 0}
    for k, v in per_step.items():
        if dec[k] != v * TP_STEPS:
            res.failures.append(f"{name}: {dec[k]} {k} launches in "
                                f"{TP_STEPS} steps, expected {v} a step")
    if toks.shape != (DEC_B, TP_STEPS) or int(klen.max()) != int(
            kl4.max()) + TP_STEPS:
        res.failures.append(f"{name}: wrong tokens or lengths")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"path {name} layers={cfg.n_layers}: setup_s={setup:.2f} "
        f"prefill_ms={prefill_ms:.2f} ({DEC_B} x {DEC_PROMPT} rows, "
        f"prefill_tok_s={int(one['lens'].sum()) / prefill_ms * 1e3:.1f}) "
        f"decode ms_per_step={wall / TP_STEPS * 1e3:.3f} first-step logits "
        f"max|tp4-tp1|={lerr:.6g} (max|logit| {scale:.4g}) "
        f"peak_mem_gib={peak:.2f} (both weight sets and both caches)")
    # device ops a step: a short profiled window of the served decode
    profile_decode(name, model, params, caches, kl4, first, steps=4,
                   moe_state=model.init_decode_state(DEC_B))
    if profile:
        profile_prefill(name, model, params, one["tokens"], one["lens"])
    return pre, dec


def _rel_rms(a, b) -> float:
    """rms(a - b) / rms(b) over every row and column."""
    d = (a.float() - b.float()).pow(2).mean().sqrt()
    return (d / b.float().pow(2).mean().sqrt()).item()


@contextlib.contextmanager
def _lost_moe_rank(rank: int, flavour: str):
    """Within the block, the MoE blocks lose ``rank``'s share (a fault
    made for the check's power): EP, the combine leg loses the chunks
    ``rank`` returns (every source reads zeros for its assignments
    there); TP, the decode's sum over the ranks loses ``rank``'s partial
    product."""
    import torch

    from triton_distributed_tpu_torch.kernels import moe_dispatch as md
    from triton_distributed_tpu_torch.models import transformer as tf

    if flavour == "ep":
        mod, attr = md, "combine_view"
        orig = md.combine_view

        def lossy(ctx, comb_tok, comb_meta, peer, dest, offs_al, n_valid):
            rows = orig(ctx, comb_tok, comb_meta, peer, dest, offs_al,
                        n_valid)
            return torch.where((peer == rank)[..., None],
                               torch.zeros_like(rows), rows)
    else:
        mod, attr = tf, "_sum_rank_partials"
        orig = tf._sum_rank_partials

        def lossy(parts):
            keep = torch.ones(parts.shape[0], device=parts.device)
            keep[rank] = 0
            return orig(parts * keep.to(parts.dtype).reshape(
                -1, *([1] * (parts.dim() - 1))))

    setattr(mod, attr, lossy)
    try:
        yield
    finally:
        setattr(mod, attr, orig)


@contextlib.contextmanager
def _lost_partial(rank: int):
    """Within the block, the sequence-parallel decode loses ``rank``'s
    (out, lse) partial in the gather: the gathered lse rows of that rank
    read NEG_INF, so the combine weighs its out 0 (a fault made for the
    check's power; the out gather, 3-D, passes untouched)."""
    from triton_distributed_tpu_torch.kernels import allgather as agk
    from triton_distributed_tpu_torch.kernels.flash_decode import NEG_INF

    gather = agk.all_gather

    def lossy(x, mesh, axis="tp", **kw):
        got = gather(x, mesh, axis, **kw)
        if got[0].dim() != 2:
            return got
        g, m = got[0].clone(), x[0].shape[0]
        g[rank * m:(rank + 1) * m] = NEG_INF
        return [g] * len(got)

    agk.all_gather = lossy
    try:
        yield
    finally:
        agk.all_gather = gather


def profile_prefill(name, model, params, tokens, lens):
    """Device time by kernel and the device's idle share over one more
    prefill of the path's batch into fresh caches (torch.profiler, CUDA
    activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    caches = model.init_cache(DEC_B, DEC_CAP)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.prefill(params, caches, tokens, lens)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy, rows = device_rows(prof)
    log(f"profile {name} prefill: under the profiler wall_ms="
        f"{wall_us / 1e3:.2f} device_busy_ms={busy / 1e3:.2f} "
        f"device_ops={sum(n for *_, n in rows)} "
        f"idle_share={max(0.0, 1 - busy / wall_us):.4f}")
    log_rows(f"{name} prefill", busy, rows)


def profile_decode(name, model, params, caches, kl, first, steps: int = 8,
                   moe_state=None):
    """Device time by kernel and the device's idle share over ``steps``
    contiguous decode steps (torch.profiler, CUDA activity), and the
    host's enqueue time of a step (its return, before a synchronize);
    an EP model's workspaces ``moe_state`` threaded from step to step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    state = [moe_state]

    def run():
        lens, toks, enq = kl, first, 0.0
        for _ in range(steps):
            t = time.perf_counter()
            out = model.decode_step(params, caches, lens, toks,
                                    moe_state=state[0])
            logits, _, lens = out[:3]
            if state[0] is not None:
                state[0] = out[3]
            enq += time.perf_counter() - t
            toks = torch.argmax(logits, -1).to(torch.int32)
        torch.cuda.synchronize()
        return enq

    run()
    t0 = time.perf_counter()
    enq = run()
    plain_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy, rows = device_rows(prof)
    log(f"profile {name} decode {steps} steps: wall_ms={plain_us / 1e3:.2f} "
        f"host_enqueue_ms={enq * 1e3:.2f} device_busy_ms={busy / 1e3:.2f} "
        f"device_ops_per_step={sum(n for *_, n in rows) / steps:.0f} "
        f"idle_share={max(0.0, 1 - busy / plain_us):.4f} | under the "
        f"profiler wall_ms={wall_us / 1e3:.2f}")
    log_rows(f"{name} decode", busy, rows)


def run_generate_cli(res: Results, dev, preset, tp=1):
    """The port's generation CLI once at full size: B 4, prompt 512, 16
    steps of ``preset``, at ``tp`` ranks, on its default device (the
    current CUDA device, ``dev``)."""
    import torch

    from triton_distributed_tpu_torch.tools import generate

    torch.cuda.empty_cache()
    out = generate.main(["--preset", preset, "--batch", "4",
                         "--prompt-len", "512", "--steps", "16",
                         "--seed", "3", "--tp", str(tp)])
    if out["device"] != str(dev):
        res.failures.append(f"tools.generate ran on {out['device']}, not "
                            f"{dev}")
    log(f"path tools.generate {preset} tp={tp}: prefill_ms="
        f"{out['prefill_ms']:.2f} ms_per_step={out['ms_per_step']:.3f} "
        f"tok_s={out['tok_s']:.2f}")
    if np.asarray(out["tokens"]).shape != (4, 16):
        res.failures.append(f"tools.generate {preset}: wrong token shape")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="after the main (MoE) path, profile a few engine "
                    "steps, and a prefill and a few decode steps of each "
                    "decode and MoE generation path")
    opts = ap.parse_args()
    t_start = time.perf_counter()

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
    from triton_distributed_tpu_torch.models import presets

    llama = presets.llama_7b(kv_quant="int8", dense_weight_quant="int8",
                             dense_act_quant="int8")
    deepseek = presets.deepseek_moe_16b()
    # the Llama path's shapes are its own checks; the main path's shapes
    # also make the kernels line's rows
    for path, cfg, main_path in (("llama_7b", llama, False),
                                 ("deepseek_moe_16b", deepseek, True)):
        check_gemms(res, dev, path, cfg, main_path)
        check_attention(res, dev, path, cfg, main_path)
    moe = moe_step_inputs(dev, deepseek)
    check_a2a(res, dev, moe)
    check_expert_gemms(res, dev, moe)
    del moe
    check_decode_kernels(res, dev)
    check_n1_gemms(res, dev)
    check_moe_tp_kernels(res, dev)
    check_mesh_kernels(res, dev)
    n_moe = len(deepseek.moe_layers)
    check_a2a_mesh(res, dev, n_moe)
    check_moe_tp_mesh_kernels(res, dev, n_moe)
    res.finish_rows()
    check_tiny(res, dev)
    check_tiny_decode(res, dev)
    check_tiny_moe_decode(res, dev)
    check_tiny_tp(res, dev)
    check_tiny_moe_tp4(res, dev)

    run_path(res, dev, "llama_7b", llama)
    bf16_counts, bf16_steps = run_path(
        res, dev, "deepseek_moe_16b_bf16_experts", presets.deepseek_moe_16b(
            moe_weight_quant=None, moe_act_quant=None))
    # the main path last, and its profile after its timed run: a
    # torch.profiler run slows the later host work of the process
    main_counts, main_steps = run_path(res, dev, "deepseek_moe_16b",
                                       deepseek, profile=opts.profile)
    # the decode path: two configurations, each one prefill and DEC_STEPS
    # steps per layout; the bf16 run's weights and prompts then drive the
    # tensor-parallel path (its launches are counted apart)
    decode_counts, one = run_decode_path(
        res, dev, "llama_7b bf16", presets.llama_7b(param_dtype=torch.bfloat16),
        profile=opts.profile, keep=True)
    tp_counts = run_tp_path(res, dev, one, profile=opts.profile)
    del one
    for k, v in run_decode_path(res, dev, "llama_7b int8", llama,
                                profile=opts.profile).items():
        decode_counts[k] += v
    run_generate_cli(res, dev, "llama_7b")
    run_generate_cli(res, dev, "llama_7b", tp=TP)
    torch.cuda.empty_cache()
    # the MoE generation path: DeepSeek-MoE-16B at full width and depth
    # as served (EP: int8 W8A8 experts over an fp8 wire, int8 KV, W8A8
    # dense) and in the TP flavour with bf16 experts, whose prefill runs
    # the two MoE-TP kernels once a MoE layer; then each flavour at
    # tp = 4 on a loopback mesh from the same weights and prompts (the
    # MoE path over the mesh), each freed before the next
    moe_counts = {}
    mesh_counts = {}
    none_mesh = {"chunked_a2a_mesh": (0, 0), "ag_group_gemm_mesh": (0, 0),
                 "moe_reduce_rs_mesh": (0, 0)}
    for name, cfg, expect in (
            ("deepseek_moe_16b ep", deepseek,
             {"ggemm_bf16": (2 * n_moe, 0),
              "chunked_a2a": (2 * n_moe, 2 * n_moe),
              "ag_group_gemm": (0, 0), "moe_reduce_rs": (0, 0),
              **none_mesh}),
            ("deepseek_moe_16b tp", presets.deepseek_moe_16b(
                moe="tp", moe_weight_quant=None, moe_act_quant=None),
             {"ag_group_gemm": (n_moe, 0), "moe_reduce_rs": (n_moe, 0),
              "chunked_a2a": (0, 0), **none_mesh})):
        counts, one = run_decode_path(res, dev, name, cfg,
                                      steps=MOE_GEN_STEPS, expect=expect,
                                      profile=opts.profile, keep=True)
        for k in PATH_KERNELS[name]:
            if counts[k] == 0:
                res.failures.append(f"{name}: {k} never launched")
        for k, v in counts.items():
            moe_counts[k] = moe_counts.get(k, 0) + v
        pre, dec = run_moe_tp4_path(res, dev, name, one,
                                    profile=opts.profile)
        # the rows: the MoE-TP mesh kernels from the TP prefill, the
        # all-to-all over the mesh from the EP run's timed steps
        for k in MOE_MESH_ROWS:
            mesh_counts[k] = mesh_counts.get(k, 0) + pre[k]
        mesh_counts["chunked_a2a_mesh"] = mesh_counts.get(
            "chunked_a2a_mesh", 0) + dec["chunked_a2a_mesh"]
        for k in PATH_KERNELS[f"{name} tp{TP}"]:
            if pre[k] + dec[k] == 0:
                res.failures.append(f"{name} tp{TP}: {k} never launched")
        del one
        torch.cuda.empty_cache()
    run_generate_cli(res, dev, "deepseek_moe_16b")
    run_generate_cli(res, dev, "deepseek_moe_16b", tp=TP)
    # each serving row's launches come from the main path; the bf16
    # grouped GEMM runs only where the experts are bf16. The decode rows'
    # come from the decode path: flash_decode / paged_decode 32 a step in
    # each configuration (64 a step index over the two; flash_decode also
    # the tp = 4 path's 32 a step over its 32 steps), the GEMMs 32 a
    # prefill at each of two shapes; the MoE-TP rows' from the MoE
    # generation path's one TP prefill; the mesh GEMM rows' from the tp = 4
    # prefill (32 at each of two shapes), the all-gather's from its timed
    # decode steps (32 a step at each of two shapes). A row's times are
    # weighted by the launches a step of its shapes: those must be the
    # run's
    for name in KERNELS:
        if name == "flash_decode":
            n, steps = decode_counts[name] + tp_counts[name], DEC_STEPS
        elif name == "paged_decode":
            n, steps = decode_counts[name], DEC_STEPS
        elif name in ("ag_gemm_n1", "gemm_rs_n1"):
            n, steps = decode_counts[name], 2
        elif name in MOE_TP_ROWS:
            n, steps = moe_counts[name], 1
        elif name in TP_ROWS:
            n, steps = tp_counts[name], 1
        elif name == "all_gather":
            n, steps = tp_counts[name], TP_STEPS
        elif name in MOE_MESH_ROWS:
            n, steps = mesh_counts[name], 1
        elif name == "chunked_a2a_mesh":
            n, steps = mesh_counts[name], TP_STEPS
        else:
            n, steps = ((main_counts[name], main_steps) if main_counts[name]
                        else (bf16_counts[name], bf16_steps))
        res.kernel(name, launches=n)
        per_step = sum(s["n"] for s in res.mix[name])
        if n != per_step * steps:
            res.failures.append(
                f"{name}: {n} launches in {steps} steps, but its row "
                f"weighs shapes of {per_step} launches a step")
    log(f"smoke wall_s={time.perf_counter() - t_start:.1f}")
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
