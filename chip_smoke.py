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
   same work — the dense W8A8 projections (on K-major weights, bit for
   bit, on the ``wgmma`` tiles), the W8A16 lm_head (at the
   serving slots' 16 rows and the decode batch's 8, on the tensor-core
   form) and attention at the shapes of the Llama-2-7B step and of the
   DeepSeek-MoE-16B step, the MoE step's chunked all-to-all (both
   legs, both modes, byte-exact) and expert GEMMs (bf16, and W8A8 bit
   for bit on the ``wgmma`` tiles, 64 experts), W8A8 at the Llama-2-7B
   int8 decode's shapes (8 rows, the four projections and a tp = 4
   rank's shards, bit for bit on the weight-streaming form, beside
   ``torch._int_mm``) and both W8A8 forms at 8 to 64 rows (where one
   hands over to the other), and the MoE router on bf16 x at 768 and 8
   rows (one device
   operation a call); and the decode path's kernels at Llama-2-7B's full width:
   flash decode (bf16 and int8, contiguous bhsd and bshd, paged at page
   128, one soft-capped case) and the world-size-1 AG-GEMM / GEMM-RS at
   the prefill's shapes; the two MoE-TP kernels (AG + grouped GEMM with
   the gather fused into its tile load, grouped GEMM + RS) at the
   DeepSeek-MoE-16B TP prefill's shapes, and in f32 and bf16 with an
   empty expert; and the tensor-parallel kernels at the Llama-2-7B tp = 4
   path's shapes, four ranks of a loopback mesh in each launch: the
   AG-GEMM and GEMM-RS over the mesh (bf16, the prefill's wqkv / up and
   wo / down) and the all-gather of the decode's attention partials
   (byte-exact); and the quantized wires at the wire path's shapes
   (Llama-2-7B's widths at tp = 4, an outlier row a shard): the wire
   quantizer (byte-exact), the AG-GEMM on fp8 / int8 (wqkv, up; the
   bf16 GEMM's excess check) and int8-mxu (bit-exact), the GEMM-RS on
   fp8 / int8 (wo, down; the fold on the plain partials bit-exact, the
   whole within a stated bound of code steps) and the fp8 all-gather
   (byte-exact), every launch of the fp8 / int8 AG-GEMM and of the
   GEMM-RS partials on the warpgroup GEMM (``wgmma``), ptxas's spills
   for it none; and the MoE-TP wires at the MoE wire path's shapes
   (DeepSeek-MoE-16B at tp = 4, 20480 sorted rows a shard, an outlier
   token a shard): the quantizer on the sorted slabs (byte-exact), the
   AG kernels on fp8 / int8 (the bf16 GEMM's excess check, per row) and
   int8-mxu (bit-exact), the reduce's partials (the excess check) and
   its fold on fp8 / int8 (bit-exact, as is the whole wire), every
   launch of the fp8 / int8 AG and of the partials on the grouped
   warpgroup GEMM (``wgmma``), ptxas's spills for it none; and the
   collectives at the collectives path's shapes (4 ranks): the
   reduce-scatter of the composed MoE-TP's stacked partials, 4 x 8192 x
   2048 (the stream engine) and 4 x 1024 x 2048 (the VMEM ring), bit-exact
   in bf16 and f32, its wire folds on fp8 / int8 at one scale a row and
   at 64-row chunks (bit-exact), and the all-to-all at the padded-slot
   EP transport's slot shapes (byte-exact); the int8-mxu GEMM-RS
   producers, their folds and the other all-gathers at the step-4 path's
   shapes; and the cp LSE-combine at the long-context path's shapes (2
   shards of DeepSeek-MoE-16B's 768 packed rows, Hkv 16, D 128, bf16; 4
   in f32; both schedule depths; bit-exact, a row held by shard 0 alone
   bit-equal to shard 0's partial); and the KV-page ship, byte for byte,
   in JAX's mesh form (the lint geometry and a full DeepSeek page, 2 and
   4 ranks, coalesce 1, 2, 4) and in the engine form at DeepSeek's pools
   (a 1024-token request's 64 pages of all 56 pools and both rails in
   one launch); and the dp gradient ring (``check_grad_ring``) bit for
   bit in every mode (int8 stochastic rounding and fp8, feedback on and
   off, the TPU kernel's deterministic mode, depth 2 and 3, n = 2, 4, 8)
   and its all-gather half, both timed at the trainer's slab. The
   kernels line reports each
   kernel at the shapes of the path that launches it, its times averaged
   over them by their launches a step;
4. tiny: the int8 tiny dense model, the tiny DeepSeek-MoE preset and
   its float-expert variant, each served on the card and on the CPU
   from the same weights; the tiny f32 and int8 models, and the tiny
   DeepSeek-MoE preset as served (EP) and in its TP flavour, through
   prefill + generate, contiguous and paged, and the tiny int8 model at
   tp = 4 on a loopback mesh — the token streams must be equal, and the
   card's run must launch the kernels of its path. Then the training
   paths: the dp × tp × cp trainer at Llama-2-7B's widths
   (``run_train_path``: 4 steps against ``train_step_reference`` on the
   card, loss, update and Adam moment, the dp ring on int8, its last two
   steps at ring depth 3, and a control with the ring's result dropped
   that must fail) and
   ``Transformer.train_step`` on Llama-2-7B cut to 8 layers at tp = 1
   and 4 (``run_train_lm_path``: 2 SGD steps, the loss falling, tp = 4
   within a stated tolerance of tp = 1);
5. the serving paths, each a continuous-batching engine serving the
   same Poisson trace with the launches of every kernel counted over
   the run: the Llama-2-7B geometry (int8 KV, W8A8 projections, W8A16
   lm_head); DeepSeek-MoE-16B with bf16 experts; and the main path,
   DeepSeek-MoE-16B at full width and depth (28 layers, 64 experts
   top-6 over an fp8 EP wire, W8A8 experts and projections, int8 KV),
   last. ``--profile`` then profiles a few of the main path's engine
   steps (device time by kernel, host enqueue time, the device's idle
   share), and a prefill and a few decode steps of each decode and MoE
   generation path. Then the disaggregated path (``run_disagg_path``):
   the main path's weights and trace served by ``DisaggregatedEngine``,
   its prefill and decode roles on the card, each cohort's pages landing
   in the decode role's pool through one ``tdt_kv_ship`` launch; every
   page byte-equal to its source at commit, every stream equal to the
   main path's, and a replay with the ship's scale rail dropped moving
   the first shipped request's logits;
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
   twice a layer and step). Then the wire path: the tensor-parallel
   layers (``ColumnParallelLinear`` wqkv, ``RowParallelLinear`` wo,
   ``ParallelMLP``) of all 32 layers (seeded bf16 weights) on 4 x 2048
   rows at tp = 4, on the bf16, fp8, int8 and int8-mxu wires, each
   wire's outputs within JAX's pinned relative errors of the bf16
   wire's, and the last MLP output all-gathered on the ring on 'auto'
   (fp8); on the
   loopback mesh no byte crosses a link, so this shows the wires'
   numerics and cost, not a bandwidth gain. Then the MoE wire path:
   DeepSeek-MoE-16B's 27 MoE layers at tp = 4 (seeded bf16 expert
   weights and router a layer, 4 x 2048 tokens with an outlier token a
   shard), each layer's ``moe_tp_mlp_overlapped`` on the bf16, fp8, int8
   and int8-mxu wires with the plain versions made to raise, the launch
   counts asserted, each wire's output within JAX's pinned reduce-wire
   limit of the bf16 wire's and its up projection within the AG-wire
   limit. Then the collectives path (``run_collectives_path``): the same
   27 MoE layers at tp = 4 with the plain versions made to raise, (a)
   the composed MoE-TP (``MoETPMLP(fused=False)``) on 4 x 2048 and
   4 x 256 tokens, one reduce-scatter a layer (the stream engine and the
   VMEM ring), held against ``MoETPMLP(fused=True)`` and
   ``moe_tp_mlp_overlapped``, the partials reduced again at depth 3
   (bit-equal) and, on the last layer, on the fp8 / int8 / 'auto' wires;
   (b) EP on the padded-slot transport (``EPMoEMLP(transport=
   "pallas")``, as served and in bf16) against the fused transport, the
   fused context demoted at ``max_m`` 4096 (two all-to-alls a layer), and
   ``EPAll2AllLayer`` round-tripping the sorted tokens byte for byte.
   Then the step-4 path (``run_step4_path``) and the long-context path
   (``run_longcontext_path``), both with the plain versions made to
   raise: DeepSeek-MoE-16B at full width and depth served at cp = 2 on a
   (tp 1, cp 2) loopback mesh, 160 pages of 16 a shard, one request of
   3584 + 64 tokens beside 7 short ones, against the same weights at
   cp = 1 on one pool of 320 pages: the long request's pages cross the
   shard boundary, the short streams equal the oracle's byte for byte,
   the long request's first-decode logits lie within a stated bf16
   tolerance of the oracle's (dropping shard 1's partial breaks it,
   schedule depth 3 changes no bit), the combine and the ragged kernel
   launch once a layer and step, and both runs print their ms a step.
   Then the port's ``tools.generate`` CLI on its default device once in
   bf16, and once with ``--tp 4``;
7. the MoE generation path, DeepSeek-MoE-16B at full width and depth as
   served (EP: fp8 wire, W8A8 int8 experts, int8 KV, W8A8 dense) and in
   its TP flavour with bf16 experts: the same batch, caches and layouts
   as the decode path, 32 greedy steps on each, the EP decode over its
   persistent workspaces; the TP prefill must launch each MoE-TP kernel
   once a MoE layer (27 times), every launch on the grouped warpgroup GEMM
   (``wgmma``), at tp = 1 and over the mesh. Then ``tools.generate --preset
   deepseek_moe_16b`` once. The run's wall time is printed last before
   the result lines.

Every W8A8 launch of the run must take the ``tc`` or ``stream`` form,
and ptxas may spill in none of the W8A8 kernels.

Exits non-zero, printing no result line, without a CUDA device or
without the port's package beside it. The last line is
``{"ok": true, "device": {...}}``; the line before it is the card's
name and power limit, and the line before that the ``{"kernels": ...}``
summary.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12       # HBM3, H100 SXM data sheet
H100_BF16_OPS = 989e12           # dense bf16 tensor-core rate
H100_INT8_OPS = 1979e12          # dense int8 tensor-core rate
H100_F32_OPS = 67e12             # float32 outside the tensor cores

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
    # the float mode's f32 (FMA) body: on the main path the EP block's
    # router product, which JAX runs as an XLA dot; the port keeps it on
    # the kernel for batch-independent row sums
    "ggemm_f32": dict(
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
    # the two fused TP kernels' GEMM bodies at world size 1: the mesh
    # entries on a one-rank table (in bf16 the warpgroup GEMM of
    # csrc/wg_gemm.cuh, in f32 the FMA tile loops)
    "ag_gemm_n1": dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/ag_gemm.cu",
        replaces="triton_distributed_tpu/kernels/ag_gemm.py:227"),
    "gemm_rs_n1": dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/gemm_rs.cu",
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
    # the quantized wires over the mesh. JAX quantizes the AG side's
    # shards with lang/wire.py's quantize_slab on the XLA side, in front
    # of the fused kernels; the port's quantizer is a kernel of its own
    "wire_quantize": dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/wire.cu",
        replaces="triton_distributed_tpu/lang/wire.py:171"),
    "ag_gemm_wire": dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/ag_gemm.cu",
        replaces="triton_distributed_tpu/kernels/ag_gemm.py:266"),
    "ag_gemm_mx": dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/ag_gemm.cu",
        replaces="triton_distributed_tpu/kernels/ag_gemm.py:309"),
    # the GEMM-RS wire in two kernels: every rank's partials, then the
    # hop-by-hop fold (the in-kernel requantizing ring of :281)
    "gemm_rs_wire": dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/gemm_rs.cu",
        replaces="triton_distributed_tpu/kernels/gemm_rs.py:281"),
    "gemm_rs_fold": dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/gemm_rs.cu",
        replaces="triton_distributed_tpu/kernels/gemm_rs.py:281"),
    "all_gather_wire": dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/allgather.cu",
        replaces="triton_distributed_tpu/kernels/allgather.py:87"),
    # the MoE-TP wires over the mesh: the AG side on fp8 / int8 and on
    # int8-mxu (its s8 loop in s8_tiles.cuh), the reduce side's partials,
    # and its fold, the GEMM-RS wire's kernel counted apart
    "ag_group_gemm_wire": dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/moe_tp_fused.cu",
        replaces="triton_distributed_tpu/kernels/moe_tp_fused.py:208"),
    "ag_group_gemm_mx": dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/moe_tp_fused.cu",
        replaces="triton_distributed_tpu/kernels/moe_tp_fused.py:243"),
    "moe_reduce_rs_wire": dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/moe_tp_fused.cu",
        replaces="triton_distributed_tpu/kernels/moe_tp_fused.py:322"),
    "moe_reduce_rs_fold": dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/gemm_rs.cu",
        replaces="triton_distributed_tpu/kernels/moe_tp_fused.py:322"),
    # the reduce-scatter under the composed MoE-TP: one pull kernel for
    # the VMEM ring (:87) and the streaming rings (:153, :181)
    "reduce_scatter": dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/reduce_scatter.cu",
        replaces="triton_distributed_tpu/kernels/reduce_scatter.py:87"),
    # its wires: the GEMM-RS wire's fold at one scale a row (:103) and at
    # the stream's chunk (:208, :246)
    "reduce_scatter_fold": dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/gemm_rs.cu",
        replaces="triton_distributed_tpu/kernels/reduce_scatter.py:103"),
    # the padded-slot EP transport's dense all-to-all
    "all_to_all": dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/all_to_all.cu",
        replaces="triton_distributed_tpu/kernels/all_to_all.py:30"),
    # the int8-mxu GEMM-RS producers: the s8 partials stand for both TPU
    # kernels (:317 here, :394 too), each fold for its own
    "gemm_rs_mx": dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/gemm_rs.cu",
        replaces="triton_distributed_tpu/kernels/gemm_rs.py:317"),
    "gemm_rs_mxw_fold": dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/gemm_rs.cu",
        replaces="triton_distributed_tpu/kernels/gemm_rs.py:317"),
    "gemm_rs_mxr_fold": dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/gemm_rs.cu",
        replaces="triton_distributed_tpu/kernels/gemm_rs.py:394"),
    # the other all-gathers: the bidirectional ring and the persistent LL
    "all_gather_bidir": dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/allgather.cu",
        replaces="triton_distributed_tpu/kernels/allgather.py:150"),
    "all_gather_persist": dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/allgather.cu",
        replaces="triton_distributed_tpu/kernels/allgather.py:231"),
    # the cp LSE-combine of long-context serving: one kernel for the ring
    # at depth 2 and at depth 3 (schedule depth 3 adds a TPU ring slot
    # and no value), counted by the TPU kernel each launch stood for
    "cp_lse_combine": dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/cp_ring.cu",
        replaces="triton_distributed_tpu/kernels/cp_ring.py:306"),
    "cp_lse_combine3": dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/cp_ring.cu",
        replaces="triton_distributed_tpu/kernels/cp_ring.py:341"),
    # the context-parallel prefill: the KV ring with the attention that
    # consumes each arrival (tdt_ring_attention, one launch a layer for
    # every rank; Ulysses' local attention is the same kernel on a ring of
    # one block, and counts here too) and the Ulysses all-to-all
    # (tdt_ulysses_a2a, one launch a tensor and direction)
    "kv_rotate": dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/cp_ring.cu",
        replaces="triton_distributed_tpu/kernels/cp_ring.py:71"),
    "ulysses_a2a": dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/cp_ring.cu",
        replaces="triton_distributed_tpu/kernels/cp_ring.py:127"),
    # disaggregated serving's KV-page ship: one launch a cohort lands its
    # pages from every prefill-role pool into the decode role's
    "kv_ship": dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/kv_ship.cu",
        replaces="triton_distributed_tpu/kernels/kv_ship.py:117"),
    # training's dp gradient ring: one kernel for the ring at depth 2 and
    # at depth 3 (a TPU ring slot, no value), counted by the TPU kernel
    # each launch stood for, and its all-gather half, which has no TPU
    # kernel (JAX's lax.all_gather in train/grad_wire.py
    # quantized_allgather)
    "grad_ring": dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/grad_ring.cu",
        replaces="triton_distributed_tpu/kernels/cp_ring.py:187"),
    "grad_ring3": dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/grad_ring.cu",
        replaces="triton_distributed_tpu/kernels/cp_ring.py:225"),
    "grad_allgather": dict(
        route="cuda",
        source="triton_distributed_tpu_torch/csrc/grad_ring.cu",
        replaces="triton_distributed_tpu/train/grad_wire.py:189"),
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

#: the quantized-wire path: Llama-2-7B's widths at tp = 4 on a loopback
#: mesh, all 32 layers' seeded weights, 4 x 2048 rows; each layer's
#: wqkv (ColumnParallelLinear), wo (RowParallelLinear) and MLP
#: (ParallelMLP) on every wire, then the last MLP output all-gathered
#: on 'auto' over the ring. Its rows' launches and shapes come from that
#: one run
WIRES = (None, "fp8", "int8", "int8-mxu")
WIRE_ROWS = ("wire_quantize", "ag_gemm_wire", "ag_gemm_mx", "gemm_rs_wire",
             "gemm_rs_fold", "all_gather_wire")
# JAX's pinned relative errors against the bf16 wire (tests/test_wire.py):
# the AG side quantizes once, the RS side at each of the W - 1 hops
WIRE_AG_TOL = {"fp8": 0.06, "int8": 0.02, "int8-mxu": 0.04}
WIRE_RS_TOL = {"fp8": 0.15, "int8": 0.04, "int8-mxu": 0.04}
WIRE_MX_TWIN_TOL = 0.03      # int8-mxu against the dequantizing int8 wire
#: the MoE-TP wire path: DeepSeek-MoE-16B's 27 MoE layers at tp = 4 on a
#: loopback mesh, each layer's expert weights drawn from a seed, 4 x 2048
#: tokens (an outlier token x1000 a shard), each layer's
#: moe_tp_mlp_overlapped on every wire. JAX pins no MoE-wire limits of its
#: own: the path holds each wire's MLP output by WIRE_RS_TOL (the reduce
#: wire it carries), its up projection by WIRE_AG_TOL, and int8-mxu by
#: WIRE_MX_TWIN_TOL against int8. Its rows' launches and shapes come from
#: that one run (the quantizer's also from the wire path's)
MOE_WIRE_ROWS = ("ag_group_gemm_wire", "ag_group_gemm_mx",
                 "moe_reduce_rs_wire", "moe_reduce_rs_fold")
#: the collectives path: DeepSeek-MoE-16B's 27 MoE layers at tp = 4 on a
#: loopback mesh, each layer's weights drawn from a seed: the composed
#: MoE-TP over the reduce-scatter at 4 x 2048 tokens (the stream engine)
#: and 4 x 256 (the VMEM ring), and EP on the padded-slot transport at
#: 4 x 2048 tokens (slots of 2048 · 6 rows; the fused context demoted at
#: 4096). Its rows' launches and shapes come from that one run
COLL_ROWS = ("reduce_scatter", "reduce_scatter_fold", "all_to_all")
COLL_BIG, COLL_SMALL, COLL_DEMOTED_M = 2048, 256, 4096
# the composed MoE-TP against the fused (moe_tp_mlp) and the overlapped
# (moe_tp_mlp_overlapped) forms, relative to the largest output: the
# composed one rounds each rank's partial and each of the ring's 3 hops
# to bf16 (7 roundings of at most 2^-9 of the largest output, 1.4 %),
# the others sum in f32 and round once, and the overlapped form applies
# the activation in f32: 2 %
COMPOSED_TOL = 0.02
# the padded-slot EP transport against the fused one on the same weights:
# the same rows meet the same experts with the same per-row arithmetic;
# one bf16 rounding of the largest output is room for a summation order
EP_PALLAS_TOL = 2.0 ** -8

#: the step-4 path: the int8-mxu GEMM-RS producers through the row
#: layer on DeepSeek-MoE-16B's wo at tp = 4 (4 x 2048 rows a rank, K 512
#: a rank, an outlier row x1000 a shard), cut to N 1024 and 512, the
#: widest outputs JAX's gate admits (its hidden is 2048; no preset has a
#: row-parallel output this narrow), on both epilogues, and at N 2048,
#: where int8-mxu demotes to the int8 wire; then the bidirectional
#: all-gather of Llama-2-7B's last MLP output at tp = 4 (4 x (2048, 4096)
#: bf16, 16 MiB a shard) through all_gather(method=None) and at split8 2,
#: 4, 6; and 32 calls of PersistentLLAllGather at the tp = 4 decode's
#: partial shape (4 x (8, 4096) bf16, 64 KiB a shard). Its rows' launches
#: and shapes come from that one run
STEP4_ROWS = ("gemm_rs_mx", "gemm_rs_mxw_fold", "gemm_rs_mxr_fold",
              "all_gather_bidir", "all_gather_persist")
STEP4_M, STEP4_K, STEP4_NS, STEP4_DEMOTED = 2048, 512, (1024, 512), 2048
STEP4_SPLITS = (None, 2, 4, 6)
STEP4_LL_CALLS, STEP4_LL_SHAPE = 32, (DEC_B, 4096)
STEP4_AG_SHAPE = (DEC_B * DEC_PROMPT // TP, 4096)
# JAX's pinned int8-mxu contract (tests/test_wire.py): against the exact
# product, and against the dequantizing int8 wire
MX_EXACT_TOL, MX_TWIN_TOL = 0.04, 0.03

#: the long-context path: DeepSeek-MoE-16B at full width and depth served
#: at cp = 2 on a (tp 1, cp 2) loopback mesh, 160 pages of 16 positions
#: a shard, against the same weights at cp = 1 on one pool of 320 pages.
#: One request of 3584 prompt tokens + 64 new (228 pages: more than a
#: shard) arriving at step 1, after 7 of 128-512 tokens + 32 new. The
#: combine's rows' launches come from its runs: depth 2 from the cp = 2
#: run (28 a step), depth 3 from a replay of the same trace at schedule
#: depth 3 up to the long request's first decode
LC_CP, LC_NPAGES, LC_SLOTS = 2, 160, 8
LC_LONG, LC_LONG_NEW = 3584, 64
LC_SHORTS, LC_SHORT_LO, LC_SHORT_HI, LC_SHORT_NEW = 7, 128, 513, 32
LC_COMBINE_ROWS = {"cp_lse_combine": "_cp_lse_combine_kernel",
                   "cp_lse_combine3": "_cp_lse_combine_kernel3"}
# the long request's first-decode logits against the cp = 1 oracle's,
# relative to the largest oracle logit: each shard's partial is rounded
# to bf16 before the f32 merge, which the one-pool softmax never does
# (about 2^-9 of an attention output), and 28 layers of W8A8 codes and
# top-6 routing carry that on. On an H100 this read 6.3 %, and 14.5 %
# with shard 1's partial dropped from every merge: 10 % lies between
LC_LOGIT_RTOL = 0.10

#: the context-parallel prefill path: Llama-2-7B bf16 at full width and
#: depth (the decode path's weights) on a loopback mesh of 4 ranks at
#: attn = "ring" and "ulysses", against attn = "tp" on the same weights
#: and mesh: 2 prompts of 4032 and 2600 tokens padded to 4032 (1008
#: positions a rank), capacity 4096, then 32 greedy steps in lockstep,
#: every model fed the tp model's tokens. Its rows' launches come from
#: the two prefills: the ring kernel 32 a prefill (at n = 4 for ring, on
#: one block for Ulysses' local heads), the all-to-all 128 (Ulysses)
CP_N, CP_B, CP_S, CP_LENS, CP_CAP, CP_STEPS = 4, 2, 4032, (4032, 2600), 4096, 32
CP_ROWS = {"kv_rotate": "_kv_rotate_kernel",
           "ulysses_a2a": "_ulysses_a2a_kernel"}
# prefill's last-position logits and every lockstep decode step's logits
# of ring / Ulysses against attn = "tp", relative to the largest tp
# logit. The paths differ in rounding only: the tp prefill rounds its
# softmax to bf16 before P @ V and projects through the mesh GEMMs, the
# ring kernel keeps P in f32 and rounds once, the projections are one
# cuBLAS matmul; the tp = 4 decode against tp = 1, which differs in the
# same way, read at most 1.6 % of the largest logit. Losing one source
# block of rank 3's ring output (a quarter of the keys of every position
# past 3024) should move the logits as losing a decode rank's partial
# did (at least 24 %): 5 % lies between
CP_LOGIT_RTOL = 0.05

#: the disaggregated path: DeepSeek-MoE-16B as served, the main path's
#: engine configuration and trace, its prefill role and decode role (budget
#: 128) on the one card, the ship committed a tick after its launch. The
#: kernel's row weighs one launch a cohort; its shape is the engine form at
#: a 1024-token request: 64 pages of every layer's K and V pool (Hkv 16,
#: page 16, D 128, int8 with f32 scale planes), landing reversed, on pools
#: of KV_SHIP_POOL pages
DISAGG_DELAY, KV_SHIP_PAGES, KV_SHIP_POOL = 1, 64, 128
# the negative control: the first shipped request's first-decode logits
# with the ship's scale rail dropped (its landing pages keep the fresh
# pool's unit scales, ≈ 30-100× the int8 codes' true scales), against the
# same request's logits in the full run, relative to their largest. A
# token-exact ship moves them by 0; a dropped rail should move them by
# far more than 5 %
DISAGG_DROP_RTOL = 0.05

#: the training paths (check_grad_ring, run_train_path). The trainer at
#: Llama-2-7B's widths, one block as JAX's TrainConfig defines the model:
#: vocab 32000, d_model 4096, 32 heads, d_ff 11008, dp 2 × tp 2 × cp 2 on
#: the loopback mesh, seq 1024, batch 8 in 2 microbatches, ring attention,
#: the int8 dp ring. 374.3 M f32 a rank: parameters 12.0 GB, Adam 24.0 GB
#: and gradients 12.0 GB over the 8 ranks, the ring's stripes 6.0 GB, the
#: activations of a microbatch a few GB: no cut. Adam at lr 1e-5: its
#: first steps move every parameter by about lr, and at d_model 4096 JAX's
#: default 1e-2 (sized for its tiny dryrun block) sent the reference's
#: loss from 11.1 to 1292 in 4 steps on an H100. At lr 1e-5 the loss
#: moves by about 0.02 over the 4 steps, so the losses alone cannot tell a
#: sound trainer from a broken one: each step is also held to the
#: reference's by its parameter update and by Adam's first moment (the
#: gradients' running mean), leaf by leaf, and a control step with the dp
#: ring's result dropped must break both. The reference runs with
#: mlp_grad_scale=tp: JAX's step (and so the trainer) carries the MLP
#: branch's gradient tp times (train_step_reference's docstring). The
#: ring's rows take their launches from its steps, the first half at
#: depth 2, the rest at 3 (the ring's entry called with the schedule, as
#: the cp LSE-combine's replay)
TRAIN_CFG = dict(vocab=32000, d_model=4096, n_heads=32, d_ff=11008, seq=1024,
                 batch=8, dp=2, tp=2, cp=2, microbatches=2, attn="ring",
                 wire_dtype="int8", lr=1e-5)
TRAIN_STEPS = 4
TRAIN_ROWS = {"grad_ring": TRAIN_STEPS // 2,
              "grad_ring3": TRAIN_STEPS - TRAIN_STEPS // 2,
              "grad_allgather": TRAIN_STEPS}
# each step's loss against train_step_reference's (sound runs read at
# most 6.6e-5 apart on an H100), step 0 (identical parameters: the
# forward's rounding alone) within 1e-4
TRAIN_TOL, TRAIN_STEP0_TOL = 1e-3, 1e-4
# the worst leaf's ||update - the reference's|| / ||the reference's||,
# and the same of Adam's first moment: the int8 ring quantizes each
# gradient twice (the hop, the all-gather), and under Adam a gradient
# that the wire's noise flips in sign moves its weight by 2 lr. Sound
# runs read at most 0.354 (step 0, head) and 0.0216 on an H100, the
# control with the ring's result dropped 0.996 and 0.709
TRAIN_DP_RTOL, TRAIN_M_RTOL = 0.6, 0.05
# row chunks of the plain ring versions at the train slab (their f64 and
# int64 temporaries would not fit at once)
GR_PLAIN_CHUNKS = 16
#: Transformer.train_step: Llama-2-7B at full width (f32 parameters,
#: bf16 compute), its depth cut to 8 of its 32 layers (two models' f32
#: parameters, gradients and SGD results at full depth would not fit
#: 80 GB), 2 SGD steps on one batch of 2 × 1024 tokens, tp = 1 and 4
LM_LAYERS, LM_B, LM_S, LM_STEPS, LM_LR = 8, 2, 1024, 2, 1e-2
# tp = 4's loss against tp = 1's at each step: bf16 activations rounded in
# other places (the mesh GEMMs' outputs, the per-rank attention), averaged
# over 2048 tokens' cross-entropy of about 10.4 (read 9.2e-5 apart on an
# H100); and the first layer's weights after the steps: the worst leaf's
# ||w_tp4 - w_tp1|| / ||w_tp1 - w_0||, each gradient summed in bf16 in
# another order (read 0.0092)
LM_TP_ATOL, LM_W_RTOL = 2e-3, 0.03

# every serving step packs 768 rows (token_budget 512 plus the 256-row
# parking zone) for 16 slots
T_PAD, SLOTS = 768, 16
# the MoE main path's step: hidden 2048, 64 experts of ffn 1408, top-6
MOE_T, MOE_H, MOE_F, MOE_E, MOE_K = T_PAD, 2048, 1408, 64, 6

# bf16 expert GEMM against its plain version in f32:
# |out - ref| <= GG_RTOL·|ref| + GG_ATOL·max|ref| (one bf16 rounding of
# the output, and the f32 summation order)
GG_RTOL, GG_ATOL = 2.0 ** -8, 1e-4
#: the world-size-1 GEMMs' second row count: 62.5 tiles of 128 rows, so
#: that the last tile is partial (TMA's zero fill, the epilogue's row guard)
N1_RAGGED_M = 8000


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


def w8a8_form(fn):
    """The form(s) the W8A8 launches of ``fn()`` ran, as {form: n}."""
    from triton_distributed_tpu_torch.kernels import group_gemm as gg

    before = dict(gg._w8a8_cuda.by_variant)
    out = fn()
    forms = {f: c - before.get(f, 0)
             for f, c in gg._w8a8_cuda.by_variant.items()
             if c != before.get(f, 0)}
    return out, forms


def int_mm_lib(xq, wqs, xs, ws):
    """``torch._int_mm`` + the epilogue on (M, K) codes and K-major (K, N)
    weights (column-major: what ``_int_mm`` takes, no copy) as fn(i) on
    weight i % len(wqs), and what it ran; x padded with zero rows to 32
    where ``_int_mm`` refuses M (its CUDA path has asked for more than 16
    rows), and the log says so."""
    import torch

    def call(xp, w):
        acc = torch._int_mm(xp, w)[: xq.shape[0]]
        return (acc.float() * xs * ws).to(torch.bfloat16)

    what = "torch._int_mm + epilogue"
    xp = xq
    try:
        call(xq, wqs[0])
        torch.cuda.synchronize()
    except RuntimeError as e:
        pad = torch.zeros((32 - xq.shape[0], xq.shape[1]), dtype=xq.dtype,
                          device=xq.device)
        xp = torch.cat([xq, pad])
        what = "torch._int_mm on x padded to 32 rows + epilogue"
        log(f"torch._int_mm refused M={xq.shape[0]} "
            f"({str(e).splitlines()[0][:120]}): x padded with zero rows to "
            "32")
    return (lambda i: call(xp, wqs[i % len(wqs)])), what


def weight_copies(w, nbytes: float):
    """``w`` and clones of it (its layout kept), enough that timed calls
    cycling through them read over 100 MB, twice the L2 cache, as a step
    reads a layer's weights cold: at most 8."""
    n = max(1, min(8, math.ceil(100e6 / nbytes)))
    return [w] + [w.clone() for _ in range(n - 1)]


def check_w8a8(res: Results, tag, xq, wq, be, kw, form):
    """One W8A8 shape against its plain version, bit for bit (exact s32
    sums on both sides and the same f32 epilogue), in the form ``form``;
    returns (kernel, plain, library ms, what the library ran): the
    kernel's and the library's (``torch._int_mm`` + the epilogue, one
    expert; else None) device time
    a call from CUDA graphs cycling through copies of the weight
    (:func:`weight_copies`), the plain version's from back-to-back
    calls."""
    import torch

    from triton_distributed_tpu_torch.kernels import group_gemm as gg

    out, forms = w8a8_form(lambda: gg.grouped_matmul(xq, wq, be, **kw))
    ref = gg.grouped_matmul_plain(xq, wq, be, **kw)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    del out, ref
    res.check("ggemm_w8a8", err, 0.0, tag)
    res.check("ggemm_w8a8", 0 if forms == {form: 1} else 1, 0,
              f"{tag}: the {form} form ran ({forms})", metric="forms off")
    res.kernel("ggemm_w8a8", err=err)
    wqs = weight_copies(wq, wq.numel())
    ms = graph_time_ms(
        lambda i: gg.grouped_matmul(xq, wqs[i % len(wqs)], be, **kw))
    plain = time_ms(lambda: gg.grouped_matmul_plain(xq, wq, be, **kw), 3)
    lib, lib_what = None, None
    if be.numel() == 1:
        fn, lib_what = int_mm_lib(xq, [w[0] for w in wqs], kw["x_scale"],
                                  kw["w_scale"])
        lib = graph_time_ms(fn)
    del wqs
    return ms, plain, lib, lib_what


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
        wq, ws = gg.quantize_grouped_weights(w, k_major=True)
        kw = dict(w_scale=ws, x_scale=xs, out_dtype=torch.bfloat16)
        tag = f"{path} {what} M={m} K={k} N={n}"
        ms, plain, lib, lib_what = check_w8a8(res, tag, xq, wq, be, kw,
                                              "tc")
        nbytes = m * k + 4 * m + k * n + 4 * n + 2 * m * n
        ops = 2.0 * m * n * k
        b, by = bound_ms(nbytes, ops, H100_INT8_OPS)
        log(f"time ggemm_w8a8 {tag} ({per_step}/step): kernel_ms={ms:.4f} "
            f"plain_ms={plain:.4f} library_ms={lib:.4f} ({lib_what}) "
            f"bound_ms={b:.4f} ({by})")
        if main:
            res.shape("ggemm_w8a8", per_step, ms, plain, lib, nbytes, ops,
                      H100_INT8_OPS)

    # lm_head: the slots' last rows (serving) and the decode batch's,
    # W8A16 with f32 logits, on the tensor-core kernel's 16-byte form
    for m in (SLOTS, DEC_B):
        k, n = cfg.hidden, cfg.vocab
        x = torch.randn((m, k), generator=g, device=dev, dtype=torch.bfloat16)
        w = torch.randn((1, k, n), generator=g, device=dev,
                        dtype=torch.bfloat16) / math.sqrt(k)
        wq, ws = gg.quantize_grouped_weights(w)
        del w
        kw = dict(w_scale=ws, out_dtype=torch.float32)
        before = dict(gg._w8a16_cuda.by_variant)
        out = gg.grouped_matmul(x, wq, be, **kw)
        forms = {f: c - before.get(f, 0)
                 for f, c in gg._w8a16_cuda.by_variant.items()
                 if c != before.get(f, 0)}
        ref = gg.grouped_matmul_plain(x, wq, be, **kw)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        # f32 sums of exact bf16 x int8 products in another order
        tol = 1e-5 * max(1.0, ref.abs().max().item()) * math.sqrt(k)
        tag = f"{path} lm_head M={m} K={k} N={n}"
        res.check("ggemm_w8a16", err, tol, tag)
        res.check("ggemm_w8a16", 0 if forms == {"tc": 1} else 1, 0,
                  f"{tag}: the tensor-core form ran ({forms})",
                  metric="forms off")
        res.kernel("ggemm_w8a16", err=err)
        ms = time_ms(lambda: gg.grouped_matmul(x, wq, be, **kw), 20)
        plain = time_ms(lambda: gg.grouped_matmul_plain(x, wq, be, **kw), 5)
        wdq = gg.dequantize_grouped_weights(wq, ws, torch.bfloat16)[0]
        lib = time_ms(lambda: torch.matmul(x, wdq), 20)
        del wdq
        nbytes = 2 * m * k + k * n + 4 * n + 4 * m * n
        ops = 2.0 * m * n * k
        b, by = bound_ms(nbytes, ops, H100_BF16_OPS)
        per = 1 if m == SLOTS else 0
        log(f"time ggemm_w8a16 {tag} ({per}/step): kernel_ms={ms:.4f} "
            f"plain_ms={plain:.4f} library_ms={lib:.4f} (torch.matmul, "
            f"dequantized bf16 W) bound_ms={b:.4f} ({by})")
        if main and m == SLOTS:
            res.shape("ggemm_w8a16", 1, ms, plain, lib, nbytes, ops,
                      H100_BF16_OPS)
        del wq, ws


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
        # W8A8 at the same expert shapes (the main path's experts), on
        # K-major weights
        wq, ws = gg.quantize_grouped_weights(w, k_major=True)
        xq, xsc = gg.quantize_act_rows(x)
        kw = dict(w_scale=ws, x_scale=xsc, out_dtype=torch.bfloat16)
        ms, plain, _, _ = check_w8a8(
            res, f"deepseek_moe_16b experts {what} M={cap} K={k} N={n}", xq,
            wq, be, kw, "tc")
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


def decode_w8a8_shapes(cfg):
    """A decode step's W8A8 products at ``DEC_B`` rows: (what, (M, K, N),
    out dtype) of the whole projections (tp = 1) and of one rank's shards
    at tp = ``TP`` (column shards of wqkv and up in bf16, row shards of wo
    and down with f32 partials, as ``Transformer._dmm_tp`` runs them)."""
    import torch

    h, f, q, qkv = cfg.hidden, cfg.ffn, cfg.q_dim, cfg.qkv_dim
    bf16, f32 = torch.bfloat16, torch.float32
    m = DEC_B
    return [("wqkv", (m, h, qkv), bf16), ("wo", (m, q, h), bf16),
            ("up", (m, h, f), bf16), ("down", (m, f, h), bf16),
            (f"wqkv tp{TP} rank", (m, h, qkv // TP), bf16),
            (f"wo tp{TP} rank", (m, q // TP, h), f32),
            (f"up tp{TP} rank", (m, h, f // TP), bf16),
            (f"down tp{TP} rank", (m, f // TP, h), f32)]


def check_decode_gemms(res: Results, dev, cfg):
    """W8A8 at the Llama-2-7B int8 decode's shapes (``DEC_B`` = 8 rows, the
    whole projections and a tp = 4 rank's shards), each on the
    weight-streaming form, bit for bit against its plain version, timed
    beside its bound (the weight's bytes) and ``torch._int_mm``."""
    import torch

    from triton_distributed_tpu_torch.kernels import group_gemm as gg

    kernels, notes = ptxas_report("w8a8_")
    for name, regs, st, ld in kernels:
        log(f"ptxas {name}: {regs} registers, spill stores {st} B, spill "
            f"loads {ld} B")
        res.check("ggemm_w8a8", st + ld, 0, f"ptxas spills of {name}",
                  metric="bytes")
    for note in notes:
        log(f"ptxas note: {note}")
    g = torch.Generator(device=dev).manual_seed(17)
    be = torch.zeros((1,), dtype=torch.int32, device=dev)
    for what, (m, k, n), odt in decode_w8a8_shapes(cfg):
        x = torch.randn((m, k), generator=g, device=dev, dtype=torch.bfloat16)
        w = torch.randn((1, k, n), generator=g, device=dev,
                        dtype=torch.bfloat16) / math.sqrt(k)
        xq, xs = gg.quantize_act_rows(x)
        wq, ws = gg.quantize_grouped_weights(w, k_major=True)
        del w
        kw = dict(w_scale=ws, x_scale=xs, out_dtype=odt)
        tag = f"llama_7b decode {what} M={m} K={k} N={n}"
        ms, plain, lib, lib_what = check_w8a8(res, tag, xq, wq, be, kw,
                                              "stream")
        nbytes = m * k + 4 * m + k * n + 4 * n + odt.itemsize * m * n
        b, by = bound_ms(nbytes, 2.0 * m * n * k, H100_INT8_OPS)
        log(f"time ggemm_w8a8 {tag}: kernel_ms={ms:.4f} plain_ms="
            f"{plain:.4f} library_ms={lib:.4f} ({lib_what}) bound_ms={b:.4f}"
            f" ({by}) kernel/bound={ms / b:.2f}")
        del wq, ws


def check_w8a8_threshold(res: Results, dev):
    """Where the W8A8 forms hand over: both forms (``_w8a8_cuda``'s
    ``form``) at block rows 8 to 64 of Llama-2-7B's wqkv and wo (K 4096,
    N 12288 / 4096), each bit for bit against the plain version, timed
    from CUDA graphs over copies of the weight; the kernel's threshold
    (blocks of up to ``W8_STREAM_ROWS`` = 16 rows stream) is where the
    stream form stops being the faster."""
    import torch

    from triton_distributed_tpu_torch.kernels import group_gemm as gg

    g = torch.Generator(device=dev).manual_seed(19)
    be = torch.zeros((1,), dtype=torch.int32, device=dev)
    for k, n in ((4096, 12288), (4096, 4096)):
        w = torch.randn((1, k, n), generator=g, device=dev,
                        dtype=torch.bfloat16) / math.sqrt(k)
        wq, ws = gg.quantize_grouped_weights(w, k_major=True)
        del w
        wqs = weight_copies(wq, wq.numel())
        for m in (8, 16, 24, 32, 64):
            x = torch.randn((m, k), generator=g, device=dev,
                            dtype=torch.bfloat16)
            xq, xs = gg.quantize_act_rows(x)
            ref = gg.grouped_matmul_plain(xq, wq, be, w_scale=ws,
                                          x_scale=xs)
            ms = {}
            for form in ("tc", "stream"):
                def call(i, form=form):
                    return gg._w8a8_cuda(xq, wqs[i % len(wqs)], be, ws, xs,
                                         torch.bfloat16, m, k, n, m,
                                         form=form)
                err = (call(0).float() - ref.float()).abs().max().item()
                res.check("ggemm_w8a8", err, 0.0,
                          f"threshold {form} M={m} K={k} N={n}")
                ms[form] = graph_time_ms(call)
            log(f"threshold ggemm_w8a8 M={m} K={k} N={n}: tc_ms="
                f"{ms['tc']:.4f} stream_ms={ms['stream']:.4f} faster="
                f"{min(ms, key=ms.get)}")
        del wqs, wq, ws


def tally_forms(wrapper):
    """Tally the launches of the whole run of ``wrapper`` (a grouped-GEMM
    wrapper: ``_w8a16_cuda`` or ``_w8a8_cuda``) by the form each ran (its
    ``by_variant``): every path clears the wrapper's counts with
    ``reset_launch_counts``, which from here on first adds them to the
    tally. Returns a function that gives the tally so far."""
    from triton_distributed_tpu_torch import kernels

    seen = {}
    reset = kernels.reset_launch_counts

    def add():
        for form, c in wrapper.by_variant.items():
            seen[form] = seen.get(form, 0) + c
        wrapper.by_variant.clear()

    def reset_and_tally():
        add()
        reset()

    kernels.reset_launch_counts = reset_and_tally

    def tally():
        add()
        return dict(seen)

    return tally


def device_ops(fn):
    """The device operations (kernels, copies) one ``fn()`` call runs, as
    torch.profiler sees them: [(name, launches)]."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(key, n) for _, key, n in device_rows(prof)[1]]


def router_device_ops():
    """The device operations of one ``Transformer._router_logits`` call
    on bf16 x and the f32 router at the serving step's and the decode
    step's rows, DeepSeek-MoE-16B's widths, as torch.profiler sees them:
    {rows: [(name, launches)]}. Run by :func:`check_router_ops` in a
    process of its own."""
    import torch

    from triton_distributed_tpu_torch.models import Transformer, presets

    cfg = presets.deepseek_moe_16b()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(6)
    r = torch.randn((cfg.hidden, cfg.num_experts), generator=g, device=dev)
    out = {}
    for m in (T_PAD, DEC_B):
        x = torch.randn((m, cfg.hidden), generator=g, device=dev).to(
            torch.bfloat16)
        Transformer._router_logits(x, r)
        out[m] = device_ops(lambda: Transformer._router_logits(x, r))
    return out


ROUTER_OPS_CHILD = r"""
import json
import chip_smoke as cs
print("OPS " + json.dumps(cs.router_device_ops()), flush=True)
"""


def check_router_ops(res: Results):
    """``Transformer._router_logits`` on bf16 x and the f32 router runs
    one device operation a call, the narrow f32 kernel (no cast), at the
    serving step's and the decode step's rows: counted by torch.profiler
    in a fresh process (:func:`router_device_ops`), whose first profiler
    session neither slows this process's host work nor meets its earlier
    ones."""
    here = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run([sys.executable, "-c", ROUTER_OPS_CHILD], cwd=here,
                         capture_output=True, text=True, timeout=600)
    line = next((x for x in out.stdout.splitlines() if x.startswith("OPS ")),
                None)
    if out.returncode or line is None:
        res.failures.append(f"router ops: the child failed (rc "
                            f"{out.returncode}): {out.stderr[-2000:]}")
        return
    for m, ops in json.loads(line[4:]).items():
        tag = f"deepseek_moe_16b router M={m} bf16 x, f32 router"
        log(f"device ops {tag}: {ops}")
        res.check("ggemm_f32", abs(sum(c for _, c in ops) - 1), 0,
                  f"{tag}: one device operation a call (profiler)",
                  metric="ops off")
        if not any("narrow_f32_kernel" in name for name, _ in ops):
            res.failures.append(f"{tag}: the narrow f32 kernel did not run "
                                f"({ops})")


def check_router(res: Results, dev, cfg):
    """The EP block's router at the main path's shape, ``(T_PAD, H) @
    (H, E)`` on bf16 x and the f32 router (the main path's operands)
    through ``Transformer._router_logits``, the call the main path makes:
    one counted launch of the float mode's narrow f32 kernel a call
    (:func:`check_router_ops` counts its device operations at the end of
    the run), against the f32 product. Within 1e-5 of the largest logit:
    2048-term f32 sums in another order. Also at the decode paths' 8 rows
    (timed, not a row of the kernels line)."""
    import torch

    from triton_distributed_tpu_torch.kernels import group_gemm as gg
    from triton_distributed_tpu_torch.kernels import launch_counts
    from triton_distributed_tpu_torch.models import Transformer

    k, n = cfg.hidden, cfg.num_experts
    g = torch.Generator(device=dev).manual_seed(5)
    r = torch.randn((k, n), generator=g, device=dev)
    be = torch.zeros((1,), dtype=torch.int32, device=dev)
    n_moe = len(cfg.moe_layers)
    for m in (T_PAD, DEC_B):
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        before = launch_counts()["ggemm_f32"]
        out = Transformer._router_logits(x, r)
        launched = launch_counts()["ggemm_f32"] - before
        xf = x.float()
        ref = xf @ r
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        tag = f"deepseek_moe_16b router M={m} K={k} N={n} bf16 x, f32 router"
        res.check("ggemm_f32", err, 1e-5 * ref.abs().max().item(), tag)
        res.check("ggemm_f32", abs(launched - 1), 0,
                  f"{tag}: one counted launch a call", metric="launches off")
        res.kernel("ggemm_f32", err=err)
        # a 3 MB operand sits in L2: the timed calls cycle through 12
        # copies of x
        xs = [x] + [torch.randn((m, k), generator=g, device=dev)
                    .to(torch.bfloat16) for _ in range(11)]
        xfs = [t.float() for t in xs]
        ms = graph_time_ms(lambda i: Transformer._router_logits(xs[i % 12], r))
        plain = time_ms(lambda: gg.grouped_matmul_plain(xf, r[None], be), 20)
        lib = graph_time_ms(lambda i: xfs[i % 12] @ r)
        call_lib = graph_time_ms(lambda i: xs[i % 12].float() @ r)
        del xs, xfs
        nbytes = 2 * m * k + 4 * k * n + 4 * m * n
        ops_n = 2.0 * m * k * n
        b, by = bound_ms(nbytes, ops_n, H100_F32_OPS)
        per = n_moe if m == T_PAD else 0
        log(f"time ggemm_f32 {tag} ({per}/step): kernel_ms={ms:.4f} "
            f"plain_ms={plain:.4f} library_ms={lib:.4f} (cuBLAS f32 matmul "
            f"on x.float()) bound_ms={b:.4f} ({by}); x.float() @ r with "
            f"the cast {call_lib:.4f} ms")
        if m == T_PAD:
            res.shape("ggemm_f32", n_moe, ms, plain, lib, nbytes, ops_n,
                      H100_F32_OPS)


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
                         "ragged_paged_attention", "ggemm_f32",
                         "chunked_a2a"),
    "deepseek_moe_16b_bf16_experts": ("ggemm_w8a8", "ggemm_w8a16",
                                      "ragged_paged_attention", "ggemm_bf16",
                                      "chunked_a2a"),
    "deepseek_moe_16b disagg": ("ggemm_w8a8", "ggemm_w8a16",
                                "ragged_paged_attention", "ggemm_f32",
                                "chunked_a2a", "kv_ship"),
}


def run_path(res: Results, dev, name, cfg, profile=False, keep=False):
    """One serving path at full width: the engine serves the seeded
    Poisson trace (16 requests, prompts 128–1023 tokens) from random
    weights drawn in bf16 and quantized on the card; the launches of
    every kernel are counted over the run. Returns the launches and the
    number of engine steps, and with ``keep`` also (model, params, the
    served trace) for the disaggregated path."""
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
    if keep:
        return counts, steps, (model, params, trace)
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
    """The ten kernels with the most device time, and every other
    kernel of the port (``csrc``'s, in its anonymous namespace)."""
    for i, (us, key, n) in enumerate(rows):
        if i >= 10 and "(anonymous namespace)::" not in key:
            continue
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
    through ``gemm_rs``, 32 launches a prefill each, timed; then each
    again at :data:`N1_RAGGED_M` rows (a partial last 128-row tile),
    against the plain version only; every launch must run the warpgroup
    GEMM (``wgmma``)."""
    import torch

    from triton_distributed_tpu_torch.kernels import ag_gemm as agm
    from triton_distributed_tpu_torch.kernels import gemm_rs as grs

    clear_wg_forms("ag_gemm_n1", "gemm_rs_n1")
    m, h, f, qkv = DEC_B * DEC_PROMPT, 4096, 11008, 3 * 4096
    g = torch.Generator(device=dev).manual_seed(6)
    shapes = (("ag_gemm_n1", "wqkv", h, qkv, agm.ag_gemm, agm.ag_gemm_plain),
              ("ag_gemm_n1", "up", h, f, agm.ag_gemm, agm.ag_gemm_plain),
              ("gemm_rs_n1", "wo", h, h, grs.gemm_rs, grs.gemm_rs_plain),
              ("gemm_rs_n1", "down", f, h, grs.gemm_rs, grs.gemm_rs_plain))
    for (name, what, k, n, fn, plain), rows in itertools.product(
            shapes, (m, N1_RAGGED_M)):
        a = torch.randn((rows, k), generator=g, device=dev,
                        dtype=torch.bfloat16)
        b = torch.randn((k, n), generator=g, device=dev,
                        dtype=torch.bfloat16) / math.sqrt(k)
        out = fn(a, b)
        ref = plain(a, b, out_dtype=torch.float32)
        torch.cuda.synchronize()
        diff = (out.float() - ref).abs()
        scale = ref.abs().max().item()
        excess = (diff - GG_RTOL * ref.abs()).max().item()
        tag = f"llama_7b prefill {what} M={rows} K={k} N={n}"
        res.check(name, excess, GG_ATOL * scale, tag,
                  metric="max(|err|-2^-8|ref|)")
        err = diff.max().item()
        res.kernel(name, err=err)
        if rows != m:
            del a, b, out, ref, diff
            continue
        ms = time_ms(lambda: fn(a, b), 10)
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
    check_all_wgmma(res, "llama_7b prefill world size 1",
                    ("ag_gemm_n1", "gemm_rs_n1"))


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
    timed, two runs bit-identical, and in f32 and bf16 at 1024 tokens with
    an empty expert; every bf16 launch on the grouped warpgroup GEMM
    (``wgmma``), every f32 one on the FMA loop."""
    import torch
    import torch.nn.functional as F

    from triton_distributed_tpu_torch.kernels import moe_tp_fused as mtf

    cases = (("bf16 prefill", DEC_B * DEC_PROMPT, torch.bfloat16, None),
             ("f32 expert 5 empty", 1024, torch.float32, 5),
             ("bf16 expert 5 empty", 1024, torch.bfloat16, 5))
    for what, m, dt, empty in cases:
        clear_wg_forms(*MOE_TP_ROWS)
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
            if not torch.equal(fn(), out):
                res.failures.append(f"{name} {tag}: two runs differ")
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
        check_all_wgmma(res, f"deepseek_moe_16b moe_tp {what}", MOE_TP_ROWS,
                        "wgmma" if dt == torch.bfloat16 else "fma")


def check_mesh_kernels(res: Results, dev):
    """The tensor-parallel kernels over a loopback mesh of 4 ranks at the
    Llama-2-7B tp = 4 path's shapes, against their plain versions: the
    AG-GEMM (A 4 x (2048, 4096) bf16 row shards, B_r (4096, 3072) for
    wqkv and (4096, 2752) for up) and GEMM-RS (A_q (8192, 1024) for wo
    and (8192, 2752) for down, B_q (K_q, 4096)), 32 launches a prefill
    each shape, timed; up and down again at the CP prefill's 2016 rows a
    rank (a partial last 128-row tile in every shard), against the plain
    versions only; every launch on the warpgroup GEMM (``wgmma``);
    and the all-gather of the decode's partials ((8, 32, 128) bf16 out
    and (8, 32) f32 lse a rank, 32 launches a step each), byte-exact,
    timed from a CUDA graph."""
    import torch

    from triton_distributed_tpu_torch.kernels import ag_gemm as agm
    from triton_distributed_tpu_torch.kernels import allgather as agk
    from triton_distributed_tpu_torch.kernels import gemm_rs as grs
    from triton_distributed_tpu_torch.runtime import Mesh

    mesh = Mesh.loopback(TP, dev)
    m, h, f = DEC_B * DEC_PROMPT, 4096, 11008
    g = torch.Generator(device=dev).manual_seed(12)
    clear_wg_forms("ag_gemm", "gemm_rs")

    def shards(shape, scale=1.0):
        t = torch.randn((TP, *shape), generator=g, device=dev,
                        dtype=torch.bfloat16) * scale
        return list(t.unbind(0))

    cp = CP_B * CP_S  # the CP prefill's rows, 2016 a rank
    cases = (("ag_gemm", "wqkv", m, h, 3 * h // TP),
             ("ag_gemm", "up", m, h, f // TP),
             ("gemm_rs", "wo", m, h // TP, h),
             ("gemm_rs", "down", m, f // TP, h),
             ("ag_gemm", "cp up", cp, h, f // TP),
             ("gemm_rs", "cp down", cp, f // TP, h))
    for name, what, rows, k, n in cases:
        if name == "ag_gemm":
            a, b = shards((rows // TP, k)), shards((k, n), k ** -0.5)
            fn, plain = agm.ag_gemm, agm.ag_gemm_plain
            # the same products for every rank at once
            a_cat, b_cat = torch.cat(a), torch.cat(b, dim=1)
            out_elems, kk = TP * rows * n, k
        else:
            a, b = shards((rows, k)), shards((k, n), (TP * k) ** -0.5)
            fn, plain = grs.gemm_rs, grs.gemm_rs_plain
            a_cat, b_cat = torch.cat(a, dim=1), torch.cat(b)
            out_elems, kk = rows * n, TP * k
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
        if rows != m:
            del a, b, a_cat, b_cat, out
            continue
        ms = time_ms(lambda: fn(a, b, mesh), 10)
        plain_ms = time_ms(lambda: plain(a, b, mesh), 2)
        lib = time_ms(lambda: torch.matmul(a_cat, b_cat), 5)
        # bytes: every rank's A and B read once, every output written
        # once; operations: all ranks' products
        nbytes = 2 * (a_cat.numel() + b_cat.numel() + out_elems)
        ops = 2.0 * rows * kk * (TP * n if name == "ag_gemm" else n)
        bnd, by = bound_ms(nbytes, ops, H100_BF16_OPS)
        log(f"time {name} {tag} (32/prefill, one launch for {TP} ranks): "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms="
            f"{lib:.4f} (torch.matmul on the concatenated operands) "
            f"bound_ms={bnd:.4f} ({by}) max_abs_err={err:.6g}")
        res.shape(name, 32, ms, plain_ms, lib, nbytes, ops, H100_BF16_OPS)
        del a, b, a_cat, b_cat, out
    check_all_wgmma(res, f"llama_7b tp={TP} prefill mesh GEMMs",
                    ("ag_gemm", "gemm_rs"))

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


def wire_operands(dev, g, shape, scale=1.0, outlier=False):
    """TP per-rank bf16 shards of ``shape`` from the generator ``g``;
    with ``outlier``, row 1 of every shard x1000, the per-chunk scale's
    worst case (tests/test_wire.py:277-299)."""
    import torch

    t = torch.randn((TP, *shape), generator=g, device=dev,
                    dtype=torch.bfloat16) * scale
    if outlier:
        t[:, 1] *= 1000.0
    return list(t.unbind(0))


def _row_excess(out, ref):
    """The bf16 GEMM excess check with its absolute term taken per row:
    (the largest ``max(|out - ref| - 2^-8·|ref|)`` of a row over that
    row's largest ``|ref|``, which must stay within GG_ATOL; max |out -
    ref|), so that the x1000 outlier row does not loosen the others'
    limit. A row of zeros must come out exact."""
    over, err = float("-inf"), 0.0
    for o, r in zip(out, ref):
        diff = (o.float() - r).abs()
        err = max(err, diff.max().item())
        excess = (diff - GG_RTOL * r.abs()).amax(1)
        over = max(over, (excess / r.abs().amax(1).clamp_min(1e-30))
                   .max().item())
    return over, err


def ptxas_report(name: str):
    """What ptxas printed for the kernels whose (mangled) name holds
    ``name`` in the current build (``_build.build_log``): one (kernel,
    registers, spill store bytes, spill load bytes) a kernel, and
    ptxas's lines about them that say "serialized" (a ``wgmma`` pipeline
    it could not keep asynchronous)."""
    import re

    from triton_distributed_tpu_torch.kernels import _build

    rows, notes, cur = [], [], None
    for line in _build.build_log().splitlines():
        hit = re.search(r"Compiling entry function '([^']+)'", line)
        if hit:
            cur = hit.group(1) if name in hit.group(1) else None
            if cur:
                rows.append([cur, None, 0, 0])
            continue
        if name in line and "serialized" in line:
            notes.append(line.strip())
        if cur is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if spill:
            rows[-1][2:] = [int(spill.group(1)), int(spill.group(2))]
        used = re.search(r"Used (\d+) registers", line)
        if used:
            rows[-1][1] = int(used.group(1))
    return [tuple(r) for r in rows], notes


def check_ptxas(res: Results, kernel: str, tag: str):
    """Log ptxas's registers and spills for every kernel whose name holds
    ``kernel`` in the current build, and fail the run on a spill."""
    kernels, notes = ptxas_report(kernel)
    for name, regs, st, ld in kernels:
        log(f"ptxas {name}: {regs} registers, spill stores {st} B, spill "
            f"loads {ld} B")
        res.check(kernel, st + ld, 0, f"{tag} ptxas spills of {name}",
                  metric="bytes")
    for note in notes:
        log(f"ptxas note: {note}")
    if not kernels:
        log(f"ptxas: the build log names no {kernel} (built without "
            "-Xptxas=-v)")


def _wg_entries() -> dict:
    """The wrappers of the entries on the warpgroup GEMM's routes, by
    their counter's name: the two wires, the two mesh GEMMs, the two
    world-size-1 GEMMs, the MoE-TP wire's two grouped GEMMs and the bf16
    MoE-TP pair over the mesh and at world size 1."""
    from triton_distributed_tpu_torch.kernels import ag_gemm as agm
    from triton_distributed_tpu_torch.kernels import gemm_rs as grs

    from triton_distributed_tpu_torch.kernels import moe_tp_fused as mtf

    return {"ag_gemm_wire": agm.ag_gemm_w_launch,
            "gemm_rs_wire": grs.gemm_rs_partials,
            "ag_gemm": agm._ag_gemm_mesh_cuda,
            "gemm_rs": grs._gemm_rs_mesh_cuda,
            "ag_gemm_n1": agm._ag_gemm_cuda,
            "gemm_rs_n1": grs._gemm_rs_cuda,
            "ag_group_gemm_wire": mtf._ag_group_gemm_w_cuda,
            "moe_reduce_rs_wire": mtf._moe_reduce_rs_partials_cuda,
            "ag_group_gemm": mtf._ag_group_gemm_cuda,
            "moe_reduce_rs": mtf._moe_reduce_rs_cuda,
            "ag_group_gemm_mesh": mtf._ag_group_gemm_mesh_cuda,
            "moe_reduce_rs_mesh": mtf._moe_reduce_rs_mesh_cuda}


def wg_forms():
    """The launches of the entries on the warpgroup GEMM's routes by the
    form each ran (``by_variant``), as {entry: {form: n}}."""
    return {e: dict(fn.by_variant) for e, fn in _wg_entries().items()}


def clear_wg_forms(*entries):
    """Clear the form tallies of ``entries``."""
    for e in entries:
        _wg_entries()[e].by_variant.clear()


def check_wg_forms(res: Results, what, want: dict, form="wgmma"):
    """Fail unless every launch of the entries of ``want`` since their
    tallies were cleared ran ``form``, ``want[entry]`` times."""
    forms = wg_forms()
    log(f"forms {what}: " + " ".join(f"{k}={forms[k]}" for k in want))
    for entry, n in want.items():
        if forms[entry] != {form: n}:
            res.failures.append(f"{what}: {entry} launches by form "
                                f"{forms[entry]}, expected {n} on {form}")


def form_of(fn, before):
    """The form of the one launch of ``fn`` since its tally was
    ``before``."""
    return ",".join(k for k, v in fn.by_variant.items()
                    if v != before.get(k, 0))


def check_all_wgmma(res: Results, what, entries, form="wgmma"):
    """Fail unless ``entries`` launched since their tallies were cleared,
    and every launch ran ``form`` (the ``wgmma`` form by default)."""
    forms = wg_forms()
    check_wg_forms(res, what, {e: max(1, sum(forms[e].values()))
                               for e in entries}, form)


def check_wire_kernels(res: Results, dev):
    """The quantized-wire kernels over a loopback mesh of 4 ranks at the
    wire path's shapes (Llama-2-7B's widths, 4 x 2048 rows, an outlier
    row a shard), each alone against its plain version on the same
    inputs, timed: the wire quantizer (codes and scales byte-exact,
    chunks of 64 rows, of JAX's fused row block (int8-mxu) and of one);
    the AG-GEMM on fp8 / int8 (the bf16
    GEMM's excess check, per row: the plain version dequantizes the same
    codes) and int8-mxu (bit-exact: s32 sums) for wqkv and up; the
    GEMM-RS wire's partials for wo and down (the bf16 GEMM's excess
    check, per row) and its fold on fp8 / int8 (bit-exact against the
    plain fold of the kernel's own partials, as is the whole wire); the
    all-gather on fp8 (byte-exact). Each row weighs its shapes by their
    launches in the wire path's run; a wrapper's whole call (the
    quantizer included, and for int8-mxu the per-column quantization of
    B in torch ops) is logged as call_ms beside its kernel's time. The
    fp8 / int8 AG-GEMM and the partials run the warpgroup GEMM
    (``csrc/wg_gemm.cuh``): each checked launch logs its form, every
    launch of the phase must be ``wgmma``, and ptxas's registers and
    spills for that kernel are logged (a spill fails the run)."""
    import torch

    from triton_distributed_tpu_torch.kernels import ag_gemm as agm
    from triton_distributed_tpu_torch.kernels import allgather as agk
    from triton_distributed_tpu_torch.kernels import gemm_rs as grs
    from triton_distributed_tpu_torch.kernels import wire as wk
    from triton_distributed_tpu_torch.lang import wire as tw
    from triton_distributed_tpu_torch.runtime import AllGatherMethod, Mesh

    mesh = Mesh.loopback(TP, dev)
    m, h, f = DEC_B * DEC_PROMPT // TP, 4096, 11008
    bf16 = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(13)
    x = wire_operands(dev, g, (m, h), outlier=True)
    tag0 = f"llama_7b tp={TP} wire"
    check_ptxas(res, "wg_gemm_kernel", tag0)
    agm.ag_gemm_w_launch.by_variant.clear()
    grs.gemm_rs_partials.by_variant.clear()

    # the quantizer: the AG-GEMMs' chunks (fp8 and int8 at 64 rows, and
    # int8-mxu at JAX's fused row block, 512 rows here; 64 launches a
    # pass each) and the all-gather's rows (fp8, once a wire)
    mx_cr = agm.pick_mm_blocks(m, h, 3 * h // TP, 2)[0]
    wired = {}
    for wire, cr, per_run in (("fp8", 64, 64), ("int8", 64, 64),
                              ("int8", mx_cr, 64), ("fp8", 1, len(WIRES))):
        fmt = tw.WireFormat(wire, cr)
        q, sc = wk.quantize_shards(x, fmt)
        torch.cuda.synchronize()
        exact = all(torch.equal(q[r].view(torch.uint8),
                                want[0].view(torch.uint8))
                    and torch.equal(sc[r], want[1])
                    for r, want in enumerate(tw.quantize_slab(xr, fmt)
                                             for xr in x))
        what = f"{tag0} quantize {wire} chunk_rows={cr} {TP} x {(m, h)} bf16"
        res.check("wire_quantize", 0.0 if exact else 1.0, 0.0, what,
                  metric="bytes differ")
        res.kernel("wire_quantize", err=0.0)
        ms = time_ms(lambda: wk.quantize_shards(x, fmt), 10)
        plain_ms = time_ms(lambda: [tw.quantize_slab(xr, fmt) for xr in x],
                           2)
        # bytes: every shard read once, its codes and scales written once
        nbytes = TP * m * h * 3 + 4 * TP * m // cr
        bnd, by = bound_ms(nbytes, 0.0, H100_BF16_OPS)
        log(f"time wire_quantize {what} ({per_run}/run, one launch for "
            f"{TP} ranks): kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms=None (no one PyTorch call) bound_ms={bnd:.4f} "
            f"({by})")
        res.shape("wire_quantize", per_run, ms, plain_ms, None, nbytes, 0.0,
                  H100_BF16_OPS)
        wired[(wire, cr)] = (fmt, q, sc)

    # the AG-GEMMs: wqkv and up, 32 launches each in a pass over the
    # layers; fp8 and int8 one pass each (ag_gemm_wire), int8-mxu one
    for what, n in (("wqkv", 3 * h // TP), ("up", f // TP)):
        b = wire_operands(dev, g, (h, n), h ** -0.5)
        b_cat = torch.cat(b, dim=1)
        ops = 2.0 * TP * m * h * TP * n
        for wire in ("fp8", "int8", "int8-mxu"):
            mx = wire == "int8-mxu"
            name = "ag_gemm_mx" if mx else "ag_gemm_wire"
            plan = agm.resolve_ag_gemm_plan(mesh, "tp", x, b,
                                            wire_dtype=wire)
            fmt, q, sc = wired[(tw.wire_payload(wire), plan.chunk_rows)]
            pairs = list(zip(q, sc))
            tag = (f"{tag0} {wire} {what} A {TP} x {(m, h)} B {TP} x "
                   f"{(h, n)}")
            call_ms = time_ms(lambda: agm.ag_gemm(x, b, mesh,
                                                  wire_dtype=wire), 3)
            if mx:
                bqt, bs = agm.quantize_cols_shards(b)
                cols = [tw.quantize_cols(br) for br in b]
                out = agm.ag_gemm_mx_launch(q, sc, bqt, bs, mesh,
                                            fmt.chunk_rows, bf16)
                ref = agm.ag_gemm_wired_plain(x, pairs, cols, fmt, bf16,
                                              mx=True)
                torch.cuda.synchronize()
                err = max((o.float() - r.float()).abs().max().item()
                          for o, r in zip(out, ref))
                res.check(name, err, 0.0, tag + " (bit-exact: s32 sums)")
                ms = time_ms(lambda: agm.ag_gemm_mx_launch(
                    q, sc, bqt, bs, mesh, fmt.chunk_rows, bf16), 3)
                plain_ms = time_ms(lambda: agm.ag_gemm_wired_plain(
                    x, pairs, cols, fmt, bf16, mx=True), 1)
                cols_ms = time_ms(lambda: agm.quantize_cols_shards(b), 3)
                codes = q.reshape(-1, h)
                rs = sc.repeat_interleave(fmt.chunk_rows, 1).reshape(-1, 1)
                # every rank's columns, column-major for _int_mm
                bcol = bqt.reshape(-1, h).t()
                bsc = bs.reshape(1, -1)
                lib = time_ms(lambda: (torch._int_mm(codes, bcol).float()
                                       * rs * bsc).to(bf16), 3)
                libwhat = "torch._int_mm + epilogue, all ranks' columns"
                # every slab's codes and scales, B's codes and scales
                # read once, every output written once
                nbytes = (TP * m * h + 4 * TP * m // fmt.chunk_rows
                          + h * TP * n + 4 * TP * n + 2 * TP * TP * m * n)
                peak = H100_INT8_OPS
                extra = (f" (B's per-column quantization in torch ops "
                         f"{cols_ms:.4f} ms of it)")
                del cols, codes, rs, bcol, bqt, bs
            else:
                before = dict(agm.ag_gemm_w_launch.by_variant)
                out = agm.ag_gemm_w_launch(x, q, sc, b, mesh, fmt, bf16)
                ref = agm.ag_gemm_wired_plain(x, pairs, b, fmt,
                                              torch.float32)
                torch.cuda.synchronize()
                over, err = _row_excess(out, ref)
                res.check(name, over, GG_ATOL, tag + " form=" + form_of(
                    agm.ag_gemm_w_launch, before), metric="max over rows "
                    "of max(|err|-2^-8|ref|)/rowmax|ref|")
                ms = time_ms(lambda: agm.ag_gemm_w_launch(
                    x, q, sc, b, mesh, fmt, bf16), 3)
                plain_ms = time_ms(lambda: agm.ag_gemm_wired_plain(
                    x, pairs, b, fmt, bf16), 1)
                a_deq = torch.cat([tw.dequantize_slab(qr, sr, fmt, bf16)
                                   for qr, sr in pairs])
                lib = time_ms(lambda: torch.matmul(a_deq, b_cat), 3)
                libwhat = ("torch.matmul on the dequantized gathered A, all "
                           "ranks' columns")
                # the own shards and every slab's codes and scales, B
                # read once, every output written once
                nbytes = (2 * TP * m * h + TP * m * h + 4 * TP * m // 64
                          + 2 * h * TP * n + 2 * TP * TP * m * n)
                peak = H100_BF16_OPS
                extra = ""
                del a_deq
            res.kernel(name, err=err)
            bnd, by = bound_ms(nbytes, ops, peak)
            log(f"time {name} {tag} (32/pass, one launch for {TP} ranks): "
                f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms="
                f"{lib:.4f} ({libwhat}) bound_ms={bnd:.4f} ({by}) "
                f"max_abs_err={err:.6g}; call_ms={call_ms:.4f} (the "
                f"wrapper: quantizer + kernel{extra})")
            res.shape(name, 32, ms, plain_ms, lib, nbytes, ops, peak)
            del out, ref
        del b, b_cat

    # the GEMM-RS wire: wo and down, 32 calls each a pass, on fp8, int8
    # and int8-mxu (its int8 payload); each call runs the partials, then
    # the fold
    for what, k in (("wo", h // TP), ("down", f // TP)):
        a = wire_operands(dev, g, (TP * m, k), outlier=True)
        b = wire_operands(dev, g, (k, h), (TP * k) ** -0.5)
        a_st, b_st = torch.stack(a), torch.stack(b)
        tag = f"{tag0} {what} A_q {TP} x {(TP * m, k)} B_q {TP} x {(k, h)}"
        before = dict(grs.gemm_rs_partials.by_variant)
        parts = grs.gemm_rs_partials(a, b, mesh, bf16)
        ref = [aq.float() @ bq.float() for aq, bq in zip(a, b)]
        torch.cuda.synchronize()
        over, err = _row_excess(parts, ref)
        del ref
        res.check("gemm_rs_wire", over, GG_ATOL, tag + " partials form="
                  + form_of(grs.gemm_rs_partials, before),
                  metric="max over rows of max(|err|-2^-8|ref|)/"
                  "rowmax|ref|")
        res.kernel("gemm_rs_wire", err=err)
        ms = time_ms(lambda: grs.gemm_rs_partials(a, b, mesh, bf16), 3)
        plain_ms = time_ms(lambda: [(aq.float() @ bq.float()).to(bf16)
                                    for aq, bq in zip(a, b)], 1)
        lib = time_ms(lambda: torch.bmm(a_st, b_st), 3)
        ops = 2.0 * TP * m * TP * k * h
        nbytes = 2 * (TP * TP * m * k + TP * k * h + TP * TP * m * h)
        bnd, by = bound_ms(nbytes, ops, H100_BF16_OPS)
        log(f"time gemm_rs_wire {tag} partials (32/pass, 3 passes, one "
            f"launch for {TP} ranks): kernel_ms={ms:.4f} plain_ms="
            f"{plain_ms:.4f} library_ms={lib:.4f} (torch.bmm of every "
            f"rank's A_q @ B_q) bound_ms={bnd:.4f} ({by}) "
            f"max_abs_err={err:.6g}")
        res.shape("gemm_rs_wire", 3 * 32, ms, plain_ms, lib, nbytes, ops,
                  H100_BF16_OPS)
        for wire, passes in (("fp8", 1), ("int8", 2)):
            fmt = tw.make_wire_format(wire, m)
            folded = grs.gemm_rs_fold(parts, mesh, fmt, bf16)
            whole = grs.gemm_rs(a, b, mesh, wire_dtype=wire)
            want = grs.gemm_rs_fold_plain(parts, fmt, bf16)
            torch.cuda.synchronize()
            for got, part in ((folded, "fold"),
                               (whole, "whole wire (partials + fold)")):
                same = all(torch.equal(o, r) for o, r in zip(got, want))
                res.check("gemm_rs_fold", 0.0 if same else 1.0, 0.0,
                          f"{tag} {wire} {part} = the plain fold of the "
                          "kernel's partials", metric="bytes differ")
            res.kernel("gemm_rs_fold", err=0.0)
            del folded, whole, want
            ms = time_ms(lambda: grs.gemm_rs_fold(parts, mesh, fmt, bf16), 5)
            plain_ms = time_ms(lambda: grs.gemm_rs_fold_plain(parts, fmt,
                                                              bf16), 1)
            call_ms = time_ms(lambda: grs.gemm_rs(a, b, mesh,
                                                  wire_dtype=wire), 3)
            # every partial read once, every output written once
            nbytes = 2 * (TP * TP * m * h + TP * m * h)
            bnd, by = bound_ms(nbytes, 0.0, H100_BF16_OPS)
            log(f"time gemm_rs_fold {tag} {wire} (32/pass, {passes} "
                f"pass(es), one launch for {TP} ranks): kernel_ms={ms:.4f} "
                f"plain_ms={plain_ms:.4f} library_ms=None (no one PyTorch "
                f"call) bound_ms={bnd:.4f} ({by}); call_ms={call_ms:.4f} "
                "(the wrapper: partials + fold)")
            res.shape("gemm_rs_fold", 32 * passes, ms, plain_ms, None,
                      nbytes, 0.0, H100_BF16_OPS)
        del a, b, a_st, b_st, parts

    # the all-gather of the last MLP output on 'auto' over the ring
    # (16 MiB a shard: fp8), once a wire's pass
    fmt, q, sc = wired[("fp8", 1)]
    pairs = list(zip(q, sc))
    got = agk.all_gather_w_launch(x, q, sc, mesh, fmt)
    whole = agk.all_gather(x, mesh, method=AllGatherMethod.RING_1D,
                           wire_dtype="auto")
    want = agk.all_gather_wired_plain(x, pairs, fmt)
    torch.cuda.synchronize()
    tag = f"{tag0} all_gather fp8 {TP} x {(m, h)} bf16"
    for out, part in ((got, "kernel"), (whole, "'auto' on the ring")):
        exact = all(torch.equal(o, r) for o, r in zip(out, want))
        res.check("all_gather_wire", 0.0 if exact else 1.0, 0.0,
                  f"{tag} {part}", metric="bytes differ")
    res.kernel("all_gather_wire", err=0.0)
    del got, whole, want
    ms = time_ms(lambda: agk.all_gather_w_launch(x, q, sc, mesh, fmt), 10)
    plain_ms = time_ms(lambda: agk.all_gather_wired_plain(x, pairs, fmt), 2)
    call_ms = time_ms(lambda: agk.all_gather(x, mesh, wire_dtype="fp8"), 10)
    lib = time_ms(lambda: torch.cat(x * TP), 10)
    # the own shards and every slab's codes and scales read once, every
    # rank's gathered copy written once
    nbytes = 2 * TP * m * h + TP * m * h + 4 * TP * m + 2 * TP * TP * m * h
    bnd, by = bound_ms(nbytes, 0.0, H100_BF16_OPS)
    log(f"time all_gather_wire {tag} (1/pass, one launch for {TP} ranks): "
        f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib:.4f} "
        f"(one torch.cat of every rank's copy) bound_ms={bnd:.4f} ({by}); "
        f"call_ms={call_ms:.4f} (the wrapper: quantizer + kernel)")
    res.shape("all_gather_wire", len(WIRES), ms, plain_ms, lib, nbytes, 0.0,
              H100_BF16_OPS)
    del x, wired, pairs, q, sc
    # every launch of the phase (checks, times, whole calls) on wgmma
    check_all_wgmma(res, f"{tag0} kernels", ("ag_gemm_wire", "gemm_rs_wire"))


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
    up K 2048 N 352 a rank, down K 352 a rank N 2048), timed, two runs
    bit-identical, and in f32 at 256 tokens a rank with an empty expert;
    every bf16 launch on the grouped warpgroup GEMM (``wgmma``), every f32
    one on the FMA loop."""
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
        clear_wg_forms(*MOE_MESH_ROWS)
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
            if empty is None and not all(
                    torch.equal(a, b) for a, b in zip(fn(), out)):
                res.failures.append(f"{name} {tag}: two runs differ")
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
        check_all_wgmma(res, f"deepseek_moe_16b tp={TP} moe_tp mesh {what}",
                        MOE_MESH_ROWS,
                        "wgmma" if dt == torch.bfloat16 else "fma")


def moe_wire_tokens(dev, g):
    """The MoE wire path's tokens: TP x 2048 rows of hidden 2048 in bf16,
    row 1 of every shard x1000 (the chunk scale's worst case)."""
    import torch

    x = torch.randn((TP, DEC_B * DEC_PROMPT // TP, MOE_H), generator=g,
                    device=dev, dtype=torch.bfloat16)
    x[:, 1] *= 1000.0
    return x.reshape(-1, MOE_H)


def moe_wire_layer(dev, g, x):
    """One MoE layer's seeded weights at tp = 4 and its routing of ``x``:
    (router weights, top-k ids, W up shards (E, H, F/4), W down shards
    (E, F/4, H)), bf16."""
    import torch

    from triton_distributed_tpu_torch.kernels import moe_utils as mu

    fl = MOE_F // TP
    gate = torch.randn((MOE_H, MOE_E), generator=g, device=dev) * MOE_H ** -0.5
    wts, ids = mu.select_experts(x.float() @ gate, MOE_K)
    w_up = list((torch.randn((TP, MOE_E, MOE_H, fl), generator=g, device=dev,
                             dtype=torch.bfloat16) * MOE_H ** -0.5).unbind(0))
    w_down = list((torch.randn((TP, MOE_E, fl, MOE_H), generator=g,
                               device=dev, dtype=torch.bfloat16)
                   * MOE_F ** -0.5).unbind(0))
    return wts, ids, w_up, w_down


def check_moe_wire_kernels(res: Results, dev, n_moe: int):
    """The MoE-TP wire kernels over a loopback mesh of 4 ranks at the MoE
    wire path's shapes (DeepSeek-MoE-16B, 4 x 2048 tokens with an outlier
    token a shard, top-6 over 64 experts, each shard aligned on its own at
    block_m 128: 20480 sorted rows a shard; up K 2048 N 352 a rank, down
    K 352 a rank N 2048), each alone against its plain version on the
    same inputs, timed: the quantizer on the sorted slabs (byte-exact;
    fp8 / int8 chunks of 64 rows, int8-mxu of 128); the AG kernels on
    fp8 / int8 (the bf16 GEMM's excess check, per row) and int8-mxu
    (bit-exact: s32 sums), the padding rows 0; the reduce's partials (the
    excess check, per row) and its fold on fp8 / int8 (bit-exact against
    the plain fold of the kernel's own partials, as is the whole wire).
    Each row weighs its shapes by their launches in the MoE wire path's
    run; an op's whole call (the gather and the quantizer, for int8-mxu
    the experts' quantization in torch ops; the partials and the fold) is
    logged as call_ms beside its kernel's time. The fp8 / int8 AG (its
    own rows from the sorted slabs the quantizer was given, as the op
    passes them) and the partials run the grouped warpgroup GEMM
    (``csrc/wg_gemm.cuh`` ``wg_grouped_kernel``): each checked launch
    logs its form, every launch of the phase must be ``wgmma``, and
    ptxas's registers and spills for that kernel are logged (a spill
    fails the run)."""
    import torch
    import torch.nn.functional as F

    from triton_distributed_tpu_torch import ops
    from triton_distributed_tpu_torch.kernels import gemm_rs as grs
    from triton_distributed_tpu_torch.kernels import moe_tp_fused as mtf
    from triton_distributed_tpu_torch.kernels import moe_utils as mu
    from triton_distributed_tpu_torch.kernels import wire as wk
    from triton_distributed_tpu_torch.lang import wire as tw
    from triton_distributed_tpu_torch.lang.shmem import stacked
    from triton_distributed_tpu_torch.runtime import Mesh

    torch.cuda.empty_cache()
    mesh = Mesh.loopback(TP, dev)
    m_s, fl, bf16 = DEC_B * DEC_PROMPT // TP, MOE_F // TP, torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(15)
    x_cat = moe_wire_tokens(dev, g)
    _, ids, w_up, w_down = moe_wire_layer(dev, g, x_cat)
    x = list(x_cat.chunk(TP))
    ctx = {w: ops.MoETPContext(num_experts=MOE_E, topk=MOE_K,
                               block_m=MOE_TP_BM, dtype=bf16, mesh=mesh,
                               wire_dtype=w) for w in WIRES}
    routing = ops.align_routing_sharded(ctx[None], ids)
    sti, be = routing.sti, routing.be
    cap_s, nb = routing.cap_s, be.shape[1]
    used = int(torch.unique(be).numel())
    valid = TP * m_s * MOE_K
    pad = sti.reshape(-1) >= m_s * MOE_K
    be_all = be.reshape(-1).long()
    tag0 = (f"deepseek_moe_16b tp={TP} moe wire {TP} x {m_s} tokens "
            f"cap_s={cap_s}")
    slab_st = mu.gather_sorted(stacked(x), sti, MOE_K)
    slabs = list(slab_st.unbind(0))
    flops = 2.0 * valid * MOE_H * MOE_F
    check_ptxas(res, "wg_grouped_kernel", tag0)
    clear_wg_forms("ag_group_gemm_wire", "moe_reduce_rs_wire")

    # the quantizer on the sorted slabs: fp8 / int8 at 64-row chunks and
    # int8-mxu at 128, once a layer each
    wired = {}
    for wire in ("fp8", "int8", "int8-mxu"):
        fmt = mtf._wire_fmt(wire, cap_s, MOE_TP_BM)
        q, sc = mtf.quantize_sorted(x, sti, MOE_K, fmt)[:2]
        wq, wsc = wk.quantize_shards_plain(slabs, fmt)
        torch.cuda.synchronize()
        exact = (torch.equal(q.view(torch.uint8), wq.view(torch.uint8))
                 and torch.equal(sc, wsc))
        del wq, wsc
        what = (f"{tag0} quantize sorted slabs {wire} chunk_rows="
                f"{fmt.chunk_rows} {TP} x {(cap_s, MOE_H)} bf16")
        res.check("wire_quantize", 0.0 if exact else 1.0, 0.0, what,
                  metric="bytes differ")
        ms = time_ms(lambda: wk.quantize_shards(slabs, fmt), 10)
        plain_ms = time_ms(lambda: wk.quantize_shards_plain(slabs, fmt), 2)
        call_ms = time_ms(lambda: mtf.quantize_sorted(x, sti, MOE_K, fmt), 5)
        # every slab read once, its codes and scales written once
        nbytes = TP * cap_s * MOE_H * 3 + 4 * TP * cap_s // fmt.chunk_rows
        bnd, by = bound_ms(nbytes, 0.0, H100_BF16_OPS)
        log(f"time wire_quantize {what} ({n_moe}/run, one launch for {TP} "
            f"ranks): kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms=None (no one PyTorch call) bound_ms={bnd:.4f} "
            f"({by}); call_ms={call_ms:.4f} (the gather of the sorted "
            "slabs + the quantizer)")
        res.shape("wire_quantize", n_moe, ms, plain_ms, None, nbytes, 0.0,
                  H100_BF16_OPS)
        wired[wire] = (fmt, q, sc)
    del slabs
    agw = mtf._ag_group_gemm_w_cuda

    # the AG side: fp8 and int8 (ag_group_gemm_wire), int8-mxu
    wg = torch.cat(w_up, dim=2)[be_all]
    for wire in ("fp8", "int8", "int8-mxu"):
        mx = wire == "int8-mxu"
        name = "ag_group_gemm_mx" if mx else "ag_group_gemm_wire"
        fmt, q, sc = wired[wire]
        tag = (f"{tag0} {wire} up K={MOE_H} N={fl} a rank ({used} experts, "
               f"{n_moe}/run, one launch for {TP} ranks)")
        call_ms = time_ms(lambda: ops.ag_group_gemm_fused(
            x_cat, routing, w_up, ctx[wire]), 3)
        if mx:
            wq, wsc = mtf.quantize_expert_shards(w_up)
            out = mtf.ag_group_gemm_mesh_mx(q, sc, be, wq, wsc, mesh,
                                            out_dtype=bf16)
            ref = mtf.ag_group_gemm_mesh_mx_plain(q, sc, be, wq, wsc, mesh,
                                                  out_dtype=bf16)
            torch.cuda.synchronize()
            err = max((o.float() - r.float()).abs().max().item()
                      for o, r in zip(out, ref))
            res.check(name, err, 0.0, tag + " (bit-exact: s32 sums)")
            ms = time_ms(lambda: mtf.ag_group_gemm_mesh_mx(
                q, sc, be, wq, wsc, mesh, out_dtype=bf16), 5)
            plain_ms = time_ms(lambda: mtf.ag_group_gemm_mesh_mx_plain(
                q, sc, be, wq, wsc, mesh, out_dtype=bf16), 1)
            w_ms = time_ms(lambda: mtf.quantize_expert_shards(w_up), 3)
            lib, libwhat = None, ("none: no PyTorch call multiplies int8 "
                                  "blocks by a per-block expert (no CUDA "
                                  "int8 bmm; torch._int_mm takes one "
                                  "matrix)")
            # the codes and scales, the used experts' int8 weights and
            # scales of every rank once, every output once
            nbytes = (TP * cap_s * MOE_H + 4 * TP * nb + used * MOE_H * MOE_F
                      + 4 * used * MOE_F + 4 * TP * nb
                      + 2 * TP * TP * cap_s * fl)
            peak = H100_INT8_OPS
            extra = (f"; the experts' quantization and transposed copy in "
                     f"torch ops {w_ms:.4f} ms of it")
            del wq, wsc
        else:
            before = dict(agw.by_variant)
            out = mtf.ag_group_gemm_mesh_w(x, q, sc, sti, be, w_up, MOE_K,
                                           mesh, fmt, slabs=slab_st)
            ref = mtf.ag_group_gemm_mesh_w_plain(x, q, sc, sti, be, w_up,
                                                 MOE_K, mesh, fmt,
                                                 out_dtype=torch.float32)
            torch.cuda.synchronize()
            over, err = _row_excess(out, ref)
            tag += " form=" + form_of(agw, before)
            res.check(name, over, GG_ATOL, tag, metric="max over rows "
                      "of max(|err|-2^-8|ref|)/rowmax|ref|")
            ms = time_ms(lambda: mtf.ag_group_gemm_mesh_w(
                x, q, sc, sti, be, w_up, MOE_K, mesh, fmt, slabs=slab_st),
                5)
            plain_ms = time_ms(lambda: mtf.ag_group_gemm_mesh_w_plain(
                x, q, sc, sti, be, w_up, MOE_K, mesh, fmt), 1)
            a_deq = torch.cat([tw.dequantize_slab(qr, sr, fmt, bf16)
                               for qr, sr in zip(q, sc)]).reshape(
                TP * nb, MOE_TP_BM, MOE_H)
            lib = time_ms(lambda: torch.bmm(a_deq, wg), 3)
            libwhat = ("bmm on the dequantized sorted rows, every rank's "
                       "columns, weights gathered per block")
            del a_deq
            # the own tokens, every slab's codes and scales, the used
            # experts' weights of every rank once, every output once
            nbytes = (2 * TP * m_s * MOE_H + TP * cap_s * MOE_H
                      + 4 * TP * cap_s // fmt.chunk_rows + 4 * TP * cap_s
                      + 4 * TP * nb + 2 * used * MOE_H * MOE_F
                      + 2 * TP * TP * cap_s * fl)
            peak = H100_BF16_OPS
            extra = ""
        if not all(bool((o[pad] == 0).all()) for o in out):
            res.failures.append(f"{name} {tag}: padding rows not 0")
        res.kernel(name, err=err)
        bnd, by = bound_ms(nbytes, flops, peak)
        log(f"time {name} {tag}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={lib if lib is None else f'{lib:.4f}'} ({libwhat}) "
            f"bound_ms={bnd:.4f} ({by}) max_abs_err={err:.6g}; call_ms="
            f"{call_ms:.4f} (the op: gather + quantizer + kernel{extra})")
        res.shape(name, n_moe, ms, plain_ms, lib, nbytes, flops, peak)
        del out, ref
    del wg, wired, slab_st

    # the reduce side: every rank's partials (fp8, int8 and int8-mxu's
    # int8 payload), then the fold on fp8 / int8
    hs = F.silu(stacked(ops.ag_group_gemm_fused(
        x_cat, routing, w_up, ctx[None])).float()).to(bf16)
    y = list(hs.unbind(0))
    tag = (f"{tag0} down K={fl} a rank x {TP} N={MOE_H} ({used} experts, "
           f"one launch for {TP} ranks)")
    before = dict(mtf._moe_reduce_rs_partials_cuda.by_variant)
    parts = mtf.moe_reduce_rs_partials(y, be, w_down, mesh)
    ref = mtf.moe_reduce_rs_partials_plain(y, be, w_down, mesh,
                                           out_dtype=torch.float32)
    torch.cuda.synchronize()
    over, err = _row_excess(parts, ref)
    del ref
    ptag = (f"{tag} partials form="
            + form_of(mtf._moe_reduce_rs_partials_cuda, before))
    res.check("moe_reduce_rs_wire", over, GG_ATOL, ptag,
              metric="max over rows of max(|err|-2^-8|ref|)/rowmax|ref|")
    res.kernel("moe_reduce_rs_wire", err=err)
    ms = time_ms(lambda: mtf.moe_reduce_rs_partials(y, be, w_down, mesh), 5)
    plain_ms = time_ms(lambda: mtf.moe_reduce_rs_partials_plain(
        y, be, w_down, mesh), 1)
    yg = torch.cat(y, dim=1).reshape(TP * nb, MOE_TP_BM, MOE_F)
    wg = torch.cat(w_down, dim=1)[be_all]
    lib = time_ms(lambda: torch.bmm(yg, wg), 3)
    del yg, wg
    # every rank's rows and the used experts' weights once, every partial
    # slab once
    nbytes = (2 * TP * TP * cap_s * fl + 4 * TP * nb
              + 2 * used * MOE_F * MOE_H + 2 * TP * TP * cap_s * MOE_H)
    bnd, by = bound_ms(nbytes, flops, H100_BF16_OPS)
    log(f"time moe_reduce_rs_wire {ptag} ({3 * n_moe}/run): "
        f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib:.4f} "
        f"(bmm on the concatenated operands, weights gathered per block: "
        f"the sum over ranks in one product) bound_ms={bnd:.4f} ({by}) "
        f"max_abs_err={err:.6g}")
    res.shape("moe_reduce_rs_wire", 3 * n_moe, ms, plain_ms, lib, nbytes,
              flops, H100_BF16_OPS)
    for wire, passes in (("fp8", 1), ("int8", 2)):
        fmt = mtf._wire_fmt(wire, cap_s)
        folded = mtf.moe_reduce_rs_fold(parts, mesh, fmt, bf16)
        whole = mtf.moe_reduce_rs_mesh_w(y, be, w_down, mesh, fmt)
        want = grs.gemm_rs_fold_plain(parts, fmt, bf16)
        torch.cuda.synchronize()
        for got, part in ((folded, "fold"),
                          (whole, "whole wire (partials + fold)")):
            same = all(torch.equal(o, r) for o, r in zip(got, want))
            res.check("moe_reduce_rs_fold", 0.0 if same else 1.0, 0.0,
                      f"{tag} {wire} {part} = the plain fold of the "
                      "kernel's partials", metric="bytes differ")
        res.kernel("moe_reduce_rs_fold", err=0.0)
        del folded, whole, want
        ms = time_ms(lambda: mtf.moe_reduce_rs_fold(parts, mesh, fmt, bf16),
                     5)
        plain_ms = time_ms(lambda: grs.gemm_rs_fold_plain(parts, fmt, bf16),
                           1)
        call_ms = time_ms(lambda: mtf.moe_reduce_rs_mesh_w(
            y, be, w_down, mesh, fmt), 3)
        # every partial slab read once, every output written once
        nbytes = 2 * (TP * TP * cap_s * MOE_H + TP * cap_s * MOE_H)
        bnd, by = bound_ms(nbytes, 0.0, H100_BF16_OPS)
        log(f"time moe_reduce_rs_fold {tag} {wire} chunk_rows="
            f"{fmt.chunk_rows} ({passes * n_moe}/run): kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms=None (no one PyTorch call "
            f"requantizes each hop) bound_ms={bnd:.4f} ({by}); call_ms="
            f"{call_ms:.4f} (the wrapper: partials + fold)")
        res.shape("moe_reduce_rs_fold", passes * n_moe, ms, plain_ms, None,
                  nbytes, 0.0, H100_BF16_OPS)
    del parts, y, hs, x, x_cat, w_up, w_down
    check_all_wgmma(res, f"{tag0} kernels",
                    ("ag_group_gemm_wire", "moe_reduce_rs_wire"))


# ------------------------------------------------------------ collectives

def coll_tokens(dev, g, per_rank):
    """The collectives path's tokens: TP x ``per_rank`` bf16 rows of
    hidden 2048."""
    import torch

    return torch.randn((TP * per_rank, MOE_H), generator=g, device=dev,
                       dtype=torch.bfloat16)


def coll_layer(dev, g):
    """One MoE layer's seeded weights: the router (H, E) f32, and the
    experts (E, H, F), (E, F, H) in bf16 (1/sqrt(fan-in) scaled)."""
    import torch

    gate = torch.randn((MOE_H, MOE_E), generator=g, device=dev) * MOE_H ** -0.5
    up = torch.randn((MOE_E, MOE_H, MOE_F), generator=g, device=dev,
                     dtype=torch.bfloat16) * MOE_H ** -0.5
    down = torch.randn((MOE_E, MOE_F, MOE_H), generator=g, device=dev,
                       dtype=torch.bfloat16) * MOE_F ** -0.5
    return gate, up, down


def tp_shards(up, down):
    """The experts' F dim over TP ranks: W (E, H, F/4) and (E, F/4, H)
    shards, each rank's views of one allocation."""
    import torch

    fl = MOE_F // TP
    return (list(torch.stack(up.split(fl, dim=2)).unbind(0)),
            list(torch.stack(down.split(fl, dim=1)).unbind(0)))


def rs_work(parts):
    """(bytes, operations) of a reduce-scatter: every contribution read
    once and every output written once; W - 1 adds an output element."""
    w = len(parts)
    n = parts[0].numel()
    return (w + 1) * n * parts[0].element_size(), (w - 1) * n


def check_collectives(res: Results, dev, n_moe: int):
    """The reduce-scatter and the dense all-to-all over a loopback mesh of
    4 ranks against their plain versions, at the collectives path's
    shapes: the composed MoE-TP's stacked partials (4 x 8192 x 2048, the
    stream engine, and 4 x 1024 x 2048, the VMEM ring), bit-exact in bf16
    and in f32; the wire folds on fp8 / int8 at one scale a row (the VMEM
    ring's) and at 64-row chunks (the stream's), bit-exact against
    ``gemm_rs_fold_plain``; the all-to-all at the padded-slot transport's
    three slot shapes (fp8 and bf16 at 12288 rows a slot, fp8 at 4096),
    byte-exact. Each timed (CUDA events; the small reduce-scatter, the
    fold and the all-to-all from a CUDA graph) beside its plain version,
    one PyTorch call and the bound. The rows weigh each shape by its
    launches in :func:`run_collectives_path`."""
    import torch

    from triton_distributed_tpu_torch.kernels import all_to_all as a2a
    from triton_distributed_tpu_torch.kernels import gemm_rs as grs
    from triton_distributed_tpu_torch.kernels import moe_all_to_all as ma
    from triton_distributed_tpu_torch.kernels import reduce_scatter as rs
    from triton_distributed_tpu_torch.lang import wire as tw
    from triton_distributed_tpu_torch.lang.shmem import stacked
    from triton_distributed_tpu_torch.runtime import Mesh

    torch.cuda.empty_cache()
    mesh = Mesh.loopback(TP, dev)
    g = torch.Generator(device=dev).manual_seed(30)
    for rows, dt, on_path in ((TP * COLL_BIG, torch.bfloat16, True),
                              (TP * COLL_SMALL, torch.bfloat16, True),
                              (TP * COLL_BIG, torch.float32, False),
                              (TP * COLL_SMALL, torch.float32, False)):
        full = torch.randn((TP, rows, MOE_H), generator=g, device=dev,
                           dtype=dt) * 30
        parts = list(full.unbind(0))
        kern = rs.select_engine(TP, (rows, MOE_H), full.element_size(),
                                None)[0]
        got = rs.reduce_scatter(parts, mesh, stacked=True)
        want = rs.reduce_scatter_plain(parts, mesh, stacked=True)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        what = (f"{TP} x ({rows}, {MOE_H}) {str(dt)[6:]} stacked partials "
                f"({kern})")
        res.check("reduce_scatter", 0.0 if same else 1.0, 0.0, what,
                  metric="bits differ")
        res.kernel("reduce_scatter", err=0.0)
        del got, want
        if not on_path:
            continue
        big = rows == TP * COLL_BIG
        if big:
            ms = time_ms(lambda: rs.reduce_scatter(parts, mesh,
                                                   stacked=True), 10)
        else:
            ms = graph_time_ms(lambda i: rs.reduce_scatter(parts, mesh,
                                                           stacked=True))
        plain = time_ms(lambda: rs.reduce_scatter_plain(
            parts, mesh, stacked=True), 3)
        lib = time_ms(lambda: full.sum(0), 10)
        nbytes, ops = rs_work(parts)
        b, by = bound_ms(nbytes, ops, H100_F32_OPS)
        n = 2 * n_moe if big else n_moe
        log(f"time reduce_scatter {what} ({n}/run, one launch for {TP} "
            f"ranks): kernel_ms={ms:.4f}{'' if big else ' (graph)'} "
            f"plain_ms={plain:.4f} library_ms={lib:.4f} (one torch.sum over "
            f"the stacked partials, then a cut) bound_ms={b:.4f} ({by})")
        res.shape("reduce_scatter", n, ms, plain, lib, nbytes, ops,
                  H100_F32_OPS)
        # the wire folds on these partials, at the chunk their engine uses
        fmt_rows = 1 if not big else tw.make_wire_format(
            "fp8", rows // TP).chunk_rows
        for wire, n_w in (("fp8", 3 if big else 2), ("int8", 2 if big else 1)):
            fmt = tw.WireFormat(quant=wire, chunk_rows=fmt_rows)
            flat = [p.view(rows, MOE_H) for p in parts]
            out = grs.launch_fold(flat, mesh, fmt, dt)
            ref = grs.gemm_rs_fold_plain(flat, fmt, dt)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(out, ref))
            fwhat = (f"{TP} x ({rows}, {MOE_H}) bf16 {wire} chunk_rows="
                     f"{fmt_rows}")
            res.check("reduce_scatter_fold", 0.0 if same else 1.0, 0.0,
                      fwhat, metric="bits differ")
            res.kernel("reduce_scatter_fold", err=0.0)
            del out, ref
            fms = graph_time_ms(lambda i: grs.launch_fold(flat, mesh, fmt,
                                                          dt), iters=8)
            fplain = time_ms(lambda: grs.gemm_rs_fold_plain(flat, fmt, dt), 1)
            # as for the GEMM-RS fold: every partial read once, every
            # output written once
            fbytes, fops = nbytes, 0.0
            fb, fby = bound_ms(fbytes, fops, H100_F32_OPS)
            log(f"time reduce_scatter_fold {fwhat} ({n_w}/run, one launch "
                f"for {TP} ranks): kernel_ms={fms:.4f} (graph) plain_ms="
                f"{fplain:.4f} library_ms=None (no one PyTorch call "
                f"requantizes each hop) bound_ms={fb:.4f} ({fby}; "
                f"{rows // TP // fmt_rows * TP} blocks of {fmt_rows * MOE_H} "
                "elements)")
            res.shape("reduce_scatter_fold", n_w, fms, fplain, None, fbytes,
                      fops, H100_F32_OPS)
        del full, parts

    # the all-to-all at the padded-slot transport's slot shapes
    for quant, max_m, n in (("fp8", COLL_BIG * MOE_K, 2 * n_moe),
                            (None, COLL_BIG * MOE_K, 2 * n_moe + 2),
                            ("fp8", COLL_DEMOTED_M, 2 * n_moe)):
        ctx = ma.create_all_to_all_context(
            mesh, max_m=max_m, hidden=MOE_H, experts_per_rank=MOE_E // TP,
            dtype=torch.bfloat16, quant=quant)
        shape = (TP, TP * ctx.slot_rows, ctx.ints_per_row)
        x = torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=g,
                          device=dev, dtype=torch.int32)
        got = a2a.all_to_all_device(x, mesh)
        want = torch.stack(a2a.all_to_all_plain(list(x.unbind(0))))
        torch.cuda.synchronize()
        bad = int((got != want).sum())
        what = (f"padded slots {quant or 'bf16'} max_m={max_m}: {TP} x "
                f"{shape[1:]} int32")
        res.check("all_to_all", bad, 0, what, metric="words differ")
        res.kernel("all_to_all", err=0.0)
        del got, want
        # from a CUDA graph, as the other collectives are (4 calls a
        # graph: each allocates its 135-805 MB output)
        ms = graph_time_ms(lambda i: a2a.all_to_all_device(x, mesh),
                           iters=4)
        plain = time_ms(lambda: a2a.all_to_all_plain(list(x.unbind(0))), 3)
        dst = torch.empty_like(x)
        lib = graph_time_ms(lambda i: dst.copy_(x), iters=4)
        nbytes = 2 * x.numel() * 4
        b, by = bound_ms(nbytes, 0.0, H100_BF16_OPS)
        log(f"time all_to_all {what} ({n}/run, one launch for {TP} ranks, "
            f"{x.numel() * 4} bytes moved): kernel_ms={ms:.4f} (graph) "
            f"plain_ms={plain:.4f} library_ms={lib:.4f} (one copy_ of the "
            f"same bytes, graph) bound_ms={b:.4f} ({by})")
        res.shape("all_to_all", n, ms, plain, lib, nbytes, 0.0,
                  H100_BF16_OPS)
        del x, dst


def step4_operands(dev, g, n):
    """The step-4 GEMM-RS's shards: A_q (TP·m, K) bf16 with an outlier
    row (x1000) a shard, B_q (K, N) scaled to unit outputs."""
    a = wire_operands(dev, g, (TP * STEP4_M, STEP4_K), outlier=True)
    b = wire_operands(dev, g, (STEP4_K, n), (TP * STEP4_K) ** -0.5)
    return a, b


def check_step4_kernels(res: Results, dev):
    """The step-4 kernels over a loopback mesh of 4 ranks against their
    plain versions, at the step-4 path's shapes, each timed beside its
    plain version, one PyTorch call (or none) and the bound: the int8-mxu
    GEMM-RS's s8 partials (``tdt_gemm_rs_mx``, f32 slabs for the
    accumulator epilogue, bf16 for the readback one) and its two folds,
    bit-exact, at N 1024 and 512 (JAX's row block, 512 rows, is the
    scale chunk); the bidirectional all-gather at 4 x (2048, 4096) bf16,
    without a schedule and at split8 2, 4, 6, and the persistent LL
    gather at 4 x (8, 4096) bf16 (from a CUDA graph: the launch bounds
    it), byte-exact. The rows weigh each shape by its launches in
    :func:`run_step4_path`."""
    import torch

    from triton_distributed_tpu_torch.kernels import ag_gemm as agm
    from triton_distributed_tpu_torch.kernels import allgather as agk
    from triton_distributed_tpu_torch.kernels import gemm_rs as grs
    from triton_distributed_tpu_torch.kernels import wire as wk
    from triton_distributed_tpu_torch.lang import wire as tw
    from triton_distributed_tpu_torch.runtime import Mesh
    from triton_distributed_tpu_torch.tune.schedule import GridSchedule

    torch.cuda.empty_cache()
    mesh = Mesh.loopback(TP, dev)
    bf16, f32 = torch.bfloat16, torch.float32
    g = torch.Generator(device=dev).manual_seed(40)
    m, k, rows = STEP4_M, STEP4_K, TP * STEP4_M
    for n in STEP4_NS:
        a, b = step4_operands(dev, g, n)
        plan = grs.resolve_gemm_rs_plan(mesh, "tp", a, b,
                                        wire_dtype="int8-mxu")
        if plan.wire != "int8-mxu":
            res.failures.append(f"step4 N {n}: int8-mxu resolved to "
                                f"{plan.wire}, not the s8 producer")
            continue
        cr = plan.chunk_rows
        fmt = tw.WireFormat("int8", cr)
        q, s = wk.quantize_shards(a, fmt)
        bqt, bs = agm.quantize_cols_shards(b)
        tag = (f"deepseek_moe_16b wo tp={TP} N={n} A_q {TP} x {(rows, k)} "
               f"B_q {TP} x {(k, n)} chunk_rows={cr}")
        ops = 2.0 * TP * rows * k * n
        # the partials' library call: each rank's torch._int_mm, then the
        # epilogue (no one call takes every rank's own B)
        codes = [qr.contiguous() for qr in q]
        bcols = [br.t() for br in bqt]
        rsc = [sr.repeat_interleave(cr)[:, None] for sr in s]

        def lib_partials(pdt):
            return [(torch._int_mm(c, bc).float() * (r * bsr[None, :]))
                    .to(pdt) for c, bc, r, bsr in zip(codes, bcols, rsc, bs)]

        parts = {}
        for pdt, epi in ((f32, "accumulator"), (bf16, "readback")):
            got = grs.gemm_rs_mx_partials(q, s, bqt, bs, mesh, cr, pdt)
            want = grs.mx_partials_plain(q, s, bqt, bs, cr, pdt)
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in zip(got, want))
            what = f"{tag} partials {str(pdt)[6:]} ({epi})"
            res.check("gemm_rs_mx", 0.0 if same else 1.0, 0.0,
                      what + " (bit-exact: s32 sums)", metric="bits differ")
            res.kernel("gemm_rs_mx", err=0.0)
            parts[epi] = got
            del want
            ms = time_ms(lambda: grs.gemm_rs_mx_partials(q, s, bqt, bs, mesh,
                                                         cr, pdt), 5)
            plain = time_ms(lambda: grs.mx_partials_plain(q, s, bqt, bs, cr,
                                                          pdt), 1)
            lib = time_ms(lambda: lib_partials(pdt), 5)
            # every rank's codes and scales, B's codes and scales read
            # once, every partial slab written once
            nbytes = (TP * rows * k + 4 * TP * rows // cr + TP * n * k
                      + 4 * TP * n + TP * rows * n * (4 if pdt == f32 else 2))
            bnd, by = bound_ms(nbytes, ops, H100_INT8_OPS)
            log(f"time gemm_rs_mx {what} (1/run, one launch for {TP} "
                f"ranks): kernel_ms={ms:.4f} plain_ms={plain:.4f} "
                f"library_ms={lib:.4f} (torch._int_mm + epilogue, rank by "
                f"rank) bound_ms={bnd:.4f} ({by})")
            res.shape("gemm_rs_mx", 1, ms, plain, lib, nbytes, ops,
                      H100_INT8_OPS)
        for epi, row in (("accumulator", "gemm_rs_mxw_fold"),
                         ("readback", "gemm_rs_mxr_fold")):
            p = parts[epi]
            got = grs.gemm_rs_mx_fold(p, mesh, fmt, bf16, epi)
            want = grs.gemm_rs_mx_fold_plain(p, fmt, bf16, epi)
            whole = grs.gemm_rs(a, b, mesh, wire_dtype="int8-mxu",
                                schedule=GridSchedule(epilogue=epi))
            torch.cuda.synchronize()
            for out, part in ((got, "fold"), (whole, "whole call")):
                same = all(torch.equal(x, y) for x, y in zip(out, want))
                res.check(row, 0.0 if same else 1.0, 0.0,
                          f"{tag} {epi} {part} = the plain fold of the "
                          "kernel's partials", metric="bits differ")
            res.kernel(row, err=0.0)
            del got, want, whole
            ms = time_ms(lambda: grs.gemm_rs_mx_fold(p, mesh, fmt, bf16, epi),
                         5)
            plain = time_ms(lambda: grs.gemm_rs_mx_fold_plain(p, fmt, bf16,
                                                              epi), 1)
            call_ms = time_ms(lambda: grs.gemm_rs(
                a, b, mesh, wire_dtype="int8-mxu",
                schedule=GridSchedule(epilogue=epi)), 3)
            # every partial read once, every output written once
            nbytes = TP * rows * n * p[0].element_size() + 2 * TP * m * n
            bnd, by = bound_ms(nbytes, 0.0, H100_BF16_OPS)
            log(f"time {row} {tag} {epi} (1/run, one launch for {TP} ranks, "
                f"{TP * m // cr} blocks): kernel_ms={ms:.4f} plain_ms="
                f"{plain:.4f} library_ms=None (no one PyTorch call "
                f"requantizes each hop) bound_ms={bnd:.4f} ({by}); "
                f"call_ms={call_ms:.4f} (the wrapper: A's quantizer, B's "
                "per-column quantization in torch ops, partials, fold)")
            res.shape(row, 1, ms, plain, None, nbytes, 0.0, H100_BF16_OPS)
        del a, b, q, s, bqt, bs, codes, bcols, rsc, parts

    # the bidirectional all-gather at Llama-2-7B's last MLP output
    x = wire_operands(dev, g, STEP4_AG_SHAPE)
    want = torch.cat(x)
    nb = x[0].numel() * x[0].element_size()
    nbytes = TP * nb + TP * TP * nb
    cols = STEP4_AG_SHAPE[1]
    for split8 in STEP4_SPLITS:
        kh = agk.bidir_split(cols, split8)
        got = agk._all_gather_bidir_cuda(x, mesh, kh)
        torch.cuda.synchronize()
        same = all(torch.equal(o, want) for o in got)
        what = (f"llama_7b tp={TP} last MLP output {TP} x {STEP4_AG_SHAPE} "
                f"bf16 split8={split8} (kh {kh})")
        res.check("all_gather_bidir", 0.0 if same else 1.0, 0.0, what,
                  metric="bytes differ")
        res.kernel("all_gather_bidir", err=0.0)
        del got
        ms = time_ms(lambda: agk._all_gather_bidir_cuda(x, mesh, kh), 10)
        plain = time_ms(lambda: agk.all_gather_bidir_plain(x, kh), 2)
        lib = time_ms(lambda: torch.cat(x * TP), 10)
        bnd, by = bound_ms(nbytes, 0.0, H100_BF16_OPS)
        log(f"time all_gather_bidir {what} (1/run, one launch for {TP} "
            f"ranks): kernel_ms={ms:.4f} plain_ms={plain:.4f} library_ms="
            f"{lib:.4f} (one torch.cat of every rank's copy) bound_ms="
            f"{bnd:.4f} ({by})")
        res.shape("all_gather_bidir", 1, ms, plain, lib, nbytes, 0.0,
                  H100_BF16_OPS)
    del x, want

    # the persistent LL gather at the tp = 4 decode's partial shape; 24
    # inputs apart, so that the graph's calls stream from memory
    ins = [wire_operands(dev, g, STEP4_LL_SHAPE) for _ in range(24)]
    ll = agk.PersistentLLAllGather(mesh, "tp", STEP4_LL_SHAPE, bf16)
    what = f"tp={TP} decode partial {TP} x {STEP4_LL_SHAPE} bf16"
    for c in range(2):
        got = ll(ins[c])
        torch.cuda.synchronize()
        same = all(torch.equal(o, torch.cat(ins[c])) for o in got)
        res.check("all_gather_persist", 0.0 if same else 1.0, 0.0,
                  f"{what}, call {c}", metric="bytes differ")
    res.kernel("all_gather_persist", err=0.0)
    ws = [w.clone() for w in ll.workspace]
    ms = graph_time_ms(lambda i: agk._ll_persist_cuda(ins[i], ll.ws, mesh,
                                                      i % 2))
    plain = time_ms(lambda: agk.ll_persist_plain(ins[0], ws, 0), 20)
    lib = time_ms(lambda: torch.cat(ins[0] * TP), 20)
    nb = ins[0][0].numel() * ins[0][0].element_size()
    # the shards read once, every rank's window and output written once
    nbytes = TP * nb + 2 * TP * TP * nb
    bnd, by = bound_ms(nbytes, 0.0, H100_BF16_OPS)
    log(f"time all_gather_persist {what} ({STEP4_LL_CALLS}/run, one "
        f"launch for {TP} ranks): kernel_ms={ms:.4f} (graph) plain_ms="
        f"{plain:.4f} library_ms={lib:.4f} (one torch.cat of every rank's "
        f"copy) bound_ms={bnd:.6f} ({by}; the launch bounds it)")
    res.shape("all_gather_persist", STEP4_LL_CALLS, ms, plain, lib, nbytes,
              0.0, H100_BF16_OPS)
    del ins, ll, ws


def cp_partials(dev, g, r, dtype, hkv=16, tg=T_PAD, d=128):
    """Seeded (R, Hkv, TG, D) partials and (R, Hkv, TG) lses as views of
    one (Hkv, R·TG, D) ragged output, as the long-context serving step's
    one launch over every shard writes them, masked as in that step:
    rows 0-191 held by shard 0 alone (short requests), rows 192-511 seen
    by every shard, the parking zone (512 on) by none."""
    import torch

    from triton_distributed_tpu_torch.kernels.cp_ring import NEG_INF

    outs = torch.randn((hkv, r * tg, d), generator=g, device=dev).to(dtype)
    lses = 4.0 * torch.randn((hkv, r * tg), generator=g, device=dev)
    vo = outs.view(hkv, r, tg, d).transpose(0, 1)
    vl = lses.view(hkv, r, tg).transpose(0, 1)
    vl[1:, :, :192] = NEG_INF
    vl[:, :, 512:] = NEG_INF
    vo[vl <= NEG_INF / 2] = 0
    return vo, vl


def check_cp_combine(res: Results, dev):
    """The cp LSE-combine (``tdt_cp_lse_combine``) against its plain
    version, bit for bit, at the long-context path's shapes: R = 2 at
    DeepSeek-MoE-16B's serving step (Hkv 16, 768 packed rows, G = 1, D
    128, bf16 partials, the strided views of the step's one ragged
    launch) with rows held by shard 0 alone (bit-equal to shard 0's
    partial), rows seen by both shards and rows no shard saw (0, lse
    NEG_INF); the same with shard 1 masked everywhere (the merge is shard
    0's partial); R = 4 in f32; both schedule depths (the same bits).
    Times the path's case at each depth (CUDA graphs over buffers that
    do not fit the L2 cache) beside the plain version."""
    import torch

    from triton_distributed_tpu_torch.kernels import cp_ring
    from triton_distributed_tpu_torch.kernels.cp_ring import NEG_INF
    from triton_distributed_tpu_torch.tune.schedule import RingSchedule

    g = torch.Generator(device=dev).manual_seed(51)
    bf16 = torch.bfloat16
    tag0 = f"deepseek_moe_16b cp={LC_CP} combine"

    def exact(got, want):
        return max((a.float() - b.float()).abs().max().item()
                   for a, b in zip(got, want))

    # the path's case, at both depths, and shard 1 masked everywhere
    outs, lses = cp_partials(dev, g, LC_CP, bf16)
    hkv, tg, d = outs.shape[1:]
    want = cp_ring.cp_lse_combine_plain(outs, lses)
    for name, tpu in LC_COMBINE_ROWS.items():
        sched = RingSchedule(depth=3 if tpu.endswith("3") else 2)
        got = cp_ring.cp_lse_combine(outs, lses, schedule=sched)
        torch.cuda.synchronize()
        err = exact(got, want)
        what = (f"{tag0} R {LC_CP} x ({hkv}, {tg}, {d}) bf16 views, depth "
                f"{sched.depth} ({tpu})")
        res.check(name, err, 0.0, what + " (bit-exact)")
        own = torch.equal(got[0][:, :192], outs[0, :, :192])
        empty = bool((got[0][:, 512:] == 0).all()
                     and (got[1][:, 512:] == NEG_INF).all())
        res.check(name, 0.0 if own and empty else 1.0, 0.0,
                  what + ": shard-0 rows are shard 0's bits, unseen rows 0",
                  metric="rows differ")
        res.kernel(name, err=err)
        sets = [cp_partials(dev, g, LC_CP, bf16) for _ in range(6)]
        ms = graph_time_ms(lambda i: cp_ring.cp_lse_combine(
            *sets[i % len(sets)], schedule=sched))
        plain_ms = time_ms(lambda: cp_ring.cp_lse_combine_plain(outs, lses),
                           3)
        # every shard's partial and lse read once, the merge written once
        nbytes = (LC_CP * hkv * tg * (d * 2 + 4)) + hkv * tg * (d * 2 + 4)
        # a multiply and an add a shard and element, the division
        ops = hkv * tg * d * (2 * LC_CP + 1)
        bnd, by = bound_ms(nbytes, ops, H100_F32_OPS)
        log(f"time {name} {what} (28/step, one launch a layer): "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms=None "
            f"(no one PyTorch call merges lse-weighted partials) "
            f"bound_ms={bnd:.4f} ({by})")
        res.shape(name, 28, ms, plain_ms, None, nbytes, ops, H100_F32_OPS)
        del sets
    lses1 = lses.clone()
    lses1[1] = NEG_INF
    got = cp_ring.cp_lse_combine(outs, lses1)
    want = cp_ring.cp_lse_combine_plain(outs, lses1)
    torch.cuda.synchronize()
    err = exact(got, want)
    res.check("cp_lse_combine", err, 0.0, f"{tag0} shard 1 masked")
    res.check("cp_lse_combine", 0.0 if torch.equal(got[0][:, :512],
                                                   outs[0, :, :512]) else 1.0,
              0.0, f"{tag0} shard 1 masked: the merge is shard 0's bits",
              metric="rows differ")
    res.kernel("cp_lse_combine", err=err)
    # four shards in f32, both depths
    outs4, lses4 = cp_partials(dev, g, 4, torch.float32)
    want = cp_ring.cp_lse_combine_plain(outs4, lses4)
    for name, tpu in LC_COMBINE_ROWS.items():
        got = cp_ring.cp_lse_combine(
            outs4, lses4, schedule=RingSchedule(depth=3 if tpu.endswith("3")
                                                else 2))
        torch.cuda.synchronize()
        err = exact(got, want)
        res.check(name, err, 0.0, f"{tag0} R 4 x ({hkv}, {tg}, {d}) f32 "
                  f"({tpu})")
        res.kernel(name, err=err)


def cp_views(dev, g, n, b, s, hq, hkv, d, dtype):
    """Seeded q, k, v as the context-parallel prefill takes them: (n, B,
    S, H, D) views of one (B, n·S, (Hq + 2·Hkv)·D) projection, rank r's
    sequence block at [r·S, (r+1)·S)."""
    import torch

    qkv = torch.randn((b, n * s, (hq + 2 * hkv) * d), generator=g,
                      device=dev).to(dtype)
    q, k, v = torch.split(qkv, [hq * d, hkv * d, hkv * d], dim=-1)
    return [t.reshape(b, n, s, -1, d).transpose(0, 1) for t in (q, k, v)]


def bf16_ulps(got, want):
    """(max |got - want| in units of want's bf16 ulp where |want| >=
    2^-4, max(|got - want| - ulp(want)) everywhere). The second is what is
    left after one bf16 rounding: two f32 results within a tolerance of
    each other, each rounded once, leave at most that tolerance. Near zero
    a bf16 ulp is smaller than f32's last-bit differences, so the ulp
    count is taken only where an ulp (>= 2^-12) dwarfs them; there it
    must be at most 1."""
    import torch

    w, gt = want.float(), got.float()
    _, e = torch.frexp(w)
    ulp = torch.where(w == 0, torch.zeros_like(w),
                      torch.ldexp(torch.ones_like(w), e - 8))
    diff = (gt - w).abs()
    big = w.abs() >= 2.0 ** -4
    ulps = (diff[big] / ulp[big]).max().item() if big.any() else 0.0
    return ulps, (diff - ulp).max().item()


def attention_ops(b, h, s_q, s_k, d, causal, q0=0):
    """The flops of attention's two products over the (query, key) pairs
    the mask keeps: 4·D a pair. ``q0``: the global position of the first
    query (keys start at 0)."""
    if not causal:
        return 4.0 * d * b * h * s_q * s_k
    pairs = sum(min(q0 + t + 1, s_k) for t in range(s_q))
    return 4.0 * d * b * h * pairs


def ring_variants(res: Results, what, want, fn):
    """``fn()``, with a failure unless every ``tdt_ring_attention`` call
    it made launched the kernel ``want`` (``ring_attention_launch.
    by_variant``: ``"tma"``, ``"cp_async"`` or ``"fma"``), and at least
    one did."""
    from triton_distributed_tpu_torch.kernels import cp_ring

    by = cp_ring.ring_attention_launch.by_variant
    before = dict(by)
    out = fn()
    made = {k: c - before.get(k, 0) for k, c in by.items()
            if c != before.get(k, 0)}
    if set(made) != {want}:
        res.failures.append(f"{what}: ring attention launched {made}, "
                            f"expected only {want!r}")
    return out


def check_cp_prefill_kernels(res: Results, dev):
    """The context-parallel prefill's kernels against their plain
    versions at the path's shapes. ``tdt_ring_attention``: 4 ranks of
    Llama-2-7B's prefill (B 2, 1008 positions a rank, 32 heads, D 128,
    bf16 views of the projection) causal and not, against the plain ring
    (JAX's body step by step), and the Ulysses local shape (a ring of one
    block: 4 ranks x B 2 as 8 rows, 4032 positions, 8 heads), each within
    one bf16 ulp of the plain output where it is at least 2^-4, and
    within one ulp plus the f32 tolerance 1e-5 everywhere (both compute
    in f32 and round once); 4 ranks of 200 positions at GQA (32 q
    heads on 16 KV heads) in f32 within 1e-5. ``tdt_ulysses_a2a``: the scatter of the
    path's q view and the gather of its local output, byte-exact. Times
    each at the path's shapes beside its bound, its plain version and one
    PyTorch call: ``scaled_dot_product_attention`` over the gathered
    sequence (flash, causal) for the ring kernel, a ``copy_`` of the same
    bytes for the all-to-all; and the ring kernel's f32 form (the
    trainer's) at the ring's shape beside SDPA in f32, timed only. Every
    bf16 launch at the path's shapes must run the TMA form; the ring's
    views made 8-byte aligned run the cp.async form, held to the same
    limits and timed beside it."""
    import torch
    import torch.nn.functional as F

    from triton_distributed_tpu_torch.kernels import cp_ring
    from triton_distributed_tpu_torch.kernels import ring_attention as tra

    g = torch.Generator(device=dev).manual_seed(61)
    bf16 = torch.bfloat16
    n, b, s, h, d = CP_N, CP_B, CP_S // CP_N, 32, 128
    tag = f"llama_7b cp{n} prefill"
    scale = d ** -0.5
    # the ring at the path's shape, causal and not
    q, k, v = cp_views(dev, g, n, b, s, h, h, d, bf16)
    for causal in (True, False):
        what = (f"{tag} ring {n} x ({b}, {s}, {h}, {d}) bf16 views, "
                f"{'causal' if causal else 'full'}")
        got = ring_variants(res, what, "tma", lambda: cp_ring.
                            ring_attention_launch(q, k, v, causal=causal,
                                                  scale=scale))
        want = tra.ring_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ulps, excess = bf16_ulps(got, want)
        res.check("kv_rotate", ulps, 1.0, what + " (bf16 ulps of plain "
                  "where |plain| >= 2^-4)", metric="ulps")
        res.check("kv_rotate", excess, 1e-5, what + " (|diff| past one bf16 "
                  "ulp of plain)", metric="excess")
        res.kernel("kv_rotate", err=(got.float() - want.float()).abs()
                   .max().item())
        del got, want
    ms = ring_variants(res, f"{tag} ring timed", "tma", lambda: time_ms(
        lambda: cp_ring.ring_attention_launch(q, k, v, causal=True,
                                              scale=scale), 5))
    plain_ms = time_ms(lambda: tra.ring_attention_plain(q, k, v), 2)
    qf, kf, vf = (t.transpose(0, 1).reshape(b, n * s, h, d).transpose(1, 2)
                  .contiguous() for t in (q, k, v))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qf, kf, vf, is_causal=True), 5)
    nbytes = 4 * n * b * s * h * d * 2
    ops = sum(attention_ops(b, h, s, (r + 1) * s, d, True, r * s)
              for r in range(n))
    bnd, by = bound_ms(nbytes, ops, H100_BF16_OPS)
    log(f"time kv_rotate {tag} ring causal (32 a ring prefill, one launch a "
        f"layer for the 4 ranks): kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}"
        f" library_ms={lib_ms:.4f} (SDPA, causal, over the gathered "
        f"sequence) bound_ms={bnd:.4f} ({by}) achieved_tflops="
        f"{ops / ms / 1e9:.2f}")
    res.shape("kv_rotate", 32, ms, plain_ms, lib_ms, nbytes, ops,
              H100_BF16_OPS)
    del qf, kf, vf
    # the same views 8-byte but not 16-byte aligned (the projection 4
    # elements wider, q, k and v 4 elements in): TMA cannot take them, so
    # the kernel loads K and V by cp.async in 8-byte copies
    qkv = torch.randn((b, n * s, 3 * h * d + 4), generator=g,
                      device=dev).to(bf16)[..., 4:]
    qn, kn, vn = (t.reshape(b, n, s, -1, d).transpose(0, 1) for t in
                  torch.split(qkv, [h * d] * 3, dim=-1))
    what = f"{tag} ring, the views 8-byte aligned (cp.async), causal"
    got = ring_variants(res, what, "cp_async", lambda: cp_ring.
                        ring_attention_launch(qn, kn, vn, causal=True,
                                              scale=scale))
    want = tra.ring_attention_plain(qn, kn, vn, causal=True)
    torch.cuda.synchronize()
    ulps, excess = bf16_ulps(got, want)
    res.check("kv_rotate", ulps, 1.0, what + " (bf16 ulps of plain where "
              "|plain| >= 2^-4)", metric="ulps")
    res.check("kv_rotate", excess, 1e-5, what + " (|diff| past one bf16 ulp "
              "of plain)", metric="excess")
    del got, want
    ms_cp = ring_variants(res, what + " timed", "cp_async", lambda: time_ms(
        lambda: cp_ring.ring_attention_launch(qn, kn, vn, causal=True,
                                              scale=scale), 5))
    log(f"time kv_rotate {tag} ring causal, the views 8-byte aligned (the "
        f"cp.async form; the path's views take TMA): kernel_ms={ms_cp:.4f} "
        f"(the TMA form {ms:.4f}) achieved_tflops={ops / ms_cp / 1e9:.2f}")
    del qkv, qn, kn, vn
    # the all-to-all: the path's q out, and its local output back
    sc = cp_ring.ulysses_a2a(q, "scatter")
    ok = torch.equal(sc, cp_ring.ulysses_a2a_plain(q, "scatter"))
    ga = cp_ring.ulysses_a2a(sc, "gather")
    ok = ok and torch.equal(ga, cp_ring.ulysses_a2a_plain(sc, "gather"))
    ok = ok and torch.equal(ga, q)
    torch.cuda.synchronize()
    res.check("ulysses_a2a", 0.0 if ok else 1.0, 0.0,
              f"{tag} scatter {n} x ({b}, {s}, {h}, {d}) bf16 views and "
              "gather back, byte-exact", metric="bytes differ")
    res.kernel("ulysses_a2a", err=0.0 if ok else float("inf"))
    nbytes = 2 * q.numel() * 2
    bnd, by = bound_ms(nbytes, 0.0, H100_BF16_OPS)
    for direction, x, per_step in (("scatter", q, 3 * 32),
                                   ("gather", sc, 32)):
        ms = graph_time_ms(lambda i: cp_ring.ulysses_a2a(x, direction),
                           iters=8, reps=5)
        plain_ms = time_ms(lambda: cp_ring.ulysses_a2a_plain(x, direction)
                           .contiguous(), 5)
        src = torch.empty(x.numel(), dtype=bf16, device=dev)
        dst = torch.empty_like(src)
        lib_ms = time_ms(lambda: dst.copy_(src), 10)
        log(f"time ulysses_a2a {tag} {direction} ({per_step} a Ulysses "
            f"prefill): kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={lib_ms:.4f} (one copy_ of the same bytes) "
            f"bound_ms={bnd:.4f} ({by})")
        res.shape("ulysses_a2a", per_step, ms, plain_ms, lib_ms, nbytes, 0.0,
                  H100_BF16_OPS)
        del src, dst
    del q, k, v, sc, ga
    # Ulysses' local attention: a ring of one block, 4 ranks x B 2 rows
    hl, sfull = h // n, n * s
    ql, kl, vl = (torch.randn((1, n * b, sfull, hl, d), generator=g,
                              device=dev).to(bf16) for _ in range(3))
    what = f"{tag} Ulysses local: 1 x ({n * b}, {sfull}, {hl}, {d}) bf16, causal"
    got = ring_variants(res, what, "tma", lambda: cp_ring.
                        ring_attention_launch(ql, kl, vl, causal=True,
                                              scale=scale))
    want = tra.ring_attention_plain(ql, kl, vl, causal=True)
    torch.cuda.synchronize()
    ulps, excess = bf16_ulps(got, want)
    res.check("kv_rotate", ulps, 1.0, what + " (bf16 ulps of plain where "
              "|plain| >= 2^-4)", metric="ulps")
    res.check("kv_rotate", excess, 1e-5, what + " (|diff| past one bf16 ulp "
              "of plain)", metric="excess")
    res.kernel("kv_rotate", err=(got.float() - want.float()).abs().max()
               .item())
    del got, want
    ms = ring_variants(res, f"{tag} Ulysses local timed", "tma", lambda:
                       time_ms(lambda: cp_ring.ring_attention_launch(
                           ql, kl, vl, causal=True, scale=scale), 5))
    plain_ms = time_ms(lambda: tra.ring_attention_plain(ql, kl, vl), 2)
    qf, kf, vf = (t[0].transpose(1, 2).contiguous() for t in (ql, kl, vl))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qf, kf, vf, is_causal=True), 5)
    nbytes = 4 * ql.numel() * 2
    ops = attention_ops(n * b, hl, sfull, sfull, d, True)
    bnd, by = bound_ms(nbytes, ops, H100_BF16_OPS)
    log(f"time kv_rotate {tag} Ulysses local, one block (32 a Ulysses "
        f"prefill): kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms="
        f"{lib_ms:.4f} (SDPA, causal) bound_ms={bnd:.4f} ({by}) "
        f"achieved_tflops={ops / ms / 1e9:.2f}")
    res.shape("kv_rotate", 32, ms, plain_ms, lib_ms, nbytes, ops,
              H100_BF16_OPS)
    del ql, kl, vl, qf, kf, vf
    # f32 at a GQA shape with a partial last tile
    q, k, v = cp_views(dev, g, n, b, 200, 32, 16, d, torch.float32)
    got = ring_variants(res, f"{tag} ring f32", "fma", lambda: cp_ring.
                        ring_attention_launch(q, k, v, causal=True,
                                              scale=scale))
    want = tra.ring_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    res.check("kv_rotate", err, 1e-5, f"{tag} ring {n} x ({b}, 200, 32 on "
              f"16 KV heads, {d}) f32, causal")
    res.kernel("kv_rotate", err=err)
    del q, k, v, got, want
    # the f32 form (the trainer's, on FMA) at the ring's shape beside SDPA
    # in f32: timed only (the row is the bf16 path's)
    q, k, v = cp_views(dev, g, n, b, s, h, h, d, torch.float32)
    ms = time_ms(lambda: cp_ring.ring_attention_launch(
        q, k, v, causal=True, scale=scale), 3)
    qf, kf, vf = (t.transpose(0, 1).reshape(b, n * s, h, d).transpose(1, 2)
                  .contiguous() for t in (q, k, v))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qf, kf, vf, is_causal=True), 3)
    ops = sum(attention_ops(b, h, s, (r + 1) * s, d, True, r * s)
              for r in range(n))
    bnd, by = bound_ms(4 * q.numel() * 4, ops, H100_F32_OPS)
    log(f"time kv_rotate {tag} ring causal f32 (the FMA kernel, the "
        f"trainer's form; timed only): kernel_ms={ms:.4f} library_ms="
        f"{lib_ms:.4f} (SDPA f32, causal, over the gathered sequence) "
        f"bound_ms={bnd:.4f} ({by}, f32 rate) achieved_tflops="
        f"{ops / ms / 1e9:.2f}")
    del q, k, v, qf, kf, vf
    torch.cuda.empty_cache()


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
    from step to step); a bf16 model's world-size-1 GEMMs must all run
    the warpgroup GEMM (``wgmma``). ``expect``: {kernel: (launches a prefill,
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
    n1 = {k: counts[k] for k in ("ag_gemm_n1", "gemm_rs_n1", *MOE_TP_ROWS)
          if counts[k]}
    if cfg.dtype == torch.bfloat16 and n1:
        # the bf16 world-size-1 GEMMs (and the TP prefill's MoE-TP pair)
        # all on the warpgroup GEMM
        check_wg_forms(res, f"{name} prefill", n1)
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
    each covering the 4 ranks, all on ``wgmma``; no world-size-1 GEMM),
    the first step's
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
    check_wg_forms(res, f"{name} prefill", {
        "ag_gemm": 2 * cfg.n_layers, "gemm_rs": 2 * cfg.n_layers})
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


def run_cp_prefill_path(res: Results, dev, one):
    """The context-parallel prefill at full width and depth: the
    Llama-2-7B bf16 decode path's weights (``one``, from
    :func:`run_decode_path` with ``keep``) on a loopback mesh of 4 ranks
    at ``attn="ring"`` and ``"ulysses"`` (``wqkv`` / ``wo`` shared, the
    MLP's shards reused from the ``attn="tp"`` model's) and, as the
    oracle, at ``attn="tp"``: 2 prompts of 4032 and 2600 tokens padded to
    4032, capacity 4096. Each prefill's last-position logits must lie
    within ``CP_LOGIT_RTOL`` of the tp prefill's, and the ring prefill
    again with rank 3's attention output built without source block 0
    (:func:`_lost_ring_block`) outside it. Then ``CP_STEPS`` greedy
    decode steps in lockstep, every model fed the tp model's token: each
    step's logits within the tolerance, the tokens equal where the tp
    model's top-2 margin exceeds it (the gate of tests/test_models.py).
    A ring prefill must launch the ring kernel once a layer, a Ulysses
    prefill the all-to-all 4 times and the ring kernel once a layer (its
    TMA form every time), each
    the mesh AG-GEMM / GEMM-RS once a layer (the MLP; at 2016 rows a rank
    on the warpgroup GEMM, ``wgmma``, every time), and every decode
    step the flash decode once and the all-gather twice a layer. Returns
    {row: (launches, 1)} of the two prefills, by TPU kernel."""
    import dataclasses

    import torch

    from triton_distributed_tpu_torch.kernels import (
        cp_ring,
        launch_counts,
        launches_by_tpu_kernel,
        reset_launch_counts,
    )
    from triton_distributed_tpu_torch.models import Transformer
    from triton_distributed_tpu_torch.runtime import Mesh

    name = f"llama_7b bf16 cp{CP_N}"
    cfg = one["model"].config
    layers = cfg.n_layers
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mesh = Mesh.loopback(CP_N, dev)
    models = {"tp": Transformer(cfg, mesh=mesh)}
    params = {"tp": models["tp"].shard_params(one["params"])}
    shared = dict(one["params"], blocks=[
        dict(blk, up=tb["up"], down=tb["down"]) for blk, tb in
        zip(one["params"]["blocks"], params["tp"]["blocks"])])
    for attn in ("ring", "ulysses"):
        models[attn] = Transformer(dataclasses.replace(cfg, attn=attn),
                                   mesh=mesh)
        params[attn] = shared
    tokens = torch.randint(0, cfg.vocab, (CP_B, CP_S), generator=torch.
                           Generator(device=dev).manual_seed(31), device=dev,
                           dtype=torch.int32)
    lens = torch.tensor(CP_LENS, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    expect = {
        "tp": {"ag_gemm": 2 * layers, "gemm_rs": 2 * layers,
               "ring_attention": 0, "ulysses_a2a": 0},
        "ring": {"ag_gemm": layers, "gemm_rs": layers,
                 "ring_attention": layers, "ulysses_a2a": 0},
        "ulysses": {"ag_gemm": layers, "gemm_rs": layers,
                    "ring_attention": layers, "ulysses_a2a": 4 * layers},
    }
    totals = {row: 0 for row in CP_ROWS}
    logits, caches, kls, prefill_ms = {}, {}, {}, {}
    for attn in ("tp", "ring", "ulysses"):
        model = models[attn]
        cc = model.init_cache(CP_B, CP_CAP)
        reset_launch_counts()
        t0 = time.perf_counter()
        last, cc, kl = model.prefill(params[attn], cc, tokens, lens)
        torch.cuda.synchronize()
        prefill_ms[attn] = (time.perf_counter() - t0) * 1e3
        counts, by = launch_counts(), launches_by_tpu_kernel()
        variants = dict(cp_ring.ring_attention_launch.by_variant)
        log(f"path {name} {attn} prefill: prefill_ms={prefill_ms[attn]:.2f} "
            f"({CP_B} x {CP_S} rows, lens {list(CP_LENS)}, prefill_tok_s="
            f"{sum(CP_LENS) / prefill_ms[attn] * 1e3:.1f}) launches "
            + " ".join(f"{k}={v}" for k, v in counts.items() if v)
            + f" by TPU kernel {by} ring attention by form {variants}")
        if attn != "tp" and variants != {"tma": layers}:
            res.failures.append(f"{name} {attn}: ring attention ran "
                                f"{variants}, expected the TMA form "
                                f"{layers} times")
        for k, want in dict(expect[attn], ag_gemm_n1=0, gemm_rs_n1=0).items():
            if counts[k] != want:
                res.failures.append(f"{name} {attn}: {counts[k]} {k} "
                                    f"launches in the prefill, expected "
                                    f"{want}")
        # the mesh GEMMs at 2016 rows a rank, on wgmma
        check_wg_forms(res, f"{name} {attn} prefill", {
            k: expect[attn][k] for k in ("ag_gemm", "gemm_rs")})
        if attn != "tp":
            for row, tpu in CP_ROWS.items():
                totals[row] += by.get(tpu, 0)
        if not torch.isfinite(last).all() or not torch.equal(kl, lens):
            res.failures.append(f"{name} {attn}: non-finite prefill logits "
                                "or wrong lengths")
        logits[attn], caches[attn], kls[attn] = last, cc, kl
    ref = logits["tp"]
    tol = CP_LOGIT_RTOL * ref.abs().max().item()
    for attn in ("ring", "ulysses"):
        err = (logits[attn] - ref).abs().max().item()
        res.check(name, err, tol, f"{attn} prefill last-position logits vs "
                  f"attn=tp (max|logit| {ref.abs().max().item():.4g})")
    # the check's power: rank 3's ring output without source block 0 (the
    # last rank holds positions 3024-4031: row 0's last position)
    cc = models["ring"].init_cache(CP_B, CP_CAP)
    with _lost_ring_block(CP_N - 1):
        lost, _, _ = models["ring"].prefill(shared, cc, tokens, lens)
    del cc
    errs = (lost - ref).abs().amax(dim=-1).tolist()
    log(f"check {name} ring prefill with rank {CP_N - 1}'s source block 0 "
        f"left out: max|logits - tp| by row " + " ".join(
            f"{e:.6g}" for e in errs) + f" (tol {tol:.4g}; row 1's last "
        f"position {CP_LENS[1] - 1} lies on rank "
        f"{(CP_LENS[1] - 1) // (CP_S // CP_N)})")
    if not errs[0] > tol:
        res.failures.append(f"{name}: leaving out a ring block moves the "
                            f"logits by {errs[0]}, within the tolerance {tol}")
    # decode in lockstep, every model fed the tp model's greedy token
    compared = {a: 0 for a in ("ring", "ulysses")}
    equal = dict(compared)
    drift = {a: [] for a in compared}
    step_s = {a: 0.0 for a in models}
    dec = {a: {} for a in models}
    for i in range(CP_STEPS + 1):
        top2 = torch.topk(logits["tp"], 2, dim=-1).values
        gate = (top2[:, 0] - top2[:, 1]) > tol
        tok = torch.argmax(logits["tp"], -1).to(torch.int32)
        for a in compared:
            compared[a] += int(gate.sum())
            equal[a] += int((gate & (torch.argmax(logits[a], -1) == tok))
                            .sum())
        if i == CP_STEPS:
            break
        for a, model in models.items():
            reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits[a], caches[a], kls[a] = model.decode_step(
                params[a], caches[a], kls[a], tok)
            torch.cuda.synchronize()
            step_s[a] += time.perf_counter() - t0
            for k, v in launch_counts().items():
                dec[a][k] = dec[a].get(k, 0) + v
        for a in compared:
            drift[a].append((logits[a] - logits["tp"]).abs().max().item())
    for a in compared:
        res.check(name, max(drift[a]), tol, f"{a} teacher-forced decode "
                  f"logits vs attn=tp, {CP_STEPS} steps x {CP_B} rows")
        log(f"check {name} {a} teacher-forced: max|logits - tp| by step "
            + " ".join(f"{x:.4g}" for x in drift[a]) + f"; tokens equal on "
            f"{equal[a]}/{compared[a]} gated (row, step) pairs (gate: tp "
            f"top-2 margin > {tol:.4g}) of {CP_B * (CP_STEPS + 1)}")
        if equal[a] != compared[a]:
            res.failures.append(f"{name} {a}: {compared[a] - equal[a]} of "
                                f"{compared[a]} gated tokens differ from tp")
    for a in models:
        for k, per_step in (("flash_decode", layers),
                            ("all_gather", 2 * layers), ("ag_gemm", 0),
                            ("ring_attention", 0), ("ulysses_a2a", 0)):
            if dec[a].get(k, 0) != per_step * CP_STEPS:
                res.failures.append(f"{name} {a}: {dec[a].get(k, 0)} {k} "
                                    f"launches in {CP_STEPS} decode steps, "
                                    f"expected {per_step} a step")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"path {name} layers={layers}: setup_s={setup:.2f} prefill_ms "
        + " ".join(f"{a}={prefill_ms[a]:.2f}" for a in models)
        + " decode ms_per_step " + " ".join(
            f"{a}={step_s[a] / CP_STEPS * 1e3:.3f}" for a in models)
        + f" peak_mem_gib={peak:.2f}")
    return {row: (n, 1) for row, n in totals.items()}


def _rel_err(a, b) -> float:
    """max |a - b| / max |b| over every rank's tensor."""
    num = max((x.float() - y.float()).abs().max().item()
              for x, y in zip(a, b))
    return num / max(y.float().abs().max().item() for y in b)


def run_wire_path(res: Results, dev):
    """The tensor-parallel layers on every wire at Llama-2-7B's widths,
    tp = 4 on a loopback mesh of the card: all 32 layers' weights (bf16,
    drawn from a seed a layer) applied to the same seeded inputs, 4 x
    2048 rows of hidden 4096 (an outlier row x1000 a shard) and, for wo,
    the attention output's 4 x (8192, 1024) column shards: each layer's
    ``ColumnParallelLinear`` (wqkv), ``RowParallelLinear`` (wo) and
    ``ParallelMLP`` (up -> silu -> down) on the bf16 wire, fp8, int8 and
    int8-mxu, every wire's output within JAX's pinned relative error of
    the bf16 wire's (int8-mxu also of the int8 wire's); then the last
    layer's MLP output, on each wire, all-gathered on 'auto' over the
    ring (16 MiB a shard: fp8) within 0.06. Counts every launch of the run: each wire
    kernel must launch 32 times a layer op it carries, the plain GEMMs
    never, and every launch of the wire AG-GEMM, of the partials and of
    the bf16 wire's AG-GEMM and GEMM-RS must run the warpgroup GEMM
    (``wgmma``). Returns {kernel: launches}. On the loopback mesh no byte
    crosses a link: the run shows the wires' numerics and cost."""
    import torch

    from triton_distributed_tpu_torch import layers, ops
    from triton_distributed_tpu_torch.kernels import allgather as agk
    from triton_distributed_tpu_torch.kernels import (
        launch_counts,
        reset_launch_counts,
    )
    from triton_distributed_tpu_torch.runtime import AllGatherMethod, Mesh

    name = f"llama_7b tp{TP} wires"
    torch.cuda.empty_cache()
    mesh = Mesh.loopback(TP, dev)
    m, h, f, n_layers = DEC_B * DEC_PROMPT // TP, 4096, 11008, 32
    g = torch.Generator(device=dev).manual_seed(14)
    x = wire_operands(dev, g, (m, h), outlier=True)
    attn = wire_operands(dev, g, (TP * m, h // TP))

    def stack(wire):
        ctx = ops.OverlapContext(mesh, "tp", wire_dtype=wire)
        return (layers.ColumnParallelLinear(ctx),
                layers.RowParallelLinear(ctx),
                layers.ParallelMLP(layers.ColumnParallelLinear(ctx),
                                   layers.RowParallelLinear(ctx),
                                   activation="silu"))

    stacks = {w: stack(w) for w in WIRES}
    worst = {(w, op): 0.0 for w in WIRES[1:] for op in ("wqkv", "wo", "mlp")}
    worst.update({("twin", op): 0.0 for op in ("wqkv", "wo", "mlp")})
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    for layer in range(n_layers):
        gl = torch.Generator(device=dev).manual_seed(1000 + layer)
        p = {"wqkv": {"w": wire_operands(dev, gl, (h, 3 * h // TP),
                                         h ** -0.5)},
             "wo": {"w": wire_operands(dev, gl, (h // TP, h), h ** -0.5)},
             "mlp": {"up": {"w": wire_operands(dev, gl, (h, f // TP),
                                               h ** -0.5)},
                     "down": {"w": wire_operands(dev, gl, (f // TP, h),
                                                 f ** -0.5)}}}
        outs = {}
        for wire in WIRES:
            col, row, mlp = stacks[wire]
            outs[wire] = {"wqkv": col(p["wqkv"], x), "wo": row(p["wo"], attn),
                          "mlp": mlp(p["mlp"], x)}
        for op in ("wqkv", "wo", "mlp"):
            for wire in WIRES[1:]:
                worst[(wire, op)] = max(worst[(wire, op)], _rel_err(
                    outs[wire][op], outs[None][op]))
            worst[("twin", op)] = max(worst[("twin", op)], _rel_err(
                outs["int8-mxu"][op], outs["int8"][op]))
        last = {w: outs[w]["mlp"] for w in WIRES}
        del p, outs
    gathered = {w: agk.all_gather(last[w], mesh,
                                  method=AllGatherMethod.RING_1D,
                                  wire_dtype="auto") for w in WIRES}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    log(f"path {name}: {n_layers} layers x {len(WIRES)} wires x (wqkv, wo, "
        f"mlp) in {wall:.2f} s (weights drawn on the card inside); launches "
        + " ".join(f"{k}={v}" for k, v in counts.items() if v))
    per_wire = 2 * n_layers       # 2 AG-GEMMs and 2 GEMM-RS a layer
    # the quantizer once an AG-GEMM call on a wire and once a gather
    expect = {"ag_gemm": per_wire, "gemm_rs": per_wire,
              "wire_quantize": 3 * per_wire + len(WIRES),
              "ag_gemm_wire": 2 * per_wire, "ag_gemm_mx": per_wire,
              "gemm_rs_wire": 3 * per_wire, "gemm_rs_fold": 3 * per_wire,
              "all_gather": 0, "all_gather_wire": len(WIRES)}
    for k, v in counts.items():
        if v != expect.get(k, 0):
            res.failures.append(f"{name}: {v} {k} launches, expected "
                                f"{expect.get(k, 0)}")
    # the fp8 / int8 AG-GEMMs, every partials launch and the bf16 wire's
    # AG-GEMM and GEMM-RS on wgmma
    check_wg_forms(res, name, {e: expect[e] for e in (
        "ag_gemm_wire", "gemm_rs_wire", "ag_gemm", "gemm_rs")})
    for (wire, op), err in worst.items():
        if wire == "twin":
            res.check(name, err, WIRE_MX_TWIN_TOL, f"int8-mxu vs int8 {op} "
                      f"(worst of {n_layers} layers)", metric="max_rel_err")
            continue
        tol = (WIRE_AG_TOL if op == "wqkv" else WIRE_RS_TOL)[wire]
        res.check(name, err, tol, f"{wire} vs bf16 wire {op} (worst of "
                  f"{n_layers} layers)", metric="max_rel_err")
    for wire in WIRES:
        want = torch.cat(last[wire])
        err = _rel_err(gathered[wire], [want] * TP)
        res.check(name, err, WIRE_AG_TOL["fp8"], f"all_gather auto (fp8) of "
                  f"the {wire or 'bf16'} wire's last MLP output",
                  metric="max_rel_err")
        for r, o in enumerate(gathered[wire]):
            if not torch.equal(o[r * m:(r + 1) * m], last[wire][r]):
                res.failures.append(f"{name}: rank {r}'s own slab is not "
                                    "exact after the wire all-gather")
    return counts


@contextlib.contextmanager
def _plain_versions_raise():
    """Within the block, the MoE-TP plain versions, the plain wire
    quantizers, the grouped GEMM's, the reduce-scatter's, the
    all-to-all's, the GEMM-RS's (its int8-mxu producers too), the
    all-gathers', the ragged attention's, the cp LSE-combine's, the
    context-parallel prefill's, the KV-page ship's and the gradient
    ring's plain versions raise: a path on CUDA tensors must launch the
    kernels."""
    from triton_distributed_tpu_torch.kernels import all_to_all as a2a
    from triton_distributed_tpu_torch.kernels import allgather as agk
    from triton_distributed_tpu_torch.kernels import cp_ring as cp
    from triton_distributed_tpu_torch.kernels import gemm_rs as grs
    from triton_distributed_tpu_torch.kernels import group_gemm as gg
    from triton_distributed_tpu_torch.kernels import kv_ship as ks
    from triton_distributed_tpu_torch.kernels import moe_tp_fused as mtf
    from triton_distributed_tpu_torch.kernels import ragged_paged_attention as rpa
    from triton_distributed_tpu_torch.kernels import reduce_scatter as rs
    from triton_distributed_tpu_torch.kernels import ring_attention as tra
    from triton_distributed_tpu_torch.kernels import wire as wk
    from triton_distributed_tpu_torch.lang import wire as tw

    def boom(*a, **k):
        raise AssertionError("a plain version ran on CUDA tensors")

    names = [(mtf, n) for n in (
        "ag_group_gemm_mesh_plain", "moe_reduce_rs_mesh_plain",
        "ag_group_gemm_mesh_w_plain", "ag_group_gemm_mesh_mx_plain",
        "moe_reduce_rs_partials_plain", "moe_reduce_rs_fold_plain",
        "moe_reduce_rs_mesh_w_plain", "gemm_rs_fold_plain")]
    names += [(wk, "quantize_shards_plain"), (tw, "quantize_slab"),
              (tw, "dequantize_slab"), (gg, "grouped_matmul_plain"),
              (rs, "reduce_scatter_plain"), (rs, "gemm_rs_fold_plain"),
              (a2a, "all_to_all_plain")]
    names += [(grs, n) for n in (
        "gemm_rs_plain", "gemm_rs_fold_plain", "wire_fold_plain",
        "gemm_rs_mx_plain", "mx_partials_plain", "mxw_fold_plain",
        "gemm_rs_mx_fold_plain")]
    names += [(agk, n) for n in ("all_gather_plain", "all_gather_bidir_plain",
                                 "ll_persist_plain")]
    names += [(rpa, "ragged_paged_attention_plain"),
              (cp, "cp_lse_combine_plain"), (cp, "kv_rotate_plain"),
              (cp, "ulysses_a2a_plain"), (tra, "ring_attention_plain"),
              (tra, "dense_attention_reference"), (ks, "kv_ship_plain"),
              (cp, "grad_ring_plain"), (cp, "grad_allgather_plain")]
    saved = [(m, n, getattr(m, n)) for m, n in names]
    for m, n in names:
        setattr(m, n, boom)
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def run_moe_wire_path(res: Results, dev, n_moe: int):
    """DeepSeek-MoE-16B's TP MoE layers on every wire, tp = 4 on a
    loopback mesh of the card: the 27 MoE layers' expert weights (bf16,
    drawn from a seed a layer, freed after it) and a router a layer
    applied to the same seeded tokens, 4 x 2048 of hidden 2048 (an
    outlier token x1000 a shard); each layer's ``moe_tp_mlp_overlapped``
    (``MoETPContext(mesh=, wire_dtype=)``) on the bf16 wire, fp8, int8
    and int8-mxu, every wire's output within JAX's pinned reduce-wire
    limit of the bf16 wire's (int8-mxu also within the twin limit of the
    int8 wire's), its up projection within the AG-wire limit. Counts
    every launch of the run with the plain versions made to raise: a
    layer launches the quantizer, the AG kernel, the partials and the
    fold once on each quantized wire, the two mesh kernels on bf16; every
    launch of the fp8 / int8 AG, of the partials and of the bf16 pass's two
    mesh kernels must take the grouped warpgroup GEMM (``wgmma``). Returns
    {kernel: launches}. On the
    loopback mesh no byte crosses a link: the run shows the wires'
    numerics and cost."""
    import torch

    from triton_distributed_tpu_torch import ops
    from triton_distributed_tpu_torch.kernels import (
        launch_counts,
        reset_launch_counts,
    )
    from triton_distributed_tpu_torch.ops import moe_tp
    from triton_distributed_tpu_torch.runtime import Mesh

    name = f"deepseek_moe_16b tp{TP} moe wires"
    torch.cuda.empty_cache()
    mesh = Mesh.loopback(TP, dev)
    g = torch.Generator(device=dev).manual_seed(16)
    x = moe_wire_tokens(dev, g)
    ctx = {w: ops.MoETPContext(num_experts=MOE_E, topk=MOE_K,
                               block_m=MOE_TP_BM, dtype=torch.bfloat16,
                               mesh=mesh, wire_dtype=w) for w in WIRES}
    ups = {}
    fused = moe_tp.ag_group_gemm_fused

    def recorded(x_, routing, w, c):
        ups[c.wire_dtype] = fused(x_, routing, w, c)
        return ups[c.wire_dtype]

    worst = {(w, op): 0.0 for w in (*WIRES[1:], "twin")
             for op in ("up", "mlp")}
    call_ms = {w: 0.0 for w in WIRES}
    # the most device memory a call allocated above what it found (MiB)
    peak_mib = {w: 0.0 for w in WIRES}
    torch.cuda.synchronize()
    reset_launch_counts()
    clear_wg_forms("ag_group_gemm_wire", "moe_reduce_rs_wire",
                   *MOE_MESH_ROWS)
    t0 = time.perf_counter()
    moe_tp.ag_group_gemm_fused = recorded
    try:
        with _plain_versions_raise():
            for layer in range(n_moe):
                gl = torch.Generator(device=dev).manual_seed(2000 + layer)
                wts, ids, w_up, w_down = moe_wire_layer(dev, gl, x)
                outs, ev = {}, []
                for wire in WIRES:
                    ev.append(torch.cuda.Event(enable_timing=True))
                    ev[-1].record()
                    base = torch.cuda.memory_allocated(dev)
                    torch.cuda.reset_peak_memory_stats(dev)
                    outs[wire] = ops.moe_tp_mlp_overlapped(
                        x, ids, wts, w_up, w_down, ctx[wire])
                    peak_mib[wire] = max(peak_mib[wire], (
                        torch.cuda.max_memory_allocated(dev) - base) / 2**20)
                ev.append(torch.cuda.Event(enable_timing=True))
                ev[-1].record()
                torch.cuda.synchronize()
                for i, wire in enumerate(WIRES):
                    call_ms[wire] += ev[i].elapsed_time(ev[i + 1])
                for wire in WIRES[1:]:
                    worst[(wire, "up")] = max(worst[(wire, "up")], _rel_err(
                        ups[wire], ups[None]))
                    worst[(wire, "mlp")] = max(worst[(wire, "mlp")],
                                               _rel_err([outs[wire]],
                                                        [outs[None]]))
                worst[("twin", "up")] = max(worst[("twin", "up")], _rel_err(
                    ups["int8-mxu"], ups["int8"]))
                worst[("twin", "mlp")] = max(worst[("twin", "mlp")],
                                             _rel_err([outs["int8-mxu"]],
                                                      [outs["int8"]]))
                if not all(o.isfinite().all() for o in outs.values()):
                    res.failures.append(f"{name}: layer {layer} has "
                                        "non-finite outputs")
                ups.clear()
                del wts, ids, w_up, w_down, outs
    finally:
        moe_tp.ag_group_gemm_fused = fused
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    log(f"path {name}: {n_moe} layers x {len(WIRES)} wires in {wall:.2f} s "
        "(weights drawn on the card inside); the calls on the device's "
        "clock, a pass over the layers: " + " ".join(
            f"{w or 'bf16'}={call_ms[w]:.2f} ms" for w in WIRES)
        + "; a call's peak device memory above what it found: " + " ".join(
            f"{w or 'bf16'}={peak_mib[w]:.1f} MiB" for w in WIRES)
        + "; launches " + " ".join(f"{k}={v}" for k, v in counts.items()
                                   if v))
    expect = {"ag_group_gemm_mesh": n_moe, "moe_reduce_rs_mesh": n_moe,
              "wire_quantize": 3 * n_moe, "ag_group_gemm_wire": 2 * n_moe,
              "ag_group_gemm_mx": n_moe, "moe_reduce_rs_wire": 3 * n_moe,
              "moe_reduce_rs_fold": 3 * n_moe}
    for k, v in counts.items():
        if v != expect.get(k, 0):
            res.failures.append(f"{name}: {v} {k} launches, expected "
                                f"{expect.get(k, 0)}")
    check_wg_forms(res, name, {"ag_group_gemm_wire": 2 * n_moe,
                               "moe_reduce_rs_wire": 3 * n_moe,
                               "ag_group_gemm_mesh": n_moe,
                               "moe_reduce_rs_mesh": n_moe})
    for (wire, op), err in worst.items():
        if wire == "twin":
            tol, what = WIRE_MX_TWIN_TOL, f"int8-mxu vs int8 {op}"
        else:
            tol = (WIRE_AG_TOL if op == "up" else
                   WIRE_RS_TOL)[wire]
            what = f"{wire} vs bf16 wire {op}"
        res.check(name, err, tol, f"{what} (worst of {n_moe} layers)",
                  metric="max_rel_err")
    return counts


def run_collectives_path(res: Results, dev, n_moe: int):
    """DeepSeek-MoE-16B's MoE layers over the collectives, tp = 4 on a
    loopback mesh of the card, the 27 MoE layers' weights (bf16, drawn
    from a seed a layer, a router each, freed after it), the plain
    versions made to raise:

    (a) the composed MoE-TP, ``MoETPMLP(fused=False)`` (``ag_group_gemm``
    → silu → ``moe_reduce_rs``, whose stacked partials go through the
    reduce-scatter) on 4 x 2048 tokens (the stream engine) and 4 x 256
    (the VMEM ring), each layer against ``MoETPMLP(fused=True)`` and
    ``moe_tp_mlp_overlapped`` on the same weights within COMPOSED_TOL;
    the 4 x 2048 partials reduced once more at
    ``RingSchedule(depth=3)``, bit-equal; the last layer's partials on
    the fp8, int8 and 'auto' wires (and on the stream at depth 3 too),
    each within JAX's pinned reduce-wire limit of the raw wire's result;

    (b) EP on the padded-slot transport: ``EPMoEMLP`` with
    ``transport="pallas"`` on 4 x 2048 tokens as served (fp8 wire, W8A8
    experts) and in bf16 (no wire quantization, bf16 experts), against
    the fused transport on the same weights within EP_PALLAS_TOL; the
    fused context at ``max_m`` 4096 (below M·topk, 12288) demoted to the
    padded slots, two all-to-alls a layer; and ``EPAll2AllLayer``
    dispatch → identity → combine on the last layer's routing, byte for
    byte.

    Each variant is timed with CUDA events, a pass over the layers. On
    the loopback mesh no byte crosses a link: the path shows numerics and
    the kernels' cost. Returns {kernel: launches}."""
    import torch

    from triton_distributed_tpu_torch import layers, ops
    from triton_distributed_tpu_torch.kernels import (
        launch_counts,
        launches_by_tpu_kernel,
        reset_launch_counts,
    )
    from triton_distributed_tpu_torch.kernels import moe_dispatch as md
    from triton_distributed_tpu_torch.kernels import moe_utils as mu
    from triton_distributed_tpu_torch.kernels import reduce_scatter as rs
    from triton_distributed_tpu_torch.kernels.group_gemm import (
        quantize_grouped_weights,
    )
    from triton_distributed_tpu_torch.ops import moe_tp
    from triton_distributed_tpu_torch.runtime import Mesh
    from triton_distributed_tpu_torch.tune import RingSchedule

    name = f"deepseek_moe_16b tp{TP} collectives"
    bf16 = torch.bfloat16
    torch.cuda.empty_cache()
    mesh = Mesh.loopback(TP, dev)
    g = torch.Generator(device=dev).manual_seed(31)
    xs = {"stream": coll_tokens(dev, g, COLL_BIG),
          "vmem": coll_tokens(dev, g, COLL_SMALL)}
    ctx = ops.MoETPContext(num_experts=MOE_E, topk=MOE_K, block_m=MOE_TP_BM,
                           dtype=bf16, mesh=mesh)
    composed = layers.MoETPMLP(ctx, fused=False)
    single = layers.MoETPMLP(ctx, fused=True)
    recorded = {}
    real_rs = moe_tp.reduce_scatter

    def recording(parts, *a, **k):
        recorded["parts"] = parts
        recorded["out"] = real_rs(parts, *a, **k)
        return recorded["out"]

    def timed(fns):
        """Run ``fns`` in order between CUDA events → (results, ms each)."""
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(fns) + 1)]
        ev[0].record()
        outs = []
        for i, fn in enumerate(fns):
            outs.append(fn())
            ev[i + 1].record()
        torch.cuda.synchronize()
        return outs, [ev[i].elapsed_time(ev[i + 1]) for i in range(len(fns))]

    pass_ms, worst = {}, {}
    same_d3, wire_err = True, {}
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    moe_tp.reduce_scatter = recording
    try:
        with _plain_versions_raise():
            for layer in range(n_moe):
                gl = torch.Generator(device=dev).manual_seed(3000 + layer)
                gate, up, down = coll_layer(dev, gl)
                w_up, w_down = tp_shards(up, down)
                del up, down
                p = {"up": w_up, "down": w_down}
                for size, x in xs.items():
                    wts, ids = mu.select_experts(x.float() @ gate, MOE_K)
                    fns = [lambda: composed(p, x, ids, wts),
                           lambda: single(p, x, ids, wts),
                           lambda: ops.moe_tp_mlp_overlapped(
                               x, ids, wts, w_up, w_down, ctx)]
                    if size == "stream":
                        fns.append(lambda: rs.reduce_scatter(
                            recorded["parts"], mesh, stacked=True,
                            schedule=RingSchedule(depth=3)))
                    outs, ms = timed(fns)
                    for key, t in zip(("composed", "fused", "overlapped",
                                       "depth3 rs"), ms):
                        pass_ms[(size, key)] = pass_ms.get((size, key),
                                                           0.0) + t
                    for ref, o in (("fused", outs[1]),
                                   ("overlapped", outs[2])):
                        worst[(size, ref)] = max(worst.get((size, ref), 0.0),
                                                 _rel_err([outs[0]], [o]))
                    if size == "stream":
                        same_d3 &= all(torch.equal(a, b) for a, b in
                                       zip(outs[3], recorded["out"]))
                    if not all(o.isfinite().all() for o in outs[:3]):
                        res.failures.append(f"{name}: layer {layer} {size} "
                                            "has non-finite outputs")
                    if layer == n_moe - 1:
                        wires = [("fp8", None), ("int8", None), ("auto", None)]
                        if size == "stream":
                            wires += [("fp8", RingSchedule(depth=3)),
                                      ("int8", RingSchedule(depth=3))]
                        for wire, sched in wires:
                            out = rs.reduce_scatter(
                                recorded["parts"], mesh, stacked=True,
                                wire_dtype=wire, schedule=sched)
                            wire_err[(size, wire, sched is not None)] = \
                                _rel_err(out, recorded["out"])
                    del outs
                del p, w_up, w_down, gate
    finally:
        moe_tp.reduce_scatter = real_rs
    torch.cuda.synchronize()
    wall_a = time.perf_counter() - t0
    counts_a, by_a = launch_counts(), dict(launches_by_tpu_kernel())
    recorded.clear()
    log(f"path {name} (a) composed MoE-TP: {n_moe} layers x 2 sizes in "
        f"{wall_a:.2f} s (weights drawn on the card inside); a pass over "
        "the layers on the device's clock (no byte crosses a link on the "
        "loopback mesh): " + " ".join(
            f"{size}:{key}={t:.2f} ms" for (size, key), t in pass_ms.items())
        + "; reduce-scatters by TPU kernel " + json.dumps(by_a)
        + "; launches " + " ".join(f"{k}={v}" for k, v in counts_a.items()
                                   if v))
    expect = {"reduce_scatter": 3 * n_moe, "reduce_scatter_fold": 8,
              "ag_group_gemm_mesh": 2 * n_moe,
              "moe_reduce_rs_mesh": 2 * n_moe,
              "ggemm_bf16": 2 * 2 * 2 * TP * n_moe}
    for k, v in counts_a.items():
        if v != expect.get(k, 0):
            res.failures.append(f"{name} (a): {v} {k} launches, expected "
                                f"{expect.get(k, 0)}")
    want_by = {"_rs_stream_kernel": n_moe, "_ring_rs_kernel": n_moe,
               "_rs_stream_kernel3": n_moe, "_rs_stream_kernel_w": 3,
               "_rs_stream_kernel_w3": 2, "_ring_rs_kernel_w": 3}
    if by_a != want_by:
        res.failures.append(f"{name} (a): reduce-scatters by TPU kernel "
                            f"{by_a}, expected {want_by}")
    if not same_d3:
        res.failures.append(f"{name} (a): depth 3 differs from depth 2")
    for (size, ref), err in worst.items():
        res.check(name, err, COMPOSED_TOL, f"(a) composed vs {ref} {size} "
                  f"engine (worst of {n_moe} layers)", metric="max_rel_err")
    for (size, wire, d3), err in wire_err.items():
        tol = WIRE_RS_TOL["fp8" if wire == "auto" else wire]
        res.check(name, err, tol, f"(a) reduce_scatter {wire} wire "
                  f"{'depth 3 ' if d3 else ''}{size} vs the raw wire (the "
                  "last layer's partials)", metric="max_rel_err")

    # (b) EP on the padded-slot transport
    x = xs["stream"]
    del xs

    def ep(transport, served, max_m=COLL_BIG * MOE_K):
        return layers.EPMoEMLP(ops.create_ep_moe_context(
            num_experts=MOE_E, topk=MOE_K, max_m=max_m, hidden=MOE_H,
            dtype=bf16, block_m=MOE_TP_BM, quant="fp8" if served else None,
            act_quant="int8" if served else None, mesh=mesh,
            transport=transport))

    runs = {("served", "pallas"): ep("pallas", True),
            ("served", "fused"): ep("fused", True),
            ("bf16", "pallas"): ep("pallas", False),
            ("bf16", "fused"): ep("fused", False),
            ("served", "demoted"): ep("fused", True, COLL_DEMOTED_M)}
    ep_ms = {k: 0.0 for k in runs}
    gap = {"served": 0.0, "bf16": 0.0}
    demoted_a2a, layer_exact = 0, False
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with _plain_versions_raise():
        for layer in range(n_moe):
            gl = torch.Generator(device=dev).manual_seed(4000 + layer)
            gate, up, down = coll_layer(dev, gl)
            params = {"bf16": {"router": gate, "up": up, "down": down}}
            uq, us = quantize_grouped_weights(up, k_major=True)
            dq, ds = quantize_grouped_weights(down, k_major=True)
            params["served"] = {"router": gate, "up": {"q": uq, "scale": us},
                                "down": {"q": dq, "scale": ds}}
            outs = {}
            for key, mlp in runs.items():
                before = launch_counts()["all_to_all"]
                (outs[key],), (ms,) = timed([lambda: mlp(params[key[0]], x)])
                ep_ms[key] += ms
                if key[1] == "demoted":
                    demoted_a2a += launch_counts()["all_to_all"] - before
            for kind in gap:
                gap[kind] = max(gap[kind], _rel_err(
                    [outs[(kind, "pallas")]], [outs[(kind, "fused")]]))
            if not all(o.isfinite().all() for o in outs.values()):
                res.failures.append(f"{name} (b): layer {layer} has "
                                    "non-finite outputs")
            if layer == n_moe - 1:
                # the dispatch / combine pair around identity experts
                a2a = runs[("bf16", "pallas")].ctx.a2a
                _, ids = mu.select_experts(x.float() @ gate, MOE_K)
                flat_e = ids.reshape(TP, -1)
                order = torch.argsort(flat_e, dim=1, stable=True)
                rows = md._take_rows(x.reshape(TP, -1, MOE_H), order // MOE_K)
                splits = torch.zeros((TP, MOE_E), dtype=torch.int32,
                                     device=dev)
                splits.scatter_add_(1, flat_e.long(), torch.ones_like(flat_e))
                layer_ = layers.EPAll2AllLayer(a2a)
                toks, _ = layer_.dispatch(rows, splits)
                back = layer_.combine(toks, splits, rows.shape[1])
                torch.cuda.synchronize()
                layer_exact = torch.equal(back, rows)
                del toks, back, rows
            del params, outs, up, down, uq, dq
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    counts_b = launch_counts()
    log(f"path {name} (b) EP padded slots: {n_moe} layers x {len(runs)} runs "
        f"in {wall_b:.2f} s (weights drawn and quantized on the card "
        "inside); a pass over the layers on the device's clock (no byte "
        "crosses a link on the loopback mesh): " + " ".join(
            f"{k[0]}:{k[1]}={t:.2f} ms" for k, t in ep_ms.items())
        + f"; pallas vs fused gap served={gap['served']:.6g} bf16="
        f"{gap['bf16']:.6g} ({'both 0' if max(gap.values()) == 0 else 'not 0'}); "
        f"the demoted runs launched {demoted_a2a} all-to-alls; launches "
        + " ".join(f"{k}={v}" for k, v in counts_b.items() if v))
    for kind, err in gap.items():
        res.check(name, err, EP_PALLAS_TOL, f"(b) pallas vs fused transport "
                  f"{kind} (worst of {n_moe} layers)", metric="max_rel_err")
    if demoted_a2a != 2 * n_moe:
        res.failures.append(f"{name} (b): the demoted fused context launched "
                            f"{demoted_a2a} all-to-alls, expected "
                            f"{2 * n_moe}")
    expect = {"all_to_all": 6 * n_moe + 2, "chunked_a2a_mesh": 4 * n_moe}
    for k in ("all_to_all", "chunked_a2a_mesh", "reduce_scatter",
              "reduce_scatter_fold"):
        if counts_b[k] != expect.get(k, 0):
            res.failures.append(f"{name} (b): {counts_b[k]} {k} launches, "
                                f"expected {expect.get(k, 0)}")
    if not layer_exact:
        res.failures.append(f"{name} (b): EPAll2AllLayer did not return the "
                            "sorted tokens byte for byte")
    return {k: counts_a[k] + counts_b[k] for k in COLL_ROWS}


def run_step4_path(res: Results, dev):
    """The step-4 path through the entry points a user calls, with the
    plain versions made to raise: ``RowParallelLinear`` on an
    ``OverlapContext(wire_dtype='int8-mxu')`` (no method: JAX's fused
    engine) at N 1024 and 512, the s8 producer with the accumulator
    epilogue, and ``gemm_rs(..., schedule=GridSchedule(epilogue=
    'readback'))`` on the same operands; each within JAX's pinned
    int8-mxu limits of the exact product and of the int8 wire. At N 2048
    the row layer's int8-mxu is the int8 wire bit for bit (the
    demotion). Then ``all_gather(method=None)`` of Llama-2-7B's last MLP
    output at tp = 4 (the bidirectional ring; also at split8 2, 4, 6) and
    32 calls of ``PersistentLLAllGather`` at the decode's partial shape,
    byte-exact, the workspace windows holding the last two calls' rows.
    Counts every launch of the run. Returns {kernel: launches}."""
    import torch

    from triton_distributed_tpu_torch import layers, ops
    from triton_distributed_tpu_torch.kernels import allgather as agk
    from triton_distributed_tpu_torch.kernels import gemm_rs as grs
    from triton_distributed_tpu_torch.kernels import (
        launch_counts,
        launches_by_tpu_kernel,
        reset_launch_counts,
    )
    from triton_distributed_tpu_torch.runtime import AllGatherMethod, Mesh
    from triton_distributed_tpu_torch.tune.schedule import (
        GridSchedule,
        RingSchedule,
    )

    name = f"step4 tp{TP}"
    torch.cuda.empty_cache()
    mesh = Mesh.loopback(TP, dev)
    g = torch.Generator(device=dev).manual_seed(41)
    row = {w: layers.RowParallelLinear(ops.OverlapContext(mesh, "tp",
                                                          wire_dtype=w))
           for w in ("int8-mxu", "int8")}
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    errs = []
    for n in (*STEP4_NS, STEP4_DEMOTED):
        a, b = step4_operands(dev, g, n)
        p = {"w": b}
        mxw = row["int8-mxu"](p, a)
        int8 = row["int8"](p, a)
        if n == STEP4_DEMOTED:
            if not all(torch.equal(x, y) for x, y in zip(mxw, int8)):
                res.failures.append(f"{name}: int8-mxu at N {n} is not the "
                                    "int8 wire bit for bit")
            del a, b, p, mxw, int8
            continue
        mxr = grs.gemm_rs(a, b, mesh, wire_dtype="int8-mxu",
                          schedule=GridSchedule(epilogue="readback"))
        exact = sum(aq.float() @ bq.float() for aq, bq in zip(a, b))
        exact = list(exact.chunk(TP, dim=0))
        for epi, out in (("accumulator", mxw), ("readback", mxr)):
            errs.append((n, epi, _rel_err(out, exact), _rel_err(out, int8)))
        del a, b, p, mxw, int8, mxr, exact
    x = wire_operands(dev, g, STEP4_AG_SHAPE)
    want = torch.cat(x)
    gathered = [agk.all_gather(x, mesh)]
    gathered += [agk.all_gather(x, mesh, method=AllGatherMethod.RING_BIDIR,
                                schedule=RingSchedule(split8=s))
                 for s in STEP4_SPLITS[1:]]
    ll = agk.PersistentLLAllGather(mesh, "tp", STEP4_LL_SHAPE, torch.bfloat16)
    calls = [wire_operands(dev, g, STEP4_LL_SHAPE)
             for _ in range(STEP4_LL_CALLS)]
    outs = [ll(c) for c in calls]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    by_tpu = launches_by_tpu_kernel()
    log(f"path {name}: int8-mxu GEMM-RS at N {STEP4_NS} x 2 epilogues and "
        f"{STEP4_DEMOTED} (demoted), {len(gathered)} bidirectional gathers, "
        f"{STEP4_LL_CALLS} persistent LL calls in {wall:.2f} s; launches "
        + " ".join(f"{k}={v}" for k, v in counts.items() if v)
        + f"; by TPU kernel {by_tpu}")
    nn = len(STEP4_NS)
    expect = {"gemm_rs_mx": 2 * nn, "gemm_rs_mxw_fold": nn,
              "gemm_rs_mxr_fold": nn, "all_gather_bidir": len(STEP4_SPLITS),
              "all_gather_persist": STEP4_LL_CALLS,
              "wire_quantize": 2 * nn,
              "gemm_rs_wire": nn + 2, "gemm_rs_fold": nn + 2}
    for k, v in counts.items():
        if v != expect.get(k, 0):
            res.failures.append(f"{name}: {v} {k} launches, expected "
                                f"{expect.get(k, 0)}")
    if by_tpu != {"_fused_kernel_mxw": nn, "_fused_kernel_mxr": nn}:
        res.failures.append(f"{name}: the s8 partials stood for {by_tpu}")
    for n, epi, to_exact, to_int8 in errs:
        res.check(name, to_exact, MX_EXACT_TOL, f"int8-mxu {epi} N {n} vs "
                  "the exact product", metric="max_rel_err")
        res.check(name, to_int8, MX_TWIN_TOL, f"int8-mxu {epi} N {n} vs the "
                  "int8 wire", metric="max_rel_err")
    bad = sum(not torch.equal(o, want) for got in gathered for o in got)
    res.check(name, bad, 0, f"all_gather {TP} x {STEP4_AG_SHAPE} bf16 "
              f"(method None and split8 {STEP4_SPLITS[1:]}) vs torch.cat",
              metric="ranks differ")
    bad = sum(not torch.equal(o, torch.cat(c))
              for c, got in zip(calls, outs) for o in got)
    rows = TP * STEP4_LL_SHAPE[0]
    last = {(len(calls) - 1) % 2: calls[-1], len(calls) % 2: calls[-2]}
    bad_ws = sum(not torch.equal(ws[w * rows:(w + 1) * rows],
                                 torch.cat(last[w]))
                 for ws in ll.workspace for w in (0, 1))
    res.check(name, bad, 0, f"PersistentLLAllGather {STEP4_LL_CALLS} calls "
              "vs torch.cat", metric="outputs differ")
    res.check(name, bad_ws, 0, "PersistentLLAllGather windows vs the last "
              "two calls' rows", metric="windows differ")
    return counts


def longcontext_trace(vocab, seed=23):
    """The long-context path's trace: 7 requests of 128-512 prompt tokens
    and 32 new at step 0, then one of LC_LONG prompt tokens and 64 new
    (rid 0) at step 1."""
    from triton_distributed_tpu_torch.serving import Request

    rng = np.random.default_rng(seed)
    reqs = [Request(rid=0, prompt=rng.integers(0, vocab, LC_LONG).astype(
        np.int32), max_new=LC_LONG_NEW, arrival=1.0)]
    for i in range(LC_SHORTS):
        n = int(rng.integers(LC_SHORT_LO, LC_SHORT_HI))
        reqs.append(Request(rid=i + 1, prompt=rng.integers(
            0, vocab, n).astype(np.int32), max_new=LC_SHORT_NEW))
    return reqs


class _LongRecorder(_CheckedEngine):
    """Mixin: the long request's logits each time it samples, by the
    number of tokens it had generated, and its block-table row at its
    first decode."""

    def _advance_row(self, s, req, take, logits):
        if req.rid == 0 and req.cursor + take == len(req.seq):
            self.long_logits.setdefault(len(req.generated),
                                        np.array(logits[s]))
            if not req.generated:
                self.long_row = self.table[s].copy()
        return super()._advance_row(s, req, take, logits)


def run_longcontext_path(res: Results, dev):
    """Long-context serving through the entry points a user calls, with
    the plain versions made to raise: DeepSeek-MoE-16B at full width and
    depth (28 layers, 64 experts top-6 on the fp8 EP wire, W8A8, int8 KV)
    served by ``ServingEngine`` on ``Transformer(cfg, mesh=Mesh.grid(
    {"tp": 1, "cp": 2}), cp_axis="cp")`` with 160 pages of 16 a shard
    (2560 positions a shard, 5120 in all), and the same weights at cp = 1
    on one pool of 320 pages (the oracle). The long request must cross
    the shard boundary; the short requests' streams must equal the
    oracle's byte for byte; the long request's first-decode logits must
    lie within LC_LOGIT_RTOL of the oracle's, and its tokens equal the
    oracle's up to the first step whose oracle top-2 margin is within
    that tolerance; the same trace replayed up to that first decode with
    shard 1's partial dropped from every merge must break the
    tolerance, and replayed at schedule depth 3 must give the same
    logits bit for bit. The combine launches once a layer and step, and
    so does the ragged kernel (one launch walks both shards). Returns
    {row: (launches, steps)} for the two combine rows."""
    import functools

    import torch

    from triton_distributed_tpu_torch.kernels import (
        cp_ring,
        launch_counts,
        launches_by_tpu_kernel,
        reset_launch_counts,
    )
    from triton_distributed_tpu_torch.models import Transformer, presets
    from triton_distributed_tpu_torch.runtime import Mesh
    from triton_distributed_tpu_torch.serving import (
        CpPagePool,
        EngineConfig,
        ServingEngine,
    )
    from triton_distributed_tpu_torch.tune.schedule import RingSchedule

    cfg = presets.deepseek_moe_16b()
    name = f"deepseek_moe_16b cp{LC_CP}"
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    flat = Transformer(cfg, device=dev)
    params = flat.init(torch.Generator(device=dev).manual_seed(0),
                       quantize=True)
    cpm = Transformer(cfg, mesh=Mesh.grid({"tp": 1, "cp": LC_CP}, dev),
                      cp_axis="cp")
    Engine = type("Engine", (_LongRecorder, ServingEngine), {})

    def engine(model, npages):
        eng = Engine(model, params, EngineConfig(
            slots=LC_SLOTS, token_budget=512, chunk=256, page=16,
            npages=npages))
        eng.long_logits, eng.long_row = {}, None
        return eng

    torch.cuda.synchronize()
    log(f"path {name}: setup_s={time.perf_counter() - t0:.2f} (one set of "
        f"weights for cp = {LC_CP} and the cp = 1 oracle)")
    runs = {}
    for tag, model, npages in (("cp", cpm, LC_NPAGES),
                               ("oracle", flat, LC_CP * LC_NPAGES)):
        eng = engine(model, npages)
        trace = longcontext_trace(cfg.vocab)
        torch.cuda.synchronize()
        reset_launch_counts()
        t1 = time.perf_counter()
        stats = eng.run(trace)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        counts, by_tpu = launch_counts(), launches_by_tpu_kernel()
        steps = len(stats.step_times)
        runs[tag] = (eng, trace, counts, by_tpu, steps)
        log(f"path {name} {tag}: pool {eng.pool.npages} pages "
            f"({type(eng.pool).__name__}) completed={stats.completed}/"
            f"{len(trace)} steps={steps} evictions={stats.evictions} "
            f"generated_tokens={stats.generated_tokens} wall_s={wall:.2f} "
            f"ms_per_step={1e3 * wall / max(steps, 1):.2f} "
            f"p50_step_ms={stats.p50_step_ms:.2f} p99_step_ms="
            f"{stats.p99_step_ms:.2f} tok_s="
            f"{stats.generated_tokens / wall:.2f}")
        log(f"launches {name} {tag} " + " ".join(
            f"{k}={v} ({v / max(steps, 1):g}/step)"
            for k, v in counts.items() if v) + f"; by TPU kernel {by_tpu}")
        if stats.completed != len(trace):
            res.failures.append(f"{name} {tag}: {stats.completed}/"
                                f"{len(trace)} requests completed")
        if eng.bad_rows:
            res.failures.append(f"{name} {tag}: {eng.bad_rows} rows of "
                                "non-finite logits")
        for k in PATH_KERNELS["deepseek_moe_16b"]:
            if counts[k] == 0:
                res.failures.append(f"{name} {tag}: {k} never launched")
        layers_steps = cfg.n_layers * steps
        want = {"cp_lse_combine": layers_steps if tag == "cp" else 0,
                "ragged_paged_attention": layers_steps}
        for k, v in want.items():
            if counts[k] != v:
                res.failures.append(f"{name} {tag}: {counts[k]} {k} "
                                    f"launches, expected {v} (28 a step)")
    eng, trace, counts, by_tpu, steps = runs["cp"]
    oeng, otrace, _, _, _ = runs["oracle"]
    if not isinstance(eng.pool, CpPagePool):
        res.failures.append(f"{name}: the engine's pool is not a CpPagePool")
    # the long request crossed the shard boundary: its columns past the
    # first shard's hold pages of shard 1
    pps = eng.state.pages_per_shard
    row = eng.long_row if eng.long_row is not None else np.full(1, -1)
    far = [int(p) for p in row[pps:] if p >= 0]
    crossed = bool(far) and all(eng.pool.shard_of(p) == 1 for p in far)
    res.check(name, 0.0 if crossed else 1.0, 0.0, f"the long request's "
              f"{int((row >= 0).sum())} pages at its first decode cross "
              f"the {pps}-page shard ({len(far)} on shard 1)",
              metric="not crossed")
    short_bad = sum(a.generated != b.generated
                    for a, b in zip(trace[1:], otrace[1:]))
    res.check(name, short_bad, 0, f"the {LC_SHORTS} short requests' token "
              "streams vs the cp = 1 oracle (byte for byte)",
              metric="streams differ")
    ref = oeng.long_logits.get(0)
    first = eng.long_logits.get(0)
    scale = float(np.abs(ref).max())
    err = float(np.abs(first - ref).max()) / scale
    res.check(name, err, LC_LOGIT_RTOL, "the long request's first-decode "
              "logits vs the oracle's, relative to its largest",
              metric="max_rel_err")
    # its tokens equal the oracle's up to the oracle's first step whose
    # top-2 margin lies within the tolerance
    got, want = trace[0].generated, otrace[0].generated
    held = 0
    for i, (a, b) in enumerate(zip(got, want)):
        lg = oeng.long_logits[i]
        top2 = np.sort(lg)[-2:]
        if top2[1] - top2[0] <= LC_LOGIT_RTOL * float(np.abs(lg).max()):
            break
        if a != b:
            res.failures.append(f"{name}: long token {i} is {a}, the "
                                f"oracle's {b}, at a top-2 margin above "
                                "the tolerance")
            break
        held += 1
    log(f"check {name} long stream: {held} of {len(want)} tokens held "
        f"(equal where the oracle's margin exceeds the tolerance); "
        f"{sum(a == b for a, b in zip(got, want))} equal in all")
    # replays up to the long request's first decode: shard 1's partial
    # dropped from every merge, then schedule depth 3
    orig = cp_ring.cp_lse_combine

    def replay(combine):
        cp_ring.cp_lse_combine = combine
        try:
            e = engine(cpm, LC_NPAGES)
            e.submit_trace(longcontext_trace(cfg.vocab))
            reset_launch_counts()
            while 0 not in e.long_logits and e.step_count < 2 * steps:
                e.step()
            torch.cuda.synchronize()
        finally:
            cp_ring.cp_lse_combine = orig
        if 0 not in e.long_logits:
            res.failures.append(f"{name}: a replay never reached the long "
                                "request's first decode")
            e.long_logits[0] = np.full_like(ref, np.nan)
        return e.long_logits[0], launches_by_tpu_kernel(), len(
            e.stats.step_times)

    def dropped(outs, lses, **kw):
        return orig(outs[:1], lses[:1], **kw)

    wrong, _, _ = replay(dropped)
    bad = float(np.abs(wrong - ref).max()) / scale
    res.check(name, -bad, -LC_LOGIT_RTOL, "shard 1's partial dropped from "
              f"every merge must break the tolerance (max_rel_err={bad:.6g})",
              metric="-max_rel_err")
    deep, deep_tpu, deep_steps = replay(functools.partial(
        orig, schedule=RingSchedule(depth=3)))
    same = np.array_equal(deep, first)
    res.check(name, 0.0 if same else 1.0, 0.0, "the first decode at "
              "schedule depth 3 vs depth 2 (bit for bit)",
              metric="logits differ")
    log(f"check {name} depth 3 replay: {deep_steps} steps, by TPU kernel "
        f"{deep_tpu}")
    return {"cp_lse_combine": (by_tpu.get("_cp_lse_combine_kernel", 0),
                               steps),
            "cp_lse_combine3": (deep_tpu.get("_cp_lse_combine_kernel3", 0),
                                deep_steps)}


def queued_ms(fn, iters: int = 20) -> float:
    """Device time of one ``fn()`` call over ``iters`` calls enqueued
    behind a spinning kernel, so that the host work of each call (the
    ship's host checks of its page tables) hides behind the device's:
    for a wrapper whose host time exceeds its kernel's. Raises when the
    enqueue outlasts the spin."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    spin = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    spin.record()
    torch.cuda._sleep(int(4e8))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    if host_ms >= spin.elapsed_time(a):
        raise RuntimeError(f"queued_ms: the enqueue took {host_ms:.1f} ms, "
                           "longer than the spin kernel")
    return a.elapsed_time(b) / iters


def ship_pools(dev, g, npages, hkv=16, page=16, d=128, layers=28):
    """Seeded int8 K and V pools with f32 scale planes, as the DeepSeek
    serving state holds them (``layers`` × 2, (npages, Hkv, page, D))."""
    import torch

    def pool():
        return {"q": torch.randint(-128, 128, (npages, hkv, page, d),
                                   generator=g, device=dev,
                                   dtype=torch.int8),
                "scale": torch.rand((npages, hkv, page), generator=g,
                                    device=dev)}

    return tuple((pool(), pool()) for _ in range(layers))


def _pool_leaves(layers):
    return [t for pair in layers for p in pair
            for t in ((p["q"], p["scale"]) if isinstance(p, dict) else (p,))]


def check_kv_ship(res: Results, dev):
    """``tdt_kv_ship`` against its plain version, byte for byte: the mesh
    form (JAX's layout) at the lint geometry (4 pages of 8 × 128) and at
    a full DeepSeek page (64 pages of 256 × 128), n = 2 and 4 ranks,
    coalesce 1, 2 and 4 on the coalesced landing tables; the engine form
    at DeepSeek-MoE-16B's pools (28 layers × K and V, Hkv 16, page 16, D
    128, int8 + f32 scales) for a 1024-token request's 64 pages, source
    pages scattered over the pool, landing reversed, every pool and rail
    in one launch. Times the engine form: the kernel behind a spinning
    kernel (the wrapper's host checks hidden), the plain version back to
    back, one ``copy_`` of the same bytes."""
    import torch

    from triton_distributed_tpu_torch.kernels import kv_ship as ks
    from triton_distributed_tpu_torch.runtime import Mesh
    from triton_distributed_tpu_torch.tune.schedule import GridSchedule

    g = torch.Generator(device=dev).manual_seed(61)
    geom = ks.KV_SHIP_GEOM
    for rows, cols, pages in ((geom["rows"], geom["cols"], geom["pages"]),
                              (256, 128, KV_SHIP_PAGES)):
        for n in (2, 4):
            for c in (1, 2, 4):
                q = [torch.randint(-128, 128, (pages * rows, cols),
                                   generator=g, device=dev, dtype=torch.int8)
                     for _ in range(n)]
                s = [torch.randn((pages * rows, 128), generator=g,
                                 device=dev) for _ in range(n)]
                table = [ks.coalesced_landing_table(pages, c)] * n
                sched = GridSchedule(coalesce=c)
                got = ks.kv_ship(q, s, table, Mesh.loopback(n, dev, axis="x"),
                                 "x", schedule=sched)
                torch.cuda.synchronize()
                want = ks.kv_ship([t.cpu() for t in q], [t.cpu() for t in s],
                                  table, Mesh.loopback(n, "cpu", axis="x"),
                                  "x", schedule=sched)
                bad = sum(int((a.cpu().view(torch.uint8)
                               != b.view(torch.uint8)).sum())
                          for a, b in zip(got[0] + got[1],
                                          want[0] + want[1]))
                res.check("kv_ship", bad, 0, f"mesh form n {n} x {pages} "
                          f"pages of ({rows}, {cols}) int8 + scales, "
                          f"coalesce {c} (byte-exact)", metric="bytes differ")
                res.kernel("kv_ship", err=float(bad))
    # the engine form at the disaggregated path's pools
    src = ship_pools(dev, g, KV_SHIP_POOL)
    dst = ship_pools(dev, g, KV_SHIP_POOL)
    ref = tuple(tuple({k: v.clone() for k, v in p.items()} for p in pair)
                for pair in dst)
    perm = torch.randperm(KV_SHIP_POOL, generator=torch.Generator()
                          .manual_seed(62))
    sp = [int(x) for x in perm[:KV_SHIP_PAGES]]
    dp = list(range(KV_SHIP_PAGES))[::-1]
    table = ks.ShipTable()
    ks.ship_kv_pages(src, dst, sp, dp, table=table)
    pairs = ks._pool_pairs(src, ref)
    ks.kv_ship_plain(pairs, [sp], [dp])
    torch.cuda.synchronize()
    bad = sum(int((a.view(torch.uint8) != b.view(torch.uint8)).sum())
              for a, b in zip(_pool_leaves(dst), _pool_leaves(ref)))
    what = (f"engine form {len(src)} layers x K, V, {KV_SHIP_PAGES} pages "
            f"of (16, 16, 128) int8 + f32 scales on {KV_SHIP_POOL}-page "
            "pools, landing reversed")
    res.check("kv_ship", bad, 0, what + " (byte-exact, whole pools)",
              metric="bytes differ")
    res.kernel("kv_ship", err=float(bad))
    ms = queued_ms(lambda: ks.ship_kv_pages(src, dst, sp, dp, table=table))
    # the plain version copies its id tables to the card once a pool and
    # rail: its host time bounds it, and back-to-back calls time that
    plain_ms = time_ms(lambda: ks.kv_ship_plain(pairs, [sp], [dp]), 5)
    moved = sum(t[0].numel() * t.element_size()
                for t in _pool_leaves(src)) * KV_SHIP_PAGES
    a = torch.empty(moved, dtype=torch.uint8, device=dev)
    b = torch.empty_like(a)
    lib_ms = time_ms(lambda: b.copy_(a), 20)
    del a, b
    # each shipped byte read once and written once
    nbytes = 2 * moved
    bnd, by = bound_ms(nbytes, 0, H100_INT8_OPS)
    log(f"time kv_ship {what} ({moved / 1e6:.1f} MB each way, one launch a "
        f"cohort): kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={lib_ms:.4f} (one copy_ of the same bytes) "
        f"bound_ms={bnd:.4f} ({by})")
    res.shape("kv_ship", 1, ms, plain_ms, lib_ms, nbytes, 0, H100_INT8_OPS)
    del src, dst, ref, pairs
    torch.cuda.empty_cache()


def _watch_first_decodes(eng, store):
    """Record each request's logits at its first decode (its second
    token) in ``store`` and count non-finite rows, on a role engine."""
    advance = eng._advance_row
    eng.bad_rows = 0

    def watched(s, req, take, logits):
        if not np.isfinite(logits[s]).all():
            eng.bad_rows += 1
        if req.cursor + take == len(req.seq) and len(req.generated) == 1:
            store.setdefault(req.rid, np.array(logits[s]))
        return advance(s, req, take, logits)

    eng._advance_row = watched


def run_disagg_path(res: Results, dev, main):
    """Disaggregated serving through ``DisaggregatedEngine``, both roles
    on the card, with the plain versions made to raise: DeepSeek-MoE-16B
    as served at full width and depth from the main path's weights
    (``main``: its model, params and served trace), the main path's
    ``EngineConfig``, the decode role derived as in JAX (budget 128),
    the 2-rank role mesh ``Mesh.grid({"dcn": 2, "tp": 1})`` with
    ``transport="auto"`` (so "dcn") and the ship committed a tick after
    its launch, serving the main path's trace again. Every request must
    complete, every request with ``max_new`` > 1 ship, ``tdt_kv_ship``
    launch once a cohort, every shipped page and scale plane equal its
    source page at commit (before the source releases it), and every
    token stream equal the colocated main path's byte for byte. Then the
    trace replayed up to the first shipped request's first decode with
    the ship's scale rail dropped must move that request's logits past
    ``DISAGG_DROP_RTOL``. Returns (the ship's launches, cohorts)."""
    import torch

    from triton_distributed_tpu_torch.kernels import (
        kv_ship as ks,
        launch_counts,
        reset_launch_counts,
    )
    from triton_distributed_tpu_torch.runtime import Mesh
    from triton_distributed_tpu_torch.serving import (
        DisaggregatedEngine,
        EngineConfig,
        poisson_trace,
    )

    model, params, col_trace = main
    cfg = model.config
    name = "deepseek_moe_16b disagg"
    ecfg = EngineConfig(slots=16, token_budget=512, chunk=256, page=16,
                        npages=2048)
    roles = Mesh.grid({"dcn": 2, "tp": 1}, dev)

    class Checked(DisaggregatedEngine):
        """Holds every shipped page to its source at commit, before the
        source releases it, and collects the committed cohorts."""

        def _commit_ships(self):
            for r in self._inflight:
                if self.ticks - r.issued_tick < self.ship_delay_steps:
                    continue
                src = self.prefill.table[r.pslot, :len(r.dpids)]
                for a, b in zip(ks.gather_kv_pages(self.prefill.state.layers,
                                                   src),
                                ks.gather_kv_pages(self.decode.state.layers,
                                                   r.dpids)):
                    self.page_bytes_differ += int((a != b).sum())
            done = super()._commit_ships()
            self.cohorts.update(r.issued_tick for r in done)
            if done and self.first_shipped is None:
                self.first_shipped = done[0].req.rid
            return done

    def engine():
        eng = Checked(model, params, model, params, ecfg, hybrid_mesh=roles,
                      ship_delay_steps=DISAGG_DELAY)
        eng.page_bytes_differ, eng.cohorts, eng.first = 0, set(), {}
        eng.first_shipped = None
        _watch_first_decodes(eng.prefill, {})
        _watch_first_decodes(eng.decode, eng.first)
        return eng

    def trace():
        return poisson_trace(seed=11, n_requests=16, mean_interarrival=0.25,
                             len_lo=128, len_hi=1024, max_new_lo=16,
                             max_new_hi=32, vocab=cfg.vocab)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = engine()
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    tr = trace()
    reset_launch_counts()
    t1 = time.perf_counter()
    st = eng.run(tr)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    pst, dst = st.prefill, st.decode
    ship_ms = np.asarray(st.ship_ms) if st.ship_ms else np.zeros(1)
    log(f"path {name} layers={cfg.n_layers}: transport={eng.transport} "
        f"setup_s={setup:.2f} completed={st.completed}/{len(tr)} "
        f"ships={st.ships} cohorts={len(eng.cohorts)} "
        f"wire_bytes={st.shipped_wire_bytes} raw_bytes={st.shipped_raw_bytes}"
        f" wire_compression={st.wire_compression:.4f} ticks={eng.ticks} "
        f"prefill_steps={len(pst.step_times)} decode_steps="
        f"{len(dst.step_times)} decode_evictions={dst.evictions} "
        f"p50_decode_step_ms={dst.p50_step_ms:.2f} p99_decode_step_ms="
        f"{dst.p99_step_ms:.2f} p50_prefill_step_ms={pst.p50_step_ms:.2f} "
        f"ship_ms_median={float(np.median(ship_ms)):.3f} ship_ms_max="
        f"{float(ship_ms.max()):.3f} wall_s={wall:.2f} tok_s="
        f"{dst.generated_tokens / wall:.2f} goodput_tok_s="
        f"{st.goodput_tok_per_s:.2f} peak_mem_gib={peak:.2f}")
    log(f"launches {name} " + " ".join(
        f"{k}={v}" for k, v in counts.items() if v))
    for k in PATH_KERNELS[name]:
        if counts[k] == 0:
            res.failures.append(f"{name}: {k} never launched")
    if st.completed != len(tr):
        res.failures.append(f"{name}: {st.completed}/{len(tr)} requests "
                            "completed")
    want_ships = sum(r.max_new > 1 for r in tr)
    res.check(name, abs(st.ships - want_ships), 0, f"{st.ships} ships for "
              f"the {want_ships} requests with max_new > 1",
              metric="ships off")
    res.check(name, abs(counts["kv_ship"] - len(eng.cohorts)), 0,
              f"{counts['kv_ship']} tdt_kv_ship launches for "
              f"{len(eng.cohorts)} cohorts (one a cohort)",
              metric="launches off")
    res.check(name, float(st.degraded_transport), 0.0,
              "the transport never degraded", metric="degraded")
    res.check(name, eng.page_bytes_differ, 0, "every shipped page's payload "
              "and scale plane vs its source page, at commit",
              metric="bytes differ")
    if eng.prefill.bad_rows + eng.decode.bad_rows:
        res.failures.append(f"{name}: rows of non-finite logits")
    differ = sum(a.generated != b.generated for a, b in zip(tr, col_trace))
    res.check(name, differ, 0, f"the {len(tr)} token streams vs the "
              "colocated main path's (byte for byte)", metric="streams differ")
    launches, cohorts = counts["kv_ship"], len(eng.cohorts)
    # the negative control: the scale rail dropped from every ship
    target, st_ticks = eng.first_shipped, eng.ticks
    ref = eng.first.get(target)
    del eng
    torch.cuda.empty_cache()
    orig = ks.ship_kv_pages

    def dropped(src_layers, dst_layers, *a, **kw):
        def payload(layers):
            return tuple(tuple(p["q"] for p in pair) for pair in layers)
        return orig(payload(src_layers), payload(dst_layers), *a, **kw)

    ks.ship_kv_pages = dropped
    try:
        e = engine()
        e.submit_trace(trace())
        while target not in e.first and e.ticks < st_ticks:
            e.tick()
        torch.cuda.synchronize()
    finally:
        ks.ship_kv_pages = orig
    got = e.first.get(target)
    if ref is None or got is None:
        res.failures.append(f"{name}: the replay never reached request "
                            f"{target}'s first decode")
    else:
        moved = float(np.abs(got - ref).max()) / float(np.abs(ref).max())
        res.check(name, -moved, -DISAGG_DROP_RTOL, f"request {target}'s "
                  "first-decode logits with the scale rail dropped must "
                  f"move past the tolerance (max_rel_err={moved:.6g}, "
                  f"{e.ticks} ticks replayed)", metric="-max_rel_err")
    del e
    torch.cuda.empty_cache()
    return launches, cohorts


def run_moe_tp4_path(res: Results, dev, name, one, profile=False):
    """DeepSeek-MoE-16B at tp = 4 on a loopback mesh of the card, from
    the MoE generation path's tp = 1 run ``one`` (:func:`run_decode_path`
    with ``keep``) in the same flavour: its weights sharded (EP: the
    experts split over the ranks; TP: their F dim), its prompts prefilled
    into sequence-sharded caches (the TP prefill must launch each mesh
    MoE-TP kernel once a MoE layer, on ``wgmma``; the EP prefill the
    all-to-all over the mesh twice a MoE layer; no one-rank MoE form), the
    first step's logits within ``TP_PREFILL_RTOL`` of the tp = 1 prefill's,
    then
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
    if cfg.moe == "tp":
        # the bf16 mesh MoE-TP pair all on the grouped warpgroup GEMM
        check_wg_forms(res, f"{name} prefill", {
            k: n_moe for k in MOE_MESH_ROWS})
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


@contextlib.contextmanager
def _lost_ring_block(rank: int, lost: int = 0):
    """Within the block, the ring attention's output for ``rank`` is
    recomputed without source block ``lost`` (a fault made for the
    check's power): the ring again over the blocks lost + 1, ..., rank
    alone, on a mesh of that many ranks, whose queries and keys keep their
    relative positions, so the causal mask is the same and only block
    ``lost``'s keys are gone."""
    from triton_distributed_tpu_torch.kernels import ring_attention as ra
    from triton_distributed_tpu_torch.runtime import Mesh

    ring = ra.ring_attention

    def lossy(q, k, v, mesh, axis="tp", *, causal=True):
        out = ring(q, k, v, mesh, axis, causal=causal)
        sub = slice(lost + 1, rank + 1)
        part = ring(q[sub], k[sub], v[sub], Mesh.loopback(
            rank - lost, q.device, axis=axis), axis, causal=causal)
        out[rank] = part[rank - lost - 1]
        return out

    ra.ring_attention = lossy
    try:
        yield
    finally:
        ra.ring_attention = ring


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


def grad_slabs(dev, g, n, srows, cols, seed):
    """Seeded (G, n, n·srows, cols) f32 gradient slabs: rank r's slab of
    ring g at [g, r], rows of every magnitude (one row a thousandth of
    the rest, one zero row: the scale's clamp)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((g, n, n * srows, cols), generator=gen, device=dev)
    x[..., 1, :] *= 1e-3
    x[..., 2, :] = 0.0
    return x


def _chunked_plain(fn, x, srows, chunks, **kw):
    """A plain ring version over a long slab, ``chunks`` row chunks at a
    time (the rows are independent; each chunk draws its own rows'
    uniforms): (G, n, n·srows, cols) → (G, n, srows, cols)."""
    import torch

    g, n, _, cols = x.shape
    v = x.view(g, n, n, srows, cols)
    step = -(-srows // chunks)
    outs = [fn(v[..., i:i + step, :].reshape(g, n, -1, cols), row0=i, **kw)
            for i in range(0, srows, step)]
    return torch.cat(outs, dim=2)


def check_grad_ring(res: Results, dev):
    """The dp gradient ring (``tdt_grad_ring``) against its plain version,
    bit for bit: int8 with stochastic rounding and fp8, each with error
    feedback on and off, and the TPU kernel's own deterministic mode
    (no feedback, round to nearest, make_wire_format's 8-row chunk over
    2048 columns); schedule depth 2 and 3 (the same bits, counted by
    ``_grad_ring_kernel_w`` / ``_w3``); n = 2, 4, 8 on 3 rings of ragged
    stripes. The all-gather half (``tdt_grad_allgather``) against its
    plain version, written in place. Then both at the train path's slab
    (``TRAIN_CFG``: dp 2 rings over tp × cp = 4 groups of Llama-2-7B-width
    rank slabs, 374.3 M f32 a rank), against the plain versions run in
    ``GR_PLAIN_CHUNKS`` row chunks (bit-equal there too), timed."""
    import torch

    from triton_distributed_tpu_torch.kernels import cp_ring as cp
    from triton_distributed_tpu_torch.kernels import (
        launch_counts,
        launches_by_tpu_kernel,
        reset_launch_counts,
    )
    from triton_distributed_tpu_torch.lang import wire as tw
    from triton_distributed_tpu_torch.train import step as tstep
    from triton_distributed_tpu_torch.tune.schedule import RingSchedule

    def exact(a, b):
        return float((a - b).abs().max())

    for n in (2, 4, 8):
        x = grad_slabs(dev, 3, n, 5, 200, seed=n)
        for wire, sr in (("int8", True), ("fp8", False)):
            for ef in (True, False):
                kw = dict(wire=wire, seed=17, ef=ef, stochastic=sr)
                want = cp.grad_ring_plain(x, **kw)
                for row, depth in (("grad_ring", 2), ("grad_ring3", 3)):
                    got = cp.grad_ring(x, schedule=RingSchedule(depth=depth),
                                       **kw)
                    err = exact(got, want)
                    res.check(row, err, 0.0, f"n {n} 3 x (5, 200) {wire} "
                              f"{'sr' if sr else 'rtn'} ef={ef} depth "
                              f"{depth} (bit-exact)")
                    res.kernel(row, err=err)
        red = cp.grad_ring(x, wire="int8", seed=3)
        buf = torch.empty_like(x)
        cp.grad_allgather(red, wire="int8", seed=4, out=buf)
        err = exact(buf, cp.grad_allgather_plain(red, wire="int8", seed=4))
        res.check("grad_allgather", err, 0.0, f"n {n} 3 x (5, 200) int8 sr "
                  "(bit-exact, in place)")
        res.kernel("grad_allgather", err=err)
    g = cp.CP_RING_GEOM
    fmt = tw.make_wire_format("int8", g["rows"])
    for n in (2, 4):
        x = grad_slabs(dev, 1, n, g["rows"], g["grad_cols"], seed=20 + n)
        kw = dict(wire="int8", ef=False, stochastic=False,
                  chunk_rows=fmt.chunk_rows)
        want = cp.grad_ring_plain(x, **kw)
        for row, depth in (("grad_ring", 2), ("grad_ring3", 3)):
            err = exact(cp.grad_ring(x, schedule=RingSchedule(depth=depth),
                                     **kw), want)
            res.check(row, err, 0.0, f"n {n} lint geometry ({g['rows']}, "
                      f"{g['grad_cols']}) rtn no feedback depth {depth} "
                      "(the TPU kernel's mode, bit-exact)")
            res.kernel(row, err=err)
    del x, want, red, buf
    # the train path's slab
    cfg = tstep.TrainConfig(**TRAIN_CFG)
    tr_rows = tstep.rank_layout(cfg)[1]
    gn, n = cfg.tp * cfg.cp, cfg.dp
    srows = tr_rows // n
    x = grad_slabs(dev, gn, n, srows, tstep.SLAB_COLS, seed=7)
    cols = tstep.SLAB_COLS
    tag = (f"train slab dp {n} x tp {cfg.tp} x cp {cfg.cp}: {gn} rings of "
           f"{n} x ({tr_rows}, {cols}) f32, int8 sr ef")
    kw = dict(wire="int8", seed=11, ef=True)
    elems = gn * n * tr_rows * cols
    for row, depth in (("grad_ring", 2), ("grad_ring3", 3)):
        sched = RingSchedule(depth=depth)
        reset_launch_counts()
        got = cp.grad_ring(x, schedule=sched, **kw)
        torch.cuda.synchronize()
        tpu = launches_by_tpu_kernel()
        if launch_counts()["grad_ring"] != 1 or len(tpu) != 1:
            res.failures.append(f"{row}: one call launched "
                                f"{launch_counts()['grad_ring']} ({tpu})")
        ms = time_ms(lambda: cp.grad_ring(x, schedule=sched, **kw), 5)
        t0 = time.perf_counter()
        want = _chunked_plain(cp.grad_ring_plain, x, srows, GR_PLAIN_CHUNKS,
                              **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = exact(got, want)
        res.check(row, err, 0.0, tag + f" depth {depth} (bit-exact against "
                  f"the plain version in {GR_PLAIN_CHUNKS} row chunks)")
        res.kernel(row, err=err)
        del got, want
        # every rank's slab read once, each owner's stripe written once;
        # ~8 f32 operations an element and hop
        nbytes = 4 * elems + 4 * elems // n
        ops = 8 * elems // n * (n - 1)
        bnd, by = bound_ms(nbytes, ops, H100_F32_OPS)
        log(f"time {row} {tag} depth {depth} (1/step): kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms=None (no one PyTorch call "
            f"requantizes each hop) bound_ms={bnd:.4f} ({by}) "
            f"{nbytes / ms / 1e6:.1f} GB/s")
        res.shape(row, 1, ms, plain_ms, None, nbytes, ops, H100_F32_OPS)
    red = cp.grad_ring(x, **kw)
    ag_kw = dict(wire="int8", seed=12)
    ms = time_ms(lambda: cp.grad_allgather(red, out=x, **ag_kw), 5)
    t0 = time.perf_counter()
    step = -(-srows // GR_PLAIN_CHUNKS)
    for i in range(0, srows, step):
        part = red[:, :, i:i + step]
        want = cp.grad_allgather_plain(part.contiguous(), row0=i, **ag_kw)
        got = x.view(gn, n, n, srows, cols)[:, :, :, i:i + step]
        err = exact(got, want.view(gn, n, n, -1, cols))
        res.kernel("grad_allgather", err=err)
        if err:
            res.failures.append(f"grad_allgather: rows {i}+ at the train "
                                f"slab apart by {err}")
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    nbytes = 4 * elems // n + 4 * elems
    ops = 6 * elems // n
    bnd, by = bound_ms(nbytes, ops, H100_F32_OPS)
    log(f"time grad_allgather {tag} (1/step; no TPU kernel): kernel_ms="
        f"{ms:.4f} plain_ms={plain_ms:.4f} (with the bit check) library_ms="
        f"None (no one PyTorch call quantizes and broadcasts) bound_ms="
        f"{bnd:.4f} ({by}) {nbytes / ms / 1e6:.1f} GB/s")
    res.shape("grad_allgather", 1, ms, plain_ms, None, nbytes, ops,
              H100_F32_OPS)
    del x, red
    torch.cuda.empty_cache()


def _rel(got, want) -> float:
    """||got - want|| / ||want|| in f64 (0 where both are 0)."""
    import torch

    num = float(torch.linalg.vector_norm(got - want, dtype=torch.float64))
    den = float(torch.linalg.vector_norm(want, dtype=torch.float64))
    return num / den if den else (0.0 if num == 0 else math.inf)


def _train_step_errs(tr, before, ref_dp, ref_m):
    """The trainer's last step against the reference's, leaf by leaf:
    (the worst leaf's relative update error and its name, the worst
    leaf's relative error of Adam's first moment and its name, the leaves
    whose replicas differ: over dp and cp, and over tp where a leaf is
    not sharded). ``before``: the parameters before the step (host);
    ``ref_dp`` / ``ref_m``: the reference's update and first moment
    (host)."""
    import torch

    from triton_distributed_tpu_torch.train import step as tstep

    after = tr.global_params()
    m = tr.opt_state()["m"]
    dev = tr.device
    dp_err = max((_rel(after[k] - before[k].to(dev), ref_dp[k].to(dev)), k)
                 for k in after)
    m_err = max((_rel(m[k], ref_m[k].to(dev)), k) for k in m)
    del after, m
    specs = tstep._param_specs(tr.cfg)
    split = []
    for k, p in tr.params.items():
        p = p.detach()
        same = all(torch.equal(p[d, t, c], p[0, t if specs[k] is not None
                                             else 0, 0])
                   for d in range(p.shape[0]) for t in range(p.shape[1])
                   for c in range(p.shape[2]))
        if not same:
            split.append(k)
    return dp_err, m_err, split


def run_train_path(res: Results, dev):
    """The dp×tp×cp trainer at Llama-2-7B's widths (``TRAIN_CFG``: vocab
    32000, d_model 4096, 32 heads, d_ff 11008, ring attention, the int8
    dp ring) on ``Mesh.grid({"dp": 2, "tp": 2, "cp": 2})``: first
    ``train_step_reference`` (one dense single-device step a batch, on
    the card, before the plain versions are made to raise; with
    ``mlp_grad_scale=tp``, JAX's and the trainer's gradients), then
    ``TRAIN_STEPS`` trainer steps from the same parameters on the same
    batches, the last half with the ring's entry called at schedule
    depth 3 (the ``_w3`` launches; the same values). Each step's loss
    must be finite and within ``TRAIN_TOL`` of the reference's (step 0
    within ``TRAIN_STEP0_TOL``), its parameter update and Adam's first
    moment within ``TRAIN_DP_RTOL`` / ``TRAIN_M_RTOL`` of the
    reference's (the worst leaf's relative error), every replica of a
    parameter equal; each step launches the ring and its all-gather once
    and the ring attention once a microbatch. Then a control: step 0
    again with the ring's result dropped (each owner keeps its own
    stripe, unreduced) must break both relative limits. Logs per step
    the loss and |Δ|, the relative errors, ms, peak memory, the wire
    ratio and the launches by TPU kernel. Returns {row: launches}."""
    import functools

    import torch

    from triton_distributed_tpu_torch.kernels import (
        cp_ring,
        launch_counts,
        launches_by_tpu_kernel,
        reset_launch_counts,
    )
    from triton_distributed_tpu_torch.train import step as tstep
    from triton_distributed_tpu_torch.tune.schedule import RingSchedule

    cfg = tstep.TrainConfig(**TRAIN_CFG)
    name = (f"train dp{cfg.dp} tp{cfg.tp} cp{cfg.cp} d{cfg.d_model} "
            f"ff{cfg.d_ff} v{cfg.vocab} seq{cfg.seq} b{cfg.batch}")
    torch.cuda.empty_cache()
    batches = [tstep.make_batch(cfg, k) for k in range(TRAIN_STEPS)]
    params = tstep.init_params(cfg, device=dev)
    p, opt = params, tstep.init_opt_state(params)
    ref, ref_dp, ref_m = [], [], []
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for tok, tgt in batches:
        new, opt, loss = tstep.train_step_reference(
            p, opt, tok, tgt, cfg, mlp_grad_scale=cfg.tp)
        ref.append(loss)
        ref_dp.append({k: (new[k] - p[k]).cpu() for k in new})
        ref_m.append({k: v.cpu() for k, v in opt["m"].items()})
        p = new
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    log(f"path {name} reference: losses {ref} ms_a_step (with the host "
        f"copies of its updates)={ms:.1f} peak_gb={torch.cuda.max_memory_allocated() / 2**30:.2f}")
    params = {k: v.cpu() for k, v in params.items()}
    del p, new, opt
    torch.cuda.empty_cache()
    mesh = tstep.default_train_mesh(cfg, dev)
    tr = tstep.Trainer(cfg, mesh, params=params)
    torch.cuda.empty_cache()
    rep = tr.wire_report()
    log(f"path {name} trainer: wire {tr.wire} slab rows a rank "
        f"{tr.rank_rows} wire report {rep}")
    if not rep["ratio"] > 1.9:
        res.failures.append(f"{name}: wire ratio {rep['ratio']}")
    totals = {"grad_ring": 0, "grad_allgather": 0, "grad_ring3": 0}
    orig = cp_ring.grad_ring
    before = params
    try:
        for k, (tok, tgt) in enumerate(batches):
            depth3 = k >= TRAIN_STEPS // 2
            if depth3:
                cp_ring.grad_ring = functools.partial(
                    orig, schedule=RingSchedule(depth=3))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            t0 = time.perf_counter()
            with _plain_versions_raise():
                r = tr.step(tok, tgt)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            peak = torch.cuda.max_memory_allocated() / 2**30
            counts, by = launch_counts(), launches_by_tpu_kernel()
            (dp_err, dp_leaf), (m_err, m_leaf), split = _train_step_errs(
                tr, before, ref_dp[k], ref_m[k])
            if k + 1 < TRAIN_STEPS:
                before = {k2: v.cpu() for k2, v in tr.global_params().items()}
            d = abs(r["loss"] - ref[k])
            tol = TRAIN_STEP0_TOL if k == 0 else TRAIN_TOL
            log(f"path {name} step {k}: loss={r['loss']:.6f} ref="
                f"{ref[k]:.6f} abs_delta={d:.3g} (tol {tol:g}) update "
                f"rel_err={dp_err:.6g} ({dp_leaf}; tol {TRAIN_DP_RTOL:g}) "
                f"first-moment rel_err={m_err:.6g} ({m_leaf}; tol "
                f"{TRAIN_M_RTOL:g}) replicas apart: {split or 'none'} "
                f"ms={ms:.1f} peak_gb={peak:.2f} wire={r['wire']} ratio="
                f"{rep['ratio']:.4f} degraded={r['degraded']} launches "
                + " ".join(f"{k2}={v}" for k2, v in counts.items() if v)
                + f" by TPU kernel {by}")
            if not math.isfinite(r["loss"]) or d > tol:
                res.failures.append(f"{name} step {k}: loss {r['loss']} vs "
                                    f"the reference's {ref[k]} (tol {tol})")
            if not dp_err <= TRAIN_DP_RTOL or not m_err <= TRAIN_M_RTOL:
                res.failures.append(
                    f"{name} step {k}: update rel_err {dp_err} ({dp_leaf}), "
                    f"first-moment rel_err {m_err} ({m_leaf}) against the "
                    f"reference's (tol {TRAIN_DP_RTOL}, {TRAIN_M_RTOL})")
            if split:
                res.failures.append(f"{name} step {k}: the replicas of "
                                    f"{split} differ")
            want = {"grad_ring": 1, "grad_allgather": 1,
                    "ring_attention": cfg.microbatches}
            for k2, v in want.items():
                if counts[k2] != v:
                    res.failures.append(f"{name} step {k}: {counts[k2]} "
                                        f"{k2} launches, expected {v}")
            tpu = "_grad_ring_kernel_w3" if depth3 else "_grad_ring_kernel_w"
            if by.get(tpu) != 1:
                res.failures.append(f"{name} step {k}: the ring stood for "
                                    f"{by}, expected {tpu}")
            totals["grad_ring3" if depth3 else "grad_ring"] += counts[
                "grad_ring"]
            totals["grad_allgather"] += counts["grad_allgather"]
        del tr
        torch.cuda.empty_cache()

        def dropped(x, **kw):
            """Each owner's own stripe of its slab, the peers' left out."""
            n = x.shape[1]
            sr = x.shape[2] // n
            return torch.stack([x[:, s, s * sr:(s + 1) * sr]
                                for s in range(n)], 1)

        cp_ring.grad_ring = dropped
        ctl = tstep.Trainer(cfg, mesh, params=params)
        ctl.step(*batches[0])
        (dp_err, dp_leaf), (m_err, m_leaf), _ = _train_step_errs(
            ctl, params, ref_dp[0], ref_m[0])
        del ctl
    finally:
        cp_ring.grad_ring = orig
    torch.cuda.empty_cache()
    res.check("train", -dp_err, -TRAIN_DP_RTOL, "control: step 0 with the "
              "dp ring's result dropped must break the update's limit "
              f"(rel_err={dp_err:.6g}, {dp_leaf})", metric="-rel_err")
    res.check("train", -m_err, -TRAIN_M_RTOL, "control: step 0 with the "
              "dp ring's result dropped must break the first moment's "
              f"limit (rel_err={m_err:.6g}, {m_leaf})", metric="-rel_err")
    for k2, v in totals.items():
        if v == 0:
            res.failures.append(f"{name}: {k2} never launched")
    return totals


def run_train_lm_path(res: Results, dev):
    """``Transformer.train_step`` on Llama-2-7B at full width, its depth
    cut to ``LM_LAYERS`` layers (f32 parameters, bf16 compute), on one
    rank and on ``Mesh.loopback(4)``: ``LM_STEPS`` SGD steps (lr
    ``LM_LR``) on one batch of ``LM_B`` × ``LM_S`` tokens (next-token
    targets), with the plain versions made to raise. The loss must be
    finite and fall over the steps on both, each step's tp = 4 loss lie
    within ``LM_TP_ATOL`` of tp = 1's, and the first layer's new weights
    within ``LM_W_RTOL`` (relative to the update); tp = 4 launches the mesh
    AG-GEMM, GEMM-RS (forward and their duals backward) and the
    all-gather (the saved and the dual's gathered operands), tp = 1 the
    world-size-1 GEMMs. Logs the losses, ms a step, peak memory and the
    launch counts."""
    import dataclasses

    import torch

    from triton_distributed_tpu_torch.kernels import (
        launch_counts,
        reset_launch_counts,
    )
    from triton_distributed_tpu_torch.models import Transformer, presets
    from triton_distributed_tpu_torch.runtime import Mesh

    cfg = dataclasses.replace(presets.llama_7b(param_dtype=torch.float32),
                              n_layers=LM_LAYERS)
    name = f"train_step llama_7b {LM_LAYERS} of 32 layers b{LM_B} s{LM_S}"
    torch.cuda.empty_cache()
    one = Transformer(cfg, device=dev)
    params = one.init(torch.Generator(device=dev).manual_seed(43))
    gen = torch.Generator(device=dev).manual_seed(44)
    tokens = torch.randint(0, cfg.vocab, (LM_B, LM_S + 1), generator=gen,
                           device=dev)
    tok, tgt = tokens[:, :-1].contiguous(), tokens[:, 1:].contiguous()
    need = {1: ("ag_gemm_n1", "gemm_rs_n1"),
            TP: ("ag_gemm", "gemm_rs", "all_gather")}
    losses, first = {}, {}
    for tp in (1, TP):
        model = one if tp == 1 else Transformer(cfg, mesh=Mesh.loopback(TP,
                                                                        dev))
        p = params if tp == 1 else model.shard_params(params)
        losses[tp] = []
        totals = {}
        with _plain_versions_raise():
            for k in range(LM_STEPS):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_launch_counts()
                t0 = time.perf_counter()
                loss, p = model.train_step(p, tok, tgt, lr=LM_LR)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                counts = launch_counts()
                losses[tp].append(float(loss))
                for k2, v in counts.items():
                    totals[k2] = totals.get(k2, 0) + v
                log(f"path {name} tp{tp} step {k}: loss={float(loss):.6f} "
                    f"ms={ms:.1f} peak_gb="
                    f"{torch.cuda.max_memory_allocated() / 2**30:.2f} launches "
                    + " ".join(f"{k2}={v}" for k2, v in counts.items() if v))
        blk = p["blocks"][0] if tp == 1 else model.unshard_params(
            {"blocks": [p["blocks"][0]]})["blocks"][0]
        first[tp] = {k2: w.detach().clone() for k2, w in blk.items()
                     if torch.is_tensor(w) and w.is_floating_point()}
        del p, model, blk
        torch.cuda.empty_cache()
        ls = losses[tp]
        if not all(math.isfinite(v) for v in ls) or not ls[-1] < ls[0]:
            res.failures.append(f"{name} tp{tp}: losses {ls} do not fall")
        for k2 in need[tp]:
            if not totals.get(k2):
                res.failures.append(f"{name} tp{tp}: {k2} never launched")
    d = max(abs(a - b) for a, b in zip(losses[1], losses[TP]))
    res.check("train_lm", d, LM_TP_ATOL, f"{name}: tp{TP} losses "
              f"{losses[TP]} against tp1 {losses[1]}", metric="max_abs_delta")
    w0 = params["blocks"][0]
    err, leaf = max((_rel(first[TP][k2] - w0[k2], w - w0[k2]), k2)
                    for k2, w in first[1].items())
    res.check("train_lm", err, LM_W_RTOL, f"{name}: layer 0's weights after "
              f"{LM_STEPS} steps, tp{TP} against tp1, the worst leaf "
              f"({leaf}) relative to its update", metric="rel_err")
    del first
    del params, one
    torch.cuda.empty_cache()


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
    from triton_distributed_tpu_torch.kernels import group_gemm as gg

    w8a16_forms = tally_forms(gg._w8a16_cuda)
    w8a8_forms = tally_forms(gg._w8a8_cuda)
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
    check_decode_gemms(res, dev, llama)
    check_w8a8_threshold(res, dev)
    check_router(res, dev, deepseek)
    check_decode_kernels(res, dev)
    check_n1_gemms(res, dev)
    check_moe_tp_kernels(res, dev)
    check_mesh_kernels(res, dev)
    check_wire_kernels(res, dev)
    n_moe = len(deepseek.moe_layers)
    check_a2a_mesh(res, dev, n_moe)
    check_moe_tp_mesh_kernels(res, dev, n_moe)
    check_moe_wire_kernels(res, dev, n_moe)
    check_collectives(res, dev, n_moe)
    check_step4_kernels(res, dev)
    check_cp_combine(res, dev)
    check_cp_prefill_kernels(res, dev)
    check_kv_ship(res, dev)
    check_grad_ring(res, dev)
    res.finish_rows()
    check_tiny(res, dev)
    check_tiny_decode(res, dev)
    check_tiny_moe_decode(res, dev)
    check_tiny_tp(res, dev)
    check_tiny_moe_tp4(res, dev)
    # the training paths: the dp × tp × cp trainer at Llama-2-7B's widths
    # and Transformer.train_step at tp = 1 and 4
    train_counts = run_train_path(res, dev)
    run_train_lm_path(res, dev)

    run_path(res, dev, "llama_7b", llama)
    bf16_counts, bf16_steps = run_path(
        res, dev, "deepseek_moe_16b_bf16_experts", presets.deepseek_moe_16b(
            moe_weight_quant=None, moe_act_quant=None))
    # the main path last, and its profile after its timed run: a
    # torch.profiler run slows the later host work of the process
    main_counts, main_steps, main_run = run_path(
        res, dev, "deepseek_moe_16b", deepseek, profile=opts.profile,
        keep=True)
    # the disaggregated path: the main path's weights and trace served
    # again with the prefill and decode roles split, its streams held to
    # the main path's
    with _plain_versions_raise():
        disagg_counts = run_disagg_path(res, dev, main_run)
    del main_run
    # the decode path: two configurations, each one prefill and DEC_STEPS
    # steps per layout; the bf16 run's weights and prompts then drive the
    # tensor-parallel path (its launches are counted apart)
    decode_counts, one = run_decode_path(
        res, dev, "llama_7b bf16", presets.llama_7b(param_dtype=torch.bfloat16),
        profile=opts.profile, keep=True)
    tp_counts = run_tp_path(res, dev, one, profile=opts.profile)
    with _plain_versions_raise():
        cp_counts = run_cp_prefill_path(res, dev, one)
    del one
    wire_counts = run_wire_path(res, dev)
    moe_wire_counts = run_moe_wire_path(res, dev, n_moe)
    coll_counts = run_collectives_path(res, dev, n_moe)
    with _plain_versions_raise():
        step4_counts = run_step4_path(res, dev)
        lc_counts = run_longcontext_path(res, dev)
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
        elif name == "wire_quantize":
            n, steps = wire_counts[name] + moe_wire_counts[name], 1
        elif name in WIRE_ROWS:
            n, steps = wire_counts[name], 1
        elif name in MOE_WIRE_ROWS:
            n, steps = moe_wire_counts[name], 1
        elif name in COLL_ROWS:
            n, steps = coll_counts[name], 1
        elif name in STEP4_ROWS:
            n, steps = step4_counts[name], 1
        elif name in LC_COMBINE_ROWS:
            n, steps = lc_counts[name]
        elif name in CP_ROWS:
            n, steps = cp_counts[name]
        elif name == "kv_ship":
            n, steps = disagg_counts      # one launch a cohort
        elif name in TRAIN_ROWS:
            n, steps = train_counts[name], TRAIN_ROWS[name]
        else:
            n, steps = ((main_counts[name], main_steps) if main_counts[name]
                        else (bf16_counts[name], bf16_steps))
        res.kernel(name, launches=n)
        per_step = sum(s["n"] for s in res.mix[name])
        if n != per_step * steps:
            res.failures.append(
                f"{name}: {n} launches in {steps} steps, but its row "
                f"weighs shapes of {per_step} launches a step")
    # every bf16 W8A16 launch of the run (the lm_heads of every full-size
    # path) on the tensor-core kernel's 16-byte form; f32 x (the tiny
    # models) runs the FMA loop
    check_router_ops(res)
    forms = w8a16_forms()
    log(f"ggemm_w8a16 launches by form over the run: {forms}")
    res.check("ggemm_w8a16", forms.get("tc_narrow", 0), 0,
              "bf16 launches off the tensor-core kernel's 16-byte form",
              metric="launches")
    if not forms.get("tc"):
        res.failures.append("ggemm_w8a16: no launch ran the tensor-core "
                            "form")
    # every W8A8 launch of the run (the serving paths, every decode path,
    # the kernels phase) on the wgmma tiles or the weight-streaming form
    forms = w8a8_forms()
    log(f"ggemm_w8a8 launches by form over the run: {forms}")
    res.check("ggemm_w8a8", sum(c for f, c in forms.items()
                                if f not in ("tc", "stream")), 0,
              "launches off the tc and stream forms", metric="launches")
    for form in ("tc", "stream"):
        if not forms.get(form):
            res.failures.append(f"ggemm_w8a8: no launch ran the {form} form")
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
