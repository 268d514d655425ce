"""The MoE tensor-parallel GEMMs: AG + grouped GEMM, grouped GEMM + RS.

Port of ``triton_distributed_tpu/kernels/moe_tp_fused.py`` at world
size 1. Its two engines stream per-shard expert-sorted slabs around a
ring: ``ag_group_gemm_kernel`` (``:172``) gathers the slabs and feeds
each arrival to a grouped GEMM, ``moe_reduce_rs_kernel`` (``:285``)
computes each destination's partial into a reduce ring. With one rank
both rings reduce to their compute (``kernels/ring.py:141-145``,
``:269-271``): one grouped GEMM each.

* :func:`ag_group_gemm`: x (M, K) tokens, the sorted token ids ``sti``
  (cap,) and the block→expert table ``be`` (cap / block_m,) of
  ``moe_utils.moe_align_block_size``, w (E, K, N) → (cap, N) rows in
  expert-sorted order, zeros at the padding. The CUDA kernel
  (``tdt_ag_group_gemm``) loads each A row straight from x: the sorted
  slab the TPU kernel consumes is never materialized.
* :func:`moe_reduce_rs`: y (cap, F) sorted rows, be, w (E, F, H) →
  (cap, H), the slab the TPU kernel writes before the top-k combine
  (``tdt_moe_reduce_rs``).

Both take bf16 (tensor cores) or f32 (FMA) operands, sum in f32 and
store to ``out_dtype``. On a CPU tensor each runs its ``*_plain``
version; on a CUDA tensor it launches the kernel or raises. The
quantized-wire twins (``_w``, ``_mx``, ``moe_reduce_rs_kernel_w``) and
the rings come with the collectives (ROADMAP Queue 2 item 18).
"""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.config import to_torch_dtype
from triton_distributed_tpu_torch.kernels.group_gemm import (
    _DT_CODE,
    _check_args,
    _cuda_common,
    grouped_matmul_plain,
)
from triton_distributed_tpu_torch.kernels.moe_utils import gather_sorted


def pick_gg_blocks(block_m: int, cap: int):
    """The grouped GEMMs' M-block: the routing ``block_m`` (one expert
    per block is the grouped-GEMM contract), or None when ``cap`` rows
    do not split into whole blocks (JAX ``pick_gg_blocks``, ``:55-74``;
    its VMEM blocking of K and N has no counterpart here)."""
    if block_m <= 0 or cap % block_m:
        return None
    return block_m


def _check(x, be, w):
    """ag_group_gemm's operands (x is (M, K) tokens, not sorted rows)."""
    if x.dim() != 2 or w.dim() != 3 or w.shape[1] != x.shape[1]:
        raise ValueError(f"ag_group_gemm: contract dim mismatch "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    if x.dtype not in _DT_CODE or w.dtype != x.dtype:
        raise ValueError(f"ag_group_gemm takes operands both f32 or both "
                         f"bf16, got {x.dtype} and {w.dtype}")
    if be.dim() != 1 or be.shape[0] < 1:
        raise ValueError("ag_group_gemm: block_expert must be a non-empty "
                         "vector")


def ag_group_gemm_plain(x, sti, be, w, topk: int, *, out_dtype=None):
    """Plain PyTorch version of :func:`ag_group_gemm`: the sorted slab
    (``gather_sorted``), then the grouped GEMM's plain version."""
    _check(x, be, w)
    return grouped_matmul_plain(gather_sorted(x, sti, topk), w, be,
                                out_dtype=out_dtype)


def ag_group_gemm(x, sti, be, w, topk: int, *, out_dtype=None):
    """(cap, N) = gather_sorted(x, sti, topk) @ w[be[block]]: x (M, K),
    sti (cap,) int32 with the sentinel M·topk at padding, be (cap /
    block_m,) int32, w (E, K, N) in x's dtype; ``out_dtype`` defaults to
    x's dtype."""
    if x.device.type == "cpu":
        return ag_group_gemm_plain(x, sti, be, w, topk, out_dtype=out_dtype)
    return _ag_group_gemm_cuda(x, sti, be, w, topk, out_dtype)


def moe_reduce_rs_plain(y, be, w, *, out_dtype=None):
    """Plain PyTorch version of :func:`moe_reduce_rs`: the grouped GEMM's
    plain version."""
    return grouped_matmul_plain(y, w, be, out_dtype=out_dtype)


def moe_reduce_rs(y, be, w, *, out_dtype=None):
    """(cap, H) = y @ w[be[block]]: y (cap, F) sorted rows, be (cap /
    block_m,) int32, w (E, F, H) in y's dtype; ``out_dtype`` defaults to
    y's dtype. At world size 1 the reduce over ranks is this one
    partial."""
    if y.device.type == "cpu":
        return moe_reduce_rs_plain(y, be, w, out_dtype=out_dtype)
    return _moe_reduce_rs_cuda(y, be, w, out_dtype)


def _out_dtype(out_dtype, a, what):
    out_dtype = to_torch_dtype(out_dtype or a.dtype)
    if out_dtype not in _DT_CODE:
        raise ValueError(f"{what}: out_dtype must be f32 or bf16, got "
                         f"{out_dtype}")
    return out_dtype


def _ag_group_gemm_cuda(x, sti, be, w, topk, out_dtype):
    from triton_distributed_tpu_torch.kernels import _build

    _check(x, be, w)
    if sti.dim() != 1 or sti.dtype != torch.int32:
        raise ValueError("ag_group_gemm: sti must be an int32 vector")
    cap, (m, k), n = sti.shape[0], x.shape, w.shape[2]
    if cap % be.shape[0]:
        raise ValueError(f"ag_group_gemm: {cap} rows do not split into "
                         f"{be.shape[0]} equal M-blocks")
    block_m = cap // be.shape[0]
    dev = _cuda_common((x, w, sti), be, cap, block_m)
    out_dtype = _out_dtype(out_dtype, x, "ag_group_gemm")
    out = torch.empty((cap, n), dtype=out_dtype, device=dev)
    fn = _build.function("tdt_ag_group_gemm", "ppppp" + "iiiiiiii" + "p")
    rc = fn(_build.ptr(x), _build.ptr(sti), _build.ptr(w), _build.ptr(be),
            _build.ptr(out), m, topk, cap, k, n, block_m, _DT_CODE[x.dtype],
            _DT_CODE[out_dtype], _build.stream(dev))
    _build.check(rc, "tdt_ag_group_gemm")
    _ag_group_gemm_cuda.launches += 1
    return out


def _moe_reduce_rs_cuda(y, be, w, out_dtype):
    from triton_distributed_tpu_torch.kernels import _build

    cap, f, _, h, block_m = _check_args(y, w, be, None, None)
    dev = _cuda_common((y, w), be, cap, block_m)
    out_dtype = _out_dtype(out_dtype, y, "moe_reduce_rs")
    out = torch.empty((cap, h), dtype=out_dtype, device=dev)
    fn = _build.function("tdt_moe_reduce_rs", "pppp" + "iiiiii" + "p")
    rc = fn(_build.ptr(y), _build.ptr(w), _build.ptr(be), _build.ptr(out),
            cap, f, h, block_m, _DT_CODE[y.dtype], _DT_CODE[out_dtype],
            _build.stream(dev))
    _build.check(rc, "tdt_moe_reduce_rs")
    _moe_reduce_rs_cuda.launches += 1
    return out


#: launch counts of the kernels (plain ints on the wrappers)
_ag_group_gemm_cuda.launches = 0
_moe_reduce_rs_cuda.launches = 0
