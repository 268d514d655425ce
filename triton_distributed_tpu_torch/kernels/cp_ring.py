"""Context-parallel collectives: the cross-rank LSE-combine.

Port of the ``cp_decode.lse_combine`` family of
``triton_distributed_tpu/kernels/cp_ring.py`` and of its collective ids.
Long-context serving shards a request's KV pages over the ``cp`` shards
of the pool; each shard's ragged attention returns a partial ``(out_r,
lse_r)``, and the partials merge into one softmax:

* ``m = max_r lse_r``; ``w_r = exp(lse_r - m)``, 0 where ``lse_r`` is
  NEG_INF (a shard that saw nothing of the row);
* ``out = Σ_r w_r · out_r / max(Σ_r w_r, 1e-30)`` in f32, cast to
  ``out_dtype``; ``lse = m + log(Σ_r w_r)``, NEG_INF where every shard
  was masked.

JAX's TPU kernels ``_cp_lse_combine_kernel`` (``:306``) and
``_cp_lse_combine_kernel3`` (``:341``) carry the weighted numerator rows
and the denominator row around the cp ring as an f32 add-reduce, at ring
depth 2 or 3; JAX's serving step runs the same merge in XLA
(``kernels/flash_decode.py:1367`` ``combine_gqa_partials``). The port
merges with one CUDA kernel, ``tdt_cp_lse_combine`` (``csrc/cp_ring.cu``),
launched from :func:`cp_lse_combine`: the serving step's
``combine_gqa_partials`` is its entry point. On the one card the cp
shards are slices of one stacked pool, so the ring becomes a read of
every shard's partial; ``schedule`` depth 3 stands for
``_cp_lse_combine_kernel3`` and adds a TPU ring slot and no value (the
launches are counted by the TPU kernel each stood for).

The kernel adds over the shards in the order r = 0, 1, ..., each product
and add rounded on its own, and :func:`cp_lse_combine_plain` does the
same in torch ops, so the two agree bit for bit on the card. On CPU
tensors :func:`cp_lse_combine` runs the plain version; on CUDA tensors
it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.config import to_torch_dtype
from triton_distributed_tpu_torch.kernels.group_gemm import _DT_CODE
from triton_distributed_tpu_torch.tune.schedule import require_depth_only

#: the lint families' barrier ids (JAX ``:63-66``), shared with the XLA
#: bodies' heartbeats; the port's pull kernels wait on nothing
CP_RING_COLLECTIVE_ID = 15
CP_ULYSSES_COLLECTIVE_ID = 16
GRAD_RING_COLLECTIVE_ID = 17
CP_DECODE_COMBINE_COLLECTIVE_ID = 18

#: finite -inf stand-in of the attention kernels' lse
NEG_INF = -1.0e30

#: the most shards one launch merges (the kernel's register arrays)
MAX_SHARDS = 8

#: the TPU kernel each launch stands for, by ring depth
_TPU_KERNEL = {2: "_cp_lse_combine_kernel", 3: "_cp_lse_combine_kernel3"}


def _check(outs, lses):
    if outs.dim() != 4 or lses.dim() != 3 or tuple(outs.shape[:3]) != tuple(
            lses.shape):
        raise ValueError(f"cp_lse_combine: outs (R, Hkv, TG, D) and lses "
                         f"(R, Hkv, TG), got {tuple(outs.shape)} and "
                         f"{tuple(lses.shape)}")
    if not 1 <= outs.shape[0] <= MAX_SHARDS:
        raise ValueError(f"cp_lse_combine: {outs.shape[0]} shards, the "
                         f"kernel merges 1 to {MAX_SHARDS}")


def cp_lse_combine_plain(outs, lses, *, out_dtype=None):
    """Plain PyTorch version: the module docstring's merge, the sums
    over r = 0, 1, ... in that order, each op rounded on its own (the
    kernel's arithmetic, bit for bit). Returns ``(out (Hkv, TG, D) in
    out_dtype (default outs' dtype), lse (Hkv, TG) f32)``."""
    _check(outs, lses)
    out_dtype = to_torch_dtype(out_dtype or outs.dtype)
    lf = lses.float()
    m = lf.amax(dim=0)
    w = torch.where(lf > NEG_INF / 2, torch.exp(lf - m),
                    torch.zeros_like(lf))
    num = w[0][..., None] * outs[0].float()
    den = w[0]
    for r in range(1, outs.shape[0]):
        num = num + w[r][..., None] * outs[r].float()
        den = den + w[r]
    den = torch.clamp(den, min=1e-30)
    lse = torch.where(m > NEG_INF / 2, m + torch.log(den),
                      torch.full_like(m, NEG_INF))
    return (num / den[..., None]).to(out_dtype), lse


def cp_lse_combine(outs, lses, *, out_dtype=None, schedule=None):
    """Merge the cp shards' attention partials: ``outs`` (R, Hkv, TG, D)
    bf16 or f32 and ``lses`` (R, Hkv, TG) f32, R from 1 to
    ``MAX_SHARDS`` (the serving path runs R = cp ∈ {2, 3, 4}) →
    ``(out (Hkv, TG, D) in out_dtype, lse (Hkv, TG) f32)``. The two may
    be strided views over the shard and head dims (each (TG, D) or (TG,)
    slab contiguous), as the serving step passes them. ``schedule``:
    None or a ``RingSchedule`` whose only non-default field is ``depth``
    (2: ``_cp_lse_combine_kernel``, 3: ``_cp_lse_combine_kernel3``; the
    same values). On CPU tensors this is :func:`cp_lse_combine_plain`; on
    CUDA tensors it launches the kernel or raises."""
    depth = require_depth_only(schedule, "cp_lse_combine")
    _check(outs, lses)
    if outs.device.type == "cpu":
        return cp_lse_combine_plain(outs, lses, out_dtype=out_dtype)
    return _cp_lse_combine_cuda(outs, lses, out_dtype, _TPU_KERNEL[depth])


def _cp_lse_combine_cuda(outs, lses, out_dtype, tpu_kernel):
    """``tdt_cp_lse_combine``: one launch merges every (head, row)."""
    from triton_distributed_tpu_torch.kernels import _build

    if outs.device.type != "cuda" or lses.device != outs.device:
        raise ValueError(f"cp_lse_combine runs on CPU or CUDA tensors on one "
                         f"device, got {outs.device} and {lses.device}")
    out_dtype = to_torch_dtype(out_dtype or outs.dtype)
    if outs.dtype not in _DT_CODE or out_dtype not in _DT_CODE:
        raise ValueError(f"cp_lse_combine's kernel takes f32 or bf16 "
                         f"partials and output, got {outs.dtype} → "
                         f"{out_dtype}")
    if lses.dtype != torch.float32:
        raise ValueError(f"cp_lse_combine: lses must be f32, got "
                         f"{lses.dtype}")
    r, hkv, tg, d = outs.shape
    if outs.stride(3) != 1 or outs.stride(2) != d or lses.stride(2) != 1:
        raise ValueError("cp_lse_combine's kernel needs each shard's and "
                         "head's (TG, D) partial and (TG,) lse contiguous")
    out = torch.empty((hkv, tg, d), dtype=out_dtype, device=outs.device)
    lse = torch.empty((hkv, tg), dtype=torch.float32, device=outs.device)
    vec = (d % 4 == 0 and outs.stride(0) % 4 == 0 and outs.stride(1) % 4 == 0
           and outs.data_ptr() % (4 * outs.element_size()) == 0
           and out.data_ptr() % (4 * out.element_size()) == 0)
    fn = _build.function("tdt_cp_lse_combine", "pppp" + "iiii" + "LLLL"
                         + "iii" + "p")
    rc = fn(_build.ptr(outs), _build.ptr(lses), _build.ptr(out),
            _build.ptr(lse), r, hkv, tg, d, outs.stride(0), outs.stride(1),
            lses.stride(0), lses.stride(1), _DT_CODE[outs.dtype],
            _DT_CODE[out_dtype], int(vec), _build.stream(outs.device))
    _build.check(rc, "tdt_cp_lse_combine")
    _cp_lse_combine_cuda.launches += 1
    _cp_lse_combine_cuda.by_tpu_kernel[tpu_kernel] = (
        _cp_lse_combine_cuda.by_tpu_kernel.get(tpu_kernel, 0) + 1)
    return out, lse


#: launch count of the kernel (a plain int on the wrapper), and by the TPU
#: kernel each launch stood for
_cp_lse_combine_cuda.launches = 0
_cp_lse_combine_cuda.by_tpu_kernel = {}
