"""All-gather + GEMM for column-parallel TP, at world size 1.

Port of ``ag_gemm`` (``triton_distributed_tpu/kernels/ag_gemm.py:1132``).
Its fused engine, ``_fused_kernel`` (``:227``), forwards the row shards
of A around a ring and streams each through the blocked GEMM of
``mm_pipeline`` (``:128-162``); with one rank the ring has nothing to
gather and the kernel is that GEMM: bf16 (or f32) in, f32 sums, the
output in A's dtype. Here it runs on the float-mode kernel of
``csrc/group_gemm.cu`` with one expert (the tensor cores for bf16);
:func:`ag_gemm` counts its own launches, apart from the grouped GEMM's.
The ring itself comes with the collectives (ROADMAP Queue 1 items
12-13), and any world size above 1 raises until then.

On a CPU tensor :func:`ag_gemm` runs :func:`ag_gemm_plain`, an f32
matmul cast to the output type.
"""

from __future__ import annotations

from triton_distributed_tpu_torch.config import to_torch_dtype


def _check(a, b, world_size, what):
    if world_size != 1:
        raise NotImplementedError(
            f"{what} at world size {world_size}: the ring comes with the "
            "collectives (ROADMAP Queue 1 items 12-13); only world size 1 "
            "is ported")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"{what}: contract dim mismatch {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")


def ag_gemm_plain(a, b, *, out_dtype=None):
    """Plain PyTorch version: ``a @ b`` in f32, cast to ``out_dtype``
    (default a's dtype)."""
    return (a.float() @ b.float()).to(to_torch_dtype(out_dtype or a.dtype))


def ag_gemm(a, b, *, world_size: int = 1, out_dtype=None):
    """AllGather(A) @ B: a (M, K) rows, b (K, N) → (M, N) in
    ``out_dtype`` (default a's dtype). a and b both bf16 or both f32 on
    the card. World size 1 only."""
    _check(a, b, world_size, "ag_gemm")
    if a.device.type == "cpu":
        return ag_gemm_plain(a, b, out_dtype=out_dtype)
    return _ag_gemm_cuda(a, b, out_dtype)


def _ag_gemm_cuda(a, b, out_dtype):
    from triton_distributed_tpu_torch.kernels.group_gemm import float_gemm

    out = float_gemm(a, b, out_dtype)
    _ag_gemm_cuda.launches += 1
    return out


#: launch count of the kernel (a plain int on the wrapper)
_ag_gemm_cuda.launches = 0
