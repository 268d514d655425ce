"""GEMM + reduce-scatter for row-parallel TP, at world size 1.

Port of ``gemm_rs`` (``triton_distributed_tpu/kernels/gemm_rs.py:1077``).
Its fused engine, ``_fused_kernel`` (``:248``), computes each rank's
partial product and folds it around an ack-credited reduce-scatter ring;
with one rank there is nothing to reduce and the kernel is the GEMM:
bf16 (or f32) in, f32 sums, the output in A's dtype. Here it runs on the
float-mode kernel of ``csrc/group_gemm.cu`` with one expert;
:func:`gemm_rs` counts its own launches. The ring comes with the
collectives (ROADMAP Queue 1 items 12-13), and any world size above 1
raises until then.

On a CPU tensor :func:`gemm_rs` runs :func:`gemm_rs_plain`.
"""

from __future__ import annotations

from triton_distributed_tpu_torch.kernels.ag_gemm import _check, ag_gemm_plain


def gemm_rs_plain(a, b, *, out_dtype=None):
    """Plain PyTorch version: ``a @ b`` in f32, cast to ``out_dtype``
    (default a's dtype)."""
    return ag_gemm_plain(a, b, out_dtype=out_dtype)


def gemm_rs(a, b, *, world_size: int = 1, out_dtype=None):
    """ReduceScatter(A @ B): a (M, K), b (K, N) → (M, N) in
    ``out_dtype`` (default a's dtype). World size 1 only."""
    _check(a, b, world_size, "gemm_rs")
    if a.device.type == "cpu":
        return gemm_rs_plain(a, b, out_dtype=out_dtype)
    return _gemm_rs_cuda(a, b, out_dtype)


def _gemm_rs_cuda(a, b, out_dtype):
    from triton_distributed_tpu_torch.kernels.group_gemm import float_gemm

    out = float_gemm(a, b, out_dtype)
    _gemm_rs_cuda.launches += 1
    return out


#: launch count of the kernel (a plain int on the wrapper)
_gemm_rs_cuda.launches = 0
