"""GEMM + reduce-scatter for row-parallel tensor parallelism.

Port of ``gemm_rs`` (``triton_distributed_tpu/kernels/gemm_rs.py:1077``).
Its fused engine, ``_fused_kernel`` (``:248``), computes each rank's
partial product and folds it around an ack-credited reduce-scatter ring
(``reduce_ring``, ``kernels/ring.py:238``; the fold is
``ew_add_pipeline``, ``:72``), so that rank r ends with the r-th row
block of ``Σ_q A_q @ B_q``.

Two forms:

* **world size 1**, ``gemm_rs(a, b)`` on tensors: there is nothing to
  reduce and the kernel is the GEMM, on the float-mode kernel of
  ``csrc/group_gemm.cu`` with one expert (launches counted apart, as
  ``gemm_rs_n1``);
* **over a mesh**, ``gemm_rs(a_shards, b_shards, mesh, axis)``: a list of
  W column shards A_q (W·m, K_q) and a list of W row shards B_q (K_q, N)
  → a list of W (m, N) outputs. On the card one launch of
  ``tdt_gemm_rs`` (``csrc/gemm_rs.cu``) covers every rank: each output
  tile runs its K loop over (rank q, k-block), reading A_q's rows and
  B_q through the peer tables, sums in f32 and rounds once.

Rounding: the TPU ring folds each hop's partial into a slab of the
output type (``gemm_rs.py:551``), so in bf16 it rounds once per hop; the
port sums over every rank in f32 and rounds once. In bf16 the two differ
by up to about (W − 1) bf16 ulps of the result; in f32 they agree to the
summation order.

On CPU tensors :func:`gemm_rs` runs :func:`gemm_rs_plain`. The wire
variants (``_fused_kernel_w``, ``_mxw``, ``_mxr``) are ROADMAP Queue 2
item 17.
"""

from __future__ import annotations

from triton_distributed_tpu_torch.config import to_torch_dtype
from triton_distributed_tpu_torch.kernels.ag_gemm import (
    _check,
    _is_shards,
    ag_gemm_plain,
    check_shards,
    launch_mesh_gemm,
)


def _check_rs(a, b, mesh, axis):
    n = check_shards(a, b, mesh, axis, "gemm_rs")
    if a[0].shape[1] != b[0].shape[0]:
        raise ValueError(f"gemm_rs: contract dim mismatch "
                         f"{tuple(a[0].shape)} @ {tuple(b[0].shape)}")
    if a[0].shape[0] % n:
        raise ValueError(f"gemm_rs: {a[0].shape[0]} rows do not scatter "
                         f"over {n} ranks")
    return n


def gemm_rs_plain(a, b, mesh=None, axis: str = "tp", *, out_dtype=None):
    """Plain PyTorch version. Tensors: ``a @ b`` in f32, cast to
    ``out_dtype`` (default a's dtype). Shard lists: ``Σ_q A_q @ B_q`` in
    f32, cut into W row blocks, each cast once."""
    if not _is_shards(a):
        return ag_gemm_plain(a, b, mesh, axis, out_dtype=out_dtype)
    n = _check_rs(a, b, mesh, axis)
    out_dtype = to_torch_dtype(out_dtype or a[0].dtype)
    acc = sum(aq.float() @ bq.float() for aq, bq in zip(a, b))
    return [blk.to(out_dtype) for blk in acc.chunk(n, dim=0)]


def gemm_rs(a, b, mesh=None, axis: str = "tp", *, out_dtype=None):
    """ReduceScatter(A @ B) (row-parallel).

    World size 1: a (M, K), b (K, N) tensors → (M, N). Over a mesh: a a
    list of W column shards (W·m, K_q), b a list of W row shards (K_q, N)
    → a list of W (m, N) outputs, rank r's row block r of the sum over
    ranks. A and B both bf16 or both f32 on the card; ``out_dtype``
    (default A's dtype) f32 or bf16. On CPU tensors this is
    :func:`gemm_rs_plain`; on CUDA tensors it launches the kernel or
    raises."""
    if not _is_shards(a):
        _check(a, b, mesh, axis, "gemm_rs")
        if a.device.type == "cpu":
            return gemm_rs_plain(a, b, out_dtype=out_dtype)
        return _gemm_rs_cuda(a, b, out_dtype)
    n = _check_rs(a, b, mesh, axis)
    if a[0].device.type == "cpu":
        return gemm_rs_plain(a, b, mesh, axis, out_dtype=out_dtype)
    return _gemm_rs_mesh_cuda(a, b, mesh, n, out_dtype)


def _gemm_rs_cuda(a, b, out_dtype):
    from triton_distributed_tpu_torch.kernels.group_gemm import float_gemm

    out = float_gemm(a, b, out_dtype)
    _gemm_rs_cuda.launches += 1
    return out


def _gemm_rs_mesh_cuda(a, b, mesh, n, out_dtype):
    m = a[0].shape[0] // n
    out = launch_mesh_gemm("tdt_gemm_rs", a, b, mesh, n, m, m, out_dtype)
    _gemm_rs_mesh_cuda.launches += 1
    return out


#: launch counts of the kernels (plain ints on the wrappers): the world-
#: size-1 GEMM, and the kernel over a mesh
_gemm_rs_cuda.launches = 0
_gemm_rs_mesh_cuda.launches = 0
