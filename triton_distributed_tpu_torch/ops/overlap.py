"""Context-managed AG-GEMM / GEMM-RS, forward only.

Port of ``triton_distributed_tpu/ops/overlap.py``: the context and the
two ops that the model's prefill projections call. The context carries
the mesh and axis (``:62``, ``:105``, ``:110``) and the output dtype; a
context without a mesh is world size 1, where the ops take tensors.
Over a mesh the ops take lists of per-rank shards (see
:mod:`~triton_distributed_tpu_torch.kernels.ag_gemm` and
:mod:`~triton_distributed_tpu_torch.kernels.gemm_rs`). The engine choice
(``method``), the wires and the custom VJPs (``:200-347``) come with
the ring variants and with training.
"""

from __future__ import annotations

from dataclasses import dataclass

from triton_distributed_tpu_torch.kernels.ag_gemm import ag_gemm as _ag_gemm_raw
from triton_distributed_tpu_torch.kernels.gemm_rs import gemm_rs as _gemm_rs_raw
from triton_distributed_tpu_torch.runtime.topology import Mesh


@dataclass(frozen=True)
class OverlapContext:
    """Shared context of the TP overlap ops: ``mesh`` None is world
    size 1."""

    mesh: Mesh | None = None
    axis: str = "tp"
    out_dtype: object = None


def create_ag_gemm_context(mesh=None, axis="tp", **kw) -> OverlapContext:
    return OverlapContext(mesh=mesh, axis=axis, **kw)


def create_gemm_rs_context(mesh=None, axis="tp", **kw) -> OverlapContext:
    return OverlapContext(mesh=mesh, axis=axis, **kw)


def ag_gemm(a, b, ctx: OverlapContext):
    """AllGather(A) @ B (column-parallel): tensors a (M, K), b (K, N) at
    world size 1; lists of W row shards of A and column shards of B over
    the context's mesh."""
    return _ag_gemm_raw(a, b, ctx.mesh, ctx.axis, out_dtype=ctx.out_dtype)


def gemm_rs(a, b, ctx: OverlapContext):
    """(A @ B) → ReduceScatter (row-parallel): tensors a (M, K), b (K, N)
    at world size 1; lists of W column shards of A and row shards of B
    over the context's mesh."""
    return _gemm_rs_raw(a, b, ctx.mesh, ctx.axis, out_dtype=ctx.out_dtype)
