"""Context-managed AG-GEMM / GEMM-RS, forward only, at world size 1.

Port of ``triton_distributed_tpu/ops/overlap.py``: the context and the
two ops that the model's prefill projections call. The JAX context
carries the mesh, axis, engine and output dtype; one GPU has no mesh,
so the port's keeps the world size (1 until the collectives land). The
custom VJPs (``:200-347``) come with training.
"""

from __future__ import annotations

from dataclasses import dataclass

from triton_distributed_tpu_torch.kernels.ag_gemm import ag_gemm as _ag_gemm_raw
from triton_distributed_tpu_torch.kernels.gemm_rs import gemm_rs as _gemm_rs_raw


@dataclass(frozen=True)
class OverlapContext:
    """Shared context of the TP overlap ops."""

    world_size: int = 1


def create_ag_gemm_context(**kw) -> OverlapContext:
    return OverlapContext(**kw)


def create_gemm_rs_context(**kw) -> OverlapContext:
    return OverlapContext(**kw)


def ag_gemm(a, b, ctx: OverlapContext):
    """AllGather(A) @ B (column-parallel): a (M, K), b (K, N)."""
    return _ag_gemm_raw(a, b, world_size=ctx.world_size)


def gemm_rs(a, b, ctx: OverlapContext):
    """(A @ B) → ReduceScatter (row-parallel): a (M, K), b (K, N)."""
    return _gemm_rs_raw(a, b, world_size=ctx.world_size)
