"""Context-managed AG-GEMM / GEMM-RS, forward only.

Port of ``triton_distributed_tpu/ops/overlap.py``: the context and the
two ops that the model's prefill projections and the tensor-parallel
layers call. The context carries the mesh and axis (``:62``, ``:105``,
``:110``), the output dtype and the forward's quantized wire
(``wire_dtype``, ``:73-75``: None / 'bf16', 'fp8', 'int8' or 'int8-mxu',
passed to :func:`~triton_distributed_tpu_torch.kernels.ag_gemm.ag_gemm`
and :func:`~triton_distributed_tpu_torch.kernels.gemm_rs.gemm_rs`); a
context without a mesh is world size 1, where the ops take tensors.
Over a mesh the ops take lists of per-rank shards. ``method`` (``:66``)
is the engine, None for JAX's heuristic: an :class:`~triton_distributed_
tpu_torch.kernels.ag_gemm.AGGemmMethod` or a :class:`~triton_distributed_
tpu_torch.kernels.gemm_rs.GemmRSMethod` (a spelling becomes the latter).
Each op takes the member of its own enum with the same name, as JAX's
``_dual_method`` maps a pinned engine (``:52-58``); the engine decides
the int8-mxu wire's numerics. Tuned winners come with ``tune/`` (ROADMAP
Queue 1 step 10). The backward wire (``bwd_wire_dtype``) and the custom
VJPs (``:200-347``) come with training (ROADMAP Queue 1 step 9).
"""

from __future__ import annotations

from dataclasses import dataclass

from triton_distributed_tpu_torch.kernels.ag_gemm import AGGemmMethod
from triton_distributed_tpu_torch.kernels.ag_gemm import ag_gemm as _ag_gemm_raw
from triton_distributed_tpu_torch.kernels.gemm_rs import GemmRSMethod
from triton_distributed_tpu_torch.kernels.gemm_rs import gemm_rs as _gemm_rs_raw
from triton_distributed_tpu_torch.lang.wire import normalize_wire
from triton_distributed_tpu_torch.runtime.topology import Mesh


@dataclass(frozen=True)
class OverlapContext:
    """Shared context of the TP overlap ops: ``mesh`` None is world
    size 1; ``method`` the engine (None: JAX's heuristic; see the module
    docstring); ``wire_dtype`` the forward's wire; ``bwd_wire_dtype`` the
    backward duals' (only None: training is not ported)."""

    mesh: Mesh | None = None
    axis: str = "tp"
    method: AGGemmMethod | GemmRSMethod | None = None
    out_dtype: object = None
    wire_dtype: object = None
    bwd_wire_dtype: object = None

    def __post_init__(self):
        # fail at the context's build on a spelling outside lang.wire's
        normalize_wire(self.wire_dtype)
        if self.method is not None and not isinstance(
                self.method, (AGGemmMethod, GemmRSMethod)):
            object.__setattr__(self, "method", GemmRSMethod(self.method))
        if normalize_wire(self.bwd_wire_dtype) is not None:
            raise NotImplementedError(
                f"bwd_wire_dtype={self.bwd_wire_dtype!r}: the backward duals "
                "come with the training step (ROADMAP Queue 1 step 9); the "
                "port's overlap ops are forward only")


def create_ag_gemm_context(mesh=None, axis="tp", **kw) -> OverlapContext:
    return OverlapContext(mesh=mesh, axis=axis, **kw)


def create_gemm_rs_context(mesh=None, axis="tp", **kw) -> OverlapContext:
    return OverlapContext(mesh=mesh, axis=axis, **kw)


def _method(method, target_enum):
    """A pinned engine as the op's own enum, by member name (JAX's
    ``_dual_method``); None stays None."""
    return None if method is None else target_enum[method.name]


def ag_gemm(a, b, ctx: OverlapContext):
    """AllGather(A) @ B (column-parallel): tensors a (M, K), b (K, N) at
    world size 1; lists of W row shards of A and column shards of B over
    the context's mesh, on the context's engine and wire."""
    return _ag_gemm_raw(a, b, ctx.mesh, ctx.axis,
                        method=_method(ctx.method, AGGemmMethod),
                        out_dtype=ctx.out_dtype, wire_dtype=ctx.wire_dtype)


def gemm_rs(a, b, ctx: OverlapContext):
    """(A @ B) → ReduceScatter (row-parallel): tensors a (M, K), b (K, N)
    at world size 1; lists of W column shards of A and row shards of B
    over the context's mesh, on the context's engine and wire."""
    return _gemm_rs_raw(a, b, ctx.mesh, ctx.axis,
                        method=_method(ctx.method, GemmRSMethod),
                        out_dtype=ctx.out_dtype, wire_dtype=ctx.wire_dtype)
