"""Differentiable overlap ops: context-managed AG-GEMM / GEMM-RS.

Port of ``triton_distributed_tpu/ops/overlap.py``: the context and the
two ops that the model's projections and the tensor-parallel layers
call. The context carries the mesh and axis (``:62``, ``:105``, ``:110``),
the engine (``method``, ``:66``: an :class:`~triton_distributed_tpu_
torch.kernels.ag_gemm.AGGemmMethod` or :class:`~triton_distributed_tpu_
torch.kernels.gemm_rs.GemmRSMethod`, None for JAX's heuristic; each op
takes the member of its own enum with the same name, as JAX's
``_dual_method`` maps a pinned engine, ``:52-58``), the output dtype, the
forward's quantized wire (``wire_dtype``: None / 'bf16', 'fp8', 'int8',
'int8-mxu'), the backward duals' wire (``bwd_wire_dtype``), the
collective id that seeds the duals' rings, and ``save_gathered``. A
context without a mesh is world size 1, where the ops take tensors; over
a mesh they take lists of per-rank shards. ``batch_axes`` beside the
tp axis raise (dp axes beside tp are ROADMAP Queue 1 step 8).

The ops are ``torch.autograd.Function``\\ s (JAX's ``custom_vjp``,
``:200-347``): the backward of each op's activation gradient is the dual
overlap op, on the kernels the forward runs.

* d(AG-GEMM): dA = GEMM-RS(dC, Bᵀ) (``tdt_gemm_rs``); dB = AG(A)ᵀ @ dC,
  a local ``torch.matmul`` in f32 (JAX's ``jnp.dot`` outside any
  kernel). With ``save_gathered`` and the fused engine
  (:func:`_fused_forward`, the same pure gate in forward and backward)
  the forward saves the gathered A (``ag_gemm(return_gathered=True)``),
  else the backward gathers A again (the all-gather kernel).
* d(GEMM-RS): dA = AG-GEMM(dC, Bᵀ) with ``return_gathered``
  (``tdt_ag_gemm`` and the gathered dC); dB = Aᵀ @ AG(dC), local.

With ``bwd_wire_dtype`` resolved (:func:`_resolve_bwd`), dA runs on the
gradient rings of :mod:`~triton_distributed_tpu_torch.train.grad_wire`
instead: ``ef_gemm_rs`` (error feedback + stochastic rounding, the
ring on ``tdt_grad_ring``) and ``ef_ag_gemm`` (quantize-once all-gather,
``tdt_grad_allgather``), seeded by ``derive_seed(collective_id, …)``.
JAX's preflight and fallback wrappers (``:350-473``: demotion to XLA
engines on an unhealthy peer) have no counterpart: the port does not
degrade (health is ROADMAP Queue 1 step 8).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from triton_distributed_tpu_torch.kernels.ag_gemm import (
    AGGemmMethod,
    auto_ag_gemm_method,
)
from triton_distributed_tpu_torch.kernels.ag_gemm import ag_gemm as _ag_gemm_raw
from triton_distributed_tpu_torch.kernels.gemm_rs import GemmRSMethod
from triton_distributed_tpu_torch.kernels.gemm_rs import gemm_rs as _gemm_rs_raw
from triton_distributed_tpu_torch.lang.wire import normalize_wire
from triton_distributed_tpu_torch.runtime.topology import Mesh, one_axis


@dataclass(frozen=True)
class OverlapContext:
    """Shared context of the TP overlap ops: ``mesh`` None is world
    size 1; ``method`` the engine (None: JAX's heuristic); ``wire_dtype``
    the forward's wire; ``bwd_wire_dtype`` the backward duals' (the same
    vocabulary: 'auto' demotes silently where the cotangent slab admits
    no ring, a pinned 'fp8' / 'int8' that cannot be carried raises in
    the backward); ``collective_id`` seeds the duals' rings;
    ``save_gathered``: keep the fused forward's gathered A for dB."""

    mesh: Mesh | None = None
    axis: str = "tp"
    batch_axes: tuple = ()
    method: AGGemmMethod | GemmRSMethod | None = None
    out_dtype: object = None
    collective_id: int = 8
    wire_dtype: object = None
    bwd_wire_dtype: object = None
    save_gathered: bool = True

    def __post_init__(self):
        # fail at the context's build on a spelling outside lang.wire's
        normalize_wire(self.wire_dtype)
        normalize_wire(self.bwd_wire_dtype)
        if self.method is not None and not isinstance(
                self.method, (AGGemmMethod, GemmRSMethod)):
            object.__setattr__(self, "method", GemmRSMethod(self.method))
        if tuple(self.batch_axes):
            raise NotImplementedError(
                f"batch_axes={tuple(self.batch_axes)!r}: data-parallel axes "
                "beside the tp axis are ROADMAP Queue 1 step 8")

    @property
    def tp(self) -> int:
        return 1 if self.mesh is None else self.mesh.axis_size(self.axis)


def create_ag_gemm_context(mesh=None, axis="tp", **kw) -> OverlapContext:
    return OverlapContext(mesh=mesh, axis=axis, **kw)


def create_gemm_rs_context(mesh=None, axis="tp", **kw) -> OverlapContext:
    kw.setdefault("collective_id", 9)
    return OverlapContext(mesh=mesh, axis=axis, **kw)


def _method(method, target_enum):
    """A pinned engine as the op's own enum, by member name (JAX's
    ``_dual_method``); None stays None."""
    return None if method is None else target_enum[method.name]


def _ring_mesh(ctx, like):
    """The mesh the duals' rings run over: the context's, or one rank on
    ``like``'s device at world size 1."""
    if ctx.mesh is not None:
        return ctx.mesh
    return Mesh.loopback(1, like.device, axis=ctx.axis)


def _resolve_bwd(ctx: OverlapContext, rows: int, cols: int):
    """The wire the backward's dual ring ships (JAX ``:127``) for a
    cotangent of ``rows`` global rows: None (the exact duals) or 'fp8' /
    'int8'. ``cols`` is the ring slab's width (K for ag_gemm's dA
    reduce-scatter, N for gemm_rs's dA all-gather). A pinned wire that
    cannot be carried raises here."""
    if ctx.bwd_wire_dtype is None:
        return None
    from triton_distributed_tpu_torch.train import grad_wire

    return grad_wire.resolve_grad_wire(ctx.bwd_wire_dtype, rows, cols, ctx.tp)


def _fused_forward(ctx, a, b) -> bool:
    """Whether the forward saves the gathered A (JAX ``:215-236``): only
    the fused engine emits it for free. A pure function of the context
    and the shapes (the explicit method, else the blockability
    heuristic), so forward and backward agree; at world size 1 there is
    nothing to gather."""
    if not isinstance(a, (list, tuple)):
        return False
    method = ctx.method
    if method is None:
        method = auto_ag_gemm_method(ctx.mesh, ctx.axis, a, b)
    return AGGemmMethod[method.name] == AGGemmMethod.PALLAS_FUSED


class _Meta:
    """An output's shape, dtype and device, for a zero cotangent."""

    def __init__(self, t):
        self.shape, self.dtype, self.device = t.shape, t.dtype, t.device


def _grads(gs, outs):
    """Output cotangents (contiguous, as the kernels take them), zeros
    where an output took none."""
    return [torch.zeros(m.shape, dtype=m.dtype, device=m.device)
            if g is None else g.contiguous() for g, m in zip(gs, outs)]


def _gathered_wgrad(xs, ys, dtypes):
    """Gather-free dB from an already-gathered operand, rank by rank
    (JAX ``_build_gathered_wgrad``, ``:160``): ``xᵀ @ y`` in f32, a local
    product as JAX's ``jnp.dot``, cast to the weight's dtype."""
    return [(x.float().t() @ y.float()).to(dt)
            for x, y, dt in zip(xs, ys, dtypes)]


def _ag_wgrad(ctx, a, g, dtypes):
    """dB of ``ag_gemm`` when the gathered A was not saved (JAX
    ``_build_ag_wgrad``, ``:139``): A gathered again (the all-gather
    kernel), then :func:`_gathered_wgrad`."""
    from triton_distributed_tpu_torch.kernels.allgather import all_gather

    return _gathered_wgrad(all_gather(a, ctx.mesh, ctx.axis), g, dtypes)


class _AGGemm(torch.autograd.Function):
    """AllGather(A) @ B with its dual backward; ``n`` None for tensors,
    else the mesh's ranks with the shards unpacked (A's, then B's)."""

    @staticmethod
    def forward(fctx, ctx, n, *ab):
        fctx.ctx, fctx.n = ctx, n
        a, b = ab if n is None else (list(ab[:n]), list(ab[n:]))
        fctx.saved_gathered = ctx.save_gathered and _fused_forward(ctx, a, b)
        # pinned when saving: the engine must be the one the gate promised
        method = (AGGemmMethod.PALLAS_FUSED if fctx.saved_gathered
                  else _method(ctx.method, AGGemmMethod))
        out = _ag_gemm_raw(a, b, ctx.mesh, ctx.axis, method=method,
                           out_dtype=ctx.out_dtype, wire_dtype=ctx.wire_dtype,
                           return_gathered=fctx.saved_gathered)
        if fctx.saved_gathered:
            out, a = out
        if n is None:
            fctx.save_for_backward(a, b)
            return out
        fctx.save_for_backward(*a, *b)
        fctx.outs = [_Meta(t) for t in out]
        return tuple(out)

    @staticmethod
    def backward(fctx, *gs):
        from triton_distributed_tpu_torch.train import grad_wire

        ctx, n = fctx.ctx, fctx.n
        saved = fctx.saved_tensors
        if n is None:
            a, b = saved
            a_l, b_l, g_l = [a], [b], [gs[0].contiguous()]
        else:
            a_l, b_l = list(saved[:n]), list(saved[n:])
            g_l = _grads(gs, fctx.outs)
        need_a, need_b = (fctx.needs_input_grad[2:2 + len(a_l)],
                          fctx.needs_input_grad[2 + len(a_l):])
        a_dtype = a_l[0].dtype
        da = db = None
        if any(need_a):
            bt = [t.t().contiguous() for t in b_l]
            wire = _resolve_bwd(ctx, g_l[0].shape[0], b_l[0].shape[0])
            if wire is not None:
                da = grad_wire.ef_gemm_rs(
                    g_l, bt, _ring_mesh(ctx, g_l[0]), ctx.axis,
                    out_dtype=a_dtype, wire=wire,
                    seed=grad_wire.derive_seed(ctx.collective_id,
                                               "ag_gemm.bwd"))
            elif n is None:
                da = [_gemm_rs_raw(g_l[0], bt[0], out_dtype=a_dtype)]
            else:
                da = _gemm_rs_raw(g_l, bt, ctx.mesh, ctx.axis,
                                  method=_method(ctx.method, GemmRSMethod),
                                  out_dtype=a_dtype)
        if any(need_b):
            dts = [t.dtype for t in b_l]
            db = (_gathered_wgrad(a_l, g_l, dts)
                  if n is None or fctx.saved_gathered
                  else _ag_wgrad(ctx, a_l, g_l, dts))
        if n is None:
            return (None, None, da[0] if da else None, db[0] if db else None)
        return (None, None, *(da or [None] * n), *(db or [None] * n))


class _GemmRS(torch.autograd.Function):
    """(A @ B) → ReduceScatter with its dual backward (see
    :class:`_AGGemm` for the argument layout)."""

    @staticmethod
    def forward(fctx, ctx, n, *ab):
        fctx.ctx, fctx.n = ctx, n
        fctx.save_for_backward(*ab)
        if n is None:
            a, b = ab
            return _gemm_rs_raw(a, b, ctx.mesh, ctx.axis,
                                method=_method(ctx.method, GemmRSMethod),
                                out_dtype=ctx.out_dtype,
                                wire_dtype=ctx.wire_dtype)
        out = _gemm_rs_raw(list(ab[:n]), list(ab[n:]), ctx.mesh, ctx.axis,
                           method=_method(ctx.method, GemmRSMethod),
                           out_dtype=ctx.out_dtype,
                           wire_dtype=ctx.wire_dtype)
        fctx.outs = [_Meta(t) for t in out]
        return tuple(out)

    @staticmethod
    def backward(fctx, *gs):
        from triton_distributed_tpu_torch.train import grad_wire

        ctx, n = fctx.ctx, fctx.n
        saved = fctx.saved_tensors
        k = 1 if n is None else n
        a_l, b_l = list(saved[:k]), list(saved[k:])
        rows = a_l[0].shape[0] // k
        g_l = [gs[0].contiguous()] if n is None else _grads(gs, fctx.outs)
        a_dtype = a_l[0].dtype
        bt = [t.t().contiguous() for t in b_l]
        wire = _resolve_bwd(ctx, rows * k, g_l[0].shape[1])
        if wire is not None:
            da, g_full = grad_wire.ef_ag_gemm(
                g_l, bt, _ring_mesh(ctx, g_l[0]), ctx.axis,
                out_dtype=a_dtype, wire=wire,
                seed=grad_wire.derive_seed(ctx.collective_id, "gemm_rs.bwd"),
                return_gathered=True)
        elif n is None:
            da, g_full = _ag_gemm_raw(g_l[0], bt[0], out_dtype=a_dtype,
                                      return_gathered=True)
            da, g_full = [da], [g_full]
        else:
            da, g_full = _ag_gemm_raw(
                g_l, bt, ctx.mesh, ctx.axis,
                method=_method(ctx.method, AGGemmMethod), out_dtype=a_dtype,
                return_gathered=True)
        need = fctx.needs_input_grad[2:]
        db = (_gathered_wgrad(a_l, g_full, [t.dtype for t in b_l])
              if any(need[k:]) else [None] * k)
        da = [d if na else None for d, na in zip(da, need[:k])]
        return (None, None, *da, *db)


def _apply(fn, raw, enum, a, b, ctx):
    """``fn`` where a gradient is wanted, else the forward kernel alone
    (``raw`` with the engine of ``enum``: no residual, so no gathered
    copy of A)."""
    shards = isinstance(a, (list, tuple))
    ts = [*a, *b] if shards else [a, b]
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in ts)):
        return raw(a, b, ctx.mesh, ctx.axis,
                   method=_method(ctx.method, enum),
                   out_dtype=ctx.out_dtype, wire_dtype=ctx.wire_dtype)
    if shards:
        n = one_axis(ctx.mesh, ctx.axis) if ctx.mesh is not None else len(a)
        if len(a) != n or len(b) != n:
            raise ValueError(f"the overlap ops over {n} ranks take {n} A and "
                             "B shards")
        return list(fn.apply(ctx, n, *a, *b))
    return fn.apply(ctx, None, a, b)


def ag_gemm(a, b, ctx: OverlapContext):
    """Differentiable AllGather(A) @ B (column-parallel): tensors a (M,
    K), b (K, N) at world size 1; lists of W row shards of A and column
    shards of B over the context's mesh, on the context's engine and
    wire."""
    return _apply(_AGGemm, _ag_gemm_raw, AGGemmMethod, a, b, ctx)


def gemm_rs(a, b, ctx: OverlapContext):
    """Differentiable (A @ B) → ReduceScatter (row-parallel): tensors a
    (M, K), b (K, N) at world size 1; lists of W column shards of A and
    row shards of B over the context's mesh, on the context's engine
    and wire."""
    return _apply(_GemmRS, _gemm_rs_raw, GemmRSMethod, a, b, ctx)
