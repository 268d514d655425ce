"""MoE tensor-parallel overlap ops: AG-GroupGEMM and GroupGEMM-Reduce-RS.

Port of the overlapped (inference) pipeline of
``triton_distributed_tpu/ops/moe_tp.py``: per-shard routing
(:func:`align_routing_sharded`), the up projection over the gathered
expert-sorted rows (:func:`ag_group_gemm_fused`), the down projection
into the reduce and the per-rank top-k combine
(:func:`moe_reduce_rs_fused`), and the whole MLP
(:func:`moe_tp_mlp_overlapped`), each op one launch of a kernel of
:mod:`~triton_distributed_tpu_torch.kernels.moe_tp_fused`.

Without a mesh one GPU holds every expert's full F (``tp == 1``): the
gather and the reduce are the identity. With one (``mesh=``) the F dim
of the experts is split over its axis (``w_up`` (E, H, F/tp) and
``w_down`` (E, F/tp, H) a rank) and the token rows too (row block s of
x is shard s): each shard aligns its own rows (the ``(tp, cap_s)``
tables), the up projection gives every rank all shards' sorted rows
against its F columns, and the reduce gives rank r the sum over ranks
of its own sorted rows, which it combines into its token rows.

Not ported: the quantized ring wires (JAX's ``wire_dtype``), which
come with the collectives, and the composed differentiable path (``moe_tp_mlp``,
``ag_group_gemm`` / ``moe_reduce_rs``), which comes with training.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from triton_distributed_tpu_torch.config import to_torch_dtype
from triton_distributed_tpu_torch.kernels import moe_tp_fused as mtf
from triton_distributed_tpu_torch.kernels import moe_utils as mu
from triton_distributed_tpu_torch.lang.shmem import require_stacked
from triton_distributed_tpu_torch.runtime.topology import Mesh, one_axis


@dataclass(frozen=True)
class MoETPContext:
    """Static geometry of the MoE-TP pipeline: the experts, the top-k,
    the routing ``block_m`` (128 as in JAX; a multiple of the CUDA
    kernels' 64-row tile), the compute dtype, and the ``mesh`` whose
    ``axis`` splits F (None: ``tp == 1``)."""

    num_experts: int
    topk: int
    block_m: int = 128
    dtype: torch.dtype = torch.bfloat16
    mesh: Mesh | None = None
    axis: str = "tp"

    def __post_init__(self):
        object.__setattr__(self, "dtype", to_torch_dtype(self.dtype))

    @property
    def tp(self) -> int:
        return 1 if self.mesh is None else one_axis(self.mesh, self.axis)


def create_ag_group_gemm_context(*, num_experts, topk, **kw) -> MoETPContext:
    """The context of both overlapped engines (JAX builds one for each
    with the same fields)."""
    return MoETPContext(num_experts=num_experts, topk=topk, **kw)


create_moe_rs_context = create_ag_group_gemm_context


@dataclass(frozen=True)
class ShardedRouting:
    """The shards' routing tables, each shard's tokens in expert-sorted
    order: over a mesh stacked ``(tp, ...)`` as JAX stacks them; without
    one the one shard's, unstacked."""

    sti: torch.Tensor       # ([tp,] cap_s) sorted token ids, M_s·k at padding
    be: torch.Tensor        # ([tp,] cap_s / block_m) block → expert
    splits: torch.Tensor    # ([tp,] E) true per-expert counts

    @property
    def cap_s(self) -> int:
        return self.sti.shape[-1]


def align_routing_sharded(ctx: MoETPContext, topk_ids) -> ShardedRouting:
    """``moe_align_block_size`` of the (M, k) ``topk_ids`` at
    ``ctx.block_m``, each shard's rows [s·M/tp, (s+1)·M/tp) on its own
    (JAX's per-shard tables; one pass for all shards)."""
    if ctx.mesh is None:
        sti, be, splits = mu.moe_align_block_size(
            topk_ids, ctx.num_experts, ctx.block_m)
        return ShardedRouting(sti=sti, be=be, splits=splits)
    m, k = topk_ids.shape
    if m % ctx.tp:
        raise ValueError(f"{m} token rows do not shard over tp = {ctx.tp}")
    sti, be, splits = mu.moe_align_block_size(
        topk_ids.reshape(ctx.tp, m // ctx.tp, k), ctx.num_experts,
        ctx.block_m)
    return ShardedRouting(sti=sti, be=be, splits=splits)


def _check_blocks(ctx: MoETPContext, cap_s: int):
    if mtf.pick_gg_blocks(ctx.block_m, cap_s) is None:
        raise ValueError(
            f"overlapped MoE-TP: {cap_s} sorted rows do not split into "
            f"block_m={ctx.block_m} blocks")


def ag_group_gemm_fused(x, routing: ShardedRouting, w, ctx: MoETPContext):
    """AG ⊕ up-projection grouped GEMM: x (M, K) tokens, w (E, K, N) →
    (cap_s, N) sorted rows in ``ctx.dtype`` (zeros at the padding). Over
    a mesh x's row block s is shard s and w is a list of tp column
    shards (E, K, N/tp) → a list of tp (tp·cap_s, N/tp) outputs, rank
    r's every shard's sorted rows against its columns. x and w are cast
    to ``ctx.dtype`` as JAX casts the slab."""
    _check_blocks(ctx, routing.cap_s)
    dt = ctx.dtype
    if ctx.mesh is None:
        return mtf.ag_group_gemm(x.to(dt).contiguous(), routing.sti,
                                 routing.be, w.to(dt), ctx.topk,
                                 out_dtype=dt)
    return mtf.ag_group_gemm_mesh(
        list(x.to(dt).contiguous().chunk(ctx.tp)), routing.sti, routing.be,
        [t.to(dt) for t in w], ctx.topk, ctx.mesh, ctx.axis, out_dtype=dt)


def moe_reduce_rs_fused(y, routing: ShardedRouting, weights, w,
                        ctx: MoETPContext):
    """Down-projection grouped GEMM ⊕ reduce, then the top-k combine:
    y (cap_s, F) sorted post-activation rows, weights (M, k) router
    weights, w (E, F, H) → (M, H) in ``ctx.dtype``. Over a mesh y and w
    are lists of tp shards ((tp·cap_s, F/tp) and (E, F/tp, H)); rank r
    sums its rows over the ranks and combines them into its token rows,
    row block r of the result."""
    _check_blocks(ctx, routing.cap_s)
    dt = ctx.dtype
    if ctx.mesh is None:
        if y.shape[0] != routing.cap_s:
            raise ValueError(f"y has {y.shape[0]} rows, the routing "
                             f"{routing.cap_s}")
        red = mtf.moe_reduce_rs(y.to(dt).contiguous(), routing.be, w.to(dt),
                                out_dtype=dt)
        out = mu.scatter_combine(red, routing.sti, weights, weights.shape[0])
        return out.to(dt)
    if y[0].shape[0] != ctx.tp * routing.cap_s:
        raise ValueError(f"y has {y[0].shape[0]} rows a rank, the routing "
                         f"{ctx.tp} x {routing.cap_s}")
    red = mtf.moe_reduce_rs_mesh([t.to(dt) for t in y], routing.be, [t.to(dt) for t in w],
                                 ctx.mesh, ctx.axis, out_dtype=dt)
    # every rank combines its own sorted rows into its token rows
    out = mu.scatter_combine(
        require_stacked(red, "the reduce's output"), routing.sti,
        weights.reshape(ctx.tp, -1, weights.shape[-1]),
        weights.shape[0] // ctx.tp)
    return out.reshape(weights.shape[0], -1).to(dt)


def moe_tp_mlp_overlapped(x, topk_ids, topk_weights, w_up, w_down,
                          ctx: MoETPContext, activation: str = "silu"):
    """The overlapped TP MoE MLP: AG ⊕ up grouped GEMM → activation (in
    f32, cast to ``ctx.dtype``) → down grouped GEMM ⊕ reduce → top-k
    combine. x (M, H), topk_ids / topk_weights (M, k), w_up (E, H, F),
    w_down (E, F, H) → (M, H) in ``ctx.dtype``; over a mesh w_up and
    w_down are lists of tp F shards and row block r of x and of the
    result is rank r's."""
    from triton_distributed_tpu_torch.ops.moe import _act

    routing = align_routing_sharded(ctx, topk_ids)
    h = ag_group_gemm_fused(x, routing, w_up, ctx)
    if ctx.mesh is None:
        h = _act(activation, h.float()).to(ctx.dtype)
    else:
        # every rank's activation at once, on the stacked output
        hs = _act(activation, require_stacked(h, "the up projection's "
                                             "output").float()).to(ctx.dtype)
        h = list(hs.unbind(0))
    return moe_reduce_rs_fused(h, routing, topk_weights, w_down, ctx)
