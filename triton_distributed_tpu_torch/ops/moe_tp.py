"""MoE tensor-parallel overlap ops: AG-GroupGEMM and GroupGEMM-Reduce-RS.

Port of the overlapped (inference) pipeline of
``triton_distributed_tpu/ops/moe_tp.py`` at world size 1: per-shard
routing (:func:`align_routing_sharded`), the up projection over the
gathered expert-sorted rows (:func:`ag_group_gemm_fused`), the down
projection into the reduce and the top-k combine
(:func:`moe_reduce_rs_fused`), and the whole MLP
(:func:`moe_tp_mlp_overlapped`). One GPU holds every expert's full F,
so there is no mesh and ``tp == 1``: the gather and the reduce are the
identity, and each op is one launch of a kernel of
:mod:`~triton_distributed_tpu_torch.kernels.moe_tp_fused`.

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


@dataclass(frozen=True)
class MoETPContext:
    """Static geometry of the MoE-TP pipeline at ``tp == 1``: the
    experts, the top-k, the routing ``block_m`` (128 as in JAX; a
    multiple of the CUDA kernels' 64-row tile) and the compute dtype."""

    num_experts: int
    topk: int
    block_m: int = 128
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        object.__setattr__(self, "dtype", to_torch_dtype(self.dtype))


def create_ag_group_gemm_context(*, num_experts, topk, **kw) -> MoETPContext:
    """The context of both overlapped engines (JAX builds one for each
    with the same fields)."""
    return MoETPContext(num_experts=num_experts, topk=topk, **kw)


create_moe_rs_context = create_ag_group_gemm_context


@dataclass(frozen=True)
class ShardedRouting:
    """The one shard's routing tables: its tokens in expert-sorted
    order (JAX stacks them over the tp shards)."""

    sti: torch.Tensor       # (cap_s,) sorted token ids, M·k at padding
    be: torch.Tensor        # (cap_s / block_m,) block → expert
    splits: torch.Tensor    # (E,) true per-expert counts

    @property
    def cap_s(self) -> int:
        return self.sti.shape[0]


def align_routing_sharded(ctx: MoETPContext, topk_ids) -> ShardedRouting:
    """``moe_align_block_size`` of the (M, k) ``topk_ids`` at
    ``ctx.block_m``: at one shard, JAX's per-shard tables."""
    sti, be, splits = mu.moe_align_block_size(topk_ids, ctx.num_experts,
                                              ctx.block_m)
    return ShardedRouting(sti=sti, be=be, splits=splits)


def _check_blocks(ctx: MoETPContext, cap_s: int):
    if mtf.pick_gg_blocks(ctx.block_m, cap_s) is None:
        raise ValueError(
            f"overlapped MoE-TP: {cap_s} sorted rows do not split into "
            f"block_m={ctx.block_m} blocks")


def ag_group_gemm_fused(x, routing: ShardedRouting, w, ctx: MoETPContext):
    """AG ⊕ up-projection grouped GEMM: x (M, K) tokens, w (E, K, N) →
    (cap_s, N) sorted rows in ``ctx.dtype`` (zeros at the
    padding). x and w are cast to ``ctx.dtype`` as JAX casts the slab."""
    _check_blocks(ctx, routing.cap_s)
    dt = ctx.dtype
    return mtf.ag_group_gemm(x.to(dt).contiguous(), routing.sti, routing.be,
                             w.to(dt), ctx.topk, out_dtype=dt)


def moe_reduce_rs_fused(y, routing: ShardedRouting, weights, w,
                        ctx: MoETPContext):
    """Down-projection grouped GEMM ⊕ reduce, then the top-k combine:
    y (cap_s, F) sorted post-activation rows, weights (M, k) router
    weights, w (E, F, H) → (M, H) in ``ctx.dtype``."""
    if y.shape[0] != routing.cap_s:
        raise ValueError(f"y has {y.shape[0]} rows, the routing "
                         f"{routing.cap_s}")
    _check_blocks(ctx, routing.cap_s)
    dt = ctx.dtype
    red = mtf.moe_reduce_rs(y.to(dt).contiguous(), routing.be, w.to(dt),
                            out_dtype=dt)
    out = mu.scatter_combine(red, routing.sti, weights, weights.shape[0])
    return out.to(dt)


def moe_tp_mlp_overlapped(x, topk_ids, topk_weights, w_up, w_down,
                          ctx: MoETPContext, activation: str = "silu"):
    """The overlapped TP MoE MLP: AG ⊕ up grouped GEMM → activation (in
    f32, cast to ``ctx.dtype``) → down grouped GEMM ⊕ reduce → top-k
    combine. x (M, H), topk_ids / topk_weights (M, k), w_up (E, H, F),
    w_down (E, F, H) → (M, H) in ``ctx.dtype``."""
    from triton_distributed_tpu_torch.ops.moe import _act

    routing = align_routing_sharded(ctx, topk_ids)
    h = ag_group_gemm_fused(x, routing, w_up, ctx)
    h = _act(activation, h.float()).to(ctx.dtype)
    return moe_reduce_rs_fused(h, routing, topk_weights, w_down, ctx)
