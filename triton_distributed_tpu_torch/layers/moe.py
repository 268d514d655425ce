"""MoE layers: the EP all-to-all layer and the two full MoE MLP flavours.

Port of ``triton_distributed_tpu/layers/moe.py``:

* :class:`EPAll2AllLayer`: the padded-slot dispatch / combine pair
  (``kernels/moe_all_to_all.py`` over the dense all-to-all) around
  expert code the caller runs between the legs;
* :class:`EPMoEMLP`: the f32 router (on the float-mode kernel,
  :func:`~triton_distributed_tpu_torch.kernels.group_gemm.router_logits`),
  then
  :func:`~triton_distributed_tpu_torch.ops.moe.ep_moe` on the layer's
  context (over its mesh when it has one: the experts, and the token
  rows, split over the ranks);
* :class:`MoETPMLP`: the tensor-parallel MoE MLP, the single-body
  ``moe_tp_mlp`` (``fused=True``) or the composed ``ag_group_gemm`` →
  activation → ``moe_reduce_rs`` over the reduce-scatter
  (``fused=False``), from :mod:`~triton_distributed_tpu_torch.ops.moe_tp`.

The port runs them forward only: JAX's ``moe_tp_mlp`` is
differentiable, but the port's grouped GEMM has no backward yet, so an
input or weight that requires a gradient raises (the rest of ROADMAP
Queue 1 step 9b).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from triton_distributed_tpu_torch.kernels import moe_all_to_all as ma
from triton_distributed_tpu_torch.ops.moe import EPMoEContext, _act, ep_moe
from triton_distributed_tpu_torch.ops.moe_tp import (
    MoETPContext,
    ag_group_gemm,
    align_routing,
    moe_reduce_rs,
    moe_tp_mlp,
)


@dataclass(frozen=True)
class EPAll2AllLayer:
    """Dispatch / combine pair around caller-provided expert compute (JAX
    ``layers/moe.py:34``). Over a mesh every rank's tensors are stacked on
    a leading dim (W, ...); at one rank the leading dim may be left out."""

    ctx: ma.MoEAllToAllContext

    def dispatch(self, tokens_sorted, splits):
        """(..., M, H) expert-sorted tokens + (..., E) counts → ((..., n,
        max_m, H) received tokens, (..., n, epr) received counts)."""
        packed = ma.pack_slots(
            self.ctx, *ma.dispatch_stage(self.ctx, tokens_sorted, splits))
        return ma.recv_tokens_view(self.ctx,
                                   ma.fast_all_to_all(self.ctx, packed))

    def combine(self, toks, splits, m_total: int):
        """(..., n, max_m, H) processed tokens → (..., m_total, H) back in
        each rank's own sorted order."""
        comb = ma.fast_all_to_all(self.ctx, ma.combine_stage(self.ctx, toks))
        return ma.combine_unstage(self.ctx, ma.combine_unpack(self.ctx, comb),
                                  splits, m_total)


@dataclass(frozen=True)
class EPMoEMLP:
    """Expert-parallel MoE MLP layer (router + dispatch + grouped MLP +
    combine in one call). Params: {"router": (H, E), "up": (E, H, F),
    "down": (E, F, H)} (float tensors or int8 dicts)."""

    ctx: EPMoEContext

    def __call__(self, params, x):
        """x: (M, H) tokens → (M, H) in x's dtype."""
        from triton_distributed_tpu_torch.kernels.group_gemm import (
            router_logits,
        )

        logits = router_logits(x, params["router"])
        return ep_moe(x, logits, params["up"], params["down"], self.ctx)


def _requires_grad(node) -> bool:
    if isinstance(node, torch.Tensor):
        return node.requires_grad
    if isinstance(node, dict):
        return any(_requires_grad(v) for v in node.values())
    if isinstance(node, (list, tuple)):
        return any(_requires_grad(v) for v in node)
    return False


@dataclass(frozen=True)
class MoETPMLP:
    """Tensor-parallel MoE MLP layer (JAX ``layers/moe.py:102``). Params:
    {"up": (E, H, F), "down": (E, F, H)}, over a mesh lists of tp F
    shards. ``fused=True`` (the default): :func:`~triton_distributed_tpu_
    torch.ops.moe_tp.moe_tp_mlp`; ``fused=False``: the composed
    ``ag_group_gemm`` → activation → ``moe_reduce_rs`` over the
    reduce-scatter, the routing aligned once. As in JAX, the composed
    form applies silu for ``activation="silu"`` and gelu otherwise."""

    ctx: MoETPContext
    activation: str = "silu"
    fused: bool = True

    def __call__(self, params, x, topk_ids, topk_weights):
        """x (M, H) tokens, topk_ids / topk_weights (M, k) → (M, H) in
        ``ctx.dtype``. Forward only: a gradient raises."""
        if _requires_grad((params, x, topk_weights)):
            raise NotImplementedError(
                "MoETPMLP runs forward only: its backward (the grouped "
                "GEMM's and the composed MoE-TP's) is the rest of ROADMAP "
                "Queue 1 step 9b; call it on tensors that require no "
                "gradient")
        if self.fused:
            return moe_tp_mlp(x, topk_ids, topk_weights, params["up"],
                              params["down"], self.ctx,
                              activation=self.activation)
        routing = align_routing(self.ctx, topk_ids)
        y = ag_group_gemm(x, routing, params["up"], self.ctx)
        act = "silu" if self.activation == "silu" else "gelu"
        y = ([_act(act, t) for t in y] if isinstance(y, list)
             else _act(act, y))
        return moe_reduce_rs(y, routing, topk_weights, params["down"],
                             self.ctx)
