"""MoE layers: the expert-parallel MoE MLP.

Port of ``EPMoEMLP`` of ``triton_distributed_tpu/layers/moe.py``: the
f32 router, then :func:`~triton_distributed_tpu_torch.ops.moe.ep_moe`
on the layer's context. ``MoETPMLP`` (the composed,
differentiable TP path) comes with training, and ``EPAll2AllLayer``
(the padded-slot ``pallas`` transport) with the collectives.
"""

from __future__ import annotations

from dataclasses import dataclass

from triton_distributed_tpu_torch.ops.moe import EPMoEContext, ep_moe


@dataclass(frozen=True)
class EPMoEMLP:
    """Expert-parallel MoE MLP layer (router + dispatch + grouped MLP +
    combine in one call). Params: {"router": (H, E), "up": (E, H, F),
    "down": (E, F, H)} (float tensors or int8 dicts)."""

    ctx: EPMoEContext

    def __call__(self, params, x):
        """x: (M, H) tokens → (M, H) in x's dtype."""
        logits = x.float() @ params["router"].float()
        return ep_moe(x, logits, params["up"], params["down"], self.ctx)
