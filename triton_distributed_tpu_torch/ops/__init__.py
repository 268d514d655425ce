"""The port's ops: the expert-parallel MoE MLP at world size 1."""

from triton_distributed_tpu_torch.ops.moe import (
    EPMoEContext,
    EPMoEState,
    create_ep_moe_context,
    create_ep_moe_state,
    ep_moe,
)

__all__ = [
    "EPMoEContext",
    "EPMoEState",
    "create_ep_moe_context",
    "create_ep_moe_state",
    "ep_moe",
]
