"""The port's ops: the expert-parallel MoE MLP (fused and padded-slot
transports), the MoE-TP overlap GEMMs and the composed MoE-TP pipeline,
and the TP overlap GEMMs."""

from triton_distributed_tpu_torch.ops.moe import (
    EPMoEContext,
    EPMoEState,
    create_ep_moe_context,
    create_ep_moe_state,
    ep_moe,
)
from triton_distributed_tpu_torch.ops.moe_tp import (
    MoETPContext,
    ShardedRouting,
    ag_group_gemm,
    ag_group_gemm_device,
    ag_group_gemm_fused,
    align_routing,
    align_routing_sharded,
    create_ag_group_gemm_context,
    create_moe_rs_context,
    moe_reduce_rs,
    moe_reduce_rs_fused,
    moe_tp_mlp,
    moe_tp_mlp_device,
    moe_tp_mlp_overlapped,
)
from triton_distributed_tpu_torch.ops.overlap import (
    OverlapContext,
    ag_gemm,
    create_ag_gemm_context,
    create_gemm_rs_context,
    gemm_rs,
)

__all__ = [
    "EPMoEContext",
    "EPMoEState",
    "MoETPContext",
    "OverlapContext",
    "ShardedRouting",
    "ag_gemm",
    "ag_group_gemm",
    "ag_group_gemm_device",
    "ag_group_gemm_fused",
    "align_routing",
    "align_routing_sharded",
    "create_ag_gemm_context",
    "create_ag_group_gemm_context",
    "create_ep_moe_context",
    "create_ep_moe_state",
    "create_gemm_rs_context",
    "create_moe_rs_context",
    "ep_moe",
    "gemm_rs",
    "moe_reduce_rs",
    "moe_reduce_rs_fused",
    "moe_tp_mlp",
    "moe_tp_mlp_device",
    "moe_tp_mlp_overlapped",
]
