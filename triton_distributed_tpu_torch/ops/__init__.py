"""The port's ops: the expert-parallel MoE MLP and the TP overlap
GEMMs, at world size 1."""

from triton_distributed_tpu_torch.ops.moe import (
    EPMoEContext,
    EPMoEState,
    create_ep_moe_context,
    create_ep_moe_state,
    ep_moe,
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
    "OverlapContext",
    "ag_gemm",
    "create_ag_gemm_context",
    "create_gemm_rs_context",
    "create_ep_moe_context",
    "create_ep_moe_state",
    "ep_moe",
    "gemm_rs",
]
