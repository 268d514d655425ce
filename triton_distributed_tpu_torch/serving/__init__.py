from triton_distributed_tpu_torch.serving.engine import (
    TIERS,
    DisaggregatedEngine,
    DisaggStats,
    EngineConfig,
    EngineStats,
    Request,
    ServingEngine,
    ShipRecord,
    TenantConfig,
    effective_rank,
    poisson_trace,
    tier_rank,
)
from triton_distributed_tpu_torch.serving.protocol import ProtocolOps
from triton_distributed_tpu_torch.serving.state import (
    CpPagePool,
    PagePool,
    ServingState,
    fresh_table,
    page_chain_hash,
)

__all__ = [
    "TIERS",
    "CpPagePool",
    "DisaggStats",
    "DisaggregatedEngine",
    "EngineConfig",
    "EngineStats",
    "PagePool",
    "ProtocolOps",
    "Request",
    "ServingEngine",
    "ServingState",
    "ShipRecord",
    "TenantConfig",
    "effective_rank",
    "fresh_table",
    "page_chain_hash",
    "poisson_trace",
    "tier_rank",
]
