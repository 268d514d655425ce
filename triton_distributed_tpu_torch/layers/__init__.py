from triton_distributed_tpu_torch.layers.allgather import AllGatherLayer
from triton_distributed_tpu_torch.layers.attention import (
    RaggedPagedAttention,
    SpGQAFlashDecodeAttention,
    append_kv,
    paged_append_kv,
)
from triton_distributed_tpu_torch.layers.linear import (
    ColumnParallelLinear,
    ParallelMLP,
    RowParallelLinear,
)
from triton_distributed_tpu_torch.layers.moe import (
    EPAll2AllLayer,
    EPMoEMLP,
    MoETPMLP,
)

__all__ = [
    "AllGatherLayer",
    "ColumnParallelLinear",
    "EPAll2AllLayer",
    "EPMoEMLP",
    "MoETPMLP",
    "ParallelMLP",
    "RaggedPagedAttention",
    "RowParallelLinear",
    "SpGQAFlashDecodeAttention",
    "append_kv",
    "paged_append_kv",
]
