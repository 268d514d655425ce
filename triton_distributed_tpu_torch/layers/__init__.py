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

__all__ = [
    "ColumnParallelLinear",
    "ParallelMLP",
    "RaggedPagedAttention",
    "RowParallelLinear",
    "SpGQAFlashDecodeAttention",
    "append_kv",
    "paged_append_kv",
]
