from triton_distributed_tpu_torch.layers.attention import RaggedPagedAttention

__all__ = ["RaggedPagedAttention"]
