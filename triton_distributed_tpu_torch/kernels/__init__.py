"""The port's kernels: each module keeps a plain PyTorch version beside
the wrapper of its hand-written CUDA kernel (``csrc/``). The attention
wrapper is not re-exported here: its name is its module's."""

from triton_distributed_tpu_torch.kernels.flash_decode import quantize_kv
from triton_distributed_tpu_torch.kernels.group_gemm import (
    dequantize_grouped_weights,
    grouped_matmul,
    grouped_matmul_plain,
    quantize_act_rows,
    quantize_grouped_weights,
)
from triton_distributed_tpu_torch.kernels.ragged_paged_attention import (
    auto_block_q,
    pack_gqa_rows,
    ragged_paged_attention_plain,
    unpack_gqa_rows,
)

__all__ = [
    "auto_block_q",
    "dequantize_grouped_weights",
    "grouped_matmul",
    "grouped_matmul_plain",
    "pack_gqa_rows",
    "quantize_act_rows",
    "quantize_grouped_weights",
    "quantize_kv",
    "ragged_paged_attention_plain",
    "unpack_gqa_rows",
]


def launch_counts() -> dict:
    """Launches of each CUDA kernel since the last :func:`reset_launch_counts`."""
    from triton_distributed_tpu_torch.kernels import group_gemm as gg
    from triton_distributed_tpu_torch.kernels import ragged_paged_attention as rpa

    return {
        "ggemm_w8a8": gg._w8a8_cuda.launches,
        "ggemm_w8a16": gg._w8a16_cuda.launches,
        "ragged_paged_attention": rpa._ragged_cuda.launches,
    }


def reset_launch_counts() -> None:
    from triton_distributed_tpu_torch.kernels import group_gemm as gg
    from triton_distributed_tpu_torch.kernels import ragged_paged_attention as rpa

    gg._w8a8_cuda.launches = 0
    gg._w8a16_cuda.launches = 0
    rpa._ragged_cuda.launches = 0
