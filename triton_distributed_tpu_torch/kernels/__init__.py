"""The port's kernels: each module keeps a plain PyTorch version beside
the wrapper of its hand-written CUDA kernel (``csrc/``). The attention
wrapper is not re-exported here: its name is its module's. The MoE
modules (``moe_utils``, ``moe_all_to_all``, ``moe_dispatch``), the
decode entries of ``flash_decode``, ``ag_gemm`` / ``gemm_rs`` (at world
size 1 and over a mesh), ``allgather`` and the MoE-TP GEMMs
(``moe_tp_fused``) are imported by name."""

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


def _counters() -> dict:
    """Each CUDA kernel's name → (the wrapper that launches it, the
    attribute that counts its launches). The float grouped GEMM's
    wrapper launches two kernels: bf16 on tensor cores, f32 on FMA; the
    all-to-all's counts its launches at one rank and over a mesh
    apart."""
    from triton_distributed_tpu_torch.kernels import ag_gemm as agg
    from triton_distributed_tpu_torch.kernels import allgather as ag
    from triton_distributed_tpu_torch.kernels import flash_decode as fd
    from triton_distributed_tpu_torch.kernels import gemm_rs as grs
    from triton_distributed_tpu_torch.kernels import group_gemm as gg
    from triton_distributed_tpu_torch.kernels import moe_dispatch as md
    from triton_distributed_tpu_torch.kernels import moe_tp_fused as mtf
    from triton_distributed_tpu_torch.kernels import ragged_paged_attention as rpa

    return {
        "ggemm_w8a8": (gg._w8a8_cuda, "launches"),
        "ggemm_w8a16": (gg._w8a16_cuda, "launches"),
        "ragged_paged_attention": (rpa._ragged_cuda, "launches"),
        "ggemm_bf16": (gg._ggemm_f_cuda, "launches_bf16"),
        "ggemm_f32": (gg._ggemm_f_cuda, "launches_f32"),
        "chunked_a2a": (md._chunked_a2a_cuda, "launches"),
        "flash_decode": (fd._flash_decode_cuda, "launches"),
        "paged_decode": (fd._paged_decode_cuda, "launches"),
        "ag_gemm_n1": (agg._ag_gemm_cuda, "launches"),
        "gemm_rs_n1": (grs._gemm_rs_cuda, "launches"),
        "ag_group_gemm": (mtf._ag_group_gemm_cuda, "launches"),
        "moe_reduce_rs": (mtf._moe_reduce_rs_cuda, "launches"),
        "ag_gemm": (agg._ag_gemm_mesh_cuda, "launches"),
        "gemm_rs": (grs._gemm_rs_mesh_cuda, "launches"),
        "all_gather": (ag._all_gather_cuda, "launches"),
        "chunked_a2a_mesh": (md._chunked_a2a_cuda, "launches_mesh"),
        "ag_group_gemm_mesh": (mtf._ag_group_gemm_mesh_cuda, "launches"),
        "moe_reduce_rs_mesh": (mtf._moe_reduce_rs_mesh_cuda, "launches"),
    }


def launch_counts() -> dict:
    """Launches of each CUDA kernel since the last :func:`reset_launch_counts`."""
    return {name: getattr(fn, attr)
            for name, (fn, attr) in _counters().items()}


def reset_launch_counts() -> None:
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)
        if hasattr(fn, "by_tpu_kernel"):
            fn.by_tpu_kernel.clear()
