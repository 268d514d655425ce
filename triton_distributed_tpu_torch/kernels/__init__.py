"""The port's kernels: each module keeps a plain PyTorch version beside
the wrapper of its hand-written CUDA kernel (``csrc/``). The attention
wrapper is not re-exported here: its name is its module's. The MoE
modules (``moe_utils``, ``moe_all_to_all``, ``moe_dispatch``), the
decode entries of ``flash_decode``, ``ag_gemm`` / ``gemm_rs`` (at world
size 1 and over a mesh, on the raw and the quantized wires), ``allgather``
the MoE-TP GEMMs (``moe_tp_fused``), the cp LSE-combine and the
context-parallel prefill's ring and all-to-all (``cp_ring``, launched from
``ring_attention``) and the KV-page ship (``kv_ship``, launched from the
disaggregated engine) are imported by name; so are the
entries ``all_to_all`` and ``reduce_scatter``, which would shadow their
modules, beside the exported stacked form and plain versions. The wire quantizer
``tdt_quantize_slab`` (``csrc/wire.cu``, :mod:`.wire`) is launched by the
AG-GEMM, all-gather and MoE-TP wire wrappers and counted on its own."""

from triton_distributed_tpu_torch.kernels.all_to_all import (
    all_to_all_device,
    all_to_all_plain,
)

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
from triton_distributed_tpu_torch.kernels.reduce_scatter import (
    reduce_scatter_plain,
    resolve_rs_wire,
)

__all__ = [
    "all_to_all_device",
    "all_to_all_plain",
    "auto_block_q",
    "dequantize_grouped_weights",
    "grouped_matmul",
    "grouped_matmul_plain",
    "pack_gqa_rows",
    "quantize_act_rows",
    "quantize_grouped_weights",
    "quantize_kv",
    "ragged_paged_attention_plain",
    "reduce_scatter_plain",
    "resolve_rs_wire",
    "unpack_gqa_rows",
]


def _counters() -> dict:
    """Each CUDA kernel's name → (the wrapper that launches it, the
    attribute that counts its launches). The float grouped GEMM's
    wrapper launches two kernels: bf16 on tensor cores, f32 on FMA; the
    all-to-all's counts its launches at one rank and over a mesh
    apart. Every counter counts one kernel's launches where it is
    launched: a wire call launches the quantizer (``wire_quantize``) and
    its product, or the GEMM-RS wire's partials and fold; the MoE-TP
    wires' fold is the GEMM-RS wire's kernel, counted apart
    (``moe_reduce_rs_fold``), and so is the reduce-scatter's wire fold
    (``reduce_scatter_fold``). The int8-mxu GEMM-RS's fold counts its two
    modes apart (``gemm_rs_mxw_fold``, ``gemm_rs_mxr_fold``). The
    reduce-scatter's two wrappers, the int8-mxu GEMM-RS's partials, the
    cp LSE-combine, the prefill's ring attention and Ulysses all-to-all,
    the KV-page ship and the dp gradient ring also count their launches
    by the TPU kernel each stood for (``by_tpu_kernel``); the ring's
    all-gather half (``grad_allgather``) has no TPU kernel."""
    from triton_distributed_tpu_torch.kernels import ag_gemm as agg
    from triton_distributed_tpu_torch.kernels import all_to_all as a2a
    from triton_distributed_tpu_torch.kernels import allgather as ag
    from triton_distributed_tpu_torch.kernels import cp_ring as cp
    from triton_distributed_tpu_torch.kernels import flash_decode as fd
    from triton_distributed_tpu_torch.kernels import gemm_rs as grs
    from triton_distributed_tpu_torch.kernels import group_gemm as gg
    from triton_distributed_tpu_torch.kernels import kv_ship as ks
    from triton_distributed_tpu_torch.kernels import moe_dispatch as md
    from triton_distributed_tpu_torch.kernels import moe_tp_fused as mtf
    from triton_distributed_tpu_torch.kernels import ragged_paged_attention as rpa
    from triton_distributed_tpu_torch.kernels import reduce_scatter as rs
    from triton_distributed_tpu_torch.kernels import wire

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
        "wire_quantize": (wire.quantize_shards, "launches"),
        "ag_gemm_wire": (agg.ag_gemm_w_launch, "launches"),
        "ag_gemm_mx": (agg.ag_gemm_mx_launch, "launches"),
        "gemm_rs_wire": (grs.gemm_rs_partials, "launches"),
        "gemm_rs_fold": (grs.gemm_rs_fold, "launches"),
        "all_gather_wire": (ag.all_gather_w_launch, "launches"),
        "ag_group_gemm_wire": (mtf._ag_group_gemm_w_cuda, "launches"),
        "ag_group_gemm_mx": (mtf._ag_group_gemm_mx_cuda, "launches"),
        "moe_reduce_rs_wire": (mtf._moe_reduce_rs_partials_cuda, "launches"),
        "moe_reduce_rs_fold": (mtf._moe_reduce_rs_fold_cuda, "launches"),
        "reduce_scatter": (rs._reduce_scatter_cuda, "launches"),
        "reduce_scatter_fold": (rs._reduce_scatter_fold_cuda, "launches"),
        "all_to_all": (a2a._all_to_all_cuda, "launches"),
        "gemm_rs_mx": (grs.gemm_rs_mx_partials, "launches"),
        "gemm_rs_mxw_fold": (grs.gemm_rs_mx_fold, "launches_mxw"),
        "gemm_rs_mxr_fold": (grs.gemm_rs_mx_fold, "launches_mxr"),
        "all_gather_bidir": (ag._all_gather_bidir_cuda, "launches"),
        "all_gather_persist": (ag._ll_persist_cuda, "launches"),
        "cp_lse_combine": (cp._cp_lse_combine_cuda, "launches"),
        "ring_attention": (cp.ring_attention_launch, "launches"),
        "ulysses_a2a": (cp._ulysses_a2a_cuda, "launches"),
        "kv_ship": (ks._kv_ship_cuda, "launches"),
        "grad_ring": (cp._grad_ring_cuda, "launches"),
        "grad_allgather": (cp._grad_allgather_cuda, "launches"),
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
        if hasattr(fn, "by_variant"):
            fn.by_variant.clear()


def launches_by_tpu_kernel() -> dict:
    """The launches of the reduce-scatter (its raw kernel and its wire
    fold), of the int8-mxu GEMM-RS's partials, of the cp LSE-combine, of
    the prefill's ring attention and Ulysses all-to-all, of the
    KV-page ship and of the dp gradient ring since the last
    :func:`reset_launch_counts`, by the TPU kernel each stood for."""
    from triton_distributed_tpu_torch.kernels import cp_ring as cp
    from triton_distributed_tpu_torch.kernels import gemm_rs as grs
    from triton_distributed_tpu_torch.kernels import kv_ship as ks
    from triton_distributed_tpu_torch.kernels import reduce_scatter as rs

    return {**rs._reduce_scatter_cuda.by_tpu_kernel,
            **rs._reduce_scatter_fold_cuda.by_tpu_kernel,
            **grs.gemm_rs_mx_partials.by_tpu_kernel,
            **cp._cp_lse_combine_cuda.by_tpu_kernel,
            **cp.ring_attention_launch.by_tpu_kernel,
            **cp._ulysses_a2a_cuda.by_tpu_kernel,
            **ks._kv_ship_cuda.by_tpu_kernel,
            **cp._grad_ring_cuda.by_tpu_kernel}
