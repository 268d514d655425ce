"""The wire quantizer on the card: ``tdt_quantize_slab`` (``csrc/wire.cu``).

JAX quantizes a shard for the wire on the XLA side, with
``lang/wire.py``'s ``quantize_slab`` (``:171``), before its fused
kernels read the codes (``ag_gemm.py:266,309``, ``allgather.py:87``).
The port quantizes every rank's shard in one launch, with the device
functions of ``csrc/wire.cuh`` that the GEMM-RS fold also requantizes
with, so that the card's codes and scales equal
:func:`~triton_distributed_tpu_torch.lang.wire.quantize_slab`'s byte for
byte. The wire wrappers of ``ag_gemm`` and ``allgather`` call
:func:`quantize_shards` on CUDA tensors (on the CPU their plain versions
call ``quantize_slab``); the MoE-TP wires call it on the shards' sorted
slabs on both devices, and on CPU tensors it runs
:func:`quantize_shards_plain`.
"""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.kernels.group_gemm import _DT_CODE
from triton_distributed_tpu_torch.lang import wire as wirelib

#: the C ABI's wire codes (csrc/wire.cuh TdtWire)
WIRE_CODE = {"fp8": 1, "int8": 2}


def quantize_shards_plain(x, fmt):
    """Plain PyTorch version of :func:`quantize_shards`: each shard's
    :func:`~triton_distributed_tpu_torch.lang.wire.quantize_slab`,
    stacked."""
    pairs = [wirelib.quantize_slab(s, fmt) for s in x]
    return (torch.stack([q for q, _ in pairs]),
            torch.stack([s for _, s in pairs]))


def quantize_shards(x, fmt):
    """Every rank's (rows, cols) shard quantized in one launch of
    ``tdt_quantize_slab`` → ((W, rows, cols) codes of
    ``fmt.wire_dtype``, (W, rows / chunk_rows) f32 scales): per shard
    :func:`~triton_distributed_tpu_torch.lang.wire.quantize_slab`, byte
    for byte. On CPU tensors :func:`quantize_shards_plain`."""
    if x[0].device.type == "cpu":
        return quantize_shards_plain(x, fmt)
    from triton_distributed_tpu_torch.kernels import _build
    from triton_distributed_tpu_torch.lang.shmem import peer_table

    rows, cols = x[0].shape
    if x[0].dtype not in _DT_CODE or any(not s.is_contiguous() for s in x):
        raise ValueError("the wire quantizer takes contiguous f32 or bf16 "
                         f"shards, got {x[0].dtype}")
    dev = x[0].device
    q = torch.empty((len(x), rows, cols), dtype=fmt.wire_dtype, device=dev)
    s = torch.empty((len(x), fmt.chunks(rows)), dtype=torch.float32,
                    device=dev)
    peers = peer_table(x)   # referenced until the launch is enqueued
    fn = _build.function("tdt_quantize_slab", "ppp" + "i" * 7 + "p")
    rc = fn(_build.ptr(peers), _build.ptr(q), _build.ptr(s), rows, cols,
            len(x), fmt.chunk_rows, _DT_CODE[x[0].dtype],
            WIRE_CODE[fmt.quant],
            int(all(t.data_ptr() % 16 == 0 for t in x)), _build.stream(dev))
    _build.check(rc, "tdt_quantize_slab")
    quantize_shards.launches += 1
    return q, s


#: launch count of the kernel (a plain int on the wrapper)
quantize_shards.launches = 0
