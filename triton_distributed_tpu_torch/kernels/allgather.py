"""All-gather over a mesh.

Port of ``all_gather`` (``triton_distributed_tpu/kernels/allgather.py:
588``) for ``RING_1D`` (``_ring_ag_kernel``, ``:42``) and ``LL_SMALL``
(``_ll_push_ag_kernel``, ``:199``): every rank ends with the
concatenation of all ranks' shards along dim 0. Both methods give the
same bytes, and on the card both run one pull kernel, ``tdt_all_gather``
(``csrc/allgather.cu``), which reads each peer's shard through the peer
table (:mod:`~triton_distributed_tpu_torch.lang.shmem`). ``RING_BIDIR``,
``LL_PERSIST`` and ``XLA_FALLBACK`` raise: they are ROADMAP Queue 2
item 11.

The quantized wire (``wire_dtype`` 'fp8' / 'int8', or 'auto': fp8 from
256 KiB a shard, :func:`~triton_distributed_tpu_torch.runtime.topology.
auto_allgather_wire`) is ``_ring_ag_kernel_w`` (``:87``): 2-D shards
travel as 1-byte codes with one f32 scale a row (``chunk_rows`` 1), and
each rank writes its peers' dequantized rows and its own shard exact
(``:93-96``). On the card the shards are quantized in one launch
(``tdt_quantize_slab``) and ``tdt_all_gather_w`` pulls the codes. An
explicit wire demotes ``RING_BIDIR`` / ``LL_SMALL`` / ``LL_PERSIST`` to
the ring, as JAX does (``:606-607``); 'int8-mxu' ships its int8 payload.
'auto' with no method follows the method JAX would pick, which at 4 or
more ranks carries no wire (:func:`resolve_all_gather_wire`).

The port is single-controller: ``x`` is a list of W per-rank shards of
one shape and dtype, and the result is a list of W gathered tensors, one
per rank (views of one allocation on the loopback mesh). On CPU tensors
:func:`all_gather` runs :func:`all_gather_plain`, ``torch.cat``.
"""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.kernels.group_gemm import _DT_CODE
from triton_distributed_tpu_torch.kernels.wire import WIRE_CODE, quantize_shards
from triton_distributed_tpu_torch.lang import wire as wirelib
from triton_distributed_tpu_torch.runtime.topology import (
    AllGatherMethod,
    auto_allgather_method,
    auto_allgather_wire,
    one_axis,
)

#: the methods the pull kernel stands for
PORTED_METHODS = (AllGatherMethod.RING_1D, AllGatherMethod.LL_SMALL)


def _check_shards(x, mesh, axis, what):
    n = one_axis(mesh, axis)
    if not isinstance(x, (list, tuple)) or len(x) != n:
        raise ValueError(f"{what} takes a list of {n} per-rank shards (the "
                         f"{axis!r} axis of the mesh)")
    s0 = x[0]
    for s in x:
        if s.shape != s0.shape or s.dtype != s0.dtype or s.device != s0.device:
            raise ValueError(f"{what}: the shards differ in shape, dtype or "
                             "device")
        if s.device != mesh.device:
            raise ValueError(f"{what}: shard on {s.device}, the mesh is on "
                             f"{mesh.device}")
    if s0.dim() < 1:
        raise ValueError(f"{what} gathers along dim 0; got a scalar shard")
    return n


def resolve_all_gather_wire(x, n, wire_dtype, method=None):
    """The wire :func:`all_gather` ships (JAX ``_resolve_ag_wire``):
    None for the raw wire or one rank; on the ring (``RING_1D``) and 2-D
    shards (m, cols) whose per-row scale saves bytes (``cols · itemsize
    > cols + 512``), the payload of an explicit wire, or for 'auto' fp8
    from 256 KiB a shard (:func:`auto_allgather_wire`). An explicit wire
    on any other shard raises ``ValueError``; 'auto' stays on the raw
    wire there. ``method`` None stands for the method JAX would pick
    (:func:`auto_allgather_method`): the LL push up to 64 KiB a shard
    and the bidirectional ring on 4 or more ranks carry no wire, so
    'auto' ships the raw bytes there, as in JAX."""
    w = wirelib.wire_payload(wirelib.normalize_wire(wire_dtype))
    if w is None or n == 1:
        return None
    s0 = x[0]
    if method is None:
        # JAX's pick; an explicit wire demotes it to the ring (all_gather)
        method = (auto_allgather_method(n, s0.numel() * s0.element_size())
                  if w == "auto" else AllGatherMethod.RING_1D)
    cols = s0.shape[-1] if s0.dim() == 2 else 0
    eligible = (method == AllGatherMethod.RING_1D and s0.dim() == 2
                and s0.dtype in (torch.float32, torch.bfloat16)
                and cols * s0.element_size()
                > cols + wirelib.SCALE_LANES * 4)
    if w == "auto":
        if not eligible:
            return None
        return auto_allgather_wire(s0.numel() * s0.element_size())
    if not eligible:
        raise ValueError(
            f"all_gather wire_dtype={w!r} needs 2-D f32 or bf16 shards with "
            f"cols·itemsize > cols + {wirelib.SCALE_LANES * 4} on the ring "
            f"(a pinned wire format is a contract); got {tuple(s0.shape)} "
            f"{s0.dtype} on {method}")
    return w


def all_gather_plain(x, mesh, axis: str = "tp", *, wire=None):
    """Plain PyTorch version: each rank's ``torch.cat`` of the shards;
    with ``wire`` (a resolved 'fp8' / 'int8') the peers' shards
    dequantized from per-row codes, each rank's own exact."""
    _check_shards(x, mesh, axis, "all_gather")
    if wire is None:
        return [torch.cat(list(x), dim=0) for _ in x]
    fmt = wirelib.WireFormat(quant=wire, chunk_rows=1)
    return all_gather_wired_plain(x, [wirelib.quantize_slab(s, fmt)
                                      for s in x], fmt)


def all_gather_wired_plain(x, wired, fmt):
    """The plain gather from the shards' wire form: ``wired`` holds every
    rank's (codes, per-row scales) of ``fmt``; rank r's result holds its
    own shard exact and its peers' dequantized."""
    peers = [wirelib.dequantize_slab(q, s, fmt, xr.dtype)
             for (q, s), xr in zip(wired, x)]
    return [torch.cat([x[q] if q == r else peers[q] for q in range(len(x))])
            for r in range(len(x))]


def all_gather(x, mesh, axis: str = "tp", *, method=None, wire_dtype=None):
    """AllGather the per-rank shards ``x`` (a list of W tensors of one
    shape, (m, ...)) along ``axis`` → a list of W (W·m, ...) tensors,
    rank r's the concatenation of every rank's shard.

    ``method`` None, ``RING_1D`` and ``LL_SMALL`` all run the one kernel:
    the JAX package picks between the two by size, and here they give
    the same bytes. The other methods raise, but that an explicit
    'fp8' / 'int8' wire demotes ``RING_BIDIR`` and ``LL_PERSIST`` to the
    ring. ``wire_dtype``: see :func:`resolve_all_gather_wire`. On CPU
    tensors this is :func:`all_gather_plain`; on CUDA tensors it
    launches the kernel or raises."""
    n = _check_shards(x, mesh, axis, "all_gather")
    if wirelib.wire_payload(wirelib.normalize_wire(wire_dtype)) in (
            "fp8", "int8") and method in (AllGatherMethod.RING_BIDIR,
                                          AllGatherMethod.LL_SMALL,
                                          AllGatherMethod.LL_PERSIST):
        # an explicit compressed wire outranks the method: only the ring
        # carries it
        method = AllGatherMethod.RING_1D
    if method is not None and method not in PORTED_METHODS:
        raise NotImplementedError(
            f"all_gather method {method.name}: only RING_1D and LL_SMALL "
            "are ported (ROADMAP Queue 2 item 11)")
    wire = resolve_all_gather_wire(x, n, wire_dtype, method)
    if x[0].device.type == "cpu":
        return all_gather_plain(x, mesh, axis, wire=wire)
    if wire is not None:
        return _all_gather_w_cuda(x, mesh, wire)
    return _all_gather_cuda(x, mesh, n)


def _all_gather_cuda(x, mesh, n):
    from triton_distributed_tpu_torch.kernels import _build
    from triton_distributed_tpu_torch.lang.shmem import peer_table, symm_empty

    if any(not s.is_contiguous() for s in x):
        raise ValueError("all_gather's kernel needs contiguous shards")
    nbytes = x[0].numel() * x[0].element_size()
    out = symm_empty(mesh, (n * x[0].shape[0], *x[0].shape[1:]), x[0].dtype)
    # referenced until the launch is enqueued (see ag_gemm.launch_mesh_gemm)
    in_peers = peer_table(x)
    fn = _build.function("tdt_all_gather", "pp" + "Lii" + "p")
    rc = fn(_build.ptr(in_peers), _build.ptr(out.peers), nbytes, n, 0, n,
            _build.stream(mesh.device))
    _build.check(rc, "tdt_all_gather")
    _all_gather_cuda.launches += 1
    return out.shards


def _all_gather_w_cuda(x, mesh, wire):
    """The fp8 / int8 wire: every shard quantized per row
    (:func:`~triton_distributed_tpu_torch.kernels.wire.quantize_shards`),
    then :func:`all_gather_w_launch`."""
    if any(not s.is_contiguous() for s in x):
        raise ValueError("all_gather's kernel needs contiguous shards")
    fmt = wirelib.WireFormat(quant=wire, chunk_rows=1)
    q, s = quantize_shards(x, fmt)
    return all_gather_w_launch(x, q, s, mesh, fmt)


def all_gather_w_launch(x, q, s, mesh, fmt):
    """``tdt_all_gather_w`` for every rank in one launch: the shards
    ``x`` with their wire form q (W, m, cols) codes and s (W, m) per-row
    scales → the W gathered (W·m, cols) tensors."""
    from triton_distributed_tpu_torch.kernels import _build
    from triton_distributed_tpu_torch.lang.shmem import peer_table, symm_empty

    n, (m, cols) = len(x), x[0].shape
    out = symm_empty(mesh, (n * m, cols), x[0].dtype)
    in_peers = peer_table(x)   # referenced until the launch is enqueued
    fn = _build.function("tdt_all_gather_w", "pppp" + "i" * 8 + "p")
    rc = fn(_build.ptr(in_peers), _build.ptr(q), _build.ptr(s),
            _build.ptr(out.peers), m, cols, n, 0, n, _DT_CODE[x[0].dtype],
            WIRE_CODE[fmt.quant],
            int(all(t.data_ptr() % 16 == 0 for t in x)),
            _build.stream(mesh.device))
    _build.check(rc, "tdt_all_gather_w")
    all_gather_w_launch.launches += 1
    return out.shards


#: launch counts of the kernels (plain ints on the wrappers): the raw
#: gather and its quantized wire (the wire quantizer counts its own)
_all_gather_cuda.launches = 0
all_gather_w_launch.launches = 0
