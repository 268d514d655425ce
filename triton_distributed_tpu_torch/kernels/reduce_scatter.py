"""Reduce-scatter over a mesh.

Port of ``reduce_scatter`` (``triton_distributed_tpu/kernels/
reduce_scatter.py:421``): every rank contributes an (M, ...) tensor and
rank r ends with the r-th row block (M/W rows) of their sum.

JAX picks one of six TPU kernels, and the port keeps its choice
(:func:`select_engine`), because the choice fixes the numerics:

* the raw wire: the VMEM-resident ring ``_ring_rs_kernel`` (``:87``)
  while ``(W + 3)`` row blocks fit half of the fused-engine budget
  (:func:`_vmem_ring_fits`, 96 MiB by default: :func:`~triton_distributed
  _tpu_torch.config.fused_vmem_budget`), else the HBM-streaming ring
  ``_rs_stream_kernel`` (``:153``), or ``_rs_stream_kernel3`` (``:181``)
  under ``schedule=RingSchedule(depth=3)``. All three add the ring's hops
  in one order and round each hop's partial to the dtype: destination d
  starts from rank d − 1's row block, adds rank d − 2's, …, and its own
  last (:func:`~triton_distributed_tpu_torch.kernels.gemm_rs.ring_order`).
  In bf16 that differs from one f32 sum by several ulps, so the port
  replays the hops. On the card the three share one kernel,
  ``tdt_reduce_scatter`` (``csrc/reduce_scatter.cu``): a pull through
  the peer table, one launch for every rank; the depth adds a ring slot
  on the TPU and changes no value;
* a quantized wire (``wire_dtype`` 'fp8' / 'int8', 'int8-mxu' shipping
  its int8 payload, 'auto': fp8 from 256 KiB a row block): each hop's
  running partial is quantized, dequantized in f32, added to the next
  contribution in f32 and rounded to the dtype. The VMEM ring
  ``_ring_rs_kernel_w`` (``:103``) keeps one scale a row; the streaming
  rings ``_rs_stream_kernel_w`` / ``_w3`` (``:208``, ``:246``) one a
  chunk of ``make_wire_format(wire, M/W)`` rows. On the card the three
  run the GEMM-RS wire's fold, ``tdt_gemm_rs_fold`` (``csrc/
  gemm_rs.cu``) at their chunk; a payload neither can carry ships the
  raw wire, with one warning, as in JAX (``:531``).

On the card the budget decides which rows share a wire scale and which
TPU kernel a launch stands for, not memory. The launches are counted by
the TPU kernel each call stands for (``by_tpu_kernel``). The plain
versions are :func:`reduce_scatter_plain` (the hop loop in torch ops)
and, for the wires, ``gemm_rs.gemm_rs_fold_plain``; on CPU tensors the
entry runs them, on CUDA tensors it launches the kernels or raises.
"""

from __future__ import annotations

import math

import torch

from triton_distributed_tpu_torch import config
from triton_distributed_tpu_torch.kernels.gemm_rs import (
    _count,
    gemm_rs_fold_plain,
    launch_fold,
    ring_order,
)
from triton_distributed_tpu_torch.kernels.group_gemm import _DT_CODE
from triton_distributed_tpu_torch.lang import wire as wirelib
from triton_distributed_tpu_torch.lang.shmem import SymmTensor
from triton_distributed_tpu_torch.runtime.topology import (
    auto_allgather_wire,
    one_axis,
)
from triton_distributed_tpu_torch.tune.schedule import require_depth_only

#: the TPU kernels, by (wire, streaming, depth)
_RAW = {(False, 2): "_ring_rs_kernel", (False, 3): "_ring_rs_kernel",
        (True, 2): "_rs_stream_kernel", (True, 3): "_rs_stream_kernel3"}
_WIRED = {(False, 2): "_ring_rs_kernel_w", (False, 3): "_ring_rs_kernel_w",
          (True, 2): "_rs_stream_kernel_w", (True, 3): "_rs_stream_kernel_w3"}


def _vmem_ring_fits(n, local_shape, itemsize) -> bool:
    """JAX's gate (``:369``): the VMEM ring keeps the whole contribution,
    the accumulator and two receive slots resident, ``(n + 3)`` row
    blocks, within half the fused-engine budget."""
    slab = math.prod(local_shape) * itemsize
    return (n + 3) * slab <= config.fused_vmem_budget() // 2


def _streamable(m_local: int, cols: int, itemsize: int,
                strict: bool = False) -> bool:
    """JAX's gate (``:378``): the streaming ring's add needs a divisor
    blocking of the (m_local, cols) row block. JAX enforces the TPU's
    blocking (``strict``) only when it compiles for a TPU; the port
    decides as JAX does off the TPU, where any block is legal."""
    return (wirelib._divisor_block(m_local, 512, 8 * max(1, 4 // itemsize),
                                   strict) is not None
            and wirelib._divisor_block(cols, 2048, 128, strict) is not None)


def resolve_rs_wire(wire_dtype, rows, cols, n, itemsize):
    """The wire the reduce-scatter ships (JAX ``_resolve_rs_wire``,
    ``:392``): None for the raw wire; 'int8-mxu' ships int8; 'auto' fp8
    from 256 KiB a row block (:func:`~triton_distributed_tpu_torch.
    runtime.topology.auto_allgather_wire`) where the payload is eligible,
    else raw. Eligible: rows split over the ranks and ``cols · itemsize
    > cols + 512`` (the per-row scale saves bytes); an explicit wire on
    any other payload raises ``ValueError``."""
    w = wirelib.wire_payload(wirelib.normalize_wire(wire_dtype))
    if w is None:
        return None
    eligible = (rows % n == 0
                and cols * itemsize > cols + wirelib.SCALE_LANES * 4)
    if w == "auto":
        return auto_allgather_wire((rows // n) * cols * itemsize) \
            if eligible else None
    if not eligible:
        raise ValueError(
            f"reduce_scatter wire_dtype={w!r} needs a 2-D-reshapeable "
            f"payload with cols·itemsize > cols + "
            f"{wirelib.SCALE_LANES * 4} (a pinned wire format is a "
            f"contract); got rows={rows} cols={cols} itemsize={itemsize}")
    return w


def select_engine(n, full_shape, itemsize, wire, depth=2):
    """(the TPU kernel JAX runs, its WireFormat or None) for one rank's
    (M, ...) contribution of ``full_shape`` on ``n`` ranks with the
    resolved ``wire`` (JAX ``reduce_scatter``, ``:489-541``). A wire that
    neither ring can carry demotes to the raw wire with one warning."""
    rows = full_shape[0]
    cols = math.prod(full_shape[1:])
    m_local = rows // n
    fits = _vmem_ring_fits(n, (m_local, *full_shape[1:]), itemsize)
    stream = _streamable(m_local, cols, itemsize)
    if wire is not None:
        if fits:
            return _WIRED[(False, depth)], wirelib.WireFormat(
                quant=wire, chunk_rows=1)
        if stream and wirelib.wire_blockable(m_local, cols, wire):
            return (_WIRED[(True, depth)],
                    wirelib.make_wire_format(wire, m_local))
        config.warn_once(
            ("reduce_scatter", "bf16 wire"),
            "reduce_scatter: payload exceeds the VMEM ring and admits no "
            "streaming wire blocking; shipping the bf16 wire")
    return _RAW[(not fits and stream, depth)], None


def _contributions(x, n, stacked, what="reduce_scatter"):
    """The W ranks' contributions: ``stacked`` a list of W tensors (or a
    :class:`SymmTensor`), else one tensor every rank contributes."""
    if not stacked:
        if not isinstance(x, torch.Tensor):
            raise ValueError(f"{what}(stacked=False) takes one tensor, "
                             "every rank's contribution")
        parts = [x] * n
    else:
        parts = list(x.shards if isinstance(x, SymmTensor) else x)
        if len(parts) != n:
            raise ValueError(f"{what}(stacked=True) takes {n} per-rank "
                             f"tensors, got {len(parts)}")
    p0 = parts[0]
    if p0.dim() < 1:
        raise ValueError(f"{what} scatters along dim 0; got a scalar")
    for p in parts:
        if p.shape != p0.shape or p.dtype != p0.dtype or \
                p.device != p0.device:
            raise ValueError(f"{what}: the contributions differ in shape, "
                             "dtype or device")
    return parts


def reduce_scatter_plain(x, mesh, axis: str = "tp", *, stacked=False,
                         fmt=None):
    """Plain PyTorch version: destination d's row block of the ranks'
    contributions added in the ring's order (rank d − 1's first, its own
    last), rounded to the dtype at each hop; with ``fmt`` (a
    :class:`~triton_distributed_tpu_torch.lang.wire.WireFormat`) the
    quantized wire's fold (``gemm_rs.gemm_rs_fold_plain``). Returns the W
    row blocks."""
    n = one_axis(mesh, axis)
    parts = _contributions(x, n, stacked)
    shape = parts[0].shape
    if n == 1:
        return [parts[0]]
    local = (shape[0] // n, *shape[1:])
    if fmt is not None:
        flat = [p.reshape(shape[0], -1) for p in parts]
        return [o.reshape(local) for o in
                gemm_rs_fold_plain(flat, fmt, parts[0].dtype)]
    blocks = [p.chunk(n, dim=0) for p in parts]
    out = []
    for d in range(n):
        hops = ring_order([b[d] for b in blocks], d)
        acc = hops[0]
        for nxt in hops[1:]:
            acc = acc + nxt
        out.append(acc)
    return out


def reduce_scatter(x, mesh, axis: str = "tp", *, stacked: bool = False,
                   collective_id: int = 3, wire_dtype=None, schedule=None):
    """ReduceScatter: sum the ranks' (M, ...) contributions and give rank
    r row block r (M/W rows) → a list of W tensors.

    ``stacked=True``: ``x`` is a list of W per-rank tensors of one shape
    (rank q contributes ``x[q]``; the normal case, e.g. partial GEMM
    outputs) or a :class:`~triton_distributed_tpu_torch.lang.shmem.
    SymmTensor`; ``stacked=False``: ``x`` is one tensor every rank
    contributes. At one rank the contribution passes through.
    ``wire_dtype``: see :func:`resolve_rs_wire`; ``schedule``: None or a
    :class:`~triton_distributed_tpu_torch.tune.schedule.RingSchedule`
    whose only non-default field is ``depth`` (2 or 3). ``collective_id``
    is JAX's barrier-semaphore id, kept for its signature: the pull
    kernels wait on nothing. On CPU tensors this runs the plain versions;
    on CUDA tensors it launches the kernels (bf16 or f32) or raises."""
    del collective_id
    depth = require_depth_only(schedule, "reduce_scatter")
    n = one_axis(mesh, axis)
    parts = _contributions(x, n, stacked)
    if n == 1:
        return [parts[0]]
    shape, itemsize = parts[0].shape, parts[0].element_size()
    rows, cols = shape[0], math.prod(shape[1:])
    if rows % n:
        raise ValueError(f"reduce_scatter: dim 0 ({rows}) does not split "
                         f"over {n} ranks")
    wire = resolve_rs_wire(wire_dtype, rows, cols, n, itemsize)
    kernel, fmt = select_engine(n, shape, itemsize, wire, depth)
    if parts[0].device.type == "cpu":
        return reduce_scatter_plain(parts, mesh, axis, stacked=True,
                                    fmt=fmt)
    if parts[0].device != mesh.device:
        raise ValueError(f"reduce_scatter: contributions on "
                         f"{parts[0].device}, the mesh is on {mesh.device}")
    if parts[0].dtype not in _DT_CODE:
        raise ValueError(f"reduce_scatter's kernels take f32 or bf16, got "
                         f"{parts[0].dtype}")
    if any(not p.is_contiguous() for p in parts):
        raise ValueError("reduce_scatter's kernels need contiguous "
                         "contributions")
    local = (rows // n, *shape[1:])
    if fmt is not None:
        flat = [p.view(rows, cols) for p in parts]
        out = _reduce_scatter_fold_cuda(flat, mesh, fmt, kernel)
        return [o.view(local) for o in out]
    return _reduce_scatter_cuda(parts, mesh, local, kernel)


def _reduce_scatter_cuda(parts, mesh, local, tpu_kernel):
    """``tdt_reduce_scatter``: one launch for every destination rank."""
    from triton_distributed_tpu_torch.kernels import _build
    from triton_distributed_tpu_torch.lang.shmem import peer_table, symm_empty

    n = len(parts)
    dtype = parts[0].dtype
    n_local = math.prod(local)
    out = symm_empty(mesh, local, dtype)
    in_peers = peer_table(parts)   # referenced until the launch is enqueued
    aligned = (n_local * parts[0].element_size() % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (*parts, *out.shards)))
    fn = _build.function("tdt_reduce_scatter", "ppL" + "i" * 5 + "p")
    rc = fn(_build.ptr(in_peers), _build.ptr(out.peers), n_local, n, 0, n,
            _DT_CODE[dtype], int(aligned), _build.stream(mesh.device))
    _build.check(rc, "tdt_reduce_scatter")
    _count(_reduce_scatter_cuda, tpu_kernel)
    return out.shards


def _reduce_scatter_fold_cuda(parts, mesh, fmt, tpu_kernel):
    """A quantized wire: the GEMM-RS wire's fold, ``tdt_gemm_rs_fold``,
    over the ranks' (M, cols) contributions at ``fmt``'s chunk."""
    out = launch_fold(parts, mesh, fmt, parts[0].dtype)
    _count(_reduce_scatter_fold_cuda, tpu_kernel)
    return out


#: launch counts (plain ints on the wrappers), and by the TPU kernel
#: each launch stands for
_reduce_scatter_cuda.launches = 0
_reduce_scatter_cuda.by_tpu_kernel = {}
_reduce_scatter_fold_cuda.launches = 0
_reduce_scatter_fold_cuda.by_tpu_kernel = {}
