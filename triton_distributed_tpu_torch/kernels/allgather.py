"""All-gather over a mesh.

Port of ``all_gather`` (``triton_distributed_tpu/kernels/allgather.py:
588``): every rank ends with the concatenation of all ranks' shards along
dim 0. The methods all give the same bytes; each runs its own kernel:

* ``RING_1D`` (``_ring_ag_kernel``, ``:42``) and ``LL_SMALL``
  (``_ll_push_ag_kernel``, ``:199``): one pull kernel, ``tdt_all_gather``
  (``csrc/allgather.cu``), which reads each peer's shard through the peer
  table (:mod:`~triton_distributed_tpu_torch.lang.shmem`);
* ``RING_BIDIR`` (``_ring_bidir_ag_kernel``, ``:150``): the clockwise
  ring carries columns [0, kh) of every shard and the counter-clockwise
  ring the rest, kh the schedule's ``split8`` eighths lane-aligned as
  JAX computes it (:func:`bidir_split`); on the card
  ``tdt_all_gather_bidir`` pulls the two column ranges in the two
  rings' source orders;
* ``LL_PERSIST`` (``_ll_persist_kernel``, ``:231``):
  :class:`PersistentLLAllGather`, a barrier-free push into a persistent
  workspace of two parity windows, each call's rows in window
  ``call_idx % 2`` of every rank's workspace, drained into the output;
  on the card ``tdt_all_gather_persist`` writes the window and the output
  from the shard in one pass. ``all_gather(method=LL_PERSIST)`` runs a
  context from a small LRU (:func:`_persist_state`).

``method`` None takes the method JAX picks (:func:`~triton_distributed_
tpu_torch.runtime.topology.auto_allgather_method`: ``LL_SMALL`` up to
64 KiB a shard, ``RING_BIDIR`` at 4 or more ranks, else ``RING_1D``);
JAX first looks up a tuned winner, which comes with the tuning layer
(ROADMAP Queue 1 step 10). JAX's demotions are kept: ``RING_BIDIR`` on a
rank-1 or single-column shard runs ``RING_1D``, an explicit fp8 / int8
wire runs ``RING_1D``, and ``LL_PERSIST`` on a shard that is not 2-D
runs ``LL_SMALL``. ``XLA_FALLBACK`` raises.

The quantized wire (``wire_dtype`` 'fp8' / 'int8', or 'auto': fp8 from
256 KiB a shard, :func:`~triton_distributed_tpu_torch.runtime.topology.
auto_allgather_wire`) is ``_ring_ag_kernel_w`` (``:87``): 2-D shards
travel as 1-byte codes with one f32 scale a row (``chunk_rows`` 1), and
each rank writes its peers' dequantized rows and its own shard exact
(``:93-96``). On the card the shards are quantized in one launch
(``tdt_quantize_slab``) and ``tdt_all_gather_w`` pulls the codes.
'int8-mxu' ships its int8 payload. Only the ring carries a wire, so
'auto' under the LL push or the bidirectional ring ships the raw bytes
(:func:`resolve_all_gather_wire`).

The port is single-controller: ``x`` is a list of W per-rank shards of
one shape and dtype, and the result is a list of W gathered tensors, one
per rank (views of one allocation on the loopback mesh). On CPU tensors
:func:`all_gather` runs the plain versions (``torch.cat``).
"""

from __future__ import annotations

import math
from collections import OrderedDict

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
from triton_distributed_tpu_torch.tune.schedule import require_split_only

#: the methods the port runs, each on its kernel
PORTED_METHODS = (AllGatherMethod.RING_1D, AllGatherMethod.LL_SMALL,
                  AllGatherMethod.RING_BIDIR, AllGatherMethod.LL_PERSIST)


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


def bidir_split(k: int, split8=None) -> int:
    """kh, the columns the bidirectional ring's clockwise direction
    carries (JAX ``:160-167``): ``k // 2`` without a schedule; with one,
    ``k · split8 // 8``, lane-aligned to a multiple of 128 in [128, k −
    128] from 256 columns up."""
    if split8 is None:
        return k // 2
    kh = (k * int(split8)) // 8
    if k >= 256:
        kh = max(128, min(k - 128, (kh // 128) * 128))
    return kh


def resolve_all_gather_method(x, n, method=None, wire_dtype=None):
    """The method :func:`all_gather` runs (JAX ``:630-664``): ``method``,
    or with None the one JAX picks (:func:`auto_allgather_method`); then
    JAX's demotions: ``RING_BIDIR`` on a rank-1 or single-column shard
    and any LL or bidirectional method under an explicit fp8 / int8 wire
    run ``RING_1D``; ``LL_PERSIST`` on a shard that is not 2-D runs
    ``LL_SMALL`` (JAX also demotes it inside a trace; the port has no
    trace)."""
    s0 = x[0]
    if method is None:
        method = auto_allgather_method(n, s0.numel() * s0.element_size())
    method = AllGatherMethod(method)
    if method == AllGatherMethod.RING_BIDIR and (s0.dim() < 2
                                                 or s0.shape[1] < 2):
        method = AllGatherMethod.RING_1D
    if wirelib.wire_payload(wirelib.normalize_wire(wire_dtype)) in (
            "fp8", "int8") and method in (AllGatherMethod.RING_BIDIR,
                                          AllGatherMethod.LL_SMALL,
                                          AllGatherMethod.LL_PERSIST):
        # an explicit compressed wire outranks the method: only the ring
        # carries it
        method = AllGatherMethod.RING_1D
    if method == AllGatherMethod.LL_PERSIST and s0.dim() != 2:
        method = AllGatherMethod.LL_SMALL
    return method


def all_gather(x, mesh, axis: str = "tp", *, method=None, wire_dtype=None,
               schedule=None):
    """AllGather the per-rank shards ``x`` (a list of W tensors of one
    shape, (m, ...)) along ``axis`` → a list of W (W·m, ...) tensors,
    rank r's the concatenation of every rank's shard.

    ``method``: an ``AllGatherMethod`` or None (JAX's pick), resolved by
    :func:`resolve_all_gather_method`; ``XLA_FALLBACK`` raises.
    ``wire_dtype``: see :func:`resolve_all_gather_wire`. ``schedule``:
    None or a ``RingSchedule`` whose only non-default field is
    ``split8`` (the bidirectional ring's column split, which changes no
    byte of the result; the other methods do not read it). On CPU
    tensors this is the plain version; on CUDA tensors it launches the
    method's kernel or raises."""
    n = _check_shards(x, mesh, axis, "all_gather")
    split8 = require_split_only(schedule, "all_gather")
    method = resolve_all_gather_method(x, n, method, wire_dtype)
    if method not in PORTED_METHODS:
        raise NotImplementedError(
            f"all_gather method {method.name}: XLA's all_gather has no "
            "kernel of the port; RING_1D, RING_BIDIR, LL_SMALL and "
            "LL_PERSIST give its bytes")
    if method == AllGatherMethod.LL_PERSIST:
        return _persist_state(mesh, axis, tuple(x[0].shape), x[0].dtype)(x)
    wire = resolve_all_gather_wire(x, n, wire_dtype, method)
    cpu = x[0].device.type == "cpu"
    if wire is not None:
        return (all_gather_plain(x, mesh, axis, wire=wire) if cpu
                else _all_gather_w_cuda(x, mesh, wire))
    if method == AllGatherMethod.RING_BIDIR:
        kh = bidir_split(x[0].shape[1], split8)
        return (all_gather_bidir_plain(x, kh) if cpu
                else _all_gather_bidir_cuda(x, mesh, kh))
    if cpu:
        return all_gather_plain(x, mesh, axis)
    return _all_gather_cuda(x, mesh, n)


def all_gather_bidir_plain(x, kh: int):
    """Plain version of the bidirectional ring: every rank's result
    assembled from the clockwise direction's columns [0, kh) and the
    counter-clockwise one's [kh, k) of every shard, in their source
    orders (rank r receives shard r − s clockwise and r + s
    counter-clockwise at step s) → the W (W·m, k, ...) results, each
    ``torch.cat`` of the shards."""
    n, m = len(x), x[0].shape[0]
    out = []
    for r in range(n):
        o = torch.empty((n * m, *x[0].shape[1:]), dtype=x[0].dtype,
                        device=x[0].device)
        for step in range(n):
            cw, ccw = (r - step) % n, (r + step) % n
            o[cw * m:(cw + 1) * m, :kh] = x[cw][:, :kh]
            o[ccw * m:(ccw + 1) * m, kh:] = x[ccw][:, kh:]
        out.append(o)
    return out


def _check_kernel_shards(x):
    if any(not s.is_contiguous() for s in x):
        raise ValueError("all_gather's kernel needs contiguous shards")


def _all_gather_cuda(x, mesh, n):
    from triton_distributed_tpu_torch.kernels import _build
    from triton_distributed_tpu_torch.lang.shmem import peer_table, symm_empty

    _check_kernel_shards(x)
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
    _check_kernel_shards(x)
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


def _all_gather_bidir_cuda(x, mesh, kh):
    """``tdt_all_gather_bidir``: one launch for every rank, columns [0,
    kh) of each shard pulled in the clockwise ring's source order and
    [kh, k) in the counter-clockwise one's; the bytes of
    :func:`all_gather_bidir_plain`."""
    from triton_distributed_tpu_torch.kernels import _build
    from triton_distributed_tpu_torch.lang.shmem import peer_table, symm_empty

    _check_kernel_shards(x)
    n, m = len(x), x[0].shape[0]
    inner = math.prod(x[0].shape[2:]) * x[0].element_size()  # a column
    out = symm_empty(mesh, (n * m, *x[0].shape[1:]), x[0].dtype)
    in_peers = peer_table(x)   # referenced until the launch is enqueued
    fn = _build.function("tdt_all_gather_bidir", "pp" + "iLLiii" + "p")
    rc = fn(_build.ptr(in_peers), _build.ptr(out.peers), m,
            x[0].shape[1] * inner, kh * inner, n, 0, n,
            _build.stream(mesh.device))
    _build.check(rc, "tdt_all_gather_bidir")
    _all_gather_bidir_cuda.launches += 1
    return out.shards


class PersistentLLAllGather:
    """The barrier-free LL all-gather over a persistent workspace (JAX
    ``kernels/allgather.py:473-516``): the context owns every rank's
    workspace of two parity windows, (2·W·m, k) a rank, symmetric over
    the mesh and zeroed, and the call counter. Call c pushes every
    rank's (m, k) shard into window ``c % 2`` of every rank's workspace
    (rank q's rows at q·m) and drains that window into the output, so
    after it window c % 2 holds call c's rows and the other window call
    c − 1's. ``instance`` is JAX's per-instance identity (two live
    contexts of one configuration never share state).

    On the card one launch of ``tdt_all_gather_persist`` covers every
    rank, writing the window and the output from the shard in one pass:
    on the loopback mesh every shard is complete before the launch, so
    no rank waits for a flag. On CPU tensors the plain version copies
    the same bytes."""

    _next_instance = [0]

    def __init__(self, mesh, axis, shard_shape, dtype=torch.bfloat16,
                 collective_id: int = 12):
        from triton_distributed_tpu_torch.config import to_torch_dtype
        from triton_distributed_tpu_torch.lang.shmem import symm_empty

        m, k = shard_shape
        self.mesh, self.axis = mesh, axis
        self.n = one_axis(mesh, axis)
        self.m, self.k = m, k
        self.dtype = to_torch_dtype(dtype)
        self.collective_id = collective_id
        self.call_idx = 0
        self.instance = PersistentLLAllGather._next_instance[0]
        PersistentLLAllGather._next_instance[0] += 1
        self.ws = symm_empty(mesh, (2 * self.n * m, k), self.dtype)
        for w in self.ws.shards:
            w.zero_()

    @property
    def workspace(self) -> list:
        """Every rank's (2·W·m, k) workspace."""
        return self.ws.shards

    def __call__(self, x):
        """x: a list of W (m, k) shards → a list of W (W·m, k) gathered
        tensors."""
        _check_shards(x, self.mesh, self.axis, "PersistentLLAllGather")
        if tuple(x[0].shape) != (self.m, self.k) or x[0].dtype != self.dtype:
            raise ValueError(
                f"PersistentLLAllGather of ({self.m}, {self.k}) "
                f"{self.dtype} shards got {tuple(x[0].shape)} {x[0].dtype}")
        parity = self.call_idx % 2
        if x[0].device.type == "cpu":
            out = ll_persist_plain(x, self.ws.shards, parity)
        else:
            out = _ll_persist_cuda(x, self.ws, self.mesh, parity)
        self.call_idx += 1
        return out


def ll_persist_plain(x, ws, parity: int):
    """Plain version of one :class:`PersistentLLAllGather` call: every
    shard copied into window ``parity`` of every workspace in ``ws`` (in
    place), then each window drained into a fresh output."""
    n, m = len(x), x[0].shape[0]
    base = parity * n * m
    for w in ws:
        for q, xq in enumerate(x):
            w[base + q * m:base + (q + 1) * m].copy_(xq)
    return [w[base:base + n * m].clone() for w in ws]


def _ll_persist_cuda(x, ws, mesh, parity):
    """``tdt_all_gather_persist``: one launch for every rank, shard q
    written to rank r's window and output in one pass."""
    from triton_distributed_tpu_torch.kernels import _build
    from triton_distributed_tpu_torch.lang.shmem import peer_table, symm_empty

    _check_kernel_shards(x)
    n, m = len(x), x[0].shape[0]
    nbytes = x[0].numel() * x[0].element_size()
    out = symm_empty(mesh, (n * m, *x[0].shape[1:]), x[0].dtype)
    in_peers = peer_table(x)   # referenced until the launch is enqueued
    fn = _build.function("tdt_all_gather_persist", "ppp" + "Liiii" + "p")
    rc = fn(_build.ptr(in_peers), _build.ptr(ws.peers),
            _build.ptr(out.peers), nbytes, parity * n, n, 0, n,
            _build.stream(mesh.device))
    _build.check(rc, "tdt_all_gather_persist")
    _ll_persist_cuda.launches += 1
    return out.shards


_PERSIST_STATES: OrderedDict = OrderedDict()
_PERSIST_STATES_MAX = 8   # each holds a workspace twice the gathered size


def _persist_state(mesh, axis, shard_shape, dtype, collective_id=2):
    """The :class:`PersistentLLAllGather` of a configuration behind
    ``all_gather(method=LL_PERSIST)`` (JAX ``:692-715``): an LRU of 8;
    evicting one frees its workspace, and a fresh context starts again
    at call 0."""
    key = (mesh, axis, tuple(shard_shape), dtype, collective_id)
    st = _PERSIST_STATES.get(key)
    if st is None:
        st = _PERSIST_STATES[key] = PersistentLLAllGather(
            mesh, axis, shard_shape, dtype, collective_id)
        while len(_PERSIST_STATES) > _PERSIST_STATES_MAX:
            _PERSIST_STATES.popitem(last=False)
    else:
        _PERSIST_STATES.move_to_end(key)
    return st


#: launch counts of the kernels (plain ints on the wrappers): the raw
#: gather, its quantized wire (the wire quantizer counts its own), the
#: bidirectional ring and the persistent LL gather
_all_gather_cuda.launches = 0
all_gather_w_launch.launches = 0
_all_gather_bidir_cuda.launches = 0
_ll_persist_cuda.launches = 0
