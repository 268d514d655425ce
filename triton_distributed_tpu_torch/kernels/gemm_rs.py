"""GEMM + reduce-scatter for row-parallel tensor parallelism.

Port of ``gemm_rs`` (``triton_distributed_tpu/kernels/gemm_rs.py:1077``).
Its fused engine, ``_fused_kernel`` (``:248``), computes each rank's
partial product and folds it around an ack-credited reduce-scatter ring
(``reduce_ring``, ``kernels/ring.py:238``; the fold is
``ew_add_pipeline``, ``:72``), so that rank r ends with the r-th row
block of ``Σ_q A_q @ B_q``.

Two forms:

* **world size 1**, ``gemm_rs(a, b)`` on tensors: there is nothing to
  reduce and the kernel is the GEMM: ``tdt_gemm_rs`` on a one-rank table
  (launches counted apart, as ``gemm_rs_n1``, and by form);
* **over a mesh**, ``gemm_rs(a_shards, b_shards, mesh, axis)``: a list of
  W column shards A_q (W·m, K_q) and a list of W row shards B_q (K_q, N)
  → a list of W (m, N) outputs. On the card one launch of
  ``tdt_gemm_rs`` (``csrc/gemm_rs.cu``) covers every rank: each output
  tile runs its K loop over (rank q, k-block), reading A_q's rows and
  B_q through the peer tables, sums in f32 and rounds once.

Both forms run the warpgroup GEMM of ``csrc/wg_gemm.cuh`` (``wgmma`` fed
by TMA) where ``ag_gemm.wgmma_form`` holds, which bf16 operands of
16-byte rows do at any row count, else the tile loops of
``csrc/ggemm_tiles.cuh`` (bf16 on ``mma.sync``, f32 on FMA).

Rounding: the TPU ring folds each hop's partial into a slab of the
output type (``gemm_rs.py:551``), so in bf16 it rounds once per hop; the
port sums over every rank in f32 and rounds once. In bf16 the two differ
by up to about (W − 1) bf16 ulps of the result; in f32 they agree to the
summation order.

**The engine** (``method``, :class:`GemmRSMethod`, JAX ``:66``): None
takes JAX's heuristic (:func:`auto_gemm_rs_method`): ``PALLAS_FUSED``
where :func:`~triton_distributed_tpu_torch.kernels.ag_gemm.
pick_mm_blocks` blocks the shard at the GEMM-RS targets, else
``XLA_RING``. JAX first looks up a tuned winner (``tune/``), which comes
with ROADMAP Queue 1 step 10; until then None is the heuristic. The
method decides the wire and, on the int8-mxu wire, the numerics; the
raw wire runs the one mesh kernel on every method.

**Quantized wires** (``wire_dtype`` 'fp8' / 'int8' over a mesh of more
than one rank): the TPU ring (``_fused_kernel_w``, ``:281``) requantizes
each hop's running partial, so the numerics are its XLA twin's
(``gemm_rs_device``, ``:759-810``). For destination d the fold starts
from rank d − 1's partial of d's rows (rounded to the output type) and
at each of the W − 1 hops quantizes the running sum
(:func:`~triton_distributed_tpu_torch.lang.wire.quantize_slab` over the
(m, N) output slab), dequantizes it in f32, adds the next partial (ranks
d − 2, …, d: the own last) in f32 and rounds to the output type. On the
card: ``tdt_gemm_rs_partials`` (every rank's A_q @ B_q for all its rows;
the warpgroup GEMM of ``csrc/wg_gemm.cuh`` where ``ag_gemm.wgmma_form``
holds) and ``tdt_gemm_rs_fold`` (csrc/gemm_rs.cu). ``XLA_NAIVE`` ships no wire.

**int8-mxu** (:func:`resolve_gemm_rs_plan`): ``XLA_RING`` ships its
int8 payload (the fp8 / int8 fold above). ``PALLAS_FUSED`` keeps the s8
producer where one out tile spans every column and the rows align with
the row block ``bm`` (JAX ``:507-521``; N ≤ 1024 at the targets), and
demotes to the int8 wire elsewhere, or raises under
``GridSchedule(demote="strict")``. The producer quantizes each rank's A
at ``chunk_rows = bm`` and B per column and multiplies the codes with
s32 sums, ``acc · (a_scale · b_scale)`` in f32. Then the fold, by the
schedule's ``epilogue``: ``'accumulator'`` (``_fused_kernel_mxw``,
``:317``) quantizes hop 0 off the f32 partial and every later hop with
the scale of the f32 running sum and the codes of the sum rounded to
the output type (``lang/wire.py:404``); ``'readback'``
(``_fused_kernel_mxr``, ``:394``) rounds each partial to the output type
first and folds as the int8 wire does. In f32 the two are one function.
On the card: ``tdt_gemm_rs_mx`` (``mma.sync`` s8 of ``csrc/
s8_tiles.cuh``, every rank's partials in one launch) and the fold,
``tdt_gemm_rs_fold_mxw`` or ``tdt_gemm_rs_fold``. ``'auto'`` raises
(ROADMAP Queue 1 step 10).

On CPU tensors :func:`gemm_rs` runs :func:`gemm_rs_plain`; on CUDA
tensors it launches the kernels of the resolved wire or raises.
"""

from __future__ import annotations

import ctypes
import enum
from dataclasses import dataclass

import torch

from triton_distributed_tpu_torch.config import to_torch_dtype, warn_once
from triton_distributed_tpu_torch.kernels.ag_gemm import (
    _auto_refused,
    _check,
    _is_shards,
    ag_gemm_plain,
    check_mesh_operands,
    check_shards,
    count_form,
    launch_mesh_gemm,
    launch_n1_gemm,
    pick_mm_blocks,
    quantize_cols_shards,
    wgmma_form,
)
from triton_distributed_tpu_torch.kernels.group_gemm import _DT_CODE
from triton_distributed_tpu_torch.kernels.wire import WIRE_CODE, quantize_shards
from triton_distributed_tpu_torch.lang import wire as wirelib
from triton_distributed_tpu_torch.runtime.topology import one_axis
from triton_distributed_tpu_torch.tune.schedule import (
    GridSchedule,
    require_depth_only,
    require_grid_epilogue,
)

#: JAX's GEMM-RS tile targets (bm, bk, bn) (``kernels/gemm_rs.py:63``)
_RS_TILE_TARGETS = (512, 4096, 1024)


class GemmRSMethod(enum.Enum):
    """JAX's GEMM-RS engines (``:66``): the fused ring, the XLA ring
    twin and ``dot`` → ``psum_scatter``."""

    PALLAS_FUSED = "pallas_fused"
    XLA_RING = "xla_ring"
    XLA_NAIVE = "xla_naive"


def _check_rs(a, b, mesh, axis):
    n = check_shards(a, b, mesh, axis, "gemm_rs")
    if a[0].shape[1] != b[0].shape[0]:
        raise ValueError(f"gemm_rs: contract dim mismatch "
                         f"{tuple(a[0].shape)} @ {tuple(b[0].shape)}")
    if a[0].shape[0] % n:
        raise ValueError(f"gemm_rs: {a[0].shape[0]} rows do not scatter "
                         f"over {n} ranks")
    return n


def _shard_blocks(a, b, n):
    """JAX's (bm, bk, bn) for a rank's shard at the GEMM-RS targets, or
    None: (m_local, K_q) @ (K_q, N) in A's itemsize."""
    return pick_mm_blocks(a[0].shape[0] // n, a[0].shape[1], b[0].shape[1],
                          a[0].element_size(), targets=_RS_TILE_TARGETS)


def auto_gemm_rs_method(mesh, axis, a, b) -> GemmRSMethod:
    """JAX's heuristic (``auto_gemm_rs_method``, ``:916-956``):
    ``PALLAS_FUSED`` where the shard blocks, else ``XLA_RING`` (said
    once). JAX's other two answers have no counterpart on the loopback
    mesh: it has no DCN link, and its collectives always run."""
    n = one_axis(mesh, axis)
    if _shard_blocks(a, b, n) is None:
        warn_once(("gemm_rs", "blocks", tuple(a[0].shape), tuple(b[0].shape)),
                  f"gemm_rs: shard ({a[0].shape[0] // n}, {a[0].shape[1]}) "
                  f"@ {tuple(b[0].shape)} admits no divisor blocking; "
                  "falling back to XLA_RING")
        return GemmRSMethod.XLA_RING
    return GemmRSMethod.PALLAS_FUSED


def resolve_gemm_rs_method(mesh, axis, a, b, *, method=None) -> GemmRSMethod:
    """The engine :func:`gemm_rs` runs (JAX ``:1045-1075``): an explicit
    ``method``, else :func:`auto_gemm_rs_method`. JAX looks up a tuned
    winner first; that lookup comes with the tuning layer (ROADMAP Queue
    1 step 10), so here None is always the heuristic."""
    if method is not None:
        return GemmRSMethod(method)
    return auto_gemm_rs_method(mesh, axis, a, b)


def resolve_gemm_rs_wire(mesh, axis, a, b, *, method=None, wire_dtype=None):
    """The payload :func:`gemm_rs`'s ring ships (JAX
    ``resolve_gemm_rs_wire``, ``:958``): None for the raw wire, at world
    size 1 and under ``XLA_NAIVE``; 'int8-mxu' reports its int8 payload
    (:func:`resolve_gemm_rs_plan` says which kernel carries it); an
    explicit 'fp8' / 'int8' when the output slab (m, N) the ring moves
    can carry it, else ``ValueError``. 'auto' raises
    ``NotImplementedError``. ``method`` None stands for
    :func:`resolve_gemm_rs_method`'s."""
    w = wirelib.wire_payload(wirelib.normalize_wire(wire_dtype))
    if w is None or not _is_shards(a) or one_axis(mesh, axis) == 1:
        return None
    if resolve_gemm_rs_method(mesh, axis, a, b, method=method) \
            == GemmRSMethod.XLA_NAIVE:
        return None
    if w == "auto":
        raise _auto_refused("gemm_rs")
    rows, cols = a[0].shape[0] // len(a), b[0].shape[1]
    if not wirelib.wire_blockable(rows, cols, w):
        raise ValueError(
            f"gemm_rs wire_dtype={w!r}: slab ({rows}, {cols}) admits no "
            "legal wire chunking/blocking (a pinned wire format is a "
            "contract); use the bf16 wire")
    return w


@dataclass(frozen=True)
class GemmRSPlan:
    """What :func:`gemm_rs` runs over a mesh: the engine, the wire
    (None, 'fp8', 'int8' or 'int8-mxu': the s8 producer), and for
    'int8-mxu' its scale chunk (JAX's row block) and fold ``epilogue``
    ('accumulator': ``_fused_kernel_mxw``; 'readback':
    ``_fused_kernel_mxr``)."""

    method: GemmRSMethod
    wire: str | None
    chunk_rows: int | None = None
    epilogue: str | None = None

    @property
    def tpu_kernel(self) -> str | None:
        """The TPU kernel the int8-mxu producer stands for."""
        if self.wire != "int8-mxu":
            return None
        return ("_fused_kernel_mxr" if self.epilogue == "readback"
                else "_fused_kernel_mxw")


def resolve_gemm_rs_plan(mesh, axis, a, b, *, method=None, wire_dtype=None,
                         schedule=None) -> GemmRSPlan:
    """The engine, wire and int8-mxu geometry of a :func:`gemm_rs` call
    over a mesh (JAX's entry, ``:1137-1160``, and the gate of its
    ``_build_fused``, ``:487-521``). ``schedule``: None, a
    ``RingSchedule`` whose only non-default field is ``depth`` (it
    changes no value), or on the int8-mxu wire a ``GridSchedule`` (its
    ``epilogue`` and ``demote``; :func:`~triton_distributed_tpu_torch.
    tune.schedule.require_grid_epilogue`). ``PALLAS_FUSED`` on a shard
    that admits no blocking raises ``ValueError``, as JAX's
    ``_build_fused`` does."""
    n = one_axis(mesh, axis)
    asked = wirelib.normalize_wire(wire_dtype)
    if isinstance(schedule, GridSchedule):
        if asked != "int8-mxu":
            raise ValueError(
                f"gemm_rs: a GridSchedule sets the int8-mxu producer's "
                f"epilogue; wire_dtype={wire_dtype!r} takes a RingSchedule "
                "or None")
        epilogue, demote = require_grid_epilogue(schedule, "gemm_rs")
    else:
        require_depth_only(schedule, "gemm_rs")
        epilogue, demote = "accumulator", "auto"
    method = resolve_gemm_rs_method(mesh, axis, a, b, method=method)
    wire = resolve_gemm_rs_wire(mesh, axis, a, b, method=method,
                                wire_dtype=wire_dtype)
    if method != GemmRSMethod.PALLAS_FUSED or n == 1:
        return GemmRSPlan(method, wire)
    blocks = _shard_blocks(a, b, n)
    m_local, n_out = a[0].shape[0] // n, b[0].shape[1]
    if blocks is None:
        raise ValueError(
            f"gemm_rs PALLAS_FUSED: no divisor blocking for shard "
            f"({m_local}, {a[0].shape[1]}) @ {tuple(b[0].shape)}; use "
            "XLA_RING")
    if asked != "int8-mxu":
        return GemmRSPlan(method, wire)
    bm, _, bn = blocks
    if n_out // bn != 1 or m_local % bm:
        if demote == "strict":
            raise ValueError(
                f"gemm_rs int8-mxu: shard ({m_local}, {a[0].shape[1]}) @ "
                f"{tuple(b[0].shape)} blocks to {blocks} — the accumulator "
                "epilogue needs a full-width out tile and chunk-aligned "
                "rows, and the schedule pins demote='strict'")
        return GemmRSPlan(method, "int8")
    return GemmRSPlan(method, "int8-mxu", bm, epilogue)


def wire_fold_plain(parts, fmt, out_dtype):
    """The reduce ring's fold for one destination d, given ``parts[k]``
    = the partial of rank d − 1 − k for d's rows (the ring's order, the
    own partial last), each already of ``out_dtype``: start from
    ``parts[0]``; at each hop quantize the running sum, dequantize in
    f32, add the next partial in f32, round to ``out_dtype``."""
    acc = parts[0]
    for nxt in parts[1:]:
        q, s = wirelib.quantize_slab(acc, fmt)
        acc = (wirelib.dequantize_slab(q, s, fmt, torch.float32)
               + nxt.float()).to(out_dtype)
    return acc


def ring_order(parts, d):
    """Destination d's partials ``parts[q]`` (one per rank q) in the
    ring's order: rank d − 1 first, d − 2, …, d itself last."""
    n = len(parts)
    return [parts[(d - 1 - k) % n] for k in range(n)]


def gemm_rs_plain(a, b, mesh=None, axis: str = "tp", *, out_dtype=None,
                  wire=None, chunk_rows=None, epilogue="accumulator"):
    """Plain PyTorch version. Tensors: ``a @ b`` in f32, cast to
    ``out_dtype`` (default a's dtype). Shard lists: ``Σ_q A_q @ B_q`` in
    f32, cut into W row blocks, each cast once; with ``wire`` (a resolved
    'fp8' / 'int8', see :func:`resolve_gemm_rs_plan`) JAX's
    ``gemm_rs_device``: each rank's partial rounded to ``out_dtype``,
    folded hop by hop (:func:`wire_fold_plain`); with 'int8-mxu'
    :func:`gemm_rs_mx_plain` at ``chunk_rows`` and ``epilogue``."""
    if not _is_shards(a):
        return ag_gemm_plain(a, b, mesh, axis, out_dtype=out_dtype)
    n = _check_rs(a, b, mesh, axis)
    out_dtype = to_torch_dtype(out_dtype or a[0].dtype)
    if wire is None:
        acc = sum(aq.float() @ bq.float() for aq, bq in zip(a, b))
        return [blk.to(out_dtype) for blk in acc.chunk(n, dim=0)]
    if wire == "int8-mxu":
        return gemm_rs_mx_plain(a, b, mesh, axis, out_dtype=out_dtype,
                                chunk_rows=chunk_rows, epilogue=epilogue)
    fmt = wirelib.make_wire_format(wire, a[0].shape[0] // n)
    return gemm_rs_fold_plain([(aq.float() @ bq.float()).to(out_dtype)
                               for aq, bq in zip(a, b)], fmt, out_dtype)


def gemm_rs_fold_plain(parts, fmt, out_dtype):
    """Plain version of the fold over every destination: ``parts`` the W
    ranks' partial slabs (W·m, N) of ``out_dtype`` → the W (m, N)
    outputs, destination d's :func:`wire_fold_plain` of its rows in the
    ring's order."""
    n = len(parts)
    rows = [p.chunk(n, dim=0) for p in parts]
    return [wire_fold_plain(ring_order([r[d] for r in rows], d), fmt,
                            out_dtype) for d in range(n)]


def mx_partials_plain(q, s, bqt, bs, chunk_rows, part_dtype):
    """Plain version of :func:`gemm_rs_mx_partials`: rank q's s8 partial
    of all its rows, the codes ``q[q]`` (M, K) against ``bqt[q]`` (N, K)
    with exact integer sums (in f64), then ``acc · (a_scale[chunk] ·
    b_scale[col])`` in f32 (the scale product first, JAX ``:136-139``),
    cast to ``part_dtype`` → W (M, N) tensors."""
    out = []
    for qr, sr, br, cr in zip(q, s, bqt, bs):
        acc = (qr.double() @ br.double().t()).float()   # exact: |acc| < 2^53
        scale = sr.repeat_interleave(chunk_rows)[:, None] * cr[None, :]
        out.append((acc * scale).to(part_dtype))
    return out


def mxw_fold_plain(parts, fmt, out_dtype):
    """Plain version of the accumulator epilogue's fold
    (``_fused_kernel_mxw``): ``parts`` the W ranks' f32 partial slabs
    (W·m, N). Destination d takes its rows in the ring's order (rank
    d − 1's first, its own last); hop 0 ships the f32 partial's codes and
    scale; each hop dequantizes in f32 and adds the next partial rounded
    to ``out_dtype``; the next hop ships the codes of that sum rounded to
    ``out_dtype`` at the scale of the f32 sum (``lang/wire.py:424-451``).
    The last sum is rounded to ``out_dtype``."""
    n = len(parts)
    rows = [p.chunk(n, dim=0) for p in parts]
    out = []
    for d in range(n):
        order = ring_order([r[d] for r in rows], d)
        q, s = wirelib.quantize_slab(order[0], fmt)
        acc = order[0].to(out_dtype)
        for nxt in order[1:]:
            t = (wirelib.dequantize_slab(q, s, fmt, torch.float32)
                 + nxt.to(out_dtype).float())
            acc = t.to(out_dtype)
            s = wirelib.slab_scales(t, fmt)
            q = wirelib.quantize_at(acc, s, fmt)
        out.append(acc)
    return out


def gemm_rs_mx_fold_plain(parts, fmt, out_dtype, epilogue):
    """Plain version of :func:`gemm_rs_mx_fold`: 'accumulator'
    :func:`mxw_fold_plain` of the f32 partials; 'readback' the int8
    wire's :func:`gemm_rs_fold_plain` of the partials rounded to
    ``out_dtype`` (``_fused_kernel_mxr``)."""
    if epilogue == "readback":
        return gemm_rs_fold_plain([p.to(out_dtype) for p in parts], fmt,
                                  out_dtype)
    return mxw_fold_plain(parts, fmt, out_dtype)


def gemm_rs_mx_plain(a, b, mesh=None, axis: str = "tp", *, out_dtype=None,
                     chunk_rows=None, epilogue="accumulator"):
    """Plain version of the int8-mxu GEMM-RS (``_fused_kernel_mxw`` /
    ``_mxr``): every rank's A quantized at ``chunk_rows`` (default JAX's
    row block ``bm``), B per column (``quantize_cols``), the s8 partials
    (:func:`mx_partials_plain`) folded by ``epilogue``
    (:func:`gemm_rs_mx_fold_plain`)."""
    n = _check_rs(a, b, mesh, axis)
    out_dtype = to_torch_dtype(out_dtype or a[0].dtype)
    if chunk_rows is None:
        chunk_rows = _shard_blocks(a, b, n)[0]
    fmt = wirelib.WireFormat("int8", chunk_rows)
    wired = [wirelib.quantize_slab(aq, fmt) for aq in a]
    cols = [wirelib.quantize_cols(bq) for bq in b]
    parts = mx_partials_plain([q for q, _ in wired], [s for _, s in wired],
                              [q.t() for q, _ in cols],
                              [s.squeeze(0) for _, s in cols], chunk_rows,
                              torch.float32)
    return gemm_rs_mx_fold_plain(parts, fmt, out_dtype, epilogue)


def gemm_rs(a, b, mesh=None, axis: str = "tp", *, method=None,
            out_dtype=None, wire_dtype=None, schedule=None):
    """ReduceScatter(A @ B) (row-parallel).

    World size 1: a (M, K), b (K, N) tensors → (M, N). Over a mesh: a a
    list of W column shards (W·m, K_q), b a list of W row shards (K_q, N)
    → a list of W (m, N) outputs, rank r's row block r of the sum over
    ranks. A and B both bf16 or both f32 on the card; ``out_dtype``
    (default A's dtype) f32 or bf16. ``method``: a :class:`GemmRSMethod`
    or None (JAX's heuristic); ``wire_dtype``: None / 'bf16', 'fp8',
    'int8', 'int8-mxu'; ``schedule``: None, a ``RingSchedule`` (depth
    only) or, on 'int8-mxu', a ``GridSchedule`` (see
    :func:`resolve_gemm_rs_plan`). On CPU tensors this is
    :func:`gemm_rs_plain`; on CUDA tensors it launches the kernels or
    raises."""
    if not _is_shards(a):
        _check(a, b, mesh, axis, "gemm_rs")
        resolve_gemm_rs_wire(mesh, axis, a, b, method=method,
                             wire_dtype=wire_dtype)
        if a.device.type == "cpu":
            return gemm_rs_plain(a, b, out_dtype=out_dtype)
        return _gemm_rs_cuda(a, b, out_dtype)
    n = _check_rs(a, b, mesh, axis)
    plan = resolve_gemm_rs_plan(mesh, axis, a, b, method=method,
                                wire_dtype=wire_dtype, schedule=schedule)
    if a[0].device.type == "cpu":
        return gemm_rs_plain(a, b, mesh, axis, out_dtype=out_dtype,
                             wire=plan.wire, chunk_rows=plan.chunk_rows,
                             epilogue=plan.epilogue)
    if plan.wire == "int8-mxu":
        return _gemm_rs_mx_cuda(a, b, mesh, out_dtype, plan)
    if plan.wire is not None:
        return _gemm_rs_w_cuda(a, b, mesh, out_dtype, plan.wire)
    return _gemm_rs_mesh_cuda(a, b, mesh, n, out_dtype)


def _gemm_rs_cuda(a, b, out_dtype):
    return launch_n1_gemm(_gemm_rs_cuda, "tdt_gemm_rs", a, b, out_dtype)


def _gemm_rs_mesh_cuda(a, b, mesh, n, out_dtype):
    m = a[0].shape[0] // n
    return launch_mesh_gemm(_gemm_rs_mesh_cuda, "tdt_gemm_rs", a, b, m, m,
                            out_dtype, mesh)


def gemm_rs_partials(a, b, mesh, out_dtype):
    """``tdt_gemm_rs_partials``: every rank's partial ``A_q @ B_q`` for
    all its W·m rows, f32 sums rounded once to ``out_dtype``, in one
    launch → the W (W·m, N) slabs (symmetric: the fold reads its peers').
    On the warpgroup GEMM where :func:`~triton_distributed_tpu_torch.
    kernels.ag_gemm.wgmma_form` holds (m the rows of one destination's
    block), else on the tile loops; counted by the form it ran in
    ``by_variant``."""
    from triton_distributed_tpu_torch.kernels import _build
    from triton_distributed_tpu_torch.lang.shmem import peer_table, symm_empty

    out_dtype, aligned = check_mesh_operands("tdt_gemm_rs_partials", a, b,
                                             out_dtype)
    n, (rows, k), cols = len(a), a[0].shape, b[0].shape[1]
    dev = mesh.device
    parts = symm_empty(mesh, (rows, cols), out_dtype)
    wg = wgmma_form(rows // n, k, cols, n, a[0].dtype, out_dtype,
                    [*a, *b, *parts.shards])
    # the tile loops read the device tables, the warpgroup GEMM's maps the
    # host pointers; both stay referenced until the launch is enqueued
    zero = None if wg else torch.zeros((1,), dtype=torch.int32, device=dev)
    a_peers, b_peers = (None, None) if wg else (peer_table(a), peer_table(b))
    hosts = [_build.ptr_array(t) for t in (a, b, parts.shards)]
    form = ctypes.c_int(-1)
    fn = _build.function("tdt_gemm_rs_partials", "p" * 7 + "i" * 8 + "pp")
    rc = fn(None if wg else _build.ptr(a_peers),
            None if wg else _build.ptr(b_peers), _build.ptr(parts.peers),
            None if wg else _build.ptr(zero), *hosts, rows // n, k, cols, n,
            _DT_CODE[a[0].dtype], _DT_CODE[out_dtype], int(aligned), int(wg),
            ctypes.byref(form), _build.stream(dev))
    _build.check(rc, "tdt_gemm_rs_partials")
    gemm_rs_partials.launches += 1
    count_form(gemm_rs_partials, form.value)
    return parts.shards


def launch_fold(parts, mesh, fmt, out_dtype):
    """Launch ``tdt_gemm_rs_fold`` over the W ranks' partial slabs
    ``parts`` (W tensors (W·m, N) of ``out_dtype``, rank q's partials of
    every destination's rows, destination d's at d·m), one block a
    (destination, chunk) → the W (m, N) outputs: :func:`gemm_rs_fold_plain`,
    bit for bit. Counts nothing: :func:`gemm_rs_fold` and the MoE-TP
    wire's fold count their own launches."""
    from triton_distributed_tpu_torch.kernels import _build
    from triton_distributed_tpu_torch.lang.shmem import peer_table, symm_empty

    n = len(parts)
    m, cols = parts[0].shape[0] // n, parts[0].shape[1]
    out = symm_empty(mesh, (m, cols), out_dtype)
    p_peers = peer_table(parts)   # referenced until the launch is enqueued
    aligned = all(t.data_ptr() % 16 == 0 for t in (*parts, *out.shards))
    fn = _build.function("tdt_gemm_rs_fold", "pp" + "i" * 9 + "p")
    rc = fn(_build.ptr(p_peers), _build.ptr(out.peers), m, cols, n, 0, n,
            fmt.chunk_rows, WIRE_CODE[fmt.quant], _DT_CODE[out_dtype],
            int(aligned), _build.stream(mesh.device))
    _build.check(rc, "tdt_gemm_rs_fold")
    return out.shards


def gemm_rs_fold(parts, mesh, fmt, out_dtype):
    """The GEMM-RS wire's fold: :func:`launch_fold` of the ranks' partial
    slabs (rank q's A_q @ B_q)."""
    out = launch_fold(parts, mesh, fmt, out_dtype)
    gemm_rs_fold.launches += 1
    return out


def _gemm_rs_w_cuda(a, b, mesh, out_dtype, wire):
    """The fp8 / int8 wire: every rank's partial slab
    (:func:`gemm_rs_partials`), then the fold (:func:`gemm_rs_fold`)."""
    parts = gemm_rs_partials(a, b, mesh, out_dtype)
    fmt = wirelib.make_wire_format(wire, a[0].shape[0] // len(a))
    return gemm_rs_fold(parts, mesh, fmt, parts[0].dtype)


def _count(fn, tpu_kernel):
    """One launch of ``fn``'s kernel, also by the TPU kernel it stands
    for."""
    fn.launches += 1
    fn.by_tpu_kernel[tpu_kernel] = fn.by_tpu_kernel.get(tpu_kernel, 0) + 1


def gemm_rs_mx_partials(q, s, bqt, bs, mesh, chunk_rows, part_dtype,
                        tpu_kernel="_fused_kernel_mxw"):
    """``tdt_gemm_rs_mx``: every rank's s8 partial for all its W·m rows
    in one launch, q (W, W·m, K) int8 codes with s (W, W·m / chunk_rows)
    scales against bqt (W, N, K) int8 weights (transposed) with bs (W, N)
    column scales, epilogue ``acc · (a_scale · b_scale)`` → the W (W·m,
    N) slabs of ``part_dtype`` (f32 for the accumulator epilogue, the
    output type for the readback one; symmetric: the fold reads its
    peers'). :func:`mx_partials_plain`, bit for bit. Counted by the TPU
    kernel it stands for."""
    from triton_distributed_tpu_torch.kernels import _build
    from triton_distributed_tpu_torch.lang.shmem import symm_empty

    n, rows, k = q.shape
    parts = symm_empty(mesh, (rows, bqt.shape[1]), part_dtype)
    fn = _build.function("tdt_gemm_rs_mx", "ppppp" + "i" * 6 + "p")
    rc = fn(_build.ptr(q), _build.ptr(s), _build.ptr(bqt), _build.ptr(bs),
            _build.ptr(parts.peers), rows, k, bqt.shape[1], n, chunk_rows,
            _DT_CODE[part_dtype], _build.stream(mesh.device))
    _build.check(rc, "tdt_gemm_rs_mx")
    _count(gemm_rs_mx_partials, tpu_kernel)
    return parts.shards


def gemm_rs_mx_fold(parts, mesh, fmt, out_dtype, epilogue):
    """The int8-mxu GEMM-RS's fold over the W ranks' partial slabs:
    'accumulator' (``_fused_kernel_mxw``) ``tdt_gemm_rs_fold_mxw`` over
    f32 partials; 'readback' (``_fused_kernel_mxr``) the int8 wire's
    ``tdt_gemm_rs_fold`` (:func:`launch_fold`) over partials of
    ``out_dtype``. :func:`gemm_rs_mx_fold_plain`, bit for bit; the two
    modes count apart (``launches_mxw``, ``launches_mxr``)."""
    if epilogue == "readback":
        out = launch_fold(parts, mesh, fmt, out_dtype)
        gemm_rs_mx_fold.launches_mxr += 1
        return out
    from triton_distributed_tpu_torch.kernels import _build
    from triton_distributed_tpu_torch.lang.shmem import peer_table, symm_empty

    if parts[0].dtype != torch.float32 or fmt.quant != "int8":
        raise ValueError("tdt_gemm_rs_fold_mxw folds f32 partials on the "
                         f"int8 wire, got {parts[0].dtype} on {fmt.quant}")
    n = len(parts)
    m, cols = parts[0].shape[0] // n, parts[0].shape[1]
    out = symm_empty(mesh, (m, cols), out_dtype)
    p_peers = peer_table(parts)   # referenced until the launch is enqueued
    aligned = all(t.data_ptr() % 16 == 0 for t in (*parts, *out.shards))
    fn = _build.function("tdt_gemm_rs_fold_mxw", "pp" + "i" * 8 + "p")
    rc = fn(_build.ptr(p_peers), _build.ptr(out.peers), m, cols, n, 0, n,
            fmt.chunk_rows, _DT_CODE[out_dtype], int(aligned),
            _build.stream(mesh.device))
    _build.check(rc, "tdt_gemm_rs_fold_mxw")
    gemm_rs_mx_fold.launches_mxw += 1
    return out.shards


def _gemm_rs_mx_cuda(a, b, mesh, out_dtype, plan):
    """The int8-mxu producer: every rank's A quantized at the row block
    (``quantize_shards``), B per column (``quantize_cols_shards``, torch
    ops, every call, as JAX quantizes B in its jitted body), the s8
    partials, then the fold of the plan's epilogue."""
    out_dtype, _ = check_mesh_operands("tdt_gemm_rs_mx", a, b, out_dtype,
                                       need_b=False)
    fmt = wirelib.WireFormat("int8", plan.chunk_rows)
    q, s = quantize_shards(a, fmt)
    bqt, bs = quantize_cols_shards(b)
    part_dtype = (out_dtype if plan.epilogue == "readback"
                  else torch.float32)
    parts = gemm_rs_mx_partials(q, s, bqt, bs, mesh, plan.chunk_rows,
                                part_dtype, plan.tpu_kernel)
    return gemm_rs_mx_fold(parts, mesh, fmt, out_dtype, plan.epilogue)


#: launch counts of the kernels (plain ints on the wrappers): the world-
#: size-1 GEMM, the kernel over a mesh, and the two kernels of its
#: fp8 / int8 wire; all but the fold also by form
_gemm_rs_cuda.launches = 0
_gemm_rs_cuda.by_variant = {}
_gemm_rs_mesh_cuda.launches = 0
_gemm_rs_mesh_cuda.by_variant = {}
gemm_rs_partials.launches = 0
gemm_rs_partials.by_variant = {}
gemm_rs_fold.launches = 0
#: the int8-mxu producer's partials, also by the TPU kernel each launch
#: stands for, and its fold's two modes
gemm_rs_mx_partials.launches = 0
gemm_rs_mx_partials.by_tpu_kernel = {}
gemm_rs_mx_fold.launches_mxw = 0
gemm_rs_mx_fold.launches_mxr = 0
