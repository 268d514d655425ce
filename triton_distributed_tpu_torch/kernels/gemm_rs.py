"""GEMM + reduce-scatter for row-parallel tensor parallelism.

Port of ``gemm_rs`` (``triton_distributed_tpu/kernels/gemm_rs.py:1077``).
Its fused engine, ``_fused_kernel`` (``:248``), computes each rank's
partial product and folds it around an ack-credited reduce-scatter ring
(``reduce_ring``, ``kernels/ring.py:238``; the fold is
``ew_add_pipeline``, ``:72``), so that rank r ends with the r-th row
block of ``Σ_q A_q @ B_q``.

Two forms:

* **world size 1**, ``gemm_rs(a, b)`` on tensors: there is nothing to
  reduce and the kernel is the GEMM, on the float-mode kernel of
  ``csrc/group_gemm.cu`` with one expert (launches counted apart, as
  ``gemm_rs_n1``);
* **over a mesh**, ``gemm_rs(a_shards, b_shards, mesh, axis)``: a list of
  W column shards A_q (W·m, K_q) and a list of W row shards B_q (K_q, N)
  → a list of W (m, N) outputs. On the card one launch of
  ``tdt_gemm_rs`` (``csrc/gemm_rs.cu``) covers every rank: each output
  tile runs its K loop over (rank q, k-block), reading A_q's rows and
  B_q through the peer tables, sums in f32 and rounds once.

Rounding: the TPU ring folds each hop's partial into a slab of the
output type (``gemm_rs.py:551``), so in bf16 it rounds once per hop; the
port sums over every rank in f32 and rounds once. In bf16 the two differ
by up to about (W − 1) bf16 ulps of the result; in f32 they agree to the
summation order.

**Quantized wires** (``wire_dtype`` 'fp8' / 'int8' over a mesh of more
than one rank; 'int8-mxu' ships its int8 payload here, as JAX's
``resolve_gemm_rs_wire`` maps it, ``:968-970``): the TPU ring
(``_fused_kernel_w``, ``:281``) requantizes each hop's running partial,
so the numerics are its XLA twin's (``gemm_rs_device``, ``:759-810``).
For destination d the fold starts from rank d − 1's partial of d's rows
(rounded to the output type) and at each of the W − 1 hops quantizes
the running sum (:func:`~triton_distributed_tpu_torch.lang.wire.
quantize_slab` over the (m, N) output slab), dequantizes it in f32, adds
the next partial (ranks d − 2, …, d: the own last) in f32 and rounds to
the output type. On the card: ``tdt_gemm_rs_partials`` (every rank's
A_q @ B_q for all its rows) and ``tdt_gemm_rs_fold`` (csrc/gemm_rs.cu).
The int8-mxu producers ``_mxw`` / ``_mxr`` (``:317``, ``:394``) JAX
takes only when one out tile spans every column (``:507-521``), never
at Llama's N = 4096; they are ROADMAP Queue 2 item 17. ``'auto'`` raises
(ROADMAP Queue 1 step 10).

On CPU tensors :func:`gemm_rs` runs :func:`gemm_rs_plain`; on CUDA
tensors it launches the kernels of the resolved wire or raises.
"""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.config import to_torch_dtype
from triton_distributed_tpu_torch.kernels.ag_gemm import (
    _auto_refused,
    _check,
    _is_shards,
    ag_gemm_plain,
    check_mesh_operands,
    check_shards,
    launch_mesh_gemm,
)
from triton_distributed_tpu_torch.kernels.group_gemm import _DT_CODE
from triton_distributed_tpu_torch.kernels.wire import WIRE_CODE
from triton_distributed_tpu_torch.lang import wire as wirelib
from triton_distributed_tpu_torch.runtime.topology import one_axis


def _check_rs(a, b, mesh, axis):
    n = check_shards(a, b, mesh, axis, "gemm_rs")
    if a[0].shape[1] != b[0].shape[0]:
        raise ValueError(f"gemm_rs: contract dim mismatch "
                         f"{tuple(a[0].shape)} @ {tuple(b[0].shape)}")
    if a[0].shape[0] % n:
        raise ValueError(f"gemm_rs: {a[0].shape[0]} rows do not scatter "
                         f"over {n} ranks")
    return n


def resolve_gemm_rs_wire(mesh, axis, a, b, *, wire_dtype=None):
    """The wire :func:`gemm_rs` ships for these arguments (JAX
    ``resolve_gemm_rs_wire``, ``:958``): 'int8-mxu' maps to its int8
    payload (a reduce ring has no tensor-core consumer); None for the
    raw wire and at world size 1; an explicit 'fp8' / 'int8' when the
    output slab (m, N) the ring moves can carry it, else ``ValueError``.
    'auto' raises ``NotImplementedError``."""
    w = wirelib.wire_payload(wirelib.normalize_wire(wire_dtype))
    if w is None or not _is_shards(a) or one_axis(mesh, axis) == 1:
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
                  wire=None):
    """Plain PyTorch version. Tensors: ``a @ b`` in f32, cast to
    ``out_dtype`` (default a's dtype). Shard lists: ``Σ_q A_q @ B_q`` in
    f32, cut into W row blocks, each cast once; with ``wire`` (a resolved
    'fp8' / 'int8', see :func:`resolve_gemm_rs_wire`) JAX's
    ``gemm_rs_device``: each rank's partial rounded to ``out_dtype``,
    folded hop by hop (:func:`wire_fold_plain`)."""
    if not _is_shards(a):
        return ag_gemm_plain(a, b, mesh, axis, out_dtype=out_dtype)
    n = _check_rs(a, b, mesh, axis)
    out_dtype = to_torch_dtype(out_dtype or a[0].dtype)
    if wire is None:
        acc = sum(aq.float() @ bq.float() for aq, bq in zip(a, b))
        return [blk.to(out_dtype) for blk in acc.chunk(n, dim=0)]
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


def gemm_rs(a, b, mesh=None, axis: str = "tp", *, out_dtype=None,
            wire_dtype=None):
    """ReduceScatter(A @ B) (row-parallel).

    World size 1: a (M, K), b (K, N) tensors → (M, N). Over a mesh: a a
    list of W column shards (W·m, K_q), b a list of W row shards (K_q, N)
    → a list of W (m, N) outputs, rank r's row block r of the sum over
    ranks. A and B both bf16 or both f32 on the card; ``out_dtype``
    (default A's dtype) f32 or bf16. ``wire_dtype``: None / 'bf16',
    'fp8', 'int8', 'int8-mxu' (its int8 payload; see
    :func:`resolve_gemm_rs_wire`). On CPU tensors this is
    :func:`gemm_rs_plain`; on CUDA tensors it launches the kernel or
    raises."""
    if not _is_shards(a):
        _check(a, b, mesh, axis, "gemm_rs")
        resolve_gemm_rs_wire(mesh, axis, a, b, wire_dtype=wire_dtype)
        if a.device.type == "cpu":
            return gemm_rs_plain(a, b, out_dtype=out_dtype)
        return _gemm_rs_cuda(a, b, out_dtype)
    n = _check_rs(a, b, mesh, axis)
    wire = resolve_gemm_rs_wire(mesh, axis, a, b, wire_dtype=wire_dtype)
    if a[0].device.type == "cpu":
        return gemm_rs_plain(a, b, mesh, axis, out_dtype=out_dtype,
                             wire=wire)
    if wire is not None:
        return _gemm_rs_w_cuda(a, b, mesh, out_dtype, wire)
    return _gemm_rs_mesh_cuda(a, b, mesh, n, out_dtype)


def _gemm_rs_cuda(a, b, out_dtype):
    from triton_distributed_tpu_torch.kernels.group_gemm import float_gemm

    out = float_gemm(a, b, out_dtype)
    _gemm_rs_cuda.launches += 1
    return out


def _gemm_rs_mesh_cuda(a, b, mesh, n, out_dtype):
    m = a[0].shape[0] // n
    out = launch_mesh_gemm("tdt_gemm_rs", a, b, mesh, n, m, m, out_dtype)
    _gemm_rs_mesh_cuda.launches += 1
    return out


def gemm_rs_partials(a, b, mesh, out_dtype):
    """``tdt_gemm_rs_partials``: every rank's partial ``A_q @ B_q`` for
    all its W·m rows, f32 sums rounded once to ``out_dtype``, in one
    launch → the W (W·m, N) slabs (symmetric: the fold reads its peers')."""
    from triton_distributed_tpu_torch.kernels import _build
    from triton_distributed_tpu_torch.lang.shmem import peer_table, symm_empty

    out_dtype, aligned = check_mesh_operands("tdt_gemm_rs_partials", a, b,
                                             out_dtype)
    n, (rows, k) = len(a), a[0].shape
    dev = mesh.device
    zero = torch.zeros((1,), dtype=torch.int32, device=dev)
    parts = symm_empty(mesh, (rows, b[0].shape[1]), out_dtype)
    a_peers, b_peers = peer_table(a), peer_table(b)
    fn = _build.function("tdt_gemm_rs_partials", "pppp" + "i" * 7 + "p")
    rc = fn(_build.ptr(a_peers), _build.ptr(b_peers), _build.ptr(parts.peers),
            _build.ptr(zero), rows // n, k, b[0].shape[1], n,
            _DT_CODE[a[0].dtype], _DT_CODE[out_dtype], int(aligned),
            _build.stream(dev))
    _build.check(rc, "tdt_gemm_rs_partials")
    gemm_rs_partials.launches += 1
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


#: launch counts of the kernels (plain ints on the wrappers): the world-
#: size-1 GEMM, the kernel over a mesh, and the two kernels of its
#: quantized wire
_gemm_rs_cuda.launches = 0
_gemm_rs_mesh_cuda.launches = 0
gemm_rs_partials.launches = 0
gemm_rs_fold.launches = 0
