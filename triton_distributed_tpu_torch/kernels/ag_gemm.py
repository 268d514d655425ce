"""All-gather + GEMM for column-parallel tensor parallelism.

Port of ``ag_gemm`` (``triton_distributed_tpu/kernels/ag_gemm.py:1132``).
Its fused engine, ``_fused_kernel`` (``:227``), forwards the row shards
of A around a ring (``ag_forward_ring``, ``kernels/ring.py:115``) and
streams each through the blocked GEMM of ``mm_pipeline``
(``:128-162``), so that rank r ends with ``out_r = AllGather(A) @ B_r``:
bf16 (or f32) in, f32 sums, the output in A's dtype.

Two forms:

* **world size 1**, ``ag_gemm(a, b)`` on tensors: the ring has nothing
  to gather and the kernel is the GEMM: ``tdt_ag_gemm`` on a one-rank
  table (launches counted apart, as ``ag_gemm_n1``, and by form);
* **over a mesh**, ``ag_gemm(a_shards, b_shards, mesh, axis)``: a list of
  W row shards A_q (m, K) and a list of W column shards B_r (K, N_r) →
  a list of W outputs (W·m, N_r). On the card one launch of
  ``tdt_ag_gemm`` (``csrc/ag_gemm.cu``) covers every rank: each output
  tile loads its A rows from the peer rank that holds them, through the
  peer table (:mod:`~triton_distributed_tpu_torch.lang.shmem`).

Both forms run the warpgroup GEMM of ``csrc/wg_gemm.cuh`` (``wgmma`` fed
by TMA, each shard tiled on its own) where :func:`wgmma_form` holds,
which bf16 operands of 16-byte rows do at any row count, else the tile
loops of ``csrc/ggemm_tiles.cuh`` (bf16 on ``mma.sync``, f32 on FMA).

**Quantized wires** (``wire_dtype``, over a mesh of more than one
rank; :func:`resolve_ag_gemm_wire` says which wire runs): ``'fp8'`` /
``'int8'`` ship each shard once as 1-byte codes with one f32 scale a
chunk of rows (:mod:`~triton_distributed_tpu_torch.lang.wire`); a rank
reads its own shard exact and a peer's dequantized to A's dtype
(``_fused_kernel_w``, ``:266``; on the card ``tdt_ag_gemm_w``, on the
warpgroup GEMM of ``csrc/wg_gemm.cuh`` where :func:`wgmma_form` holds).
``'int8-mxu'`` quantizes every shard, the own one too, and B per output
column (``quantize_cols``), and multiplies the int8 codes with s32 sums,
``(acc · row scale) · column scale`` in f32 (``_fused_kernel_mx``,
``:309``; ``tdt_ag_gemm_mx``). The numerics are those of JAX's XLA ring
twin ``ag_gemm_device`` (``:672-795``), with the chunk rows of
:func:`~triton_distributed_tpu_torch.lang.wire.make_wire_format`, except
where JAX's engine choice (:class:`AGGemmMethod`,
:func:`resolve_ag_gemm_method`: with no method ``PALLAS_FUSED`` wherever
:func:`pick_mm_blocks` blocks the shard) runs its fused int8-mxu kernel,
which chunks the scales at its row block (``:428-432``): there the port
chunks at ``pick_mm_blocks(...)[0]`` too (:func:`resolve_ag_gemm_plan`).
``'auto'`` needs the wire tuner and perf model of ``tune/`` and raises
(ROADMAP Queue 1 step 10).

On CPU tensors :func:`ag_gemm` runs :func:`ag_gemm_plain`; on CUDA
tensors it launches the kernel of the resolved wire or raises.
"""

from __future__ import annotations

import ctypes
import enum
from dataclasses import dataclass

import torch

from triton_distributed_tpu_torch.config import (
    fused_vmem_budget,
    to_torch_dtype,
    warn_once,
)
from triton_distributed_tpu_torch.kernels.group_gemm import _DT_CODE
from triton_distributed_tpu_torch.kernels.wire import WIRE_CODE, quantize_shards
from triton_distributed_tpu_torch.lang import wire as wirelib
from triton_distributed_tpu_torch.runtime.topology import one_axis


#: JAX's AG-GEMM tile targets (bm, bk, bn) (``kernels/ag_gemm.py:79``);
#: the GEMM-RS carries its own (``gemm_rs._RS_TILE_TARGETS``)
_TILE_TARGETS = (512, 2048, 1792)

#: the form an AG-GEMM, GEMM-RS or wire launch ran, by the code its C
#: entry reports (``MeshGemmForm`` of ``csrc/wg_gemm.cuh``): the
#: warpgroup GEMM (``wgmma`` fed by TMA) where :func:`wgmma_form` holds,
#: else the tile loops of ``csrc/ggemm_tiles.cuh`` (bf16 on ``mma.sync``,
#: f32 on FMA). Counted in ``by_variant`` on the mesh wrappers
#: (``_ag_gemm_mesh_cuda``, ``gemm_rs._gemm_rs_mesh_cuda``), the
#: world-size-1 ones (``_ag_gemm_cuda``, ``gemm_rs._gemm_rs_cuda``), the
#: wires' (``ag_gemm_w_launch``, ``gemm_rs.gemm_rs_partials``) and the
#: MoE-TP grouped GEMMs' (``moe_tp_fused``, :func:`grouped_wgmma_form`).
MESH_GEMM_FORMS = {0: "fma", 1: "mma_sync", 2: "wgmma"}
#: the warpgroup GEMM's tile rows and the ranks a launch's tensor maps
#: cover (``WG_BM``, ``WG_MAX_RANKS``)
WG_TILE_ROWS = 128
WG_MAX_RANKS = 8


def pick_mm_blocks(m: int, k: int, n: int, itemsize: int,
                   budget: int | None = None, targets=None):
    """(bm, bk, bn) of JAX's streaming matmul pipeline (``kernels/
    ag_gemm.py:101``), or None where the shape admits no divisor
    blocking: the targets shrink until two A, B and output tiles and an
    f32 accumulator fit the fused-engine budget (:func:`~triton_
    distributed_tpu_torch.config.fused_vmem_budget`). The port's own
    copy, off the TPU's strict tiling as JAX decides off a TPU. On the
    card the blocks set no tile: JAX's row block ``bm`` is the int8-mxu
    GEMM-RS's scale chunk and the gate of its engine choice."""
    budget = budget or fused_vmem_budget()
    sublane = 8 * (4 // itemsize)
    tm, tk, tn = targets or _TILE_TARGETS
    while True:
        bm = wirelib._divisor_block(m, tm, sublane, False)
        bk = wirelib._divisor_block(k, tk, 128, False)
        bn = wirelib._divisor_block(n, tn, 128, False)
        if bm is None or bk is None or bn is None:
            return None
        work = (2 * (bm * bk + bk * bn) * itemsize + 2 * bm * bn * itemsize
                + 4 * bm * bn)
        if work <= budget:
            return bm, bk, bn
        if tm <= 64 and tk <= 128 and tn <= 128:
            return None
        tm, tk, tn = max(tm // 2, 64), max(tk // 2, 128), max(tn // 2, 128)


class AGGemmMethod(enum.Enum):
    """JAX's AG-GEMM engines (``:65``): the fused ring, the XLA ring twin
    and ``all_gather`` → ``dot``. On the card the fused engine and the
    XLA ring run the same pull kernels; the choice sets the int8-mxu
    wire's scale chunk, and ``XLA_NAIVE`` ships no wire."""

    PALLAS_FUSED = "pallas_fused"
    XLA_RING = "xla_ring"
    XLA_NAIVE = "xla_naive"


def _shard_blocks(a, b):
    """JAX's (bm, bk, bn) for a rank's (m, K) @ (K, N_r) shard product
    in A's itemsize, or None."""
    return pick_mm_blocks(a[0].shape[0], a[0].shape[1], b[0].shape[1],
                          a[0].element_size())


def auto_ag_gemm_method(mesh, axis, a, b) -> AGGemmMethod:
    """JAX's heuristic (``auto_ag_gemm_method``, ``:944-985``):
    ``PALLAS_FUSED`` where the shard blocks, else ``XLA_RING`` (said
    once). JAX's other answers have no counterpart on the loopback mesh:
    it has no DCN link, and its collectives always run."""
    if _shard_blocks(a, b) is None:
        warn_once(("ag_gemm", "blocks", tuple(a[0].shape), tuple(b[0].shape)),
                  f"ag_gemm: shard {tuple(a[0].shape)} @ {tuple(b[0].shape)}"
                  " admits no divisor blocking; falling back to XLA_RING")
        return AGGemmMethod.XLA_RING
    return AGGemmMethod.PALLAS_FUSED


def resolve_ag_gemm_method(mesh, axis, a, b, *, method=None) -> AGGemmMethod:
    """The engine :func:`ag_gemm` runs (JAX ``:1094-1129``): an explicit
    ``method``, else :func:`auto_ag_gemm_method`. JAX looks up a tuned
    winner first; that lookup comes with the tuning layer (ROADMAP Queue
    1 step 10), so here None is always the heuristic."""
    if method is not None:
        return AGGemmMethod(method)
    return auto_ag_gemm_method(mesh, axis, a, b)


def _is_shards(a) -> bool:
    return isinstance(a, (list, tuple))


def _check(a, b, mesh, axis, what):
    """The world-size-1 form: two matrices, and no mesh or a mesh of one
    rank along ``axis``."""
    if mesh is not None and one_axis(mesh, axis) != 1:
        raise ValueError(
            f"{what} at world size {mesh.shape[axis]} takes lists of "
            "per-rank shards, not tensors")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"{what}: contract dim mismatch {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")


def check_shards(a, b, mesh, axis, what):
    """Shard lists ``a`` and ``b`` of W same-shaped 2-D matrices each on
    the mesh's device, W the size of ``axis``. Returns W."""
    if mesh is None:
        raise ValueError(f"{what} on shard lists needs the mesh")
    n = one_axis(mesh, axis)
    if not (_is_shards(b) and len(a) == n and len(b) == n):
        raise ValueError(f"{what}: A and B must be lists of {n} per-rank "
                         f"shards (the {axis!r} axis)")
    for shards, name in ((a, "A"), (b, "B")):
        s0 = shards[0]
        for s in shards:
            if s.dim() != 2 or s.shape != s0.shape or s.dtype != s0.dtype:
                raise ValueError(f"{what}: the {name} shards must be 2-D "
                                 "matrices of one shape and dtype")
            if s.device != mesh.device:
                raise ValueError(f"{what}: {name} shard on {s.device}, the "
                                 f"mesh is on {mesh.device}")
    return n


def _auto_refused(op: str):
    return NotImplementedError(
        f"{op} wire_dtype='auto' needs the wire tuner and the perf model "
        "of tune/ (ROADMAP Queue 1 step 10); pass 'fp8', 'int8', "
        "'int8-mxu' or None")


def resolve_ag_gemm_wire(mesh, axis, a, b, *, method=None, wire_dtype=None):
    """The wire :func:`ag_gemm` ships for these arguments (JAX
    ``resolve_ag_gemm_wire``, ``:988``): None for the raw wire, at world
    size 1 (tensors, or a mesh of one rank: nothing crosses a wire) and
    under ``XLA_NAIVE`` (no ring), else the explicit 'fp8' / 'int8' /
    'int8-mxu' when an A shard (m, K) can carry it
    (:func:`~triton_distributed_tpu_torch.lang.wire.wire_blockable`), and
    ``ValueError`` when it cannot: a pinned wire is a contract. 'auto'
    raises ``NotImplementedError``."""
    w = wirelib.normalize_wire(wire_dtype)
    if w is None or not _is_shards(a) or one_axis(mesh, axis) == 1:
        return None
    if method is not None and AGGemmMethod(method) == AGGemmMethod.XLA_NAIVE:
        return None
    if w == "auto":
        raise _auto_refused("ag_gemm")
    rows, k = a[0].shape
    if not wirelib.wire_blockable(rows, k, w):
        raise ValueError(
            f"ag_gemm wire_dtype={w!r}: slab ({rows}, {k}) admits no legal "
            "wire chunking/blocking (a pinned wire format is a contract); "
            "use the bf16 wire")
    return w


@dataclass(frozen=True)
class AGGemmPlan:
    """What :func:`ag_gemm` runs over a mesh: the engine, the wire (None,
    'fp8', 'int8' or 'int8-mxu') and the wire's scale chunk in rows."""

    method: AGGemmMethod
    wire: str | None
    chunk_rows: int | None = None


def resolve_ag_gemm_plan(mesh, axis, a, b, *, method=None,
                         wire_dtype=None) -> AGGemmPlan:
    """The engine, wire and scale chunk of an :func:`ag_gemm` call over a
    mesh (JAX's entry, ``:1303-1340``, and the gate of its
    ``_build_fused``, ``:397-432``). Every wire chunks at
    :func:`~triton_distributed_tpu_torch.lang.wire.make_wire_format`'s
    rows, except int8-mxu on ``PALLAS_FUSED``, whose kernel chunks at its
    row block, ``pick_mm_blocks(...)[0]``. ``PALLAS_FUSED`` on a shard
    that admits no blocking raises ``ValueError``, as JAX's
    ``_build_fused`` does."""
    method = resolve_ag_gemm_method(mesh, axis, a, b, method=method)
    wire = resolve_ag_gemm_wire(mesh, axis, a, b, method=method,
                                wire_dtype=wire_dtype)
    if method == AGGemmMethod.PALLAS_FUSED and one_axis(mesh, axis) > 1:
        blocks = _shard_blocks(a, b)
        if blocks is None:
            raise ValueError(
                f"ag_gemm PALLAS_FUSED: no divisor blocking for shard "
                f"{tuple(a[0].shape)} @ {tuple(b[0].shape)}; use XLA_RING")
        if wire == "int8-mxu":
            return AGGemmPlan(method, wire, blocks[0])
    if wire is None:
        return AGGemmPlan(method, None)
    fmt = wirelib.make_wire_format(wire, a[0].shape[0])
    return AGGemmPlan(method, wire, fmt.chunk_rows)


def ag_gemm_plain(a, b, mesh=None, axis: str = "tp", *, out_dtype=None,
                  wire=None, chunk_rows=None):
    """Plain PyTorch version. Tensors: ``a @ b`` in f32, cast to
    ``out_dtype`` (default a's dtype). Shard lists: for each rank r,
    ``cat(A) @ B_r`` in f32, cast; with ``wire`` (a resolved wire, see
    :func:`resolve_ag_gemm_plan`) as JAX's ``ag_gemm_device``: 'fp8' /
    'int8' replace every peer shard by its dequantized codes (rank r's
    own shard exact); 'int8-mxu' multiplies every shard's int8 codes by
    ``quantize_cols(B_r)`` with exact integer sums (in f64), then
    ``(acc · row scale) · column scale`` in f32. ``chunk_rows``: the
    scale chunk (None: ``make_wire_format``'s)."""
    if not _is_shards(a):
        _check(a, b, mesh, axis, "ag_gemm")
        return (a.float() @ b.float()).to(to_torch_dtype(out_dtype or a.dtype))
    check_shards(a, b, mesh, axis, "ag_gemm")
    out_dtype = to_torch_dtype(out_dtype or a[0].dtype)
    if wire is None:
        gathered = torch.cat(list(a), dim=0).float()
        return [(gathered @ br.float()).to(out_dtype) for br in b]
    fmt = wirelib.make_wire_format(wire, a[0].shape[0],
                                   chunk_rows=chunk_rows)
    wired = [wirelib.quantize_slab(aq, fmt) for aq in a]
    if wire == "int8-mxu":
        return ag_gemm_wired_plain(a, wired, [wirelib.quantize_cols(br)
                                              for br in b], fmt, out_dtype,
                                   mx=True)
    return ag_gemm_wired_plain(a, wired, b, fmt, out_dtype)


def ag_gemm_wired_plain(a, wired, b, fmt, out_dtype, mx=False):
    """The plain version's product from the shards' wire form: ``wired``
    holds every rank's (codes, scales) of ``fmt``. 'fp8' / 'int8': ``b``
    is the W weight shards, rank r reads its own A shard exact and its
    peers' dequantized to A's dtype. ``mx`` (int8-mxu): ``b`` is the W
    shards' ``quantize_cols`` pairs, every slab's codes multiply with
    exact integer sums (in f64), then ``(acc · row scale) · column
    scale`` in f32."""
    if mx:
        codes = torch.cat([q for q, _ in wired]).double()
        row_scale = torch.cat([s.repeat_interleave(fmt.chunk_rows)
                               for _, s in wired])[:, None]
        # exact: |acc| < 2^53
        return [((codes @ bq.double()).float() * row_scale * bs)
                .to(out_dtype) for bq, bs in b]
    peers = [wirelib.dequantize_slab(q, s, fmt, aq.dtype)
             for (q, s), aq in zip(wired, a)]
    return [(torch.cat([a[q] if q == r else peers[q] for q in range(len(a))])
             .float() @ br.float()).to(out_dtype) for r, br in enumerate(b)]


def ag_gemm(a, b, mesh=None, axis: str = "tp", *, method=None,
            out_dtype=None, wire_dtype=None, return_gathered: bool = False):
    """AllGather(A) @ B (column-parallel).

    World size 1: a (M, K), b (K, N) tensors → (M, N). Over a mesh: a a
    list of W row shards (m, K), b a list of W column shards (K, N) →
    a list of W (W·m, N) outputs, rank r's the gathered A times B_r.
    A and B both bf16 or both f32 on the card; ``out_dtype`` (default
    A's dtype) f32 or bf16. ``method``: an :class:`AGGemmMethod` or None
    (JAX's heuristic); ``wire_dtype``: None / 'bf16', 'fp8', 'int8',
    'int8-mxu' (see the module docstring and :func:`resolve_ag_gemm_plan`).
    On CPU tensors this is :func:`ag_gemm_plain`; on CUDA tensors it
    launches the kernel or raises.

    ``return_gathered`` (JAX ``:1142``; the overlap ops' backward) also
    returns the gathered A: at world size 1, ``a`` itself; over a mesh, a
    list of W (W·m, K) tensors, rank r's copy. On the raw wire every copy
    is ``cat(A)``, which on the card ``tdt_all_gather`` writes (a launch
    of its own: the mesh GEMM reads its peers' rows in place and keeps no
    gathered copy); on 'fp8' / 'int8' rank r's copy holds its own shard
    exact and its peers' dequantized at the plan's chunk, as JAX's fused
    engines' (``:548-570``; on the card from the wire kernels' codes, in
    torch ops)."""
    if not _is_shards(a):
        _check(a, b, mesh, axis, "ag_gemm")
        resolve_ag_gemm_wire(mesh, axis, a, b, wire_dtype=wire_dtype)
        if a.device.type == "cpu":
            out = ag_gemm_plain(a, b, out_dtype=out_dtype)
        else:
            out = _ag_gemm_cuda(a, b, out_dtype)
        return (out, a) if return_gathered else out
    n = check_shards(a, b, mesh, axis, "ag_gemm")
    if a[0].shape[1] != b[0].shape[0]:
        raise ValueError(f"ag_gemm: contract dim mismatch "
                         f"{tuple(a[0].shape)} @ {tuple(b[0].shape)}")
    plan = resolve_ag_gemm_plan(mesh, axis, a, b, method=method,
                                wire_dtype=wire_dtype)
    cpu = a[0].device.type == "cpu"
    if cpu:
        out = ag_gemm_plain(a, b, mesh, axis, out_dtype=out_dtype,
                            wire=plan.wire, chunk_rows=plan.chunk_rows)
    elif plan.wire == "int8-mxu":
        out, wired = _ag_gemm_mx_cuda(a, b, mesh, out_dtype, plan.chunk_rows,
                                      keep_codes=True)
    elif plan.wire is not None:
        out, wired = _ag_gemm_w_cuda(a, b, mesh, out_dtype, plan.wire,
                                     keep_codes=True)
    else:
        out = _ag_gemm_mesh_cuda(a, b, mesh, n, out_dtype)
    if not return_gathered:
        return out
    if plan.wire is None:
        if cpu:
            return out, [torch.cat(list(a))] * n
        from triton_distributed_tpu_torch.kernels.allgather import (
            _all_gather_cuda,
        )

        return out, _all_gather_cuda(list(a), mesh, n)
    fmt = wirelib.make_wire_format(plan.wire, a[0].shape[0],
                                   chunk_rows=plan.chunk_rows)
    if cpu:
        wired = [wirelib.quantize_slab(aq, fmt) for aq in a]
    else:
        wired = list(zip(*wired))
    peers = [(q.float().reshape(fmt.chunks(q.shape[0]), -1)
              * s[:, None]).reshape(q.shape).to(aq.dtype)
             for (q, s), aq in zip(wired, a)]
    return out, [torch.cat([a[q] if q == r else peers[q] for q in range(n)])
                 for r in range(n)]


def _ag_gemm_cuda(a, b, out_dtype):
    return launch_n1_gemm(_ag_gemm_cuda, "tdt_ag_gemm", a, b, out_dtype)


def check_mesh_operands(entry, a, b, out_dtype, need_b=True):
    """The dtype and layout checks of the mesh GEMM kernels; returns
    (out_dtype, aligned: every shard on a 16-byte boundary)."""
    dtype = a[0].dtype
    out_dtype = to_torch_dtype(out_dtype or dtype)
    if dtype not in _DT_CODE or (need_b and b[0].dtype != dtype):
        raise ValueError(f"{entry} takes A and B both f32 or both bf16, got "
                         f"{dtype} and {b[0].dtype}")
    if out_dtype not in _DT_CODE:
        raise ValueError(f"{entry}: out_dtype must be f32 or bf16, got "
                         f"{out_dtype}")
    if any(not s.is_contiguous() for s in (*a, *b)):
        raise ValueError(f"{entry}'s kernel needs contiguous shards")
    return out_dtype, all(s.data_ptr() % 16 == 0 for s in (*a, *b))


def launch_mesh_gemm(fn, entry, a, b, m, out_rows, out_dtype, mesh=None):
    """Launch ``tdt_ag_gemm`` or ``tdt_gemm_rs`` (``m``: rows of an A
    shard, or of an output shard) over the W = ``len(a)`` ranks (one
    launch, ``blockIdx.z`` the rank) into fresh ``(out_rows, N)`` outputs,
    symmetric over ``mesh`` (None: one plain tensor, world size 1); returns
    them. On the warpgroup GEMM where :func:`wgmma_form` holds, else on the
    tile loops; counted in ``fn.launches`` and by the form its C entry
    reports in ``fn.by_variant``."""
    from triton_distributed_tpu_torch.kernels import _build
    from triton_distributed_tpu_torch.lang.shmem import peer_table, symm_empty

    out_dtype, aligned = check_mesh_operands(entry, a, b, out_dtype)
    n, k, cols, dev = len(a), a[0].shape[1], b[0].shape[1], a[0].device
    out = ([torch.empty((out_rows, cols), dtype=out_dtype, device=dev)]
           if mesh is None else symm_empty(mesh, (out_rows, cols), out_dtype))
    shards = out if mesh is None else out.shards
    wg = wgmma_form(m, k, cols, n, a[0].dtype, out_dtype, [*a, *b, *shards])
    # the tile loops read the device tables (the last one the one expert's
    # 0), the warpgroup GEMM's maps the host pointers; all stay referenced
    # until the launch
    # is enqueued: a table freed earlier could be handed to the next
    # allocation on the stream and rewritten before the kernel reads it
    tables = [] if wg else [peer_table(t) for t in (a, b, out)] + [
        torch.zeros((1,), dtype=torch.int32, device=dev)]
    hosts = [_build.ptr_array(t) for t in (a, b, shards)]
    form = ctypes.c_int(-1)
    f = _build.function(entry, "p" * 7 + "i" * 10 + "pp")
    rc = f(*([None] * 4 if wg else map(_build.ptr, tables)), *hosts,
           m, k, cols, n, 0, n, _DT_CODE[a[0].dtype], _DT_CODE[out_dtype],
           int(aligned), int(wg), ctypes.byref(form), _build.stream(dev))
    _build.check(rc, entry)
    fn.launches += 1
    count_form(fn, form.value)
    return shards


def launch_n1_gemm(fn, entry, a, b, out_dtype):
    """The world-size-1 AG-GEMM or GEMM-RS, a (M, K) @ b (K, N): ``entry``
    (``tdt_ag_gemm`` / ``tdt_gemm_rs``) on a one-rank table, on the
    warpgroup GEMM where :func:`wgmma_form` holds (bf16), else on the tile
    loops (f32 on FMA); counted in ``fn.launches`` and by form."""
    a, b = a.contiguous(), b.contiguous()
    return launch_mesh_gemm(fn, entry, [a], [b], a.shape[0], a.shape[0],
                            out_dtype)[0]


def _ag_gemm_mesh_cuda(a, b, mesh, n, out_dtype):
    m = a[0].shape[0]
    return launch_mesh_gemm(_ag_gemm_mesh_cuda, "tdt_ag_gemm", a, b, m,
                            n * m, out_dtype, mesh)


def wgmma_form(m, k, n, world, dtype, out_dtype, tensors,
               codes=False) -> bool:
    """Whether an AG-GEMM, GEMM-RS (either over a mesh or at world size 1),
    wire AG-GEMM (``codes``: its wire codes among ``tensors``) or GEMM-RS
    partials launch takes the warpgroup GEMM, by ``wg_form_ok``'s rule
    (``csrc/wg_gemm.cuh``, which refuses a ``wgmma`` launch that breaks
    it): bf16 A and B, a bf16 or f32 output, ``m`` (the rows of a shard, or
    of one destination's block) at least 1 and, with codes, a multiple of
    :data:`WG_TILE_ROWS` (the wire's tile lies in one shard; the other
    sources tile each shard on its own), ``k`` and ``n`` multiples of 8
    (``k`` of 16 with codes: TMA's rows are whole 16-byte pieces), at most
    :data:`WG_MAX_RANKS` ranks (``world``), and every tensor of
    ``tensors`` (the A and B shards, the outputs, the codes) on a 16-byte
    boundary."""
    return (dtype == torch.bfloat16
            and out_dtype in (torch.bfloat16, torch.float32)
            and 1 <= world <= WG_MAX_RANKS and m > 0
            and (not codes or m % WG_TILE_ROWS == 0)
            and k > 0 and k % (16 if codes else 8) == 0 and n % 8 == 0
            and all(t.data_ptr() % 16 == 0 for t in tensors))


def grouped_wgmma_form(cap_s, block_m, k, n, world, dtype, out_dtype,
                       tensors, codes=False) -> bool:
    """Whether a MoE-TP grouped GEMM launch takes the grouped warpgroup
    GEMM: the bf16 AG and RS over a mesh (``tdt_ag_group_gemm_mesh``,
    ``tdt_moe_reduce_rs_mesh``) and at world size 1 (``tdt_ag_group_gemm``,
    ``tdt_moe_reduce_rs``: ``world`` 1, ``cap_s`` the sorted rows), and
    the wire's (``tdt_ag_group_gemm_w``, with ``codes``: its wire codes
    among ``tensors``; ``tdt_moe_reduce_rs_partials``), by
    ``wg_grouped_form_ok``'s rule (``csrc/wg_gemm.cuh``, which refuses a
    ``wgmma`` launch that breaks it): bf16 A and weights, a bf16 or f32
    output, ``cap_s`` (a shard's sorted rows) and ``block_m`` (a routing
    block's) multiples of :data:`WG_TILE_ROWS` with ``cap_s`` a multiple of
    ``block_m`` (a tile lies in one shard and one block, so one expert),
    ``k`` and ``n`` multiples of 8 (``k`` of 16 with codes), at most
    :data:`WG_MAX_RANKS` ranks (``world``), and every tensor of
    ``tensors`` (the A rows or token shards, the weights, the outputs, the
    codes) on a 16-byte boundary."""
    return (dtype == torch.bfloat16
            and out_dtype in (torch.bfloat16, torch.float32)
            and 1 <= world <= WG_MAX_RANKS
            and cap_s > 0 and cap_s % WG_TILE_ROWS == 0
            and block_m > 0 and block_m % WG_TILE_ROWS == 0
            and cap_s % block_m == 0
            and k > 0 and k % (16 if codes else 8) == 0
            and n > 0 and n % 8 == 0
            and all(t.data_ptr() % 16 == 0 for t in tensors))


def count_form(fn, code: int) -> None:
    """Tally a launch of ``fn``'s entry by the form it reported
    (:data:`MESH_GEMM_FORMS`) in ``fn.by_variant``."""
    name = MESH_GEMM_FORMS[code]
    fn.by_variant[name] = fn.by_variant.get(name, 0) + 1


def _ag_gemm_w_cuda(a, b, mesh, out_dtype, wire, keep_codes=False):
    """The fp8 / int8 wire: every shard quantized (:func:`~triton_
    distributed_tpu_torch.kernels.wire.quantize_shards`), then
    :func:`ag_gemm_w_launch`; ``keep_codes``: also the (codes, scales)."""
    fmt = wirelib.make_wire_format(wire, a[0].shape[0])
    q, s = quantize_shards(a, fmt)
    out = ag_gemm_w_launch(a, q, s, b, mesh, fmt, out_dtype)
    return (out, (q, s)) if keep_codes else out


def ag_gemm_w_launch(a, q, s, b, mesh, fmt, out_dtype):
    """``tdt_ag_gemm_w`` for every rank in one launch: the A shards
    ``a`` with their wire form q (W, m, K) codes and s (W, m /
    chunk_rows) scales, the weight shards ``b`` → the W (W·m, N)
    outputs. On the warpgroup GEMM where :func:`wgmma_form` holds, else
    on the tile loops; counted by the form it ran in ``by_variant``."""
    from triton_distributed_tpu_torch.kernels import _build
    from triton_distributed_tpu_torch.lang.shmem import peer_table, symm_empty

    out_dtype, aligned = check_mesh_operands("tdt_ag_gemm_w", a, b,
                                             out_dtype)
    n, (m, k), cols = len(a), a[0].shape, b[0].shape[1]
    dev = mesh.device
    out = symm_empty(mesh, (n * m, cols), out_dtype)
    wg = wgmma_form(m, k, cols, n, a[0].dtype, out_dtype,
                    [*a, *b, *out.shards, q], codes=True)
    # the tile loops read the device tables; the warpgroup GEMM's maps
    # take the host pointers. Both stay referenced until the launch is
    # enqueued
    zero = None if wg else torch.zeros((1,), dtype=torch.int32, device=dev)
    a_peers, b_peers = (None, None) if wg else (peer_table(a), peer_table(b))
    hosts = [_build.ptr_array(t) for t in (a, b, out.shards)]
    form = ctypes.c_int(-1)
    fn = _build.function("tdt_ag_gemm_w", "p" * 9 + "i" * 12 + "pp")
    rc = fn(None if wg else _build.ptr(a_peers), _build.ptr(q),
            _build.ptr(s), None if wg else _build.ptr(b_peers),
            _build.ptr(out.peers), None if wg else _build.ptr(zero), *hosts,
            m, k, cols, n, 0, n, fmt.chunk_rows, WIRE_CODE[fmt.quant],
            _DT_CODE[a[0].dtype], _DT_CODE[out_dtype], int(aligned), int(wg),
            ctypes.byref(form), _build.stream(dev))
    _build.check(rc, "tdt_ag_gemm_w")
    ag_gemm_w_launch.launches += 1
    count_form(ag_gemm_w_launch, form.value)
    return out.shards


def quantize_cols_shards(b):
    """``quantize_cols`` of every rank's (K, N) weight shard → ((W, N, K)
    int8 codes, transposed, (W, N) f32 scales): the int8-mxu kernel's
    stacked operands (its tiles load B k-contiguous). Torch ops, as JAX
    quantizes B on the XLA side; they run on every int8-mxu call."""
    from triton_distributed_tpu_torch.lang.shmem import stacked

    bst = stacked(b)
    q, s = wirelib.quantize_cols(torch.stack(list(b)) if bst is None else bst)
    return q.transpose(1, 2).contiguous(), s.squeeze(1)


def ag_gemm_mx_launch(q, s, bqt, bs, mesh, chunk_rows, out_dtype):
    """``tdt_ag_gemm_mx`` for every rank in one launch: q (W, m, K) int8
    codes of every shard with s (W, m / chunk_rows) scales, bqt (W, N, K)
    int8 weights (transposed) with bs (W, N) column scales → the W
    (W·m, N) outputs."""
    from triton_distributed_tpu_torch.kernels import _build
    from triton_distributed_tpu_torch.lang.shmem import symm_empty

    n, m, k = q.shape
    out = symm_empty(mesh, (n * m, bqt.shape[1]), out_dtype)
    fn = _build.function("tdt_ag_gemm_mx", "ppppp" + "i" * 8 + "p")
    rc = fn(_build.ptr(q), _build.ptr(s), _build.ptr(bqt), _build.ptr(bs),
            _build.ptr(out.peers), m, k, bqt.shape[1], n, 0, n, chunk_rows,
            _DT_CODE[out_dtype], _build.stream(mesh.device))
    _build.check(rc, "tdt_ag_gemm_mx")
    ag_gemm_mx_launch.launches += 1
    return out.shards


def _ag_gemm_mx_cuda(a, b, mesh, out_dtype, chunk_rows, keep_codes=False):
    """The int8-mxu wire: every shard quantized at ``chunk_rows``
    (``quantize_shards``), B per column (:func:`quantize_cols_shards`),
    then :func:`ag_gemm_mx_launch`; ``keep_codes``: also A's (codes,
    scales)."""
    out_dtype, _ = check_mesh_operands("tdt_ag_gemm_mx", a, b, out_dtype,
                                       need_b=False)
    fmt = wirelib.make_wire_format("int8-mxu", a[0].shape[0],
                                   chunk_rows=chunk_rows)
    q, s = quantize_shards(a, fmt)
    bqt, bs = quantize_cols_shards(b)
    out = ag_gemm_mx_launch(q, s, bqt, bs, mesh, fmt.chunk_rows, out_dtype)
    return (out, (q, s)) if keep_codes else out


#: launch counts of the kernels (plain ints on the wrappers): the world-
#: size-1 GEMM, the kernel over a mesh, and its two quantized wires (the
#: wire quantizer counts its own launches); the first three also by form
_ag_gemm_cuda.launches = 0
_ag_gemm_cuda.by_variant = {}
_ag_gemm_mesh_cuda.launches = 0
_ag_gemm_mesh_cuda.by_variant = {}
ag_gemm_w_launch.launches = 0
ag_gemm_w_launch.by_variant = {}
ag_gemm_mx_launch.launches = 0
