"""The MoE tensor-parallel GEMMs: AG + grouped GEMM, grouped GEMM + RS.

Port of ``triton_distributed_tpu/kernels/moe_tp_fused.py``. Its two
engines stream per-shard expert-sorted slabs around a ring:
``ag_group_gemm_kernel`` (``:172``) gathers the slabs and feeds each
arrival to a grouped GEMM, ``moe_reduce_rs_kernel`` (``:285``) computes
each destination's partial into a reduce ring. With one rank both rings
reduce to their compute (``kernels/ring.py:141-145``, ``:269-271``): one
grouped GEMM each. Over a loopback mesh (:func:`ag_group_gemm_mesh`,
:func:`moe_reduce_rs_mesh`) each ring becomes a pull through the peer
tables of :mod:`~triton_distributed_tpu_torch.lang.shmem`, one launch
for every rank (``csrc/moe_tp_fused.cu``).

* :func:`ag_group_gemm`: x (M, K) tokens, the sorted token ids ``sti``
  (cap,) and the block→expert table ``be`` (cap / block_m,) of
  ``moe_utils.moe_align_block_size``, w (E, K, N) → (cap, N) rows in
  expert-sorted order, zeros at the padding. The CUDA kernel
  (``tdt_ag_group_gemm``) loads each A row straight from x: the sorted
  slab the TPU kernel consumes is never materialized.
* :func:`moe_reduce_rs`: y (cap, F) sorted rows, be, w (E, F, H) →
  (cap, H), the slab the TPU kernel writes before the top-k combine
  (``tdt_moe_reduce_rs``).

* :func:`ag_group_gemm_mesh`: W row shards x_s (M_s, K), the shards'
  tables stacked (sti (W, cap_s), be (W, cap_s / block_m)) and W column
  shards w_r (E, K, N_r) → W outputs (W·cap_s, N_r): rank r's rows of
  shard s are x_s's sorted rows times w_r (``tdt_ag_group_gemm_mesh``).
* :func:`moe_reduce_rs_mesh`: W shards y_q (W·cap_s, F_q), the stacked
  be, W row shards w_q (E, F_q, H) → W outputs (cap_s, H): rank r's is
  Σ_q y_q[r·cap_s : (r+1)·cap_s] @ w_q[be[r, ·]], summed in f32 and
  rounded once (``tdt_moe_reduce_rs_mesh``; the TPU's ring rounds each
  hop in the compute type).

All take bf16 (tensor cores) or f32 (FMA) operands, sum in f32 and
store to ``out_dtype``. On a CPU tensor each runs its ``*_plain``
version; on a CUDA tensor it launches the kernel or raises. In bf16,
where :func:`~triton_distributed_tpu_torch.kernels.ag_gemm.
grouped_wgmma_form` holds (``block_m`` and ``cap_s`` multiples of 128:
the prefill's shapes), the four run the grouped warpgroup GEMM of
``csrc/wg_gemm.cuh`` (``wg_grouped_kernel``): the AGs gather each tile's
sorted rows from the tokens in its producer warpgroup (``cp.async``
into the swizzled stage; no slab is written), the RSs read their rows
in place by TMA, over (rank, K step) at the mesh; world size 1 is the
same source on a one-rank table. Elsewhere (f32, 64-row blocks) they
run the tile loops of ``csrc/ggemm_tiles.cuh``. Each tallies its
launches by the form its C entry reports, in ``by_variant``
(``MESH_GEMM_FORMS``).

**Quantized wires** (JAX ``ag_group_gemm_kernel_w`` ``:208``,
``ag_group_gemm_kernel_mx`` ``:243``, ``moe_reduce_rs_kernel_w``
``:322``; the format :func:`_wire_fmt`, ``:356-375``). The AG side ships
each shard's materialized sorted slab (:func:`quantize_sorted`: the
gather, padding rows zero, then every shard quantized in one launch of
``tdt_quantize_slab``):

* :func:`ag_group_gemm_mesh_w` (fp8 / int8): rank r reads its own
  shard's rows exact and a peer's as its codes times the chunk scale,
  rounded to x's dtype (``tdt_ag_group_gemm_w``);
* :func:`ag_group_gemm_mesh_mx` (int8-mxu, and :func:`ag_group_gemm_mx`
  at one rank): every slab's codes, the own one too, chunked a routing
  block each, against the rank's per-(expert, column) int8 weights
  (:func:`quantize_expert_shards`), s32 sums, ``acc · (row scale ·
  column scale)`` in f32 (``tdt_ag_group_gemm_mx``);
* :func:`moe_reduce_rs_mesh_w` (fp8 / int8, and int8-mxu's int8
  payload): every rank's partial slabs (``tdt_moe_reduce_rs_partials``,
  each rounded once to the output type), then the reduce ring's
  requantizing hops replayed by the GEMM-RS wire's fold
  (``tdt_gemm_rs_fold``, counted apart: :func:`moe_reduce_rs_fold`).

``tdt_ag_group_gemm_w`` and ``tdt_moe_reduce_rs_partials`` run the
grouped warpgroup GEMM of ``csrc/wg_gemm.cuh`` (``wgmma`` fed by TMA, the
weight a 3-D tensor map looked up by the tile's expert, a persistent grid
whose TMA stores overlap the next tile's products) where
:func:`~triton_distributed_tpu_torch.kernels.ag_gemm.grouped_wgmma_form`
holds: bf16, ``block_m`` and ``cap_s`` multiples of 128, the wire path's
shapes. There the AG reads its own rows from the sorted slabs that
:func:`quantize_sorted` materialized (``slabs``) and skips the K loop of
an all-padding tile. Elsewhere they run the tile loops of
``csrc/ggemm_tiles.cuh``. Each wrapper tallies its launches by the form
its C entry reports, in ``by_variant`` (``MESH_GEMM_FORMS``).
"""

from __future__ import annotations

import ctypes

import torch

from triton_distributed_tpu_torch.config import to_torch_dtype
from triton_distributed_tpu_torch.kernels.ag_gemm import (
    count_form,
    grouped_wgmma_form,
)
from triton_distributed_tpu_torch.kernels.group_gemm import (
    _DT_CODE,
    KERNEL_BM,
    _check_args,
    _cuda_common,
    grouped_matmul_plain,
)
from triton_distributed_tpu_torch.kernels.gemm_rs import (
    gemm_rs_fold_plain,
    launch_fold,
)
from triton_distributed_tpu_torch.kernels.group_gemm import (
    quantize_grouped_weights,
)
from triton_distributed_tpu_torch.kernels.moe_utils import gather_sorted
from triton_distributed_tpu_torch.kernels.wire import WIRE_CODE, quantize_shards
from triton_distributed_tpu_torch.lang import wire as wirelib
from triton_distributed_tpu_torch.lang.shmem import (
    peer_table,
    stacked,
    symm_empty,
)
from triton_distributed_tpu_torch.runtime.topology import Mesh, one_axis


def pick_gg_blocks(block_m: int, cap: int):
    """The grouped GEMMs' M-block: the routing ``block_m`` (one expert
    per block is the grouped-GEMM contract), or None when ``cap`` rows
    do not split into whole blocks (JAX ``pick_gg_blocks``, ``:55-74``;
    its VMEM blocking of K and N has no counterpart here)."""
    if block_m <= 0 or cap % block_m:
        return None
    return block_m


def _check(x, be, w):
    """ag_group_gemm's operands (x is (M, K) tokens, not sorted rows)."""
    if x.dim() != 2 or w.dim() != 3 or w.shape[1] != x.shape[1]:
        raise ValueError(f"ag_group_gemm: contract dim mismatch "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    if x.dtype not in _DT_CODE or w.dtype != x.dtype:
        raise ValueError(f"ag_group_gemm takes operands both f32 or both "
                         f"bf16, got {x.dtype} and {w.dtype}")
    if be.dim() != 1 or be.shape[0] < 1:
        raise ValueError("ag_group_gemm: block_expert must be a non-empty "
                         "vector")


def ag_group_gemm_plain(x, sti, be, w, topk: int, *, out_dtype=None):
    """Plain PyTorch version of :func:`ag_group_gemm`: the sorted slab
    (``gather_sorted``), then the grouped GEMM's plain version."""
    _check(x, be, w)
    return grouped_matmul_plain(gather_sorted(x, sti, topk), w, be,
                                out_dtype=out_dtype)


def ag_group_gemm(x, sti, be, w, topk: int, *, out_dtype=None):
    """(cap, N) = gather_sorted(x, sti, topk) @ w[be[block]]: x (M, K),
    sti (cap,) int32 with the sentinel M·topk at padding, be (cap /
    block_m,) int32, w (E, K, N) in x's dtype; ``out_dtype`` defaults to
    x's dtype."""
    if x.device.type == "cpu":
        return ag_group_gemm_plain(x, sti, be, w, topk, out_dtype=out_dtype)
    return _ag_group_gemm_cuda(x, sti, be, w, topk, out_dtype)


def moe_reduce_rs_plain(y, be, w, *, out_dtype=None):
    """Plain PyTorch version of :func:`moe_reduce_rs`: the grouped GEMM's
    plain version."""
    return grouped_matmul_plain(y, w, be, out_dtype=out_dtype)


def moe_reduce_rs(y, be, w, *, out_dtype=None):
    """(cap, H) = y @ w[be[block]]: y (cap, F) sorted rows, be (cap /
    block_m,) int32, w (E, F, H) in y's dtype; ``out_dtype`` defaults to
    y's dtype. At world size 1 the reduce over ranks is this one
    partial."""
    if y.device.type == "cpu":
        return moe_reduce_rs_plain(y, be, w, out_dtype=out_dtype)
    return _moe_reduce_rs_cuda(y, be, w, out_dtype)


def _out_dtype(out_dtype, a, what):
    out_dtype = to_torch_dtype(out_dtype or a.dtype)
    if out_dtype not in _DT_CODE:
        raise ValueError(f"{what}: out_dtype must be f32 or bf16, got "
                         f"{out_dtype}")
    return out_dtype


def _ag_group_gemm_cuda(x, sti, be, w, topk, out_dtype):
    from triton_distributed_tpu_torch.kernels import _build

    _check(x, be, w)
    if sti.dim() != 1 or sti.dtype != torch.int32:
        raise ValueError("ag_group_gemm: sti must be an int32 vector")
    cap, (m, k), (e, _, n) = sti.shape[0], x.shape, w.shape
    if cap % be.shape[0]:
        raise ValueError(f"ag_group_gemm: {cap} rows do not split into "
                         f"{be.shape[0]} equal M-blocks")
    block_m = cap // be.shape[0]
    dev = _cuda_common((x, w, sti), be, cap, block_m)
    out_dtype = _out_dtype(out_dtype, x, "ag_group_gemm")
    out = torch.empty((cap, n), dtype=out_dtype, device=dev)
    wg = grouped_wgmma_form(cap, block_m, k, n, 1, x.dtype, out_dtype,
                            [x, w, out])
    form = ctypes.c_int(-1)
    fn = _build.function("tdt_ag_group_gemm", "ppppp" + "i" * 10 + "pp")
    rc = fn(_build.ptr(x), _build.ptr(sti), _build.ptr(w), _build.ptr(be),
            _build.ptr(out), m, topk, cap, k, n, e, block_m,
            _DT_CODE[x.dtype], _DT_CODE[out_dtype], int(wg),
            ctypes.byref(form), _build.stream(dev))
    _build.check(rc, "tdt_ag_group_gemm")
    _ag_group_gemm_cuda.launches += 1
    count_form(_ag_group_gemm_cuda, form.value)
    return out


def _moe_reduce_rs_cuda(y, be, w, out_dtype):
    from triton_distributed_tpu_torch.kernels import _build

    cap, f, e, h, block_m = _check_args(y, w, be, None, None)
    dev = _cuda_common((y, w), be, cap, block_m)
    out_dtype = _out_dtype(out_dtype, y, "moe_reduce_rs")
    out = torch.empty((cap, h), dtype=out_dtype, device=dev)
    wg = grouped_wgmma_form(cap, block_m, f, h, 1, y.dtype, out_dtype,
                            [y, w, out])
    form = ctypes.c_int(-1)
    fn = _build.function("tdt_moe_reduce_rs", "pppp" + "i" * 8 + "pp")
    rc = fn(_build.ptr(y), _build.ptr(w), _build.ptr(be), _build.ptr(out),
            cap, f, h, e, block_m, _DT_CODE[y.dtype], _DT_CODE[out_dtype],
            int(wg), ctypes.byref(form), _build.stream(dev))
    _build.check(rc, "tdt_moe_reduce_rs")
    _moe_reduce_rs_cuda.launches += 1
    count_form(_moe_reduce_rs_cuda, form.value)
    return out


# ------------------------------------------------------------ over a mesh

def _check_mesh(x, sti, be, w, mesh, axis, what):
    """W same-shaped 2-D shards ``x`` and 3-D shards ``w`` on the mesh's
    device, the shards' stacked int32 tables; returns (W, cap_s,
    block_m)."""
    n = one_axis(mesh, axis)
    if not (isinstance(x, (list, tuple)) and isinstance(w, (list, tuple))
            and len(x) == n and len(w) == n):
        raise ValueError(f"{what}: x and w must be lists of {n} per-rank "
                         f"shards (the {axis!r} axis)")
    for shards, nd, name in ((x, 2, "x"), (w, 3, "w")):
        s0 = shards[0]
        for s in shards:
            if s.dim() != nd or s.shape != s0.shape or s.dtype != s0.dtype:
                raise ValueError(f"{what}: the {name} shards must be {nd}-D "
                                 "of one shape and dtype")
            if s.device != mesh.device:
                raise ValueError(f"{what}: {name} shard on {s.device}, the "
                                 f"mesh is on {mesh.device}")
    if x[0].dtype not in _DT_CODE or w[0].dtype != x[0].dtype:
        raise ValueError(f"{what} takes operands both f32 or both bf16, got "
                         f"{x[0].dtype} and {w[0].dtype}")
    if w[0].shape[1] != x[0].shape[1]:
        raise ValueError(f"{what}: contract dim mismatch {tuple(x[0].shape)}"
                         f" @ {tuple(w[0].shape)}")
    for t, name in ((sti, "sti"), (be, "block_expert")):
        if t is not None and (t.dtype != torch.int32 or t.dim() != 2
                              or t.shape[0] != n):
            raise ValueError(f"{what}: {name} must be the {n} shards' int32 "
                             "tables stacked")
    nb = be.shape[1]
    cap_s = sti.shape[1] if sti is not None else x[0].shape[0] // n
    if sti is None and x[0].shape[0] != n * cap_s:
        raise ValueError(f"{what}: {x[0].shape[0]} rows a rank are not "
                         f"{n} shards' sorted rows")
    if nb < 1 or cap_s % nb:
        raise ValueError(f"{what}: {cap_s} rows a shard do not split into "
                         f"{nb} equal M-blocks")
    return n, cap_s, cap_s // nb


def ag_group_gemm_mesh_plain(x, sti, be, w, topk: int, mesh, axis="tp", *,
                             out_dtype=None):
    """Plain PyTorch version of :func:`ag_group_gemm_mesh`: every shard's
    sorted slab (``gather_sorted``), stacked, then the grouped GEMM's
    plain version against each rank's columns."""
    n, _, _ = _check_mesh(x, sti, be, w, mesh, axis, "ag_group_gemm_mesh")
    out_dtype = to_torch_dtype(out_dtype or x[0].dtype)
    slab = torch.cat([gather_sorted(x[s], sti[s], topk) for s in range(n)])
    be_all = be.reshape(-1)
    out = symm_empty(mesh, (slab.shape[0], w[0].shape[2]), out_dtype)
    for o, wr in zip(out.shards, w):
        o.copy_(grouped_matmul_plain(slab, wr, be_all, out_dtype=out_dtype))
    return out.shards


def ag_group_gemm_mesh(x, sti, be, w, topk: int, mesh, axis="tp", *,
                       out_dtype=None):
    """AllGather ⊕ grouped GEMM over ``mesh``'s ``axis`` (W ranks): x a
    list of W row shards (M_s, K), sti (W, cap_s) and be (W, cap_s /
    block_m) int32 the shards' routing tables (the sentinel M_s·topk at
    padding), w a list of W (E, K, N_r) column shards → a list of W
    (W·cap_s, N_r) outputs, views of one allocation: rank r's row s·cap_s
    + i is token sti[s, i] // topk of x_s (zeros at the sentinel) times
    w_r[be[s, i // block_m]]."""
    if x[0].device.type == "cpu":
        return ag_group_gemm_mesh_plain(x, sti, be, w, topk, mesh, axis,
                                        out_dtype=out_dtype)
    return _ag_group_gemm_mesh_cuda(x, sti, be, w, topk, mesh, axis,
                                    out_dtype)


def moe_reduce_rs_mesh_plain(y, be, w, mesh, axis="tp", *, out_dtype=None):
    """Plain PyTorch version of :func:`moe_reduce_rs_mesh`: each rank's
    per-rank grouped GEMMs in f32, summed over the ranks, rounded
    once."""
    n, cap_s, _ = _check_mesh(y, None, be, w, mesh, axis,
                              "moe_reduce_rs_mesh")
    out_dtype = to_torch_dtype(out_dtype or y[0].dtype)
    out = symm_empty(mesh, (cap_s, w[0].shape[2]), out_dtype)
    for r, o in enumerate(out.shards):
        rows = slice(r * cap_s, (r + 1) * cap_s)
        acc = sum(grouped_matmul_plain(yq[rows], wq, be[r],
                                       out_dtype=torch.float32)
                  for yq, wq in zip(y, w))
        o.copy_(acc.to(out_dtype))
    return out.shards


def moe_reduce_rs_mesh(y, be, w, mesh, axis="tp", *, out_dtype=None):
    """Grouped GEMM ⊕ reduce-scatter over ``mesh``'s ``axis`` (W ranks):
    y a list of W (W·cap_s, F_q) shards (every shard's sorted rows
    against rank q's F columns), be (W, cap_s / block_m) int32 the
    shards' block tables, w a list of W (E, F_q, H) row shards → a list
    of W (cap_s, H) outputs, views of one allocation: rank r's is
    Σ_q y_q[r·cap_s : (r+1)·cap_s] @ w_q[be[r, ·]], f32 sums rounded
    once to ``out_dtype``."""
    if y[0].device.type == "cpu":
        return moe_reduce_rs_mesh_plain(y, be, w, mesh, axis,
                                        out_dtype=out_dtype)
    return _moe_reduce_rs_mesh_cuda(y, be, w, mesh, axis, out_dtype)


def _mesh_launch_common(x, w, tables, be, block_m, what):
    """The CUDA checks of the mesh forms; returns (device, aligned)."""
    dev = x[0].device
    if any(not s.is_contiguous() for s in (*x, *w, *tables)):
        raise ValueError(f"{what}'s kernel needs contiguous tensors")
    if be.shape[1] > 1 and block_m % KERNEL_BM:
        raise ValueError(f"{what}: block_m={block_m} must be a multiple of "
                         f"{KERNEL_BM} when there is more than one M-block")
    for t in tables:
        if t.device != dev:
            raise ValueError(f"{what}: table on {t.device}, expected {dev}")
    return dev, all(s.data_ptr() % 16 == 0 for s in (*x, *w))


def _ag_group_gemm_mesh_cuda(x, sti, be, w, topk, mesh, axis, out_dtype):
    from triton_distributed_tpu_torch.kernels import _build

    n, cap_s, block_m = _check_mesh(x, sti, be, w, mesh, axis,
                                    "ag_group_gemm_mesh")
    dev, aligned = _mesh_launch_common(x, w, (sti, be), be, block_m,
                                       "ag_group_gemm_mesh")
    out_dtype = _out_dtype(out_dtype, x[0], "ag_group_gemm_mesh")
    k, (e, _, nn) = x[0].shape[1], w[0].shape
    out = symm_empty(mesh, (n * cap_s, nn), out_dtype)
    wg = grouped_wgmma_form(cap_s, block_m, k, nn, n, x[0].dtype, out_dtype,
                            [*x, *w, *out.shards])
    # the tile loops read the device tables, the grouped warpgroup GEMM the
    # host pointers; all stay referenced until the launch is enqueued: one
    # freed earlier could be handed to the next allocation on the stream
    # and rewritten before the kernel reads it
    x_peers, w_peers = (None, None) if wg else (peer_table(x), peer_table(w))
    hosts = [_build.ptr_array(t) for t in (x, w, out.shards)]
    form = ctypes.c_int(-1)
    fn = _build.function("tdt_ag_group_gemm_mesh", "p" * 8 + "i" * 14 + "pp")
    rc = fn(None if wg else _build.ptr(x_peers),
            None if wg else _build.ptr(w_peers),
            None if wg else _build.ptr(out.peers), _build.ptr(sti),
            _build.ptr(be), *hosts, x[0].shape[0], topk, cap_s, k, nn, e,
            block_m, n, 0, n, _DT_CODE[x[0].dtype], _DT_CODE[out_dtype],
            int(aligned), int(wg), ctypes.byref(form), _build.stream(dev))
    _build.check(rc, "tdt_ag_group_gemm_mesh")
    _ag_group_gemm_mesh_cuda.launches += 1
    count_form(_ag_group_gemm_mesh_cuda, form.value)
    return out.shards


def _moe_reduce_rs_mesh_cuda(y, be, w, mesh, axis, out_dtype):
    from triton_distributed_tpu_torch.kernels import _build

    n, cap_s, block_m = _check_mesh(y, None, be, w, mesh, axis,
                                    "moe_reduce_rs_mesh")
    dev, aligned = _mesh_launch_common(y, w, (be,), be, block_m,
                                       "moe_reduce_rs_mesh")
    out_dtype = _out_dtype(out_dtype, y[0], "moe_reduce_rs_mesh")
    f, (e, _, h) = y[0].shape[1], w[0].shape
    out = symm_empty(mesh, (cap_s, h), out_dtype)
    wg = grouped_wgmma_form(cap_s, block_m, f, h, n, y[0].dtype, out_dtype,
                            [*y, *w, *out.shards])
    y_peers, w_peers = (None, None) if wg else (peer_table(y), peer_table(w))
    hosts = [_build.ptr_array(t) for t in (y, w, out.shards)]
    form = ctypes.c_int(-1)
    fn = _build.function("tdt_moe_reduce_rs_mesh", "p" * 7 + "i" * 12 + "pp")
    rc = fn(None if wg else _build.ptr(y_peers),
            None if wg else _build.ptr(w_peers),
            None if wg else _build.ptr(out.peers), _build.ptr(be), *hosts,
            cap_s, f, h, e, block_m, n, 0, n, _DT_CODE[y[0].dtype],
            _DT_CODE[out_dtype], int(aligned), int(wg), ctypes.byref(form),
            _build.stream(dev))
    _build.check(rc, "tdt_moe_reduce_rs_mesh")
    _moe_reduce_rs_mesh_cuda.launches += 1
    count_form(_moe_reduce_rs_mesh_cuda, form.value)
    return out.shards


# ------------------------------------------------------ quantized wires

def _wire_fmt(wire, rows: int, block_m: int | None = None):
    """The wire format of a sorted slab of ``rows`` rows (JAX
    ``_wire_fmt``, ``:356-375``): None for the bf16 wire; 'fp8' / 'int8'
    at :func:`~triton_distributed_tpu_torch.lang.wire.make_wire_format`'s
    chunking; 'int8-mxu' int8 at one chunk a routing block (``block_m``
    rows), so that row block i's scale is the i-th. A slab that admits
    no legal chunking raises ``ValueError``: a pinned wire is a
    contract."""
    if wire is None:
        return None
    if wire == "int8-mxu":
        if not block_m or rows % block_m:
            raise ValueError(
                f"moe_tp wire='int8-mxu': {rows} sorted rows do not cut "
                f"into chunks of block_m={block_m}; use the bf16 wire")
        return wirelib.WireFormat(quant="int8", chunk_rows=block_m)
    fmt = wirelib.make_wire_format(wire, rows)
    if fmt is None:
        raise ValueError(f"moe_tp wire={wire!r}: slab of {rows} rows admits "
                         "no legal scale chunking; use the bf16 wire")
    return fmt


def _as_stack(shards):
    """The (W, ...) tensor of W same-shaped shards (a view where they are
    views of one allocation)."""
    st = stacked(shards)
    return torch.stack(list(shards)) if st is None else st


def quantize_sorted(x, sti, topk: int, fmt):
    """Every shard's sorted slab on the wire: x W row shards (M_s, K), sti
    (W, cap_s) their tables → ((W, cap_s, K) codes of ``fmt.wire_dtype``,
    (W, cap_s / chunk_rows) f32 scales, the (W, cap_s, K) slabs
    themselves: :func:`ag_group_gemm_mesh_w`'s ``slabs``, which a caller
    that does not need them drops). The slabs are materialized
    (``gather_sorted``, padding rows zero: JAX's XLA
    ``_build_gather_sorted``) and quantized together
    (:func:`~triton_distributed_tpu_torch.kernels.wire.quantize_shards`:
    one ``tdt_quantize_slab`` launch on the card), so a chunk of padding
    rows gets codes 0 and the scale 1e-12 / QMAX, as JAX's does."""
    slabs = gather_sorted(_as_stack(x), sti, topk)
    q, s = quantize_shards(list(slabs.unbind(0)), fmt)
    return q, s, slabs


def quantize_expert_shards(w):
    """``quantize_grouped_weights(w_r, "int8")`` of every rank's (E, K, N)
    expert shard → ((W, E, N, K) int8 codes, transposed for the s8 loop's
    B tiles, (W, E, N) f32 per-(expert, column) scales). Torch ops, run
    on every int8-mxu call, as JAX quantizes the weights inside its call
    (``ops/moe_tp.py:301``)."""
    wst = _as_stack(w)
    n, e, k, nn = wst.shape
    q, sc = quantize_grouped_weights(wst.reshape(n * e, k, nn), "int8")
    return (q.reshape(n, e, k, nn).transpose(2, 3).contiguous(),
            sc.reshape(n, e, nn))


def _check_wire(q, s, n, cap_s, k, fmt, what):
    if (q.dtype != fmt.wire_dtype or tuple(q.shape) != (n, cap_s, k)
            or s.dtype != torch.float32
            or tuple(s.shape) != (n, fmt.chunks(cap_s))):
        raise ValueError(
            f"{what}: the wire form must be ({n}, {cap_s}, {k}) "
            f"{fmt.wire_dtype} codes and ({n}, {fmt.chunks(cap_s)}) f32 "
            f"scales, got {q.dtype} {tuple(q.shape)} and {s.dtype} "
            f"{tuple(s.shape)}")


def ag_group_gemm_mesh_w_plain(x, q, s, sti, be, w, topk: int, mesh, fmt,
                               axis="tp", *, out_dtype=None):
    """Plain PyTorch version of :func:`ag_group_gemm_mesh_w`: the peers'
    slabs dequantized to x's dtype (``dequantize_slab``, as JAX's
    ``dequant_pipeline`` writes its workspace), the own slab exact
    (``gather_sorted``), stacked, then the grouped GEMM's plain version
    against each rank's columns."""
    what = "ag_group_gemm_mesh_w"
    n, cap_s, _ = _check_mesh(x, sti, be, w, mesh, axis, what)
    _check_wire(q, s, n, cap_s, x[0].shape[1], fmt, what)
    out_dtype = to_torch_dtype(out_dtype or x[0].dtype)
    peers = [wirelib.dequantize_slab(qs, ss, fmt, x[0].dtype)
             for qs, ss in zip(q, s)]
    be_all = be.reshape(-1)
    out = symm_empty(mesh, (n * cap_s, w[0].shape[2]), out_dtype)
    for r, (o, wr) in enumerate(zip(out.shards, w)):
        slab = torch.cat([gather_sorted(x[r], sti[r], topk) if t == r
                          else peers[t] for t in range(n)])
        o.copy_(grouped_matmul_plain(slab, wr, be_all, out_dtype=out_dtype))
    return out.shards


def ag_group_gemm_mesh_w(x, q, s, sti, be, w, topk: int, mesh, fmt,
                         axis="tp", *, slabs, out_dtype=None):
    """AllGather ⊕ grouped GEMM on the fp8 / int8 wire: as
    :func:`ag_group_gemm_mesh` (x, sti, be, w), with q (W, cap_s, K) and
    s (W, cap_s / chunk_rows) every shard's sorted slab on the wire
    (:func:`quantize_sorted` at ``fmt``): rank r's rows of shard s ≠ r
    are the codes times their chunk's scale, rounded to x's dtype; its
    own rows are exact. ``slabs``: the (W, cap_s, K) sorted slabs those
    codes were made from (:func:`quantize_sorted`'s third value), which
    the card's grouped warpgroup GEMM reads its own rows from (the plain
    version gathers the own rows from x)."""
    if x[0].device.type == "cpu":
        return ag_group_gemm_mesh_w_plain(x, q, s, sti, be, w, topk, mesh,
                                          fmt, axis, out_dtype=out_dtype)
    return _ag_group_gemm_w_cuda(x, q, s, sti, be, w, topk, mesh, fmt,
                                 axis, out_dtype, slabs)


def _ag_group_gemm_w_cuda(x, q, s, sti, be, w, topk, mesh, fmt, axis,
                          out_dtype, slabs):
    from triton_distributed_tpu_torch.kernels import _build

    what = "ag_group_gemm_mesh_w"
    n, cap_s, block_m = _check_mesh(x, sti, be, w, mesh, axis, what)
    k, nn = x[0].shape[1], w[0].shape[2]
    _check_wire(q, s, n, cap_s, k, fmt, what)
    dev, aligned = _mesh_launch_common(x, w, (sti, be, q, s), be, block_m,
                                       what)
    aligned = aligned and q.data_ptr() % 16 == 0
    out_dtype = _out_dtype(out_dtype, x[0], what)
    out = symm_empty(mesh, (n * cap_s, nn), out_dtype)
    if (slabs.shape != (n, cap_s, k) or slabs.dtype != x[0].dtype
            or slabs.device != dev or not slabs.is_contiguous()):
        raise ValueError(f"{what}: slabs must be the contiguous ({n}, "
                         f"{cap_s}, {k}) {x[0].dtype} sorted slabs on "
                         f"{dev}, got {tuple(slabs.shape)} {slabs.dtype}")
    wg = grouped_wgmma_form(cap_s, block_m, k, nn, n, x[0].dtype, out_dtype,
                            [*w, *out.shards, q, slabs], codes=True)
    # the tile loops read the device tables, the grouped warpgroup GEMM's
    # maps the host pointers; all stay referenced until the launch is
    # enqueued
    x_peers, w_peers = ((None, None) if wg
                        else (peer_table(x), peer_table(w)))
    hosts = [_build.ptr_array(t) for t in (w, out.shards)]
    form = ctypes.c_int(-1)
    fn = _build.function("tdt_ag_group_gemm_w", "p" * 10 + "i" * 16 + "pp")
    rc = fn(None if wg else _build.ptr(x_peers), _build.ptr(q),
            _build.ptr(s), None if wg else _build.ptr(w_peers),
            None if wg else _build.ptr(out.peers), _build.ptr(sti),
            _build.ptr(be), _build.ptr(slabs) if wg else None, *hosts,
            x[0].shape[0], topk, cap_s, k, nn, w[0].shape[0], block_m, n, 0,
            n, fmt.chunk_rows, WIRE_CODE[fmt.quant], _DT_CODE[x[0].dtype],
            _DT_CODE[out_dtype], int(aligned), int(wg), ctypes.byref(form),
            _build.stream(dev))
    _build.check(rc, "tdt_ag_group_gemm_w")
    _ag_group_gemm_w_cuda.launches += 1
    count_form(_ag_group_gemm_w_cuda, form.value)
    return out.shards


def _check_mx(q, s, be, wq, ws, mesh, axis):
    """The int8-mxu operands; returns (W, cap_s, block_m)."""
    what = "ag_group_gemm_mesh_mx"
    n = one_axis(mesh, axis)
    if (q.dtype != torch.int8 or q.dim() != 3 or q.shape[0] != n
            or wq.dtype != torch.int8 or wq.dim() != 4 or wq.shape[0] != n
            or wq.shape[3] != q.shape[2]):
        raise ValueError(f"{what}: q must be ({n}, cap_s, K) int8 codes and "
                         f"wq ({n}, E, N, K) int8, got {tuple(q.shape)} "
                         f"{q.dtype} and {tuple(wq.shape)} {wq.dtype}")
    if be.dtype != torch.int32 or be.dim() != 2 or be.shape[0] != n:
        raise ValueError(f"{what}: block_expert must be the {n} shards' "
                         "int32 tables stacked")
    cap_s, nb = q.shape[1], be.shape[1]
    if nb < 1 or cap_s % nb:
        raise ValueError(f"{what}: {cap_s} rows a shard do not split into "
                         f"{nb} equal M-blocks")
    if (s.dtype != torch.float32 or tuple(s.shape) != (n, nb)
            or ws.dtype != torch.float32
            or tuple(ws.shape) != tuple(wq.shape[:3])):
        raise ValueError(f"{what}: s must be ({n}, {nb}) f32 (one scale a "
                         f"routing block) and ws {tuple(wq.shape[:3])} f32")
    for t in (q, s, be, wq, ws):
        if t.device != mesh.device:
            raise ValueError(f"{what}: operand on {t.device}, the mesh is "
                             f"on {mesh.device}")
    return n, cap_s, cap_s // nb


def _mx_rows_plain(codes, scales, be_all, wq, ws, out_dtype):
    """codes (R, K) int8 in M-blocks of one scale and expert each
    (scales, be_all (R / block_m,)), wq (E, N, K) int8, ws (E, N) → (R,
    N): exact integer sums (int64 on the CPU, float64 on a card, exact
    below 2^53), then ``acc · (row scale · column scale)`` in f32."""
    rows = codes.shape[0]
    block_m = rows // be_all.shape[0]
    acc_t = torch.int64 if codes.device.type == "cpu" else torch.float64
    out = torch.empty((rows, wq.shape[1]), dtype=out_dtype,
                      device=codes.device)
    for b, e in enumerate(be_all.tolist()):
        blk = slice(b * block_m, (b + 1) * block_m)
        acc = codes[blk].to(acc_t) @ wq[e].to(acc_t).t()
        out[blk] = (acc.float() * (scales[b] * ws[e])[None, :]).to(out_dtype)
    return out


def ag_group_gemm_mesh_mx_plain(q, s, be, wq, ws, mesh, axis="tp", *,
                                out_dtype=torch.bfloat16):
    """Plain PyTorch version of :func:`ag_group_gemm_mesh_mx`."""
    n, cap_s, _ = _check_mx(q, s, be, wq, ws, mesh, axis)
    out_dtype = to_torch_dtype(out_dtype)
    codes, scales = q.reshape(n * cap_s, -1), s.reshape(-1)
    be_all = be.reshape(-1)
    out = symm_empty(mesh, (n * cap_s, wq.shape[2]), out_dtype)
    for r, o in enumerate(out.shards):
        o.copy_(_mx_rows_plain(codes, scales, be_all, wq[r], ws[r],
                               out_dtype))
    return out.shards


def ag_group_gemm_mesh_mx(q, s, be, wq, ws, mesh, axis="tp", *,
                          out_dtype=torch.bfloat16):
    """AllGather ⊕ grouped GEMM on the int8-mxu wire over ``mesh``'s
    ``axis`` (W ranks): q (W, cap_s, K) int8 every shard's sorted slab's
    codes, s (W, cap_s / block_m) their scales, one a routing block (the
    :func:`_wire_fmt` of 'int8-mxu'), be (W, cap_s / block_m) int32, wq
    (W, E, N, K) / ws (W, E, N) every rank's per-(expert, column) int8
    weights, transposed (:func:`quantize_expert_shards`) → a list of W
    (W·cap_s, N) outputs: rank r's row t is ``codes[t] @ wq[r,
    be[t / block_m]]`` summed in s32, times ``(row scale · column
    scale)`` in f32, stored to ``out_dtype`` (f32 or bf16)."""
    if q.device.type == "cpu":
        return ag_group_gemm_mesh_mx_plain(q, s, be, wq, ws, mesh, axis,
                                           out_dtype=out_dtype)
    return _ag_group_gemm_mx_cuda(q, s, be, wq, ws, mesh, axis, out_dtype)


def ag_group_gemm_mx(q, s, be, wq, ws, *, out_dtype=torch.bfloat16):
    """The int8-mxu product at world size 1, JAX's ring at n = 1 (the own
    slab's codes through the s8 kernel): q (cap, K), s and be (cap /
    block_m,), wq (E, N, K), ws (E, N) → (cap, N); the one-rank launch of
    :func:`ag_group_gemm_mesh_mx`."""
    mesh = Mesh.loopback(1, q.device)
    return ag_group_gemm_mesh_mx(q[None], s[None], be[None], wq[None],
                                 ws[None], mesh, out_dtype=out_dtype)[0]


def _ag_group_gemm_mx_cuda(q, s, be, wq, ws, mesh, axis, out_dtype):
    from triton_distributed_tpu_torch.kernels import _build

    what = "ag_group_gemm_mesh_mx"
    n, cap_s, block_m = _check_mx(q, s, be, wq, ws, mesh, axis)
    if any(not t.is_contiguous() for t in (q, s, be, wq, ws)):
        raise ValueError(f"{what}'s kernel needs contiguous tensors")
    if be.shape[1] > 1 and block_m % KERNEL_BM:
        raise ValueError(f"{what}: block_m={block_m} must be a multiple of "
                         f"{KERNEL_BM} when there is more than one M-block")
    out_dtype = _out_dtype(out_dtype, q, what)
    _, e, nn, k = wq.shape
    out = symm_empty(mesh, (n * cap_s, nn), out_dtype)
    fn = _build.function("tdt_ag_group_gemm_mx", "p" * 6 + "i" * 10 + "p")
    rc = fn(_build.ptr(q), _build.ptr(s), _build.ptr(be), _build.ptr(wq),
            _build.ptr(ws), _build.ptr(out.peers), cap_s, k, nn, e, block_m,
            n, 0, n, block_m, _DT_CODE[out_dtype], _build.stream(mesh.device))
    _build.check(rc, "tdt_ag_group_gemm_mx")
    _ag_group_gemm_mx_cuda.launches += 1
    return out.shards


def moe_reduce_rs_partials_plain(y, be, w, mesh, axis="tp", *,
                                 out_dtype=None):
    """Plain PyTorch version of :func:`moe_reduce_rs_partials`: each
    rank's grouped GEMM over all its rows, f32 sums rounded once."""
    n, _, _ = _check_mesh(y, None, be, w, mesh, axis, "moe_reduce_rs_mesh_w")
    out_dtype = to_torch_dtype(out_dtype or y[0].dtype)
    be_all = be.reshape(-1)
    return [grouped_matmul_plain(yq, wq, be_all, out_dtype=out_dtype)
            for yq, wq in zip(y, w)]


def moe_reduce_rs_partials(y, be, w, mesh, axis="tp", *, out_dtype=None):
    """Every rank's partial slab y_q @ w_q[be] over all its W·cap_s rows
    (destination d's at d·cap_s), f32 sums rounded once to ``out_dtype``
    → W (W·cap_s, H) slabs; on the card one launch of
    ``tdt_moe_reduce_rs_partials`` into symmetric slabs (the fold reads
    its peers')."""
    if y[0].device.type == "cpu":
        return moe_reduce_rs_partials_plain(y, be, w, mesh, axis,
                                            out_dtype=out_dtype)
    return _moe_reduce_rs_partials_cuda(y, be, w, mesh, axis, out_dtype)


def _moe_reduce_rs_partials_cuda(y, be, w, mesh, axis, out_dtype):
    from triton_distributed_tpu_torch.kernels import _build

    what = "moe_reduce_rs_mesh_w"
    n, cap_s, block_m = _check_mesh(y, None, be, w, mesh, axis, what)
    dev, aligned = _mesh_launch_common(y, w, (be,), be, block_m, what)
    out_dtype = _out_dtype(out_dtype, y[0], what)
    f, h = y[0].shape[1], w[0].shape[2]
    parts = symm_empty(mesh, (n * cap_s, h), out_dtype)
    wg = grouped_wgmma_form(cap_s, block_m, f, h, n, y[0].dtype, out_dtype,
                            [*y, *w, *parts.shards])
    y_peers, w_peers = (None, None) if wg else (peer_table(y), peer_table(w))
    hosts = [_build.ptr_array(t) for t in (y, w, parts.shards)]
    form = ctypes.c_int(-1)
    fn = _build.function("tdt_moe_reduce_rs_partials",
                         "p" * 7 + "i" * 10 + "pp")
    rc = fn(None if wg else _build.ptr(y_peers),
            None if wg else _build.ptr(w_peers),
            None if wg else _build.ptr(parts.peers), _build.ptr(be), *hosts,
            cap_s, f, h, w[0].shape[0], block_m, n, _DT_CODE[y[0].dtype],
            _DT_CODE[out_dtype], int(aligned), int(wg), ctypes.byref(form),
            _build.stream(dev))
    _build.check(rc, "tdt_moe_reduce_rs_partials")
    _moe_reduce_rs_partials_cuda.launches += 1
    count_form(_moe_reduce_rs_partials_cuda, form.value)
    return parts.shards


def moe_reduce_rs_fold_plain(parts, mesh, fmt, out_dtype):
    """Plain PyTorch version of :func:`moe_reduce_rs_fold`:
    ``gemm_rs_fold_plain`` (JAX's reduce ring: destination d starts from
    rank d − 1's partial, and at each hop the running sum is quantized,
    dequantized in f32, the next partial added in f32 and the sum
    rounded to ``out_dtype``; the own partial last), into symmetric
    outputs."""
    red = gemm_rs_fold_plain(parts, fmt, out_dtype)
    out = symm_empty(mesh, tuple(red[0].shape), out_dtype)
    for o, r in zip(out.shards, red):
        o.copy_(r)
    return out.shards


def moe_reduce_rs_fold(parts, mesh, fmt, out_dtype):
    """The MoE-TP reduce ring's hops over the W ranks' partial slabs
    (W·cap_s, H) → the W (cap_s, H) outputs; on the card the GEMM-RS
    wire's fold (``tdt_gemm_rs_fold``, :func:`~triton_distributed_tpu_torch.
    kernels.gemm_rs.launch_fold`, m = cap_s), counted apart from the
    dense GEMM-RS's."""
    if parts[0].device.type == "cpu":
        return moe_reduce_rs_fold_plain(parts, mesh, fmt, out_dtype)
    return _moe_reduce_rs_fold_cuda(parts, mesh, fmt, out_dtype)


def _moe_reduce_rs_fold_cuda(parts, mesh, fmt, out_dtype):
    out = launch_fold(parts, mesh, fmt, out_dtype)
    _moe_reduce_rs_fold_cuda.launches += 1
    return out


def moe_reduce_rs_mesh_w_plain(y, be, w, mesh, fmt, axis="tp", *,
                               out_dtype=None):
    """Plain PyTorch version of :func:`moe_reduce_rs_mesh_w`: the plain
    partials, then the plain fold."""
    parts = moe_reduce_rs_partials_plain(y, be, w, mesh, axis,
                                         out_dtype=out_dtype)
    return moe_reduce_rs_fold_plain(parts, mesh, fmt, parts[0].dtype)


def moe_reduce_rs_mesh_w(y, be, w, mesh, fmt, axis="tp", *,
                         out_dtype=None):
    """Grouped GEMM ⊕ reduce-scatter on the fp8 / int8 wire (``fmt``, the
    :func:`_wire_fmt` of the (cap_s, H) slab the ring moves): as
    :func:`moe_reduce_rs_mesh`, with each destination's partials folded
    hop by hop in the reduce ring's order, each running sum requantized
    (``moe_reduce_rs_kernel_w``): :func:`moe_reduce_rs_partials`, then
    :func:`moe_reduce_rs_fold`."""
    if y[0].device.type == "cpu":
        return moe_reduce_rs_mesh_w_plain(y, be, w, mesh, fmt, axis,
                                          out_dtype=out_dtype)
    parts = _moe_reduce_rs_partials_cuda(y, be, w, mesh, axis, out_dtype)
    return _moe_reduce_rs_fold_cuda(parts, mesh, fmt, parts[0].dtype)


#: launch counts of the kernels (plain ints on the wrappers): at world
#: size 1, over a mesh (each launch covers every rank), and the wires'
#: (the one-rank int8-mxu form counts with its mesh form); the bf16 pair at
#: world size 1 and over a mesh, the fp8 / int8 AG and the partials also by
#: form
_ag_group_gemm_cuda.launches = 0
_ag_group_gemm_cuda.by_variant = {}
_moe_reduce_rs_cuda.launches = 0
_moe_reduce_rs_cuda.by_variant = {}
_ag_group_gemm_mesh_cuda.launches = 0
_ag_group_gemm_mesh_cuda.by_variant = {}
_moe_reduce_rs_mesh_cuda.launches = 0
_moe_reduce_rs_mesh_cuda.by_variant = {}
_ag_group_gemm_w_cuda.launches = 0
_ag_group_gemm_w_cuda.by_variant = {}
_ag_group_gemm_mx_cuda.launches = 0
_moe_reduce_rs_partials_cuda.launches = 0
_moe_reduce_rs_partials_cuda.by_variant = {}
_moe_reduce_rs_fold_cuda.launches = 0
