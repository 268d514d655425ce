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
version; on a CUDA tensor it launches the kernel or raises. The
quantized-wire twins (``_w``, ``_mx``, ``moe_reduce_rs_kernel_w``)
come with the collectives (ROADMAP Queue 2 item 18).
"""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.config import to_torch_dtype
from triton_distributed_tpu_torch.kernels.group_gemm import (
    _DT_CODE,
    KERNEL_BM,
    _check_args,
    _cuda_common,
    grouped_matmul_plain,
)
from triton_distributed_tpu_torch.kernels.moe_utils import gather_sorted
from triton_distributed_tpu_torch.lang.shmem import peer_table, symm_empty


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
    cap, (m, k), n = sti.shape[0], x.shape, w.shape[2]
    if cap % be.shape[0]:
        raise ValueError(f"ag_group_gemm: {cap} rows do not split into "
                         f"{be.shape[0]} equal M-blocks")
    block_m = cap // be.shape[0]
    dev = _cuda_common((x, w, sti), be, cap, block_m)
    out_dtype = _out_dtype(out_dtype, x, "ag_group_gemm")
    out = torch.empty((cap, n), dtype=out_dtype, device=dev)
    fn = _build.function("tdt_ag_group_gemm", "ppppp" + "iiiiiiii" + "p")
    rc = fn(_build.ptr(x), _build.ptr(sti), _build.ptr(w), _build.ptr(be),
            _build.ptr(out), m, topk, cap, k, n, block_m, _DT_CODE[x.dtype],
            _DT_CODE[out_dtype], _build.stream(dev))
    _build.check(rc, "tdt_ag_group_gemm")
    _ag_group_gemm_cuda.launches += 1
    return out


def _moe_reduce_rs_cuda(y, be, w, out_dtype):
    from triton_distributed_tpu_torch.kernels import _build

    cap, f, _, h, block_m = _check_args(y, w, be, None, None)
    dev = _cuda_common((y, w), be, cap, block_m)
    out_dtype = _out_dtype(out_dtype, y, "moe_reduce_rs")
    out = torch.empty((cap, h), dtype=out_dtype, device=dev)
    fn = _build.function("tdt_moe_reduce_rs", "pppp" + "iiiiii" + "p")
    rc = fn(_build.ptr(y), _build.ptr(w), _build.ptr(be), _build.ptr(out),
            cap, f, h, block_m, _DT_CODE[y.dtype], _DT_CODE[out_dtype],
            _build.stream(dev))
    _build.check(rc, "tdt_moe_reduce_rs")
    _moe_reduce_rs_cuda.launches += 1
    return out


# ------------------------------------------------------------ over a mesh

def _check_mesh(x, sti, be, w, mesh, axis, what):
    """W same-shaped 2-D shards ``x`` and 3-D shards ``w`` on the mesh's
    device, the shards' stacked int32 tables; returns (W, cap_s,
    block_m)."""
    from triton_distributed_tpu_torch.runtime.topology import one_axis

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
    k, nn = x[0].shape[1], w[0].shape[2]
    out = symm_empty(mesh, (n * cap_s, nn), out_dtype)
    # the tables stay referenced until the launch is enqueued: one freed
    # earlier could be handed to the next allocation on the stream and
    # rewritten before the kernel reads it
    x_peers, w_peers = peer_table(x), peer_table(w)
    fn = _build.function("tdt_ag_group_gemm_mesh", "ppppp" + "i" * 12 + "p")
    rc = fn(_build.ptr(x_peers), _build.ptr(w_peers), _build.ptr(out.peers),
            _build.ptr(sti), _build.ptr(be), x[0].shape[0], topk, cap_s, k,
            nn, block_m, n, 0, n, _DT_CODE[x[0].dtype], _DT_CODE[out_dtype],
            int(aligned), _build.stream(dev))
    _build.check(rc, "tdt_ag_group_gemm_mesh")
    _ag_group_gemm_mesh_cuda.launches += 1
    return out.shards


def _moe_reduce_rs_mesh_cuda(y, be, w, mesh, axis, out_dtype):
    from triton_distributed_tpu_torch.kernels import _build

    n, cap_s, block_m = _check_mesh(y, None, be, w, mesh, axis,
                                    "moe_reduce_rs_mesh")
    dev, aligned = _mesh_launch_common(y, w, (be,), be, block_m,
                                       "moe_reduce_rs_mesh")
    out_dtype = _out_dtype(out_dtype, y[0], "moe_reduce_rs_mesh")
    f, h = y[0].shape[1], w[0].shape[2]
    out = symm_empty(mesh, (cap_s, h), out_dtype)
    y_peers, w_peers = peer_table(y), peer_table(w)
    fn = _build.function("tdt_moe_reduce_rs_mesh", "pppp" + "i" * 10 + "p")
    rc = fn(_build.ptr(y_peers), _build.ptr(w_peers), _build.ptr(out.peers),
            _build.ptr(be), cap_s, f, h, block_m, n, 0, n,
            _DT_CODE[y[0].dtype], _DT_CODE[out_dtype], int(aligned),
            _build.stream(dev))
    _build.check(rc, "tdt_moe_reduce_rs_mesh")
    _moe_reduce_rs_mesh_cuda.launches += 1
    return out.shards


#: launch counts of the kernels (plain ints on the wrappers): at world
#: size 1, and over a mesh (each launch covers every rank)
_ag_group_gemm_cuda.launches = 0
_moe_reduce_rs_cuda.launches = 0
_ag_group_gemm_mesh_cuda.launches = 0
_moe_reduce_rs_mesh_cuda.launches = 0
