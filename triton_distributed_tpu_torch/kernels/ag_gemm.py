"""All-gather + GEMM for column-parallel tensor parallelism.

Port of ``ag_gemm`` (``triton_distributed_tpu/kernels/ag_gemm.py:1132``).
Its fused engine, ``_fused_kernel`` (``:227``), forwards the row shards
of A around a ring (``ag_forward_ring``, ``kernels/ring.py:115``) and
streams each through the blocked GEMM of ``mm_pipeline``
(``:128-162``), so that rank r ends with ``out_r = AllGather(A) @ B_r``:
bf16 (or f32) in, f32 sums, the output in A's dtype.

Two forms:

* **world size 1**, ``ag_gemm(a, b)`` on tensors: the ring has nothing
  to gather and the kernel is the GEMM, run on the float-mode kernel of
  ``csrc/group_gemm.cu`` with one expert (launches counted apart, as
  ``ag_gemm_n1``);
* **over a mesh**, ``ag_gemm(a_shards, b_shards, mesh, axis)``: a list of
  W row shards A_q (m, K) and a list of W column shards B_r (K, N_r) →
  a list of W outputs (W·m, N_r). On the card one launch of
  ``tdt_ag_gemm`` (``csrc/ag_gemm.cu``) covers every rank: each output
  tile loads its A rows from the peer rank that holds them, through the
  peer table (:mod:`~triton_distributed_tpu_torch.lang.shmem`).

On CPU tensors :func:`ag_gemm` runs :func:`ag_gemm_plain`. The wire
variants (``_fused_kernel_w``, ``_mx``) are ROADMAP Queue 2 item 16.
"""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.config import to_torch_dtype
from triton_distributed_tpu_torch.runtime.topology import one_axis

_DT_CODE = {torch.float32: 0, torch.bfloat16: 1}


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


def ag_gemm_plain(a, b, mesh=None, axis: str = "tp", *, out_dtype=None):
    """Plain PyTorch version. Tensors: ``a @ b`` in f32, cast to
    ``out_dtype`` (default a's dtype). Shard lists: for each rank r,
    ``cat(A) @ B_r`` in f32, cast."""
    if not _is_shards(a):
        _check(a, b, mesh, axis, "ag_gemm")
        return (a.float() @ b.float()).to(to_torch_dtype(out_dtype or a.dtype))
    check_shards(a, b, mesh, axis, "ag_gemm")
    out_dtype = to_torch_dtype(out_dtype or a[0].dtype)
    gathered = torch.cat(list(a), dim=0).float()
    return [(gathered @ br.float()).to(out_dtype) for br in b]


def ag_gemm(a, b, mesh=None, axis: str = "tp", *, out_dtype=None):
    """AllGather(A) @ B (column-parallel).

    World size 1: a (M, K), b (K, N) tensors → (M, N). Over a mesh: a a
    list of W row shards (m, K), b a list of W column shards (K, N) →
    a list of W (W·m, N) outputs, rank r's the gathered A times B_r.
    A and B both bf16 or both f32 on the card; ``out_dtype`` (default
    A's dtype) f32 or bf16. On CPU tensors this is :func:`ag_gemm_plain`;
    on CUDA tensors it launches the kernel or raises."""
    if not _is_shards(a):
        _check(a, b, mesh, axis, "ag_gemm")
        if a.device.type == "cpu":
            return ag_gemm_plain(a, b, out_dtype=out_dtype)
        return _ag_gemm_cuda(a, b, out_dtype)
    n = check_shards(a, b, mesh, axis, "ag_gemm")
    if a[0].shape[1] != b[0].shape[0]:
        raise ValueError(f"ag_gemm: contract dim mismatch "
                         f"{tuple(a[0].shape)} @ {tuple(b[0].shape)}")
    if a[0].device.type == "cpu":
        return ag_gemm_plain(a, b, mesh, axis, out_dtype=out_dtype)
    return _ag_gemm_mesh_cuda(a, b, mesh, n, out_dtype)


def _ag_gemm_cuda(a, b, out_dtype):
    from triton_distributed_tpu_torch.kernels.group_gemm import float_gemm

    out = float_gemm(a, b, out_dtype)
    _ag_gemm_cuda.launches += 1
    return out


def launch_mesh_gemm(entry, a, b, mesh, n, m, out_rows, out_dtype):
    """Launch ``tdt_ag_gemm`` or ``tdt_gemm_rs`` (``m``: rows of an A
    shard, or of an output shard) over every rank of the loopback mesh
    (one launch, ``blockIdx.z`` the rank) into a fresh symmetric output
    of ``(out_rows, N)`` per rank; returns its shards."""
    from triton_distributed_tpu_torch.kernels import _build
    from triton_distributed_tpu_torch.lang.shmem import peer_table, symm_empty

    dtype = a[0].dtype
    out_dtype = to_torch_dtype(out_dtype or dtype)
    if dtype not in _DT_CODE or b[0].dtype != dtype:
        raise ValueError(f"{entry} takes A and B both f32 or both bf16, got "
                         f"{dtype} and {b[0].dtype}")
    if out_dtype not in _DT_CODE:
        raise ValueError(f"{entry}: out_dtype must be f32 or bf16, got "
                         f"{out_dtype}")
    if any(not s.is_contiguous() for s in (*a, *b)):
        raise ValueError(f"{entry}'s kernel needs contiguous shards")
    dev = mesh.device
    zero = torch.zeros((1,), dtype=torch.int32, device=dev)
    aligned = all(s.data_ptr() % 16 == 0 for s in (*a, *b))
    out = symm_empty(mesh, (out_rows, b[0].shape[1]), out_dtype)
    # the tables (and ``zero``) stay referenced until the launch is
    # enqueued: one freed earlier could be handed to the next allocation
    # on the stream and rewritten before the kernel reads it
    a_peers, b_peers = peer_table(a), peer_table(b)
    fn = _build.function(entry, "pppp" + "i" * 9 + "p")
    rc = fn(_build.ptr(a_peers), _build.ptr(b_peers),
            _build.ptr(out.peers), _build.ptr(zero), m, a[0].shape[1],
            b[0].shape[1], n, 0, n, _DT_CODE[dtype], _DT_CODE[out_dtype],
            int(aligned), _build.stream(dev))
    _build.check(rc, entry)
    return out.shards


def _ag_gemm_mesh_cuda(a, b, mesh, n, out_dtype):
    m = a[0].shape[0]
    out = launch_mesh_gemm("tdt_ag_gemm", a, b, mesh, n, m, n * m,
                           out_dtype)
    _ag_gemm_mesh_cuda.launches += 1
    return out


#: launch counts of the kernels (plain ints on the wrappers): the world-
#: size-1 GEMM, and the kernel over a mesh
_ag_gemm_cuda.launches = 0
_ag_gemm_mesh_cuda.launches = 0
