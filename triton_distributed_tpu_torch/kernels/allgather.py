"""All-gather over a mesh.

Port of ``all_gather`` (``triton_distributed_tpu/kernels/allgather.py:
588``) for ``RING_1D`` (``_ring_ag_kernel``, ``:42``) and ``LL_SMALL``
(``_ll_push_ag_kernel``, ``:199``): every rank ends with the
concatenation of all ranks' shards along dim 0. Both methods give the
same bytes, and on the card both run one pull kernel, ``tdt_all_gather``
(``csrc/allgather.cu``), which reads each peer's shard through the peer
table (:mod:`~triton_distributed_tpu_torch.lang.shmem`). ``RING_BIDIR``,
``LL_PERSIST``, ``XLA_FALLBACK`` and quantized wires raise: they are
ROADMAP Queue 2 item 11.

The port is single-controller: ``x`` is a list of W per-rank shards of
one shape and dtype, and the result is a list of W gathered tensors, one
per rank (views of one allocation on the loopback mesh). On CPU tensors
:func:`all_gather` runs :func:`all_gather_plain`, ``torch.cat``.
"""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.runtime.topology import (
    AllGatherMethod,
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


def all_gather_plain(x, mesh, axis: str = "tp"):
    """Plain PyTorch version: each rank's ``torch.cat`` of the shards."""
    _check_shards(x, mesh, axis, "all_gather")
    return [torch.cat(list(x), dim=0) for _ in x]


def all_gather(x, mesh, axis: str = "tp", *, method=None, wire_dtype=None):
    """AllGather the per-rank shards ``x`` (a list of W tensors of one
    shape, (m, ...)) along ``axis`` → a list of W (W·m, ...) tensors,
    rank r's the concatenation of every rank's shard.

    ``method`` None, ``RING_1D`` and ``LL_SMALL`` all run the one kernel:
    the JAX package picks between the two by size, and here they give
    the same bytes. The other methods raise. On CPU tensors this is
    :func:`all_gather_plain`; on CUDA tensors it launches the kernel or
    raises."""
    n = _check_shards(x, mesh, axis, "all_gather")
    if wire_dtype not in (None, "bf16"):
        raise NotImplementedError(
            f"all_gather wire_dtype={wire_dtype!r}: quantized wires come "
            "with the ring variants (ROADMAP Queue 2 item 11)")
    if method is not None and method not in PORTED_METHODS:
        raise NotImplementedError(
            f"all_gather method {method.name}: only RING_1D and LL_SMALL "
            "are ported (ROADMAP Queue 2 item 11)")
    if x[0].device.type == "cpu":
        return all_gather_plain(x, mesh, axis)
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


#: launch count of the kernel (a plain int on the wrapper)
_all_gather_cuda.launches = 0
