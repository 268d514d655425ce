"""Dense all-to-all of equal row blocks over a mesh.

Port of ``all_to_all`` / ``all_to_all_device`` (``triton_distributed_tpu/
kernels/all_to_all.py:81,120``) over ``_a2a_kernel`` (``:30``): rank i's
row block j lands in row block i of rank j. It is the transport of the
padded-slot ("pallas") EP exchange
(:mod:`~triton_distributed_tpu_torch.kernels.moe_all_to_all`), whose
slots are int32 words.

On the card one launch of ``tdt_all_to_all`` (``csrc/all_to_all.cu``)
covers every rank: each destination pulls its blocks from the peers
through the peer table, the bytes unchanged whatever the dtype. On CPU
tensors the entries run :func:`all_to_all_plain`.

The port is single-controller: :func:`all_to_all` takes a list of W
per-rank tensors (rows, ...) and returns W; :func:`all_to_all_device`
takes the ranks stacked, one (W, rows, ...) tensor, as the EP host side
holds them, and returns them stacked.
"""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.runtime.topology import one_axis


def _check(x, n, what):
    x0 = x[0]
    if x0.dim() < 1 or x0.shape[0] % n:
        raise ValueError(f"{what}: {tuple(x0.shape)} rows do not split into "
                         f"{n} blocks")
    for t in x:
        if t.shape != x0.shape or t.dtype != x0.dtype or t.device != x0.device:
            raise ValueError(f"{what}: the ranks' tensors differ in shape, "
                             "dtype or device")


def all_to_all_plain(x):
    """Plain PyTorch version: the W ranks' tensors (a list, rows
    divisible by W) → the W outputs, rank j's block i rank i's block j."""
    n = len(x)
    blocks = [t.chunk(n, dim=0) for t in x]
    return [torch.cat([blocks[i][j] for i in range(n)]) for j in range(n)]


def all_to_all(x, mesh, axis: str = "tp"):
    """Equal-split AllToAll along dim 0 (row block j of rank i → row
    block i of rank j): ``x`` a list of W per-rank tensors of one shape
    → a list of W. At one rank the input passes through. On CPU tensors
    this is :func:`all_to_all_plain`; on CUDA tensors it launches the
    kernel or raises."""
    n = one_axis(mesh, axis)
    if not isinstance(x, (list, tuple)) or len(x) != n:
        raise ValueError(f"all_to_all takes a list of {n} per-rank tensors")
    if n == 1:
        return list(x)
    _check(x, n, "all_to_all")
    if x[0].device.type == "cpu":
        return all_to_all_plain(list(x))
    return _all_to_all_cuda(list(x), mesh)


def all_to_all_device(x, mesh, axis: str = "tp"):
    """The dense all-to-all on the ranks stacked: ``x`` (W, rows, ...)
    → (W, rows, ...), ``out[j]``'s block i ``x[i]``'s block j. At one
    rank it returns its input (JAX ``:87-88``)."""
    n = one_axis(mesh, axis)
    if x.shape[0] != n:
        raise ValueError(f"all_to_all_device takes the {n} ranks stacked on "
                         f"dim 0, got {tuple(x.shape)}")
    if n == 1:
        return x
    parts = list(x.unbind(0))
    _check(parts, n, "all_to_all_device")
    if x.device.type == "cpu":
        return torch.stack(all_to_all_plain(parts))
    from triton_distributed_tpu_torch.lang.shmem import stacked

    return stacked(_all_to_all_cuda(parts, mesh))


def _all_to_all_cuda(x, mesh):
    """``tdt_all_to_all`` for every rank in one launch."""
    from triton_distributed_tpu_torch.kernels import _build
    from triton_distributed_tpu_torch.lang.shmem import peer_table, symm_empty

    if x[0].device != mesh.device:
        raise ValueError(f"all_to_all: tensors on {x[0].device}, the mesh "
                         f"is on {mesh.device}")
    if any(not t.is_contiguous() for t in x):
        raise ValueError("all_to_all's kernel needs contiguous tensors")
    n = len(x)
    block = x[0].numel() * x[0].element_size() // n
    out = symm_empty(mesh, tuple(x[0].shape), x[0].dtype)
    in_peers = peer_table(x)   # referenced until the launch is enqueued
    fn = _build.function("tdt_all_to_all", "ppL" + "iii" + "p")
    rc = fn(_build.ptr(in_peers), _build.ptr(out.peers), block, n, 0, n,
            _build.stream(mesh.device))
    _build.check(rc, "tdt_all_to_all")
    _all_to_all_cuda.launches += 1
    return out.shards


#: launch count of the kernel (a plain int on the wrapper)
_all_to_all_cuda.launches = 0
