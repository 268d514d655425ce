"""Symmetric tensors and their peer tables (host side).

Port of the host half of ``triton_distributed_tpu/lang/shmem.py``:
``my_pe`` (``:65``) and ``n_pes`` (``:94``) as host ints. The TPU
kernels push with ``remote_copy`` (``:102``); the port's kernels pull
instead: a kernel takes a **peer table**, an int64 device tensor holding
every rank's data pointer of a symmetric tensor, plus ``(rank0,
nranks)``, the ranks whose outputs the launch writes (``blockIdx.z`` is
the rank), and reads a peer's rows through the table (the symmetric
addressing of the reference's ``symm_at``).

A symmetric tensor is W per-rank tensors of one shape and dtype, one per
rank of a mesh. On the loopback mesh the W shards are views of one
allocation ``(W, *shape)``, and the table is computed on the device (one
``arange`` over the data pointers), with no host-to-device copy.

Signals, ``fence`` and ``quiet`` come with the push-and-signal redesign
of the rings (ROADMAP Queue 1 item 11): this slice's kernels read inputs
that are complete before the launch, by stream order on the one device,
and wait on nothing.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from triton_distributed_tpu_torch.config import to_torch_dtype
from triton_distributed_tpu_torch.runtime.topology import Mesh


@dataclass(frozen=True)
class SymmTensor:
    """W per-rank ``shards`` of one shape and dtype, and their ``peers``
    table ((W,) int64 data pointers on the mesh's device)."""

    shards: list
    peers: torch.Tensor
    mesh: Mesh


def symm_empty(mesh: Mesh, shape, dtype) -> SymmTensor:
    """An uninitialised symmetric tensor: one ``shape`` shard per rank of
    ``mesh``, the shards views of one ``(W, *shape)`` allocation."""
    full = torch.empty((mesh.size, *shape), dtype=to_torch_dtype(dtype),
                       device=mesh.device)
    shards = list(full.unbind(0))
    return SymmTensor(shards, peer_table(shards), mesh)


def stacked(shards):
    """The ``(W, *shape)`` tensor whose rows are ``shards``, when the
    shards are contiguous views of one allocation laid end to end (as
    :func:`symm_empty` makes them); None otherwise."""
    s0 = shards[0]
    n = s0.numel()
    if n == 0 or not all(
            s.is_contiguous() and s.shape == s0.shape and s.dtype == s0.dtype
            and s.device == s0.device
            and s.untyped_storage().data_ptr()
            == s0.untyped_storage().data_ptr()
            and s.storage_offset() == s0.storage_offset() + r * n
            for r, s in enumerate(shards)):
        return None
    return s0.as_strided((len(shards), *s0.shape), (n, *s0.stride()),
                         s0.storage_offset())


def require_stacked(shards, what: str):
    """:func:`stacked` of ``shards``, or ``NotImplementedError``: the
    decode's caches and the model's row shards are taken as one ``(W,
    *shape)`` batch, which holds on the loopback mesh, where every
    per-rank tensor the model makes is a view of one allocation. Shards
    of their own come with the mesh over several GPUs (ROADMAP Queue 1
    item 11)."""
    st = stacked(shards)
    if st is None:
        raise NotImplementedError(
            f"{what} takes per-rank shards that are views of one "
            "allocation (as Transformer.init_cache and symm_empty make "
            "them); shards of their own come with the mesh over several "
            "GPUs (ROADMAP Queue 1 item 11)")
    return st


def block_table(x: torch.Tensor) -> torch.Tensor:
    """The peer table of a tensor whose dim 0 is the rank: the data
    pointer of each rank's block ``x[r]``, whatever the strides inside a
    block (the context-parallel prefill's q / k / v are strided views of
    the projected rows). One ``arange`` on the device, no host copy."""
    n, p0 = x.shape[0], x.data_ptr()
    step = x.stride(0) * x.element_size() if n > 1 else 1
    if step == 0:                      # every rank's block at one address
        return torch.full((n,), p0, dtype=torch.int64, device=x.device)
    return torch.arange(p0, p0 + n * step, step, dtype=torch.int64,
                        device=x.device)


def peer_table(x) -> torch.Tensor:
    """The (W,) int64 table of the shards' data pointers on their device:
    a :class:`SymmTensor`'s own, one ``arange`` for :func:`stacked`
    shards, else an asynchronous copy of the pointers from pinned host
    memory (no host sync)."""
    if isinstance(x, SymmTensor):
        return x.peers
    st = stacked(x)
    if st is not None:
        return block_table(st)
    dev = x[0].device
    host = torch.tensor([s.data_ptr() for s in x], dtype=torch.int64,
                        pin_memory=dev.type == "cuda")
    return host.to(dev, non_blocking=True)


def n_pes(mesh: Mesh, axis: str) -> int:
    """The number of ranks along ``axis`` (``nvshmem_n_pes``)."""
    return mesh.axis_size(axis)


def my_pe(mesh: Mesh, axis: str, rank: int) -> int:
    """Flat rank ``rank``'s index along ``axis`` (``nvshmem_my_pe``: the
    single controller names the rank it asks about)."""
    names, sizes = mesh.axis_names, mesh.axis_sizes
    i = names.index(axis)
    stride = 1
    for s in sizes[i + 1:]:
        stride *= s
    return (rank // stride) % sizes[i]
