"""The device mesh, and the all-gather method names.

Port of the parts of ``triton_distributed_tpu/runtime/topology.py`` that
the tensor-parallel path needs: ``AllGatherMethod`` (``:24``),
``auto_allgather_method`` (``:86``), ``auto_allgather_wire`` (``:99``),
``mesh_axes_size`` (``:117``) and ``ring_neighbors`` (``:125``), plus
:class:`Mesh`, the port's counterpart of ``jax.sharding.Mesh``
(:meth:`Mesh.loopback` for one axis, :meth:`Mesh.grid` for several, as
context-parallel serving's ``{"tp": 1, "cp": 2}``).

The port is single-controller, as JAX is: one process drives every rank
of a mesh. A tensor sharded over the mesh is a Python list of per-rank
tensors, one on each rank's device. On the one card this round runs on,
the mesh is a **loopback mesh** (:meth:`Mesh.loopback`): W ranks, each
with its own buffers, all on the same device. A kernel reaches a peer
rank's buffer through a device-side table of data pointers
(:mod:`~triton_distributed_tpu_torch.lang.shmem`), so on the card the
collectives run at W ranks with real cross-rank addressing.

A mesh whose ranks sit on distinct GPUs raises ``NotImplementedError``:
it needs peer access between the cards, one launch per device and a
cross-device barrier before each launch, and nothing here can test those
(ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass

import torch

from triton_distributed_tpu_torch.config import indexed, resolve_device


class AllGatherMethod(enum.Enum):
    """The JAX package's all-gather methods (``:24``). The port runs
    ``RING_1D`` and ``LL_SMALL`` on one pull kernel (``tdt_all_gather``,
    the same bytes either way), ``RING_BIDIR`` and ``LL_PERSIST`` on
    kernels of their own; ``XLA_FALLBACK`` raises."""

    RING_1D = "ring_1d"
    RING_BIDIR = "ring_bidir"
    LL_SMALL = "ll_small"
    LL_PERSIST = "ll_persist"
    XLA_FALLBACK = "xla"


@dataclass(frozen=True)
class Mesh:
    """Named axes over ranks, row-major, with one device per rank.

    ``devices`` holds one torch device per rank; ``axis_names`` and
    ``axis_sizes`` name and size the axes (their product is the number
    of ranks). Every rank must sit on the same device: a loopback mesh.
    Build one with :meth:`loopback`."""

    devices: tuple
    axis_names: tuple
    axis_sizes: tuple

    def __post_init__(self):
        devs = tuple(indexed(torch.device(d)) for d in self.devices)
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        object.__setattr__(self, "axis_sizes",
                           tuple(int(s) for s in self.axis_sizes))
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.axis_sizes)} axis sizes")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"axis names repeat: {self.axis_names}")
        if math.prod(self.axis_sizes) != len(devs) or not devs:
            raise ValueError(f"axes {self.axis_sizes} do not cover "
                             f"{len(devs)} devices")
        if len(set(devs)) > 1:
            raise NotImplementedError(
                f"a mesh over distinct devices {sorted(map(str, set(devs)))}"
                " needs peer access between the cards, one launch per "
                "device and a cross-device barrier before each launch "
                "(ROADMAP Queue 1 item 11); only a loopback mesh, every "
                "rank on one device, is ported")

    @classmethod
    def loopback(cls, n: int, device=None, axis: str = "tp") -> "Mesh":
        """``n`` ranks along ``axis``, all on ``device`` (default: the
        current CUDA device; ``"cpu"`` must be asked for)."""
        if n < 1:
            raise ValueError(f"a mesh needs at least one rank, got {n}")
        dev = resolve_device(device)
        return cls((dev,) * n, (axis,), (n,))

    @classmethod
    def grid(cls, axes: dict, device=None) -> "Mesh":
        """A loopback mesh with the named axes, sized by ``axes`` (name →
        size, row-major in that order), e.g. ``{"tp": 1, "cp": 2}`` for
        context-parallel serving; all ranks on ``device``."""
        dev = resolve_device(device)
        sizes = tuple(int(v) for v in axes.values())
        if any(v < 1 for v in sizes):
            raise ValueError(f"every axis needs at least one rank: {axes}")
        return cls((dev,) * math.prod(sizes), tuple(axes), sizes)

    @property
    def shape(self) -> dict:
        """Axis name → size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The one device every rank of the loopback mesh lives on."""
        return self.devices[0]

    def axis_size(self, axis: str) -> int:
        if axis not in self.shape:
            raise ValueError(f"mesh has no axis {axis!r} (axes "
                             f"{self.axis_names})")
        return self.shape[axis]


def auto_allgather_method(n: int, nbytes_per_shard: int,
                          small_msg_threshold: int = 1 << 16
                          ) -> AllGatherMethod:
    """The method JAX's all-gather picks when the caller names none
    (``auto_allgather_method``, JAX ``:86-96``, on one slice: the
    loopback mesh has no DCN leg): ``LL_SMALL`` up to 64 KiB a shard,
    else ``RING_BIDIR`` on 4 or more ranks and ``RING_1D`` below."""
    if nbytes_per_shard <= small_msg_threshold:
        return AllGatherMethod.LL_SMALL
    if n >= 4:
        return AllGatherMethod.RING_BIDIR
    return AllGatherMethod.RING_1D


def auto_allgather_wire(nbytes_per_shard: int,
                        threshold: int = 1 << 18) -> str | None:
    """The wire of a standalone all-gather asked for 'auto' (JAX
    ``:99-116``): 'fp8' from ``threshold`` bytes a shard (256 KiB), None
    below, where the quantize and dequantize passes cost more than the
    bytes they save. int8 is never picked: the same bytes as fp8 with
    coarser numerics."""
    return "fp8" if nbytes_per_shard >= threshold else None


def mesh_axes_size(mesh: Mesh, axes) -> int:
    """Product of mesh extents over ``axes`` (e.g. total DP degree)."""
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    return size


def ring_neighbors(idx: int, n: int):
    """(left, right) neighbours of rank ``idx`` on a ring of ``n``."""
    return (idx + n - 1) % n, (idx + 1) % n


def one_axis(mesh: Mesh, axis: str, beside: tuple = ()) -> int:
    """The size of ``axis`` on a mesh whose other axes have size 1, the
    axes named in ``beside`` excepted (a model sizes tp beside its cp
    axis): the collectives of this slice run over one axis (data-parallel
    axes beside it are ROADMAP Queue 1 item 11)."""
    n = mesh.axis_size(axis)
    if mesh.size != n * mesh_axes_size(mesh, beside):
        raise NotImplementedError(
            f"collectives over {axis!r} on a mesh of shape {mesh.shape}: "
            "axes beside it (dp_axes) are ROADMAP Queue 1 item 11")
    return n
