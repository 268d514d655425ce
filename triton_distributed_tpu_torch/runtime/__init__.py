"""The port's runtime: the device mesh (``topology``)."""

from triton_distributed_tpu_torch.runtime.topology import (
    AllGatherMethod,
    Mesh,
    mesh_axes_size,
    ring_neighbors,
)

__all__ = ["AllGatherMethod", "Mesh", "mesh_axes_size", "ring_neighbors"]
