"""All-gather layer.

Port of ``AllGatherLayer`` (``triton_distributed_tpu/layers/allgather.py:
27``): the mesh and axis, and the named method entries (``RING_1D``,
``RING_BIDIR``, ``LL_SMALL``, ``LL_PERSIST``; see
:mod:`~triton_distributed_tpu_torch.kernels.allgather`). JAX's
``forward_xla`` is not ported: XLA's all-gather has no kernel here.
"""

from __future__ import annotations

from dataclasses import dataclass

from triton_distributed_tpu_torch.kernels.allgather import all_gather
from triton_distributed_tpu_torch.runtime.topology import AllGatherMethod, Mesh


@dataclass(frozen=True)
class AllGatherLayer:
    mesh: Mesh
    axis: str = "tp"

    def __call__(self, x, method: AllGatherMethod | None = None):
        """x: a list of W per-rank (m, ...) shards → a list of W gathered
        (W·m, ...) tensors, one per rank."""
        return all_gather(x, self.mesh, self.axis, method=method)

    def forward_ring(self, x):
        return self(x, AllGatherMethod.RING_1D)

    def forward_ring_bidir(self, x):
        """Both ring directions, each carrying part of the columns."""
        return self(x, AllGatherMethod.RING_BIDIR)

    def forward_ll(self, x):
        """The small-message path (``LL_SMALL``)."""
        return self(x, AllGatherMethod.LL_SMALL)

    def forward_ll_persist(self, x):
        """The barrier-free LL gather over the persistent double-buffered
        workspace of ``all_gather``'s context for this shape
        (``LL_PERSIST``)."""
        return self(x, AllGatherMethod.LL_PERSIST)
