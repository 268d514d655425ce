"""Geometry and wire quantization of the MoE all-to-all.

Port of the parts of ``triton_distributed_tpu/kernels/moe_all_to_all.py``
that the fused (count-bounded chunked) transport of
:mod:`~triton_distributed_tpu_torch.kernels.moe_dispatch` uses: the
exchange's static geometry, the per-token wire quantizers, and the
per-peer offsets and receive-count clamp. The padded-slot transport
(``dispatch_stage``, ``pack_slots`` and their inverses) is not ported.

``n`` is the number of EP ranks: 1 (one GPU owns every expert), or the
size of the mesh axis the experts are split over. Over a mesh every
function here takes the ranks' tensors stacked on a leading dim, so one
op serves all ranks; the per-peer helpers work on any leading dims.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from triton_distributed_tpu_torch.config import to_torch_dtype
from triton_distributed_tpu_torch.kernels.moe_utils import exclusive_cumsum
from triton_distributed_tpu_torch.runtime.topology import Mesh, one_axis

_WIRE = {"fp8": torch.float8_e4m3fn, "int8": torch.int8}


@dataclass(frozen=True)
class MoEAllToAllContext:
    """Static geometry of the EP exchange.

    ``max_m``: token-assignment capacity (the fused transport needs the
    full ``M·topk``); ``quant``: the wire format, ``"fp8"`` (e4m3) or
    ``"int8"`` with one f32 scale per token in the metadata, or None for
    tokens in ``dtype``; ``chunk_m``: the transport's chunk granule in
    rows (None → max(tile, 64)); ``mesh`` / ``axis``: the mesh whose
    axis the ``n`` ranks are (None at one rank)."""

    n: int
    max_m: int
    hidden: int
    experts_per_rank: int
    dtype: torch.dtype = torch.bfloat16
    quant: str | None = None
    chunk_m: int | None = None
    mesh: Mesh | None = None
    axis: str = "tp"

    def __post_init__(self):
        object.__setattr__(self, "dtype", to_torch_dtype(self.dtype))
        if self.mesh is not None and one_axis(self.mesh, self.axis) != self.n:
            raise ValueError(f"n={self.n} is not the size of the mesh's "
                             f"{self.axis!r} axis {self.mesh.shape}")
        if self.quant not in (None, "fp8", "int8"):
            raise ValueError(
                f"quant must be None|'fp8'|'int8', got {self.quant!r}")
        if self.hidden * self.wire_itemsize % 4:
            raise ValueError(f"hidden={self.hidden} row of {self.wire_dtype}"
                             " is not a whole number of int32s")

    @property
    def num_experts(self) -> int:
        return self.n * self.experts_per_rank

    @property
    def wire_dtype(self) -> torch.dtype:
        return self.dtype if self.quant is None else _WIRE[self.quant]

    @property
    def wire_itemsize(self) -> int:
        return self.wire_dtype.itemsize

    @property
    def quant_max(self) -> float:
        return 448.0 if self.quant == "fp8" else 127.0


def quantize_rows(ctx: MoEAllToAllContext, toks):
    """(..., H) → ((..., H) wire dtype, (...,) f32 per-token scales):
    symmetric, scale = amax / QMAX. The fp8 cast rounds to nearest
    even, as ``jnp.float8_e4m3fn`` does."""
    f = toks.float()
    amax = f.abs().amax(dim=-1)
    scale = torch.clamp(amax, min=1e-12) / ctx.quant_max
    q = f / scale[..., None]
    if ctx.quant == "int8":
        q = torch.clamp(torch.round(q), -127, 127).to(torch.int8)
    else:
        q = q.to(torch.float8_e4m3fn)
    return q, scale


def dequantize_rows(ctx: MoEAllToAllContext, q, scale):
    """Inverse of :func:`quantize_rows`, back to ``ctx.dtype``."""
    return (q.float() * scale[..., None]).to(ctx.dtype)


def peer_offsets(ctx: MoEAllToAllContext, splits):
    """(counts (..., n), exclusive offsets (..., n)) of a rank's
    assignments per peer; ``splits`` (..., num_experts) counts per
    global expert (experts [j·epr, (j+1)·epr) live on peer j)."""
    counts = splits.reshape(*splits.shape[:-1], ctx.n,
                            ctx.experts_per_rank).sum(dim=-1,
                                                      dtype=torch.int32)
    return counts, exclusive_cumsum(counts)


def clamp_recv_splits(ctx: MoEAllToAllContext, spl):
    """Receiver splits (..., epr) clamped to what fits the ``max_m``
    capacity (a sender past it shipped only its first ``max_m`` rows, in
    expert order)."""
    cum = torch.clamp(torch.cumsum(spl, dim=-1, dtype=torch.int32),
                      max=ctx.max_m)
    return torch.diff(cum, dim=-1, prepend=torch.zeros_like(cum[..., :1]))
