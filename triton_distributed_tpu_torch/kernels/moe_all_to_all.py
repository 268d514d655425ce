"""Geometry, wire quantization and slot staging of the MoE all-to-all.

Port of ``triton_distributed_tpu/kernels/moe_all_to_all.py``: the
exchange's static geometry (:class:`MoEAllToAllContext`, with the
padded-slot layout of ``create_all_to_all_context``), the per-token wire
quantizers, the per-peer offsets and receive-count clamp that the fused
(count-bounded chunked) transport of
:mod:`~triton_distributed_tpu_torch.kernels.moe_dispatch` uses, and the
padded-slot ("pallas") transport:

* :func:`dispatch_stage` packs expert-sorted tokens into per-peer slots
  of ``max_m`` rows, truncating a peer's tokens at ``max_m`` (the
  overflow comes back as zero rows, and the receiver's counts are
  clamped: :func:`clamp_recv_splits`);
* :func:`pack_slots` bitcasts a slot into int32 words: the tokens in the
  wire dtype, with a quantized wire their per-token f32 scales, then the
  per-expert counts, ``slot_rows`` rows of ``ints_per_row`` words a slot
  (``_toks_to_ints``, ``_pack_scales``, ``_pack_splits``);
* :func:`fast_all_to_all` exchanges the slots through the dense
  all-to-all (:mod:`~triton_distributed_tpu_torch.kernels.all_to_all`,
  ``tdt_all_to_all`` on the card);
* :func:`recv_tokens_view`, :func:`combine_stage`,
  :func:`combine_unpack` and :func:`combine_unstage` undo it on the two
  legs.

``n`` is the number of EP ranks: 1 (one GPU owns every expert), or the
size of the mesh axis the experts are split over. Over a mesh every
function here takes the ranks' tensors stacked on a leading dim, so one
op serves all ranks; the per-peer helpers work on any leading dims.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from triton_distributed_tpu_torch.config import div_scalar, to_torch_dtype
from triton_distributed_tpu_torch.kernels.all_to_all import all_to_all_device
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

    @property
    def ints_per_row(self) -> int:
        """int32 words of one token row in the wire dtype."""
        return self.hidden * self.wire_itemsize // 4

    @property
    def scale_rows(self) -> int:
        """Rows of a padded slot carrying the bitcast per-token scales."""
        return 0 if self.quant is None else -(-self.max_m // self.ints_per_row)

    @property
    def splits_rows(self) -> int:
        """Trailing rows of a padded slot carrying the int32 counts."""
        return -(-self.experts_per_rank // self.ints_per_row)

    @property
    def slot_rows(self) -> int:
        """Rows of one padded slot: ``max_m`` token rows, the scale rows
        and the count rows."""
        return self.max_m + self.scale_rows + self.splits_rows


def create_all_to_all_context(mesh=None, axis: str = "tp", *, max_m, hidden,
                              experts_per_rank, dtype=torch.bfloat16,
                              quant=None, chunk_m=None) -> MoEAllToAllContext:
    """A :class:`MoEAllToAllContext` over ``mesh``'s ``axis`` (None: one
    rank), as JAX's ``create_all_to_all_context`` (``:168``) builds it;
    ``max_m`` is a peer's slot capacity. A token row of the wire dtype
    must be a whole number of int32 words (``ValueError``)."""
    n = 1 if mesh is None else one_axis(mesh, axis)
    return MoEAllToAllContext(n=n, max_m=max_m, hidden=hidden,
                              experts_per_rank=experts_per_rank, dtype=dtype,
                              quant=quant, chunk_m=chunk_m, mesh=mesh,
                              axis=axis)


def quantize_rows(ctx: MoEAllToAllContext, toks):
    """(..., H) → ((..., H) wire dtype, (...,) f32 per-token scales):
    symmetric, scale = amax / QMAX. The fp8 cast rounds to nearest
    even, as ``jnp.float8_e4m3fn`` does."""
    f = toks.float()
    amax = f.abs().amax(dim=-1)
    scale = div_scalar(torch.clamp(amax, min=1e-12), ctx.quant_max)
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


# ------------------------------------------------- the padded-slot transport

def _take(x, idx):
    """``x[..., idx[...], :]``: rows ``idx`` (..., T) of ``x`` (..., R, H),
    each leading index from its own ``x``."""
    lead = x.shape[:-2]
    flat = x.reshape(-1, *x.shape[-2:])
    i = idx.reshape(flat.shape[0], -1).long()
    b = torch.arange(flat.shape[0], device=x.device)[:, None]
    return flat[b, i].reshape(*lead, *idx.shape[len(lead):], x.shape[-1])


def _pack_splits(ctx: MoEAllToAllContext, spl):
    """(..., n, epr) int32 counts → (..., n, splits_rows, ints_per_row)."""
    pad = ctx.splits_rows * ctx.ints_per_row - ctx.experts_per_rank
    spl = torch.nn.functional.pad(spl.to(torch.int32), (0, pad))
    return spl.reshape(*spl.shape[:-1], ctx.splits_rows, ctx.ints_per_row)


def _toks_to_ints(ctx: MoEAllToAllContext, toks):
    """(..., H) wire dtype → (..., ints_per_row) int32, the same bytes."""
    return toks.contiguous().view(torch.int32)


def _ints_to_toks(ctx: MoEAllToAllContext, ints):
    """(..., ints_per_row) int32 → (..., H) wire dtype, the same bytes."""
    return ints.contiguous().view(ctx.wire_dtype)


def _pack_scales(ctx: MoEAllToAllContext, scale):
    """(..., n, max_m) f32 scales → (..., n, scale_rows, ints_per_row)."""
    ints = scale.float().contiguous().view(torch.int32)
    pad = ctx.scale_rows * ctx.ints_per_row - ctx.max_m
    ints = torch.nn.functional.pad(ints, (0, pad))
    return ints.reshape(*ints.shape[:-1], ctx.scale_rows, ctx.ints_per_row)


def _unpack_scales(ctx: MoEAllToAllContext, rows):
    """(..., n, scale_rows, ints_per_row) int32 → (..., n, max_m) f32."""
    flat = rows.reshape(*rows.shape[:-2], -1)[..., :ctx.max_m]
    return flat.contiguous().view(torch.float32)


def dispatch_stage(ctx: MoEAllToAllContext, tokens, splits):
    """Expert-sorted tokens (..., M, H) and their counts per global
    expert (..., E) → (per-peer slots (..., n, max_m, H) in ``ctx.dtype``,
    counts (..., n, epr) int32). Peer j's slot holds the tokens of its
    experts, the first ``max_m`` of them: past it a peer's tokens are
    dropped (JAX ``:218``)."""
    m_total = tokens.shape[-2]
    counts, offs = peer_offsets(ctx, splits)
    pos = torch.arange(ctx.max_m, dtype=torch.int32, device=tokens.device)
    idx = offs[..., :, None] + pos                       # (..., n, max_m)
    valid = pos < counts[..., :, None]
    rows = _take(tokens, torch.clamp(idx, 0, max(m_total - 1, 0)).reshape(
        *idx.shape[:-2], -1)).reshape(*idx.shape, tokens.shape[-1])
    toks = torch.where(valid[..., None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))
    spl = splits.reshape(*splits.shape[:-1], ctx.n, ctx.experts_per_rank)
    return toks.to(ctx.dtype), spl.to(torch.int32)


def pack_slots(ctx: MoEAllToAllContext, toks, spl):
    """(toks (..., n, max_m, H), counts (..., n, epr)) → one int32
    payload (..., n·slot_rows, ints_per_row): each slot's token rows in
    the wire dtype, with a quantized wire their per-token scales
    (:func:`quantize_rows`), then the counts (JAX ``:239``)."""
    if ctx.quant is None:
        parts = [_toks_to_ints(ctx, toks.to(ctx.dtype))]
    else:
        q, scale = quantize_rows(ctx, toks)
        parts = [_toks_to_ints(ctx, q), _pack_scales(ctx, scale)]
    parts.append(_pack_splits(ctx, spl))
    slots = torch.cat(parts, dim=-2)
    return slots.reshape(*slots.shape[:-3], ctx.n * ctx.slot_rows,
                         ctx.ints_per_row)


def fast_all_to_all(ctx: MoEAllToAllContext, send):
    """The padded-slot exchange: slot j of rank i → slot i of rank j.
    ``send``: every rank's payload stacked, (W, n·slot_rows,
    ints_per_row) int32 (at one rank, with or without the leading dim,
    it passes through)."""
    if ctx.mesh is None:
        return send
    return all_to_all_device(send, ctx.mesh, ctx.axis)


def _slot_tokens(ctx: MoEAllToAllContext, slots):
    toks = _ints_to_toks(ctx, slots[..., :ctx.max_m, :])
    if ctx.quant is None:
        return toks
    scales = _unpack_scales(
        ctx, slots[..., ctx.max_m:ctx.max_m + ctx.scale_rows, :])
    return dequantize_rows(ctx, toks, scales)


def recv_tokens_view(ctx: MoEAllToAllContext, recv):
    """A received payload (..., n·slot_rows, ints_per_row) → (tokens
    (..., n, max_m, H) in ``ctx.dtype``, dequantized with the in-slot
    scales; counts (..., n, epr), clamped by :func:`clamp_recv_splits`).
    Row i of the counts is source rank i's for this rank's experts."""
    slots = recv.reshape(*recv.shape[:-2], ctx.n, ctx.slot_rows,
                         ctx.ints_per_row)
    spl = slots[..., ctx.max_m + ctx.scale_rows:, :].reshape(
        *slots.shape[:-2], -1)[..., :ctx.experts_per_rank]
    return _slot_tokens(ctx, slots), clamp_recv_splits(ctx, spl)


def combine_stage(ctx: MoEAllToAllContext, toks):
    """Processed token slots (..., n, max_m, H) → the return leg's int32
    payload, its count rows zero (the combiner knows its own counts)."""
    zero = torch.zeros((*toks.shape[:-2], ctx.experts_per_rank),
                       dtype=torch.int32, device=toks.device)
    return pack_slots(ctx, toks, zero)


def combine_unpack(ctx: MoEAllToAllContext, comb):
    """The return leg's payload → (..., n, max_m, H) ``ctx.dtype`` token
    slots (dequantized with the in-slot scales on a quantized wire)."""
    slots = comb.reshape(*comb.shape[:-2], ctx.n, ctx.slot_rows,
                         ctx.ints_per_row)
    return _slot_tokens(ctx, slots)


def combine_unstage(ctx: MoEAllToAllContext, toks, splits, m_total: int):
    """Token slots (..., n, max_m, H) back in expert-sorted order →
    (..., m_total, H): slot j holds this rank's tokens as processed by
    peer j; ``splits`` (..., E) this rank's own dispatch counts. Tokens
    past a peer's ``max_m`` were never shipped and come back as zeros."""
    lead = toks.shape[:-3]
    toks = toks.reshape(*lead, ctx.n * ctx.max_m, ctx.hidden)
    counts, offs = peer_offsets(ctx, splits)
    ends = torch.cumsum(counts, dim=-1, dtype=torch.int32)
    t = torch.arange(m_total, dtype=torch.int32, device=toks.device)
    j = torch.searchsorted(ends.contiguous(),
                           t.expand(*lead, m_total).contiguous(), right=True)
    j = torch.clamp(j, 0, ctx.n - 1)
    pos = t - offs.gather(-1, j)
    flat = j * ctx.max_m + torch.clamp(pos, 0, ctx.max_m - 1)
    out = _take(toks, flat)
    valid = (t < ends[..., -1:]) & (pos < ctx.max_m)
    return torch.where(valid[..., None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device))
