"""Fused MoE dispatch/combine: the count-bounded chunked transport.

Port of ``triton_distributed_tpu/kernels/moe_dispatch.py`` at EP world
size 1. Tokens are staged once into aligned expert-sorted per-peer
segments in the wire dtype; the transport then ships each peer
``ceil(count / chunk)`` chunks of ``chunk`` rows plus a small int32
metadata block ([epr counts, n_chunks, checksum][f32 scale bits of the
peer's window rows]). The geometry is the JAX package's exactly: the
wire dtype's sublane tile ``align`` (32 rows for a 1-byte wire), 64-row
chunks. It is the wire format, and keeping it lets the tests compare
every intermediate array with the JAX package's.

Two modes share the transport:

* **barrier mode**: a fresh receive pair per call (one window);
* **LL mode**: persistent double-buffered workspaces written in place,
  the window chosen by a parity that lives on the device, so no call
  reads a value back to the host.

The transport itself is :func:`chunked_a2a`: on a CUDA tensor it
launches the hand-written kernel of ``csrc/moe_dispatch.cu``; on a CPU
tensor it runs :func:`chunked_a2a_plain`. Both are written for one
rank (the peer loop over symmetric memory comes with the collectives)
and raise for ``n > 1``.

Layout, one rank:

* sender payload: (m_cap, hidden) wire dtype, aligned segments;
* sender meta: (n·meta_rows, 128) int32;
* receiver: tokens (windows·n·slot_pad, hidden) and meta
  (windows·n·meta_rows, 128); rows past the shipped chunks keep what
  they held (masked by the counts downstream).
"""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.kernels import moe_all_to_all as ma
from triton_distributed_tpu_torch.kernels.moe_utils import exclusive_cumsum

META_W = 128  # metadata lane width (int32 words per row)

_M32 = 0xFFFFFFFF


def _cnt_rows(ctx) -> int:
    """Leading metadata rows holding [epr counts, n_chunks, checksum]."""
    return -(-(ctx.experts_per_rank + 2) // META_W)


def align(ctx: ma.MoEAllToAllContext) -> int:
    """Segment-start granule: the wire dtype's sublane tile (8 rows per
    int32 of packing: 32 for a 1-byte wire, 16 for bf16, 8 for f32)."""
    return 8 * (4 // ctx.wire_itemsize)


def chunk_rows(ctx: ma.MoEAllToAllContext) -> int:
    """Transport granule in rows: ``chunk_m``, else max(tile, 64)
    (the tile alone when ``max_m < 64``)."""
    a = align(ctx)
    if ctx.chunk_m is not None:
        if ctx.chunk_m % a or ctx.chunk_m <= 0:
            raise ValueError(
                f"chunk_m={ctx.chunk_m} must be a positive multiple of the "
                f"wire sublane tile {a}")
        return ctx.chunk_m
    if ctx.max_m < 64:
        return a
    return max(a, 64)


def n_chunks_max(ctx: ma.MoEAllToAllContext) -> int:
    return -(-ctx.max_m // chunk_rows(ctx))


def slot_pad(ctx: ma.MoEAllToAllContext) -> int:
    """Per-peer receive capacity in rows: all ``max_m`` assignments to
    one peer, rounded to whole chunks."""
    return n_chunks_max(ctx) * chunk_rows(ctx)


def meta_rows(ctx: ma.MoEAllToAllContext) -> int:
    """Per-slot int32 metadata rows ([counts, n_chunks, checksum] then
    the scales), padded to 8."""
    sc_rows = 0 if ctx.quant is None else -(-slot_pad(ctx) // META_W)
    return -(-(_cnt_rows(ctx) + sc_rows) // 8) * 8


def m_cap(ctx: ma.MoEAllToAllContext) -> int:
    """Sender payload rows: the aligned total plus one tile per peer and
    one chunk of overhang, so every chunk read stays inside."""
    a = align(ctx)
    return -(-ctx.max_m // a) * a + a * ctx.n + chunk_rows(ctx)


def send_plan(ctx: ma.MoEAllToAllContext, splits):
    """(counts, dense offs, aligned offs, sendk), each (n,) int32: the
    aligned segment start and the chunk count of each peer."""
    a = align(ctx)
    counts, offs = ma.peer_offsets(ctx, splits)
    offs_al = exclusive_cumsum(-(-counts // a) * a)
    sendk = (-(-counts // chunk_rows(ctx))).to(torch.int32)
    return counts, offs, offs_al, sendk


def assignment_dest(ctx: ma.MoEAllToAllContext, sorted_experts, offs,
                    offs_al):
    """(peer (T,), dest (T,)) int32: target rank and aligned payload row
    of each expert-sorted assignment."""
    t = torch.arange(sorted_experts.shape[0], dtype=torch.int32,
                     device=sorted_experts.device)
    peer = torch.clamp(sorted_experts // ctx.experts_per_rank, 0,
                       ctx.n - 1).long()
    return peer.to(torch.int32), (offs_al[peer] + (t - offs[peer])).to(
        torch.int32)


def stage_aligned(ctx: ma.MoEAllToAllContext, x, src_row, dest, n_valid):
    """Gather rows of ``x`` into the aligned layout in the wire dtype →
    ((m_cap, hidden) tokens, (m_cap,) f32 scales or None).

    ``src_row`` (T,): source row per assignment; ``dest`` (T,): aligned
    payload row (:func:`assignment_dest`); ``n_valid``: the count of
    valid assignments (a 0-d tensor or an int; those past it write
    nothing). Unassigned rows are zero."""
    cap = m_cap(ctx)
    dev = x.device
    t = torch.arange(src_row.shape[0], device=dev)
    val = torch.where(t < n_valid, src_row.to(torch.int32), -1)
    # JAX drops out-of-bounds scatters: such a dest lands in the extra
    # slot at ``cap``, which is cut off
    idx = torch.where((dest >= 0) & (dest < cap), dest.long(), cap)
    inv = torch.full((cap + 1,), -1, dtype=torch.int32, device=dev)
    inv.scatter_(0, idx, val)
    inv = inv[:cap]
    ok = (inv >= 0)[:, None]
    rows = x[torch.clamp(inv, 0, x.shape[0] - 1).long()]
    rows = torch.where(ok, rows, torch.zeros((), dtype=x.dtype, device=dev))
    if ctx.quant is None:
        return rows.to(ctx.dtype), None
    q, scale = ma.quantize_rows(ctx, rows)
    return q, scale.float()


def _pack_scale_rows(ctx, scale2d):
    """(n, slot_pad) f32 → (n, ceil(slot_pad/128), 128) int32 bit
    patterns."""
    sp = slot_pad(ctx)
    pad = -(-sp // META_W) * META_W - sp
    s = torch.nn.functional.pad(scale2d.float(), (0, pad))
    return s.contiguous().view(torch.int32).reshape(ctx.n, -1, META_W)


def _mul32(a, b: int):
    """(a · b) mod 2^32 for int64 ``a`` in [0, 2^32) without leaving
    int64: the high half's product only matters in its low 16 bits."""
    lo, hi = a & 0xFFFF, a >> 16
    return (lo * b + (((hi * b) & 0xFFFF) << 16)) & _M32


def _head_checksum(head):
    """(n, epr+1) int32 [counts, n_chunks] → (n,) int32: the JAX
    package's FNV-style word mix in wrapping uint32, computed in int64
    masked to 32 bits and reinterpreted."""
    v = head.long() & _M32
    i = torch.arange(v.shape[1], dtype=torch.int64, device=head.device)
    key = _mul32(i, 0x9E3779B9)
    h = _mul32(v ^ key[None, :], 0x85EBCA6B).sum(dim=1) & _M32
    h = h ^ (h >> 15)
    return torch.where(h >= 2 ** 31, h - 2 ** 32, h).to(torch.int32)


def _pack_meta(ctx, head, scale2d):
    """(n, epr+1) head → its checksum appended, padded into the leading
    count rows; ``scale2d`` (n, slot_pad) f32 or None into the scale
    rows; zeros up to meta_rows → (n, meta_rows, 128) int32."""
    n, cnt_rows = ctx.n, _cnt_rows(ctx)
    head = torch.cat([head.to(torch.int32), _head_checksum(head)[:, None]],
                     dim=1)
    pad = cnt_rows * META_W - head.shape[1]
    parts = [torch.nn.functional.pad(head, (0, pad)).reshape(
        n, cnt_rows, META_W)]
    if scale2d is not None:
        parts.append(_pack_scale_rows(ctx, scale2d))
    used = sum(p.shape[1] for p in parts)
    tail = meta_rows(ctx) - used
    if tail:
        parts.append(torch.zeros((n, tail, META_W), dtype=torch.int32,
                                 device=head.device))
    return torch.cat(parts, dim=1)


def meta_payload(ctx: ma.MoEAllToAllContext, splits, scales, offs_al, sendk):
    """(n, meta_rows, 128) int32 per-peer metadata: [epr counts,
    n_chunks, checksum][f32 scale bits of the peer's window rows]."""
    spl = splits.reshape(ctx.n, ctx.experts_per_rank).to(torch.int32)
    head = torch.cat([spl, sendk.to(torch.int32)[:, None]], dim=1)
    scale2d = None
    if ctx.quant is not None:
        j = torch.arange(slot_pad(ctx), dtype=torch.int64,
                         device=splits.device)
        idx = offs_al.long()[:, None] + j[None, :]
        scale2d = scales[torch.clamp(idx, 0, scales.shape[0] - 1)]
    return _pack_meta(ctx, head, scale2d)


def _parse_meta(ctx: ma.MoEAllToAllContext, meta):
    """(n·meta_rows, 128) int32 → ((n, epr) clamped counts, (n, slot_pad)
    f32 scales or None). The JAX package's debug checksum verification
    is not ported."""
    slots = meta.reshape(ctx.n, meta_rows(ctx), META_W)
    cnt_rows = _cnt_rows(ctx)
    flat = slots[:, :cnt_rows].reshape(ctx.n, -1)
    rspl = ma.clamp_recv_splits(ctx, flat[:, :ctx.experts_per_rank])
    scales = None
    if ctx.quant is not None:
        sc = slots[:, cnt_rows:].reshape(ctx.n, -1)[:, :slot_pad(ctx)]
        scales = sc.contiguous().view(torch.float32)
    return rspl, scales


def recv_view(ctx: ma.MoEAllToAllContext, recv_tok, recv_meta):
    """Receiver unpack → ((n, slot_pad, H) ``ctx.dtype`` tokens, (n, epr)
    clamped counts). Rows past a slot's count are whatever the window
    held; the counts mask them."""
    rspl, scales = _parse_meta(ctx, recv_meta)
    toks = recv_tok.reshape(ctx.n, slot_pad(ctx), ctx.hidden)
    if ctx.quant is not None:
        toks = ma.dequantize_rows(ctx, toks, scales)
    return toks.to(ctx.dtype), rspl


def stage_return(ctx: ma.MoEAllToAllContext, y):
    """(n, slot_pad, H) processed rows → ((n·slot_pad, H) wire tokens,
    (n, meta_rows, 128) int32 metadata) for the combine leg: a zero head
    with a valid checksum, and the scales."""
    sp = slot_pad(ctx)
    zero_head = torch.zeros((ctx.n, ctx.experts_per_rank + 1),
                            dtype=torch.int32, device=y.device)
    if ctx.quant is None:
        toks = y.to(ctx.dtype).reshape(ctx.n * sp, ctx.hidden)
        return toks, _pack_meta(ctx, zero_head, None)
    q, scale = ma.quantize_rows(ctx, y)                 # scale: (n, sp)
    return q.reshape(ctx.n * sp, ctx.hidden), _pack_meta(ctx, zero_head,
                                                         scale)


def combine_view(ctx: ma.MoEAllToAllContext, comb_tok, comb_meta, peer, dest,
                 offs_al, n_valid):
    """Combine-leg unpack → (T, H) ``ctx.dtype`` rows in the sorted
    assignment order, zeros for assignments past ``n_valid``.
    Assignment t, dispatched to peer p at aligned row dest[t], comes
    back in combine slot p at window row dest[t] − offs_al[p]."""
    sp = slot_pad(ctx)
    _, scales = _parse_meta(ctx, comb_meta)
    toks = comb_tok.reshape(ctx.n, sp, ctx.hidden)
    if ctx.quant is not None:
        toks = ma.dequantize_rows(ctx, toks, scales)
    toks = toks.reshape(ctx.n * sp, ctx.hidden).to(ctx.dtype)
    p = peer.long()
    row = p * sp + dest.long() - offs_al.long()[p]
    rows = toks[torch.clamp(row, 0, toks.shape[0] - 1)]
    t = torch.arange(dest.shape[0], device=dest.device)
    return torch.where((t < n_valid)[:, None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))


# ------------------------------------------------------------- the transport

def _check_transport(ctx, payload, meta, offs_u, sendk, recvk, dst_tok,
                     dst_meta, parity):
    if ctx.n != 1:
        raise NotImplementedError(
            f"the chunked all-to-all is written for one rank (n={ctx.n}); "
            "the peer loop comes with the collectives")
    wire = ctx.wire_dtype
    sp, mr = slot_pad(ctx), meta_rows(ctx)
    if payload.dtype != wire or dst_tok.dtype != wire:
        raise ValueError(f"payload and window must be {wire}, got "
                         f"{payload.dtype} and {dst_tok.dtype}")
    if payload.ndim != 2 or payload.shape[1] != ctx.hidden:
        raise ValueError(f"payload shape {tuple(payload.shape)}")
    windows = dst_tok.shape[0] // (ctx.n * sp)
    if (windows not in (1, 2) or dst_tok.shape != (windows * ctx.n * sp,
                                                   ctx.hidden)
            or dst_meta.shape != (windows * ctx.n * mr, META_W)):
        raise ValueError(
            f"window shapes {tuple(dst_tok.shape)}, {tuple(dst_meta.shape)}"
            f" are not 1 or 2 windows of ({ctx.n * sp}, {ctx.hidden}) and "
            f"({ctx.n * mr}, {META_W})")
    if meta.shape != (ctx.n * mr, META_W):
        raise ValueError(f"meta shape {tuple(meta.shape)}")
    for name, t in (("meta", meta), ("dst_meta", dst_meta)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    for name, t in (("offs", offs_u), ("sendk", sendk), ("recvk", recvk),
                    ("parity", parity)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    if offs_u.shape != (ctx.n,) or sendk.shape != (ctx.n,) \
            or recvk.shape != (ctx.n,) or parity.shape != (1,):
        raise ValueError("offs, sendk and recvk must be (n,), parity (1,)")
    return windows


def _geometry(ctx):
    a = align(ctx)
    return a, chunk_rows(ctx) // a, slot_pad(ctx) // a, meta_rows(ctx), \
        n_chunks_max(ctx)


def chunked_a2a_plain(ctx, payload, meta, offs_u, sendk, recvk, dst_tok,
                      dst_meta, parity):
    """Plain PyTorch version of :func:`chunked_a2a` (same signature and
    in-place effect): the same copies with tensor indexing. It reads
    the counts back to the host."""
    windows = _check_transport(ctx, payload, meta, offs_u, sendk, recvk,
                               dst_tok, dst_meta, parity)
    a, chunk_u, slot_u, mr, kmax = _geometry(ctx)
    par = min(max(int(parity[0]), 0), windows - 1)
    k = min(max(int(sendk[0]), 0), kmax)
    src0 = max(int(offs_u[0]), 0) * a
    rows = max(min(k * chunk_u * a, payload.shape[0] - src0), 0)
    dst0 = par * ctx.n * slot_u * a
    src_b, dst_b = payload.view(torch.uint8), dst_tok.view(torch.uint8)
    dst_b[dst0:dst0 + rows] = src_b[src0:src0 + rows]
    dst_meta[par * ctx.n * mr:(par * ctx.n + 1) * mr] = meta[:mr]
    return dst_tok, dst_meta


def chunked_a2a(ctx, payload, meta, offs_u, sendk, recvk, dst_tok, dst_meta,
                parity):
    """Count-bounded chunked push, in place (the TPU's
    ``_chunked_a2a_kernel`` at world size 1).

    Copies ``sendk[0]`` chunks of ``chunk_rows`` rows from payload row
    ``offs_u[0]·align`` into window ``parity[0]`` of ``dst_tok``, and
    the ``meta_rows × 128`` metadata block into the same window of
    ``dst_meta``; every other row keeps what it held. ``offs_u`` is in
    ``align``-row units. ``recvk`` (the combine leg's known receive
    counts) drives the receiver's waits across ranks and has no use at
    one rank. ``parity``, ``offs_u`` and ``sendk`` are read on the
    device. Returns ``(dst_tok, dst_meta)``.

    On a CPU tensor this is :func:`chunked_a2a_plain`; on a CUDA tensor
    it launches the kernel or raises."""
    if payload.device.type == "cpu":
        return chunked_a2a_plain(ctx, payload, meta, offs_u, sendk, recvk,
                                 dst_tok, dst_meta, parity)
    return _chunked_a2a_cuda(ctx, payload, meta, offs_u, sendk, recvk,
                             dst_tok, dst_meta, parity)


def _chunked_a2a_cuda(ctx, payload, meta, offs_u, sendk, recvk, dst_tok,
                      dst_meta, parity):
    from triton_distributed_tpu_torch.kernels import _build

    windows = _check_transport(ctx, payload, meta, offs_u, sendk, recvk,
                               dst_tok, dst_meta, parity)
    dev = payload.device
    tensors = (payload, meta, offs_u, sendk, dst_tok, dst_meta, parity)
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensor on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError("chunked_a2a's CUDA kernel needs contiguous "
                             "tensors")
    a, chunk_u, slot_u, mr, kmax = _geometry(ctx)
    fn = _build.function("tdt_chunked_a2a", "ppppppp" + "i" * 9 + "p")
    rc = fn(_build.ptr(parity), _build.ptr(offs_u), _build.ptr(sendk),
            _build.ptr(payload), _build.ptr(meta), _build.ptr(dst_tok),
            _build.ptr(dst_meta), ctx.n, a, chunk_u, slot_u, mr, kmax,
            ctx.hidden * ctx.wire_itemsize, payload.shape[0], windows,
            _build.stream(dev))
    _build.check(rc, "tdt_chunked_a2a")
    _chunked_a2a_cuda.launches += 1
    return dst_tok, dst_meta


#: launch count of the kernel (a plain int on the wrapper)
_chunked_a2a_cuda.launches = 0


def _zero_n(ctx, dev):
    return torch.zeros((ctx.n,), dtype=torch.int32, device=dev)


def _fresh_window(ctx, dev):
    return (torch.empty((ctx.n * slot_pad(ctx), ctx.hidden),
                        dtype=ctx.wire_dtype, device=dev),
            torch.empty((ctx.n * meta_rows(ctx), META_W), dtype=torch.int32,
                        device=dev))


def _slot_offs(ctx, dev):
    return (torch.arange(ctx.n, dtype=torch.int32, device=dev)
            * slot_pad(ctx)) // align(ctx)


def dispatch_device(ctx: ma.MoEAllToAllContext, payload, offs_al, sendk,
                    meta_pl):
    """Dispatch, barrier mode: ``payload`` (m_cap, hidden) wire-dtype
    aligned segments, ``offs_al``/``sendk`` (n,) from :func:`send_plan`,
    ``meta_pl`` (n, meta_rows, 128) from :func:`meta_payload` →
    a fresh (recv_tok (n·slot_pad, hidden), recv_meta (n·meta_rows,
    128)) for :func:`recv_view`."""
    dev = payload.device
    tok, meta = _fresh_window(ctx, dev)
    return chunked_a2a(
        ctx, payload, meta_pl.reshape(-1, META_W),
        (offs_al // align(ctx)).to(torch.int32), sendk.to(torch.int32),
        _zero_n(ctx, dev), tok, meta, _zero_n(ctx, dev)[:1])


def combine_device(ctx: ma.MoEAllToAllContext, y_tok, y_meta, retk, expk):
    """Combine, barrier mode: static slot offsets (slot p returns whole
    to source p, ``retk[p]`` chunks) and known receive counts
    (``expk``, the chunks dispatched to each peer)."""
    dev = y_tok.device
    tok, meta = _fresh_window(ctx, dev)
    return chunked_a2a(
        ctx, y_tok, y_meta.reshape(-1, META_W), _slot_offs(ctx, dev),
        retk.to(torch.int32), expk.to(torch.int32), tok, meta,
        _zero_n(ctx, dev)[:1])


def dispatch_ll_device(ctx: ma.MoEAllToAllContext, payload, offs_al, sendk,
                       meta_pl, parity, ws_tok, ws_meta):
    """Dispatch, LL mode: written in place into window ``parity`` (a
    (1,) int32 device tensor) of the persistent workspaces ``ws_tok``
    (2·n·slot_pad, hidden) and ``ws_meta`` (2·n·meta_rows, 128). Returns
    the same workspaces; read the window with :func:`ll_window`."""
    return chunked_a2a(
        ctx, payload, meta_pl.reshape(-1, META_W),
        (offs_al // align(ctx)).to(torch.int32), sendk.to(torch.int32),
        _zero_n(ctx, payload.device), ws_tok, ws_meta, parity)


def combine_ll_device(ctx: ma.MoEAllToAllContext, y_tok, y_meta, retk, expk,
                      parity, ws_tok, ws_meta):
    """Combine, LL mode (see :func:`combine_device` and
    :func:`dispatch_ll_device`)."""
    return chunked_a2a(
        ctx, y_tok, y_meta.reshape(-1, META_W), _slot_offs(ctx, y_tok.device),
        retk.to(torch.int32), expk.to(torch.int32), ws_tok, ws_meta, parity)


def ll_window(ctx: ma.MoEAllToAllContext, ws_tok, ws_meta, parity):
    """The window ``parity`` of the LL workspaces → (recv_tok
    (n·slot_pad, H), recv_meta (n·meta_rows, 128)). The parity stays on
    the device, so this is a gather (a copy of one window), not a view.
    The token window is gathered as bytes (fp8 has no CPU gather)."""
    p = parity.long()
    raw = ws_tok.view(torch.uint8)
    tok = raw.reshape(2, -1, raw.shape[1]).index_select(0, p)[0]
    meta = ws_meta.reshape(2, -1, META_W).index_select(0, p)[0]
    return tok.view(ws_tok.dtype), meta


def ll_workspace_shapes(ctx: ma.MoEAllToAllContext):
    """LL workspace shapes: ((2·n·slot_pad, hidden), wire dtype) and
    ((2·n·meta_rows, 128), int32)."""
    return (
        ((2 * ctx.n * slot_pad(ctx), ctx.hidden), ctx.wire_dtype),
        ((2 * ctx.n * meta_rows(ctx), META_W), torch.int32),
    )


def wire_rows(ctx: ma.MoEAllToAllContext, splits):
    """(n,) payload rows put on the wire per peer, for each leg."""
    _, _, _, sendk = send_plan(ctx, splits)
    return sendk * chunk_rows(ctx)
