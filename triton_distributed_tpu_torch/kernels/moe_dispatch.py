"""Fused MoE dispatch/combine: the count-bounded chunked transport.

Port of ``triton_distributed_tpu/kernels/moe_dispatch.py``. Tokens are
staged once into aligned expert-sorted per-peer segments in the wire
dtype; the transport then ships each peer ``ceil(count / chunk)``
chunks of ``chunk`` rows plus a small int32 metadata block ([epr
counts, n_chunks, checksum][f32 scale bits of the peer's window rows]).
The geometry is the JAX package's exactly: the wire dtype's sublane
tile ``align`` (32 rows for a 1-byte wire), 64-row chunks. It is the
wire format, and keeping it lets the tests compare every intermediate
array with the JAX package's.

Two modes share the transport:

* **barrier mode**: a fresh receive pair per call (one window);
* **LL mode**: persistent double-buffered workspaces written in place,
  the window chosen by a parity that lives on the device, so no call
  reads a value back to the host.

The transport itself is :func:`chunked_a2a`: on a CUDA tensor it
launches the hand-written kernel of ``csrc/moe_dispatch.cu``, one launch
for every rank; on a CPU tensor it runs :func:`chunked_a2a_plain`.

With ``n`` ranks (a loopback mesh) every function here takes the ranks'
tensors stacked on a leading dim, so a step stages, routes and unpacks
all ranks with one op each; at one rank the leading dim may be left
out. Layout, one rank:

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
    """(counts, dense offs, aligned offs, sendk), each (..., n) int32:
    the aligned segment start and the chunk count of each peer, for
    ``splits`` (..., num_experts) (a leading dim: every rank's at once)."""
    a = align(ctx)
    counts, offs = ma.peer_offsets(ctx, splits)
    offs_al = exclusive_cumsum(-(-counts // a) * a)
    sendk = (-(-counts // chunk_rows(ctx))).to(torch.int32)
    return counts, offs, offs_al, sendk


def assignment_dest(ctx: ma.MoEAllToAllContext, sorted_experts, offs,
                    offs_al):
    """(peer (..., T), dest (..., T)) int32: target rank and aligned
    payload row of each expert-sorted assignment."""
    t = torch.arange(sorted_experts.shape[-1], dtype=torch.int32,
                     device=sorted_experts.device)
    peer = torch.clamp(sorted_experts // ctx.experts_per_rank, 0,
                       ctx.n - 1).long()
    dest = offs_al.gather(-1, peer) + (t - offs.gather(-1, peer))
    return peer.to(torch.int32), dest.to(torch.int32)


def _take_rows(x, idx):
    """Rows ``idx`` (..., T) of ``x`` (..., R, H), each leading index
    from its own ``x``."""
    if x.dim() == 2:
        return x[idx]
    lead = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[lead, idx]


def stage_aligned(ctx: ma.MoEAllToAllContext, x, src_row, dest, n_valid):
    """Gather rows of ``x`` into the aligned layout in the wire dtype →
    ((..., m_cap, hidden) tokens, (..., m_cap) f32 scales or None).

    ``x`` (..., R, H); ``src_row`` (..., T): source row per assignment;
    ``dest`` (..., T): aligned payload row (:func:`assignment_dest`);
    ``n_valid`` (...,): the count of valid assignments (a tensor or an
    int; those past it write nothing). Unassigned rows are zero."""
    cap = m_cap(ctx)
    dev = x.device
    t = torch.arange(src_row.shape[-1], device=dev)
    nv = torch.as_tensor(n_valid, device=dev)[..., None]
    val = torch.where(t < nv, src_row.to(torch.int32), -1)
    # JAX drops out-of-bounds scatters: such a dest lands in the extra
    # slot at ``cap``, which is cut off
    idx = torch.where((dest >= 0) & (dest < cap), dest.long(), cap)
    inv = torch.full((*val.shape[:-1], cap + 1), -1, dtype=torch.int32,
                     device=dev)
    inv.scatter_(-1, idx, val)
    inv = inv[..., :cap]
    ok = (inv >= 0)[..., None]
    rows = _take_rows(x, torch.clamp(inv, 0, x.shape[-2] - 1).long())
    rows = torch.where(ok, rows, torch.zeros((), dtype=x.dtype, device=dev))
    if ctx.quant is None:
        return rows.to(ctx.dtype), None
    q, scale = ma.quantize_rows(ctx, rows)
    return q, scale.float()


def _pack_scale_rows(ctx, scale2d):
    """(..., n, slot_pad) f32 → (..., n, ceil(slot_pad/128), 128) int32
    bit patterns."""
    sp = slot_pad(ctx)
    pad = -(-sp // META_W) * META_W - sp
    s = torch.nn.functional.pad(scale2d.float(), (0, pad))
    return s.contiguous().view(torch.int32).reshape(*scale2d.shape[:-1], -1,
                                                    META_W)


def _mul32(a, b: int):
    """(a · b) mod 2^32 for int64 ``a`` in [0, 2^32) without leaving
    int64: the high half's product only matters in its low 16 bits."""
    lo, hi = a & 0xFFFF, a >> 16
    return (lo * b + (((hi * b) & 0xFFFF) << 16)) & _M32


def _head_checksum(head):
    """(..., epr+1) int32 [counts, n_chunks] → (...,) int32: the JAX
    package's FNV-style word mix in wrapping uint32, computed in int64
    masked to 32 bits and reinterpreted."""
    v = head.long() & _M32
    i = torch.arange(v.shape[-1], dtype=torch.int64, device=head.device)
    key = _mul32(i, 0x9E3779B9)
    h = _mul32(v ^ key, 0x85EBCA6B).sum(dim=-1) & _M32
    h = h ^ (h >> 15)
    return torch.where(h >= 2 ** 31, h - 2 ** 32, h).to(torch.int32)


def _pack_meta(ctx, head, scale2d):
    """(..., n, epr+1) head → its checksum appended, padded into the
    leading count rows; ``scale2d`` (..., n, slot_pad) f32 or None into
    the scale rows; zeros up to meta_rows → (..., n, meta_rows, 128)
    int32."""
    cnt_rows = _cnt_rows(ctx)
    lead = head.shape[:-1]
    head = torch.cat([head.to(torch.int32), _head_checksum(head)[..., None]],
                     dim=-1)
    pad = cnt_rows * META_W - head.shape[-1]
    parts = [torch.nn.functional.pad(head, (0, pad)).reshape(
        *lead, cnt_rows, META_W)]
    if scale2d is not None:
        parts.append(_pack_scale_rows(ctx, scale2d))
    used = sum(p.shape[-2] for p in parts)
    tail = meta_rows(ctx) - used
    if tail:
        parts.append(torch.zeros((*lead, tail, META_W), dtype=torch.int32,
                                 device=head.device))
    return torch.cat(parts, dim=-2)


def meta_payload(ctx: ma.MoEAllToAllContext, splits, scales, offs_al, sendk):
    """(..., n, meta_rows, 128) int32 per-peer metadata: [epr counts,
    n_chunks, checksum][f32 scale bits of the peer's window rows]."""
    lead = splits.shape[:-1]
    spl = splits.reshape(*lead, ctx.n, ctx.experts_per_rank).to(torch.int32)
    head = torch.cat([spl, sendk.to(torch.int32)[..., None]], dim=-1)
    scale2d = None
    if ctx.quant is not None:
        j = torch.arange(slot_pad(ctx), dtype=torch.int64,
                         device=splits.device)
        idx = offs_al.long()[..., None] + j
        idx = torch.clamp(idx, 0, scales.shape[-1] - 1)
        scale2d = scales.gather(-1, idx.reshape(*lead, -1)).reshape(
            idx.shape)
    return _pack_meta(ctx, head, scale2d)


def _parse_meta(ctx: ma.MoEAllToAllContext, meta, lead=()):
    """The ``lead`` ranks' metadata windows (n·meta_rows·128 int32 a
    rank, in any shape) → ((*lead, n, epr) clamped counts, (*lead, n,
    slot_pad) f32 scales or None). The JAX package's debug checksum
    verification is not ported."""
    slots = meta.reshape(*lead, ctx.n, meta_rows(ctx), META_W)
    cnt_rows = _cnt_rows(ctx)
    flat = slots[..., :cnt_rows, :].reshape(*lead, ctx.n, -1)
    rspl = ma.clamp_recv_splits(ctx, flat[..., :ctx.experts_per_rank])
    scales = None
    if ctx.quant is not None:
        sc = slots[..., cnt_rows:, :].reshape(*lead, ctx.n, -1)
        scales = sc[..., :slot_pad(ctx)].contiguous().view(torch.float32)
    return rspl, scales


def recv_view(ctx: ma.MoEAllToAllContext, recv_tok, recv_meta):
    """Receiver unpack → ((..., n, slot_pad, H) ``ctx.dtype`` tokens,
    (..., n, epr) clamped counts). Rows past a slot's count are whatever
    the window held; the counts mask them."""
    lead = recv_tok.shape[:-2]
    rspl, scales = _parse_meta(ctx, recv_meta, lead)
    toks = recv_tok.reshape(*lead, ctx.n, slot_pad(ctx), ctx.hidden)
    if ctx.quant is not None:
        toks = ma.dequantize_rows(ctx, toks, scales)
    return toks.to(ctx.dtype), rspl


def stage_return(ctx: ma.MoEAllToAllContext, y):
    """(..., n, slot_pad, H) processed rows → ((..., n·slot_pad, H) wire
    tokens, (..., n, meta_rows, 128) int32 metadata) for the combine
    leg: a zero head with a valid checksum, and the scales."""
    sp = slot_pad(ctx)
    lead = y.shape[:-3]
    zero_head = torch.zeros((*lead, ctx.n, ctx.experts_per_rank + 1),
                            dtype=torch.int32, device=y.device)
    if ctx.quant is None:
        toks = y.to(ctx.dtype).reshape(*lead, ctx.n * sp, ctx.hidden)
        return toks, _pack_meta(ctx, zero_head, None)
    q, scale = ma.quantize_rows(ctx, y)                 # scale: (..., n, sp)
    return (q.reshape(*lead, ctx.n * sp, ctx.hidden),
            _pack_meta(ctx, zero_head, scale))


def combine_view(ctx: ma.MoEAllToAllContext, comb_tok, comb_meta, peer, dest,
                 offs_al, n_valid):
    """Combine-leg unpack → (..., T, H) ``ctx.dtype`` rows in the sorted
    assignment order, zeros for assignments past ``n_valid`` (...,).
    Assignment t, dispatched to peer p at aligned row dest[t], comes
    back in combine slot p at window row dest[t] − offs_al[p]."""
    sp = slot_pad(ctx)
    lead = comb_tok.shape[:-2]
    _, scales = _parse_meta(ctx, comb_meta, lead)
    toks = comb_tok.reshape(*lead, ctx.n, sp, ctx.hidden)
    if ctx.quant is not None:
        toks = ma.dequantize_rows(ctx, toks, scales)
    toks = toks.reshape(*lead, ctx.n * sp, ctx.hidden).to(ctx.dtype)
    p = peer.long()
    row = p * sp + dest.long() - offs_al.long().gather(-1, p)
    rows = _take_rows(toks, torch.clamp(row, 0, toks.shape[-2] - 1))
    t = torch.arange(dest.shape[-1], device=dest.device)
    nv = torch.as_tensor(n_valid, device=dest.device)[..., None]
    return torch.where((t < nv)[..., None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))


# ------------------------------------------------------------- the transport

#: the transport's per-rank operands, in the order of the C entry's peer
#: tables: sender side payload, meta, offs, sendk; receiver side recvk,
#: dst_tok, dst_meta
_OPERANDS = ("payload", "meta", "offs", "sendk", "recvk", "dst_tok",
             "dst_meta")
#: per-rank dims of each operand
_NDIM = dict(payload=2, meta=2, offs=1, sendk=1, recvk=1, dst_tok=2,
             dst_meta=2)
#: the most ranks one launch takes (the kernel's by-value peer tables)
MAX_RANKS = 8


def _stacked(ctx, name, t):
    """``t`` as a (n, *per-rank) tensor: every rank's tensor stacked on a
    leading dim (as the ops layer makes them), a list of n per-rank
    shards that are views of one allocation, or at one rank the rank's
    own tensor."""
    from triton_distributed_tpu_torch.lang.shmem import require_stacked

    if isinstance(t, (list, tuple)):
        if len(t) != ctx.n:
            raise ValueError(f"{name}: {len(t)} shards for n={ctx.n} ranks")
        t = require_stacked(list(t), f"the chunked all-to-all's {name}")
    if t.dim() == _NDIM[name]:
        if ctx.n != 1:
            raise NotImplementedError(
                f"the chunked all-to-all at n={ctx.n} got one rank's {name}"
                ": it takes every rank's tensors stacked on a leading dim "
                "(one launch for all ranks of the loopback mesh); per-rank "
                "tensors of their own come with the mesh over several GPUs "
                "(ROADMAP Queue 1 item 11)")
        return t[None]
    if t.dim() != _NDIM[name] + 1 or t.shape[0] != ctx.n:
        raise ValueError(f"{name} shape {tuple(t.shape)} is not {ctx.n} "
                         f"ranks of {_NDIM[name]}-d tensors")
    return t


def _check_transport(ctx, ops, parity):
    """``ops``: the stacked operands by name. Returns the window count."""
    n, wire = ctx.n, ctx.wire_dtype
    sp, mr = slot_pad(ctx), meta_rows(ctx)
    if n > MAX_RANKS:
        raise ValueError(f"the chunked all-to-all takes at most {MAX_RANKS} "
                         f"ranks, got {n}")
    payload, dst_tok, dst_meta = ops["payload"], ops["dst_tok"], ops[
        "dst_meta"]
    if payload.dtype != wire or dst_tok.dtype != wire:
        raise ValueError(f"payload and window must be {wire}, got "
                         f"{payload.dtype} and {dst_tok.dtype}")
    if payload.shape[2] != ctx.hidden:
        raise ValueError(f"payload shape {tuple(payload.shape)}")
    windows = dst_tok.shape[1] // (n * sp)
    if (windows not in (1, 2)
            or dst_tok.shape != (n, windows * n * sp, ctx.hidden)
            or dst_meta.shape != (n, windows * n * mr, META_W)):
        raise ValueError(
            f"window shapes {tuple(dst_tok.shape)}, {tuple(dst_meta.shape)}"
            f" are not 1 or 2 windows of ({n * sp}, {ctx.hidden}) and "
            f"({n * mr}, {META_W}) a rank")
    if ops["meta"].shape != (n, n * mr, META_W):
        raise ValueError(f"meta shape {tuple(ops['meta'].shape)}")
    for name in ("meta", "dst_meta", "offs", "sendk", "recvk"):
        if ops[name].dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {ops[name].dtype}")
    for name in ("offs", "sendk", "recvk"):
        if ops[name].shape != (n, n):
            raise ValueError("offs, sendk and recvk must be (n,) a rank")
    if parity.dtype != torch.int32 or parity.shape != (1,):
        raise ValueError("parity must be one int32")
    return windows


def _geometry(ctx):
    a = align(ctx)
    return a, chunk_rows(ctx) // a, slot_pad(ctx) // a, meta_rows(ctx), \
        n_chunks_max(ctx)


def _count_at(ctx):
    """(row, lane) of the chunk count in a metadata block."""
    return divmod(ctx.experts_per_rank, META_W)


def _transport_args(ctx, payload, meta, offs_u, sendk, recvk, dst_tok,
                    dst_meta):
    args = dict(zip(_OPERANDS, (payload, meta, offs_u, sendk, recvk,
                                dst_tok, dst_meta)))
    return {k: _stacked(ctx, k, v) for k, v in args.items()}


def chunked_a2a_plain(ctx, payload, meta, offs_u, sendk, recvk, dst_tok,
                      dst_meta, parity, know_recv: bool = False):
    """Plain PyTorch version of :func:`chunked_a2a` (same signature and
    in-place effect): the same copies with tensor indexing, receiver by
    receiver and slot by slot. It reads the counts back to the host."""
    ops = _transport_args(ctx, payload, meta, offs_u, sendk, recvk, dst_tok,
                          dst_meta)
    windows = _check_transport(ctx, ops, parity)
    a, chunk_u, slot_u, mr, kmax = _geometry(ctx)
    n = ctx.n
    row, lane = _count_at(ctx)
    par = min(max(int(parity[0]), 0), windows - 1)
    src_b = ops["payload"].view(torch.uint8)
    dst_b = ops["dst_tok"].view(torch.uint8)
    meta_s, dmeta = ops["meta"], ops["dst_meta"]
    for r in range(n):
        for p in range(n):
            if p == r:
                k = int(ops["sendk"][p, r])
            elif know_recv:
                k = int(ops["recvk"][r, p])
            else:
                k = int(meta_s[p, r * mr + row, lane])
            k = min(max(k, 0), kmax)
            src0 = max(int(ops["offs"][p, r]), 0) * a
            rows = max(min(k * chunk_u * a, src_b.shape[1] - src0), 0)
            slot = par * n + p
            dst0 = slot * slot_u * a
            dst_b[r, dst0:dst0 + rows] = src_b[p, src0:src0 + rows]
            dmeta[r, slot * mr:(slot + 1) * mr] = meta_s[p, r * mr:
                                                          (r + 1) * mr]
    return dst_tok, dst_meta


def chunked_a2a(ctx, payload, meta, offs_u, sendk, recvk, dst_tok, dst_meta,
                parity, know_recv: bool = False):
    """Count-bounded chunked exchange among the ``ctx.n`` ranks, in
    place (the TPU's ``_chunked_a2a_kernel``).

    Every per-rank operand is the ranks' tensors stacked on a leading
    dim (at one rank the rank's own tensor may be given as is): the
    senders' ``payload`` (m_cap, hidden) wire rows, ``meta`` (n·meta_rows,
    128) int32 blocks, ``offs_u`` / ``sendk`` (n,) int32 (offs in
    ``align``-row units), and the receivers' ``recvk`` (n,) int32 and
    windows ``dst_tok`` (windows·n·slot_pad, hidden) / ``dst_meta``
    (windows·n·meta_rows, 128). Receiver r's slot p in window
    ``parity[0]`` (a (1,) int32 device tensor shared by the ranks) gets
    k chunks of ``chunk_rows`` rows from sender p's payload row
    ``offs_p[r]·align``, and p's metadata block for r; every other row
    keeps what it held. k is ``sendk_r[r]`` in r's own slot, else the
    count in p's metadata block for r (the dispatch leg), or
    ``recvk_r[p]`` with ``know_recv`` (the combine leg: what r
    dispatched to p comes back). Counts, offsets and the parity are read
    on the device. Returns ``(dst_tok, dst_meta)``.

    On a CPU tensor this is :func:`chunked_a2a_plain`; on a CUDA tensor
    it launches the kernel (one launch for every rank) or raises."""
    first = payload if torch.is_tensor(payload) else payload[0]
    if first.device.type == "cpu":
        return chunked_a2a_plain(ctx, payload, meta, offs_u, sendk, recvk,
                                 dst_tok, dst_meta, parity, know_recv)
    return _chunked_a2a_cuda(ctx, payload, meta, offs_u, sendk, recvk,
                             dst_tok, dst_meta, parity, know_recv)


def _chunked_a2a_cuda(ctx, payload, meta, offs_u, sendk, recvk, dst_tok,
                      dst_meta, parity, know_recv):
    import ctypes

    from triton_distributed_tpu_torch.kernels import _build

    ops = _transport_args(ctx, payload, meta, offs_u, sendk, recvk, dst_tok,
                          dst_meta)
    windows = _check_transport(ctx, ops, parity)
    dev = ops["payload"].device
    for t in (*ops.values(), parity):
        if t.device != dev:
            raise ValueError(f"tensor on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError("chunked_a2a's CUDA kernel needs contiguous "
                             "tensors")
    a, chunk_u, slot_u, mr, kmax = _geometry(ctx)
    row, lane = _count_at(ctx)
    # the peer tables, host side: each operand's per-rank data pointers,
    # passed by value in the launch's parameters
    ptrs = [t.data_ptr() + r * t.stride(0) * t.element_size()
            for t in ops.values() for r in range(ctx.n)]
    tables = (ctypes.c_ulonglong * len(ptrs))(*ptrs)
    fn = _build.function("tdt_chunked_a2a", "pp" + "i" * 12 + "p")
    rc = fn(ctypes.cast(tables, ctypes.c_void_p), _build.ptr(parity), ctx.n,
            a, chunk_u, slot_u, mr, kmax, row, lane,
            ctx.hidden * ctx.wire_itemsize, ops["payload"].shape[1], windows,
            int(know_recv), _build.stream(dev))
    _build.check(rc, "tdt_chunked_a2a")
    if ctx.n == 1:
        _chunked_a2a_cuda.launches += 1
    else:
        _chunked_a2a_cuda.launches_mesh += 1
    return dst_tok, dst_meta


#: launch counts of the kernel (plain ints on the wrapper): at one rank,
#: and over a mesh (each launch covers every rank)
_chunked_a2a_cuda.launches = 0
_chunked_a2a_cuda.launches_mesh = 0


def _zero_n(ctx, lead, dev):
    return torch.zeros((*lead, ctx.n), dtype=torch.int32, device=dev)


def _zero_parity(dev):
    return torch.zeros((1,), dtype=torch.int32, device=dev)


def _fresh_window(ctx, lead, dev):
    return (torch.empty((*lead, ctx.n * slot_pad(ctx), ctx.hidden),
                        dtype=ctx.wire_dtype, device=dev),
            torch.empty((*lead, ctx.n * meta_rows(ctx), META_W),
                        dtype=torch.int32, device=dev))


def _slot_offs(ctx, lead, dev):
    offs = (torch.arange(ctx.n, dtype=torch.int32, device=dev)
            * slot_pad(ctx)) // align(ctx)
    return offs.expand(*lead, ctx.n).contiguous()


def dispatch_device(ctx: ma.MoEAllToAllContext, payload, offs_al, sendk,
                    meta_pl):
    """Dispatch, barrier mode: ``payload`` (..., m_cap, hidden) wire-dtype
    aligned segments, ``offs_al``/``sendk`` (..., n) from
    :func:`send_plan`, ``meta_pl`` (..., n, meta_rows, 128) from
    :func:`meta_payload` (a leading dim: every rank's) → a fresh
    (recv_tok (..., n·slot_pad, hidden), recv_meta (..., n·meta_rows,
    128)) for :func:`recv_view`."""
    dev, lead = payload.device, payload.shape[:-2]
    tok, meta = _fresh_window(ctx, lead, dev)
    return chunked_a2a(
        ctx, payload, meta_pl.reshape(*lead, -1, META_W),
        (offs_al // align(ctx)).to(torch.int32), sendk.to(torch.int32),
        _zero_n(ctx, lead, dev), tok, meta, _zero_parity(dev))


def combine_device(ctx: ma.MoEAllToAllContext, y_tok, y_meta, retk, expk):
    """Combine, barrier mode: static slot offsets (slot p returns whole
    to source p, ``retk[p]`` chunks) and known receive counts
    (``expk``, the chunks dispatched to each peer)."""
    dev, lead = y_tok.device, y_tok.shape[:-2]
    tok, meta = _fresh_window(ctx, lead, dev)
    return chunked_a2a(
        ctx, y_tok, y_meta.reshape(*lead, -1, META_W),
        _slot_offs(ctx, lead, dev), retk.to(torch.int32),
        expk.to(torch.int32), tok, meta, _zero_parity(dev), know_recv=True)


def dispatch_ll_device(ctx: ma.MoEAllToAllContext, payload, offs_al, sendk,
                       meta_pl, parity, ws_tok, ws_meta):
    """Dispatch, LL mode: written in place into window ``parity`` (a
    (1,) int32 device tensor) of the persistent workspaces ``ws_tok``
    (..., 2·n·slot_pad, hidden) and ``ws_meta`` (..., 2·n·meta_rows,
    128). Returns the same workspaces; read the window with
    :func:`ll_window`."""
    dev, lead = payload.device, payload.shape[:-2]
    return chunked_a2a(
        ctx, payload, meta_pl.reshape(*lead, -1, META_W),
        (offs_al // align(ctx)).to(torch.int32), sendk.to(torch.int32),
        _zero_n(ctx, lead, dev), ws_tok, ws_meta, parity)


def combine_ll_device(ctx: ma.MoEAllToAllContext, y_tok, y_meta, retk, expk,
                      parity, ws_tok, ws_meta):
    """Combine, LL mode (see :func:`combine_device` and
    :func:`dispatch_ll_device`)."""
    dev, lead = y_tok.device, y_tok.shape[:-2]
    return chunked_a2a(
        ctx, y_tok, y_meta.reshape(*lead, -1, META_W),
        _slot_offs(ctx, lead, dev), retk.to(torch.int32),
        expk.to(torch.int32), ws_tok, ws_meta, parity, know_recv=True)


def ll_window(ctx: ma.MoEAllToAllContext, ws_tok, ws_meta, parity):
    """The window ``parity`` of the LL workspaces (..., 2·n·slot_pad, H)
    and (..., 2·n·meta_rows, 128) → (recv_tok (..., n·slot_pad, H),
    recv_meta (..., n·meta_rows, 128)). The parity stays on the device,
    so this is a gather (a copy of one window), not a view. The token
    window is gathered as bytes (fp8 has no CPU gather)."""
    p = parity.long()
    raw = ws_tok.view(torch.uint8)
    lead = raw.shape[:-2]
    d = len(lead)
    tok = raw.reshape(*lead, 2, -1, raw.shape[-1]).index_select(d, p)
    meta = ws_meta.reshape(*lead, 2, -1, META_W).index_select(d, p)
    return tok.squeeze(d).view(ws_tok.dtype), meta.squeeze(d)


def ll_workspace_shapes(ctx: ma.MoEAllToAllContext):
    """LL workspace shapes of one rank: ((2·n·slot_pad, hidden), wire
    dtype) and ((2·n·meta_rows, 128), int32)."""
    return (
        ((2 * ctx.n * slot_pad(ctx), ctx.hidden), ctx.wire_dtype),
        ((2 * ctx.n * meta_rows(ctx), META_W), torch.int32),
    )


def wire_rows(ctx: ma.MoEAllToAllContext, splits):
    """(..., n) payload rows put on the wire per peer, for each leg."""
    _, _, _, sendk = send_plan(ctx, splits)
    return sendk * chunk_rows(ctx)
