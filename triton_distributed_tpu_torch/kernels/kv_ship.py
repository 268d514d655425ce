"""KV page shipping: the prefill role's pool → the decode role's pool.

Port of ``triton_distributed_tpu/kernels/kv_ship.py``. Disaggregated
serving moves every finished prefill's KV pages to the decode role. The
pool's native form travels verbatim: int8 page payloads with their f32
per-row scale planes on a second rail under ``kv_quant`` (no
requantization, so a shipped request decodes token-exactly as if it had
prefilled on the decode side), else the raw pages.

* :func:`gather_kv_pages` / :func:`scatter_kv_pages` (JAX ``:59``,
  ``:82``): the pool ↔ payload plumbing, plain torch ops over the port's
  pools (``(npages, Hkv, page, D)`` tensors, int8 ``{"q", "scale"}``
  dicts under ``kv_quant``); the scatter writes the pools in place.
* :func:`ship_wire_bytes`, :data:`KV_SHIP_GEOM`,
  :func:`coalesced_landing_table`, :func:`coalesced_landing_ok` (JAX
  ``:104``, ``:204``, ``:207``, ``:222``).
* The ship. JAX's TPU kernel ``_kv_ship_kernel`` (``:117``) pushes each
  rank r's staged pages to rank (r + n/2) % n at the landing slots of a
  table, ``coalesce`` pages a tick, payload and scale plane on paired
  rails; JAX launches it only from its lint builder, and its engine
  ships over ``ppermute`` / ``device_put``. The port runs one CUDA
  kernel, ``tdt_kv_ship`` (``csrc/kv_ship.cu``), in two forms:
  :func:`kv_ship`, JAX's mesh layout (each rank's staged
  ``(pages·rows, cols)`` int8 and ``(pages·rows, SCALE_LANES)`` f32
  buffers → fresh buffers on the partner rank), and
  :func:`ship_kv_pages`, the engine's form: one launch lands a cohort's
  pages from the prefill role's per-layer pools straight into the decode
  role's, every pool and both rails (JAX's gather → transport → scatter
  in one pass). ``DisaggregatedEngine``'s ship is its user entry point.

The kernel copies page runs through a table of (pool, rail) base
pointers: bytes move unchanged whatever the dtype, and stream order is
the landing fence (nothing waits). On CPU tensors every entry runs
:func:`kv_ship_plain` (``index_select`` → ``index_copy_``); on CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from triton_distributed_tpu_torch.lang.wire import SCALE_LANES
from triton_distributed_tpu_torch.runtime.topology import one_axis
from triton_distributed_tpu_torch.tune.schedule import require_ship_schedule

#: lint geometry: 4 staged pages of 8 rows × 128 lanes, landing slots a
#: permutation of the whole destination buffer
KV_SHIP_GEOM = dict(pages=4, rows=8, cols=128)

#: the most (pool, rail) pairs one launch covers (the grid's y extent)
MAX_PAIRS = 65535


# ------------------------------------------------------ pool ↔ payload

def _pool_ids(pids, device):
    return torch.as_tensor(np.asarray(pids, np.int64), device=device)


def gather_kv_pages(layers, pids):
    """Pull pages ``pids`` (P,) out of every layer's K and V pool:
    ``(q (L·2, P, Hkv, page, D) in the pool dtype, s (L·2, P, Hkv, page)
    f32 or None)`` — None for unquantized pools (the raw wire)."""
    qs, ss = [], []
    for kp, vp in layers:
        for pool in (kp, vp):
            if isinstance(pool, dict):
                ids = _pool_ids(pids, pool["q"].device)
                qs.append(pool["q"].index_select(0, ids))
                ss.append(pool["scale"].index_select(0, ids))
            else:
                qs.append(pool.index_select(0, _pool_ids(pids, pool.device)))
    return torch.stack(qs), (torch.stack(ss) if ss else None)


def scatter_kv_pages(layers, pids, q_payload, s_payload):
    """Inverse of :func:`gather_kv_pages`: land the payload in the pools
    at page slots ``pids`` — in place (JAX donates the pools to the same
    end). Returns ``layers``."""
    i = 0
    for kp, vp in layers:
        for pool in (kp, vp):
            if isinstance(pool, dict):
                ids = _pool_ids(pids, pool["q"].device)
                pool["q"].index_copy_(0, ids, q_payload[i])
                pool["scale"].index_copy_(0, ids, s_payload[i])
            else:
                pool.index_copy_(0, _pool_ids(pids, pool.device), q_payload[i])
            i += 1
    return layers


def ship_wire_bytes(n_pages: int, page: int, hkv: int, d: int,
                    n_layers: int, quant: bool = True) -> int:
    """Bytes one request's KV ship puts on the wire: K and V pages for
    every layer — 1 B/element int8 payload plus the per-row f32 scale
    planes under ``kv_quant``, else the raw 2 B/element pages."""
    per_page = hkv * page * d * (1 if quant else 2)
    if quant:
        per_page += hkv * page * 4          # the per-row scale plane
    return n_layers * 2 * n_pages * per_page


def coalesced_landing_table(pages: int, coalesce: int) -> list:
    """A landing permutation every coalescing width can drive:
    consecutive staged pages within a tick land at consecutive slots,
    tick groups reversed (``coalesce=1``: the fully reversed table)."""
    ticks = pages // coalesce
    return [p for blk in reversed(range(ticks))
            for p in range(blk * coalesce, (blk + 1) * coalesce)]


def coalesced_landing_ok(table, coalesce: int) -> bool:
    """True when ``table`` gives each ``coalesce``-page tick a contiguous
    ascending slot run — the legality check a coalesced launch needs."""
    table = [int(x) for x in table]
    if coalesce <= 1:
        return True
    if len(table) % coalesce:
        return False
    for t in range(0, len(table), coalesce):
        base = table[t]
        if table[t:t + coalesce] != list(range(base, base + coalesce)):
            return False
    return True


# ------------------------------------------------------------- the ship

def kv_ship_plain(pairs, src_ids, dst_ids):
    """Plain PyTorch version of the ship: for each ``(src, dst, row)`` of
    ``pairs`` (page-major tensors (npages, ...) of one dtype and page
    shape), ``dst[dst_ids[row]] = src[src_ids[row]]``; ``src_ids`` /
    ``dst_ids`` (G, P) integer tables. Writes ``dst`` in place."""
    for src, dst, row in pairs:
        si = _pool_ids(src_ids[row], src.device)
        di = _pool_ids(dst_ids[row], dst.device)
        dst.index_copy_(0, di, src.index_select(0, si))


def _check_ids(pairs, src_ids, dst_ids, coalesce, what):
    """Host checks of the page tables: in range on both sides, every
    landing slot written once a row, whole coalesced runs."""
    if src_ids.shape != dst_ids.shape or src_ids.ndim != 2:
        raise ValueError(f"{what}: source and landing tables must be (G, P) "
                         f"of one shape, got {src_ids.shape} / "
                         f"{dst_ids.shape}")
    pages = src_ids.shape[1]
    if pages % coalesce:
        raise ValueError(f"{what}: coalesce={coalesce} does not divide the "
                         f"page count {pages}")
    for row in range(src_ids.shape[0]):
        for tbl, side in ((src_ids[row], "source"), (dst_ids[row], "landing")):
            if not coalesced_landing_ok(tbl, coalesce):
                raise ValueError(
                    f"{what}: the {side} table {list(map(int, tbl))} is not "
                    f"a contiguous run a tick at coalesce={coalesce}")
        if len(set(dst_ids[row].tolist())) != pages:
            raise ValueError(f"{what}: landing table row {row} repeats a slot")
    if len({t.device for src, dst, _ in pairs for t in (src, dst)}) > 1:
        raise ValueError(f"{what}: the pools lie on more than one device")
    for src, dst, row in pairs:
        if src.dtype != dst.dtype or src.shape[1:] != dst.shape[1:]:
            raise ValueError(f"{what}: pools differ in dtype or page shape "
                             f"({src.dtype} {tuple(src.shape)} → {dst.dtype} "
                             f"{tuple(dst.shape)})")
        if src.device != dst.device:
            raise ValueError(f"{what}: pools on {src.device} and "
                             f"{dst.device}")
        for ids, pool, side in ((src_ids, src, "source"),
                                (dst_ids, dst, "landing")):
            if pages and (ids[row].min() < 0
                          or ids[row].max() >= pool.shape[0]):
                raise ValueError(f"{what}: a {side} page id lies outside "
                                 f"the pool's {pool.shape[0]} pages")


def _ship(pairs, src_ids, dst_ids, coalesce, table, what):
    src_ids = np.asarray(src_ids, np.int64)
    dst_ids = np.asarray(dst_ids, np.int64)
    _check_ids(pairs, src_ids, dst_ids, coalesce, what)
    if not pairs or src_ids.shape[1] == 0:
        return
    if pairs[0][0].device.type == "cpu":
        kv_ship_plain(pairs, src_ids, dst_ids)
        return
    if table is None:
        table = ShipTable()
    _kv_ship_cuda(table.desc_for(pairs), src_ids, dst_ids, coalesce,
                  pairs[0][0].device)


class ShipTable:
    """The kernel's (pool, rail) table on the device, one row a pair:
    source base pointer, landing base pointer, bytes a page, id row.
    :meth:`desc_for` rebuilds it only when a pool's storage moved, so a
    caller whose pools are written in place (the serving engines) builds
    it once."""

    def __init__(self):
        self._key = None
        self._desc = None

    def desc_for(self, pairs) -> torch.Tensor:
        """The table for ``pairs`` (contiguous page-major tensors on one
        device), checked against the pools' data pointers on the host."""
        for src, dst, _ in pairs:
            if not (src.is_contiguous() and dst.is_contiguous()):
                raise ValueError("tdt_kv_ship needs contiguous pools")
        rows = [(src.data_ptr(), dst.data_ptr(),
                 src[0].numel() * src.element_size(), row)
                for src, dst, row in pairs]
        key = (pairs[0][0].device, tuple(rows))
        if key != self._key:
            if len(rows) > MAX_PAIRS:
                raise ValueError(f"tdt_kv_ship covers at most {MAX_PAIRS} "
                                 f"(pool, rail) pairs a launch, got "
                                 f"{len(rows)}")
            host = torch.tensor(rows, dtype=torch.int64)
            self._desc = host.to(pairs[0][0].device)
            self._key = key
        return self._desc


def _kv_ship_cuda(desc, src_ids, dst_ids, coalesce, device):
    """``tdt_kv_ship``: one launch, a CTA a ((pool, rail), tick)."""
    from triton_distributed_tpu_torch.kernels import _build

    if device.type != "cuda":
        raise ValueError(f"tdt_kv_ship runs on CUDA tensors, got {device}")
    g, pages = src_ids.shape
    ids = torch.from_numpy(np.stack([src_ids, dst_ids], 1).astype(np.int32))
    ids = ids.pin_memory().to(device, non_blocking=True)
    fn = _build.function("tdt_kv_ship", "pp" + "iii" + "p")
    # desc and ids stay referenced until the launch is enqueued
    rc = fn(_build.ptr(desc), _build.ptr(ids), desc.shape[0], pages,
            coalesce, _build.stream(device))
    _build.check(rc, "tdt_kv_ship")
    _kv_ship_cuda.launches += 1
    _kv_ship_cuda.by_tpu_kernel["_kv_ship_kernel"] = (
        _kv_ship_cuda.by_tpu_kernel.get("_kv_ship_kernel", 0) + 1)


#: launch count of the kernel (a plain int on the wrapper), and the same
#: launches by the TPU kernel they stand for
_kv_ship_cuda.launches = 0
_kv_ship_cuda.by_tpu_kernel = {}


def _pool_pairs(src_layers, dst_layers):
    """(src, dst, 0) for every layer's K and V pool and rail."""
    if len(src_layers) != len(dst_layers):
        raise ValueError(f"ship_kv_pages: {len(src_layers)} source layers, "
                         f"{len(dst_layers)} landing layers")
    pairs = []
    for sl, dl in zip(src_layers, dst_layers):
        for sp, dp in zip(sl, dl):
            if isinstance(sp, dict) != isinstance(dp, dict):
                raise ValueError("ship_kv_pages: a quantized pool ships only "
                                 "into a quantized pool")
            if isinstance(sp, dict):
                pairs += [(sp["q"], dp["q"], 0), (sp["scale"], dp["scale"], 0)]
            else:
                pairs.append((sp, dp, 0))
    return pairs


def ship_kv_pages(src_layers, dst_layers, src_pids, dst_pids, *,
                  table: ShipTable | None = None):
    """The engine form: land pages ``src_pids`` of every layer's K and V
    pool of ``src_layers`` at pages ``dst_pids`` of ``dst_layers``, in
    place — the int8 payload and its f32 scale plane under ``kv_quant``,
    the raw pages otherwise. ``table``: a :class:`ShipTable` the caller
    keeps across launches. On CPU pools this is :func:`kv_ship_plain`; on
    CUDA pools one launch of the kernel, or it raises."""
    pairs = _pool_pairs(src_layers, dst_layers)
    _ship(pairs, [list(src_pids)], [list(dst_pids)], 1, table,
          "ship_kv_pages")


def kv_ship(src_q, src_s, dstpg, mesh, axis: str = "x", *, schedule=None):
    """JAX's mesh form: every rank r ships its staged pages to rank
    (r + n/2) % n. ``src_q`` a list of n per-rank ``(pages·rows, cols)``
    int8 buffers, ``src_s`` their ``(pages·rows, SCALE_LANES)`` f32 scale
    planes (or None: the raw wire), ``dstpg`` (n, pages) rank r's landing
    slots on its partner. ``schedule``: None or a ``GridSchedule`` whose
    only non-default field is ``coalesce`` (pages a tick; the landing
    table must give each tick a contiguous run). Returns ``(out_q,
    out_s)``, fresh zeroed buffers of the same shapes with the arrivals
    landed (``out_s`` None on the raw wire)."""
    n = one_axis(mesh, axis)
    coalesce = require_ship_schedule(schedule, "kv_ship")
    dstpg = np.asarray(dstpg, np.int64).reshape(n, -1)
    pages = dstpg.shape[1]
    if len(src_q) != n or (src_s is not None and len(src_s) != n):
        raise ValueError(f"kv_ship takes {n} per-rank buffers a rail")
    rows = src_q[0].shape[0] // max(pages, 1)
    if pages == 0 or rows * pages != src_q[0].shape[0]:
        raise ValueError(f"kv_ship: {src_q[0].shape[0]} staged rows do not "
                         f"split into {pages} pages")
    rails = [src_q] + ([] if src_s is None else [src_s])
    if src_s is not None and tuple(src_s[0].shape) != (pages * rows,
                                                       SCALE_LANES):
        raise ValueError(f"kv_ship: scale planes must be ({pages * rows}, "
                         f"{SCALE_LANES}), got {tuple(src_s[0].shape)}")
    outs = []
    pairs = []
    for rail in rails:
        out = torch.zeros((n, *rail[0].shape), dtype=rail[0].dtype,
                          device=rail[0].device)
        for r in range(n):
            pairs.append((rail[r].view(pages, rows, -1),
                          out[(r + n // 2) % n].view(pages, rows, -1), r))
        outs.append(list(out.unbind(0)))
    src_ids = np.tile(np.arange(pages, dtype=np.int64), (n, 1))
    _ship(pairs, src_ids, dstpg, coalesce, None, "kv_ship")
    return outs[0], (outs[1] if src_s is not None else None)
