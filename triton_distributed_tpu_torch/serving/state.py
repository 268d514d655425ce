"""ServingState and the host page allocator.

Port of ``triton_distributed_tpu/serving/state.py`` (without
``CpPagePool``, which comes with context-parallel serving):

* **page pools** per layer — ``(npages, Hkv, page, D)`` tensors, or int8
  ``{"q", "scale"}`` dicts under ``kv_quant``; one GPU holds every head;
* **block table** ``(slots, pages_per_seq)`` int32 pool page ids (-1 =
  unallocated);
* **kv_lens** ``(slots,)`` int32, including the step in flight;
* **cursors** ``(slots,)`` int32, the device mirror of each request's
  progress.

JAX donated the state to its jitted step; here the step appends into
the pool tensors in place and returns the same object with new
metadata.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, replace as _dc_replace

import numpy as np


@dataclass(frozen=True)
class ServingState:
    """One engine's device-resident serving state (see module docs)."""

    layers: tuple        # per-layer (k_pool, v_pool); dicts under kv_quant
    block_table: object  # (slots, pages_per_seq) int32
    kv_lens: object      # (slots,) int32 — includes the in-flight step
    cursors: object      # (slots,) int32
    page: int = 0        # rows per page
    cp: int = 1          # context-parallel shards (1 in this port)

    def replace(self, **kw) -> "ServingState":
        return _dc_replace(self, **kw)

    @property
    def slots(self) -> int:
        return int(self.block_table.shape[0])

    @property
    def pages_per_seq(self) -> int:
        return int(self.block_table.shape[1])

    @property
    def pages_per_shard(self) -> int:
        return self.pages_per_seq // max(self.cp, 1)

    @property
    def npages(self) -> int:
        k0 = self.layers[0][0]
        return int((k0["q"] if isinstance(k0, dict) else k0).shape[0])

    @property
    def capacity(self) -> int:
        """Max sequence positions one slot can hold."""
        return self.pages_per_seq * self.page


def fresh_table(slots: int, pages_per_seq: int) -> np.ndarray:
    """Host-side table template (-1 = unallocated)."""
    return np.full((slots, pages_per_seq), -1, np.int32)


class PagePool:
    """Host-side page allocator with per-page refcounts and an optional
    prefix cache. A page is **free** (on the free list), **held**
    (``refs >= 1``: referenced by that many block-table rows) or
    **cached** (``refs == 0`` but registered under the chain hash of the
    prefix it froze under; reclaimed least-recently-released first when
    the free list runs dry). Only full pages are registered, so a cached
    page's content never changes while it sits in the cache."""

    def __init__(self, npages: int, page: int, *, prefix_cache: bool = False):
        self.npages = int(npages)
        self.page = int(page)
        self.prefix_cache = bool(prefix_cache)
        self.refs = np.zeros((npages,), np.int32)
        self.free: list = list(range(npages - 1, -1, -1))
        self._by_hash: dict = {}              # chain hash -> page id
        self._hash_of: dict = {}              # page id -> chain hash
        self._reclaim: OrderedDict = OrderedDict()   # refcount-0 cached, LRU

    @property
    def available(self) -> int:
        """Pages an allocation may claim: free + reclaimable-cached."""
        return len(self.free) + len(self._reclaim)

    @property
    def held_pages(self) -> int:
        """Pages some block-table row still references (0 when idle)."""
        return int((self.refs >= 1).sum())

    def alloc(self, idx: int | None = None) -> int | None:
        """Claim one page (refcount 1), reclaiming the LRU cached page
        when the free list is dry. None when exhausted. ``idx`` (the
        logical page index) routes a context-parallel pool; ignored."""
        del idx
        if self.free:
            pg = self.free.pop()
        elif self._reclaim:
            pg, _ = self._reclaim.popitem(last=False)
            h = self._hash_of.pop(pg)
            if self._by_hash.get(h) == pg:
                del self._by_hash[h]
        else:
            return None
        assert self.refs[pg] == 0, (pg, self.refs[pg])
        self.refs[pg] = 1
        return pg

    def retain(self, pg: int) -> None:
        """One more block-table row references ``pg``."""
        if pg in self._reclaim:
            del self._reclaim[pg]
        self.refs[pg] += 1

    def release(self, pg: int) -> None:
        """Drop one reference; the page frees (or parks in the cache)
        when the last reference drops."""
        assert self.refs[pg] >= 1, (pg, self.refs[pg])
        self.refs[pg] -= 1
        if self.refs[pg] == 0:
            if pg in self._hash_of:
                self._reclaim[pg] = None
            else:
                self.free.append(pg)

    def register(self, pg: int, chain_hash) -> None:
        """Publish a frozen full page under its prefix-chain hash (first
        registration wins)."""
        if not self.prefix_cache or chain_hash in self._by_hash:
            return
        self._by_hash[chain_hash] = pg
        self._hash_of[pg] = chain_hash

    def lookup(self, chain_hash, idx: int | None = None) -> int | None:
        """The resident page holding this prefix page, or None."""
        del idx
        return self._by_hash.get(chain_hash)

    def can_hold(self, held: int, need: int) -> bool:
        """Whether a sequence can grow from ``held`` to ``need`` pages."""
        return need - held <= self.available

    def clone(self) -> "PagePool":
        """Deep copy of the allocator state."""
        q = PagePool.__new__(PagePool)
        q.npages = self.npages
        q.page = self.page
        q.prefix_cache = self.prefix_cache
        q.refs = self.refs.copy()
        q.free = list(self.free)
        q._by_hash = dict(self._by_hash)
        q._hash_of = dict(self._hash_of)
        q._reclaim = OrderedDict(self._reclaim)
        return q


def page_chain_hash(prev_hash, tokens) -> int:
    """The prefix-cache key of one full page: the previous page's hash
    chained with this page's token ids."""
    return hash((prev_hash, tuple(int(t) for t in tokens)))
