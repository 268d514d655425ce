"""ServingState and the host page allocator.

Port of ``triton_distributed_tpu/serving/state.py``:

* **page pools** per layer — ``(npages, Hkv, page, D)`` tensors, or int8
  ``{"q", "scale"}`` dicts under ``kv_quant``; one GPU holds every head.
  Under context parallelism (``cp`` shards) the pool is ``cp`` per-shard
  pools stacked in one allocation, and the host allocator is a
  :class:`CpPagePool`;
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
    cp: int = 1          # context-parallel shards of the pool

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


class CpPagePool:
    """Context-parallel page allocator (JAX ``:234-383``): ``cp``
    per-shard :class:`PagePool` instances behind one global page-id
    namespace.

    Shard ``s`` owns global page ids ``[s·npages_shard, (s+1)·
    npages_shard)``, the same rows of the stacked device pool, and the
    logical page index ``idx`` of any sequence belongs to shard
    ``min(idx // pages_per_shard, cp - 1)``, as the block table's columns
    split. Appends land on the owning shard (``alloc`` routes by
    ``idx``), releases route by the global id's shard, and the prefix
    cache registers and looks up within the owning shard.

    The combined read-only views (``refs``, ``free``, ``_reclaim``,
    ``_hash_of``, ``_by_hash``, in global ids) give the engine's leak
    checks one allocator whatever ``cp`` is."""

    def __init__(self, cp: int, npages: int, page: int,
                 pages_per_shard: int, *, prefix_cache: bool = False):
        if cp < 2:
            raise ValueError(f"a cp pool needs at least 2 shards, got {cp}")
        self.cp = int(cp)
        self.npages_shard = int(npages)
        self.npages = int(cp) * int(npages)     # total pages
        self.page = int(page)
        self.pages_per_shard = int(pages_per_shard)
        self.prefix_cache = bool(prefix_cache)
        self.shards = tuple(PagePool(npages, page, prefix_cache=prefix_cache)
                            for _ in range(self.cp))

    # ---- routing

    def owner_of(self, idx: int) -> int:
        """Logical page index within a sequence → owning shard."""
        return min(int(idx) // self.pages_per_shard, self.cp - 1)

    def shard_of(self, pg: int) -> int:
        """Global page id → owning shard."""
        return int(pg) // self.npages_shard

    def _global(self, s: int, lp):
        return None if lp is None else s * self.npages_shard + lp

    # ---- combined views (global ids)

    @property
    def refs(self):
        return np.concatenate([s.refs for s in self.shards])

    @property
    def free(self) -> list:
        return [self._global(i, lp) for i, s in enumerate(self.shards)
                for lp in s.free]

    @property
    def _reclaim(self) -> OrderedDict:
        return OrderedDict((self._global(i, lp), None)
                           for i, s in enumerate(self.shards)
                           for lp in s._reclaim)

    @property
    def _hash_of(self) -> dict:
        return {self._global(i, lp): h for i, s in enumerate(self.shards)
                for lp, h in s._hash_of.items()}

    @property
    def _by_hash(self) -> dict:
        return {h: self._global(i, lp) for i, s in enumerate(self.shards)
                for h, lp in s._by_hash.items()}

    @property
    def available(self) -> int:
        """Claimable pages over every shard: an upper bound for one
        sequence (growth routes to owners; :meth:`can_hold` is the exact
        per-shard gate)."""
        return sum(s.available for s in self.shards)

    @property
    def held_pages(self) -> int:
        return sum(s.held_pages for s in self.shards)

    # ---- allocator verbs

    def alloc(self, idx: int | None = None) -> int | None:
        """Claim one page on the shard owning logical index ``idx``."""
        if idx is None:
            raise ValueError("a cp pool's allocation needs the page index")
        s = self.owner_of(idx)
        return self._global(s, self.shards[s].alloc())

    def retain(self, pg: int) -> None:
        s = self.shard_of(pg)
        self.shards[s].retain(pg - s * self.npages_shard)

    def release(self, pg: int) -> None:
        s = self.shard_of(pg)
        self.shards[s].release(pg - s * self.npages_shard)

    def register(self, pg: int, chain_hash) -> None:
        s = self.shard_of(pg)
        self.shards[s].register(pg - s * self.npages_shard, chain_hash)

    def lookup(self, chain_hash, idx: int | None = None) -> int | None:
        """The resident page holding this prefix page on the shard that
        owns logical index ``idx``, or None."""
        if idx is None:
            raise ValueError("a cp pool's lookup needs the page index")
        s = self.owner_of(idx)
        return self._global(s, self.shards[s].lookup(chain_hash))

    def can_hold(self, held: int, need: int) -> bool:
        """Exact per-shard gate: pages ``held .. need - 1`` route to their
        owners, and every owner must have the headroom."""
        want = [0] * self.cp
        for p in range(held, need):
            want[self.owner_of(p)] += 1
        return all(w <= s.available for w, s in zip(want, self.shards))

    def clone(self) -> "CpPagePool":
        """Deep copy of the allocator state."""
        q = CpPagePool.__new__(CpPagePool)
        q.cp = self.cp
        q.npages_shard = self.npages_shard
        q.npages = self.npages
        q.page = self.page
        q.pages_per_shard = self.pages_per_shard
        q.prefix_cache = self.prefix_cache
        q.shards = tuple(s.clone() for s in self.shards)
        return q


def page_chain_hash(prev_hash, tokens) -> int:
    """The prefix-cache key of one full page: the previous page's hash
    chained with this page's token ids."""
    return hash((prev_hash, tuple(int(t) for t in tokens)))
