"""ProtocolOps: the serving protocol's transition verbs.

Port of the engine verbs of ``triton_distributed_tpu/serving/
protocol.py`` (``alloc`` through ``complete``) and of the transactional
KV ship (``reserve_shipped`` through ``ship_abort``, JAX ``:252-309``).
Every verb is host bookkeeping over numpy tables, the
:class:`~triton_distributed_tpu_torch.serving.state.PagePool` refcounts
and request fields; the engines delegate to them. The fleet's verbs
(``migrate_live_core``, ``failover_requeue``, ``drain_requeue``) come
with ``serving/fleet.py`` (ROADMAP Queue 1 step 5, its fleet half).
"""

from __future__ import annotations

from collections import deque


class ProtocolOps:
    """The serving protocol's transition verbs. Engine-scoped verbs
    take the engine as their first argument; subclass and override a
    verb to build a deliberately broken protocol."""

    seeds_rule: str | None = None

    # ---------------------------------------------------- page allocator

    def alloc(self, eng, slot: int, held: int, need: int) -> bool:
        """Grow ``slot``'s table from ``held`` to ``need`` pages;
        all-or-nothing."""
        if not eng.pool.can_hold(held, need):
            return False
        for pg in range(held, need):
            eng.table[slot, pg] = eng.pool.alloc(pg)
        return True

    def free_slot(self, eng, slot: int) -> None:
        """Release the slot's page references (shared pages free only
        when their last holder lets go)."""
        for pg in eng.table[slot]:
            if pg >= 0:
                eng.pool.release(int(pg))
        eng.table[slot] = -1
        eng.slot_req[slot] = None

    def ensure_pages(self, eng, slot: int, held: int, need: int,
                     batched: set) -> bool:
        """Claim the row's pages, evicting until they fit or nothing
        evictable remains. False = the row defers this step."""
        while not self.alloc(eng, slot, held, need):
            if not self.evict_one(eng, batched | {slot}):
                return False
        return True

    # ------------------------------------------------ eviction/preemption

    def evict_one(self, eng, batched: set) -> bool:
        """Evict the lowest-tier, latest-arrived active request not in
        this step's batch; it re-queues at the front with cursor 0 (the
        recompute prefix resumes it exactly)."""
        victims = [
            (eng._rank(req), req.arrival, s)
            for s, req in enumerate(eng.slot_req)
            if req is not None and s not in batched
            and not req.parked and not req.done
        ]
        if not victims:
            return False
        _, _, s = max(victims)
        req = eng.slot_req[s]
        req.cursor = 0
        req.evictions += 1
        req.slot = None
        self.free_slot(eng, s)
        eng.waiting.appendleft(req)
        eng.stats.evictions += 1
        return True

    def preempt_for(self, eng, by_req) -> bool:
        """Priority preemption: evict the lowest-tier resident strictly
        below ``by_req``'s effective rank. False = no such victim."""
        rank = eng._eff_rank(by_req)
        victims = [
            (eng._eff_rank(req), -int((eng.table[s] >= 0).sum()),
             req.arrival, s)
            for s, req in enumerate(eng.slot_req)
            if req is not None and not req.parked and not req.done
            and eng._eff_rank(req) > rank
        ]
        if not victims:
            return False
        _, _, _, s = max(victims)
        victim = eng.slot_req[s]
        victim.cursor = 0
        victim.evictions += 1
        victim.slot = None
        self.free_slot(eng, s)
        eng.waiting.append(victim)
        eng.stats.evictions += 1
        eng.stats.preemptions += 1
        t = getattr(victim, "tenant", "default")
        eng.stats.tenant_preemptions[t] = (
            eng.stats.tenant_preemptions.get(t, 0) + 1)
        if eng.on_preempt is not None:
            eng.on_preempt(by_req, victim)
        return True

    # ----------------------------------------------------------- admission

    def admit(self, eng) -> None:
        """Priority admission over the free slots: effective tier rank,
        then FIFO, with preemption when a higher tier finds no slot or
        no page headroom, and per-tenant fair-share deferrals."""
        while eng.pending and eng.pending[0].arrival <= eng.step_count:
            eng.waiting.append(eng.pending.popleft())
        if not eng.waiting:
            return
        eng.waiting = deque(sorted(
            eng.waiting,
            key=lambda r: (eng._eff_rank(r), r.arrival, r.rid)))
        deferred: list = []
        while eng.waiting:
            req = eng.waiting[0]
            free = [s for s, r in enumerate(eng.slot_req) if r is None]
            if not free:
                if not self.preempt_for(eng, req):
                    break                  # no slot, no lower-tier victim
                free = [s for s, r in enumerate(eng.slot_req)
                        if r is None]
            first = min(eng._chunk_for(req), len(req.seq))
            if (eng._pages_held(first)
                    > eng.pool.available - eng._committed_pages()):
                if self.preempt_for(eng, req):
                    continue
                break                      # hold the queue
            if not eng._fair_share_ok(req, first):
                eng.waiting.popleft()
                deferred.append(req)
                t = getattr(req, "tenant", "default")
                eng.stats.fair_share_deferrals[t] = (
                    eng.stats.fair_share_deferrals.get(t, 0) + 1)
                continue
            eng.waiting.popleft()
            s = free[0]
            req.slot = s
            eng.slot_req[s] = req
            if len(req.seq) > eng.state.capacity:
                req.done = True
                self.free_slot(eng, s)
                raise ValueError(
                    f"request {req.rid}: sequence {len(req.seq)} exceeds "
                    f"slot capacity {eng.state.capacity}"
                )
            if eng.pool.prefix_cache and req.cursor == 0:
                eng._attach_prefix(req, s)
        for req in deferred:               # over-share: retry next step
            eng.waiting.append(req)

    # ------------------------------------------------------- row advance

    def advance_cursor(self, eng, s: int, req, take: int) -> int:
        """Move one batched row's cursor past its packed tokens and
        publish newly frozen pages. Returns the pre-advance cursor."""
        old_cursor = req.cursor
        req.cursor += take
        if eng.pool.prefix_cache:
            eng._register_frozen(req, s, old_cursor)
        return old_cursor

    def complete(self, eng, req, s: int) -> None:
        """Completion check after a row emitted a token; frees (or
        parks, via ``on_complete``) the slot at the request's target."""
        target = 1 if eng.cfg.prefill_only else req.max_new
        if len(req.generated) >= target:
            req.completion_step = eng.step_count
            eng.stats.completed += 1
            eng.stats.generated_tokens += len(req.generated)
            if not eng.cfg.prefill_only:
                req.done = True
            if eng.on_complete is None or eng.on_complete(req, s):
                self.free_slot(eng, s)

    # --------------------------------------------- transactional KV ship

    def reserve_shipped(self, eng, req) -> tuple | None:
        """Claim a slot + landing pages for a request whose first
        ``req.cursor`` tokens of KV will arrive by transfer. Returns
        (slot, page_ids) or None (no slot / pool pressure — the caller
        retries, leaving the source pages pinned)."""
        free = [s for s, r in enumerate(eng.slot_req) if r is None]
        if not free:
            return None
        if len(req.seq) > eng.state.capacity:
            raise ValueError(
                f"request {req.rid}: sequence {len(req.seq)} exceeds "
                f"slot capacity {eng.state.capacity}"
            )
        need = eng._pages_held(req.cursor)
        if (need > eng.pool.available - eng._committed_pages()
                or not eng.pool.can_hold(0, need)):
            return None
        s = free[0]
        pids = []
        for p in range(need):
            pg = eng.pool.alloc(p)
            eng.table[s, p] = pg
            pids.append(int(pg))
        req.slot = s
        req.parked = True
        eng.slot_req[s] = req
        return s, pids

    def commit_shipped(self, eng, req) -> None:
        """The transfer into this request's reserved pages has landed:
        the row becomes schedulable (and evictable) like any other."""
        req.parked = False

    def release_parked(self, eng, slot: int) -> None:
        """Free a parked slot (source-side handoff after its pages have
        shipped, or an abandoned reservation)."""
        req = eng.slot_req[slot]
        if req is None or not req.parked:
            raise ValueError(f"slot {slot} holds no parked request ({req})")
        req.parked = False
        self.free_slot(eng, slot)

    def ship_commit(self, src_eng, pslot: int, dst_eng, req) -> None:
        """Land one ship: the SOURCE frees its pinned pages first, then
        the row becomes schedulable at the destination (the reverse order
        would leave a window where both pools claim the request's KV)."""
        self.release_parked(src_eng, pslot)
        self.commit_shipped(dst_eng, req)

    def ship_abort(self, dst_eng, dslot: int, req, pslot: int) -> None:
        """Roll a destination reservation back (its landing pages return
        to the pool) and restore the request to its source slot,
        schedulable in place."""
        self.release_parked(dst_eng, dslot)
        req.slot = pslot
        req.parked = False

    def migrate_live_core(self, req, src_role, dst_role, pslot: int,
                          npg: int, transport):
        """A replica → replica live migration: not ported."""
        raise NotImplementedError(
            "migrate_live_core (the fleet's live migration) comes with "
            "serving/fleet.py, ROADMAP Queue 1 step 5's fleet half")
