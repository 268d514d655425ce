"""Continuous-batching request scheduler over the ragged serving step.

Port of ``triton_distributed_tpu/serving/engine.py`` (the colocated
``ServingEngine``). Requests arrive on a trace, are admitted into slots
when the page pool can hold their first chunk, have their prompts
prefilled in chunks interleaved with other requests' decode tokens (one
ragged mixed batch per step), and are evicted when the pool runs dry
(pages freed, request re-queued; re-admission re-prefills prompt plus
everything generated, so generation resumes from the exact cursor).

The scheduling is host-side numpy and is the JAX engine's, verb for
verb (through :class:`~triton_distributed_tpu_torch.serving.protocol.
ProtocolOps`). The device work is one call of the port's
``Transformer.serving_step`` per engine step; fetching its logits to the
host is the step's fence. Sampling is keyed on ``(seed, rid,
tokens generated)``, so logits that agree give the JAX engine's token
streams.

An EP MoE model's layers keep persistent transport workspaces
(``moe_state``, built by ``model.init_decode_state`` for the packed
step width) that every step threads through.

A model with a context-parallel axis (``model.cp > 1``) serves long
requests: the pool holds ``cp`` per-shard pools of ``cfg.npages`` pages
each, and the host allocator mirrors them as a
:class:`~triton_distributed_tpu_torch.serving.state.CpPagePool`, which
lands each page on the shard that owns its logical index (the protocol's
verbs pass that index to ``alloc`` and ``lookup`` on every path, eviction
and recompute included). In-batch prefix dedup (``prefix_share``) is
refused there, as in JAX.

:class:`DisaggregatedEngine` splits the roles (JAX ``:1175``): a prefill
engine and a decode engine, every finished prefill's KV pages landing in
the decode role's pool through the KV-page ship (``tdt_kv_ship`` on the
card) between the ship verbs' reserve and commit.

Not in this slice: the health ledger and the demotion to a twin when a
kernel raises (a kernel error propagates), the watchdog hooks, the
TPU grid schedule and speculation.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

TIERS = ("interactive", "batch", "background")

TIER_RANK = {name: i for i, name in enumerate(TIERS)}


def tier_rank(priority: str | None) -> int:
    """Numeric rank of a priority class (lower = more important);
    unknown or unset priorities rank as interactive."""
    return TIER_RANK.get(priority, 0)


@dataclass(frozen=True)
class TenantConfig:
    """Per-tenant serving contract: ``priority`` (a tier of
    ``TIERS``), ``slo_ms``, ``token_budget`` (packed tokens the tenant's
    resident rows may claim per step, None = unbounded) and
    ``page_share`` (fraction of the pool its residents may hold)."""

    priority: str = "interactive"
    slo_ms: float = float("inf")
    token_budget: int | None = None
    page_share: float = 1.0

    def __post_init__(self):
        if self.priority not in TIERS:
            raise ValueError(
                f"unknown priority {self.priority!r} (want one of "
                f"{TIERS})")
        if not 0.0 < self.page_share <= 1.0:
            raise ValueError(
                f"page_share must be in (0, 1], got {self.page_share}")
        if self.token_budget is not None and self.token_budget < 8:
            raise ValueError(
                f"token_budget must be >= 8 (one packed row), got "
                f"{self.token_budget}")


DEFAULT_TENANT = TenantConfig()


def effective_rank(req, now: float, aging_ticks: int) -> int:
    """The tier rank minus one bump per ``aging_ticks`` ticks waited
    since arrival (floor 0)."""
    rank = tier_rank(getattr(req, "priority", None))
    if rank == 0 or aging_ticks <= 0:
        return rank
    waited = max(float(now) - float(req.arrival), 0.0)
    return max(0, rank - int(waited // aging_ticks))


@dataclass
class Request:
    """One serving request; ``arrival`` is in engine-step units."""

    rid: int
    prompt: np.ndarray                 # (L,) int32 token ids
    max_new: int = 8
    arrival: float = 0.0
    tenant: str = "default"
    priority: str | None = None

    # runtime (engine-owned)
    generated: list = field(default_factory=list)
    cursor: int = 0                    # tokens of `seq` already in KV
    slot: int | None = None
    evictions: int = 0
    done: bool = False
    completion_step: int | None = None
    parked: bool = False

    @property
    def seq(self) -> np.ndarray:
        """Prompt + generated: the recompute prefix after an eviction."""
        if not self.generated:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.generated, np.int32)]
        )


@dataclass(frozen=True)
class EngineConfig:
    slots: int = 8                     # concurrent requests (R)
    token_budget: int = 64             # static packed tokens per step (T)
    chunk: int = 16                    # max prefill tokens per row-step
    page: int = 16
    npages: int = 64
    max_steps: int = 10_000
    # temperature <= 0: greedy argmax; else softmax sampling of
    # logits/temperature (top_k-truncated when > 0), keyed on
    # (seed, rid, tokens generated so far)
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0
    prefill_only: bool = False
    prefix_cache: bool = False
    prefix_share: bool = False


@dataclass
class EngineStats:
    step_times: list = field(default_factory=list)
    step_tokens: list = field(default_factory=list)
    step_generated: list = field(default_factory=list)
    completed: int = 0
    generated_tokens: int = 0
    prefill_tokens: int = 0
    evictions: int = 0
    deferrals: int = 0
    prefix_hits: int = 0
    shared_prefix_rows: int = 0
    deduped_pages: int = 0
    preemptions: int = 0
    tenant_preemptions: dict = field(default_factory=dict)
    fair_share_deferrals: dict = field(default_factory=dict)

    @property
    def total_time(self) -> float:
        return float(sum(self.step_times))

    @property
    def sustained_tok_per_s(self) -> float:
        t = self.total_time
        return (sum(self.step_tokens) / t) if t > 0 else 0.0

    @property
    def goodput_tok_per_s(self) -> float:
        """Generated tokens of completed requests per wall second."""
        t = self.total_time
        return (self.generated_tokens / t) if t > 0 else 0.0

    @property
    def p99_step_ms(self) -> float:
        if not self.step_times:
            return 0.0
        return float(np.percentile(np.asarray(self.step_times), 99) * 1e3)

    @property
    def p50_step_ms(self) -> float:
        if not self.step_times:
            return 0.0
        return float(np.percentile(np.asarray(self.step_times), 50) * 1e3)


def poisson_trace(seed: int, n_requests: int, mean_interarrival: float,
                  len_lo: int, len_hi: int, max_new_lo: int,
                  max_new_hi: int, vocab: int) -> list:
    """Seeded Poisson arrival trace: exponential inter-arrival gaps (in
    engine steps), prompt lengths ~ U[len_lo, len_hi), uniform max_new.
    The same draws as the JAX package's trace for the same arguments."""
    rng = np.random.default_rng(seed)
    t = 0.0
    out = []
    for i in range(n_requests):
        t += float(rng.exponential(mean_interarrival))
        ln = int(rng.integers(len_lo, max(len_hi, len_lo + 1)))
        out.append(Request(
            rid=i,
            prompt=rng.integers(0, vocab, (ln,)).astype(np.int32),
            max_new=int(rng.integers(max_new_lo, max(max_new_hi,
                                                     max_new_lo + 1))),
            arrival=t,
        ))
    return out


def _ceil8(x: int) -> int:
    return -(-x // 8) * 8


class ServingEngine:
    """The scheduler. Owns the host mirrors (pool allocator, block
    table, cursors) and the device :class:`ServingState`; every
    :meth:`step` assembles one ragged batch and runs one
    ``model.serving_step``."""

    def __init__(self, model, params, cfg: EngineConfig, *,
                 on_complete=None, tenants=None, aging_ticks: int = 64,
                 ops=None, moe_state="auto"):
        from triton_distributed_tpu_torch.kernels.ragged_paged_attention import (
            auto_block_q,
        )
        from triton_distributed_tpu_torch.serving.protocol import ProtocolOps
        from triton_distributed_tpu_torch.serving.state import (
            CpPagePool,
            PagePool,
        )

        if cfg.token_budget % 8:
            raise ValueError("token_budget must be 8-aligned")
        if cfg.chunk > cfg.token_budget:
            raise ValueError(
                f"chunk={cfg.chunk} exceeds token_budget={cfg.token_budget}")
        if cfg.prefix_share and not cfg.prefix_cache:
            raise ValueError("prefix_share requires prefix_cache (the "
                             "chain-hash registry is the dedup index)")
        cp = getattr(model, "cp", 1)
        if cp > 1 and cfg.prefix_share:
            raise ValueError(
                "prefix_share is incompatible with context-parallel "
                "decode: in-batch dedup retargets table columns to a "
                "canonical page, but under cp a logical page index is "
                "pinned to its owning shard")
        self.model = model
        self.params = params
        self.cfg = cfg
        self.device = model.device
        self.ops = ops if ops is not None else ProtocolOps()
        self.state = model.init_serving_state(cfg.slots, cfg.npages, cfg.page)
        self.table = np.full((cfg.slots, self.state.pages_per_seq), -1,
                             np.int32)
        # under cp the pool's shards own the table's column blocks: the
        # allocator routes each logical page index to its shard
        if cp > 1:
            self.pool = CpPagePool(cp, cfg.npages, cfg.page,
                                   self.state.pages_per_shard,
                                   prefix_cache=cfg.prefix_cache)
        else:
            self.pool = PagePool(cfg.npages, cfg.page,
                                 prefix_cache=cfg.prefix_cache)
        # called (req, slot) on completion; return True to free the slot
        self.on_complete = on_complete
        self.slot_req: list = [None] * cfg.slots
        self.pending: deque = deque()      # not yet arrived (by time)
        self.waiting: deque = deque()      # arrived, not admitted
        self.stats = EngineStats()
        self.step_count = 0
        self.tenants: dict = dict(tenants or {})
        self.aging_ticks = int(aging_ticks)
        self.on_preempt = None
        c = model.config
        self._g = c.n_heads // c.n_kv_heads
        self._block_q_cap = auto_block_q(cfg.chunk, self._g)
        # the packed array keeps the JAX engine's parking zone of
        # block_q_cap tokens past the budget: q_len == 0 rows point
        # there, so the batch is laid out exactly as in JAX
        self._t_pad = cfg.token_budget + self._block_q_cap
        # the EP MoE layers' persistent (LL) workspaces, sized for the
        # packed step width; None when the model has no EP layers
        self.moe_state = (model.init_decode_state(self._t_pad)
                          if moe_state == "auto" else moe_state)

    # ------------------------------------------------------------ requests

    def submit(self, req: Request) -> None:
        self.pending.append(req)

    def submit_trace(self, trace) -> None:
        for r in sorted(trace, key=lambda r: r.arrival):
            self.submit(r)

    @property
    def idle(self) -> bool:
        return (not self.pending and not self.waiting
                and all(r is None for r in self.slot_req))

    # ------------------------------------------------------------ tenancy

    def _tenant(self, req) -> TenantConfig:
        return self.tenants.get(
            getattr(req, "tenant", "default"), DEFAULT_TENANT)

    def _priority(self, req) -> str:
        pr = getattr(req, "priority", None)
        return self._tenant(req).priority if pr is None else pr

    def _rank(self, req) -> int:
        """Static tier rank (the request's, else its tenant's)."""
        return tier_rank(self._priority(req))

    def _eff_rank(self, req) -> int:
        """Admission-order rank with anti-starvation aging."""
        rank = tier_rank(self._priority(req))
        if rank == 0 or self.aging_ticks <= 0:
            return rank
        waited = max(float(self.step_count) - float(req.arrival), 0.0)
        return max(0, rank - int(waited // self.aging_ticks))

    def _chunk_for(self, req) -> int:
        """The prefill chunk of a request (the fleet's brownout, which
        halves it per tier, is not ported)."""
        return self.cfg.chunk

    # ----------------------------------------------------------- allocator

    def _pages_held(self, cursor: int) -> int:
        return -(-cursor // self.cfg.page)

    def _row_take_bound(self, req) -> int:
        return min(self._chunk_for(req), len(req.seq) - req.cursor)

    def _committed_pages(self) -> int:
        """Pages admitted slots will claim for their next chunk but have
        not allocated yet — admission must not promise them away."""
        tot = 0
        for req in self.slot_req:
            if req is None or req.parked or req.done:
                continue
            take = self._row_take_bound(req)
            tot += max(
                self._pages_held(req.cursor + take)
                - self._pages_held(req.cursor), 0,
            )
        return tot

    def _fair_share_ok(self, req, first: int) -> bool:
        """Per-tenant page-share and token-budget admission gate."""
        tc = self._tenant(req)
        if tc.page_share >= 1.0 and tc.token_budget is None:
            return True
        tenant = getattr(req, "tenant", "default")
        resident = [
            r for r in self.slot_req
            if r is not None and not r.done
            and getattr(r, "tenant", "default") == tenant
        ]
        if tc.page_share < 1.0:
            cap = int(tc.page_share * self.pool.npages)
            held = sum(self._pages_held(r.cursor) for r in resident)
            if held + self._pages_held(first) > cap:
                return False
        if tc.token_budget is not None:
            packed = sum(self._row_take_bound(r) for r in resident
                         if not r.parked)
            if packed + first > tc.token_budget:
                return False
        return True

    # ------------------------------------------------------ prefix cache

    def _page_hashes(self, req, upto: int) -> list:
        """Chain hashes of ``req.seq``'s first ``upto`` full pages."""
        from triton_distributed_tpu_torch.serving.state import page_chain_hash

        seq, page = req.seq, self.cfg.page
        hashes, h = [], 0
        for p in range(upto):
            h = page_chain_hash(h, seq[p * page:(p + 1) * page])
            hashes.append(h)
        return hashes

    def _attach_prefix(self, req, slot: int) -> None:
        """Reattach the longest run of resident full pages matching the
        request's prefix (one trailing token is always recomputed)."""
        page = self.cfg.page
        limit = min((len(req.seq) - 1) // page, self.state.pages_per_seq)
        matched = 0
        for h in self._page_hashes(req, limit):
            pg = self.pool.lookup(h, matched)
            if pg is None:
                break
            self.pool.retain(pg)
            self.table[slot, matched] = pg
            matched += 1
        if matched:
            req.cursor = matched * page
            self.stats.prefix_hits += matched

    def _register_frozen(self, req, slot: int, old_cursor: int) -> None:
        """Publish pages the cursor just moved past to the prefix cache."""
        page = self.cfg.page
        first = old_cursor // page
        last = req.cursor // page
        if last <= first:
            return
        hashes = self._page_hashes(req, last)
        for p in range(first, last):
            self.pool.register(int(self.table[slot, p]), hashes[p])

    def _dedup_shared_prefixes(self, batched, topo, width: int) -> None:
        """In-batch shared-prefix dedup (``cfg.prefix_share``): fold each
        batched row's frozen pages onto the prefix cache's canonical page
        and mark rows whose leading pages are shared SHARED_PREFIX."""
        from triton_distributed_tpu_torch.kernels.ragged_paged_attention import (
            TOPO_CAUSAL,
            shared_prefix_topology_row,
        )

        page = self.cfg.page
        for s in sorted(batched):
            req = self.slot_req[s]
            frozen = min(req.cursor // page, self.state.pages_per_seq)
            if frozen <= 0:
                continue
            run = 0
            for p, h in enumerate(self._page_hashes(req, frozen)):
                pg = int(self.table[s, p])
                canon = self.pool.lookup(h, p)
                if canon is not None and canon != pg:
                    self.pool.release(pg)
                    self.pool.retain(canon)
                    self.table[s, p] = canon
                    self.stats.deduped_pages += 1
                    pg = canon
                if run == p and self.pool.refs[pg] >= 2:
                    run = p + 1
            if run > 0 and topo[s, 0] == TOPO_CAUSAL:
                topo[s] = shared_prefix_topology_row(
                    min(run * page, int(req.cursor)), width)
                self.stats.shared_prefix_rows += 1

    # ---------------------------------------------------------------- step

    def _assemble(self):
        from triton_distributed_tpu_torch.kernels.ragged_paged_attention import (
            causal_topologies,
            topo_width,
        )

        cfg = self.cfg
        R, T = cfg.slots, self._t_pad
        tokens = np.zeros((T,), np.int32)
        token_rows = np.zeros((T,), np.int32)
        token_pos = np.full((T,), -1, np.int32)
        # inactive slots point past the budget (the parking zone)
        q_starts = np.full((R,), cfg.token_budget, np.int32)
        q_lens = np.zeros((R,), np.int32)
        kv_dev = np.zeros((R,), np.int32)
        topo_w = topo_width(self._block_q_cap)
        topo = causal_topologies(R, topo_w)
        next_start = 0
        batched: set = set()
        takes: dict = {}
        for s in range(R):
            req = self.slot_req[s]
            if req is None or req.parked or req.done:
                continue
            if len(req.seq) - req.cursor <= 0:
                continue
            take = min(self._chunk_for(req), len(req.seq) - req.cursor)
            if take <= 0:
                continue
            if next_start + _ceil8(take) > cfg.token_budget:
                self.stats.deferrals += 1
                continue                   # token budget spent
            held = self._pages_held(req.cursor)
            need = self._pages_held(req.cursor + take)
            if self.ops.ensure_pages(self, s, held, need, batched):
                span = slice(next_start, next_start + take)
                tokens[span] = req.seq[req.cursor:req.cursor + take]
                token_rows[span] = s
                token_pos[span] = np.arange(
                    req.cursor, req.cursor + take, dtype=np.int32)
                q_starts[s] = next_start
                q_lens[s] = take
                kv_dev[s] = req.cursor + take
                next_start += _ceil8(take)
                batched.add(s)
                takes[s] = take
                continue
            self.stats.deferrals += 1       # no pages even after eviction
        if cfg.prefix_share and batched:
            self._dedup_shared_prefixes(batched, topo, topo_w)
        return (tokens, token_rows, token_pos, q_starts, q_lens, kv_dev,
                topo, batched, takes)

    def _run_device(self, arrays, block_q):
        """One ``serving_step`` on the device; the host fetch of the
        logits is the fence."""
        dev = self.device
        (tokens, token_rows, token_pos, q_starts, q_lens, kv_dev,
         topo) = arrays

        def put(a):
            return torch.as_tensor(a, device=dev)

        state = self.state.replace(
            block_table=put(self.table),
            kv_lens=put(kv_dev),
            cursors=put(np.asarray(
                [0 if r is None else r.cursor for r in self.slot_req],
                np.int32)),
        )
        out = self.model.serving_step(
            self.params, state, put(tokens), put(token_rows),
            put(token_pos), put(q_starts), put(q_lens), put(topo),
            self.moe_state, block_q=block_q,
        )
        if self.moe_state is None:
            logits, self.state = out
        else:
            logits, self.state, self.moe_state = out
        return logits.cpu().numpy()

    def step(self) -> dict:
        """One engine step: admit → assemble → device step → advance
        cursors and completions. Returns a small per-step report."""
        from triton_distributed_tpu_torch.kernels.ragged_paged_attention import (
            auto_block_q,
        )

        self.ops.admit(self)
        (tokens, token_rows, token_pos, q_starts, q_lens, kv_dev,
         topo, batched, takes) = self._assemble()
        report = {"step": self.step_count, "batched": len(batched),
                  "tokens": int(q_lens.sum())}
        if not batched:
            self.step_count += 1
            return report
        block_q = min(self._block_q_cap,
                      auto_block_q(int(q_lens.max()), self._g))
        if int(q_lens.max()) > block_q:
            # the attention kernel computes block_q query rows per row
            raise ValueError(
                f"a row of {int(q_lens.max())} tokens exceeds block_q="
                f"{block_q} (the cap set by chunk={self.cfg.chunk})")
        t0 = time.perf_counter()
        logits = self._run_device(
            (tokens, token_rows, token_pos, q_starts, q_lens, kv_dev, topo),
            block_q)
        dt = time.perf_counter() - t0
        gen_this_step = 0
        prefill_this_step = 0
        for s in sorted(batched):
            emitted, prefill_toks = self._advance_row(
                s, self.slot_req[s], takes[s], logits)
            gen_this_step += emitted
            prefill_this_step += prefill_toks
        self.stats.step_times.append(dt)
        self.stats.step_tokens.append(int(q_lens.sum()))
        self.stats.step_generated.append(gen_this_step)
        self.stats.prefill_tokens += prefill_this_step
        report.update(
            ms=round(dt * 1e3, 3), generated=gen_this_step,
            free_pages=self.pool.available,
            waiting=len(self.waiting) + len(self.pending),
        )
        self.step_count += 1
        return report

    def _advance_row(self, s: int, req, take: int, logits) -> tuple:
        """Move the row's cursor past its packed tokens and sample at the
        sequence frontier. Returns ``(emitted, prefill_tokens)``."""
        self.ops.advance_cursor(self, s, req, take)
        if req.cursor == len(req.seq):
            tok = self._sample(logits[s], req)
            req.generated.append(tok)
            self.ops.complete(self, req, s)
            return 1, take - 1
        return 0, take

    def _sample(self, row_logits, req) -> int:
        """Greedy argmax at ``temperature <= 0``; else softmax sampling
        (top_k-truncated) from a generator keyed on (seed, rid,
        generated-so-far), so scheduling never changes a stream."""
        t = self.cfg.temperature
        if t <= 0.0:
            return int(np.argmax(row_logits))
        z = np.asarray(row_logits, np.float64) / t
        k = self.cfg.top_k
        if 0 < k < z.shape[-1]:
            kth = np.partition(z, -k)[-k]
            z = np.where(z >= kth, z, -np.inf)
        z -= z.max()
        p = np.exp(z)
        p /= p.sum()
        rng = np.random.default_rng(
            (self.cfg.seed, req.rid, len(req.generated)))
        return int(rng.choice(p.shape[-1], p=p))

    def run(self, trace=None, max_steps: int | None = None) -> EngineStats:
        """Drive the engine until the trace drains (or ``max_steps``)."""
        if trace is not None:
            self.submit_trace(trace)
        max_steps = max_steps or self.cfg.max_steps
        for _ in range(max_steps):
            if self.idle:
                break
            self.step()
        return self.stats

    # ------------------------------------------------ shipped admission
    # The decode half of a disaggregated deployment admits requests whose
    # KV was computed elsewhere: reserve_shipped claims the slot and its
    # landing pages up front (parked: eviction never touches it), and
    # commit_shipped makes the row schedulable once the pages have landed.

    def reserve_shipped(self, req) -> tuple | None:
        """Claim a slot + landing pages for a request whose first
        ``req.cursor`` tokens of KV will arrive by transfer —
        :meth:`ProtocolOps.reserve_shipped`. Returns (slot, page_ids) or
        None (the caller retries, the source pages stay pinned)."""
        return self.ops.reserve_shipped(self, req)

    def commit_shipped(self, req) -> None:
        """The transfer into this request's reserved pages has landed —
        :meth:`ProtocolOps.commit_shipped`."""
        self.ops.commit_shipped(self, req)

    def release_parked(self, slot: int) -> None:
        """Free a parked slot — :meth:`ProtocolOps.release_parked`."""
        self.ops.release_parked(self, slot)

    def gather_pages(self, *args, **kwargs):
        """The fleet's replica → replica page moves (``gather_pages`` /
        ``land_pages``): not ported."""
        raise NotImplementedError(
            "ServingEngine.gather_pages / land_pages (replica → replica "
            "page moves) come with serving/fleet.py, ROADMAP Queue 1 "
            "step 5's fleet half")

    land_pages = gather_pages


# ===================================================================
# Disaggregated prefill/decode: two role engines, KV shipped between
# ===================================================================

@dataclass
class ShipRecord:
    """One in-flight KV transfer (prefill pool → decode pool). The pages
    landed at launch; the record holds them pinned on both sides until
    its commit."""

    req: Request
    pslot: int                   # prefill-side slot (pages pinned)
    dslot: int                   # decode-side reserved slot
    dpids: list                  # decode-side landing page ids
    issued_tick: int
    wire_bytes: int
    raw_bytes: int
    span: object = 0.0           # the cohort's (start, end) CUDA events,
                                 # or its host ms on CPU pools
    share: float = 1.0           # this request's page share of the cohort

    @property
    def launch_ms(self) -> float:
        """This request's share of its cohort's ship time (waits for the
        end event, which a later step's sync has passed by the commit)."""
        if isinstance(self.span, tuple):
            start, end = self.span
            end.synchronize()
            return start.elapsed_time(end) * self.share
        return self.span * self.share


@dataclass
class DisaggStats:
    """The two role engines' stats plus the ship ledger. The goodput
    takes the slower role's time: deployed, the roles run side by side.
    ``ship_ms``: each request's page share of its cohort's ship, timed
    on the stream between CUDA events recorded around the wrapper's call
    (on the host clock for CPU pools); with the stream idle at the ship,
    the wrapper's host work before its launch falls inside it.
    ``degraded_transport`` keeps JAX's name and stays False until the
    transport's health and degrade logic are ported (ROADMAP Queue 1
    step 8)."""

    prefill: EngineStats
    decode: EngineStats
    ships: int = 0
    ship_ms: list = field(default_factory=list)
    shipped_wire_bytes: int = 0
    shipped_raw_bytes: int = 0
    degraded_transport: bool = False

    @property
    def failover(self) -> dict | None:
        """The slice-death failover's outcome: always None, since no
        slice dies until that failover is ported (ROADMAP Queue 1 step
        8)."""
        return None

    @property
    def completed(self) -> int:
        return self.decode.completed

    @property
    def goodput_tok_per_s(self) -> float:
        t = max(self.prefill.total_time, self.decode.total_time)
        return (self.decode.generated_tokens / t) if t > 0 else 0.0

    @property
    def decode_p99_step_ms(self) -> float:
        return self.decode.p99_step_ms

    @property
    def wire_compression(self) -> float:
        """Raw-payload bytes per wire byte shipped (> 1: the quantized
        wire shrank the transfer)."""
        return (self.shipped_raw_bytes / self.shipped_wire_bytes
                if self.shipped_wire_bytes else 1.0)


def _one_rank_role(model, what: str) -> None:
    if getattr(model, "tp", 1) > 1 or getattr(model, "cp", 1) > 1:
        raise NotImplementedError(
            f"{what}: roles over a mesh (tp or cp > 1, head-sharded pools) "
            "come with serving over a mesh, ROADMAP Queue 1 step 8; each "
            "role is one rank")


class DisaggregatedEngine:
    """Two-role serving (JAX ``serving/engine.py:1175``): a PREFILL
    engine runs chunked prefill (plus the first token) into its pool;
    each finished request's KV pages then ship to the DECODE engine's
    pool at block-table-assigned slots — int8 payloads with their f32
    scale planes under ``kv_quant``, verbatim — and the decode engine
    admits the request only once its pages have landed (reserve →
    transfer → commit). In-flight ships pin their pages on both sides, so
    eviction never frees a page mid-ship.

    ``transport``: JAX's names and validation — ``"auto"`` is ``"dcn"``
    with a ``hybrid_mesh``, else ``"xla"``; ``"dcn"`` needs the mesh. The
    port's ``hybrid_mesh`` is the role mesh, ``Mesh.grid({"dcn": 2, "tp":
    1})``: rank 0 the prefill role, rank 1 the decode role, the ship's
    r → (r + n/2) % n pairing. Both transports land pages through
    :func:`~triton_distributed_tpu_torch.kernels.kv_ship.ship_kv_pages`,
    one launch a cohort (``tdt_kv_ship`` on the card, the plain version
    on CPU pools); ``"xla"`` differs only in needing no role mesh. On one
    card no byte crosses a link.

    The ship lands the pages at launch, straight into the decode role's
    reserved pages: their row stays parked (no decode step batches it)
    until the commit, ``ship_delay_steps`` ticks later, and both roles
    run on one stream, so the prefill pages freed at commit were read
    before any later prefill step writes them.

    Refused, each with its ROADMAP step: ``placement="auto"`` (step 10),
    ``spec_k > 0`` (step 7), ``health=`` and the transport retry /
    degrade / probe logic and slice-death failover (step 8: a transport
    error propagates, ``stats.degraded_transport`` stays False), roles
    over a mesh (step 8)."""

    def __init__(self, prefill_model, prefill_params, decode_model,
                 decode_params, cfg: EngineConfig, *, decode_cfg=None,
                 hybrid_mesh=None, dcn_axis: str = "dcn",
                 transport: str = "auto", ship_delay_steps: int = 0,
                 placement: str = "force", moe_state="auto", health=None,
                 spec_k: int = 0):
        from dataclasses import replace as _rep

        from triton_distributed_tpu_torch.kernels.kv_ship import ShipTable

        if transport not in ("auto", "dcn", "xla"):
            raise ValueError(f"unknown transport {transport!r}")
        if transport == "auto":
            transport = "dcn" if hybrid_mesh is not None else "xla"
        if transport == "dcn" and hybrid_mesh is None:
            raise ValueError("transport='dcn' needs a hybrid_mesh")
        if placement not in ("force", "auto"):
            raise ValueError(f"unknown placement {placement!r}")
        if placement == "auto":
            raise NotImplementedError(
                "placement='auto' (tune.perf_model.refuse_disaggregation "
                "pricing the ship against the decode window) comes with "
                "the tuning layer, ROADMAP Queue 1 step 10")
        if spec_k:
            raise NotImplementedError(
                "speculative decoding on the decode role (SpeculativeEngine)"
                " comes with ROADMAP Queue 1 step 7")
        if health is not None:
            raise NotImplementedError(
                "health= (the ship's retry, degrade and probe logic and "
                "slice-death failover) comes with runtime/health.py, "
                "ROADMAP Queue 1 step 8")
        for model, role in ((prefill_model, "prefill"),
                            (decode_model, "decode")):
            _one_rank_role(model, f"DisaggregatedEngine's {role} role")
        if hybrid_mesh is not None:
            self._check_role_mesh(hybrid_mesh, dcn_axis, prefill_model,
                                  decode_model)
        if decode_cfg is None:
            # the decode role's batches are at most one token a slot:
            # size its packed width to 8 slots' rows, never wider than
            # the prefill budget (its steps stop paying prefill-sized
            # buffers)
            dbudget = max(8, min(8 * cfg.slots, cfg.token_budget))
            decode_cfg = _rep(cfg, token_budget=dbudget,
                              chunk=min(cfg.chunk, dbudget))
        dcfg = decode_cfg
        if dcfg.page != cfg.page:
            raise ValueError(
                f"page size must match across roles ({cfg.page} vs "
                f"{dcfg.page}) — pages ship verbatim")
        self.transport = transport
        self.hybrid_mesh = hybrid_mesh
        self.dcn_axis = dcn_axis
        self.ship_delay_steps = int(ship_delay_steps)
        self.prefill = ServingEngine(
            prefill_model, prefill_params, _rep(cfg, prefill_only=True),
            moe_state=moe_state, on_complete=self._on_prefill_complete)
        self.decode = ServingEngine(
            decode_model, decode_params, _rep(dcfg, prefill_only=False),
            moe_state=moe_state)
        self._ready: deque = deque()       # (req, prefill slot) to ship
        self._inflight: list = []
        self._ship_table = ShipTable()
        self.ticks = 0
        self.stats = DisaggStats(prefill=self.prefill.stats,
                                 decode=self.decode.stats)

    @staticmethod
    def _check_role_mesh(mesh, axis, prefill_model, decode_model) -> None:
        """The role mesh: ``axis`` of 2 ranks (prefill, decode), every
        other axis of one, on the roles' device."""
        if mesh.axis_size(axis) != 2:
            raise ValueError(f"the role mesh's {axis!r} axis must hold the "
                             f"2 roles, got {mesh.axis_size(axis)}")
        if mesh.size != 2:
            raise NotImplementedError(
                f"a role mesh of {mesh.shape}: roles over several ranks "
                "(tp > 1 head-sharded pools) come with serving over a mesh,"
                " ROADMAP Queue 1 step 8")
        for model in (prefill_model, decode_model):
            if model.device != mesh.device:
                raise ValueError(f"the role mesh is on {mesh.device}, a "
                                 f"role's model on {model.device}")

    def _on_prefill_complete(self, req, slot) -> bool:
        """Prefill-role completion hook: a request done at its first
        token finishes here (credited to the decode ledger, the system's);
        every other parks, its pages pinned, until its KV has shipped."""
        if len(req.generated) >= req.max_new:
            req.done = True
            self.decode.stats.completed += 1
            self.decode.stats.generated_tokens += len(req.generated)
            return True                    # free the prefill slot now
        req.parked = True
        self._ready.append((req, slot))
        return False                       # hold the pages for the ship

    # ------------------------------------------------------------ shipping

    def _launch_ships(self) -> None:
        """Reserve landing pages for the whole ready cohort, then ship it
        in ONE launch: bytes and time are attributed to its requests by
        page share (``stats.ships`` counts requests)."""
        from triton_distributed_tpu_torch.kernels import kv_ship

        cohort = []
        while self._ready:
            req, pslot = self._ready[0]
            res = self.decode.reserve_shipped(req)
            if res is None:
                break                      # decode backpressure; retry
            self._ready.popleft()
            dslot, dpids = res
            npg = self.prefill._pages_held(req.cursor)
            cohort.append((req, pslot, dslot, dpids, npg))
        if not cohort:
            return
        cuda = self.decode.device.type == "cuda"
        if cuda:
            span = tuple(torch.cuda.Event(enable_timing=True)
                         for _ in range(2))
            span[0].record()
        else:
            t0 = time.perf_counter()
        src = np.concatenate([self.prefill.table[pslot, :npg]
                              for _, pslot, _, _, npg in cohort])
        dst = np.concatenate([np.asarray(dpids, np.int64)
                              for _, _, _, dpids, _ in cohort])
        kv_ship.ship_kv_pages(self.prefill.state.layers,
                              self.decode.state.layers, src, dst,
                              table=self._ship_table)
        if cuda:
            span[1].record()
        else:
            span = (time.perf_counter() - t0) * 1e3
        wire, raw = self._ship_bytes(len(src))
        total_pg = len(src)
        for req, pslot, dslot, dpids, npg in cohort:
            frac = npg / total_pg
            self._inflight.append(ShipRecord(
                req=req, pslot=pslot, dslot=dslot, dpids=dpids,
                issued_tick=self.ticks,
                wire_bytes=int(round(wire * frac)),
                raw_bytes=int(round(raw * frac)), span=span, share=frac))

    def _ship_bytes(self, n_pages: int) -> tuple:
        """(wire, raw) bytes of ``n_pages`` pages of every pool, counted
        as JAX's engine counts its payload: the pool's bytes plus the
        scale planes, against 2 B (or the pool's width) an element."""
        q_elems = wire = 0
        width = 2
        for kp, vp in self.prefill.state.layers:
            for pool in (kp, vp):
                q = pool["q"] if isinstance(pool, dict) else pool
                per = q[0].numel() * n_pages
                q_elems += per
                wire += per * q.element_size()
                width = max(2, q.element_size())
                if isinstance(pool, dict):
                    wire += pool["scale"][0].numel() * n_pages * 4
        return wire, q_elems * width

    def _commit_ships(self) -> list:
        """Commit the ships whose delay has passed: the source releases
        its pinned pages first, then the row becomes schedulable
        (:meth:`ProtocolOps.ship_commit`). Returns the committed
        records."""
        ready = [r for r in self._inflight
                 if self.ticks - r.issued_tick >= self.ship_delay_steps]
        for r in ready:
            self.decode.ops.ship_commit(self.prefill, r.pslot, self.decode,
                                        r.req)
            self._warm_prefix_cache(r)
            self._inflight.remove(r)
            self.stats.ships += 1
            self.stats.shipped_wire_bytes += r.wire_bytes
            self.stats.shipped_raw_bytes += r.raw_bytes
            self.stats.ship_ms.append(r.launch_ms)
        return ready

    def _warm_prefix_cache(self, r: ShipRecord) -> None:
        """Register each FULL landed page's prefix-chain hash in the
        decode pool (its content is frozen), so a later request sharing
        the prefix attaches on the decode side without a ship."""
        if not self.decode.pool.prefix_cache:
            return
        full = min(r.req.cursor // self.decode.cfg.page, len(r.dpids))
        if full <= 0:
            return
        hashes = self.decode._page_hashes(r.req, full)
        for p in range(full):
            self.decode.pool.register(int(r.dpids[p]), hashes[p])

    # ------------------------------------------------------------- driving

    @property
    def idle(self) -> bool:
        return (self.prefill.idle and self.decode.idle
                and not self._ready and not self._inflight)

    def submit_trace(self, trace) -> None:
        self.prefill.submit_trace(trace)

    def tick(self) -> dict:
        """One system tick: a prefill step, ship launches and commits, a
        decode step. Deployed, the roles run side by side; here they run
        in turn with the same ordering (no decode step sees a page before
        its commit)."""
        rep_p = None if self.prefill.idle else self.prefill.step()
        self._launch_ships()
        self._commit_ships()
        rep_d = None if self.decode.idle else self.decode.step()
        self.ticks += 1
        return {"tick": self.ticks, "prefill": rep_p, "decode": rep_d,
                "inflight": len(self._inflight), "ready": len(self._ready)}

    def run(self, trace=None, max_ticks: int | None = None) -> DisaggStats:
        """Drive both roles until the trace drains (or ``max_ticks``)."""
        if trace is not None:
            self.submit_trace(trace)
        max_ticks = max_ticks or self.prefill.cfg.max_steps
        for _ in range(max_ticks):
            if self.idle:
                break
            self.tick()
        return self.stats
