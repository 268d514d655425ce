"""Parity of the port's KV-page ship and disaggregated serving with the
JAX package, on the CPU.

* The plain mesh ship against JAX's TPU kernel ``_kv_ship_kernel``, run
  in interpret mode under ``jax.shard_map`` (``build_lint_kernel``) on 2
  and 4 of the virtual devices, at coalesce 1 and 2: every int8 page and
  f32 scale row lands on rank (r + n/2) % n at its slot, byte for byte.
* The landing-table helpers, ``ship_wire_bytes``, and the pool plumbing
  (gather → scatter on pools the tiny model filled, int8 and raw) equal
  JAX's; the engine form of the ship equals gather → scatter.
* The five ship verbs leave tables, pool counts and parked flags equal
  to JAX's.
* ``DisaggregatedEngine`` on ``tests/test_kv_ship.py``'s configuration,
  with JAX's weights carried across: token streams equal JAX's
  ``DisaggregatedEngine`` and the colocated engine's, and so do the ship
  counters; the port's forms of JAX's scenarios (admission gates on
  shipped pages, no eviction mid-ship, parked rows never evicted,
  ``max_new=1`` finishing on the prefill side, sampling across
  topologies); every refusal raising its ROADMAP step.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from triton_distributed_tpu.kernels import kv_ship as jks
from triton_distributed_tpu.models import Transformer as JTransformer
from triton_distributed_tpu.models import TransformerConfig as JConfig
from triton_distributed_tpu.serving import DisaggregatedEngine as JDisagg
from triton_distributed_tpu.serving import EngineConfig as JEngineConfig
from triton_distributed_tpu.serving import Request as JRequest
from triton_distributed_tpu.serving import ServingEngine as JServingEngine
from triton_distributed_tpu.serving import poisson_trace as j_trace
from triton_distributed_tpu.tune.schedule import GridSchedule as JGrid
from triton_distributed_tpu_torch.kernels import kv_ship as ks
from triton_distributed_tpu_torch.models import (
    Transformer,
    TransformerConfig,
    params_from_numpy,
)
from triton_distributed_tpu_torch.runtime import Mesh
from triton_distributed_tpu_torch.serving import (
    DisaggregatedEngine,
    EngineConfig,
    Request,
    ServingEngine,
    poisson_trace,
)
from triton_distributed_tpu_torch.tune.schedule import GridSchedule

CFG = dict(
    vocab=128, n_layers=2, hidden=64, ffn=128,
    n_heads=4, n_kv_heads=2, head_dim=16,
    dtype=jnp.float32, param_dtype=jnp.float32, kv_quant="int8",
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _roles():
    return Mesh.grid({"dcn": 2, "tp": 1}, "cpu")


# ------------------------------------------------------------ mesh form

def _staged(n, pages, rows, cols, seed):
    rng = np.random.default_rng(seed)
    q = rng.integers(-128, 128, (n, pages * rows, cols)).astype(np.int8)
    s = rng.standard_normal((n, pages * rows, 128)).astype(np.float32)
    return q, s


@functools.lru_cache(maxsize=None)
def _jax_mesh_ship(n, coalesce):
    """JAX's ``_kv_ship_kernel`` at ``KV_SHIP_GEOM`` on ``n`` devices
    (interpret mode) with the coalesced landing table on every rank →
    (staged q, staged s, table, landed q, landed s) as numpy, (n, ...)."""
    g = jks.KV_SHIP_GEOM
    pages, rows, cols = g["pages"], g["rows"], g["cols"]
    mesh = JMesh(np.asarray(jax.devices()[:n]), ("x",))
    fn = jks.build_lint_kernel(mesh, n, schedule=JGrid(coalesce=coalesce))
    q, s = _staged(n, pages, rows, cols, seed=10 * n + coalesce)
    table = np.asarray(jks.coalesced_landing_table(pages, coalesce), np.int32)
    run = jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=(P("x"), P("x"), P("x")),
        out_specs=(P("x"), P("x")), check_vma=False))
    oq, os_ = run(jnp.asarray(np.tile(table, n)),
                  jnp.asarray(q.reshape(n * pages * rows, cols)),
                  jnp.asarray(s.reshape(n * pages * rows, 128)))
    return (q, s, table, np.asarray(oq).reshape(q.shape),
            np.asarray(os_).reshape(s.shape))


class TestMeshShip:
    @pytest.mark.parametrize("n,coalesce", [(2, 1), (2, 2), (4, 1), (4, 2)])
    def test_plain_ship_equals_the_tpu_kernel(self, n, coalesce):
        q, s, table, jq, js = _jax_mesh_ship(n, coalesce)
        oq, os_ = ks.kv_ship(
            list(torch.from_numpy(q)), list(torch.from_numpy(s)),
            np.tile(table, (n, 1)), Mesh.loopback(n, "cpu", axis="x"), "x",
            schedule=GridSchedule(coalesce=coalesce))
        np.testing.assert_array_equal(torch.stack(oq).numpy(), jq)
        np.testing.assert_array_equal(torch.stack(os_).numpy(), js)
        # and the JAX kernel's landing is the pairing's: rank r's staged
        # page i at slot table[tick] + offset of rank (r + n/2) % n
        rows = KV_ROWS
        for r in range(n):
            to = (r + n // 2) % n
            for i in range(len(table)):
                slot = table[i - i % coalesce] + i % coalesce
                np.testing.assert_array_equal(
                    jq[to, slot * rows:(slot + 1) * rows],
                    q[r, i * rows:(i + 1) * rows])

    def test_raw_wire_ships_the_payload_alone(self):
        q, _ = _staged(2, 4, 8, 128, seed=5)
        table = [[2, 0, 3, 1], [1, 3, 0, 2]]
        oq, os_ = ks.kv_ship(list(torch.from_numpy(q)), None, table,
                             Mesh.loopback(2, "cpu", axis="x"), "x")
        assert os_ is None
        for r in range(2):
            for i, slot in enumerate(table[r]):
                np.testing.assert_array_equal(
                    oq[1 - r][slot * 8:(slot + 1) * 8].numpy(),
                    q[r, i * 8:(i + 1) * 8])

    @pytest.mark.parametrize("pages,coalesce", [(4, 1), (4, 2), (4, 4),
                                                (8, 2), (64, 4)])
    def test_landing_helpers_equal_jax(self, pages, coalesce):
        table = ks.coalesced_landing_table(pages, coalesce)
        assert table == jks.coalesced_landing_table(pages, coalesce)
        rng = np.random.default_rng(pages + coalesce)
        for t in (table, list(rng.permutation(pages)), table[::-1],
                  table[:-1]):
            assert (ks.coalesced_landing_ok(t, coalesce)
                    == jks.coalesced_landing_ok(t, coalesce))

    @pytest.mark.parametrize("args", [(4, 8, 2, 16, 2, True),
                                      (64, 16, 16, 128, 28, True),
                                      (3, 8, 2, 16, 2, False)])
    def test_ship_wire_bytes_equal_jax(self, args):
        assert ks.ship_wire_bytes(*args) == jks.ship_wire_bytes(*args)

    @pytest.mark.parametrize("bad,match", [
        (dict(table=[[1, 0, 3, 2]] * 2, coalesce=2), "contiguous run"),
        (dict(table=[[0, 1, 2, 3]] * 2, coalesce=3), "does not divide"),
        (dict(table=[[0, 0, 1, 2]] * 2, coalesce=1), "repeats a slot"),
        (dict(table=[[0, 1, 2, 4]] * 2, coalesce=1), "outside"),
    ])
    def test_illegal_tables_are_refused(self, bad, match):
        q, s = _staged(2, 4, 8, 128, seed=1)
        with pytest.raises(ValueError, match=match):
            ks.kv_ship(list(torch.from_numpy(q)), list(torch.from_numpy(s)),
                       bad["table"], Mesh.loopback(2, "cpu", axis="x"), "x",
                       schedule=GridSchedule(coalesce=bad["coalesce"]))

    @pytest.mark.parametrize("sched", [GridSchedule(rail="shared"),
                                       GridSchedule(rail="drop"),
                                       GridSchedule(coalesce=2, rail="drop"),
                                       GridSchedule(block_q=8)])
    def test_illegal_schedules_cite_step_10(self, sched):
        q, s = _staged(2, 4, 8, 128, seed=1)
        with pytest.raises(ValueError, match="step 10"):
            ks.kv_ship(list(torch.from_numpy(q)), list(torch.from_numpy(s)),
                       [[0, 1, 2, 3]] * 2, Mesh.loopback(2, "cpu", axis="x"),
                       "x", schedule=sched)


KV_ROWS = jks.KV_SHIP_GEOM["rows"]


# ------------------------------------------------------- pool plumbing

@functools.lru_cache(maxsize=None)
def _jax_models():
    """The JAX roles of ``tests/test_kv_ship.py`` (one device each, the
    2 × 1 hybrid mesh) with their weights, and the port's model with the
    same weights, per kv_quant."""
    devs = jax.devices()
    mesh_p = JMesh(np.asarray(devs[:1]), ("tp",))
    mesh_d = JMesh(np.asarray(devs[1:2]), ("tp",))
    hybrid = JMesh(np.asarray(devs[:2]).reshape(2, 1), ("dcn", "tp"))
    mp = JTransformer(JConfig(**CFG), mesh_p, "tp", ())
    md = JTransformer(JConfig(**CFG), mesh_d, "tp", ())
    params = mp.init(jax.random.PRNGKey(0))
    pp = jax.tree.map(lambda x, s: jax.device_put(x, s), params,
                      mp.shardings())
    pd = jax.tree.map(lambda x, s: jax.device_put(x, s), params,
                      md.shardings())
    return mp, pp, md, pd, hybrid, jax.tree.map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def _port_model(quant: bool = True):
    cfg = TransformerConfig(**{**CFG, "kv_quant": "int8" if quant else None})
    tm = Transformer(cfg, device="cpu")
    return tm, params_from_numpy(_jax_models()[5], cfg, "cpu")


def _filled_pools(quant):
    """The port's tiny model's pools after prefilling a 20-token request,
    parked so that its pages stay resident → (layers, its page ids)."""
    tm, tp = _port_model(quant)
    eng = ServingEngine(tm, tp, EngineConfig(slots=2, token_budget=32,
                                             chunk=8, page=8, npages=16),
                        on_complete=lambda r, s: False)
    req = Request(rid=0, prompt=np.arange(20, dtype=np.int32), max_new=1)
    eng.run([req], max_steps=40)
    pids = eng.table[req.slot, :eng._pages_held(req.cursor)]
    assert (pids >= 0).all() and len(pids) == 3
    return eng.state.layers, pids


def _np_layers(layers):
    return tuple(tuple(
        {k: v.numpy() for k, v in p.items()} if isinstance(p, dict)
        else p.numpy() for p in pair) for pair in layers)


def _fresh_like(layers):
    return tuple(tuple(
        {k: torch.zeros_like(v) for k, v in p.items()} if isinstance(p, dict)
        else torch.zeros_like(p) for p in pair) for pair in layers)


class TestPoolPlumbing:
    @pytest.mark.parametrize("quant", [True, False])
    def test_gather_scatter_equal_jax(self, quant):
        layers, pids = _filled_pools(quant)
        q, s = ks.gather_kv_pages(layers, pids)
        jq, js = jax.jit(jks.gather_kv_pages)(
            _np_layers(layers), jnp.asarray(pids.astype(np.int32)))
        assert q.dtype == (torch.int8 if quant else torch.float32)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert (s is None) == (js is None) == (not quant)
        if quant:
            np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        dst = np.arange(len(pids), dtype=np.int32)[::-1].copy() + 5
        fresh = _fresh_like(layers)
        landed = ks.scatter_kv_pages(fresh, dst, q, s)
        jlanded = jax.jit(jks.scatter_kv_pages)(
            _np_layers(_fresh_like(layers)), jnp.asarray(dst), jq, js)
        for a, b in zip(jax.tree.leaves(_np_layers(landed)),
                        jax.tree.leaves(jlanded)):
            np.testing.assert_array_equal(a, np.asarray(b))
        # the engine form lands the same bytes in one pass
        shipped = _fresh_like(layers)
        ks.ship_kv_pages(layers, shipped, pids, dst)
        for a, b in zip(jax.tree.leaves(_np_layers(shipped)),
                        jax.tree.leaves(_np_layers(landed))):
            np.testing.assert_array_equal(a, b)

    def test_engine_form_refuses_mixed_pools(self):
        layers, pids = _filled_pools(True)
        raw, _ = _filled_pools(False)
        with pytest.raises(ValueError, match="quantized pool"):
            ks.ship_kv_pages(layers, _fresh_like(raw), pids, pids)


# ------------------------------------------------------------- the verbs

def _verb_state(eng):
    return (eng.table.copy(), int(eng.pool.available),
            eng.pool.refs.copy(),
            [None if r is None else (r.rid, r.parked, r.slot)
             for r in eng.slot_req])


class TestVerbs:
    def test_ship_verbs_match_jax(self):
        mp, pp, *_ = _jax_models()
        tm, tp = _port_model()
        ecfg = dict(slots=3, token_budget=32, chunk=8, page=8, npages=12)
        engines = []
        for E, C, R, m, p in ((JServingEngine, JEngineConfig, JRequest, mp,
                               pp),
                              (ServingEngine, EngineConfig, Request, tm, tp)):
            kw = dict(use_pallas=False) if E is JServingEngine else {}
            src, dst = (E(m, p, C(**ecfg), **kw) for _ in range(2))
            reqs = [R(rid=i, prompt=np.arange(10 + 7 * i, dtype=np.int32),
                      max_new=4) for i in range(4)]
            for r in reqs:
                r.cursor = len(r.prompt)
            states = []
            # the source holds requests 0 and 1 parked in slots 0 and 1
            for i in (0, 1):
                assert src.ops.alloc(src, i, 0, src._pages_held(
                    reqs[i].cursor))
                src.slot_req[i] = reqs[i]
                reqs[i].slot, reqs[i].parked = i, True
            # three slots: the fourth reservation finds none
            got = [dst.reserve_shipped(r) for r in reqs]
            assert got[3] is None
            states.append((got, _verb_state(dst)))
            src.ops.ship_commit(src, 0, dst, reqs[0])
            states.append((_verb_state(src), _verb_state(dst)))
            dst.commit_shipped(reqs[2])
            src.ops.ship_abort(dst, got[1][0], reqs[1], 1)
            states.append((_verb_state(src), _verb_state(dst),
                           [(r.slot, r.parked) for r in reqs]))
            again = dst.reserve_shipped(reqs[3])
            dst.release_parked(again[0])
            states.append((again, _verb_state(dst), reqs[3].parked))
            engines.append(states)
        jstates, tstates = engines
        for a, b in zip(jax.tree.leaves(jstates), jax.tree.leaves(tstates)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert len(jax.tree.leaves(jstates)) == len(jax.tree.leaves(tstates))

    def test_release_of_an_unparked_slot_raises(self):
        tm, tp = _port_model()
        eng = ServingEngine(tm, tp, EngineConfig(slots=2, token_budget=32,
                                                 chunk=8, page=8, npages=16))
        with pytest.raises(ValueError, match="no parked request"):
            eng.release_parked(0)


# ------------------------------------------------------------ the engine

ECFG = dict(slots=4, token_budget=48, chunk=16, page=8, npages=32)


@functools.lru_cache(maxsize=None)
def _jax_disagg():
    """JAX's DisaggregatedEngine on the DCN wire (and its colocated
    engine) over the seeded trace → (streams, ships, wire, raw,
    colocated streams)."""
    mp, pp, md, pd, hybrid, _ = _jax_models()
    tc, td = (j_trace(7, 6, 1.0, 5, 30, 3, 6, 128) for _ in range(2))
    JServingEngine(mp, pp, JEngineConfig(**ECFG),
                   use_pallas=False).run(tc, max_steps=400)
    st = JDisagg(mp, pp, md, pd, JEngineConfig(**ECFG), hybrid_mesh=hybrid,
                 dcn_axis="dcn", transport="dcn", ship_delay_steps=1,
                 use_pallas=False).run(td, max_ticks=600)
    return ([r.generated for r in td], st.ships, st.shipped_wire_bytes,
            st.shipped_raw_bytes, [r.generated for r in tc])


def _port_disagg(ecfg=ECFG, trace=(7, 6, 1.0, 5, 30, 3, 6, 128), **kw):
    tm, tp = _port_model()
    eng = DisaggregatedEngine(tm, tp, tm, tp, EngineConfig(**ecfg),
                              hybrid_mesh=_roles(), **kw)
    tr = poisson_trace(*trace)
    return eng, tr


def _colocated(ecfg, trace):
    tm, tp = _port_model()
    tr = poisson_trace(*trace)
    ServingEngine(tm, tp, EngineConfig(**ecfg)).run(tr, max_steps=600)
    return [r.generated for r in tr]


class _Checked(DisaggregatedEngine):
    """Checks at every commit, before the source releases, that each
    landed page and scale plane equals its source page."""

    def _commit_ships(self):
        for r in self._inflight:
            if self.ticks - r.issued_tick < self.ship_delay_steps:
                continue
            src = self.prefill.table[r.pslot, :len(r.dpids)]
            q, s = ks.gather_kv_pages(self.prefill.state.layers, src)
            dq, dsc = ks.gather_kv_pages(self.decode.state.layers, r.dpids)
            assert torch.equal(q, dq) and torch.equal(s, dsc)
            self.checked += 1
        return super()._commit_ships()


class TestDisaggregatedEngine:
    def test_streams_and_ship_counters_equal_jax(self):
        jstreams, jships, jwire, jraw, jcol = _jax_disagg()
        tm, tp = _port_model()
        eng = _Checked(tm, tp, tm, tp, EngineConfig(**ECFG),
                       hybrid_mesh=_roles(), transport="dcn",
                       ship_delay_steps=1)
        eng.checked = 0
        tr = poisson_trace(7, 6, 1.0, 5, 30, 3, 6, 128)
        st = eng.run(tr, max_ticks=600)
        assert st.completed == 6 and st.ships == jships > 0
        assert eng.checked == st.ships
        assert [r.generated for r in tr] == jstreams == jcol
        assert _colocated(ECFG, (7, 6, 1.0, 5, 30, 3, 6, 128)) == jcol
        assert (st.shipped_wire_bytes, st.shipped_raw_bytes) == (jwire, jraw)
        assert st.wire_compression > 1.0 and not st.degraded_transport
        assert len(st.ship_ms) == st.ships and st.failover is None
        assert eng.transport == "dcn"

    def test_xla_transport_lands_the_same_streams(self):
        """Without a role mesh 'auto' is 'xla': the same ship, the same
        streams."""
        tm, tp = _port_model()
        eng = DisaggregatedEngine(tm, tp, tm, tp, EngineConfig(**ECFG),
                                  ship_delay_steps=2)
        assert eng.transport == "xla"
        tr = poisson_trace(7, 6, 1.0, 5, 30, 3, 6, 128)
        eng.run(tr, max_ticks=600)
        assert [r.generated for r in tr] == _jax_disagg()[0]

    def test_admission_gates_on_shipped_pages(self):
        """Between launch and commit the decode slot is reserved and
        parked: its pages claimed, its row never batched."""
        eng, _ = _port_disagg(dict(slots=2, token_budget=32, chunk=8,
                                   page=8, npages=16), ship_delay_steps=3)
        req = Request(rid=0, prompt=np.arange(12, dtype=np.int32),
                      max_new=4)
        eng.submit_trace([req])
        saw = False
        while not eng.idle and eng.ticks < 100:
            eng.tick()
            if eng._inflight:
                r = eng._inflight[0]
                assert req.parked
                held = eng.decode.table[r.dslot]
                assert (held[:len(r.dpids)] >= 0).all()
                assert sum(eng.decode.stats.step_generated) == 0
                saw = True
        assert saw and req.done and sum(eng.decode.stats.step_generated) > 0
        ref = Request(rid=0, prompt=np.arange(12, dtype=np.int32), max_new=4)
        tm, tp = _port_model()
        ServingEngine(tm, tp, EngineConfig(slots=2, token_budget=32, chunk=8,
                                           page=8, npages=16)).run([ref])
        assert req.generated == ref.generated

    def test_eviction_never_frees_pages_mid_ship(self):
        """JAX's eviction scenario at one rank a role (its tp = 2 test's
        pools): a decode pool small enough for a mid-stream eviction while
        later ships are in flight, whose pages and pins stay intact."""
        tm, tp = _port_model()
        ecfg = dict(slots=4, token_budget=48, chunk=16, page=8, npages=32)
        eng = DisaggregatedEngine(
            tm, tp, tm, tp, EngineConfig(**ecfg),
            decode_cfg=EngineConfig(slots=4, token_budget=32, chunk=16,
                                    page=8, npages=14),
            hybrid_mesh=_roles(), ship_delay_steps=2)
        trace = poisson_trace(9, 6, 0.7, 8, 30, 3, 6, 128)
        eng.submit_trace(trace)
        while not eng.idle and eng.ticks < 800:
            eng.tick()
            for r in eng._inflight:
                assert r.req.parked
                assert (list(eng.decode.table[r.dslot, :len(r.dpids)])
                        == list(r.dpids))
                assert eng.prefill.slot_req[r.pslot] is r.req
        assert eng.stats.completed == 6 and eng.stats.decode.evictions > 0
        assert ([r.generated for r in trace]
                == _colocated(ecfg, (9, 6, 0.7, 8, 30, 3, 6, 128)))

    def test_parked_requests_are_never_eviction_victims(self):
        tm, tp = _port_model()
        eng = ServingEngine(tm, tp, EngineConfig(slots=2, token_budget=32,
                                                 chunk=8, page=8, npages=16))
        req = Request(rid=0, prompt=np.arange(9, dtype=np.int32), max_new=2)
        eng.submit(req)
        eng.ops.admit(eng)
        req.parked = True
        assert eng.ops.evict_one(eng, set()) is False
        req.parked = False
        assert eng.ops.evict_one(eng, set()) is True

    def test_max_new_1_completes_on_the_prefill_side(self):
        eng, _ = _port_disagg(dict(slots=2, token_budget=32, chunk=8,
                                   page=8, npages=16))
        req = Request(rid=0, prompt=np.arange(10, dtype=np.int32), max_new=1)
        st = eng.run([req], max_ticks=50)
        assert st.completed == 1 and st.ships == 0 and req.done
        assert st.decode.generated_tokens == 1 and len(req.generated) == 1

    def test_sampling_token_exact_across_topologies(self):
        ecfg = dict(slots=3, token_budget=48, chunk=16, page=8, npages=24,
                    temperature=0.8, top_k=12, seed=5)
        eng, td = _port_disagg(ecfg, (3, 4, 1.0, 5, 24, 3, 6, 128),
                               ship_delay_steps=1)
        eng.run(td, max_ticks=500)
        assert [r.generated for r in td] == _colocated(
            ecfg, (3, 4, 1.0, 5, 24, 3, 6, 128))
        assert all(len(r.generated) == r.max_new for r in td)

    def test_a_transport_error_propagates(self, monkeypatch):
        def boom(*a, **k):
            raise RuntimeError("injected ship failure")

        monkeypatch.setattr(ks, "ship_kv_pages", boom)
        eng, tr = _port_disagg()
        with pytest.raises(RuntimeError, match="injected"):
            eng.run(tr, max_ticks=600)
        assert not eng.stats.degraded_transport

    def test_decode_role_is_derived_as_in_jax(self):
        eng, _ = _port_disagg(dict(slots=16, token_budget=512, chunk=256,
                                   page=16, npages=64))
        assert eng.decode.cfg.token_budget == 128
        assert eng.decode.cfg.chunk == 128
        assert eng.prefill.cfg.prefill_only and not eng.decode.cfg.prefill_only

    @pytest.mark.parametrize("kw,err,match", [
        (dict(placement="auto"), NotImplementedError, "step 10"),
        (dict(spec_k=2), NotImplementedError, "step 7"),
        (dict(health=object()), NotImplementedError, "step 8"),
        (dict(hybrid_mesh=Mesh.grid({"dcn": 2, "tp": 2}, "cpu")),
         NotImplementedError, "step 8"),
        (dict(hybrid_mesh=Mesh.grid({"dcn": 4, "tp": 1}, "cpu")),
         ValueError, "2 roles"),
        (dict(hybrid_mesh=None, transport="dcn"), ValueError, "hybrid_mesh"),
        (dict(transport="ici"), ValueError, "unknown transport"),
        (dict(decode_cfg=EngineConfig(page=16)), ValueError, "page size"),
    ])
    def test_refusals(self, kw, err, match):
        tm, tp = _port_model()
        kw = {"hybrid_mesh": _roles(), **kw}
        with pytest.raises(err, match=match):
            DisaggregatedEngine(tm, tp, tm, tp, EngineConfig(**ECFG), **kw)

    def test_fleet_verbs_cite_step_5(self):
        tm, tp = _port_model()
        eng = ServingEngine(tm, tp, EngineConfig(**ECFG))
        for call in (lambda: eng.gather_pages([0]),
                     lambda: eng.land_pages([0], None, None),
                     lambda: eng.ops.migrate_live_core(None, eng, eng, 0, 1,
                                                       None)):
            with pytest.raises(NotImplementedError, match="step 5"):
                call()

    def test_roles_over_a_mesh_are_refused(self):
        tp2 = Transformer(_port_model()[0].config,
                          mesh=Mesh.loopback(2, "cpu"))
        tm, tp = _port_model()
        with pytest.raises(NotImplementedError, match="step 8"):
            DisaggregatedEngine(tp2, tp, tm, tp, EngineConfig(**ECFG))
