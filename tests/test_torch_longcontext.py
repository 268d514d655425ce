"""Parity of the PyTorch port's long-context (context-parallel) serving
with the JAX package.

The JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``
with its XLA twins (``use_pallas=False``); the port on the CPU, where
every kernel wrapper runs its plain PyTorch version because the tensors
lie on the CPU. The same inputs, drawn with numpy from a seed (the
weights carried over from JAX's init), go through both:

* (a) ``combine_gqa_partials``: the cp shards' merge, with masked rows
  and empty shards, within 1e-6 in f32 (JAX's ``einsum`` adds the
  shards in its own order, the port in shard order); a row held by one
  shard comes out bit-equal to that shard's partial;
* (b) the shard decomposition: each shard's ragged partial under a
  TOPO_CP row, merged, equals one full causal run; and the model's
  one-launch shard walk (``Transformer._cp_ragged_attn``) equals JAX's
  shard loop;
* (c) ``CpPagePool``'s routing and its combined views, verb by verb on
  one allocation trace;
* (d) cp = 2 engines (a tp = 1, cp = 2 mesh) whose long request needs
  more pages than one shard holds: token streams equal to JAX's cp
  engine and to the port's own cp-free oracle, in f32, with int8 KV, and
  under eviction (5 pages a shard);
* (e) the refusals: ``prefix_share`` under cp, tp > 1 beside cp (ROADMAP
  Queue 1 item 12), a schedule field the combine cannot run.

The JAX engines run once each (``functools.lru_cache``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from triton_distributed_tpu.kernels.flash_decode import (
    combine_gqa_partials as j_combine,
)
from triton_distributed_tpu.kernels.ragged_paged_attention import (
    cp_topology_row as j_cp_row,
)
from triton_distributed_tpu.kernels.ragged_paged_attention import (
    ragged_paged_attention_xla as j_ragged,
)
from triton_distributed_tpu.models import Transformer as JTransformer
from triton_distributed_tpu.models import TransformerConfig as JConfig
from triton_distributed_tpu.serving import EngineConfig as JEngineConfig
from triton_distributed_tpu.serving import Request as JRequest
from triton_distributed_tpu.serving import ServingEngine as JServingEngine
from triton_distributed_tpu.serving.state import CpPagePool as JCpPagePool
from triton_distributed_tpu_torch.kernels import cp_ring
from triton_distributed_tpu_torch.kernels.flash_decode import (
    combine_gqa_partials,
)
from triton_distributed_tpu_torch.kernels.ragged_paged_attention import (
    NEG_INF,
    cp_topology_row,
    pack_gqa_rows,
    ragged_paged_attention_plain,
    topo_width,
)
from triton_distributed_tpu_torch.models import (
    Transformer,
    TransformerConfig,
    params_from_numpy,
)
from triton_distributed_tpu_torch.runtime import Mesh
from triton_distributed_tpu_torch.serving import (
    CpPagePool,
    EngineConfig,
    Request,
    ServingEngine,
)
from triton_distributed_tpu_torch.tune.schedule import RingSchedule

PAGE = 4
CP = 2
#: JAX's einsum and the port's shard-order sums of the same f32 terms
COMBINE_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the inputs are tiny, and the suite runs in
    several worker processes that share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(kv_quant=None):
    """JAX's ``tests/test_longcontext.py`` ``_tcfg`` in f32, both sides."""
    kw = dict(vocab=128, n_layers=2, hidden=64, ffn=128, n_heads=4,
              n_kv_heads=2, head_dim=16, kv_quant=kv_quant)
    return (JConfig(dtype=jnp.float32, param_dtype=jnp.float32, **kw),
            TransformerConfig(dtype="float32", param_dtype="float32", **kw))


def _jmesh(cp):
    devs = np.asarray(jax.devices()[:cp]).reshape(1, cp)
    return JMesh(devs, ("tp", "cp"))


@functools.lru_cache(maxsize=None)
def _jax_model(kv_quant, cp):
    jcfg, _ = _cfg(kv_quant)
    jm = JTransformer(jcfg, _jmesh(cp), "tp", (),
                      cp_axis="cp" if cp > 1 else None)
    return jm, jm.init(jax.random.PRNGKey(0))


def _port_model(kv_quant, cp):
    _, cfg = _cfg(kv_quant)
    _, params = _jax_model(kv_quant, 1)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), cfg, "cpu")
    if cp == 1:
        return Transformer(cfg, device="cpu"), tparams
    mesh = Mesh.grid({"tp": 1, "cp": cp}, "cpu")
    return Transformer(cfg, mesh=mesh, cp_axis="cp"), tparams


def _requests(cls):
    """JAX's long-context trace: a 30-token prompt + 10 new tokens (10
    pages, more than one 6-page shard) and a short request that stays on
    shard 0; the long prompt prefills in four chunks of 8."""
    rng = np.random.default_rng(0)
    return [cls(rid=0, prompt=rng.integers(1, 127, 30, np.int32), max_new=10,
                arrival=0),
            cls(rid=1, prompt=rng.integers(1, 127, 7, np.int32), max_new=6,
                arrival=0)]


def _run(eng, cls):
    done = {}
    eng.on_complete = lambda req, slot: done.setdefault(
        req.rid, list(req.generated)) or True
    eng.run(_requests(cls))
    return done


def _ecfg(cls, npages):
    return cls(slots=2, token_budget=16, chunk=8, page=PAGE, npages=npages,
               max_steps=800, temperature=0.0)


@functools.lru_cache(maxsize=None)
def _jax_streams(kv_quant, cp, npages):
    """JAX's engine on the XLA twins: (streams, evictions)."""
    jm, params = _jax_model(kv_quant, cp)
    if cp == 1:
        jm = JTransformer(jm.config, JMesh(np.asarray(jax.devices()[:1]),
                                           ("tp",)), "tp", ())
    eng = JServingEngine(jm, params, _ecfg(JEngineConfig, npages),
                         use_pallas=False)
    return _run(eng, JRequest), eng.stats.evictions


class _LongLogits(ServingEngine):
    """The long request's (rid 0) logits each time it samples, by the
    number of tokens it had generated."""

    def _advance_row(self, s, req, take, logits):
        if req.rid == 0 and req.cursor + take == len(req.seq):
            self.long_logits.setdefault(len(req.generated),
                                        np.array(logits[s]))
        return super()._advance_row(s, req, take, logits)


def _port_engine(kv_quant, cp, npages, **kw):
    tm, tparams = _port_model(kv_quant, cp)
    eng = _LongLogits(tm, tparams, _ecfg(EngineConfig, npages), **kw)
    eng.long_logits = {}
    return eng


# --------------------------------------------------- (a) the combine


def _partials(seed, r, hkv=2, tg=12, d=16):
    """Seeded partials with every masking case: rows only shard 0 saw,
    rows no shard saw (partials 0, lses NEG_INF), an empty last shard."""
    rng = np.random.default_rng(seed)
    outs = rng.standard_normal((r, hkv, tg, d)).astype(np.float32)
    lses = (3.0 * rng.standard_normal((r, hkv, tg))).astype(np.float32)
    lses[1:, :, :3] = NEG_INF          # shard 0 only
    lses[:, :, 3:5] = NEG_INF          # every shard masked
    lses[-1, :, 7:] = NEG_INF          # the last shard past the data
    outs[lses <= NEG_INF / 2] = 0.0
    return outs, lses


class TestCombine:
    @pytest.mark.parametrize("r", [2, 3, 4])
    def test_matches_jax(self, r):
        """The merge and its lse within 1e-6 of JAX's (relative to the
        largest output); masked rows exactly 0 with lse NEG_INF."""
        outs, lses = _partials(r, r)
        jo, jl = j_combine(jnp.asarray(outs), jnp.asarray(lses))
        to, tl = combine_gqa_partials(torch.from_numpy(outs),
                                      torch.from_numpy(lses))
        jo, jl = np.asarray(jo), np.asarray(jl)
        assert np.abs(to.numpy() - jo).max() <= COMBINE_TOL * np.abs(jo).max()
        ok = jl > NEG_INF / 2
        np.testing.assert_array_equal(tl.numpy() > NEG_INF / 2, ok)
        assert np.abs(tl.numpy()[ok] - jl[ok]).max() <= COMBINE_TOL * max(
            np.abs(jl[ok]).max(), 1.0)
        assert (to.numpy()[:, 3:5] == 0).all()
        assert (tl.numpy()[:, 3:5] == NEG_INF).all()

    def test_shard_zero_rows_are_bit_exact(self):
        """A row whose only finite lse is shard 0's weighs 1 and 0: its
        merge is shard 0's partial bit for bit, in bf16 too."""
        outs, lses = _partials(5, 2)
        for dtype in (torch.float32, torch.bfloat16):
            o = torch.from_numpy(outs).to(dtype)
            got, lse = combine_gqa_partials(o, torch.from_numpy(lses))
            assert got.dtype == dtype
            assert torch.equal(got[:, :3], o[0, :, :3])
            assert torch.equal(lse[:, :3], torch.from_numpy(lses[0, :, :3]))

    def test_strided_views_and_depths(self):
        """The serving step passes the partials as views (shard, head)
        of one (Hkv, R·TG, D) output; both ring depths give the same
        values (the depth adds a TPU ring slot and no value)."""
        outs, lses = _partials(6, 2)
        o, l = torch.from_numpy(outs), torch.from_numpy(lses)
        flat_o = o.permute(1, 0, 2, 3).reshape(2, -1, 16).contiguous()
        flat_l = l.permute(1, 0, 2).reshape(2, -1).contiguous()
        view_o = flat_o.view(2, 2, 12, 16).transpose(0, 1)
        view_l = flat_l.view(2, 2, 12).transpose(0, 1)
        want = cp_ring.cp_lse_combine_plain(o, l)
        for depth in (2, 3):
            got = cp_ring.cp_lse_combine(view_o, view_l,
                                         schedule=RingSchedule(depth=depth))
            assert all(torch.equal(g, w) for g, w in zip(got, want))


# ------------------------------------------ (b) the shard decomposition


class TestShardDecomposition:
    HKV, G, D, KPAGE = 2, 2, 32, 8

    def test_shard_decomposition_matches_full_causal(self):
        """JAX's case: kv = 37 split as shard 0 = 24 (shift 13), shard 1
        = 13 (shift 0) and an empty shard: the merged partials equal one
        full causal run of the port and JAX's, and the empty shard's lse
        is NEG_INF (weight 0)."""
        rng = np.random.default_rng(3)
        k = rng.standard_normal((8, self.HKV, self.KPAGE, self.D)).astype(
            np.float32)
        v = rng.standard_normal((8, self.HKV, self.KPAGE, self.D)).astype(
            np.float32)
        q = rng.standard_normal((8, self.HKV * self.G, self.D)).astype(
            np.float32)
        width = topo_width(8)
        tq = pack_gqa_rows(torch.from_numpy(q), self.HKV)
        tk, tv = torch.from_numpy(k), torch.from_numpy(v)

        def port(kv_len, table, topo):
            return ragged_paged_attention_plain(
                tq, tk, tv, torch.tensor([kv_len], dtype=torch.int32),
                torch.tensor([1], dtype=torch.int32),
                torch.tensor([0], dtype=torch.int32),
                torch.tensor([table], dtype=torch.int32), group=self.G,
                topologies=topo)

        full = [0, 1, 2, 3, 4]
        ref, _ = port(37, full, None)
        jq = jnp.asarray(np.asarray(tq))
        jref, _ = j_ragged(jq, jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray([37], jnp.int32),
                           jnp.asarray([1], jnp.int32),
                           jnp.asarray([0], jnp.int32),
                           jnp.asarray([full], jnp.int32), group=self.G)
        shards = [(24, [0, 1, 2, -1, -1], 13), (13, [3, 4, -1, -1, -1], 0),
                  (0, [0, -1, -1, -1, -1], 0)]
        outs, lses = [], []
        for kv_len, table, shift in shards:
            row = cp_topology_row(shift, width)
            np.testing.assert_array_equal(row, j_cp_row(shift, width))
            o, l = port(kv_len, table, np.stack([row]))
            outs.append(o)
            lses.append(l)
        assert bool((lses[2][:, :self.G] <= NEG_INF / 2).all())
        merged, _ = combine_gqa_partials(torch.stack(outs), torch.stack(lses))
        g = slice(0, self.G)
        np.testing.assert_allclose(merged[:, g].numpy(), ref[:, g].numpy(),
                                   atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(merged[:, g].numpy(),
                                   np.asarray(jref)[:, g], atol=2e-5,
                                   rtol=2e-5)

    @pytest.mark.parametrize("kv_quant", [None, "int8"])
    def test_one_launch_walk_matches_jax_shard_loop(self, kv_quant):
        """The model's cp attention on seeded pools: the port's one
        launch over every shard's rows (the stacked pool, global page
        ids) against JAX's loop over pool slices, within 1e-5; rows that
        cross the shard boundary, rows inside shard 0 and an idle slot."""
        jm, _ = _jax_model(kv_quant, CP)
        tm, _ = _port_model(kv_quant, CP)
        rng = np.random.default_rng(8)
        npages, slots = 4, 3
        jst = jm.init_serving_state(slots, npages, PAGE)
        tst = tm.init_serving_state(slots, npages, PAGE)
        assert (tst.pages_per_seq, tst.npages, tst.cp, tst.capacity) == (
            jst.pages_per_seq, jst.npages, jst.cp, jst.capacity)
        shape = (CP * npages, 2, PAGE, 16)
        if kv_quant:
            pools = [{"q": rng.integers(-127, 128, shape).astype(np.int8),
                      "scale": rng.uniform(0.01, 0.05, shape[:3]).astype(
                          np.float32)} for _ in range(2)]
        else:
            pools = [rng.standard_normal(shape).astype(np.float32)
                     for _ in range(2)]
        # slot 0: 26 positions over shard 0's 4 pages and 3 of shard 1's;
        # slot 1: 9 positions on shard 0; slot 2 idle
        table = np.full((slots, 8), -1, np.int32)
        table[0, :7] = [3, 0, 1, 2, 4, 6, 5]
        table[1, :3] = [3, 1, 0]
        kv_lens = np.array([26, 9, 0], np.int32)
        q_lens = np.array([5, 1, 0], np.int32)
        q_starts = np.array([0, 8, 16], np.int32)
        t = 24
        qp = rng.standard_normal((2, t * 2, 16)).astype(np.float32)
        topo = np.zeros((slots, 2 + 2 * topo_width(8)), np.int32)

        def j(x):
            return jax.tree.map(jnp.asarray, x)

        @jax.jit
        def walk(qp, kp, vp, table, kv_lens, q_lens, q_starts, topo):
            st = jst.replace(layers=(), block_table=table, kv_lens=kv_lens)
            return jm._cp_ragged_attn(qp, kp, vp, st, q_lens, q_starts, 8,
                                      False, 2, topo)

        jo = walk(*map(j, (qp, pools[0], pools[1], table, kv_lens, q_lens,
                           q_starts, topo)))

        def t_(x):
            return ({k: torch.from_numpy(a) for k, a in x.items()}
                    if isinstance(x, dict) else torch.from_numpy(x))

        to = tm._cp_ragged_attn(
            torch.from_numpy(qp), t_(pools[0]), t_(pools[1]),
            tst.replace(block_table=torch.from_numpy(table),
                        kv_lens=torch.from_numpy(kv_lens)),
            torch.from_numpy(q_lens), torch.from_numpy(q_starts), 8,
            torch.from_numpy(topo))
        jo = np.asarray(jo)
        assert to.shape == jo.shape
        assert np.abs(to.numpy() - jo).max() <= 1e-5 * np.abs(jo).max()


# ------------------------------------------------------- (c) the pool


class TestCpPagePool:
    def test_routing_and_views_match_jax(self):
        """A seeded walk of allocator verbs (alloc by logical index,
        retain, release, register, lookup by index, can_hold) on both
        pools: the same answers and the same combined views after every
        verb."""
        rng = np.random.default_rng(0)
        jp = JCpPagePool(CP, 6, PAGE, 5, prefix_cache=True)
        tp = CpPagePool(CP, 6, PAGE, 5, prefix_cache=True)
        held: list = []
        for step in range(400):
            op = int(rng.integers(0, 5))
            if op == 0 or not held:
                idx = int(rng.integers(0, 12))
                a, b = jp.alloc(idx), tp.alloc(idx)
                assert a == b
                if a is not None:
                    assert jp.shard_of(a) == tp.owner_of(idx)
                    held.append(a)
            elif op == 1:
                pg = held.pop(int(rng.integers(0, len(held))))
                jp.release(pg)
                tp.release(pg)
            elif op == 2:
                pg = held[int(rng.integers(0, len(held)))]
                jp.retain(pg)
                tp.retain(pg)
                held.append(pg)
            elif op == 3:
                pg = held[int(rng.integers(0, len(held)))]
                h = int(rng.integers(0, 8))
                jp.register(pg, h)
                tp.register(pg, h)
            else:
                h, idx = int(rng.integers(0, 8)), int(rng.integers(0, 12))
                assert jp.lookup(h, idx) == tp.lookup(h, idx)
                lo = int(rng.integers(0, 10))
                hi = lo + int(rng.integers(0, 8))
                assert jp.can_hold(lo, hi) == tp.can_hold(lo, hi)
            np.testing.assert_array_equal(jp.refs, tp.refs)
            assert jp.free == tp.free
            assert list(jp._reclaim) == list(tp._reclaim)
            assert jp._hash_of == tp._hash_of and jp._by_hash == tp._by_hash
            assert (jp.available, jp.held_pages) == (tp.available,
                                                     tp.held_pages)
        c = tp.clone()
        assert c.free == tp.free and c.shards[0] is not tp.shards[0]
        with pytest.raises(ValueError, match="page index"):
            tp.alloc()


# ---------------------------------------------------- (d) the engines


class TestCpEngine:
    @pytest.mark.parametrize("kv_quant,npages", [(None, 6), ("int8", 6),
                                                 (None, 5)])
    def test_streams_match_jax_and_the_cp_free_oracle(self, kv_quant,
                                                      npages):
        """The long request needs 10 pages, more than a shard's; at 5
        pages a shard the engine evicts and recomputes. The port's cp = 2
        streams equal JAX's cp = 2 engine's and the port's cp-free engine
        (one pool of 12 pages), the long request's logits at every token
        within 1e-5 of the cp-free engine's (f32: the merge rounds apart
        from one softmax in the last bits), and every page returns to
        the pool."""
        eng = _port_engine(kv_quant, CP, npages)
        assert isinstance(eng.pool, CpPagePool)
        assert eng.pool.npages == CP * npages and eng.model.tp == 1
        got = _run(eng, Request)
        assert -(-(30 + 10) // PAGE) > npages
        want, j_evictions = _jax_streams(kv_quant, CP, npages)
        assert got == want
        assert eng.stats.evictions == j_evictions
        if npages == 5:
            assert eng.stats.evictions > 0
        flat = _port_engine(kv_quant, 1, 12)
        assert got == _run(flat, Request)
        assert sorted(eng.long_logits) == list(range(10))
        for i, lg in flat.long_logits.items():
            d = np.abs(eng.long_logits[i] - lg).max()
            assert d <= 1e-5 * np.abs(lg).max(), (i, d)
        assert int(np.asarray(eng.pool.refs).sum()) == 0
        assert len(eng.pool.free) + len(eng.pool._reclaim) == eng.pool.npages


# --------------------------------------------------- (e) the refusals


class TestRefusals:
    def test_prefix_share_under_cp(self):
        with pytest.raises(ValueError, match="context-parallel"):
            ServingEngine(*_port_model(None, CP),
                          EngineConfig(slots=2, token_budget=16, chunk=8,
                                       page=PAGE, npages=6,
                                       prefix_cache=True, prefix_share=True))

    def test_tp_beside_cp_cites_item_12(self):
        _, cfg = _cfg()
        with pytest.raises(NotImplementedError, match="item 12"):
            Transformer(cfg, mesh=Mesh.grid({"tp": 2, "cp": 2}, "cpu"),
                        cp_axis="cp")
        with pytest.raises(NotImplementedError, match="item 11"):
            Transformer(cfg, mesh=Mesh.grid({"tp": 1, "cp": 2}, "cpu"))
        with pytest.raises(ValueError, match="cp_axis"):
            Transformer(cfg, cp_axis="cp", device="cpu")

    def test_combine_schedule_and_shapes(self):
        outs, lses = _partials(7, 2)
        o, l = torch.from_numpy(outs), torch.from_numpy(lses)
        with pytest.raises(ValueError, match="step 10"):
            cp_ring.cp_lse_combine(o, l, schedule=RingSchedule(
                direction="rev"))
        with pytest.raises(ValueError, match="depth"):
            cp_ring.cp_lse_combine(o, l, schedule=RingSchedule(depth=4))
        with pytest.raises(ValueError, match="R, Hkv, TG"):
            cp_ring.cp_lse_combine(o, l[:, :, :5])
