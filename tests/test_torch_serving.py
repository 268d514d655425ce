"""Parity of the PyTorch port's serving slice with the JAX package.

Config, presets, the host allocator, one ``serving_step`` with weights
carried over from JAX, and the continuous-batching engine end to end:
the same seeded trace through the JAX engine (on its XLA twin) and the
port's engine (on the CPU, its plain versions) must give equal token
streams and equal ``EngineStats`` counters. Plus the port's hygiene: it
imports neither JAX nor the JAX package, and its entry points refuse to
run on a host without CUDA unless asked for the CPU.
"""

import dataclasses
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_distributed_tpu.models import Transformer as JTransformer
from triton_distributed_tpu.models import TransformerConfig as JConfig
from triton_distributed_tpu.models import presets as jpresets
from triton_distributed_tpu.serving import EngineConfig as JEngineConfig
from triton_distributed_tpu.serving import PagePool as JPagePool
from triton_distributed_tpu.serving import Request as JRequest
from triton_distributed_tpu.serving import ServingEngine as JServingEngine
from triton_distributed_tpu.serving.state import page_chain_hash as j_chain_hash
from triton_distributed_tpu.serving import poisson_trace as j_trace
from triton_distributed_tpu_torch.kernels import auto_block_q
from _torch_moe_ref import tpu_moe  # noqa: F401 (the fixture)
from triton_distributed_tpu_torch.models import (
    Transformer,
    TransformerConfig,
    params_from_numpy,
    presets,
)
from triton_distributed_tpu_torch.serving import (
    EngineConfig,
    PagePool,
    Request,
    ServingEngine,
    page_chain_hash,
    poisson_trace,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]

INT8 = dict(kv_quant="int8", dense_weight_quant="int8",
            dense_act_quant="int8")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the inputs are tiny, and the suite runs in
    several worker processes that share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh1():
    return Mesh(np.asarray(jax.devices()[:1]), ("tp",))


def _jax_and_port(mesh, quant: bool, seed: int = 0):
    """The tiny preset in both packages with the same weights."""
    kw = INT8 if quant else {}
    jm = JTransformer(jpresets.tiny(**kw), mesh, "tp", ())
    params = jm.init(jax.random.PRNGKey(seed))
    if quant:
        params = jm.quantize_dense_weights(params)
    cfg = presets.tiny(**kw)
    tm = Transformer(cfg, device="cpu")
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), cfg, "cpu")
    return jm, params, tm, tparams


# ------------------------------------------------------------ config/presets

def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name not in ("dtype", "param_dtype")}


def _dtype_names(cfg):
    return tuple(jnp.dtype(d).name if not isinstance(d, torch.dtype)
                 else str(d).replace("torch.", "")
                 for d in (cfg.dtype, cfg.param_dtype))


class TestConfig:
    @pytest.mark.parametrize("name", ["llama_7b", "llama_70b",
                                      "mixtral_8x7b", "deepseek_moe_16b",
                                      "tiny"])
    def test_presets_have_the_jax_fields(self, name):
        j, t = getattr(jpresets, name)(), getattr(presets, name)()
        assert _fields(j) == _fields(t)
        assert _dtype_names(j) == _dtype_names(t)
        assert (j.q_dim, j.kv_dim, j.qkv_dim) == (t.q_dim, t.kv_dim,
                                                  t.qkv_dim)

    @pytest.mark.parametrize("bad", [
        dict(attn="x"), dict(moe="x"), dict(kv_quant="fp8"),
        dict(dense_weight_quant="fp8"), dict(dense_act_quant="int8"),
        dict(moe_act_quant="int8"), dict(moe_weight_quant="int8"),
        dict(moe_wire_quant="int4"),
    ])
    def test_validation_matches_jax(self, bad):
        with pytest.raises(ValueError):
            JConfig(**bad)
        with pytest.raises(ValueError):
            TransformerConfig(**bad)

    def test_dtype_names(self):
        cfg = TransformerConfig(dtype="float32", param_dtype="bfloat16")
        assert cfg.dtype == torch.float32
        assert cfg.param_dtype == torch.bfloat16
        assert TransformerConfig(dtype=jnp.float32).dtype == torch.float32


# ------------------------------------------------------------------- state

class TestState:
    def test_page_pool_matches_jax(self):
        """A seeded random walk of allocator verbs leaves both pools in
        the same state after every verb."""
        rng = np.random.default_rng(0)
        pools = (JPagePool(12, 8, prefix_cache=True),
                 PagePool(12, 8, prefix_cache=True))
        held: list = []
        for _ in range(300):
            op = rng.integers(0, 4)
            if op == 0 or not held:
                got = [p.alloc() for p in pools]
                assert got[0] == got[1]
                if got[0] is not None:
                    held.append(got[0])
            elif op == 1:
                pg = held.pop(int(rng.integers(len(held))))
                for p in pools:
                    p.release(pg)
            elif op == 2:
                pg = held[int(rng.integers(len(held)))]
                h = int(rng.integers(0, 6))
                for p in pools:
                    p.register(pg, h)
            else:
                h = int(rng.integers(0, 6))
                got = [p.lookup(h) for p in pools]
                assert got[0] == got[1]
                if got[0] is not None:
                    for p in pools:
                        p.retain(got[0])
                    held.append(got[0])
            a, b = pools
            assert a.free == b.free and a.available == b.available
            np.testing.assert_array_equal(a.refs, b.refs)
            assert a.held_pages == b.held_pages
            assert list(a._reclaim) == list(b._reclaim)
        c = pools[1].clone()
        assert c.free == pools[1].free and c is not pools[1]

    def test_chain_hash_matches_jax(self):
        toks = np.arange(16, dtype=np.int32)
        assert page_chain_hash(7, toks) == j_chain_hash(7, toks)

    def test_serving_state_properties(self, mesh1):
        jm, _, tm, _ = _jax_and_port(mesh1, True)
        js = jm.init_serving_state(4, 16, 8)
        ts = tm.init_serving_state(4, 16, 8)
        for name in ("slots", "pages_per_seq", "npages", "capacity", "page"):
            assert getattr(js, name) == getattr(ts, name), name
        np.testing.assert_array_equal(np.asarray(js.block_table),
                                      ts.block_table.numpy())
        kq = ts.layers[0][0]
        assert kq["q"].dtype == torch.int8 and kq["scale"].shape == (16, 4, 8)


# -------------------------------------------------------------- one step

def _two_steps():
    """Two packed batches over 4 slots (page 8): first prefills of three
    rows, then a decode token, a prompt chunk, a fresh prefill and a
    decode token, with one q_len == 0 slot in the first step."""
    rng = np.random.default_rng(5)
    seqs = [rng.integers(0, 128, (n,)).astype(np.int32)
            for n in (14, 12, 7, 5)]
    #         (slot, start cursor, take)
    plan = [[(0, 0, 12), (1, 0, 5), (3, 0, 3)],
            [(0, 12, 1), (1, 5, 4), (2, 0, 6), (3, 3, 1)]]
    return seqs, plan


def _batch(seqs, rows, t_pad, budget):
    tokens = np.zeros((t_pad,), np.int32)
    token_rows = np.zeros((t_pad,), np.int32)
    token_pos = np.full((t_pad,), -1, np.int32)
    q_starts = np.full((4,), budget, np.int32)
    q_lens = np.zeros((4,), np.int32)
    kv = np.zeros((4,), np.int32)
    nxt = 0
    for s, cur, take in rows:
        tokens[nxt:nxt + take] = seqs[s][cur:cur + take]
        token_rows[nxt:nxt + take] = s
        token_pos[nxt:nxt + take] = np.arange(cur, cur + take)
        q_starts[s], q_lens[s], kv[s] = nxt, take, cur + take
        nxt += -(-take // 8) * 8
    return tokens, token_rows, token_pos, q_starts, q_lens, kv


class TestServingStep:
    @pytest.mark.parametrize("quant", [False, True])
    def test_step_matches_jax(self, mesh1, quant):
        """Logits of the batched rows and the pools after two steps,
        and the port's ``all_logits`` rows at each slot's frontier.

        Tolerances: 1e-4 on logits (f32 sums in another order; measured
        about 2e-6), and on dense f32 pools. int8 pools: a last-bit
        difference in a K/V value can move its int8 code across a
        rounding tie, so codes may differ by 1 in at most 0.5 % of
        entries (none did when this was written). The JAX side runs its
        grouped-GEMM Pallas kernels in interpret mode and its attention
        through the XLA twin (the int8 Pallas attention rounds
        p·v_scale to bf16; the kernel tests hold the port against it at
        2e-2)."""
        jm, params, tm, tparams = _jax_and_port(mesh1, quant)
        table = np.arange(16, dtype=np.int32).reshape(4, 4)
        js = jm.init_serving_state(4, 16, 8)
        ts = tm.init_serving_state(4, 16, 8)
        seqs, plan = _two_steps()
        budget, t_pad = 32, 48
        for rows in plan:
            tok, trow, tpos, qs, ql, kv = _batch(seqs, rows, t_pad, budget)
            block_q = auto_block_q(int(ql.max()), 2)
            js = js.replace(block_table=jnp.asarray(table),
                            kv_lens=jnp.asarray(kv))
            jl, js = jm._serving_jit(
                params, js, *map(jnp.asarray, (tok, trow, tpos, qs, ql)),
                None, None, block_q, False)
            ts = ts.replace(block_table=torch.as_tensor(table),
                            kv_lens=torch.as_tensor(kv))
            batch = tuple(map(torch.as_tensor, (tok, trow, tpos, qs, ql)))
            tl, ts = tm.serving_step(tparams, ts, *batch, block_q=block_q)
            live = ql > 0
            np.testing.assert_allclose(tl.numpy()[live],
                                       np.asarray(jl)[live],
                                       rtol=1e-4, atol=1e-4)
        # all_logits on the same batch (the pool writes repeat the same
        # values): every packed token's logits, the frontier rows equal
        # to the per-slot logits
        al, ts = tm.serving_step(tparams, ts, *batch, block_q=block_q,
                                 all_logits=True)
        assert al.shape == (t_pad, 128)
        last = torch.as_tensor(qs + ql - 1)[torch.as_tensor(live)]
        torch.testing.assert_close(al[last], tl[torch.as_tensor(live)],
                                   rtol=1e-5, atol=1e-5)
        for (jk, jv), (tk, tv) in zip(js.layers, ts.layers):
            for jp, tp in ((jk, tk), (jv, tv)):
                if quant:
                    dq = np.abs(tp["q"].numpy().astype(np.int32)
                                - np.asarray(jp["q"]).astype(np.int32))
                    assert dq.max() <= 1
                    assert (dq > 0).mean() <= 5e-3
                    np.testing.assert_allclose(
                        tp["scale"].numpy(), np.asarray(jp["scale"]),
                        rtol=1e-4)
                else:
                    np.testing.assert_allclose(tp.numpy(), np.asarray(jp),
                                               rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("rows", [8, 1032])
    def test_dmm_runs_every_batch_through_w8a8(self, mesh1, rows):
        """``_dmm`` on an int8 weight is the W8A8 grouped GEMM at every
        batch size, above 1024 rows too (where the JAX ``_dmm`` widens
        the weight instead): bit-equal to quantizing the rows and calling
        the grouped GEMM's plain version."""
        from triton_distributed_tpu_torch.kernels import group_gemm as gg

        _, _, tm, tparams = _jax_and_port(mesh1, True)
        w = tparams["blocks"][0]["up"]
        x = torch.from_numpy(np.random.default_rng(rows).standard_normal(
            (rows, w["q"].shape[0])).astype(np.float32))
        xq, xs = gg.quantize_act_rows(x)
        want = gg.grouped_matmul_plain(
            xq, w["q"][None], torch.zeros((1,), dtype=torch.int32),
            w_scale=w["scale"][None], x_scale=xs, out_dtype=torch.float32)
        torch.testing.assert_close(tm._dmm(x, w), want, rtol=0, atol=0)

    def test_dense_w_matches_jax(self, mesh1):
        """The widened int8 weight equals the JAX package's, bit for
        bit (the same f32 product of code and scale)."""
        jm, params, tm, tparams = _jax_and_port(mesh1, True)
        np.testing.assert_array_equal(
            tm._dense_w(tparams["blocks"][1]["wo"]).numpy(),
            np.asarray(jm._dense_w(params["blocks"][1]["wo"])))

    def test_quantized_init_and_carry_over(self, mesh1):
        _, params, tm, tparams = _jax_and_port(mesh1, True)
        assert tparams["lm_head"]["q"].dtype == torch.int8
        np.testing.assert_array_equal(
            tparams["blocks"][1]["down"]["q"].numpy(),
            np.asarray(params["blocks"][1]["down"]["q"]))
        # the port's own quantizer on the carried float tree agrees
        jm2, fparams, _, tfloat = _jax_and_port(mesh1, False)
        q_port = tm.quantize_dense_weights(tfloat, "int8")
        q_jax = jm2.quantize_dense_weights(fparams, "int8")
        np.testing.assert_array_equal(
            q_port["blocks"][0]["wqkv"]["q"].numpy(),
            np.asarray(q_jax["blocks"][0]["wqkv"]["q"]))
        own = tm.init(torch.Generator().manual_seed(0), quantize=True)
        assert own["blocks"][0]["up"]["q"].shape == (128, 256)
        assert own["embed"].dtype == torch.float32


# --------------------------------------------------------------------- MoE

#: the tiny DeepSeek-MoE preset as served (fp8 wire, int8 W8A8 experts)
#: and its bf16-expert variant (float experts, fp8 wire)
MOE_VARIANTS = {"int8": {}, "float_experts": dict(moe_weight_quant=None,
                                                  moe_act_quant=None)}


def _moe_jax_and_port(mesh, variant, seed=0):
    """The tiny MoE preset in both packages with the same weights (EP:
    the DeepSeek preset in ``variant``; "tp": Mixtral's topology with
    the TP-flavour MoE)."""
    if variant == "tp":
        jcfg = jpresets.tiny(jpresets.mixtral_8x7b(moe="tp"))
        cfg = presets.tiny(presets.mixtral_8x7b(moe="tp"))
    else:
        kw = MOE_VARIANTS[variant]
        jcfg = jpresets.tiny(jpresets.deepseek_moe_16b(**kw))
        cfg = presets.tiny(presets.deepseek_moe_16b(**kw))
    jm = JTransformer(jcfg, mesh, "tp", ())
    params = jm.init(jax.random.PRNGKey(seed))
    params = jm.quantize_moe_weights(jm.quantize_dense_weights(params))
    tm = Transformer(cfg, device="cpu")
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), cfg, "cpu")
    return jm, params, tm, tparams


class TestMoE:
    def test_params_carry_over_bit_for_bit(self, mesh1):
        """The quantized JAX tree carries over with its dtypes (int8 q,
        f32 scales, f32 router); the port's quantize_moe_weights on the
        carried float tree equals JAX's; the port's own init keeps the
        router f32 and quantizes the experts it draws."""
        jm, params, tm, tparams = _moe_jax_and_port(mesh1, "int8")
        jb, tb = params["blocks"][1], tparams["blocks"][1]
        assert "up" not in tb and tb["router"].dtype == torch.float32
        for name in ("moe_up", "moe_down"):
            assert tb[name]["q"].dtype == torch.int8
            assert tb[name]["scale"].dtype == torch.float32
            for k in ("q", "scale"):
                np.testing.assert_array_equal(tb[name][k].numpy(),
                                              np.asarray(jb[name][k]))
        np.testing.assert_array_equal(tb["router"].numpy(),
                                      np.asarray(jb["router"]))
        fparams = jm.init(jax.random.PRNGKey(0))
        tfloat = params_from_numpy(jax.tree.map(np.asarray, fparams),
                                   tm.config, "cpu")
        q_port = tm.quantize_moe_weights(tfloat)["blocks"][1]["moe_down"]
        q_jax = jm.quantize_moe_weights(fparams)["blocks"][1]["moe_down"]
        for k in ("q", "scale"):
            np.testing.assert_array_equal(q_port[k].numpy(),
                                          np.asarray(q_jax[k]))
        np.testing.assert_array_equal(
            tm._expert_w(q_port).numpy(), np.asarray(jm._expert_w(q_jax)))
        own = tm.init(torch.Generator().manual_seed(0), quantize=True)
        assert own["blocks"][1]["router"].dtype == torch.float32
        assert own["blocks"][1]["moe_up"]["q"].shape == (8, 128, 256)
        assert "moe_up" not in own["blocks"][0]

    @pytest.mark.parametrize("variant", ["int8", "float_experts", "tp"])
    def test_step_matches_jax(self, mesh1, tpu_moe, variant):
        """Two packed steps: logits of the batched rows within 1e-4 (f32
        sums in another order, as for the dense model; the fp8 wire and
        the W8A8 experts are bit-equal on these inputs), the persistent
        MoE workspaces threaded through both (EP), none for TP."""
        jm, params, tm, tparams = _moe_jax_and_port(mesh1, variant)
        table = np.arange(16, dtype=np.int32).reshape(4, 4)
        js = jm.init_serving_state(4, 16, 8)
        ts = tm.init_serving_state(4, 16, 8)
        budget, t_pad = 32, 48
        jst = jm.init_decode_state(t_pad)
        tst = tm.init_decode_state(t_pad)
        assert (jst is None) == (tst is None) == (variant == "tp")
        seqs, plan = _two_steps()
        for rows in plan:
            tok, trow, tpos, qs, ql, kv = _batch(seqs, rows, t_pad, budget)
            block_q = auto_block_q(int(ql.max()), 2)
            js = js.replace(block_table=jnp.asarray(table),
                            kv_lens=jnp.asarray(kv))
            jout = jm._serving_jit(
                params, js, *map(jnp.asarray, (tok, trow, tpos, qs, ql)),
                None, jst, block_q, False)
            ts = ts.replace(block_table=torch.as_tensor(table),
                            kv_lens=torch.as_tensor(kv))
            batch = tuple(map(torch.as_tensor, (tok, trow, tpos, qs, ql)))
            tout = tm.serving_step(tparams, ts, *batch, None, tst,
                                   block_q=block_q)
            if tst is None:
                (jl, js), (tl, ts) = jout, tout
            else:
                jl, js, jst = jout
                tl, ts, tst = tout
                assert int(tst[1].parity[0]) == int(np.asarray(
                    jst[1].parity)[0])
            live = ql > 0
            np.testing.assert_allclose(tl.numpy()[live],
                                       np.asarray(jl)[live],
                                       rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------------ engine

def _run_both(mesh, quant, ecfg, trace_fn, **ekw):
    jm, params, tm, tparams = _jax_and_port(mesh, quant)
    jtr, ttr = trace_fn(JRequest), trace_fn(Request)
    jstats = JServingEngine(jm, params, JEngineConfig(**ecfg),
                            use_pallas=False, **ekw).run(jtr, max_steps=600)
    tstats = ServingEngine(tm, tparams, EngineConfig(**ecfg),
                           **ekw).run(ttr, max_steps=600)
    return jtr, jstats, ttr, tstats


COUNTERS = ("completed", "generated_tokens", "prefill_tokens", "evictions",
            "deferrals", "prefix_hits", "shared_prefix_rows",
            "deduped_pages", "preemptions")


def _assert_same(jtr, jstats, ttr, tstats):
    assert [r.generated for r in ttr] == [r.generated for r in jtr]
    assert [r.evictions for r in ttr] == [r.evictions for r in jtr]
    for name in COUNTERS:
        assert getattr(tstats, name) == getattr(jstats, name), name
    assert len(tstats.step_times) == len(jstats.step_times)
    assert tstats.step_tokens == jstats.step_tokens
    assert tstats.step_generated == jstats.step_generated


class TestEngine:
    @pytest.mark.parametrize("quant", [False, True])
    def test_streams_and_counters_match_jax_under_eviction(self, mesh1,
                                                           quant):
        ecfg = dict(slots=4, token_budget=48, chunk=16, page=8, npages=12)

        def trace(_cls):
            return j_trace(7, 8, 1.0, 5, 30, 3, 6, 128) if _cls is JRequest \
                else poisson_trace(7, 8, 1.0, 5, 30, 3, 6, 128)

        jtr, jstats, ttr, tstats = _run_both(mesh1, quant, ecfg, trace)
        assert tstats.completed == 8
        assert tstats.evictions > 0, "the pool failed to force an eviction"
        _assert_same(jtr, jstats, ttr, tstats)

    def test_shared_prefix_dedup_matches_jax(self, mesh1):
        """prefix_cache + prefix_share: SHARED_PREFIX rows reach the
        attention and the counters and streams still match."""
        ecfg = dict(slots=4, token_budget=64, chunk=16, page=8, npages=40,
                    prefix_cache=True, prefix_share=True)
        base = np.random.default_rng(3).integers(0, 128, (24,))

        def trace(cls):
            rng = np.random.default_rng(4)
            return [cls(rid=i, prompt=np.concatenate(
                [base, rng.integers(0, 128, (3 + i,))]).astype(np.int32),
                max_new=4, arrival=float(i)) for i in range(5)]

        jtr, jstats, ttr, tstats = _run_both(mesh1, False, ecfg, trace)
        assert tstats.shared_prefix_rows > 0 and tstats.prefix_hits > 0
        _assert_same(jtr, jstats, ttr, tstats)

    def test_sampled_streams_match_jax(self, mesh1):
        """temperature/top_k sampling keyed on (seed, rid, n)."""
        ecfg = dict(slots=4, token_budget=48, chunk=16, page=8, npages=32,
                    temperature=1.0, top_k=8, seed=3)

        def trace(_cls):
            return j_trace(2, 5, 1.0, 5, 20, 3, 6, 128) if _cls is JRequest \
                else poisson_trace(2, 5, 1.0, 5, 20, 3, 6, 128)

        _assert_same(*_run_both(mesh1, False, ecfg, trace))

    @pytest.mark.parametrize("variant", ["int8", "float_experts"])
    def test_moe_streams_and_counters_match_jax(self, mesh1, tpu_moe,
                                                variant):
        """The tiny DeepSeek-MoE preset served by both engines, the JAX
        one on the TPU's MoE path, under eviction."""
        ecfg = dict(slots=4, token_budget=48, chunk=16, page=8, npages=12)
        jm, params, tm, tparams = _moe_jax_and_port(mesh1, variant)
        jtr = j_trace(7, 8, 1.0, 5, 30, 3, 6, 128)
        ttr = poisson_trace(7, 8, 1.0, 5, 30, 3, 6, 128)
        jstats = JServingEngine(jm, params, JEngineConfig(**ecfg),
                                use_pallas=False).run(jtr, max_steps=600)
        eng = ServingEngine(tm, tparams, EngineConfig(**ecfg))
        assert eng.moe_state is not None
        tstats = eng.run(ttr, max_steps=600)
        assert tstats.completed == 8 and tstats.evictions > 0
        _assert_same(jtr, jstats, ttr, tstats)

    def test_poisson_trace_matches_jax(self):
        a = j_trace(11, 16, 0.25, 128, 1024, 16, 32, 32000)
        b = poisson_trace(11, 16, 0.25, 128, 1024, 16, 32, 32000)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.prompt, y.prompt)
            assert (x.max_new, x.arrival) == (y.max_new, y.arrival)

    def test_rows_longer_than_block_q_raise(self):
        """A row longer than the attention's block_q would leave query
        rows the kernel never computes: the engine refuses the step."""
        cfg = presets.tiny()
        tm = Transformer(cfg, device="cpu")
        params = tm.init(torch.Generator().manual_seed(0))

        class WideChunks(ServingEngine):
            def _chunk_for(self, req):
                return 40                  # past block_q_cap = 16

        eng = WideChunks(tm, params, EngineConfig(
            slots=2, token_budget=48, chunk=16, page=8, npages=16))
        eng.submit_trace(poisson_trace(1, 1, 1.0, 40, 41, 2, 3, cfg.vocab))
        with pytest.raises(ValueError, match="block_q"):
            for _ in range(4):
                eng.step()

    def test_config_errors(self):
        tm = Transformer(presets.tiny(), device="cpu")
        with pytest.raises(ValueError):
            ServingEngine(tm, {}, EngineConfig(token_budget=20))
        with pytest.raises(ValueError):
            ServingEngine(tm, {}, EngineConfig(chunk=128, token_budget=64))
        with pytest.raises(ValueError):
            ServingEngine(tm, {}, EngineConfig(prefix_share=True))


# ----------------------------------------------------------------- hygiene

PORT_FILES = sorted((ROOT / "triton_distributed_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py", ROOT / "ab_main_path.py",
       ROOT / "ab_gemms.py", ROOT / "ab_wire.py", ROOT / "ab_tp.py",
       ROOT / "ab_common.py"]

_IMPORT = re.compile(r"^\s*(?:import|from)\s+([\w.]+)")


class TestHygiene:
    @pytest.mark.parametrize("path", PORT_FILES,
                             ids=lambda p: str(p.relative_to(ROOT)))
    def test_no_jax_imports_in_the_port(self, path):
        for line in path.read_text().splitlines():
            m = _IMPORT.match(line)
            if not m:
                continue
            mod = m.group(1).split(".")[0]
            assert mod not in ("jax", "jaxlib", "triton_distributed_tpu"), (
                f"{path.name}: {line.strip()}")
            assert "importlib" not in line or "jax" not in line

    def test_port_import_loads_no_jax(self):
        code = (
            "import sys, triton_distributed_tpu_torch.serving, "
            "triton_distributed_tpu_torch.models, "
            "triton_distributed_tpu_torch.ops, "
            "triton_distributed_tpu_torch.layers, chip_smoke; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'triton_distributed_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                             capture_output=True, text=True)
        assert out.returncode == 0, out.stdout + out.stderr

    def test_entry_points_refuse_a_missing_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            Transformer(presets.tiny())
        with pytest.raises(RuntimeError, match="CUDA"):
            Transformer(presets.tiny(), device="cuda")
        assert Transformer(presets.tiny(), device="cpu").device.type == "cpu"

    def test_chip_smoke_refuses_without_a_card(self):
        """The smoke script exits non-zero with no result line here."""
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
