"""Parity of the PyTorch port's prefill → decode path with the JAX package.

The same inputs, drawn with numpy from a seed, go through the JAX
function (its Pallas kernels in interpret mode, as
tests/test_flash_decode.py runs them) and the port's counterpart, whose
CPU path is the plain PyTorch version: the four flash-decode entries and
``combine_partials``, the KV appends, the world-size-1 ``ag_gemm`` /
``gemm_rs``, and ``prefill`` + ``generate`` end to end. The CUDA kernels
are held against the plain versions in tests/test_torch_cuda.py.

Head dim 128 sends JAX to its aligned kernels (``_decode_kernel_dyn``,
``_decode_kernel_dyn_mh``, ``_paged_kernel_dyn_mh``), head dim 16 to
``_decode_kernel`` and ``_paged_decode_kernel``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_distributed_tpu.kernels import flash_decode as jfd
from triton_distributed_tpu.kernels.ag_gemm import ag_gemm as j_ag_gemm
from triton_distributed_tpu.kernels.gemm_rs import gemm_rs as j_gemm_rs
from triton_distributed_tpu.layers import attention as jattn
from triton_distributed_tpu.models import Transformer as JTransformer
from triton_distributed_tpu.models import presets as jpresets
from triton_distributed_tpu_torch import layers, ops
from triton_distributed_tpu_torch.kernels import ag_gemm as tag
from triton_distributed_tpu_torch.kernels import flash_decode as tfd
from triton_distributed_tpu_torch.kernels import gemm_rs as trs
from triton_distributed_tpu_torch.models import (
    Transformer,
    caches_from_numpy,
    params_from_numpy,
    presets,
)
from triton_distributed_tpu_torch.tools import generate as tgen

INT8 = dict(kv_quant="int8", dense_weight_quant="int8",
            dense_act_quant="int8")
B, HKV, G, S = 3, 2, 2, 256
#: an empty row, a full row, a partial row
LENS = np.array([0, S, 77], np.int32)


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


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _qkv(seed, d, layout="bhsd"):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, HKV * G, d)).astype(np.float32)
    shape = (B, HKV, S, d) if layout == "bhsd" else (B, S, HKV, d)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    return q, k, v


def _close(got, want, tol):
    out, lse = got
    wout, wlse = want
    np.testing.assert_allclose(_np(out), np.asarray(wout, np.float32),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(wlse), rtol=tol,
                               atol=tol)


# ------------------------------------------------------------ decode entries

class TestDecodeEntries:
    @pytest.mark.parametrize("d,layout,dtype,soft_cap", [
        (128, "bhsd", "float32", 0.0), (128, "bhsd", "bfloat16", 0.0),
        (128, "bshd", "float32", 0.0), (16, "bhsd", "float32", 5.0),
        (16, "bshd", "float32", 0.0)])
    def test_contiguous_matches_jax(self, d, layout, dtype, soft_cap):
        """f32: both sides sum f32 products in another order, 1e-5. bf16:
        one bf16 rounding of out (2^-8 relative) and of p on both sides,
        1e-2. The empty row gives zeros and NEG_INF on both."""
        q, k, v = _qkv(0, d, layout)
        jdt = getattr(jnp, dtype)
        want = jfd.gqa_fwd_batch_decode(
            jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
            jnp.asarray(LENS), kv_layout=layout, soft_cap=soft_cap)
        tdt = getattr(torch, dtype)
        got = tfd.gqa_fwd_batch_decode(
            _t(q).to(tdt), _t(k).to(tdt), _t(v).to(tdt), _t(LENS),
            kv_layout=layout, soft_cap=soft_cap)
        assert got[0].dtype == tdt
        _close(got, want, 1e-5 if dtype == "float32" else 1e-2)
        assert np.all(_np(got[0])[0] == 0.0)
        assert np.all(got[1].numpy()[0] == tfd.NEG_INF)

    @pytest.mark.parametrize("d", [16, 128])
    def test_q8_matches_jax(self, d):
        """Head dim 16 widens to f32 on both sides: 1e-5. Head dim 128
        takes the int8 kernel's numerics on both (q in bf16, scale folds,
        p·v_scale rounded to bf16), but JAX rounds p against the max of
        its one 256-position block and the port against the running max
        of its 64-position tiles: 2e-3 (JAX's own XLA twin, which does
        not round p at all, is 1.4e-3 from its kernel here)."""
        q, k, v = _qkv(1, d)
        kq, ks = jfd.quantize_kv(jnp.asarray(k))
        vq, vs = jfd.quantize_kv(jnp.asarray(v))
        want = jfd.gqa_fwd_batch_decode_q8(jnp.asarray(q), kq, ks, vq, vs,
                                           jnp.asarray(LENS), soft_cap=3.0)
        got = tfd.gqa_fwd_batch_decode_q8(_t(q), _t(kq), _t(ks), _t(vq),
                                          _t(vs), _t(LENS), soft_cap=3.0)
        assert got[0].dtype == torch.float32
        _close(got, want, 1e-5 if d == 16 else 2e-3)

    @pytest.mark.parametrize("d,page,quant", [(128, 128, False),
                                              (128, 128, True),
                                              (16, 8, False), (16, 8, True)])
    def test_paged_matches_jax(self, d, page, quant):
        """Pools in a seeded permutation of pages, table entries past a
        row's length pointing anywhere (-1 included). 1e-5, except int8
        at page 128, where p is rounded to bf16 against the running max
        of JAX's 128-position pages and of the port's 64-position tiles:
        2e-3."""
        rng = np.random.default_rng(2)
        pps = S // page
        npages = B * pps + 3
        q = rng.standard_normal((B, HKV * G, d)).astype(np.float32)
        kp = rng.standard_normal((npages, HKV, page, d)).astype(np.float32)
        vp = rng.standard_normal((npages, HKV, page, d)).astype(np.float32)
        table = rng.permutation(npages)[:B * pps].reshape(B, pps)
        table = table.astype(np.int32)
        table[2, -1] = -1                   # past row 2's 77 positions
        if quant:
            kq, ks = jfd.quantize_kv(jnp.asarray(kp))
            vq, vs = jfd.quantize_kv(jnp.asarray(vp))
            want = jfd.paged_gqa_fwd_batch_decode_q8(
                jnp.asarray(q), kq, ks, vq, vs, jnp.asarray(LENS),
                jnp.asarray(table))
            got = tfd.paged_gqa_fwd_batch_decode_q8(
                _t(q), _t(kq), _t(ks), _t(vq), _t(vs), _t(LENS), _t(table))
            tol = 1e-5 if d == 16 else 2e-3
        else:
            want = jfd.paged_gqa_fwd_batch_decode(
                jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                jnp.asarray(LENS), jnp.asarray(table), soft_cap=4.0)
            got = tfd.paged_gqa_fwd_batch_decode(
                _t(q), _t(kp), _t(vp), _t(LENS), _t(table), soft_cap=4.0)
            tol = 1e-5
        _close(got, want, tol)

    @pytest.mark.parametrize("quant", [False, True])
    def test_paged_equals_contiguous(self, quant):
        """A contiguous cache and its paginated copy give equal outputs
        (the CUDA kernels walk both in the same tiles)."""
        cfg = presets.tiny(head_dim=128, **(INT8 if quant else {}))
        tm = Transformer(cfg, device="cpu")
        caches = tm.init_cache(B, S)
        rng = np.random.default_rng(3)
        for ck, cv in caches:
            for c in (ck, cv):
                if quant:
                    c["q"].copy_(_t(rng.integers(-127, 128, c["q"].shape,
                                                 dtype=np.int8)))
                    c["scale"].copy_(_t(rng.random(c["scale"].shape,
                                                   dtype=np.float32)))
                else:
                    c.copy_(_t(rng.standard_normal(c.shape,
                                                   dtype=np.float32)))
        pools, table = tm.paginate_caches(caches, page=128)
        assert table.shape == (1, B, S // 128)
        q = _t(rng.standard_normal((B, cfg.n_heads, 128), dtype=np.float32))
        attn = tm._sp_attn
        a = attn.partials(q, *caches[0], _t(LENS))
        b = attn.partials(q, *pools[0], _t(LENS), table)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])

    def test_combine_partials_matches_jax(self):
        rng = np.random.default_rng(4)
        outs = rng.standard_normal((3, B, 4, 16)).astype(np.float32)
        lses = rng.standard_normal((3, B, 4)).astype(np.float32)
        lses[1, 0] = tfd.NEG_INF                 # an empty partial
        want = jfd.combine_partials(jnp.asarray(outs), jnp.asarray(lses))
        got = tfd.combine_partials(_t(outs), _t(lses))
        _close(got, want, 1e-6)
        got = tfd.combine_partials(_t(outs), _t(lses),
                                   out_dtype=torch.bfloat16)
        assert got[0].dtype == torch.bfloat16

    def test_pick_block_k_matches_jax(self):
        for s_len in (16, 100, 256, 384, 2048, 4099):
            for req in (16, 128, 1024, 2048):
                assert tfd.pick_block_k(s_len, req) == jfd.pick_block_k(
                    s_len, req)

    def test_layer_token_partial_matches_jax(self, mesh1):
        rng = np.random.default_rng(5)
        q = rng.standard_normal((B, 4, 16)).astype(np.float32)
        kn = rng.standard_normal((B, 2, 16)).astype(np.float32)
        vn = rng.standard_normal((B, 2, 16)).astype(np.float32)
        jl = jattn.SpGQAFlashDecodeAttention(mesh1, "tp", q_heads=4,
                                             kv_heads=2, head_dim=16,
                                             soft_cap=2.0)
        tl = layers.SpGQAFlashDecodeAttention(q_heads=4, kv_heads=2,
                                              head_dim=16, soft_cap=2.0)
        want = jl.token_partial(jnp.asarray(q), jnp.asarray(kn),
                                jnp.asarray(vn))
        _close(tl.token_partial(_t(q), _t(kn), _t(vn)), want, 1e-6)


# --------------------------------------------------------------- KV appends

class TestAppend:
    @pytest.mark.parametrize("kind", ["bhsd", "bshd", "int8"])
    def test_append_kv_matches_jax(self, kind):
        """Rows at capacity drop the write on both sides; the lengths
        still count up. Caches compare bit for bit."""
        rng = np.random.default_rng(6)
        lens = np.array([0, 7, 8], np.int32)       # row 2 is full (S = 8)
        shape = (3, 8, 2, 16) if kind == "bshd" else (3, 2, 8, 16)
        kc = rng.standard_normal(shape).astype(np.float32)
        vc = rng.standard_normal(shape).astype(np.float32)
        kn = rng.standard_normal((3, 2, 16)).astype(np.float32)
        vn = rng.standard_normal((3, 2, 16)).astype(np.float32)
        layout = "bshd" if kind == "bshd" else "bhsd"
        if kind == "int8":
            jk = dict(zip(("q", "scale"), jfd.quantize_kv(jnp.asarray(kc))))
            jv = dict(zip(("q", "scale"), jfd.quantize_kv(jnp.asarray(vc))))
        else:
            jk, jv = jnp.asarray(kc), jnp.asarray(vc)
        want = jattn.append_kv(jk, jv, jnp.asarray(lens), jnp.asarray(kn),
                               jnp.asarray(vn), kv_layout=layout)
        tk, tv = caches_from_numpy(
            [jax.tree.map(np.asarray, (jk, jv))], "cpu")[0]
        got = layers.append_kv(tk, tv, _t(lens), _t(kn), _t(vn),
                               kv_layout=layout)
        for w, g in zip(jax.tree.leaves(want[:2]), jax.tree.leaves(got[:2])):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(got[2].numpy(), lens + 1)

    @pytest.mark.parametrize("quant", [False, True])
    def test_paged_append_kv_matches_jax(self, quant):
        rng = np.random.default_rng(7)
        lens = np.array([0, 13, 16, 5], np.int32)  # row 2 is full (2 x 8)
        table = rng.permutation(8).astype(np.int32).reshape(1, 4, 2)
        kp = rng.standard_normal((8, 2, 8, 16)).astype(np.float32)
        vp = rng.standard_normal((8, 2, 8, 16)).astype(np.float32)
        kn = rng.standard_normal((4, 2, 16)).astype(np.float32)
        vn = rng.standard_normal((4, 2, 16)).astype(np.float32)
        if quant:
            jk = dict(zip(("q", "scale"), jfd.quantize_kv(jnp.asarray(kp))))
            jv = dict(zip(("q", "scale"), jfd.quantize_kv(jnp.asarray(vp))))
        else:
            jk, jv = jnp.asarray(kp), jnp.asarray(vp)
        want = jattn.paged_append_kv(jk, jv, jnp.asarray(table),
                                     jnp.asarray(lens), jnp.asarray(kn),
                                     jnp.asarray(vn))
        tk, tv = caches_from_numpy(
            [jax.tree.map(np.asarray, (jk, jv))], "cpu")[0]
        got = layers.paged_append_kv(tk, tv, _t(table), _t(lens), _t(kn),
                                     _t(vn))
        for w, g in zip(jax.tree.leaves(want[:2]), jax.tree.leaves(got[:2])):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -------------------------------------------------------- world-size-1 GEMMs

class TestGemmN1:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("op", ["ag_gemm", "gemm_rs"])
    def test_matches_jax(self, mesh1, op, dtype):
        """f32 sums on both sides: 1e-5 in f32; bf16 out, one bf16
        rounding (2^-8 relative)."""
        rng = np.random.default_rng(8)
        a = rng.standard_normal((40, 48)).astype(np.float32)
        b = (rng.standard_normal((48, 24)) / 7).astype(np.float32)
        jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
        jfn = j_ag_gemm if op == "ag_gemm" else j_gemm_rs
        want = jfn(jnp.asarray(a, jdt), jnp.asarray(b, jdt), mesh1, "tp")
        tfn = tag.ag_gemm if op == "ag_gemm" else trs.gemm_rs
        got = tfn(_t(a).to(tdt), _t(b).to(tdt))
        assert got.dtype == tdt
        tol = 1e-5 if dtype == "float32" else 2.0 ** -8
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)
        ctx = (ops.create_ag_gemm_context() if op == "ag_gemm"
               else ops.create_gemm_rs_context())
        op_fn = ops.ag_gemm if op == "ag_gemm" else ops.gemm_rs
        assert torch.equal(op_fn(_t(a).to(tdt), _t(b).to(tdt), ctx), got)

    def test_world_size_above_one_raises(self):
        """Above world size 1 the ops take lists of per-rank shards
        (tests/test_torch_tp.py); tensors are refused."""
        from triton_distributed_tpu_torch.runtime import Mesh

        a = torch.zeros((4, 8))
        with pytest.raises(ValueError, match="per-rank shards"):
            tag.ag_gemm(a, torch.zeros((8, 2)), Mesh.loopback(2, "cpu"))
        with pytest.raises(ValueError, match="per-rank shards"):
            ops.gemm_rs(a, torch.zeros((8, 2)),
                        ops.OverlapContext(Mesh.loopback(4, "cpu")))

    @pytest.mark.parametrize("activation", ["silu", "gelu"])
    def test_parallel_mlp(self, activation):
        g = torch.Generator().manual_seed(0)
        mlp = layers.ParallelMLP(
            layers.ColumnParallelLinear(ops.create_ag_gemm_context()),
            layers.RowParallelLinear(ops.create_gemm_rs_context()),
            activation=activation)
        p = {"up": {"w": torch.randn((32, 64), generator=g)},
             "down": {"w": torch.randn((64, 32), generator=g) / 8}}
        x = torch.randn((5, 32), generator=g)
        h = x @ p["up"]["w"]
        h = (torch.nn.functional.silu(h) if activation == "silu" else
             torch.from_numpy(np.array(jax.nn.gelu(h.numpy()))))
        torch.testing.assert_close(mlp(p, x), h @ p["down"]["w"],
                                   rtol=1e-5, atol=1e-5)


# ------------------------------------------------------- prefill → generate

def _models(mesh, cfg_kw, seed=0):
    jm = JTransformer(jpresets.tiny(**cfg_kw), mesh, "tp", ())
    params = jm.quantize_dense_weights(jm.init(jax.random.PRNGKey(seed)))
    cfg = presets.tiny(**cfg_kw)
    tm = Transformer(cfg, device="cpu")
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), cfg, "cpu")
    return jm, params, tm, tparams


#: (config, capacity, prompt length, page): head dim 16 (JAX's
#: _decode_kernel / _paged_decode_kernel, int8 widened), and head dim 128
#: at capacity 256 and page 128 (JAX's aligned kernels)
GEN_CASES = {
    "f32": (dict(), 32, 16, 8),
    "int8": (INT8, 32, 16, 8),
    "int8_d128": (dict(head_dim=128, **INT8), 256, 96, 128),
    "f32_d128": (dict(head_dim=128), 256, 96, 128),
}


class TestGenerate:
    @pytest.mark.parametrize("paged", [False, True])
    @pytest.mark.parametrize("case", sorted(GEN_CASES))
    def test_token_streams_equal_jax(self, mesh1, case, paged):
        """Ragged prompts (one of length 1) prefill, then 6 greedy steps,
        contiguous or paged: the token streams equal JAX's. Prefill's
        logits agree to 1e-4 (f32 model; the int8 run's W8A8 rows
        quantize the same activations); the int8 cache codes after
        prefill are equal but for one-LSB flips of at most 0.1 % of the
        codes (a GEMM output rounding across a quantization tie)."""
        cfg_kw, cap, s, page = GEN_CASES[case]
        jm, params, tm, tparams = _models(mesh1, cfg_kw)
        rng = np.random.default_rng(9)
        toks = rng.integers(0, 128, (B, s)).astype(np.int32)
        lens = np.array([s, s // 2 + 3, 1], np.int32)
        jlast, jc, jl = jm.prefill(params, jm.init_cache(B, cap),
                                   jnp.asarray(toks), jnp.asarray(lens))
        tlast, tc, tl = tm.prefill(tparams, tm.init_cache(B, cap),
                                   _t(toks), _t(lens))
        np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        for (jk, jv), (tk, tv) in zip(jc, tc):
            for jleaf, tleaf in ((jk, tk), (jv, tv)):
                if isinstance(jleaf, dict):
                    diff = np.abs(tleaf["q"].numpy().astype(np.int32)
                                  - np.asarray(jleaf["q"], np.int32))
                    assert diff.max() <= 1 and diff.mean() <= 1e-3
                else:
                    np.testing.assert_allclose(tleaf.numpy(),
                                               np.asarray(jleaf),
                                               rtol=1e-4, atol=1e-4)
        first = jnp.argmax(jlast, -1).astype(jnp.int32)
        tfirst = _t(np.asarray(first))
        table = ttable = None
        if paged:
            jc, table = jm.paginate_caches(jc, page=page)
            tc, ttable = tm.paginate_caches(tc, page=page)
            np.testing.assert_array_equal(ttable.numpy(), np.asarray(table))
        jtoks, _, jl2 = jm.generate(params, jc, jl, first, 6,
                                    block_table=table)
        ttoks, _, tl2 = tm.generate(tparams, tc, tl, tfirst, 6,
                                    block_table=ttable)
        np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
        np.testing.assert_array_equal(tl2.numpy(), np.asarray(jl2))

    def test_generate_refuses_past_capacity(self):
        tm = Transformer(presets.tiny(), device="cpu")
        params = tm.init(torch.Generator().manual_seed(0))
        caches = tm.init_cache(2, 16)
        lens = torch.tensor([10, 12], dtype=torch.int32)
        with pytest.raises(ValueError, match="capacity 16 < 17"):
            tm.generate(params, caches, lens, lens, 5)

    def test_caches_round_trip_and_paged_layout(self, mesh1):
        """init_paged_cache and paginate_caches have the JAX layouts, and
        caches_from_numpy carries trees over bit for bit."""
        jm, _, tm, _ = _models(mesh1, INT8)
        jc, jt = jm.init_paged_cache(2, 32, page=8)
        tc, tt = tm.init_paged_cache(2, 32, page=8)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        for w, g in zip(jax.tree.leaves(jc), jax.tree.leaves(tc)):
            assert tuple(g.shape) == w.shape and g.numpy().dtype == w.dtype
        rng = np.random.default_rng(10)
        cont = [(dict(q=rng.integers(-127, 128, (2, 4, 32, 16)).astype(np.int8),
                      scale=rng.random((2, 4, 32)).astype(np.float32)),) * 2]
        jp, jtab = jm.paginate_caches(jax.tree.map(jnp.asarray, cont), page=8)
        tp, ttab = tm.paginate_caches(caches_from_numpy(cont, "cpu"), page=8)
        np.testing.assert_array_equal(ttab.numpy(), np.asarray(jtab))
        for w, g in zip(jax.tree.leaves(jp), jax.tree.leaves(tp)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    def test_moe_blocks_raise(self):
        """MoE blocks prefill and decode (tests/test_torch_moe_decode.py
        holds them against JAX); what still raises is the differentiable
        MoE-TP block, which comes with training."""
        cfg = presets.tiny(presets.deepseek_moe_16b(), kv_quant=None)
        tm = Transformer(cfg, device="cpu")
        params = tm.init(torch.Generator().manual_seed(0))
        toks = torch.zeros((1, 4), dtype=torch.int32)
        last, caches, lens = tm.prefill(params, tm.init_cache(1, 8), toks)
        logits, _, _ = tm.decode_step(params, caches, lens, toks[:, 0])
        assert torch.isfinite(last).all() and torch.isfinite(logits).all()
        tp = Transformer(presets.tiny(presets.mixtral_8x7b(moe="tp")),
                         device="cpu")
        blk = tp.init(torch.Generator().manual_seed(0))["blocks"][1]
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tp._mlp_block(blk, torch.zeros((4, 128)), inference=False)

    def test_generate_cli_on_cpu(self, capsys):
        res = tgen.main(["--device", "cpu", "--batch", "2", "--prompt-len",
                         "8", "--steps", "3"])
        assert np.asarray(res["tokens"]).shape == (2, 3)
        assert res["device"] == "cpu" and res["tok_s"] > 0
        assert "decode:" in capsys.readouterr().out
        with pytest.raises(SystemExit):
            tgen.main(["--device", "cpu", "--preset", "nope"])
