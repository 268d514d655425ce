"""Parity of the PyTorch port's tensor-parallel path with the JAX package.

The JAX side runs on a mesh of 4 of the 8 virtual CPU devices
(``tests/conftest.py``), its Pallas rings in interpret mode; the port's
side on ``Mesh.loopback(4, "cpu")``, where every kernel wrapper runs its
plain PyTorch version because the tensors lie on the CPU. The same
inputs, drawn with numpy from a seed, go through both: the all-gather,
AG-GEMM and GEMM-RS, the sequence-parallel flash decode and its
append, and ``prefill`` + ``generate`` of the tiny model in f32 and int8.
The CUDA kernels are held against the plain versions in
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from triton_distributed_tpu.kernels import flash_decode as jfd
from triton_distributed_tpu.kernels.ag_gemm import AGGemmMethod
from triton_distributed_tpu.kernels.ag_gemm import ag_gemm as j_ag_gemm
from triton_distributed_tpu.kernels.ag_gemm import resolve_ag_gemm_method
from triton_distributed_tpu.kernels.allgather import all_gather as j_all_gather
from triton_distributed_tpu.kernels.gemm_rs import GemmRSMethod
from triton_distributed_tpu.kernels.gemm_rs import gemm_rs as j_gemm_rs
from triton_distributed_tpu.kernels.gemm_rs import resolve_gemm_rs_method
from triton_distributed_tpu.layers import attention as jattn
from triton_distributed_tpu.models import Transformer as JTransformer
from triton_distributed_tpu.models import presets as jpresets
from triton_distributed_tpu.runtime import AllGatherMethod as JAGMethod
from triton_distributed_tpu_torch import layers, lang, ops
from triton_distributed_tpu_torch.kernels import ag_gemm as tag
from triton_distributed_tpu_torch.kernels import allgather as tallg
from triton_distributed_tpu_torch.kernels import gemm_rs as trs
from triton_distributed_tpu_torch.models import (
    Transformer,
    caches_from_numpy,
    params_from_numpy,
    presets,
)
from triton_distributed_tpu_torch.runtime import AllGatherMethod, Mesh
from triton_distributed_tpu_torch.tools import generate as tgen

W = 4
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
def jmesh():
    return JMesh(np.asarray(jax.devices()[:W]), ("tp",))


@pytest.fixture(scope="module")
def tmesh():
    return Mesh.loopback(W, "cpu")


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _shards(a, n=W, dim=0):
    return [_t(x) for x in np.split(np.asarray(a), n, axis=dim)]


# --------------------------------------------------------------- all-gather

class TestAllGather:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("method", ["RING_1D", "LL_SMALL"])
    def test_matches_jax_bytes(self, jmesh, tmesh, method, dtype):
        """Every rank's gathered tensor equals JAX's gathered array byte
        for byte."""
        x = np.random.default_rng(0).standard_normal((24, 40))
        jx = jnp.asarray(x, getattr(jnp, dtype))
        want = np.asarray(j_all_gather(jx, jmesh, "tp",
                                       method=JAGMethod[method]))
        got = tallg.all_gather(_shards(jx), tmesh, "tp",
                               method=AllGatherMethod[method])
        assert len(got) == W
        for g in got:
            assert g.dtype == getattr(torch, dtype) and g.shape == (24, 40)
            np.testing.assert_array_equal(_np(g), want.astype(np.float32))

    def test_auto_method_and_layer(self, tmesh):
        """``method=None`` runs the same gather as the two named methods
        (the JAX package picks between them by size; here they give the
        same bytes), and so do the layer's named entries."""
        x = [torch.full((2, 3), float(r)) for r in range(W)]
        layer = layers.AllGatherLayer(tmesh)
        for got in (tallg.all_gather(x, tmesh), layer(x),
                    layer.forward_ring(x), layer.forward_ll(x)):
            assert len(got) == W
            for g in got:
                assert torch.equal(g, torch.cat(x))

    @pytest.mark.parametrize("method", ["RING_BIDIR", "LL_PERSIST",
                                        "XLA_FALLBACK"])
    def test_unported_methods_raise(self, tmesh, method):
        """Only XLA_FALLBACK stays unported and raises; RING_BIDIR and
        LL_PERSIST, ported since (tests/test_torch_allgather_methods.py),
        give ``torch.cat``'s bytes. The quantized wire is ported
        (tests/test_torch_wire.py): a pinned fp8 wire on shards that
        cannot carry it (3 columns) raises ValueError."""
        x = [torch.full((2, 3), float(r)) for r in range(W)]
        if method == "XLA_FALLBACK":
            with pytest.raises(NotImplementedError, match="XLA"):
                tallg.all_gather(x, tmesh, method=AllGatherMethod[method])
        else:
            for g in tallg.all_gather(x, tmesh,
                                      method=AllGatherMethod[method]):
                assert torch.equal(g, torch.cat(x))
        with pytest.raises(ValueError, match="wire"):
            tallg.all_gather(x, tmesh, wire_dtype="fp8")


# --------------------------------------------------------- AG-GEMM, GEMM-RS

#: (global rows M, K, N): 64 rows is 16 a rank, which JAX's fused engine
#: blocks; 160 rows is 40 a rank, not a multiple of 64 (the CUDA tile)
GEMM_SHAPES = [(64, 48, 96), (160, 32, 64)]


class TestOverlapGemms:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("shape", GEMM_SHAPES)
    def test_ag_gemm_matches_jax(self, jmesh, tmesh, shape, dtype):
        """JAX on its own engine choice, which is PALLAS_FUSED
        (``_fused_kernel`` over ``ag_forward_ring``, interpreted) for
        both shapes: f32 within 1e-5 (the same products summed in
        another order); bf16 within one bf16 rounding of the output
        (2^-8 relative). Rank r's output is the gathered A times its
        column shard of B."""
        m, k, n = shape
        rng = np.random.default_rng(1)
        jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
        a = jnp.asarray(rng.standard_normal((m, k)), jdt)
        b = jnp.asarray(rng.standard_normal((k, n)) / np.sqrt(k), jdt)
        assert (resolve_ag_gemm_method(jmesh, "tp", a, b)
                == AGGemmMethod.PALLAS_FUSED)
        want = np.asarray(j_ag_gemm(a, b, jmesh, "tp"), np.float32)
        ctx = ops.create_ag_gemm_context(tmesh, "tp")
        got = ops.ag_gemm(_shards(a), _shards(b, dim=1), ctx)
        tol = 1e-5 if dtype == "float32" else 2.0 ** -8
        for r, g in enumerate(got):
            assert g.dtype == tdt and g.shape == (m, n // W)
            np.testing.assert_allclose(
                _np(g), want[:, r * n // W:(r + 1) * n // W], rtol=tol,
                atol=tol)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("shape", GEMM_SHAPES)
    def test_gemm_rs_matches_jax(self, jmesh, tmesh, shape, dtype):
        """JAX on its own engine choice, PALLAS_FUSED (``_fused_kernel``
        over ``reduce_ring``, interpreted), for both shapes. f32: within
        1e-5. bf16: the TPU ring stores each rank's partial product in
        bf16 and rounds the running sum at each hop, where the port sums
        in f32 and rounds once, so the two differ by at most 2^-8 of
        every partial product and running sum (plus the port's own
        rounding, 2^-8 of the last sum)."""
        m, k, n = shape
        rng = np.random.default_rng(2)
        jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
        a = jnp.asarray(rng.standard_normal((m, k)), jdt)
        b = jnp.asarray(rng.standard_normal((k, n)) / np.sqrt(k), jdt)
        assert (resolve_gemm_rs_method(jmesh, "tp", a, b)
                == GemmRSMethod.PALLAS_FUSED)
        want = np.asarray(j_gemm_rs(a, b, jmesh, "tp"), np.float32)
        ctx = ops.create_gemm_rs_context(tmesh, "tp")
        got = ops.gemm_rs(_shards(a, dim=1), _shards(b), ctx)
        if dtype == "float32":
            tol = np.full_like(want, 1e-5)
        else:
            af, bf = np.asarray(a, np.float32), np.asarray(b, np.float32)
            kw = k // W
            parts = np.stack([af[:, q * kw:(q + 1) * kw]
                              @ bf[q * kw:(q + 1) * kw] for q in range(W)])
            sums = np.cumsum(parts, axis=0)
            tol = 2.0 ** -8 * (np.abs(parts).sum(0) + np.abs(sums).sum(0)
                               + np.abs(sums[-1]))
        for r, g in enumerate(got):
            assert g.dtype == tdt and g.shape == (m // W, n)
            rows = slice(r * m // W, (r + 1) * m // W)
            assert (np.abs(_np(g) - want[rows]) <= tol[rows] + 1e-6).all()

    def test_plain_versions_and_refusals(self, tmesh):
        """Shard lists at W = 1 and W = 4 equal the one-rank products;
        tensors over a mesh of 4, or lists of the wrong length, are
        refused."""
        g = torch.Generator().manual_seed(3)
        a = torch.randn((8, 12), generator=g)
        b = torch.randn((12, 8), generator=g)
        one = Mesh.loopback(1, "cpu")
        torch.testing.assert_close(tag.ag_gemm([a], [b], one)[0], a @ b)
        torch.testing.assert_close(trs.gemm_rs([a], [b], one)[0], a @ b)
        rs = trs.gemm_rs(list(a.chunk(W, 1)), list(b.chunk(W, 0)), tmesh)
        torch.testing.assert_close(torch.cat(rs), a @ b)
        with pytest.raises(ValueError, match="per-rank shards"):
            tag.ag_gemm(a, b, tmesh)
        with pytest.raises(ValueError, match="lists of 4"):
            trs.gemm_rs([a], [b], tmesh)


# ------------------------------------------------------ sequence-parallel

B, HKV, G, D, S = 3, 2, 2, 128, 512
#: an empty row, a full row, a row that ends inside rank 1's slice
LENS = np.array([0, S, 200], np.int32)


def _seq_caches(tmesh, jk, jv):
    """The port's sequence-sharded caches from JAX's global ones: each
    leaf W views of one allocation."""
    return caches_from_numpy([jax.tree.map(np.asarray, (jk, jv))],
                             mesh=tmesh)[0]


def _own(leaf):
    """The shards of a cache leaf (or int8 dict) as W tensors of their
    own, no longer views of one allocation."""
    if isinstance(leaf, dict):
        return {k: _own(v) for k, v in leaf.items()}
    return [t.clone() for t in leaf]


class TestSpDecode:
    @pytest.mark.parametrize("kind", ["bf16", "int8"])
    def test_partials_match_jax(self, jmesh, tmesh, kind):
        """``SpGQAFlashDecodeAttention`` at W = 4 over caches sequence-
        sharded like JAX's (128 positions a rank): JAX's local Pallas
        kernels (``_decode_kernel_dyn``, ``_decode_kernel_dyn_mh``),
        all_gather and combine against the port's, one batched local
        decode over the ranks' views. bf16:
        one bf16 rounding of p and of out on both sides (1e-2); int8:
        both round p to bf16, against different running maxima (JAX's
        128-position blocks, the port's 64-position tiles): 2e-3."""
        rng = np.random.default_rng(4)
        q = rng.standard_normal((B, HKV * G, D)).astype(np.float32)
        k = rng.standard_normal((B, HKV, S, D)).astype(np.float32)
        v = rng.standard_normal((B, HKV, S, D)).astype(np.float32)
        if kind == "int8":
            jk = dict(zip(("q", "scale"), jfd.quantize_kv(jnp.asarray(k))))
            jv = dict(zip(("q", "scale"), jfd.quantize_kv(jnp.asarray(v))))
            jq, tq, tol = jnp.asarray(q), _t(q), 2e-3
        else:
            jk = jnp.asarray(k, jnp.bfloat16)
            jv = jnp.asarray(v, jnp.bfloat16)
            jq = jnp.asarray(q, jnp.bfloat16)
            tq, tol = _t(jq), 1e-2
        jl = jattn.SpGQAFlashDecodeAttention(jmesh, "tp", q_heads=HKV * G,
                                             kv_heads=HKV, head_dim=D)
        want = jl.partials(jq, jk, jv, jnp.asarray(LENS))
        tl = layers.SpGQAFlashDecodeAttention(tmesh, "tp", q_heads=HKV * G,
                                              kv_heads=HKV, head_dim=D)
        tk, tv = _seq_caches(tmesh, jk, jv)
        out, lse = tl.partials(tq, tk, tv, _t(LENS))
        assert out.dtype == tq.dtype and out.shape == (B, HKV * G, D)
        np.testing.assert_allclose(_np(out), np.asarray(want[0], np.float32),
                                   rtol=tol, atol=tol)
        np.testing.assert_allclose(lse.numpy(), np.asarray(want[1]),
                                   rtol=tol, atol=tol)
        assert np.all(_np(out)[0] == 0.0)
        assert np.all(lse.numpy()[0] == jfd.NEG_INF)

    @pytest.mark.parametrize("kind", ["bhsd", "int8"])
    def test_append_matches_jax(self, tmesh, kind):
        """JAX's append into the global cache against the port's into the
        sequence-sharded one: a row writing on rank 0, one on the last
        position of rank 1's slice, one at capacity (nothing written).
        Every shard equals the matching slice of JAX's cache, bit for
        bit."""
        s = 16
        rng = np.random.default_rng(5)
        lens = np.array([2, 7, s], np.int32)      # slices of 4 positions
        kc = rng.standard_normal((3, 2, s, 8)).astype(np.float32)
        vc = rng.standard_normal((3, 2, s, 8)).astype(np.float32)
        kn = rng.standard_normal((3, 2, 8)).astype(np.float32)
        vn = rng.standard_normal((3, 2, 8)).astype(np.float32)
        if kind == "int8":
            jk = dict(zip(("q", "scale"), jfd.quantize_kv(jnp.asarray(kc))))
            jv = dict(zip(("q", "scale"), jfd.quantize_kv(jnp.asarray(vc))))
        else:
            jk, jv = jnp.asarray(kc), jnp.asarray(vc)
        want = jattn.append_kv(jk, jv, jnp.asarray(lens), jnp.asarray(kn),
                               jnp.asarray(vn))
        tk, tv = _seq_caches(tmesh, jk, jv)
        got = layers.append_kv(tk, tv, _t(lens), _t(kn), _t(vn))
        np.testing.assert_array_equal(got[2].numpy(), lens + 1)
        for w, g in zip(jax.tree.leaves(want[:2]),
                        jax.tree.leaves(got[:2], is_leaf=lambda x:
                                        isinstance(x, list))):
            np.testing.assert_array_equal(
                np.concatenate([t.numpy() for t in g], axis=2),
                np.asarray(w))

    @pytest.mark.parametrize("kind", ["bf16", "int8"])
    @pytest.mark.parametrize("entry", ["decode", "append"])
    def test_shards_of_their_own_raise(self, tmesh, entry, kind):
        """The decode and the append take each cache leaf as one batch of
        W·B rows: shards that are not views of one allocation (a mesh
        over several GPUs would hold such) raise, naming the ROADMAP
        item, and the append writes nothing before it does."""
        rng = np.random.default_rng(6)
        k = rng.standard_normal((2, 2, 16, 8)).astype(np.float32)
        if kind == "int8":
            kc = dict(zip(("q", "scale"), jfd.quantize_kv(jnp.asarray(k))))
        else:
            kc = jnp.asarray(k, jnp.bfloat16)
        tk, tv = _seq_caches(tmesh, kc, kc)
        tv = _own(tv)
        lens = _t(np.array([3, 9], np.int32))
        before = jax.tree.map(lambda t: t.clone(), tk)
        with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
            if entry == "decode":
                tl = layers.SpGQAFlashDecodeAttention(
                    tmesh, "tp", q_heads=4, kv_heads=2, head_dim=8)
                tl.partials(_t(rng.standard_normal((2, 4, 8))), tk, tv,
                            lens)
            else:
                kn = _t(rng.standard_normal((2, 2, 8)).astype(np.float32))
                layers.append_kv(tk, tv, lens, kn, kn)
        for a, b in zip(jax.tree.leaves(before), jax.tree.leaves(tk)):
            assert torch.equal(a, b)


# ------------------------------------------------------- prefill → generate

#: (config overrides, batch, prompt, capacity, steps)
TP_CASES = {"f32": dict(), "int8": INT8}
TB, TS, TCAP, TSTEPS = 4, 16, 32, 6


@pytest.fixture(scope="module", params=sorted(TP_CASES))
def tp_run(request, jmesh, tmesh):
    """The tiny model through prefill + generate: JAX at tp = 4, the port
    at tp = 4 (from ``params_from_numpy(mesh=)``) and at tp = 1, on the
    same parameters and ragged prompts (one of length 1)."""
    kw = TP_CASES[request.param]
    jm = JTransformer(jpresets.tiny(**kw), jmesh, "tp", ())
    params = jm.quantize_dense_weights(jm.init(jax.random.PRNGKey(0)))
    cfg = presets.tiny(**kw)
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(9)
    toks = rng.integers(0, 128, (TB, TS)).astype(np.int32)
    lens = np.array([TS, TS // 2 + 3, 5, 1], np.int32)
    run = dict(name=request.param, tree=tree, cfg=cfg)
    jlast, jc, jl = jm.prefill(params, jm.init_cache(TB, TCAP),
                               jnp.asarray(toks), jnp.asarray(lens))
    first = jnp.argmax(jlast, -1).astype(jnp.int32)
    run["jax"] = dict(last=np.asarray(jlast),
                      caches=jax.tree.map(np.asarray, jc),
                      toks=np.asarray(jm.generate(params, jc, jl, first,
                                                  TSTEPS)[0]))
    for tp in (W, 1):
        tm = (Transformer(cfg, mesh=tmesh) if tp > 1
              else Transformer(cfg, device="cpu"))
        tparams = params_from_numpy(tree, cfg, "cpu",
                                    mesh=tmesh if tp > 1 else None)
        last, tc, tl = tm.prefill(tparams, tm.init_cache(TB, TCAP),
                                  _t(toks), _t(lens))
        np.testing.assert_array_equal(tl.numpy(), lens)
        # the caches after prefill (generate writes them in place)
        snap = jax.tree.map(lambda t: t.numpy().copy(), tc)
        ttoks, _, tl2 = tm.generate(tparams, tc, tl, _t(np.asarray(first)),
                                    TSTEPS)
        np.testing.assert_array_equal(tl2.numpy(), lens + TSTEPS)
        run[tp] = dict(last=last.numpy(), caches=snap, toks=ttoks.numpy())
    return run


class TestTpGenerate:
    def test_prefill_logits_match_jax(self, tp_run):
        """The first step's logits at tp = 4 within 1e-4 of JAX's (the
        int8 model's prefill widens its weights, so both are f32 GEMMs
        summed in another order)."""
        np.testing.assert_allclose(tp_run[W]["last"], tp_run["jax"]["last"],
                                   rtol=1e-4, atol=1e-4)

    def test_cache_shards_match_jax(self, tp_run):
        """Each rank's cache shard after prefill is its slice of JAX's
        sequence-sharded cache: f32 within 1e-5; int8 codes equal, and
        the scales (each row's max-abs / 127, of K/V rows summed in
        another order) within 1e-6 relative."""
        for (jk, jv), (tk, tv) in zip(tp_run["jax"]["caches"],
                                      tp_run[W]["caches"]):
            for jleaf, tleaf in ((jk, tk), (jv, tv)):
                if isinstance(jleaf, dict):
                    assert len(tleaf["q"]) == W
                    np.testing.assert_array_equal(
                        np.concatenate(tleaf["q"], axis=2), jleaf["q"])
                    np.testing.assert_allclose(
                        np.concatenate(tleaf["scale"], axis=2),
                        jleaf["scale"], rtol=1e-6, atol=0)
                else:
                    assert len(tleaf) == W
                    assert tuple(tleaf[0].shape) == (TB, 4, TCAP // W, 16)
                    got = np.concatenate(tleaf, axis=2)
                    np.testing.assert_allclose(got, jleaf, rtol=1e-5,
                                               atol=1e-5)

    def test_token_streams_equal_jax(self, tp_run):
        np.testing.assert_array_equal(tp_run[W]["toks"], tp_run["jax"]["toks"])

    def test_tp4_equals_tp1(self, tp_run):
        """The port at tp = 4 against itself at tp = 1: the same tokens,
        first-step logits within 1e-5 (row-parallel sums in another
        order)."""
        np.testing.assert_array_equal(tp_run[W]["toks"], tp_run[1]["toks"])
        np.testing.assert_allclose(tp_run[W]["last"], tp_run[1]["last"],
                                   rtol=1e-5, atol=1e-5)

    def test_params_round_trip(self, tp_run, tmesh):
        """``params_from_numpy(mesh=)`` gives rank r the q columns of its
        heads and the k and v columns of its KV heads in ``wqkv``, the
        matching rows of ``wo``, and its blocks of ``up`` / ``down``
        (their int8 scales alike); put back in place, the shards give
        JAX's global arrays bit for bit."""
        cfg, tree = tp_run["cfg"], tp_run["tree"]
        sharded = params_from_numpy(tree, cfg, mesh=tmesh)
        d, hq, hkv = cfg.head_dim, cfg.n_heads // W, cfg.n_kv_heads // W

        def block(size, r):
            return np.arange(r * size // W, (r + 1) * size // W)

        index = {
            "wqkv": (1, lambda r: np.concatenate([
                block(cfg.q_dim, r), cfg.q_dim + block(cfg.kv_dim, r),
                cfg.q_dim + cfg.kv_dim + block(cfg.kv_dim, r)])),
            "wo": (0, lambda r: block(cfg.q_dim, r)),
            "up": (1, lambda r: block(cfg.ffn, r)),
            "down": (0, lambda r: block(cfg.ffn, r)),
        }
        for wb, tb in zip(tree["blocks"], sharded["blocks"]):
            for name, (dim, idx) in index.items():
                glob, leaf = wb[name], tb[name]
                if isinstance(glob, dict):
                    glob, scale, leaf, tscale = (glob["q"], glob["scale"],
                                                 leaf["q"], leaf["scale"])
                    for r, sc in enumerate(tscale):
                        want = scale[idx(r)] if dim == 1 else scale
                        np.testing.assert_array_equal(sc.numpy(), want)
                back = np.zeros_like(glob)
                for r, sh in enumerate(leaf):
                    np.testing.assert_array_equal(
                        sh.numpy(), np.take(glob, idx(r), axis=dim))
                    if dim == 1:
                        back[:, idx(r)] = sh.numpy()
                    else:
                        back[idx(r)] = sh.numpy()
                np.testing.assert_array_equal(back, glob)


class TestMesh:
    def test_mesh_over_distinct_devices_raises(self):
        with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
            Mesh(("cuda:0", "cuda:1"), ("tp",), (2,))
        m = Mesh.loopback(W, "cpu")
        assert m.shape == {"tp": W} and m.size == W
        assert lang.n_pes(m, "tp") == W and lang.my_pe(m, "tp", 2) == 2

    def test_symmetric_tensor_and_peer_table(self, tmesh):
        st = lang.symm_empty(tmesh, (3, 5), torch.float32)
        assert len(st.shards) == W and st.peers.dtype == torch.int64
        ptrs = [s.data_ptr() for s in st.shards]
        assert st.peers.tolist() == ptrs
        assert lang.stacked(st.shards).shape == (W, 3, 5)
        own = [torch.zeros((3, 5)) for _ in range(W)]
        assert lang.stacked(own) is None
        assert lang.peer_table(own).tolist() == [t.data_ptr() for t in own]

    def test_model_refusals(self, tmesh):
        """The tiny DeepSeek-MoE preset builds on the mesh in both
        flavours (MoE over a mesh is ported; tests/test_torch_moe_mesh.py
        holds it against JAX); what waits for later slices raises: KV
        heads that do not split, paged caches and the serving step at
        tp > 1, prompts whose B·S rows do not shard."""
        for kw in ({}, dict(moe="tp", moe_weight_quant=None,
                            moe_act_quant=None)):
            tm = Transformer(presets.tiny(presets.deepseek_moe_16b(**kw)),
                             mesh=tmesh)
            assert tm.tp == W and tm.config.moe_layers
        with pytest.raises(ValueError, match="n_kv_heads"):
            Transformer(presets.tiny(n_kv_heads=2), mesh=tmesh)
        tm = Transformer(presets.tiny(), mesh=tmesh)
        with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
            tm.init_paged_cache(2, 32, page=8)
        with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
            tm.init_serving_state(2, 8, 8)
        params = tm.shard_params(tm.init(torch.Generator().manual_seed(0)))
        with pytest.raises(ValueError, match="do not shard"):
            tm.prefill(params, tm.init_cache(1, 8),
                       torch.zeros((1, 3), dtype=torch.int32))
        with pytest.raises(TypeError, match="Mesh"):
            Transformer(presets.tiny(), "cpu")

    def test_generate_cli_tp_on_cpu(self, capsys):
        res = tgen.main(["--device", "cpu", "--tp", "4", "--batch", "2",
                         "--prompt-len", "8", "--steps", "3"])
        assert np.asarray(res["tokens"]).shape == (2, 3) and res["tp"] == 4
        assert "loopback, 4 ranks" in capsys.readouterr().out
