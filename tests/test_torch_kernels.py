"""Parity of the PyTorch port's kernel modules with the JAX package.

The same inputs, drawn with numpy from a seed, go through the JAX
function (its Pallas kernel in interpret mode, or its XLA twin) and the
port's counterpart, whose CPU path is the plain PyTorch version. The
hand-written CUDA kernels are held against those plain versions in
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_distributed_tpu.kernels import group_gemm as jgg
from triton_distributed_tpu.kernels import ragged_paged_attention as jrpa
from triton_distributed_tpu.kernels.flash_decode import quantize_kv as j_quantize_kv
from triton_distributed_tpu_torch.kernels import group_gemm as tgg
from triton_distributed_tpu_torch.kernels import ragged_paged_attention as trpa
from triton_distributed_tpu_torch.kernels.flash_decode import quantize_kv
from triton_distributed_tpu_torch.layers import RaggedPagedAttention


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the inputs are tiny, and the suite runs in
    several worker processes that share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ---------------------------------------------------------------- quantizers

class TestQuantizers:
    def test_round_is_half_to_even_in_both(self):
        v = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5], np.float32)
        want = np.array([-2, -2, 0, 0, 2, 2, 4], np.float32)
        np.testing.assert_array_equal(np.asarray(jnp.round(v)), want)
        np.testing.assert_array_equal(torch.round(_t(v)).numpy(), want)

    def test_quantize_act_rows_bit_exact(self):
        rng = np.random.default_rng(0)
        x = rng.standard_normal((24, 96)).astype(np.float32)
        x[3] = 0.0                                   # zero row: scale 1
        # a row whose scale is exactly 1 and whose values sit on .5 ties
        x[5, :] = np.arange(96, dtype=np.float32) % 7 + 0.5
        x[5, 0] = 127.0
        jq, js = jgg.quantize_act_rows(jnp.asarray(x))
        tq, ts = tgg.quantize_act_rows(_t(x))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        assert tq.dtype == torch.int8 and ts.shape == (24, 1)
        assert set(np.unique(tq.numpy()[5, 1:8])) == {0, 2, 4, 6}

    def test_quantize_grouped_weights_bit_exact(self):
        rng = np.random.default_rng(1)
        w = rng.standard_normal((3, 64, 40)).astype(np.float32)
        w[1, :, 7] = 0.0                             # all-zero channel
        jq, js = jgg.quantize_grouped_weights(jnp.asarray(w), "int8")
        tq, ts = tgg.quantize_grouped_weights(_t(w), "int8")
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(
            tgg.dequantize_grouped_weights(tq, ts, torch.float32).numpy(),
            np.asarray(jgg.dequantize_grouped_weights(jq, js, jnp.float32)))
        # the K-major store W8A8 reads: the same codes and scales
        kq, ks = tgg.quantize_grouped_weights(_t(w), "int8", k_major=True)
        assert kq.stride() == (64 * 40, 1, 64)
        np.testing.assert_array_equal(kq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ks.numpy(), np.asarray(js))
        with pytest.raises(ValueError):
            tgg.quantize_grouped_weights(_t(w), "fp8")

    def test_quantize_kv_bit_exact(self):
        rng = np.random.default_rng(2)
        x = rng.standard_normal((5, 2, 8, 32)).astype(np.float32)
        x[0, 0, 0] = 0.0
        jq, js = j_quantize_kv(jnp.asarray(x))
        tq, ts = quantize_kv(_t(x))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# --------------------------------------------------------------------- GEMMs

def _gemm_inputs(seed, e, cap, k, n, block_m):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((cap, k)).astype(np.float32)
    w = (rng.standard_normal((e, k, n)) / np.sqrt(k)).astype(np.float32)
    be = rng.integers(0, e, (cap // block_m,)).astype(np.int32)
    be[0] = e - 1
    return x, w, be


class TestGroupedMatmul:
    @pytest.mark.parametrize("e", [1, 3])
    def test_w8a8_plain_matches_pallas_kernel(self, e):
        """s32 sums are exact on both sides and the f32 epilogue runs
        in the same order, so the f32 outputs are bit-identical: on the
        (E, K, N) codes as JAX holds them, and on their K-major view (the
        layout W8A8's CUDA kernels read)."""
        x, w, be = _gemm_inputs(10 + e, e, 24, 64, 48, 8)
        jxq, jxs = jgg.quantize_act_rows(jnp.asarray(x))
        jwq, jws = jgg.quantize_grouped_weights(jnp.asarray(w))
        want = jgg.grouped_matmul(
            jxq, jwq, jnp.asarray(be), w_scale=jws, x_scale=jxs,
            block_m=8, out_dtype=jnp.float32)
        for wq in (_t(jwq), tgg.to_k_major(_t(jwq))):
            got = tgg.grouped_matmul(
                _t(jxq), wq, _t(be), w_scale=_t(jws), x_scale=_t(jxs),
                out_dtype=torch.float32)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("e", [1, 3])
    def test_w8a16_plain_matches_pallas_kernel(self, e):
        """f32 x, f32 accumulation in another order: 1e-5."""
        x, w, be = _gemm_inputs(20 + e, e, 24, 64, 48, 8)
        jwq, jws = jgg.quantize_grouped_weights(jnp.asarray(w))
        want = jgg.grouped_matmul(
            jnp.asarray(x), jwq, jnp.asarray(be), w_scale=jws, block_m=8,
            out_dtype=jnp.float32)
        got = tgg.grouped_matmul(_t(x), _t(jwq), _t(be), w_scale=_t(jws),
                                 out_dtype=torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)

    def test_w8a8_defaults_to_bf16_and_checks_shapes(self):
        x, w, be = _gemm_inputs(3, 1, 16, 32, 24, 16)
        xq, xs = tgg.quantize_act_rows(_t(x))
        wq, ws = tgg.quantize_grouped_weights(_t(w))
        out = tgg.grouped_matmul(xq, wq, _t(be), w_scale=ws, x_scale=xs)
        assert out.dtype == torch.bfloat16 and out.shape == (16, 24)
        with pytest.raises(ValueError):
            tgg.grouped_matmul(xq, wq, torch.zeros(3, dtype=torch.int32),
                               w_scale=ws, x_scale=xs)
        with pytest.raises(ValueError):
            tgg.grouped_matmul(xq.float(), wq, _t(be), w_scale=ws,
                               x_scale=xs)


# ----------------------------------------------------------------- attention

HKV, G, D, PAGE, PPS, NPAGES = 2, 2, 32, 8, 4, 32

#: (kv_len, q_len, kind, aux): a decode row, a mid-prompt chunk, a fresh
#: prefill, a q_len == 0 row, a SHARED_PREFIX row, a TREE row (4 nodes)
#: and a CP row whose frontier sits 3 tokens to the right
ROWS = [(13, 1, "causal", None), (21, 5, "causal", None),
        (8, 8, "causal", None), (17, 0, "causal", None),
        (20, 3, "shared", 8), (12, 4, "tree", [-1, 0, 0]),
        (10, 2, "cp", 3)]


def _attention_inputs(seed, quant, q_dtype=np.float32):
    rng = np.random.default_rng(seed)
    r = len(ROWS)
    kv_lens = np.array([a for a, *_ in ROWS], np.int32)
    q_lens = np.array([b for _, b, *_ in ROWS], np.int32)
    q_starts = np.zeros((r,), np.int32)
    nxt = 0
    for i, (_, ql, *_) in enumerate(ROWS):
        q_starts[i] = nxt
        nxt += -(-ql // 8) * 8
    block_q = jrpa.auto_block_q(int(q_lens.max()), G)
    t = nxt + block_q
    q_starts[q_lens == 0] = nxt
    table = rng.permutation(NPAGES)[: r * PPS].reshape(r, PPS).astype(np.int32)
    table[2, 1:] = -1                                # unallocated entries
    w = jrpa.topo_width(block_q)
    topo = jrpa.causal_topologies(r, w)
    for i, (_, _, kind, aux) in enumerate(ROWS):
        if kind == "shared":
            topo[i] = jrpa.shared_prefix_topology_row(aux, w)
        elif kind == "tree":
            topo[i] = jrpa.tree_topology_row(aux, w)
        elif kind == "cp":
            topo[i] = jrpa.cp_topology_row(aux, w)
    q = rng.standard_normal((HKV, t * G, D)).astype(q_dtype)
    kc = rng.standard_normal((NPAGES, HKV, PAGE, D)).astype(np.float32)
    vc = rng.standard_normal((NPAGES, HKV, PAGE, D)).astype(np.float32)
    if quant:
        kq, ks = j_quantize_kv(jnp.asarray(kc))
        vq, vs = j_quantize_kv(jnp.asarray(vc))
        pools = (np.asarray(kq), np.asarray(vq))
        scales = dict(k_scale=np.asarray(ks), v_scale=np.asarray(vs))
    else:
        pools, scales = (kc, vc), {}
    meta = (kv_lens, q_lens, q_starts, table)
    return q, pools, scales, meta, topo, block_q


def _spans(meta):
    _, q_lens, q_starts, _ = meta
    for ql, qs in zip(q_lens, q_starts):
        if ql > 0:
            yield slice(int(qs) * G, (int(qs) + int(ql)) * G)


def _port_attention(q, pools, scales, meta, topo, block_q):
    return trpa.ragged_paged_attention(
        _t(q), *map(_t, pools), *map(_t, meta), group=G,
        topologies=_t(topo), block_q=block_q,
        **{k: _t(v) for k, v in scales.items()})


class TestRaggedPagedAttention:
    @pytest.mark.parametrize("quant", [False, True])
    @pytest.mark.parametrize("reference", ["pallas_kernel", "xla_twin"])
    def test_plain_matches_jax(self, quant, reference):
        """All four row kinds and a q_len == 0 row, valid spans only.
        Tolerances: 1e-5 wherever both sides compute in f32; 2e-2 for
        the int8 Pallas kernel, which widens K/V to bf16 and rounds
        p·v_scale to bf16 before its PV product (the port's plain
        version, like the JAX twin, dequantizes the pools to q's f32)."""
        q, pools, scales, meta, topo, block_q = _attention_inputs(0, quant)
        jargs = (jnp.asarray(q), *map(jnp.asarray, pools),
                 *map(jnp.asarray, meta))
        jkw = dict(group=G, topologies=jnp.asarray(topo),
                   **{k: jnp.asarray(v) for k, v in scales.items()})
        if reference == "pallas_kernel":
            want, wlse = jrpa.ragged_paged_attention(
                *jargs, block_q=block_q, **jkw)
        else:
            want, wlse = jrpa.ragged_paged_attention_xla(*jargs, **jkw)
        got, lse = _port_attention(q, pools, scales, meta, topo, block_q)
        tol = 2e-2 if (quant and reference == "pallas_kernel") else 1e-5
        for sp in _spans(meta):
            np.testing.assert_allclose(got.numpy()[:, sp],
                                       np.asarray(want)[:, sp],
                                       rtol=tol, atol=tol)
            np.testing.assert_allclose(lse.numpy()[:, sp],
                                       np.asarray(wlse)[:, sp],
                                       rtol=tol, atol=tol)

    def test_rows_outside_spans_are_zero(self):
        """The port leaves every row outside a valid span at out = 0,
        lse = NEG_INF (the CUDA kernel does the same, so the two agree
        everywhere, not only on the spans)."""
        q, pools, scales, meta, topo, block_q = _attention_inputs(1, False)
        got, lse = _port_attention(q, pools, scales, meta, topo, block_q)
        inside = np.zeros(q.shape[1], bool)
        for sp in _spans(meta):
            inside[sp] = True
        assert np.all(got.numpy()[:, ~inside] == 0.0)
        assert np.all(lse.numpy()[:, ~inside] == trpa.NEG_INF)
        assert np.all(np.isfinite(got.numpy()))

    def test_helpers_match_jax(self):
        rng = np.random.default_rng(3)
        q = rng.standard_normal((12, HKV * G, D)).astype(np.float32)
        packed = trpa.pack_gqa_rows(_t(q), HKV)
        np.testing.assert_array_equal(
            packed.numpy(), np.asarray(jrpa.pack_gqa_rows(jnp.asarray(q), HKV)))
        np.testing.assert_array_equal(
            trpa.unpack_gqa_rows(packed, HKV * G).numpy(), q)
        for mq in (1, 7, 8, 9, 100, 256):
            for g in (1, 2, 3, 8):
                assert trpa.auto_block_q(mq, g) == jrpa.auto_block_q(mq, g)
        w = trpa.topo_width(16)
        assert w == jrpa.topo_width(16)
        np.testing.assert_array_equal(
            trpa.tree_topology_row([-1, 0, 1, 1], w),
            jrpa.tree_topology_row([-1, 0, 1, 1], w))
        np.testing.assert_array_equal(
            trpa.shared_prefix_topology_row(24, w),
            jrpa.shared_prefix_topology_row(24, w))
        np.testing.assert_array_equal(trpa.cp_topology_row(5, w),
                                      jrpa.cp_topology_row(5, w))
        with pytest.raises(ValueError):
            trpa.tree_topology_row([-1, 5], w)

    @pytest.mark.parametrize("quant", [False, True])
    def test_layer_matches_jax_twin(self, quant):
        """The port's layer (int8 dict pools or tensor pools, no mesh)
        against the XLA twin the JAX layer runs with use_pallas=False:
        1e-5."""
        q, pools, scales, meta, topo, block_q = _attention_inputs(4, quant)
        want, wlse = jrpa.ragged_paged_attention_xla(
            jnp.asarray(q), *map(jnp.asarray, pools),
            *map(jnp.asarray, meta), group=G, topologies=jnp.asarray(topo),
            **{k: jnp.asarray(v) for k, v in scales.items()})
        if quant:
            kp = {"q": _t(pools[0]), "scale": _t(scales["k_scale"])}
            vp = {"q": _t(pools[1]), "scale": _t(scales["v_scale"])}
        else:
            kp, vp = map(_t, pools)
        layer = RaggedPagedAttention(group=G)
        args = (_t(q), kp, vp, *map(_t, meta))
        got, lse = layer(*args, topologies=_t(topo), block_q=block_q,
                         with_lse=True)
        assert torch.equal(
            layer(*args, topologies=_t(topo), block_q=block_q), got)
        for sp in _spans(meta):
            np.testing.assert_allclose(got.numpy()[:, sp],
                                       np.asarray(want)[:, sp],
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(lse.numpy()[:, sp],
                                       np.asarray(wlse)[:, sp],
                                       rtol=1e-5, atol=1e-5)
