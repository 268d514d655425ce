"""Parity of the PyTorch port's quantized wires with the JAX package.

The JAX side runs on a mesh of 4 of the 8 virtual CPU devices
(``tests/conftest.py``); the port's on ``Mesh.loopback(4, "cpu")``,
where every kernel wrapper runs its plain PyTorch version because the
tensors lie on the CPU. The same inputs, drawn with numpy from a seed,
go through both, in f32:

* the host half of ``lang/wire``: spellings, chunking, eligibility,
  codes and scales (byte for byte against JAX's eager helpers), the
  per-column weight quantizer;
* AG-GEMM on fp8, int8 and int8-mxu wires and GEMM-RS on fp8 and int8,
  against JAX's XLA ring twins (``method=XLA_RING``, which ship the
  same ``lang.wire`` bytes as the fused kernels), and one case per
  kernel and wire against the interpreted fused Pallas kernels
  (``PALLAS_FUSED``);
* the all-gather on a wire, and 'auto' on both sides of 256 KiB;
* ``ParallelMLP`` on a wire context;
* the refusals.

Tolerances, relative to the largest reference value: 1e-5 where both
sides compute on the same codes (JAX's jitted quantizer can round a
scale in the last bit, which moves a dequantized value by an ulp; the
products are summed in another order); JAX's pinned tolerances of
``tests/test_wire.py`` against the exact product. The CUDA kernels are
held against these plain versions in tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from triton_distributed_tpu.kernels.ag_gemm import AGGemmMethod
from triton_distributed_tpu.kernels.ag_gemm import ag_gemm as j_ag_gemm
from triton_distributed_tpu.kernels.allgather import all_gather as j_all_gather
from triton_distributed_tpu.kernels.gemm_rs import GemmRSMethod
from triton_distributed_tpu.kernels.gemm_rs import gemm_rs as j_gemm_rs
from triton_distributed_tpu.lang import wire as jw
from triton_distributed_tpu.layers import linear as jlin
from triton_distributed_tpu.ops import overlap as jov
from triton_distributed_tpu.runtime import AllGatherMethod as JAGMethod
from triton_distributed_tpu.runtime.topology import LinkKind, TopologyInfo
from triton_distributed_tpu.runtime.topology import (
    auto_allgather_method as j_auto_allgather_method,
)
from triton_distributed_tpu.runtime.topology import (
    auto_allgather_wire as j_auto_allgather_wire,
)
from triton_distributed_tpu_torch import layers, ops
from triton_distributed_tpu_torch.kernels import ag_gemm as tag
from triton_distributed_tpu_torch.kernels import allgather as tallg
from triton_distributed_tpu_torch.kernels import gemm_rs as trs
from triton_distributed_tpu_torch.lang import wire as tw
from triton_distributed_tpu_torch.runtime import AllGatherMethod, Mesh
from triton_distributed_tpu_torch.runtime.topology import (
    auto_allgather_method,
    auto_allgather_wire,
)

W = 4
#: the same products on the same codes, summed in another order
SAME_CODES = 1e-5


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


def _shards(a, dim=0):
    return [torch.from_numpy(np.array(x)) for x in
            np.split(np.asarray(a, np.float32), W, axis=dim)]


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / (np.abs(want).max() or 1.0))


def _operands(seed, rows, k, n, outlier=True):
    """A (rows, k) with one outlier row (x1000) in the first shard, the
    per-chunk scale's worst case (tests/test_wire.py:277-299), and B
    (k, n) scaled to unit outputs."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((rows, k)).astype(np.float32)
    if outlier:
        a[3] *= 1000.0
    b = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    return a, b


def _bytes(t):
    return t.view(torch.uint8).numpy() if t.dtype == torch.float8_e4m3fn \
        else t.numpy().view(np.uint8)


# ---------------------------------------------------------- lang/wire host

class TestWireFormat:
    def test_spellings(self):
        for w in (None, "bf16", "fp8", "int8", "int8-mxu", "auto"):
            assert tw.normalize_wire(w) == jw.normalize_wire(w)
            n = tw.normalize_wire(w)
            assert tw.wire_payload(n) == jw.wire_payload(n)
        assert tw.WIRE_DTYPES == jw.WIRE_DTYPES
        for mod in (tw, jw):
            with pytest.raises(ValueError, match="wire_dtype"):
                mod.normalize_wire("fp4")

    @pytest.mark.parametrize("strict", [False, True])
    def test_chunk_rows_sweep(self, strict):
        """Rows 1-300 and the prefill's 2048 / 8192: the same chunking
        as JAX (``None`` where a strict slab has none)."""
        for rows in [*range(1, 301), 2048, 8192]:
            assert tw.pick_chunk_rows(rows, strict) == \
                jw.pick_chunk_rows(rows, strict)
            for q in ("fp8", "int8", "int8-mxu"):
                t = tw.make_wire_format(q, rows, strict=strict)
                j = jw.make_wire_format(q, rows, strict=strict)
                assert (t is None) == (j is None)
                if t is not None:
                    assert (t.quant, t.chunk_rows) == (j.quant, j.chunk_rows)
                    assert t.slab_bytes(rows, 640) == j.slab_bytes(rows, 640)
                    assert t.qmax == j.qmax
        assert [tw.make_wire_format("fp8", r).chunk_rows
                for r in (2048, 96, 8)] == [64, 32, 8]

    def test_wire_blockable_sweep(self):
        for rows in (1, 8, 16, 40, 64, 96, 100, 128, 2048):
            for cols in (16, 32, 64, 100, 128, 200, 640, 4096):
                for q in ("fp8", "int8", "int8-mxu"):
                    assert tw.wire_blockable(rows, cols, q) == \
                        jw.wire_blockable(rows, cols, q, False), (rows, cols)
        assert not tw.wire_blockable(8, 32, "fp8")
        assert tw.wire_blockable(64, 2048, "fp8")

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("quant", ["fp8", "int8"])
    def test_codes_and_scales_are_jax_bytes(self, quant, dtype):
        """A slab of 4 chunks of 64 rows: normal rows, an outlier row, a
        chunk of zeros (scale 1e-12 / QMAX, codes 0) and a chunk below
        the 1e-12 floor: the codes (fp8 subnormals among them) equal JAX's
        eager quantizer byte for byte, the scales its plane's
        (lane-replicated) column, and the dequantized slab JAX's
        exactly."""
        rng = np.random.default_rng(1)
        x = rng.standard_normal((256, 96)).astype(np.float32)
        x[70] *= 1000.0
        x[128:192] = 0.0
        x[192:] *= 1e-30
        jx = jnp.asarray(x, getattr(jnp, dtype))
        tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(
            getattr(torch, dtype))
        jf, tf = jw.make_wire_format(quant, 256), tw.make_wire_format(quant,
                                                                      256)
        jq, js = jw.quantize_slab(jx, jf)
        tq, ts = tw.quantize_slab(tx, tf)
        assert tq.dtype == tf.wire_dtype and ts.shape == tf.scale_shape(256)
        np.testing.assert_array_equal(_bytes(tq), np.asarray(jq).view(np.uint8))
        js = np.asarray(js)
        assert (js == js[:, :1]).all()
        np.testing.assert_array_equal(ts.numpy(), js[:, 0])
        assert ts[2].item() == np.float32(1e-12) / np.float32(tf.qmax)
        assert not tq[128:192].view(torch.uint8).any()
        np.testing.assert_array_equal(
            tw.dequantize_slab(tq, ts, tf, torch.float32).numpy(),
            np.asarray(jw.dequantize_slab(jq, js, jf, jnp.float32)))

    def test_outlier_row_worst_case(self):
        """One outlier row inflates its chunk's int8 scale: its neighbours
        keep half a step of absolute error, as JAX's pinned case says."""
        x = np.random.default_rng(2).standard_normal((64, 512))
        x = x.astype(np.float32)
        x[0] *= 1000.0
        fmt = tw.make_wire_format("int8", 64)
        q, s = tw.quantize_slab(torch.from_numpy(x), fmt)
        y = tw.dequantize_slab(q, s, fmt, torch.float32).numpy()
        assert _rel(y[0], x[0]) < 0.01
        assert np.abs(y[1:] - x[1:]).max() <= 0.5 * s[0].item() * 1.01

    def test_quantize_cols(self):
        b = np.random.default_rng(3).standard_normal((256, 96))
        b = b.astype(np.float32)
        b[:, 5] = 0.0
        jq, js = jw.quantize_cols(jnp.asarray(b))
        tq, ts = tw.quantize_cols(torch.from_numpy(b))
        assert tq.dtype == torch.int8 and ts.shape == (1, 96)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        # leading dims batch: every rank's shard at once
        bq, bs = tw.quantize_cols(torch.from_numpy(b).reshape(256, 4, 24)
                                  .permute(1, 0, 2))
        for r in range(4):
            q, s = tw.quantize_cols(torch.from_numpy(b[:, 24 * r:24 * r + 24]))
            assert torch.equal(bq[r], q) and torch.equal(bs[r], s)


# ------------------------------------------------------------ AG-GEMM

#: (rows a rank, K, N): 64 rows a rank is one chunk of 64; 96 is three of
#: 32 (JAX's chunking), and not a multiple of the CUDA tile
AG_SHAPES = [(64, 256, 128), (96, 512, 64)]


class TestAgGemmWire:
    @pytest.mark.parametrize("wire", ["fp8", "int8", "int8-mxu"])
    @pytest.mark.parametrize("shape", AG_SHAPES)
    def test_matches_xla_ring(self, jmesh, tmesh, shape, wire):
        """Against JAX's XLA ring twin on the same wire, ``method=
        XLA_RING`` on both sides (with no method int8-mxu chunks at the
        fused engine's row block): every rank's output within 1e-5 of the
        largest (the same codes; rank r's own shard exact on the fp8 /
        int8 wires)."""
        m, k, n = shape
        a, b = _operands(10, W * m, k, n)
        want = np.asarray(j_ag_gemm(jnp.asarray(a), jnp.asarray(b), jmesh,
                                    "tp", method=AGGemmMethod.XLA_RING,
                                    wire_dtype=wire))
        ctx = ops.create_ag_gemm_context(
            tmesh, "tp", method=tag.AGGemmMethod.XLA_RING, wire_dtype=wire)
        got = ops.ag_gemm(_shards(a), _shards(b, 1), ctx)
        for r, g in enumerate(got):
            assert g.shape == (W * m, n // W)
            assert _rel(g, want[:, r * n // W:(r + 1) * n // W]) < SAME_CODES

    @pytest.mark.parametrize("wire,tol", [("fp8", 0.06), ("int8", 0.02),
                                          ("int8-mxu", 0.04)])
    def test_matches_fused_kernel(self, jmesh, tmesh, wire, tol):
        """JAX's interpreted fused kernels (``_fused_kernel_w`` /
        ``_mx``): within 1e-5 of them (the int8-mxu kernel pins its
        chunk to its 64-row block, which is the port's chunk here), and
        both within JAX's pinned tolerance of the exact product."""
        a, b = _operands(11, W * 64, 256, 128, outlier=False)
        want = np.asarray(j_ag_gemm(jnp.asarray(a), jnp.asarray(b), jmesh,
                                    "tp", method=AGGemmMethod.PALLAS_FUSED,
                                    wire_dtype=wire))
        got = tag.ag_gemm(_shards(a), _shards(b, 1), tmesh, wire_dtype=wire)
        exact = a @ b
        for r, g in enumerate(got):
            cols = slice(r * 32, (r + 1) * 32)
            assert _rel(g, want[:, cols]) < SAME_CODES
            assert _rel(g, exact[:, cols]) < tol

    @pytest.mark.parametrize("method", [None, "XLA_RING"])
    @pytest.mark.parametrize("m", [128, 256])
    def test_int8_mxu_engine_chunks_as_jax(self, jmesh, tmesh, m, method):
        """int8-mxu with no method takes JAX's heuristic on both sides:
        the fused engine, whose kernel chunks the scales at its row block
        (128 and 256 rows here, against the wire's 64), and with
        ``XLA_RING`` the ring's 64-row chunks. The port within 1e-5 of
        JAX's interpreted engine in f32 at W = 4, seed 11."""
        a, b = _operands(11, W * m, 256, 128, outlier=False)
        jm = None if method is None else AGGemmMethod[method]
        tm = None if method is None else tag.AGGemmMethod[method]
        want = np.asarray(j_ag_gemm(jnp.asarray(a), jnp.asarray(b), jmesh,
                                    "tp", method=jm, wire_dtype="int8-mxu"))
        plan = tag.resolve_ag_gemm_plan(tmesh, "tp", _shards(a),
                                        _shards(b, 1), method=tm,
                                        wire_dtype="int8-mxu")
        assert plan.wire == "int8-mxu"
        assert plan.chunk_rows == (m if method is None else 64)
        got = ops.ag_gemm(_shards(a), _shards(b, 1),
                          ops.OverlapContext(tmesh, "tp", method=tm,
                                             wire_dtype="int8-mxu"))
        for r, g in enumerate(got):
            assert _rel(g, want[:, r * 32:(r + 1) * 32]) < SAME_CODES

    def test_int8_mxu_against_the_int8_twin(self, tmesh):
        """JAX's pinned contract (tests/test_wire.py:356-376): int8-mxu
        within 0.04 of exact and 0.03 of the dequantizing int8 wire, with
        an outlier row."""
        a, b = _operands(12, W * 64, 1024, 128)
        mx = tag.ag_gemm(_shards(a), _shards(b, 1), tmesh,
                         wire_dtype="int8-mxu")
        twin = tag.ag_gemm(_shards(a), _shards(b, 1), tmesh,
                           wire_dtype="int8")
        for g, t in zip(mx, twin):
            assert np.isfinite(g.numpy()).all()
            assert _rel(g, t) < 0.03

    def test_bf16_wire_and_world_size_one(self, tmesh):
        """None and 'bf16' are the raw wire; at world size 1 (tensors)
        nothing crosses a wire, so every wire is the exact product, as
        JAX resolves it (``n == 1`` → None)."""
        a, b = _operands(13, W * 64, 256, 128)
        raw = tag.ag_gemm(_shards(a), _shards(b, 1), tmesh)
        for g, h in zip(raw, tag.ag_gemm(_shards(a), _shards(b, 1), tmesh,
                                         wire_dtype="bf16")):
            assert torch.equal(g, h)
        one = tag.ag_gemm(torch.from_numpy(a), torch.from_numpy(b))
        for w in ("fp8", "int8", "int8-mxu", "auto"):
            assert torch.equal(tag.ag_gemm(torch.from_numpy(a),
                                           torch.from_numpy(b),
                                           wire_dtype=w), one)
            assert tag.resolve_ag_gemm_wire(Mesh.loopback(1, "cpu"), "tp",
                                            [torch.from_numpy(a)],
                                            [torch.from_numpy(b)],
                                            wire_dtype=w) is None


# ------------------------------------------------------------ GEMM-RS

#: (rows a rank, K a rank, N)
RS_SHAPES = [(64, 64, 256), (96, 128, 192)]


class TestGemmRsWire:
    @pytest.mark.parametrize("wire", ["fp8", "int8", "int8-mxu"])
    @pytest.mark.parametrize("shape", RS_SHAPES)
    def test_matches_xla_ring(self, jmesh, tmesh, shape, wire):
        """Against JAX's XLA ring twin: the same hop order (destination
        d folds rank d − 1's partial first, its own last), each hop's
        running sum requantized: within 1e-5 of the largest output
        (int8-mxu ships its int8 payload there, as JAX resolves it; the
        port's context names the same engine)."""
        m, kq, n = shape
        a, b = _operands(20, W * m, W * kq, n)
        want = np.asarray(j_gemm_rs(jnp.asarray(a), jnp.asarray(b), jmesh,
                                    "tp", method=GemmRSMethod.XLA_RING,
                                    wire_dtype=wire))
        ctx = ops.create_gemm_rs_context(
            tmesh, "tp", method=trs.GemmRSMethod.XLA_RING, wire_dtype=wire)
        got = ops.gemm_rs(_shards(a, 1), _shards(b), ctx)
        for r, g in enumerate(got):
            assert g.shape == (m, n)
            assert _rel(g, want[r * m:(r + 1) * m]) < SAME_CODES

    @pytest.mark.parametrize("wire,tol", [("fp8", 0.15), ("int8", 0.04)])
    def test_matches_fused_kernel(self, jmesh, tmesh, wire, tol):
        """JAX's interpreted fused ``_fused_kernel_w`` and the port both
        within JAX's pinned tolerance of the exact product, and of each
        other. Not within 1e-5: the fused kernel sums each partial in its
        own K-block order and quantizes in-kernel, so a last-bit
        difference can move a hop's code by one step (an fp8 step is up
        to 1/14 of the chunk's largest value; read here 1.8e-3 of the
        largest output)."""
        a, b = _operands(21, W * 64, 256, 128, outlier=False)
        want = np.asarray(j_gemm_rs(jnp.asarray(a), jnp.asarray(b), jmesh,
                                    "tp", method=GemmRSMethod.PALLAS_FUSED,
                                    wire_dtype=wire))
        got = trs.gemm_rs(_shards(a, 1), _shards(b), tmesh, wire_dtype=wire)
        exact = a @ b
        for r, g in enumerate(got):
            rows = slice(r * 64, (r + 1) * 64)
            assert _rel(g, want[rows]) < tol
            assert _rel(g, exact[rows]) < tol
            assert _rel(want[rows], exact[rows]) < tol

    def test_int8_mxu_default_engine_matches_fused_kernel(self, jmesh,
                                                          tmesh):
        """With no method both sides take the fused engine, and at one
        out tile (N 128) int8-mxu runs the s8 producer
        (``_fused_kernel_mxw``): the port within 1e-5 of JAX's kernel in
        f32, and both within JAX's pinned int8-mxu contract, 0.04 of the
        exact product and 0.03 of the int8 wire
        (tests/test_torch_gemm_rs_mx.py has the shapes and bf16)."""
        a, b = _operands(21, W * 64, 256, 128)
        want = np.asarray(j_gemm_rs(jnp.asarray(a), jnp.asarray(b), jmesh,
                                    "tp", wire_dtype="int8-mxu"))
        got = torch.cat(trs.gemm_rs(_shards(a, 1), _shards(b), tmesh,
                                    wire_dtype="int8-mxu")).numpy()
        int8 = torch.cat(trs.gemm_rs(_shards(a, 1), _shards(b), tmesh,
                                     wire_dtype="int8")).numpy()
        assert _rel(got, want) < SAME_CODES
        assert _rel(got, a @ b) < 0.04 and _rel(got, int8) < 0.03

    def test_fold_replays_the_ring(self, tmesh):
        """The plain fold on hand-made partials: destination d starts
        from rank d − 1's partial, requantizes at each of the W − 1 hops
        and adds its own last; with zero partials but one, the result is
        that partial's code · scale."""
        fmt = tw.make_wire_format("int8", 64)
        g = torch.Generator().manual_seed(4)
        parts = [torch.randn((64, 256), generator=g) for _ in range(W)]
        d = 2
        order = trs.ring_order(parts, d)
        assert all(p is parts[q] for p, q in zip(order, (1, 0, 3, 2)))
        acc = order[0]
        for nxt in order[1:]:
            q, s = tw.quantize_slab(acc, fmt)
            acc = tw.dequantize_slab(q, s, fmt, torch.float32) + nxt
        assert torch.equal(trs.wire_fold_plain(order, fmt, torch.float32),
                           acc)
        zeros = [torch.zeros_like(parts[0])] * (W - 1)
        one = trs.wire_fold_plain([parts[0], *zeros], fmt, torch.float32)
        q, s = tw.quantize_slab(parts[0], fmt)
        for _ in range(W - 2):   # requantizing a dequantized slab is exact
            q, s = tw.quantize_slab(tw.dequantize_slab(q, s, fmt,
                                                       torch.float32), fmt)
        assert torch.equal(one, tw.dequantize_slab(q, s, fmt, torch.float32))


# ----------------------------------------------------------- all-gather

def _per_device(arr):
    """Every device's copy of a replicated JAX result (their own slabs
    differ on a wire), in device order."""
    shards = sorted(arr.addressable_shards, key=lambda s: s.device.id)
    return [np.asarray(s.data) for s in shards]


class TestAllGatherWire:
    @pytest.mark.parametrize("method", ["RING_1D", "XLA_FALLBACK"])
    @pytest.mark.parametrize("wire", ["fp8", "int8"])
    def test_matches_jax(self, jmesh, tmesh, wire, method):
        """JAX's Pallas ring (``_ring_ag_kernel_w``, interpreted) and its
        XLA twin, per device: rank r's own slab exact, the peers' rows
        dequantized from per-row codes, within 1e-5 (an ulp of a scale
        that JAX's jitted quantizer rounds apart)."""
        x = np.random.default_rng(5).standard_normal((W * 32, 1024))
        x = x.astype(np.float32)
        x[40] *= 1000.0
        want = _per_device(j_all_gather(jnp.asarray(x), jmesh, "tp",
                                        method=JAGMethod[method],
                                        wire_dtype=wire))
        got = tallg.all_gather(_shards(x), tmesh, "tp", wire_dtype=wire)
        for r, (g, w) in enumerate(zip(got, want)):
            rows = slice(r * 32, (r + 1) * 32)
            np.testing.assert_array_equal(g[rows].numpy(), x[rows])
            assert _rel(g, w) < SAME_CODES
            assert _rel(g, x) < (0.06 if wire == "fp8" else 0.02)

    @pytest.mark.parametrize("rows", [60, 64])
    def test_auto_at_256_kib(self, jmesh, tmesh, rows):
        """'auto' on the ring sends fp8 from 256 KiB a shard (64 rows of
        1024 f32) and stays exact below (60 rows), as JAX's RING_1D
        does; with no method it stays exact at 4 ranks, as JAX's pick
        (the bidirectional ring) does."""
        assert auto_allgather_wire(rows * 4096) == \
            j_auto_allgather_wire(rows * 4096)
        x = np.random.default_rng(6).standard_normal((W * rows, 1024))
        x = x.astype(np.float32)
        want = _per_device(j_all_gather(jnp.asarray(x), jmesh, "tp",
                                        method=JAGMethod.RING_1D,
                                        wire_dtype="auto"))
        got = tallg.all_gather(_shards(x), tmesh, "tp",
                               method=AllGatherMethod.RING_1D,
                               wire_dtype="auto")
        for g, w in zip(got, want):
            if rows < 64:
                np.testing.assert_array_equal(g.numpy(), x)
                np.testing.assert_array_equal(w, x)
            else:
                assert not np.array_equal(g.numpy(), x)
                assert _rel(g, w) < SAME_CODES
        for g in tallg.all_gather(_shards(x), tmesh, "tp", wire_dtype="auto"):
            np.testing.assert_array_equal(g.numpy(), x)

    @pytest.mark.parametrize("n", [2, 3, 4, 8])
    def test_auto_without_method_follows_jax_pick(self, n):
        """With no method, 'auto' first takes the method JAX picks
        (``auto_allgather_method``: the LL push up to 64 KiB a shard, the
        bidirectional ring from 4 ranks, the ring below), and only the
        ring carries a wire; an explicit wire rides the ring whatever
        the pick."""
        for rows in (8, 16, 17, 60, 64, 128):
            nbytes = rows * 1024 * 4
            want = j_auto_allgather_method(
                TopologyInfo(n, LinkKind.ICI, is_torus=True), nbytes)
            assert auto_allgather_method(n, nbytes).value == want.value
            x = [torch.zeros((rows, 1024)) for _ in range(n)]
            assert tallg.resolve_all_gather_wire(x, n, "auto") == (
                j_auto_allgather_wire(nbytes)
                if want == JAGMethod.RING_1D else None)
            assert tallg.resolve_all_gather_wire(x, n, "fp8") == "fp8"

    def test_explicit_wire_demotes_methods_and_refuses_1d(self, tmesh):
        """An explicit wire runs the ring under RING_BIDIR / LL_SMALL /
        LL_PERSIST (JAX ``:606-607``); 1-D shards cannot carry one
        (tests/test_wire.py:479-483) and 'auto' leaves them exact."""
        x = _shards(np.random.default_rng(7).standard_normal((W * 8, 512)))
        ring = tallg.all_gather(x, tmesh, wire_dtype="int8")
        for m in ("RING_BIDIR", "LL_SMALL", "LL_PERSIST"):
            for g, h in zip(tallg.all_gather(x, tmesh, wire_dtype="int8",
                                             method=AllGatherMethod[m]),
                            ring):
                assert torch.equal(g, h)
        flat = [torch.zeros((64,)) for _ in range(W)]
        with pytest.raises(ValueError, match="wire"):
            tallg.all_gather(flat, tmesh, wire_dtype="fp8")
        for g in tallg.all_gather(flat, tmesh, wire_dtype="auto"):
            assert torch.equal(g, torch.zeros((W * 64,)))


# --------------------------------------------------------- the layers

@pytest.mark.parametrize("wire", ["fp8", "int8", "int8-mxu"])
def test_parallel_mlp_on_a_wire_matches_jax(jmesh, tmesh, wire):
    """``ParallelMLP`` (up → silu → down) over a wire context, against
    JAX's layers on XLA ring contexts of the same wire (the port's row
    layer names the same GEMM-RS engine), and within JAX's
    pinned RS tolerance of the raw wire. The up projection's outputs
    agree to the summation order, so a reduce hop can see a last-bit
    different activation and move one code by a step (an fp8 step is up
    to 1/14 of its chunk's largest value): fewer than 1 in 1000 outputs
    may stray past 1e-5 of the largest (1 in 65536 did, by 6.1e-5,
    under fp8), and none past the pinned tolerance."""
    m, h, f = 64, 256, 512
    rng = np.random.default_rng(8)
    x = rng.standard_normal((W * m, h)).astype(np.float32)
    up = (rng.standard_normal((h, f)) / np.sqrt(h)).astype(np.float32)
    down = (rng.standard_normal((f, h)) / np.sqrt(f)).astype(np.float32)
    jctx = dict(method=AGGemmMethod.XLA_RING, wire_dtype=wire)
    jmlp = jlin.ParallelMLP(
        jlin.ColumnParallelLinear(jov.create_ag_gemm_context(jmesh, "tp",
                                                             **jctx)),
        jlin.RowParallelLinear(jov.create_gemm_rs_context(
            jmesh, "tp", method=GemmRSMethod.XLA_RING, wire_dtype=wire)),
        activation="silu")
    want = np.asarray(jmlp({"up": {"w": jnp.asarray(up)},
                            "down": {"w": jnp.asarray(down)}},
                           jnp.asarray(x)))

    def mlp(w):
        ctx = ops.OverlapContext(tmesh, "tp", wire_dtype=w)
        rs = ops.OverlapContext(tmesh, "tp", wire_dtype=w,
                                method=trs.GemmRSMethod.XLA_RING)
        return layers.ParallelMLP(layers.ColumnParallelLinear(ctx),
                                  layers.RowParallelLinear(rs),
                                  activation="silu")

    params = {"up": {"w": _shards(up, 1)}, "down": {"w": _shards(down)}}
    got = torch.cat(mlp(wire)(params, _shards(x))).numpy()
    raw = torch.cat(mlp(None)(params, _shards(x))).numpy()
    assert got.shape == (W * m, h)
    tol = 0.15 if wire == "fp8" else 0.04
    d = np.abs(got - want) / np.abs(want).max()
    assert (d > SAME_CODES).mean() < 1e-3 and d.max() < tol
    assert _rel(got, raw) < tol


# ---------------------------------------------------------- the refusals

class TestRefusals:
    def test_ineligible_slab_raises(self, tmesh):
        """A pinned wire on a slab whose scale rows eat the compression
        (8 x 32 a rank) raises, as JAX does; so does a spelling outside
        the vocabulary."""
        # 8 rows a rank: 8 x 32 codes and a 512-byte scale row are more
        # bytes than the bf16 slab
        a32 = _shards(np.zeros((W * 8, 32)))
        b = _shards(np.zeros((32, 128)), 1)
        for w in ("fp8", "int8", "int8-mxu"):
            with pytest.raises(ValueError, match="wire"):
                tag.ag_gemm(a32, b, tmesh, wire_dtype=w)
        a = _shards(np.zeros((W * 8, 256)), 1)
        b32 = _shards(np.zeros((256, 32)))
        with pytest.raises(ValueError, match="wire"):
            trs.gemm_rs(a, b32, tmesh, wire_dtype="int8")
        with pytest.raises(ValueError, match="wire_dtype"):
            ops.OverlapContext(tmesh, wire_dtype="fp4")

    def test_auto_and_backward_wires_raise(self, tmesh):
        a, b = _operands(9, W * 64, 256, 128)
        with pytest.raises(NotImplementedError, match="Queue 1 step 10"):
            tag.ag_gemm(_shards(a), _shards(b, 1), tmesh, wire_dtype="auto")
        with pytest.raises(NotImplementedError, match="Queue 1 step 10"):
            trs.gemm_rs(_shards(a, 1), _shards(b), tmesh, wire_dtype="auto")
        # the backward duals' wires came with training: a pinned one the
        # cotangent cannot carry raises when the backward resolves it
        ctx = ops.create_ag_gemm_context(tmesh, "tp", bwd_wire_dtype="int8")
        with pytest.raises(ValueError, match="pinned wire format"):
            ops.overlap._resolve_bwd(ctx, W * 2 - 1, 32)
