"""Parity of the PyTorch port's MoE-TP quantized wires with the JAX package.

The JAX side runs on a mesh of 4 of the 8 virtual CPU devices
(``tests/conftest.py``), its fused MoE-TP wire kernels
(``ag_group_gemm_kernel_w``, ``ag_group_gemm_kernel_mx``,
``moe_reduce_rs_kernel_w``) interpreted; the port's side on
``Mesh.loopback(4, "cpu")``, where every kernel wrapper runs its plain
PyTorch version because the tensors lie on the CPU. The same inputs,
drawn with numpy from a seed (64 tokens, hidden 128, ffn 256, 8 experts,
top-2, block_m 64, one skewed routing: expert 3 starved, expert 0
favoured), go through both:

* the wire formats (``_wire_fmt``: fp8 / int8 chunked as
  ``make_wire_format`` picks, int8-mxu one chunk a routing block) and the
  sorted slabs' codes and scales, byte for byte against JAX's eager
  ``quantize_slab`` of its ``gather_sorted`` slabs, at block_m 128 so
  that the two chunkings differ, all-padding chunks included;
* ``ag_group_gemm_fused`` on each wire, the padding rows exactly 0;
* ``moe_reduce_rs_fused`` on fp8 and int8 (int8-mxu ships int8);
* the whole ``moe_tp_mlp_overlapped`` on each wire, and at tp = 1;
* the refusals.

Tolerances. The AG side computes on the same codes as JAX in f32: 1e-5
of the largest output (the products are summed in another order; read
1.2-2.7e-7). In bf16 JAX's jitted quantizer multiplies by the reciprocal
of the scale, where the port (and JAX's eager quantizer, byte for byte)
divides, so at an exact tie, which bf16 inputs hit, a code moves one
step (2 of 4 x 576 x 128 slab codes and 17 weight codes here): the
port's kernels fed JAX's jitted codes are held at 2^-7 relative, every
element (one bf16 rounding of the output on each side), and the whole op
at 2^-7 of the largest output (read 0.40-0.59 %). The reduce side cannot
be held to 1e-5 in general: each rank's partial is summed in its own K
order, and a last-bit difference can move a hop's code by one step (an
fp8 step is up to 1/14 of its chunk's largest value), as for the dense
fold (``tests/test_torch_wire.py``). So the port, JAX and the exact sum
(the bf16 wire in f32) are held within JAX's pinned RS limits of each
other (``tests/test_wire.py``: fp8 0.15, int8 0.04 of the largest
output). Readings: the port against JAX 1.3e-7 (fp8) and 9.3e-8 (int8) on
the reduce alone, 1.0-3.0e-7 on the whole MLP; both against the exact
sum 4.5 % / 0.73 % on the reduce, 4.6 / 1.2 / 1.4 % (fp8 / int8 /
int8-mxu) on the whole MLP. The CUDA kernels are held against these
plain versions in tests/test_torch_cuda.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from triton_distributed_tpu import ops as jops
from triton_distributed_tpu.kernels import moe_tp_fused as jmtf
from triton_distributed_tpu.kernels import moe_utils as jmu
from triton_distributed_tpu.kernels.group_gemm import (
    quantize_grouped_weights as j_quantize_grouped_weights,
)
from triton_distributed_tpu.lang import wire as jw
from triton_distributed_tpu_torch import ops
from triton_distributed_tpu_torch.kernels import moe_tp_fused as tmtf
from triton_distributed_tpu_torch.kernels import moe_utils as tmu
from triton_distributed_tpu_torch.lang import wire as tw
from triton_distributed_tpu_torch.runtime import Mesh

W = 4
#: 64 tokens (16 a rank), hidden 128, ffn 256 (64 a rank), 8 experts,
#: top-2, routing blocks of 64 rows
M, H, F, E, K, BM = 64, 128, 256, 8, 2, 64
WIRES = ("fp8", "int8", "int8-mxu")
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
#: the same codes, products summed in another order
SAME_CODES = 1e-5
#: JAX's pinned limits of a reduce wire against the exact sum
RS_TOL = {"fp8": 0.15, "int8": 0.04}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the inputs are tiny, and the suite runs in
    several worker processes that share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jmesh(n=W):
    return JMesh(np.asarray(jax.devices()[:n]), ("tp",))


@pytest.fixture(scope="module")
def tmesh():
    return Mesh.loopback(W, "cpu")


def _t(a, dtype=None):
    """numpy → torch; bf16 through f32."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
        dtype = dtype or torch.bfloat16
    return torch.from_numpy(np.array(a, copy=True)).to(dtype)


def _np(a):
    """A torch or JAX array as f32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a).astype(np.float32)


def _cols(shards):
    """Per-rank column shards put back side by side."""
    return np.concatenate([_np(s) for s in shards], axis=1)


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _data(seed, outlier=False):
    """x (M, H) (with ``outlier``, token 3 x1000, its chunk's worst
    case), router logits with expert 3 starved and expert 0 favoured by
    the first half of the tokens, (E, H, F) / (E, F, H) weights, and both
    sides' routing (top-k ids equal)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, H)).astype(np.float32)
    if outlier:
        x[3] *= 1000.0
    logits = rng.standard_normal((M, E)).astype(np.float32)
    logits[:, 3] = -30.0
    logits[: M // 2, 0] += 4.0
    w_up = (rng.standard_normal((E, H, F)) / np.sqrt(H)).astype(np.float32)
    w_down = (rng.standard_normal((E, F, H)) / np.sqrt(F)).astype(np.float32)
    jw_, jids = jmu.select_experts(jnp.asarray(logits), K)
    tw_, tids = tmu.select_experts(_t(logits), K)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    return x, (jw_, jids), (tw_, tids), w_up, w_down


def _f_shards(w, dim, dtype):
    """W shards of an expert tensor over its F dim (views of one
    allocation, as ``shard_params`` makes them)."""
    parts = np.split(np.asarray(w, np.float32), W, axis=dim)
    return list(torch.stack([_t(p, dtype) for p in parts]).unbind(0))


def _contexts(wire, dtype, tmesh, n=W, block_m=BM):
    jdt, tdt = DTYPES[dtype]
    jctx = jops.create_ag_group_gemm_context(
        _jmesh(n), "tp", num_experts=E, topk=K, dtype=jdt, block_m=block_m,
        wire_dtype=wire)
    tctx = ops.create_ag_group_gemm_context(
        num_experts=E, topk=K, dtype=tdt, mesh=tmesh, block_m=block_m,
        wire_dtype=wire)
    return jctx, tctx


@functools.lru_cache(maxsize=None)
def _jax_ag(wire, dtype):
    """JAX's interpreted AG ⊕ grouped GEMM on ``wire`` (cached: each call
    interprets a ring of 4 devices)."""
    x, (_, jids), _, w_up, _ = _data(1)
    jdt = DTYPES[dtype][0]
    jctx, _ = _contexts(wire, dtype, None)
    jr = jops.align_routing_sharded(jctx, jids)
    return np.asarray(jops.ag_group_gemm_fused(
        jnp.asarray(x, jdt), jr, jnp.asarray(w_up, jdt), jctx), np.float32)


def _jax_jitted_wire(wire, jr, x, w_up):
    """The bf16 wire forms as JAX's jitted call makes them (its XLA
    quantizers, jitted): every shard's sorted slab's codes (W, cap_s, H)
    and scales (W, chunks), and for int8-mxu every rank's expert weights
    (``quantize_grouped_weights``) as the s8 loop takes them, (W, E, N,
    K) codes and (W, E, N) scales."""
    fmt = jmtf._wire_fmt(wire, jr.cap_s, BM)
    quant = jax.jit(jw.quantize_slab, static_argnums=1)
    jx = jnp.asarray(x, jnp.bfloat16)
    ms = M // W
    codes, scales = [], []
    for r in range(W):
        jq, js = quant(jmu.gather_sorted(jx[r * ms:(r + 1) * ms], jr.sti[r],
                                         K).astype(jnp.bfloat16), fmt)
        jq = np.asarray(jq)
        codes.append(torch.from_numpy(jq.view(np.uint8).copy()).view(
            tw.make_wire_format(wire, 64).wire_dtype))
        scales.append(torch.from_numpy(np.asarray(js)[:, 0].copy()))
    q, s = torch.stack(codes), torch.stack(scales)
    if wire != "int8-mxu":
        return q, s, None
    wquant = jax.jit(lambda w: j_quantize_grouped_weights(w, "int8"))
    pairs = [wquant(jnp.asarray(p, jnp.bfloat16))
             for p in np.split(w_up, W, axis=2)]
    wq = torch.stack([torch.from_numpy(np.asarray(a).copy()) for a, _ in
                      pairs]).transpose(2, 3).contiguous()
    ws = torch.stack([torch.from_numpy(np.asarray(b).copy())
                      for _, b in pairs])
    return q, s, (wq, ws)


def _rs_input(cap_s, sti, seed=3):
    """A post-activation slab (W·cap_s, F), zeros at the padding rows."""
    y = np.random.default_rng(seed).standard_normal(
        (W * cap_s, F)).astype(np.float32)
    y[(sti >= (M // W) * K).numpy().reshape(-1)] = 0.0
    return y


@functools.lru_cache(maxsize=None)
def _jax_rs(wire):
    _, (jwts, jids), _, _, w_down = _data(2)
    jctx, _ = _contexts(wire, "float32", None)
    jr = jops.align_routing_sharded(jctx, jids)
    y = _rs_input(jr.cap_s, torch.from_numpy(np.array(jr.sti)))
    return np.asarray(jops.moe_reduce_rs_fused(
        jnp.asarray(y), jr, jwts, jnp.asarray(w_down), jctx), np.float32)


# ------------------------------------------------------------ wire formats

class TestWireFormat:
    def test_chunkings_are_jax(self):
        """``_wire_fmt`` equals JAX's: fp8 / int8 at ``make_wire_format``'s
        chunk rows, int8-mxu at one chunk a routing block. At the tp = 4
        prefill's 20480 sorted rows a shard the two differ (64 and 128)."""
        for rows in (64, 128, 576, 640, 1152, 1280, 2304, 20480):
            for wire in ("fp8", "int8"):
                t, j = tmtf._wire_fmt(wire, rows), jmtf._wire_fmt(wire, rows)
                assert (t.quant, t.chunk_rows) == (j.quant, j.chunk_rows)
            for bm in (64, 128):
                if rows % bm:
                    continue
                t = tmtf._wire_fmt("int8-mxu", rows, bm)
                j = jmtf._wire_fmt("int8-mxu", rows, bm)
                assert (t.quant, t.chunk_rows) == (j.quant, j.chunk_rows)
        assert tmtf._wire_fmt("fp8", 20480).chunk_rows == 64
        assert tmtf._wire_fmt("int8-mxu", 20480, 128).chunk_rows == 128
        assert tmtf._wire_fmt(None, 20480) is None
        # the reduce side carries int8-mxu's payload
        assert tw.wire_payload("int8-mxu") == "int8"

    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    @pytest.mark.parametrize("wire", WIRES)
    def test_sorted_slab_codes_are_jax_bytes(self, tmesh, wire, dtype):
        """Every shard's materialized sorted slab on the wire (block_m
        128: fp8 / int8 chunks of 64 rows, int8-mxu of 128), with an
        outlier token: the codes equal JAX's eager ``quantize_slab`` of
        its ``gather_sorted`` slab byte for byte, the scales its plane's
        column; the all-padding chunks at the end of a slab are codes 0
        at the scale 1e-12 / QMAX."""
        x, (_, jids), _, _, _ = _data(5, outlier=True)
        jdt, tdt = DTYPES[dtype]
        jctx, tctx = _contexts(wire, dtype, tmesh, block_m=128)
        jr = jops.align_routing_sharded(jctx, jids)
        tr = ops.align_routing_sharded(tctx, _t(np.asarray(jids),
                                                torch.int32))
        np.testing.assert_array_equal(tr.sti.numpy(), np.asarray(jr.sti))
        cap_s = tr.cap_s
        tf = tmtf._wire_fmt(wire, cap_s, 128)
        jf = jmtf._wire_fmt(wire, cap_s, 128)
        assert tf.chunk_rows == jf.chunk_rows == (128 if wire == "int8-mxu"
                                                  else 64)
        xs = list(_t(x, tdt).chunk(W))
        q, s, slabs = tmtf.quantize_sorted(xs, tr.sti, K, tf)
        assert q.shape == (W, cap_s, H) and s.shape == (W, cap_s //
                                                        tf.chunk_rows)
        assert slabs.shape == (W, cap_s, H) and slabs.dtype == tdt
        jx = jnp.asarray(x, jdt)
        pad_chunks = 0
        for r in range(W):
            slab = jmu.gather_sorted(jx[r * (M // W):(r + 1) * (M // W)],
                                     jr.sti[r], K).astype(jdt)
            np.testing.assert_array_equal(slabs[r].float().numpy(),
                                          np.asarray(slab, np.float32))
            jq, js = jw.quantize_slab(slab, jf)
            np.testing.assert_array_equal(q[r].view(torch.uint8).numpy(),
                                          np.asarray(jq).view(np.uint8))
            np.testing.assert_array_equal(s[r].numpy(), np.asarray(js)[:, 0])
            pad = (tr.sti[r] >= (M // W) * K).reshape(-1, tf.chunk_rows)
            for c in torch.nonzero(pad.all(1)).flatten().tolist():
                pad_chunks += 1
                rows = slice(c * tf.chunk_rows, (c + 1) * tf.chunk_rows)
                assert not q[r, rows].view(torch.uint8).any()
                assert s[r, c].item() == np.float32(1e-12) / np.float32(
                    tf.qmax)
        assert pad_chunks >= W

    def test_refusals(self, tmesh):
        """'auto' is no MoE-TP wire (JAX has none here: an explicit
        opt-in); a slab with no legal chunking raises on both sides, as
        does an int8-mxu slab that routing blocks do not cut."""
        with pytest.raises(ValueError, match="auto"):
            ops.create_ag_group_gemm_context(num_experts=E, topk=K,
                                             mesh=tmesh, wire_dtype="auto")
        with pytest.raises(ValueError, match="wire_dtype"):
            ops.MoETPContext(num_experts=E, topk=K, wire_dtype="fp4")
        for mod in (tmtf, jmtf):
            with pytest.raises(ValueError, match="no legal scale chunking"):
                mod._wire_fmt("int8", 0)
        with pytest.raises(ValueError, match="block_m=128"):
            tmtf._wire_fmt("int8-mxu", 576, 128)
        with pytest.raises(AssertionError):
            jmtf._wire_fmt("int8-mxu", 576, 128)

    def test_wrappers_refuse_a_wrong_wire_form(self, tmesh):
        """The wire wrappers take the codes and scales of their format
        only: fp8 codes on an int8 format, and int8-mxu scales that are
        not one a routing block, are refused before any product."""
        x, _, (_, tids), w_up, _ = _data(1)
        _, tctx = _contexts("int8", "float32", tmesh)
        tr = ops.align_routing_sharded(tctx, tids)
        xs = list(_t(x).chunk(W))
        w_sh = _f_shards(w_up, 2, torch.float32)
        fmt8 = tmtf._wire_fmt("fp8", tr.cap_s)
        q, s, slabs = tmtf.quantize_sorted(xs, tr.sti, K, fmt8)
        with pytest.raises(ValueError, match="wire form"):
            tmtf.ag_group_gemm_mesh_w(xs, q, s, tr.sti, tr.be, w_sh, K,
                                      tmesh, tmtf._wire_fmt("int8",
                                                            tr.cap_s),
                                      slabs=slabs)
        q, s, _ = tmtf.quantize_sorted(xs, tr.sti, K,
                                       tmtf._wire_fmt("int8", tr.cap_s))
        wq, ws = tmtf.quantize_expert_shards(w_sh)
        with pytest.raises(ValueError, match="one scale a routing block"):
            tmtf.ag_group_gemm_mesh_mx(q, s[:, 1:].contiguous(), tr.be, wq,
                                       ws, tmesh)


# ----------------------------------------------------------- the two ops

class TestMoEWireOps:
    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    @pytest.mark.parametrize("wire", WIRES)
    def test_ag_group_gemm_fused_matches_jax(self, tmesh, wire, dtype):
        """Every shard's sorted rows against each rank's F columns, on the
        wire, against JAX's interpreted ``ag_group_gemm_kernel_w`` /
        ``_mx``; the padding rows exactly zero on both. f32: the same
        codes, so 1e-5 of the largest output. bf16: JAX's jitted
        quantizer multiplies by the reciprocal of the scale, so at an
        exact tie, which bf16 inputs hit, its code is one step from its
        eager quantizer's (the port's, byte for byte, above): the port's
        kernels given JAX's jitted codes are held at 2^-7 relative, every
        element; the whole op, the port's own codes, at 2^-7 of the
        largest output."""
        x, (_, jids), (_, tids), w_up, _ = _data(1)
        jctx, tctx = _contexts(wire, dtype, tmesh)
        tdt = DTYPES[dtype][1]
        tr = ops.align_routing_sharded(tctx, tids)
        want = _jax_ag(wire, dtype)
        w_sh = _f_shards(w_up, 2, tdt)
        got = ops.ag_group_gemm_fused(_t(x, tdt), tr, w_sh, tctx)
        assert len(got) == W and got[0].dtype == tdt
        got = _cols(got)
        assert got.shape == want.shape == (W * tr.cap_s, F)
        pad = (tr.sti >= (M // W) * K).numpy().reshape(-1)
        assert pad.any() and (got[pad] == 0).all() and (want[pad] == 0).all()
        # the wire moved the peers' rows: not the bf16 wire's product
        _, raw = _contexts(None, dtype, tmesh)
        exact = _cols(ops.ag_group_gemm_fused(_t(x, tdt), tr, w_sh, raw))
        assert 0.0 < _rel(got, exact) < {"fp8": 0.06, "int8": 0.02,
                                         "int8-mxu": 0.04}[wire]
        if dtype == "float32":
            assert _rel(got, want) < SAME_CODES
            return
        assert _rel(got, want) < 2.0 ** -7
        jr = jops.align_routing_sharded(jctx, jids)
        q, s, wq = _jax_jitted_wire(wire, jr, x, w_up)
        fmt = tmtf._wire_fmt(wire, tr.cap_s, BM)
        if wire == "int8-mxu":
            on_jax = tmtf.ag_group_gemm_mesh_mx(q, s, tr.be, *wq, tmesh,
                                                out_dtype=tdt)
        else:
            xs = list(_t(x, tdt).chunk(W))
            on_jax = tmtf.ag_group_gemm_mesh_w(
                xs, q, s, tr.sti, tr.be, w_sh, K, tmesh, fmt,
                slabs=tmtf.gather_sorted(torch.stack(xs), tr.sti, K))
        np.testing.assert_allclose(_cols(on_jax), want, rtol=2.0 ** -7,
                                   atol=1e-6)

    @pytest.mark.parametrize("wire", ["fp8", "int8"])
    def test_moe_reduce_rs_fused_matches_jax(self, tmesh, wire):
        """Each rank's rows summed over the ranks' F shards through the
        reduce ring's requantizing hops, then the top-k combine, against
        JAX's interpreted ``moe_reduce_rs_kernel_w``: the port and JAX
        each within JAX's pinned limit of the exact sum (the bf16 wire in
        f32) and of each other; int8-mxu's reduce is the int8 wire's,
        bit for bit."""
        _, _, (twts, tids), _, w_down = _data(2)
        _, tctx = _contexts(wire, "float32", tmesh)
        tr = ops.align_routing_sharded(tctx, tids)
        y = _rs_input(tr.cap_s, tr.sti)
        args = (_f_shards(y, 1, torch.float32), tr, twts,
                _f_shards(w_down, 1, torch.float32))
        got = ops.moe_reduce_rs_fused(*args, tctx).numpy()
        want = _jax_rs(wire)
        _, raw = _contexts(None, "float32", tmesh)
        exact = ops.moe_reduce_rs_fused(*args, raw).numpy()
        assert got.shape == want.shape == (M, H)
        tol = RS_TOL[wire]
        assert 0.0 < _rel(got, exact) < tol
        assert _rel(want, exact) < tol
        assert _rel(got, want) < tol
        if wire == "int8":
            _, mx = _contexts("int8-mxu", "float32", tmesh)
            assert np.array_equal(ops.moe_reduce_rs_fused(*args, mx).numpy(),
                                  got)

    @pytest.mark.parametrize("wire", WIRES)
    def test_moe_tp_mlp_overlapped_matches_jax(self, tmesh, wire):
        """The whole overlapped MLP on the wire in f32: the port and JAX
        within the reduce wire's pinned limit (int8-mxu: its int8
        payload's) of each other and of the bf16 wire."""
        x, (jwts, jids), (twts, tids), w_up, w_down = _data(4)
        jctx, tctx = _contexts(wire, "float32", tmesh)
        want = np.asarray(jops.moe_tp_mlp_overlapped(
            jnp.asarray(x), jids, jwts, jnp.asarray(w_up),
            jnp.asarray(w_down), jctx), np.float32)
        args = (_t(x), tids, twts, _f_shards(w_up, 2, torch.float32),
                _f_shards(w_down, 1, torch.float32))
        got = ops.moe_tp_mlp_overlapped(*args, tctx).numpy()
        _, raw = _contexts(None, "float32", tmesh)
        exact = ops.moe_tp_mlp_overlapped(*args, raw).numpy()
        tol = RS_TOL[tw.wire_payload(wire)]
        assert np.isfinite(got).all() and got.shape == (M, H)
        assert _rel(got, want) < tol
        assert 0.0 < _rel(got, exact) < tol
        assert _rel(want, exact) < tol


# ------------------------------------------------------------- one rank

class TestOneRank:
    @pytest.mark.parametrize("wire", ["fp8", "int8"])
    def test_fp8_int8_equal_the_bf16_wire(self, wire):
        """At tp = 1 the AG ring consumes its own slab exact and the
        reduce ring has no hop: the fp8 / int8 MLP is the bf16 wire's, bit
        for bit."""
        x, _, (twts, tids), w_up, w_down = _data(6)
        args = (_t(x), tids, twts, _t(w_up), _t(w_down))
        _, raw = _contexts(None, "float32", None)
        _, wired = _contexts(wire, "float32", None)
        assert torch.equal(ops.moe_tp_mlp_overlapped(*args, wired),
                           ops.moe_tp_mlp_overlapped(*args, raw))

    def test_int8_mxu_on_one_slab_matches_jax(self):
        """At tp = 1 int8-mxu still runs the own slab's codes through the
        s8 product: against JAX's ``ag_group_gemm_kernel_mx`` on a
        1-device mesh, 1e-5 of the largest output; the padding rows 0."""
        x, (_, jids), (_, tids), w_up, _ = _data(7)
        jctx, tctx = _contexts("int8-mxu", "float32", None, n=1)
        jr = jops.align_routing_sharded(jctx, jids)
        want = np.asarray(jops.ag_group_gemm_fused(
            jnp.asarray(x), jr, jnp.asarray(w_up), jctx), np.float32)
        tr = ops.align_routing_sharded(tctx, tids)
        got = ops.ag_group_gemm_fused(_t(x), tr, _t(w_up), tctx).numpy()
        assert got.shape == want.shape == (tr.cap_s, F)
        assert _rel(got, want) < SAME_CODES
        pad = (tr.sti >= M * K).numpy()
        assert pad.any() and (got[pad] == 0).all()
        _, raw = _contexts(None, "float32", None)
        exact = ops.ag_group_gemm_fused(_t(x), tr, _t(w_up), raw).numpy()
        assert 0.0 < _rel(got, exact) < 0.04
