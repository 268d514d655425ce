"""Parity of the PyTorch port's MoE modules with the JAX package.

Routing, block alignment, the wire quantizers, the fused transport's
geometry, staging, metadata and unpacking, the chunked all-to-all's
plain version against the JAX kernel (interpret mode, a one-device
mesh), the float grouped GEMM, and ``ops.ep_moe`` against JAX
``ops.ep_moe`` on the path a TPU takes (fused transport, Pallas grouped
GEMMs). Inputs are drawn with numpy from a seed; integers must match
exactly, floats within the tolerance each test states.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from triton_distributed_tpu import ops as jops
from triton_distributed_tpu.kernels import group_gemm as jgg
from triton_distributed_tpu.kernels import moe_all_to_all as jma
from triton_distributed_tpu.kernels import moe_dispatch as jmd
from triton_distributed_tpu.kernels import moe_utils as jmu
from triton_distributed_tpu_torch import ops as tops
from triton_distributed_tpu_torch.kernels import group_gemm as tgg
from triton_distributed_tpu_torch.kernels import moe_all_to_all as tma
from triton_distributed_tpu_torch.kernels import moe_dispatch as tmd
from triton_distributed_tpu_torch.kernels import moe_utils as tmu

E, TOPK, H, FF, M = 8, 2, 128, 64, 40


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
    """numpy (or JAX) → torch, fp8 through its bytes."""
    a = np.asarray(a)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(np.array(a, copy=True))


def _np(t):
    """torch → numpy, fp8 as its bytes."""
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy()
    return t.numpy()


def _jbytes(a):
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.name == "float8_e4m3fn" else a


def _contexts(mesh, quant, dtype="float32", max_m=M * TOPK, chunk_m=None):
    j = jma.create_all_to_all_context(
        mesh, "tp", max_m=max_m, hidden=H, experts_per_rank=E,
        dtype=getattr(jnp, dtype), quant=quant, chunk_m=chunk_m)
    t = tma.MoEAllToAllContext(n=1, max_m=max_m, hidden=H,
                               experts_per_rank=E, dtype=dtype, quant=quant,
                               chunk_m=chunk_m)
    return j, t


def _routing(seed, masked=3):
    """Expert ids per assignment (M·TOPK), the last ``masked`` set to
    the sentinel E, and the rows to stage."""
    rng = np.random.default_rng(seed)
    flat_e = rng.integers(0, E, (M * TOPK,)).astype(np.int32)
    flat_e[rng.permutation(M * TOPK)[:masked]] = E
    x = rng.standard_normal((M, H)).astype(np.float32)
    return flat_e, x


# ------------------------------------------------------------------ routing

class TestRouting:
    def test_select_experts_matches_jax(self):
        """ids exact; weights within 1e-6 (softmax and the renormalizing
        sum in another order)."""
        logits = np.random.default_rng(0).standard_normal(
            (64, E)).astype(np.float32)
        jw, jid = jmu.select_experts(jnp.asarray(logits), TOPK + 1)
        tw, tid = tmu.select_experts(_t(logits), TOPK + 1)
        np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
        assert tid.dtype == torch.int32
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                                   atol=1e-7)

    def test_ties_keep_the_lower_expert_first(self):
        logits = np.zeros((3, E), np.float32)
        logits[1, [2, 5, 6]] = 1.0
        logits[2, 7] = 2.0
        _, jid = jmu.select_experts(jnp.asarray(logits), 3)
        _, tid = tmu.select_experts(_t(logits), 3)
        np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
        assert tid.numpy().tolist() == [[0, 1, 2], [2, 5, 6], [7, 0, 1]]

    @pytest.mark.parametrize("block_m", [1, 8, 64])
    def test_moe_align_block_size_matches_jax(self, block_m):
        ids = np.random.default_rng(block_m).integers(
            0, E, (M, TOPK)).astype(np.int32)
        ids[:5] = 3                                  # one heavy expert
        want = jmu.moe_align_block_size(jnp.asarray(ids), E, block_m)
        got = tmu.moe_align_block_size(_t(ids), E, block_m)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert tmu.aligned_capacity(M * TOPK, E, block_m) == \
            jmu.aligned_capacity(M * TOPK, E, block_m)

    def test_gather_and_scatter_combine_match_jax(self):
        rng = np.random.default_rng(3)
        ids = rng.integers(0, E, (M, TOPK)).astype(np.int32)
        x = rng.standard_normal((M, H)).astype(np.float32)
        w = rng.random((M, TOPK)).astype(np.float32)
        sti, _, _ = jmu.moe_align_block_size(jnp.asarray(ids), E, 8)
        g = tmu.gather_sorted(_t(x), _t(sti), TOPK)
        np.testing.assert_array_equal(
            g.numpy(), np.asarray(jmu.gather_sorted(jnp.asarray(x), sti,
                                                    TOPK)))
        y = rng.standard_normal((sti.shape[0], H)).astype(np.float32)
        np.testing.assert_allclose(
            tmu.scatter_combine(_t(y), _t(sti), _t(w), M).numpy(),
            np.asarray(jmu.scatter_combine(jnp.asarray(y), sti,
                                           jnp.asarray(w), M)),
            rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------- quantizers

class TestWireQuantizers:
    def test_fp8_cast_rounds_as_jax_on_the_bytes(self):
        """Round to nearest even on every value, near ±448 and among the
        subnormals too."""
        v = np.concatenate([
            np.array([0.0, -0.0, 447.0, 448.0, -448.0, 440.0, 436.0, 452.0,
                      -447.9, 2.0 ** -9, 2.0 ** -10, 3 * 2.0 ** -10,
                      1.0625, 1.1875, 0.00195], np.float32),
            np.random.default_rng(0).uniform(-448, 448, 4096).astype(
                np.float32)])
        want = np.asarray(jnp.asarray(v).astype(jnp.float8_e4m3fn)).view(
            np.uint8)
        got = _t(v).to(torch.float8_e4m3fn).view(torch.uint8).numpy()
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("quant", ["fp8", "int8"])
    def test_quantize_rows_bytes_match_jax(self, mesh1, quant):
        jc, tc = _contexts(mesh1, quant)
        x = np.random.default_rng(1).standard_normal((33, H)).astype(
            np.float32) * 3
        x[4] = 0.0                           # zero row: scale 1e-12/QMAX
        jq, js = jma.quantize_rows(jc, jnp.asarray(x))
        tq, ts = tma.quantize_rows(tc, _t(x))
        np.testing.assert_array_equal(_np(tq), _jbytes(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(
            tma.dequantize_rows(tc, tq, ts).numpy(),
            np.asarray(jma.dequantize_rows(jc, jq, js)))


# ----------------------------------------------------------------- transport

GEOMS = [("fp8", "float32", M * TOPK, None), ("int8", "float32", 40, None),
         (None, "float32", M * TOPK, None), (None, "bfloat16", 300, None),
         ("fp8", "float32", 4608, None), ("fp8", "float32", M * TOPK, 32)]


class TestTransportGeometry:
    @pytest.mark.parametrize("geom", GEOMS,
                             ids=lambda g: "-".join(map(str, g)))
    def test_geometry_matches_jax(self, mesh1, geom):
        quant, dtype, max_m, chunk_m = geom
        jc, tc = _contexts(mesh1, quant, dtype, max_m, chunk_m)
        for name in ("align", "chunk_rows", "n_chunks_max", "slot_pad",
                     "meta_rows", "m_cap", "_cnt_rows"):
            assert getattr(tmd, name)(tc) == getattr(jmd, name)(jc), name
        (tt, tdt), (tm, _) = tmd.ll_workspace_shapes(tc)
        (jt, jdt), (jm, _) = jmd.ll_workspace_shapes(jc)
        assert (tt, tm) == (jt, jm)
        assert str(tdt).replace("torch.", "") == jnp.dtype(jdt).name
        assert tc.wire_itemsize == jc.wire_dtype.itemsize
        assert tc.quant_max == jc.quant_max

    def test_bad_chunk_is_refused(self, mesh1):
        _, tc = _contexts(mesh1, "fp8", chunk_m=48)
        with pytest.raises(ValueError, match="multiple"):
            tmd.chunk_rows(tc)


def _staged(mesh, quant, seed=0, dtype="float32"):
    """The JAX and port staging of the same routed rows: every array on
    both sides, for the tests to compare."""
    jc, tc = _contexts(mesh, quant, dtype)
    flat_e, x = _routing(seed)
    order = np.argsort(flat_e, kind="stable").astype(np.int32)
    valid = flat_e < E
    n_valid = int(valid.sum())
    splits = np.bincount(flat_e[valid], minlength=E).astype(np.int32)
    out = {}
    for side, c, mod, arr in (("j", jc, jmd, jnp.asarray),
                              ("t", tc, tmd, _t)):
        spl = arr(splits)
        counts, offs, offs_al, sendk = mod.send_plan(c, spl)
        peer, dest = mod.assignment_dest(c, arr(flat_e[order]), offs,
                                         offs_al)
        payload, scales = mod.stage_aligned(
            c, arr(x).astype(getattr(jnp, dtype)) if side == "j"
            else arr(x).to(getattr(torch, dtype)),
            arr(order // TOPK), dest, n_valid)
        meta = mod.meta_payload(c, spl, scales, offs_al, sendk)
        out[side] = dict(ctx=c, counts=counts, offs=offs, offs_al=offs_al,
                         sendk=sendk, peer=peer, dest=dest, payload=payload,
                         scales=scales, meta=meta, splits=spl,
                         n_valid=n_valid)
    return out["j"], out["t"]


def _shard1(mesh, fn, *args):
    """Run a per-device JAX function on the one-device mesh."""
    spec = tuple(P() for _ in args)
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=spec,
                                 out_specs=P(), check_vma=False))(*args)


class TestStaging:
    @pytest.mark.parametrize("quant", ["fp8", "int8", None])
    def test_send_plan_stage_and_meta_match_jax(self, mesh1, quant):
        """Integers, payload bytes, scales and the metadata block with
        its checksum: all exact."""
        j, t = _staged(mesh1, quant)
        for name in ("counts", "offs", "offs_al", "sendk", "peer", "dest",
                     "meta"):
            assert t[name].dtype == torch.int32, name
            np.testing.assert_array_equal(t[name].numpy(),
                                          np.asarray(j[name]), name)
        np.testing.assert_array_equal(_np(t["payload"]),
                                      _jbytes(j["payload"]))
        if quant is None:
            assert t["scales"] is None and j["scales"] is None
        else:
            np.testing.assert_array_equal(t["scales"].numpy(),
                                          np.asarray(j["scales"]))
        np.testing.assert_array_equal(
            tmd.wire_rows(t["ctx"], t["splits"]).numpy(),
            np.asarray(jmd.wire_rows(j["ctx"], j["splits"])))

    def test_checksum_wraps_as_uint32(self):
        """Large words, where the 32-bit products wrap."""
        head = np.random.default_rng(2).integers(
            -2 ** 31, 2 ** 31 - 1, (3, 70), dtype=np.int64).astype(np.int32)
        np.testing.assert_array_equal(
            tmd._head_checksum(_t(head)).numpy(),
            np.asarray(jmd._head_checksum(jnp.asarray(head))))

    @pytest.mark.parametrize("quant", ["fp8", None])
    def test_recv_and_combine_views_match_jax(self, mesh1, quant):
        """A window and a combine window made of the staged rows: the
        dequantized rows, the clamped counts and the combined rows in
        sorted order are equal."""
        j, t = _staged(mesh1, quant)
        sp = jmd.slot_pad(j["ctx"])
        rows = _jbytes(j["payload"])[:sp]
        tok_t = _t(rows)
        if quant == "fp8":
            tok_t = tok_t.view(torch.float8_e4m3fn)
        tok_j = jnp.asarray(np.asarray(j["payload"])[:sp])
        meta_np = np.asarray(j["meta"]).reshape(-1, 128)
        jt, js = jmd.recv_view(j["ctx"], tok_j, jnp.asarray(meta_np))
        tt, ts = tmd.recv_view(t["ctx"], tok_t, _t(meta_np))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        y = np.random.default_rng(4).standard_normal((1, sp, H)).astype(
            np.float32)
        jy, jym = jmd.stage_return(j["ctx"], jnp.asarray(y))
        ty, tym = tmd.stage_return(t["ctx"], _t(y))
        np.testing.assert_array_equal(_np(ty), _jbytes(jy))
        np.testing.assert_array_equal(tym.numpy(), np.asarray(jym))
        jv = jmd.combine_view(j["ctx"], jy, jym.reshape(-1, 128), j["peer"],
                              j["dest"], j["offs_al"], j["n_valid"])
        tv = tmd.combine_view(t["ctx"], ty, tym.reshape(-1, 128), t["peer"],
                              t["dest"], t["offs_al"], t["n_valid"])
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _sentinel(shape_rows, row_bytes, seed):
    return np.random.default_rng(seed).integers(
        0, 256, (shape_rows, row_bytes), dtype=np.uint8)


class TestChunkedA2A:
    @pytest.mark.parametrize("quant", ["fp8", None])
    def test_barrier_windows_match_jax(self, mesh1, quant):
        """Dispatch and combine in barrier mode: the shipped rows and
        the metadata block equal the JAX kernel's, byte for byte."""
        j, t = _staged(mesh1, quant)
        jc, tc = j["ctx"], t["ctx"]
        jtok, jmeta = _shard1(
            mesh1, functools.partial(jmd.dispatch_device, jc), j["payload"],
            j["offs_al"], j["sendk"], j["meta"])
        ttok, tmeta = tmd.dispatch_device(tc, t["payload"], t["offs_al"],
                                          t["sendk"], t["meta"])
        shipped = int(t["sendk"][0]) * tmd.chunk_rows(tc)
        np.testing.assert_array_equal(_np(ttok)[:shipped],
                                      _jbytes(jtok)[:shipped])
        np.testing.assert_array_equal(tmeta.numpy(), np.asarray(jmeta))
        # the combine leg: static slot offsets, the same chunk count back
        y = np.random.default_rng(5).standard_normal(
            (1, jmd.slot_pad(jc), H)).astype(np.float32)
        jy, jym = jmd.stage_return(jc, jnp.asarray(y))
        jctok, jcmeta = _shard1(
            mesh1, functools.partial(jmd.combine_device, jc), jy, jym,
            j["sendk"], j["sendk"])
        ctok, cmeta = tmd.combine_device(tc, _t(jy), _t(jym), t["sendk"],
                                         t["sendk"])
        np.testing.assert_array_equal(_np(ctok)[:shipped],
                                      _jbytes(jctok)[:shipped])
        np.testing.assert_array_equal(cmeta.numpy(), np.asarray(jcmeta))

    @pytest.mark.parametrize("quant", ["fp8", "int8", None])
    def test_workspace_windows_match_jax_over_three_calls(self, mesh1,
                                                          quant):
        """LL mode over workspaces pre-filled with random bytes, parity
        rolling 0, 1, 0 with a different routing each call: both whole
        workspaces, the untouched rows included, are equal after every
        call, and the plain version left every row past the shipped
        chunks as it was."""
        jc, tc = _contexts(mesh1, quant)
        (tshape, tdt), (mshape, _) = tmd.ll_workspace_shapes(tc)
        row_b = H * tc.wire_itemsize
        ws_b = _sentinel(tshape[0], row_b, 7)
        wsm = np.random.default_rng(8).integers(
            -2 ** 31, 2 ** 31 - 1, mshape, dtype=np.int64).astype(np.int32)
        jws = jax.lax.bitcast_convert_type(
            jnp.asarray(ws_b.reshape(tshape[0], H, tc.wire_itemsize)
                        if tc.wire_itemsize > 1 else ws_b),
            jc.wire_dtype)
        jwsm = jnp.asarray(wsm)
        tws = torch.from_numpy(ws_b.copy()).view(tdt)
        twsm = _t(wsm)
        for call, seed in enumerate((11, 12, 13)):
            j, t = _staged(mesh1, quant, seed)
            par = call % 2
            fn = functools.partial(jmd.dispatch_ll_device, jc,
                                   instance=900 + call)
            jws, jwsm = _shard1(mesh1, fn, j["payload"], j["offs_al"],
                                j["sendk"], j["meta"],
                                jnp.asarray([par], jnp.int32), jws, jwsm)
            before = tws.view(torch.uint8).clone()
            tmd.dispatch_ll_device(tc, t["payload"], t["offs_al"], t["sendk"],
                                   t["meta"], torch.tensor([par],
                                                           dtype=torch.int32),
                                   tws, twsm)
            np.testing.assert_array_equal(_np(tws).reshape(tshape[0], -1),
                                          _jbytes(jws).reshape(tshape[0], -1))
            np.testing.assert_array_equal(twsm.numpy(), np.asarray(jwsm))
            sp = tmd.slot_pad(tc)
            shipped = int(t["sendk"][0]) * tmd.chunk_rows(tc)
            changed = (tws.view(torch.uint8) != before).any(dim=1)
            rows = torch.arange(tshape[0])
            assert not changed[(rows < par * sp)
                               | (rows >= par * sp + shipped)].any()

    def test_transport_refuses_more_than_one_rank(self, mesh1):
        _, t = _staged(mesh1, "fp8")
        tc2 = tma.MoEAllToAllContext(n=2, max_m=M * TOPK, hidden=H,
                                     experts_per_rank=E // 2, quant="fp8")
        with pytest.raises(NotImplementedError, match="one rank"):
            tmd.dispatch_device(tc2, t["payload"], t["offs_al"].repeat(2),
                                t["sendk"].repeat(2),
                                t["meta"].repeat(2, 1, 1))


# --------------------------------------------------------- float grouped GEMM

class TestFloatGroupedMatmul:
    @pytest.mark.parametrize("e", [1, 3])
    def test_plain_matches_pallas_kernel_in_f32(self, e):
        """f32 sums in another order: 1e-5 relative."""
        rng = np.random.default_rng(30 + e)
        x = rng.standard_normal((24, 64)).astype(np.float32)
        w = (rng.standard_normal((e, 64, 48)) / 8).astype(np.float32)
        be = rng.integers(0, e, (3,)).astype(np.int32)
        want = jgg.grouped_matmul(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(be), block_m=8)
        got = tgg.grouped_matmul(_t(x), _t(w), _t(be))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)

    def test_bf16_in_and_out(self):
        """bf16 operands, f32 sums, bf16 out: equal up to one bf16
        rounding step of the output (2^-8 relative)."""
        rng = np.random.default_rng(40)
        x = rng.standard_normal((16, 32)).astype(np.float32)
        w = (rng.standard_normal((2, 32, 24)) / 6).astype(np.float32)
        be = np.array([1, 0], np.int32)
        want = jgg.grouped_matmul(jnp.asarray(x, jnp.bfloat16),
                                  jnp.asarray(w, jnp.bfloat16),
                                  jnp.asarray(be), block_m=8)
        got = tgg.grouped_matmul(_t(x).bfloat16(), _t(w).bfloat16(), _t(be))
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want).astype(np.float32),
                                   rtol=2 ** -8, atol=1e-6)

    def test_float_mode_checks_dtypes(self):
        x = torch.zeros((8, 4))
        with pytest.raises(ValueError, match="float mode"):
            tgg.grouped_matmul(x, torch.zeros((1, 4, 4), dtype=torch.int8),
                               torch.zeros((1,), dtype=torch.int32))
        with pytest.raises(ValueError, match="x_scale"):
            tgg.grouped_matmul(x, torch.zeros((1, 4, 4)),
                               torch.zeros((1,), dtype=torch.int32),
                               x_scale=torch.ones((8, 1)))

    def test_padded_splits_matches_jax(self):
        spl = np.array([3, 0, 17, 9], np.int32)
        np.testing.assert_array_equal(
            tgg.padded_splits(_t(spl), 8, 64).numpy(),
            np.asarray(jgg.padded_splits(jnp.asarray(spl), 8, 64)))


# -------------------------------------------------------------------- ep_moe

def _moe_inputs(seed, weights):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, H)).astype(np.float32)
    logits = rng.standard_normal((M, E)).astype(np.float32)
    up = (rng.standard_normal((E, H, FF)) / np.sqrt(H)).astype(np.float32)
    down = (rng.standard_normal((E, FF, H)) / np.sqrt(FF)).astype(np.float32)
    ju, jd = jnp.asarray(up), jnp.asarray(down)
    if weights != "float":
        ju, jd = ({"q": q, "scale": s} for q, s in (
            jgg.quantize_grouped_weights(w) for w in (ju, jd)))
    conv = (lambda w: {k: _t(v) for k, v in w.items()}
            if isinstance(w, dict) else _t(w))
    return x, logits, ju, jd, conv(ju), conv(jd)


#: max |port - JAX| / max|JAX| allowed per (wire, weights). Float and
#: W8A16 experts in f32 agree to the f32 summation order (1e-5). W8A8
#: re-quantizes the hidden activation per row after silu: a last-bit
#: difference in silu (another exp) can move one int8 code across a
#: rounding tie, which shifts that output by up to one code's share of
#: the down projection (about 1e-2 of the output's scale). An fp8 or int8
#: return wire rounds the expert outputs again, so the same last-bit
#: difference can move one wire code (2^-4 of a value for fp8, 1/127 of
#: the row's max for int8). Such a flip moves one token's row: besides
#: the max, at most 5 % of the elements (two tokens of 40) may differ by
#: more than 1e-5·max|ref|.
TOL = {("float", None): 1e-5, ("w8a16", None): 1e-5, ("w8a8", None): 1e-2,
       ("float", "fp8"): 7e-2, ("w8a16", "fp8"): 7e-2, ("w8a8", "fp8"): 7e-2,
       ("float", "int8"): 1e-2, ("w8a16", "int8"): 1e-2,
       ("w8a8", "int8"): 2e-2}


@pytest.mark.parametrize("mode", ["barrier", "workspace"])
@pytest.mark.parametrize("weights", ["w8a8", "w8a16", "float"])
@pytest.mark.parametrize("wire", [None, "fp8", "int8"])
def test_ep_moe_matches_jax(mesh1, wire, weights, mode):
    """``ops.ep_moe`` against JAX ``ops.ep_moe`` on the TPU's path (the
    fused transport, Pallas grouped GEMMs at block_m 64) in barrier mode,
    and over persistent workspaces for 3 calls with the parity rolling
    (the output of each call against JAX's call with the same parity)."""
    seed = 10 * ["float", "w8a16", "w8a8"].index(weights) + [
        None, "fp8", "int8"].index(wire)
    x, logits, ju, jd, tu, td = _moe_inputs(seed, weights)
    act = "int8" if weights == "w8a8" else None
    jctx = jops.create_ep_moe_context(
        mesh1, "tp", num_experts=E, topk=TOPK, max_m=M * TOPK, hidden=H,
        dtype=jnp.float32, transport="fused", use_pallas_gemm=True,
        block_m=64, quant=wire, act_quant=act)
    tctx = tops.create_ep_moe_context(
        num_experts=E, topk=TOPK, max_m=M * TOPK, hidden=H,
        dtype=torch.float32, block_m=64, quant=wire, act_quant=act)
    tol = TOL[(weights, wire)]
    calls = 1 if mode == "barrier" else 3
    jst = tst = None
    if mode == "workspace":
        jst = jops.create_ep_moe_state(jctx)
        tst = tops.create_ep_moe_state(tctx, "cpu")
    for call in range(calls):
        xs = x * (1.0 + 0.5 * call)
        if jst is None:
            want = jops.ep_moe(jnp.asarray(xs), jnp.asarray(logits), ju, jd,
                               jctx)
            got = tops.ep_moe(_t(xs), _t(logits), tu, td, tctx)
        else:
            want, jst = jops.ep_moe(jnp.asarray(xs), jnp.asarray(logits), ju,
                                    jd, jctx, state=jst)
            got, tst = tops.ep_moe(_t(xs), _t(logits), tu, td, tctx,
                                   state=tst)
            assert int(tst.parity[0]) == int(np.asarray(jst.parity)[0]) \
                == (call + 1) % 2
        want = np.asarray(want)
        assert got.dtype == torch.float32 and got.shape == want.shape
        diff = np.abs(got.numpy() - want) / np.abs(want).max()
        assert diff.max() <= tol, (call, diff.max())
        assert (diff > 1e-5).mean() <= 0.05, (call, (diff > 1e-5).mean())
    if tst is not None:
        # after the same three calls both windows' metadata heads
        # (counts, chunk counts, checksums) are equal in both workspaces;
        # the scale rows may differ in the last bit (JAX's jitted
        # division by QMAX is not always the eager one)
        a2a = tctx.a2a
        mr, cnt = tmd.meta_rows(a2a), tmd._cnt_rows(a2a)
        for name in ("disp_meta", "comb_meta"):
            np.testing.assert_array_equal(
                getattr(tst, name).numpy().reshape(2, mr, -1)[:, :cnt],
                np.asarray(getattr(jst, name)).reshape(2, mr, -1)[:, :cnt])


def test_ep_moe_context_validation():
    with pytest.raises(ValueError, match="act_quant"):
        tops.create_ep_moe_context(num_experts=E, topk=TOPK, max_m=8,
                                   hidden=H, act_quant="fp8")
    with pytest.raises(ValueError, match="int32s"):
        tops.create_ep_moe_context(num_experts=E, topk=TOPK, max_m=8,
                                   hidden=3, quant="fp8")
    ctx = tops.create_ep_moe_context(num_experts=E, topk=TOPK, max_m=8,
                                     hidden=H)
    # below M·topk the fused transport runs on the padded slots, as JAX's
    # does; its persistent workspaces cannot, and raise
    bf16 = torch.bfloat16
    args = (torch.zeros((5, H)), torch.zeros((5, E)),
            torch.zeros((E, H, 4), dtype=bf16),
            torch.zeros((E, 4, H), dtype=bf16), ctx)
    assert tops.ep_moe(*args).shape == (5, H)
    with pytest.raises(ValueError, match="capacity"):
        tops.ep_moe(*args, state=tops.create_ep_moe_state(ctx, "cpu"))
