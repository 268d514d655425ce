"""Parity of the PyTorch port's composed MoE-TP pipeline and padded-slot
EP transport with the JAX package.

The JAX side runs on a mesh of 4 (or 1) of the 8 virtual CPU devices
(``tests/conftest.py``): its composed MoE-TP (``align_routing``,
``ag_group_gemm``, ``moe_reduce_rs`` over the interpreted Pallas
reduce-scatter ring, ``moe_tp_mlp``, ``MoETPMLP``) with XLA's grouped
GEMM (``use_pallas_gemm=False``, the same f32 sums), and its EP MoE on
the ``pallas`` transport (the staging of ``kernels/moe_all_to_all.py``
and the interpreted ``_a2a_kernel``). The port's side runs on
``Mesh.loopback(4, "cpu")`` (or without a mesh), every kernel wrapper on
its plain PyTorch version because the tensors lie on the CPU. Inputs
are drawn with numpy from a seed: 64 tokens a rank, hidden 128, ffn 256
(64 a rank), 8 experts (2 a rank), top-2; one routing favours expert 0
and starves expert 3, a skewed one sends most assignments to rank 0's
experts.

* Integers are exact: ``align_routing``'s tables; ``dispatch_stage`` /
  ``pack_slots``' slot words (tokens, per-token scales, counts; against
  JAX's eager functions, rank by rank, quant None / fp8 / int8); the
  received counts after ``clamp_recv_splits`` and the rows the skewed
  routing drops at ``max_m``.
* Floats. f32 sums in another order: 1e-5 of the largest output. bf16:
  ``ag_group_gemm`` rounds each output once on both sides, one bf16 ulp
  elementwise (2^-7 relative; the f32 sums can straddle a rounding);
  ``moe_reduce_rs`` rounds each rank's partial and each hop of the ring
  on both sides (a last-bit difference of a partial can move a
  rounding), and the MLPs apply the activation in bf16 (JAX's silu
  rounds its sigmoid apart), so they are held at 2^-6 of the largest
  output (read: 0 on the reduce alone, 0.67 % on the
  MLPs; the composed and the fused modes 0.66 % apart). f32 read
  1e-7-4e-7. ``ep_moe`` on a quantized wire: JAX's jitted quantizer
  multiplies by the scale's reciprocal, so a code can move (the bound of
  tests/test_torch_moe_mesh.py: 7e-2 of the largest output, at most 5 %
  of the elements past 1e-5; read 0.80 % and 0.006 %).
* The fused → ``pallas`` demotion (``max_m < M·topk``) and its ValueError
  with an LL state; ``EPAll2AllLayer`` against JAX's; the refusals
  (a gradient, DP axes, the ``xla`` transport).

The CUDA kernels are held against the plain versions in
tests/test_torch_cuda.py.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from triton_distributed_tpu import ops as jops
from triton_distributed_tpu.kernels import moe_all_to_all as jma
from triton_distributed_tpu.kernels import moe_utils as jmu
from triton_distributed_tpu.layers import EPAll2AllLayer as JEPAll2AllLayer
from triton_distributed_tpu.layers import MoETPMLP as JMoETPMLP
from triton_distributed_tpu_torch import ops
from triton_distributed_tpu_torch.kernels import moe_all_to_all as tma
from triton_distributed_tpu_torch.kernels import moe_utils as tmu
from triton_distributed_tpu_torch.layers import EPAll2AllLayer, MoETPMLP
from triton_distributed_tpu_torch.runtime import Mesh

W = 4
#: 64 tokens a rank, hidden 128, ffn 256 (64 a rank), 8 experts (2 a
#: rank), top-2, routing blocks of 64 rows
MR, H, F, E, K, BM = 64, 128, 256, 8, 2, 64
M = W * MR
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
#: f32 sums in another order; bf16 through the rounded partials and hops
TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}


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
    """numpy (or JAX) → torch; bf16 through f32."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
        dtype = dtype or torch.bfloat16
    return torch.from_numpy(np.array(a, copy=True)).to(dtype)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a).astype(np.float32)


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _data(seed, skew=False):
    """x (M, H), router logits (expert 3 starved, expert 0 favoured by the
    first half of the tokens; ``skew``: experts 0 and 1, rank 0's, take
    most assignments), (E, H, F) / (E, F, H) weights."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, H)).astype(np.float32)
    logits = rng.standard_normal((M, E)).astype(np.float32)
    logits[:, 3] = -30.0
    logits[: M // 2, 0] += 4.0
    if skew:
        logits[:, :2] += 6.0
    w_up = (rng.standard_normal((E, H, F)) / np.sqrt(H)).astype(np.float32)
    w_down = (rng.standard_normal((E, F, H)) / np.sqrt(F)).astype(np.float32)
    return x, logits, w_up, w_down


def _routing(logits):
    jw, jids = jmu.select_experts(jnp.asarray(logits), K)
    tw, tids = tmu.select_experts(_t(logits), K)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    return (jw, jids), (tw, tids)


def _f_shards(w, dim, dtype):
    """W shards of an expert tensor over its F dim (views of one
    allocation)."""
    parts = np.split(np.asarray(w, np.float32), W, axis=dim)
    return list(torch.stack([_t(p, dtype) for p in parts]).unbind(0))


def _tp_contexts(dtype, tmesh):
    jdt, tdt = DTYPES[dtype]
    jctx = jops.create_moe_rs_context(
        _jmesh(), "tp", num_experts=E, topk=K, dtype=jdt, block_m=BM,
        use_pallas_gemm=False)
    tctx = ops.create_moe_rs_context(num_experts=E, topk=K, dtype=tdt,
                                     block_m=BM, mesh=tmesh)
    return jctx, tctx


# ---------------------------------------------------------- composed MoE-TP

class TestComposedMoETP:
    def test_align_routing_is_jax(self, tmesh):
        """One alignment over every token: sorted ids, block → expert and
        counts equal JAX's."""
        _, logits, _, _ = _data(1)
        (_, jids), (_, tids) = _routing(logits)
        jctx, tctx = _tp_contexts("float32", tmesh)
        for j, t in zip(jops.align_routing(jctx, jids),
                        ops.align_routing(tctx, tids)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))

    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    def test_ag_group_gemm_and_reduce_rs(self, tmesh, dtype):
        """``ag_group_gemm`` (every rank's sorted rows against its F
        columns) and ``moe_reduce_rs`` (each rank's combined partial
        through the reduce-scatter) against JAX's: f32 1e-5; bf16 the up
        projection one bf16 ulp elementwise (2^-7 relative), the reduce
        2^-6 of the largest output."""
        x, logits, w_up, w_down = _data(2)
        (jwts, jids), (twts, tids) = _routing(logits)
        jdt, tdt = DTYPES[dtype]
        jctx, tctx = _tp_contexts(dtype, tmesh)
        jr, tr = jops.align_routing(jctx, jids), ops.align_routing(tctx, tids)
        jy = jops.ag_group_gemm(jnp.asarray(x, jdt), jr,
                                jnp.asarray(w_up, jdt), jctx)
        ty = ops.ag_group_gemm(_t(x, tdt), tr, _f_shards(w_up, 2, tdt), tctx)
        assert len(ty) == W and ty[0].dtype == tdt
        got = np.concatenate([_np(s) for s in ty], axis=1)
        want = _np(jy)
        if dtype == "float32":
            assert _rel(got, want) <= 1e-5
        else:
            np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-6)
        # the reduce on the same post-activation rows
        h = jax.nn.silu(jy)
        jo = jops.moe_reduce_rs(h, jr, jwts, jnp.asarray(w_down, jdt), jctx)
        th = [_t(np.asarray(p), tdt) for p in
              np.split(np.asarray(h.astype(jnp.float32)), W, axis=1)]
        to = ops.moe_reduce_rs(th, tr, twts, _f_shards(w_down, 1, tdt), tctx)
        assert to.shape == (M, H) and to.dtype == tdt
        assert _rel(_np(to), _np(jo)) <= TOL[dtype]

    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    def test_moe_tp_mlp_and_layer(self, tmesh, dtype):
        """``moe_tp_mlp`` and ``MoETPMLP`` in both modes against JAX's:
        f32 1e-5, bf16 2^-6 of the largest output; the two modes agree
        with each other as closely."""
        x, logits, w_up, w_down = _data(3)
        (jwts, jids), (twts, tids) = _routing(logits)
        jdt, tdt = DTYPES[dtype]
        jctx, tctx = _tp_contexts(dtype, tmesh)
        jx, tx = jnp.asarray(x, jdt), _t(x, tdt)
        jp = {"up": jnp.asarray(w_up, jdt), "down": jnp.asarray(w_down, jdt)}
        tp = {"up": _f_shards(w_up, 2, tdt), "down": _f_shards(w_down, 1, tdt)}
        want = _np(jops.moe_tp_mlp(jx, jids, jwts, jp["up"], jp["down"], jctx))
        got = ops.moe_tp_mlp(tx, tids, twts, tp["up"], tp["down"], tctx)
        assert got.dtype == tdt and _rel(_np(got), want) <= TOL[dtype]
        outs = {}
        for fused in (True, False):
            jo = _np(JMoETPMLP(jctx, fused=fused)(jp, jx, jids, jwts))
            to = _np(MoETPMLP(tctx, fused=fused)(tp, tx, tids, twts))
            assert _rel(to, jo) <= TOL[dtype], fused
            outs[fused] = to
        assert _rel(outs[False], outs[True]) <= TOL[dtype]
        np.testing.assert_array_equal(outs[True], _np(got))

    def test_one_rank(self):
        """Without a mesh the composed MLP is one rank's (no reduce); it
        equals the 4-rank result in f32 within 1e-5 and JAX's on one
        device."""
        x, logits, w_up, w_down = _data(4)
        (jwts, jids), (twts, tids) = _routing(logits)
        jctx = jops.create_moe_rs_context(
            _jmesh(1), "tp", num_experts=E, topk=K, dtype=jnp.float32,
            block_m=BM, use_pallas_gemm=False)
        tctx = ops.create_moe_rs_context(num_experts=E, topk=K,
                                         dtype=torch.float32, block_m=BM)
        p = {"up": jnp.asarray(w_up), "down": jnp.asarray(w_down)}
        tp = {"up": _t(w_up), "down": _t(w_down)}
        for fused in (True, False):
            want = _np(JMoETPMLP(jctx, fused=fused)(p, jnp.asarray(x), jids,
                                                    jwts))
            got = _np(MoETPMLP(tctx, fused=fused)(tp, _t(x), tids, twts))
            assert _rel(got, want) <= 1e-5

    def test_refusals(self, tmesh):
        """A gradient (forward only), DP axes, XLA's grouped GEMM, and
        per-rank operands that are not the mesh's."""
        x, logits, w_up, w_down = _data(1)
        _, (twts, tids) = _routing(logits)
        _, tctx = _tp_contexts("float32", tmesh)
        tp = {"up": _f_shards(w_up, 2, torch.float32),
              "down": _f_shards(w_down, 1, torch.float32)}
        for fused in (True, False):
            with pytest.raises(NotImplementedError, match="step 9"):
                MoETPMLP(tctx, fused=fused)(
                    tp, _t(x).requires_grad_(), tids, twts)
        grad_w = {"up": [t.clone().requires_grad_() for t in tp["up"]],
                  "down": tp["down"]}
        with pytest.raises(NotImplementedError, match="step 9"):
            MoETPMLP(tctx)(grad_w, _t(x), tids, twts)
        with pytest.raises(NotImplementedError, match="step 8"):
            ops.MoETPContext(num_experts=E, topk=K, mesh=tmesh,
                             batch_axes=("dp",))
        with pytest.raises(NotImplementedError, match="ragged_dot"):
            ops.MoETPContext(num_experts=E, topk=K, use_pallas_gemm=False)
        with pytest.raises(ValueError, match="per-rank"):
            ops.ag_group_gemm(_t(x), ops.align_routing(tctx, tids),
                              tp["up"][:2], tctx)


# -------------------------------------------------- padded-slot transport

def _a2a_contexts(quant, max_m, n=W, dtype="float32"):
    jdt, tdt = DTYPES[dtype]
    jctx = jma.create_all_to_all_context(
        _jmesh(n), "tp", max_m=max_m, hidden=H, experts_per_rank=E // n,
        dtype=jdt, quant=quant)
    tctx = tma.create_all_to_all_context(
        Mesh.loopback(n, "cpu") if n > 1 else None, "tp", max_m=max_m,
        hidden=H, experts_per_rank=E // n, dtype=tdt, quant=quant)
    return jctx, tctx


def _sorted_rows(x, ids):
    """Each rank's assignments in expert order: (W, MR·K, H) rows and
    (W, E) counts (numpy), as ``ep_moe`` stages them."""
    rows, splits = [], []
    for r in range(W):
        e = ids[r * MR:(r + 1) * MR].reshape(-1)
        order = np.argsort(e, kind="stable")
        rows.append(x[r * MR:(r + 1) * MR][order // K])
        splits.append(np.bincount(e, minlength=E).astype(np.int32))
    return np.stack(rows), np.stack(splits)


class TestPaddedSlots:
    def test_geometry_is_jax(self):
        """``slot_rows``, ``ints_per_row``, ``scale_rows``, ``splits_rows``
        equal JAX's, and a row that is no whole number of int32 words is
        refused on both sides."""
        for quant in (None, "fp8", "int8"):
            for max_m in (1, 40, 128, 300):
                j, t = _a2a_contexts(quant, max_m)
                for k in ("slot_rows", "ints_per_row", "scale_rows",
                          "splits_rows"):
                    assert getattr(t, k) == getattr(j, k), (quant, max_m, k)
        with pytest.raises(AssertionError):
            jma.create_all_to_all_context(_jmesh(), "tp", max_m=8, hidden=6,
                                          experts_per_rank=2, quant="fp8")
        with pytest.raises(ValueError, match="int32"):
            tma.create_all_to_all_context(None, max_m=8, hidden=6,
                                          experts_per_rank=2, quant="fp8")

    @pytest.mark.parametrize("skew", [False, True])
    @pytest.mark.parametrize("quant", [None, "fp8", "int8"])
    def test_slot_words_are_jax(self, quant, skew):
        """``dispatch_stage`` → ``pack_slots`` of every rank's sorted rows
        equals JAX's eager functions word for word (at ``max_m`` 40 the
        skewed routing overflows rank 0's slot), and the exchanged
        payload's ``recv_tokens_view`` gives JAX's tokens and clamped
        counts; ``combine_stage`` → ``combine_unpack`` →
        ``combine_unstage`` returns JAX's rows, zeros for the dropped."""
        x, logits, _, _ = _data(5, skew=skew)
        ids = np.asarray(jmu.select_experts(jnp.asarray(logits), K)[1])
        rows, splits = _sorted_rows(x, ids)
        max_m = 40 if skew else MR * K
        jctx, tctx = _a2a_contexts(quant, max_m)
        t_toks, t_spl = tma.dispatch_stage(tctx, _t(rows), _t(splits))
        t_send = tma.pack_slots(tctx, t_toks, t_spl)
        assert t_send.dtype == torch.int32 and t_send.shape == (
            W, W * tctx.slot_rows, tctx.ints_per_row)
        j_send = []
        for r in range(W):
            jt, js = jma.dispatch_stage(jctx, jnp.asarray(rows[r]),
                                        jnp.asarray(splits[r]))
            np.testing.assert_array_equal(t_spl[r].numpy(), np.asarray(js))
            j_send.append(np.asarray(jma.pack_slots(jctx, jt, js)))
            np.testing.assert_array_equal(t_send[r].numpy(), j_send[-1])
        if skew:
            assert splits[0].reshape(W, -1).sum(1).max() > max_m
        # the exchange, then each side's receive view
        t_recv = tma.fast_all_to_all(tctx, t_send)
        j_recv = np.stack(j_send).reshape(W, W, -1, tctx.ints_per_row)
        j_recv = j_recv.transpose(1, 0, 2, 3).reshape(t_recv.shape)
        np.testing.assert_array_equal(t_recv.numpy(), j_recv)
        t_tok, t_rspl = tma.recv_tokens_view(tctx, t_recv)
        for r in range(W):
            jt, jspl = jma.recv_tokens_view(jctx, jnp.asarray(j_recv[r]))
            np.testing.assert_array_equal(t_rspl[r].numpy(), np.asarray(jspl))
            np.testing.assert_array_equal(_np(t_tok[r]), _np(jt))
        # the return leg, the received rows sent back as they are
        t_back = tma.combine_unstage(
            tctx, tma.combine_unpack(tctx, tma.fast_all_to_all(
                tctx, tma.combine_stage(tctx, t_tok))), _t(splits), MR * K)
        t_comb = tma.fast_all_to_all(tctx, tma.combine_stage(tctx, t_tok))
        for r in range(W):
            jb = jma.combine_unstage(
                jctx, jma.combine_unpack(jctx, jnp.asarray(t_comb[r].numpy())),
                jnp.asarray(splits[r]), MR * K)
            np.testing.assert_array_equal(_np(t_back[r]), _np(jb))
        if quant is None:
            kept = t_back.abs().sum(-1) > 0
            np.testing.assert_array_equal(_np(t_back)[kept.numpy()],
                                          rows[kept.numpy()])
            if skew:
                assert not bool(kept.all())

    def test_combine_unstage_is_jax(self):
        """``combine_unstage`` of the same slots and counts equals JAX's,
        the tokens past a peer's ``max_m`` zero."""
        x, logits, _, _ = _data(5, skew=True)
        ids = np.asarray(jmu.select_experts(jnp.asarray(logits), K)[1])
        _, splits = _sorted_rows(x, ids)
        jctx, tctx = _a2a_contexts(None, 40)
        slots = np.random.default_rng(6).standard_normal(
            (W, W, 40, H)).astype(np.float32)
        got = tma.combine_unstage(tctx, _t(slots), _t(splits), MR * K)
        for r in range(W):
            want = jma.combine_unstage(jctx, jnp.asarray(slots[r]),
                                       jnp.asarray(splits[r]), MR * K)
            np.testing.assert_array_equal(got[r].numpy(), np.asarray(want))
        assert bool((got[0] == 0).all(-1).any())


def _ep_contexts(quant, max_m, transport, n=W):
    kw = dict(num_experts=E, topk=K, max_m=max_m, hidden=H, block_m=BM,
              quant=quant, transport=transport)
    jctx = jops.create_ep_moe_context(_jmesh(n), "tp", dtype=jnp.float32,
                                      use_pallas_gemm=False, **kw)
    tctx = ops.create_ep_moe_context(
        dtype=torch.float32, mesh=Mesh.loopback(n, "cpu") if n > 1 else None,
        **kw)
    return jctx, tctx


def _ep_close(got, want, quant):
    want = np.asarray(want)
    if quant is None:
        assert _rel(got.numpy(), want) <= 1e-5
        return
    diff = np.abs(got.numpy() - want) / np.abs(want).max()
    assert diff.max() <= 7e-2 and (diff > 1e-5).mean() <= 0.05


class TestEPPallas:
    @pytest.mark.parametrize("n", [W, 1])
    @pytest.mark.parametrize("quant", [None, "fp8", "int8"])
    def test_ep_moe_matches_jax(self, n, quant):
        """``ep_moe`` on the padded slots at full capacity against JAX's
        (its interpreted ``_a2a_kernel`` at n = 4, none at n = 1), and
        equal to the port's fused transport (the same rows meet the same
        experts)."""
        x, logits, w_up, w_down = _data(7)
        jctx, tctx = _ep_contexts(quant, (M // n) * K, "pallas", n)
        want = jops.ep_moe(jnp.asarray(x), jnp.asarray(logits),
                           jnp.asarray(w_up), jnp.asarray(w_down), jctx)
        got = ops.ep_moe(_t(x), _t(logits), _t(w_up), _t(w_down), tctx)
        _ep_close(got, want, quant)
        _, fused = _ep_contexts(quant, (M // n) * K, "fused", n)
        assert torch.equal(got, ops.ep_moe(_t(x), _t(logits), _t(w_up),
                                           _t(w_down), fused))

    def test_overflow_drops_what_jax_drops(self):
        """A skewed routing past ``max_m`` 40 a peer: the port drops the
        same assignments as JAX (the same output rows, f32 1e-5), and the
        dropped tokens change the result."""
        x, logits, w_up, w_down = _data(8, skew=True)
        jctx, tctx = _ep_contexts(None, 40, "pallas")
        want = jops.ep_moe(jnp.asarray(x), jnp.asarray(logits),
                           jnp.asarray(w_up), jnp.asarray(w_down), jctx)
        got = ops.ep_moe(_t(x), _t(logits), _t(w_up), _t(w_down), tctx)
        _ep_close(got, want, None)
        _, full = _ep_contexts(None, MR * K, "pallas")
        assert _rel(got.numpy(), ops.ep_moe(_t(x), _t(logits), _t(w_up),
                                            _t(w_down), full).numpy()) > 0.1

    def test_fused_demotes_to_pallas(self, caplog):
        """The fused transport with ``max_m`` below M·topk runs on the
        padded slots (with one warning), as JAX's does: its output equals
        the port's ``pallas`` context's and JAX's demoted run; with an LL
        state it raises on both sides."""
        x, logits, w_up, w_down = _data(8, skew=True)
        jctx, tctx = _ep_contexts(None, 40, "fused")
        want = jops.ep_moe(jnp.asarray(x), jnp.asarray(logits),
                           jnp.asarray(w_up), jnp.asarray(w_down), jctx)
        with caplog.at_level("WARNING"):
            got = ops.ep_moe(_t(x), _t(logits), _t(w_up), _t(w_down), tctx)
        _ep_close(got, want, None)
        _, pal = _ep_contexts(None, 40, "pallas")
        assert torch.equal(got, ops.ep_moe(_t(x), _t(logits), _t(w_up),
                                           _t(w_down), pal))
        st = ops.create_ep_moe_state(tctx)
        with pytest.raises(ValueError, match="full-assignment capacity"):
            ops.ep_moe(_t(x), _t(logits), _t(w_up), _t(w_down), tctx,
                       state=st)
        with pytest.raises(ValueError, match="full-assignment capacity"):
            jops.ep_moe(jnp.asarray(x), jnp.asarray(logits),
                        jnp.asarray(w_up), jnp.asarray(w_down), jctx,
                        state=jops.create_ep_moe_state(jctx))
        with pytest.raises(ValueError, match="fused transport"):
            ops.create_ep_moe_state(pal)
        with pytest.raises(NotImplementedError, match="step 3"):
            _ep_contexts(None, 40, "xla")

    def test_ep_all2all_layer_is_jax(self):
        """``EPAll2AllLayer`` dispatch → the identity → combine, against
        JAX's layer inside a shard_map: the received tokens and counts
        equal, and the combine returns each rank's sorted rows byte for
        byte (no overflow, no wire quantization)."""
        x, logits, _, _ = _data(9)
        ids = np.asarray(jmu.select_experts(jnp.asarray(logits), K)[1])
        rows, splits = _sorted_rows(x, ids)
        jctx, tctx = _a2a_contexts(None, MR * K)
        jl, tl = JEPAll2AllLayer(jctx), EPAll2AllLayer(tctx)

        def body(r, s):
            tok, spl = jl.dispatch(r, s)
            return tok, spl, jl.combine(tok, s, MR * K)

        jtok, jspl, jback = jax.jit(jax.shard_map(
            body, mesh=_jmesh(), in_specs=(P("tp"), P("tp")),
            out_specs=(P("tp"), P("tp"), P("tp")), check_vma=False))(
            jnp.asarray(rows.reshape(-1, H)), jnp.asarray(splits.reshape(-1)))
        ttok, tspl = tl.dispatch(_t(rows), _t(splits))
        np.testing.assert_array_equal(
            ttok.numpy(), np.asarray(jtok).reshape(ttok.shape))
        np.testing.assert_array_equal(
            tspl.numpy(), np.asarray(jspl).reshape(tspl.shape))
        back = tl.combine(ttok, _t(splits), MR * K)
        np.testing.assert_array_equal(back.numpy(), rows)
        np.testing.assert_array_equal(np.asarray(jback).reshape(rows.shape),
                                      rows)
