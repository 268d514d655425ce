"""Parity of the PyTorch port's MoE over a mesh with the JAX package.

The JAX side runs on a mesh of 4 of the 8 virtual CPU devices
(``tests/conftest.py``), its Pallas kernels in interpret mode (the fused
EP transport pinned where the decode needs it by
``_torch_moe_ref.tpu_moe_ctx``); the port's side on ``Mesh.loopback(4,
"cpu")``, where every kernel wrapper runs its plain PyTorch version
because the tensors lie on the CPU. The same inputs, drawn with numpy
from a seed, go through both: the per-shard MoE-TP routing and the two
MoE-TP engines with the whole overlapped MLP, the chunked all-to-all at
n = 4 (both legs, barrier and workspace mode, fp8 and int8 wires, one
skewed routing), ``ep_moe`` and ``EPMoEMLP`` with float and int8
experts, the expert shards of ``params_from_numpy(mesh=)``, and
``prefill`` + ``generate`` of the tiny DeepSeek-MoE preset in its EP
and TP flavours at tp = 4, against JAX's 4-device model and the port
at tp = 1. The CUDA kernels are held against the plain versions in
tests/test_torch_cuda.py.

Tolerances: f32 sums in another order, 1e-5 (relative to the largest
output where values cross zero). In bf16 the up projection rounds each
output once on both sides (2^-8 relative); the reduce-scatter's TPU ring
rounds every partial product and running sum to bf16, where the port
sums in f32 and rounds once, so the two differ by at most 2^-8 of each
partial, each running sum and the result. Integers (routing tables,
wire bytes, metadata, token streams) are exact; the quantized models'
tokens are compared where the reference's top-2 margin exceeds 1e-2, as
tests/test_models.py gates them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from triton_distributed_tpu import ops as jops
from triton_distributed_tpu.kernels import moe_all_to_all as jma
from triton_distributed_tpu.kernels import moe_dispatch as jmd
from triton_distributed_tpu.kernels import moe_utils as jmu
from triton_distributed_tpu.kernels.group_gemm import (
    quantize_grouped_weights as j_quantize_grouped_weights,
)
from triton_distributed_tpu.layers import EPMoEMLP as JEPMoEMLP
from triton_distributed_tpu.models import Transformer as JTransformer
from triton_distributed_tpu.models import presets as jpresets
from triton_distributed_tpu_torch import ops
from triton_distributed_tpu_torch.kernels import moe_all_to_all as tma
from triton_distributed_tpu_torch.kernels import moe_dispatch as tmd
from triton_distributed_tpu_torch.kernels import moe_utils as tmu
from triton_distributed_tpu_torch.kernels.group_gemm import (
    dequantize_grouped_weights,
)
from triton_distributed_tpu_torch.layers import EPMoEMLP
from triton_distributed_tpu_torch.models import (
    Transformer,
    params_from_numpy,
    presets,
)
from triton_distributed_tpu_torch.runtime import Mesh

W = 4
#: 64 tokens (16 a rank), hidden 128, ffn 256 (64 a rank), 8 experts
#: (2 a rank), top-2
M, H, F, E, K = 64, 128, 256, 8, 2
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


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


def _t(a, dtype=None):
    """numpy (or JAX) → torch; bf16 through f32, fp8 through its bytes."""
    a = np.asarray(a)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
        dtype = dtype or torch.bfloat16
    return torch.from_numpy(np.array(a, copy=True)).to(dtype)


def _bytes(a):
    """A torch or JAX array's bytes (fp8 as uint8), as numpy."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.float8_e4m3fn:
            return a.view(torch.uint8).numpy()
        return a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    if a.dtype.name == "float8_e4m3fn":
        return a.view(np.uint8)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _cols(shards):
    """Per-rank column shards put back side by side."""
    return np.concatenate([_bytes(s).astype(np.float32) for s in shards],
                          axis=1)


def _moe_data(seed):
    """x (M, H), router logits with expert 3 starved and expert 0
    favoured by the first half of the tokens, (E, H, F) / (E, F, H)
    weights."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, H)).astype(np.float32)
    logits = rng.standard_normal((M, E)).astype(np.float32)
    logits[:, 3] = -30.0
    logits[: M // 2, 0] += 4.0
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
    allocation, as ``shard_params`` makes them)."""
    parts = np.split(np.asarray(w, np.float32), W, axis=dim)
    return list(torch.stack([_t(p, dtype) for p in parts]).unbind(0))


def _tp_contexts(jmesh, tmesh, dtype):
    """Both sides' MoE-TP contexts at block_m 64 (the CUDA kernels' tile;
    half the interpreted rows of JAX's default 128)."""
    jdt, tdt = DTYPES[dtype]
    jctx = jops.create_ag_group_gemm_context(jmesh, "tp", num_experts=E,
                                             topk=K, dtype=jdt, block_m=64)
    tctx = ops.create_ag_group_gemm_context(num_experts=E, topk=K,
                                            dtype=tdt, mesh=tmesh,
                                            block_m=64)
    return jctx, tctx


def _rs_bound(y, w, be, cap_s):
    """The bf16 bound of the reduce-scatter: 2^-8 of every rank's partial
    product, of every running sum and of the result, rank r's rows."""
    y, w = np.asarray(y, np.float32), np.asarray(w, np.float32)
    fl = F // W
    out = []
    for r in range(W):
        rows = y[r * cap_s:(r + 1) * cap_s]
        e = np.repeat(np.asarray(be[r]), cap_s // be.shape[1])
        parts = np.stack([
            np.einsum("if,ifh->ih", rows[:, q * fl:(q + 1) * fl],
                      w[e][:, q * fl:(q + 1) * fl]) for q in range(W)])
        sums = np.cumsum(parts, axis=0)
        out.append(2.0 ** -8 * (np.abs(parts).sum(0) + np.abs(sums).sum(0)
                                + np.abs(sums[-1])))
    return out


# ------------------------------------------------------------------ MoE-TP

class TestMoETPMesh:
    def test_align_routing_sharded_equals_jax(self, jmesh, tmesh):
        """Each shard's tables (tp, cap_s) equal JAX's integer for
        integer; the starved expert counts 0 in every shard."""
        _, logits, _, _ = _moe_data(0)
        (_, jids), (_, tids) = _routing(logits)
        jctx, tctx = _tp_contexts(jmesh, tmesh, "float32")
        jr = jops.align_routing_sharded(jctx, jids)
        tr = ops.align_routing_sharded(tctx, tids)
        assert tr.cap_s == jr.cap_s and tr.sti.shape[0] == W
        for name in ("sti", "be", "splits"):
            np.testing.assert_array_equal(getattr(tr, name).numpy(),
                                          np.asarray(getattr(jr, name)))
        assert int(tr.splits[:, 3].sum()) == 0

    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    def test_ag_group_gemm_fused_matches_jax(self, jmesh, tmesh, dtype):
        """Every shard's sorted rows against each rank's F columns (JAX's
        ``ag_group_gemm_kernel`` over its ring, interpreted); the padding
        rows exactly zero on both sides."""
        x, logits, w_up, _ = _moe_data(1)
        (_, jids), (_, tids) = _routing(logits)
        jctx, tctx = _tp_contexts(jmesh, tmesh, dtype)
        jdt, tdt = DTYPES[dtype]
        jr = jops.align_routing_sharded(jctx, jids)
        tr = ops.align_routing_sharded(tctx, tids)
        want = np.asarray(jops.ag_group_gemm_fused(
            jnp.asarray(x, jdt), jr, jnp.asarray(w_up, jdt), jctx),
            np.float32)
        got = ops.ag_group_gemm_fused(_t(x, tdt), tr,
                                      _f_shards(w_up, 2, tdt), tctx)
        assert len(got) == W and got[0].dtype == tdt
        got = _cols(got)
        assert got.shape == want.shape == (W * tr.cap_s, F)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_allclose(got, want, rtol=2.0 ** -7,
                                       atol=1e-6)
        pad = (tr.sti >= (M // W) * K).numpy().reshape(-1)
        assert pad.any() and (got[pad] == 0).all() and (want[pad] == 0).all()

    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    def test_moe_reduce_rs_fused_matches_jax(self, jmesh, tmesh, dtype):
        """Each rank's rows summed over the ranks' F shards, then its
        top-k combine (JAX's ``moe_reduce_rs_kernel`` over its reduce
        ring, interpreted). f32: 1e-5 of the largest output; bf16: the
        per-hop rounding bound of the module docstring, carried through
        the combine's weights."""
        _, logits, _, w_down = _moe_data(2)
        (jw, jids), (tw, tids) = _routing(logits)
        jctx, tctx = _tp_contexts(jmesh, tmesh, dtype)
        jdt, tdt = DTYPES[dtype]
        jr = jops.align_routing_sharded(jctx, jids)
        tr = ops.align_routing_sharded(tctx, tids)
        cap_s = tr.cap_s
        y = np.random.default_rng(3).standard_normal(
            (W * cap_s, F)).astype(np.float32)
        y[(tr.sti >= (M // W) * K).numpy().reshape(-1)] = 0.0
        y = np.asarray(jnp.asarray(y, jdt), np.float32)
        want = np.asarray(jops.moe_reduce_rs_fused(
            jnp.asarray(y, jdt), jr, jw, jnp.asarray(w_down, jdt), jctx),
            np.float32)
        got = ops.moe_reduce_rs_fused(_f_shards(y, 1, tdt), tr, tw,
                                      _f_shards(w_down, 1, tdt), tctx)
        assert got.dtype == tdt and tuple(got.shape) == (M, H)
        got = _bytes(got)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())
            return
        wdn = np.asarray(jnp.asarray(w_down, jdt), np.float32)
        bound = _rs_bound(y, wdn, tr.be.numpy(), cap_s)
        # through the combine: each token sums its top-k rows, weighted
        tol = np.zeros((M, H), np.float32)
        sti, wts = tr.sti.numpy(), tw.numpy()
        ms = M // W
        for r in range(W):
            for i, s in enumerate(sti[r]):
                if s < ms * K:
                    tol[r * ms + s // K] += wts[r * ms + s // K, s % K] * \
                        bound[r][i]
        tol += 2.0 ** -8 * np.abs(want)       # the combine's own rounding
        assert (np.abs(got - want) <= tol + 1e-6).all()

    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    def test_moe_tp_mlp_overlapped_matches_jax(self, jmesh, tmesh, dtype):
        """The whole overlapped MLP over the mesh. f32: 1e-5 of the
        largest output. bf16: the hidden activation is rounded on each
        side before the down projection, and the reduce rounds per hop
        in JAX: 2^-5 of the largest output."""
        x, logits, w_up, w_down = _moe_data(4)
        (jw, jids), (tw, tids) = _routing(logits)
        jctx, tctx = _tp_contexts(jmesh, tmesh, dtype)
        jdt, tdt = DTYPES[dtype]
        want = np.asarray(jops.moe_tp_mlp_overlapped(
            jnp.asarray(x, jdt), jids, jw, jnp.asarray(w_up, jdt),
            jnp.asarray(w_down, jdt), jctx), np.float32)
        got = _bytes(ops.moe_tp_mlp_overlapped(
            _t(x, tdt), tids, tw, _f_shards(w_up, 2, tdt),
            _f_shards(w_down, 1, tdt), tctx))
        tol = 1e-5 if dtype == "float32" else 2.0 ** -5
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=tol * np.abs(want).max())

    def test_training_block_still_raises(self, tmesh):
        """The differentiable MoE-TP block (``MoETPMLP``) comes with
        training."""
        cfg = presets.tiny(presets.deepseek_moe_16b(
            moe="tp", moe_weight_quant=None, moe_act_quant=None))
        tm = Transformer(cfg, mesh=tmesh)
        params = tm.shard_params(tm.init(torch.Generator().manual_seed(0)))
        with pytest.raises(NotImplementedError, match="training"):
            tm._mlp_block(params["blocks"][1], torch.zeros((8, cfg.hidden)))


# --------------------------------------------------------- the all-to-all

def _a2a_contexts(jmesh, tmesh, quant):
    j = jma.create_all_to_all_context(
        jmesh, "tp", max_m=(M // W) * K, hidden=H, experts_per_rank=E // W,
        dtype=jnp.float32, quant=quant)
    t = tma.MoEAllToAllContext(
        n=W, max_m=(M // W) * K, hidden=H, experts_per_rank=E // W,
        dtype=torch.float32, quant=quant, mesh=tmesh)
    return j, t


def _a2a_staged(jc, tc, seed, skew):
    """Every rank's routed rows staged on both sides: JAX rank by rank
    (its per-device functions, eagerly), the port for all ranks at once.
    With ``skew`` rank 0 routes every assignment to expert 0, so it
    ships nothing to the other ranks. The staging must agree exactly."""
    rng = np.random.default_rng(seed)
    t_a = (M // W) * K
    flat_e = rng.integers(0, E, (W, t_a)).astype(np.int32)
    flat_e[:, ::7] = E                          # masked assignments
    if skew:
        flat_e[0] = 0
    x = rng.standard_normal((W, M // W, H)).astype(np.float32)
    order = np.argsort(flat_e, axis=1, kind="stable").astype(np.int32)
    valid = flat_e < E
    splits = np.stack([np.bincount(f[v], minlength=E) for f, v in
                       zip(flat_e, valid)]).astype(np.int32)
    jside = []
    for r in range(W):
        spl = jnp.asarray(splits[r])
        _, offs, offs_al, sendk = jmd.send_plan(jc, spl)
        _, dest = jmd.assignment_dest(
            jc, jnp.asarray(np.take_along_axis(flat_e[r], order[r], 0)),
            offs, offs_al)
        payload, scales = jmd.stage_aligned(
            jc, jnp.asarray(x[r]), jnp.asarray(order[r] // K), dest,
            int(valid[r].sum()))
        meta = jmd.meta_payload(jc, spl, scales, offs_al, sendk)
        jside.append(dict(payload=payload, meta=meta, offs_al=offs_al,
                          sendk=sendk))
    spl = _t(splits)
    _, offs, offs_al, sendk = tmd.send_plan(tc, spl)
    fe = _t(flat_e)
    o = torch.argsort(fe, dim=1, stable=True)
    _, dest = tmd.assignment_dest(tc, fe.gather(1, o), offs, offs_al)
    payload, scales = tmd.stage_aligned(tc, _t(x), o // K, dest,
                                        _t(valid.sum(1).astype(np.int32)))
    meta = tmd.meta_payload(tc, spl, scales, offs_al, sendk)
    tside = dict(payload=payload, meta=meta, offs_al=offs_al, sendk=sendk)
    for name in ("payload", "meta", "offs_al", "sendk"):
        want = np.stack([_bytes(j[name]) for j in jside])
        np.testing.assert_array_equal(_bytes(tside[name]), want, name)
    return jside, tside


def _jstack(jside, name):
    """Every rank's JAX array of ``name``, concatenated on dim 0."""
    return jnp.concatenate([j[name] for j in jside])


def _on_mesh(jmesh, fn, *args):
    """Run a per-device JAX function over the 4-device mesh, every
    argument and result split over the ranks on dim 0."""
    spec = tuple(P("tp") for _ in args)
    return jax.jit(jax.shard_map(fn, mesh=jmesh, in_specs=spec,
                                 out_specs=P("tp"), check_vma=False))(*args)


def _shipped_rows(tc, counts):
    """(W, n·slot_pad) mask of the window rows each receiver's slots
    were shipped (``counts[r, p]`` chunks in slot p of receiver r)."""
    sp, ck = tmd.slot_pad(tc), tmd.chunk_rows(tc)
    pos = np.arange(sp)
    return np.stack([np.concatenate([pos < counts[r, p] * ck
                                     for p in range(W)])
                     for r in range(W)])


class TestChunkedA2AMesh:
    @pytest.mark.parametrize("case", [("fp8", False), ("int8", True)],
                             ids=["fp8", "int8-skewed"])
    def test_both_legs_match_jax(self, jmesh, tmesh, case):
        """Barrier mode: the dispatch (counts from the landed metadata)
        and the combine (counts known, ``recvk``) at n = 4 against JAX's
        ``_chunked_a2a_kernel`` (interpreted): every receiver's shipped
        rows and its metadata blocks equal byte for byte."""
        quant, skew = case
        jc, tc = _a2a_contexts(jmesh, tmesh, quant)
        jside, t = _a2a_staged(jc, tc, 5, skew)
        sendk = t["sendk"].numpy()
        jtok, jmeta = _on_mesh(
            jmesh, functools.partial(jmd.dispatch_device, jc),
            _jstack(jside, "payload"), _jstack(jside, "offs_al"),
            _jstack(jside, "sendk"), _jstack(jside, "meta"))
        ttok, tmeta = tmd.dispatch_device(tc, t["payload"], t["offs_al"],
                                          t["sendk"], t["meta"])
        sp, mr = tmd.slot_pad(tc), tmd.meta_rows(tc)
        rows = _shipped_rows(tc, sendk.T)          # slot p: p's count for r
        if skew:
            assert not rows[1, :sp].any()          # rank 0 sent rank 1 none
        jt = _bytes(jtok).reshape(W, W * sp, -1)
        np.testing.assert_array_equal(_bytes(ttok)[rows], jt[rows])
        np.testing.assert_array_equal(tmeta.numpy(),
                                      np.asarray(jmeta).reshape(W, W * mr,
                                                                128))
        # the combine leg: every receiver's slots back to their sources
        toks, rspl = tmd.recv_view(tc, ttok, tmeta)
        y_tok, y_meta = tmd.stage_return(tc, toks * 0.5)
        retk = -(-rspl.sum(-1) // tmd.chunk_rows(tc))
        np.testing.assert_array_equal(retk.numpy(), sendk.T)
        jy = jnp.asarray(_bytes(y_tok).reshape(W * W * sp, -1).view(
            np.asarray(jtok).dtype) if quant == "fp8"
            else _bytes(y_tok).reshape(W * W * sp, -1))
        jctok, jcmeta = _on_mesh(
            jmesh, functools.partial(jmd.combine_device, jc), jy,
            jnp.asarray(y_meta.numpy().reshape(W * W, mr, 128)),
            jnp.asarray(retk.numpy().reshape(-1)),
            _jstack(jside, "sendk"))
        ctok, cmeta = tmd.combine_device(tc, y_tok, y_meta, retk,
                                         t["sendk"])
        back = _shipped_rows(tc, sendk)            # what r sent to p
        np.testing.assert_array_equal(
            _bytes(ctok)[back], _bytes(jctok).reshape(W, W * sp, -1)[back])
        np.testing.assert_array_equal(cmeta.numpy(),
                                      np.asarray(jcmeta).reshape(W, W * mr,
                                                                 128))

    def test_workspaces_roll_the_parity_like_jax(self, jmesh, tmesh):
        """LL mode over two calls (parity 0, then 1), fp8, a different
        routing each call, workspaces pre-filled with random bytes: both
        whole workspaces, the rows never shipped included, equal JAX's
        after each call."""
        jc, tc = _a2a_contexts(jmesh, tmesh, "fp8")
        (tshape, _), (mshape, _) = tmd.ll_workspace_shapes(tc)
        rng = np.random.default_rng(6)
        ws_b = rng.integers(0, 256, (W, *tshape), dtype=np.uint8)
        wsm = rng.integers(-2 ** 31, 2 ** 31 - 1, (W, *mshape),
                           dtype=np.int64).astype(np.int32)
        jws = jnp.asarray(ws_b.reshape(W * tshape[0], -1)).view(
            jnp.float8_e4m3fn)
        jwsm = jnp.asarray(wsm.reshape(W * mshape[0], -1))
        tws = torch.from_numpy(ws_b.copy()).view(torch.float8_e4m3fn)
        twsm = torch.from_numpy(wsm.copy())
        for call, seed in enumerate((7, 8)):
            jside, t = _a2a_staged(jc, tc, seed, False)
            par = np.asarray([call % 2], np.int32)
            fn = functools.partial(jmd.dispatch_ll_device, jc,
                                   instance=950 + call)
            jws, jwsm = jax.jit(jax.shard_map(
                fn, mesh=jmesh, in_specs=(P("tp"),) * 4 + (P(),)
                + (P("tp"),) * 2, out_specs=P("tp"), check_vma=False))(
                _jstack(jside, "payload"), _jstack(jside, "offs_al"),
                _jstack(jside, "sendk"), _jstack(jside, "meta"),
                jnp.asarray(par), jws, jwsm)
            tmd.dispatch_ll_device(tc, t["payload"], t["offs_al"],
                                   t["sendk"], t["meta"], _t(par), tws, twsm)
            np.testing.assert_array_equal(
                _bytes(tws).reshape(W * tshape[0], -1), _bytes(jws))
            np.testing.assert_array_equal(
                twsm.numpy().reshape(W * mshape[0], -1), np.asarray(jwsm))

    def test_separate_shards_are_refused(self, tmesh):
        """Over a mesh the transport takes every rank's tensors stacked
        (views of one allocation); per-rank tensors of their own, and
        one rank's tensors alone, come with the mesh over several GPUs."""
        tc = tma.MoEAllToAllContext(
            n=W, max_m=(M // W) * K, hidden=H, experts_per_rank=E // W,
            quant="fp8", mesh=tmesh)
        sp, mr = tmd.slot_pad(tc), tmd.meta_rows(tc)
        pay = [torch.zeros((tmd.m_cap(tc), H), dtype=torch.float8_e4m3fn)
               for _ in range(W)]
        meta = torch.zeros((W, W * mr, 128), dtype=torch.int32)
        n4 = torch.zeros((W, W), dtype=torch.int32)
        tok, tmeta = tmd._fresh_window(tc, (W,), "cpu")
        par = torch.zeros((1,), dtype=torch.int32)
        with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
            tmd.chunked_a2a(tc, pay, meta, n4, n4, n4, tok, tmeta, par)
        with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
            tmd.chunked_a2a(tc, pay[0], meta[0], n4[0], n4[0], n4[0], tok[0],
                            tmeta[0], par)
        assert tok.shape == (W, W * sp, H)


# ------------------------------------------------------------------ ep_moe

def _ep_weights(w_up, w_down, kind):
    """(JAX, port) expert weights: f32 tensors, or the JAX quantizer's
    int8 dicts (the port's as W per-rank expert shards of each leaf)."""
    if kind == "float":
        return (jnp.asarray(w_up), jnp.asarray(w_down)), (
            list(_t(w_up).reshape(W, E // W, H, F).unbind(0)),
            list(_t(w_down).reshape(W, E // W, F, H).unbind(0)))
    jw, tw = [], []
    for w in (w_up, w_down):
        q, s = j_quantize_grouped_weights(jnp.asarray(w), "int8")
        jw.append({"q": q, "scale": s})
        tq, ts = _t(q), _t(s)
        tw.append({"q": list(tq.reshape(W, E // W, *tq.shape[1:]).unbind(0)),
                   "scale": list(ts.reshape(W, E // W, -1).unbind(0))})
    return tuple(jw), tuple(tw)


class TestEPMoEMesh:
    @pytest.mark.parametrize("kind", ["float", "int8"])
    def test_ep_moe_decode_matches_jax(self, jmesh, tmesh, kind):
        """The decode's context (fused transport, fp8 wire, W8A8 for int8
        experts, block_m 64) over persistent workspaces for two calls,
        against JAX's on the TPU's path (interpreted): the bound of
        tests/test_torch_moe.py (one wire or int8 code flip may move a
        token's row; at most 5 % of the elements past 1e-5)."""
        x, logits, w_up, w_down = _moe_data(9)
        (ju, jd), (tu, td) = _ep_weights(w_up, w_down, kind)
        act = "int8" if kind == "int8" else None
        kw = dict(num_experts=E, topk=K, max_m=(M // W) * K, hidden=H,
                  block_m=64, quant="fp8", act_quant=act)
        jctx = jops.create_ep_moe_context(
            jmesh, "tp", dtype=jnp.float32, transport="fused",
            use_pallas_gemm=True, **kw)
        tctx = ops.create_ep_moe_context(dtype=torch.float32, mesh=tmesh,
                                         **kw)
        jst, tst = jops.create_ep_moe_state(jctx), ops.create_ep_moe_state(
            tctx)
        assert tst.disp_tok.shape[0] == W
        for call in range(2):
            xs = x * (1.0 + 0.5 * call)
            want, jst = jops.ep_moe(jnp.asarray(xs), jnp.asarray(logits), ju,
                                    jd, jctx, state=jst)
            got, tst = ops.ep_moe(_t(xs), _t(logits), tu, td, tctx,
                                  state=tst)
            assert int(tst.parity[0]) == (call + 1) % 2
            want = np.asarray(want)
            diff = np.abs(got.numpy() - want) / np.abs(want).max()
            assert diff.max() <= 7e-2 and (diff > 1e-5).mean() <= 0.05

    @pytest.mark.parametrize("kind", ["float", "int8"])
    def test_ep_moe_mlp_prefill_matches_jax(self, jmesh, tmesh, kind):
        """``EPMoEMLP`` as prefill runs it: the port's fused transport with
        no quantization on float (widened) experts at block_m 128,
        launching the all-to-all across the 4 ranks, against JAX's
        full-precision ``xla`` transport; f32, 1e-5."""
        x, _, w_up, w_down = _moe_data(10)
        router = np.random.default_rng(11).standard_normal(
            (H, E)).astype(np.float32) / np.sqrt(H)
        (ju, jd), (tu, td) = _ep_weights(w_up, w_down, kind)
        if kind == "int8":
            tu, td = (dequantize_grouped_weights(
                torch.cat(w["q"]), torch.cat(w["scale"]), torch.float32)
                for w in (tu, td))
        jctx = jops.create_ep_moe_context(
            jmesh, "tp", num_experts=E, topk=K, max_m=(M // W) * K,
            hidden=H, dtype=jnp.float32, transport="xla",
            use_pallas_gemm=False, block_m=128)
        tctx = ops.create_ep_moe_context(
            num_experts=E, topk=K, max_m=(M // W) * K, hidden=H,
            dtype=torch.float32, block_m=128, mesh=tmesh)
        want = JEPMoEMLP(jctx)({"router": jnp.asarray(router), "up": ju,
                                "down": jd}, jnp.asarray(x))
        got = EPMoEMLP(tctx)({"router": _t(router), "up": tu, "down": td},
                             _t(x))
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


# ------------------------------------------------------ prefill → generate

#: the tiny DeepSeek-MoE preset: EP as served (int8 preset) and TP
FLAVOURS = {"ep": dict(),
            "tp": dict(moe="tp", moe_weight_quant=None, moe_act_quant=None)}
#: batch (not a multiple of 4: the EP decode pads), prompt, capacity,
#: steps
GB, GS, GCAP, GSTEPS = 3, 8, 16, 2


@pytest.fixture(scope="module", params=sorted(FLAVOURS))
def moe_run(request, jmesh, tmesh):
    """The tiny DeepSeek-MoE preset through prefill + generate, the EP
    decode over its persistent workspaces: JAX at tp = 4 (its decode on
    the TPU's fused transport), the port at tp = 4 (from
    ``params_from_numpy(mesh=)``) and at tp = 1, on the same parameters
    and ragged prompts."""
    from _torch_moe_ref import tpu_moe_ctx

    kw = FLAVOURS[request.param]
    jcfg = jpresets.tiny(jpresets.deepseek_moe_16b(**kw))
    cfg = presets.tiny(presets.deepseek_moe_16b(**kw))
    jm = JTransformer(jcfg, jmesh, "tp", ())
    params = jm.quantize_moe_weights(jm.quantize_dense_weights(
        jm.init(jax.random.PRNGKey(0))))
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(12)
    toks = rng.integers(0, 128, (GB, GS)).astype(np.int32)
    lens = np.array([GS, 5, 3], np.int32)
    run = dict(name=request.param, tree=tree, cfg=cfg)
    saved = JTransformer._moe_ep_ctx
    JTransformer._moe_ep_ctx = tpu_moe_ctx
    try:
        jlast, jc, jl = jm.prefill(params, jm.init_cache(GB, GCAP),
                                   jnp.asarray(toks), jnp.asarray(lens))
        first = jnp.argmax(jlast, -1).astype(jnp.int32)
        jst = jm.init_decode_state(GB)
        jout = jm.generate(params, jc, jl, first, GSTEPS, moe_state=jst)
    finally:
        JTransformer._moe_ep_ctx = saved
    run["jax"] = dict(last=np.asarray(jlast), toks=np.asarray(jout[0]),
                      states=jst is not None)
    for tp in (W, 1):
        tm = (Transformer(cfg, mesh=tmesh) if tp > 1
              else Transformer(cfg, device="cpu"))
        tparams = params_from_numpy(tree, cfg, "cpu",
                                    mesh=tmesh if tp > 1 else None)
        last, tc, tl = tm.prefill(tparams, tm.init_cache(GB, GCAP),
                                  _t(toks), _t(lens))
        st = tm.init_decode_state(GB)
        out = tm.generate(tparams, tc, tl, _t(np.asarray(first)), GSTEPS,
                          moe_state=st)
        np.testing.assert_array_equal(out[2].numpy(), lens + GSTEPS)
        run[tp] = dict(last=last.numpy(), toks=out[0].numpy(),
                       states=out[3] if len(out) == 4 else None)
    return run


class TestMoEGenerateMesh:
    def test_prefill_logits_match_jax_and_tp1(self, moe_run):
        """The first step's logits at tp = 4 within 1e-4 of JAX's and of
        the port at tp = 1 (f32 GEMMs, and in EP the float experts of
        prefill, summed in another order)."""
        np.testing.assert_allclose(moe_run[W]["last"], moe_run["jax"]["last"],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(moe_run[W]["last"], moe_run[1]["last"],
                                   rtol=1e-4, atol=1e-4)

    def test_token_streams_match_jax_and_tp1(self, moe_run):
        """The greedy tokens: TP (f32 experts) equal JAX's and tp = 1's
        on every row; EP as served (fp8 wire, W8A8, int8 KV) on the rows
        whose first-step top-2 margin clears 1e-2 (all of them at these
        seeds)."""
        last = moe_run["jax"]["last"]
        top2 = np.sort(last, axis=-1)[:, -2:]
        gate = (top2[:, 1] - top2[:, 0]) > 1e-2
        assert gate.any()
        if moe_run["name"] == "tp":
            gate[:] = True
        for other in ("jax", 1):
            np.testing.assert_array_equal(moe_run[W]["toks"][gate],
                                          moe_run[other]["toks"][gate])

    def test_moe_states_carry(self, moe_run):
        """EP returns the next workspaces of every MoE layer (one window
        pair a rank, the parity flipped once a step, both models alike);
        TP has none."""
        st = moe_run[W]["states"]
        if moe_run["name"] == "tp":
            assert st is None and not moe_run["jax"]["states"]
            return
        assert moe_run["jax"]["states"]
        layer = st[moe_run["cfg"].moe_layers[0]]
        assert layer.disp_tok.shape[0] == W
        assert int(layer.parity[0]) == GSTEPS % 2

    def test_expert_shards_round_trip(self, moe_run, tmesh):
        """``params_from_numpy(mesh=)`` gives rank r its block of experts
        (EP: every leaf of the int8 dicts, the scales too) or its F block
        (TP: ``moe_up``'s columns, ``moe_down``'s rows); the router stays
        whole. Put back in place, the shards give JAX's arrays bit for
        bit."""
        cfg, tree = moe_run["cfg"], moe_run["tree"]
        sharded = params_from_numpy(tree, cfg, mesh=tmesh)
        for i in cfg.moe_layers:
            jb, tb = tree["blocks"][i], sharded["blocks"][i]
            np.testing.assert_array_equal(tb["router"].numpy(), jb["router"])
            for name in ("moe_up", "moe_down"):
                leaves = (jb[name].items() if isinstance(jb[name], dict)
                          else [(None, jb[name])])
                for key, glob in leaves:
                    shards = tb[name] if key is None else tb[name][key]
                    assert len(shards) == W
                    dim = (0 if cfg.moe == "ep"
                           else (2 if name == "moe_up" else 1))
                    back = np.concatenate([s.numpy() for s in shards],
                                          axis=dim)
                    np.testing.assert_array_equal(back, glob)
