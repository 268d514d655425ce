"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs an NVIDIA GPU and ``nvcc`` and skips without one.
The file imports torch, numpy and the port only, so it also runs on a
machine without JAX::

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from triton_distributed_tpu_torch.kernels import allgather as ag
from triton_distributed_tpu_torch.kernels import group_gemm as gg
from triton_distributed_tpu_torch.kernels import launch_counts, quantize_kv
from triton_distributed_tpu_torch.kernels import moe_all_to_all as ma
from triton_distributed_tpu_torch.kernels import moe_dispatch as md
from triton_distributed_tpu_torch.kernels import moe_tp_fused as mtf
from triton_distributed_tpu_torch.kernels import moe_utils as mu
from triton_distributed_tpu_torch.kernels import ragged_paged_attention as rpa

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    """The first CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode (their plain versions are tested on the CPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _t(a, dev, dtype=None):
    return torch.from_numpy(np.array(a, copy=True)).to(dev, dtype)


def _gemm_inputs(seed, e, cap, k, n, block_m):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((cap, k)).astype(np.float32)
    w = (rng.standard_normal((e, k, n)) / np.sqrt(k)).astype(np.float32)
    be = rng.integers(0, e, (cap // block_m,)).astype(np.int32)
    return x, w, be


class TestGroupedMatmulKernel:
    @pytest.mark.parametrize("out", ["float32", "bfloat16"])
    @pytest.mark.parametrize("shape", [(192, 200, 100, 64, 3),
                                       (37, 70, 33, 37, 1),
                                       (1100, 96, 40, 1100, 1)])
    def test_w8a8_is_exact(self, dev, out, shape):
        """Ragged M/N/K edges, one or three experts, and one M-block of
        more than 1024 rows: the int32 sums and the f32 epilogue equal
        the plain version's bit for bit."""
        cap, k, n, block_m, e = shape
        x, w, be = _gemm_inputs(0, e, cap, k, n, block_m)
        wq, ws = gg.quantize_grouped_weights(_t(w, dev))
        xq, xs = gg.quantize_act_rows(_t(x, dev))
        kw = dict(w_scale=ws, x_scale=xs, out_dtype=getattr(torch, out))
        before = launch_counts()["ggemm_w8a8"]
        got = gg.grouped_matmul(xq, wq, _t(be, dev), **kw)
        want = gg.grouped_matmul_plain(xq, wq, _t(be, dev), **kw)
        assert launch_counts()["ggemm_w8a8"] == before + 1
        torch.testing.assert_close(got, want, rtol=0, atol=0)

    @pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("out", ["float32", "bfloat16"])
    def test_w8a16_matches_plain(self, dev, x_dtype, out):
        """f32 sums in another order: 1e-4 (f32 out); one bf16 rounding
        of the output (bf16 out)."""
        x, w, be = _gemm_inputs(1, 3, 192, 200, 100, 64)
        wq, ws = gg.quantize_grouped_weights(_t(w, dev))
        xt = _t(x, dev, getattr(torch, x_dtype))
        kw = dict(w_scale=ws, out_dtype=getattr(torch, out))
        got = gg.grouped_matmul(xt, wq, _t(be, dev), **kw)
        want = gg.grouped_matmul_plain(xt, wq, _t(be, dev), **kw)
        tol = 1e-4 if out == "float32" else 1e-2
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)

    @pytest.mark.parametrize("out", ["float32", "bfloat16"])
    @pytest.mark.parametrize("shape", [(256, 2048, 1408, 64, 4),
                                       (37, 70, 33, 37, 1),
                                       (192, 96, 136, 64, 3)])
    def test_bf16_float_mode_matches_plain(self, dev, out, shape):
        """The tensor-core kernel: bf16 products are exact in f32, so
        only the f32 summation order (1e-5·sqrt(K) of the largest sum)
        and, for bf16 out, one bf16 rounding (2^-8 relative) differ.
        Ragged M/N/K edges (K = 70: no 16-byte rows) and the expert
        shapes of the serving path."""
        cap, k, n, block_m, e = shape
        x, w, be = _gemm_inputs(5, e, cap, k, n, block_m)
        xb, wb = _t(x, dev, torch.bfloat16), _t(w, dev, torch.bfloat16)
        odt = getattr(torch, out)
        before = launch_counts()["ggemm_bf16"]
        got = gg.grouped_matmul(xb, wb, _t(be, dev), out_dtype=odt)
        want = gg.grouped_matmul_plain(xb, wb, _t(be, dev),
                                       out_dtype=torch.float32)
        assert launch_counts()["ggemm_bf16"] == before + 1
        assert got.dtype == odt
        scale = want.abs().max().item()
        tol = (2.0 ** -8 * want.abs() if out == "bfloat16" else 0.0) \
            + 1e-5 * np.sqrt(k) * scale
        assert ((got.float() - want).abs() <= tol).all()

    def test_f32_float_mode_matches_plain(self, dev):
        """The f32 instantiation (FMA): 1e-5 (summation order)."""
        x, w, be = _gemm_inputs(6, 3, 192, 200, 100, 64)
        before = launch_counts()
        got = gg.grouped_matmul(_t(x, dev), _t(w, dev), _t(be, dev))
        after = launch_counts()
        assert after["ggemm_f32"] == before["ggemm_f32"] + 1
        assert after["ggemm_bf16"] == before["ggemm_bf16"]
        want = gg.grouped_matmul_plain(_t(x, dev), _t(w, dev), _t(be, dev))
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)

    def test_w8a8_is_exact_with_64_experts(self, dev):
        """The expert layout: 64 experts, many 64-row blocks."""
        x, w, be = _gemm_inputs(7, 64, 64 * 40, 256, 192, 64)
        wq, ws = gg.quantize_grouped_weights(_t(w, dev))
        xq, xs = gg.quantize_act_rows(_t(x, dev))
        kw = dict(w_scale=ws, x_scale=xs, out_dtype=torch.bfloat16)
        got = gg.grouped_matmul(xq, wq, _t(be, dev), **kw)
        want = gg.grouped_matmul_plain(xq, wq, _t(be, dev), **kw)
        torch.testing.assert_close(got, want, rtol=0, atol=0)

    def test_wrapper_refuses_what_the_kernel_does_not_take(self, dev):
        x, w, be = _gemm_inputs(2, 2, 128, 64, 32, 32)
        wq, ws = gg.quantize_grouped_weights(_t(w, dev))
        xq, xs = gg.quantize_act_rows(_t(x, dev))
        with pytest.raises(ValueError, match="multiple of"):
            gg.grouped_matmul(xq, wq, _t(be, dev), w_scale=ws, x_scale=xs)
        with pytest.raises(ValueError, match="contiguous"):
            gg.grouped_matmul(xq.t().contiguous().t(), wq,
                              _t(be[:2], dev), w_scale=ws, x_scale=xs)


#: (kv_len, q_len, kind, aux) — decode, chunk, prefill, q_len == 0,
#: SHARED_PREFIX, TREE and CP rows, and a long decode row
ROWS = [(13, 1, "causal", None), (21, 5, "causal", None),
        (8, 8, "causal", None), (17, 0, "causal", None),
        (20, 3, "shared", 8), (12, 4, "tree", [-1, 0, 0]),
        (10, 2, "cp", 3), (60, 1, "causal", None)]
HKV, G, PAGE, PPS, NPAGES = 2, 2, 8, 8, 96


def _attention_inputs(seed, dev, quant, q_dtype, d):
    rng = np.random.default_rng(seed)
    r = len(ROWS)
    kv_lens = np.array([a for a, *_ in ROWS], np.int32)
    q_lens = np.array([b for _, b, *_ in ROWS], np.int32)
    q_starts = np.zeros((r,), np.int32)
    nxt = 0
    for i, (_, ql, *_) in enumerate(ROWS):
        q_starts[i] = nxt
        nxt += -(-ql // 8) * 8
    block_q = rpa.auto_block_q(int(q_lens.max()), G)
    t = nxt + block_q
    q_starts[q_lens == 0] = nxt
    table = rng.permutation(NPAGES)[: r * PPS].reshape(r, PPS).astype(np.int32)
    table[2, 1:] = -1
    w = rpa.topo_width(block_q)
    topo = rpa.causal_topologies(r, w)
    for i, (_, _, kind, aux) in enumerate(ROWS):
        if kind == "shared":
            topo[i] = rpa.shared_prefix_topology_row(aux, w)
        elif kind == "tree":
            topo[i] = rpa.tree_topology_row(aux, w)
        elif kind == "cp":
            topo[i] = rpa.cp_topology_row(aux, w)
    qdt = getattr(torch, q_dtype)
    q = _t(rng.standard_normal((HKV, t * G, d)), dev, qdt)
    kc = _t(rng.standard_normal((NPAGES, HKV, PAGE, d)), dev, torch.float32)
    vc = _t(rng.standard_normal((NPAGES, HKV, PAGE, d)), dev, torch.float32)
    kw = dict(group=G, topologies=_t(topo, dev), block_q=block_q)
    if quant:
        kq, ks = quantize_kv(kc)
        vq, vs = quantize_kv(vc)
        pools = (kq, vq)
        kw.update(k_scale=ks, v_scale=vs)
    else:
        pools = (kc.to(qdt), vc.to(qdt))
    meta = [_t(m, dev) for m in (kv_lens, q_lens, q_starts, table)]
    return (q, *pools, *meta), kw


class TestRaggedAttentionKernel:
    @pytest.mark.parametrize("d", [16, 128])
    @pytest.mark.parametrize("quant", [False, True])
    @pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
    def test_matches_plain_on_every_row(self, dev, quant, q_dtype, d):
        """Every row of out and lse, spans and the rest. f32: 1e-5
        (summation order); bf16 q: one bf16 rounding of out (1e-2), and
        with int8 pools the plain version's bf16 dequantized pools
        (5e-2)."""
        args, kw = _attention_inputs(3, dev, quant, q_dtype, d)
        before = launch_counts()["ragged_paged_attention"]
        got, lse = rpa.ragged_paged_attention(*args, **kw)
        want, wlse = rpa.ragged_paged_attention_plain(*args, **kw)
        assert launch_counts()["ragged_paged_attention"] == before + 1
        if q_dtype == "float32":
            tol = 1e-5
        else:
            tol = 5e-2 if quant else 1e-2
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        torch.testing.assert_close(lse, wlse, rtol=tol, atol=tol)

    def test_wrapper_refuses_mismatched_pools(self, dev):
        args, kw = _attention_inputs(4, dev, False, "float32", 16)
        q, kp, vp, *meta = args
        with pytest.raises(ValueError, match="pools"):
            rpa.ragged_paged_attention(q, kp.to(torch.bfloat16),
                                       vp.to(torch.bfloat16), *meta, **kw)
        with pytest.raises(ValueError, match="int32"):
            rpa.ragged_paged_attention(q, kp, vp, *[m.long() for m in meta],
                                       **kw)


def _staged_a2a(dev, quant, dtype, seed):
    """One rank's staged payload and metadata for a seeded routing."""
    ctx = ma.MoEAllToAllContext(n=1, max_m=200, hidden=96,
                                experts_per_rank=8, dtype=dtype, quant=quant)
    rng = np.random.default_rng(seed)
    flat_e = _t(rng.integers(0, 9, (200,)).astype(np.int32), dev)
    x = _t(rng.standard_normal((100, 96)), dev, dtype)
    order = torch.argsort(flat_e, stable=True)
    valid = flat_e < 8
    splits = torch.bincount(flat_e[valid].long(), minlength=8).to(torch.int32)
    _, offs, offs_al, sendk = md.send_plan(ctx, splits)
    _, dest = md.assignment_dest(ctx, flat_e[order], offs, offs_al)
    payload, scales = md.stage_aligned(ctx, x, order // 2, dest,
                                       valid.sum())
    meta = md.meta_payload(ctx, splits, scales, offs_al, sendk)
    return ctx, payload, offs_al, sendk, meta


class TestChunkedA2AKernel:
    @pytest.mark.parametrize("wire", [("fp8", torch.float32),
                                      ("int8", torch.bfloat16),
                                      (None, torch.bfloat16),
                                      (None, torch.float32)])
    def test_windows_are_byte_exact(self, dev, wire):
        """Barrier and workspace mode over windows pre-filled with random
        bytes, parity rolling 0, 1, 0: every byte equals the plain
        version's, the rows past the shipped chunks untouched."""
        quant, dtype = wire
        ctx = ma.MoEAllToAllContext(n=1, max_m=200, hidden=96,
                                    experts_per_rank=8, dtype=dtype,
                                    quant=quant)
        (tshape, tdt), (mshape, _) = md.ll_workspace_shapes(ctx)
        g = torch.Generator(device=dev).manual_seed(0)
        raw = torch.randint(0, 256, (tshape[0], 96 * ctx.wire_itemsize),
                            generator=g, device=dev, dtype=torch.uint8)
        ws = [raw.clone().view(tdt), raw.clone().view(tdt)]
        wsm = torch.randint(-2 ** 31, 2 ** 31 - 1, mshape, generator=g,
                            device=dev, dtype=torch.int32)
        wsm = [wsm.clone(), wsm.clone()]
        for call in range(3):
            _, payload, offs_al, sendk, meta = _staged_a2a(dev, quant, dtype,
                                                           call)
            par = torch.tensor([call % 2], dtype=torch.int32, device=dev)
            args = (ctx, payload, meta.reshape(-1, 128),
                    (offs_al // md.align(ctx)).to(torch.int32), sendk,
                    torch.zeros_like(sendk))
            before = launch_counts()["chunked_a2a"]
            md.chunked_a2a(*args, ws[0], wsm[0], par)
            assert launch_counts()["chunked_a2a"] == before + 1
            md.chunked_a2a_plain(*args, ws[1], wsm[1], par)
            torch.cuda.synchronize()
            assert torch.equal(ws[0].view(torch.uint8),
                               ws[1].view(torch.uint8))
            assert torch.equal(wsm[0], wsm[1])
        tok, tmeta = md.dispatch_device(ctx, payload, offs_al, sendk, meta)
        rows = int(sendk[0]) * md.chunk_rows(ctx)
        assert torch.equal(tok.view(torch.uint8)[:rows],
                           payload.view(torch.uint8)[:rows])
        assert torch.equal(tmeta, meta.reshape(-1, 128))


def test_ep_moe_on_card_matches_cpu(dev):
    """The tiny f32 EP MoE (fp8 wire, W8A8 and float experts) on the card
    against the CPU's plain versions: 1e-5 of the output's scale, or
    one fp8 / int8 code flip of a token's row (see tests/test_torch_moe.py
    for the same bound against JAX)."""
    from triton_distributed_tpu_torch import ops

    rng = np.random.default_rng(0)
    x = rng.standard_normal((40, 128)).astype(np.float32)
    logits = rng.standard_normal((40, 8)).astype(np.float32)
    up = (rng.standard_normal((8, 128, 64)) / 11).astype(np.float32)
    down = (rng.standard_normal((8, 64, 128)) / 8).astype(np.float32)
    for act in ("int8", None):
        outs = []
        for d in ("cpu", dev):
            u, dn = _t(up, d), _t(down, d)
            if act:
                u, dn = ({"q": q, "scale": sc} for q, sc in (
                    gg.quantize_grouped_weights(w) for w in (u, dn)))
            ctx = ops.create_ep_moe_context(
                num_experts=8, topk=2, max_m=80, hidden=128,
                dtype=torch.float32, quant="fp8", act_quant=act)
            st = ops.create_ep_moe_state(ctx, d)
            out, st = ops.ep_moe(_t(x, d), _t(logits, d), u, dn, ctx,
                                 state=st)
            outs.append(out.cpu())
        diff = (outs[1] - outs[0]).abs() / outs[0].abs().max()
        assert diff.max() <= 7e-2 and (diff > 1e-5).float().mean() <= 0.05


def test_serving_step_on_card_matches_cpu(dev):
    """The int8 tiny model: logits of two packed steps on the card
    (kernels) against the CPU (plain versions) from the same weights,
    1e-3 (f32 model; the attention sums in another order)."""
    from triton_distributed_tpu_torch.models import Transformer, presets

    cfg = presets.tiny(kv_quant="int8", dense_weight_quant="int8",
                       dense_act_quant="int8")
    cpu = Transformer(cfg, device="cpu")
    params = cpu.quantize_dense_weights(
        cpu.init(torch.Generator().manual_seed(0)))
    gpu = Transformer(cfg, device=dev)

    def to(node, d):
        if isinstance(node, dict):
            return {k: to(v, d) for k, v in node.items()}
        if isinstance(node, list):
            return [to(v, d) for v in node]
        return node.to(d)

    states = [cpu.init_serving_state(4, 16, 8), gpu.init_serving_state(4, 16, 8)]
    rng = np.random.default_rng(0)
    table = np.arange(16, dtype=np.int32).reshape(4, 4)
    for q_lens in ([12, 5, 0, 3], [1, 4, 6, 1]):
        q_lens = np.array(q_lens, np.int32)
        q_starts = np.full((4,), 32, np.int32)
        nxt = 0
        for s, ql in enumerate(q_lens):
            if ql:
                q_starts[s] = nxt
                nxt += -(-ql // 8) * 8
        kv = q_lens if states[0].kv_lens.sum() == 0 else \
            states[0].kv_lens.numpy() + q_lens
        tokens = rng.integers(0, cfg.vocab, (48,)).astype(np.int32)
        rows = np.zeros((48,), np.int32)
        pos = np.full((48,), -1, np.int32)
        for s, ql in enumerate(q_lens):
            rows[q_starts[s]:q_starts[s] + ql] = s
            pos[q_starts[s]:q_starts[s] + ql] = np.arange(kv[s] - ql, kv[s])
        out = []
        for i, (model, d) in enumerate(((cpu, "cpu"), (gpu, dev))):
            st = states[i].replace(block_table=_t(table, d),
                                   kv_lens=_t(kv.astype(np.int32), d))
            logits, states[i] = model.serving_step(
                to(params, d), st, *[_t(a, d) for a in (tokens, rows, pos,
                                                        q_starts, q_lens)],
                block_q=rpa.auto_block_q(int(q_lens.max()), 2))
            out.append(logits.cpu()[torch.from_numpy(q_lens > 0)])
        torch.testing.assert_close(out[1], out[0], rtol=1e-3, atol=1e-3)


# ------------------------------------------------------------ flash decode

from triton_distributed_tpu_torch.kernels import ag_gemm as agm  # noqa: E402
from triton_distributed_tpu_torch.kernels import flash_decode as fd  # noqa: E402
from triton_distributed_tpu_torch.kernels import gemm_rs as grs  # noqa: E402

#: an empty row, one position, a full row, rows ending inside a tile and
#: on a tile's edge
DEC_LENS = np.array([0, 1, 256, 77, 128], np.int32)
DEC_B, DEC_HKV, DEC_G, DEC_S = 5, 2, 2, 256


def _decode_inputs(seed, dev, d, kv, layout):
    """Seeded q and a cache in ``layout`` ("bhsd", "bshd" or "paged" at
    page 128, or 8 for head dim 16) of ``kv`` ("float32", "bfloat16",
    "int8")."""
    rng = np.random.default_rng(seed)
    q = _t(rng.standard_normal((DEC_B, DEC_HKV * DEC_G, d)), dev,
           torch.bfloat16 if kv == "bfloat16" else torch.float32)
    lens = _t(DEC_LENS, dev)
    if layout == "paged":
        page = 128 if d == 128 else 8
        pps = DEC_S // page
        npages = DEC_B * pps + 2
        shape = (npages, DEC_HKV, page, d)
        table = rng.permutation(npages)[:DEC_B * pps].reshape(DEC_B, pps)
        table[3, -1] = -1                  # past row 3's 77 positions
        extra = (_t(table.astype(np.int32), dev),)
    else:
        shape = ((DEC_B, DEC_HKV, DEC_S, d) if layout == "bhsd"
                 else (DEC_B, DEC_S, DEC_HKV, d))
        extra = ()
    k = _t(rng.standard_normal(shape), dev, torch.float32)
    v = _t(rng.standard_normal(shape), dev, torch.float32)
    if kv == "int8":
        (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
        cache = (kq, ks, vq, vs)
    else:
        cache = (k.to(getattr(torch, kv)), v.to(getattr(torch, kv)))
    return q, cache, lens, extra


_DECODE_CASES = [(d, kv, layout) for d in (16, 128)
                 for kv in ("float32", "bfloat16", "int8")
                 for layout in ("bhsd", "bshd", "paged")
                 if not (kv == "int8" and layout == "bshd")]


class TestFlashDecodeKernels:
    @pytest.mark.parametrize("soft_cap", [0.0, 4.0])
    @pytest.mark.parametrize("d,kv,layout", _DECODE_CASES)
    def test_matches_plain(self, dev, d, kv, layout, soft_cap):
        """Every row of out and lse against the plain version on the same
        inputs: both walk the same 64-position tiles and round p alike,
        so they differ by the f32 summation order and one rounding of
        out: 1e-5 for f32 caches, 1e-2 for bf16 out, 1e-4 otherwise
        (int8 at head dim 128 rounds p to bf16; at head dim 16 the gate
        widens it to f32). The empty row is exactly zero with lse
        NEG_INF, and each launch counts once on its kernel's counter."""
        q, cache, lens, extra = _decode_inputs(0, dev, d, kv, layout)
        kw = dict(soft_cap=soft_cap)
        if layout == "paged":
            fn = (fd.paged_gqa_fwd_batch_decode_q8 if kv == "int8"
                  else fd.paged_gqa_fwd_batch_decode)
            plain = (fd.paged_gqa_fwd_batch_decode_q8_plain if kv == "int8"
                     else fd.paged_gqa_fwd_batch_decode_plain)
            counter = "paged_decode"
        else:
            fn = (fd.gqa_fwd_batch_decode_q8 if kv == "int8"
                  else fd.gqa_fwd_batch_decode)
            plain = (fd.gqa_fwd_batch_decode_q8_plain if kv == "int8"
                     else fd.gqa_fwd_batch_decode_plain)
            counter = "flash_decode"
            if kv != "int8":
                kw["kv_layout"] = layout
        before = launch_counts()
        got, lse = fn(q, *cache, lens, *extra, **kw)
        after = launch_counts()
        assert after[counter] == before[counter] + 1
        assert sum(after.values()) == sum(before.values()) + 1
        want, wlse = plain(q, *cache, lens, *extra, **kw)
        torch.cuda.synchronize()
        tol = {"float32": 1e-5, "bfloat16": 1e-2, "int8": 1e-4}[kv]
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        torch.testing.assert_close(lse, wlse, rtol=1e-4, atol=1e-4)
        assert torch.all(got[0] == 0) and torch.all(lse[0] == fd.NEG_INF)

    @pytest.mark.parametrize("quant", [False, True])
    def test_paged_equals_contiguous_bitwise(self, dev, quant):
        """A contiguous cache and its paginated copy: the two kernels sum
        in the same order, so out and lse are equal bit for bit."""
        from triton_distributed_tpu_torch.models import Transformer, presets

        cfg = presets.tiny(head_dim=128, dtype=torch.bfloat16,
                           **(dict(kv_quant="int8") if quant else {}))
        tm = Transformer(cfg, device=dev)
        caches = tm.init_cache(DEC_B, DEC_S)
        g = torch.Generator(device=dev).manual_seed(1)
        for c in caches[0]:
            if quant:
                c["q"].copy_(torch.randint(-127, 128, c["q"].shape,
                                           generator=g, device=dev))
                c["scale"].copy_(torch.rand(c["scale"].shape, generator=g,
                                            device=dev))
            else:
                c.copy_(torch.randn(c.shape, generator=g, device=dev))
        pools, table = tm.paginate_caches(caches[:1], page=128)
        q = torch.randn((DEC_B, cfg.n_heads, 128), generator=g, device=dev,
                        dtype=torch.bfloat16)
        lens = _t(DEC_LENS, dev)
        a = tm._sp_attn.partials(q, *caches[0], lens)
        b = tm._sp_attn.partials(q, *pools[0], lens, table)
        torch.cuda.synchronize()
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])

    def test_wrapper_refuses_what_the_kernel_does_not_take(self, dev):
        q = torch.zeros((2, 4, 12), device=dev, dtype=torch.bfloat16)
        k = torch.zeros((2, 2, 64, 12), device=dev, dtype=torch.bfloat16)
        lens = torch.zeros((2,), dtype=torch.int32, device=dev)
        with pytest.raises(ValueError, match="multiple of 16 bytes"):
            fd.gqa_fwd_batch_decode(q, k, k, lens)   # 24-byte rows
        q = torch.zeros((2, 4, 16), device=dev)
        k = torch.zeros((2, 2, 64, 16), device=dev)
        with pytest.raises(ValueError, match="int32"):
            fd.gqa_fwd_batch_decode(q, k, k, lens.long())


class TestGemmN1Kernels:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("op", ["ag_gemm_n1", "gemm_rs_n1"])
    def test_matches_plain(self, dev, op, dtype):
        """M = 200 (not a multiple of the 64-row tile), ragged N and K:
        f32 sums in another order (1e-5·sqrt(K) of the largest sum) and,
        in bf16, one rounding of the output. Each launch counts on its
        own counter, not the grouped GEMM's."""
        rng = np.random.default_rng(3)
        tdt = getattr(torch, dtype)
        a = _t(rng.standard_normal((200, 136)), dev, tdt)
        b = _t(rng.standard_normal((136, 72)) / 12, dev, tdt)
        fn = agm.ag_gemm if op == "ag_gemm_n1" else grs.gemm_rs
        before = launch_counts()
        got = fn(a, b)
        after = launch_counts()
        assert after[op] == before[op] + 1
        assert sum(after.values()) == sum(before.values()) + 1
        want = agm.ag_gemm_plain(a, b, out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert got.dtype == tdt and got.shape == (200, 72)
        tol = ((2.0 ** -8 * want.abs() if dtype == "bfloat16" else 0.0)
               + 1e-5 * np.sqrt(136) * want.abs().max().item())
        assert ((got.float() - want).abs() <= tol).all()


def test_prefill_generate_on_card_equals_cpu(dev):
    """The tiny f32 and int8 models, contiguous and paged: prefill and 6
    greedy steps on the card (kernels) give the CPU's (plain versions)
    token streams."""
    from triton_distributed_tpu_torch.models import Transformer, presets

    for kw in ({}, dict(kv_quant="int8", dense_weight_quant="int8",
                        dense_act_quant="int8")):
        cfg = presets.tiny(**kw)
        cpu = Transformer(cfg, device="cpu")
        params = cpu.quantize_dense_weights(
            cpu.init(torch.Generator().manual_seed(0)))
        gpu = Transformer(cfg, device=dev)
        rng = np.random.default_rng(0)
        toks = rng.integers(0, cfg.vocab, (3, 16)).astype(np.int32)
        lens = np.array([16, 9, 1], np.int32)
        streams = []
        for model, d in ((cpu, "cpu"), (gpu, dev)):
            p = _to(params, d)
            last, caches, kl = model.prefill(p, model.init_cache(3, 32),
                                             _t(toks, d), _t(lens, d))
            first = torch.argmax(last, -1).to(torch.int32)
            pools, table = model.paginate_caches(caches, page=8)
            a, _, _ = model.generate(p, caches, kl, first, 6)
            b, _, _ = model.generate(p, pools, kl, first, 6,
                                     block_table=table)
            streams += [a.cpu(), b.cpu()]
        for s in streams[1:]:
            assert torch.equal(s, streams[0])


def _moe_tp_inputs(seed, dev, m, topk, e, k, n, block_m, dtype):
    """Routing over ``e`` experts with expert 1 empty and expert 0 given
    several blocks (half the tokens favour it), the sorted ids and block
    table at ``block_m``, x (m, k) and w (e, k, n) in ``dtype``."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((m, e)).astype(np.float32)
    logits[:, 1] = -1e4
    logits[: m // 2, 0] += 6.0
    _, ids = mu.select_experts(torch.from_numpy(logits), topk)
    sti, be, splits = mu.moe_align_block_size(ids, e, block_m)
    assert int(splits[1]) == 0 and int((be == 0).sum()) > 1
    x = _t(rng.standard_normal((m, k)), dev, dtype)
    w = _t(rng.standard_normal((e, k, n)) / np.sqrt(k), dev, dtype)
    return x, sti.to(dev), be.to(dev), w


def _gemm_tol(want, k, bf16_out):
    """f32 sums in another order (1e-5·sqrt(K) of the largest sum) and,
    for bf16 out, one bf16 rounding (2^-8 relative)."""
    return ((2.0 ** -8 * want.abs() if bf16_out else 0.0)
            + 1e-5 * np.sqrt(k) * want.abs().max().item())


#: (tokens, top-k, experts, K, N, block_m): K and N not multiples of 8
#: (no 16-byte rows), 16-byte rows with several blocks an expert, and
#: the prefill's experts (64 of 2048 x 1408, top-6) at 256 tokens
MOE_TP_SHAPES = [(120, 2, 6, 70, 33, 64), (300, 2, 8, 136, 72, 64),
                 (256, 6, 64, 2048, 1408, 128)]


class TestMoETPKernels:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("shape", MOE_TP_SHAPES)
    def test_ag_group_gemm_matches_plain(self, dev, dtype, shape):
        """The gather fused into the tile load: every row equals the
        plain version's (gather_sorted, then the grouped GEMM), and the
        padding rows (the sentinel) are exactly zero."""
        m, topk, e, k, n, bm = shape
        tdt = getattr(torch, dtype)
        x, sti, be, w = _moe_tp_inputs(11, dev, m, topk, e, k, n, bm, tdt)
        before = launch_counts()
        got = mtf.ag_group_gemm(x, sti, be, w, topk)
        after = launch_counts()
        assert after["ag_group_gemm"] == before["ag_group_gemm"] + 1
        assert sum(after.values()) == sum(before.values()) + 1
        want = mtf.ag_group_gemm_plain(x, sti, be, w, topk,
                                       out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert got.dtype == tdt and got.shape == (sti.shape[0], n)
        tol = _gemm_tol(want, k, dtype == "bfloat16")
        assert ((got.float() - want).abs() <= tol).all()
        pad = sti >= m * topk
        assert pad.any() and (got[pad] == 0).all()

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("shape", MOE_TP_SHAPES)
    def test_moe_reduce_rs_matches_plain(self, dev, dtype, shape):
        """The down projection over sorted rows in place (F = K here)."""
        m, topk, e, k, n, bm = shape
        tdt = getattr(torch, dtype)
        _, sti, be, w = _moe_tp_inputs(12, dev, m, topk, e, k, n, bm, tdt)
        y = _t(np.random.default_rng(13).standard_normal((sti.shape[0], k)),
               dev, tdt)
        before = launch_counts()["moe_reduce_rs"]
        got = mtf.moe_reduce_rs(y, be, w)
        assert launch_counts()["moe_reduce_rs"] == before + 1
        want = mtf.moe_reduce_rs_plain(y, be, w, out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert got.dtype == tdt
        assert ((got.float() - want).abs()
                <= _gemm_tol(want, k, dtype == "bfloat16")).all()

    def test_wrappers_refuse_what_the_kernels_do_not_take(self, dev):
        x, sti, be, w = _moe_tp_inputs(14, dev, 200, 2, 4, 64, 64, 64,
                                       torch.bfloat16)
        with pytest.raises(ValueError, match="int32"):
            mtf.ag_group_gemm(x, sti.long(), be, w, 2)
        with pytest.raises(ValueError, match="operands both"):
            mtf.ag_group_gemm(x, sti, be, w.float(), 2)
        with pytest.raises(ValueError, match="equal M-blocks"):
            mtf.moe_reduce_rs(x[:63], be[:2], w)


def test_moe_prefill_generate_on_card_equals_cpu(dev):
    """The tiny DeepSeek-MoE preset as served (EP) and its TP flavour,
    contiguous and paged: prefill and 6 greedy steps on the card give
    the CPU's token streams; the TP prefill launches both MoE-TP kernels
    once per MoE layer."""
    from triton_distributed_tpu_torch.models import Transformer, presets

    for kw in ({}, dict(moe="tp", moe_weight_quant=None,
                        moe_act_quant=None)):
        cfg = presets.tiny(presets.deepseek_moe_16b(**kw))
        cpu = Transformer(cfg, device="cpu")
        params = cpu.quantize_moe_weights(cpu.quantize_dense_weights(
            cpu.init(torch.Generator().manual_seed(0))))
        gpu = Transformer(cfg, device=dev)
        rng = np.random.default_rng(0)
        toks = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
        lens = np.array([16, 9], np.int32)
        streams = []
        for model, d in ((cpu, "cpu"), (gpu, dev)):
            p = _to(params, d)
            before = launch_counts()
            last, caches, kl = model.prefill(p, model.init_cache(2, 32),
                                             _t(toks, d), _t(lens, d))
            after = launch_counts()
            if d != "cpu" and cfg.moe == "tp":
                for name in ("ag_group_gemm", "moe_reduce_rs"):
                    assert after[name] - before[name] == len(cfg.moe_layers)
            first = torch.argmax(last, -1).to(torch.int32)
            pools, table = model.paginate_caches(caches, page=8)
            st = model.init_decode_state(2)
            a = model.generate(p, caches, kl, first, 6, moe_state=st)[0]
            b = model.generate(p, pools, kl, first, 6, block_table=table)[0]
            streams += [a.cpu(), b.cpu()]
        for s in streams[1:]:
            assert torch.equal(s, streams[0])


def _to(node, d):
    if isinstance(node, dict):
        return {k: _to(v, d) for k, v in node.items()}
    if isinstance(node, list):
        return [_to(v, d) for v in node]
    return node.to(d)


# ------------------------------------------------------- mesh collectives

def _mesh_shards(rng, dev, w, shape, dtype, separate):
    """W per-rank shards of ``shape``: views of one allocation, or
    (``separate``) tensors of their own (the peer table then comes from
    the host)."""
    full = _t(rng.standard_normal((w, *shape)), dev, dtype)
    if separate:
        return [full[r].clone() for r in range(w)]
    return list(full.unbind(0))


class TestMeshKernels:
    @pytest.mark.parametrize("separate", [False, True])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("w", [1, 2, 4])
    @pytest.mark.parametrize("shape", [(37, 72, 40), (64, 70, 136)])
    def test_ag_gemm_matches_plain(self, dev, shape, w, dtype, separate):
        """Ragged shards (37 rows a rank, K not a multiple of 8: no
        16-byte rows) and aligned ones: every rank's output within f32
        summation order (and one bf16 rounding) of the plain version,
        one launch of ``tdt_ag_gemm`` for all ranks."""
        from triton_distributed_tpu_torch.runtime import Mesh

        m, k, n = shape
        rng = np.random.default_rng(20)
        tdt = getattr(torch, dtype)
        mesh = Mesh.loopback(w, dev)
        a = _mesh_shards(rng, dev, w, (m, k), tdt, separate)
        b = [x / np.sqrt(k) for x in _mesh_shards(rng, dev, w, (k, n), tdt,
                                                  False)]
        before = launch_counts()
        got = agm.ag_gemm(a, b, mesh)
        after = launch_counts()
        assert after["ag_gemm"] == before["ag_gemm"] + 1
        assert sum(after.values()) == sum(before.values()) + 1
        want = agm.ag_gemm_plain(a, b, mesh, out_dtype=torch.float32)
        torch.cuda.synchronize()
        for g, ref in zip(got, want):
            assert g.dtype == tdt and g.shape == (w * m, n)
            tol = _gemm_tol(ref, k, dtype == "bfloat16")
            assert ((g.float() - ref).abs() <= tol).all()

    @pytest.mark.parametrize("separate", [False, True])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("w", [1, 2, 4])
    @pytest.mark.parametrize("shape", [(37, 50, 40), (64, 136, 72)])
    def test_gemm_rs_matches_plain(self, dev, shape, w, dtype, separate):
        """Every rank's row block of the sum over ranks: f32 sums over
        ranks and K in another order than the plain version (1e-5·
        sqrt(W·K) of the largest sum) and, in bf16, one rounding of the
        output; one launch of ``tdt_gemm_rs``."""
        from triton_distributed_tpu_torch.runtime import Mesh

        m, k, n = shape
        rng = np.random.default_rng(21)
        tdt = getattr(torch, dtype)
        mesh = Mesh.loopback(w, dev)
        a = _mesh_shards(rng, dev, w, (w * m, k), tdt, separate)
        b = [x / np.sqrt(w * k) for x in _mesh_shards(rng, dev, w, (k, n),
                                                      tdt, separate)]
        before = launch_counts()
        got = grs.gemm_rs(a, b, mesh)
        assert launch_counts()["gemm_rs"] == before["gemm_rs"] + 1
        want = grs.gemm_rs_plain(a, b, mesh, out_dtype=torch.float32)
        torch.cuda.synchronize()
        for g, ref in zip(got, want):
            assert g.dtype == tdt and g.shape == (m, n)
            tol = _gemm_tol(ref, w * k, dtype == "bfloat16")
            assert ((g.float() - ref).abs() <= tol).all()

    @pytest.mark.parametrize("separate", [False, True])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
    @pytest.mark.parametrize("w", [1, 2, 4])
    @pytest.mark.parametrize("shape", [(13, 7), (64, 32)])
    def test_all_gather_is_byte_exact(self, dev, shape, w, dtype, separate):
        """Shards of 91 elements (offsets off the 16-byte grid: the byte
        loop) and of 2048: every rank's result equals ``torch.cat``."""
        from triton_distributed_tpu_torch.runtime import Mesh

        rng = np.random.default_rng(22)
        tdt = getattr(torch, dtype)
        mesh = Mesh.loopback(w, dev)
        if dtype == "int8":
            full = _t(rng.integers(-128, 128, (w, *shape)), dev, tdt)
            x = ([full[r].clone() for r in range(w)] if separate
                 else list(full.unbind(0)))
        else:
            x = _mesh_shards(rng, dev, w, shape, tdt, separate)
        before = launch_counts()["all_gather"]
        got = ag.all_gather(x, mesh)
        assert launch_counts()["all_gather"] == before + 1
        want = torch.cat(x)
        torch.cuda.synchronize()
        for g in got:
            assert torch.equal(g, want)

    def test_wrappers_refuse_what_the_kernels_do_not_take(self, dev):
        from triton_distributed_tpu_torch.runtime import Mesh

        mesh = Mesh.loopback(2, dev)
        a = [torch.zeros((4, 8), device=dev) for _ in range(2)]
        b = [torch.zeros((8, 4), device=dev, dtype=torch.bfloat16)] * 2
        with pytest.raises(ValueError, match="both f32 or both bf16"):
            agm.ag_gemm(a, b, mesh)
        with pytest.raises(ValueError, match="the mesh is on"):
            agm.ag_gemm([t.cpu() for t in a], [t.float().cpu() for t in b],
                        mesh)
        with pytest.raises(ValueError, match="contiguous"):
            ag.all_gather([t.t() for t in a], mesh)


def test_tp_prefill_generate_on_card_equals_cpu(dev):
    """The tiny f32 and int8 models at tp = 4 on a loopback mesh on the
    card and on the CPU, from the same weights: the prefill logits within
    1e-4 (f32 GEMMs summed in another order), then 6 greedy steps in
    lockstep, each side on its own tokens, the tokens equal on every row
    while its CPU top-2 margin stays above 1e-2 (the gate of
    tests/test_models.py: an int8 K/V code can round the other way
    across a tie, which moves the logits by about 1e-3). The card's
    prefill launches the two mesh GEMMs twice a layer each, its decode
    the all-gather twice a layer and step, and no world-size-1 GEMM
    runs."""
    from triton_distributed_tpu_torch.models import Transformer, presets
    from triton_distributed_tpu_torch.runtime import Mesh

    for kw in ({}, dict(kv_quant="int8", dense_weight_quant="int8",
                        dense_act_quant="int8")):
        cfg = presets.tiny(**kw)
        one = Transformer(cfg, device="cpu")
        params = one.quantize_dense_weights(
            one.init(torch.Generator().manual_seed(0)))
        rng = np.random.default_rng(0)
        toks = rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)
        lens = np.array([16, 9, 5, 1], np.int32)
        runs = []
        for d in ("cpu", dev):
            model = Transformer(cfg, mesh=Mesh.loopback(4, d))
            p = model.shard_params(_to(params, d))
            before = launch_counts()
            last, caches, kl = model.prefill(p, model.init_cache(4, 32),
                                             _t(toks, d), _t(lens, d))
            mid = launch_counts()
            runs.append([model, p, caches, kl, last])
            if d != "cpu":
                assert mid["ag_gemm"] - before["ag_gemm"] == 2 * cfg.n_layers
                assert mid["gemm_rs"] - before["gemm_rs"] == 2 * cfg.n_layers
        (mc, pc, cc, kc, lc), (mg, pg, cg, kg, lg) = runs
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
        gate = torch.ones((4,), dtype=torch.bool)
        mid = launch_counts()
        for _ in range(6):
            top2 = torch.topk(lc, 2, dim=-1).values
            gate &= (top2[:, 0] - top2[:, 1]) > 1e-2
            assert gate.any(), "degenerate: every row near-tied"
            tc = torch.argmax(lc, -1).to(torch.int32)
            tg = torch.argmax(lg, -1).to(torch.int32)
            assert torch.equal(tc[gate], tg.cpu()[gate])
            lc, cc, kc = mc.decode_step(pc, cc, kc, tc)
            lg, cg, kg = mg.decode_step(pg, cg, kg, tg)
        after = launch_counts()
        assert after["all_gather"] - mid["all_gather"] == 2 * cfg.n_layers * 6
        assert after["ag_gemm_n1"] == before["ag_gemm_n1"]
        assert after["gemm_rs_n1"] == before["gemm_rs_n1"]


def test_generate_cli_tp_on_the_default_device(dev, capsys):
    """With no device named, the mesh takes the current CUDA device with
    its index (as the tensors made on it report theirs), and the CLI's
    tp = 4 path runs through the mesh kernels on it."""
    from triton_distributed_tpu_torch.runtime import Mesh
    from triton_distributed_tpu_torch.tools import generate

    mesh = Mesh.loopback(4)
    assert mesh.device == torch.device("cuda", torch.cuda.current_device())
    before = launch_counts()
    res = generate.main(["--tp", "4", "--batch", "2", "--prompt-len", "8",
                         "--steps", "3"])
    after = launch_counts()
    assert np.asarray(res["tokens"]).shape == (2, 3) and res["tp"] == 4
    assert f"loopback, 4 ranks along 'tp' on {mesh.device}" in (
        capsys.readouterr().out)
    for k in ("ag_gemm", "gemm_rs", "all_gather"):
        assert after[k] > before[k]


# ------------------------------------------------------- MoE over a mesh

def _moe_mesh_inputs(seed, dev, w, m_s, topk, e, k, n, block_m, dtype):
    """W shards of ``m_s`` tokens routed over ``e`` experts (expert 1
    empty, expert 0 given several blocks), each shard aligned on its own
    at ``block_m``: x's W (m_s, k) row shards (views of one allocation),
    the stacked (W, cap_s) / (W, cap_s / block_m) tables, and W (e, k, n)
    weight shards."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((w * m_s, e)).astype(np.float32)
    logits[:, 1] = -1e4
    logits[::2, 0] += 6.0
    _, ids = mu.select_experts(torch.from_numpy(logits), topk)
    sti, be, splits = mu.moe_align_block_size(ids.reshape(w, m_s, topk), e,
                                              block_m)
    assert int(splits[:, 1].sum()) == 0 and int((be == 0).sum()) >= w
    x = list(_t(rng.standard_normal((w, m_s, k)), dev, dtype).unbind(0))
    ws = list((_t(rng.standard_normal((w, e, k, n)), dev, dtype)
               / np.sqrt(k)).unbind(0))
    return x, sti.to(dev), be.to(dev), ws


#: (tokens a shard, top-k, experts, K, N, block_m): K and N not multiples
#: of 8, 16-byte rows with several blocks an expert, and the DeepSeek-
#: MoE-16B tp = 4 prefill's up projection (N = F / 4 = 352, 2.75 tiles of
#: 128) at 64 tokens a shard
MOE_MESH_SHAPES = [(60, 2, 6, 70, 33, 64), (150, 2, 8, 136, 72, 64),
                   (64, 6, 64, 2048, 352, 128)]


class TestMoEMeshKernels:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("w", [1, 2, 4])
    @pytest.mark.parametrize("shape", MOE_MESH_SHAPES)
    def test_ag_group_gemm_mesh_matches_plain(self, dev, shape, w, dtype):
        """Every rank's rows of every shard (the token's rank, then its
        sorted row) within f32 summation order (and one bf16 rounding)
        of the plain version, the padding rows exactly zero; one launch
        of ``tdt_ag_group_gemm_mesh`` for all ranks."""
        from triton_distributed_tpu_torch.runtime import Mesh

        m_s, topk, e, k, n, bm = shape
        tdt = getattr(torch, dtype)
        mesh = Mesh.loopback(w, dev)
        x, sti, be, ws = _moe_mesh_inputs(30, dev, w, m_s, topk, e, k, n,
                                          bm, tdt)
        before = launch_counts()
        got = mtf.ag_group_gemm_mesh(x, sti, be, ws, topk, mesh)
        after = launch_counts()
        assert after["ag_group_gemm_mesh"] == (
            before["ag_group_gemm_mesh"] + 1)
        assert sum(after.values()) == sum(before.values()) + 1
        want = mtf.ag_group_gemm_mesh_plain(x, sti, be, ws, topk, mesh,
                                            out_dtype=torch.float32)
        torch.cuda.synchronize()
        pad = sti.reshape(-1) >= m_s * topk
        assert pad.any()
        for g, ref in zip(got, want):
            assert g.dtype == tdt and g.shape == (w * sti.shape[1], n)
            assert ((g.float() - ref).abs()
                    <= _gemm_tol(ref, k, dtype == "bfloat16")).all()
            assert (g[pad] == 0).all()

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("w", [1, 2, 4])
    @pytest.mark.parametrize("shape", MOE_MESH_SHAPES)
    def test_moe_reduce_rs_mesh_matches_plain(self, dev, shape, w, dtype):
        """Rank r's sorted rows summed over the ranks' F shards (here
        F_q = N of the shape, H = its K: the tp = 4 prefill's down K of
        352 a rank): f32 sums over ranks and K in another order than the
        plain version and, in bf16, one rounding; one launch."""
        from triton_distributed_tpu_torch.runtime import Mesh

        m_s, topk, e, h, f, bm = shape
        tdt = getattr(torch, dtype)
        mesh = Mesh.loopback(w, dev)
        _, sti, be, ws = _moe_mesh_inputs(31, dev, w, m_s, topk, e, f, h,
                                          bm, tdt)
        rng = np.random.default_rng(32)
        y = list(_t(rng.standard_normal((w, w * sti.shape[1], f)), dev,
                    tdt).unbind(0))
        before = launch_counts()
        got = mtf.moe_reduce_rs_mesh(y, be, ws, mesh)
        after = launch_counts()
        assert after["moe_reduce_rs_mesh"] == (
            before["moe_reduce_rs_mesh"] + 1)
        assert sum(after.values()) == sum(before.values()) + 1
        want = mtf.moe_reduce_rs_mesh_plain(y, be, ws, mesh,
                                            out_dtype=torch.float32)
        torch.cuda.synchronize()
        for g, ref in zip(got, want):
            assert g.dtype == tdt and g.shape == (sti.shape[1], h)
            assert ((g.float() - ref).abs()
                    <= _gemm_tol(ref, w * f, dtype == "bfloat16")).all()

    def test_wrappers_refuse_what_the_kernels_do_not_take(self, dev):
        from triton_distributed_tpu_torch.runtime import Mesh

        mesh = Mesh.loopback(2, dev)
        x, sti, be, ws = _moe_mesh_inputs(33, dev, 2, 60, 2, 6, 64, 32, 64,
                                          torch.bfloat16)
        with pytest.raises(ValueError, match="int32 tables"):
            mtf.ag_group_gemm_mesh(x, sti.long(), be, ws, 2, mesh)
        with pytest.raises(ValueError, match="operands both"):
            mtf.ag_group_gemm_mesh(x, sti, be, [t.float() for t in ws], 2,
                                   mesh)
        with pytest.raises(ValueError, match="lists of 2"):
            mtf.ag_group_gemm_mesh(x[:1], sti, be, ws, 2, mesh)
        y = [torch.zeros((2 * sti.shape[1] + 1, 64), device=dev,
                         dtype=torch.bfloat16)] * 2
        with pytest.raises(ValueError, match="sorted rows"):
            mtf.moe_reduce_rs_mesh(y, be, ws, mesh)


def _staged_a2a_mesh(dev, w, quant, dtype, seed, skew):
    """Every rank's staged payload and metadata for a seeded routing of
    100 tokens a rank (top-2 over 16 experts, some assignments masked);
    with ``skew`` rank 0 sends every assignment to expert 0, so it
    ships nothing to the other peers."""
    ctx = ma.MoEAllToAllContext(n=w, max_m=200, hidden=96,
                                experts_per_rank=16 // w, dtype=dtype,
                                quant=quant)
    rng = np.random.default_rng(seed)
    flat_e = rng.integers(0, 17, (w, 200)).astype(np.int32)
    if skew:
        flat_e[0] = 0
    flat_e = _t(flat_e, dev)
    x = _t(rng.standard_normal((w, 100, 96)), dev, dtype)
    order = torch.argsort(flat_e, dim=1, stable=True)
    valid = flat_e < 16
    splits = torch.zeros((w, 16), dtype=torch.int32, device=dev)
    splits.scatter_add_(1, torch.clamp(flat_e, 0, 15).long(),
                        valid.to(torch.int32))
    _, offs, offs_al, sendk = md.send_plan(ctx, splits)
    _, dest = md.assignment_dest(ctx, flat_e.gather(1, order), offs, offs_al)
    payload, scales = md.stage_aligned(ctx, x, order // 2, dest,
                                       valid.sum(1))
    meta = md.meta_payload(ctx, splits, scales, offs_al, sendk)
    return ctx, payload, offs_al, sendk, meta


class TestChunkedA2AMesh:
    @pytest.mark.parametrize("skew", [False, True])
    @pytest.mark.parametrize("wire", [("fp8", torch.float32),
                                      ("int8", torch.bfloat16),
                                      (None, torch.bfloat16)])
    @pytest.mark.parametrize("w", [1, 2, 4])
    def test_windows_are_byte_exact(self, dev, w, wire, skew):
        """Both legs, barrier mode and LL mode over two calls (parity 0
        then 1), windows pre-filled with random bytes: every receiver's
        window equals the plain version's byte for byte, the rows past
        the shipped chunks untouched; one launch for all ranks."""
        quant, dtype = wire
        ctx, payload, offs_al, sendk, meta = _staged_a2a_mesh(
            dev, w, quant, dtype, 40, skew)
        a = md.align(ctx)
        sp, mr = md.slot_pad(ctx), md.meta_rows(ctx)
        y = torch.randn((w, w, sp, 96), generator=torch.Generator(
            device=dev).manual_seed(41), device=dev).to(dtype)
        y_tok, y_meta = md.stage_return(ctx, y)
        legs = {
            "dispatch": ((payload, meta.reshape(w, -1, 128),
                          (offs_al // a).to(torch.int32), sendk,
                          torch.zeros_like(sendk)), False),
            # what rank r dispatched to p comes back: r's self slot reads
            # its own sendk (= retk), the others recvk = sendk
            "combine": ((y_tok, y_meta.reshape(w, -1, 128),
                         md._slot_offs(ctx, (w,), dev),
                         sendk.t().contiguous(), sendk), True),
        }
        name = "chunked_a2a" if w == 1 else "chunked_a2a_mesh"
        g = torch.Generator(device=dev).manual_seed(42)
        for leg, (args, know) in legs.items():
            for nw in (1, 2):
                raw = torch.randint(0, 256, (w, nw * w * sp,
                                             96 * ctx.wire_itemsize),
                                    generator=g, device=dev,
                                    dtype=torch.uint8)
                rawm = torch.randint(-2 ** 31, 2 ** 31 - 1,
                                     (w, nw * w * mr, 128), generator=g,
                                     device=dev, dtype=torch.int32)
                got = (raw.clone().view(ctx.wire_dtype), rawm.clone())
                want = (raw.clone().view(ctx.wire_dtype), rawm.clone())
                for par in range(nw):
                    p = torch.tensor([par], dtype=torch.int32, device=dev)
                    before = launch_counts()[name]
                    md.chunked_a2a(ctx, *args, *got, p, know_recv=know)
                    assert launch_counts()[name] == before + 1
                    md.chunked_a2a_plain(ctx, *args, *want, p,
                                         know_recv=know)
                torch.cuda.synchronize()
                assert torch.equal(got[0].view(torch.uint8),
                                   want[0].view(torch.uint8)), (leg, nw)
                assert torch.equal(got[1], want[1]), (leg, nw)
                changed = (got[0].view(torch.uint8) != raw).any(dim=-1)
                rows = torch.arange(nw * w * sp, device=dev)
                for r in range(w):
                    allowed = torch.zeros_like(changed[r])
                    for par in range(nw):
                        for q in range(w):
                            s0 = (par * w + q) * sp
                            # dispatch: sender q's count for r; combine:
                            # what r dispatched to q comes back
                            k = int(sendk[q, r] if leg == "dispatch"
                                    else sendk[r, q])
                            allowed |= (rows >= s0) & (
                                rows < s0 + k * md.chunk_rows(ctx))
                    assert not (changed[r] & ~allowed).any()

    def test_replays_from_a_cuda_graph(self, dev):
        """The peer tables ride the launch's parameters: a CUDA graph of
        the n = 4 dispatch replays it onto the windows it captured."""
        ctx, payload, offs_al, sendk, meta = _staged_a2a_mesh(
            dev, 4, "fp8", torch.bfloat16, 43, False)
        (tshape, tdt), (mshape, _) = md.ll_workspace_shapes(ctx)
        ws = (torch.zeros((4, *tshape), dtype=torch.uint8,
                          device=dev).view(tdt),
              torch.zeros((4, *mshape), dtype=torch.int32, device=dev))
        par = torch.zeros((1,), dtype=torch.int32, device=dev)
        run = lambda: md.dispatch_ll_device(  # noqa: E731
            ctx, payload, offs_al, sendk, meta, par, *ws)
        run()
        torch.cuda.synchronize()
        want = (ws[0].view(torch.uint8).clone(), ws[1].clone())
        ws[0].view(torch.uint8).zero_()
        ws[1].zero_()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            run()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(ws[0].view(torch.uint8), want[0])
        assert torch.equal(ws[1], want[1])

    def test_wrapper_refuses_what_the_kernel_does_not_take(self, dev):
        ctx, payload, offs_al, sendk, meta = _staged_a2a_mesh(
            dev, 2, "fp8", torch.bfloat16, 44, False)
        with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
            md.dispatch_device(ctx, payload[0], offs_al[0], sendk[0],
                               meta[0])
        own = [payload[0].clone(), payload[1].clone()]
        with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
            md.chunked_a2a(ctx, own, meta.reshape(2, -1, 128),
                           (offs_al // md.align(ctx)).to(torch.int32),
                           sendk, sendk, *md._fresh_window(ctx, (2,), dev),
                           torch.zeros((1,), dtype=torch.int32,
                                       device=dev))
        with pytest.raises(ValueError, match="int32"):
            md.chunked_a2a(ctx, payload, meta.reshape(2, -1, 128),
                           (offs_al // md.align(ctx)).long(), sendk, sendk,
                           *md._fresh_window(ctx, (2,), dev),
                           torch.zeros((1,), dtype=torch.int32,
                                       device=dev))


def test_moe_tp4_prefill_generate_on_card_equals_cpu(dev):
    """The tiny DeepSeek-MoE preset as served (EP: fp8 wire, W8A8) and
    its TP flavour at tp = 4 on a loopback mesh, on the card and on the
    CPU from the same weights, B = 3 (not a multiple of 4: the EP
    decode pads): the prefill logits within 1e-4 (f32 GEMMs summed in
    another order), then 6 greedy steps in lockstep, the tokens equal on
    every row while its CPU top-2 margin stays above 1e-2. The card's TP
    prefill launches each mesh MoE-TP kernel once a MoE layer, the EP
    prefill and every EP decode step the all-to-all over the mesh twice
    a MoE layer, and no world-size-1 form runs."""
    from triton_distributed_tpu_torch.models import Transformer, presets
    from triton_distributed_tpu_torch.runtime import Mesh

    for kw in ({}, dict(moe="tp", moe_weight_quant=None,
                        moe_act_quant=None)):
        cfg = presets.tiny(presets.deepseek_moe_16b(**kw))
        one = Transformer(cfg, device="cpu")
        params = one.quantize_moe_weights(one.quantize_dense_weights(
            one.init(torch.Generator().manual_seed(0))))
        rng = np.random.default_rng(0)
        toks = rng.integers(0, cfg.vocab, (3, 16)).astype(np.int32)
        lens = np.array([16, 9, 5], np.int32)
        n_moe = len(cfg.moe_layers)
        runs = []
        for d in ("cpu", dev):
            model = Transformer(cfg, mesh=Mesh.loopback(4, d))
            p = model.shard_params(_to(params, d))
            before = launch_counts()
            last, caches, kl = model.prefill(p, model.init_cache(3, 32),
                                             _t(toks, d), _t(lens, d))
            mid = launch_counts()
            runs.append([model, p, caches, kl, last,
                         model.init_decode_state(3)])
            assert (runs[-1][-1] is None) == (cfg.moe == "tp")
            if d != "cpu":
                want = ({"ag_group_gemm_mesh": n_moe,
                         "moe_reduce_rs_mesh": n_moe} if cfg.moe == "tp"
                        else {"chunked_a2a_mesh": 2 * n_moe})
                for k, v in want.items():
                    assert mid[k] - before[k] == v, k
                for k in ("chunked_a2a", "ag_group_gemm", "moe_reduce_rs"):
                    assert mid[k] == before[k], k
        (mc, pc, cc, kc, lc, sc), (mg, pg, cg, kg, lg, sg) = runs
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
        gate = torch.ones((3,), dtype=torch.bool)
        mid = launch_counts()
        for _ in range(6):
            top2 = torch.topk(lc, 2, dim=-1).values
            gate &= (top2[:, 0] - top2[:, 1]) > 1e-2
            assert gate.any(), "degenerate: every row near-tied"
            tc = torch.argmax(lc, -1).to(torch.int32)
            tg = torch.argmax(lg, -1).to(torch.int32)
            assert torch.equal(tc[gate], tg.cpu()[gate])
            res_c = mc.decode_step(pc, cc, kc, tc, moe_state=sc)
            res_g = mg.decode_step(pg, cg, kg, tg, moe_state=sg)
            (lc, cc, kc), (lg, cg, kg) = res_c[:3], res_g[:3]
            if sc is not None:
                sc, sg = res_c[3], res_g[3]
        after = launch_counts()
        if cfg.moe == "ep":
            assert (after["chunked_a2a_mesh"] - mid["chunked_a2a_mesh"]
                    == 2 * n_moe * 6)
