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


def _w8a8_form(k, n, block_m):
    """The form ``tdt_ggemm_w8a8`` runs on 16-byte aligned tensors."""
    if k % 16:
        return "narrow"
    return "stream" if block_m <= 16 or n % 8 else "tc"


class TestGroupedMatmulKernel:
    @pytest.mark.parametrize("out", ["float32", "bfloat16"])
    @pytest.mark.parametrize("shape", [
        (192, 200, 100, 64, 3), (37, 70, 33, 37, 1), (1100, 96, 40, 1100, 1),
        (768, 256, 384, 64, 3), (512, 256, 320, 128, 3),
        (192, 208, 136, 64, 3), (1, 256, 1024, 1, 1), (8, 4096, 512, 8, 1),
        (16, 1408, 2048, 16, 1), (8, 11008, 96, 8, 1), (8, 70, 64, 8, 1)])
    def test_w8a8_is_exact(self, dev, out, shape):
        """K-major weights, bit for bit against the plain version, and the
        form each shape runs: ``tc`` at 64-row expert blocks (experts in
        sorted order, so one spans several blocks; N 384 and 136, K 208
        in partial stages), at 128-row blocks (N 320) and at one block of
        1100 rows; ``stream`` at M 1, 8 and 16 (K 11008 and 1408 in
        partial 512-k stages, split over the warps); the element-copy
        ``narrow`` form at K 70 and 200. Ragged M, N and K edges."""
        cap, k, n, block_m, e = shape
        x, w, be = _gemm_inputs(0, e, cap, k, n, block_m)
        be = np.sort(be)
        wq, ws = gg.quantize_grouped_weights(_t(w, dev), k_major=True)
        xq, xs = gg.quantize_act_rows(_t(x, dev))
        kw = dict(w_scale=ws, x_scale=xs, out_dtype=getattr(torch, out))
        gg._w8a8_cuda.by_variant.clear()
        before = launch_counts()["ggemm_w8a8"]
        got = gg.grouped_matmul(xq, wq, _t(be, dev), **kw)
        want = gg.grouped_matmul_plain(xq, wq, _t(be, dev), **kw)
        assert launch_counts()["ggemm_w8a8"] == before + 1
        assert gg._w8a8_cuda.by_variant == {_w8a8_form(k, n, block_m): 1}
        torch.testing.assert_close(got, want, rtol=0, atol=0)

    def test_w8a8_refuses_an_n_major_weight(self, dev):
        """The kernels read the weight K-major; an (E, K, N) weight with N
        contiguous raises, naming the layout, and launches nothing."""
        x, w, be = _gemm_inputs(3, 1, 64, 128, 64, 64)
        wq, ws = gg.quantize_grouped_weights(_t(w, dev))
        xq, xs = gg.quantize_act_rows(_t(x, dev))
        before = launch_counts()["ggemm_w8a8"]
        with pytest.raises(ValueError, match="K-major"):
            gg.grouped_matmul(xq, wq, _t(be, dev), w_scale=ws, x_scale=xs)
        assert launch_counts()["ggemm_w8a8"] == before

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
    @pytest.mark.parametrize("shape", [
        (1, 256, 1024, 1, 1), (8, 4096, 512, 8, 1), (16, 2048, 2048, 16, 1),
        (17, 200, 100, 17, 1), (64, 70, 257, 64, 1), (64, 256, 384, 64, 1),
        (192, 200, 100, 64, 3), (192, 256, 384, 64, 3)])
    def test_w8a16_bf16_runs_the_tensor_cores(self, dev, out, shape):
        """bf16 x: the int8 codes widened to bf16 and bf16 products on the
        tensor cores, within :meth:`test_w8a16_matches_plain`'s
        tolerances of the plain version; M of one tile (1, 8, 16) and of
        several (17, 64, 192 over three experts), N and K ragged (N 100
        and 257, K 70 and 200). The 16-byte form (``tc``) where K % 8
        and N % 16 are 0, element-by-element copies (``tc_narrow``)
        otherwise; one launch."""
        cap, k, n, block_m, e = shape
        x, w, be = _gemm_inputs(7, e, cap, k, n, block_m)
        wq, ws = gg.quantize_grouped_weights(_t(w, dev))
        xt = _t(x, dev, torch.bfloat16)
        kw = dict(w_scale=ws, out_dtype=getattr(torch, out))
        gg._w8a16_cuda.by_variant.clear()
        before = launch_counts()["ggemm_w8a16"]
        got = gg.grouped_matmul(xt, wq, _t(be, dev), **kw)
        assert launch_counts()["ggemm_w8a16"] == before + 1
        form = "tc" if k % 8 == 0 and n % 16 == 0 else "tc_narrow"
        assert gg._w8a16_cuda.by_variant == {form: 1}
        want = gg.grouped_matmul_plain(xt, wq, _t(be, dev), **kw)
        tol = 1e-4 if out == "float32" else 1e-2
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)

    def test_w8a16_f32_runs_the_fma_loop(self, dev):
        """f32 x: JAX widens the weight to f32, so f32 products on the
        FMA loop (``fma``)."""
        x, w, be = _gemm_inputs(1, 3, 192, 200, 100, 64)
        wq, ws = gg.quantize_grouped_weights(_t(w, dev))
        gg._w8a16_cuda.by_variant.clear()
        gg.grouped_matmul(_t(x, dev), wq, _t(be, dev), w_scale=ws)
        assert gg._w8a16_cuda.by_variant == {"fma": 1}

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
        """The expert layout: 64 experts, many 64-row blocks, on the
        ``wgmma`` tiles."""
        x, w, be = _gemm_inputs(7, 64, 64 * 40, 256, 192, 64)
        wq, ws = gg.quantize_grouped_weights(_t(w, dev), k_major=True)
        xq, xs = gg.quantize_act_rows(_t(x, dev))
        kw = dict(w_scale=ws, x_scale=xs, out_dtype=torch.bfloat16)
        gg._w8a8_cuda.by_variant.clear()
        got = gg.grouped_matmul(xq, wq, _t(be, dev), **kw)
        want = gg.grouped_matmul_plain(xq, wq, _t(be, dev), **kw)
        assert gg._w8a8_cuda.by_variant == {"tc": 1}
        torch.testing.assert_close(got, want, rtol=0, atol=0)

    def test_wrapper_refuses_what_the_kernel_does_not_take(self, dev):
        x, w, be = _gemm_inputs(2, 2, 128, 64, 32, 32)
        wq, ws = gg.quantize_grouped_weights(_t(w, dev), k_major=True)
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
                    gg.quantize_grouped_weights(w, k_major=True)
                    for w in (u, dn)))
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


# ------------------------------------------------------- quantized wires

def _gemm_tol_rows(want, k, bf16_out):
    """:func:`_gemm_tol` with the summation term taken per row, so that
    an outlier row (x1000) does not loosen the limit of the others."""
    return ((2.0 ** -8 * want.abs() if bf16_out else 0.0)
            + 1e-5 * np.sqrt(k) * want.abs().amax(1, keepdim=True))


def _wire_shards(dev, w, rows, cols, dtype, seed, separate=False):
    """W (rows, cols) shards with an outlier row (x1000) in shard 0 and
    a chunk of zeros at the end of the last shard: views of one
    allocation, or (``separate``) tensors of their own."""
    rng = np.random.default_rng(seed)
    full = rng.standard_normal((w, rows, cols)).astype(np.float32)
    full[0, 1] *= 1000.0
    full[-1, -min(rows, 8):] = 0.0
    full = _t(full, dev, dtype)
    if separate:
        return [full[r].clone() for r in range(w)]
    return list(full.unbind(0))


def test_quantizers_round_as_on_the_cpu(dev):
    """Every quantizer gives the card the CPU's scales and codes bit for
    bit (the CPU's are JAX's: tests/test_torch_wire.py and the parity
    files). PyTorch's CUDA division by a Python scalar multiplies by the
    reciprocal, which rounded half the scales apart in the last bit
    before ``config.div_scalar``."""
    from triton_distributed_tpu_torch.lang import wire as tw

    g = torch.Generator().manual_seed(41)
    x = torch.randn((64, 512), generator=g) * 3.0
    w = torch.randn((3, 64, 96), generator=g)
    ctx = {q: ma.MoEAllToAllContext(n=1, max_m=64, hidden=512,
                                    experts_per_rank=2, quant=q)
           for q in ("fp8", "int8")}
    fmt = {q: tw.make_wire_format(q, 64) for q in ("fp8", "int8")}
    cases = [("quantize_act_rows", gg.quantize_act_rows, (x,)),
             ("quantize_grouped_weights", gg.quantize_grouped_weights, (w,)),
             ("quantize_kv", quantize_kv, (x.reshape(2, 4, 16, 256),)),
             ("quantize_cols", tw.quantize_cols, (x,))]
    for q in ("fp8", "int8"):
        cases += [(f"quantize_rows {q}", lambda t, q=q: ma.quantize_rows(
                      ctx[q], t), (x,)),
                  (f"quantize_slab {q}", lambda t, q=q: tw.quantize_slab(
                      t, fmt[q]), (x,))]
    for name, fn, args in cases:
        want = fn(*args)
        got = fn(*(a.to(dev) for a in args))
        for gt, wt in zip(got, want):
            gt = gt.cpu()
            if gt.dtype == torch.float8_e4m3fn:
                gt, wt = gt.view(torch.uint8), wt.view(torch.uint8)
            assert torch.equal(gt, wt), name


class TestWireKernels:
    """The quantized-wire kernels against their plain versions, at small
    shapes: 16-byte rows and ragged ones (the scalar paths), one and
    several chunks a shard, an outlier row and a zero chunk."""

    @pytest.mark.parametrize("chunk", [None, 1])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("quant", ["fp8", "int8"])
    @pytest.mark.parametrize("shape", [(96, 72), (40, 70)])
    def test_quantize_is_byte_exact(self, dev, shape, quant, dtype, chunk):
        """``tdt_quantize_slab`` over every shard: codes and scales equal
        ``lang.wire.quantize_slab``'s byte for byte (chunks of 32 / 40
        rows, or one row)."""
        from triton_distributed_tpu_torch.lang import wire as tw

        rows, cols = shape
        x = _wire_shards(dev, 3, rows, cols, getattr(torch, dtype), 30,
                         separate=True)
        fmt = (tw.make_wire_format(quant, rows) if chunk is None
               else tw.WireFormat(quant, chunk))
        from triton_distributed_tpu_torch.kernels import wire as wk

        before = launch_counts()["wire_quantize"]
        q, s = wk.quantize_shards(x, fmt)
        assert launch_counts()["wire_quantize"] == before + 1
        torch.cuda.synchronize()
        for r, xr in enumerate(x):
            wq, ws = tw.quantize_slab(xr, fmt)
            assert torch.equal(q[r].view(torch.uint8), wq.view(torch.uint8))
            assert torch.equal(s[r], ws)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("wire", ["fp8", "int8"])
    @pytest.mark.parametrize("w", [2, 4])
    @pytest.mark.parametrize("shape", [(37, 72, 40), (64, 70, 136)])
    def test_ag_gemm_w_matches_plain(self, dev, shape, w, wire, dtype):
        """Rank r's own shard exact, its peers' dequantized: the same A
        as the plain version, so f32 summation order (per row) and one
        bf16 rounding apart; two launches counted, the quantizer's
        (``wire_quantize``) and the product's (``ag_gemm_wire``)."""
        from triton_distributed_tpu_torch.runtime import Mesh

        m, k, n = shape
        tdt = getattr(torch, dtype)
        mesh = Mesh.loopback(w, dev)
        a = _wire_shards(dev, w, m, k, tdt, 31)
        rng = np.random.default_rng(32)
        b = [x / np.sqrt(k) for x in _mesh_shards(rng, dev, w, (k, n), tdt,
                                                  False)]
        before = launch_counts()
        got = agm.ag_gemm(a, b, mesh, wire_dtype=wire)
        after = launch_counts()
        assert after["ag_gemm_wire"] == before["ag_gemm_wire"] + 1
        assert after["wire_quantize"] == before["wire_quantize"] + 1
        assert sum(after.values()) == sum(before.values()) + 2
        want = agm.ag_gemm_plain(a, b, mesh, out_dtype=torch.float32,
                                 wire=wire)
        torch.cuda.synchronize()
        for g, ref in zip(got, want):
            assert g.dtype == tdt and g.shape == (w * m, n)
            assert ((g.float() - ref).abs()
                    <= _gemm_tol_rows(ref, k, dtype == "bfloat16")).all()

    @pytest.mark.parametrize("out", ["float32", "bfloat16"])
    @pytest.mark.parametrize("w", [2, 4])
    @pytest.mark.parametrize("shape", [(37, 72, 40), (64, 256, 136)])
    def test_ag_gemm_mx_is_exact(self, dev, shape, w, out):
        """s32 sums are exact in any order and the epilogue is the plain
        version's, (acc · row scale) · column scale: bit for bit (K 72:
        the byte loads; K 256: 16-byte rows, N past one 128-wide tile)."""
        from triton_distributed_tpu_torch.runtime import Mesh

        m, k, n = shape
        mesh = Mesh.loopback(w, dev)
        a = _wire_shards(dev, w, m, k, torch.bfloat16, 33)
        rng = np.random.default_rng(34)
        b = _mesh_shards(rng, dev, w, (k, n), torch.bfloat16, False)
        kw = dict(out_dtype=getattr(torch, out))
        before = launch_counts()["ag_gemm_mx"]
        got = agm.ag_gemm(a, b, mesh, wire_dtype="int8-mxu", **kw)
        assert launch_counts()["ag_gemm_mx"] == before + 1
        want = agm.ag_gemm_plain(a, b, mesh, wire="int8-mxu", **kw)
        torch.cuda.synchronize()
        for g, ref in zip(got, want):
            torch.testing.assert_close(g, ref, rtol=0, atol=0)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("wire", ["fp8", "int8"])
    @pytest.mark.parametrize("w", [2, 4])
    @pytest.mark.parametrize("shape", [(32, 50, 196), (64, 136, 72)])
    def test_gemm_rs_w(self, dev, shape, w, wire, dtype):
        """The partials (``tdt_gemm_rs_partials``) within f32 summation
        order (per row) and one rounding of the plain partials; the fold
        (``tdt_gemm_rs_fold``) on the kernel's own partials equals the
        plain fold of them bit for bit, and so does the whole wire, one
        launch of each kernel."""
        from triton_distributed_tpu_torch.lang import wire as tw
        from triton_distributed_tpu_torch.runtime import Mesh

        m, k, n = shape
        tdt = getattr(torch, dtype)
        mesh = Mesh.loopback(w, dev)
        rng = np.random.default_rng(35)
        a = _mesh_shards(rng, dev, w, (w * m, k), tdt, False)
        a[0][3] *= 1000.0
        b = [x / np.sqrt(w * k) for x in _mesh_shards(rng, dev, w, (k, n),
                                                      tdt, False)]
        fmt = tw.make_wire_format(wire, m)
        parts = grs.gemm_rs_partials(a, b, mesh, tdt)
        folded = grs.gemm_rs_fold(parts, mesh, fmt, tdt)
        before = launch_counts()
        got = grs.gemm_rs(a, b, mesh, wire_dtype=wire)
        after = launch_counts()
        assert after["gemm_rs_wire"] == before["gemm_rs_wire"] + 1
        assert after["gemm_rs_fold"] == before["gemm_rs_fold"] + 1
        assert sum(after.values()) == sum(before.values()) + 2
        want = grs.gemm_rs_fold_plain(parts, fmt, tdt)
        torch.cuda.synchronize()
        for p, aq, bq in zip(parts, a, b):
            ref = aq.float() @ bq.float()
            assert p.dtype == tdt and p.shape == (w * m, n)
            assert ((p.float() - ref).abs()
                    <= _gemm_tol_rows(ref, k, dtype == "bfloat16")).all()
        for d in range(w):
            assert got[d].dtype == tdt and got[d].shape == (m, n)
            assert torch.equal(folded[d], want[d])
            assert torch.equal(got[d], want[d])

    @pytest.mark.parametrize("separate", [False, True])
    @pytest.mark.parametrize("wire", ["fp8", "int8"])
    @pytest.mark.parametrize("w", [2, 4])
    @pytest.mark.parametrize("shape", [(13, 520, "bfloat16"),
                                       (16, 700, "float32")])
    def test_all_gather_w_is_byte_exact(self, dev, shape, w, wire, separate):
        """Every rank's result equals the plain version's byte for byte:
        its own shard exact, the peers' per-row codes · scale."""
        from triton_distributed_tpu_torch.runtime import Mesh

        m, cols, dtype = shape
        mesh = Mesh.loopback(w, dev)
        x = _wire_shards(dev, w, m, cols, getattr(torch, dtype), 36,
                         separate)
        before = launch_counts()["all_gather_wire"]
        got = ag.all_gather(x, mesh, wire_dtype=wire)
        assert launch_counts()["all_gather_wire"] == before + 1
        want = ag.all_gather_plain(x, mesh, wire=wire)
        torch.cuda.synchronize()
        for r, (g, ref) in enumerate(zip(got, want)):
            assert torch.equal(g, ref)
            assert torch.equal(g[r * m:(r + 1) * m], x[r])

    def test_wires_on_the_card_never_run_the_plain_versions(self, dev,
                                                            monkeypatch):
        """Every wire on CUDA tensors launches its kernel: with the plain
        versions and the plain quantizer made to raise, each op counts
        exactly one launch of its wire kernel and nothing else."""
        from triton_distributed_tpu_torch import ops
        from triton_distributed_tpu_torch.lang import wire as tw
        from triton_distributed_tpu_torch.runtime import Mesh

        def boom(*a, **k):
            raise AssertionError("a plain version ran on CUDA tensors")

        for mod, name in ((agm, "ag_gemm_plain"),
                          (agm, "ag_gemm_wired_plain"),
                          (grs, "gemm_rs_plain"), (grs, "gemm_rs_fold_plain"),
                          (grs, "wire_fold_plain"), (ag, "all_gather_plain"),
                          (ag, "all_gather_wired_plain"),
                          (grs, "gemm_rs_mx_plain"),
                          (grs, "mx_partials_plain"),
                          (grs, "mxw_fold_plain"),
                          (ag, "all_gather_bidir_plain"),
                          (tw, "quantize_slab"), (tw, "dequantize_slab")):
            monkeypatch.setattr(mod, name, boom)
        mesh = Mesh.loopback(4, dev)
        x = _wire_shards(dev, 4, 64, 256, torch.bfloat16, 37)
        up = [t / 16 for t in _wire_shards(dev, 4, 256, 128, torch.bfloat16,
                                           38)]
        down = [t / 16 for t in _wire_shards(dev, 4, 128, 256,
                                             torch.bfloat16, 39)]
        # the down projection (N 256) blocks to one out tile, so
        # int8-mxu runs the s8 producer and the accumulator epilogue's
        # fold (JAX's _fused_kernel_mxw), with a second quantizer launch
        # for the GEMM-RS's A; fp8 and int8 run the partials and the fold
        wired = {"wire_quantize": 1, "ag_gemm_wire": 1, "gemm_rs_wire": 1,
                 "gemm_rs_fold": 1}
        for wire, want in (("fp8", wired), ("int8", wired),
                           ("int8-mxu", {"wire_quantize": 2, "ag_gemm_mx": 1,
                                         "gemm_rs_mx": 1,
                                         "gemm_rs_mxw_fold": 1})):
            ctx = ops.OverlapContext(mesh, "tp", wire_dtype=wire)
            before = launch_counts()
            h = ops.ag_gemm(x, up, ctx)
            y = ops.gemm_rs(h, down, ctx)
            after = launch_counts()
            moved = {k: after[k] - before[k] for k in after
                     if after[k] != before[k]}
            assert moved == want
            assert all(t.isfinite().all() for t in y)
        # 'auto' on the ring: 128 KiB shards stay raw, 256 KiB go on
        # fp8; with no method, 256 KiB stay raw at 4 ranks (JAX's pick,
        # the bidirectional ring, carries no wire and runs its kernel)
        from triton_distributed_tpu_torch.runtime import AllGatherMethod

        xa = _wire_shards(dev, 4, 64, 1024, torch.bfloat16, 40)
        xb = [t.repeat(2, 1) for t in xa]
        ring = AllGatherMethod.RING_1D
        before = launch_counts()
        ag.all_gather(xa, mesh, method=ring, wire_dtype="auto")
        ag.all_gather(xb, mesh, method=ring, wire_dtype="auto")
        ag.all_gather(xb, mesh, wire_dtype="auto")
        after = launch_counts()
        assert after["all_gather"] == before["all_gather"] + 1
        assert after["all_gather_bidir"] == before["all_gather_bidir"] + 1
        assert after["all_gather_wire"] == before["all_gather_wire"] + 1
        assert after["wire_quantize"] == before["wire_quantize"] + 1


class TestWgmmaGemm:
    """The warpgroup GEMM (``csrc/wg_gemm.cuh``: ``wgmma`` fed by TMA) of
    the wire AG-GEMM and the GEMM-RS wire's partials, at shapes that take
    it (m a multiple of 128 rows), and of the bf16 AG-GEMM and GEMM-RS
    over a mesh and at world size 1, at any row count: a ragged N, a K
    tail past a 64-deep stage, 1, 2 and 4 ranks, an outlier row (x1000)
    in shard 0 and zero rows at the end of the last shard, bf16 and f32
    outputs. Each launch must report the ``wgmma`` form."""

    @pytest.mark.parametrize("out", ["bfloat16", "float32"])
    @pytest.mark.parametrize("k", [200, 1024])
    @pytest.mark.parametrize("m", [128, 200, 2016])
    @pytest.mark.parametrize("w", [1, 2, 4])
    def test_ag_gemm_wgmma_matches_plain(self, dev, w, m, k, out):
        """``tdt_ag_gemm`` with every shard tiled on its own (m 200 and
        2016: a partial last tile a shard, whose rows past m TMA fills
        with zeros and the epilogue never stores) and K 200 (a K tail):
        every rank's gathered product within f32 summation order (per
        row) and one rounding of the plain version; the last shard's zero
        rows give exact zeros; one launch, on ``wgmma``."""
        from triton_distributed_tpu_torch.runtime import Mesh

        odt, n = getattr(torch, out), 136
        mesh = Mesh.loopback(w, dev)
        a = _wire_shards(dev, w, m, k, torch.bfloat16, 57)
        rng = np.random.default_rng(58)
        b = [x / np.sqrt(k) for x in _mesh_shards(rng, dev, w, (k, n),
                                                  torch.bfloat16, False)]
        agm._ag_gemm_mesh_cuda.by_variant.clear()
        got = agm.ag_gemm(a, b, mesh, out_dtype=odt)
        assert agm._ag_gemm_mesh_cuda.by_variant == {"wgmma": 1}
        want = agm.ag_gemm_plain(a, b, mesh, out_dtype=torch.float32)
        torch.cuda.synchronize()
        for g, ref in zip(got, want):
            assert g.dtype == odt and g.shape == (w * m, n)
            assert ((g.float() - ref).abs()
                    <= _gemm_tol_rows(ref, k, out == "bfloat16")).all()
            assert torch.equal(g[-8:], torch.zeros_like(g[-8:]))

    @pytest.mark.parametrize("out", ["bfloat16", "float32"])
    @pytest.mark.parametrize("k", [200, 1024])
    @pytest.mark.parametrize("m", [128, 200, 2016])
    @pytest.mark.parametrize("w", [1, 2, 4])
    def test_gemm_rs_wgmma_matches_plain(self, dev, w, m, k, out):
        """``tdt_gemm_rs``: destination r's m rows summed over the w ranks'
        parts of K 200 (a K tail in every part) or 1024 in the f32
        accumulators, rounded once (m 200 and 2016: a partial last tile,
        which reads rank r + 1's rows and stores none of them): within
        f32 summation order over ranks and K (per row) and one rounding
        of the plain version; one launch, on ``wgmma``."""
        from triton_distributed_tpu_torch.runtime import Mesh

        odt, n = getattr(torch, out), 136
        mesh = Mesh.loopback(w, dev)
        a = _wire_shards(dev, w, w * m, k, torch.bfloat16, 59)
        rng = np.random.default_rng(60)
        b = [x / np.sqrt(w * k) for x in _mesh_shards(
            rng, dev, w, (k, n), torch.bfloat16, False)]
        grs._gemm_rs_mesh_cuda.by_variant.clear()
        got = grs.gemm_rs(a, b, mesh, out_dtype=odt)
        assert grs._gemm_rs_mesh_cuda.by_variant == {"wgmma": 1}
        want = grs.gemm_rs_plain(a, b, mesh, out_dtype=torch.float32)
        torch.cuda.synchronize()
        for g, ref in zip(got, want):
            assert g.dtype == odt and g.shape == (m, n)
            assert ((g.float() - ref).abs()
                    <= _gemm_tol_rows(ref, w * k, out == "bfloat16")).all()

    @pytest.mark.parametrize("out", ["bfloat16", "float32"])
    @pytest.mark.parametrize("shape", [(8192, 1024, 1024), (8064, 200, 136),
                                       (8000, 1024, 136), (200, 136, 72)])
    @pytest.mark.parametrize("op", ["ag_gemm_n1", "gemm_rs_n1"])
    def test_n1_wgmma_matches_plain(self, dev, op, shape, out):
        """(M, K, N) at world size 1 (``ag_gemm`` / ``gemm_rs`` on
        tensors), the mesh entry on a one-rank table: M 8192 (the
        prefill's), 8064 (whole tiles, K 200: a K tail), 8000 and 200 (a
        partial last tile), within f32 summation order (per row) and one
        rounding of the plain version; one launch on its own counter, on
        ``wgmma``."""
        m, k, n = shape
        odt = getattr(torch, out)
        rng = np.random.default_rng(61)
        a = _t(rng.standard_normal((m, k)), dev, torch.bfloat16)
        b = _t(rng.standard_normal((k, n)) / np.sqrt(k), dev, torch.bfloat16)
        fn, wrap = ((agm.ag_gemm, agm._ag_gemm_cuda) if op == "ag_gemm_n1"
                    else (grs.gemm_rs, grs._gemm_rs_cuda))
        wrap.by_variant.clear()
        before = launch_counts()
        got = fn(a, b, out_dtype=odt)
        after = launch_counts()
        assert after[op] == before[op] + 1
        assert sum(after.values()) == sum(before.values()) + 1
        assert wrap.by_variant == {"wgmma": 1}
        want = agm.ag_gemm_plain(a, b, out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert got.dtype == odt and got.shape == (m, n)
        assert ((got.float() - want).abs()
                <= _gemm_tol_rows(want, k, out == "bfloat16")).all()

    def test_f32_and_unaligned_keep_the_tile_loops(self, dev):
        """f32 operands run the FMA loops of ``tdt_ag_gemm`` /
        ``tdt_gemm_rs`` (over a mesh and on a one-rank table at world size
        1) and bf16 rows that are not whole 16-byte pieces (K 70) the
        ``mma.sync`` loops; each wrapper tallies the form it ran."""
        from triton_distributed_tpu_torch.runtime import Mesh

        mesh = Mesh.loopback(2, dev)
        rng = np.random.default_rng(62)
        for dtype, k, form in ((torch.float32, 64, "fma"),
                               (torch.bfloat16, 70, "mma_sync")):
            a = _mesh_shards(rng, dev, 2, (64, k), dtype, False)
            b = _mesh_shards(rng, dev, 2, (k, 72), dtype, False)
            for wrap in (agm._ag_gemm_mesh_cuda, grs._gemm_rs_mesh_cuda,
                         agm._ag_gemm_cuda, grs._gemm_rs_cuda):
                wrap.by_variant.clear()
            agm.ag_gemm(a, b, mesh)
            grs.gemm_rs(a, b, mesh)
            agm.ag_gemm(a[0], b[0])
            grs.gemm_rs(a[0], b[0])
            torch.cuda.synchronize()
            for wrap in (agm._ag_gemm_mesh_cuda, grs._gemm_rs_mesh_cuda,
                         agm._ag_gemm_cuda, grs._gemm_rs_cuda):
                assert wrap.by_variant == {form: 1}

    @pytest.mark.parametrize("out", ["bfloat16", "float32"])
    @pytest.mark.parametrize("wire", ["fp8", "int8"])
    @pytest.mark.parametrize("w", [1, 2, 4])
    @pytest.mark.parametrize("shape", [(128, 208, 136, 64),
                                       (256, 512, 2752, 1)])
    def test_ag_gemm_w_wgmma_matches_plain(self, dev, shape, w, wire, out):
        """(m, K, N, chunk rows): rank r's own tiles from its bf16 shard, a
        peer's from its codes converted in registers; against the plain
        version on the same codes, within f32 summation order (per row)
        and one rounding of the output; a zero row of A gives an exact
        zero row."""
        from triton_distributed_tpu_torch.kernels import wire as wk
        from triton_distributed_tpu_torch.lang import wire as tw
        from triton_distributed_tpu_torch.runtime import Mesh

        m, k, n, cr = shape
        odt = getattr(torch, out)
        mesh = Mesh.loopback(w, dev)
        a = _wire_shards(dev, w, m, k, torch.bfloat16, 51)
        rng = np.random.default_rng(52)
        b = [x / np.sqrt(k) for x in _mesh_shards(rng, dev, w, (k, n),
                                                  torch.bfloat16, False)]
        fmt = tw.WireFormat(wire, cr)
        q, sc = wk.quantize_shards(a, fmt)
        agm.ag_gemm_w_launch.by_variant.clear()
        got = agm.ag_gemm_w_launch(a, q, sc, b, mesh, fmt, odt)
        assert agm.ag_gemm_w_launch.by_variant == {"wgmma": 1}
        want = agm.ag_gemm_wired_plain(a, list(zip(q, sc)), b, fmt,
                                       torch.float32)
        torch.cuda.synchronize()
        for g, ref in zip(got, want):
            assert g.dtype == odt and g.shape == (w * m, n)
            assert ((g.float() - ref).abs()
                    <= _gemm_tol_rows(ref, k, out == "bfloat16")).all()
            # the last shard's zero rows (the output is in gathered order)
            assert torch.equal(g[-8:], torch.zeros_like(g[-8:]))

    @pytest.mark.parametrize("out", ["bfloat16", "float32"])
    @pytest.mark.parametrize("w", [1, 2, 4])
    @pytest.mark.parametrize("shape", [(128, 200, 136), (128, 2752, 512)])
    def test_gemm_rs_partials_wgmma(self, dev, shape, w, out):
        """(m, K, N): every rank's A_r @ B_r within f32 summation order
        (per row) and one rounding; the fold of the kernel's partials on
        fp8 and int8 equals the plain fold of them bit for bit, and so
        does the whole wire (from 2 ranks)."""
        from triton_distributed_tpu_torch.lang import wire as tw
        from triton_distributed_tpu_torch.runtime import Mesh

        m, k, n = shape
        odt = getattr(torch, out)
        mesh = Mesh.loopback(w, dev)
        a = _wire_shards(dev, w, w * m, k, torch.bfloat16, 53)
        rng = np.random.default_rng(54)
        b = [x / np.sqrt(w * k) for x in _mesh_shards(
            rng, dev, w, (k, n), torch.bfloat16, False)]
        grs.gemm_rs_partials.by_variant.clear()
        parts = grs.gemm_rs_partials(a, b, mesh, odt)
        assert grs.gemm_rs_partials.by_variant == {"wgmma": 1}
        torch.cuda.synchronize()
        for p, aq, bq in zip(parts, a, b):
            ref = aq.float() @ bq.float()
            assert p.dtype == odt and p.shape == (w * m, n)
            assert ((p.float() - ref).abs()
                    <= _gemm_tol_rows(ref, k, out == "bfloat16")).all()
        assert torch.equal(parts[-1][-8:], torch.zeros_like(parts[-1][-8:]))
        for wire in ("fp8", "int8"):
            fmt = tw.make_wire_format(wire, m)
            folded = grs.gemm_rs_fold(parts, mesh, fmt, odt)
            want = grs.gemm_rs_fold_plain(parts, fmt, odt)
            whole = (grs.gemm_rs(a, b, mesh, wire_dtype=wire,
                                 out_dtype=odt) if w > 1 else want)
            torch.cuda.synchronize()
            for d in range(w):
                assert torch.equal(folded[d], want[d])
                assert torch.equal(whole[d], want[d])
        assert grs.gemm_rs_partials.by_variant == {"wgmma": 1 + (w > 1) * 2}

    def test_form_follows_alignment(self, dev):
        """The same shape on shards one 16-byte piece off their boundary
        (views 8 bytes in) takes the tile loops; aligned, the warpgroup
        GEMM; both within the same tolerance."""
        from triton_distributed_tpu_torch.kernels import wire as wk
        from triton_distributed_tpu_torch.lang import wire as tw
        from triton_distributed_tpu_torch.runtime import Mesh

        w, m, k, n = 2, 128, 256, 256
        mesh = Mesh.loopback(w, dev)
        a = _wire_shards(dev, w, m, k, torch.bfloat16, 55)
        rng = np.random.default_rng(56)
        b = [x / 16 for x in _mesh_shards(rng, dev, w, (k, n),
                                          torch.bfloat16, True)]
        off = [torch.empty(k * n + 4, dtype=torch.bfloat16, device=dev)
               [4:].view(k, n) for _ in b]
        for o, x in zip(off, b):
            o.copy_(x)
        fmt = tw.WireFormat("fp8", 64)
        q, sc = wk.quantize_shards(a, fmt)
        want = agm.ag_gemm_wired_plain(a, list(zip(q, sc)), b, fmt,
                                       torch.float32)
        for bb, form in ((b, "wgmma"), (off, "mma_sync")):
            agm.ag_gemm_w_launch.by_variant.clear()
            got = agm.ag_gemm_w_launch(a, q, sc, bb, mesh, fmt,
                                       torch.bfloat16)
            assert agm.ag_gemm_w_launch.by_variant == {form: 1}
            torch.cuda.synchronize()
            for g, ref in zip(got, want):
                assert ((g.float() - ref).abs()
                        <= _gemm_tol_rows(ref, k, True)).all()


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


class TestMoEWireKernels:
    """The MoE-TP wire kernels against their plain versions at
    ``MOE_MESH_SHAPES`` (the last one the DeepSeek-MoE-16B tp = 4
    prefill's up projection at 64 tokens a shard: fp8 / int8 chunks of 64
    sorted rows, int8-mxu of 128), token 1 of shard 0 x1000."""

    @staticmethod
    def _inputs(seed, dev, w, shape, dtype):
        m_s, topk, e, k, n, bm = shape
        x, sti, be, ws = _moe_mesh_inputs(seed, dev, w, m_s, topk, e, k, n,
                                          bm, dtype)
        x[0][1] *= 1000.0
        return x, sti, be, ws

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("wire", ["fp8", "int8"])
    @pytest.mark.parametrize("w", [2, 4])
    @pytest.mark.parametrize("shape", MOE_MESH_SHAPES)
    def test_ag_group_gemm_w_matches_plain(self, dev, shape, w, wire, dtype):
        """The sorted slabs' codes and scales (one ``tdt_quantize_slab``
        launch) equal the plain quantizer's byte for byte; rank r's own
        rows exact and its peers' dequantized are the plain version's A,
        so ``tdt_ag_group_gemm_w`` is within f32 summation order (per
        row) and one bf16 rounding of it; the padding rows exactly 0."""
        from triton_distributed_tpu_torch.kernels import wire as wk
        from triton_distributed_tpu_torch.runtime import Mesh

        topk = shape[1]
        tdt = getattr(torch, dtype)
        mesh = Mesh.loopback(w, dev)
        x, sti, be, ws = self._inputs(40, dev, w, shape, tdt)
        cap_s = sti.shape[1]
        fmt = mtf._wire_fmt(wire, cap_s)
        before = launch_counts()
        q, s, kept = mtf.quantize_sorted(x, sti, topk, fmt)
        got = mtf.ag_group_gemm_mesh_w(x, q, s, sti, be, ws, topk, mesh, fmt,
                                       slabs=kept)
        after = launch_counts()
        assert after["wire_quantize"] == before["wire_quantize"] + 1
        assert after["ag_group_gemm_wire"] == (
            before["ag_group_gemm_wire"] + 1)
        assert sum(after.values()) == sum(before.values()) + 2
        slabs = [mu.gather_sorted(xr, sr, topk) for xr, sr in zip(x, sti)]
        wq, wsc = wk.quantize_shards_plain(slabs, fmt)
        want = mtf.ag_group_gemm_mesh_w_plain(x, q, s, sti, be, ws, topk,
                                              mesh, fmt,
                                              out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert torch.equal(kept, torch.stack(slabs))
        assert torch.equal(q.view(torch.uint8), wq.view(torch.uint8))
        assert torch.equal(s, wsc)
        pad = sti.reshape(-1) >= shape[0] * topk
        assert pad.any()
        for g, ref in zip(got, want):
            assert g.dtype == tdt and g.shape == (w * cap_s, shape[4])
            assert ((g.float() - ref).abs()
                    <= _gemm_tol_rows(ref, shape[3],
                                      dtype == "bfloat16")).all()
            assert (g[pad] == 0).all()

    @pytest.mark.parametrize("out", ["float32", "bfloat16"])
    @pytest.mark.parametrize("w", [1, 2, 4])
    @pytest.mark.parametrize("shape", MOE_MESH_SHAPES)
    def test_ag_group_gemm_mx_is_exact(self, dev, shape, w, out):
        """s32 sums are exact in any order and the epilogue is the plain
        version's, acc · (row scale · column scale): bit for bit, the
        padding rows 0 (K 70 / 136: the byte loads; K 2048: 16-byte
        rows). One rank is the one-rank form."""
        from triton_distributed_tpu_torch.runtime import Mesh

        topk, bm = shape[1], shape[5]
        mesh = Mesh.loopback(w, dev)
        x, sti, be, ws = self._inputs(41, dev, w, shape, torch.bfloat16)
        fmt = mtf._wire_fmt("int8-mxu", sti.shape[1], bm)
        q, s = mtf.quantize_sorted(x, sti, topk, fmt)[:2]
        wq, wsc = mtf.quantize_expert_shards(ws)
        kw = dict(out_dtype=getattr(torch, out))
        before = launch_counts()["ag_group_gemm_mx"]
        if w == 1:
            got = [mtf.ag_group_gemm_mx(q[0], s[0], be[0], wq[0], wsc[0],
                                        **kw)]
        else:
            got = mtf.ag_group_gemm_mesh_mx(q, s, be, wq, wsc, mesh, **kw)
        assert launch_counts()["ag_group_gemm_mx"] == before + 1
        want = mtf.ag_group_gemm_mesh_mx_plain(q, s, be, wq, wsc, mesh, **kw)
        torch.cuda.synchronize()
        pad = sti.reshape(-1) >= shape[0] * topk
        for g, ref in zip(got, want):
            torch.testing.assert_close(g, ref, rtol=0, atol=0)
            assert (g[pad] == 0).all()

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("wire", ["fp8", "int8"])
    @pytest.mark.parametrize("w", [2, 4])
    @pytest.mark.parametrize("shape", MOE_MESH_SHAPES)
    def test_moe_reduce_rs_w(self, dev, shape, w, wire, dtype):
        """The partials (``tdt_moe_reduce_rs_partials``) within f32
        summation order (per row) and one rounding of the plain partials;
        the fold on the kernel's own partials equals the plain fold of
        them bit for bit, and so does the whole wire, one launch of each
        kernel (here F_q = N of the shape, H = its K)."""
        from triton_distributed_tpu_torch.runtime import Mesh

        m_s, topk, e, h, f, bm = shape
        tdt = getattr(torch, dtype)
        mesh = Mesh.loopback(w, dev)
        _, sti, be, ws = _moe_mesh_inputs(42, dev, w, m_s, topk, e, f, h, bm,
                                          tdt)
        cap_s = sti.shape[1]
        rng = np.random.default_rng(43)
        yf = rng.standard_normal((w, w * cap_s, f))
        yf[0, 5] *= 1000.0
        y = list(_t(yf, dev, tdt).unbind(0))
        fmt = mtf._wire_fmt(wire, cap_s)
        parts = mtf.moe_reduce_rs_partials(y, be, ws, mesh)
        folded = mtf.moe_reduce_rs_fold(parts, mesh, fmt, tdt)
        before = launch_counts()
        got = mtf.moe_reduce_rs_mesh_w(y, be, ws, mesh, fmt)
        after = launch_counts()
        assert after["moe_reduce_rs_wire"] == (
            before["moe_reduce_rs_wire"] + 1)
        assert after["moe_reduce_rs_fold"] == (
            before["moe_reduce_rs_fold"] + 1)
        assert sum(after.values()) == sum(before.values()) + 2
        ref_parts = mtf.moe_reduce_rs_partials_plain(y, be, ws, mesh,
                                                     out_dtype=torch.float32)
        want = grs.gemm_rs_fold_plain(parts, fmt, tdt)
        torch.cuda.synchronize()
        for p, ref in zip(parts, ref_parts):
            assert p.dtype == tdt and p.shape == (w * cap_s, h)
            assert ((p.float() - ref).abs()
                    <= _gemm_tol_rows(ref, f, dtype == "bfloat16")).all()
        for d in range(w):
            assert got[d].shape == (cap_s, h)
            assert torch.equal(folded[d], want[d])
            assert torch.equal(got[d], want[d])

    @pytest.mark.parametrize("wire", ["fp8", "int8", "int8-mxu"])
    def test_moe_wires_on_the_card_never_run_the_plain_versions(
            self, dev, monkeypatch, wire):
        """``moe_tp_mlp_overlapped`` on a wire over 4 ranks of the card:
        with the plain versions and the plain quantizers made to raise,
        one layer launches the quantizer, its AG kernel, the partials and
        the fold, once each, and nothing else."""
        from triton_distributed_tpu_torch import ops
        from triton_distributed_tpu_torch.kernels import wire as wk
        from triton_distributed_tpu_torch.lang import wire as tw
        from triton_distributed_tpu_torch.runtime import Mesh

        def boom(*a, **k):
            raise AssertionError("a plain version ran on CUDA tensors")

        for mod, name in ((mtf, "ag_group_gemm_mesh_w_plain"),
                          (mtf, "ag_group_gemm_mesh_mx_plain"),
                          (mtf, "moe_reduce_rs_partials_plain"),
                          (mtf, "moe_reduce_rs_fold_plain"),
                          (mtf, "moe_reduce_rs_mesh_w_plain"),
                          (mtf, "gemm_rs_fold_plain"),
                          (wk, "quantize_shards_plain"),
                          (tw, "quantize_slab"), (tw, "dequantize_slab")):
            monkeypatch.setattr(mod, name, boom)
        mesh = Mesh.loopback(4, dev)
        m_s, topk, e, hid, f = 64, 6, 16, 256, 512
        x, sti, _, w_up = _moe_mesh_inputs(44, dev, 4, m_s, topk, e, hid,
                                           f // 4, 64, torch.bfloat16)
        rng = np.random.default_rng(45)
        w_down = list((_t(rng.standard_normal((4, e, f // 4, hid)), dev,
                          torch.bfloat16) / np.sqrt(f)).unbind(0))
        logits = _t(rng.standard_normal((4 * m_s, e)), dev)
        wts, ids = mu.select_experts(logits, topk)
        ctx = ops.MoETPContext(num_experts=e, topk=topk, block_m=64,
                               mesh=mesh, wire_dtype=wire)
        before = launch_counts()
        out = ops.moe_tp_mlp_overlapped(torch.cat(x), ids, wts, w_up,
                                        w_down, ctx)
        after = launch_counts()
        moved = {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}
        ag_row = "ag_group_gemm_mx" if wire == "int8-mxu" else \
            "ag_group_gemm_wire"
        assert moved == {"wire_quantize": 1, ag_row: 1,
                         "moe_reduce_rs_wire": 1, "moe_reduce_rs_fold": 1}
        assert out.shape == (4 * m_s, hid) and out.isfinite().all()

    def test_one_rank_int8_mxu_equals_the_cpu(self, dev):
        """At tp = 1 int8-mxu runs the own slab's codes through the s8
        kernel: the card's up projection equals the CPU's bit for bit (the
        quantizers round as on the CPU, the s32 sums are exact), and the
        whole MLP launches the quantizer, ``ag_group_gemm_mx`` and the
        one-rank reduce."""
        from triton_distributed_tpu_torch import ops

        m, topk, e, hid, f = 200, 2, 8, 256, 320
        rng = np.random.default_rng(46)
        x = rng.standard_normal((m, hid)).astype(np.float32)
        x[7] *= 1000.0
        w_up = rng.standard_normal((e, hid, f)) / np.sqrt(hid)
        w_down = rng.standard_normal((e, f, hid)) / np.sqrt(f)
        wts, ids = mu.select_experts(torch.from_numpy(
            rng.standard_normal((m, e)).astype(np.float32)), topk)
        outs = []
        for d in ("cpu", dev):
            ctx = ops.MoETPContext(num_experts=e, topk=topk, block_m=64,
                                   wire_dtype="int8-mxu")
            r = ops.align_routing_sharded(ctx, ids.to(d))
            bf = torch.bfloat16
            outs.append(ops.ag_group_gemm_fused(_t(x, d, bf), r,
                                                _t(w_up, d, bf), ctx).cpu())
            if d != "cpu":
                before = launch_counts()
                y = ops.moe_tp_mlp_overlapped(_t(x, d, bf), ids.to(d),
                                              wts.to(d), _t(w_up, d, bf),
                                              _t(w_down, d, bf), ctx)
                after = launch_counts()
                moved = {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}
                assert moved == {"wire_quantize": 1, "ag_group_gemm_mx": 1,
                                 "moe_reduce_rs": 1}
                assert y.isfinite().all()
        torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=0)


#: (tokens a shard, top-k, experts, K, N, block_m) of the grouped
#: warpgroup GEMM's card tests: the DeepSeek-MoE-16B tp = 4 up projection's
#: widths (N 352: 2.75 tiles of 128), K 352 (5.5 stages of 64: an expert's
#: K edge) against N 88 (one partial tile) at 256-row blocks, and K 144 /
#: N 200; every shard has an empty expert (1), trailing all-padding blocks
#: and sentinel rows inside its last block of each expert
GROUPED_SHAPES = [(64, 6, 16, 2048, 352, 128), (100, 2, 8, 352, 88, 256),
                  (60, 3, 6, 144, 200, 128)]


class TestGroupedWgmma:
    """The MoE-TP wire's two grouped GEMMs on the grouped warpgroup GEMM
    (``csrc/wg_gemm.cuh`` ``wg_grouped_kernel``: the weight a 3-D tensor
    map looked up by the tile's expert, a persistent grid, TMA stores) at
    ``GROUPED_SHAPES``, 1, 2 and 4 ranks, bf16 and f32 outputs: every
    launch on ``wgmma``, within f32 summation order (per row) and one
    rounding of the plain version, the padding rows exactly 0, and two
    runs bit-identical."""

    @pytest.mark.parametrize("out", ["bfloat16", "float32"])
    @pytest.mark.parametrize("wire", ["fp8", "int8"])
    @pytest.mark.parametrize("w", [1, 2, 4])
    @pytest.mark.parametrize("shape", GROUPED_SHAPES)
    def test_ag_group_gemm_w_wgmma(self, dev, shape, w, wire, out):
        """``tdt_ag_group_gemm_w`` over ``WgPeerGatherRowsQ``: a peer's
        codes converted in registers, the own rows from the sorted slabs
        ``quantize_sorted`` returned, the all-padding tiles' zeros stored
        without their K loop; token 1 of shard 0 x1000."""
        from triton_distributed_tpu_torch.runtime import Mesh

        m_s, topk, e, k, n, bm = shape
        odt = getattr(torch, out)
        mesh = Mesh.loopback(w, dev)
        x, sti, be, ws = _moe_mesh_inputs(70, dev, w, m_s, topk, e, k, n, bm,
                                          torch.bfloat16)
        x[0][1] *= 1000.0
        cap_s = sti.shape[1]
        pad = sti.reshape(-1) >= m_s * topk
        first = sti[:, ::bm].reshape(-1) >= m_s * topk
        assert pad.any() and first.any() and not first.all()
        fmt = mtf._wire_fmt(wire, cap_s)
        q, s, slabs = mtf.quantize_sorted(x, sti, topk, fmt)
        runs = []
        for _ in range(2):
            mtf._ag_group_gemm_w_cuda.by_variant.clear()
            runs.append(mtf.ag_group_gemm_mesh_w(x, q, s, sti, be, ws, topk,
                                                 mesh, fmt, out_dtype=odt,
                                                 slabs=slabs))
            assert mtf._ag_group_gemm_w_cuda.by_variant == {"wgmma": 1}
        want = mtf.ag_group_gemm_mesh_w_plain(x, q, s, sti, be, ws, topk,
                                              mesh, fmt,
                                              out_dtype=torch.float32)
        torch.cuda.synchronize()
        for g, g2, ref in zip(*runs, want):
            assert g.dtype == odt and g.shape == (w * cap_s, n)
            assert torch.equal(g, g2)
            assert ((g.float() - ref).abs()
                    <= _gemm_tol_rows(ref, k, out == "bfloat16")).all()
            assert (g[pad] == 0).all()

    @pytest.mark.parametrize("out", ["bfloat16", "float32"])
    @pytest.mark.parametrize("w", [1, 2, 4])
    @pytest.mark.parametrize("shape", GROUPED_SHAPES)
    def test_moe_reduce_rs_partials_wgmma(self, dev, shape, w, out):
        """``tdt_moe_reduce_rs_partials`` over ``WgGroupedLocal`` (here F_q
        = K of the shape, H = its N): every rank's rows against its
        experts' weights, y's padding rows zero as the up projection's
        are (their partials exactly 0), an outlier row x1000."""
        from triton_distributed_tpu_torch.runtime import Mesh

        m_s, topk, e, f, h, bm = shape
        odt = getattr(torch, out)
        mesh = Mesh.loopback(w, dev)
        _, sti, be, ws = _moe_mesh_inputs(71, dev, w, m_s, topk, e, f, h, bm,
                                          torch.bfloat16)
        cap_s = sti.shape[1]
        pad = sti.reshape(-1) >= m_s * topk
        rng = np.random.default_rng(72)
        yf = rng.standard_normal((w, w * cap_s, f))
        yf[0, 5] *= 1000.0
        y = _t(yf, dev, torch.bfloat16)
        y[:, pad] = 0
        y = list(y.unbind(0))
        runs = []
        for _ in range(2):
            mtf._moe_reduce_rs_partials_cuda.by_variant.clear()
            runs.append(mtf.moe_reduce_rs_partials(y, be, ws, mesh,
                                                   out_dtype=odt))
            assert mtf._moe_reduce_rs_partials_cuda.by_variant == {
                "wgmma": 1}
        want = mtf.moe_reduce_rs_partials_plain(y, be, ws, mesh,
                                                out_dtype=torch.float32)
        torch.cuda.synchronize()
        for p, p2, ref in zip(*runs, want):
            assert p.dtype == odt and p.shape == (w * cap_s, h)
            assert torch.equal(p, p2)
            assert ((p.float() - ref).abs()
                    <= _gemm_tol_rows(ref, f, out == "bfloat16")).all()
            assert (p[pad] == 0).all()

    def test_off_rule_shapes_keep_the_tile_loops(self, dev):
        """64-row routing blocks (a 128-row tile would span two experts)
        and f32 operands run the tile loops, counted as ``mma_sync`` /
        ``fma``."""
        from triton_distributed_tpu_torch.runtime import Mesh

        mesh = Mesh.loopback(2, dev)
        for dtype, bm, form in ((torch.bfloat16, 64, "mma_sync"),
                                (torch.float32, 128, "fma")):
            x, sti, be, ws = _moe_mesh_inputs(73, dev, 2, 60, 2, 6, 144, 200,
                                              bm, dtype)
            fmt = mtf._wire_fmt("int8", sti.shape[1])
            q, s, slabs = mtf.quantize_sorted(x, sti, 2, fmt)
            mtf._ag_group_gemm_w_cuda.by_variant.clear()
            mtf.ag_group_gemm_mesh_w(x, q, s, sti, be, ws, 2, mesh, fmt,
                                     slabs=slabs)
            assert mtf._ag_group_gemm_w_cuda.by_variant == {form: 1}
            y = [torch.zeros((2 * sti.shape[1], 200), dtype=dtype,
                             device=dev) for _ in range(2)]
            wd = [t.transpose(1, 2).contiguous() for t in ws]
            mtf._moe_reduce_rs_partials_cuda.by_variant.clear()
            mtf.moe_reduce_rs_partials(y, be, wd, mesh)
            assert mtf._moe_reduce_rs_partials_cuda.by_variant == {form: 1}


#: the world-size-1 shapes of the bf16 pair on the grouped warpgroup GEMM:
#: ``GROUPED_SHAPES`` and the TP prefill's experts (64 of 2048 x 1408,
#: top-6) at 256 tokens
GROUPED_N1_SHAPES = GROUPED_SHAPES + [(256, 6, 64, 2048, 1408, 128)]

#: the bf16 MoE-TP pair's entries: (wrapper, counter) at world size 1 and
#: over a mesh
_BF16_PAIR = {1: (("ag_group_gemm", "_ag_group_gemm_cuda"),
                  ("moe_reduce_rs", "_moe_reduce_rs_cuda")),
              4: (("ag_group_gemm_mesh", "_ag_group_gemm_mesh_cuda"),
                  ("moe_reduce_rs_mesh", "_moe_reduce_rs_mesh_cuda"))}


class TestGroupedWgmmaBf16:
    """The bf16 MoE-TP pair on the grouped warpgroup GEMM (``csrc/
    wg_gemm.cuh`` ``wg_grouped_kernel``): ``tdt_ag_group_gemm_mesh`` over
    ``WgPeerGatherRows`` (the producer warpgroup gathers each tile's sorted
    rows from the tokens by cp.async), ``tdt_moe_reduce_rs_mesh`` over
    ``WgGroupedPeerSum`` (the K loop over (rank, K step)), and both at world
    size 1 on a one-rank table, at ``GROUPED_SHAPES`` (ragged N 352 and 88,
    K 352, an empty expert), 1, 2 and 4 ranks, bf16 and f32 outputs: every
    launch on ``wgmma``, within f32 summation order (per row) and one
    rounding of the plain version, the padding rows exactly 0, two runs
    bit-identical."""

    @staticmethod
    def _runs(fn, counter, n=2):
        runs = []
        for _ in range(n):
            counter.by_variant.clear()
            runs.append(fn())
            assert counter.by_variant == {"wgmma": 1}
        return runs

    @pytest.mark.parametrize("out", ["bfloat16", "float32"])
    @pytest.mark.parametrize("w", [1, 2, 4])
    @pytest.mark.parametrize("shape", GROUPED_SHAPES)
    def test_ag_group_gemm_mesh_wgmma(self, dev, shape, w, out):
        """Every rank's rows of every shard, gathered from the token's
        shard; token 1 of shard 0 x1000; the all-padding tiles' zeros."""
        from triton_distributed_tpu_torch.runtime import Mesh

        m_s, topk, e, k, n, bm = shape
        odt = getattr(torch, out)
        mesh = Mesh.loopback(w, dev)
        x, sti, be, ws = _moe_mesh_inputs(80, dev, w, m_s, topk, e, k, n, bm,
                                          torch.bfloat16)
        x[0][1] *= 1000.0
        pad = sti.reshape(-1) >= m_s * topk
        first = sti[:, ::bm].reshape(-1) >= m_s * topk
        assert pad.any() and first.any() and not first.all()
        runs = self._runs(lambda: mtf.ag_group_gemm_mesh(
            x, sti, be, ws, topk, mesh, out_dtype=odt),
            mtf._ag_group_gemm_mesh_cuda)
        want = mtf.ag_group_gemm_mesh_plain(x, sti, be, ws, topk, mesh,
                                            out_dtype=torch.float32)
        torch.cuda.synchronize()
        for g, g2, ref in zip(*runs, want):
            assert g.dtype == odt and g.shape == (w * sti.shape[1], n)
            assert torch.equal(g, g2)
            assert ((g.float() - ref).abs()
                    <= _gemm_tol_rows(ref, k, out == "bfloat16")).all()
            assert (g[pad] == 0).all()

    @pytest.mark.parametrize("out", ["bfloat16", "float32"])
    @pytest.mark.parametrize("w", [1, 2, 4])
    @pytest.mark.parametrize("shape", GROUPED_SHAPES)
    def test_moe_reduce_rs_mesh_wgmma(self, dev, shape, w, out):
        """Destination r's rows summed over the ranks' F shards (F_q = K
        of the shape, H = its N), every row computed (padding rows of y
        zero, as the up projection's are: their sums exactly 0); an
        outlier row x1000."""
        from triton_distributed_tpu_torch.runtime import Mesh

        m_s, topk, e, f, h, bm = shape
        odt = getattr(torch, out)
        mesh = Mesh.loopback(w, dev)
        _, sti, be, ws = _moe_mesh_inputs(81, dev, w, m_s, topk, e, f, h, bm,
                                          torch.bfloat16)
        cap_s = sti.shape[1]
        pad = sti >= m_s * topk
        rng = np.random.default_rng(82)
        yf = rng.standard_normal((w, w * cap_s, f))
        yf[0, 5] *= 1000.0
        y = _t(yf, dev, torch.bfloat16)
        y[:, pad.reshape(-1)] = 0
        y = list(y.unbind(0))
        runs = self._runs(lambda: mtf.moe_reduce_rs_mesh(
            y, be, ws, mesh, out_dtype=odt), mtf._moe_reduce_rs_mesh_cuda)
        want = mtf.moe_reduce_rs_mesh_plain(y, be, ws, mesh,
                                            out_dtype=torch.float32)
        torch.cuda.synchronize()
        for r, (g, g2, ref) in enumerate(zip(*runs, want)):
            assert g.dtype == odt and g.shape == (cap_s, h)
            assert torch.equal(g, g2)
            assert ((g.float() - ref).abs()
                    <= _gemm_tol_rows(ref, w * f, out == "bfloat16")).all()
            assert (g[pad[r]] == 0).all()

    @pytest.mark.parametrize("out", ["bfloat16", "float32"])
    @pytest.mark.parametrize("shape", GROUPED_N1_SHAPES)
    def test_n1_pair_wgmma(self, dev, shape, out):
        """World size 1: ``tdt_ag_group_gemm`` gathers from x (M, K) and
        ``tdt_moe_reduce_rs`` reads y (cap, F) in place, both on a
        one-rank table of the grouped warpgroup GEMM."""
        m, topk, e, k, n, bm = shape
        odt = getattr(torch, out)
        x, sti, be, ws = _moe_mesh_inputs(83, dev, 1, m, topk, e, k, n, bm,
                                          torch.bfloat16)
        x, sti, be, w = x[0], sti[0], be[0], ws[0]
        x[1] *= 1000.0
        pad = sti >= m * topk
        runs = self._runs(lambda: mtf.ag_group_gemm(x, sti, be, w, topk,
                                                    out_dtype=odt),
                          mtf._ag_group_gemm_cuda)
        want = mtf.ag_group_gemm_plain(x, sti, be, w, topk,
                                       out_dtype=torch.float32)
        torch.cuda.synchronize()
        g, g2 = runs
        assert g.dtype == odt and g.shape == (sti.shape[0], n)
        assert torch.equal(g, g2) and (g[pad] == 0).all()
        assert ((g.float() - want).abs()
                <= _gemm_tol_rows(want, k, out == "bfloat16")).all()
        # the down projection: F = N of the shape, H = its K
        wd = (_t(np.random.default_rng(84).standard_normal((e, n, k)), dev,
                 torch.bfloat16) / np.sqrt(n))
        y = runs[0].to(torch.bfloat16)
        runs = self._runs(lambda: mtf.moe_reduce_rs(y, be, wd,
                                                    out_dtype=odt),
                          mtf._moe_reduce_rs_cuda)
        want = mtf.moe_reduce_rs_plain(y, be, wd, out_dtype=torch.float32)
        torch.cuda.synchronize()
        g, g2 = runs
        assert g.dtype == odt and g.shape == (sti.shape[0], k)
        assert torch.equal(g, g2) and (g[pad] == 0).all()
        assert ((g.float() - want).abs()
                <= _gemm_tol_rows(want, n, out == "bfloat16")).all()

    @pytest.mark.parametrize("w", [1, 4])
    def test_prefill_shapes_never_run_the_plain_versions(self, dev,
                                                         monkeypatch, w):
        """``moe_tp_mlp_overlapped`` in bf16 at the TP prefill's shapes (8
        x 1024 tokens, top-6 over 64 experts of 2048 x 1408, block_m 128)
        at tp = 1 and tp = 4 on the card: with the plain versions made to
        raise, one layer launches the AG and the RS once each, both on
        ``wgmma``, and nothing else."""
        from triton_distributed_tpu_torch import ops
        from triton_distributed_tpu_torch.runtime import Mesh

        def boom(*a, **k):
            raise AssertionError("a plain version ran on CUDA tensors")

        for name in ("ag_group_gemm_plain", "moe_reduce_rs_plain",
                     "ag_group_gemm_mesh_plain", "moe_reduce_rs_mesh_plain"):
            monkeypatch.setattr(mtf, name, boom)
        monkeypatch.setattr(gg, "grouped_matmul_plain", boom)
        m, topk, e, hid, f = 8192, 6, 64, 2048, 1408
        g = torch.Generator(device=dev).manual_seed(85)
        bf = torch.bfloat16
        x = torch.randn((m, hid), generator=g, device=dev, dtype=bf)
        w_up = torch.randn((w, e, hid, f // w), generator=g, device=dev,
                           dtype=bf) / hid ** 0.5
        w_down = torch.randn((w, e, f // w, hid), generator=g, device=dev,
                             dtype=bf) / f ** 0.5
        wts, ids = mu.select_experts(torch.randn(
            (m, e), generator=g, device=dev), topk)
        mesh = Mesh.loopback(w, dev) if w > 1 else None
        ctx = ops.MoETPContext(num_experts=e, topk=topk, block_m=128,
                               mesh=mesh)
        ups, downs = ((list(w_up.unbind(0)), list(w_down.unbind(0)))
                      if w > 1 else (w_up[0], w_down[0]))
        counters = [getattr(mtf, c) for _, c in _BF16_PAIR[w]]
        for c in counters:
            c.by_variant.clear()
        before = launch_counts()
        out = ops.moe_tp_mlp_overlapped(x, ids, wts, ups, downs, ctx)
        after = launch_counts()
        moved = {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}
        assert moved == {name: 1 for name, _ in _BF16_PAIR[w]}
        assert all(c.by_variant == {"wgmma": 1} for c in counters)
        assert out.shape == (m, hid) and out.isfinite().all()

    @pytest.mark.parametrize("w", [1, 2])
    def test_f32_and_64_row_blocks_keep_the_tile_loops(self, dev, w):
        """f32 operands run the FMA loop, bf16 at 64-row routing blocks (a
        128-row tile would span two experts) the ``mma.sync`` loop, at
        world size 1 and over a mesh, counted by form."""
        from triton_distributed_tpu_torch.runtime import Mesh

        mesh = Mesh.loopback(w, dev)
        for dtype, bm, form in ((torch.float32, 128, "fma"),
                                (torch.bfloat16, 64, "mma_sync")):
            x, sti, be, ws = _moe_mesh_inputs(86, dev, w, 60, 2, 6, 144, 200,
                                              bm, dtype)
            wd = [t.transpose(1, 2).contiguous() for t in ws]
            y = [torch.ones((w * sti.shape[1], 200), dtype=dtype,
                            device=dev) for _ in range(w)]
            if w == 1:
                calls = (lambda: mtf.ag_group_gemm(x[0], sti[0], be[0],
                                                   ws[0], 2),
                         lambda: mtf.moe_reduce_rs(y[0], be[0], wd[0]))
            else:
                calls = (lambda: mtf.ag_group_gemm_mesh(x, sti, be, ws, 2,
                                                        mesh),
                         lambda: mtf.moe_reduce_rs_mesh(y, be, wd, mesh))
            for (_, c), call in zip(_BF16_PAIR[1 if w == 1 else 4], calls):
                counter = getattr(mtf, c)
                counter.by_variant.clear()
                call()
                assert counter.by_variant == {form: 1}

    def test_a_refused_wgmma_form_raises(self, dev, monkeypatch):
        """A ``wgmma`` form that the C side refuses (64-row routing blocks
        forced past the predicate) raises; nothing falls back to the tile
        loops."""
        monkeypatch.setattr(mtf, "grouped_wgmma_form",
                            lambda *a, **k: True)
        x, sti, be, ws = _moe_mesh_inputs(87, dev, 1, 60, 2, 6, 144, 200,
                                          64, torch.bfloat16)
        with pytest.raises(RuntimeError, match="tdt_ag_group_gemm"):
            mtf.ag_group_gemm(x[0], sti[0], be[0], ws[0], 2)
        y = torch.ones((sti.shape[1], 144), dtype=torch.bfloat16, device=dev)
        with pytest.raises(RuntimeError, match="tdt_moe_reduce_rs"):
            mtf.moe_reduce_rs(y, be[0], ws[0])


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


# -------------------------------- reduce-scatter and the dense all-to-all

def _rs_parts(dev, w, shape, dtype, seed, separate=False, offset=0):
    """W contributions of ``shape`` (x30): views of one allocation, tensors
    of their own (``separate``), or (``offset`` elements) views that start
    off the 16-byte grid."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    flat = _t(rng.standard_normal(w * n + offset) * 30, dev,
              getattr(torch, dtype))
    parts = [flat[offset + r * n: offset + (r + 1) * n].view(shape)
             for r in range(w)]
    return [p.clone() for p in parts] if separate else parts


class TestCollectiveKernels:
    @pytest.mark.parametrize("layout", ["stacked", "separate", "unaligned",
                                        "replicated"])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("w", [2, 4])
    @pytest.mark.parametrize("shape", [(4 * 37, 9), (4 * 64, 256),
                                       (4 * 32, 8, 24)])
    def test_reduce_scatter_is_bit_exact(self, dev, shape, w, dtype, layout):
        """Ragged rows (37 a rank, 9 columns: the element loop), aligned
        2-D and 3-D contributions, shards of their own, views off the
        16-byte grid and one replicated tensor: every rank's row block
        equals ``reduce_scatter_plain`` (the ring's hop order, one
        rounding a hop) bit for bit; one launch of ``tdt_reduce_scatter``
        for all ranks, counted by the TPU kernel it stands for."""
        from triton_distributed_tpu_torch.kernels import (
            launches_by_tpu_kernel,
        )
        from triton_distributed_tpu_torch.kernels import reduce_scatter as rs
        from triton_distributed_tpu_torch.runtime import Mesh

        mesh = Mesh.loopback(w, dev)
        rows = shape[0] // 4 * w
        shape = (rows, *shape[1:])
        parts = _rs_parts(dev, w, shape, dtype, 60,
                          separate=layout == "separate",
                          offset=3 if layout == "unaligned" else 0)
        x, stacked = (parts[0], False) if layout == "replicated" else (
            parts, True)
        before, by = launch_counts(), dict(launches_by_tpu_kernel())
        got = rs.reduce_scatter(x, mesh, stacked=stacked)
        after = launch_counts()
        assert after["reduce_scatter"] == before["reduce_scatter"] + 1
        assert sum(after.values()) == sum(before.values()) + 1
        kern = rs.select_engine(w, shape, parts[0].element_size(), None)[0]
        assert launches_by_tpu_kernel()[kern] == by.get(kern, 0) + 1
        want = rs.reduce_scatter_plain(x, mesh, stacked=stacked)
        torch.cuda.synchronize()
        for g, r in zip(got, want):
            assert g.shape == (rows // w, *shape[1:]) and torch.equal(g, r)

    @pytest.mark.parametrize("depth", [2, 3])
    def test_reduce_scatter_engines(self, dev, monkeypatch, depth):
        """The streaming engine (a budget of 1 byte) and the VMEM one run
        the same kernel to the same bits; the counts name
        ``_rs_stream_kernel`` / ``3`` and ``_ring_rs_kernel``."""
        from triton_distributed_tpu_torch.kernels import (
            launches_by_tpu_kernel,
            reset_launch_counts,
        )
        from triton_distributed_tpu_torch.kernels import reduce_scatter as rs
        from triton_distributed_tpu_torch.runtime import Mesh
        from triton_distributed_tpu_torch.tune import RingSchedule

        mesh = Mesh.loopback(4, dev)
        parts = _rs_parts(dev, 4, (256, 512), "bfloat16", 61)
        sched = RingSchedule(depth=depth)
        reset_launch_counts()
        vmem = rs.reduce_scatter(parts, mesh, stacked=True, schedule=sched)
        monkeypatch.setenv("TDTPU_FUSED_VMEM_BUDGET", "1")
        stream = rs.reduce_scatter(parts, mesh, stacked=True, schedule=sched)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(vmem, stream))
        assert launches_by_tpu_kernel() == {
            "_ring_rs_kernel": 1,
            "_rs_stream_kernel" + ("3" if depth == 3 else ""): 1}

    @pytest.mark.parametrize("wire", ["fp8", "int8", "int8-mxu"])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("stream", [False, True])
    def test_reduce_scatter_wire_is_bit_exact(self, dev, monkeypatch, stream,
                                              dtype, wire):
        """The wire on the VMEM ring (the fold at one scale a row) and on
        the stream (at ``make_wire_format``'s chunk, depth 3 too): the
        GEMM-RS fold equals ``gemm_rs_fold_plain`` bit for bit, one launch
        counted as ``reduce_scatter_fold`` and by its TPU kernel."""
        from triton_distributed_tpu_torch.kernels import (
            launches_by_tpu_kernel,
            reset_launch_counts,
        )
        from triton_distributed_tpu_torch.kernels import reduce_scatter as rs
        from triton_distributed_tpu_torch.runtime import Mesh
        from triton_distributed_tpu_torch.tune import RingSchedule

        mesh = Mesh.loopback(4, dev)
        parts = _rs_parts(dev, 4, (4 * 96, 1024), dtype, 62)
        parts[1][5] *= 1000.0               # an outlier row
        if stream:
            monkeypatch.setenv("TDTPU_FUSED_VMEM_BUDGET", "1")
        w = rs.resolve_rs_wire(wire, 4 * 96, 1024, 4, parts[0].element_size())
        for sched in (None, RingSchedule(depth=3)) if stream else (None,):
            kern, fmt = rs.select_engine(4, parts[0].shape,
                                         parts[0].element_size(), w,
                                         sched.depth if sched else 2)
            assert fmt.chunk_rows == (32 if stream else 1)
            reset_launch_counts()
            got = rs.reduce_scatter(parts, mesh, stacked=True,
                                    wire_dtype=wire, schedule=sched)
            want = rs.reduce_scatter_plain(parts, mesh, stacked=True, fmt=fmt)
            torch.cuda.synchronize()
            assert all(torch.equal(g, r) for g, r in zip(got, want))
            counts = {k: v for k, v in launch_counts().items() if v}
            assert counts == {"reduce_scatter_fold": 1}
            assert launches_by_tpu_kernel() == {kern: 1}

    @pytest.mark.parametrize("separate", [False, True])
    @pytest.mark.parametrize("dtype", ["int32", "bfloat16", "int8",
                                       "float32"])
    @pytest.mark.parametrize("w", [2, 4])
    @pytest.mark.parametrize("shape", [(4 * 7, 3), (4 * 64, 512)])
    def test_all_to_all_is_byte_exact(self, dev, shape, w, dtype, separate):
        """Blocks of 21 bytes-ish (off the 16-byte grid: the byte loop)
        and of 128 KiB, in every dtype: each rank's output equals
        ``all_to_all_plain`` byte for byte (the list and the stacked
        forms), one launch of ``tdt_all_to_all`` for all ranks."""
        from triton_distributed_tpu_torch.kernels import all_to_all as a2a
        from triton_distributed_tpu_torch.runtime import Mesh

        rng = np.random.default_rng(63)
        mesh = Mesh.loopback(w, dev)
        shape = (shape[0] // 4 * w, *shape[1:])
        tdt = getattr(torch, dtype)
        if dtype in ("int32", "int8"):
            info = np.iinfo(np.dtype(dtype))
            full = _t(rng.integers(info.min, info.max, (w, *shape)), dev, tdt)
        else:
            full = _t(rng.standard_normal((w, *shape)), dev, tdt)
        x = ([full[r].clone() for r in range(w)] if separate
             else list(full.unbind(0)))
        before = launch_counts()
        got = a2a.all_to_all(x, mesh)
        after = launch_counts()
        assert after["all_to_all"] == before["all_to_all"] + 1
        assert sum(after.values()) == sum(before.values()) + 1
        want = a2a.all_to_all_plain(x)
        stacked = a2a.all_to_all_device(full, mesh)
        torch.cuda.synchronize()
        for g, s, r in zip(got, stacked.unbind(0), want):
            assert torch.equal(g, r) and torch.equal(s, r)

    def test_collective_paths_launch_their_kernels(self, dev, monkeypatch):
        """With the plain versions made to raise: ``MoETPMLP(fused=False)``
        over 4 ranks launches the reduce-scatter once (the stream engine
        at a budget of 1 byte, else the VMEM ring), and ``ep_moe`` on the
        fused transport with ``max_m`` below M·topk (demoted to the padded
        slots) launches the all-to-all twice and the chunked one never."""
        from triton_distributed_tpu_torch import layers, ops
        from triton_distributed_tpu_torch.kernels import (
            launches_by_tpu_kernel,
            reset_launch_counts,
        )
        from triton_distributed_tpu_torch.kernels import all_to_all as a2a
        from triton_distributed_tpu_torch.kernels import reduce_scatter as rs
        from triton_distributed_tpu_torch.runtime import Mesh

        def boom(*a, **k):
            raise AssertionError("a plain version ran on CUDA tensors")

        for mod, name in ((rs, "reduce_scatter_plain"),
                          (rs, "gemm_rs_fold_plain"),
                          (a2a, "all_to_all_plain"),
                          (gg, "grouped_matmul_plain")):
            monkeypatch.setattr(mod, name, boom)
        mesh = Mesh.loopback(4, dev)
        rng = np.random.default_rng(64)
        m, e, k, hid, f = 4 * 64, 8, 2, 256, 512
        x = _t(rng.standard_normal((m, hid)), dev, torch.bfloat16)
        logits = _t(rng.standard_normal((m, e)), dev)
        wts, ids = mu.select_experts(logits, k)
        up = list((_t(rng.standard_normal((4, e, hid, f // 4)), dev,
                      torch.bfloat16) / 16).unbind(0))
        down = list((_t(rng.standard_normal((4, e, f // 4, hid)), dev,
                        torch.bfloat16) / 16).unbind(0))
        ctx = ops.MoETPContext(num_experts=e, topk=k, block_m=64, mesh=mesh)
        for budget, kern in ((None, "_ring_rs_kernel"),
                             ("1", "_rs_stream_kernel")):
            if budget:
                monkeypatch.setenv("TDTPU_FUSED_VMEM_BUDGET", budget)
            reset_launch_counts()
            out = layers.MoETPMLP(ctx, fused=False)(
                {"up": up, "down": down}, x, ids, wts)
            assert launches_by_tpu_kernel() == {kern: 1}
            assert launch_counts()["reduce_scatter"] == 1
            assert out.shape == (m, hid) and out.isfinite().all()
        ep = ops.create_ep_moe_context(
            num_experts=e, topk=k, max_m=64, hidden=hid, mesh=mesh,
            quant="fp8", block_m=64)
        reset_launch_counts()
        out = ops.ep_moe(x, logits, torch.cat(up, dim=2),
                         torch.cat(down, dim=1), ep)
        counts = launch_counts()
        assert counts["all_to_all"] == 2 and counts["chunked_a2a_mesh"] == 0
        assert out.shape == (m, hid) and out.isfinite().all()

    def test_wrappers_refuse_what_the_kernels_do_not_take(self, dev):
        """A dtype the kernels do not take, non-contiguous contributions,
        a mesh on another device: each raises, none falls back."""
        from triton_distributed_tpu_torch.kernels import all_to_all as a2a
        from triton_distributed_tpu_torch.kernels import reduce_scatter as rs
        from triton_distributed_tpu_torch.runtime import Mesh

        mesh = Mesh.loopback(2, dev)
        h = [torch.zeros((8, 16), device=dev, dtype=torch.float16)] * 2
        with pytest.raises(ValueError, match="f32 or bf16"):
            rs.reduce_scatter(h, mesh, stacked=True)
        t = [torch.zeros((16, 8), device=dev).t() for _ in range(2)]
        with pytest.raises(ValueError, match="contiguous"):
            rs.reduce_scatter(t, mesh, stacked=True)
        with pytest.raises(ValueError, match="contiguous"):
            a2a.all_to_all(t, mesh)
        cpu = Mesh.loopback(2, "cpu")
        with pytest.raises(ValueError, match="the mesh is on"):
            a2a.all_to_all([torch.zeros(4, 2, device=dev)] * 2, cpu)
        with pytest.raises(ValueError, match="the mesh is on"):
            rs.reduce_scatter([torch.zeros(4, 2, device=dev)] * 2, cpu,
                              stacked=True)

    def test_a_failed_build_raises(self, dev, monkeypatch):
        """A kernel that does not build raises on the call: nothing falls
        back to the plain version."""
        from triton_distributed_tpu_torch.kernels import _build
        from triton_distributed_tpu_torch.kernels import all_to_all as a2a
        from triton_distributed_tpu_torch.runtime import Mesh

        mesh = Mesh.loopback(2, dev)
        x = [torch.zeros((4, 2), device=dev)] * 2

        def no_lib():
            raise RuntimeError("nvcc failed: (a failing build)")

        monkeypatch.setattr(_build, "lib", no_lib)
        with pytest.raises(RuntimeError, match="nvcc failed"):
            a2a.all_to_all(x, mesh)


# ------------------------------------------- the other all-gathers, int8-mxu RS

def _mx_operands(dev, w, m, k, n, dtype, seed):
    """The int8-mxu GEMM-RS's operands: W column shards A_q (W·m, K) with
    an outlier row (x1000) in shard 0 and W row shards B_q (K, N)."""
    rng = np.random.default_rng(seed)
    a = _mesh_shards(rng, dev, w, (w * m, k), dtype, False)
    a[0][3] *= 1000.0
    b = [x / np.sqrt(w * k) for x in _mesh_shards(rng, dev, w, (k, n),
                                                  dtype, False)]
    return a, b


class TestStep4Kernels:
    """The int8-mxu GEMM-RS producers (``tdt_gemm_rs_mx``, the fold's
    two modes) and the bidirectional and persistent all-gathers against
    their plain versions: bit for bit, byte for byte."""

    @pytest.mark.parametrize("part", ["float32", "bfloat16"])
    @pytest.mark.parametrize("w", [2, 4])
    @pytest.mark.parametrize("shape", [(32, 72, 40, 16), (64, 256, 136, 64)])
    def test_mx_partials_are_exact(self, dev, shape, w, part):
        """s32 sums are exact in any order and the epilogue is the plain
        version's, acc · (a_scale · b_scale): bit for bit (K 72: the byte
        loads; K 256: 16-byte rows; N past one 128-wide tile)."""
        from triton_distributed_tpu_torch.kernels import wire as wk
        from triton_distributed_tpu_torch.lang import wire as tw
        from triton_distributed_tpu_torch.runtime import Mesh

        m, k, n, cr = shape
        mesh = Mesh.loopback(w, dev)
        a, b = _mx_operands(dev, w, m, k, n, torch.bfloat16, 60)
        fmt = tw.WireFormat("int8", cr)
        q, s = wk.quantize_shards(a, fmt)
        bqt, bs = agm.quantize_cols_shards(b)
        pdt = getattr(torch, part)
        before = launch_counts()["gemm_rs_mx"]
        got = grs.gemm_rs_mx_partials(q, s, bqt, bs, mesh, cr, pdt)
        assert launch_counts()["gemm_rs_mx"] == before + 1
        want = grs.mx_partials_plain(q, s, bqt, bs, cr, pdt)
        torch.cuda.synchronize()
        for g, ref in zip(got, want):
            assert g.dtype == pdt and g.shape == (w * m, n)
            assert torch.equal(g, ref)

    @pytest.mark.parametrize("epilogue", ["accumulator", "readback"])
    @pytest.mark.parametrize("out", ["float32", "bfloat16"])
    @pytest.mark.parametrize("w", [2, 4])
    @pytest.mark.parametrize("shape", [(32, 72, 36), (64, 136, 256)])
    def test_int8_mxu_gemm_rs_is_exact(self, dev, shape, w, out, epilogue):
        """The whole int8-mxu GEMM-RS on the fused engine (one out tile:
        N 36, ragged, and 256): the fold of the plan's epilogue on the
        kernel's own partials equals the plain fold of them bit for bit,
        and so does the call; launches: the quantizer, the partials (by
        the TPU kernel), the fold's mode."""
        from triton_distributed_tpu_torch.kernels import (
            launches_by_tpu_kernel,
            reset_launch_counts,
        )
        from triton_distributed_tpu_torch.kernels import wire as wk
        from triton_distributed_tpu_torch.lang import wire as tw
        from triton_distributed_tpu_torch.runtime import Mesh
        from triton_distributed_tpu_torch.tune.schedule import GridSchedule

        m, k, n = shape
        mesh = Mesh.loopback(w, dev)
        odt = getattr(torch, out)
        a, b = _mx_operands(dev, w, m, k, n, torch.bfloat16, 61)
        sched = GridSchedule(epilogue=epilogue)
        plan = grs.resolve_gemm_rs_plan(mesh, "tp", a, b,
                                        wire_dtype="int8-mxu",
                                        schedule=sched)
        assert plan.wire == "int8-mxu" and plan.chunk_rows == m
        fmt = tw.WireFormat("int8", plan.chunk_rows)
        q, s = wk.quantize_shards(a, fmt)
        bqt, bs = agm.quantize_cols_shards(b)
        pdt = odt if epilogue == "readback" else torch.float32
        parts = grs.gemm_rs_mx_partials(q, s, bqt, bs, mesh, fmt.chunk_rows,
                                        pdt)
        folded = grs.gemm_rs_mx_fold(parts, mesh, fmt, odt, epilogue)
        reset_launch_counts()
        got = grs.gemm_rs(a, b, mesh, wire_dtype="int8-mxu", out_dtype=odt,
                          schedule=sched)
        counts = {k: v for k, v in launch_counts().items() if v}
        fold_row = ("gemm_rs_mxr_fold" if epilogue == "readback"
                    else "gemm_rs_mxw_fold")
        assert counts == {"wire_quantize": 1, "gemm_rs_mx": 1, fold_row: 1}
        assert launches_by_tpu_kernel() == {plan.tpu_kernel: 1}
        want = grs.gemm_rs_mx_fold_plain(parts, fmt, odt, epilogue)
        torch.cuda.synchronize()
        for d in range(w):
            assert got[d].dtype == odt and got[d].shape == (m, n)
            assert torch.equal(folded[d], want[d])
            assert torch.equal(got[d], want[d])

    def test_int8_mxu_demotes_to_the_int8_wire(self, dev):
        """N 2048 spans two out tiles: int8-mxu runs the int8 wire, bit
        for bit, and ``demote='strict'`` raises instead."""
        from triton_distributed_tpu_torch.runtime import Mesh
        from triton_distributed_tpu_torch.tune.schedule import GridSchedule

        mesh = Mesh.loopback(4, dev)
        a, b = _mx_operands(dev, 4, 64, 128, 2048, torch.bfloat16, 62)
        before = launch_counts()
        got = grs.gemm_rs(a, b, mesh, wire_dtype="int8-mxu")
        after = launch_counts()
        assert after["gemm_rs_mx"] == before["gemm_rs_mx"]
        want = grs.gemm_rs(a, b, mesh, wire_dtype="int8")
        torch.cuda.synchronize()
        assert all(torch.equal(g, r) for g, r in zip(got, want))
        with pytest.raises(ValueError, match="strict"):
            grs.gemm_rs(a, b, mesh, wire_dtype="int8-mxu",
                        schedule=GridSchedule(demote="strict"))

    @pytest.mark.parametrize("split8", [None, 2, 6])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
    @pytest.mark.parametrize("w", [2, 4])
    @pytest.mark.parametrize("shape", [(13, 7), (64, 512), (5, 300, 3)])
    def test_all_gather_bidir_is_byte_exact(self, dev, shape, w, dtype,
                                            split8):
        """Rows off the 16-byte grid (the byte loop), aligned rows split
        at 128 columns or more, a 3-D shard split along dim 1: every
        rank's result equals ``torch.cat``, one launch."""
        from triton_distributed_tpu_torch.runtime import AllGatherMethod, Mesh
        from triton_distributed_tpu_torch.tune.schedule import RingSchedule

        rng = np.random.default_rng(63)
        tdt = getattr(torch, dtype)
        mesh = Mesh.loopback(w, dev)
        full = _t(rng.integers(-100, 100, (w, *shape)), dev, tdt)
        x = list(full.unbind(0))
        sched = None if split8 is None else RingSchedule(split8=split8)
        before = launch_counts()["all_gather_bidir"]
        got = ag.all_gather(x, mesh, method=AllGatherMethod.RING_BIDIR,
                            schedule=sched)
        assert launch_counts()["all_gather_bidir"] == before + 1
        want = torch.cat(x)
        torch.cuda.synchronize()
        for g in got:
            assert torch.equal(g, want)

    @pytest.mark.parametrize("shape", [(8, 4096), (3, 5)])
    def test_persistent_ll_windows(self, dev, shape):
        """Three calls of ``PersistentLLAllGather``: every output equals
        ``torch.cat``, and afterwards every rank's workspace holds call
        2's rows in window 0 and call 1's in window 1; one launch a
        call; ``all_gather(method=LL_PERSIST)`` runs the same kernel."""
        from triton_distributed_tpu_torch.runtime import AllGatherMethod, Mesh

        w = 4
        mesh = Mesh.loopback(w, dev)
        ll = ag.PersistentLLAllGather(mesh, "tp", shape, torch.bfloat16)
        rng = np.random.default_rng(64)
        calls = [list(_t(rng.standard_normal((w, *shape)), dev,
                         torch.bfloat16).unbind(0)) for _ in range(3)]
        before = launch_counts()["all_gather_persist"]
        for x in calls:
            got = ll(x)
            torch.cuda.synchronize()
            assert all(torch.equal(g, torch.cat(x)) for g in got)
        assert launch_counts()["all_gather_persist"] == before + 3
        rows = w * shape[0]
        for ws in ll.workspace:
            assert torch.equal(ws[:rows], torch.cat(calls[2]))
            assert torch.equal(ws[rows:], torch.cat(calls[1]))
        got = ag.all_gather(calls[0], mesh, method=AllGatherMethod.LL_PERSIST)
        assert launch_counts()["all_gather_persist"] == before + 4
        assert all(torch.equal(g, torch.cat(calls[0])) for g in got)


# ---------------------------------------------- long-context serving

from triton_distributed_tpu_torch.kernels import cp_ring  # noqa: E402


def _cp_partials(dev, r, dtype, seed, hkv=4, tg=40, d=128):
    """Seeded partials: rows 0-7 only shard 0 saw, rows 8-11 no shard
    (partials 0, lses NEG_INF), the last shard past the data from row
    20."""
    rng = np.random.default_rng(seed)
    outs = rng.standard_normal((r, hkv, tg, d)).astype(np.float32)
    lses = (4.0 * rng.standard_normal((r, hkv, tg))).astype(np.float32)
    lses[1:, :, :8] = rpa.NEG_INF
    lses[:, :, 8:12] = rpa.NEG_INF
    lses[-1, :, 20:] = rpa.NEG_INF
    outs[lses <= rpa.NEG_INF / 2] = 0.0
    return _t(outs, dev, getattr(torch, dtype)), _t(lses, dev)


class TestCpCombineKernel:
    @pytest.mark.parametrize("out", [None, "float32"])
    @pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
    @pytest.mark.parametrize("r", [2, 3, 4])
    def test_is_bit_exact(self, dev, r, dtype, out):
        """``tdt_cp_lse_combine`` against its plain version bit for bit
        (the same shard-order sums, each op rounded on its own); the
        shard-0-only rows equal shard 0's partial, the all-masked rows
        stay 0 with lse NEG_INF; one launch."""
        outs, lses = _cp_partials(dev, r, dtype, 70 + r)
        kw = dict(out_dtype=None if out is None else getattr(torch, out))
        before = launch_counts()["cp_lse_combine"]
        got = cp_ring.cp_lse_combine(outs, lses, **kw)
        assert launch_counts()["cp_lse_combine"] == before + 1
        want = cp_ring.cp_lse_combine_plain(outs, lses, **kw)
        torch.cuda.synchronize()
        assert got[0].dtype == want[0].dtype
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert torch.equal(got[0][:, :8], outs[0, :, :8].to(got[0].dtype))
        assert torch.equal(got[1][:, :8], lses[0, :, :8])
        assert (got[0][:, 8:12] == 0).all()
        assert (got[1][:, 8:12] == rpa.NEG_INF).all()

    @pytest.mark.parametrize("d", [128, 72, 30])
    def test_strided_views_and_depths(self, dev, d):
        """The serving step's views of one (Hkv, R·TG, D) output; D 72
        and 30 (the one-element path where 4-wide loads do not fit);
        depth 3 gives the same bits and counts as
        ``_cp_lse_combine_kernel3``."""
        from triton_distributed_tpu_torch.kernels import (
            launches_by_tpu_kernel,
            reset_launch_counts,
        )
        from triton_distributed_tpu_torch.tune.schedule import RingSchedule

        outs, lses = _cp_partials(dev, 2, "bfloat16", 75, d=d)
        flat_o = outs.permute(1, 0, 2, 3).reshape(4, -1, d).contiguous()
        flat_l = lses.permute(1, 0, 2).reshape(4, -1).contiguous()
        view_o = flat_o.view(4, 2, 40, d).transpose(0, 1)
        view_l = flat_l.view(4, 2, 40).transpose(0, 1)
        want = cp_ring.cp_lse_combine_plain(outs, lses)
        reset_launch_counts()
        for depth in (2, 3):
            got = cp_ring.cp_lse_combine(view_o, view_l,
                                         schedule=RingSchedule(depth=depth))
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                want[1])
        assert launches_by_tpu_kernel() == {"_cp_lse_combine_kernel": 1,
                                            "_cp_lse_combine_kernel3": 1}

    def test_wrapper_refuses_what_the_kernel_does_not_take(self, dev):
        outs, lses = _cp_partials(dev, 2, "float32", 76)
        with pytest.raises(ValueError, match="f32 or bf16"):
            cp_ring.cp_lse_combine(outs.half(), lses)
        with pytest.raises(ValueError, match="lses must be f32"):
            cp_ring.cp_lse_combine(outs, lses.bfloat16())
        with pytest.raises(ValueError, match="contiguous"):
            cp_ring.cp_lse_combine(torch.cat([outs, outs], -1)[..., ::2],
                                   lses)
        with pytest.raises(ValueError, match="shards"):
            cp_ring.cp_lse_combine(outs.repeat(5, 1, 1, 1),
                                   lses.repeat(5, 1, 1))


def test_cp_engine_on_card_equals_cpu(dev):
    """A tiny cp = 2 engine (tp = 1) on the card and on the CPU from the
    same weights: a request of 40 positions over two 6-page shards
    beside a short one, equal token streams; on the card every step
    launches the ragged kernel and the combine once a layer."""
    from triton_distributed_tpu_torch.kernels import reset_launch_counts
    from triton_distributed_tpu_torch.models import (
        Transformer,
        TransformerConfig,
    )
    from triton_distributed_tpu_torch.runtime import Mesh
    from triton_distributed_tpu_torch.serving import (
        CpPagePool,
        EngineConfig,
        Request,
        ServingEngine,
    )

    cfg = TransformerConfig(vocab=128, n_layers=2, hidden=64, ffn=128,
                            n_heads=4, n_kv_heads=2, head_dim=16,
                            dtype="float32", param_dtype="float32")
    params = Transformer(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    streams, steps = [], []
    for d in ("cpu", dev):
        model = Transformer(cfg, mesh=Mesh.grid({"tp": 1, "cp": 2}, d),
                            cp_axis="cp")
        eng = ServingEngine(model, _to(params, d), EngineConfig(
            slots=2, token_budget=16, chunk=8, page=4, npages=6))
        assert isinstance(eng.pool, CpPagePool)
        rng = np.random.default_rng(0)
        done = {}
        eng.on_complete = lambda req, s: done.setdefault(
            req.rid, list(req.generated)) or True
        reset_launch_counts()
        eng.run([Request(rid=0, prompt=rng.integers(1, 127, 30, np.int32),
                         max_new=10),
                 Request(rid=1, prompt=rng.integers(1, 127, 7, np.int32),
                         max_new=6)])
        streams.append(done)
        steps.append(len(eng.stats.step_times))
    assert streams[1] == streams[0] and len(streams[0]) == 2
    counts = launch_counts()
    assert counts["cp_lse_combine"] == cfg.n_layers * steps[1]
    assert counts["ragged_paged_attention"] == cfg.n_layers * steps[1]


# ------------------------------------------------ context-parallel prefill

from triton_distributed_tpu_torch.kernels import ring_attention as tra  # noqa: E402


def _cp_qkv(dev, n, b, s, hq, hkv, d, dtype, seed):
    """Seeded q, k, v as the prefill takes them: (n, B, S, H, D) views of
    one (B, n·S, (Hq + 2·Hkv)·D) projection, rank r's sequence block at
    [r·S, (r+1)·S)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn((b, n * s, (hq + 2 * hkv) * d), generator=g,
                      device=dev).to(dtype)
    q, k, v = torch.split(qkv, [hq * d, hkv * d, hkv * d], dim=-1)
    return [t.reshape(b, n, s, -1, d).transpose(0, 1) for t in (q, k, v)]


def _bf16_excess(got, want):
    """max(|got - want| - ulp(want)) over the elements, want's bf16 ulp
    being 2^(e - 8) for |want| in [2^(e-1), 2^e): what is left of the
    difference after one bf16 rounding. Two f32 results within a
    tolerance t of each other, each rounded to bf16 once, leave at most
    t; near zero a bf16 ulp is smaller than the f32 sums' last-bit
    differences, so a bare ulp count does not bound them."""
    w, g = want.float(), got.float()
    _, e = torch.frexp(w)
    ulp = torch.where(w == 0, torch.zeros_like(w),
                      torch.ldexp(torch.ones_like(w), e - 8))
    return ((g - w).abs() - ulp).max().item()


def _entry_plain(fn, q, k, v):
    """The plain version of the ring or Ulysses entry on q, k, v's own
    device and dtype: :func:`ring_attention_plain`, and for Ulysses the
    plain all-to-alls around it on a ring of one block (the entries'
    composition, with the plain pieces)."""
    if fn is tra.ring_attention:
        return tra.ring_attention_plain(q, k, v)
    n, hkv = q.shape[0], k.shape[3]
    if hkv % n:
        k, v = (t.repeat_interleave(n // hkv, dim=3) for t in (k, v))
    qs, ks, vs = (cp_ring.ulysses_a2a_plain(t, "scatter") for t in (q, k, v))
    _, b, s, hl, d = qs.shape
    o = tra.ring_attention_plain(
        *(t.reshape(1, n * b, s, t.shape[3], d) for t in (qs, ks, vs)))
    return cp_ring.ulysses_a2a_plain(o.reshape(n, b, s, hl, d), "gather")


def _attention_f64(q, k, v):
    """Causal GQA attention over the ranks' stacked blocks (n, B, S, H,
    D) in float64 on the CPU: the exact values both sides round."""
    n, b, s, hq, d = q.shape
    hkv = k.shape[3]

    def seq(t):  # (n, B, S, H, D) -> (B, H, n·S, D)
        return t.detach().cpu().double().transpose(0, 1).reshape(
            b, n * s, -1, d).transpose(1, 2)

    qd, kd, vd = seq(q), seq(k), seq(v)
    kd, vd = (t.repeat_interleave(hq // hkv, dim=1) for t in (kd, vd))
    sc = qd @ kd.transpose(-1, -2) / d ** 0.5
    pos = torch.arange(n * s)
    sc = sc.masked_fill(pos[None, :] > pos[:, None], float("-inf"))
    o = torch.softmax(sc, dim=-1) @ vd                 # (B, H, n·S, D)
    return o.transpose(1, 2).reshape(b, n, s, hq, d).transpose(0, 1)


def _ring_miss_sides(fn, q, k, v, mesh, got):
    """Which side of an f32 ring-entry comparison moved: the card's
    output, the plain version on the card and on the CPU, each against a
    second run of itself and against the float64 values; each line the
    largest difference, the elements past 1e-5 and where the largest sits
    (rank, batch, token, head, dim)."""
    from triton_distributed_tpu_torch.runtime import Mesh

    got = got.cpu()
    card_again = fn(q, k, v, mesh).cpu()
    plain = _entry_plain(fn, q, k, v).cpu()
    plain_again = _entry_plain(fn, q, k, v).cpu()
    host = [t.cpu() for t in (q, k, v)]
    cpu = fn(*host, Mesh.loopback(4, "cpu"))
    cpu_again = fn(*host, Mesh.loopback(4, "cpu"))
    exact = _attention_f64(q, k, v)
    lines = [fn.__name__]
    for name, a, b in (("card vs plain on the card", got, plain),
                       ("card vs card again", got, card_again),
                       ("plain on the card vs again", plain, plain_again),
                       ("cpu vs cpu again", cpu, cpu_again),
                       ("card vs float64", got, exact),
                       ("plain on the card vs float64", plain, exact),
                       ("cpu vs float64", cpu, exact)):
        dif = (a.double() - b.double()).abs()
        at = tuple(int(i) for i in torch.unravel_index(dif.argmax(),
                                                       dif.shape))
        lines.append(f"{name}: max {dif.max().item():.3g}, "
                     f"{int((dif > 1e-5).sum())} past 1e-5, at {at}")
    return "\n".join(lines)


class TestCpPrefillKernels:
    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("shape", [(4, 100, 8, 4, 128), (4, 70, 8, 8, 64),
                                       (1, 200, 4, 2, 16), (8, 33, 4, 4, 32)])
    def test_ring_attention_matches_plain(self, dev, shape, dtype, causal):
        """``tdt_ring_attention`` against the plain ring (JAX's body step
        by step) on strided views of a projection: partial last tiles
        (S 100, 70, 33), GQA (G = 2) and MHA, a ring of one block (the
        Ulysses local body), D 16 to 128. f32 within 1e-5; bf16 within
        one bf16 ulp of the plain output where it is at least 2^-4, and
        within one ulp past that tolerance everywhere (both compute in
        f32 and round once). One launch, counted under
        ``_kv_rotate_kernel``."""
        from triton_distributed_tpu_torch.kernels import (
            launches_by_tpu_kernel,
            reset_launch_counts,
        )

        n, s, hq, hkv, d = shape
        q, k, v = _cp_qkv(dev, n, 2, s, hq, hkv, d, getattr(torch, dtype),
                          seed=sum(shape))
        reset_launch_counts()
        got = cp_ring.ring_attention_launch(q, k, v, causal=causal,
                                            scale=d ** -0.5)
        assert launches_by_tpu_kernel() == {"_kv_rotate_kernel": 1}
        want = tra.ring_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.dtype == want.dtype
        if dtype == "float32":
            torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
        else:
            assert _bf16_excess(got, want) <= 1e-5
            big = want.float().abs() >= 2.0 ** -4
            assert _bf16_excess(got[big], want[big]) <= 0.0

    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("shape", [(2, 129, 8, 2, 128),
                                       (4, 191, 16, 2, 64),
                                       (8, 129, 4, 4, 32),
                                       (3, 191, 2, 1, 16)])
    def test_ring_attention_tc_edges(self, dev, shape, causal):
        """The bf16 kernel (tensor cores, 128 q rows a CTA, 64-key tiles)
        at its edges, under the tolerances of
        :meth:`test_ring_attention_matches_plain`: positions a rank that
        are a multiple of neither tile (129, 191), G = 4 and 8 (32 and 16
        tokens a q tile), a ring of 8 and of 3, D 128 down to 16 (K and V
        by TMA at D 64 and 128, by cp.async below)."""
        from triton_distributed_tpu_torch.kernels import (
            launches_by_tpu_kernel,
            reset_launch_counts,
        )

        n, s, hq, hkv, d = shape
        q, k, v = _cp_qkv(dev, n, 2, s, hq, hkv, d, torch.bfloat16,
                          seed=sum(shape) + causal)
        reset_launch_counts()
        got = cp_ring.ring_attention_launch(q, k, v, causal=causal,
                                            scale=d ** -0.5)
        assert launches_by_tpu_kernel() == {"_kv_rotate_kernel": 1}
        assert cp_ring.ring_attention_launch.by_variant == {
            "tma" if d >= 64 else "cp_async": 1}
        want = tra.ring_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.dtype == want.dtype
        assert _bf16_excess(got, want) <= 1e-5
        big = want.float().abs() >= 2.0 ** -4
        assert _bf16_excess(got[big], want[big]) <= 0.0

    def test_ring_attention_tc_narrow_copies(self, dev):
        """Views 8-byte but not 16-byte aligned (the projection's rows
        4 elements longer, q, k and v starting 4 elements in): the bf16
        kernel copies them by cp.async in 8-byte pieces (TMA cannot take
        them), within the same tolerances."""
        from triton_distributed_tpu_torch.kernels import reset_launch_counts

        n, b, s, hq, hkv, d = 4, 2, 70, 8, 2, 64
        g = torch.Generator(device=dev).manual_seed(3)
        w = (hq + 2 * hkv) * d
        qkv = torch.randn((b, n * s, w + 4), generator=g,
                          device=dev).to(torch.bfloat16)[..., 4:]
        q, k, v = (t.reshape(b, n, s, -1, d).transpose(0, 1) for t in
                   torch.split(qkv, [hq * d, hkv * d, hkv * d], dim=-1))
        assert q.data_ptr() % 16 == 8 and q.stride(2) * 2 % 16 == 8
        reset_launch_counts()
        got = cp_ring.ring_attention_launch(q, k, v, causal=True,
                                            scale=d ** -0.5)
        assert cp_ring.ring_attention_launch.by_variant == {"cp_async": 1}
        want = tra.ring_attention_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
        assert _bf16_excess(got, want) <= 1e-5
        big = want.float().abs() >= 2.0 ** -4
        assert _bf16_excess(got[big], want[big]) <= 0.0

    def test_ring_attention_bf16_lse(self, dev):
        """The bf16 kernel with ``lse=True`` against
        ``ring_attention_plain(return_lse=True)``: the output within the
        bf16 tolerances, each row's lse within 1e-5 relative (1e-5
        absolute where |lse| < 1: a causal row 0 sees one key, its lse
        that one score)."""
        q, k, v = _cp_qkv(dev, 4, 2, 100, 8, 4, 128, torch.bfloat16,
                          seed=11)
        got, lse = cp_ring.ring_attention_launch(q, k, v, causal=True,
                                                 scale=128 ** -0.5, lse=True)
        want, want_lse = tra.ring_attention_plain(q, k, v, return_lse=True)
        torch.cuda.synchronize()
        assert lse.shape == want_lse.shape and lse.dtype == torch.float32
        torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
        assert _bf16_excess(got, want) <= 1e-5
        big = want.float().abs() >= 2.0 ** -4
        assert _bf16_excess(got[big], want[big]) <= 0.0

    def test_ring_entries_run_the_kernel(self, dev):
        """``ring_attention`` and ``ulysses_attention`` on CUDA tensors:
        the ring one launch; Ulysses four all-to-alls (q, k, v out and
        the output back) and one launch of the ring kernel on a ring of
        one block; both within 1e-5 of their plain versions in f32 (GQA,
        the KV heads replicated for Ulysses at Hkv 2 < n 4) and of the
        float64 attention. The plain versions run on the card: run on the
        CPU inside a pytest process they moved now and then (two CPU runs
        of these inputs 5.1e-5 apart on 640 elements, the card's output
        and its plain version within 7e-7 of float64). On a miss the
        message names the side that moved (:func:`_ring_miss_sides`)."""
        from triton_distributed_tpu_torch.runtime import Mesh

        mesh = Mesh.loopback(4, dev)
        q, k, v = _cp_qkv(dev, 4, 2, 40, 8, 2, 64, torch.float32, seed=5)
        exact = _attention_f64(q, k, v)
        for fn in (tra.ring_attention, tra.ulysses_attention):
            before = launch_counts()
            got = fn(q, k, v, mesh)
            after = launch_counts()
            want = _entry_plain(fn, q, k, v)

            def sides(m, fn=fn, got=got):
                return m + "\n" + _ring_miss_sides(fn, q, k, v, mesh, got)

            torch.testing.assert_close(got, want, rtol=0, atol=1e-5,
                                       msg=sides)
            torch.testing.assert_close(got.cpu().double(), exact, rtol=0,
                                       atol=1e-5, msg=sides)
            a2a = 4 if fn is tra.ulysses_attention else 0
            assert after["ulysses_a2a"] - before["ulysses_a2a"] == a2a
            assert after["ring_attention"] - before["ring_attention"] == 1

    @pytest.mark.parametrize("entry", ["ring", "ulysses", "launch_lse",
                                       "launch_bf16"])
    def test_ring_entries_repeat_bit_identical(self, dev, entry):
        """The inputs of :meth:`test_ring_entries_run_the_kernel` through
        one entry 200 times (``launch_lse``: ``tdt_ring_attention`` with
        each row's lse): every call bit-identical to the first, out and
        lse, so no call read or wrote shared memory out of turn; the
        first within 1e-5 of the plain version run on the card and of the
        float64 attention (f32; :meth:`test_ring_entries_run_the_kernel`
        says why not on the CPU). ``launch_bf16``:
        the tensor-core kernel with its lse at partial q and key tiles
        (129 positions a rank, G 4), the first call within the bf16
        tolerances of :meth:`test_ring_attention_matches_plain` (lse
        within 1e-5)."""
        from triton_distributed_tpu_torch.runtime import Mesh

        mesh = Mesh.loopback(4, dev)
        if entry == "launch_bf16":
            q, k, v = _cp_qkv(dev, 4, 2, 129, 8, 2, 128, torch.bfloat16,
                              seed=7)

            def call():
                return cp_ring.ring_attention_launch(
                    q, k, v, causal=True, scale=128 ** -0.5, lse=True)
            first = call()
            want, want_lse = tra.ring_attention_plain(q, k, v,
                                                      return_lse=True)
            torch.cuda.synchronize()
            assert _bf16_excess(first[0], want) <= 1e-5
            big = want.float().abs() >= 2.0 ** -4
            assert _bf16_excess(first[0][big], want[big]) <= 0.0
            torch.testing.assert_close(first[1], want_lse, rtol=1e-5,
                                       atol=1e-5)
            apart = 0
            for _ in range(199):
                apart += not all(torch.equal(a, b)
                                 for a, b in zip(call(), first))
            assert apart == 0, f"{apart} of 199 calls differ from the first"
            return
        q, k, v = _cp_qkv(dev, 4, 2, 40, 8, 2, 64, torch.float32, seed=5)
        fn = {"ring": tra.ring_attention,
              "ulysses": tra.ulysses_attention}.get(entry, tra.ring_attention)
        if entry == "launch_lse":
            def call():
                return cp_ring.ring_attention_launch(
                    q, k, v, causal=True, scale=64 ** -0.5, lse=True)
            want = tra.ring_attention_plain(q, k, v, return_lse=True)
        else:
            def call():
                return (fn(q, k, v, mesh),)
            want = (_entry_plain(fn, q, k, v),)
        first = call()

        def sides(m):
            return m + "\n" + _ring_miss_sides(fn, q, k, v, mesh, first[0])

        for got, w in zip(first, want):
            torch.testing.assert_close(got, w, rtol=0, atol=1e-5, msg=sides)
        torch.testing.assert_close(first[0].cpu().double(),
                                   _attention_f64(q, k, v), rtol=0,
                                   atol=1e-5, msg=sides)
        apart = 0
        for _ in range(199):
            apart += not all(torch.equal(a, b) for a, b in zip(call(), first))
        assert apart == 0, f"{apart} of 199 calls differ from the first"

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("n", [2, 4, 8])
    def test_ulysses_a2a_is_byte_exact(self, dev, n, dtype):
        """``tdt_ulysses_a2a`` both directions against the plain layout
        byte for byte: the scatter on strided views of a projection, the
        gather on the local attention's contiguous output; the gather's
        view of a (B, n, S, H, D) tensor; one launch each."""
        q, _, _ = _cp_qkv(dev, n, 2, 9, 2 * n, n, 32, getattr(torch, dtype),
                          seed=n)
        before = launch_counts()["ulysses_a2a"]
        sc = cp_ring.ulysses_a2a(q, "scatter")
        assert torch.equal(sc, cp_ring.ulysses_a2a_plain(q, "scatter"))
        ga = cp_ring.ulysses_a2a(sc, "gather")
        assert torch.equal(ga, cp_ring.ulysses_a2a_plain(sc, "gather"))
        assert torch.equal(ga, q)
        assert ga.transpose(0, 1).is_contiguous()
        assert launch_counts()["ulysses_a2a"] == before + 2

    def test_wrappers_refuse_what_the_kernels_do_not_take(self, dev):
        q, k, v = _cp_qkv(dev, 4, 1, 16, 6, 2, 64, torch.float32, seed=1)
        with pytest.raises(ValueError, match="f32 or bf16"):
            cp_ring.ring_attention_launch(q.half(), k.half(), v.half(),
                                          causal=True, scale=0.1)
        with pytest.raises(ValueError, match="head dims"):
            cp_ring.ring_attention_launch(q[..., :48], k[..., :48],
                                          v[..., :48], causal=True,
                                          scale=0.1)
        with pytest.raises(ValueError, match="G = Hq / Hkv"):
            cp_ring.ring_attention_launch(q, k, v, causal=True, scale=0.1)
        q8, _, _ = _cp_qkv(dev, 4, 1, 16, 8, 4, 64, torch.float32, seed=2)
        with pytest.raises(ValueError, match="contiguous"):
            cp_ring.ulysses_a2a(q8[..., ::2], "scatter")
        with pytest.raises(ValueError, match="does not split"):
            cp_ring.ulysses_a2a(q8[:, :, :, :5], "scatter")


def test_cp_prefill_generate_on_card_equals_cpu(dev):
    """The tiny model at ``attn="ring"`` and ``"ulysses"`` on 4 ranks, on
    the card and on the CPU from the same weights: the prefill's logits
    within 1e-4 (f32, sums in another order), then 4 greedy steps in
    lockstep on the CPU side's tokens, logits within 1e-4. The card's
    prefill launches the ring kernel once a layer and, for Ulysses, the
    all-to-all four times a layer."""
    from triton_distributed_tpu_torch.kernels import reset_launch_counts
    from triton_distributed_tpu_torch.models import Transformer, presets
    from triton_distributed_tpu_torch.runtime import Mesh

    for attn in ("ring", "ulysses"):
        cfg = presets.tiny(attn=attn)
        params = Transformer(cfg, device="cpu").init(
            torch.Generator().manual_seed(0))
        toks = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab, (2, 32)).astype(np.int32))
        runs = []
        for d in ("cpu", dev):
            model = Transformer(cfg, mesh=Mesh.loopback(4, d))
            p = model.shard_params(_to(params, d))
            reset_launch_counts()
            last, caches, kl = model.prefill(p, model.init_cache(2, 48),
                                             toks.to(d))
            counts = launch_counts()
            runs.append([model, p, caches, kl, last])
        assert counts["ring_attention"] == cfg.n_layers
        assert counts["ulysses_a2a"] == (4 * cfg.n_layers
                                         if attn == "ulysses" else 0)
        (mc, pc, cc, kc, lc), (mg, pg, cg, kg, lg) = runs
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
        for _ in range(4):
            t = torch.argmax(lc, -1).to(torch.int32)
            lc, cc, kc = mc.decode_step(pc, cc, kc, t)
            lg, cg, kg = mg.decode_step(pg, cg, kg, t.to(dev))
            torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------ KV-page ship

from triton_distributed_tpu_torch.kernels import kv_ship as ks  # noqa: E402


def _ship_pools(dev, layers, npages, seed, hkv=2, page=8, d=128, quant=True):
    """Seeded per-layer (K, V) pools: int8 dicts with f32 scale planes,
    or bf16 tensors."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def pool():
        if not quant:
            return torch.randn((npages, hkv, page, d), generator=g,
                               device=dev).to(torch.bfloat16)
        return {"q": torch.randint(-128, 128, (npages, hkv, page, d),
                                   generator=g, device=dev,
                                   dtype=torch.int8),
                "scale": torch.rand((npages, hkv, page), generator=g,
                                    device=dev)}

    return tuple((pool(), pool()) for _ in range(layers))


def _ship_leaves(layers):
    return [t for pair in layers for p in pair
            for t in ((p["q"], p["scale"]) if isinstance(p, dict) else (p,))]


class TestKvShipKernel:
    @pytest.mark.parametrize("n", [2, 4])
    @pytest.mark.parametrize("coalesce", [1, 2, 4])
    @pytest.mark.parametrize("rows,cols,pages", [(8, 128, 4), (256, 128, 64)])
    def test_mesh_form_is_byte_exact(self, dev, n, coalesce, rows, cols,
                                     pages):
        """JAX's layout (the lint geometry and a full DeepSeek page):
        every rank's staged pages and scale rows land on rank
        (r + n/2) % n at the coalesced landing table, byte for byte."""
        from triton_distributed_tpu_torch.runtime import Mesh
        from triton_distributed_tpu_torch.tune.schedule import GridSchedule

        g = torch.Generator(device=dev).manual_seed(n * 10 + coalesce)
        q = [torch.randint(-128, 128, (pages * rows, cols), generator=g,
                           device=dev, dtype=torch.int8) for _ in range(n)]
        s = [torch.randn((pages * rows, 128), generator=g, device=dev)
             for _ in range(n)]
        table = ks.coalesced_landing_table(pages, coalesce)
        mesh = Mesh.loopback(n, dev, axis="x")
        before = launch_counts()["kv_ship"]
        got = ks.kv_ship(q, s, [table] * n, mesh, "x",
                         schedule=GridSchedule(coalesce=coalesce))
        assert launch_counts()["kv_ship"] == before + 1
        want = ks.kv_ship([t.cpu() for t in q], [t.cpu() for t in s],
                          [table] * n, Mesh.loopback(n, "cpu", axis="x"),
                          "x", schedule=GridSchedule(coalesce=coalesce))
        for a, b in zip(got[0] + got[1], want[0] + want[1]):
            assert torch.equal(a.cpu(), b)

    @pytest.mark.parametrize("quant", [True, False])
    def test_engine_form_is_byte_exact(self, dev, quant):
        """Every layer's pools and both rails in one launch, source pages
        scattered, landing reversed: equal to the plain version on the
        same pools, and pages outside the landing set untouched."""
        src = _ship_pools(dev, 3, 24, 1, quant=quant)
        dst = _ship_pools(dev, 3, 20, 2, quant=quant)
        ref = tuple(tuple({k: v.clone() for k, v in p.items()}
                          if isinstance(p, dict) else p.clone() for p in pair)
                    for pair in dst)
        sp = [23, 0, 7, 5, 11, 2, 19]
        dp = list(range(len(sp)))[::-1]
        before = launch_counts()["kv_ship"]
        ks.ship_kv_pages(src, dst, sp, dp)
        assert launch_counts()["kv_ship"] == before + 1
        ks.kv_ship_plain([(a, b, 0) for a, b in zip(_ship_leaves(src),
                                                    _ship_leaves(ref))],
                         [sp], [dp])
        for a, b in zip(_ship_leaves(dst), _ship_leaves(ref)):
            assert torch.equal(a, b)

    def test_a_stale_table_is_rebuilt(self, dev):
        """The engine's table follows the pools' storage."""
        table = ks.ShipTable()
        src = _ship_pools(dev, 1, 4, 3)
        for seed in (4, 5):
            dst = _ship_pools(dev, 1, 4, seed)
            ks.ship_kv_pages(src, dst, [0, 1], [3, 2], table=table)
            assert torch.equal(dst[0][0]["q"][3], src[0][0]["q"][0])
            assert torch.equal(dst[0][1]["scale"][2], src[0][1]["scale"][1])

    def test_refuses_a_non_contiguous_coalesced_table(self, dev):
        from triton_distributed_tpu_torch.runtime import Mesh
        from triton_distributed_tpu_torch.tune.schedule import GridSchedule

        q = [torch.zeros((32, 128), dtype=torch.int8, device=dev)] * 2
        s = [torch.zeros((32, 128), device=dev)] * 2
        before = launch_counts()["kv_ship"]
        with pytest.raises(ValueError, match="contiguous run"):
            ks.kv_ship(q, s, [[1, 0, 3, 2]] * 2,
                       Mesh.loopback(2, dev, axis="x"), "x",
                       schedule=GridSchedule(coalesce=2))
        assert launch_counts()["kv_ship"] == before


def test_disaggregated_engine_on_card_equals_colocated(dev):
    """A tiny int8-KV DisaggregatedEngine on the card, both roles on the
    one card: token streams equal the colocated engine's on the card and
    the disaggregated engine's on the CPU; one ship launch a cohort and
    no plain ship."""
    from triton_distributed_tpu_torch.kernels import reset_launch_counts
    from triton_distributed_tpu_torch.models import (
        Transformer,
        TransformerConfig,
    )
    from triton_distributed_tpu_torch.runtime import Mesh
    from triton_distributed_tpu_torch.serving import (
        DisaggregatedEngine,
        EngineConfig,
        ServingEngine,
        poisson_trace,
    )

    cfg = TransformerConfig(vocab=128, n_layers=2, hidden=64, ffn=128,
                            n_heads=4, n_kv_heads=2, head_dim=16,
                            dtype="float32", param_dtype="float32",
                            kv_quant="int8")
    params = Transformer(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    ecfg = EngineConfig(slots=4, token_budget=48, chunk=16, page=8,
                        npages=32)
    streams = {}
    for d in ("cpu", dev):
        model = Transformer(cfg, device=d)
        p = _to(params, d)
        tc = poisson_trace(7, 6, 1.0, 5, 30, 3, 6, 128)
        ServingEngine(model, p, ecfg).run(tc)
        streams[f"colocated {d}"] = [r.generated for r in tc]
        eng = DisaggregatedEngine(model, p, model, p, ecfg,
                                  hybrid_mesh=Mesh.grid({"dcn": 2, "tp": 1},
                                                        d),
                                  ship_delay_steps=1)
        ticks = set()
        commit = eng._commit_ships

        def counted():
            done = commit()
            ticks.update(r.issued_tick for r in done)
            return done

        eng._commit_ships = counted
        td = poisson_trace(7, 6, 1.0, 5, 30, 3, 6, 128)
        reset_launch_counts()
        st = eng.run(td)
        streams[f"disagg {d}"] = [r.generated for r in td]
        assert st.completed == 6 and st.ships > 0
    assert launch_counts()["kv_ship"] == len(ticks) > 0
    first = streams["colocated cpu"]
    assert all(v == first for v in streams.values()), streams


def test_ep_router_rows_do_not_depend_on_the_batch(dev):
    """The EP block's router product runs the float-mode grouped GEMM:
    a row's logits are the same bits in a 768-row batch (the colocated
    serving step) as in its 256-row slice (the disaggregated decode
    role's step), where cuBLAS's f32 matmul picked another summation
    order for the two shapes. Within 1e-5 of the largest logit of the
    f32 product (2048-term f32 sums in another order)."""
    from triton_distributed_tpu_torch.models import Transformer

    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((768, 2048), generator=g, device=dev).to(torch.bfloat16)
    r = torch.randn((2048, 64), generator=g, device=dev).to(torch.bfloat16)
    before = launch_counts()["ggemm_f32"]
    full = Transformer._router_logits(x, r)
    assert launch_counts()["ggemm_f32"] == before + 1
    for s0 in (0, 256, 512):
        part = Transformer._router_logits(x[s0:s0 + 256], r)
        assert torch.equal(full[s0:s0 + 256], part)
    ref = x.float() @ r.float()
    assert (full - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("m, k, n", [(768, 2048, 64), (37, 100, 50)])
def test_float_gemm_narrow_tiles_equal_the_wide_ones(dev, m, k, n):
    """A dense f32 product at N <= 64 runs the 8-row-tile kernel; its
    bits equal the 64 x 64 tile kernel's, which the same product runs as
    the first N columns of a 128-column one (ragged M, K and N too)."""
    from triton_distributed_tpu_torch.kernels.group_gemm import float_gemm

    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((m, k), generator=g, device=dev)
    w = torch.randn((k, 128), generator=g, device=dev)
    wide = float_gemm(x, w, torch.float32)[:, :n]
    narrow = float_gemm(x, w[:, :n], torch.float32)
    assert torch.equal(narrow, wide)
    assert torch.equal(float_gemm(x, w[:, :n], torch.bfloat16),
                       wide.to(torch.bfloat16))


@pytest.mark.parametrize("m", [1, 8, 768])
def test_router_logits_take_bf16_x_at_the_fma_bits(dev, m):
    """``router_logits`` on bf16 x (and an f32 or a bf16 router) runs one
    launch of the narrow f32 kernel on the operands as they are: the bits
    of ``float_gemm`` on the widened f32 operands (bf16 -> f32 is exact),
    which are the bits of the 64 x 64 FMA kernel (``float_gemm`` at N 128,
    its first 64 columns), at 1, 8 and 768 rows."""
    from triton_distributed_tpu_torch.kernels.group_gemm import (
        float_gemm,
        router_logits,
    )

    g = torch.Generator(device=dev).manual_seed(m)
    x = torch.randn((m, 2048), generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn((2048, 128), generator=g, device=dev)
    wide = float_gemm(x.float(), w, torch.float32)[:, :64]
    for r in (w[:, :64].contiguous(), w[:, :64].to(torch.bfloat16)):
        before = launch_counts()["ggemm_f32"]
        got = router_logits(x, r)
        assert launch_counts()["ggemm_f32"] == before + 1
        assert got.dtype == torch.float32 and got.shape == (m, 64)
        assert torch.equal(got, float_gemm(x.float(), r.float(),
                                           torch.float32))
        if r.dtype == torch.float32:
            assert torch.equal(got, wide)


def test_router_logits_repeat_bit_identical(dev):
    """200 calls of ``router_logits`` at the serving step's shape (bf16
    x, f32 router): every call the bits of the first."""
    from triton_distributed_tpu_torch.kernels.group_gemm import router_logits

    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((768, 2048), generator=g, device=dev).to(torch.bfloat16)
    r = torch.randn((2048, 64), generator=g, device=dev)
    first = router_logits(x, r)
    apart = sum(not torch.equal(router_logits(x, r), first)
                for _ in range(199))
    assert apart == 0


def test_router_logits_strided_rows(dev):
    """x rows at a pitch wider than K (a column slice of a wider tensor)
    and rows not 16-byte aligned: the same bits as the contiguous rows."""
    from triton_distributed_tpu_torch.kernels.group_gemm import router_logits

    g = torch.Generator(device=dev).manual_seed(3)
    wide = torch.randn((40, 2048 + 24), generator=g, device=dev).to(
        torch.bfloat16)
    r = torch.randn((2048, 64), generator=g, device=dev)
    for x in (wide[:, :2048], wide[:, 3:2051]):
        assert torch.equal(router_logits(x, r),
                           router_logits(x.contiguous(), r))


# ------------------------------------------- the routers of every MoE path


class _Stop(Exception):
    pass


@pytest.mark.parametrize("path", ["ep_prefill", "tp_prefill", "tp_decode"])
def test_moe_router_rows_do_not_depend_on_the_batch(dev, monkeypatch, path):
    """Every MoE path routes on the float-mode kernel: the EP prefill
    (``EPMoEMLP``), the TP flavour's prefill (``_mlp_block``) and its
    decode (``_moe_tp``). Each path's router logits for a 256-row slice
    are the bits of the same rows in a 768-row batch, one ``ggemm_f32``
    launch a call."""
    from triton_distributed_tpu_torch.kernels import moe_utils
    from triton_distributed_tpu_torch.layers import moe as lmoe
    from triton_distributed_tpu_torch.models import Transformer, presets

    seen = []

    def record(logits, *a, **k):
        seen.append(logits.clone())
        raise _Stop

    if path == "ep_prefill":
        monkeypatch.setattr(lmoe, "ep_moe", lambda x, logits, *a, **k:
                            record(logits))
        cfg = presets.deepseek_moe_16b(moe_weight_quant=None,
                                       moe_act_quant=None)
    else:
        monkeypatch.setattr(moe_utils, "select_experts", record)
        cfg = presets.deepseek_moe_16b(moe="tp", moe_weight_quant=None,
                                       moe_act_quant=None)
    model = Transformer(cfg, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    e = cfg.num_experts
    blk = {"router": torch.randn((cfg.hidden, e), generator=g, device=dev),
           "moe_up": torch.zeros((e, 1, 1), device=dev),
           "moe_down": torch.zeros((e, 1, 1), device=dev)}
    x = torch.randn((768, cfg.hidden), generator=g, device=dev).to(
        torch.bfloat16)

    def route(rows):
        before = launch_counts()["ggemm_f32"]
        with pytest.raises(_Stop):
            if path == "tp_decode":
                model._moe_tp(blk, rows)
            else:
                model._mlp_block(blk, rows, inference=path == "tp_prefill")
        assert launch_counts()["ggemm_f32"] == before + 1
        return seen[-1]

    full = route(x)
    for s0 in (0, 256, 512):
        assert torch.equal(route(x[s0:s0 + 256]), full[s0:s0 + 256])


# ------------------------------------------------------- the gradient ring

from triton_distributed_tpu_torch.kernels import cp_ring as tcp  # noqa: E402
from triton_distributed_tpu_torch.lang import wire as twire  # noqa: E402
from triton_distributed_tpu_torch.tune.schedule import RingSchedule  # noqa: E402


def _grad_slabs(dev, g, n, srows, cols, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((g, n, n * srows, cols), generator=gen, device=dev)
    # rows of every magnitude, one near-zero row (scale clamp) and a tie
    x[..., 1, :] *= 1e-3
    x[..., 2, :] = 0.0
    return x


class TestGradRingKernel:
    @pytest.mark.parametrize("depth", [2, 3])
    @pytest.mark.parametrize("stochastic", [True, False])
    @pytest.mark.parametrize("ef", [True, False])
    @pytest.mark.parametrize("wire", ["int8", "fp8"])
    @pytest.mark.parametrize("n", [2, 4, 8])
    def test_is_bit_exact(self, dev, n, wire, ef, stochastic, depth):
        """Ragged rows and columns (3 rings, 5 stripe rows, 200 columns,
        one scale a row) in every mode: the kernel's bits are the plain
        version's; depth 3 gives depth 2's bits, counted apart."""
        x = _grad_slabs(dev, 3, n, 5, 200, seed=n)
        kw = dict(wire=wire, seed=17, ef=ef, stochastic=stochastic)
        before = dict(tcp._grad_ring_cuda.by_tpu_kernel)
        got = tcp.grad_ring(x, schedule=RingSchedule(depth=depth), **kw)
        want = tcp.grad_ring_plain(x, **kw)
        name = "_grad_ring_kernel_w3" if depth == 3 else "_grad_ring_kernel_w"
        assert (tcp._grad_ring_cuda.by_tpu_kernel.get(name, 0)
                == before.get(name, 0) + 1)
        assert torch.equal(got, want)

    @pytest.mark.parametrize("n", [2, 4])
    def test_lint_geometry_is_bit_exact(self, dev, n):
        """The TPU kernel's own mode: no feedback, round to nearest,
        make_wire_format's 8-row chunk over 2048 columns."""
        g = tcp.CP_RING_GEOM
        x = _grad_slabs(dev, 1, n, g["rows"], g["grad_cols"], seed=10 + n)
        fmt = twire.make_wire_format("int8", g["rows"])
        kw = dict(wire="int8", ef=False, stochastic=False,
                  chunk_rows=fmt.chunk_rows)
        assert torch.equal(tcp.grad_ring(x, **kw), tcp.grad_ring_plain(x, **kw))

    def test_strided_rings_and_the_cpu_draw_the_same_bits(self, dev):
        """The trainer's view, (G, n) strides of a (n, G, rows, cols)
        buffer, equals the contiguous input; the card's hash uniforms are
        the CPU's (the CPU plain version gives the card's bits)."""
        x = _grad_slabs(dev, 4, 2, 6, 128, seed=3)
        buf = x.transpose(0, 1).contiguous()
        view = buf.transpose(0, 1)
        got = tcp.grad_ring(view, wire="int8", seed=5)
        assert torch.equal(got, tcp.grad_ring(x, wire="int8", seed=5))
        cpu = tcp.grad_ring(x.cpu(), wire="int8", seed=5)
        assert torch.equal(got.cpu(), cpu)
        assert torch.equal(twire.sr_uniforms(9, 3, 1, 40, 130, device=dev)
                           .cpu(), twire.sr_uniforms(9, 3, 1, 40, 130))

    @pytest.mark.parametrize("wire", ["int8", "fp8"])
    def test_allgather_is_bit_exact_in_place(self, dev, wire):
        """The all-gather half: every rank's slab gets every owner's
        stripe dequantized from one set of codes, the plain version's
        bits, written in place into the (strided) ring input."""
        x = _grad_slabs(dev, 3, 4, 5, 200, seed=7)
        red = tcp.grad_ring(x, wire=wire, seed=1)
        want = tcp.grad_allgather_plain(red, wire=wire, seed=2)
        before = launch_counts()["grad_allgather"]
        buf = torch.zeros_like(x.transpose(0, 1)).transpose(0, 1)
        got = tcp.grad_allgather(red, wire=wire, seed=2, out=buf)
        assert launch_counts()["grad_allgather"] == before + 1
        assert got is buf and torch.equal(buf, want)
        for r in range(1, 4):
            assert torch.equal(buf[:, r], buf[:, 0])

    def test_refuses_what_the_kernel_does_not_hold(self, dev):
        x = torch.zeros((1, 4, 4 * 64, 4096), device=dev)
        with pytest.raises(ValueError, match="shared memory"):
            tcp.grad_ring(x, wire="int8", chunk_rows=64)
        with pytest.raises(ValueError, match="contiguous"):
            tcp.grad_ring(x.transpose(2, 3), wire="int8")


def test_overlap_backward_on_card_equals_cpu(dev):
    """The overlap ops' backward over a 4-rank loopback mesh on the card
    (the dual kernels tdt_gemm_rs / tdt_ag_gemm, the gather, and on the
    int8 wire the gradient ring) against the same on the CPU: f32
    gradients within 1e-5 of the largest (sums in another order); the
    int8 duals within 5e-2 (another order upstream may move a code)."""
    from triton_distributed_tpu_torch.ops import overlap as tov
    from triton_distributed_tpu_torch.runtime import Mesh

    rng = np.random.default_rng(0)
    a = rng.standard_normal((256, 128)).astype(np.float32)
    b = rng.standard_normal((128, 256)).astype(np.float32)
    w = rng.standard_normal((256, 256)).astype(np.float32)
    for op, bw in (("ag_gemm", None), ("gemm_rs", None), ("ag_gemm", "int8"),
                   ("gemm_rs", "int8")):
        grads = []
        for d in ("cpu", dev):
            mesh = Mesh.loopback(4, d)
            ctx = tov.OverlapContext(mesh=mesh, bwd_wire_dtype=bw)
            at, bt, wt = (_t(v, d) for v in (a, b, w))
            if op == "ag_gemm":
                sa, sb, ws = at.chunk(4, 0), bt.chunk(4, 1), wt.chunk(4, 1)
            else:
                sa, sb, ws = at.chunk(4, 1), bt.chunk(4, 0), wt.chunk(4, 0)
            sa = [s.contiguous().requires_grad_() for s in sa]
            sb = [s.contiguous().requires_grad_() for s in sb]
            out = getattr(tov, op)(sa, sb, ctx)
            sum((o * wr).sum() for o, wr in zip(out, ws)).backward()
            grads.append([torch.cat([s.grad for s in sa]).cpu(),
                          torch.cat([s.grad for s in sb]).cpu()])
        tol = 1e-5 if bw is None else 5e-2
        for c, g in zip(*grads):
            assert (g - c).abs().max() <= tol * c.abs().max(), (op, bw)


def test_trainer_step_on_card_equals_cpu(dev):
    """Two steps of a tiny dp 2 × tp 2 × cp 2 trainer on the int8 ring
    (head dim 16, the ring kernel's smallest), on the card (ring
    attention, the gradient ring and its all-gather on their kernels)
    and on the CPU from the same parameters: losses within 1e-4; every
    kernel of the path launched."""
    from triton_distributed_tpu_torch.kernels import reset_launch_counts
    from triton_distributed_tpu_torch.train import step as tstep

    cfg = tstep.TrainConfig(d_model=64, d_ff=128)
    params = tstep.init_params(cfg, device="cpu")
    losses = []
    for d in ("cpu", dev):
        tr = tstep.Trainer(cfg, tstep.default_train_mesh(cfg, d),
                           params={k: v.to(d) for k, v in params.items()})
        reset_launch_counts()
        losses.append([r["loss"] for r in tr.run(2)])
    counts = launch_counts()
    assert counts["grad_ring"] == 2 and counts["grad_allgather"] == 2
    assert counts["ring_attention"] == 2 * cfg.microbatches
    for a, b in zip(*losses):
        assert abs(a - b) <= 1e-4, losses


def test_transformer_train_step_tp4_on_card_equals_cpu(dev):
    """``Transformer.train_step`` of a tiny f32 model on a 4-rank loopback
    mesh, on the card (the forward's mesh GEMMs and their dual kernels in
    the backward) and on the CPU: loss within 1e-5, new parameters within
    1e-5 of the largest (lr 1: the step is the gradient)."""
    from triton_distributed_tpu_torch.models import (
        Transformer,
        TransformerConfig,
    )
    from triton_distributed_tpu_torch.runtime import Mesh

    cfg = TransformerConfig(vocab=128, n_layers=2, hidden=128, ffn=256,
                            n_heads=8, n_kv_heads=4, head_dim=16,
                            dtype="float32", param_dtype="float32")
    params = Transformer(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    tok = torch.randint(0, 128, (2, 64), generator=torch.Generator()
                        .manual_seed(1))
    out = []
    for d in ("cpu", dev):
        model = Transformer(cfg, mesh=Mesh.loopback(4, d))
        p = model.shard_params(_to(params, d))
        before = launch_counts()
        loss, new = model.train_step(p, tok.to(d), tok.to(d), lr=1.0)
        out.append((float(loss), model.unshard_params(new)))
    after = launch_counts()
    assert after["ag_gemm"] > before["ag_gemm"]
    assert after["gemm_rs"] > before["gemm_rs"]
    assert abs(out[0][0] - out[1][0]) <= 1e-5
    wc, wg = out[0][1]["blocks"][0]["up"], out[1][1]["blocks"][0]["up"]
    assert (wg.cpu() - wc).abs().max() <= 1e-5 * max(1.0, wc.abs().max())
