"""Parity of the PyTorch port's MoE prefill → decode path with the JAX package.

The same inputs, drawn with numpy from a seed, go through the JAX
function and the port's counterpart, whose CPU path is the plain
PyTorch version: the MoE-TP routing and overlapped ops (JAX's Pallas
engines of kernels/moe_tp_fused.py run in interpret mode on the
one-device mesh, as tests/test_moe_tp.py runs them), the EP MoE MLP and
``EPMoEMLP`` as prefill runs them (the port's fused transport with no
quantization on float experts against JAX's full-precision ``xla``
transport, which widens int8 dicts itself), and ``prefill``
+ ``generate`` of the tiny DeepSeek-MoE preset in its EP (as served:
fp8 wire, W8A8 int8 experts, int8 KV and dense weights) and TP (bf16
experts → f32 at the tiny size) flavours, contiguous and paged. The JAX
EP decode is pinned to the fused transport a TPU runs
(``_torch_moe_ref.tpu_moe``). The CUDA kernels are held against the
plain versions in tests/test_torch_cuda.py.

Tolerances: f32 sums in another order, 1e-5 relative; in bf16 each side
rounds its f32 sums to bf16 once, so two results are at most one bf16
ulp apart (2^-7 relative), and values near zero get 2^-7 of the
output's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from _torch_moe_ref import tpu_moe  # noqa: F401 (the fixture)
from triton_distributed_tpu import ops as jops
from triton_distributed_tpu.kernels import moe_utils as jmu
from triton_distributed_tpu.kernels.group_gemm import (
    quantize_grouped_weights as j_quantize_grouped_weights,
)
from triton_distributed_tpu.layers import EPMoEMLP as JEPMoEMLP
from triton_distributed_tpu.models import Transformer as JTransformer
from triton_distributed_tpu.models import presets as jpresets
from triton_distributed_tpu_torch import ops
from triton_distributed_tpu_torch.kernels import moe_tp_fused as mtf
from triton_distributed_tpu_torch.kernels import moe_utils as mu
from triton_distributed_tpu_torch.kernels.group_gemm import (
    dequantize_grouped_weights,
)
from triton_distributed_tpu_torch.layers import EPMoEMLP
from triton_distributed_tpu_torch.models import (
    Transformer,
    TransformerConfig,
    params_from_numpy,
    presets,
)
from triton_distributed_tpu_torch.tools import generate as tgen

#: the tiny preset's MoE geometry: 32 tokens (B 2 × 16), hidden 128,
#: ffn 256, 8 experts, top-2
M, H, F, E, K = 32, 128, 256, 8, 2
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
def mesh1():
    return Mesh(np.asarray(jax.devices()[:1]), ("tp",))


def _t(a, dtype=None):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
        dtype = dtype or torch.bfloat16
    return torch.from_numpy(np.array(a, copy=True)).to(dtype)


def _close(got, want, dtype):
    """``got`` (torch) against ``want`` (JAX) at the module's stated
    tolerance for ``dtype``."""
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        tol = 2.0 ** -7
        np.testing.assert_allclose(got, want, rtol=tol,
                                   atol=tol * np.abs(want).max())


def _moe_data(seed=0):
    """x (M, H), the router's logits with expert 3 starved (an empty
    expert) and expert 0 favoured, (E, H, F) / (E, F, H) weights."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, H)).astype(np.float32)
    logits = rng.standard_normal((M, E)).astype(np.float32)
    logits[:, 3] = -30.0
    logits[: M // 2, 0] += 4.0
    w_up = (rng.standard_normal((E, H, F)) / np.sqrt(H)).astype(np.float32)
    w_down = (rng.standard_normal((E, F, H)) / np.sqrt(F)).astype(np.float32)
    return x, logits, w_up, w_down


def _routing(logits):
    """The same routing on both sides: JAX's select_experts, whose
    weights and ids the port's must equal."""
    jw, jids = jmu.select_experts(jnp.asarray(logits), K)
    tw, tids = mu.select_experts(_t(logits), K)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
    return (jw, jids), (tw, tids)


def _contexts(mesh, dtype):
    jdt, tdt = DTYPES[dtype]
    jctx = jops.create_ag_group_gemm_context(mesh, "tp", num_experts=E,
                                             topk=K, dtype=jdt)
    tctx = ops.create_ag_group_gemm_context(num_experts=E, topk=K, dtype=tdt)
    return jctx, tctx


# ------------------------------------------------------------------ MoE-TP

class TestMoETP:
    def test_align_routing_sharded_equals_jax(self, mesh1):
        """sti, be and splits equal JAX's integer for integer (block_m
        128, one shard), the starved expert counted as 0."""
        _, logits, _, _ = _moe_data()
        (_, jids), (_, tids) = _routing(logits)
        jctx, tctx = _contexts(mesh1, "float32")
        jr = jops.align_routing_sharded(jctx, jids)
        tr = ops.align_routing_sharded(tctx, tids)
        assert tr.cap_s == jr.cap_s and tctx.block_m == jctx.block_m == 128
        for name in ("sti", "be", "splits"):
            want = np.asarray(getattr(jr, name))
            assert want.shape[0] == 1          # JAX stacks its one shard
            np.testing.assert_array_equal(getattr(tr, name).numpy(), want[0])
        assert int(tr.splits[3]) == 0

    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    def test_ag_group_gemm_fused_matches_jax(self, mesh1, dtype):
        """The up projection over the per-shard sorted rows; the padding
        rows are exactly zero on both sides."""
        x, logits, w_up, _ = _moe_data(1)
        (_, jids), (_, tids) = _routing(logits)
        jctx, tctx = _contexts(mesh1, dtype)
        jdt, tdt = DTYPES[dtype]
        jr = jops.align_routing_sharded(jctx, jids)
        tr = ops.align_routing_sharded(tctx, tids)
        want = jops.ag_group_gemm_fused(jnp.asarray(x, jdt), jr,
                                        jnp.asarray(w_up, jdt), jctx)
        got = ops.ag_group_gemm_fused(_t(x, tdt), tr, _t(w_up, tdt), tctx)
        assert got.dtype == tdt and tuple(got.shape) == want.shape
        _close(got, want, dtype)
        pad = (tr.sti >= M * K).numpy()
        assert pad.any()
        assert (got.float().numpy()[pad] == 0).all()
        assert (np.asarray(want, np.float32)[pad] == 0).all()

    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    def test_moe_reduce_rs_fused_matches_jax(self, mesh1, dtype):
        """The down projection and the top-k combine, from sorted rows
        that are zero at the padding (as the up projection leaves
        them)."""
        _, logits, _, w_down = _moe_data(2)
        (jw, jids), (tw, tids) = _routing(logits)
        jctx, tctx = _contexts(mesh1, dtype)
        jdt, tdt = DTYPES[dtype]
        jr = jops.align_routing_sharded(jctx, jids)
        tr = ops.align_routing_sharded(tctx, tids)
        rng = np.random.default_rng(3)
        y = rng.standard_normal((tr.cap_s, F)).astype(np.float32)
        y[(tr.sti >= M * K).numpy()] = 0.0
        want = jops.moe_reduce_rs_fused(jnp.asarray(y, jdt), jr, jw,
                                        jnp.asarray(w_down, jdt), jctx)
        got = ops.moe_reduce_rs_fused(_t(y, tdt), tr, tw, _t(w_down, tdt),
                                      tctx)
        assert got.dtype == tdt and tuple(got.shape) == (M, H)
        _close(got, want, dtype)

    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    def test_moe_tp_mlp_overlapped_matches_jax(self, mesh1, dtype):
        """The whole overlapped MLP (activation in f32, cast to the
        compute dtype between the two kernels). In bf16 the hidden
        activation is rounded on each side before the down projection,
        so the tolerance is taken against the largest output."""
        x, logits, w_up, w_down = _moe_data(4)
        (jw, jids), (tw, tids) = _routing(logits)
        jctx, tctx = _contexts(mesh1, dtype)
        jdt, tdt = DTYPES[dtype]
        want = jops.moe_tp_mlp_overlapped(
            jnp.asarray(x, jdt), jids, jw, jnp.asarray(w_up, jdt),
            jnp.asarray(w_down, jdt), jctx)
        got = ops.moe_tp_mlp_overlapped(_t(x, tdt), tids, tw, _t(w_up, tdt),
                                        _t(w_down, tdt), tctx)
        _close(got, want, dtype)

    def test_kernels_plain_versions(self):
        """The kernels' plain versions against a per-row reference: row
        r of ``ag_group_gemm`` is token sti[r] // k of x times its
        block's expert (zeros at the sentinel), and ``moe_reduce_rs`` is
        the grouped GEMM of its rows; ``pick_gg_blocks`` refuses a
        capacity that is not a whole number of blocks."""
        x, logits, w_up, w_down = _moe_data(5)
        _, (_, tids) = _routing(logits)
        sti, be, _ = mu.moe_align_block_size(tids, E, 64)
        xt, wu = _t(x), _t(w_up)
        got = mtf.ag_group_gemm(xt, sti, be, wu, K)
        for r in range(0, sti.shape[0], 7):
            s, e = int(sti[r]), int(be[r // 64])
            want = (torch.zeros(F) if s >= M * K else xt[s // K] @ wu[e])
            torch.testing.assert_close(got[r], want, rtol=1e-5, atol=1e-5)
        y = torch.relu(got)
        red = mtf.moe_reduce_rs(y, be, _t(w_down))
        for r in range(0, sti.shape[0], 11):
            torch.testing.assert_close(
                red[r], y[r] @ _t(w_down)[int(be[r // 64])], rtol=1e-5,
                atol=1e-5)
        assert mtf.pick_gg_blocks(128, 1024) == 128
        assert mtf.pick_gg_blocks(128, 1000) is None
        with pytest.raises(ValueError, match="operands both"):
            mtf.ag_group_gemm(xt.double(), sti, be, wu, K)

    def test_fused_ops_refuse_a_partial_block(self):
        """The routing pads the capacity to whole ``block_m`` blocks;
        tables whose capacity is not a whole number of blocks are
        refused before a launch."""
        tctx = ops.create_ag_group_gemm_context(num_experts=E, topk=K,
                                                block_m=96)
        assert ops.create_moe_rs_context is ops.create_ag_group_gemm_context
        routing = ops.align_routing_sharded(
            tctx, torch.zeros((M, K), dtype=torch.int32))
        assert routing.cap_s % 96 == 0
        bad = ops.ShardedRouting(sti=routing.sti[:100], be=routing.be,
                                 splits=routing.splits)
        with pytest.raises(ValueError, match="block_m=96"):
            ops.ag_group_gemm_fused(torch.zeros((M, H)), bad,
                                    torch.zeros((E, H, F)), tctx)


# ------------------------------------------------------------- EP prefill

def _ep_contexts(mesh):
    """JAX's off-TPU prefill context (the ``xla`` transport at block_m
    128) and the port's prefill context: the fused transport, no wire
    quantization, no W8A8, block_m 128."""
    jctx = jops.create_ep_moe_context(
        mesh, "tp", num_experts=E, topk=K, max_m=M * K, hidden=H,
        dtype=jnp.float32, transport="xla", use_pallas_gemm=False,
        block_m=128)
    tctx = ops.create_ep_moe_context(
        num_experts=E, topk=K, max_m=M * K, hidden=H, dtype=torch.float32,
        block_m=128)
    return jctx, tctx


def _ep_weights(w_up, w_down, kind):
    """(JAX, port) weight pairs: f32 tensors, or the JAX quantizer's
    int8 dicts, which JAX's ``xla`` transport widens itself and the port
    gets widened, as ``Transformer._expert_w`` widens them for prefill."""
    if kind == "float":
        return ((jnp.asarray(w_up), jnp.asarray(w_down)),
                (_t(w_up), _t(w_down)))
    jw, tw = [], []
    for w in (w_up, w_down):
        q, s = j_quantize_grouped_weights(jnp.asarray(w), "int8")
        jw.append({"q": q, "scale": s})
        tw.append(dequantize_grouped_weights(_t(q), _t(s), torch.float32))
    return tuple(jw), tuple(tw)


class TestEPPrefill:
    @pytest.mark.parametrize("kind", ["float", "int8"])
    def test_ep_moe_matches_jax(self, mesh1, kind):
        """One rank, where either transport's exchange is the identity:
        the float expert MLP over the same sorted rows (JAX's
        ragged_dot, the port's float grouped GEMM) and the top-k sum;
        f32, 1e-5."""
        x, logits, w_up, w_down = _moe_data(6)
        jctx, tctx = _ep_contexts(mesh1)
        (ju, jd), (tu, td) = _ep_weights(w_up, w_down, kind)
        want = jops.ep_moe(jnp.asarray(x), jnp.asarray(logits), ju, jd, jctx)
        got = ops.ep_moe(_t(x), _t(logits), tu, td, tctx)
        _close(got, want, "float32")

    @pytest.mark.parametrize("kind", ["float", "int8"])
    def test_ep_moe_mlp_layer_matches_jax(self, mesh1, kind):
        """``EPMoEMLP``: the f32 router, then ``ep_moe``."""
        x, _, w_up, w_down = _moe_data(7)
        router = np.random.default_rng(8).standard_normal(
            (H, E)).astype(np.float32) / np.sqrt(H)
        jctx, tctx = _ep_contexts(mesh1)
        (ju, jd), (tu, td) = _ep_weights(w_up, w_down, kind)
        want = JEPMoEMLP(jctx)(
            {"router": jnp.asarray(router), "up": ju, "down": jd},
            jnp.asarray(x))
        got = EPMoEMLP(tctx)({"router": _t(router), "up": tu, "down": td},
                             _t(x))
        _close(got, want, "float32")


# ------------------------------------------------------ prefill → generate

#: the tiny DeepSeek-MoE preset: EP as served (int8 preset) and TP
FLAVOURS = {
    "ep": dict(),
    "tp": dict(moe="tp", moe_weight_quant=None, moe_act_quant=None),
}


def _models(mesh, flavour, seed=0):
    jcfg = jpresets.tiny(jpresets.deepseek_moe_16b(**FLAVOURS[flavour]))
    cfg = presets.tiny(presets.deepseek_moe_16b(**FLAVOURS[flavour]))
    jm = JTransformer(jcfg, mesh, "tp", ())
    params = jm.init(jax.random.PRNGKey(seed))
    params = jm.quantize_moe_weights(jm.quantize_dense_weights(params))
    tm = Transformer(cfg, device="cpu")
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), cfg, "cpu")
    return jm, params, tm, tparams


class TestGenerate:
    @pytest.mark.parametrize("paged", [False, True])
    @pytest.mark.parametrize("flavour", sorted(FLAVOURS))
    def test_token_streams_equal_jax(self, mesh1, tpu_moe, flavour, paged):
        """Ragged prompts of 16 and 9 tokens prefill (EP in full
        precision, TP through the overlapped engines), then 6 greedy
        steps (EP on the fused transport with the persistent workspaces
        threaded through, TP on the per-token loop), contiguous or paged:
        prefill's logits agree to 1e-4 and the token streams are
        equal."""
        jm, params, tm, tparams = _models(mesh1, flavour)
        b, s, cap, page, steps = 2, 16, 32, 8, 6
        toks = np.random.default_rng(9).integers(0, 128, (b, s)).astype(
            np.int32)
        lens = np.array([s, 9], np.int32)
        jlast, jc, jl = jm.prefill(params, jm.init_cache(b, cap),
                                   jnp.asarray(toks), jnp.asarray(lens))
        tlast, tc, tl = tm.prefill(tparams, tm.init_cache(b, cap), _t(toks),
                                   _t(lens))
        np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast),
                                   rtol=1e-4, atol=1e-4)
        first = jnp.argmax(jlast, -1).astype(jnp.int32)
        table = ttable = None
        if paged:
            jc, table = jm.paginate_caches(jc, page=page)
            tc, ttable = tm.paginate_caches(tc, page=page)
        jst, tst = jm.init_decode_state(b), tm.init_decode_state(b)
        assert (jst is None) == (tst is None) == (flavour == "tp")
        jout = jm.generate(params, jc, jl, first, steps, moe_state=jst,
                           block_table=table)
        tout = tm.generate(tparams, tc, tl, _t(np.asarray(first)), steps,
                           moe_state=tst, block_table=ttable)
        assert len(tout) == len(jout) == (3 if flavour == "tp" else 4)
        np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
        np.testing.assert_array_equal(tout[2].numpy(), np.asarray(jout[2]))

    @pytest.mark.parametrize("moe", ["ep", "tp"])
    def test_prefill_matches_stepwise_decode(self, moe):
        """The JAX model's serving contract (tests/test_models.py) on the
        port: prefill + generate continues like feeding the prompt
        through decode_step token by token; logits within 2e-3 (dense
        causal softmax against the online one), then the stepwise
        tokens equal on every row not at a near-tie."""
        cfg = TransformerConfig(
            vocab=128, n_layers=2, hidden=128, ffn=256, n_heads=8,
            n_kv_heads=4, head_dim=16, dtype=torch.float32,
            param_dtype=torch.float32, moe=moe, moe_layers=(1,),
            num_experts=8, topk=2)
        tm = Transformer(cfg, device="cpu")
        params = tm.init(torch.Generator().manual_seed(0))
        b, smax, steps = 2, 32, 3
        prompt = _t(np.random.default_rng(3).integers(0, 128, (b, 16)),
                    torch.int32)
        last, caches, lens = tm.prefill(params, tm.init_cache(b, smax),
                                        prompt)
        caches_b = tm.init_cache(b, smax)
        lens_b = torch.zeros((b,), dtype=torch.int32)
        for t in range(prompt.shape[1]):
            logits, caches_b, lens_b = tm.decode_step(params, caches_b,
                                                      lens_b, prompt[:, t])
        torch.testing.assert_close(last, logits, rtol=2e-3, atol=2e-3)
        la, lb = last, logits
        cmp = np.ones((b,), bool)
        for _ in range(steps):
            top2 = torch.topk(la, 2).values.numpy()
            cmp &= (top2[:, 0] - top2[:, 1]) > 1e-2
            ta = torch.argmax(la, -1).to(torch.int32)
            tb = torch.argmax(lb, -1).to(torch.int32)
            assert cmp.any(), "degenerate test: all rows near-tied"
            np.testing.assert_array_equal(ta.numpy()[cmp], tb.numpy()[cmp])
            la, caches, lens = tm.decode_step(params, caches, lens, ta)
            lb, caches_b, lens_b = tm.decode_step(params, caches_b, lens_b,
                                                  tb)

    def test_decode_threads_the_moe_state(self):
        """With ``moe_state`` decode_step and generate return the next
        states as a 4th result (the parity flips once a step in every
        EP layer, the dense layer keeps None); without it, 3 results
        and the same tokens."""
        cfg = presets.tiny(presets.deepseek_moe_16b(), kv_quant=None)
        tm = Transformer(cfg, device="cpu")
        params = tm.quantize_moe_weights(tm.quantize_dense_weights(
            tm.init(torch.Generator().manual_seed(1))))
        toks = _t(np.random.default_rng(4).integers(0, 128, (2, 8)),
                  torch.int32)
        last, caches, lens = tm.prefill(params, tm.init_cache(2, 16), toks)
        first = torch.argmax(last, -1).to(torch.int32)
        st = tm.init_decode_state(2)
        assert st[0] is None and st[1] is not None
        res = tm.decode_step(params, caches, lens, first, moe_state=st)
        assert len(res) == 4 and int(res[3][1].parity[0]) == 1
        assert res[3][0] is None
        pools, table = tm.paginate_caches(caches, page=8)
        toks4, _, lens4, st4 = tm.generate(params, pools, lens, first, 3,
                                           moe_state=st, block_table=table)
        assert int(st4[1].parity[0]) == 1          # 3 flips from 0
        toks3, _, lens3 = tm.generate(params, caches, lens, first, 3)
        assert torch.equal(toks3, toks4) and torch.equal(lens3, lens4)

    def test_generate_cli_runs_a_moe_preset_on_cpu(self):
        res = tgen.main(["--device", "cpu", "--preset", "tiny:deepseek_moe_16b",
                         "--batch", "2", "--prompt-len", "8", "--steps", "3"])
        assert np.asarray(res["tokens"]).shape == (2, 3)
