"""W8A8's K-major weights in the PyTorch port, against the JAX package.

W8A8's CUDA kernels read the weight K-major (the tensor cores take 8-bit
operands only so): the port stores the codes (E, N, K) and keeps their
(E, K, N) view, once, where a weight is quantized or loaded. These tests
hold that view to JAX's codes, scales and products bit for bit, and check
which weights the model keeps K-major (those W8A8 multiplies) and which
it leaves N-major (the W8A16 lm_head, and every weight of a model without
W8A8), through ``init``, the quantizers, ``params_from_numpy`` and
``shard_params``. (The f32 quantizer's K-major store, and W8A8 on a
K-major view against JAX's Pallas kernel, extend the JAX parity tests of
tests/test_torch_kernels.py.)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_distributed_tpu.kernels import group_gemm as jgg
from triton_distributed_tpu_torch.kernels import group_gemm as tgg
from triton_distributed_tpu_torch.models import Transformer, presets
from triton_distributed_tpu_torch.models.transformer import params_from_numpy
from triton_distributed_tpu_torch.ops.moe import whole_experts
from triton_distributed_tpu_torch.runtime import Mesh

DENSE = ("wqkv", "wo", "up", "down")
EXPERTS = ("moe_up", "moe_down")


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _is_k_major_view(q):
    return tgg.k_major(q) and not q.is_contiguous()


def _numpy_tree(node):
    if isinstance(node, dict):
        return {k: _numpy_tree(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_numpy_tree(v) for v in node]
    return node.contiguous().numpy()


@pytest.fixture(scope="module")
def served():
    """The tiny DeepSeek-MoE preset as served (W8A8 dense and experts,
    W8A16 lm_head), its weights quantized N-major as a JAX tree holds
    them."""
    cfg = presets.tiny(presets.deepseek_moe_16b())
    model = Transformer(cfg, device="cpu")
    p = model.init(torch.Generator().manual_seed(0))
    tree = model.quantize_dense_weights(model.quantize_moe_weights(p))
    return cfg, _numpy_tree(tree)     # N-major: contiguous (E, K, N) codes


def test_k_major_quantizer_view_equals_jax_on_bf16():
    """``k_major=True`` on a bf16 weight (how a served model's weights are
    drawn): (E, N, K) storage whose (E, K, N) view is JAX's codes, and
    JAX's scales, bit for bit (an all-zero channel too); the widened
    weight contiguous and equal. The f32 case, and W8A8 on the K-major
    view against JAX's Pallas kernel, are tests/test_torch_kernels.py's
    ``TestQuantizers`` / ``TestGroupedMatmul``."""
    rng = np.random.default_rng(1)
    w = rng.standard_normal((3, 64, 40)).astype(np.float32)
    w[1, :, 7] = 0.0
    jq, js = jgg.quantize_grouped_weights(jnp.asarray(w, jnp.bfloat16),
                                          "int8")
    tq, ts = tgg.quantize_grouped_weights(_t(w).to(torch.bfloat16), "int8",
                                          k_major=True)
    assert tq.shape == (3, 64, 40) and tq.stride() == (64 * 40, 1, 64)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    wd = tgg.dequantize_grouped_weights(tq, ts, torch.float32)
    assert wd.is_contiguous()
    np.testing.assert_array_equal(
        wd.numpy(), np.asarray(jgg.dequantize_grouped_weights(jq, js,
                                                              jnp.float32)))


def test_params_from_numpy_keeps_w8a8_weights_k_major(served):
    """A JAX tree's W8A8 codes (dense projections, experts) land as
    K-major views holding the same codes; the W8A16 lm_head stays
    N-major; the scales are untouched."""
    cfg, tree = served
    params = params_from_numpy(tree, cfg, "cpu")
    assert params["lm_head"]["q"].is_contiguous()
    for i, blk in enumerate(params["blocks"]):
        for name in DENSE + EXPERTS:
            if name not in blk:
                continue
            q = blk[name]["q"]
            assert _is_k_major_view(q), (i, name)
            np.testing.assert_array_equal(q.numpy(),
                                          tree["blocks"][i][name]["q"])
            assert blk[name]["scale"].is_contiguous()


def test_shard_params_keeps_every_shard_k_major(served):
    """Over a loopback mesh of 4: each rank's column or row shard of a
    W8A8 projection is a K-major view of one allocation, holding the
    rows or columns ``_shard_index`` names; the experts' shards stack
    (``whole_experts``) back to the whole K-major codes."""
    cfg, tree = served
    whole = params_from_numpy(tree, cfg, "cpu")
    mesh = Mesh.loopback(4, "cpu")
    model = Transformer(cfg, mesh=mesh)
    sharded = params_from_numpy(tree, cfg, mesh=mesh)
    for i, blk in enumerate(sharded["blocks"]):
        for name in DENSE:
            if name not in blk:
                continue
            dim, idx = model._shard_index(name)
            shards = blk[name]["q"]
            base = shards[0].untyped_storage().data_ptr()
            for r, q in enumerate(shards):
                assert _is_k_major_view(q), (i, name, r)
                assert q.untyped_storage().data_ptr() == base
                assert torch.equal(
                    q, whole["blocks"][i][name]["q"].index_select(dim,
                                                                  idx[r]))
        for name in EXPERTS:
            if name in blk:
                q = whole_experts(blk[name])["q"]
                assert _is_k_major_view(q)
                assert torch.equal(q, whole["blocks"][i][name]["q"])


@pytest.mark.parametrize("kw", [dict(dense_weight_quant="int8"),
                                dict(dense_weight_quant="int8",
                                     dense_act_quant="int8")])
def test_init_and_quantizers_store_only_w8a8_weights_k_major(kw):
    """``init(quantize=True)`` and ``quantize_dense_weights``: K-major
    codes exactly where W8A8 multiplies them (``dense_act_quant``), the
    lm_head N-major either way; the same codes in both layouts."""
    cfg = presets.tiny(**kw)
    model = Transformer(cfg, device="cpu")
    drawn = model.init(torch.Generator().manual_seed(2), quantize=True)
    plain = model.init(torch.Generator().manual_seed(3))
    quant = model.quantize_dense_weights(plain)
    w8a8 = cfg.dense_act_quant == "int8"
    for params in (drawn, quant):
        assert params["lm_head"]["q"].is_contiguous()
        for blk in params["blocks"]:
            for name in DENSE:
                assert _is_k_major_view(blk[name]["q"]) == w8a8, name
    for i, blk in enumerate(quant["blocks"]):
        for name in DENSE:
            q, s = tgg.quantize_grouped_weights(plain["blocks"][i][name][None])
            assert torch.equal(blk[name]["q"], q[0])
            assert torch.equal(blk[name]["scale"], s[0])
