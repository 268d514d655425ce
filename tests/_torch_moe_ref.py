"""Shared by the MoE parity tests of the PyTorch port: the JAX model's
EP MoE context pinned to the one a TPU builds for serving.

Off a TPU the JAX ``Transformer._moe_ep_ctx`` always picks the XLA
transport, and ``init_decode_state`` returns None. The port decodes on
the fused transport, so its parity tests pin the JAX side to the TPU's
choice with the :func:`tpu_moe` fixture (import it into the test
module).
"""

import pytest

from triton_distributed_tpu.models import Transformer as JTransformer

#: the JAX model's own context factory, which the fixture replaces
_jax_moe_ep_ctx = JTransformer._moe_ep_ctx


def tpu_moe_ctx(self, m_local, inference=False, weights_quantized=None):
    """JAX ``Transformer._moe_ep_ctx`` as a TPU builds it for serving:
    the fused transport, the Pallas grouped GEMMs (interpret mode here)
    at the port's block_m, the wire quant, and W8A8 experts when the
    weights are int8 dicts. Without ``inference`` (prefill) the JAX
    model's own factory, which off a TPU gives the full-precision XLA
    transport at block_m 128, as on a TPU without Pallas."""
    from triton_distributed_tpu import ops as jops
    from triton_distributed_tpu_torch.models.transformer import MOE_BLOCK_M

    if not inference:
        return _jax_moe_ep_ctx(self, m_local,
                               weights_quantized=weights_quantized)
    c = self.config
    wq = c.moe_weight_quant
    if weights_quantized is False:
        wq = None
    elif weights_quantized and wq is None:
        wq = "int8"
    return jops.create_ep_moe_context(
        self.mesh, self.tp_axis, num_experts=c.num_experts, topk=c.topk,
        max_m=m_local * c.topk, hidden=c.hidden, dtype=c.dtype,
        transport="fused", use_pallas_gemm=True, block_m=MOE_BLOCK_M,
        quant=c.moe_wire_quant,
        act_quant=c.moe_act_quant if wq == "int8" else None,
        batch_axes=tuple(self.dp_axes))


@pytest.fixture
def tpu_moe(monkeypatch):
    monkeypatch.setattr(JTransformer, "_moe_ep_ctx", tpu_moe_ctx)
