"""Model-family presets, with the fields of the JAX package's presets."""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.models.transformer import TransformerConfig


def llama_7b(**overrides) -> TransformerConfig:
    """Llama-2-7B geometry: hidden 4096, ffn 11008, 32 heads of 128."""
    cfg = dict(
        vocab=32000, n_layers=32, hidden=4096, ffn=11008,
        n_heads=32, n_kv_heads=32, head_dim=128,
        dtype=torch.bfloat16,
    )
    cfg.update(overrides)
    return TransformerConfig(**cfg)


def llama_70b(**overrides) -> TransformerConfig:
    """Llama-2-70B geometry (GQA with 8 KV heads)."""
    cfg = dict(
        vocab=32000, n_layers=80, hidden=8192, ffn=28672,
        n_heads=64, n_kv_heads=8, head_dim=128,
        dtype=torch.bfloat16,
    )
    cfg.update(overrides)
    return TransformerConfig(**cfg)


def mixtral_8x7b(**overrides) -> TransformerConfig:
    """Mixtral-style MoE: 8 experts, top 2, in every block."""
    cfg = dict(
        vocab=32000, n_layers=32, hidden=4096, ffn=14336,
        n_heads=32, n_kv_heads=8, head_dim=128,
        moe="ep", moe_layers=tuple(range(32)), num_experts=8, topk=2,
        dtype=torch.bfloat16,
    )
    cfg.update(overrides)
    return TransformerConfig(**cfg)


def deepseek_moe_16b(**overrides) -> TransformerConfig:
    """DeepSeek-MoE-16B-style geometry (64 small experts, top 6) with
    the int8 serving knobs: fp8 EP wire, int8 expert and dense weights,
    W8A8 activations, int8 KV."""
    cfg = dict(
        vocab=102400, n_layers=28, hidden=2048, ffn=1408,
        n_heads=16, n_kv_heads=16, head_dim=128,
        moe="ep", moe_layers=tuple(range(1, 28)), num_experts=64, topk=6,
        dtype=torch.bfloat16,
        moe_wire_quant="fp8",
        moe_weight_quant="int8",
        moe_act_quant="int8",
        kv_quant="int8",
        dense_weight_quant="int8",
        dense_act_quant="int8",
    )
    cfg.update(overrides)
    return TransformerConfig(**cfg)


def tiny(preset=None, **overrides) -> TransformerConfig:
    """Test-sized twin: the topology knobs of ``preset`` (or dense
    defaults) at tiny dims, in f32."""
    cfg = dict(
        vocab=128, n_layers=2, hidden=128, ffn=256,
        n_heads=8, n_kv_heads=4, head_dim=16,
        dtype=torch.float32, param_dtype=torch.float32,
    )
    if preset is not None:
        cfg.update(
            moe=preset.moe,
            moe_layers=tuple(i for i in preset.moe_layers if i < 2),
            num_experts=min(preset.num_experts, 8),
            topk=min(preset.topk, 2),
            attn=preset.attn,
            moe_wire_quant=preset.moe_wire_quant,
            moe_weight_quant=preset.moe_weight_quant,
            moe_act_quant=preset.moe_act_quant,
            kv_quant=preset.kv_quant,
            dense_weight_quant=preset.dense_weight_quant,
            dense_act_quant=preset.dense_act_quant,
        )
    cfg.update(overrides)
    return TransformerConfig(**cfg)
