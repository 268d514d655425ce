from triton_distributed_tpu_torch.models import presets
from triton_distributed_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
    caches_from_numpy,
    params_from_numpy,
)

__all__ = ["Transformer", "TransformerConfig", "caches_from_numpy",
           "params_from_numpy", "presets"]
