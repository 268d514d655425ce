"""Tensor-parallel linear layers over the overlap ops.

Port of ``triton_distributed_tpu/layers/linear.py``: callables over a
params dict in the JAX layout (``{"w": (in, out)}``; the MLP's
``{"up": {"w"}, "down": {"w"}}``), forward only.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch.nn.functional as F

from triton_distributed_tpu_torch.ops.overlap import (
    OverlapContext,
    ag_gemm,
    gemm_rs,
)


@dataclass(frozen=True)
class ColumnParallelLinear:
    """y = AG(x) @ W."""

    ctx: OverlapContext

    def __call__(self, params, x):
        return ag_gemm(x, params["w"], self.ctx)


@dataclass(frozen=True)
class RowParallelLinear:
    """y = RS(x @ W)."""

    ctx: OverlapContext

    def __call__(self, params, x):
        return gemm_rs(x, params["w"], self.ctx)


@dataclass(frozen=True)
class ParallelMLP:
    """Column → activation → Row: one AG-GEMM and one GEMM-RS."""

    up: ColumnParallelLinear
    down: RowParallelLinear
    activation: str = "gelu"

    def __call__(self, params, x):
        h = self.up(params["up"], x)
        if self.activation == "silu":
            return self.down(params["down"], F.silu(h))
        # jax.nn.gelu's default is the tanh approximation
        return self.down(params["down"], F.gelu(h, approximate="tanh"))
