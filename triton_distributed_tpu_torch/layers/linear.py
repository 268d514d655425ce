"""Tensor-parallel linear layers over the overlap ops.

Port of ``triton_distributed_tpu/layers/linear.py``: callables over a
params dict in the JAX layout (``{"w": (in, out)}``; the MLP's
``{"up": {"w"}, "down": {"w"}}``), differentiable through the overlap
ops' autograd Functions (their backward runs the dual kernels, or the
gradient rings with ``OverlapContext(bwd_wire_dtype=...)``). At world
size 1 ``x`` and ``w`` are tensors; over a mesh they are lists of
per-rank shards:
``x`` row shards (m, in) for the column layer and the MLP, ``w`` the
column (``up``) or row (``down``) shards of the weight. A quantized
wire comes through the context (``OverlapContext(wire_dtype=...)``:
'fp8', 'int8' or 'int8-mxu', see :mod:`~triton_distributed_tpu_torch.
ops.overlap`), and so does the row layer's GEMM-RS engine
(``OverlapContext(method=...)``); the layers take no argument of their
own for either.
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


def _act(h, activation):
    if activation == "silu":
        return F.silu(h)
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(h, approximate="tanh")


@dataclass(frozen=True)
class ParallelMLP:
    """Column → activation → Row: one AG-GEMM and one GEMM-RS."""

    up: ColumnParallelLinear
    down: RowParallelLinear
    activation: str = "gelu"

    def __call__(self, params, x):
        h = self.up(params["up"], x)
        if isinstance(h, list):
            h = [_act(hr, self.activation) for hr in h]
        else:
            h = _act(h, self.activation)
        return self.down(params["down"], h)
