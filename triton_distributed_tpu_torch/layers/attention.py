"""Serving-layout ragged paged attention layer.

Port of ``RaggedPagedAttention`` from ``triton_distributed_tpu/layers/
attention.py``. On one GPU the layer holds every KV head, so there is no
mesh and no head sharding: it dispatches int8 ``{"q", "scale"}`` pools
or plain pool tensors to :func:`~triton_distributed_tpu_torch.kernels.
ragged_paged_attention.ragged_paged_attention`.
"""

from __future__ import annotations

from dataclasses import dataclass

from triton_distributed_tpu_torch.kernels.ragged_paged_attention import (
    ragged_paged_attention,
)


@dataclass(frozen=True)
class RaggedPagedAttention:
    group: int = 4                 # G = Hq // Hkv
    scale: float | None = None
    soft_cap: float = 0.0

    def __call__(self, qp, k_pool, v_pool, kv_lens, q_lens, q_starts,
                 block_table, *, topologies=None, block_q: int = 8,
                 with_lse: bool = False):
        """qp: (Hkv, T·G, D) packed rows; pools (npages, Hkv, page, D)
        tensors or int8 ``{"q", "scale"}`` dicts. Returns (Hkv, T·G, D),
        or ``(out, lse)`` under ``with_lse``."""
        kw = dict(group=self.group, scale=self.scale,
                  soft_cap=self.soft_cap, topologies=topologies,
                  block_q=block_q)
        if isinstance(k_pool, dict):
            out, lse = ragged_paged_attention(
                qp, k_pool["q"], v_pool["q"], kv_lens, q_lens, q_starts,
                block_table, k_scale=k_pool["scale"],
                v_scale=v_pool["scale"], **kw)
        else:
            out, lse = ragged_paged_attention(
                qp, k_pool, v_pool, kv_lens, q_lens, q_starts,
                block_table, **kw)
        return (out, lse) if with_lse else out
