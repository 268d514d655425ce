"""MoE routing utilities: expert selection, token sort, block alignment.

Port of ``triton_distributed_tpu/kernels/moe_utils.py``: plain tensor
code (a few sorts, cumsums and scatters over some thousand int32s), no
kernel. Sort (token, expert) pairs by expert and pad each expert's
segment to a GEMM block boundary, so a grouped GEMM walks whole blocks
with one expert id per block. Shapes depend only on the sizes, never on
the data: the padded capacity is the worst case, and unused positions
carry a sentinel row id.

Every function runs on the device of its inputs and never reads a value
back to the host.
"""

from __future__ import annotations

import torch


def round_up_to_block(x, block: int):
    """Round ``x`` (int or int tensor) up to a multiple of ``block``."""
    return ((x + block - 1) // block) * block


def exclusive_cumsum(x):
    """[0, x0, x0+x1, ...] as int32: segment starts from segment sizes."""
    c = torch.cumsum(x, dim=0, dtype=torch.int32)
    return torch.cat([torch.zeros((1,), dtype=torch.int32, device=x.device),
                      c[:-1]])


def select_experts(gate_logits, topk: int, *, renormalize: bool = True):
    """Softmax router → (weights (M, k) f32, expert ids (M, k) int32).

    Ties keep the lower expert first, as ``jax.lax.top_k`` does: a
    stable descending sort (``torch.topk`` promises no order on ties)."""
    probs = torch.softmax(gate_logits.float(), dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = vals[:, :topk], ids[:, :topk]
    if renormalize:
        weights = weights / weights.sum(dim=-1, keepdim=True)
    return weights, ids.to(torch.int32)


def aligned_capacity(total: int, num_experts: int, block_m: int) -> int:
    """Static worst-case padded length: every expert wastes < block_m."""
    return round_up_to_block(total + num_experts * (block_m - 1), block_m)


def moe_align_block_size(topk_ids, num_experts: int, block_m: int):
    """Sort (token, slot) pairs by expert and pad segments to block_m.

    topk_ids: (M, k) int32 in [0, num_experts). Returns
    ``sorted_token_ids`` (cap,) int32 — the flat source index
    ``row*k + slot`` per padded position, the sentinel ``M*k`` at
    padding; ``block_expert`` (cap // block_m,) int32 — the owning
    expert of each block; ``splits`` (num_experts,) int32 — the true
    count per expert."""
    m, k = topk_ids.shape
    dev = topk_ids.device
    total = m * k
    cap = aligned_capacity(total, num_experts, block_m)
    flat = topk_ids.reshape(-1).to(torch.int64)

    # index_add_, not bincount: a CUDA bincount reads the max id back to
    # the host to size its output
    splits = torch.zeros((num_experts,), dtype=torch.int32, device=dev)
    splits.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    padded = round_up_to_block(splits, block_m)
    padded_offs = exclusive_cumsum(padded)
    offs = exclusive_cumsum(splits)

    order = torch.argsort(flat, stable=True)                     # (total,)
    sorted_experts = flat[order]
    rank_in_expert = (torch.arange(total, device=dev)
                      - offs[sorted_experts])
    dest = padded_offs[sorted_experts] + rank_in_expert
    # every dest is below cap by construction; anything else would land
    # in the dropped slot at cap (JAX drops out-of-bounds scatters)
    dest = torch.where((dest >= 0) & (dest < cap), dest, cap).long()
    sti = torch.full((cap + 1,), total, dtype=torch.int32, device=dev)
    sti.scatter_(0, dest, order.to(torch.int32))
    sorted_token_ids = sti[:cap]

    nblocks = cap // block_m
    block_start = torch.arange(nblocks, dtype=torch.int64,
                               device=dev) * block_m
    block_expert = torch.searchsorted(
        torch.cumsum(padded, dim=0, dtype=torch.int64), block_start,
        right=True)
    block_expert = torch.clamp(block_expert, 0, num_experts - 1)
    return sorted_token_ids, block_expert.to(torch.int32), splits


def gather_sorted(x, sorted_token_ids, topk: int):
    """Rows of ``x`` (M, H) in padded-sorted order, zeros at padding
    (the row of flat id ``i`` is ``i // topk``)."""
    total = x.shape[0] * topk
    rows = torch.clamp(sorted_token_ids.long() // topk, 0, x.shape[0] - 1)
    valid = (sorted_token_ids < total)[:, None]
    return torch.where(valid, x[rows], torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def scatter_combine(y_sorted, sorted_token_ids, weights, m: int):
    """Weighted scatter-add of expert outputs back to token order:
    (cap, H) padded-sorted rows and (M, k) router weights → (M, H) f32."""
    k = weights.shape[1]
    total = m * k
    valid = sorted_token_ids < total
    safe = torch.where(valid, sorted_token_ids, 0).long()
    w = weights.reshape(-1)[safe] * valid                      # (cap,)
    rows = torch.where(valid, safe // k, m)                    # sentinel → m
    out = torch.zeros((m + 1, y_sorted.shape[1]), dtype=torch.float32,
                      device=y_sorted.device)
    out.index_add_(0, rows, y_sorted.float() * w[:, None])
    return out[:m]
