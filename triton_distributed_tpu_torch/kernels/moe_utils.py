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
    """[0, x0, x0+x1, ...] as int32 along the last dim: segment starts
    from segment sizes (each leading index on its own)."""
    c = torch.cumsum(x, dim=-1, dtype=torch.int32)
    return torch.cat([torch.zeros_like(c[..., :1]), c[..., :-1]], dim=-1)


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
    count per expert.

    A leading dim (S, M, k) aligns S shards, each on its own (JAX's
    ``vmap`` of this function), in one pass: every result gains the
    leading S."""
    if topk_ids.dim() == 2:
        return tuple(t[0] for t in moe_align_block_size(
            topk_ids[None], num_experts, block_m))
    s, m, k = topk_ids.shape
    dev = topk_ids.device
    total = m * k
    cap = aligned_capacity(total, num_experts, block_m)
    flat = topk_ids.reshape(s, total).to(torch.int64)

    # scatter_add_, not bincount: a CUDA bincount reads the max id back
    # to the host to size its output
    splits = torch.zeros((s, num_experts), dtype=torch.int32, device=dev)
    splits.scatter_add_(1, flat, torch.ones_like(flat, dtype=torch.int32))
    padded = round_up_to_block(splits, block_m)
    padded_offs = exclusive_cumsum(padded)
    offs = exclusive_cumsum(splits)

    order = torch.argsort(flat, dim=1, stable=True)            # (s, total)
    sorted_experts = flat.gather(1, order)
    rank_in_expert = (torch.arange(total, device=dev)
                      - offs.gather(1, sorted_experts))
    dest = padded_offs.gather(1, sorted_experts) + rank_in_expert
    # every dest is below cap by construction; anything else would land
    # in the dropped slot at cap (JAX drops out-of-bounds scatters)
    dest = torch.where((dest >= 0) & (dest < cap), dest, cap).long()
    sti = torch.full((s, cap + 1), total, dtype=torch.int32, device=dev)
    sti.scatter_(1, dest, order.to(torch.int32))
    sorted_token_ids = sti[:, :cap].contiguous()

    nblocks = cap // block_m
    block_start = torch.arange(nblocks, dtype=torch.int64,
                               device=dev) * block_m
    block_expert = torch.searchsorted(
        torch.cumsum(padded, dim=1, dtype=torch.int64),
        block_start.expand(s, nblocks).contiguous(), right=True)
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
    """Weighted sum of expert outputs back in token order: (..., cap, H)
    padded-sorted rows and (..., M, k) router weights → (..., M, H) f32
    (a leading dim: shards, each on its own).

    JAX scatter-adds the rows; here each (token, slot) assignment finds
    its sorted row through the inverse of ``sorted_token_ids`` (every
    assignment has exactly one, so the inverse is a plain scatter) and a
    token's k rows are summed in slot order. The result does not depend
    on the order threads run in (a CUDA ``index_add_`` adds with atomics,
    so its low bits would change from run to run)."""
    k = weights.shape[-1]
    total = m * k
    cap = sorted_token_ids.shape[-1]
    valid = sorted_token_ids < total
    pos = torch.arange(cap, device=y_sorted.device).expand_as(
        sorted_token_ids)
    # the sentinel's writes land in the dropped slot at ``total``
    slot = torch.where(valid, sorted_token_ids, total).long()
    inv = torch.zeros((*sorted_token_ids.shape[:-1], total + 1),
                      dtype=torch.int64, device=y_sorted.device)
    inv.scatter_(-1, slot, pos)
    inv = inv[..., :total]
    if y_sorted.dim() == 2:
        rows = y_sorted[inv]
    else:
        lead = torch.arange(y_sorted.shape[0], device=y_sorted.device)
        rows = y_sorted[lead[:, None], inv]
    w = weights.reshape(*weights.shape[:-2], total, 1).float()
    out = (rows.float() * w).reshape(*rows.shape[:-2], m, k, -1)
    return out.sum(dim=-2)
