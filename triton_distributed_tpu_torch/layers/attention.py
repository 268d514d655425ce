"""Decode and serving attention layers, and the KV-cache appends.

Port of ``triton_distributed_tpu/layers/attention.py`` at world size 1:
one GPU holds the whole sequence and every KV head, so there is no mesh.

* :class:`SpGQAFlashDecodeAttention` dispatches a contiguous cache or a
  page pool (plain tensors, or int8 ``{"q", "scale"}`` dicts) to the
  decode entries of :mod:`~triton_distributed_tpu_torch.kernels.
  flash_decode`. The JAX layer merges the ranks' (out, lse) partials;
  over one rank that merge is the identity.
* :func:`append_kv` / :func:`paged_append_kv` write one decode step's
  K/V in place. JAX drops a write past the capacity as an out-of-bounds
  scatter; an out-of-range index is a device-side assert on CUDA, so
  such a row is masked instead (it writes its last slot's old value
  back), without a host sync.
* :class:`RaggedPagedAttention` dispatches the serving step's pools to
  :func:`~triton_distributed_tpu_torch.kernels.ragged_paged_attention.
  ragged_paged_attention`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from triton_distributed_tpu_torch.kernels import flash_decode as fd
from triton_distributed_tpu_torch.kernels.ragged_paged_attention import (
    ragged_paged_attention,
)


def _one_rank_table(block_table):
    """The (R, B, pps) table of the JAX layer at R = 1 → (B, pps)."""
    if block_table.dim() != 3 or block_table.shape[0] != 1:
        raise NotImplementedError(
            f"block table of shape {tuple(block_table.shape)}: sequence-"
            "sharded pools (R > 1) come with the collectives (ROADMAP "
            "Queue 1 items 11-12); pass (1, B, pages_per_seq)")
    return block_table[0]


@dataclass(frozen=True)
class SpGQAFlashDecodeAttention:
    """Decode attention over a whole (unsharded) KV cache.

    ``scale`` defaults to 1/sqrt(head_dim); ``soft_cap`` > 0 enables
    logit soft-capping; ``block_k`` None is the kernels' auto block (it
    feeds the int8 entry's gate); ``kv_layout`` "bhsd" (B, Hkv, S, D) or
    "bshd" (B, S, Hkv, D) for float caches."""

    q_heads: int = 32
    kv_heads: int = 8
    head_dim: int = 128
    scale: float | None = None
    soft_cap: float = 0.0
    block_k: int | None = None
    kv_layout: str = "bhsd"

    def __call__(self, q, k_cache, v_cache, global_kv_lens,
                 block_table=None):
        """q: (B, Hq, D); caches as in :meth:`partials`. Returns
        (B, Hq, D) in q's dtype."""
        return self.partials(q, k_cache, v_cache, global_kv_lens,
                             block_table)[0]

    def partials(self, q, k_cache, v_cache, global_kv_lens,
                 block_table=None):
        """``(out, lse)`` over the cache, for callers that merge further
        partials with :func:`~triton_distributed_tpu_torch.kernels.
        flash_decode.combine_partials`. Contiguous: k/v_cache (B, Hkv, S,
        D) tensors or int8 dicts with (B, Hkv, S) scales. Paged
        (``block_table`` (1, B, pps)): (npages, Hkv, page, D) pools."""
        lens = global_kv_lens.to(torch.int32)
        kw = dict(scale=self.scale, soft_cap=self.soft_cap)
        if block_table is not None:
            table = _one_rank_table(block_table).to(torch.int32)
            if isinstance(k_cache, dict):
                return fd.paged_gqa_fwd_batch_decode_q8(
                    q, k_cache["q"], k_cache["scale"], v_cache["q"],
                    v_cache["scale"], lens, table, **kw)
            return fd.paged_gqa_fwd_batch_decode(q, k_cache, v_cache, lens,
                                                 table, **kw)
        if isinstance(k_cache, dict):
            return fd.gqa_fwd_batch_decode_q8(
                q, k_cache["q"], k_cache["scale"], v_cache["q"],
                v_cache["scale"], lens, block_k=self.block_k, **kw)
        return fd.gqa_fwd_batch_decode(q, k_cache, v_cache, lens,
                                       block_k=self.block_k,
                                       kv_layout=self.kv_layout, **kw)

    def token_partial(self, q, k_new, v_new):
        """The (out, lse) partial of ONE just-produced KV position in this
        layer's score convention: a weight-1 softmax over one position
        has out = v and lse = its (scaled, soft-capped) score. q: (B, Hq,
        D); k_new/v_new: (B, Hkv, D). Returns ((B, Hq, D) f32, (B, Hq)
        f32)."""
        b, hq, d = q.shape
        hkv = k_new.shape[1]
        g = hq // hkv
        scale = self.scale if self.scale is not None else 1.0 / d ** 0.5
        qg = q.reshape(b, hkv, g, d)
        s = torch.einsum("bhgd,bhd->bhg", qg.float(), k_new.float()) * scale
        if self.soft_cap > 0.0:
            s = self.soft_cap * torch.tanh(s / self.soft_cap)
        out = v_new[:, :, None].float().expand(b, hkv, g, d).reshape(b, hq, d)
        return out, s.reshape(b, hq)


def _put_rows(cache, idx, new, keep):
    """cache[idx] = new where ``keep`` (per leading row), else the old
    value (a masked, sync-free stand-in for a dropped scatter)."""
    shape = keep.shape + (1,) * (new.dim() - 1)
    old = cache[idx]
    cache[idx] = torch.where(keep.reshape(shape), new.to(cache.dtype), old)


def append_kv(k_cache, v_cache, kv_lens, k_new, v_new, kv_layout="bhsd",
              k_quant=None, v_quant=None):
    """Append one decode step's K/V at each row's current length, in
    place. k_cache/v_cache: (B, Hkv, S, D) (``"bhsd"``) or (B, S, Hkv, D)
    (``"bshd"``), or int8 ``{"q", "scale"}`` dicts (bhsd); k_new/v_new:
    (B, Hkv, D); kv_lens: (B,) lengths before the append. A row at
    capacity writes nothing, while its returned length still counts up
    (as in JAX: callers enforce the capacity, see ``generate``).
    ``k_quant``/``v_quant``: the (int8, scale) pairs the caller already
    attended, stored as they are. Returns (k_cache, v_cache,
    kv_lens + 1)."""
    b = k_new.shape[0]
    rows = torch.arange(b, device=kv_lens.device)
    if isinstance(k_cache, dict):
        if kv_layout != "bhsd":
            raise ValueError("int8 caches are bhsd")
        cap = k_cache["q"].shape[2]
    else:
        cap = k_cache.shape[2 if kv_layout == "bhsd" else 1]
    keep = kv_lens < cap
    li = torch.clamp(kv_lens.long(), 0, cap - 1)
    if isinstance(k_cache, dict):
        kq, ks = k_quant if k_quant is not None else fd.quantize_kv(k_new)
        vq, vs = v_quant if v_quant is not None else fd.quantize_kv(v_new)
        heads = torch.arange(kq.shape[1], device=kv_lens.device)
        idx = (rows[:, None], heads[None, :], li[:, None])
        for cache, val in ((k_cache["q"], kq), (k_cache["scale"], ks),
                           (v_cache["q"], vq), (v_cache["scale"], vs)):
            _put_rows(cache, idx, val, keep)
        return k_cache, v_cache, kv_lens + 1
    if kv_layout == "bshd":
        idx = (rows, li)
    else:
        heads = torch.arange(k_new.shape[1], device=kv_lens.device)
        idx = (rows[:, None], heads[None, :], li[:, None])
    _put_rows(k_cache, idx, k_new, keep)
    _put_rows(v_cache, idx, v_new, keep)
    return k_cache, v_cache, kv_lens + 1


def paged_append_kv(k_pool, v_pool, block_table, kv_lens, k_new, v_new,
                    k_quant=None, v_quant=None):
    """Append one decode step's K/V into page pools at each row's current
    length, in place — the paged twin of :func:`append_kv`. Pools
    (R·npages_local, Hkv, page, D) (or int8 dicts with (…, page) scale
    pools), block_table (R, B, pps) of local page ids, kv_lens (B,)
    global lengths before the append: position L lives on slice L //
    (pps·page), local page (L mod pps·page) // page, offset L mod page.
    Rows at capacity write nothing. Returns (k_pool, v_pool,
    kv_lens + 1)."""
    r, b, pps = block_table.shape
    pool0 = k_pool["q"] if isinstance(k_pool, dict) else k_pool
    npool, hkv, page = pool0.shape[:3]
    npages_local = npool // r
    s_loc = pps * page
    keep = kv_lens < r * s_loc
    # a row at capacity addresses its own last slot and writes its old
    # value back
    pos = torch.where(keep, kv_lens.long(),
                      torch.full_like(kv_lens, r * s_loc - 1).long())
    slice_idx = pos // s_loc
    local = pos % s_loc
    rows = torch.arange(b, device=kv_lens.device)
    local_id = block_table[torch.clamp(slice_idx, 0, r - 1), rows,
                           local // page].long()
    pool_idx = slice_idx * npages_local + local_id
    # negative ids index from the end, as in a JAX scatter
    pool_idx = torch.where(pool_idx < 0, pool_idx + npool, pool_idx)
    heads = torch.arange(hkv, device=kv_lens.device)
    idx = (pool_idx[:, None], heads[None, :], (local % page)[:, None])
    if isinstance(k_pool, dict):
        kq, ks = k_quant if k_quant is not None else fd.quantize_kv(k_new)
        vq, vs = v_quant if v_quant is not None else fd.quantize_kv(v_new)
        for cache, val in ((k_pool["q"], kq), (k_pool["scale"], ks),
                           (v_pool["q"], vq), (v_pool["scale"], vs)):
            _put_rows(cache, idx, val, keep)
        return k_pool, v_pool, kv_lens + 1
    _put_rows(k_pool, idx, k_new, keep)
    _put_rows(v_pool, idx, v_new, keep)
    return k_pool, v_pool, kv_lens + 1


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
