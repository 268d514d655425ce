"""Decode and serving attention layers, and the KV-cache appends.

Port of ``triton_distributed_tpu/layers/attention.py``.

* :class:`SpGQAFlashDecodeAttention` dispatches a contiguous cache or a
  page pool (plain tensors, or int8 ``{"q", "scale"}`` dicts) to the
  decode entries of :mod:`~triton_distributed_tpu_torch.kernels.
  flash_decode`. A cache held whole is one rank's: the JAX layer's merge
  of the ranks' (out, lse) partials is then the identity. A cache
  sequence-sharded over the layer's mesh (each leaf a list of per-rank
  slices) runs the sequence-parallel entries: local decode, all-gather
  of the partials, combine.
* :func:`append_kv` / :func:`paged_append_kv` write one decode step's
  K/V in place. JAX drops a write past the capacity as an out-of-bounds
  scatter; an out-of-range index is a device-side assert on CUDA, so
  such a row is masked instead (it writes its last slot's old value
  back), without a host sync. Into a sequence-sharded cache, position p
  lives on rank p // (S/W) at offset p % (S/W), and only that rank
  writes.
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
from triton_distributed_tpu_torch.lang.shmem import require_stacked
from triton_distributed_tpu_torch.runtime.topology import Mesh


def is_sharded(cache) -> bool:
    """Whether a cache leaf (or int8 dict) is a list of per-rank shards."""
    if isinstance(cache, dict):
        cache = cache["q"]
    return isinstance(cache, (list, tuple))


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
    """Decode attention over a KV cache held whole, or sequence-sharded
    over ``axis`` of ``mesh``.

    ``scale`` defaults to 1/sqrt(head_dim); ``soft_cap`` > 0 enables
    logit soft-capping; ``block_k`` None is the kernels' auto block (it
    feeds the int8 entry's gate); ``kv_layout`` "bhsd" (B, Hkv, S, D) or
    "bshd" (B, S, Hkv, D) for float caches."""

    mesh: Mesh | None = None
    axis: str = "tp"
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
        D) tensors or int8 dicts with (B, Hkv, S) scales, or the same
        with each leaf a list of W per-rank (…, S/W, …) slices over the
        layer's mesh. Paged (``block_table`` (1, B, pps)): (npages, Hkv,
        page, D) pools."""
        lens = global_kv_lens.to(torch.int32)
        kw = dict(scale=self.scale, soft_cap=self.soft_cap)
        if is_sharded(k_cache):
            return self._sharded(q, k_cache, v_cache, lens, block_table, kw)
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

    def _sharded(self, q, k_cache, v_cache, lens, block_table, kw):
        if self.mesh is None:
            raise ValueError("a sequence-sharded cache needs the layer's "
                             "mesh")
        if block_table is not None:
            raise NotImplementedError(
                "paged caches over a mesh (tp > 1) are ROADMAP Queue 1 "
                "item 12")
        if isinstance(k_cache, dict):
            return fd.sp_gqa_fwd_batch_decode_q8(
                q, k_cache["q"], k_cache["scale"], v_cache["q"],
                v_cache["scale"], lens, self.mesh, self.axis,
                block_k=self.block_k, with_lse=True, **kw)
        return fd.sp_gqa_fwd_batch_decode(
            q, k_cache, v_cache, lens, self.mesh, self.axis,
            block_k=self.block_k, kv_layout=self.kv_layout, with_lse=True,
            **kw)

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
    (``"bshd"``), or int8 ``{"q", "scale"}`` dicts (bhsd), each leaf
    whole or a list of W per-rank slices of the sequence (position p on
    rank p // (S/W) at offset p % (S/W)); k_new/v_new: (B, Hkv, D);
    kv_lens: (B,) lengths before the append. A row at
    capacity writes nothing, while its returned length still counts up
    (as in JAX: callers enforce the capacity, see ``generate``).
    ``k_quant``/``v_quant``: the (int8, scale) pairs the caller already
    attended, stored as they are. Returns (k_cache, v_cache,
    kv_lens + 1)."""
    b = k_new.shape[0]
    rows = torch.arange(b, device=kv_lens.device)
    if isinstance(k_cache, dict) and kv_layout != "bhsd":
        raise ValueError("int8 caches are bhsd")
    if is_sharded(k_cache):
        _append_sharded(k_cache, v_cache, kv_lens, k_new, v_new, kv_layout,
                        k_quant, v_quant)
        return k_cache, v_cache, kv_lens + 1
    if isinstance(k_cache, dict):
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


def _append_sharded(k_cache, v_cache, kv_lens, k_new, v_new, kv_layout,
                    k_quant, v_quant):
    """:func:`append_kv` into sequence-sharded caches: only the rank that
    owns position ``kv_lens[b]`` writes row b: every plane's shards are
    views of one allocation, so one masked write over the W·B rows of
    each plane."""
    if isinstance(k_cache, dict):
        kq, ks = k_quant if k_quant is not None else fd.quantize_kv(k_new)
        vq, vs = v_quant if v_quant is not None else fd.quantize_kv(v_new)
        planes = ((k_cache["q"], kq), (k_cache["scale"], ks),
                  (v_cache["q"], vq), (v_cache["scale"], vs))
    else:
        planes = ((k_cache, k_new), (v_cache, v_new))
    stacks = [require_stacked(shards, "append_kv") for shards, _ in planes]
    n = len(planes[0][0])
    s_loc = planes[0][0][0].shape[2 if kv_layout == "bhsd" else 1]
    b, hkv = k_new.shape[:2]
    dev = kv_lens.device
    pos = kv_lens.long()
    keep = pos < n * s_loc
    owner = torch.clamp(pos // s_loc, 0, n - 1)
    # a row at capacity addresses the last slot and writes its old value
    li = torch.where(keep, pos % s_loc, torch.full_like(pos, s_loc - 1))
    # row b of rank r is row r·B + b of the stacked (W·B, ...) plane
    rows = owner * b + torch.arange(b, device=dev)
    if kv_layout == "bshd":
        idx = (rows, li)
    else:
        heads = torch.arange(hkv, device=dev)
        idx = (rows[:, None], heads[None, :], li[:, None])
    for st, (_, new) in zip(stacks, planes):
        _put_rows(st.reshape(n * b, *st.shape[2:]), idx, new, keep)


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
