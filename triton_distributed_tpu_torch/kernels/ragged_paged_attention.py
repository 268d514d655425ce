"""Ragged paged attention: mixed prefill-chunk + decode rows, one launch.

Port of ``triton_distributed_tpu/kernels/ragged_paged_attention.py``.
The layout contract is the JAX one, kept at the public functions:

* ``q``/``out``: ``(Hkv, T·G, D)`` GQA rows (:func:`pack_gqa_rows`);
  row ``r``'s tokens occupy rows ``[q_starts[r]·G,
  (q_starts[r]+q_lens[r])·G)``.
* pools ``(npages, Hkv, page, D)``: int8 with ``(npages, Hkv, page)``
  f32 scales, or in q's dtype; ``block_table`` ``(R, pps)`` page ids
  (entries are clamped into ``[0, npages)``, -1 included).
* ``kv_lens`` include this step's tokens (append-then-attend); token
  ``t`` of row ``r`` sits at position ``kv_lens[r] - q_lens[r] + t``.
* optional per-row topology descriptors ``(R, 2+2W)``: CAUSAL, TREE
  (ancestor bitmask), SHARED_PREFIX (masks causally) and CP (frontier
  shifted right by ``aux``).
* returns ``(out (Hkv, T·G, D) in q's dtype, lse (Hkv, T·G) f32)``.

Unlike the TPU kernel, rows of ``out`` outside every row's span are not
garbage here: both versions leave them 0 with ``lse = NEG_INF``.

:func:`ragged_paged_attention` launches ``csrc/ragged_paged_attention.cu``
on a CUDA tensor and runs :func:`ragged_paged_attention_plain` on a CPU
tensor.
"""

from __future__ import annotations

import math

import numpy as np
import torch

NEG_INF = -1.0e30

TOPO_CAUSAL = 0
TOPO_TREE = 1
TOPO_SHARED_PREFIX = 2
TOPO_CP = 3
TOPO_MAX_NODES = 31


def topo_width(block_q: int) -> int:
    """Descriptor width for a ``block_q`` launch: one ancestor-bitmask
    slot per q position, capped at the int32 bitmask bound."""
    return min(int(block_q), TOPO_MAX_NODES)


def causal_topologies(r: int, width: int):
    """(R, 2+2W) all-CAUSAL descriptor block — the identity operand."""
    return np.zeros((r, 2 + 2 * width), np.int32)


def tree_topology_row(parents, width: int):
    """One TREE descriptor row from per-node parent indices
    (``parents[i]`` = parent draft node of node ``i``, -1 = the frontier
    token at q position 0; node ``i`` sits at q position ``i + 1``)."""
    n = len(parents)
    if n + 1 > width:
        raise ValueError(
            f"tree of {n} nodes needs width >= {n + 1}, got {width}")
    row = np.zeros((2 + 2 * width,), np.int32)
    row[0] = TOPO_TREE
    row[1] = n + 1
    anc = np.zeros((width,), np.int64)
    par = np.full((width,), -1, np.int64)
    anc[0] = 1
    for i, p in enumerate(parents):
        t = i + 1
        pt = int(p) + 1
        if not 0 <= pt < t:
            raise ValueError(
                f"node {i}: parent {p} must be an earlier node or -1")
        anc[t] = anc[pt] | (np.int64(1) << t)
        par[t] = pt
    row[2:2 + width] = anc.astype(np.int32)
    row[2 + width:2 + 2 * width] = par.astype(np.int32)
    return row


def shared_prefix_topology_row(split: int, width: int):
    """One SHARED_PREFIX descriptor row (``split`` in tokens)."""
    row = np.zeros((2 + 2 * width,), np.int32)
    row[0] = TOPO_SHARED_PREFIX
    row[1] = int(split)
    return row


def cp_topology_row(shift: int, width: int):
    """One CP descriptor row (``shift``: the frontier shift in tokens,
    0 on the shard that owns the frontier)."""
    if shift < 0:
        raise ValueError(f"cp frontier shift must be >= 0, got {shift}")
    row = np.zeros((2 + 2 * width,), np.int32)
    row[0] = TOPO_CP
    row[1] = int(shift)
    return row


def pack_gqa_rows(q, hkv):
    """(T, Hq, D) → (Hkv, T·G, D), contiguous."""
    t, hq, d = q.shape
    g = hq // hkv
    return q.reshape(t, hkv, g, d).permute(1, 0, 2, 3).reshape(
        hkv, t * g, d).contiguous()


def unpack_gqa_rows(o, hq):
    """(Hkv, T·G, D) → (T, Hq, D): inverse of :func:`pack_gqa_rows`."""
    hkv, tg, d = o.shape
    g = hq // hkv
    t = tg // g
    return o.reshape(hkv, t, g, d).permute(1, 0, 2, 3).reshape(t, hq, d)


def auto_block_q(max_q_len: int, g: int) -> int:
    """Smallest block from the {8, 16, 32, ...} ladder covering
    ``max_q_len`` with block·G a multiple of 8 — the JAX ladder, kept so
    the engine packs its batches exactly as the JAX engine does."""
    b = 8
    while b < max_q_len:
        b *= 2
    while (b * g) % 8:
        b *= 2
    return b


def _row_mask(kind, aux, anc_row, kv_len, q_len, g, s_len, device):
    """(q_len·G, S) visibility of one row's query rows over positions
    ``[0, S)`` — the JAX twin's per-kind mask."""
    base = kv_len - q_len
    t = torch.arange(q_len * g, device=device) // g
    pos = torch.arange(s_len, device=device)
    limit = base + t + 1
    ok = pos[None, :] < limit[:, None]
    if kind == TOPO_TREE:
        w = anc_row.shape[0]
        anc_t = anc_row[torch.clamp(t, 0, w - 1)].long()
        rel = pos[None, :] - base
        bit = (anc_t[:, None] >> torch.clamp(rel, 0, 31)) & 1
        ok = (pos[None, :] < kv_len) & ((rel < 0) | (bit > 0))
    elif kind == TOPO_CP:
        ok = (pos[None, :] < kv_len) & (pos[None, :] < (limit + aux)[:, None])
    return ok


def ragged_paged_attention_plain(
    q, k_pool, v_pool, kv_lens, q_lens, q_starts, block_table, *,
    group: int, topologies=None, k_scale=None, v_scale=None, scale=None,
    soft_cap=0.0, block_q=None,
):
    """Plain PyTorch version (the port of the JAX ``_xla`` twin), row
    by row: gather the row's pages into a contiguous cache, run the
    masked dense attention in f32. int8 pools are dequantized to q's
    dtype first, as the twin does. ``block_q`` is accepted for signature
    parity and unused."""
    del block_q
    hkv, tg, d = q.shape
    g = group
    npages, _, page, _ = k_pool.shape
    _, pps = block_table.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    out = torch.zeros_like(q)
    lse = torch.full((hkv, tg), NEG_INF, dtype=torch.float32,
                     device=q.device)
    kv_l, q_l, q_s = (x.tolist() for x in (kv_lens, q_lens, q_starts))
    topo = None if topologies is None else torch.as_tensor(
        topologies, device=q.device)
    for r, (kv_len, q_len, q_start) in enumerate(zip(kv_l, q_l, q_s)):
        if q_len <= 0:
            continue
        nb = min(max(-(-kv_len // page), 1), pps)
        pages = torch.clamp(block_table[r, :nb].long(), 0, npages - 1)
        kc, vc = k_pool[pages], v_pool[pages]        # (nb, Hkv, page, D)
        if k_scale is not None:
            kc = (kc.float() * k_scale[pages][..., None]).to(q.dtype)
            vc = (vc.float() * v_scale[pages][..., None]).to(q.dtype)
        kc = kc.permute(1, 0, 2, 3).reshape(hkv, nb * page, d).float()
        vc = vc.permute(1, 0, 2, 3).reshape(hkv, nb * page, d).float()
        span = slice(q_start * g, (q_start + q_len) * g)
        qr = q[:, span].float()                      # (Hkv, q·G, D)
        s = torch.einsum("hrd,hsd->hrs", qr, kc) * scale
        if soft_cap > 0.0:
            s = soft_cap * torch.tanh(s / soft_cap)
        kind = aux = 0
        anc = None
        if topo is not None:
            kind, aux = int(topo[r, 0]), int(topo[r, 1])
            w = (topo.shape[1] - 2) // 2
            anc = topo[r, 2:2 + w]
        ok = _row_mask(kind, aux, anc, kv_len, q_len, g, nb * page,
                       q.device)[None]
        s = torch.where(ok, s, torch.full_like(s, NEG_INF))
        m = s.amax(dim=-1, keepdim=True)
        p = torch.where(ok, torch.exp(s - m), torch.zeros_like(s))
        l = p.sum(dim=-1, keepdim=True)
        o = torch.einsum("hrs,hsd->hrd", p / torch.clamp(l, min=1e-30), vc)
        out[:, span] = o.to(q.dtype)
        lse[:, span] = torch.where(
            l[..., 0] > 0, m[..., 0] + torch.log(torch.clamp(l[..., 0],
                                                             min=1e-30)),
            torch.full_like(l[..., 0], NEG_INF))
    return out, lse


def ragged_paged_attention(
    q, k_pool, v_pool, kv_lens, q_lens, q_starts, block_table, *,
    group: int, topologies=None, k_scale=None, v_scale=None,
    scale: float | None = None, soft_cap: float = 0.0, block_q: int = 8,
):
    """Mixed prefill-chunk/decode attention over a shared page pool
    (layout in the module docstring). ``block_q`` sizes the kernel's
    grid, and the caller must keep ``max(q_lens) <= block_q``: the
    kernel computes only a row's first ``block_q`` tokens, while the
    plain version computes them all (the engine raises before a step
    that would break this). On a CPU tensor this is
    :func:`ragged_paged_attention_plain`; on a CUDA tensor it launches
    the kernel or raises."""
    if q.device.type == "cpu":
        return ragged_paged_attention_plain(
            q, k_pool, v_pool, kv_lens, q_lens, q_starts, block_table,
            group=group, topologies=topologies, k_scale=k_scale,
            v_scale=v_scale, scale=scale, soft_cap=soft_cap)
    return _ragged_cuda(
        q, k_pool, v_pool, kv_lens, q_lens, q_starts, block_table,
        group=group, topologies=topologies, k_scale=k_scale,
        v_scale=v_scale, scale=scale, soft_cap=soft_cap, block_q=block_q)


_Q_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _ragged_cuda(q, k_pool, v_pool, kv_lens, q_lens, q_starts, block_table,
                 *, group, topologies, k_scale, v_scale, scale, soft_cap,
                 block_q):
    from triton_distributed_tpu_torch.kernels import _build

    if q.device.type != "cuda":
        raise ValueError(f"ragged_paged_attention runs on CPU or CUDA "
                         f"tensors, got {q.device}")
    hkv, tg, d = q.shape
    g = int(group)
    npages, hkv_p, page, d_p = k_pool.shape
    r, pps = block_table.shape
    quant = k_scale is not None
    if tg % g or (hkv_p, d_p) != (hkv, d):
        raise ValueError(f"q {tuple(q.shape)} / pool {tuple(k_pool.shape)}"
                         f" mismatch at group={g}")
    if tuple(v_pool.shape) != tuple(k_pool.shape):
        raise ValueError("k_pool and v_pool shapes differ")
    if q.dtype not in _Q_CODE:
        raise ValueError(f"q must be f32 or bf16, got {q.dtype}")
    want_pool = torch.int8 if quant else q.dtype
    if k_pool.dtype != want_pool or v_pool.dtype != want_pool:
        raise ValueError(f"pools must be {want_pool}, got {k_pool.dtype}")
    if d > 256:
        raise ValueError(f"head_dim {d} > 256 is not supported")
    meta = [kv_lens, q_lens, q_starts, block_table]
    tensors = [q, k_pool, v_pool, *meta]
    if quant:
        if v_scale is None:
            raise ValueError("int8 pools need k_scale and v_scale")
        for sc in (k_scale, v_scale):
            if sc.dtype != torch.float32 or tuple(sc.shape) != (
                    npages, hkv, page):
                raise ValueError("scales must be f32 (npages, Hkv, page)")
        tensors += [k_scale, v_scale]
    topo_w = 0
    if topologies is not None:
        topologies = torch.as_tensor(topologies, dtype=torch.int32,
                                     device=q.device).contiguous()
        tr, tw = topologies.shape
        topo_w = (tw - 2) // 2
        if tr != r or tw != 2 + 2 * topo_w or not (
                1 <= topo_w <= TOPO_MAX_NODES):
            raise ValueError(f"topologies shape {(tr, tw)} must be (R={r},"
                             f" 2+2W) with 1 <= W <= {TOPO_MAX_NODES}")
        tensors.append(topologies)
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"tensor on {t.device}, expected {q.device}")
        if not t.is_contiguous():
            raise ValueError("ragged_paged_attention's kernel needs "
                             "contiguous tensors")
    for t in meta:
        if t.dtype != torch.int32:
            raise ValueError(f"metadata must be int32, got {t.dtype}")
    if kv_lens.shape[0] != r or q_lens.shape[0] != r or q_starts.shape[0] != r:
        raise ValueError("kv_lens/q_lens/q_starts must have R entries")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    out = torch.zeros_like(q)
    lse = torch.full((hkv, tg), NEG_INF, dtype=torch.float32,
                     device=q.device)
    bq = min(int(block_q), tg // g)
    null = None
    fn = _build.function("tdt_ragged_paged_attention",
                         "p" * 12 + "i" * 10 + "ff" + "ii" + "p")
    rc = fn(_build.ptr(q), _build.ptr(k_pool), _build.ptr(v_pool),
            _build.ptr(k_scale) if quant else null,
            _build.ptr(v_scale) if quant else null,
            _build.ptr(kv_lens), _build.ptr(q_lens), _build.ptr(q_starts),
            _build.ptr(block_table),
            _build.ptr(topologies) if topo_w else null,
            _build.ptr(out), _build.ptr(lse),
            r, pps, npages, hkv, g, d, page, tg, bq, topo_w,
            float(scale), float(soft_cap), _Q_CODE[q.dtype], int(quant),
            _build.stream(q.device))
    _build.check(rc, "tdt_ragged_paged_attention")
    _ragged_cuda.launches += 1
    return out, lse


#: launch count of the CUDA kernel (a plain int on the wrapper)
_ragged_cuda.launches = 0
