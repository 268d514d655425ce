"""GQA flash-decode: one query token per batch row over a KV cache.

Port of ``triton_distributed_tpu/kernels/flash_decode.py``: the KV-cache
quantizer, the four local decode entries, the partials merges (the
sequence-parallel decode's, and the cp shards' of long-context serving),
and the sequence-parallel entries over a mesh
(:func:`sp_gqa_fwd_batch_decode`, :func:`sp_gqa_fwd_batch_decode_q8`).

* :func:`gqa_fwd_batch_decode` — a contiguous cache, (B, Hkv, S, D)
  (``"bhsd"``) or (B, S, Hkv, D) (``"bshd"``), f32 or bf16;
* :func:`gqa_fwd_batch_decode_q8` — an int8 bhsd cache with
  (B, Hkv, S) f32 per-position scales;
* :func:`paged_gqa_fwd_batch_decode` and
  :func:`paged_gqa_fwd_batch_decode_q8` — (npages, Hkv, page, D) page
  pools read through a (B, pages_per_seq) block table.

Each returns ``(out (B, Hq, D) in q's dtype, lse (B, Hq) f32)``: the
softmax over the row's first ``min(kv_lens[b], capacity)`` positions
and its natural-log sum-exp; an empty row gives zeros and ``NEG_INF``.

The int8 entries keep the JAX entries' gates (``:884-895``,
``:1135-1146``), which pick the numerics: with ``head_dim`` and the
block (or page) multiples of 128 the TPU runs its int8 kernels, which
cast q to bf16 and fold the scales into the softmax; otherwise the cache
is widened to q's dtype first and the float path runs. The port takes
the same branch on the CPU and on the card.

On a CUDA tensor the entries launch the kernels of
``csrc/flash_decode.cu`` (a strided walk for the contiguous caches, a
block-table walk for the pools); on a CPU tensor they run the plain
PyTorch versions (``*_plain``), with the kernels' arithmetic: the int8
scale folds, an online softmax over the same 64-position tiles, and p
rounded to V's type (bf16 for bf16 and int8 caches) before the PV
product. The TPU walks its own blocks (``block_k`` positions, or a
page), so where p is rounded to bf16 the port and the TPU kernels differ
by those roundings (about 1e-4 at the tests' shapes).
"""

from __future__ import annotations

import math

import torch

from triton_distributed_tpu_torch.config import div_scalar

NEG_INF = -1.0e30  # finite -inf stand-in: exp(NEG_INF - m) == 0, no NaNs

#: positions per step of the KV walk, in the CUDA kernels
#: (``csrc/flash_decode.cu`` TK) and in the plain versions alike
TILE = 64

_DT_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def quantize_kv(x):
    """Per-row int8 quantization of a (..., S, D) cache tensor: each
    length-D row gets one f32 scale (max-abs / 127). Returns (int8
    values, f32 scales of shape ``x.shape[:-1]``). Rounds half to even,
    as the JAX version does."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    s = torch.where(amax > 0.0, div_scalar(amax, 127.0),
                    torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / s[..., None]), -127.0, 127.0)
    return q.to(torch.int8), s


def _divisor_block(dim: int, target: int, mult: int) -> int | None:
    """Largest divisor of ``dim`` <= ``target``, preferring multiples of
    ``mult`` (the non-strict mode of ``ag_gemm._divisor_block``, which
    the JAX package runs off the TPU)."""
    best = None
    for b in range(min(target, dim), 0, -1):
        if dim % b == 0:
            if b % mult == 0:
                return b
            if best is None:
                best = b
    return best


def pick_block_k(s_len: int, requested: int, *, head_dim: int = 128,
                 itemsize: int = 2) -> int:
    """Largest divisor of ``s_len`` <= ``requested``, preferring
    multiples of 16 — the TPU's KV block, kept because the int8 entries'
    gate reads it. (The CUDA kernels walk fixed 64-position tiles.)"""
    del head_dim, itemsize          # they size the TPU's strict-mode check
    return _divisor_block(s_len, requested, 16) or s_len


def _auto_block_k(s_len: int) -> int:
    """The JAX entries' auto block: half the capacity in [1024, 4096]."""
    return min(max(s_len // 2, 1024), 4096)


def _pv_dtype(v):
    """The type the PV product takes p in: V's, or bf16 for int8 V
    (the TPU widens int8 V to bf16)."""
    return v.dtype if v.is_floating_point() else torch.bfloat16


def _attend_plain(q, k, v, kv_lens, k_scale, v_scale, scale, soft_cap,
                  out_dtype):
    """The decode arithmetic in f32: q (B, Hq, D), k/v (B, Hkv, S, D),
    optional (B, Hkv, S) scales folded per column. The online softmax
    walks the kernels' ``TILE``-position tiles, rounding each tile's p
    (against the running max) to the PV product's type as they do, so
    the two differ only by the f32 summation order."""
    b, hq, d = q.shape
    hkv, s_len = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, d).float()
    s = torch.einsum("bhgd,bhsd->bhgs", qg, k.float()) * scale
    if k_scale is not None:
        s = s * k_scale.float()[:, :, None, :]
    if soft_cap > 0.0:
        s = soft_cap * torch.tanh(s / soft_cap)
    lens = torch.clamp(kv_lens.to(torch.int64), 0, s_len)
    mask = (torch.arange(s_len, device=q.device)[None, None, None, :]
            < lens[:, None, None, None])
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    vf = v.float()
    pdt = _pv_dtype(v)
    m = torch.full((b, hkv, g, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, g, d), device=q.device)
    for t0 in range(0, s_len, TILE):
        tile = slice(t0, t0 + TILE)
        st = s[..., tile]
        m_new = torch.maximum(m, st.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(mask[..., tile], torch.exp(st - m_new),
                        torch.zeros_like(st))
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        if v_scale is not None:
            p = p * v_scale.float()[:, :, None, tile]
        p = p.to(pdt).float()
        acc = alpha * acc + torch.einsum("bhgs,bhsd->bhgd", p,
                                         vf[:, :, tile])
        m = m_new
    safe = torch.where(l > 0.0, l, torch.ones_like(l))
    lse = torch.where(l > 0.0, m + torch.log(safe),
                      torch.full_like(l, NEG_INF))
    return (acc / safe).reshape(b, hq, d).to(out_dtype), lse.reshape(b, hq)


def _geometry(q, k_cache, kv_layout):
    if kv_layout == "bshd":
        _, s_len, hkv, _ = k_cache.shape
    elif kv_layout == "bhsd":
        _, hkv, s_len, _ = k_cache.shape
    else:
        raise ValueError(f"kv_layout must be 'bshd' or 'bhsd', got "
                         f"{kv_layout!r}")
    batch, hq, d = q.shape
    if hq % hkv:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got {hq} % {hkv}")
    return batch, hq, d, hkv, s_len


def _contiguous(q, k, v, kv_lens, k_scale, v_scale, *, kv_layout, scale,
                soft_cap, out_dtype, tpu_kernel, plain):
    if plain or q.device.type == "cpu":
        if kv_layout == "bshd":
            k, v = k.transpose(1, 2), v.transpose(1, 2)
        return _attend_plain(q, k, v, kv_lens, k_scale, v_scale, scale,
                             soft_cap, out_dtype)
    return _flash_decode_cuda(q, k, v, kv_lens, k_scale, v_scale,
                              kv_layout=kv_layout, scale=scale,
                              soft_cap=soft_cap, out_dtype=out_dtype,
                              tpu_kernel=tpu_kernel)


def _gqa(q, k_cache, v_cache, kv_lens, *, scale, soft_cap, block_k,
         kv_layout, plain):
    _, _, d, _, s_len = _geometry(q, k_cache, kv_layout)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if block_k is None:
        block_k = _auto_block_k(s_len)
    block_k = pick_block_k(s_len, block_k, head_dim=d,
                           itemsize=k_cache.element_size())
    # the JAX entry's gate (:693): which TPU kernel this call stands for
    tpu = ("_decode_kernel_dyn"
           if kv_layout == "bhsd" and d % 128 == 0 and block_k % 8 == 0
           else "_decode_kernel")
    return _contiguous(q, k_cache, v_cache, kv_lens, None, None,
                       kv_layout=kv_layout, scale=scale, soft_cap=soft_cap,
                       out_dtype=q.dtype, tpu_kernel=tpu, plain=plain)


def gqa_fwd_batch_decode(q, k_cache, v_cache, kv_lens, *,
                         scale: float | None = None, soft_cap: float = 0.0,
                         block_k: int | None = 2048,
                         kv_layout: str = "bhsd"):
    """Local GQA decode over a contiguous f32/bf16 cache → (out, lse).

    q: (B, Hq, D); k_cache/v_cache: (B, Hkv, S, D) (``"bhsd"``) or
    (B, S, Hkv, D) (``"bshd"``); kv_lens: (B,) valid lengths (clamped to
    [0, S]). ``scale`` defaults to 1/sqrt(D); ``soft_cap`` > 0 caps the
    scores at ``soft_cap · tanh(s / soft_cap)``. On a CPU tensor this is
    :func:`gqa_fwd_batch_decode_plain`; on a CUDA tensor it launches the
    kernel or raises."""
    return _gqa(q, k_cache, v_cache, kv_lens, scale=scale,
                soft_cap=soft_cap, block_k=block_k, kv_layout=kv_layout,
                plain=False)


def gqa_fwd_batch_decode_plain(q, k_cache, v_cache, kv_lens, *,
                               scale: float | None = None,
                               soft_cap: float = 0.0,
                               block_k: int | None = 2048,
                               kv_layout: str = "bhsd"):
    """Plain PyTorch version of :func:`gqa_fwd_batch_decode` (any
    device): the port of ``gqa_fwd_batch_decode_xla`` (``:1312``)."""
    return _gqa(q, k_cache, v_cache, kv_lens, scale=scale,
                soft_cap=soft_cap, block_k=block_k, kv_layout=kv_layout,
                plain=True)


def _widen(x, s, dtype):
    return (x.float() * s.float()[..., None]).to(dtype)


def _gqa_q8(q, k_q, k_scale, v_q, v_scale, kv_lens, *, scale, soft_cap,
            block_k, plain):
    batch, hq, d, hkv, s_len = _geometry(q, k_q, "bhsd")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if block_k is None:
        block_k = _auto_block_k(s_len)
    block_k = pick_block_k(s_len, block_k, head_dim=d, itemsize=1)
    if d % 128 != 0 or block_k % 128 != 0:
        # the JAX gate (:887-895): widen to q's dtype, take the float path
        return _gqa(q, _widen(k_q, k_scale, q.dtype),
                    _widen(v_q, v_scale, q.dtype), kv_lens, scale=scale,
                    soft_cap=soft_cap, block_k=block_k, kv_layout="bhsd",
                    plain=plain)
    # the TPU's int8 kernels take q in bf16 (:897)
    return _contiguous(q.to(torch.bfloat16), k_q, v_q, kv_lens, k_scale,
                       v_scale, kv_layout="bhsd", scale=scale,
                       soft_cap=soft_cap, out_dtype=q.dtype,
                       tpu_kernel="_decode_kernel_dyn_mh", plain=plain)


def gqa_fwd_batch_decode_q8(q, k_q, k_scale, v_q, v_scale, kv_lens, *,
                            scale: float | None = None,
                            soft_cap: float = 0.0,
                            block_k: int | None = None):
    """Local GQA decode over an int8 cache → (out, lse).

    k_q/v_q: (B, Hkv, S, D) int8; k_scale/v_scale: (B, Hkv, S) f32 (from
    :func:`quantize_kv`). ``block_k=None`` is the JAX auto block, which
    with ``head_dim`` decides between the two numerics (module
    docstring). On a CPU tensor this is
    :func:`gqa_fwd_batch_decode_q8_plain`; on a CUDA tensor it launches
    the kernel or raises."""
    return _gqa_q8(q, k_q, k_scale, v_q, v_scale, kv_lens, scale=scale,
                   soft_cap=soft_cap, block_k=block_k, plain=False)


def gqa_fwd_batch_decode_q8_plain(q, k_q, k_scale, v_q, v_scale, kv_lens,
                                  *, scale: float | None = None,
                                  soft_cap: float = 0.0,
                                  block_k: int | None = None):
    """Plain PyTorch version of :func:`gqa_fwd_batch_decode_q8` (any
    device): the port of ``gqa_fwd_batch_decode_q8_xla`` (``:993``)
    behind the same gate."""
    return _gqa_q8(q, k_q, k_scale, v_q, v_scale, kv_lens, scale=scale,
                   soft_cap=soft_cap, block_k=block_k, plain=True)


def _gather_pages(pool, block_table):
    """(npages, Hkv, page[, D]) pool → the rows' contiguous (B, Hkv,
    pps·page[, D]) caches (table entries clamped into the pool)."""
    npages, hkv, page = pool.shape[:3]
    safe = torch.clamp(block_table.long(), 0, npages - 1)
    g = pool[safe]                        # (B, pps, Hkv, page[, D])
    g = g.transpose(1, 2)                 # (B, Hkv, pps, page[, D])
    return g.reshape(block_table.shape[0], hkv, -1, *pool.shape[3:])


def _paged(q, k_pool, v_pool, kv_lens, block_table, k_scale, v_scale, *,
           scale, soft_cap, out_dtype, tpu_kernel, plain):
    if plain or q.device.type == "cpu":
        ks = None if k_scale is None else _gather_pages(k_scale, block_table)
        vs = None if v_scale is None else _gather_pages(v_scale, block_table)
        return _attend_plain(q, _gather_pages(k_pool, block_table),
                             _gather_pages(v_pool, block_table), kv_lens,
                             ks, vs, scale, soft_cap, out_dtype)
    return _paged_decode_cuda(q, k_pool, v_pool, kv_lens, block_table,
                              k_scale, v_scale, scale=scale,
                              soft_cap=soft_cap, out_dtype=out_dtype,
                              tpu_kernel=tpu_kernel)


def _pool_geometry(q, k_pool, v_pool):
    if tuple(v_pool.shape) != tuple(k_pool.shape):
        raise ValueError(f"pool shapes differ: {tuple(k_pool.shape)} vs "
                         f"{tuple(v_pool.shape)}")
    batch, hq, d = q.shape
    hkv, page = k_pool.shape[1], k_pool.shape[2]
    if hq % hkv:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got {hq} % {hkv}")
    return d, page


def _paged_float(q, k_pool, v_pool, kv_lens, block_table, *, scale,
                 soft_cap, plain):
    d, _ = _pool_geometry(q, k_pool, v_pool)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    return _paged(q, k_pool, v_pool, kv_lens, block_table, None, None,
                  scale=scale, soft_cap=soft_cap, out_dtype=q.dtype,
                  tpu_kernel="_paged_decode_kernel", plain=plain)


def paged_gqa_fwd_batch_decode(q, k_pool, v_pool, kv_lens, block_table, *,
                               scale: float | None = None,
                               soft_cap: float = 0.0):
    """Paged GQA decode → (out, lse). k_pool/v_pool: (npages, Hkv, page,
    D) f32/bf16; block_table: (B, pps) int32 page ids (entries past a
    row's length may be anything: they are clamped into the pool and
    their positions masked); kv_lens: (B,) clamped to [0, pps·page]. On
    a CPU tensor this is :func:`paged_gqa_fwd_batch_decode_plain`; on a
    CUDA tensor it launches the kernel or raises."""
    return _paged_float(q, k_pool, v_pool, kv_lens, block_table,
                        scale=scale, soft_cap=soft_cap, plain=False)


def paged_gqa_fwd_batch_decode_plain(q, k_pool, v_pool, kv_lens,
                                     block_table, *,
                                     scale: float | None = None,
                                     soft_cap: float = 0.0):
    """Plain PyTorch version of :func:`paged_gqa_fwd_batch_decode` (any
    device): gather the pages, then the contiguous plain version (the
    port of ``paged_gqa_fwd_batch_decode_xla``, ``:1227``)."""
    return _paged_float(q, k_pool, v_pool, kv_lens, block_table,
                        scale=scale, soft_cap=soft_cap, plain=True)


def _paged_q8(q, k_pool, k_scale, v_pool, v_scale, kv_lens, block_table, *,
              scale, soft_cap, plain):
    d, page = _pool_geometry(q, k_pool, v_pool)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if d % 128 != 0 or page % 128 != 0:
        # the JAX gate (:1135-1146): widen the pools, take the float path
        return _paged_float(q, _widen(k_pool, k_scale, q.dtype),
                            _widen(v_pool, v_scale, q.dtype), kv_lens,
                            block_table, scale=scale, soft_cap=soft_cap,
                            plain=plain)
    return _paged(q.to(torch.bfloat16), k_pool, v_pool, kv_lens, block_table,
                  k_scale, v_scale, scale=scale, soft_cap=soft_cap,
                  out_dtype=q.dtype, tpu_kernel="_paged_kernel_dyn_mh",
                  plain=plain)


def paged_gqa_fwd_batch_decode_q8(q, k_pool, k_scale, v_pool, v_scale,
                                  kv_lens, block_table, *,
                                  scale: float | None = None,
                                  soft_cap: float = 0.0):
    """Paged GQA decode over int8 pools with (npages, Hkv, page) f32
    scales → (out, lse); the gate as in the module docstring. On a CPU
    tensor this is :func:`paged_gqa_fwd_batch_decode_q8_plain`; on a
    CUDA tensor it launches the kernel or raises."""
    return _paged_q8(q, k_pool, k_scale, v_pool, v_scale, kv_lens,
                     block_table, scale=scale, soft_cap=soft_cap, plain=False)


def paged_gqa_fwd_batch_decode_q8_plain(q, k_pool, k_scale, v_pool,
                                        v_scale, kv_lens, block_table, *,
                                        scale: float | None = None,
                                        soft_cap: float = 0.0):
    """Plain PyTorch version of :func:`paged_gqa_fwd_batch_decode_q8`
    (any device): the port of ``paged_gqa_fwd_batch_decode_q8_xla``
    (``:1214``) behind the same gate."""
    return _paged_q8(q, k_pool, k_scale, v_pool, v_scale, kv_lens,
                     block_table, scale=scale, soft_cap=soft_cap, plain=True)


def combine_partials(outs, lses, out_dtype=None):
    """Merge (out, lse) partials along axis 0: outs (R, B, Hq, D), lses
    (R, B, Hq). Each partial weighs exp(lse_r − max lse); a partial with
    lse == NEG_INF beside a finite one weighs exactly 0. Returns (merged
    in ``out_dtype`` (default outs' dtype), lse)."""
    out_dtype = out_dtype or outs.dtype
    lses = lses.float()
    m = lses.amax(dim=0, keepdim=True)
    w = torch.exp(lses - m)
    denom = torch.clamp(w.sum(dim=0), min=1e-30)
    merged = torch.einsum("rbh,rbhd->bhd", w, outs.float()) / denom[..., None]
    return merged.to(out_dtype), m[0] + torch.log(denom)


def combine_gqa_partials(outs, lses, out_dtype=None):
    """Merge cp-shard partials in the ragged kernel's layout (JAX
    ``:1367-1395``): outs (R, Hkv, TG, D), lses (R, Hkv, TG), as the
    ragged paged attention returns them, stacked along the cp shards.
    The softmax merge of :func:`combine_partials` with JAX's guard: a
    partial whose lse is NEG_INF weighs exactly 0, so a row every shard
    masked (padding, an empty shard) stays 0 with lse NEG_INF, and a row
    held wholly by one shard merges to that shard's out bit for bit.
    Returns (merged in ``out_dtype`` (default outs' dtype), lse).

    The long-context serving step's merge: on CUDA tensors the kernel of
    :func:`~triton_distributed_tpu_torch.kernels.cp_ring.cp_lse_combine`,
    on CPU tensors its plain version (the sums in shard order)."""
    from triton_distributed_tpu_torch.kernels.cp_ring import cp_lse_combine

    return cp_lse_combine(outs, lses, out_dtype=out_dtype)


# ------------------------------------------------------ sequence parallel

def _sp_decode(local, q, planes, global_kv_lens, mesh, axis, s_dim,
               with_lse):
    """Sequence-parallel decode (≡ ``sp_gqa_fwd_batch_decode_device``,
    ``:1485``): each rank's local decode over its slice of the sequence
    (``_local_shard_decode``, ``:1420``), an all-gather of the per-rank
    ``(out, lse)`` (``_merge_shard_partials_lse``, ``:1446``, on
    ``tdt_all_gather`` where JAX runs XLA's ``all_gather``), then
    :func:`combine_partials`. ``planes``: the cache's per-rank shard lists
    in ``local``'s order; ``s_dim`` their sequence dim.

    Every plane's shards are views of one allocation (the caches of
    ``Transformer.init_cache`` on a mesh), so the strided walk takes the
    W ranks as one batch of W·B rows: one launch for every rank. The
    merged result is replicated: one shared tensor on the loopback mesh,
    combined from rank 0's gathered copy (every rank's copy holds the
    same bytes)."""
    from triton_distributed_tpu_torch.kernels.allgather import all_gather
    from triton_distributed_tpu_torch.lang.shmem import require_stacked
    from triton_distributed_tpu_torch.runtime.topology import one_axis

    n = one_axis(mesh, axis)
    if any(not isinstance(p, (list, tuple)) or len(p) != n for p in planes):
        raise ValueError(f"sequence-parallel decode takes caches as lists of "
                         f"{n} per-rank shards")
    stacks = [require_stacked(p, "sequence-parallel decode") for p in planes]
    b, hq, d = q.shape
    s_loc = planes[0][0].shape[s_dim]
    starts = torch.arange(n, device=q.device)[:, None] * s_loc
    lens = torch.clamp(global_kv_lens.to(torch.int64)[None, :] - starts, 0,
                       s_loc).to(torch.int32)                  # (W, B)
    out, lse = local(q.repeat(n, 1, 1),
                     *(st.reshape(n * b, *st.shape[2:]) for st in stacks),
                     lens.reshape(-1))
    outs = list(out.view(n, b, hq, d).unbind(0))
    lses = list(lse.view(n, b, hq).unbind(0))
    g_out = all_gather(outs, mesh, axis)[0]
    g_lse = all_gather(lses, mesh, axis)[0]
    merged, mlse = combine_partials(g_out.view(n, b, hq, d),
                                    g_lse.view(n, b, hq),
                                    out_dtype=outs[0].dtype)
    return (merged, mlse) if with_lse else merged


def sp_gqa_fwd_batch_decode(q, k_cache, v_cache, global_kv_lens, mesh,
                            axis: str = "tp", *, scale: float | None = None,
                            soft_cap: float = 0.0,
                            block_k: int | None = 2048,
                            kv_layout: str = "bhsd", with_lse: bool = False):
    """Sequence-parallel GQA decode over a mesh (``:1535``).

    k_cache/v_cache: lists of W per-rank slices of the sequence, (B, Hkv,
    S/W, D) (``"bhsd"``) or (B, S/W, Hkv, D) (``"bshd"``); q (B, Hq, D)
    and global_kv_lens (B,) replicated. Rank r holds positions [r·S/W,
    (r+1)·S/W). Returns (B, Hq, D) in q's dtype, and the merged (B, Hq)
    lse with ``with_lse``."""
    def local(qq, k, v, lens):
        return gqa_fwd_batch_decode(qq, k, v, lens, scale=scale,
                                    soft_cap=soft_cap, block_k=block_k,
                                    kv_layout=kv_layout)

    return _sp_decode(local, q, (k_cache, v_cache), global_kv_lens, mesh,
                      axis, 2 if kv_layout == "bhsd" else 1, with_lse)


def sp_gqa_fwd_batch_decode_q8(q, k_q, k_scale, v_q, v_scale,
                               global_kv_lens, mesh, axis: str = "tp", *,
                               scale: float | None = None,
                               soft_cap: float = 0.0,
                               block_k: int | None = None,
                               with_lse: bool = False):
    """Sequence-parallel GQA decode over an int8 cache (``:1627``):
    k_q/v_q lists of W (B, Hkv, S/W, D) int8 slices, k_scale/v_scale
    lists of W (B, Hkv, S/W) f32; the rest as
    :func:`sp_gqa_fwd_batch_decode`."""
    def local(qq, kq, ks, vq, vs, lens):
        return gqa_fwd_batch_decode_q8(qq, kq, ks, vq, vs, lens, scale=scale,
                                       soft_cap=soft_cap, block_k=block_k)

    return _sp_decode(local, q, (k_q, k_scale, v_q, v_scale), global_kv_lens,
                      mesh, axis, 2, with_lse)


# ---------------------------------------------------------------- kernels

def _check_cuda(tensors, what):
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: tensor on {t.device}, expected {dev}")
    return dev


def _common_args(q, hkv, d, kv_dtype, out_dtype, what):
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: q must be f32 or bf16, got {q.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: out must be f32 or bf16, got {out_dtype}")
    if kv_dtype not in _DT_CODE:
        raise ValueError(f"{what}: the cache must be f32, bf16 or int8, got "
                         f"{kv_dtype}")
    elem = torch.empty((), dtype=kv_dtype).element_size()
    g = q.shape[1] // hkv
    if (d * elem) % 16 or d * elem > 512 or g * d > 2048:
        raise ValueError(f"{what}: head_dim {d} of {kv_dtype} needs rows of "
                         f"a multiple of 16 bytes, at most 512, and "
                         f"G·D <= 2048 (G = {g})")
    return g, elem


def _scales_ok(k_scale, v_scale, shape, what):
    for sc in (k_scale, v_scale):
        if sc is None or sc.dtype != torch.float32 or tuple(sc.shape) != shape:
            raise ValueError(f"{what}: int8 K/V need f32 scales of shape "
                             f"{shape}")


def _flash_decode_cuda(q, k, v, kv_lens, k_scale, v_scale, *, kv_layout,
                       scale, soft_cap, out_dtype, tpu_kernel):
    from triton_distributed_tpu_torch.kernels import _build

    what = "flash_decode"
    batch, hq, d = q.shape
    if kv_layout == "bhsd":
        _, hkv, s_len, _ = k.shape
        sb, sh, ss, sd = k.stride()
    else:
        _, s_len, hkv, _ = k.shape
        sb, ss, sh, sd = k.stride()
    g, elem = _common_args(q, hkv, d, k.dtype, out_dtype, what)
    quant = k.dtype == torch.int8
    tensors = [q, k, v, kv_lens]
    if quant:
        _scales_ok(k_scale, v_scale, (batch, hkv, s_len), what)
        k_scale, v_scale = k_scale.contiguous(), v_scale.contiguous()
        tensors += [k_scale, v_scale]
    dev = _check_cuda(tensors, what)
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on CPU or CUDA tensors, got {dev}")
    if v.dtype != k.dtype or v.shape != k.shape or v.stride() != k.stride():
        raise ValueError(f"{what}: K and V must match in dtype, shape and "
                         "strides")
    strides = (sb, sh, ss)
    if (sd != 1 or any((st * elem) % 16 for st in strides)
            or k.data_ptr() % 16 or v.data_ptr() % 16
            or max(strides) >= 2 ** 31):
        raise ValueError(f"{what}: K/V rows must be contiguous and 16-byte "
                         "aligned")
    if kv_lens.dtype != torch.int32 or tuple(kv_lens.shape) != (batch,):
        raise ValueError(f"{what}: kv_lens must be (B,) int32")
    q = q.contiguous()
    out = torch.empty((batch, hq, d), dtype=out_dtype, device=dev)
    lse = torch.empty((batch, hq), dtype=torch.float32, device=dev)
    fn = _build.function("tdt_flash_decode",
                         "p" * 8 + "i" * 11 + "ff" + "iii" + "p")
    rc = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v),
            _build.ptr(k_scale) if quant else None,
            _build.ptr(v_scale) if quant else None,
            _build.ptr(kv_lens.contiguous()), _build.ptr(out),
            _build.ptr(lse), batch, hkv, g, d, s_len, sb, sh, ss,
            hkv * s_len if quant else 0, s_len if quant else 0,
            1 if quant else 0, float(scale), float(soft_cap),
            _DT_CODE[q.dtype], _DT_CODE[k.dtype], _DT_CODE[out_dtype],
            _build.stream(dev))
    _build.check(rc, "tdt_flash_decode")
    _flash_decode_cuda.launches += 1
    by = _flash_decode_cuda.by_tpu_kernel
    by[tpu_kernel] = by.get(tpu_kernel, 0) + 1
    return out, lse


def _paged_decode_cuda(q, k_pool, v_pool, kv_lens, block_table, k_scale,
                       v_scale, *, scale, soft_cap, out_dtype, tpu_kernel):
    from triton_distributed_tpu_torch.kernels import _build

    what = "paged_decode"
    q = q.contiguous()
    batch, hq, d = q.shape
    npages, hkv, page, _ = k_pool.shape
    g, _ = _common_args(q, hkv, d, k_pool.dtype, out_dtype, what)
    quant = k_pool.dtype == torch.int8
    tensors = [q, k_pool, v_pool, kv_lens, block_table]
    if quant:
        _scales_ok(k_scale, v_scale, (npages, hkv, page), what)
        tensors += [k_scale, v_scale]
    dev = _check_cuda(tensors, what)
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on CPU or CUDA tensors, got {dev}")
    if v_pool.dtype != k_pool.dtype:
        raise ValueError(f"{what}: K and V pools differ in dtype")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{what}'s kernel needs contiguous tensors")
    for t in (kv_lens, block_table):
        if t.dtype != torch.int32:
            raise ValueError(f"{what}: kv_lens and the block table must be "
                             f"int32, got {t.dtype}")
    if block_table.dim() != 2 or block_table.shape[0] != batch:
        raise ValueError(f"{what}: block table must be (B, pps), got "
                         f"{tuple(block_table.shape)}")
    out = torch.empty((batch, hq, d), dtype=out_dtype, device=dev)
    lse = torch.empty((batch, hq), dtype=torch.float32, device=dev)
    fn = _build.function("tdt_paged_decode",
                         "p" * 9 + "i" * 7 + "ff" + "iii" + "p")
    rc = fn(_build.ptr(q), _build.ptr(k_pool), _build.ptr(v_pool),
            _build.ptr(k_scale) if quant else None,
            _build.ptr(v_scale) if quant else None,
            _build.ptr(kv_lens), _build.ptr(block_table), _build.ptr(out),
            _build.ptr(lse), batch, hkv, g, d, block_table.shape[1], npages,
            page, float(scale), float(soft_cap), _DT_CODE[q.dtype],
            _DT_CODE[k_pool.dtype], _DT_CODE[out_dtype], _build.stream(dev))
    _build.check(rc, "tdt_paged_decode")
    _paged_decode_cuda.launches += 1
    by = _paged_decode_cuda.by_tpu_kernel
    by[tpu_kernel] = by.get(tpu_kernel, 0) + 1
    return out, lse


#: launch counts of the two kernels (plain ints on the wrappers), and
#: their launches by the TPU kernel each call stands for
_flash_decode_cuda.launches = 0
_flash_decode_cuda.by_tpu_kernel = {}
_paged_decode_cuda.launches = 0
_paged_decode_cuda.by_tpu_kernel = {}
