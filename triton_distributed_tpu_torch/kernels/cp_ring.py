"""Context-parallel collectives: the KV ring and the Ulysses all-to-all
of the context-parallel prefill, and the cross-rank LSE-combine.

Port of the ``cp.ring_attention``, ``cp.ulysses`` and
``cp_decode.lse_combine`` families of
``triton_distributed_tpu/kernels/cp_ring.py`` and of their collective
ids.

**The prefill** (``TransformerConfig(attn="ring" | "ulysses")``; the user
entry points are :func:`~triton_distributed_tpu_torch.kernels.
ring_attention.ring_attention` and ``ulysses_attention``, which the
model's ``_cp_attention`` calls a layer). JAX's TPU kernel
``_kv_rotate_kernel`` (``:71``) forwards each rank's KV block around
the cp ring while the attention partial consumes every arrival; its
``_ulysses_a2a_kernel`` (``:127``) is the equal-split all-to-all under
Ulysses' sequence ↔ heads re-shard. JAX launches both only from its lint
builders; its prefill runs their XLA bodies (``ppermute`` and
``lax.all_to_all``, ``kernels/ring_attention.py:109-110,148-157``). The
port launches two CUDA kernels (``csrc/cp_ring.cu``) from those entry
points: ``tdt_ring_attention`` (:func:`ring_attention_launch`), the
rotation with its consume, one launch a layer for every rank (the ring
becomes a read of each source block in the stacked views; bf16 runs
both products on the tensor cores, with P split into two bf16 terms so
that the output keeps f32 accuracy, f32 runs on FMA); Ulysses' local
attention is the same kernel on a ring of one block; and
``tdt_ulysses_a2a`` (:func:`ulysses_a2a`), one pull launch a tensor and
direction for every rank. Their launches are counted by the TPU kernel
each stood for (``_kv_rotate_kernel``, ``_ulysses_a2a_kernel``).
:func:`kv_rotate_plain` and :func:`ulysses_a2a_plain` are the plain
moves (``ppermute``'s hop, the tiled all-to-all's layout).

**The decode merge.** Long-context serving shards a request's KV pages over the ``cp`` shards
of the pool; each shard's ragged attention returns a partial ``(out_r,
lse_r)``, and the partials merge into one softmax:

* ``m = max_r lse_r``; ``w_r = exp(lse_r - m)``, 0 where ``lse_r`` is
  NEG_INF (a shard that saw nothing of the row);
* ``out = Σ_r w_r · out_r / max(Σ_r w_r, 1e-30)`` in f32, cast to
  ``out_dtype``; ``lse = m + log(Σ_r w_r)``, NEG_INF where every shard
  was masked.

JAX's TPU kernels ``_cp_lse_combine_kernel`` (``:306``) and
``_cp_lse_combine_kernel3`` (``:341``) carry the weighted numerator rows
and the denominator row around the cp ring as an f32 add-reduce, at ring
depth 2 or 3; JAX's serving step runs the same merge in XLA
(``kernels/flash_decode.py:1367`` ``combine_gqa_partials``). The port
merges with one CUDA kernel, ``tdt_cp_lse_combine`` (``csrc/cp_ring.cu``),
launched from :func:`cp_lse_combine`: the serving step's
``combine_gqa_partials`` is its entry point. On the one card the cp
shards are slices of one stacked pool, so the ring becomes a read of
every shard's partial; ``schedule`` depth 3 stands for
``_cp_lse_combine_kernel3`` and adds a TPU ring slot and no value (the
launches are counted by the TPU kernel each stood for).

The kernel adds over the shards in the order r = 0, 1, ..., each product
and add rounded on its own, and :func:`cp_lse_combine_plain` does the
same in torch ops, so the two agree bit for bit on the card. On CPU
tensors every entry here runs its plain version; on CUDA tensors it
launches its kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from triton_distributed_tpu_torch.config import to_torch_dtype
from triton_distributed_tpu_torch.kernels.group_gemm import _DT_CODE
from triton_distributed_tpu_torch.lang.shmem import block_table
from triton_distributed_tpu_torch.tune.schedule import require_depth_only

#: the lint families' barrier ids (JAX ``:63-66``), shared with the XLA
#: bodies' heartbeats; the port's pull kernels wait on nothing
CP_RING_COLLECTIVE_ID = 15
CP_ULYSSES_COLLECTIVE_ID = 16
GRAD_RING_COLLECTIVE_ID = 17
CP_DECODE_COMBINE_COLLECTIVE_ID = 18

#: finite -inf stand-in of the attention kernels' lse
NEG_INF = -1.0e30

#: the most shards one launch merges (the kernel's register arrays)
MAX_SHARDS = 8

#: the TPU kernel each launch stands for, by ring depth
_TPU_KERNEL = {2: "_cp_lse_combine_kernel", 3: "_cp_lse_combine_kernel3"}


def _check(outs, lses):
    if outs.dim() != 4 or lses.dim() != 3 or tuple(outs.shape[:3]) != tuple(
            lses.shape):
        raise ValueError(f"cp_lse_combine: outs (R, Hkv, TG, D) and lses "
                         f"(R, Hkv, TG), got {tuple(outs.shape)} and "
                         f"{tuple(lses.shape)}")
    if not 1 <= outs.shape[0] <= MAX_SHARDS:
        raise ValueError(f"cp_lse_combine: {outs.shape[0]} shards, the "
                         f"kernel merges 1 to {MAX_SHARDS}")


def cp_lse_combine_plain(outs, lses, *, out_dtype=None):
    """Plain PyTorch version: the module docstring's merge, the sums
    over r = 0, 1, ... in that order, each op rounded on its own (the
    kernel's arithmetic, bit for bit). Returns ``(out (Hkv, TG, D) in
    out_dtype (default outs' dtype), lse (Hkv, TG) f32)``."""
    _check(outs, lses)
    out_dtype = to_torch_dtype(out_dtype or outs.dtype)
    lf = lses.float()
    m = lf.amax(dim=0)
    w = torch.where(lf > NEG_INF / 2, torch.exp(lf - m),
                    torch.zeros_like(lf))
    num = w[0][..., None] * outs[0].float()
    den = w[0]
    for r in range(1, outs.shape[0]):
        num = num + w[r][..., None] * outs[r].float()
        den = den + w[r]
    den = torch.clamp(den, min=1e-30)
    lse = torch.where(m > NEG_INF / 2, m + torch.log(den),
                      torch.full_like(m, NEG_INF))
    return (num / den[..., None]).to(out_dtype), lse


def cp_lse_combine(outs, lses, *, out_dtype=None, schedule=None):
    """Merge the cp shards' attention partials: ``outs`` (R, Hkv, TG, D)
    bf16 or f32 and ``lses`` (R, Hkv, TG) f32, R from 1 to
    ``MAX_SHARDS`` (the serving path runs R = cp ∈ {2, 3, 4}) →
    ``(out (Hkv, TG, D) in out_dtype, lse (Hkv, TG) f32)``. The two may
    be strided views over the shard and head dims (each (TG, D) or (TG,)
    slab contiguous), as the serving step passes them. ``schedule``:
    None or a ``RingSchedule`` whose only non-default field is ``depth``
    (2: ``_cp_lse_combine_kernel``, 3: ``_cp_lse_combine_kernel3``; the
    same values). On CPU tensors this is :func:`cp_lse_combine_plain`; on
    CUDA tensors it launches the kernel or raises."""
    depth = require_depth_only(schedule, "cp_lse_combine")
    _check(outs, lses)
    if outs.device.type == "cpu":
        return cp_lse_combine_plain(outs, lses, out_dtype=out_dtype)
    return _cp_lse_combine_cuda(outs, lses, out_dtype, _TPU_KERNEL[depth])


def _cp_lse_combine_cuda(outs, lses, out_dtype, tpu_kernel):
    """``tdt_cp_lse_combine``: one launch merges every (head, row)."""
    from triton_distributed_tpu_torch.kernels import _build

    if outs.device.type != "cuda" or lses.device != outs.device:
        raise ValueError(f"cp_lse_combine runs on CPU or CUDA tensors on one "
                         f"device, got {outs.device} and {lses.device}")
    out_dtype = to_torch_dtype(out_dtype or outs.dtype)
    if outs.dtype not in _DT_CODE or out_dtype not in _DT_CODE:
        raise ValueError(f"cp_lse_combine's kernel takes f32 or bf16 "
                         f"partials and output, got {outs.dtype} → "
                         f"{out_dtype}")
    if lses.dtype != torch.float32:
        raise ValueError(f"cp_lse_combine: lses must be f32, got "
                         f"{lses.dtype}")
    r, hkv, tg, d = outs.shape
    if outs.stride(3) != 1 or outs.stride(2) != d or lses.stride(2) != 1:
        raise ValueError("cp_lse_combine's kernel needs each shard's and "
                         "head's (TG, D) partial and (TG,) lse contiguous")
    out = torch.empty((hkv, tg, d), dtype=out_dtype, device=outs.device)
    lse = torch.empty((hkv, tg), dtype=torch.float32, device=outs.device)
    vec = (d % 4 == 0 and outs.stride(0) % 4 == 0 and outs.stride(1) % 4 == 0
           and outs.data_ptr() % (4 * outs.element_size()) == 0
           and out.data_ptr() % (4 * out.element_size()) == 0)
    fn = _build.function("tdt_cp_lse_combine", "pppp" + "iiii" + "LLLL"
                         + "iii" + "p")
    rc = fn(_build.ptr(outs), _build.ptr(lses), _build.ptr(out),
            _build.ptr(lse), r, hkv, tg, d, outs.stride(0), outs.stride(1),
            lses.stride(0), lses.stride(1), _DT_CODE[outs.dtype],
            _DT_CODE[out_dtype], int(vec), _build.stream(outs.device))
    _build.check(rc, "tdt_cp_lse_combine")
    _cp_lse_combine_cuda.launches += 1
    _cp_lse_combine_cuda.by_tpu_kernel[tpu_kernel] = (
        _cp_lse_combine_cuda.by_tpu_kernel.get(tpu_kernel, 0) + 1)
    return out, lse


#: launch count of the kernel (a plain int on the wrapper), and by the TPU
#: kernel each launch stood for
_cp_lse_combine_cuda.launches = 0
_cp_lse_combine_cuda.by_tpu_kernel = {}


# ------------------------------------------------ the context-parallel prefill

#: head dims the ring kernel is built for
RING_HEAD_DIMS = (16, 32, 64, 128)
#: q rows a CTA of the ring kernel, by dtype: tokens times the G query
#: heads of one KV head, so G must divide it (bf16: two warpgroups of 64
#: rows on the tensor cores; f32: the FMA kernel's 64)
RING_TILE_ROWS = {torch.bfloat16: 128, torch.float32: 64}
#: the kernel a ``tdt_ring_attention`` call launched, by the code it
#: reports (``RingVariant`` in ``csrc/cp_ring.cu``): the f32 FMA kernel, or
#: the bf16 tensor-core kernel with K and V by cp.async or by TMA (the
#: fast one; it needs every base and stride 16-byte aligned and D 64 or
#: 128). Counted in ``ring_attention_launch.by_variant``.
RING_VARIANTS = {0: "fma", 1: "cp_async", 2: "tma"}


def kv_rotate_plain(blocks):
    """One hop of the KV ring on stacked ``(n, ...)`` blocks: rank j's
    block moves to rank j + 1 (``ppermute`` with ``perm = [(j, (j + 1) %
    n)]``, JAX ``kernels/ring_attention.py:108-110``)."""
    return torch.roll(blocks, 1, dims=0)


def _check_a2a(x, direction, n):
    if direction not in ("scatter", "gather"):
        raise ValueError(f"ulysses_a2a: direction 'scatter' or 'gather', "
                         f"got {direction!r}")
    if x.dim() != 5:
        raise ValueError(f"ulysses_a2a takes (n, B, S, H, D) blocks, got "
                         f"{tuple(x.shape)}")
    split = x.shape[3] if direction == "scatter" else x.shape[2]
    if split % n:
        raise ValueError(f"ulysses_a2a {direction}: dim "
                         f"{3 if direction == 'scatter' else 2} = {split} "
                         f"does not split over {n} ranks")


def ulysses_a2a_plain(x, direction: str):
    """The Ulysses all-to-all on every rank's block at once, in torch
    ops (``lax.all_to_all(tiled=True)``'s layout, JAX
    ``kernels/ring_attention.py:145-157``):

    * ``"scatter"`` (seq → heads): x (n, B, S, H, D) → (n, B, n·S, H/n,
      D), ``out[r, b, j·S + t, h'] = x[j, b, t, r·H/n + h']``;
    * ``"gather"`` (heads → seq): x (n, B, n·S, H/n, D) → (n, B, S, H,
      D), the inverse."""
    n, b = x.shape[:2]
    _check_a2a(x, direction, n)
    if direction == "scatter":
        _, _, s, h, d = x.shape
        y = x.reshape(n, b, s, n, h // n, d).permute(3, 1, 0, 2, 4, 5)
        return y.reshape(n, b, n * s, h // n, d)
    _, _, s, hl, d = x.shape
    y = x.reshape(n, b, n, s // n, hl, d).permute(2, 1, 3, 0, 4, 5)
    return y.reshape(n, b, s // n, n * hl, d)


def ulysses_a2a(x, direction: str):
    """The Ulysses all-to-all of :func:`ulysses_a2a_plain` on every
    rank's block, ``x`` (n, B, S, H, D) stacked by rank (a strided view
    is taken as it is, each (H, D) row contiguous). On CPU tensors the
    plain version; on CUDA tensors one launch of ``tdt_ulysses_a2a``, or
    a raise. The scatter returns a contiguous (n, B, n·S, H/n, D)
    tensor; the gather a (n, B, S, H, D) view of a contiguous (B, n, S,
    H, D) tensor, so that the prefill's (B, n·S, H·D) rows are a view."""
    if x.device.type == "cpu":
        return ulysses_a2a_plain(x, direction)
    return _ulysses_a2a_cuda(x, direction)


def _ulysses_a2a_cuda(x, direction):
    """``tdt_ulysses_a2a``: one pull launch moves every rank's runs."""
    from triton_distributed_tpu_torch.kernels import _build

    if x.device.type != "cuda":
        raise ValueError(f"ulysses_a2a runs on CPU or CUDA tensors, got "
                         f"{x.device}")
    n, b = x.shape[:2]
    _check_a2a(x, direction, n)
    if x.stride(4) != 1 or x.stride(3) != x.shape[4]:
        raise ValueError("ulysses_a2a's kernel needs each token's (H, D) "
                         "row contiguous")
    es = x.element_size()
    d = x.shape[4]
    if direction == "scatter":
        _, _, t, h, _ = x.shape
        hl = h // n
        out = torch.empty((n, b, n * t, hl, d), dtype=x.dtype,
                          device=x.device)
        src_r, dst_q = hl * d * es, t * out.stride(2) * es
    else:
        _, _, s, hl, _ = x.shape
        t = s // n
        out = torch.empty((b, n, t, n * hl, d), dtype=x.dtype,
                          device=x.device).transpose(0, 1)
        src_r, dst_q = t * x.stride(2) * es, hl * d * es
    src, dst = block_table(x), block_table(out)
    fn = _build.function("tdt_ulysses_a2a", "pp" + "iii" + "L" * 7 + "p")
    rc = fn(_build.ptr(src), _build.ptr(dst), n, b, t, hl * d * es,
            x.stride(1) * es, x.stride(2) * es, src_r, out.stride(1) * es,
            out.stride(2) * es, dst_q, _build.stream(x.device))
    _build.check(rc, "tdt_ulysses_a2a")
    _ulysses_a2a_cuda.launches += 1
    _ulysses_a2a_cuda.by_tpu_kernel["_ulysses_a2a_kernel"] = (
        _ulysses_a2a_cuda.by_tpu_kernel.get("_ulysses_a2a_kernel", 0) + 1)
    return out


_ulysses_a2a_cuda.launches = 0
_ulysses_a2a_cuda.by_tpu_kernel = {}


def ring_attention_launch(q, k, v, *, causal: bool, scale: float,
                          lse: bool = False):
    """``tdt_ring_attention``: the KV ring with its attention consume on
    every rank in one launch. q (n, B, S, Hq, D) and k, v (n, B, S, Hkv,
    D) stacked by rank (strided views taken as they are: D contiguous,
    the other strides and the pointers multiples of 4 elements), f32 or
    bf16 → (n, B, S, Hq, D) in q's dtype, a view of a contiguous (B, n,
    S, Hq, D) tensor. Rank r's queries sit at global positions r·S + t
    and attend to every block in the ring's arrival order; n = 1 is
    dense attention over one block. ``lse``: also return each query
    row's log-sum-exp (n, B, S, Hq) f32 (the backward's input). bf16 runs
    on the tensor cores (``wgmma``, 128 q rows a CTA, K and V by TMA
    where the views allow it), f32 on FMA (64 rows a CTA): G must divide
    the dtype's :data:`RING_TILE_ROWS`. Counted under
    ``_kv_rotate_kernel``, and by the kernel the call launched in
    ``by_variant`` (:data:`RING_VARIANTS`)."""
    from triton_distributed_tpu_torch.kernels import _build

    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"ring attention's kernel runs on CUDA tensors on "
                         f"one device, got {q.device}, {k.device}, "
                         f"{v.device}")
    if q.dim() != 5 or k.shape != v.shape or k.dim() != 5:
        raise ValueError(f"ring attention takes (n, B, S, H, D) q, k and v, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    n, b, s, hq, d = q.shape
    hkv = k.shape[3]
    if tuple(k.shape) != (n, b, s, hkv, d) or hq % hkv:
        raise ValueError(f"ring attention: k / v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)} (Hq a multiple of Hkv)")
    g = hq // hkv
    if q.dtype not in _DT_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"ring attention's kernel takes f32 or bf16 q, k "
                         f"and v of one dtype, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    rows = RING_TILE_ROWS[q.dtype]
    if d not in RING_HEAD_DIMS or rows % g:
        raise ValueError(f"ring attention's kernel is built for head dims "
                         f"{RING_HEAD_DIMS} and G = Hq / Hkv dividing "
                         f"{rows} ({q.dtype}), got D {d}, G {g}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if (x.stride(4) != 1 or any(st % 4 for st in x.stride()[:4])
                or x.data_ptr() % (4 * x.element_size())):
            raise ValueError(f"ring attention's kernel needs {name}'s D "
                             "contiguous and its other strides and pointer "
                             "multiples of 4 elements")
    out = torch.empty((b, n, s, hq, d), dtype=q.dtype,
                      device=q.device).transpose(0, 1)
    lse_t = (torch.empty((n, b, s, hq), dtype=torch.float32,
                         device=q.device) if lse else None)
    variant = ctypes.c_int(-1)
    fn = _build.function("tdt_ring_attention", "ppppp" + "i" * 7 + "f"
                         + "L" * 16 + "i" + "pp")
    rc = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
            None if lse_t is None else _build.ptr(lse_t),
            n, b, s, hkv, g, d, int(causal), float(scale),
            *q.stride()[:4], *k.stride()[:4], *v.stride()[:4],
            *out.stride()[:4], _DT_CODE[q.dtype], ctypes.byref(variant),
            _build.stream(q.device))
    _build.check(rc, "tdt_ring_attention")
    ring_attention_launch.launches += 1
    ring_attention_launch.by_tpu_kernel["_kv_rotate_kernel"] = (
        ring_attention_launch.by_tpu_kernel.get("_kv_rotate_kernel", 0) + 1)
    if variant.value in RING_VARIANTS:
        name = RING_VARIANTS[variant.value]
        ring_attention_launch.by_variant[name] = (
            ring_attention_launch.by_variant.get(name, 0) + 1)
    return (out, lse_t) if lse else out


ring_attention_launch.launches = 0
ring_attention_launch.by_tpu_kernel = {}
ring_attention_launch.by_variant = {}


# --------------------------------------------------- the dp gradient ring

#: JAX's lint geometry (``:59``): KV blocks of 8 rows × 128 lanes, grad
#: stripes 2048 lanes wide
CP_RING_GEOM = dict(rows=8, cols=128, grad_cols=2048)

#: the TPU kernel each gradient-ring launch stands for, by ring depth
_GRAD_TPU_KERNEL = {2: "_grad_ring_kernel_w", 3: "_grad_ring_kernel_w3"}

#: shared memory a block of the ring kernels may hold (one warp's state
#: must fit)
GRAD_RING_SMEM = 227 * 1024


def _grad_slabs(parts, what):
    """``parts`` as (G, n, n·srows, cols) f32 (a 3-D (n, n·srows, cols)
    is one ring) → (parts, srows, one ring?)."""
    one = parts.dim() == 3
    x = parts[None] if one else parts
    if x.dim() != 4 or x.dtype != torch.float32:
        raise ValueError(f"{what} takes (G, n, n·srows, cols) f32 slabs, got "
                         f"{tuple(parts.shape)} {parts.dtype}")
    n, rows = x.shape[1], x.shape[2]
    if n < 1 or rows % n:
        raise ValueError(f"{what}: {rows} rows do not cut into {n} stripes")
    return x, rows // n, one


def _grad_fmt(wire, chunk_rows, srows):
    from triton_distributed_tpu_torch.lang import wire as wirelib

    quant = wirelib.wire_payload(wirelib.normalize_wire(wire))
    if quant not in ("fp8", "int8"):
        raise ValueError(f"the gradient ring ships 'fp8' or 'int8', got "
                         f"{wire!r} (resolve it first)")
    if chunk_rows < 1 or srows % chunk_rows:
        raise ValueError(f"the gradient ring: {srows} stripe rows do not cut "
                         f"into chunks of {chunk_rows}")
    return wirelib.WireFormat(quant, chunk_rows)


def _chunk_quant(y_src, fmt, sr, u):
    """(…, rows, cols) f32 → (code values, per-element scales) at
    ``fmt``'s chunks: the scale ``max(amax, 1e-12) / QMAX``, the code
    ``x / scale`` rounded (int8: ``floor(· + u)`` when ``sr``, else half
    to even; clipped to ±127; fp8 to nearest)."""
    from triton_distributed_tpu_torch.config import div_scalar

    shape = y_src.shape
    ch = y_src.reshape(*shape[:-2], shape[-2] // fmt.chunk_rows, -1)
    scale = div_scalar(torch.clamp(ch.abs().amax(dim=-1), min=1e-12),
                       fmt.qmax)[..., None]
    y = (ch / scale).reshape(shape)
    full = scale.expand(ch.shape).reshape(shape)
    if fmt.quant == "fp8":
        return y.to(torch.float8_e4m3fn).float(), full
    q = torch.floor(y + u) if sr else torch.round(y)
    return torch.clamp(q, -127, 127), full


def _ring_draws(seed, n, hops, srows, cols, device, row0=0):
    """The hash's uniforms of every (rank, hop): (n, hops, srows, cols)."""
    from triton_distributed_tpu_torch.lang.wire import sr_uniforms

    return torch.stack([torch.stack([
        sr_uniforms(seed, r, h, srows, cols, row0=row0, device=device)
        for h in range(hops)]) for r in range(n)])


def grad_ring_plain(parts, *, wire, seed: int = 0, ef: bool = True,
                    stochastic: bool = True, chunk_rows: int = 1,
                    uniforms=None, row0: int = 0):
    """Plain PyTorch version of :func:`grad_ring`, hop by hop on every
    rank at once (``csrc/grad_ring.cu``'s header states the arithmetic;
    the dequantize-adds are :func:`~triton_distributed_tpu_torch.lang.
    wire.fma_f32`). ``uniforms``: (n, n − 1, srows, cols) draws of every
    (rank, hop), e.g. JAX's; None draws the hash's of ``seed``. ``row0``:
    the stripes given are rows [row0, row0 + srows) of longer stripes
    (the draws of those rows; the rows are independent, so a long slab
    may be reduced in row chunks)."""
    from triton_distributed_tpu_torch.lang.wire import fma_f32

    x, srows, one = _grad_slabs(parts, "grad_ring_plain")
    fmt = _grad_fmt(wire, chunk_rows, srows)
    g, n, _, cols = x.shape
    sr = stochastic and fmt.quant == "int8"
    if sr and uniforms is None:
        uniforms = _ring_draws(seed, n, n - 1, srows, cols, x.device, row0)
    st = x.reshape(g, n, n, srows, cols)             # [group, rank, stripe]
    ar = torch.arange(n, device=x.device)
    acc = st[:, ar, (ar + 1) % n]
    resid = torch.zeros_like(acc)
    for h in range(n - 1):
        out = acc + resid
        q, s = _chunk_quant(out, fmt, sr, uniforms[:, h] if sr else None)
        if ef:
            resid = fma_f32(-q, s, out)
        acc = fma_f32(torch.roll(q, -1, dims=1), torch.roll(s, -1, dims=1),
                      st[:, ar, (ar + 2 + h) % n])
    return acc[0] if one else acc


def grad_ring(parts, *, wire, seed: int = 0, ef: bool = True,
              stochastic: bool = True, chunk_rows: int = 1, schedule=None):
    """The dp gradient ring's reduce-scatter on the quantized wire, every
    group's ring in one call: ``parts`` (G, n, n·srows, cols) f32, rank
    r's slab of ring g at [g, r] (each slab contiguous; the group and
    rank strides free), stripe i its rows [i·srows, (i+1)·srows) → (G,
    n, srows, cols), owner s's reduced stripe at [g, s] (3-D in, 3-D
    out). ``wire`` 'int8' or 'fp8'; ``stochastic`` rounds int8 with the
    hash's uniforms of (``seed``, rank, hop, row, column); ``ef`` carries
    the error-feedback residual; ``chunk_rows`` rows share a scale (1 on
    the training path). With ``ef=False, stochastic=False`` and
    ``make_wire_format``'s chunk this is JAX's ``_grad_ring_kernel_w``
    (``schedule`` depth 2) / ``_w3`` (depth 3: the same values). On CPU
    tensors :func:`grad_ring_plain`; on CUDA tensors one launch of
    ``tdt_grad_ring`` (``csrc/grad_ring.cu``), or a raise."""
    depth = require_depth_only(schedule, "grad_ring")
    x, srows, one = _grad_slabs(parts, "grad_ring")
    if x.device.type == "cpu":
        return grad_ring_plain(parts, wire=wire, seed=seed, ef=ef,
                               stochastic=stochastic, chunk_rows=chunk_rows)
    out = _grad_ring_cuda(x, srows, _grad_fmt(wire, chunk_rows, srows), seed,
                          ef, stochastic, _GRAD_TPU_KERNEL[depth])
    return out[0] if one else out


def _check_rows(t, what):
    if t.device.type != "cuda":
        raise ValueError(f"{what}'s kernel runs on CUDA tensors, got "
                         f"{t.device}")
    if t.stride(-1) != 1 or t.stride(-2) != t.shape[-1]:
        raise ValueError(f"{what}'s kernel needs each rank's (rows, cols) "
                         "slab contiguous")


def _warp_state(what, nbytes):
    if nbytes > GRAD_RING_SMEM:
        raise ValueError(f"{what}: a warp's state of {nbytes} B exceeds the "
                         f"{GRAD_RING_SMEM} B of shared memory a block holds; "
                         "use fewer rows a scale chunk")


def _grad_ring_cuda(x, srows, fmt, seed, ef, stochastic, tpu_kernel):
    """``tdt_grad_ring``: every group's ring in one launch."""
    from triton_distributed_tpu_torch.kernels import _build
    from triton_distributed_tpu_torch.kernels.wire import WIRE_CODE

    _check_rows(x, "grad_ring")
    g, n, _, cols = x.shape
    elems = fmt.chunk_rows * cols
    _warp_state("grad_ring", ((2 * n if ef else 1) * elems + n) * 4)
    out = torch.empty((g, n, srows, cols), dtype=torch.float32,
                      device=x.device)
    fn = _build.function("tdt_grad_ring", "pp" + "i" * 5 + "LL" + "iii"
                         + "L" + "p")
    rc = fn(_build.ptr(x), _build.ptr(out), g, n, srows, cols, fmt.chunk_rows,
            x.stride(0), x.stride(1), WIRE_CODE[fmt.quant], int(stochastic),
            int(ef), seed & 0xFFFFFFFF, _build.stream(x.device))
    _build.check(rc, "tdt_grad_ring")
    _grad_ring_cuda.launches += 1
    _grad_ring_cuda.by_tpu_kernel[tpu_kernel] = (
        _grad_ring_cuda.by_tpu_kernel.get(tpu_kernel, 0) + 1)
    return out


_grad_ring_cuda.launches = 0
_grad_ring_cuda.by_tpu_kernel = {}


def grad_allgather_plain(stripes, *, wire, seed: int = 0,
                         stochastic: bool = True, chunk_rows: int = 1,
                         uniforms=None, out=None, row0: int = 0):
    """Plain PyTorch version of :func:`grad_allgather`. ``uniforms``: (n,
    srows, cols) draws of every owner (e.g. JAX's); None draws the
    hash's of (``seed``, owner, ``AG_HOP``) at rows ``row0 + i``."""
    from triton_distributed_tpu_torch.lang.wire import AG_HOP, sr_uniforms

    one = stripes.dim() == 3
    s4 = stripes[None] if one else stripes
    g, n, srows, cols = s4.shape
    fmt = _grad_fmt(wire, chunk_rows, srows)
    sr = stochastic and fmt.quant == "int8"
    if sr and uniforms is None:
        uniforms = torch.stack([sr_uniforms(seed, s, AG_HOP, srows, cols,
                                            row0=row0, device=s4.device)
                                for s in range(n)])
    q, sc = _chunk_quant(s4.float(), fmt, sr, uniforms)
    full = (q * sc).reshape(g, 1, n * srows, cols).expand(g, n, n * srows,
                                                          cols)
    if out is None:
        out = full.contiguous()
    else:
        (out[None] if one else out).copy_(full)
        return out
    return out[0] if one else out


def grad_allgather(stripes, *, wire, seed: int = 0, stochastic: bool = True,
                   chunk_rows: int = 1, out=None):
    """The gradient ring's all-gather half (JAX ``train/grad_wire.py``
    ``quantized_allgather``): ``stripes`` (G, n, srows, cols) f32, owner
    s's stripe of ring g at [g, s] → every rank's (n·srows, cols) slab,
    (G, n, n·srows, cols) (3-D in, 3-D out), stripe s of every rank's
    slab the dequantized codes of owner s's stripe, quantized once
    (stochastic rounding keyed by (``seed``, owner, ``AG_HOP``)). ``out``:
    write into this (G, n, n·srows, cols) f32 tensor instead (each slab
    contiguous, e.g. the ring's input). JAX runs ``lax.all_gather``: no
    TPU kernel. On CPU tensors :func:`grad_allgather_plain`; on CUDA
    tensors one launch of ``tdt_grad_allgather``, or a raise."""
    if stripes.device.type == "cpu":
        return grad_allgather_plain(stripes, wire=wire, seed=seed,
                                    stochastic=stochastic,
                                    chunk_rows=chunk_rows, out=out)
    return _grad_allgather_cuda(stripes, wire, seed, stochastic, chunk_rows,
                                out)


def _grad_allgather_cuda(stripes, wire, seed, stochastic, chunk_rows, out):
    """``tdt_grad_allgather``: every group's owners in one launch."""
    from triton_distributed_tpu_torch.kernels import _build
    from triton_distributed_tpu_torch.kernels.wire import WIRE_CODE

    one = stripes.dim() == 3
    s4 = stripes[None] if one else stripes
    if s4.dim() != 4 or s4.dtype != torch.float32:
        raise ValueError(f"grad_allgather takes (G, n, srows, cols) f32 "
                         f"stripes, got {tuple(stripes.shape)}")
    g, n, srows, cols = s4.shape
    fmt = _grad_fmt(wire, chunk_rows, srows)
    _check_rows(s4, "grad_allgather")
    _warp_state("grad_allgather", fmt.chunk_rows * cols * 4)
    o4 = (torch.empty((g, n, n * srows, cols), dtype=torch.float32,
                      device=s4.device) if out is None
          else (out[None] if one else out))
    if tuple(o4.shape) != (g, n, n * srows, cols) or o4.dtype != torch.float32:
        raise ValueError(f"grad_allgather: out must be ({g}, {n}, "
                         f"{n * srows}, {cols}) f32")
    _check_rows(o4, "grad_allgather")
    fn = _build.function("tdt_grad_allgather", "pp" + "i" * 5 + "LLLL" + "ii"
                         + "L" + "p")
    rc = fn(_build.ptr(s4), _build.ptr(o4), g, n, srows, cols, fmt.chunk_rows,
            s4.stride(0), s4.stride(1), o4.stride(0), o4.stride(1),
            WIRE_CODE[fmt.quant], int(stochastic), seed & 0xFFFFFFFF,
            _build.stream(s4.device))
    _build.check(rc, "tdt_grad_allgather")
    _grad_allgather_cuda.launches += 1
    if out is not None:
        return out
    return o4[0] if one else o4


_grad_allgather_cuda.launches = 0
