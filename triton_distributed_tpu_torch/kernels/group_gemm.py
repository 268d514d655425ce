"""Grouped (per-expert) GEMM, and its weight and activation quantizers.

Port of ``triton_distributed_tpu/kernels/group_gemm.py`` in three modes:

* **float** (``w_scale=None``): x and w both bf16 or both f32, f32
  accumulation, stored to ``out_dtype`` — the TPU's ``_ggemm_kernel``;
* **W8A16** (``w_scale`` only): x bf16/f32, w int8 widened to x's dtype
  (as JAX's ``x @ w.astype(x.dtype)``), f32 accumulation, ``acc ·
  w_scale[e, n]`` stored straight to ``out_dtype`` — the TPU's
  ``_ggemm_q_kernel``. bf16 x runs on the tensor cores, f32 x on FMAs
  (:data:`W8A16_VARIANTS`).
* **W8A8** (``w_scale`` and ``x_scale``): x int8 from
  :func:`quantize_act_rows`, s8×s8→s32, ``acc · x_scale[m] ·
  w_scale[e, n]`` — the TPU's ``_ggemm_q8a_kernel``. On a card the
  weight is K-major (``quantize_grouped_weights(..., k_major=True)``):
  ``wgmma`` tiles for blocks of more than 16 rows, a weight-streaming
  form for a decode's few rows (:data:`W8A8_VARIANTS`).

Rows are cut into ``len(block_expert)`` equal M-blocks; block ``b``
multiplies expert ``block_expert[b]``'s (K, N) weight (the dense
projections call it with E = 1, the MoE experts with E = experts per
rank). The fp8 weight mode is not ported.

On a CUDA tensor :func:`grouped_matmul` launches the hand-written
kernels of ``csrc/group_gemm.cu`` (built on first use); on a CPU tensor
it runs :func:`grouped_matmul_plain`, the plain PyTorch version of the
same arithmetic. :func:`router_logits` is the MoE routers' f32 product
on the float mode's narrow kernel.
"""

from __future__ import annotations

import ctypes

import torch

from triton_distributed_tpu_torch.config import div_scalar, to_torch_dtype

#: the CUDA kernel's M tile: with more than one M-block, block_m must be
#: a multiple of it (one tile never straddles two experts)
KERNEL_BM = 64

_DT_CODE = {torch.float32: 0, torch.bfloat16: 1}

#: the kernel a W8A16 launch ran, as ``tdt_ggemm_w8a16`` reports it
#: (``W8a16Variant`` of ``csrc/group_gemm.cu``): bf16 x on the tensor
#: cores, with 16-byte copies (``tc``) or, where a row is not whole
#: aligned 16-byte pieces, element by element (``tc_narrow``); f32 x on
#: the FMA loop (``fma``). Counted in ``_w8a16_cuda.by_variant``.
W8A16_VARIANTS = {0: "fma", 1: "tc", 2: "tc_narrow"}

#: the form a W8A8 launch ran, as ``tdt_ggemm_w8a8`` reports it
#: (``W8a8Variant`` of ``csrc/group_gemm.cu``): ``tc``, the ``wgmma``
#: tiles of blocks of more than 16 rows (the serving step's projections
#: and experts); ``stream``, the weight-streaming ``mma.sync`` form of
#: blocks of up to 16 rows (every decode's projections); ``narrow``, the
#: stream kernel copying element by element where K % 16 or an alignment
#: rules out 16-byte copies and TMA. Counted in ``_w8a8_cuda.by_variant``.
W8A8_VARIANTS = {0: "tc", 1: "stream", 2: "narrow"}
_W8A8_FORM = {None: -1, "tc": 0, "stream": 1}


def quantize_act_rows(x):
    """Per-row symmetric int8 activation quantization: (M, K) →
    ((M, K) int8, (M, 1) f32 scales). ``torch.round`` rounds half to
    even, as ``jnp.round`` does, so the values are bit-identical."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    s = torch.where(amax > 0.0, div_scalar(amax, 127.0),
                    torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / s), -127.0, 127.0).to(torch.int8)
    return q, s


def quantize_grouped_weights(w, mode: str = "int8", k_major: bool = False):
    """(E, K, N) weights → ((E, K, N) int8, (E, N) f32 scales):
    symmetric per-(expert, out-channel) quantization. Only ``"int8"``
    is ported (the fp8 mode has no consumer on the serving path).

    ``k_major`` stores the codes as (E, N, K), K contiguous, and returns
    their (E, K, N) transposed view: the same codes, the layout W8A8's
    CUDA kernels read (the tensor cores take 8-bit operands K-major only).
    The weights W8A8 multiplies are quantized so once; nothing transposes
    a weight per call."""
    if mode != "int8":
        raise ValueError(f"weight quant mode must be int8, got {mode!r}")
    if k_major:
        wt = w.new_empty((w.shape[0], w.shape[2], w.shape[1]),
                         dtype=torch.float32).copy_(w.transpose(1, 2))
        amax = wt.abs().amax(dim=2)                            # (E, N)
        scale = div_scalar(torch.clamp(amax, min=1e-30), 127.0)
        q = torch.round(wt / scale[:, :, None])
        return torch.clamp(q, -127, 127).to(torch.int8).transpose(1, 2), scale
    wf = w.float()
    amax = wf.abs().amax(dim=1)                                # (E, N)
    scale = div_scalar(torch.clamp(amax, min=1e-30), 127.0)
    q = torch.round(wf / scale[:, None, :])
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def k_major(q):
    """Whether (..., K, N) codes are a view of K-contiguous (..., N, K)
    storage, the layout W8A8's CUDA kernels take (read from the strides:
    the wrappers' host time counts)."""
    if q.dim() < 2:
        return False
    *lead, k, n = q.shape
    *lead_st, sk, sn = q.stride()
    if (k != 1 and sk != 1) or (n != 1 and sn != k):
        return False
    expect = n * k
    for size, st in zip(reversed(lead), reversed(lead_st)):
        if size != 1 and st != expect:
            return False
        expect *= size
    return True


def to_k_major(q):
    """(..., K, N) codes as the (..., K, N) view of a K-contiguous copy
    (the codes unchanged; no copy when they are K-major already): for
    weights carried in N-major (a JAX tree), once, when they load."""
    return q if k_major(q) else q.transpose(-1, -2).contiguous().transpose(
        -1, -2)


def dequantize_grouped_weights(q, scale, dtype=torch.bfloat16):
    """Widen (E, K, N) int8 weights with their (E, N) scales; the result
    is contiguous whatever the codes' layout."""
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    out.copy_(q).mul_(scale[:, None, :])
    return out.to(to_torch_dtype(dtype))


def _check_args(x_sorted, w, block_expert, w_scale, x_scale):
    cap, k = x_sorted.shape
    e, kw, n = w.shape
    if kw != k:
        raise ValueError(f"x has K={k} but w has K={kw}")
    if w_scale is None:
        if x_scale is not None:
            raise ValueError("x_scale requires w_scale (W8A8 mode)")
        if x_sorted.dtype not in _DT_CODE or w.dtype != x_sorted.dtype:
            raise ValueError(
                "the float mode takes x and w both f32 or both bf16, got "
                f"{x_sorted.dtype} and {w.dtype}")
    elif w.dtype != torch.int8:
        raise ValueError(f"w_scale needs int8 w, got {w.dtype}")
    elif tuple(w_scale.shape) != (e, n):
        raise ValueError(f"w_scale shape {tuple(w_scale.shape)} != {(e, n)}")
    nb = block_expert.shape[0]
    if nb < 1 or cap % nb:
        raise ValueError(
            f"{cap} rows do not split into {nb} equal M-blocks")
    if x_scale is not None:
        if x_sorted.dtype != torch.int8:
            raise ValueError(f"W8A8 needs int8 x, got {x_sorted.dtype}")
        if tuple(x_scale.shape) != (cap, 1):
            raise ValueError(
                f"x_scale shape {tuple(x_scale.shape)} != {(cap, 1)}")
    return cap, k, e, n, cap // nb


def grouped_matmul_plain(x_sorted, w, block_expert, *, w_scale=None,
                         x_scale=None, out_dtype=None):
    """Plain PyTorch version of :func:`grouped_matmul` (same signature).

    The float mode is a per-block f32 matmul stored to ``out_dtype``.
    W8A8 sums s8×s8 products exactly: in int64 on the CPU, in float64 on
    a card (CUDA has no general integer matmul; every partial sum is an
    integer far below 2**53, so float64 is exact too). The epilogue then
    repeats the kernel's f32 ``(acc · x_scale) · w_scale``."""
    cap, _, _, n, block_m = _check_args(
        x_sorted, w, block_expert, w_scale, x_scale)
    if x_scale is not None:
        out_dtype = to_torch_dtype(out_dtype or torch.bfloat16)
        acc_t = torch.int64 if x_sorted.device.type == "cpu" else torch.float64
        out = torch.empty((cap, n), dtype=out_dtype, device=x_sorted.device)
        for b, e in enumerate(block_expert.tolist()):
            rows = slice(b * block_m, (b + 1) * block_m)
            acc = x_sorted[rows].to(acc_t) @ w[e].to(acc_t)
            y = acc.float() * x_scale[rows].float()
            y = y * w_scale[e].float()[None, :]
            out[rows] = y.to(out_dtype)
        return out
    out_dtype = to_torch_dtype(out_dtype or x_sorted.dtype)
    out = torch.empty((cap, n), dtype=out_dtype, device=x_sorted.device)
    for b, e in enumerate(block_expert.tolist()):
        rows = slice(b * block_m, (b + 1) * block_m)
        acc = x_sorted[rows].float() @ w[e].float()
        if w_scale is not None:
            acc = acc * w_scale[e].float()[None, :]
        out[rows] = acc.to(out_dtype)
    return out


def grouped_matmul(x_sorted, w, block_expert, *, w_scale=None, x_scale=None,
                   out_dtype=None):
    """x_sorted (cap, K) @ w (E, K, N) → (cap, N), expert per M-block:
    the float mode (``w_scale=None``, w in x's dtype), W8A16 (int8 w
    with ``w_scale``) or W8A8 (``x_scale`` too).

    ``out_dtype`` defaults to x's dtype, and to bf16 for W8A8.
    On a CPU tensor this is :func:`grouped_matmul_plain`; on a CUDA
    tensor it launches the kernel or raises."""
    if x_sorted.device.type == "cpu":
        return grouped_matmul_plain(
            x_sorted, w, block_expert, w_scale=w_scale, x_scale=x_scale,
            out_dtype=out_dtype)
    cap, k, _, n, block_m = _check_args(
        x_sorted, w, block_expert, w_scale, x_scale)
    if w_scale is None:
        return _ggemm_f_cuda(x_sorted, w, block_expert, out_dtype, cap, k,
                             n, block_m)
    if x_scale is not None:
        return _w8a8_cuda(x_sorted, w, block_expert, w_scale, x_scale,
                          out_dtype, cap, k, n, block_m)
    return _w8a16_cuda(x_sorted, w, block_expert, w_scale, out_dtype,
                       cap, k, n, block_m)


def _cuda_common(tensors, block_expert, cap, block_m):
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"grouped_matmul runs on CPU or CUDA tensors, "
                         f"got {dev}")
    for t in (*tensors, block_expert):
        if t.device != dev:
            raise ValueError(f"tensor on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError("grouped_matmul's CUDA kernel needs "
                             "contiguous tensors")
    if block_expert.dtype != torch.int32:
        raise ValueError(f"block_expert must be int32, got "
                         f"{block_expert.dtype}")
    if block_expert.shape[0] > 1 and block_m % KERNEL_BM:
        raise ValueError(
            f"block_m={block_m} must be a multiple of {KERNEL_BM} when "
            "there is more than one M-block")
    return dev


def _w8a8_cuda(x, w, block_expert, w_scale, x_scale, out_dtype, cap, k, n,
               block_m, form=None):
    """Launch W8A8; ``form`` ("tc" or "stream") asks for one form, for
    measuring where one hands over to the other (None: by the kernel's
    threshold)."""
    from triton_distributed_tpu_torch.kernels import _build

    out_dtype = to_torch_dtype(out_dtype or torch.bfloat16)
    if out_dtype not in _DT_CODE:
        raise ValueError(f"W8A8 out_dtype must be f32 or bf16, got "
                         f"{out_dtype}")
    if w_scale.dtype != torch.float32 or x_scale.dtype != torch.float32:
        raise ValueError("W8A8 scales must be float32")
    if not k_major(w):
        raise ValueError(
            "W8A8's CUDA kernels take the weight K-major: an (E, K, N) "
            "view of (E, N, K) int8 codes, K contiguous (as "
            "quantize_grouped_weights(..., k_major=True) stores them); got "
            f"an (E, K, N) weight of strides {tuple(w.stride())}")
    dev = _cuda_common((x, w_scale, x_scale), block_expert, cap, block_m)
    if w.device != dev:
        raise ValueError(f"tensor on {w.device}, expected {dev}")
    out = torch.empty((cap, n), dtype=out_dtype, device=dev)
    variant = ctypes.c_int(-1)
    fn = _build.function("tdt_ggemm_w8a8", "pppppp" + "iiiiiii" + "pp")
    rc = fn(x.data_ptr(), x_scale.data_ptr(), w.data_ptr(),
            w_scale.data_ptr(), block_expert.data_ptr(), out.data_ptr(),
            cap, k, n, w.shape[0], block_m, _DT_CODE[out_dtype],
            _W8A8_FORM[form], ctypes.byref(variant), _build.stream(dev))
    _build.check(rc, "tdt_ggemm_w8a8")
    _w8a8_cuda.launches += 1
    name = W8A8_VARIANTS.get(variant.value)
    if name is not None:
        _w8a8_cuda.by_variant[name] = _w8a8_cuda.by_variant.get(name, 0) + 1
    return out


def _w8a16_cuda(x, w, block_expert, w_scale, out_dtype, cap, k, n,
                block_m):
    from triton_distributed_tpu_torch.kernels import _build

    out_dtype = to_torch_dtype(out_dtype or x.dtype)
    if x.dtype not in _DT_CODE or out_dtype not in _DT_CODE:
        raise ValueError(f"W8A16 takes f32/bf16 x and out, got {x.dtype} "
                         f"-> {out_dtype}")
    if w_scale.dtype != torch.float32:
        raise ValueError("W8A16 w_scale must be float32")
    dev = _cuda_common((x, w, w_scale), block_expert, cap, block_m)
    out = torch.empty((cap, n), dtype=out_dtype, device=dev)
    variant = ctypes.c_int(-1)
    fn = _build.function("tdt_ggemm_w8a16", "ppppp" + "iiiiii" + "pp")
    rc = fn(_build.ptr(x), _build.ptr(w), _build.ptr(w_scale),
            _build.ptr(block_expert), _build.ptr(out), cap, k, n, block_m,
            _DT_CODE[x.dtype], _DT_CODE[out_dtype], ctypes.byref(variant),
            _build.stream(dev))
    _build.check(rc, "tdt_ggemm_w8a16")
    _w8a16_cuda.launches += 1
    if variant.value in W8A16_VARIANTS:
        name = W8A16_VARIANTS[variant.value]
        _w8a16_cuda.by_variant[name] = _w8a16_cuda.by_variant.get(name, 0) + 1
    return out


def _ggemm_f_cuda(x, w, block_expert, out_dtype, cap, k, n, block_m):
    """Launch the float-mode kernel, counted by x's dtype."""
    from triton_distributed_tpu_torch.kernels import _build

    out_dtype = to_torch_dtype(out_dtype or x.dtype)
    if out_dtype not in _DT_CODE:
        raise ValueError(f"out_dtype must be f32 or bf16, got {out_dtype}")
    dev = _cuda_common((x, w), block_expert, cap, block_m)
    out = torch.empty((cap, n), dtype=out_dtype, device=dev)
    fn = _build.function("tdt_ggemm_f", "pppp" + "iiiiii" + "p")
    rc = fn(_build.ptr(x), _build.ptr(w), _build.ptr(block_expert),
            _build.ptr(out), cap, k, n, block_m, _DT_CODE[x.dtype],
            _DT_CODE[out_dtype], _build.stream(dev))
    _build.check(rc, "tdt_ggemm_f")
    if x.dtype == torch.bfloat16:
        _ggemm_f_cuda.launches_bf16 += 1
    else:
        _ggemm_f_cuda.launches_f32 += 1
    return out


def float_gemm(a, b, out_dtype=None):
    """(M, K) @ (K, N) on a CUDA tensor through the float-mode kernel
    with one expert (a and b both bf16 or both f32, f32 sums, stored to
    ``out_dtype``, default a's dtype), counted with the float mode's
    launches."""
    x, w = a.contiguous(), b.contiguous()[None]
    be = torch.zeros((1,), dtype=torch.int32, device=a.device)
    cap, k, _, n, block_m = _check_args(x, w, be, None, None)
    return _ggemm_f_cuda(x, w, be, out_dtype, cap, k, n, block_m)


def router_logits(x, router):
    """A MoE block's f32 router product, ``x.float() @ router.float()``
    (JAX: an XLA dot). On CUDA tensors one launch of the float mode's
    narrow kernel (one expert, counted as ``ggemm_f32``) on x and the
    router as they are, each f32 or bf16 (widened exactly in the
    kernel: no cast), x's rows at any pitch: every row's sums run in one
    K order whatever the batch, so a row's route does not depend on the
    rows packed beside it (cuBLAS picks its algorithm, and so its
    summation order, by the batch's shape), and they are the bits of
    :func:`float_gemm` on the widened operands. On CPU tensors the plain
    product."""
    if x.device.type == "cpu":
        return x.float() @ router.float()
    return _router_cuda(x, router)


def _router_cuda(x, router):
    from triton_distributed_tpu_torch.kernels import _build

    if x.dim() != 2 or router.dim() != 2 or x.shape[1] != router.shape[0]:
        raise ValueError(f"router_logits takes x (M, K) and a (K, N) router, "
                         f"got {tuple(x.shape)} and {tuple(router.shape)}")
    if x.dtype not in _DT_CODE or router.dtype not in _DT_CODE:
        raise ValueError(f"router_logits' kernel takes f32 or bf16 x and "
                         f"router, got {x.dtype} and {router.dtype}")
    if x.device.type != "cuda" or router.device != x.device:
        raise ValueError(f"router_logits runs on CPU or CUDA tensors on one "
                         f"device, got {x.device} and {router.device}")
    if x.stride(1) != 1 and x.shape[1] > 1:
        x = x.contiguous()
    router = router.contiguous()
    m, k = x.shape
    n = router.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    fn = _build.function("tdt_narrow_f32", "pLpp" + "iiiii" + "p")
    rc = fn(_build.ptr(x), max(x.stride(0), k), _build.ptr(router),
            _build.ptr(out), m, k, n, _DT_CODE[x.dtype],
            _DT_CODE[router.dtype], _build.stream(x.device))
    _build.check(rc, "tdt_narrow_f32")
    _ggemm_f_cuda.launches_f32 += 1
    return out


#: launch counts of the kernels (plain ints on the wrappers); the float
#: mode counts its bf16 (tensor-core) and f32 (FMA) kernels apart
_w8a8_cuda.launches = 0
_w8a8_cuda.by_variant = {}
_w8a16_cuda.launches = 0
_w8a16_cuda.by_variant = {}
_ggemm_f_cuda.launches_bf16 = 0
_ggemm_f_cuda.launches_f32 = 0


def padded_splits(splits, block_m: int, cap: int):
    """Block-aligned per-expert counts with the tail slack folded into
    the last group, so the sizes sum to ``cap``."""
    from triton_distributed_tpu_torch.kernels.moe_utils import (
        round_up_to_block,
    )

    padded = round_up_to_block(splits, block_m)
    slack = cap - padded.sum()
    return torch.cat([padded[:-1], (padded[-1] + slack).reshape(1)])
