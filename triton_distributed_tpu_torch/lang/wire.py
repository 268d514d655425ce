"""Quantized ring wires: fp8 / int8 payloads with per-chunk f32 scales.

Port of the host half of ``triton_distributed_tpu/lang/wire.py``: the
wire spellings (``WIRE_DTYPES``, :func:`normalize_wire` ``:94``,
:func:`wire_payload` ``:107``), the wire geometry (:class:`WireFormat`
``:118``, :func:`pick_chunk_rows` ``:149``, :func:`make_wire_format`
``:159``), the value-level transforms (:func:`quantize_slab` ``:171``
with its two halves :func:`slab_scales` and :func:`quantize_at`,
:func:`dequantize_slab` ``:190``, :func:`quantize_cols` ``:625``) and the
eligibility test (:func:`wire_blockable` ``:662`` with
``_wire_cols_block`` ``:238``).

The wire: a (rows, cols) slab is shipped as 1-byte codes (fp8 e4m3 or
int8) plus ONE f32 scale per chunk of ``chunk_rows`` consecutive rows,
``scale = max(chunk amax, 1e-12) / QMAX`` and ``code = x / scale``
(int8: rounded half to even and clipped to ±127; fp8: cast with
saturation). The AG side quantizes once at the source (each rank's own
shard is consumed exact); the RS side requantizes every hop's running
partial and adds in f32.

The port keeps one f32 a chunk, shape ``(chunks,)``. JAX ships the scale
as a ``(chunks, 128)`` plane, the scale replicated across 128 lanes so
that a ``(1, 128)`` block is a legal Mosaic operand; :meth:`WireFormat.
slab_bytes` still counts that plane, because :func:`wire_blockable`
uses it to decide which slabs may carry a wire, and the port accepts
exactly the slabs JAX accepts (on the CPU, ``strict=False``).

The in-kernel pipelines (``quant_pipeline`` … ``dequant_rows_into``,
``:254-536``) are device functions of ``csrc/wire.cuh``. JAX's Mosaic
toolchain gates (``inkernel_wire_ok``, ``inkernel_s8_dot_ok``,
``require_inkernel``, ``require_mxu``, ``:557-622``) have no Hopper
counterpart: sm_90a converts fp8 and multiplies s8 natively, so every
wire is carried in-kernel.

**Stochastic rounding** (:func:`quantize_slab_sr`, JAX ``:199-229``), the
gradient rings' quantizer: the same scales, and int8 codes ``floor(x /
scale + u)`` clipped to ±127 with ``u`` uniform in [0, 1); fp8 keeps
round-to-nearest (its grid is not uniform). JAX draws ``u`` from
``jax.random``, which the port does not reproduce: its uniforms come
from a counter-based hash of (seed, ring index, hop, row, column)
(:func:`sr_uniforms`), the same 32-bit integer operations in torch (on
int64, masked) and in ``csrc/grad_ring.cu``, so that the card and the
CPU draw the same bits. The plain functions also take the uniforms as a
tensor, which is how a test feeds in JAX's own draws. :func:`fma_f32`
is the correctly rounded f32 ``a·b + c`` of the rings' dequantize-add.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from triton_distributed_tpu_torch.config import div_scalar

#: accepted wire_dtype spellings. None and "bf16" both mean the raw wire
#: (the compute dtype); "int8-mxu" ships the int8 payload and ends the
#: wire at the tensor cores (an s8 x s8 -> s32 product, the chunk scale
#: folded into the epilogue); "auto" defers to a selector.
WIRE_DTYPES = (None, "bf16", "fp8", "int8", "int8-mxu", "auto")

_QMAX = {"fp8": 448.0, "int8": 127.0}
_WDT = {"fp8": torch.float8_e4m3fn, "int8": torch.int8}

#: lane width of JAX's scale planes (one f32 scale replicated per lane);
#: counted by :meth:`WireFormat.slab_bytes`, not stored by the port
SCALE_LANES = 128


def _divisor_block(dim: int, target: int, mult: int, strict: bool):
    """Largest divisor of ``dim`` <= ``target``, preferring multiples of
    ``mult``; with ``strict`` only such a multiple or the whole dim.
    The port's own copy of JAX's ``kernels/ag_gemm.py:82``: the wire's
    chunking must equal JAX's exactly."""
    best = None
    for b in range(min(target, dim), 0, -1):
        if dim % b == 0:
            if b % mult == 0:
                return b
            if best is None:
                best = b
    if strict and best != dim:
        return None
    return best


def normalize_wire(wire_dtype) -> str | None:
    """Canonical spelling: None for the raw wire, 'fp8' / 'int8',
    'int8-mxu', or 'auto' passed through for the selectors."""
    if wire_dtype in (None, "bf16"):
        return None
    if wire_dtype in ("fp8", "int8", "int8-mxu", "auto"):
        return wire_dtype
    raise ValueError(
        f"wire_dtype must be one of {WIRE_DTYPES}, got {wire_dtype!r}")


def wire_payload(wire: str | None) -> str | None:
    """The payload a wire spelling ships: 'int8-mxu' ships int8 (only
    its consumer differs), so ops without a tensor-core consumer (the
    reduce ring, the standalone all-gather) carry it as plain int8."""
    return "int8" if wire == "int8-mxu" else wire


@dataclass(frozen=True)
class WireFormat:
    """Static geometry of one wire: ``quant`` 'fp8' | 'int8', and
    ``chunk_rows`` rows per f32 scale (dividing the slab's rows)."""

    quant: str
    chunk_rows: int

    @property
    def wire_dtype(self) -> torch.dtype:
        return _WDT[self.quant]

    @property
    def qmax(self) -> float:
        return _QMAX[self.quant]

    def chunks(self, rows: int) -> int:
        if rows % self.chunk_rows:
            raise ValueError(f"{rows} rows do not cut into chunks of "
                             f"{self.chunk_rows}")
        return rows // self.chunk_rows

    def scale_shape(self, rows: int) -> tuple:
        """The port's scales: one f32 a chunk."""
        return (self.chunks(rows),)

    def slab_bytes(self, rows: int, cols: int) -> int:
        """Bytes of one (rows, cols) slab on JAX's wire: the payload and
        a 128-lane f32 scale row a chunk (the eligibility test's
        measure)."""
        return rows * cols + self.chunks(rows) * SCALE_LANES * 4


def pick_chunk_rows(rows: int, strict: bool = False, target: int = 64):
    """Rows a scale covers: the largest divisor of ``rows`` <= ``target``,
    preferring multiples of 32 (JAX's int8 sublane granule), or None
    where ``strict`` finds none."""
    return _divisor_block(rows, min(target, rows), 32, strict)


def make_wire_format(quant: str, rows: int, *, strict: bool = False,
                     chunk_rows: int | None = None) -> WireFormat | None:
    """The :class:`WireFormat` of a slab of ``rows`` rows (the payload of
    ``quant``), or None when no chunking is legal."""
    cr = chunk_rows or pick_chunk_rows(rows, strict)
    if cr is None or rows % cr:
        return None
    return WireFormat(quant=wire_payload(quant), chunk_rows=cr)


def _codes(y, quant: str):
    """f32 values already divided by their scale → wire codes."""
    if quant == "int8":
        return torch.clamp(torch.round(y), -127, 127).to(torch.int8)
    return y.to(torch.float8_e4m3fn)


def slab_scales(x, fmt: WireFormat):
    """The (chunks,) f32 scales of a (rows, cols) slab: ``max(chunk amax,
    1e-12) / QMAX``, the amax taken in f32."""
    rows, cols = x.shape
    amax = x.float().reshape(fmt.chunks(rows), -1).abs().amax(dim=-1)
    return div_scalar(torch.clamp(amax, min=1e-12), fmt.qmax)


def quantize_at(x, scale, fmt: WireFormat):
    """The (rows, cols) codes of ``x`` at the given per-chunk ``scale``:
    ``code = x / scale`` (a division). The int8-mxu reduce fold takes a
    hop's scale off its f32 sum and its codes off the sum rounded to the
    output type (``lang/wire.py:404``)."""
    rows, cols = x.shape
    xf = x.float().reshape(fmt.chunks(rows), -1)
    return _codes(xf / scale[:, None], fmt.quant).reshape(rows, cols)


def quantize_slab(x, fmt: WireFormat):
    """(rows, cols) → ((rows, cols) codes, (chunks,) f32 scales):
    symmetric per-chunk quantization, ``scale = max(amax, 1e-12) /
    QMAX``, ``code = x / scale`` (a division, as JAX computes it)."""
    scale = slab_scales(x, fmt)
    return quantize_at(x, scale, fmt), scale


def dequantize_slab(q, scales, fmt: WireFormat, out_dtype):
    """Inverse of :func:`quantize_slab`: ``code · scale`` in f32, cast to
    ``out_dtype``."""
    rows, cols = q.shape
    ch = fmt.chunks(rows)
    y = q.float().reshape(ch, fmt.chunk_rows * cols) * scales[:, None]
    return y.reshape(rows, cols).to(out_dtype)


def quantize_cols(b):
    """(K, N) weight → ((K, N) int8, (1, N) f32 scales): symmetric per
    output channel, ``scale = max(amax, 1e-30) / 127`` — the stationary
    operand of the int8-mxu products. Leading dims batch: (..., K, N) →
    (..., 1, N) scales."""
    bf = b.float()
    amax = bf.abs().amax(dim=-2, keepdim=True)
    scale = div_scalar(torch.clamp(amax, min=1e-30), 127.0)
    q = torch.clamp(torch.round(bf / scale), -127, 127).to(torch.int8)
    return q, scale


# ------------------------------------------------- stochastic rounding

_M32 = 0xFFFFFFFF
#: the hop index of the all-gather half's draws (it quantizes once, at
#: no hop of the reduce ring)
AG_HOP = 0xFFFF


def _mul32(x, c: int):
    """``x · c mod 2**32`` on int64 tensors holding uint32 values, in
    16-bit halves so that no product leaves int64."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """A 32-bit integer hash (lowbias32): xor-shifts and two odd
    multipliers, a bijection of [0, 2**32). ``csrc/grad_ring.cu``
    ``sr_mix`` is the same function on ``uint32_t``."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def sr_key(seed: int, ring: int, hop: int) -> int:
    """The 32-bit key of one quantization: ``seed``, the ring index
    (the quantizing rank's index on the ring) and the ``hop``."""
    k = torch.tensor([(seed ^ 0x9E3779B9) & _M32], dtype=torch.int64)
    k = _mix32(_mix32(_mix32(k) ^ (ring & _M32)) ^ (hop & _M32))
    return int(k.item())


def sr_uniforms(seed: int, ring: int, hop: int, rows: int, cols: int, *,
                row0: int = 0, device=None):
    """(rows, cols) f32 uniforms in [0, 1) of the counter-based hash:
    element (i, j) is ``mix(mix(key ^ (row0 + i)) ^ j) >> 8`` times
    2**-24, ``key = sr_key(seed, ring, hop)``; every value is a multiple
    of 2**-24, exact in f32."""
    key = sr_key(seed, ring, hop)
    r = torch.arange(row0, row0 + rows, dtype=torch.int64, device=device)
    c = torch.arange(cols, dtype=torch.int64, device=device)
    v = _mix32(_mix32((r ^ key) & _M32)[:, None] ^ c[None, :])
    return (v >> 8).to(torch.float32) * (2.0 ** -24)


def quantize_slab_sr(x, fmt: WireFormat, *, uniforms=None, seed=None,
                     ring: int = 0, hop: int = 0, row0: int = 0):
    """:func:`quantize_slab` with stochastic rounding (JAX ``:199``):
    (rows, cols) → ((rows, cols) codes, (chunks,) f32 scales), the scales
    those of :func:`quantize_slab`. int8 codes are ``floor(x / scale +
    u)`` (the add rounded to f32), clipped to ±127, with ``uniforms``
    ((rows, cols) f32 in [0, 1), e.g. JAX's own draws) or, without them,
    the hash's draws of ``(seed, ring, hop)`` at rows ``row0 + i``
    (:func:`sr_uniforms`); fp8 rounds to nearest and takes none."""
    rows, cols = x.shape
    scale = slab_scales(x, fmt)
    y = (x.float().reshape(fmt.chunks(rows), -1) / scale[:, None]).reshape(
        rows, cols)
    if fmt.quant != "int8":
        return y.to(torch.float8_e4m3fn), scale
    if uniforms is None:
        if seed is None:
            raise ValueError("quantize_slab_sr on int8 needs uniforms= or "
                             "seed=")
        uniforms = sr_uniforms(seed, ring, hop, rows, cols, row0=row0,
                               device=x.device)
    q = torch.clamp(torch.floor(y + uniforms.float()), -127, 127)
    return q.to(torch.int8), scale


def fma_f32(a, b, c):
    """``a · b + c`` rounded once to f32, as ``__fmaf_rn``, for an f32
    ``b`` and ``c`` and an ``a`` whose product with ``b`` is exact in
    f64 (a wire code: at most 8 significant bits). The sum runs in f64
    with its error (two-sum); where the f64 sum falls exactly on a
    midpoint of two f32 values, the error decides the side, so the
    double rounding never moves a bit."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    f = s.float()
    d = s - f.double()
    inf = torch.full_like(f, float("inf"))
    nb = torch.nextafter(f, torch.where(d > 0, inf, -inf))
    mid = (d != 0) & ((nb.double() - f.double()).abs() == 2 * d.abs())
    return torch.where(mid & (err * d > 0), nb, f)


def _wire_cols_block(cols: int, itemsize: int = 1, strict: bool = False):
    """The column block of JAX's dequant pipelines (``:238``): 128 where
    it divides ``cols``, else a divisor of ``cols`` (None only with
    ``strict``, JAX's real-TPU lowering rule, which JAX applies only
    when it compiles for a TPU). The port's kernels take any width."""
    del itemsize
    if cols % SCALE_LANES == 0:
        return SCALE_LANES
    return _divisor_block(cols, SCALE_LANES, 128, strict)


def wire_blockable(rows: int, cols: int, quant: str,
                   strict: bool = False) -> bool:
    """Can a (rows, cols) slab carry this wire: a legal chunking, a
    column block, and fewer bytes than the bf16 wire (a narrow slab
    whose scale rows eat the compression is refused, not shipped
    larger)."""
    fmt = make_wire_format(wire_payload(quant), rows, strict=strict)
    if fmt is None or _wire_cols_block(cols) is None:
        return False
    return fmt.slab_bytes(rows, cols) < rows * cols * 2
