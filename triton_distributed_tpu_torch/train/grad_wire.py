"""Wire-quantized gradient rings with per-hop error feedback.

Port of ``triton_distributed_tpu/train/grad_wire.py``. The backward's
rings ship 1-byte payloads (int8 or fp8 e4m3) with one f32 scale a row,
and two guards the forward wire does not need:

* **stochastic rounding** (:func:`~triton_distributed_tpu_torch.lang.wire.
  quantize_slab_sr`): int8 codes round ``floor(y + u)``, unbiased per
  element and the same bits under the same seed (the uniforms come from
  the port's counter hash of (seed, ring index, hop, row, column), not
  ``jax.random``); fp8 keeps round-to-nearest;
* **per-hop error feedback**: each rank carries the residual ``outgoing −
  dequant(quant(outgoing))`` into the next stripe it ships, so what a
  link ships telescopes to one final residual instead of n − 1
  roundings (JAX's module docstring states what this bounds).

The reduce-scatter half is :func:`ef_ring_reduce_scatter` (JAX
``:144-186``), the all-gather half :func:`quantized_allgather`
(``:189-204``: each owner's stripe quantized once, every rank, the owner
too, taking the dequantized bytes). On the card they launch
``tdt_grad_ring`` and ``tdt_grad_allgather`` (``csrc/grad_ring.cu``,
:func:`~triton_distributed_tpu_torch.kernels.cp_ring.grad_ring`); on the
CPU their plain versions. The noise is keyed by the ring index (the dp
index): every group reducing over the same axis draws the same noise, as
JAX's do, so gradients replicated over tp stay bit-identical.

The port is single-controller on a loopback mesh: a tensor sharded over
the ring's axis is its ranks' slabs stacked on a leading dim of size n
(``(n, rows, cols)``), and a leading group dim before it carries several
rings in one call (``(G, n, rows, cols)``). The dual engines of the
overlap ops' backward (:func:`ef_gemm_rs`, :func:`ef_ag_gemm`) take the
shard lists of :mod:`~triton_distributed_tpu_torch.kernels.ag_gemm` /
``gemm_rs``. The exact ``wire=None`` sum is :func:`grad_allreduce_xla`;
it is the raw wire and nothing else: nothing falls back to it.
"""

from __future__ import annotations

import zlib

import torch

from triton_distributed_tpu_torch.config import to_torch_dtype
from triton_distributed_tpu_torch.kernels import cp_ring
from triton_distributed_tpu_torch.lang import wire as wirelib

#: collective id of the dp gradient ring (the cp_ring lint family's id)
GRAD_RING_COLLECTIVE_ID = cp_ring.GRAD_RING_COLLECTIVE_ID


def resolve_grad_wire(wire_dtype, rows: int, cols: int, n: int):
    """The wire a gradient ring ships for an (rows, cols) per-rank f32
    slab reduced over ``n`` ranks (JAX ``:67``): None for None / 'bf16'
    (the exact sum); 'auto' → 'int8' where the slab splits into n stripes
    and the payload with its scale column beats the bf16 wire, else None;
    a pinned 'fp8' / 'int8' that cannot be carried raises ``ValueError``;
    'int8-mxu' ships its int8 payload. At n ≤ 1 'auto' is None and a
    pinned wire its payload."""
    w = wirelib.normalize_wire(wire_dtype)
    if w is None:
        return None
    if n <= 1:
        return None if w == "auto" else wirelib.wire_payload(w)
    srows = rows // n
    eligible = (rows % n == 0 and srows >= 1
                and srows * cols + srows * 4 < srows * cols * 2)
    if w == "auto":
        return "int8" if eligible else None
    if not eligible:
        raise ValueError(
            f"grad ring wire_dtype={w!r}: slab ({rows}, {cols}) over n={n} "
            "admits no legal wire chunking (a pinned wire format is a "
            "contract); use wire_dtype='auto' or the bf16 wire")
    return wirelib.wire_payload(w)


def _fmt(wire: str) -> wirelib.WireFormat:
    """One scale a row (JAX ``:108``)."""
    return wirelib.WireFormat(wirelib.wire_payload(wire), 1)


def derive_seed(seed: int, *tags) -> int:
    """A 31-bit seed folding ``seed`` and ``tags`` (JAX ``:114``, whose
    crc32 also folds its interpreter's configuration key, which the port
    has no counterpart of): a host-side int."""
    return zlib.crc32(repr((int(seed), tags)).encode()) & 0x7FFFFFFF


def _ranks(x, mesh, axis, what):
    n = mesh.axis_size(axis)
    if x.dim() < 3 or x.shape[-3] != n:
        raise ValueError(f"{what} takes the {n} ranks of {axis!r} stacked on "
                         f"dim -3, (n, rows, cols) or (G, n, rows, cols), got "
                         f"{tuple(x.shape)}")
    return n


def ef_ring_reduce_scatter(x, mesh, axis, *, wire, seed: int, ef: bool = True,
                           uniforms=None):
    """The quantized ring reduce-scatter with error feedback over ``axis``
    (JAX ``:144``): ``x`` (n, n·srows, cols) f32, rank r's slab at [r],
    stripe i its contribution to the stripe rank i owns (or (G, n, …):
    G rings) → (n, srows, cols) (or (G, n, …)), rank r's fully reduced
    stripe at [r]. ``wire`` a resolved 'int8' / 'fp8'; ``ef=False`` is
    the no-feedback control. ``uniforms`` ((n, n − 1, srows, cols), the
    plain version only): the draws of every (rank, hop), e.g. JAX's."""
    _ranks(x, mesh, axis, "ef_ring_reduce_scatter")
    x, fmt = x.float(), _fmt(wire)
    kw = dict(wire=fmt.quant, chunk_rows=fmt.chunk_rows, seed=seed, ef=ef)
    if uniforms is not None:
        if x.device.type != "cpu":
            raise ValueError("uniforms= feeds the plain version (CPU tensors)")
        return cp_ring.grad_ring_plain(x, uniforms=uniforms, **kw)
    return cp_ring.grad_ring(x, **kw)


def quantized_allgather(x, mesh, axis, *, wire, seed: int, uniforms=None,
                        out=None):
    """The quantize-once all-gather over ``axis`` (JAX ``:189``): ``x``
    (n, srows, cols), rank r's stripe at [r] (or (G, n, …)) → (n,
    n·srows, cols) f32 (or (G, n, …)), every rank's slab made of every
    stripe's dequantized codes, the same bytes on every rank. ``uniforms``
    ((n, srows, cols), the plain version only): each owner's draws.
    ``out``: write there (on the card, e.g. into the ring's input)."""
    _ranks(x, mesh, axis, "quantized_allgather")
    x, fmt = x.float(), _fmt(wire)
    kw = dict(wire=fmt.quant, chunk_rows=fmt.chunk_rows, seed=seed, out=out)
    if uniforms is not None:
        if x.device.type != "cpu":
            raise ValueError("uniforms= feeds the plain version (CPU tensors)")
        return cp_ring.grad_allgather_plain(x, uniforms=uniforms, **kw)
    return cp_ring.grad_allgather(x, **kw)


def grad_allreduce_xla(g, mesh, axis):
    """The exact all-reduce (JAX ``:351``, ``psum``): (n, rows, cols)
    stacked over ``axis`` (or (G, n, rows, cols)) → every rank the f32
    sum. The ``wire=None`` path; nothing degrades to it."""
    _ranks(g, mesh, axis, "grad_allreduce_xla")
    return g.float().sum(-3, keepdim=True).expand_as(g).contiguous()


def grad_allreduce_device(g, mesh, axis, *, wire, seed: int, ef: bool = True,
                          uniforms=None):
    """The gradient all-reduce (JAX ``:207``): (n, rows, cols) f32
    partials stacked over ``axis`` (or (G, n, …)) → the same shape, every
    rank the sum, the same bits on every rank: :func:`ef_ring_reduce_scatter`
    at ``seed``, then :func:`quantized_allgather` at ``seed + 1``.
    ``wire`` None (or n ≤ 1) is the exact sum (:func:`grad_allreduce_xla`).
    ``uniforms``: (the ring's, the all-gather's) draws for the plain
    version."""
    n = mesh.axis_size(axis)
    if wire is None or n <= 1:
        return grad_allreduce_xla(g, mesh, axis)
    u_rs, u_ag = uniforms if uniforms is not None else (None, None)
    red = ef_ring_reduce_scatter(g, mesh, axis, wire=wire, seed=seed, ef=ef,
                                 uniforms=u_rs)
    return quantized_allgather(red, mesh, axis, wire=wire, seed=seed + 1,
                               uniforms=u_ag)


def _leaves(tree, path=()):
    """(path, tensor) leaves in ``jax.tree.flatten``'s order: dict keys
    sorted, sequences in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _rebuild(tree, values):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], values) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, values) for v in tree)
    return next(values)


def tree_slab(grads, n: int, cols: int = 128, lead: int = 0):
    """Flatten a gradient tree into one ring-reducible f32 slab (JAX
    ``:220``): the leaves in ``jax.tree.flatten``'s order, concatenated,
    padded with zeros to rows a multiple of ``n`` → ``(*lead_dims, rows,
    cols)``, where the first ``lead`` dims of every leaf (e.g. a stacked
    rank dim) are kept. Returns (slab, unflatten); ``unflatten(slab)``
    restores the tree's shapes and dtypes."""
    leaves = [t for _, t in _leaves(grads)]
    lead_shape = tuple(leaves[0].shape[:lead])
    flat = torch.cat([t.reshape(*lead_shape, -1).float() for t in leaves],
                     dim=-1)
    total = flat.shape[-1]
    rows = -(-total // cols)
    rows += (-rows) % n
    slab = torch.nn.functional.pad(flat, (0, rows * cols - total))
    slab = slab.reshape(*lead_shape, rows, cols)

    def unflatten(s):
        out_flat = s.reshape(*lead_shape, -1)[..., :total]
        outs, off = [], 0
        for leaf in leaves:
            size = leaf[(0,) * lead].numel() if lead else leaf.numel()
            outs.append(out_flat[..., off:off + size].reshape(leaf.shape)
                        .to(leaf.dtype))
            off += size
        return _rebuild(grads, iter(outs))

    return slab, unflatten


def grad_tree_allreduce(grads, mesh, axis, *, wire, seed: int,
                        ef: bool = True):
    """The all-reduce of a gradient tree whose leaves stack the ranks of
    ``axis`` on dim 0 (JAX ``:250``): :func:`tree_slab` →
    :func:`grad_allreduce_device` → unflatten."""
    n = mesh.axis_size(axis)
    slab, unflatten = tree_slab(grads, n, lead=1)
    return unflatten(grad_allreduce_device(slab, mesh, axis, wire=wire,
                                           seed=seed, ef=ef))


def ef_gemm_rs(a, b, mesh, axis, *, out_dtype=None, wire, seed: int = 0,
               ef: bool = True):
    """GEMM → the error-feedback ring reduce-scatter (JAX ``:290``): the
    backward dual of ``ag_gemm`` on a resolved wire. ``a`` W column
    shards (M, K_q), ``b`` W row shards (K_q, N) → W (M/W, N) outputs of
    ``out_dtype`` (default a's dtype): rank q's partial ``A_q @ B_q`` in
    f32 (a local product, as JAX's ``jnp.dot``), then the ring over the
    stacked partials."""
    n = mesh.axis_size(axis)
    if len(a) != n or len(b) != n:
        raise ValueError(f"ef_gemm_rs takes {n} A and B shards")
    out_dtype = to_torch_dtype(out_dtype or a[0].dtype)
    parts = torch.stack([aq.float() @ bq.float() for aq, bq in zip(a, b)])
    red = ef_ring_reduce_scatter(parts, mesh, axis, wire=wire, seed=seed,
                                 ef=ef)
    return [r.to(out_dtype) for r in red.unbind(0)]


def ef_ag_gemm(a, b, mesh, axis, *, out_dtype=None, wire, seed: int = 0,
               return_gathered: bool = False):
    """The quantized all-gather → GEMM (JAX ``:337``): the backward dual
    of ``gemm_rs`` on a resolved wire. ``a`` W row shards (m, K), ``b`` W
    column shards (K, N_r) → W (W·m, N_r) outputs: every rank's gathered
    A is the dequantized codes of every shard (:func:`quantized_allgather`,
    cast back to A's dtype), times B_r in f32, cast to ``out_dtype``.
    ``return_gathered``: also the W gathered A's (the weight gradient's
    operand, the same wire error)."""
    n = mesh.axis_size(axis)
    if len(a) != n or len(b) != n:
        raise ValueError(f"ef_ag_gemm takes {n} A and B shards")
    out_dtype = to_torch_dtype(out_dtype or a[0].dtype)
    full = quantized_allgather(torch.stack([aq.float() for aq in a]), mesh,
                               axis, wire=wire, seed=seed).to(a[0].dtype)
    outs = [(fr.float() @ br.float()).to(out_dtype)
            for fr, br in zip(full.unbind(0), b)]
    if return_gathered:
        return outs, list(full.unbind(0))
    return outs


def ring_wire_bytes(rows: int, cols: int, n: int, wire) -> int:
    """Wire bytes one rank ships for one (rows, cols) slab all-reduce on
    the ring (JAX ``:363``): n − 1 reduce hops and n − 1 forwarded
    stripes, one f32 scale a row."""
    srows = max(rows // max(n, 1), 1)
    hops = 2 * (n - 1)
    if wire in (None, "bf16"):
        return hops * srows * cols * 2
    return hops * (srows * cols * 1 + srows * 4)
