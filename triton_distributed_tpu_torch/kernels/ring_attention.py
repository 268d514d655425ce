"""Context-parallel attention for the prefill: ring and Ulysses.

Port of ``triton_distributed_tpu/kernels/ring_attention.py``. Both
schemes take q, k and v with the sequence sharded over a mesh axis: on
the loopback mesh a tensor sharded over ``axis`` is its ranks' blocks
stacked, q (n, B, S, Hq, D) and k, v (n, B, S, Hkv, D), rank r holding
positions [r·S, (r+1)·S) (GQA: Hq a multiple of Hkv). Both return (n,
B, S, Hq, D) in q's dtype and compute dense attention, causal or not:

* **Ring attention** (JAX ``:70-119``): q stays put; the KV blocks
  rotate around the ring, and each block's partial (m, l, o) in f32
  folds into the rank's online softmax, the own block first (step 0
  peeled), then the block of ``src = (me − i) mod n`` at hop i.
* **Ulysses** (JAX ``:122-163``): an all-to-all re-shards sequence →
  heads (each rank gets the whole sequence of Hq/n heads), dense
  attention runs on the local heads, and a second all-to-all re-shards
  back. Hq must split over the ranks; KV heads that do not are
  replicated (``repeat_interleave``) when the ranks split over them.

The plain versions follow JAX's bodies step by step in torch ops:
:func:`_block_attn` in f32 with the ``-1e30`` mask, the hops as
:func:`~triton_distributed_tpu_torch.kernels.cp_ring.kv_rotate_plain`
moves of the stacked blocks (the counterpart of ``ppermute``),
``combine`` and the final ``max(l, 1e-30)`` division; the Ulysses
layouts as :func:`~triton_distributed_tpu_torch.kernels.cp_ring.
ulysses_a2a_plain`; Ulysses' local attention is the ring on one block.
On CPU tensors :func:`ring_attention` and
:func:`ulysses_attention` run them; on CUDA tensors they launch the
kernels of :mod:`~triton_distributed_tpu_torch.kernels.cp_ring`
(``tdt_ring_attention``, one launch for every rank; Ulysses' local
attention on the same kernel with one block, and ``tdt_ulysses_a2a``
four times: q, k and v out, the output back), or raise. They are the
entry points of the two TPU kernels ``_kv_rotate_kernel`` and
``_ulysses_a2a_kernel``, which JAX launches only from its lint builders.

**Gradients** (training): JAX differentiates its XLA bodies. Where a
gradient is wanted both entries run autograd Functions: the ring's
forward as above, the kernel also writing each query row's log-sum-exp,
and :func:`ring_attention_bwd` (torch ops, per source block) as its
backward; the all-to-all's backward is the all-to-all in the other
direction, on the kernel.
"""

from __future__ import annotations

import math

import torch

from triton_distributed_tpu_torch.kernels import cp_ring

NEG_INF = -1.0e30

#: collective ids of the CP rings (JAX ``:48-49``, shared with the
#: ``cp_ring`` lint families): ring KV rotation 15, Ulysses a2a 16
RING_ATTENTION_COLLECTIVE_ID = 15
ULYSSES_COLLECTIVE_ID = 16


def _block_attn(q, k, v, scale, mask):
    """One blockwise partial (JAX ``:52``): (max, exp-sums, weighted V)
    in f32. q (..., Sq, Hkv, G, D); k, v (..., Skv, Hkv, D); ``mask``
    broadcastable to (..., Sq, Hkv, G, Skv)."""
    s = torch.einsum("...qhgd,...khd->...qhgk", q.float(), k.float()) * scale
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("...qhgk,...khd->...qhgd", p, v.float())
    return m, l, o


def _combine(acc, blk):
    """Fold a block's partial into the running one (JAX ``:93-100``)."""
    m_acc, l_acc, o_acc = acc
    m_blk, l_blk, o_blk = blk
    m_new = torch.maximum(m_acc, m_blk)
    a_old = torch.exp(m_acc - m_new)
    a_blk = torch.exp(m_blk - m_new)
    return m_new, a_old * l_acc + a_blk * l_blk, a_old * o_acc + a_blk * o_blk


def _scale(d, scale):
    return 1.0 / math.sqrt(d) if scale is None else scale


def ring_attention_plain(q, k, v, *, causal: bool = True, scale=None,
                         skip_masked: bool = False, return_lse: bool = False):
    """Ring attention on every rank at once, JAX's body step by step:
    q (n, B, S, Hq, D), k / v (n, B, S, Hkv, D) → (n, B, S, Hq, D) in
    q's dtype. ``skip_masked`` leaves out the blocks the causal mask
    hides wholly (src > me), as the kernel does: JAX folds them in with
    weight ``exp(−1e30 − m) = 0`` once step 0 has set a finite m, so the
    values are the same to the bit. ``return_lse``: also each query
    row's log-sum-exp ``m + log(max(l, 1e-30))``, (n, B, S, Hq) f32."""
    n, b, s, hq, d = q.shape
    hkv = k.shape[3]
    g = hq // hkv
    scale = _scale(d, scale)
    qg = q.reshape(n, b, s, hkv, g, d)
    dev = q.device
    me = torch.arange(n, device=dev)
    pos = torch.arange(s, device=dev)
    pos_q = me[:, None] * s + pos                              # (n, S)

    def block_mask(src):
        if not causal:
            return torch.ones((1, 1, 1, 1, 1, s), dtype=torch.bool,
                              device=dev)
        pos_k = src[:, None] * s + pos
        return (pos_q[:, :, None] >= pos_k[:, None, :])[:, None, :, None,
                                                        None, :]

    # step 0 peeled: the own block needs no rotation (JAX :102-104)
    acc = _block_attn(qg, k, v, scale, block_mask(me))
    k_blk, v_blk = k, v
    for i in range(1, n):
        k_blk, v_blk = cp_ring.kv_rotate_plain(k_blk), cp_ring.kv_rotate_plain(
            v_blk)
        src = (me - i) % n                                     # block owner
        new = _combine(acc, _block_attn(qg, k_blk, v_blk, scale,
                                        block_mask(src)))
        if skip_masked and causal:
            keep = (src > me).reshape(n, 1, 1, 1, 1, 1)
            new = tuple(torch.where(keep, a, c) for a, c in zip(acc, new))
        acc = new
    m, l, o = acc
    den = torch.clamp(l, min=1e-30)
    out = (o / den).reshape(n, b, s, hq, d).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(den)).reshape(n, b, s, hq)
    return out


def dense_attention_reference(q, k, v, *, causal: bool = True, scale=None):
    """Unsharded GQA attention (JAX ``:220``): q (B, S, Hq, D), k / v
    (B, S, Hkv, D) → (B, S, Hq, D) in q's dtype. The correctness
    baseline, and the local body of Ulysses (full sequence, local
    heads)."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = _scale(d, scale)
    qg = q.reshape(b, s, hkv, g, d)
    if causal:
        pos = torch.arange(s, device=q.device)
        mask = (pos[:, None] >= pos[None, :])[None, :, None, None, :]
    else:
        mask = torch.ones((1, 1, 1, 1, s), dtype=torch.bool, device=q.device)
    _, l, o = _block_attn(qg, k, v, scale, mask)
    return (o / torch.clamp(l, min=1e-30)).reshape(b, s, hq, d).to(q.dtype)


def ring_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                       scale=None):
    """The ring attention's backward on every rank at once, in torch ops
    (JAX differentiates its XLA body, ``:70``; it has no backward
    kernel): the softmax gradient of each source block from the saved q,
    k, v, out and each row's ``lse``. For the block of ``src = (me − i)
    mod n``: ``p = exp(s − lse)`` (0 where masked), ``dV += pᵀ dO``, ``dS
    = p (dO Vᵀ − rowsum(dO ∘ O))``, ``dQ += dS K · scale``, ``dK += dSᵀ Q
    · scale``, the K and V gradients carried back to the block's owner
    (the ring in the other direction). Returns (dq, dk, dv) in the
    inputs' dtypes."""
    n, b, s, hq, d = q.shape
    hkv = k.shape[3]
    g = hq // hkv
    scale = _scale(d, scale)
    dev = q.device
    qg = q.reshape(n, b, s, hkv, g, d).float()
    dog = dout.reshape(n, b, s, hkv, g, d).float()
    lg = lse.reshape(n, b, s, hkv, g, 1).float()
    dsum = (dog * out.reshape(n, b, s, hkv, g, d).float()).sum(-1,
                                                               keepdim=True)
    me = torch.arange(n, device=dev)
    pos = torch.arange(s, device=dev)
    pos_q = me[:, None] * s + pos
    dq = torch.zeros_like(qg)
    dk = torch.zeros((n, b, s, hkv, d), dtype=torch.float32, device=dev)
    dv = torch.zeros_like(dk)
    for i in range(n):
        k_blk = torch.roll(k, i, dims=0).float()
        v_blk = torch.roll(v, i, dims=0).float()
        sc = torch.einsum("nbqhgd,nbkhd->nbqhgk", qg, k_blk) * scale
        p = torch.exp(sc - lg)
        if causal:
            pos_k = ((me - i) % n)[:, None] * s + pos
            keep = (pos_q[:, :, None] >= pos_k[:, None, :])[:, None, :, None,
                                                             None, :]
            p = torch.where(keep, p, torch.zeros_like(p))
        del sc
        dv_blk = torch.einsum("nbqhgk,nbqhgd->nbkhd", p, dog)
        ds = p * (torch.einsum("nbqhgd,nbkhd->nbqhgk", dog, v_blk) - dsum)
        del p
        dq += torch.einsum("nbqhgk,nbkhd->nbqhgd", ds, k_blk) * scale
        dk_blk = torch.einsum("nbqhgk,nbqhgd->nbkhd", ds, qg) * scale
        dk += torch.roll(dk_blk, -i, dims=0)
        dv += torch.roll(dv_blk, -i, dims=0)
    return (dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


class _RingAttention(torch.autograd.Function):
    """Ring attention with its backward: the forward on the kernel (or the
    plain version on the CPU), saving each row's lse; the backward
    :func:`ring_attention_bwd`."""

    @staticmethod
    def forward(fctx, q, k, v, causal):
        if q.device.type == "cpu":
            out, lse = ring_attention_plain(q, k, v, causal=causal,
                                            return_lse=True)
        else:
            out, lse = cp_ring.ring_attention_launch(
                q, k, v, causal=causal, scale=_scale(q.shape[-1], None),
                lse=True)
        fctx.causal = causal
        fctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(fctx, dout):
        q, k, v, out, lse = fctx.saved_tensors
        return (*ring_attention_bwd(q, k, v, out, lse, dout,
                                    causal=fctx.causal), None)


def _grad_wanted(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _ring_attn(q, k, v, causal):
    """The ring's forward, differentiable where a gradient is wanted."""
    if _grad_wanted(q, k, v):
        return _RingAttention.apply(q, k, v, causal)
    if q.device.type == "cpu":
        return ring_attention_plain(q, k, v, causal=causal)
    return cp_ring.ring_attention_launch(q, k, v, causal=causal,
                                         scale=_scale(q.shape[-1], None))


_OTHER = {"scatter": "gather", "gather": "scatter"}


class _UlyssesA2A(torch.autograd.Function):
    """The Ulysses all-to-all; its backward is the all-to-all in the other
    direction, on the kernel."""

    @staticmethod
    def forward(fctx, x, direction):
        fctx.direction = direction
        return cp_ring.ulysses_a2a(x, direction)

    @staticmethod
    def backward(fctx, g):
        if g.stride(4) != 1 or g.stride(3) != g.shape[4]:
            g = g.contiguous()
        return cp_ring.ulysses_a2a(g, _OTHER[fctx.direction]), None


def _a2a(x, direction):
    if _grad_wanted(x):
        return _UlyssesA2A.apply(x, direction)
    return cp_ring.ulysses_a2a(x, direction)


def _ranks(q, mesh, axis):
    n = mesh.axis_size(axis)
    if q.dim() != 5 or q.shape[0] != n:
        raise ValueError(f"q must stack the {n} ranks' blocks of {axis!r} "
                         f"as (n, B, S, H, D), got {tuple(q.shape)}")
    return n


def ring_attention(q, k, v, mesh, axis: str = "tp", *, causal: bool = True):
    """Ring attention over ``axis`` of ``mesh`` (JAX ``:202``) on the
    stacked blocks of the module docstring. CPU tensors: the plain
    version; CUDA tensors: one ``tdt_ring_attention`` launch for every
    rank."""
    _ranks(q, mesh, axis)
    return _ring_attn(q, k, v, causal)


def ulysses_attention(q, k, v, mesh, axis: str = "tp", *,
                      causal: bool = True):
    """Ulysses attention over ``axis`` of ``mesh`` (JAX ``:211``) on the
    stacked blocks of the module docstring. Needs Hq % n == 0, and
    Hkv % n == 0 or n % Hkv == 0 (KV heads replicated); raises
    ``ValueError`` otherwise. CPU tensors: the plain layouts and
    :func:`dense_attention_reference`; CUDA tensors: ``tdt_ulysses_a2a``
    for q, k and v, one ``tdt_ring_attention`` launch on a ring of one
    block for every rank's local heads, ``tdt_ulysses_a2a`` back."""
    n = _ranks(q, mesh, axis)
    hq, hkv = q.shape[3], k.shape[3]
    if hq % n:
        raise ValueError(f"Ulysses needs Hq % cp == 0, got {hq} % {n}")
    if hkv % n:
        if n % hkv:
            raise ValueError(f"Ulysses needs Hkv % cp == 0 or cp % Hkv == 0,"
                             f" got Hkv {hkv} at cp {n}")
        # GQA with fewer KV heads than ranks: replicate each KV head so
        # every rank gets a whole one (JAX :135-143)
        k = k.repeat_interleave(n // hkv, dim=3)
        v = v.repeat_interleave(n // hkv, dim=3)
    qs, ks, vs = (_a2a(t, "scatter") for t in (q, k, v))
    _, b, s, hl, d = qs.shape
    flat = [t.reshape(1, n * b, s, t.shape[3], d) for t in (qs, ks, vs)]
    o = _ring_attn(*flat, causal)[0]
    return _a2a(o.reshape(n, b, s, hl, d), "gather")
