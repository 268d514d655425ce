"""MoE tensor-parallel overlap ops: AG-GroupGEMM and GroupGEMM-Reduce-RS.

Port of the overlapped (inference) pipeline of
``triton_distributed_tpu/ops/moe_tp.py``: per-shard routing
(:func:`align_routing_sharded`), the up projection over the gathered
expert-sorted rows (:func:`ag_group_gemm_fused`), the down projection
into the reduce and the per-rank top-k combine
(:func:`moe_reduce_rs_fused`), and the whole MLP
(:func:`moe_tp_mlp_overlapped`), each op one launch of a kernel of
:mod:`~triton_distributed_tpu_torch.kernels.moe_tp_fused`.

Without a mesh one GPU holds every expert's full F (``tp == 1``): the
gather and the reduce are the identity. With one (``mesh=``) the F dim
of the experts is split over its axis (``w_up`` (E, H, F/tp) and
``w_down`` (E, F/tp, H) a rank) and the token rows too (row block s of
x is shard s): each shard aligns its own rows (the ``(tp, cap_s)``
tables), the up projection gives every rank all shards' sorted rows
against its F columns, and the reduce gives rank r the sum over ranks
of its own sorted rows, which it combines into its token rows.

The quantized ring wires (``MoETPContext.wire_dtype``, JAX ``:71-82``):
'fp8' / 'int8' ship each shard's sorted token slab once as 1-byte codes
with a scale a chunk of rows (each rank consumes its own slab exact) and
every reduce hop's running partial requantized; 'int8-mxu' ends the AG
wire at the tensor cores (every slab's int8 codes, the own one too,
against the experts' per-(expert, column) int8 weights, quantized on
every call as JAX does) and carries its int8 payload on the reduce side.
An explicit opt-in, as in JAX: no 'auto'. Without a mesh the rings have
one rank (``kernels/ring.py:141-145``, ``:269-271``): fp8 and int8
consume the own slab exact, so they equal the bf16 wire, int8-mxu still
runs its own slab's codes through the s8 kernel, and the reduce has no
hop. Each op launches the kernels of
:mod:`~triton_distributed_tpu_torch.kernels.moe_tp_fused`'s wires.

The composed pipeline (JAX ``:98-211``, ``:412-470``), forward only
(the port's grouped GEMM has no backward yet: the rest of ROADMAP Queue
1 step 9b):

* :func:`align_routing`: one alignment over every token (replicated);
* :func:`ag_group_gemm`: the tokens' all-gather, on the single
  controller the (M, K) tensor itself (JAX's ``lax.all_gather``), then
  each rank's grouped GEMM over the sorted rows against its F columns
  (:func:`ag_group_gemm_device`);
* :func:`moe_reduce_rs`: each rank's down projection, its top-k combine
  into token rows (``scatter_combine``), rounded to ``ctx.dtype``, then
  :func:`~triton_distributed_tpu_torch.kernels.reduce_scatter.
  reduce_scatter` of the stacked partials, which sums them in the ring's
  order, rounding each hop as the TPU's ring does;
* :func:`moe_tp_mlp` (JAX's ``MoETPMLP(fused=True)`` body): one sort,
  both grouped GEMMs a rank, the combine, and ``psum_scatter`` as a plain
  f32 sum of the ranks' partials, rounded once.

DP axes beside ``axis`` (``batch_axes``) are refused (ROADMAP Queue 1
step 8).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from triton_distributed_tpu_torch.config import to_torch_dtype
from triton_distributed_tpu_torch.kernels import moe_tp_fused as mtf
from triton_distributed_tpu_torch.kernels import moe_utils as mu
from triton_distributed_tpu_torch.kernels.group_gemm import grouped_matmul
from triton_distributed_tpu_torch.kernels.reduce_scatter import reduce_scatter
from triton_distributed_tpu_torch.lang import wire as wirelib
from triton_distributed_tpu_torch.lang.shmem import require_stacked
from triton_distributed_tpu_torch.runtime.topology import Mesh, one_axis


@dataclass(frozen=True)
class MoETPContext:
    """Static geometry of the MoE-TP pipeline: the experts, the top-k,
    the routing ``block_m`` (128 as in JAX; a multiple of the CUDA
    kernels' 64-row tile), the compute dtype, the ``mesh`` whose
    ``axis`` splits F (None: ``tp == 1``), and the overlapped rings'
    ``wire_dtype`` (None / 'bf16', 'fp8', 'int8', 'int8-mxu'; see the
    module docstring). ``use_pallas_gemm`` (True: the grouped-GEMM
    kernel), ``rs_collective_id`` / ``ag_collective_id`` (JAX's
    semaphore ids; the pull kernels wait on none) and ``batch_axes``
    (``()``) keep JAX's fields."""

    num_experts: int
    topk: int
    block_m: int = 128
    dtype: torch.dtype = torch.bfloat16
    mesh: Mesh | None = None
    axis: str = "tp"
    wire_dtype: str | None = None
    use_pallas_gemm: bool = True
    rs_collective_id: int = 12
    ag_collective_id: int = 13
    batch_axes: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "dtype", to_torch_dtype(self.dtype))
        if not self.use_pallas_gemm:
            raise NotImplementedError(
                "MoETPContext(use_pallas_gemm=False) picks JAX's ragged_dot "
                "twin; the port's grouped GEMM is its kernel (its plain "
                "version runs on CPU tensors)")
        if tuple(self.batch_axes):
            raise NotImplementedError(
                f"MoETPContext(batch_axes={self.batch_axes!r}): DP axes "
                "beside the TP axis are ROADMAP Queue 1 step 8 (dp_axes)")
        wire = wirelib.normalize_wire(self.wire_dtype)
        if wire == "auto":
            raise ValueError(
                "MoETPContext: wire_dtype='auto' is not a MoE-TP wire (an "
                "explicit opt-in, as in JAX); pass 'fp8', 'int8', "
                "'int8-mxu' or None")
        object.__setattr__(self, "wire_dtype", wire)

    @property
    def tp(self) -> int:
        return 1 if self.mesh is None else one_axis(self.mesh, self.axis)


def create_ag_group_gemm_context(*, num_experts, topk, **kw) -> MoETPContext:
    """The context of both overlapped engines (JAX builds one for each
    with the same fields)."""
    return MoETPContext(num_experts=num_experts, topk=topk, **kw)


create_moe_rs_context = create_ag_group_gemm_context


@dataclass(frozen=True)
class ShardedRouting:
    """The shards' routing tables, each shard's tokens in expert-sorted
    order: over a mesh stacked ``(tp, ...)`` as JAX stacks them; without
    one the one shard's, unstacked."""

    sti: torch.Tensor       # ([tp,] cap_s) sorted token ids, M_s·k at padding
    be: torch.Tensor        # ([tp,] cap_s / block_m) block → expert
    splits: torch.Tensor    # ([tp,] E) true per-expert counts

    @property
    def cap_s(self) -> int:
        return self.sti.shape[-1]


def align_routing_sharded(ctx: MoETPContext, topk_ids) -> ShardedRouting:
    """``moe_align_block_size`` of the (M, k) ``topk_ids`` at
    ``ctx.block_m``, each shard's rows [s·M/tp, (s+1)·M/tp) on its own
    (JAX's per-shard tables; one pass for all shards)."""
    if ctx.mesh is None:
        sti, be, splits = mu.moe_align_block_size(
            topk_ids, ctx.num_experts, ctx.block_m)
        return ShardedRouting(sti=sti, be=be, splits=splits)
    m, k = topk_ids.shape
    if m % ctx.tp:
        raise ValueError(f"{m} token rows do not shard over tp = {ctx.tp}")
    sti, be, splits = mu.moe_align_block_size(
        topk_ids.reshape(ctx.tp, m // ctx.tp, k), ctx.num_experts,
        ctx.block_m)
    return ShardedRouting(sti=sti, be=be, splits=splits)


def _check_blocks(ctx: MoETPContext, cap_s: int):
    if mtf.pick_gg_blocks(ctx.block_m, cap_s) is None:
        raise ValueError(
            f"overlapped MoE-TP: {cap_s} sorted rows do not split into "
            f"block_m={ctx.block_m} blocks")


def ag_group_gemm_fused(x, routing: ShardedRouting, w, ctx: MoETPContext):
    """AG ⊕ up-projection grouped GEMM: x (M, K) tokens, w (E, K, N) →
    (cap_s, N) sorted rows in ``ctx.dtype`` (zeros at the padding). Over
    a mesh x's row block s is shard s and w is a list of tp column
    shards (E, K, N/tp) → a list of tp (tp·cap_s, N/tp) outputs, rank
    r's every shard's sorted rows against its columns. x and w are cast
    to ``ctx.dtype`` as JAX casts the slab; on the int8-mxu wire w is
    quantized as given, as JAX quantizes it. ``ctx.wire_dtype`` picks the
    wire (module docstring)."""
    _check_blocks(ctx, routing.cap_s)
    dt, wire = ctx.dtype, ctx.wire_dtype
    fmt = mtf._wire_fmt(wire, routing.cap_s, ctx.block_m)
    if ctx.mesh is None:
        if wire == "int8-mxu":
            q, s = mtf.quantize_sorted([x.to(dt)], routing.sti[None],
                                       ctx.topk, fmt)[:2]
            wq, ws = mtf.quantize_expert_shards([w])
            return mtf.ag_group_gemm_mx(q[0], s[0], routing.be, wq[0], ws[0],
                                        out_dtype=dt)
        # fp8 / int8 at one rank: the own slab is consumed exact
        return mtf.ag_group_gemm(x.to(dt).contiguous(), routing.sti,
                                 routing.be, w.to(dt), ctx.topk,
                                 out_dtype=dt)
    xs = list(x.to(dt).contiguous().chunk(ctx.tp))
    if wire is None:
        return mtf.ag_group_gemm_mesh(
            xs, routing.sti, routing.be, [t.to(dt) for t in w], ctx.topk,
            ctx.mesh, ctx.axis, out_dtype=dt)
    if wire == "int8-mxu":
        q, s = mtf.quantize_sorted(xs, routing.sti, ctx.topk, fmt)[:2]
        wq, ws = mtf.quantize_expert_shards(w)
        return mtf.ag_group_gemm_mesh_mx(q, s, routing.be, wq, ws, ctx.mesh,
                                         ctx.axis, out_dtype=dt)
    # the sorted slabs stay alive into the AG kernel, which reads its own
    # rows from them
    q, s, slabs = mtf.quantize_sorted(xs, routing.sti, ctx.topk, fmt)
    return mtf.ag_group_gemm_mesh_w(
        xs, q, s, routing.sti, routing.be, [t.to(dt) for t in w], ctx.topk,
        ctx.mesh, fmt, ctx.axis, out_dtype=dt, slabs=slabs)


def moe_reduce_rs_fused(y, routing: ShardedRouting, weights, w,
                        ctx: MoETPContext):
    """Down-projection grouped GEMM ⊕ reduce, then the top-k combine:
    y (cap_s, F) sorted post-activation rows, weights (M, k) router
    weights, w (E, F, H) → (M, H) in ``ctx.dtype``. Over a mesh y and w
    are lists of tp shards ((tp·cap_s, F/tp) and (E, F/tp, H)); rank r
    sums its rows over the ranks and combines them into its token rows,
    row block r of the result. On a wire the reduce ring's hops carry
    its payload ('int8-mxu': int8)."""
    _check_blocks(ctx, routing.cap_s)
    dt = ctx.dtype
    fmt = mtf._wire_fmt(wirelib.wire_payload(ctx.wire_dtype), routing.cap_s)
    if ctx.mesh is None:
        if y.shape[0] != routing.cap_s:
            raise ValueError(f"y has {y.shape[0]} rows, the routing "
                             f"{routing.cap_s}")
        red = mtf.moe_reduce_rs(y.to(dt).contiguous(), routing.be, w.to(dt),
                                out_dtype=dt)
        out = mu.scatter_combine(red, routing.sti, weights, weights.shape[0])
        return out.to(dt)
    if y[0].shape[0] != ctx.tp * routing.cap_s:
        raise ValueError(f"y has {y[0].shape[0]} rows a rank, the routing "
                         f"{ctx.tp} x {routing.cap_s}")
    ys, ws = [t.to(dt) for t in y], [t.to(dt) for t in w]
    if fmt is None:
        red = mtf.moe_reduce_rs_mesh(ys, routing.be, ws, ctx.mesh, ctx.axis,
                                     out_dtype=dt)
    else:
        red = mtf.moe_reduce_rs_mesh_w(ys, routing.be, ws, ctx.mesh, fmt,
                                       ctx.axis, out_dtype=dt)
    # every rank combines its own sorted rows into its token rows
    out = mu.scatter_combine(
        require_stacked(red, "the reduce's output"), routing.sti,
        weights.reshape(ctx.tp, -1, weights.shape[-1]),
        weights.shape[0] // ctx.tp)
    return out.reshape(weights.shape[0], -1).to(dt)


def moe_tp_mlp_overlapped(x, topk_ids, topk_weights, w_up, w_down,
                          ctx: MoETPContext, activation: str = "silu"):
    """The overlapped TP MoE MLP: AG ⊕ up grouped GEMM → activation (in
    f32, cast to ``ctx.dtype``) → down grouped GEMM ⊕ reduce → top-k
    combine. x (M, H), topk_ids / topk_weights (M, k), w_up (E, H, F),
    w_down (E, F, H) → (M, H) in ``ctx.dtype``; over a mesh w_up and
    w_down are lists of tp F shards and row block r of x and of the
    result is rank r's. Both rings ride ``ctx.wire_dtype``."""
    from triton_distributed_tpu_torch.ops.moe import _act

    routing = align_routing_sharded(ctx, topk_ids)
    h = ag_group_gemm_fused(x, routing, w_up, ctx)
    if ctx.mesh is None:
        h = _act(activation, h.float()).to(ctx.dtype)
    else:
        # every rank's activation at once, on the stacked output
        hs = _act(activation, require_stacked(h, "the up projection's "
                                             "output").float()).to(ctx.dtype)
        h = list(hs.unbind(0))
    return moe_reduce_rs_fused(h, routing, topk_weights, w_down, ctx)


# ------------------------------------------------------ the composed path

def align_routing(ctx: MoETPContext, topk_ids):
    """(sorted token ids (cap,), block → expert (cap / block_m,), counts
    (E,)) of every token's (M, k) ``topk_ids`` (JAX ``:116``): one
    alignment, shared by :func:`ag_group_gemm` and :func:`moe_reduce_rs`."""
    return mu.moe_align_block_size(topk_ids, ctx.num_experts, ctx.block_m)


def _ranks(t, ctx: MoETPContext, what: str):
    """A rank-split operand as a list of ``ctx.tp`` tensors."""
    if ctx.mesh is None:
        return [t]
    if not isinstance(t, (list, tuple)) or len(t) != ctx.tp:
        raise ValueError(f"{what} takes a list of {ctx.tp} per-rank shards "
                         "over the mesh")
    return list(t)


def ag_group_gemm_device(a_full, sti, be, counts, w_loc, ctx: MoETPContext):
    """One rank's body after the gather (JAX ``:128``): the (M, K)
    tokens' rows in expert-sorted order (zeros at the padding) times the
    rank's (E, K, N_r) expert columns → (cap, N_r) in ``ctx.dtype``."""
    del counts
    xs = mu.gather_sorted(a_full, sti, ctx.topk).to(ctx.dtype)
    return grouped_matmul(xs, w_loc.to(ctx.dtype), be)


def ag_group_gemm(a, routing, w, ctx: MoETPContext):
    """The composed AG ⊕ up projection (JAX ``:149``): a (M, K) tokens,
    row block r rank r's (gathered: every rank reads all of them), the
    :func:`align_routing` triple, w (E, K, N) or over a mesh a list of
    tp column shards (E, K, N/tp) → (cap, N) or a list of tp (cap, N/tp)
    sorted rows."""
    sti, be, counts = routing
    out = [ag_group_gemm_device(a, sti, be, counts, wr, ctx)
           for wr in _ranks(w, ctx, "ag_group_gemm")]
    return out[0] if ctx.mesh is None else out


def moe_reduce_rs(y, routing, weights, w, ctx: MoETPContext):
    """The composed down projection ⊕ reduce-scatter (JAX ``:165``,
    ``:183-211``): y (cap, F) sorted rows, or a list of tp (cap, F/tp);
    the :func:`align_routing` triple; weights (M, k) router weights; w
    (E, F, H) or a list of tp row shards (E, F/tp, H) → (M, H) token rows
    in ``ctx.dtype``, over a mesh row block r summed over the ranks for
    rank r (the ranks' combined partials, each rounded to ``ctx.dtype``,
    through :func:`reduce_scatter` with ``stacked=True``)."""
    sti, be, _ = routing
    m = weights.shape[0]
    ys, ws = _ranks(y, ctx, "moe_reduce_rs"), _ranks(w, ctx, "moe_reduce_rs")
    parts = None
    for r, (yr, wr) in enumerate(zip(ys, ws)):
        part = grouped_matmul(yr.to(ctx.dtype), wr.to(ctx.dtype), be)
        tok = mu.scatter_combine(part, sti, weights, m)
        if parts is None:
            parts = torch.empty((len(ys), m, tok.shape[-1]), dtype=ctx.dtype,
                                device=tok.device)
        parts[r] = tok
    if ctx.mesh is None:
        return parts[0]
    out = reduce_scatter(list(parts.unbind(0)), ctx.mesh, ctx.axis,
                         stacked=True, collective_id=ctx.rs_collective_id)
    return torch.cat(out)


def moe_tp_mlp_device(x_full, ids, weights, w_up_loc, w_down_loc,
                      ctx: MoETPContext, activation: str = "silu"):
    """One rank's body after the gathers (JAX ``:412``): sort every token
    once, the rank's up projection, the activation (in ``ctx.dtype``),
    its down projection and the top-k combine → the rank's (M, H) f32
    partial, before the reduce-scatter."""
    from triton_distributed_tpu_torch.ops.moe import _act

    sti, be, _ = mu.moe_align_block_size(ids, ctx.num_experts, ctx.block_m)
    xs = mu.gather_sorted(x_full, sti, ctx.topk).to(ctx.dtype)
    h = _act(activation, grouped_matmul(xs, w_up_loc.to(ctx.dtype), be))
    part = grouped_matmul(h.to(ctx.dtype), w_down_loc.to(ctx.dtype), be)
    return mu.scatter_combine(part, sti, weights, x_full.shape[0])


def moe_tp_mlp(x, topk_ids, topk_weights, w_up, w_down, ctx: MoETPContext,
               activation: str = "silu"):
    """The single-body TP MoE MLP (JAX ``:459``, ``MoETPMLP(fused=True)``):
    x (M, K), topk_ids / topk_weights (M, k), w_up (E, K, F) / w_down
    (E, F, H), over a mesh lists of tp F shards → (M, H) in
    ``ctx.dtype``. Each rank's f32 partial (:func:`moe_tp_mlp_device`);
    the ``psum_scatter`` is their f32 sum, cut into the ranks' row blocks
    and rounded once."""
    ups = _ranks(w_up, ctx, "moe_tp_mlp")
    downs = _ranks(w_down, ctx, "moe_tp_mlp")
    acc = None
    for wu, wd in zip(ups, downs):
        part = moe_tp_mlp_device(x, topk_ids, topk_weights, wu, wd, ctx,
                                 activation)
        acc = part if acc is None else acc + part
    return acc.to(ctx.dtype)
