"""Expert-parallel MoE MLP: route → dispatch → grouped GEMMs → combine.

Port of ``triton_distributed_tpu/ops/moe.py`` on the fused
(count-bounded chunked) transport only: route with
:func:`~triton_distributed_tpu_torch.kernels.moe_utils.select_experts`,
expert-sort the assignments, stage them into aligned segments in the
wire dtype, dispatch them through the chunked all-to-all kernel, run the
grouped expert MLP (W8A8, W8A16 or float grouped-GEMM kernels), stage
the results back, combine through the same kernel, and sum each token's
top-k results weighted by the router.

Without a mesh one rank owns every expert. With one (``mesh=``) the
experts are split over its axis, rank r owning experts [r·epr,
(r+1)·epr), and the tokens too, rank r owning row block r; the port is
single-controller, so one call stages, routes and combines every rank's
rows as stacked tensors (one op a step for all ranks), the all-to-all
is one launch for all ranks, and the expert MLP is one grouped GEMM in
which each rank's rows meet only its own experts.

In barrier mode every call allocates its receive windows; with an
:class:`EPMoEState` the two legs write the state's persistent
double-buffered workspaces in place, in the window its device-side
parity names, and the call returns the state with the parity flipped.
Nothing reads a value back to the host.

JAX's full-precision ``xla`` transport (``lax.all_to_all`` of padded
slots) carries the same rows to the same experts, so a context with no
wire quantization and no W8A8, on float experts, gives its values (the
model's prefill runs so). Not ported: the hierarchical (DCN) exchange,
the padded-slot (``pallas``) and ``xla`` transports, ``ep_moe_tuned``
and the demotion probe of the health ledger.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from triton_distributed_tpu_torch.config import to_torch_dtype
from triton_distributed_tpu_torch.kernels import moe_all_to_all as ma
from triton_distributed_tpu_torch.kernels import moe_dispatch as md
from triton_distributed_tpu_torch.kernels import moe_utils as mu
from triton_distributed_tpu_torch.kernels.group_gemm import (
    grouped_matmul,
    quantize_act_rows,
)
from triton_distributed_tpu_torch.runtime.topology import Mesh, one_axis


@dataclass(frozen=True)
class EPMoEContext:
    """Static geometry of the EP MoE layer on the fused transport. The
    experts are split over ``mesh``'s ``axis`` (``n`` ranks); without a
    mesh one rank owns every expert. ``max_m`` is a rank's assignment
    capacity (M·topk for its M tokens); ``block_m`` the grouped-GEMM
    M-block (a multiple of the CUDA kernels' 64-row tile); ``quant`` the
    wire format (None, "fp8" or "int8"); ``act_quant="int8"`` runs the
    experts W8A8 when their weights are int8 dicts."""

    num_experts: int
    topk: int
    max_m: int
    hidden: int
    dtype: torch.dtype = torch.bfloat16
    activation: str = "silu"        # silu | gelu | none
    block_m: int = 64
    quant: str | None = None
    act_quant: str | None = None
    mesh: Mesh | None = None
    axis: str = "tp"

    def __post_init__(self):
        object.__setattr__(self, "dtype", to_torch_dtype(self.dtype))

    @property
    def n(self) -> int:
        """EP ranks: the mesh axis' size, 1 without a mesh."""
        return 1 if self.mesh is None else one_axis(self.mesh, self.axis)

    @property
    def experts_per_rank(self) -> int:
        return self.num_experts // self.n

    @property
    def a2a(self) -> ma.MoEAllToAllContext:
        return ma.MoEAllToAllContext(
            n=self.n, max_m=self.max_m, hidden=self.hidden,
            experts_per_rank=self.experts_per_rank, dtype=self.dtype,
            quant=self.quant, mesh=self.mesh, axis=self.axis)


def create_ep_moe_context(*, num_experts, topk, max_m, hidden,
                          **kw) -> EPMoEContext:
    """An :class:`EPMoEContext`, validated as the JAX package validates
    it (for the fused transport). ``mesh=`` / ``axis=`` split the experts
    over the mesh's axis."""
    ctx = EPMoEContext(num_experts=num_experts, topk=topk, max_m=max_m,
                       hidden=hidden, **kw)
    if num_experts % ctx.n:
        raise ValueError(f"{num_experts} experts do not split over "
                         f"{ctx.n} ranks")
    if ctx.act_quant not in (None, "int8"):
        raise ValueError(
            f"act_quant must be None or 'int8', got {ctx.act_quant!r}")
    if ctx.activation not in ("silu", "gelu", "none"):
        raise ValueError(f"unknown activation {ctx.activation!r}")
    if ctx.block_m <= 0:
        raise ValueError(f"block_m must be positive, got {ctx.block_m}")
    ctx.a2a  # noqa: B018 — fail fast on a bad quant / hidden geometry
    return ctx


@dataclass
class EPMoEState:
    """Persistent workspaces of the barrier-free (LL) transport: the
    double-buffered receive windows of both legs and the parity (a (1,)
    int32 device tensor, shared by the ranks) naming the window the next
    call writes. Over a mesh each window is a symmetric tensor, the
    ranks' windows stacked on a leading dim. The kernels write the
    windows in place; thread the returned state into the next call."""

    parity: torch.Tensor
    disp_tok: torch.Tensor
    disp_meta: torch.Tensor
    comb_tok: torch.Tensor
    comb_meta: torch.Tensor


def create_ep_moe_state(ctx: EPMoEContext, device=None) -> EPMoEState:
    """Zeroed LL workspaces for ``ctx`` on ``device`` (over a mesh: the
    mesh's device, one window pair a rank, as symmetric tensors)."""
    from triton_distributed_tpu_torch.lang.shmem import stacked, symm_empty

    (tok_shape, tok_dt), (meta_shape, meta_dt) = md.ll_workspace_shapes(
        ctx.a2a)
    if ctx.mesh is not None:
        device = ctx.mesh.device

    def ws(shape, dt):
        if ctx.mesh is None:
            return torch.zeros(shape, dtype=dt, device=device)
        return stacked(symm_empty(ctx.mesh, shape, dt).shards).zero_()

    return EPMoEState(
        parity=torch.zeros((1,), dtype=torch.int32, device=device),
        disp_tok=ws(tok_shape, tok_dt), disp_meta=ws(meta_shape, meta_dt),
        comb_tok=ws(tok_shape, tok_dt), comb_meta=ws(meta_shape, meta_dt),
    )


def _act(name: str, x):
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        return F.gelu(x, approximate="tanh")       # jax.nn.gelu's default
    return x


def _zero(t):
    return torch.zeros((), dtype=t.dtype, device=t.device)


def sort_rows(ctx: EPMoEContext, rows, eid, valid, groups=None):
    """The grouped GEMMs' input: rows sorted by expert into
    ``block_m``-aligned segments → ((cap, H) ``ctx.dtype`` rows, (cap //
    block_m,) int32 expert per block, (cap,) source row per position,
    the sentinel R at padding). ``eid`` (R,) indexes ``groups`` experts
    (default: a rank's own). Invalid rows are zeroed and sorted into a
    trailing dummy group, whose blocks read the last expert's weights
    (their rows are zero, so is the product)."""
    groups = groups or ctx.experts_per_rank
    r = rows.shape[0]
    ids = torch.where(valid, eid, groups).to(torch.int32)[:, None]
    sti, be, _ = mu.moe_align_block_size(ids, groups + 1, ctx.block_m)
    safe = torch.clamp(sti, 0, r - 1).long()
    ok = ((sti < r) & valid[safe])[:, None]
    xs = torch.where(ok, rows[safe], _zero(rows)).to(ctx.dtype)
    return xs, torch.clamp(be, 0, groups - 1), sti


def whole_experts(w):
    """An expert leaf as one tensor over every expert: a (E, ...) tensor
    as it is, a list of W per-rank (E/W, ...) shards (views of one
    allocation) as their (E, ...) view; int8 dicts leaf by leaf."""
    from triton_distributed_tpu_torch.lang.shmem import require_stacked

    if isinstance(w, dict):
        return {k: whole_experts(v) for k, v in w.items()}
    if isinstance(w, (list, tuple)):
        st = require_stacked(list(w), "the expert-parallel MoE's experts")
        return st.reshape(-1, *st.shape[2:])
    return w


def _expert_mlp(ctx: EPMoEContext, rows, eid, valid, w_up, w_down):
    """Grouped MLP of every rank over its own experts, in one pass.

    rows: (W, R, H) received rows of the W ranks; eid: (W, R) local
    expert ids; valid: (W, R) bool; invalid rows come out as zeros
    (:func:`sort_rows`). Rank r's local expert j is global expert
    r·epr + j, so one grouped GEMM serves all ranks and each rank's
    rows meet only its own experts. ``w_up`` (E, H, F) / ``w_down`` (E,
    F, H) hold every rank's experts (:func:`whole_experts`): float
    tensors in ``ctx.dtype`` or int8 ``{"q", "scale"}`` dicts: W8A8 when
    both are and ``ctx.act_quant`` is "int8" (the hidden activation
    re-quantized per row after the nonlinearity), else W8A16 for a dict
    and the float mode for a tensor. Returns (W, R, H)."""
    nw, r0, hid = rows.shape
    epr = ctx.experts_per_rank
    eid = eid + epr * torch.arange(nw, device=eid.device)[:, None]
    rows, eid, valid = (rows.reshape(nw * r0, hid), eid.reshape(-1),
                        valid.reshape(-1))
    r = rows.shape[0]
    xs, be_w, sti = sort_rows(ctx, rows, eid, valid, groups=nw * epr)
    cap = sti.shape[0]

    def gg(inp, w):
        if isinstance(w, dict):
            return grouped_matmul(inp, w["q"], be_w, w_scale=w["scale"])
        return grouped_matmul(inp, w, be_w)

    if (ctx.act_quant == "int8" and isinstance(w_up, dict)
            and isinstance(w_down, dict) and w_up["q"].dtype == torch.int8
            and w_down["q"].dtype == torch.int8):
        def gg8(q_in, s_in, w):
            return grouped_matmul(q_in, w["q"], be_w, w_scale=w["scale"],
                                  x_scale=s_in, out_dtype=ctx.dtype)

        xq, xsc = quantize_act_rows(xs)
        h = _act(ctx.activation, gg8(xq, xsc, w_up))
        hq, hsc = quantize_act_rows(h)
        y = gg8(hq, hsc, w_down)
    else:
        h = _act(ctx.activation, gg(xs, w_up)).to(ctx.dtype)
        y = gg(h, w_down)
    # un-sort by the inverse permutation: every received row appears
    # once in sti; padding (the sentinel r) lands in the dropped slot
    inv = torch.zeros((r + 1,), dtype=torch.int64, device=rows.device)
    inv.scatter_(0, sti.long(), torch.arange(cap, device=rows.device))
    return y[inv[:r]].reshape(nw, r0, -1)


def _slot_tables(ctx: EPMoEContext, rspl, slot_m: int):
    """(eid, valid), each (..., n·slot_m), for the receive slots from the
    clamped per-expert counts (..., n, epr)."""
    lead = rspl.shape[:-1]
    pos = torch.arange(slot_m, dtype=torch.int64, device=rspl.device)
    cum = torch.cumsum(rspl, dim=-1, dtype=torch.int64)     # (..., n, epr)
    rel = pos.expand(*lead, slot_m).contiguous()
    eid = torch.searchsorted(cum, rel, right=True)
    eid = torch.clamp(eid, 0, ctx.experts_per_rank - 1)
    valid = (rel >= 0) & (rel < cum[..., -1:])
    return eid.reshape(*lead[:-1], -1), valid.reshape(*lead[:-1], -1)


def _ep_assignments_device(ctx: EPMoEContext, x, flat_e, w_flat, out_rows,
                           w_up, w_down, state=None):
    """Pre-routed assignments of every rank → dispatch → grouped MLP →
    combine → weighted sum (the fused transport).

    x: (W, R, H) rows of the W = ``ctx.n`` ranks; flat_e: (W, T) expert
    per assignment (T = R·topk; the sentinel ``num_experts`` masks one);
    w_flat: (W, T) f32 weights, 0 for masked assignments; w_up / w_down:
    every rank's experts (:func:`whole_experts`). Returns (W, out_rows,
    H) f32, and the next :class:`EPMoEState` when ``state`` is given."""
    nw, total = flat_e.shape
    if ctx.max_m < total:
        raise ValueError(
            f"ep_moe: max_m={ctx.max_m} < M·topk={total}; the fused "
            "transport needs full-assignment capacity")
    dev = x.device
    a2a = ctx.a2a
    flat_e = flat_e.to(torch.int32)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    valid_a = flat_e < ctx.num_experts
    n_valid = valid_a.sum(dim=-1, dtype=torch.int32)             # (W,)
    splits = torch.zeros((nw, ctx.num_experts), dtype=torch.int32,
                         device=dev)
    splits.scatter_add_(
        1, torch.clamp(flat_e, 0, ctx.num_experts - 1).long(),
        valid_a.to(torch.int32))

    _, offs, offs_al, sendk = md.send_plan(a2a, splits)
    peer, dest = md.assignment_dest(a2a, flat_e.gather(1, order), offs,
                                    offs_al)
    payload, scales = md.stage_aligned(a2a, x, order // ctx.topk, dest,
                                       n_valid)
    meta = md.meta_payload(a2a, splits, scales, offs_al, sendk)
    if state is None:
        recv_tok, recv_meta = md.dispatch_device(a2a, payload, offs_al,
                                                 sendk, meta)
    else:
        md.dispatch_ll_device(a2a, payload, offs_al, sendk, meta,
                              state.parity, state.disp_tok, state.disp_meta)
        recv_tok, recv_meta = md.ll_window(a2a, state.disp_tok,
                                           state.disp_meta, state.parity)
    toks, rspl = md.recv_view(a2a, recv_tok, recv_meta)

    slot_m = md.slot_pad(a2a)
    eid, valid = _slot_tables(ctx, rspl, slot_m)
    y = _expert_mlp(ctx, toks.reshape(nw, ctx.n * slot_m, ctx.hidden), eid,
                    valid, w_up, w_down)
    # return leg: slot p goes back whole to source p, the same chunks
    y_tok, y_meta = md.stage_return(a2a, y.reshape(nw, ctx.n, slot_m,
                                                   ctx.hidden))
    retk = -(-rspl.sum(dim=-1, dtype=torch.int32) // md.chunk_rows(a2a))
    new_state = None
    if state is None:
        comb_tok, comb_meta = md.combine_device(a2a, y_tok, y_meta, retk,
                                                sendk)
    else:
        md.combine_ll_device(a2a, y_tok, y_meta, retk, sendk, state.parity,
                             state.comb_tok, state.comb_meta)
        comb_tok, comb_meta = md.ll_window(a2a, state.comb_tok,
                                           state.comb_meta, state.parity)
        new_state = EPMoEState(
            parity=(state.parity + 1) % 2, disp_tok=state.disp_tok,
            disp_meta=state.disp_meta, comb_tok=state.comb_tok,
            comb_meta=state.comb_meta)
    y_sorted = md.combine_view(a2a, comb_tok, comb_meta, peer, dest,
                               offs_al, n_valid)

    # back to assignment order by the inverse permutation, then the
    # top-k groups summed: assignment t belongs to token t // topk
    ar = torch.arange(total, device=dev)
    inv_order = torch.empty((nw, total), dtype=torch.int64, device=dev)
    inv_order.scatter_(1, order, ar.expand(nw, total))
    y_orig = md._take_rows(y_sorted, inv_order)
    # masked assignments weigh 0 but their rows may hold garbage: select
    y_use = torch.where((w_flat != 0)[..., None],
                        y_orig.float() * w_flat[..., None], 0.0)
    out = y_use.reshape(nw, out_rows, ctx.topk, ctx.hidden).sum(dim=2)
    return (out, new_state) if state is not None else out


def ep_moe(x, logits, w_up, w_down, ctx: EPMoEContext, state=None):
    """Entry point: the EP MoE MLP. x (M, H) tokens, logits (M, E)
    router logits; w_up (E, H, F) / w_down (E, F, H) float tensors or
    int8 dicts, or over a mesh their per-rank shards (lists of (E/W, ...)
    views of one allocation, as ``Transformer.shard_params`` makes them)
    → (M, H) in x's dtype. Over a mesh row block r of x (M/W rows) is
    rank r's tokens. With ``state`` (from :func:`create_ep_moe_state`)
    the transport runs over the persistent workspaces and the call
    returns ``(out, state')``."""
    nw = ctx.n
    m, hid = x.shape
    if m % nw:
        raise ValueError(f"ep_moe: {m} rows do not split over {nw} ranks")
    weights, ids = mu.select_experts(logits, ctx.topk)
    res = _ep_assignments_device(
        ctx, x.reshape(nw, m // nw, hid), ids.reshape(nw, -1),
        weights.reshape(nw, -1).float(), m // nw, whole_experts(w_up),
        whole_experts(w_down), state=state)
    if state is not None:
        out, new_state = res
        return out.reshape(m, hid).to(x.dtype), new_state
    return res.reshape(m, hid).to(x.dtype)
