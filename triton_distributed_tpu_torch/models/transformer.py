"""The serving and generation paths of the flagship transformer, in PyTorch.

Port of ``triton_distributed_tpu/models/transformer.py``: the config,
the parameter layout of ``Transformer.init``, the dense and expert
weight quantizers, the continuous-batching ``serving_step`` with its
dense MLP and its two MoE flavours, and the prefill → decode path
(``init_cache`` / ``init_paged_cache`` / ``paginate_caches``,
``prefill``, ``decode_step``, ``generate``) for dense and MoE blocks:
prefill projects through the world-size-1 ``ag_gemm`` / ``gemm_rs``
and runs an MoE block through ``EPMoEMLP`` in full precision (EP: the
fused transport with no wire quantization, on float experts) or
``moe_tp_mlp_overlapped`` on the MoE-TP kernels (TP); decode attends
through the flash-decode kernels and runs an MoE block as the serving
step does. Without a mesh one GPU holds every head and every expert:
the serving step's projections run through
:func:`~triton_distributed_tpu_torch.kernels.group_gemm.grouped_matmul`
(int8 weights) or a plain matmul (float weights), attention through the
ragged paged-attention kernel, and an ``moe="ep"`` block through
:func:`~triton_distributed_tpu_torch.ops.moe.ep_moe` at EP world size 1
on the fused transport (the chunked all-to-all and grouped-GEMM
kernels).

**Tensor parallelism** (``Transformer(config, mesh=...)``,
``attn="tp"``): the prefill → decode path over the ``tp`` axis of a
loopback mesh (:class:`~triton_distributed_tpu_torch.runtime.topology.
Mesh`), single-controller as in JAX. :meth:`Transformer.shard_params`
turns each tensor-parallel weight into a list of per-rank shards (the
counterpart of ``shardings()`` and ``device_put``): rank r holds the q
columns of its ``Hq/W`` heads and the k and v columns of its ``Hkv/W``
heads in ``wqkv`` (JAX shards ``wqkv``'s columns in contiguous quarters
and reshards after the split; the port keeps each rank's attention
local), the matching rows of ``wo``, and quarters of ``up`` / ``down``;
the other leaves stay one shared tensor. Prefill runs the fused
``ag_gemm`` / ``gemm_rs`` kernels over the mesh with the activation rows
sequence-parallel (row block r of the (B·S, H) activations is rank r's
shard), each rank's attention over its heads, and writes the K/V into
sequence-sharded caches (rank r holds positions [r·S/W, (r+1)·S/W) of
every head). Decode projects each rank's shard with ``_dmm`` and
combines with plain tensor ops (concatenation of column shards, an f32
sum of row shards: XLA's collectives in JAX), attends through the
sequence-parallel flash decode (local decode, ``all_gather`` of the
partials, combine), and appends each token on the rank that owns its
position. Replicated activations are one shared tensor on the loopback
mesh.

**Context-parallel prefill** (``attn="ring"`` or ``"ulysses"`` over a
mesh, JAX ``_cp_attention``): the attention's sequence is sharded over
the ``tp`` axis with every head whole on every rank. ``wqkv`` and ``wo``
stay one shared tensor (JAX replicates them) and project all rows in one
matmul; the ring or Ulysses attention of :mod:`~triton_distributed_tpu_torch.
kernels.ring_attention` runs on the ranks' stacked sequence blocks; the
MLP stays tensor-parallel. Decode is the same sequence-parallel decode
for every ``attn``, its q, k, v and output projections on the shared
weights.

**Long-context serving** (``Transformer(config, mesh=Mesh.grid({"tp":
1, "cp": 2}), cp_axis="cp")``): the serving step over ``cp`` stacked
per-shard page pools, each layer's ragged attention walking every
shard's slice of a row's pages in one launch and the shards' partials
merged by the cp LSE-combine (:meth:`Transformer._cp_ragged_attn`).

MoE blocks run over the mesh in both flavours. EP splits the experts
(rank r owns experts [r·E/W, (r+1)·E/W)): the prefill and the decode
route every rank's tokens (row block r) through ``ep_moe`` across the
ranks, one all-to-all launch a leg for all of them, the decode over B
padded up to a multiple of W as JAX pads it. TP splits the experts' F
dim: the prefill runs ``moe_tp_mlp_overlapped`` on the mesh forms of
the two MoE-TP kernels, the decode's per-token loop sums the ranks'
partial products in f32.

Parameters are a plain dict with exactly the JAX layout::

    {"embed": (vocab, H), "norm_f": (H,), "lm_head": (H, vocab),
     "blocks": [{"norm_attn", "norm_mlp", "wqkv": (H, qkv), "wo": (q, H),
                 "up": (H, F), "down": (F, H)}, ...]}

where an MoE block holds ``"router": (H, E)`` f32, ``"moe_up": (E, H,
F)`` and ``"moe_down": (E, F, H)`` in place of up/down, a quantized
matrix is ``{"q": int8 (K, N), "scale": f32 (N,)}`` and a quantized
expert tensor ``{"q": int8 (E, K, N), "scale": f32 (E, N)}``.
:func:`params_from_numpy` carries a JAX parameter tree over.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from triton_distributed_tpu_torch.config import resolve_device, to_torch_dtype
from triton_distributed_tpu_torch.runtime.topology import Mesh, one_axis


@dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 32000
    n_layers: int = 2
    hidden: int = 512
    ffn: int = 1024
    n_heads: int = 8
    n_kv_heads: int = 4
    head_dim: int = 64
    attn: str = "tp"
    moe: str = "none"
    moe_layers: tuple = ()
    num_experts: int = 8
    topk: int = 2
    norm_eps: float = 1e-5
    moe_wire_quant: str | None = None
    moe_weight_quant: str | None = None
    moe_act_quant: str | None = None
    # int8 dense projections (wqkv / wo / up / down / lm_head) with
    # per-out-channel f32 scales, after Transformer.quantize_dense_weights
    dense_weight_quant: str | None = None
    # W8A8 dense projections (needs dense_weight_quant="int8"); lm_head
    # stays W8A16 so the logits keep the f32 accumulator
    dense_act_quant: str | None = None
    # int8 KV pools with per-(page, head, position) f32 scales
    kv_quant: str | None = None
    remat: bool = False
    # torch dtypes, or their names ("bfloat16", "float32")
    dtype: object = torch.bfloat16
    param_dtype: object = torch.float32

    def __post_init__(self):
        object.__setattr__(self, "dtype", to_torch_dtype(self.dtype))
        object.__setattr__(self, "param_dtype",
                           to_torch_dtype(self.param_dtype))
        object.__setattr__(self, "moe_layers", tuple(self.moe_layers))
        if self.attn not in ("tp", "ring", "ulysses"):
            raise ValueError(
                f"attn must be 'tp', 'ring' or 'ulysses', got {self.attn!r}")
        if self.moe not in ("none", "tp", "ep"):
            raise ValueError(
                f"moe must be 'none', 'tp' or 'ep', got {self.moe!r}")
        for name, allowed in (
            ("moe_wire_quant", (None, "fp8", "int8")),
            ("moe_weight_quant", (None, "fp8", "int8")),
            ("kv_quant", (None, "int8")),
            ("dense_weight_quant", (None, "int8")),
            ("moe_act_quant", (None, "int8")),
            ("dense_act_quant", (None, "int8")),
        ):
            if getattr(self, name) not in allowed:
                raise ValueError(f"{name} must be one of {allowed}, got "
                                 f"{getattr(self, name)!r}")
        if self.moe_act_quant is not None and self.moe_weight_quant != "int8":
            raise ValueError("moe_act_quant (W8A8) needs "
                             "moe_weight_quant='int8'")
        if (self.dense_act_quant is not None
                and self.dense_weight_quant != "int8"):
            raise ValueError(
                "dense_act_quant (W8A8) needs dense_weight_quant='int8'")
        if self.moe_weight_quant is not None and self.moe != "ep":
            raise ValueError(
                "moe_weight_quant targets the EP expert matrices — set "
                f"moe='ep' (got moe={self.moe!r})")

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def qkv_dim(self) -> int:
        return self.q_dim + 2 * self.kv_dim


_DENSE_QUANT_KEYS = ("wqkv", "wo", "up", "down")
#: the attention projections: sharded per head at attn="tp", shared under
#: context-parallel attention
_ATTN_KEYS = ("wqkv", "wo")
_EXPERT_KEYS = ("moe_up", "moe_down")

#: the mesh axis the tensor-parallel path runs over
TP_AXIS = "tp"

#: the grouped-GEMM M-block of the MoE experts on the fused (decode and
#: serving) transport: a multiple of the CUDA kernels' 64-row tile
#: (kernels/group_gemm.py KERNEL_BM); the smallest one pads the least
#: (8704 rows at the serving step's 4608 assignments over 64 experts,
#: against 12928 at 128)
MOE_BLOCK_M = 64
#: the M-block of the prefill's MoE GEMMs (EP and the MoE-TP kernels):
#: JAX's off-TPU choice, so that the routing tables equal the
#: reference's integer for integer
PREFILL_BLOCK_M = 128


def _qexperts(w, mode="int8", k_major=False):
    """(E, K, N) expert tensor → ``{"q": int8, "scale": f32 (E, N)}``;
    ``k_major``: the codes stored (E, N, K), "q" their (E, K, N) view (the
    experts W8A8 multiplies)."""
    from triton_distributed_tpu_torch.kernels.group_gemm import (
        quantize_grouped_weights,
    )

    q, scale = quantize_grouped_weights(w, mode, k_major=k_major)
    return {"q": q, "scale": scale}


def _q2d(w, mode="int8", k_major=False):
    """(K, N) matrix → ``{"q": int8 (K, N), "scale": f32 (N,)}``;
    ``k_major``: the codes stored (N, K), "q" their (K, N) view (the
    projections W8A8 multiplies)."""
    from triton_distributed_tpu_torch.kernels.group_gemm import (
        quantize_grouped_weights,
    )

    if isinstance(w, dict):
        return w
    q, scale = quantize_grouped_weights(w[None], mode, k_major=k_major)
    return {"q": q[0], "scale": scale[0]}


def _w8a8_keys(cfg) -> tuple:
    """The weights W8A8 multiplies, which are stored K-major: the dense
    projections with ``dense_act_quant``, the experts with
    ``moe_act_quant`` (the lm_head is W8A16 and stays N-major)."""
    keys = ()
    if cfg.dense_act_quant == "int8":
        keys += _DENSE_QUANT_KEYS
    if cfg.moe_act_quant == "int8":
        keys += _EXPERT_KEYS
    return keys


class Transformer:
    """Config + device, or config + mesh. The serving step is a method;
    the parameters live in a dict the caller holds (see the module
    docstring).

    ``mesh``: a loopback mesh whose ``"tp"`` axis the prefill → decode
    path runs tensor-parallel over (``attn="tp"``; the device is the
    mesh's): dense blocks, and MoE blocks in both flavours, EP with the
    experts split over the ranks and TP with their F dim split. It needs
    ``n_heads``, ``n_kv_heads`` and ``ffn`` (and an EP model's
    ``num_experts``) to split over the ranks. Under ``attn="ring"`` or
    ``"ulysses"`` the axis is context-parallel in the attention: the
    heads need not split (Ulysses needs ``n_heads`` to, and
    ``n_kv_heads`` to split or to divide the ranks), ``ffn`` still does.

    ``cp_axis``: the mesh axis of long-context serving (JAX ``:231-242``;
    None: no context parallelism), e.g. ``Mesh.grid({"tp": 1, "cp": 2})``
    with ``cp_axis="cp"``. The serving pool becomes ``cp`` per-shard
    pools stacked in one allocation, each layer's ragged attention walks
    every shard's slice of a request's pages, and the shards' partials
    merge through the cp LSE-combine (:meth:`_cp_ragged_attn`). tp is
    sized with the cp axis excluded; beside cp it must be 1 (serving at
    tp > 1 is ROADMAP Queue 1 item 12), and the model's other paths then
    run as one rank: ``self.mesh`` is the tensor-parallel mesh, None
    there. cp adds no parameters."""

    def __init__(self, config: TransformerConfig, mesh: Mesh | None = None,
                 device=None, cp_axis: str | None = None):
        self.config = config
        self.mesh = mesh
        self.cp_axis = cp_axis
        self.cp = 1
        if mesh is None:
            if cp_axis is not None:
                raise ValueError(f"cp_axis={cp_axis!r} names an axis of a "
                                 "mesh; pass mesh=")
            self.device = resolve_device(device)
            self.tp = 1
            return
        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a Mesh, got {type(mesh).__name__}"
                            " (pass the device as device=...)")
        self.device = mesh.device
        if device is not None and resolve_device(device) != self.device:
            raise ValueError(f"device {device} is not the mesh's "
                             f"{self.device}")
        self.tp = one_axis(mesh, TP_AXIS, () if cp_axis is None
                           else (cp_axis,))
        if cp_axis is not None:
            self.cp = mesh.axis_size(cp_axis)
            if self.cp > 1 and self.tp > 1:
                raise NotImplementedError(
                    f"context-parallel serving at cp = {self.cp} beside tp ="
                    f" {self.tp}: serving at tp > 1 is ROADMAP Queue 1 item "
                    "12; use a mesh whose tp axis has size 1")
            if self.tp == 1:
                self.mesh = None      # the tensor-parallel paths: one rank
                return
        c = config
        split = [("ffn", c.ffn)]
        if c.attn == "tp":
            split[:0] = [("n_heads", c.n_heads), ("n_kv_heads", c.n_kv_heads)]
        if c.moe == "ep" and c.moe_layers:
            split.append(("num_experts", c.num_experts))
        for name, v in split:
            if v % self.tp:
                raise ValueError(
                    f"{name} = {v} does not split over tp = {self.tp} (KV-"
                    "head replication for n_kv_heads < tp is ROADMAP Queue 1"
                    " item 12)")
        if c.attn == "ulysses" and (c.n_heads % self.tp or (
                c.n_kv_heads % self.tp and self.tp % c.n_kv_heads)):
            raise ValueError(
                f"Ulysses needs n_heads % cp == 0 and n_kv_heads % cp == 0 "
                f"or cp % n_kv_heads == 0, got {c.n_heads} and "
                f"{c.n_kv_heads} heads at cp = {self.tp}")

    # ---------------------------------------------------------------- params

    def init(self, generator: torch.Generator, quantize: bool = False):
        """Random parameters on the device, drawn from ``generator``
        (which must live on the same device) with the JAX scales.

        ``quantize=True`` (needs ``dense_weight_quant``) draws each
        dense matrix, and each (E, K, N) expert tensor, in
        ``config.dtype`` and quantizes it at once (the experts when
        ``moe_weight_quant`` is set), so a full-size model never holds
        its float weights: the other leaves are then in ``config.dtype``
        too, except the router, which stays f32."""
        c = self.config
        if quantize and c.dense_weight_quant is None:
            raise ValueError("init(quantize=True) needs dense_weight_quant")
        pd = c.dtype if quantize else c.param_dtype
        dev = self.device
        s = 1.0 / (c.hidden ** 0.5)

        def dense(shape, scale=None, dtype=pd):
            w = torch.randn(shape, generator=generator, device=dev,
                            dtype=dtype) * (scale or s)
            return w

        kmaj = c.dense_act_quant == "int8"

        def mat(shape, scale=None, k_major=kmaj):
            w = dense(shape, scale)
            return _q2d(w, c.dense_weight_quant, k_major) if quantize else w

        def experts(shape, scale=None):
            w = dense(shape, scale)
            if quantize and c.moe_weight_quant is not None:
                return _qexperts(w, c.moe_weight_quant,
                                 c.moe_act_quant == "int8")
            return w

        params = {
            "embed": dense((c.vocab, c.hidden), 0.02),
            "norm_f": torch.ones((c.hidden,), dtype=pd, device=dev),
            "lm_head": mat((c.hidden, c.vocab), k_major=False),
            "blocks": [],
        }
        for i in range(c.n_layers):
            blk = {
                "norm_attn": torch.ones((c.hidden,), dtype=pd, device=dev),
                "norm_mlp": torch.ones((c.hidden,), dtype=pd, device=dev),
                "wqkv": mat((c.hidden, c.qkv_dim)),
                "wo": mat((c.q_dim, c.hidden)),
            }
            if c.moe != "none" and i in c.moe_layers:
                blk["router"] = dense((c.hidden, c.num_experts),
                                      dtype=c.param_dtype)
                blk["moe_up"] = experts((c.num_experts, c.hidden, c.ffn))
                blk["moe_down"] = experts((c.num_experts, c.ffn, c.hidden),
                                          1.0 / (c.ffn ** 0.5))
            else:
                blk["up"] = mat((c.hidden, c.ffn))
                blk["down"] = mat((c.ffn, c.hidden), 1.0 / (c.ffn ** 0.5))
            params["blocks"].append(blk)
        return params

    def quantize_moe_weights(self, params, mode: str | None = None):
        """Replace every block's expert tensors (moe_up / moe_down) with
        int8 ``{"q": (E, K, N), "scale": (E, N) f32}`` dicts
        (per-(expert, out-channel) scales). ``mode`` defaults to
        ``config.moe_weight_quant``; returns ``params`` unchanged when
        both are None. Only int8 is ported. With ``moe_act_quant`` (W8A8)
        the codes are stored K-major, "q" their (E, K, N) view."""
        mode = mode or self.config.moe_weight_quant
        if mode is None:
            return params
        if self.config.moe != "ep":
            raise ValueError("quantize_moe_weights targets EP expert weights")
        kmaj = self.config.moe_act_quant == "int8"
        out = dict(params)
        out["blocks"] = []
        for blk in params["blocks"]:
            blk = dict(blk)
            for name in ("moe_up", "moe_down"):
                if name in blk and not isinstance(blk[name], dict):
                    blk[name] = _qexperts(blk[name], mode, kmaj)
            out["blocks"].append(blk)
        return out

    def quantize_dense_weights(self, params, mode: str | None = None):
        """Replace wqkv / wo / up / down of every block, and lm_head,
        with int8 ``{"q", "scale"}`` dicts (per-out-channel scales).
        ``mode`` defaults to ``config.dense_weight_quant``. With
        ``dense_act_quant`` (W8A8) the blocks' codes are stored K-major
        (``quantize_grouped_weights(..., k_major=True)``); the lm_head's
        stay N-major (W8A16)."""
        mode = mode or self.config.dense_weight_quant
        if mode is None:
            return params
        kmaj = self.config.dense_act_quant == "int8"
        out = dict(params)
        out["lm_head"] = _q2d(params["lm_head"], mode)
        out["blocks"] = []
        for blk in params["blocks"]:
            blk = dict(blk)
            for name in _DENSE_QUANT_KEYS:
                if name in blk:
                    blk[name] = _q2d(blk[name], mode, kmaj)
            out["blocks"].append(blk)
        return out

    # ---------------------------------------------------- tensor parallel

    def _shard_index(self, name):
        """(dim, per-rank index tensors) of a tensor-parallel weight:
        ``wqkv`` by columns, rank r's q columns of its Hq/W heads then k
        and v columns of its Hkv/W heads; ``up`` by column blocks;
        ``wo`` and ``down`` by the matching rows; the experts
        (``moe_up``, ``moe_down``) by expert blocks (EP) or by F blocks
        (TP: ``moe_up``'s columns, ``moe_down``'s rows)."""
        c, n = self.config, self.tp

        def blocks(size):
            w = size // n
            return [torch.arange(r * w, (r + 1) * w) for r in range(n)]

        if name == "wqkv":
            q, k, v = (blocks(x) for x in (c.q_dim, c.kv_dim, c.kv_dim))
            return 1, [torch.cat([q[r], c.q_dim + k[r],
                                  c.q_dim + c.kv_dim + v[r]])
                       for r in range(n)]
        if name == "wo":
            return 0, blocks(c.q_dim)
        if name in _EXPERT_KEYS:
            if c.moe == "ep":
                return 0, blocks(c.num_experts)
            return (2 if name == "moe_up" else 1), blocks(c.ffn)
        return (1 if name == "up" else 0), blocks(c.ffn)

    def shard_params(self, params):
        """Place a parameter dict on the model's mesh (the counterpart of
        ``shardings()`` followed by ``device_put``): each
        tensor-parallel leaf (``wqkv``, ``wo``, ``up``, ``down``, the
        experts ``moe_up`` / ``moe_down``, and both leaves of their int8
        dicts) becomes a list of W per-rank shards, views of one
        allocation; every other leaf (the router too) stays one shared
        tensor. ``wqkv`` is cut per head (see :meth:`_shard_index`); under
        context-parallel attention (``attn`` "ring" / "ulysses") ``wqkv``
        and ``wo`` stay shared, as JAX replicates them."""
        from triton_distributed_tpu_torch.kernels.group_gemm import k_major

        if self.mesh is None:
            raise ValueError("shard_params needs the model's mesh")
        dev = self.device
        keys = _DENSE_QUANT_KEYS + _EXPERT_KEYS
        if self.config.attn != "tp":
            keys = tuple(k for k in keys if k not in _ATTN_KEYS)

        def shard(w, dim, idx):
            idx = [i.to(w.device) for i in idx]
            if not w.is_contiguous() and k_major(w):
                # K-major codes (W8A8): cut their (..., N, K) storage, so
                # that every shard stays a K-major view of one allocation
                last = w.dim() - 1
                dim = {last: last - 1, last - 1: last}.get(dim, dim)
                return [t.transpose(-1, -2)
                        for t in shard(w.transpose(-1, -2), dim, idx)]
            full = torch.stack([w.index_select(dim, i) for i in idx])
            return list(full.to(dev).unbind(0))

        out = dict(params)
        out["blocks"] = []
        for blk in params["blocks"]:
            blk = dict(blk)
            for name in keys:
                if name not in blk:
                    continue
                dim, idx = self._shard_index(name)
                w = blk[name]
                if isinstance(w, dict) and name in _EXPERT_KEYS:
                    # (E, N) expert scales follow the expert blocks (EP;
                    # int8 experts are EP only)
                    blk[name] = {"q": shard(w["q"], dim, idx),
                                 "scale": shard(w["scale"], 0, idx)}
                elif isinstance(w, dict):
                    # out-channel scales follow column shards; row shards
                    # keep every column, and its scale
                    sc = (shard(w["scale"], 0, idx) if dim == 1 else
                          list(w["scale"].to(dev)[None]
                               .expand(self.tp, -1).contiguous().unbind(0)))
                    blk[name] = {"q": shard(w["q"], dim, idx), "scale": sc}
                else:
                    blk[name] = shard(w, dim, idx)
            out["blocks"].append(blk)
        return out

    def _dmm_tp(self, x, w, rows: bool):
        """A decode projection over a sharded weight: each rank's shard
        product with the kernels ``_dmm`` uses, combined with plain
        tensor ops, the counterparts of XLA's collectives in JAX.
        Column shards (``rows=False``: wqkv, up) concatenate; row shards
        (wo, down) take rank r's block of x's columns and sum in f32,
        then cast to the compute dtype. W8A8 quantizes x's rows once over
        the whole row, as the one-rank model does, so every rank's int32
        sums are exact slices of it."""
        c, n = self.config, self.tp
        if not isinstance(w, dict):
            parts = x.chunk(n, dim=-1) if rows else (x,) * n
            outs = [xr @ wr.to(c.dtype) for xr, wr in zip(parts, w)]
        else:
            from triton_distributed_tpu_torch.kernels.group_gemm import (
                grouped_matmul,
                quantize_act_rows,
            )

            be = torch.zeros((1,), dtype=torch.int32, device=x.device)
            kw = dict(out_dtype=torch.float32 if rows else c.dtype)
            if c.dense_act_quant == "int8":
                xq, kw["x_scale"] = quantize_act_rows(x)
            else:
                xq = x.to(c.dtype)
            parts = xq.chunk(n, dim=-1) if rows else (xq,) * n
            outs = [grouped_matmul(xr.contiguous(), wq[None], be,
                                   w_scale=ws[None], **kw)
                    for xr, wq, ws in zip(parts, w["q"], w["scale"])]
        if rows:
            return torch.stack(outs).sum(0, dtype=torch.float32).to(c.dtype)
        return torch.cat(outs, dim=-1)

    def _proj(self, x, w, rows: bool):
        """A decode projection: ``_dmm``, or over a sharded weight
        :meth:`_dmm_tp` (``rows``: the weight is row-parallel). A shared
        weight over a mesh (context-parallel attention's ``wqkv`` and
        ``wo``) goes through ``_dmm`` once, as JAX's decode does
        (``:1106``)."""
        if not _sharded(w):
            return self._dmm(x, w)
        return self._dmm_tp(x, w, rows)

    def _qkv(self, xn, w):
        """The decode step's q, k and v rows (B, q_dim / kv_dim), every
        head in head order; over a mesh at ``attn="tp"`` from the ranks'
        [q | k | v] column shards."""
        c = self.config
        n = self.tp if _sharded(w) else 1
        qkv = self._proj(xn, w, rows=False)
        if n > 1:
            qkv = qkv.reshape(xn.shape[0], n, -1)
        q, k, v = torch.split(qkv, [c.q_dim // n, c.kv_dim // n,
                                    c.kv_dim // n], dim=-1)
        return tuple(t.reshape(xn.shape[0], -1) for t in (q, k, v))

    def _dense_w(self, w):
        """Dense weight in the compute dtype: widen a quantized dict,
        cast a plain tensor; a sharded leaf rank by rank."""
        if isinstance(w, list):
            return [self._dense_w(wr) for wr in w]
        if isinstance(w, dict) and isinstance(w["q"], list):
            return [self._dense_w({"q": q, "scale": sc})
                    for q, sc in zip(w["q"], w["scale"])]
        if isinstance(w, dict):
            from triton_distributed_tpu_torch.kernels.group_gemm import (
                dequantize_grouped_weights,
            )

            return dequantize_grouped_weights(
                w["q"][None], w["scale"][None], self.config.dtype)[0]
        return w.to(self.config.dtype)

    def _dmm(self, x, w, out_dtype=None, act_quant=True):
        """Dense matmul dispatching on the weight storage: int8 dicts go
        through the grouped-GEMM kernel with E = 1 (W8A8 when
        ``config.dense_act_quant`` and ``act_quant``, else W8A16); plain
        tensors take an ordinary matmul.

        Every batch size stays on the kernel, which covers any M in one
        launch. The JAX ``_dmm`` dequantizes the weight above 1024 rows
        instead (a second M-block on the TPU grid re-streams every weight
        tile), so batches of more than 1024 rows differ from it by the
        activation quantization."""
        c = self.config
        if not isinstance(w, dict):
            return x @ w.to(out_dtype or c.dtype)
        from triton_distributed_tpu_torch.kernels.group_gemm import (
            grouped_matmul,
            quantize_act_rows,
        )

        be = torch.zeros((1,), dtype=torch.int32, device=x.device)
        wq, ws = w["q"][None], w["scale"][None]
        if (act_quant and c.dense_act_quant == "int8"
                and w["q"].dtype == torch.int8):
            xq, xsc = quantize_act_rows(x)
            return grouped_matmul(xq, wq, be, w_scale=ws, x_scale=xsc,
                                  out_dtype=out_dtype or c.dtype)
        return grouped_matmul(x.to(c.dtype).contiguous(), wq, be,
                              w_scale=ws, out_dtype=out_dtype)

    def _expert_w(self, w):
        """Expert weights for a dense consumer: widen a quantized dict,
        cast a plain tensor. An EP model's sharded leaf is taken as the
        (E, ...) view of its shards; a TP model's F shards stay a list,
        each cast."""
        from triton_distributed_tpu_torch.ops.moe import whole_experts

        if self.config.moe == "tp" and isinstance(w, list):
            return [t.to(self.config.dtype) for t in w]
        w = whole_experts(w)
        if isinstance(w, dict):
            from triton_distributed_tpu_torch.kernels.group_gemm import (
                dequantize_grouped_weights,
            )

            return dequantize_grouped_weights(w["q"], w["scale"],
                                              self.config.dtype)
        return w.to(self.config.dtype)

    @functools.cached_property
    def _moe_tp_ctx(self):
        """The MoE-TP context of the prefill's overlapped engines."""
        from triton_distributed_tpu_torch.ops import (
            create_ag_group_gemm_context,
        )

        c = self.config
        return create_ag_group_gemm_context(
            num_experts=c.num_experts, topk=c.topk, block_m=PREFILL_BLOCK_M,
            dtype=c.dtype, mesh=self.mesh, axis=TP_AXIS)

    def _moe_ep_ctx(self, m_local: int, inference: bool = False,
                    weights_quantized: bool | None = None):
        """The EP MoE context, on the fused transport. ``inference``
        (decode, serving): the grouped-GEMM kernels at ``MOE_BLOCK_M``,
        ``moe_wire_quant`` on the wire, and W8A8 experts
        (``moe_act_quant``) when the expert weights are int8 dicts.
        Otherwise (prefill) the full precision of JAX's off-TPU ``xla``
        context: no wire quantization, no W8A8, ``PREFILL_BLOCK_M``; the
        caller hands float experts, so both GEMMs run the float mode
        over the same sorted rows (either transport carries each row to
        its expert unchanged). ``m_local``: a rank's tokens; over a mesh
        the experts split over its ranks. ``weights_quantized``: whether
        the leaves in hand are quantized dicts (None → trust the
        config)."""
        from triton_distributed_tpu_torch.ops import create_ep_moe_context

        c = self.config
        kw = dict(num_experts=c.num_experts, topk=c.topk,
                  max_m=m_local * c.topk, hidden=c.hidden, dtype=c.dtype,
                  mesh=self.mesh, axis=TP_AXIS)
        if not inference:
            return create_ep_moe_context(block_m=PREFILL_BLOCK_M, **kw)
        wq = c.moe_weight_quant
        if weights_quantized is False:
            wq = None
        elif weights_quantized and wq is None:
            wq = "int8"
        return create_ep_moe_context(
            block_m=MOE_BLOCK_M, quant=c.moe_wire_quant,
            act_quant=c.moe_act_quant if wq == "int8" else None, **kw)

    def init_decode_state(self, batch: int):
        """Per-layer persistent workspaces of the barrier-free EP MoE
        transport (:class:`~triton_distributed_tpu_torch.ops.EPMoEState`)
        sized for ``batch`` tokens (over a mesh ceil(batch / tp) a rank,
        one window pair a rank): one per MoE layer, None elsewhere; None
        when the model has no EP layers."""
        from triton_distributed_tpu_torch.ops import create_ep_moe_state

        c = self.config
        if c.moe != "ep" or not c.moe_layers:
            return None
        ctx = self._moe_ep_ctx(-(-batch // self.tp), inference=True)
        return [create_ep_moe_state(ctx, self.device)
                if i in c.moe_layers else None for i in range(c.n_layers)]

    def _decode_moe_ep(self, blk, xn, state=None):
        """One EP MoE block on the (T, H) normed rows: the f32 router,
        then :func:`~triton_distributed_tpu_torch.ops.ep_moe` (over the
        persistent workspaces when ``state`` is given). Over a mesh T is
        padded with zero rows up to a multiple of tp (JAX's padding to
        the token shards), whose results are dropped. Returns ``(y,
        state')``."""
        from triton_distributed_tpu_torch.ops import ep_moe
        from triton_distributed_tpu_torch.ops.moe import whole_experts

        c = self.config
        b = xn.shape[0]
        pad = (-b) % self.tp
        xp = F.pad(xn, (0, 0, 0, pad)) if pad else xn
        logits = self._router_logits(xp, blk["router"])
        w_up, w_down = (whole_experts(w) for w in (blk["moe_up"],
                                                   blk["moe_down"]))
        wq = isinstance(w_up, dict)
        ctx = self._moe_ep_ctx(xp.shape[0] // self.tp, inference=True,
                               weights_quantized=wq)
        w_up, w_down = (w if isinstance(w, dict) else w.to(c.dtype)
                        for w in (w_up, w_down))
        if state is not None:
            y, state = ep_moe(xp, logits, w_up, w_down, ctx, state=state)
        else:
            y = ep_moe(xp, logits, w_up, w_down, ctx)
        return y[:b], state

    @staticmethod
    def _router_logits(x, router):
        """Every MoE block's f32 router product (the EP and TP flavours,
        prefill, decode and serving): :func:`~triton_distributed_tpu_torch.
        kernels.group_gemm.router_logits`, batch-independent row sums on
        the float-mode kernel (a disaggregated decode role's 256-row
        steps routed rows apart from the colocated engine's 768-row steps
        on cuBLAS). On CPU tensors the plain product."""
        from triton_distributed_tpu_torch.kernels.group_gemm import (
            router_logits,
        )

        return router_logits(x, router)

    def _moe_tp(self, blk, xn):
        """The TP-flavour MoE block: each token's top-k expert MLPs run
        on its gathered (H, F) weights (plain tensor math). Over a mesh
        every rank's F shard at once: the up product's column shards,
        then the down product's per-rank partials summed in f32 and cast,
        as :meth:`_dmm_tp` sums row shards."""
        from triton_distributed_tpu_torch.kernels.moe_utils import (
            select_experts,
        )
        from triton_distributed_tpu_torch.lang.shmem import require_stacked

        c = self.config
        w, ids = select_experts(self._router_logits(xn, blk["router"]),
                                c.topk)
        y = torch.zeros(xn.shape, dtype=torch.float32, device=xn.device)
        up, down = blk["moe_up"], blk["moe_down"]
        if self.mesh is not None:
            up = require_stacked(up, "the MoE-TP decode's experts")
            down = require_stacked(down, "the MoE-TP decode's experts")
        for tt in range(c.topk):
            e = ids[:, tt].long()
            if self.mesh is None:
                hh = F.silu(torch.einsum("bh,bhf->bf", xn,
                                         up[e].to(c.dtype)))
                yt = torch.einsum("bf,bfh->bh", hh, down[e].to(c.dtype))
            else:
                hh = F.silu(torch.einsum("bh,wbhf->wbf", xn,
                                         up[:, e].to(c.dtype)))
                yt = _sum_rank_partials(torch.einsum(
                    "wbf,wbfh->wbh", hh, down[:, e].to(c.dtype)))
            y += w[:, tt:tt + 1] * yt.float()
        return y

    def _rmsnorm(self, x, w):
        xf = x.float()
        r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True)
                        + self.config.norm_eps)
        return (xf * r).to(x.dtype) * w.to(x.dtype)

    # --------------------------------------------------------------- serving

    def init_serving_state(self, slots: int, npages: int, page: int):
        """A fresh :class:`~triton_distributed_tpu_torch.serving.state.
        ServingState`: per-layer page pools holding every KV head (int8
        dicts under ``kv_quant``), a (slots, pages_per_seq) block table
        of -1, zero lengths and cursors. ``pages_per_seq`` is ``npages``
        capped at 1024.

        Under ``cp > 1`` (JAX ``:1398-1466``) ``npages`` is the per-shard
        pool: the pools hold ``cp·npages`` pages, shard r the rows
        ``[r·npages, (r+1)·npages)``, the table's columns split the same
        way (``pages_per_seq = min(npages, max(1024 // cp, 1))·cp``), and
        one slot holds up to ``cp·pages_per_shard·page`` positions."""
        from triton_distributed_tpu_torch.serving.state import (
            ServingState,
            fresh_table,
        )

        self._one_rank("the serving state")
        c = self.config
        dev = self.device
        cp = self.cp
        pps = min(npages, max(1024 // cp, 1)) * cp
        shape = (npages * cp, c.n_kv_heads, page, c.head_dim)
        return ServingState(
            layers=tuple((self._fresh_cache(shape), self._fresh_cache(shape))
                         for _ in range(c.n_layers)),
            block_table=torch.as_tensor(fresh_table(slots, pps), device=dev),
            kv_lens=torch.zeros((slots,), dtype=torch.int32, device=dev),
            cursors=torch.zeros((slots,), dtype=torch.int32, device=dev),
            page=page,
            cp=cp,
        )

    def _ragged_attn(self, qp, k_pool, v_pool, state, q_lens, q_starts,
                     block_q, topologies=None, with_lse=False):
        """One layer's ragged paged attention over the updated pools.
        qp: (Hkv, T·G, D) packed GQA rows."""
        from triton_distributed_tpu_torch.layers import RaggedPagedAttention

        c = self.config
        layer = RaggedPagedAttention(group=c.n_heads // c.n_kv_heads)
        return layer(qp, k_pool, v_pool, state.kv_lens, q_lens, q_starts,
                     state.block_table, topologies=topologies,
                     block_q=block_q, with_lse=with_lse)

    def _cp_ragged_attn(self, qp, kp, vp, state, q_lens, q_starts, block_q,
                        topologies=None):
        """Context-parallel attention (JAX ``:1491-1545``): every cp
        shard walks its slice of a row's pages, shard r the table columns
        ``[r·pps_loc, (r+1)·pps_loc)`` with ``lens_r = clip(kv_len −
        r·s_loc, 0, s_loc)`` positions and a TOPO_CP descriptor whose
        frontier shift ``max(kv_len − r·s_loc, 0) − lens_r`` makes the
        shard's causal mask exact against the global positions it holds;
        the shards' ``(out, lse)`` partials then merge through
        :func:`~triton_distributed_tpu_torch.kernels.flash_decode.
        combine_gqa_partials` (on the card the cp LSE-combine kernel, one
        launch a layer). A row held wholly by shard 0 merges to shard 0's
        out bit for bit, so short requests stream as on a cp-free engine.

        JAX launches the ragged kernel once a shard on the shard's slice
        of the pool. Here one launch walks all shards: the shards' rows
        are stacked (cp·slots rows, shard r's q the r-th copy of the
        packed rows), and each row's table holds its shard's columns of
        global page ids, which address the stacked pool directly."""
        from triton_distributed_tpu_torch.kernels.flash_decode import (
            combine_gqa_partials,
        )
        from triton_distributed_tpu_torch.kernels.ragged_paged_attention import (
            TOPO_CP,
            topo_width,
        )

        cp, slots = state.cp, state.slots
        pps_loc = state.pages_per_shard
        s_loc = pps_loc * state.page
        hkv, tg, d = qp.shape
        t = tg // (self.config.n_heads // self.config.n_kv_heads)
        dev = qp.device
        if topologies is None:
            w = topo_width(block_q)
            topologies = torch.zeros((slots, 2 + 2 * w), dtype=torch.int32,
                                     device=dev)
        r = torch.arange(cp, device=dev)[:, None]
        kv = state.kv_lens.long()[None, :] - r * s_loc         # (cp, slots)
        lens = kv.clamp(0, s_loc)
        topo = torch.as_tensor(topologies, dtype=torch.int32,
                               device=dev).repeat(cp, 1)
        topo[:, 0] = TOPO_CP
        topo[:, 1] = (kv.clamp(min=0) - lens).reshape(-1)
        table = state.block_table.view(slots, cp, pps_loc).transpose(0, 1)
        shards = state.replace(
            block_table=table.reshape(cp * slots, pps_loc),
            kv_lens=lens.reshape(-1).to(torch.int32))
        starts = (q_starts.long()[None, :] + r * t).reshape(-1)
        out, lse = self._ragged_attn(
            qp.repeat(1, cp, 1), kp, vp, shards, q_lens.repeat(cp),
            starts.to(torch.int32), block_q, topo, with_lse=True)
        merged, _ = combine_gqa_partials(
            out.view(hkv, cp, tg, d).transpose(0, 1),
            lse.view(hkv, cp, tg).transpose(0, 1), out_dtype=qp.dtype)
        return merged

    def serving_step(self, params, state, tokens, token_rows, token_pos,
                     q_starts, q_lens, topologies=None, moe_state=None, *,
                     block_q: int = 8, all_logits: bool = False):
        """One continuous-batching step: a ragged mixed batch of prefill
        chunks and decode tokens through every layer.

        ``state.kv_lens`` already include this step's tokens;
        ``tokens``/``token_rows``/``token_pos``: (T,) packed ids, slot
        ids and positions (pos < 0 marks padding, whose K/V writes are
        dropped); ``q_starts``/``q_lens``: (slots,) spans. Returns
        ``(logits (slots, vocab) f32, state)`` — logits at each slot's
        last packed token, or at every packed token under
        ``all_logits``. With ``moe_state`` (from
        :meth:`init_decode_state`) the EP MoE blocks run over its
        persistent workspaces and the step returns ``(logits, state,
        moe_state')``.

        Every new K/V token is written into the pools first and
        attention reads the updated pools (append-then-attend). The
        write is in place (``index_put_``) where the JAX step donated
        its state; the returned state holds the same pool tensors."""
        from triton_distributed_tpu_torch.kernels.flash_decode import (
            quantize_kv,
        )
        from triton_distributed_tpu_torch.kernels.ragged_paged_attention import (
            pack_gqa_rows,
            unpack_gqa_rows,
        )

        self._one_rank("serving_step")
        c = self.config
        t = tokens.shape[0]
        page = state.page
        x = params["embed"][tokens.long()].to(c.dtype)          # (T, H)
        pos_c = torch.clamp(token_pos.long(), min=0)
        local_page = state.block_table[
            torch.clamp(token_rows.long(), 0, state.slots - 1),
            torch.clamp(pos_c // page, 0, state.pages_per_seq - 1),
        ]
        # padding tokens and unallocated (-1) table entries write
        # nothing: JAX dropped them as out-of-bounds scatters, here they
        # are masked out before the in-place write (one host sync)
        keep = torch.nonzero((token_pos >= 0) & (local_page >= 0))[:, 0]
        pi = local_page[keep].long()[:, None]
        hi = torch.arange(c.n_kv_heads, device=x.device)[None, :]
        oi = (pos_c[keep] % page)[:, None]
        idx = (pi, hi, oi)

        new_states = None if moe_state is None else list(moe_state)
        for li, (blk, (kp, vp)) in enumerate(zip(params["blocks"],
                                                 state.layers)):
            xn = self._rmsnorm(x, blk["norm_attn"])
            qkv = self._dmm(xn, blk["wqkv"])                     # (T, qkv)
            q, k, v = torch.split(qkv, [c.q_dim, c.kv_dim, c.kv_dim], dim=-1)
            k = k.reshape(t, c.n_kv_heads, c.head_dim)[keep]
            v = v.reshape(t, c.n_kv_heads, c.head_dim)[keep]
            if isinstance(kp, dict):
                kq8, ks8 = quantize_kv(k)
                vq8, vs8 = quantize_kv(v)
                kp["q"].index_put_(idx, kq8)
                kp["scale"].index_put_(idx, ks8)
                vp["q"].index_put_(idx, vq8)
                vp["scale"].index_put_(idx, vs8)
            else:
                kp.index_put_(idx, k.to(kp.dtype))
                vp.index_put_(idx, v.to(vp.dtype))
            qp = pack_gqa_rows(q.reshape(t, c.n_heads, c.head_dim),
                               c.n_kv_heads)
            if state.cp > 1:
                o = self._cp_ragged_attn(qp, kp, vp, state, q_lens,
                                         q_starts, block_q, topologies)
            else:
                o = self._ragged_attn(qp, kp, vp, state, q_lens, q_starts,
                                      block_q, topologies)
            o = unpack_gqa_rows(o, c.n_heads).reshape(t, c.q_dim)
            x = x + self._dmm(o.to(c.dtype), blk["wo"])
            xn = self._rmsnorm(x, blk["norm_mlp"])
            if "up" in blk:
                h = F.silu(self._dmm(xn, blk["up"]))
                x = x + self._dmm(h, blk["down"])
            elif c.moe == "ep":
                st = None if moe_state is None else moe_state[li]
                y, st = self._decode_moe_ep(blk, xn, st)
                x = x + y.to(x.dtype)
                if new_states is not None:
                    new_states[li] = st
            else:
                x = x + self._moe_tp(blk, xn).to(x.dtype)
        x = self._rmsnorm(x, params["norm_f"])
        if all_logits:
            x_last = x                                           # (T, H)
        else:
            last_idx = torch.clamp(q_starts.long() + q_lens.long() - 1,
                                   0, t - 1)
            x_last = x[last_idx]                                 # (slots, H)
        if isinstance(params["lm_head"], dict):
            logits = self._dmm(x_last, params["lm_head"],
                               out_dtype=torch.float32, act_quant=False)
        else:
            logits = x_last.float() @ params["lm_head"].float()
        if moe_state is None:
            return logits, state
        return logits, state, new_states

    # ------------------------------------------------------ prefill → decode

    def _one_rank(self, what):
        if self.mesh is not None:
            raise NotImplementedError(
                f"{what} over a mesh: paged caches and the serving step at "
                "tp > 1 are ROADMAP Queue 1 item 12")

    @functools.cached_property
    def _ag_ctx(self):
        from triton_distributed_tpu_torch import ops

        return ops.create_ag_gemm_context(self.mesh, TP_AXIS)

    @functools.cached_property
    def _rs_ctx(self):
        from triton_distributed_tpu_torch import ops

        return ops.create_gemm_rs_context(self.mesh, TP_AXIS)

    @functools.cached_property
    def _mlp(self):
        from triton_distributed_tpu_torch.layers import (
            ColumnParallelLinear,
            ParallelMLP,
            RowParallelLinear,
        )

        return ParallelMLP(ColumnParallelLinear(self._ag_ctx),
                           RowParallelLinear(self._rs_ctx),
                           activation="silu")

    @functools.cached_property
    def _sp_attn(self):
        from triton_distributed_tpu_torch.layers import (
            SpGQAFlashDecodeAttention,
        )

        c = self.config
        return SpGQAFlashDecodeAttention(self.mesh, TP_AXIS,
                                         q_heads=c.n_heads,
                                         kv_heads=c.n_kv_heads,
                                         head_dim=c.head_dim)

    def _causal(self, qkv, b, s, hq, hkv):
        """The causal softmax of one rank's heads: (B·S, (hq + 2·hkv)·D)
        projected rows → ((B·S, hq·D) out, k, v (B, S, hkv, D)). Plain
        tensor math in f32 with the ``-1e30`` mask, as JAX computes it
        outside any kernel."""
        c = self.config
        d = c.head_dim
        q, k, v = torch.split(qkv, [hq * d, hkv * d, hkv * d], dim=-1)
        g = hq // hkv
        qg = q.reshape(b, s, hkv, g, d)
        k = k.reshape(b, s, hkv, d)
        v = v.reshape(b, s, hkv, d)
        logits = torch.einsum("bshgd,bthd->bhgst", qg.float(),
                              k.float()) / d ** 0.5
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                     device=qkv.device))
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
        probs = torch.softmax(logits, dim=-1).to(c.dtype)
        del logits
        o = torch.einsum("bhgst,bthd->bshgd", probs, v.to(c.dtype))
        return o.reshape(b * s, hq * d), k, v

    def _cp_attention(self, blk, x, b, s):
        """Context-parallel prefill attention (JAX ``:613-642``): the
        sequence sharded over tp, every head whole, ``wqkv`` and ``wo``
        shared. (B·S, H) rows → ((B·S, H) rows, k, v) with k/v (B, S, Hkv,
        D) in global sequence order. Both projections are one matmul over
        all rows (JAX computes ``xr @ W`` outside any kernel); q, k and v
        are taken as views (n, B, S/n, H, D) of the projected rows, rank r
        holding positions [r·S/n, (r+1)·S/n), and go through
        :func:`~triton_distributed_tpu_torch.kernels.ring_attention.
        ring_attention` or ``ulysses_attention``, whose output rows feed
        ``wo`` as a view."""
        from triton_distributed_tpu_torch.kernels import ring_attention as ra

        c = self.config
        n = self.tp
        d = c.head_dim
        qkv = x @ self._dense_w(blk["wqkv"])                   # (B·S, qkv)
        q, k, v = torch.split(qkv, [c.q_dim, c.kv_dim, c.kv_dim], dim=-1)
        q = q.reshape(b, s, c.n_heads, d)
        k = k.reshape(b, s, c.n_kv_heads, d)
        v = v.reshape(b, s, c.n_kv_heads, d)

        def blocks(t):
            return t.view(b, n, s // n, *t.shape[2:]).transpose(0, 1)

        mesh = self.mesh or Mesh.loopback(1, self.device)
        attn = ra.ring_attention if c.attn == "ring" else ra.ulysses_attention
        o = attn(blocks(q), blocks(k), blocks(v), mesh, TP_AXIS)
        o = o.transpose(0, 1).reshape(b * s, c.q_dim)
        return o @ self._dense_w(blk["wo"]), k, v

    def _attention_kv(self, blk, x, b, s):
        """Prefill attention: (B·S, H) rows → ((B·S, H) rows, k, v) with
        k/v (B, S, Hkv, D), which :meth:`prefill` writes into the caches.
        ``attn="ring"`` / ``"ulysses"`` dispatch to :meth:`_cp_attention`.
        At ``attn="tp"`` the projections run through ``ag_gemm`` /
        ``gemm_rs``; over a mesh, row block r of ``x`` and of the result
        is rank r's shard, and rank r attends over its Hq/W heads (k/v
        come back with every rank's heads, in head order)."""
        from triton_distributed_tpu_torch import ops

        c = self.config
        if c.attn != "tp":
            return self._cp_attention(blk, x, b, s)
        n = self.tp
        hq, hkv = c.n_heads // n, c.n_kv_heads // n
        if self.mesh is None:
            qkv = ops.ag_gemm(x, self._dense_w(blk["wqkv"]), self._ag_ctx)
            o, k, v = self._causal(qkv, b, s, hq, hkv)
            out = ops.gemm_rs(o, self._dense_w(blk["wo"]), self._rs_ctx)
            return out, k, v
        qkv = ops.ag_gemm(list(x.chunk(n)), self._dense_w(blk["wqkv"]),
                          self._ag_ctx)
        parts = [self._causal(qr, b, s, hq, hkv) for qr in qkv]
        out = ops.gemm_rs([o for o, _, _ in parts],
                          self._dense_w(blk["wo"]), self._rs_ctx)
        return (_rows(out), torch.cat([k for _, k, _ in parts], dim=2),
                torch.cat([v for _, _, v in parts], dim=2))

    def _mlp_block(self, blk, x, inference: bool = False):
        """The block's MLP on (T, H) rows. Dense: ``ag_gemm`` → silu →
        ``gemm_rs``. MoE (the experts widened to ``config.dtype``, one
        layer at a time): EP through ``EPMoEMLP`` in full precision
        (:meth:`_moe_ep_ctx`); TP routes once in f32 and, with
        ``inference``, runs ``moe_tp_mlp_overlapped`` (the MoE-TP
        kernels). Over a mesh, row block r of ``x`` is rank r's tokens
        and both flavours run over the mesh (the all-to-all across the
        ranks, the mesh MoE-TP kernels). The differentiable TP path
        (``MoETPMLP``) raises: its backward is the rest of ROADMAP Queue
        1 step 9b."""
        c = self.config
        if "up" in blk:
            p = {"up": {"w": self._dense_w(blk["up"])},
                 "down": {"w": self._dense_w(blk["down"])}}
            if self.mesh is None:
                return self._mlp(p, x)
            return _rows(self._mlp(p, list(x.chunk(self.tp))))
        moe = {"router": blk["router"],
               "up": self._expert_w(blk["moe_up"]),
               "down": self._expert_w(blk["moe_down"])}
        if c.moe == "ep":
            from triton_distributed_tpu_torch.layers import EPMoEMLP

            return EPMoEMLP(self._moe_ep_ctx(x.shape[0] // self.tp))(moe, x)
        if not inference:
            raise NotImplementedError(
                "the differentiable MoE-TP block (MoETPMLP, moe_tp_mlp) for "
                "training: its backward is the rest of ROADMAP Queue 1 step "
                "9b")
        from triton_distributed_tpu_torch.kernels.moe_utils import (
            select_experts,
        )
        from triton_distributed_tpu_torch.ops import moe_tp_mlp_overlapped

        weights, ids = select_experts(self._router_logits(x, blk["router"]),
                                      c.topk)
        return moe_tp_mlp_overlapped(x, ids, weights, moe["up"],
                                     moe["down"], self._moe_tp_ctx).to(c.dtype)

    def _embed_rows(self, params, tokens):
        """(B, S) token ids → (B·S, H) activations."""
        return params["embed"][tokens.reshape(-1).long()].to(self.config.dtype)

    def _block(self, blk, x, b, s, inference: bool = False):
        """One decoder block → (x, k, v); ``inference`` picks the
        MoE-TP block's overlapped engines."""
        xn = self._rmsnorm(x, blk["norm_attn"])
        h, k, v = self._attention_kv(blk, xn, b, s)
        x = x + h
        x = x + self._mlp_block(blk, self._rmsnorm(x, blk["norm_mlp"]),
                                inference=inference)
        return x, k, v

    def _head(self, params, x):
        """Final norm and the f32 logits (an int8 lm_head widened)."""
        x = self._rmsnorm(x, params["norm_f"])
        w = params["lm_head"]
        if isinstance(w, dict):
            w = self._dense_w(w)
        return x.float() @ w.float()

    # ---------------------------------------------------------- training

    def _refuse_training(self, what):
        c = self.config
        if c.moe != "none" and c.moe_layers:
            raise NotImplementedError(
                f"{what} of a MoE model: the EP block's backward on the xla "
                "transport and MoETPMLP's (the composed MoE-TP backward) are "
                "the rest of ROADMAP Queue 1 step 9b")
        if c.remat:
            raise NotImplementedError(
                f"{what} with remat=True: activation checkpointing is the "
                "rest of ROADMAP Queue 1 step 9b")
        if self.cp > 1:
            raise NotImplementedError(
                f"{what} beside a cp serving axis: the model trains over "
                "its tp axis (dp axes beside it are ROADMAP Queue 1 step 8)")

    def forward(self, params, tokens):
        """tokens (B, S) int → logits (B·S, vocab) f32 (JAX ``:742``):
        every block's prefill math (``_block``, the attention through
        the differentiable ``ag_gemm`` / ``gemm_rs`` at ``attn="tp"``,
        the causal softmax in torch ops, the dense MLP), differentiable.
        Over a mesh, B·S must split over the ranks."""
        self._refuse_training("forward")
        b, s = tokens.shape
        if (b * s) % self.tp or (self.config.attn != "tp" and s % self.tp):
            raise ValueError(f"tokens ({b}, {s}) do not shard over tp = "
                             f"{self.tp}")
        x = self._embed_rows(params, tokens)
        for blk in params["blocks"]:
            x = self._block(blk, x, b, s)[0]
        return self._head(params, x)

    def loss(self, params, tokens, targets):
        """The mean next-token cross-entropy of :meth:`forward`'s logits
        (JAX ``:769``), an f32 scalar."""
        logits = self.forward(params, tokens)
        logp = torch.log_softmax(logits, dim=-1)
        tgt = targets.reshape(-1).long().to(logp.device)
        return -torch.gather(logp, 1, tgt[:, None])[:, 0].mean()

    def train_step(self, params, tokens, targets, lr=1e-3):
        """One SGD step (JAX ``:777``) → (loss, new params): ``p − lr ·
        grad`` in each parameter's dtype, gradients from autograd through
        the differentiable overlap ops (over a mesh their dual kernels).
        ``params`` (float tensors; over a mesh as :meth:`shard_params`
        gives them) are not modified; a sharded leaf of the result is
        again views of one allocation. MoE models and ``remat=True``
        raise (the rest of ROADMAP Queue 1 step 9b)."""
        self._refuse_training("train_step")
        leaves = []

        def prep(node):
            if isinstance(node, dict):
                return {k: prep(v) for k, v in node.items()}
            if isinstance(node, list):
                return [prep(v) for v in node]
            if not node.is_floating_point():
                raise ValueError("train_step takes float parameters, got a "
                                 f"{node.dtype} leaf (quantized weights)")
            t = node.detach().requires_grad_()
            leaves.append(t)
            return t

        live = prep(params)
        tokens = torch.as_tensor(tokens, device=self.device)
        loss = self.loss(live, tokens, targets)
        grads = iter(torch.autograd.grad(loss, leaves))

        def step(node):
            if isinstance(node, dict):
                return {k: step(v) for k, v in node.items()}
            if isinstance(node, list):
                new = [step(v) for v in node]
                if isinstance(new[0], torch.Tensor):   # a sharded leaf
                    return list(torch.stack(new).unbind(0))
                return new
            g = next(grads)
            return (node - lr * g.to(node.dtype)).detach()

        with torch.no_grad():
            new = step(live)
        return loss.detach(), new

    def unshard_params(self, params):
        """The inverse of :meth:`shard_params` for float leaves: every
        sharded leaf reassembled into one tensor."""
        out = dict(params)
        out["blocks"] = []
        for blk in params["blocks"]:
            blk = dict(blk)
            for name, w in list(blk.items()):
                if not isinstance(w, list):
                    continue
                dim, idx = self._shard_index(name)
                full_shape = list(w[0].shape)
                full_shape[dim] *= self.tp
                full = w[0].new_empty(full_shape)
                for wr, ir in zip(w, idx):
                    full.index_copy_(dim, ir.to(full.device), wr)
                blk[name] = full
            out["blocks"].append(blk)
        return out

    def init_cache(self, batch: int, max_len: int):
        """Per-layer (k, v) caches of shape (B, Hkv, S, D) ("bhsd") in
        ``config.dtype``, zero; under ``config.kv_quant`` each is a
        ``{"q": int8, "scale": (B, Hkv, S) f32}`` dict (scales 1). Every
        leaf is its own tensor: the decode step writes them in place.

        Over a mesh the sequence is sharded (the counterpart of
        ``cache_sharding``): each leaf is a list of W per-rank (B, Hkv,
        S/W, D) slices, views of one allocation, rank r holding positions
        [r·S/W, (r+1)·S/W). S must split over the ranks."""
        c = self.config
        n = self.tp
        if self.mesh is not None and max_len % n:
            raise ValueError(f"capacity {max_len} does not split over tp = "
                             f"{n}")
        shape = (batch, c.n_kv_heads, max_len // n, c.head_dim)
        return [(self._fresh_cache(shape), self._fresh_cache(shape))
                for _ in range(c.n_layers)]

    def _fresh_cache(self, shape):
        """One zero K or V cache (or page pool) of ``shape`` in
        ``config.dtype``, or an int8 dict with unit scales under
        ``kv_quant``; over a mesh, each leaf a list of per-rank tensors
        of ``shape``, views of one allocation."""
        dev = self.device
        lead = () if self.mesh is None else (self.tp,)

        def leaf(shp, dtype, fill):
            t = torch.full(lead + shp, fill, dtype=dtype, device=dev)
            return t if not lead else list(t.unbind(0))

        if self.config.kv_quant is not None:
            return {"q": leaf(shape, torch.int8, 0),
                    "scale": leaf(shape[:3], torch.float32, 1.0)}
        return leaf(shape, self.config.dtype, 0.0)

    def init_paged_cache(self, batch: int, max_len: int, page: int = 1024):
        """Paged twin of :meth:`init_cache`: per-layer (k_pool, v_pool) of
        shape (B·pps, Hkv, page, D) (int8 dicts under ``kv_quant``) and
        one (1, B, pps) int32 block table shared by every layer (the
        dense identity allocation; R = 1 rank)."""
        self._one_rank("init_paged_cache")
        c = self.config
        if max_len % page:
            raise ValueError(f"capacity {max_len} must split into whole "
                             f"{page}-row pages")
        pps = max_len // page
        shape = (batch * pps, c.n_kv_heads, page, c.head_dim)
        caches = [(self._fresh_cache(shape), self._fresh_cache(shape))
                  for _ in range(c.n_layers)]
        return caches, self._identity_table(batch, pps)

    def _identity_table(self, batch, pps):
        return torch.arange(batch * pps, dtype=torch.int32,
                            device=self.device).reshape(1, batch, pps)

    def paginate_caches(self, caches, page: int = 1024):
        """Contiguous (prefill-filled) caches → (page pools, (1, B, pps)
        table): page j of row b becomes pool page b·pps + j (a reshape
        and a copy per plane; the caches are left as they are)."""
        self._one_rank("paginate_caches")
        def split(x):                   # (B, Hkv, S[, D]) → pools
            b, hkv, s = x.shape[:3]
            tail = tuple(x.shape[3:])
            pps = s // page
            y = x.reshape((b, hkv, 1, pps, page) + tail)
            y = torch.movedim(y, (2, 0, 3, 1), (0, 1, 2, 3))
            return y.reshape((b * pps, hkv, page) + tail).contiguous()

        out = []
        for ck, cv in caches:
            lead = ck["q"] if isinstance(ck, dict) else ck
            batch, s = lead.shape[0], lead.shape[2]
            if s % page:
                raise ValueError(f"capacity {s} must split into whole "
                                 f"{page}-row pages")
            if isinstance(ck, dict):
                ck = {name: split(t) for name, t in ck.items()}
                cv = {name: split(t) for name, t in cv.items()}
            else:
                ck, cv = split(ck), split(cv)
            out.append((ck, cv))
        return out, self._identity_table(batch, s // page)

    def prefill(self, params, caches, tokens, lens=None):
        """Process a prompt batch in one forward pass and fill the
        contiguous caches (in place): returns (logits at each row's last
        prompt position (B, vocab) f32, caches, kv_lens (B,) int32).

        ``lens`` (B,) makes the batch ragged: rows are right-padded to S
        and row i's logits are taken at ``lens[i] - 1``, ``lens`` clamped
        to [1, S] (:1014-1021); the pad positions' K/V land past the
        lengths, where decode never reads. MoE blocks run the inference
        engines of :meth:`_mlp_block`. Over a mesh, B·S must split over
        the ranks (the sequence-parallel rows, as JAX asserts), and each
        rank's slice of the sequence lands in its cache shard; under
        context-parallel attention S must split over them too (JAX's
        ``shard_map`` cannot shard it otherwise)."""
        c = self.config
        b, s = tokens.shape
        cap = _cache_capacity(caches)
        if s > cap:
            raise ValueError(f"prompt length {s} exceeds cache capacity {cap}")
        if c.attn != "tp" and s % self.tp:
            raise ValueError(f"prompt length S = {s} does not split over the "
                             f"{self.tp} context-parallel ranks of "
                             f"attn={c.attn!r}; pad the prompts to a "
                             f"multiple of {self.tp}")
        if (b * s) % self.tp:
            raise ValueError(f"B·S = {b * s} rows do not shard over tp = "
                             f"{self.tp} (the sequence-parallel rows)")
        x = self._embed_rows(params, tokens)
        for blk, (ck, cv) in zip(params["blocks"], caches):
            x, k, v = self._block(blk, x, b, s, inference=True)
            _fill_cache(ck, k.transpose(1, 2))        # (B, Hkv, S, D)
            _fill_cache(cv, v.transpose(1, 2))
        if lens is None:
            lens = torch.full((b,), s, dtype=torch.int32, device=x.device)
        lens = torch.clamp(lens.to(device=x.device, dtype=torch.int32), 1, s)
        rows = torch.arange(b, device=x.device)
        x_last = x.reshape(b, s, c.hidden)[rows, lens.long() - 1]
        return self._head(params, x_last), caches, lens

    def decode_step(self, params, caches, kv_lens, last_tokens,
                    moe_state=None, block_table=None):
        """One decode token for every row: (B,) last tokens → ((B, vocab)
        f32 logits, caches, kv_lens + 1). The caches (contiguous, or page
        pools with ``block_table`` (1, B, pps)) are written in place.

        Attention runs over the OLD cache and merges the new token as a
        single-position partial (``combine_partials``): the merge is
        associative, so this equals attending over the appended cache.
        Int8 caches attend the new token quantized and append the same
        (int8, scale) pairs. Projections go through ``_dmm`` (over a
        sharded weight, rank by rank: :meth:`_dmm_tp`). An EP MoE
        block runs ``ep_moe`` on the fused transport, over the persistent
        workspaces of ``moe_state`` (from :meth:`init_decode_state`) when
        given, and the step then returns the next states as a 4th
        result; a TP MoE block runs the per-token expert loop."""
        from triton_distributed_tpu_torch.kernels.flash_decode import (
            combine_partials,
            quantize_kv,
        )
        from triton_distributed_tpu_torch.layers import (
            append_kv,
            paged_append_kv,
        )

        if block_table is not None:
            self._one_rank("paged decode")
        c = self.config
        x = params["embed"][last_tokens.long()].to(c.dtype)      # (B, H)
        b = x.shape[0]
        new_caches = []
        new_states = None if moe_state is None else list(moe_state)
        for li, (blk, (ck, cv)) in enumerate(zip(params["blocks"], caches)):
            xn = self._rmsnorm(x, blk["norm_attn"])
            q, k, v = self._qkv(xn, blk["wqkv"])
            q = q.reshape(b, c.n_heads, c.head_dim)
            k = k.reshape(b, c.n_kv_heads, c.head_dim)
            v = v.reshape(b, c.n_kv_heads, c.head_dim)
            kq_pair = vq_pair = None
            if isinstance(ck, dict):
                kq_pair, vq_pair = quantize_kv(k), quantize_kv(v)
                k = (kq_pair[0].float() * kq_pair[1][..., None]).to(k.dtype)
                v = (vq_pair[0].float() * vq_pair[1][..., None]).to(v.dtype)
            o_c, lse_c = self._sp_attn.partials(q, ck, cv, kv_lens,
                                                block_table)
            o_new, lse_new = self._sp_attn.token_partial(q, k, v)
            o, _ = combine_partials(torch.stack([o_c.float(), o_new]),
                                    torch.stack([lse_c, lse_new]),
                                    out_dtype=o_c.dtype)
            if block_table is None:
                ck, cv, _ = append_kv(ck, cv, kv_lens, k, v,
                                      k_quant=kq_pair, v_quant=vq_pair)
            else:
                ck, cv, _ = paged_append_kv(ck, cv, block_table, kv_lens, k,
                                            v, k_quant=kq_pair,
                                            v_quant=vq_pair)
            new_caches.append((ck, cv))
            x = x + self._proj(o.reshape(b, c.q_dim), blk["wo"], rows=True)
            xn = self._rmsnorm(x, blk["norm_mlp"])
            if "up" in blk:
                h = F.silu(self._proj(xn, blk["up"], rows=False))
                x = x + self._proj(h, blk["down"], rows=True)
            elif c.moe == "ep":
                st = None if moe_state is None else moe_state[li]
                y, st = self._decode_moe_ep(blk, xn, st)
                x = x + y.to(x.dtype)
                if new_states is not None:
                    new_states[li] = st
            else:
                x = x + self._moe_tp(blk, xn).to(x.dtype)
        x = self._rmsnorm(x, params["norm_f"])
        if isinstance(params["lm_head"], dict):
            # W8A16: the logits keep the f32 accumulator
            logits = self._dmm(x, params["lm_head"], out_dtype=torch.float32,
                               act_quant=False)
        else:
            logits = x.float() @ params["lm_head"].float()
        if moe_state is None:
            return logits, new_caches, kv_lens + 1
        return logits, new_caches, kv_lens + 1, new_states

    def generate(self, params, caches, kv_lens, last_tokens, steps: int,
                 moe_state=None, block_table=None):
        """Greedy-decode ``steps`` tokens: returns ((B, steps) int32
        tokens, caches, kv_lens), and the MoE states as a 4th result when
        ``moe_state`` (:meth:`init_decode_state`) is threaded through.
        With ``block_table``, the caches are page pools
        (:meth:`init_paged_cache` / :meth:`paginate_caches`). Raises when
        the longest row would outgrow the capacity (writes past it would
        be dropped)."""
        cap = _serving_capacity(caches, block_table)
        max_len = int(kv_lens.max()) + steps
        if max_len > cap:
            raise ValueError(f"cache capacity {cap} < {max_len} needed — "
                             "writes past capacity are dropped (see "
                             "layers.append_kv)")
        out = []
        for _ in range(steps):
            res = self.decode_step(params, caches, kv_lens, last_tokens,
                                   moe_state=moe_state,
                                   block_table=block_table)
            logits, caches, kv_lens = res[:3]
            if moe_state is not None:
                moe_state = res[3]
            last_tokens = torch.argmax(logits, dim=-1).to(torch.int32)
            out.append(last_tokens)
        toks = torch.stack(out, dim=1)
        if moe_state is None:
            return toks, caches, kv_lens
        return toks, caches, kv_lens, moe_state


def _sharded(w) -> bool:
    """Whether a weight leaf is per-rank shards (a list, or an int8 dict
    of lists)."""
    return isinstance(w, list) or (isinstance(w, dict)
                                   and isinstance(w["q"], list))


def _sum_rank_partials(parts):
    """The ranks' (W, ...) partial products summed in f32 and cast back:
    the TP MoE decode's counterpart of GSPMD's all-reduce."""
    return parts.sum(0, dtype=torch.float32).to(parts.dtype)


def _cache_capacity(caches):
    """Sequence capacity S of a per-layer cache list (plain bhsd tensors
    or int8 dicts, whole or as per-rank slices); for page pools, dim 2
    is the page."""
    ck = caches[0][0]
    lead = ck["q"] if isinstance(ck, dict) else ck
    if isinstance(lead, list):
        return len(lead) * lead[0].shape[2]
    return lead.shape[2]


def _rows(shards):
    """Per-rank row shards, views of one allocation (the kernels'
    symmetric outputs, the plain versions' row blocks), as one (W·m, ...)
    view."""
    from triton_distributed_tpu_torch.lang.shmem import require_stacked

    if torch.is_grad_enabled() and any(t.requires_grad for t in shards):
        # training: a view over the shards' storage would carry every
        # rank's gradient into rank 0's shard alone
        return torch.cat(list(shards))
    st = require_stacked(shards, "the model's row shards")
    return st.reshape(-1, *st.shape[2:])


def _fill_cache(cache, kv):
    """Write prefill's (B, Hkv, S', D) K or V into a cache's first S'
    positions, in place: a tensor, an int8 dict (quantized per row), or
    per-rank slices of the sequence (rank r takes positions [r·S/W,
    (r+1)·S/W) of ``kv``)."""
    if isinstance(cache, dict):
        from triton_distributed_tpu_torch.kernels.flash_decode import (
            quantize_kv,
        )

        q, sc = quantize_kv(kv)
        planes = ((cache["q"], q), (cache["scale"], sc))
    else:
        planes = ((cache, kv),)
    s = kv.shape[2]
    for dst, val in planes:
        if not isinstance(dst, list):
            dst[:, :, :s] = val.to(dst.dtype)
            continue
        s_loc = dst[0].shape[2]
        for r, shard in enumerate(dst):
            n = min(s - r * s_loc, s_loc)
            if n > 0:
                shard[:, :, :n] = val[:, :, r * s_loc:r * s_loc + n].to(
                    shard.dtype)


def _serving_capacity(caches, block_table=None):
    """Capacity in positions: S for contiguous caches, R·pps·page for
    page pools."""
    if block_table is None:
        return _cache_capacity(caches)
    r, _, pps = block_table.shape
    return r * pps * _cache_capacity(caches)


def _leaf_from_numpy(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(tree, cfg: TransformerConfig, device=None,
                      mesh: Mesh | None = None):
    """A JAX parameter tree, passed as numpy arrays (e.g.
    ``jax.tree.map(np.asarray, params)``), as the port's parameter dict
    on ``device``. Plain trees and trees already put through
    ``quantize_dense_weights`` or ``quantize_moe_weights`` (int8
    ``{"q", "scale"}`` dicts), MoE blocks included, carry over bit for
    bit; dtypes are kept. The codes W8A8 multiplies (``_w8a8_keys``)
    land K-major, as the port's quantizers store them. With ``mesh``, JAX's global arrays land on the
    mesh's device as :meth:`Transformer.shard_params` places them."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    if len(tree["blocks"]) != cfg.n_layers:
        raise ValueError(f"tree has {len(tree['blocks'])} blocks, config "
                         f"{cfg.n_layers}")
    if tuple(np.shape(tree["embed"])) != (cfg.vocab, cfg.hidden):
        raise ValueError(f"embed shape {np.shape(tree['embed'])} does not "
                         f"match the config")

    from triton_distributed_tpu_torch.kernels.group_gemm import to_k_major

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return _leaf_from_numpy(node, dev)

    params = conv(tree)
    # the weights W8A8 multiplies are kept K-major, converted once here
    for blk in params["blocks"]:
        for name in _w8a8_keys(cfg):
            if isinstance(blk.get(name), dict):
                blk[name]["q"] = to_k_major(blk[name]["q"])
    if mesh is None:
        return params
    return Transformer(cfg, mesh=mesh, device=device).shard_params(params)


def caches_from_numpy(caches, device=None, mesh: Mesh | None = None):
    """A JAX per-layer cache list, passed as numpy arrays (contiguous
    caches or page pools, plain arrays or int8 ``{"q", "scale"}``
    dicts), as the port's list of (k, v) pairs on ``device``, bit for
    bit. With ``mesh``, each global contiguous (B, Hkv, S[, D]) leaf is
    sequence-sharded over its ``"tp"`` axis as
    :meth:`Transformer.init_cache` shards it: W per-rank slices, views
    of one allocation."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    n = 1 if mesh is None else one_axis(mesh, TP_AXIS)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        t = _leaf_from_numpy(node, dev)
        if mesh is None:
            return t
        if t.shape[2] % n:
            raise ValueError(f"capacity {t.shape[2]} does not split over "
                             f"{n} ranks")
        return list(torch.stack(t.chunk(n, dim=2)).unbind(0))

    return [(conv(k), conv(v)) for k, v in caches]
