"""The dp×tp×cp train step: ring (or Ulysses) attention over cp, Megatron
TP over tp, the wire-quantized gradient ring over dp, Adam.

Port of ``triton_distributed_tpu/train/step.py``. The model is JAX's one
transformer block (embed, wq / wk / wv / wo, a gelu MLP w1 → w2, head; f32
parameters), the step JAX's ``_device_step`` (``:244``):

* each microbatch's summed next-token cross-entropy over ``batch · seq``
  and its gradient, accumulated;
* **cp** shards the sequence; attention runs
  :func:`~triton_distributed_tpu_torch.kernels.ring_attention.
  ring_attention` (``tdt_ring_attention``, the forward saving each row's
  log-sum-exp) or ``ulysses_attention`` over the cp axis, with every
  (dp, tp) rank's blocks folded into the ring's batch;
* **tp** shards the MLP (``w1`` columns, ``w2`` rows). Megatron's
  f-operator (identity forward, sum over tp backward: :class:`_MegatronF`,
  JAX's ``custom_vjp``) sits on the MLP input, and the MLP's partials are
  summed over tp in the forward, whose backward sums the cotangents over
  tp as well (JAX's transpose of ``psum`` under ``shard_map``), so the
  replicated parameters' gradients come out tp-replicated and nothing
  reduces over tp afterwards. The gradients are therefore JAX's, not the
  loss's own: the MLP branch's reaches every parameter tp times
  (:func:`train_step_reference` with ``mlp_grad_scale=tp`` reproduces
  them; ROADMAP Queue 3);
* the gradients sum exactly over cp, then over dp: exactly for
  ``wire_dtype=None``, else on the quantized ring (``tdt_grad_ring``,
  error feedback and stochastic rounding keyed by the dp index, then
  ``tdt_grad_allgather``; :mod:`~triton_distributed_tpu_torch.train.
  grad_wire`), seeded per step;
* Adam (``_adam``, ``:226``) on every rank.

The port runs every rank of the (dp, tp, cp) loopback mesh in one
process on one device: each parameter is a tensor stacked over the ranks,
``(dp, tp, cp, *shard)``, and every rank's forward runs batched over
them. The ranks' parameters, gradients and Adam moments each live in one
flat ``(dp, tp, cp, rows, 128)`` f32 buffer laid out as JAX's
``tree_slab`` lays a rank's gradient tree (leaves by sorted name, rows
padded to a multiple of dp); a parameter is a view of its buffer and its
gradient the same view of the gradient buffer, which autograd
accumulates into and the ring reduces in place. No second copy of the
gradients exists.

There is no degradation: a kernel's error propagates, the report says
``degraded: False, probing: False``, and ``Trainer(health=...)`` raises
(the health ledger and the probation schedule are ROADMAP Queue 1 step
8). The parameters are drawn from a ``torch.Generator`` (the port does
not reproduce ``jax.random``); :func:`params_from_numpy` carries JAX's
across.
"""

from __future__ import annotations

import dataclasses
import math
import warnings

import numpy as np
import torch

from triton_distributed_tpu_torch.config import resolve_device
from triton_distributed_tpu_torch.kernels import cp_ring
from triton_distributed_tpu_torch.kernels.ring_attention import (
    dense_attention_reference,
    ring_attention,
    ulysses_attention,
)
from triton_distributed_tpu_torch.lang import wire as wirelib
from triton_distributed_tpu_torch.runtime.topology import Mesh
from triton_distributed_tpu_torch.train import grad_wire

#: the parameters, in ``jax.tree.flatten``'s order (sorted names)
PARAM_NAMES = ("embed", "head", "w1", "w2", "wk", "wo", "wq", "wv")
#: the grad slab's width (JAX ``tree_slab``'s ``cols``)
SLAB_COLS = 128
#: elements an Adam update touches at once (bounds its temporaries)
_ADAM_CHUNK = 1 << 24


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Static train-step configuration (JAX ``:70``); the defaults are
    JAX's dryrun geometry, a tiny block on dp 2 × tp 2 × cp 2."""

    vocab: int = 64
    d_model: int = 32
    n_heads: int = 4
    d_ff: int = 64
    seq: int = 16
    batch: int = 8
    dp: int = 2
    tp: int = 2
    cp: int = 2
    microbatches: int = 2
    attn: str = "ring"            # "ring" | "ulysses"
    #: the dp gradient ring's wire: None / 'bf16' the exact sum, 'fp8' /
    #: 'int8' pinned (raises where the slab admits no chunking), 'auto'
    wire_dtype: object = "int8"
    ef: bool = True               # error feedback on the ring
    lr: float = 1e-2
    beta1: float = 0.9
    beta2: float = 0.999
    adam_eps: float = 1e-8
    seed: int = 0

    def __post_init__(self):
        wirelib.normalize_wire(self.wire_dtype)   # loud on junk
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} % n_heads "
                             f"{self.n_heads} != 0")
        if self.seq % self.cp:
            raise ValueError(f"seq {self.seq} % cp {self.cp} != 0")
        if self.batch % self.dp:
            raise ValueError(f"batch {self.batch} % dp {self.dp} != 0")
        if (self.batch // self.dp) % self.microbatches:
            raise ValueError(
                f"per-dp batch {self.batch // self.dp} % microbatches "
                f"{self.microbatches} != 0")
        if self.d_ff % self.tp:
            raise ValueError(f"d_ff {self.d_ff} % tp {self.tp} != 0")
        if self.attn not in ("ring", "ulysses"):
            raise ValueError(f"attn must be 'ring'|'ulysses', "
                             f"got {self.attn!r}")
        if self.attn == "ulysses" and self.n_heads % self.cp:
            raise ValueError(f"ulysses needs n_heads {self.n_heads} % "
                             f"cp {self.cp} == 0")


def default_train_mesh(cfg: TrainConfig, device=None) -> Mesh:
    """The (dp, tp, cp) loopback mesh (JAX ``:114``): on the current CUDA
    device unless ``device`` asks for another (``"cpu"``)."""
    return Mesh.grid({"dp": cfg.dp, "tp": cfg.tp, "cp": cfg.cp}, device)


# ------------------------------------------------------------------ model

def _shapes(cfg: TrainConfig) -> dict:
    d, ff, v = cfg.d_model, cfg.d_ff, cfg.vocab
    return {"embed": (v, d), "wq": (d, d), "wk": (d, d), "wv": (d, d),
            "wo": (d, d), "w1": (d, ff), "w2": (ff, d), "head": (d, v)}


def init_params(cfg: TrainConfig, generator: torch.Generator | None = None,
                device=None) -> dict:
    """The block's parameters, f32, unsharded (JAX ``:124``, its scales):
    normal draws from ``generator`` (default: one on ``device`` seeded
    with ``cfg.seed``) in JAX's key order (embed, wq, wk, wv, wo, w1, w2,
    head)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(cfg.seed)
    d, ff = cfg.d_model, cfg.d_ff
    scale = {"embed": 1.0, "w2": ff ** -0.5}
    out = {}
    for name in ("embed", "wq", "wk", "wv", "wo", "w1", "w2", "head"):
        out[name] = torch.randn(_shapes(cfg)[name], generator=generator,
                                device=dev) * scale.get(name, d ** -0.5)
    return out


def init_opt_state(params: dict) -> dict:
    """Adam state (JAX ``:147``): the step count and f32 zero moments."""
    return {"t": 0,
            "m": {k: torch.zeros_like(v, dtype=torch.float32)
                  for k, v in params.items()},
            "v": {k: torch.zeros_like(v, dtype=torch.float32)
                  for k, v in params.items()}}


def _param_specs(cfg: TrainConfig) -> dict:
    """Each parameter's tp-sharded dim (JAX ``:159``): ``w1`` its
    columns, ``w2`` its rows, None (replicated) for the rest."""
    return {k: (1 if k == "w1" else 0 if k == "w2" else None)
            for k in PARAM_NAMES}


def params_from_numpy(params, cfg: TrainConfig | None = None, device=None,
                      opt_state=None):
    """JAX's parameters (and, given ``opt_state``, its Adam state) as
    f32 torch tensors on ``device`` (default: the current CUDA device):
    returns the params dict, or (params, opt_state) with ``opt_state``
    (``t`` an int)."""
    del cfg
    dev = resolve_device(device)

    def conv(tree):
        return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(dev)
                for k, v in tree.items()}

    out = conv(params)
    if opt_state is None:
        return out
    return out, {"t": int(np.asarray(opt_state["t"])),
                 "m": conv(opt_state["m"]), "v": conv(opt_state["v"])}


class _MegatronF(torch.autograd.Function):
    """Megatron's f-operator over the tp dim (dim 1) of the stacked
    ranks (JAX ``_megatron_f``, ``:166``): identity forward, the sum over
    tp of the cotangents backward, so every tp rank holds the full input
    cotangent."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.sum(1, keepdim=True).expand_as(g)


def _token_xent_sum(logits, targets):
    """Summed next-token cross-entropy in f32 over the last two dims'
    rows (JAX ``:189``), one sum a leading index."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    return -ll.flatten(1).sum(1)


def _gelu(x):
    # jax.nn.gelu's default is the tanh approximation
    return torch.nn.functional.gelu(x, approximate="tanh")


def _forward_device(cfg: TrainConfig, params, tokens):
    """Every rank's forward at once (JAX ``:203``): ``params`` stacked
    (dp, tp, cp, *shard), ``tokens`` (dp, tp, cp, b, s) → logits (dp,
    tp, cp, b, s, vocab). Attention over cp, Megatron MLP over tp."""
    dp, tp, cp, b, s = tokens.shape
    rk = dp * tp * cp
    d, h = cfg.d_model, cfg.n_heads
    dh = d // h
    flat = {k: v.reshape(rk, *v.shape[3:]) for k, v in params.items()}
    ranks = torch.arange(rk, device=tokens.device)[:, None, None]
    x = flat["embed"][ranks, tokens.reshape(rk, b, s).long()]
    x = x.reshape(rk, b * s, d)

    def heads(w):
        # (rk, b·s, d) → the ring's stacked blocks (cp, dp·tp·b, s, h, dh)
        y = (x @ flat[w]).reshape(dp, tp, cp, b, s, h, dh)
        return y.permute(2, 0, 1, 3, 4, 5, 6).reshape(cp, dp * tp * b, s, h,
                                                      dh)

    mesh = Mesh.loopback(cp, tokens.device, axis="cp")
    attn = ring_attention if cfg.attn == "ring" else ulysses_attention
    o = attn(heads("wq"), heads("wk"), heads("wv"), mesh, "cp", causal=True)
    o = o.reshape(cp, dp, tp, b, s, d).permute(1, 2, 0, 3, 4, 5)
    x = x + o.reshape(rk, b * s, d) @ flat["wo"]
    xf = _MegatronF.apply(x.reshape(dp, tp, cp, b * s, d))
    part = _gelu(xf.reshape(rk, b * s, d) @ flat["w1"]) @ flat["w2"]
    mlp = part.reshape(dp, tp, cp, b * s, d).sum(1, keepdim=True)
    x = x + mlp.expand(dp, tp, cp, b * s, d).reshape(rk, b * s, d)
    return (x @ flat["head"]).reshape(dp, tp, cp, b, s, cfg.vocab)


def _adam(cfg: TrainConfig, t: int, p, g, m, v):
    """Adam in place on matching f32 tensors (JAX ``_adam``, ``:226``,
    op for op): ``t`` is the step count after this step."""
    b1, b2 = cfg.beta1, cfg.beta2
    tf = torch.tensor(float(t), dtype=torch.float32)
    c1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** tf)
    c2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** tf)
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_((1 - b2) * g * g)
    c1t = m.new_full((), c1)
    c2t = m.new_full((), c2)
    step = cfg.lr * (m / c1t) / (torch.sqrt(v / c2t) + cfg.adam_eps)
    p.sub_(step)


def _adam_chunked(cfg, t, p, g, m, v):
    """:func:`_adam` over flat buffers in chunks (elementwise, so
    the chunking changes no value)."""
    pf, gf, mf, vf = (x.reshape(-1) for x in (p, g, m, v))
    for i in range(0, pf.numel(), _ADAM_CHUNK):
        sl = slice(i, i + _ADAM_CHUNK)
        _adam(cfg, t, pf[sl], gf[sl], mf[sl], vf[sl])


# --------------------------------------------------------------- reference

class _ScaleGrad(torch.autograd.Function):
    """Identity forward, the cotangent times ``s`` backward."""

    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def _reference_loss(cfg: TrainConfig, p, tok, tgt, mlp_grad_scale=1):
    x = p["embed"][tok.long()]
    b, s, d = x.shape
    h = cfg.n_heads

    def heads(w):
        return (x @ p[w]).reshape(b, s, h, d // h)

    o = dense_attention_reference(heads("wq"), heads("wk"), heads("wv"),
                                  causal=True)
    x = x + o.reshape(b, s, d) @ p["wo"]
    mlp = _gelu(x @ p["w1"]) @ p["w2"]
    if mlp_grad_scale != 1:
        mlp = _ScaleGrad.apply(mlp, float(mlp_grad_scale))
    x = x + mlp
    logits = (x @ p["head"])[None]
    return _token_xent_sum(logits, tgt[None])[0] / (cfg.batch * cfg.seq)


def train_step_reference(params, opt_state, tokens, targets,
                         cfg: TrainConfig, *, mlp_grad_scale=1):
    """One single-device reference step (JAX ``:341``): dense attention
    over the whole sequence, the unsharded MLP, exact f32 gradients, the
    same microbatch accumulation and Adam. ``params`` and ``opt_state``
    as :func:`init_params` / :func:`init_opt_state` give them (on one
    device) → (params, opt_state, loss), new tensors.

    ``mlp_grad_scale``: multiply the MLP branch's cotangent by this. JAX's
    distributed step sums the MLP's tp partials with a ``psum`` whose
    transpose (under ``check_vma=False``) is again a ``psum``, so its
    gradients carry the MLP branch ``tp`` times: ``w1`` and ``w2`` ``tp``
    times theirs, the leaves before the MLP the residual's gradient plus
    ``tp`` times the MLP's. :class:`Trainer` keeps JAX's numbers;
    ``mlp_grad_scale=cfg.tp`` gives this reference the same gradients,
    1 (JAX's reference) the loss's own."""
    dev = params["embed"].device
    tokens = torch.as_tensor(np.asarray(tokens), device=dev)
    targets = torch.as_tensor(np.asarray(targets), device=dev)
    mb = tokens.shape[0] // cfg.microbatches
    p = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    grads, loss_sum = None, torch.zeros((), device=dev)
    for i in range(cfg.microbatches):
        sl = slice(i * mb, (i + 1) * mb)
        li = _reference_loss(cfg, p, tokens[sl], targets[sl],
                             mlp_grad_scale)
        gi = torch.autograd.grad(li, [p[k] for k in PARAM_NAMES])
        loss_sum = loss_sum + li.detach()
        grads = (list(gi) if grads is None
                 else [a + b for a, b in zip(grads, gi)])
    t = opt_state["t"] + 1
    m = {k: v.clone() for k, v in opt_state["m"].items()}
    v = {k: x.clone() for k, x in opt_state["v"].items()}
    new = {}
    with torch.no_grad():
        for k, g in zip(PARAM_NAMES, grads):
            new[k] = params[k].detach().clone()
            _adam(cfg, t, new[k], g, m[k], v[k])
    return new, {"t": t, "m": m, "v": v}, float(loss_sum)


# ----------------------------------------------------------------- trainer

def rank_layout(cfg: TrainConfig):
    """A rank's slab layout, JAX's ``tree_slab`` of its gradient tree:
    ({name: (offset, shard shape)} in sorted name order, rows of
    ``SLAB_COLS`` padded to a multiple of dp)."""
    specs = _param_specs(cfg)
    local, off = {}, 0
    for k in PARAM_NAMES:
        shape = list(_shapes(cfg)[k])
        if specs[k] is not None:
            shape[specs[k]] //= cfg.tp
        local[k] = (off, tuple(shape))
        off += math.prod(shape)
    rows = -(-off // SLAB_COLS)
    return local, rows + (-rows) % cfg.dp


def make_batch(cfg: TrainConfig, step: int):
    """The synthetic LM batch of ``step`` (JAX ``Trainer.make_batch``,
    ``:425``, the same numpy draws): (tokens, targets) (batch, seq)
    int32, targets the sequence rolled left."""
    rng = np.random.RandomState((cfg.seed * 100003 + step) % (2 ** 31 - 1))
    tokens = rng.randint(0, cfg.vocab,
                         size=(cfg.batch, cfg.seq)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1).astype(np.int32)


class Trainer:
    """Stateful dp×tp×cp trainer on a loopback mesh (JAX ``:352``):
    stacked parameters and Adam state, a step counter. ``params`` /
    ``opt_state``: start from these (unsharded, e.g. JAX's through
    :func:`params_from_numpy`) instead of :func:`init_params`' draws.
    ``health`` raises: degradation is ROADMAP Queue 1 step 8."""

    def __init__(self, cfg: TrainConfig, mesh: Mesh | None = None,
                 health=None, *, params=None, opt_state=None):
        if health is not None:
            raise NotImplementedError(
                "Trainer(health=...): the health ledger, the grad ring's "
                "degradation to the exact sum and its probation are ROADMAP "
                "Queue 1 step 8; the port's trainer does not degrade")
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else default_train_mesh(cfg)
        for ax in ("dp", "tp", "cp"):
            if self.mesh.shape.get(ax) != getattr(cfg, ax):
                raise ValueError(
                    f"mesh axis {ax!r} is {self.mesh.shape.get(ax)}, "
                    f"TrainConfig wants {getattr(cfg, ax)}")
        if self.mesh.size != cfg.dp * cfg.tp * cfg.cp:
            raise ValueError(f"the mesh has axes beside dp, tp and cp: "
                             f"{self.mesh.shape}")
        self.device = self.mesh.device
        if params is None:
            params = init_params(cfg, device=self.device)
        shapes = _shapes(cfg)
        total = sum(math.prod(s) for s in shapes.values())
        rows = -(-total // SLAB_COLS)
        self.slab_rows = rows + (-rows) % cfg.dp
        self.wire = grad_wire.resolve_grad_wire(cfg.wire_dtype,
                                                self.slab_rows, SLAB_COLS,
                                                cfg.dp)
        self.base_seed = grad_wire.derive_seed(cfg.seed, "train.dp_ring")
        self._layout(params, opt_state)
        self.step_count = 0

    def _layout(self, params, opt_state):
        """The flat buffers and the stacked views (module docstring)."""
        cfg = self.cfg
        self._local, self.rank_rows = rank_layout(cfg)
        lead = (cfg.dp, cfg.tp, cfg.cp)
        size = self.rank_rows * SLAB_COLS
        dev = self.device
        self._p = torch.zeros((*lead, size), dtype=torch.float32, device=dev)
        self._g = torch.zeros_like(self._p)
        self._m = torch.zeros_like(self._p)
        self._v = torch.zeros_like(self._p)
        self.params = {k: self._view(self._p, k) for k in PARAM_NAMES}
        opt = opt_state or {"t": 0, "m": None, "v": None}
        self.t = int(opt["t"])
        with torch.no_grad():
            for k in PARAM_NAMES:
                self._place(self.params[k], params[k], k)
                if opt["m"] is not None:
                    self._place(self._view(self._m, k), opt["m"][k], k)
                    self._place(self._view(self._v, k), opt["v"][k], k)
        for k, p in self.params.items():
            p.requires_grad_(True)
            p.grad = self._view(self._g, k)

    def _view(self, buf, k):
        off, shape = self._local[k]
        c = self.cfg
        return buf[..., off:off + math.prod(shape)].view(c.dp, c.tp, c.cp,
                                                         *shape)

    def _place(self, dst, full, k):
        """Copy an unsharded tensor into every rank's slot of ``dst``."""
        dim = _param_specs(self.cfg)[k]
        full = full.to(self.device, torch.float32)
        if dim is None:
            dst.copy_(full.expand(dst.shape))
            return
        shards = torch.stack(full.chunk(self.cfg.tp, dim=dim))
        dst.copy_(shards[None, :, None].expand(dst.shape))

    def global_params(self) -> dict:
        """Every parameter unsharded, from rank (0, ·, 0) (the tp shards
        of ``w1`` / ``w2`` concatenated)."""
        out = {}
        for k, dim in _param_specs(self.cfg).items():
            p = self.params[k].detach()
            out[k] = (p[0, 0, 0].clone() if dim is None
                      else torch.cat(list(p[0, :, 0].unbind(0)), dim=dim))
        return out

    # -- data ---------------------------------------------------------

    def make_batch(self, step: int):
        """:func:`make_batch` of the trainer's configuration."""
        return make_batch(self.cfg, step)

    def _shard(self, x, i):
        """Microbatch ``i`` of a (batch, seq) array as every rank's
        (dp, tp, cp, b, s) block."""
        c = self.cfg
        mb = c.batch // c.dp // c.microbatches
        s = c.seq // c.cp
        t = torch.as_tensor(np.asarray(x), device=self.device)
        t = t.reshape(c.dp, c.microbatches, mb, c.cp, s)[:, i]
        return t.permute(0, 2, 1, 3)[:, None].expand(c.dp, c.tp, c.cp, mb, s)

    # -- stepping -----------------------------------------------------

    def _sum_over(self, dim):
        """The exact sum of the gradient buffer over its rank dim ``dim``
        (0 dp, 1 tp, 2 cp), in place: every rank of the axis holds it."""
        g = self._g.movedim(dim, 0)
        for j in range(1, g.shape[0]):
            g[0] += g[j]
        for j in range(1, g.shape[0]):
            g[j].copy_(g[0])

    def _run(self, tokens, targets) -> float:
        """One step on every rank (JAX's ``_device_step``, ``:244``):
        each microbatch's loss summed over the ranks and its gradient
        accumulated into the flat buffer, the exact sum over cp, the dp
        ring (or the exact sum), Adam; returns the global loss."""
        c = self.cfg
        n_total = c.batch * c.seq
        self._g.zero_()
        loss_sum = torch.zeros((c.dp, c.tp, c.cp), device=self.device)
        with warnings.catch_warnings():
            # the gradients are views of the flat buffer, whose strides
            # differ from a dense tensor's
            warnings.filterwarnings("ignore", "grad and param do not obey")
            for i in range(c.microbatches):
                logits = _forward_device(c, self.params,
                                         self._shard(tokens, i))
                tgt = self._shard(targets, i)
                li = _token_xent_sum(
                    logits.reshape(-1, *logits.shape[3:]),
                    tgt.reshape(-1, *tgt.shape[3:])).reshape(
                        c.dp, c.tp, c.cp) / n_total
                li.sum().backward()
                loss_sum += li.detach()
                del logits, li
        with torch.no_grad():
            self._sum_over(2)                          # cp: exact
            if c.dp > 1:
                if self.wire is None:
                    self._sum_over(0)
                else:
                    x = self._g.view(c.dp, c.tp * c.cp, self.rank_rows,
                                     SLAB_COLS).transpose(0, 1)
                    # the SR seed varies per step (JAX folds the step count)
                    seed = self.base_seed + self.t
                    red = cp_ring.grad_ring(x, wire=self.wire, seed=seed,
                                            ef=c.ef)
                    cp_ring.grad_allgather(red, wire=self.wire, seed=seed + 1,
                                           out=x)
                    del red
            self.t += 1
            _adam_chunked(c, self.t, self._p, self._g, self._m, self._v)
        # the loss: every (dp, cp) rank's sum, from tp rank 0
        return float(loss_sum[:, 0].sum())

    def step(self, tokens=None, targets=None) -> dict:
        """One train step (a synthetic batch when none is given) → a report:
        the loss and the wire; ``degraded`` and ``probing`` are always
        False (the port does not degrade)."""
        if tokens is None:
            tokens, targets = self.make_batch(self.step_count)
        loss = self._run(tokens, targets)
        report = {"step": self.step_count, "loss": loss, "wire": self.wire,
                  "degraded": False, "probing": False}
        self.step_count += 1
        return report

    def run(self, steps: int) -> list:
        """``steps`` synthetic-batch steps → their reports."""
        return [self.step() for _ in range(steps)]

    def opt_state(self) -> dict:
        """The Adam state unsharded, as :func:`init_opt_state` shapes it."""
        out = {"t": self.t, "m": {}, "v": {}}
        for name, buf in (("m", self._m), ("v", self._v)):
            for k, dim in _param_specs(self.cfg).items():
                p = self._view(buf, k)
                out[name][k] = (p[0, 0, 0].clone() if dim is None else
                                torch.cat(list(p[0, :, 0].unbind(0)),
                                          dim=dim))
        return out

    # -- reporting ----------------------------------------------------

    def wire_report(self) -> dict:
        """Per-step dp-ring wire bytes of one rank (JAX ``:514``): the bf16
        baseline against the resolved wire, and their ratio."""
        bf16 = grad_wire.ring_wire_bytes(self.slab_rows, SLAB_COLS,
                                         self.cfg.dp, None)
        wired = grad_wire.ring_wire_bytes(self.slab_rows, SLAB_COLS,
                                          self.cfg.dp, self.wire)
        return {"slab_rows": self.slab_rows, "bf16_bytes": bf16,
                "wire_bytes": wired,
                "ratio": (bf16 / wired) if wired else math.nan}
