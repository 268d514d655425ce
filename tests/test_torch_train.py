"""Parity of the port's training path with the JAX package, on the CPU.

* The stochastic-rounding quantizer on JAX's own uniforms: codes and
  scales equal JAX's ``quantize_slab_sr``.
* The gradient ring (``ef_ring_reduce_scatter``, ``grad_allreduce_device``)
  on JAX's uniforms against JAX's XLA body at n = 2, 4, 8, int8 and fp8,
  error feedback on and off: every element within n f32 ulps of the
  largest sum (JAX's jitted body contracts some dequantize-adds into
  FMAs and not others; the port fuses every one), except where such a
  one-ulp difference meets a rounding tie and moves a code by one step
  (at most 1 element in 2000); the all-reduce's ranks are bit-identical.
* The deterministic mode (no feedback, round to nearest, make_wire_format's
  chunk) bit-equal to JAX's TPU kernels ``_grad_ring_kernel_w`` / ``_w3``,
  run interpreted under ``shard_map`` at n = 2 and 4.
* JAX's properties on the port's own hash RNG: EF's aggregate error below
  the no-EF control and sublinear in hops; the same seed the same bits,
  another seed other bits; ``resolve_grad_wire``'s contract.
* The overlap ops' gradients (exact duals, ``save_gathered`` on and off)
  against JAX's ``custom_vjp`` at 4 ranks in f32 (1e-5 of the largest
  gradient); the quantized duals within JAX's 5e-2 pins.
* ``Trainer``: with ``wire_dtype=None`` and JAX's parameters carried
  across, losses within 1e-5 of JAX's ``Trainer`` over 3 steps, the
  first step's Adam moments within 1e-5 of their largest, and the
  parameters within 1e-5 (where JAX's first
  gradient exceeds 1e-6: Adam's first step, ``lr·g/(|g| + eps)``, turns an
  f32 rounding of a gradient near eps into up to lr); on int8 and with
  Ulysses, within JAX's TOL = 0.05 of ``train_step_reference`` (step 0
  within 1e-4), deterministic, the wire halving the ring's bytes.
* ``Transformer.train_step`` at tp = 1 and on a 4-rank loopback mesh
  against JAX's at tp = 1 and 4 (an SGD step of lr 1, so that old − new
  is the gradient): loss within 1e-6, gradients and new parameters
  within 1e-6 of the largest.
* Every refusal names its ROADMAP step.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from triton_distributed_tpu import config as jconfig
from triton_distributed_tpu.kernels import cp_ring as jcp
from triton_distributed_tpu.lang import wire as jwire
from triton_distributed_tpu.models import Transformer as JTransformer
from triton_distributed_tpu.models import presets as jpresets
from triton_distributed_tpu.ops import overlap as jov
from triton_distributed_tpu.train import grad_wire as jgw
from triton_distributed_tpu.train import step as jstep
from triton_distributed_tpu.tune.schedule import RingSchedule as JRing
from triton_distributed_tpu_torch.kernels import cp_ring
from triton_distributed_tpu_torch.kernels import ag_gemm as tag
from triton_distributed_tpu_torch.lang import wire as twire
from triton_distributed_tpu_torch.layers import MoETPMLP
from triton_distributed_tpu_torch.models import Transformer, params_from_numpy
from triton_distributed_tpu_torch.models import presets
from triton_distributed_tpu_torch.ops import MoETPContext
from triton_distributed_tpu_torch.ops import overlap as tov
from triton_distributed_tpu_torch.runtime import Mesh
from triton_distributed_tpu_torch.train import grad_wire as tgw
from triton_distributed_tpu_torch.train import step as tstep
from triton_distributed_tpu_torch.tune.schedule import RingSchedule


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jmesh(n, axis="x"):
    return JMesh(np.asarray(jax.devices()[:n]), (axis,))


def _tmesh(n, axis="x"):
    return Mesh.loopback(n, "cpu", axis=axis)


def _jax_draws(seed, n, hops, srows, cols):
    """JAX's ring uniforms, (n, hops, srows, cols):
    ``uniform(fold_in(fold_in(PRNGKey(seed), me), h), (srows, cols))``
    (``train/grad_wire.py:160,172``)."""
    return np.stack([np.stack([np.asarray(jax.random.uniform(
        jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), me),
                           h), (srows, cols), dtype=jnp.float32))
        for h in range(hops)]) for me in range(n)])


def _jax_ag_draws(seed, n, srows, cols):
    """The all-gather half's uniforms, (n, srows, cols):
    ``uniform(fold_in(PRNGKey(seed), me), (srows, cols))``."""
    return np.stack([np.asarray(jax.random.uniform(
        jax.random.fold_in(jax.random.PRNGKey(seed), me), (srows, cols),
        dtype=jnp.float32)) for me in range(n)])


def _partials(n, srows, cols, seed):
    rng = np.random.RandomState(seed)
    return rng.standard_normal((n, n * srows, cols)).astype(np.float32)


def _ulp_bound(ref, n):
    """n f32 ulps of the largest |value|."""
    return n * float(np.spacing(np.float32(np.abs(ref).max())))


def _one_step(ref, wire):
    """The largest step one code can take at the sums' magnitude: a
    scale (amax / 127) for int8, an eighth of the value for fp8 e4m3."""
    return float(np.abs(ref).max()) * (1 / 127 if wire == "int8" else
                                       1 / 8) * 1.01


# ------------------------------------------------ stochastic rounding


class TestQuantizeSR:
    @pytest.mark.parametrize("quant,chunk", [("int8", 1), ("int8", 8),
                                             ("fp8", 1)])
    def test_codes_equal_jax_on_its_uniforms(self, quant, chunk):
        rows, cols = 16, 96
        x = np.random.RandomState(5).standard_normal(
            (rows, cols)).astype(np.float32) * 3
        key = jax.random.PRNGKey(9)
        jfmt = jwire.WireFormat(quant=quant, chunk_rows=chunk)
        jq, js = jwire.quantize_slab_sr(jnp.asarray(x), jfmt, key)
        u = np.asarray(jax.random.uniform(key, (rows // chunk, chunk * cols),
                                          dtype=jnp.float32))
        q, s = twire.quantize_slab_sr(
            torch.from_numpy(x), twire.WireFormat(quant, chunk),
            uniforms=torch.from_numpy(u.reshape(rows, cols).copy()))
        np.testing.assert_array_equal(np.asarray(js)[:, 0], s.numpy())
        if quant == "int8":
            np.testing.assert_array_equal(np.asarray(jq), q.numpy())
        else:
            np.testing.assert_array_equal(
                np.asarray(jq).view(np.uint8), q.view(torch.uint8).numpy())

    def test_hash_uniforms_are_in_range_and_seeded(self):
        a = twire.sr_uniforms(3, 1, 2, 64, 128)
        b = twire.sr_uniforms(3, 1, 2, 64, 128)
        c = twire.sr_uniforms(3, 1, 3, 64, 128)
        assert torch.equal(a, b) and not torch.equal(a, c)
        assert float(a.min()) >= 0.0 and float(a.max()) < 1.0
        assert abs(float(a.mean()) - 0.5) < 0.01
        # a row offset is the same draw as the rows it skips
        assert torch.equal(twire.sr_uniforms(3, 1, 2, 8, 128, row0=56), a[56:])

    def test_fma_f32_rounds_once(self):
        # 2^-24 · (1 + 2^-23) lies a hair above half an ulp of 1: one
        # rounding gives 1 + 2^-23; two (through the f64 sum) give 1
        a = torch.tensor([1.0], dtype=torch.float32)
        b = torch.tensor([2.0 ** -24 * (1 + 2.0 ** -23)], dtype=torch.float32)
        c = torch.tensor([1.0], dtype=torch.float32)
        assert twire.fma_f32(a, b, c).item() == 1.0 + 2.0 ** -23


# ------------------------------------------------------ the grad ring


@functools.lru_cache(maxsize=None)
def _jax_rs(n, wire, ef, srows=8, cols=128, seed=7):
    x = _partials(n, srows, cols, seed=n)
    run = jax.jit(jax.shard_map(
        lambda a: jgw.ef_ring_reduce_scatter(a, "x", n=n, wire=wire,
                                             seed=seed, ef=ef),
        mesh=_jmesh(n), in_specs=P("x"), out_specs=P("x"), check_vma=False))
    out = np.asarray(run(jnp.asarray(x.reshape(n * n * srows, cols))))
    return x, out.reshape(n, srows, cols)


@functools.lru_cache(maxsize=None)
def _jax_allreduce(n, wire, ef, srows=8, cols=128, seed=5):
    x = _partials(n, srows, cols, seed=10 + n)
    run = jax.jit(jax.shard_map(
        lambda a: jgw.grad_allreduce_device(a, "x", n=n, wire=wire,
                                            seed=seed, ef=ef),
        mesh=_jmesh(n), in_specs=P("x"), out_specs=P("x"), check_vma=False))
    out = np.asarray(run(jnp.asarray(x.reshape(n * n * srows, cols))))
    return x, out.reshape(n, n * srows, cols)


class TestGradRingParity:
    @pytest.mark.parametrize("ef", [True, False])
    @pytest.mark.parametrize("wire", ["int8", "fp8"])
    @pytest.mark.parametrize("n", [2, 4, 8])
    def test_ef_ring_on_jax_uniforms(self, n, wire, ef):
        x, jout = _jax_rs(n, wire, ef)
        u = (torch.from_numpy(_jax_draws(7, n, n - 1, 8, 128))
             if wire == "int8" else None)
        out = tgw.ef_ring_reduce_scatter(
            torch.from_numpy(x), _tmesh(n), "x", wire=wire, seed=7, ef=ef,
            uniforms=u).numpy()
        d = np.abs(out - jout)
        over = d > _ulp_bound(jout, n)
        # a code moves only where a one-ulp difference upstream meets a
        # rounding tie (with feedback, n = 8: 1-2 of 8192 elements), by
        # one step of its hop
        assert over.sum() <= d.size // 2000, over.sum()
        assert d.max() <= _one_step(jout, wire)

    @pytest.mark.parametrize("ef", [True, False])
    @pytest.mark.parametrize("wire", ["int8", "fp8"])
    @pytest.mark.parametrize("n", [2, 4, 8])
    def test_allreduce_on_jax_uniforms(self, n, wire, ef):
        x, jout = _jax_allreduce(n, wire, ef)
        u = None
        if wire == "int8":
            u = (torch.from_numpy(_jax_draws(5, n, n - 1, 8, 128)),
                 torch.from_numpy(_jax_ag_draws(6, n, 8, 128)))
        out = tgw.grad_allreduce_device(
            torch.from_numpy(x), _tmesh(n), "x", wire=wire, seed=5, ef=ef,
            uniforms=u).numpy()
        for r in range(1, n):                 # every rank the same bits
            np.testing.assert_array_equal(out[r], out[0])
        d = np.abs(out - jout)
        # the all-gather requantizes the reduced stripes: a one-ulp
        # difference there may move a code by one step at a rounding tie
        assert d.max() <= _one_step(jout, wire)
        assert (d > _ulp_bound(jout, n)).sum() <= d.size // 2000

    def test_kernel_dispatch_on_cpu_is_the_plain_version(self):
        x = torch.from_numpy(_partials(4, 8, 128, 3))
        a = cp_ring.grad_ring(x, wire="int8", seed=4)
        b = cp_ring.grad_ring_plain(x, wire="int8", seed=4)
        assert torch.equal(a, b)
        g = torch.stack([x, x.flip(0)])             # two rings at once
        both = cp_ring.grad_ring(g, wire="int8", seed=4)
        assert torch.equal(both[0], a)


@functools.lru_cache(maxsize=None)
def _jax_lint(n, depth):
    g = jcp.CP_RING_GEOM
    fn = jcp.build_grad_ring_lint(
        _jmesh(n), n, schedule=None if depth == 2 else JRing(depth=3))
    x = np.random.default_rng(n).standard_normal(
        (n, g["rows"] * n, g["grad_cols"])).astype(np.float32)
    run = jax.jit(jax.shard_map(fn, mesh=_jmesh(n), in_specs=(P("x"),),
                                out_specs=P("x"), check_vma=False))
    out = run(jnp.asarray(x.reshape(n * g["rows"] * n, g["grad_cols"])))
    return x, np.asarray(out[0]).reshape(n, g["rows"], g["grad_cols"])


class TestGradRingTpuKernel:
    @pytest.mark.parametrize("n,depth", [(2, 2), (2, 3), (4, 2), (4, 3)])
    def test_deterministic_mode_equals_the_tpu_kernel(self, n, depth):
        x, jout = _jax_lint(n, depth)
        m_local = cp_ring.CP_RING_GEOM["rows"]
        fmt = twire.make_wire_format("int8", m_local)
        out = cp_ring.grad_ring(
            torch.from_numpy(x), wire="int8", ef=False, stochastic=False,
            chunk_rows=fmt.chunk_rows,
            schedule=RingSchedule(depth=depth)).numpy()
        np.testing.assert_array_equal(out, jout)


# ------------------------------------------- properties, on the hash RNG


def _rs_errors(n, seed, ef, srows=8, cols=128):
    x = torch.from_numpy(_partials(n, srows, cols, seed))
    exact = x.sum(0).reshape(n, srows, cols)
    out = tgw.ef_ring_reduce_scatter(x, _tmesh(n), "x", wire="int8",
                                     seed=seed + 7, ef=ef)
    err = (out - exact).numpy()
    return float(np.abs(err).mean()), float(np.abs(err.sum(0)).mean())


class TestGradRingProperties:
    @pytest.mark.parametrize("n", [4, 8])
    def test_ef_aggregate_error_below_no_ef_control(self, n):
        ef = np.mean([_rs_errors(n, s, True)[1] for s in (0, 1, 2)])
        ctl = np.mean([_rs_errors(n, s, False)[1] for s in (0, 1, 2)])
        assert ef < ctl, (ef, ctl)

    def test_ef_aggregate_error_sublinear_in_hops(self):
        ef4 = np.mean([_rs_errors(4, s, True)[1] for s in (0, 1, 2)])
        ef8 = np.mean([_rs_errors(8, s, True)[1] for s in (0, 1, 2)])
        assert ef8 / ef4 < 7.0 / 3.0, (ef4, ef8)

    def test_same_seed_same_bits_other_seed_other_bits(self):
        x = torch.from_numpy(_partials(4, 16, 128, 2))
        mesh = _tmesh(4)
        a = tgw.grad_allreduce_device(x, mesh, "x", wire="int8", seed=11)
        b = tgw.grad_allreduce_device(x, mesh, "x", wire="int8", seed=11)
        c = tgw.grad_allreduce_device(x, mesh, "x", wire="int8", seed=12)
        assert torch.equal(a, b) and not torch.equal(a, c)
        exact = x.sum(0)
        assert float((a[0] - exact).abs().max()) < 3e-2 * float(
            exact.abs().max())

    def test_wire_none_is_the_exact_sum(self):
        x = torch.from_numpy(_partials(4, 8, 128, 1))
        out = tgw.grad_allreduce_device(x, _tmesh(4), "x", wire=None, seed=0)
        assert torch.equal(out[2], x.sum(0))

    def test_tree_allreduce_keeps_shapes(self):
        rng = np.random.RandomState(0)
        tree = {"b": torch.from_numpy(rng.standard_normal((2, 3, 5))
                                      .astype(np.float32)),
                "a": torch.from_numpy(rng.standard_normal((2, 7))
                                      .astype(np.float32))}
        out = tgw.grad_tree_allreduce(tree, _tmesh(2), "x", wire="int8",
                                      seed=1)
        assert out["b"].shape == (2, 3, 5) and out["a"].shape == (2, 7)
        assert torch.equal(out["a"][0], out["a"][1])
        assert float((out["a"][0] - tree["a"].sum(0)).abs().max()) < 0.1


class TestResolveContract:
    @pytest.mark.parametrize("wire,rows,cols,n", [
        ("auto", 6, 128, 8), ("auto", 64, 128, 8), ("fp8", 64, 128, 8),
        ("int8-mxu", 64, 128, 8), (None, 64, 128, 8), ("bf16", 64, 128, 8),
        ("auto", 64, 128, 1), ("int8", 64, 128, 1), ("auto", 64, 3, 8)])
    def test_resolve_equals_jax(self, wire, rows, cols, n):
        assert (tgw.resolve_grad_wire(wire, rows, cols, n)
                == jgw.resolve_grad_wire(wire, rows, cols, n))

    def test_pinned_ineligible_raises(self):
        with pytest.raises(ValueError, match="pinned wire format"):
            tgw.resolve_grad_wire("int8", 6, 128, 8)

    def test_ring_wire_bytes_equal_jax(self):
        for wire in (None, "int8", "fp8"):
            assert (tgw.ring_wire_bytes(96, 128, 2, wire)
                    == jgw.ring_wire_bytes(96, 128, 2, wire))


# --------------------------------------------------- the overlap ops


def _overlap_grads_jax(op, a, b, **kw):
    mesh = _jmesh(4)
    make = (jov.create_ag_gemm_context if op == "ag_gemm"
            else jov.create_gemm_rs_context)
    ctx = make(mesh, "x", **kw)
    fn = getattr(jov, op)
    w = np.random.RandomState(7).standard_normal(
        (a.shape[0], b.shape[1])).astype(np.float32)

    def f(a_, b_):
        return jnp.sum(fn(a_, b_, ctx) * w)

    budget = jconfig.config.fused_vmem_budget
    # the XLA engines: the same f32 math as the interpreted fused rings
    jconfig.config.fused_vmem_budget = 0
    try:
        da, db = jax.grad(f, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    finally:
        jconfig.config.fused_vmem_budget = budget
    return np.asarray(da), np.asarray(db), w


def _overlap_grads_port(op, a, b, w, **kw):
    n = 4
    mesh = _tmesh(n)
    make = (tov.create_ag_gemm_context if op == "ag_gemm"
            else tov.create_gemm_rs_context)
    ctx = make(mesh, "x", **kw)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    if op == "ag_gemm":
        sa, sb = at.chunk(n, 0), bt.chunk(n, 1)
    else:
        sa, sb = at.chunk(n, 1), bt.chunk(n, 0)
    sa = [t.clone().requires_grad_() for t in sa]
    sb = [t.clone().requires_grad_() for t in sb]
    out = getattr(tov, op)(sa, sb, ctx)
    wt = torch.from_numpy(w)
    ws = wt.chunk(n, 1) if op == "ag_gemm" else wt.chunk(n, 0)
    sum((o * wr).sum() for o, wr in zip(out, ws)).backward()
    cat_a = 0 if op == "ag_gemm" else 1
    return (torch.cat([t.grad for t in sa], cat_a).numpy(),
            torch.cat([t.grad for t in sb], 1 - cat_a).numpy())


_A = np.random.RandomState(1).standard_normal((64, 32)).astype(np.float32)
_B = np.random.RandomState(2).standard_normal((32, 128)).astype(np.float32)
_A2 = np.random.RandomState(3).standard_normal((64, 256)).astype(np.float32)
_B2 = np.random.RandomState(4).standard_normal((256, 128)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_overlap(op, wire):
    a, b = (_A, _B) if op == "ag_gemm" else (_A2, _B2)
    return _overlap_grads_jax(op, a, b, bwd_wire_dtype=wire)


class TestOverlapGrads:
    @pytest.mark.parametrize("save", [True, False])
    @pytest.mark.parametrize("op", ["ag_gemm", "gemm_rs"])
    def test_exact_duals_equal_jax(self, op, save):
        jda, jdb, w = _jax_overlap(op, None)
        a, b = (_A, _B) if op == "ag_gemm" else (_A2, _B2)
        da, db = _overlap_grads_port(op, a, b, w, save_gathered=save)
        assert np.abs(da - jda).max() <= 1e-5 * np.abs(jda).max()
        assert np.abs(db - jdb).max() <= 1e-5 * np.abs(jdb).max()

    @pytest.mark.parametrize("wire", ["int8", "fp8"])
    @pytest.mark.parametrize("op", ["ag_gemm", "gemm_rs"])
    def test_quantized_duals_within_jax_pins(self, op, wire):
        jda, jdb, w = _jax_overlap(op, None)
        a, b = (_A, _B) if op == "ag_gemm" else (_A2, _B2)
        da, db = _overlap_grads_port(op, a, b, w, bwd_wire_dtype=wire)
        assert np.abs(da - jda).max() < 5e-2 * np.abs(jda).max()
        assert np.abs(db - jdb).max() < 5e-2 * max(np.abs(jdb).max(), 1.0)

    def test_world_size_one_equals_autograd(self):
        a = torch.from_numpy(_A).requires_grad_()
        b = torch.from_numpy(_B).requires_grad_()
        (tov.ag_gemm(a, b, tov.OverlapContext()) ** 2).sum().backward()
        a2 = torch.from_numpy(_A).requires_grad_()
        b2 = torch.from_numpy(_B).requires_grad_()
        ((a2 @ b2) ** 2).sum().backward()
        assert torch.allclose(a.grad, a2.grad, rtol=1e-6, atol=1e-5)
        assert torch.allclose(b.grad, b2.grad, rtol=1e-6, atol=1e-5)

    def test_return_gathered_is_the_concatenation(self):
        a = [torch.from_numpy(t.copy()) for t in np.split(_A, 4)]
        b = [torch.from_numpy(t.copy()) for t in np.split(_B, 4, axis=1)]
        _, full = tag.ag_gemm(a, b, _tmesh(4), "x", return_gathered=True)
        for f in full:
            assert torch.equal(f, torch.from_numpy(_A))

    @pytest.mark.parametrize("wire", ["int8", "int8-mxu"])
    def test_return_gathered_on_a_wire(self, wire):
        """JAX's fused engines' gathered A on a wire: the own shard
        exact, the peers' dequantized at the plan's chunk."""
        g = torch.Generator().manual_seed(3)
        a = [torch.randn(64, 256, generator=g) for _ in range(2)]
        b = [torch.randn(256, 128, generator=g) for _ in range(2)]
        mesh = _tmesh(2)
        _, full = tag.ag_gemm(a, b, mesh, "x", wire_dtype=wire,
                              return_gathered=True)
        plan = tag.resolve_ag_gemm_plan(mesh, "x", a, b, wire_dtype=wire)
        fmt = twire.make_wire_format(wire, 64, chunk_rows=plan.chunk_rows)
        deq = [twire.dequantize_slab(*twire.quantize_slab(t, fmt), fmt,
                                     torch.float32) for t in a]
        assert torch.equal(full[0], torch.cat([a[0], deq[1]]))
        assert torch.equal(full[1], torch.cat([deq[0], a[1]]))

    def test_auto_bwd_wire_demotes_and_pinned_refuses(self):
        ctx = tov.create_ag_gemm_context(_tmesh(8), "x",
                                         bwd_wire_dtype="auto")
        assert tov._resolve_bwd(ctx, 6, 32) is None
        ctx = tov.create_ag_gemm_context(_tmesh(8), "x",
                                         bwd_wire_dtype="int8")
        with pytest.raises(ValueError, match="pinned wire format"):
            tov._resolve_bwd(ctx, 6, 32)


# ------------------------------------------------------------ trainer


@functools.lru_cache(maxsize=None)
def _jax_trainer_run():
    cfg = jstep.TrainConfig(wire_dtype=None)
    tr = jstep.Trainer(cfg)
    p0 = jax.tree.map(np.asarray, jstep.init_params(cfg))
    losses, params, m, v = [], [], [], []
    for _ in range(3):
        losses.append(tr.step()["loss"])
        params.append({k: np.asarray(x) for k, x in tr.params.items()})
        m.append({k: np.asarray(x) for k, x in tr.opt_state["m"].items()})
        v.append({k: np.asarray(x) for k, x in tr.opt_state["v"].items()})
    return p0, losses, params, m, v


def _port_trainer(cfg, **kw):
    return tstep.Trainer(cfg, mesh=tstep.default_train_mesh(cfg, "cpu"), **kw)


def _reference_losses(cfg, batches):
    params = tstep.init_params(cfg, device="cpu")
    opt = tstep.init_opt_state(params)
    out = []
    for tok, tgt in batches:
        params, opt, loss = tstep.train_step_reference(params, opt, tok, tgt,
                                                       cfg)
        out.append(loss)
    return out


class TestTrainer:
    STEPS = 4
    TOL = 0.05          # JAX's pinned |loss_dist - loss_ref| per step

    def test_exact_wire_equals_jax_trainer(self):
        p0, losses, params, m, v = _jax_trainer_run()
        cfg = tstep.TrainConfig(wire_dtype=None)
        tr = _port_trainer(cfg, params=tstep.params_from_numpy(p0, cfg,
                                                               "cpu"))
        g0 = {k: np.abs(m[0][k]) / (1 - cfg.beta1) for k in m[0]}
        for i in range(3):
            r = tr.step()
            assert r["degraded"] is False and r["probing"] is False
            assert abs(r["loss"] - losses[i]) <= 1e-5
            got = tr.global_params()
            opt = tr.opt_state()
            for k in params[i]:
                well = g0[k] > 1e-6
                d = np.abs(got[k].numpy() - params[i][k])
                assert d[well].max() <= 1e-5, (i, k, d.max())
                assert d.max() <= cfg.lr, (i, k)
                if i == 0:      # before Adam's first step amplifies
                    for got_s, want_s in ((opt["m"][k], m[i][k]),
                                          (opt["v"][k], v[i][k])):
                        assert (np.abs(got_s.numpy() - want_s).max()
                                <= 1e-5 * np.abs(want_s).max())

    @pytest.mark.parametrize("scale", [1, 2])
    def test_jax_trainer_gradient_is_the_mlp_scaled_reference(self, scale):
        """JAX's distributed step transposes its tp ``psum`` to a
        ``psum``, so its gradient is not its reference's: at tp 2 its
        first Adam moment after step 0 equals the port's
        ``train_step_reference(mlp_grad_scale=2)``'s within 1e-5 of the
        largest, every leaf; the reference's own gradient (scale 1) has
        ``w1`` / ``w2`` half of JAX's and every leaf before the MLP more
        than 10% apart. The port's exact-wire trainer equals JAX's
        (:meth:`test_exact_wire_equals_jax_trainer`)."""
        p0, _, _, m, _ = _jax_trainer_run()
        cfg = tstep.TrainConfig(wire_dtype=None)
        assert cfg.tp == 2
        params = tstep.params_from_numpy(p0, cfg, "cpu")
        tok, tgt = tstep.make_batch(cfg, 0)
        _, opt, _ = tstep.train_step_reference(
            params, tstep.init_opt_state(params), tok, tgt, cfg,
            mlp_grad_scale=scale)
        for k, want in m[0].items():
            got = opt["m"][k].numpy()
            err = np.abs(got - want).max() / np.abs(want).max()
            if scale == cfg.tp:
                assert err <= 1e-5, (k, err)
            elif k in ("w1", "w2"):
                np.testing.assert_allclose(2 * got, want, rtol=1e-5,
                                           atol=1e-5 * np.abs(want).max())
            elif k != "head":
                assert (np.linalg.norm(got - want) / np.linalg.norm(want)
                        > 0.1), k

    @pytest.mark.parametrize("attn,wire", [("ring", "int8"),
                                           ("ulysses", "int8"),
                                           ("ring", "fp8")])
    def test_wire_step_tracks_reference(self, attn, wire):
        cfg = tstep.TrainConfig(attn=attn, wire_dtype=wire)
        tr = _port_trainer(cfg)
        batches = [tr.make_batch(k) for k in range(self.STEPS)]
        dist = [tr.step(tok, tgt)["loss"] for tok, tgt in batches]
        ref = _reference_losses(cfg, batches)
        assert tr.wire == wire
        assert abs(dist[0] - ref[0]) < 1e-4
        for d, r in zip(dist, ref):
            assert abs(d - r) < self.TOL, (dist, ref)
        assert tr.wire_report()["ratio"] > 1.9

    def test_step_is_deterministic(self):
        cfg = tstep.TrainConfig()
        a = [r["loss"] for r in _port_trainer(cfg).run(3)]
        b = [r["loss"] for r in _port_trainer(cfg).run(3)]
        assert a == b

    def test_batches_and_wire_report_equal_jax(self):
        jtr = jstep.Trainer(jstep.TrainConfig())
        tr = _port_trainer(tstep.TrainConfig())
        for k in range(3):
            for a, b in zip(jtr.make_batch(k), tr.make_batch(k)):
                np.testing.assert_array_equal(a, b)
        assert jtr.wire_report() == tr.wire_report()
        assert jtr.wire == tr.wire

    def test_tp_replicated_parameters_stay_identical(self):
        tr = _port_trainer(tstep.TrainConfig())
        tr.run(2)
        for k in ("wq", "embed"):
            p = tr.params[k].detach()
            assert torch.equal(p[:, 0], p[:, 1])    # over tp
            assert torch.equal(p[0], p[1])          # over dp
        w1 = tr.params["w1"].detach()
        assert torch.equal(w1[0], w1[1]) and not torch.equal(w1[:, 0],
                                                             w1[:, 1])

    def test_config_validation_equals_jax(self):
        for kw in (dict(d_model=30), dict(seq=15), dict(batch=7),
                   dict(microbatches=3), dict(d_ff=63), dict(attn="dense"),
                   dict(attn="ulysses", n_heads=3, d_model=33),
                   dict(wire_dtype="int4")):
            with pytest.raises(ValueError):
                jstep.TrainConfig(**kw)
            with pytest.raises(ValueError):
                tstep.TrainConfig(**kw)


# ------------------------------------------------ Transformer.train_step


#: the SGD step of the Transformer tests: 1, so that ``old − new`` is the
#: gradient itself, not its rounding at a small lr
LM_LR = 1.0


@functools.lru_cache(maxsize=None)
def _jax_lm(w):
    cfg = jpresets.tiny(jpresets.llama_7b())
    jm = JTransformer(cfg, _jmesh(w, "tp"), "tp", ())
    params = jm.init(jax.random.PRNGKey(0))
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0,
                                         128))
    budget = jconfig.config.fused_vmem_budget
    # the XLA engines: the same f32 math as the interpreted fused rings
    jconfig.config.fused_vmem_budget = 0
    try:
        loss, new = jm.train_step(jax.device_put(params, jm.shardings()),
                                  jnp.asarray(toks), jnp.asarray(toks),
                                  lr=LM_LR)
    finally:
        jconfig.config.fused_vmem_budget = budget
    return (jax.tree.map(np.asarray, params), toks, float(loss),
            jax.tree.map(np.asarray, new))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, t in enumerate(tree):
            yield from _leaves(t, path + (i,))
    else:
        yield path, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


class TestTransformerTrainStep:
    @pytest.mark.parametrize("w", [1, 4])
    def test_train_step_equals_jax(self, w):
        params, toks, jloss, jnew = _jax_lm(w)
        cfg = presets.tiny(presets.llama_7b())
        if w == 1:
            tm = Transformer(cfg, device="cpu")
            p = params_from_numpy(params, cfg, "cpu")
        else:
            mesh = Mesh.loopback(w, "cpu")
            tm = Transformer(cfg, mesh=mesh)
            p = params_from_numpy(params, cfg, mesh=mesh)
        t = torch.from_numpy(toks.copy())
        loss, new = tm.train_step(p, t, t, lr=LM_LR)
        if w > 1:
            new = tm.unshard_params(new)
            assert all(isinstance(s, torch.Tensor)
                       for s in p["blocks"][0]["up"])   # inputs kept
        assert abs(float(loss) - jloss) <= 1e-6
        gmax = max(float(np.abs(old - _at(jnew, path)).max())
                   for path, old in _leaves(params)) / LM_LR
        for path, old in _leaves(params):
            got = _at(new, path).numpy()
            want = _at(jnew, path)
            g_got, g_want = (old - got) / LM_LR, (old - want) / LM_LR
            assert np.abs(g_got - g_want).max() <= 1e-6 * gmax, path
            assert np.abs(got - want).max() <= 1e-6 * max(
                1.0, float(np.abs(want).max())), path

    def test_loss_falls_over_two_steps(self):
        cfg = presets.tiny(presets.llama_7b())
        tm = Transformer(cfg, device="cpu")
        p = tm.init(torch.Generator().manual_seed(0))
        t = torch.randint(0, cfg.vocab, (2, 16),
                          generator=torch.Generator().manual_seed(1))
        l1, p = tm.train_step(p, t, t, lr=1e-2)
        l2, _ = tm.train_step(p, t, t, lr=1e-2)
        assert float(l2) < float(l1)


# ---------------------------------------------------------- refusals


class TestRefusals:
    def test_trainer_health_is_step_8(self):
        cfg = tstep.TrainConfig()
        with pytest.raises(NotImplementedError, match="step 8"):
            tstep.Trainer(cfg, tstep.default_train_mesh(cfg, "cpu"),
                          health=object())

    def test_overlap_batch_axes_is_step_8(self):
        with pytest.raises(NotImplementedError, match="step 8"):
            tov.OverlapContext(mesh=_tmesh(2), axis="x", batch_axes=("dp",))

    @pytest.mark.parametrize("moe", ["ep", "tp"])
    def test_moe_training_is_step_9b(self, moe):
        cfg = presets.tiny(presets.deepseek_moe_16b(
            moe=moe, moe_weight_quant=None, moe_act_quant=None))
        tm = Transformer(cfg, device="cpu")
        t = torch.zeros((1, 8), dtype=torch.int64)
        with pytest.raises(NotImplementedError, match="step 9b"):
            tm.train_step({}, t, t)

    def test_remat_is_step_9b(self):
        import dataclasses

        cfg = dataclasses.replace(presets.tiny(presets.llama_7b()),
                                  remat=True)
        t = torch.zeros((1, 8), dtype=torch.int64)
        with pytest.raises(NotImplementedError, match="step 9b"):
            Transformer(cfg, device="cpu").loss({}, t, t)

    def test_moe_tp_mlp_backward_is_step_9b(self):
        ctx = MoETPContext(num_experts=4, topk=2, block_m=8,
                           dtype=torch.float32)
        x = torch.randn(8, 16, requires_grad=True)
        ids = torch.zeros((8, 2), dtype=torch.int32)
        wts = torch.ones((8, 2))
        params = {"up": torch.randn(4, 16, 32), "down": torch.randn(4, 32,
                                                                    16)}
        with pytest.raises(NotImplementedError, match="step 9b"):
            MoETPMLP(ctx)(params, x, ids, wts)


    def test_the_ring_refuses_what_it_cannot_carry(self):
        x = torch.zeros((2, 6, 8))
        with pytest.raises(ValueError, match="'fp8' or 'int8'"):
            cp_ring.grad_ring(x, wire=None)
        with pytest.raises(ValueError, match="chunks"):
            cp_ring.grad_ring(x, wire="int8", chunk_rows=2)
