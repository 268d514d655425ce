"""Parity of the PyTorch port's int8-mxu GEMM-RS with the JAX package.

JAX's ``gemm_rs(wire_dtype='int8-mxu')`` on its default engine runs the
s8 producer ``_fused_kernel_mxw`` (or, under ``GridSchedule(epilogue=
"readback")``, ``_fused_kernel_mxr``) wherever one out tile spans every
column, and demotes to the int8 wire elsewhere. The JAX side runs on 4 of
the 8 virtual CPU devices (``tests/conftest.py``), its kernels
interpreted; the port's on ``Mesh.loopback(4, "cpu")``, where the entry
runs its plain versions because the tensors lie on the CPU. Inputs are
drawn with numpy from a seed, an outlier row (x1000) in the first shard.

* The engine, the wire and the scale chunk the port resolves equal
  JAX's at every shape: JAX's kernels are wrapped to record which one
  ``_build_fused`` takes and at which chunk (its row block ``bm``).
* f32: the port within 1e-5 of the largest output of JAX's kernels (the
  two epilogues are one function in f32).
* bf16: elementwise within one int8 code step of the output's chunk
  (1/127 of its largest value) plus one bf16 ulp there. JAX's jitted
  quantizers multiply by the scale's reciprocal where the port divides,
  so at an exact tie a hop's code moves one step (ROADMAP Queue 3).
* At N = 2048 (two out tiles) int8-mxu is the port's int8 wire bit for
  bit, and ``demote="strict"`` raises on both sides.
* ``method=XLA_RING`` keeps the int8 wire's numerics: the port's int8
  wire bit for bit, JAX's XLA twin within a code step.

Each JAX build takes 6-7 s here (the interpreter's trace and lowering);
the twelve kernel builds are most of the file's time.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from triton_distributed_tpu.kernels.ag_gemm import (
    pick_mm_blocks as j_pick_mm_blocks,
)
from triton_distributed_tpu.tune.schedule import GridSchedule as JGridSchedule
from triton_distributed_tpu_torch.kernels import ag_gemm as tag
from triton_distributed_tpu_torch.kernels import gemm_rs as trs
from triton_distributed_tpu_torch.runtime import Mesh
from triton_distributed_tpu_torch.tune.schedule import GridSchedule

jgrs = importlib.import_module("triton_distributed_tpu.kernels.gemm_rs")

W = 4
#: (rows a rank, K a rank, N): the two widths of JAX's s8 producer at
#: 256 and 512 columns of K in all, and the wire tests' odd chunking
SHAPES = [(64, 64, 128), (64, 128, 1024), (96, 128, 192)]
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ULP = {"float32": 2.0 ** -23, "bfloat16": 2.0 ** -7}
_KERNELS = ("_fused_kernel_mxw", "_fused_kernel_mxr", "_fused_kernel_w")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the inputs are small, and the suite runs in
    several worker processes that share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jmesh():
    return JMesh(np.asarray(jax.devices()[:W]), ("tp",))


@pytest.fixture(scope="module")
def tmesh():
    return Mesh.loopback(W, "cpu")


@functools.lru_cache(maxsize=None)
def _operands(shape, dtype, seed=30):
    """A (W·m, W·K) with an outlier row, B (W·K, N) scaled to unit
    outputs, as numpy f32 rounded to ``dtype``."""
    m, k, n = shape
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((W * m, W * k)).astype(np.float32)
    a[3] *= 1000.0
    b = (rng.standard_normal((W * k, n)) / np.sqrt(W * k)).astype(np.float32)
    rnd = lambda x: np.asarray(jnp.asarray(x, JDT[dtype]).astype(jnp.float32))
    return rnd(a), rnd(b)


def _port_operands(shape, dtype):
    a, b = _operands(shape, dtype)
    ta = torch.from_numpy(a.copy()).to(TDT[dtype])
    tb = torch.from_numpy(b.copy()).to(TDT[dtype])
    return list(ta.chunk(W, dim=1)), list(tb.chunk(W, dim=0))


@functools.lru_cache(maxsize=None)
def _jax_gemm_rs(shape, dtype, epilogue=None, method=None):
    """JAX's interpreted GEMM-RS on the int8-mxu wire → (its output as
    f32 numpy, the (kernel, row block, chunk rows) ``_build_fused`` took;
    None for an engine without a fused kernel). Its fused kernels are
    wrapped to record the call (cached: each run interprets a ring of 4
    devices)."""
    a, b = _operands(shape, dtype)
    seen = []
    saved = {k: getattr(jgrs, k) for k in _KERNELS}

    def spy(name):
        def run(*args, **kw):
            seen.append((name, args[3][0], args[4].chunk_rows))
            return saved[name](*args, **kw)
        return run

    for k in _KERNELS:
        setattr(jgrs, k, spy(k))
    jgrs._build_fused.cache_clear()
    try:
        sched = None if epilogue is None else JGridSchedule(epilogue=epilogue)
        out = jgrs.gemm_rs(jnp.asarray(a, JDT[dtype]),
                           jnp.asarray(b, JDT[dtype]), _jmesh(), "tp",
                           method=method, wire_dtype="int8-mxu",
                           schedule=sched)
        out = np.asarray(jnp.asarray(out).astype(jnp.float32))
    finally:
        for k, f in saved.items():
            setattr(jgrs, k, f)
        jgrs._build_fused.cache_clear()
    return out, (seen[0] if seen else None)


def _port(tmesh, shape, dtype, **kw):
    a, b = _port_operands(shape, dtype)
    out = trs.gemm_rs(a, b, tmesh, wire_dtype="int8-mxu", **kw)
    return torch.cat(out).float().numpy()


def _chunk_tol(want, rows, dtype):
    """One int8 code step of each output chunk of ``rows`` rows (1/127
    of its largest value) plus one ulp of ``dtype`` there, per element."""
    amax = np.abs(want).reshape(-1, rows * want.shape[1]).max(axis=1)
    per = amax * (1.0 / 127.0 + ULP[dtype])
    return np.repeat(per, rows * want.shape[1]).reshape(want.shape)


class TestPlan:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("shape", SHAPES + [(64, 64, 2048)])
    def test_blocks_and_plan_are_jax(self, tmesh, shape, dtype):
        """``pick_mm_blocks`` equals JAX's at the GEMM-RS targets, and
        the plan takes JAX's gate: the s8 producer at one out tile, its
        chunk the row block, else the int8 wire."""
        m, k, n = shape
        item = 4 if dtype == "float32" else 2
        want = j_pick_mm_blocks(m, k, n, item, targets=jgrs._RS_TILE_TARGETS)
        assert tag.pick_mm_blocks(m, k, n, item,
                                  targets=trs._RS_TILE_TARGETS) == want
        a, b = _port_operands(shape, dtype)
        plan = trs.resolve_gemm_rs_plan(tmesh, "tp", a, b,
                                        wire_dtype="int8-mxu")
        assert plan.method == trs.GemmRSMethod.PALLAS_FUSED
        if n // want[2] == 1:
            assert (plan.wire, plan.chunk_rows) == ("int8-mxu", want[0])
            assert plan.tpu_kernel == "_fused_kernel_mxw"
        else:
            assert (plan.wire, plan.chunk_rows) == ("int8", None)

    def test_blockless_shard_takes_the_xla_ring(self, tmesh):
        """A shard without a divisor blocking runs XLA_RING, as JAX's
        heuristic picks, where int8-mxu ships int8; a pinned
        PALLAS_FUSED raises, as JAX's ``_build_fused`` does."""
        a = [torch.zeros((W * 8, 64))] * W
        b = [torch.zeros((64, 128))] * W
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("TDTPU_FUSED_VMEM_BUDGET", "64")
            plan = trs.resolve_gemm_rs_plan(tmesh, "tp", a, b,
                                            wire_dtype="int8-mxu")
            assert (plan.method, plan.wire) == (trs.GemmRSMethod.XLA_RING,
                                                "int8")
            with pytest.raises(ValueError, match="no divisor blocking"):
                trs.resolve_gemm_rs_plan(
                    tmesh, "tp", a, b,
                    method=trs.GemmRSMethod.PALLAS_FUSED)
        assert trs.resolve_gemm_rs_plan(
            tmesh, "tp", a, b, method=trs.GemmRSMethod.XLA_NAIVE,
            wire_dtype="int8").wire is None


class TestInt8MxuProducer:
    @pytest.mark.parametrize("epilogue", [None, "readback"])
    @pytest.mark.parametrize("shape", SHAPES)
    def test_f32_matches_jax_kernel(self, tmesh, shape, epilogue):
        """f32: JAX's ``_fused_kernel_mxw`` (no schedule) and ``_mxr``
        (readback) at the chunk the port resolves, within 1e-5 of the
        largest output (today's port before the repair: 1.65e-2)."""
        want, (kern, bm, chunk) = _jax_gemm_rs(shape, "float32", epilogue)
        assert kern == ("_fused_kernel_mxr" if epilogue else
                        "_fused_kernel_mxw")
        sched = GridSchedule(epilogue=epilogue) if epilogue else None
        a, b = _port_operands(shape, "float32")
        plan = trs.resolve_gemm_rs_plan(tmesh, "tp", a, b,
                                        wire_dtype="int8-mxu",
                                        schedule=sched)
        assert plan.tpu_kernel == kern and plan.chunk_rows == chunk == bm
        got = _port(tmesh, shape, "float32", schedule=sched)
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()

    @pytest.mark.parametrize("epilogue", [None, "readback"])
    @pytest.mark.parametrize("shape", SHAPES)
    def test_bf16_matches_jax_kernel(self, tmesh, shape, epilogue):
        """bf16: within one int8 code step of the output's chunk plus
        one bf16 ulp, elementwise (JAX's jitted reciprocal moves a code
        at a tie); the two epilogues differ from each other past that
        bound, so each is held to its own kernel."""
        want, (kern, _, chunk) = _jax_gemm_rs(shape, "bfloat16", epilogue)
        sched = GridSchedule(epilogue=epilogue) if epilogue else None
        got = _port(tmesh, shape, "bfloat16", schedule=sched)
        assert (np.abs(got - want)
                <= _chunk_tol(want, chunk, "bfloat16")).all()

    def test_bf16_epilogues_differ(self, tmesh):
        """In bf16 the accumulator epilogue quantizes hop 0 off the f32
        partial and takes each later scale off the f32 sum, where the
        readback one rounds first: most outputs differ."""
        shape = SHAPES[0]
        mxw = _port(tmesh, shape, "bfloat16")
        mxr = _port(tmesh, shape, "bfloat16",
                    schedule=GridSchedule(epilogue="readback"))
        assert (mxw != mxr).mean() > 0.1
        f32 = [_port(tmesh, shape, "float32", schedule=GridSchedule(
            epilogue=e)) for e in ("accumulator", "readback")]
        np.testing.assert_array_equal(*f32)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_demoted_at_two_out_tiles(self, tmesh, dtype):
        """N = 2048 blocks to two 1024-wide out tiles: JAX runs its int8
        wire (``_fused_kernel_w``; read in f32, the gate is the shape's),
        and the port's int8-mxu is its own int8 wire bit for bit."""
        shape = (64, 64, 2048)
        _, (kern, _, _) = _jax_gemm_rs(shape, "float32")
        assert kern == "_fused_kernel_w"
        a, b = _port_operands(shape, dtype)
        got = trs.gemm_rs(a, b, tmesh, wire_dtype="int8-mxu")
        want = trs.gemm_rs(a, b, tmesh, wire_dtype="int8")
        assert all(torch.equal(g, w) for g, w in zip(got, want))

    def test_strict_demotion_raises_on_both_sides(self, tmesh):
        shape = (64, 64, 2048)
        a, b = _operands(shape, "float32")
        with pytest.raises(ValueError, match="strict"):
            jgrs.gemm_rs(jnp.asarray(a), jnp.asarray(b), _jmesh(), "tp",
                         wire_dtype="int8-mxu",
                         schedule=JGridSchedule(demote="strict"))
        ta, tb = _port_operands(shape, "float32")
        with pytest.raises(ValueError, match="strict"):
            trs.gemm_rs(ta, tb, tmesh, wire_dtype="int8-mxu",
                        schedule=GridSchedule(demote="strict"))

    def test_xla_ring_keeps_the_int8_wire(self, tmesh):
        """``method=XLA_RING``: int8-mxu ships int8 on both sides. The
        port's result is its int8 wire bit for bit (its numerics before
        the repair); against JAX's XLA twin, elementwise within one code
        step of the output's 64-row chunk (JAX's jitted reciprocal moves
        one code here, by 1.2e-5 of the largest output)."""
        shape = SHAPES[0]
        want, seen = _jax_gemm_rs(shape, "float32",
                                  method=jgrs.GemmRSMethod.XLA_RING)
        assert seen is None
        got = _port(tmesh, shape, "float32",
                    method=trs.GemmRSMethod.XLA_RING)
        a, b = _port_operands(shape, "float32")
        int8 = torch.cat(trs.gemm_rs(a, b, tmesh, wire_dtype="int8")).numpy()
        np.testing.assert_array_equal(got, int8)
        assert (np.abs(got - want) <= _chunk_tol(want, 64, "float32")).all()


class TestSchedules:
    def test_grid_schedule_fields(self, tmesh):
        """A GridSchedule sets only the int8-mxu producer's epilogue and
        demotion; any other field, or a GridSchedule on another wire,
        raises; a RingSchedule keeps its depth rule."""
        from triton_distributed_tpu_torch.tune.schedule import RingSchedule

        a, b = _port_operands(SHAPES[0], "float32")
        for bad in (GridSchedule(block_q=8), GridSchedule(rail="shared"),
                    GridSchedule(epilogue="fused")):
            with pytest.raises(ValueError, match="step 10|epilogue"):
                trs.gemm_rs(a, b, tmesh, wire_dtype="int8-mxu",
                            schedule=bad)
        with pytest.raises(ValueError, match="GridSchedule"):
            trs.gemm_rs(a, b, tmesh, wire_dtype="int8",
                        schedule=GridSchedule())
        with pytest.raises(ValueError, match="step 10"):
            trs.gemm_rs(a, b, tmesh, schedule=RingSchedule(direction="rev"))
        out = trs.gemm_rs(a, b, tmesh, wire_dtype="int8-mxu",
                          schedule=RingSchedule(depth=3))
        want = trs.gemm_rs(a, b, tmesh, wire_dtype="int8-mxu")
        assert all(torch.equal(g, w) for g, w in zip(out, want))
        assert GridSchedule.kind == "grid" and RingSchedule.kind == "ring"

    def test_overlap_context_method(self, tmesh):
        """``OverlapContext(method=)`` carries the GEMM-RS engine to the row
        layer (a spelling is coerced to the enum), and the column op takes
        the AG-GEMM engine of the same name, as JAX's ``_dual_method``
        maps a pinned engine: XLA_RING's int8-mxu chunks at the wire's 64
        rows."""
        from triton_distributed_tpu_torch import layers, ops
        from triton_distributed_tpu_torch.kernels import ag_gemm as tag

        a, b = _port_operands(SHAPES[0], "float32")
        ctx = ops.OverlapContext(tmesh, "tp", method="xla_ring",
                                 wire_dtype="int8-mxu")
        assert ctx.method == trs.GemmRSMethod.XLA_RING
        got = layers.RowParallelLinear(ctx)({"w": b}, a)
        want = trs.gemm_rs(a, b, tmesh, wire_dtype="int8")
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        rows = [x.contiguous() for x in torch.cat(a, 1).chunk(W, 0)]
        cols = [x.contiguous() for x in torch.cat(b, 0).chunk(W, 1)]
        got = ops.ag_gemm(rows, cols, ctx)
        want = tag.ag_gemm(rows, cols, tmesh,
                           method=tag.AGGemmMethod.XLA_RING,
                           wire_dtype="int8-mxu")
        assert all(torch.equal(g, w) for g, w in zip(got, want))
