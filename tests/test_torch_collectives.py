"""Parity of the PyTorch port's reduce-scatter and dense all-to-all with
the JAX package.

The JAX side runs on a mesh of 4 of the 8 virtual CPU devices
(``tests/conftest.py``), its ring kernels interpreted: the VMEM-resident
``_ring_rs_kernel`` / ``_ring_rs_kernel_w`` and, with its fused-engine
budget set to 1 byte (as ``tests/test_collectives.py`` forces it), the
HBM-streaming ``_rs_stream_kernel`` / ``3`` / ``_w`` / ``_w3``; and
``_a2a_kernel``. The port's side runs on ``Mesh.loopback(4, "cpu")``,
where every wrapper runs its plain PyTorch version because the tensors
lie on the CPU. Inputs are drawn with numpy from a seed (4 ranks, 32 rows
a rank; 256 columns in f32, 1024 in bf16, where a per-row wire scale
saves bytes; values x30).

* The raw reduce-scatter, f32 and bf16, stacked and replicated, on both
  engines and at depth 2 and 3, is **bit-equal** to JAX: the ring adds
  rank d − 1's block first and its own last and rounds each hop to the
  dtype. One f32 sum rounded once is not (the test shows it differs in
  bf16).
* The engine the port picks equals JAX's at every shape, dtype, wire,
  budget and depth tried (JAX's ``_build_*`` functions are intercepted
  before they build).
* The wires (fp8, int8; 'int8-mxu' ships int8; 'auto' fp8 from 256 KiB
  a row block) on both engines. The codes agree up to JAX's reciprocal
  rounding: its jitted quantizers multiply by the scale's reciprocal,
  where the port divides, so a code can move one step at an exact tie
  and carry into the later hops. f32 on the stream is held to 1e-5 of
  the largest output; the rest elementwise to one code step of the
  chunk's scale (1/127 of the chunk's largest output for int8, for fp8
  the step of its top binade, 32/448) plus one ulp of the dtype there.
  Readings: in f32 no code moves (the outputs differ by float noise,
  1.6e-7 of the largest); in bf16 the largest difference is 0.92 (fp8)
  and 0.60 (int8) of that step on the VMEM ring, 0.39 and 0 (two
  elements differ by 6e-5) on the stream.
* JAX's eligibility ``ValueError``, and the port's refusal of schedule
  fields other than the depth.
* The all-to-all is byte-exact against JAX (int32 words and bf16).
"""

import contextlib
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from triton_distributed_tpu.config import config as jcfg
from triton_distributed_tpu.tune.schedule import RingSchedule as JRingSchedule
from triton_distributed_tpu_torch.runtime import Mesh
from triton_distributed_tpu_torch.tune.schedule import RingSchedule

jrs = importlib.import_module("triton_distributed_tpu.kernels.reduce_scatter")
ja2a = importlib.import_module("triton_distributed_tpu.kernels.all_to_all")
trs = importlib.import_module(
    "triton_distributed_tpu_torch.kernels.reduce_scatter")
ta2a = importlib.import_module(
    "triton_distributed_tpu_torch.kernels.all_to_all")

W = 4
ROWS = 32 * W
COLS = {"float32": 256, "bfloat16": 1024}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
QSTEP = {"fp8": 32.0 / 448.0, "int8": 1.0 / 127.0}
ULP = {"float32": 2.0 ** -23, "bfloat16": 2.0 ** -7}


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


@contextlib.contextmanager
def _jax_budget(budget):
    """JAX's fused-engine budget, as tests/test_collectives.py sets it."""
    old = jcfg.fused_vmem_budget
    jcfg.fused_vmem_budget = budget
    try:
        yield
    finally:
        jcfg.fused_vmem_budget = old


@functools.lru_cache(maxsize=None)
def _data(dtype, stacked, seed=0):
    """The ranks' contributions as numpy f32 (rounded to ``dtype``):
    (W, ROWS, cols) stacked, (ROWS, cols) replicated."""
    rng = np.random.default_rng(seed)
    shape = ((W,) if stacked else ()) + (ROWS, COLS[dtype])
    x = (rng.standard_normal(shape) * 30).astype(np.float32)
    return np.asarray(jnp.asarray(x, JDT[dtype]).astype(jnp.float32))


def _port_in(x, dtype, stacked):
    t = torch.from_numpy(x.copy()).to(TDT[dtype])
    return list(t.unbind(0)) if stacked else t


@functools.lru_cache(maxsize=None)
def _jax_rs(dtype, stacked, stream, wire=None, depth=2):
    """JAX's interpreted reduce-scatter → the (ROWS, cols) result, in
    ``dtype`` (cached: each call interprets a ring of 4 devices)."""
    x = jnp.asarray(_data(dtype, stacked), JDT[dtype])
    if stacked:
        x = jax.device_put(x, NamedSharding(_jmesh(), P("tp")))
    sched = None if depth == 2 else JRingSchedule(depth=depth)
    with _jax_budget(1 if stream else jcfg.fused_vmem_budget):
        out = jrs.reduce_scatter(x, _jmesh(), "tp", stacked=stacked,
                                 wire_dtype=wire, schedule=sched)
        return np.asarray(out)


def _port_rs(tmesh, dtype, stacked, stream, monkeypatch, **kw):
    if stream:
        monkeypatch.setenv("TDTPU_FUSED_VMEM_BUDGET", "1")
    out = trs.reduce_scatter(_port_in(_data(dtype, stacked), dtype, stacked),
                             tmesh, stacked=stacked, **kw)
    monkeypatch.delenv("TDTPU_FUSED_VMEM_BUDGET", raising=False)
    return torch.cat(out)


class _Picked(Exception):
    pass


def _jax_engine(shape, dtype, wire, budget, depth, stacked=True):
    """The TPU kernel JAX's entry picks, read from the ``_build_*``
    function it calls (which is stopped before it builds)."""
    names = {"_build_reduce_scatter": "_ring_rs_kernel",
             "_build_reduce_scatter_w": "_ring_rs_kernel_w",
             "_build_rs_stream": "_rs_stream_kernel",
             "_build_rs_stream_w": "_rs_stream_kernel_w"}
    saved = {n: getattr(jrs, n) for n in names}

    def spy(name):
        def fn(*a, **k):
            sched = k.get("schedule", a[-1] if "stream" in name else None)
            suffix = "3" if sched is not None and sched.depth == 3 else ""
            raise _Picked(names[name] + suffix)
        return fn

    x = jnp.zeros(((W,) if stacked else ()) + shape, JDT[dtype])
    sched = None if depth == 2 else JRingSchedule(depth=depth)
    for n in names:
        setattr(jrs, n, spy(n))
    try:
        with _jax_budget(budget):
            jrs.reduce_scatter(x, _jmesh(), "tp", stacked=stacked,
                               wire_dtype=wire, schedule=sched)
    except _Picked as e:
        return str(e)
    finally:
        for n, f in saved.items():
            setattr(jrs, n, f)
    raise AssertionError("JAX's entry built no reduce-scatter")


# ------------------------------------------------------------ raw engines

@pytest.mark.parametrize("depth,stream", [(2, False), (2, True), (3, True)])
@pytest.mark.parametrize("stacked", [True, False])
@pytest.mark.parametrize("dtype", sorted(COLS))
def test_raw_is_bit_equal_to_jax(tmesh, monkeypatch, dtype, stacked, stream,
                                 depth):
    """Both engines, at depth 2 and 3, stacked and replicated: the port's
    hop loop equals JAX's ring bit for bit; in bf16 one f32 sum rounded
    once does not."""
    want = _jax_rs(dtype, stacked, stream, depth=depth)
    sched = None if depth == 2 else RingSchedule(depth=depth)
    got = _port_rs(tmesh, dtype, stacked, stream, monkeypatch,
                   schedule=sched)
    if dtype == "float32":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16))
    if dtype == "bfloat16" and stacked:
        once = torch.from_numpy(_data(dtype, True).sum(0)).to(torch.bfloat16)
        assert not torch.equal(once, got)


# ---------------------------------------------------------------- engines

ENGINE_CASES = [
    # (rows, cols), dtype, wire, budget (bytes), depth
    ((8192, 2048), "bfloat16", None, 96 << 20, 2),    # stream
    ((8192, 2048), "bfloat16", None, 96 << 20, 3),
    ((1024, 2048), "bfloat16", None, 96 << 20, 3),    # VMEM ignores depth
    ((7020, 2048), "bfloat16", None, 96 << 20, 2),    # 1755 rows: VMEM
    ((7024, 2048), "bfloat16", None, 96 << 20, 2),    # 1756 rows: stream
    ((8192, 2048), "bfloat16", "fp8", 96 << 20, 2),
    ((8192, 2048), "bfloat16", "int8", 96 << 20, 3),
    ((1024, 2048), "bfloat16", "int8-mxu", 96 << 20, 2),
    ((1024, 2048), "float32", "auto", 96 << 20, 2),
    ((128, 256), "float32", "fp8", 1, 2),
    ((128, 256), "float32", "int8", 1, 3),
    ((268, 256), "float32", "fp8", 1, 2),     # 67 rows: no wire blocking
    ((64, 48), "float32", None, 1, 2),
    ((64, 48), "float32", "auto", 1, 2),
]


@pytest.mark.parametrize("shape,dtype,wire,budget,depth", ENGINE_CASES)
def test_engine_is_jax(monkeypatch, shape, dtype, wire, budget, depth):
    """At the same shape, budget, wire and depth the port picks the TPU
    kernel JAX picks (and its wire format's chunk: one row on the VMEM
    ring, ``make_wire_format``'s on the stream)."""
    want = _jax_engine(shape, dtype, wire, budget, depth)
    monkeypatch.setenv("TDTPU_FUSED_VMEM_BUDGET", str(budget))
    itemsize = TDT[dtype].itemsize
    w = trs.resolve_rs_wire(wire, shape[0], shape[1], W, itemsize)
    got, fmt = trs.select_engine(W, shape, itemsize, w, depth)
    assert got == want
    if fmt is not None:
        assert fmt.chunk_rows == (1 if got == "_ring_rs_kernel_w" else
                                  trs.wirelib.make_wire_format(
                                      w, shape[0] // W).chunk_rows)


def test_wire_resolution_is_jax():
    """``resolve_rs_wire`` equals JAX's ``_resolve_rs_wire`` for every
    spelling over ragged, narrow and wide payloads, 'auto' on both sides
    of 256 KiB, and the eligibility ``ValueError`` alike."""
    cases = [(128, 256, 4), (128, 1024, 2), (128, 512, 2), (128, 170, 4),
             (130, 1024, 2), (4096, 1024, 2), (512, 1024, 2), (511, 256, 4),
             (4096, 1, 4)]
    for wire in (None, "bf16", "fp8", "int8", "int8-mxu", "auto"):
        for rows, cols, itemsize in cases:
            try:
                want = jrs._resolve_rs_wire(wire, rows, cols, W, itemsize)
            except ValueError:
                with pytest.raises(ValueError, match="pinned wire format"):
                    trs.resolve_rs_wire(wire, rows, cols, W, itemsize)
                continue
            assert trs.resolve_rs_wire(wire, rows, cols, W,
                                       itemsize) == want, (wire, rows, cols)


# ------------------------------------------------------------------ wires

def _step_excess(got, want, dtype, wire, chunk_rows):
    """max(|got − want| − step) over the elements, relative to the
    step: each chunk's step is one code step of its scale plus one ulp of
    the dtype at the chunk's largest output."""
    g, w = got.float().numpy(), np.asarray(want, np.float32)
    rows = g.shape[0] // W
    excess = 0.0
    for r in range(W):
        gr = g[r * rows:(r + 1) * rows].reshape(rows // chunk_rows, -1)
        wr = w[r * rows:(r + 1) * rows].reshape(rows // chunk_rows, -1)
        amax = np.abs(wr).max(axis=1, keepdims=True)
        step = amax * (QSTEP[wire] + ULP[dtype])
        excess = max(excess, float(((np.abs(gr - wr) - step)
                                    / step).max()))
    return excess


@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("wire", ["fp8", "int8"])
@pytest.mark.parametrize("dtype", sorted(COLS))
def test_wire_matches_jax(tmesh, monkeypatch, dtype, wire, stream):
    """The wire on the VMEM ring (one scale a row) and on the stream
    (``make_wire_format``'s chunk): f32 on the stream within 1e-5 of the
    largest output; the rest within one code step of each chunk's scale
    and one ulp, elementwise (module docstring). The same call on
    'int8-mxu' gives the int8 wire's bytes."""
    want = np.asarray(_jax_rs(dtype, True, stream, wire), np.float32)
    got = _port_rs(tmesh, dtype, True, stream, monkeypatch, wire_dtype=wire)
    if stream and dtype == "float32":
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err <= 1e-5
    chunk = 1 if not stream else trs.wirelib.make_wire_format(
        wire, ROWS // W).chunk_rows
    assert _step_excess(got, want, dtype, wire, chunk) <= 0.0
    exact = _data(dtype, True).sum(0)
    assert (np.abs(got.float().numpy() - exact).max()
            <= {"fp8": 0.15, "int8": 0.04}[wire] * np.abs(exact).max())
    if wire == "int8":
        mx = _port_rs(tmesh, dtype, True, stream, monkeypatch,
                      wire_dtype="int8-mxu")
        assert torch.equal(mx, got)


def test_auto_wire(tmesh, monkeypatch):
    """'auto' ships fp8 from 256 KiB a row block (the port's fp8 bytes)
    and the raw wire below it (bit-equal to the raw reduce-scatter)."""
    small = _port_rs(tmesh, "bfloat16", True, False, monkeypatch,
                     wire_dtype="auto")
    assert torch.equal(small, _port_rs(tmesh, "bfloat16", True, False,
                                       monkeypatch))
    rng = np.random.default_rng(4)
    x = list(torch.from_numpy(rng.standard_normal(
        (W, 4 * 128, 1024)).astype(np.float32)).to(torch.bfloat16).unbind(0))
    auto = trs.reduce_scatter(x, tmesh, stacked=True, wire_dtype="auto")
    fp8 = trs.reduce_scatter(x, tmesh, stacked=True, wire_dtype="fp8")
    assert all(torch.equal(a, b) for a, b in zip(auto, fp8))


# -------------------------------------------------------------- refusals

def test_refusals(tmesh):
    """JAX's eligibility ``ValueError`` on a pinned wire the payload
    cannot carry (both sides); the port's refusal of schedule fields
    other than the depth (a reversed ring adds in another order) and of
    a depth other than 2 or 3; rows that do not split over the ranks."""
    x = jnp.zeros((W, 32, 128), jnp.float32)
    with pytest.raises(ValueError, match="pinned wire format"):
        jrs.reduce_scatter(x, _jmesh(), "tp", stacked=True, wire_dtype="fp8")
    t = [torch.zeros(32, 128) for _ in range(W)]
    with pytest.raises(ValueError, match="pinned wire format"):
        trs.reduce_scatter(t, tmesh, stacked=True, wire_dtype="fp8")
    for bad in (RingSchedule(direction="rev"),
                RingSchedule(chunk_order="skip_last"),
                RingSchedule(split8=2, depth=3)):
        with pytest.raises(ValueError, match="step 10"):
            trs.reduce_scatter(t, tmesh, stacked=True, schedule=bad)
    with pytest.raises(ValueError, match="depth must be 2 or 3"):
        trs.reduce_scatter(t, tmesh, stacked=True,
                           schedule=RingSchedule(depth=4))
    with pytest.raises(ValueError, match="does not split"):
        trs.reduce_scatter([torch.zeros(30, 128)] * W, tmesh, stacked=True)
    with pytest.raises(ValueError, match="per-rank"):
        trs.reduce_scatter(t[:3], tmesh, stacked=True)
    # one rank: the contribution passes through
    one = Mesh.loopback(1, "cpu")
    assert trs.reduce_scatter(t[0], one)[0] is t[0]


def test_schedule_is_jax():
    """The port's RingSchedule has JAX's fields and defaults."""
    assert RingSchedule().to_dict() == JRingSchedule().to_dict()
    d = JRingSchedule(direction="rev", depth=3).to_dict()
    assert RingSchedule(**d).to_dict() == d


# ------------------------------------------------------------ all-to-all

@pytest.mark.parametrize("dtype,shape", [("int32", (W * 6, 40)),
                                         ("bfloat16", (W * 3, 5, 8))])
def test_all_to_all_is_byte_exact(tmesh, dtype, shape):
    """Row block j of rank i lands in row block i of rank j: the port's
    list and stacked forms equal JAX's interpreted ``_a2a_kernel`` byte
    for byte; at one rank the input passes through."""
    rng = np.random.default_rng(7)
    if dtype == "int32":
        x = rng.integers(-2 ** 31, 2 ** 31 - 1, (W,) + shape,
                         dtype=np.int64).astype(np.int32)
        jx = jnp.asarray(x.reshape(-1, *shape[1:]))
        tx = torch.from_numpy(x)
    else:
        x = rng.standard_normal((W,) + shape).astype(np.float32)
        jx = jnp.asarray(x.reshape(-1, *shape[1:]), jnp.bfloat16)
        tx = torch.from_numpy(x).to(torch.bfloat16)
    want = np.asarray(ja2a.all_to_all(
        jax.device_put(jx, NamedSharding(_jmesh(), P("tp"))), _jmesh(),
        "tp")).reshape((W,) + shape)
    got = torch.stack(ta2a.all_to_all(list(tx.unbind(0)), tmesh))
    dev = ta2a.all_to_all_device(tx, tmesh)
    view = torch.int32 if dtype == "int32" else torch.int16
    np_view = np.int32 if dtype == "int32" else np.int16
    np.testing.assert_array_equal(got.view(view).numpy(), want.view(np_view))
    assert torch.equal(dev.view(view), got.view(view))
    one = Mesh.loopback(1, "cpu")
    assert ta2a.all_to_all_device(tx[:1], one) is not None
    assert torch.equal(ta2a.all_to_all_device(tx[:1], one), tx[:1])
    with pytest.raises(ValueError, match="split"):
        ta2a.all_to_all([t[:-1] for t in tx.unbind(0)], tmesh)
