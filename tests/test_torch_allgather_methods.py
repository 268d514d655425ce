"""Parity of the PyTorch port's all-gather methods with the JAX package.

The JAX side runs on 4 of the 8 virtual CPU devices (``tests/
conftest.py``), its kernels interpreted: ``_ring_ag_kernel``,
``_ring_bidir_ag_kernel``, ``_ll_push_ag_kernel``, ``_ll_persist_kernel``
and XLA's ``all_gather``. The port's side runs on ``Mesh.loopback(4,
"cpu")``, where ``all_gather`` runs its plain versions because the
tensors lie on the CPU. Inputs are drawn with numpy from a seed.

* The method each side runs: JAX's is read by wrapping its
  ``_build_all_gather`` and its persistent-context LRU
  (``_persist_state``), which record what they are asked for and raise
  before building, at every shape, method and wire of the table.
* Every method's bytes against JAX's, f32 and bf16; the bidirectional
  ring at ``split8`` 2, 4 and 6; ``XLA_FALLBACK`` raises in the port.
* ``PersistentLLAllGather``: the outputs and, after each of three
  calls, every rank's workspace (window c % 2 holds call c's rows)
  against JAX's, byte for byte; the LRU of 8 contexts.
"""

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

from triton_distributed_tpu.layers.allgather import (
    AllGatherLayer as JAllGatherLayer,
)
from triton_distributed_tpu.runtime import AllGatherMethod as JAGMethod
from triton_distributed_tpu.tune.schedule import RingSchedule as JRingSchedule
from triton_distributed_tpu_torch.kernels import allgather as tag
from triton_distributed_tpu_torch.layers import AllGatherLayer
from triton_distributed_tpu_torch.runtime import AllGatherMethod, Mesh
from triton_distributed_tpu_torch.tune.schedule import RingSchedule

jag = importlib.import_module("triton_distributed_tpu.kernels.allgather")

W = 4
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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


def _data(shape, dtype, seed=40):
    """W shards of ``shape`` as numpy f32 rounded to ``dtype``, stacked
    on a leading dim."""
    x = np.random.default_rng(seed).standard_normal((W, *shape))
    x = x.astype(np.float32)
    return np.asarray(jnp.asarray(x, JDT[dtype]).astype(jnp.float32))


def _port_shards(x, dtype):
    return list(torch.from_numpy(x.copy()).to(TDT[dtype]).unbind(0))


def _jax_in(x, dtype):
    """The JAX global array: the shards concatenated on dim 0, sharded
    over the mesh."""
    g = jnp.asarray(x.reshape(W * x.shape[1], *x.shape[2:]), JDT[dtype])
    return jax.device_put(g, NamedSharding(_jmesh(), P("tp")))


class _Picked(Exception):
    pass


def _jax_method(shape, method=None, wire=None):
    """The method JAX's ``all_gather`` runs for W f32 shards of ``shape``:
    its ``_build_all_gather`` and its persistent-context LRU are wrapped
    to record the request and raise before building."""
    seen = []

    def build(mesh, axis, m, *a, **k):
        seen.append(m)
        raise _Picked

    def persist(*a, **k):
        seen.append(JAGMethod.LL_PERSIST)
        raise _Picked

    x = jnp.zeros((W * shape[0], *shape[1:]), jnp.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jag, "_build_all_gather", build)
        mp.setattr(jag, "_persist_state", persist)
        with pytest.raises(_Picked):
            jag.all_gather(x, _jmesh(), "tp", method=method,
                           wire_dtype=wire)
    return seen[0]


#: (shard shape, method asked for, wire): LL_SMALL up to 64 KiB a shard,
#: the bidirectional ring above at 4 ranks, its rank-1 and single-column
#: demotions, an explicit wire's demotion, LL_PERSIST on 2-D and 3-D
PICKS = [((16, 16), None, None), ((32, 512), None, None),
         ((33, 512), None, None), ((16384,), None, None),
         ((20000, 1), None, None), ((17, 64, 16), None, None),
         ((16384,), "RING_BIDIR", None), ((64, 512), None, "fp8"),
         ((64, 512), "LL_SMALL", "int8"), ((64, 512), "LL_PERSIST", "int8"),
         ((8, 64), "LL_PERSIST", None), ((8, 8, 8), "LL_PERSIST", None),
         ((64, 512), "RING_BIDIR", "auto"), ((64, 512), "RING_1D", None)]


@pytest.mark.parametrize("shape,method,wire", PICKS)
def test_method_is_jax(shape, method, wire):
    """The port resolves the method JAX's entry runs."""
    want = _jax_method(shape, None if method is None else JAGMethod[method],
                       wire)
    x = [torch.zeros(shape) for _ in range(W)]
    got = tag.resolve_all_gather_method(
        x, W, None if method is None else AllGatherMethod[method], wire)
    assert got.value == want.value


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("method", ["RING_1D", "RING_BIDIR", "LL_SMALL",
                                    "LL_PERSIST"])
def test_bytes_equal_jax(tmesh, method, dtype):
    """Each method's result against JAX's interpreted kernel, byte for
    byte (the gathered rows of every rank)."""
    x = _data((16, 256), dtype)
    want = np.asarray(jag.all_gather(_jax_in(x, dtype), _jmesh(), "tp",
                                     method=JAGMethod[method])
                      .astype(jnp.float32))
    got = tag.all_gather(_port_shards(x, dtype), tmesh,
                         method=AllGatherMethod[method])
    assert len(got) == W
    for g in got:
        np.testing.assert_array_equal(g.float().numpy(), want)


def test_xla_fallback(tmesh):
    """JAX's XLA ``all_gather`` gives the kernels' bytes; the port has no
    kernel for it and raises."""
    x = _data((16, 256), "float32")
    want = np.asarray(jag.all_gather(_jax_in(x, "float32"), _jmesh(), "tp",
                                     method=JAGMethod.XLA_FALLBACK))
    np.testing.assert_array_equal(want, x.reshape(W * 16, 256))
    with pytest.raises(NotImplementedError, match="XLA"):
        tag.all_gather(_port_shards(x, "float32"), tmesh,
                       method=AllGatherMethod.XLA_FALLBACK)


@pytest.mark.parametrize("split8", [2, 4, 6])
def test_bidir_split8(tmesh, split8):
    """The bidirectional ring under ``RingSchedule(split8=...)`` on both
    sides, byte for byte; the split is JAX's, lane-aligned (512 columns:
    128 · split8 / 2), and a schedule field other than split8 raises."""
    x = _data((8, 512), "bfloat16")
    want = np.asarray(jag.all_gather(
        _jax_in(x, "bfloat16"), _jmesh(), "tp",
        method=JAGMethod.RING_BIDIR,
        schedule=JRingSchedule(split8=split8)).astype(jnp.float32))
    got = tag.all_gather(_port_shards(x, "bfloat16"), tmesh,
                         method=AllGatherMethod.RING_BIDIR,
                         schedule=RingSchedule(split8=split8))
    for g in got:
        np.testing.assert_array_equal(g.float().numpy(), want)
    assert tag.bidir_split(512, split8) == 64 * split8
    with pytest.raises(ValueError, match="step 10"):
        tag.all_gather(_port_shards(x, "bfloat16"), tmesh,
                       schedule=RingSchedule(split8=split8, depth=3))


def test_bidir_split_points():
    """kh as JAX computes it (``:160-167``): k // 2 without a schedule;
    k · split8 // 8, clamped to [128, k − 128] in multiples of 128 from
    256 columns; unaligned below."""
    assert tag.bidir_split(300) == 150
    assert [tag.bidir_split(300, s) for s in (2, 4, 6)] == [128, 128, 128]
    assert [tag.bidir_split(1024, s) for s in (1, 3, 7)] == [128, 384, 896]
    assert [tag.bidir_split(100, s) for s in (2, 4, 6)] == [25, 50, 75]


def test_rank1_shards_run_the_ring(tmesh):
    """1-D shards under RING_BIDIR run RING_1D on both sides, with the
    same bytes."""
    x = _data((4096,), "float32")
    assert _jax_method((4096,), JAGMethod.RING_BIDIR) == JAGMethod.RING_1D
    want = np.asarray(jag.all_gather(_jax_in(x, "float32"), _jmesh(), "tp",
                                     method=JAGMethod.RING_BIDIR))
    for g in tag.all_gather(_port_shards(x, "float32"), tmesh,
                            method=AllGatherMethod.RING_BIDIR):
        np.testing.assert_array_equal(g.numpy(), want)


def test_persistent_workspace_after_each_call(tmesh):
    """Three calls of ``PersistentLLAllGather`` on both sides: each call's
    output, and every rank's workspace after it (window c % 2 holds call
    c's rows, the other window the call before's, zeros at first), byte
    for byte."""
    m, k, dtype = 8, 128, "bfloat16"
    jll = jag.PersistentLLAllGather(_jmesh(), "tp", (m, k), jnp.bfloat16)
    tll = tag.PersistentLLAllGather(tmesh, "tp", (m, k), torch.bfloat16)
    for c in range(3):
        x = _data((m, k), dtype, seed=41 + c)
        want = np.asarray(jll(_jax_in(x, dtype)).astype(jnp.float32))
        got = tll(_port_shards(x, dtype))
        for g in got:
            np.testing.assert_array_equal(g.float().numpy(), want)
        jws = sorted(jll.ws.addressable_shards, key=lambda s: s.device.id)
        for r, ws in enumerate(tll.workspace):
            np.testing.assert_array_equal(
                ws.float().numpy(),
                np.asarray(jws[r].data.astype(jnp.float32)))
        assert tll.call_idx == jll.call_idx == c + 1
    rows = W * m
    for c, window in ((2, slice(0, rows)), (1, slice(rows, 2 * rows))):
        np.testing.assert_array_equal(
            tll.workspace[0][window].float().numpy(),
            _data((m, k), dtype, seed=41 + c).reshape(rows, k))


def test_persist_state_lru(tmesh):
    """``all_gather(method=LL_PERSIST)`` keeps one context a
    configuration in an LRU of 8: a repeated shape continues its call
    count; a ninth shape evicts the oldest, which restarts at call 0."""
    tag._PERSIST_STATES.clear()
    x = [torch.ones((4, 8)) for _ in range(W)]
    tag.all_gather(x, tmesh, method=AllGatherMethod.LL_PERSIST)
    tag.all_gather(x, tmesh, method=AllGatherMethod.LL_PERSIST)
    first = tag._persist_state(tmesh, "tp", (4, 8), torch.float32)
    assert first.call_idx == 2
    for cols in range(9, 17):
        tag.all_gather([torch.ones((4, cols))] * W, tmesh,
                       method=AllGatherMethod.LL_PERSIST)
    assert len(tag._PERSIST_STATES) == tag._PERSIST_STATES_MAX == 8
    assert tag._persist_state(tmesh, "tp", (4, 8),
                              torch.float32).call_idx == 0
    tag._PERSIST_STATES.clear()


def test_layer_entries(tmesh):
    """``AllGatherLayer``'s named entries on both sides, byte for byte."""
    x = _data((16, 256), "float32")
    jl = JAllGatherLayer(_jmesh(), "tp")
    tl = AllGatherLayer(tmesh, "tp")
    for name in ("forward_ring_bidir", "forward_ll_persist"):
        want = np.asarray(getattr(jl, name)(_jax_in(x, "float32")))
        for g in getattr(tl, name)(_port_shards(x, "float32")):
            np.testing.assert_array_equal(g.numpy(), want)
