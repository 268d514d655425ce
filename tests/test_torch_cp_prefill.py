"""Parity of the PyTorch port's context-parallel prefill with the JAX package.

The JAX side runs on meshes of 4 (and 8) of the 8 virtual CPU devices
(``tests/conftest.py``); the port's side on ``Mesh.loopback(n, "cpu")``,
where ``ring_attention`` / ``ulysses_attention`` run their plain
versions because the tensors lie on the CPU. The same inputs, drawn with
numpy from a seed, go through both: the attention entries against JAX's
``ring_attention`` / ``ulysses_attention`` / ``dense_attention_reference``,
the plain KV hop and both Ulysses all-to-all directions against
``jax.lax.ppermute`` / ``jax.lax.all_to_all(tiled=True)`` inside
``shard_map``, and ``prefill`` → decode of the tiny model at
``attn="ring"`` and ``"ulysses"``. The CUDA kernels are held against the
plain versions in tests/test_torch_cuda.py.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from triton_distributed_tpu.models import Transformer as JTransformer
from triton_distributed_tpu.models import presets as jpresets
from triton_distributed_tpu_torch.kernels import cp_ring
from triton_distributed_tpu_torch.kernels import ring_attention as tra
from triton_distributed_tpu_torch.models import (
    Transformer,
    params_from_numpy,
    presets,
)
from triton_distributed_tpu_torch.runtime import Mesh

# the JAX package's kernels/__init__ exports functions that shadow the module
jra = importlib.import_module("triton_distributed_tpu.kernels.ring_attention")

W = 4
B, S_LOC, D = 2, 8, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the inputs are tiny, and the suite runs in
    several worker processes that share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jmesh(n, axis="x"):
    return JMesh(np.asarray(jax.devices()[:n]), (axis,))


def _stack(a, n):
    """A global (B, n·S, ...) array → the port's (n, B, S, ...) blocks."""
    a = np.asarray(a)
    blocks = a.reshape(a.shape[0], n, a.shape[1] // n, *a.shape[2:])
    return torch.from_numpy(np.ascontiguousarray(np.swapaxes(blocks, 0, 1)))


def _unstack(t):
    """The port's (n, B, S, ...) blocks → the global (B, n·S, ...)."""
    a = np.swapaxes(t.numpy(), 0, 1)
    return a.reshape(a.shape[0], -1, *a.shape[3:])


def _qkv(n, hq, hkv, seed):
    rng = np.random.default_rng(seed)
    s = n * S_LOC
    return (rng.standard_normal((B, s, hq, D)).astype(np.float32),
            rng.standard_normal((B, s, hkv, D)).astype(np.float32),
            rng.standard_normal((B, s, hkv, D)).astype(np.float32))


# ---------------------------------------------------------------- attention

#: (kind, Hq, Hkv, n, causal): GQA and MHA at n = 4, and Ulysses with
#: fewer KV heads than ranks (the KV heads replicated)
ATTN_CASES = [(kind, hq, hkv, W, causal)
              for kind in ("ring", "ulysses", "dense")
              for hq, hkv in ((8, 4), (8, 8), (16, 8))
              for causal in (True, False)]
ATTN_CASES += [("ulysses", 8, 2, 4, causal) for causal in (True, False)]
ATTN_CASES += [("ulysses", 8, 4, 8, causal) for causal in (True, False)]


@pytest.mark.parametrize(
    "kind,hq,hkv,n,causal", ATTN_CASES,
    ids=[f"{k}-hq{q}-hkv{v}-n{n}-{'causal' if c else 'full'}"
         for k, q, v, n, c in ATTN_CASES])
def test_attention_matches_jax(kind, hq, hkv, n, causal):
    """``ring_attention``, ``ulysses_attention`` and
    ``dense_attention_reference`` on the same f32 inputs as JAX's, within
    1e-5 (the same f32 products summed in another order)."""
    q, k, v = _qkv(n, hq, hkv, seed=hq * 10 + hkv + n)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    if kind == "dense":
        want = jra.dense_attention_reference(jq, jk, jv, causal=causal)
        got = tra.dense_attention_reference(
            *(torch.from_numpy(a) for a in (q, k, v)), causal=causal).numpy()
    else:
        jfn = jra.ring_attention if kind == "ring" else jra.ulysses_attention
        tfn = tra.ring_attention if kind == "ring" else tra.ulysses_attention
        want = jfn(jq, jk, jv, _jmesh(n), "x", causal=causal)
        out = tfn(_stack(q, n), _stack(k, n), _stack(v, n),
                  Mesh.loopback(n, "cpu", axis="x"), "x", causal=causal)
        assert tuple(out.shape) == (n, B, S_LOC, hq, D)
        got = _unstack(out)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [4, 8])
def test_skipping_wholly_masked_blocks_keeps_jax_values(n):
    """The kernel leaves out the blocks the causal mask hides wholly (src
    > me). JAX folds them in with weight exp(-1e30 - m) = 0 once step 0
    has set a finite m, so the plain ring with the skip equals the one
    without bit for bit, and both JAX's within 1e-5."""
    q, k, v = _qkv(n, 8, 4, seed=40 + n)
    args = [_stack(a, n) for a in (q, k, v)]
    full = tra.ring_attention_plain(*args, causal=True)
    skip = tra.ring_attention_plain(*args, causal=True, skip_masked=True)
    assert torch.equal(full, skip)
    want = jra.ring_attention(*(jnp.asarray(a) for a in (q, k, v)),
                              _jmesh(n), "x", causal=True)
    np.testing.assert_allclose(_unstack(skip), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _bf16_excess(got, want):
    """max(|got - want| - ulp(want)): the card tests' measure
    (tests/test_torch_cuda.py), want's bf16 ulp 2^(e - 8) for |want| in
    [2^(e-1), 2^e)."""
    w, g = want.float(), got.float()
    _, e = torch.frexp(w)
    ulp = torch.where(w == 0, torch.zeros_like(w),
                      torch.ldexp(torch.ones_like(w), e - 8))
    return ((g - w).abs() - ulp).max().item()


def _tc_kernel_emulation(q, k, v, *, split: bool, tile: int = 64):
    """The arithmetic of the bf16 ring kernel (``csrc/cp_ring.cu``
    ``ring_attention_tc_kernel``) in torch ops, causal: every rank's
    source blocks in the ring's order (src = r, r - 1, ..., 0), each in
    64-key tiles; S the f32 sums of exact bf16 products; exp2 of the
    scores scaled by scale · log2(e), less the row max so scaled; P
    into the product as bf16 hi + lo (``split``) or as one bf16; f32
    sums, one rounding at the output."""
    n, b, s, hq, d = q.shape
    g = hq // k.shape[3]
    sl2 = torch.tensor(d ** -0.5 * 1.4426950408889634, dtype=torch.float32)
    pos = torch.arange(s)
    outs = []
    for r in range(n):
        qr = q[r].float().transpose(1, 2)                  # (b, hq, s, d)
        m = torch.full((b, hq, s, 1), -torch.inf)
        l = torch.zeros((b, hq, s, 1))
        o = torch.zeros((b, hq, s, d))
        for src in range(r, -1, -1):
            kb, vb = (t[src].float().repeat_interleave(g, dim=2)
                      .transpose(1, 2) for t in (k, v))   # (b, hq, s, d)
            for k0 in range(0, s, tile):
                sc = qr @ kb[:, :, k0:k0 + tile].transpose(-1, -2)
                if src == r:
                    keys = pos[k0:k0 + tile]
                    sc = sc.masked_fill(keys[None, :] > pos[:, None],
                                        -torch.inf)
                mx = torch.maximum(m, sc.amax(-1, keepdim=True))
                base = torch.where(mx == -torch.inf, 0.0, mx * sl2)
                alpha = torch.exp2(m * sl2 - base)
                p = torch.exp2(sc * sl2 - base)
                m = mx
                l = l * alpha + p.sum(-1, keepdim=True)
                hi = p.bfloat16().float()
                vt = vb[:, :, k0:k0 + tile]
                pv = hi @ vt
                if split:
                    pv = pv + (p - hi).bfloat16().float() @ vt
                o = o * alpha + pv
        out = o / torch.clamp(l, min=1e-30)
        outs.append(out.transpose(1, 2).to(q.dtype))
    return torch.stack(outs)


def test_tc_kernel_split_p_keeps_the_card_tolerance():
    """The bf16 ring kernel splits P into bf16 hi + lo before P @ V. Its
    arithmetic, emulated at a small causal shape, stays within the card
    tests' bf16 tolerance of the plain ring (excess over one bf16 ulp ≤
    1e-5, none where |plain| ≥ 2^-4); with P as one bf16 it falls outside,
    so the split cannot be dropped without this test failing."""
    rng = np.random.default_rng(5)
    n, s, hq, hkv, d = 2, 64, 4, 2, 32
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (n, B, s, h, d)).astype(np.float32)).bfloat16()
        for h in (hq, hkv, hkv))
    want = tra.ring_attention_plain(q, k, v, causal=True)
    got = _tc_kernel_emulation(q, k, v, split=True)
    big = want.float().abs() >= 2.0 ** -4
    assert _bf16_excess(got, want) <= 1e-5
    assert _bf16_excess(got[big], want[big]) <= 0.0
    one = _tc_kernel_emulation(q, k, v, split=False)
    assert _bf16_excess(one, want) > 1e-5


def test_ring_variant_codes_match_the_kernel():
    """``RING_VARIANTS`` names the codes of ``csrc/cp_ring.cu``'s
    ``RingVariant`` (the kernel a ``tdt_ring_attention`` call reports it
    launched), and ``reset_launch_counts`` clears the wrapper's
    ``by_variant`` with its other counts."""
    import re

    from triton_distributed_tpu_torch.config import csrc_dir
    from triton_distributed_tpu_torch.kernels import reset_launch_counts

    src = (csrc_dir() / "cp_ring.cu").read_text()
    body = re.search(r"enum RingVariant \{([^}]*)\}", src).group(1)
    codes = {int(c): name for name, c in
             re.findall(r"RING_(\w+) = (\d+)", body)}
    assert {c: name.lower() for c, name in codes.items()} == \
        cp_ring.RING_VARIANTS
    cp_ring.ring_attention_launch.by_variant["tma"] = 3
    reset_launch_counts()
    assert cp_ring.ring_attention_launch.by_variant == {}


def _shard_mapped(fn, n):
    return jax.jit(jax.shard_map(fn, mesh=_jmesh(n), in_specs=P(None, "x"),
                                 out_specs=P(None, "x"), check_vma=False))


def test_kv_rotate_matches_ppermute():
    """Each of the ring's hops moves every rank's block as JAX's
    ``ppermute`` with ``perm = [(j, (j + 1) % n)]`` does, on rank-tagged
    blocks, exactly; n hops bring every block home."""
    n = W
    x = np.arange(B * n * 3 * 5, dtype=np.float32).reshape(B, n * 3, 5)
    hop = _shard_mapped(lambda blk: jax.lax.ppermute(
        blk, "x", [(j, (j + 1) % n) for j in range(n)]), n)
    want, got = jnp.asarray(x), _stack(x, n)
    for _ in range(n):
        want = hop(want)
        got = cp_ring.kv_rotate_plain(got)
        np.testing.assert_array_equal(_unstack(got), np.asarray(want))
    np.testing.assert_array_equal(_unstack(got), x)


@pytest.mark.parametrize("direction", ["scatter", "gather"])
def test_ulysses_a2a_matches_all_to_all(direction):
    """``ulysses_a2a`` against ``jax.lax.all_to_all(tiled=True)`` inside
    ``shard_map`` on rank-tagged blocks, exactly: the scatter (sequence →
    heads, split 2 concat 1) and the gather (heads → sequence, split 1
    concat 2)."""
    n, h = W, 8
    if direction == "scatter":
        shape, split, concat = (B, n * S_LOC, h, D), 2, 1
    else:
        shape, split, concat = (B, n * n * S_LOC, h // n, D), 1, 2
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    a2a = _shard_mapped(lambda blk: jax.lax.all_to_all(
        blk, "x", split_axis=split, concat_axis=concat, tiled=True), n)
    want = np.asarray(a2a(jnp.asarray(x)))
    got = cp_ring.ulysses_a2a(_stack(x, n), direction)
    np.testing.assert_array_equal(_unstack(got), want)
    back = cp_ring.ulysses_a2a(got, "gather" if direction == "scatter"
                               else "scatter")
    np.testing.assert_array_equal(_unstack(back), x)


# --------------------------------------------------------- prefill → decode

#: B = 2 rows: at B = 1 the sequence-parallel row blocks and the sequence
#: shards coincide, and a mix-up of the two layouts would pass
TB, TS, TCAP, TSTEPS = 2, 16, 32, 3


def _margin_gate(jax_logits, port_logits, jax_toks, port_toks):
    """The gate of tests/test_models.py: a row is compared while the JAX
    side's top-2 margin stays above 1e-2."""
    cmp = np.ones((TB,), bool)
    for la, ta, tb in zip(jax_logits, jax_toks, port_toks):
        top2 = np.sort(la, axis=-1)[:, -2:]
        cmp &= (top2[:, 1] - top2[:, 0]) > 1e-2
        assert cmp.any(), "degenerate test: all rows near-tied"
        np.testing.assert_array_equal(ta[cmp], tb[cmp])


@functools.lru_cache(maxsize=None)
def _cp_run(attn):
    """The tiny model through prefill and TSTEPS greedy decode steps: JAX
    and the port at ``attn`` on 4 ranks, each side on its own tokens, and
    the port at ``attn="tp"`` fed the port's tokens, all from one JAX
    parameter tree."""
    jm = JTransformer(jpresets.tiny(attn=attn), _jmesh(W, "tp"), "tp", ())
    params = jm.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    toks = np.random.default_rng(9).integers(0, 128, (TB, TS)).astype(
        np.int32)
    run = {"tree": tree}
    la, jc, jl = jm.prefill(params, jm.init_cache(TB, TCAP), jnp.asarray(toks))
    run["jax_caches"] = jax.tree.map(np.asarray, jc)
    logits, sent = [np.asarray(la)], []
    for _ in range(TSTEPS):
        t = jnp.argmax(la, -1).astype(jnp.int32)
        sent.append(np.asarray(t))
        la, jc, jl = jm._decode_jit(params, jc, jl, t)
        logits.append(np.asarray(la))
    run["jax"] = (logits, sent)
    mesh = Mesh.loopback(W, "cpu")
    for mode in (attn, "tp"):
        cfg = presets.tiny(attn=mode)
        tm = Transformer(cfg, mesh=mesh)
        tp = params_from_numpy(tree, cfg, mesh=mesh)
        lt, tc, tl = tm.prefill(tp, tm.init_cache(TB, TCAP),
                                torch.from_numpy(toks))
        if mode == attn:
            run["caches"] = [[np.concatenate([s.numpy() for s in leaf], 2)
                              for leaf in pair] for pair in tc]
            run["params"] = tp
        logits, sent = [lt.numpy()], []
        for i in range(TSTEPS):
            t = (torch.argmax(lt, -1).to(torch.int32) if mode == attn
                 else torch.from_numpy(run[attn][1][i]))
            sent.append(t.numpy())
            lt, tc, tl = tm.decode_step(tp, tc, tl, t)
            logits.append(lt.numpy())
        run[mode] = (logits, sent)
    return run


@pytest.mark.parametrize("attn", ["ring", "ulysses"])
def test_prefill_matches_jax(attn):
    """``prefill`` at B = 2, S = 16 on 4 ranks: the last-position logits
    and every layer's sequence-sharded K/V caches within 1e-5 of JAX's
    (f32 GEMMs summed in another order)."""
    run = _cp_run(attn)
    np.testing.assert_allclose(run[attn][0][0], run["jax"][0][0], rtol=1e-5,
                               atol=1e-5)
    for got, want in zip(run["caches"], run["jax_caches"]):
        for g, w in zip(got, want):
            assert g.shape == (TB, 4, TCAP, D)
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("attn", ["ring", "ulysses"])
def test_generate_tokens_equal_jax(attn):
    """3 greedy decode steps after the prefill, each side on its own
    tokens: equal to JAX's wherever the margin gate holds, and every
    step's logits within 1e-5 of JAX's."""
    run = _cp_run(attn)
    jl, jt = run["jax"]
    tl, tt = run[attn]
    _margin_gate(jl, tl, jt, tt)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("attn", ["ring", "ulysses"])
def test_modes_agree_with_tp(attn):
    """The same weights at ``attn="tp"``, fed the same tokens: the
    prefill's and every decode step's logits within 2e-3 (JAX's
    ``test_model_attn_modes_agree``)."""
    run = _cp_run(attn)
    for a, b in zip(run[attn][0], run["tp"][0]):
        np.testing.assert_allclose(a, b, atol=2e-3)


def test_cp_params_keep_the_attention_projections_shared():
    """Under context-parallel attention ``wqkv`` and ``wo`` stay one
    shared tensor (JAX replicates them) equal to JAX's, while ``up`` and
    ``down`` are cut into the ranks' blocks as at ``attn="tp"``."""
    run = _cp_run("ring")
    for jb, tb in zip(run["tree"]["blocks"], run["params"]["blocks"]):
        for name in ("wqkv", "wo"):
            assert isinstance(tb[name], torch.Tensor)
            np.testing.assert_array_equal(tb[name].numpy(), jb[name])
        for name, dim in (("up", 1), ("down", 0)):
            assert isinstance(tb[name], list) and len(tb[name]) == W
            np.testing.assert_array_equal(
                np.concatenate([s.numpy() for s in tb[name]], dim), jb[name])


def test_refusals():
    """Ulysses needs the query heads (and the KV heads, or the ranks over
    them) to split over the ranks; ring attention needs neither, only
    ``ffn``; every context-parallel prefill needs S to split over the
    ranks (B·S splitting is not enough)."""
    mesh = Mesh.loopback(W, "cpu")
    x = torch.zeros((W, 1, 2, 6, 16))
    with pytest.raises(ValueError, match="Hq % cp"):
        tra.ulysses_attention(x, x[:, :, :, :2], x[:, :, :, :2], mesh)
    kv = torch.zeros((W, 1, 2, 3, 16))
    with pytest.raises(ValueError, match="Hkv"):
        tra.ulysses_attention(torch.zeros((W, 1, 2, 12, 16)), kv, kv, mesh)
    with pytest.raises(ValueError, match="n_heads % cp"):
        Transformer(presets.tiny(attn="ulysses", n_heads=6, n_kv_heads=2),
                    mesh=mesh)
    ring = Transformer(presets.tiny(attn="ring", n_heads=6, n_kv_heads=3),
                       mesh=mesh)
    with pytest.raises(ValueError, match="ffn"):
        Transformer(presets.tiny(attn="ring", ffn=250), mesh=mesh)
    params = ring.shard_params(ring.init(torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError, match="does not split over the 4"):
        ring.prefill(params, ring.init_cache(2, 8),
                     torch.zeros((2, 6), dtype=torch.int32))
    with pytest.raises(ValueError, match="q must stack"):
        tra.ring_attention(x[:2], x[:2], x[:2], mesh)
