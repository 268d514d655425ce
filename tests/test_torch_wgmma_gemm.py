"""CPU checks of the warpgroup GEMM's host-side pieces (``csrc/
wg_gemm.cuh``: ``wgmma`` fed by TMA, under ``tdt_ag_gemm``,
``tdt_gemm_rs`` (over a mesh and at world size 1), ``tdt_ag_gemm_w`` and
``tdt_gemm_rs_partials``), whose kernel runs only on a card
(``tests/test_torch_cuda.py::TestWgmmaGemm``):

* a peer's code pairs read from the 64-byte-swizzled codes tile as the
  consumer threads read them, converted as the kernel converts them, and
  laid out as the register-A fragment, equal ``lang/wire.py``'s
  dequantize for every fp8 and int8 code at several scales, and the
  reads are free of shared-memory bank conflicts;
* the wire AG's tile map (emulated in numpy) against ``PeerRowsQ::at``
  (``csrc/ggemm_tiles.cuh``) and the plain version's gathered order;
* the bf16 sources' tile maps (``WgPeerRows``, ``WgPeerSum``,
  ``WgLocal``) against the tile loops' ``PeerRows``, ``PeerSum`` and
  ``PeerLocal`` at row counts that are not multiples of the tile, and
  the epilogue's row guard: every output row stored once, none past;
* the epilogue's staging covers the tile once, without bank conflicts;
* the form predicate (``ag_gemm.wgmma_form``), its constants against the
  C source, and the shapes the wire path and the smoke launch;
* the port's AG-GEMM and GEMM-RS wires on the CPU against the JAX
  package's XLA ring twins at a tile-sized shard, and the bf16 AG-GEMM
  and GEMM-RS at a shard of 200 rows.
"""

from __future__ import annotations

import itertools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from triton_distributed_tpu.kernels.ag_gemm import AGGemmMethod
from triton_distributed_tpu.kernels.ag_gemm import ag_gemm as j_ag_gemm
from triton_distributed_tpu.kernels.gemm_rs import GemmRSMethod
from triton_distributed_tpu.kernels.gemm_rs import gemm_rs as j_gemm_rs
from triton_distributed_tpu_torch import ops
from triton_distributed_tpu_torch.config import csrc_dir
from triton_distributed_tpu_torch.kernels import ag_gemm as agm
from triton_distributed_tpu_torch.kernels import gemm_rs as grs
from triton_distributed_tpu_torch.lang import wire as tw
from triton_distributed_tpu_torch.runtime import Mesh

BM, BK, BN = 128, 64, 256      # the kernel's tile: rows, k a stage, columns


def _src():
    return (csrc_dir() / "wg_gemm.cuh").read_text()


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", _src()).group(1))


def test_tile_constants_match_the_kernel():
    """The tile this file emulates and the predicate's constants are the
    kernel's; ``MESH_GEMM_FORMS`` names its ``MeshGemmForm`` codes."""
    assert (_const("WG_BM"), _const("WG_BK"), _const("WG_BN")) == (BM, BK, BN)
    assert agm.WG_TILE_ROWS == _const("WG_BM")
    assert agm.WG_MAX_RANKS == _const("WG_MAX_RANKS")
    body = re.search(r"enum MeshGemmForm \{([^}]*)\}", _src()).group(1)
    codes = {int(c): name.lower()
             for name, c in re.findall(r"GEMM_(\w+) = (\d+)", body)}
    assert codes == agm.MESH_GEMM_FORMS


# ------------------------------------------------- the codes' A fragments

def _swizzled(tile):
    """A (rows, 64) byte tile as TMA lands it in the 64-byte swizzle:
    16-byte chunk c of row r at chunk c ^ ((r >> 1) & 3)."""
    rows = tile.shape[0]
    out = np.zeros(rows * 64, np.uint8)
    for r in range(rows):
        for c in range(4):
            d = r * 64 + ((c ^ ((r >> 1) & 3)) << 4)
            out[d:d + 16] = tile[r, 16 * c:16 * c + 16]
    return out


def _words(smem, offsets):
    """The little-endian 32-bit words at byte ``offsets``."""
    o = np.asarray(offsets)
    return (smem[o].astype(np.uint32) | smem[o + 1].astype(np.uint32) << 8
            | smem[o + 2].astype(np.uint32) << 16
            | smem[o + 3].astype(np.uint32) << 24)


def _thread_reads(kk):
    """For k step kk, each consumer thread's (tile row, byte offsets of
    its four registers' words, the shift of its pair): ``convert`` of
    ``wg_gemm_kernel`` (rows r0 and r0 + 8, words at 4 (tq >> 1) and + 8
    in chunk kk ^ ((g >> 1) & 3), the half tq & 1)."""
    out = []
    for tid in range(256):
        wg, warp, lane = tid >> 7, tid >> 5, tid & 31
        g, tq = lane >> 2, lane & 3
        r0 = wg * 64 + (warp & 3) * 16 + g
        sw, sh = (g >> 1) & 3, (tq & 1) * 16
        o0 = r0 * 64 + 4 * (tq >> 1)
        o1 = o0 + 8 * 64
        c = (kk ^ sw) << 4
        out.append((tid, r0, [c + o0, c + o1, c + o0 + 8, c + o1 + 8], sh))
    return out


def _convert(pairs, scales, quant):
    """``wg_code_pair``: the low byte and the next of each 16-bit pair as
    codes → f32 (fp8 exactly; int8 biased by 0x80 into the low byte of
    the f32 2^23, minus 2^23 + 128), times the row's scale in f32, both
    rounded to bf16; returns (n, 2) bf16."""
    lo = (pairs & 0xFF).astype(np.uint8)
    hi = ((pairs >> 8) & 0xFF).astype(np.uint8)
    codes = torch.from_numpy(np.stack([lo, hi], 1))
    if quant == "fp8":
        vals = codes.view(torch.float8_e4m3fn).float()
    else:
        bits = 0x4B000000 | (codes.to(torch.int64) ^ 0x80)
        vals = bits.to(torch.int32).view(torch.float32) - 8388736.0
    return (vals * torch.from_numpy(scales)[:, None]).to(torch.bfloat16)


def _fragment_tile(codes, row_scale, quant):
    """The (BM, BK) bf16 A that the consumer threads' register fragments
    hold over a stage: register i of a k step holds row r0 + 8 (i & 1),
    columns 16 kk + 8 (i >> 1) + 2 tq and + 1 (mma.sync's A layout)."""
    smem = _swizzled(codes)
    got = torch.zeros((BM, BK), dtype=torch.bfloat16)
    filled = np.zeros((BM, BK), np.int64)
    for kk in range(BK // 16):
        for tid, r0, offs, sh in _thread_reads(kk):
            tq = (tid & 31) & 3
            pairs = _words(smem, offs) >> sh
            rows = [r0 + 8 * (i & 1) for i in range(4)]
            vals = _convert(pairs, row_scale[rows], quant)
            for i in range(4):
                col = 16 * kk + 8 * (i >> 1) + 2 * tq
                got[rows[i], col:col + 2] = vals[i]
                filled[rows[i], col:col + 2] += 1
    assert (filled == 1).all()      # every element, once
    return got


@pytest.mark.parametrize("quant", ["fp8", "int8"])
def test_code_fragments_equal_the_plain_dequantize(quant):
    """Every code (fp8 but its two NaNs; int8 all 256) in a 128 x 64
    tile at chunk scales from the smallest to an outlier's, read and
    converted as the kernel does: the fragments hold ``dequantize_slab``
    of the tile bit for bit, each row at its own chunk's scale."""
    rng = np.random.default_rng(0)
    pool = np.arange(256, dtype=np.uint8)
    if quant == "fp8":
        pool = pool[(pool & 0x7F) != 0x7F]
    codes = np.resize(rng.permutation(pool), BM * BK)
    codes = rng.permuted(codes).reshape(BM, BK)
    for chunk_rows in (64, 1):
        fmt = tw.WireFormat(quant, chunk_rows)
        chunks = BM // chunk_rows
        scales = np.array([1e-12 / fmt.qmax, 1.0, 3.0 / fmt.qmax,
                           1000.0 / fmt.qmax] * chunks, np.float32)[:chunks]
        row_scale = np.repeat(scales, chunk_rows)
        got = _fragment_tile(codes, row_scale, quant)
        q = torch.from_numpy(codes).view(fmt.wire_dtype)
        want = tw.dequantize_slab(q, torch.from_numpy(scales), fmt,
                                  torch.bfloat16)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_code_reads_are_free_of_bank_conflicts():
    """Each warp-wide 32-bit read of ``convert`` (a k step, a register)
    touches at most one word a bank (lanes that share a word are one
    broadcast)."""
    for kk in range(BK // 16):
        reads = _thread_reads(kk)
        for warp in range(8):
            lanes = reads[32 * warp:32 * warp + 32]
            for i in range(4):
                words = {offs[i] // 4 for _, _, offs, _ in lanes}
                banks = [w % 32 for w in words]
                assert len(banks) == len(set(banks))


# -------------------------------------------------- the wire AG's tiles

def _peer_rows_q_at(t, r, m, world, chunk_rows):
    """``PeerRowsQ::at`` (csrc/ggemm_tiles.cuh): tile row t of rank r →
    (source shard, its row, own (exact) or a scale index)."""
    g = (t + r * m) % (world * m)
    src, i = g // m, g % m
    return src, i, None if src == r else src * (m // chunk_rows) + i // chunk_rows


def _wg_tile(m0, r, m, world):
    """``WgPeerRowsQ::tile``: (codes, A's first row in its map, first
    output row) of tile m0 of rank r."""
    g = (m0 + r * m) % (world * m)
    return (g // m != r), (g % m if g // m == r else g), g


def _wg_scale(g, m, chunk_rows):
    """``WgPeerRowsQ::scale`` of gathered row g."""
    return (g // m) * (m // chunk_rows) + (g % m) // chunk_rows


@pytest.mark.parametrize("world", [1, 2, 4, 8])
@pytest.mark.parametrize("m", [128, 384])
def test_wire_tiles_follow_peer_rows_q(world, m):
    """For every rank and tile: no tile straddles two shards; its rows
    are ``PeerRowsQ::at``'s (the own shard's rows exact, a peer's codes
    at row g of q (world, m, K) with its chunk's scale); the output rows
    are the plain version's gathered order; every fragment row a consumer
    thread holds (r0 and r0 + 8) gets its own row's scale."""
    for chunk_rows in sorted({1, 64, m}):
        if m % chunk_rows:
            continue
        for r in range(world):
            for m0 in range(0, world * m, BM):
                codes, a_row, out_row = _wg_tile(m0, r, m, world)
                at = [_peer_rows_q_at(m0 + j, r, m, world, chunk_rows)
                      for j in range(BM)]
                assert len({src for src, _, _ in at}) == 1
                src = at[0][0]
                assert codes == (src != r)
                for j, (s, i, scale) in enumerate(at):
                    # the plain version's row m0 + j of rank r's output
                    assert out_row + j == s * m + i
                    if codes:
                        assert a_row + j == s * m + i     # row g of q
                        assert _wg_scale(a_row + j, m, chunk_rows) == scale
                    else:
                        assert a_row + j == i             # the own shard
                if codes:
                    for tid in range(256):
                        wg, warp, g = tid >> 7, tid >> 5, (tid & 31) >> 2
                        r0 = wg * 64 + (warp & 3) * 16 + g
                        for row in (r0, r0 + 8):
                            assert (_wg_scale(a_row + row, m, chunk_rows)
                                    == at[row][2])


# ------------------------------------------------ the bf16 sources' tiles

def _cdiv(a, b):
    return -(-a // b)


def _src_tiles(src, m, world):
    """``Src::tiles``: the grid's M-tile count (``m`` the rows of a shard,
    or of a destination)."""
    return {"rows": world * _cdiv(m, BM), "sum": _cdiv(m, BM),
            "local": _cdiv(world * m, BM)}[src]


def _src_tile(src, t, r, m, world):
    """``WgPeerRows`` / ``WgPeerSum`` / ``WgLocal``'s ``tile`` for M-tile t
    of rank r, each part's (A's rank, its first row in that rank's map, B's
    rank), then the first output row and the rows stored."""
    m0 = t * BM
    if src == "rows":
        per = _cdiv(m, BM)
        s, i0 = (t // per + r) % world, (t % per) * BM
        return [(s, i0, r)], s * m + i0, min(BM, m - i0)
    if src == "sum":
        return ([(q, r * m + m0, q) for q in range(world)], m0,
                min(BM, m - m0))
    return [(r, m0, r)], m0, min(BM, world * m - m0)


def _loop_reads(src, r, m, world):
    """The tile loops' row sources (``csrc/ggemm_tiles.cuh``) for rank r:
    {output row: [(A's rank, its row, B's rank) a part]}. ``PeerRows``:
    tile row t is gathered row g = (t + r m) mod (W m), row g % m of shard
    g / m; ``PeerSum``: output row i (< m) sums A_q's row r m + i against
    B_q over q; ``PeerLocal``: row i (< W m) of A_r against B_r."""
    if src == "rows":
        out = {}
        for t in range(world * m):
            g = (t + r * m) % (world * m)
            out[g] = [(g // m, g % m, r)]
        return out
    if src == "sum":
        return {i: [(q, r * m + i, q) for q in range(world)]
                for i in range(m)}
    return {i: [(r, i, r)] for i in range(world * m)}


@pytest.mark.parametrize("src", ["rows", "sum", "local"])
def test_bf16_tiles_follow_the_tile_loops(src):
    """At W 1 / 2 / 4 / 8 ranks and m 96 / 128 / 200 / 2016 rows, for
    every rank: the stored rows of every M-tile (its first ``rows``, the
    epilogue's guard) cover the output rows once and none past them, each
    read from the A rows and B of the tile loops' source (so in the plain
    version's gathered or summed order), and every stored row's A row
    lies inside its map (shard maps of m rows for ``WgPeerRows``, W m for
    the others), so none of TMA's zero fill reaches a stored row."""
    for world, m in itertools.product((1, 2, 4, 8), (96, 128, 200, 2016)):
        out_rows = {"rows": world * m, "sum": m, "local": world * m}[src]
        map_rows = m if src == "rows" else world * m
        for r in range(world):
            got = {}
            for t in range(_src_tiles(src, m, world)):
                parts, out0, rows = _src_tile(src, t, r, m, world)
                assert 1 <= rows <= BM
                for j in range(rows):
                    reads = [(q, a0 + j, b) for q, a0, b in parts]
                    assert all(0 <= row < map_rows for _, row, _ in reads)
                    assert out0 + j not in got
                    got[out0 + j] = reads
            assert sorted(got) == list(range(out_rows)), (world, m, r)
            assert got == _loop_reads(src, r, m, world), (world, m, r)


def _band_tile(bx, by, nx, ny, band=8):
    """``wg_gemm_kernel``'s tile order: block (bx, by) of an (nx, ny) grid
    → (M-tile, N-tile), in bands of ``band`` M-tiles, M fastest within."""
    pid = by * nx + bx
    first = pid // (band * nx) * band
    rows = min(band, ny - first)
    i = pid - first * nx
    return first + i % rows, i // rows


@pytest.mark.parametrize("grid", [(1, 1), (48, 64), (12, 64), (16, 16),
                                  (1, 2), (3, 17), (16, 63)])
def test_band_order_covers_the_grid_once(grid):
    """The banded tile order is a permutation of the grid's (M-tile,
    N-tile) pairs (the last band short where the M-tiles do not divide),
    and within a band consecutive blocks walk the band's M-tiles before
    the next N-tile: ``WG_BAND`` consecutive blocks share one B column
    block."""
    assert _const("WG_BAND") == 8
    nx, ny = grid
    order = [_band_tile(bx, by, nx, ny) for by in range(ny)
             for bx in range(nx)]
    assert sorted(order) == [(m, n) for m in range(ny) for n in range(nx)]
    for pid in range(min(len(order), 8 * nx) - 1):
        (m, n), (m2, n2) = order[pid], order[pid + 1]
        assert (m2, n2) == ((m + 1, n) if m + 1 < min(8, ny) else (0, n + 1))


@pytest.mark.parametrize("rows", [1, 8, 96, 128])
@pytest.mark.parametrize("esize", [2, 4])
def test_epilogue_stores_the_tiles_rows_once(rows, esize):
    """The epilogue's store loop (``idx < tile.rows * PIECES``, stride the
    256 consumer threads, 16-byte pieces of a 256-column row) writes each
    piece of the tile's first ``rows`` rows once and nothing of the rows
    past them."""
    pieces = BN // (16 // esize)
    seen = np.zeros((BM, pieces), np.int64)
    for tid in range(256):
        for idx in range(tid, rows * pieces, 256):
            seen[idx // pieces, idx % pieces] += 1
    assert (seen[:rows] == 1).all() and (seen[rows:] == 0).all()


def test_epilogue_staging_covers_the_tile_without_conflicts():
    """Accumulator 4j + e of a consumer thread is tile row r0 + 8 (e >>
    1), column 8j + 2 tq + (e & 1): the 256 threads' fragments cover the
    128 x 256 tile once. Stored as bf16x2 words (or f32 pairs) at a row
    pitch of 264 elements, a warp's store of one j touches each bank once
    (f32: each half warp)."""
    seen = np.zeros((BM, BN), np.int64)
    pitch = BN + 8
    for tid in range(256):
        wg, warp, lane = tid >> 7, tid >> 5, tid & 31
        g, tq = lane >> 2, lane & 3
        r0 = wg * 64 + (warp & 3) * 16 + g
        for j in range(BN // 8):
            for e in range(4):
                seen[r0 + 8 * (e >> 1), 8 * j + 2 * tq + (e & 1)] += 1
    assert (seen == 1).all()
    for j in (0, 5, 31):
        lanes = [(g, tq) for g in range(8) for tq in range(4)]
        bf16 = [((g * pitch + 8 * j + 2 * tq) * 2 // 4) % 32 for g, tq in lanes]
        assert len(set(bf16)) == 32
        for half in (lanes[:16], lanes[16:]):
            f32 = [((g * pitch + 8 * j + 2 * tq) + e) % 32
                   for g, tq in half for e in (0, 1)]
            assert len(set(f32)) == 32


# ----------------------------------------------------- the form predicate

class _At:
    """A stand-in tensor: only its data pointer."""

    def __init__(self, ptr):
        self.ptr = ptr

    def data_ptr(self):
        return self.ptr


def _form(m, k, n, world=4, dtype=torch.bfloat16, out=torch.bfloat16,
          codes=False, off=0):
    tensors = [_At(4096 * (i + 1)) for i in range(3 * world + int(codes))]
    tensors[-1] = _At(tensors[-1].ptr + off)
    return agm.wgmma_form(m, k, n, world, dtype, out, tensors, codes=codes)


def test_wire_path_shapes_take_wgmma():
    """The Llama-2-7B tp = 4 wire path's six shapes (the smoke's and
    ``ab_wire.py``'s): the AG-GEMM's wqkv and up on fp8 and int8 codes
    (m 2048, K 4096, N 3072 / 2752), the partials' wo and down (2048 rows
    a destination, K 1024 / 2752, N 4096), in bf16 and f32 outputs."""
    for out in (torch.bfloat16, torch.float32):
        for n in (3072, 2752):
            assert _form(2048, 4096, n, out=out, codes=True)
        for k in (1024, 2752):
            assert _form(2048, k, 4096, out=out)


@pytest.mark.parametrize("case,want", [
    (dict(m=128, k=208, n=136, codes=True), True),    # card test shapes
    (dict(m=128, k=200, n=136), True),                # K tail, partials
    (dict(m=128, k=200, n=136, codes=True), False),   # codes rows 200 B
    (dict(m=128, k=256, n=256, world=1), True),
    (dict(m=128, k=256, n=256, world=8), True),
    (dict(m=128, k=256, n=256, world=9), False),      # maps for 8 ranks
    (dict(m=64, k=256, n=256, codes=True), False),    # a tile spans shards
    (dict(m=37, k=72, n=40, codes=True), False),      # the odd card shapes
    (dict(m=64, k=70, n=136, codes=True), False),
    (dict(m=32, k=50, n=196), False),
    (dict(m=64, k=136, n=72, codes=True), False),
    (dict(m=128, k=256, n=196), False),               # N rows not 16 B
    (dict(m=128, k=252, n=256), False),               # K rows not 16 B
    (dict(m=128, k=256, n=256, off=8), False),        # a base 8 B off
    (dict(m=128, k=256, n=256, dtype=torch.float32,
          out=torch.float32), False),                 # f32: the FMA loop
    (dict(m=128, k=256, n=256, out=torch.float16), False),
    (dict(m=2016, k=4096, n=3072), True),             # the CP prefill's AG
    (dict(m=2016, k=1024, n=4096), True),             # and its GEMM-RS
    (dict(m=2016, k=4096, n=3072, codes=True), False),  # the wire's rule
    (dict(m=2016, k=4096, n=3072, dtype=torch.float32,
          out=torch.float32), False),                 # f32: the FMA loop
    (dict(m=2016, k=4096, n=3072, off=8), False),     # a base 8 B off
    (dict(m=64, k=256, n=256), True),                 # a shard's one tile
    (dict(m=200, k=136, n=72, world=1), True),        # world size 1, any M
    (dict(m=8064, k=4096, n=11008, world=1), True),
    (dict(m=1, k=8, n=8, world=1), True),
    (dict(m=200, k=70, n=72, world=1), False),        # K rows not 16 B
])
def test_form_predicate(case, want):
    """Which shapes, types and alignments take the warpgroup GEMM: the
    wire's codes keep the multiple of 128 rows a shard, the bf16 sources
    take any row count."""
    assert _form(**case) is want


def test_forms_are_counted_and_cleared():
    """``count_form`` tallies each entry's launches by form name, and
    ``reset_launch_counts`` clears every tally: the wires', the mesh
    GEMMs' and the world-size-1 GEMMs'."""
    from triton_distributed_tpu_torch.kernels import reset_launch_counts

    fns = (agm.ag_gemm_w_launch, grs.gemm_rs_partials,
           agm._ag_gemm_mesh_cuda, grs._gemm_rs_mesh_cuda,
           agm._ag_gemm_cuda, grs._gemm_rs_cuda)
    for i, fn in enumerate(fns):
        agm.count_form(fn, i % 3)
        assert fn.by_variant.get(agm.MESH_GEMM_FORMS[i % 3], 0) >= 1
    reset_launch_counts()
    for fn in fns:
        assert fn.by_variant == {}


# ------------------------------------------------- parity with the JAX package

W = 4


@pytest.fixture(scope="module")
def jmesh():
    return JMesh(np.asarray(jax.devices()[:W]), ("tp",))


def _shards(a, dim=0):
    return [torch.from_numpy(np.array(x)) for x in
            np.split(np.asarray(a, np.float32), W, axis=dim)]


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("wire", ["fp8", "int8"])
def test_wires_match_jax_at_a_tile_shard(jmesh, wire):
    """At 128 rows a shard (one tile of the warpgroup GEMM), an outlier
    row x1000 in shard 0: the port's AG-GEMM and GEMM-RS wires on the CPU
    (their plain versions, which the card's kernels are held to) within
    1e-5 of the largest output of JAX's XLA ring twins on the same wire
    (the same codes, summed in another order)."""
    tmesh = Mesh.loopback(W, "cpu")
    rng = np.random.default_rng(7)
    m, k, n = 128, 256, 128
    a = rng.standard_normal((W * m, k)).astype(np.float32)
    a[3] *= 1000.0
    b = (rng.standard_normal((k, W * n)) / np.sqrt(k)).astype(np.float32)
    want = np.asarray(j_ag_gemm(jnp.asarray(a), jnp.asarray(b), jmesh, "tp",
                                method=AGGemmMethod.XLA_RING,
                                wire_dtype=wire))
    ctx = ops.create_ag_gemm_context(
        tmesh, "tp", method=agm.AGGemmMethod.XLA_RING, wire_dtype=wire)
    got = ops.ag_gemm(_shards(a), _shards(b, 1), ctx)
    for r, g in enumerate(got):
        assert _rel(g, want[:, r * n:(r + 1) * n]) < 1e-5
    kq = k // W
    b2 = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    want = np.asarray(j_gemm_rs(jnp.asarray(a), jnp.asarray(b2), jmesh, "tp",
                                method=GemmRSMethod.XLA_RING,
                                wire_dtype=wire))
    ctx = ops.create_gemm_rs_context(
        tmesh, "tp", method=grs.GemmRSMethod.XLA_RING, wire_dtype=wire)
    got = ops.gemm_rs(_shards(a, 1), _shards(b2), ctx)
    for r, g in enumerate(got):
        assert g.shape == (m, n) and kq * W == k
        assert _rel(g, want[r * m:(r + 1) * m]) < 1e-5


@pytest.mark.parametrize("w", [1, W])
def test_bf16_gemms_match_jax_at_a_ragged_shard(w):
    """At 200 rows a shard (one whole tile of the warpgroup GEMM and a
    partial one) and K 200 a rank (a K tail past three 64-deep stages),
    bf16 operands and f32 outputs, over a mesh of ``w`` ranks (1: the
    world-size-1 call on tensors): the port's AG-GEMM and GEMM-RS on the
    CPU (their plain versions, which the card's kernels are held to)
    within 1e-5 of the largest output of JAX's ``ag_gemm`` /
    ``gemm_rs`` (the same products summed in another order)."""
    jm = JMesh(np.asarray(jax.devices()[:w]), ("tp",))
    tmesh = Mesh.loopback(w, "cpu")
    rng = np.random.default_rng(8)
    m, k, n = 200, 200, 136
    bf = jnp.bfloat16
    a = jnp.asarray(rng.standard_normal((w * m, k)), bf)
    b = jnp.asarray(rng.standard_normal((k, w * n)) / np.sqrt(k), bf)
    want = np.asarray(j_ag_gemm(a, b, jm, "tp", method=AGGemmMethod.XLA_RING,
                                out_dtype=jnp.float32))
    ta = torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    tb = torch.from_numpy(np.asarray(b, np.float32)).to(torch.bfloat16)
    if w == 1:
        got = [agm.ag_gemm(ta, tb, out_dtype=torch.float32)]
    else:
        got = agm.ag_gemm(list(ta.chunk(w)), list(tb.chunk(w, 1)), tmesh,
                          out_dtype=torch.float32)
    for r, g in enumerate(got):
        assert g.dtype == torch.float32 and g.shape == (w * m, n)
        assert _rel(g, want[:, r * n:(r + 1) * n]) < 1e-5
    a2 = jnp.asarray(rng.standard_normal((w * m, w * k)), bf)
    b2 = jnp.asarray(rng.standard_normal((w * k, n)) / np.sqrt(w * k), bf)
    want = np.asarray(j_gemm_rs(a2, b2, jm, "tp",
                                method=GemmRSMethod.XLA_RING,
                                out_dtype=jnp.float32))
    ta = torch.from_numpy(np.asarray(a2, np.float32)).to(torch.bfloat16)
    tb = torch.from_numpy(np.asarray(b2, np.float32)).to(torch.bfloat16)
    if w == 1:
        got = [grs.gemm_rs(ta, tb, out_dtype=torch.float32)]
    else:
        got = grs.gemm_rs(list(ta.chunk(w, 1)), list(tb.chunk(w)), tmesh,
                          out_dtype=torch.float32)
    for r, g in enumerate(got):
        assert g.dtype == torch.float32 and g.shape == (m, n)
        assert _rel(g, want[r * m:(r + 1) * m]) < 1e-5


def test_ab_script_imports_no_jax():
    """``ab_wire.py``, ``ab_tp.py``, ``ab_moe_wire.py`` and the runner they
    share, ``ab_common.py`` (run on the card machine, which has no JAX),
    and the child each script starts in each tree import nothing of JAX or
    of the JAX package."""
    import ab_moe_wire
    import ab_tp
    import ab_wire

    root = csrc_dir().parents[1]
    for script, child in (("ab_wire.py", ab_wire.CHILD),
                          ("ab_tp.py", ab_tp.CHILD),
                          ("ab_moe_wire.py", ab_moe_wire.CHILD),
                          ("ab_common.py", "")):
        text = (root / script).read_text() + child
        for line in text.splitlines():
            hit = re.match(r"^\s*(?:import|from)\s+([\w.]+)", line)
            if hit:
                assert hit.group(1).split(".")[0] not in (
                    "jax", "jaxlib", "triton_distributed_tpu"), line
