"""CPU checks of the grouped warpgroup GEMM's host-side pieces
(``csrc/wg_gemm.cuh`` ``wg_grouped_kernel`` under ``tdt_ag_group_gemm_w``
and ``tdt_moe_reduce_rs_partials``, the MoE-TP wire's two bf16 grouped
GEMMs, and under the bf16 MoE-TP pair ``tdt_ag_group_gemm_mesh`` /
``tdt_moe_reduce_rs_mesh`` and their world-size-1 entries), whose kernel
runs only on a card (``tests/test_torch_cuda.py::TestGroupedWgmma``,
``TestGroupedWgmmaBf16``), emulated in numpy:

* the persistent grid's tile walk covers every (rank, M-tile, N-tile)
  once, and the row sources' tile maps agree with the tile loops'
  ``PeerGatherRowsQ::at``, grouped ``PeerLocal``, ``PeerGatherRows::at``
  and grouped ``PeerSum`` (``csrc/ggemm_tiles.cuh``): the tile's expert
  ``be[s, i / block_m]``, the own slab against a peer's codes, each row's
  chunk scale, each gathered row's (shard, token), the RS's parts with
  their rows, weights and K edges, the all-padding tiles that skip their K
  loop;
* the bf16 AG's gather: each thread's 16-byte ``cp.async`` pieces land
  once each where TMA's 128-byte swizzle puts them, and the stage's full
  barrier counts the arrivals its producers make;
* the weight's 3-D tensor map: the boxes a tile loads cover its expert's
  (K, N) block once, the K edge (352 = 5.5 stages) and the N edges (352,
  88) as TMA's zeros, never the next expert's rows;
* the epilogue tile in the 128-byte swizzle: the consumer threads' writes
  cover it once without bank conflicts, and the TMA store boxes put every
  accumulator at its output row and column;
* the tile widths, stage counts and shared memory against the C source;
* the form predicate (``ag_gemm.grouped_wgmma_form``) at the wire path's,
  the bf16 prefill's and off-rule shapes, and the six wrappers' form
  tallies; the wrappers' ctypes signatures against the C entries;
* on the CPU, the slabs ``quantize_sorted`` returns are
  ``gather_sorted``'s, and the codes and scales are those of the slabs.
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from triton_distributed_tpu_torch.config import csrc_dir
from triton_distributed_tpu_torch.kernels import ag_gemm as agm
from triton_distributed_tpu_torch.kernels import moe_tp_fused as mtf
from triton_distributed_tpu_torch.kernels import moe_utils as mu
from triton_distributed_tpu_torch.kernels import wire as wk

BM, BK = 128, 64          # a tile's rows, k a stage
SMEM_MAX = 232448         # shared memory a CTA may take on an H100


def _src():
    return (csrc_dir() / "wg_gemm.cuh").read_text()


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", _src()).group(1))


def _routing(seed, w, m_s, topk, e, block_m):
    """The stacked (W, cap_s) sorted ids and (W, cap_s / block_m) block
    table of W seeded shards, expert 1 empty."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((w * m_s, e)).astype(np.float32)
    logits[:, 1] = -1e4
    _, ids = mu.select_experts(torch.from_numpy(logits), topk)
    sti, be, _ = mu.moe_align_block_size(ids.reshape(w, m_s, topk), e,
                                         block_m)
    return sti.numpy(), be.numpy()


def _walk(ntiles, grid):
    """The tiles each CTA of the persistent grid takes: t = blockIdx.x,
    + gridDim.x, ..."""
    return [list(range(b, ntiles, grid)) for b in range(grid)]


def _decode(t, mt, nt, bn, rank0=0):
    """Tile t's (rank, first row m0, first column n0): N-tiles fastest,
    then M-tiles, then ranks."""
    return rank0 + t // (mt * nt), t // nt % mt * BM, t % nt * bn


def _ag_tile(r, m0, sti, be, cap_s, block_m, total):
    """``WgPeerGatherRowsQ::tile``: (codes, skip, expert); A's row is m0
    in the codes' map or the slab stack's."""
    flat = sti.reshape(-1)
    return (m0 // cap_s != r, int(flat[m0]) >= total,
            int(be.reshape(-1)[m0 // block_m]))


def _peer_gather_rows_q_at(t, r, sti, cap_s, topk, total, chunk_rows):
    """``PeerGatherRowsQ::at`` of the tile loops: (kind, source row, scale
    index) of sorted row t of rank r: None past the sentinel, ('x', token)
    for the own shard, ('q', t) with scale s[t / chunk_rows] for a
    peer's."""
    v = int(sti.reshape(-1)[t])
    if v < 0 or v >= total:
        return None
    if t // cap_s == r:
        return ("x", v // topk)
    return ("q", t, t // chunk_rows)


@pytest.mark.parametrize("shape", [(64, 6, 16, 128, 64), (100, 2, 8, 256, 32),
                                   (37, 3, 6, 128, 128)])
@pytest.mark.parametrize("w", [1, 2, 4])
def test_ag_tiles_follow_peer_gather_rows_q(shape, w):
    """Rank r's tile m0: every row of it lies in one shard and one routing
    block, so one expert, ``be[s, i / block_m]``; a peer shard's rows are
    its codes (row g of q, scale s[g / chunk_rows], as ``at`` reads them),
    the own shard's the slab stack's row g, which is ``gather_sorted`` of
    the token ``at`` names (zeros at the sentinel); a tile is skipped only
    when every row is padding, and some are (trailing blocks). The grid's
    walk stores every output row of every rank once."""
    m_s, topk, e, block_m, chunk_rows = shape
    sti, be = _routing(80 + w, w, m_s, topk, e, block_m)
    cap_s, total = sti.shape[1], m_s * topk
    assert cap_s % BM == 0 and cap_s % chunk_rows == 0
    x = np.random.default_rng(3).standard_normal((w, m_s, 8))
    slabs = mu.gather_sorted(torch.from_numpy(x), torch.from_numpy(sti),
                             topk).numpy().reshape(w * cap_s, 8)
    mt, nt, bn = w * cap_s // BM, 2, 192
    seen = np.zeros((w, w * cap_s, nt), np.int64)
    skipped = 0
    for tiles in _walk(w * mt * nt, 7):
        for t in tiles:
            r, m0, n0 = _decode(t, mt, nt, bn)
            codes, skip, expert = _ag_tile(r, m0, sti, be, cap_s, block_m,
                                           total)
            seen[r, m0:m0 + BM, n0 // bn] += 1
            skipped += skip
            refs = [_peer_gather_rows_q_at(g, r, sti, cap_s, topk, total,
                                           chunk_rows)
                    for g in range(m0, m0 + BM)]
            assert skip == all(ref is None for ref in refs)
            for g, ref in zip(range(m0, m0 + BM), refs):
                s, i = divmod(g, cap_s)
                assert expert == be[s, i // block_m]
                assert codes == (s != r)
                if ref is None:
                    assert not slabs[g].any()
                elif codes:
                    assert ref == ("q", g, g // chunk_rows)
                else:
                    assert ref[0] == "x" and (slabs[g] == x[r, ref[1]]).all()
    assert (seen == 1).all()
    assert 0 < skipped < w * mt * nt


@pytest.mark.parametrize("w", [1, 2, 4])
def test_partial_tiles_follow_grouped_peer_local(w):
    """``WgGroupedLocal``: rank r's tile m0 reads y_r's rows m0.. in place
    against ``be[m0 / block_m]``, which is grouped ``PeerLocal``'s expert
    for every row of the tile (the stacked table: destination d's sorted
    row i at d·cap_s + i takes be[d, i / block_m]); nothing is skipped,
    and the walk stores every row and column block of every rank once."""
    sti, be = _routing(90 + w, w, 50, 4, 8, 256)
    cap_s = sti.shape[1]
    mt, nt, bn = w * cap_s // BM, 2048 // 256, 256
    seen = np.zeros((w, w * cap_s, nt), np.int64)
    for tiles in _walk(w * mt * nt, 132):
        for t in tiles:
            r, m0, n0 = _decode(t, mt, nt, bn)
            expert = int(be.reshape(-1)[m0 // 256])
            for m in range(m0, m0 + BM):
                d, i = divmod(m, cap_s)
                assert expert == be[d, i // 256]      # PeerLocal::expert
            seen[r, m0:m0 + BM, n0 // bn] += 1
    assert (seen == 1).all()


def _tma_box(t, c):
    """A TMA box of tensor ``t`` (dims innermost last in numpy order) at
    coordinates ``c`` (innermost first) of the box shape (64, 64, 1):
    elements past the tensor are zeros."""
    e, k, n = c[2], c[1], c[0]
    box = np.zeros((1, BK, 64), t.dtype)
    part = t[e:e + 1, k:k + BK, n:n + 64]
    box[:, :part.shape[1], :part.shape[2]] = part
    return box[0]


@pytest.mark.parametrize("k,n,bn", [(352, 2048, 256), (2048, 352, 192),
                                    (352, 88, 192), (144, 200, 192)])
def test_weight_boxes_cover_the_experts_block(k, n, bn):
    """The producer's B boxes of a tile (``nbox = min(BN / 64, ceil((N -
    n0) / 64))`` boxes at (n0 + 64 j, k0, expert) a stage, ``ceil(K /
    64)`` stages) in the 3-D map (N, K, E) assemble the expert's (K, N)
    block's columns [n0, n0 + BN) with zeros past K and N: at K 352 the
    last stage's 32 rows past the edge are zeros where a 2-D map over (E
    K, N) would read the next expert's first rows."""
    e = 3
    wts = np.arange(1, e * k * n + 1, dtype=np.float64).reshape(e, k, n)
    nk = -(-k // BK)
    for expert in range(e):
        for n0 in range(0, n, bn):
            nbox = min(bn // 64, -(-(n - n0) // 64))
            tile = np.zeros((nk * BK, bn))
            for kk in range(nk):
                for j in range(nbox):
                    tile[kk * BK:(kk + 1) * BK, 64 * j:64 * (j + 1)] = (
                        _tma_box(wts, (n0 + 64 * j, kk * BK, expert)))
            want = np.zeros_like(tile)
            blk = wts[expert, :, n0:n0 + bn]
            want[:k, :blk.shape[1]] = blk
            assert (tile == want).all()
    if k % BK:
        flat = wts.reshape(e * k, n)
        spill = flat[k:nk * BK, :64]       # a 2-D map's last stage, expert 0
        assert (spill == wts[1, :nk * BK - k, :64]).all() and spill.any()


@pytest.mark.parametrize("esize", [2, 4])
@pytest.mark.parametrize("bn", [192, 256])
def test_epilogue_tile_is_swizzled_and_stored_in_place(esize, bn):
    """Accumulator 4j + e of a consumer thread is tile row r0 + 8 (e >>
    1), column 8j + 2tq + (e & 1); the kernel writes its pair at box col /
    EC (EC = 128 / esize columns a 128-byte row), row r, chunk (byte >> 4)
    ^ (r & 7). Every byte of the tile is written once, a warp's write of
    one j meets every bank at most twice in f32 (256 bytes) and once in
    bf16, and TMA's store of box b (chunk c of row r read from c ^ (r &
    7)) puts each accumulator at output column b·EC + its column."""
    ec = 128 // esize
    nbytes = BM * bn * esize
    owner = np.full(nbytes, -1, np.int64)
    for tid in range(256):
        wg, warp, lane = tid >> 7, tid >> 5, tid & 31
        g, tq = lane >> 2, lane & 3
        r0 = wg * 64 + (warp & 3) * 16 + g
        for j in range(bn // 8):
            col = 8 * j + 2 * tq
            byte = col % ec * esize
            for h in (0, 1):
                r = r0 + 8 * h
                addr = (col // ec * BM * 128 + r * 128
                        + (((byte >> 4) ^ (r & 7)) << 4) + (byte & 15))
                for e in (0, 1):
                    a = addr + e * esize
                    assert (owner[a:a + esize] == -1).all()
                    owner[a:a + esize] = r * bn + col + e
    assert (owner >= 0).all()
    # TMA's view: box b, row r, 16-byte chunk c read from chunk c ^ (r & 7)
    for b in range(bn // ec):
        for r in range(BM):
            for c in range(8):
                src = b * BM * 128 + r * 128 + ((c ^ (r & 7)) << 4)
                for x in range(0, 16, esize):
                    col = b * ec + (c * 16 + x) // esize
                    assert owner[src + x] == r * bn + col
    for j in (0, 3, bn // 8 - 1):
        banks = {}
        for lane in range(32):
            g, tq = lane >> 2, lane & 3
            col = 8 * j + 2 * tq
            byte = col % ec * esize
            addr = (col // ec * BM * 128 + g * 128
                    + (((byte >> 4) ^ g) << 4) + (byte & 15))
            for word in range(2 * esize // 4):
                bank = (addr // 4 + word) % 32
                banks[bank] = banks.get(bank, 0) + 1
        assert max(banks.values()) == esize // 2


def _shape(out_esize, bn):
    """``WgGroupShape``: (stages, dynamic shared memory)."""
    stage = BM * BK * 2 + bn // 64 * BK * 64 * 2
    epi = BM * bn * out_esize
    stages = min(6, (SMEM_MAX - 1024 - 256 - epi) // stage)
    return stages, stages * stage + epi + 1024


def test_tile_widths_and_shared_memory_match_the_kernel():
    """The tile widths (256 for the partials' N 2048, 192 for the AG's N_r
    352: 2 tiles of 384 columns against 2 of 512), the 128-byte epilogue
    boxes and the shared-memory ceiling are the C source's; the stages
    that fit beside the epilogue tile (bf16 partials 3, f32 2; AG 4 / 3)
    leave the CTA within 227 KB with the barriers, and the entries use the
    widths they name."""
    assert (_const("WG_GROUP_BN_RS"), _const("WG_GROUP_BN_AG")) == (256, 192)
    assert _const("WG_SMEM_MAX") == SMEM_MAX
    assert re.search(r"constexpr int WG_STORE_BOX = WG_BM \* 128;", _src())
    assert re.search(r"FIT < 6 \? FIT : 6", _src())
    want = {(2, 256): 3, (4, 256): 2, (2, 192): 4, (4, 192): 3}
    for (esize, bn), stages in want.items():
        got, smem = _shape(esize, bn)
        assert got == stages
        assert smem + 2 * 8 * stages <= SMEM_MAX
    for n, bn in ((2048, 256), (352, 192)):
        assert -(-n // bn) * bn <= -(-n // 256) * 256
    cu = (csrc_dir() / "moe_tp_fused.cu").read_text()
    for src, bn in (("WgPeerGatherRowsQ", "AG"), ("WgGroupedLocal", "RS"),
                    ("WgPeerGatherRows", "AG"), ("WgGroupedPeerSum", "RS")):
        assert f"wg_grouped<{src}, WG_GROUP_BN_{bn}>" in cu
    # 25 maps, the gather's 8 shard pointers, 3 table pointers, 8 ints
    params = 25 * 128 + 8 * 8 + 3 * 8 + 8 * 4
    assert params <= 4096


class _At:
    """A stand-in tensor: only its data pointer."""

    def __init__(self, ptr):
        self.ptr = ptr

    def data_ptr(self):
        return self.ptr


def _form(cap_s=20480, block_m=128, k=2048, n=352, world=4,
          dtype=torch.bfloat16, out=torch.bfloat16, codes=True, off=0):
    tensors = [_At(4096 * (i + 1)) for i in range(2 * world + 2)]
    tensors[-1] = _At(tensors[-1].ptr + off)
    return agm.grouped_wgmma_form(cap_s, block_m, k, n, world, dtype, out,
                                  tensors, codes=codes)


@pytest.mark.parametrize("case,want", [
    (dict(), True),                                    # the wire AG
    (dict(k=352, n=2048, codes=False), True),          # the partials
    (dict(out=torch.float32), True),
    (dict(k=352, n=2048, codes=False, out=torch.float32), True),
    (dict(cap_s=2432, k=352, n=88, world=1), True),    # card shapes
    (dict(cap_s=2560, block_m=256, k=352, n=88, world=2), True),
    (dict(block_m=64), False),                         # a tile spans experts
    (dict(cap_s=20416), False),                        # a tile spans shards
    (dict(cap_s=2432, block_m=256), False),            # blocks do not split
    (dict(dtype=torch.float32, out=torch.float32), False),
    (dict(out=torch.float16), False),
    (dict(k=2040), False),                             # codes rows not 16 B
    (dict(k=2040, codes=False), True),                 # bf16 rows: 8
    (dict(k=2044, codes=False), False),
    (dict(n=348), False),                              # N rows not 16 B
    (dict(off=8), False),                              # a base 8 B off
    (dict(world=8), True),
    (dict(world=9), False),                            # maps for 8 ranks
    # the bf16 pair: the tp = 4 prefill's AG and RS, and at world size 1
    (dict(codes=False), True),
    (dict(k=352, n=2048, codes=False), True),
    (dict(cap_s=57344, k=2048, n=1408, world=1, codes=False), True),
    (dict(cap_s=57344, k=1408, n=2048, world=1, codes=False), True),
    (dict(cap_s=57344, k=1408, n=2048, world=1, codes=False,
          dtype=torch.float32, out=torch.float32), False),
    (dict(cap_s=6144, block_m=64, world=1, codes=False), False),
    (dict(codes=False, off=4), False),                 # a token shard 4 B off
])
def test_grouped_form_predicate(case, want):
    """Which shapes, types and alignments take the grouped warpgroup GEMM:
    the MoE wire path's (cap_s 20480, block_m 128; AG K 2048 N 352 a rank
    on codes, partials K 352 N 2048) and the bf16 prefill's (the pair at
    tp = 4, and at world size 1 cap 57344, K 2048 N 1408 and K 1408 N
    2048) do; 64-row blocks, f32, codes rows not a multiple of 16 bytes
    and misaligned bases keep the tile loops."""
    assert _form(**case) is want


def test_grouped_forms_are_counted_and_cleared():
    """The six wrappers on the grouped routes (the wire's AG and
    partials, the bf16 pair over a mesh and at world size 1) tally their
    launches by form, and ``reset_launch_counts`` clears every tally."""
    from triton_distributed_tpu_torch.kernels import reset_launch_counts

    fns = (mtf._ag_group_gemm_w_cuda, mtf._moe_reduce_rs_partials_cuda,
           mtf._ag_group_gemm_mesh_cuda, mtf._moe_reduce_rs_mesh_cuda,
           mtf._ag_group_gemm_cuda, mtf._moe_reduce_rs_cuda)
    for i, fn in enumerate(fns):
        agm.count_form(fn, 2 - i % 3)
        agm.count_form(fn, 2)
        assert fn.by_variant.get(agm.MESH_GEMM_FORMS[2 - i % 3], 0) >= 1
        assert fn.by_variant.get("wgmma", 0) >= 1
    reset_launch_counts()
    assert all(fn.by_variant == {} for fn in fns)


def test_kept_slabs_are_the_gathered_rows():
    """``quantize_sorted`` returns, beside the codes and scales, the
    (W, cap_s, K) slabs ``gather_sorted`` makes (zeros at the sentinel),
    and the codes and scales are the quantizer's of those slabs."""
    w, m_s, topk, e, k = 2, 40, 2, 6, 32
    sti = torch.from_numpy(_routing(5, w, m_s, topk, e, 128)[0])
    rng = np.random.default_rng(6)
    x = list(torch.from_numpy(rng.standard_normal((w, m_s, k)))
             .to(torch.bfloat16).unbind(0))
    fmt = mtf._wire_fmt("int8", sti.shape[1])
    q, s, slabs = mtf.quantize_sorted(x, sti, topk, fmt)
    assert torch.equal(slabs, mu.gather_sorted(torch.stack(x), sti, topk))
    assert (slabs.reshape(-1, k)[sti.reshape(-1) >= m_s * topk] == 0).all()
    q2, s2 = wk.quantize_shards_plain(list(slabs.unbind(0)), fmt)
    assert torch.equal(q, q2) and torch.equal(s, s2)


# ------------------------------------------------- the bf16 MoE-TP pair

def _tma_rows(t, r0, k0, rows=BM, cols=BK):
    """A TMA box of the 2-D (R, K) tensor ``t`` at rows r0.., columns
    k0..: elements past the tensor are zeros."""
    box = np.zeros((rows, cols), t.dtype)
    part = t[r0:r0 + rows, k0:k0 + cols]
    box[:part.shape[0], :part.shape[1]] = part
    return box


def _weight_tile(wts, expert, k0, n0, bn):
    """The producer's B boxes of one stage, assembled: (BK, bn) of the
    expert's (K, N) block from (n0, k0) through the 3-D map (zeros past K
    and N; boxes starting past N not loaded)."""
    n = wts.shape[2]
    tile = np.zeros((BK, bn), wts.dtype)
    for j in range(min(bn // 64, -(-(n - n0) // 64))):
        tile[:, 64 * j:64 * (j + 1)] = _tma_box(
            wts, (n0 + 64 * j, k0, expert))
    return tile


def _int_operands(seed, shape):
    """Small integers as float64 (exact sums in any order)."""
    return np.random.default_rng(seed).integers(-3, 4, shape).astype(
        np.float64)


@pytest.mark.parametrize("w", [1, 2, 4])
def test_rs_tiles_follow_grouped_peer_sum(w):
    """``WgGroupedPeerSum``: destination r's tile m0 sums w parts, part q
    reading y_q's rows r·cap_s + m0.. (its 2-D map) against w_q's 3-D map
    at the destination's block's expert ``be[r, m0 / block_m]`` (grouped
    ``PeerSum::expert``), each part's K of 352 in 5.5 stages with the last
    half TMA's zeros; the stored tiles equal Σ_q y_q[r·cap_s + i] @
    w_q[be[r, i / block_m]] exactly (integers), N 200 a partial tile, and
    the walk stores every destination row and column block once."""
    sti, be = _routing(100 + w, w, 40, 2, 6, 128)
    cap_s, f, h, bn, e = sti.shape[1], 352, 200, 256, 6
    y = _int_operands(1, (w, w * cap_s, f))
    wts = _int_operands(2, (w, e, f, h))
    want = np.zeros((w, cap_s, h))
    for r in range(w):
        for i in range(cap_s):
            ex = be[r, i // 128]
            want[r, i] = sum(y[q, r * cap_s + i] @ wts[q, ex]
                             for q in range(w))
    mt, nt, nk = cap_s // BM, -(-h // bn), -(-f // BK)
    got = np.full((w, cap_s, h), np.nan)
    seen = np.zeros((w, mt, nt), np.int64)
    for tiles in _walk(w * mt * nt, 7):
        for t in tiles:
            r, m0, n0 = _decode(t, mt, nt, bn)
            g = r * cap_s + m0
            expert = int(be.reshape(-1)[g // 128])
            # one block, so one expert, for every row of the tile
            assert all(be[r, i // 128] == expert for i in range(m0, m0 + BM))
            acc = np.zeros((BM, bn))
            for q in range(w):
                for kk in range(nk):
                    acc += (_tma_rows(y[q], g, kk * BK)
                            @ _weight_tile(wts[q], expert, kk * BK, n0, bn))
            cols = min(bn, h - n0)
            got[r, m0:m0 + BM, n0:n0 + cols] = acc[:, :cols]
            seen[r, m0 // BM, n0 // bn] += 1
    assert (seen == 1).all()
    assert np.array_equal(got, want)


def _swizzle128(addr):
    """TMA's 128-byte swizzle of a byte offset in a 1024-aligned box: the
    16-byte chunk bits [4:6] XOR the row bits [7:9]."""
    return addr ^ ((addr >> 3) & 0x70)


def test_gather_pieces_land_once_where_tma_puts_them():
    """The bf16 AG's producer: thread t copies piece c = t % 8 (bytes
    16c..16c+15 of a row's 128 of a stage) of rows g = t / 8 + 16 j, j =
    0..7, to g·128 + ((c ^ (g & 7)) << 4), which it computes as one base
    plus j·2048; those 1024 destinations cover the 16 KB box once each and
    are TMA's 128-byte swizzle of (g, c), the layout the consumers'
    descriptors read; each warp instruction (one j) reads four whole
    128-byte rows. A stage's full barrier is initialised to the arrivals
    its producers make: the TMA thread's expect_tx and one
    ``cp.async.mbarrier.arrive.noinc`` a thread; its byte count is B's
    boxes only, A coming by cp.async."""
    dst, ref, rows = [], [], []
    for t in range(128):
        c, g0 = t % 8, t // 8
        base = g0 * 128 + ((c ^ (g0 & 7)) << 4)
        for j in range(BM * 8 // 128):
            g = g0 + 16 * j
            dst.append(base + j * 16 * 128)
            ref.append(_swizzle128(g * 128 + 16 * c))
            rows.append((t // 32, j, g, c))
    assert sorted(dst) == list(range(0, BM * 128, 16))
    assert dst == ref
    for w in range(4):
        for j in range(8):
            got = sorted((g, c) for w_, j_, g, c in rows
                         if (w_, j_) == (w, j))
            g0 = sorted({g for g, _ in got})
            assert len(g0) == 4 and got == [(g, c) for g in g0
                                            for c in range(8)]
    src = _src()
    kernel = src[src.index("wg_grouped_kernel(const __grid_constant__"):]
    init = re.search(r"tc_bar_init\(&full\[st\], Src::kGather \? 1 \+ "
                     r"(\d+) : 1\);", kernel)
    copiers = 128 - 0                     # every thread of the warpgroup
    arrivals = 1 + copiers                # + the TMA thread's expect_tx
    assert init and 1 + int(init.group(1)) == arrivals
    assert "wg_cp_arrive(&full[st]);" in kernel
    assert re.search(r"const int bytes = \(Src::kGather \? 0", kernel)
    regs = re.search(r"P = Src::kGather \? (\d+) : (\d+);\s+"
                     r"static constexpr int C = Src::kGather \? (\d+) : "
                     r"(\d+);", src)
    pg, pt, cg, ct = map(int, regs.groups())
    for p_, c_ in ((pg, cg), (pt, ct)):
        assert 128 * p_ + 256 * c_ == 384 * 168
        assert p_ % 8 == 0 and c_ % 8 == 0 and p_ >= 24


#: the producer's placement: element e of piece c of the box's row t at
#: (t·128 + ((c ^ (t & 7)) << 4)) / 2 + e, in (t, 8c + e) order; and the
#: consumers' view: element (i, j) at the swizzle of i·128 + 2j
_T, _C, _E = np.meshgrid(np.arange(BM), np.arange(8), np.arange(8),
                         indexing="ij")
_PLACE = ((_T * 128 + ((_C ^ (_T & 7)) << 4)) // 2 + _E).reshape(-1)
_VIEW = _swizzle128(np.arange(BM)[:, None] * 128
                    + 2 * np.arange(BK)[None, :]) // 2


@pytest.mark.parametrize("shape", [(40, 2, 6, 144, 200, 128),
                                   (64, 6, 16, 128, 352, 128),
                                   (50, 2, 8, 88, 88, 256)])
@pytest.mark.parametrize("w", [1, 2, 4])
def test_gather_tiles_follow_peer_gather_rows(shape, w):
    """``WgPeerGatherRows``: rank r's tile m0 (one shard, one block, one
    expert ``be[s, i / block_m]``) is skipped exactly when every row is
    padding (its first row the sentinel), and otherwise its row i is
    sorted row g = m0 + i as ``PeerGatherRows::at`` reads it: token sti[g]
    / topk of shard g / cap_s, zeros at the sentinel; the pieces past K (K
    144: 2.25 stages) are zeros. The stages read back through the
    swizzle, times the rank's expert weight, equal the plain version's
    rows exactly (integers); the walk stores every row of every rank
    once."""
    m_s, topk, e, k, n, bm = shape
    sti, be = _routing(110 + w, w, m_s, topk, e, bm)
    cap_s, total, bn = sti.shape[1], m_s * topk, 192
    x = _int_operands(3, (w, m_s, k))
    wts = _int_operands(4, (w, e, k, n))
    slabs = mu.gather_sorted(torch.from_numpy(x), torch.from_numpy(sti),
                             topk).numpy().reshape(w * cap_s, k)
    flat_sti, flat_be = sti.reshape(-1), be.reshape(-1)
    mt, nt, nk = w * cap_s // BM, -(-n // bn), -(-k // BK)
    got = np.full((w, w * cap_s, n), np.nan)
    seen = np.zeros((w, mt, nt), np.int64)
    skipped = 0
    for tiles in _walk(w * mt * nt, 5):
        for t in tiles:
            r, m0, n0 = _decode(t, mt, nt, bn)
            skip = int(flat_sti[m0]) >= total
            expert = int(flat_be[m0 // bm])
            seen[r, m0 // BM, n0 // bn] += 1
            rows = [None if int(flat_sti[g]) >= total
                    else (g // cap_s, int(flat_sti[g]) // topk)
                    for g in range(m0, m0 + BM)]
            assert skip == all(v is None for v in rows)
            cols = min(bn, n - n0)
            if skip:
                skipped += 1
                got[r, m0:m0 + BM, n0:n0 + cols] = 0.0
                continue
            # thread t's row, zeros at the sentinel and past K
            src = np.zeros((BM, nk * BK))
            for tt, v in enumerate(rows):
                if v is not None:
                    src[tt, :k] = x[v[0], v[1]]
            acc = np.zeros((BM, bn))
            for kk in range(nk):
                box = np.zeros(BM * BK)     # the stage's A box, in elements
                box[_PLACE] = src[:, kk * BK:(kk + 1) * BK].reshape(-1)
                a = box[_VIEW]              # the consumers' view
                assert np.array_equal(a, _tma_rows(slabs, m0, kk * BK))
                assert expert == flat_be[(m0 + BM - 1) // bm]
                acc += a @ _weight_tile(wts[r], expert, kk * BK, n0, bn)
            got[r, m0:m0 + BM, n0:n0 + cols] = acc[:, :cols]
    assert (seen == 1).all()
    assert 0 < skipped < w * mt * nt
    for r in range(w):
        want = np.stack([slabs[g] @ wts[r, flat_be[g // bm]]
                         for g in range(w * cap_s)])
        assert np.array_equal(got[r], want)


def _c_entries():
    """{name: ctypes letters} of the extern "C" entries of
    ``csrc/moe_tp_fused.cu``: p for a pointer, i for an int."""
    cu = (csrc_dir() / "moe_tp_fused.cu").read_text()
    out = {}
    for name, args in re.findall(r"\nint (tdt_\w+)\(([^)]*)\)\s*\{", cu):
        out[name] = "".join("p" if "*" in a else "i"
                            for a in args.split(","))
    return out


def test_wrapper_signatures_match_the_c_entries():
    """Every ``_build.function`` of ``kernels/moe_tp_fused.py`` declares
    its C entry's arguments, one ctypes letter each, in order: a missing
    or extra argument would be passed as garbage."""
    import inspect

    py = inspect.getsource(mtf)
    entries = _c_entries()
    found = re.findall(r'_build\.function\(\s*"(tdt_\w+)",\s*([^)]+?)\)',
                       py)
    assert {n for n, _ in found} >= {"tdt_ag_group_gemm", "tdt_moe_reduce_rs",
                                     "tdt_ag_group_gemm_mesh",
                                     "tdt_moe_reduce_rs_mesh",
                                     "tdt_ag_group_gemm_w",
                                     "tdt_moe_reduce_rs_partials"}
    for name, sig in found:
        assert eval(sig, {"__builtins__": {}}) == entries[name], name
