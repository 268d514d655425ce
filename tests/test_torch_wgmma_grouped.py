"""CPU checks of the grouped warpgroup GEMM's host-side pieces
(``csrc/wg_gemm.cuh`` ``wg_grouped_kernel`` under ``tdt_ag_group_gemm_w``
and ``tdt_moe_reduce_rs_partials``, the MoE-TP wire's two bf16 grouped
GEMMs), whose kernel runs only on a card
(``tests/test_torch_cuda.py::TestGroupedWgmma``), emulated in numpy:

* the persistent grid's tile walk covers every (rank, M-tile, N-tile)
  once, and the two row sources' tile maps agree with the tile loops'
  ``PeerGatherRowsQ::at`` and grouped ``PeerLocal`` (``csrc/
  ggemm_tiles.cuh``): the tile's expert ``be[s, i / block_m]``, the own
  slab against a peer's codes, each row's chunk scale, the all-padding
  tiles that skip their K loop;
* the weight's 3-D tensor map: the boxes a tile loads cover its expert's
  (K, N) block once, the K edge (352 = 5.5 stages) and the N edges (352,
  88) as TMA's zeros, never the next expert's rows;
* the epilogue tile in the 128-byte swizzle: the consumer threads' writes
  cover it once without bank conflicts, and the TMA store boxes put every
  accumulator at its output row and column;
* the tile widths, stage counts and shared memory against the C source;
* the form predicate (``ag_gemm.grouped_wgmma_form``) at the wire path's
  and off-rule shapes, and the wrappers' form tallies;
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
    assert "wg_grouped<WgPeerGatherRowsQ, WG_GROUP_BN_AG>" in cu
    assert "wg_grouped<WgGroupedLocal, WG_GROUP_BN_RS>" in cu
    params = 25 * 128 + 3 * 8 + 7 * 4
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
])
def test_grouped_form_predicate(case, want):
    """Which shapes, types and alignments take the grouped warpgroup GEMM:
    the MoE wire path's (cap_s 20480, block_m 128; AG K 2048 N 352 a rank
    on codes, partials K 352 N 2048) do; 64-row blocks, f32, codes rows
    not a multiple of 16 bytes and misaligned bases keep the tile loops."""
    assert _form(**case) is want


def test_grouped_forms_are_counted_and_cleared():
    """The two wrappers tally their launches by form, and
    ``reset_launch_counts`` clears both tallies."""
    from triton_distributed_tpu_torch.kernels import reset_launch_counts

    fns = (mtf._ag_group_gemm_w_cuda, mtf._moe_reduce_rs_partials_cuda)
    for i, fn in enumerate(fns):
        agm.count_form(fn, 2 - i)
        assert fn.by_variant.get(agm.MESH_GEMM_FORMS[2 - i], 0) >= 1
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
