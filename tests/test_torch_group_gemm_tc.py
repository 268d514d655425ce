"""CPU checks of the W8A16 tensor-core kernel's and the narrow f32 router
kernel's host-side pieces (``csrc/group_gemm.cu``,
``csrc/ggemm_tiles.cuh``): the int8 -> bf16 widening the kernel does with
byte permutes and one f32 subtraction, emulated in integer torch ops; the
lanes' fragment layout of the swapped product (weights as mma's A
operand), emulated in numpy; the form codes the C entry reports; and the
router's CPU product. The kernels themselves run only on a card
(``tests/test_torch_cuda.py``)."""

from __future__ import annotations

import re

import numpy as np
import torch

from triton_distributed_tpu_torch.config import csrc_dir
from triton_distributed_tpu_torch.kernels import group_gemm as gg

MAGIC = 0x4B000000          # the f32 2^23
OFFSET = 8388736.0          # 2^23 + 128


def _byte_perm(x, y, sel):
    """CUDA's ``__byte_perm(x, y, sel)`` on int64 tensors of 32-bit
    words: byte i of the result is byte ``(sel >> 4i) & 7`` of the eight
    bytes of x (0-3) and y (4-7)."""
    out = torch.zeros_like(x)
    for i in range(4):
        j = (sel >> (4 * i)) & 7
        src = x if j < 4 else y
        out |= ((src >> (8 * (j % 4))) & 0xFF) << (8 * i)
    return out


def _as_f32(words):
    return words.to(torch.int64).to(torch.int32).view(torch.float32)


def _as_u32(f):
    return f.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _q8_f32(u, j):
    """``q8_f32<j>``: code j of the biased word u as f32."""
    return _as_f32(_byte_perm(u, torch.full_like(u, MAGIC), 0x7540 | j)) \
        - OFFSET


def _q8_pack(lo, hi):
    """``q8_pack``: the upper halves of two f32 as one bf16x2 word."""
    return _byte_perm(_as_u32(lo), _as_u32(hi), 0x7632)


def _bf16_bits(half):
    """16-bit words (int64) as int16 bit patterns."""
    return ((half + 2 ** 15) % 2 ** 16 - 2 ** 15).to(torch.int16)


def test_int8_widening_is_bf16_of_every_code():
    """Every code -127..127, four to a word: the byte placed into the
    f32 2^23 (after the 0x80 bias) minus 2^23 + 128 is the code exactly,
    and the packed upper halves are ``q.to(torch.bfloat16)`` bit for bit
    (the lower 16 bits of such an f32 are zero)."""
    q = torch.cat([torch.arange(-127, 128), torch.zeros(1, dtype=torch.int64)])
    codes = q.reshape(-1, 4)
    word = sum(((codes[:, i] & 0xFF) << (8 * i)) for i in range(4))
    u = word ^ 0x80808080
    vals = torch.stack([_q8_f32(u, j) for j in range(4)], dim=1)
    assert torch.equal(vals, codes.to(torch.float32))
    assert torch.all((_as_u32(vals) & 0xFFFF) == 0)
    for j in (0, 2):
        packed = _q8_pack(vals[:, j], vals[:, j + 1])
        want = codes[:, j:j + 2].to(torch.int8).to(torch.bfloat16)
        assert torch.equal(_bf16_bits(packed & 0xFFFF), want[:, 0].view(torch.int16))
        assert torch.equal(_bf16_bits(packed >> 16), want[:, 1].view(torch.int16))


def test_swapped_fragments_cover_the_tile():
    """The lanes' fragments of one 64-deep K stage, as the kernel builds
    them: a warp's A fragments from 32-bit words of the weight rows kk +
    2t, +1, +8, +9 at byte 32·warp + 4g (tile i row g is column 4g + 2i,
    row g + 8 column 4g + 2i + 1), x's B fragments by ldmatrix, the
    m16n8k16 products, and the epilogue's (row, column) of each
    accumulator. Emulated lane by lane (PTX's fragment layouts), the
    stage's product is x @ w exactly."""
    rng = np.random.default_rng(0)
    mt, bk, bn = 16, 64, 128
    w = rng.integers(-127, 128, (bk, bn))
    x = rng.integers(-8, 9, (mt, bk)).astype(np.float64)
    got = np.zeros((mt, bn))
    for warp in range(4):
        acc = np.zeros((2, mt // 8, 32, 4))
        for kk in range(0, bk, 16):
            a_tile = np.zeros((2, 16, 16))
            b_tile = np.zeros((mt // 8, 16, 8))
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                rows = [kk + 2 * t + (r & 1) + 8 * (r >> 1) for r in range(4)]
                u = [w[row, 32 * warp + 4 * g: 32 * warp + 4 * g + 4]
                     for row in rows]
                for i in range(2):
                    # q8_frag<i>: registers (lo, hi) of a[0..3]
                    regs = [(u[0][2 * i], u[1][2 * i]),
                            (u[0][2 * i + 1], u[1][2 * i + 1]),
                            (u[2][2 * i], u[3][2 * i]),
                            (u[2][2 * i + 1], u[3][2 * i + 1])]
                    for h in range(2):
                        a_tile[i, g, 2 * t + h] = regs[0][h]
                        a_tile[i, g + 8, 2 * t + h] = regs[1][h]
                        a_tile[i, g, 2 * t + 8 + h] = regs[2][h]
                        a_tile[i, g + 8, 2 * t + 8 + h] = regs[3][h]
                for j in range(mt // 8):
                    # ldmatrix: b0 = x[8j + g][kk + 2t ..], b1 = ... + 8
                    for h in range(2):
                        b_tile[j, 2 * t + h, g] = x[8 * j + g, kk + 2 * t + h]
                        b_tile[j, 2 * t + 8 + h, g] = \
                            x[8 * j + g, kk + 2 * t + 8 + h]
            for i in range(2):
                for j in range(mt // 8):
                    c = a_tile[i] @ b_tile[j]                   # (16, 8)
                    for lane in range(32):
                        g, t = lane >> 2, lane & 3
                        acc[i, j, lane] += [c[g, 2 * t], c[g, 2 * t + 1],
                                            c[g + 8, 2 * t],
                                            c[g + 8, 2 * t + 1]]
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            nb = warp * 32 + 4 * g
            for j in range(mt // 8):
                for h in range(2):
                    m = 8 * j + 2 * t + h
                    got[m, nb: nb + 4] = [acc[0, j, lane, h],
                                          acc[0, j, lane, 2 + h],
                                          acc[1, j, lane, h],
                                          acc[1, j, lane, 2 + h]]
    np.testing.assert_array_equal(got, x @ w)


def test_w8a16_variant_codes_match_the_kernel():
    """``W8A16_VARIANTS`` names the codes of ``csrc/group_gemm.cu``'s
    ``W8a16Variant`` (the kernel a ``tdt_ggemm_w8a16`` call reports it
    launched), and ``reset_launch_counts`` clears the wrapper's
    ``by_variant`` with its other counts."""
    from triton_distributed_tpu_torch.kernels import reset_launch_counts

    src = (csrc_dir() / "group_gemm.cu").read_text()
    body = re.search(r"enum W8a16Variant \{([^}]*)\}", src).group(1)
    codes = {int(c): name.lower()
             for name, c in re.findall(r"W8A16_(\w+) = (\d+)", body)}
    assert codes == gg.W8A16_VARIANTS
    gg._w8a16_cuda.by_variant["tc"] = 3
    reset_launch_counts()
    assert gg._w8a16_cuda.by_variant == {}


def test_router_logits_on_cpu_is_the_f32_product():
    """On CPU tensors ``router_logits`` on bf16 x (and an f32 or a bf16
    router) is ``x.float() @ router.float()`` bit for bit."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((37, 96), generator=g).to(torch.bfloat16)
    r = torch.randn((96, 20), generator=g)
    for router in (r, r.to(torch.bfloat16)):
        got = gg.router_logits(x, router)
        assert got.dtype == torch.float32
        assert torch.equal(got, x.float() @ router.float())
