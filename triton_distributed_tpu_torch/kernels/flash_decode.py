"""KV-cache quantization shared by the serving step.

Port of ``quantize_kv`` from ``triton_distributed_tpu/kernels/
flash_decode.py``; the decode kernels of that module come with the
decode-path slice.
"""

from __future__ import annotations

import torch


def quantize_kv(x):
    """Per-row int8 quantization of a (..., S, D) cache tensor: each
    length-D row gets one f32 scale (max-abs / 127). Returns (int8
    values, f32 scales of shape ``x.shape[:-1]``). Rounds half to even,
    as the JAX version does."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    s = torch.where(amax > 0.0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / s[..., None]), -127.0, 127.0)
    return q.to(torch.int8), s
