"""Device resolution, dtype names, the kernel build directory, the
division the quantizers use (:func:`div_scalar`), and JAX's fused-engine
budget (:func:`fused_vmem_budget`).

The port's entry points run on the card unless the caller asks for the
CPU: :func:`resolve_device` turns ``None`` into the current CUDA device
(``cuda:0`` unless the caller set another) and raises
where no CUDA device is present, so nothing quietly falls back to the
CPU. The CPU path exists for the parity tests, which pass
``device="cpu"`` explicitly.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path

import torch

#: dtype names (as numpy/JAX spell them) → torch dtypes
DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "int8": torch.int8,
    "int32": torch.int32,
    "int64": torch.int64,
}


def to_torch_dtype(dt) -> torch.dtype:
    """A torch dtype from a torch dtype, a name, or anything whose
    ``str``/``name`` spells one (numpy and JAX dtypes)."""
    if isinstance(dt, torch.dtype):
        return dt
    name = getattr(dt, "name", None) or getattr(dt, "__name__", None)
    name = name or str(dt)
    name = name.replace("torch.", "")
    if name not in DTYPES:
        raise ValueError(f"unknown dtype {dt!r}")
    return DTYPES[name]


def resolve_device(device=None) -> torch.device:
    """``None`` → the current CUDA device, with its index. A CUDA device on
    a host without one raises; ``"cpu"`` must be asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    return indexed(dev)


def indexed(dev: torch.device) -> torch.device:
    """``dev`` with its index: a CUDA device given without one names the
    current device, as the tensors made on it report it (``cuda:0``, not
    ``cuda``), so that devices compare equal."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def div_scalar(x, c: float):
    """``x / c`` as an IEEE division on every device. PyTorch's CUDA
    kernels turn a division by a Python scalar into a multiplication by
    its reciprocal, which rounds apart from the CPU's (and JAX's)
    division in the last bit for many values; a quantizer's scales must
    not, or the card's codes drift from the reference's."""
    return x / x.new_full((), c)


#: JAX's working-set budget of the fused single-kernel engines, 96 MiB
#: (``triton_distributed_tpu/config.py:69``). The reduce-scatter keeps
#: JAX's engine choice by it (``kernels/reduce_scatter.py``): on the card
#: it decides which rows share a wire scale, not memory
FUSED_VMEM_BUDGET = 96 * 1024 * 1024


def fused_vmem_budget() -> int:
    """:data:`FUSED_VMEM_BUDGET`, or ``TDTPU_FUSED_VMEM_BUDGET`` (bytes)
    where the environment sets it, as JAX reads it."""
    return int(float(os.environ.get("TDTPU_FUSED_VMEM_BUDGET",
                                    str(FUSED_VMEM_BUDGET))))


_WARNED: set = set()


def warn_once(key, msg: str) -> None:
    """Log ``msg`` as a warning the first time ``key`` is seen in this
    process (the JAX package's ``_warn_once``): a demotion that changes
    what a call runs says so once, not on every call."""
    if key not in _WARNED:
        _WARNED.add(key)
        logging.getLogger("triton_distributed_tpu_torch").warning(msg)


def build_dir() -> Path:
    """Where the CUDA sources are compiled to (listed in .gitignore)."""
    return Path(__file__).resolve().parent / "_build"


def csrc_dir() -> Path:
    return Path(__file__).resolve().parent / "csrc"
