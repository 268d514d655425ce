"""Build and load the port's CUDA kernels (a plain C interface, ctypes).

Every ``triton_distributed_tpu_torch/csrc/*.cu`` is compiled by its own
``nvcc`` process, all started together, then linked into one shared
library::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas=-v -c <src>.cu  (one per source, in parallel)
    nvcc -shared -o libtdt_kernels_<hash>.so *.o

The library lands in :func:`config.build_dir` under a name keyed by a
hash of the sources and flags, so an edited source forces a rebuild and
an unchanged one loads at once; beside it, ``libtdt_kernels_<hash>.log``
keeps what each compile printed (ptxas's registers, spills and warnings
for every kernel; :func:`build_log`). Nothing is built at import: the
first launch on a CUDA tensor calls :func:`lib`.

Every C entry point takes its pointers and the stream as ``void*`` and
returns ``cudaGetLastError()`` after its launch; :func:`check` turns a
non-zero code into an exception naming the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

from triton_distributed_tpu_torch.config import build_dir, csrc_dir

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_LOCK = threading.Lock()
_LIB = None


def _nvcc() -> str:
    for cand in (
        os.environ.get("NVCC"),
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set NVCC or CUDA_HOME)")


def sources() -> list:
    return sorted(csrc_dir().glob("*.cu"))


def _digest(srcs) -> str:
    h = hashlib.sha256()
    for f in [*srcs, *sorted(csrc_dir().glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (in parallel) and link the library unless a
    library for these exact sources exists. Returns its path; raises
    with nvcc's output when a compile or the link fails."""
    srcs = sources()
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"libtdt_kernels_{_digest(srcs)}.so"
    if so.exists():
        return so
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in srcs]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(srcs, objs)]
        outs = [p.communicate()[0] for p in procs]
        failed = [f"== {src.name}\n{out}"
                  for src, p, out in zip(srcs, procs, outs) if p.returncode]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        (Path(tmp) / so.with_suffix(".log").name).write_text(
            "".join(f"== {src.name}\n{out}" for src, out in zip(srcs, outs)))
        tmp_so = Path(tmp) / so.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_so), *map(str, objs)],
            capture_output=True, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(Path(tmp) / so.with_suffix(".log").name,
                   so.with_suffix(".log"))
        os.replace(tmp_so, so)
    return so


def build_log() -> str:
    """What the compiles of the current library printed ("" where it was
    built without a log)."""
    log = build().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def lib() -> ctypes.CDLL:
    """The loaded kernel library, building it on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            dll = ctypes.CDLL(str(build()))
            dll.tdt_error_string.restype = ctypes.c_char_p
            dll.tdt_error_string.argtypes = [ctypes.c_int]
            _LIB = dll
        return _LIB


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong

#: C signatures: "p" pointer or stream, "i" int, "L" long long, "f" float
_CODES = {"p": _P, "i": _I, "L": _L, "f": _F}


def function(name: str, sig: str):
    """The C entry ``name`` with ``argtypes`` set from ``sig`` (one
    letter per argument: p = pointer/stream, i = int, L = long long,
    f = float)."""
    fn = getattr(lib(), name)
    if getattr(fn, "_tdt_sig", None) != sig:
        fn.argtypes = [_CODES[c] for c in sig]
        fn.restype = ctypes.c_int
        fn._tdt_sig = sig
    return fn


def check(rc: int, name: str) -> None:
    """Raise when a C entry returned a CUDA error code."""
    if rc != 0:
        msg = lib().tdt_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def ptr_array(tensors):
    """The tensors' data pointers as a C array of 64-bit words in host
    memory (a ``p`` argument): what an entry reads on the host, such as the
    bases of the tensor maps it encodes."""
    ptrs = [t.data_ptr() for t in tensors]
    return (ctypes.c_uint64 * len(ptrs))(*ptrs)


def stream(device) -> ctypes.c_void_p:
    """``device``'s current CUDA stream as a pointer argument: the raw
    handle ``torch.cuda.current_stream(device).cuda_stream`` holds, read
    without building a Stream object (a wrapper's host time counts)."""
    import torch

    index = device.index if isinstance(device, torch.device) else None
    if index is None:
        index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(index))
