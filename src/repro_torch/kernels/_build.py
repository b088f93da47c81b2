"""Build and load the port's hand-written CUDA kernels.

Every ``src/repro_torch/csrc/*.cu`` file exposes plain ``extern "C"``
entry points. At first use the sources are compiled for Hopper
(``sm_90a``), one ``nvcc`` process per source all started together,
linked into ``build/repro_torch/<hash>/libkernels.so`` at the repository
root, and loaded with :mod:`ctypes`. The directory name is a hash of the
sources and flags, so an edited source never meets a stale library.

Every entry point returns ``cudaGetLastError()`` right after its launch;
:func:`check` raises on anything but 0, so a refused launch surfaces at
the call instead of disappearing.

``-fmad=false`` keeps nvcc from contracting a multiply and an add into
one FMA (a single rounding), which would move QSGD levels across their
floor boundary; ``--use_fast_math`` is never used for the same reason.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("bucket_topk.cu", "bucket_scatter.cu", "qsgd_pack.cu",
           "qsgd_unpack.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-fmad=false", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# name -> argtypes (every entry point returns an int CUDA error code)
ENTRY_POINTS = {
    "bucket_topk_f32": (_P, _P, _P, _P, _LL, _I, _I, _P),
    "bucket_topk_ef_grouped_f32": (_P, _I, _P, _P),
    "bucket_scatter_sum_grouped_f32": (_P, _I, _P, _P),
    "qsgd_pack_grouped_f32": (_P, _I, _I, _I, _P, _P),
    "qsgd_unpack_grouped_f32": (_P, _I, _I, _P, _P),
}

_lib = None
# what the last build did: {"seconds": float, "cached": bool, "ptxas": str}
build_info: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels (if this exact source set is not built yet) and
    return the shared library's path."""
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / "libkernels.so"
    if lib_path.exists():
        build_info.update(seconds=0.0, cached=True, ptxas="")
        return lib_path
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for name in SOURCES:
        obj = out_dir / (Path(name).stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(CSRC / name),
               "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, objs, failed = [], [], []
    for name, obj, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {name}\n{out}")
        objs.append(str(obj))
        if proc.returncode != 0:
            failed.append(name)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
    tmp = out_dir / f"libkernels.{os.getpid()}.tmp.so"
    link = subprocess.run(
        [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a", *objs,
         "-o", str(tmp)], capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib_path)
    build_info.update(seconds=time.perf_counter() - t0, cached=False,
                      ptxas="\n".join(logs))
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in ENTRY_POINTS.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def offsets(sizes, start: int = 0) -> list:
    """Where each of ``sizes`` starts, laid one after the other from
    ``start``: a grouped call's offsets into its flat buffers."""
    return np.cumsum([start] + list(sizes))[:-1].tolist()


def byte_offsets(offsets_f32) -> np.ndarray:
    """Offsets in 4-byte entries -> bytes, as a descriptor array's
    pointer fields add them to a buffer's address."""
    return np.array([4 * o for o in offsets_f32], dtype=np.uint64)


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def stream(t: torch.Tensor) -> int:
    """PyTorch's current stream on the tensor's device, as a raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream


def resolve_impl(impl: str, t: torch.Tensor, name: str) -> str:
    """'ref' or 'cuda': ``impl``, with 'auto' taken from ``t``'s device
    (see ``bucket_topk/ops.py`` for the values)."""
    if impl == "auto":
        impl = "cuda" if t.is_cuda else "ref"
    if impl not in ("ref", "cuda"):
        raise ValueError(f"{name}: unknown impl {impl!r}")
    return impl


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device."""
    dev = tensors[0].get_device()
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, "
                             f"got one on {t.device}")
        if t.get_device() != dev:
            raise ValueError(f"{name}: tensors on {tensors[0].device} and "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel takes contiguous "
                             "tensors")
