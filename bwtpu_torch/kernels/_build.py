"""Build a CUDA source of bwtpu_torch/csrc with nvcc and load it by ctypes.

Each kernel source has a plain C entry point (pointers, ints and the
stream; it returns cudaGetLastError()), so the build never includes
PyTorch's headers: `nvcc -shared` of one file takes seconds. The shared
library is cached in bwtpu_torch/_build/ under a hash of the source and
the flags, and built at first use — never at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# per source: {"seconds": build time (0.0 when cached), "ptxas": nvcc's
# register / spill report}
build_info: dict[str, dict] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels of bwtpu_torch need the CUDA toolkit")


def library(name: str) -> ctypes.CDLL:
    """Load csrc/<name>.cu as a shared library, building it if needed.
    Raises on a failed build; there is no fallback."""
    with _lock:
        if name in _libs:
            return _libs[name]
        src = os.path.join(CSRC, name + ".cu")
        with open(src, "rb") as f:
            text = f.read()
        tag = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        so = os.path.join(BUILD_DIR, f"lib{name}_{tag}.so")
        info = {"seconds": 0.0, "ptxas": ""}
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.tmp{os.getpid()}"
            t0 = time.perf_counter()
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
            os.replace(tmp, so)
            info = {"seconds": time.perf_counter() - t0, "ptxas": proc.stderr}
        lib = ctypes.CDLL(so)
        lib.bwtpu_cuda_error_name.restype = ctypes.c_char_p
        lib.bwtpu_cuda_error_name.argtypes = [ctypes.c_int]
        build_info[name] = info
        _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(
            f"{what}: CUDA error {rc} ({lib.bwtpu_cuda_error_name(rc).decode()})")


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of tensor t's device, as a handle."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_tensor(kernel: str, name: str, t: torch.Tensor, dtype, ndim: int,
                 device) -> None:
    """Raise unless t is a contiguous ndim-D dtype tensor on device."""
    if t.dtype != dtype or t.dim() != ndim or t.device != device or not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be a contiguous {ndim}-D "
                         f"{dtype} tensor on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


_count_lock = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to a kernel wrapper's `launches` counter (the finish thread
    of the CLI launches too, hence the lock)."""
    with _count_lock:
        wrapper.launches += 1
