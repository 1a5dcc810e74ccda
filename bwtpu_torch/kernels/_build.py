"""Build a CUDA source of bwtpu_torch/csrc with nvcc and load it by ctypes.

Each kernel source has a plain C entry point (pointers, ints and the
stream; it returns cudaGetLastError()), so the build never includes
PyTorch's headers: `nvcc -shared` of one file takes seconds. The shared
library is cached in bwtpu_torch/_build/ under a hash of the source, the
shared csrc/*.cuh headers and the flags, and built at first use — never
at import. `build_all` starts one nvcc per source at once.
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import hashlib
import os
import re
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

SOURCES = ("locate", "verify", "search1", "search2", "searchk", "gather", "sw",
           "compact", "prep")  # csrc/*.cu

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


def _paths(name: str) -> tuple[str, str]:
    """(source, cached library path) of csrc/<name>.cu (name may be a path
    relative to csrc, as an A/B script's source from elsewhere is); the
    cache key hashes the source, every csrc/*.cuh header and the flags."""
    src = os.path.join(CSRC, name + ".cu")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    stem = name.replace("/", "_")
    return src, os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")


def _load(name: str, so: str, info: dict) -> ctypes.CDLL:
    lib = ctypes.CDLL(so)
    lib.bwtpu_cuda_error_name.restype = ctypes.c_char_p
    lib.bwtpu_cuda_error_name.argtypes = [ctypes.c_int]
    build_info[name] = info
    _libs[name] = lib
    return lib


def build_all(names) -> None:
    """Build and load the named sources, one nvcc process for each
    source that is not cached, all started together. Raises on a failed
    build; there is no fallback."""
    with _lock:
        todo = []
        for name in names:
            if name in _libs:
                continue
            src, so = _paths(name)
            if os.path.exists(so):
                _load(name, so, {"seconds": 0.0, "ptxas": ""})
                continue
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.tmp{os.getpid()}"
            proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)
            todo.append((name, src, so, tmp, proc, time.perf_counter()))
        failed = []
        for name, src, so, tmp, proc, t0 in todo:
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {src}:\n{err}")
                continue
            os.replace(tmp, so)
            _load(name, so, {"seconds": time.perf_counter() - t0, "ptxas": err})
        if failed:
            raise RuntimeError("\n".join(failed))


def sass(name: str):
    """`cuobjdump -sass` of csrc/<name>.cu's built library (building it if
    needed), or None where the toolkit has no cuobjdump."""
    build_all([name])
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    exe = shutil.which("cuobjdump") or os.path.join(home, "bin", "cuobjdump")
    if not os.path.exists(exe):
        return None
    return subprocess.run([exe, "-sass", _paths(name)[1]], capture_output=True, text=True,
                          timeout=300, check=True).stdout


def sass_loops(listing: str) -> dict:
    """{kernel function: [(instructions, {opcode: count}), ...]} of a
    `cuobjdump -sass` listing: one entry per backward branch (a loop),
    the instructions from its target to the branch, largest first."""
    out, fn, code = {}, None, []

    def close():
        if fn is None:
            return
        at = {addr: i for i, (addr, _) in enumerate(code)}
        found = []
        for i, (addr, ins) in enumerate(code):
            m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", ins)
            if m and int(m.group(1), 16) <= addr and int(m.group(1), 16) in at:
                body = [c.split()[0] for _, c in code[at[int(m.group(1), 16)]:i + 1]]
                ops = {}
                for op in (b.split(".")[0] for b in body):
                    ops[op] = ops.get(op, 0) + 1
                found.append((len(body), ops))
        out[fn] = sorted(found, key=lambda f: -f[0])

    for line in listing.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            close()
            fn, code = m.group(1), []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and fn is not None:
            ins = re.sub(r"^@!?U?P\w+\s+", "", m.group(2))
            code.append((int(m.group(1), 16), ins))
    close()
    return out


def library(name: str) -> ctypes.CDLL:
    """Load csrc/<name>.cu as a shared library, building it if needed.
    Raises on a failed build; there is no fallback."""
    build_all([name])
    return _libs[name]


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(
            f"{what}: CUDA error {rc} ({lib.bwtpu_cuda_error_name(rc).decode()})")


def call(fn, t: torch.Tensor, *args) -> int:
    """fn(*args, stream) with tensor t's device made current, the stream
    being that device's current stream; returns fn's CUDA error code.
    Every kernel launch of the port goes through here: a device's default
    stream has the handle 0, and CUDA sends a launch on handle 0 to the
    null stream of whichever device is current, so a launch made without
    the guard for tensors on cuda:1 while cuda:0 is current would run on
    card 0 with card 1's pointers."""
    with torch.cuda.device(t.device):
        return fn(*args, torch.cuda.current_stream(t.device).cuda_stream)


def launch(lib: ctypes.CDLL, fn, what: str, t: torch.Tensor, *args) -> None:
    """`call`, then raise if the entry point returned a CUDA error."""
    check(lib, call(fn, t, *args), what)


def on_cuda(kernel: str, t: torch.Tensor) -> bool:
    """False for a CPU tensor (the wrapper runs its plain version), True
    for a CUDA tensor (it launches its kernel); any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{kernel}: no kernel for device {t.device}")
    return True


def check_tensor(kernel: str, name: str, t: torch.Tensor, dtype, ndim: int,
                 device) -> None:
    """Raise unless t is a contiguous ndim-D dtype tensor on device."""
    if t.dtype != dtype or t.dim() != ndim or t.device != device or not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be a contiguous {ndim}-D "
                         f"{dtype} tensor on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


_count_lock = threading.Lock()
_capture = threading.local()  # .tally: launches recorded into a CUDA graph


def count_launch(wrapper) -> None:
    """Add one to a kernel wrapper's `launches` counter (the finish thread
    of the CLI launches too, hence the lock). Inside `recording()` the
    launch is recorded into a CUDA graph, not run, and is tallied there
    instead. A replay runs it without calling the wrapper, so no counter
    sees a replay: `launches_in_trace` counts what one ran."""
    tally = getattr(_capture, "tally", None)
    if tally is not None:
        tally[wrapper] = tally.get(wrapper, 0) + 1
        return
    with _count_lock:
        wrapper.launches += 1


@contextlib.contextmanager
def recording():
    """While this thread captures a CUDA graph: yields {kernel name:
    launches} of the kernels the graph holds, which the counters do not
    see (filled when the block ends)."""
    _capture.tally = tally = {}
    names = {}
    try:
        yield names
    finally:
        _capture.tally = None
        name_of = {fn: n for n, fn in _wrappers().items()}
        names.update((name_of[fn], n) for fn, n in tally.items())


# each wrapper's __global__ function(s) that run once for each of its
# launches (search_multistep's exit kernel runs once a call; its search
# kernel only when there are lanes)
DEVICE_FUNCS = {
    "sw_band": ("sw_band_kernel",), "locate_walk": ("locate_walk_kernel",),
    "verify_nm": ("verify_nm_kernel", "verify_nm_wide_kernel"),
    "search_chain1": ("search_chain1_kernel",),
    "search_chain2": ("chain2_packed_kernel", "chain2_planes_kernel"),
    "search_multistep": ("exit_kernel",), "verify_locv": ("verify_locv_kernel",),
    "row_gather_sum": ("row_gather_sum_kernel",),
    "compact_slots": ("compact_slots_kernel", "compact_slots_tiles_kernel"),
    "compact_mask": ("compact_mask_kernel", "compact_mask_tiles_kernel"),
    "revcomp_both": ("revcomp_both_kernel",),
}
_FUNC = re.compile(r"(?<!\w)(" + "|".join(f for fs in DEVICE_FUNCS.values() for f in fs)
                   + r")(?!\w)")


def launches_in_trace(names) -> dict:
    """{kernel name: launches} from the names of a trace's device kernel
    events (torch.profiler): the launches a CUDA graph replay runs, which
    no wrapper counts, measured."""
    wrapper_of = {f: n for n, fs in DEVICE_FUNCS.items() for f in fs}
    out = dict.fromkeys(DEVICE_FUNCS, 0)
    for name in names:
        m = _FUNC.search(name)
        if m:
            out[wrapper_of[m.group(1)]] += 1
    return out


def _wrappers() -> dict:
    """{kernel name: wrapper} of every kernel (imported at call time: the
    wrapper modules import this one)."""
    from bwtpu_torch.kernels.compact import compact, compact_counts
    from bwtpu_torch.kernels.gather import row_gather_sum
    from bwtpu_torch.kernels.locate import locate_walk
    from bwtpu_torch.kernels.prep import revcomp_both
    from bwtpu_torch.kernels.search2 import search_chain1, search_chain2
    from bwtpu_torch.kernels.searchk import search_multistep
    from bwtpu_torch.kernels.verify2 import verify_locv, verify_nm
    from bwtpu_torch.sw import sw_score_batch

    return {"sw_band": sw_score_batch, "locate_walk": locate_walk, "verify_nm": verify_nm,
            "search_chain1": search_chain1, "search_chain2": search_chain2,
            "search_multistep": search_multistep, "verify_locv": verify_locv,
            "row_gather_sum": row_gather_sum, "compact_slots": compact_counts,
            "compact_mask": compact, "revcomp_both": revcomp_both}


def reset_launches() -> None:
    """Set every kernel wrapper's `launches` counter to 0."""
    with _count_lock:
        for fn in _wrappers().values():
            fn.launches = 0


def launch_counts() -> dict:
    """{kernel name: launches since the last reset_launches}."""
    with _count_lock:
        return {name: fn.launches for name, fn in _wrappers().items()}
