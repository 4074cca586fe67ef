"""Build the CUDA kernels of `csrc/` for sm_90a and load them with ctypes.

Each `csrc/<name>.cu` is compiled by `nvcc` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds).
The libraries go into `build/torch_kernels/` at the repository root
(listed in .gitignore), named by a hash of their sources and flags, so a
changed source rebuilds and an unchanged one is loaded as it is.
`build_all()` starts one `nvcc` per source, all at once, and waits.

Nothing is built or loaded at import time: the CPU path never needs
`nvcc`.  A failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

KERNEL_SOURCES = (
    "mask_gids",
    "segment_reduce_blocked",
    "segment_reduce_scatter",
    "segment_last",
)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc")
        if os.environ.get("CUDA_HOME") else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> str:
    h = hashlib.sha1()
    for fn in (f"{name}.cu", "common.cuh"):
        with open(os.path.join(CSRC, fn), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build_all(names=KERNEL_SOURCES) -> dict[str, float]:
    """Compile every missing library, one nvcc process per source started
    together.  Returns seconds per source built (0.0 when it was cached);
    raises with nvcc's output if a build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    started = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    seconds = {name: 0.0 for name in names}
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - started
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not os.path.exists(path):
                build_all((name,))
            lib = ctypes.CDLL(path)
            for fn in _EXPORTS[name]:
                f = getattr(lib, fn)
                f.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
                f.restype = ctypes.c_int
            _libs[name] = lib
    return lib


_EXPORTS = {
    "mask_gids": ("gt_mask_gids",),
    "segment_reduce_blocked": ("gt_blocked_partials", "gt_blocked_fold"),
    "segment_reduce_scatter": ("gt_scatter_reduce",),
    "segment_last": ("gt_last_partials", "gt_last_fold", "gt_last_sorted"),
}


def launch(name: str, fn: str, args: ctypes.Structure, stream: int) -> None:
    """Call one exported entry point with a pointer to its argument struct
    and the CUDA stream; raise on a launch error."""
    err = getattr(load(name), fn)(ctypes.byref(args), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name}.{fn}: CUDA launch failed with error {err}")
