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
    "quantize_limbs",
    "limb_segment_sums",
    "topk_select",
    "pack_result",
    "strip_counter_resets",
    "range_windows",
    "range_finalize",
    "series_fold",
    "having_mask",
    "ts_argsort",
    "gather_planes",
    "delta_patch",
    "hash_group_slots",
    "segment_sort",
    "topk_distances",
    "segment_hll",
    "segment_udd",
    "fold_states",
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
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fn in (f"{name}.cu", *headers):
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
    "quantize_limbs": ("gt_quantize_limbs",),
    "limb_segment_sums": ("gt_limb_partials", "gt_limb_fold", "gt_limb_runs"),
    "topk_select": ("gt_topk_select", "gt_topk_round", "gt_topk_compact"),
    "pack_result": ("gt_pack_result",),
    "strip_counter_resets": ("gt_strip_counter_resets",),
    "range_windows": ("gt_range_layout", "gt_range_windows"),
    "range_finalize": ("gt_range_finalize",),
    "series_fold": ("gt_series_fold",),
    "having_mask": ("gt_having_mask",),
    "ts_argsort": ("gt_argsort_range", "gt_argsort_passes"),
    "gather_planes": ("gt_gather_planes", "gt_remap_codes"),
    "delta_patch": ("gt_delta_patch",),
    "hash_group_slots": ("gt_hash_slots",),
    "segment_sort": ("gt_segment_sort",),
    "topk_distances": ("gt_topk_distances",),
    "segment_hll": ("gt_segment_hll",),
    "segment_udd": ("gt_segment_udd",),
    "fold_states": ("gt_fold_states", "gt_fold_invert"),
}


def launch(name: str, fn: str, args: ctypes.Structure, stream: int) -> None:
    """Call one exported entry point with a pointer to its argument struct
    and the CUDA stream; raise on a launch error."""
    err = getattr(load(name), fn)(ctypes.byref(args), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name}.{fn}: CUDA launch failed with error {err}")


class TableArena:
    """Where a capture's descriptor tables live.

    `upload_table` stages a table in a fresh pinned buffer and copies it
    on the stream; inside a CUDA graph capture that copy would become a
    memcpy node whose host source the caching host allocator hands to
    later work, so a replay would copy whatever lies there then.  Inside
    `with arena:` a table instead lands at the next aligned offset of a
    pinned host buffer and is returned as a view of one device buffer,
    both owned by the arena and allocated before the capture; `commit()`
    copies the whole buffer once, after the capture and before the first
    replay.  The tables hold device pointers, which stay valid as long as
    the graph that reads them holds their tensors."""

    _ALIGN = 16

    def __init__(self, nbytes: int, dev):
        import torch

        self.host = torch.empty(int(nbytes), dtype=torch.uint8).pin_memory()
        self.device = torch.empty(int(nbytes), dtype=torch.uint8, device=dev)
        self.used = 0
        self._prev = None

    def put(self, raw):
        import torch

        if isinstance(raw, list):
            data = torch.tensor(raw, dtype=torch.int64).view(torch.uint8)
            dtype = torch.int64
        else:
            data = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
            dtype = torch.uint8
        off = -(-self.used // self._ALIGN) * self._ALIGN
        end = off + int(data.numel())
        if end > self.host.numel():
            raise RuntimeError(
                f"table arena of {self.host.numel()} bytes is full ({end} needed)")
        self.host[off:end] = data
        self.used = end
        return self.device[off:end].view(dtype)

    def commit(self) -> None:
        """The one host -> device copy of every table (synchronous)."""
        self.device.copy_(self.host)

    def __enter__(self):
        self._prev = getattr(_arena, "current", None)
        _arena.current = self
        return self

    def __exit__(self, *exc):
        _arena.current = self._prev
        return False


_arena = threading.local()


def upload_table(raw, dev):
    """A small descriptor table (a list of int64 values, or the bytes of a
    ctypes array) on `dev` without a host sync: staged in pinned memory
    and copied on the current stream.  PyTorch's caching host allocator
    keeps the staging buffer until that copy has run.  Inside a
    `TableArena` the table lands in the arena instead; a capture without
    one raises."""
    import torch

    arena = getattr(_arena, "current", None)
    if arena is not None:
        return arena.put(raw)
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("upload_table inside a CUDA graph capture needs a TableArena")
    if isinstance(raw, list):
        host = torch.tensor(raw, dtype=torch.int64)
    else:
        host = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    return host.pin_memory().to(dev, non_blocking=True)
