"""The plan and scratch of the one-sweep radix sort (csrc/radix.cuh).

K14 `ts_argsort`, K18 `sort_segments` and K19's large-k branch sort with
the same kernels.  The host plans each sort from its largest key alone:

* the key width: u32 when the largest key fits 32 bits, else u64;
* the passes: one up to 11 bits (the largest key's bit length); past
  that ceil(bits / 11), or up to three of at most 8 bits where they do
  (a pass costs more the wider its digit); digit widths (at most 11
  bits) differ by at most one, low digits first.  A largest key of 0
  takes one 1-bit pass, which keeps the row order.

The scratch is sized here and allocated with `torch.empty` by the
wrapper, so the kernels allocate nothing: the keys and rows between
passes, one 32-bit look-back word per (tile, digit) of every pass, and
the control words (digit counts, a done counter, a tile counter per
pass) that each sort resets on its stream.  The sort counts the kernels
it launched into the scratch struct; `sort_record` is what a wrapper
keeps of its last sort.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

TILE_ROWS = 4096  # kTileRows: 512 threads x 8 keys
MAX_DIGIT_BITS = 11  # kMaxDigitBits
MAX_PASSES = 6  # kMaxPasses: 64 bits at 11 a pass


@dataclass(frozen=True)
class RadixPlan:
    key_bytes: int
    shifts: tuple
    widths: tuple

    @property
    def n_passes(self) -> int:
        return len(self.widths)


@functools.lru_cache(maxsize=256)
def radix_plan(max_key: int) -> RadixPlan:
    """The plan of a sort whose keys lie in [0, max_key]."""
    if not 0 <= max_key < 1 << 64:
        raise ValueError(f"radix keys are unsigned 64-bit, got a largest key of {max_key}")
    bits = max(max_key.bit_length(), 1)
    n_passes = -(-bits // MAX_DIGIT_BITS)
    if n_passes > 1:
        # a pass costs more the more digits it has (its look-back words
        # and its per-digit work), so past one pass take up to three of
        # at most 8 bits where they do
        n_passes = max(n_passes, min(-(-bits // 8), 3))
    widths = tuple(bits // n_passes + (p < bits % n_passes) for p in range(n_passes))
    shifts = tuple(sum(widths[:p]) for p in range(n_passes))
    return RadixPlan(4 if bits <= 32 else 8, shifts, widths)


class _RadixPlan(ctypes.Structure):
    # mirrored field for field by RadixPlan in csrc/radix.cuh
    _fields_ = [
        ("n_passes", ctypes.c_int32), ("key_bytes", ctypes.c_int32),
        ("shift", ctypes.c_int32 * MAX_PASSES), ("bits", ctypes.c_int32 * MAX_PASSES),
    ]


class _RadixScratch(ctypes.Structure):
    # mirrored field for field by RadixScratch in csrc/radix.cuh
    _fields_ = [
        ("keys", ctypes.c_void_p * 2), ("idx", ctypes.c_void_p * 2),
        ("status", ctypes.c_void_p), ("control", ctypes.c_void_p), ("kernels", ctypes.c_int32),
    ]


@functools.lru_cache(maxsize=256)
def _plan_struct(plan: RadixPlan) -> _RadixPlan:
    pad = (0,) * (MAX_PASSES - plan.n_passes)
    return _RadixPlan(plan.n_passes, plan.key_bytes,
                      (ctypes.c_int32 * MAX_PASSES)(*plan.shifts, *pad),
                      (ctypes.c_int32 * MAX_PASSES)(*plan.widths, *pad))


def plan_struct(plan: RadixPlan) -> _RadixPlan:
    """The plan as its C struct (built once per plan; the launch argument
    structs copy it)."""
    return _plan_struct(plan)


def scratch_sizes(n: int, plan: RadixPlan) -> dict:
    """Elements of each scratch tensor of a sort of n keys: keys and rows
    between passes (one buffer for two passes, two from three on), the
    int32 look-back words and the int32 control words."""
    bins = sum(1 << w for w in plan.widths)
    n_tiles = -(-n // TILE_ROWS)
    return {
        "buffers": min(plan.n_passes - 1, 2),
        "status": n_tiles * bins,
        "control": bins + 1 + plan.n_passes,
    }


def carve(nbytes, dev):
    """One allocation cut into pieces of the given byte sizes, each at a
    256-byte boundary: (the tensor to keep alive, the pieces' addresses)."""
    import torch

    offs, end = [], 0
    for b in nbytes:
        offs.append(end)
        end += -(-int(b) // 256) * 256
    buf = torch.empty(max(end, 1), dtype=torch.uint8, device=dev)
    p = buf.data_ptr()
    return buf, [p + o for o in offs]


def radix_scratch(n: int, plan: RadixPlan, dev):
    """(the tensor to keep alive until the launch is queued, _RadixScratch):
    the keys and rows between passes, the look-back and control words, in
    one allocation."""
    size = scratch_sizes(n, plan)
    nbuf = size["buffers"]
    keep, (*bufs, status, control) = carve(
        [n * plan.key_bytes] * nbuf + [n * 4] * nbuf + [size["status"] * 4, size["control"] * 4],
        dev)
    pad = [None] * (2 - nbuf)
    s = _RadixScratch((ctypes.c_void_p * 2)(*bufs[:nbuf], *pad),
                      (ctypes.c_void_p * 2)(*bufs[nbuf:], *pad), status, control, 0)
    return keep, s


def sort_record(plan: RadixPlan, kernels: int) -> dict:
    """What one sort ran: its passes, its key width and the kernels
    launched (counted where they were launched)."""
    return {"passes": plan.n_passes, "key_bytes": plan.key_bytes, "kernels": int(kernels)}
