"""Physical-strategy passes of the tile path: named and individually
switchable.

Counterpart of `greptimedb_tpu/query/passes.py`, holding only the passes
the port implements and whose decision points consult `enabled()` (14 of
the reference's 19), in the reference's run order.  A pass the reference
has and the port does not (the pipelined build, the streamed readback,
the streamed spill, ...) does not exist here, so `enabled()` reports it
off: the port behaves as the reference does with that pass in
`query.disabled_passes` (for `pipelined_build`: no encode/upload overlap
and no shape-only compile ahead of the uploads).

`note()` records a decision (a pass taken or declined, and why) into
the trace of the current context, when a caller opened one with
`use_trace`; the reference renders these in EXPLAIN ANALYZE, which is
not ported.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass, field

# name -> what the pass does, in run order
PASSES = {
    "cost_route": "route sub-threshold scans to the local CPU path (device round-trip "
                  "dwarfs a small local aggregation)",
    "host_fast_path": "serve highly selective pk-equality aggregates from (pk,ts)-sorted "
                      "host planes via binary search — no device dispatch",
    "cold_host_serve": "serve a COLD grouped aggregate straight from the host consolidation "
                       "(bounded numpy pass — bincount folds, run-boundary last_value, "
                       "unique-compacted hash-scale group spaces) instead of paying plane "
                       "uploads; with tile.fused_build the fused family build then warms the "
                       "device planes in the background, otherwise the next query builds them",
    "fused_build": "consolidate the family's plane-requirement manifests into ONE cold "
                   "build pass: decode each SST file once, host-encode each column once, "
                   "batch uploads through the pipelined producer/consumer, and coalesce "
                   "concurrent cold builds onto one in-flight future",
    "tql_tile": "evaluate PromQL range functions (rate/increase/delta, *_over_time, the "
                "by-label sum/avg/min/max/count fold) as one program (K9-K12) over the "
                "resident super-tile planes, with a compacted [series_out, steps] readback",
    "agg_strategy": "pick the device group-by strategy per query from table stats: dense "
                    "mixed-radix states exploiting the (pk, ts) sort, or a hash table "
                    "sized to the distinct-key estimate when the padded group space is "
                    "sparse (the hash/sort winner flips with group cardinality)",
    "dedup_plane": "lower last-write-wins dedup of overlapping SSTs to a device-side "
                   "keep mask instead of falling back to the merge scan",
    "limb_quantize": "accumulate sum/avg through fixed-point base-256 digit planes (K5 "
                     "quantize, K6 integer segment sums) with a per-group error bound",
    "window_tile": "gather only in-window (dedup-surviving) rows into a compact device "
                   "tile so kernels scan the window, not the retention",
    "incremental_tile": "extend an existing super-tile IN PLACE when a flush appends files: "
                        "delta encode + merge of sorted runs + on-device plane patch (K16), "
                        "so post-flush cold cost is O(delta rows) instead of a full rebuild",
    "device_finalize": "run HAVING (K13), ORDER BY / LIMIT and result compaction on the card "
                       "over the finalized [G] states (K7) so the one readback is "
                       "O(rows_out)",
    "time_major": "permute value planes time-major (K14 sort, K15 gathers) so bucket-only "
                  "group-bys reduce over contiguous runs",
    "chunk_placement": "place super-tile chunks round-robin over the device slots (from the "
                       "region's co-located slot when tile.mesh_devices is on); disabled, "
                       "every chunk lives on the first slot",
    "mesh_dispatch": "run the tile program over the tile.mesh_devices slots: each slot "
                     "computes its sources' partial states on its device, the partials "
                     "gather on the first slot and fold there (K22; hash slot tables union "
                     "through K17 first), device finalize runs once after the fold",
}


def enabled(name: str, config=None) -> bool:
    """A pass the port has that `query.disabled_passes` does not name."""
    if name not in PASSES:
        return False
    return config is None or name not in (getattr(config, "disabled_passes", ()) or ())


@dataclass
class PassDecision:
    name: str
    fired: bool
    why: str
    attrs: dict = field(default_factory=dict)


@dataclass
class PassTrace:
    """The decisions of one query, in the order they were taken."""

    decisions: list = field(default_factory=list)


_trace: contextvars.ContextVar[PassTrace | None] = contextvars.ContextVar(
    "pass_trace", default=None
)


@contextlib.contextmanager
def use_trace(t: PassTrace):
    """Record the decisions taken inside the block into `t`."""
    token = _trace.set(t)
    try:
        yield t
    finally:
        _trace.reset(token)


def note(name: str, fired: bool, why: str, **attrs) -> None:
    """Record a pass decision; one context-variable read when no trace is
    open."""
    t = _trace.get()
    if t is not None:
        t.decisions.append(PassDecision(name, fired, why, attrs))
