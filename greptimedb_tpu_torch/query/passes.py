"""Physical-strategy passes of the tile path: named and individually
switchable.

Counterpart of `greptimedb_tpu/query/passes.py`, holding only the passes
the port implements and whose decision points consult `enabled()`.  A
pass the reference has and the port does not (time-major, window tiles,
incremental planes, the host fast path, the fused build, the mesh, ...)
does not exist here, so `enabled()` reports it off: the port behaves as
the reference does with that pass in `query.disabled_passes`.  The
per-query decision trace of the reference (EXPLAIN ANALYZE) is not
ported.
"""

from __future__ import annotations

# name -> what the pass does, in run order
PASSES = {
    "limb_quantize": "accumulate sum/avg through fixed-point base-256 digit planes (K5 "
                     "quantize, K6 integer segment sums) with a per-group error bound",
    "device_finalize": "run ORDER BY / LIMIT and result compaction on the card over the "
                       "finalized [G] states (K7) so the one readback is O(rows_out)",
    "tql_tile": "evaluate PromQL range functions (rate/increase/delta, *_over_time, the "
                "by-label sum/avg/min/max/count fold) as one program (K9-K12) over the "
                "resident super-tile planes, with a compacted [series_out, steps] readback",
}


def enabled(name: str, config=None) -> bool:
    """A pass the port has that `query.disabled_passes` does not name."""
    if name not in PASSES:
        return False
    return config is None or name not in (getattr(config, "disabled_passes", ()) or ())
