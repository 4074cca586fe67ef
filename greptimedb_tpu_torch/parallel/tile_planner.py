"""Planning of a tile-path query: the static plan and its runtime values.

Counterpart of the planning methods of
`greptimedb_tpu/parallel/tile_cache.py` `TileExecutor` (`_plan_cols`,
`_bucket_geometry`, `_size_hash_slots`, `_choose_agg_strategy`,
`_build_plan`, `_plan_device_finalize`, `config_acc_dtype`) and its
module helpers (`_choose_layout`, `_encode_tag_filter`, `_quantize_soft`,
`_disjoint`, `_HASH_GID_LIMIT`), copied as functions of the query config.
Differences:

* the strategy probe (`choose_agg_strategy`) reads the tag dictionary
  only.  The port has no index sidecars, so no term index answers for a
  column the dictionary has not encoded; the tile executor therefore
  calls the probe once every source of the query (memtable tails and
  files) is encoded, before the limb planes are decided, where the
  reference calls it before its file encodes and asks the term index on
  a cold dictionary.  On a warm dictionary both read the same
  cardinalities;
* the blocked kernels' span is fixed at 16 (the reference sizes it per
  plan, and the port only records its estimate in the `time_major`
  note): where the reference's wider span would pass, the port's guard
  fails and the scatter path gives the same values;
* a keyed ORDER BY whose cap or number of keys exceeds K7's keyed
  limits is not consumed (the host replays the Sort), so the program
  never asks K7 for it.
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa

from ..datatypes.coercion import coerce_string_scalar
from ..ops.aggregate import BLOCK_ROWS, TOPK_MAX_KEYED_CAP, TOPK_MAX_KEYS, having_fits
from ..query import passes
from ..storage.dictionary import TableDictionary
from .executor import COUNT_STAR, DistGroupByPlan, _quantize_card

# Hash-strategy gids are int64 mixed-radix composites; past this padded
# group space the composition would wrap and alias distinct groups into
# one slot with no overflow verdict.  The margin below 2^63 keeps every
# intermediate `gid * card + c` in range too.
HASH_GID_LIMIT = 1 << 62


def plan_cols(plan: DistGroupByPlan) -> set:
    """Every column a plan's program reads."""
    need = set(plan.group_tags) | {f[0] for f in plan.filters}
    if plan.layout_tags:
        need |= set(plan.layout_tags)
    if plan.bucket_col:
        need.add(plan.bucket_col)
    if plan.ts_col:
        need.add(plan.ts_col)
    for _f, c in plan.agg_specs:
        if c != COUNT_STAR:
            need.add(c)
    return need


def quantize_soft(n: int) -> int:
    """Round up keeping 3 significant bits (12 -> 12, 13 -> 14, 25 -> 28)."""
    if n <= 8:
        return n
    step = 1 << (n.bit_length() - 3)
    return -(-n // step) * step


def bucket_geometry(lowering, schema, scan, time_bounds):
    """(bucket_col, interval_native, origin, n_buckets_real, n_buckets)."""
    if lowering.bucket is not None:
        ts_col, interval, origin_hint = lowering.bucket
        if (scan.time_range is not None and scan.time_range[0] > -(1 << 61)
                and scan.time_range[1] < (1 << 61)):
            lo, hi = scan.time_range
        else:
            lo, hi = time_bounds()
            hi += 1
        unit_ns = schema.time_index.data_type.timestamp_unit_ns()
        interval_native = max(int(interval * 1_000_000) // max(unit_ns, 1), 1)
        origin = origin_hint + ((lo - origin_hint) // interval_native) * interval_native
        n_buckets_real = max(int((hi - origin + interval_native - 1) // interval_native), 1)
        return ts_col, interval_native, origin, n_buckets_real, quantize_soft(n_buckets_real)
    return None, 1, 0, 1, 1


def config_acc_dtype(config) -> str:
    mode = getattr(config, "tile_acc_dtype", "limb")
    if mode == "limb" and passes.enabled("limb_quantize", config):
        return "limb"
    return "float64"


def choose_layout(pk: list[str], group_tags: list[str], has_bucket: bool) -> list[str] | None:
    """The hierarchical gid composition, or None when the requested groups
    already follow the storage sort order (direct layout) or group by the
    bucket alone.  Sources are sorted by (pk..., ts); a gid composed over
    a pk PREFIX in pk order (+ bucket last) is non-decreasing per source."""
    if not all(t in pk for t in group_tags):
        return None  # non-pk group tag: no layout claim (scatter handles)
    if has_bucket:
        if not group_tags:
            return None
        if list(group_tags) == pk:
            return None  # direct: (full pk, bucket) rides the sort
        return pk  # aggregate at (full pk, bucket), fold down
    if not group_tags:
        return None  # scalar aggregate: single group
    if list(group_tags) == pk[: len(group_tags)]:
        return None  # direct: pk prefix in pk order
    j = 1 + max(pk.index(t) for t in group_tags)
    return pk[:j]


def encode_tag_filter(d: TableDictionary, name: str, op: str, value):
    """A tag-string predicate in code space.  Sorted codes make
    inequalities exact; the null slot (the max code) is excluded from every
    operator except '='."""
    null_code = d.code_of(name, None)
    guard = [(name, "!=", null_code)] if null_code >= 0 else []
    if op == "=":
        return [(name, "=", d.code_of(name, value))]
    if op == "!=":
        return guard + [(name, "!=", d.code_of(name, value))]
    if op == "in":
        return guard + [(name, "in", tuple(d.code_of(name, v) for v in value))]
    if op == "not in":
        return guard + [(name, "not in", tuple(d.code_of(name, v) for v in value))]
    if op == "<":
        return guard + [(name, "<", d.bound(name, value))]
    if op == ">=":
        return guard + [(name, ">=", d.bound(name, value))]
    if op == "<=":
        return guard + [(name, "<", d.bound_right(name, value))]
    if op == ">":
        return guard + [(name, ">=", d.bound_right(name, value))]
    return None


def disjoint(ranges: list[tuple[int, int]]) -> bool:
    """True when every pair of inclusive [lo, hi] ranges is non-overlapping."""
    if len(ranges) <= 1:
        return True
    s = sorted(ranges)
    for (_alo, ahi), (blo, _bhi) in zip(s, s[1:]):
        if ahi >= blo:
            return False
    return True


def _coerce(v):
    """A numeric literal given as a string; None when it is not numeric."""
    if isinstance(v, str):
        try:
            c = coerce_string_scalar(v, pa.float64())
        except (ValueError, TypeError):
            return None
        v = c.as_py() if isinstance(c, pa.Scalar) else c
        if isinstance(v, str):
            return None
    return v


def size_hash_slots(config, d_est: int) -> int:
    """Slot-table size for a distinct-key estimate: the next power of two
    past 2x (load factor <= 0.5), floored at 1024, capped at the
    internal-groups bound.  The result stays a power of two (K17
    addresses with `& (H - 1)`), so a max_internal_groups that is not one
    clamps down to its largest contained power of two."""
    cap = max(int(config.max_internal_groups), 1 << 10)
    cap = 1 << (cap.bit_length() - 1)
    slots = 1 << 10
    while slots < 2 * d_est and slots < cap:
        slots <<= 1
    return min(slots, cap)


def choose_agg_strategy(config, lowering, schema, scan, ctx, tag_cols, time_bounds):
    """Pick hash vs sort before the plan is built, from the per-tag
    dictionary cardinalities against the padded dense group space: dense
    [G] states win while G is small and the (pk, ts) sort feeds the blocked
    kernels; a slot table sized to the distinct keys wins when G is sparse,
    and is the only option once G passes the dense bound.  Returns the
    probe dict build_plan consumes, or None meaning "sort"."""
    knob = getattr(config, "agg_strategy", "auto")
    has_last = any(f == "last_value" for f, _c in lowering.agg_specs)
    why_sort = None
    if not passes.enabled("agg_strategy", config):
        why_sort = "pass disabled"
    elif knob == "sort":
        why_sort = "query.agg_strategy=sort forces the dense path"
    elif not tag_cols:
        why_sort = "bucket-only group-by: dense space is one axis, trivially small"
    elif has_last:
        why_sort = "last_value needs the ts-ordered dense kernels"
    if why_sort is not None:
        passes.note("agg_strategy", False, why_sort)
        return None
    d = ctx.dictionary
    est_rows = max(sum(r.approx_rows() for r in ctx.regions), 1)
    _bc, _iv, _orig, n_buckets_real, n_buckets = bucket_geometry(
        lowering, schema, scan, time_bounds
    )
    d_prod = 1
    g_est = n_buckets
    for t in tag_cols:
        card = max(d.cardinality(t), 1)
        d_prod *= card
        g_est *= _quantize_card(card)
    if g_est >= HASH_GID_LIMIT:
        passes.note(
            "agg_strategy", False,
            f"padded group space {g_est} exceeds the int64 gid range: "
            "neither strategy can address it; scan path owns the query",
        )
        return None
    d_est = min(est_rows, d_prod * max(n_buckets_real, 1))
    slots = size_hash_slots(config, d_est)
    if slots < 2 * d_est and knob != "hash":
        # the cap clamped the table below 2x the estimate: overflow is
        # likely, auto declines (forced hash proceeds: the estimate is an
        # upper bound and the overflow verdict stays the net)
        passes.note(
            "agg_strategy", False,
            f"~{d_est} distinct keys exceed half the {slots}-slot cap "
            "(query.max_internal_groups): hash would overflow, dense/"
            "scan paths own the query",
        )
        return None
    info = {"strategy": "hash", "slots": slots, "d_est": int(d_est), "g_est": int(g_est),
            "stats_src": "dictionary"}
    if knob == "hash":
        info["why"] = (
            f"query.agg_strategy=hash forced: ~{d_est} distinct keys "
            f"into {slots} slots (dense space {g_est})"
        )
        return info
    min_space = int(getattr(config, "agg_hash_min_group_space", 1 << 16))
    if g_est >= min_space and d_est * 4 <= g_est:
        info["why"] = (
            f"sparse group space: ~{d_est} distinct keys (dictionary) vs "
            f"{g_est} dense groups -> {slots}-slot hash table"
        )
        return info
    passes.note(
        "agg_strategy", False,
        f"dense space {g_est} is small or well-filled (~{d_est} "
        "distinct keys): sorted dense states win",
        groups=int(g_est), distinct_est=int(d_est),
    )
    return None


def build_plan(config, lowering, schema, scan, ctx, tag_cols, time_bounds, use_ts,
               agg_probe=None):
    """(plan, dyn_host, spec) or None when the query cannot tile.  `plan`
    is the static structure (filter literals replaced by their arity,
    bucket geometry by placeholders); `dyn_host` carries the runtime
    values; `spec` is the device-finalize spec or None.  `agg_probe` (a
    `choose_agg_strategy` result) switches the plan to the hash group-by:
    no layout fold, no time-major copies, exact f64 accumulation, and the
    probe's slot count.  The reference re-sizes the table and re-checks
    the gid range here because its probe read a cold dictionary; the
    port's probe already reads the final one (see the module docstring),
    and declines a gid space past `HASH_GID_LIMIT` itself."""
    d = ctx.dictionary
    bucket_col, interval_native, origin, n_buckets_real, n_buckets = bucket_geometry(
        lowering, schema, scan, time_bounds
    )
    ts_name = schema.time_index.name if schema.time_index else None
    tag_names = {c.name for c in schema.tag_columns()}
    enc_filters: list[tuple[str, str, object]] = []
    filter_vals: list = []

    def push(name, op, value, dtype):
        if op in ("in", "not in"):
            enc_filters.append((name, op, len(value)))
            filter_vals.append(tuple(dtype(v) for v in value))
        else:
            enc_filters.append((name, op, None))
            filter_vals.append(dtype(value))

    for name, op, value in scan.filters:
        if name in tag_names:
            f = encode_tag_filter(d, name, op, value)
            if f is None:
                return None
            for fname, fop, fval in f:
                push(fname, fop, fval, np.int32)
        else:
            if op in ("in", "not in"):
                vals = [_coerce(v) for v in value]
                if any(v is None for v in vals):
                    return None
                value = tuple(vals)
            else:
                value = _coerce(value)
                if value is None:
                    return None
            push(name, op, value, np.int64 if name == ts_name else np.float64)
    if scan.time_range is not None and use_ts:
        lo, hi = scan.time_range
        if lo > -(1 << 61):
            push(use_ts, ">=", int(lo), np.int64)
        if hi < (1 << 61):
            push(use_ts, "<", int(hi), np.int64)

    norm_specs = [(func, COUNT_STAR if col is None else col) for func, col in lowering.agg_specs]
    needs_ts_order = any(f == "last_value" for f, _ in norm_specs)
    pk = [c.name for c in schema.tag_columns()]
    is_hash = agg_probe is not None and agg_probe.get("strategy") == "hash"
    layout_tags = None if is_hash else choose_layout(pk, tag_cols, bucket_col is not None)
    time_major = (
        not is_hash
        and bucket_col is not None
        and not tag_cols
        and layout_tags is None
        and passes.enabled("time_major", config)
    )
    if time_major:
        # window rows spread over n_buckets (out-of-window rows are masked):
        # the distinct ids a 4096-row block of the copies touches, which
        # the reference sizes its span by; the port's stays 16
        est_rows = sum(r.approx_rows() for r in ctx.regions)
        per_group = max(est_rows // max(n_buckets, 1), 1)
        passes.note(
            "time_major", True,
            "bucket-only group-by reduces over a time-major permutation",
            span_est=-(-BLOCK_ROWS // per_group) + 2,
        )
    elif bucket_col is not None and not tag_cols:
        passes.note("time_major", False, "time-major disabled or layout claims the sort order")
    if layout_tags is not None and needs_ts_order and set(tag_cols) != set(layout_tags):
        return None  # LAST states only permute, never fold away an axis
    if time_major and needs_ts_order:
        return None  # LAST states need the (pk, ts) order
    filter_null_cols = tuple(sorted({
        name for name, _op, _v in enc_filters
        if name not in tag_names and name != ts_name
        and schema.has_column(name) and schema.column(name).nullable
    }))
    acc_dtype = config_acc_dtype(config)
    hash_slots = 0
    if is_hash:
        hash_slots = agg_probe["slots"]
        # hash accumulates exact f64: slot ids defeat the limb kernels'
        # block geometry
        acc_dtype = "float64"
    plan = DistGroupByPlan(
        group_tags=tuple(tag_cols),
        tag_cards=tuple(_quantize_card(d.cardinality(t)) for t in tag_cols),
        bucket_col=bucket_col,
        bucket_origin=0,  # dynamic: see dyn_host
        bucket_interval=1,
        n_buckets=n_buckets,
        agg_specs=tuple(norm_specs),
        filters=tuple(enc_filters),
        acc_dtype=acc_dtype,
        ts_col=use_ts if needs_ts_order else None,
        filter_null_cols=filter_null_cols,
        layout_tags=None if layout_tags is None else tuple(layout_tags),
        layout_cards=() if layout_tags is None else tuple(
            _quantize_card(d.cardinality(t)) for t in layout_tags
        ),
        time_major=time_major,
        agg_strategy="hash" if is_hash else "sort",
        hash_slots=hash_slots,
    )
    dyn_host = {
        "filter_values": filter_vals,
        "bucket_origin": origin,
        "bucket_interval": interval_native,
    }
    if is_hash:
        # hash results are already compact (O(slots) fetch, host slot ->
        # key decode); Sort/LIMIT/HAVING replay on the host
        passes.note(
            "device_finalize", False,
            "hash agg strategy ships compact slots; host post-ops own Sort/LIMIT/HAVING",
        )
        return plan, dyn_host, None
    spec = plan_device_finalize(config, lowering, schema, ctx, plan, dyn_host, n_buckets_real)
    return plan, dyn_host, spec


def plan_device_finalize(config, lowering, schema, ctx, plan, dyn_host, n_buckets_real):
    """The device-finalize spec, or None.  Engages when the device can
    consume HAVING/Sort/Limit, when the real group bound is at most half the
    padded group space (compaction alone pays), and always for last_value
    plans.  With no LIMIT `cap` bounds the non-empty groups, so the compact
    fetch never overflows."""
    from ..query.device_finalize import DeviceFinalizeSpec, DevicePost, derive_post_lowering

    if not (passes.enabled("device_finalize", config) and getattr(config, "device_topk", True)):
        return None
    if plan.num_groups <= 1:
        return None
    post = derive_post_lowering(lowering, schema)
    if post is None:
        return None
    real_groups = max(n_buckets_real, 1)
    for t in plan.group_tags:
        real_groups *= max(ctx.dictionary.cardinality(t), 1)

    def cap_of(p):
        if p.limit is not None:
            return min(plan.num_groups, p.offset + p.limit)
        return min(plan.num_groups, quantize_soft(real_groups))

    cap = cap_of(post)
    if (post.order and (cap > TOPK_MAX_KEYED_CAP or len(post.order) > TOPK_MAX_KEYS)) or (
        post.having is not None and not having_fits(post.having)
    ):
        # K7's keyed selection stops at TOPK_MAX_KEYS keys and a cap of
        # TOPK_MAX_KEYED_CAP, K13's program at its fixed tables: leave the
        # post-plan to the host, keep the compaction
        post = DevicePost()
        cap = cap_of(post)
    has_last = any(f == "last_value" for f, _c in plan.agg_specs)
    if cap <= 0 or not (post.consumed or cap * 2 <= plan.num_groups or has_last):
        return None
    dyn_host["post_consumed"] = post.consumed
    dyn_host["having_values"] = tuple(post.having_values)
    return DeviceFinalizeSpec(order=post.order, having=post.having,
                              n_having_values=len(post.having_values), limit=post.limit,
                              offset=post.offset, cap=int(cap))
