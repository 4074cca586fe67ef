"""Planning of a tile-path query: the static plan and its runtime values.

Counterpart of the planning methods of
`greptimedb_tpu/parallel/tile_cache.py` `TileExecutor` (`_plan_cols`,
`_bucket_geometry`, `_build_plan`, `_plan_device_finalize`,
`config_acc_dtype`) and its module helpers
(`_choose_layout`, `_encode_tag_filter`, `_quantize_soft`, `_disjoint`),
copied as functions of the query config.  Differences:

* the group-by strategy is always the dense "sort" path, so
  `_choose_agg_strategy` has no counterpart (the hash path, B18, is not
  ported; `QueryConfig.validate` refuses "hash" and "auto");
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


def build_plan(config, lowering, schema, scan, ctx, tag_cols, time_bounds, use_ts):
    """(plan, dyn_host, spec) or None when the query cannot tile.  `plan`
    is the static structure (filter literals replaced by their arity,
    bucket geometry by placeholders); `dyn_host` carries the runtime
    values; `spec` is the device-finalize spec or None."""
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
    layout_tags = choose_layout(pk, tag_cols, bucket_col is not None)
    time_major = (
        bucket_col is not None
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
    plan = DistGroupByPlan(
        group_tags=tuple(tag_cols),
        tag_cards=tuple(_quantize_card(d.cardinality(t)) for t in tag_cols),
        bucket_col=bucket_col,
        bucket_origin=0,  # dynamic: see dyn_host
        bucket_interval=1,
        n_buckets=n_buckets,
        agg_specs=tuple(norm_specs),
        filters=tuple(enc_filters),
        acc_dtype=config_acc_dtype(config),
        ts_col=use_ts if needs_ts_order else None,
        filter_null_cols=filter_null_cols,
        layout_tags=None if layout_tags is None else tuple(layout_tags),
        layout_cards=() if layout_tags is None else tuple(
            _quantize_card(d.cardinality(t)) for t in layout_tags
        ),
        time_major=time_major,
    )
    dyn_host = {
        "filter_values": filter_vals,
        "bucket_origin": origin,
        "bucket_interval": interval_native,
    }
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
