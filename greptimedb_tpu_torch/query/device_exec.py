"""Device physical planner: recognize lowerable plans, run them on a torch
device.

Counterpart of `greptimedb_tpu/query/tpu_exec.py` (`try_lower`,
`TpuExecutor.execute` on its table-fed path).  It pattern-matches the
scan -> filter -> time-bucketed GROUP BY aggregate shape and lowers it to
`parallel/executor.py::distributed_groupby`; anything it cannot prove
lowerable returns None and the CPU executor runs it.  Post-aggregation
operators (HAVING / projection arithmetic / ORDER BY / LIMIT) replay on
the CPU executor over the small aggregated result.

The super-tile cache path (`try_tile`), device-side HAVING/top-k and
distributed state shipping are not ported (ROADMAP.md).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import pyarrow as pa

from ..datatypes.schema import Schema
from .cpu_exec import CpuExecutor
from .expr import AggCall, Alias, Column, Expr, FuncCall, Literal, strip_alias
from .logical_plan import (
    Aggregate,
    Having,
    Limit,
    LogicalPlan,
    Project,
    Sort,
    TableScan,
)

LOWERABLE_AGGS = {"sum", "avg", "min", "max", "count", "last_value"}


@dataclass
class Lowering:
    """A proven-lowerable plan: the scan+aggregate for the device, and the
    post-plan (relative to the aggregate output) for the host."""

    scan: TableScan
    group_tags: list[str]
    bucket: tuple[str, int, int] | None  # (ts_col, interval, origin_hint)
    agg_specs: list[tuple[str, str | None]]  # (func, col or None for count(*))
    post_ops: list[LogicalPlan] = field(default_factory=list)  # outer-first
    group_exprs: list[Expr] = field(default_factory=list)
    agg_exprs: list[Expr] = field(default_factory=list)


def _post_has_subquery(node) -> bool:
    from .expr import PlannedSubquery, Subquery

    exprs: list = []
    if isinstance(node, Having):
        exprs.append(node.predicate)
    elif isinstance(node, Project):
        exprs.extend(node.exprs)
    elif isinstance(node, Sort):
        exprs.extend(e for e, _asc in node.keys)
    for e in exprs:
        if isinstance(e, Expr) and any(
            isinstance(x, (Subquery, PlannedSubquery)) for x in e.walk()
        ):
            return True
    return False


def try_lower(plan: LogicalPlan, schema: Schema) -> Lowering | None:
    """Walk from the root: collect post-aggregation ops until the Aggregate,
    then prove Aggregate(TableScan) matches the kernel shape."""
    post: list[LogicalPlan] = []
    node = plan
    while isinstance(node, (Limit, Sort, Project, Having)):
        if _post_has_subquery(node):
            # the post-op replay resolves every TableScan to the kernel's
            # RESULT table — a scalar subquery over a real table would
            # silently read the wrong data
            return None
        post.append(node)
        node = node.children()[0]
    if not isinstance(node, Aggregate):
        return None
    agg = node
    if not isinstance(agg.input, TableScan):
        return None  # residual Filter exprs block lowering (non-simple preds)
    scan = agg.input

    ts_col = schema.time_index.name if schema.time_index else None
    tag_names = {c.name for c in schema.tag_columns()}
    field_names = {c.name for c in schema.field_columns()}

    group_tags: list[str] = []
    bucket: tuple[str, int, int] | None = None
    for ge in agg.group_exprs:
        e = strip_alias(ge)
        if isinstance(e, Column) and e.column in tag_names:
            group_tags.append(e.column)
        elif isinstance(e, FuncCall) and e.func in ("time_bucket", "date_bin"):
            if bucket is not None:
                return None  # at most one time bucket dimension
            if len(e.args) < 2 or not isinstance(e.args[1], Column):
                return None
            if e.args[1].column != ts_col:
                return None
            if not isinstance(e.args[0], Literal):
                return None
            from .sql_parser import _parse_interval

            iv = e.args[0].value
            interval_ms = _parse_interval(iv) if isinstance(iv, str) else int(iv)
            origin = 0
            if len(e.args) > 2:
                if not isinstance(e.args[2], Literal) or not isinstance(e.args[2].value, (int, float)):
                    return None
                origin = int(e.args[2].value)
            bucket = (ts_col, interval_ms, origin)
        else:
            return None

    agg_specs: list[tuple[str, str | None]] = []
    for ae in agg.agg_exprs:
        inner = strip_alias(ae)
        if not isinstance(inner, AggCall):
            return None  # arithmetic over aggs not lowered yet
        func = "avg" if inner.func == "mean" else inner.func
        if func not in LOWERABLE_AGGS:
            return None
        if inner.distinct:
            return None  # count(DISTINCT x) has no segment-sum lowering
        if inner.arg is None:
            agg_specs.append(("count", None))
            continue
        if not isinstance(inner.arg, Column) or inner.arg.column not in field_names:
            return None
        col_schema = schema.column(inner.arg.column)
        if not col_schema.data_type.is_numeric():
            return None
        if getattr(col_schema.data_type, "value", "") in ("int64", "uint64"):
            # BIGINT aggregates stay on the authoritative CPU path: f64
            # accumulation cannot represent int64 extremes exactly
            return None
        if func == "last_value" and inner.order_by not in (None, ts_col):
            return None
        agg_specs.append((func, inner.arg.column))
    if not agg_specs:
        return None

    return Lowering(
        scan=scan,
        group_tags=group_tags,
        bucket=bucket,
        agg_specs=agg_specs,
        post_ops=post,
        group_exprs=agg.group_exprs,
        agg_exprs=agg.agg_exprs,
    )


class DeviceExecutor:
    """Executes lowered plans on one torch device; post-ops on the CPU."""

    def __init__(self, region_scan_provider, device):
        # region_scan_provider(scan: TableScan) -> list[pa.Table], one per region
        self.region_scan = region_scan_provider
        self.device = device
        # host wall ms per stage of the last execute(): scan, tile,
        # device, readback, post (decode + post-ops)
        self.timings: dict[str, float] = {}

    def execute(self, lowering: Lowering, schema: Schema, time_bounds) -> pa.Table:
        """time_bounds: callback () -> (min_ts, max_ts) over the scanned data,
        used when the query has no explicit time range."""
        from ..parallel.executor import distributed_groupby

        scan = lowering.scan
        if lowering.bucket is not None:
            ts_col, interval, origin_hint = lowering.bucket
            if scan.time_range is not None and scan.time_range[0] > -(1 << 61) and scan.time_range[1] < (1 << 61):
                lo, hi = scan.time_range
            else:
                lo, hi = time_bounds()
                hi += 1  # bounds are inclusive; range is half-open
            unit_ns = schema.time_index.data_type.timestamp_unit_ns()
            interval_native = max(int(interval * 1_000_000) // max(unit_ns, 1), 1)
            origin = origin_hint + ((lo - origin_hint) // interval_native) * interval_native
            n_buckets = max(int((hi - origin + interval_native - 1) // interval_native), 1)
            bucket_col = ts_col
        else:
            bucket_col, interval_native, origin, n_buckets = None, 1, 0, 1

        t0 = time.perf_counter()
        region_tables = self.region_scan(scan)
        t1 = time.perf_counter()
        needs_ts = any(f == "last_value" for f, _ in lowering.agg_specs)
        result = distributed_groupby(
            region_tables,
            group_tags=lowering.group_tags,
            bucket_col=bucket_col,
            bucket_origin=origin,
            bucket_interval=interval_native,
            n_buckets=n_buckets,
            agg_specs=[(f, c) for f, c in lowering.agg_specs],
            filters=list(scan.filters),
            device=self.device,
            ts_col=schema.time_index.name if needs_ts and schema.time_index else None,
        )
        t2 = time.perf_counter()
        out = self._shape_output(result.to_table(), lowering, schema)
        self.timings = {
            "scan": (t1 - t0) * 1e3, **result.timings,
            "post": (time.perf_counter() - t2) * 1e3,
        }
        return out

    def _shape_output(self, table: pa.Table, lowering: Lowering, schema: Schema) -> pa.Table:
        """Kernel output -> SQL result: plan names, empty-input semantics,
        host-side post ops."""
        table = self._rename_to_plan_names(table, lowering, schema)
        if (
            not lowering.group_tags
            and lowering.bucket is None
            and table.num_rows == 0
        ):
            # SQL semantics: an ungrouped aggregate over empty input yields
            # one row — count()=0, everything else null
            cols = {}
            for ae in lowering.agg_exprs:
                inner = strip_alias(ae)
                is_count = isinstance(inner, AggCall) and inner.func == "count"
                cols[inner.name()] = pa.array(
                    [0 if is_count else None],
                    pa.int64() if is_count else pa.float64(),
                )
            table = pa.table(cols)
        return self._run_post_ops(table, lowering)

    def _rename_to_plan_names(self, table: pa.Table, lowering: Lowering, schema: Schema) -> pa.Table:
        """Kernel output names -> the plan's expression names, and bucket ts
        ints -> the time index's timestamp type."""
        rename: dict[str, str] = {}
        for ge in lowering.group_exprs:
            e = strip_alias(ge)
            if isinstance(e, FuncCall) and lowering.bucket is not None:
                rename[lowering.bucket[0]] = ge.name() if not isinstance(ge, Alias) else e.name()
        for ae in lowering.agg_exprs:
            inner = strip_alias(ae)
            kernel_name = f"{'avg' if inner.func == 'mean' else inner.func}({inner.arg.column})" if inner.arg is not None else "count(*)"
            rename[kernel_name] = inner.name()
        cols, names = [], []
        for name in table.column_names:
            out_name = rename.get(name, name)
            col = table[name]
            if lowering.bucket is not None and name == lowering.bucket[0]:
                col = col.cast(schema.time_index.data_type.to_arrow())
            cols.append(col)
            names.append(out_name)
        return pa.table(dict(zip(names, cols)))

    def _run_post_ops(self, table: pa.Table, lowering: Lowering) -> pa.Table:
        """Replay Having/Project/Sort/Limit over the aggregated table with
        the CPU executor (the small, frontend-side upper plan)."""
        if not lowering.post_ops:
            return table
        plan: LogicalPlan = TableScan(table="__device_result")
        for op in reversed(lowering.post_ops):
            if isinstance(op, Having):
                plan = Having(plan, op.predicate)
            elif isinstance(op, Project):
                plan = Project(plan, op.exprs)
            elif isinstance(op, Sort):
                plan = Sort(plan, op.keys, nulls=op.nulls)
            elif isinstance(op, Limit):
                plan = Limit(plan, op.limit, op.offset)
        cpu = CpuExecutor(lambda _scan: table)
        return cpu.execute(plan)
