"""CPU executor: the authoritative Arrow-compute execution path.

Role-equivalent of running the reference's plans on DataFusion's CPU
operators — this path defines correct results; the TPU path must match it
(SURVEY.md section 7 step 3's "CPU path authoritative" rule).  Evaluates
logical plans over pyarrow tables with pyarrow.compute kernels.
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from ..utils.errors import ExecutionError, PlanError
from .expr import (
    AggCall,
    Alias,
    Between,
    BinaryOp,
    Column,
    Expr,
    FuncCall,
    InList,
    IsNull,
    Literal,
    PlannedSubquery,
    Star,
    UnaryOp,
    WindowCall,
    find_agg_calls,
    map_aggs,
    map_expr,
    split_conjuncts,
    strip_alias,
)
from .logical_plan import (
    Aggregate,
    Distinct,
    Filter,
    Having,
    Join,
    Limit,
    LogicalPlan,
    Project,
    RangeSelect,
    Sort,
    SubqueryAlias,
    TableScan,
    Union,
    VectorSearch,
    Window,
)

# ---- expression evaluation -------------------------------------------------


def resolve_column(name: str, columns: list[str]) -> str | None:
    """Resolve a (possibly alias-qualified) column reference against a
    table's columns.  Join outputs qualify colliding columns as
    "side.column"; unqualified refs resolve when unambiguous."""
    if name in columns:
        return name
    if "." in name:
        base = name.rsplit(".", 1)[1]
        if base in columns:
            return base
        cands = [c for c in columns if c.endswith("." + base)]
        if len(cands) == 1:
            return cands[0]
        return None
    cands = [c for c in columns if c.endswith("." + name)]
    if len(cands) == 1:
        return cands[0]
    if len(cands) > 1:
        raise PlanError(f"ambiguous column reference: {name} (matches {cands})")
    return None


def eval_expr(e: Expr, table: pa.Table):
    """Evaluate an expression to an Arrow array (or scalar for literals)."""
    if isinstance(e, Alias):
        return eval_expr(e.expr, table)
    if isinstance(e, WindowCall):
        # Window columns are materialized by the Window node under this name.
        if e.name() in table.column_names:
            col = table[e.name()]
            return col.combine_chunks() if isinstance(col, pa.ChunkedArray) else col
        raise PlanError(f"window expression {e.name()} not materialized")
    if isinstance(e, Column):
        resolved = resolve_column(e.column, table.column_names)
        if resolved is None:
            raise PlanError(f"unknown column: {e.column}")
        col = table[resolved]
        if pa.types.is_dictionary(col.type):
            col = pc.cast(col, col.type.value_type)
        return col.combine_chunks() if isinstance(col, pa.ChunkedArray) else col
    if isinstance(e, Literal):
        return pa.scalar(e.value)
    if isinstance(e, BinaryOp):
        return _eval_binary(e, table)
    if isinstance(e, UnaryOp):
        v = eval_expr(e.operand, table)
        if e.op == "not":
            return pc.invert(v)
        if e.op == "-":
            return pc.negate(v)
        raise PlanError(f"unknown unary op {e.op}")
    if isinstance(e, InList):
        v = eval_expr(e.expr, table)
        m = pc.is_in(v, value_set=pa.array(list(e.values)))
        return pc.invert(m) if e.negated else m
    if isinstance(e, Between):
        v = eval_expr(e.expr, table)
        lo = eval_expr(e.low, table)
        hi = eval_expr(e.high, table)
        v1, lo = _align_ts(v, lo)
        v2, hi = _align_ts(v, hi)
        m = pc.and_kleene(pc.greater_equal(v1, lo), pc.less_equal(v2, hi))
        return pc.invert(m) if e.negated else m
    if isinstance(e, IsNull):
        v = eval_expr(e.expr, table)
        m = pc.is_null(v)
        return pc.invert(m) if e.negated else m
    if isinstance(e, FuncCall):
        return _eval_func(e, table)
    raise PlanError(f"cannot evaluate expression: {e!r}")


def _eval_binary(e: BinaryOp, table: pa.Table):
    l = eval_expr(e.left, table)
    r = eval_expr(e.right, table)
    op = e.op
    if op == "and":
        return pc.and_kleene(l, r)
    if op == "or":
        return pc.or_kleene(l, r)
    if op in ("like", "ilike"):
        import re as _re

        pattern = r.as_py() if isinstance(r, pa.Scalar) else r
        # only % and _ are LIKE wildcards; every other char is literal
        # (unescaped regex metachars matched wrongly / raised)
        regex = "".join(
            ".*" if ch == "%" else "." if ch == "_" else _re.escape(ch)
            for ch in pattern
        )
        return pc.match_substring_regex(
            l, f"^{regex}$", ignore_case=(op == "ilike")
        )
    cmp = {
        "=": pc.equal,
        "!=": pc.not_equal,
        "<": pc.less,
        "<=": pc.less_equal,
        ">": pc.greater,
        ">=": pc.greater_equal,
    }
    if op in cmp:
        l, r = _align_ts(l, r)
        l, r = _coerce_literal(l, r)
        return cmp[op](l, r)
    arith = {"+": pc.add, "-": pc.subtract, "*": pc.multiply, "/": pc.divide, "%": _mod}
    if op in arith:
        # timestamp +/- integer treats the integer as milliseconds (the
        # unit INTERVAL literals parse to) cast to the timestamp's
        # duration unit — Arrow has no timestamp+int kernel
        l, r = _interval_align(l, r, op)
        return arith[op](l, r)
    raise PlanError(f"unknown binary op {op}")


_TS_UNIT_PER_MS = {"s": 0.001, "ms": 1, "us": 1000, "ns": 1_000_000}


def _float_to_int_cast(v, arrow_t):
    """float -> int with arrow-rs `as`-cast semantics (the reference's
    CAST): truncate toward zero, saturate out-of-range, NaN -> 0.  A raw
    pyarrow safe=False cast wraps NaN/overflow to INT_MIN instead."""
    import numpy as np

    info = np.iinfo(arrow_t.to_pandas_dtype())
    t = pc.trunc(v)
    scalar = isinstance(t, pa.Scalar)
    if scalar:
        x = t.as_py()
        if x is None or x != x:  # NULL stays NULL; NaN -> 0
            x = None if x is None else 0
        else:
            x = min(max(int(x), info.min), info.max)
        return pa.scalar(x, arrow_t)
    nan = pc.is_nan(t)
    hi = float(info.max)
    if int(hi) > info.max:  # float(2^63-1) rounds UP to 2^63: step below
        hi = float(np.nextafter(hi, 0))
    clamped = pc.min_element_wise(
        pc.max_element_wise(t, pa.scalar(float(info.min))), pa.scalar(hi)
    )
    base = pc.cast(clamped, arrow_t, safe=False)
    return pc.if_else(nan, pa.scalar(0, arrow_t), base)


def _interval_align(l, r, op):
    def is_ts(x):
        return pa.types.is_timestamp(getattr(x, "type", pa.null()))

    def is_int(x):
        t = getattr(x, "type", None)
        return t is not None and (pa.types.is_integer(t) or pa.types.is_floating(t))

    def to_dur(ms_val, unit):
        factor = _TS_UNIT_PER_MS[unit]
        if isinstance(ms_val, pa.Scalar):
            return pa.scalar(round(ms_val.as_py() * factor), pa.duration(unit))
        # float64 -> duration has no arrow kernel; go through int64
        as_int = pc.cast(
            pc.round(pc.multiply(pc.cast(ms_val, pa.float64()), factor)),
            pa.int64(),
        )
        return pc.cast(as_int, pa.duration(unit))

    if is_ts(l) and is_int(r) and op in ("+", "-"):
        return l, to_dur(r, l.type.unit)
    if is_ts(r) and is_int(l) and op == "+":
        return to_dur(l, r.type.unit), r
    return l, r


def _mod(l, r):
    if isinstance(l, pa.Scalar) and isinstance(r, pa.Scalar):
        return pa.scalar(np.mod(l.as_py(), r.as_py()).item())
    ln = l.as_py() if isinstance(l, pa.Scalar) else np.asarray(l)
    rn = r.as_py() if isinstance(r, pa.Scalar) else np.asarray(r)
    return pa.array(np.mod(ln, rn))


def _align_ts(l, r):
    """Compare timestamp columns against int/string literals sanely."""
    def is_ts(x):
        t = x.type if isinstance(x, (pa.Array, pa.ChunkedArray, pa.Scalar)) else None
        return t is not None and pa.types.is_timestamp(t)

    if is_ts(l) and isinstance(r, pa.Scalar) and not is_ts(r):
        rv = r.as_py()
        if isinstance(rv, (int, float)):
            return pc.cast(l, pa.int64()), pa.scalar(int(rv))
        if isinstance(rv, str):
            return l, pa.scalar(np.datetime64(rv.replace(" ", "T"), "ms").astype("datetime64[ms]")).cast(l.type)
    if is_ts(r) and isinstance(l, pa.Scalar) and not is_ts(l):
        rr, ll = _align_ts(r, l)
        return ll, rr
    return l, r


def _coerce_literal(l, r):
    """String literal vs numeric/bool column — shared rule, see
    datatypes/coercion.py."""
    from ..datatypes.coercion import coerce_string_scalar

    def col_type(x):
        return x.type if isinstance(x, (pa.Array, pa.ChunkedArray)) else None

    lt, rt = col_type(l), col_type(r)
    if lt is not None:
        r = coerce_string_scalar(r, lt)
    if rt is not None:
        l = coerce_string_scalar(l, rt)
    return l, r


def _eval_func(e: FuncCall, table: pa.Table):
    f = e.func
    args = e.args
    if f in ("time_bucket", "date_bin"):
        # time_bucket(interval, ts) / date_bin(interval, ts[, origin])
        interval = _interval_ms(args[0], table)
        ts = eval_expr(args[1], table)
        origin = 0
        if len(args) > 2:
            o = eval_expr(args[2], table)
            origin = o.as_py() if isinstance(o, pa.Scalar) else 0
        t_int = pc.cast(ts, pa.int64())
        unit = ts.type.unit if pa.types.is_timestamp(ts.type) else "ms"
        units_per_ms = {"s": 0.001, "ms": 1, "us": 1000, "ns": 1_000_000}[unit]
        iv_native = max(int(interval * units_per_ms), 1)
        bucketed = pc.multiply(pc.floor(pc.divide(pc.subtract(t_int, origin), iv_native)), iv_native)
        bucketed = pc.add(pc.cast(bucketed, pa.int64()), origin)
        return pc.cast(bucketed, ts.type if pa.types.is_timestamp(ts.type) else pa.int64())
    if f == "date_trunc":
        unit = args[0].value if isinstance(args[0], Literal) else "hour"
        ts = eval_expr(args[1], table)
        return pc.floor_temporal(ts, unit=unit)
    if f == "cast":
        v = eval_expr(args[0], table)
        from ..datatypes.data_type import ConcreteDataType

        target = ConcreteDataType.parse(args[1].value)
        arrow_t = target.to_arrow()
        if pa.types.is_integer(arrow_t) and pa.types.is_floating(
            getattr(v, "type", pa.null())
        ):
            return _float_to_int_cast(v, arrow_t)
        return pc.cast(v, arrow_t)
    if f in ("matches", "matches_term"):
        raise PlanError(f"{f}() needs the fulltext index, which is not ported yet")
    if f == "case":
        flat = [eval_expr(a, table) for a in args]
        conds, vals = flat[:-1:2], flat[1:-1:2]
        default = flat[-1]
        n = table.num_rows
        out = None
        for cond, val in zip(reversed(conds), reversed(vals)):
            base = out if out is not None else (
                pa.array([default.as_py()] * n) if isinstance(default, pa.Scalar) else default
            )
            val_arr = pa.array([val.as_py()] * n) if isinstance(val, pa.Scalar) else val
            out = pc.if_else(cond, val_arr, base)
        return out if out is not None else default
    if f in ("now", "current_timestamp"):
        import time

        return pa.scalar(int(time.time() * 1000), pa.timestamp("ms"))
    from .functions import call_function, has_function

    if has_function(f):
        return call_function(f, [eval_expr(a, table) for a in args])
    raise PlanError(f"unknown function: {f}")


def _interval_ms(e: Expr, table) -> int:
    from .sql_parser import _parse_interval

    if isinstance(e, Literal):
        if isinstance(e.value, str):
            return _parse_interval(e.value)
        return int(e.value)
    raise PlanError("interval argument must be a literal")


# ---- plan execution --------------------------------------------------------


class CpuExecutor:
    """Executes a logical plan; scans are served by a callback so the same
    executor runs standalone (local engine) or as the datanode-side stage
    of a shipped sub-plan."""

    def __init__(self, scan_provider, vector_search_provider=None):
        # scan_provider(scan: TableScan) -> pa.Table
        # vector_search_provider(vs: VectorSearch) -> pa.Table (top-k rows)
        self.scan = scan_provider
        self.vector_search = vector_search_provider

    def execute(self, plan: LogicalPlan) -> pa.Table:
        return self._execute_node(plan)

    def _execute_node(self, plan: LogicalPlan) -> pa.Table:
        if isinstance(plan, TableScan):
            return self.scan(plan)
        if isinstance(plan, VectorSearch):
            if self.vector_search is not None:
                return self.vector_search(plan)
            return self.scan(plan.scan)  # no provider: full scan, Sort ranks it
        if isinstance(plan, Filter):
            t = self.execute(plan.input)
            mask = eval_expr(self._materialize_subqueries(plan.predicate), t)
            if isinstance(mask, pa.Scalar):
                return t if mask.as_py() else t.schema.empty_table()
            return t.filter(mask)
        if isinstance(plan, Project):
            t = self.execute(plan.input)
            return self._project(plan.exprs, t)
        if isinstance(plan, Join):
            return self._join(plan)
        if isinstance(plan, SubqueryAlias):
            return self.execute(plan.input)
        if isinstance(plan, Window):
            return self._window(plan)
        if isinstance(plan, Distinct):
            t = self.execute(plan.input)
            if t.num_rows == 0 or t.num_columns == 0:
                return t
            return t.group_by(t.column_names, use_threads=False).aggregate([])
        if isinstance(plan, Union):
            return self._union(plan)
        if isinstance(plan, Aggregate):
            t = self.execute(plan.input)
            return self._aggregate(plan, t)
        if isinstance(plan, Having):
            t = self.execute(plan.input)
            pred = self._materialize_subqueries(plan.predicate)
            mask = eval_expr(_rewrite_agg_refs(pred, t), t)
            return t.filter(mask)
        if isinstance(plan, RangeSelect):
            t = self.execute(plan.input)
            return _range_select(plan, t)
        if isinstance(plan, Sort):
            t = self.execute(plan.input)
            return self._sort(plan, t)
        if isinstance(plan, Limit):
            t = self.execute(plan.input)
            return t.slice(plan.offset, plan.limit)
        raise ExecutionError(f"unknown plan node: {plan!r}")

    # ---- helpers ----------------------------------------------------------
    def _project(self, exprs: list[Expr], t: pa.Table) -> pa.Table:
        cols, names = [], []
        for e in exprs:
            if isinstance(e, Star):
                for name in t.column_names:
                    if name.startswith("__"):
                        continue
                    cols.append(t[name])
                    names.append(name)
                continue
            if isinstance(e, Alias):
                name = e.alias
            elif isinstance(e, Column) and "." in e.column:
                # Qualified reference: the output column is named by the
                # base column, per standard SQL (SELECT c.host -> "host");
                # on collision (c.host, h.host) the qualified name survives.
                name = e.column.rsplit(".", 1)[1]
                if name in names:
                    name = e.column
            else:
                name = e.name()
            e = self._materialize_subqueries(e)
            inner = strip_alias(e)
            # After aggregation the table already holds agg outputs by name.
            if inner.name() in t.column_names:
                cols.append(t[inner.name()])
            elif isinstance(e, Alias) and e.alias in t.column_names:
                cols.append(t[e.alias])
            else:
                # scalar exprs over agg outputs (round(avg(v),1)): the agg is
                # already a column of the aggregated table — reference it
                v = eval_expr(_rewrite_agg_refs(inner, t), t)
                if isinstance(v, pa.Scalar):
                    v = pa.array([v.as_py()] * t.num_rows)
                cols.append(v)
            names.append(name)
        return pa.table(dict(zip(names, cols))) if names else t

    def _aggregate(self, plan: Aggregate, t: pa.Table) -> pa.Table:
        group_names = []
        work = t
        # Materialize group key expressions as columns.
        for ge in plan.group_exprs:
            name = ge.name()
            inner = strip_alias(ge)
            if isinstance(inner, Column):
                name = resolve_column(inner.column, work.column_names) or inner.column
            else:
                arr = eval_expr(inner, work)
                if isinstance(arr, pa.Scalar):
                    arr = pa.array([arr.as_py()] * work.num_rows)
                work = work.append_column(name, arr)
            group_names.append(name)

        # Materialize aggregate argument columns, collect (col, fn, out_name).
        specs: list[tuple[str, str]] = []
        out_names: list[str] = []
        post_divide: list[tuple[str, str, str]] = []
        # Sketch aggregates (hll/uddsketch) have no pyarrow kernel; they are
        # computed per group from row indices after the hash group-by.
        sketch_specs: list[tuple[str, str, tuple, str]] = []  # (argname, fn, params, out)
        for ae in plan.agg_exprs:
            for agg in find_agg_calls(ae):
                out_name = agg.name()
                if out_name in out_names or any(s[3] == out_name for s in sketch_specs):
                    continue
                fn = agg.func
                if fn in _SKETCH_AGGS:
                    argname = f"__sketch_{len(sketch_specs)}"
                    arr = eval_expr(agg.arg, work)
                    if isinstance(arr, pa.Scalar):
                        arr = pa.array([arr.as_py()] * work.num_rows)
                    work = work.append_column(argname, arr)
                    sketch_specs.append((argname, fn, agg.params, out_name))
                    continue
                if fn == "count" and agg.arg is None:
                    if "__one" not in work.column_names:
                        work = work.append_column("__one", pa.array(np.ones(work.num_rows, dtype=np.int64)))
                    # "count" (not "sum") so an empty input yields 0, not null
                    specs.append(("__one", "count"))
                    out_names.append(out_name)
                    continue
                argname = f"__agg_{len(specs)}"
                arr = eval_expr(agg.arg, work)
                if isinstance(arr, pa.Scalar):
                    arr = pa.array([arr.as_py()] * work.num_rows)
                if pa.types.is_dictionary(arr.type):
                    arr = pc.cast(arr, arr.type.value_type)
                work = work.append_column(argname, arr)
                pa_fn = {
                    "sum": "sum", "avg": "mean", "min": "min", "max": "max",
                    "count": "count", "stddev": "stddev", "stddev_pop": "stddev",
                    "var": "variance", "var_pop": "variance",
                    "last_value": "last", "first_value": "first",
                    "approx_percentile_cont": "approximate_median", "percentile": "approximate_median",
                }.get(fn)
                if fn == "count" and agg.distinct:
                    pa_fn = "count_distinct"
                if pa_fn is None:
                    raise PlanError(f"unsupported aggregate: {fn}")
                if fn in ("last_value", "first_value"):
                    if agg.order_by:
                        work = _sorted_by(work, agg.order_by)
                    else:
                        # implicit time order: the device kernel's LAST is
                        # by time index, and the scan's (pk, ts) sort made
                        # the CPU's row-order last the last PK's row
                        # instead — sort by the (single) timestamp column
                        # so both backends agree (reference lastpoint
                        # semantics)
                        ts_cols = [
                            c for c in work.column_names
                            if pa.types.is_timestamp(work[c].type)
                        ]
                        if len(ts_cols) == 1:
                            work = work.take(pc.sort_indices(
                                work, [(ts_cols[0], "ascending")]
                            ))
                if pa_fn in ("stddev", "variance"):
                    # SQL: stddev/var are SAMPLE statistics (n-1), the
                    # _pop variants population — arrow defaults to ddof=0
                    specs.append((argname, pa_fn, 0 if fn.endswith("_pop") else 1))
                else:
                    specs.append((argname, pa_fn))
                out_names.append(out_name)

        if not group_names:
            # Global aggregate (no GROUP BY): aggregate whole table.
            cols = {}
            for spec, out_name in zip(specs, out_names):
                argname, pa_fn = spec[0], spec[1]
                ddof = spec[2] if len(spec) > 2 else None
                cols[out_name] = [_global_agg(work[argname], pa_fn, ddof)]
            for argname, fn, params, out_name in sketch_specs:
                col = work[argname]
                col = col.combine_chunks() if isinstance(col, pa.ChunkedArray) else col
                cols[out_name] = pa.array(
                    [_sketch_of(fn, params, col)], pa.binary()
                )
            return pa.table(cols)

        if sketch_specs:
            assert "__rowidx" not in work.column_names
            work = work.append_column(
                "__rowidx", pa.array(np.arange(work.num_rows, dtype=np.int64))
            )
            specs.append(("__rowidx", "list"))
        gb = work.group_by(group_names, use_threads=False)
        result = gb.aggregate([
            (s[0], s[1], pc.VarianceOptions(ddof=s[2])) if len(s) > 2 else s
            for s in specs
        ])
        # pyarrow names outputs "{col}_{fn}"; rename to our agg names.
        rename = {}
        for spec, out_name in zip(specs, out_names):
            rename[f"{spec[0]}_{spec[1]}"] = out_name
        new_names = [rename.get(n, n) for n in result.column_names]
        result = result.rename_columns(new_names)
        if sketch_specs:
            # Per-row group ids from the group-by's row-index lists: one
            # vectorized scatter instead of per-group Python loops.
            la = result["__rowidx_list"].combine_chunks()
            flat = np.asarray(la.values, dtype=np.int64)
            lengths = np.diff(np.asarray(la.offsets, dtype=np.int64))
            num_groups = len(lengths)
            gids = np.empty(work.num_rows, dtype=np.int64)
            gids[flat] = np.repeat(np.arange(num_groups, dtype=np.int64), lengths)
            for argname, fn, params, out_name in sketch_specs:
                col = work[argname]
                col = col.combine_chunks() if isinstance(col, pa.ChunkedArray) else col
                states = _sketch_grouped(fn, params, col, gids, num_groups, la)
                result = result.append_column(out_name, pa.array(states, pa.binary()))
            result = result.drop_columns(["__rowidx_list"])
        return result

    def _sort(self, plan: Sort, t: pa.Table) -> pa.Table:
        keys = []
        work = t
        nulls_spec = plan.nulls or [None] * len(plan.keys)
        for (e, asc), nulls_first in zip(plan.keys, nulls_spec):
            inner = strip_alias(e)
            name = inner.name() if not isinstance(inner, Column) else inner.column
            if name not in work.column_names:
                # sort keys over aggregate output may reference agg columns
                arr = eval_expr(_rewrite_agg_refs(inner, work), work)
                if isinstance(arr, pa.Scalar):
                    arr = pa.array([arr.as_py()] * work.num_rows)
                work = work.append_column(name, arr)
            # SQL default: NULLS LAST for ASC, NULLS FIRST for DESC
            # (PostgreSQL/DataFusion; the reference inherits it).  Arrow
            # only offers one global null_placement per sort call, so
            # per-key placement rides an auxiliary is-null flag column
            # ordered ahead of its value key.
            want_first = (not asc) if nulls_first is None else nulls_first
            col = work[name]
            if col.null_count:
                flag = pc.is_null(col)
                fname = f"__nulls_{name}"
                if fname not in work.column_names:
                    work = work.append_column(fname, flag)
                # ascending sorts false<true: nulls-last = ascending flag
                keys.append((fname, "descending" if want_first else "ascending"))
            keys.append((name, "ascending" if asc else "descending"))
        idx = pc.sort_indices(work, sort_keys=keys)
        return t.take(idx) if set(t.column_names) == set(work.column_names) else work.take(idx).select(t.column_names)

    # ---- relational operators (joins / windows / set ops) ------------------
    # The reference gets these from DataFusion's physical operators; here
    # they run as Arrow-compute hash joins and numpy window evaluation —
    # deliberately CPU-side (the TPU lowering targets the scan→filter→agg
    # hot shape; joins/windows are dashboard-query garnish, not the
    # billion-row path).

    def _materialize_subqueries(self, e: Expr) -> Expr:
        """Execute uncorrelated subqueries, folding their results into
        literal expressions (scalar -> Literal, IN -> InList, EXISTS ->
        Literal bool)."""
        if not any(isinstance(x, PlannedSubquery) for x in e.walk()):
            return e

        def fn(x):
            if not isinstance(x, PlannedSubquery):
                return x
            sub = self.execute(x.plan)
            if x.kind == "scalar":
                if sub.num_columns != 1:
                    raise PlanError("scalar subquery must return one column")
                if sub.num_rows > 1:
                    raise ExecutionError("scalar subquery returned more than one row")
                v = sub.column(0)[0].as_py() if sub.num_rows == 1 else None
                return Literal(v)
            if x.kind == "in":
                if sub.num_columns != 1:
                    raise PlanError("IN subquery must return one column")
                raw = sub.column(0).to_pylist()
                vals = tuple(v for v in raw if v is not None)
                has_null = len(vals) != len(raw)
                if x.negated and has_null:
                    # SQL 3-valued logic: NOT IN over a set containing NULL
                    # is never TRUE (matches the reference's DataFusion).
                    return Literal(False)
                if not vals:
                    # empty set: IN -> FALSE, NOT IN -> TRUE
                    return Literal(bool(x.negated))
                return InList(x.operand, vals, x.negated)
            # exists
            return Literal((sub.num_rows > 0) != x.negated)

        return map_expr(e, fn)

    def _join(self, plan: Join) -> pa.Table:
        lt = _decode_dicts(self.execute(plan.left))
        rt = _decode_dicts(self.execute(plan.right))
        lcols, rcols = lt.column_names, rt.column_names

        if plan.how == "cross":
            out = _cross_product(lt, rt, plan.left_name, plan.right_name)
            return out

        pairs: list[tuple[str, str]] = []
        residual: list[Expr] = []
        if plan.using:
            for u in plan.using:
                lu, ru = resolve_column(u, lcols), resolve_column(u, rcols)
                if lu is None or ru is None:
                    raise PlanError(f"USING column {u} missing from join input")
                pairs.append((lu, ru))
        elif plan.condition is not None:
            for conj in split_conjuncts(plan.condition):
                pair = _equi_pair(conj, lcols, rcols)
                if pair is not None:
                    pairs.append(pair)
                else:
                    residual.append(conj)
        if not pairs:
            raise PlanError(
                f"{plan.how.upper()} JOIN requires at least one equi-join "
                "condition (col = col across the two sides)"
            )
        if residual and plan.how != "inner":
            raise PlanError(
                "non-equi conditions in OUTER JOIN ON clauses are not supported"
            )

        lkeys = [l for l, _ in pairs]
        rkeys = [r for _, r in pairs]
        # Qualify colliding non-key output columns as "side.column" so
        # qualified references keep working after the join.
        lset, rset = set(lcols), set(rcols)
        collisions = (lset & (rset - set(rkeys))) | (set(rkeys) & (lset - set(lkeys)))
        lren, rren = {}, {}
        for c in sorted(collisions):
            if c in rset and c not in rkeys:
                rren[c] = f"{plan.right_name}.{c}" if plan.right_name else f"right.{c}"
            if c in lset and c not in lkeys:
                lren[c] = f"{plan.left_name}.{c}" if plan.left_name else f"left.{c}"
        if lren:
            lt = lt.rename_columns([lren.get(c, c) for c in lcols])
        if rren:
            rt = rt.rename_columns([rren.get(c, c) for c in rcols])

        # Arrow's hash join rejects null-typed payload columns (all-NULL
        # virtual-table columns like information_schema column_default).
        lt, rt = _cast_null_cols(lt), _cast_null_cols(rt)

        # Arrow coalesces the join-key columns into one output column named
        # by the left key, which breaks side-qualified references: in a
        # LEFT JOIN, `b.k` must be NULL on unmatched rows, not the left
        # value, and with ON a.x = b.y the right column y vanishes.  Keep
        # per-side copies of the key columns under qualified names — they
        # join the output as ordinary payload columns with correct outer-
        # join NULL semantics.  (USING keeps only the coalesced column, per
        # standard SQL.)
        qual_keys = not plan.using
        if qual_keys:
            for lk, rk in zip(lkeys, rkeys):
                if plan.left_name and f"{plan.left_name}.{lk}" not in lt.column_names:
                    lt = lt.append_column(f"{plan.left_name}.{lk}", lt[lk])
                if plan.right_name and f"{plan.right_name}.{rk}" not in rt.column_names:
                    rt = rt.append_column(f"{plan.right_name}.{rk}", rt[rk])

        # Join-key types must agree for the Arrow hash join.
        for lk, rk in zip(lkeys, rkeys):
            if lt[lk].type != rt[rk].type:
                try:
                    rt = rt.set_column(
                        rt.column_names.index(rk), rk, pc.cast(rt[rk], lt[lk].type)
                    )
                except (pa.ArrowInvalid, pa.ArrowNotImplementedError) as exc:
                    raise PlanError(
                        f"join key type mismatch: {lk}:{lt[lk].type} vs {rk}:{rt[rk].type}"
                    ) from exc

        join_type = {
            "inner": "inner",
            "left": "left outer",
            "right": "right outer",
            "full": "full outer",
        }[plan.how]
        out = lt.join(
            rt, keys=lkeys, right_keys=rkeys, join_type=join_type, use_threads=False
        )
        if qual_keys and plan.left_name and plan.right_name:
            # Both sides have qualified key copies: drop the non-standard
            # coalesced column — per SQL, an ON join exposes a.k and b.k
            # separately (unqualified k is then ambiguous, as it should be).
            out = out.drop_columns([lk for lk in dict.fromkeys(lkeys) if lk in out.column_names])
        for conj in residual:
            mask = eval_expr(self._materialize_subqueries(conj), out)
            if isinstance(mask, pa.Scalar):
                if not mask.as_py():
                    out = out.schema.empty_table()
            else:
                out = out.filter(mask)
        return out

    def _window(self, plan: Window) -> pa.Table:
        t = self.execute(plan.input)
        for w in plan.window_exprs:
            name = w.name()
            if name in t.column_names:
                continue
            t = t.append_column(name, _eval_window_call(w, t))
        return t

    def _union(self, plan: Union) -> pa.Table:
        lt = _decode_dicts(self.execute(plan.left))
        rt = _decode_dicts(self.execute(plan.right))
        if lt.num_columns != rt.num_columns:
            raise PlanError(
                f"UNION inputs have {lt.num_columns} vs {rt.num_columns} columns"
            )
        rt = rt.rename_columns(lt.column_names)
        try:
            out = pa.concat_tables([lt, rt], promote_options="permissive")
        except (pa.ArrowInvalid, pa.ArrowTypeError):
            casted = [pc.cast(rt[c], lt[c].type) for c in lt.column_names]
            out = pa.concat_tables(
                [lt, pa.table(dict(zip(lt.column_names, casted)))]
            )
        if not plan.all and out.num_rows and out.num_columns:
            out = out.group_by(out.column_names, use_threads=False).aggregate([])
        return out


def _sorted_by(t: pa.Table, col: str) -> pa.Table:
    return t.take(pc.sort_indices(t, sort_keys=[(col, "ascending")]))


# ---- join / window helpers --------------------------------------------------


def _decode_dicts(t: pa.Table) -> pa.Table:
    """Decode dictionary-encoded columns (the Arrow hash join and concat
    are picky about dictionary key spaces across tables)."""
    for i, f in enumerate(t.schema):
        if pa.types.is_dictionary(f.type):
            t = t.set_column(i, f.name, pc.cast(t[f.name], f.type.value_type))
    return t


def _cast_null_cols(t: pa.Table) -> pa.Table:
    for i, f in enumerate(t.schema):
        if pa.types.is_null(f.type):
            t = t.set_column(i, f.name, pc.cast(t[f.name], pa.string()))
    return t


def _equi_pair(conj: Expr, lcols: list[str], rcols: list[str]):
    """`a.x = b.y` with sides resolving to opposite inputs -> (lname, rname)."""
    if not (isinstance(conj, BinaryOp) and conj.op == "="):
        return None
    if not (isinstance(conj.left, Column) and isinstance(conj.right, Column)):
        return None

    def _try(name, cols):
        try:
            return resolve_column(name, cols)
        except PlanError:
            return None

    a, b = conj.left.column, conj.right.column
    al, ar = _try(a, lcols), _try(a, rcols)
    bl, br = _try(b, lcols), _try(b, rcols)
    # Prefer the unambiguous assignment; when a name resolves on both sides
    # (e.g. `id = id`), fall back to left-for-left, right-for-right.
    if al is not None and br is not None and (ar is None or bl is None):
        return (al, br)
    if ar is not None and bl is not None and (al is None or br is None):
        return (bl, ar)
    if al is not None and br is not None:
        return (al, br)
    return None


def _cross_product(lt: pa.Table, rt: pa.Table, lname, rname) -> pa.Table:
    n, m = lt.num_rows, rt.num_rows
    li = np.repeat(np.arange(n, dtype=np.int64), m)
    ri = np.tile(np.arange(m, dtype=np.int64), n)
    lout = lt.take(li)
    rout = rt.take(ri)
    cols, names = [], []
    common = set(lt.column_names) & set(rt.column_names)
    for c in lt.column_names:
        names.append((f"{lname}.{c}" if lname else f"left.{c}") if c in common else c)
        cols.append(lout[c])
    for c in rt.column_names:
        names.append((f"{rname}.{c}" if rname else f"right.{c}") if c in common else c)
        cols.append(rout[c])
    return pa.table(dict(zip(names, cols)))


_RANKING_WINDOW_FUNCS = {
    "row_number", "rank", "dense_rank", "percent_rank", "cume_dist", "ntile",
}
_WINDOW_AGG_FUNCS = {"sum", "count", "avg", "min", "max", "mean"}


def _eval_window_call(w: WindowCall, t: pa.Table) -> pa.Array:
    """Evaluate one window function over the whole table.

    Default-frame semantics match the reference's DataFusion execution:
    with ORDER BY the frame is RANGE UNBOUNDED PRECEDING..CURRENT ROW
    (peers included); without ORDER BY it is the whole partition."""
    n = t.num_rows
    func = "avg" if w.func == "mean" else w.func
    if n == 0:
        if func in _RANKING_WINDOW_FUNCS or func == "count":
            return pa.array([], type=pa.int64())
        if func in ("avg",):
            return pa.array([], type=pa.float64())
        return pa.array([], type=pa.null())

    # partition ids
    if w.partition_by:
        codes = []
        for pe in w.partition_by:
            arr = eval_expr(pe, t)
            if isinstance(arr, pa.Scalar):
                codes.append(np.zeros(n, dtype=np.int64))
                continue
            arr = arr.combine_chunks() if isinstance(arr, pa.ChunkedArray) else arr
            codes.append(
                np.asarray(
                    pc.rank(arr, sort_keys=[("x", "ascending")], tiebreaker="dense"),
                    dtype=np.int64,
                )
            )
        key = np.stack(codes, axis=1)
        _, pid = np.unique(key, axis=0, return_inverse=True)
    else:
        pid = np.zeros(n, dtype=np.int64)

    # order codes (dense ranks encode both ordering and tie structure)
    ocodes: list[np.ndarray] = []
    for oe, asc in w.order_by:
        arr = eval_expr(oe, t)
        if isinstance(arr, pa.Scalar):
            ocodes.append(np.zeros(n, dtype=np.int64))
            continue
        arr = arr.combine_chunks() if isinstance(arr, pa.ChunkedArray) else arr
        code = np.asarray(
            pc.rank(
                arr,
                sort_keys=[("x", "ascending" if asc else "descending")],
                tiebreaker="dense",
            ),
            dtype=np.int64,
        )
        if not asc:
            # DataFusion/Postgres default: DESC implies NULLS FIRST
            # (pc.rank puts them last); move nulls ahead of every value.
            nulls = np.asarray(pc.is_null(arr))
            if nulls.any():
                code = np.where(nulls, 0, code)
        ocodes.append(code)

    if ocodes:
        idx = np.lexsort((np.arange(n), *reversed(ocodes), pid))
    else:
        idx = np.argsort(pid, kind="stable")
    pid_s = pid[idx]
    new_part = np.empty(n, dtype=bool)
    new_part[0] = True
    new_part[1:] = pid_s[1:] != pid_s[:-1]
    if ocodes:
        new_peer = new_part.copy()
        for c in ocodes:
            cs = c[idx]
            new_peer[1:] |= cs[1:] != cs[:-1]
    else:
        new_peer = new_part.copy()

    rows = np.arange(n, dtype=np.int64)
    part_start = np.maximum.accumulate(np.where(new_part, rows, 0))
    part_sizes = np.diff(np.r_[np.flatnonzero(new_part), n])
    part_size_per_row = np.repeat(part_sizes, part_sizes)
    peer_gid = np.cumsum(new_peer) - 1  # global peer-group id
    peer_last_idx = np.flatnonzero(np.r_[new_peer[1:], True])
    group_end = peer_last_idx[peer_gid]  # last row index of this row's peer group
    pos = rows - part_start

    def _scatter(vals_sorted: np.ndarray, type_=None) -> pa.Array:
        out = np.empty(n, dtype=vals_sorted.dtype)
        out[idx] = vals_sorted
        return pa.array(out, type=type_) if type_ is not None else pa.array(out)

    if func == "row_number":
        return _scatter(pos + 1)
    if func == "rank":
        gs = np.maximum.accumulate(np.where(new_peer, rows, 0))
        return _scatter(gs - part_start + 1)
    if func == "dense_rank":
        dr = np.cumsum(new_peer)
        dr_at_start = np.maximum.accumulate(np.where(new_part, dr, 0))
        return _scatter(dr - dr_at_start + 1)
    if func == "percent_rank":
        gs = np.maximum.accumulate(np.where(new_peer, rows, 0))
        rank = gs - part_start + 1
        denom = np.maximum(part_size_per_row - 1, 1)
        return _scatter(np.where(part_size_per_row == 1, 0.0, (rank - 1) / denom))
    if func == "cume_dist":
        return _scatter((group_end - part_start + 1) / part_size_per_row)
    if func == "ntile":
        if not w.args or not isinstance(w.args[0], Literal):
            raise PlanError("ntile(k) requires a literal bucket count")
        k = int(w.args[0].value)
        if k <= 0:
            raise PlanError("ntile bucket count must be positive")
        size, p = part_size_per_row, pos
        base, rem = size // k, size % k
        cut = rem * (base + 1)
        bucket = np.where(
            p < cut,
            p // np.maximum(base + 1, 1),
            np.where(base > 0, rem + (p - cut) // np.maximum(base, 1), p),
        )
        return _scatter(np.minimum(bucket, k - 1) + 1)

    # value-bearing functions need the argument column in sorted order
    def _sorted_arg(i=0) -> pa.Array:
        if len(w.args) <= i:
            raise PlanError(f"{func} requires an argument")
        arr = eval_expr(w.args[i], t)
        if isinstance(arr, pa.Scalar):
            arr = pa.array([arr.as_py()] * n)
        arr = arr.combine_chunks() if isinstance(arr, pa.ChunkedArray) else arr
        return arr.take(pa.array(idx))

    inv = np.empty(n, dtype=np.int64)
    inv[idx] = rows  # original position -> sorted position

    if func in ("lag", "lead"):
        offset = 1
        default = None
        if len(w.args) >= 2:
            if not isinstance(w.args[1], Literal):
                raise PlanError(f"{func} offset must be a literal")
            offset = int(w.args[1].value)
        if len(w.args) >= 3:
            if not isinstance(w.args[2], Literal):
                raise PlanError(f"{func} default must be a literal")
            default = w.args[2].value
        vals_s = _sorted_arg()
        shift = -offset if func == "lag" else offset
        target = rows + shift
        part_end = part_start + part_size_per_row - 1
        valid = (target >= part_start) & (target <= part_end)
        take_idx = pa.array(np.where(valid, target, 0), mask=~valid)
        out_s = vals_s.take(take_idx)
        if default is not None:
            # fill only out-of-partition positions — a real NULL at the
            # shifted position must stay NULL (SQL lag/lead semantics)
            out_s = pc.if_else(pa.array(valid), out_s, pa.scalar(default))
        return out_s.take(pa.array(inv))

    if func == "first_value":
        vals_s = _sorted_arg()
        return vals_s.take(pa.array(part_start)).take(pa.array(inv))
    if func == "last_value":
        vals_s = _sorted_arg()
        return vals_s.take(pa.array(group_end)).take(pa.array(inv))
    if func == "nth_value":
        if len(w.args) < 2 or not isinstance(w.args[1], Literal):
            raise PlanError("nth_value(x, k) requires a literal k")
        k = int(w.args[1].value)
        vals_s = _sorted_arg()
        target = part_start + k - 1
        valid = (k >= 1) & (target <= part_start + part_size_per_row - 1)
        take_idx = pa.array(np.where(valid, target, 0), mask=~valid)
        return vals_s.take(take_idx).take(pa.array(inv))

    if func in _WINDOW_AGG_FUNCS:
        if func == "count" and not w.args:
            if ocodes:
                out_s = group_end - part_start + 1
            else:
                out_s = part_size_per_row
            return _scatter(out_s.astype(np.int64))
        vals_s = _sorted_arg()
        arg_type = vals_s.type
        null_mask = np.asarray(pc.is_null(vals_s))
        v = np.asarray(pc.cast(pc.fill_null(vals_s, 0), pa.float64()), dtype=np.float64)
        v = np.where(null_mask, np.nan, v)
        starts = np.flatnonzero(new_part)
        bounds = np.r_[starts, n]
        out = np.empty(n, dtype=np.float64)
        cnt = np.empty(n, dtype=np.int64)
        for s, e in zip(bounds[:-1], bounds[1:]):
            seg = v[s:e]
            seg_valid = ~np.isnan(seg)
            ge_local = group_end[s:e] - s
            run_cnt = np.cumsum(seg_valid)
            if ocodes:
                if func == "count":
                    acc = run_cnt.astype(np.float64)
                elif func in ("sum", "avg"):
                    acc = np.nancumsum(seg)
                elif func == "min":
                    acc = np.fmin.accumulate(seg)
                else:  # max
                    acc = np.fmax.accumulate(seg)
                out[s:e] = acc[ge_local]
                cnt[s:e] = run_cnt[ge_local]
            else:
                total_cnt = int(seg_valid.sum())
                cnt[s:e] = total_cnt
                if func == "count":
                    out[s:e] = total_cnt
                elif total_cnt == 0:
                    out[s:e] = np.nan
                elif func in ("sum", "avg"):
                    out[s:e] = np.nansum(seg)  # avg divides by cnt below
                elif func == "min":
                    out[s:e] = np.nanmin(seg)
                else:
                    out[s:e] = np.nanmax(seg)
        if func == "count":
            return _scatter(out.astype(np.int64))
        if func == "avg":
            with np.errstate(invalid="ignore", divide="ignore"):
                out = np.where(cnt > 0, out / np.maximum(cnt, 1), np.nan)
        else:
            # aggregate over an empty (all-null) frame is NULL
            out = np.where(cnt > 0, out, np.nan)
        res = np.empty(n, dtype=np.float64)
        res[idx] = out
        mask = np.isnan(res)
        if func in ("sum", "min", "max") and pa.types.is_integer(arg_type) and not mask.any():
            return pa.array(res.astype(np.int64))
        return pa.array(res, mask=mask)

    raise PlanError(f"unsupported window function: {func}")


# ---- RANGE ... ALIGN execution ---------------------------------------------


def _ts_to_ms(arr: pa.Array) -> np.ndarray:
    """Timestamp/int array -> epoch-ms int64 numpy array."""
    if pa.types.is_timestamp(arr.type):
        unit = arr.type.unit
        raw = np.asarray(pc.fill_null(pc.cast(arr, pa.int64()), 0), dtype=np.int64)
        if unit == "s":
            return raw * 1000
        if unit == "ms":
            return raw
        if unit == "us":
            return raw // 1000
        return raw // 1_000_000
    return np.asarray(pc.fill_null(pc.cast(arr, pa.int64()), 0), dtype=np.int64)


def _range_select(plan: RangeSelect, t: pa.Table) -> pa.Table:
    """Execute the RangeSelect node.

    Mirrors the reference's semantics (query/src/range_select/plan.rs:939):
    a row at `ts` feeds every aligned slot `align_ts <= ts < align_ts+range`;
    output rows are the union of touched (series, align_ts) keys; FILL
    materializes each series' missing slots between its first and last key.
    """
    n = t.num_rows
    ts_arr = t[plan.ts_col]
    ts_arr = ts_arr.combine_chunks() if isinstance(ts_arr, pa.ChunkedArray) else ts_arr
    ts_ms = _ts_to_ms(ts_arr)
    align, origin = plan.align_ms, plan.origin_ms

    # --- series codes from BY expressions
    by_names, by_arrays = [], []
    for e in plan.by_exprs:
        inner = strip_alias(e)
        arr = eval_expr(inner, t)
        if isinstance(arr, pa.Scalar):
            arr = pa.array([arr.as_py()] * n)
        if isinstance(arr, pa.ChunkedArray):
            arr = arr.combine_chunks()
        by_names.append(e.name() if not isinstance(inner, Column) else inner.column)
        by_arrays.append(arr)
    code = np.zeros(n, dtype=np.int64)
    for arr in by_arrays:
        d = pc.dictionary_encode(arr)
        card = len(d.dictionary) + 1
        idx = np.asarray(pc.fill_null(pc.cast(d.indices, pa.int64()), card - 1), dtype=np.int64)
        code = code * card + idx
    if by_arrays:
        _, code = np.unique(code, return_inverse=True)

    def _empty_result() -> pa.Table:
        cols = {
            plan.ts_col: pa.array(
                [], ts_arr.type if pa.types.is_timestamp(ts_arr.type) else pa.timestamp("ms")
            )
        }
        for name, arr in zip(by_names, by_arrays):
            cols[name] = pa.array([], arr.type)
        for agg in plan.aggs:
            cols[agg.name()] = pa.array([], pa.float64())
        return pa.table(cols)

    if n == 0:
        return _empty_result()

    # --- contributions per distinct range duration
    ranges = sorted({a.range_ms for a in plan.aggs})
    contrib_ts, contrib_row = {}, {}
    for r in ranges:
        n_slots = max(-(-r // align), 1)
        base = (ts_ms - origin) // align * align + origin
        parts_ts, parts_row = [], []
        for j in range(n_slots):
            tj = base - j * align
            valid = tj + r > ts_ms
            parts_ts.append(tj[valid])
            parts_row.append(np.nonzero(valid)[0])
        contrib_ts[r] = np.concatenate(parts_ts) if parts_ts else np.zeros(0, np.int64)
        contrib_row[r] = np.concatenate(parts_row) if parts_row else np.zeros(0, np.int64)

    all_ts = np.concatenate([contrib_ts[r] for r in ranges])
    all_row = np.concatenate([contrib_row[r] for r in ranges])
    if len(all_ts) == 0:
        # no row falls inside any sampled window (range < align)
        return _empty_result()
    all_code = code[all_row]
    ts_lo = int(all_ts.min())
    span = int((all_ts.max() - ts_lo) // align) + 1
    combined = all_code * span + (all_ts - ts_lo) // align
    keys, inv = np.unique(combined, return_inverse=True)
    n_groups = len(keys)
    g_code = keys // span
    g_ts = (keys % span) * align + ts_lo

    # exemplar input row per group (for decoding BY values)
    exemplar = np.full(n_groups, n - 1, dtype=np.int64)
    np.minimum.at(exemplar, inv, all_row)

    slices, off = {}, 0
    for r in ranges:
        ln = len(contrib_ts[r])
        slices[r] = (off, off + ln)
        off += ln

    arg_cache: dict[str, tuple[np.ndarray, np.ndarray]] = {}

    def _arg_values(agg: AggCall):
        key = agg.arg.name()
        if key not in arg_cache:
            arr = eval_expr(agg.arg, t)
            if isinstance(arr, pa.Scalar):
                arr = pa.array([arr.as_py()] * n)
            if isinstance(arr, pa.ChunkedArray):
                arr = arr.combine_chunks()
            if pa.types.is_dictionary(arr.type):
                arr = pc.cast(arr, arr.type.value_type)
            nulls = np.asarray(pc.is_null(arr))
            vals = np.asarray(pc.fill_null(pc.cast(arr, pa.float64()), 0.0), dtype=np.float64)
            arg_cache[key] = (vals, ~nulls)
        return arg_cache[key]

    agg_cols: dict[str, pa.Array] = {}
    for agg in plan.aggs:
        s, e = slices[agg.range_ms]
        gid, rows = inv[s:e], all_row[s:e]
        fn = agg.func
        if fn == "count" and agg.arg is None:
            cnt = np.bincount(gid, minlength=n_groups)
            agg_cols[agg.name()] = pa.array(cnt.astype(np.int64))
            continue
        vals, valid = _arg_values(agg)
        v_r, ok = vals[rows], valid[rows]
        gid_v, v_v = gid[ok], v_r[ok]
        cnt = np.bincount(gid_v, minlength=n_groups).astype(np.float64)
        present = cnt > 0
        if fn == "count":
            agg_cols[agg.name()] = pa.array(cnt.astype(np.int64))
            continue
        if fn in ("sum", "avg", "mean", "stddev", "stddev_pop", "var", "var_pop"):
            ssum = np.bincount(gid_v, weights=v_v, minlength=n_groups)
            if fn == "sum":
                out = ssum
            elif fn in ("avg", "mean"):
                out = np.divide(ssum, cnt, out=np.zeros_like(ssum), where=present)
            else:
                sq = np.bincount(gid_v, weights=v_v * v_v, minlength=n_groups)
                mean = np.divide(ssum, cnt, out=np.zeros_like(ssum), where=present)
                pop_var = np.maximum(
                    np.divide(sq, cnt, out=np.zeros_like(sq), where=present) - mean * mean, 0.0
                )
                if fn in ("var_pop", "stddev_pop"):
                    out = pop_var
                else:  # sample variance, n-1 denominator (SQL default)
                    denom = np.maximum(cnt - 1, 1)
                    out = pop_var * cnt / denom
                if fn.startswith("stddev"):
                    out = np.sqrt(out)
        elif fn == "min":
            out = np.full(n_groups, np.inf)
            np.minimum.at(out, gid_v, v_v)
        elif fn == "max":
            out = np.full(n_groups, -np.inf)
            np.maximum.at(out, gid_v, v_v)
        elif fn in ("first_value", "last_value"):
            order = np.argsort(ts_ms[rows][ok], kind="stable")
            if fn == "first_value":
                order = order[::-1]
            out = np.zeros(n_groups)
            out[gid_v[order]] = v_v[order]  # later assignment wins
        else:
            raise PlanError(f"unsupported RANGE aggregate: {fn}")
        agg_cols[agg.name()] = pc.if_else(
            pa.array(present), pa.array(out, pa.float64()), pa.scalar(None, pa.float64())
        )

    # --- FILL: expand each series to its full align grid
    need_fill = any(a.fill is not None for a in plan.aggs)
    if need_fill and n_groups:
        order = np.lexsort((g_ts, g_code))
        g_code, g_ts, exemplar = g_code[order], g_ts[order], exemplar[order]
        for k in agg_cols:
            agg_cols[k] = agg_cols[k].take(pa.array(order))
        out_code, out_ts, src_idx = [], [], []
        series, starts = np.unique(g_code, return_index=True)
        bounds = list(starts) + [len(g_code)]
        for si, sc in enumerate(series):
            lo, hi = bounds[si], bounds[si + 1]
            t0, t1 = g_ts[lo], g_ts[hi - 1]
            grid = np.arange(t0, t1 + 1, align)
            out_code.append(np.full(len(grid), sc))
            out_ts.append(grid)
            pos = np.full(len(grid), -1, dtype=np.int64)
            pos[(g_ts[lo:hi] - t0) // align] = np.arange(lo, hi)
            src_idx.append(pos)
        out_code = np.concatenate(out_code)
        out_ts = np.concatenate(out_ts)
        src_idx = np.concatenate(src_idx)
        have = src_idx >= 0
        # exemplar per output row = any exemplar of that series
        series_ex = {int(c): int(exemplar[starts[i]]) for i, c in enumerate(series)}
        out_ex = np.array([series_ex[int(c)] for c in out_code], dtype=np.int64)
        new_cols = {}
        for agg in plan.aggs:
            name = agg.name()
            col = np.asarray(pc.fill_null(agg_cols[name].cast(pa.float64()), np.nan), dtype=np.float64)
            full = np.full(len(out_ts), np.nan)
            full[have] = col[np.maximum(src_idx, 0)][have]
            filled = _apply_fill(full, out_code, agg.fill)
            new_cols[name] = pa.array(filled, pa.float64())
            mask = np.isnan(filled)
            if mask.any():
                new_cols[name] = pc.if_else(pa.array(~mask), new_cols[name], pa.scalar(None, pa.float64()))
        agg_cols = new_cols
        g_ts, exemplar = out_ts, out_ex

    # --- assemble output
    cols: dict[str, object] = {}
    ts_out = pa.array(g_ts, pa.timestamp("ms"))
    if pa.types.is_timestamp(ts_arr.type) and ts_arr.type != ts_out.type:
        ts_out = ts_out.cast(ts_arr.type, safe=False)
    elif not pa.types.is_timestamp(ts_arr.type):
        ts_out = pa.array(g_ts // max(plan.ts_unit_ms, 1), pa.int64())
    cols[plan.ts_col] = ts_out
    take_idx = pa.array(exemplar)
    for name, arr in zip(by_names, by_arrays):
        cols[name] = arr.take(take_idx)
    for agg in plan.aggs:
        cols[agg.name()] = agg_cols[agg.name()]
    return pa.table(cols)


def _apply_fill(vals: np.ndarray, series_code: np.ndarray, fill) -> np.ndarray:
    """Apply a FILL policy along each series (vals NaN = missing)."""
    if fill is None or fill == "null":
        return vals
    out = vals.copy()
    for sc in np.unique(series_code):
        m = series_code == sc
        v = out[m]
        nan = np.isnan(v)
        if not nan.any():
            continue
        if fill == "prev":
            idx = np.where(~nan, np.arange(len(v)), -1)
            np.maximum.accumulate(idx, out=idx)
            v = np.where(idx >= 0, v[np.maximum(idx, 0)], np.nan)
        elif fill == "linear":
            known = np.nonzero(~nan)[0]
            if len(known) >= 2:
                interp = np.interp(np.arange(len(v)), known, v[known])
                # only interior gaps get interpolated; edges stay missing
                interior = (np.arange(len(v)) >= known[0]) & (np.arange(len(v)) <= known[-1])
                v = np.where(nan & interior, interp, v)
        else:  # constant
            v = np.where(nan, float(fill), v)
        out[m] = v
    return out


_SKETCH_AGGS = {"hll", "hll_merge", "uddsketch_state", "uddsketch_merge"}


def _sketch_of(fn: str, params: tuple, values: pa.Array) -> bytes:
    raise PlanError(f"{fn}: sketch aggregates are not ported yet")


def _sketch_grouped(fn, params, col, gids, num_groups, *_args):
    raise PlanError(f"{fn}: sketch aggregates are not ported yet")


def _global_agg(col, pa_fn: str, ddof=None):
    col = col.combine_chunks() if isinstance(col, pa.ChunkedArray) else col
    if pa_fn in ("stddev", "variance") and ddof is not None:
        fn = pc.stddev if pa_fn == "stddev" else pc.variance
        return fn(col, ddof=ddof).as_py()
    fn = {
        "sum": pc.sum, "mean": pc.mean, "min": pc.min, "max": pc.max,
        "count": pc.count, "stddev": pc.stddev, "variance": pc.variance,
        "count_distinct": pc.count_distinct,
        "approximate_median": pc.approximate_median,
        "first": lambda c: c[0] if len(c) else pa.scalar(None),
        "last": lambda c: c[-1] if len(c) else pa.scalar(None),
    }[pa_fn]
    return fn(col).as_py()


def _rewrite_agg_refs(e: Expr, t: pa.Table) -> Expr:
    """HAVING predicates reference agg outputs like avg(x) — rewrite those
    AggCall nodes to Columns over the aggregated table."""
    return map_aggs(e, lambda a: Column(a.name()) if a.name() in t.column_names else a)
