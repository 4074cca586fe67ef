"""SQL statement -> logical plan, with scan pushdown analysis.

Role-equivalent of the reference's logical planning + the pushdown half of
its distributed planner (reference query/src/planner.rs and
query/src/dist_plan/analyzer.rs): WHERE conjuncts that are simple
(column op literal) move into the TableScan as pushed filters, time-index
comparisons become the scan's time_range (SST pruning), and the rest stays
in a residual Filter node.
"""

from __future__ import annotations

import datetime

from ..datatypes.schema import Schema, SemanticType
from ..utils.errors import PlanError
from .expr import (
    AggCall,
    Alias,
    Between,
    BinaryOp,
    Column,
    Expr,
    FuncCall,
    InList,
    Literal,
    PlannedSubquery,
    Star,
    Subquery,
    UnaryOp,
    find_agg_calls,
    find_window_calls,
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
    Sort,
    SubqueryAlias,
    TableScan,
    Union,
    Window,
)
from .sql_parser import JoinItem, SelectStmt, SubqueryRef, TableRef


def plan_query(stmt: SelectStmt, schema_provider, database: str = "public", view_provider=None):
    """Full-query planner: CTEs, views, joined/subquery FROM items, UNIONs.

    Returns (plan, schema) where schema is the single base table's schema
    when the query is a plain single-table select (enabling the TPU
    lowering) and an empty Schema otherwise.

    `view_provider(table, database) -> SelectStmt | None` resolves view
    names to their (freshly parsed) defining statements.

    Role-equivalent of DataFusion's SqlToRel in the reference
    (query/src/planner.rs): the relational surface beyond the
    Aggregate(Filter(Scan)) hot shape executes on the CPU backend.
    """
    return _plan_full(stmt, schema_provider, database, {}, view_provider)


def _plan_full(
    stmt: SelectStmt, schema_provider, database: str, outer_ctes: dict, view_provider=None
):
    """plan_query with an inherited CTE scope (inner subqueries and views
    see the outer query's CTEs, per SQL scoping)."""
    cte_plans: dict[str, LogicalPlan] = dict(outer_ctes)
    for name, cstmt in stmt.ctes:
        cte_plans[name] = _plan_full(
            cstmt, schema_provider, database, cte_plans, view_provider
        )[0]

    if not stmt.unions:
        return _plan_branch(stmt, schema_provider, database, cte_plans, view_provider)

    # UNION chain: the parser attaches a trailing ORDER BY/LIMIT to the last
    # branch; per SQL they order the union's output, so hoist them.  Plan
    # from a copy — the parsed statement may be re-executed (cursors,
    # prepared statements), so it must not be mutated.
    import dataclasses as _dc

    branches = [stmt] + [s for _, s in stmt.unions]
    last = branches[-1]
    tail_order, tail_limit, tail_offset = last.order_by, last.limit, last.offset
    tail_nulls = last.order_nulls
    branches[-1] = _dc.replace(last, order_by=[], order_nulls=[], limit=None, offset=0)
    plans = [
        _plan_branch(b, schema_provider, database, cte_plans, view_provider)[0]
        for b in branches
    ]
    plan = plans[0]
    for (all_, _), p in zip(stmt.unions, plans[1:]):
        plan = Union(plan, p, all_)
    if tail_order:
        keys = [(_resolve_order_key(e, stmt.projections), asc) for e, asc in tail_order]
        plan = Sort(plan, keys, nulls=tail_nulls or None)
    if tail_limit is not None or tail_offset:
        plan = Limit(plan, tail_limit, tail_offset)
    return plan, Schema(columns=[])


def _plan_branch(
    stmt: SelectStmt, schema_provider, database: str, cte_plans: dict, view_provider=None
):
    """Plan one SELECT (no unions) resolving CTEs, views, and FROM items."""

    def subplanner(sub: SelectStmt) -> LogicalPlan:
        return _plan_full(sub, schema_provider, database, cte_plans, view_provider)[0]

    def view_stmt_of(item: TableRef):
        if view_provider is None:
            return None
        return view_provider(item.table, item.database or database)

    fi = stmt.from_item
    if fi is None:
        if stmt.table is not None:
            # Synthetic statements (DELETE's key lookup, programmatic
            # SelectStmts) set table without a from_item — keep the
            # single-table pushdown fast path for them.
            schema = schema_provider(stmt.table, stmt.database or database)
            return plan_select(stmt, schema, database, subplanner=subplanner), schema
        return plan_select(stmt, Schema(columns=[]), database, subplanner=subplanner), Schema(columns=[])
    if isinstance(fi, TableRef) and not (fi.database is None and fi.table in cte_plans):
        vstmt = view_stmt_of(fi)
        if vstmt is None:
            schema = schema_provider(fi.table, fi.database or database)
            # Normalize alias-qualified references (m.ts -> ts) so pushdown
            # and the TPU lowering see plain column names; unknown
            # qualifiers are rejected rather than silently bound.
            stmt = _normalize_qualifiers(stmt, {fi.alias or fi.table, fi.table})
            plan = plan_select(stmt, schema, database, subplanner=subplanner)
            return _rewrite_vector_search(plan, schema), schema
        # View as the sole FROM item: plan its (already parsed) definition
        # once — _plan_from would re-resolve and re-parse it.
        _validate_qualifiers(stmt, _from_names(fi))
        source = _plan_view(
            vstmt, fi, schema_provider, database, view_provider
        )
        plan = plan_select(
            stmt, Schema(columns=[]), database, subplanner=subplanner, source=source
        )
        return plan, Schema(columns=[])
    # CTE reference, subquery, or join tree: build the source plan, then
    # run the (pushdown-free) select pipeline on top of it.
    _validate_qualifiers(stmt, _from_names(fi))
    source = _plan_from(fi, schema_provider, database, cte_plans, subplanner, view_provider)
    plan = plan_select(
        stmt, Schema(columns=[]), database, subplanner=subplanner, source=source
    )
    return plan, Schema(columns=[])


# Per-thread stack of views being expanded, for cycle detection: a view
# whose (re)definition references itself — directly or mutually — must fail
# with a clean error, not a RecursionError (the reference rejects cycles at
# plan time via DataFusion's recursive CTE/view checks).
import threading as _threading

_view_stack = _threading.local()


def _plan_view(vstmt, item: TableRef, schema_provider, database, view_provider):
    key = f"{item.database or database}.{item.table}"
    stack = getattr(_view_stack, "keys", None)
    if stack is None:
        stack = _view_stack.keys = []
    if key in stack:
        raise PlanError(
            f"circular view reference: {' -> '.join([*stack, key])}"
        )
    stack.append(key)
    try:
        vplan = _plan_full(
            vstmt, schema_provider, item.database or database, {}, view_provider
        )[0]
    finally:
        stack.pop()
    return SubqueryAlias(vplan, item.alias or item.table)


_VEC_DIST_FUNCS = {"vec_cos_distance", "vec_l2sq_distance", "vec_dot_product"}


def _rewrite_vector_search(plan: LogicalPlan, schema: Schema) -> LogicalPlan:
    """Limit(k) over [Project*] over Sort(vec_distance(col, lit)) over a
    bare TableScan -> swap the scan for a VectorSearch top-k producer.
    The Sort/Limit stay (re-ordering k rows is cheap); correctness is
    unchanged because VectorSearch returns a superset-ordering-stable
    top-(k+offset) of exactly the rows the sort would have ranked first."""
    from .logical_plan import VectorSearch

    if not isinstance(plan, Limit) or plan.limit is None:
        return plan
    k = plan.limit + plan.offset
    node = plan.input
    projects = []
    while isinstance(node, Project):
        projects.append(node)
        node = node.input
    if not isinstance(node, Sort) or len(node.keys) != 1:
        return plan
    key, asc = node.keys[0]
    key = strip_alias(key)
    if not (isinstance(key, FuncCall) and key.func in _VEC_DIST_FUNCS and len(key.args) == 2):
        return plan
    a, b = key.args
    if isinstance(a, Column) and isinstance(b, Literal):
        col, lit = a, b
    elif isinstance(b, Column) and isinstance(a, Literal):
        col, lit = b, a
    else:
        return plan
    if not isinstance(node.input, TableScan):
        return plan  # residual filters or joins: keep the full sort
    cs = schema.column(col.column) if schema.has_column(col.column) else None
    if cs is None or cs.data_type.value != "vector":
        return plan
    from .vector import parse_vector_literal

    try:
        qb = parse_vector_literal(lit.value, cs.vector_dim)
    except Exception:  # noqa: BLE001 — malformed literal: let eval report it
        return plan
    metric = {"vec_cos_distance": "cos", "vec_l2sq_distance": "l2sq", "vec_dot_product": "dot"}[
        key.func
    ]
    vs = VectorSearch(node.input, col.column, qb, metric, k, ascending=asc)
    new_sort = Sort(vs, node.keys, nulls=node.nulls)
    inner: LogicalPlan = new_sort
    for p in reversed(projects):
        inner = Project(inner, p.exprs)
    return Limit(inner, plan.limit, plan.offset)


def _from_names(item) -> set[str]:
    """All side names (aliases and table names) visible in a FROM tree."""
    if isinstance(item, TableRef):
        return {item.table} | ({item.alias} if item.alias else set())
    if isinstance(item, SubqueryRef):
        return {item.alias} if item.alias else set()
    if isinstance(item, JoinItem):
        return _from_names(item.left) | _from_names(item.right)
    return set()


def _iter_stmt_exprs(stmt: SelectStmt):
    for p in stmt.projections:
        if not isinstance(p, Star):
            yield p
    if stmt.where is not None:
        yield stmt.where
    if stmt.having is not None:
        yield stmt.having
    for g in stmt.group_by:
        yield g
    for e, _ in stmt.order_by:
        yield e


def _validate_qualifiers(stmt: SelectStmt, valid: set[str]):
    """Reject column qualifiers that name no table in this branch's FROM —
    a mistyped alias (or an outer reference from a correlated subquery)
    must error, not silently bind to a same-named local column."""
    for e in _iter_stmt_exprs(stmt):
        for x in e.walk():
            if isinstance(x, Column) and "." in x.column:
                q = x.column.rsplit(".", 1)[0]
                if q not in valid:
                    raise PlanError(
                        f"unknown table alias {q!r} in {x.column!r} "
                        "(correlated subqueries are not supported)"
                    )


def _normalize_qualifiers(stmt: SelectStmt, valid: set[str]) -> SelectStmt:
    """Single-table path: rewrite alias.col -> col (validating the alias)."""
    import dataclasses

    def has_qual(e: Expr) -> bool:
        return any(isinstance(x, Column) and "." in x.column for x in e.walk())

    if not any(has_qual(e) for e in _iter_stmt_exprs(stmt)):
        return stmt

    def fix(x: Expr) -> Expr:
        if isinstance(x, Column) and "." in x.column:
            q, base = x.column.rsplit(".", 1)
            if q not in valid:
                raise PlanError(f"unknown table alias {q!r} in {x.column!r}")
            return Column(base)
        return x

    def rw(e: Expr) -> Expr:
        return map_expr(e, fix)

    return dataclasses.replace(
        stmt,
        projections=[p if isinstance(p, Star) else rw(p) for p in stmt.projections],
        where=rw(stmt.where) if stmt.where is not None else None,
        having=rw(stmt.having) if stmt.having is not None else None,
        group_by=[rw(g) for g in stmt.group_by],
        order_by=[(rw(e), asc) for e, asc in stmt.order_by],
    )


def _plan_from(item, schema_provider, database, cte_plans, subplanner, view_provider=None) -> LogicalPlan:
    if isinstance(item, TableRef):
        if item.database is None and item.table in cte_plans:
            return SubqueryAlias(cte_plans[item.table], item.alias or item.table)
        if view_provider is not None:
            vstmt = view_provider(item.table, item.database or database)
            if vstmt is not None:
                # Views are planned in their own scope (no outer CTEs).
                return _plan_view(vstmt, item, schema_provider, database, view_provider)
        scan = TableScan(table=item.table, database=item.database or database)
        # Schema lookup validates the table exists at plan time.
        schema_provider(item.table, item.database or database)
        return SubqueryAlias(scan, item.alias) if item.alias else scan
    if isinstance(item, SubqueryRef):
        return SubqueryAlias(subplanner(item.stmt), item.alias)
    if isinstance(item, JoinItem):
        left = _plan_from(item.left, schema_provider, database, cte_plans, subplanner, view_provider)
        right = _plan_from(item.right, schema_provider, database, cte_plans, subplanner, view_provider)
        return Join(
            left,
            right,
            item.how,
            condition=item.on,
            using=item.using,
            left_name=_side_name(item.left),
            right_name=_side_name(item.right),
        )
    raise PlanError(f"unsupported FROM item: {item!r}")


def _side_name(item) -> str | None:
    if isinstance(item, TableRef):
        return item.alias or item.table
    if isinstance(item, SubqueryRef):
        return item.alias
    return None


def plan_select(
    stmt: SelectStmt,
    schema: Schema,
    database: str = "public",
    subplanner=None,
    source: LogicalPlan | None = None,
) -> LogicalPlan:
    # Rewrite subquery expressions into planned subqueries up front.
    if subplanner is not None:
        stmt = _rewrite_subqueries(stmt, subplanner)

    if stmt.table is None and source is None:
        # SELECT 1, SELECT now() — constant projection over an empty scan.
        return Project(TableScan(table="", database=database), stmt.projections)

    ts_col = schema.time_index.name if schema.time_index else None
    ts_unit_ms = (
        schema.time_index.data_type.timestamp_unit_ns() // 1_000_000
        if schema.time_index
        else 1
    )

    if source is not None:
        # Joined / subquery / CTE source: no static schema, so no pushdown —
        # the WHERE clause stays a residual filter above the source.
        plan: LogicalPlan = source
        for conj in split_conjuncts(stmt.where):
            plan = Filter(plan, conj)
    else:
        pushed: list[tuple[str, str, object]] = []
        time_lo: int | None = None
        time_hi: int | None = None
        residual: list[Expr] = []

        for conj in split_conjuncts(stmt.where):
            simple = _as_simple_filter(conj, schema)
            if simple is None:
                residual.append(conj)
                continue
            name, op, value = simple
            if name == ts_col and op in ("<", "<=", ">", ">=", "="):
                v = _to_native_ts(value, ts_unit_ms)
                if v is None:
                    residual.append(conj)
                    continue
                if op in (">", ">="):
                    lo = v + 1 if op == ">" else v
                    time_lo = lo if time_lo is None else max(time_lo, lo)
                elif op in ("<", "<="):
                    hi = v if op == "<" else v + 1
                    time_hi = hi if time_hi is None else min(time_hi, hi)
                else:  # =
                    time_lo = v if time_lo is None else max(time_lo, v)
                    time_hi = v + 1 if time_hi is None else min(time_hi, v + 1)
                continue
            pushed.append((name, op, value))

        time_range = None
        if time_lo is not None or time_hi is not None:
            time_range = (
                time_lo if time_lo is not None else -(1 << 62),
                time_hi if time_hi is not None else (1 << 62),
            )

        plan = TableScan(
            table=stmt.table,
            database=stmt.database or database,
            filters=pushed,
            time_range=time_range,
        )
        for conj in residual:
            plan = Filter(plan, conj)

    if stmt.align is not None:
        return _plan_range_select(stmt, schema, plan, ts_col, ts_unit_ms)

    window_calls: list[Expr] = []
    seen_windows: set[str] = set()
    for p in stmt.projections:
        if isinstance(p, Star):
            continue
        for w in find_window_calls(p):
            if w.name() not in seen_windows:
                seen_windows.add(w.name())
                window_calls.append(w)

    # Aggregation?
    proj_aggs = [a for p in stmt.projections if not isinstance(p, Star) for a in find_agg_calls(p)]
    if stmt.group_by or proj_aggs:
        if window_calls:
            raise PlanError(
                "window functions over aggregated output are not supported yet; "
                "wrap the aggregation in a subquery"
            )
        group_exprs = [_resolve_positional(g, stmt.projections) for g in stmt.group_by]
        agg_exprs = [p for p in stmt.projections if find_agg_calls(p)]
        # HAVING (and ORDER BY) may reference aggregates absent from the
        # SELECT list — compute them as hidden aggregates; the projection
        # above drops them (the reference gets this from DataFusion's
        # having-expression rewriting).
        seen_aggs = {a.name() for p in agg_exprs for a in find_agg_calls(p)}
        hidden: list[Expr] = []
        for src in [stmt.having, *(e for e, _ in stmt.order_by)]:
            if src is None:
                continue
            for a in find_agg_calls(src):
                if a.name() not in seen_aggs:
                    seen_aggs.add(a.name())
                    hidden.append(a)
        plan = Aggregate(plan, group_exprs, agg_exprs + hidden)
        if stmt.having is not None:
            plan = Having(plan, stmt.having)
        hidden_names = {a.name() for a in hidden}
        order_uses_hidden = any(
            a.name() in hidden_names
            for e, _ in stmt.order_by
            for a in find_agg_calls(_resolve_positional(e, stmt.projections))
        )
        if order_uses_hidden:
            # Sort over the aggregate output (hidden agg columns still
            # present), then project them away.
            keys = [(_resolve_positional(e, stmt.projections), asc) for e, asc in stmt.order_by]
            plan = Sort(plan, keys, nulls=stmt.order_nulls or None)
            plan = Project(plan, stmt.projections)
            if stmt.distinct:
                plan = Distinct(plan)
        else:
            plan = Project(plan, stmt.projections)
            if stmt.distinct:
                plan = Distinct(plan)
            if stmt.order_by:
                # ORDER BY runs over the projected output: positional refs
                # and alias refs become output-column references.
                keys = [(_resolve_order_key(e, stmt.projections), asc) for e, asc in stmt.order_by]
                plan = Sort(plan, keys, nulls=stmt.order_nulls or None)
    else:
        if window_calls:
            plan = Window(plan, window_calls)
        if stmt.distinct:
            # Project -> Distinct -> Sort: distinct runs over the projected
            # output, and ORDER BY keys must resolve against that output.
            if not (len(stmt.projections) == 1 and isinstance(stmt.projections[0], Star)):
                plan = Project(plan, stmt.projections)
            plan = Distinct(plan)
            if stmt.order_by:
                keys = [(_resolve_order_key(e, stmt.projections), asc) for e, asc in stmt.order_by]
                plan = Sort(plan, keys, nulls=stmt.order_nulls or None)
        else:
            if stmt.order_by:
                # Sort below the projection: keys may reference base columns
                # that the SELECT list drops (aliases resolve to their exprs).
                keys = [(_resolve_positional(e, stmt.projections), asc) for e, asc in stmt.order_by]
                plan = Sort(plan, keys, nulls=stmt.order_nulls or None)
            if not (len(stmt.projections) == 1 and isinstance(stmt.projections[0], Star)):
                plan = Project(plan, stmt.projections)

    if stmt.limit is not None or stmt.offset:
        plan = Limit(plan, stmt.limit, stmt.offset)
    return plan


def _rewrite_subqueries(stmt: SelectStmt, subplanner) -> SelectStmt:
    """Replace Subquery exprs in WHERE/HAVING/projections/ORDER BY with
    PlannedSubquery nodes carrying logical plans (uncorrelated only)."""
    import dataclasses

    def rw(e: Expr) -> Expr:
        def fn(x):
            if isinstance(x, Subquery):
                return PlannedSubquery(subplanner(x.stmt), x.kind, x.operand, x.negated)
            return x

        return map_expr(e, fn)

    has_sub = any(
        isinstance(x, Subquery)
        for e in [
            *(p for p in stmt.projections if not isinstance(p, Star)),
            *(x for x in [stmt.where, stmt.having] if x is not None),
            *(e for e, _ in stmt.order_by),
        ]
        for x in e.walk()
    )
    if not has_sub:
        return stmt
    return dataclasses.replace(
        stmt,
        projections=[p if isinstance(p, Star) else rw(p) for p in stmt.projections],
        where=rw(stmt.where) if stmt.where is not None else None,
        having=rw(stmt.having) if stmt.having is not None else None,
        order_by=[(rw(e), asc) for e, asc in stmt.order_by],
    )


def _plan_range_select(
    stmt: SelectStmt, schema: Schema, scan: LogicalPlan, ts_col: str | None, ts_unit_ms: int
) -> LogicalPlan:
    """RANGE query: scan -> RangeSelect -> Project -> Sort/Limit
    (reference query/src/range_select/plan_rewrite.rs)."""
    import dataclasses
    import time as _time

    from .logical_plan import RangeSelect

    if ts_col is None:
        raise PlanError("RANGE query requires a table with a time index")
    if stmt.group_by or stmt.having is not None:
        raise PlanError("RANGE queries use BY (...) instead of GROUP BY/HAVING")
    align = stmt.align

    # Resolve TO origin to epoch ms.  TO NOW anchors window boundaries at the
    # query time itself (NOT floored — flooring would collapse it back to the
    # TO 0 lattice whenever now % align == 0).
    if align.to == "now":
        origin = int(_time.time() * 1000)
    elif align.to == "calendar" or align.to == 0:
        origin = 0
    else:
        origin = int(align.to)

    # BY defaults to the table's primary key (reference plan_rewrite.rs
    # default_by: the time-series identity columns).
    by_exprs = align.by if align.by is not None else [Column(c.name) for c in schema.tag_columns()]

    # Collect range aggregates from projections; apply the clause-level FILL
    # to any agg without its own, and require RANGE on every aggregate.
    aggs: list[Expr] = []
    seen: set[str] = set()

    def _check(agg: AggCall) -> AggCall:
        if agg.range_ms is None:
            raise PlanError(f"aggregate {agg.name()} in a RANGE query needs a RANGE duration")
        if agg.fill is None and align.fill is not None:
            agg = dataclasses.replace(agg, fill=align.fill)
        return agg

    new_projections: list[Expr] = []
    for p in stmt.projections:
        p2 = map_aggs(p, _check)
        new_projections.append(p2)
        for agg in find_agg_calls(p2):
            if agg.name() not in seen:
                seen.add(agg.name())
                aggs.append(agg)
    if not aggs:
        raise PlanError("RANGE query requires at least one aggregate with RANGE")

    plan: LogicalPlan = RangeSelect(
        input=scan,
        ts_col=ts_col,
        ts_unit_ms=ts_unit_ms,
        align_ms=align.align_ms,
        origin_ms=origin,
        by_exprs=by_exprs,
        aggs=aggs,
    )
    if align.to == "now":
        # the origin was frozen at plan time: a plan cache must never reuse
        # this plan (plan_uncacheable() walks for the marker)
        plan._uncacheable = True
    plan = Project(plan, new_projections)
    if stmt.order_by:
        keys = [(_resolve_order_key(e, new_projections), asc) for e, asc in stmt.order_by]
        plan = Sort(plan, keys, nulls=stmt.order_nulls or None)
    else:
        # Deterministic default ordering: by series, then aligned ts
        # (the reference sorts range output the same way for sqlness goldens).
        keys = [(Column(e.name()), True) for e in by_exprs] + [(Column(ts_col), True)]
        present = {p.name() for p in new_projections}
        keys = [(e, a) for e, a in keys if e.column in present]
        if keys:
            plan = Sort(plan, keys, nulls=stmt.order_nulls or None)
    if stmt.limit is not None or stmt.offset:
        plan = Limit(plan, stmt.limit, stmt.offset)
    return plan


def plan_uncacheable(plan: LogicalPlan) -> bool:
    """True when any node froze query-time state at plan time (ALIGN TO
    NOW origins) — such plans must never be served from a plan cache,
    regardless of how deeply (subquery, view, CTE) the node is buried."""
    if getattr(plan, "_uncacheable", False):
        return True
    return any(plan_uncacheable(c) for c in plan.children())


def _resolve_order_key(e: Expr, projections: list[Expr]) -> Expr:
    """ORDER BY key -> a reference to the projected output column."""
    if isinstance(e, Literal) and isinstance(e.value, int):
        i = e.value - 1
        if 0 <= i < len(projections):
            return Column(projections[i].name())
        raise PlanError(f"positional reference {e.value} out of range")
    return e  # Column names (incl. aliases) resolve against the output table


def _resolve_positional(e: Expr, projections: list[Expr]) -> Expr:
    """GROUP BY 1 / ORDER BY 2 -> the corresponding projection expr."""
    if isinstance(e, Literal) and isinstance(e.value, int):
        i = e.value - 1
        if 0 <= i < len(projections):
            return strip_alias(projections[i])
        raise PlanError(f"positional reference {e.value} out of range")
    if isinstance(e, Column):
        # May reference a projection alias.
        for p in projections:
            if isinstance(p, Alias) and p.alias == e.column:
                return p.expr
    return e


def _as_simple_filter(e: Expr, schema: Schema):
    """(col op literal) or col IN (...) -> pushdown triple, else None."""
    from .expr import FuncCall as _FuncCall

    if (
        isinstance(e, _FuncCall)
        and e.func in ("matches", "matches_term")
        and len(e.args) == 2
        and isinstance(e.args[0], Column)
        and isinstance(e.args[1], Literal)
        and schema.has_column(e.args[0].column)
    ):
        op = "match" if e.func == "matches" else "match_term"
        return (e.args[0].column, op, e.args[1].value)
    if isinstance(e, BinaryOp) and e.op in ("=", "!=", "<", "<=", ">", ">="):
        if isinstance(e.left, Column) and isinstance(e.right, Literal) and schema.has_column(e.left.column):
            return (e.left.column, e.op, e.right.value)
        if isinstance(e.right, Column) and isinstance(e.left, Literal) and schema.has_column(e.right.column):
            flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}
            return (e.right.column, flip.get(e.op, e.op), e.left.value)
    if isinstance(e, InList) and isinstance(e.expr, Column) and schema.has_column(e.expr.column):
        if all(not isinstance(v, Expr) for v in e.values):
            return (e.expr.column, "not in" if e.negated else "in", tuple(e.values))
    if isinstance(e, Between) and not e.negated and isinstance(e.expr, Column):
        return None  # handled as two conjuncts by caller? keep residual for now
    return None


def _to_native_ts(value, unit_ms: int):
    """Literal -> native time-index units.  Ints are already native;
    ISO strings are parsed as UTC."""
    if isinstance(value, (int, float)):
        return int(value)
    if isinstance(value, str):
        try:
            dt = datetime.datetime.fromisoformat(value.replace(" ", "T"))
            if dt.tzinfo is None:
                dt = dt.replace(tzinfo=datetime.timezone.utc)
            ms = int(dt.timestamp() * 1000)
            return ms // unit_ms if unit_ms else ms
        except ValueError:
            return None
    return None
