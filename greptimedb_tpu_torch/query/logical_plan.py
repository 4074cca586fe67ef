"""Logical plan nodes.

The role of DataFusion `LogicalPlan` in the reference: a small relational
algebra the SQL/PromQL planners emit and both executors consume.  The TPU
physical planner pattern-matches Aggregate(Filter(Scan)) shapes (the
reference's dist-planner commutative boundary, see
query/src/dist_plan/analyzer.rs) and lowers them to device kernels;
everything else runs on the CPU executor.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .expr import Expr


class LogicalPlan:
    def children(self) -> list["LogicalPlan"]:
        return []

    def describe(self, indent: int = 0) -> str:
        lines = [" " * indent + repr(self)]
        for c in self.children():
            lines.append(c.describe(indent + 2))
        return "\n".join(lines)


@dataclass(repr=False)
class TableScan(LogicalPlan):
    table: str
    database: str = "public"
    projection: list[str] | None = None
    # pushed-down conjuncts: simple (col op literal) only
    filters: list = field(default_factory=list)
    time_range: tuple[int, int] | None = None  # native time-index unit, [lo, hi)

    def __repr__(self):
        return (
            f"TableScan({self.database}.{self.table}, proj={self.projection}, "
            f"filters={self.filters}, time_range={self.time_range})"
        )


@dataclass(repr=False)
class Filter(LogicalPlan):
    input: LogicalPlan
    predicate: Expr

    def children(self):
        return [self.input]

    def __repr__(self):
        return f"Filter({self.predicate.name()})"


@dataclass(repr=False)
class Project(LogicalPlan):
    input: LogicalPlan
    exprs: list[Expr]

    def children(self):
        return [self.input]

    def __repr__(self):
        return f"Project({[e.name() for e in self.exprs]})"


@dataclass(repr=False)
class Aggregate(LogicalPlan):
    input: LogicalPlan
    group_exprs: list[Expr]
    agg_exprs: list[Expr]  # AggCall or Alias(AggCall)

    def children(self):
        return [self.input]

    def __repr__(self):
        return (
            f"Aggregate(group={[e.name() for e in self.group_exprs]}, "
            f"aggs={[e.name() for e in self.agg_exprs]})"
        )


@dataclass(repr=False)
class RangeSelect(LogicalPlan):
    """Time-bucketed sliding-window aggregation — GreptimeDB's
    `SELECT agg(x) RANGE 'r' ... ALIGN 'a'` (reference
    query/src/range_select/plan.rs:273 `RangeSelect` logical node).

    Semantics (plan.rs:939): a row at time `ts` contributes to every
    aligned slot `t = k*align + to` with `t <= ts < t + range`.
    """

    input: LogicalPlan
    ts_col: str  # time index column name
    ts_unit_ms: int  # native unit of ts col in ms-per-tick
    align_ms: int
    origin_ms: int  # resolved TO origin
    by_exprs: list[Expr]  # series identity (default: primary key)
    aggs: list[Expr]  # AggCall with range_ms set (each may differ)

    def children(self):
        return [self.input]

    def __repr__(self):
        return (
            f"RangeSelect(align={self.align_ms}ms, to={self.origin_ms}, "
            f"by={[e.name() for e in self.by_exprs]}, "
            f"aggs={[a.name() for a in self.aggs]})"
        )


@dataclass(repr=False)
class VectorSearch(LogicalPlan):
    """Top-k nearest-neighbor scan: replaces the TableScan under an
    `ORDER BY vec_*_distance(col, literal) LIMIT k` pattern (reference
    vector index applier, mito2/src/sst/index/vector_index/).  Produces at
    most k rows; the Sort/Limit above re-order the reduced set."""

    scan: TableScan
    column: str
    query: bytes  # f32-le encoded query vector
    metric: str  # cos | l2sq | dot
    k: int
    ascending: bool = True

    def children(self):
        return [self.scan]

    def __repr__(self):
        return f"VectorSearch({self.column}, metric={self.metric}, k={self.k})"


@dataclass(repr=False)
class Sort(LogicalPlan):
    input: LogicalPlan
    keys: list[tuple[Expr, bool]]  # (expr, ascending)
    # per-key NULLS FIRST/LAST (parallel to keys; None = SQL default:
    # NULLS LAST for ASC, NULLS FIRST for DESC — PostgreSQL semantics)
    nulls: list | None = None

    def children(self):
        return [self.input]

    def __repr__(self):
        return f"Sort({[(e.name(), a) for e, a in self.keys]})"


@dataclass(repr=False)
class Limit(LogicalPlan):
    input: LogicalPlan
    limit: int
    offset: int = 0

    def children(self):
        return [self.input]

    def __repr__(self):
        return f"Limit({self.limit}, offset={self.offset})"


@dataclass(repr=False)
class Join(LogicalPlan):
    """Relational join.  The reference gets joins from DataFusion
    (query/src/planner.rs → DataFusion SqlToRel); here the CPU executor
    runs an Arrow hash join (equi conjuncts) with a residual post-filter.

    `left_name`/`right_name` are the user-visible side names (table alias
    or table name) used to qualify colliding output columns."""

    left: LogicalPlan
    right: LogicalPlan
    how: str  # inner | left | right | full | cross
    condition: Expr | None = None  # ON expr
    using: tuple = ()  # USING (c1, c2)
    left_name: str | None = None
    right_name: str | None = None

    def children(self):
        return [self.left, self.right]

    def __repr__(self):
        cond = self.condition.name() if self.condition is not None else list(self.using)
        return f"Join({self.how}, on={cond})"


@dataclass(repr=False)
class SubqueryAlias(LogicalPlan):
    """FROM (SELECT ...) AS alias, or a CTE reference."""

    input: LogicalPlan
    alias: str

    def children(self):
        return [self.input]

    def __repr__(self):
        return f"SubqueryAlias({self.alias})"


@dataclass(repr=False)
class Window(LogicalPlan):
    """Computes window-function columns (one per distinct WindowCall found
    in `exprs`) and appends them to the input, named by WindowCall.name()."""

    input: LogicalPlan
    window_exprs: list[Expr]  # the WindowCalls to materialize

    def children(self):
        return [self.input]

    def __repr__(self):
        return f"Window({[e.name() for e in self.window_exprs]})"


@dataclass(repr=False)
class Distinct(LogicalPlan):
    input: LogicalPlan

    def children(self):
        return [self.input]

    def __repr__(self):
        return "Distinct"


@dataclass(repr=False)
class Union(LogicalPlan):
    left: LogicalPlan
    right: LogicalPlan
    all: bool = False

    def children(self):
        return [self.left, self.right]

    def __repr__(self):
        return f"Union({'all' if self.all else 'distinct'})"


@dataclass(repr=False)
class Having(LogicalPlan):
    """Post-aggregation filter (kept distinct so the TPU lowering can apply
    it host-side after finalize)."""

    input: LogicalPlan
    predicate: Expr

    def children(self):
        return [self.input]

    def __repr__(self):
        return f"Having({self.predicate.name()})"
