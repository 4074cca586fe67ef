"""Expression AST shared by the SQL planner and both executors.

The role of DataFusion's `Expr` in the reference (reference query crate
planning surface): a small, typed expression tree that the CPU executor
evaluates over Arrow arrays and the TPU planner pattern-matches for
lowering (filters -> mask kernels, time_bucket -> bucket components,
aggregates -> segment reductions).
"""

from __future__ import annotations

from dataclasses import dataclass, field


class Expr:
    def name(self) -> str:
        raise NotImplementedError

    def children(self) -> list["Expr"]:
        return []

    def walk(self):
        yield self
        for c in self.children():
            yield from c.walk()


@dataclass(frozen=True)
class Column(Expr):
    column: str

    def name(self) -> str:
        return self.column


@dataclass(frozen=True)
class Literal(Expr):
    value: object

    def name(self) -> str:
        return repr(self.value)


@dataclass(frozen=True)
class BinaryOp(Expr):
    op: str  # + - * / % = != < <= > >= and or like
    left: Expr
    right: Expr

    def name(self) -> str:
        return f"{self.left.name()} {self.op} {self.right.name()}"

    def children(self) -> list[Expr]:
        return [self.left, self.right]


@dataclass(frozen=True)
class UnaryOp(Expr):
    op: str  # not, -
    operand: Expr

    def name(self) -> str:
        return f"{self.op} {self.operand.name()}"

    def children(self) -> list[Expr]:
        return [self.operand]


@dataclass(frozen=True)
class InList(Expr):
    expr: Expr
    values: tuple
    negated: bool = False

    def name(self) -> str:
        neg = "not in" if self.negated else "in"
        return f"{self.expr.name()} {neg} {self.values}"

    def children(self) -> list[Expr]:
        return [self.expr]


@dataclass(frozen=True)
class Between(Expr):
    expr: Expr
    low: Expr
    high: Expr
    negated: bool = False

    def name(self) -> str:
        return f"{self.expr.name()} between {self.low.name()} and {self.high.name()}"

    def children(self) -> list[Expr]:
        return [self.expr, self.low, self.high]


@dataclass(frozen=True)
class IsNull(Expr):
    expr: Expr
    negated: bool = False

    def name(self) -> str:
        return f"{self.expr.name()} is {'not ' if self.negated else ''}null"

    def children(self) -> list[Expr]:
        return [self.expr]


@dataclass(frozen=True)
class FuncCall(Expr):
    """Scalar function: time_bucket/date_bin/date_trunc, abs, round, ..."""

    func: str
    args: tuple = ()

    def name(self) -> str:
        return f"{self.func}({', '.join(a.name() for a in self.args)})"

    def children(self) -> list[Expr]:
        return list(self.args)


@dataclass(frozen=True)
class AggCall(Expr):
    """Aggregate function: sum/avg/min/max/count/last_value/first_value/
    stddev/p50-p99 (approx).

    `range_ms`/`fill` mark a RANGE-query aggregate (reference
    query/src/range_select/plan.rs: each range expr carries its own
    range duration and fill policy)."""

    func: str
    arg: Expr | None = None  # None = count(*)
    order_by: str | None = None  # for last_value(x ORDER BY ts)
    range_ms: int | None = None  # agg(x) RANGE '10s'
    fill: object = None  # None | "null" | "prev" | "linear" | constant
    params: tuple = ()  # literal leading args, e.g. uddsketch_state(128, 0.01, v)
    distinct: bool = False  # count(DISTINCT x)

    def name(self) -> str:
        inner = self.arg.name() if self.arg is not None else "*"
        if self.distinct:
            inner = f"distinct {inner}"
        if self.params:
            inner = ", ".join([*(str(p) for p in self.params), inner])
        base = f"{self.func}({inner})"
        if self.range_ms is not None:
            base += f" RANGE {self.range_ms}ms"
            if self.fill is not None:
                base += f" FILL {self.fill}"
        return base

    def children(self) -> list[Expr]:
        return [self.arg] if self.arg is not None else []


@dataclass(frozen=True)
class Subquery(Expr):
    """A subquery appearing in an expression (scalar, IN, or EXISTS form).

    The reference gets these from DataFusion's SQL frontend
    (query/src/planner.rs); here the parser emits `Subquery` and the
    planner rewrites it to `PlannedSubquery` carrying a logical plan that
    the executor materializes (uncorrelated subqueries only)."""

    stmt: object  # SelectStmt (kept opaque to avoid a circular import)
    kind: str = "scalar"  # scalar | in | exists
    operand: Expr | None = None  # for `x IN (SELECT ...)`
    negated: bool = False

    def name(self) -> str:
        if self.kind == "exists":
            return f"{'not ' if self.negated else ''}exists(<subquery>)"
        if self.kind == "in":
            neg = "not in" if self.negated else "in"
            return f"{self.operand.name()} {neg} (<subquery>)"
        return "(<subquery>)"

    def children(self) -> list[Expr]:
        return [self.operand] if self.operand is not None else []


@dataclass(frozen=True)
class PlannedSubquery(Expr):
    """Planner output for `Subquery`: holds the subquery's LogicalPlan."""

    plan: object  # LogicalPlan
    kind: str = "scalar"
    operand: Expr | None = None
    negated: bool = False

    def name(self) -> str:
        if self.kind == "exists":
            return f"{'not ' if self.negated else ''}exists(<subquery>)"
        if self.kind == "in":
            neg = "not in" if self.negated else "in"
            return f"{self.operand.name()} {neg} (<subquery>)"
        return "(<subquery>)"

    def children(self) -> list[Expr]:
        return [self.operand] if self.operand is not None else []


@dataclass(frozen=True)
class WindowCall(Expr):
    """Window function: func(args) OVER (PARTITION BY ... ORDER BY ...).

    Default SQL frame semantics (RANGE UNBOUNDED PRECEDING .. CURRENT ROW
    including peers when ORDER BY is present, whole partition otherwise) —
    matching the reference's DataFusion window execution."""

    func: str
    args: tuple = ()
    partition_by: tuple = ()  # tuple[Expr]
    order_by: tuple = ()  # tuple[(Expr, ascending)]

    def name(self) -> str:
        inner = ", ".join(a.name() for a in self.args)
        parts = []
        if self.partition_by:
            parts.append("partition by " + ", ".join(e.name() for e in self.partition_by))
        if self.order_by:
            parts.append(
                "order by "
                + ", ".join(f"{e.name()}{'' if asc else ' desc'}" for e, asc in self.order_by)
            )
        return f"{self.func}({inner}) over ({' '.join(parts)})"

    def children(self) -> list[Expr]:
        return [*self.args, *self.partition_by, *[e for e, _ in self.order_by]]


@dataclass(frozen=True)
class Alias(Expr):
    expr: Expr
    alias: str

    def name(self) -> str:
        return self.alias

    def children(self) -> list[Expr]:
        return [self.expr]


@dataclass(frozen=True)
class Star(Expr):
    def name(self) -> str:
        return "*"


def strip_alias(e: Expr) -> Expr:
    return e.expr if isinstance(e, Alias) else e


def to_sql(e: Expr) -> str:
    """Fully-parenthesized SQL rendering that re-parses to the SAME tree —
    unlike name(), which drops grouping parens (fine for display, wrong for
    round-tripping, e.g. persisted partition expressions)."""
    if isinstance(e, BinaryOp):
        return f"({to_sql(e.left)} {e.op} {to_sql(e.right)})"
    if isinstance(e, UnaryOp):
        return f"({e.op} {to_sql(e.operand)})"
    if isinstance(e, Literal):
        if e.value is None:
            return "NULL"
        if isinstance(e.value, bool):
            return "true" if e.value else "false"
        if isinstance(e.value, str):
            return "'" + e.value.replace("'", "''") + "'"
        return repr(e.value)
    if isinstance(e, Column):
        return e.column
    if isinstance(e, InList):
        vals = ", ".join(to_sql(Literal(v)) for v in e.values)
        return f"({to_sql(e.expr)} {'not in' if e.negated else 'in'} ({vals}))"
    if isinstance(e, Between):
        neg = "not " if e.negated else ""
        return f"({to_sql(e.expr)} {neg}between {to_sql(e.low)} and {to_sql(e.high)})"
    if isinstance(e, IsNull):
        return f"({to_sql(e.expr)} is {'not ' if e.negated else ''}null)"
    if isinstance(e, FuncCall):
        return f"{e.func}({', '.join(to_sql(a) for a in e.args)})"
    raise ValueError(f"cannot render {type(e).__name__} as SQL")


def find_agg_calls(e: Expr) -> list[AggCall]:
    return [x for x in e.walk() if isinstance(x, AggCall)]


def map_aggs(e: Expr, fn) -> Expr:
    """Rebuild an expression with every AggCall replaced by fn(agg)."""
    import dataclasses

    if isinstance(e, AggCall):
        return fn(e)
    if isinstance(e, Alias):
        return Alias(map_aggs(e.expr, fn), e.alias)
    if isinstance(e, BinaryOp):
        return BinaryOp(e.op, map_aggs(e.left, fn), map_aggs(e.right, fn))
    if isinstance(e, UnaryOp):
        return UnaryOp(e.op, map_aggs(e.operand, fn))
    if isinstance(e, FuncCall):
        return FuncCall(e.func, tuple(map_aggs(a, fn) for a in e.args))
    if isinstance(e, Between):
        return Between(
            map_aggs(e.expr, fn), map_aggs(e.low, fn), map_aggs(e.high, fn),
            e.negated,
        )
    if isinstance(e, IsNull):
        return IsNull(map_aggs(e.expr, fn), e.negated)
    if isinstance(e, InList):
        return InList(map_aggs(e.expr, fn), e.values, e.negated)
    return e


def map_expr(e: Expr, fn) -> Expr:
    """Bottom-up rebuild: fn is applied to every node after its children
    have been rebuilt.  fn returns a replacement node (or the node itself)."""
    if isinstance(e, Alias):
        e = Alias(map_expr(e.expr, fn), e.alias)
    elif isinstance(e, BinaryOp):
        e = BinaryOp(e.op, map_expr(e.left, fn), map_expr(e.right, fn))
    elif isinstance(e, UnaryOp):
        e = UnaryOp(e.op, map_expr(e.operand, fn))
    elif isinstance(e, FuncCall):
        e = FuncCall(e.func, tuple(map_expr(a, fn) for a in e.args))
    elif isinstance(e, InList):
        e = InList(map_expr(e.expr, fn), e.values, e.negated)
    elif isinstance(e, Between):
        e = Between(map_expr(e.expr, fn), map_expr(e.low, fn), map_expr(e.high, fn), e.negated)
    elif isinstance(e, IsNull):
        e = IsNull(map_expr(e.expr, fn), e.negated)
    elif isinstance(e, AggCall):
        import dataclasses

        if e.arg is not None:
            e = dataclasses.replace(e, arg=map_expr(e.arg, fn))
    elif isinstance(e, WindowCall):
        e = WindowCall(
            e.func,
            tuple(map_expr(a, fn) for a in e.args),
            tuple(map_expr(p, fn) for p in e.partition_by),
            tuple((map_expr(o, fn), asc) for o, asc in e.order_by),
        )
    elif isinstance(e, (Subquery, PlannedSubquery)):
        if e.operand is not None:
            e = type(e)(
                e.stmt if isinstance(e, Subquery) else e.plan,
                e.kind,
                map_expr(e.operand, fn),
                e.negated,
            )
    return fn(e)


def find_window_calls(e: Expr) -> list["WindowCall"]:
    return [x for x in e.walk() if isinstance(x, WindowCall)]


def find_subqueries(e: Expr) -> list["Subquery"]:
    return [x for x in e.walk() if isinstance(x, Subquery)]


def split_conjuncts(e: Expr | None) -> list[Expr]:
    """Flatten nested ANDs into a conjunct list (for pushdown analysis)."""
    if e is None:
        return []
    if isinstance(e, BinaryOp) and e.op == "and":
        return split_conjuncts(e.left) + split_conjuncts(e.right)
    return [e]
