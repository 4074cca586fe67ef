"""SQL front door: tokenizer + recursive-descent parser.

Role-equivalent of the reference's forked sqlparser + custom statements
(reference sql/src/parser.rs `ParserContext`, sql/src/statements/): SELECT
with WHERE/GROUP BY/HAVING/ORDER BY/LIMIT, CREATE TABLE with TIME INDEX /
PRIMARY KEY / PARTITION clauses, INSERT VALUES, SHOW/DESCRIBE, EXPLAIN,
TQL EVAL (PromQL-in-SQL, reference statements/tql.rs), ADMIN functions.

No external parser library exists in this environment, so this is a
hand-rolled parser; precedence climbing matches standard SQL.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from ..utils.errors import InvalidSyntaxError
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
    Star,
    Subquery,
    UnaryOp,
    WindowCall,
)

WINDOW_FUNCS = {
    "row_number", "rank", "dense_rank", "ntile",
    "lag", "lead", "first_value", "last_value", "nth_value",
    "cume_dist", "percent_rank",
}

AGG_FUNCS = {
    "sum", "avg", "min", "max", "count", "mean",
    "last_value", "first_value", "stddev", "stddev_pop", "var", "var_pop",
    "approx_percentile_cont", "percentile",
    # approx sketches (reference common/function aggrs: hll, uddsketch)
    "hll", "hll_merge", "uddsketch_state", "uddsketch_merge",
}

# Aggregates whose leading arguments are literal parameters and whose LAST
# argument is the aggregated expression: uddsketch_state(128, 0.01, v).
_PARAM_AGGS = {"uddsketch_state"}

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<comment>--[^\n]*|\/\*.*?\*\/)
  | (?P<number>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?|\d+(?:[eE][+-]?\d+)?)
  | (?P<string>'(?:[^']|'')*')
  | (?P<qident>"(?:[^"]|"")*"|`(?:[^`]|``)*`)
  | (?P<op><=|>=|!=|<>|::|\|\||[-+*/%(),.;=<>\[\]])
  | (?P<ident>[A-Za-z_][A-Za-z0-9_$]*)
    """,
    re.VERBOSE | re.DOTALL,
)


@dataclass
class Token:
    kind: str  # number|string|ident|qident|op|eof
    value: str
    pos: int


def tokenize(sql: str) -> list[Token]:
    tokens: list[Token] = []
    i = 0
    while i < len(sql):
        m = _TOKEN_RE.match(sql, i)
        if not m:
            raise InvalidSyntaxError(f"unexpected character {sql[i]!r} at {i}")
        kind = m.lastgroup
        if kind not in ("ws", "comment"):
            tokens.append(Token(kind, m.group(), i))
        i = m.end()
    tokens.append(Token("eof", "", len(sql)))
    return tokens


# ---- statements ------------------------------------------------------------


@dataclass
class AlignClause:
    """`ALIGN '5s' [TO ...] [BY (...)] [FILL ...]` — the range-query clause
    (reference sql/src/parsers/create_parser.rs range syntax +
    query/src/range_select/plan_rewrite.rs)."""

    align_ms: int
    to: object = 0  # origin: 0 (epoch) | "now" | "calendar" | ms timestamp
    by: list[Expr] | None = None  # None = default (table primary key)
    fill: object = None  # default fill for range aggs without their own


@dataclass
class SelectStmt:
    projections: list[Expr]
    table: str | None = None
    database: str | None = None
    where: Expr | None = None
    group_by: list[Expr] = field(default_factory=list)
    having: Expr | None = None
    order_by: list[tuple[Expr, bool]] = field(default_factory=list)
    # Per-key NULLS FIRST/LAST (parallel to order_by; None = the SQL
    # default, which is NULLS LAST for ASC and NULLS FIRST for DESC —
    # PostgreSQL/DataFusion semantics, reference parity).
    order_nulls: list[bool | None] = field(default_factory=list)
    limit: int | None = None
    offset: int = 0
    align: AlignClause | None = None
    distinct: bool = False
    # Relational surface beyond single-table scans (reference gets these
    # from DataFusion's SQL frontend):
    from_item: object = None  # TableRef | SubqueryRef | JoinItem | None
    ctes: list = field(default_factory=list)  # [(name, SelectStmt)]
    unions: list = field(default_factory=list)  # [(all: bool, SelectStmt)]


@dataclass
class TableRef:
    """FROM db.table [AS alias]"""

    table: str
    database: str | None = None
    alias: str | None = None


@dataclass
class SubqueryRef:
    """FROM (SELECT ...) AS alias"""

    stmt: SelectStmt = None
    alias: str | None = None


@dataclass
class JoinItem:
    left: object = None  # TableRef | SubqueryRef | JoinItem
    right: object = None
    how: str = "inner"  # inner | left | right | full | cross
    on: Expr | None = None
    using: tuple = ()


@dataclass
class ColumnDef:
    name: str
    type_name: str
    nullable: bool = True
    default: object = None
    is_time_index: bool = False
    is_primary_key: bool = False
    fulltext: bool = False
    vector_index: bool = False


@dataclass
class CreateTableStmt:
    name: str
    columns: list[ColumnDef]
    database: str | None = None
    time_index: str | None = None
    primary_key: list[str] = field(default_factory=list)
    if_not_exists: bool = False
    partition_by_hash: tuple[list[str], int] | None = None  # (columns, n)
    partition_on_columns: tuple[list[str], list] | None = None  # (columns, region exprs)
    engine: str = "mito"
    options: dict = field(default_factory=dict)
    external: bool = False  # CREATE EXTERNAL TABLE (file engine)


@dataclass
class CreateDatabaseStmt:
    name: str
    if_not_exists: bool = False


@dataclass
class DropStmt:
    kind: str  # table|database|flow|view
    name: str
    if_exists: bool = False
    database: str | None = None  # DROP TABLE <db>.<table>


@dataclass
class CreateViewStmt:
    """CREATE [OR REPLACE] VIEW name AS <select> (reference
    common/meta/src/ddl/create_view.rs — stored as defining SQL here,
    re-planned per query)."""

    name: str
    sql_text: str  # the defining SELECT, verbatim
    stmt: object = None  # parsed SelectStmt (validation-time artifact)
    or_replace: bool = False
    if_not_exists: bool = False


@dataclass
class CreateFlowStmt:
    """`CREATE FLOW name SINK TO sink [EXPIRE AFTER i] [EVAL INTERVAL i]
    [COMMENT '...'] AS SELECT ...` (reference sql/src/statements/create.rs:596)."""

    name: str
    sink_table: str
    query: "SelectStmt"
    query_sql: str  # raw SELECT text (persisted; batching mode re-plans it)
    if_not_exists: bool = False
    or_replace: bool = False
    expire_after_ms: int | None = None
    eval_interval_ms: int | None = None
    comment: str | None = None


@dataclass
class InsertStmt:
    table: str
    columns: list[str] | None
    rows: list[list[object]]
    database: str | None = None
    # INSERT INTO ... SELECT: the source query (rows is then empty)
    query: "SelectStmt | None" = None


@dataclass
class ShowStmt:
    what: str  # tables|databases|create_table
    target: str | None = None
    like: str | None = None
    database: str | None = None  # SHOW TABLES FROM <db>


@dataclass
class DescribeStmt:
    table: str


@dataclass
class ExplainStmt:
    analyze: bool
    inner: object


@dataclass
class ExplainFlowStmt:
    """`EXPLAIN FLOW <name>`: render the flow's operator graph (mode,
    operators, fallback reason) — the introspection half of the
    incremental-dataflow degradation ladder."""

    name: str


@dataclass
class TqlStmt:
    kind: str  # eval|explain|analyze
    start: float
    end: float
    step: float
    query: str


@dataclass
class AdminStmt:
    func: str
    args: list[object]


@dataclass
class UseStmt:
    database: str


@dataclass
class DeleteStmt:
    table: str
    where: Expr | None


@dataclass
class AlterTableStmt:
    """ALTER TABLE: add/drop/modify columns, rename, set/unset options
    (reference sql/src/statements/alter.rs `AlterTableOperation`)."""

    table: str
    action: str  # add_columns|drop_columns|modify_columns|rename|set_options|unset_options
    add_columns: list[ColumnDef] = field(default_factory=list)
    drop_columns: list[str] = field(default_factory=list)
    modify_columns: list[tuple[str, str]] = field(default_factory=list)  # (name, new type)
    new_name: str | None = None
    options: dict = field(default_factory=dict)
    unset_keys: list[str] = field(default_factory=list)


@dataclass
class TruncateStmt:
    table: str


@dataclass
class CopyStmt:
    """COPY data in/out (reference sql/src/statements/copy.rs +
    operator/src/statement/copy_table_{from,to}.rs, copy_database.rs):
    `COPY tbl TO|FROM 'path' [WITH (format = 'parquet'|'csv'|'json')]`,
    `COPY DATABASE db TO|FROM 'dir' [WITH (...)]`."""

    kind: str  # table|database
    name: str
    direction: str  # to|from
    path: str
    options: dict = field(default_factory=dict)


@dataclass
class SetStmt:
    """`SET k = v` session variable (accepted and recorded; most are client
    bootstrap noise like SET NAMES / search_path — the reference stores them
    on the session, session/src/context.rs)."""

    raw: str


@dataclass
class TransactionStmt:
    """BEGIN/COMMIT/ROLLBACK — accepted as no-ops (the reference's
    storage has no interactive transactions either)."""

    kind: str  # begin|commit|rollback


@dataclass
class DeclareCursorStmt:
    """DECLARE <name> CURSOR FOR <select> (reference
    operator/src/statement/cursor.rs + common/recordbatch cursor.rs)."""

    name: str
    select: object  # SelectStmt | TqlStmt


@dataclass
class FetchCursorStmt:
    """FETCH [n FROM] <name>."""

    name: str
    count: int


@dataclass
class CloseCursorStmt:
    name: str


@dataclass
class KillStmt:
    """KILL [QUERY] <process_id> (reference catalog process_manager kill)."""

    process_id: int


class Parser:
    def __init__(self, sql: str):
        self.tokens = tokenize(sql)
        self.i = 0
        self.sql = sql

    # ---- token helpers ----------------------------------------------------
    def peek(self) -> Token:
        return self.tokens[self.i]

    def next(self) -> Token:
        t = self.tokens[self.i]
        self.i += 1
        return t

    def at_kw(self, *kws: str) -> bool:
        t = self.peek()
        return t.kind == "ident" and t.value.lower() in kws

    def eat_kw(self, *kws: str) -> bool:
        if self.at_kw(*kws):
            self.next()
            return True
        return False

    def expect_kw(self, kw: str):
        if not self.eat_kw(kw):
            raise InvalidSyntaxError(f"expected {kw.upper()} near {self.peek().value!r}")

    def at_op(self, op: str) -> bool:
        t = self.peek()
        return t.kind == "op" and t.value == op

    def eat_op(self, op: str) -> bool:
        if self.at_op(op):
            self.next()
            return True
        return False

    def expect_op(self, op: str):
        if not self.eat_op(op):
            raise InvalidSyntaxError(f"expected {op!r} near {self.peek().value!r} in {self.sql!r}")

    def ident(self) -> str:
        t = self.next()
        if t.kind == "ident":
            return t.value
        if t.kind == "qident":
            q = t.value[0]
            return t.value[1:-1].replace(q + q, q)
        raise InvalidSyntaxError(f"expected identifier, got {t.value!r}")

    # ---- entry ------------------------------------------------------------
    def parse_statement(self):
        if self.at_kw("select"):
            return self.parse_select_query()
        if self.at_kw("with"):
            return self.parse_select_query()
        if self.at_kw("create"):
            return self.parse_create()
        if self.at_kw("drop"):
            return self.parse_drop()
        if self.at_kw("insert"):
            return self.parse_insert()
        if self.at_kw("show"):
            return self.parse_show()
        if self.at_kw("describe", "desc"):
            self.next()
            if self.eat_kw("table"):
                pass
            return DescribeStmt(self.ident())
        if self.at_kw("explain"):
            self.next()
            if self.eat_kw("flow"):
                return ExplainFlowStmt(self.ident())
            analyze = self.eat_kw("analyze")
            return ExplainStmt(analyze, self.parse_statement())
        if self.at_kw("tql"):
            return self.parse_tql()
        if self.at_kw("admin"):
            self.next()
            func = self.ident()
            args = []
            if self.eat_op("("):
                while not self.at_op(")"):
                    args.append(self.parse_literal_value())
                    if not self.eat_op(","):
                        break
                self.expect_op(")")
            return AdminStmt(func, args)
        if self.at_kw("use"):
            self.next()
            return UseStmt(self.ident())
        if self.at_kw("delete"):
            self.next()
            self.expect_kw("from")
            table = self.ident()
            where = None
            if self.eat_kw("where"):
                where = self.parse_expr()
            return DeleteStmt(table, where)
        if self.at_kw("alter"):
            return self.parse_alter()
        if self.at_kw("truncate"):
            self.next()
            self.eat_kw("table")
            return TruncateStmt(self.ident())
        if self.at_kw("set"):
            # swallow everything up to the statement boundary
            start = self.peek().pos
            while not (self.peek().kind == "eof" or self.at_op(";")):
                self.next()
            return SetStmt(self.sql[start : self.peek().pos].strip())
        if self.at_kw("begin", "commit", "rollback"):
            kind = self.next().value.lower()
            while not (self.peek().kind == "eof" or self.at_op(";")):
                self.next()  # BEGIN WORK / ROLLBACK TO SAVEPOINT ...
            return TransactionStmt(kind)
        if self.at_kw("start"):
            self.next()
            self.expect_kw("transaction")
            return TransactionStmt("begin")
        if self.at_kw("copy"):
            return self.parse_copy()
        if self.at_kw("declare"):
            self.next()
            name = self.ident()
            self.expect_kw("cursor")
            self.expect_kw("for")
            inner = self.parse_statement()
            if not isinstance(inner, (SelectStmt, TqlStmt)):
                raise InvalidSyntaxError("DECLARE CURSOR requires a SELECT or TQL query")
            return DeclareCursorStmt(name, inner)
        if self.at_kw("fetch"):
            # FETCH [NEXT | ALL | FORWARD [n | ALL] | n] [FROM] <name>
            self.next()
            count = 1
            if self.eat_kw("forward"):
                if self.eat_kw("all"):
                    count = -1
                elif self.peek().kind == "number":
                    count = int(float(self.next().value))
            elif self.eat_kw("next"):
                count = 1
            elif self.eat_kw("all"):
                count = -1
            elif self.peek().kind == "number":
                count = int(float(self.next().value))
            self.eat_kw("from")
            return FetchCursorStmt(self.ident(), count)
        if self.at_kw("close"):
            self.next()
            return CloseCursorStmt(self.ident())
        if self.at_kw("kill"):
            self.next()
            self.eat_kw("query")
            tok = self.next()
            raw = tok.value
            if tok.kind == "string":
                raw = raw.strip("'\"")
            # process_list renders ids as "<addr>/<pid>" — accept that form
            if "/" in raw:
                raw = raw.rsplit("/", 1)[1]
            try:
                pid = int(float(raw))
            except ValueError:
                raise InvalidSyntaxError(
                    f"KILL expects a process id (e.g. 3 or 'addr/3'), got {tok.value!r}"
                ) from None
            return KillStmt(pid)
        raise InvalidSyntaxError(f"unsupported statement: {self.peek().value!r}")

    def parse_copy(self) -> CopyStmt:
        self.expect_kw("copy")
        kind = "database" if self.eat_kw("database") else "table"
        if kind == "table":
            self.eat_kw("table")
        name = self.ident()
        if self.eat_kw("to"):
            direction = "to"
        else:
            self.expect_kw("from")
            direction = "from"
        t = self.next()
        if t.kind != "string":
            raise InvalidSyntaxError("COPY requires a quoted path")
        path = t.value[1:-1].replace("''", "'")
        options: dict = {}
        if self.eat_kw("with"):
            self.expect_op("(")
            while not self.at_op(")"):
                k = self.parse_option_key()
                self.expect_op("=")
                options[k.lower()] = self.parse_literal_value()
                if not self.eat_op(","):
                    break
            self.expect_op(")")
        return CopyStmt(kind, name, direction, path, options)

    # ---- ALTER ------------------------------------------------------------
    def parse_alter(self) -> AlterTableStmt:
        self.expect_kw("alter")
        self.expect_kw("table")
        stmt = AlterTableStmt(table=self.ident(), action="")
        if self.at_kw("add"):
            stmt.action = "add_columns"
            while self.eat_kw("add"):
                self.eat_kw("column")
                stmt.add_columns.append(self.parse_column_def())
                if not self.eat_op(","):
                    break
            return stmt
        if self.at_kw("drop"):
            stmt.action = "drop_columns"
            while self.eat_kw("drop"):
                self.eat_kw("column")
                stmt.drop_columns.append(self.ident())
                if not self.eat_op(","):
                    break
            return stmt
        if self.eat_kw("modify"):
            stmt.action = "modify_columns"
            while True:
                self.eat_kw("column")
                name = self.ident()
                stmt.modify_columns.append((name, self.parse_type_name()))
                if not (self.eat_op(",") and self.eat_kw("modify")):
                    break
            return stmt
        if self.eat_kw("rename"):
            stmt.action = "rename"
            self.eat_kw("to")
            stmt.new_name = self.ident()
            return stmt
        if self.eat_kw("set"):
            stmt.action = "set_options"
            while True:
                k = self.parse_option_key()
                self.expect_op("=")
                stmt.options[k] = self.parse_literal_value()
                if not self.eat_op(","):
                    break
            return stmt
        if self.eat_kw("unset"):
            stmt.action = "unset_options"
            while True:
                stmt.unset_keys.append(self.parse_option_key())
                if not self.eat_op(","):
                    break
            return stmt
        raise InvalidSyntaxError(
            f"unsupported ALTER TABLE action near {self.peek().value!r}"
        )

    def parse_option_key(self) -> str:
        t = self.peek()
        if t.kind == "string":
            self.next()
            return t.value[1:-1].replace("''", "'")
        return self.ident()

    # ---- SELECT -----------------------------------------------------------
    def parse_select_query(self) -> SelectStmt:
        """Full query: [WITH ctes] select [UNION [ALL] select]*"""
        ctes: list = []
        if self.eat_kw("with"):
            while True:
                name = self.ident()
                self.expect_kw("as")
                self.expect_op("(")
                ctes.append((name, self.parse_select_query()))
                self.expect_op(")")
                if not self.eat_op(","):
                    break
        stmt = self.parse_select()
        stmt.ctes = ctes
        while self.at_kw("union"):
            self.next()
            all_ = self.eat_kw("all")
            self.eat_kw("distinct")
            stmt.unions.append((all_, self.parse_select()))
        return stmt

    def parse_select(self) -> SelectStmt:
        self.expect_kw("select")
        distinct = False
        if self.eat_kw("distinct"):
            distinct = True
        self.eat_kw("all")
        projections = [self.parse_projection()]
        while self.eat_op(","):
            projections.append(self.parse_projection())
        stmt = SelectStmt(projections=projections, distinct=distinct)
        if self.eat_kw("from"):
            stmt.from_item = self.parse_from_item()
            if isinstance(stmt.from_item, TableRef):
                # Keep the single-table fast path fields populated (the TPU
                # lowering and protocol servers read stmt.table directly).
                stmt.table = stmt.from_item.table
                stmt.database = stmt.from_item.database
        if self.eat_kw("where"):
            stmt.where = self.parse_expr()
        if self.at_kw("align"):
            stmt.align = self.parse_align()
        if self.eat_kw("group"):
            self.expect_kw("by")
            stmt.group_by.append(self.parse_expr())
            while self.eat_op(","):
                stmt.group_by.append(self.parse_expr())
        if self.eat_kw("having"):
            stmt.having = self.parse_expr()
        if self.eat_kw("order"):
            self.expect_kw("by")
            while True:
                e = self.parse_expr()
                asc = True
                if self.eat_kw("desc"):
                    asc = False
                elif self.eat_kw("asc"):
                    pass
                nulls: bool | None = None
                if self.eat_kw("nulls"):
                    if self.eat_kw("first"):
                        nulls = True
                    else:
                        self.expect_kw("last")
                        nulls = False
                stmt.order_by.append((e, asc))
                stmt.order_nulls.append(nulls)
                if not self.eat_op(","):
                    break
        if self.eat_kw("limit"):
            stmt.limit = int(self.next().value)
        if self.eat_kw("offset"):
            stmt.offset = int(self.next().value)
        return stmt

    _FROM_STOP_KWS = (
        "join", "inner", "left", "right", "full", "outer", "cross", "on",
        "using", "where", "group", "having", "order", "limit", "offset",
        "align", "union", "natural",
    )

    def parse_from_item(self):
        left = self.parse_from_primary()
        while True:
            how = None
            if self.at_kw("join"):
                how = "inner"
            elif self.at_kw("inner"):
                self.next()
                how = "inner"
            elif self.at_kw("left"):
                self.next()
                self.eat_kw("outer")
                how = "left"
            elif self.at_kw("right"):
                self.next()
                self.eat_kw("outer")
                how = "right"
            elif self.at_kw("full"):
                self.next()
                self.eat_kw("outer")
                how = "full"
            elif self.at_kw("cross"):
                self.next()
                how = "cross"
            elif self.at_op(","):
                # comma join = cross join (with WHERE doing the filtering)
                self.next()
                right = self.parse_from_primary()
                left = JoinItem(left, right, "cross")
                continue
            else:
                return left
            self.expect_kw("join")
            right = self.parse_from_primary()
            item = JoinItem(left, right, how)
            if how != "cross":
                if self.eat_kw("on"):
                    item.on = self.parse_expr()
                elif self.eat_kw("using"):
                    self.expect_op("(")
                    cols = [self.ident()]
                    while self.eat_op(","):
                        cols.append(self.ident())
                    self.expect_op(")")
                    item.using = tuple(cols)
                else:
                    raise InvalidSyntaxError(f"{how.upper()} JOIN requires ON or USING")
            left = item

    def parse_from_primary(self):
        if self.at_op("("):
            self.next()
            if self.at_kw("select", "with"):
                sub = self.parse_select_query()
                self.expect_op(")")
                self.eat_kw("as")
                alias = self.ident()
                return SubqueryRef(sub, alias)
            item = self.parse_from_item()
            self.expect_op(")")
            return item
        name = self.ident()
        database = None
        if self.eat_op("."):
            database = name
            name = self.ident()
        alias = None
        if self.eat_kw("as"):
            alias = self.ident()
        elif self.peek().kind in ("ident", "qident") and not self.at_kw(*self._FROM_STOP_KWS):
            alias = self.ident()
        return TableRef(name, database, alias)

    def parse_projection(self) -> Expr:
        if self.at_op("*"):
            self.next()
            return Star()
        e = self.parse_expr()
        if self.eat_kw("as"):
            return Alias(e, self.ident())
        t = self.peek()
        if t.kind in ("ident", "qident") and not self.at_kw(
            "from", "where", "group", "having", "order", "limit", "offset", "as", "and", "or", "asc", "desc", "union",
        ):
            return Alias(e, self.ident())
        return e

    # ---- expressions (precedence climbing) --------------------------------
    def parse_expr(self) -> Expr:
        return self.parse_or()

    def parse_or(self) -> Expr:
        left = self.parse_and()
        while self.eat_kw("or"):
            left = BinaryOp("or", left, self.parse_and())
        return left

    def parse_and(self) -> Expr:
        left = self.parse_not()
        while self.eat_kw("and"):
            left = BinaryOp("and", left, self.parse_not())
        return left

    def parse_not(self) -> Expr:
        if self.eat_kw("not"):
            return UnaryOp("not", self.parse_not())
        return self.parse_comparison()

    def parse_comparison(self) -> Expr:
        left = self.parse_additive()
        t = self.peek()
        if t.kind == "op" and t.value in ("=", "!=", "<>", "<", "<=", ">", ">="):
            self.next()
            op = "!=" if t.value == "<>" else t.value
            return BinaryOp(op, left, self.parse_additive())
        if self.at_kw("between"):
            self.next()
            low = self.parse_additive()
            self.expect_kw("and")
            high = self.parse_additive()
            return Between(left, low, high)
        negated = False
        if self.at_kw("not"):
            save = self.i
            self.next()
            if self.at_kw("in", "like", "ilike", "between"):
                negated = True
            else:
                self.i = save
        if self.eat_kw("in"):
            self.expect_op("(")
            if self.at_kw("select", "with"):
                sub = self.parse_select_query()
                self.expect_op(")")
                return Subquery(sub, "in", operand=left, negated=negated)
            values = []
            while not self.at_op(")"):
                values.append(self.parse_literal_value())
                if not self.eat_op(","):
                    break
            self.expect_op(")")
            return InList(left, tuple(values), negated=negated)
        if self.eat_kw("like"):
            pattern = self.parse_additive()
            e = BinaryOp("like", left, pattern)
            return UnaryOp("not", e) if negated else e
        if self.eat_kw("ilike"):
            pattern = self.parse_additive()
            e = BinaryOp("ilike", left, pattern)
            return UnaryOp("not", e) if negated else e
        if negated and self.eat_kw("between"):
            low = self.parse_additive()
            self.expect_kw("and")
            high = self.parse_additive()
            return Between(left, low, high, negated=True)
        if self.at_kw("is"):
            self.next()
            neg = self.eat_kw("not")
            self.expect_kw("null")
            return IsNull(left, negated=neg)
        return left

    def parse_additive(self) -> Expr:
        left = self.parse_multiplicative()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("+", "-"):
                self.next()
                left = BinaryOp(t.value, left, self.parse_multiplicative())
            else:
                return left

    def parse_multiplicative(self) -> Expr:
        left = self.parse_unary()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("*", "/", "%"):
                self.next()
                left = BinaryOp(t.value, left, self.parse_unary())
            else:
                return left

    def parse_unary(self) -> Expr:
        if self.eat_op("-"):
            e = self.parse_unary()
            if isinstance(e, Literal) and isinstance(e.value, (int, float)):
                return Literal(-e.value)  # fold negative numeric literals
            return UnaryOp("-", e)
        if self.eat_op("+"):
            return self.parse_unary()
        return self.parse_primary()

    def parse_primary(self) -> Expr:
        t = self.peek()
        if t.kind == "number":
            self.next()
            v = float(t.value) if ("." in t.value or "e" in t.value.lower()) else int(t.value)
            return self._maybe_cast(Literal(v))
        if t.kind == "string":
            self.next()
            return self._maybe_cast(Literal(t.value[1:-1].replace("''", "'")))
        if self.at_op("("):
            self.next()
            if self.at_kw("select", "with"):
                sub = self.parse_select_query()
                self.expect_op(")")
                return self._maybe_cast(Subquery(sub, "scalar"))
            e = self.parse_expr()
            self.expect_op(")")
            return self._maybe_cast(e)
        if t.kind in ("ident", "qident"):
            if self.at_kw("exists"):
                save = self.i
                self.next()
                if self.at_op("("):
                    self.next()
                    sub = self.parse_select_query()
                    self.expect_op(")")
                    return Subquery(sub, "exists")
                self.i = save
            if self.at_kw("null"):
                self.next()
                return self._maybe_cast(Literal(None))
            if self.at_kw("true"):
                self.next()
                return self._maybe_cast(Literal(True))
            if self.at_kw("false"):
                self.next()
                return self._maybe_cast(Literal(False))
            if self.at_kw("interval"):
                self.next()
                s = self.next()
                if s.kind != "string":
                    raise InvalidSyntaxError("expected string after INTERVAL")
                return Literal(_parse_interval(s.value[1:-1]))
            if self.at_kw("case"):
                return self.parse_case()
            name = self.ident()
            if self.at_op("("):
                if name.lower() == "cast":
                    # CAST(expr AS TYPE) — standard form alongside `::`
                    save = self.i
                    self.next()
                    inner = self.parse_expr()
                    if self.eat_kw("as"):
                        tname = self.ident().lower()
                        if self.eat_op("("):
                            # precision/dim stays part of the type name:
                            # timestamp(9), vector(3) resolve differently
                            p = self.next().value
                            self.expect_op(")")
                            tname = f"{tname}({p})"
                        self.expect_op(")")
                        return self._maybe_cast(
                            FuncCall("cast", (inner, Literal(tname)))
                        )
                    self.i = save  # a UDF literally named cast(...)
                return self._maybe_cast(self.parse_call(name))
            # Qualified column reference: alias.column (resolved against the
            # join output at execution; see cpu_exec column resolution).
            if self.at_op("."):
                nxt = self.tokens[self.i + 1] if self.i + 1 < len(self.tokens) else None
                after = self.tokens[self.i + 2] if self.i + 2 < len(self.tokens) else None
                if (
                    nxt is not None
                    and nxt.kind in ("ident", "qident")
                    and not (after is not None and after.kind == "op" and after.value == "(")
                ):
                    self.next()
                    name = f"{name}.{self.ident()}"
            return self._maybe_cast(Column(name))
        raise InvalidSyntaxError(f"unexpected token {t.value!r} in expression")

    def _maybe_cast(self, e: Expr) -> Expr:
        while self.eat_op("::"):
            type_name = self.ident()
            e = FuncCall("cast", (e, Literal(type_name.lower())))
        return self._maybe_range(e)

    def _maybe_range(self, e: Expr) -> Expr:
        """Postfix `RANGE '10s' [FILL v]` attaches range/fill to every
        aggregate inside e (reference range expr rewrite,
        query/src/range_select/plan_rewrite.rs)."""
        if not self.at_kw("range"):
            return e
        self.next()
        range_ms = self._interval_token()
        fill = None
        if self.eat_kw("fill"):
            fill = self._parse_fill_value()
        import dataclasses

        from .expr import map_aggs

        hit = 0

        def _attach(a):
            nonlocal hit
            hit += 1
            return dataclasses.replace(a, range_ms=range_ms, fill=fill)

        out = map_aggs(e, _attach)
        if hit == 0:
            raise InvalidSyntaxError(
                f"RANGE must follow an aggregate expression, got {e.name()!r}"
            )
        return out

    def _interval_token(self) -> int:
        t = self.next()
        if t.kind == "string":
            return _parse_interval(t.value[1:-1])
        if t.kind == "number":
            return int(float(t.value) * 1000)  # bare numbers are seconds
        raise InvalidSyntaxError(f"expected duration, got {t.value!r}")

    def _parse_fill_value(self):
        t = self.peek()
        if self.eat_kw("null"):
            return "null"
        if self.eat_kw("prev"):
            return "prev"
        if self.eat_kw("linear"):
            return "linear"
        v = self.parse_literal_value()
        if isinstance(v, str):
            try:
                return float(v)
            except ValueError:
                return v
        return v

    def parse_align(self) -> AlignClause:
        self.expect_kw("align")
        clause = AlignClause(self._interval_token())
        if self.eat_kw("to"):
            t = self.peek()
            if self.at_kw("now"):
                self.next()
                clause.to = "now"
            elif self.at_kw("calendar"):
                self.next()
                clause.to = "calendar"
            elif t.kind == "string":
                self.next()
                import datetime as _dt

                dt = _dt.datetime.fromisoformat(t.value[1:-1].replace(" ", "T"))
                if dt.tzinfo is None:
                    dt = dt.replace(tzinfo=_dt.timezone.utc)
                clause.to = int(dt.timestamp() * 1000)
            elif t.kind == "number":
                self.next()
                clause.to = int(t.value)
        if self.eat_kw("by"):
            self.expect_op("(")
            exprs: list[Expr] = []
            while not self.at_op(")"):
                exprs.append(self.parse_expr())
                if not self.eat_op(","):
                    break
            self.expect_op(")")
            clause.by = exprs
        if self.eat_kw("fill"):
            clause.fill = self._parse_fill_value()
        return clause

    def parse_case(self) -> Expr:
        self.expect_kw("case")
        # simple form: CASE <operand> WHEN <value> THEN ... — desugars to
        # the searched form with `operand = value` conditions
        operand = None if self.at_kw("when") else self.parse_expr()
        branches = []
        default = Literal(None)
        while self.eat_kw("when"):
            cond = self.parse_expr()
            if operand is not None:
                cond = BinaryOp("=", operand, cond)
            self.expect_kw("then")
            val = self.parse_expr()
            branches.append((cond, val))
        if self.eat_kw("else"):
            default = self.parse_expr()
        self.expect_kw("end")
        args: list[Expr] = []
        for c, v in branches:
            args += [c, v]
        args.append(default)
        return FuncCall("case", tuple(args))

    def parse_call(self, name: str) -> Expr:
        self.expect_op("(")
        lname = name.lower()
        # SQL-standard sample-statistic aliases normalize at parse time so
        # every execution path (arrow hash-agg, numpy tile finalize,
        # distributed state merge) sees one canonical name
        lname = {"var_samp": "var", "stddev_samp": "stddev"}.get(lname, lname)
        if lname == "count" and self.at_op("*"):
            self.next()
            self.expect_op(")")
            if self.at_kw("over"):
                return self._parse_over(lname, ())
            return AggCall("count", None)
        distinct = False
        args: list[Expr] = []
        while not self.at_op(")"):
            if self.eat_kw("distinct"):
                distinct = True
            args.append(self.parse_expr())
            if self.at_kw("order"):  # last_value(x ORDER BY ts)
                self.next()
                self.expect_kw("by")
                order_col = self.ident()
                self.eat_kw("desc")
                self.eat_kw("asc")
                self.expect_op(")")
                return AggCall(lname, args[0], order_by=order_col)
            if not self.eat_op(","):
                break
        self.expect_op(")")
        if self.at_kw("over"):
            if distinct:
                raise InvalidSyntaxError(
                    f"DISTINCT is not supported in window function {lname}()"
                )
            return self._parse_over(lname, tuple(args))
        if lname in AGG_FUNCS:
            if lname == "mean":
                lname = "avg"
            if lname in _PARAM_AGGS and len(args) > 1:
                params = []
                for a in args[:-1]:
                    if not isinstance(a, Literal):
                        raise InvalidSyntaxError(
                            f"{lname}: leading arguments must be literals"
                        )
                    params.append(a.value)
                return AggCall(lname, args[-1], params=tuple(params))
            if distinct and lname != "count":
                raise InvalidSyntaxError(f"DISTINCT is only supported in count(), not {lname}()")
            return AggCall(lname, args[0] if args else None, distinct=distinct)
        if distinct:
            raise InvalidSyntaxError(f"DISTINCT is not valid in {lname}()")
        return FuncCall(lname, tuple(args))

    def _parse_over(self, func: str, args: tuple) -> Expr:
        """func(args) OVER ([PARTITION BY ...] [ORDER BY ...])"""
        self.expect_kw("over")
        self.expect_op("(")
        partition_by: list[Expr] = []
        order_by: list[tuple[Expr, bool]] = []
        if self.eat_kw("partition"):
            self.expect_kw("by")
            partition_by.append(self.parse_expr())
            while self.eat_op(","):
                partition_by.append(self.parse_expr())
        if self.eat_kw("order"):
            self.expect_kw("by")
            while True:
                e = self.parse_expr()
                asc = True
                if self.eat_kw("desc"):
                    asc = False
                elif self.eat_kw("asc"):
                    pass
                order_by.append((e, asc))
                if not self.eat_op(","):
                    break
        if self.at_kw("rows", "range", "groups"):
            raise InvalidSyntaxError("window frame specifications are not supported yet")
        self.expect_op(")")
        if func not in WINDOW_FUNCS and func not in AGG_FUNCS:
            raise InvalidSyntaxError(f"{func} is not a window function")
        return WindowCall(func, args, tuple(partition_by), order_by=tuple(order_by))

    def parse_literal_value(self):
        t = self.next()
        if t.kind == "number":
            return float(t.value) if "." in t.value else int(t.value)
        if t.kind == "string":
            return t.value[1:-1].replace("''", "'")
        if t.kind == "ident":
            lv = t.value.lower()
            if lv == "null":
                return None
            if lv == "true":
                return True
            if lv == "false":
                return False
            return t.value
        if t.kind == "op" and t.value == "-":
            v = self.parse_literal_value()
            return -v
        raise InvalidSyntaxError(f"expected literal, got {t.value!r}")

    # ---- CREATE -----------------------------------------------------------
    def parse_create(self):
        self.expect_kw("create")
        or_replace = False
        if self.eat_kw("or"):
            self.expect_kw("replace")
            or_replace = True
        if self.eat_kw("flow"):
            return self.parse_create_flow(or_replace)
        if self.eat_kw("view"):
            ine = self._if_not_exists()
            name = self.ident()
            self.expect_kw("as")
            start = self.peek().pos
            sub = self.parse_select_query()  # validates the definition
            sql_text = self.sql[start : self.peek().pos].strip().rstrip(";").strip()
            return CreateViewStmt(
                name, sql_text, stmt=sub, or_replace=or_replace, if_not_exists=ine
            )
        if or_replace:
            raise InvalidSyntaxError(
                "OR REPLACE is only supported for CREATE FLOW / CREATE VIEW"
            )
        if self.eat_kw("database", "schema"):
            ine = self._if_not_exists()
            return CreateDatabaseStmt(self.ident(), if_not_exists=ine)
        external = self.eat_kw("external")
        self.expect_kw("table")
        ine = self._if_not_exists()
        name = self.ident()
        database = None
        if self.eat_op("."):
            database = name
            name = self.ident()
        stmt = CreateTableStmt(name=name, columns=[], if_not_exists=ine, database=database)
        stmt.external = external
        if not external or self.at_op("("):
            self.expect_op("(")
            while not self.at_op(")"):
                if self.at_kw("time"):
                    self.next()
                    self.expect_kw("index")
                    self.expect_op("(")
                    stmt.time_index = self.ident()
                    self.expect_op(")")
                elif self.at_kw("primary"):
                    self.next()
                    self.expect_kw("key")
                    self.expect_op("(")
                    stmt.primary_key.append(self.ident())
                    while self.eat_op(","):
                        stmt.primary_key.append(self.ident())
                    self.expect_op(")")
                else:
                    stmt.columns.append(self.parse_column_def())
                if not self.eat_op(","):
                    break
            self.expect_op(")")
        # table-level clauses
        while True:
            if self.eat_kw("partition"):
                if self.eat_kw("by"):
                    self.expect_kw("hash")
                    self.expect_op("(")
                    cols = [self.ident()]
                    while self.eat_op(","):
                        cols.append(self.ident())
                    self.expect_op(")")
                    self.expect_kw("partitions")
                    n = int(self.next().value)
                    stmt.partition_by_hash = (cols, n)
                else:
                    # PARTITION ON COLUMNS (c1, c2) (expr, expr, ...)
                    # (reference multi-dimensional partition rule,
                    # partition/src/multi_dim.rs + RFC 2024-02-21)
                    self.expect_kw("on")
                    self.expect_kw("columns")
                    self.expect_op("(")
                    cols = [self.ident()]
                    while self.eat_op(","):
                        cols.append(self.ident())
                    self.expect_op(")")
                    self.expect_op("(")
                    exprs = []
                    while not self.at_op(")"):
                        exprs.append(self.parse_expr())
                        if not self.eat_op(","):
                            break
                    self.expect_op(")")
                    stmt.partition_on_columns = (cols, exprs)
            elif self.eat_kw("engine"):
                self.expect_op("=")
                stmt.engine = self.ident()
            elif self.eat_kw("with"):
                self.expect_op("(")
                while not self.at_op(")"):
                    k = self.ident() if self.peek().kind != "string" else self.next().value[1:-1]
                    self.expect_op("=")
                    stmt.options[k] = self.parse_literal_value()
                    if not self.eat_op(","):
                        break
                self.expect_op(")")
            else:
                break
        return stmt

    def parse_type_name(self) -> str:
        type_parts = [self.ident()]
        if self.at_op("("):  # e.g. TIMESTAMP(3), VARCHAR(255)
            self.next()
            prec = self.next().value
            self.expect_op(")")
            type_parts[0] += f"({prec})"
        if self.at_kw("unsigned"):
            self.next()
            type_parts.append("unsigned")
        return " ".join(type_parts)

    def parse_column_def(self) -> ColumnDef:
        name = self.ident()
        col = ColumnDef(name=name, type_name=self.parse_type_name())
        while True:
            if self.eat_kw("not"):
                self.expect_kw("null")
                col.nullable = False
            elif self.eat_kw("null"):
                col.nullable = True
            elif self.eat_kw("default"):
                col.default = self.parse_literal_value()
            elif self.at_kw("time"):
                self.next()
                self.expect_kw("index")
                col.is_time_index = True
            elif self.at_kw("primary"):
                self.next()
                self.expect_kw("key")
                col.is_primary_key = True
            elif self.eat_kw("fulltext"):
                # `msg STRING FULLTEXT INDEX [WITH (...)]` (reference sql
                # fulltext column option; analyzer options accepted+ignored)
                self.eat_kw("index")
                if self.eat_kw("with"):
                    self.expect_op("(")
                    depth = 1
                    while depth:
                        t = self.next()
                        if t.kind == "op" and t.value == "(":
                            depth += 1
                        elif t.kind == "op" and t.value == ")":
                            depth -= 1
                        elif t.kind == "eof":
                            raise InvalidSyntaxError("unterminated FULLTEXT WITH")
                col.fulltext = True
            elif self.eat_kw("vector"):
                # `emb VECTOR(3) VECTOR INDEX [WITH (...)]` (reference
                # vector index column extension; build options accepted+ignored)
                self.eat_kw("index")
                if self.eat_kw("with"):
                    self.expect_op("(")
                    depth = 1
                    while depth:
                        t = self.next()
                        if t.kind == "op" and t.value == "(":
                            depth += 1
                        elif t.kind == "op" and t.value == ")":
                            depth -= 1
                        elif t.kind == "eof":
                            raise InvalidSyntaxError("unterminated VECTOR INDEX WITH")
                col.vector_index = True
            else:
                break
        return col

    def _if_not_exists(self) -> bool:
        if self.eat_kw("if"):
            self.expect_kw("not")
            self.expect_kw("exists")
            return True
        return False

    # ---- DROP / INSERT / SHOW / TQL --------------------------------------
    def parse_create_flow(self, or_replace: bool) -> CreateFlowStmt:
        ine = self._if_not_exists()
        name = self.ident()
        self.expect_kw("sink")
        self.expect_kw("to")
        sink = self.ident()
        expire_after = eval_interval = comment = None
        while True:
            if self.eat_kw("expire"):
                self.expect_kw("after")
                expire_after = self._interval_value()
            elif self.eat_kw("eval"):
                self.expect_kw("interval")
                eval_interval = self._interval_value()
            elif self.eat_kw("comment"):
                comment = self.next().value.strip("'")
            else:
                break
        self.expect_kw("as")
        start_pos = self.peek().pos
        query = self.parse_select()
        end_pos = self.peek().pos if self.peek().kind != "eof" else len(self.sql)
        raw = self.sql[start_pos:end_pos].strip().rstrip(";").strip()
        return CreateFlowStmt(
            name=name,
            sink_table=sink,
            query=query,
            query_sql=raw,
            if_not_exists=ine,
            or_replace=or_replace,
            expire_after_ms=expire_after,
            eval_interval_ms=eval_interval,
            comment=comment,
        )

    def _interval_value(self) -> int:
        """An interval literal: '1h' (string) or a bare number of seconds."""
        t = self.next()
        if t.kind == "string":
            return _parse_interval(t.value[1:-1])
        return int(float(t.value) * 1000)

    def parse_drop(self):
        self.expect_kw("drop")
        kind = "table"
        if self.eat_kw("database", "schema"):
            kind = "database"
        elif self.eat_kw("flow"):
            kind = "flow"
        elif self.eat_kw("view"):
            kind = "view"
        else:
            self.expect_kw("table")
        if_exists = False
        if self.eat_kw("if"):
            self.expect_kw("exists")
            if_exists = True
        name = self.ident()
        database = None
        if self.eat_op("."):
            database, name = name, self.ident()
        return DropStmt(kind, name, if_exists=if_exists, database=database)

    def parse_insert(self):
        self.expect_kw("insert")
        self.expect_kw("into")
        table = self.ident()
        database = None
        if self.eat_op("."):
            database = table
            table = self.ident()
        columns = None
        if self.eat_op("("):
            columns = [self.ident()]
            while self.eat_op(","):
                columns.append(self.ident())
            self.expect_op(")")
        if self.at_kw("select"):
            # INSERT INTO t [(cols)] SELECT ... — rows come from a query
            return InsertStmt(
                table, columns, [], database=database, query=self.parse_select()
            )
        self.expect_kw("values")
        rows = []
        while True:
            self.expect_op("(")
            row = []
            while not self.at_op(")"):
                row.append(self.parse_literal_value())
                if not self.eat_op(","):
                    break
            self.expect_op(")")
            rows.append(row)
            if not self.eat_op(","):
                break
        return InsertStmt(table, columns, rows, database=database)

    def parse_show(self):
        self.expect_kw("show")
        if self.eat_kw("tables"):
            database = None
            if self.eat_kw("from", "in"):
                database = self.ident()
            like = None
            if self.eat_kw("like"):
                like = self.next().value.strip("'")
            return ShowStmt("tables", like=like, database=database)
        if self.eat_kw("databases", "schemas"):
            return ShowStmt("databases")
        if self.eat_kw("flows"):
            like = None
            if self.eat_kw("like"):
                like = self.next().value.strip("'")
            return ShowStmt("flows", like=like)
        if self.eat_kw("views"):
            like = None
            if self.eat_kw("like"):
                like = self.next().value.strip("'")
            return ShowStmt("views", like=like)
        if self.eat_kw("create"):
            if self.eat_kw("flow"):
                return ShowStmt("create_flow", target=self.ident())
            if self.eat_kw("view"):
                return ShowStmt("create_view", target=self.ident())
            self.expect_kw("table")
            return ShowStmt("create_table", target=self.ident())
        raise InvalidSyntaxError(f"unsupported SHOW near {self.peek().value!r}")

    def parse_tql(self):
        self.expect_kw("tql")
        kind = "eval"
        if self.eat_kw("eval", "evaluate"):
            kind = "eval"
        elif self.eat_kw("explain"):
            kind = "explain"
        elif self.eat_kw("analyze"):
            kind = "analyze"
        self.expect_op("(")
        start = float(self.next().value)
        self.expect_op(",")
        end = float(self.next().value)
        self.expect_op(",")
        step_tok = self.next()
        step = (
            _parse_interval(step_tok.value[1:-1]) / 1000.0
            if step_tok.kind == "string"
            else float(step_tok.value)
        )
        self.expect_op(")")
        # The rest of the statement (to trailing ; or EOF) is raw PromQL.
        start_pos = self.peek().pos
        end_pos = len(self.sql)
        text = self.sql[start_pos:end_pos].strip()
        if text.endswith(";"):
            text = text[:-1].strip()
        self.i = len(self.tokens) - 1  # consume everything
        return TqlStmt(kind, start, end, step, text)


def _parse_interval(s: str) -> int:
    """'5m', '1h', '90 seconds', '1 day' ... -> milliseconds."""
    s = s.strip().lower()
    m = re.fullmatch(r"(\d+(?:\.\d+)?)\s*([a-z]*)", s)
    if not m:
        raise InvalidSyntaxError(f"bad interval: {s!r}")
    n = float(m.group(1))
    unit = m.group(2) or "s"
    mult = {
        "ms": 1, "millisecond": 1, "milliseconds": 1,
        "s": 1000, "sec": 1000, "second": 1000, "seconds": 1000,
        "m": 60_000, "min": 60_000, "minute": 60_000, "minutes": 60_000,
        "h": 3_600_000, "hour": 3_600_000, "hours": 3_600_000,
        "d": 86_400_000, "day": 86_400_000, "days": 86_400_000,
        "w": 604_800_000, "week": 604_800_000, "weeks": 604_800_000,
    }.get(unit)
    if mult is None:
        raise InvalidSyntaxError(f"bad interval unit: {unit!r}")
    return int(n * mult)


_TQL_RE = re.compile(
    r"^\s*tql\s+(eval|evaluate|explain|analyze)\s*\(\s*([^,]+?)\s*,\s*([^,]+?)\s*,\s*([^)]+?)\s*\)\s*(.+?)\s*;?\s*$",
    re.IGNORECASE | re.DOTALL,
)


def parse_sql(sql: str):
    """Parse one or more ;-separated statements.

    TQL statements are matched by regex BEFORE SQL tokenization because
    their tail is raw PromQL (`{label="x"}` is not SQL-tokenizable) —
    the reference's parser special-cases TQL the same way
    (sql/src/parsers/tql_parser.rs).
    """
    m = _TQL_RE.match(sql)
    if m:
        kind = {"evaluate": "eval"}.get(m.group(1).lower(), m.group(1).lower())
        step_raw = m.group(4).strip()
        if step_raw.startswith(("'", '"')):
            step = _parse_interval(step_raw.strip("'\"")) / 1000.0
        else:
            step = float(step_raw)
        return [
            TqlStmt(kind, float(m.group(2)), float(m.group(3)), step, m.group(5).strip())
        ]
    statements = []
    p = Parser(sql)
    while p.peek().kind != "eof":
        statements.append(p.parse_statement())
        while p.eat_op(";"):
            pass
    return statements
