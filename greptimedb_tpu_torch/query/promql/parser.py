"""PromQL parser (hand-rolled recursive descent).

A copy of `greptimedb_tpu/query/promql/parser.py` (pure Python; the port
keeps its own so it never imports the reference package).  Role-equivalent
of the reference's promql-parser dependency feeding `PromPlanner`
(reference query/src/promql/planner.rs:185).  Covers the surface the
engine evaluates: vector/matrix selectors with label matchers, offset,
rate-family and *_over_time functions, aggregation operators with
by/without, scalar+vector binary arithmetic/comparison, and number
literals.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from ...utils.errors import InvalidSyntaxError

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<comment>\#[^\n]*)
  | (?P<duration>\d+(?:ms|[smhdwy])\b)
  | (?P<number>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+|\d+(?:[eE][+-]?\d+)?|0x[0-9a-fA-F]+)
  | (?P<string>'(?:[^'\\]|\\.)*'|"(?:[^"\\]|\\.)*")
  | (?P<op>=~|!~|!=|==|<=|>=|<|>|\+|-|\*|/|%|\^|\(|\)|\{|\}|\[|\]|,|=|:|@)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_:]*)
    """,
    re.VERBOSE,
)

# NOTE: durations like "5m" tokenize as number+ident normally; we re-lex
# number-followed-by-unit inside brackets via _parse_duration.

AGG_OPS = {"sum", "avg", "min", "max", "count", "stddev", "stdvar", "topk", "bottomk", "quantile"}
RANGE_FUNCS = {
    "rate", "increase", "delta", "idelta", "irate",
    "avg_over_time", "sum_over_time", "min_over_time", "max_over_time",
    "count_over_time", "last_over_time", "present_over_time",
    "stddev_over_time", "stdvar_over_time", "quantile_over_time",
    "deriv", "predict_linear", "holt_winters", "resets", "changes",
    "absent_over_time",
}
INSTANT_FUNCS = {
    "abs", "ceil", "floor", "round", "sqrt", "exp", "ln", "log2", "log10",
    "clamp_min", "clamp_max", "clamp", "scalar", "sgn", "timestamp", "absent",
    "histogram_quantile", "sort", "sort_desc",
    "label_replace", "label_join", "vector", "time",
    "minute", "hour", "day_of_month", "day_of_week", "days_in_month",
    "month", "year",
}
SET_OPS = {"and", "or", "unless"}


@dataclass
class Matcher:
    label: str
    op: str  # = != =~ !~
    value: str


@dataclass
class VectorSelector:
    metric: str
    matchers: list[Matcher] = field(default_factory=list)
    offset_ms: int = 0
    at_spec: object = None  # None | float epoch-ms | "start" | "end"


@dataclass
class MatrixSelector:
    vector: VectorSelector
    range_ms: int = 0


@dataclass
class SubqueryExpr:
    """expr[range:step] — re-evaluates `expr` on a sub-step grid and feeds
    the samples to an outer range function (Prometheus subquery)."""

    expr: object
    range_ms: int = 0
    step_ms: int = 0  # 0 = use the outer evaluation step
    offset_ms: int = 0
    at_spec: object = None


@dataclass
class NumberLiteral:
    value: float


@dataclass
class StringLiteral:
    value: str


@dataclass
class FunctionCall:
    func: str
    args: list = field(default_factory=list)


@dataclass
class AggregateExpr:
    op: str
    expr: object
    by: list[str] | None = None  # None = aggregate everything
    without: list[str] | None = None
    param: object = None  # k for topk, q for quantile


@dataclass
class BinaryExpr:
    op: str  # + - * / % ^ == != < <= > >= and or unless
    left: object
    right: object
    bool_modifier: bool = False
    # vector matching (reference PromPlanner vector matching support):
    on: list[str] | None = None  # join on exactly these labels
    ignoring: list[str] | None = None  # join on all labels except these
    group: str | None = None  # "left" | "right" for many-to-one
    include: list[str] = field(default_factory=list)  # extra labels to copy


@dataclass
class ParenExpr:
    expr: object


def _unquote(s: str) -> str:
    body = s[1:-1]
    return re.sub(r"\\(.)", r"\1", body)


class PromParser:
    def __init__(self, text: str):
        self.text = text
        self.tokens = []
        i = 0
        while i < len(text):
            m = _TOKEN_RE.match(text, i)
            if not m:
                raise InvalidSyntaxError(f"promql: bad char {text[i]!r} at {i}")
            if m.lastgroup not in ("ws", "comment"):
                self.tokens.append((m.lastgroup, m.group()))
            i = m.end()
        self.tokens.append(("eof", ""))
        self.i = 0

    def peek(self):
        return self.tokens[self.i]

    def next(self):
        t = self.tokens[self.i]
        self.i += 1
        return t

    def eat(self, kind, value=None) -> bool:
        k, v = self.peek()
        if k == kind and (value is None or v == value):
            self.next()
            return True
        return False

    def expect(self, kind, value=None):
        k, v = self.peek()
        if k != kind or (value is not None and v != value):
            raise InvalidSyntaxError(f"promql: expected {value or kind}, got {v!r}")
        return self.next()

    # precedence: or(15) and/unless(14) == != etc(13) + -(12) * / %(11) ^(10) unary
    def parse(self):
        e = self.parse_expr()
        if self.peek()[0] != "eof":
            raise InvalidSyntaxError(f"promql: trailing input {self.peek()[1]!r}")
        return e

    def parse_expr(self):
        return self.parse_or()

    def _binary_modifiers(self) -> dict:
        """Optional on/ignoring + group_left/group_right after a binary op."""
        mods: dict = {}
        if self.peek() == ("ident", "on"):
            self.next()
            mods["on"] = self._label_list()
        elif self.peek() == ("ident", "ignoring"):
            self.next()
            mods["ignoring"] = self._label_list()
        for side in ("left", "right"):
            if self.peek() == ("ident", f"group_{side}"):
                self.next()
                mods["group"] = side
                if self.peek() == ("op", "("):
                    mods["include"] = self._label_list()
                break
        return mods

    def parse_or(self):
        left = self.parse_and()
        while self.peek() == ("ident", "or"):
            self.next()
            mods = self._binary_modifiers()
            left = BinaryExpr("or", left, self.parse_and(), **mods)
        return left

    def parse_and(self):
        left = self.parse_comparison()
        while self.peek()[0] == "ident" and self.peek()[1] in ("and", "unless"):
            op = self.next()[1]
            mods = self._binary_modifiers()
            left = BinaryExpr(op, left, self.parse_comparison(), **mods)
        return left

    def parse_comparison(self):
        left = self.parse_additive()
        while True:
            k, v = self.peek()
            if k == "op" and v in ("==", "!=", "<", "<=", ">", ">="):
                self.next()
                bool_mod = self.eat("ident", "bool")
                mods = self._binary_modifiers()
                right = self.parse_additive()
                left = BinaryExpr(v, left, right, bool_modifier=bool_mod, **mods)
            else:
                return left

    def parse_additive(self):
        left = self.parse_multiplicative()
        while True:
            k, v = self.peek()
            if k == "op" and v in ("+", "-"):
                self.next()
                mods = self._binary_modifiers()
                left = BinaryExpr(v, left, self.parse_multiplicative(), **mods)
            else:
                return left

    def parse_multiplicative(self):
        left = self.parse_power()
        while True:
            k, v = self.peek()
            if k == "op" and v in ("*", "/", "%"):
                self.next()
                mods = self._binary_modifiers()
                left = BinaryExpr(v, left, self.parse_power(), **mods)
            else:
                return left

    def parse_power(self):
        left = self.parse_unary()
        if self.peek() == ("op", "^"):
            self.next()
            mods = self._binary_modifiers()
            return BinaryExpr("^", left, self.parse_power(), **mods)
        return left

    def parse_unary(self):
        if self.eat("op", "-"):
            return BinaryExpr("*", NumberLiteral(-1.0), self.parse_unary())
        if self.eat("op", "+"):
            return self.parse_unary()
        return self.parse_postfix()

    def parse_postfix(self):
        e = self.parse_primary()
        # range selector / subquery, offset, @ modifier
        while True:
            if self.peek() == ("op", "["):
                self.next()
                rng = self._parse_duration()
                if self.eat("op", ":"):
                    sub_step = 0
                    if self.peek() != ("op", "]"):
                        sub_step = self._parse_duration()
                    self.expect("op", "]")
                    e = SubqueryExpr(e, rng, sub_step)
                    continue
                self.expect("op", "]")
                if isinstance(e, VectorSelector):
                    e = MatrixSelector(e, rng)
                else:
                    raise InvalidSyntaxError(
                        "promql: range on non-selector (use a subquery [range:step])"
                    )
            elif self.peek() == ("ident", "offset"):
                self.next()
                off = self._parse_duration()
                if isinstance(e, VectorSelector):
                    e.offset_ms = off
                elif isinstance(e, MatrixSelector):
                    e.vector.offset_ms = off
                elif isinstance(e, SubqueryExpr):
                    e.offset_ms = off
                else:
                    raise InvalidSyntaxError("promql: offset on non-selector")
            elif self.peek() == ("op", "@"):
                self.next()
                at = self._parse_at()
                if isinstance(e, VectorSelector):
                    e.at_spec = at
                elif isinstance(e, MatrixSelector):
                    e.vector.at_spec = at
                elif isinstance(e, SubqueryExpr):
                    e.at_spec = at
                else:
                    raise InvalidSyntaxError("promql: @ on non-selector")
            else:
                return e

    def _parse_at(self):
        k, v = self.next()
        if k == "number":
            return float(v) * 1000.0  # epoch seconds -> ms
        if k == "ident" and v in ("start", "end"):
            self.expect("op", "(")
            self.expect("op", ")")
            return v
        raise InvalidSyntaxError(f"promql: bad @ modifier {v!r}")

    def parse_primary(self):
        k, v = self.peek()
        if k == "number":
            self.next()
            return NumberLiteral(float(v))
        if k == "string":
            self.next()
            return StringLiteral(_unquote(v))
        if k == "op" and v == "(":
            self.next()
            e = self.parse_expr()
            self.expect("op", ")")
            return ParenExpr(e)
        if k == "op" and v == "{":
            # {__name__="m"} form
            sel = VectorSelector(metric="")
            sel.matchers = self.parse_matchers()
            for m in sel.matchers:
                if m.label == "__name__" and m.op == "=":
                    sel.metric = m.value
            sel.matchers = [m for m in sel.matchers if m.label != "__name__"]
            return sel
        if k == "ident":
            name = v
            self.next()
            lname = name.lower()
            if lname in AGG_OPS:
                return self.parse_aggregate(lname)
            if self.peek() == ("op", "("):
                self.next()
                args = []
                while not self.eat("op", ")"):
                    args.append(self.parse_expr())
                    if not self.eat("op", ","):
                        if self.peek() != ("op", ")"):
                            raise InvalidSyntaxError("promql: expected , or )")
                return FunctionCall(lname, args)
            sel = VectorSelector(metric=name)
            if self.peek() == ("op", "{"):
                sel.matchers = self.parse_matchers()
            return sel
        raise InvalidSyntaxError(f"promql: unexpected {v!r}")

    def parse_matchers(self) -> list[Matcher]:
        self.expect("op", "{")
        out = []
        while not self.eat("op", "}"):
            label = self.expect("ident")[1]
            k, op = self.next()
            if k != "op" or op not in ("=", "!=", "=~", "!~"):
                raise InvalidSyntaxError(f"promql: bad matcher op {op!r}")
            val = self.expect("string")[1]
            out.append(Matcher(label, op, _unquote(val)))
            if not self.eat("op", ","):
                if self.peek() != ("op", "}"):
                    raise InvalidSyntaxError("promql: expected , or }")
        return out

    def parse_aggregate(self, op: str) -> AggregateExpr:
        by = without = None
        if self.peek() == ("ident", "by"):
            self.next()
            by = self._label_list()
        elif self.peek() == ("ident", "without"):
            self.next()
            without = self._label_list()
        self.expect("op", "(")
        param = None
        first = self.parse_expr()
        if self.eat("op", ","):
            param = first
            first = self.parse_expr()
        self.expect("op", ")")
        if by is None and without is None:
            if self.peek() == ("ident", "by"):
                self.next()
                by = self._label_list()
            elif self.peek() == ("ident", "without"):
                self.next()
                without = self._label_list()
        return AggregateExpr(op, first, by=by, without=without, param=param)

    def _label_list(self) -> list[str]:
        self.expect("op", "(")
        out = []
        while not self.eat("op", ")"):
            out.append(self.expect("ident")[1])
            if not self.eat("op", ","):
                if self.peek() != ("op", ")"):
                    raise InvalidSyntaxError("promql: expected , or )")
        return out

    def _parse_duration(self) -> int:
        """Durations appear as duration token or number+ident ("5m")."""
        k, v = self.next()
        if k == "duration":
            return _duration_ms(v)
        if k == "number":
            nk, nv = self.peek()
            if nk == "ident":
                self.next()
                return _duration_ms(v + nv)
            return int(float(v) * 1000)  # bare seconds
        raise InvalidSyntaxError(f"promql: expected duration, got {v!r}")


def _duration_ms(s: str) -> int:
    m = re.fullmatch(r"(\d+(?:\.\d+)?)(ms|s|m|h|d|w|y)", s)
    if not m:
        raise InvalidSyntaxError(f"promql: bad duration {s!r}")
    n = float(m.group(1))
    mult = {
        "ms": 1, "s": 1000, "m": 60_000, "h": 3_600_000,
        "d": 86_400_000, "w": 604_800_000, "y": 31_536_000_000,
    }[m.group(2)]
    return int(n * mult)


def parse_promql(text: str):
    return PromParser(text).parse()
