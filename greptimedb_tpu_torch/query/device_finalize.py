"""Device-side result finalization: HAVING / ORDER BY / LIMIT past the
aggregate.

Counterpart of `greptimedb_tpu/query/device_finalize.py`.  The tile
program (parallel/tile_program.py) finalizes the aggregates into [G]
states; instead of shipping all G groups to the host for the post-plan
to replay, `derive_post_lowering` pattern-matches the post-plan the
device planner collected (device_exec.Lowering.post_ops, outer-first)
and returns a `DevicePost` naming what the program can finalize on the
card:

  * HAVING predicates over lowered aggregate outputs (comparisons against
    numeric literals or another output, BETWEEN, IS [NOT] NULL, combined
    with Kleene and/or/not), evaluated by K13 `having_mask` into the
    survivor mask; the literals ride `having_values` by slot;
  * ORDER BY over group dimensions (tag columns / the time bucket) or
    aggregate outputs, multi-key, with per-key NULLS FIRST/LAST (K7
    `topk_group_select`).  Tag keys ride the value-sorted dictionary
    codes (code order is value order, NULL is the max code), so only the
    SQL-default null placement is consumable for a tag key; aggregate
    keys carry an explicit null bucket and accept either placement;
  * LIMIT/OFFSET — the program ships the first offset + limit groups.

Ties at the limit break by group id ascending, as the host replay's
stable sort over the gid-ordered aggregate table does.  Consumption
stops at the first operator the device cannot take; everything outward
replays on the host over the compact device result.
"""

from __future__ import annotations

from dataclasses import dataclass

from .expr import (
    AggCall,
    Alias,
    Between,
    BinaryOp,
    Column,
    Expr,
    FuncCall,
    IsNull,
    Literal,
    UnaryOp,
    strip_alias,
)
from .logical_plan import Having, Limit, Project, Sort

# mirror of parallel/executor.py COUNT_STAR
_COUNT_STAR = "__count_star"

_FUNC_TO_KERNEL = {
    "sum": "sum",
    "count": "count",
    "min": "min",
    "max": "max",
    "avg": "avg",
    "mean": "avg",
    "last_value": "last",
}

_CMP_OPS = ("=", "!=", "<", "<=", ">", ">=")


@dataclass(frozen=True)
class DeviceFinalizeSpec:
    """Static description of on-device finalization.

    `order` entries are (ref, ascending, nulls_first) where ref is
    ("dim", i) — the i-th group dimension in gid composition order (tags
    in group order, bucket last) — or ("agg", col, kernel_agg).
    `having` is the encoded predicate tree (see `_encode_having`); its
    literals ride the runtime values by slot, not the spec.  `cap` is
    the row capacity of the compact result; with no LIMIT it is a true
    upper bound on non-empty groups, so the compact fetch never
    overflows."""

    order: tuple = ()
    having: object = None
    n_having_values: int = 0
    limit: int | None = None
    offset: int = 0
    cap: int = 0


@dataclass
class DevicePost:
    """Derivation result: the spec fields that come from the post-plan
    and WHICH post_ops indices the device consumed (the host replay skips
    exactly those)."""

    order: tuple = ()
    having: object = None
    having_values: tuple = ()
    limit: int | None = None
    offset: int = 0
    consumed: frozenset = frozenset()


def _build_env(lowering, schema) -> dict[str, tuple] | None:
    """Output-name -> device ref for everything the aggregate produces."""
    group_tags = list(lowering.group_tags)
    env: dict[str, tuple] = {}
    for ge in lowering.group_exprs:
        inner = strip_alias(ge)
        if isinstance(inner, Column) and inner.column in group_tags:
            ref = ("dim", group_tags.index(inner.column))
        elif isinstance(inner, FuncCall) and lowering.bucket is not None:
            ref = ("dim", len(group_tags))  # the bucket dimension
        else:
            return None
        env[ge.name()] = ref
        env[inner.name()] = ref
    for ae in lowering.agg_exprs:
        inner = strip_alias(ae)
        if not isinstance(inner, AggCall):
            return None
        kernel = _FUNC_TO_KERNEL.get(inner.func)
        if kernel is None:
            return None
        col = inner.arg.column if inner.arg is not None else _COUNT_STAR
        ref = ("agg", col, kernel)
        env[ae.name()] = ref
        env[inner.name()] = ref
    return env


def _num_literal(e: Expr):
    if isinstance(e, Literal) and isinstance(e.value, (int, float)) \
            and not isinstance(e.value, bool):
        return float(e.value)
    return None


def _ref_of(e: Expr, env: dict) -> tuple | None:
    inner = strip_alias(e)
    if isinstance(inner, Column):
        return env.get(inner.column)
    return env.get(inner.name())


_SWAP = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "=", "!=": "!="}


def _encode_having(pred: Expr, env: dict, values: list) -> object | None:
    """Predicate -> hashable tree over aggregate refs and literal slots:
    ("cmp", op, ref, slot) | ("cmpref", op, ref, ref) | ("isnull", ref,
    negated) | ("and" | "or", l, r) | ("not", x); None when a node cannot
    be encoded (tag comparisons stay on the host)."""
    if isinstance(pred, BinaryOp) and pred.op in ("and", "or"):
        left = _encode_having(pred.left, env, values)
        if left is None:
            return None
        right = _encode_having(pred.right, env, values)
        if right is None:
            return None
        return (pred.op, left, right)
    if isinstance(pred, UnaryOp) and pred.op == "not":
        x = _encode_having(pred.operand, env, values)
        return None if x is None else ("not", x)
    if isinstance(pred, Between):
        lo = _encode_having(BinaryOp(">=", pred.expr, pred.low), env, values)
        hi = _encode_having(BinaryOp("<=", pred.expr, pred.high), env, values)
        if lo is None or hi is None:
            return None
        both = ("and", lo, hi)
        return ("not", both) if pred.negated else both
    if isinstance(pred, IsNull):
        ref = _ref_of(pred.expr, env)
        if ref is None or ref[0] != "agg":
            return None
        return ("isnull", ref, bool(pred.negated))
    if isinstance(pred, BinaryOp) and pred.op in _CMP_OPS:
        lref, rref = _ref_of(pred.left, env), _ref_of(pred.right, env)
        lval, rval = _num_literal(pred.left), _num_literal(pred.right)
        if lref is not None and lref[0] == "agg" and rval is not None:
            values.append(rval)
            return ("cmp", pred.op, lref, len(values) - 1)
        if rref is not None and rref[0] == "agg" and lval is not None:
            values.append(lval)
            return ("cmp", _SWAP[pred.op], rref, len(values) - 1)
        if lref is not None and rref is not None and lref[0] == "agg" and rref[0] == "agg":
            return ("cmpref", pred.op, lref, rref)
    return None


def derive_post_lowering(lowering, schema) -> DevicePost | None:
    """Walk post_ops innermost-out, consuming what the device program can
    finalize; consumption stops at the first operator it cannot.
    Pass-through Projects are never consumed but extend the name
    environment, so a Sort above `SELECT max(x) AS mu` resolves `mu`."""
    env = _build_env(lowering, schema)
    if env is None:
        return None
    post = DevicePost()
    values: list = []
    sort_taken = False
    limit_taken = False
    for idx in range(len(lowering.post_ops) - 1, -1, -1):
        op = lowering.post_ops[idx]
        if isinstance(op, Project):
            for e in op.exprs:
                ref = _ref_of(e, env)
                if ref is not None:
                    env[e.name()] = ref
                    if isinstance(e, Alias):
                        env[e.alias] = ref
            continue
        if isinstance(op, Having) and not sort_taken and not limit_taken:
            # encode into a scratch copy and commit on success, so a
            # failed encode leaves no stray slots
            scratch = list(values)
            tree = _encode_having(op.predicate, env, scratch)
            if tree is None:
                break
            values[:] = scratch
            post.having = tree if post.having is None else ("and", post.having, tree)
            post.consumed = post.consumed | {idx}
            continue
        if isinstance(op, Sort) and not sort_taken and not limit_taken:
            keys = []
            nulls_spec = op.nulls or [None] * len(op.keys)
            ok = True
            for (e, asc), nf in zip(op.keys, nulls_spec):
                ref = _ref_of(e, env)
                if ref is None:
                    ok = False
                    break
                want_first = (not asc) if nf is None else bool(nf)
                if ref[0] == "dim":
                    is_bucket = (
                        lowering.bucket is not None
                        and ref[1] == len(lowering.group_tags)
                    )
                    # tag codes are value-sorted with NULL as the max code:
                    # only the SQL-default placement rides the code order
                    if not is_bucket and want_first != (not asc):
                        ok = False
                        break
                keys.append((ref, bool(asc), want_first))
            if not ok:
                break
            post.order = tuple(keys)
            post.consumed = post.consumed | {idx}
            sort_taken = True
            continue
        if isinstance(op, Limit) and not limit_taken:
            if op.limit is None or op.limit < 0 or op.offset < 0:
                break
            post.limit = int(op.limit)
            post.offset = int(op.offset)
            post.consumed = post.consumed | {idx}
            limit_taken = True
            continue
        break  # anything else: the host replays from here out
    post.having_values = tuple(values)
    return post
