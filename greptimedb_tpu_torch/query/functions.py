"""Scalar function registry.

Role-equivalent of the reference's `FUNCTION_REGISTRY`
(reference common/function/src/function_registry.rs:137-183): a single
registry of named scalar functions over Arrow arrays, consulted by the CPU
executor for any FuncCall that is not a planner special form (cast / case /
time_bucket / date handling live in cpu_exec.py).

Functions evaluate on host (Arrow kernels / numpy); the TPU path only sees
columns after scalar projection, so the registry stays CPU-side exactly like
the reference evaluates UDFs inside DataFusion on CPU.
"""

from __future__ import annotations

import datetime
import hashlib
import math

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from ..utils.errors import PlanError

# registry: name -> callable(args: list[pa.Array|pa.Scalar]) -> pa.Array|pa.Scalar
FUNCTION_REGISTRY: dict = {}


def register(*names):
    def deco(fn):
        for n in names:
            FUNCTION_REGISTRY[n] = fn
        return fn

    return deco


def has_function(name: str) -> bool:
    return name in FUNCTION_REGISTRY


def call_function(name: str, args: list):
    fn = FUNCTION_REGISTRY.get(name)
    if fn is None:
        raise PlanError(f"unknown function: {name}")
    out = fn(*args)
    if isinstance(out, np.generic):
        return pa.scalar(out.item())
    if isinstance(out, np.ndarray) and out.ndim == 0:
        return pa.scalar(out.item())
    if isinstance(out, np.ndarray):
        return pa.array(out)
    return out


def _as_array(v, n: int | None = None):
    if isinstance(v, pa.ChunkedArray):
        return v.combine_chunks()
    if isinstance(v, pa.Scalar) and n is not None:
        return pa.array([v.as_py()] * n)
    return v


def _np(v):
    if isinstance(v, pa.Scalar):
        return v.as_py()
    if isinstance(v, pa.ChunkedArray):
        v = v.combine_chunks()
    return np.asarray(v)


# ---- math ------------------------------------------------------------------

_SIMPLE_MATH = {
    "abs": pc.abs,
    "floor": pc.floor,
    "ceil": pc.ceil,
    "sqrt": pc.sqrt,
    "ln": pc.ln,
    "log10": pc.log10,
    "log2": pc.log2,
    "exp": pc.exp,
    "sin": pc.sin,
    "cos": pc.cos,
    "tan": pc.tan,
    "asin": pc.asin,
    "acos": pc.acos,
    "atan": pc.atan,
    "sign": pc.sign,
    "signum": pc.sign,
    "negative": pc.negate,
}

for _name, _fn in _SIMPLE_MATH.items():
    FUNCTION_REGISTRY[_name] = (lambda f: lambda x: f(x))(_fn)


@register("round")
def _round(x, digits=None):
    nd = digits.as_py() if isinstance(digits, pa.Scalar) else (digits or 0)
    return pc.round(x, ndigits=int(nd or 0))


@register("pow", "power")
def _pow(x, y):
    return pc.power(x, y)


@register("mod")
def _mod(x, y):
    return np.mod(_np(x), _np(y))


@register("atan2")
def _atan2(y, x):
    return np.arctan2(_np(y), _np(x))


@register("cbrt")
def _cbrt(x):
    return np.cbrt(_np(x))


@register("trunc")
def _trunc(x):
    return pc.trunc(x)


@register("degrees")
def _degrees(x):
    return np.degrees(_np(x))


@register("radians")
def _radians(x):
    return np.radians(_np(x))


@register("pi")
def _pi():
    return pa.scalar(math.pi)


@register("clamp")
def _clamp(x, lo, hi):
    return np.clip(_np(x), _np(lo), _np(hi))


@register("greatest")
def _greatest(*args):
    return pc.max_element_wise(*args)


@register("least")
def _least(*args):
    return pc.min_element_wise(*args)


@register("rate")
def _rate_scalar(x, ts=None):
    """greptime scalar `rate(val, ts)` (reference
    common/function/src/scalars/math/rate.rs RateFunction): per-row
    value delta divided by the elapsed time delta, NULL for the first
    row and wherever time does not advance.  The deltas are raw numeric
    differences in the ts argument's own unit, exactly like the
    reference (no seconds normalization)."""
    v = np.atleast_1d(np.asarray(_np(x), dtype=np.float64))
    if ts is None:
        raise PlanError(
            "rate(value, timestamp) requires the timestamp column: the "
            "per-row delta must divide by elapsed time"
        )
    if isinstance(ts, (pa.Array, pa.ChunkedArray)) and pa.types.is_timestamp(
        ts.type
    ):
        ts = pc.cast(ts, pa.int64())
    t = np.atleast_1d(np.asarray(_np(ts), dtype=np.float64))
    if len(v) == 0:
        return pa.array([], pa.float64())
    if len(t) != len(v):
        raise PlanError("rate(value, timestamp): argument lengths differ")
    out = np.full(len(v), np.nan)
    if len(v) > 1:
        dv = np.diff(v)
        dt = np.diff(t)
        with np.errstate(all="ignore"):
            out[1:] = np.where(dt > 0, dv / np.where(dt > 0, dt, 1.0), np.nan)
    mask = ~np.isnan(out)
    return pa.array(out.tolist(), pa.float64(), mask=~mask)


# ---- string ----------------------------------------------------------------

_SIMPLE_STR = {
    "lower": pc.utf8_lower,
    "upper": pc.utf8_upper,
    "length": pc.utf8_length,
    "char_length": pc.utf8_length,
    "character_length": pc.utf8_length,
    "trim": pc.utf8_trim_whitespace,
    "ltrim": pc.utf8_ltrim_whitespace,
    "rtrim": pc.utf8_rtrim_whitespace,
    "reverse": pc.utf8_reverse,
    "capitalize": pc.utf8_capitalize,
}
for _name, _fn in _SIMPLE_STR.items():
    FUNCTION_REGISTRY[_name] = (lambda f: lambda x: f(x))(_fn)


@register("substr", "substring")
def _substr(s, start, length=None):
    st = int(_scalar(start)) - 1  # SQL is 1-based
    if length is None:
        return pc.utf8_slice_codeunits(s, start=max(st, 0))
    return pc.utf8_slice_codeunits(s, start=max(st, 0), stop=max(st, 0) + int(_scalar(length)))


@register("left")
def _left(s, n):
    return pc.utf8_slice_codeunits(s, start=0, stop=int(_scalar(n)))


@register("right")
def _right(s, n):
    k = int(_scalar(n))
    vals = [None if v is None else v[-k:] if k else "" for v in _pylist(s)]
    return pa.array(vals, pa.string())


@register("concat")
def _concat(*args):
    n = max((len(a) for a in args if isinstance(a, (pa.Array, pa.ChunkedArray))), default=1)
    parts = [pc.cast(_as_array(a, n), pa.string()) for a in args]
    return pc.binary_join_element_wise(*parts, "")


@register("concat_ws")
def _concat_ws(sep, *args):
    n = max((len(a) for a in args if isinstance(a, (pa.Array, pa.ChunkedArray))), default=1)
    parts = [pc.cast(_as_array(a, n), pa.string()) for a in args]
    return pc.binary_join_element_wise(*parts, _scalar(sep))


@register("replace")
def _replace(s, old, new):
    return pc.replace_substring(s, pattern=_scalar(old), replacement=_scalar(new))


@register("lpad")
def _lpad(s, n, fill=" "):
    return pc.utf8_lpad(s, width=int(_scalar(n)), padding=_scalar(fill) if not isinstance(fill, str) else fill)


@register("rpad")
def _rpad(s, n, fill=" "):
    return pc.utf8_rpad(s, width=int(_scalar(n)), padding=_scalar(fill) if not isinstance(fill, str) else fill)


@register("starts_with")
def _starts_with(s, prefix):
    return pc.starts_with(s, pattern=_scalar(prefix))


@register("ends_with")
def _ends_with(s, suffix):
    return pc.ends_with(s, pattern=_scalar(suffix))


@register("contains", "strpos_bool")
def _contains(s, sub):
    return pc.match_substring(s, pattern=_scalar(sub))


@register("strpos", "position", "instr")
def _strpos(s, sub):
    return pc.add(pc.find_substring(s, pattern=_scalar(sub)), 1)


@register("split_part")
def _split_part(s, sep, idx):
    i = int(_scalar(idx)) - 1
    sp = _scalar(sep)
    vals = []
    for v in _pylist(s):
        if v is None:
            vals.append(None)
            continue
        parts = v.split(sp)
        vals.append(parts[i] if 0 <= i < len(parts) else "")
    return pa.array(vals, pa.string())


@register("regexp_match", "regexp_like")
def _regexp_match(s, pattern):
    return pc.match_substring_regex(s, pattern=_scalar(pattern))


@register("repeat")
def _repeat(s, n):
    k = int(_scalar(n))
    return pa.array([None if v is None else v * k for v in _pylist(s)], pa.string())


@register("md5")
def _md5(s):
    return pa.array(
        [None if v is None else hashlib.md5(str(v).encode()).hexdigest() for v in _pylist(s)],
        pa.string(),
    )


@register("sha256")
def _sha256(s):
    return pa.array(
        [None if v is None else hashlib.sha256(str(v).encode()).hexdigest() for v in _pylist(s)],
        pa.string(),
    )


@register("hex")
def _hex(x):
    return pa.array(
        [None if v is None else (format(v, "x") if isinstance(v, int) else str(v).encode().hex()) for v in _pylist(x)],
        pa.string(),
    )


# ---- date / time -----------------------------------------------------------


@register("to_unixtime")
def _to_unixtime(ts):
    if isinstance(ts, pa.Scalar):
        v = ts.as_py()
        if isinstance(v, str):
            dt = datetime.datetime.fromisoformat(v.replace(" ", "T"))
            if dt.tzinfo is None:
                dt = dt.replace(tzinfo=datetime.timezone.utc)
            return pa.scalar(int(dt.timestamp()))
        if isinstance(v, datetime.datetime):
            return pa.scalar(int(v.timestamp()))
        return pa.scalar(int(v))
    t = ts
    if pa.types.is_timestamp(t.type):
        unit = t.type.unit
        div = {"s": 1, "ms": 1000, "us": 1_000_000, "ns": 1_000_000_000}[unit]
        return pc.divide(pc.cast(t, pa.int64()), div)
    if pa.types.is_string(t.type):
        return pa.array([int(datetime.datetime.fromisoformat(v.replace(" ", "T")).replace(tzinfo=datetime.timezone.utc).timestamp()) if v else None for v in _pylist(t)])
    return pc.cast(t, pa.int64())


@register("from_unixtime")
def _from_unixtime(secs):
    v = _np(secs)
    if np.isscalar(v):
        return pa.scalar(int(v) * 1000, pa.timestamp("ms"))
    return pa.array((v.astype(np.int64) * 1000), pa.timestamp("ms"))


@register("date_format")
def _date_format(ts, fmt):
    f = _scalar(fmt)
    # chrono %-style passes through to strftime (same directives for the common set)
    return pc.strftime(ts, format=f)


@register("year")
def _year(ts):
    return pc.year(ts)


@register("month")
def _month(ts):
    return pc.month(ts)


@register("day")
def _day(ts):
    return pc.day(ts)


@register("hour")
def _hour(ts):
    return pc.hour(ts)


@register("minute")
def _minute(ts):
    return pc.minute(ts)


@register("second")
def _second(ts):
    return pc.second(ts)


@register("date_part", "datepart")
def _date_part(part, ts):
    """date_part('year'|'month'|..., ts) — DataFusion-compatible form of
    the unit extractors (reference gets it from DataFusion)."""
    p = _scalar(part).lower()
    fns = {
        "year": pc.year, "month": pc.month, "day": pc.day, "hour": pc.hour,
        "minute": pc.minute, "second": pc.second, "dow": pc.day_of_week,
        "doy": pc.day_of_year, "week": pc.iso_week, "quarter": pc.quarter,
        "millisecond": pc.millisecond, "microsecond": pc.microsecond,
    }
    if p not in fns:
        raise ValueError(f"date_part: unknown field {p!r}")
    return fns[p](ts)


@register("dayofweek", "dow")
def _dow(ts):
    return pc.day_of_week(ts)


@register("dayofyear", "doy")
def _doy(ts):
    return pc.day_of_year(ts)


@register("current_date")
def _current_date():
    return pa.scalar(datetime.date.today())


@register("current_time")
def _current_time():
    return pa.scalar(datetime.datetime.now(datetime.timezone.utc).time())


# ---- conditional / misc ----------------------------------------------------


@register("coalesce")
def _coalesce(*args):
    # null-typed literals (SELECT coalesce(NULL, 2)) have no arrow kernel;
    # cast them to the first non-null arg's type.
    types = [a.type for a in args if isinstance(a, (pa.Array, pa.ChunkedArray, pa.Scalar))]
    target = next((t for t in types if not pa.types.is_null(t)), None)
    if target is not None:
        args = [
            a.cast(target) if isinstance(a, (pa.Array, pa.Scalar)) and pa.types.is_null(a.type) else a
            for a in args
        ]
    return pc.coalesce(*args)


@register("nullif")
def _nullif(a, b):
    eq = pc.equal(a, b)
    return pc.if_else(eq, pa.scalar(None, _type_of(a)), a)


@register("ifnull", "nvl")
def _ifnull(a, b):
    return _coalesce(a, b)


@register("isnull")
def _isnull(a):
    if isinstance(a, pa.Scalar):
        return pa.scalar(a.as_py() is None)
    return pc.is_null(a)


@register("arrow_typeof")
def _arrow_typeof(a):
    return pa.scalar(str(_type_of(a)))


@register("version")
def _version():
    from .. import __version__

    return pa.scalar(f"greptimedb-tpu {__version__}")


@register("database")
def _database():
    return pa.scalar("public")


@register("timezone")
def _timezone():
    return pa.scalar("UTC")


@register("uuid")
def _uuid():
    import uuid as _u

    return pa.scalar(str(_u.uuid4()))


# ---- helpers ---------------------------------------------------------------


def _scalar(v):
    if isinstance(v, pa.Scalar):
        return v.as_py()
    return v


def _pylist(v):
    if isinstance(v, pa.Scalar):
        return [v.as_py()]
    if isinstance(v, pa.ChunkedArray):
        return v.combine_chunks().to_pylist()
    if isinstance(v, pa.Array):
        return v.to_pylist()
    return list(v)


def _type_of(v):
    if isinstance(v, (pa.Array, pa.ChunkedArray, pa.Scalar)):
        return v.type
    return pa.null()


# ---- approx sketch finalizers (reference common/function aggrs) ------------


@register("hll_count")
def _hll_count(state):
    """Cardinality estimate from an hll()/hll_merge() state column."""
    from ..ops import sketch as sk

    def one(v):
        return None if v is None else int(round(sk.hll_estimate(sk.hll_deserialize(v))))

    if isinstance(state, pa.Scalar):
        return pa.scalar(one(state.as_py()), pa.int64())
    return pa.array([one(v) for v in _pylist(state)], pa.int64())


@register("uddsketch_calc")
def _uddsketch_calc(q, state):
    """Percentile from a uddsketch_state()/uddsketch_merge() state column.
    Signature matches the reference: uddsketch_calc(0.95, state)."""
    from ..ops import sketch as sk

    qv = q.as_py() if isinstance(q, pa.Scalar) else float(np.asarray(q).reshape(-1)[0])

    def one(v):
        if v is None:
            return None
        out = sk.UddSketch.deserialize(v).quantile(float(qv))
        return None if np.isnan(out) else float(out)

    if isinstance(state, pa.Scalar):
        return pa.scalar(one(state.as_py()), pa.float64())
    return pa.array([one(v) for v in _pylist(state)], pa.float64())


# ---- vector functions (reference common/function/src/scalars/vector/) ------


def _vec_arg_to_bytes(v):
    """Scalar vector arg: binary bytes or a '[...]' string literal."""
    from .vector import parse_vector_literal

    raw = v.as_py() if isinstance(v, pa.Scalar) else v
    if raw is None:
        return None
    if isinstance(raw, bytes):
        return raw
    return parse_vector_literal(raw)


def _vec_distance(a, b, metric: str):
    from .vector import decode_matrix, distances

    # one side is a column, the other a literal (either order)
    if isinstance(a, (pa.Array, pa.ChunkedArray)) and isinstance(b, (pa.Array, pa.ChunkedArray)):
        ma, va = decode_matrix(a)
        mb, vb = decode_matrix(b)
        if ma.shape != mb.shape:
            raise PlanError("vector columns have mismatched dimensions")
        out = np.empty(len(ma), dtype=np.float64)
        for i in range(len(ma)):
            out[i] = distances(ma[i : i + 1], mb[i], metric)[0]
        return pa.array(out, mask=~(va & vb))
    if isinstance(b, (pa.Array, pa.ChunkedArray)):
        a, b = b, a
    qb = _vec_arg_to_bytes(b)
    if qb is None:
        n = len(a) if isinstance(a, (pa.Array, pa.ChunkedArray)) else 1
        return pa.array([None] * n, pa.float64())
    q = np.frombuffer(qb, dtype="<f4")
    if isinstance(a, pa.Scalar) or isinstance(a, (bytes, str)):
        ab = _vec_arg_to_bytes(a)
        if ab is None:
            return pa.scalar(None, pa.float64())
        from .vector import distances as _d

        v = np.frombuffer(ab, dtype="<f4")
        return pa.scalar(float(_d(v[None, :], q, metric)[0]), pa.float64())
    from .vector import decode_matrix as _dm, distances as _d

    mat, valid = _dm(a, len(q))
    out = _d(mat, q, metric).astype(np.float64)
    return pa.array(out, mask=~valid)


@register("vec_cos_distance")
def _vec_cos_distance(a, b):
    return _vec_distance(a, b, "cos")


@register("vec_l2sq_distance")
def _vec_l2sq_distance(a, b):
    return _vec_distance(a, b, "l2sq")


@register("vec_dot_product")
def _vec_dot_product(a, b):
    return _vec_distance(a, b, "dot")


@register("parse_vec")
def _parse_vec(s):
    from .vector import parse_vector_literal

    def one(v):
        return None if v is None else parse_vector_literal(v)

    if isinstance(s, pa.Scalar):
        return pa.scalar(one(s.as_py()), pa.binary())
    return pa.array([one(v) for v in _pylist(s)], pa.binary())


@register("vec_to_string")
def _vec_to_string(b):
    from .vector import vector_to_string

    def one(v):
        return vector_to_string(_vec_arg_to_bytes(v) if v is not None else None)

    if isinstance(b, pa.Scalar):
        return pa.scalar(one(b.as_py()), pa.string())
    return pa.array([one(v) for v in _pylist(b)], pa.string())


@register("vec_dim")
def _vec_dim(b):
    def one(v):
        return None if v is None else len(_vec_arg_to_bytes(v)) // 4

    if isinstance(b, pa.Scalar):
        return pa.scalar(one(b.as_py()), pa.int64())
    return pa.array([one(v) for v in _pylist(b)], pa.int64())


@register("vec_norm")
def _vec_norm(b):
    def one(v):
        if v is None:
            return None
        return float(np.linalg.norm(np.frombuffer(_vec_arg_to_bytes(v), dtype="<f4")))

    if isinstance(b, pa.Scalar):
        return pa.scalar(one(b.as_py()), pa.float64())
    return pa.array([one(v) for v in _pylist(b)], pa.float64())
