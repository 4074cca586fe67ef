"""PromQL range-query evaluation engine.

Counterpart of `greptimedb_tpu/query/promql/engine.py` (role-equivalent of
the reference's PromQL pipeline, query/src/promql/planner.rs +
promql/src/extension_plan/*).  Two routes evaluate a range function
(rate/increase/delta, *_over_time, instant vectors, timestamp()):

* the warm tile path (query/promql/tile_exec.py, the `tql_tile` pass):
  one program (K9-K12) over the resident super-tile planes;
* the legacy path: the selector scans the metric table with matcher
  pushdown, and `_range_from_samples` moves the flat (sid, ts, value)
  columns to the database's device and runs K9 (rate/increase), K10 and
  K11 there (ops/rate.py).  Label aggregations regroup series on the host.

A tile-path decline (a shape it does not express) takes the legacy path;
a failure on either path raises.  Everything else (functions, binary and
set operators, host window functions, histogram_quantile) is the
reference's host logic, carried over.

The evaluated value representation is a dense matrix [S series, W steps]
(float64, NaN = no sample) instead of the reference's ragged range-vector
matrices (RangeManipulate).
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from ...utils.errors import PlanError, UnsupportedError
from ..logical_plan import TableScan
from .parser import (
    AggregateExpr,
    BinaryExpr,
    FunctionCall,
    Matcher,
    MatrixSelector,
    NumberLiteral,
    ParenExpr,
    SubqueryExpr,
    VectorSelector,
    parse_promql,
)

DEFAULT_LOOKBACK_MS = 300_000  # Prometheus' 5m lookback delta

_RATE_FUNCS = {"rate", "increase", "delta"}
_OVER_TIME = {
    "avg_over_time", "sum_over_time", "min_over_time", "max_over_time",
    "count_over_time", "last_over_time",
}
# Window functions evaluated host-side over raw window slices (sequential or
# order-statistic semantics that don't reduce to the WindowStats moments).
_HOST_WINDOW_FUNCS = {
    "deriv", "predict_linear", "holt_winters", "resets", "changes",
    "quantile_over_time", "stddev_over_time", "stdvar_over_time",
    "present_over_time", "absent_over_time",
}


@dataclass
class Matrix:
    """Dense evaluation result: S series x W steps."""

    label_names: list[str]
    label_values: list[tuple]  # per series, aligned with label_names
    values: np.ndarray  # [S, W] float64, NaN = absent
    steps: np.ndarray  # [W] int64 ms

    def drop_empty(self) -> "Matrix":
        keep = ~np.all(np.isnan(self.values), axis=1)
        return Matrix(
            self.label_names,
            [lv for lv, k in zip(self.label_values, keep) if k],
            self.values[keep],
            self.steps,
        )


@dataclass
class Scalar:
    """A PromQL scalar: one value per step.  `value` is a float (constant)
    or a [W] ndarray (step-dependent, e.g. time())."""

    value: object  # float | np.ndarray

    def row(self, n_steps: int) -> np.ndarray:
        v = np.asarray(self.value, dtype=np.float64)
        return np.broadcast_to(v, (n_steps,))


_TILE_UNSET = object()


class PromqlEngine:
    def __init__(self, db, lookback_ms: int = DEFAULT_LOOKBACK_MS):
        self.db = db
        self.lookback_ms = lookback_ms
        self._tile = _TILE_UNSET

    def _tile_exec(self):
        """Warm TQL tile-path executor (query/promql/tile_exec.py), or
        None when the tile cache is off or `tql.tile` is off."""
        if self._tile is _TILE_UNSET:
            self._tile = None
            if self.db.config.tql.tile and self.db.query_engine.tile_executor() is not None:
                from .tile_exec import TqlTileExecutor

                self._tile = TqlTileExecutor(self.db)
        return self._tile

    # ---- public API (mirrors the HTTP /api/v1 surface) --------------------
    def query_range(self, promql: str, start_ms: int, end_ms: int, step_ms: int) -> pa.Table:
        ast = parse_promql(promql)
        out = self._eval(ast, start_ms, end_ms, step_ms)
        if isinstance(out, Scalar):
            steps = np.arange(start_ms, end_ms + 1, step_ms, dtype=np.int64)
            return pa.table(
                {"ts": pa.array(steps, pa.timestamp("ms")), "value": out.row(len(steps)).copy()}
            )
        t0 = time.perf_counter()
        try:
            return _matrix_to_table(out.drop_empty())
        finally:
            _add_ms(self.db.query_engine.last_tql_timings, "output", t0)

    def query_instant(self, promql: str, time_ms: int) -> pa.Table:
        return self.query_range(promql, time_ms, time_ms, max(1, 1000))

    # ---- evaluation --------------------------------------------------------
    def _eval(self, node, start: int, end: int, step: int):
        if isinstance(node, NumberLiteral):
            return Scalar(node.value)
        if isinstance(node, ParenExpr):
            return self._eval(node.expr, start, end, step)
        if isinstance(node, VectorSelector):
            # Instant vector: latest sample within lookback at each step.
            return self._eval_range_func("last_over_time", node, self.lookback_ms, start, end, step)
        if isinstance(node, (MatrixSelector, SubqueryExpr)):
            raise PlanError("range vector must be an argument of a range function")
        if isinstance(node, FunctionCall):
            return self._eval_function(node, start, end, step)
        if isinstance(node, AggregateExpr):
            return self._eval_aggregate(node, start, end, step)
        if isinstance(node, BinaryExpr):
            return self._eval_binary(node, start, end, step)
        raise UnsupportedError(f"promql: cannot evaluate {type(node).__name__}")

    def _eval_function(self, node: FunctionCall, start, end, step):
        f = node.func
        range_like = f in _RATE_FUNCS or f in _OVER_TIME or f in _HOST_WINDOW_FUNCS or f in ("irate", "idelta")
        if range_like:
            # the range vector may not be the first arg (quantile_over_time(q, m[5m]))
            range_args = [a for a in node.args if isinstance(a, (MatrixSelector, SubqueryExpr))]
            if len(range_args) != 1:
                raise PlanError(f"promql: {f} expects a range vector")
            sel = range_args[0]
            extra = [
                self._eval(a, start, end, step)
                for a in node.args
                if not isinstance(a, (MatrixSelector, SubqueryExpr))
            ]
            extra_vals = [a.value if isinstance(a, Scalar) else None for a in extra]
            if any(v is None for v in extra_vals):
                raise PlanError(f"promql: {f} extra arguments must be scalars")
            if f in _HOST_WINDOW_FUNCS:
                return self._eval_host_window(f, sel, extra_vals, start, end, step)
            fname = {"irate": "rate", "idelta": "delta"}.get(f, f)
            if isinstance(sel, SubqueryExpr):
                return self._with_at(
                    sel.at_spec, start, end, step,
                    lambda s, e, st: self._range_from_samples(
                        fname, self._subquery_samples(sel, s, e, st), sel.range_ms, s, e, st
                    ),
                )
            return self._eval_range_func(fname, sel.vector, sel.range_ms, start, end, step)
        if f == "time":
            steps = np.arange(start, end + 1, step, dtype=np.int64)
            return Scalar(steps / 1000.0)
        if f == "vector":
            arg = self._eval(node.args[0], start, end, step)
            steps = np.arange(start, end + 1, step, dtype=np.int64)
            if isinstance(arg, Scalar):
                return Matrix([], [()], arg.row(len(steps))[None, :].copy(), steps)
            return arg
        if f in ("minute", "hour", "day_of_month", "day_of_week", "days_in_month", "month", "year"):
            return self._eval_date_func(f, node.args, start, end, step)
        if f == "timestamp":
            if node.args and isinstance(node.args[0], VectorSelector):
                # underlying sample timestamp (WindowStats.last_ts), not the step
                return self._eval_range_func(
                    "__last_ts", node.args[0], self.lookback_ms, start, end, step
                )
            m = self._eval(node.args[0], start, end, step)
            vals = np.where(~np.isnan(m.values), m.steps[None, :] / 1000.0, np.nan)
            return Matrix(m.label_names, m.label_values, vals, m.steps)
        if f == "absent":
            m = self._eval(node.args[0], start, end, step)
            if isinstance(m, Scalar):
                raise PlanError("promql: absent expects an instant vector")
            no_series = (
                np.ones(m.values.shape[1], dtype=bool)
                if m.values.shape[0] == 0
                else np.all(np.isnan(m.values), axis=0)
            )
            vals = np.where(no_series, 1.0, np.nan)[None, :]
            return Matrix([], [()], vals, m.steps)
        if f == "label_replace":
            return self._label_replace(node.args, start, end, step)
        if f == "label_join":
            return self._label_join(node.args, start, end, step)
        simple = {
            "abs": np.abs, "ceil": np.ceil, "floor": np.floor, "sqrt": np.sqrt,
            "exp": np.exp, "ln": np.log, "log2": np.log2, "log10": np.log10,
            "sgn": np.sign, "round": np.round,
        }
        if f in simple:
            m = self._eval(node.args[0], start, end, step)
            if isinstance(m, Scalar):
                return Scalar(simple[f](m.value))
            return Matrix(m.label_names, m.label_values, simple[f](m.values), m.steps)
        if f in ("clamp_min", "clamp_max", "clamp"):
            m = self._eval(node.args[0], start, end, step)
            args = [self._eval(a, start, end, step) for a in node.args[1:]]
            vals = m.values
            if f == "clamp_min":
                vals = np.maximum(vals, args[0].value)
            elif f == "clamp_max":
                vals = np.minimum(vals, args[0].value)
            else:
                vals = np.clip(vals, args[0].value, args[1].value)
            return Matrix(m.label_names, m.label_values, vals, m.steps)
        if f == "scalar":
            m = self._eval(node.args[0], start, end, step)
            if isinstance(m, Scalar):
                return m
            vals = np.where(
                np.sum(~np.isnan(m.values), axis=0) == 1,
                np.nansum(m.values, axis=0),
                np.nan,
            )
            return Scalar(vals)
        if f in ("sort", "sort_desc"):
            return self._eval(node.args[0], start, end, step)  # order applied at output
        if f == "histogram_quantile":
            phi_arg = self._eval(node.args[0], start, end, step)
            if not isinstance(phi_arg, Scalar):
                raise PlanError("promql: histogram_quantile expects a scalar φ")
            m = self._eval(node.args[1], start, end, step)
            if isinstance(m, Scalar):
                raise PlanError("promql: histogram_quantile expects bucket series")
            return _histogram_quantile(phi_arg.value, m)
        raise UnsupportedError(f"promql: function {f} not supported yet")

    def _resolve_at(self, at_spec, start, end):
        """@ modifier -> fixed evaluation timestamp in ms (or None)."""
        if at_spec is None:
            return None
        if at_spec == "start":
            return start
        if at_spec == "end":
            return end
        return int(at_spec)

    def _broadcast_fixed(self, m: "Matrix", start, end, step) -> "Matrix":
        """Tile a single-step result across the full step grid (@ modifier)."""
        steps = np.arange(start, end + 1, step, dtype=np.int64)
        vals = (
            np.repeat(m.values[:, :1], len(steps), axis=1)
            if m.values.size
            else np.zeros((m.values.shape[0], len(steps)))
        )
        return Matrix(m.label_names, m.label_values, vals, steps)

    def _with_at(self, at_spec, start, end, step, compute):
        """THE @-modifier implementation, used by every range-vector
        consumer: pin `compute` to the resolved timestamp and broadcast
        the single-step result across the requested grid."""
        at_ms = self._resolve_at(at_spec, start, end)
        if at_ms is None:
            return compute(start, end, step)
        fixed = compute(at_ms, at_ms, max(step, 1))
        return self._broadcast_fixed(fixed, start, end, step)

    def _eval_range_func(self, func: str, sel: VectorSelector, range_ms: int, start, end, step):
        # warm TQL path first (the `tql_tile` pass): one program over the
        # resident planes; a decline (a shape the tile path does not
        # express) falls through to the legacy scan-and-upload evaluation
        # below, which is tql.tile = false
        tile = self._tile_exec()
        if tile is not None:
            at_ms = self._resolve_at(sel.at_spec, start, end)
            s0, e0, st0 = (
                (start, end, step) if at_ms is None
                else (at_ms, at_ms, max(step, 1))
            )
            out = tile.try_range_eval(func, sel, range_ms, s0, e0, st0)
            if out is not None:
                return (
                    out if at_ms is None
                    else self._broadcast_fixed(out, start, end, step)
                )
        return self._with_at(
            sel.at_spec, start, end, step,
            lambda s, e, st: self._range_from_samples(
                func, self._fetch(sel, s - range_ms, e), range_ms, s, e, st
            ),
        )

    def _range_from_samples(self, func: str, flat, range_ms: int, start, end, step):
        """Rate-family / over_time over flat (sid, ts, value) samples on the
        database's device — K9 (rate, increase), K10 and K11, the legacy
        route's one device call — shared by selectors and subqueries."""
        import torch

        from ...ops.rate import (
            RangeGrid,
            RangeSpec,
            RowSource,
            range_finalize,
            range_windows,
            strip_counter_resets,
        )

        series_ids, ts, values, label_names, label_values, num_series = flat
        steps = np.arange(start, end + 1, step, dtype=np.int64)
        if num_series == 0:
            return Matrix(label_names, [], np.zeros((0, len(steps))), steps)
        t0 = time.perf_counter()
        spec = RangeSpec(start=start, end=start + (len(steps) - 1) * step, step=step, range_=range_ms)
        grid = RangeGrid(start, step, range_ms, n_steps=len(steps), k=spec.windows_per_sample,
                         num_series=num_series, n_steps_actual=len(steps))
        dev = torch.device(self.db.device)

        def up(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)

        src = RowSource(ts=[up(ts, np.int64)], values=[up(values, np.float64)],
                        num_series=num_series, sid=[up(series_ids, np.int32)])
        adjusted = layout = None
        if func in ("rate", "increase"):
            adjusted, layout = strip_counter_resets(src)
        stats, _presence = range_windows(src, grid, values=adjusted, layout=layout)
        vals = range_finalize([stats], grid, func).cpu().numpy().reshape(num_series, len(steps))
        qe = self.db.query_engine
        qe.stats.add(tql_legacy=1)
        _add_ms(qe.last_tql_timings, "legacy_device", t0)
        return Matrix(label_names, label_values, vals, steps)

    def _subquery_samples(self, sub: SubqueryExpr, start, end, step):
        """Evaluate the subquery's inner expr on the sub-step grid and
        return its samples in the flat (sid, ts, value) shape _fetch uses."""
        sub_step = sub.step_ms or step
        s0 = start - sub.range_ms - sub.offset_ms
        e0 = end - sub.offset_ms
        # Align the sub-grid to multiples of sub_step like Prometheus does.
        s0 = (s0 // sub_step) * sub_step
        m = self._eval(sub.expr, s0, e0, sub_step)
        if isinstance(m, Scalar):
            steps = np.arange(s0, e0 + 1, sub_step, dtype=np.int64)
            m = Matrix([], [()], m.row(len(steps))[None, :].copy(), steps)
        S, W = m.values.shape
        present = ~np.isnan(m.values)
        sid_grid = np.broadcast_to(np.arange(S, dtype=np.int32)[:, None], (S, W))
        ts_grid = np.broadcast_to(m.steps[None, :] + sub.offset_ms, (S, W))
        sid = sid_grid[present]
        ts = ts_grid[present]
        vals = m.values[present]
        order = np.lexsort((ts, sid))
        return sid[order], ts[order], vals[order], m.label_names, m.label_values, S

    # ---- host-evaluated window functions -----------------------------------
    def _eval_host_window(self, func, sel, extra, start, end, step):
        at_spec = sel.at_spec if isinstance(sel, SubqueryExpr) else sel.vector.at_spec
        range_ms = sel.range_ms
        return self._with_at(
            at_spec, start, end, step,
            lambda s, e, st: self._host_window_inner(func, sel, extra, range_ms, s, e, st),
        )

    def _host_window_inner(self, func, sel, extra, range_ms, start, end, step):
        if isinstance(sel, SubqueryExpr):
            flat = self._subquery_samples(sel, start, end, step)
        else:
            flat = self._fetch(sel.vector, start - range_ms, end)
        sid, ts, values, label_names, label_values, num_series = flat
        steps = np.arange(start, end + 1, step, dtype=np.int64)
        W = len(steps)
        out = np.full((num_series, W), np.nan)
        # series are contiguous after the (sid, ts) lexsort
        bounds = np.searchsorted(sid, np.arange(num_series + 1))
        for si in range(num_series):
            lo, hi = bounds[si], bounds[si + 1]
            sts, svs = ts[lo:hi], values[lo:hi]
            for w, t1 in enumerate(steps):
                a = np.searchsorted(sts, t1 - range_ms, side="right")
                b = np.searchsorted(sts, t1, side="right")
                if a >= b:
                    continue
                # scalar args may be step-dependent (e.g. time()-derived)
                ex = [x if np.isscalar(x) else float(np.asarray(x).reshape(-1)[min(w, np.asarray(x).size - 1)]) for x in extra]
                out[si, w] = _window_func(func, sts[a:b], svs[a:b], t1, ex)
        if func == "absent_over_time":
            no_samples = (
                np.ones(W, dtype=bool) if num_series == 0 else np.all(np.isnan(out), axis=0)
            )
            vals = np.where(no_samples, 1.0, np.nan)[None, :]
            return Matrix([], [()], vals, steps)
        return Matrix(label_names, label_values, out, steps)

    # ---- date & label functions --------------------------------------------
    def _eval_date_func(self, f, args, start, end, step):
        if args:
            m = self._eval(args[0], start, end, step)
        else:
            steps = np.arange(start, end + 1, step, dtype=np.int64)
            m = Matrix([], [()], (steps / 1000.0)[None, :], steps)
        if isinstance(m, Scalar):
            steps = np.arange(start, end + 1, step, dtype=np.int64)
            m = Matrix([], [()], m.row(len(steps))[None, :].copy(), steps)
        vals = m.values
        nan = np.isnan(vals)
        secs = np.where(nan, 0, vals).astype(np.int64)
        t64 = secs.astype("datetime64[s]")
        if f == "minute":
            out = (secs // 60) % 60
        elif f == "hour":
            out = (secs // 3600) % 24
        elif f == "day_of_week":
            out = (secs // 86_400 + 4) % 7  # epoch day 0 was a Thursday
        elif f == "day_of_month":
            months = t64.astype("datetime64[M]")
            out = (t64.astype("datetime64[D]") - months.astype("datetime64[D]")).astype(np.int64) + 1
        elif f == "days_in_month":
            months = t64.astype("datetime64[M]")
            out = ((months + 1).astype("datetime64[D]") - months.astype("datetime64[D]")).astype(np.int64)
        elif f == "month":
            out = t64.astype("datetime64[M]").astype(np.int64) % 12 + 1
        else:  # year
            out = t64.astype("datetime64[Y]").astype(np.int64) + 1970
        return Matrix(m.label_names, m.label_values, np.where(nan, np.nan, out.astype(np.float64)), m.steps)

    def _label_replace(self, args, start, end, step):
        if len(args) != 5:
            raise PlanError("label_replace(v, dst_label, replacement, src_label, regex)")
        m = self._eval(args[0], start, end, step)
        dst, repl, src, regex = (
            _string_arg(args[1]), _string_arg(args[2]), _string_arg(args[3]), _string_arg(args[4]))
        pat = re.compile(regex)
        names = list(m.label_names)
        if dst not in names:
            names = names + [dst]
        out_values = []
        template = _dollar_template(repl)
        for lv in m.label_values:
            d = dict(zip(m.label_names, lv))
            srcval = d.get(src, "") or ""
            mt = pat.fullmatch(srcval)
            if mt is not None:
                d[dst] = mt.expand(template)
            elif dst not in d:
                d[dst] = ""
            out_values.append(tuple(d.get(n, "") for n in names))
        return Matrix(names, out_values, m.values, m.steps)

    def _label_join(self, args, start, end, step):
        if len(args) < 3:
            raise PlanError("label_join(v, dst_label, separator, src_labels...)")
        m = self._eval(args[0], start, end, step)
        dst, sep = _string_arg(args[1]), _string_arg(args[2])
        srcs = [_string_arg(a) for a in args[3:]]
        names = list(m.label_names)
        if dst not in names:
            names = names + [dst]
        out_values = []
        for lv in m.label_values:
            d = dict(zip(m.label_names, lv))
            d[dst] = sep.join(str(d.get(s, "") or "") for s in srcs)
            out_values.append(tuple(d.get(n, "") for n in names))
        return Matrix(names, out_values, m.values, m.steps)

    def _eval_aggregate(self, node: AggregateExpr, start, end, step):
        fused = self._try_fused_aggregate(node, start, end, step)
        if fused is not None:
            return fused
        m = self._eval(node.expr, start, end, step)
        if isinstance(m, Scalar):
            return m
        if node.op in ("topk", "bottomk"):
            k = int(node.param.value) if isinstance(node.param, NumberLiteral) else 5
            order = np.nansum(m.values, axis=1)
            idx = np.argsort(-order if node.op == "topk" else order)[:k]
            return Matrix(m.label_names, [m.label_values[i] for i in idx], m.values[idx], m.steps)

        # Regroup series by the kept label subset.
        if node.by is not None:
            keep = [l for l in node.by if l in m.label_names]
        elif node.without is not None:
            keep = [l for l in m.label_names if l not in node.without]
        else:
            keep = []
        keep_idx = [m.label_names.index(l) for l in keep]
        groups: dict[tuple, int] = {}
        gid = np.empty(len(m.label_values), dtype=np.int64)
        for i, lv in enumerate(m.label_values):
            key = tuple(lv[j] for j in keep_idx)
            if key not in groups:
                groups[key] = len(groups)
            gid[i] = groups[key]
        G, W = len(groups), m.values.shape[1]
        present = ~np.isnan(m.values)
        zeroed = np.where(present, m.values, 0.0)
        sums = np.zeros((G, W))
        counts = np.zeros((G, W))
        np.add.at(sums, gid, zeroed)
        np.add.at(counts, gid, present.astype(float))
        if node.op == "sum":
            out = np.where(counts > 0, sums, np.nan)
        elif node.op in ("avg", "mean"):
            out = np.where(counts > 0, sums / np.maximum(counts, 1), np.nan)
        elif node.op == "count":
            out = np.where(counts > 0, counts, np.nan)
        elif node.op in ("min", "max"):
            fill = np.inf if node.op == "min" else -np.inf
            filled = np.where(present, m.values, fill)
            ext = np.full((G, W), fill)
            ufunc = np.minimum if node.op == "min" else np.maximum
            ufunc.at(ext, gid, filled)
            out = np.where(counts > 0, ext, np.nan)
        elif node.op in ("stddev", "stdvar"):
            sq = np.zeros((G, W))
            np.add.at(sq, gid, np.where(present, m.values**2, 0.0))
            mean = sums / np.maximum(counts, 1)
            var = sq / np.maximum(counts, 1) - mean**2
            var = np.maximum(var, 0.0)
            out = np.where(counts > 0, np.sqrt(var) if node.op == "stddev" else var, np.nan)
        elif node.op == "quantile":
            q = float(node.param.value) if isinstance(node.param, NumberLiteral) else 0.5
            out = np.full((G, W), np.nan)
            for g in range(G):
                rows = m.values[gid == g]
                with np.errstate(all="ignore"):
                    out[g] = np.nanquantile(rows, q, axis=0)
        else:
            raise UnsupportedError(f"promql: aggregation {node.op} not supported")
        return Matrix(keep, list(groups.keys()), out, m.steps)

    def _try_fused_aggregate(self, node: AggregateExpr, start, end, step):
        """sum/avg/min/max/count by(...) over a range function on a plain
        selector: the whole expression — window kernels AND the by-label
        fold — compiles into the ONE tile dispatch (the `tql_tile` pass),
        so the readback ships [groups, steps] instead of the per-series
        matrix.  Returns None whenever the fused shape does not apply;
        the caller then evaluates per-series and folds host-side, which
        the tile path still accelerates through `_eval_range_func`."""
        if node.op not in ("sum", "avg", "mean", "min", "max", "count"):
            return None
        if node.param is not None:
            return None
        tile = self._tile_exec()
        if tile is None:
            return None
        expr = node.expr
        while isinstance(expr, ParenExpr):
            expr = expr.expr
        sel = func = range_ms = None
        if isinstance(expr, FunctionCall):
            f = expr.func
            if f in _RATE_FUNCS or f in _OVER_TIME or f in ("irate", "idelta"):
                rargs = [
                    a for a in expr.args
                    if isinstance(a, (MatrixSelector, SubqueryExpr))
                ]
                if (
                    len(expr.args) == 1
                    and len(rargs) == 1
                    and isinstance(rargs[0], MatrixSelector)
                ):
                    sel = rargs[0].vector
                    func = {"irate": "rate", "idelta": "delta"}.get(f, f)
                    range_ms = rargs[0].range_ms
        elif isinstance(expr, VectorSelector):
            # instant vector = last_over_time over the lookback window
            sel, func, range_ms = expr, "last_over_time", self.lookback_ms
        if sel is None:
            return None
        agg = (node.op, node.by, node.without)
        at_ms = self._resolve_at(sel.at_spec, start, end)
        if at_ms is None:
            return tile.try_range_eval(
                func, sel, range_ms, start, end, step, agg=agg
            )
        fixed = tile.try_range_eval(
            func, sel, range_ms, at_ms, at_ms, max(step, 1), agg=agg
        )
        return (
            None if fixed is None
            else self._broadcast_fixed(fixed, start, end, step)
        )

    def _eval_binary(self, node: BinaryExpr, start, end, step):
        l = self._eval(node.left, start, end, step)
        r = self._eval(node.right, start, end, step)
        if node.op in ("and", "or", "unless"):
            if isinstance(l, Scalar) or isinstance(r, Scalar):
                raise PlanError(f"promql: {node.op} requires vector operands")
            return self._set_op(node, l, r)
        if isinstance(l, Scalar) and isinstance(r, Scalar):
            return Scalar(_scalar_op(node.op, l.value, r.value))
        if isinstance(l, Scalar):
            return self._apply_scalar(node, r, l.value, scalar_on_left=True)
        if isinstance(r, Scalar):
            return self._apply_scalar(node, l, r.value, scalar_on_left=False)
        return self._vector_match(node, l, r)

    @staticmethod
    def _join_key(m: Matrix, i: int, on, ignoring) -> tuple:
        d = dict(zip(m.label_names, m.label_values[i]))
        if on is not None:
            return tuple(d.get(n) for n in on)
        keys = [n for n in m.label_names if ignoring is None or n not in ignoring]
        return tuple((n, d[n]) for n in sorted(keys))

    def _set_op(self, node: BinaryExpr, l: Matrix, r: Matrix):
        """and/or/unless with on/ignoring matching, per-timestamp (Prometheus
        semantics: presence is checked at each step, unioned across all
        series sharing a join key)."""
        W = l.values.shape[1]
        # per-key presence mask on the right side (union across series)
        rpresence: dict[tuple, np.ndarray] = {}
        for j in range(len(r.label_values)):
            key = self._join_key(r, j, node.on, node.ignoring)
            mask = ~np.isnan(r.values[j])
            prev = rpresence.get(key)
            rpresence[key] = mask if prev is None else (prev | mask)
        if node.op in ("and", "unless"):
            out_vals = []
            for i in range(len(l.label_values)):
                rpresent = rpresence.get(
                    self._join_key(l, i, node.on, node.ignoring), np.zeros(W, dtype=bool)
                )
                keep = rpresent if node.op == "and" else ~rpresent
                out_vals.append(np.where(keep, l.values[i], np.nan))
            values = np.stack(out_vals) if out_vals else np.zeros((0, W))
            return Matrix(l.label_names, list(l.label_values), values, l.steps)
        # or: all left series; right series contribute only at steps where NO
        # left series with the same key has a value.
        lpresence: dict[tuple, np.ndarray] = {}
        for i in range(len(l.label_values)):
            key = self._join_key(l, i, node.on, node.ignoring)
            mask = ~np.isnan(l.values[i])
            prev = lpresence.get(key)
            lpresence[key] = mask if prev is None else (prev | mask)
        names = list(l.label_names)
        extra = [n for n in r.label_names if n not in names]
        names_all = names + extra
        out_labels, out_vals = [], []
        for i in range(len(l.label_values)):
            d = dict(zip(l.label_names, l.label_values[i]))
            out_labels.append(tuple(d.get(n, "") for n in names_all))
            out_vals.append(l.values[i])
        for j in range(len(r.label_values)):
            key = self._join_key(r, j, node.on, node.ignoring)
            lmask = lpresence.get(key, np.zeros(W, dtype=bool))
            vals = np.where(lmask, np.nan, r.values[j])
            if np.all(np.isnan(vals)):
                continue
            d = dict(zip(r.label_names, r.label_values[j]))
            out_labels.append(tuple(d.get(n, "") for n in names_all))
            out_vals.append(vals)
        values = np.stack(out_vals) if out_vals else np.zeros((0, W))
        return Matrix(names_all, out_labels, values, l.steps)

    def _vector_match(self, node: BinaryExpr, l: Matrix, r: Matrix):
        """Arithmetic/comparison with one-to-one or many-to-one matching
        (reference PromPlanner vector matching: on/ignoring, group_left/right).

        The "many" side is the left operand (group_left, the default for
        one-to-one too) or the right operand (group_right); the "one" side
        must have a unique series per join key.
        """
        one, many = (l, r) if node.group == "right" else (r, l)
        one_map: dict[tuple, int] = {}
        for j in range(len(one.label_values)):
            key = self._join_key(one, j, node.on, node.ignoring)
            if key in one_map:
                side = "left" if node.group == "right" else "right"
                raise PlanError(
                    f"promql: many-to-many matching not allowed: duplicate series "
                    f"on the {side} side for key {key}"
                )
            one_map[key] = j

        if node.group is None:
            # one-to-one: the other side must also be unique per key
            seen: set = set()
            for i in range(len(many.label_values)):
                key = self._join_key(many, i, node.on, node.ignoring)
                if key in seen:
                    raise PlanError(
                        "promql: many-to-many matching not allowed (use group_left/group_right)"
                    )
                seen.add(key)

        # output labels: grouped match keeps the many side's labels
        # (+include from the one side); one-to-one keeps the join-key labels
        # when `on` is given, else left labels minus ignored.
        if node.group is not None:
            names = list(many.label_names) + [
                n for n in node.include if n not in many.label_names
            ]
        elif node.on is not None:
            names = list(node.on)
        else:
            names = [n for n in l.label_names if node.ignoring is None or n not in node.ignoring]

        out_labels, out_vals = [], []
        W = l.values.shape[1]
        for i in range(len(many.label_values)):
            key = self._join_key(many, i, node.on, node.ignoring)
            j = one_map.get(key)
            if j is None:
                continue
            lv = l.values[i] if node.group != "right" else l.values[j]
            rv = r.values[j] if node.group != "right" else r.values[i]
            vals = _vec_op(node.op, lv, rv, node.bool_modifier)
            d = dict(zip(many.label_names, many.label_values[i]))
            if node.group is not None:
                do = dict(zip(one.label_names, one.label_values[j]))
                for n in node.include:
                    d[n] = do.get(n, "")
            out_labels.append(tuple(d.get(n, "") for n in names))
            out_vals.append(vals)
        values = np.stack(out_vals) if out_vals else np.zeros((0, W))
        return Matrix(names, out_labels, values, l.steps)

    def _apply_scalar(self, node, m: Matrix, scalar: float, scalar_on_left: bool):
        a, b = (scalar, m.values) if scalar_on_left else (m.values, scalar)
        vals = _vec_op(node.op, a, b, node.bool_modifier)
        return Matrix(m.label_names, m.label_values, vals, m.steps)

    # ---- data fetch --------------------------------------------------------
    def _fetch(self, sel: VectorSelector, t_lo: int, t_hi: int):
        """Scan the metric table; returns sorted flat (series, ts, value)
        columns plus the series label decode."""
        t0 = time.perf_counter()
        try:
            return self._fetch_inner(sel, t_lo, t_hi)
        finally:
            _add_ms(self.db.query_engine.last_tql_timings, "legacy_fetch", t0)

    def _fetch_inner(self, sel: VectorSelector, t_lo: int, t_hi: int):
        meta = self.db.catalog.table(sel.metric, self.db.current_database)
        schema = meta.schema
        ts_col = schema.time_index.name
        fields = schema.field_columns()
        value_col = None
        for cand in ("greptime_value", "value", "val"):
            if any(f.name == cand for f in fields):
                value_col = cand
                break
        if value_col is None:
            if len(fields) != 1:
                raise PlanError(
                    f"promql: metric {sel.metric} has {len(fields)} fields; expected one"
                )
            value_col = fields[0].name
        tags = [c.name for c in schema.tag_columns()]

        filters = []
        regex_matchers: list[Matcher] = []
        for mt in sel.matchers:
            if mt.label not in tags:
                if mt.op in ("=", "=~"):
                    return np.zeros(0, np.int32), np.zeros(0, np.int64), np.zeros(0), tags, [], 0
                continue
            if mt.op == "=":
                filters.append((mt.label, "=", mt.value))
            elif mt.op == "!=":
                filters.append((mt.label, "!=", mt.value))
            else:
                regex_matchers.append(mt)

        # ms bounds -> the column's NATIVE unit: scale by 1e6/unit_ns
        # (×1000 for us, ×1e6 for ns, ÷1000 for s columns).
        unit_ns = schema.time_index.data_type.timestamp_unit_ns()
        offset = sel.offset_ms
        scan = TableScan(
            table=sel.metric,
            database=self.db.current_database,
            filters=filters,
            time_range=(
                (t_lo - offset) * 1_000_000 // unit_ns,
                (t_hi - offset) * 1_000_000 // unit_ns + 1,
            ),
        )
        tables = [t for t in self.db._region_scan(scan) if t.num_rows]
        if not tables:
            return np.zeros(0, np.int32), np.zeros(0, np.int64), np.zeros(0), tags, [], 0
        table = pa.concat_tables(tables, promote_options="permissive")

        for mt in regex_matchers:
            col = table[mt.label]
            if pa.types.is_dictionary(col.type):
                col = pc.cast(col, col.type.value_type)
            pat = re.compile(mt.value)
            vals = col.to_pylist()
            mask = np.array([bool(pat.fullmatch(v or "")) for v in vals])
            if mt.op == "!~":
                mask = ~mask
            table = table.filter(pa.array(mask))
            if table.num_rows == 0:
                return np.zeros(0, np.int32), np.zeros(0, np.int64), np.zeros(0), tags, [], 0

        # native unit -> ms (floor division is exact for s/ms; truncates us/ns)
        ts = np.asarray(pc.cast(table[ts_col], pa.int64())) * unit_ns // 1_000_000 + offset
        values = np.asarray(pc.cast(table[value_col], pa.float64()))
        if tags:
            cols = []
            for tg in tags:
                c = table[tg]
                if pa.types.is_dictionary(c.type):
                    c = pc.cast(c, c.type.value_type)
                cols.append(c.to_pylist())
            combos: dict[tuple, int] = {}
            sid = np.empty(table.num_rows, dtype=np.int32)
            for i, combo in enumerate(zip(*cols)):
                if combo not in combos:
                    combos[combo] = len(combos)
                sid[i] = combos[combo]
            label_values = list(combos.keys())
        else:
            sid = np.zeros(table.num_rows, dtype=np.int32)
            label_values = [()]
        order = np.lexsort((ts, sid))
        return sid[order], ts[order], values[order], tags, label_values, len(label_values)


def _add_ms(timings: dict, stage: str, t0: float) -> None:
    timings[stage] = timings.get(stage, 0.0) + (time.perf_counter() - t0) * 1e3


def _dollar_template(repl: str) -> str:
    """RE2-style $N/${N}/$name/$$ replacement -> Python \\g<> template."""
    out = []
    i = 0
    while i < len(repl):
        c = repl[i]
        if c == "$":
            if repl[i + 1 : i + 2] == "$":
                out.append("$")
                i += 2
                continue
            m = re.match(r"\$\{(\w+)\}|\$(\w+)", repl[i:])
            if m:
                out.append(f"\\g<{m.group(1) or m.group(2)}>")
                i += m.end()
                continue
            out.append("$")
            i += 1
        elif c == "\\":
            out.append("\\\\")
            i += 1
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _string_arg(node) -> str:
    from .parser import StringLiteral

    if isinstance(node, StringLiteral):
        return node.value
    raise PlanError("promql: expected a string literal argument")


def _window_func(func: str, ts: np.ndarray, vs: np.ndarray, eval_ms: int, extra: list):
    """One (series, window) evaluation for the host-side window functions
    (reference promql/src/functions/{deriv,predict_linear,holt_winters,
    resets,changes,quantile}.rs semantics)."""
    n = len(vs)
    if func == "present_over_time":
        return 1.0
    if func == "absent_over_time":
        return 0.0  # sentinel: series HAS samples; absence derived by caller
    if func == "quantile_over_time":
        q = extra[0] if extra else 0.5
        return float(np.quantile(vs, np.clip(q, 0, 1)))
    if func == "stddev_over_time":
        return float(np.std(vs))
    if func == "stdvar_over_time":
        return float(np.var(vs))
    if func == "resets":
        return float(np.sum(np.diff(vs) < 0)) if n > 1 else 0.0
    if func == "changes":
        return float(np.sum(np.diff(vs) != 0)) if n > 1 else 0.0
    if func in ("deriv", "predict_linear"):
        if n < 2:
            return np.nan
        # least-squares slope/intercept with x = seconds relative to eval time
        x = (ts - eval_ms) / 1000.0
        mx, my = x.mean(), vs.mean()
        dx = x - mx
        denom = np.dot(dx, dx)
        if denom == 0:
            return np.nan
        slope = np.dot(dx, vs - my) / denom
        if func == "deriv":
            return float(slope)
        intercept = my - slope * mx
        return float(intercept + slope * extra[0])  # extra[0] = seconds ahead
    if func == "holt_winters":
        if n < 2:
            return np.nan
        sf = extra[0] if extra else 0.5
        tf = extra[1] if len(extra) > 1 else 0.5
        s, b = vs[0], vs[1] - vs[0]
        for i in range(1, n):
            s_prev = s
            s = sf * vs[i] + (1 - sf) * (s + b)
            b = tf * (s - s_prev) + (1 - tf) * b
        return float(s)
    raise PlanError(f"promql: unknown window function {func}")


def _scalar_op(op: str, a, b):
    """Scalar-scalar op; operands may be floats or per-step [W] arrays."""
    with np.errstate(all="ignore"):
        if op in ("+", "-", "*", "/", "%", "^"):
            f = {
                "+": np.add, "-": np.subtract, "*": np.multiply,
                "/": np.divide, "%": np.fmod, "^": np.power,
            }[op]
            out = f(np.float64(a) if np.isscalar(a) else a, b)
        else:
            out = _cmp_np(op, np.asarray(a, dtype=np.float64), np.asarray(b)).astype(np.float64)
        return float(out) if np.ndim(out) == 0 else out


def _cmp_np(op, a, b):
    return {"==": a == b, "!=": a != b, "<": a < b, "<=": a <= b, ">": a > b, ">=": a >= b}[op]


def _vec_op(op: str, a, b, bool_modifier: bool):
    with np.errstate(all="ignore"):
        if op in ("+", "-", "*", "/", "%", "^"):
            f = {
                "+": np.add, "-": np.subtract, "*": np.multiply,
                "/": np.divide, "%": np.fmod, "^": np.power,
            }[op]
            return f(a, b)
        m = _cmp_np(op, a, b)
        if bool_modifier:
            nan = np.isnan(a) | np.isnan(b) if isinstance(a, np.ndarray) or isinstance(b, np.ndarray) else False
            return np.where(nan, np.nan, m.astype(np.float64))
        # filter semantics: keep left value where true, NaN elsewhere
        left = a if isinstance(a, np.ndarray) else np.broadcast_to(a, np.shape(m))
        return np.where(m, left, np.nan)


def _histogram_quantile(phi, m: Matrix) -> Matrix:
    """Prometheus histogram_quantile: fold `le`-bucketed cumulative series
    per label set and interpolate the φ-quantile inside the located bucket
    (reference promql/src/extension_plan/histogram_fold.rs; semantics from
    Prometheus bucketQuantile: monotonicity repair, +Inf top bucket
    required, linear interpolation, φ out of [0,1] -> ±Inf)."""
    if "le" not in m.label_names:
        return Matrix(m.label_names, [], np.zeros((0, len(m.steps))), m.steps)
    le_i = m.label_names.index("le")
    out_names = [n for n in m.label_names if n != "le"]
    groups: dict[tuple, list[tuple[float, int]]] = {}
    for s, lv in enumerate(m.label_values):
        raw = lv[le_i]
        try:
            le = float("inf") if raw in ("+Inf", "Inf", "inf") else float(raw)
        except (TypeError, ValueError):
            continue
        key = tuple(v for j, v in enumerate(lv) if j != le_i)
        groups.setdefault(key, []).append((le, s))

    W = len(m.steps)
    phi_row = np.broadcast_to(np.asarray(phi, np.float64), (W,))
    out_labels: list[tuple] = []
    out_rows: list[np.ndarray] = []
    for key, buckets in groups.items():
        buckets.sort()
        les = np.array([b[0] for b in buckets])
        if len(les) < 2 or not np.isinf(les[-1]):
            continue  # need at least one finite bucket plus +Inf
        cum = m.values[[s for _le, s in buckets], :]  # [B, W] cumulative
        # absent bucket samples (NaN) contribute nothing: carry the lower
        # bucket's cumulative count forward (Prometheus computes from the
        # buckets present); monotonicity repair rides the same accumulate
        cum = np.maximum.accumulate(np.where(np.isnan(cum), -np.inf, cum), axis=0)
        all_absent = np.isneginf(cum[-1])
        cum = np.maximum(cum, 0.0)
        total = np.where(all_absent, np.nan, cum[-1])
        res = np.full(W, np.nan)
        valid = ~np.isnan(total) & (total > 0) & ~np.isnan(phi_row)
        rank = phi_row * total
        # first bucket whose cumulative count reaches the rank
        reached = cum >= rank[None, :]
        b = np.argmax(reached, axis=0)
        b = np.where(reached.any(axis=0), b, len(les) - 1)
        top = b == len(les) - 1
        res = np.where(valid & top, les[-2], res)
        inner = valid & ~top
        if inner.any():
            b_in = np.where(inner, b, 1)
            end_le = les[b_in]
            start_le = np.where(b_in > 0, les[np.maximum(b_in - 1, 0)], 0.0)
            # Prometheus: first bucket with le <= 0 returns its le directly
            first_nonpos = (b_in == 0) & (les[0] <= 0)
            count_before = np.where(
                b_in > 0, np.take_along_axis(cum, np.maximum(b_in - 1, 0)[None, :], 0)[0], 0.0
            )
            bucket_count = np.take_along_axis(cum, b_in[None, :], 0)[0] - count_before
            interp = start_le + (end_le - start_le) * np.where(
                bucket_count > 0, (rank - count_before) / np.where(bucket_count > 0, bucket_count, 1), 0.0
            )
            res = np.where(inner, np.where(first_nonpos, les[0], interp), res)
        res = np.where(
            valid & (phi_row < 0), -np.inf,
            np.where(valid & (phi_row > 1), np.inf, res),
        )
        out_labels.append(key)
        out_rows.append(res)
    values = np.stack(out_rows) if out_rows else np.zeros((0, W))
    return Matrix(out_names, out_labels, values, m.steps)


def _matrix_to_table(m: Matrix) -> pa.Table:
    """Matrix -> long-format table: labels..., ts, value (reference's
    PromQL JSON matrix rendered relationally)."""
    S, W = m.values.shape
    present = ~np.isnan(m.values)
    cols: dict[str, object] = {}
    s_idx, w_idx = np.nonzero(present)
    for li, name in enumerate(m.label_names):
        vals = [m.label_values[s][li] for s in s_idx]
        cols[name] = vals
    cols["ts"] = pa.array(m.steps[w_idx], pa.timestamp("ms"))
    cols["value"] = m.values[present]
    return pa.table(cols)
