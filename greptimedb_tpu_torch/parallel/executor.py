"""Group-by execution over region tables on one torch device.

Counterpart of `greptimedb_tpu/parallel/executor.py`, sort (dense)
strategy on a single device: there is no mesh, no shard_map and no
cross-device merge (multi-GPU is later work).  The host side is kept as
it was:
  - union tag dictionaries across region tables, in order of first
    appearance, so codes — hence group ids and row order — match the
    reference;
  - quantize tag cardinalities to powers of two (`_quantize_card`);
  - decode finalized group ids back to (tags..., bucket timestamp) rows.

`compute_partial_states` is the lower/state stage: K1 (mask + group ids)
then K2/K3/K4 (segment reductions), f64 accumulation, with the
reference's count-pass sharing and presence fusing.  It has no `perm`
(time-major), no limb quantization and no hash table.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import torch

from ..ops.aggregate import (
    AggState,
    finalize,
    segment_aggregate,
    segment_aggregate_multi,
)
from ..ops.filter import mask_gids
from ..ops.tiles import TileBatch, tiles_from_table

COUNT_STAR = "__count_star"  # pseudo-column for count(*)

# SQL agg func -> kernel agg name
_FUNC_TO_KERNEL = {
    "sum": "sum",
    "count": "count",
    "min": "min",
    "max": "max",
    "avg": "avg",
    "last_value": "last",
}


@dataclass(frozen=True)
class DistGroupByPlan:
    """Static description of a scan->filter->groupby aggregate.
    agg_specs is ((func, value_col), ...)."""

    group_tags: tuple[str, ...]
    tag_cards: tuple[int, ...]
    bucket_col: str | None
    bucket_origin: int
    bucket_interval: int
    n_buckets: int
    agg_specs: tuple[tuple[str, str], ...]
    filters: tuple[tuple[str, str, object], ...] = ()
    ts_col: str | None = None  # needed for last_value ordering
    # nullable filter columns whose present-mask must gate the row mask
    # (SQL: NULL never satisfies a predicate)
    filter_null_cols: tuple[str, ...] = ()

    @property
    def num_groups(self) -> int:
        """Output group-space size (the [G] the caller sees)."""
        g = 1
        for c in self.tag_cards:
            g *= c
        if self.bucket_col is not None:
            g *= self.n_buckets
        return g

    def value_cols(self) -> list[str]:
        out = []
        for _f, c in self.agg_specs:
            if c != COUNT_STAR and c not in out:
                out.append(c)
        return out


def _quantize_card(n: int) -> int:
    p = 1
    while p < max(n, 1):
        p <<= 1
    return p


def compute_partial_states(plan: DistGroupByPlan, columns, valid, nulls):
    """Lower/state stage on one tile: mask -> group ids -> partial AggStates.

    `columns`/`nulls` map names to [n] tensors on one device, `valid` is
    the bool row mask.  Returns {value col: AggState, "__presence":
    AggState(counts=...)}."""
    n_groups = plan.num_groups
    gates = [nulls[c] for c in plan.filter_null_cols if c in nulls]
    bucket = None
    if plan.bucket_col is not None:
        bucket = (
            columns[plan.bucket_col], plan.bucket_origin, plan.bucket_interval,
            plan.n_buckets,
        )
    # K1: padding rows get the max id so they never break clustering;
    # their mask keeps them out of every reduction
    gids, mask = mask_gids(
        valid,
        [(columns[name], op, v) for name, op, v in plan.filters],
        gates,
        [(columns[t], card) for t, card in zip(plan.group_tags, plan.tag_cards)],
        bucket,
        n_groups - 1,
    )

    ts = None
    if plan.ts_col is not None and plan.ts_col in columns:
        ts = columns[plan.ts_col]

    per_col_aggs: dict[str, set] = {}
    for func, col in plan.agg_specs:
        per_col_aggs.setdefault(col, set()).add(_FUNC_TO_KERNEL[func])
    states: dict[str, AggState] = {}
    groups: dict[tuple, list[str]] = {}
    last_presence: str | None = None
    for col, aggs in per_col_aggs.items():
        if "last" in aggs:
            key = tuple(sorted(aggs | {"count"}))
            col_mask = mask & nulls[col] if col in nulls else mask
            if col not in nulls:
                last_presence = col  # its count IS the presence count
            states[col] = segment_aggregate(
                columns[col], gids, n_groups, key,
                mask=col_mask, ts=ts,
            )
            continue
        # Count-pass sharing: a column with NO null mask counts exactly the
        # group presence, so it skips its own count pass.
        if col == COUNT_STAR:
            continue  # presence covers it
        null_gated = col in nulls
        kernel_aggs = set()
        if "sum" in aggs or "avg" in aggs:
            kernel_aggs.add("sum")
        if "min" in aggs:
            kernel_aggs.add("min")
        if "max" in aggs:
            kernel_aggs.add("max")
        if null_gated:
            kernel_aggs.add("count")
        elif not kernel_aggs:
            continue  # count(col) on a non-null column: presence covers it
        groups.setdefault(tuple(sorted(kernel_aggs)), []).append(col)
    # Presence fusing: a NON-null-gated value column counts exactly the
    # base-mask rows, which IS the group presence — ride its kernel pass.
    presence_from: str | None = None
    for key in list(groups):
        if "count" in key:
            continue
        cols = groups[key]
        rep = cols[0]
        if len(cols) == 1:
            del groups[key]
        else:
            groups[key] = cols[1:]
        groups.setdefault(tuple(sorted(set(key) | {"count"})), []).insert(0, rep)
        presence_from = rep
        break
    if presence_from is None and last_presence is not None:
        presence_from = last_presence
    if presence_from is None:
        # pseudo-column whose "values" are the mask itself
        groups.setdefault(("count",), []).append("__presence")
    for key, cols in groups.items():
        vals = [
            mask if c in ("__presence", COUNT_STAR) else columns[c]
            for c in cols
        ]
        col_masks = [mask & nulls[c] if c in nulls else mask for c in cols]
        multi = segment_aggregate_multi(
            vals, gids, n_groups, key, col_masks, mask
        )
        for i, c in enumerate(cols):
            states[c] = multi.row(i)
    if presence_from is not None:
        states["__presence"] = AggState(counts=states[presence_from].counts)
    return states


@dataclass
class GroupByResult:
    """Finalized aggregates plus the host-side group key decode."""

    outputs: dict[str, np.ndarray]  # "func(col)" -> [G]
    non_empty: np.ndarray
    tag_values: dict[str, list]
    plan: DistGroupByPlan
    # host wall ms per stage: "tile" (dictionary union, encode, upload),
    # "device" (K1-K4 through the last sync), "readback" ([G] states out)
    timings: dict[str, float] = field(default_factory=dict)

    def to_table(self) -> pa.Table:
        idx = np.nonzero(self.non_empty)[0]
        cols: dict[str, object] = {}
        dims: list[tuple[str, int]] = list(zip(self.plan.group_tags, self.plan.tag_cards))
        if self.plan.bucket_col is not None:
            dims.append(("__bucket", self.plan.n_buckets))
        decoded = {}
        div = 1
        for name, card in reversed(dims):
            decoded[name] = (idx // div) % card
            div *= card
        for tag in self.plan.group_tags:
            values = self.tag_values.get(tag, [])
            codes = decoded[tag]
            cols[tag] = [values[c] if c < len(values) else None for c in codes]
        if self.plan.bucket_col is not None:
            ts = self.plan.bucket_origin + decoded["__bucket"].astype(np.int64) * self.plan.bucket_interval
            cols[self.plan.bucket_col] = ts
        for name, arr in self.outputs.items():
            sel = np.asarray(arr)[idx]
            if np.issubdtype(sel.dtype, np.floating):
                cols[name] = pa.array(sel, mask=np.isnan(sel))  # NaN -> NULL
            else:
                cols[name] = pa.array(sel)
        return pa.table(cols)


def distributed_groupby(
    region_tables: list[pa.Table],
    *,
    group_tags: list[str],
    bucket_col: str | None,
    bucket_origin: int,
    bucket_interval: int,
    n_buckets: int,
    agg_specs: list[tuple[str, str]],
    filters: list[tuple[str, str, object]] | None = None,
    device: str | torch.device = "cuda",
    ts_col: str | None = None,
) -> GroupByResult:
    """Execute a scan->filter->time-bucketed-groupby over region tables on
    one device (the reference's 1-device mesh: all regions concatenated
    into one shard, in region order)."""
    t_start = time.perf_counter()
    filters = filters or []
    norm_specs: list[tuple[str, str]] = []
    for func, col in agg_specs:
        if func == "count" and col is None:
            col = COUNT_STAR
        norm_specs.append((func, col))

    tables = [t for t in region_tables if t is not None]
    if not tables:
        raise ValueError("no region tables to scan")
    table = pa.concat_tables(tables, promote_options="permissive")

    # Union tag dictionaries so codes agree globally (first appearance).
    value_cols = [c for _f, c in norm_specs if c != COUNT_STAR]
    needed_cols = set(group_tags) | set(value_cols) | {f[0] for f in filters}
    if bucket_col is not None:
        needed_cols.add(bucket_col)
    if ts_col is not None:
        needed_cols.add(ts_col)
    union_dicts: dict[str, dict] = {}
    for name in table.column_names:
        if name not in needed_cols:
            continue
        col = table[name]
        typ = col.type
        if pa.types.is_dictionary(typ):
            typ = typ.value_type
        if pa.types.is_string(typ) or pa.types.is_large_string(typ) or pa.types.is_binary(typ):
            mapping = union_dicts.setdefault(name, {})
            if col.type != typ:
                col = col.cast(typ)
            for v in pc.unique(col).to_pylist():
                if v not in mapping:
                    mapping[v] = len(mapping)

    table = table.select([c for c in table.column_names if c in needed_cols])
    batch: TileBatch = tiles_from_table(table, device=device, dicts=union_dicts)
    nulls = {c: batch.nulls[c] for c in value_cols if c in batch.nulls}

    # Encode filter literals to codes; quantize cardinalities.
    enc_filters = []
    for name, op, value in filters:
        if name in union_dicts:
            if op in ("in", "not in"):
                value = tuple(union_dicts[name].get(v, -1) for v in value)
            else:
                value = union_dicts[name].get(value, -1)
        elif op in ("in", "not in"):
            value = tuple(value)
        enc_filters.append((name, op, value))
    tag_cards = tuple(_quantize_card(len(union_dicts.get(t, {}))) for t in group_tags)

    needs_ts = any(f == "last_value" for f, _c in norm_specs)
    plan = DistGroupByPlan(
        group_tags=tuple(group_tags),
        tag_cards=tag_cards,
        bucket_col=bucket_col,
        bucket_origin=bucket_origin,
        bucket_interval=bucket_interval,
        n_buckets=n_buckets,
        agg_specs=tuple(norm_specs),
        filters=tuple(enc_filters),
        ts_col=(ts_col or bucket_col) if needs_ts else None,
    )
    t_tiled = time.perf_counter()
    states = compute_partial_states(plan, batch.columns, batch.valid, nulls)

    per_col_aggs: dict[str, set] = {}
    for func, col in norm_specs:
        per_col_aggs.setdefault(col, set()).add(_FUNC_TO_KERNEL[func])
    presence = states["__presence"].counts
    finals = {
        col: finalize(states[col], tuple(sorted(aggs)), counts=presence)
        for col, aggs in per_col_aggs.items()
        if col in states
    }
    if batch.device.type == "cuda":
        torch.cuda.synchronize(batch.device)
    t_device = time.perf_counter()
    # one device->host copy of the [G]-sized results
    presence_np = presence.cpu().numpy()
    finals = {c: {k: v.cpu().numpy() for k, v in d.items()} for c, d in finals.items()}
    t_read = time.perf_counter()
    non_empty = presence_np > 0
    outputs: dict[str, np.ndarray] = {}
    for func, col in norm_specs:
        out = finals.get(col, {})
        kernel = _FUNC_TO_KERNEL[func]
        arr = out.get(kernel)
        if arr is None and kernel == "count":
            arr = presence_np  # count-pass sharing: presence IS the count
        col_count = out.get("count", presence_np)
        if col == COUNT_STAR:
            outputs["count(*)"] = arr.astype(np.int64)
        elif func == "count":
            outputs[f"count({col})"] = arr.astype(np.int64)
        else:
            # NULL semantics: no non-null values in the group -> NULL output.
            outputs[f"{func}({col})"] = np.where(col_count > 0, arr, np.nan)

    tag_values = {}
    for tag in group_tags:
        mapping = union_dicts.get(tag, {})
        values = [None] * len(mapping)
        for v, code in mapping.items():
            values[code] = v
        tag_values[tag] = values
    timings = {
        "tile": (t_tiled - t_start) * 1e3,
        "device": (t_device - t_tiled) * 1e3,
        "readback": (t_read - t_device) * 1e3,
    }
    return GroupByResult(outputs=outputs, non_empty=non_empty, tag_values=tag_values,
                         plan=plan, timings=timings)
