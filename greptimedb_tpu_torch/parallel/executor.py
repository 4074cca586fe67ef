"""Group-by execution over region tables on the mesh's device slots.

Counterpart of `greptimedb_tpu/parallel/executor.py`: region tables go to
D slots, each slot computes its partial states on its device, and the
partials fold in slot order on the first slot, every key in one launch
(K22, `ops/aggregate.py::fold_state_dicts`, in place of the reference's
shard_map + `psum_states` collectives).  The host side is kept as it was:
  - union tag dictionaries across region tables, in order of first
    appearance, so codes — hence group ids and row order — match the
    reference;
  - quantize tag cardinalities to powers of two (`_quantize_card`);
  - decode finalized group ids back to (tags..., bucket timestamp) rows.

`compute_partial_states` is the lower/state stage shared with the tile
program (parallel/tile_program.py): K1 (mask + group ids) then K2/K3/K4
(segment reductions), with the reference's count-pass sharing and
presence fusing; with `plan.acc_dtype == "limb"` sum/avg columns ride
K5/K6 (limb digit planes) instead, and a hierarchical layout folds its
states down to the group tags.  A hash plan (`plan.agg_strategy ==
"hash"`) composes int64 ids (K1's int64 mode), places them in the slot
table threaded through the query's sources (K17) and reduces over the
[hash_slots] slot ids on K3.  It has no `perm`: a time-major plan
(`plan.time_major`) is handed the ts-ascending copies of its planes,
which the tile cache gathered once.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import torch

from ..ops.aggregate import (
    BLOCK_ROWS,
    _FAST_MIN_ROWS,
    AggState,
    finalize,
    fold_state_dicts,
    hash_group_slots,
    limb_segment_sums,
    quantize_limbs,
    reduce_state_axes,
    segment_aggregate,
    segment_aggregate_multi,
    segment_sums_scatter,
)
from ..ops.filter import mask_gids
from ..ops.tiles import TileBatch, pad_rows, tiles_from_table

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
    # "float64" (K2/K3) or "limb" (sum/avg through K5/K6, the tile path)
    acc_dtype: str = "float64"
    # Hierarchical grouping: when the group tags are not a primary-key
    # prefix in pk order, ids are composed over this pk prefix (+ bucket
    # last), which the (pk, ts) sort keeps clustered, and the states fold
    # down to `group_tags` (ops/aggregate.py reduce_state_axes).
    layout_tags: tuple[str, ...] | None = None
    layout_cards: tuple[int, ...] = ()
    # Bucket-only group-bys on the tile path reduce over ts-ascending
    # copies of the planes (tile_planes.py `ensure_time_major`), whose
    # 4096-row blocks each span about one bucket
    time_major: bool = False
    # Device group-by strategy (the `agg_strategy` planner pass): "sort" =
    # the dense mixed-radix path above (states are [G]); "hash" = int64
    # group ids placed in a `hash_slots`-sized table (K17) threaded through
    # every source of the query, states are [hash_slots] and the host
    # decodes slot -> group key from the table — the dense [G] space never
    # materializes, so group spaces far past the dense bound still run.
    agg_strategy: str = "sort"
    hash_slots: int = 0

    @property
    def num_groups(self) -> int:
        """Output group-space size (the [G] the caller sees)."""
        g = 1
        for c in self.tag_cards:
            g *= c
        if self.bucket_col is not None:
            g *= self.n_buckets
        return g

    @property
    def internal_groups(self) -> int:
        """Stage-1 group-space size (= num_groups unless hierarchical)."""
        if self.layout_tags is None:
            return self.num_groups
        g = 1
        for c in self.layout_cards:
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


def compute_partial_states(plan: DistGroupByPlan, columns, valid, nulls, dyn=None,
                           count_cols=None, limbs=None, hash_table=None):
    """Lower/state stage on one tile: mask -> group ids -> partial AggStates.

    `columns`/`nulls` map names to [n] tensors on one device, `valid` is
    the bool row mask.  `dyn` optionally carries the runtime literals
    {'filter_values', 'bucket_origin', 'bucket_interval'} (the tile path:
    `plan.filters` then holds only their structure).  `count_cols` fixes
    which columns carry their own null-gated count, so every source of a
    multi-source program emits states of one structure (None: decide from
    this tile's nulls).  `limbs` optionally supplies cached K5 planes per
    column (col -> (limbs, scale)); a limb column without one is
    quantized here from its f64 plane.  Returns {value col: AggState,
    "__presence": AggState(counts=...)} plus, in limb mode,
    "__limb_err:<col>" states holding each column's error bound.  A hash
    plan needs `hash_table` (int64 [hash_slots], updated in place) and
    returns (states, hash_table), the states over [hash_slots] slots with
    an "__hash_overflow" state counting the rows that found no slot."""
    is_hash = plan.agg_strategy == "hash"
    if is_hash and hash_table is None:
        raise ValueError("hash agg strategy requires the threaded hash_table")
    gates = [nulls[c] for c in plan.filter_null_cols if c in nulls]
    if dyn is not None:
        filters = [(columns[name], op, v)
                   for (name, op, _arity), v in zip(plan.filters, dyn["filter_values"])]
        origin, interval = dyn["bucket_origin"], dyn["bucket_interval"]
    else:
        filters = [(columns[name], op, v) for name, op, v in plan.filters]
        origin, interval = plan.bucket_origin, plan.bucket_interval
    bucket = None
    if plan.bucket_col is not None:
        bucket = (columns[plan.bucket_col], int(origin), int(interval), plan.n_buckets)
    if plan.layout_tags is not None:
        tags = list(zip(plan.layout_tags, plan.layout_cards))
    else:
        tags = list(zip(plan.group_tags, plan.tag_cards))
    comps = [(columns[t], card) for t, card in tags]
    overflow = None
    lits = None if dyn is None else dyn.get("lits")
    if is_hash:
        # int64 ids: the sparse space may pass int32; only its occupied
        # keys materialize, one per table slot (K1 then K17)
        gid64, mask = mask_gids(valid, filters, gates, comps, bucket, None, dtype=torch.int64,
                                lits=lits)
        hash_table, gids, overflow = hash_group_slots(hash_table, gid64, mask)
        n_internal = plan.hash_slots
    else:
        n_internal = plan.internal_groups
        # K1: padding rows get the max id so they never break clustering;
        # their mask keeps them out of every reduction
        gids, mask = mask_gids(valid, filters, gates, comps, bucket, n_internal - 1, lits=lits)

    ts = None
    if plan.ts_col is not None and plan.ts_col in columns:
        ts = columns[plan.ts_col]

    if plan.layout_tags is not None:
        fold_cards = plan.layout_cards + ((plan.n_buckets,) if plan.bucket_col is not None else ())
        keep_axes = tuple(plan.layout_tags.index(t) for t in plan.group_tags) + (
            (len(plan.layout_tags),) if plan.bucket_col is not None else ()
        )

        def fold(state: AggState) -> AggState:
            return reduce_state_axes(state, fold_cards, keep_axes)
    else:
        def fold(state: AggState) -> AggState:
            return state

    per_col_aggs: dict[str, set] = {}
    for func, col in plan.agg_specs:
        per_col_aggs.setdefault(col, set()).add(_FUNC_TO_KERNEL[func])
    states: dict[str, AggState] = {}
    groups: dict[tuple, list[str]] = {}
    last_presence: str | None = None
    n_rows = valid.shape[0]
    # limb routing is decided from the PLAN (every source of a program
    # must emit states of one structure); sources too small for the limb
    # geometry take segment_sums_scatter, which yields the same tuple
    limb_mode = plan.acc_dtype == "limb"
    limb_fits = n_rows >= _FAST_MIN_ROWS and n_rows % BLOCK_ROWS == 0
    limb_batch: list[tuple[str, bool]] = []  # (col, counted)
    for col, aggs in per_col_aggs.items():
        if "last" in aggs:
            key = tuple(sorted(aggs | {"count"}))
            col_mask = mask & nulls[col] if col in nulls else mask
            if col not in nulls:
                last_presence = col  # its count IS the presence count
            states[col] = fold(segment_aggregate(
                columns[col], gids, n_internal, key, mask=col_mask, ts=ts,
                force_scatter=is_hash,
            ))
            continue
        # Count-pass sharing: a column with NO null mask counts exactly the
        # group presence, so it skips its own count pass.
        if col == COUNT_STAR:
            continue  # presence covers it
        null_gated = (col in count_cols) if count_cols is not None else (col in nulls)
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
        if limb_mode and "sum" in kernel_aggs:
            # sum + null-gated count ride the limb batch; min/max keep K2/K3
            limb_batch.append((col, null_gated))
            kernel_aggs -= {"sum", "count"}
        if kernel_aggs:
            groups.setdefault(tuple(sorted(kernel_aggs)), []).append(col)
    # Presence fusing: a NON-null-gated value column counts exactly the
    # base-mask rows, which IS the group presence — ride its kernel pass.
    # The limb batch carries presence itself.
    presence_from: str | None = None
    if not limb_batch:
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
            vals, gids, n_internal, key, col_masks, mask, force_scatter=is_hash,
        )
        for i, c in enumerate(cols):
            states[c] = fold(multi.row(i))
    if limb_batch:
        count01 = [nulls[c] if (counted and c in nulls) else None for c, counted in limb_batch]
        c01 = count01 if any(counted for _c, counted in limb_batch) else None
        if limb_fits:
            limb_inputs = [
                limbs[c] if limbs is not None and c in limbs else quantize_limbs(columns[c])
                for c, _counted in limb_batch
            ]
            lsums, lerrs, lcounts, lpresence = limb_segment_sums(
                limb_inputs, gids, mask, n_internal, count01=c01,
            )
        else:
            lsums, lerrs, lcounts, lpresence = segment_sums_scatter(
                [columns[c] for c, _counted in limb_batch], gids, mask, n_internal, count01=c01,
            )
        for i, (c, counted) in enumerate(limb_batch):
            st = fold(AggState(sums=lsums[i], counts=lcounts[i] if counted else None))
            prev = states.get(c)
            if prev is not None:  # min/max part from K2/K3
                st = AggState(sums=st.sums, counts=st.counts, mins=prev.mins, maxs=prev.maxs)
            states[c] = st
            # worst-case quantization error per group: merges by addition
            # and folds like a sum; the tile program checks it against |sum|
            states["__limb_err:" + c] = fold(AggState(sums=lerrs[i]))
        states["__presence"] = fold(AggState(counts=lpresence))
    elif presence_from is not None:
        states["__presence"] = AggState(counts=states[presence_from].counts)
    if is_hash:
        # sum-merges across sources like any count; > 0 after the last
        # merge means some row found no slot: the caller reruns dense
        states["__hash_overflow"] = AggState(counts=overflow.reshape(1))
        return states, hash_table
    return states


def fold_partials(partials: list[dict], dev) -> dict[str, AggState]:
    """The table-fed mesh merge: one partial state dict per slot, in slot
    order, gathered on `dev` and folded by K22 with `psum_states`' rules."""
    return fold_state_dicts(partials, 1, range(len(partials)), rule="psum", dev=dev)


def host_last_winners(g, t, v, lexsort_cap: int = 1 << 22):
    """The numpy twin of the `last_value` kernel (K4) for ONE source range:
    one (gid, ts, value) winner per gid present in `g`, the winner being
    the max-ts row, a ts tie going to the LAST row in scan order (K4's
    highest-row-index rule; the layout is (pk, ts, write order) sorted, so
    that is last write wins).

    Rows already in runs (gid non-decreasing, ts non-decreasing within a
    gid run) take the run-boundary path; other rows are put in runs by a
    stable lexsort, which keeps the same tie rule.  Returns None when such
    rows number more than `lexsort_cap` (the caller declines to the device
    path).  Merging across sources is the caller's: fold winners in source
    order, a ts tie going to the later source."""
    if not len(g):
        return g[:0], t[:0], v[:0]
    runs_ok = bool(np.all(g[1:] >= g[:-1])) and bool(
        np.all((g[1:] != g[:-1]) | (t[1:] >= t[:-1])))
    if not runs_ok:
        if len(g) > lexsort_cap:
            return None
        order = np.lexsort((t, g))
        g, t, v = g[order], t[order], v[order]
    ends = np.append(np.flatnonzero(g[1:] != g[:-1]), len(g) - 1)
    return g[ends], t[ends], v[ends]


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


# the table-fed path composes int32 group ids: a padded group space this
# large cannot be addressed (its pad id would overflow)
INT32_GROUP_SPACE = 1 << 31


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
    device="cuda",
    ts_col: str | None = None,
) -> GroupByResult | None:
    """Execute a scan->filter->time-bucketed-groupby over region tables on
    the D device slots `device` (a device, or a sequence of them: the
    reference's mesh of D devices):
    region table i goes to slot i % D, each slot's tables concatenated in
    region order and padded to one size, with the dictionaries unioned in
    slot order.  Each slot computes its partial states on its device; with
    D > 1 they gather on the first slot and fold in slot order (K22, the
    reference's `psum_states`: counts add, min/max take order statistics,
    sums fold left, LAST takes the max value at the max ts).  A slot with
    no table gets an all-invalid source, whose states are the identity.
    Returns None — a decline, before anything is uploaded — when the
    padded group space (the quantized tag cardinalities of the dictionary
    union times the buckets) reaches 2^31, which int32 ids cannot
    address."""
    t_start = time.perf_counter()
    filters = filters or []
    devices = [torch.device(d) for d in
               (device if isinstance(device, (list, tuple)) else (device,))]
    n_dev = len(devices)
    norm_specs: list[tuple[str, str]] = []
    for func, col in agg_specs:
        if func == "count" and col is None:
            col = COUNT_STAR
        norm_specs.append((func, col))

    tables = [t for t in region_tables if t is not None]
    if not tables:
        raise ValueError("no region tables to scan")
    slots: list[list[pa.Table]] = [[] for _ in range(n_dev)]
    for i, t in enumerate(tables):
        slots[i % n_dev].append(t)
    slot_tables = [
        pa.concat_tables(ts, promote_options="permissive") if ts else None for ts in slots
    ]

    # Union tag dictionaries so codes agree globally (first appearance,
    # slot by slot).
    value_cols = [c for _f, c in norm_specs if c != COUNT_STAR]
    needed_cols = set(group_tags) | set(value_cols) | {f[0] for f in filters}
    if bucket_col is not None:
        needed_cols.add(bucket_col)
    if ts_col is not None:
        needed_cols.add(ts_col)
    union_dicts: dict[str, dict] = {}
    for table in slot_tables:
        if table is None:
            continue
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

    tag_cards = tuple(_quantize_card(len(union_dicts.get(t, {}))) for t in group_tags)
    n_b = max(int(n_buckets), 1) if bucket_col is not None else 1
    if math.prod(tag_cards) * n_b >= INT32_GROUP_SPACE:
        return None
    schema = next(t for t in slot_tables if t is not None).schema
    rows = pad_rows(max(t.num_rows for t in slot_tables if t is not None))
    batches: list[TileBatch] = []
    for table, dev in zip(slot_tables, devices):
        if table is None:
            table = schema.empty_table()
        table = table.select([c for c in table.column_names if c in needed_cols])
        batches.append(tiles_from_table(table, device=dev, dicts=union_dicts, rows=rows))
    null_cols = tuple(sorted(c for c in value_cols if any(c in b.nulls for b in batches)))

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
    partials = []
    for b in batches:
        # a column masked in some slot is null-gated in every slot (all
        # present where a slot has no mask), so every partial has one shape
        nulls = {c: b.nulls.get(c, torch.ones_like(b.valid)) for c in null_cols}
        partials.append(compute_partial_states(plan, b.columns, b.valid, nulls,
                                               count_cols=null_cols))
    states = partials[0] if n_dev == 1 else fold_partials(partials, devices[0])

    per_col_aggs: dict[str, set] = {}
    for func, col in norm_specs:
        per_col_aggs.setdefault(col, set()).add(_FUNC_TO_KERNEL[func])
    presence = states["__presence"].counts
    finals = {
        col: finalize(states[col], tuple(sorted(aggs)), counts=presence)
        for col, aggs in per_col_aggs.items()
        if col in states
    }
    if devices[0].type == "cuda":
        for dev in dict.fromkeys(devices):
            torch.cuda.synchronize(dev)
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
