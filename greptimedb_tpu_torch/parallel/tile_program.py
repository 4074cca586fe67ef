"""The tile program: one query's sources in, one packed result out.

Counterpart of `greptimedb_tpu/parallel/tile_cache.py` `_tile_program`
(`run_all`, `_partial`, the merge, `_device_select`, `_final`).  Per
source (a super-tile chunk or a memtable tail) `compute_partial_states`
runs K1 and K2-K6; the partial states merge pairwise in source order
(chunk order, then the tails), are finalized, optionally filtered by
HAVING (K13) and top-k selected on the card (K7) and packed by K8 into
the reference's result layout:

* dense path: (buf, accs64) — buf holds the int rows (int32, or 1 bit
  per group when G >= 2^14 and no output consumes an exact count), the
  f32 avg rows (G >= 2^14) and the limb verdict byte; accs64 [K, G] the
  f64 rows;
* compact path (a DeviceFinalizeSpec): (buf,) — int rows, f32 rows, the
  selected group ids, the survivor count, the f64 rows as [hi, lo] int32
  words, the verdict byte; every row gathered by the selection;
* hash path: (buf, accs64, table_keys) — the dense layout over the
  [hash_slots] slot rows, buf ending in the overflow byte (1 = some row
  found no slot), and the [hash_slots] int64 key table that every source
  threaded through K17 in source order, for the host's slot -> key decode.
  The byte packing keys off the logical group space, as on the dense
  path, so hash and sort ship the same precision.

There is no jit: PyTorch runs eagerly and the kernels are compiled once
per process (kernels/_build.py), so a "program" is the layout plus the
loop.  Programs are cached per (plan, nullable columns, spec) as in the
reference.
"""

from __future__ import annotations

import functools

import torch

from ..ops.aggregate import (
    HASH_EMPTY,
    HavingRef,
    finalize,
    having_mask,
    having_refs,
    merge_states,
    pack_result,
    topk_group_select,
)
from .executor import COUNT_STAR, DistGroupByPlan, _FUNC_TO_KERNEL, compute_partial_states


def limb_sum_cols(plan: DistGroupByPlan) -> list[str]:
    """Value columns whose sum/avg rides the limb kernels (K5/K6)."""
    if plan.acc_dtype != "limb":
        return []
    per: dict[str, set] = {}
    for f, c in plan.agg_specs:
        per.setdefault(c, set()).add(_FUNC_TO_KERNEL[f])
    return [
        c for c, aggs in per.items()
        if c != COUNT_STAR and "last" not in aggs and aggs & {"sum", "avg"}
    ]


class TileProgram:
    """Layouts of one (plan, nullable columns, spec) and its `run_all`."""

    def __init__(self, plan: DistGroupByPlan, nullable_cols: tuple[str, ...], spec=None):
        self.plan = plan
        self.nullable_cols = nullable_cols
        self.spec = spec
        self.is_hash = plan.agg_strategy == "hash"
        if self.is_hash and spec is not None:
            raise ValueError("a hash plan has no device-finalize spec")
        per_col_aggs: dict[str, set] = {}
        for func, col in plan.agg_specs:
            per_col_aggs.setdefault(col, set()).add(_FUNC_TO_KERNEL[func])
        self.per_col_aggs = per_col_aggs
        pack_bytes = plan.num_groups >= 1 << 14 and spec is None
        int_layout: list[tuple[str, str]] = [("__presence", "count")]
        acc32_layout: list[tuple[str, str]] = []
        acc64_layout: list[tuple[str, str]] = []
        for col, aggs in per_col_aggs.items():
            for agg in sorted(aggs):
                if agg == "count":
                    continue  # count rides the int rows (or presence)
                target = acc32_layout if (pack_bytes and agg == "avg") else acc64_layout
                target.append((col, agg))
            # a per-column count row ships only when the column carries its
            # own null-gated count; otherwise presence substitutes exactly
            if col in nullable_cols and col != COUNT_STAR:
                int_layout.append((col, "count"))
        needs_exact_counts = any(_FUNC_TO_KERNEL[f] == "count" for f, _c in plan.agg_specs)
        self.int_layout = tuple(int_layout)
        self.acc32_layout = tuple(acc32_layout)
        self.acc64_layout = tuple(acc64_layout)
        self.bit_packed = pack_bytes and not needs_exact_counts
        # columns whose sums carry a quantization-error bound: the result
        # ends in a verdict byte, and the caller reruns in f64 on 0
        self.limb_err_cols = limb_sum_cols(plan)
        # avg is computed by K8; before it only for an ORDER BY key of K7
        # or a HAVING ref of K13
        refs = [ref for ref, _asc, _nf in (spec.order if spec is not None else ())]
        if spec is not None and spec.having is not None:
            refs += having_refs(spec.having)
        self.key_avg_cols = frozenset(
            ref[1] for ref in refs if ref[0] != "dim" and ref[2] == "avg"
        )

    # -- the pieces ----------------------------------------------------------
    def partial(self, cols, valid, nulls, dyn, limbs, hash_table=None):
        return compute_partial_states(
            self.plan, cols, valid, nulls, dyn=dyn, count_cols=self.nullable_cols, limbs=limbs,
            hash_table=hash_table,
        )

    @staticmethod
    def merge(a: dict, b: dict) -> dict:
        return {k: merge_states(a[k], b[k]) for k in a}

    def _counts_of(self, merged, col, presence):
        st = merged.get(col)
        return st.counts if st is not None and st.counts is not None else presence

    def device_select(self, merged, outs, presence, having_values=()):
        """HAVING (K13) ANDed with presence > 0, then ORDER BY keys over
        the finalized states -> K7.  Returns (sel int32 [cap], n_out
        int32 [1])."""
        plan, spec = self.plan, self.spec
        g = presence.shape[0]
        dims = list(plan.tag_cards)
        if plan.bucket_col is not None:
            dims.append(plan.n_buckets)

        def ref_planes(ref) -> HavingRef:
            """What a HAVING or ORDER BY ref reads.  Dim refs decode from
            the group id (tag codes are value-sorted, NULL last, so code
            order is SQL-default order); agg refs read the finalized
            outputs with the count > 0 NULL gate the host applies, and the
            host's NULL for a NaN output."""
            if ref[0] == "dim":
                div = 1
                for c in dims[ref[1] + 1:]:
                    div *= c
                return HavingRef(div=div, card=dims[ref[1]])
            _kind, col, agg = ref
            if col == COUNT_STAR or col not in merged:
                return HavingRef(values=presence)
            counts = merged[col].counts
            if agg == "count":
                return HavingRef(values=counts if counts is not None else presence)
            return HavingRef(values=outs[col][agg], counts=counts, nan_null=True)

        if spec.having is not None:
            refs = {ref: ref_planes(ref) for ref in having_refs(spec.having)}
            hv = torch.tensor(having_values or (0.0,), dtype=torch.float64)
            mask = having_mask(spec.having, refs, hv, presence)
        else:
            mask = presence > 0
        order_keys = []
        for ref, asc, nulls_first in spec.order:
            v, isn = ref_planes(ref).resolve(g, presence.device)
            order_keys.append((v, isn, asc, nulls_first))
        return topk_group_select(mask, order_keys, spec.cap)

    def final(self, merged, having_values=(), table_keys=None):
        presence = merged["__presence"].counts
        outs = {"__presence": {"count": presence}}
        for col, aggs in self.per_col_aggs.items():
            if col in merged:
                if col not in self.key_avg_cols:
                    aggs = aggs - {"avg"}
                outs[col] = finalize(merged[col], tuple(sorted(aggs)), counts=presence)
        sel = n_out = None
        if self.spec is not None:
            sel, n_out = self.device_select(merged, outs, presence, having_values)

        def int_row(col):
            return presence if col == "__presence" else merged[col].counts

        def f64_row(col, agg):
            if agg == "avg":
                return ("avg", merged[col].sums, self._counts_of(merged, col, presence))
            return ("value", outs[col][agg])

        verdict = None
        if self.limb_err_cols:
            verdict = [
                (merged["__limb_err:" + c].sums, merged[c].sums) for c in self.limb_err_cols
            ]
        packed = pack_result(
            [int_row(col) for col, _agg in self.int_layout],
            [(merged[col].sums, self._counts_of(merged, col, presence))
             for col, _agg in self.acc32_layout],
            [f64_row(col, agg) for col, agg in self.acc64_layout],
            self.bit_packed, sel=sel, n_out=n_out, verdict_rows=verdict,
            overflow=merged["__hash_overflow"].counts if self.is_hash else None,
        )
        return (*packed, table_keys) if self.is_hash else packed

    def run_all(self, sources, dyn):
        """sources: (cols, valid, nulls, limbs) per chunk/tail, merged in
        order; dyn: the runtime literals and bucket geometry.  A hash plan
        threads one key table through the sources, in source order."""
        pdyn = {k: dyn[k] for k in ("filter_values", "bucket_origin", "bucket_interval")}
        merged = None
        table_keys = None
        for cols, valid, nulls, limbs in sources:
            if self.is_hash:
                if table_keys is None:
                    table_keys = torch.full((self.plan.hash_slots,), HASH_EMPTY,
                                            dtype=torch.int64, device=valid.device)
                states, table_keys = self.partial(cols, valid, nulls, pdyn, limbs, table_keys)
            else:
                states = self.partial(cols, valid, nulls, pdyn, limbs)
            merged = states if merged is None else self.merge(merged, states)
        if merged is None:
            raise ValueError("tile program received no sources")
        return self.final(merged, dyn.get("having_values", ()), table_keys)


@functools.lru_cache(maxsize=256)
def tile_program(plan: DistGroupByPlan, nullable_cols: tuple[str, ...], spec=None) -> TileProgram:
    return TileProgram(plan, nullable_cols, spec)
