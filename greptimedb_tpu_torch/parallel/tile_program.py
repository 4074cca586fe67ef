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
reference.  The values that change from one run of a program to the next
(each source's K1 literal table — [bucket origin, interval, filter
literals] — and the HAVING literals) are encoded on the host
(`TileProgram.encode_inputs`) and read by the kernels from ONE int64
device buffer, uploaded without a sync before the first launch; nothing
between that upload and the readback reads the device on the host.

`mesh_run` is the multi-device form (`tile.mesh_devices`, the reference's
`_mesh_run`, `_mesh_merge_program`, `_mesh_hash_cross_program`): the
sources split into contiguous runs of one shape; within a run each mesh
slot computes the partial states of its sources (`TileProgram.partial`,
on the slot's device) and K22 folds them on the first slot, every state
key in one launch (`fold_state_dicts`, reading the partials where they
lie); runs merge pairwise in run order, and `final` runs once on the first
slot.

`TickProgram` is B19, the reference's `_mega_program`
(greptimedb_tpu/parallel/tile_cache.py:3325): the members of a dashboard
tick — N distinct warm queries over one table — as one program.  On the
card the first tick of a member multiset captures every member's
`run_with`, back to back, and the copy of all their packed leaves into
one slab, into a `torch.cuda.CUDAGraph`; each later tick writes its
literals into the graph's static input buffer (one host -> device copy)
and replays it (one dispatch), then reads the slab back (one copy).  On
the CPU the same plumbing runs eagerly over the same static buffers.
"""

from __future__ import annotations

import contextlib
import functools
import time

import numpy as np
import torch

from ..ops.aggregate import (
    HASH_EMPTY,
    AggState,
    HavingRef,
    finalize,
    fold_state_dicts,
    hash_group_slots,
    having_mask,
    having_refs,
    invert_slot_maps,
    merge_states,
    pack_result,
    topk_group_select,
)
from ..ops.filter import literal_specs, literal_table
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
        self.having_ref_list = ()
        if spec is not None and spec.having is not None:
            self.having_ref_list = tuple(having_refs(spec.having))
            refs += self.having_ref_list
        self.key_avg_cols = frozenset(
            ref[1] for ref in refs if ref[0] != "dim" and ref[2] == "avg"
        )

    # -- the pieces ----------------------------------------------------------
    def partial(self, cols, valid, nulls, dyn, limbs, hash_table=None):
        return compute_partial_states(
            self.plan, cols, valid, nulls, dyn=dyn, count_cols=self.nullable_cols, limbs=limbs,
            hash_table=hash_table,
        )

    # -- the dynamic inputs ----------------------------------------------------
    def _filter_meta(self, cols, dyn) -> list:
        return [(cols[name].dtype, op, v)
                for (name, op, _arity), v in zip(self.plan.filters, dyn["filter_values"])]

    def encode_inputs(self, sources, dyn) -> tuple[tuple, np.ndarray]:
        """(signature, int64 [m]): the literals a run reads from the
        device — per source its K1 literal table, then the HAVING literals
        as f64 bits (at least one).  The signature is their structure (per
        source the literal specs, the HAVING count): two runs with equal
        signatures read the same layout, so a captured graph replays the
        second from a rewrite of the buffer."""
        origin, interval = int(dyn["bucket_origin"]), int(dyn["bucket_interval"])
        if self.plan.bucket_col is not None and interval == 0:
            raise ValueError("time bucket interval must be non-zero")
        parts, sig = [], []
        for cols, _valid, _nulls, _limbs in sources:
            meta = self._filter_meta(cols, dyn)
            sig.append(literal_specs(meta))
            parts.append(literal_table(meta, origin, interval))
        having = tuple(dyn.get("having_values", ())) or (0.0,)
        parts.append(np.asarray(having, np.float64).view(np.int64).tolist())
        sig.append(len(having))
        return tuple(sig), np.asarray([x for p in parts for x in p], np.int64)

    def _input_views(self, sources, dyn, inputs):
        """Per source its literal table, and the HAVING literals: views of
        `inputs`, the device buffer laid out by `encode_inputs`."""
        views, off = [], 0
        for cols, _valid, _nulls, _limbs in sources:
            n = 2 + sum(c for *_x, c in literal_specs(self._filter_meta(cols, dyn)))
            views.append(inputs[off: off + n])
            off += n
        return views, inputs[off:].view(torch.float64)

    @staticmethod
    def merge(a: dict, b: dict) -> dict:
        return {k: merge_states(a[k], b[k]) for k in a}

    def _counts_of(self, merged, col, presence):
        st = merged.get(col)
        return st.counts if st is not None and st.counts is not None else presence

    def device_select(self, merged, outs, presence, hv):
        """HAVING (K13) ANDed with presence > 0, then ORDER BY keys over
        the finalized states -> K7.  The refs go to the kernels as the
        states hold them (K7 reads presence > 0 itself where there is no
        HAVING), so nothing else runs on the card.  Returns (sel int32
        [cap], n_out int32 [1])."""
        plan, spec = self.plan, self.spec
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

        mask = presence
        if spec.having is not None:
            refs = {ref: ref_planes(ref) for ref in self.having_ref_list}
            mask = having_mask(spec.having, refs, hv, presence)
        order_keys = [(ref_planes(ref), asc, nulls_first) for ref, asc, nulls_first in spec.order]
        return topk_group_select(mask, order_keys, spec.cap)

    def final(self, merged, hv, table_keys=None):
        presence = merged["__presence"].counts
        outs = {"__presence": {"count": presence}}
        for col, aggs in self.per_col_aggs.items():
            if col in merged:
                if col not in self.key_avg_cols:
                    aggs = aggs - {"avg"}
                outs[col] = finalize(merged[col], tuple(sorted(aggs)), counts=presence)
        sel = n_out = None
        if self.spec is not None:
            sel, n_out = self.device_select(merged, outs, presence, hv)

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

    def upload_inputs(self, sources, dyn, dev):
        """`encode_inputs` of `sources` as one int64 buffer on `dev`."""
        from ..kernels._build import upload_table

        _sig, enc = self.encode_inputs(sources, dyn)
        if dev.type == "cpu":
            return torch.from_numpy(enc)
        return upload_table(enc.tolist(), dev)

    def run_all(self, sources, dyn):
        """sources: (cols, valid, nulls, limbs) per chunk/tail, merged in
        order; dyn: the runtime literals and bucket geometry, encoded and
        uploaded in one buffer before the first launch."""
        dev = sources[0][1].device if sources else torch.device("cpu")
        sources = [source_on(src, dev) for src in sources]
        return self.run_with(sources, dyn, self.upload_inputs(sources, dyn, dev))

    def run_with(self, sources, dyn, inputs):
        """`run_all` over `inputs`, the int64 buffer `encode_inputs` laid
        out (on the sources' device).  `dyn` gives only the structure of
        the literals.  A hash plan threads one key table through the
        sources, in source order."""
        if not sources:
            raise ValueError("tile program received no sources")
        lits, hv = self._input_views(sources, dyn, inputs)
        pdyn = {k: dyn[k] for k in ("filter_values", "bucket_origin", "bucket_interval")}
        merged = None
        table_keys = None
        for (cols, valid, nulls, limbs), src_lits in zip(sources, lits):
            sdyn = dict(pdyn, lits=src_lits)
            if self.is_hash:
                if table_keys is None:
                    table_keys = torch.full((self.plan.hash_slots,), HASH_EMPTY,
                                            dtype=torch.int64, device=valid.device)
                states, table_keys = self.partial(cols, valid, nulls, sdyn, limbs, table_keys)
            else:
                states = self.partial(cols, valid, nulls, sdyn, limbs)
            merged = states if merged is None else self.merge(merged, states)
        return self.final(merged, hv, table_keys)


def source_on(src, dev):
    """A (cols, valid, nulls, limbs) source with every tensor on `dev` (the
    source itself when it already is)."""
    cols, valid, nulls, limbs = src
    if valid.device == dev and all(t.device == dev for t in cols.values()):
        return src
    return ({k: v.to(dev) for k, v in cols.items()}, valid.to(dev),
            {k: v.to(dev) for k, v in nulls.items()},
            {k: (lb.to(dev), sc.to(dev)) for k, (lb, sc) in limbs.items()})


# ---- the mesh run (tile.mesh_devices) ------------------------------------------------
#
# The reference's order contract (tile_cache.py:3378-3396): counts add and
# min/max take order statistics, while float sums and LAST states fold in
# GLOBAL SOURCE ORDER, the single-device left fold, so a 1-slot mesh, an
# N-slot mesh and the single-device dispatch give the same bytes.  K22
# (`fold_state_dicts`) does every fold, one launch per merge.


class MeshIneligible(Exception):
    """A query shape the mesh run does not express: the single-device
    dispatch answers it (a shape verdict, never an error)."""


def _source_sig(src) -> tuple:
    def sig(t):
        return tuple(t.shape), str(t.dtype)

    cols, valid, nulls, limbs = src
    return (tuple((k, sig(v)) for k, v in sorted(cols.items())), sig(valid),
            tuple((k, sig(v)) for k, v in sorted(nulls.items())),
            tuple((k, sig(lb), sig(sc)) for k, (lb, sc) in sorted(limbs.items())))


def mesh_runs(sources, slots) -> list[list[tuple]]:
    """Contiguous runs of sources of one structure and shape, as
    (source, slot) pairs (the reference's `_mesh_runs`)."""
    runs, last = [], None
    for src, slot in zip(sources, slots):
        sig = _source_sig(src)
        if runs and sig == last:
            runs[-1].append((src, slot))
        else:
            runs.append([(src, slot)])
            last = sig
    return runs


def mesh_positions(run, n_dev: int, n_local: int) -> list[tuple[int, int]]:
    """(slot, local index) of each source of a run: its placed slot while
    that slot has room, else the least loaded slot (the reference's
    `_stack_mesh_inputs`)."""
    counts = [0] * n_dev
    out = []
    for _src, slot in run:
        d = slot if slot is not None and 0 <= slot < n_dev else None
        if d is None or counts[d] >= n_local:
            d = min(range(n_dev), key=lambda i: (counts[i], i))
        out.append((d, counts[d]))
        counts[d] += 1
    return out


def _dummy_of(src, dev):
    """An all-invalid source of `src`'s shapes on `dev` (identity states)."""
    cols, valid, nulls, limbs = src
    return ({k: torch.zeros_like(v, device=dev) for k, v in cols.items()},
            torch.zeros_like(valid, device=dev),
            {k: torch.zeros_like(v, device=dev) for k, v in nulls.items()},
            {k: (torch.zeros_like(lb, device=dev), torch.zeros_like(sc, device=dev))
             for k, (lb, sc) in limbs.items()})


def on_device(dev):
    """The slot's device as the current one: a kernel is launched in the
    current device's context, on its operands' device's stream."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _fold_run(program, run, devices, dyn):
    """One run over the mesh: (merged states, union key table or None, hv).
    Each slot computes its sources' partials (and its dummies') on its
    device; K22 folds them on the first slot, every key in one launch."""
    n_dev = len(devices)
    n_local = -(-len(run) // n_dev)
    positions = mesh_positions(run, n_dev, n_local)
    local: list[list] = [[None] * n_local for _ in range(n_dev)]
    for (src, _slot), (d, l) in zip(run, positions):
        local[d][l] = source_on(src, devices[d])
    template = run[0][0]
    pdyn = {k: dyn[k] for k in ("filter_values", "bucket_origin", "bucket_interval")}
    states, tables, hv = [], [], None
    for d, dev in enumerate(devices):
        srcs = [s if s is not None else _dummy_of(template, dev) for s in local[d]]
        with on_device(dev):
            lits, slot_hv = program._input_views(srcs, dyn, program.upload_inputs(srcs, dyn, dev))
            if d == 0:
                hv = slot_hv  # the HAVING literals, on the first slot
            table = None
            if program.is_hash:
                table = torch.full((program.plan.hash_slots,), HASH_EMPTY, dtype=torch.int64,
                                   device=dev)
            for (cols, valid, nulls, limbs), src_lits in zip(srcs, lits):
                sdyn = dict(pdyn, lits=src_lits)
                if program.is_hash:
                    st, table = program.partial(cols, valid, nulls, sdyn, limbs, table)
                else:
                    st = program.partial(cols, valid, nulls, sdyn, limbs)
                states.append(st)
            tables.append(table)
    dev0 = devices[0]
    order = [d * n_local + l for d, l in positions]
    if not program.is_hash:
        return fold_state_dicts(states, n_local, order, dev=dev0), None, hv
    return (*_keyed_fold(program.plan.hash_slots, states, tables, n_local, order, dev0), hv)


def _keyed_fold(h, states, tables, n_local, order, dev0):
    """Hash plans: union the slot tables through K17 on the first slot,
    invert each slot's map (K22's first launch) and fold every key through
    it in one more (K22, keyed; `__hash_overflow` dense, plus the union's
    overflow).  `states` holds the per-source state dicts
    (slot-major, n_local a slot); `tables` one [h] key table per slot.
    Returns (merged states, union keys)."""
    keys = torch.cat([t.to(dev0) for t in tables])
    union = torch.full((h,), HASH_EMPTY, dtype=torch.int64, device=dev0)
    union, slots, overflow = hash_group_slots(union, keys, keys != HASH_EMPTY)
    inv = invert_slot_maps(slots.reshape(len(tables), h))
    merged = fold_state_dicts(states, n_local, order, inv=inv, dev=dev0,
                              dense_keys=("__hash_overflow",))
    total = merged["__hash_overflow"].counts
    merged["__hash_overflow"] = AggState(counts=total + overflow.to(total.dtype).reshape(1))
    return merged, union


def mesh_run(program: "TileProgram", sources, slots, dyn, devices):
    """The query's sources over the mesh `devices` (the first
    tile.mesh_devices slots): one fold per shape run, runs merged pairwise
    in run order (K22 again: the reference's `merge_states` for dense
    states, a keyed union for hash plans), then `final` once on the first
    slot.  `slots` gives each source's placed slot (None: unplaced).
    Returns the packed result as `run_all` does."""
    plan = program.plan
    if program.is_hash and any(_FUNC_TO_KERNEL[f] == "last" for f, _c in plan.agg_specs):
        raise MeshIneligible("LAST states have no keyed merge")
    if not sources:
        raise ValueError("mesh program received no sources")
    dev0 = devices[0]
    merged = keys = hv = None
    for run in mesh_runs(sources, slots):
        states, run_keys, run_hv = _fold_run(program, run, devices, dyn)
        hv = run_hv if hv is None else hv
        if merged is None:
            merged, keys = states, run_keys
        elif program.is_hash:
            merged, keys = _keyed_fold(plan.hash_slots, [merged, states], [keys, run_keys],
                                       1, [0, 1], dev0)
        else:
            merged = fold_state_dicts([merged, states], 2, [0, 1], dev=dev0)
    with on_device(dev0):
        return program.final(merged, hv, keys)


@functools.lru_cache(maxsize=256)
def tile_program(plan: DistGroupByPlan, nullable_cols: tuple[str, ...], spec=None) -> TileProgram:
    return TileProgram(plan, nullable_cols, spec)


def _leaf_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.uint8).reshape(-1)


class TickProgram:
    """B19: the members of one dashboard tick as one program.

    `members` are (TileProgram, sources, dyn) in the tick's canonical
    order; their sources (planes, null masks, limbs, time-major copies,
    memtable tails) are held here for as long as the program lives, so a
    replay never reads a freed plane.  The static input buffer holds the
    members' `encode_inputs` back to back.  `run(encodings)` writes a
    tick's encodings into it (one host -> device copy from a pinned
    buffer), runs every member (on the card: one `CUDAGraph.replay()`),
    and reads every member's packed leaves back in one copy of the slab;
    it returns per member its leaves as numpy arrays, in the order
    `run_all` returns them.  The first run on the card captures the graph
    (`capture_ms`, `pool_bytes`: what the graph's private pool took)."""

    # descriptor tables of every launch the graph holds (kernels/_build.py)
    _ARENA_BYTES = 1 << 20

    def __init__(self, members, device):
        self.members = list(members)
        self.device = torch.device(device)
        sizes = [len(p.encode_inputs(src, dyn)[1]) for p, src, dyn in self.members]
        self.offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        total = int(self.offsets[-1])
        self.static_in = torch.zeros(total, dtype=torch.int64, device=self.device)
        self.host_in = torch.zeros(total, dtype=torch.int64)
        if self.device.type == "cuda":
            self.host_in = self.host_in.pin_memory()
        self.graph = None
        self.arena = None
        self.slab = None
        self.host_out = None
        self.layout: list[list[tuple]] = []  # per member (offset, nbytes, dtype, shape)
        self.capture_ms = 0.0
        self.pool_bytes = 0
        self.runs = 0
        self.readbacks = 0
        self.last_stage_ms: dict[str, float] = {}

    @property
    def readback_bytes(self) -> int:
        """Bytes of the one slab a run reads back."""
        return sum(nb for mine in self.layout for _off, nb, _dt, _sh in mine)

    def bytes_moved(self) -> int:
        """The least traffic of a run: every source tensor each member
        reads, once per member, and the slab written once."""
        total = self.readback_bytes
        for _prog, sources, _dyn in self.members:
            for cols, valid, nulls, limbs in sources:
                tensors = [valid, *cols.values(), *nulls.values()]
                tensors += [t for pair in limbs.values() for t in pair]
                total += sum(t.numel() * t.element_size() for t in tensors)
        return total

    @property
    def nbytes(self) -> int:
        """What the program keeps on the card beyond its sources."""
        return int(self.pool_bytes + self.static_in.numel() * 8
                   + (0 if self.arena is None else self.arena.device.numel()))

    def run_members(self):
        """Every member's `run_with` over the static input buffer, back to
        back (what the graph holds; eagerly, the plain form of a replay)."""
        outs = []
        for (prog, sources, dyn), lo, hi in zip(self.members, self.offsets[:-1],
                                                self.offsets[1:]):
            outs.append(prog.run_with(sources, dyn, self.static_in[int(lo):int(hi)]))
        return outs

    def _slab_of(self, outs) -> torch.Tensor:
        """Every member's leaves as one byte slab, and their layout."""
        parts, layout, off = [], [], 0
        for leaves in outs:
            mine = []
            for t in leaves:
                b = _leaf_bytes(t)
                mine.append((off, int(b.numel()), t.dtype, tuple(t.shape)))
                off += int(b.numel())
                parts.append(b)
            layout.append(mine)
        self.layout = layout
        return torch.cat(parts) if parts else torch.zeros(0, dtype=torch.uint8,
                                                          device=self.device)

    def _capture(self):
        from ..kernels._build import TableArena

        dev = self.device
        torch.cuda.synchronize(dev)
        before = torch.cuda.memory_stats(dev).get("reserved_bytes.all.current", 0)
        t0 = time.perf_counter()
        self.arena = TableArena(self._ARENA_BYTES, dev)
        graph = torch.cuda.CUDAGraph()
        # thread_local: other threads' queries keep running (and syncing)
        # while this one captures
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            with self.arena:
                self.slab = self._slab_of(self.run_members())
        self.arena.commit()
        torch.cuda.synchronize(dev)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.pool_bytes = max(
            torch.cuda.memory_stats(dev).get("reserved_bytes.all.current", 0) - before, 0)
        self.host_out = torch.empty(int(self.slab.numel()), dtype=torch.uint8).pin_memory()
        self.graph = graph

    def run(self, encodings) -> list[tuple]:
        """One tick: the members' encodings in, their fetched leaves out."""
        t0 = time.perf_counter()
        host = self.host_in.numpy()
        for enc, lo, hi in zip(encodings, self.offsets[:-1], self.offsets[1:]):
            host[int(lo):int(hi)] = enc
        stages = {}
        if self.device.type == "cuda":
            self.static_in.copy_(self.host_in, non_blocking=True)
            if self.graph is None:
                self._capture()
                stages["capture"] = self.capture_ms
            t1 = time.perf_counter()
            self.graph.replay()
            torch.cuda.synchronize(self.device)
            stages["replay"] = (time.perf_counter() - t1) * 1e3
            t1 = time.perf_counter()
            self.host_out.copy_(self.slab, non_blocking=True)
            torch.cuda.synchronize(self.device)
            fetched = self.host_out.numpy()
        else:
            self.static_in.copy_(self.host_in)
            t1 = time.perf_counter()
            slab = self._slab_of(self.run_members())
            stages["replay"] = (time.perf_counter() - t1) * 1e3
            t1 = time.perf_counter()
            fetched = slab.numpy()
        self.readbacks += 1
        self.runs += 1
        stages["readback"] = (time.perf_counter() - t1) * 1e3
        out = []
        for mine in self.layout:
            out.append(tuple(
                fetched[off: off + nb].view(np_dtype(dtype)).reshape(shape).copy()
                for off, nb, dtype, shape in mine
            ))
        stages["total"] = (time.perf_counter() - t0) * 1e3
        self.last_stage_ms = stages
        return out


def np_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch dtype."""
    return torch.empty(0, dtype=dtype).numpy().dtype
