"""The tile executor: a lowered query over the cached super-tiles.

Counterpart of `greptimedb_tpu/parallel/tile_cache.py` `TileExecutor`:
`execute`, `_try_execute_impl`, `_locked_execute` with the cold-serve
ladders, `_encode_mem` (the memtable tail), `_fetch_result`, `_finalize`,
`_decode_result`, the `_assemble_*` helpers, `_mesh_attempt`, the fused
family build (`_fused_*`, `shutdown_fused`) and `prewarm`, for the
configuration the port implements (the "sort" and "hash" strategies, the
mesh of `tile.mesh_devices` slots, the dedup keep plane, window tiles,
the host fast path and the cold host serve of parallel/tile_host.py, the
fused build; no pipelined build, no streamed spill).
A query:

  1. snapshots each region's (files, memtables) and checks that the
     tile path may aggregate raw file rows: no delete tombstones in the
     window and, on a non-append table, no memtable overlapping another
     memtable or a file in the window; a region whose in-window files
     overlap reads the last-write-wins keep plane (`dedup_plane`);
  2. updates the table dictionary with the memtable tails, fetches (or
     builds on the host, or extends by a flushed delta) each region's
     super-tile without uploading, and repairs the code planes a
     dictionary growth moved (`repair_super`);
  3. picks the group-by strategy (`choose_agg_strategy`: hash when the
     padded group space is sparse against the distinct keys) and builds
     the plan and its runtime values (parallel/tile_planner.py); a sort
     plan must fit the dense bounds (`query.max_groups` * 64 output
     groups, `query.max_internal_groups` stage-1 groups).  Over a dense
     output space the host routes come next: the host fast path
     (`host_fast_path`: a pk-equality slice folded with numpy, counted in
     `host_fast_path`), then the cold serve (`cold_host_serve`: a grouped
     aggregate answered from the host consolidation, counted in
     `cold_serves` — under the fused build a family's first touch, with
     its build scheduled; on the legacy ladder a query over planes not
     yet resident, once per entry).  A route that
     answers returns before any upload or launch; only when both decline
     do the entries upload what the host-only build deferred;
  4. runs one tile program over every chunk and tail — of the
     time-major copies for a bucket-only group-by, of the compact window
     tile for a query bounded on both sides (`window_tile`) — (parallel/
     tile_program.py) and reads the packed result back once.  With
     `tile.mesh_devices` > 0 the program runs over the mesh instead
     (`mesh_run`: per-slot partials, K22's fold on the first slot,
     finalize once; counted in `mesh_dispatches`); a shape it does not
     express takes the single-device dispatch, and a failure raises;
  5. decodes it on the host.  A limb verdict of 0 (a group's
     quantization bound above 1e-7 of its sum) reruns the query with
     exact f64 accumulation; a hash overflow verdict (some row found no
     slot) reruns it on the dense plan when the dense bounds allow it,
     and otherwise declines, so the table-fed path answers.  A hash
     result decodes from the slot table: occupied slots in ascending gid
     order, the order of the dense path's rows.

The fused family build (`tile.fused_build` and the `fused_build` pass,
both on by default): a query family (`plan_fp`: the plan without its
literals) touched for the first time answers on a host route — the cold
serve's fused ladder, or the host fast path of a wide slice whose planes
are cold (`wide_cold`) — and records its plane manifest; a background
thread (`_fused_worker`, one for the executor) then runs one union build
of the table's manifests (`TileCacheManager.fused_union_build`, under
`build_gate`) and a ghost run of each queued family: a normal
`execute_direct` inside `fused_build_scope()` whose result is thrown
away, so the family's planes are built and its path primed.  Inside the
scope the host routes decline, the result cache is not probed and no
tick is joined.  A query of a family whose build is in flight waits for
it (`_fused_join`, before any lock).  A failed build never fails a
query: it is counted in `fused_build_errors`, kept in
`last_fused_error` and on the family's record, and the next touch builds
on its own thread.

`execute` returns None when the query does not apply, and the caller
takes the table-fed path.  Before the dispatch path it probes the windowed
result cache (`batch.result_cache_mb`), and a query of a warm family
under `batch.window_ms > 0` joins the table's dashboard tick
(parallel/batcher.py) before the table lock is taken, so the leader's
window sleep never blocks its followers.  A tick's members are captured
at the dispatch site and answered by one `TickProgram` (B19,
`fused_dispatch`), or dispatched back to back with one shared readback.

Per-call state is thread-local (the members of a tick run on their own
threads): `timings` holds the host ms per stage of the calling thread's
last query: build and upload (cold entries only), host (the fold of a
host route that answered; such a query has no later stage), delta_host and
delta_device (a flushed delta merged into a cached entry: host encode
and merge, then the K16 patches through a sync), keep (the dedup keep
plane; near zero once built), window_gather, window_upload and
window_quantize (a window tile's build or extension: host gather,
upload, K5 through a sync), time_major (K14 and the K15 copies through
a sync; near zero once cached), quantize (K5, through a sync; near zero
once the limb planes are cached), plan (everything else before the
dispatch), dispatch (the program through its last sync), readback,
decode.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import threading
import time
from collections import OrderedDict

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import torch

from ..ops.aggregate import unpack_f64_bits
from ..ops.tiles import pad_rows
from ..query import passes
from ..storage.region import OP_COL
from .batcher import (
    CapturedDispatch,
    PendingFetch,
    QueryBatcher,
    WindowedResultCache,
    capture_active,
    defer_active,
    region_versions,
)
from .executor import COUNT_STAR, GroupByResult, _FUNC_TO_KERNEL
from .tile_host import HostRoutes
from .tile_planes import (
    PlaneManifest,
    TileCacheManager,
    TileContext,
    _encode_host_tiles,
    _SuperTiles,
)
from .tile_planner import (
    build_plan,
    choose_agg_strategy,
    choose_layout,
    config_acc_dtype,
    disjoint,
    plan_cols,
)
from .mesh import REGION_AXIS
from .tile_program import (
    MeshIneligible,
    TickProgram,
    limb_sum_cols,
    mesh_run,
    np_dtype,
    on_device,
    tile_program,
)


# ---- the fused family build's thread scope -------------------------------------
# The background builder re-enters the normal execution path to build a
# family's planes and prime its path (the "ghost" run).  Inside the scope
# the host routes decline, so the ghost builds instead of answering from
# the host, and no family build is waited on, so it never waits on itself.
_FUSED_BUILD = threading.local()


@contextlib.contextmanager
def fused_build_scope():
    """Mark the calling thread as the fused background builder."""
    prev = getattr(_FUSED_BUILD, "depth", 0)
    _FUSED_BUILD.depth = prev + 1
    try:
        yield
    finally:
        _FUSED_BUILD.depth = prev


def in_fused_build() -> bool:
    return getattr(_FUSED_BUILD, "depth", 0) > 0


class _FamilyBuild:
    """One family's queued or running build: queries of the family wait on
    `event`; `error` is the build's failure (the waiters proceed and build
    on their own thread: they never inherit it)."""

    __slots__ = ("event", "error")

    def __init__(self):
        self.event = threading.Event()
        self.error = None


@dataclasses.dataclass
class _FusedItem:
    """One queued family build.  A SQL family carries its lowering (a copy:
    the ghost run sets its `post_done`) for `execute_direct`; another
    engine (the TQL tile path) passes `run`, a callable that builds and
    primes its family."""

    fp: tuple
    rec: _FamilyBuild | None
    lowering: object
    schema: object
    time_bounds: object
    ctx: TileContext
    manifest: PlaneManifest
    run: object = None


class _CallState(threading.local):
    """The calling thread's per-query state (see TileExecutor)."""

    def __init__(self):
        self.timings: dict[str, float] = {}
        self.last_strategy: str | None = None
        self.last_hash_overflow = False
        self.last_readback_bytes = 0


def _call_field(name: str):
    return property(lambda self: getattr(self._call, name),
                    lambda self, v: setattr(self._call, name, v))


class Counters(dict):
    """A dict of counters that threads bump under one lock."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.lock = threading.Lock()

    def add(self, **deltas) -> None:
        with self.lock:
            for k, v in deltas.items():
                self[k] = self.get(k, 0) + v


class TileExecutor(HostRoutes):
    """Aggregation over cached device super-tiles; returns None when not
    applicable so the caller can take the table-fed path."""

    # families remembered in each of the fused build's LRUs, and the most
    # family builds queued at once (past it a family takes the legacy
    # ladder)
    _FAMILIES_MAX = 4096
    _FUSED_QUEUE_MAX = 128

    def __init__(self, cache: TileCacheManager, config, batch_config=None, stats=None):
        self.cache = cache
        self.config = config
        self.batch_config = batch_config
        # the engine's counters: limb_reruns, the batch and tick counters
        self.stats = stats if stats is not None else Counters()
        self._call = _CallState()
        self._lock = threading.Lock()
        # the fused family build, per family fingerprint (`plan_fp`):
        # `served` holds families answered on a host route on their first
        # touch (their build scheduled), `done` families whose path is warm
        # (answered without such a serve, or built by a ghost run), `builds`
        # the queued or running build each query of the family waits on
        self._fused_lock = threading.Lock()
        self._fused_served: OrderedDict = OrderedDict()
        self._fused_done: OrderedDict = OrderedDict()
        self._fused_builds: dict = {}
        self._fused_queue: list = []
        self._fused_thread: threading.Thread | None = None
        self._fused_worker_live = False
        self._fused_stop = False
        # the last failure of a background build (counted in the stats'
        # `fused_build_errors`)
        self.last_fused_error: BaseException | None = None
        self._batcher = QueryBatcher(self)
        self.result_cache: WindowedResultCache | None = None
        # tick programs by (member keys, input signatures, source identity),
        # an LRU bounded in bytes out of the tile budget
        self._ticks: OrderedDict = OrderedDict()
        self.cache.plane_listeners.append(self._drop_ticks_of)
        # the tick program of the last tick (diagnostics)
        self.last_tick: TickProgram | None = None

    # the strategy of the calling thread's last query's first dispatched
    # plan ("hash", "sort", or None when it dispatched nothing), whether
    # its hash dispatch overflowed the slot table, and the bytes of its
    # result read back from the device
    timings = _call_field("timings")
    last_strategy = _call_field("last_strategy")
    last_hash_overflow = _call_field("last_hash_overflow")
    last_readback_bytes = _call_field("last_readback_bytes")

    @property
    def limb_reruns(self) -> int:
        """Queries rerun in exact f64 after a failed limb verdict."""
        return self.stats.get("limb_reruns", 0)

    def call_state(self) -> dict:
        """A copy of the calling thread's per-query state."""
        return {"timings": dict(self.timings), "last_strategy": self.last_strategy,
                "last_hash_overflow": self.last_hash_overflow,
                "last_readback_bytes": self.last_readback_bytes}

    def adopt_call(self, call: dict) -> None:
        """Take over per-query state another thread left for this one."""
        for k, v in call.items():
            setattr(self._call, k, v)

    def _reset_call(self) -> None:
        self.adopt_call({"timings": {}, "last_strategy": None, "last_hash_overflow": False,
                         "last_readback_bytes": 0})

    def count(self, **deltas) -> None:
        self.stats.add(**deltas)

    @property
    def device(self) -> torch.device:
        return self.cache.device

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- public entry --------------------------------------------------------
    def execute(self, lowering, schema, time_bounds, ctx: TileContext):
        """The result cache, the batch tick of a warm family, or the solo
        path; a family whose fused build is in flight first waits for it."""
        self._reset_call()
        bc = self.batch_config
        if bc is not None:
            bc.validate()
        ghost = in_fused_build()
        fp = self.plan_fp(lowering, ctx)
        if not ghost and self._fused_enabled():
            # before any lock: the builder takes the table lock
            self._fused_join(fp)
        rc = None if ghost else self._result_cache(bc)
        ck = None
        if rc is not None:
            ck = WindowedResultCache.key_for(fp, lowering, schema, ctx)
            hit = rc.get(ck)
            if hit is not None and region_versions(ctx) != ck[3]:
                # a write landed between the key's snapshot and the probe:
                # the entry may not be purged yet, and must not serve
                hit = None
            if hit is not None:
                table, lowering.post_done = hit
                self.count(result_cache_hits=1)
                return table
        with self._fused_lock:
            warm = fp in self._fused_done
        if bc is not None and bc.window_ms > 0 and warm and not ghost:
            out = self._batcher.submit(lowering, schema, time_bounds, ctx, bc)
        else:
            out = self.execute_direct(lowering, schema, time_bounds, ctx)
        if out is not None:
            with self._fused_lock:
                if fp not in self._fused_served:
                    # answered with no first-touch host serve: the family is
                    # warm (a served one becomes so when its ghost run ends)
                    self._mark_fused_locked(self._fused_done, fp)
            # the dispatch may have read data newer than the key's snapshot
            # (the leader sleeps out the window): store only a current key
            if rc is not None and region_versions(ctx) == ck[3]:
                rc.put(ck, out, lowering.post_done)
        return out

    def _result_cache(self, bc):
        """The executor's WindowedResultCache, made the first time
        `batch.result_cache_mb` is on (None while it is 0)."""
        if bc is None or bc.result_cache_mb <= 0:
            return None
        with self._lock:
            if self.result_cache is None:
                self.result_cache = WindowedResultCache(int(bc.result_cache_mb) << 20)
                self.cache.result_cache = self.result_cache
            return self.result_cache

    @staticmethod
    def plan_fp(lowering, ctx: TileContext):
        """A query family without its literals or data snapshot: the
        filter structure (column, op, arity), the window's shape, the
        group shape, the aggregates and the post-ops.  Slid windows and
        swapped literals stay in the family."""
        scan = lowering.scan
        scan_fp = (
            scan.table, scan.database,
            None if scan.projection is None else tuple(scan.projection),
            tuple((f[0], f[1], len(f[2]) if isinstance(f[2], (list, tuple, set, frozenset))
                   else None) for f in scan.filters),
            scan.time_range is not None and scan.time_range[0] > -(1 << 61),
            scan.time_range is not None and scan.time_range[1] < (1 << 61),
        )
        return (ctx.table_key, ctx.append_mode, repr((
            scan_fp, tuple(lowering.group_tags), lowering.bucket, tuple(lowering.agg_specs),
            lowering.group_exprs, lowering.agg_exprs,
            tuple(TileExecutor._post_op_fp(op) for op in lowering.post_ops),
        )))

    @staticmethod
    def _post_op_fp(op):
        """One post-op's own fields (its input subtree is covered by the
        scan, group and aggregate parts of the key): plan reprs are lossy."""
        return (type(op).__name__, repr({
            f.name: getattr(op, f.name) for f in dataclasses.fields(op) if f.name != "input"
        }))

    @staticmethod
    def family_key(lowering, ctx: TileContext):
        """A query and its data snapshot: two members of a tick with equal
        keys would compute the same bytes, so one answers both."""
        return (ctx.table_key, ctx.append_mode, repr((
            lowering.scan, tuple(lowering.group_tags), lowering.bucket,
            tuple(lowering.agg_specs), lowering.group_exprs, lowering.agg_exprs,
            tuple(TileExecutor._post_op_fp(op) for op in lowering.post_ops),
        )), region_versions(ctx))

    # -- the fused family build -------------------------------------------------
    def _fused_enabled(self) -> bool:
        """`tile.fused_build` and the `fused_build` pass both on."""
        return bool(getattr(self.cache.tile_config, "fused_build", True)
                    and passes.enabled("fused_build", self.config))

    def _mark_fused_locked(self, od: OrderedDict, fp) -> None:
        od[fp] = None
        od.move_to_end(fp)
        while len(od) > self._FAMILIES_MAX:
            od.popitem(last=False)

    def fused_first_touch_fp(self, fp) -> bool:
        """`fp` was never served on a first touch, built nor queued."""
        with self._fused_lock:
            return (fp not in self._fused_served and fp not in self._fused_done
                    and fp not in self._fused_builds)

    def _fused_first_touch(self, lowering, ctx: TileContext) -> bool:
        """The query's family is new: a host route answers it and schedules
        its background build (never inside the builder)."""
        if in_fused_build() or not self._fused_enabled():
            return False
        return self.fused_first_touch_fp(self.plan_fp(lowering, ctx))

    def _fused_join(self, fp) -> None:
        """Wait for the in-flight build of this family, if any (counted in
        `build_coalesced`).  Should it fail, the caller proceeds and builds
        on its own thread."""
        with self._fused_lock:
            rec = self._fused_builds.get(fp)
        if rec is None:
            return
        self.cache.count(build_coalesced=1)
        rec.event.wait()

    def _fused_schedule(self, lowering, schema, time_bounds, ctx: TileContext,
                        manifest: PlaneManifest) -> None:
        """Record the family's manifest and queue its build: the worker's
        union build, then a ghost run of a copy of the lowering."""
        ghost = copy.copy(lowering)
        ghost.post_done = frozenset()
        self._fused_enqueue(_FusedItem(
            fp=self.plan_fp(lowering, ctx), rec=None, lowering=ghost, schema=schema,
            time_bounds=time_bounds, ctx=ctx, manifest=manifest))

    def fused_schedule_custom(self, fp, manifest: PlaneManifest, ctx: TileContext, schema,
                              run) -> None:
        """Queue a family build of another engine (the TQL tile path): the
        same manifest ring and union build, with `run` as the ghost run."""
        self._fused_enqueue(_FusedItem(fp=fp, rec=None, lowering=None, schema=schema,
                                       time_bounds=None, ctx=ctx, manifest=manifest, run=run))

    def _fused_enqueue(self, item: _FusedItem) -> None:
        self.cache.record_manifest(item.manifest)
        start = False
        with self._fused_lock:
            self._mark_fused_locked(self._fused_served, item.fp)
            if (self._fused_stop or item.fp in self._fused_builds
                    or item.fp in self._fused_done
                    or len(self._fused_queue) >= self._FUSED_QUEUE_MAX):
                return
            item.rec = self._fused_builds[item.fp] = _FamilyBuild()
            self._fused_queue.append(item)
            if not self._fused_worker_live:
                self._fused_worker_live = True
                self._fused_thread = threading.Thread(
                    target=self._fused_worker, name="tile-fused-build", daemon=True)
                start = True
        if start:
            self._fused_thread.start()

    def fused_pending(self) -> int:
        """Family builds queued or running (0: the builder is drained)."""
        with self._fused_lock:
            return len(self._fused_builds) + len(self._fused_queue)

    def _fused_failed(self, err: BaseException) -> None:
        self.last_fused_error = err
        self.count(fused_build_errors=1)

    def _fused_worker(self) -> None:
        """The background builder: takes the queued families in batches;
        per table one union build of the ring's manifests and the queued
        ones (under `build_gate`, so a concurrent prewarm or builder leads
        or waits), then each family's ghost run, on the cache's device.  A
        failure is recorded (`_fused_failed`, the family's record) and the
        next build goes on; a family is done only when its ghost run
        succeeded."""
        while True:
            with self._fused_lock:
                items, self._fused_queue = self._fused_queue, []
                if not items or self._fused_stop:
                    self._fused_worker_live = False
                    stopped = self._abandon_locked(items)
                    break
            by_table: dict[str, list] = {}
            for it in items:
                by_table.setdefault(it.ctx.table_key, []).append(it)
            for tkey, group in by_table.items():
                union_err = None
                try:
                    with fused_build_scope(), on_device(self.device):
                        manifests = list(dict.fromkeys(
                            self.cache.family_manifests(tkey) + [it.manifest for it in group]))
                        with self.cache.build_gate(tkey) as leader:
                            if leader:
                                self.cache.fused_union_build(group[0].ctx, group[0].schema,
                                                             manifests)
                except Exception as e:  # recorded; the ghost runs build what it missed
                    union_err = e
                    self._fused_failed(e)
                for it in group:
                    err = None
                    with self._fused_lock:
                        stop = self._fused_stop
                    if stop:
                        err = RuntimeError("fused builder stopped")
                    else:
                        try:
                            with fused_build_scope(), on_device(self.device):
                                if it.run is not None:
                                    it.run()
                                else:
                                    self.execute_direct(it.lowering, it.schema,
                                                        it.time_bounds, it.ctx)
                        except Exception as e:  # recorded; never a query's failure
                            err = e
                            self._fused_failed(e)
                    with self._fused_lock:
                        it.rec.error = err or union_err
                        if err is None:
                            self._mark_fused_locked(self._fused_done, it.fp)
                        self._fused_builds.pop(it.fp, None)
                    it.rec.event.set()
        for it in stopped:
            it.rec.event.set()

    def _abandon_locked(self, items: list) -> list:
        """Drop queued builds (the builder stopping): their records carry an
        error and leave `builds`; the caller wakes their waiters."""
        for it in items:
            it.rec.error = RuntimeError("fused builder stopped")
            self._fused_builds.pop(it.fp, None)
        return items

    def shutdown_fused(self, timeout: float | None = None) -> None:
        """Stop the background builder (Database.close): queued builds are
        abandoned and their waiters woken; a running ghost run ends first
        (up to `timeout` s, None waits for it)."""
        with self._fused_lock:
            self._fused_stop = True
            items, self._fused_queue = self._fused_queue, []
            self._abandon_locked(items)
            t = self._fused_thread
        for it in items:
            it.rec.event.set()
        if t is not None and t.is_alive() and t is not threading.current_thread():
            t.join(timeout)

    def execute_direct(self, lowering, schema, time_bounds, ctx: TileContext):
        """The solo path: one query over the planes, under the table lock.
        In capture mode it returns a CapturedDispatch, in deferred-fetch
        mode a PendingFetch."""
        self._reset_call()
        # refuse an unknown strategy, or more mesh slots than are listed,
        # also when the config was changed after it was built
        self.config.validate()
        if self.cache.tile_config is not None:
            self.cache.tile_config.validate(len(self.cache.devices))
        scan = lowering.scan
        ts_name = schema.time_index.name if schema.time_index else None
        tag_cols = list(lowering.group_tags)
        tag_names = {c.name for c in schema.tag_columns()}
        filter_tag_cols = [
            f[0] for f in scan.filters if f[0] in tag_names and f[0] not in tag_cols
        ]
        value_cols = list(dict.fromkeys(
            [c for _f, c in lowering.agg_specs if c is not None]
            + [f[0] for f in scan.filters if f[0] not in tag_names and f[0] != ts_name]
        ))
        needs_ts = (
            lowering.bucket is not None
            or any(f == "last_value" for f, _ in lowering.agg_specs)
            or scan.time_range is not None
            or any(f[0] == ts_name for f in scan.filters)
        )
        use_ts = ts_name if (needs_ts and ts_name) else None
        pk = [c.name for c in schema.tag_columns()]
        layout_probe = choose_layout(pk, tag_cols, lowering.bucket is not None)
        needs_last = any(f == "last_value" for f, _ in lowering.agg_specs)
        if needs_last and (
            (layout_probe is not None and set(tag_cols) != set(layout_probe))
            or (lowering.bucket is not None and not tag_cols)
        ):
            return None  # LAST states cannot fold away a pk axis
        extra_tag_cols = []
        if layout_probe is not None:
            extra_tag_cols = [
                t for t in layout_probe if t not in tag_cols and t not in filter_tag_cols
            ]
        all_tag_cols = tag_cols + filter_tag_cols + extra_tag_cols
        if any(getattr(r, "merge_mode", "last_row") == "last_non_null" for r in ctx.regions) \
                and not ctx.append_mode:
            return None  # fieldwise merging: the scan path owns it
        pinned: list = []
        with ctx.dictionary.table_lock:
            try:
                return self._locked_execute(
                    lowering, schema, scan, ctx, time_bounds, pinned, ts_name,
                    tag_cols, all_tag_cols, value_cols, use_ts, pk,
                )
            finally:
                for region in pinned:
                    region.unpin_scan()

    def _locked_execute(self, lowering, schema, scan, ctx, time_bounds, pinned, ts_name,
                        tag_cols, all_tag_cols, value_cols, use_ts, pk):
        t_start = time.perf_counter()
        window = scan.time_range

        def in_window(lo: int, hi: int) -> bool:
            if window is None:
                return True
            wlo, whi = window
            return hi >= wlo and lo < whi

        # 1. snapshot + safety gate; the region stays pinned until dispatch
        region_sources = []  # (region, [FileMeta], [mem pa.Table])
        dedup_regions: set[int] = set()  # regions whose in-window files overlap
        for region in ctx.regions:
            region.pin_scan()
            pinned.append(region)
            all_files, mems, version = region.tile_snapshot()
            # drop cached planes of files compaction removed, once per
            # manifest version
            self.cache.invalidate_region_if_changed(
                region.region_id, {m.file_id for m in all_files}, version
            )
            file_ranges, mem_ranges, mem_tables = [], [], []
            for meta in all_files:
                if not in_window(*meta.time_range):
                    continue
                if meta.num_deletes != 0:
                    return None  # tombstones (or unknown): dedup needed
                file_ranges.append(meta.time_range)
            for mem in mems:
                mem_table = mem.scan(None, dedup=not ctx.append_mode)
                if mem_table.num_rows == 0:
                    continue
                if OP_COL in mem_table.column_names:
                    op_rows = mem_table
                    if window is not None and ts_name in mem_table.column_names:
                        ts_i = pc.cast(mem_table[ts_name], pa.int64())
                        op_rows = mem_table.filter(pc.and_(
                            pc.greater_equal(ts_i, window[0]), pc.less(ts_i, window[1])))
                    if op_rows.num_rows and pc.sum(
                        pc.fill_null(pc.cast(op_rows[OP_COL], pa.int64()), 0)
                    ).as_py():
                        return None  # tombstones inside the window
                    mem_table = mem_table.drop_columns([OP_COL])
                if ts_name and ts_name in mem_table.column_names:
                    ts_i = pc.cast(mem_table[ts_name], pa.int64())
                    mlo, mhi = pc.min(ts_i).as_py(), pc.max(ts_i).as_py()
                    if not in_window(mlo, mhi):
                        continue
                    mem_ranges.append((mlo, mhi))
                else:
                    mem_ranges.append((0, 0))
                mem_tables.append(mem_table)
            if not ctx.append_mode:
                # a memtable version of a row beats file versions, and
                # other memtables hold later writes still: a memtable that
                # overlaps another memtable or a file stays on the scan
                # path.  Overlapping files read the keep plane (a region
                # holds each pk, so regions never overlap each other)
                if mem_ranges and not disjoint(mem_ranges + file_ranges):
                    if not disjoint(mem_ranges):
                        return None
                    for mlo, mhi in mem_ranges:
                        if any(fhi >= mlo and flo <= mhi for flo, fhi in file_ranges):
                            return None
                if not disjoint(file_ranges):
                    dedup_regions.add(region.region_id)
            region_sources.append((region, all_files, mem_tables))
        if not any(fs or ms for _r, fs, ms in region_sources):
            return None  # empty table: the normal path shapes the output

        # 2. every dictionary mutation happens before the plan is built:
        # memtable values first, then the per-file host encodes
        for _region, _metas, mem_tables in region_sources:
            for mt in mem_tables:
                ctx.dictionary.update_table(mt, all_tag_cols)
        pinned_ids = {r.region_id for r, _f, _m in region_sources}
        build_t: dict[str, float] = {}
        entries: dict[int, _SuperTiles] = {}

        def fetch(region, metas):
            # host-only: the host routes below may answer without the card
            entry, excluded = self.cache.super_tiles(
                region, ctx.dictionary, metas, all_tag_cols, ts_name or use_ts,
                value_cols, pinned_ids, pk, timings=build_t, device_upload=False,
            )
            if any(in_window(*m.time_range) for m in excluded):
                return False
            if entry is not None:
                entries[region.region_id] = entry
            return True

        for region, metas, _mems in region_sources:
            if metas and not fetch(region, metas):
                return None
        # the dictionary is final for this query: repair the code planes a
        # later growth moved, with one K15 remap each
        self.cache.repair_super(list(entries.values()), ctx.dictionary, all_tag_cols)
        if not entries and not any(ms for _r, _f, ms in region_sources):
            return None

        # 3. the strategy probe and the static plan (cards after all
        # dictionary updates; before the limb planes are decided, since a
        # hash plan accumulates exact f64)
        agg_probe = choose_agg_strategy(
            self.config, lowering, schema, scan, ctx, tag_cols, time_bounds
        )
        built = build_plan(self.config, lowering, schema, scan, ctx, tag_cols, time_bounds,
                           use_ts, agg_probe=agg_probe)
        if built is None:
            return None
        plan, dyn_host, fspec = built
        if plan.agg_strategy == "hash":
            # the dense [G] space never materializes: only the slot table
            # must fit, and size_hash_slots caps it at max_internal_groups
            passes.note("agg_strategy", True, agg_probe["why"], slots=plan.hash_slots,
                        groups=plan.num_groups, distinct_est=agg_probe["d_est"],
                        stats=agg_probe["stats_src"])
        elif not self._dense_fits(plan):
            return None  # group space too large for dense [G] states

        # 3b. the host routes, over a dense output space: answered before
        # the device is chosen, with no upload and no launch
        routed = self._host_routes(lowering, schema, time_bounds, plan, dyn_host, entries,
                                   region_sources, ctx, use_ts, pk, value_cols, all_tag_cols,
                                   dedup_regions, window, build_t)
        if routed is not None:
            return routed
        # the device path: upload what the host-only build deferred (an
        # entry whose planes are resident is a hit)
        uploaded: set[int] = set()
        for region, metas, _mems in region_sources:
            if metas:
                before = build_t.get("upload")
                up, _excluded = self.cache.super_tiles(
                    region, ctx.dictionary, metas, all_tag_cols, ts_name or use_ts,
                    value_cols, pinned_ids, pk, timings=build_t,
                )
                if up is None:
                    return None
                entries[region.region_id] = up
                if build_t.get("upload") != before:
                    uploaded.add(region.region_id)

        # 4. the device sources: chunks of each super-tile (or of its window
        # tile), then the tails
        need_cols = plan_cols(plan)
        limb_need = limb_sum_cols(plan)
        device_sources = []
        # each source's mesh slot (its chunk's placement; time-major copies
        # and memtable tails live on slot 0, as in the reference)
        source_slots = []
        stage_ms: dict[str, float] = {}
        for region, _metas, mem_tables in region_sources:
            s = entries.get(region.region_id)
            if s is not None:
                got = self._entry_sources(s, plan, window, use_ts, need_cols, limb_need,
                                          region.region_id in dedup_regions, ctx,
                                          pinned_ids, stage_ms, region.region_id in uploaded)
                if got is None:
                    return None
                device_sources.extend(got[0])
                source_slots.extend(got[1])
            for mt in mem_tables:
                src = self._encode_mem(ctx.dictionary, mt, all_tag_cols, use_ts, value_cols)
                if src is None:
                    return None
                cols, valid, nulls = src
                device_sources.append((
                    {k: v for k, v in cols.items() if k in need_cols},
                    valid,
                    {k: v for k, v in nulls.items() if k in need_cols},
                    {},
                ))
                source_slots.append(0)
        # count rows ship only for columns whose sources carry a null mask
        null_present = set()
        for _cols, _valid, nulls, _limbs in device_sources:
            null_present |= set(nulls)
        nullable_cols = tuple(sorted(
            c for _f, c in plan.agg_specs if c != COUNT_STAR and c in null_present
        ))
        dyn = {
            "filter_values": tuple(dyn_host["filter_values"]),
            "bucket_origin": int(dyn_host["bucket_origin"]),
            "bucket_interval": int(dyn_host["bucket_interval"]),
            "having_values": tuple(dyn_host.get("having_values", ())),
        }
        self.timings.update(build_t, quantize=stage_ms.pop("quantize", 0.0), **stage_ms)
        if plan.time_major:
            self.timings.setdefault("time_major", 0.0)
        self.timings["plan"] = (time.perf_counter() - t_start) * 1e3 - sum(self.timings.values())
        ndev = len(self.cache.devices)
        placed = ndev > 1 and passes.enabled("chunk_placement", self.config)
        if placed:
            why = (f"{len(device_sources)} tile chunk(s) placed over {ndev} device slots, "
                   "states merged N:1")
        elif ndev > 1:
            why = "pass disabled: all chunks pinned to slot 0"
        else:
            why = f"{len(device_sources)} tile chunk(s) on the single device"
        passes.note("chunk_placement", placed, why, chunks=len(device_sources), devices=ndev)

        # 5. one program, one readback.  A failed limb verdict reruns in
        # f64; a hash overflow reruns on the dense plan when it fits the
        # dense bounds, and otherwise the table-fed path owns the query
        if plan.agg_strategy == "hash":
            attempts = [plan]
            dense = dataclasses.replace(plan, agg_strategy="sort", hash_slots=0,
                                        acc_dtype="float64")
            if self._dense_fits(dense):
                attempts.append(dense)
        else:
            attempts = [plan, dataclasses.replace(plan, acc_dtype="float64")]
        self.last_strategy = plan.agg_strategy
        if capture_active():
            # a tick member: everything before the dispatch is done (plan,
            # planes, limbs, time-major copies, each synced); the tick
            # program launches it.  Only the first rung is captured: a
            # rerun verdict sends the member to its own solo run
            first = attempts[0]
            program = tile_program(first, nullable_cols, fspec)
            return CapturedDispatch(
                key=(first, nullable_cols, fspec), sources=tuple(device_sources), dyn=dyn,
                finish=functools.partial(self._finish_fetched, program, first, lowering, ctx,
                                         dyn_host),
                call=self.call_state(), regions=[r.region_id for r, _f, _m in region_sources],
            )
        for attempt in attempts:
            program = tile_program(attempt, nullable_cols, fspec)
            t0 = time.perf_counter()
            # the mesh first (tile.mesh_devices > 0); a shape it does not
            # express takes the single-device dispatch, and a failure raises
            packed = self._mesh_attempt(program, device_sources, source_slots, dyn)
            if packed is None:
                packed = program.run_all(device_sources, dyn)
            if defer_active():
                # the per-member tick path: the leader reads every member's
                # leaves back in one copy, then decodes (first rung only)
                return PendingFetch(packed, functools.partial(
                    self._finish_fetched, program, attempt, lowering, ctx, dyn_host),
                    call=self.call_state())
            self._sync()
            self._add_ms("dispatch", t0)
            table = self._finalize(packed, program, attempt, lowering, ctx, dyn_host)
            if table is not None:
                return table
            if attempt.agg_strategy == "hash":
                self.last_hash_overflow = True
            else:
                self.count(limb_reruns=1)
        return None

    def _host_routes(self, lowering, schema, time_bounds, plan, dyn_host, entries,
                     region_sources, ctx, use_ts, pk, value_cols, all_tag_cols, dedup_regions,
                     window, build_t):
        """The host fast path, then the cold serve (parallel/tile_host.py),
        each noted in the pass trace with the reference's wording: the
        answer, or None when both decline.  A family's first touch under
        the fused build takes the cold serve's fused ladder and schedules
        the family's build, as does a wide host fast path slice served
        only because its planes are cold.  Inside the builder both
        decline: the ghost run builds."""
        t0 = time.perf_counter()
        ghost = in_fused_build()
        dense_host_ok = plan.num_groups <= self.config.max_groups * 64
        super_entries = list(entries.values())
        mem_slots = [(r, mt) for r, _f, ms in region_sources for mt in ms]
        hfp_enabled = (passes.enabled("host_fast_path", self.config) and dense_host_ok
                       and not ghost)
        table = None
        hints: dict = {}
        if hfp_enabled:
            table = self.host_execute(plan, dyn_host, super_entries, mem_slots, ctx, use_ts, pk,
                                      value_cols, all_tag_cols, dedup_regions, hints=hints)

        def manifest(window_geometry=None) -> PlaneManifest:
            return PlaneManifest(
                table_key=ctx.table_key, tag_cols=tuple(all_tag_cols), ts_col=use_ts,
                value_cols=tuple(value_cols), limb_cols=tuple(limb_sum_cols(plan)),
                time_major=bool(plan.time_major), window=window_geometry,
                dedup=bool(dedup_regions))

        if table is not None:
            self.count(host_fast_path=1)
            if hints.get("wide_cold") and self._fused_first_touch(lowering, ctx):
                # a wide multi-key slice served only because its planes are
                # cold: warm them in the background, so the warm runs take
                # the tile dispatch
                self._fused_schedule(lowering, schema, time_bounds, ctx, manifest())
            passes.note("host_fast_path", True, "pk-equality slice served from sorted host planes",
                        rows_out=table.num_rows, **hints)
        else:
            passes.note("host_fast_path", False,
                        "query not selective enough for the sorted-host binary search"
                        if hfp_enabled else "pass disabled")
            fused_serve = self._fused_first_touch(lowering, ctx)
            if (dense_host_ok or fused_serve) and not ghost:
                table = self.host_cold_grouped(plan, dyn_host, super_entries, mem_slots, ctx,
                                               use_ts, value_cols, all_tag_cols, dedup_regions,
                                               window, fused=fused_serve)
            if table is None:
                return None
            self.count(cold_serves=1)
            if fused_serve:
                geometry = None
                if (not plan.time_major and window is not None and use_ts
                        and window[0] > -(1 << 61) and window[1] < (1 << 61)
                        and passes.enabled("window_tile", self.config)):
                    geometry = (int(window[0]), int(window[1]))
                self._fused_schedule(lowering, schema, time_bounds, ctx, manifest(geometry))
                passes.note("fused_build", True,
                            "family manifest recorded; fused background build scheduled "
                            "(waiters coalesce onto it)",
                            window=bool(geometry), time_major=bool(plan.time_major))
                passes.note("cold_host_serve", True,
                            "grouped aggregate served from the host consolidation while the "
                            "fused family build warms device planes in the background",
                            rows_out=table.num_rows, fused=True)
            else:
                passes.note("cold_host_serve", True,
                            "grouped aggregate served from the host consolidation; device tiles "
                            "build on the next touch", rows_out=table.num_rows)
        self.timings.update(build_t)
        self._add_ms("host", t0)
        return table

    def _entry_sources(self, s: _SuperTiles, plan, window, use_ts, need_cols, limb_need,
                       dedup: bool, ctx: TileContext, pinned_ids, stage_ms: dict,
                       uploaded: bool = False):
        """One region's entry as device sources: (sources, mesh slots), or
        None to decline.  A region whose in-window files overlap reads the
        keep plane (`dedup_plane`; the keep plane cannot be built: decline,
        the merge scan owns the dedup); a plan that is not time-major over
        a window bounded on both sides reads the window tile where it
        qualifies (`window_tile`); otherwise the entry's chunks, or their
        time-major copies.  `stage_ms` gains keep, the window tile's
        stages, time_major and quantize (each through a sync).  `uploaded`:
        the query uploaded planes of this entry."""
        def add_ms(stage, t0):
            stage_ms[stage] = stage_ms.get(stage, 0.0) + (time.perf_counter() - t0) * 1e3

        if dedup:
            enabled = passes.enabled("dedup_plane", self.config)
            t0 = time.perf_counter()
            if not enabled or not self.cache.ensure_dedup_keep(s):
                passes.note("dedup_plane", False,
                            "keep plane unavailable: merge scan owns dedup" if enabled
                            else "pass disabled")
                return None
            self._sync()
            add_ms("keep", t0)
            passes.note("dedup_plane", True,
                        "overlapping-SST LWW dedup lowered to a device keep mask",
                        region=s.region_id)
        if (not plan.time_major and window is not None and use_ts
                and window[0] > -(1 << 61) and window[1] < (1 << 61)
                and passes.enabled("window_tile", self.config)):
            # a windowed query over deep retention: only the in-window
            # (and dedup-surviving) rows, gathered into a compact tile
            wsrc = self.cache.ensure_window_tile(s, window, use_ts, need_cols, set(limb_need),
                                                 dedup, ctx.dictionary, timings=stage_ms)
            if wsrc is not None:
                passes.note("window_tile", True, "in-window rows gathered into a compact tile",
                            region=s.region_id, sources=len(wsrc[0]))
                return wsrc
            passes.note("window_tile", False,
                        "window covers most of retention (or tile build declined): "
                        "full-tile scan with device masking")
        # an entry past half the budget makes room for the planes this
        # query adds by dropping the ones it does not read (whole-entry
        # eviction cannot: the entry is pinned).  A query that adds none
        # keeps them all: the other families' planes (a fused build's union
        # among them) stay warm.  A tick member keeps the other members'
        # planes: the tick reads all of them at once, and a release would
        # re-upload them (and rebuild the tick's graph) on every tick
        adds = uploaded or self.cache.lacks_derived(s, need_cols, limb_need, plan.time_major,
                                                    dedup)
        if (adds and s.nbytes > self.cache.budget // 2
                and not (capture_active() or defer_active())):
            self.cache.release_unneeded(s, need_cols, keep_dedup=dedup)
        if plan.time_major:
            t0 = time.perf_counter()
            cols, valid, nulls = self.cache.ensure_time_major(s, use_ts, need_cols, dedup=dedup)
            self._sync()
            add_ms("time_major", t0)
        else:
            cols = {k: v for k, v in s.cols.items() if k in need_cols}
            valid = s.valid_dedup if dedup else s.valid
            nulls = {k: v for k, v in s.nulls.items() if k in need_cols}
        t0 = time.perf_counter()
        limbs = (self.cache.ensure_limbs(s, limb_need, plan.time_major, pinned_ids)
                 if limb_need else {})
        self._sync()
        add_ms("quantize", t0)
        if any(c not in limbs and c not in s.cols for c in limb_need):
            return None
        sources, slots = [], []
        for i in range(len(valid)):
            sources.append((
                {k: v[i] for k, v in cols.items()},
                valid[i],
                {k: v[i] for k, v in nulls.items()},
                {k: v[i] for k, v in limbs.items()},
            ))
            slots.append(0 if plan.time_major else s.chunk_slot(i))
        return sources, slots

    def _mesh_attempt(self, program, device_sources, source_slots, dyn):
        """The multi-device dispatch (`tile.mesh_devices` > 0, the
        reference's `_mesh_attempt`): the packed result, or None to run the
        single-device dispatch (mesh off, pass disabled, or a shape the
        mesh run does not express).  Unlike the reference, a failure in
        the mesh run raises: nothing degrades to the single device."""
        mesh_n = self.cache.mesh_devices()
        if mesh_n <= 0:
            return None
        if not passes.enabled("mesh_dispatch", self.config):
            passes.note("mesh_dispatch", False, "pass disabled: single-device dispatch")
            return None
        try:
            packed = mesh_run(program, device_sources, source_slots, dyn,
                              self.cache.mesh(mesh_n))
        except MeshIneligible as why:
            passes.note("mesh_dispatch", False, f"{why}: single-device dispatch")
            return None
        self.count(mesh_dispatches=1)
        passes.note(
            "mesh_dispatch", True,
            f"{len(device_sources)} source(s) over the {mesh_n}-slot `{REGION_AXIS}` mesh: "
            "per-slot partial states, K22 fold on slot 0, finalize once after the fold",
            devices=mesh_n, sources=len(device_sources),
        )
        return packed

    def _dense_fits(self, plan) -> bool:
        """A sort plan's [G] states fit the dense bounds."""
        return (plan.num_groups <= self.config.max_groups * 64
                and plan.internal_groups <= self.config.max_internal_groups)

    def _add_ms(self, stage: str, t0: float) -> None:
        self.timings[stage] = self.timings.get(stage, 0.0) + (time.perf_counter() - t0) * 1e3

    @staticmethod
    def _fetch_result(packed) -> tuple:
        """The one device -> host readback of the packed result."""
        return tuple(p.cpu().numpy() for p in packed)

    def _finalize(self, packed, program, plan, lowering, ctx, dyn_host):
        """Read the result back and decode it; None on a failed limb
        verdict (the caller reruns in f64)."""
        t0 = time.perf_counter()
        fetched = self._fetch_result(packed)
        self._add_ms("readback", t0)
        return self._finish_fetched(program, plan, lowering, ctx, dyn_host, fetched)

    def _finish_fetched(self, program, plan, lowering, ctx, dyn_host, fetched):
        """Everything `_finalize` does after the readback, on leaves
        already on the host (a tick's shared readback); None on a rerun
        verdict."""
        self.last_readback_bytes = sum(a.nbytes for a in fetched)
        t0 = time.perf_counter()
        try:
            return self._decode_result(fetched, program, plan, lowering, ctx, dyn_host)
        finally:
            self._add_ms("decode", t0)

    # -- prewarm -----------------------------------------------------------------
    def prewarm(self, ctx: TileContext, schema) -> dict:
        """Build a table's super-tiles off the query path.  Under the fused
        build (the reference's fused `prewarm`): record the table's base
        manifest and run its union build host-only (`fused_union_build(...,
        device=False)`: the host consolidation the host routes read; no
        device plane, no launch) under `build_gate` — when another builder
        leads, wait for it and return {"regions_built": 0, "coalesced":
        True, ...}.  Otherwise (the reference's non-fused `prewarm`): per
        region, under the table lock, the host consolidation and the upload
        of every numeric field, then (with limb accumulation on) K5 over
        the non-null ones.  A region with no files, or whose build yields
        no entry, is skipped; any other failure raises.  Returns
        {"regions_built", "ms"}."""
        t0 = time.perf_counter()
        built = 0
        pk = [c.name for c in schema.tag_columns()]
        ts_name = schema.time_index.name if schema.time_index else None
        value_cols = [c.name for c in schema.field_columns() if c.data_type.is_numeric()]
        nonnull = [c for c in value_cols
                   if schema.has_column(c) and not schema.column(c).nullable]
        limb_wanted = config_acc_dtype(self.config) == "limb"
        if self._fused_enabled():
            manifest = PlaneManifest(
                table_key=ctx.table_key, tag_cols=tuple(pk), ts_col=ts_name,
                value_cols=tuple(value_cols), limb_cols=tuple(nonnull) if limb_wanted else ())
            self.cache.record_manifest(manifest)
            with self.cache.build_gate(ctx.table_key) as leader:
                if leader:
                    out = self.cache.fused_union_build(ctx, schema, [manifest], device=False)
                else:
                    out = {"regions_built": 0, "coalesced": True}
            return {"regions_built": out["regions_built"],
                    "ms": round((time.perf_counter() - t0) * 1e3, 1),
                    **({"coalesced": True} if out.get("coalesced") else {})}
        pinned_ids = {r.region_id for r in ctx.regions}
        # the table lock is taken a region at a time: a query waits for one
        # region's build at most
        for region in ctx.regions:
            with ctx.dictionary.table_lock:
                region.pin_scan()
                try:
                    metas, _mems, version = region.tile_snapshot()
                    self.cache.invalidate_region_if_changed(
                        region.region_id, {m.file_id for m in metas}, version)
                    if not metas:
                        continue
                    entry, _excluded = self.cache.super_tiles(
                        region, ctx.dictionary, metas, pk, ts_name, value_cols, pinned_ids, pk)
                    if entry is None:
                        continue
                    built += 1
                    if limb_wanted and nonnull:
                        self.cache.ensure_limbs(entry, nonnull, False, pinned_ids)
                        self._sync()
                finally:
                    region.unpin_scan()
        return {"regions_built": built, "ms": round((time.perf_counter() - t0) * 1e3, 1)}

    # -- the batch tick --------------------------------------------------------
    def fetch_leaves(self, per_member: list) -> list[tuple]:
        """The per-member path's one readback: every member's leaves
        through one device slab and one device -> host copy."""
        flat = [t for leaves in per_member for t in leaves]
        if not flat:
            return [() for _ in per_member]
        slab = torch.cat([t.contiguous().view(torch.uint8).reshape(-1) for t in flat])
        host = slab.cpu().numpy()
        out, off = [], 0
        for leaves in per_member:
            mine = []
            for t in leaves:
                nb = t.numel() * t.element_size()
                mine.append(host[off: off + nb].view(np_dtype(t.dtype))
                            .reshape(tuple(t.shape)).copy())
                off += nb
            out.append(tuple(mine))
        return out

    def finish_pending(self, pending: PendingFetch, fetched) -> tuple:
        """(decoded table or None, the member's call state) of one member of
        the per-member path."""
        self.adopt_call(pending.call)
        table = pending.finish(fetched)
        return table, self.call_state()

    def fused_dispatch(self, cds: list[CapturedDispatch], ctx: TileContext) -> tuple[list, list]:
        """B19: the captured members of one tick through one TickProgram:
        one replay (one CUDA graph launch on the card), one readback, a
        decode per member.  Returns per member (in the given order) the
        decoded table or None (a rerun verdict), and its call state.  The
        multiset is canonical — members sorted by key — so {A, B} and
        {B, A} share one program; a slid window (new literals and bounds,
        the same structure) finds it again.  A capture or replay failure
        raises.  The replay runs under the table lock, as a solo dispatch
        does."""
        order = sorted(range(len(cds)), key=lambda i: repr(cds[i].key))
        members, encs, sigs = [], [], []
        for i in order:
            cd = cds[i]
            prog = tile_program(*cd.key)
            sig, enc = prog.encode_inputs(cd.sources, cd.dyn)
            members.append((prog, cd.sources, cd.dyn))
            encs.append(enc)
            sigs.append(sig)
        key = (tuple(cds[i].key for i in order), tuple(sigs),
               tuple(_source_identity(cds[i].sources) for i in order))
        with ctx.dictionary.table_lock:
            tick = self._tick_program(key, members, set().union(*(cd.regions for cd in cds)))
            t0 = time.perf_counter()
            fetched = tick.run(encs)
            run_ms = (time.perf_counter() - t0) * 1e3
        with self._lock:
            self._trim_ticks_locked()  # its graph's pool is known after the first run
        self.count(tick_graph_replays=1)
        tables, calls = [None] * len(cds), [None] * len(cds)
        decode_ms = []
        for pos, i in enumerate(order):
            cd = cds[i]
            self.adopt_call(cd.call)
            self.timings["dispatch"] = run_ms
            self.timings["readback"] = tick.last_stage_ms.get("readback", 0.0)
            tables[i] = cd.finish(fetched[pos])
            decode_ms.append(self.timings.get("decode", 0.0))
            calls[i] = self.call_state()
        tick.last_stage_ms["decode_ms"] = decode_ms
        # the tick program of the calling thread's last tick (read by
        # chip_smoke.py and the tests)
        self.last_tick = tick
        return tables, calls

    def _tick_program(self, key, members, regions) -> TickProgram:
        """The cached TickProgram of a member multiset over these exact
        sources, or a new one (counted in tick_graph_captures; on the card
        its first run captures the graph).  The cache is an LRU bounded in
        bytes, the bytes taken out of the tile cache's budget."""
        with self._lock:
            tick = self._ticks.get(key)
            if tick is not None:
                self._ticks.move_to_end(key)
                return tick
        tick = TickProgram(members, self.device)
        tick.regions = frozenset(regions)
        self.count(tick_graph_captures=1)
        with self._lock:
            self._ticks[key] = tick
        return tick

    def _trim_ticks_locked(self) -> None:
        budget = self.cache.budget // 4
        used = sum(t.nbytes for t in self._ticks.values())
        while used > budget and len(self._ticks) > 1:
            _k, old = self._ticks.popitem(last=False)
            used -= old.nbytes
        self.cache.graph_bytes = used

    def _drop_ticks_of(self, region_id: int) -> None:
        """A plane of the region was replaced or freed: drop every tick
        program that reads the region (it holds the old planes; its key
        would never match the new ones)."""
        with self._lock:
            for k in [k for k, t in self._ticks.items() if region_id in t.regions]:
                del self._ticks[k]
            self.cache.graph_bytes = sum(t.nbytes for t in self._ticks.values())

    # -- sources ----------------------------------------------------------------
    def _encode_mem(self, dictionary, table, tag_cols, ts_col, value_cols):
        """Encode the memtable tail with the same host encode as file
        tiles; padded to a multiple of 4096 rows and uploaded."""
        need = list(dict.fromkeys(tag_cols + ([ts_col] if ts_col else []) + value_cols))
        if any(name not in table.column_names for name in need):
            return None
        built = _encode_host_tiles(dictionary, table, need, tag_cols, ts_col)
        if built is None:
            return None
        cols, nulls, _epochs, _nbytes = built
        n = table.num_rows
        pad = pad_rows(n)

        def up(arr, dtype=None):
            buf = np.zeros(pad, dtype=dtype or arr.dtype)
            buf[:n] = arr
            return torch.from_numpy(buf).to(self.device)

        out_cols = {name: up(arr) for name, arr in cols.items()}
        out_nulls = {name: up(arr, bool) for name, arr in nulls.items()}
        return out_cols, up(np.ones(n, bool), bool), out_nulls

    # -- readback decode ----------------------------------------------------------
    def _decode_result(self, fetched, program, plan, lowering, ctx, dyn_host):
        buf = fetched[0]
        accs64 = fetched[1] if len(fetched) > 1 else None
        spec = program.spec
        is_hash = plan.agg_strategy == "hash"
        if is_hash and buf[-1] != 0:
            # slot-table overflow: the distinct-key estimate was badly low;
            # the caller reruns dense or declines (never a wrong result)
            return None
        if program.limb_err_cols and buf[-1] == 0:
            # a group's quantization bound exceeded 1e-7 of its sum: the
            # caller reruns with exact f64 accumulation
            return None
        if spec is not None:
            g = spec.cap
        elif is_hash:
            g = plan.hash_slots
        else:
            g = plan.num_groups
        bit_packed = program.bit_packed
        int_row = -(-g // 8) if bit_packed else g
        ni = len(program.int_layout)
        off = ni * int_row * (1 if bit_packed else 4)
        ints = np.frombuffer(
            buf[:off].tobytes(), np.uint8 if bit_packed else np.int32
        ).reshape(ni, int_row)
        n32 = len(program.acc32_layout)
        accs32 = np.frombuffer(buf[off: off + n32 * g * 4].tobytes(), np.float32).reshape(n32, g)
        off += n32 * g * 4
        sel = n_out = None
        if spec is not None:
            sel = np.frombuffer(buf[off: off + g * 4].tobytes(), np.int32)
            off += g * 4
            n_out = int(np.frombuffer(buf[off: off + 4].tobytes(), np.int32)[0])
            off += 4
            n64 = len(program.acc64_layout)
            pairs = np.frombuffer(buf[off: off + n64 * g * 8].tobytes(), np.int32).reshape(n64, g, 2)
            off += n64 * g * 8
            accs64 = unpack_f64_bits(pairs)
        finals: dict[str, dict[str, np.ndarray]] = {}
        for i, (col, agg) in enumerate(program.int_layout):
            row = ints[i]
            if bit_packed:
                row = np.unpackbits(row)[:g].astype(np.int64)
            finals.setdefault(col, {})[agg] = row
        for i, (col, agg) in enumerate(program.acc32_layout):
            finals.setdefault(col, {})[agg] = accs32[i].astype(np.float64)
        for i, (col, agg) in enumerate(program.acc64_layout):
            finals.setdefault(col, {})[agg] = accs64[i]
        if spec is not None:
            table = self._assemble_compact(finals, plan, ctx, dyn_host, sel, n_out, spec)
            # the device consumed these post-ops: the host replay skips them
            lowering.post_done = dyn_host.get("post_consumed", frozenset())
            return table
        if is_hash:
            return self._assemble_hash_result(finals, plan, ctx, dyn_host, fetched[2])
        return self._assemble_result(finals, plan, ctx, dyn_host)

    def _group_key_columns(self, plan, ctx, dyn_host, gids) -> dict:
        """gid vector -> ordered {tag..., bucket} output columns (the
        mixed-radix decode of GroupByResult.to_table)."""
        cols: dict[str, object] = {}
        dims: list[tuple[str, int]] = list(zip(plan.group_tags, plan.tag_cards))
        if plan.bucket_col is not None:
            dims.append(("__bucket", plan.n_buckets))
        decoded = {}
        div = 1
        for name, card in reversed(dims):
            decoded[name] = (gids // div) % card
            div *= card
        for tag in plan.group_tags:
            values = ctx.dictionary.values(tag)
            cols[tag] = [values[c] if c < len(values) else None for c in decoded[tag]]
        if plan.bucket_col is not None:
            cols[plan.bucket_col] = (
                dyn_host["bucket_origin"]
                + decoded["__bucket"].astype(np.int64) * dyn_host["bucket_interval"]
            )
        return cols

    @staticmethod
    def _append_agg_columns(cols, finals, plan, indexer):
        """Per-agg-spec output columns, rows taken via `indexer`, with the
        count-sharing / NULL-gating / naming of `_assemble_result`."""
        presence = finals["__presence"]["count"]
        for func, col in plan.agg_specs:
            out = finals.get(col, {})
            kernel = _FUNC_TO_KERNEL[func]
            arr = out.get(kernel)
            if arr is None and kernel == "count":
                arr = presence  # count-pass sharing: presence IS the count
            arr = np.asarray(arr)[indexer]
            col_count = np.asarray(out.get("count", presence))[indexer]
            if col == COUNT_STAR:
                cols["count(*)"] = pa.array(arr.astype(np.int64))
            elif func == "count":
                cols[f"count({col})"] = pa.array(arr.astype(np.int64))
            else:
                vals = np.where(col_count > 0, arr, np.nan)
                cols[f"{func}({col})"] = pa.array(vals, mask=np.isnan(vals))
        return cols

    def _assemble_hash_result(self, finals, plan, ctx, dyn_host, table_keys):
        """[K, hash_slots] rows + the slot -> gid key table -> SQL rows: the
        occupied slots ordered by gid ascending (the order of the dense
        path's scan over [G]), keys decoded with the same mixed radix and
        the same NULL gating and naming."""
        keys = np.asarray(table_keys, dtype=np.int64)
        presence = np.asarray(finals["__presence"]["count"])
        slot_idx = np.nonzero((keys >= 0) & (presence[: keys.shape[0]] > 0))[0]
        slots = slot_idx[np.argsort(keys[slot_idx], kind="stable")]
        cols = self._group_key_columns(plan, ctx, dyn_host, keys[slots])
        return pa.table(self._append_agg_columns(cols, finals, plan, slots))

    def _assemble_compact(self, finals, plan, ctx, dyn_host, sel, n_out, spec):
        """Compact [K, cap] rows + selected group ids -> SQL rows in device
        order; the host's remaining work is the offset/limit slice and the
        tag/bucket decode of rows_out ids."""
        rows_avail = max(min(n_out, spec.cap), 0)
        start, stop = 0, rows_avail
        if spec.limit is not None:
            start = min(spec.offset, rows_avail)
            stop = min(start + spec.limit, rows_avail)
        sl = slice(start, stop)
        idx = np.asarray(sel[sl], np.int64)
        cols = self._group_key_columns(plan, ctx, dyn_host, idx)
        return pa.table(self._append_agg_columns(cols, finals, plan, sl))

    def _assemble_result(self, finals, plan, ctx, dyn_host):
        """[G]-state rows -> SQL rows (the table-fed path's decode)."""
        outputs: dict[str, np.ndarray] = {}
        presence = finals["__presence"]["count"]
        for func, col in plan.agg_specs:
            out = finals.get(col, {})
            kernel = _FUNC_TO_KERNEL[func]
            arr = out.get(kernel)
            if arr is None and kernel == "count":
                arr = presence
            arr = np.asarray(arr)
            col_count = out.get("count", presence)
            if col == COUNT_STAR:
                outputs["count(*)"] = arr.astype(np.int64)
            elif func == "count":
                outputs[f"count({col})"] = arr.astype(np.int64)
            else:
                outputs[f"{func}({col})"] = np.where(col_count > 0, arr, np.nan)
        real = dataclasses.replace(
            plan, bucket_origin=int(dyn_host["bucket_origin"]),
            bucket_interval=int(dyn_host["bucket_interval"]),
        )
        result = GroupByResult(
            outputs=outputs, non_empty=presence > 0,
            tag_values={t: ctx.dictionary.values(t) for t in plan.group_tags}, plan=real,
        )
        return result.to_table()


def _source_identity(sources) -> tuple:
    """What a captured graph reads, by address: every tensor of every
    source (a new plane, even at a reused address after a drop, is
    caught by the cache's plane listeners)."""
    out = []
    for cols, valid, nulls, limbs in sources:
        out.append((
            tuple((k, v.data_ptr()) for k, v in sorted(cols.items())),
            valid.data_ptr(),
            tuple((k, v.data_ptr()) for k, v in sorted(nulls.items())),
            tuple((k, lb.data_ptr(), sc.data_ptr()) for k, (lb, sc) in sorted(limbs.items())),
        ))
    return tuple(out)
