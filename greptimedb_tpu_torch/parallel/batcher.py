"""The dashboard batch tick and the windowed result cache.

Counterpart of `greptimedb_tpu/parallel/batcher.py`.  A Grafana dashboard
of N panels sends its N distinct warm queries together on every refresh;
this module answers them as one tick:

  * `QueryBatcher` — warm queries against the same table that arrive
    within `batch.window_ms` of each other form a tick.  The first arrival
    is the LEADER: it sleeps out the window (clamped to 250 ms), then runs
    the tick for everyone.  With `batch.fuse_programs` (the default) each
    member's dispatch is CAPTURED at the executor's dispatch site
    (`CapturedDispatch`: the plan's program key, the device sources, the
    literals, the decode continuation) and the executor answers all of
    them from one `TickProgram` (parallel/tile_program.py: one CUDA graph
    per member multiset, one replay, one readback).  Without it, or while
    `tile.mesh_devices` > 0 (the reference's rule), each member dispatches
    back to back in deferred-fetch mode
    (`PendingFetch`) and the leader reads every member's leaves back in
    one copy.  Members share the dispatch and the readback, never each
    other's math: each result is byte-identical to the member's solo run.
    A member whose decoded result is a rerun verdict (the limb bound
    byte, the hash overflow byte) runs solo on its own thread, walking the
    full attempt ladder.  A member answered on a host route returns its
    table before the dispatch site, outside the tick; the fused build's
    ghost runs never join one (the builder calls `execute_direct`).  A failing capture or replay raises to the
    callers: there is no catch-all degrade.

  * `WindowedResultCache` — finished results keyed on (literal-
    insensitive plan fingerprint, filter-literal digest, bucket-aligned
    time window, per-region manifest version + WAL tail id).  A dashboard
    that re-asks the same aligned window is served with no dispatch; a
    write moves the WAL tail and a flush the manifest version, so stale
    entries are unreachable.  LRU-bounded by `batch.result_cache_mb`.

Not ported: the `batch.pack` / `batch.fuse` / `batch.result_cache` fault
points, the device-health supervisor, admission coalescing, the
reference's whole-tick degrade on a fuse failure, and `defer_suppressed`
(only the streamed readback, not ported, needs it) (ROADMAP).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict

# ---- deferred device -> host fetches ----------------------------------------
# A thread-local flag the leader raises around each member's dispatch on
# the per-member path: the executor's _finalize sees it and returns a
# PendingFetch (dispatched, not fetched).

_DEFER = threading.local()


def defer_active() -> bool:
    return getattr(_DEFER, "active", False)


@contextlib.contextmanager
def defer_fetch():
    prev = getattr(_DEFER, "active", False)
    _DEFER.active = True
    try:
        yield
    finally:
        _DEFER.active = prev


# ---- dispatch capture -----------------------------------------------------------
# A thread-local flag the leader raises around each member's execute on the
# fused path: the executor's dispatch site returns a CapturedDispatch
# (everything the tick program needs, nothing launched).

_CAPTURE = threading.local()


def capture_active() -> bool:
    return getattr(_CAPTURE, "active", False)


@contextlib.contextmanager
def capture_dispatch():
    prev = getattr(_CAPTURE, "active", False)
    _CAPTURE.active = True
    try:
        yield
    finally:
        _CAPTURE.active = prev


class CapturedDispatch:
    """One member's dispatch-ready state, captured instead of launched.

    `key` is the member's `tile_program` key (plan, nullable count
    columns, finalize spec); `sources` and `dyn` the device sources and
    the literals of this tick; `finish` the decode continuation (fetched
    leaves in, the decoded table or a rerun-verdict None out).  Only the
    first rung of the attempt ladder is captured.  `call` holds the
    per-call state the capture left (strategy, stage timings), which the
    member's own thread adopts; `regions` the ids of the regions whose
    planes the sources are."""

    __slots__ = ("key", "sources", "dyn", "finish", "call", "regions")

    def __init__(self, key, sources, dyn, finish, call=None, regions=()):
        self.key = key
        self.sources = sources
        self.dyn = dyn
        self.finish = finish
        self.call = call or {}
        self.regions = frozenset(regions)


class PendingFetch:
    """One query's dispatched but unfetched result: its packed leaves on
    the device and the decode continuation (`finish`, as above)."""

    __slots__ = ("leaves", "finish", "call")

    def __init__(self, leaves, finish, call=None):
        self.leaves = list(leaves)
        self.finish = finish
        self.call = call or {}


# ---- windowed result cache ----------------------------------------------------------


def region_versions(ctx) -> tuple:
    """(region id, manifest version, WAL tail id) of every region: the data
    snapshot a result-cache key pins."""
    return tuple(
        (r.region_id, r.manifest_mgr.manifest.manifest_version, r.wal.last_entry_id)
        for r in ctx.regions
    )


class WindowedResultCache:
    """LRU byte-bounded memo of finished results.

    Values are (pa.Table, post_done); both immutable, so a hit hands back
    the stored objects.  `post_done` rides along because a result the
    card finalized already consumed some post-ops; a hit skips the same
    ones."""

    # per-entry bookkeeping floor: a tiny table still costs its key
    _ENTRY_OVERHEAD = 1 << 10

    def __init__(self, budget_bytes: int):
        self.budget = int(budget_bytes)
        self._lock = threading.Lock()
        self._entries: OrderedDict = OrderedDict()  # key -> (table, post_done, nbytes)
        self._used = 0
        self.evictions = 0

    @staticmethod
    def key_for(plan_fp, lowering, schema, ctx):
        """(plan_fp, literals, window, versions) of one query, or None
        when it has no fingerprint.  `window` is the scan's time range in
        bucket units when both bounds sit on the query's bucket grid (the
        form a refreshing dashboard re-asks), verbatim otherwise; both are
        exact."""
        if plan_fp is None:
            return None
        literals = repr(tuple(lowering.scan.filters))
        window = WindowedResultCache._window_key(lowering, schema)
        return (plan_fp, literals, window, region_versions(ctx))

    @staticmethod
    def _window_key(lowering, schema):
        tr = lowering.scan.time_range
        if tr is None:
            return ("full",)
        lo, hi = int(tr[0]), int(tr[1])
        bucket = lowering.bucket
        if bucket is not None and lo > -(1 << 61) and hi < (1 << 61):
            _ts, interval_ms, origin = bucket
            # the ms -> native conversion of the plan's bucket geometry
            unit_ns = schema.time_index.data_type.timestamp_unit_ns()
            step = max(int(interval_ms * 1_000_000) // max(unit_ns, 1), 1)
            if (lo - origin) % step == 0 and (hi - origin) % step == 0:
                # bijective given the plan: interval and origin are in plan_fp
                return ("aligned", (lo - origin) // step, (hi - origin) // step)
        return ("raw", lo, hi)

    def get(self, key):
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return None
            self._entries.move_to_end(key)
            return entry[0], entry[1]

    def put(self, key, table, post_done):
        nbytes = int(table.nbytes) + self._ENTRY_OVERHEAD
        if nbytes > self.budget:
            return
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._used -= old[2]
            self._entries[key] = (table, frozenset(post_done or ()), nbytes)
            self._used += nbytes
            while self._used > self.budget and self._entries:
                _key, dropped = self._entries.popitem(last=False)
                self._used -= dropped[2]
                self.evictions += 1

    def purge_region(self, region_id: int):
        """Drop every entry touching the region.  Its version-carrying key
        already makes a stale entry unreachable; this returns its bytes to
        the budget at once."""
        with self._lock:
            for key in list(self._entries):
                if any(v[0] == region_id for v in key[3]):
                    self._used -= self._entries.pop(key)[2]
                    self.evictions += 1

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "bytes": self._used,
                    "evictions": self.evictions}


# ---- the query batcher ------------------------------------------------------------------


class _Member:
    __slots__ = ("lowering", "schema", "time_bounds", "ctx", "event", "result", "post_done",
                 "call", "solo", "served", "error")

    def __init__(self, lowering, schema, time_bounds, ctx):
        self.lowering = lowering
        self.schema = schema
        self.time_bounds = time_bounds
        self.ctx = ctx
        self.event = threading.Event()
        self.result = None
        self.post_done = frozenset()
        self.call: dict = {}  # the per-call state the batch left for this member
        self.solo = False  # a rerun verdict: the owner runs its own solo dispatch
        self.served = False  # result / post_done came from the batch
        self.error: BaseException | None = None


class _Batch:
    __slots__ = ("members", "closed")

    def __init__(self):
        self.members: list[_Member] = []
        self.closed = False


class QueryBatcher:
    """Forms per-table ticks of warm queries.  The executor calls `submit`
    only for warm families with `batch.window_ms > 0`; everything else
    takes the solo path."""

    # ceiling on the leader's window sleep, whatever the knob says
    _WINDOW_CAP_S = 0.25

    def __init__(self, executor):
        self._ex = executor
        self._lock = threading.Lock()
        self._open: dict[str, _Batch] = {}  # table key -> forming batch

    def submit(self, lowering, schema, time_bounds, ctx, bc):
        m = _Member(lowering, schema, time_bounds, ctx)
        key = ctx.table_key
        cap = max(int(bc.max_members), 2)
        with self._lock:
            batch = self._open.get(key)
            if batch is not None and not batch.closed and len(batch.members) < cap:
                batch.members.append(m)
                leader = False
            else:
                batch = _Batch()
                batch.members.append(m)
                self._open[key] = batch
                leader = True
        if leader:
            self._lead(batch, m, key, bc)
        else:
            m.event.wait()
        return self._adopt(m)

    def _adopt(self, m: _Member):
        """The member's answer on its own thread: the batch's result, its
        error, or its own solo run."""
        if m.error is not None:
            raise m.error
        if m.served:
            m.lowering.post_done = m.post_done
            self._ex.adopt_call(m.call)
            return m.result
        return self._ex.execute_direct(m.lowering, m.schema, m.time_bounds, m.ctx)

    def _lead(self, batch, m, key, bc):
        """Sleep out the window, close the batch, run it, wake everyone.
        The finally closes the batch and wakes every peer whatever
        happened, so no joiner waits on a dead leader; an error of the
        tick is handed to every member still unserved."""
        try:
            window_s = min(float(bc.window_ms) / 1000.0, self._WINDOW_CAP_S)
            if window_s > 0:
                time.sleep(window_s)
            with self._lock:
                batch.closed = True
                if self._open.get(key) is batch:
                    del self._open[key]
            try:
                self._run(batch, bc)
            except BaseException as exc:
                for peer in batch.members:
                    if not peer.served and not peer.solo:
                        peer.error = exc
        finally:
            with self._lock:
                batch.closed = True
                if self._open.get(key) is batch:
                    del self._open[key]
            for peer in batch.members:
                if peer is not m:
                    peer.event.set()

    def _run(self, batch, bc):
        ex = self._ex
        # members identical in plan and snapshot adopt one primary's result
        primaries: list[_Member] = []
        adopt: list[tuple[_Member, _Member]] = []
        by_key: dict = {}
        for m in batch.members:
            fk = ex.family_key(m.lowering, m.ctx)
            if fk in by_key:
                adopt.append((m, by_key[fk]))
                continue
            by_key[fk] = m
            primaries.append(m)
        if len(primaries) == 1:
            # one plan: the plain solo dispatch
            self._run_solo_into(primaries[0])
        elif bc.fuse_programs and ex.cache.mesh_devices() == 0:
            self._run_fused(primaries)
        else:
            # with the mesh on (tile.mesh_devices > 0) each member
            # dispatches over the mesh in turn: its per-slot partials and
            # gathers do not ride one graph
            self._run_packed(primaries)
        for dupe, prim in adopt:
            if prim.served:
                dupe.result, dupe.post_done, dupe.call = prim.result, prim.post_done, prim.call
                dupe.served = True
            else:
                dupe.solo = True

    def _run_solo_into(self, m: _Member):
        m.result = self._ex.execute_direct(m.lowering, m.schema, m.time_bounds, m.ctx)
        m.post_done = m.lowering.post_done
        m.call = self._ex.call_state()
        m.served = True

    def _serve(self, m: _Member, table, call) -> bool:
        """Record a member's decoded result; a rerun verdict (None) sends
        it to its own solo run."""
        if table is None:
            m.solo = True
            return False
        m.result = table
        m.post_done = m.lowering.post_done
        m.call = call
        m.served = True
        return True

    def _run_fused(self, primaries: list[_Member]):
        """Capture every member's dispatch, answer the captured set from
        one tick program, decode each member from its leaves."""
        ex = self._ex
        captured = []
        for m in primaries:
            with capture_dispatch():
                out = ex.execute_direct(m.lowering, m.schema, m.time_bounds, m.ctx)
            if isinstance(out, CapturedDispatch):
                captured.append((m, out))
            elif out is None:
                m.solo = True  # the tile path declined: the member's own run answers
            else:
                self._serve(m, out, ex.call_state())
        if not captured:
            return
        tables, calls = ex.fused_dispatch([cd for _m, cd in captured], primaries[0].ctx)
        served = sum(self._serve(m, t, c) for (m, _cd), t, c in zip(captured, tables, calls))
        ex.count(batch_ticks=1, batch_members=served, batch_fused_dispatches=1)

    def _run_packed(self, primaries: list[_Member]):
        """Each member dispatched back to back, every member's leaves read
        back in one copy."""
        ex = self._ex
        pendings = []
        for m in primaries:
            with defer_fetch():
                out = ex.execute_direct(m.lowering, m.schema, m.time_bounds, m.ctx)
            if isinstance(out, PendingFetch):
                pendings.append((m, out))
            elif out is None:
                m.solo = True
            else:
                self._serve(m, out, ex.call_state())
        if not pendings:
            return
        fetched = ex.fetch_leaves([p.leaves for _m, p in pendings])
        served = 0
        for (m, p), part in zip(pendings, fetched):
            table, call = ex.finish_pending(p, part)
            served += self._serve(m, table, call)
        if len(pendings) >= 2:
            ex.count(batch_ticks=1, batch_members=served)
