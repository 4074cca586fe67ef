"""The fused family build (`tile.fused_build`, the `fused_build` pass) and
the cold serve's fused ladder, in the port's Database (device="cpu")
beside the reference's Database on the same writes, both at the fused
build's default (on), the reference with the passes the port lacks off and
no tile persistence.

Mirrors of tests/test_fused_build.py: warm bit parity of the fused build
against the legacy ladder (auto / sort / hash, the 1-slot mesh), every
family cold-served before its planes exist, one decode a file, a query
waiting for its family's build in flight (the port's builder held by a
patched sleep where the reference arms a fault latency), a failed build
that leaves queries healthy (a patched raise: counted in
`fused_build_errors`, the next touch builds on its own thread), a
hash-scale group space cold-served compacted, `build_gate` and prewarm,
and the fused build off restoring the legacy ladder.  Then a seeded
differential (append and non-append tables, last_value, windows,
memtable tails, `_COLD_PAR_ROWS` and `_COLD_COMPACT_GROUPS` lowered on
both sides so the chunk-parallel and compacted folds run) and a TQL
family's first touch.

Every query must record the same `host_fast_path` / `cold_host_serve` /
`fused_build` decisions (name, fired, why; the attributes of the last two)
in both packages and give the same bytes (Arrow IPC), cold and after the
builders drained.  The data is integer-valued or fixed-point decimal, so
sums are exact in any order."""

import io
import threading
import time

import numpy as np
import pyarrow as pa
import pytest
import torch

from greptimedb_tpu.database import Database as JaxDatabase
from greptimedb_tpu.query import passes as jax_passes
from greptimedb_tpu.utils import fault_injection as fi
from greptimedb_tpu.utils import metrics
from greptimedb_tpu.utils.config import Config as JaxConfig
from greptimedb_tpu_torch import Database
from greptimedb_tpu_torch.parallel import tile_host
from greptimedb_tpu_torch.parallel.tile_executor import TileExecutor, in_fused_build
from greptimedb_tpu_torch.parallel.tile_host import HostRoutes
from greptimedb_tpu_torch.parallel.tile_planes import TileCacheManager
from greptimedb_tpu_torch.query import passes
from greptimedb_tpu_torch.query.logical_plan import TableScan
from greptimedb_tpu_torch.utils.config import Config, TileConfig
from greptimedb_tpu_torch.utils.errors import ConfigError
from test_torch_host_routes import DDL, _rows
from test_torch_promql import _assert_same as _assert_same_tql
from test_torch_promql import _load_counter
from test_torch_tile import UNPORTED_PASSES, _assert_same, _JaxWriter

import chip_smoke

# the decisions compared, and the reference's passes the port still lacks
ROUTES = ("cost_route", "host_fast_path", "cold_host_serve", "fused_build")
REF_DISABLED = tuple(p for p in UNPORTED_PASSES if p not in ROUTES)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_faults():
    fi.REGISTRY.disarm()
    yield
    fi.REGISTRY.disarm()


def _ser(t: pa.Table) -> bytes:
    sink = io.BytesIO()
    with pa.ipc.new_stream(sink, t.schema) as w:
        w.write_table(t)
    return sink.getvalue()


def _decisions(trace) -> list:
    out = []
    for d in trace.decisions:
        if d.name not in ROUTES:
            continue
        attrs = dict(d.attrs) if d.name in ("fused_build", "cold_host_serve") else {}
        out.append((d.name, d.fired, d.why, attrs))
    return out


def _drain_port(db, timeout=60.0) -> None:
    te = db.query_engine.tile_executor()
    deadline = time.monotonic() + timeout
    while te.fused_pending():
        assert time.monotonic() < deadline, "the port's fused builds did not drain"
        time.sleep(0.02)


def _drain_ref(db, timeout=60.0) -> None:
    """tests/test_fused_build.py's `_drain_fused`."""
    te = db.query_engine._tile_executor
    deadline = time.monotonic() + timeout
    while True:
        with te._fused_lock:
            if not te._fused_builds and not te._fused_queue:
                return
        assert time.monotonic() < deadline, "the reference's fused builds did not drain"
        time.sleep(0.02)


class Pair:
    """The port's and the reference's Database over the same writes."""

    def __init__(self, tmp_path, tag="p", strategy="auto", fused=True, mesh=0):
        cfg = JaxConfig()
        cfg.query.disabled_passes = REF_DISABLED
        cfg.query.agg_strategy = strategy
        cfg.query.tile_persist_enable = False
        cfg.query.fallback_to_cpu = False
        cfg.query.tpu_min_rows = 1
        cfg.storage.compaction_background_enable = False
        cfg.tile.fused_build = fused
        self.ref = JaxDatabase(config=cfg, data_home=str(tmp_path / f"{tag}_jax"))
        # its cache over one device, as the port's: with several it drops
        # the device planes on a delta extend where one device patches them
        cache = self.ref.query_engine.tile_cache
        cache.devices = list(cache.devices[:1])
        pcfg = Config()
        pcfg.query.agg_strategy = strategy
        pcfg.query.tpu_min_rows = 1
        pcfg.tile.fused_build = fused
        pcfg.tile.mesh_devices = mesh
        self.port = Database(str(tmp_path / f"{tag}_port"), device="cpu", config=pcfg)

    def sql(self, text):
        self.port.sql(text)
        self.ref.sql(text)

    def write(self, rows: pa.Table, table="cpu"):
        self.port.write(table, rows)
        self.ref.insert_rows(table, rows)

    def flush(self):
        self.port.flush()
        self.ref.storage.flush_all()

    def drain(self):
        _drain_port(self.port)
        _drain_ref(self.ref)

    @property
    def executors(self):
        return self.port.query_engine.tile_executor(), self.ref.query_engine._tile_executor

    def lower_bounds(self, **bounds):
        for ex in self.executors:
            for name, value in bounds.items():
                setattr(ex, name, value)

    def query(self, sql, same_bytes=True):
        """(port table, its decisions): both packages record the same
        decisions and give the same bytes (or, with `same_bytes` False, the
        same rows within test_torch_tile's tolerances)."""
        pt, rt = passes.PassTrace(), jax_passes.PassTrace()
        with passes.use_trace(pt):
            got = self.port.sql_one(sql)
        with jax_passes.use_trace(rt):
            want = self.ref.sql_one(sql)
        mine, theirs = _decisions(pt), _decisions(rt)
        assert mine == theirs, (sql, mine, theirs)
        self.port_trace = pt
        if same_bytes:
            assert _ser(got) == _ser(want), (sql, got.to_pydict(), want.to_pydict())
        else:
            _assert_same(got, want, sql, ordered=True)
        return got, mine

    def close(self):
        self.port.close()
        self.ref.close()


def route_of(decisions) -> str:
    fired = [name for name, f, _why, _a in decisions if f]
    return fired[-1] if fired else "device"


# ---- the reference's cases (tests/test_fused_build.py) ---------------------------------


def _mk(pair, append=True):
    pair.sql("CREATE TABLE cpu (host STRING, ts TIMESTAMP(3) TIME INDEX,"
             " u DOUBLE, v DOUBLE, w DOUBLE, PRIMARY KEY (host))"
             + (" WITH (append_mode = 'true')" if append else ""))


def _load(pair, rng, hosts=6, ticks=160, t0=0):
    """The reference test's load: NULL tags and NULL values; u stays
    non-null so limb planes engage."""
    rows = []
    for t in range(ticks):
        for h in range(hosts):
            host = "NULL" if rng.random() < 0.02 else f"'h{h}'"
            v = "NULL" if rng.random() < 0.1 else f"{rng.uniform(0, 100):.6f}"
            rows.append(f"({host}, {t0 + t * 1000}, {rng.uniform(0, 100):.6f},"
                        f" {v}, {rng.uniform(0, 100):.6f})")
    pair.sql("INSERT INTO cpu VALUES " + ",".join(rows))


FAMILY = [
    # distinct plane manifests: columns, a window or none, last_value, a
    # scalar aggregate with a value filter
    "SELECT host, time_bucket('30s', ts) AS tb, avg(u) AS a, count(*) AS c"
    " FROM cpu WHERE ts >= 20000 AND ts < 120000 GROUP BY host, tb",
    "SELECT host, time_bucket('30s', ts) AS tb, avg(v) AS a, max(w) AS m"
    " FROM cpu WHERE ts >= 20000 AND ts < 120000 GROUP BY host, tb",
    "SELECT host, last_value(u) AS lu FROM cpu GROUP BY host",
    "SELECT count(*) AS n, max(u) AS m FROM cpu WHERE u > 50.0",
]


def _run_family(tmp_path, tag, fused, strategy, mesh) -> list:
    """The reference's `_run_family` on both sides: a cold pass, an
    appended flush (the delta route) and another pass, the drain, then a
    settling run and a warm run of each query; returns the port's warm
    tables.  The builders drain before the flush too: where a build
    stands when the flush lands decides the next query's route, and the
    two packages' builders keep their own time."""
    pair = Pair(tmp_path, tag, strategy=strategy, fused=fused, mesh=mesh)
    try:
        rng = np.random.default_rng(7)
        _mk(pair)
        _load(pair, rng)
        pair.flush()
        for q in FAMILY:
            pair.query(q)
        if fused:
            pair.drain()
        _load(pair, rng, ticks=30, t0=200_000)
        pair.flush()
        for q in FAMILY:
            pair.query(q)
        if fused:
            pair.drain()
        warm = []
        for q in FAMILY:
            pair.query(q)
            got, decisions = pair.query(q)
            assert route_of(decisions) == "device", (q, decisions)
            warm.append(got)
        te = pair.port.query_engine.tile_executor()
        assert te.last_fused_error is None
        assert pair.port.query_engine.stats.get("fused_build_errors", 0) == 0
        return warm
    finally:
        pair.close()


@pytest.mark.parametrize("strategy,mesh", [("auto", 0), ("sort", 1), ("hash", 0)])
def test_fused_family_warm_bit_parity(tmp_path, strategy, mesh):
    """Warm results after the fused family build are the bytes of warm
    results after per-query builds: the union build's planes are the
    per-query planes."""
    fused = _run_family(tmp_path, "on", True, strategy, mesh)
    legacy = _run_family(tmp_path, "off", False, strategy, mesh)
    for q, a, b in zip(FAMILY, fused, legacy):
        assert _ser(a) == _ser(b), q


def _vs_cpu(db, sql, got, rtol=1e-9, keys=None):
    """The port's answer against its own CPU backend (the reference's
    tolerance), both sorted by `keys` (the first column and tb)."""
    db.config.query.backend = "cpu"
    try:
        want = db.sql_one(sql)
    finally:
        db.config.query.backend = "torch"
    keys = [(k, "ascending") for k in keys or [got.column_names[0]]
            + [c for c in ("tb",) if c in got.column_names]]
    g, w = got.sort_by(keys).to_pydict(), want.sort_by(keys).to_pydict()
    assert list(g) == list(w), sql
    for c in g:
        for x, y in zip(g[c], w[c]):
            if isinstance(x, float) and isinstance(y, float):
                assert x == y or (np.isnan(x) and np.isnan(y)) or \
                    abs(x - y) <= rtol * max(1.0, abs(y)), (sql, c, x, y)
            else:
                assert x == y, (sql, c, x, y)


def test_fused_cold_serves_every_family_before_planes(tmp_path):
    """After a (host-only) fused prewarm every family's first touch answers
    from the host consolidation — lastpoint and the filtered scalar
    aggregate included — with no plane upload on the query's thread."""
    pair = Pair(tmp_path)
    try:
        _mk(pair)
        _load(pair, np.random.default_rng(11))
        pair.flush()
        mine = pair.port.prewarm(tables=["cpu"])
        theirs = pair.ref.prewarm(tables=["cpu"])
        assert mine["public.cpu"]["regions_built"] == theirs["public.cpu"]["regions_built"] == 1
        cache = pair.port.query_engine.tile_cache
        assert all(not e.cols and e.valid is None for e in cache._super.values()), \
            "the fused prewarm uploaded device planes"
        assert cache.stats()["bytes"] == 0
        eng = pair.port.query_engine
        cs0, mf0 = eng.stats.get("cold_serves", 0), cache.stats()["fused_manifests"]
        cold = []
        for q in FAMILY:
            got, decisions = pair.query(q)
            assert route_of(decisions) == "cold_host_serve", (q, decisions)
            assert ("fused_build", True) in [(n, f) for n, f, _w, _a in decisions]
            assert "upload" not in eng.last_timings and "dispatch" not in eng.last_timings
            cold.append(got)
        assert eng.stats["cold_serves"] - cs0 == len(FAMILY)
        assert cache.stats()["fused_manifests"] - mf0 >= len(FAMILY)
        pair.drain()
        for q, t in zip(FAMILY, cold):
            _vs_cpu(pair.port, q, t)
        for q in FAMILY:  # the builds warmed every family
            _got, decisions = pair.query(q)
            assert route_of(decisions) == "device", (q, decisions)
    finally:
        pair.close()


def test_fused_decode_once_contract(tmp_path):
    """A whole family's cold build decodes each SST file once; warm runs
    decode none."""
    pair = Pair(tmp_path)
    try:
        _mk(pair)
        _load(pair, np.random.default_rng(3))
        pair.flush()
        ctx = pair.port._tile_context(TableScan(table="cpu", database="public"))
        n_files = sum(len(r.tile_snapshot()[0]) for r in ctx.regions)
        assert n_files >= 1
        cache = pair.port.query_engine.tile_cache
        d0 = cache.stats()["file_decodes"] if cache is not None else 0
        r0 = metrics.TILE_FILE_DECODES.get()
        for q in FAMILY:
            pair.query(q)
        pair.drain()
        for q in FAMILY:
            pair.query(q)
        cache = pair.port.query_engine.tile_cache
        assert cache.stats()["file_decodes"] - d0 == n_files
        assert metrics.TILE_FILE_DECODES.get() - r0 == n_files
        assert cache.stats()["fused_decodes_saved"] > 0
    finally:
        pair.close()


def test_fused_build_coalesces_concurrent_queries(tmp_path, monkeypatch):
    """While a family's build is in flight, the family's next query waits
    for it and reads its planes instead of building them again."""
    pair = Pair(tmp_path)
    try:
        _mk(pair)
        _load(pair, np.random.default_rng(5), ticks=80)
        pair.flush()
        union = TileCacheManager.fused_union_build
        held = []

        def slow_union(self, *a, **k):
            held.append(1)
            time.sleep(1.5)  # the reference arms `tile.fused_build` with this latency
            return union(self, *a, **k)

        monkeypatch.setattr(TileCacheManager, "fused_union_build", slow_union)
        fi.REGISTRY.arm("tile.fused_build", fail_times=1, latency_s=1.5)
        cache = pair.port.query_engine.tile_cache
        q = FAMILY[0]
        t1, d1 = pair.query(q)
        assert route_of(d1) == "cold_host_serve"
        c0 = pair.port.query_engine.tile_cache.stats()["build_coalesced"]
        builds0 = pair.port.query_engine.tile_cache.stats()["builds"]
        t2, d2 = pair.query(q)  # waits for the build in flight
        cache = pair.port.query_engine.tile_cache
        assert held and cache.stats()["build_coalesced"] == c0 + 1
        assert route_of(d2) == "device"
        # the builder built the planes; the waiter uploaded nothing
        timings = pair.port.query_engine.last_timings
        assert "upload" not in timings and "dispatch" in timings, timings
        assert cache.stats()["builds"] > builds0
        k = [("host", "ascending"), ("tb", "ascending")]
        assert _ser(t1.sort_by(k)) == _ser(t2.sort_by(k))
    finally:
        pair.close()


def test_fused_build_failure_leaves_queries_healthy(tmp_path, monkeypatch):
    """A background build that fails never fails (or wrongs) a query: the
    failure is counted and kept, and the next touch builds on its own
    thread."""
    pair = Pair(tmp_path)
    try:
        _mk(pair)
        _load(pair, np.random.default_rng(9), ticks=60)
        pair.flush()

        def failing_union(self, *a, **k):
            raise RuntimeError("union build failed")

        direct = TileExecutor.execute_direct

        def failing_ghost(self, *a, **k):
            if in_fused_build():
                raise RuntimeError("ghost run failed")
            return direct(self, *a, **k)

        monkeypatch.setattr(TileCacheManager, "fused_union_build", failing_union)
        monkeypatch.setattr(TileExecutor, "execute_direct", failing_ghost)
        fi.REGISTRY.arm("tile.fused_build", fail_times=10, error=RuntimeError)
        q = FAMILY[0]
        t1, d1 = pair.query(q)
        assert route_of(d1) == "cold_host_serve"
        pair.drain()
        te = pair.port.query_engine.tile_executor()
        assert pair.port.query_engine.stats["fused_build_errors"] == 2
        assert str(te.last_fused_error) == "ghost run failed"
        cache = pair.port.query_engine.tile_cache
        assert cache.stats()["builds"] == 0 and cache.stats()["bytes"] == 0
        t2, d2 = pair.query(q)  # built on the query's own thread
        assert route_of(d2) == "device" and cache.stats()["builds"] >= 1
        monkeypatch.undo()
        fi.REGISTRY.disarm()
        t3, _d3 = pair.query(q)
        for t in (t1, t2, t3):
            _vs_cpu(pair.port, q, t)
        assert pair.port.query_engine.stats["fused_build_errors"] == 2
    finally:
        pair.close()


def test_fused_hash_scale_group_space_cold_serve(tmp_path):
    """A group space past 2^22 (three 200-value tags) cold-serves through
    the unique-compacted fold; the build then takes it to the card."""
    pair = Pair(tmp_path)
    try:
        pair.sql("CREATE TABLE m (a STRING, b STRING, c STRING, ts TIMESTAMP(3) TIME INDEX,"
                 " x DOUBLE, PRIMARY KEY (a, b, c)) WITH (append_mode = 'true')")
        rng = np.random.default_rng(13)
        rows = [f"('a{rng.integers(0, 200)}', 'b{rng.integers(0, 200)}',"
                f" 'c{rng.integers(0, 200)}', {i * 1000}, {rng.uniform(0, 10):.6f})"
                for i in range(600)]
        pair.sql("INSERT INTO m VALUES " + ",".join(rows))
        pair.flush()
        q = "SELECT a, b, c, sum(x) AS s, count(*) AS n FROM m GROUP BY a, b, c"
        cs0 = pair.port.query_engine.stats.get("cold_serves", 0)
        t, decisions = pair.query(q)
        assert route_of(decisions) == "cold_host_serve", decisions
        assert pair.port.query_engine.stats["cold_serves"] == cs0 + 1
        _vs_cpu(pair.port, q, t, keys=["a", "b", "c"])
        pair.drain()
        t2, decisions = pair.query(q)
        assert route_of(decisions) == "device"
        assert t2.num_rows == t.num_rows
    finally:
        pair.close()


def test_build_gate_coalesces_prewarm_and_queries(tmp_path):
    """Concurrent whole-table builds collapse to one leader; the others
    wait for it (counted in `build_coalesced`)."""
    db = Database(str(tmp_path / "gate"), device="cpu")
    try:
        db.query_engine.tile_executor()
        cache = db.query_engine.tile_cache
        ran = []
        barrier = threading.Barrier(3)

        def enter():
            barrier.wait()
            with cache.build_gate("public.cpu") as leader:
                if leader:
                    time.sleep(0.2)  # hold the gate so the others must wait
                ran.append(leader)

        threads = [threading.Thread(target=enter) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        assert sorted(ran) == [False, False, True]
        assert cache.stats()["build_coalesced"] == 2
    finally:
        db.close()


def test_cache_counters_under_threads(tmp_path):
    """The cache's counters take no lost update from the query and builder
    threads counting at once (a switch interval shortened to provoke
    one)."""
    import sys

    db = Database(str(tmp_path / "counters"), device="cpu")
    try:
        db.query_engine.tile_executor()
        cache = db.query_engine.tile_cache
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(
                target=lambda: [cache.count(file_decodes=1, build_coalesced=2)
                                for _ in range(2000)]) for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
                assert not t.is_alive()
        finally:
            sys.setswitchinterval(old)
        stats = cache.stats()
        assert stats["file_decodes"] == 16 * 2000 and stats["build_coalesced"] == 2 * 16 * 2000
    finally:
        db.close()


def test_prewarm_coalesces_onto_a_running_build(tmp_path, monkeypatch):
    """A fused prewarm that finds the table's build running waits for it
    and reports it coalesced; alone it leads."""
    pair = Pair(tmp_path)
    try:
        _mk(pair)
        _load(pair, np.random.default_rng(2), ticks=40)
        pair.flush()
        cache = pair.port.query_engine.tile_executor().cache
        entered, release = threading.Event(), threading.Event()

        def hold():
            with cache.build_gate("public.cpu"):
                entered.set()
                release.wait()

        t = threading.Thread(target=hold)
        t.start()
        assert entered.wait(timeout=30)
        out = {}
        waiter = threading.Thread(target=lambda: out.update(pair.port.prewarm()))
        waiter.start()
        time.sleep(0.1)
        release.set()
        for th in (t, waiter):
            th.join(timeout=60)
            assert not th.is_alive()
        assert out["public.cpu"]["coalesced"] is True
        assert out["public.cpu"]["regions_built"] == 0
        again = pair.port.prewarm()["public.cpu"]
        assert again["regions_built"] == 1 and "coalesced" not in again
    finally:
        pair.close()


def test_fused_off_restores_serve_once_ladder(tmp_path):
    """`tile.fused_build = False`: the legacy ladder — one cold serve an
    entry, the second touch builds on the query's thread, and no builder
    thread is started."""
    pair = Pair(tmp_path, fused=False)
    try:
        _mk(pair)
        _load(pair, np.random.default_rng(17), ticks=60)
        pair.flush()
        q = FAMILY[0]
        _t, decisions = pair.query(q)
        assert route_of(decisions) == "cold_host_serve"
        assert not any(n == "fused_build" for n, _f, _w, _a in decisions)
        cache = pair.port.query_engine.tile_cache
        entries = list(cache._super.values())
        assert entries and all(e.cold_served and not e.cols for e in entries)
        te = pair.port.query_engine.tile_executor()
        assert te._fused_thread is None
        _t, decisions = pair.query(q)
        assert route_of(decisions) == "device"
        assert any(e.cols for e in cache._super.values())
        # lastpoint: the legacy ladder does not cold-serve last_value
        _t, decisions = pair.query(FAMILY[2])
        assert route_of(decisions) == "device"
        assert te._fused_thread is None
    finally:
        pair.close()


def test_fused_off_by_the_pass_alone(tmp_path):
    """`fused_build` in query.disabled_passes is the same legacy ladder."""
    cfg = Config()
    cfg.query.disabled_passes = ("fused_build",)
    db = Database(str(tmp_path / "pass"), device="cpu", config=cfg)
    try:
        db.sql("CREATE TABLE cpu (host STRING, ts TIMESTAMP(3) TIME INDEX, u DOUBLE,"
               " v DOUBLE, w DOUBLE, PRIMARY KEY (host)) WITH (append_mode = 'true')")
        db.sql("INSERT INTO cpu VALUES ('h0', 0, 1, 2, 3), ('h1', 1000, 4, 5, 6)")
        db.flush()
        for _ in range(2):
            db.sql_one(FAMILY[0])
        assert db.query_engine.tile_executor()._fused_thread is None
        assert db.query_engine.stats["cold_serves"] == 1
    finally:
        db.close()


@pytest.mark.parametrize("value", [1, "yes", None])
def test_fused_build_validated(value):
    with pytest.raises(ConfigError):
        TileConfig(fused_build=value).validate()


# ---- the seeded differential ---------------------------------------------------------

DIFF_QUERIES = [
    # a wide pk slice: host-served while its planes are cold (`wide_cold`),
    # its build scheduled; once they are warm, the card's
    "SELECT count(*) AS n, sum(usage_user) AS s, max(usage_system) AS m FROM cpu"
    " WHERE host IN ('h1', 'h2', 'h4')",
    # host x bucket: compacted past the lowered group bound
    "SELECT host, time_bucket('30s', ts) AS tb, avg(usage_user) AS a, max(usage_system) AS m,"
    " count(*) AS c FROM cpu GROUP BY host, tb",
    # bucket-only: a time-major family; dense and chunk-parallel
    "SELECT time_bucket('1m', ts) AS tb, sum(usage_user) AS s, min(usage_system) AS mn,"
    " count(usage_system) AS cs FROM cpu GROUP BY tb",
    # windowed, a value filter: a window geometry in the manifest
    "SELECT region, avg(usage_system) AS a, count(usage_system) AS c FROM cpu"
    " WHERE usage_user < 50 AND ts >= 10000 AND ts < 310000 GROUP BY region",
    # last_value from run boundaries (group tags, no bucket)
    "SELECT host, region, last_value(usage_user) AS lu, last_value(usage_system) AS ls"
    " FROM cpu GROUP BY host, region",
    # scalar with a filter
    "SELECT count(*) AS n, max(usage_user) AS m, sum(usage_system) AS s FROM cpu"
    " WHERE usage_user > 30",
    # a pk equality: the host fast path, warm or cold
    "SELECT time_bucket('1m', ts) AS tb, max(usage_user) AS mu FROM cpu"
    " WHERE host = 'h3' GROUP BY tb",
    # ORDER BY / LIMIT over a compacted group space
    "SELECT host, time_bucket('10s', ts) AS tb, sum(usage_user) AS s FROM cpu"
    " GROUP BY host, tb ORDER BY s DESC, host, tb LIMIT 5",
]

DIFF_CASES = [(seed, strategy) for seed in (0, 1) for strategy in ("sort", "hash", "auto")]


def _spy_folds(monkeypatch) -> dict:
    """Count the port's chunk-parallel and compacted cold folds."""
    seen = {"parallel": 0, "compact": 0}
    pool = tile_host.ThreadPoolExecutor
    stitch = HostRoutes._stitch_compact

    def counting_pool(*a, **k):
        seen["parallel"] += 1
        return pool(*a, **k)

    def counting_stitch(self, *a, **k):
        seen["compact"] += 1
        return stitch(self, *a, **k)

    monkeypatch.setattr(tile_host, "ThreadPoolExecutor", counting_pool)
    monkeypatch.setattr(HostRoutes, "_stitch_compact", counting_stitch)
    return seen


@pytest.mark.parametrize("seed,strategy", DIFF_CASES)
def test_seeded_differential(tmp_path, monkeypatch, seed, strategy):
    """Cold, warm, and after an appended flush (the delta route): on an
    append table, then a non-append one whose flushed files overlap (the
    keep plane) with an unflushed tail after them, the same decisions and
    bytes in both packages.  The bounds are lowered on both sides: sources
    of 2 x 256 rows or more fold in ranges of 256 on the pool, group
    spaces past 32 fold compacted, a multi-key slice past 64 cells leaves
    the host fast path once its planes are warm.  Both builders drain after
    each query: a route that reads whether planes are resident (the wide
    slice's) must not race the builders, which keep their own time."""
    seen = _spy_folds(monkeypatch)
    for append in (True, False):
        pair = Pair(tmp_path, f"{int(append)}", strategy=strategy)
        try:
            pair.lower_bounds(_COLD_PAR_ROWS=256, _COLD_COMPACT_GROUPS=32,
                              _HOST_PATH_MAX_CELLS=64)
            rng = np.random.default_rng(seed)
            pair.sql(DDL.format(pk="host, region",
                                opts=" WITH (append_mode = 'true')" if append else ""))
            pair.write(_rows(rng, 6, 0, 240, nulls=True))
            pair.flush()
            pair.write(_rows(rng, 6, 200 if not append else 240, 300, nulls=True))
            pair.flush()
            pair.write(_rows(rng, 6, 300, 330, nulls=False))  # the memtable tail
            routes = []

            wide = []

            def one_pass():
                for sql in DIFF_QUERIES:
                    _got, decisions = pair.query(sql)
                    routes.append((route_of(decisions), decisions))
                    wide.append(any(d.attrs.get("wide_cold") for d in pair.port_trace.decisions))
                    pair.drain()

            one_pass()
            cold = [r for r, _d in routes]
            assert cold[0] == "host_fast_path", routes[0]
            assert cold.count("cold_host_serve") >= 5, cold
            # the wide slice was served cold and scheduled its family
            assert wide[0] and not any(wide[1:]), wide
            one_pass()
            warm = [r for r, _d in routes[len(DIFF_QUERIES):]]
            assert warm[0] == "device" and "host_fast_path" in warm, warm
            # a flush: the memtable tail joins the files (delta extend)
            pair.flush()
            pair.write(_rows(rng, 6, 330, 345, nulls=True))
            one_pass()
            assert pair.port.query_engine.stats.get("fused_build_errors", 0) == 0
        finally:
            pair.close()
    assert seen["parallel"] > 0 and seen["compact"] > 0, seen


# ---- the TSBS queries' first touches (chip_smoke.py's phase 5e) --------------------------


def test_tsbs_first_touch_routes(tmp_path):
    """The 15 TSBS queries (40 hosts x 12 h, the ten metrics) in phase 5e's
    cold order: each first touch takes the route `FUSED_COLD_ROUTES` names
    in both packages (cpu-max-all-8's wide slice `wide_cold`, lastpoint a
    fused cold serve) with the same bytes; after the drain the pk-equality
    queries stay on the host and the seven others take the card
    (`WARM_ROUTES`), within test_torch_tile's tolerances of the
    reference."""
    tsbs = chip_smoke.Tsbs(40, 12)
    pair = Pair(tmp_path, "tsbs")
    try:
        chip_smoke.ingest(_JaxWriter(pair.ref), tsbs)
        chip_smoke.ingest(pair.port, tsbs)
        queries = dict(tsbs.queries())
        for name in chip_smoke.FUSED_COLD_ORDER:
            _got, decisions = pair.query(queries[name])
            assert route_of(decisions) == chip_smoke.FUSED_COLD_ROUTES[name], (name, decisions)
            wide = any(d.attrs.get("wide_cold") for d in pair.port_trace.decisions)
            assert wide == (name == "cpu-max-all-8"), name
            timings = pair.port.query_engine.last_timings
            assert "upload" not in timings and "dispatch" not in timings, (name, timings)
        pair.drain()
        for name, sql in tsbs.queries():
            _got, decisions = pair.query(sql, same_bytes=False)
            want = chip_smoke.WARM_ROUTES.get(name, "device")
            assert route_of(decisions) == want, (name, decisions)
        cache = pair.port.query_engine.tile_cache.stats()
        ssts = sum(len(r.files()) for r in (pair.port.storage.region(rid)
                                             for rid in pair.port.storage.region_ids()))
        assert cache["file_decodes"] == ssts
        assert pair.port.query_engine.stats.get("fused_build_errors", 0) == 0
    finally:
        pair.close()


# ---- a TQL family's first touch --------------------------------------------------------


def test_tql_first_touch_legacy_then_tile(tmp_path):
    """Under the fused build a TQL family's first touch declines the tile
    route while its build is queued, and the legacy scan answers (a
    by-label query's per-series evaluation too: the statement stays on one
    route); after the drain the same query runs on the tile route.  Both
    equal the reference's legacy answer."""
    cfg = JaxConfig()
    cfg.tql.tile = False
    cfg.query.fallback_to_cpu = False
    ref = JaxDatabase(config=cfg, data_home=str(tmp_path / "tql_jax"))
    port = Database(str(tmp_path / "tql_port"), device="cpu")

    class _W:
        def sql(self, text):
            port.sql(text)
            ref.sql(text)

        def flush(self):
            port.flush()
            ref.storage.flush_all()

    def run(q):
        before, trace = dict(eng.stats), passes.PassTrace()
        with passes.use_trace(trace):
            got = port.sql_one(q)
        return got, {k: eng.stats[k] - before.get(k, 0) for k in eng.stats}, trace.decisions

    try:
        rng = np.random.default_rng(29)
        _load_counter(_W(), rng, hosts=4, ticks=48)
        _load_counter(_W(), rng, hosts=5, ticks=40, table="tq2")
        eng = port.query_engine
        # each on its own table: a family whose planes are already warm
        # takes the tile route on its first touch
        for q, rtol in (("TQL EVAL (60, 540, '30s') rate(tq[2m])", 1e-12),
                        ("TQL EVAL (60, 540, '30s') sum by (host) (max_over_time(tq2[1m]))",
                         0.0)):
            want = ref.sql_one(q)
            got, delta, decisions = run(q)
            assert decisions[0].name == "tql_tile" and decisions[0].attrs == {"cold": True}
            assert delta["tql_tile_cold_serves"] == 1, delta
            assert delta["tql_legacy"] == 1 and delta["tql_tile_dispatches"] == 0, delta
            _assert_same_tql(got, want, q, rtol=rtol)
            _drain_port(port)
            assert eng.stats.get("fused_build_errors", 0) == 0
            again, delta, _d = run(q)
            assert delta["tql_tile_dispatches"] == 1 and delta["tql_legacy"] == 0, delta
            _assert_same_tql(again, want, q, rtol=rtol)
    finally:
        port.close()
        ref.close()
