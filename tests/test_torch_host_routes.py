"""The tile path's host routing ladder: `cost_route`, `host_fast_path`,
`cold_host_serve` (the legacy ladder) and `Database.prewarm`, in the
port's Database (device="cpu") beside the reference's Database on the
same writes.

The reference runs at its defaults with the passes the port lacks
switched off (`fused_build` among them, so its cold serve takes the
legacy ladder), no tile persistence and no CPU fallback; the port at its
defaults with `fused_build` switched off too.  The cases mirror the reference's tests/test_tile_cache.py
(`test_host_fast_path_selective_queries`,
`test_host_fast_path_includes_memtable`,
`test_cold_host_serve_then_device_build`) and
tests/test_optimizer_passes.py (`test_disabling_host_fast_path_still_serves`),
and add a seeded differential (append and non-append tables with
overlapping files and overwrites, NULL values, `=` / `IN` / `!=` on the
pk, residual value, pk and ts filters, bucketed and scalar outputs,
memtable tails, the three route bounds lowered on both sides so each
guard's two branches run), the cost route's estimate, prewarm and a
dashboard tick with host-served members.

Every query must record the same `cost_route` / `host_fast_path` /
`cold_host_serve` decisions (name, fired, why) in both packages and give
the same bytes (Arrow IPC).  The data is integer-valued, so sums are
exact in any order and the card's answers are bytes too."""

import io

import numpy as np
import pyarrow as pa
import pytest
import torch

from greptimedb_tpu.database import Database as JaxDatabase
from greptimedb_tpu.query import passes as jax_passes
from greptimedb_tpu.query.planner import plan_query as jax_plan_query
from greptimedb_tpu.query.sql_parser import parse_sql as jax_parse_sql
from greptimedb_tpu.query.tpu_exec import try_lower as jax_try_lower
from greptimedb_tpu.utils import metrics
from greptimedb_tpu.utils.config import Config as JaxConfig
from greptimedb_tpu_torch import Database
from greptimedb_tpu_torch.query import passes
from greptimedb_tpu_torch.query.device_exec import try_lower
from greptimedb_tpu_torch.query.planner import plan_query
from greptimedb_tpu_torch.query.sql_parser import parse_sql
from greptimedb_tpu_torch.utils.config import Config, QueryConfig
from greptimedb_tpu_torch.utils.errors import ConfigError
from test_torch_batch import _concurrent, _delta, _solo
from test_torch_tile import HOST_ROUTES, UNPORTED_PASSES, _assert_same

# the legacy ladder: the reference's passes the port still lacks and its
# fused build off (the port names `fused_build` too, `PORT_DISABLED`);
# tests/test_torch_fused_build.py holds the fused ladder
ROUTES = ("cost_route", "host_fast_path", "cold_host_serve")
REF_DISABLED = tuple(p for p in UNPORTED_PASSES if p not in ROUTES)
PORT_DISABLED = ("fused_build",)
# the three bounds, lowered on both sides' executors
BOUNDS = ("_HOST_PATH_MAX_ROWS", "_HOST_PATH_MAX_CELLS", "_COLD_COMPACT_GROUPS")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ser(t: pa.Table) -> bytes:
    sink = io.BytesIO()
    with pa.ipc.new_stream(sink, t.schema) as w:
        w.write_table(t)
    return sink.getvalue()


class Pair:
    """The port's and the reference's Database over the same writes."""

    def __init__(self, tmp_path, strategy="auto", tpu_min_rows=0, window_ms=0.0):
        cfg = JaxConfig()
        cfg.query.disabled_passes = REF_DISABLED
        cfg.query.agg_strategy = strategy
        cfg.query.tile_persist_enable = False
        cfg.query.fallback_to_cpu = False
        cfg.query.tpu_min_rows = tpu_min_rows
        cfg.storage.compaction_background_enable = False
        self.ref = JaxDatabase(config=cfg, data_home=str(tmp_path / "jax"))
        pcfg = Config()
        pcfg.query.disabled_passes = PORT_DISABLED
        pcfg.query.agg_strategy = strategy
        pcfg.query.tpu_min_rows = tpu_min_rows
        pcfg.batch.window_ms = window_ms
        self.port = Database(str(tmp_path / "port"), device="cpu", config=pcfg)

    def sql(self, text):
        self.port.sql(text)
        self.ref.sql(text)

    def write(self, rows: pa.Table, table="cpu"):
        self.port.write(table, rows)
        self.ref.insert_rows(table, rows)

    def flush(self):
        self.port.flush()
        self.ref.storage.flush_all()

    @property
    def executors(self):
        return self.port.query_engine.tile_executor(), self.ref.query_engine._tile_executor

    def lower_bounds(self, **bounds):
        for ex in self.executors:
            for name, value in bounds.items():
                setattr(ex, name, value)

    def query(self, sql):
        """(port table, its route decisions): both packages must record the
        same decisions and give the same bytes."""
        pt, rt = passes.PassTrace(), jax_passes.PassTrace()
        with passes.use_trace(pt):
            got = self.port.sql_one(sql)
        with jax_passes.use_trace(rt):
            want = self.ref.sql_one(sql)
        mine = [(d.name, d.fired, d.why) for d in pt.decisions if d.name in ROUTES]
        theirs = [(d.name, d.fired, d.why) for d in rt.decisions if d.name in ROUTES]
        assert mine == theirs, (sql, mine, theirs)
        assert _ser(got) == _ser(want), (sql, got.to_pydict(), want.to_pydict())
        return got, mine

    def close(self):
        self.port.close()
        self.ref.close()


def route_of(decisions) -> str:
    fired = [name for name, f, _why in decisions if f]
    return fired[-1] if fired else "device"


DDL = ("CREATE TABLE cpu (host STRING, region STRING, ts TIMESTAMP TIME INDEX,"
       " usage_user DOUBLE, usage_system DOUBLE, PRIMARY KEY ({pk})){opts}")


def _rows(rng, hosts, t_lo, t_hi, nulls: bool) -> pa.Table:
    """Every host at every second of [t_lo, t_hi) (s), integer values,
    usage_system NULL on a seeded share of rows."""
    ts = np.arange(t_lo, t_hi, dtype=np.int64) * 1000
    h = np.repeat(np.arange(hosts), len(ts))
    t = np.tile(ts, hosts)
    user = rng.integers(0, 100, len(t)).astype(np.float64)
    system = rng.integers(0, 10, len(t)).astype(np.float64)
    sys_arr = pa.array(system, mask=(rng.random(len(t)) < 0.1) if nulls else None)
    return pa.table({
        "host": pa.array([f"h{i}" for i in h]),
        "region": pa.array([f"r{i % 2}" for i in h]),
        "ts": pa.array(t, pa.timestamp("ms")),
        "usage_user": pa.array(user), "usage_system": sys_arr,
    })


def _load(pair, seed, append: bool, pk="host, region", hosts=6):
    """Two flushed files over overlapping time ranges (the second
    overwrites a time range of the first on a non-append table), then an
    unflushed tail after them."""
    rng = np.random.default_rng(seed)
    pair.sql(DDL.format(pk=pk, opts=" WITH (append_mode = 'true')" if append else ""))
    pair.write(_rows(rng, hosts, 0, 240, nulls=True))
    pair.flush()
    pair.write(_rows(rng, hosts, 200, 300, nulls=True))
    pair.flush()
    pair.write(_rows(rng, hosts, 300, 330, nulls=False))


DIFF_QUERIES = [
    # pk equality, scalar, over every source
    "SELECT count(*) AS n, max(usage_user) AS m, min(usage_system) AS mn, sum(usage_system) AS s,"
    " avg(usage_user) AS a, count(usage_system) AS cs FROM cpu WHERE host = 'h3'",
    # pk equality, bucketed, ts window
    "SELECT time_bucket('30s', ts) AS tb, avg(usage_user) AS au, count(*) AS c FROM cpu"
    " WHERE host = 'h2' AND ts >= 20000 AND ts < 260000 GROUP BY tb",
    # IN, bucketed, open-ended window
    "SELECT time_bucket('1m', ts) AS tb, max(usage_user) AS mu, sum(usage_system) AS s FROM cpu"
    " WHERE host IN ('h1', 'h4') AND ts > 5000 GROUP BY tb",
    # IN minus !=, residual value filter, ts <=
    "SELECT count(*) AS n, max(usage_system) AS m FROM cpu WHERE host IN ('h1', 'h4', 'h5')"
    " AND host != 'h4' AND usage_system > 2 AND ts <= 250000",
    # four keys: past the lowered slice bound
    "SELECT count(*) AS n, sum(usage_user) AS s FROM cpu WHERE host IN ('h0', 'h1', 'h2', 'h3')",
    # != alone: no equality set, the card
    "SELECT count(*) AS n, sum(usage_user) AS s FROM cpu WHERE host != 'h0'",
    # a residual on the second pk column
    "SELECT min(usage_user) AS mn, sum(usage_system) AS s FROM cpu"
    " WHERE host = 'h0' AND region = 'r0'",
    # grouped: the cold serve, then the card
    "SELECT host, time_bucket('30s', ts) AS tb, avg(usage_user) AS a, max(usage_system) AS m,"
    " count(*) AS c FROM cpu GROUP BY host, tb",
    # grouped, windowed, a value filter
    "SELECT region, avg(usage_system) AS a, count(usage_system) AS c FROM cpu"
    " WHERE usage_user < 50 AND ts >= 10000 AND ts < 310000 GROUP BY region",
    # host-served then replayed on the host: ORDER BY / LIMIT
    "SELECT time_bucket('10s', ts) AS tb, max(usage_user) AS m FROM cpu WHERE host = 'h1'"
    " GROUP BY tb ORDER BY m DESC, tb LIMIT 3",
    # last_value: neither route
    "SELECT host, region, last_value(usage_user) AS lu FROM cpu GROUP BY host, region",
]

DIFF_CASES = [(seed, strategy, append) for seed in (0, 1)
              for strategy in ("sort", "hash", "auto") for append in (True, False)]


@pytest.mark.parametrize("seed,strategy,append", DIFF_CASES)
def test_seeded_differential(tmp_path, seed, strategy, append):
    """Cold then warm passes over the query list: the same route decisions
    and bytes in both packages.  Odd seeds lower the three bounds on both
    sides: two keys' slice passes the row bound, four keys' does not; any
    multi-key slice is wide (served while the planes are cold, the card's
    once they are warm); every group space is past the cold serve's."""
    pair = Pair(tmp_path, strategy=strategy)
    try:
        # odd seeds: a one-column pk (each pk run ts-sorted: the window
        # narrows it), where region is a string field no query reads
        single = bool(seed % 2)
        _load(pair, seed, append, pk="host" if single else "host, region")
        if single:
            pair.lower_bounds(_HOST_PATH_MAX_ROWS=1000, _HOST_PATH_MAX_CELLS=64,
                              _COLD_COMPACT_GROUPS=16)
        queries = [q for q in DIFF_QUERIES if not (single and "region" in q)]
        routes, whys = [], []
        for _pass in range(2):
            for sql in queries:
                _got, decisions = pair.query(sql)
                routes.append(route_of(decisions))
                whys += [why for _n, _f, why in decisions]
        assert "host_fast_path" in routes and "device" in routes
        if single:
            assert any("tile dispatch beats" in why for why in whys)
        else:
            assert "cold_host_serve" in routes
    finally:
        pair.close()


# ---- the reference's own cases -------------------------------------------------------

Q = ("SELECT host, time_bucket('30s', ts) AS tb, avg(usage_user) AS au,"
     " max(usage_system) AS ms, count(*) AS c FROM cpu GROUP BY host, tb")


def _ref_load(pair, hosts=6, ticks=120, t0=0):
    """tests/test_tile_cache.py's `_load`."""
    rows = []
    for t in range(ticks):
        for h in range(hosts):
            rows.append(f"('host_{h}', 'r{h % 2}', {t0 + t * 1000}, {t % 13 + h}, {(t + h) % 7})")
    pair.sql("INSERT INTO cpu VALUES " + ",".join(rows))


def _vs_cpu(pair, sql, got):
    """The port's answer against its own CPU backend."""
    pair.port.config.query.backend = "cpu"
    try:
        want = pair.port.sql_one(sql)
    finally:
        pair.port.config.query.backend = "torch"
    keys = [c for c in got.column_names if c == "tb"] or [got.column_names[0]]
    _assert_same(got.sort_by([(k, "ascending") for k in keys]),
                 want.sort_by([(k, "ascending") for k in keys]), sql, ordered=True)


@pytest.fixture()
def pair(tmp_path):
    p = Pair(tmp_path)
    p.sql(DDL.format(pk="host, region", opts=""))
    yield p
    p.close()


def test_host_fast_path_selective_queries(pair):
    _ref_load(pair)
    pair.flush()
    pair.query(Q)  # warms the super-tile and its order
    h0 = pair.port.query_engine.stats.get("host_fast_path", 0)
    r0 = metrics.TILE_HOST_FAST_PATH.get()
    for sql in [
        "SELECT time_bucket('30s', ts) AS tb, avg(usage_user) AS au,"
        " count(*) AS c FROM cpu WHERE host = 'host_2' GROUP BY tb",
        "SELECT time_bucket('30s', ts) AS tb, max(usage_user) AS mu"
        " FROM cpu WHERE host IN ('host_1','host_4') GROUP BY tb",
        "SELECT count(*) AS n, max(usage_user) AS m FROM cpu"
        " WHERE host = 'host_3' AND usage_system > 2 AND ts >= 10000 AND ts < 60000",
        "SELECT min(usage_user) AS mn, sum(usage_system) AS s FROM cpu"
        " WHERE host = 'host_0' AND region = 'r0'",
    ]:
        got, decisions = pair.query(sql)
        assert route_of(decisions) == "host_fast_path", (sql, decisions)
        _vs_cpu(pair, sql, got)
    assert pair.port.query_engine.stats.get("host_fast_path", 0) == h0 + 4
    assert metrics.TILE_HOST_FAST_PATH.get() == r0 + 4


def test_host_fast_path_includes_memtable(pair):
    _ref_load(pair, ticks=40)
    pair.flush()
    pair.query(Q)
    _ref_load(pair, ticks=20, t0=600_000)  # an unflushed tail in a disjoint window
    sql = "SELECT count(*) AS c, avg(usage_user) AS au FROM cpu WHERE host = 'host_1'"
    got, decisions = pair.query(sql)
    assert route_of(decisions) == "host_fast_path"
    assert got["c"].to_pylist() == [60]
    _vs_cpu(pair, sql, got)


def test_cold_host_serve_then_device_build(pair):
    """The cold grouped aggregate answers from the host consolidation with
    no plane upload and no launch; the second touch builds the planes on
    the card."""
    _ref_load(pair, hosts=8, ticks=400)
    pair.flush()
    sql = ("SELECT host, time_bucket('30s', ts) AS tb, avg(usage_user) AS a,"
           " max(usage_system) AS m, count(*) AS c FROM cpu GROUP BY host, tb")
    eng = pair.port.query_engine
    s0 = dict(eng.stats)
    t1, decisions = pair.query(sql)
    assert route_of(decisions) == "cold_host_serve"
    cache = eng.tile_cache
    entries = list(cache._super.values())
    assert entries and all(e.cold_served for e in entries)
    assert all(not e.cols and e.valid is None for e in entries), "the cold serve uploaded planes"
    assert cache.stats()["bytes"] == 0 and cache.stats()["builds"] == 0
    assert eng.stats.get("cold_serves", 0) == s0.get("cold_serves", 0) + 1
    assert eng.stats["agg_sort"] + eng.stats["agg_hash"] == s0["agg_sort"] + s0["agg_hash"]
    ref_entries = list(pair.ref.query_engine.tile_cache._super.values())
    assert ref_entries and all(e.cold_served and not e.cols for e in ref_entries)
    t2, decisions = pair.query(sql)
    assert route_of(decisions) == "device"
    assert all(e.cols for e in cache._super.values()), "the second touch built no planes"
    assert cache.stats()["builds"] == 1 and cache.stats()["bytes"] > 0
    assert _ser(t1) == _ser(t2)
    _vs_cpu(pair, sql, t1)


def test_memtable_only_sources(pair):
    """No flushed file: the cold serve declines (no entry would carry its
    flag, so it would answer forever), the host fast path folds the tail."""
    _ref_load(pair, ticks=30)
    _got, decisions = pair.query(Q)
    assert route_of(decisions) == "device"
    got, decisions = pair.query(
        "SELECT count(*) AS c, max(usage_user) AS m FROM cpu WHERE host = 'host_4'")
    assert route_of(decisions) == "host_fast_path" and got["c"].to_pylist() == [30]


def test_disabling_host_fast_path_still_serves(pair):
    """tests/test_optimizer_passes.py: with `host_fast_path` disabled the
    same rows come from the card."""
    _ref_load(pair)
    pair.flush()
    pair.query(Q)
    sql = ("SELECT max(usage_user) AS m FROM cpu"
           " WHERE host = 'host_1' AND ts >= 10000 AND ts < 100000")
    on, decisions = pair.query(sql)
    assert route_of(decisions) == "host_fast_path"
    pair.port.config.query.disabled_passes = PORT_DISABLED + ("host_fast_path",)
    pair.ref.config.query.disabled_passes = REF_DISABLED + ("host_fast_path",)
    off, decisions = pair.query(sql)
    assert ("host_fast_path", False, "pass disabled") in decisions
    assert route_of(decisions) == "device"
    assert off["m"].to_pylist() == on["m"].to_pylist()


# ---- cost_route ------------------------------------------------------------------------

EST_QUERIES = [
    "SELECT count(*) AS n FROM cpu",
    "SELECT count(*) AS n FROM cpu WHERE host = 'h2'",
    "SELECT max(usage_user) AS m FROM cpu WHERE host IN ('h1', 'h3') AND ts >= 100000",
    "SELECT host, avg(usage_user) AS a FROM cpu WHERE ts >= 250000 AND ts < 320000 GROUP BY host",
]


def _estimates(pair, sql) -> tuple:
    """(port, reference) `_estimate_scan_rows` of the query's scan."""
    peng, reng = pair.port.query_engine, pair.ref.query_engine
    plan, schema = plan_query(parse_sql(sql)[0], peng.schema_of, "public")
    mine = peng._estimate_scan_rows(try_lower(plan, schema).scan, schema)
    rplan, rschema = jax_plan_query(jax_parse_sql(sql)[0], reng.schema_of, "public",
                                    reng.view_of)
    theirs = reng._estimate_scan_rows(jax_try_lower(rplan, rschema).scan, rschema)
    return mine, theirs


@pytest.mark.parametrize("sql", EST_QUERIES)
def test_cost_route_estimate_matches_reference(tmp_path, sql):
    pair = Pair(tmp_path, tpu_min_rows=1)
    try:
        _load(pair, 3, append=True)
        mine, theirs = _estimates(pair, sql)
        assert mine == theirs and mine > 0, (sql, mine, theirs)
        _got, decisions = pair.query(sql)
        assert decisions[0][:2] == ("cost_route", False)
        # a warm dictionary: tag equalities scale the estimate
        mine, theirs = _estimates(pair, sql)
        assert mine == theirs, (sql, mine, theirs)
    finally:
        pair.close()


def test_cost_route_routes_cold_small_scans_then_yields(tmp_path):
    """A scan estimated under `tpu_min_rows` runs on the CPU executor while
    no super-tile is resident, and on the tile path once one is."""
    small = "SELECT count(*) AS n, max(usage_user) AS m FROM cpu WHERE ts >= 320000"
    pair = Pair(tmp_path, tpu_min_rows=1)
    try:
        _load(pair, 4, append=True)
        est, _ = _estimates(pair, small)
        for ex_db in (pair.port, pair.ref):
            ex_db.config.query.tpu_min_rows = est + 1
        eng = pair.port.query_engine
        s0 = dict(eng.stats)
        got, decisions = pair.query(small)
        assert route_of(decisions) == "cost_route" and eng.last_path == "cpu"
        assert eng.stats.get("routed_to_cpu", 0) == s0.get("routed_to_cpu", 0) + 1
        assert eng.stats["lowered"] == s0["lowered"]
        assert not eng.tile_cache or not eng.tile_cache.stats()["regions"]
        # a large scan builds the table's super-tile; the small one follows
        _big, decisions = pair.query("SELECT host, max(usage_user) AS m FROM cpu GROUP BY host")
        assert decisions[0][:2] == ("cost_route", False)
        again, decisions = pair.query(small)
        assert decisions[0] == ("cost_route", False,
                                "scan large enough (or tiles resident) for the device path")
        assert eng.last_path == "tile" and _ser(again) == _ser(got)
    finally:
        pair.close()


@pytest.mark.parametrize("value", [-1, 1.5])
def test_tpu_min_rows_validated(value):
    with pytest.raises(ConfigError):
        QueryConfig(tpu_min_rows=value)


# ---- prewarm -------------------------------------------------------------------------


PREWARM_DDL = ("CREATE TABLE w (host STRING, ts TIMESTAMP TIME INDEX, u DOUBLE NOT NULL,"
               " v DOUBLE, PRIMARY KEY (host)){opts}")


@pytest.mark.parametrize("append", [True, False])
def test_prewarm_builds_planes_and_the_first_query_takes_the_card(tmp_path, append):
    """Prewarm uploads every numeric field and quantizes the non-null one
    (an entry past the limb geometry's 2^16 rows); the first grouped
    query then takes the card, with no cold serve and no rebuild."""
    pair = Pair(tmp_path)
    try:
        pair.sql(PREWARM_DDL.format(opts=" WITH (append_mode = 'true')" if append else ""))
        rng = np.random.default_rng(5)
        ts = np.arange(4200, dtype=np.int64) * 1000
        for lo, hi in ((0, 3000), (2500, 4200)):  # two files, overlapping
            n = (hi - lo) * 16
            pair.write(pa.table({
                "host": pa.array([f"h{i % 16}" for i in range(n)]),
                "ts": pa.array(np.repeat(ts[lo:hi], 16), pa.timestamp("ms")),
                "u": pa.array(rng.integers(0, 100, n).astype(np.float64)),
                "v": pa.array(rng.integers(0, 9, n).astype(np.float64)),
            }), table="w")
            pair.flush()
        mine, theirs = pair.port.prewarm(), pair.ref.prewarm(tables=["w"])
        assert set(mine) == set(theirs) == {"public.w"}
        assert mine["public.w"]["regions_built"] == theirs["public.w"]["regions_built"] == 1
        cache = pair.port.query_engine.tile_cache
        entry = next(iter(cache._super.values()))
        ref_entry = next(iter(pair.ref.query_engine.tile_cache._super.values()))
        assert entry.valid is not None and set(entry.cols) == set(ref_entry.cols)
        assert {"u", "v"} <= set(entry.cols)
        assert set(entry.limb_cols) == set(ref_entry.limb_cols) == {"u"}
        builds = cache.stats()["builds"]
        got, decisions = pair.query(
            "SELECT host, time_bucket('10m', ts) AS tb, avg(u) AS a, max(v) AS m FROM w"
            " GROUP BY host, tb")
        assert route_of(decisions) == "device" and got.num_rows
        assert cache.stats()["builds"] == builds, "the first query rebuilt prewarmed planes"
        assert pair.port.prewarm(tables=["nope"]) == {}
    finally:
        pair.close()


def test_prewarm_with_the_tile_cache_off(tmp_path):
    cfg = Config()
    cfg.query.tile_cache_enable = False
    db = Database(str(tmp_path / "off"), device="cpu", config=cfg)
    try:
        assert db.prewarm() == {}
    finally:
        db.close()


# ---- a dashboard tick with host-served members ------------------------------------------

TICK_QUERIES = (
    "SELECT host, time_bucket('1m', ts) AS tb, sum(usage_user) AS s FROM cpu GROUP BY host, tb",
    "SELECT region, max(usage_user) AS m, count(*) AS c FROM cpu GROUP BY region",
    "SELECT time_bucket('1m', ts) AS tb, max(usage_user) AS m FROM cpu"
    " WHERE host = 'h1' GROUP BY tb",
    "SELECT count(*) AS n, sum(usage_user) AS s FROM cpu WHERE host IN ('h2', 'h3')",
)


def test_tick_host_served_members_answer_outside_the_tick(tmp_path):
    """The two pk-equality members return from the host fast path before
    the dispatch site; the two others form the tick, with the bytes of
    their solo runs."""
    cfg = Config()
    cfg.batch.window_ms = 120.0
    db = Database(str(tmp_path / "tick"), device="cpu", config=cfg)
    try:
        rng = np.random.default_rng(9)
        db.sql(DDL.format(pk="host, region", opts=" WITH (append_mode = 'true')"))
        db.write("cpu", _rows(rng, 6, 0, 300, nulls=False))
        db.flush()
        solo = _solo(db, TICK_QUERIES)  # warms every family (the cold serve once)
        h0 = db.query_engine.stats.get("host_fast_path", 0)
        for _ in range(8):  # a round whose four threads all met in the window
            before = dict(db.query_engine.stats)
            results, errors = _concurrent(db, list(TICK_QUERIES))
            assert not errors, errors
            delta = _delta(db, before)
            if delta["batch_ticks"] == 1 and delta["batch_members"] == 2:
                break
        else:
            pytest.fail("no tick formed (timing-dependent membership)")
        # the two tile members ride one tick program; the host members
        # answered outside it
        assert delta["batch_fused_dispatches"] == 1 and delta["tick_graph_replays"] == 1
        assert delta.get("host_fast_path", 0) == 2
        assert db.query_engine.stats.get("host_fast_path", 0) >= h0 + 2
        for q, t in zip(TICK_QUERIES, results):
            assert _ser(t) == solo[q], q
    finally:
        db.close()
