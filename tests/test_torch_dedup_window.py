"""SQL over non-append tables on the tile path: the last-write-wins keep
plane (`dedup_plane`) and compact window tiles (`window_tile`), in the
port's Database (device="cpu", the plain kernel versions) beside the
reference's Database on the same writes, in the configuration of
tests/test_torch_tile.py (the passes the port lacks switched off,
agg_strategy "sort" unless a case says otherwise, no tile persistence,
no CPU fallback, no cold host serve).

The cases mirror the reference's tests/test_tile_cache.py
(`test_window_tile_engages_and_matches`,
`test_window_tile_extends_with_new_columns`,
`test_overlapping_flushes_dedup_on_tile_path`,
`test_overwrite_changes_values_last_write_wins`,
`test_windowed_query_tiles_despite_out_of_window_overlap`),
tests/test_optimizer_passes.py (`test_disabling_window_tile_composes`)
and tests/test_tile_incremental.py
(`test_window_tiles_survive_disjoint_delta`), and add time-major plans
over the keep plane, `last_value` under an overwrite, the hash strategy,
a 4-slot mesh, a dashboard tick, a flush that appends an overlapping file
to a resident entry, and a memtable overlapping a file (still declined).

Every query must take the tile path in both packages (or decline in
both), and the pass trace of `dedup_plane` and `window_tile` (fired or
declined, and why) must be the reference's.  Tolerances: keys, counts,
min, max and last exact; sum/avg within rel 1e-12."""

import numpy as np
import pyarrow as pa
import pytest
import torch

from greptimedb_tpu.database import Database as JaxDatabase
from greptimedb_tpu.parallel.tile_cache import TileCacheManager as JaxTileCache
from greptimedb_tpu.query import passes as jax_passes
from greptimedb_tpu.utils import metrics
from greptimedb_tpu.utils.config import Config as JaxConfig
from greptimedb_tpu_torch import Database
from greptimedb_tpu_torch.parallel import tile_planes
from greptimedb_tpu_torch.parallel.tile_planes import TileCacheManager
from greptimedb_tpu_torch.query import passes
from greptimedb_tpu_torch.utils.config import Config
from test_torch_batch import _ser, _solo, _tick
from test_torch_tile import HOST_ROUTES, UNPORTED_PASSES, _assert_same

DDL = ("CREATE TABLE cpu (host STRING, region STRING, ts TIMESTAMP TIME INDEX,"
       " usage_user DOUBLE, usage_system DOUBLE, PRIMARY KEY (host, region))")
# tests/test_tile_cache.py's Q
Q = ("SELECT host, time_bucket('30s', ts) AS tb, avg(usage_user) AS au,"
     " max(usage_system) AS ms, count(*) AS c FROM cpu GROUP BY host, tb")
W = " WHERE ts >= 1000000 AND ts < 2000000"
TRACED = ("dedup_plane", "window_tile")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def small_window_tiles(monkeypatch):
    """Window tiles at test sizes, in both packages alike."""
    def floor(rows):
        monkeypatch.setattr(TileCacheManager, "_WINDOW_TILE_MIN_ROWS", rows)
        monkeypatch.setattr(JaxTileCache, "_WINDOW_TILE_MIN_ROWS", rows)
    floor(1 << 14)
    return floor


class Pair:
    """The port's and the reference's Database over the same writes."""

    def __init__(self, tmp_path, strategy="sort", devices="cpu", window_ms=0.0):
        cfg = JaxConfig()
        cfg.query.disabled_passes = UNPORTED_PASSES
        cfg.query.agg_strategy = strategy
        cfg.query.tile_persist_enable = False
        cfg.query.fallback_to_cpu = False
        cfg.storage.compaction_background_enable = False
        self.ref = JaxDatabase(config=cfg, data_home=str(tmp_path / "jax"))
        pcfg = Config()
        pcfg.query.agg_strategy = strategy
        pcfg.batch.window_ms = window_ms
        pcfg.query.disabled_passes = HOST_ROUTES
        self.port = Database(str(tmp_path / "port"), device=devices, config=pcfg)

    def sql(self, text):
        self.port.sql(text)
        self.ref.sql(text)

    def write(self, rows: pa.Table, table="cpu"):
        self.port.write(table, rows)
        self.ref.insert_rows(table, rows)

    def flush(self):
        self.port.flush()
        self.ref.storage.flush_all()

    def disable(self, *names):
        self.port.config.query.disabled_passes = HOST_ROUTES + names
        self.ref.config.query.disabled_passes = UNPORTED_PASSES + names

    @property
    def cache(self):
        return self.port.query_engine.tile_executor().cache

    def query(self, sql, tile=True):
        """(port table, reference table, the port's traced decisions); both
        must take the tile path (`tile`), or both decline it, with the same
        dedup_plane / window_tile decisions."""
        eng = self.port.query_engine
        d0, r0 = eng.stats["tile_dispatches"], metrics.TILE_LOWERED_TOTAL.get()
        pt, rt = passes.PassTrace(), jax_passes.PassTrace()
        with passes.use_trace(pt):
            got = self.port.sql_one(sql)
        with jax_passes.use_trace(rt):
            want = self.ref.sql_one(sql)
        if tile:
            assert eng.last_path == "tile" and eng.stats["tile_dispatches"] == d0 + 1, sql
            assert metrics.TILE_LOWERED_TOTAL.get() > r0, f"the reference declined: {sql}"
        else:
            assert eng.last_path != "tile" and eng.stats["tile_dispatches"] == d0, sql
            assert metrics.TILE_LOWERED_TOTAL.get() == r0, f"the reference tiled: {sql}"
        mine = [(d.name, d.fired, d.why) for d in pt.decisions if d.name in TRACED]
        theirs = [(d.name, d.fired, d.why) for d in rt.decisions if d.name in TRACED]
        assert mine == theirs, (sql, mine, theirs)
        _assert_same(got, want, sql, ordered="ORDER BY" in sql)
        return got, want, mine

    def close(self):
        self.port.close()
        self.ref.close()


@pytest.fixture()
def pair(tmp_path):
    p = Pair(tmp_path)
    yield p
    p.close()


def _fired(decisions) -> dict:
    return {name: fired for name, fired, _why in decisions}


def _rows(hosts, ts, user, system, region="r0") -> pa.Table:
    n = len(ts)
    return pa.table({
        "host": pa.array(hosts),
        "region": pa.array(np.repeat(region, n) if isinstance(region, str) else region),
        "ts": pa.array(np.asarray(ts, np.int64), pa.timestamp("ms")),
        "usage_user": pa.array(np.asarray(user, np.float64)),
        "usage_system": pa.array(np.asarray(system, np.float64)),
    })


def _load(p: Pair, hosts=6, ticks=120, t0=0, bump=0.0):
    """tests/test_tile_cache.py's _load (plus `bump` on usage_user)."""
    t = np.repeat(np.arange(ticks), hosts)
    h = np.tile(np.arange(hosts), ticks)
    p.write(_rows([f"host_{i}" for i in h], t0 + t * 1000, t % 13 + h + bump, (t + h) % 7,
                  region=np.array([f"r{i % 2}" for i in h])))


def _deep(p: Pair, seed: int, n=1 << 16):
    """tests/test_tile_cache.py's window-tile table: 8 hosts, one row a
    second each; returns (hosts, ts)."""
    hosts = np.repeat([f"h{i}" for i in range(8)], n // 8)
    ts = np.tile(np.arange(n // 8, dtype=np.int64) * 1000, 8)
    rng = np.random.default_rng(seed)
    p.write(_rows(hosts, ts, rng.uniform(0, 100, n), rng.uniform(0, 100, n)))
    p.flush()
    return hosts, ts


def _entry(db):
    (entry,) = db.query_engine.tile_cache._super.values()
    return entry


# ---- the reference's tests ---------------------------------------------------------------


def test_window_tile_engages_and_matches(pair, small_window_tiles):
    """A windowed query over deep retention gathers a compact window tile,
    combined here with overwrite dedup (test_tile_cache.py)."""
    pair.sql(DDL)
    hosts, ts = _deep(pair, 77)
    # overwrite a slice inside the window in a second flush
    sel = (ts >= 1_000_000) & (ts < 1_200_000) & (np.arange(len(ts)) % 2 == 0)
    pair.write(_rows(hosts[sel], ts[sel], np.full(int(sel.sum()), 500.0),
                     np.zeros(int(sel.sum()))))
    pair.flush()
    q = f"SELECT host, count(*) AS c, avg(usage_user) AS a FROM cpu{W} GROUP BY host ORDER BY host"
    builds, ref_builds = pair.cache.stats()["window_tile_builds"], metrics.TILE_WINDOW_BUILDS.get()
    got, _want, dec = pair.query(q)
    assert _fired(dec) == {"dedup_plane": True, "window_tile": True}
    assert pair.cache.stats()["window_tile_builds"] == builds + 1
    assert metrics.TILE_WINDOW_BUILDS.get() == ref_builds + 1
    assert got["c"].to_pylist() == [1000] * 8
    (wt,) = _entry(pair.port).window_tiles.values()
    assert wt["rows"] == 8000 and len(wt["valid"]) == 1
    assert _entry(pair.port).nbytes == tile_planes._entry_device_bytes(_entry(pair.port))
    # warm: the cached window tile serves again (no second build)
    pair.query(q)
    assert pair.cache.stats()["window_tile_builds"] == builds + 1


def test_window_tile_extends_with_new_columns(pair, small_window_tiles):
    """A wider query over the same window extends the cached tile with
    the new columns and stays on the tile path (test_tile_cache.py)."""
    pair.sql(DDL)
    _deep(pair, 5)
    q1 = f"SELECT host, avg(usage_user) AS a FROM cpu{W} GROUP BY host"
    q2 = (f"SELECT host, avg(usage_user) AS a, avg(usage_system) AS b,"
          f" count(*) AS c FROM cpu{W} GROUP BY host")
    builds = pair.cache.stats()["window_tile_builds"]
    pair.query(q1)
    entry = _entry(pair.port)
    (wt,) = entry.window_tiles.values()
    assert "usage_system" not in wt["cols"] and set(wt["limbs"]) == {"usage_user"}
    pair.query(q2)
    (wt2,) = entry.window_tiles.values()
    assert wt2 is wt and {"usage_user", "usage_system"} <= set(wt["cols"]) <= set(wt["limbs"]) | {
        "host", "region", "ts"}
    assert pair.cache.stats()["window_tile_builds"] == builds + 2  # the build, the extension
    assert entry.nbytes == tile_planes._entry_device_bytes(entry)
    # the complete tile serves both without another build
    pair.query(q1)
    pair.query(q2)
    assert pair.cache.stats()["window_tile_builds"] == builds + 2


def test_overlapping_flushes_dedup_on_tile_path(pair):
    """The same keys written twice across flushes: the tile path engages
    with the keep plane (test_tile_cache.py)."""
    pair.sql(DDL)
    for _ in range(2):
        _load(pair, ticks=50)
        pair.flush()
    keeps = pair.cache.stats()["dedup_keep_builds"]
    got, _want, dec = pair.query(Q)
    assert _fired(dec) == {"dedup_plane": True}
    assert sum(got["c"].to_pylist()) == 50 * 6
    entry = _entry(pair.port)
    assert pair.cache.stats()["dedup_keep_builds"] == keeps + 1
    assert entry.keep_host is not None and int(entry.keep_host.sum()) == 50 * 6
    np.testing.assert_array_equal(entry.keep_host, np.asarray(_entry(pair.ref).keep_host))
    assert entry.host_nbytes == entry.keep_host.nbytes


def test_overwrite_changes_values_last_write_wins(pair):
    """Overwriting flushes with different values: the keep plane selects
    the newer file's rows (test_tile_cache.py)."""
    pair.sql(DDL)
    n = 512
    ts = np.arange(n, dtype=np.int64) * 1000
    pair.write(_rows(["h0"] * n, ts, np.full(n, 1.0), np.zeros(n)))
    pair.flush()
    mid = slice(n // 4, 3 * n // 4)
    pair.write(_rows(["h0"] * (n // 2), ts[mid], np.full(n // 2, 5.0), np.zeros(n // 2)))
    pair.flush()
    got, _want, _dec = pair.query(
        "SELECT host, count(*) AS c, sum(usage_user) AS s, max(usage_user) AS m"
        " FROM cpu GROUP BY host")
    assert got["c"].to_pylist() == [n]
    assert got["s"].to_pylist() == [float(n // 2) * 1.0 + float(n // 2) * 5.0]
    assert got["m"].to_pylist() == [5.0]


def test_windowed_query_tiles_despite_out_of_window_overlap(pair):
    """Overlap confined to old files leaves a windowed query's in-window
    files disjoint: no keep plane; the whole-table query reads it
    (test_tile_cache.py)."""
    pair.sql(DDL)
    for t0 in (0, 0, 1_000_000):
        _load(pair, ticks=50, t0=t0)
        pair.flush()
    got, _want, dec = pair.query(f"SELECT host, count(*) AS c FROM cpu{W} GROUP BY host")
    # no keep plane; the entry is below the window tiles' floor
    assert _fired(dec) == {"window_tile": False} and sum(got["c"].to_pylist()) == 50 * 6
    _got, _want, dec = pair.query(Q)
    assert _fired(dec) == {"dedup_plane": True}


def test_disabling_window_tile_composes(tmp_path, small_window_tiles):
    """`window_tile` in query.disabled_passes: the full-tile masked path,
    the same answer (test_optimizer_passes.py)."""
    p = Pair(tmp_path)
    try:
        p.sql("CREATE TABLE cpu (host STRING, ts TIMESTAMP TIME INDEX,"
              " usage_user DOUBLE, PRIMARY KEY (host))")
        n = 1 << 16
        rows = pa.table({
            "host": pa.array(np.repeat([f"h{i}" for i in range(8)], n // 8)),
            "ts": pa.array(np.tile(np.arange(n // 8, dtype=np.int64) * 1000, 8),
                           pa.timestamp("ms")),
            "usage_user": pa.array(np.random.default_rng(11).uniform(0, 100, n)),
        })
        p.write(rows)
        p.flush()
        windowed = ("SELECT host, time_bucket('30s', ts) AS tb, avg(usage_user) AS au"
                    f" FROM cpu{W} GROUP BY host, tb")
        p.disable("window_tile")
        off, _want, dec = p.query(windowed)
        assert dec == []
        p.disable()
        on, _want, dec = p.query(windowed)
        assert _fired(dec) == {"window_tile": True}
        key = [("host", "ascending"), ("tb", "ascending")]
        assert off.sort_by(key).equals(on.sort_by(key))
    finally:
        p.close()


def test_window_tiles_survive_disjoint_delta(tmp_path, small_window_tiles):
    """A cached window tile whose window cannot hold a delta row stays;
    one the delta reaches is dropped and rebuilds (test_tile_incremental.py)."""
    small_window_tiles(0)
    p = Pair(tmp_path)
    rng = np.random.default_rng(3)

    def batch(n, lo, hi):
        return pa.table({
            "host": pa.array(rng.choice([f"h{i}" for i in range(4)], n)),
            "region": pa.array(rng.choice(["r0", "r1"], n)),
            "ts": pa.array(rng.integers(lo, hi, n) * 1000, pa.timestamp("ms")),
            "usage_user": pa.array(rng.uniform(0, 100, n)),
            "usage_system": pa.array(rng.uniform(0, 100, n)),
        })

    try:
        p.sql(DDL)
        p.write(batch(3000, 0, 3000))
        p.flush()
        wq = ("SELECT host, time_bucket('60s', ts) AS tb, avg(usage_user) AS av"
              " FROM cpu WHERE ts >= 0 AND ts < 600000 GROUP BY host, tb")
        p.query(wq)
        entry = _entry(p.port)
        (tile,) = entry.window_tiles.values()
        builds = p.cache.stats()["window_tile_builds"]
        # a delta strictly above the window: the tile survives the merge
        p.write(batch(150, 4000, 4400))
        p.flush()
        p.query(wq)
        assert _entry(p.port) is entry and entry.delta_extends == 1
        assert list(entry.window_tiles.values()) == [tile]
        assert p.cache.stats()["window_tile_builds"] == builds
        # a delta inside the window: the stale tile is dropped and rebuilt
        p.write(batch(150, 100, 500))
        p.flush()
        p.query(wq)
        assert entry.delta_extends == 2 and p.cache.stats()["window_tile_builds"] == builds + 1
        (rebuilt,) = entry.window_tiles.values()
        assert rebuilt is not tile
        assert entry.nbytes == tile_planes._entry_device_bytes(entry)
    finally:
        p.close()


# ---- the port's own cases ------------------------------------------------------------------


@pytest.mark.parametrize("lo", [0, 8_500_000], ids=["cover", "empty"])
def test_window_tile_declines_and_remembers(pair, small_window_tiles, lo):
    """A window holding more than half the rows, or none: the tile
    declines (the reference's note), the decline is kept for the file
    set (a warm run masks nothing), and a flush forgets it."""
    pair.sql(DDL)
    _deep(pair, 9)
    q = (f"SELECT host, max(usage_user) AS m, count(*) AS c FROM cpu"
         f" WHERE ts >= {lo} AND ts < 9000000 GROUP BY host")
    for _ in range(2):
        _got, _want, dec = pair.query(q)
        assert _fired(dec) == {"window_tile": False}
        entry = _entry(pair.port)
        assert entry.window_declines == {(lo, 9_000_000, False)} and not entry.window_tiles
    pair.write(_rows(["h0"], [9_500_000], [1.0], [1.0]))
    pair.flush()
    pair.query(q)
    assert entry.delta_extends == 1 and entry.window_declines == {(lo, 9_000_000, False)}




def test_time_major_plan_reads_the_keep_plane_copy(pair, monkeypatch):
    """A bucket-only group-by over overlapping files: a time-major plan
    whose valid planes are the keep plane's ts-ascending copy, gathered
    in the same K15 call as the other copies."""
    calls = []
    real = tile_planes.gather_planes_multi

    def counted(planes, perm):
        calls.append(len(planes))
        return real(planes, perm)

    monkeypatch.setattr(tile_planes, "gather_planes_multi", counted)
    pair.sql(DDL)
    for bump in (0.0, 0.5):
        _load(pair, ticks=60, bump=bump)
        pair.flush()
    q = ("SELECT time_bucket('30s', ts) AS tb, avg(usage_user) AS au, max(usage_system) AS ms,"
         " count(*) AS c FROM cpu GROUP BY tb")
    got, _want, dec = pair.query(q)
    assert _fired(dec) == {"dedup_plane": True}
    assert got["c"].to_pylist() == [6 * 30, 6 * 30]
    entry = _entry(pair.port)
    assert entry.tm_valid_dedup is not None and entry.tm_valid is not None
    # one call: valid, valid_dedup, ts, usage_user, usage_system
    assert [c for c in calls if c] == [5]
    assert entry.nbytes == tile_planes._entry_device_bytes(entry)
    pair.query(q)
    assert [c for c in calls if c] == [5]  # warm: no gather


def test_last_value_under_an_overwrite(pair):
    """lastpoint over a corrected remote write: the newest version of the
    last sample wins (K4 over the keep plane)."""
    pair.sql(DDL)
    _load(pair, ticks=40)
    pair.flush()
    h = np.arange(6)
    pair.write(_rows([f"host_{i}" for i in h], np.full(6, 39_000), 100.0 + h, np.zeros(6),
                     region=np.array([f"r{i % 2}" for i in h])))
    pair.flush()
    got, _want, dec = pair.query("SELECT host, region, last_value(usage_user) AS lu"
                                 " FROM cpu GROUP BY host, region")
    assert _fired(dec) == {"dedup_plane": True}
    got = got.sort_by("host")
    assert got["lu"].to_pylist() == [100.0 + i for i in h]


def test_hash_strategy_on_a_dedup_region(tmp_path):
    """agg_strategy "hash" over the keep plane (K17's slot table)."""
    p = Pair(tmp_path, strategy="hash")
    try:
        p.sql(DDL)
        for bump in (0.0, 0.25):
            _load(p, hosts=12, ticks=90, bump=bump)
            p.flush()
        got, _want, dec = p.query(Q)
        assert _fired(dec) == {"dedup_plane": True}
        assert p.port.query_engine.tile_executor().last_strategy == "hash"
        assert sum(got["c"].to_pylist()) == 12 * 90
    finally:
        p.close()


@pytest.mark.parametrize("windowed", [False, True], ids=["full", "window"])
def test_mesh_of_four_slots(tmp_path, small_window_tiles, windowed):
    """tile.mesh_devices 4 over ["cpu"] * 4, a table of three partitions,
    each with overlapping files: per-slot partials over the keep planes
    (and window tiles), K22's fold; the reference's answer."""
    small_window_tiles(0)
    p = Pair(tmp_path, devices=["cpu"] * 4)
    try:
        p.sql(DDL.replace("))", ")) PARTITION BY HASH (host) PARTITIONS 3"))
        for bump in (0.0, 1.0):
            _load(p, hosts=9, ticks=400, bump=bump)
            p.flush()
        q = ("SELECT host, time_bucket('1m', ts) AS tb, avg(usage_user) AS au,"
             " min(usage_system) AS mn, count(*) AS c FROM cpu"
             + (" WHERE ts >= 60000 AND ts < 120000" if windowed else "") + " GROUP BY host, tb")
        single, _want, _dec = p.query(q)
        eng = p.port.query_engine
        p.port.config.tile.mesh_devices = 4
        m0 = eng.stats.get("mesh_dispatches", 0)
        meshed, _want, dec = p.query(q)
        assert eng.stats.get("mesh_dispatches", 0) == m0 + 1
        assert dec.count(("dedup_plane", True, "overlapping-SST LWW dedup lowered to a device "
                                                "keep mask")) == 3
        assert _fired(dec).get("window_tile", False) == windowed
        _assert_same(meshed, single, q, ordered=False)
    finally:
        p.close()


def test_tick_members_read_keep_plane_and_window_tile(tmp_path, small_window_tiles):
    """A dashboard tick whose members read the keep plane, a window tile
    and the keep plane's time-major copy: each member's bytes are its
    solo run's, and the solo runs are the reference's."""
    small_window_tiles(0)
    p = Pair(tmp_path, window_ms=120.0)
    try:
        p.sql(DDL)
        for bump in (0.0, 0.5):
            _load(p, hosts=8, ticks=300, bump=bump)
            p.flush()
        queries = [
            Q,
            "SELECT host, avg(usage_user) AS au, count(*) AS c FROM cpu"
            " WHERE ts >= 30000 AND ts < 90000 GROUP BY host",
            "SELECT time_bucket('1m', ts) AS tb, max(usage_user) AS mu FROM cpu GROUP BY tb",
        ]
        bc = p.port.config.batch
        win, bc.window_ms = bc.window_ms, 0.0
        try:
            for q in queries:
                p.query(q)
        finally:
            bc.window_ms = win
        assert _entry(p.port).window_tiles and _entry(p.port).tm_valid_dedup is not None
        solo = _solo(p.port, queries)
        results, d = _tick(p.port, queries)
        assert d["tick_graph_replays"] == 1
        for q, t in zip(queries, results):
            assert _ser(t) == solo[q], q
    finally:
        p.close()


def test_flush_of_an_overlapping_file_extends_the_entry(pair):
    """A flush that appends an overlapping file to a resident entry: the
    delta route (K16), then the keep plane rebuilt over the merged order,
    equal to the reference's, its newest versions kept."""
    pair.sql(DDL)
    _load(pair, ticks=80)
    pair.flush()
    got, _want, dec = pair.query(Q)
    assert dec == []  # one file: nothing to dedup
    entry = _entry(pair.port)
    keeps = pair.cache.stats()["dedup_keep_builds"]
    for bump in (10.0, 20.0):
        _load(pair, ticks=30, t0=50_000, bump=bump)  # overwrites ts 50 s .. 79 s
        pair.flush()
        got, _want, dec = pair.query(Q)
        assert _fired(dec) == {"dedup_plane": True}
        assert _entry(pair.port) is entry
    assert entry.delta_extends == 2 and pair.cache.stats()["delta_extends"] == 2
    assert pair.cache.stats()["dedup_keep_builds"] == keeps + 2
    np.testing.assert_array_equal(entry.keep_host, np.asarray(_entry(pair.ref).keep_host))
    assert sum(got["c"].to_pylist()) == 80 * 6
    # the newest versions survive: the last sample (tick 29 of the second
    # overwrite) carries +20
    last = pair.port.sql_one(
        "SELECT host, region, last_value(usage_user) AS lu FROM cpu GROUP BY host, region")
    want = {f"host_{h}": 29 % 13 + h + 20.0 for h in range(6)}
    assert dict(zip(last["host"].to_pylist(), last["lu"].to_pylist())) == want


@pytest.mark.parametrize("memtable", ["overlapping", "disjoint"])
def test_memtable_overlap_still_declines(pair, memtable):
    """Unflushed rows over a file's keys keep the merge scan: the tile
    path declines in both packages, with the reference's answer.  A
    memtable disjoint from the files rides as a tail beside the keep
    plane of the overlapping files.  Once flushed, the keep plane serves
    all of it."""
    pair.sql(DDL)
    for _ in range(2):
        _load(pair, ticks=50)
        pair.flush()
    overlapping = memtable == "overlapping"
    _load(pair, ticks=20, t0=0 if overlapping else 100_000, bump=3.0)
    _got, _want, dec = pair.query(Q, tile=not overlapping)
    assert dec == ([] if overlapping else [("dedup_plane", True, "overlapping-SST LWW dedup "
                                                                 "lowered to a device keep mask")])
    pair.flush()
    _got, _want, dec = pair.query(Q)
    assert _fired(dec) == {"dedup_plane": True}


def test_dedup_plane_disabled_declines(pair):
    """`dedup_plane` in query.disabled_passes: overlapping files decline
    the tile path (the reference's behaviour with the pass off)."""
    pair.sql(DDL)
    for _ in range(2):
        _load(pair, ticks=30)
        pair.flush()
    pair.disable("dedup_plane")
    _got, _want, dec = pair.query(Q, tile=False)
    assert dec == [("dedup_plane", False, "pass disabled")]


def test_cache_counts_and_drops_the_new_planes(pair, small_window_tiles):
    """The keep plane's host copy is counted in the cache's host bytes and
    its device planes, time-major copy and the window tiles in the
    entry's and the cache's bytes; `release_unneeded` drops a window tile
    that lacks a kept column and, for a query without the keep plane, the
    keep plane's time-major copy; dropping the entry returns every byte."""
    pair.sql(DDL)
    hosts, ts = _deep(pair, 13)
    pair.write(_rows(hosts[:64], ts[:64], np.ones(64), np.ones(64)))
    pair.flush()
    pair.query(f"SELECT host, avg(usage_user) AS a FROM cpu{W} GROUP BY host")
    pair.query("SELECT time_bucket('1m', ts) AS tb, max(usage_system) AS m FROM cpu GROUP BY tb")
    cache, entry = pair.cache, _entry(pair.port)
    assert entry.window_tiles and entry.tm_valid_dedup is not None
    assert entry.nbytes == tile_planes._entry_device_bytes(entry)
    stats = cache.stats()
    assert stats["bytes"] == entry.nbytes
    assert entry.host_nbytes == entry.keep_host.nbytes and stats["host_bytes"] >= entry.host_nbytes
    freed = cache.release_unneeded(entry, {"host", "ts", "usage_system"}, keep_dedup=False)
    assert not entry.window_tiles and entry.tm_valid_dedup is None and freed > 0
    assert entry.nbytes == tile_planes._entry_device_bytes(entry) == cache.stats()["bytes"]
    cache.invalidate_region(entry.region_id, set())
    assert cache.stats()["bytes"] == 0 and cache.stats()["host_bytes"] == 0
