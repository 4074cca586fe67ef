"""The dashboard batch tick and the windowed result cache of the port
(greptimedb_tpu_torch/parallel/batcher.py, `TickProgram` in
parallel/tile_program.py), on the CPU, following the reference's
tests/test_batcher.py and tests/test_mega_fusion.py.

On the CPU a tick program runs its members eagerly over the same static
input buffer a replay on the card reads, so what feeds a replay (the
literal encoding, the per-member layout, the one slab readback) is the
code under test here.  Every batched result must be byte-identical
(Arrow IPC bytes) to the same query's solo run, and the port's batched
results must agree with the reference Database's batched results.

A tick forms only when the barrier-released threads land inside the
leader's window: membership is asserted from the stats of a round, and a
round that did not form a clean tick is retried (the reference's
`_fused_round`: up to 8 rounds, a 120 ms window)."""

import io
import math
import threading

import numpy as np
import pyarrow as pa
import pytest
import torch

from greptimedb_tpu.database import Database as JaxDatabase
from greptimedb_tpu.utils import metrics
from greptimedb_tpu.utils.config import Config as JaxConfig
from greptimedb_tpu_torch import Database
from greptimedb_tpu_torch.ops import aggregate as agg
from greptimedb_tpu_torch.parallel.batcher import WindowedResultCache
from greptimedb_tpu_torch.utils.config import BatchConfig, Config
from greptimedb_tpu_torch.utils.errors import ConfigError

# the port's host routes and fused family build, off where the reference's
# are (tests/test_torch_tile.py)
HOST_ROUTES = ("cost_route", "host_fast_path", "cold_host_serve", "fused_build")
# the reference's passes the port has not ported (tests/test_torch_tile.py)
UNPORTED_PASSES = (
    "cold_host_serve", "fused_build", "pipelined_build", "stream_spill",
    "chunk_placement", "mesh_dispatch", "streamed_readback", "host_fast_path", "cost_route",
)
_WIN = 120.0
_N_ROWS = 2_500  # covers the slid windows below (ts reaches ~41 min)

# N distinct plan families over one table (tests/test_batcher.py _QUERIES)
_QUERIES = (
    "SELECT k, g, sum(v) AS sv, count(*) AS c FROM t GROUP BY k, g",
    "SELECT g, max(w) AS xw, min(w) AS mw FROM t GROUP BY g",
    "SELECT time_bucket('1m', ts) AS tb, sum(v) AS sv FROM t GROUP BY tb",
    "SELECT g, avg(v) AS av, count(v) AS cv FROM t GROUP BY g",
    "SELECT g, count(v) AS cv FROM t WHERE g = 'g3' GROUP BY g",
)
# tests/test_mega_fusion.py _SLID_W1 / _SLID_W2: the dashboard slide moves
# both bounds one bucket and changes the filter literal; the plan
# structure, and so every program key, stays
_SLID_W1 = (
    "SELECT k, g, sum(v) AS sv FROM t WHERE ts >= '1970-01-01T00:10:00'"
    " AND ts < '1970-01-01T00:40:00' GROUP BY k, g",
    "SELECT time_bucket('1m', ts) AS tb, sum(v) AS sv FROM t"
    " WHERE ts >= '1970-01-01T00:10:00' AND ts < '1970-01-01T00:40:00'"
    " GROUP BY tb",
    "SELECT g, count(v) AS cv FROM t WHERE g = 'g3' AND"
    " ts >= '1970-01-01T00:10:00' AND ts < '1970-01-01T00:40:00'"
    " GROUP BY g",
)
_SLID_W2 = tuple(
    q.replace("00:10:00", "00:11:00").replace("00:40:00", "00:41:00").replace("'g3'", "'g4'")
    for q in _SLID_W1
)
_CACHE_Q = (
    "SELECT k, g, sum(v) AS sv, count(*) AS c FROM t"
    " WHERE ts >= '1970-01-01T00:00:00' AND ts < '1970-01-01T01:00:00'"
    " GROUP BY k, g"
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops on one thread while the test workers share
    the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ser(t: pa.Table) -> bytes:
    sink = io.BytesIO()
    with pa.ipc.new_stream(sink, t.schema) as w:
        w.write_table(t)
    return sink.getvalue()


def _mk_db(home, *, strategy="sort", window_ms=0.0, cache_mb=0, fuse=True) -> Database:
    cfg = Config()
    cfg.query.agg_strategy = strategy
    cfg.batch.window_ms = window_ms
    cfg.batch.result_cache_mb = cache_mb
    cfg.batch.fuse_programs = fuse
    cfg.query.disabled_passes = HOST_ROUTES
    return Database(str(home), device="cpu", config=cfg)


def _jax_db(home, *, strategy="sort", window_ms=0.0) -> JaxDatabase:
    cfg = JaxConfig()
    cfg.query.disabled_passes = UNPORTED_PASSES
    cfg.query.agg_strategy = strategy
    cfg.query.tile_persist_enable = False
    cfg.query.fallback_to_cpu = False
    cfg.query.tpu_min_rows = 1
    cfg.tile.fused_build = False
    cfg.batch.window_ms = window_ms
    return JaxDatabase(config=cfg, data_home=str(home))


def _load(db, seed, n=5_000, n_keys=120, nulls=True, null_tags=True):
    """The reference's seeded load (tests/test_batcher.py _load): NULL tags
    and NULL values; integer-valued v keeps sums exact across strategies."""
    rng = np.random.default_rng(seed)
    db.sql(
        "CREATE TABLE t (k STRING, g STRING, ts TIMESTAMP TIME INDEX,"
        " v DOUBLE, w DOUBLE, PRIMARY KEY (k, g)) WITH (append_mode='true')"
    )
    keys = rng.integers(0, n_keys, n)
    ks = np.array([f"k{i:05d}" for i in keys])
    gs = np.array([f"g{i % 7}" for i in keys])
    g_arr = (pa.array([None if i % 11 == 0 else g for i, g in enumerate(gs)], pa.string())
             if null_tags else pa.array(gs))
    v = rng.integers(-500, 500, n).astype(np.float64)
    v_arr = (pa.array([None if i % 7 == 0 else x for i, x in enumerate(v)], pa.float64())
             if nulls else pa.array(v))
    rows = pa.table({
        "k": pa.array(ks), "g": g_arr,
        "ts": pa.array(np.arange(n, dtype=np.int64) * 1000, pa.timestamp("ms")),
        "v": v_arr, "w": pa.array(rng.uniform(-1e3, 1e3, n)),
    })
    if isinstance(db, JaxDatabase):
        db.insert_rows("t", rows)
        db.storage.flush_all()
    else:
        db.write("t", rows)
        db.flush()


def _concurrent(db, queries):
    """Each query on its own thread, all released together: (results
    index-aligned to `queries`, errors)."""
    results = [None] * len(queries)
    errors = []
    barrier = threading.Barrier(len(queries))

    def run(i, q):
        try:
            barrier.wait(timeout=30)
            results[i] = db.sql_one(q)
        except Exception as exc:  # noqa: BLE001 — asserted by the callers
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(i, q)) for i, q in enumerate(queries)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive(), "a tick member never returned"
    return results, errors


def _solo(db, queries) -> dict:
    """Warm every family and take its solo bytes (window 0: the direct
    path, no window sleep)."""
    bc = db.config.batch
    win, bc.window_ms = bc.window_ms, 0.0
    try:
        out = {}
        for q in queries:
            db.sql_one(q)
            out[q] = _ser(db.sql_one(q))
        return out
    finally:
        bc.window_ms = win


def _delta(db, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in db.query_engine.stats.items()}


def _tick(db, queries, rounds=8, fused=True):
    """Barrier-released rounds until one forms a clean tick (every query a
    member of one tick; fused: one tick-program run).  Returns (results,
    stats delta of that round)."""
    for _ in range(rounds):
        before = dict(db.query_engine.stats)
        results, errors = _concurrent(db, queries)
        assert not errors, errors
        d = _delta(db, before)
        if d["batch_ticks"] == 1 and d["batch_members"] == len(queries) and (
                d["batch_fused_dispatches"] == int(fused)):
            return results, d
    pytest.fail("no clean tick formed (timing-dependent membership)")


@pytest.fixture(scope="module")
def sort_db(tmp_path_factory):
    db = _mk_db(tmp_path_factory.mktemp("tick_sort"), strategy="sort", window_ms=_WIN)
    _load(db, 21, n=_N_ROWS)
    yield db
    db.close()


@pytest.fixture(scope="module")
def hash_db(tmp_path_factory):
    db = _mk_db(tmp_path_factory.mktemp("tick_hash"), strategy="hash", window_ms=_WIN)
    _load(db, 23, n=_N_ROWS)
    yield db
    db.close()


# ---- the tick -----------------------------------------------------------------------


@pytest.mark.parametrize("dbfix", ["sort_db", "hash_db"])
def test_tick_vs_solo_bytes(request, dbfix):
    """N distinct warm queries as one tick: byte-identical to their solo
    runs, dense (sort) and hash strategies, NULL tags and values."""
    db = request.getfixturevalue(dbfix)
    solo = _solo(db, _QUERIES)
    results, d = _tick(db, _QUERIES)
    for q, r in zip(_QUERIES, results):
        assert _ser(r) == solo[q], f"the tick's result diverged from solo for {q!r}"
    assert d["lowered"] == d["tile_dispatches"] == d["agg_hash"] + d["agg_sort"] == len(_QUERIES)
    assert d["agg_hash" if dbfix == "hash_db" else "agg_sort"] >= 1


def test_one_run_and_one_readback_per_tick(sort_db):
    """A clean tick of N >= 3 members is one tick-program run and one
    readback of the slab: the tick invariant."""
    db = sort_db
    queries = _QUERIES[:4]
    solo = _solo(db, queries)
    results, d = _tick(db, queries)
    tick = db.query_engine.tile_executor().last_tick
    assert d["tick_graph_replays"] == 1 and d["batch_fused_dispatches"] == 1
    runs, readbacks = tick.runs, tick.readbacks
    results, d = _tick(db, queries)
    assert db.query_engine.tile_executor().last_tick is tick
    assert (d["tick_graph_captures"], d["tick_graph_replays"]) == (0, 1)
    assert (tick.runs, tick.readbacks) == (runs + 1, readbacks + 1)
    for q, r in zip(queries, results):
        assert _ser(r) == solo[q]


@pytest.mark.parametrize("dbfix", ["sort_db", "hash_db"])
def test_slid_window_replays_with_no_new_program(request, dbfix):
    """After a tick at window W, the same members slid one bucket (new
    bounds, new literals) run the same tick program: no new program (no
    recapture on the card), byte-identical to their solo runs."""
    db = request.getfixturevalue(dbfix)
    _solo(db, _SLID_W1)
    _tick(db, _SLID_W1)  # builds the program
    solo2 = _solo(db, _SLID_W2)
    results, d = _tick(db, _SLID_W2)
    assert d["tick_graph_captures"] == 0, "the slid window built a new tick program"
    assert d["tick_graph_replays"] == 1
    for q, r in zip(_SLID_W2, results):
        assert _ser(r) == solo2[q]


def test_member_order_shares_one_program(sort_db):
    """The multiset is canonical: the same members in another order run
    the program the first order built."""
    db = sort_db
    queries = _QUERIES[1:4]
    _solo(db, queries)
    _tick(db, queries)
    _results, d = _tick(db, tuple(reversed(queries)))
    assert d["tick_graph_captures"] == 0


def test_window_zero_is_the_solo_path(tmp_path):
    """batch.window_ms = 0 (the default): concurrent distinct queries never
    batch and never touch a batch counter; the bytes are the solo bytes."""
    db = _mk_db(tmp_path / "off")
    try:
        assert db.config.batch == BatchConfig()
        _load(db, 6, n=_N_ROWS)
        solo = _solo(db, _QUERIES[:3])
        before = dict(db.query_engine.stats)
        results, errors = _concurrent(db, _QUERIES[:3])
        assert not errors
        d = _delta(db, before)
        assert all(d[k] == 0 for k in ("batch_ticks", "batch_members", "batch_fused_dispatches",
                                       "tick_graph_captures", "tick_graph_replays",
                                       "result_cache_hits"))
        assert db.query_engine.tile_executor().result_cache is None
        for q, r in zip(_QUERIES[:3], results):
            assert _ser(r) == solo[q]
    finally:
        db.close()


def test_fuse_off_runs_the_per_member_path(tmp_path):
    """batch.fuse_programs = False: the tick still forms (one shared
    readback) but no tick program is built; the bytes are the solo bytes."""
    db = _mk_db(tmp_path / "nofuse", window_ms=_WIN, fuse=False)
    try:
        _load(db, 9, n=_N_ROWS)
        solo = _solo(db, _QUERIES[:4])
        results, d = _tick(db, _QUERIES[:4], fused=False)
        assert d["tick_graph_captures"] == d["tick_graph_replays"] == 0
        for q, r in zip(_QUERIES[:4], results):
            assert _ser(r) == solo[q]
    finally:
        db.close()


def test_tick_after_a_delta_extension(sort_db):
    """A flush that appends files extends the cached entry in place: the
    planes the tick program read are replaced, the program is dropped,
    and the next tick builds a new one over the new planes, byte-identical
    to the solo runs over the new data."""
    db = sort_db
    queries = _QUERIES[:3]
    _solo(db, queries)
    _tick(db, queries)
    rng = np.random.default_rng(5)
    n = 300
    db.write("t", pa.table({
        "k": pa.array([f"k{i:05d}" for i in rng.integers(0, 120, n)]),
        "g": pa.array([f"g{i % 7}" for i in range(n)]),
        "ts": pa.array(_N_ROWS * 1000 + np.arange(n, dtype=np.int64) * 1000, pa.timestamp("ms")),
        "v": pa.array(rng.integers(-500, 500, n).astype(np.float64)),
        "w": pa.array(rng.uniform(-1e3, 1e3, n)),
    }))
    db.flush()
    tile = db.query_engine.tile_executor()
    ext0 = tile.cache.stats()["delta_extends"]
    solo = _solo(db, queries)
    assert tile.cache.stats()["delta_extends"] > ext0, "the flush did not take the delta route"
    results, d = _tick(db, queries)
    assert d["tick_graph_captures"] == 1, "a tick program over replaced planes was reused"
    for q, r in zip(queries, results):
        assert _ser(r) == solo[q]


# ---- against the reference --------------------------------------------------------------


@pytest.mark.parametrize("strategy", ["sort", "hash"])
def test_tick_against_the_reference_tick(tmp_path, strategy):
    """The port's batched results beside the reference Database's batched
    results (batch.window_ms > 0, fuse_programs on) on the same load:
    keys, counts, min and max exact, sums and averages within rel 1e-12."""
    port = _mk_db(tmp_path / "port", strategy=strategy, window_ms=_WIN)
    ref = _jax_db(tmp_path / "jax", strategy=strategy, window_ms=_WIN)
    try:
        _load(port, 31, n=_N_ROWS)
        _load(ref, 31, n=_N_ROWS)
        _solo(port, _QUERIES)
        for q in _QUERIES:  # the reference's warm marking
            ref.sql_one(q)
        got, _d = _tick(port, _QUERIES)
        f0 = metrics.QUERY_BATCH_FUSED_DISPATCHES_TOTAL.get()
        for _ in range(8):
            want, errors = _concurrent(ref, _QUERIES)
            assert not errors
            if metrics.QUERY_BATCH_FUSED_DISPATCHES_TOTAL.get() > f0:
                break
        assert metrics.QUERY_BATCH_FUSED_DISPATCHES_TOTAL.get() > f0, "the reference never fused"
        for q, a, b in zip(_QUERIES, got, want):
            _assert_same(a, b, q)
    finally:
        port.close()
        ref.close()


def _assert_same(got: pa.Table, want: pa.Table, sql: str):
    assert got.column_names == want.column_names, sql
    assert got.num_rows == want.num_rows, sql
    keys = [(c, "ascending") for c in got.column_names]
    got, want = got.sort_by(keys), want.sort_by(keys)
    for c in got.column_names:
        for x, y in zip(got[c].to_pylist(), want[c].to_pylist()):
            if isinstance(x, float) and isinstance(y, float):
                assert (math.isnan(x) and math.isnan(y)) or math.isclose(
                    x, y, rel_tol=1e-12, abs_tol=0.0), (sql, c, x, y)
            else:
                assert x == y, (sql, c, x, y)


# ---- rerun verdicts inside a tick ---------------------------------------------------------


def test_limb_verdict_member_runs_solo(tmp_path):
    """Tiny values co-blocked with huge ones fail the limb verdict: inside a
    tick that member's result is a rerun verdict, so it runs solo (the
    exact f64 rung) with the solo bytes; its peers are served by the tick."""
    n = 65536
    ts = np.arange(n, dtype=np.int64) * 1000
    vals = np.where((ts // 600_000) % 2 == 0, 1e9, 1.0)
    db = _mk_db(tmp_path / "limb", window_ms=_WIN)
    try:
        db.sql("CREATE TABLE t (host STRING, ts TIMESTAMP TIME INDEX, u DOUBLE, v DOUBLE,"
               " PRIMARY KEY (host)) WITH (append_mode='true')")
        db.write("t", pa.table({
            "host": pa.array(np.repeat("h0", n)), "ts": pa.array(ts, pa.timestamp("ms")),
            "u": pa.array(vals), "v": pa.array(np.arange(n, dtype=np.float64)),
        }))
        db.flush()
        queries = (
            "SELECT time_bucket('600s', ts) AS tb, sum(u) AS su FROM t GROUP BY tb",
            "SELECT time_bucket('600s', ts) AS tb, max(v) AS mv FROM t GROUP BY tb",
            "SELECT host, count(*) AS c FROM t GROUP BY host",
        )
        solo = _solo(db, queries)
        for _ in range(8):
            before = dict(db.query_engine.stats)
            results, errors = _concurrent(db, queries)
            assert not errors
            d = _delta(db, before)
            for q, r in zip(queries, results):
                assert _ser(r) == solo[q]
            if d["batch_fused_dispatches"] == 1:
                # the verdict member left the tick and reran in f64 on its own
                assert d["batch_members"] == len(queries) - 1
                assert d["limb_reruns"] == 1
                return
        pytest.fail("no tick formed")
    finally:
        db.close()


def test_hash_overflow_member_runs_solo(tmp_path, monkeypatch):
    """A hash member whose slot table overflows decodes to a rerun verdict
    inside the tick and runs solo (its dense rung) with the solo bytes."""
    from greptimedb_tpu_torch.parallel import tile_planner

    db = _mk_db(tmp_path / "ovf", strategy="hash", window_ms=_WIN)
    try:
        _load(db, 8, n=6_000, n_keys=3000, nulls=False, null_tags=False)
        monkeypatch.setattr(tile_planner, "size_hash_slots", lambda config, d_est: 1024)
        queries = (
            "SELECT k, g, sum(v) AS sv FROM t GROUP BY k, g",  # ~3000 keys: overflows
            "SELECT g, max(w) AS xw FROM t GROUP BY g",
            "SELECT g, count(*) AS c FROM t GROUP BY g",
        )
        solo = _solo(db, queries)
        for _ in range(8):
            before = dict(db.query_engine.stats)
            results, errors = _concurrent(db, queries)
            assert not errors
            d = _delta(db, before)
            for q, r in zip(queries, results):
                assert _ser(r) == solo[q]
            if d["batch_fused_dispatches"] == 1:
                assert d["batch_members"] == len(queries) - 1
                assert d["agg_hash_overflow"] == 1
                return
        pytest.fail("no tick formed")
    finally:
        db.close()


# ---- the windowed result cache ------------------------------------------------------------


def test_result_cache_rehit_dispatches_nothing(tmp_path, monkeypatch):
    """Re-asking the same aligned window is served from the cache: no
    program runs, the same bytes."""
    from greptimedb_tpu_torch.parallel.tile_program import TileProgram

    runs = []
    real = TileProgram.run_with

    def counted(self, *a, **k):
        runs.append(1)
        return real(self, *a, **k)

    monkeypatch.setattr(TileProgram, "run_with", counted)
    db = _mk_db(tmp_path / "rc", cache_mb=32)
    try:
        _load(db, 7)
        db.sql_one(_CACHE_Q)
        first = db.sql_one(_CACHE_Q)
        assert runs, "the first asks ran no program"
        before = dict(db.query_engine.stats)
        n_runs = len(runs)
        again = db.sql_one(_CACHE_Q)
        d = _delta(db, before)
        assert d["result_cache_hits"] == 1
        assert len(runs) == n_runs, "a cache re-hit ran a program"
        assert _ser(again) == _ser(first)
    finally:
        db.close()


def test_result_cache_invalidated_by_write_and_flush(tmp_path):
    """A write moves the WAL tail, a flush the manifest version: either
    makes the cached window unreachable, and the rerun sees the new rows."""
    db = _mk_db(tmp_path / "rcinv", cache_mb=32)
    total = lambda t: sum(t.column("c").to_pylist())  # noqa: E731
    hits = lambda: db.query_engine.stats["result_cache_hits"]  # noqa: E731
    try:
        _load(db, 8, n=2_000)
        db.sql_one(_CACHE_Q)
        before = db.sql_one(_CACHE_Q)
        h0 = hits()
        db.sql_one(_CACHE_Q)
        assert hits() == h0 + 1
        _insert_probe_row(db)
        h1 = hits()
        after_write = db.sql_one(_CACHE_Q)
        assert hits() == h1, "a write must invalidate the cached window"
        assert total(after_write) == total(before) + 1
        db.flush()
        h2 = hits()
        after_flush = db.sql_one(_CACHE_Q)
        assert hits() == h2
        assert total(after_flush) == total(after_write)
        db.sql_one(_CACHE_Q)
        assert hits() == h2 + 1
    finally:
        db.close()


def test_result_cache_lru_eviction_unit():
    """Byte-bounded LRU: past the budget the least recently used entry
    goes first; an entry larger than the budget is never admitted;
    purge_region drops exactly the region's entries."""

    class _T:
        def __init__(self, nbytes):
            self.nbytes = nbytes

    def key(i, region=1):
        return (f"plan{i}", "lits", ("raw", 0, 10), ((region, 3, 7),))

    rc = WindowedResultCache(8 << 10)  # each entry below costs 2 KiB with its overhead
    for i in (1, 2, 3, 4):
        rc.put(key(i), _T(1 << 10), frozenset())
    assert rc.stats()["bytes"] == 8 << 10 and rc.stats()["evictions"] == 0
    assert rc.get(key(1)) is not None  # touched: key(2) is now the oldest
    rc.put(key(5), _T(1 << 10), frozenset())
    assert rc.get(key(2)) is None
    assert all(rc.get(key(i)) is not None for i in (1, 3, 4, 5))
    assert rc.stats()["evictions"] == 1
    rc.put(key(7), _T(64 << 10), frozenset())  # larger than the budget: never admitted
    assert rc.get(key(7)) is None
    rc.put(key(6, region=9), _T(1 << 10), frozenset())
    rc.purge_region(1)
    assert all(rc.get(key(i)) is None for i in (1, 3, 4, 5))
    assert rc.get(key(6, region=9)) is not None


def _insert_probe_row(db):
    db.write("t", pa.table({
        "k": pa.array(["k00000"]), "g": pa.array(["g0"]),
        "ts": pa.array(np.array([5_000], np.int64), pa.timestamp("ms")),
        "v": pa.array([100.0]), "w": pa.array([1.0]),
    }))


def test_result_cache_revalidates_against_a_racing_write(tmp_path, monkeypatch):
    """A write landing between the key's version snapshot and the cache
    boundary: the store must not publish under the old snapshot, and a
    probe must not adopt an entry whose versions moved."""
    total = lambda t: sum(t.column("c").to_pylist())  # noqa: E731
    db = _mk_db(tmp_path / "rcrace", cache_mb=32)
    try:
        _load(db, 11, n=2_000)
        db.sql_one(_CACHE_Q)
        base = total(db.sql_one(_CACHE_Q))
        rc = db.query_engine.tile_executor().result_cache
        db.flush()  # empties the cache for the region (its versions moved)
        e0 = rc.stats()["entries"]
        real_get = WindowedResultCache.get
        raced = []

        def get_with_write(self, key):
            if not raced:
                raced.append(True)
                _insert_probe_row(db)  # after the key's snapshot
            return real_get(self, key)

        monkeypatch.setattr(WindowedResultCache, "get", get_with_write)
        out = db.sql_one(_CACHE_Q)
        assert total(out) == base + 1, "the dispatch must see the write"
        assert rc.stats()["entries"] == e0, "a stale-snapshot result was published"
        monkeypatch.setattr(WindowedResultCache, "get", real_get)
        h0 = db.query_engine.stats["result_cache_hits"]
        db.sql_one(_CACHE_Q)  # re-caches under the current versions
        db.sql_one(_CACHE_Q)
        assert db.query_engine.stats["result_cache_hits"] == h0 + 1
        # adoption: the entry is current; a write lands before the probe
        raced.clear()
        monkeypatch.setattr(WindowedResultCache, "get", get_with_write)
        adopted = db.sql_one(_CACHE_Q)
        assert db.query_engine.stats["result_cache_hits"] == h0 + 1, "a stale entry served"
        assert total(adopted) == base + 2
    finally:
        db.close()


# ---- configuration ------------------------------------------------------------------------


@pytest.mark.parametrize("field,value", [
    ("window_ms", -1.0), ("max_members", 1), ("result_cache_mb", -1), ("fuse_programs", 1),
])
def test_batch_config_validation(field, value):
    """The reference's batch-section validation."""
    bc = BatchConfig(**{field: value})
    with pytest.raises(ConfigError):
        bc.validate()


# ---- repairs: the group-space decline and the host-read-free kernels ---------------------------


def test_table_fed_group_space_past_int32_declines(tmp_path):
    """Three tags whose quantized cardinalities multiply past 2^31 on the
    table-fed path (tile cache off): declined before lowering, counted in
    `declined`, and the CPU executor's answer served."""
    db = Database(str(tmp_path / "wide"), device="cpu")
    try:
        db.config.query.tile_cache_enable = False
        db.sql("CREATE TABLE w (a STRING, b STRING, c STRING, ts TIMESTAMP TIME INDEX,"
               " v DOUBLE, PRIMARY KEY (a, b, c)) WITH (append_mode='true')")
        n = 1100  # 2048 x 2048 x 2048 = 2^33 padded groups
        db.write("w", pa.table({
            "a": pa.array([f"a{i}" for i in range(n)]),
            "b": pa.array([f"b{(i * 7) % n}" for i in range(n)]),
            "c": pa.array([f"c{(i * 13) % n}" for i in range(n)]),
            "ts": pa.array(np.arange(n, dtype=np.int64), pa.timestamp("ms")),
            "v": pa.array(np.arange(n, dtype=np.float64)),
        }))
        db.flush()
        q = "SELECT a, b, c, sum(v) AS s FROM w GROUP BY a, b, c"
        before = dict(db.query_engine.stats)
        got = db.sql_one(q)
        d = _delta(db, before)
        assert d["declined"] == 1 and d["lowered"] == 0
        db.config.query.backend = "cpu"
        want = db.sql_one(q)
        assert _ser(got.sort_by([("a", "ascending")])) == _ser(want.sort_by([("a", "ascending")]))
    finally:
        db.close()


def test_group_space_decline_counts_like_the_union():
    """The decline's group space is the table-fed path's own [G]: quantized
    distinct values per tag across the regions (NULL counted) times the
    buckets; at 2^31 `distributed_groupby` declines before any upload."""
    from greptimedb_tpu_torch.parallel.executor import distributed_groupby

    t1 = pa.table({"a": pa.array(["x", "y", None]), "b": pa.array(["p", "p", "q"]),
                   "v": pa.array([1.0, 2.0, 3.0])})
    t2 = pa.table({"a": pa.array(["z", "x"]), "b": pa.array(["r", "p"]),
                   "v": pa.array([4.0, 5.0])})
    kw = dict(group_tags=["a", "b"], bucket_origin=0, bucket_interval=1,
              agg_specs=[("sum", "v")], device="cpu")
    # a: x, y, NULL, z -> 4; b: p, q, r -> 4: 16 groups per bucket
    res = distributed_groupby([t1, t2], bucket_col=None, n_buckets=1, **kw)
    assert res is not None and res.plan.num_groups == 16
    tt1, tt2 = (t.append_column("ts", pa.array([0] * t.num_rows, pa.int64())) for t in (t1, t2))
    # 16 groups x 2^27 buckets = 2^31: declined before anything is uploaded
    assert distributed_groupby([tt1, tt2], bucket_col="ts", n_buckets=1 << 27, **kw) is None


@pytest.mark.parametrize("layout", ["clustered", "shuffled"])
def test_guard_branches_plain_forms(layout):
    """The plain forms behind the predicated branches: K2's guard passes on
    clustered ids and fails on shuffled ones, and whichever branch stands
    gives the scatter form's counts, minima and maxima and its sums within
    rel 1e-12 (K2 adds per block); K6's two branches give the same
    quantized sums and bounds whichever the guard picks."""
    rng = np.random.default_rng(3)
    n, G = 1 << 16, 128
    g = np.sort(rng.integers(0, G, n)).astype(np.int32)
    if layout == "shuffled":
        g = rng.permutation(g)
    gids = torch.from_numpy(g)
    mask = torch.from_numpy(rng.random(n) < 0.9)
    v = torch.from_numpy(np.round(rng.normal(0, 100, n)))
    aggs = ("count", "max", "min", "sum")
    ok, st, _base = agg.segment_reduce_blocked_plain([v], gids, [mask], mask, G, aggs)
    assert ok == (layout == "clustered")
    multi = agg.segment_aggregate_multi([v], gids, G, aggs, [mask], mask)
    scat = agg.segment_reduce_scatter_plain([v], gids, [mask], mask, G, aggs)
    for f in ("counts", "mins", "maxs"):
        assert torch.equal(getattr(multi, f), getattr(scat, f))
    torch.testing.assert_close(multi.sums, scat.sums, rtol=1e-12, atol=0.0)
    limbs = agg.quantize_limbs_plain(v)
    sums, errs, _c, presence = agg.limb_segment_sums_plain([limbs], gids, mask, G)
    vhat, half = agg.dequantize_limbs_plain(*limbs)
    slow = agg.segment_reduce_scatter_plain([vhat, half], gids, [mask, mask], mask, G,
                                            ("sum", "count"))
    assert torch.equal(presence, slow.counts[0])
    torch.testing.assert_close(sums[0], slow.sums[0], rtol=1e-12, atol=1e-9)
    torch.testing.assert_close(errs[0], slow.sums[1], rtol=1e-12, atol=1e-12)


def test_hash_rounds_in_one_call_plain():
    """K17's plain form: one call runs every probe round (the reference's
    while_loop) and leaves its round count on the tensors' device; the
    count and the slots are those of a round-by-round loop."""
    rng = np.random.default_rng(4)
    h = 1 << 10
    gids = torch.from_numpy(rng.integers(0, 1 << 40, 700).astype(np.int64))
    active = torch.from_numpy(rng.random(700) < 0.9)
    table, slots, over = agg.hash_group_slots(
        torch.full((h,), agg.HASH_EMPTY, dtype=torch.int64), gids, active)
    rounds = agg.last_hash_rounds()
    assert int(over) == 0 and 1 <= rounds <= min(2 * h, 1024)
    assert agg.hash_group_slots.last_rounds.device.type == "cpu"
    placed = slots[active]
    assert bool((placed < h).all()) and torch.equal(table[placed.long()], gids[active])
    # a second call over the filled table finds every key where it lies
    table2, slots2, _o = agg.hash_group_slots(table.clone(), gids, active)
    assert torch.equal(slots2, slots) and torch.equal(table2, table)


def test_counters_lose_no_update_under_threads():
    """The engine's counters are bumped by the members of a tick on their
    own threads: more threads than cores, a short switch interval, no lost
    update."""
    import sys

    from greptimedb_tpu_torch.parallel.tile_executor import Counters

    c = Counters({"n": 0})
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [c.add(n=1) for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert c["n"] == 16 * 2000


def test_tick_keeps_its_members_planes_past_half_the_budget(tmp_path):
    """An entry past half the tile budget releases the planes a solo query
    that adds planes does not read; inside a tick it must not, or each
    member would drop the next member's planes and every tick would
    re-upload them and build a new tick program."""
    db = _mk_db(tmp_path / "half", window_ms=_WIN)
    try:
        _load(db, 12, n=_N_ROWS)
        solo = _solo(db, _QUERIES[:4])
        cache = db.query_engine.tile_executor().cache
        entry = next(iter(cache._super.values()))
        cache.budget = entry.nbytes * 3 // 2  # past half the budget, inside it
        # every plane dropped: each solo query below adds its planes and
        # releases the others'
        cache.release_unneeded(entry, set())
        solo = _solo(db, _QUERIES[:4])
        _tick(db, _QUERIES[:4])
        results, d = _tick(db, _QUERIES[:4])
        assert d["tick_graph_captures"] == 0, "a tick released planes its members read"
        for q, r in zip(_QUERIES[:4], results):
            assert _ser(r) == solo[q]
    finally:
        db.close()
