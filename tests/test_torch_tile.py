"""The tile path as a whole: the port's Database (device="cpu", tile cache
on, at its defaults) beside the reference Database in the same
configuration — the passes the port has not ported switched off,
agg_strategy "sort", no tile persistence — on the same writes.

* the 15 TSBS cpu-only queries at 40 hosts x 12 h with 3 metrics;
* the shapes of the reference's tests/test_tile_cache.py and
  tests/test_device_finalize.py that fall inside the slice (tag/value
  filters, NULL tags and values, hierarchical and bucket-only layouts,
  last_value, windows, ORDER BY / LIMIT / OFFSET and HAVING on the
  card), as cases of parametrised tests;
* a write after a warm query (memtable tail, flush — the delta route —,
  a new tag value that moves dictionary codes — repaired in place)
  changes the next answer;
* a mixed-magnitude block fails the limb verdict and reruns in f64.

Every port query must be answered by the tile path, and the reference by
its own tile path, so the parity is not vacuous.  Tolerances: keys,
counts, min, max and last exact; sum/avg within rel 1e-12."""

import math

import numpy as np
import pyarrow as pa
import pytest
import torch

import chip_smoke
from greptimedb_tpu.database import Database as JaxDatabase
from greptimedb_tpu.utils import metrics
from greptimedb_tpu.utils.config import Config as JaxConfig
from greptimedb_tpu_torch import Database
from greptimedb_tpu_torch.utils.config import QueryConfig
from greptimedb_tpu_torch.utils.errors import ConfigError

# the reference's passes the port has not ported: its configuration here
# (time_major and incremental_tile run on both sides, at their defaults)
UNPORTED_PASSES = (
    "cold_host_serve", "fused_build", "pipelined_build", "stream_spill",
    "chunk_placement", "mesh_dispatch", "streamed_readback", "host_fast_path", "cost_route",
)
# the port's host routes (parallel/tile_host.py) and its fused family
# build: these tests check the card's path, so the port names them in
# query.disabled_passes as the reference side above does
HOST_ROUTES = ("cost_route", "host_fast_path", "cold_host_serve", "fused_build")
TSBS = chip_smoke.Tsbs(40, 12, n_metrics=3)
NAMES = [name for name, _sql in TSBS.queries()]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops on one thread while the test workers share
    the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_db(home: str) -> JaxDatabase:
    cfg = JaxConfig()
    cfg.query.disabled_passes = UNPORTED_PASSES
    cfg.query.agg_strategy = "sort"
    cfg.query.tile_persist_enable = False
    cfg.query.fallback_to_cpu = False
    return JaxDatabase(config=cfg, data_home=home)


def _port_db(home: str) -> Database:
    """The port's Database with its host routes off (`HOST_ROUTES`)."""
    db = Database(home, device="cpu")
    db.config.query.disabled_passes = HOST_ROUTES
    return db


class _JaxWriter:
    """chip_smoke.ingest's surface (sql / write / flush) over the
    reference Database."""

    def __init__(self, db):
        self.db = db

    def sql(self, text):
        return self.db.sql(text)

    def write(self, table, rows):
        return self.db.insert_rows(table, rows)

    def flush(self):
        self.db.storage.flush_all()


def _run_pair(port, ref, sql):
    """(port table, reference table); both must take their tile paths."""
    eng = port.query_engine
    d0 = eng.stats["tile_dispatches"]
    got = port.sql_one(sql)
    assert eng.last_path == "tile" and eng.stats["tile_dispatches"] == d0 + 1, sql
    r0 = metrics.TILE_LOWERED_TOTAL.get()
    want = ref.sql_one(sql)
    assert metrics.TILE_LOWERED_TOTAL.get() > r0, f"the reference declined its tile path: {sql}"
    return got, want


def _assert_same(got: pa.Table, want: pa.Table, sql: str, ordered: bool):
    assert got.column_names == want.column_names, (sql, got.column_names, want.column_names)
    assert got.num_rows == want.num_rows, (sql, got.num_rows, want.num_rows)
    if not ordered:
        keys = [(c, "ascending") for c in got.column_names
                if pa.types.is_string(got.schema.field(c).type)
                or pa.types.is_timestamp(got.schema.field(c).type)]
        keys += [(c, "ascending") for c in got.column_names if (c, "ascending") not in keys]
        got, want = got.sort_by(keys), want.sort_by(keys)
    for c in got.column_names:
        for x, y in zip(got[c].to_pylist(), want[c].to_pylist()):
            if isinstance(x, float) and isinstance(y, float):
                assert (math.isnan(x) and math.isnan(y)) or math.isclose(
                    x, y, rel_tol=1e-12, abs_tol=0.0), (sql, c, x, y)
            else:
                assert x == y, (sql, c, x, y)


# ---- the 15 TSBS queries ------------------------------------------------------------


@pytest.fixture(scope="module")
def tsbs_pair(tmp_path_factory):
    ref = _jax_db(str(tmp_path_factory.mktemp("tile_jax")))
    port = _port_db(str(tmp_path_factory.mktemp("tile_port")))
    try:
        chip_smoke.ingest(_JaxWriter(ref), TSBS)
        _rows, gt = chip_smoke.ingest(port, TSBS)
        yield port, ref, gt
    finally:
        port.close()
        ref.close()


@pytest.mark.parametrize("name", NAMES)
def test_tsbs_query_matches_reference_on_the_tile_path(tsbs_pair, name):
    port, ref, gt = tsbs_pair
    sql = dict(TSBS.queries())[name]
    got, want = _run_pair(port, ref, sql)
    assert got.num_rows > 0
    chip_smoke.compare_tables(got, want, name + " " + sql)
    if name == "double-groupby-1":
        chip_smoke.check_ground_truth(got, gt, TSBS, tol=1e-7)
    # warm: the same answer again from the cached planes
    again = port.sql_one(sql)
    assert port.query_engine.last_path == "tile"
    assert again.equals(got)


def test_tile_cache_counts_builds_and_hits(tsbs_pair):
    port, _ref, _gt = tsbs_pair
    port.sql_one(dict(TSBS.queries())["lastpoint"])
    stats = port.query_engine.tile_cache.stats()
    assert stats["regions"] == 1 and stats["hits"] >= 1 and stats["bytes"] > 0
    assert port.query_engine.stats["tile_declined"] == 0


# ---- the reference's tile / device-finalize shapes ------------------------------------


def _t_rows():
    """tests/test_device_finalize.py's table: host_5's region is NULL, u
    carries heavy ties, v is NULL for host_3 and scattered elsewhere."""
    import random

    rows = []
    rng = random.Random(7)
    for t in range(120):
        for h in range(6):
            region = "NULL" if h == 5 else f"'r{h % 2}'"
            u = (t // 10) % 4 + h
            s = rng.randint(0, 9)
            v = "NULL" if h == 3 or (t + h) % 11 == 0 else f"{(t * h) % 17 + 0.5}"
            rows.append(f"('host_{h}', {region}, {t * 1000}, {u}, {s}, {v})")
    return rows


_T_DDL = (
    "CREATE TABLE t (host STRING, region STRING, ts TIMESTAMP TIME INDEX,"
    " u DOUBLE, s DOUBLE, v DOUBLE, PRIMARY KEY (host, region))"
)


def _load_t(port, ref, flush=True):
    for db in (port, ref):
        db.sql(_T_DDL)
        db.sql("INSERT INTO t VALUES " + ",".join(_t_rows()))
    if flush:
        port.flush()
        ref.storage.flush_all()


@pytest.fixture(scope="module")
def t_pair(tmp_path_factory):
    ref = _jax_db(str(tmp_path_factory.mktemp("t_jax")))
    port = _port_db(str(tmp_path_factory.mktemp("t_port")))
    try:
        _load_t(port, ref)
        yield port, ref
    finally:
        port.close()
        ref.close()


SHAPE_QUERIES = [
    # test_tile_cache.py Q: hierarchical (host, bucket) over pk (host, region)
    "SELECT host, time_bucket('30s', ts) AS tb, avg(u) AS au, max(s) AS ms, count(*) AS c"
    " FROM t GROUP BY host, tb",
    # filters on tags and values
    "SELECT host, avg(u) AS au, count(*) AS c FROM t WHERE host = 'host_1' AND u > 3 GROUP BY host",
    "SELECT host, max(s) AS ms FROM t WHERE host IN ('host_1', 'host_4') AND s >= 2 GROUP BY host",
    # string inequality on a tag is exact on sorted codes
    "SELECT host, count(*) AS c FROM t WHERE host > 'host_2' GROUP BY host",
    "SELECT host, count(*) AS c FROM t WHERE host <= 'host_3' GROUP BY host",
    # NULL tags and values; a non-prefix group tag (hierarchical fold)
    "SELECT region, count(*) AS c, avg(v) AS av, min(v) AS mv FROM t GROUP BY region",
    "SELECT host, count(v) AS cv, sum(v) AS sv FROM t GROUP BY host",
    # ungrouped aggregate and a value filter
    "SELECT count(*) AS c, sum(u) AS su, max(v) AS mv FROM t WHERE v > 3.0",
    # bucket-only group-by (a time-major plan on both sides)
    "SELECT time_bucket('10s', ts) AS tb, max(u) AS mu, avg(s) AS a FROM t GROUP BY tb",
    # last_value on a pk-prefix group
    "SELECT host, last_value(u) AS lu, last_value(v) AS lv FROM t GROUP BY host",
    # a window
    "SELECT host, time_bucket('30s', ts) AS tb, min(s) AS ms FROM t"
    " WHERE ts >= 30000 AND ts < 90000 GROUP BY host, tb",
]

# tests/test_device_finalize.py ORDERBY_LIMIT_QUERIES: consumed on the card
ORDERBY_LIMIT_QUERIES = [
    "SELECT time_bucket('30s', ts) AS tb, max(u) AS mu FROM t GROUP BY tb ORDER BY tb DESC LIMIT 2",
    "SELECT host, max(u) AS mu FROM t GROUP BY host ORDER BY mu DESC LIMIT 3",
    "SELECT host, max(u) AS mu FROM t GROUP BY host ORDER BY mu ASC LIMIT 4",
    "SELECT host, time_bucket('30s', ts) AS tb, avg(u) AS au FROM t"
    " GROUP BY host, tb ORDER BY tb DESC, host ASC LIMIT 7",
    "SELECT host, time_bucket('30s', ts) AS tb, avg(u) AS au FROM t"
    " GROUP BY host, tb ORDER BY tb DESC, host ASC LIMIT 5 OFFSET 3",
    "SELECT host, avg(u) AS au FROM t GROUP BY host ORDER BY au DESC LIMIT 5 OFFSET 1000",
    "SELECT host, avg(v) AS av FROM t GROUP BY host ORDER BY av ASC LIMIT 4",
    "SELECT host, avg(v) AS av FROM t GROUP BY host ORDER BY av DESC LIMIT 4",
    "SELECT region, count(*) AS c FROM t GROUP BY region ORDER BY region ASC LIMIT 3",
    "SELECT host, sum(u) AS su FROM t GROUP BY host LIMIT 3",
    "SELECT host, time_bucket('30s', ts) AS tb, min(s) AS ms FROM t"
    " WHERE ts >= 30000 AND ts < 90000 GROUP BY host, tb ORDER BY tb ASC, host DESC LIMIT 6",
    "SELECT host, last_value(u) AS lu FROM t GROUP BY host ORDER BY lu DESC LIMIT 3",
    # lastpoint: compaction with no key
    "SELECT host, last_value(u) AS lu FROM t GROUP BY host",
    # a keyed cap above K7's limit (720 groups, no LIMIT): the Sort stays
    # on the host
    "SELECT host, time_bucket('1s', ts) AS tb, max(u) AS mu FROM t GROUP BY host, tb"
    " ORDER BY tb DESC, host ASC",
]

# tests/test_device_finalize.py HAVING_QUERIES: HAVING is consumed on the
# card (K13) by both packages; what follows an unconsumable operator
# replays on the host over the compact result
HAVING_QUERIES = [
    "SELECT host, avg(u) AS au FROM t GROUP BY host HAVING avg(u) > 6.0",
    "SELECT host, avg(u) AS au, count(*) AS c FROM t GROUP BY host"
    " HAVING avg(u) > 5.0 AND count(*) >= 100",
    "SELECT host, avg(u) AS au FROM t GROUP BY host HAVING avg(u) > 8.0 OR avg(u) < 4.0",
    "SELECT host, avg(v) AS av FROM t GROUP BY host HAVING avg(v) > 5.0",
    "SELECT host, avg(v) AS av FROM t GROUP BY host HAVING avg(v) IS NULL",
    "SELECT host, avg(v) AS av FROM t GROUP BY host HAVING avg(v) IS NOT NULL",
    "SELECT host, avg(u) AS au FROM t GROUP BY host HAVING avg(u) BETWEEN 5.0 AND 8.0",
    "SELECT host, avg(u) AS au, max(u) AS mu FROM t GROUP BY host HAVING max(u) > avg(u)",
    "SELECT host, avg(u) AS au FROM t GROUP BY host HAVING NOT (avg(u) > 6.0)",
    "SELECT host, time_bucket('30s', ts) AS tb, avg(u) AS au FROM t"
    " GROUP BY host, tb HAVING avg(u) > 4.0 ORDER BY au DESC, host ASC LIMIT 5",
    "SELECT host, avg(u) AS au FROM t GROUP BY host HAVING avg(u) > 5.0"
    " ORDER BY au + 1.0 DESC LIMIT 3",
]


@pytest.mark.parametrize("sql", SHAPE_QUERIES)
def test_tile_shape_matches_reference(t_pair, sql):
    port, ref = t_pair
    got, want = _run_pair(port, ref, sql)
    _assert_same(got, want, sql, ordered=False)


@pytest.mark.parametrize("sql", ORDERBY_LIMIT_QUERIES)
def test_device_finalize_matches_reference(t_pair, sql):
    """ORDER BY / LIMIT on the card (K7) gives the reference's rows in the
    reference's order, and the same rows as the port's own host replay."""
    port, ref = t_pair
    got, want = _run_pair(port, ref, sql)
    _assert_same(got, want, sql, ordered=True)
    port.config.query.device_topk = False
    try:
        host = port.sql_one(sql)
    finally:
        port.config.query.device_topk = True
    assert port.query_engine.last_path == "tile"
    assert host.to_pydict() == got.to_pydict()


@pytest.mark.parametrize("n_keys", [4, 5])
def test_order_keys_beyond_the_device_limit_sort_on_the_host(t_pair, monkeypatch, n_keys):
    """K7 takes at most TOPK_MAX_KEYS order keys: a plan with more leaves
    the Sort to the host (the spec orders by nothing), still answers on the
    tile path and matches the reference."""
    from greptimedb_tpu_torch.ops.aggregate import TOPK_MAX_KEYS
    from greptimedb_tpu_torch.parallel import tile_planner

    keys = ["a", "b", "c", "host", "tb"][-n_keys:]
    sql = ("SELECT host, time_bucket('30s', ts) AS tb, max(u) AS a, min(s) AS b, max(s) AS c"
           f" FROM t GROUP BY host, tb ORDER BY {', '.join(keys)} LIMIT 5")
    specs = []
    real = tile_planner.plan_device_finalize

    def spy(*args, **kwargs):
        specs.append(real(*args, **kwargs))
        return specs[-1]

    monkeypatch.setattr(tile_planner, "plan_device_finalize", spy)
    port, ref = t_pair
    got, want = _run_pair(port, ref, sql)
    assert port.query_engine.last_path == "tile"
    _assert_same(got, want, sql, ordered=True)
    assert specs, "the tile planner did not run"
    for spec in specs:
        assert spec is None or len(spec.order) <= TOPK_MAX_KEYS
    if n_keys <= TOPK_MAX_KEYS:
        assert specs[-1] is not None and len(specs[-1].order) == n_keys


@pytest.mark.parametrize("sql", HAVING_QUERIES)
def test_having_replays_on_host_and_matches(t_pair, monkeypatch, sql):
    """Each HAVING folds into the device program (the spec carries its
    tree); the port's answer equals the reference's."""
    from greptimedb_tpu_torch.parallel import tile_planner

    specs = []
    real = tile_planner.plan_device_finalize

    def spy(*args, **kwargs):
        specs.append(real(*args, **kwargs))
        return specs[-1]

    monkeypatch.setattr(tile_planner, "plan_device_finalize", spy)
    port, ref = t_pair
    got, want = _run_pair(port, ref, sql)
    assert specs and specs[-1] is not None and specs[-1].having is not None
    _assert_same(got, want, sql, ordered="ORDER BY" in sql)


# ---- writes after the planes are built ------------------------------------------------

_W_QUERY = ("SELECT host, time_bucket('30s', ts) AS tb, avg(u) AS au, count(*) AS c,"
            " max(v) AS mv FROM t GROUP BY host, tb")


@pytest.mark.parametrize("write", ["memtable_tail", "flush", "new_tag_value"])
def test_write_after_warm_query_changes_the_answer(tmp_path, write):
    ref = _jax_db(str(tmp_path / "jax"))
    port = _port_db(str(tmp_path / "port"))
    try:
        _load_t(port, ref)
        warm, _ = _run_pair(port, ref, _W_QUERY)
        # rows in a later, disjoint time window (the tile path stays on)
        host = "edge_0" if write == "new_tag_value" else "host_1"
        rows = ",".join(f"('{host}', 'r1', {200_000 + i * 1000}, {i}, 1, {i + 0.25})"
                        for i in range(40))
        for db in (port, ref):
            db.sql("INSERT INTO t VALUES " + rows)
        if write != "memtable_tail":
            port.flush()
            ref.storage.flush_all()
        got, want = _run_pair(port, ref, _W_QUERY)
        _assert_same(got, want, _W_QUERY, ordered=False)
        assert got.num_rows > warm.num_rows
        if write == "new_tag_value":
            # "edge_0" sorts first: every cached host code moved
            assert got.sort_by("host")["host"][0].as_py() == "edge_0"
    finally:
        port.close()
        ref.close()


def test_limb_verdict_reruns_in_exact_f64(tmp_path):
    """Tiny values co-blocked with huge ones break a block's shared scale:
    the verdict byte fires and the query reruns with f64 accumulation
    (tests/test_tile_cache.py test_limb_mixed_magnitude_reruns_exact)."""
    n = 65536
    ts = np.arange(n, dtype=np.int64) * 1000
    vals = np.where((ts // 600_000) % 2 == 0, 1e9, 1.0)
    tbl = pa.table({
        "host": pa.array(np.repeat("h0", n)), "region": pa.array(np.repeat("r0", n)),
        "ts": pa.array(ts, pa.timestamp("ms")), "u": pa.array(vals), "s": pa.array(vals),
        "v": pa.array(vals),
    })
    ref = _jax_db(str(tmp_path / "jax"))
    port = _port_db(str(tmp_path / "port"))
    try:
        for db in (port, ref):
            db.sql(_T_DDL)
        port.write("t", tbl)
        ref.insert_rows("t", tbl)
        port.flush()
        ref.storage.flush_all()
        q = "SELECT time_bucket('600s', ts) AS tb, sum(u) AS su FROM t GROUP BY tb"
        tile = port.query_engine.tile_executor()
        before = tile.limb_reruns
        r0 = metrics.TILE_LIMB_RERUNS.get()
        got, want = _run_pair(port, ref, q)
        assert tile.limb_reruns == before + 1, "the verdict did not fire"
        assert metrics.TILE_LIMB_RERUNS.get() > r0
        _assert_same(got, want, q, ordered=False)
        port.config.query.backend = "cpu"
        exact = port.sql_one(q)
        _assert_same(got, exact, q, ordered=False)
    finally:
        port.close()
        ref.close()


@pytest.mark.parametrize("with_count", [False, True])
def test_packed_readback_large_group_space(tmp_path, with_count):
    """>= 2^14 groups: bit-packed presence rows and f32 avg rows, or exact
    int32 rows with a count(*) output (tests/test_tile_cache.py
    test_packed_readback_large_group_space)."""
    hosts, ticks = 32, 2048  # 32 hosts x 512 buckets = 16384 groups
    rng = np.random.default_rng(17)
    tbl = pa.table({
        "host": pa.array(np.repeat([f"host_{i:02d}" for i in range(hosts)], ticks)),
        "region": pa.array(np.repeat([f"r{i % 2}" for i in range(hosts)], ticks)),
        "ts": pa.array(np.tile(np.arange(ticks, dtype=np.int64) * 1000, hosts), pa.timestamp("ms")),
        "u": pa.array(rng.uniform(0, 100, hosts * ticks)),
        "s": pa.array(rng.uniform(0, 100, hosts * ticks)),
        "v": pa.array(rng.uniform(0, 100, hosts * ticks)),
    })
    ref = _jax_db(str(tmp_path / "jax"))
    port = _port_db(str(tmp_path / "port"))
    try:
        for db in (port, ref):
            db.sql(_T_DDL)
        port.write("t", tbl)
        ref.insert_rows("t", tbl)
        port.flush()
        ref.storage.flush_all()
        q = ("SELECT host, time_bucket('4s', ts) AS tb, avg(u) AS au"
             + (", count(*) AS c" if with_count else "") + " FROM t GROUP BY host, tb")
        got, want = _run_pair(port, ref, q)
        _assert_same(got, want, q, ordered=False)
    finally:
        port.close()
        ref.close()


# ---- configuration -----------------------------------------------------------------


def test_agg_strategy_defaults_to_auto():
    cfg = QueryConfig()
    assert cfg.agg_strategy == "auto" and cfg.agg_hash_min_group_space == 1 << 16
    assert cfg.max_groups == 1 << 16 and cfg.max_internal_groups == 1 << 24


@pytest.mark.parametrize("knobs,ok", [
    ({"agg_strategy": "auto"}, True),
    ({"agg_strategy": "hash"}, True),
    ({"agg_strategy": "sort"}, True),
    ({"agg_strategy": "dense"}, False),
    ({"agg_strategy": ""}, False),
    ({"agg_hash_min_group_space": 1024}, True),
    ({"agg_hash_min_group_space": 1023}, False),
])
def test_agg_strategy_config_values(knobs, ok):
    """The reference's accepted strategies and agg_hash_min_group_space
    floor (greptimedb_tpu/utils/config.py:1189-1199)."""
    if ok:
        cfg = QueryConfig(**knobs)
        for k, v in knobs.items():
            assert getattr(cfg, k) == v
    else:
        with pytest.raises(ConfigError, match="agg_strategy|agg_hash_min_group_space"):
            QueryConfig(**knobs)


def test_disabled_limb_pass_accumulates_in_f64(tmp_path):
    port = _port_db(str(tmp_path / "port"))
    try:
        port.config.query.disabled_passes = HOST_ROUTES + ("limb_quantize",)
        port.sql(_T_DDL)
        port.sql("INSERT INTO t VALUES " + ",".join(_t_rows()))
        port.flush()
        got = port.sql_one("SELECT host, avg(u) AS au FROM t GROUP BY host")
        assert port.query_engine.last_path == "tile"
        port.config.query.backend = "cpu"
        _assert_same(got, port.sql_one("SELECT host, avg(u) AS au FROM t GROUP BY host"),
                     "avg", ordered=False)
    finally:
        port.close()


def test_drop_table_releases_the_planes(tmp_path):
    port = _port_db(str(tmp_path / "port"))
    try:
        port.sql(_T_DDL)
        port.sql("INSERT INTO t VALUES " + ",".join(_t_rows()))
        port.flush()
        port.sql_one("SELECT host, max(u) AS mu FROM t GROUP BY host")
        cache = port.query_engine.tile_cache
        assert cache.stats()["regions"] == 1
        port.sql("DROP TABLE t")
        assert cache.stats()["regions"] == 0 and cache.stats()["bytes"] == 0
    finally:
        port.close()
