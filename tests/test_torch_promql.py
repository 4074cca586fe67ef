"""TQL (PromQL) through the port's Database on the CPU against the reference
Database with `tql.tile = False` (its legacy path, the oracle: the
reference's own tile path fails its parity tests on this JAX version,
ROADMAP Queue C), on the same writes:

* the queries of tests/test_promql.py (memtable data: the port's tile
  path declines them and its legacy path answers) and the same queries
  after a flush (the port's tile path answers what it expresses);
* EXACT_QUERIES / ULP_QUERIES of tests/test_tql_tile.py on the port's tile
  route and on its legacy route;
* the `tql.max_cells` decline, the compact readback, and a kernel
  failure raising instead of degrading.

tests/test_torch_tql_routes.py holds the port's tile route against its
legacy route (several regions, the dedup keep plane, the warm contract,
memtable rows, a dictionary growth, a numpy twin).

Tolerances, and why: labels, timestamps, counts, min, max, last, first,
timestamp() and matcher results exact; sum-based values and rate /
increase over counters with resets within relative 1e-12 — the port's
counter-reset strip keeps a running sum per series where the reference
subtracts a baseline from a global prefix sum (last-ulp differences on
series with a reset), and folds across regions add in another order.
Every other result is held exact."""

import math

import numpy as np
import pyarrow as pa
import pytest
import torch

from greptimedb_tpu.database import Database as JaxDatabase
from greptimedb_tpu.utils.config import Config as JaxConfig
from greptimedb_tpu_torch import Database
from greptimedb_tpu_torch.ops import rate as R
from greptimedb_tpu_torch.query.promql import tile_exec


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_db(home: str) -> JaxDatabase:
    cfg = JaxConfig()
    cfg.tql.tile = False
    cfg.query.fallback_to_cpu = False
    return JaxDatabase(config=cfg, data_home=home)


def _rows(t: pa.Table):
    return list(zip(*[t[c].to_pylist() for c in t.column_names]))


def _assert_same(got: pa.Table, want: pa.Table, q: str, rtol: float = 0.0, ordered=True):
    assert got.column_names == want.column_names, (q, got.column_names, want.column_names)
    g, w = _rows(got), _rows(want)
    if not ordered:
        g, w = sorted(g, key=repr), sorted(w, key=repr)
    assert len(g) == len(w), (q, len(g), len(w))
    for a, b in zip(g, w):
        assert a[:-1] == b[:-1], (q, a, b)
        x, y = a[-1], b[-1]
        if rtol == 0.0:
            assert x == y or (math.isnan(x) and math.isnan(y)), (q, a, b)
        else:
            assert math.isclose(x, y, rel_tol=rtol, abs_tol=0.0), (q, a, b)


class _Pair:
    """The port (device="cpu") and the reference, written identically."""

    def __init__(self, tmp_path_factory, name):
        self.port = Database(str(tmp_path_factory.mktemp(f"{name}_port")), device="cpu")
        # the tile route's synchronous build: a family's first touch under
        # the fused build is held in tests/test_torch_fused_build.py
        self.port.config.query.disabled_passes = ("fused_build",)
        self.ref = _jax_db(str(tmp_path_factory.mktemp(f"{name}_ref")))

    def sql(self, text):
        self.port.sql(text)
        self.ref.sql(text)

    def flush(self):
        self.port.flush()
        self.ref.storage.flush_all()

    def close(self):
        self.port.close()
        self.ref.close()

    def run(self, q, tile=True):
        """(port result, reference legacy result, counter deltas)."""
        eng = self.port.query_engine
        self.port.config.tql.tile = tile
        before = dict(eng.stats)
        try:
            got = self.port.sql_one(q)
        finally:
            self.port.config.tql.tile = True
        delta = {k: eng.stats[k] - before[k] for k in before}
        return got, self.ref.sql_one(q), delta


# ---- the queries of tests/test_promql.py ------------------------------------------


def _promql_tables(pair):
    pair.sql("CREATE TABLE http_requests_total (host STRING, job STRING, ts TIMESTAMP(3), "
             "val DOUBLE, TIME INDEX (ts), PRIMARY KEY (host, job))")
    rows = []
    for h, slope in (("a", 2.0), ("b", 5.0)):
        for i in range(61):
            ts = i * 10_000
            rows.append(f"('{h}', 'api', {ts}, {slope * ts / 1000.0})")
    pair.sql(f"INSERT INTO http_requests_total VALUES {', '.join(rows)}")
    pair.sql("CREATE TABLE resets (ts TIMESTAMP(3), val DOUBLE, TIME INDEX (ts))")
    pair.sql("INSERT INTO resets VALUES " + ", ".join(
        f"({i * 10_000}, {(i * 10) % 500})" for i in range(121)))
    pair.sql("CREATE TABLE saw (ts TIMESTAMP(3), val DOUBLE, TIME INDEX (ts))")
    pair.sql("INSERT INTO saw VALUES " + ", ".join(
        f"({i * 10_000}, {v})" for i, v in enumerate([0, 1, 2, 0, 1, 0, 5, 5])))
    pair.sql("CREATE TABLE limits (host STRING, ts TIMESTAMP(3), val DOUBLE, TIME INDEX (ts), "
             "PRIMARY KEY (host))")
    pair.sql("INSERT INTO limits VALUES ('a', 400000, 100), ('b', 400000, 200)")
    pair.sql("CREATE TABLE once (ts TIMESTAMP(3), val DOUBLE, TIME INDEX (ts))")
    pair.sql("INSERT INTO once VALUES (590000, 1.0)")
    for t in ("s1", "s2", "lft"):
        pair.sql(f"CREATE TABLE {t} (host STRING, ts TIMESTAMP(3), val DOUBLE, TIME INDEX (ts), "
                 "PRIMARY KEY (host))")
    pair.sql("INSERT INTO s1 VALUES ('x', 60000, 100)")
    pair.sql("INSERT INTO s2 VALUES ('x', 60000, 150), ('x', 900000, 200)")
    pair.sql("INSERT INTO lft VALUES ('x', 60000, 1), ('x', 900000, 2)")
    pair.sql("CREATE TABLE rgt (host STRING, job STRING, ts TIMESTAMP(3), val DOUBLE, "
             "TIME INDEX (ts), PRIMARY KEY (host, job))")
    pair.sql("INSERT INTO rgt VALUES ('x', 'j1', 60000, 1), ('x', 'j2', 900000, 1)")
    pair.sql("CREATE TABLE hist (le STRING, job STRING, ts TIMESTAMP(3), val DOUBLE, "
             "TIME INDEX (ts), PRIMARY KEY (le, job))")
    rows = []
    for job, counts in (("api", [10, 30, 60, 100]), ("db", [0, 5, 5, 40])):
        for le, c in zip(["0.1", "0.5", "1", "+Inf"], counts):
            rows.append(f"('{le}', '{job}', 60000, {c})")
    pair.sql("INSERT INTO hist VALUES " + ",".join(rows))


HTR = "http_requests_total"
PROMQL_QUERIES = [
    f"TQL EVAL (300, 600, '60s') rate({HTR}[5m])",
    f"TQL EVAL (300, 600, '60s') sum(increase({HTR}[5m]))",
    f"TQL EVAL (600, 600, '60s') {HTR}{{host=\"a\"}}",
    f"TQL EVAL (600, 600, '60s') avg_over_time({HTR}{{host=\"b\"}}[1m])",
    f"TQL EVAL (600, 600, '60s') {HTR} * 2 > 3000",
    f"TQL EVAL (600, 600, '60s') {HTR} - {HTR}",
    "TQL EVAL (600, 1200, '300s') rate(resets[5m])",
    f"TQL EVAL (600, 600, '60s') topk(1, {HTR})",
    f"TQL EVAL (600, 600, '60s') {HTR}{{host=~\"a|b\"}}",
    f"TQL EVAL (600, 600, '60s') {HTR}{{host!~\"a\"}}",
    f"TQL EVAL (600, 600, '60s') max_over_time(rate({HTR}[1m])[5m:30s])",
    f"TQL EVAL (500, 600, '50s') {HTR}{{host=\"a\"}} @ 300",
    f"TQL EVAL (600, 600, '60s') {HTR}{{host=\"a\"}} @ start()",
    f"TQL EVAL (600, 600, '60s') deriv({HTR}{{host=\"b\"}}[2m])",
    f"TQL EVAL (600, 600, '60s') predict_linear({HTR}{{host=\"b\"}}[2m], 60)",
    "TQL EVAL (80, 80, '10s') resets(saw[80s])",
    "TQL EVAL (80, 80, '10s') changes(saw[80s])",
    f"TQL EVAL (600, 600, '60s') quantile_over_time(0.5, {HTR}{{host=\"a\"}}[1m])",
    f"TQL EVAL (600, 600, '60s') stddev_over_time({HTR}{{host=\"a\"}}[1m])",
    f"TQL EVAL (600, 600, '60s') holt_winters({HTR}{{host=\"a\"}}[2m], 0.5, 0.5)",
    f"TQL EVAL (600, 600, '60s') present_over_time({HTR}{{host=\"a\"}}[1m])",
    f"TQL EVAL (600, 600, '60s') absent({HTR}{{host=\"zzz\"}})",
    f"TQL EVAL (600, 600, '60s') absent({HTR}{{host=\"a\"}})",
    f"TQL EVAL (600, 600, '60s') {HTR} / on(host) group_left limits",
    f"TQL EVAL (600, 600, '60s') {HTR} and on(host) {HTR}{{host=\"a\"}}",
    f"TQL EVAL (600, 600, '60s') {HTR} unless on(host) {HTR}{{host=\"a\"}}",
    f"TQL EVAL (600, 600, '60s') {HTR}{{host=\"a\"}} or {HTR}{{host=\"b\"}}",
    f"TQL EVAL (600, 600, '60s') label_replace({HTR}{{host=\"a\"}}, \"h2\", \"$1-x\", \"host\", \"(.*)\")",
    f"TQL EVAL (600, 600, '60s') label_join({HTR}{{host=\"a\"}}, \"hj\", \"-\", \"host\", \"job\")",
    "TQL EVAL (600, 600, '60s') time()",
    "TQL EVAL (600, 600, '60s') vector(7)",
    "TQL EVAL (600, 600, '60s') minute()",
    "TQL EVAL (600, 600, '60s') days_in_month()",
    f"TQL EVAL (600, 600, '60s') timestamp({HTR}{{host=\"a\"}})",
    f"TQL EVAL (500, 600, '50s') max_over_time({HTR}{{host=\"a\"}}[1m:10s] @ 300)",
    f"TQL EVAL (600, 600, '60s') time() - {HTR}{{host=\"a\"}}",
    f"TQL EVAL (600, 600, '60s') {HTR} > bool time()",
    "TQL EVAL (600, 600, '60s') timestamp(once)",
    "TQL EVAL (60, 900, '840s') last_over_time(s1[1m]) or last_over_time(s2[1m])",
    "TQL EVAL (60, 900, '840s') last_over_time(lft[1m]) and on(host) last_over_time(rgt[1m])",
    "TQL EVAL (60, 60, '1s') histogram_quantile(0.5, hist)",
    "TQL EVAL (60, 60, '1s') histogram_quantile(0.9, sum by (le) (hist))",
    f"TQL EVAL (300, 600, '60s') sum by (job) (rate({HTR}[5m]))",
    f"TQL EVAL (300, 600, '60s') count without (job) (avg_over_time({HTR}[2m]))",
]
# the counter with resets: rate over a window that holds one
PROMQL_ULP = {"TQL EVAL (600, 1200, '300s') rate(resets[5m])"}


@pytest.fixture(scope="module")
def promql_pair(tmp_path_factory):
    """Two port databases on the same writes — memtable data only, and
    flushed — beside one reference database."""
    pair = _Pair(tmp_path_factory, "promql")
    _promql_tables(pair)
    flushed = Database(str(tmp_path_factory.mktemp("promql_flushed")), device="cpu")
    _promql_tables(_Writer(flushed))
    flushed.flush()
    yield pair, flushed
    flushed.close()
    pair.close()


class _Writer:
    def __init__(self, db):
        self.sql = db.sql


def _port_run(db, q):
    eng = db.query_engine
    before = dict(eng.stats)
    got = db.sql_one(q)
    return got, {k: eng.stats[k] - before[k] for k in before}


@pytest.mark.parametrize("q", PROMQL_QUERIES)
def test_promql_queries_match_reference_legacy(promql_pair, q):
    pair, flushed = promql_pair
    got, want, delta = pair.run(q)
    rtol = 1e-12 if q in PROMQL_ULP else 0.0
    _assert_same(got, want, q, rtol=rtol)
    # memtable rows in every window: whatever the tile path saw, it declined
    assert delta["tql_tile_dispatches"] == 0, q
    got_f, _delta_f = _port_run(flushed, q)
    _assert_same(got_f, want, q, rtol=rtol)


def test_flushed_selectors_take_the_tile_path(promql_pair):
    pair, flushed = promql_pair
    q = f"TQL EVAL (300, 600, '60s') sum by (job) (rate({HTR}[5m]))"
    _got, _want, delta = pair.run(q)
    # the fused fold and then the per-series evaluation both decline
    assert delta["tql_tile_declined"] == 2 and delta["tql_legacy"] == 1
    _got, delta = _port_run(flushed, q)
    assert delta["tql_tile_dispatches"] == 1 and delta["tql_legacy"] == 0


# ---- EXACT_QUERIES / ULP_QUERIES of tests/test_tql_tile.py ---------------------------


def _load_counter(pair, rng, hosts=4, ticks=48, resets=True, nulls=False, table="tq",
                  partitions=None):
    part = f" PARTITION BY HASH (host) PARTITIONS {partitions}" if partitions else ""
    pair.sql(f"CREATE TABLE IF NOT EXISTS {table} (host STRING, greptime_value DOUBLE, "
             f"ts TIMESTAMP(3) TIME INDEX, PRIMARY KEY (host)){part}")
    rows = []
    for h in range(hosts):
        v = 0.0
        for t in range(ticks):
            v += rng.uniform(0, 5)
            if resets and rng.random() < 0.06:
                v = rng.uniform(0, 1)  # counter reset
            val = "NULL" if (nulls and rng.random() < 0.08) else f"{v:.6f}"
            rows.append(f"('h{h}', {val}, {t * 15000})")
    pair.sql(f"INSERT INTO {table} VALUES " + ",".join(rows))
    pair.flush()


EXACT_QUERIES = [
    "TQL EVAL (60, 540, '25s') avg_over_time(tq[2m])",
    "TQL EVAL (60, 540, '25s') sum_over_time(tq[90s])",
    "TQL EVAL (60, 540, '25s') min_over_time(tq[2m])",
    "TQL EVAL (60, 540, '25s') max_over_time(tq[2m])",
    "TQL EVAL (60, 540, '25s') count_over_time(tq[2m])",
    "TQL EVAL (60, 540, '25s') last_over_time(tq[2m])",
    "TQL EVAL (60, 540, '25s') delta(tq[2m])",
    "TQL EVAL (60, 540, '25s') tq",
    "TQL EVAL (60, 540, '25s') timestamp(tq)",
    "TQL EVAL (60, 540, '25s') tq{host='h1'}",
    "TQL EVAL (60, 540, '25s') tq{host!='h1'}",
    "TQL EVAL (60, 540, '25s') tq{host=~'h[12]'}",
    "TQL EVAL (60, 540, '25s') tq{host!~'h1'}",
    "TQL EVAL (60, 540, '25s') sum by (host) (avg_over_time(tq[2m]))",
    "TQL EVAL (60, 540, '25s') avg by (host) (delta(tq[2m]))",
    "TQL EVAL (60, 540, '25s') min by (host) (tq)",
    "TQL EVAL (60, 540, '25s') max(tq)",
    "TQL EVAL (60, 540, '25s') count(tq)",
    "TQL EVAL (60, 540, '25s') sum(sum_over_time(tq[2m]))",
    "TQL EVAL (60, 540, '25s') sum_over_time(tq[2m] offset 1m)",
    "TQL EVAL (60, 540, '25s') avg_over_time(tq[2m] @ 300)",
    "TQL EVAL (60, 540, '25s') last_over_time(tq[2m] @ end())",
]
ULP_QUERIES = [
    "TQL EVAL (60, 540, '25s') rate(tq[2m])",
    "TQL EVAL (60, 540, '25s') increase(tq[2m])",
    "TQL EVAL (60, 540, '25s') sum by (host) (rate(tq[2m]))",
]


@pytest.fixture(scope="module")
def tq_pair(tmp_path_factory):
    pair = _Pair(tmp_path_factory, "tq")
    _load_counter(pair, np.random.default_rng(11), nulls=True)
    yield pair
    pair.close()


@pytest.mark.parametrize("tile", [True, False], ids=["tile", "legacy"])
@pytest.mark.parametrize("q", EXACT_QUERIES + ULP_QUERIES)
def test_tql_tile_queries_match_reference_legacy(tq_pair, q, tile):
    got, want, delta = tq_pair.run(q, tile=tile)
    _assert_same(got, want, q, rtol=1e-12 if q in ULP_QUERIES else 0.0)
    if tile:
        assert delta["tql_tile_dispatches"] >= 1 and delta["tql_legacy"] == 0, q
    else:
        assert delta["tql_tile_dispatches"] == 0 and delta["tql_legacy"] >= 1, q


def test_rate_is_exact_on_series_without_resets(tq_pair):
    """The ulp tolerance above is only for series with a reset: one of three
    counters resets, the other two must come out exact."""
    tq_pair.sql("CREATE TABLE tr (host STRING, greptime_value DOUBLE, ts TIMESTAMP(3) TIME INDEX, "
                "PRIMARY KEY (host))")
    rng = np.random.default_rng(19)
    rows = []
    for h in range(3):
        v = 0.0
        for t in range(48):
            v += rng.uniform(0, 5)
            if h == 0 and t in (17, 33):
                v = rng.uniform(0, 1)
            rows.append(f"('h{h}', {v:.6f}, {t * 15000})")
    tq_pair.sql("INSERT INTO tr VALUES " + ",".join(rows))
    tq_pair.flush()
    for tile in (True, False):
        q = "TQL EVAL (60, 540, '25s') rate(tr[2m])"
        got, want, _d = tq_pair.run(q, tile=tile)
        _assert_same(got, want, q, rtol=1e-12)
        clean = [r for r in _rows(got) if r[0] != "h0"]
        assert len(clean) > 20
        assert clean == [r for r in _rows(want) if r[0] != "h0"]


# ---- declines, readback, failure ---------------------------------------------------


def test_max_cells_declines_to_legacy(tq_pair):
    q = "TQL EVAL (60, 540, '25s') avg_over_time(tq[2m])"
    cfg = tq_pair.port.config.tql
    cfg.max_cells = 8
    try:
        got, want, delta = tq_pair.run(q)
    finally:
        cfg.max_cells = 1 << 22
    assert delta["tql_tile_declined"] == 1 and delta["tql_legacy"] == 1
    _assert_same(got, want, q)


def test_compact_readback_matches_one_trip(tq_pair):
    q = "TQL EVAL (60, 540, '25s') last_over_time(tq{host!='h2'}[2m])"
    one, want, _d = tq_pair.run(q)
    cfg = tq_pair.port.config.tql
    cfg.compact_readback_kb = 0
    try:
        two, _w, delta = tq_pair.run(q)
    finally:
        cfg.compact_readback_kb = 1024
    assert delta["tql_tile_dispatches"] == 1
    _assert_same(two, one, q)
    _assert_same(two, want, q)


def test_kernel_failure_raises_instead_of_degrading(tq_pair, monkeypatch):
    def broken(*_a, **_k):
        raise RuntimeError("range_windows: CUDA launch failed")

    monkeypatch.setattr(tile_exec, "range_windows", broken)
    eng = tq_pair.port.query_engine
    before = dict(eng.stats)
    with pytest.raises(RuntimeError, match="launch failed"):
        tq_pair.port.sql_one("TQL EVAL (60, 540, '25s') avg_over_time(tq[2m])")
    assert eng.stats["tql_legacy"] == before["tql_legacy"]
    assert eng.stats["tql_tile_declined"] == before["tql_tile_declined"]


def test_tile_off_runs_the_legacy_kernels(tq_pair, monkeypatch):
    """`tql.tile = False`: the legacy route's one device call goes through
    the K9-K11 wrappers (the plain versions here, on the CPU)."""
    calls = []
    for name in ("strip_counter_resets", "range_windows", "range_finalize"):
        fn = getattr(R, name)
        monkeypatch.setattr(R, name, lambda *a, _fn=fn, _n=name, **k: calls.append(_n) or _fn(*a, **k))
    _got, _want, delta = tq_pair.run("TQL EVAL (60, 540, '25s') rate(tq[2m])", tile=False)
    assert delta["tql_legacy"] == 1 and delta["tql_tile_dispatches"] == 0
    assert calls == ["strip_counter_resets", "range_windows", "range_finalize"]
