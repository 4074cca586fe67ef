"""The port's two TQL routes against each other and against the reference
Database with `tql.tile = False` (its legacy path), on the same writes:

* a hash-partitioned table (several regions: per-region K9/K10, K11's
  selection merge);
* a non-append table whose flushes overlap (the dedup keep plane);
* the warm contract: a repeated warm query builds no planes and counts
  one tile dispatch;
* memtable rows in the fetch window routing to the legacy path, and back
  to the tile path after a flush;
* a dictionary growth that moves every code (the entry is extended in
  place and its codes repaired);
* a microsecond time index;
* rate() against an independent numpy twin (tests/test_tql_tile.py:174).

Tolerances as in tests/test_torch_promql.py: exact, except rate over
counters with resets and folds across regions (relative 1e-12), and the
numpy twin (relative 1e-9, its own arithmetic order)."""

import math

import numpy as np
import pyarrow as pa
import pytest
import torch

from test_torch_promql import _assert_same, _load_counter, _Pair, _rows


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_tile_matches_numpy_twin(tmp_path_factory):
    """rate() on the tile route against an independent numpy form of
    Prometheus' extrapolatedRate (resets stripped with a sequential sum),
    after tests/test_tql_tile.py:174."""
    pair = _Pair(tmp_path_factory, "twin")
    try:
        _load_counter(pair, np.random.default_rng(23), hosts=3, ticks=40)
        start, end, step, rng_ms = 60_000, 540_000, 30_000, 120_000
        got, _want, delta = pair.run("TQL EVAL (60, 540, '30s') rate(tq[2m])")
        assert delta["tql_tile_dispatches"] == 1
        raw = pair.port.sql_one("SELECT host, ts, greptime_value AS v FROM tq ORDER BY host, ts")
        twin = numpy_rate_twin(raw["host"].to_pylist(),
                               np.asarray(raw["ts"].cast(pa.int64()).to_pylist(), np.int64),
                               np.asarray(raw["v"].to_pylist(), np.float64),
                               start, end, step, rng_ms)
        have = {(h, int(t)): v for h, t, v in zip(
            got["host"].to_pylist(), got["ts"].cast(pa.int64()).to_pylist(),
            got["value"].to_pylist())}
        assert set(have) == set(twin)
        for k, v in twin.items():
            assert math.isclose(have[k], v, rel_tol=1e-9), k
    finally:
        pair.close()


def numpy_rate_twin(hosts, ts, vals, start, end, step, rng_ms):
    """Prometheus rate() per (host, step) from raw samples."""
    twin = {}
    steps = np.arange(start, end + 1, step, dtype=np.int64)
    hosts_arr = np.asarray(hosts)
    for h in sorted(set(hosts)):
        sel = hosts_arr == h
        hts, hv = ts[sel], vals[sel]
        keep = (hts >= start - rng_ms) & (hts <= end)
        hts, hv = hts[keep], hv[keep]
        adj = hv.copy()
        acc = 0.0
        for i in range(1, len(adj)):
            if hv[i] < hv[i - 1]:
                acc += hv[i - 1]
            adj[i] = hv[i] + acc
        for t1 in steps:
            wmask = (hts > t1 - rng_ms) & (hts <= t1)
            if wmask.sum() < 2:
                continue
            wts, wv = hts[wmask], adj[wmask]
            si = float(wts[-1] - wts[0])
            avg = si / (len(wts) - 1)
            d_start, d_end = float(wts[0] - (t1 - rng_ms)), float(t1 - wts[-1])
            ext_s = d_start if d_start < avg * 1.1 else avg / 2.0
            ext_e = d_end if d_end < avg * 1.1 else avg / 2.0
            result = wv[-1] - wv[0]
            if result > 0 and wv[0] >= 0:
                zero_dur = si * (wv[0] / result)
                if 0 <= zero_dur < ext_s:
                    ext_s = zero_dur
            twin[(h, int(t1))] = result * ((si + ext_s + ext_e) / si) / (rng_ms / 1000.0)
    return twin


# ---- the tile route against the legacy route --------------------------------------

ROUTE_QUERIES = [
    "TQL EVAL (60, 420, '30s') rate(mq[2m])",
    "TQL EVAL (60, 420, '30s') sum by (host) (rate(mq[2m]))",
    "TQL EVAL (60, 420, '30s') max(avg_over_time(mq[2m]))",
    "TQL EVAL (60, 420, '30s') sum(sum_over_time(mq[2m]))",
    "TQL EVAL (60, 420, '30s') count_over_time(mq{host=~'h[1-4]'}[1m])",
    "TQL EVAL (60, 420, '30s') mq",
]


@pytest.fixture(scope="module")
def partitioned_pair(tmp_path_factory):
    pair = _Pair(tmp_path_factory, "mq")
    _load_counter(pair, np.random.default_rng(29), hosts=6, ticks=30, table="mq", partitions=3)
    yield pair
    pair.close()


@pytest.mark.parametrize("q", ROUTE_QUERIES)
def test_partitioned_tile_route_matches_legacy(partitioned_pair, q):
    """Several regions: per-region K9/K10, K11's selection merge; against
    the port's legacy route and the reference (order-insensitive; folds
    across regions within rel 1e-12)."""
    port = partitioned_pair.port
    regions = port.catalog.table("mq", "public").region_ids
    assert len(regions) == 3
    tile, want, delta = partitioned_pair.run(q)
    assert delta["tql_tile_dispatches"] >= 1 and delta["tql_legacy"] == 0
    legacy, _w, _d = partitioned_pair.run(q, tile=False)
    _assert_same(tile, legacy, q, rtol=1e-12, ordered=False)
    _assert_same(legacy, want, q, rtol=1e-12 if "rate" in q else 0.0)


def test_overlapping_flushes_use_the_dedup_keep_plane(tmp_path_factory):
    """A non-append table whose second flush re-sends samples of the first
    (a remote-write retry, one with a new value): the tile route serves it
    through the last-write-wins keep plane and equals the legacy route and
    the reference."""
    pair = _Pair(tmp_path_factory, "dedup")
    try:
        pair.sql("CREATE TABLE dq (host STRING, greptime_value DOUBLE, ts TIMESTAMP(3) TIME INDEX, "
                 "PRIMARY KEY (host))")
        rng = np.random.default_rng(37)
        first = [(h, t, float(rng.uniform(0, 9))) for h in range(3) for t in range(0, 30)]
        pair.sql("INSERT INTO dq VALUES " + ",".join(
            f"('h{h}', {v:.6f}, {t * 15000})" for h, t, v in first))
        pair.flush()
        retry = [(h, t, v + (1.0 if t % 5 == 0 else 0.0)) for h, t, v in first if t >= 20]
        retry += [(h, t, float(rng.uniform(0, 9))) for h in range(3) for t in range(30, 40)]
        pair.sql("INSERT INTO dq VALUES " + ",".join(
            f"('h{h}', {v:.6f}, {t * 15000})" for h, t, v in retry))
        pair.flush()
        for q in ("TQL EVAL (60, 570, '30s') sum_over_time(dq[1m])",
                  "TQL EVAL (60, 570, '30s') dq",
                  "TQL EVAL (60, 570, '30s') count(count_over_time(dq[2m]))"):
            tile, want, delta = pair.run(q)
            assert delta["tql_tile_dispatches"] == 1, q
            legacy, _w, _d = pair.run(q, tile=False)
            _assert_same(tile, legacy, q)
            _assert_same(tile, want, q)
        entry = next(iter(pair.port.query_engine.tile_cache._super.values()))
        assert entry.valid_dedup is not None
        assert len(entry.file_ids) == 2
    finally:
        pair.close()


# ---- warm contract, routing, churn -----------------------------------------------------


def test_warm_query_builds_nothing_and_dispatches_once(tmp_path_factory):
    pair = _Pair(tmp_path_factory, "warm")
    try:
        _load_counter(pair, np.random.default_rng(3))
        q = "TQL EVAL (60, 540, '30s') rate(tq[2m])"
        pair.port.sql_one(q)  # cold: builds the planes
        cache = pair.port.query_engine.tile_cache
        entry = next(iter(cache._super.values()))
        ids = {name: [id(c) for c in chunks] for name, chunks in entry.cols.items()}
        for _ in range(3):
            builds = cache.stats_counts["builds"]
            got, want, delta = pair.run(q)
            assert cache.stats_counts["builds"] == builds, "a warm query rebuilt planes"
            assert delta["tql_tile_dispatches"] == 1 and delta["tql_legacy"] == 0
            assert delta["tql_tile_declined"] == 0
            _assert_same(got, want, q, rtol=1e-12)
        entry2 = next(iter(cache._super.values()))
        assert {name: [id(c) for c in chunks] for name, chunks in entry2.cols.items()} == ids
        timings = pair.port.query_engine.last_tql_timings
        assert {"plan", "dispatch", "readback", "assemble"} <= set(timings)
        assert "build" not in timings
    finally:
        pair.close()


def test_memtable_rows_route_to_legacy(tmp_path_factory):
    pair = _Pair(tmp_path_factory, "memrows")
    try:
        _load_counter(pair, np.random.default_rng(13), hosts=2, ticks=30)
        q = "TQL EVAL (60, 540, '30s') sum_over_time(tq[2m])"
        pair.run(q)
        pair.sql("INSERT INTO tq VALUES ('h0', 123.5, 301000)")
        got, want, delta = pair.run(q)
        assert delta["tql_tile_dispatches"] == 0
        assert delta["tql_tile_declined"] == 1 and delta["tql_legacy"] == 1
        _assert_same(got, want, q)
        pair.flush()
        got, want, delta = pair.run(q)
        assert delta["tql_tile_dispatches"] == 1 and delta["tql_legacy"] == 0
        _assert_same(got, want, q)
    finally:
        pair.close()


def test_label_churn_rebuilds_the_planes(tmp_path_factory):
    """A new host that sorts before the others moves every code: the flush
    extends the cached entry in place (the delta merge) and `repair_super`
    remaps the resident host codes (K15's remap mode) instead of a
    rebuild, and the warm result equals the reference."""
    pair = _Pair(tmp_path_factory, "churn")
    try:
        rng = np.random.default_rng(17)
        _load_counter(pair, rng, hosts=3, ticks=24)
        q = "TQL EVAL (60, 540, '30s') sum by (host) (avg_over_time(tq[2m]))"
        pair.run(q)
        cache = pair.port.query_engine.tile_cache
        (entry,) = cache._super.values()
        before = entry.cols["host"][0][: entry.num_rows].clone()
        builds = cache.stats_counts["builds"]
        pair.sql("INSERT INTO tq VALUES " + ",".join(
            f"('aa', {rng.uniform(0, 9):.4f}, {t * 15000})" for t in range(24)))
        pair.flush()
        got, want, delta = pair.run(q)
        assert delta["tql_tile_dispatches"] == 1
        _assert_same(got, want, q)
        assert {r[0] for r in _rows(got)} == {"aa", "h0", "h1", "h2"}
        (after,) = cache._super.values()
        assert after is entry and entry.delta_extends == 1
        assert cache.stats_counts["builds"] == builds
        # every old row's code moved up by one ("aa" took code 0), and the
        # new rows hold code 0
        codes = entry.cols["host"][0][: entry.num_rows]
        assert int((codes == 0).sum()) == 24
        assert sorted((codes[codes > 0] - 1).tolist()) == sorted(before.tolist())
    finally:
        pair.close()


def test_microsecond_time_index(tmp_path_factory):
    """A TIMESTAMP(6) table: fetch bounds and the ms conversion in the
    column's unit, on both routes."""
    pair = _Pair(tmp_path_factory, "us")
    try:
        pair.sql("CREATE TABLE uq (host STRING, greptime_value DOUBLE, ts TIMESTAMP(6) TIME INDEX, "
                 "PRIMARY KEY (host))")
        rng = np.random.default_rng(41)
        pair.sql("INSERT INTO uq VALUES " + ",".join(
            f"('h{h}', {rng.uniform(0, 9):.5f}, {t * 15_000_000 + int(rng.integers(0, 999))})"
            for h in range(3) for t in range(40)))
        pair.flush()
        for q in ("TQL EVAL (60, 540, '25s') avg_over_time(uq[2m])",
                  "TQL EVAL (60, 540, '25s') timestamp(uq)"):
            for tile in (True, False):
                got, want, delta = pair.run(q, tile=tile)
                assert delta["tql_tile_dispatches"] == (1 if tile else 0)
                _assert_same(got, want, q)
    finally:
        pair.close()
