"""Plane maintenance under live writes: a randomized write / flush /
new-tag-value sequence (after the reference's
tests/test_tile_incremental.py:78) through the port's Database and the
reference's, both with incremental planes on (their default).

After every flush the next query must extend the port's cached entry in
place (K16 patches, K15 remaps of moved codes; their plain versions
here), and then the entry's planes, `order` and sorted host copies must
equal a from-scratch rebuild of the same files byte for byte
(`chip_smoke.check_against_rebuild`), and, over real rows, the
reference's delta-extended entry.  `tile.incremental = False` restores
the rebuild path with the same answers, and a file set that is not an
append of the cached one rebuilds.

Tolerances: planes exact; query results as in tests/test_torch_tile.py
(keys, counts, max exact; sum/avg within rel 1e-12)."""

import numpy as np
import pyarrow as pa
import pytest
import torch

import chip_smoke
from greptimedb_tpu.utils import metrics
from greptimedb_tpu.utils.config import Config as JaxConfig
from greptimedb_tpu.database import Database as JaxDatabase
from greptimedb_tpu_torch.query import passes
from test_torch_tile import UNPORTED_PASSES, _assert_same, _port_db, _run_pair

DDL = ("CREATE TABLE t (host STRING, region STRING, ts TIMESTAMP(3) TIME INDEX, v DOUBLE,"
       " w DOUBLE, PRIMARY KEY (host, region)) WITH (append_mode = 'true')")
Q = ("SELECT host, region, time_bucket('60s', ts) AS tb, avg(v) AS av, max(v) AS mv,"
     " sum(v) AS sv, count(*) AS c, count(w) AS cw, avg(w) AS aw FROM t GROUP BY host, region, tb")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_db(home: str, incremental: bool) -> JaxDatabase:
    cfg = JaxConfig()
    cfg.query.disabled_passes = UNPORTED_PASSES
    cfg.query.agg_strategy = "sort"
    cfg.query.tile_persist_enable = False
    cfg.query.fallback_to_cpu = False
    cfg.storage.compaction_background_enable = False
    cfg.tile.incremental = incremental
    return JaxDatabase(config=cfg, data_home=home)


def _batch(rng, step: int, n: int = 400) -> pa.Table:
    """Rows of a 10-minute window with ts ties, hosts old and new (the new
    names sort before and among the old ones, so codes move), NULL regions
    from the second flush on and NULL values in w from the third (the
    plane's first nulls arrive in a delta)."""
    hosts = [f"h{i}" for i in range(4)] + [f"a{step}", f"h{step}x"][: min(step, 2)]
    regions = ["r0", "r1"] + ([None] if step >= 1 else [])
    w = rng.uniform(0, 100, n)
    w_null = (rng.random(n) < 0.2) if step >= 2 else np.zeros(n, bool)
    return pa.table({
        "host": pa.array(rng.choice(hosts, n)),
        "region": pa.array(rng.choice(np.array(regions, dtype=object), n)),
        "ts": pa.array(rng.integers(0, 600, n) * 1000, pa.timestamp("ms")),
        "v": pa.array(rng.uniform(0, 100, n)),
        "w": pa.array(np.where(w_null, np.nan, w), pa.float64(), mask=w_null),
    })


def _entry(db):
    (entry,) = db.query_engine.tile_cache._super.values()
    return entry


def _host(planes, n):
    return torch.cat(planes).numpy()[:n]


def _assert_matches_reference(pe, re):
    """The port's entry against the reference's over real rows."""
    n = pe.num_rows
    assert re.num_rows == n and len(pe.file_ids) == len(re.file_ids)
    np.testing.assert_array_equal(pe.order, np.asarray(re.order))
    assert set(pe.sorted_host) == set(re.sorted_host)
    for name, arr in pe.sorted_host.items():
        np.testing.assert_array_equal(arr, np.asarray(re.sorted_host[name]), err_msg=name)
    shared = set(pe.cols) & set(re.cols)
    assert {"host", "region", "ts"} <= shared
    for name in shared:
        np.testing.assert_array_equal(
            _host(pe.cols[name], n), np.concatenate([np.asarray(c) for c in re.cols[name]])[:n],
            err_msg=name)
    for name in set(pe.nulls) & set(re.nulls):
        np.testing.assert_array_equal(
            _host(pe.nulls[name], n),
            np.concatenate([np.asarray(c) for c in re.nulls[name]])[:n], err_msg=name)
    assert _host(pe.valid, n).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_delta_extended_planes_equal_rebuild_and_reference(tmp_path, seed):
    rng = np.random.default_rng(seed)
    ref = _jax_db(str(tmp_path / "jax"), incremental=True)
    port = _port_db(str(tmp_path / "port"))
    try:
        for db in (port, ref):
            db.sql(DDL)
        cache = port.query_engine.tile_cache
        first = None
        merges0 = metrics.TILE_DELTA_MERGES.get()
        for step in range(4):
            batch = _batch(rng, step)
            port.write("t", batch)
            ref.insert_rows("t", batch)
            port.flush()
            ref.storage.flush_all()
            builds0 = cache.stats()["builds"] if cache is not None else 0
            got, want = _run_pair(port, ref, Q)
            _assert_same(got, want, Q, ordered=False)
            cache = port.query_engine.tile_cache
            entry = _entry(port)
            if first is None:
                first = entry
            else:
                # the flush took the delta route: the same entry, extended
                assert entry is first and entry.delta_extends == step
                assert cache.stats()["builds"] == builds0
                assert cache.stats()["delta_extends"] == step
            _assert_matches_reference(entry, _entry(ref))
            chip_smoke.check_against_rebuild(port, "public.t", ["host", "region"], "ts", False)
        assert metrics.TILE_DELTA_MERGES.get() - merges0 == 3
    finally:
        port.close()
        ref.close()


def test_incremental_off_restores_the_rebuild_path(tmp_path):
    batches = [_batch(np.random.default_rng(7), step) for step in range(3)]
    results = {}
    for incremental in (True, False):
        port = _port_db(str(tmp_path / f"port_{incremental}"))
        port.config.tile.incremental = incremental
        try:
            port.sql(DDL)
            entries = []
            for b in batches:
                port.write("t", b)
                port.flush()
                trace = passes.PassTrace()
                with passes.use_trace(trace):
                    results.setdefault(incremental, []).append(port.sql_one(Q))
                entries.append(_entry(port))
                notes = [d for d in trace.decisions if d.name == "incremental_tile"]
                if len(entries) > 1:
                    assert [d.fired for d in notes] == [incremental]
                    if not incremental:
                        assert notes[0].why == "tile.incremental off: full rebuild"
            if incremental:
                assert all(e is entries[0] for e in entries)
                assert entries[0].delta_extends == 2
            else:
                assert len({id(e) for e in entries}) == 3
                assert all(e.delta_extends == 0 for e in entries)
        finally:
            port.close()
    for on, off in zip(results[True], results[False]):
        assert on.sort_by([("host", "ascending"), ("region", "ascending"), ("tb", "ascending")]) \
            .equals(off.sort_by([("host", "ascending"), ("region", "ascending"),
                                 ("tb", "ascending")]))


def test_a_file_set_that_is_not_an_append_rebuilds(tmp_path):
    port = _port_db(str(tmp_path / "port"))
    try:
        port.sql(DDL)
        rng = np.random.default_rng(5)
        for step in range(2):
            port.write("t", _batch(rng, step))
            port.flush()
        port.sql_one(Q)
        cache = port.query_engine.tile_cache
        old = _entry(port)
        (region,) = [port.storage.region(rid) for rid in port.storage.region_ids()]
        metas = region.files()
        trace = passes.PassTrace()
        with passes.use_trace(trace):
            entry, excluded = cache.super_tiles(
                region, port.dicts.get("public.t"), metas[1:], ["host", "region"], "ts",
                ["v"], {region.region_id}, ["host", "region"])
        assert not excluded and entry is not old and entry.delta_extends == 0
        assert entry.file_ids == (metas[1].file_id,)
        assert [(d.fired, d.why) for d in trace.decisions if d.name == "incremental_tile"] == [
            (False, "file set not an append of the cached one (removal): full rebuild")]
    finally:
        port.close()
