"""Time-major plans: the nine bucket-only TSBS queries and a bucket-only
avg/sum (limb planes quantized over the time-major copies) through the
port's Database and the reference's, both with the time_major pass on
(their default), at 40 hosts x 12 h with 3 metrics.

Each port plan must be time-major (`plan.time_major`), its planes the
ts-ascending copies (K14's permutation, K15's gathers: their plain
versions here), the reference's must have built its own copies, and the
port's permutation over real rows must equal the reference's
`ensure_perm`.  Tolerances as in tests/test_torch_tile.py: keys, counts,
max exact; sum/avg within rel 1e-12."""

import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_tile import TSBS, _jax_db, _JaxWriter, _port_db, _run_pair

LO, HI = TSBS.w12
BUCKET_AVG = (f"SELECT time_bucket('1h', ts) AS tb, avg(usage_user) AS avg_usage_user, "
              f"sum(usage_system) AS sum_usage_system FROM cpu WHERE ts >= {LO} AND ts < {HI} "
              f"GROUP BY tb")
QUERIES = {name: sql for name, sql in TSBS.queries() if name in chip_smoke.TIME_MAJOR}
QUERIES["bucket-avg-sum"] = BUCKET_AVG


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tsbs_pair(tmp_path_factory):
    ref = _jax_db(str(tmp_path_factory.mktemp("tm_jax")))
    port = _port_db(str(tmp_path_factory.mktemp("tm_port")))
    try:
        chip_smoke.ingest(_JaxWriter(ref), TSBS)
        chip_smoke.ingest(port, TSBS)
        yield port, ref
    finally:
        port.close()
        ref.close()


def test_nine_tsbs_queries_are_bucket_only():
    assert len(chip_smoke.TIME_MAJOR) == 9
    assert set(chip_smoke.TIME_MAJOR) <= {name for name, _sql in TSBS.queries()}


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_bucket_only_query_runs_time_major(tsbs_pair, monkeypatch, name):
    from greptimedb_tpu_torch.parallel import tile_planner

    port, ref = tsbs_pair
    sql = QUERIES[name]
    plans = []
    real = tile_planner.build_plan

    def spy(*args, **kwargs):
        plans.append(real(*args, **kwargs))
        return plans[-1]

    monkeypatch.setattr("greptimedb_tpu_torch.parallel.tile_executor.build_plan", spy)
    got, want = _run_pair(port, ref, sql)
    assert plans and plans[-1] is not None and plans[-1][0].time_major
    chip_smoke.compare_tables(got, want, name + " " + sql)
    (pe,) = port.query_engine.tile_cache._super.values()
    (re,) = ref.query_engine.tile_cache._super.values()
    assert pe.perm is not None and pe.tm_valid is not None and "ts" in pe.tm_cols
    assert re.tm_cols, "the reference did not take its time-major plan"
    n = pe.num_rows
    want_perm = np.asarray(ref.query_engine.tile_cache.ensure_perm(re, "ts"))[:n]
    np.testing.assert_array_equal(pe.perm.numpy()[:n], want_perm)
    if name == "bucket-avg-sum":
        assert {"tm:usage_user", "tm:usage_system"} <= set(pe.limb_cols)
    # warm: the cached copies answer again, unchanged
    assert port.sql_one(sql).equals(got)
