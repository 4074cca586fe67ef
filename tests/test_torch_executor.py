"""The port's group-by executor (distributed_groupby on device="cpu")
against the reference's on a 1-device mesh, on seeded TSBS-shaped region
tables with filters, NULLs and last_value.

Tolerances: keys, counts, min, max and last_value exact; sum and avg
within rel 1e-12."""

import numpy as np
import pyarrow as pa
import pytest
import torch

from greptimedb_tpu.parallel.executor import distributed_groupby as jax_groupby
from greptimedb_tpu.parallel.mesh import make_mesh
from greptimedb_tpu_torch.parallel.executor import distributed_groupby as port_groupby

T0 = 1_767_225_600_000
H = 3_600_000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test workers on one machine: keep torch's CPU
    ops on one thread so they do not starve timing-sensitive tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _regions(seed, n_hosts, hours, nulls):
    """Two region tables of a cpu-like table, each sorted by (host, ts)."""
    rng = np.random.default_rng(seed)
    out = []
    for r in range(2):
        hosts = [f"host_{i}" for i in range(r, n_hosts, 2)]
        ticks = hours * 360
        hs = np.repeat(hosts, ticks)
        ts = np.tile(T0 + np.arange(ticks, dtype=np.int64) * 10_000, len(hosts))
        # duplicate timestamps: last_value ties go to the later row
        ts[5::97] = ts[4::97][: len(ts[5::97])]
        cols = {"hostname": pa.array(hs), "ts": pa.array(ts, pa.timestamp("ms"))}
        for m in ("usage_user", "usage_system", "usage_idle"):
            v = rng.uniform(0, 100, len(ts))
            mask = (rng.random(len(ts)) < 0.1) if nulls else np.zeros(len(ts), bool)
            cols[m] = pa.array(v, mask=mask)
        out.append(pa.table(cols))
    return out


def _compare(port, ref):
    pt, rt = port.to_table(), ref.to_table()
    assert pt.column_names == rt.column_names
    assert pt.num_rows == rt.num_rows > 0
    for c in rt.column_names:
        a, b = pt[c].to_pylist(), rt[c].to_pylist()
        if c.startswith(("sum(", "avg(")):
            x = np.array([np.nan if v is None else v for v in a])
            y = np.array([np.nan if v is None else v for v in b])
            np.testing.assert_allclose(x, y, rtol=1e-12, atol=0, err_msg=c)
        else:
            assert a == b, c


QUERIES = {
    "double-groupby": dict(
        group_tags=["hostname"], bucket=(H, 3),
        agg_specs=[("avg", "usage_user"), ("avg", "usage_system")],
        filters=[("ts", ">=", T0), ("ts", "<", T0 + 3 * H)],
    ),
    "cpu-max-8": dict(
        group_tags=[], bucket=(H, 3),
        agg_specs=[("max", "usage_user"), ("min", "usage_idle"), ("sum", "usage_system")],
        filters=[("hostname", "in", ("host_1", "host_4", "host_9", "missing"))],
    ),
    "lastpoint": dict(
        group_tags=["hostname"], bucket=None,
        agg_specs=[("last_value", "usage_user"), ("count", "usage_user")],
        filters=[],
    ),
    "high-cpu": dict(
        group_tags=[], bucket=None,
        agg_specs=[("count", None), ("max", "usage_user")],
        filters=[("usage_user", ">", 90.0), ("hostname", "!=", "host_3")],
    ),
    "minute-buckets": dict(
        group_tags=[], bucket=(60_000, 180),
        agg_specs=[("max", "usage_user"), ("count", None)],
        filters=[("ts", "<", T0 + 3 * H - 1_800_000)],
    ),
}


@pytest.mark.parametrize("nulls", [False, True], ids=["dense", "nulls"])
@pytest.mark.parametrize("name", sorted(QUERIES))
def test_groupby_matches_reference(name, nulls):
    q = QUERIES[name]
    # 80 hosts: 86 400 rows, past 2^16 (the blocked kernel's branch);
    # 40 hosts: 43 200 rows (the scatter branch)
    regions = _regions(len(name), n_hosts=40 if nulls else 80, hours=3, nulls=nulls)
    if q["bucket"] is not None:
        interval, n_buckets = q["bucket"]
        bucket = dict(bucket_col="ts", bucket_origin=T0, bucket_interval=interval, n_buckets=n_buckets)
    else:
        bucket = dict(bucket_col=None, bucket_origin=0, bucket_interval=1, n_buckets=1)
    needs_ts = any(f == "last_value" for f, _ in q["agg_specs"])
    common = dict(group_tags=q["group_tags"], agg_specs=q["agg_specs"], filters=q["filters"],
                  ts_col="ts" if needs_ts else None, **bucket)
    # the table-fed path scans with the filters already applied on the
    # host (storage residual); the device mask applies them again
    ref = jax_groupby(make_mesh(1), regions, acc_dtype="float64", **common)
    port = port_groupby(regions, device="cpu", **common)
    _compare(port, ref)
