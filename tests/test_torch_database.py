"""The slice as a whole: the 15 TSBS cpu-only queries through the port's
Database.sql (device path on device="cpu") against the reference
Database (tile cache off: the table-fed device path), on the same seeded
data written through each package.  The port also reopens a data home
the reference wrote, and recovers an unflushed write from its own WAL.

Tolerances: keys, counts, min, max and last_value exact; avg within rel
1e-12 (chip_smoke.compare_tables)."""

import pyarrow as pa
import pytest
import torch

import chip_smoke
from greptimedb_tpu.database import Database as JaxDatabase
from greptimedb_tpu.parallel.mesh import make_mesh
from greptimedb_tpu.utils.config import Config as JaxConfig
from greptimedb_tpu_torch import Database

HOSTS, HOURS = 32, 2
TSBS = chip_smoke.Tsbs(HOSTS, HOURS)
NAMES = [name for name, _sql in TSBS.queries()]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test workers on one machine: keep torch's CPU
    ops on one thread so they do not starve timing-sensitive tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


@pytest.fixture(scope="module")
def homes(tmp_path_factory):
    """(reference answers, reference data home, port db on its own home)."""
    jax_home = str(tmp_path_factory.mktemp("jax_home"))
    cfg = JaxConfig()
    cfg.query.tile_cache_enable = False
    cfg.query.fallback_to_cpu = False
    jdb = JaxDatabase(config=cfg, data_home=jax_home)
    # one device, as the port runs: the reference's table-fed path pads
    # empty mesh shards to a different shape than full ones
    jdb.query_engine._mesh = make_mesh(1)
    try:
        rows, _gt = chip_smoke.ingest(_JaxWriter(jdb), TSBS)
        assert rows == HOSTS * HOURS * 360
        ref = {name: jdb.sql_one(sql) for name, sql in TSBS.queries()}
    finally:
        jdb.close()
    port = Database(str(tmp_path_factory.mktemp("port_home")), device="cpu")
    _rows, gt = chip_smoke.ingest(port, TSBS)
    yield ref, jax_home, port, gt
    port.close()


@pytest.mark.parametrize("name", NAMES)
def test_query_matches_reference(homes, name):
    ref, _home, port, gt = homes
    sql = dict(TSBS.queries())[name]
    before = port.query_engine.stats["lowered"]
    got = port.sql_one(sql)
    assert port.query_engine.stats["lowered"] == before + 1, "query did not take the device path"
    assert got.num_rows > 0
    chip_smoke.compare_tables(got, ref[name], name + " " + sql)
    if name == "double-groupby-1":
        chip_smoke.check_ground_truth(got, gt, TSBS)


@pytest.fixture(scope="module")
def reopened(homes):
    _ref, jax_home, _port, _gt = homes
    db = Database(jax_home, device="cpu")
    yield db
    db.close()


@pytest.mark.parametrize("name", NAMES)
def test_port_reopens_reference_data_home(homes, reopened, name):
    ref = homes[0]
    sql = dict(TSBS.queries())[name]
    before = reopened.query_engine.stats["lowered"]
    got = reopened.sql_one(sql)
    assert reopened.query_engine.stats["lowered"] == before + 1
    chip_smoke.compare_tables(got, ref[name], name + " " + sql)


def test_port_recovers_unflushed_write_from_wal(tmp_path):
    home = str(tmp_path / "db")
    db = Database(home, device="cpu")
    db.sql("CREATE TABLE cpu (hostname STRING, usage_user DOUBLE, ts TIMESTAMP(3) TIME INDEX, "
           "PRIMARY KEY (hostname))")
    db.write("cpu", pa.table({"hostname": ["a", "b"], "usage_user": [1.0, 2.0],
                              "ts": pa.array([1000, 1000], pa.timestamp("ms"))}))
    db.flush()
    assert db.sql_one("INSERT INTO cpu (hostname, usage_user, ts) VALUES ('a', 5.0, 2000), "
                      "('c', 7.0, 2000)") == 2
    db.close()  # the INSERT is only in the WAL and the memtable
    db = Database(home, device="cpu")
    out = db.sql_one("SELECT hostname, count(*) AS n, max(usage_user) AS m, "
                     "last_value(usage_user) AS l FROM cpu GROUP BY hostname")
    assert db.query_engine.stats["lowered"] == 1
    rows = sorted(out.to_pylist(), key=lambda r: r["hostname"])
    assert rows == [
        {"hostname": "a", "n": 2, "m": 5.0, "l": 5.0},
        {"hostname": "b", "n": 1, "m": 2.0, "l": 2.0},
        {"hostname": "c", "n": 1, "m": 7.0, "l": 7.0},
    ]
    db.close()


def test_cpu_backend_and_declined_plans_are_counted(tmp_path):
    db = Database(str(tmp_path / "db"), device="cpu")
    db.sql("CREATE TABLE m (k STRING, v DOUBLE, ts TIMESTAMP TIME INDEX, PRIMARY KEY (k))")
    db.sql("INSERT INTO m (k, v, ts) VALUES ('x', 1.5, 1), ('y', 2.5, 2), ('x', 3.5, 3)")
    # arithmetic over an aggregate is not lowerable: the CPU executor runs it
    out = db.sql_one("SELECT k, max(v) * 2 AS d FROM m GROUP BY k ORDER BY k")
    assert out.to_pylist() == [{"k": "x", "d": 7.0}, {"k": "y", "d": 5.0}]
    assert db.query_engine.stats == {"lowered": 0, "declined": 1}
    db.config.query.backend = "cpu"
    assert db.sql_one("SELECT count(*) AS n FROM m").to_pylist() == [{"n": 3}]
    assert db.query_engine.stats["lowered"] == 0
    db.close()


def test_device_failure_raises_unless_fallback_is_on(tmp_path, monkeypatch):
    """A failing device path raises, every time: the port has no
    fallback_to_cpu, so no lowered query is served from the CPU executor."""
    from greptimedb_tpu_torch.query import device_exec
    from greptimedb_tpu_torch.utils.config import QueryConfig

    assert not hasattr(QueryConfig(), "fallback_to_cpu")
    db = Database(str(tmp_path / "db"), device="cpu")
    db.sql("CREATE TABLE m (k STRING, v DOUBLE, ts TIMESTAMP TIME INDEX, PRIMARY KEY (k))")
    db.sql("INSERT INTO m (k, v, ts) VALUES ('x', 1.5, 1), ('y', 2.5, 2)")

    def broken(self, *_a, **_k):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(device_exec.DeviceExecutor, "execute", broken)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            db.sql_one("SELECT k, max(v) AS m FROM m GROUP BY k")
    assert db.query_engine.stats == {"lowered": 0, "declined": 0}
    db.close()
