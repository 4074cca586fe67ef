"""Vector search in the port against the JAX package, on the CPU.

K19's plain form (`ops/vector.py::topk_distances` on CPU tensors) against
the reference's jitted `topk_distances`; `topk_host` on both sides of its
100,000-row threshold; the puffin container and the IVF blob byte for
byte; and the `ORDER BY vec_*_distance(col, literal) LIMIT k` route
through both Databases: the scenarios of tests/test_vector.py, the IVF
route on a flushed append-mode table, and tables of 100,000+ rows in the
default and the append mode with rows in an SST, a frozen memtable and
the live memtable.

Tolerances.  Integer-valued data whose sums stay below 2^24 makes every
f32 sum exact in any order, so distances are held bit for bit, with
their indices.  Real data (d = 8) is held within rel 1e-6: the two sides
add eight f32 products in different orders, each sum within 8 * 2^-24
(4.8e-7) of the terms' magnitude; the data keeps the distances clear of
cancellation, and its distinct distances further apart than 1e-6, so the
indices are held exactly.  Rank ties go to the lower index in both
packages, so exact duplicates rank alike."""

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

import chip_smoke
from greptimedb_tpu.database import Database as JaxDatabase
from greptimedb_tpu.ops import vector as jvec
from greptimedb_tpu.storage import index as jindex
from greptimedb_tpu.storage import puffin as jpuffin
from greptimedb_tpu.storage.sst import INDEX_VECTOR_APPLIED as JAX_APPLIED
from greptimedb_tpu_torch import Database
from greptimedb_tpu_torch.ops import vector as pvec
from greptimedb_tpu_torch.storage import index as pindex
from greptimedb_tpu_torch.storage import puffin as ppuffin
from greptimedb_tpu_torch.storage.sst import INDEX_VECTOR_APPLIED

METRICS = ("dot", "l2sq", "cos")
NAN = np.float32(np.nan)
NEG_NAN = -np.float32(np.nan)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test workers on one machine: keep torch's CPU
    ops on one thread so they do not starve timing-sensitive tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_topk(mat, valid, q, metric, k, asc):
    d, i = jvec.topk_distances(mat, valid, q, metric=metric, k=k, ascending=asc)
    return np.asarray(d), np.asarray(i).astype(np.int64)


def _port_topk(mat, valid, q, metric, k, asc):
    d, i = pvec.topk_distances(torch.from_numpy(mat), torch.from_numpy(valid),
                               torch.from_numpy(q), metric, k, asc)
    return d.numpy(), i.numpy()


def _same_bits(port, ref, what):
    assert np.array_equal(port[1], ref[1]), f"{what}: indices {port[1]} != {ref[1]}"
    assert np.array_equal(port[0].view(np.uint32), ref[0].view(np.uint32)), (
        f"{what}: distances {port[0]} != {ref[0]}")


def _int_case():
    """64 x 8 integer rows: three invalid, exact duplicates, a zero row,
    +inf and -inf components, a NaN and a sign-set NaN component; the
    query is a stored row (l2sq 0 three times)."""
    rng = np.random.default_rng(1)
    n = 64
    mat = rng.integers(0, 256, (n, 8)).astype(np.float32)
    mat[[10, 40]] = mat[3]
    mat[20] = mat[7]
    valid = np.ones(n, bool)
    valid[[5, 33, 60]] = False
    mat[~valid] = 0.0
    mat[12] = 0.0
    mat[15, 2] = np.inf
    mat[16, 0] = -np.inf
    mat[25, 4] = NAN
    mat[26, 1] = NEG_NAN
    return mat, valid, mat[3].copy()


@pytest.mark.parametrize("k", [1, 5, 64])
@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("metric", METRICS)
def test_topk_distances_integer_bits(metric, ascending, k):
    mat, valid, q = _int_case()
    _same_bits(_port_topk(mat, valid, q, metric, k, ascending),
               _jax_topk(mat, valid, q, metric, k, ascending), f"{metric} k={k}")


def _real_case(metric):
    rng = np.random.default_rng(2)
    if metric == "dot":  # positive terms: no cancellation
        mat = rng.uniform(0.5, 1.5, (64, 8)).astype(np.float32)
        q = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    else:
        mat = rng.standard_normal((64, 8)).astype(np.float32)
        q = rng.standard_normal(8).astype(np.float32)
    mat[[9, 30]] = mat[4]
    valid = np.ones(64, bool)
    valid[[0, 17]] = False
    mat[~valid] = 0.0
    return mat, valid, q


@pytest.mark.parametrize("k", [1, 5, 64])
@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("metric", METRICS)
def test_topk_distances_real_within_tolerance(metric, ascending, k):
    mat, valid, q = _real_case(metric)
    full_d, _i = _jax_topk(mat, valid, q, metric, 64, ascending)
    fin = np.unique(full_d[np.isfinite(full_d)])
    assert np.all(np.diff(fin) > 1e-6 * np.abs(fin[1:])), "distinct distances must be apart"
    pd, pi = _port_topk(mat, valid, q, metric, k, ascending)
    jd, ji = _jax_topk(mat, valid, q, metric, k, ascending)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(pd, jd, rtol=1e-6, atol=0)


@pytest.mark.parametrize("d", [1, 3, 128, 1024])
def test_topk_distances_dims(d):
    """N = 300 (a multiple of no block size), duplicates, invalid rows;
    d = 1 with signed zeros (XLA's one-component dot is the product: -0
    stays -0); d = 1024 with values below 16 so its sums stay exact."""
    rng = np.random.default_rng(d)
    n, hi = 300, (16 if d == 1024 else 256)
    mat = rng.integers(0, hi, (n, d)).astype(np.float32)
    mat[rng.integers(0, n, 20)] = mat[rng.integers(0, n, 20)]
    valid = rng.random(n) < 0.9
    mat[~valid] = 0.0
    q = rng.integers(1, hi, d).astype(np.float32)
    if d == 1:
        mat[:6, 0] = [-0.0, 0.0, -0.0, -3.0, 0.0, 2.0]
        valid[:6] = True
    for metric in METRICS:
        for asc in (True, False):
            for k in (7, n):
                _same_bits(_port_topk(mat, valid, q, metric, k, asc),
                           _jax_topk(mat, valid, q, metric, k, asc), f"d={d} {metric} k={k}")
    if d == 1:  # a negative query turns +0 rows into -0 products
        qn = np.array([-3.0], np.float32)
        for asc in (True, False):
            _same_bits(_port_topk(mat, valid, qn, "dot", n, asc),
                       _jax_topk(mat, valid, qn, "dot", n, asc), "d=1 -0 products")


def test_topk_distances_nan_rules():
    """x86's arithmetic NaN is sign-set; a NaN component passes its own
    sign on.  Measured with JAX on x86: l2sq over [[1,0],[nan,0],[0,0],
    [1,0],[inf,0]] with q = [1,0] ranks [4, 0, 3, 2, 1]."""
    mat = np.array([[1, 0], [NAN, 0], [0, 0], [1, 0], [np.inf, 0]], np.float32)
    valid = np.ones(5, bool)
    q = np.array([1, 0], np.float32)
    port = _port_topk(mat, valid, q, "l2sq", 5, True)
    assert port[1].tolist() == [4, 0, 3, 2, 1]
    assert port[0].view(np.uint32)[0] == 0xFFC00000  # inf - inf on x86
    more = np.concatenate([mat, [[NEG_NAN, 0], [-np.inf, 0], [0, 1]]]).astype(np.float32)
    for m, v, qq in ((mat, valid, q), (more, np.ones(8, bool), q),
                     (more, np.ones(8, bool), np.array([NAN, 1], np.float32)),
                     (more[[0, 2, 3, 7]], np.ones(4, bool), np.array([1, NEG_NAN], np.float32))):
        for metric in METRICS:
            for asc in (True, False):
                _same_bits(_port_topk(m, v, qq, metric, len(m), asc),
                           _jax_topk(m, v, qq, metric, len(m), asc), f"nan {metric} asc={asc}")


def test_topk_distances_mixed_nan_divergence():
    """A row with NaN components of both signs: the reference's distance
    carries whichever NaN its summation order meets last (ROADMAP,
    divergences); the port takes the row's first NaN, so this row's l2sq
    is +NaN and ranks last ascending, first descending."""
    mat = np.array([[NAN, NEG_NAN, 1], [1, 2, 3], [0, 0, 0]], np.float32)
    valid = np.ones(3, bool)
    q = np.ones(3, np.float32)
    d, i = _port_topk(mat, valid, q, "l2sq", 3, True)
    assert i.tolist() == [2, 1, 0] and d.view(np.uint32)[2] == 0x7FC00000
    d, i = _port_topk(mat, valid, q, "l2sq", 3, False)
    assert i.tolist() == [0, 1, 2]


@pytest.mark.parametrize("case", ["n1", "all_invalid", "k_past_valid", "duplicates"])
def test_topk_distances_boundaries(case):
    rng = np.random.default_rng(3)
    if case == "n1":
        mat, valid, ks = np.array([[3, 4]], np.float32), np.ones(1, bool), (1,)
    elif case == "all_invalid":
        mat, valid, ks = np.zeros((40, 4), np.float32), np.zeros(40, bool), (1, 40)
    elif case == "k_past_valid":
        mat = rng.integers(0, 256, (50, 4)).astype(np.float32)
        valid = np.zeros(50, bool)
        valid[rng.choice(50, 12, replace=False)] = True
        mat[~valid] = 0.0
        ks = (20, 50)
    else:
        mat = np.repeat(rng.integers(0, 256, (5, 4)).astype(np.float32), 6, axis=0)
        valid, ks = np.ones(30, bool), (4, 13, 30)
    q = np.array([1, 2, 3, 4][: mat.shape[1]], np.float32)
    for metric in METRICS:
        for asc in (True, False):
            for k in ks:
                _same_bits(_port_topk(mat, valid, q, metric, k, asc),
                           _jax_topk(mat, valid, q, metric, k, asc), f"{case} {metric} k={k}")


# K19's select on the card (csrc/topk_distances.cu), emulated in numpy on
# the rows' flipped scores: a 12-bit first digit counted in the distance
# pass, the candidates at or above its pick, a 12-bit second digit, 8-bit
# passes over the candidates while the bin reached holds more keys than
# are wanted, then the keys >= the k-th's prefix, largest first
def _pick(hist, wanted: int):
    """(bin, count above it, its count): the bin at which the count from
    the top reaches `wanted` (`pick_digit`)."""
    above = 0
    for b in range(hist.size - 1, -1, -1):
        if above + int(hist[b]) >= wanted:
            return b, above, int(hist[b])
        above += int(hist[b])
    raise AssertionError("fewer keys than wanted")


def _select_emulated(hi: np.ndarray, k: int) -> np.ndarray:
    """The k largest keys (hi << 32 | ~row), largest first."""
    rows = np.arange(hi.size, dtype=np.uint64)
    keys = (hi.astype(np.uint64) << np.uint64(32)) | (~rows & np.uint64(0xFFFFFFFF))
    first = hi >> np.uint32(20)
    d1, above1, _c = _pick(np.bincount(first, minlength=4096), k)
    cand = keys[first >= d1]  # the candidate buffer (the kernel's is in no order)
    rng = np.random.default_rng(hi.size)
    cand = cand[rng.permutation(cand.size)]
    second = (hi[first == d1] >> np.uint32(8)) & np.uint32(4095)
    d2, above2, count = _pick(np.bincount(second, minlength=4096), k - above1)
    prefix, bits, wanted = (d1 << 12) | d2, 24, k - above1 - above2
    while wanted != count and bits < 64:
        shift = 64 - bits - 8
        at = cand[(cand >> np.uint64(shift + 8)) == np.uint64(prefix)]
        digit = ((at >> np.uint64(shift)) & np.uint64(255)).astype(np.int64)
        dig, above, count = _pick(np.bincount(digit, minlength=256), wanted)
        prefix, bits, wanted = (prefix << 8) | dig, bits + 8, wanted - above
    kth = np.uint64(prefix if bits >= 64 else prefix << (64 - bits))
    top = np.sort(cand[cand >= kth])[::-1]
    assert top.size == k
    return top


def _select_case(case: str):
    rng = np.random.default_rng(len(case))
    n, d = 3000, 8
    if case == "ties":  # three distinct rows, each a thousand times
        mat = rng.integers(0, 4, (3, d)).astype(np.float32)[rng.integers(0, 3, n)]
        valid = rng.random(n) < 0.95
    elif case == "special":  # NaN and +-inf scores beside finite ones
        mat = rng.integers(0, 256, (n, d)).astype(np.float32)
        mat[rng.choice(n, 40, replace=False), 2] = NAN
        mat[rng.choice(n, 40, replace=False), 5] = NEG_NAN
        mat[rng.choice(n, 40, replace=False), 1] = np.inf
        mat[rng.choice(n, 40, replace=False), 3] = -np.inf
        valid = rng.random(n) < 0.9
    elif case == "all_invalid":
        mat, valid = rng.integers(0, 256, (n, d)).astype(np.float32), np.zeros(n, bool)
    else:  # real-valued: the k-th bin resolves within the second digit
        mat, valid = rng.random((n, d), dtype=np.float32), np.ones(n, bool)
    mat[~valid] = 0.0
    return mat, valid, rng.integers(0, 4, d).astype(np.float32)


@pytest.mark.parametrize("k", [1, 7, 2049, 3000])
@pytest.mark.parametrize("case", ["ties", "special", "all_invalid", "real"])
def test_topk_select_emulation_matches_reference(case, k):
    """The score-first select, emulated, gives lax.top_k's rows and bits:
    tie-heavy rows (the lower rows win at the k-th score), NaN and +-inf
    scores, every row invalid, k = 1, past the one-block sort and k = N."""
    mat, valid, q = _select_case(case)
    for metric in METRICS:
        for asc in (True, False):
            bits, hi = pvec.score_bits(torch.from_numpy(mat), torch.from_numpy(valid),
                                       torch.from_numpy(q), metric, asc)
            hi = ((hi.numpy() & 0xFFFFFFFF) ^ 0x80000000).astype(np.uint32)  # the card's hi
            top = _select_emulated(hi, k)
            idx = (~top & np.uint64(0xFFFFFFFF)).astype(np.int64)
            got = (bits.numpy()[idx].view(np.float32), idx)
            # lax.top_k over the same scores (the rows' bits, negated when
            # ascending); on integer rows also the reference's whole search
            # (real rows add in another order: tests above)
            score = (bits.numpy() ^ np.int32(-(1 << 31)) if asc else bits.numpy()).view(np.float32)
            _top, ref_idx = jax.lax.top_k(jnp.asarray(score), k)
            ref_idx = np.asarray(ref_idx).astype(np.int64)
            _same_bits(got, (bits.numpy()[ref_idx].view(np.float32), ref_idx),
                       f"{case} {metric} asc={asc} lax.top_k")
            if case != "real":
                _same_bits(got, _jax_topk(mat, valid, q, metric, k, asc), f"{case} {metric} asc={asc}")


def test_topk_distances_rejects_bad_metric():
    mat, valid, q = _int_case()
    with pytest.raises(ValueError):
        _port_topk(mat, valid, q, "manhattan", 3, True)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("n", [99_999, 100_000])
def test_topk_host_threshold(monkeypatch, n, metric):
    """99,999 rows take the numpy branch and 100,000 the kernel (its plain
    form on the CPU) in both packages, with the same answer; k = 10 plus
    an offset of 5, so 15 rows, invalid rows dropped."""
    calls = {"jax": 0, "port": 0}

    def spy(which, fn):
        def wrapped(*args, **kwargs):
            calls[which] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(jvec, "topk_distances", spy("jax", jvec.topk_distances))
    monkeypatch.setattr(pvec, "topk_distances", spy("port", pvec.topk_distances))
    rng = np.random.default_rng(n)
    mat = rng.integers(0, 256, (n, 2)).astype(np.float32)
    valid = rng.random(n) < 0.99
    mat[~valid] = 0.0
    q = np.array([17, 200], np.float32)
    asc = metric != "dot"
    pd, pi = pvec.topk_host(mat, valid, q, metric, 15, asc, device="cpu")
    jd, ji = jvec.topk_host(mat, valid, q, metric, 15, asc)
    want = int(n >= 100_000)
    assert calls == {"jax": want, "port": want}
    np.testing.assert_array_equal(pi, ji)
    assert pd.dtype == jd.dtype and np.array_equal(pd.view(np.uint8), jd.view(np.uint8))


def _blobs():
    rng = np.random.default_rng(4)
    return [
        ("greptime-vector-index-v1", rng.bytes(300), {"column": "emb"}),
        ("greptime-bloom-filter-v1", bytes(range(256)) * 3, {"column": "host", "x": 1}),
        ("empty", b"", {}),
    ]


def test_puffin_bytes_and_round_trip(tmp_path):
    jpath, ppath = str(tmp_path / "j.puffin"), str(tmp_path / "p.puffin")
    jw, pw = jpuffin.PuffinWriter(jpath), ppuffin.PuffinWriter(ppath)
    for t, data, props in _blobs():
        jw.add_blob(t, data, props)
        pw.add_blob(t, data, props)
    assert pw.finish() == jw.finish()
    with open(jpath, "rb") as f, open(ppath, "rb") as g:
        assert f.read() == g.read()
    assert ppuffin.PuffinWriter(str(tmp_path / "none.puffin")).finish() == 0
    for path in (jpath, ppath):
        for ranged in (False, True):
            r = ppuffin.PuffinReader(path, ranged=ranged)
            assert [m.blob_type for m in r.blobs()] == [t for t, _d, _p in _blobs()]
            for t, data, props in _blobs():
                m = r.find(t, **props)
                assert m is not None and r.read_blob(m) == data
            assert r.find("greptime-vector-index-v1", column="other") is None
            if ranged:
                assert r.bytes_read > 0


def _vector_column(n, d, seed, nulls=()):
    rng = np.random.default_rng(seed)
    mat = rng.standard_normal((n, d)).astype(np.float32)
    vals = [None if i in nulls else mat[i].tobytes() for i in range(n)]
    return pa.array(vals, pa.binary()), mat


def test_vector_index_blob_and_candidates():
    col, mat = _vector_column(400, 4, 5, nulls={3, 77, 200})
    jb, pb = jindex.build_vector_index(col, 4), pindex.build_vector_index(col, 4)
    assert pb == jb
    ji, pi = jindex.VectorIndex(jb), pindex.VectorIndex(pb)
    assert (pi.dim, pi.nlist, pi.n) == (ji.dim, ji.nlist, ji.n)
    for qi in (0, 42, 399):
        for nprobe in (1, 4, 8):
            np.testing.assert_array_equal(pi.candidates(mat[qi], nprobe),
                                          ji.candidates(mat[qi], nprobe))
    empty = pa.array([None, None], pa.binary())
    assert pindex.build_vector_index(empty, 4) is None and jindex.build_vector_index(empty, 4) is None


_EMBS = ("CREATE TABLE embs (id STRING, emb VECTOR(3), ts TIMESTAMP TIME INDEX, PRIMARY KEY(id))",
         "INSERT INTO embs VALUES ('a', '[1,0,0]', 1), ('b', '[0,1,0]', 2),"
         " ('c', '[0.9,0.1,0]', 3), ('d', '[0,0,1]', 4)")
_EMBS_QUERIES = [
    "SELECT id FROM embs ORDER BY vec_cos_distance(emb, '[1,0,0]') LIMIT 2",
    "SELECT id, round(vec_cos_distance(emb, '[1,0,0]'), 3) d FROM embs"
    " ORDER BY vec_cos_distance(emb, '[1,0,0]') LIMIT 2",
    "SELECT id FROM embs ORDER BY vec_l2sq_distance(emb, '[1,0,0]') LIMIT 2",
    "SELECT id FROM embs WHERE id != 'a' ORDER BY vec_cos_distance(emb, '[1,0,0]') LIMIT 1",
    "SELECT id FROM embs ORDER BY vec_dot_product(emb, '[1,0,0]') DESC LIMIT 3",
    "SELECT id, ts FROM embs ORDER BY vec_l2sq_distance(emb, '[0,1,0]') LIMIT 2 OFFSET 1",
    "SELECT id FROM embs ORDER BY vec_cos_distance(emb, '[1,0,0]') LIMIT 4",
]


@pytest.fixture()
def embs(tmp_path):
    """The embs table of tests/test_vector.py in both packages, with a
    fifth row whose vector is NULL (excluded from every top-k)."""
    jdb = JaxDatabase(data_home=str(tmp_path / "jax"))
    pdb = Database(str(tmp_path / "port"), device="cpu")
    for db in (jdb, pdb):
        for stmt in _EMBS:
            db.sql(stmt)
        db.sql("INSERT INTO embs VALUES ('e', NULL, 5)")
    yield jdb, pdb
    jdb.close()
    pdb.close()


@pytest.mark.parametrize("sql", _EMBS_QUERIES)
def test_database_embs_matches_reference(embs, sql):
    jdb, pdb = embs
    got, want = pdb.sql_one(sql), jdb.sql_one(sql)
    assert got.to_pydict() == want.to_pydict()
    assert "e" not in got.column("id").to_pylist()


def test_vector_search_plan_rewrite(embs):
    from greptimedb_tpu_torch.query.planner import plan_query
    from greptimedb_tpu_torch.query.sql_parser import parse_sql

    _jdb, pdb = embs
    stmt = parse_sql("SELECT id FROM embs ORDER BY vec_l2sq_distance(emb, '[1,0,0]') LIMIT 2")[0]
    plan, _ = plan_query(stmt, pdb._schema_of, "public")
    assert "VectorSearch" in plan.describe()
    pdb.sql_one("SELECT id FROM embs ORDER BY vec_l2sq_distance(emb, '[1,0,0]') LIMIT 2")
    assert set(pdb.last_vector_timings) == {"scan", "decode", "upload", "rank", "take"}


def test_ann_index_on_append_table_matches_reference(tmp_path):
    """A flushed append-mode VECTOR INDEX table: the port writes the IVF
    sidecar (the reference's blob, byte for byte), consults it
    (INDEX_VECTOR_APPLIED moves in both packages) and returns the
    reference's rows, approximate as they are."""
    rng = np.random.RandomState(3)
    vecs = rng.randn(300, 4).astype(np.float32)
    rows = ", ".join(f"('r{i}', '[{','.join(f'{x:.4f}' for x in vecs[i])}]', {i})"
                     for i in range(300))
    create = ("CREATE TABLE logs_emb (id STRING, emb VECTOR(4) VECTOR INDEX,"
              " ts TIMESTAMP TIME INDEX, PRIMARY KEY(id)) WITH (append_mode = 'true')")
    jdb = JaxDatabase(data_home=str(tmp_path / "jax"))
    pdb = Database(str(tmp_path / "port"), device="cpu")
    try:
        for db in (jdb, pdb):
            db.sql(create)
            db.sql(f"INSERT INTO logs_emb VALUES {rows}")
        jdb.sql("ADMIN flush_table('logs_emb')")
        pdb.flush()
        (jregion,), (pregion,) = (
            [db.storage.region(r) for r in db.catalog.table("logs_emb", "public").region_ids]
            for db in (jdb, pdb))
        (jfm,), (pfm,) = jregion.files(), pregion.files()
        assert pfm.indexed_columns == ["emb"] and pfm.index_file_size > 0
        jvi = jregion.sst_reader.vector_index(jfm, "emb")
        pvi = pregion.sst_reader.vector_index(pfm, "emb")
        np.testing.assert_array_equal(pvi.centroids, jvi.centroids)
        np.testing.assert_array_equal(pvi.assign, jvi.assign)
        for qi in (42, 7, 250):
            q = vecs[qi]
            qlit = "[" + ",".join(f"{x:.4f}" for x in q) + "]"
            for fn, order in (("vec_l2sq_distance", ""), ("vec_cos_distance", ""),
                              ("vec_dot_product", " DESC")):
                sql = f"SELECT id FROM logs_emb ORDER BY {fn}(emb, '{qlit}'){order} LIMIT 5"
                jb, pb = JAX_APPLIED.get(), INDEX_VECTOR_APPLIED.get()
                got, want = pdb.sql_one(sql), jdb.sql_one(sql)
                assert got.to_pydict() == want.to_pydict(), sql
                assert INDEX_VECTOR_APPLIED.get() - pb == JAX_APPLIED.get() - jb == 1
            assert pdb.sql_one(
                f"SELECT id FROM logs_emb ORDER BY vec_l2sq_distance(emb, '{qlit}') LIMIT 1"
            ).column("id").to_pylist() == [f"r{qi}"]
    finally:
        jdb.close()
        pdb.close()


BIG_ROWS, BIG_FROZEN, BIG_LIVE = 100_000, 3_000, 2_000
_BIG_QUERIES = [
    "SELECT id FROM big ORDER BY vec_l2sq_distance(emb, '{q}') LIMIT 10",
    "SELECT id FROM big ORDER BY vec_cos_distance(emb, '{q}') LIMIT 5",
    "SELECT id FROM big ORDER BY vec_dot_product(emb, '{q}') DESC LIMIT 10",
    "SELECT id, ts FROM big ORDER BY vec_l2sq_distance(emb, '{q}') LIMIT 10 OFFSET 5",
]


def _big_batches():
    """Three batches of (ts, id, emb) rows: integer vectors in [0, 255],
    duplicates across the batches (exact ties), a few NULL vectors."""
    rng = np.random.default_rng(6)
    n = BIG_ROWS + BIG_FROZEN + BIG_LIVE
    mat = rng.integers(0, 256, (n, 4)).astype(np.float32)
    mat[rng.integers(0, n, 300)] = mat[rng.integers(0, n, 300)]
    mat[BIG_ROWS + 10] = mat[BIG_ROWS + BIG_FROZEN + 20] = mat[77]
    nulls = set(rng.integers(0, n, 50).tolist())
    ids = np.arange(n, dtype=np.int64)
    emb = pa.array([None if i in nulls else mat[i].tobytes() for i in range(n)], pa.binary())
    table = pa.table({"ts": pa.array(chip_smoke.T0 + ids, pa.timestamp("ms")), "id": ids,
                      "emb": emb})
    cuts = (0, BIG_ROWS, BIG_ROWS + BIG_FROZEN, n)
    return [table.slice(a, b - a) for a, b in zip(cuts, cuts[1:])], mat[77]


def _queries_during_flush(db, region, write_live, queries):
    """Flush the region; while its memtable is frozen (the SST not yet
    committed) write the live batch and run the queries."""
    out = {}
    original = region._encode_sst_windows

    def hooked(frozen):
        write_live()
        assert region._frozen_memtables, "the flushing memtable must be frozen"
        for sql in queries:
            out[sql] = db.sql_one(sql)
        return original(frozen)

    region._encode_sst_windows = hooked
    try:
        region.flush()
    finally:
        del region._encode_sst_windows
    return out


@pytest.fixture(scope="module", params=["default", "append"])
def big(request, tmp_path_factory):
    """Per big query (sql, [(port table, reference table)] during the
    flush and after it): run while rows lie in an SST, a frozen memtable
    and the live memtable, and again once the flush has committed; each
    package must call its kernel once per query."""
    batches, q = _big_batches()
    lit = "[" + ",".join(str(int(x)) for x in q) + "]"
    queries = [s.format(q=lit) for s in _BIG_QUERIES]
    opts = " WITH (append_mode = 'true')" if request.param == "append" else ""
    create = f"CREATE TABLE big (ts TIMESTAMP TIME INDEX, id BIGINT, emb VECTOR(4)){opts}"
    calls = {"jax": 0, "port": 0}
    saved = jvec.topk_distances, pvec.topk_distances

    def spy(which, fn):
        def wrapped(*args, **kwargs):
            calls[which] += 1
            return fn(*args, **kwargs)
        return wrapped

    jvec.topk_distances, pvec.topk_distances = spy("jax", saved[0]), spy("port", saved[1])
    home = tmp_path_factory.mktemp(f"big_{request.param}")
    jdb = JaxDatabase(data_home=str(home / "jax"))
    pdb = Database(str(home / "port"), device="cpu")
    results = {}
    try:
        for name, db, write in (("jax", jdb, jdb.insert_rows), ("port", pdb, pdb.write)):
            db.sql(create)
            write("big", batches[0])
            db.storage.flush_all()
            write("big", batches[1])
            (rid,) = db.catalog.table("big", "public").region_ids
            before = calls[name]
            during = _queries_during_flush(db, db.storage.region(rid),
                                           lambda: write("big", batches[2]), queries)
            after = {sql: db.sql_one(sql) for sql in queries}
            # one kernel call per query: the merged scan (default) or the
            # 100,000-row SST (append); the memtables take numpy
            assert calls[name] - before == 2 * len(queries), (name, calls)
            results[name] = (during, after)
    finally:
        jvec.topk_distances, pvec.topk_distances = saved
        jdb.close()
        pdb.close()
    return [(sql, [(results["port"][i][sql], results["jax"][i][sql]) for i in (0, 1)])
            for sql in queries]


@pytest.mark.parametrize("qi", range(len(_BIG_QUERIES)))
def test_big_table_matches_reference(big, qi):
    sql, pairs = big[qi]
    for port, ref in pairs:  # during the flush, then after it
        assert port.to_pydict() == ref.to_pydict(), sql
        assert port.num_rows == (5 if "LIMIT 5" in sql else 10)


def test_chip_smoke_vector_phase_rehearsal(tmp_path):
    """Phase 8's slice of chip_smoke.py at 100,000 x 8 on the CPU: the
    five queries against its numpy ground truth and the IVF table."""
    out = chip_smoke.run_vector_slice("cpu", 100_000, 8, 0, str(tmp_path))
    assert set(out["queries"]) == {name for name, *_ in chip_smoke.vector_queries(
        chip_smoke.sift_data(10, 8)[1])}
    assert out["ivf"]["index_vector_applied"] >= 1
    assert "topk_distances" in chip_smoke.kernel_table()
