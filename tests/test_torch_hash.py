"""The hash group-by of the port (agg_strategy auto / hash / sort) against
the reference JAX package on the CPU, on numpy-seeded inputs.

* K17's plain version (`hash_group_slots_plain`) against the reference's
  `hash_group_slots`: table, slots and overflow byte-equal, on seeded
  ids, a table threaded through three sources, masked rows, an
  overflowing table, ids that share a home position, and the extreme ids
  0 and 2^62 - 1 (after tests/test_agg_strategy.py:237-272);
* K1's int64 mode (plain) against `raw_group_ids(dtype=int64)`, with
  out-of-range codes and a space past 2^31;
* `compute_partial_states` of a hash plan against the reference's over
  three threaded sources: tables byte-equal, counts, min and max exact,
  sums within rel 1e-12 (byte-equal with binary-exact values);
* the port's Database (device="cpu") against the reference Database,
  both under the same `agg_strategy`: the sqlness golden
  agg_strategy_groupby.sql, seeded group-bys with NULL tags and values
  and duplicate-heavy keys (tests/test_agg_strategy.py:102-125), the
  strategy verdicts, a group space past the dense bound, an overflowing
  slot table and the gid-range decline.  Knobs that reach a verdict at a
  small size (`agg_hash_min_group_space`, `max_internal_groups`) are set
  alike on both sides.

The strategy verdicts are compared on warm queries: the reference asks
its term index for a column its dictionary has not encoded yet, the port
(which has no index sidecars) probes once its sources are encoded."""

import io
import math

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from greptimedb_tpu.database import Database as JaxDatabase
from greptimedb_tpu.ops import aggregate as jagg
from greptimedb_tpu.parallel import executor as jexec
from greptimedb_tpu.parallel.tile_cache import _HASH_GID_LIMIT
from greptimedb_tpu.utils import metrics
from greptimedb_tpu.utils.config import Config as JaxConfig
from greptimedb_tpu_torch import Database
from greptimedb_tpu_torch.ops import aggregate as tagg
from greptimedb_tpu_torch.ops import filter as tflt
from greptimedb_tpu_torch.parallel import executor as texec
from greptimedb_tpu_torch.parallel.tile_planner import HASH_GID_LIMIT
from test_torch_tile import HOST_ROUTES, UNPORTED_PASSES

T0 = 1_767_225_600_000
STRATEGIES = ("auto", "hash", "sort")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bytes_equal(port, ref, what):
    port = port.numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.dtype == ref.dtype and port.shape == ref.shape, what
    assert port.tobytes() == ref.tobytes(), what


# ---- K17 -------------------------------------------------------------------------


def _slots_pair(h, sources):
    """Run the sources [(gids, active)] through both versions, threading
    one table each; compare after every source; return the final pair."""
    jt = jnp.full((h,), jagg.HASH_EMPTY, jnp.int64)
    tt = torch.full((h,), tagg.HASH_EMPTY, dtype=torch.int64)
    for i, (gids, act) in enumerate(sources):
        jt, js, jo = jagg.hash_group_slots(jt, jnp.asarray(gids), jnp.asarray(act))
        tt, ts, to = tagg.hash_group_slots(tt, _t(gids), _t(act))
        _bytes_equal(tt, jt, f"source {i} table")
        _bytes_equal(ts, js, f"source {i} slots")
        _bytes_equal(to, jo, f"source {i} overflow")
    return (tt, ts, to), (jt, js, jo)


def _k17_case(name, rng):
    if name == "seeded_1024":
        return 1024, [(rng.integers(0, 400, 3000).astype(np.int64), rng.random(3000) < 0.9)]
    if name == "seeded_65536":
        return 1 << 16, [(rng.integers(0, 1 << 40, 40_000).astype(np.int64),
                          np.ones(40_000, bool))]
    if name == "three_sources":
        return 4096, [(rng.integers(0, 1800, n).astype(np.int64), rng.random(n) < 0.8)
                      for n in (5000, 1234, 7000)]
    if name == "masked":
        g = rng.integers(0, 50, 2000).astype(np.int64)
        return 1024, [(g, rng.random(2000) < 0.3), (g, np.zeros(2000, bool))]
    if name == "overflow":
        return 8, [(np.arange(40, dtype=np.int64) * 7919, np.ones(40, bool))]
    if name == "shared_home":
        # ids whose home positions coincide: long probe chains
        h = 1024
        cand = np.arange(0, 2_000_000, dtype=np.int64)
        home = np.asarray(tagg._hash_home(_t(cand), h))
        g = np.concatenate([cand[home == 17][:60], cand[home == 1000][:40], cand[home == 1023][:30]])
        return h, [(rng.permutation(np.repeat(g, 3)), np.ones(3 * len(g), bool))]
    if name == "extreme_ids":
        g = np.array([0, (1 << 62) - 1, (1 << 62) - 2, 1, 0, (1 << 62) - 1, 1 << 61, 5],
                     dtype=np.int64)
        return 1024, [(g, np.ones(len(g), bool)), (g[::-1].copy(), np.ones(len(g), bool))]
    if name == "runs_of_ten":
        # ten rows of one id from row 5 on: runs across every warp's edge
        g = np.concatenate([np.full(5, 3), np.repeat(rng.integers(0, 1 << 40, 300), 10)])
        return 1024, [(g.astype(np.int64), np.ones(len(g), bool))]
    if name == "largest_one_slot":
        # 2^62 - 1 and 2^62 - 2 contend for the one empty position
        g = np.array([(1 << 62) - 1, (1 << 62) - 2, (1 << 62) - 1], dtype=np.int64)
        return 1, [(g, np.ones(3, bool))]
    raise KeyError(name)


K17_CASES = ("seeded_1024", "seeded_65536", "three_sources", "masked", "overflow",
             "shared_home", "extreme_ids")


@pytest.mark.parametrize("name", K17_CASES)
def test_hash_group_slots_matches_reference(name):
    rng = np.random.default_rng(K17_CASES.index(name) + 1)
    h, sources = _k17_case(name, rng)
    (tt, ts, to), _ref = _slots_pair(h, sources)
    gids, act = sources[-1]
    s = ts.numpy()
    if name == "overflow":
        assert int(to) == 40 - 8 and int((s == 8).sum()) == 40 - 8
    else:
        assert int(to) == 0
        # one slot per gid, the table holds each active gid once
        placed = s < h
        assert np.array_equal(placed, act)
        keys = tt.numpy()
        assert np.array_equal(keys[s[placed]], gids[placed])
        occupied = keys[keys != tagg.HASH_EMPTY]
        assert len(occupied) == len(np.unique(occupied))


_TAG = 1 << 62
_SIGN = -(1 << 63)


def _tag_rounds(table, gids, active, seed):
    """K17's rounds (csrc/hash_group_slots.cu) in torch ops, on the table in
    place.  A claim is the unsigned minimum of the tag 2^62 + gid into the
    table itself (HASH_EMPTY, -1, the largest unsigned value; the minimum
    taken on the values with their sign bit flipped), one claim per
    distinct tag in each warp of 32 rows.  Then the fused land/find: a row
    decodes its position's winner (a tag less 2^62, or a landed gid) and
    is found when it is its gid; a found row that read a tag writes the
    gid.  Round 0 walks every row; later rounds walk the worklist of the
    rows not yet found, each round in another shuffled order.  Returns
    (slots, overflow, rounds): rounds 0 when no row is active."""
    h = table.shape[0]
    home = tagg._hash_home(gids, h)
    slots = torch.full((gids.shape[0],), h, dtype=torch.int32)
    rng = np.random.default_rng(seed)
    rows = torch.nonzero(active).flatten()
    rounds, max_rounds = 0, min(2 * h, 1024)
    while rounds == 0 or (rows.numel() and rounds < max_rounds):
        if rounds:
            rows = rows[torch.from_numpy(rng.permutation(rows.numel()))]
        pos = ((home[rows] + rounds) & (h - 1)).long()
        tag = _TAG + gids[rows]
        # the lowest lane of each tag in each warp of 32 list entries claims
        lane = torch.arange(rows.numel())
        key = torch.stack([lane // 32, tag], 1)
        _u, inv = torch.unique(key, dim=0, return_inverse=True)
        lead = torch.full((_u.shape[0],), rows.numel(), dtype=torch.int64).scatter_reduce_(
            0, inv, lane, "amin")
        flipped = (table ^ _SIGN).scatter_reduce_(0, pos[lead], tag[lead] ^ _SIGN, "amin")
        table.copy_(flipped ^ _SIGN)
        t = table[pos]
        w = torch.where(t >= _TAG, t - _TAG, t)
        found = w == gids[rows]
        landing = found & (t >= _TAG)
        table[pos[landing]] = w[landing]
        slots[rows[found]] = pos[found].to(torch.int32)
        rows = rows[~found]
        rounds += 1
    return slots, torch.tensor(rows.numel(), dtype=torch.int32), rounds if bool(active.any()) else 0


def _reference_rounds(h, gids, active, slots, overflow):
    """The reference's probe rounds, from its outputs: none when no row is
    active, the cap when a row overflowed, else one more than the largest
    probe of a found row (a row is found in the round of its probe, and
    below H probes)."""
    if not active.any():
        return 0
    if int(overflow):
        return min(2 * h, 1024)
    home = np.asarray(tagg._hash_home(_t(gids), h)).astype(np.int64)
    found = np.asarray(slots) < h
    return int((((np.asarray(slots)[found] - home[found]) & (h - 1)).max())) + 1


K17_TAG_CASES = K17_CASES + ("runs_of_ten", "largest_one_slot")


@pytest.mark.parametrize("name", K17_TAG_CASES)
def test_tag_rounds_match_reference(name):
    """The table, slots, overflow and rounds of K17's tag rounds equal the
    reference's and the plain version's, source after source."""
    rng = np.random.default_rng(K17_TAG_CASES.index(name) + 1)
    h, sources = _k17_case(name, rng)
    jt = jnp.full((h,), jagg.HASH_EMPTY, jnp.int64)
    et = torch.full((h,), tagg.HASH_EMPTY, dtype=torch.int64)
    pt = et.clone()
    for i, (gids, act) in enumerate(sources):
        jt, js, jo = jagg.hash_group_slots(jt, jnp.asarray(gids), jnp.asarray(act))
        es, eo, er = _tag_rounds(et, _t(gids), _t(act), seed=i)
        _bytes_equal(et, jt, f"source {i} table")
        _bytes_equal(es, js, f"source {i} slots")
        _bytes_equal(eo, jo, f"source {i} overflow")
        assert er == _reference_rounds(h, gids, act, js, jo), f"source {i} rounds"
        _pt, _ps, _po = tagg.hash_group_slots(pt, _t(gids), _t(act))
        assert er == tagg.last_hash_rounds(), f"source {i} rounds of the plain version"
    if name == "largest_one_slot":
        assert et.tolist() == [(1 << 62) - 2] and int(eo) == 2


def test_threaded_table_keeps_slots_across_sources():
    """A gid seen by an earlier source keeps its slot in a later one, as
    the reference's docstring promises (deterministic claims)."""
    h = 64
    a = np.array([5, 9, 5, 123456789, 9], dtype=np.int64)
    b = np.array([9, 77, 5], dtype=np.int64)
    (tt, _ts, _to), _ref = _slots_pair(h, [(a, np.ones(5, bool))])
    first = {int(g): int(np.nonzero(tt.numpy() == g)[0][0]) for g in a}
    _t2, s2, o2 = tagg.hash_group_slots(tt, _t(b), torch.ones(3, dtype=torch.bool))
    assert int(o2) == 0
    assert int(s2[0]) == first[9] and int(s2[2]) == first[5]


# ---- K1 int64 mode ------------------------------------------------------------------


@pytest.mark.parametrize("case", ["bucket", "tags_only", "past_int32"])
def test_mask_gids_int64_matches_reference(case):
    rng = np.random.default_rng(3)
    n = 10_000 + 17
    cards = {"bucket": (128, 8), "tags_only": (64, 32), "past_int32": (1 << 16, 1 << 12)}[case]
    codes = [rng.integers(-1, c + 2, n).astype(np.int32) for c in cards]  # out of range both ways
    ts = (T0 + rng.integers(-10**8, 10**9, n)).astype(np.int64)
    valid = np.arange(n) < n - 33
    comps = [(jnp.asarray(c), card) for c, card in zip(codes, cards)]
    tags = [(_t(c), card) for c, card in zip(codes, cards)]
    bucket = None
    if case != "tags_only":
        origin, interval, nb = T0, 3_600_000, 300
        comps.append((jagg.time_bucket(jnp.asarray(ts), origin, interval), nb))
        bucket = (_t(ts), origin, interval, nb)
    jg, in_range = jagg.raw_group_ids(comps, shape=valid.shape, dtype=jnp.int64)
    pg, pm = tflt.mask_gids(_t(valid), [], [], tags, bucket, None, dtype=torch.int64)
    assert pg.dtype == torch.int64
    _bytes_equal(pg, jg, "gids")
    _bytes_equal(pm, np.asarray(in_range) & valid, "mask")
    if case == "past_int32":
        assert int(pg.max()) >= 1 << 31


# ---- compute_partial_states, hash plan ------------------------------------------------


def _hash_plans(slots):
    common = dict(
        group_tags=("a", "b"), tag_cards=(64, 8), bucket_col="ts", bucket_origin=T0,
        bucket_interval=600_000, n_buckets=16,
        agg_specs=(("sum", "v"), ("avg", "v"), ("count", "v"), ("min", "w"), ("max", "w"),
                   ("count", "__count_star")),
        filters=(("ts", ">=", T0 + 60_000), ("a", "!=", 3)), acc_dtype="float64",
        agg_strategy="hash", hash_slots=slots,
    )
    return jexec.DistGroupByPlan(**common), texec.DistGroupByPlan(**common)


@pytest.mark.parametrize("values", ["binary_exact", "float"])
def test_hash_partial_states_match_reference(values):
    rng = np.random.default_rng(5)
    slots = 1 << 14  # 2x the 64 x 8 x 16 possible ids
    jplan, tplan = _hash_plans(slots)
    jt = jnp.full((slots,), jagg.HASH_EMPTY, jnp.int64)
    tt = torch.full((slots,), tagg.HASH_EMPTY, dtype=torch.int64)
    for i, n in enumerate((6000, 70_000, 999)):  # the middle one passes 2^16 rows
        v = (rng.integers(-400, 400, n) / 4.0 if values == "binary_exact"
             else rng.uniform(-1e3, 1e3, n))
        cols = {
            "a": rng.integers(-1, 64, n).astype(np.int32),
            "b": rng.integers(0, 8, n).astype(np.int32),
            "ts": (T0 + rng.integers(0, 16 * 600_000, n)).astype(np.int64),
            "v": v,
            "w": rng.uniform(-50, 50, n),
        }
        valid = np.arange(n) < n - 7
        nulls = {"v": rng.random(n) < 0.85}
        jst, jt = jexec.compute_partial_states(
            jplan, {k: jnp.asarray(x) for k, x in cols.items()}, jnp.asarray(valid),
            {k: jnp.asarray(x) for k, x in nulls.items()}, count_cols=("v",), hash_table=jt,
        )
        tst, tt = texec.compute_partial_states(
            tplan, {k: _t(x) for k, x in cols.items()}, _t(valid),
            {k: _t(x) for k, x in nulls.items()}, count_cols=("v",), hash_table=tt,
        )
        _bytes_equal(tt, jt, f"source {i} table")
        assert set(tst) == set(jst)
        for key in jst:
            for field in ("sums", "counts", "mins", "maxs"):
                p, r = getattr(tst[key], field), getattr(jst[key], field)
                assert (p is None) == (r is None), (key, field)
                if p is None:
                    continue
                if field == "sums" and values == "float":
                    np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=1e-12, atol=1e-9,
                                               err_msg=f"{key}.{field}")
                else:
                    _bytes_equal(p, r, f"source {i} {key}.{field}")
        assert int(tst["__hash_overflow"].counts[0]) == 0


# ---- end to end: the port's Database beside the reference's ------------------------------


def _jax_db(home: str) -> JaxDatabase:
    cfg = JaxConfig()
    cfg.query.disabled_passes = UNPORTED_PASSES
    cfg.query.tile_persist_enable = False
    cfg.query.fallback_to_cpu = False
    cfg.query.tpu_min_rows = 0
    return JaxDatabase(config=cfg, data_home=home)


class _Pair:
    """The port's and the reference's Database over the same writes."""

    def __init__(self, tmp):
        self.ref = _jax_db(str(tmp / "jax"))
        self.port = Database(str(tmp / "port"), device="cpu")
        self.port.config.query.disabled_passes = HOST_ROUTES

    def close(self):
        self.port.close()
        self.ref.close()

    def sql(self, text):
        self.port.sql(text)
        self.ref.sql(text)

    def write(self, table, rows):
        self.port.write(table, rows)
        self.ref.insert_rows(table, rows)

    def flush(self):
        self.port.flush()
        self.ref.storage.flush_all()

    def set(self, **knobs):
        for k, v in knobs.items():
            setattr(self.port.config.query, k, v)
            setattr(self.ref.config.query, k, v)

    def run(self, sql):
        """(port table, reference table, port strategy, reference
        strategy): the strategy each package's tile path dispatched (None
        where it declined)."""
        eng = self.port.query_engine
        before = dict(eng.stats)
        got = self.port.sql_one(sql)
        delta = {k: eng.stats[k] - before[k] for k in ("agg_hash", "agg_sort", "tile_dispatches")}
        port_strategy = ("hash" if delta["agg_hash"] else "sort" if delta["agg_sort"] else None)
        if delta["tile_dispatches"] == 0:
            port_strategy = None
        h0 = metrics.AGG_STRATEGY_TOTAL.get(strategy="hash")
        s0 = metrics.AGG_STRATEGY_TOTAL.get(strategy="sort")
        l0 = metrics.TILE_LOWERED_TOTAL.get()
        want = self.ref.sql_one(sql)
        ref_strategy = None
        if metrics.TILE_LOWERED_TOTAL.get() > l0:
            ref_strategy = ("hash" if metrics.AGG_STRATEGY_TOTAL.get(strategy="hash") > h0
                            else "sort" if metrics.AGG_STRATEGY_TOTAL.get(strategy="sort") > s0
                            else None)
        return got, want, port_strategy, ref_strategy


def _ser(t: pa.Table) -> bytes:
    sink = io.BytesIO()
    with pa.ipc.new_stream(sink, t.schema) as w:
        w.write_table(t)
    return sink.getvalue()


def _assert_same(got, want, sql, rel=1e-12, sort_keys=None):
    assert got.column_names == want.column_names, (sql, got.column_names, want.column_names)
    assert got.num_rows == want.num_rows, (sql, got.num_rows, want.num_rows)
    if sort_keys:
        got = got.sort_by([(k, "ascending") for k in sort_keys])
        want = want.sort_by([(k, "ascending") for k in sort_keys])
    for c in got.column_names:
        for x, y in zip(got[c].to_pylist(), want[c].to_pylist()):
            if isinstance(x, float) and isinstance(y, float):
                assert (math.isnan(x) and math.isnan(y)) or math.isclose(
                    x, y, rel_tol=rel, abs_tol=0.0), (sql, c, x, y)
            else:
                assert x == y, (sql, c, x, y)


GOLDEN = "tests/cases/standalone/agg_strategy_groupby.sql"


def _golden_statements():
    import os

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    text = open(os.path.join(here, GOLDEN)).read()
    lines = [ln for ln in text.splitlines() if not ln.startswith("--")]
    return [s.strip() for s in "\n".join(lines).split(";") if s.strip()]


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """Each strategy's SELECT results of the golden, through both packages."""
    out = {}
    for strategy in STRATEGIES:
        pair = _Pair(tmp_path_factory.mktemp(f"golden_{strategy}"))
        try:
            pair.set(agg_strategy=strategy)
            results = []
            for stmt in _golden_statements():
                if stmt.upper().startswith("ADMIN"):
                    pair.flush()
                elif stmt.upper().startswith("SELECT"):
                    got, want, ps, rs = pair.run(stmt)
                    assert pair.port.query_engine.last_path == "tile", stmt
                    results.append((stmt, got, want, ps, rs))
                else:
                    pair.sql(stmt)
            out[strategy] = results
        finally:
            pair.close()
    return out


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_golden_matches_reference(golden, strategy):
    """The sqlness golden through both packages under one strategy:
    binary-exact values, so the tables are equal value for value, and the
    forced strategy is the one each dispatched."""
    for stmt, got, want, ps, rs in golden[strategy]:
        assert got.schema.equals(want.schema), stmt
        assert got.to_pydict() == want.to_pydict(), stmt
        assert ps == rs, (stmt, ps, rs)
        if strategy != "auto":
            assert ps == strategy, stmt


def test_golden_is_byte_identical_under_every_strategy(golden):
    for i, (stmt, first, _w, _ps, _rs) in enumerate(golden["sort"]):
        for strategy in ("auto", "hash"):
            assert _ser(golden[strategy][i][1]) == _ser(first), (strategy, stmt)


PARITY_Q = (
    "SELECT k, g, sum(v) AS sv, avg(v) AS av, count(v) AS cv,"
    " min(w) AS mw, max(w) AS xw, count(*) AS c"
    " FROM t GROUP BY k, g"
)


def _load_random(pair, n, n_keys, seed, nulls=False, null_tags=False, dup_heavy=False):
    """tests/test_agg_strategy.py's table: integer-valued v (exact sums),
    arbitrary w (min/max only), NULL values and tags on request."""
    rng = np.random.default_rng(seed)
    pair.sql("CREATE TABLE t (k STRING, g STRING, ts TIMESTAMP TIME INDEX,"
             " v DOUBLE, w DOUBLE, PRIMARY KEY (k, g)) WITH (append_mode='true')")
    keys = rng.integers(0, max(n_keys // 50, 2) if dup_heavy else n_keys, n)
    gs = [f"g{i % 7}" for i in keys]
    v = rng.integers(-500, 500, n).astype(np.float64)
    tbl = pa.table({
        "k": pa.array([f"k{i:05d}" for i in keys]),
        "g": pa.array([None if null_tags and i % 11 == 0 else g for i, g in enumerate(gs)],
                      pa.string()),
        "ts": pa.array(np.arange(n, dtype=np.int64) * 1000, pa.timestamp("ms")),
        "v": pa.array([None if nulls and i % 7 == 0 else x for i, x in enumerate(v)],
                      pa.float64()),
        "w": pa.array(rng.uniform(-1e3, 1e3, n)),
    })
    pair.write("t", tbl)
    pair.flush()


PARITY_CASES = {
    "null_values": dict(seed=2, nulls=True, n_keys=400),
    "null_tags_dup_heavy": dict(seed=4, nulls=True, null_tags=True, dup_heavy=True, n_keys=200),
    "high_cardinality": dict(seed=5, n_keys=4000),
}


@pytest.fixture(scope="module", params=sorted(PARITY_CASES))
def parity_pair(request, tmp_path_factory):
    pair = _Pair(tmp_path_factory.mktemp("parity"))
    try:
        _load_random(pair, 20_000, **PARITY_CASES[request.param])
        # the auto verdicts at this size: hash needs a padded space of at
        # least agg_hash_min_group_space groups
        pair.set(agg_hash_min_group_space=1024)
        yield request.param, pair
    finally:
        pair.close()


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_seeded_group_by_matches_reference(parity_pair, strategy):
    """NULL tags and values and duplicate-heavy keys: the port equals the
    reference under each strategy (integer-valued sums exact, avg within
    the f32 rows both ship for G >= 2^14), and takes the same verdict."""
    case, pair = parity_pair
    pair.set(agg_strategy=strategy)
    try:
        pair.run(PARITY_Q)  # warm both dictionaries
        got, want, ps, rs = pair.run(PARITY_Q)
    finally:
        pair.set(agg_strategy="auto")
    assert ps is not None and ps == rs, (case, strategy, ps, rs)
    if strategy != "auto":
        assert ps == strategy
    _assert_same(got, want, PARITY_Q, rel=1e-6, sort_keys=["k", "g"])
    assert _ser(got.sort_by([("k", "ascending"), ("g", "ascending")])) == _ser(
        want.sort_by([("k", "ascending"), ("g", "ascending")]))


def test_hash_and_sort_give_the_same_bytes(parity_pair):
    _case, pair = parity_pair
    out = {}
    for strategy in ("sort", "hash"):
        pair.set(agg_strategy=strategy)
        out[strategy] = pair.port.sql_one(PARITY_Q)
    pair.set(agg_strategy="auto")
    assert _ser(out["sort"]) == _ser(out["hash"])


def test_auto_picks_hash_on_a_sparse_space(tmp_path):
    """Two ~1.5k-value tags that co-occur 1:1: a padded space of 2^22 for
    1.5k groups, so auto picks hash on both sides
    (tests/test_agg_strategy.py:128)."""
    pair = _Pair(tmp_path)
    try:
        n = 30_000
        rng = np.random.default_rng(6)
        k = rng.integers(0, 1500, n)
        pair.sql("CREATE TABLE s (a STRING, b STRING, ts TIMESTAMP TIME INDEX,"
                 " v DOUBLE, PRIMARY KEY (a, b)) WITH (append_mode='true')")
        pair.write("s", pa.table({
            "a": pa.array([f"a{i:04d}" for i in k]),
            "b": pa.array([f"b{i:04d}" for i in k]),
            "ts": pa.array(np.arange(n, dtype=np.int64), pa.timestamp("ms")),
            "v": pa.array(rng.integers(0, 100, n).astype(np.float64)),
        }))
        pair.flush()
        q = "SELECT a, b, sum(v) AS sv, count(*) AS c FROM s GROUP BY a, b"
        pair.run(q)
        got, want, ps, rs = pair.run(q)
        assert ps == rs == "hash"
        _assert_same(got, want, q)
        # an ORDER BY / LIMIT over a hash plan replays on the host
        q2 = q + " ORDER BY sv DESC, a LIMIT 7"
        got, want, ps, rs = pair.run(q2)
        assert ps == rs == "hash"
        _assert_same(got, want, q2)
    finally:
        pair.close()


def test_auto_picks_sort_at_the_tsbs_shape(tmp_path):
    """TSBS double-groupby (hosts x hourly buckets): every host reports in
    every bucket, the space is well filled, and auto keeps the dense path
    even with the minimum space lowered to reach the fill rule."""
    import chip_smoke

    tsbs = chip_smoke.Tsbs(40, 12, n_metrics=3)
    pair = _Pair(tmp_path)
    try:
        chip_smoke.ingest(pair, tsbs)
        pair.set(agg_hash_min_group_space=1024)
        q = dict(tsbs.queries())["double-groupby-1"]
        pair.run(q)
        got, want, ps, rs = pair.run(q)
        assert ps == rs == "sort"
        _assert_same(got, want, q)
    finally:
        pair.close()


def test_group_space_past_the_dense_bound_runs_on_the_tile_path(tmp_path):
    """Three tags whose padded product (2^33) is past max_groups * 64: the
    dense path refuses it, the hash plan answers on the tile path
    (tests/test_agg_strategy.py:158)."""
    pair = _Pair(tmp_path)
    try:
        n = 30_000
        rng = np.random.default_rng(7)
        k = rng.integers(0, 1200, n)
        pair.sql("CREATE TABLE big (a STRING, b STRING, c STRING, ts TIMESTAMP TIME"
                 " INDEX, v DOUBLE, PRIMARY KEY (a, b, c)) WITH (append_mode='true')")
        pair.write("big", pa.table({
            "a": pa.array([f"a{i % 1031:04d}" for i in k]),
            "b": pa.array([f"b{i % 1151:04d}" for i in k]),
            "c": pa.array([f"c{i:04d}" for i in k]),
            "ts": pa.array(np.arange(n, dtype=np.int64), pa.timestamp("ms")),
            "v": pa.array(rng.integers(0, 50, n).astype(np.float64)),
        }))
        pair.flush()
        q = "SELECT a, b, c, sum(v) AS sv, count(*) AS cnt FROM big GROUP BY a, b, c"
        pair.run(q)
        got, want, ps, rs = pair.run(q)
        assert ps == rs == "hash"
        assert pair.port.query_engine.last_path == "tile"
        _assert_same(got, want, q)
    finally:
        pair.close()


def test_slot_overflow_leaves_the_hash_result(tmp_path):
    """A slot table clamped below the distinct keys overflows: the verdict
    counts once, the dense rerun is outside the bound as well, so the
    table-fed path answers, and the answer equals the reference's
    (tests/test_agg_strategy.py:194).  The reference's table-fed path gets
    a one-device mesh: with more devices than region tables its shards
    stack to different shapes (ROADMAP.md, Queue C)."""
    from greptimedb_tpu.parallel.mesh import make_mesh

    pair = _Pair(tmp_path)
    try:
        _load_random(pair, 20_000, 3000, 8)
        pair.ref.query_engine._mesh = make_mesh(1)
        pair.set(agg_strategy="hash", max_internal_groups=2048)
        eng = pair.port.query_engine
        before = dict(eng.stats)
        o0 = metrics.AGG_HASH_OVERFLOW.get()
        got = pair.port.sql_one(PARITY_Q)
        want = pair.ref.sql_one(PARITY_Q)
        assert eng.stats["agg_hash"] == before["agg_hash"] + 1
        assert eng.stats["agg_hash_overflow"] == before["agg_hash_overflow"] + 1
        assert eng.stats["tile_declined"] == before["tile_declined"] + 1
        assert eng.last_path == "table"
        assert metrics.AGG_HASH_OVERFLOW.get() == o0 + 1
        _assert_same(got, want, PARITY_Q, sort_keys=["k", "g"])
    finally:
        pair.close()


def test_slot_overflow_reruns_dense_within_the_bound(tmp_path, monkeypatch):
    """Where the dense plan fits the bounds, an overflowing hash dispatch
    reruns it on the tile path: the second rung of the reference's ladder
    (tile_cache.py:5176-5190).  The port's slot table is shrunk to force
    the overflow."""
    from greptimedb_tpu_torch.parallel import tile_planner

    pair = _Pair(tmp_path)
    try:
        _load_random(pair, 20_000, 3000, 8)
        pair.set(agg_strategy="hash")
        want = pair.ref.sql_one(PARITY_Q)
        monkeypatch.setattr(tile_planner, "size_hash_slots", lambda config, d_est: 1024)
        eng = pair.port.query_engine
        before = dict(eng.stats)
        got = pair.port.sql_one(PARITY_Q)
        assert eng.last_path == "tile"
        assert eng.stats["agg_hash"] == before["agg_hash"] + 1
        assert eng.stats["agg_hash_overflow"] == before["agg_hash_overflow"] + 1
        _assert_same(got, want, PARITY_Q, rel=1e-6, sort_keys=["k", "g"])
    finally:
        pair.close()


def _probe_pair(knobs, cards, est_rows, n_buckets, aggs):
    """The port's `choose_agg_strategy` and the reference's
    `_choose_agg_strategy` on the same dictionary cardinalities, row
    estimate and bucket geometry."""
    from types import SimpleNamespace

    from greptimedb_tpu.parallel.tile_cache import TileExecutor as JaxTileExecutor
    from greptimedb_tpu_torch.parallel import tile_planner
    from greptimedb_tpu_torch.utils.config import QueryConfig

    tags = sorted(cards)
    geometry = ("ts", 1, 0, n_buckets, tile_planner.quantize_soft(n_buckets))
    ctx = SimpleNamespace(
        dictionary=SimpleNamespace(cardinality=lambda t: cards[t]),
        regions=[SimpleNamespace(approx_rows=lambda: est_rows,
                                 distinct_estimate=lambda t: 0)],
    )
    lowering = SimpleNamespace(agg_specs=aggs)
    jcfg = JaxConfig().query
    tcfg = QueryConfig(device="cpu")
    for k, v in knobs.items():
        setattr(jcfg, k, v)
        setattr(tcfg, k, v)
    jself = SimpleNamespace(config=jcfg, _bucket_geometry=lambda *a: geometry)
    jself._size_hash_slots = lambda d: JaxTileExecutor._size_hash_slots(jself, d)
    ref = JaxTileExecutor._choose_agg_strategy(jself, lowering, None, None, ctx, tags, None)
    real = tile_planner.bucket_geometry
    tile_planner.bucket_geometry = lambda *a: geometry
    try:
        port = tile_planner.choose_agg_strategy(tcfg, lowering, None, None, ctx, tags, None)
    finally:
        tile_planner.bucket_geometry = real
    return port, ref


PROBE_CASES = {
    # five tags of 40,000 values: 2^80 padded ids, past the int64 gid range
    "gid_limit": ({"agg_strategy": "hash"}, {t: 40_000 for t in "abcde"}, 10**6, 1, ()),
    "sparse": ({}, {"a": 1500, "b": 1500}, 30_000, 1, ()),
    "well_filled": ({"agg_hash_min_group_space": 1024}, {"host": 40}, 172_800, 12, ()),
    "below_min_space": ({}, {"host": 40}, 172_800, 12, ()),
    "cap_clamps_auto": ({"max_internal_groups": 4096}, {"a": 3000, "b": 7}, 20_000, 1, ()),
    "cap_clamps_forced": ({"max_internal_groups": 5000, "agg_strategy": "hash"},
                          {"a": 3000, "b": 7}, 20_000, 1, ()),
    "last_value": ({"agg_strategy": "hash"}, {"a": 1500, "b": 1500}, 30_000, 1,
                   (("last_value", "v"),)),
    "sort_forced": ({"agg_strategy": "sort"}, {"a": 1500, "b": 1500}, 30_000, 1, ()),
    "pass_disabled": ({"disabled_passes": ("agg_strategy",)}, {"a": 1500, "b": 1500},
                      30_000, 1, ()),
    "container_panel": ({}, {"namespace": 100, "pod": 4000, "container": 20}, 5_760_000, 72,
                        ()),
}


@pytest.mark.parametrize("case", sorted(PROBE_CASES))
def test_strategy_probe_matches_reference(case):
    """The probe's verdict, slot count and estimates against the
    reference's on the same statistics, the gid-range decline included
    (tests/test_agg_strategy.py:275): hash is declined before any id is
    composed."""
    assert HASH_GID_LIMIT == _HASH_GID_LIMIT == 1 << 62
    knobs, cards, est_rows, n_buckets, aggs = PROBE_CASES[case]
    port, ref = _probe_pair(knobs, cards, est_rows, n_buckets, aggs)
    if ref is None:
        assert port is None
    else:
        assert port is not None
        for key in ("strategy", "slots", "d_est", "g_est"):
            assert port[key] == ref[key], (key, port[key], ref[key])
    expect = {"gid_limit": None, "sparse": "hash", "well_filled": None,
              "below_min_space": None, "cap_clamps_auto": None, "cap_clamps_forced": "hash",
              "last_value": None, "sort_forced": None, "pass_disabled": None,
              "container_panel": "hash"}[case]
    assert (None if port is None else port["strategy"]) == expect
    if case == "container_panel":
        assert port["slots"] == 1 << 24 and port["d_est"] == 5_760_000


def test_disabled_pass_forces_sort(tmp_path):
    """Disabling the agg_strategy pass is `sort`, bit for bit
    (tests/test_agg_strategy.py:215)."""
    pair = _Pair(tmp_path)
    try:
        _load_random(pair, 10_000, 300, 9)
        pair.set(agg_strategy="sort")
        t1 = pair.port.sql_one(PARITY_Q)
        pair.set(agg_strategy="hash")
        pair.port.config.query.disabled_passes = HOST_ROUTES + ("agg_strategy",)
        h0 = pair.port.query_engine.stats["agg_hash"]
        t2 = pair.port.sql_one(PARITY_Q)
        assert pair.port.query_engine.stats["agg_hash"] == h0
        assert _ser(t1) == _ser(t2)
    finally:
        pair.close()
