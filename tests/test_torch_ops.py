"""Plain K1-K4 of the port (greptimedb_tpu_torch/ops) against the
reference JAX functions on the same numpy-seeded inputs, on the CPU.

Tolerances: group ids, masks, counts, min, max and last_value exact;
float64 sums within rel 1e-12 (only the order of additions differs)."""

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from greptimedb_tpu.ops import aggregate as jagg
from greptimedb_tpu.ops import tiles as jtiles
from greptimedb_tpu.parallel.executor import DistGroupByPlan, _apply_filters
from greptimedb_tpu_torch.ops import aggregate as tagg
from greptimedb_tpu_torch.ops import filter as tflt
from greptimedb_tpu_torch.ops import tiles as ttiles

T0 = 1_767_225_600_000
RTOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test workers on one machine: keep torch's CPU
    ops on one thread so they do not starve timing-sensitive tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(port, ref, exact, what):
    port = port.numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, what
    if exact:
        np.testing.assert_array_equal(port, ref, err_msg=what)
    else:
        np.testing.assert_allclose(port, ref, rtol=RTOL, atol=0, err_msg=what)


def _check_state(port, ref, what):
    for name in ("sums", "counts", "mins", "maxs", "last_ts", "last_val"):
        p, r = getattr(port, name), getattr(ref, name)
        assert (p is None) == (r is None), f"{what}.{name}"
        if p is not None:
            _close(p, r, exact=name != "sums", what=f"{what}.{name}")


# ---- inputs ---------------------------------------------------------------------


def _layout(case, n, G, rng):
    """Group ids of a given layout: clustered (sorted, the (pk, ts) scan),
    or shuffled (any order)."""
    g = np.sort(rng.integers(0, G, n)).astype(np.int32)
    if case == "shuffled":
        g = rng.permutation(g)
    return g


def _values(kind, n, rng):
    v = rng.uniform(0.0, 100.0, n)
    if kind == "specials":
        v[rng.choice(n, 25, replace=False)] = np.nan
        v[rng.choice(n, 25, replace=False)] = np.inf
        v[rng.choice(n, 25, replace=False)] = -np.inf
    return v


CASES = [
    # (layout, n, values, nulls, all_masked_blocks)
    ("clustered", 1 << 17, "plain", False, False),
    ("clustered", (1 << 17) + 1234, "plain", True, True),  # ragged tail
    ("clustered", 1 << 17, "specials", True, False),
    ("shuffled", 1 << 17, "plain", True, False),
    ("shuffled", 5000, "specials", False, False),  # under 2^16 rows
    ("clustered", 3000, "plain", True, True),
]


def _case_inputs(case):
    layout, n, vkind, nulls, dead = case
    rng = np.random.default_rng(abs(hash(case)) % (1 << 32))
    G = 300
    g = _layout(layout, n, G, rng)
    mask = rng.random(n) < 0.9
    if dead:
        mask[4096: 4096 * 4] = False
    vals = [_values(vkind, n, rng), rng.uniform(0.0, 1.0, n)]
    cm = [mask & (rng.random(n) < 0.8) if nulls else mask, mask]
    return g, mask, vals, cm, G


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}-nulls{c[3]}-dead{c[4]}")
def test_segment_aggregate_multi_matches_reference(case):
    g, mask, vals, cm, G = _case_inputs(case)
    aggs = ("count", "max", "min", "sum")
    ref = jagg.segment_aggregate_multi(
        [jnp.asarray(v) for v in vals], jnp.asarray(g), G, aggs,
        [jnp.asarray(m) for m in cm], jnp.asarray(mask), acc_dtype=jnp.float64,
    )
    port = tagg.segment_aggregate_multi(
        [_t(v) for v in vals], _t(g), G, aggs, [_t(m) for m in cm], _t(mask),
    )
    _check_state(port, ref, "multi")


@pytest.mark.parametrize("layout", ["clustered", "shuffled"])
def test_blocked_guard_picks_the_reference_branch(layout):
    rng = np.random.default_rng(5)
    n, G = 1 << 17, 300
    g = _layout(layout, n, G, rng)
    mask = np.ones(n, bool)
    ok, base = tagg.block_guard_plain(_t(g), _t(mask), G)
    assert ok == (layout == "clustered")
    if ok:
        ok2, st, _ = tagg.segment_reduce_blocked_plain(
            [_t(rng.uniform(0, 1, n))], _t(g), [_t(mask)], _t(mask), G, ("sum",))
        assert ok2 and st.sums.shape == (1, G)
    assert base.shape == (n // tagg.BLOCK_ROWS,)


@pytest.mark.parametrize("case", CASES[:4], ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
def test_scatter_matches_reference_segment_scatter(case):
    g, mask, vals, cm, G = _case_inputs(case)
    aggs = ("count", "max", "min", "sum")
    for v, m in zip(vals, cm):
        ref = jagg._segment_scatter(jnp.asarray(v), jnp.asarray(g), G, aggs,
                                    jnp.asarray(m), None, jnp.float64)
        port = tagg.segment_reduce_scatter([_t(v)], _t(g), [_t(m)], _t(mask), G, aggs)
        _check_state(port.row(0), ref, "scatter")


@pytest.mark.parametrize("layout", ["clustered", "shuffled"])
@pytest.mark.parametrize("n", [1 << 17, (1 << 16) + 777, 4000])
def test_last_value_matches_reference(layout, n):
    rng = np.random.default_rng(n)
    G = 257
    g = _layout(layout, n, G, rng)
    ts = (T0 + rng.integers(0, 40, n) * 1000).astype(np.int64)  # many ts ties
    v = rng.uniform(0, 100, n)
    mask = rng.random(n) < 0.85
    aggs = ("count", "last")
    ref = jagg.segment_aggregate(jnp.asarray(v), jnp.asarray(g), G, aggs, mask=jnp.asarray(mask),
                                 ts=jnp.asarray(ts), acc_dtype=jnp.float64)
    port = tagg.segment_aggregate(_t(v), _t(g), G, aggs, mask=_t(mask), ts=_t(ts))
    _check_state(port, ref, "last")


def test_last_value_blocked_and_scatter_forms_agree():
    """The blocked form (K2's bases) and the scatter form of K4 give the
    same winners, ties going to the later row."""
    rng = np.random.default_rng(3)
    n, G = 1 << 17, 100
    g = np.sort(rng.integers(0, G, n)).astype(np.int32)
    ts = (T0 + rng.integers(0, 5, n) * 1000).astype(np.int64)
    v = rng.uniform(0, 1, n)
    mask = torch.ones(n, dtype=torch.bool)
    ok, base = tagg.block_guard_plain(_t(g), mask, G)
    assert ok
    a = tagg.segment_last_plain(_t(v), _t(ts), _t(g), mask, G, base=base)
    b = tagg.segment_last_plain(_t(v), _t(ts), _t(g), mask, G)
    _close(a[0], b[0].numpy(), True, "ts")
    _close(a[1], b[1].numpy(), True, "val")
    # the winner of each group is its last row at the max ts
    for grp in (0, 50, 99):
        rows = np.nonzero(g == grp)[0]
        best = rows[ts[rows] == ts[rows].max()][-1]
        assert a[1][grp].item() == v[best]


# ---- K1 -------------------------------------------------------------------------------


K1_CASES = {
    "range+tag": [("ts", ">=", T0 - 5 * 3_600_000), ("ts", "<", T0 + 3 * 3_600_000)],
    "in+nan": [("f", ">", 90.0), ("code", "in", (3, 5, -1, 39)), ("f", "!=", 95.5)],
    "not-in+int": [("code", "not in", (1, 2)), ("i", "<=", 7), ("f", "<=", float("inf"))],
    "f32": [("h", ">", 0.1), ("h", "<", 0.7)],
}


@pytest.mark.parametrize("name", sorted(K1_CASES))
def test_mask_gids_matches_reference(name):
    rng = np.random.default_rng(len(name))
    n = 20_000 + 321
    f = rng.uniform(0, 100, n)
    f[rng.choice(n, 300, replace=False)] = np.nan
    f[rng.choice(n, 300, replace=False)] = np.inf
    cols = {
        "code": rng.integers(-1, 40, n).astype(np.int32),  # -1: unseen literal
        "code2": rng.integers(0, 5, n).astype(np.int32),
        "ts": (T0 + rng.integers(-10**8, 10**8, n)).astype(np.int64),  # negative offsets
        "f": f,
        "i": rng.integers(0, 12, n).astype(np.int32),
        "h": rng.uniform(0, 1, n).astype(np.float32),
    }
    valid = np.arange(n) < n - 99
    present = rng.random(n) < 0.9
    filters = K1_CASES[name]
    tags = [("code", 64), ("code2", 8)]
    origin, interval, nb = T0 - 3_600_000, 3_600_000, 16
    G = 64 * 8 * nb
    # reference: compute_partial_states' mask / group-id prologue
    plan = DistGroupByPlan(group_tags=("code", "code2"), tag_cards=(64, 8), bucket_col="ts",
                           bucket_origin=origin, bucket_interval=interval, n_buckets=nb,
                           agg_specs=(), filters=tuple(filters))
    jcols = {k: jnp.asarray(v) for k, v in cols.items()}
    jmask = _apply_filters(plan, jcols, jnp.asarray(valid)) & jnp.asarray(present)
    comps = [(jcols[t], c) for t, c in tags] + [(jagg.time_bucket(jcols["ts"], origin, interval), nb)]
    jg, in_range = jagg.raw_group_ids(comps, shape=valid.shape)
    jmask = jmask & in_range
    jg = jnp.where(jnp.asarray(valid), jg, G - 1)
    tcols = {k: _t(v) for k, v in cols.items()}
    pg, pm = tflt.mask_gids(
        _t(valid), [(tcols[c], op, v) for c, op, v in filters], [_t(present)],
        [(tcols[t], c) for t, c in tags], (tcols["ts"], origin, interval, nb), G - 1,
    )
    _close(pg, jg, True, "gids")
    _close(pm, jmask, True, "mask")


def test_time_bucket_floors_negative_offsets():
    ts = torch.tensor([-1, -3_600_000, -3_600_001, 0, 3_599_999], dtype=torch.int64)
    got = tflt.time_bucket(ts, 0, 3_600_000).tolist()
    assert got == [-1, -1, -2, 0, 0]
    ref = np.asarray(jagg.time_bucket(jnp.asarray(ts.numpy()), 0, 3_600_000)).tolist()
    assert got == ref


# ---- tiles and carried state -------------------------------------------------------------


def _table(rng, n):
    host = pa.array([f"h{int(i)}" if i % 7 else None for i in rng.integers(0, 30, n)])
    val = pa.array([None if i % 11 == 0 else float(x) for i, x in enumerate(rng.uniform(0, 1, n))])
    return pa.table({
        "host": host,
        "ts": pa.array((T0 + np.arange(n) * 1000).astype(np.int64), pa.timestamp("ms")),
        "v": val,
        "k": pa.array(rng.integers(0, 9, n).astype(np.int32)),
    })


@pytest.mark.parametrize("pinned", [False, True])
def test_tiles_from_table_matches_reference(pinned):
    rng = np.random.default_rng(9)
    table = _table(rng, 5000)
    dicts = None
    if pinned:
        dicts = {"host": {v: i for i, v in enumerate(["h3", None, "h1", "h29", "zz"])}}
    ref = jtiles.tiles_from_table(table, dicts=dicts)
    port = ttiles.tiles_from_table(table, dicts=dicts)
    n = ref.num_rows
    # the reference pads to a power of two, the port to whole 4096-row
    # blocks: the real rows must agree exactly, the padding is empty
    assert port.num_rows == n and port.padded_rows == 8192
    assert port.dicts == ref.dicts
    planes = [(port.columns[k], ref.columns[k], k) for k in ref.columns]
    planes += [(port.valid, ref.valid, "valid")]
    assert set(port.nulls) == set(ref.nulls)
    planes += [(port.nulls[k], ref.nulls[k], f"nulls {k}") for k in ref.nulls]
    for p, r, what in planes:
        _close(p[:n], np.asarray(r)[:n], True, what)
        assert not p[n:].any(), f"{what}: padding rows are not empty"


def test_tile_batch_and_state_carry_across():
    rng = np.random.default_rng(4)
    ref = jtiles.tiles_from_table(_table(rng, 3000))
    port = ttiles.tile_batch_from_numpy(
        {k: np.asarray(v) for k, v in ref.columns.items()}, np.asarray(ref.valid),
        {k: np.asarray(v) for k, v in ref.nulls.items()}, ref.dicts, "cpu",
        num_rows=ref.num_rows,
    )
    for k in ref.columns:
        _close(port.columns[k], ref.columns[k], True, k)
    _close(port.valid, ref.valid, True, "valid")
    assert port.dicts == ref.dicts and port.num_rows == ref.num_rows
    st = jagg.AggState(sums=jnp.arange(4.0), counts=jnp.arange(4, dtype=jnp.int32))
    carried = tagg.AggState.from_numpy(sums=np.asarray(st.sums), counts=np.asarray(st.counts))
    merged = tagg.merge_states(carried, carried)
    ref_m = jagg.merge_states(st, st)
    _close(merged.sums, ref_m.sums, True, "sums")
    _close(merged.counts, ref_m.counts, True, "counts")
    fin = tagg.finalize(merged, ("avg", "count"))
    ref_f = jagg.finalize(ref_m, ("avg", "count"))
    for k in ref_f:
        _close(fin[k], ref_f[k], True, k)


def test_reduce_state_axes_matches_reference():
    rng = np.random.default_rng(8)
    cards = (4, 3, 5)
    st = jagg.AggState(sums=jnp.asarray(rng.uniform(0, 1, 60)),
                       counts=jnp.asarray(rng.integers(0, 9, 60).astype(np.int32)),
                       mins=jnp.asarray(rng.uniform(0, 1, 60)),
                       maxs=jnp.asarray(rng.uniform(0, 1, 60)))
    port = tagg.AggState.from_numpy(**{k: np.asarray(getattr(st, k)) for k in ("sums", "counts", "mins", "maxs")})
    for keep in [(2, 0), (1,), (0, 1, 2), (2, 1, 0)]:
        _check_state(tagg.reduce_state_axes(port, cards, keep), jagg.reduce_state_axes(st, cards, keep),
                     f"fold {keep}")
