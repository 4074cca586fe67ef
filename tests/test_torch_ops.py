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


# ---- the blocked fold's order (csrc/block_layout.cuh) ------------------------------------

# Layouts that pass the blocked guard: rising bases (host x hour over
# host-major rows), falling bases (hour alone over 16 h of hosts: a block
# inside one host starts at its hour, the next, crossing into the next
# host, at 0), an all-masked block mid-stream (base = G), one block, and
# G <= 16.
FOLD_LAYOUTS = ["rising", "falling", "masked_mid", "single_block", "small_g"]


def fold_layout(name: str, seed: int = 17):
    """(gids int32 [n], mask bool [n], G), n a multiple of 4096."""
    rng = np.random.default_rng(seed)
    L = tagg.BLOCK_ROWS
    if name in ("rising", "masked_mid", "falling"):
        hosts, hours, per = (60, 16, 360) if name == "falling" else (24, 16, 360)
        hour = np.tile(np.repeat(np.arange(hours), per), hosts)
        host = np.repeat(np.arange(hosts), hours * per)
        g = hour if name == "falling" else host * hours + hour
        G = hours if name == "falling" else hosts * hours
    elif name == "single_block":
        g, G = np.sort(rng.integers(0, 10, L - 100)), 10
    else:  # small_g: a time-major plan's bucket ids
        g, G = np.sort(rng.integers(0, 12, 40 * L)), 12
    n = -(-g.size // L) * L
    gids = np.zeros(n, np.int32)
    gids[:g.size] = g
    mask = np.zeros(n, bool)
    mask[:g.size] = rng.random(g.size) < 0.95
    if name == "masked_mid":
        mask[5 * L:8 * L] = False
    return gids, mask, G


def fold_emulated(parts, base, occ, G: int, add, init, order: str = "block"):
    """The fold of [nb, 16] block partials into [G], group by group: in the
    kernels' order (covering_blocks_plain: block order, empty slots
    skipped), or in the (base, block) order of a fold over sorted bases."""
    keylo, keyhi, mode = tagg.block_layout_plain(base, occ)
    out = []
    for g in range(G):
        if order == "block":
            blocks = tagg.covering_blocks_plain(base, occ, keylo, keyhi, mode, g)
        else:
            blocks = sorted((int(base[b]), b) for b in range(base.shape[0])
                            if 0 <= g - int(base[b]) < tagg.BLOCK_SPAN)
            blocks = [(b, g - bb) for bb, b in blocks]
        acc = init
        for b, j in blocks:
            acc = add(acc, parts[b][j])
        out.append(acc)
    return out


@pytest.mark.parametrize("layout", FOLD_LAYOUTS)
def test_blocked_fold_order_emulation_matches_reference(layout):
    """K2's fold as the kernels run it — the block layout's keys and mode,
    the covering range, blocks added in block order — over per-block
    partials (row order inside a block, as the plain version forms them),
    against the reference's segment_aggregate: sums within rel 1e-12,
    count, min and max exact.  On falling bases a fold in (base, block)
    order gives other bytes."""
    gids, mask, G = fold_layout(layout)
    rng = np.random.default_rng(3)
    v = rng.uniform(-1e3, 1e3, gids.size) * np.exp(rng.uniform(-20, 20, gids.size))
    ok, base = tagg.block_guard_plain(_t(gids), _t(mask), G)
    assert ok
    occ = tagg.block_occupancy_plain(_t(gids), _t(mask), base)
    nb, K = base.shape[0], tagg.BLOCK_SPAN
    slot = np.where(mask, np.arange(gids.size) // tagg.BLOCK_ROWS * K
                    + gids - np.repeat(base.numpy(), tagg.BLOCK_ROWS), nb * K)
    psum = torch.zeros(nb * K + 1, dtype=torch.float64).index_add_(
        0, _t(slot), _t(np.where(mask, v, 0.0)))[:-1].reshape(nb, K).numpy()
    pcnt = np.bincount(slot, minlength=nb * K + 1)[:-1].reshape(nb, K)
    pmin = np.full(nb * K + 1, np.inf)
    np.minimum.at(pmin, slot, np.where(mask, v, np.inf))
    pmax = np.full(nb * K + 1, -np.inf)
    np.maximum.at(pmax, slot, np.where(mask, v, -np.inf))
    sums = fold_emulated(psum, base, occ, G, lambda a, x: a + float(x), 0.0)
    ref = jagg.segment_aggregate(jnp.asarray(v), jnp.asarray(gids), G, ("count", "max", "min", "sum"),
                                 mask=jnp.asarray(mask), acc_dtype=jnp.float64)
    _close(np.array(sums), ref.sums, False, f"{layout} sums")
    _close(np.array(fold_emulated(pcnt, base, occ, G, lambda a, x: a + int(x), 0), np.int32),
           ref.counts, True, f"{layout} counts")
    mins = fold_emulated(pmin[:-1].reshape(nb, K), base, occ, G, min, np.inf)
    maxs = fold_emulated(pmax[:-1].reshape(nb, K), base, occ, G, max, -np.inf)
    present = np.asarray(ref.counts) > 0
    _close(np.array(mins)[present], np.asarray(ref.mins)[present], True, f"{layout} mins")
    _close(np.array(maxs)[present], np.asarray(ref.maxs)[present], True, f"{layout} maxs")
    keylo, keyhi, mode = tagg.block_layout_plain(base, occ)
    assert mode == (layout == "falling")
    if layout == "falling":
        other = fold_emulated(psum, base, occ, G, lambda a, x: a + float(x), 0.0, "base")
        assert not np.array_equal(np.array(other), np.array(sums))


# ---- K4's partials kernel (csrc/segment_last.cu) ------------------------------------------

I64_MIN = np.iinfo(np.int64).min

# Layouts that pass the blocked guard: host-major ids (lastpoint's), falling
# bases (hour alone over 16 h of hosts), blocks whose warps each span all
# 16 slots, all-masked warps and a whole all-masked block, and ts ties
# within and across warps and blocks (every group's rows share 3 ts).
K4_LAYOUTS = ["host_major", "falling", "warp_spans_16", "masked_warps_blocks", "ts_ties"]


def k4_layout(name: str):
    """(gids int32, mask bool, ts int64, G) with a ragged last block."""
    rng = np.random.default_rng(len(name))
    L = tagg.BLOCK_ROWS
    if name == "falling":
        gids, mask, G = fold_layout("falling")
        gids, mask = gids[:-1000], mask[:-1000]
    elif name == "warp_spans_16":
        nb, G = 6, 96
        n = nb * L - 333
        gids = (np.arange(n) // L * 16 + rng.integers(0, 16, n)).astype(np.int32)
        mask = rng.random(n) < 0.9
    else:  # host-major runs of 1000 rows, 37 hosts
        G = 37
        gids = np.repeat(np.arange(G, dtype=np.int32), 1000)
        mask = rng.random(gids.size) < 0.9
        if name == "masked_warps_blocks":
            mask[512:1536] = False          # warps 1 and 2 of block 0
            mask[3 * L + 100:3 * L + 612] = False  # parts of two warps
            mask[5 * L:6 * L] = False       # block 5
    n = gids.size
    if name == "ts_ties":
        ts = (T0 + rng.integers(0, 3, n) * 1000).astype(np.int64)
    else:
        ts = (T0 + rng.integers(0, 10**6, n)).astype(np.int64)
    return gids.astype(np.int32), mask, ts, G


def k4_partials_emulated(gids, mask, ts, base):
    """K4's blocked partials as the kernel forms them: per block, warp w
    owns rows [512 w, 512 w + 512), lane l the quads 4l..4l+3 of each
    128-row stretch; a row counts where it is masked in and id - base lies
    in [0, 16); each warp reduces only the slots of its own range [klo,
    khi] by the lexicographic max of (ts, row), and the block takes each
    slot from the warps whose range holds it.  Returns (pts, prow, occ)."""
    L, K, n = tagg.BLOCK_ROWS, tagg.BLOCK_SPAN, gids.size
    nb = base.shape[0]
    i = np.arange(16)
    lane_rows = (i[None, :] >> 2) * 128 + 4 * np.arange(32)[:, None] + (i[None, :] & 3)
    pts = np.full((nb, K), I64_MIN, np.int64)
    prow = np.full((nb, K), -1, np.int32)
    occ = np.zeros(nb, np.uint32)
    for b in range(nb):
        sh = {}
        ranges = []
        for w in range(8):
            rows = (b * L + w * 512 + lane_rows).reshape(-1)
            inn = rows < n
            r = np.minimum(rows, n - 1)
            k = (np.where(inn, gids[r], 0).astype(np.int64) - int(base[b])) % (1 << 32)
            live = inn & mask[r] & (k < K)
            lo, hi = (int(k[live].min()), int(k[live].max())) if live.any() else (K, -1)
            ranges.append((lo, hi))
            for j in range(lo, hi + 1):
                sel = live & (k == j)
                if sel.any():
                    t = ts[r][sel].max()
                    sh[w, j] = (t, rows[sel & (ts[r] == t)].max())
                else:
                    sh[w, j] = (I64_MIN, -1)
        for j in range(K):
            best = (I64_MIN, -1)
            for w, (lo, hi) in enumerate(ranges):
                if lo <= j <= hi:
                    best = max(best, sh[w, j])
            pts[b, j], prow[b, j] = best
            occ[b] |= np.uint32(best[1] >= 0) << np.uint32(j)
    return pts, prow, occ


@pytest.mark.parametrize("layout", K4_LAYOUTS)
def test_last_partials_emulation_matches_reference(layout):
    """K4's warp-range partials, then the per-group max over the covering
    blocks' occupied slots (lex_max is order-free), equal the port's
    blocked plain form and the reference's `_segment_blocked_last`, byte
    for byte; the occupied slots are the blocks' masked slots."""
    gids, mask, ts, G = k4_layout(layout)
    n = gids.size
    v = np.random.default_rng(5).uniform(-1e3, 1e3, n)
    ok, base = tagg.block_guard_plain(_t(gids), _t(mask), G)
    assert ok
    pts, prow, occ = k4_partials_emulated(gids, mask, ts, base.numpy())
    np.testing.assert_array_equal(
        occ, tagg.block_occupancy_plain(_t(gids), _t(mask), base).numpy().astype(np.uint32))
    if layout == "warp_spans_16":  # every warp of the first block spans 16 slots
        assert occ[0] == 0xFFFF
    last_ts = np.full(G, I64_MIN, np.int64)
    pick = np.full(G, -1, np.int64)
    b64 = base.numpy().astype(np.int64)
    for b in range(b64.size):
        for j in range(tagg.BLOCK_SPAN):
            g = b64[b] + j
            if prow[b, j] >= 0 and g < G and (pts[b, j], prow[b, j]) > (last_ts[g], pick[g]):
                last_ts[g], pick[g] = pts[b, j], prow[b, j]
    last_val = v[np.clip(pick, 0, n - 1)]
    plain = tagg.segment_last_plain(_t(v), _t(ts), _t(gids), _t(mask), G, base=base)
    _close(plain[0], last_ts, True, f"{layout} plain last_ts")
    _close(plain[1], last_val, True, f"{layout} plain last_val")
    nbf = n // tagg.BLOCK_ROWS
    ref = jagg._segment_blocked_last(jnp.asarray(v), jnp.asarray(gids), G, ("last",),
                                     jnp.asarray(mask), jnp.asarray(ts), jnp.float64,
                                     jnp.asarray(base.numpy()[:nbf]))
    _close(last_ts, ref.last_ts, True, f"{layout} reference last_ts")
    _close(last_val, ref.last_val, True, f"{layout} reference last_val")


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


# K1's time bucket on the card (csrc/mask_gids.cu `floor_div_of`, `floor_div`):
# a magic reciprocal of |interval| per CTA, then a multiply-high, an add and
# two shifts a row, emulated here in Python integers
M64 = (1 << 64) - 1
I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1


def _wrap64(x: int) -> int:
    return (x + (1 << 63) & M64) - (1 << 63)


def _magic(v: int):
    """(m, sh1, sh2, v > 0) of the interval v, as `floor_div_of` makes them."""
    u = -v & M64 if v < 0 else v
    if u <= 1:
        return 0, 0, 0, v > 0
    l = (u - 1).bit_length()  # 64 - __clzll(u - 1)
    r, q = (1 << l) - u, 0
    for _ in range(64):
        r, q = r << 1, q << 1
        if r >= u:
            r, q = r - u, q | 1
    return (q + 1) & M64, 1, l - 1, v > 0


def _bucket_emulated(ts: int, origin: int, magic) -> int:
    """K1's bucket of one row: the wrapped offset floor-divided by the
    magic, then the wrapping int32 cast."""
    m, sh1, sh2, pos = magic
    d = _wrap64(ts - origin)
    du = d & M64
    if pos:
        flip, num = d < 0, ~du & M64 if d < 0 else du
    else:
        flip, num = d > 0, (du - 1) & M64 if d > 0 else -du & M64
    t = (m * num) >> 64
    q = (t + ((num - t) >> sh1)) >> sh2
    assert q <= M64
    if flip:
        q = ~q & M64
    return (q + (1 << 31) & 0xFFFFFFFF) - (1 << 31)


K1_INTERVALS = (1, -1, 2, 3, 7, -7, 1000, 60_000, 3_600_000, -3_600_000, 1 << 32, -(1 << 32),
                (1 << 32) + 1, -(1 << 32) - 7, (1 << 62) + 3, -(1 << 63), I64_MAX)


@pytest.mark.parametrize("interval", K1_INTERVALS)
def test_k1_bucket_division_emulation_matches_reference(interval):
    """The kernel's division, emulated, equals the reference's time_bucket
    (and the port's plain one) for every sign of the offset and the
    interval, |interval| past 2^32, quotients past int32 (they wrap) and
    ts and the origin at the int64 ends."""
    rng = np.random.default_rng(abs(interval) % 9973)
    magic = _magic(interval)
    for origin in (0, T0, -T0, I64_MIN, I64_MAX):
        ts = [I64_MIN, I64_MIN + 1, -1, 0, 1, I64_MAX - 1, I64_MAX,
              _wrap64(origin + (1 << 31) + 5), _wrap64(origin - (1 << 40) - 3)]
        for j in range(-3, 4):
            for e in (-1, 0, 1):
                ts.append(_wrap64(origin + j * min(abs(interval), 1 << 61) + e))
        ts += [int(x) for x in rng.integers(I64_MIN, I64_MAX, 40, dtype=np.int64, endpoint=True)]
        got = [_bucket_emulated(x, origin, magic) for x in ts]
        ref = np.asarray(jagg.time_bucket(jnp.asarray(np.array(ts, np.int64)), origin, interval))
        assert got == ref.tolist(), f"origin {origin}"
        # the port's plain form (torch's floor division traps on -2^63 // -1)
        ok = [x for x in ts if not (interval == -1 and _wrap64(x - origin) == I64_MIN)]
        plain = tflt.time_bucket(torch.tensor(ok, dtype=torch.int64), origin, interval)
        assert plain.tolist() == [_bucket_emulated(x, origin, magic) for x in ok], f"origin {origin}"


def _k1_reference(cols, valid, present, filters, tags, bucket):
    """compute_partial_states' mask / group-id prologue of the reference."""
    origin, interval, nb = bucket
    cards = [c for _t, c in tags]
    G = int(np.prod(cards)) * nb
    plan = DistGroupByPlan(group_tags=tuple(t for t, _c in tags), tag_cards=tuple(cards),
                           bucket_col="ts", bucket_origin=origin, bucket_interval=interval,
                           n_buckets=nb, agg_specs=(), filters=tuple(filters))
    jcols = {k: jnp.asarray(v) for k, v in cols.items()}
    jmask = _apply_filters(plan, jcols, jnp.asarray(valid)) & jnp.asarray(present)
    comps = [(jcols[t], c) for t, c in tags] + [(jagg.time_bucket(jcols["ts"], origin, interval), nb)]
    jg, in_range = jagg.raw_group_ids(comps, shape=valid.shape)
    return jnp.where(jnp.asarray(valid), jg, G - 1), jmask & in_range


def test_k1_layout_reused_across_literal_values():
    """K1's cached structure: calls with the same structure and other
    literal values, origin and interval in `lits` (the tile program's
    form) reuse one layout and each match the reference; another
    structure (an IN-list of another length, a non-integral literal on an
    integer plane) builds its own."""
    rng = np.random.default_rng(17)
    n = 5000 + 3
    cols = {"code": rng.integers(-1, 40, n).astype(np.int32),
            "ts": (T0 + rng.integers(-10**8, 10**8, n)).astype(np.int64),
            "f": rng.uniform(0, 100, n), "i": rng.integers(0, 12, n).astype(np.int32)}
    valid, present = np.arange(n) < n - 7, rng.random(n) < 0.9
    tcols = {k: _t(v) for k, v in cols.items()}
    tags = [("code", 64)]

    def run(filters, bucket, lit_filters=None):
        lit_filters = filters if lit_filters is None else lit_filters
        lits = _t(np.array(tflt.literal_table([(tcols[c].dtype, op, v) for c, op, v in lit_filters],
                                              bucket[0], bucket[1]), np.int64))
        structure = [(tcols[c], op, v) for c, op, v in filters]
        # the structure's values and bucket stand in; lits carries the real ones
        got = tflt.mask_gids(_t(valid), structure, [_t(present)], [(tcols["code"], 64)],
                             (tcols["ts"], 0, 1, bucket[2]), 64 * bucket[2] - 1, lits=lits)
        ref = _k1_reference(cols, valid, present, lit_filters, tags, bucket)
        _close(got[0], ref[0], True, f"{lit_filters} gids")
        _close(got[1], ref[1], True, f"{lit_filters} mask")
        return tflt.k1_layout(structure, [_t(present)], [(tcols["code"], 64)],
                              (tcols["ts"], 0, 1, bucket[2]), 64 * bucket[2] - 1)

    tflt._LAYOUTS.clear()
    a = [("f", ">", 10.0), ("code", "in", (3, 5, 7)), ("i", "<", 9)]
    b = [("f", ">", 55.5), ("code", "in", (1, 2, 39)), ("i", "<", 4)]
    first = run(a, (T0, 3_600_000, 16))
    again = run(a, (T0 - 7 * 3_600_000, -900_000, 16), lit_filters=b)
    assert again is first and len(tflt._LAYOUTS) == 1
    longer = run([("f", ">", 10.0), ("code", "in", (3, 5)), ("i", "<", 9)], (T0, 60_000, 16))
    frac = run([("f", ">", 10.0), ("code", "in", (3, 5, 7)), ("i", "<", 8.5)], (T0, 60_000, 16))
    assert len({id(first), id(longer), id(frac)}) == 3 and len(tflt._LAYOUTS) == 3
    assert frac.convert[2] == torch.float64 and first.convert == (None, None, None)
    assert [sp[3] for sp in longer.specs] == [1, 2, 1]


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
