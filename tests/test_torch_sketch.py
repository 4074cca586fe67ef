"""The approximate sketch aggregates of the port against the JAX package,
on the CPU.

* every host function of `ops/sketch.py` against the reference's:
  `splitmix64`, `hash64` on every type branch, `hll_inputs` at the extreme
  hashes, `hll_build(_grouped)`, `hll_estimate` in its linear-counting and
  large ranges, serialized HLL and UDDSketch states byte for byte, the
  collapsing `UddSketch` (collapse, merge, the mismatched-error
  `ValueError`, quantiles), and the fixed-range `udd_*` helpers;
* K20's and K21's plain versions (`segment_hll` / `segment_udd` on CPU
  tensors) against the reference's `segment_hll` / `segment_udd`, int32
  bytes equal: empty groups, rho <= 0, negative and out-of-range gids
  with the int32 wrap, masked rows, G = 1, N = 0;
* K20's ordered path: the decision (sorted gids in [0, G), reg_idx in
  [0, m), G * m < 2^31, m within the shared-memory budget) and its result
  built from one register row per group, against the reference;
* the two-step merge: the reference's 8-device `shard_map` (`pmax` /
  `psum`) against the port's per-shard partials folded in shard order;
* `Database.sql` through both packages: the scenarios of
  tests/test_sketch.py::test_sql_sketch_aggregates, the sqlness golden
  approx_aggregates.sql, NULLs, an empty table, mismatched
  `uddsketch_merge` parameters, and the decline of sketch queries to the
  CPU executor on both device routes.

Everything here is exact: the states are integers (registers, counts)
and the finalizers run the same numpy code on the same states, so result
tables are compared value for value and states byte for byte."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

import chip_smoke
from greptimedb_tpu.database import Database as JaxDatabase
from greptimedb_tpu.ops import sketch as jsk
from greptimedb_tpu.utils.config import Config as JaxConfig
from greptimedb_tpu_torch import Database
from greptimedb_tpu_torch.ops import sketch as psk
from greptimedb_tpu_torch.utils.errors import PlanError
from test_torch_tile import HOST_ROUTES, UNPORTED_PASSES

GAMMA = (1 + 0.01) / (1 - 0.01)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test workers on one machine: keep torch's CPU
    ops on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- hashing ------------------------------------------------------------------


def _columns():
    rng = np.random.default_rng(0)
    strs = [None if i % 7 == 3 else f"host_{rng.integers(0, 50)}" for i in range(300)]
    floats = rng.normal(0, 1e3, 300)
    floats[[0, 1, 2, 3]] = [0.0, -0.0, np.nan, -np.nan]
    return {
        "string": pa.array(strs),
        "large_string": pa.array(strs, pa.large_string()),
        "binary": pa.array([None if s is None else s.encode() for s in strs], pa.binary()),
        "dictionary": pa.array(strs).dictionary_encode(),
        "chunked": pa.chunked_array([pa.array(strs[:100]), pa.array(strs[100:])]),
        "float64": pa.array(floats),
        "float64_nulls": pa.array([None if i % 5 == 0 else v for i, v in enumerate(floats)],
                                  pa.float64()),
        "float32": pa.array(floats.astype(np.float32)),
        "int64": pa.array(rng.integers(-2**62, 2**62, 300)),
        "int32_nulls": pa.array([None if i % 9 == 0 else int(v) for i, v in
                                 enumerate(rng.integers(-2**31, 2**31 - 1, 300))], pa.int32()),
        "uint8": pa.array(rng.integers(0, 256, 300).astype(np.uint8)),
        "timestamp": pa.array(rng.integers(0, 2**45, 300), pa.timestamp("ms")),
        "bool": pa.array([None if i % 4 == 0 else bool(i % 3) for i in range(300)]),
    }


@pytest.mark.parametrize("kind", sorted(_columns()))
def test_hash64_matches_reference(kind):
    col = _columns()[kind]
    got, want = psk.hash64(col), jsk.hash64(col)
    assert got.dtype == want.dtype == np.uint64
    np.testing.assert_array_equal(got, want)


def test_hash64_signed_zero_and_nulls():
    h = psk.hash64(pa.array([0.0, -0.0, None], pa.float64()))
    assert h[0] == h[1]
    s = pa.array(["a", None, "a"])
    np.testing.assert_array_equal(psk.hash64(s), psk.hash64(s.dictionary_encode()))
    assert psk.hash64(s)[1] == 0


def test_hash64_rejects_list_type_as_reference():
    col = pa.array([[1]], pa.list_(pa.int64()))
    with pytest.raises(TypeError) as got:
        psk.hash64(col)
    with pytest.raises(TypeError) as want:
        jsk.hash64(col)
    assert str(got.value) == str(want.value)


def test_splitmix64_matches_reference():
    x = np.concatenate([np.array([0, 1, 2**63, 2**64 - 1], np.uint64),
                        np.random.default_rng(1).integers(0, 2**63, 1000).astype(np.uint64)])
    np.testing.assert_array_equal(psk.splitmix64(x), jsk.splitmix64(x))


# ---- HyperLogLog ----------------------------------------------------------------


@pytest.mark.parametrize("p", [4, 12, 14, 16])
def test_hll_inputs_extremes(p):
    rng = np.random.default_rng(p)
    h = np.concatenate([np.array([0, 2**64 - 1, 1, 2**63, (1 << (64 - p)) - 1], np.uint64),
                        rng.integers(0, 2**63, 500).astype(np.uint64) * np.uint64(2)])
    gi, gr = psk.hll_inputs(h, p)
    wi, wr = jsk.hll_inputs(h, p)
    assert gi.dtype == wi.dtype and gr.dtype == wr.dtype
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gr, wr)
    assert gr[0] == 64 - p + 1 and gi[1] == (1 << p) - 1  # rho cap, top index


def test_hll_build_and_serialize_bytes():
    rng = np.random.default_rng(2)
    h = psk.hash64(pa.array(rng.integers(0, 10**9, 20_000)))
    for p in (4, 12, 14):
        got, want = psk.hll_build(h, p), jsk.hll_build(h, p)
        np.testing.assert_array_equal(got, want)
        assert psk.hll_serialize(got) == jsk.hll_serialize(want)
        np.testing.assert_array_equal(psk.hll_deserialize(jsk.hll_serialize(want)), want)
    gids = rng.integers(0, 7, h.shape[0])
    np.testing.assert_array_equal(psk.hll_build_grouped(h, gids, 7, 10),
                                  jsk.hll_build_grouped(h, gids, 7, 10))
    np.testing.assert_array_equal(psk.hll_merge(got, got[::-1]), jsk.hll_merge(got, got[::-1]))
    for bad in (psk, jsk):
        with pytest.raises(ValueError):
            bad.hll_deserialize(b"nope")


@pytest.mark.parametrize("m", [16, 32, 64, 128, 4096])
def test_hll_estimate_ranges(m):
    """Linear counting (few registers set), the raw estimate (all set,
    large values) and the [..., m] batch form, each equal to the
    reference's float."""
    rng = np.random.default_rng(m)
    sparse = np.zeros(m, np.uint8)
    sparse[rng.choice(m, max(1, m // 10), replace=False)] = 1
    full = rng.integers(1, 30, m).astype(np.uint8)
    empty = np.zeros(m, np.uint8)
    for regs in (sparse, full, empty):
        assert psk.hll_estimate(regs) == jsk.hll_estimate(regs)
    batch = np.stack([sparse, full, empty])
    np.testing.assert_array_equal(psk.hll_estimate(batch), jsk.hll_estimate(batch))


# ---- UDDSketch ----------------------------------------------------------------------


def _udd_pair(nb, err, *chunks):
    a, b = psk.UddSketch(nb, err), jsk.UddSketch(nb, err)
    for c in chunks:
        a.add_array(c)
        b.add_array(c)
    return a, b


def test_udd_build_collapse_and_bytes():
    rng = np.random.default_rng(3)
    mix = np.concatenate([-rng.lognormal(1, 2, 3000), np.zeros(50), rng.lognormal(0, 4, 5000),
                          [np.nan] * 5])
    for nb, err in ((128, 0.01), (16, 0.001), (8, 0.2)):
        a, b = _udd_pair(nb, err, mix[:4000], mix[4000:])
        assert a.serialize() == b.serialize()
        assert a.gamma == b.gamma and a.count() == b.count()
        for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.999, 1.0):
            assert a.quantile(q) == b.quantile(q)
        again = psk.UddSketch.deserialize(b.serialize())
        assert again.serialize() == b.serialize()
    assert a.gamma > (1 + 0.2) / (1 - 0.2)  # collapsed
    for bad in (psk, jsk):
        with pytest.raises(ValueError):
            bad.UddSketch(8, 1.5)
        with pytest.raises(ValueError):
            bad.UddSketch().quantile(1.5)
        with pytest.raises(ValueError):
            bad.UddSketch.deserialize(b"nope")
    assert np.isnan(psk.UddSketch().quantile(0.5))


def test_udd_merge_aligns_gamma_and_matches_reference():
    rng = np.random.default_rng(4)
    x, y = rng.lognormal(0, 3, 4000), rng.lognormal(2, 1, 300)
    a, b = _udd_pair(32, 0.01, x)  # collapses
    c, d = _udd_pair(32, 0.01, y)  # finer gamma
    a.merge(c)
    b.merge(d)
    assert a.serialize() == b.serialize()
    e, f = _udd_pair(128, 0.05, y)
    with pytest.raises(ValueError) as got:
        a.merge(e)
    with pytest.raises(ValueError) as want:
        b.merge(f)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("nb", [16, 128, 1024])
def test_udd_dense_helpers_match_reference(nb):
    rng = np.random.default_rng(nb)
    v = np.concatenate([rng.lognormal(0, 2, 400), -rng.lognormal(0, 2, 300), np.zeros(20),
                        [1e300, -1e300, 1e-300, -1e-300, 1.0, -1.0]])
    got, want = psk.udd_bucket_ids(v, GAMMA, nb), jsk.udd_bucket_ids(v, GAMMA, nb)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    # clipped at both edges: negatives take [1, half), positives (half, nb)
    assert got.min() == 1 and got.max() == nb - 1
    b = np.arange(nb)
    np.testing.assert_array_equal(psk.udd_value_of_bucket(b, GAMMA, nb),
                                  jsk.udd_value_of_bucket(b, GAMMA, nb))
    counts = np.stack([np.bincount(got, minlength=nb), np.zeros(nb, np.int64),
                       np.bincount(got[:50], minlength=nb)])
    for q in (0.0, 0.5, 0.99, 1.0):
        np.testing.assert_array_equal(psk.udd_quantile_dense(counts, q, GAMMA),
                                      jsk.udd_quantile_dense(counts, q, GAMMA))


# ---- K20 / K21 plain versions against the reference's segment ops ---------------


def _segment_cases():
    """(name, n, num_groups, width, gids): seeded ids and the edges."""
    rng = np.random.default_rng(5)
    n = 3000
    wrap = rng.integers(0, 3, n).astype(np.int64)
    wrap[::5] = 1 << 20          # * 4096 = 2^32: wraps onto group 0
    wrap[1::7] = 1 << 19         # * 4096 = 2^31: wraps negative, dropped
    wrap[2::11] = -(1 << 20)     # -2^32: wraps onto group 0
    wrap[3::13] = -1             # negative, dropped
    wrap[4::17] = 3              # == G: out of range, dropped
    return [
        ("seeded", n, 9, 64, rng.integers(0, 9, n)),
        ("empty groups", n, 40, 64, rng.integers(0, 5, n) * 8),
        ("G=1", n, 1, 1024, np.zeros(n, np.int64)),
        ("N=0", 0, 4, 16, np.zeros(0, np.int64)),
        ("int32 wrap", n, 3, 4096, wrap),
        ("out of range", n, 4, 128, rng.integers(-6, 10, n)),
    ]


@pytest.mark.parametrize("case", _segment_cases(), ids=lambda c: c[0])
def test_segment_hll_plain_matches_reference(case):
    _name, n, g, m, gids = case
    rng = np.random.default_rng(6)
    reg = rng.integers(0, m, n).astype(np.int32)
    rho = rng.integers(-3, 40, n).astype(np.int32)  # rho <= 0 leaves 0
    want = np.asarray(jsk.segment_hll(jnp.asarray(reg), jnp.asarray(rho), jnp.asarray(gids), g, m))
    before = psk.segment_hll.launches
    got = psk.segment_hll(torch.from_numpy(reg), torch.from_numpy(rho),
                          torch.from_numpy(np.asarray(gids)), g, m)
    assert psk.segment_hll.launches == before  # a CPU tensor runs the plain version
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape == (g, m)
    assert got.numpy().tobytes() == want.astype(np.int32).tobytes()


def test_segment_hll_wrap_aliases_into_group_zero():
    """The reference's int32 arithmetic: gid 2^20 at m = 4096 lands on
    group 0's register; gid 2^19 wraps negative and is dropped."""
    reg = np.array([5, 6], np.int32)
    rho = np.array([9, 9], np.int32)
    gids = np.array([1 << 20, 1 << 19], np.int64)
    got = psk.segment_hll_plain(*(torch.from_numpy(x) for x in (reg, rho, gids)), 2, 4096)
    want = np.asarray(jsk.segment_hll(jnp.asarray(reg), jnp.asarray(rho), jnp.asarray(gids), 2, 4096))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 5] == 9 and int(got.sum()) == 9


def _hll_path(reg_idx, gids, num_groups: int, m: int) -> str:
    """The path K20 (csrc/segment_hll.cu) takes for these rows: "ordered"
    when the host allows it (`hll_layout`: G * m < 2^31, m within the
    shared-memory budget), every gid lies in [0, G) and none is below the
    gid before it, and every reg_idx lies in [0, m); else "atomic"."""
    ordered, _cap, _tile = psk.hll_layout(int(gids.shape[0]), num_groups, m)
    g = gids.to(torch.int64)
    r = reg_idx.to(torch.int64)
    ok = (ordered and bool(((g >= 0) & (g < num_groups)).all())
          and bool((g[1:] >= g[:-1]).all()) and bool(((r >= 0) & (r < m)).all()))
    return "ordered" if ok else "atomic"


def _hll_ordered(reg_idx, rho, gids, num_groups: int, m: int):
    """K20's ordered path in torch ops, for rows that take it: each group's
    run of rows builds its own register row from zeros, stored once;
    groups with no row store zeros."""
    g = gids.to(torch.int64)
    regs = torch.zeros((int(num_groups), int(m)), dtype=torch.int32)
    bounds = torch.searchsorted(g, torch.arange(int(num_groups) + 1))
    for grp in range(int(num_groups)):
        lo, hi = int(bounds[grp]), int(bounds[grp + 1])
        keep = rho[lo:hi] > 0
        regs[grp].scatter_reduce_(0, reg_idx[lo:hi][keep].to(torch.int64),
                                  rho[lo:hi][keep].to(torch.int32), "amax")
    return regs


def _hll_path_cases():
    """(name, path K20 must take, num_groups, m, gids, reg_idx): the
    ordered path's decision at its edges (sorted runs of 300 rows)."""
    rng = np.random.default_rng(9)
    runs = np.repeat(np.array([0, 1, 4, 5, 9, 11], np.int64), 300)  # empty groups between
    n = runs.shape[0]

    def regs(m):
        return rng.integers(0, m, n).astype(np.int32)

    down = runs.copy()
    down[-1] = 10  # one decreasing gid at the very end
    minus = runs.copy()
    minus[400] = -1  # a gid of -1 inside a sorted run
    past = runs.copy()
    past[700] = 12  # a gid of G inside a sorted run
    bad_reg = regs(64)
    bad_reg[900] = 64  # reg_idx out of range
    neg_reg = regs(64)
    neg_reg[5] = -1
    return [
        ("sorted, empty groups", "ordered", 12, 64, runs, regs(64)),
        ("sorted, one group per window", "ordered", 12, 4096, runs, regs(4096)),
        ("sorted, m at the budget", "ordered", 12, 1 << 15, runs, regs(1 << 15)),
        ("m above the budget", "atomic", 12, 1 << 16, runs, regs(1 << 16)),
        ("one decreasing gid at the end", "atomic", 12, 64, down, regs(64)),
        ("gid -1 in a sorted run", "atomic", 12, 64, minus, regs(64)),
        ("gid G in a sorted run", "atomic", 12, 64, past, regs(64)),
        ("reg_idx = m", "atomic", 12, 64, runs, bad_reg),
        ("reg_idx = -1", "atomic", 12, 64, runs, neg_reg),
        ("N=0", "ordered", 4, 16, np.zeros(0, np.int64), np.zeros(0, np.int32)),
    ]


@pytest.mark.parametrize("case", _hll_path_cases(), ids=lambda c: c[0])
def test_hll_ordered_path_plain_matches_reference(case):
    """K20's path decision as a plain function, and the ordered path's
    result built from one register row per group, against the reference's
    segment_hll (the atomic path's result is `segment_hll_plain`)."""
    _name, path, g, m, gids, reg = case
    rho = np.random.default_rng(10).integers(-3, 40, gids.shape[0]).astype(np.int32)
    t_reg, t_rho, t_gids = (torch.from_numpy(x) for x in (reg, rho, gids))
    assert _hll_path(t_reg, t_gids, g, m) == path
    want = np.asarray(jsk.segment_hll(jnp.asarray(reg), jnp.asarray(rho), jnp.asarray(gids), g, m))
    got = (_hll_ordered if path == "ordered" else psk.segment_hll_plain)(
        t_reg, t_rho, t_gids, g, m)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape == (g, m)
    assert got.numpy().tobytes() == want.astype(np.int32).tobytes()


def test_hll_path_past_2_31_is_atomic():
    """G * m >= 2^31 (the int32 wrap) keeps the ordered path off, however
    the rows lie; the layout caps a window at 4096 registers."""
    gids = torch.arange(8, dtype=torch.int64)
    reg = torch.zeros(8, dtype=torch.int32)
    assert _hll_path(reg, gids, (1 << 19) + 1, 4096) == "atomic"
    assert _hll_path(reg, gids, 1 << 19, 4096) == "atomic"
    assert _hll_path(reg, gids, (1 << 19) - 1, 4096) == "ordered"
    assert psk.hll_layout(17_280_000, 4000, 1 << 14) == (True, 1, 1 << 16)
    assert psk.hll_layout(0, 4000, 16) == (True, 256, 1 << 16)
    assert psk.hll_layout(100_000_000, 1, 4096)[2] == 1 << 19


@pytest.mark.parametrize("case", _segment_cases(), ids=lambda c: c[0])
def test_segment_udd_plain_matches_reference(case):
    _name, n, g, nb, gids = case
    rng = np.random.default_rng(7)
    bids = rng.integers(0, nb, n).astype(np.int32)
    mask = rng.random(n) > 0.2
    want = np.asarray(jsk.segment_udd(jnp.asarray(bids), jnp.asarray(gids), jnp.asarray(mask), g, nb))
    got = psk.segment_udd(torch.from_numpy(bids), torch.from_numpy(np.asarray(gids)),
                          torch.from_numpy(mask), g, nb)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape == (g, nb)
    assert got.numpy().tobytes() == want.astype(np.int32).tobytes()


def test_device_hll_matches_host_grouped():
    """K20's plain version over `hll_inputs`, cast to uint8, is the host
    `hll_build_grouped` (tests/test_sketch.py's bar, in the port)."""
    rng = np.random.default_rng(8)
    h = psk.hash64(pa.array(rng.integers(0, 3000, 20_000)))
    gids = rng.integers(0, 5, h.shape[0]).astype(np.int32)
    idx, rho = psk.hll_inputs(h, 12)
    regs = psk.segment_hll(torch.from_numpy(idx), torch.from_numpy(rho), torch.from_numpy(gids),
                           5, 1 << 12)
    np.testing.assert_array_equal(regs.numpy().astype(np.uint8), psk.hll_build_grouped(h, gids, 5, 12))


def test_wrapper_never_runs_the_plain_version_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel (which this
    machine cannot build) and raises; it never gets the plain answer."""
    meta = [torch.zeros(4, dtype=torch.int32, device="meta") for _ in range(3)]
    launches = psk.segment_hll.launches, psk.segment_udd.launches
    with pytest.raises(Exception):
        psk.segment_hll(*meta, 2, 16)
    with pytest.raises(Exception):
        psk.segment_udd(meta[0], meta[1], torch.zeros(4, dtype=torch.bool, device="meta"), 2, 16)
    assert (psk.segment_hll.launches, psk.segment_udd.launches) == launches


# ---- the two-step merge: 8 shards ---------------------------------------------------


def test_two_step_merge_matches_reference_mesh():
    """The reference's per-device partials merged with pmax / psum over an
    8-device mesh, against the port's per-shard partials folded in shard
    order with torch.maximum and +; both equal the single pass."""
    from jax.sharding import Mesh, PartitionSpec as P

    from greptimedb_tpu.utils.jax_compat import shard_map

    devs = jax.devices()
    assert len(devs) >= 8, "conftest forces an 8-device CPU mesh"
    mesh = Mesh(np.array(devs[:8]), ("regions",))
    rng = np.random.default_rng(9)
    n, g, p, nb = 512 * 8, 5, 10, 1024
    idx, rho = psk.hll_inputs(psk.hash64(pa.array(rng.integers(0, 2000, n))), p)
    gids = rng.integers(0, g, n).astype(np.int32)
    bids = psk.udd_bucket_ids(rng.lognormal(2, 1, n), GAMMA, nb)
    mask = rng.random(n) > 0.01

    @jax.jit
    def run(idx, rho, gids, bids, mask):
        def step(idx, rho, gids, bids, mask):
            regs = jax.lax.pmax(jsk.segment_hll(idx, rho, gids, g, 1 << p), "regions")
            counts = jax.lax.psum(jsk.segment_udd(bids, gids, mask, g, nb), "regions")
            return regs, counts

        spec = P("regions")
        return shard_map(step, mesh=mesh, in_specs=(spec,) * 5, out_specs=(P(), P()))(
            idx, rho, gids, bids, mask)

    want_regs, want_counts = (np.asarray(x) for x in run(*(jnp.asarray(x) for x in
                                                            (idx, rho, gids, bids, mask))))
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
         dict(idx=idx, rho=rho, gids=gids, bids=bids, mask=mask).items()}
    regs = counts = None
    for s in range(8):
        sl = slice(s * n // 8, (s + 1) * n // 8)
        r = psk.segment_hll(t["idx"][sl], t["rho"][sl], t["gids"][sl], g, 1 << p)
        c = psk.segment_udd(t["bids"][sl], t["gids"][sl], t["mask"][sl], g, nb)
        regs = r if regs is None else torch.maximum(regs, r)
        counts = c if counts is None else counts + c
    assert regs.numpy().tobytes() == want_regs.astype(np.int32).tobytes()
    assert counts.numpy().tobytes() == want_counts.astype(np.int32).tobytes()
    single = psk.segment_hll(t["idx"], t["rho"], t["gids"], g, 1 << p)
    assert torch.equal(single, regs)
    assert torch.equal(psk.segment_udd(t["bids"], t["gids"], t["mask"], g, nb), counts)


# ---- Database.sql through both packages ---------------------------------------------


def _jax_db(home: str) -> JaxDatabase:
    cfg = JaxConfig()
    cfg.query.disabled_passes = UNPORTED_PASSES
    cfg.query.tile_persist_enable = False
    cfg.query.fallback_to_cpu = False
    return JaxDatabase(config=cfg, data_home=home)


class _Pair:
    """The port's and the reference's Database over the same statements."""

    def __init__(self, tmp, tile: bool = True):
        self.ref = _jax_db(str(tmp / "jax"))
        self.port = Database(str(tmp / "port"), device="cpu")
        self.port.config.query.disabled_passes = HOST_ROUTES
        for db in (self.ref, self.port):
            db.config.query.tile_cache_enable = tile

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

    def same(self, sql):
        got, want = self.port.sql_one(sql), self.ref.sql_one(sql)
        assert got.schema.equals(want.schema), (sql, got.schema, want.schema)
        assert got.to_pydict() == want.to_pydict(), sql
        return got


SCENARIO_QUERIES = (
    "SELECT host, hll_count(hll(v)) AS c FROM t GROUP BY host ORDER BY host",
    "SELECT hll_count(hll(host)) AS c FROM t",
    "SELECT host, uddsketch_calc(0.5, uddsketch_state(128, 0.01, v)) AS p50"
    " FROM t GROUP BY host ORDER BY host",
    "SELECT hll(v) AS s FROM t WHERE ts < 4500",
    "SELECT hll(v) AS s FROM t WHERE ts >= 4500",
    "SELECT host, hll(v) AS s, uddsketch_state(32, 0.02, v) AS u FROM t GROUP BY host ORDER BY host",
    "SELECT time_bucket('3s', ts) AS b, hll_count(hll(host)) AS c,"
    " uddsketch_calc(0.99, uddsketch_state(128, 0.01, v)) AS p99 FROM t GROUP BY b ORDER BY b",
    "SELECT uddsketch_calc(0.5, uddsketch_state(v)) AS p FROM t",
)


@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    """test_sql_sketch_aggregates' table (3 hosts x 3000 rows), flushed
    half way, through both packages."""
    pair = _Pair(tmp_path_factory.mktemp("sketch_sql"))
    pair.sql("CREATE TABLE t (host STRING, ts TIMESTAMP(3), v DOUBLE,"
             " TIME INDEX (ts), PRIMARY KEY (host))")
    rng = np.random.default_rng(0)
    n = 9000
    rows = pa.record_batch({
        "host": pa.array([f"h{i % 3}" for i in range(n)]),
        "ts": pa.array(np.arange(n, dtype=np.int64), pa.timestamp("ms")),
        "v": pa.array(np.floor(rng.uniform(0, 500, n))),
    })
    pair.write("t", rows.slice(0, 5000))
    pair.flush()
    pair.write("t", rows.slice(5000))
    yield pair
    pair.close()


@pytest.mark.parametrize("sql", SCENARIO_QUERIES)
def test_sql_scenarios_match_reference(scenario, sql):
    out = scenario.same(sql)
    assert out.num_rows > 0


def test_sql_scenario_bars_and_two_step_merge(scenario):
    """tests/test_sketch.py's bars, through the port; the per-half states
    merged with the port's hll_merge estimate the whole."""
    t = scenario.port.sql_one(SCENARIO_QUERIES[0])
    assert all(abs(c - 500) / 500 < 0.06 for c in t["c"].to_pylist())
    assert scenario.port.sql_one(SCENARIO_QUERIES[1])["c"].to_pylist() == [3]
    p50 = scenario.port.sql_one(SCENARIO_QUERIES[2])["p50"].to_pylist()
    assert all(abs(p - 250) / 250 < 0.1 for p in p50)
    h1 = scenario.port.sql_one(SCENARIO_QUERIES[3])["s"].to_pylist()[0]
    h2 = scenario.port.sql_one(SCENARIO_QUERIES[4])["s"].to_pylist()[0]
    est = psk.hll_estimate(psk.hll_merge(psk.hll_deserialize(h1), psk.hll_deserialize(h2)))
    assert abs(est - 500) / 500 < 0.06


def test_sql_merge_of_stored_states(scenario):
    """GreptimeDB's two-step rollup: per-bucket states written to a
    BINARY table through Database.write, merged at query time; the merged
    HLL state is the single pass's byte for byte."""
    states = scenario.port.sql_one(
        "SELECT time_bucket('1s', ts) AS b, hll(v) AS s, uddsketch_state(128, 0.01, v) AS u"
        " FROM t GROUP BY b ORDER BY b")
    scenario.sql("CREATE TABLE st (b TIMESTAMP(3) TIME INDEX, s BINARY, u BINARY)")
    scenario.write("st", pa.table({"b": states["b"], "s": states["s"], "u": states["u"]}))
    merged = scenario.same("SELECT hll_merge(s) AS s, uddsketch_merge(u) AS u FROM st")
    whole = scenario.port.sql_one("SELECT hll(v) AS s FROM t")
    assert merged["s"].to_pylist() == whole["s"].to_pylist()
    scenario.same("SELECT hll_count(hll_merge(s)) AS c,"
                  " uddsketch_calc(0.99, uddsketch_merge(u)) AS p99 FROM st")


def _golden_statements(name):
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    text = open(os.path.join(here, "tests", "cases", "standalone", name)).read()
    lines = [ln for ln in text.splitlines() if not ln.startswith("--")]
    return [s.strip() for s in "\n".join(lines).split(";") if s.strip()]


def test_golden_approx_aggregates_matches_reference(tmp_path):
    """Every statement of the sqlness golden through both packages; the
    SELECTs give equal tables and the golden's own answers."""
    pair = _Pair(tmp_path)
    try:
        selects = []
        for stmt in _golden_statements("approx_aggregates.sql"):
            if stmt.upper().startswith("SELECT"):
                selects.append(pair.same(stmt).column(0).to_pylist())
            else:
                pair.sql(stmt)
        assert selects == [[5], [3.0], [3.0]]
    finally:
        pair.close()


def test_sql_nulls_empty_table_and_mismatched_merge(tmp_path):
    pair = _Pair(tmp_path)
    try:
        pair.sql("CREATE TABLE n (k STRING, v DOUBLE, ts TIMESTAMP TIME INDEX, PRIMARY KEY (k))")
        # an empty table: the states of no rows, counted
        pair.same("SELECT hll_count(hll(v)) AS c, uddsketch_calc(0.5, uddsketch_state(v)) AS p,"
                  " hll(v) AS s, uddsketch_state(v) AS u FROM n")
        pair.same("SELECT k, hll(v) AS s FROM n GROUP BY k")
        pair.sql("INSERT INTO n VALUES ('a', 1.0, 0), ('a', NULL, 1000), ('b', NULL, 2000),"
                 " (NULL, 4.0, 3000), ('c', 0.0, 4000), ('c', -2.5, 5000), ('c', NULL, 6000)")
        pair.same("SELECT k, hll_count(hll(v)) AS c, uddsketch_calc(0.5, uddsketch_state(v)) AS p,"
                  " hll(v) AS s, uddsketch_state(16, 0.05, v) AS u FROM n GROUP BY k ORDER BY k")
        pair.same("SELECT hll_count(hll(k)) AS c, hll(k) AS s FROM n")
        # NULL states: hll_count / uddsketch_calc of NULL is NULL, merges skip them
        pair.sql("CREATE TABLE ns (ts TIMESTAMP TIME INDEX, s BINARY, u BINARY)")
        pair.write("ns", pa.table({"ts": pa.array([0, 1000], pa.timestamp("ms")),
                                   "s": pa.array([None, None], pa.binary()),
                                   "u": pa.array([None, None], pa.binary())}))
        pair.same("SELECT hll_count(s) AS c, uddsketch_calc(0.5, u) AS p FROM ns")
        pair.same("SELECT hll_count(hll_merge(s)) AS c, uddsketch_calc(0.5, uddsketch_merge(u)) AS p"
                  " FROM ns")
        # states of two error parameters cannot merge: the same PlanError text
        a = jsk.UddSketch(128, 0.01)
        a.add_array(np.arange(1.0, 50.0))
        b = jsk.UddSketch(128, 0.05)
        b.add_array(np.arange(1.0, 50.0))
        pair.sql("CREATE TABLE mm (ts TIMESTAMP TIME INDEX, u BINARY)")
        pair.write("mm", pa.table({"ts": pa.array([0, 1000], pa.timestamp("ms")),
                                   "u": pa.array([a.serialize(), b.serialize()], pa.binary())}))
        sql = "SELECT uddsketch_calc(0.5, uddsketch_merge(u)) AS p FROM mm"
        with pytest.raises(PlanError) as got:
            pair.port.sql_one(sql)
        with pytest.raises(Exception) as want:
            pair.ref.sql_one(sql)
        assert type(want.value).__name__ == "PlanError"
        assert str(got.value) == str(want.value)
        assert "cannot merge UDDSketches" in str(got.value)
        with pytest.raises(PlanError) as got:
            pair.port.sql_one("SELECT uddsketch_state(128, 2.0, v) AS u FROM n")
        with pytest.raises(Exception) as want:
            pair.ref.sql_one("SELECT uddsketch_state(128, 2.0, v) AS u FROM n")
        assert str(got.value) == str(want.value)
    finally:
        pair.close()


def _launch_total():
    return sum(fn.launches for fn, _s, _r in chip_smoke.kernel_table().values())


@pytest.mark.parametrize("tile", [True, False], ids=["tile route", "table-fed route"])
def test_sketch_queries_decline_to_the_cpu_executor(tmp_path, tile):
    """`LOWERABLE_AGGS` leaves the sketches out, as the reference's does:
    a sketch query is declined by the device executor on both routes (the
    tile route and the table-fed route), launches no kernel and is
    answered by the CPU executor, as in the reference; a plain aggregate
    over the same table is lowered."""
    from greptimedb_tpu_torch.query.device_exec import LOWERABLE_AGGS

    assert not LOWERABLE_AGGS & {"hll", "hll_merge", "uddsketch_state", "uddsketch_merge"}
    pair = _Pair(tmp_path, tile=tile)
    try:
        pair.sql("CREATE TABLE d (host STRING, v DOUBLE, ts TIMESTAMP TIME INDEX,"
                 " PRIMARY KEY (host)) WITH (append_mode = 'true')")
        rng = np.random.default_rng(10)
        pair.write("d", pa.table({"host": pa.array([f"h{i % 4}" for i in range(400)]),
                                  "v": rng.uniform(0, 10, 400),
                                  "ts": pa.array(np.arange(400) * 1000, pa.timestamp("ms"))}))
        pair.flush()
        eng = pair.port.query_engine
        pair.same("SELECT host, max(v) AS m FROM d GROUP BY host ORDER BY host")
        assert eng.last_path == ("tile" if tile else "table")
        for sql in ("SELECT host, hll_count(hll(v)) AS c FROM d GROUP BY host ORDER BY host",
                    "SELECT uddsketch_calc(0.9, uddsketch_state(v)) AS p, max(v) AS m FROM d"):
            before, launches = dict(eng.stats), _launch_total()
            pair.same(sql)
            assert eng.last_path == "cpu", sql
            assert eng.stats["declined"] == before["declined"] + 1, sql
            for k in ("lowered", "tile_dispatches", "tile_declined"):
                assert eng.stats[k] == before[k], (sql, k)
            assert _launch_total() == launches
    finally:
        pair.close()


def test_chip_smoke_sketch_phase_rehearsal(tmp_path):
    """Phase 9 of chip_smoke.py on the CPU at 40 hosts x 2 h: the kernel
    half (plain versions, the 4-shard merge, the tie to the host build)
    and S1-S5 through the port's Database against their bars."""
    kern = chip_smoke.run_sketch_kernel_phase("cpu", 40, 2, 1)
    out = chip_smoke.run_sketch_slice("cpu", 40, 2, 0, str(tmp_path), kern["regs_by_host"])
    assert set(out["queries"]) == {"S1", "S2", "S3", "S4", "S5"}
    assert {"segment_hll", "segment_udd"} <= set(chip_smoke.kernel_table())


# ---- K21's ordered path, emulated ---------------------------------------------------


def _udd_path(bucket_ids, gids, mask, num_groups: int, n_buckets: int) -> str:
    """The path K21 (csrc/segment_udd.cu) takes for these rows: "ordered"
    when the host allows it (`udd_layout`: G * B < 2^31, a group's row
    within the shared-memory budget), every gid lies in [0, G) and none is
    below the gid before it (masked rows included: the run pass reads gids
    alone), and every unmasked bucket lies in [0, B); else "atomic"."""
    ordered, _cap, _tile = psk.udd_layout(int(gids.shape[0]), num_groups, n_buckets)
    g = gids.to(torch.int64)
    b = bucket_ids.to(torch.int64)[mask.to(torch.bool)]
    ok = (ordered and bool(((g >= 0) & (g < num_groups)).all())
          and bool((g[1:] >= g[:-1]).all()) and bool(((b >= 0) & (b < n_buckets)).all()))
    return "ordered" if ok else "atomic"


def _udd_ordered(bucket_ids, gids, mask, num_groups: int, n_buckets: int, tile=None):
    """K21's ordered path in torch ops, for rows that take it: the run pass's
    window table (each window of `cap` groups: its first and last row), an
    owner a window that builds the window's histograms from zeros out of
    its first `tile` rows and stores every count (empty buckets and groups
    included), helper blocks for the rest of a longer run, each a partial
    row from zeros, and the fold that adds them to the owner's row.  `tile`
    stands in for the layout's rows a block (at least 2^16) so that small
    inputs reach the helpers."""
    n = int(gids.shape[0])
    _ordered, cap, layout_tile = psk.udd_layout(n, num_groups, n_buckets)
    tile = tile or layout_tile
    g = gids.to(torch.int64)
    b = bucket_ids.to(torch.int64)
    keep = mask.to(torch.bool)
    n_windows = -(-int(num_groups) // cap)
    first = torch.full((n_windows,), -1, dtype=torch.int64)
    last = torch.full((n_windows,), -2, dtype=torch.int64)
    for r in range(n):  # the run pass: a store where a window's run starts or ends
        w = int(g[r]) // cap
        if r == 0 or int(g[r - 1]) // cap != w:
            first[w] = r
        if r + 1 == n or int(g[r + 1]) // cap != w:
            last[w] = r
    counts = torch.empty(int(num_groups) * n_buckets, dtype=torch.int32)

    def build(w, lo, hi):
        ga = w * cap
        width = min(cap, int(num_groups) - ga) * n_buckets
        row = torch.zeros(width, dtype=torch.int32)
        k = keep[lo:hi]
        row.index_add_(0, (b[lo:hi][k] + (g[lo:hi][k] - ga) * n_buckets),
                       torch.ones(int(k.sum()), dtype=torch.int32))
        return ga, width, row

    taken = torch.zeros(n, dtype=torch.int64)
    for w in range(n_windows):  # the owners
        f, l = int(first[w]), int(last[w])
        lo, hi = (0, 0) if f < 0 else (f, min(f + tile, l + 1))
        ga, width, row = build(w, lo, hi)
        taken[lo:hi] += 1
        counts[ga * n_buckets:ga * n_buckets + width] = row
    for h in range(-(-n // tile)):  # the helpers, then the fold
        hs = h * tile
        w = int(g[hs]) // cap
        f, l = int(first[w]), int(last[w])
        lo, hi = max(hs, f + tile), min(hs + tile, l + 1)
        if lo >= hi:
            continue
        ga, width, row = build(w, lo, hi)
        taken[lo:hi] += 1
        counts[ga * n_buckets:ga * n_buckets + width] += row
    assert bool((taken == 1).all())  # every row taken by one block
    return counts.reshape(int(num_groups), n_buckets)


def _udd_path_cases():
    """(name, path K21 must take, num_groups, B, gids, bucket_ids, mask, tile):
    the ordered path's decision at its edges (sorted runs of 300 rows) and
    runs longer than a block's tile (the helpers)."""
    rng = np.random.default_rng(19)
    runs = np.repeat(np.array([0, 1, 4, 5, 9, 11], np.int64), 300)  # empty groups between
    n = runs.shape[0]

    def buckets(nb):
        return rng.integers(0, nb, n).astype(np.int32)

    mask = rng.random(n) > 0.1
    masked_b = buckets(64)
    masked_b[~mask] = 64  # a masked row's bucket of B adds nothing
    bad_b, neg_b = buckets(64), buckets(64)
    bad_b[900], neg_b[5] = 64, -1
    on = mask.copy()
    on[[5, 900]] = True
    down = runs.copy()
    down[-1] = 10  # one decreasing gid at the very end
    minus = runs.copy()
    minus[400] = -1  # a gid of -1 inside a sorted run
    past = runs.copy()
    past[700] = 12  # a gid of G inside a sorted run
    off_400 = mask.copy()
    off_400[400] = False  # the gid of -1 on a masked row: the run pass still reads it
    return [
        ("sorted, empty groups, masked rows", "ordered", 12, 64, runs, buckets(64), mask, None),
        ("masked bucket = B", "ordered", 12, 64, runs, masked_b, mask, None),
        ("one group a window", "ordered", 12, 1024, runs, buckets(1024), mask, None),
        ("B at the budget", "ordered", 12, 1 << 15, runs, buckets(1 << 15), mask, None),
        ("B above the budget", "atomic", 12, 1 << 16, runs, buckets(1 << 16), mask, None),
        ("unmasked bucket = B", "atomic", 12, 64, runs, bad_b, on, None),
        ("unmasked bucket = -1", "atomic", 12, 64, runs, neg_b, on, None),
        ("one decreasing gid at the end", "atomic", 12, 64, down, buckets(64), mask, None),
        ("gid -1 in a sorted run", "atomic", 12, 64, minus, buckets(64), mask, None),
        ("gid -1 on a masked row", "atomic", 12, 64, minus, buckets(64), off_400, None),
        ("gid G in a sorted run", "atomic", 12, 64, past, buckets(64), mask, None),
        ("runs past a tile (helpers)", "ordered", 12, 64, runs, buckets(64), mask, 128),
        ("one bucket, one group, helpers", "ordered", 1, 128, np.zeros(n, np.int64),
         np.zeros(n, np.int32), np.ones(n, bool), 256),
        ("N=0", "ordered", 4, 16, np.zeros(0, np.int64), np.zeros(0, np.int32),
         np.zeros(0, bool), None),
    ]


@pytest.mark.parametrize("case", _udd_path_cases(), ids=lambda c: c[0])
def test_udd_ordered_path_plain_matches_reference(case):
    """K21's path decision as a plain function, and the ordered path's
    result built window by window (owners, helpers, the fold) from zeros,
    against the reference's segment_udd byte for byte (the atomic path's
    result is `segment_udd_plain`)."""
    _name, path, g, nb, gids, bids, mask, tile = case
    t_b, t_g, t_m = (torch.from_numpy(x) for x in (bids, gids, mask))
    assert _udd_path(t_b, t_g, t_m, g, nb) == path
    want = np.asarray(jsk.segment_udd(jnp.asarray(bids), jnp.asarray(gids), jnp.asarray(mask),
                                      g, nb))
    got = (_udd_ordered(t_b, t_g, t_m, g, nb, tile) if path == "ordered"
           else psk.segment_udd_plain(t_b, t_g, t_m, g, nb))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape == (g, nb)
    assert got.numpy().tobytes() == want.astype(np.int32).tobytes()
    plain = psk.segment_udd(t_b, t_g, t_m, g, nb)  # a CPU tensor: the plain version
    assert plain.numpy().tobytes() == want.astype(np.int32).tobytes()


def _udd_aliased(bucket_ids, gids, mask, num_groups: int, n_buckets: int, tile=None):
    """K21 for rows in order with unmasked buckets outside [0, B): the
    owners (and helpers, and the fold) build and store every window without
    those rows, then the finish kernel adds them alone by their wrapped
    int32 flat ids, dropping an id outside [0, G * B)."""
    b = bucket_ids.to(torch.int64)
    bad = mask.to(torch.bool) & ((b < 0) | (b >= n_buckets))
    counts = _udd_ordered(bucket_ids, gids, mask.to(torch.bool) & ~bad, num_groups, n_buckets,
                          tile).reshape(-1)
    total = int(num_groups) * n_buckets
    flat, keep = psk._flat_ids(gids[bad], bucket_ids[bad], n_buckets, total)
    sel = flat[keep]
    counts.index_add_(0, sel, torch.ones(sel.shape, dtype=torch.int32))
    return counts.reshape(int(num_groups), n_buckets)


def _udd_aliased_cases():
    """(name, num_groups, B, gids, bucket_ids, mask, tile): sorted runs of
    300 rows with unmasked buckets outside [0, B) that alias into the next
    or the previous group's row, fall off the table, or sit in a run past a
    tile (helpers and the fold beside the adds)."""
    rng = np.random.default_rng(190)
    runs = np.repeat(np.array([0, 1, 4, 5, 9, 11], np.int64), 300)
    n = runs.shape[0]
    b = rng.integers(0, 64, n).astype(np.int32)
    mask = rng.random(n) > 0.1
    on = mask.copy()
    on[[5, 299, 900, 1799]] = True
    up, down, off = b.copy(), b.copy(), b.copy()
    up[[299, 900]] = [64, 200]        # into group 1's and group 6's rows
    down[[5, 900]] = [-1, -130]       # off the table's front, into group 2's row
    off[[1799, 1500]] = [64, 1 << 30]  # past the last group, and a wrapping id
    one = np.zeros(n, np.int32)
    one[[10, 1000]] = [1, -1]
    return [
        ("bucket B into the next group", 12, 64, runs, up, on, None),
        ("negative buckets", 12, 64, runs, down, on, None),
        ("off the table and wrapping", 12, 64, runs, off, on, None),
        ("runs past a tile (helpers)", 12, 64, runs, up, on, 128),
        ("one group, helpers", 1, 1, np.zeros(n, np.int64), one, np.ones(n, bool), 256),
    ]


@pytest.mark.parametrize("case", _udd_aliased_cases(), ids=lambda c: c[0])
def test_udd_aliased_buckets_over_stored_windows_match_reference(case):
    """Rows in order with an aliasing bucket: K21's windows stored without
    those rows plus their global adds, against the reference's segment_udd
    byte for byte (the path reads "atomic")."""
    _name, g, nb, gids, bids, mask, tile = case
    t_b, t_g, t_m = (torch.from_numpy(x) for x in (bids, gids, mask))
    assert _udd_path(t_b, t_g, t_m, g, nb) == "atomic"
    want = np.asarray(jsk.segment_udd(jnp.asarray(bids), jnp.asarray(gids), jnp.asarray(mask),
                                      g, nb)).astype(np.int32)
    got = _udd_aliased(t_b, t_g, t_m, g, nb, tile)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape == (g, nb)
    assert got.numpy().tobytes() == want.tobytes()


def test_udd_path_past_2_31_is_atomic():
    """G * B >= 2^31 (the int32 wrap) keeps the ordered path off, however
    the rows lie."""
    gids = torch.arange(8, dtype=torch.int64)
    b = torch.zeros(8, dtype=torch.int32)
    m = torch.ones(8, dtype=torch.bool)
    assert _udd_path(b, gids, m, (1 << 21) + 1, 1024) == "atomic"
    assert _udd_path(b, gids, m, 1 << 21, 1024) == "atomic"  # G * B = 2^31
    assert _udd_path(b, gids, m, (1 << 21) - 1, 1024) == "ordered"


@pytest.mark.parametrize("n,groups,nb,layout", [
    (8_640_000, 4000, 1024, (True, 1, 1 << 14)),   # phase 9 by host, B = 1024
    (8_640_000, 4000, 128, (True, 1, 1 << 14)),    # phase 9 by host, B = 128
    (8_640_000, 6, 1024, (True, 1, 1 << 14)),      # by hour (the run pass finds the disorder)
    (8_640_000, 1, 128, (True, 1, 1 << 14)),       # one bucket: 528 helper tiles
    (5000, 40, 64, (True, 64, 1 << 13)),           # 125 rows a group: windows of 4096 counts
    (2_160_000, 4000, 1024, (True, 1, 1 << 13)),   # a quarter shard of the two-step path
    (100_000_000, 1, 128, (True, 1, 1 << 18)),
    (10, 1 << 21, 1024, (False, 4, 1 << 13)),      # the wrap
])
def test_udd_layout_at_phase_9_shapes(n, groups, nb, layout):
    """K21's layout at phase 9's shapes: one group a window where the groups
    average RUN_GROUP_ROWS rows or more (no gids read by the owners), else
    windows of 4096 counts; tiles of n / 528 rows, at least 2^13."""
    assert psk.udd_layout(n, groups, nb) == layout
