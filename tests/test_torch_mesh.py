"""Multi-device tile execution (`tile.mesh_devices`) in the port against
the reference's mesh, in one process.

The reference gets 8 virtual CPU devices from tests/conftest.py; the port
lists 8 slots of one device (`Database(device=["cpu"] * 8)`), which runs
the same placement, per-slot partials, gather and fold.

* K22's plain version (`fold_states_plain`), dense and keyed, against the
  reference's merge at 1 and 8 devices: `psum_states` under shard_map
  after each device's local fold (counts; the table-fed LAST), the same
  merge on one device (min, max: K22 keeps a NaN across slots, where XLA
  CPU's pmin/pmax skip it), and the left folds and keyed scatters of
  `_mesh_merge_program` (sums, LAST, hash plans), on seeded states with
  NaN, +-inf, +-0.0, ts ties and empty sources — byte for byte;
* the tests/test_multichip.py fixture rebuilt in both packages: the port
  at mesh_devices 0, 1 and 8 gives the same bytes, equal byte for byte
  to the reference's 8-device answer (but for the float columns whose
  single-device answers already differ in the last ulp: within rel
  1e-12, the tile path's tolerance), and NaN values in one region only;
* config validation, chunk co-location, the table-fed route at 8 slots,
  the TQL mesh route, a mesh-ineligible shape, a failure inside K22, and
  a dashboard tick with the mesh on."""

import inspect
import math
import random

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from greptimedb_tpu.database import Database as JaxDatabase
from greptimedb_tpu.ops import aggregate as jagg
from greptimedb_tpu.parallel.executor import _shard_map
from greptimedb_tpu.utils import metrics
from greptimedb_tpu.utils.config import Config as JaxConfig
from greptimedb_tpu_torch import Database
from greptimedb_tpu_torch.ops import aggregate as agg
from greptimedb_tpu_torch.parallel import tile_program
from greptimedb_tpu_torch.parallel.mesh import REGION_AXIS, make_mesh, region_device_index
from greptimedb_tpu_torch.query import passes
from greptimedb_tpu_torch.utils.config import Config
from greptimedb_tpu_torch.utils.errors import ConfigError
from test_torch_tile import _assert_same

_DBL_MAX = float(np.finfo(np.float64).max)
_POOL = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1.5, -2.5, 3.0, _DBL_MAX,
                  -_DBL_MAX])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint64) if a.dtype == np.float64 else a


def _shard(fn, n_dev: int):
    mesh = Mesh(np.array(jax.devices()[:n_dev]), (REGION_AXIS,))
    params = inspect.signature(_shard_map).parameters
    kw = next(({k: False} for k in ("check_rep", "check_vma") if k in params), {})
    return jax.jit(_shard_map(fn, mesh=mesh, in_specs=P(REGION_AXIS), out_specs=P(), **kw))


# ---- K22's plain version against the reference's merge ----------------------------


def _values(rng, shape) -> np.ndarray:
    """f64 states: the edge pool (NaN of both signs, +-inf, +-0.0, +-max)
    mixed with ordinary values."""
    v = rng.standard_normal(shape) * 100.0
    edge = rng.random(shape) < 0.4
    return np.where(edge, rng.choice(_POOL, size=shape), v)


def _dense_case(seed: int, n_dev: int, n_local: int, rows: int = 301):
    rng = np.random.default_rng(seed)
    m = n_dev * n_local
    sums, mins, maxs = (_values(rng, (m, rows)) for _ in range(3))
    counts = rng.integers(0, 50, (m, rows)).astype(np.int64)
    last_ts = rng.integers(0, 3, (m, rows)).astype(np.int64)  # many ties
    last_val = _values(rng, (m, rows))
    # empty sources: identity states
    for e in rng.choice(m, size=max(m // 4, 1), replace=False):
        sums[e], counts[e], mins[e], maxs[e] = 0.0, 0, np.inf, -np.inf
        last_ts[e], last_val[e] = np.iinfo(np.int64).min, -_DBL_MAX
    # the real sources' placement (None: unplaced), as chunk placement gives
    # it; the rest of each slot is dummies
    n_real = int(rng.integers(max(m - n_local + 1, 1), m + 1))
    slots = [None if rng.random() < 0.3 else int(rng.integers(0, n_dev)) for _ in range(n_real)]
    positions = tile_program.mesh_positions([(None, s) for s in slots], n_dev, n_local)
    return dict(sums=sums, counts=counts, mins=mins, maxs=maxs, last_ts=last_ts,
                last_val=last_val), positions


def _ref_dense(st, positions, n_dev: int, n_local: int):
    """The reference's dense mesh merge: per device the local fold of its
    n_local sources then psum_states (counts, min, max), and the left folds
    of `_mesh_merge_program` over the real sources (sums, LAST)."""

    def per_device(c, mn, mx):
        c, mn, mx = c[0], mn[0], mx[0]
        lc, lmn, lmx = c[0], mn[0], mx[0]
        for s in range(1, n_local):
            lc, lmn, lmx = lc + c[s], jnp.minimum(lmn, mn[s]), jnp.maximum(lmx, mx[s])
        out = jagg.psum_states(jagg.AggState(counts=lc, mins=lmn, maxs=lmx), REGION_AXIS)
        return out.counts, out.mins, out.maxs

    def local(a):
        return jnp.asarray(a.reshape(n_dev, n_local, -1))

    counts, mins, maxs = _shard(per_device, n_dev)(
        local(st["counts"]), local(st["mins"]), local(st["maxs"]))
    g = {k: jnp.asarray(st[k]) for k in ("sums", "last_ts", "last_val")}
    rows = [d * n_local + s for d, s in positions]
    acc = g["sums"][rows[0]]
    lt, lv = g["last_ts"][rows[0]], g["last_val"][rows[0]]
    for r in rows[1:]:
        acc = acc + g["sums"][r]
        bt, bv = g["last_ts"][r], g["last_val"][r]
        newer = bt >= lt
        lv = jnp.where(newer, bv, lv)
        lt = jnp.maximum(lt, bt)
    return dict(sums=acc, counts=counts, mins=mins, maxs=maxs, last_ts=lt, last_val=lv)


@pytest.mark.parametrize("n_dev,n_local,seed", [(1, 5, 1), (8, 1, 2), (8, 3, 3), (8, 2, 4)])
def test_fold_states_dense_matches_reference(n_dev, n_local, seed):
    st, positions = _dense_case(seed, n_dev, n_local)
    want = _ref_dense(st, positions, n_dev, n_local)
    # min/max: the reference's merge with every source on one device (its
    # jnp.minimum/maximum fold), which K22 gives at any slot count.  XLA
    # CPU's pmin/pmax across 8 devices skip a NaN instead (ROADMAP)
    one = _ref_dense(st, positions, 1, n_dev * n_local)
    want["mins"], want["maxs"] = one["mins"], one["maxs"]
    order = [d * n_local + s for d, s in positions]
    got = agg.fold_states(agg.AggState(**{k: torch.from_numpy(v) for k, v in st.items()}),
                          n_local, order)
    for k, v in want.items():
        assert np.array_equal(_bits(getattr(got, k).numpy()), _bits(v)), k


@pytest.mark.parametrize("n_dev,n_local,seed", [(8, 1, 21), (8, 2, 22), (4, 3, 23)])
def test_fold_states_min_max_independent_of_slots(n_dev, n_local, seed):
    """The same sources folded over n_dev slots and over one: min and max
    give the same bytes (NaN of both signs, +-inf, +-0.0), also where a NaN
    sits in one slot's sources only."""
    st, positions = _dense_case(seed, n_dev, n_local)
    mins, maxs = st["mins"].copy(), st["maxs"].copy()
    mins[:, :50], maxs[:, :50] = 1.0, 1.0
    mins[n_local - 1, :25] = maxs[n_local - 1, :25] = np.nan  # slot 0 only
    mins[n_local - 1, 25:50] = maxs[n_local - 1, 25:50] = -np.nan
    order = [d * n_local + s for d, s in positions]
    folded = [agg.fold_states(agg.AggState(mins=torch.from_numpy(mins),
                                           maxs=torch.from_numpy(maxs)), k, order)
              for k in (n_local, n_dev * n_local)]
    for name in ("mins", "maxs"):
        a, b = (_bits(getattr(f, name).numpy()) for f in folded)
        assert np.array_equal(a, b), name
        assert np.isnan(getattr(folded[0], name).numpy()[:50]).all(), name


@pytest.mark.parametrize("n_dev", [1, 8])
def test_fold_states_table_fed_last_matches_psum_states(n_dev):
    """The table-fed route (one partial per slot) folds LAST by
    `psum_states`' rule: the max ts, the max value at it."""
    st, _positions = _dense_case(11 + n_dev, n_dev, 1)

    def per_device(t, v, s):
        out = jagg.psum_states(jagg.AggState(sums=s[0], last_ts=t[0], last_val=v[0]),
                               REGION_AXIS)
        return out.last_ts, out.last_val, out.sums

    lt, lv, sums = _shard(per_device, n_dev)(
        *(jnp.asarray(st[k]) for k in ("last_ts", "last_val", "sums")))
    got = agg.fold_states(agg.AggState(**{k: torch.from_numpy(st[k]) for k in
                                          ("sums", "last_ts", "last_val")}),
                          1, list(range(n_dev)), rule="psum")
    assert np.array_equal(got.last_ts.numpy(), np.asarray(lt))
    assert np.array_equal(_bits(got.last_val.numpy()), _bits(lv))
    # XLA CPU's psum over the devices is the left fold in device order
    # (keeping the later NaN where two meet): the psum rule's bytes
    assert np.array_equal(_bits(got.sums.numpy()), _bits(sums))


def _keyed_case(seed: int, n_dev: int, n_local: int, h: int, trailing: bool):
    """Per device a slot table built by the reference's K17 from seeded ids
    (keys shared across devices), and per source states over its device's
    slots: seeded values in the occupied slots, the scatter identity in
    the empty ones (what a partial holds there), the trailing row seeded."""
    rng = np.random.default_rng(seed)
    pool = rng.choice(1 << 40, size=40, replace=False).astype(np.int64)
    tables = []
    for _d in range(n_dev):
        ids = rng.choice(pool, size=int(rng.integers(5, 30)))
        table = jnp.full((h,), jagg.HASH_EMPTY, jnp.int64)
        table, _slots, ovf = jagg.hash_group_slots(table, jnp.asarray(ids),
                                                   jnp.ones(len(ids), bool))
        assert int(ovf) == 0
        tables.append(np.asarray(table))
    m, rows = n_dev * n_local, h + int(trailing)
    st = {}
    for name, ident in (("sums", 0.0), ("counts", 0), ("mins", np.inf), ("maxs", -np.inf)):
        vals = (rng.integers(0, 50, (m, rows)).astype(np.int64) if name == "counts"
                else _values(rng, (m, rows)))
        for r in range(m):
            empty = np.concatenate([tables[r // n_local] == jagg.HASH_EMPTY,
                                    np.zeros(int(trailing), bool)])
            vals[r, empty] = ident
        st[name] = vals
    n_real = int(rng.integers(max(m - n_local + 1, 1), m + 1))
    slots = [int(rng.integers(0, n_dev)) for _ in range(n_real)]
    positions = tile_program.mesh_positions([(None, s) for s in slots], n_dev, n_local)
    return np.stack(tables), st, positions


@pytest.mark.parametrize("n_dev,n_local,trailing", [(1, 3, False), (8, 1, True),
                                                    (8, 2, False), (8, 2, True)])
def test_fold_states_keyed_matches_reference(n_dev, n_local, trailing):
    h = 64
    tables, st, positions = _keyed_case(5 + n_dev + n_local, n_dev, n_local, h, trailing)
    # the union: the reference's K17 over the gathered [D * H] keys
    keys = jnp.asarray(tables.reshape(-1))
    union = jnp.full((h,), jagg.HASH_EMPTY, jnp.int64)
    union, uslots, ovf = jagg.hash_group_slots(union, keys, keys != jagg.HASH_EMPTY)
    slot_map = np.asarray(uslots).reshape(n_dev, h)
    rows = h + int(trailing)
    want = {}
    for name, g in st.items():
        g = jnp.asarray(g)
        if name == "mins":
            acc = jnp.full((rows,), jnp.finfo(g.dtype).max, g.dtype)
        elif name == "maxs":
            acc = jnp.full((rows,), jnp.finfo(g.dtype).min, g.dtype)
        else:
            acc = jnp.zeros((rows,), g.dtype)
        for d, s in positions:
            idx = jnp.asarray(slot_map[d])
            if trailing:
                idx = jnp.concatenate([idx, jnp.full((1,), h, idx.dtype)])
            upd = g[d * n_local + s]
            if name == "mins":
                acc = acc.at[idx].min(upd)
            elif name == "maxs":
                acc = acc.at[idx].max(upd)
            else:
                acc = acc.at[idx].add(upd)
        want[name] = np.asarray(acc)
    # the port: its own K17 (plain) gives the same union and slot map
    pkeys = torch.from_numpy(tables.reshape(-1).copy())
    punion = torch.full((h,), agg.HASH_EMPTY, dtype=torch.int64)
    punion, pslots, povf = agg.hash_group_slots(punion, pkeys, pkeys != agg.HASH_EMPTY)
    assert np.array_equal(punion.numpy(), np.asarray(union)) and int(povf) == int(ovf) == 0
    assert np.array_equal(pslots.numpy(), np.asarray(uslots))
    inv = agg.invert_slot_maps(pslots.reshape(n_dev, h))
    order = [d * n_local + s for d, s in positions]
    got = agg.fold_states(agg.AggState(**{k: torch.from_numpy(v) for k, v in st.items()}),
                          n_local, order, inv=inv)
    for name, v in want.items():
        assert np.array_equal(_bits(getattr(got, name).numpy()), _bits(v)), name


# ---- the batched fold (fold_state_dicts): every key of a merge in one launch ----------


_FIELDS = ("sums", "counts", "mins", "maxs", "last_ts", "last_val")


def _per_source(st: dict, m: int) -> list:
    """A stacked [m, rows] state (numpy arrays by field) as m per-source
    AggStates."""
    return [agg.AggState(**{k: torch.from_numpy(np.ascontiguousarray(v[i])) for k, v in st.items()})
            for i in range(m)]


def _assert_state_bits(got, want, what):
    for name in _FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), (what, name)
        if a is not None:
            assert np.array_equal(_bits(a.numpy()), _bits(np.asarray(b))), (what, name)


def _dense_merge_case(seed: int, n_dev: int, n_local: int, with_last: bool):
    """Dense keys of different row counts and field sets over one
    placement: the per-source dicts, the stacked states per key, positions."""
    rows_of = {"usage_user": 301, "__limb_err:usage_user": 301, "usage_idle": 77,
               "__presence": 5, "lastpoint": 128}
    stacked, positions = {}, None
    for i, (key, rows) in enumerate(rows_of.items()):
        st, pos = _dense_case(seed * 10 + i, n_dev, n_local, rows)
        positions = positions or pos
        if key == "__presence":
            st = {"counts": st["counts"]}
        elif key.startswith("__limb_err"):
            st = {"sums": st["sums"]}
        elif key == "lastpoint":
            if not with_last:
                continue
            st = {k: st[k] for k in ("counts", "last_ts", "last_val")}
        else:
            st = {k: st[k] for k in ("sums", "counts", "mins", "maxs")}
        stacked[key] = st
    m = n_dev * n_local
    per = [{} for _ in range(m)]
    for key, st in stacked.items():
        for i, s in enumerate(_per_source(st, m)):
            per[i][key] = s
    return per, stacked, positions


@pytest.mark.parametrize("n_dev,n_local,seed", [(1, 4, 31), (8, 1, 32), (4, 2, 33)])
def test_fold_state_dicts_dense_matches_reference(n_dev, n_local, seed):
    """The batched fold's plain path over dense keys of different row
    counts (LAST under the fold rule among them) against the reference's
    merges, and key by key against `fold_states_plain`, byte for byte."""
    per, stacked, positions = _dense_merge_case(seed, n_dev, n_local, with_last=True)
    order = [d * n_local + s for d, s in positions]
    got = agg.fold_state_dicts(per, n_local, order)
    assert list(got) == list(stacked)
    for key, st in stacked.items():
        full = {k: st.get(k, np.zeros_like(next(iter(st.values())), dtype=np.float64))
                for k in ("sums", "mins", "maxs", "last_val")}
        full.update({k: st.get(k, np.zeros(next(iter(st.values())).shape, np.int64))
                     for k in ("counts", "last_ts")})
        want = _ref_dense(full, positions, n_dev, n_local)
        one = _ref_dense(full, positions, 1, n_dev * n_local)
        want["mins"], want["maxs"] = one["mins"], one["maxs"]
        for name in st:
            ref = want[name]
            if name == "counts":
                ref = np.asarray(ref).astype(st[name].dtype)
            assert np.array_equal(_bits(getattr(got[key], name).numpy()), _bits(ref)), (key, name)
        plain = agg.fold_states_plain(agg.AggState(**{k: torch.from_numpy(v) for k, v in st.items()}),
                                      n_local, order)
        _assert_state_bits(got[key], plain, key)


@pytest.mark.parametrize("n_dev", [1, 8])
def test_fold_state_dicts_psum_rule_matches_psum_states(n_dev):
    """The table-fed route's merge (one partial per slot, `psum_states`'
    rules) over two keys of different rows: LAST and the sums as the
    reference's collective gives them."""
    st, _pos = _dense_case(41 + n_dev, n_dev, 1, rows=90)
    st2, _pos = _dense_case(51 + n_dev, n_dev, 1, rows=13)
    keyed = {"v": {k: st[k] for k in ("sums", "last_ts", "last_val")}, "w": {"sums": st2["sums"]}}
    per = [{} for _ in range(n_dev)]
    for key, s in keyed.items():
        for i, x in enumerate(_per_source(s, n_dev)):
            per[i][key] = x

    def per_device(t, v, s):
        out = jagg.psum_states(jagg.AggState(sums=s[0], last_ts=t[0], last_val=v[0]), REGION_AXIS)
        return out.last_ts, out.last_val, out.sums

    lt, lv, sums = _shard(per_device, n_dev)(*(jnp.asarray(st[k]) for k in
                                              ("last_ts", "last_val", "sums")))
    got = agg.fold_state_dicts(per, 1, list(range(n_dev)), rule="psum")
    assert np.array_equal(got["v"].last_ts.numpy(), np.asarray(lt))
    assert np.array_equal(_bits(got["v"].last_val.numpy()), _bits(lv))
    assert np.array_equal(_bits(got["v"].sums.numpy()), _bits(sums))
    w = agg.fold_states_plain(agg.AggState(sums=torch.from_numpy(st2["sums"])), 1,
                              list(range(n_dev)), rule="psum")
    _assert_state_bits(got["w"], w, "w")


def _keyed_merge_case(seed, n_dev, n_local, h, trailing):
    tables, st, positions = _keyed_case(seed, n_dev, n_local, h, trailing)
    m = n_dev * n_local
    rng = np.random.default_rng(seed + 100)
    stacked = {"usage_user": st, "usage_idle": {"sums": _values(rng, st["sums"].shape)},
               "__presence": {"counts": rng.integers(0, 9, st["counts"].shape).astype(np.int32)},
               "__hash_overflow": {"counts": rng.integers(0, 3, (m, 1)).astype(np.int32)}}
    for key in ("usage_idle", "__presence"):
        for name, v in stacked[key].items():
            for r in range(m):
                empty = np.concatenate([tables[r // n_local] == jagg.HASH_EMPTY,
                                        np.zeros(int(trailing), bool)])
                v[r, empty] = 0
    per = [{} for _ in range(m)]
    for key, s in stacked.items():
        for i, x in enumerate(_per_source(s, m)):
            per[i][key] = x
    return tables, per, stacked, positions


@pytest.mark.parametrize("n_dev,n_local,trailing", [(1, 3, True), (8, 1, False), (4, 2, True)])
def test_fold_state_dicts_keyed_matches_reference(n_dev, n_local, trailing):
    """Keyed keys (with the trailing row where the plan has one) and the
    dense `__hash_overflow` count in one merge: the reference's keyed
    scatters in global source order for every keyed key, its psum for the
    overflow, and `fold_states_plain` key by key, byte for byte."""
    h = 64
    tables, per, stacked, positions = _keyed_merge_case(60 + n_dev, n_dev, n_local, h, trailing)
    keys = torch.from_numpy(tables.reshape(-1).copy())
    union = torch.full((h,), agg.HASH_EMPTY, dtype=torch.int64)
    union, slots, ovf = agg.hash_group_slots(union, keys, keys != agg.HASH_EMPTY)
    assert int(ovf) == 0
    inv = agg.invert_slot_maps(slots.reshape(n_dev, h))
    slot_map = slots.reshape(n_dev, h).numpy()
    order = [d * n_local + s for d, s in positions]
    got = agg.fold_state_dicts(per, n_local, order, inv=inv, dense_keys=("__hash_overflow",))
    rows = h + int(trailing)
    for key in ("usage_user", "usage_idle", "__presence"):
        for name, g in stacked[key].items():
            g = jnp.asarray(g)
            big = jnp.finfo(g.dtype).max if g.dtype == jnp.float64 else jnp.iinfo(g.dtype).max
            acc = jnp.full((rows,), {"mins": big, "maxs": -big}.get(name, 0), g.dtype)
            for d, s in positions:
                idx = jnp.asarray(slot_map[d])
                if trailing:
                    idx = jnp.concatenate([idx, jnp.full((1,), h, idx.dtype)])
                upd = g[d * n_local + s]
                acc = (acc.at[idx].min(upd) if name == "mins" else acc.at[idx].max(upd)
                       if name == "maxs" else acc.at[idx].add(upd))
            assert np.array_equal(_bits(getattr(got[key], name).numpy()), _bits(acc)), (key, name)
        plain = agg.fold_states_plain(
            agg.AggState(**{k: torch.from_numpy(v) for k, v in stacked[key].items()}),
            n_local, order, inv=inv)
        _assert_state_bits(got[key], plain, key)
    over = stacked["__hash_overflow"]["counts"]
    assert got["__hash_overflow"].counts.tolist() == [int(over.sum())]


@pytest.mark.parametrize("m,n_order,fields_per_key,n_keys,want", [
    (4, 4, 1, 21, [21]),                 # double-groupby-all at 4 slots: one launch
    (8, 7, 6, 10, [10]),
    (8, 8, 4, 100, [64, 36]),            # the descriptor's 64 keys
    (64, 60, 6, 12, [9, 3]),             # its 3734 pointers: 390 a key
    (300, 290, 4, 5, [3, 2]),            # 1204 a key
    (4220, 4219, 4, 21, [21]),           # past 512 real sources: staged, the key cap alone
    (4220, 4219, 2, 100, [64, 36]),
])
def test_fold_launch_plan_splits_whole_keys(m, n_order, fields_per_key, n_keys, want):
    """A merge over the descriptor's capacity splits into launches of
    whole keys, in key order, each within the kernel's parameter space
    unless it is staged; past 512 real sources every launch is staged."""
    names = _FIELDS[:fields_per_key]
    keys = [(f"k{i}", names) for i in range(n_keys)]
    plan = agg.fold_launch_plan(keys, m, n_order)
    assert [len(u) for u in plan] == want
    assert [k for u in plan for k, _f in u] == [k for k, _f in keys]
    for units in plan:
        assert all(f == names for _k, f in units)
        assert len(units) <= agg._FOLD_MAX_KEYS
        staged = agg.fold_launch_staged(units, m, n_order)
        assert staged == (n_order > agg._FOLD_MAX_ORDER)
        assert staged or sum(len(f) * (m + 1) for _k, f in units) <= agg._FOLD_MAX_PTRS


@pytest.mark.parametrize("n_order,want,staged", [
    (500, [["a"], ["b"], ["c"]], [False, True, False]),   # b alone passes the pointers
    (600, [["a", "b", "c"]], [True]),                     # past 512 real sources
])
def test_fold_launch_plan_stages_a_wide_key(n_order, want, staged):
    """A key wider than a descriptor of its own keeps its fields together
    in a launch of its own, staged; the keys beside it are not."""
    keys = [("a", ("sums",)), ("b", _FIELDS), ("c", ("counts",))]
    plan = agg.fold_launch_plan(keys, 900, n_order)
    assert [[k for k, _f in u] for u in plan] == want
    assert [u for launch in plan for u in launch] == keys
    assert [agg.fold_launch_staged(u, 900, n_order) for u in plan] == staged


def test_fold_descriptor_mirrors_the_kernel():
    """_FoldDesc's capacity and size are csrc/fold_states.cu's FoldDesc: it
    fits sm_90's 32,764 bytes of kernel parameters."""
    import ctypes
    import os
    import re

    src = open(os.path.join(os.path.dirname(agg.__file__), "..", "csrc",
                            "fold_states.cu")).read()
    consts = dict(re.findall(r"constexpr int (kMax\w+) = (\d+);", src))
    assert int(consts["kMaxKeys"]) == agg._FOLD_MAX_KEYS
    assert int(consts["kMaxOrder"]) == agg._FOLD_MAX_ORDER
    assert int(consts["kMaxPtrs"]) == agg._FOLD_MAX_PTRS
    assert ctypes.sizeof(agg._FoldKey) == 24
    assert ctypes.sizeof(agg._FoldDesc) == 32760 <= 32764


_EMU_DTYPES = {0: torch.float64, 1: torch.float32, 2: torch.int64, 3: torch.int32}


def _emulated_launch(name, fn, a, stream):
    """csrc/fold_states.cu's kernel read from its descriptor alone, on host
    memory: each key's rows, fields, types, outputs and source row bases
    from the descriptor (or, staged, from its table: pointers, each real
    source's row of inv, `order`), folded by the plain version."""
    import ctypes

    assert (name, fn) == ("fold_states", "gt_fold_states") and stream == 0
    assert a.desc_bytes == ctypes.sizeof(agg._FoldDesc)
    m = a.m
    rule = "psum" if a.rule == 1 else "fold"
    blocks = 0

    def view(ptr, rows, dtype):
        nbytes = rows * torch.empty((), dtype=dtype).element_size()
        return torch.frombuffer((ctypes.c_char * nbytes).from_address(ptr), dtype=dtype)

    if a.table:
        ptrs = view(a.table, a.n_ptrs, torch.int64).tolist()
        rows_of = view(a.table + 8 * a.n_ptrs, a.n_order, torch.int64).tolist()
        order = view(a.table + 8 * (a.n_ptrs + a.n_order), a.n_order, torch.int32).tolist()
        assert rows_of == [a.inv + (k // a.n_local) * a.h * 4 if a.inv else 0 for k in order]
    else:
        assert a.n_ptrs <= agg._FOLD_MAX_PTRS and a.n_order <= agg._FOLD_MAX_ORDER
        ptrs, order = a.ptrs, list(a.order[:a.n_order])
    for i in range(a.n_keys):
        k = a.keys[i]
        blocks += -(-k.rows // 256)
        assert a.blk_end[i] == blocks
        p, st, outs = k.ptr0, agg.AggState(), {}
        for f, field in enumerate(_FIELDS):
            if not (k.present >> f) & 1:
                continue
            dtype = (torch.int64 if field == "last_ts" else torch.float64
                     if field == "last_val" else _EMU_DTYPES[k.dtype[f]])
            outs[field] = view(ptrs[p], k.rows, dtype)
            setattr(st, field, torch.stack([view(ptrs[p + 1 + j], k.rows, dtype)
                                            for j in range(m)]))
            p += m + 1
        inv = None
        if k.keyed:
            inv = view(a.inv, a.n_slots * a.h, torch.int32).view(a.n_slots, a.h)
        res = agg.fold_states_plain(st, a.n_local, order, inv, rule)
        for field, out in outs.items():
            out.copy_(getattr(res, field))
    assert a.n_blocks == blocks
    emulated.append(bool(a.table))


emulated: list = []


def _planned(items, m, n_order) -> list[bool]:
    """Whether each launch `fold_launch_plan` makes of these items is staged."""
    plan = agg.fold_launch_plan([(key, tuple(f for f in _FIELDS if f in per))
                                 for key, per, _k in items], m, n_order)
    return [agg.fold_launch_staged(u, m, n_order) for u in plan]


@pytest.mark.parametrize("n_dev,n_local,max_ptrs,max_order", [
    (4, 2, None, None),    # one launch
    (4, 2, 20, None),      # a smaller descriptor: several launches, the wider keys staged
    (4, 2, None, 3),       # more real sources than it holds: every launch staged
    (8, 80, None, None),   # 640 sources (more than 512 real) at the real capacity
])
def test_fold_descriptor_layout_through_an_emulated_kernel(monkeypatch, n_dev, n_local,
                                                           max_ptrs, max_order):
    """What the wrapper hands the card: the merge's descriptors (and the
    staged launches' tables), read back by an emulation of the kernel,
    give `fold_states_plain`'s bytes key by key (dense keys of different
    rows, LAST, keyed keys with the trailing row, the dense overflow
    count), in the launches `fold_launch_plan` makes."""
    from greptimedb_tpu_torch.kernels import _build

    monkeypatch.setattr(_build, "launch", _emulated_launch)
    monkeypatch.setattr(_build, "upload_table",
                        lambda raw, dev: torch.frombuffer(bytearray(raw), dtype=torch.uint8))
    monkeypatch.setattr(agg, "_FOLD_LAYOUTS", {})  # layouts are built for the capacity
    if max_ptrs is not None:
        monkeypatch.setattr(agg, "_FOLD_MAX_PTRS", max_ptrs)
    if max_order is not None:
        monkeypatch.setattr(agg, "_FOLD_MAX_ORDER", max_order)
    cpu = torch.device("cpu")
    m = n_dev * n_local
    per, stacked, positions = _dense_merge_case(71, n_dev, n_local, with_last=True)
    order = [d * n_local + s for d, s in positions]
    items = agg._fold_items(per, None, ())
    emulated.clear()
    l0, g0 = agg.fold_states.launches, agg.fold_states.merges
    got = agg._fold_on_card(cpu, -1, items, m, n_local, order, None, "fold", 0)
    assert agg.fold_states.launches - l0 == len(emulated)
    assert emulated == _planned(items, m, len(order))
    assert len(emulated) == 1 if max_ptrs is None else len(emulated) > 1
    assert any(emulated) == (max_ptrs is not None or max_order is not None or len(order) > 512)
    assert agg.fold_states.merges - g0 == 1
    for key, st in stacked.items():
        plain = agg.fold_states_plain(agg.AggState(**{k: torch.from_numpy(v)
                                                      for k, v in st.items()}), n_local, order)
        _assert_state_bits(got[key], plain, key)
    # keyed, with the trailing row and the dense overflow count
    k_local = 200 if n_local > 2 else 1   # 800 sources, more than 512 real
    tables, kper, kstacked, kpos = _keyed_merge_case(72, 4, k_local, 64, True)
    keys = torch.from_numpy(tables.reshape(-1).copy())
    union = torch.full((64,), agg.HASH_EMPTY, dtype=torch.int64)
    _u, slots, _o = agg.hash_group_slots(union, keys, keys != agg.HASH_EMPTY)
    inv = agg.invert_slot_maps(slots.reshape(4, 64))
    korder = [d * k_local + s for d, s in kpos]
    items = agg._fold_items(kper, inv, ("__hash_overflow",))
    emulated.clear()
    got = agg._fold_on_card(cpu, -1, items, 4 * k_local, k_local, korder, inv, "fold", 0)
    assert emulated == _planned(items, 4 * k_local, len(korder))
    assert all(emulated) if len(korder) > 512 or max_order is not None else not any(emulated)
    for key, st in kstacked.items():
        plain = agg.fold_states_plain(agg.AggState(**{k: torch.from_numpy(v) for k, v in st.items()}),
                                      k_local, korder, None if key == "__hash_overflow" else inv)
        _assert_state_bits(got[key], plain, key)
    # the merged fields are views of one allocation
    bases = {getattr(st, f).untyped_storage().data_ptr() for st in got.values()
             for f in _FIELDS if getattr(st, f) is not None}
    assert len(bases) == 1


def test_fold_state_dicts_rejects_mixed_sources():
    a = {"k": agg.AggState(sums=torch.zeros(3, dtype=torch.float64))}
    b = {"k": agg.AggState(counts=torch.zeros(3, dtype=torch.int32))}
    with pytest.raises(ValueError):
        agg._fold_items([a, b], None, ())
    with pytest.raises(ValueError):
        agg.fold_state_dicts([a, a], 3, [0])
    with pytest.raises(ValueError):
        agg.fold_state_dicts([], 1, [0])


def test_invert_slot_maps_plain():
    slot_map = torch.tensor([[2, 4, 0, 4], [4, 3, 1, 4]], dtype=torch.int32)
    assert agg.invert_slot_maps(slot_map).tolist() == [[2, -1, 0, -1], [-1, 2, -1, 1]]


def test_mesh_positions_match_the_reference_rule():
    """`_stack_mesh_inputs`: a source keeps its placed slot while the slot
    has room, else the least loaded slot (ties to the lowest)."""
    run = [(None, s) for s in (0, 0, 0, 5, None, 1)]
    assert tile_program.mesh_positions(run, 4, 2) == [
        (0, 0), (0, 1), (1, 0), (2, 0), (3, 0), (1, 1)]


# ---- the tests/test_multichip.py fixture in both packages ---------------------------


def _load_multichip(db):
    rng = np.random.default_rng(42)
    n = 9000
    hosts = np.array([f"h{i % 40}" for i in range(n)])
    regions = [None if i % 11 == 0 else f"r{i % 5}" for i in range(n)]
    ts = np.arange(n, dtype=np.int64) * 700
    v = rng.uniform(-100, 100, n)
    w = np.where(rng.uniform(0, 1, n) < 0.25, np.nan, rng.uniform(0, 50, n))
    rows = pa.table({
        "host": pa.array(hosts), "region": pa.array(regions),
        "ts": pa.array(ts, pa.timestamp("ms")), "v": pa.array(v), "w": pa.array(w, pa.float64()),
    })
    db.sql("CREATE TABLE t (host STRING, region STRING, ts TIMESTAMP TIME INDEX,"
           " v DOUBLE, w DOUBLE, PRIMARY KEY (host, region)) PARTITION BY HASH (host) PARTITIONS 3")
    if isinstance(db, JaxDatabase):
        db.insert_rows("t", rows)
        db.sql("ADMIN flush_table('t')")
    else:
        db.write("t", rows)
        db.flush()


def _jax_mesh_db(home) -> JaxDatabase:
    d = JaxDatabase(data_home=str(home))
    d.config.query.disabled_passes = ("cold_host_serve", "host_fast_path")
    d.config.query.tile_chunk_rows = 4096
    d.query_engine.tile_cache.chunk_rows = 4096
    return d


def _port_mesh_db(home, slots=8) -> Database:
    d = Database(str(home), device=["cpu"] * slots)
    d.config.query.disabled_passes = ("cold_host_serve", "host_fast_path")
    d.config.query.tile_chunk_rows = 4096
    return d


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    ref = _jax_mesh_db(tmp_path_factory.mktemp("mesh_ref"))
    port = _port_mesh_db(tmp_path_factory.mktemp("mesh_port"))
    _load_multichip(ref)
    _load_multichip(port)
    yield port, ref
    port.close()
    ref.close()


BASE_QUERIES = [
    "SELECT host, time_bucket('10s', ts) AS tb, count(*) AS c, sum(v) AS s,"
    " avg(w) AS aw, min(v) AS mn, max(v) AS mx FROM t GROUP BY host, tb",
    "SELECT region, count(w) AS cw, avg(v) AS av FROM t GROUP BY region",
    "SELECT count(*) AS c, sum(v) AS s, min(w) AS mn FROM t",
    "SELECT time_bucket('30s', ts) AS tb, max(v) AS mx FROM t WHERE v > 0 GROUP BY tb",
    "SELECT host, last_value(v) AS lv FROM t GROUP BY host",
]


def _column_bits(col) -> tuple:
    """A result column as (type, null mask, value bytes): floats by their
    bits, so -0.0, +0.0 and each NaN are told apart."""
    col = col.combine_chunks() if isinstance(col, pa.ChunkedArray) else col
    nulls = np.asarray(col.is_null().to_numpy(zero_copy_only=False), bool)
    if pa.types.is_floating(col.type) or pa.types.is_integer(col.type):
        vals = np.ascontiguousarray(col.fill_null(0).to_numpy(zero_copy_only=False))
        return str(col.type), nulls.tobytes(), vals.tobytes()
    return str(col.type), nulls.tobytes(), repr(col.to_pylist()).encode()


def _assert_bytes(got: pa.Table, want: pa.Table, q: str):
    """Byte-identical results: names, types, nulls and value bits."""
    assert got.column_names == want.column_names, (q, got.column_names, want.column_names)
    assert got.num_rows == want.num_rows, (q, got.num_rows, want.num_rows)
    for c in got.column_names:
        assert _column_bits(got[c]) == _column_bits(want[c]), (q, c)


def _port_at(port, q, n):
    port.config.tile.mesh_devices = n
    try:
        return port.sql_one(q)
    finally:
        port.config.tile.mesh_devices = 0


def _assert_mesh_parity(pair, q, monkeypatch):
    """The port at mesh_devices 0, 1 and 8: the same bytes, each run a mesh
    dispatch through K22; and byte for byte the reference's 8-device mesh
    answer.  The one exception predates the mesh: a float column whose
    single-device answers already differ in the last ulp (the f64 sums of
    some shapes) is held within rel 1e-12, and the mesh changes no byte of
    it on either side."""
    port, ref = pair
    folds = []
    plain = agg.fold_states_plain
    monkeypatch.setattr(agg, "fold_states_plain", lambda *a, **k: folds.append(1) or plain(*a, **k))
    eng = port.query_engine
    single = _port_at(port, q, 0)
    assert eng.last_path == "tile" and not folds, q
    m0 = eng.stats.get("mesh_dispatches", 0)
    eight, one = _port_at(port, q, 8), _port_at(port, q, 1)
    assert eng.last_path == "tile" and folds, q
    assert eng.stats.get("mesh_dispatches", 0) - m0 == 2, q
    _assert_bytes(eight, single, q)
    _assert_bytes(one, single, q)
    ref_single = ref.sql_one(q)
    ref.config.tile.mesh_devices = 8
    try:
        d0 = metrics.TILE_MESH_DISPATCHES.get()
        want = ref.sql_one(q)
        assert metrics.TILE_MESH_DISPATCHES.get() == d0 + 1, f"the reference did not mesh: {q}"
    finally:
        ref.config.tile.mesh_devices = 0
    assert eight.column_names == want.column_names and eight.num_rows == want.num_rows, q
    for c in eight.column_names:
        if _column_bits(single[c]) == _column_bits(ref_single[c]):
            assert _column_bits(eight[c]) == _column_bits(want[c]), (q, c)
        else:
            assert pa.types.is_floating(eight[c].type), (q, c)
            assert _column_bits(want[c]) == _column_bits(ref_single[c]), (q, c)
            _assert_same(eight.select([c]), want.select([c]), q, ordered=True)


@pytest.mark.parametrize("q", BASE_QUERIES)
def test_mesh_bit_parity(pair, q, monkeypatch):
    for db in pair:
        db.config.query.agg_strategy = "auto"
    _assert_mesh_parity(pair, q, monkeypatch)


def test_mesh_nan_in_one_region(tmp_path):
    """NaN values in one host's rows only, hence in one region and on the
    mesh slots of its chunks: min, max, sum, avg and count at
    mesh_devices 0 and 8 give the same bytes in both packages (the tile
    encode stores a NaN value as 0 in both, so no state holds a NaN)."""
    rng = np.random.default_rng(7)
    n = 9000
    hosts = np.array([f"h{i % 40}" for i in range(n)])
    w = np.where(hosts == "h7", np.nan, rng.uniform(-50, 50, n))
    rows = pa.table({
        "host": pa.array(hosts), "region": pa.array([f"r{i % 5}" for i in range(n)]),
        "ts": pa.array(np.arange(n, dtype=np.int64) * 700, pa.timestamp("ms")),
        "w": pa.array(w, pa.float64()),
    })
    ref = _jax_mesh_db(tmp_path / "nref")
    port = _port_mesh_db(tmp_path / "nport")
    try:
        for db in (ref, port):
            db.sql("CREATE TABLE t (host STRING, region STRING, ts TIMESTAMP TIME INDEX,"
                   " w DOUBLE, PRIMARY KEY (host, region)) PARTITION BY HASH (host) PARTITIONS 3")
        ref.insert_rows("t", rows)
        ref.sql("ADMIN flush_table('t')")
        port.write("t", rows)
        port.flush()
        for q in ("SELECT min(w) AS mn, max(w) AS mx, count(w) AS c FROM t",
                  "SELECT region, min(w) AS mn, max(w) AS mx, sum(w) AS s FROM t GROUP BY region",
                  "SELECT host, min(w) AS mn, max(w) AS mx, avg(w) AS a FROM t GROUP BY host"):
            answers = []
            m0 = port.query_engine.stats.get("mesh_dispatches", 0)
            for db in (port, ref):
                for n_dev in (0, 8):
                    db.config.tile.mesh_devices = n_dev
                    try:
                        answers.append(db.sql_one(q))
                    finally:
                        db.config.tile.mesh_devices = 0
            assert port.query_engine.last_path == "tile"
            assert port.query_engine.stats.get("mesh_dispatches", 0) == m0 + 1, q
            for other in answers[1:]:
                _assert_bytes(answers[0], other, q)
    finally:
        ref.close()
        port.close()


@pytest.mark.parametrize("strategy", ["sort", "hash"])
def test_mesh_parity_across_strategies(pair, strategy, monkeypatch):
    for db in pair:
        db.config.query.agg_strategy = strategy
    try:
        _assert_mesh_parity(pair, "SELECT host, region, count(*) AS c, sum(v) AS s,"
                            " avg(w) AS aw, max(v) AS mx, min(w) AS mnw FROM t"
                            " GROUP BY host, region", monkeypatch)
        assert pair[0].query_engine.stats["agg_" + strategy] > 0
    finally:
        for db in pair:
            db.config.query.agg_strategy = "auto"


def test_hash_packed_bytes_match_reference(pair, monkeypatch):
    """Keyed mode, the union table and the trailing rows: the packed result
    buffers of a hash query (the slot rows, the overflow byte, the key
    table) are the reference's, at 8 devices on both sides."""
    from greptimedb_tpu.parallel.tile_cache import TileExecutor as JaxTileExecutor
    from greptimedb_tpu_torch.parallel.tile_executor import TileExecutor

    port, ref = pair
    q = "SELECT host, region, count(*) AS c, sum(v) AS s, min(w) AS mnw FROM t GROUP BY host, region"
    got, want = [], []
    port_fetch, ref_fetch = TileExecutor._fetch_result, JaxTileExecutor._fetch_result
    monkeypatch.setattr(TileExecutor, "_fetch_result",
                        staticmethod(lambda packed: got.append(port_fetch(packed)) or got[-1]))
    monkeypatch.setattr(JaxTileExecutor, "_fetch_result",
                        lambda self, packed: want.append(ref_fetch(self, packed)) or want[-1])
    for db in pair:
        db.config.query.agg_strategy = "hash"
        db.config.tile.mesh_devices = 8
    try:
        port.sql_one(q)
        ref.sql_one(q)
    finally:
        for db in pair:
            db.config.query.agg_strategy = "auto"
            db.config.tile.mesh_devices = 0
    assert len(got) == 1 and len(want) == 1
    assert len(got[0]) == len(want[0]) == 3
    for a, b in zip(got[0], want[0]):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


@pytest.mark.parametrize("topk", [True, False])
def test_mesh_parity_device_finalize(pair, topk, monkeypatch):
    for db in pair:
        db.config.query.device_topk = topk
    try:
        _assert_mesh_parity(pair, "SELECT host, avg(v) AS av FROM t GROUP BY host"
                            " HAVING avg(v) > -5.0 ORDER BY av DESC LIMIT 6", monkeypatch)
    finally:
        for db in pair:
            db.config.query.device_topk = True


@pytest.mark.parametrize("draw", range(6))
def test_mesh_randomized_parity(pair, draw, monkeypatch):
    """tests/test_multichip.py's seeded draws (one per case)."""
    rng = random.Random(20260804)
    aggs = ["count(*) AS c", "sum(v) AS s", "avg(v) AS av", "min(v) AS mn",
            "max(v) AS mx", "avg(w) AS aw", "count(w) AS cw", "sum(w) AS sw"]
    groups = ["host", "region", "host, region"]
    filters = ["", " WHERE v > 10", " WHERE w < 40", " WHERE host != 'h3'"]
    for _ in range(draw + 1):
        g = rng.choice(groups)
        picked = rng.sample(aggs, rng.randint(2, 4))
        q = f"SELECT {g}, {', '.join(picked)} FROM t{rng.choice(filters)} GROUP BY {g}"
        strategy = rng.choice(["auto", "sort", "hash"])
    for db in pair:
        db.config.query.agg_strategy = strategy
    try:
        _assert_mesh_parity(pair, q, monkeypatch)
    finally:
        for db in pair:
            db.config.query.agg_strategy = "auto"


def test_mesh_ineligible_shape_takes_the_single_device_dispatch(pair, monkeypatch):
    """A shape verdict, not an error: the query is answered by the
    single-device dispatch, with a pass note and no mesh dispatch."""
    port, _ref = pair
    q = "SELECT host, sum(v) AS s, count(*) AS c FROM t GROUP BY host"
    want = _port_at(port, q, 0).to_pydict()

    def ineligible(*_a, **_k):
        raise tile_program.MeshIneligible("a shape the mesh run does not express")

    monkeypatch.setattr(tile_program, "mesh_runs", ineligible)
    eng = port.query_engine
    m0 = eng.stats.get("mesh_dispatches", 0)
    trace = passes.PassTrace()
    with passes.use_trace(trace):
        got = _port_at(port, q, 8).to_pydict()
    assert got == want and eng.last_path == "tile"
    assert eng.stats.get("mesh_dispatches", 0) == m0
    notes = [d for d in trace.decisions if d.name == "mesh_dispatch"]
    assert notes and not notes[-1].fired and "single-device dispatch" in notes[-1].why


def test_failure_inside_k22_raises(pair, monkeypatch):
    """No degrade: a failure inside the mesh fold raises out of
    Database.sql, and the next query meshes again."""
    port, _ref = pair
    q = "SELECT host, sum(v) AS s FROM t GROUP BY host"
    want = _port_at(port, q, 0).to_pydict()

    def broken(*_a, **_k):
        raise RuntimeError("injected K22 failure")

    plain = agg.fold_states_plain
    monkeypatch.setattr(agg, "fold_states_plain", broken)
    with pytest.raises(RuntimeError, match="injected K22 failure"):
        _port_at(port, q, 8)
    monkeypatch.setattr(agg, "fold_states_plain", plain)
    assert _port_at(port, q, 8).to_pydict() == want


def test_mesh_off_is_default_and_off_safe(pair):
    from greptimedb_tpu_torch.utils.config import TileConfig

    port, _ref = pair
    assert TileConfig().mesh_devices == 0
    m0 = port.query_engine.stats.get("mesh_dispatches", 0)
    port.sql_one("SELECT host, sum(v) AS s FROM t GROUP BY host")
    assert port.query_engine.stats.get("mesh_dispatches", 0) == m0


# ---- config, placement -------------------------------------------------------------------


@pytest.mark.parametrize("value", [-1, "all", True, 9])
def test_mesh_devices_validation(value):
    cfg = Config()
    cfg.query.device = ("cpu",) * 8
    cfg.tile.mesh_devices = value
    with pytest.raises(ConfigError):
        cfg.validate()


def test_mesh_devices_validation_accepts_the_slots(tmp_path):
    cfg = Config()
    cfg.query.device = ("cpu",) * 8
    for n in (8, 1, 0):
        cfg.tile.mesh_devices = n
        cfg.validate()
    cfg.query.device = "cpu"
    cfg.tile.mesh_devices = 2
    with pytest.raises(ConfigError):
        cfg.validate()  # one slot
    db = Database(str(tmp_path / "v"), device=["cpu"] * 2)
    try:
        assert db.devices == ("cpu", "cpu") and db.query_engine.mesh == make_mesh(2, ["cpu"] * 2)
        assert db.device == "cpu" and db.config.query.first_device == "cpu"
        db.sql("CREATE TABLE m (k STRING, v DOUBLE, ts TIMESTAMP TIME INDEX, PRIMARY KEY (k))")
        db.sql("INSERT INTO m (k, v, ts) VALUES ('x', 1.5, 1), ('y', 2.5, 2)")
        db.flush()
        db.config.tile.mesh_devices = 3
        with pytest.raises(ConfigError):
            db.sql_one("SELECT k, sum(v) AS s FROM m GROUP BY k")
    finally:
        db.close()


def test_region_chunks_colocated_on_mesh(tmp_path):
    """With the mesh on at upload, a region's chunks start at its
    co-located slot — the reference's `chunk_device`, slot for slot."""
    ref = _jax_mesh_db(tmp_path / "cref")
    port = _port_mesh_db(tmp_path / "cport")
    try:
        placed = []
        for db in (ref, port):
            db.config.tile.mesh_devices = 8
            db.sql("CREATE TABLE t (host STRING, ts TIMESTAMP TIME INDEX, v DOUBLE,"
                   " PRIMARY KEY (host)) PARTITION BY HASH (host) PARTITIONS 3")
            n = 30000
            rows = pa.table({
                "host": pa.array([f"h{i % 30}" for i in range(n)]),
                "ts": pa.array(np.arange(n, dtype=np.int64) * 1000, pa.timestamp("ms")),
                "v": pa.array(np.arange(n, dtype=np.float64)),
            })
            if db is ref:
                db.insert_rows("t", rows)
                db.sql("ADMIN flush_table('t')")
            else:
                db.write("t", rows)
                db.flush()
            db.sql_one("SELECT host, sum(v) AS s FROM t GROUP BY host")
            cache = db.query_engine.tile_cache
            slots = {}
            for rid, entry in cache._super.items():
                if db is ref:
                    devs = [next(iter(c.devices())) for c in entry.cols["v"]]
                    slots[rid] = [cache.devices.index(d) for d in devs]
                else:
                    slots[rid] = [entry.chunk_slot(i) for i in range(len(entry.cols["v"]))]
            placed.append(slots)
        ref_slots, port_slots = placed
        # the reference pads a region to a power of two, the port to a
        # multiple of 4096: the chunks they share sit on the same slots
        assert set(ref_slots) == set(port_slots) and len(port_slots) == 3
        for rid, s in port_slots.items():
            assert len(s) > 1
            assert s == [(region_device_index(rid, 8) + i) % 8 for i in range(len(s))]
            k = min(len(s), len(ref_slots[rid]))
            assert s[:k] == ref_slots[rid][:k]
    finally:
        ref.close()
        port.close()


# ---- the table-fed route at 8 slots ---------------------------------------------------


def test_table_fed_route_at_8_slots(tmp_path):
    """Region tables on slots i % 8, partials per slot, K22 in slot order;
    the reference's table-fed mesh over its 8 devices: within rel 1e-12
    (its float sums are XLA's psum; on the CPU that is the same left fold,
    so the bytes come out equal here)."""
    cfg = JaxConfig()
    cfg.query.tile_cache_enable = False
    cfg.query.fallback_to_cpu = False
    ref = JaxDatabase(config=cfg, data_home=str(tmp_path / "tref"))
    port = Database(str(tmp_path / "tport"), device=["cpu"] * 8)
    port.config.query.tile_cache_enable = False
    try:
        rng = np.random.default_rng(8)
        n = 6000
        rows = pa.table({
            "host": pa.array([f"h{i % 64}" for i in range(n)]),
            "ts": pa.array(np.arange(n, dtype=np.int64) * 1000, pa.timestamp("ms")),
            "v": pa.array(rng.uniform(-100, 100, n)),
            "w": pa.array([None if i % 9 == 0 else float(x) for i, x in
                           enumerate(rng.uniform(0, 50, n))], pa.float64()),
        })
        for db in (ref, port):
            db.sql("CREATE TABLE tf (host STRING, ts TIMESTAMP TIME INDEX, v DOUBLE, w DOUBLE,"
                   " PRIMARY KEY (host)) PARTITION BY HASH (host) PARTITIONS 8")
        ref.insert_rows("tf", rows)
        ref.sql("ADMIN flush_table('tf')")
        port.write("tf", rows)
        port.flush()
        assert len(port.catalog.table("tf", "public").region_ids) == 8
        folds = []
        plain = agg.fold_states_plain
        agg.fold_states_plain = lambda *a, **k: folds.append(1) or plain(*a, **k)
        try:
            for q in ("SELECT host, time_bucket('10m', ts) AS tb, count(*) AS c, sum(v) AS s,"
                      " avg(w) AS aw, min(v) AS mn, max(w) AS mx FROM tf GROUP BY host, tb",
                      "SELECT host, last_value(v) AS lv, count(w) AS cw FROM tf GROUP BY host",
                      "SELECT count(*) AS c, sum(v) AS s, max(v) AS mx, min(w) AS mn FROM tf"):
                got = port.sql_one(q)
                assert port.query_engine.last_path == "table" and folds, q
                _assert_same(got, ref.sql_one(q), q, ordered=True)
        finally:
            agg.fold_states_plain = plain
    finally:
        ref.close()
        port.close()


def test_table_fed_route_with_more_slots_than_tables(tmp_path):
    """A slot with no region table folds the identity (the reference's
    table-fed mesh raises here instead)."""
    port = Database(str(tmp_path / "few"), device=["cpu"] * 8)
    one = Database(str(tmp_path / "one"), device="cpu")
    try:
        for db in (port, one):
            db.config.query.tile_cache_enable = False
            db.sql("CREATE TABLE m (k STRING, v DOUBLE, ts TIMESTAMP TIME INDEX, PRIMARY KEY (k))"
                   " PARTITION BY HASH (k) PARTITIONS 2")
            db.sql("INSERT INTO m (k, v, ts) VALUES ('x', 1.5, 1), ('y', -0.0, 2), ('x', 3.5, 3),"
                   " ('z', 2.0, 4)")
        q = "SELECT k, sum(v) AS s, min(v) AS mn, max(v) AS mx, last_value(v) AS l FROM m GROUP BY k"
        assert port.sql_one(q).to_pydict() == one.sql_one(q).to_pydict()
        assert port.query_engine.last_path == "table"
    finally:
        port.close()
        one.close()


# ---- the TQL mesh route -----------------------------------------------------------------


def test_tql_mesh_route(tmp_path_factory):
    """Each region's K9/K10 on its co-located slot, K11/K12 on slot 0:
    the same bytes as the single-device program, and the reference's
    legacy answer within the tolerance of tests/test_torch_tql_routes.py."""
    from test_torch_promql import _assert_same as tql_same
    from test_torch_promql import _jax_db, _load_counter

    class _MeshPair:
        def __init__(self):
            self.port = Database(str(tmp_path_factory.mktemp("tmesh_port")), device=["cpu"] * 4)
            self.ref = _jax_db(str(tmp_path_factory.mktemp("tmesh_ref")))

        def sql(self, text):
            self.port.sql(text)
            self.ref.sql(text)

        def flush(self):
            self.port.flush()
            self.ref.storage.flush_all()

    pair = _MeshPair()
    try:
        _load_counter(pair, np.random.default_rng(29), hosts=6, ticks=30, table="mq",
                      partitions=3)
        eng = pair.port.query_engine
        for q in ("TQL EVAL (60, 420, '30s') rate(mq[2m])",
                  "TQL EVAL (60, 420, '30s') sum(rate(mq[2m]))",
                  "TQL EVAL (60, 420, '30s') max(avg_over_time(mq[2m]))"):
            single = pair.port.sql_one(q)
            pair.port.config.tile.mesh_devices = 4
            try:
                m0, t0 = eng.stats.get("mesh_dispatches", 0), eng.stats["tql_tile_dispatches"]
                meshed = pair.port.sql_one(q)
                assert eng.stats.get("mesh_dispatches", 0) == m0 + 1
                assert eng.stats["tql_tile_dispatches"] == t0 + 1
            finally:
                pair.port.config.tile.mesh_devices = 0
            tql_same(meshed, single, q)
            tql_same(meshed, pair.ref.sql_one(q), q, rtol=1e-12 if "rate" in q else 0.0)
    finally:
        pair.port.close()
        pair.ref.close()


# ---- the dashboard tick with the mesh on ---------------------------------------------------


def test_tick_with_the_mesh_dispatches_per_member(tmp_path):
    """While tile.mesh_devices > 0 a tick does not fuse: its members
    dispatch over the mesh one by one (one shared readback), and each
    result is the member's solo bytes."""
    from test_torch_batch import _QUERIES, _WIN, _concurrent, _delta, _load, _ser

    cfg = Config()
    cfg.query.agg_strategy = "sort"
    cfg.batch.window_ms = _WIN
    db = Database(str(tmp_path / "tick"), device=["cpu"] * 4, config=cfg)
    try:
        _load(db, 9, n=2_500)
        db.config.tile.mesh_devices = 4
        queries = list(_QUERIES[:3])
        db.config.batch.window_ms = 0.0
        solo = {}
        for q in queries:
            db.sql_one(q)
            solo[q] = _ser(db.sql_one(q))
        db.config.batch.window_ms = _WIN
        for _ in range(8):
            before = dict(db.query_engine.stats)
            results, errors = _concurrent(db, queries)
            assert not errors, errors
            d = _delta(db, before)
            if d["batch_ticks"] == 1 and d["batch_members"] == len(queries):
                break
        else:
            pytest.fail("no clean tick formed (timing-dependent membership)")
        assert d["batch_fused_dispatches"] == 0 and d["tick_graph_replays"] == 0
        assert d.get("mesh_dispatches", 0) == len(queries)
        for q, r in zip(queries, results):
            assert _ser(r) == solo[q]
    finally:
        db.close()


def test_fold_states_rejects_bad_shapes():
    st = agg.AggState(sums=torch.zeros(4, 3, dtype=torch.float64))
    with pytest.raises(ValueError):
        agg.fold_states_plain(st, 3, [0])  # 4 sources are not slots of 3
    with pytest.raises(ValueError):
        agg.fold_states_plain(st, 1, [])
    with pytest.raises(ValueError):
        agg.fold_states_plain(st, 1, [0], rule="first")
    assert math.isclose(float(agg.fold_states_plain(
        agg.AggState(sums=torch.ones(4, 3, dtype=torch.float64)), 1, [0, 2]).sums[0]), 2.0)
