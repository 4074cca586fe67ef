"""Kernel-level parity of the plane kernels K14-K16 (their plain torch
versions, which CPU tensors run) and of the delta merge's host half,
against the JAX reference on the same seeded numpy inputs:

* K14 `ts_argsort` equals `jnp.argsort(jnp.where(valid, ts, INT64_MAX))`
  (the reference's `ensure_perm`, stable) with ties, negative and
  extreme keys, invalid rows and two or more chunks;
* K15 `gather_planes` in remap mode equals `jnp.take(perm, codes,
  mode="fill", fill_value=-1)` (the reference's `repair_super`) for codes
  in [-n-2, n+2); in gather mode, the reference's
  `concatenate(chunks)[perm]` cut at the chunk bounds;
* K16 `delta_patch` equals the reference's `_delta_patch`, and the port's
  `_lex_merge_positions` the reference's, on seeded runs with ties, the
  delta at the front, the back or interleaved, and an empty delta.

Every comparison is exact (integers, booleans, and f64 values moved
without arithmetic)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from greptimedb_tpu.parallel.tile_cache import _delta_patch as r_delta_patch
from greptimedb_tpu.parallel.tile_cache import _lex_merge_positions as r_merge
from greptimedb_tpu_torch.ops import permute as P
from greptimedb_tpu_torch.parallel.tile_planes import _lex_merge_positions as p_merge

I64_MAX = np.iinfo(np.int64).max
I64_MIN = np.iinfo(np.int64).min


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _chunks(a, rows):
    return [_t(a[o:o + rows]) for o in range(0, len(a), rows)]


def _ts_case(case, rng, n):
    if case == "scrape_ties":  # every host of one scrape shares its ts
        return np.repeat(np.arange(-(-n // 40), dtype=np.int64) * 10_000, 40)[:n]
    if case == "negative":
        return rng.integers(-50, 50, n).astype(np.int64)
    if case == "extremes":
        return rng.choice(np.array([I64_MIN, I64_MIN + 1, -1, 0, 1, I64_MAX - 1, I64_MAX]), n)
    return rng.integers(I64_MIN, I64_MAX, n, dtype=np.int64)  # "wide": all eight radix passes


@pytest.mark.parametrize("case", ["scrape_ties", "negative", "extremes", "wide"])
@pytest.mark.parametrize("p_valid", [1.0, 0.6, 0.0])
@pytest.mark.parametrize("chunk_rows", [4096, 1 << 24])
def test_ts_argsort_equals_jnp_argsort(case, p_valid, chunk_rows):
    rng = np.random.default_rng(hash((case, p_valid)) % 2**32)
    n = 3 * 4096
    ts = _ts_case(case, rng, n)
    valid = rng.random(n) < p_valid
    valid[-500:] = False  # padding at the tail, as a super-tile holds it
    want = np.asarray(jnp.argsort(jnp.where(jnp.asarray(valid), jnp.asarray(ts), I64_MAX)))
    got = P.ts_argsort(_chunks(ts, chunk_rows), _chunks(valid, chunk_rows))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))


@pytest.mark.parametrize("n_table", [1, 2, 7, 4000])
def test_remap_equals_jnp_take_fill(n_table):
    rng = np.random.default_rng(n_table)
    table = rng.permutation(n_table + 96)[:n_table].astype(np.int32)
    codes = rng.integers(-n_table - 2, n_table + 2, 9000).astype(np.int32)
    codes[:6] = [-1, -n_table, -n_table - 1, n_table, n_table + 1, 0]
    want = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(codes), mode="fill",
                               fill_value=-1)).astype(np.int32)
    got = P.gather_planes(_chunks(codes, 4096), _t(table), remap=True)
    assert [c.shape[0] for c in got] == [4096, 4096, 808]
    np.testing.assert_array_equal(torch.cat(got).numpy(), want)


@pytest.mark.parametrize("dtype", [np.float64, np.int64, np.int32, np.bool_])
def test_gather_equals_reference_concat_take(dtype):
    rng = np.random.default_rng(3)
    n = 2 * 4096 + 1000
    x = rng.integers(-1000, 1000, n).astype(dtype)
    perm = rng.permutation(n).astype(np.int32)
    want = np.asarray(jnp.concatenate([jnp.asarray(c) for c in np.split(x, [4096, 8192])])[
        jnp.asarray(perm)])
    got = P.gather_planes(_chunks(x, 4096), _t(perm))
    assert [c.shape[0] for c in got] == [4096, 4096, 1000]
    np.testing.assert_array_equal(torch.cat(got).numpy(), want)


def _sorted_runs(rng, n_old, n_new, n_hosts):
    """Two (host code, ts)-sorted runs with ties across and inside them."""
    def run(n):
        h = rng.integers(0, n_hosts, n).astype(np.int32)
        t = rng.integers(0, 50, n).astype(np.int64) * 1000
        o = np.lexsort([t, h])
        return [h[o], t[o]]
    return run(n_old), run(n_new)


@pytest.mark.parametrize("n_old,n_new", [(5000, 300), (4096, 0), (0, 50), (1, 1), (3000, 4000)])
def test_lex_merge_positions_equal_reference(n_old, n_new):
    rng = np.random.default_rng(n_old + 7 * n_new)
    old, new = _sorted_runs(rng, n_old, n_new, 9)
    got = p_merge(old, new)
    want = r_merge(old, new)
    np.testing.assert_array_equal(got, want)
    # merging by these positions is the stable lexsort of the concatenation
    cat = [np.concatenate([o, x]) for o, x in zip(old, new)]
    stable = np.lexsort(cat[::-1], axis=0)
    merged = np.empty(n_old + n_new, np.int64)
    merged[np.arange(n_old) + np.searchsorted(got, np.arange(n_old), side="right")] = \
        np.arange(n_old)
    merged[got + np.arange(n_new)] = n_old + np.arange(n_new)
    np.testing.assert_array_equal(merged, stable)


@pytest.mark.parametrize("where", ["interleaved", "front", "back", "empty"])
@pytest.mark.parametrize("dtype", [np.float64, np.int32, np.bool_])
def test_delta_patch_equals_reference(where, dtype):
    rng = np.random.default_rng(11)
    old_n, n_delta = 9000, 0 if where == "empty" else 700
    old_pad = -(-old_n // 4096) * 4096
    new_pad = -(-(old_n + n_delta) // 4096) * 4096
    full = np.zeros(old_pad, dtype)
    full[:old_n] = rng.integers(1, 100, old_n).astype(dtype)
    delta = rng.integers(1, 100, n_delta).astype(dtype)
    pos = {
        "interleaved": np.sort(rng.integers(0, old_n + 1, n_delta)),
        "front": np.zeros(n_delta, np.int64),
        "back": np.full(n_delta, old_n),
        "empty": np.zeros(0, np.int64),
    }[where].astype(np.int32)
    want = np.asarray(r_delta_patch(jnp.asarray(full), jnp.asarray(delta), jnp.asarray(pos),
                                    old_n=old_n, new_pad=new_pad))
    got = P.delta_patch(_chunks(full, 4096), old_n, _t(delta), _t(pos), new_pad, 4096)
    assert all(c.shape[0] == 4096 for c in got) and len(got) == new_pad // 4096
    np.testing.assert_array_equal(torch.cat(got).numpy(), want)
