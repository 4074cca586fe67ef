"""Kernel-level parity of the plane kernels K14-K16 (their plain torch
versions, which CPU tensors run) and of the delta merge's host half,
against the JAX reference on the same seeded numpy inputs:

* K14 `ts_argsort` equals `jnp.argsort(jnp.where(valid, ts, INT64_MAX))`
  (the reference's `ensure_perm`, stable) with ties, negative and
  extreme keys, invalid rows and two or more chunks;
* K15 `gather_planes` in remap mode equals `jnp.take(perm, codes,
  mode="fill", fill_value=-1)` (the reference's `repair_super`) for codes
  in [-n-2, n+2); in gather mode, the reference's
  `concatenate(chunks)[perm]` cut at the chunk bounds, one plane or
  several at once (`gather_planes_multi`, whose kernel's tiles and chunk
  lookup a numpy emulation holds to the same bytes);
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


def _gather_emulated(planes, perm, chunk_rows):
    """csrc/gather_planes.cu's gather kernel in numpy: tiles of 256 R output
    rows (R = 8 / planes as a power of two in [1, 4], kGatherLoads = 8),
    each inside one chunk (the chunk from the tile index), perm read once
    a row, the source chunk by a shift (chunk_rows a power of two) or a
    division, then that row of every plane.  Fails unless every output
    row is written exactly once."""
    nc, n = len(planes[0]), sum(c.size for c in planes[0])
    per = 8 // min(len(planes), 8)
    tile = 256 * (4 if per >= 4 else 2 if per >= 2 else 1)
    tpc = -(-chunk_rows // tile)
    n_tiles = (nc - 1) * tpc + -(-(n - (nc - 1) * chunk_rows) // tile)
    shift = chunk_rows.bit_length() - 1 if chunk_rows & (chunk_rows - 1) == 0 else -1
    outs = [[np.zeros_like(c) for c in p] for p in planes]
    written = [np.zeros(c.size, np.int64) for c in planes[0]]
    for t in range(n_tiles):
        dc = t // tpc
        rows = n - dc * chunk_rows if dc == nc - 1 else chunk_rows
        dof = (t - dc * tpc) * tile + np.arange(tile)
        dof = dof[dof < rows]
        src = perm[dc * chunk_rows + dof].astype(np.int64)
        sc = src >> shift if shift >= 0 else src // chunk_rows
        so = src - sc * chunk_rows
        written[dc][dof] += 1
        for p, out in zip(planes, outs):
            for c in np.unique(sc):
                out[dc][dof[sc == c]] = p[c][so[sc == c]]
    assert all((w == 1).all() for w in written)
    return outs


@pytest.mark.parametrize("chunk_rows", [4096, 5000, 256, 1 << 24])
def test_gather_multi_equals_reference_and_per_plane(chunk_rows):
    """K15's multi-plane gather (bool, int32, int64 and f64 planes at once)
    equals the one-plane `gather_planes_plain` of each and the reference's
    `concatenate(chunks)[perm]`: chunk_rows a power of two and not, a
    ragged last chunk, one chunk and 36; and so does a numpy emulation of
    the kernel's tiles, chunk lookup and row moves."""
    rng = np.random.default_rng(chunk_rows)
    n = 2 * 4096 + 1000
    xs = [rng.random(n) < 0.5, rng.integers(-2**31, 2**31, n).astype(np.int32),
          rng.integers(-2**62, 2**62, n), rng.normal(0, 1e3, n)]
    perm = rng.permutation(n).astype(np.int32)
    planes = [_chunks(x, chunk_rows) for x in xs]
    got = P.gather_planes_multi(planes, _t(perm))
    np_planes = [[c.numpy() for c in p] for p in planes]
    emulated = _gather_emulated(np_planes, perm, chunk_rows)
    # the kernel's other tilings: one or two planes (4 rows a thread), three
    # (2), thirteen (1)
    for sub in (np_planes[:1], np_planes[:2], np_planes[:3], (np_planes * 4)[:13]):
        for a, b in zip(_gather_emulated(sub, perm, chunk_rows), emulated):
            np.testing.assert_array_equal(np.concatenate(a), np.concatenate(b))
    assert len(got) == len(xs)
    for x, p, g, e in zip(xs, planes, got, emulated):
        bounds = np.cumsum([c.shape[0] for c in p])[:-1]
        want = np.asarray(jnp.concatenate([jnp.asarray(c) for c in np.split(x, bounds)])[
            jnp.asarray(perm)])
        assert [c.shape[0] for c in g] == [c.shape[0] for c in p]
        assert all(c.dtype == p[0].dtype for c in g)
        np.testing.assert_array_equal(torch.cat(g).numpy(), want)
        np.testing.assert_array_equal(np.concatenate(e), want)
        for a, b in zip(g, P.gather_planes_plain(p, _t(perm))):
            assert torch.equal(a, b)
    assert P.gather_planes_multi([], _t(perm)) == []


@pytest.mark.parametrize("n_planes,n_chunks,sizes", [
    (1, 1, [1]), (13, 2, [13]), (31, 64, [31]), (40, 64, [31, 9]), (100, 2, [100]),
    (2041, 1, [2040, 1]),
])
def test_gather_launch_plan_splits_at_the_descriptor(n_planes, n_chunks, sizes):
    """One launch for all the planes of a call until their chunk tables
    (two pointers a chunk of each plane) pass the descriptor's 4080."""
    plan = P.gather_launch_plan(n_planes, n_chunks)
    assert [len(u) for u in plan] == sizes
    assert [p for u in plan for p in u] == list(range(n_planes))


def test_remap_tiles_cover_every_code_once():
    """csrc/gather_planes.cu's remap tiles (4096 codes inside one chunk, 16
    a thread in 16 B vectors, scalar where a chunk's tail asks for it)
    cover every code of a ragged plane exactly once."""
    for lens in ([4096, 4096, 808], [5000, 5000, 3], [1 << 24, 7], [13]):
        cr, nc, n = lens[0], len(lens), sum(lens)
        tpc = -(-cr // 4096)
        n_tiles = (nc - 1) * tpc + -(-(n - (nc - 1) * cr) // 4096)
        seen = [np.zeros(x, np.int64) for x in lens]
        for tile in range(n_tiles):
            c = tile // tpc
            rows = n - c * cr if c == nc - 1 else cr
            off = (tile - c * tpc) * 4096
            for s in range(4):
                i = off + (s * 256 + np.arange(256)) * 4
                for e in range(4):
                    seen[c][(i + e)[i + e < rows]] += 1
        assert all((x == 1).all() for x in seen)


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
