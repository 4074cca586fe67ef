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


# ---- K16's tile walk, emulated --------------------------------------------------------


def _warp_lower_bound(q, key):
    """csrc/delta_patch.cu's `warp_lower_bound`: the first j with q[j] >= key
    by 32-way rounds (a lane probes the last entry of one of 32 equal
    blocks; the ballot counts the blocks below the key); (answer, rounds)."""
    lo, hi, rounds = 0, len(q), 0
    while lo < hi:
        s = (hi - lo + 31) >> 5
        starts = lo + np.arange(32) * s
        valid = starts < hi
        probes = np.minimum(starts + s, hi) - 1
        below = valid & (q[np.where(valid, probes, lo)] < key)
        blocks, cnt = int(valid.sum()), int(below.sum())
        assert below[:cnt].all() and not below[cnt:].any()  # a prefix of the lanes
        if cnt == blocks:
            lo = hi
        else:
            nlo = lo + cnt * s
            lo, hi = nlo, min(nlo + s, hi) - 1
        rounds += 1
    return lo, rounds


def _copy_rows_cover(cnt, src_off, vec, V, threads=256):
    """csrc/delta_patch.cu's `copy_rows` split of `cnt` rows from element
    `src_off` of an aligned chunk: with vec, the rows before the first
    whole 16 B vector one a thread (threads < head), the whole vectors,
    then the tail in a thread-strided loop; without, every row in that
    loop.  Fails unless every row is copied exactly once."""
    head = nv = 0
    if vec:
        head = min((V - src_off % V) % V, cnt)
        nv = (cnt - head) // V
    seen = np.zeros(cnt, np.int64)
    seen[np.arange(min(head, threads))] += 1
    for q in range(nv):
        seen[head + q * V:head + (q + 1) * V] += 1
    seen[head + nv * V:] += 1
    assert (seen == 1).all()


def _patch_emulated(old_chunks, old_n, delta, pos, new_pad, chunk_rows):
    """csrc/delta_patch.cu's kernel in numpy: tiles of PATCH_TILE rows inside
    one destination chunk (`patch_tiles`, the chunk from the tile index);
    the window [lo, hi) of delta rows by two warp searches; the old rows
    one contiguous range from r0 - lo, copied piece by piece where it
    crosses an old chunk bound (the chunk by a shift or a division) to
    buf[sh + ...], whose 16 B copies line up with the source; a flag a
    delta row, the words' popcounts scanned, and each 16 B unit of output
    rows built from the unit's first delta count.  Fails unless every
    output row is written exactly once; returns the new chunks."""
    dtype = old_chunks[0].dtype
    esize = np.dtype(dtype).itemsize
    V = 16 // esize
    ocr = old_chunks[0].size
    vec_old = len(old_chunks) == 1 or ocr % V == 0  # numpy buffers: aligned bases
    old_shift = ocr.bit_length() - 1 if ocr & (ocr - 1) == 0 else -1
    bounds = [(o, min(o + chunk_rows, new_pad)) for o in range(0, new_pad, chunk_rows)] or [(0, 0)]
    outs = [np.zeros(b - a, dtype) for a, b in bounds]
    written = [np.zeros(b - a, np.int64) for a, b in bounds]
    cr = min(chunk_rows, new_pad)
    tpc, n_tiles = P.patch_tiles(new_pad, cr)
    n_delta = len(delta)
    q = pos.astype(np.int64) + np.arange(n_delta)
    total = old_n + n_delta
    max_rounds = 0
    for tile in range(n_tiles):
        c = tile // tpc
        off = (tile - c * tpc) * P.PATCH_TILE
        rows_c = new_pad - c * cr if c + 1 == len(bounds) else cr
        length = min(P.PATCH_TILE, rows_c - off)
        assert length > 0
        r0 = c * cr + off
        if n_delta == 0:
            lo = hi = 0
        elif r0 >= total:
            lo = hi = n_delta
        else:
            (lo, r1), (hi, r2) = _warp_lower_bound(q, r0), _warp_lower_bound(q, r0 + length)
            max_rounds = max(max_rounds, r1, r2)
        m = max(0, min(length, total - r0))
        n_old = m - (hi - lo)
        a0 = r0 - lo
        sh = a0 % V if vec_old else 0
        buf = np.zeros(P.PATCH_TILE + V, dtype)
        o, pieces = a0, 0
        while o < a0 + n_old:
            ci = o >> old_shift if old_shift >= 0 else o // ocr
            cbase = ci * ocr
            stop = min(a0 + n_old, cbase + ocr)
            src_off = o - cbase
            head = min((V - src_off % V) % V, stop - o)
            if vec_old and head < stop - o:  # the first whole vector lines up in buf
                assert (sh + (o - a0) + head) % V == 0
            buf[sh + o - a0:sh + stop - a0] = old_chunks[ci][src_off:src_off + stop - o]
            _copy_rows_cover(stop - o, src_off, vec_old, V)
            o, pieces = stop, pieces + 1
        if ocr >= P.PATCH_TILE:
            assert pieces <= 2  # the old range crosses at most one old chunk bound
        flags = np.zeros(P.PATCH_TILE, bool)
        t = q[lo:hi] - r0
        assert ((t >= 0) & (t < length)).all()
        flags[t] = True
        buf[sh + n_old:sh + n_old + hi - lo] = delta[lo:hi]
        words = (flags.reshape(-1, 32).astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(
            1).astype(np.uint32)
        pops = np.bitwise_count(words).astype(np.int64)
        before = np.concatenate([[0], np.cumsum(pops)[:-1]])
        i0 = np.arange(0, length, V)
        below = ((np.uint64(1) << (i0 & 31).astype(np.uint64)) - np.uint64(1)).astype(np.uint32)
        d0 = before[i0 >> 5] + np.bitwise_count(words[i0 >> 5] & below)
        i = (i0[:, None] + np.arange(V)).reshape(-1)
        f = flags[np.minimum(i, P.PATCH_TILE - 1)].reshape(-1, V)
        d = (d0[:, None] + np.cumsum(f, 1) - f).reshape(-1)
        idx = np.where(f.reshape(-1), n_old + d, i - d)
        vals = np.where(i < m, buf[sh + np.clip(idx, 0, P.PATCH_TILE - 1)], np.zeros(1, dtype))
        keep = i < length
        outs[c][off + i[keep]] = vals[keep]
        written[c][off + i[keep]] += 1
    assert all((w == 1).all() for w in written)
    if n_delta > 1:
        assert max_rounds <= int(np.ceil(np.log(n_delta) / np.log(32))) + 1
    return outs


def _patch_case(where, old_n, n_delta, rng):
    """Sorted merge positions of `n_delta` delta rows into `old_n` old rows."""
    if where == "front":
        return np.zeros(n_delta, np.int64)
    if where == "back":
        return np.full(n_delta, old_n, np.int64)
    if where == "runs":  # a tile of delta rows only, runs across tile bounds, tiles with none
        return np.sort(np.concatenate([np.zeros(4200, np.int64), np.full(300, 3900),
                                       rng.integers(12_000, old_n + 1, n_delta - 4500)]))
    return np.sort(rng.integers(0, old_n + 1, n_delta))


@pytest.mark.parametrize("where", ["interleaved", "front", "back", "runs", "empty"])
@pytest.mark.parametrize("chunk_rows", [256, 4096, 5000, 1 << 24])
@pytest.mark.parametrize("dtype", [np.float64, np.int32, np.bool_])
def test_delta_patch_tile_walk_emulation_matches_reference(where, chunk_rows, dtype):
    """csrc/delta_patch.cu's tile walk (`_patch_emulated`) equals the
    reference's `_delta_patch` and `delta_patch_plain` byte for byte:
    chunk rows a power of two and not, below and above the tile, one chunk;
    old_n not a multiple of 4096; the delta at the front, the back,
    interleaved, and in runs (a tile of delta rows only, a run across a
    tile bound, tiles with none); an empty delta; new_pad past
    old_n + n_delta."""
    rng = np.random.default_rng(19)
    old_n = 13_333
    n_delta = 0 if where == "empty" else 6000
    new_pad = -(-(old_n + n_delta) // 4096) * 4096 + 4096
    full = np.zeros(-(-old_n // 4096) * 4096, dtype)
    full[:old_n] = rng.integers(1, 100, old_n).astype(dtype)
    delta = rng.integers(1, 100, n_delta).astype(dtype)
    pos = _patch_case(where, old_n, n_delta, rng).astype(np.int32)
    old = _chunks(full, chunk_rows)
    want = np.asarray(r_delta_patch(jnp.asarray(full), jnp.asarray(delta), jnp.asarray(pos),
                                    old_n=old_n, new_pad=new_pad))
    got = _patch_emulated([c.numpy() for c in old], old_n, delta, pos, new_pad, chunk_rows)
    plain = P.delta_patch_plain(old, old_n, _t(delta), _t(pos), new_pad, chunk_rows)
    assert [c.shape[0] for c in got] == [c.shape[0] for c in plain]
    assert np.concatenate(got).tobytes() == want.tobytes()
    assert torch.cat(plain).numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("new_pad,chunk_rows,tiles", [
    (4400 * 4096, 1 << 24, (4096, 4400)), (10_000, 5000, (2, 4)), (1000, 256, (1, 4)),
    (8192, 4096, (1, 2)), (0, 4096, (1, 0)), (1, 1 << 24, (1, 1)),
])
def test_patch_tiles_cover_every_row_once(new_pad, chunk_rows, tiles):
    """K16's grid: tiles of at most PATCH_TILE rows, each inside one
    destination chunk, cover every row of the new plane exactly once."""
    assert P.patch_tiles(new_pad, chunk_rows) == tiles
    cr = min(chunk_rows, new_pad)
    tpc, n_tiles = tiles
    seen = np.zeros(new_pad, np.int64)
    n_chunks = -(-new_pad // cr) if cr else 0
    for tile in range(n_tiles):
        c = tile // tpc
        off = (tile - c * tpc) * P.PATCH_TILE
        rows_c = new_pad - c * cr if c + 1 == n_chunks else cr
        assert 0 <= off < rows_c
        seen[c * cr + off:c * cr + min(off + P.PATCH_TILE, rows_c)] += 1
    assert (seen == 1).all()


def test_warp_lower_bound_rounds_at_the_live_delta():
    """The 32-way search finds every tile's window in 4 rounds over the live
    phase's 737,280 delta rows (the `before` search took about 20)."""
    rng = np.random.default_rng(20)
    n_delta, old_n = 737_280, 17_280_000
    q = np.sort(rng.integers(0, old_n + 1, n_delta)) + np.arange(n_delta)
    for key in (0, 1, int(q[0]), int(q[n_delta // 2]), int(q[-1]), int(q[-1]) + 1,
                *rng.integers(0, old_n + n_delta, 50).tolist()):
        got, rounds = _warp_lower_bound(q, key)
        assert got == int(np.searchsorted(q, key, side="left"))
        assert rounds <= 4
