"""K8 `pack_result` and K3 `segment_reduce_scatter` of the port, on the CPU:
what their CUDA wrappers hand the card, read back by emulations of the
kernels, and K3's add order against the reference JAX function.

* K8: `pack_layout` (the cached structure of a result) and the
  descriptors `pack_descriptors` fills in, read by a numpy emulation of
  csrc/pack_result.cu (each CTA's row found by the kernel's search over
  blk_end, every row's kind, offset and alignment), give the bytes of
  `pack_result_plain` exactly, for mixes of int32 and bit-packed rows
  (G not a multiple of 32, so later rows sit at odd offsets), f32 averages,
  dense and compact f64 rows, the verdict and the overflow byte, and for
  calls past one descriptor.
* K3: a numpy emulation of the kernel's lane order and shuffle tree holds
  the reference `_segment_scatter` within rel 1e-12 for sums and exactly
  for counts, mins and maxs, on runs of 1, 31, 32, 33 and ~9000 rows,
  all-masked groups, signed zeros, +-inf and NaN; the port's torch form of
  the same order (`segment_reduce_scatter_lanes`) equals it byte for byte;
  one thread's 8- or 16-leaf tree for runs of up to 16 rows equals the
  32-lane tree byte for byte; column launches split at 32 columns.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from greptimedb_tpu.ops import aggregate as jagg
from greptimedb_tpu_torch.ops import aggregate as agg

RTOL = 1e-12


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---- K8 -----------------------------------------------------------------------------


def _pack_inputs(rng, G, cap, n_int, n_acc32, acc64, n_verdict, fail_at=None):
    """Seeded rows of one result: presence-like int rows, (sums, counts),
    f64 rows with NaN, +-0, subnormals and +-inf, verdict rows (err, sum)
    that pass but for group `fail_at` of the last verdict row."""
    def f64():
        v = rng.normal(0, 1e3, G)
        v[rng.choice(G, min(G, 12), replace=False)] = [
            np.nan, -np.nan, 0.0, -0.0, 5e-324, -1e-310, np.inf, -np.inf, 1.5, -2.5, 1e300, 3.0,
        ][:min(G, 12)]
        return _t(v)

    ints = [_t(rng.integers(0, 4, G).astype(np.int32)) for _ in range(n_int)]
    counts = ints[0]
    acc32 = [(f64(), counts) for _ in range(n_acc32)]
    rows64 = [("value", f64()) if k == "value" else ("avg", f64(), counts) for k in acc64]
    verdict = None
    if n_verdict >= 0:
        verdict = []
        for i in range(n_verdict):
            s = rng.normal(0, 1e3, G)
            err = np.abs(s) * 1e-8
            if fail_at is not None and i == n_verdict - 1:
                err[fail_at] = abs(s[fail_at]) * 1e-6
            verdict.append((_t(err), _t(s)))
    sel = n_out = None
    if cap is not None:
        sel = _t(rng.permutation(G)[:cap].astype(np.int32))
        n_out = _t(np.array([cap - 3], np.int32))
    return ints, acc32, rows64, verdict, sel, n_out


def _emulate_pack(raws, arrays, nbytes, n64, G):
    """csrc/pack_result.cu over the descriptors `raws`, in numpy: pointers
    are handles into `arrays` (1-based; the buffer and accs64 are the
    handles given in the descriptor).  Returns (buf, accs64, CTAs run)."""
    buf = np.full(nbytes, 0xAB, np.uint8)  # torch.empty: whatever lies there
    accs = np.full((n64, G), np.nan)
    ctas = 0
    for li, raw in enumerate(raws):
        d = agg._PackDesc.from_buffer_copy(raw)
        assert d.desc_bytes == len(raw)
        if d.verdict_at >= 0:
            assert li == 0, "the verdict byte is preset before the first launch only"
            buf[d.verdict_at] = 1
        grid = d.blk_end[d.n_rows - 1]
        covered = {}
        for b in range(grid):
            lo, hi = 0, d.n_rows - 1
            while lo < hi:
                mid = (lo + hi) >> 1
                if d.blk_end[mid] > b:
                    hi = mid
                else:
                    lo = mid + 1
            covered.setdefault(lo, []).append(b - (d.blk_end[lo - 1] if lo else 0))
        ctas += grid
        for r in range(d.n_rows):
            row = d.rows[r]
            kind, n, out, align = row.kind, row.n, row.out, row.align
            dense = kind in (agg._PACK["f64_dense"], agg._PACK["avg_f64_dense"])
            # an accs64 row (`out` its row index) is always whole f64 words
            assert align == (8 if dense or out % 8 == 0 else 4 if out % 4 == 0 else 1)
            per = agg._pack_ctas(kind, n)
            assert sorted(covered.get(r, [])) == list(range(per)), "each CTA of a row once"
            a = arrays[d.ptrs[2 * r] - 1] if d.ptrs[2 * r] else None
            b = arrays[d.ptrs[2 * r + 1] - 1] if d.ptrs[2 * r + 1] else None
            sel = arrays[d.sel - 1] if d.sel else None
            gathered = sel is not None and kind != agg._PACK["raw_int32"]
            idx = sel[:n].astype(np.int64) if gathered else np.arange(n)

            def avg():
                return a[idx] / np.maximum(b[idx], 1).astype(np.float64)

            def put(values):
                raw_bytes = np.ascontiguousarray(values).reshape(-1).view(np.uint8)
                buf[out:out + raw_bytes.size] = raw_bytes

            if kind == agg._PACK["bits"]:
                put(np.packbits(a > 0))
            elif kind in (agg._PACK["int32"], agg._PACK["raw_int32"]):
                put(a[idx].astype(np.int32))
            elif kind == agg._PACK["avg_f32"]:
                with np.errstate(over="ignore"):  # 1e300 -> inf, as the cast on the card
                    put(avg().astype(np.float32))
            elif kind in (agg._PACK["f64_words"], agg._PACK["avg_f64_words"]):
                x = a[idx] if kind == agg._PACK["f64_words"] else avg()
                put(np.asarray(agg.pack_f64_bits(torch.from_numpy(x))))
            elif kind in (agg._PACK["f64_dense"], agg._PACK["avg_f64_dense"]):
                accs[out] = a[idx] if kind == agg._PACK["f64_dense"] else avg()
            elif kind == agg._PACK["scalar_int32"]:
                put(a[:1].astype(np.int32))
            elif kind == agg._PACK["verdict"]:
                s = np.abs(b) * 1e-7
                lim = np.where(np.isnan(s), s, np.maximum(s, 1e-12))
                if not np.all(a <= lim):
                    buf[out] = 0
            elif kind == agg._PACK["overflow"]:
                buf[out] = 1 if a[0] > 0 else 0
            else:
                raise AssertionError(f"unknown row kind {kind}")
    return buf, accs, ctas


def _through_descriptors(args, kw):
    """pack_result's card path with the kernel emulated: the layout, the
    operands in row order, the descriptors, then the emulation."""
    int_rows, acc32_rows, acc64_rows, bit_packed = args
    sel, n_out = kw.get("sel"), kw.get("n_out")
    verdict_rows, overflow = kw.get("verdict_rows"), kw.get("overflow")
    G = int(int_rows[0].shape[0])
    n = int(sel.shape[0]) if sel is not None else G
    layout = agg.pack_layout(bit_packed, sel is not None, len(int_rows), len(acc32_rows),
                             tuple(s[0] for s in acc64_rows),
                             -1 if verdict_rows is None else len(verdict_rows),
                             overflow is not None, n, G)
    arrays, handles = [], {}

    def ptr(t, dtype, elems):
        assert t.dtype is dtype and t.numel() == elems and t.is_contiguous()
        if id(t) not in handles:
            arrays.append(t.numpy().reshape(-1))
            handles[id(t)] = len(arrays)
        return handles[id(t)]

    ptrs = agg.pack_operands(int_rows, acc32_rows, acc64_rows, sel, n_out, verdict_rows,
                             overflow, ptr, G, n)
    assert len(ptrs) == 2 * len(layout.rows)
    sel_h = ptr(sel, torch.int32, n) if sel is not None else 0
    raws = agg.pack_descriptors(layout, ptrs, sel_h, 0, 0)
    assert [len(r) for r in raws] == [agg.ctypes.sizeof(agg._PackDesc)] * len(layout.launches)
    buf, accs, _ctas = _emulate_pack(raws, arrays, layout.nbytes, layout.n64, G)
    return layout, buf, accs


PACK_CASES = {
    # name: (G, cap, n_int, n_acc32, acc64, n_verdict, overflow, bit_packed)
    "dense_bits_odd_offsets": (1000, None, 2, 3, ("value", "avg"), 2, True, True),
    "dense_bits_aligned": (4096, None, 1, 10, (), 10, False, True),
    "dense_int32": (777, None, 3, 2, ("avg", "value", "value"), -1, True, False),
    "dense_verdict_without_rows": (64, None, 1, 0, ("value",), 0, False, False),
    "compact": (3000, 700, 2, 1, ("value", "avg"), 1, False, False),
    "compact_one_group": (5, 1, 1, 0, ("value",), -1, False, False),
    "past_one_descriptor": (300, None, 1, 40, ("value",) * 30, 3, True, True),
    "compact_past_one_descriptor": (300, 64, 1, 2, ("avg",) * 70, 2, False, False),
}


@pytest.mark.parametrize("case", sorted(PACK_CASES))
def test_pack_descriptors_through_an_emulated_kernel(case):
    G, cap, n_int, n_acc32, acc64, n_verdict, overflow, bit_packed = PACK_CASES[case]
    rng = np.random.default_rng(sorted(PACK_CASES).index(case) + 40)
    ints, acc32, rows64, verdict, sel, n_out = _pack_inputs(rng, G, cap, n_int, n_acc32, acc64,
                                                            n_verdict)
    kw = {"sel": sel, "n_out": n_out, "verdict_rows": verdict,
          "overflow": _t(np.array([3], np.int32)) if overflow else None}
    args = (ints, acc32, rows64, bit_packed)
    layout, buf, accs = _through_descriptors(args, kw)
    plain = agg.pack_result_plain(*args, **kw)
    np.testing.assert_array_equal(buf, plain[0].numpy(), err_msg=f"{case}: buf bytes")
    if cap is None:
        assert accs.shape == tuple(plain[1].shape)
        np.testing.assert_array_equal(accs.view(np.uint64), plain[1].numpy().view(np.uint64))
    n_rows = len(layout.rows)
    assert layout.launches == tuple(agg.pack_launch_plan(n_rows))
    assert len(layout.launches) == (1 if n_rows <= 64 else -(-n_rows // 64))
    assert (len(layout.launches) > 1) == case.endswith("past_one_descriptor")
    if bit_packed and G % 32:
        assert any(align == 1 for _k, _n, _o, align in layout.rows), "a misaligned row"


@pytest.mark.parametrize("fail_at", [0, 3999, None])
def test_pack_verdict_fails_at_exactly_one_group(fail_at):
    rng = np.random.default_rng(9)
    G = 4000
    ints, acc32, rows64, verdict, _s, _n = _pack_inputs(rng, G, None, 1, 1, (), 4,
                                                        fail_at=fail_at)
    args, kw = (ints, acc32, rows64, True), {"verdict_rows": verdict}
    _layout, buf, _a = _through_descriptors(args, kw)
    plain = agg.pack_result_plain(*args, **kw)[0].numpy()
    np.testing.assert_array_equal(buf, plain)
    assert buf[-1] == (1 if fail_at is None else 0)


@pytest.mark.parametrize("n_rows, launches", [
    (0, []), (1, [(0, 1)]), (64, [(0, 64)]), (65, [(0, 64), (64, 65)]),
    (130, [(0, 64), (64, 128), (128, 130)]),
])
def test_pack_launch_plan_splits_whole_rows(n_rows, launches):
    assert agg.pack_launch_plan(n_rows) == launches


def test_pack_layout_offsets_and_alignment():
    """Offsets follow pack_result_plain's parts in order; a bit row of G not
    a multiple of 32 leaves the next row at an odd offset (byte stores);
    the verdict byte is preset by the first launch only."""
    L = agg.pack_layout(True, False, 2, 2, ("value",), 1, True, 1001, 1001)
    names = {code: name for name, code in agg._PACK.items()}
    kinds = [names[k] for k, *_r in L.rows]
    assert kinds == ["bits", "bits", "avg_f32", "avg_f32", "f64_dense", "verdict", "overflow"]
    outs = [o for _k, _n, o, _a in L.rows]
    assert outs == [0, 126, 252, 4256, 0, 8260, 8261]
    assert [a for *_r, a in L.rows] == [8, 1, 4, 8, 8, 4, 1]
    assert L.nbytes == 8262 and L.n64 == 1 and L.verdict_at == 8260
    big = agg.pack_layout(False, False, 1, 80, (), 2, False, 50, 50)
    heads = [agg._PackDesc.from_buffer_copy(t) for t in big.templates]
    assert [h.verdict_at for h in heads] == [big.verdict_at, -1]
    assert [h.n_rows for h in heads] == [64, 19]
    with pytest.raises(ValueError):
        agg.pack_layout(True, True, 1, 0, (), -1, False, 5, 10)


# ---- K3 -----------------------------------------------------------------------------


def _k3_numpy(vals, masks, base, gids, G):
    """K3's order in numpy loops: the stable sort of the masked ids, then per
    group lane l folds positions start + l + 32 k in increasing k, and the
    shuffle tree (lane l < o takes lane l + o, o = 16 .. 1) combines the
    lanes.  Returns [(sums, counts, mins, maxs)] per column."""
    key = np.where(base & (gids >= 0) & (gids < G), gids, G)
    perm = np.argsort(key, kind="stable")
    skeys = key[perm]
    out = []
    nan = np.float64("nan")

    def nmin(a, b):
        return nan if np.isnan(a) or np.isnan(b) else (b if b < a else a)

    def nmax(a, b):
        return nan if np.isnan(a) or np.isnan(b) else (b if b > a else a)

    for v, m in zip(vals, masks):
        sums = np.zeros(G)
        counts = np.zeros(G, np.int32)
        mins = np.full(G, np.inf)
        maxs = np.full(G, -np.inf)
        for g in range(G):
            lo, hi = np.searchsorted(skeys, g), np.searchsorted(skeys, g + 1)
            if lo == hi:
                continue
            s, c = np.zeros(32), np.zeros(32, np.int32)
            mn, mx = np.full(32, np.inf), np.full(32, -np.inf)
            for j in range(lo, hi):
                lane, r = (j - lo) % 32, perm[j]
                if not (m[r] and base[r]):
                    continue
                s[lane] = s[lane] + v[r]
                c[lane] += 1
                mn[lane], mx[lane] = nmin(mn[lane], v[r]), nmax(mx[lane], v[r])
            for o in (16, 8, 4, 2, 1):
                for lane in range(o):
                    s[lane] = s[lane] + s[lane + o]
                    c[lane] += c[lane + o]
                    mn[lane] = nmin(mn[lane], mn[lane + o])
                    mx[lane] = nmax(mx[lane], mx[lane + o])
            sums[g], counts[g], mins[g], maxs[g] = s[0], c[0], mn[0], mx[0]
        out.append((sums, counts, mins, maxs))
    return out


def _k3_case(name):
    """(values, column masks, base mask, ids, G) of one run layout."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "run_lengths":
        # runs of 1, 31, 32, 33 and ~9000 rows, an empty last group
        lens = [1, 31, 32, 33, 9001, 2, 0, 64, 65, 5, 0]
        gids = np.repeat(np.arange(len(lens)), lens).astype(np.int32)
        G = len(lens)
    elif name == "short_runs":
        lens = rng.integers(0, 9, 300)
        gids = np.repeat(np.arange(300), lens).astype(np.int32)
        G = 300
    else:  # shuffled
        G = 97
        gids = rng.integers(0, G, 5000).astype(np.int32)
    gids = rng.permutation(gids)
    n = gids.size
    v = rng.normal(0, 100, n)
    v[rng.choice(n, 40, replace=False)] = -0.0
    v[rng.choice(n, 40, replace=False)] = 0.0
    v[rng.choice(n, 6, replace=False)] = np.inf
    v[rng.choice(n, 6, replace=False)] = -np.inf
    v[rng.choice(n, 8, replace=False)] = np.nan
    v2 = rng.uniform(-1, 1, n) * 1e-300  # subnormal sums
    base = rng.random(n) < 0.9
    base[gids == 2] = False  # an all-masked group
    col = base & (rng.random(n) < 0.7)
    col[gids == 5] = False   # a group with rows but none of this column's
    return [v, v2], [col, base], base, gids, G


K3_CASES = ["run_lengths", "short_runs", "shuffled"]


@pytest.mark.parametrize("case", K3_CASES)
def test_k3_order_emulation_matches_reference(case):
    vals, masks, base, gids, G = _k3_case(case)
    emu = _k3_numpy(vals, masks, base, gids, G)
    aggs = ("count", "max", "min", "sum")
    for c, (v, m) in enumerate(zip(vals, masks)):
        ref = jagg._segment_scatter(jnp.asarray(v), jnp.asarray(gids), G, aggs,
                                    jnp.asarray(m & base), None, jnp.float64)
        sums, counts, mins, maxs = emu[c]
        np.testing.assert_array_equal(counts, np.asarray(ref.counts), err_msg=f"{case} counts")
        np.testing.assert_array_equal(mins, np.asarray(ref.mins), err_msg=f"{case} mins")
        np.testing.assert_array_equal(maxs, np.asarray(ref.maxs), err_msg=f"{case} maxs")
        np.testing.assert_allclose(sums, np.asarray(ref.sums), rtol=RTOL, atol=0,
                                   err_msg=f"{case} sums")


@pytest.mark.parametrize("case", K3_CASES)
def test_k3_torch_order_form_equals_numpy_bytes(case):
    vals, masks, base, gids, G = _k3_case(case)
    emu = _k3_numpy(vals, masks, base, gids, G)
    order = agg.sort_segments(_t(gids), _t(base), G)
    got = agg.segment_reduce_scatter_lanes([_t(v) for v in vals], [_t(m) for m in masks],
                                           _t(base), order, G, ("count", "max", "min", "sum"))
    for c in range(len(vals)):
        for name, want in zip(("sums", "counts", "mins", "maxs"), emu[c]):
            have = getattr(got, name)[c].numpy()
            np.testing.assert_array_equal(have.view(np.uint8), want.view(np.uint8),
                                          err_msg=f"{case} {name}")
    plain = agg.segment_reduce_scatter_plain([_t(v) for v in vals], _t(gids),
                                             [_t(m) for m in masks], _t(base), G,
                                             ("count", "max", "min", "sum"))
    for name in ("counts", "mins", "maxs"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(plain, name).numpy())
    np.testing.assert_allclose(got.sums.numpy(), plain.sums.numpy(), rtol=RTOL, atol=0)


@pytest.mark.parametrize("length", range(1, 17))
@np.errstate(all="ignore")  # inf - inf and overflow, as on the card
def test_k3_one_thread_tree_equals_the_warp_tree(length):
    """A run of up to 16 rows: one thread's tree over 8 leaves (runs of up to
    8) or 16 (up to 16), as csrc's fold_short, gives the 32-lane tree's
    bytes, -0.0, NaN and +-inf included: the upper levels add +0.0 to a
    partial that is never -0.0."""
    rng = np.random.default_rng(length)
    pool = np.array([-0.0, 0.0, np.nan, np.inf, -np.inf, 1e-320, -1e-320, 2.5, -2.5, 1e308])
    leaves = 8 if length <= 8 else 16
    for _trial in range(200):
        x = rng.choice(pool, length)
        on = rng.random(length) < 0.8
        s32 = np.zeros(32)
        for lane in range(length):
            if on[lane]:
                s32[lane] = s32[lane] + x[lane]
        for o in (16, 8, 4, 2, 1):
            s32[:o] = s32[:o] + s32[o:2 * o]
        short = np.zeros(leaves)
        for lane in range(length):
            if on[lane]:
                short[lane] = 0.0 + x[lane]
        o = leaves // 2
        while o:
            short[:o] = short[:o] + short[o:2 * o]
            o //= 2
        assert short[:1].view(np.uint64)[0] == s32[:1].view(np.uint64)[0] or (
            np.isnan(short[0]) and np.isnan(s32[0]))


@pytest.mark.parametrize("n_cols, launches", [
    (1, [(0, 1)]), (10, [(0, 10)]), (32, [(0, 32)]), (40, [(0, 32), (32, 40)]),
    (70, [(0, 32), (32, 64), (64, 70)]),
])
def test_k3_column_launches(n_cols, launches):
    assert agg.column_launches(n_cols) == launches
    assert agg._ScatterArgs.values.size == 8 * agg._K3_MAX_COLS == 8 * 32
