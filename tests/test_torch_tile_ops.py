"""Kernel-level parity of the tile path's kernels K5-K8 (their plain torch
versions, which a CPU tensor runs) and of the tile program, against the
JAX reference functions on the same seeded numpy inputs.

Tolerances: limb digits, scales, presence, counts, `sel`, `n_out`, the
verdict byte and the int / bit rows of the packed buffer exact; limb
sums and error bounds within rel 1e-12 (fold order); f64 result rows
exact wherever the f64 values are equal, sums within rel 1e-12; f32 rows
within 1 f32 ulp."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from greptimedb_tpu.ops import aggregate as R
from greptimedb_tpu.parallel.executor import DistGroupByPlan as RPlan
from greptimedb_tpu.parallel.tile_cache import _tile_program as r_tile_program
from greptimedb_tpu.query.device_finalize import DeviceFinalizeSpec as RSpec
from greptimedb_tpu_torch.ops import aggregate as P
from greptimedb_tpu_torch.parallel.executor import DistGroupByPlan as PPlan
from greptimedb_tpu_torch.parallel.tile_program import tile_program as p_tile_program
from greptimedb_tpu_torch.query.device_finalize import DeviceFinalizeSpec as PSpec
from test_torch_ops import FOLD_LAYOUTS, fold_emulated, fold_layout

L = 4096


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops on one thread while the test workers share
    the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(a, b, rtol=1e-12):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.array_equal(np.isnan(a), np.isnan(b))
    fin = np.isfinite(b)
    assert np.array_equal(a[~fin & ~np.isnan(b)], b[~fin & ~np.isnan(b)])
    np.testing.assert_allclose(a[fin], b[fin], rtol=rtol, atol=0)


# ---- K5 quantize_limbs ----------------------------------------------------------


def _quant_case(case: str, rng) -> np.ndarray:
    nb = 8
    v = rng.uniform(-1, 1, nb * L)
    if case == "nonfinite":
        v[5], v[L + 9], v[2 * L + 3] = np.nan, np.inf, -np.inf
        v[3 * L:4 * L] = np.nan
    elif case == "zero_blocks":
        v[:2 * L] = 0.0
        v[5 * L:6 * L] = -0.0
    elif case == "pow2_edges":
        ks = rng.integers(-95, 1020, nb)
        for i, k in enumerate(ks):
            blk = v[i * L:(i + 1) * L]
            blk *= 2.0**k * 0.5
            p = 2.0**k
            blk[11] = [p, np.nextafter(p, 0), np.nextafter(p, np.inf), -p,
                       -np.nextafter(p, 0), -np.nextafter(p, np.inf), p, p][i]
    elif case == "pow2_all_exponents":
        nb = 1120 // 16
        v = rng.uniform(-1, 1, nb * L)
        for i in range(nb):
            k = -99 + 16 * i
            v[i * L:(i + 1) * L] *= 2.0**k * 0.25
            v[i * L + 7] = np.nextafter(2.0**k, [0, np.inf][i % 2])
    elif case == "half_way":
        v[:L] = np.arange(L) + 0.5
        v[L:2 * L] = (np.arange(L) - 2048) * 0.25 + 0.125
        v[2 * L:3 * L] = np.round(rng.uniform(-1e6, 1e6, L)) + 0.5
    elif case == "mixed_magnitude":
        v[:L] = np.where(np.arange(L) % 2, 1e9, 1.0)
        v[L:2 * L] *= 1e300
        v[2 * L:3 * L] *= 1e-28
    return v


@pytest.mark.parametrize(
    "case", ["nonfinite", "zero_blocks", "pow2_edges", "pow2_all_exponents", "half_way",
             "mixed_magnitude"],
)
def test_quantize_limbs_bit_exact(case):
    v = _quant_case(case, np.random.default_rng(3))
    rl, rs = jax.jit(R.quantize_limbs)(jnp.asarray(v))
    pl, ps = P.quantize_limbs_plain(_t(v))
    assert pl.dtype == torch.bfloat16 and tuple(pl.shape) == rl.shape
    np.testing.assert_array_equal(pl.view(torch.int16).numpy(),
                                  np.asarray(rl).view(np.int16))
    np.testing.assert_array_equal(ps.numpy().view(np.int64), np.asarray(rs).view(np.int64))


def test_limb_exponent_matches_the_reference_log2():
    """The reference's ceil(log2(x)) is ceil(log(x) * (1 / log 2)); the
    port reproduces it exactly, powers of two and their neighbours
    included, where it differs from the exact exponent."""
    ks = np.arange(-99, 1024)
    base = np.ldexp(1.0, ks)
    xs = [base]
    up, dn = base.copy(), base.copy()
    for _ in range(6):
        up, dn = np.nextafter(up, np.inf), np.nextafter(dn, 0)
        xs += [up, dn]
    xs += [np.random.default_rng(0).lognormal(0, 40, 20000)]
    xs = np.concatenate(xs)
    xs = xs[np.isfinite(xs) & (xs >= 1e-30)]
    ref = np.asarray(jax.jit(lambda x: jnp.ceil(jnp.log2(x)))(xs)).astype(np.int64)
    got = P.limb_exponent(_t(xs)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert np.any(ref[: ks.size] != ks), "the reference's rounding differs at some powers of two"


# ---- K6 limb_segment_sums and the scatter companion -------------------------------


def _limb_inputs(layout: str, seed: int = 5):
    rng = np.random.default_rng(seed)
    n = L * 32
    G = 256
    if layout == "unsorted":
        gids = rng.integers(0, G, n).astype(np.int32)
    else:
        gids = np.sort(rng.integers(0, G, n)).astype(np.int32)
    mask = rng.random(n) > 0.2
    if layout == "ragged_tail":
        mask[n - 1234:] = False  # real rows end inside the last block
        gids[n - 1234:] = G - 1
    v0 = rng.normal(50, 30, n)
    v1 = rng.uniform(-1e6, 1e6, n)
    nn1 = rng.random(n) > 0.1
    v1 = np.where(nn1, v1, 0.0)
    if layout == "mixed_magnitude":
        v0[:L] = np.where(np.arange(L) < L // 2, 1e9, 1.0)
    return gids, mask, v0, v1, nn1, G


@pytest.mark.parametrize("layout", ["sorted", "unsorted", "ragged_tail", "mixed_magnitude"])
def test_limb_segment_sums_matches_reference(layout):
    gids, mask, v0, v1, nn1, G = _limb_inputs(layout)
    r = jax.jit(lambda a, b, g, m, c1: R.limb_segment_sums(
        [R.quantize_limbs(a), R.quantize_limbs(b)], g, m, G, span=16, count01=[None, c1]
    ))(jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(gids), jnp.asarray(mask), jnp.asarray(nn1))
    cols = [P.quantize_limbs_plain(_t(v)) for v in (v0, v1)]
    p = P.limb_segment_sums_plain(cols, _t(gids), _t(mask), G, count01=[None, _t(nn1)])
    _close(p[0].numpy(), r[0])
    _close(p[1].numpy(), r[1])
    np.testing.assert_array_equal(p[2].numpy(), np.asarray(r[2]))
    np.testing.assert_array_equal(p[3].numpy(), np.asarray(r[3]))

    def verdict(sums, errs):
        s, e = np.asarray(sums), np.asarray(errs)
        return bool(np.all(e <= np.maximum(np.abs(s) * 1e-7, 1e-12)))

    assert verdict(p[0].numpy(), p[1].numpy()) == verdict(r[0], r[1])
    if layout == "mixed_magnitude":
        assert not verdict(p[0].numpy(), p[1].numpy()), "the co-blocked small group must fail"


@pytest.mark.parametrize("layout", FOLD_LAYOUTS)
def test_limb_fold_order_emulation_matches_reference(layout):
    """K6's fold as the kernels run it — per-(block, slot) values formed
    as the kernel forms them, the block layout's keys and mode, blocks
    added in block order — equals the reference's limb_segment_sums byte
    for byte (sums, error bounds, counts, presence), and so does the plain
    version; on falling bases a fold in (base, block) order does not."""
    gids, mask, G = fold_layout(layout)
    rng = np.random.default_rng(9)
    # blocks of other magnitudes: their scales differ, so a group's sum
    # rounds and its order shows in the bytes
    v0 = rng.uniform(-1e3, 1e3, gids.size) * np.repeat(np.exp(rng.uniform(-20, 20, gids.size // L)), L)
    v1 = rng.normal(50, 30, gids.size)
    nn1 = rng.random(gids.size) > 0.1
    r = jax.jit(lambda a, b, g, m, c1: R.limb_segment_sums(
        [R.quantize_limbs(a), R.quantize_limbs(b)], g, m, G, span=16, count01=[None, c1]
    ))(jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(gids), jnp.asarray(mask), jnp.asarray(nn1))
    cols = [P.quantize_limbs_plain(_t(v)) for v in (v0, v1)]
    g, m = _t(gids), _t(mask)
    ok, base = P.block_guard_plain(g, m, G)
    assert ok
    occ = P.block_occupancy_plain(g, m, base)
    nb, K = base.shape[0], P.BLOCK_SPAN
    slot = torch.where(m, torch.arange(gids.size) // L * K + g.long()
                       - base.long().repeat_interleave(L), nb * K)

    def slot_sum(x):  # exact integer sums per (block, slot)
        return torch.zeros(nb * K + 1, dtype=torch.int64).index_add_(0, slot, x.long())[:-1]

    pres = slot_sum(m)
    cnt1 = slot_sum(m & _t(nn1))
    psums, perrs = [], []
    for limbs, scale in cols:
        acc = -pres.double() * float(1 << 29)
        for j in range(4):
            acc = acc + slot_sum(limbs[:, :, j].reshape(-1).to(torch.int32)).double() * float(256**j)
        sc = scale.repeat_interleave(K)
        psums.append((acc * sc).reshape(nb, K).numpy())
        perrs.append((pres.double() * (sc * 0.5)).reshape(nb, K).numpy())

    def fadd(a, x):
        return a + float(x)

    def iadd(a, x):
        return a + int(x)

    differs = False
    for c in range(2):
        want_s, want_e = np.asarray(r[0][c]), np.asarray(r[1][c])
        got_s = np.array(fold_emulated(psums[c], base, occ, G, fadd, 0.0))
        got_e = np.array(fold_emulated(perrs[c], base, occ, G, fadd, 0.0))
        np.testing.assert_array_equal(got_s.view(np.int64), want_s.view(np.int64))
        np.testing.assert_array_equal(got_e.view(np.int64), want_e.view(np.int64))
        if layout == "falling":
            other = np.array(fold_emulated(psums[c], base, occ, G, fadd, 0.0, "base"))
            differs |= not np.array_equal(other.view(np.int64), want_s.view(np.int64))
    assert differs == (layout == "falling")
    presence = np.array(fold_emulated(pres.reshape(nb, K).numpy(), base, occ, G, iadd, 0))
    np.testing.assert_array_equal(presence, np.asarray(r[3]))
    counts1 = np.array(fold_emulated(cnt1.reshape(nb, K).numpy(), base, occ, G, iadd, 0))
    np.testing.assert_array_equal(counts1, np.asarray(r[2][1]))
    p = P.limb_segment_sums_plain(cols, g, m, G, count01=[None, _t(nn1)])
    for a, b in zip(p, r):
        np.testing.assert_array_equal(np.ascontiguousarray(a.numpy()).view(np.uint8),
                                      np.ascontiguousarray(np.asarray(b)).view(np.uint8))


@pytest.mark.parametrize("n_counted", [17, 33])
def test_limb_segment_sums_many_counted_columns(n_counted):
    """More null-gated count planes than one combine pass of K6 covers (16
    per 256 threads; 32 per chunk): every count row still matches."""
    rng = np.random.default_rng(n_counted)
    n, G = 4 * L, 64
    gids = np.sort(rng.integers(0, G, n)).astype(np.int32)
    mask = rng.random(n) > 0.2
    v = rng.normal(50, 30, n)
    c01 = [rng.random(n) > rng.uniform(0.05, 0.9) for _ in range(n_counted)]
    r = jax.jit(lambda a, g, m, cs: R.limb_segment_sums(
        [R.quantize_limbs(a)] * n_counted, g, m, G, span=16, count01=list(cs)
    ))(jnp.asarray(v), jnp.asarray(gids), jnp.asarray(mask), [jnp.asarray(c) for c in c01])
    p = P.limb_segment_sums_plain([P.quantize_limbs_plain(_t(v))] * n_counted, _t(gids),
                                  _t(mask), G, count01=[_t(c) for c in c01])
    assert p[2].shape == (n_counted, G)
    np.testing.assert_array_equal(p[2].numpy(), np.asarray(r[2]))
    np.testing.assert_array_equal(p[3].numpy(), np.asarray(r[3]))
    _close(p[0].numpy(), r[0])


@pytest.mark.parametrize("counted", [False, True])
def test_segment_sums_scatter_matches_reference(counted):
    gids, mask, v0, v1, nn1, G = _limb_inputs("unsorted", seed=9)
    c01 = [None, nn1] if counted else None
    r = R.segment_sums_scatter([jnp.asarray(v0), jnp.asarray(v1)], jnp.asarray(gids),
                               jnp.asarray(mask), G,
                               count01=None if c01 is None else [None, jnp.asarray(nn1)])
    p = P.segment_sums_scatter([_t(v0), _t(v1)], _t(gids), _t(mask), G,
                               count01=None if c01 is None else [None, _t(nn1)])
    _close(p[0].numpy(), r[0])
    np.testing.assert_array_equal(p[1].numpy(), np.asarray(r[1]))
    if counted:
        np.testing.assert_array_equal(p[2].numpy(), np.asarray(r[2]))
    else:
        assert p[2] is None and r[2] is None
    np.testing.assert_array_equal(p[3].numpy(), np.asarray(r[3]))


# ---- K7 topk_group_select ------------------------------------------------------------


def _topk_inputs(kind: str, seed: int = 21):
    rng = np.random.default_rng(seed)
    G = 600
    mask = rng.random(G) > 0.35
    if kind == "float":
        v = rng.integers(0, 6, G).astype(np.float64)  # heavy ties
        for val, cnt in ((np.nan, 25), (-0.0, 15), (0.0, 15), (np.inf, 10), (-np.inf, 10)):
            v[rng.choice(G, cnt, replace=False)] = val
    else:
        v = rng.integers(-4, 4, G).astype(np.int64)
        v[:3] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, 0]
    isnull = rng.random(G) < 0.12
    return mask, v, isnull


@pytest.mark.parametrize("kind", ["float", "int"])
@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("nulls_first", [True, False])
@pytest.mark.parametrize("cap", [1, 9, 450])
def test_topk_group_select_matches_reference(kind, ascending, nulls_first, cap):
    mask, v, isnull = _topk_inputs(kind)
    second = np.arange(mask.size, dtype=np.int64) % 7
    r_sel, r_n = R.topk_group_select(
        jnp.asarray(mask),
        [(jnp.asarray(v), jnp.asarray(isnull), ascending, nulls_first),
         (jnp.asarray(second), None, not ascending, False)], cap)
    p_sel, p_n = P.topk_group_select_plain(
        _t(mask), [(_t(v), _t(isnull), ascending, nulls_first), (_t(second), None, not ascending, False)],
        cap)
    np.testing.assert_array_equal(p_sel.numpy(), np.asarray(r_sel))
    assert int(p_n[0]) == int(r_n) == int(mask.sum())


@pytest.mark.parametrize("cap", [5, 600])
def test_topk_group_select_without_keys_compacts(cap):
    """No key: survivors in group order, then the rest (cap above the
    number of survivors included)."""
    mask, _v, _n = _topk_inputs("int")
    r_sel, r_n = R.topk_group_select(jnp.asarray(mask), [], cap)
    p_sel, p_n = P.topk_group_select_plain(_t(mask), [], cap)
    np.testing.assert_array_equal(p_sel.numpy(), np.asarray(r_sel))
    assert int(p_n[0]) == int(r_n)


# ---- K7's kernels, emulated (csrc/topk_select.cu) -----------------------------------

_I64_MIN, _I64_MAX = np.iinfo(np.int64).min, np.iinfo(np.int64).max
_NO_ENT = (0xFFFFFFFF,)  # after every group: the kernel's empty entry
_SELECT_WARPS, _CLUSTER_CTAS = 16, 8


def _order_key_emulated(values: np.ndarray, null: np.ndarray, ascending: bool) -> np.ndarray:
    """group_ref.cuh `group_order_key`'s value order: floats widened to f64
    and canonicalized by `float_order`, integers widened to int64 and
    negated with wrapping; a NULL's value 0."""
    if values.dtype.kind == "f":
        x = np.where(null, 0.0, values.astype(np.float64))
        y = x if ascending else -x
        bits = y.view(np.int64)
        out = np.where(bits >= 0, bits, bits ^ _I64_MAX)
        out = np.where(y == 0, 0, out)
        return np.where(np.isnan(y), 0x7FF8000000000000, out)
    x = np.where(null, 0, values.astype(np.int64)).astype(np.int64)
    return x if ascending else (np.uint64(0) - x.view(np.uint64)).view(np.int64)


def _k7_entries(gate: np.ndarray, keys: list) -> list:
    """Every group's entry of the select as a tuple in the kernel's compare
    order: h = (not a survivor) << 2 | (key 0's null bucket + 1), key 0's
    value, then per later key its null bucket + 1 and value, then the id.
    `keys` holds (values, isnull | None, ascending, nulls_first)."""
    surv = gate > 0 if gate.dtype != bool else gate
    g = gate.size
    cols = []
    for i, (values, isnull, ascending, nulls_first) in enumerate(keys):
        null = np.zeros(g, bool) if isnull is None else isnull
        nb = np.where(null, 0 if nulls_first else 2, 1)
        if i == 0:
            cols.append(np.where(surv, 0, 4) | nb)
        else:
            cols.append(nb)
        cols.append(_order_key_emulated(values, null, ascending))
    cols.append(np.arange(g))
    return list(zip(*[c.tolist() for c in cols]))


def _k7_select_emulated(ents: list, cand, n_cand: int, cap: int, units: int) -> list:
    """One select launch of `units` clusters over candidates 0..n_cand-1
    (or the ids `cand`, -1 none): warp w takes batches w, w + n_warps, ...
    of 32; a batch's entries not below the warp's cap-th best drop, the
    rest join its best 32; the warps' lists, then the CTAs', merge keeping
    32.  Returns each unit's first `cap` ids (-1 where it holds fewer)."""
    n_warps = units * _CLUSTER_CTAS * _SELECT_WARPS
    lists = []
    for w in range(n_warps):
        best: list = []
        for b in range(w, -(-n_cand // 32), n_warps):
            batch = []
            for i in range(b * 32, min(b * 32 + 32, n_cand)):
                gid = i if cand is None else cand[i]
                if gid >= 0:
                    batch.append(ents[gid])
            thr = best[cap - 1] if len(best) >= cap else _NO_ENT
            batch = [e for e in batch if e < thr]
            if batch:
                best = sorted(best + batch)[:32]
        lists.append(best)
    out = []
    per_unit = _CLUSTER_CTAS * _SELECT_WARPS
    for u in range(units):
        mine = lists[u * per_unit:(u + 1) * per_unit]
        while len(mine) > 1:  # pairwise, as the warps and then the CTAs merge
            mine = [sorted(mine[i] + mine[i + 1])[:32] for i in range(0, len(mine), 2)]
        ids = [e[-1] for e in mine[0][:cap]]
        out.extend(ids + [-1] * (cap - len(ids)))
    return out


def _k7_rounds_emulated(ents: list, g: int, cap: int) -> list:
    """The bitonic rounds: a chunk of 1024 candidates sorted, its first
    `cap` kept (-1 past its candidates), until one chunk is left."""
    cand = list(range(g))
    while True:
        nxt = []
        for c0 in range(0, len(cand), 1024):
            chunk = sorted(ents[i] for i in cand[c0:c0 + 1024] if i >= 0)
            ids = [e[-1] for e in chunk[:cap]]
            nxt.extend(ids + [-1] * (cap - len(ids)))
        if len(cand) <= 1024:
            return nxt
        cand = nxt


def _k7_compact_emulated(surv: np.ndarray, cap: int) -> list:
    """The compaction's cluster: each CTA a contiguous range, the ranges'
    survivor counts summed before it, then tiles of 8192 groups until no
    position below `cap` is left; a survivor g goes to sb(g), the
    survivors before it, any other group to total + g - sb(g)."""
    g = surv.size
    per_cta = -(-(-(-g // _CLUSTER_CTAS)) // 8) * 8
    total = int(surv.sum())
    out = np.full(cap, -7, np.int64)
    for rank in range(_CLUSTER_CTAS):
        lo, hi = min(g, rank * per_cta), min(g, (rank + 1) * per_cta)
        run = int(surv[:lo].sum())
        t0 = lo
        while t0 < hi and (run < cap or total + (t0 - run) < cap):
            tile = surv[t0:min(t0 + 8192, hi)]
            sb = run + np.concatenate([[0], np.cumsum(tile)[:-1]]).astype(np.int64)
            ids = np.arange(t0, t0 + tile.size)
            pos = np.where(tile, sb, total + ids - sb)
            keep = pos < cap
            out[pos[keep]] = ids[keep]
            run += int(tile.sum())
            t0 += 8192
    return out.tolist()


def k7_emulated(gate: np.ndarray, keys: list, cap: int) -> tuple[list, int]:
    """K7 as `topk_launch_plan` launches it, emulated: (sel, n_out)."""
    g = gate.size
    surv = gate > 0 if gate.dtype != bool else gate
    plan = P.topk_launch_plan(g, cap, len(keys))
    if not keys:
        return _k7_compact_emulated(surv, cap), int(surv.sum())
    ents = _k7_entries(gate, keys)
    if plan[0][0] == "gt_topk_round":
        return _k7_rounds_emulated(ents, g, cap), int(surv.sum())
    cand, n_cand = None, g
    for _fn, units in plan:
        cand = _k7_select_emulated(ents, cand, n_cand, cap, units)
        n_cand = len(cand)
    return cand, int(surv.sum())


def _k7_case(kind: str, g: int, seed: int):
    """(gate, keys as (values, isnull | None, ascending, nulls_first)) of
    one emulation case."""
    rng = np.random.default_rng(seed)
    gate = rng.random(g) < 0.6
    if kind == "int64_ends_desc":
        v = rng.integers(-4, 4, g).astype(np.int64)
        v[rng.integers(0, g, max(g // 16, 1))] = _I64_MIN
        v[rng.integers(0, g, max(g // 16, 1))] = _I64_MAX
        return gate, [(v, None, False, False)]
    if kind == "f64_specials":
        v = rng.integers(0, 4, g).astype(np.float64)
        for val in (np.nan, -0.0, 0.0, np.inf, -np.inf):
            v[rng.integers(0, g, max(g // 10, 1))] = val
        second = rng.integers(-2, 2, g).astype(np.int32)
        return gate, [(v, rng.random(g) < 0.1, False, True), (second, None, True, False)]
    if kind == "nulls_last":
        v = rng.uniform(-1, 1, g).astype(np.float32)
        return rng.integers(0, 3, g).astype(np.int32), [(v, rng.random(g) < 0.3, True, False)]
    if kind == "all_equal":
        return gate, [(np.zeros(g), None, True, True), (np.ones(g, np.int64), None, False, True),
                      (np.zeros(g, np.int32), np.zeros(g, bool), True, True),
                      (np.zeros(g, np.uint8), None, False, False)]
    if kind == "no_survivors":
        return np.zeros(g, bool), [(rng.uniform(0, 9, g), rng.random(g) < 0.2, False, True)]
    raise ValueError(kind)


K7_SHAPES = [(g, cap) for g in (1, 31, 768, 1025, 49_152) for cap in (1, 5, 10, 32, 33, 512)
             if cap <= g]


@pytest.mark.parametrize("kind", ["int64_ends_desc", "f64_specials", "nulls_last", "all_equal",
                                  "no_survivors"])
@pytest.mark.parametrize("g,cap", K7_SHAPES)
def test_topk_kernel_emulation_matches_reference(g, cap, kind):
    """K7's select (per-warp best lists behind a cap-th-best threshold,
    merged pairwise), its bitonic rounds past cap 32 and, at the largest
    G, the select's two-launch form, emulated, equal the reference's
    lax.sort selection and the port's plain version: int64 keys at both
    ends descending, f64 NaN / +-0 / +-inf, NULLs first and last, every key
    equal, no survivor."""
    gate, keys = _k7_case(kind, g, g * 31 + cap)
    r_sel, r_n = R.topk_group_select(
        jnp.asarray(gate > 0 if gate.dtype != bool else gate),
        [(jnp.asarray(v), None if n is None else jnp.asarray(n), a, f) for v, n, a, f in keys], cap)
    sel, n_out = k7_emulated(gate, keys, cap)
    assert sel == np.asarray(r_sel).tolist() and n_out == int(r_n)
    p_sel, p_n = P.topk_group_select_plain(
        _t(gate), [(_t(v), None if n is None else _t(n), a, f) for v, n, a, f in keys], cap)
    assert p_sel.tolist() == sel and int(p_n[0]) == n_out
    if g == 49_152 and cap <= P.TOPK_SELECT_CAP:
        # the select's grid of clusters and merge launch (past
        # TOPK_ONE_LAUNCH_GROUPS on the card)
        ents = _k7_entries(gate, keys)
        lists = _k7_select_emulated(ents, None, g, cap, P._TOPK_GRID_UNITS)
        assert _k7_select_emulated(ents, lists, len(lists), cap, 1) == sel


@pytest.mark.parametrize("g,cap", [(1, 1), (31, 5), (4096, 4096), (57_344, 57_344),
                                   (57_344, 10), (70_001, 65_537)])
def test_topk_compaction_emulation_matches_reference(g, cap):
    """K7 without a key, its cluster's ranges and tiles emulated: the
    reference's order (survivors, then the rest, each by group id) for a
    cap below, at and past the survivors."""
    gate = np.random.default_rng(g + cap).integers(0, 3, g).astype(np.int32)
    r_sel, r_n = R.topk_group_select(jnp.asarray(gate > 0), [], cap)
    sel, n_out = k7_emulated(gate, [], cap)
    assert sel == np.asarray(r_sel).tolist() and n_out == int(r_n)


def test_topk_layout_is_built_once_per_structure():
    """K7's structure is cached by the gate's and keys' forms, cap and G;
    new planes of the same forms reuse it, a new form or cap does not."""
    from greptimedb_tpu_torch.ops.aggregate import HavingRef

    g = 768
    v = _t(np.random.default_rng(1).uniform(0, 1, g))
    keys = [(HavingRef(values=v, nan_null=True), False, True), (HavingRef(div=1, card=g), True,
                                                                True)]
    lay = P.topk_layout(torch.int32, keys, 5, g)
    keys2 = [(HavingRef(values=v.clone(), nan_null=True), False, True),
             (HavingRef(div=1, card=g), True, True)]
    assert P.topk_layout(torch.int32, keys2, 5, g) is lay
    assert P.topk_layout(torch.int32, keys2, 6, g) is not lay
    assert P.topk_layout(torch.bool, keys2, 5, g) is not lay
    a = P._TopkArgs.from_buffer_copy(lay.template)
    assert (a.n_keys, a.cap, a.num_groups, a.ascending, a.nulls_first) == (2, 5, g, 2, 3)
    assert a.keys[0].nan_null == 1 and a.keys[1].card == g and lay.plan == [("gt_topk_select", 1)]


# ---- f64 words -------------------------------------------------------------------------


def test_pack_f64_bits_matches_reference_and_round_trips():
    x = np.array([5e-324, -5e-324, 1e-310, -1e-310, np.nan, -np.nan, np.inf, -np.inf, -0.0, 0.0,
                  1.5, -2.2250738585072014e-308, 2.2250738585072014e-308, 123.456, -9e307])
    r = np.asarray(jax.jit(R.pack_f64_bits)(jnp.asarray(x)))
    p = P.pack_f64_bits(_t(x)).numpy()
    np.testing.assert_array_equal(p, r)
    back = P.unpack_f64_bits(p)
    normal = np.abs(x) >= 2.2250738585072014e-308
    np.testing.assert_array_equal(back[normal].view(np.int64), x[normal].view(np.int64))
    assert np.all(back[(x != 0) & ~normal & np.isfinite(x)] == 0)  # subnormals flush
    assert np.isnan(back[4]) and np.isnan(back[5])
    np.testing.assert_array_equal(np.signbit(back), np.signbit(x))


# ---- the tile program: (buf, accs64) -----------------------------------------------


def _sources(seed: int = 4):
    """Two 65,536-row chunks sorted by (host, ts) plus a 3,000-row
    memtable tail padded to 4096 rows; host codes 0..47, v nullable."""
    rng = np.random.default_rng(seed)
    out = []
    for n, pad, t0 in ((65536, 65536, 0), (65536, 65536, 0), (3000, 4096, 10**7)):
        host = np.sort(rng.integers(0, 48, n)).astype(np.int32)
        ts = (t0 + np.arange(n) % 4000 * 1000 + rng.integers(0, 1000, n)).astype(np.int64)
        u = rng.uniform(0, 100, n)
        v = rng.normal(0, 1e3, n)
        present = rng.random(n) > 0.1
        v = np.where(present, v, 0.0)

        def padded(a, fill=0):
            b = np.full(pad, fill, a.dtype)
            b[:n] = a
            return b

        valid = padded(np.ones(n, bool), False)
        cols = {"host": padded(host), "ts": padded(ts), "u": padded(u), "v": padded(v)}
        out.append((cols, valid, {"v": padded(present, False)}))
    return out


_CASES = {
    # avg over a 64 x 256 group space: bit-packed presence and f32 avg rows
    "dense_packed": dict(tags=64, buckets=256, interval=16_000,
                         specs=(("avg", "u"), ("avg", "v"), ("max", "v")), spec=None),
    # a count output keeps exact int32 rows; sums and mins ride accs64
    "dense_counts": dict(tags=64, buckets=8, interval=600_000,
                         specs=(("sum", "u"), ("count", "__count_star"), ("count", "v"),
                                ("min", "u")), spec=None),
    # ORDER BY max(v) DESC LIMIT 5 on the card
    "compact_topk": dict(tags=64, buckets=8, interval=600_000,
                         specs=(("avg", "u"), ("max", "v")),
                         spec=dict(order=((("agg", "v", "max"), False, True),), limit=5,
                                   offset=0, cap=5)),
    # lastpoint: compaction with no key, the LAST row as f64 words
    "compact_last": dict(tags=64, buckets=None, interval=1,
                         specs=(("last_value", "u"), ("max", "v")),
                         spec=dict(order=(), limit=None, offset=0, cap=48)),
}


def _decode(buf, g, int_layout, acc32, acc64, bits, compact):
    """Split a packed buffer into its rows (the reference's layout)."""
    ni = len(int_layout)
    row = -(-g // 8) if bits else g
    off = ni * row * (1 if bits else 4)
    ints = np.frombuffer(buf[:off].tobytes(), np.uint8 if bits else np.int32).reshape(ni, row)
    f32 = np.frombuffer(buf[off: off + len(acc32) * g * 4].tobytes(), np.float32).reshape(-1, g)
    off += len(acc32) * g * 4
    out = {"ints": ints, "f32": f32}
    if compact:
        out["sel"] = np.frombuffer(buf[off: off + g * 4].tobytes(), np.int32)
        off += g * 4
        out["n_out"] = np.frombuffer(buf[off: off + 4].tobytes(), np.int32)
        off += 4
        out["words"] = np.frombuffer(buf[off: off + len(acc64) * g * 8].tobytes(),
                                     np.int32).reshape(len(acc64), g, 2)
        off += len(acc64) * g * 8
    out["tail"] = buf[off:]
    return out


@pytest.mark.parametrize("case", sorted(_CASES))
def test_tile_program_matches_reference(case):
    c = _CASES[case]
    bucket = c["buckets"] is not None
    common = dict(
        group_tags=("host",), tag_cards=(c["tags"],), bucket_col="ts" if bucket else None,
        bucket_origin=0, bucket_interval=1, n_buckets=c["buckets"] or 1,
        agg_specs=c["specs"], filters=(("ts", ">=", None),), acc_dtype="limb",
        ts_col="ts" if any(f == "last_value" for f, _ in c["specs"]) else None,
    )
    rplan = RPlan(**common, block_span=16)
    pplan = PPlan(**common)
    rspec = pspec = None
    if c["spec"] is not None:
        rspec = RSpec(having=None, n_having_values=0, **c["spec"])
        pspec = PSpec(**c["spec"])
    nullable = ("v",)
    run_r, r_int, r_32, r_64, r_dtype = r_tile_program(rplan, nullable, rspec)
    prog = p_tile_program(pplan, nullable, pspec)
    assert (prog.int_layout, prog.acc32_layout, prog.acc64_layout) == (r_int, r_32, r_64)
    assert prog.bit_packed == (r_dtype == jnp.uint8)
    srcs = _sources()
    r_out = run_r(tuple(
        ({k: jnp.asarray(v) for k, v in cols.items()}, jnp.asarray(valid),
         {k: jnp.asarray(v) for k, v in nulls.items()}, None, {})
        for cols, valid, nulls in srcs
    ), {"filter_values": (np.int64(1000),), "bucket_origin": np.int64(0),
        "bucket_interval": np.int64(c["interval"]), "having_values": ()})
    p_out = prog.run_all(
        [({k: _t(v) for k, v in cols.items()}, _t(valid), {k: _t(v) for k, v in nulls.items()}, {})
         for cols, valid, nulls in srcs],
        {"filter_values": (np.int64(1000),), "bucket_origin": 0,
         "bucket_interval": c["interval"]},
    )
    assert len(p_out) == len(r_out)
    g = pspec.cap if pspec is not None else pplan.num_groups
    compact = pspec is not None
    rd = _decode(np.asarray(r_out[0]), g, r_int, r_32, r_64, prog.bit_packed, compact)
    pd = _decode(p_out[0].numpy(), g, r_int, r_32, r_64, prog.bit_packed, compact)
    np.testing.assert_array_equal(pd["ints"], rd["ints"])
    np.testing.assert_array_equal(pd["tail"], rd["tail"])  # the verdict byte
    ulps = np.abs(pd["f32"].view(np.int32).astype(np.int64) - rd["f32"].view(np.int32))
    assert ulps.size == 0 or ulps.max() <= 1
    if compact:
        np.testing.assert_array_equal(pd["sel"], rd["sel"])
        np.testing.assert_array_equal(pd["n_out"], rd["n_out"])
        p64, r64 = P.unpack_f64_bits(pd["words"]), P.unpack_f64_bits(rd["words"])
    else:
        p64, r64 = p_out[1].numpy(), np.asarray(r_out[1])
    for i, (_col, agg) in enumerate(r_64):
        if agg in ("sum", "avg"):
            _close(p64[i], r64[i])
        else:
            np.testing.assert_array_equal(p64[i].view(np.int64), r64[i].view(np.int64))
