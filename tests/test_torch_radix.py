"""The plan of the one-sweep radix sort (csrc/radix.cuh) that K14
`ts_argsort`, K18 `sort_segments` and K19's large-k branch share, held
against the references on the CPU:

* `radix_plan` covers every bit of the largest key exactly once, in
  digits of at most 11 bits that differ by at most one (one pass up to
  11 bits, up to three of at most 8 where they do; a largest key of 0
  one 1-bit pass), with u32 keys up to 2^32 - 1;
* a plain-torch emulation of the planned sort (a stable sort by each
  planned digit, low to high) gives `jnp.argsort` (stable) of the
  reference's K14 key (`greptimedb_tpu/parallel/tile_cache.py`
  `ensure_perm`) with the wrapper's key offset and fill, and numpy's
  stable argsort of K18's key (the id sort behind the reference's
  `_segment_scatter`);
* `sort_segments_plain`, which the card's K18 is held against, equals
  that numpy argsort with masked and out-of-range ids.

Every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from greptimedb_tpu_torch.ops import aggregate as A
from greptimedb_tpu_torch.ops import permute as P
from greptimedb_tpu_torch.ops.radix import (
    MAX_DIGIT_BITS, MAX_PASSES, TILE_ROWS, radix_plan, scratch_sizes)

I64_MAX = np.iinfo(np.int64).max
I64_MIN = np.iinfo(np.int64).min
U64_MAX = (1 << 64) - 1
# the largest keys of the plans' edges: digit and pass boundaries, the
# u32 / u64 boundary, K18 at G = 720 and 2^24 slots, K14's widest fill
SPANS = [0, 1, 255, 256, 721, 2047, 2048, 1 << 16, (1 << 22) - 1, (1 << 24) + 1, (1 << 32) - 1,
         1 << 32, 1 << 63, I64_MAX, U64_MAX]


@pytest.mark.parametrize("max_key", SPANS)
def test_radix_plan_covers_every_bit(max_key):
    plan = radix_plan(max_key)
    bits = max(max_key.bit_length(), 1)  # a largest key of 0: one 1-bit pass
    assert plan.key_bytes == (4 if bits <= 32 else 8)
    fewest = -(-bits // MAX_DIGIT_BITS)
    assert plan.n_passes == (fewest if fewest <= 1 else max(fewest, min(-(-bits // 8), 3)))
    assert plan.n_passes <= MAX_PASSES
    assert sum(plan.widths) == bits
    assert all(1 <= w <= MAX_DIGIT_BITS for w in plan.widths)
    assert max(plan.widths, default=0) - min(plan.widths, default=0) <= 1
    assert plan.shifts == tuple(sum(plan.widths[:p]) for p in range(plan.n_passes))
    rng = np.random.default_rng(max_key % 2**32)
    keys = {0, max_key, max_key >> 1, *(int(k) for k in rng.integers(0, max_key + 1, 20,
                                                                      dtype=np.uint64))}
    for key in keys:
        digits = [(key >> s) & ((1 << w) - 1) for s, w in zip(plan.shifts, plan.widths)]
        assert sum(d << s for d, s in zip(digits, plan.shifts)) == key


@pytest.mark.parametrize("what,max_key,passes,key_bytes", [
    ("K18 at G = 720", 720, 1, 4),
    ("K18 at 2^24 slots", 1 << 24, 3, 4),
    ("K14 over 12 h of ms", 12 * 3600_000 - 10_000 + 1, 3, 4),
    ("K14 with no valid row, K18 at G = 0: every key 0", 0, 1, 4),
    ("G = 2^16", 1 << 16, 3, 4),
    ("G = 2^12", 1 << 12, 2, 4),
    ("K19's survivors", U64_MAX, 6, 8),
])
def test_radix_plan_targets(what, max_key, passes, key_bytes):
    plan = radix_plan(max_key)
    assert (plan.n_passes, plan.key_bytes) == (passes, key_bytes), what


@pytest.mark.parametrize("n,max_key", [(0, 0), (1, 5), (4095, 720), (3 * 4096 + 1, 1 << 24),
                                       (10_000, U64_MAX)])
def test_scratch_sizes(n, max_key):
    plan = radix_plan(max_key)
    size = scratch_sizes(n, plan)
    bins = sum(1 << w for w in plan.widths)
    assert size["buffers"] == min(plan.n_passes - 1, 2)
    assert size["status"] == -(-n // TILE_ROWS) * bins
    assert size["control"] == bins + 1 + plan.n_passes


def emulate(keys: np.ndarray, plan) -> np.ndarray:
    """The planned sort in plain torch: a stable sort by each digit, low to
    high, over keys given as uint64 (held as int64 bits: every digit lies
    below bit 64, so the arithmetic shift's sign bits are masked off)."""
    k = torch.from_numpy(np.ascontiguousarray(keys).view(np.int64))
    order = torch.arange(k.numel())
    for shift, width in zip(plan.shifts, plan.widths):
        digit = (k[order] >> shift) & ((1 << width) - 1)
        order = order[torch.sort(digit, stable=True).indices]
    return order.numpy()


def _ts_case(case, rng, n):
    if case == "scrape_ties":  # every host of one scrape shares its ts
        return np.repeat(np.arange(-(-n // 40), dtype=np.int64) * 10_000, 40)[:n]
    if case == "negative":
        return rng.integers(-50, 50, n).astype(np.int64)
    if case == "extremes":
        return rng.choice(np.array([I64_MIN, I64_MIN + 1, -1, 0, 1, I64_MAX - 1, I64_MAX]), n)
    if case == "below_2^32":  # the span just fits u32 keys
        return rng.integers(-7, (1 << 32) - 9, n).astype(np.int64)
    if case == "past_2^32":  # one more and the keys are u64
        return rng.integers(-7, (1 << 32) + 7, n).astype(np.int64)
    if case == "negative_wide":
        return rng.integers(-(1 << 40), -(1 << 20), n).astype(np.int64)
    return rng.integers(I64_MIN, I64_MAX, n, dtype=np.int64)  # "wide": six passes


@pytest.mark.parametrize("case", ["scrape_ties", "negative", "extremes", "below_2^32",
                                  "past_2^32", "negative_wide", "wide"])
@pytest.mark.parametrize("p_valid", [1.0, 0.6, 0.0])
def test_k14_plan_equals_jnp_argsort(case, p_valid):
    rng = np.random.default_rng([sum(map(ord, case)), int(p_valid * 10)])
    n = 3 * 4096
    ts = _ts_case(case, rng, n)
    if case == "below_2^32":
        ts[:3] = [-7, (1 << 32) - 9, -6]  # the fill, hi - lo + 1, is 2^32 - 1
    if case == "past_2^32":
        ts[:3] = [-7, (1 << 32) + 6, -6]
    valid = rng.random(n) < p_valid
    if case in ("below_2^32", "past_2^32") and p_valid:
        valid[:3] = True
    valid[-500:] = False  # padding at the tail, as a super-tile holds it
    want = np.asarray(jnp.argsort(jnp.where(jnp.asarray(valid), jnp.asarray(ts), I64_MAX)))
    lo, hi = (int(ts[valid].min()), int(ts[valid].max())) if valid.any() else (I64_MAX, I64_MIN)
    off, fill = P.argsort_keys(lo, hi)
    keys = np.where(valid, ts.view(np.uint64) - np.uint64(off % (1 << 64)), np.uint64(fill))
    assert int(keys.max()) == (fill if valid.any() else 0)
    plan = radix_plan(fill)
    if case == "below_2^32" and p_valid:
        assert plan.key_bytes == 4 and fill == (1 << 32) - 1
    if case == "past_2^32" and p_valid:
        assert plan.key_bytes == 8
    np.testing.assert_array_equal(emulate(keys, plan), want)


def _k18_case(G: int, rng, n: int):
    gids = rng.integers(-3, G + 3, n).astype(np.int32)
    gids[: n // 3] = rng.integers(0, min(G, 7) + 1, n // 3)  # long runs of few ids
    mask = rng.random(n) < 0.8
    key = np.where(mask & (gids >= 0) & (gids < G), gids, G).astype(np.int64)
    return gids, mask, key


@pytest.mark.parametrize("G", [255, 256, 720, 2047, 2048, 1 << 24])
def test_k18_plan_equals_numpy_stable_argsort(G):
    rng = np.random.default_rng(G)
    gids, mask, key = _k18_case(G, rng, 3 * 4096 + 1000)
    plan = radix_plan(G)
    assert plan.key_bytes == 4
    np.testing.assert_array_equal(emulate(key.astype(np.uint64), plan),
                                  np.argsort(key, kind="stable"))


@pytest.mark.parametrize("G", [0, 1, 255, 256, 720, 2047, 2048, 1 << 24])
@pytest.mark.parametrize("n", [0, 1, 4095, 3 * 4096 + 1000])
def test_sort_segments_plain_equals_numpy_stable_argsort(G, n):
    rng = np.random.default_rng(G + n)
    gids, mask, key = _k18_case(G, rng, n)
    want = np.argsort(key, kind="stable")
    for sort in (A.sort_segments_plain, A.sort_segments):  # a CPU tile runs the plain form
        skeys, perm = sort(torch.from_numpy(gids), torch.from_numpy(mask), G)
        assert skeys.dtype == torch.int32 and perm.dtype == torch.int64
        np.testing.assert_array_equal(perm.numpy(), want)
        np.testing.assert_array_equal(skeys.numpy(), key[want].astype(np.int32))


def test_sort_segments_all_masked_and_one_id():
    n = 2 * 4096 + 17
    gids = torch.full((n,), 5, dtype=torch.int32)
    for mask in (torch.zeros(n, dtype=torch.bool), torch.ones(n, dtype=torch.bool)):
        skeys, perm = A.sort_segments_plain(gids, mask, 720)
        np.testing.assert_array_equal(perm.numpy(), np.arange(n))
        assert set(skeys.tolist()) == {5 if bool(mask[0]) else 720}
