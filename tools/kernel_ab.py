"""Times kernels of two checkouts of the port on one card, in turns (other,
this, this, other), at chip_smoke.py's shapes.

`--set blocked` (the default): the blocked reductions of the SQL main path
over phase 3's planes (TSBS cpu-only, 4000 hosts x 12 h of 10 s scrapes =
17.28 M rows in (hostname, ts) order, 10 uniform columns):

* K2 `segment_reduce_blocked` at C = 1, 5 and 10 over the double-groupby
  ids (host x hour, G = 4096 x 12: the guard passes, the bases rise);
* K6 `limb_segment_sums` at C = 1 and 10 over the same ids, the planes
  padded to a multiple of 4096 rows as the tile path holds them;
* K2 + K18 + K3 as `segment_aggregate_multi` runs them on the card (both
  branches launched, the scatter branch shut by the guard's word), C = 10;
* K3 `segment_reduce_scatter` (C = 1, 10), K18 `sort_segments` over minute
  buckets (G = 720) and K14 `ts_argsort` over the ts plane, all open: the
  scatter branch behind K2 and K6, and the radix sort it shares with K14;
* K4 `segment_last` blocked at lastpoint's shape (hostname only);
* the falling-bases shape: the same hosts over 16 h, grouped by hour
  alone (`date_bin('1 hour', ts)`, G = 16), where a block inside one host
  starts at its hour and the next, crossing into the next host, at 0: the
  guard passes and the bases fall at each host.  K2 (C = 10), K6 (C = 10)
  and K4 there are also held against their plain versions: K6 and K4 byte
  for byte (K6's plain version on the host, whose f64 adds run in block
  order), K2 within rel 1e-12 with count, min and max exact.

`--set range_hll`: K10 `range_windows` at phase 3c's TQL shapes (k = 8 and
64, the row prologue included) and K20 `segment_hll` at phase 9's rows (by
host p = 12 and 14, by hour, one register) beside `scatter_reduce_`.

`--set fold`: the mesh merge and the by-label fold at phase 10a's and 3c's
shapes.  K22 `fold_states` one key at a time (dense 4 x 2^16 and
8 x 480,000 rows; keyed over 4 slot tables of 2^24 slots, the inversion
apart) and whole merges of per-source state dicts: one key at each of those
shapes, and a TSBS double-groupby-all merge at 4 slots (21 dense keys over
4096 x 12 groups; 12 keyed keys over 2^17 hash slots, `__hash_overflow`
among them).  A merge calls `fold_state_dicts` where the checkout has it,
else the per-key loop of `stack_states` + `fold_states` that the mesh ran
before it.  K12 `series_fold` over a 4096 x 1024 rate matrix (NaN holes) at
G = 1, 2, 16, 32, 64 and 4096, beside `index_add_`; where the checkout has
`_series_fold_launch`, both of its forms too (the cell form, and the staged
form at the tile the plan would give it).

`--set pack_scatter`: K8 `pack_result` dense (double-groupby-all's layout
at G = 4096 x 12: bit-packed presence, 10 f32 avg rows, the verdict over
10 limb columns), compact (lastpoint's, gathered by K7's selection) and over
2^24 hash slots with the overflow byte; K3 `segment_reduce_scatter` at the
TSBS tile shape (host x hour, C = 1, 5, 10), over minute buckets (G = 720:
few long runs), over host x minute (runs of 6 rows: the sparse ids) and over
H1's 2^24 slot ids, each alone on a precomputed `order` and (C = 1, 10, the
slots) with its K18 sort.

`--set strip_hash`: K9 `strip_counter_resets` at phase 3c's shape (17.28 M
rows in two chunks, 4096 padded series, the 5-minute source; the prologue
included) and on the same rows with a reset at every fourth row of each
series; K17 `hash_group_slots` at H1's shape (5.76 M rows, 2^24 slots, the
table's refill timed in) and at the mesh union's (4 slot tables of 2^24
keys, active where not HASH_EMPTY); K15's remap of the 4000-code plane
beside `torch.take`.  K9's bytes are those of the fetched rows and the row
prologue's layout; K17's the table, slots, overflow and rounds.

`--set gather_last`: K15 `gather_planes` and K4 `segment_last`.  K15's
remap of the 4000-code plane (17.28 M codes in two 2^24-row chunks)
beside `torch.take`; its gather of one f64 plane through the time-major
permutation (K14's) beside `torch.index_select`; the tile cell's first
time-major build, its 13 planes (valid, ts, hostname, ten f64 columns)
in one `gather_planes_multi` call where the checkout has it, else one
call a plane, with each plane's time alone and their sum.  K4's blocked
form at lastpoint's shape (G = 4096) and on the falling-bases planes
(G = 16), each held byte for byte against its plain version.

`--set mask_topk`: K1 `mask_gids` and K19 `topk_distances`.  K1 at the
tile path's two chunk shapes (the 2^24-row chunk and the 503,808-row tail
of the TSBS planes, double-groupby's filters), each as the tile program
calls it (`lits` a view of one uploaded literal buffer) and with
`lits=None` (the table built and uploaded each call, as phase 3b timed
it); at the table-fed shape; its int64 form at H1's inputs in both forms.
Each K1 time is the median of five readings (`ms_range` their range), and
each output is also held byte for byte against the plain version.  K19 at
1,000,000 x 128, k = 10, for l2sq, cos and dot beside `torch.mv` +
`torch.topk`; on uniform [0, 1) rows at k = 100 (bytes only: the
distances' bits depend on the add order); at k = 10,000 of 100,000.  The
first turn of each tree also prints the SASS of csrc/mask_gids.cu: each
kernel's instructions and `CALL.REL.NOINC` (subroutine calls, such as a
64-bit division's), the listing in <--out>/sass_<tree>_mask_gids.txt.

`--set having_topk`: K13 `having_mask` and K7 `topk_group_select`, the
device half of HAVING and ORDER BY / LIMIT.  K13 at phase 3d's
`having_case(4096 * 16)` and at the live HAVING queries' plan shape (their
refs and trees over 4096 hosts x 14 hour buckets); K7 keyed at
groupby-orderby-limit's shape (G = 768, cap 5, an int64 minute key,
descending) and at the live query's (G = 57,344, cap 10, the f64 max with
NaN as NULL, K13's mask as the survivors); K7's compaction at lastpoint's
(4096 groups, cap 4096); `TileProgram.device_select` whole at
groupby-orderby-limit and both live HAVING queries.  Each time is the
median of five readings, each output held byte for byte against its plain
version; with --profile each case also gives the kernels, memsets and
copies one call puts on the card.  The first turn of each tree prints the
SASS counts of both sources (listings in <--out>).

`--set patch_udd`: K16 `delta_patch` and K21 `segment_udd`.  K16 at phase
3d's shape: the live phase's delta (30 minutes x 6 scrapes x 4096 hosts =
737,280 rows, seeded sorted positions) merged into the 17.28 M-row entry
in 2^24-row chunks, on its f64, int32 and bool planes (interleaved), and
the f64 plane with the delta at the front and at the back.  K21 at phase
9's rows (--sketch-hours, usage_user's buckets, one row in 100 masked):
by host at B = 128 and 1024 (the ordered path where the checkout has
it), by hour at B = 1024 (hour gids in host order: the atomic path), one
bucket (every row on one), each beside `index_add_`, and phase 9's
four-shard two-step path (4 calls and their folds); K20 `segment_hll` at
phase 9's cases too (by host p = 12 and 14, by hour, one register), as
the run pass is shared.  Each time is the median of five readings, each
output held byte for byte against its plain version; the path a K21 or
K20 call took is read where the checkout says it.  The first turn of each
tree prints the SASS counts of delta_patch.cu and segment_udd.cu.

With --tql (any set), T2, T3 and T5 through `TQL EVAL` on the warm tile
route once per checkout (the dispatch stage's p50 beside the query's).

With --profile every shape runs once more under torch.profiler: the device
time of each CUDA kernel and memset it launched, per call, their sum, and
the names of any library sort kernel (cub, Radix, DeviceSort) among them.
The first turn of each checkout also prints `nvcc --resource-usage` of the
sources the set times (registers and shared memory of each kernel).

Each turn is a process of its own that imports the port of its checkout
and builds its kernels there (build/ of that checkout).  Each kernel's
time is the mean of --reps calls after one warm-up (CUDA events), and
each output's bytes are hashed, so that the line says whether the two
checkouts gave the same bytes.

Prints the card's name and power limit, one JSON line per turn and shape,
and a last line with the ms of each checkout (mean of its two turns) and
whether every output's bytes agreed.

    python3 tools/kernel_ab.py --other DIR
                               [--set blocked|range_hll|fold|pack_scatter|strip_hash|gather_last|
                                      mask_topk|having_topk|patch_udd]
                               [--hosts 4000]
                               [--hours 12] [--sketch-hours 12] [--reps 20] [--tql]
                               [--profile] [--out DIR]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = {"blocked": ("segment_reduce_blocked", "limb_segment_sums", "segment_last"),
           "range_hll": ("strip_counter_resets", "range_windows", "segment_hll"),
           "fold": ("fold_states", "series_fold"),
           "pack_scatter": ("pack_result", "segment_reduce_scatter"),
           "strip_hash": ("strip_counter_resets", "hash_group_slots", "gather_planes"),
           "gather_last": ("gather_planes", "segment_last"),
           "mask_topk": ("mask_gids", "topk_distances"),
           "having_topk": ("having_mask", "topk_select"),
           "patch_udd": ("delta_patch", "segment_udd", "segment_hll")}
# the sets whose first turn of each tree prints the SASS counts of these sources
SASS_SOURCES = {"mask_topk": ("mask_gids",), "having_topk": SOURCES["having_topk"],
                "patch_udd": ("delta_patch", "segment_udd")}
LIBRARY_SORT_NAMES = ("cub", "Radix", "DeviceSort")
AGGS = ("count", "max", "min", "sum")
# Hours of the falling-bases planes: at 10 s a host holds 360 rows an hour,
# so over 12 h (4320 rows) nearly every 4096-row block holds some host's
# first hour and its base is 0; over 16 h (5760 rows) a block inside one
# host starts at its own hour and the next, crossing into the next host,
# at 0 (1374 of 5625 bases fall at 4000 hosts)
FALL_HOURS = 16


def _digest(tensors) -> str:
    h = hashlib.sha1()
    for t in tensors:
        if t is not None:
            h.update(t.contiguous().view(-1).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _device_us(fn, calls: int = 5) -> tuple[dict, dict]:
    """({kernel, memset or copy name: device us per call}, {name: launches
    per call}) of fn() under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out, count = {}, {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if us and evt.device_type is not None and "cuda" in str(evt.device_type).lower():
            out[evt.key[:60]] = us / calls
            count[evt.key[:60]] = evt.count / calls
    return out, count


def _profiled(fn) -> dict:
    """What one call launches on the card: {"device_us": per kernel,
    "device_sum_us": their sum, "library_sorts": names of library sort
    kernels among them}."""
    us, count = _device_us(fn)
    # the kernel's name alone ("void ns::k<T>(A, B)" -> "ns::k"): the port's
    # own sort takes a RadixPlan argument
    names = {k: k.split("(")[0].split("<")[0].split(" ")[-1] for k in us}
    return {"device_us": us, "device_sum_us": sum(us.values()), "device_calls": count,
            "library_sorts": [k for k in us if any(s in names[k] for s in LIBRARY_SORT_NAMES)]}


def _state(st) -> list:
    return [st.sums, st.counts, st.mins, st.maxs]


def _enqueue_us(fn, reps: int) -> float:
    """Host microseconds per call to enqueue fn() (no sync inside): where it
    exceeds the CUDA-event time, back-to-back calls wait on the host."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def blocked_cases(c, hosts: int, hours: int, reps: int, prof: bool, emit, dev) -> None:
    import torch

    from greptimedb_tpu_torch.ops import aggregate as agg
    from greptimedb_tpu_torch.ops import filter as flt
    from greptimedb_tpu_torch.ops.tiles import pad_rows

    n, codes, ts, valid, vals = c.tsbs_planes(hosts, hours, 10, dev)
    card = 1 << (max(hosts, 1) - 1).bit_length()
    lo, hi = c.T0, c.T0 + hours * c.H3600
    G = card * hours

    def ids(valid, ts, codes):
        return flt.mask_gids(valid, [(ts, ">=", lo), (ts, "<", hi)], [], [(codes, card)],
                             (ts, c.T0, c.H3600, hours), G - 1)

    def case(name, fn, outs, **kw):
        emit(name, c._timed(fn, reps), _digest(outs), enqueue_us=_enqueue_us(fn, reps), **kw,
             **(_profiled(fn) if prof else {}))

    gids, mask = ids(valid, ts, codes)
    for C in (1, 5, 10):
        cols, masks = vals[:C], [mask] * C

        def k2():
            return agg.segment_reduce_blocked(cols, gids, masks, mask, G, AGGS)

        case(f"K2 C={C}", k2, _state(k2()[1]), rows=n, groups=G)

    # the tile path's planes: padded to a multiple of 4096 rows
    npad = pad_rows(n)
    codes, ts = c._padded(codes, npad, 0), c._padded(ts, npad, 0)
    valid = c._padded(valid, npad, False)
    vals = [c._padded(v, npad, 0.0) for v in vals]
    gids, mask = ids(valid, ts, codes)
    lcols = [agg.quantize_limbs(v) for v in vals]
    for C in (1, 10):
        def k6():
            return agg.limb_segment_sums(lcols[:C], gids, mask, G)

        case(f"K6 C={C}", k6, list(k6()), rows=npad, groups=G)

    def multi():
        return agg.segment_aggregate_multi(vals, gids, G, AGGS, [mask] * 10, mask)

    case("K2+K18+K3 C=10", multi, _state(multi()), rows=npad, groups=G)

    # the kernels whose launch geometry changed beside them: K3 (open) at C =
    # 1 and 10, K18 over minute buckets (G = 720: one pass), K14 over ts
    from greptimedb_tpu_torch.ops import permute as perm

    for C in (1, 10):
        def k3():
            return agg.segment_reduce_scatter(vals[:C], gids, [mask] * C, mask, G, AGGS)

        case(f"K3 C={C}", k3, _state(k3()), rows=npad, groups=G)
    n_min = hours * 60
    gm, mm = flt.mask_gids(valid, [(ts, "<", hi)], [], [], (ts, c.T0, 60_000, n_min), n_min - 1)

    def k18():
        return agg.sort_segments(gm, mm, n_min)

    case("K18 G=720", k18, list(k18()), rows=npad, groups=n_min)

    def k14():
        return perm.ts_argsort([ts], [valid])

    case("K14", k14, [k14()], rows=npad)
    del gm, mm

    gl, ml = flt.mask_gids(valid, [], [], [(codes, card)], None, card - 1)
    _v, _s, base_l = agg.segment_reduce_blocked([vals[0]], gl, [ml], ml, card, ("count",))

    def k4():
        return agg.segment_last(vals[0], ts, gl, ml, card, base=base_l)

    case("K4 blocked", k4, list(k4()), rows=npad, groups=card)

    # falling bases: hour alone over FALL_HOURS of host-major rows
    del codes, ts, valid, vals, lcols, gids, mask, gl, ml
    torch.cuda.empty_cache()
    n, codes, ts, valid, vals = c.tsbs_planes(hosts, FALL_HOURS, 10, dev)
    npad = pad_rows(n)
    codes, ts = c._padded(codes, npad, 0), c._padded(ts, npad, 0)
    valid = c._padded(valid, npad, False)
    vals = [c._padded(v, npad, 0.0) for v in vals]
    # column 0 in blocks of other magnitudes: their K5 scales differ, so a
    # group's sum rounds and the fold's order shows in K6's bytes
    gen = torch.Generator(device=dev).manual_seed(c.SEED + 12)
    mag = torch.exp(torch.rand(npad // agg.BLOCK_ROWS, generator=gen, device=dev,
                               dtype=torch.float64) * 40.0 - 20.0)
    vals[0] = vals[0] * mag.repeat_interleave(agg.BLOCK_ROWS)
    lcols = [agg.quantize_limbs(v) for v in vals]
    H = FALL_HOURS
    gh, mh = flt.mask_gids(valid, [], [], [], (ts, c.T0, c.H3600, H), H - 1)
    ok, pbase = agg.block_guard_plain(gh, mh, H)
    falls = int((pbase[1:] < pbase[:-1]).sum())

    def k2h():
        return agg.segment_reduce_blocked(vals, gh, [mh] * 10, mh, H, AGGS)

    verdict, k2_st, base_h = k2h()
    p2 = agg.segment_reduce_blocked_plain(vals, gh, [mh] * 10, mh, H, AGGS)[1]
    try:
        c._check_state(k2_st, p2, "K2 falling")
        k2_ok = True
    except AssertionError as e:
        k2_ok = str(e)
    case("K2 falling C=10", k2h, _state(k2_st), rows=npad, groups=H, guard=bool(ok),
         falls=falls, passed=c._passed(verdict), plain=k2_ok)

    def k6h():
        return agg.limb_segment_sums(lcols, gh, mh, H)

    got = k6h()
    host = torch.device("cpu")
    want = agg.limb_segment_sums_plain([(lb.to(host), s.to(host)) for lb, s in lcols],
                                       gh.to(host), mh.to(host), H)
    same = [c._same_bytes(a.cpu() if a is not None else None, b) for a, b in zip(got, want)]
    case("K6 falling C=10", k6h, list(got), rows=npad, groups=H,
         plain_bytes=dict(zip(("sums", "errs", "counts", "presence"), same)))

    def k4h():
        return agg.segment_last(vals[0], ts, gh, mh, H, base=base_h)

    got4 = k4h()
    want4 = agg.segment_last_plain(vals[0], ts, gh, mh, H, base=base_h)
    case("K4 falling", k4h, list(got4), rows=npad, groups=H,
         plain_bytes=all(c._same_bytes(a, b) for a, b in zip(got4, want4)))


def range_hll_cases(c, hosts: int, hours: int, sketch_hours: int, reps: int, prof: bool,
                    emit) -> None:
    import torch

    from greptimedb_tpu_torch.ops import rate as R
    from greptimedb_tpu_torch.ops import sketch as sk

    dev = torch.device("cuda", 0)
    # K10 at phase 3c's shapes
    n, npad, codes, ts, vals, present, valid = c.prom_planes(hosts, hours, dev)
    s_pad = 1 << (max(hosts, 1) - 1).bit_length()
    steps = hours * 60 + 1
    w_pad = 1 << (steps - 1).bit_length()
    start, end = c.T0, c.T0 + hours * c.H3600

    def source(range_ms):
        return R.RowSource(ts=ts, values=vals, num_series=s_pad, codes=(codes,),
                           radices=(s_pad,), nulls=present, valid=valid,
                           lo=start - range_ms, hi=end + 1)

    adj, _layout = R.strip_counter_resets(source(300_000))
    for range_ms, k, values in ((300_000, 8, adj), (3_600_000, 64, None)):
        src = source(range_ms)
        grid = R.RangeGrid(start, 60_000, range_ms, w_pad, k, s_pad, steps)

        def run():
            return R.range_windows(src, grid, values=values)

        st, pres = run()
        emit(f"K10 k={k}", c._timed(run, reps), _digest(st.tensors() + (pres,)),
             **(_profiled(run) if prof else {}))
        del st, pres
    del codes, ts, vals, present, valid, adj
    torch.cuda.empty_cache()

    # K20 at phase 9's rows
    import numpy as np
    import pyarrow as pa

    user = c.tsbs_columns(c.Tsbs(hosts, sketch_hours), ("usage_user",))["usage_user"]
    rows = user.shape[0]
    ticks = rows // hosts
    hashes = sk.hash64(pa.array(user))

    def up(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    host = up(np.repeat(np.arange(hosts, dtype=np.int32), ticks))
    hour = up(np.tile((np.arange(ticks) * c.SCRAPE_S // 3600).astype(np.int32), hosts))
    inputs = {p: [up(x) for x in sk.hll_inputs(hashes, p)] for p in (12, 14)}
    zeros = torch.zeros(rows, dtype=torch.int32, device=dev)
    cases = {
        "K20 host p=12": (*inputs[12], host, hosts, 1 << 12),
        "K20 hour p=12": (*inputs[12], hour, sketch_hours, 1 << 12),
        "K20 host p=14": (*inputs[14], host, hosts, 1 << 14),
        "K20 one register": (zeros, inputs[12][1], zeros, 1, 1 << 12),
    }
    for name, args in cases.items():
        got = sk.segment_hll(*args)
        emit(name, c._timed(lambda: sk.segment_hll(*args), reps), _digest([got]),
             library_ms=c._timed(c._library_call("hll", args, dev), reps), rows=rows,
             **(_profiled(lambda: sk.segment_hll(*args)) if prof else {}))
        del got
        torch.cuda.empty_cache()



# the TSBS double-groupby-all merge at 4 slots (the mesh cell's): 4000
# hosts (a card of 4096) x 12 hourly buckets; its hash plan's slot tables
FOLD_SLOTS = 4
TSBS_COLS = ("usage_user", "usage_system", "usage_idle", "usage_nice", "usage_iowait",
             "usage_irq", "usage_softirq", "usage_steal", "usage_guest", "usage_guest_nice")
HASH_SLOTS = 1 << 17


def _merge_parent(agg, states, n_local, order, dev, inv=None, dense=()):
    """The mesh merge before the batched entry: one stack and one K22 call
    per state key."""
    return {k: agg.fold_states(agg.stack_states([s[k] for s in states], dev), n_local, order,
                               inv=None if k in dense else inv)
            for k in states[0]}


def _merge(agg, states, n_local, order, dev, inv=None, dense=()):
    if hasattr(agg, "fold_state_dicts"):
        return agg.fold_state_dicts(states, n_local, order, dev=dev, inv=inv, dense_keys=dense)
    return _merge_parent(agg, states, n_local, order, dev, inv, dense)


def _split(st, m: int) -> list:
    """A stacked [m, rows] state as m per-source states (views)."""
    from greptimedb_tpu_torch.ops.aggregate import AggState

    names = ("sums", "counts", "mins", "maxs", "last_ts", "last_val")
    return [AggState(**{k: None if getattr(st, k) is None else getattr(st, k)[i] for k in names})
            for i in range(m)]


def _tsbs_dense_states(rng, dev) -> list:
    """Per slot the state dict of double-groupby-all's sort plan in limb
    mode: per column the limb sums and their error bound, and the presence
    count, over 4096 x 12 groups."""
    import torch

    from greptimedb_tpu_torch.ops.aggregate import AggState

    g = 4096 * 12
    out = []
    for _s in range(FOLD_SLOTS):
        st = {}
        for col in TSBS_COLS:
            st[col] = AggState(sums=torch.from_numpy(rng.standard_normal(g) * 1e3).to(dev))
            st["__limb_err:" + col] = AggState(sums=torch.from_numpy(rng.random(g) * 1e-9).to(dev))
        st["__presence"] = AggState(counts=torch.from_numpy(
            rng.integers(0, 360, g).astype(np.int32)).to(dev))
        out.append(st)
    return out


def _tsbs_keyed_states(agg, dev):
    """double-groupby-all's hash plan at 4 slots: per slot its K17 table of
    HASH_SLOTS slots over its partition's (host, hour) keys (host % 4), the
    union and its inversion, and per slot the state dict over its table
    (sums of 10 columns, usage_user's count, the presence, the overflow
    count; the identity in empty slots)."""
    import torch

    from greptimedb_tpu_torch.ops.aggregate import AggState

    g = torch.Generator(device=dev).manual_seed(29)
    tables = []
    for s in range(FOLD_SLOTS):
        ids = torch.arange(4000 * 12, dtype=torch.int64, device=dev)
        ids = ids[(ids // 12) % FOLD_SLOTS == s].contiguous()
        t = torch.full((HASH_SLOTS,), agg.HASH_EMPTY, dtype=torch.int64, device=dev)
        t, _slots, ovf = agg.hash_group_slots(t, ids, torch.ones_like(ids, dtype=torch.bool))
        assert int(ovf) == 0
        tables.append(t)
    keys = torch.cat(tables)
    union = torch.full((HASH_SLOTS,), agg.HASH_EMPTY, dtype=torch.int64, device=dev)
    union, slots, ovf = agg.hash_group_slots(union, keys, keys != agg.HASH_EMPTY)
    inv = agg.invert_slot_maps(slots.reshape(FOLD_SLOTS, HASH_SLOTS))
    states = []
    for t in tables:
        occ = t != agg.HASH_EMPTY

        def vals(ident, ints=False):
            v = (torch.randint(0, 360, (HASH_SLOTS,), generator=g, device=dev, dtype=torch.int32)
                 if ints else torch.randn(HASH_SLOTS, generator=g, device=dev,
                                          dtype=torch.float64) * 1e3)
            return torch.where(occ, v, torch.full_like(v, ident))

        st = {col: AggState(sums=vals(0.0)) for col in TSBS_COLS}
        st["usage_user"] = AggState(sums=st["usage_user"].sums, counts=vals(0, True))
        st["__presence"] = AggState(counts=vals(0, True))
        st["__hash_overflow"] = AggState(counts=torch.zeros(1, dtype=torch.int32, device=dev))
        states.append(st)
    return states, inv


def _rate_matrix(rng, dev, s_pad: int = 4096, w_pad: int = 1024, hosts: int = 4000,
                 steps: int = 721):
    """A seeded [s_pad, w_pad] rate matrix as phase 3c's fold reads it: the
    padded series and steps NaN, 1 % NaN holes, values of mixed magnitude."""
    import torch

    v = rng.random((s_pad, w_pad)) * 10.0 ** rng.integers(-3, 4, (s_pad, w_pad))
    v[hosts:] = np.nan
    v[:, steps:] = np.nan
    v[rng.random((s_pad, w_pad)) < 0.01] = np.nan
    return torch.from_numpy(v).to(dev)


def fold_cases(c, reps: int, prof: bool, emit, dev) -> None:
    import torch

    from greptimedb_tpu_torch.ops import aggregate as agg
    from greptimedb_tpu_torch.ops import rate as R

    rng = np.random.default_rng(c.SEED)
    batched = hasattr(agg, "fold_state_dicts")

    def case(name, fn, outs, **kw):
        emit(name, c._timed(fn, reps), _digest(outs), enqueue_us=_enqueue_us(fn, reps),
             batched=batched, **kw, **(_profiled(fn) if prof else {}))

    def merged(out):
        return [t for k in out for t in _state(out[k]) + [out[k].last_ts, out[k].last_val]]

    # one key: the one-key form over stacked states, and the merge of
    # per-source states (the parent: a stack, then the one-key form)
    for m, rows in ((FOLD_SLOTS, 1 << 16), (8, 48_000 * 10)):
        st = c._fold_inputs(rng, m, rows, dev)
        order = list(range(m))
        b, _by = c.bound(c._state_bytes(st) * (1 + 1 / m), 0)

        def one():
            return agg.fold_states(st, m, order)

        got = one()
        case(f"K22 dense {m}x{rows} one-key form", one,
             _state(got) + [got.last_ts, got.last_val], rows=rows, sources=m, bound_ms=b)
        per = [{"k": s} for s in _split(st, m)]

        def dict_merge():
            return _merge(agg, per, m, order, dev)

        case(f"K22 dense {m}x{rows} merge", dict_merge, merged(dict_merge()), rows=rows,
             sources=m, bound_ms=b)
        del st, per
    # keyed at the container cell's slot tables, the inversion apart
    tables = c._slot_tables(FOLD_SLOTS, c.MESH_H, c.CM_HOURS, dev)
    keys = tables.reshape(-1)
    u = torch.full((c.MESH_H,), agg.HASH_EMPTY, dtype=torch.int64, device=dev)
    u, slots, _ovf = agg.hash_group_slots(u, keys, keys != agg.HASH_EMPTY)
    inv = agg.invert_slot_maps(slots.reshape(FOLD_SLOTS, c.MESH_H))
    kst = c._keyed_states(tables, False, c.SEED)
    korder = list(range(FOLD_SLOTS))

    def keyed():
        return agg.fold_states(kst, 1, korder, inv=inv)

    case("K22 keyed 4x2^24 fold", keyed, _state(keyed()), rows=c.MESH_H,
         invert_ms=c._timed(lambda: agg.invert_slot_maps(slots.reshape(FOLD_SLOTS, c.MESH_H)),
                            reps))
    kper = [{"k": s} for s in _split(kst, FOLD_SLOTS)]

    def keyed_merge():
        return _merge(agg, kper, 1, korder, dev, inv=inv)

    case("K22 keyed 4x2^24 merge", keyed_merge, merged(keyed_merge()), rows=c.MESH_H)
    del tables, keys, u, slots, inv, kst, kper
    torch.cuda.empty_cache()

    # whole merges: double-groupby-all's state dicts at 4 slots
    dense = _tsbs_dense_states(rng, dev)

    def whole():
        return _merge(agg, dense, 1, korder, dev)

    nbytes = sum(t.numel() * t.element_size() for st in dense for s in st.values()
                 for t in _state(s) if t is not None)
    b, _by = c.bound(nbytes * (1 + 1 / FOLD_SLOTS), 0)
    case("K22 whole merge dense (21 keys)", whole, merged(whole()), keys=len(dense[0]),
         bound_ms=b, parent_loop_ms=c._timed(
             lambda: _merge_parent(agg, dense, 1, korder, dev), reps))
    hstates, hinv = _tsbs_keyed_states(agg, dev)
    dk = ("__hash_overflow",)

    def whole_keyed():
        return _merge(agg, hstates, 1, korder, dev, inv=hinv, dense=dk)

    case("K22 whole merge keyed (12 keys)", whole_keyed, merged(whole_keyed()),
         keys=len(hstates[0]), parent_loop_ms=c._timed(
             lambda: _merge_parent(agg, hstates, 1, korder, dev, hinv, dk), reps))
    del dense, hstates, hinv
    torch.cuda.empty_cache()

    # K12 over a rate matrix at G = 1, 64 and 4096
    mat = _rate_matrix(rng, dev)
    s_pad, w_pad = mat.shape
    forms = hasattr(R, "_series_fold_launch")
    for keep, radices in (((), (s_pad,)), ((0,), (2, s_pad // 2)), ((0,), (16, s_pad // 16)),
                          ((0,), (32, s_pad // 32)), ((0,), (64, 64)), ((0,), (s_pad,))):
        off, mem = (torch.from_numpy(x).to(dev) for x in R.group_csr(radices, keep))
        G = int(off.shape[0]) - 1
        gid = torch.from_numpy(R.gid_map(radices, keep)).to(dev)
        zeroed = torch.nan_to_num(mat, nan=0.0)
        lib = c._timed(lambda: torch.zeros((G, w_pad), dtype=torch.float64, device=dev)
                       .index_add_(0, gid, zeroed), reps)
        b, _by = c.bound(mat.numel() * 8 + G * w_pad * 8 + (G + 1 + s_pad) * 8, 0)
        tws = {"": None}
        if forms:
            tws.update({" cells": 0, " staged": R._staged_tile(G, w_pad)})
        for form, tw in tws.items():
            def fold():
                if tw is None:
                    return R.series_fold(mat, off, mem, "sum")
                return R._series_fold_launch(mat, off, mem, "sum", tw)

            plan = R.series_fold_plan(s_pad, G, w_pad) if hasattr(R, "series_fold_plan") else None
            case(f"K12 G={G}{form}", fold, [fold()], groups=G, library_ms=lib, bound_ms=b,
                 plan=plan, tw=tw)
    del mat
    torch.cuda.empty_cache()


def pack_scatter_cases(c, hosts: int, hours: int, reps: int, prof: bool, emit, dev) -> None:
    """K8 and K3 at chip_smoke.py's shapes, each call's host enqueue beside
    its device time."""
    import torch

    from greptimedb_tpu_torch.ops import aggregate as agg
    from greptimedb_tpu_torch.ops import filter as flt
    from greptimedb_tpu_torch.ops.tiles import pad_rows
    from greptimedb_tpu_torch.parallel.tile_planner import quantize_soft

    def case(name, fn, outs, **kw):
        emit(name, c._timed(fn, reps), _digest(outs), enqueue_us=_enqueue_us(fn, reps), **kw,
             **(_profiled(fn) if prof else {}))

    gen = torch.Generator(device=dev).manual_seed(c.SEED + 14)

    def f64(n, scale=1.0):
        return torch.rand(n, generator=gen, dtype=torch.float64, device=dev) * scale

    def i32(n, hi):
        return torch.randint(0, hi, (n,), generator=gen, dtype=torch.int32, device=dev)

    # K8 dense: double-groupby-all's layout at G = 4096 x 12 (bit-packed
    # presence, 10 f32 avg rows, the verdict over 10 limb columns)
    card = 1 << (max(hosts, 1) - 1).bit_length()
    G = card * hours
    pres = i32(G, 361)
    sums = [f64(G, 3.6e4) for _ in range(10)]
    errs = [f64(G, 1e-9) for _ in range(10)]
    dense = ([pres], [(s, pres) for s in sums], [], True)
    verdict = [(e, s) for e, s in zip(errs, sums)]

    def k8_dense():
        return agg.pack_result(*dense, verdict_rows=verdict)

    b, _by = c.bound(G * (4 + 10 * 16) + G // 8 + G * 40 + 1, 0)
    case("K8 dense", k8_dense, list(k8_dense()), groups=G, bound_ms=b)
    # K8 compact: lastpoint's presence and one f64 row gathered by K7
    cap = quantize_soft(hosts)
    surv = torch.arange(card, device=dev) < hosts
    sel, n_out = agg.topk_group_select(surv, [], cap)
    comp = ([surv.to(torch.int32)], [], [("value", f64(card, 100.0))], False)

    def k8_compact():
        return agg.pack_result(*comp, sel=sel, n_out=n_out)

    b, _by = c.bound(cap * 4 + 4 + cap * (4 + 8) + cap * (4 + 4 + 8) + 8, 0)
    case("K8 compact", k8_compact, list(k8_compact()), groups=card, cap=cap, bound_ms=b)
    # K8 over the 2^24 slot rows of a hash plan, and the overflow byte
    H = 1 << 24
    hp = i32(H, 3)
    hashed = ([hp], [(f64(H, 2e9), hp)], [("value", f64(H, 2e9))], True)
    ovf = torch.zeros(1, dtype=torch.int32, device=dev)

    def k8_hash():
        return agg.pack_result(*hashed, overflow=ovf)

    b, _by = c.bound(H * (4 + 8 + 8) + 4 + H // 8 + H * (4 + 8) + 1, 0)
    case("K8 hash 2^24", k8_hash, list(k8_hash()), groups=H, bound_ms=b)
    del pres, sums, errs, dense, verdict, hp, hashed
    torch.cuda.empty_cache()

    # K3 at the TSBS tile shape: 17.28 M rows padded to whole blocks, host x
    # hour (G = 4096 x 12), C = 1, 5, 10; with its K18 sort and alone
    n, codes, ts, valid, vals = c.tsbs_planes(hosts, hours, 10, dev)
    npad = pad_rows(n)
    codes, ts = c._padded(codes, npad, 0), c._padded(ts, npad, 0)
    valid = c._padded(valid, npad, False)
    vals = [c._padded(v, npad, 0.0) for v in vals]
    lo, hi = c.T0, c.T0 + hours * c.H3600
    n_min = hours * 60
    shapes = {
        "tsbs": flt.mask_gids(valid, [(ts, ">=", lo), (ts, "<", hi)], [], [(codes, card)],
                              (ts, c.T0, c.H3600, hours), G - 1) + (G,),
        # minute buckets over all hosts: 720 long runs (dense ids)
        "minute G=720": flt.mask_gids(valid, [(ts, "<", hi)], [], [],
                                      (ts, c.T0, 60_000, n_min), n_min - 1) + (n_min,),
        # host x minute: runs of 6 rows over 4096 x 720 ids (sparse ids)
        "host x minute": flt.mask_gids(valid, [(ts, "<", hi)], [], [(codes, card)],
                                       (ts, c.T0, 60_000, n_min), card * n_min - 1)
        + (card * n_min,),
    }
    for shape, (gids, mask, groups) in shapes.items():
        order = agg.sort_segments(gids, mask, groups)
        for C in ((1, 5, 10) if shape == "tsbs" else (1,)):
            cols, masks = vals[:C], [mask] * C
            kb, _by = c.bound(npad * (4 + 1 + 8 * C) + C * groups * 28, 0)

            def k3_alone():
                return agg.segment_reduce_scatter(cols, gids, masks, mask, groups, AGGS, order)

            case(f"K3 {shape} C={C} alone", k3_alone, _state(k3_alone()), rows=npad,
                 groups=groups, bound_ms=kb)
            if C in (1, 10):
                def k3():
                    return agg.segment_reduce_scatter(cols, gids, masks, mask, groups, AGGS)

                case(f"K3 {shape} C={C} with K18", k3, _state(k3()), rows=npad, groups=groups,
                     bound_ms=kb)
        del order
    del codes, ts, valid, vals, shapes
    torch.cuda.empty_cache()

    # K3 over the 2^24 slot ids of H1 (K1 int64 ids, K17's slots)
    _n, k1_args = c.h1_group_ids(c.CM_HOURS, dev)
    gids, mask = flt.mask_gids(*k1_args)
    table = torch.full((H,), agg.HASH_EMPTY, dtype=torch.int64, device=dev)
    _t, slots, _ovf = agg.hash_group_slots(table, gids, mask)
    hv = f64(slots.shape[0], 2e9)
    haggs = ("count", "max", "sum")
    order = agg.sort_segments(slots, mask, H)
    kb, _by = c.bound(slots.shape[0] * (4 + 1 + 8) + H * (8 + 4 + 8), 0)

    def k3_slots_alone():
        return agg.segment_reduce_scatter([hv], slots, [mask], mask, H, haggs, order)

    def k3_slots():
        return agg.segment_reduce_scatter([hv], slots, [mask], mask, H, haggs)

    case("K3 2^24 slots alone", k3_slots_alone, _state(k3_slots_alone()), rows=slots.shape[0],
         groups=H, bound_ms=kb)
    case("K3 2^24 slots with K18", k3_slots, _state(k3_slots()), rows=slots.shape[0], groups=H,
         bound_ms=kb)
    del gids, mask, table, slots, hv, order
    torch.cuda.empty_cache()

    # the order's edge: runs of 1 to ~9000 rows with NaN, +-0 and +-inf
    # values and a column mask, as dense ids and spread over 2^20 (sparse)
    rng = np.random.default_rng(c.SEED + 15)
    lens = np.array([1, 31, 32, 33, 9001, 2, 0, 64, 65, 5, 1, 0] * 40)
    runs = np.repeat(np.arange(lens.size), lens)
    spread = np.sort(rng.choice(np.arange(1 << 20), lens.size, replace=False))
    n = runs.size
    v = rng.normal(0, 100, n)
    for val, cnt in ((np.nan, 50), (-0.0, 300), (0.0, 300), (np.inf, 20), (-np.inf, 20)):
        v[rng.choice(n, cnt, replace=False)] = val
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    cols = [up(v), up(rng.normal(0, 1, n) * 1e-300)]
    base = up(rng.random(n) < 0.9)
    masks = [base, base & up(rng.random(n) < 0.5)]
    for shape, gids, groups in (("dense", runs, lens.size), ("sparse", spread[runs], 1 << 20)):
        g = up(rng.permutation(gids).astype(np.int32))
        order = agg.sort_segments(g, base, groups)

        def k3_edge():
            return agg.segment_reduce_scatter(cols, g, masks, base, groups, AGGS, order)

        case(f"K3 edge runs {shape}", k3_edge, _state(k3_edge()), rows=n, groups=groups)


def _reset_every_fourth(vals, ticks: int) -> list:
    """Counter values in which every fourth row of each series (row j of
    its `ticks`, j % 4 == 0, j > 0) falls below the row before it: about
    1000 then 2000, 3000, 4000; NaN where `vals` holds NaN."""
    import torch

    out, row0 = [], 0
    for v in vals:
        j = torch.arange(row0, row0 + v.shape[0], device=v.device) % ticks
        ramp = (j % 4 + 1).to(torch.float64) * 1000.0 + (j % 997).to(torch.float64) * 1e-3
        out.append(torch.where(torch.isnan(v), v, ramp))
        row0 += v.shape[0]
    return out


def strip_hash_cases(c, hosts: int, hours: int, reps: int, prof: bool, emit, dev) -> None:
    """K9 and K17 at chip_smoke.py's shapes, each call's host enqueue beside
    its device split; K15's remap beside `torch.take`."""
    import torch

    from greptimedb_tpu_torch.ops import aggregate as agg
    from greptimedb_tpu_torch.ops import filter as flt
    from greptimedb_tpu_torch.ops import permute as perm
    from greptimedb_tpu_torch.ops import rate as R

    def case(name, fn, outs, **kw):
        emit(name, c._timed(fn, reps), _digest(outs), enqueue_us=_enqueue_us(fn, reps), **kw,
             **(_profiled(fn) if prof else {}))

    # K9 at phase 3c's shape: 17.28 M rows in two chunks, S_pad 4096, the
    # 5-minute source; then the same rows with a reset every fourth row
    n, npad, codes, ts, vals, present, valid = c.prom_planes(hosts, hours, dev)
    s_pad = 1 << (max(hosts, 1) - 1).bit_length()
    start, end = c.T0, c.T0 + hours * c.H3600
    ticks = hours * 3600 // c.SCRAPE_S
    kb, _by = c.bound(npad * 30, npad * 4)
    for shape, values in (("5m", vals), ("reset every 4th row", _reset_every_fourth(vals, ticks))):
        src = R.RowSource(ts=ts, values=values, num_series=s_pad, codes=(codes,),
                          radices=(s_pad,), nulls=present, valid=valid,
                          lo=start - 300_000, hi=end + 1)

        def k9():
            return R.strip_counter_resets(src)

        adj, layout = k9()
        fetched = layout.in_fetch.bool()
        case(f"K9 {shape}", k9, [adj[fetched], layout.in_fetch, layout.first, layout.last,
                                 layout.presence],
             rows=npad, fetched=int(fetched.sum()), bound_ms=kb)
        del adj, layout, fetched
    del codes, ts, vals, present, valid
    torch.cuda.empty_cache()

    # K17 at H1's shape (5.76 M rows, 2^24 slots, the table's refill timed
    # in), then the mesh union's (4 slot tables of 2^24 keys, active where
    # not HASH_EMPTY)
    H = 1 << 24
    _n, k1_args = c.h1_group_ids(c.CM_HOURS, dev)
    gids, mask = flt.mask_gids(*k1_args)
    tables = c._slot_tables(4, c.MESH_H, c.CM_HOURS, dev)
    keys = tables.reshape(-1)
    for shape, (g, a, h) in (("H1", (gids, mask, H)),
                              ("mesh union 4x2^24", (keys, keys != agg.HASH_EMPTY, c.MESH_H))):
        table = torch.empty(h, dtype=torch.int64, device=dev)

        def k17():
            return agg.hash_group_slots(table.fill_(agg.HASH_EMPTY), g, a)

        t, slots, ovf = k17()
        rounds = agg.hash_group_slots.last_rounds
        m, m_act = int(g.shape[0]), int(a.sum())
        # active flags (1 B) read and slots (4 B) written for every row, the
        # gids (8 B) of the active rows read, the table read and written
        kb, _by = c.bound(m * (1 + 4) + m_act * 8 + h * 16, m_act * int(rounds.reshape(-1)[0]) * 8)
        case(f"K17 {shape}", k17, [t, slots, ovf, rounds], rows=m, active=m_act, slots=h,
             rounds=int(rounds.reshape(-1)[0]), occupied=int((t != agg.HASH_EMPTY).sum()),
             bound_ms=kb, fill_ms=c._timed(lambda: table.fill_(agg.HASH_EMPTY), reps))
        del table, t, slots, ovf
    del gids, mask, tables, keys, k1_args
    torch.cuda.empty_cache()

    # K15's remap: the 4000-code plane of the entry through the growth
    # permutation, beside torch.take
    from greptimedb_tpu_torch.ops.tiles import pad_rows
    from greptimedb_tpu_torch.parallel.tile_planes import TILE_CHUNK_ROWS

    n, codes, _ts, _valid, _vals = c.tsbs_planes(hosts, hours, 1, dev)
    del _ts, _valid, _vals
    npad = pad_rows(n)
    codes_c = c._chunked(c._padded(codes, npad, 0), TILE_CHUNK_ROWS)
    table = torch.from_numpy(c.growth_perm(hosts, hosts + c.LIVE_NEW_HOSTS)).to(dev)
    flat_codes = torch.cat(codes_c).to(torch.int64)
    kb, _by = c.bound(npad * (4 + 4) + table.numel() * 4, 0)

    def remap():
        return perm.gather_planes(codes_c, table, remap=True)

    case("K15 remap", remap, remap(), rows=npad, bound_ms=kb,
         library_ms=c._timed(lambda: torch.take(table, flat_codes), reps))


# The planes of the TSBS tile cell's first time-major build (cpu-max-all-1:
# valid, ts, hostname and the ten usage columns; no null planes)
TM_COLS = 10


def gather_last_cases(c, hosts: int, hours: int, reps: int, prof: bool, emit, dev) -> None:
    """K15 (remap, one f64 plane, the tile cell's time-major build) and K4's
    blocked form (lastpoint, falling bases) at chip_smoke.py's shapes."""
    import torch

    from greptimedb_tpu_torch.ops import aggregate as agg
    from greptimedb_tpu_torch.ops import filter as flt
    from greptimedb_tpu_torch.ops import permute as perm
    from greptimedb_tpu_torch.ops.tiles import pad_rows
    from greptimedb_tpu_torch.parallel.tile_planes import TILE_CHUNK_ROWS

    def case(name, fn, outs, **kw):
        emit(name, c._timed(fn, reps), _digest(outs), enqueue_us=_enqueue_us(fn, reps), **kw,
             **(_profiled(fn) if prof else {}))

    n, codes, ts, valid, vals = c.tsbs_planes(hosts, hours, TM_COLS, dev)
    npad = pad_rows(n)
    chunk = lambda t, fill: c._chunked(c._padded(t, npad, fill), TILE_CHUNK_ROWS)  # noqa: E731
    codes_c, ts_c, valid_c = chunk(codes, 0), chunk(ts, 0), chunk(valid, False)
    vals_c = [chunk(v, 0.0) for v in vals]
    del codes, ts, valid, vals

    # K15 remap: the 4000-code plane through the growth permutation
    table = torch.from_numpy(c.growth_perm(hosts, hosts + c.LIVE_NEW_HOSTS)).to(dev)
    flat_codes = torch.cat(codes_c).to(torch.int64)
    rb, _by = c.bound(npad * (4 + 4) + table.numel() * 4, 0)

    def remap():
        return perm.gather_planes(codes_c, table, remap=True)

    take_ms = c._timed(lambda: torch.take(table, flat_codes), reps)
    case("K15 remap", remap, remap(), rows=npad, bound_ms=rb, library_ms=take_ms)
    del flat_codes

    # K15 gather: one f64 plane through the time-major permutation
    order = perm.ts_argsort(ts_c, valid_c)
    flat = torch.cat(vals_c[0])
    order64 = order.to(torch.int64)
    gb, _by = c.bound(npad * (4 + 8 + 8), 0)

    def gather_f64():
        return perm.gather_planes(vals_c[0], order)

    case("K15 gather f64", gather_f64, gather_f64(), rows=npad, bound_ms=gb,
         library_ms=c._timed(lambda: torch.index_select(flat, 0, order64), reps))
    del flat, order64

    # K15: the tile cell's first time-major build, its 13 planes at once
    # (one launch of gather_planes_multi where the checkout has it, else
    # one launch a plane, as ensure_time_major made them)
    planes = [valid_c, ts_c, codes_c, *vals_c]
    multi = hasattr(perm, "gather_planes_multi")

    def build():
        if multi:
            return perm.gather_planes_multi(planes, order)
        return [perm.gather_planes(p, order) for p in planes]

    l0 = perm.gather_planes.launches
    got = build()
    launches = perm.gather_planes.launches - l0
    esum = sum(p[0].element_size() for p in planes)
    b_one, _by = c.bound(npad * 4 + npad * 2 * esum, 0)
    b_per, _by = c.bound(len(planes) * npad * 4 + npad * 2 * esum, 0)
    per_plane = [c._timed(lambda p=p: perm.gather_planes(p, order), reps) for p in planes]
    case("K15 time-major build (13 planes)", build, [t for p in got for t in p], rows=npad,
         planes=len(planes), launches=launches, multi=multi, bound_ms=b_one,
         per_plane_bound_ms=b_per, per_plane_ms=per_plane, per_plane_sum_ms=sum(per_plane))
    del got, planes, order, vals_c, ts_c, codes_c, valid_c
    torch.cuda.empty_cache()

    # K4 blocked at lastpoint's shape (hostname alone, G = 4096) and on the
    # falling-bases planes (hour alone over FALL_HOURS, G = 16)
    card = 1 << (max(hosts, 1) - 1).bit_length()
    for shape, hrs in (("lastpoint", hours), ("falling", FALL_HOURS)):
        n, codes, ts, valid, vals = c.tsbs_planes(hosts, hrs, 1, dev)
        npad = pad_rows(n)
        codes, ts = c._padded(codes, npad, 0), c._padded(ts, npad, 0)
        valid = c._padded(valid, npad, False)
        v = c._padded(vals[0], npad, 0.0)
        del vals
        if shape == "lastpoint":
            g, m = flt.mask_gids(valid, [], [], [(codes, card)], None, card - 1)
            G = card
        else:
            G = FALL_HOURS
            g, m = flt.mask_gids(valid, [], [], [], (ts, c.T0, c.H3600, G), G - 1)
        verdict, _st, base = agg.segment_reduce_blocked([v], g, [m], m, G, ("count",))

        def k4():
            return agg.segment_last(v, ts, g, m, G, base=base)

        got4 = k4()
        want4 = agg.segment_last_plain(v, ts, g, m, G, base=base)
        kb, _by = c.bound(npad * (4 + 1 + 8) + G * 8 + G * (8 + 8), npad * 2)
        case(f"K4 {shape}", k4, list(got4), rows=npad, groups=G, bound_ms=kb,
             passed=c._passed(verdict),
             plain_bytes=all(c._same_bytes(a, b) for a, b in zip(got4, want4)))
        del codes, ts, valid, v, g, m, base, got4, want4
        torch.cuda.empty_cache()


def _tile_lits(flt, filters, origin: int, interval: int, n_views: int, dev):
    """`n_views` views of one uploaded int64 buffer, each K1's literal table
    of `filters` (given as (plane dtype, op, value)): the form the tile
    program hands each source (`TileProgram.run_with`)."""
    from greptimedb_tpu_torch.kernels._build import upload_table

    table = flt.literal_table(filters, origin, interval)
    buf = upload_table(table * n_views + [0], dev)  # a HAVING literal after them
    return [buf[i * len(table):(i + 1) * len(table)] for i in range(n_views)]


def mask_topk_cases(c, hosts: int, hours: int, reps: int, prof: bool, emit, dev) -> None:
    """K1 `mask_gids` at the tile path's chunk shapes (the 2^24-row chunk
    and the tail of the TSBS planes, double-groupby's filters), each as the
    tile program calls it (`lits` a view of one uploaded literal buffer) and
    as phase 3b called it (`lits=None`: the table built and uploaded each
    call); at the table-fed shape (phase 3); its int64 form at H1's inputs
    (phase 3e) in both forms.  K19 `topk_distances` at phase 8's shape
    (1,000,000 x 128, k = 10) for every metric beside `torch.mv` +
    `torch.topk`, on real-valued rows (uniform [0, 1): the distances'
    bits depend on the add order) and at k = 10,000 of 100,000 (the radix
    sort's path).  Each K1 time is the median of five readings with their
    range."""
    import torch

    from greptimedb_tpu_torch.ops import filter as flt
    from greptimedb_tpu_torch.ops import vector as V
    from greptimedb_tpu_torch.ops.tiles import pad_rows
    from greptimedb_tpu_torch.parallel.tile_planes import TILE_CHUNK_ROWS

    def case(name, fn, outs, timed=None, **kw):
        emit(name, **(timed or {"ms": c._timed(fn, reps)}), digest=_digest(outs),
             enqueue_us=_enqueue_us(fn, reps), **kw, **(_profiled(fn) if prof else {}))

    def k1_case(name, args, lits, rows, bound_ms):
        fn = lambda: flt.mask_gids(*args, lits=lits)  # noqa: E731
        got = fn()
        want = flt.mask_gids_plain(*args)
        plain = all(c._same_bytes(a, b) for a, b in zip(got, want))
        case(name, fn, list(got), timed=c._timed_runs(fn, reps), rows=rows, bound_ms=bound_ms,
             plain_bytes=plain)

    n, codes, ts, valid, _vals = c.tsbs_planes(hosts, hours, 0, dev)
    card = 1 << (max(hosts, 1) - 1).bit_length()
    G = card * hours
    lo, hi = c.T0, c.T0 + hours * c.H3600

    # table-fed: phase 3's unpadded planes, the table uploaded a call
    b, _by = c.bound(n * (1 + 8 + 4) + n * (4 + 1), n * 8)
    k1_case("K1 table-fed", (valid, [(ts, ">=", lo), (ts, "<", hi)], [], [(codes, card)],
                            (ts, c.T0, c.H3600, hours), G - 1), None, n, b)

    # the tile path's chunks: the planes padded to 4096 rows, cut at 2^24
    npad = pad_rows(n)
    codes, ts = c._padded(codes, npad, 0), c._padded(ts, npad, 0)
    valid = c._padded(valid, npad, False)
    spans = list(range(0, npad, TILE_CHUNK_ROWS))
    views = _tile_lits(flt, [(torch.int64, ">=", lo), (torch.int64, "<", hi)], c.T0, c.H3600,
                       len(spans), dev)
    for o, lits in zip(spans, views):
        v_c, t_c, c_c = (x[o:o + TILE_CHUNK_ROWS] for x in (valid, ts, codes))
        rows = int(v_c.shape[0])
        args = (v_c, [(t_c, ">=", lo), (t_c, "<", hi)], [], [(c_c, card)],
                (t_c, c.T0, c.H3600, hours), G - 1)
        b, _by = c.bound(rows * (1 + 8 + 4) + rows * (4 + 1), rows * 8)
        k1_case(f"K1 chunk {rows} tile", args, lits, rows, b)
        k1_case(f"K1 chunk {rows} upload", args, None, rows, b)
    del codes, ts, valid, views
    torch.cuda.empty_cache()

    # the wrapper's output allocation on the host, per call: two tensors,
    # or one allocation cut into the ids and the mask (two views)
    rows = TILE_CHUNK_ROWS

    def two_allocations():
        return (torch.empty(rows, dtype=torch.int32, device=dev),
                torch.empty(rows, dtype=torch.bool, device=dev))

    def one_allocation():
        out = torch.empty(5 * rows, dtype=torch.uint8, device=dev)
        return out[:4 * rows].view(torch.int32), out[4 * rows:].view(torch.bool)

    for name, fn in (("two allocations", two_allocations), ("one allocation", one_allocation)):
        us = _enqueue_us(fn, 20 * reps)
        emit(f"host: K1 outputs, {name}", us / 1e3, None, enqueue_us=us)

    # int64 ids at H1's inputs (phase 3e), both forms
    _n, args = c.h1_group_ids(c.CM_HOURS, dev)
    rows = int(args[0].shape[0])
    b, _by = c.bound(rows * (1 + 8 + 3 * 4) + rows * (8 + 1), rows * 12)
    (lits,) = _tile_lits(flt, [(torch.int64, ">=", c.T0),
                               (torch.int64, "<", c.T0 + c.CM_HOURS * c.H3600)],
                         c.T0, c.CM_BUCKET_MS, 1, dev)
    k1_case("K1 int64 H1 tile", args, lits, rows, b)
    k1_case("K1 int64 H1 upload", args, None, rows, b)
    del args, lits
    torch.cuda.empty_cache()

    # K19 at phase 8's shape: integer rows (one in 4099 invalid), then
    # uniform [0, 1) rows, whose distances carry rounding
    rows, dim = c.SIFT_ROWS, c.SIFT_DIM
    base, queries = c.sift_data(rows, dim)
    valid_np = np.ones(rows, dtype=bool)
    valid_np[::4099] = False
    base[~valid_np] = 0.0
    mat = torch.from_numpy(base).to(dev)
    valid = torch.from_numpy(valid_np).to(dev)
    q = torch.from_numpy(queries[0]).to(dev)
    rng = np.random.default_rng(c.SEED + 9)
    real = torch.from_numpy(rng.random((rows, dim), dtype=np.float32)).to(dev)
    qr = torch.from_numpy(rng.random(dim, dtype=np.float32)).to(dev)
    lib = c._timed(lambda: torch.topk(torch.mv(mat, q), 10, largest=False), reps)
    for metric in ("l2sq", "cos", "dot"):
        fn = lambda m=metric: V.topk_distances(mat, valid, q, m, 10, True)  # noqa: E731
        got = fn()
        b, _by = c._vector_bound(rows, dim, 10, metric)
        case(f"K19 {metric} k=10", fn, list(got), rows=rows, dim=dim, bound_ms=b,
             library_ms=lib,
             plain_bytes=all(c._same_bytes(x, y) for x, y in
                             zip(got, V.topk_distances_plain(mat, valid, q, metric, 10, True))))
        fr = lambda m=metric: V.topk_distances(real, valid, qr, m, 100, m != "dot")  # noqa: E731
        case(f"K19 {metric} k=100 real", fr, list(fr()), rows=rows, dim=dim)
    del mat, valid, real
    torch.cuda.empty_cache()
    base, queries = c.sift_data(rows // 10, dim)
    big = torch.from_numpy(base).to(dev)
    ones = torch.ones(base.shape[0], dtype=torch.bool, device=dev)
    q = torch.from_numpy(queries[0]).to(dev)
    fn = lambda: V.topk_distances(big, ones, q, "l2sq", 10_000, True)  # noqa: E731
    b, _by = c._vector_bound(base.shape[0], dim, 10_000, "l2sq")
    case("K19 l2sq k=10000 of 100000", fn, list(fn()), rows=base.shape[0], dim=dim, bound_ms=b,
         library_ms=c._timed(lambda: torch.topk(torch.mv(big, q), 10_000, largest=False), reps))


def _smoke_here():
    """This checkout's chip_smoke.py, loaded apart from the turn's own: the
    select stage's shapes (`select_inputs`), whichever tree a turn times.
    Its functions import the port of the turn's tree."""
    import importlib.util

    mod = sys.modules.get("chip_smoke_here")
    if mod is None:
        spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                      os.path.join(ROOT, "chip_smoke.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules["chip_smoke_here"] = mod
        spec.loader.exec_module(mod)
    return mod


def _ops_per_call(prof: dict) -> dict:
    """{"kernels", "memsets", "copies"}: what one call put on the card, from
    `_profiled`'s per-call launch counts."""
    out = {"kernels": 0.0, "memsets": 0.0, "copies": 0.0}
    for name, n in prof["device_calls"].items():
        kind = ("memsets" if name.startswith("Memset") else
                "copies" if name.startswith("Memcpy") else "kernels")
        out[kind] += n
    return out


def having_topk_cases(c, hosts: int, hours: int, reps: int, prof: bool, emit, dev) -> None:
    """K13 `having_mask` and K7 `topk_group_select`, the device half of
    HAVING and ORDER BY / LIMIT, at the main path's shapes: K13 at phase
    3d's case (`having_case(4096 * 16)`, every op) and at the live HAVING
    queries' plan shape (their refs and trees, G = 4096 x 14); K7 keyed at
    groupby-orderby-limit's shape (G = 768, cap 5, an int64 minute key,
    descending) and at the live query's (G = 4096 x 14, cap 10, the f64
    max with NaN as NULL, descending, NULLs first, K13's mask as the
    survivors); K7's compaction at lastpoint's (4096 groups, cap 4096); and
    `TileProgram.device_select` whole at groupby-orderby-limit and the two
    live HAVING queries, as the tile program calls it.  Each time is the
    median of five readings (`ms_range` their range); each output is held
    byte for byte against its plain version."""
    import torch

    from greptimedb_tpu_torch.ops import aggregate as agg
    from greptimedb_tpu_torch.ops.aggregate import HavingRef

    def case(name, fn, outs, plain, **kw):
        got = fn()
        extra = {}
        if prof:
            p = _profiled(fn)
            extra = {**p, **_ops_per_call(p)}
        emit(name, **c._timed_runs(fn, reps), digest=_digest(outs),
             enqueue_us=_enqueue_us(fn, reps),
             plain_bytes=all(c._same_bytes(a, b) for a, b in zip(got, plain)), **kw, **extra)

    # K13 at phase 3d's case
    G = 4096 * 16
    tree, refs, lits, presence = c.having_case(G, dev, c.SEED)
    fn = lambda: (agg.having_mask(tree, refs, lits, presence),)  # noqa: E731
    case("K13 having_case 65536", fn, list(fn()),
         [agg.having_mask_plain(tree, refs, lits, presence)], groups=G)

    # the live HAVING queries' states; K13 at their trees
    h = _smoke_here()
    states = h.select_states(dev)
    G, presence, mu, asys = states
    live_refs = {h.SELECT_MU: HavingRef(values=mu, nan_null=True),
                 h.SELECT_AS: HavingRef(values=asys, nan_null=True),
                 h.SELECT_N: HavingRef(values=presence)}
    masks = {}
    for q, tree in h.HAVING_TREES.items():
        hv = torch.tensor(h.HAVING_LITERALS[q], dtype=torch.float64, device=dev)
        fn = lambda tree=tree, hv=hv: (agg.having_mask(tree, live_refs, hv, presence),)  # noqa: E731
        masks[q] = fn()[0]
        case(f"K13 {q} G={G}", fn, [masks[q]],
             [agg.having_mask_plain(tree, live_refs, hv, presence)], groups=G)

    # K7 keyed at groupby-orderby-limit's shape, as phase 3b holds it
    n_min = hours * 60
    Gm = 768
    surv = torch.arange(Gm, device=dev) < n_min - 30
    keys = [(torch.arange(Gm, dtype=torch.int64, device=dev), None, False, True)]
    fn = lambda: agg.topk_group_select(surv, keys, 5)  # noqa: E731
    case("K7 keyed G=768 cap=5", fn, list(fn()), agg.topk_group_select_plain(surv, keys, 5),
         groups=Gm, library_ms=c._timed(lambda: torch.topk(keys[0][0], 5), reps))

    # K7 keyed at the live query's shape: the f64 max, NaN as NULL
    lkeys = [(mu, torch.isnan(mu), False, True)]
    m = masks["having-or-orderby-limit"]
    fn = lambda: agg.topk_group_select(m, lkeys, 10)  # noqa: E731
    case(f"K7 keyed G={G} cap=10", fn, list(fn()), agg.topk_group_select_plain(m, lkeys, 10),
         groups=G, library_ms=c._timed(lambda: torch.topk(mu, 10), reps))

    # K7's compaction at lastpoint's shape
    card = 1 << (max(hosts, 1) - 1).bit_length()
    surv_l = torch.arange(card, device=dev) < hosts
    fn = lambda: agg.topk_group_select(surv_l, [], card)  # noqa: E731
    case(f"K7 compact G={card} cap={card}", fn, list(fn()),
         agg.topk_group_select_plain(surv_l, [], card), groups=card,
         library_ms=c._timed(lambda: torch.nonzero(surv_l), reps))

    # device_select whole, as TileProgram.final calls it
    for q in h.SELECT_QUERIES:
        prog, args, (mask, pkeys, cap) = h.select_inputs(q, dev, states)
        fn = lambda prog=prog, args=args: prog.device_select(*args)  # noqa: E731
        case(f"device_select {q}", fn, list(fn()), agg.topk_group_select_plain(mask, pkeys, cap),
             groups=int(mask.shape[0]), cap=cap)


def patch_udd_cases(c, hosts: int, hours: int, sketch_hours: int, reps: int, prof: bool,
                    emit, dev) -> None:
    """K16 on phase 3d's planes and K21 (with K20 beside it) on phase 9's
    rows; see the module's docstring."""
    import numpy as np
    import torch

    from greptimedb_tpu_torch.ops import permute as perm
    from greptimedb_tpu_torch.ops import sketch as sk
    from greptimedb_tpu_torch.ops.tiles import pad_rows
    from greptimedb_tpu_torch.parallel.tile_planes import TILE_CHUNK_ROWS

    def case(name, fn, outs, plain, **kw):
        extra = {}
        if prof:
            p = _profiled(fn)
            extra = {**p, **_ops_per_call(p)}
        emit(name, **c._timed_runs(fn, reps), digest=_digest(outs),
             enqueue_us=_enqueue_us(fn, reps),
             plain_bytes=all(c._same_bytes(a, b) for a, b in zip(outs, plain)), **kw, **extra)

    # K16: phase 3d's entry and the live phase's delta
    n, codes, ts, valid, vals = c.tsbs_planes(hosts, hours, 1, dev)
    npad = pad_rows(n)
    planes = {"f64": c._chunked(c._padded(vals[0], npad, 0.0), TILE_CHUNK_ROWS),
              "int32": c._chunked(c._padded(codes, npad, 0), TILE_CHUNK_ROWS),
              "bool": c._chunked(c._padded(valid, npad, False), TILE_CHUNK_ROWS)}
    del codes, ts, valid, vals
    n_delta = c.LIVE_MINUTES * 6 * (hosts + c.LIVE_NEW_HOSTS)
    new_pad = pad_rows(n + n_delta)
    g = torch.Generator(device=dev).manual_seed(c.SEED)
    deltas = {"f64": torch.rand(n_delta, generator=g, dtype=torch.float64, device=dev)}
    deltas["bool"] = torch.rand(n_delta, generator=g, device=dev) < 0.5
    deltas["int32"] = torch.randint(0, 1 << 30, (n_delta,), generator=g, dtype=torch.int32,
                                    device=dev)
    spread = torch.sort(torch.randint(0, n + 1, (n_delta,), generator=g, device=dev)).values
    positions = {"interleaved": spread.to(torch.int32),
                 "front": torch.zeros(n_delta, dtype=torch.int32, device=dev),
                 "back": torch.full((n_delta,), n, dtype=torch.int32, device=dev)}
    shapes = [(name, "interleaved") for name in planes] + [("f64", "front"), ("f64", "back")]
    for name, where in shapes:
        args = (planes[name], n, deltas[name], positions[where], new_pad, TILE_CHUNK_ROWS)
        fn = lambda args=args: perm.delta_patch(*args)  # noqa: E731
        esize = planes[name][0].element_size()
        # old rows read, the delta and its positions read, the new plane written
        b, _by = c.bound(n * esize + n_delta * (esize + 4) + new_pad * esize, 0)
        case(f"K16 {name} {where}", fn, fn(), perm.delta_patch_plain(*args), rows=new_pad,
             delta_rows=n_delta, bound_ms=b)
    del planes, deltas, positions, spread
    torch.cuda.empty_cache()

    # K21 (and K20) at phase 9's rows
    import pyarrow as pa

    user = c.tsbs_columns(c.Tsbs(hosts, sketch_hours), ("usage_user",))["usage_user"]
    rows = user.shape[0]
    ticks = rows // hosts

    def up(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    host = up(np.repeat(np.arange(hosts, dtype=np.int32), ticks))
    hour = up(np.tile((np.arange(ticks) * c.SCRAPE_S // 3600).astype(np.int32), hosts))
    mask_np = np.ones(rows, dtype=bool)
    mask_np[::100] = False
    mask = up(mask_np)
    bid = {b: up(sk.udd_bucket_ids(user, c.UDD_GAMMA, b)) for b in (128, 1024)}
    zeros = torch.zeros(rows, dtype=torch.int32, device=dev)
    ones = torch.ones(rows, dtype=torch.bool, device=dev)
    udd_path = getattr(sk, "last_udd_path", lambda: None)
    udd = {
        "K21 host B=128": (bid[128], host, mask, hosts, 128),
        "K21 host B=1024": (bid[1024], host, mask, hosts, 1024),
        "K21 hour B=1024": (bid[1024], hour, mask, sketch_hours, 1024),
        "K21 one bucket": (zeros, zeros, ones, 1, 128),
    }
    for name, args in udd.items():
        fn = lambda args=args: (sk.segment_udd(*args),)  # noqa: E731
        got = fn()
        torch.cuda.synchronize()
        path = udd_path()
        b, _by = c._sketch_bound("udd", rows, args[-2] * args[-1])
        case(name, fn, list(got), [sk.segment_udd_plain(*args)], rows=rows, path=path,
             bound_ms=b, library_ms=c._timed(c._library_call("udd", args, dev), reps))
        del got
        torch.cuda.empty_cache()
    cut = [(s * hosts // c.SHARDS) * ticks for s in range(c.SHARDS + 1)]

    def two_step():
        counts = None
        for lo, hi in zip(cut[:-1], cut[1:]):
            part = sk.segment_udd(bid[1024][lo:hi], host[lo:hi], mask[lo:hi], hosts, 1024)
            counts = part if counts is None else counts + part
        return (counts,)

    case("K21 two-step B=1024 (4 shards)", two_step, list(two_step()),
         [sk.segment_udd_plain(*udd["K21 host B=1024"])], rows=rows, shards=c.SHARDS)
    del bid, udd
    torch.cuda.empty_cache()

    hashes = sk.hash64(pa.array(user))
    inputs = {p: [up(x) for x in sk.hll_inputs(hashes, p)] for p in (12, 14)}
    hll = {
        "K20 host p=12": (*inputs[12], host, hosts, 1 << 12),
        "K20 hour p=12": (*inputs[12], hour, sketch_hours, 1 << 12),
        "K20 host p=14": (*inputs[14], host, hosts, 1 << 14),
        "K20 one register": (zeros, inputs[12][1], zeros, 1, 1 << 12),
    }
    for name, args in hll.items():
        fn = lambda args=args: (sk.segment_hll(*args),)  # noqa: E731
        got = fn()
        torch.cuda.synchronize()
        b, _by = c._sketch_bound("hll", rows, args[-2] * args[-1])
        case(name, fn, list(got), [sk.segment_hll_plain(*args)], rows=rows,
             path=sk.last_hll_path(), bound_ms=b,
             library_ms=c._timed(c._library_call("hll", args, dev), reps))
        del got
        torch.cuda.empty_cache()


def tql_cases(c, hosts: int, hours: int, emit) -> None:
    """T2, T3 and T5 through TQL EVAL on the warm tile route (p50 of 3)."""
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as home:
        out = c.run_tql_slice("cuda", hosts, hours, 3, home)
    for name in ("T2", "T3", "T5"):
        q = out["queries"][name]
        emit(f"{name} tile warm", q["warm_p50_ms"], None,
             dispatch_ms=q["warm_stage_p50_ms"].get("dispatch"),
             stage_ms=q["warm_stage_p50_ms"])


def worker(root: str, kset: str, hosts: int, hours: int, sketch_hours: int, reps: int,
           tql: bool, prof: bool) -> None:
    sys.path.insert(0, root)
    sys.modules.setdefault("jax", None)
    import chip_smoke as c
    from greptimedb_tpu_torch.kernels import build_all

    build_all(SOURCES[kset] + {"blocked": ("mask_gids", "quantize_limbs",
                                           "segment_reduce_scatter", "segment_sort"),
                               "fold": ("mask_gids", "hash_group_slots"),
                               "pack_scatter": ("mask_gids", "segment_sort", "topk_select",
                                                "hash_group_slots"),
                               "strip_hash": ("mask_gids",),
                               "gather_last": ("mask_gids", "segment_reduce_blocked",
                                               "ts_argsort")}.get(kset, ()))

    def emit(case, ms, digest, **kw):
        print(json.dumps({"case": case, "ms": ms, "bytes": digest, **kw}), flush=True)

    import torch

    dev = torch.device("cuda", 0)
    if kset == "blocked":
        blocked_cases(c, hosts, hours, reps, prof, emit, dev)
    elif kset == "fold":
        fold_cases(c, reps, prof, emit, dev)
    elif kset == "pack_scatter":
        pack_scatter_cases(c, hosts, hours, reps, prof, emit, dev)
    elif kset == "strip_hash":
        strip_hash_cases(c, hosts, hours, reps, prof, emit, dev)
    elif kset == "gather_last":
        gather_last_cases(c, hosts, hours, reps, prof, emit, dev)
    elif kset == "mask_topk":
        mask_topk_cases(c, hosts, hours, reps, prof, emit, dev)
    elif kset == "having_topk":
        having_topk_cases(c, hosts, hours, reps, prof, emit, dev)
    elif kset == "patch_udd":
        patch_udd_cases(c, hosts, hours, sketch_hours, reps, prof, emit, dev)
    else:
        range_hll_cases(c, hosts, hours, sketch_hours, reps, prof, emit)
    if tql:
        tql_cases(c, hosts, hours, emit)


def resource_usage(root: str, kset: str) -> dict:
    """{source: nvcc --resource-usage output} of the set's sources in root."""
    from greptimedb_tpu_torch.kernels._build import NVCC_FLAGS, nvcc_path

    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    out = {}
    for name in SOURCES[kset]:
        src = os.path.join(root, "greptimedb_tpu_torch", "csrc", f"{name}.cu")
        proc = subprocess.run([nvcc_path(), *flags, "--resource-usage", "-c", "-o", os.devnull, src],
                              capture_output=True, text=True)
        out[name] = (proc.stdout + proc.stderr).strip()
    return out


def sass_counts(root: str, label: str, out_dir: str, name: str = "mask_gids") -> dict:
    """{kernel: (SASS instructions, CALL.REL.NOINC count)} of csrc/<name>.cu
    in root (`cuobjdump -sass` of its cubin); the listing itself goes to
    out_dir/sass_<label>_<name>.txt."""
    import re

    from greptimedb_tpu_torch.kernels._build import NVCC_FLAGS, nvcc_path

    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    src = os.path.join(root, "greptimedb_tpu_torch", "csrc", f"{name}.cu")
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, f"{name}.cubin")
        subprocess.run([nvcc_path(), *flags, "-cubin", "-o", cubin, src], check=True,
                       capture_output=True, text=True)
        cuobjdump = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
        sass = subprocess.run([cuobjdump, "-sass", cubin], check=True, capture_output=True,
                              text=True).stdout
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"sass_{label}_{name}.txt"), "w") as f:
        f.write(sass)
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = [0, 0]
        elif fn is not None and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            counts[fn][0] += 1
            counts[fn][1] += "CALL.REL.NOINC" in line
    return {k: tuple(v) for k, v in counts.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="the other checkout (the root of its tree)")
    ap.add_argument("--set", dest="kset", choices=sorted(SOURCES), default="blocked")
    ap.add_argument("--hosts", type=int, default=4000)
    ap.add_argument("--hours", type=int, default=12)
    ap.add_argument("--sketch-hours", type=int, default=12)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--tql", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "kernel_ab"),
                    help="where --set mask_topk, having_topk and patch_udd write their SASS "
                         "listings")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker, args.kset, args.hosts, args.hours, args.sketch_hours, args.reps,
               args.tql, args.profile)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    sys.path.insert(0, ROOT)
    other = os.path.abspath(args.other)
    turns = [("other", other), ("this", ROOT), ("this", ROOT), ("other", other)]
    for label, root in turns[:2]:
        print(json.dumps({"tree": label, "resource_usage": resource_usage(root, args.kset)}),
              flush=True)
        if args.kset in SASS_SOURCES:
            for name in SASS_SOURCES[args.kset]:
                print(json.dumps({"tree": label, "source": name,
                                  "sass": sass_counts(root, label, args.out, name)}), flush=True)
    ms: dict[str, dict[str, list]] = {}
    digests: dict[str, set] = {}
    for i, (label, root) in enumerate(turns):
        # T2, T3 and T5 once per checkout: the TQL slice ingests 34.56 M rows
        tql = args.tql and i in (1, 3)
        cmd = [sys.executable, os.path.abspath(__file__), "--worker", root, "--set", args.kset,
               "--hosts", str(args.hosts), "--hours", str(args.hours),
               "--sketch-hours", str(args.sketch_hours), "--reps", str(args.reps)]
        cmd += ["--profile"] if args.profile else []
        t0 = time.perf_counter()
        proc = subprocess.run(cmd + (["--tql"] if tql else []), capture_output=True, text=True,
                              cwd=root)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        for line in proc.stdout.splitlines():
            if not line.startswith('{"case"'):
                continue
            rec = json.loads(line)
            print(json.dumps({"turn": i, "tree": label, **rec}), flush=True)
            ms.setdefault(rec["case"], {}).setdefault(label, []).append(rec["ms"])
            if rec["bytes"] is not None:
                digests.setdefault(rec["case"], set()).add(rec["bytes"])
        print(json.dumps({"turn": i, "tree": label, "seconds": time.perf_counter() - t0}),
              flush=True)
    print(json.dumps({
        "ms": {case: {label: sum(v) / len(v) for label, v in per.items()}
               for case, per in ms.items()},
        "same_bytes": {case: len(d) == 1 for case, d in digests.items()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
