#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (greptimedb_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--hours 12] [--hosts 4000] [--reps 1] [--tile-reps 5] [--tql-reps 5]
                          [--prom-sql-reps 3]
                          [--container-hours 6] [--container-reps 3] [--tick-reps 5]
                          [--vector-rows 1000000] [--vector-reps 2]
                          [--sketch-hours 6] [--sketch-reps 0]
                          [--mesh-hours 6] [--mesh-reps 2]

Phases, each printing one JSON line:

1. device  — requires a CUDA device; prints the card's name and power
             limit as `nvidia-smi --query-gpu=name,power.limit` gives them.
2. build   — builds the twenty-two kernel sources of csrc/ for sm_90a (one
             nvcc each, all started together).
3. kernels — runs K1-K8 against their plain torch versions on the card, at
             the main path's shapes (TSBS cpu-only, 4000 hosts x 12 h =
             17.28 M rows, C = 1, 5 and 10, span 16, G = 4096 x 12; the
             groupby-orderby-limit and lastpoint selections) and on edge
             cases (shuffled ids, NULLs, +-inf/NaN, all-masked blocks, ts
             ties, a ragged tail; block maxima at powers of two +-1 ulp,
             half-way values, mixed magnitudes; +-0/NaN/null sort keys;
             subnormal and NaN f64 words; K1 at every interval sign,
             |interval| past 2^32 and the int64 ends of ts and the origin,
             n from 1 to one past a thread's rows and a CTA's tile, views
             at odd rows); every kernel runs twice and must give
             byte-identical results; times kernel, plain version and the
             nearest single PyTorch call with CUDA events.  K1 is also
             timed at the tile path's two chunk shapes, as the tile program
             calls it (`lits` a view of the run's uploaded literals) and
             with the table uploaded each call (`_upload`).
4. slice   — TSBS cpu-only at --hosts x --hours (10 s scrape, 10 metrics),
             written through the port's Database at its storage defaults
             with the WAL on, flushed to Parquet, then the 15 TSBS
             queries through Database.sql on the table-fed path (tile
             cache off): once cold and --reps times warm.  Each result is
             held against the port's CPU (Arrow) backend — keys, counts,
             min, max, last exactly; sum/avg within rel 1e-12 — and
             double-groupby-1 also against a numpy ground truth built
             during ingest.  Per query it asserts that the lowered-query
             counter advanced and that every kernel of the query's path
             (EXPECTED_PATH) launched.
5. tile    — the same 15 queries on the tile path (device-resident
             super-tiles) over the same region: once cold (plane build,
             upload, time-major permutation and copies, K5 quantize split
             out) and --tile-reps times warm (p50 per stage).  The nine
             bucket-only queries take time-major plans (the first one's
             cold run launches K14 and K15, warm runs neither).  Every run
             must advance `tile_dispatches` and leave `tile_declined`
             alone, launch the kernels of EXPECTED_TILE_PATH, and match
             phase 4's CPU-backend result (sum/avg within rel 1e-7, the
             limb verdict's bound).  Edge queries: more ORDER BY keys
             than K7 takes, a bucket-only avg/sum (limbs over the
             time-major copies), and a minute-bucket query with the
             time_major pass off (K2's guard fails, K3 on the tile path).
5d. host_routes — the tile path's host routing ladder at the defaults
             but the fused build (`cost_route`, `host_fast_path`,
             `cold_host_serve`'s legacy ladder: `fused_build` named in
             query.disabled_passes; every other phase but 5e names all four
             there, `HOST_ROUTES`, so its kernel asserts, launch counts and
             cold timings read the card's path) on phase 4's data, in fresh
             Databases over the same data home (cold entries): the 15
             queries once cold (each query's route from its pass trace,
             its launches, host ms and the device bytes it added: a host
             route launches nothing and uploads nothing), the cold-served
             ones again (the card), then --tile-reps warm runs each (the
             eight pk-equality queries host-served, cpu-max-all-8 on the
             card once its planes are warm; each host-served p50 beside
             phase 5's tile p50); then, in another fresh Database with
             `tpu_min_rows` just above single-groupby-1-1-1's estimate,
             that query on the CPU executor, `Database.prewarm()` (K5 over
             the non-null numeric fields: none, TSBS's DOUBLE fields are
             nullable), double-groupby-1 on the card with
             no cold serve and no build, and single-groupby-1-1-1 back on
             the tile path.  Every result against phase 4's CPU backend
             (within rel 1e-7), double-groupby-1 also against the ground
             truth.
5e. fused_ladder — the fused family build and the cold serve's fused
             ladder at the defaults, on phase 4's data in fresh Databases:
             the 15 queries once cold in FUSED_COLD_ORDER (each on its
             FUSED_COLD_ROUTES host route from its pass trace: the eight
             pk-equality queries and cpu-max-all-8, served as `wide_cold`
             and scheduling its family's build, on the host fast path; the
             six others fused cold serves, lastpoint included; no upload or
             dispatch stage on the query's thread), the builder drained (its
             union builds, manifests, regions, one file decode a SST, no
             failure, the kernels it launched: K5, K14 and K15 among them),
             --tile-reps warm runs each (pk-equality on the host, the seven
             others on the card with no build and no byte added, each
             launching EXPECTED_TILE_PATH but K5; p50 beside phases 5 and
             5d), then `Database.prewarm()` host-only (no device byte, no
             launch) and double-groupby-1 as a fused cold serve.  Every
             result against phase 4's CPU backend (rel 1e-7),
             double-groupby-1 also against the ground truth.  Its TQL step
             runs after phase 6b on phase 6's tables (a fresh Database at
             the defaults): T2 over the last hour at '15s' answered by the
             legacy scan on its first touch, then after the drain by the
             tile route (K9-K12), both against phase 6's legacy result
             (rel 1e-12).
5c. tick   — on phase 5's resident region: the 15 queries as the
             dashboard tick (`batch.window_ms` 120, `max_members` 16; 15
             threads released by one barrier): --tick-reps ticks, then
             --tick-reps with every window one bucket later and the host
             literals changed.  Each tick is one tick program (B19: one
             CUDA graph replay, one readback; `batch_fused_dispatches` and
             `tick_graph_replays` +1) serving all 15 members, each result
             byte-identical to the query's solo run; the first tick captures
             the graph, the slid ticks capture none.  Then a result-cache
             re-hit that launches nothing.  Prints per tick the wall time net
             of the window, replay, readback and per-member decode ms, and
             the capture ms and the graph's pool bytes; the members run
             once more eagerly under torch's sync debug mode "error" (no host
             read before the readback).
5b. live   — on phase 5's resident region: 30 more minutes for the 4000
             hosts and 96 new ones (737,280 rows through Database.write,
             WAL on, flushed; the new names move the host codes).  The
             next query must extend the cached entry in place
             (`delta_extends` +1, `builds` +0, K15 remap and K16); then
             the 15 queries with their windows moved to the new end and
             two HAVING queries (consumed on the card: K13), cold and
             warm, against the CPU backend; then the extended entry's
             planes, order and sorted host copies against a from-scratch
             rebuild of the same files, byte for byte, with the delta's
             host and device ms and the rebuild's ms.
   3d (plane kernels) — K13-K16 against their plain versions at the main
             path's shapes (K14 over the 17.28 M-row entry's ts, K15
             gathers of an f64, an int32 and a bool plane by it and the
             host-code remap of the live append, K16 merging its 737,280
             rows at the front, the back and interleaved, K13 at G = 4096
             x 16 with every op, NULL and NaN), K14-K16 byte for byte and
             K13 exactly, and on edge cases (K14 spans either side of 2^32,
             INT64_MIN/MAX, no valid row, no row; K16 over chunks of a
             tile, one chunk and 5000 rows, a delta run across a tile
             bound), twice each; K14 timed again on the same rows with each
             ts moved by 0-9999 ms; K16 timed on the f64 (interleaved,
             front, back), int32 and bool planes.
   3c (TQL kernels) — K9-K12 against their plain versions at the TQL main
             path's shapes (17.28 M rows in two chunks, S_pad 4096, W_pad
             1024, k = 8 and 64, NaN values, NULLs, invalid rows) and on
             edge cases (two tags, matcher masks, ns/us units with an
             offset, odd chunk lengths, several regions; K10's slices at
             k = 64, a 1 s step, a 1 h step over 10 s scrapes and a series
             wholly before the first step; K9's series with no, one, many
             resets and one on every row, resets at lanes 0 and 31, just
             after unfetched rows across a group's and a window's edge, NaN
             and +-inf either side of a reset, byte for byte at four chunk
             lengths), twice each.  K9's call runs its three kernels (the
             layout's identities, the row prologue, the strip) and one
             copy (its chunk-pointer table).
6. tql     — two Prometheus metrics (a gauge and a counter with restarts,
             GreptimeDB's remote-write layout, not append_mode) at --hosts x
             --hours, flushed, a remote-write retry overlapping the last
             SST; the dashboard T1-T7 through `TQL EVAL` on the warm tile
             path over the whole load at '60s' (one cold run with plane
             build, upload and dedup keep plane split out, --tql-reps warm
             runs; each query must launch EXPECTED_TQL_PATH); the same
             queries over the last hour at '15s' on the legacy path
             (tql.tile off: K9-K11) held against the tile path; T1 of a
             few hosts against a numpy twin; the legacy hour again on the
             CPU backend (plain versions), held against the card.
6b. prom_sql — on phase 6's database, before its CPU-backend run: SQL
             panels over the two remote-write tables on the tile path (P1
             per host and minute over the last hour: the keep plane and a
             window tile; P2 per host and hour over 12 h: the keep plane
             on the full planes, the window tile declined on cover; P3 per
             5 minutes over 12 h: a time-major plan over the keep plane's
             copy; P4 each host's last value under the keep plane; P5 the
             gauge's top 10 hosts by the last hour's average: a window
             tile, K7), once cold and --prom-sql-reps warm, each on the
             tile route with its passes (`dedup_plane`, `window_tile`,
             from a pass trace) and EXPECTED_PROM_SQL_PATH's kernels,
             equal to a numpy ground truth from the generator's samples
             (keys, counts, max, last exact; avg within rel 1e-7).  Then
             P1b (P1 two hours earlier) builds a second window tile, a
             corrected remote write (hosts = 3 mod 16, the last 10
             minutes, + 0.5) is flushed, and P1, P1b, P3, P4 run again:
             the entry extended in place (K16), P1's window tile rebuilt,
             P1b's kept, P4 showing the new values.  P1 and P5 with both
             passes off (and P5 with the tile cache off) give the same
             rows on the table-fed route; the corrected rows are then
             written back as they were.
   3f (guards on the card) — K2 and K6 behind their layout guards with
             no host read (both branches launched, each predicated on the
             guard's word) at 17.28 M rows and C = 10, the guard passing
             (host x hour) and failing (minute buckets): byte for byte
             against the host-driven form and K6 against its plain version
             run on the host (K2 within rel 1e-12), twice, the three timed;
             the falling-bases shape (hour alone over 16 h of hosts, the
             guard passing with bases that fall at each host): K6 and K4
             byte for byte against their plain versions, K2 within rel
             1e-12, and no library sort kernel (cub, Radix, DeviceSort) in a
             profiled K2, K4 or K6 call; K18 (the flag-reading sort of the
             K3 branch, radix.cuh's one-sweep sort) against torch.sort, and
             its edge cases (n and G at every plan boundary, all masked, one
             id, a shut gate, one graph capture replayed twice).
   3e (hash kernels) — at H1's shape (phase 7: 5.76 M rows in (namespace,
             pod, container, ts) order, 2^24 slots): K1's int64 ids, K17
             `hash_group_slots`, K18 alone and K3 over the slot ids, each byte for byte
             against its plain version and twice; K17's time includes the
             refill of its table, which is one cooperative launch a call
             beside the caller's refill; K17 edge cases, rounds held too
             (threaded sources, masked rows, overflow, shared home
             positions, ids 0 and 2^62 - 1, 2^62 - 1 and 2^62 - 2 contending
             for one empty position, ten-row runs of one id across warp
             boundaries, a 2^24 table threaded from an earlier source), K1
             int64 past 2^31, K8's overflow byte.
7. containers — the hash group-by (agg_strategy auto) on a high-cardinality
             table: per-container memory from cAdvisor as kube-prometheus
             scrapes it (container_memory_working_set_bytes, Prometheus
             remote-write layout, append_mode): 100 namespaces x 40 pods x 2
             containers = 8000 series, 30 s scrape over --container-hours
             (5.76 M rows at 6 h) through Database.write, flushed.  H1 the
             per-container 5-minute panel (hash), H2 one namespace over the
             last hour (hash), H3 per-pod count and peak (sort; and forced
             hash, which must give the same bytes), H4 the top 10 container
             5-minute peaks (hash; Sort/LIMIT replay on the host): cold and
             --container-reps warm on the tile path, each against the CPU
             backend (avg within rel 1e-7: f32 rows for G >= 2^14), the
             strategy asserted from `stats`, the hash queries launching K1,
             K17, K3 and K8 and none of K2, K5, K6.  Then a forced-hash query
             whose 4096-slot table overflows: `agg_hash_overflow` +1, the
             table-fed path answers, against the CPU backend.
   7c (hash tick) — H1-H4 as one tick (H3 sort, the others hash, K17's
             probe rounds on the card inside the graph), each byte-identical
             to its solo run.
8. vectors — K19 `topk_distances` against its plain version on the card
             at the slice's shape (ANN-Benchmarks' sift-128-euclidean:
             1,000,000 x 128, integer values in [0, 255] from the seed,
             one row in 1,000 a copy of an earlier one), k = 10, 100 and
             1000, every metric and both orders, byte for byte and twice;
             on uniform real data within the sums' rounding bound; edge
             cases (the NaN rules, signed zeros, d = 1/3/128/1024, N = 1,
             all rows invalid, k past the valid rows, k above the
             one-block sort, tie-heavy rows at 6,000 and 200,003 with k = N
             among the ks); every call launches the kernels and memsets
             `topk_launch_plan` gives, at most 5 at k <= 2048 (the slice's
             queries too).  Timed: K19, the plain version, torch.mv +
             torch.topk.  Then the slice: the table `sift (ts TIMESTAMP
             TIME INDEX, id BIGINT, emb VECTOR(128))` (default mode)
             written through Database.write and flushed, five queries
             (l2sq LIMIT 10 and 100, cos LIMIT 10, dot DESC LIMIT 10, l2sq
             LIMIT 10 OFFSET 5) cold and --vector-reps warm, each against
             a numpy ground truth (exact for l2sq and dot), K19 launched
             once per run; per stage: region scan, decode_matrix, upload,
             rank (K19 + readback), take.  Then a small append-mode VECTOR
             INDEX table: the per-SST IVF route answers
             (INDEX_VECTOR_APPLIED moves).
9. sketches — K20 `segment_hll` and K21 `segment_udd` against their plain
             versions on the card, byte for byte and twice, over the TSBS
             rows (--hosts x --sketch-hours, in (hostname, ts) order):
             K20 over hll_inputs(hash64(usage_user)) by host at p = 12 and
             14 and by hour, K21 over udd_bucket_ids(usage_user) at B = 128
             and 1024 by host and 1024 by hour, one row in 100 masked;
             timed beside the plain version and the library call
             (`scatter_reduce_` amax / `index_add_` over the flat ids), each
             call's path (ordered or atomic, decided on the card) checked
             and printed beside each time;
             K20's registers equal the host `hll_build_grouped`.  The main path: the rows as 4 host-range
             shards, K20/K21 per shard folded in shard order (torch.maximum,
             +), equal to the single pass; the estimates against the seed
             data.  Edge cases (the int32 wrap, out-of-range gids, rho <= 0,
             masked rows, G = 1, N = 0, every row on one register / bucket,
             G * width past 2^31; K20's paths: sorted gids with empty
             groups, a decreasing gid at a tile's first row, m at the
             shared-memory budget and above it, long runs over helper
             blocks; K21's: masked rows and a masked bucket of B, an
             unmasked bucket of B or -1, a decreasing gid, a gid of G,
             windows of several groups, long runs).  Then the slice: the TSBS table through
             Database.write (WAL on), flushed, and S1-S5 (active hosts per
             hour, per-host p99, per-host HLL states, the table's hosts and
             median, the hourly states stored in a BINARY table and merged)
             through Database.sql, cold and --sketch-reps warm, each declined
             to the CPU executor (as in the reference) and held to the
             reference test's bars (hll_count within 5 %, uddsketch_calc
             within 10 % of the seed data's answer); S3's states are K20's
             registers and S5's merged state is S4's, byte for byte.
10. mesh — multi-device tile execution (`tile.mesh_devices`) on the one
             card, one JSON line per step.  (a) K22 `fold_states` against
             its plain version, byte for byte and twice: dense, 8 sources
             over double-groupby-all's state shape (48,000 groups x 10
             columns: sums, counts, min, max, LAST), the table-fed rule
             too; keyed, 4 slot tables of 2^24 slots built by K17 from H1's
             ids of the container cell, unioned by K17, inverted and
             folded; edge cases (NaN, +-inf, +-0.0, ts ties, empty sources,
             dummies, the trailing row); timed beside the plain version and
             the library calls (sum/amin/amax over the stacked states,
             index_add_ for keyed).  (b) at the end of run_slice, on phase
             5's resident region: the 15 TSBS queries (bench.py's
             MULTICHIP_QUERIES among them) at mesh_devices 1 against 0, byte
             for byte, each mesh run advancing `mesh_dispatches` and K22;
             p50 of both.  (c) the TSBS table as PARTITION BY HASH
             (hostname) PARTITIONS 4 (--hosts x --mesh-hours) in a
             Database over ["cuda:0"] * 4: MULTICHIP_QUERIES, lastpoint and
             groupby-orderby-limit (device finalize on and off) at
             mesh_devices 0, 1 and 4, byte for byte, under agg_strategy
             sort, hash and auto; the table-fed route over the 4 slots
             against the CPU backend; a TQL sum(rate(...)) over a 4-region
             counter at mesh_devices 4 against 0.
11. the kernels line (B19's row `tick_program`: its launches are the
   replays of phase 5c, its bound its members' traffic; K22's its
   launches on 10b and 10c; K10's launches also per k on the TQL routes,
   K2's and K3's per column count C on the tile path; K9's and K17's
   calls, launches a call and kernels a launch from 6's tile run and 7's
   H1-H4, the kernels as their entry points count them; every kernel's
   launches on 6b as `prom_sql_launches`, on 5d as `host_routes_launches`,
   on 5e as `fused_ladder_launches` — of them the builder's, first touch to
   drain, as `fused_builder_launches` — and on 5e's TQL step after its
   drain as `tql_first_touch_launches`),
   then the last line
   {"ok": true, "device":
   {...}}.

The launch counts are set to 0 just before phases 4, 5, 5d, 5e, 5c, 5b, 6's tile
and legacy runs, 6b's panels (through the corrected write's reruns), 7's H1-H4, 7c, 8's queries, 9's two-step path and 9's
queries (which launch nothing), 10b, and 10c's tile, table-fed and TQL
runs, and read just after each
(a graph replay launches the kernels it captured without calling their
wrappers: phase 5c's and 7c's counts are those of the capture).  It imports neither jax nor the reference package
(greptimedb_tpu).  It exits non-zero, printing no result, when no CUDA
device is present or when it runs outside a checkout of the repository.
"""

from __future__ import annotations

import argparse
import functools
import itertools
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# ---- the TSBS cpu-only workload (the repository's bench.py query builder) ----

SCRAPE_S = 10
T0 = 1_767_225_600_000  # 2026-01-01 UTC, epoch ms
METRICS = [
    "usage_user", "usage_system", "usage_idle", "usage_nice", "usage_iowait",
    "usage_irq", "usage_softirq", "usage_steal", "usage_guest", "usage_guest_nice",
]
SEED = 7
H3600 = 3600_000


class Tsbs:
    """Windows, hosts and the 15 queries of the TSBS cpu-only family."""

    def __init__(self, n_hosts: int, hours: int, n_metrics: int = len(METRICS),
                 end: int | None = None):
        self.n_hosts, self.hours = n_hosts, hours
        self.metrics = METRICS[:n_metrics]
        # the queries' windows end here (the end of the load by default)
        self.end = T0 + hours * H3600 if end is None else end
        self.w12 = (self.end - 12 * H3600, self.end)
        self.w8 = (self.end - 8 * H3600, self.end)
        self.w1 = (self.end - H3600, self.end)
        self.host1 = f"host_{703 % n_hosts}"
        self.hosts8 = [f"host_{i % n_hosts}" for i in (703, 1217, 2048, 99, 3777, 1500, 2901, 42)]

    def _q(self, window, metrics_n, hosts=None, bucket="1h", funcs="max"):
        lo, hi = window
        cols = ", ".join(f"{funcs}({m}) AS {funcs}_{m}" for m in self.metrics[:metrics_n])
        where = f"ts >= {lo} AND ts < {hi}"
        if hosts is not None:
            where += (
                f" AND hostname = '{hosts}'"
                if isinstance(hosts, str)
                else f" AND hostname IN ({', '.join(repr(h) for h in hosts)})"
            )
        group = "tb" if hosts is not None else "hostname, tb"
        sel_host = "" if hosts is not None else "hostname, "
        return (
            f"SELECT {sel_host}time_bucket('{bucket}', ts) AS tb, {cols} "
            f"FROM cpu WHERE {where} GROUP BY {group}"
        )

    def queries(self) -> list[tuple[str, str]]:
        q, w12, w8, w1 = self._q, self.w12, self.w8, self.w1
        h1, h8 = self.host1, self.hosts8
        return [
            ("double-groupby-1", q(w12, 1, funcs="avg")),
            ("double-groupby-5", q(w12, 5, funcs="avg")),
            ("double-groupby-all", q(w12, 10, funcs="avg")),
            ("cpu-max-all-1", q(w8, 10, hosts=h1)),
            ("cpu-max-all-8", q(w8, 10, hosts=h8)),
            ("single-groupby-1-1-1", q(w1, 1, hosts=h1, bucket="1m")),
            ("single-groupby-1-1-12", q(w12, 1, hosts=h1, bucket="1m")),
            ("single-groupby-1-8-1", q(w1, 1, hosts=h8, bucket="1m")),
            ("single-groupby-5-1-1", q(w1, 5, hosts=h1, bucket="1m")),
            ("single-groupby-5-1-12", q(w12, 5, hosts=h1, bucket="1m")),
            ("single-groupby-5-8-1", q(w1, 5, hosts=h8, bucket="1m")),
            (
                "groupby-orderby-limit",
                f"SELECT time_bucket('1m', ts) AS minute, max(usage_user) AS mu FROM cpu "
                f"WHERE ts < {self.end - 1800_000} GROUP BY minute ORDER BY minute DESC LIMIT 5",
            ),
            (
                "lastpoint",
                "SELECT hostname, last_value(usage_user) AS last_user FROM cpu GROUP BY hostname",
            ),
            (
                "high-cpu-all",
                f"SELECT count(*) AS n, max(usage_user) AS m FROM cpu "
                f"WHERE usage_user > 90.0 AND ts >= {w12[0]} AND ts < {w12[1]}",
            ),
            (
                "high-cpu-1",
                f"SELECT count(*) AS n, max(usage_user) AS m FROM cpu "
                f"WHERE usage_user > 90.0 AND hostname = '{h1}' "
                f"AND ts >= {w12[0]} AND ts < {w12[1]}",
            ),
        ]


# The kernels each query's path launches at the default size (4000 hosts x
# 12 h) and the storage defaults: the region scan merges its SSTs into
# (hostname, ts) order, so K2's guard passes for host-major groups; minute
# buckets over whole hosts fail it (K3 reruns); scans under 2^16 rows go
# straight to K3.
_BLOCKED, _SCATTER, _LAST = "segment_reduce_blocked", "segment_reduce_scatter", "segment_last"
_MASK = "mask_gids"
_SORT = "segment_sort"
TILE_KERNELS = ("quantize_limbs", "limb_segment_sums", "topk_select", "pack_result")
EXPECTED_PATH = {
    "double-groupby-1": {_BLOCKED},
    "double-groupby-5": {_BLOCKED},
    "double-groupby-all": {_BLOCKED},
    "cpu-max-all-1": {_SCATTER},
    "cpu-max-all-8": {_SCATTER},
    "single-groupby-1-1-1": {_SCATTER},
    "single-groupby-1-1-12": {_SCATTER},
    "single-groupby-1-8-1": {_SCATTER},
    "single-groupby-5-1-1": {_SCATTER},
    "single-groupby-5-1-12": {_SCATTER},
    "single-groupby-5-8-1": {_SCATTER},
    "groupby-orderby-limit": {_BLOCKED, _SCATTER},
    "lastpoint": {_BLOCKED, _LAST},
    "high-cpu-all": {_BLOCKED},
    "high-cpu-1": {_SCATTER},
}


# The kernels each query launches on the tile path at the default size,
# reasoned from the planes' layout and checked on the card: one region,
# one super-tile of 17.28 M rows in (hostname, ts) order, two chunks of
# at most 2^24 rows.  Host-major hourly groups pass the blocked guard
# (K6 for avg, limb planes quantized by K5 in each double-groupby's cold
# run; K2 for max).  The nine bucket-only queries take time-major plans:
# their planes are ts-ascending copies, whose 4096-row blocks span one or
# two buckets, so K2's guard passes (the first one's cold run sorts the
# permutation, K14, and gathers the copies, K15; warm runs launch
# neither).  ORDER BY + LIMIT and lastpoint's compaction run K7; K8 packs
# every result.
_QUANT, _LIMB, _TOPK, _PACK = TILE_KERNELS
_HAVING, _ARGSORT, _GATHER, _PATCH = PLANE_KERNELS = (
    "having_mask", "ts_argsort", "gather_planes", "delta_patch")
# the main-path phases each of K13-K16 must launch in: the cold time-major
# runs of phase 5 (K14, K15 gathers); the live phase's delta route (K15
# remap, K16), its rebuilt permutation and copies, and its HAVING (K13)
PLANE_PHASES = {
    _HAVING: ("live",), _ARGSORT: ("tile", "live"), _GATHER: ("tile", "live"), _PATCH: ("live",),
}
TIME_MAJOR = (
    "cpu-max-all-1", "cpu-max-all-8", "single-groupby-1-1-1", "single-groupby-1-1-12",
    "single-groupby-1-8-1", "single-groupby-5-1-1", "single-groupby-5-1-12",
    "single-groupby-5-8-1", "groupby-orderby-limit",
)
EXPECTED_TILE_PATH = {
    "double-groupby-1": {_QUANT, _LIMB, _PACK},
    "double-groupby-5": {_QUANT, _LIMB, _PACK},
    "double-groupby-all": {_QUANT, _LIMB, _PACK},
    "cpu-max-all-1": {_BLOCKED, _PACK},
    "cpu-max-all-8": {_BLOCKED, _PACK},
    "single-groupby-1-1-1": {_BLOCKED, _PACK},
    "single-groupby-1-1-12": {_BLOCKED, _PACK},
    "single-groupby-1-8-1": {_BLOCKED, _PACK},
    "single-groupby-5-1-1": {_BLOCKED, _PACK},
    "single-groupby-5-1-12": {_BLOCKED, _PACK},
    "single-groupby-5-8-1": {_BLOCKED, _PACK},
    "groupby-orderby-limit": {_BLOCKED, _TOPK, _PACK},
    "lastpoint": {_BLOCKED, _LAST, _TOPK, _PACK},
    "high-cpu-all": {_BLOCKED, _PACK},
    "high-cpu-1": {_BLOCKED, _PACK},
}


# The tile path's host routes (parallel/tile_host.py, the engine's cost
# route) and the fused family build, whose background builder launches
# kernels beside the query's.  Every phase but 5d and 5e names them in
# query.disabled_passes: its kernel asserts, launch counts and cold timings
# read the card's path.  Phase 5d names `fused_build` alone (the legacy
# ladder, LEGACY_LADDER); 5e runs at the defaults.
HOST_ROUTES = ("cost_route", "host_fast_path", "cold_host_serve", "fused_build")
LEGACY_LADDER = ("fused_build",)
# the TSBS queries with a pk equality and no group tag: host-served by the
# host fast path, cold or warm (a slice of 360-4,320 rows)
PK_EQUALITY = (
    "cpu-max-all-1", "single-groupby-1-1-1", "single-groupby-1-1-12", "single-groupby-1-8-1",
    "single-groupby-5-1-1", "single-groupby-5-1-12", "single-groupby-5-8-1", "high-cpu-1",
)
# each query's route on phase 5d's cold pass, in the queries' order: the
# first grouped query is cold-served (once per entry), the next ones build
# the planes; cpu-max-all-8's 8 x 2,880 rows x 10 columns pass
# _HOST_PATH_MAX_CELLS, so it takes the card once its planes are warm
COLD_ROUTES = {"double-groupby-1": "cold_host_serve",
               **{name: "host_fast_path" for name in PK_EQUALITY}}
WARM_ROUTES = {name: "host_fast_path" for name in PK_EQUALITY}
# phase 5e's cold pass under the fused build (the reference's decisions on
# the same queries, tests/test_torch_fused_build.py): the pk-equality
# queries first, so no family build has warmed a plane before
# cpu-max-all-8 runs (its slice is host-served while its planes are cold,
# `wide_cold`, and schedules its family's build); then the six other
# families' first touches, each a fused cold serve (lastpoint included)
FUSED_COLD_ORDER = (
    "cpu-max-all-1", "cpu-max-all-8", "single-groupby-1-1-1", "single-groupby-1-1-12",
    "single-groupby-1-8-1", "single-groupby-5-1-1", "single-groupby-5-1-12",
    "single-groupby-5-8-1", "high-cpu-1", "double-groupby-1", "double-groupby-5",
    "double-groupby-all", "groupby-orderby-limit", "lastpoint", "high-cpu-all",
)
FUSED_COLD_ROUTES = {name: "host_fast_path" if name in PK_EQUALITY + ("cpu-max-all-8",)
                     else "cold_host_serve" for name in FUSED_COLD_ORDER}


def device_route_config(disabled=HOST_ROUTES):
    """A Config whose lowered queries take the card: the host routes and
    the fused build off (`disabled`: the passes to name)."""
    from greptimedb_tpu_torch.utils.config import Config

    cfg = Config()
    cfg.query.disabled_passes = tuple(disabled)
    return cfg


def emit(obj: dict) -> None:
    print(json.dumps(obj, separators=(",", ":")), flush=True)


# ---- kernel registry ----------------------------------------------------------

def kernel_table():
    """name -> (wrapper with .launches, source, reference kernel it replaces).
    K1-K4 serve the table-fed path and the tile path, K5-K8 the tile path,
    K9-K12 TQL (K9-K11 on both of its routes, K12 on the tile route),
    K13-K16 the tile path's HAVING and plane maintenance, K17 its hash
    group-by, K18 the stable sort of K3's ids (behind the guards, read
    from the card's verdict), K19 the vector search's distance + top-k,
    K20/K21 the device builds of the HLL and UDDSketch states, K22 the
    mesh fold of partial states."""
    from greptimedb_tpu_torch.ops import aggregate as agg
    from greptimedb_tpu_torch.ops import filter as flt
    from greptimedb_tpu_torch.ops import permute as perm
    from greptimedb_tpu_torch.ops import rate
    from greptimedb_tpu_torch.ops import sketch as sk
    from greptimedb_tpu_torch.ops import vector as vec

    src = "greptimedb_tpu_torch/csrc/"
    return {
        "mask_gids": (flt.mask_gids, src + "mask_gids.cu",
                      "greptimedb_tpu/parallel/executor.py:207"),
        "segment_reduce_blocked": (agg.segment_reduce_blocked, src + "segment_reduce_blocked.cu",
                                   "greptimedb_tpu/ops/aggregate.py:642"),
        "segment_reduce_scatter": (agg.segment_reduce_scatter, src + "segment_reduce_scatter.cu",
                                   "greptimedb_tpu/ops/aggregate.py:598"),
        "segment_last": (agg.segment_last, src + "segment_last.cu",
                         "greptimedb_tpu/ops/aggregate.py:792"),
        "quantize_limbs": (agg.quantize_limbs, src + "quantize_limbs.cu",
                           "greptimedb_tpu/ops/aggregate.py:259"),
        "limb_segment_sums": (agg.limb_segment_sums, src + "limb_segment_sums.cu",
                              "greptimedb_tpu/ops/aggregate.py:291"),
        "topk_select": (agg.topk_group_select, src + "topk_select.cu",
                        "greptimedb_tpu/ops/aggregate.py:1031"),
        "pack_result": (agg.pack_result, src + "pack_result.cu",
                        "greptimedb_tpu/parallel/tile_cache.py:3119"),
        "strip_counter_resets": (rate.strip_counter_resets, src + "strip_counter_resets.cu",
                                 "greptimedb_tpu/ops/rate.py:46"),
        "range_windows": (rate.range_windows, src + "range_windows.cu",
                          "greptimedb_tpu/ops/rate.py:145"),
        "range_finalize": (rate.range_finalize, src + "range_finalize.cu",
                           "greptimedb_tpu/ops/rate.py:263"),
        "series_fold": (rate.series_fold, src + "series_fold.cu",
                        "greptimedb_tpu/query/promql/tile_exec.py:180"),
        "having_mask": (agg.having_mask, src + "having_mask.cu",
                        "greptimedb_tpu/ops/aggregate.py:1076"),
        "ts_argsort": (perm.ts_argsort, src + "ts_argsort.cu",
                       "greptimedb_tpu/parallel/tile_cache.py:2680"),
        "gather_planes": (perm.gather_planes, src + "gather_planes.cu",
                          "greptimedb_tpu/parallel/tile_cache.py:2193"),
        "delta_patch": (perm.delta_patch, src + "delta_patch.cu",
                        "greptimedb_tpu/parallel/tile_cache.py:292"),
        "hash_group_slots": (agg.hash_group_slots, src + "hash_group_slots.cu",
                             "greptimedb_tpu/ops/aggregate.py:118"),
        "segment_sort": (agg.sort_segments, src + "segment_sort.cu",
                         "greptimedb_tpu/ops/aggregate.py:598"),
        "topk_distances": (vec.topk_distances, src + "topk_distances.cu",
                           "greptimedb_tpu/ops/vector.py:25"),
        "segment_hll": (sk.segment_hll, src + "segment_hll.cu",
                        "greptimedb_tpu/ops/sketch.py:185"),
        "segment_udd": (sk.segment_udd, src + "segment_udd.cu",
                        "greptimedb_tpu/ops/sketch.py:403"),
        "fold_states": (agg.fold_states, src + "fold_states.cu",
                        "greptimedb_tpu/ops/aggregate.py:1007"),
    }


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, (fn, _s, _r) in kernel_table().items()}


def reset_counts() -> None:
    for fn, _s, _r in kernel_table().values():
        fn.launches = 0
    kernel_table()["fold_states"][0].merges = 0
    SHAPES.clear()
    K22_PLANNED.update(planned=0, made=0)
    K8_PLANNED.update(calls=0, planned=0, made=0)
    K15_PLANNED.update(calls=0, planned=0, made=0, planes=0, builds=0)
    for name in ENTRY_KERNELS:
        kernel_table()[name][0].calls = 0
        ENTRY_KERNELS[name] = 0


def _rows_bucket(n: int) -> str:
    """n rounded up to a power of two, as "2^k"."""
    return f"2^{max(int(n) - 1, 0).bit_length()}"


def _k7_shape(a) -> str | None:
    """K7's calls by their G: a call's first launch (the one over every
    group) counts, a merge launch does not."""
    return None if a.cand else f"G<={_rows_bucket(a.num_groups)}"


# Launches per shape of the kernels whose time depends on it: (kernel, C
# entry point) -> the shape of one launch, from its argument struct.  Each
# wrapper launches that entry point once a call (K2 and K6 once per 32 and
# 16 columns; K22 once a merge, or as its launch plan splits it; K12 per
# form: tw = 0 the cell form; K13 once a call, by G; K7 its calls, by G).
SHAPED = {
    ("mask_gids", "gt_mask_gids"): lambda a: f"rows<={_rows_bucket(a.n)}",
    ("segment_reduce_blocked", "gt_blocked_partials"): lambda a: f"C={a.n_cols}",
    ("segment_reduce_scatter", "gt_scatter_reduce"): lambda a: f"C={a.n_cols}",
    ("limb_segment_sums", "gt_limb_partials"): lambda a: f"C={a.n_cols}",
    ("range_windows", "gt_range_windows"): lambda a: f"k={a.k}",
    ("fold_states", "gt_fold_states"): lambda a: (f"sources={a.m} keys={a.n_keys} "
                                                  f"rows<={_rows_bucket(a.total_rows)}"),
    ("series_fold", "gt_series_fold"): lambda a: f"tw={a.tw}",
    ("segment_sort", "gt_segment_sort"): lambda a: f"rows<={_rows_bucket(a.n)}",
    ("having_mask", "gt_having_mask"): lambda a: f"G<={_rows_bucket(a.num_groups)}",
    **{("topk_select", entry): _k7_shape
       for entry in ("gt_topk_select", "gt_topk_round", "gt_topk_compact")},
}
SHAPES: dict[str, int] = {}
# The arguments of each SHAPED entry point's last launch, and K22's
# launches against the launches its plan makes for the same merges.
LAST_ARGS: dict = {}
K22_PLANNED = {"planned": 0, "made": 0}
# K8's calls and their launches, made and planned (`pack_launch_plan`:
# one a call up to 64 rows), since the counts were last set to 0
K8_PLANNED = {"calls": 0, "planned": 0, "made": 0}
# K15's multi-plane gather calls, their launches made and planned
# (`gather_launch_plan`: one a call up to the descriptor's pointers), the
# planes they moved, and the time-major builds that gathered (each must
# make exactly one call), since the counts were last set to 0
K15_PLANNED = {"calls": 0, "planned": 0, "made": 0, "planes": 0, "builds": 0}
# K9's and K17's kernel launches since the counts were last set to 0, as
# their entry points count them where they launch (the `kernels` field of
# their argument structs; K9 launches the layout's identities, the row
# prologue and the strip, K17 one cooperative kernel)
ENTRY_KERNELS = {"strip_counter_resets": 0, "hash_group_slots": 0}
_K22_FIELDS = ("sums", "counts", "mins", "maxs", "last_ts", "last_val")


def k12_last_launch() -> dict:
    """K12's form, tw and CTAs as its last launch's arguments give them
    (the grid as csrc/series_fold.cu's gt_series_fold computes it)."""
    a = LAST_ARGS["series_fold"]
    grid = (a.n_groups * -(-a.n_steps // a.tw) if a.tw
            else -(-(a.n_groups * a.n_steps) // 256))
    return {"form": "staged" if a.tw else "cells", "tw": int(a.tw), "grid": int(grid)}


def count_shapes() -> None:
    """Count the launches of SHAPED's entry points by shape (K2/K3/K6 per
    column count C, K10 per k, K22 per sources and rows, K18 per rows) from
    here on: a wrapper around the port's one launch function, which every
    wrapper looks up when it is called, and around K1's own (`flt._launch`:
    K1 takes its entry point once, in its cached layout).  Each K22 merge must launch as
    often as `fold_launch_plan` says for it, and each K8 call as its
    layout's launch plan says: wrappers around the merge and around K8's
    launches count both and fail where they differ."""
    from greptimedb_tpu_torch.kernels import _build
    from greptimedb_tpu_torch.ops import aggregate as agg

    launch = _build.launch
    if getattr(launch, "counts_shapes", False):
        return

    def counted_shape(name, fn, args):
        shape = SHAPED.get((name, fn))
        if shape is not None:
            what = shape(args)
            if what is not None:
                key = f"{name} {what}"
                SHAPES[key] = SHAPES.get(key, 0) + 1
            LAST_ARGS[name] = args

    def counted(name, fn, args, stream):
        counted_shape(name, fn, args)
        launch(name, fn, args, stream)
        if name in ENTRY_KERNELS:
            ENTRY_KERNELS[name] += args.kernels

    fold_on_card = agg._fold_on_card
    plans = functools.lru_cache(maxsize=256)(
        lambda keys, m, n_order: len(agg.fold_launch_plan(keys, m, n_order)))

    def merge(dev, didx, items, m, n_local, order, *rest):
        planned = plans(tuple((key, tuple(f for f in _K22_FIELDS if f in per))
                              for key, per, _k in items), m, len(order))
        l0 = agg.fold_states.launches
        out = fold_on_card(dev, didx, items, m, n_local, order, *rest)
        made = agg.fold_states.launches - l0
        if made != planned:
            raise AssertionError(f"K22 merge of {len(items)} keys x {m} sources: {made} "
                                 f"launches, its plan makes {planned}")
        K22_PLANNED["planned"] += planned
        K22_PLANNED["made"] += made
        return out

    pack_on_card = agg._pack_on_card

    def pack(layout, *rest):
        l0 = agg.pack_result.launches
        pack_on_card(layout, *rest)
        made = agg.pack_result.launches - l0
        if made != len(layout.launches):
            raise AssertionError(f"K8 call of {len(layout.rows)} rows: {made} launches, its "
                                 f"plan makes {len(layout.launches)}")
        K8_PLANNED["calls"] += 1
        K8_PLANNED["planned"] += len(layout.launches)
        K8_PLANNED["made"] += made

    from greptimedb_tpu_torch.ops import permute as perm
    from greptimedb_tpu_torch.parallel import tile_planes

    gather_on_card = perm._gather_on_card

    def gather(planes, outs, index, dev):
        planned = len(perm.gather_launch_plan(len(planes), len(planes[0])))
        l0 = perm.gather_planes.launches
        gather_on_card(planes, outs, index, dev)
        made = perm.gather_planes.launches - l0
        if made != planned:
            raise AssertionError(f"K15 gather of {len(planes)} planes: {made} launches, its "
                                 f"plan makes {planned}")
        K15_PLANNED["calls"] += 1
        K15_PLANNED["planned"] += planned
        K15_PLANNED["made"] += made
        K15_PLANNED["planes"] += len(planes)

    ensure_time_major = tile_planes.TileCacheManager.ensure_time_major

    def time_major(self, *args, **kw):
        c0 = K15_PLANNED["calls"]
        out = ensure_time_major(self, *args, **kw)
        if K15_PLANNED["calls"] - c0 > 1:
            raise AssertionError(f"a time-major build made {K15_PLANNED['calls'] - c0} K15 "
                                 "gather calls, not one")
        K15_PLANNED["builds"] += K15_PLANNED["calls"] - c0
        return out

    from greptimedb_tpu_torch.ops import filter as flt

    k1_launch = flt._launch

    def k1(fn, args, stream):  # K1 launches through its own entry, fn taken once
        counted_shape("mask_gids", "gt_mask_gids", args)
        k1_launch(fn, args, stream)

    launch_cached = agg._launch_cached

    def cached(name, fn, args, stream):  # K7 and K13: entry points taken once
        counted_shape(name, fn.__name__, args)
        launch_cached(name, fn, args, stream)

    counted.counts_shapes = True
    _build.launch = counted
    flt._launch = k1
    agg._launch_cached = cached
    agg._fold_on_card = merge
    agg._pack_on_card = pack
    perm._gather_on_card = gather
    tile_planes.TileCacheManager.ensure_time_major = time_major


def shape_counts() -> dict[str, int]:
    return dict(sorted(SHAPES.items()))


def call_counts(name: str) -> dict[str, int]:
    """K9's or K17's calls on the card, their wrapper's launches and the
    kernels their entry point launched, since the counts were last set to 0."""
    return {"calls": kernel_table()[name][0].calls, "launches": kernel_table()[name][0].launches,
            "kernels": ENTRY_KERNELS[name]}


def per_call(counts: dict[str, int], kernels: tuple, what: str) -> dict:
    """The kernels line's per-call figures of K9 or K17 on its main path:
    the calls, the wrapper's launches a call and the entry point's kernel
    launches a launch.  Fails unless every launch ran each of `kernels`
    once."""
    if counts["launches"] == 0 or counts["kernels"] != len(kernels) * counts["launches"]:
        raise AssertionError(f"{what} on its main path: {counts}, each launch runs {kernels}")
    return {"calls": counts["calls"], "launches_per_call": counts["launches"] / counts["calls"],
            "kernels_per_call": counts["kernels"] / counts["launches"]}


def _summed(*shape_dicts) -> dict[str, int]:
    """Launches per shape over several runs' shape_counts() records."""
    out: dict[str, int] = {}
    for d in shape_dicts:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v
    return dict(sorted(out.items()))


def by_shape(shapes: dict[str, int], name: str) -> dict[str, int]:
    """{shape: launches} of kernel `name` in a shape_counts() record."""
    pre = name + " "
    return {k[len(pre):]: v for k, v in shapes.items() if k.startswith(pre)}


# ---- phase 3: kernels against their plain versions ------------------------------

# H100 SXM data sheet: the HBM rate, and the peak of float32 arithmetic
# outside the tensor cores, where the kernels' compares, selects and adds
# run
HBM_BYTES_PER_S = 3.35e12
PLAIN_OPS_PER_S = 67e12


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    """(least ms the card could take, what bounds it): the larger of the
    bytes over the memory rate and the operations over the peak rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PLAIN_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _timed(fn, reps: int) -> float:
    """Mean ms of fn() over reps launches, after one warm-up, CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _timed_runs(fn, reps: int, runs: int = 5) -> dict:
    """`_timed` read `runs` times: the median ms and the range, for a call
    whose mean moves between readings (a host-bound wrapper)."""
    got = sorted(_timed(fn, reps) for _ in range(runs))
    return {"ms": got[len(got) // 2], "ms_range": [got[0], got[-1]]}


def _enqueue_us(fn, reps: int) -> float:
    """Host µs per fn() call with no sync between calls: where it passes
    the CUDA-event time, back-to-back calls wait on the host."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def _k1_figures(chunks: dict, launches: dict, form: str | None = None) -> dict:
    """K1's tile-path figures from its chunk shapes ({key: timed}) and its
    launches at each ({key: n}): launches x (ms - bound ms), and that split
    into launches x (device ms - bound ms), the kernel's part, and
    launches x (ms - device ms), the host's.  `form` "upload" reads each
    chunk's `lits=None` timing (names suffixed `_upload`); else the tile
    program's form."""
    total = kernel = 0.0
    for k, v in launches.items():
        if k not in chunks:
            continue
        c = chunks[k] if form is None else chunks[k][form]
        dev_ms = sum(c["device_us"].values()) / 1e3
        total += v * (c["ms"] - c["bound_ms"])
        kernel += v * (dev_ms - c["bound_ms"])
    sfx = "" if form is None else f"_{form}"
    return {f"tile_chunk_figure{sfx}": total, f"tile_chunk_kernel_figure{sfx}": kernel,
            f"tile_chunk_host_figure{sfx}": total - kernel}


def _same_bytes(a, b) -> bool:
    import torch

    if a is None or b is None:
        return a is b
    a, b = a.contiguous().reshape(-1), b.contiguous().reshape(-1)  # 0-dim counts too
    return bool(torch.equal(a.view(torch.uint8) if a.dtype != torch.bool else a,
                            b.view(torch.uint8) if b.dtype != torch.bool else b))


def _state_tensors(st) -> list:
    return [getattr(st, k) for k in ("sums", "counts", "mins", "maxs", "last_ts", "last_val")]


def _compare(kernel_out, plain_out, exact: bool, what: str) -> float:
    """Max abs difference of finite entries; NaN/inf positions must agree;
    exact outputs must be equal, sums within rel 1e-12."""
    import torch

    k, p = kernel_out, plain_out
    if k.shape != p.shape:
        raise AssertionError(f"{what}: shape {tuple(k.shape)} != {tuple(p.shape)}")
    if not k.is_floating_point():
        if not torch.equal(k, p):
            bad = int((k != p).sum())
            raise AssertionError(f"{what}: {bad} entries differ")
        return 0.0
    if not torch.equal(torch.isnan(k), torch.isnan(p)):
        raise AssertionError(f"{what}: NaN positions differ")
    inf = torch.isinf(p)
    if not torch.equal(torch.isinf(k), inf) or not torch.equal(k[inf], p[inf]):
        raise AssertionError(f"{what}: infinite entries differ")
    fin = torch.isfinite(p)
    diff = (k[fin] - p[fin]).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if exact:
        if err != 0.0:
            raise AssertionError(f"{what}: max abs err {err}, expected exact")
    else:
        tol = 1e-12 * p[fin].abs().clamp(min=1.0)
        if diff.numel() and bool((diff > tol).any()):
            raise AssertionError(f"{what}: max abs err {err} beyond rel 1e-12")
    return err


def _check_state(k_st, p_st, what: str) -> float:
    err = 0.0
    for name, a, b in zip(("sums", "counts", "mins", "maxs", "last_ts", "last_val"),
                          _state_tensors(k_st), _state_tensors(p_st)):
        if (a is None) != (b is None):
            raise AssertionError(f"{what}.{name}: present in one result only")
        if a is not None:
            err = max(err, _compare(a, b, exact=(name != "sums"), what=f"{what}.{name}"))
    return err


# Seconds of the checks that hold K3 against its order emulation (in
# phases 3 and 3e and the edge cases), of run_pack_scatter_edge_cases, of
# K9's edge series (run_strip_edge_series) and of K17's edge cases
CHECK_S = {"k3_order_emulation_s": 0.0, "pack_scatter_edge_cases_s": 0.0,
           "k9_edge_series_s": 0.0, "k17_edge_cases_s": 0.0}


def _same_as_lanes(k_st, lanes_fn, what: str) -> None:
    """K3's outputs against `segment_reduce_scatter_lanes` (its add order
    in torch ops; lanes_fn() computes it) byte for byte, signed zeros
    included; a NaN only as a NaN (torch's own adds on the card may give it
    another payload)."""
    t0 = time.perf_counter()
    try:
        _same_bytes_as_lanes(k_st, lanes_fn(), what)
    finally:
        CHECK_S["k3_order_emulation_s"] += time.perf_counter() - t0


def _same_bytes_as_lanes(k_st, lanes, what: str) -> None:
    import torch

    for name in ("sums", "counts", "mins", "maxs"):
        a, b = getattr(k_st, name), getattr(lanes, name)
        if (a is None) != (b is None):
            raise AssertionError(f"{what}.{name}: present in one result only")
        if a is None:
            continue
        if a.is_floating_point():
            nan_a, nan_b = torch.isnan(a), torch.isnan(b)
            if not torch.equal(nan_a, nan_b):
                raise AssertionError(f"{what}.{name}: NaN positions differ from K3's order")
            a, b = torch.where(nan_a, 0.0, a), torch.where(nan_b, 0.0, b)
        if not _same_bytes(a, b):
            bad = int((a.reshape(-1).view(torch.uint8) != b.reshape(-1).view(torch.uint8)).sum())
            raise AssertionError(f"{what}.{name}: {bad} bytes differ from K3's order emulation")


def _moved(x, dev):
    """x with every tensor in it (lists, tuples, AggStates) moved to dev."""
    import dataclasses

    import torch

    if torch.is_tensor(x):
        return x.to(dev)
    if isinstance(x, (list, tuple)):
        return type(x)(_moved(y, dev) for y in x)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: _moved(getattr(x, f.name), dev)
                                         for f in dataclasses.fields(x)})
    return x


def _plain_on_host(fn, *args):
    """fn (a plain version) over host copies of args, its tensors moved back
    to the card.  The card's index_add_ adds in another order on every run,
    and a reference that changes between runs cannot hold a signed sum that
    cancels to near zero within rel 1e-12; the host adds in row order."""
    import torch

    dev = torch.device("cuda", 0)
    return _moved(fn(*_moved(args, torch.device("cpu"))), dev)


def _passed(verdict) -> bool:
    """A K2 call's guard verdict on the host: the plain version returns a
    bool, the kernel its int32 [1] word on the card (0 = passed)."""
    return verdict if isinstance(verdict, bool) else int(verdict.item()) == 0


def _twice_identical(fn, what: str):
    import torch

    a = fn()
    b = fn()
    torch.cuda.synchronize()
    flat_a = a if isinstance(a, (tuple, list)) else (a,)
    flat_b = b if isinstance(b, (tuple, list)) else (b,)
    for x, y in zip(flat_a, flat_b):
        xs = _state_tensors(x) if hasattr(x, "sums") else [x]
        ys = _state_tensors(y) if hasattr(y, "sums") else [y]
        for u, v in zip(xs, ys):
            if torch.is_tensor(u) and not _same_bytes(u, v):
                raise AssertionError(f"{what}: two runs differ in their bytes")
    return a


def tsbs_planes(n_hosts: int, hours: int, n_cols: int, dev, seed: int = SEED):
    """Device planes laid out as the (hostname, ts) sorted region scan of
    TSBS cpu-only: host codes, ts, valid, n_cols uniform [0, 100) columns."""
    import torch

    ticks = hours * 3600 // SCRAPE_S
    n = n_hosts * ticks
    g = torch.Generator(device=dev).manual_seed(seed)
    codes = torch.arange(n_hosts, dtype=torch.int32, device=dev).repeat_interleave(ticks)
    ts = T0 + torch.arange(ticks, dtype=torch.int64, device=dev).repeat(n_hosts) * (SCRAPE_S * 1000)
    vals = [torch.rand(n, generator=g, dtype=torch.float64, device=dev) * 100.0 for _ in range(n_cols)]
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    return n, codes, ts, valid, vals


def run_kernel_phase(n_hosts: int, hours: int, reps: int) -> dict:
    """Phase 3: every kernel against its plain version, timed.  Returns
    name -> metrics for the kernels line (launches filled in later)."""
    import torch

    from greptimedb_tpu_torch.ops import aggregate as agg
    from greptimedb_tpu_torch.ops import filter as flt

    dev = torch.device("cuda", 0)
    n, codes, ts, valid, vals = tsbs_planes(n_hosts, hours, 10, dev)
    card = 1 << (max(n_hosts, 1) - 1).bit_length()
    n_buckets = hours
    G = card * n_buckets
    lo, hi = T0, T0 + hours * H3600
    out: dict[str, dict] = {}

    # K1 at the double-groupby shape: ts range filter, hostname x 1h bucket
    k1_args = (valid, [(ts, ">=", lo), (ts, "<", hi)], [], [(codes, card)],
               (ts, T0, H3600, n_buckets), G - 1)
    gids, mask = _twice_identical(lambda: flt.mask_gids(*k1_args), "mask_gids")
    pg, pm = flt.mask_gids_plain(*k1_args)
    err = max(_compare(gids, pg, True, "mask_gids.gids"), _compare(mask, pm, True, "mask_gids.mask"))
    # reads valid, ts, codes once; writes gids and mask; per row 2
    # compares, a floor division and 2 mixed-radix steps (~8 operations)
    k1_bound, k1_by = bound(n * (1 + 8 + 4) + n * (4 + 1), n * 8)
    ops = _device_ops(lambda: flt.mask_gids(*k1_args), calls=3)
    out["mask_gids"] = dict(
        max_abs_err=err,
        **_timed_runs(lambda: flt.mask_gids(*k1_args), reps),
        plain_ms=_timed(lambda: flt.mask_gids_plain(*k1_args), max(reps // 2, 1)),
        bound_ms=k1_bound, bound_by=k1_by, library_ms=None,
        enqueue_us=_enqueue_us(lambda: flt.mask_gids(*k1_args), reps),
        device_us={_kernel_name(k): us / c for k, (us, c) in ops.items() if c},
    )

    # K2 at C = 1, 5 and 10 (the tile path's widths) over the K1 output; K3
    # on the same inputs
    # (the scatter path of a failing guard); one index_add_ as the library
    # yardstick of the sums.
    stats = {}
    for C in (1, 5, 10):
        cols, masks = vals[:C], [mask] * C
        aggs = ("count", "max", "min", "sum")
        ok, k_st, _b = _twice_identical(
            lambda: agg.segment_reduce_blocked(cols, gids, masks, mask, G, aggs), f"blocked C={C}")
        assert _passed(ok), "the TSBS layout must pass the blocked guard"
        _okp, p_st, _bp = agg.segment_reduce_blocked_plain(cols, gids, masks, mask, G, aggs)
        e2 = _check_state(k_st, p_st, f"segment_reduce_blocked C={C}")
        order = agg.sort_segments(gids, mask, G)
        s_st = _twice_identical(
            lambda: agg.segment_reduce_scatter(cols, gids, masks, mask, G, aggs, order), f"scatter C={C}")
        e3 = _check_state(s_st, agg.segment_reduce_scatter_plain(cols, gids, masks, mask, G, aggs),
                          f"segment_reduce_scatter C={C}")
        _same_as_lanes(s_st, lambda: agg.segment_reduce_scatter_lanes(cols, masks, mask, order, G,
                                                                      aggs),
                       f"segment_reduce_scatter C={C}")
        stacked = torch.stack(cols, dim=1)
        safe = torch.where(mask, gids, G).to(torch.int64)
        lib = _timed(lambda: torch.zeros((G + 1, C), dtype=torch.float64, device=dev)
                     .index_add_(0, safe, stacked), reps)
        del stacked
        # ids, mask, C value columns read once; [C, G] states written once;
        # one operation per row, column and aggregate
        kb, kby = bound(n * (4 + 1 + 8 * C) + C * G * (8 + 4 + 8 + 8), n * C * len(aggs))
        stats[C] = dict(
            blocked=dict(
                max_abs_err=e2,
                ms=_timed(lambda: agg.segment_reduce_blocked(cols, gids, masks, mask, G, aggs), reps),
                plain_ms=_timed(lambda: agg.segment_reduce_blocked_plain(cols, gids, masks, mask, G, aggs), 1),
                bound_ms=kb, bound_by=kby, library_ms=lib,
            ),
            scatter=dict(
                max_abs_err=e3,
                ms=_timed(lambda: agg.segment_reduce_scatter(cols, gids, masks, mask, G, aggs), reps),
                # without its K18 sort: on a precomputed order
                alone_ms=_timed(lambda: agg.segment_reduce_scatter(cols, gids, masks, mask, G, aggs,
                                                                   order), reps),
                plain_ms=_timed(lambda: agg.segment_reduce_scatter_plain(cols, gids, masks, mask, G, aggs), 1),
                bound_ms=kb, bound_by=kby, library_ms=lib,
            ),
        )
    out["segment_reduce_blocked"] = dict(stats[10]["blocked"], c1=stats[1]["blocked"],
                                         c5=stats[5]["blocked"])
    out["segment_reduce_scatter"] = dict(stats[10]["scatter"], c1=stats[1]["scatter"],
                                         c5=stats[5]["scatter"])

    # groupby-orderby-limit's shape: 1-minute buckets over the host-major
    # layout fail K2's guard, and K3 reruns; what the failed K2 call
    # (guard pass + verdict sync) adds to that query's device time
    n_min = hours * 60
    gm, mm = flt.mask_gids(valid, [(ts, "<", hi - 1800_000)], [], [], (ts, T0, 60_000, n_min), n_min - 1)
    ok, _st, _b = agg.segment_reduce_blocked(vals[:1], gm, [mm], mm, n_min, ("max",))
    assert not _passed(ok), "minute buckets over the host-major layout must fail the blocked guard"
    nb = -(-n // 4096)
    # the failing guard reads ids and base mask once and writes the bases;
    # a min and a max compare per row
    gf_bound, gf_by = bound(n * (4 + 1) + nb * 4, n * 2)
    # K3 on the same inputs: ids, mask and values read once, [G] maxima
    # written; one compare per row; scatter_reduce_ is the library call
    sm_bound, sm_by = bound(n * (4 + 1 + 8) + n_min * 8, n)
    safe_m = torch.where(mm, gm, n_min).to(torch.int64)
    # K3 over 720 long runs: its order emulation and the plain version
    order_m = agg.sort_segments(gm, mm, n_min)
    km = _twice_identical(lambda: agg.segment_reduce_scatter(vals[:1], gm, [mm], mm, n_min, ("max",),
                                                             order_m), "scatter minute buckets")
    _check_state(km, agg.segment_reduce_scatter_plain(vals[:1], gm, [mm], mm, n_min, ("max",)),
                 "segment_reduce_scatter minute buckets")
    _same_as_lanes(km, lambda: agg.segment_reduce_scatter_lanes(vals[:1], [mm], mm, order_m, n_min,
                                                                ("max",)),
                   "segment_reduce_scatter minute buckets")
    out["segment_reduce_blocked"]["guard_fail"] = dict(
        ms=_timed(lambda: agg.segment_reduce_blocked(vals[:1], gm, [mm], mm, n_min, ("max",)), reps),
        bound_ms=gf_bound, bound_by=gf_by,
        scatter_ms=_timed(lambda: agg.segment_reduce_scatter(vals[:1], gm, [mm], mm, n_min, ("max",)), reps),
        scatter_alone_ms=_timed(lambda: agg.segment_reduce_scatter(
            vals[:1], gm, [mm], mm, n_min, ("max",), order_m), reps),
        scatter_bound_ms=sm_bound, scatter_bound_by=sm_by,
        scatter_library_ms=_timed(
            lambda: torch.full((n_min + 1,), -np.inf, dtype=torch.float64, device=dev)
            .scatter_reduce_(0, safe_m, vals[0], "amax"), reps),
    )
    del gm, mm, safe_m, order_m, km

    # K4 at the lastpoint shape: group by hostname only
    gl, ml = flt.mask_gids(valid, [], [], [(codes, card)], None, card - 1)
    okl, _st, base = agg.segment_reduce_blocked([vals[0]], gl, [ml], ml, card, ("count",))
    assert _passed(okl), "lastpoint must pass the blocked guard"
    kl = _twice_identical(lambda: agg.segment_last(vals[0], ts, gl, ml, card, base=base), "segment_last")
    pl = agg.segment_last_plain(vals[0], ts, gl, ml, card, base=base)
    e4 = max(_compare(kl[0], pl[0], True, "segment_last.ts"), _compare(kl[1], pl[1], True, "segment_last.val"))
    ks = agg.segment_last(vals[0], ts, gl, ml, card)  # sorted-run form
    e4 = max(e4, _compare(ks[0], pl[0], True, "segment_last sorted.ts"),
             _compare(ks[1], pl[1], True, "segment_last sorted.val"))
    # ids, mask, ts read once, the winners' values gathered; [G] ts and
    # values written; a compare per row for ts and one for the row
    k4_bound, k4_by = bound(n * (4 + 1 + 8) + card * 8 + card * (8 + 8), n * 2)
    out["segment_last"] = dict(
        max_abs_err=e4,
        ms=_timed(lambda: agg.segment_last(vals[0], ts, gl, ml, card, base=base), reps),
        plain_ms=_timed(lambda: agg.segment_last_plain(vals[0], ts, gl, ml, card, base=base), 1),
        bound_ms=k4_bound, bound_by=k4_by, library_ms=None,
    )
    del vals, codes, ts, valid, gids, mask, gl, ml
    torch.cuda.empty_cache()
    run_edge_cases(dev)
    return out


def run_edge_cases(dev) -> None:
    """Shuffled ids, NULLs, +-inf/NaN, all-masked blocks, ts ties and a
    ragged tail: every kernel against its plain version, twice each."""
    import torch

    from greptimedb_tpu_torch.ops import aggregate as agg
    from greptimedb_tpu_torch.ops import filter as flt

    rng = np.random.default_rng(11)
    n = 300_000 + 1234  # not a multiple of 4096
    G = 512
    gid_np = np.sort(rng.integers(0, G, n)).astype(np.int32)
    v_np = rng.uniform(-50, 50, n)
    v_np[rng.choice(n, 40, replace=False)] = np.nan
    v_np[rng.choice(n, 40, replace=False)] = np.inf
    v_np[rng.choice(n, 40, replace=False)] = -np.inf
    ts_np = (T0 + rng.integers(0, 50, n) * 1000).astype(np.int64)  # many ties
    mask_np = rng.random(n) < 0.9
    mask_np[4096 * 3: 4096 * 6] = False  # all-masked blocks
    null_np = rng.random(n) < 0.85
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    gid, v, ts, mask = t(gid_np), t(v_np), t(ts_np), t(mask_np)
    v2 = t(rng.uniform(0, 1, n))
    colmask = mask & t(null_np)
    aggs = ("count", "max", "min", "sum")
    cases = {"clustered": gid, "shuffled": t(rng.permutation(gid_np))}
    for name, g in cases.items():
        # the fold writes the state only where the guard passed
        ok = _passed(agg.segment_reduce_blocked([v, v2], g, [colmask, mask], mask, G, aggs)[0])
        if ok:
            _v, k_st, base = _twice_identical(
                lambda: agg.segment_reduce_blocked([v, v2], g, [colmask, mask], mask, G, aggs),
                f"edge {name} blocked")
        okp, p_st, _ = _plain_on_host(agg.segment_reduce_blocked_plain, [v, v2], g,
                                      [colmask, mask], mask, G, aggs)
        if ok != okp:
            raise AssertionError(f"edge {name}: guard verdicts differ ({ok} vs {okp})")
        if name == "shuffled" and ok:
            raise AssertionError("shuffled ids must fail the blocked guard")
        if ok:
            _check_state(k_st, p_st, f"edge {name} blocked")
            kl = _twice_identical(lambda: agg.segment_last(v, ts, g, colmask, G, base=None), "edge last")
            okc, _s, cbase = agg.segment_reduce_blocked([v], g, [colmask], colmask, G, ("count",))
            kb = agg.segment_last(v, ts, g, colmask, G, base=cbase)
            pb = agg.segment_last_plain(v, ts, g, colmask, G, base=cbase)
            for a, b, w in ((kb[0], pb[0], "ts"), (kb[1], pb[1], "val"), (kl[0], pb[0], "sorted ts"),
                            (kl[1], pb[1], "sorted val")):
                _compare(a, b, True, f"edge {name} last {w}")
        s_st = _twice_identical(
            lambda: agg.segment_reduce_scatter([v, v2], g, [colmask, mask], mask, G, aggs),
            f"edge {name} scatter")
        _check_state(s_st, _plain_on_host(agg.segment_reduce_scatter_plain, [v, v2], g,
                                          [colmask, mask], mask, G, aggs),
                     f"edge {name} scatter")
        kl = _twice_identical(lambda: agg.segment_last(v, ts, g, colmask, G), f"edge {name} last sorted")
        pl = agg.segment_last_plain(v, ts, g, colmask, G)
        _compare(kl[0], pl[0], True, f"edge {name} last ts")
        _compare(kl[1], pl[1], True, f"edge {name} last val")
    # K1: codes with unseen (-1) literals, NaN/inf comparisons, IN-lists,
    # negative ts offsets (floor division), null gates
    codes = t(rng.integers(-1, 40, n).astype(np.int32))
    f_np = rng.uniform(0, 100, n)
    f_np[rng.choice(n, 100, replace=False)] = np.nan
    f_np[rng.choice(n, 100, replace=False)] = np.inf
    f = t(f_np)
    tsn = t((T0 - 7 * H3600 + rng.integers(-10**9, 10**9, n)).astype(np.int64))
    valid = t(np.arange(n) < n - 777)
    gate = t(null_np)
    args = (valid,
            [(f, ">", 90.0), (codes, "in", (3, 5, -1, 39)), (f, "!=", 95.5), (tsn, ">=", T0 - 10**10)],
            [gate], [(codes, 64)], (tsn, T0, 3_600_000, 64), 64 * 64 - 1)
    kg, km = _twice_identical(lambda: flt.mask_gids(*args), "edge mask_gids")
    pg, pm = flt.mask_gids_plain(*args)
    _compare(kg, pg, True, "edge mask_gids gids")
    _compare(km, pm, True, "edge mask_gids mask")
    args_not_in = (valid, [(codes, "not in", (1, 2)), (f, "<=", float("inf"))], [], [], None, 0)
    kg, km = flt.mask_gids(*args_not_in)
    pg, pm = flt.mask_gids_plain(*args_not_in)
    _compare(km, pm, True, "edge mask_gids not in")
    run_mask_gids_edges(dev, rng)


# K1's time bucket divides by a magic reciprocal of the interval: every sign,
# |interval| past 2^32 and the int64 ends
K1_INTERVALS = (1, -1, 2, 7, -7, 60_000, 3_600_000, -3_600_000, 1 << 32, -(1 << 32),
                (1 << 32) + 1, (1 << 62) + 3, -(1 << 63), (1 << 63) - 1)
K1_ORIGINS = (0, T0, -T0, -(1 << 63), (1 << 63) - 1)
# rows a thread of K1 holds (two quads) and a CTA's tile of them
K1_THREAD_ROWS, K1_TILE_ROWS = 8, 256 * 8


def k1_edge_ts(rng, n: int, origin: int, interval: int):
    """int64 timestamps for K1's bucket edges: the int64 ends, a span
    around the origin, and quotients past int32 (they wrap); no row's
    offset is -2^63 where the interval is -1 (an overflow the reference's
    torch op traps on)."""
    i64 = np.iinfo(np.int64)
    ext = np.array([i64.min, i64.min + 1, -1, 0, 1, i64.max - 1, i64.max], np.int64)
    near = np.int64(origin) + rng.integers(-5, 5, n).astype(np.int64) * np.int64(
        min(abs(interval), 1 << 40))
    wide = rng.integers(i64.min, i64.max, n, dtype=np.int64, endpoint=True)
    ts = np.where(rng.random(n) < 0.5, near, wide)
    ts[:min(n, ext.size)] = ext[:min(n, ext.size)]
    if interval == -1:
        wrapped = (origin + int(i64.min) + (1 << 63)) % (1 << 64) - (1 << 63)
        ts[ts == wrapped] += 1
    return ts


def run_mask_gids_edges(dev, rng) -> None:
    """K1 byte for byte against its plain version, both id widths: every
    interval sign, |interval| past 2^32 and the int64 ends of ts and the
    origin; n from 1 to one past a thread's rows and past a CTA's tile;
    views at odd row offsets (the loose rows before the first aligned
    quad); f64, f32, int8 and bool filter planes, an IN-list, a gate and
    three tags."""
    import torch

    from greptimedb_tpu_torch.ops import filter as flt

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    n = 4096 + 13
    valid = t(rng.random(n) < 0.9)
    codes = t(rng.integers(-2, 70, n).astype(np.int32))
    for interval in K1_INTERVALS:
        for origin in K1_ORIGINS:
            ts = t(k1_edge_ts(rng, n, origin, interval))
            for dtype, pad in ((torch.int32, 64 * 1024 - 1), (torch.int64, None)):
                args = (valid, [(ts, ">", origin)], [], [(codes, 64)], (ts, origin, interval, 1024),
                        pad, dtype)
                what = f"edge mask_gids interval {interval} origin {origin} {dtype}"
                kg, km = _twice_identical(lambda: flt.mask_gids(*args), what)
                pg, pm = flt.mask_gids_plain(*args)
                _compare_bytes(kg, pg, what)
                _compare_bytes(km, pm, what + " mask")
    big = 3 * K1_TILE_ROWS + 77
    f64 = rng.uniform(-1, 1, big)
    f64[::97] = np.nan
    planes = dict(valid=rng.random(big) < 0.8, ts=T0 + rng.integers(-10**9, 10**9, big),
                  f64=f64, f32=rng.uniform(-1, 1, big).astype(np.float32),
                  i8=rng.integers(-3, 3, big).astype(np.int8), flag=rng.random(big) < 0.5,
                  gate=rng.random(big) < 0.9, c0=rng.integers(-1, 9, big).astype(np.int32),
                  c1=rng.integers(0, 5, big).astype(np.int32),
                  c2=rng.integers(0, 300, big).astype(np.int32))
    planes = {k: t(v) for k, v in planes.items()}
    sizes = list(range(1, K1_THREAD_ROWS + 2)) + [K1_TILE_ROWS - 1, K1_TILE_ROWS + 1, 2 * K1_TILE_ROWS + 3]
    for off in (0, 1, 2, 3, 5):
        for m in sizes:
            v = {k: p[off:off + m] for k, p in planes.items()}
            # planes taken as they are (the quads start past the loose rows)
            # and with f32 and int8 planes converted (new tensors, out of
            # phase with the views at an odd offset: every row one a thread)
            views = [(v["f64"], "<", 0.5), (v["flag"], "=", True), (v["ts"], "<", T0 + 10**8)]
            converted = views + [(v["f32"], ">=", -0.75), (v["i8"], "in", (-2, 0, 2)),
                                 (v["flag"], "<", 0.5)]  # a bool plane compared in f64
            for (dtype, pad), (form, filters) in itertools.product(
                    ((torch.int32, 8 * 8 * 512 * 4 - 1), (torch.int64, None)),
                    (("views", views), ("converted", converted))):
                args = (v["valid"], filters, [v["gate"]], [(v["c0"], 8), (v["c1"], 8), (v["c2"], 512)],
                        (v["ts"], T0, -7_000_000, 4), pad, dtype)
                what = f"edge mask_gids n={m} offset {off} {dtype} {form}"
                kg, km = _twice_identical(lambda: flt.mask_gids(*args), what)
                pg, pm = flt.mask_gids_plain(*args)
                _compare_bytes(kg, pg, what)
                _compare_bytes(km, pm, what + " mask")


# ---- phase 3b: the tile path's kernels K5-K8 against their plain versions -------

def _padded(t, n_pad, fill):
    import torch

    out = torch.full((n_pad,), fill, dtype=t.dtype, device=t.device)
    out[: t.shape[0]] = t
    return out


def _compare_bytes(a, b, what: str) -> None:
    import torch

    a, b = a.contiguous().reshape(-1), b.contiguous().reshape(-1)  # 0-dim counts too
    a = a.view(torch.uint8) if a.dtype != torch.uint8 else a
    b = b.view(torch.uint8) if b.dtype != torch.uint8 else b
    if a.shape != b.shape or not torch.equal(a, b):
        bad = int((a != b).sum()) if a.shape == b.shape else -1
        raise AssertionError(f"{what}: {bad} bytes differ from the plain version")


def _check_limb_sums(k, p, what: str) -> float:
    """K6 against its plain version: sums/errs within rel 1e-12 (fold
    order), counts and presence exact."""
    err = 0.0
    for name, a, b in zip(("sums", "errs", "counts", "presence"), k, p):
        if (a is None) != (b is None):
            raise AssertionError(f"{what}.{name}: present in one result only")
        if a is not None:
            err = max(err, _compare(a, b, exact=(name in ("counts", "presence")),
                                    what=f"{what}.{name}"))
    return err


def run_tile_kernel_phase(n_hosts: int, hours: int, reps: int) -> dict:
    """Phase 3b: K5-K8 at the tile path's shapes — the (hostname, ts)
    planes padded to a multiple of 4096 rows as the super-tile holds them.
    Returns name -> metrics for the kernels line."""
    import torch

    from greptimedb_tpu_torch.ops import aggregate as agg
    from greptimedb_tpu_torch.ops import filter as flt
    from greptimedb_tpu_torch.ops.tiles import pad_rows

    dev = torch.device("cuda", 0)
    n, codes, ts, valid, vals = tsbs_planes(n_hosts, hours, 10, dev)
    npad = pad_rows(n)
    nb = npad // agg.BLOCK_ROWS
    codes, ts = _padded(codes, npad, 0), _padded(ts, npad, 0)
    valid = _padded(valid, npad, False)
    vals = [_padded(v, npad, 0.0) for v in vals]
    card = 1 << (max(n_hosts, 1) - 1).bit_length()
    G = card * hours
    lo, hi = T0, T0 + hours * H3600
    gids, mask = flt.mask_gids(valid, [(ts, ">=", lo), (ts, "<", hi)], [], [(codes, card)],
                               (ts, T0, H3600, hours), G - 1)
    out: dict[str, dict] = {}

    # K1 at the chunk shapes the tile path launches it at (the entry's
    # 2^24-row chunk and its tail) with double-groupby's filters, keyed as
    # SHAPED keys its launches; each against its plain version
    from greptimedb_tpu_torch.parallel.tile_planes import TILE_CHUNK_ROWS

    # each as the tile program calls it, `lits` a view of the run's one
    # uploaded literal buffer (TileProgram.run_with), and as this phase
    # called it before (`_upload`: the table built and uploaded each call)
    from greptimedb_tpu_torch.kernels._build import upload_table

    spans = range(0, npad, TILE_CHUNK_ROWS)
    table = flt.literal_table([(torch.int64, ">=", lo), (torch.int64, "<", hi)], T0, H3600)
    run_lits = upload_table(table * len(spans) + [0], dev)  # the HAVING literal after them
    k1_chunks = {}
    for i, o in enumerate(spans):
        v_c, t_c, c_c = (x[o:o + TILE_CHUNK_ROWS] for x in (valid, ts, codes))
        rows = int(v_c.shape[0])
        k1_args = (v_c, [(t_c, ">=", lo), (t_c, "<", hi)], [], [(c_c, card)],
                   (t_c, T0, H3600, hours), G - 1)
        src_lits = run_lits[i * len(table):(i + 1) * len(table)]
        forms = {"tile": lambda: flt.mask_gids(*k1_args, lits=src_lits),
                 "upload": lambda: flt.mask_gids(*k1_args)}
        pg, pm = flt.mask_gids_plain(*k1_args)
        # as phase 3's K1: valid, ts and codes read, ids and mask written
        kb1, kby1 = bound(rows * (1 + 8 + 4) + rows * (4 + 1), rows * 8)
        timed = {}
        for form, fn in forms.items():
            kg, km = _twice_identical(fn, f"mask_gids chunk {rows} {form}")
            _compare(kg, pg, True, f"mask_gids chunk {rows} {form}.gids")
            _compare(km, pm, True, f"mask_gids chunk {rows} {form}.mask")
            ops = _device_ops(fn, calls=3)
            timed[form] = dict(**_timed_runs(fn, reps), enqueue_us=_enqueue_us(fn, reps),
                               device_us={_kernel_name(k): us / n for k, (us, n) in ops.items() if n})
            del kg, km
        k1_chunks[f"rows<={_rows_bucket(rows)}"] = dict(
            rows=rows, bound_ms=kb1, bound_by=kby1, **timed["tile"],
            upload={**timed["upload"], "bound_ms": kb1})
        del pg, pm
    out["mask_gids_chunk"] = k1_chunks

    # K5 on one full-length column
    kl = _twice_identical(lambda: agg.quantize_limbs(vals[0]), "quantize_limbs")
    pl = agg.quantize_limbs_plain(vals[0])
    _compare_bytes(kl[0], pl[0], "quantize_limbs.limbs")
    _compare_bytes(kl[1], pl[1], "quantize_limbs.scale")
    # 8 B read and 8 B of digits written per row, 8 B of scale per block;
    # per row about 6 operations (abs/max, multiply, round, 4 digit shifts)
    k5_bound, k5_by = bound(npad * 16 + nb * 8, npad * 6)
    out["quantize_limbs"] = dict(
        max_abs_err=0.0, rows=npad,
        ms=_timed(lambda: agg.quantize_limbs(vals[0]), reps),
        plain_ms=_timed(lambda: agg.quantize_limbs_plain(vals[0]), 1),
        bound_ms=k5_bound, bound_by=k5_by, library_ms=None,
    )

    # K6 at C = 1, 5 and 10 over host-clustered ids; index_add_ of the raw
    # sums is the library yardstick
    lcols = [agg.quantize_limbs(v) for v in vals]
    k6 = {}
    k6_states = None
    for C in (1, 5, 10):
        k = _twice_identical(lambda: agg.limb_segment_sums(lcols[:C], gids, mask, G), f"limb C={C}")
        p = agg.limb_segment_sums_plain(lcols[:C], gids, mask, G)
        err = _check_limb_sums(k, p, f"limb_segment_sums C={C}")
        stacked = torch.stack(vals[:C], dim=1)
        safe = torch.where(mask, gids, G).to(torch.int64)
        lib = _timed(lambda: torch.zeros((G + 1, C), dtype=torch.float64, device=dev)
                     .index_add_(0, safe, stacked), reps)
        del stacked
        # ids, mask and 8 B of digits per column read once; sums, errs
        # [C, G] f64 and presence [G] written; 4 digit adds per row and column
        kb, kby = bound(npad * (4 + 1 + 8 * C) + C * G * 16 + G * 4, npad * C * 4)
        k6[C] = dict(
            max_abs_err=err,
            ms=_timed(lambda: agg.limb_segment_sums(lcols[:C], gids, mask, G), reps),
            plain_ms=_timed(lambda: agg.limb_segment_sums_plain(lcols[:C], gids, mask, G), 1),
            bound_ms=kb, bound_by=kby, library_ms=lib,
        )
        if C == 10:
            k6_states = k
    # minute buckets over the host-major layout fail the guard: the slow
    # branch (K18's sort, then the runs of dequantized values)
    n_min = hours * 60
    gm, mm = flt.mask_gids(valid, [(ts, "<", hi - 1800_000)], [], [], (ts, T0, 60_000, n_min),
                           n_min - 1)
    k = agg.limb_segment_sums(lcols[:1], gm, mm, n_min)
    _check_limb_sums(k, agg.limb_segment_sums_plain(lcols[:1], gm, mm, n_min), "limb guard fails")
    # the failing call reads ids, mask, digits and scales once and writes
    # [G] sums, errs and presence; 4 digit adds per row
    gf_b, gf_by = bound(npad * (4 + 1 + 8) + nb * 8 + n_min * (8 + 8 + 4), npad * 4)
    guard_fail = dict(ms=_timed(lambda: agg.limb_segment_sums(lcols[:1], gm, mm, n_min), reps),
                      bound_ms=gf_b, bound_by=gf_by)
    del gm, mm
    out["limb_segment_sums"] = dict(k6[10], c1=k6[1], c5=k6[5], guard_fail=guard_fail)

    # K7 at groupby-orderby-limit's shape (minute buckets, one int key,
    # descending, cap 5), at the live HAVING query's (G = 4096 x 14, cap 10,
    # the f64 max with NaN as NULL, K13's mask as the survivors) and at
    # lastpoint's (hosts, no key, cap ~ hosts), each a median of five.  The
    # bound is bytes alone, whatever implements the select: the gate and
    # each key's planes read once, the `cap` ids and the count written
    from greptimedb_tpu_torch.parallel.tile_planner import quantize_soft

    Gm = quantize_soft(n_min)
    surv = torch.arange(Gm, device=dev) < n_min - 30
    bucket_key = torch.arange(Gm, dtype=torch.int64, device=dev)
    keys = [(bucket_key, None, False, True)]
    ks, kn = _twice_identical(lambda: agg.topk_group_select(surv, keys, 5), "topk keyed")
    ps, pn = agg.topk_group_select_plain(surv, keys, 5)
    _compare(ks, ps, True, "topk keyed.sel")
    _compare(kn, pn, True, "topk keyed.n_out")
    fkey = vals[0][:Gm].contiguous()
    lib7 = _timed(lambda: torch.topk(fkey, 5), reps)
    k7b, k7by = bound(Gm * (1 + 8) + 5 * 4 + 4, 0)
    states = select_states(dev)
    G_live, pres_live, mu_live, _asys = states
    _prog, _args, (live_mask, live_keys, _cap) = select_inputs("having-or-orderby-limit", dev, states)
    ks3, kn3 = _twice_identical(lambda: agg.topk_group_select(live_mask, live_keys, 10),
                                "topk keyed live")
    ps3, pn3 = agg.topk_group_select_plain(live_mask, live_keys, 10)
    _compare(ks3, ps3, True, "topk keyed live.sel")
    _compare(kn3, pn3, True, "topk keyed live.n_out")
    # the mask, the f64 key and its NULL plane read; 10 ids and the count written
    k7lb, k7lby = bound(G_live * (1 + 8 + 1) + 10 * 4 + 4, 0)
    cap_l = quantize_soft(n_hosts)
    surv_l = torch.arange(card, device=dev) < n_hosts
    ks2, kn2 = _twice_identical(lambda: agg.topk_group_select(surv_l, [], cap_l), "topk compact")
    ps2, pn2 = agg.topk_group_select_plain(surv_l, [], cap_l)
    _compare(ks2, ps2, True, "topk compact.sel")
    _compare(kn2, pn2, True, "topk compact.n_out")
    k7cb, k7cby = bound(card + cap_l * 4 + 4, 0)
    # the same compaction as one PyTorch call: the survivors' indices
    lib7c = _timed(lambda: torch.nonzero(surv_l), reps)
    out["topk_select"] = dict(
        max_abs_err=0.0, groups=Gm, cap=5,
        **_timed_runs(lambda: agg.topk_group_select(surv, keys, 5), reps),
        plain_ms=_timed(lambda: agg.topk_group_select_plain(surv, keys, 5), reps),
        bound_ms=k7b, bound_by=k7by, library_ms=lib7,
        live=dict(
            groups=G_live, cap=10,
            **_timed_runs(lambda: agg.topk_group_select(live_mask, live_keys, 10), reps),
            plain_ms=_timed(lambda: agg.topk_group_select_plain(live_mask, live_keys, 10), reps),
            bound_ms=k7lb, bound_by=k7lby,
            library_ms=_timed(lambda: torch.topk(mu_live, 10), reps),
        ),
        compact=dict(
            groups=card, cap=cap_l,
            **_timed_runs(lambda: agg.topk_group_select(surv_l, [], cap_l), reps),
            plain_ms=_timed(lambda: agg.topk_group_select_plain(surv_l, [], cap_l), reps),
            bound_ms=k7cb, bound_by=k7cby, library_ms=lib7c,
        ),
        select_stage=run_select_stage(dev, reps, states),
    )
    del states, live_mask, live_keys, pres_live, mu_live, _asys, _args, _prog

    # K8 dense at G = 4096 x 12: bit-packed presence, 10 f32 avg rows, the
    # verdict over 10 limb columns (double-groupby-all's layout); compact
    # at lastpoint's: presence and one f64 row gathered by K7's selection
    sums, errs, _c, presence = k6_states
    dense = ([presence], [(sums[c], presence) for c in range(10)], [], True)
    verdict = [(errs[c], sums[c]) for c in range(10)]
    kd = _twice_identical(lambda: agg.pack_result(*dense, verdict_rows=verdict), "pack dense")
    pd = agg.pack_result_plain(*dense, verdict_rows=verdict)
    _compare_bytes(kd[0], pd[0], "pack_result dense.buf")
    lv = vals[1][:card].contiguous()
    pres_l = surv_l.to(torch.int32)
    comp = ([pres_l], [], [("value", lv)], False)
    kc = _twice_identical(lambda: agg.pack_result(*comp, sel=ks2, n_out=kn2), "pack compact")
    pc_ = agg.pack_result_plain(*comp, sel=ks2, n_out=kn2)
    _compare_bytes(kc[0], pc_[0], "pack_result compact.buf")
    # dense: presence (4 B) + 10 x (sums 8 B + counts shared) + errs read;
    # buf written (1 bit + 10 x 4 B per group)
    k8b, k8by = bound(G * (4 + 10 * 16) + G // 8 + G * 40 + 1, G * 10 * 3)
    # compact: the selection and n_out read, each selected group's presence
    # (4 B) and f64 value read once; ids, presence and the value's two
    # words written
    k8cb, k8cby = bound(cap_l * 4 + 4 + cap_l * (4 + 8) + cap_l * (4 + 4 + 8) + 8, cap_l * 2)
    out["pack_result"] = dict(
        max_abs_err=0.0,
        ms=_timed(lambda: agg.pack_result(*dense, verdict_rows=verdict), reps),
        plain_ms=_timed(lambda: agg.pack_result_plain(*dense, verdict_rows=verdict), reps),
        bound_ms=k8b, bound_by=k8by, library_ms=None,
        compact=dict(
            ms=_timed(lambda: agg.pack_result(*comp, sel=ks2, n_out=kn2), reps),
            plain_ms=_timed(lambda: agg.pack_result_plain(*comp, sel=ks2, n_out=kn2), reps),
            bound_ms=k8cb, bound_by=k8cby,
        ),
    )
    del vals, lcols, codes, ts, valid, gids, mask, k6_states, sums, errs, presence
    torch.cuda.empty_cache()
    run_tile_edge_cases(dev)
    t0 = time.perf_counter()
    run_pack_scatter_edge_cases(dev)
    CHECK_S["pack_scatter_edge_cases_s"] += time.perf_counter() - t0
    return out


def run_tile_edge_cases(dev) -> None:
    """K5-K8 on the inputs that make them hard, against their plain
    versions, twice each: NaN/+-inf/all-zero blocks, amax at powers of two
    and +-1 ulp, half-way values; shuffled ids (the slow branch), null
    gated counts, a mixed-magnitude block; ties, +-0, NaN, +-inf and
    nulls in sort keys; NaN and subnormals in f64 words."""
    import torch

    from greptimedb_tpu_torch.ops import aggregate as agg

    rng = np.random.default_rng(13)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    nb = 96
    v = rng.normal(0, 1, nb * 4096) * np.repeat(np.exp(rng.uniform(-60, 60, nb)), 4096)
    for i, k in enumerate(rng.integers(-95, 1000, 40)):
        blk = v[i * 4096:(i + 1) * 4096]
        blk[:] = rng.uniform(-1, 1, 4096) * 2.0**k
        p = 2.0**k
        blk[7] = [p, np.nextafter(p, 0), np.nextafter(p, np.inf), -p][i % 4]
    v[40 * 4096:41 * 4096] = 0.0
    v[41 * 4096 + 5], v[41 * 4096 + 9], v[42 * 4096 + 3] = np.nan, np.inf, -np.inf
    v[43 * 4096:44 * 4096] = np.arange(4096) + 0.5
    v[44 * 4096:45 * 4096] = (np.arange(4096) - 2048) * 0.25
    v[45 * 4096:46 * 4096] = np.where(np.arange(4096) % 2, 1e9, 1.0)
    x = t(v)
    kq = _twice_identical(lambda: agg.quantize_limbs(x), "edge quantize")
    pq = agg.quantize_limbs_plain(x)
    _compare_bytes(kq[0], pq[0], "edge quantize.limbs")
    _compare_bytes(kq[1], pq[1], "edge quantize.scale")
    n = nb * 4096
    G = 512
    sorted_g = np.sort(rng.integers(0, G, n)).astype(np.int32)
    mask = t(rng.random(n) < 0.9)
    c01 = t(rng.random(n) < 0.8)
    y = t(rng.uniform(-1e6, 1e6, n))
    cols = [kq, agg.quantize_limbs(y)]
    for name, g in (("clustered", t(sorted_g)), ("shuffled", t(rng.permutation(sorted_g)))):
        k = _twice_identical(lambda: agg.limb_segment_sums(cols, g, mask, G, [None, c01]),
                             f"edge limb {name}")
        _check_limb_sums(k, agg.limb_segment_sums_plain(cols, g, mask, G, [None, c01]),
                         f"edge limb {name}")
    # more null-gated count planes than one combine pass covers (16 per
    # 256 threads, 32 per chunk)
    g = t(sorted_g)
    for n_counted in (17, 40):
        many = [t(rng.random(n) < rng.uniform(0.1, 0.9)) for _ in range(n_counted)]
        lc = [cols[i % 2] for i in range(n_counted)]
        k = _twice_identical(lambda: agg.limb_segment_sums(lc, g, mask, G, many),
                             f"edge limb {n_counted} counted")
        _check_limb_sums(k, agg.limb_segment_sums_plain(lc, g, mask, G, many),
                         f"edge limb {n_counted} counted")
    Gk = 3000
    m = t(rng.random(Gk) > 0.3)
    fv = rng.integers(0, 5, Gk).astype(np.float64)
    for val, cnt in ((np.nan, 20), (-0.0, 10), (np.inf, 10), (-np.inf, 10)):
        fv[rng.choice(Gk, cnt, replace=False)] = val
    isn = t(rng.random(Gk) < 0.1)
    iv = t(rng.integers(-3, 3, Gk).astype(np.int64))
    for asc in (True, False):
        for nf in (True, False):
            keys = [(t(fv), isn, asc, nf), (iv, None, not asc, False)]
            for cap in (1, 7, 512):
                ks = _twice_identical(lambda: agg.topk_group_select(m, keys, cap), "edge topk")
                ps = agg.topk_group_select_plain(m, keys, cap)
                _compare(ks[0], ps[0], True, f"edge topk asc={asc} nf={nf} cap={cap}")
                _compare(ks[1], ps[1], True, "edge topk n_out")
    for cap in (5, Gk):
        ks = agg.topk_group_select(m, [], cap)
        ps = agg.topk_group_select_plain(m, [], cap)
        _compare(ks[0], ps[0], True, f"edge topk compact cap={cap}")
    # the select's forms: keys read from the states (a count plane NULL at
    # 0 with NaN as NULL, a dim coordinate), a count plane as the gate, one
    # launch and (past TOPK_ONE_LAUNCH_GROUPS) a grid and a merge; int64
    # ends descending, every key equal, no survivor; caps on both sides of
    # the select's 32
    for G in (1, 31, 768, agg.TOPK_ONE_LAUNCH_GROUPS + 4099):
        v = rng.uniform(0, 9, G).round(1)
        v[rng.random(G) < 0.05] = np.nan
        i64 = rng.integers(-3, 3, G).astype(np.int64)
        i64[rng.random(G) < 0.02] = np.iinfo(np.int64).min
        i64[rng.random(G) < 0.02] = np.iinfo(np.int64).max
        cnt = t(rng.integers(0, 3, G).astype(np.int32))
        cases = {
            "refs": [(agg.HavingRef(values=t(v), counts=cnt, nan_null=True), False, True),
                     (agg.HavingRef(div=7, card=11), True, False)],
            "int64 ends": [(t(i64), None, False, False)],
            "all equal": [(t(np.zeros(G)), None, True, True), (agg.HavingRef(div=G, card=1), False, True)],
        }
        for gate_name, gate in (("count", cnt), ("none", t(np.zeros(G, bool)))):
            for name, keys in cases.items():
                for cap in sorted({1, min(10, G), min(32, G), min(33, G)}):
                    what = f"edge topk G={G} {name} gate={gate_name} cap={cap}"
                    ks = _twice_identical(lambda: agg.topk_group_select(gate, keys, cap), what)
                    ps = agg.topk_group_select_plain(gate, keys, cap)
                    _compare(ks[0], ps[0], True, what)
                    _compare(ks[1], ps[1], True, what + " n_out")
    w = np.array([5e-324, -5e-324, 1e-310, np.nan, -np.nan, np.inf, -np.inf, -0.0, 0.0, 1.5,
                  -2.2250738585072014e-308, 123.456] * 250)
    wv = t(w)
    pres = t(rng.integers(0, 3, w.size).astype(np.int32))
    sel = t(rng.permutation(w.size)[:700].astype(np.int32))
    nout = t(np.array([650], np.int32))
    for args, kw in (
        (([pres], [(wv, pres)], [("value", wv), ("avg", wv, pres)], False), {}),
        (([pres], [(wv, pres)], [("value", wv), ("avg", wv, pres)], True),
         {"verdict_rows": [(wv.abs(), wv)]}),
        (([pres], [(wv, pres)], [("value", wv), ("avg", wv, pres)], False),
         {"sel": sel, "n_out": nout, "verdict_rows": [(wv.abs() * 1e-9, wv)]}),
    ):
        kp = _twice_identical(lambda: agg.pack_result(*args, **kw), "edge pack")
        pp = agg.pack_result_plain(*args, **kw)
        for a, b in zip(kp, pp):
            _compare_bytes(a, b, "edge pack_result")


def _device_ops(fn, calls: int = 1) -> dict[str, tuple[float, int]]:
    """{CUDA kernel, memset or memcpy name: (device us, how often)} of
    `calls` fn() calls under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out = {}
        for evt in prof.key_averages():
            if evt.device_type is None or "cuda" not in str(evt.device_type).lower():
                continue
            us = getattr(evt, "self_device_time_total", None)
            if us is None:
                us = getattr(evt, "self_cuda_time_total", 0)
            out[evt.key[:80]] = (us, evt.count)
        # every fn profiled here launches a kernel: a trace with none lost
        # the tracer's records (seen once on the card), so it is taken again
        if any(not k.startswith(("Memset", "Memcpy")) for k in out):
            break
    return out


# The kernels one call of K9 and of K17 runs on the card, in order: K9 the
# layout's identities, the row prologue and the strip from one host call;
# K17 one cooperative launch (its refill of the table is the caller's)
K9_KERNELS = ("layout_init_kernel", "series_layout_kernel", "strip_kernel")
K17_KERNELS = ("hash_slots_kernel",)


def _runtime_calls(fn, calls: int = 3) -> dict[str, float]:
    """{CUDA runtime call that puts work on a stream (a kernel launch, a
    copy, a memset): how often a fn() call makes it}, from the host side
    of torch.profiler (a launch is counted where the host makes it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.count / calls for e in prof.key_averages()
            if e.key.startswith(("cudaLaunch", "cudaMemcpy", "cudaMemset"))}


def _call_ops(fn, wrapper, kernels, what: str, caller_ops=(), bare=None, copies=0) -> dict:
    """fn()'s device split (us a launch of each kernel, memset and copy,
    from torch.profiler).  Fails unless one `bare()` call (fn without the
    caller's own work, such as a refill; fn itself by default) added one
    to its wrapper's count and made one runtime call per kernel of
    `kernels`, `copies` host-to-device copies and no memset, and the
    device ran no kernel but those and `caller_ops` (names the caller's
    own work contains).  The kernels line's launch figures come from the
    main path, not from here."""
    bare = bare or fn
    l0 = wrapper.launches
    bare()
    launches = wrapper.launches - l0
    api = _runtime_calls(bare)
    ops = _device_ops(fn, calls=3)
    seen = {_kernel_name(key) for key, (_us, n) in ops.items() if n}
    other = [key for key in ops if _kernel_name(key) not in kernels
             and not any(c in key for c in caller_ops)
             and not (copies and key.startswith("Memcpy HtoD"))]
    if launches != 1 or api.get("cudaMemcpyAsync", 0) != copies \
            or sum(api.values()) != len(kernels) + copies or other or not set(kernels) <= seen:
        raise AssertionError(f"{what}: one call: {launches} wrapper launches, runtime calls "
                             f"{api}, device ops of 3 calls {ops}")
    return {"device_us": {_kernel_name(k): us / n for k, (us, n) in ops.items() if n}}


def _k8_k3_ops(fn, what: str, k8_launches: int = 0) -> dict[str, int]:
    """fn()'s device ops: no host-to-device copy (K8's descriptor and K3's
    column pointers ride in their launches' arguments), and `k8_launches`
    pack kernels where given."""
    ops = {k: n for k, (_us, n) in _device_ops(fn).items()}
    h2d = {k: n for k, n in ops.items() if "HtoD" in k}
    if h2d:
        raise AssertionError(f"{what}: host-to-device copies {h2d}")
    packs = sum(n for k, n in ops.items() if "pack_kernel" in k)
    if k8_launches and packs != k8_launches:
        raise AssertionError(f"{what}: {packs} pack kernels, its plan makes {k8_launches}; "
                             f"device ops {ops}")
    return ops


def run_pack_scatter_edge_cases(dev) -> dict:
    """K8 and K3 where their launch plans and kernels branch, each against
    its plain version (K3 also against its order emulation), twice: K8 past
    one descriptor (two launches), a misaligned row after bit-packed
    presence, a verdict that fails at exactly one group, two calls on two
    streams at once, a capture in a CUDA graph replayed on new inputs; K3
    at 40 columns (two launches), runs of 1 to ~9000 rows on its dense and
    sparse kernels, an empty last group, a shut gate (its outputs left as
    they were) and an open one.  torch.profiler: no K8 or K3 call copies
    to the card, and K8 launches as its plan says."""
    import torch

    from greptimedb_tpu_torch.ops import aggregate as agg

    rng = np.random.default_rng(SEED + 14)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    out: dict = {}

    def pack_args(G, n_acc32, n64, n_verdict, fail_at=None, bits=True):
        pres = t(rng.integers(0, 3, G).astype(np.int32))
        sums = [t(rng.normal(0, 1e3, G)) for _ in range(max(n_acc32, n64, n_verdict))]
        errs = []
        for i in range(n_verdict):
            e = np.abs(sums[i].cpu().numpy()) * 1e-9
            if fail_at is not None and i == n_verdict - 1:
                e[fail_at] = abs(float(sums[i][fail_at])) * 1e-6
            errs.append(t(e))
        args = ([pres], [(sums[i], pres) for i in range(n_acc32)],
                [("value", sums[i]) if i % 2 else ("avg", sums[i], pres) for i in range(n64)], bits)
        return args, {"verdict_rows": list(zip(errs, sums)),
                      "overflow": t(np.array([int(rng.integers(0, 2))], np.int32))}

    def check_pack(args, kw, what, launches):
        l0 = agg.pack_result.launches
        k = _twice_identical(lambda: agg.pack_result(*args, **kw), what)
        made = agg.pack_result.launches - l0
        if made != 2 * launches:
            raise AssertionError(f"{what}: {made} launches in two calls, expected {launches} a call")
        p = agg.pack_result_plain(*args, **kw)
        for a, b in zip(k, p):
            _compare_bytes(a, b, what)
        return k

    # past one descriptor: 1 + 40 + 30 + 3 + 1 rows over G = 300 bit-packed
    big = pack_args(300, 40, 30, 3)
    check_pack(*big, "edge K8 past one descriptor", 2)
    _k8_k3_ops(lambda: agg.pack_result(*big[0], **big[1]), "edge K8 past one descriptor", 2)
    # a misaligned row: 4101 presence bits leave the f32 rows at odd offsets
    odd = pack_args(4101, 3, 2, 2)
    layout = agg.pack_layout(True, False, 1, 3, ("avg", "value"), 2, True, 4101, 4101)
    if [a for *_r, a in layout.rows][1] != 1:
        raise AssertionError("edge K8: the row after 4101 presence bits should be misaligned")
    check_pack(*odd, "edge K8 misaligned rows", 1)
    # a verdict failing at exactly one group, and one that passes
    for fail_at in (2999, None):
        args, kw = pack_args(4096 * 12, 10, 0, 10, fail_at=fail_at)
        k = check_pack(args, kw, f"edge K8 verdict fail_at={fail_at}", 1)
        if int(k[0][-2]) != (fail_at is None):
            raise AssertionError(f"edge K8 verdict fail_at={fail_at}: byte {int(k[0][-2])}")
    out["k8_ops"] = _k8_k3_ops(lambda: agg.pack_result(*args, **kw), "edge K8 dense", 1)
    # two calls on two streams at once
    cases = [pack_args(4096 * 12, 10, 1, 10, fail_at=f) for f in (None, 7)]
    want = [agg.pack_result_plain(*a, **kw_) for a, kw_ in cases]
    streams = [torch.cuda.Stream(dev) for _ in cases]
    torch.cuda.synchronize()
    got = [[], []]
    for _round in range(8):
        for i, ((a, kw_), st) in enumerate(zip(cases, streams)):
            with torch.cuda.stream(st):
                got[i].append(agg.pack_result(*a, **kw_))
    torch.cuda.synchronize()
    for i in range(2):
        for res in got[i]:
            for a, b in zip(res, want[i]):
                _compare_bytes(a, b, f"edge K8 stream {i}")
    # a capture in a CUDA graph, replayed twice on new inputs in place
    (gargs, gkw) = pack_args(4096 * 12, 10, 2, 10)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        agg.pack_result(*gargs, **gkw)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = agg.pack_result(*gargs, **gkw)
    for fail_at in (None, 123):
        fresh, fkw = pack_args(4096 * 12, 10, 2, 10, fail_at=fail_at)
        gargs[0][0].copy_(fresh[0][0])
        for (s_old, _c), (s_new, _c2) in zip(gargs[1], fresh[1]):
            s_old.copy_(s_new)
        for (e_old, _s), (e_new, _s2) in zip(gkw["verdict_rows"], fkw["verdict_rows"]):
            e_old.copy_(e_new)
        gkw["overflow"].copy_(fkw["overflow"])
        want_g = agg.pack_result_plain(*gargs, **gkw)
        for _replay in range(2):
            graph.replay()
            torch.cuda.synchronize()
            for a, b in zip(captured, want_g):
                _compare_bytes(a, b, f"edge K8 graph replay fail_at={fail_at}")
    del graph, captured

    # K3
    aggs = ("count", "max", "min", "sum")

    def check_scatter(g, G, C, what, launches=1):
        n = g.shape[0]
        vals = [t(rng.normal(0, 100, n)) for _ in range(C)]
        vals[0][t(rng.choice(n, min(n, 9), replace=False))] = float("nan")
        vals[0][t(rng.choice(n, min(n, 9), replace=False))] = -0.0
        base = t(rng.random(n) < 0.93)
        masks = [base if c % 3 else base & t(rng.random(n) < 0.6) for c in range(C)]
        order = agg.sort_segments(g, base, G)
        l0 = agg.segment_reduce_scatter.launches
        k = _twice_identical(lambda: agg.segment_reduce_scatter(vals, g, masks, base, G, aggs,
                                                                order), what)
        if agg.segment_reduce_scatter.launches - l0 != 2 * launches:
            raise AssertionError(f"{what}: expected {launches} launches a call")
        _check_state(k, _plain_on_host(agg.segment_reduce_scatter_plain, vals, g, masks, base, G,
                                       aggs), what)
        _same_as_lanes(k, lambda: agg.segment_reduce_scatter_lanes(vals, masks, base, order, G, aggs),
                       what)
        return vals, masks, base, order, k

    lens = np.array([1, 31, 32, 33, 9001, 2, 0, 64, 65, 5, 1, 0] * 40)
    runs = np.repeat(np.arange(lens.size), lens).astype(np.int32)
    # dense kernel (G <= n / 32): the runs as they are; sparse: spread over 2^20
    check_scatter(t(rng.permutation(runs)), lens.size, 3, "edge K3 runs, dense ids")
    spread = np.sort(rng.choice(np.arange(1 << 20), lens.size, replace=False)).astype(np.int32)
    check_scatter(t(rng.permutation(spread[runs])), 1 << 20, 3, "edge K3 runs, sparse ids")
    short = rng.integers(0, 9, 60_000)
    check_scatter(t(np.repeat(np.arange(short.size), short).astype(np.int32)), short.size, 2,
                  "edge K3 short runs")
    vals, masks, base, order, k40 = check_scatter(
        t(np.sort(rng.integers(0, 5000, 400_000)).astype(np.int32)), 5001, 40,
        "edge K3 40 columns, empty last group", launches=2)
    if int(k40.counts[:, -1].abs().sum()) != 0:
        raise AssertionError("edge K3: the empty last group holds rows")
    # a shut gate leaves the outputs as they were; an open one writes them
    G = 5001
    n = base.shape[0]
    gids = t(np.sort(rng.integers(0, G - 1, n)).astype(np.int32))
    order = agg.sort_segments(gids, base, G)
    sentinel = [torch.full((3, G), 7.0, dtype=torch.float64, device=dev),
                torch.full((3, G), 7, dtype=torch.int32, device=dev),
                torch.full((3, G), 7.0, dtype=torch.float64, device=dev),
                torch.full((3, G), 7.0, dtype=torch.float64, device=dev)]
    for word, shut in ((0, True), (1, False)):
        outs = [o.clone() for o in sentinel]
        verdict = torch.full((1,), word, dtype=torch.int32, device=dev)
        st = agg.segment_reduce_scatter(vals[:3], gids, masks[:3], base, G, aggs, order,
                                        verdict=verdict, outs=outs)
        torch.cuda.synchronize()
        if shut:
            for a, b in zip(outs, sentinel):
                _compare_bytes(a, b, "edge K3 shut gate")
        else:
            _check_state(st, _plain_on_host(agg.segment_reduce_scatter_plain, vals[:3], gids,
                                            masks[:3], base, G, aggs), "edge K3 open gate")
    out["k3_ops"] = _k8_k3_ops(lambda: agg.segment_reduce_scatter(vals, gids, masks, base, G,
                                                                  aggs, order), "edge K3")
    emit({"phase": "pack_scatter_edge_cases", "ok": True, **out})
    return out


# ---- phase 3d: the plane kernels K13-K16 against their plain versions ----------

# the live phase's append: 30 more minutes at the 10 s scrape, for the 4000
# hosts and 96 new ones (host_4000 .. host_4095)
LIVE_MINUTES = 30
LIVE_NEW_HOSTS = 96


def _chunked(t, chunk_rows: int) -> list:
    return [t[o:o + chunk_rows].contiguous() for o in range(0, t.shape[0], chunk_rows)]


def _same_chunks(a, b, what: str) -> None:
    if len(a) != len(b):
        raise AssertionError(f"{what}: {len(a)} chunks != {len(b)}")
    for i, (x, y) in enumerate(zip(a, b)):
        _compare_bytes(x, y, f"{what} chunk {i}")


def _twice_identical_chunks(fn, what: str):
    import torch

    a = fn()
    b = fn()
    torch.cuda.synchronize()
    _same_chunks(a, b, what + " (two runs)")
    return a


def _multi_gather_case(P, planes, perm, what: str) -> list:
    """K15's multi-plane gather of `planes` twice with identical bytes,
    each plane byte for byte its plain version, in as many launches as
    `gather_launch_plan` says."""
    l0 = P.gather_planes.launches
    got = _twice_identical_chunks(lambda: [c for p in P.gather_planes_multi(planes, perm)
                                           for c in p], what)
    made = P.gather_planes.launches - l0
    planned = len(P.gather_launch_plan(len(planes), len(planes[0])))
    if planes[0][0].is_cuda and made != 2 * planned:
        raise AssertionError(f"{what}: {made} launches in two calls, its plan makes {planned} a call")
    want = [c for p in P.gather_planes_multi_plain(planes, perm) for c in p]
    _same_chunks(got, want, what)
    return got


def growth_perm(n_old: int, n_new: int):
    """The dictionary permutation old code -> new code when hosts
    host_<n_old> .. host_<n_new - 1> join host_0 .. host_<n_old - 1>
    (codes are the ranks of the sorted names)."""
    new = sorted(f"host_{i}" for i in range(n_new))
    rank = {h: i for i, h in enumerate(new)}
    old = sorted(f"host_{i}" for i in range(n_old))
    return np.array([rank[h] for h in old], np.int32)


def _timed_sort(wrapper, fn, reps: int, extra_kernels: int = 0) -> dict:
    """Mean ms of fn(), a call of a radix.cuh sort's wrapper, and what the
    last of those calls ran as the wrapper recorded it: the plan it used
    and the kernels it launched, counted where they were launched (the
    memset of the control words is not a kernel).  Fails unless that is
    the histogram and one kernel a pass, plus `extra_kernels` of the
    wrapper's own."""
    wrapper.last_sort = None
    ms = _timed(fn, reps)
    s = wrapper.last_sort
    if s is None or s["kernels"] != 1 + s["passes"] + extra_kernels:
        raise AssertionError(f"{wrapper.__name__} ran {s}: expected the histogram, one kernel a "
                             f"pass and {extra_kernels} more")
    return {"ms": ms, "passes": s["passes"], "key_bytes": s["key_bytes"],
            "sort_launches": s["kernels"]}


def run_plane_kernel_phase(n_hosts: int, hours: int, reps: int) -> dict:
    """Phase 3d: K13-K16 against their plain versions on the card, at the
    main path's shapes (the super-tile of --hosts x --hours in (hostname,
    ts) order, padded and cut into 2^24-row chunks; the live phase's
    delta; G = 4096 x 16 HAVING states), then on edge cases; every kernel
    twice with identical bytes.  K13 exact, K14-K16 byte for byte."""
    import torch

    from greptimedb_tpu_torch.ops import aggregate as agg
    from greptimedb_tpu_torch.ops import permute as P
    from greptimedb_tpu_torch.ops.tiles import pad_rows
    from greptimedb_tpu_torch.parallel.tile_planes import TILE_CHUNK_ROWS

    dev = torch.device("cuda", 0)
    n, codes, ts, valid, vals = tsbs_planes(n_hosts, hours, 1, dev)
    npad = pad_rows(n)
    ts_c = _chunked(_padded(ts, npad, 0), TILE_CHUNK_ROWS)
    valid_c = _chunked(_padded(valid, npad, False), TILE_CHUNK_ROWS)
    codes_c = _chunked(_padded(codes, npad, 0), TILE_CHUNK_ROWS)
    f64_c = _chunked(_padded(vals[0], npad, 0.0), TILE_CHUNK_ROWS)
    del ts, valid, codes, vals
    out: dict[str, dict] = {}

    # K14 over the entry's ts: every scrape's 4000 hosts tie
    perm = _twice_identical(lambda: P.ts_argsort(ts_c, valid_c), "ts_argsort")
    _compare_bytes(perm, P.ts_argsort_plain(ts_c, valid_c), "ts_argsort")
    key = torch.where(torch.cat(valid_c), torch.cat(ts_c), P.INT64_MAX)
    # ts (8 B) and valid (1 B) read, the int32 perm written, once a row
    k14b, k14by = bound(npad * (8 + 1 + 4), npad)
    k14 = _timed_sort(P.ts_argsort, lambda: P.ts_argsort(ts_c, valid_c), reps, extra_kernels=2)
    # the same rows with each ts moved by 0-9999 ms, as targets scraped at
    # their own offsets with jitter: no low bit shared, the same span
    jit = torch.Generator(device=dev).manual_seed(SEED + 14)
    jts_c = [c + torch.randint(0, 10_000, c.shape, generator=jit, device=dev) for c in ts_c]
    jperm = _twice_identical(lambda: P.ts_argsort(jts_c, valid_c), "ts_argsort jittered")
    _compare_bytes(jperm, P.ts_argsort_plain(jts_c, valid_c), "ts_argsort jittered")
    jkey = torch.where(torch.cat(valid_c), torch.cat(jts_c), P.INT64_MAX)
    jittered = _timed_sort(P.ts_argsort, lambda: P.ts_argsort(jts_c, valid_c), reps,
                           extra_kernels=2)
    jittered["library_ms"] = _timed(lambda: torch.argsort(jkey, stable=True), reps)
    out["ts_argsort"] = dict(
        max_abs_err=0.0, rows=npad, **k14,
        plain_ms=_timed(lambda: P.ts_argsort_plain(ts_c, valid_c), 1),
        bound_ms=k14b, bound_by=k14by,
        library_ms=_timed(lambda: torch.argsort(key, stable=True), reps),
        jittered=jittered,
    )
    emit({"phase": "ts_argsort", **out["ts_argsort"]})
    del key, jkey, jts_c, jperm

    # K15 gather: an f64, an int32 and a bool plane by that perm, alone and
    # with the int64 ts plane in one multi-plane call (one launch)
    for name, planes in (("f64", f64_c), ("int32", codes_c), ("bool", valid_c)):
        k = _twice_identical_chunks(lambda: P.gather_planes(planes, perm), f"gather {name}")
        _same_chunks(k, P.gather_planes_plain(planes, perm), f"gather_planes {name}")
    mixed = [f64_c, codes_c, valid_c, ts_c]
    _multi_gather_case(P, mixed, perm, "gather_planes_multi f64+int32+bool+int64")
    esum = sum(p[0].element_size() for p in mixed)
    # perm (4 B) read once for all the planes, each element read and written
    k15mb, k15mby = bound(npad * 4 + npad * 2 * esum, 0)
    multi = dict(
        planes=len(mixed), ms=_timed(lambda: P.gather_planes_multi(mixed, perm), reps),
        bound_ms=k15mb, bound_by=k15mby,
        per_plane_ms=sum(_timed(lambda p=p: P.gather_planes(p, perm), reps) for p in mixed),
        per_plane_bound_ms=bound(len(mixed) * npad * 4 + npad * 2 * esum, 0)[0],
    )
    flat = torch.cat(f64_c)
    perm64 = perm.to(torch.int64)
    # per f64 plane: the index (4 B) and the value (8 B) read, 8 B written
    k15b, k15by = bound(npad * (4 + 8 + 8), 0)
    # K15 remap: the 4000-code plane through the growth permutation
    table = torch.from_numpy(growth_perm(n_hosts, n_hosts + LIVE_NEW_HOSTS)).to(dev)
    k = _twice_identical_chunks(lambda: P.gather_planes(codes_c, table, remap=True), "remap")
    _same_chunks(k, P.gather_planes_plain(codes_c, table, remap=True), "gather_planes remap")
    flat_codes = torch.cat(codes_c).to(torch.int64)
    k15rb, k15rby = bound(npad * (4 + 4) + table.numel() * 4, 0)
    out["gather_planes"] = dict(
        max_abs_err=0.0,
        ms=_timed(lambda: P.gather_planes(f64_c, perm), reps),
        plain_ms=_timed(lambda: P.gather_planes_plain(f64_c, perm), 1),
        bound_ms=k15b, bound_by=k15by,
        library_ms=_timed(lambda: torch.index_select(flat, 0, perm64), reps),
        multi=multi,
        remap=dict(
            ms=_timed(lambda: P.gather_planes(codes_c, table, remap=True), reps),
            plain_ms=_timed(lambda: P.gather_planes_plain(codes_c, table, remap=True), 1),
            bound_ms=k15rb, bound_by=k15rby,
            library_ms=_timed(lambda: torch.take(table, flat_codes), reps),
        ),
    )
    del flat, perm64, flat_codes, perm

    # K16: the live phase's delta merged into the entry, at the front, the
    # back and interleaved, and an empty delta
    n_delta = LIVE_MINUTES * 6 * (n_hosts + LIVE_NEW_HOSTS)
    new_pad = pad_rows(n + n_delta)
    g = torch.Generator(device=dev).manual_seed(SEED)
    dv = torch.rand(n_delta, generator=g, dtype=torch.float64, device=dev)
    db_ = torch.rand(n_delta, generator=g, device=dev) < 0.5
    di = torch.randint(0, 1 << 30, (n_delta,), generator=g, dtype=torch.int32, device=dev)
    spread = torch.sort(torch.randint(0, n + 1, (n_delta,), generator=g, device=dev)).values
    positions = {
        "front": torch.zeros(n_delta, dtype=torch.int32, device=dev),
        "back": torch.full((n_delta,), n, dtype=torch.int32, device=dev),
        "interleaved": spread.to(torch.int32),
    }
    for where, pos in positions.items():
        for name, planes, d in (("f64", f64_c, dv), ("int32", codes_c, di), ("bool", valid_c, db_)):
            args = (planes, n, d, pos, new_pad, TILE_CHUNK_ROWS)
            k = _twice_identical_chunks(lambda: P.delta_patch(*args), f"patch {where} {name}")
            _same_chunks(k, P.delta_patch_plain(*args), f"delta_patch {where} {name}")
    empty = (f64_c, n, dv[:0], positions["front"][:0], npad, TILE_CHUNK_ROWS)
    _same_chunks(P.delta_patch(*empty), P.delta_patch_plain(*empty), "delta_patch empty")
    patch = (f64_c, n, dv, positions["interleaved"], new_pad, TILE_CHUNK_ROWS)
    # per f64 plane: old rows read, the delta and its positions read, the
    # new plane written
    k16b, k16by = bound(n * 8 + n_delta * (8 + 4) + new_pad * 8, 0)
    # the int32 and bool planes interleaved, the f64 plane with the delta
    # at the front and at the back
    per_plane = {}
    for what, planes, d, where in (("int32", codes_c, di, "interleaved"),
                                   ("bool", valid_c, db_, "interleaved"),
                                   ("f64 front", f64_c, dv, "front"),
                                   ("f64 back", f64_c, dv, "back")):
        args = (planes, n, d, positions[where], new_pad, TILE_CHUNK_ROWS)
        esize = planes[0].element_size()
        per_plane[what] = dict(ms=_timed(lambda: P.delta_patch(*args), reps),
                               bound_ms=bound(n * esize + n_delta * (esize + 4)
                                              + new_pad * esize, 0)[0])
    out["delta_patch"] = dict(
        max_abs_err=0.0, rows=new_pad, delta_rows=n_delta,
        ms=_timed(lambda: P.delta_patch(*patch), reps),
        plain_ms=_timed(lambda: P.delta_patch_plain(*patch), 1),
        bound_ms=k16b, bound_by=k16by, library_ms=None, per_plane=per_plane,
    )
    del patch, positions, spread, dv, db_, di, f64_c, codes_c, valid_c, ts_c

    # K13 at G = 4096 x 16 with every op, NULL and NaN, and at the live
    # HAVING queries' shape (their trees over G = 4096 x 14); each a median
    # of five.  Bound: the planes the refs name and presence read once, a
    # byte a group written
    G = 4096 * 16
    tree, refs, lits, presence = having_case(G, dev, SEED)
    k = _twice_identical(lambda: agg.having_mask(tree, refs, lits, presence), "having_mask")
    _compare(k, agg.having_mask_plain(tree, refs, lits, presence), True, "having_mask")
    planes = {id(t): t for r in refs.values() for t in (r.values, r.counts) if t is not None}
    planes[id(presence)] = presence
    k13b, k13by = bound(sum(t.numel() * t.element_size() for t in planes.values()) + G, 0)
    live = {}
    g_live, pres_live, mu_live, as_live = select_states(dev)
    live_refs = {SELECT_MU: agg.HavingRef(values=mu_live, nan_null=True),
                 SELECT_AS: agg.HavingRef(values=as_live, nan_null=True),
                 SELECT_N: agg.HavingRef(values=pres_live)}
    for q, q_tree in HAVING_TREES.items():
        hv = torch.tensor(HAVING_LITERALS[q], dtype=torch.float64, device=dev)
        fn = lambda q_tree=q_tree, hv=hv: agg.having_mask(q_tree, live_refs, hv, pres_live)  # noqa: E731
        k = _twice_identical(fn, f"having_mask {q}")
        _compare(k, agg.having_mask_plain(q_tree, live_refs, hv, pres_live), True,
                 f"having_mask {q}")
        used = {id(live_refs[r].values): live_refs[r].values for r in agg.having_refs(q_tree)}
        used[id(pres_live)] = pres_live
        lb, lby = bound(sum(t.numel() * t.element_size() for t in used.values()) + g_live, 0)
        live[q] = dict(groups=g_live, **_timed_runs(fn, reps), enqueue_us=_enqueue_us(fn, reps),
                       bound_ms=lb, bound_by=lby)
    out["having_mask"] = dict(
        max_abs_err=0.0, groups=G,
        **_timed_runs(lambda: agg.having_mask(tree, refs, lits, presence), reps),
        plain_ms=_timed(lambda: agg.having_mask_plain(tree, refs, lits, presence), reps),
        bound_ms=k13b, bound_by=k13by, library_ms=None, live=live,
    )
    del live_refs, pres_live, mu_live, as_live
    torch.cuda.empty_cache()
    run_plane_edge_cases(dev)
    return out


def having_case(G: int, dev, seed: int):
    """A HAVING tree using every op over max / avg / count / dim refs of G
    groups, with empty groups (presence 0), NULL counts, NaN outputs and
    ties at the literals; returns (tree, refs, literals, presence)."""
    import torch

    from greptimedb_tpu_torch.ops.aggregate import HavingRef

    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    presence = rng.integers(0, 4, G).astype(np.int32)
    cnt = np.where(rng.random(G) < 0.2, 0, presence).astype(np.int32)
    mx = np.round(rng.uniform(90, 100, G), 1)
    av = rng.uniform(0, 100, G)
    av[rng.random(G) < 0.05] = np.nan
    edge = [99.5, np.nan, 99.0, -0.0, np.inf, -np.inf, 99.5, 0.0]
    mx[: min(G, 8)] = edge[: min(G, 8)]
    refs = {
        ("agg", "u", "max"): HavingRef(values=t(mx), counts=t(cnt), nan_null=True),
        ("agg", "s", "avg"): HavingRef(values=t(av), nan_null=True),
        ("agg", "__count_star", "count"): HavingRef(values=t(presence)),
        ("dim", 0): HavingRef(div=16, card=4096),
        ("dim", 1): HavingRef(div=1, card=16),
    }
    mu, asys, n = ("agg", "u", "max"), ("agg", "s", "avg"), ("agg", "__count_star", "count")
    tree = ("or",
            ("and", ("cmp", ">", mu, 0), ("not", ("cmp", ">=", asys, 1))),
            ("or",
             ("and", ("cmp", "<", n, 2), ("isnull", asys, False)),
             ("and", ("cmpref", "<=", asys, mu),
              ("and", ("isnull", mu, True),
               ("or", ("cmp", "=", ("dim", 1), 3),
                ("and", ("cmp", "!=", ("dim", 0), 5), ("cmp", "=", mu, 4)))))))
    lits = t(np.array([99.5, 60.0, 2.0, 3.0, np.nan, 5.0]))
    return tree, refs, lits, t(presence)


# The select stage (TileProgram.device_select: K13, then K7) at the main
# path's query shapes.  The live HAVING queries (`having_queries` on the
# live phase's region): 4000 + LIVE_NEW_HOSTS hosts, a tag card of 4096,
# over a 12 h window ending LIVE_MINUTES past the hour, 13 hour buckets (14
# after quantize_soft): G = 4096 x 14.  groupby-orderby-limit: 720 minute
# buckets (768), ORDER BY minute DESC LIMIT 5, no HAVING.
SELECT_CARD, SELECT_BUCKETS = 4096, 14
SELECT_MU, SELECT_AS, SELECT_N = (("agg", "usage_user", "max"), ("agg", "usage_system", "avg"),
                                  ("agg", "__count_star", "count"))
SELECT_QUERIES = ("groupby-orderby-limit", "having-or-orderby-limit", "having-and-not")
HAVING_TREES = {
    "having-or-orderby-limit": ("or", ("cmp", ">", SELECT_MU, 0), ("cmp", "<", SELECT_N, 1)),
    "having-and-not": ("and", ("cmp", ">", SELECT_MU, 0),
                       ("not", ("cmp", ">=", SELECT_AS, 1))),
}
HAVING_LITERALS = {"having-or-orderby-limit": (99.0, 300.0), "having-and-not": (99.5, 60.0)}


def select_states(dev, seed: int = SEED):
    """Finalized [G] states of the live HAVING queries' shape: presence
    (360 rows a full host-hour, 180 in the partial ones, 0 in the padded
    groups, a few at random), max(usage_user) and avg(usage_system) (f64,
    NaN in a few groups and the empty ones; no count plane: the columns
    are not nullable).  Returns (G, presence, mu, asys)."""
    import torch

    rng = np.random.default_rng(seed)
    G = SELECT_CARD * SELECT_BUCKETS
    host, bucket = np.arange(G) // SELECT_BUCKETS, np.arange(G) % SELECT_BUCKETS
    presence = np.where((bucket == 0) | (bucket == 12), 180, 360)
    presence[(bucket == 13) | (host >= 4000 + LIVE_NEW_HOSTS)] = 0
    presence = np.where(rng.random(G) < 0.01, rng.integers(1, 300, G), presence).astype(np.int32)
    mu = np.round(rng.uniform(90, 100, G), 1)
    mu[rng.random(G) < 0.002] = np.nan
    asys = rng.uniform(0, 100, G)
    asys[rng.random(G) < 0.002] = np.nan
    mu[presence == 0], asys[presence == 0] = np.nan, np.nan
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return G, t(presence), t(mu), t(asys)


def select_program(kind: str):
    """A TileProgram whose device_select is the one of query `kind`."""
    from greptimedb_tpu_torch.parallel.executor import DistGroupByPlan
    from greptimedb_tpu_torch.parallel.tile_program import TileProgram
    from greptimedb_tpu_torch.query.device_finalize import DeviceFinalizeSpec

    if kind == "groupby-orderby-limit":
        plan = DistGroupByPlan(group_tags=(), tag_cards=(), bucket_col="ts", bucket_origin=0,
                               bucket_interval=60_000, n_buckets=768,
                               agg_specs=(("max", "usage_user"),), ts_col="ts")
        spec = DeviceFinalizeSpec(order=((("dim", 0), False, True),), limit=5, cap=5)
        return TileProgram(plan, (), spec)
    plan = DistGroupByPlan(group_tags=("hostname",), tag_cards=(SELECT_CARD,), bucket_col="ts",
                           bucket_origin=0, bucket_interval=H3600, n_buckets=SELECT_BUCKETS,
                           agg_specs=(("max", "usage_user"), ("avg", "usage_system"),
                                      ("count", "__count_star")), ts_col="ts")
    if kind == "having-or-orderby-limit":
        spec = DeviceFinalizeSpec(order=((SELECT_MU, False, True),), having=HAVING_TREES[kind],
                                  n_having_values=2, limit=10, cap=10)
    else:  # no LIMIT: the cap bounds the non-empty groups (quantize_soft(4096 x 13))
        spec = DeviceFinalizeSpec(having=HAVING_TREES[kind], n_having_values=2,
                                  cap=SELECT_CARD * SELECT_BUCKETS)
    return TileProgram(plan, (), spec)


class _NoCounts:
    """A merged state without a count plane (a column that is not nullable)."""

    counts = None


def select_inputs(kind: str, dev, states=None):
    """(program, its device_select's arguments (merged, outs, presence,
    hv), the plain version's (mask, keys, cap)) of query `kind`."""
    import torch

    from greptimedb_tpu_torch.ops import aggregate as agg

    prog = select_program(kind)
    spec = prog.spec
    hv = torch.tensor(HAVING_LITERALS.get(kind, (0.0,)), dtype=torch.float64, device=dev)
    if kind == "groupby-orderby-limit":
        pres = torch.where(torch.arange(768, device=dev) < 690, 360, 0).to(torch.int32)
        merged = {"usage_user": _NoCounts(), "__presence": _NoCounts()}
        outs = {"__presence": {"count": pres},
                "usage_user": {"max": torch.zeros(768, dtype=torch.float64, device=dev)}}
        keys = [(torch.arange(768, dtype=torch.int64, device=dev), None, False, True)]
        return prog, (merged, outs, pres, hv), (pres > 0, keys, spec.cap)
    _g, pres, mu, asys = states if states is not None else select_states(dev)
    merged = {"usage_user": _NoCounts(), "usage_system": _NoCounts(), "__presence": _NoCounts()}
    outs = {"__presence": {"count": pres}, "usage_user": {"max": mu}, "usage_system": {"avg": asys}}
    refs = {SELECT_MU: agg.HavingRef(values=mu, nan_null=True),
            SELECT_AS: agg.HavingRef(values=asys, nan_null=True),
            SELECT_N: agg.HavingRef(values=pres)}
    mask = agg.having_mask_plain(spec.having, refs, hv, pres)
    keys = [(mu, torch.isnan(mu), asc, nf) for _ref, asc, nf in spec.order]
    return prog, (merged, outs, pres, hv), (mask, keys, spec.cap)


# The select stage's kernels, by their names on the card
SELECT_KERNELS = ("having_kernel", "topk_select_kernel", "topk_compact_kernel",
                  "topk_round_kernel")


def run_select_stage(dev, reps: int, states) -> dict:
    """TileProgram.device_select at SELECT_QUERIES' shapes, as the tile
    program calls it: each output byte for byte its plain version (twice),
    the time a median of five with its device split and host enqueue.
    Fails unless one call puts on the card exactly the kernels planned —
    K13 where there is a HAVING, then K7 as `topk_launch_plan` launches it
    — and no memset, no copy and no other kernel."""
    from greptimedb_tpu_torch.ops import aggregate as agg

    out = {}
    for q in SELECT_QUERIES:
        prog, args, (mask, keys, cap) = select_inputs(q, dev, states)
        fn = lambda prog=prog, args=args: prog.device_select(*args)  # noqa: E731
        ks, kn = _twice_identical(fn, f"device_select {q}")
        ps, pn = agg.topk_group_select_plain(mask, keys, cap)
        _compare(ks, ps, True, f"device_select {q}.sel")
        _compare(kn, pn, True, f"device_select {q}.n_out")
        g = int(mask.shape[0])
        planned = int(prog.spec.having is not None) + len(
            agg.topk_launch_plan(g, cap, len(prog.spec.order)))
        api = _runtime_calls(fn)
        ops = _device_ops(fn, calls=3)
        launched = sum(n for key, (_us, n) in ops.items() if _kernel_name(key) in SELECT_KERNELS)
        other = [key for key in ops if _kernel_name(key) not in SELECT_KERNELS]
        if other or launched != 3 * planned or sum(api.values()) != planned \
                or any(not key.startswith("cudaLaunch") for key in api):
            raise AssertionError(f"device_select {q}: {planned} kernels planned a call; runtime "
                                 f"calls {api}, device ops of 3 calls {ops}")
        out[q] = dict(groups=g, cap=cap, kernels_per_call=planned, **_timed_runs(fn, reps),
                      enqueue_us=_enqueue_us(fn, reps),
                      device_us={_kernel_name(k): us / n for k, (us, n) in ops.items() if n})
        emit({"phase": "select_stage", "query": q, **out[q]})
    return out


def run_plane_edge_cases(dev) -> None:
    """K13-K16 on the inputs that make them hard, against their plain
    versions, twice each: keys with ties, negatives, INT64_MIN/MAX and
    interleaved invalid rows over two uneven chunks (up to 8 radix
    passes), no valid row; element sizes 1/4/8 gathered over small
    chunks; codes in [-n-2, n+2) remapped; deltas at the edges of chunks
    and of the old rows and in a run across a tile bound, over chunks of a
    tile, one chunk and 5000 rows (not a multiple of the tile); a HAVING
    tree of one node of each kind."""
    import torch

    from greptimedb_tpu_torch.ops import aggregate as agg
    from greptimedb_tpu_torch.ops import permute as P

    rng = np.random.default_rng(29)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    imax, imin = np.iinfo(np.int64).max, np.iinfo(np.int64).min
    below = rng.integers(-7, (1 << 32) - 9, 3 * 4096 + 1000)
    below[:3] = [-7, (1 << 32) - 9, -6]  # the largest key, hi - lo + 1, is 2^32 - 1: u32 keys
    past = rng.integers(-7, (1 << 32) + 7, 3 * 4096 + 1000)
    past[:3] = [-7, (1 << 32) + 6, -6]  # past 2^32: u64 keys
    cases = {
        "ties": rng.integers(-5, 5, 3 * 4096),
        "wide": rng.integers(imin, imax, 3 * 4096, dtype=np.int64),
        "edges": np.array([imax, imin, 0, -1, imax, imin + 1, imax - 1] * 1755 + [7] * 3),
        "one": np.array([42] * 4096),
        "below 2^32": below,
        "past 2^32": past,
        "ragged": rng.integers(0, 43_200_000, 3 * 4096 + 1000),
        "below one tile": rng.integers(-1000, 1000, 100),
        "one row": np.array([5]),
        "no row": np.zeros(0),
    }
    for name, ts_np in cases.items():
        ts_np = ts_np.astype(np.int64)
        for p_valid in (1.0, 0.7, 0.0):
            v_np = rng.random(ts_np.size) < p_valid
            if name in ("below 2^32", "past 2^32") and p_valid:
                v_np[:3] = True
            for chunk in (4096, 8192, 1 << 24):
                ts_c = _chunked(t(ts_np), chunk) or [t(ts_np)]
                v_c = _chunked(t(v_np), chunk) or [t(v_np)]
                k = _twice_identical(lambda: P.ts_argsort(ts_c, v_c), f"edge argsort {name}")
                _compare_bytes(k, P.ts_argsort_plain(ts_c, v_c),
                               f"edge ts_argsort {name} valid={p_valid} chunk={chunk}")
        if name in ("below 2^32", "past 2^32"):
            want = 4 if name == "below 2^32" else 8
            P.ts_argsort([t(ts_np)], [t(np.ones(ts_np.size, bool))])
            got = P.ts_argsort.last_sort["key_bytes"]
            if got != want:
                raise AssertionError(f"edge ts_argsort {name}: {got}-byte keys, expected {want}")
    n = 3 * 4096 + 1000
    perm = t(rng.permutation(n).astype(np.int32))
    xs = [t(rng.integers(0, 200, n).astype(dtype))
          for dtype in (np.float64, np.int32, np.int64, np.bool_, np.uint8)]
    for x in xs:
        for chunk in (4096, 1 << 24):
            xc = _chunked(x, chunk)
            k = _twice_identical_chunks(lambda: P.gather_planes(xc, perm), "edge gather")
            _same_chunks(k, P.gather_planes_plain(xc, perm), f"edge gather {x.dtype}")
    # the multi-plane gather over mixed 1/4/8 B planes: chunks of a power of
    # two (a shift) and not (a 32-bit division), a ragged last chunk, one
    # chunk and 52; then 40 planes of 64 chunks, which pass the descriptor
    # and split into launches as planned
    for chunk in (4096, 5000, 256, 1 << 24):
        _multi_gather_case(P, [_chunked(x, chunk) for x in xs], perm,
                           f"edge gather_planes_multi chunk={chunk}")
    m64 = 64 * 200 - 77
    perm_m = t(rng.permutation(m64).astype(np.int32))
    many = [_chunked(t(rng.integers(0, 200, m64).astype(dt)), 200)
            for dt in (np.float64, np.int32, np.bool_, np.int64) * 10]
    if len(P.gather_launch_plan(len(many), len(many[0]))) < 2:
        raise AssertionError("40 planes of 64 chunks must pass K15's descriptor")
    _multi_gather_case(P, many, perm_m, "edge gather_planes_multi 40 planes x 64 chunks")
    m = 4000
    table = t(rng.permutation(m + 96)[:m].astype(np.int32))
    codes = t(rng.integers(-m - 2, m + 2, n).astype(np.int32))
    for chunk in (4096, 1 << 24):
        cc = _chunked(codes, chunk)
        k = _twice_identical_chunks(lambda: P.gather_planes(cc, table, remap=True), "edge remap")
        _same_chunks(k, P.gather_planes_plain(cc, table, remap=True), "edge remap")
    empty_table = t(np.zeros(0, np.int32))
    _same_chunks(P.gather_planes(_chunked(codes, 4096), empty_table, remap=True),
                 P.gather_planes_plain(_chunked(codes, 4096), empty_table, remap=True),
                 "edge remap empty table")
    for old_n in (1, 4096, 8191, 3 * 4096 + 5):
        old = t(rng.uniform(-1, 1, old_n + 7))
        for n_delta in (0, 1, 4095, 5000):
            d = t(rng.uniform(-1, 1, n_delta))
            for kind in ("random", "front", "back", "boundary", "tile run"):
                if kind == "random":
                    p = np.sort(rng.integers(0, old_n + 1, n_delta))
                elif kind == "front":
                    p = np.zeros(n_delta, np.int64)
                elif kind == "back":
                    p = np.full(n_delta, old_n, np.int64)
                elif kind == "boundary":
                    p = np.sort(rng.choice([0, 1, 4095, 4096, old_n], n_delta)).clip(0, old_n)
                else:  # the delta rows one run from output row 4000 on, across a tile bound
                    p = np.full(n_delta, min(4000, old_n), np.int64)
                pos = t(p.astype(np.int32))
                new_pad = -(-(old_n + n_delta) // 4096) * 4096 + 4096
                # chunks of a tile and one chunk (f64); chunks no multiple
                # of the tile, the last tile of each chunk shorter, at every
                # element size (a bool chunk starts off the 16 B vector)
                for chunk, planes in ((4096, ((old, d),)), (1 << 24, ((old, d),)),
                                      (5000, ((old, d), ((old * 1e6).to(torch.int32),
                                                         (d * 1e6).to(torch.int32)),
                                              (old > 0, d > 0)))):
                    for o_plane, d_plane in planes:
                        args = (_chunked(o_plane, chunk), old_n, d_plane, pos, new_pad, chunk)
                        k = _twice_identical_chunks(lambda: P.delta_patch(*args), "edge patch")
                        _same_chunks(k, P.delta_patch_plain(*args),
                                     f"edge delta_patch old={old_n} delta={n_delta} {kind} "
                                     f"chunk={chunk} {o_plane.dtype}")
    for G in (1, 255, 257, 5000):
        tree, refs, lits, presence = having_case(G, dev, G)
        subtrees = [tree, tree[1], tree[2], tree[1][2], tree[2][1][2],
                    ("and", ("isnull", ("agg", "s", "avg"), False),
                     ("isnull", ("agg", "s", "avg"), False))]
        for sub in subtrees:
            k = _twice_identical(lambda: agg.having_mask(sub, refs, lits, presence), "edge having")
            _compare(k, agg.having_mask_plain(sub, refs, lits, presence), True,
                     f"edge having_mask G={G}")
    emit({"phase": "plane_edge_cases", "ok": True})


# ---- phase 3f: the guards decided on the card ----------------------------------------


def _same_state(a, b, what: str) -> None:
    for name, x, y in zip(("sums", "counts", "mins", "maxs", "last_ts", "last_val"),
                          _state_tensors(a), _state_tensors(b)):
        if (x is None) != (y is None) or (x is not None and not _same_bytes(x, y)):
            raise AssertionError(f"{what}.{name}: the bytes differ")


def run_guard_kernel_phase(n_hosts: int, hours: int, reps: int, dev=None) -> dict:
    """Phase 3f: K2 and K6 behind their layout guards with no host read —
    both branches launched, each predicated on the guard's word on the
    card — at the main path's shapes (17.28 M rows, 10 columns): the
    double-groupby ids (host x hour: the guard passes) and minute buckets
    over the host-major layout (it fails).  Each is held byte for byte
    against the host-driven form (the verdict read on the host, then only
    the taken branch: K2's fold, or K18 + K3; the guard computed by its
    plain version, then K6 or its slow branch alone) and against its plain
    version (K2's sums within rel 1e-12, the order inside a block differs,
    the rest exact; K6 byte for byte against the plain version run on the
    host, whose f64 adds run in the kernel's order), twice, and all three
    are timed; then the falling-bases shape (`run_falling_case`).  K18, the flag-reading sort of
    the K3 branch, is held against torch.sort (its plain version) on the
    failing shape.  K17's single cooperative call is phase 3e's.  The
    planes are padded to a multiple of 4096 rows, as the tile path holds
    them (K5/K6 take whole blocks)."""
    import torch

    from greptimedb_tpu_torch.ops import aggregate as agg
    from greptimedb_tpu_torch.ops import filter as flt
    from greptimedb_tpu_torch.ops.tiles import pad_rows

    dev = torch.device("cuda", 0) if dev is None else dev
    n, codes, ts, valid, vals = tsbs_planes(n_hosts, hours, 10, dev)
    n = pad_rows(n)
    codes, ts, valid = _padded(codes, n, 0), _padded(ts, n, 0), _padded(valid, n, False)
    vals = [_padded(v, n, 0.0) for v in vals]
    card = 1 << (max(n_hosts, 1) - 1).bit_length()
    lo, hi = T0, T0 + hours * H3600
    n_min = hours * 60
    shapes = {
        "pass": flt.mask_gids(valid, [(ts, ">=", lo), (ts, "<", hi)], [], [(codes, card)],
                              (ts, T0, H3600, hours), card * hours - 1) + (card * hours,),
        "fail": flt.mask_gids(valid, [(ts, "<", hi - 1800_000)], [], [],
                              (ts, T0, 60_000, n_min), n_min - 1) + (n_min,),
    }
    aggs = ("count", "max", "min", "sum")
    out: dict[str, dict] = {}

    def k2_host_driven(g, m, G):
        verdict, st, _b = agg.segment_reduce_blocked(vals, g, [m] * 10, m, G, aggs)
        if _passed(verdict):
            return st
        return agg.segment_reduce_scatter(vals, g, [m] * 10, m, G, aggs)

    lcols = [agg.quantize_limbs(v) for v in vals]

    def k6_host_driven(g, m, G):
        ok, _base = agg.block_guard_plain(g, m, G)
        if ok:
            return agg.limb_segment_sums(lcols, g, m, G)
        return agg.limb_segment_runs(lcols, g, m, G)

    for case, (g, m, G) in shapes.items():
        ok, _base = agg.block_guard_plain(g, m, G)
        if ok != (case == "pass"):
            raise AssertionError(f"3f {case}: the guard verdict is {ok}")
        k = _twice_identical(lambda: agg.segment_aggregate_multi(vals, g, G, aggs, [m] * 10, m),
                             f"3f K2 {case}")
        _same_state(k, k2_host_driven(g, m, G), f"3f K2 {case} vs host-driven")
        if ok:
            p = agg.segment_reduce_blocked_plain(vals, g, [m] * 10, m, G, aggs)[1]
        else:
            p = agg.segment_reduce_scatter_plain(vals, g, [m] * 10, m, G, aggs)
        e2 = _check_state(k, p, f"3f K2 {case} vs plain")
        kb, kby = bound(n * (4 + 1 + 8 * 10) + 10 * G * 28, n * 10 * len(aggs))
        out[f"k2_{case}"] = dict(
            max_abs_err=e2, rows=n, groups=G,
            ms=_timed(lambda: agg.segment_aggregate_multi(vals, g, G, aggs, [m] * 10, m), reps),
            host_driven_ms=_timed(lambda: k2_host_driven(g, m, G), reps),
            plain_ms=_timed(lambda: (agg.segment_reduce_blocked_plain if ok else
                                     agg.segment_reduce_scatter_plain)(
                vals, g, [m] * 10, m, G, aggs), 1),
            bound_ms=kb, bound_by=kby,
        )
        k6 = _twice_identical(lambda: agg.limb_segment_sums(lcols, g, m, G), f"3f K6 {case}")
        for a, b, w in zip(k6, k6_host_driven(g, m, G), ("sums", "errs", "counts", "presence")):
            if (a is None) != (b is None) or (a is not None and not _same_bytes(a, b)):
                raise AssertionError(f"3f K6 {case} vs host-driven: {w} differs")
        # the plain version on the host: its f64 adds run in block (pass)
        # or row (fail) order, as the kernel's do
        e6 = _same_limb_sums(k6, _plain_on_host(agg.limb_segment_sums_plain, lcols, g, m, G),
                             f"3f K6 {case} vs plain")
        nb = -(-n // agg.BLOCK_ROWS)
        b6, b6by = bound(n * (4 + 1 + 8 * 10) + nb * 80 + G * (10 * 16 + 4), n * 10 * 4)
        out[f"k6_{case}"] = dict(
            max_abs_err=e6, rows=n, groups=G,
            ms=_timed(lambda: agg.limb_segment_sums(lcols, g, m, G), reps),
            host_driven_ms=_timed(lambda: k6_host_driven(g, m, G), reps),
            plain_ms=_timed(lambda: agg.limb_segment_sums_plain(lcols, g, m, G), 1),
            bound_ms=b6, bound_by=b6by,
        )
        emit({"phase": "guard_kernels", "case": case, "k2": out[f"k2_{case}"],
              "k6": out[f"k6_{case}"]})
    # K18 on the failing shape: the ids and mask read once, the sorted ids
    # and rows written once; a compare and a select per row
    g, m, G = shapes["fail"]
    ks = _twice_identical(lambda: agg.sort_segments(g, m, G), "3f K18")
    ps = agg.sort_segments_plain(g, m, G)
    if not (_same_bytes(ks[0], ps[0]) and _same_bytes(ks[1], ps[1])):
        raise AssertionError("3f K18: the sort differs from torch.sort's")
    sb, sby = bound(n * (4 + 1) + n * (4 + 8), n * 2)
    plain_ms = _timed(lambda: agg.sort_segments_plain(g, m, G), reps)
    out["segment_sort"] = dict(
        max_abs_err=0.0, rows=n, groups=G,
        **_timed_sort(agg.sort_segments, lambda: agg.sort_segments(g, m, G), reps),
        plain_ms=plain_ms, bound_ms=sb, bound_by=sby, library_ms=plain_ms,
    )
    emit({"phase": "segment_sort", **out["segment_sort"]})
    del vals, lcols, shapes, codes, ts, valid
    torch.cuda.empty_cache()
    out.update(run_falling_case(n_hosts, reps, dev))
    run_sort_edge_cases(dev)
    return out


def _same_limb_sums(k, p, what: str) -> float:
    """K6's four outputs against its plain version's, byte for byte."""
    for name, a, b in zip(("sums", "errs", "counts", "presence"), k, p):
        if (a is None) != (b is None) or (a is not None and not _same_bytes(a, b)):
            bad = -1 if a is None or b is None else int((a != b).sum())
            raise AssertionError(f"{what}.{name}: {bad} entries differ from the plain version")
    return 0.0


# Hours of phase 3f's falling-bases planes.  At 10 s a host holds 360 rows
# an hour, so over 12 h (4320 rows) nearly every 4096-row block holds some
# host's first hour and its base is 0; over 16 h (5760 rows) a block inside
# one host starts at its own hour and the next, crossing into the next
# host, at 0 (1374 of 5625 bases fall at 4000 hosts).
FALL_HOURS = 16
LIBRARY_SORT_NAMES = ("cub", "Radix", "DeviceSort")


def _kernel_name(key: str) -> str:
    """A profiler key's kernel name, without its return type, template and
    parameter lists ("void ns::k<T>(A, B)" -> "ns::k")."""
    name = key.split("(")[0].split("<")[0]
    return name.split(" ")[-1]


def _device_kernels(fn) -> dict[str, float]:
    """{CUDA kernel or memset name: device us} of one fn() under
    torch.profiler."""
    return {k: us for k, (us, _n) in _device_ops(fn).items() if us}


def run_falling_case(n_hosts: int, reps: int, dev) -> dict:
    """Phase 3f's falling-bases shape: the TSBS planes over FALL_HOURS
    grouped by `date_bin('1 hour', ts)` alone (G = 16), column 0 in blocks
    of other magnitudes (so K5's scales differ and a group's sum shows the
    order of its adds).  The guard passes and the bases fall at each host.
    K6 and K4 equal their plain versions byte for byte (K6's on the host,
    whose f64 adds run in block order), K2 within rel 1e-12 with count, min
    and max exact; each twice.  Under torch.profiler one K2, one K4 and one
    K6 call launch no library sort kernel (cub, Radix, DeviceSort); the
    phase fails otherwise."""
    import torch

    from greptimedb_tpu_torch.ops import aggregate as agg
    from greptimedb_tpu_torch.ops import filter as flt
    from greptimedb_tpu_torch.ops.tiles import pad_rows

    H = FALL_HOURS
    n, codes, ts, valid, vals = tsbs_planes(n_hosts, H, 10, dev)
    n = pad_rows(n)
    ts, valid = _padded(ts, n, 0), _padded(valid, n, False)
    vals = [_padded(v, n, 0.0) for v in vals]
    del codes
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    mag = torch.exp(torch.rand(n // agg.BLOCK_ROWS, generator=gen, device=dev,
                               dtype=torch.float64) * 40.0 - 20.0)
    vals[0] = vals[0] * mag.repeat_interleave(agg.BLOCK_ROWS)
    g, m = flt.mask_gids(valid, [], [], [], (ts, T0, H3600, H), H - 1)
    ok, pbase = agg.block_guard_plain(g, m, H)
    falls = int((pbase[1:] < pbase[:-1]).sum())
    if not ok or falls == 0:
        raise AssertionError(f"3f falling: guard {ok}, {falls} falling bases")
    aggs = ("count", "max", "min", "sum")
    cm = [m] * 10
    verdict, k2, base = _twice_identical(
        lambda: agg.segment_reduce_blocked(vals, g, cm, m, H, aggs), "3f K2 falling")
    if not _passed(verdict):
        raise AssertionError("3f falling: K2's guard failed")
    e2 = _check_state(k2, agg.segment_reduce_blocked_plain(vals, g, cm, m, H, aggs)[1],
                      "3f K2 falling vs plain")
    lcols = [agg.quantize_limbs(v) for v in vals]
    k6 = _twice_identical(lambda: agg.limb_segment_sums(lcols, g, m, H), "3f K6 falling")
    _same_limb_sums(k6, _plain_on_host(agg.limb_segment_sums_plain, lcols, g, m, H),
                    "3f K6 falling vs plain")
    k4 = _twice_identical(lambda: agg.segment_last(vals[1], ts, g, m, H, base=base),
                          "3f K4 falling")
    p4 = agg.segment_last_plain(vals[1], ts, g, m, H, base=base)
    if not (_same_bytes(k4[0], p4[0]) and _same_bytes(k4[1], p4[1])):
        raise AssertionError("3f K4 falling: differs from the plain version")
    calls = {
        "K2": lambda: agg.segment_reduce_blocked(vals, g, cm, m, H, aggs),
        "K4": lambda: agg.segment_last(vals[1], ts, g, m, H, base=base),
        "K6": lambda: agg.limb_segment_sums(lcols, g, m, H),
    }
    launched = {}
    for name, fn in calls.items():
        launched[name] = _device_kernels(fn)
        sorts = [k for k in launched[name]
                 if any(w in _kernel_name(k) for w in LIBRARY_SORT_NAMES)]
        if sorts:
            raise AssertionError(f"3f {name}: a library sort ran: {sorts}")
    nb = n // agg.BLOCK_ROWS
    out = {
        "k2_falling": dict(
            max_abs_err=e2, rows=n, groups=H, falls=falls,
            ms=_timed(calls["K2"], reps), device_us=launched["K2"],
            bound_ms=bound(n * (4 + 1 + 8 * 10) + 10 * H * 28, n * 10 * len(aggs))[0]),
        "k6_falling": dict(
            max_abs_err=0.0, rows=n, groups=H, ms=_timed(calls["K6"], reps),
            device_us=launched["K6"],
            bound_ms=bound(n * (4 + 1 + 8 * 10) + nb * 80 + H * (10 * 16 + 4), n * 10 * 4)[0]),
        "k4_falling": dict(
            max_abs_err=0.0, rows=n, groups=H, ms=_timed(calls["K4"], reps),
            device_us=launched["K4"],
            bound_ms=bound(n * (4 + 1 + 8) + H * (8 + 8 + 8), n * 2)[0]),
    }
    emit({"phase": "guard_kernels", "case": "falling", **out})
    return out


def _same_sort(got, g, m, G: int, what: str) -> None:
    from greptimedb_tpu_torch.ops import aggregate as agg

    want = agg.sort_segments_plain(g, m, G)
    _compare_bytes(got[0], want[0], f"{what} ids")
    _compare_bytes(got[1], want[1], f"{what} rows")


def run_sort_edge_cases(dev) -> None:
    """K18 (radix.cuh's one-sweep sort) against its plain version, byte for
    byte and twice: n = 0, below one tile, on and off the tile size; G + 1
    at every digit and pass boundary of `radix_plan` up to 2^31 - 1 and G
    = 2^24; every row masked and one id for every row (all rows in one
    digit of every pass: the longest look-back) at 2^22 + 5 rows; a shut
    gate leaves given outputs as they were; the sort captured once in a
    CUDA graph and replayed twice on new inputs."""
    import torch

    from greptimedb_tpu_torch.ops import aggregate as agg

    rng = np.random.default_rng(SEED + 18)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731

    def case(n: int, G: int):
        gids = rng.integers(-3, G + 3, n, dtype=np.int64).astype(np.int32)
        gids[: n // 3] = rng.integers(0, min(G, 7) + 1, n // 3)
        return t(gids), t(rng.random(n) < 0.8)

    bounds = (0, 1, 2, 255, 256, 720, 1023, 1024, 2047, 2048, (1 << 16) - 1, 1 << 16,
              (1 << 22) - 1, 1 << 22, 1 << 24, (1 << 31) - 1)
    for n in (0, 1, 100, 4095, 4096, 4097, 3 * 4096 + 1000):
        for G in bounds:
            g, m = case(n, G)
            got = _twice_identical(lambda: agg.sort_segments(g, m, G), f"edge K18 n={n} G={G}")
            _same_sort(got, g, m, G, f"edge K18 n={n} G={G}")
    for G in (720, 2048, 1 << 24):
        g, m = case(1_000_003, G)
        _same_sort(_twice_identical(lambda: agg.sort_segments(g, m, G), "edge K18 1M"), g, m, G,
                   f"edge K18 n=1000003 G={G}")
    n = (1 << 22) + 5
    for G in (720, 1 << 24):
        for what, g, m in (
                ("all masked", t(rng.integers(0, G, n).astype(np.int32)),
                 torch.zeros(n, dtype=torch.bool, device=dev)),
                ("one id", torch.full((n,), 7, dtype=torch.int32, device=dev),
                 torch.ones(n, dtype=torch.bool, device=dev))):
            got = _twice_identical(lambda: agg.sort_segments(g, m, G), f"edge K18 {what}")
            _same_sort(got, g, m, G, f"edge K18 {what} G={G}")
    # the gate: shut (the guard passed: 0) leaves the outputs alone; open
    # (it failed) sorts
    for G, verdict in itertools.product((720, 1 << 24), (0, 1)):
        g, m = case(3 * 4096 + 1000, G)
        word = torch.full((1,), verdict, dtype=torch.int32, device=dev)
        out = (torch.full(g.shape, -7, dtype=torch.int32, device=dev),
               torch.full(g.shape, -9, dtype=torch.int64, device=dev))
        agg._segment_sort_into(g, m, G, word, *out)
        torch.cuda.synchronize()
        if verdict:
            _same_sort(out, g, m, G, f"edge K18 gate open G={G}")
        elif not (bool((out[0] == -7).all()) and bool((out[1] == -9).all())):
            raise AssertionError(f"edge K18 G={G}: a shut gate wrote the outputs")
    # one capture, two replays on new inputs (1 and 3 passes)
    for G in (720, 1 << 24):
        sg, sm = case(1_000_003, G)
        word = torch.ones(1, dtype=torch.int32, device=dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            agg.sort_segments(sg, sm, G, verdict=word)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            res = agg.sort_segments(sg, sm, G, verdict=word)
        for replay in range(2):
            g, m = case(1_000_003, G)
            sg.copy_(g)
            sm.copy_(m)
            graph.replay()
            torch.cuda.synchronize()
            _same_sort(res, g, m, G, f"edge K18 graph G={G} replay {replay}")
        del graph, res
    emit({"phase": "sort_edge_cases", "ok": True})


# ---- phase 3e: the hash group-by's kernels at H1's shape ---------------------------

# The container-metrics configuration of phase 7 (cAdvisor's
# container_memory_working_set_bytes at the 30 s interval of
# kube-prometheus's kubelet ServiceMonitor).  The cluster shape — 100
# namespaces, 40 pods each, 2 containers per pod drawn from 20 names — and
# the 6 h window are assumed, not taken from a published deployment
CM_NAMESPACES, CM_PODS_PER_NS, CM_CONTAINERS_PER_POD, CM_CONTAINER_NAMES = 100, 40, 2, 20
CM_SCRAPE_S, CM_HOURS, CM_BUCKET_MS = 30, 6, 300_000
CM_TABLE = "container_memory_working_set_bytes"
CM_KEYS = ("namespace", "pod", "container", "tb")


def container_series(seed: int = SEED):
    """(namespace index, pod index, container name index) of each of the
    8000 series, in (namespace, pod, container) order, which is the order
    of their codes: names are zero-padded, so code order is name order."""
    rng = np.random.default_rng(seed)
    n_pods = CM_NAMESPACES * CM_PODS_PER_NS
    pods = np.repeat(np.arange(n_pods), CM_CONTAINERS_PER_POD)
    conts = np.sort(np.stack([rng.choice(CM_CONTAINER_NAMES, CM_CONTAINERS_PER_POD, replace=False)
                              for _ in range(n_pods)]), axis=1).reshape(-1)
    return pods // CM_PODS_PER_NS, pods, conts


def container_planes(hours: int, dev):
    """Device planes of the container table as the super-tile holds them
    ((namespace, pod, container, ts) order, padded to a multiple of 4096
    rows): namespace, pod and container codes, ts, valid."""
    import torch

    from greptimedb_tpu_torch.ops.tiles import pad_rows

    ns, pod, cont = container_series()
    ticks = hours * 3600 // CM_SCRAPE_S
    n = ns.size * ticks
    npad = pad_rows(n)

    def per_row(a):
        t = torch.from_numpy(a.astype(np.int32)).to(dev).repeat_interleave(ticks)
        return _padded(t, npad, 0)

    ts = T0 + torch.arange(ticks, dtype=torch.int64, device=dev).repeat(ns.size) * (CM_SCRAPE_S * 1000)
    valid = _padded(torch.ones(n, dtype=torch.bool, device=dev), npad, False)
    return n, per_row(ns), per_row(pod), per_row(cont), _padded(ts, npad, 0), valid


def h1_group_ids(hours: int, dev):
    """K1's int64 inputs of H1 over the planes: the window filter, the three
    tags at their quantized cards and the 5-minute bucket."""
    import torch

    from greptimedb_tpu_torch.parallel.tile_planner import quantize_soft

    n, ns, pod, cont, ts, valid = container_planes(hours, dev)
    n_buckets = quantize_soft(hours * 3600_000 // CM_BUCKET_MS)
    card = lambda k: 1 << (k - 1).bit_length()  # noqa: E731
    hi = T0 + hours * H3600
    args = (valid, [(ts, ">=", T0), (ts, "<", hi)], [],
            [(ns, card(CM_NAMESPACES)), (pod, card(CM_NAMESPACES * CM_PODS_PER_NS)),
             (cont, card(CM_CONTAINER_NAMES))],
            (ts, T0, CM_BUCKET_MS, n_buckets), None, torch.int64)
    return n, args


def run_hash_kernel_phase(reps: int) -> dict:
    """Phase 3e: K1's int64 mode, K17, K3 over slot ids and K8 over the
    slot rows at H1's shape (5.76 M rows, 2^24 slots), each against its
    plain version byte for byte (K3's sums within rel 1e-12) and twice;
    then the edge cases.  Returns name -> metrics for
    the kernels line."""
    import torch

    from greptimedb_tpu_torch.ops import aggregate as agg
    from greptimedb_tpu_torch.ops import filter as flt

    dev = torch.device("cuda", 0)
    n, k1_args = h1_group_ids(CM_HOURS, dev)
    npad = k1_args[0].shape[0]
    H = 1 << 24
    out: dict[str, dict] = {}

    gids, mask = _twice_identical(lambda: flt.mask_gids(*k1_args), "mask_gids int64")
    pg, pm = flt.mask_gids_plain(*k1_args)
    _compare_bytes(gids, pg, "mask_gids int64.gids")
    _compare_bytes(mask, pm, "mask_gids int64.mask")
    # valid, ts and three code planes read once, an 8-byte id and the mask
    # written; ~12 operations a row (2 compares, the floor division, 4
    # clipped mixed-radix steps)
    b1, b1_by = bound(npad * (1 + 8 + 3 * 4) + npad * (8 + 1), npad * 12)
    # as the hash tile program calls it (`lits` a view of an uploaded
    # buffer), and with the table uploaded each call (`upload`)
    from greptimedb_tpu_torch.kernels._build import upload_table

    lo, hi = (v for _p, _op, v in k1_args[1])
    _ts, origin, interval, _nb = k1_args[4]
    lits = upload_table(flt.literal_table([(torch.int64, ">=", lo), (torch.int64, "<", hi)],
                                          origin, interval) + [0], dev)[:-1]
    tile = lambda: flt.mask_gids(*k1_args, lits=lits)  # noqa: E731
    tg, tm = _twice_identical(tile, "mask_gids int64 tile")
    _compare_bytes(tg, pg, "mask_gids int64 tile.gids")
    _compare_bytes(tm, pm, "mask_gids int64 tile.mask")
    del tg, tm
    out["mask_gids_int64"] = dict(
        max_abs_err=0.0, **_timed_runs(tile, reps),
        plain_ms=_timed(lambda: flt.mask_gids_plain(*k1_args), 1),
        bound_ms=b1, bound_by=b1_by, library_ms=None, rows=npad,
        upload=_timed_runs(lambda: flt.mask_gids(*k1_args), reps),
    )

    table = torch.empty(H, dtype=torch.int64, device=dev)

    def k17():
        return agg.hash_group_slots(table.fill_(agg.HASH_EMPTY), gids, mask)

    kt, ks, ko = _twice_identical(k17, "hash_group_slots")
    rounds = agg.last_hash_rounds()
    pt, ps, po = agg.hash_group_slots_plain(
        torch.full((H,), agg.HASH_EMPTY, dtype=torch.int64, device=dev), gids, mask)
    _compare_bytes(kt, pt, "hash_group_slots.table")
    _compare_bytes(ks, ps, "hash_group_slots.slots")
    _compare_bytes(ko, po, "hash_group_slots.overflow")
    if agg.last_hash_rounds() != rounds:
        raise AssertionError(f"hash_group_slots: {rounds} rounds, the plain version "
                             f"{agg.last_hash_rounds()}")
    if int(ko) != 0:
        raise AssertionError(f"hash_group_slots: {int(ko)} rows overflowed 2^24 slots at H1")
    occupied = int((kt != agg.HASH_EMPTY).sum())
    # ids (8 B) and mask (1 B) read, slots (4 B) written, the table read and
    # written once; per row and round a multiply, a shift, a compare and
    # the claim (~8 operations)
    b17, b17_by = bound(npad * (8 + 1 + 4) + H * 16, npad * rounds * 8)
    out["hash_group_slots"] = dict(
        max_abs_err=0.0, ms=_timed(k17, reps),
        plain_ms=_timed(lambda: agg.hash_group_slots_plain(
            torch.full((H,), agg.HASH_EMPTY, dtype=torch.int64, device=dev), gids, mask), 1),
        bound_ms=b17, bound_by=b17_by, library_ms=None, rows=npad, slots=H, rounds=rounds,
        occupied=occupied,
        # the timed call includes refilling the [2^24] table, as each query does
        fill_ms=_timed(lambda: table.fill_(agg.HASH_EMPTY), reps),
        **_call_ops(k17, agg.hash_group_slots, K17_KERNELS, "hash_group_slots",
                    caller_ops=("elementwise",),
                    bare=lambda: agg.hash_group_slots(table, gids, mask)),
    )

    # K3 over the slot ids: avg and max of one value column over [2^24]
    vals = torch.rand(npad, generator=torch.Generator(device=dev).manual_seed(SEED),
                      dtype=torch.float64, device=dev) * 2e9
    aggs = ("count", "max", "sum")
    s_st = _twice_identical(
        lambda: agg.segment_reduce_scatter([vals], ks, [mask], mask, H, aggs), "scatter over slots")
    e3 = _check_state(s_st, agg.segment_reduce_scatter_plain([vals], ks, [mask], mask, H, aggs),
                      "segment_reduce_scatter over slots")
    order_h = agg.sort_segments(ks, mask, H)
    _same_as_lanes(s_st, lambda: agg.segment_reduce_scatter_lanes([vals], [mask], mask, order_h, H,
                                                                  aggs),
                   "segment_reduce_scatter over slots")
    safe = torch.where(mask, ks, H).to(torch.int64)
    # slot ids, mask and values read once, [H] sums, counts and maxima written
    b3, b3_by = bound(npad * (4 + 1 + 8) + H * (8 + 4 + 8), npad * len(aggs))
    out["scatter_hash_slots"] = dict(
        max_abs_err=e3, ms=_timed(lambda: agg.segment_reduce_scatter([vals], ks, [mask], mask, H, aggs),
                                  reps),
        plain_ms=_timed(lambda: agg.segment_reduce_scatter_plain([vals], ks, [mask], mask, H, aggs), 1),
        alone_ms=_timed(lambda: agg.segment_reduce_scatter([vals], ks, [mask], mask, H, aggs,
                                                           order_h), reps),
        bound_ms=b3, bound_by=b3_by,
        library_ms=_timed(lambda: torch.zeros(H + 1, dtype=torch.float64, device=dev)
                          .index_add_(0, safe, vals), reps),
    )
    # K18 alone over the slot ids, the sort inside K3 at H1's shape: the ids
    # and mask read once, the sorted ids and rows written once
    k18 = _twice_identical(lambda: agg.sort_segments(ks, mask, H), "sort_segments over slots")
    _same_sort(k18, ks, mask, H, "sort_segments over slots")
    b18, b18_by = bound(npad * (4 + 1) + npad * (4 + 8), npad * 2)
    k18_plain = _timed(lambda: agg.sort_segments_plain(ks, mask, H), reps)
    out["sort_hash_slots"] = dict(
        max_abs_err=0.0, rows=npad, groups=H,
        **_timed_sort(agg.sort_segments, lambda: agg.sort_segments(ks, mask, H), reps),
        plain_ms=k18_plain, bound_ms=b18, bound_by=b18_by, library_ms=k18_plain,
    )
    del k18
    # K8 over the [2^24] slot rows as H1's program hands them: bit-packed
    # presence, the value's (sums, counts) shipped as f32 averages, its f64
    # max, and the overflow row
    pres = s_st.counts[0]
    packed = ([pres], [(s_st.sums[0], pres)], [("value", s_st.maxs[0])], True)
    k8 = _twice_identical(lambda: agg.pack_result(*packed, overflow=ko), "pack_result hash")
    p8 = agg.pack_result_plain(*packed, overflow=ko)
    _compare_bytes(k8[0], p8[0], "pack_result hash.buf")
    _compare_bytes(k8[1], p8[1], "pack_result hash.accs64")
    # presence (4 B), sums (8 B) and maxima (8 B) read, the overflow count;
    # presence bits, f32 averages (4 B) and the f64 row (8 B) written
    b8, b8_by = bound(H * (4 + 8 + 8) + 4 + H // 8 + H * (4 + 8) + 1, H * 3)
    out["pack_hash_slots"] = dict(
        max_abs_err=0.0, ms=_timed(lambda: agg.pack_result(*packed, overflow=ko), reps),
        plain_ms=_timed(lambda: agg.pack_result_plain(*packed, overflow=ko), 1),
        bound_ms=b8, bound_by=b8_by, library_ms=None,
    )
    emit({"phase": "hash_kernels", "rows": n, "slots": H, "rounds": rounds, "occupied": occupied,
          **{k: {m: v for m, v in d.items() if m in ("ms", "plain_ms", "bound_ms", "library_ms",
                                                     "passes", "key_bytes", "sort_launches")}
             for k, d in out.items()}})
    del gids, mask, table, kt, ks, pt, ps, vals, safe, k1_args, s_st, pres, packed, k8, p8, order_h
    torch.cuda.empty_cache()
    run_hash_edge_cases(dev)
    return out


def run_hash_edge_cases(dev) -> None:
    """K17 against its plain version on the card, byte for byte (table,
    slots, overflow, rounds) and twice: seeded ids at H = 1024 and 2^16, a
    table threaded through three sources, masked rows, a table that
    overflows, ids that share a home position, ids 0 and 2^62 - 1, 2^62 - 1
    and 2^62 - 2 contending for one empty position, ten-row runs of one id
    across warp boundaries, a 2^24 table threaded from an earlier source;
    K1's int64 mode with out-of-range codes
    and a space past 2^31; K3's sparse dispatch; K8's overflow byte."""
    import torch

    from greptimedb_tpu_torch.ops import aggregate as agg
    from greptimedb_tpu_torch.ops import filter as flt

    rng = np.random.default_rng(SEED)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    home = agg._hash_home(torch.arange(2_000_000, dtype=torch.int64, device=dev), 1024)
    cand = torch.arange(2_000_000, dtype=torch.int64, device=dev)
    shared = torch.cat([cand[home == 17][:60], cand[home == 1000][:40], cand[home == 1023][:30]])
    extreme = t(np.array([0, (1 << 62) - 1, (1 << 62) - 2, 1, 0, (1 << 62) - 1, 1 << 61, 5]))
    ones = lambda m: torch.ones(m, dtype=torch.bool, device=dev)  # noqa: E731
    largest = t(np.array([(1 << 62) - 1, (1 << 62) - 2, (1 << 62) - 1], np.int64))
    # runs of ten rows of one id from row 5 on: runs across every warp's edge
    runs = t(np.concatenate([np.full(5, 3), np.repeat(rng.integers(0, 1 << 40, 1000), 10)]))
    first = rng.integers(0, 1 << 40, 60_000)
    big = [t(rng.choice(first, 250_000)),
           t(np.concatenate([rng.choice(first, 150_000), rng.integers(0, 1 << 40, 150_000)]))]
    cases = {
        "seeded_1024": (1024, [(t(rng.integers(0, 400, 3000)), t(rng.random(3000) < 0.9))]),
        "seeded_65536": (1 << 16, [(t(rng.integers(0, 1 << 40, 40_000)),
                                    torch.ones(40_000, dtype=torch.bool, device=dev))]),
        "three_sources": (4096, [(t(rng.integers(0, 1800, m)), t(rng.random(m) < 0.8))
                                 for m in (5000, 1234, 7000)]),
        "masked": (1024, [(t(rng.integers(0, 50, 2000)), t(rng.random(2000) < 0.3))]),
        "overflow": (8, [(torch.arange(40, dtype=torch.int64, device=dev) * 7919,
                          torch.ones(40, dtype=torch.bool, device=dev))]),
        "shared_home": (1024, [(shared.repeat(3), torch.ones(3 * shared.numel(), dtype=torch.bool,
                                                             device=dev))]),
        "extreme_ids": (1024, [(extreme, torch.ones(8, dtype=torch.bool, device=dev)),
                               (extreme.flip(0).contiguous(),
                                torch.ones(8, dtype=torch.bool, device=dev))]),
        # 2^62 - 1 and 2^62 - 2 contend for the one empty position: the
        # smaller tag lands, the other id overflows
        "largest_ids_one_slot": (1, [(largest, ones(3))]),
        "runs_of_ten": (4096, [(runs, ones(runs.numel()))]),
        "threaded_2^24": (1 << 24, [(g, ones(g.numel())) for g in big]),
    }
    t17 = time.perf_counter()
    for name, (h, sources) in cases.items():
        kt = torch.full((h,), agg.HASH_EMPTY, dtype=torch.int64, device=dev)
        pt = kt.clone()
        for i, (g, a) in enumerate(sources):
            before = kt.clone()
            ks2 = _twice_identical(
                lambda: agg.hash_group_slots(kt.copy_(before), g, a)[1:], f"edge K17 {name}")
            _kt, ks, ko = agg.hash_group_slots(kt.copy_(before), g, a)
            kr = agg.last_hash_rounds()
            _pt, ps, po = agg.hash_group_slots_plain(pt, g, a)
            _compare_bytes(kt, pt, f"edge K17 {name} source {i} table")
            _compare_bytes(ks, ps, f"edge K17 {name} source {i} slots")
            _compare_bytes(ko, po, f"edge K17 {name} source {i} overflow")
            _compare_bytes(ks2[0], ks, f"edge K17 {name} source {i} rerun")
            if kr != agg.last_hash_rounds():
                raise AssertionError(f"edge K17 {name} source {i}: {kr} rounds, the plain "
                                     f"version {agg.last_hash_rounds()}")
        if name == "overflow" and int(ko) != 32:
            raise AssertionError(f"edge K17 overflow: {int(ko)} unplaced rows, expected 32")
        if name == "largest_ids_one_slot" and (int(ko) != 2 or int(kt[0]) != (1 << 62) - 2):
            raise AssertionError(f"edge K17 {name}: overflow {int(ko)}, table {kt.tolist()}")
    CHECK_S["k17_edge_cases_s"] += time.perf_counter() - t17
    n = 10_017
    valid = t(np.arange(n) < n - 33)
    for cards in ((128, 8), (1 << 16, 1 << 12)):
        codes = [t(rng.integers(-1, c + 2, n).astype(np.int32)) for c in cards]
        ts = t((T0 + rng.integers(-10**8, 10**9, n)).astype(np.int64))
        args = (valid, [], [], list(zip(codes, cards)), (ts, T0, 3_600_000, 300), None,
                torch.int64)
        kg, km = _twice_identical(lambda: flt.mask_gids(*args), "edge mask_gids int64")
        pg, pm = flt.mask_gids_plain(*args)
        _compare_bytes(kg, pg, f"edge mask_gids int64 {cards}")
        _compare_bytes(km, pm, f"edge mask_gids int64 {cards} mask")
    # K3's sparse dispatch (G > n / 32): runs of 1 to ~9000 rows over 300
    # ids spread across 2^20 groups (0 and G - 1 among them), shuffled;
    # NaN/inf values, a column mask, masked rows
    n, G = 20_000, 1 << 20
    ids = np.concatenate([[0, G - 1], rng.choice(np.arange(1, G - 1), 298, replace=False)])
    g = t(ids[rng.zipf(1.6, n) % ids.size].astype(np.int32))
    v_np = rng.uniform(-50, 50, n)
    v_np[rng.choice(n, 30, replace=False)] = np.nan
    v_np[rng.choice(n, 30, replace=False)] = np.inf
    v, v2 = t(v_np), t(rng.uniform(0, 1, n))
    mask = t(rng.random(n) < 0.9)
    colmask = mask & t(rng.random(n) < 0.8)
    aggs = ("count", "max", "min", "sum")
    s_st = _twice_identical(
        lambda: agg.segment_reduce_scatter([v, v2], g, [colmask, mask], mask, G, aggs),
        "edge sparse scatter")
    _check_state(s_st, _plain_on_host(agg.segment_reduce_scatter_plain, [v, v2], g,
                                      [colmask, mask], mask, G, aggs), "edge sparse scatter")
    G = 4096
    pres = t(rng.integers(0, 3, G).astype(np.int32))
    for count in (0, 5):
        ov = torch.tensor([count], dtype=torch.int32, device=dev)
        value = t(rng.uniform(0, 1, G))
        k = _twice_identical(
            lambda: agg.pack_result([pres], [], [("value", value)], True, overflow=ov),
            "edge pack_result")
        p = agg.pack_result_plain([pres], [], [("value", value)], True, overflow=ov)
        _compare_bytes(k[0], p[0], f"edge pack_result overflow={count}")
        _compare_bytes(k[1], p[1], f"edge pack_result overflow={count} accs64")
        if int(k[0][-1]) != int(count > 0):
            raise AssertionError("edge pack_result: wrong overflow byte")
    emit({"phase": "hash_edge_cases", "ok": True, "k17_edge_cases_s": CHECK_S["k17_edge_cases_s"]})


# ---- phase 4: the slice ------------------------------------------------------------

def _sorted_rows(table, keys):
    import pyarrow.compute as pc

    if keys:
        idx = pc.sort_indices(table, sort_keys=[(k, "ascending") for k in keys])
        table = table.take(idx)
    return table


def compare_tables(dev_t, cpu_t, query: str, tol: float = 1e-12, inexact=(),
                   keys=("hostname", "tb", "minute")) -> float:
    """Device result vs CPU-backend result: same columns and rows; exact
    except sum/avg columns, within relative `tol` (1e-12 on the f64 paths,
    where only the addition order differs; 1e-7 on the limb path, the
    bound its verdict enforces); `inexact` names further sum/avg columns
    by alias.  Without an ORDER BY both sides are sorted by the `keys`
    they have.  Returns the max relative error of the inexact columns."""
    if dev_t.column_names != cpu_t.column_names:
        raise AssertionError(f"{query}: columns {dev_t.column_names} != {cpu_t.column_names}")
    if dev_t.num_rows != cpu_t.num_rows:
        raise AssertionError(f"{query}: {dev_t.num_rows} rows != {cpu_t.num_rows}")
    inexact = [c for c in dev_t.column_names if c.startswith(("avg", "sum")) or c in inexact]
    keys = [c for c in dev_t.column_names if c in keys]
    if "ORDER BY" not in query:
        dev_t, cpu_t = _sorted_rows(dev_t, keys), _sorted_rows(cpu_t, keys)
    worst = 0.0
    for c in dev_t.column_names:
        a = dev_t[c].to_pylist()
        b = cpu_t[c].to_pylist()
        if c not in inexact:
            if a != b:
                bad = sum(1 for x, y in zip(a, b) if x != y)
                raise AssertionError(f"{query}: column {c}: {bad} values differ")
            continue
        x = np.array([np.nan if v is None else v for v in a], dtype=np.float64)
        y = np.array([np.nan if v is None else v for v in b], dtype=np.float64)
        if not np.array_equal(np.isnan(x), np.isnan(y)):
            raise AssertionError(f"{query}: column {c}: NULL positions differ")
        ok = ~np.isnan(y)
        rel = np.abs(x[ok] - y[ok]) / np.maximum(np.abs(y[ok]), 1e-300)
        if rel.size:
            worst = max(worst, float(rel.max()))
            if float(rel.max()) > tol:
                raise AssertionError(f"{query}: column {c}: rel err {rel.max()} > {tol}")
    return worst


def tsbs_chunks(tsbs: Tsbs):
    """The TSBS cpu-only rows from the seed, in the chunks `ingest` writes:
    (ts int64 [rows], host index [rows], {metric: f64 [rows]}), each chunk
    tick-major (every host at one tick, then the next tick)."""
    n_hosts = tsbs.n_hosts
    rng = np.random.default_rng(SEED)
    ticks_total = tsbs.hours * 3600 // SCRAPE_S
    chunk_ticks = max(1, 2_000_000 // n_hosts)
    for start in range(0, ticks_total, chunk_ticks):
        ticks = min(chunk_ticks, ticks_total - start)
        ts = T0 + (start + np.arange(ticks, dtype=np.int64))[:, None] * (SCRAPE_S * 1000)
        ts = np.broadcast_to(ts, (ticks, n_hosts)).reshape(-1)
        hidx = np.broadcast_to(np.arange(n_hosts)[None, :], (ticks, n_hosts)).reshape(-1)
        yield ts, hidx, {m: rng.uniform(0.0, 100.0, ticks * n_hosts) for m in tsbs.metrics}


def tsbs_columns(tsbs: Tsbs, names) -> dict:
    """Columns `names` of the rows `ingest` writes, in the region scan's
    (hostname, ts) order: {name: f64 [hosts * ticks]}."""
    parts = {m: [] for m in names}
    for _ts, _hidx, vals in tsbs_chunks(tsbs):
        for m in names:
            parts[m].append(vals[m].reshape(-1, tsbs.n_hosts))
    return {m: np.ascontiguousarray(np.concatenate(parts[m]).T).reshape(-1) for m in names}


def ingest(db, tsbs: Tsbs, partitions: int | None = None) -> tuple[int, dict]:
    """TSBS cpu-only rows through Database.write (WAL on), then flush; with
    `partitions`, into that many regions by hash of the host (bench.py's
    multi-chip layout).  Returns (rows, double-groupby-1 ground truth
    {(host, hour): [sum, n]})."""
    import pyarrow as pa

    cols_sql = ", ".join(f"{m} DOUBLE" for m in tsbs.metrics)
    part = f" PARTITION BY HASH (hostname) PARTITIONS {partitions}" if partitions else ""
    db.sql(
        f"CREATE TABLE cpu (hostname STRING, {cols_sql}, ts TIMESTAMP(3) TIME INDEX, "
        f"PRIMARY KEY (hostname)){part} WITH (append_mode = 'true')"
    )
    n_hosts = tsbs.n_hosts
    hosts_arr = np.array([f"host_{i}" for i in range(n_hosts)])
    gt: dict[int, list] = {}
    n_rows = 0
    for ts, hidx, vals in tsbs_chunks(tsbs):
        batch = pa.table({
            "hostname": pa.array(hosts_arr[hidx]),
            "ts": pa.array(ts, pa.timestamp("ms")),
            **{m: pa.array(vals[m], pa.float64()) for m in tsbs.metrics},
        })
        db.write("cpu", batch)
        n_rows += ts.shape[0]
        w12 = tsbs.w12
        in_w = (ts >= w12[0]) & (ts < w12[1])
        if in_w.any():
            hour = ((ts[in_w] - w12[0]) // H3600).astype(np.int64)
            key = hidx[in_w] * 100 + hour
            sums = np.bincount(key, weights=vals["usage_user"][in_w])
            cnts = np.bincount(key)
            for k in np.nonzero(cnts)[0]:
                acc = gt.setdefault(int(k), [0.0, 0])
                acc[0] += sums[k]
                acc[1] += int(cnts[k])
    db.flush()
    return n_rows, gt


def check_ground_truth(table, gt: dict, tsbs: Tsbs, tol: float = 1e-12) -> None:
    hosts = table["hostname"].to_pylist()
    tbs = table["tb"].cast("int64").to_pylist()
    avgs = table["avg_usage_user"].to_pylist()
    if len(hosts) != len(gt):
        raise AssertionError(f"double-groupby-1: {len(hosts)} groups, ground truth has {len(gt)}")
    for h, tb, a in zip(hosts, tbs, avgs):
        key = int(h[5:]) * 100 + (tb - tsbs.w12[0]) // H3600
        s, c = gt[key]
        if abs(a - s / c) > tol * abs(s / c):
            raise AssertionError(f"double-groupby-1 {h} {tb}: {a} vs ground truth {s / c}")


def run_slice(device: str, n_hosts: int, hours: int, reps: int, data_home: str, tick_reps: int = 5,
              tile_reps: int | None = None) -> dict:
    """Phases 4, 5, 5d, 5e, 5c, 5b and 10b on `device` ("cuda" on the card;
    "cpu" to rehearse the control flow with the plain versions): ingest,
    the table-fed path (tile cache off), the tile path on the same region,
    the host routes and the fused ladder in fresh Databases over its data,
    the tick, the live append on it, then the region at mesh_devices 1.
    Returns the slice record."""
    from greptimedb_tpu_torch import Database

    tsbs = Tsbs(n_hosts, hours)
    # the storage defaults (64 MiB region / 512 MiB global write buffer,
    # two flush-encode threads): the load flushes as it goes, into many SSTs
    db = Database(data_home, device=device, config=device_route_config())
    db.config.query.tile_cache_enable = False  # phase 4 is the table-fed path
    is_cuda = device.startswith("cuda")
    if is_cuda:
        import torch
    t0 = time.perf_counter()
    n_rows, gt = ingest(db, tsbs)
    ingest_s = time.perf_counter() - t0
    ssts = sum(len(db.storage.region(rid).files()) for rid in db.storage.region_ids())
    emit({"phase": "ingest", "rows": n_rows, "hosts": n_hosts, "hours": hours,
          "seconds": ingest_s, "rows_per_s": n_rows / ingest_s, "ssts": ssts})

    per_query = {}
    cpu_results = {}
    full_size = n_hosts == 4000 and hours == 12
    reset_counts()  # the table-fed path's run starts here
    for name, sql in tsbs.queries():
        before = launch_counts()
        lowered0 = db.query_engine.stats["lowered"]
        times = []
        stages: dict[str, list] = {}
        result = None
        for _ in range(1 + reps):
            t1 = time.perf_counter()
            result = db.sql_one(sql)
            if is_cuda:
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
            for k, v in db.query_engine.last_timings.items():
                stages.setdefault(k, []).append(v)
        after = launch_counts()
        delta = {k: after[k] - before[k] for k in after}
        lowered = db.query_engine.stats["lowered"] - lowered0
        if lowered != 1 + reps:
            raise AssertionError(f"{name}: lowered counter advanced {lowered}, expected {1 + reps}")
        if is_cuda:
            ran = {k for k, d in delta.items() if d > 0}
            need = {"mask_gids"} | (EXPECTED_PATH[name] if full_size else set())
            if not need <= ran or not ({_BLOCKED, _SCATTER} & ran):
                raise AssertionError(f"{name}: kernels launched {sorted(ran)}, path needs {sorted(need)}")
        # the authoritative CPU backend on the same data
        db.config.query.backend = "cpu"
        t1 = time.perf_counter()
        cpu_t = db.sql_one(sql)
        cpu_ms = (time.perf_counter() - t1) * 1e3
        db.config.query.backend = "torch"
        cpu_results[name] = cpu_t
        rel = compare_tables(result, cpu_t, name + " " + sql)
        if name == "double-groupby-1":
            check_ground_truth(result, gt, tsbs)
        if result.num_rows == 0:
            raise AssertionError(f"{name}: empty result")
        warm = sorted(times[1:]) if reps else times
        per_query[name] = {
            "rows_out": result.num_rows,
            "cold_ms": times[0],
            "warm_p50_ms": float(np.median(warm)),
            "cpu_backend_ms": cpu_ms,
            "max_rel_err": rel,
            # warm p50 of each host-timed stage (scan / tile / device /
            # readback / post)
            "stage_p50_ms": {k: float(np.median(v[1:] if reps else v)) for k, v in stages.items()},
            "launches": {k: v for k, v in delta.items() if v},
        }
        emit({"phase": "query", "name": name, **per_query[name]})
    totals, shapes = launch_counts(), shape_counts()
    if db.query_engine.stats["declined"]:
        raise AssertionError(f"{db.query_engine.stats['declined']} queries declined by try_lower")
    tile = run_tile_phase(db, tsbs, reps if tile_reps is None else tile_reps, cpu_results, gt,
                          is_cuda, full_size)
    host_routes = run_host_routes_phase(data_home, device, tsbs,
                                        reps if tile_reps is None else tile_reps, cpu_results, gt,
                                        tile["queries"])
    fused = run_fused_ladder_phase(data_home, device, tsbs,
                                   reps if tile_reps is None else tile_reps, cpu_results, gt,
                                   tile["queries"], host_routes)
    tick = run_tick_phase(db, tsbs, is_cuda, tick_reps)
    live = run_live_phase(db, tsbs, is_cuda, full_size)
    mesh = run_mesh_region(db, Tsbs(tsbs.n_hosts, tsbs.hours, len(tsbs.metrics),
                                    end=tsbs.end + LIVE_MINUTES * 60_000), is_cuda)
    db.close()
    return {"rows": n_rows, "ingest_s": ingest_s, "ssts": ssts, "queries": per_query,
            "launches": totals, "shape_launches": shapes, "tile": tile,
            "host_routes": host_routes, "fused": fused, "tick": tick, "live": live,
            "mesh": mesh}


# Host seconds spent in TileProgram.final and, inside it, in K8's wrapper
# (no sync: what the host takes to enqueue them), and the calls
FINAL_HOST = {"final_s": 0.0, "k8_s": 0.0, "calls": 0}


def time_final_host() -> None:
    """Count into FINAL_HOST from here on: wrappers around
    TileProgram.final and the K8 entry it calls."""
    from greptimedb_tpu_torch.parallel import tile_program as tp

    if getattr(tp.TileProgram.final, "timed", False):
        return
    final, pack = tp.TileProgram.final, tp.pack_result

    def timed_final(self, *args, **kw):
        t0 = time.perf_counter()
        try:
            return final(self, *args, **kw)
        finally:
            FINAL_HOST["final_s"] += time.perf_counter() - t0
            FINAL_HOST["calls"] += 1

    def timed_pack(*args, **kw):
        t0 = time.perf_counter()
        try:
            return pack(*args, **kw)
        finally:
            FINAL_HOST["k8_s"] += time.perf_counter() - t0

    timed_final.timed = True
    tp.TileProgram.final = timed_final
    tp.pack_result = timed_pack


def run_tile_phase(db, tsbs: Tsbs, reps: int, cpu_results: dict, gt: dict, is_cuda: bool,
                   full_size: bool) -> dict:
    """Phase 5: the tile path (super-tiles resident on the device) on the
    region phase 4 ingested: per query one cold run (plane build, upload,
    time-major permutation and copies, K5 quantize included, split out)
    and `reps` warm runs (p50 per stage: plan, dispatch through the last
    sync, readback, decode).  Every run must be answered by the tile path;
    each result is held against the CPU backend's (phase 4) — keys, counts,
    min, max, last exactly, sum and avg within rel 1e-7, the limb
    verdict's bound.  Each warm run's host time in TileProgram.final is
    split into K8's wrapper and the rest (`finalize`'s torch ops, K7/K13
    where a spec asks for them)."""
    eng = db.query_engine
    db.config.query.tile_cache_enable = True
    time_final_host()
    if is_cuda:
        import torch
    per_query = {}
    first_tm = next(name for name, _sql in tsbs.queries() if name in TIME_MAJOR)
    reset_counts()  # the tile path's run starts here
    for name, sql in tsbs.queries():
        before = launch_counts()
        d0, x0 = eng.stats["tile_dispatches"], eng.stats["tile_declined"]
        times, stages = [], []
        result = None
        cold = None
        for i in range(1 + reps):
            if i == 1:
                host0 = dict(FINAL_HOST)
            t1 = time.perf_counter()
            result = db.sql_one(sql)
            if is_cuda:
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
            if eng.last_path != "tile":
                raise AssertionError(f"{name}: answered by the {eng.last_path!r} path, not the tile path")
            stages.append(dict(eng.last_timings))
            if cold is None:
                cold = launch_counts()
        after = launch_counts()
        delta = {k: v - before[k] for k, v in after.items()}
        warm_delta = {k: v - cold[k] for k, v in after.items()}
        cold_delta = {k: cold[k] - before[k] for k in after}
        if eng.stats["tile_dispatches"] - d0 != 1 + reps or eng.stats["tile_declined"] != x0:
            raise AssertionError(f"{name}: tile_dispatches +{eng.stats['tile_dispatches'] - d0}, "
                                 f"tile_declined +{eng.stats['tile_declined'] - x0}")
        if is_cuda:
            ran = {k for k, d in delta.items() if d > 0}
            need = {"mask_gids"} | (EXPECTED_TILE_PATH[name] if full_size else {_PACK})
            if not need <= ran:
                raise AssertionError(f"{name}: tile path launched {sorted(ran)}, needs {sorted(need)}")
            if name in TIME_MAJOR:
                if reps and (warm_delta[_ARGSORT] or warm_delta[_GATHER]):
                    raise AssertionError(f"{name}: a warm time-major run sorted or gathered planes")
                if name == first_tm and not (cold_delta[_ARGSORT] and cold_delta[_GATHER]):
                    raise AssertionError(f"{name}: the first time-major run built no permutation "
                                         "or copies")
        rel = compare_tables(result, cpu_results[name], name + " " + sql, tol=1e-7)
        if name == "double-groupby-1":
            check_ground_truth(result, gt, tsbs, tol=1e-7)
        warm = stages[1:] if reps else stages
        keys = sorted({k for st in warm for k in st})
        per_query[name] = {
            "rows_out": result.num_rows,
            "time_major": name in TIME_MAJOR,
            "cold_ms": times[0],
            "cold_stage_ms": stages[0],
            "warm_p50_ms": float(np.median(times[1:] if reps else times)),
            "warm_stage_p50_ms": {k: float(np.median([st.get(k, 0.0) for st in warm])) for k in keys},
            "max_rel_err": rel,
            "launches": {k: v for k, v in delta.items() if v},
        }
        if reps:
            calls = FINAL_HOST["calls"] - host0["calls"]
            k8_us = (FINAL_HOST["k8_s"] - host0["k8_s"]) / max(calls, 1) * 1e6
            final_us = (FINAL_HOST["final_s"] - host0["final_s"]) / max(calls, 1) * 1e6
            per_query[name].update(final_host_us=final_us, final_k8_host_us=k8_us,
                                   final_other_host_us=final_us - k8_us)
        emit({"phase": "tile_query", "name": name, **per_query[name]})
    totals = launch_counts()  # the main path's launches end here
    shapes = shape_counts()
    k8 = dict(K8_PLANNED)
    if is_cuda and (k8["made"] != totals[_PACK] or k8["planned"] != k8["calls"]):
        raise AssertionError(f"K8 on the tile path: {totals[_PACK]} launches, {k8['made']} in "
                             f"{k8['calls']} calls, {k8['planned']} planned (one a call)")
    k15 = dict(K15_PLANNED)
    if is_cuda and (k15["made"] != totals[_GATHER] or k15["builds"] != k15["calls"]):
        raise AssertionError(f"K15 on the tile path: {totals[_GATHER]} launches, {k15}")
    edge = run_tile_edge_queries(db, tsbs, is_cuda)
    return {"queries": per_query, "launches": totals, "shape_launches": shapes, "k8_calls": k8,
            "k15_calls": k15, "edge_launches": edge, "edge_shape_launches": shape_counts(),
            "cache": eng.tile_cache.stats(), "limb_reruns": eng.tile_executor().limb_reruns}


def _routed_run(db, sql: str, is_cuda: bool) -> dict:
    """One query under a pass trace: its result, host ms through a sync,
    route (the host route that fired, else `last_path`: "tile", "table" or
    "cpu"), the kernels it launched, and the device bytes and builds it
    added to the tile cache."""
    from greptimedb_tpu_torch.query import passes

    eng = db.query_engine

    def cache_stats():
        return eng.tile_cache.stats() if eng.tile_cache is not None else {"bytes": 0, "builds": 0}

    c0, before, trace = cache_stats(), launch_counts(), passes.PassTrace()
    t0 = time.perf_counter()
    with passes.use_trace(trace):
        result = db.sql_one(sql)
    if is_cuda:
        import torch

        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    after, c1 = launch_counts(), cache_stats()
    fired = [d for d in trace.decisions if d.fired and d.name in HOST_ROUTES]
    return {"result": result, "ms": ms, "route": fired[-1].name if fired else eng.last_path,
            "route_attrs": dict(fired[-1].attrs) if fired else {},
            "stage_ms": dict(eng.last_timings),
            "launches": {k: after[k] - before[k] for k in after if after[k] != before[k]},
            "bytes_added": c1["bytes"] - c0["bytes"], "builds": c1["builds"] - c0["builds"],
            "decisions": [(d.name, d.fired, d.why) for d in trace.decisions
                          if d.name in HOST_ROUTES]}


def _free(db) -> None:
    """Close a Database and give its planes back to the card."""
    import gc

    import torch

    db.close()
    del db
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run_host_routes_phase(data_home: str, device: str, tsbs: Tsbs, reps: int, cpu_results: dict,
                          gt: dict, tile_queries: dict) -> dict:
    """Phase 5d: the host routing ladder at the defaults but the fused
    build (`fused_build` named in query.disabled_passes: the legacy
    ladder; phase 5e runs the fused one), on phase 4's data
    in fresh Databases over the same data home (the phase's Database stays
    open and idle: nothing here writes).  Steps: cold (the 15 queries once,
    routes as COLD_ROUTES says), second touch (the cold-served queries on
    the card), warm (`reps` runs each, routes as WARM_ROUTES says, host
    p50 beside phase 5's tile p50), then cost_route + prewarm in another
    fresh Database.  A host-routed run must launch no kernel and add no
    device byte; every result is held against phase 4's CPU backend."""
    from greptimedb_tpu_torch import Database
    from greptimedb_tpu_torch.query.device_exec import try_lower
    from greptimedb_tpu_torch.query.planner import plan_query
    from greptimedb_tpu_torch.query.sql_parser import parse_sql

    is_cuda = device.startswith("cuda")
    queries = dict(tsbs.queries())
    t_phase = time.perf_counter()
    reset_counts()  # phase 5d's run starts here

    def check(name: str, run: dict, want: str, what: str, same_as=None) -> None:
        """The run's route, no launch or upload on a host route, and its
        result against the CPU backend (or the bytes of `same_as`, an
        earlier run of the same query that was)."""
        if run["route"] != want:
            raise AssertionError(f"{what} {name}: the {run['route']!r} route, expected {want!r} "
                                 f"({run['decisions']})")
        if want in HOST_ROUTES and (run["launches"] or run["bytes_added"] or run["builds"]):
            raise AssertionError(f"{what} {name} ({want}) launched {run['launches']}, added "
                                 f"{run['bytes_added']} device bytes, {run['builds']} builds")
        if same_as is not None:
            if not run["result"].equals(same_as["result"]):
                raise AssertionError(f"{what} {name}: a warm run changed the result")
            return
        compare_tables(run["result"], cpu_results[name], f"{what} {name}", tol=1e-7)
        if name == "double-groupby-1":
            check_ground_truth(run["result"], gt, tsbs, tol=1e-7)

    def line(run: dict) -> dict:
        return {k: run[k] for k in ("route", "ms", "stage_ms", "launches", "bytes_added",
                                    "builds")}

    # 1. cold: a fresh Database, every entry cold (the legacy ladder: the
    # fused build off, phase 5e runs it)
    t0 = time.perf_counter()
    db = Database(data_home, device=device, config=device_route_config(LEGACY_LADDER))
    cold = {}
    for name, sql in queries.items():
        run = _routed_run(db, sql, is_cuda)
        check(name, run, COLD_ROUTES.get(name, "tile"), "cold")
        cold[name] = line(run)
    stats = db.query_engine.stats
    emit({"phase": "host_routes", "step": "cold", "seconds": time.perf_counter() - t0,
          "queries": cold, "host_fast_path": stats.get("host_fast_path", 0),
          "cold_serves": stats.get("cold_serves", 0)})

    # 2. second touch: the cold-served queries on the card
    t0 = time.perf_counter()
    second = {}
    for name in [n for n, r in cold.items() if r["route"] == "cold_host_serve"]:
        run = _routed_run(db, queries[name], is_cuda)
        check(name, run, "tile", "second touch")
        if is_cuda and tsbs.n_hosts == 4000 and tsbs.hours == 12:
            # the planes of its columns are resident since a later cold query
            # built them (K5 included): the kernels of its plan but K5
            need = EXPECTED_TILE_PATH[name] - {_QUANT}
            if not need <= set(run["launches"]):
                raise AssertionError(f"second touch {name}: launched {run['launches']}, needs "
                                     f"{sorted(need)}")
        second[name] = line(run)
    emit({"phase": "host_routes", "step": "second_touch", "seconds": time.perf_counter() - t0,
          "queries": second})

    # 3. warm
    t0 = time.perf_counter()
    warm = {}
    for name, sql in queries.items():
        runs = []
        for _ in range(max(reps, 1)):
            run = _routed_run(db, sql, is_cuda)
            check(name, run, WARM_ROUTES.get(name, "tile"), "warm", runs[0] if runs else None)
            runs.append(run)
        warm[name] = {"route": runs[0]["route"],
                      "p50_ms": float(np.median([r["ms"] for r in runs])),
                      "tile_p50_ms": tile_queries[name]["warm_p50_ms"],
                      "launches": _summed(*[r["launches"] for r in runs])}
        if name == "cpu-max-all-8" and not any(
                not fired and "tile dispatch beats" in why
                for _n, fired, why in runs[0]["decisions"]):
            raise AssertionError(f"cpu-max-all-8 left the host path for another reason: "
                                 f"{runs[0]['decisions']}")
    emit({"phase": "host_routes", "step": "warm", "seconds": time.perf_counter() - t0,
          "reps": max(reps, 1),
          "host_served": {n: {k: w[k] for k in ("p50_ms", "tile_p50_ms")}
                          for n, w in warm.items() if w["route"] in HOST_ROUTES},
          "card": {n: w["p50_ms"] for n, w in warm.items() if w["route"] not in HOST_ROUTES}})
    _free(db)

    # 4 + 5. cost_route, then prewarm, in another fresh Database
    t0 = time.perf_counter()
    probe = "single-groupby-1-1-1"
    db = Database(data_home, device=device, config=device_route_config(LEGACY_LADDER))
    eng = db.query_engine
    plan, schema = plan_query(parse_sql(queries[probe])[0], eng.schema_of, db.current_database)
    est = eng._estimate_scan_rows(try_lower(plan, schema).scan, schema)
    db.config.query.tpu_min_rows = est + 1
    routed = _routed_run(db, queries[probe], is_cuda)
    check(probe, routed, "cost_route", "cost route")
    if eng.last_path != "cpu" or eng.stats.get("routed_to_cpu", 0) != 1:
        raise AssertionError(f"cost route: last_path {eng.last_path!r}, {eng.stats}")
    before = launch_counts()
    t1 = time.perf_counter()
    warmed = db.prewarm()
    if is_cuda:
        import torch

        torch.cuda.synchronize()
    prewarm_ms = (time.perf_counter() - t1) * 1e3
    k5 = launch_counts()[_QUANT] - before[_QUANT]
    table_key = f"{db.current_database}.cpu"
    if warmed.get(table_key, {}).get("regions_built") != 1:
        raise AssertionError(f"prewarm built {warmed}")
    # K5 runs over the non-null numeric fields; TSBS's DOUBLE fields are
    # nullable (the reference's rule), so the first sum/avg quantizes
    cache = eng.tile_cache.stats()
    first = _routed_run(db, queries["double-groupby-1"], is_cuda)
    check("double-groupby-1", first, "tile", "after prewarm")
    if first["builds"] or eng.stats.get("cold_serves", 0):
        raise AssertionError(f"after prewarm double-groupby-1 rebuilt or was cold-served: {first}")
    back = _routed_run(db, queries[probe], is_cuda)
    check(probe, back, "host_fast_path", "after prewarm")
    if back["decisions"][0] != ("cost_route", False,
                                "scan large enough (or tiles resident) for the device path"):
        raise AssertionError(f"cost route after prewarm: {back['decisions']}")
    emit({"phase": "host_routes", "step": "cost_route_prewarm", "seconds": time.perf_counter() - t0,
          "estimate": est, "tpu_min_rows": est + 1, "routed": line(routed),
          "prewarm": warmed.get(table_key), "prewarm_ms": prewarm_ms, "prewarm_k5_launches": k5,
          "device_bytes_after_prewarm": cache["bytes"], "first_query": line(first),
          "back_on_tile_path": line(back)})
    _free(db)
    totals, shapes = launch_counts(), shape_counts()  # the phase's launches end here
    seconds = time.perf_counter() - t_phase
    emit({"phase": "host_routes", "seconds": seconds,
          "launches": {k: v for k, v in totals.items() if v}})
    return {"seconds": seconds, "cold": cold, "second_touch": second, "warm": warm,
            "cost_route": {"estimate": est, "routed": line(routed), "back": line(back)},
            "prewarm": {"stats": warmed.get(table_key), "ms": prewarm_ms, "k5_launches": k5,
                        "first_query": line(first)},
            "launches": totals, "shape_launches": shapes}


def fused_drain(db, timeout_s: float = 600.0) -> float:
    """Wait until the fused build's background builder has no queued or
    running family (tests/test_fused_build.py's `_drain_fused`); the
    seconds waited.  Raises if a build failed (`fused_build_errors`)."""
    te = db.query_engine.tile_executor()
    t0 = time.perf_counter()
    while te.fused_pending():
        if time.perf_counter() - t0 > timeout_s:
            raise AssertionError(f"the fused builder did not drain in {timeout_s} s")
        time.sleep(0.01)
    errors = db.query_engine.stats.get("fused_build_errors", 0)
    if errors:
        raise AssertionError(f"{errors} fused build failure(s): {te.last_fused_error!r}")
    return time.perf_counter() - t0


def _first_touch_stages(name: str, run: dict, what: str) -> None:
    """A host-served first touch: no upload and no dispatch on the query's
    own thread (its stages are thread-local; the builder's are its own)."""
    for stage in ("upload", "dispatch", "quantize", "time_major"):
        if stage in run["stage_ms"]:
            raise AssertionError(f"{what} {name}: a {stage!r} stage on the query's thread: "
                                 f"{run['stage_ms']}")


def run_fused_ladder_phase(data_home: str, device: str, tsbs: Tsbs, reps: int,
                           cpu_results: dict, gt: dict, tile_queries: dict,
                           host_routes: dict) -> dict:
    """Phase 5e: the fused family build and the cold serve's fused ladder,
    at the defaults, on phase 4's data in fresh Databases over the same data
    home.  Steps: cold (the 15 queries once, in FUSED_COLD_ORDER, each on
    its FUSED_COLD_ROUTES host route, read from its pass trace, with no
    upload or dispatch stage on its thread), drain (the builder's record:
    union builds, manifests, regions, file decodes — one a SST —,
    coalesced waits, no failure, and the kernels it launched: K5, K14 and
    K15 among them), warm (`reps` runs each: the pk-equality queries on the
    host, the seven others on the card with no build and no byte added,
    each launching its EXPECTED_TILE_PATH kernels but K5; p50 beside phase
    5's and 5d's), then prewarm in another fresh Database (host-only: no
    device byte, no launch) and double-groupby-1 as a fused cold serve.
    Every result against phase 4's CPU backend (within rel 1e-7),
    double-groupby-1 also against the ground truth."""
    from greptimedb_tpu_torch import Database

    is_cuda = device.startswith("cuda")
    full_size = tsbs.n_hosts == 4000 and tsbs.hours == 12
    queries = dict(tsbs.queries())
    t_phase = time.perf_counter()

    def against_cpu(name: str, run: dict, what: str) -> None:
        compare_tables(run["result"], cpu_results[name], f"{what} {name}", tol=1e-7)
        if name == "double-groupby-1":
            check_ground_truth(run["result"], gt, tsbs, tol=1e-7)

    def line(run: dict) -> dict:
        return {k: run[k] for k in ("route", "route_attrs", "ms", "stage_ms")}

    # 1. cold: a fresh Database at the defaults, every entry and family cold
    t0 = time.perf_counter()
    db = Database(data_home, device=device)
    eng = db.query_engine
    reset_counts()  # the builder's launches, from the first touch to the drain
    cold = {}
    for name in FUSED_COLD_ORDER:
        run = _routed_run(db, queries[name], is_cuda)
        want = FUSED_COLD_ROUTES[name]
        if run["route"] != want:
            raise AssertionError(f"fused cold {name}: the {run['route']!r} route, expected "
                                 f"{want!r} ({run['decisions']})")
        if want == "cold_host_serve" and run["route_attrs"].get("fused") is not True:
            raise AssertionError(f"fused cold {name}: not the fused ladder: {run['decisions']}")
        if name == "cpu-max-all-8" and not run["route_attrs"].get("wide_cold"):
            raise AssertionError(f"fused cold {name}: not served as wide_cold: "
                                 f"{run['route_attrs']}")
        _first_touch_stages(name, run, "fused cold")
        against_cpu(name, run, "fused cold")
        cold[name] = line(run)
    cold_s = time.perf_counter() - t0
    emit({"phase": "fused_ladder", "step": "cold", "seconds": cold_s, "queries": cold,
          "host_fast_path": eng.stats.get("host_fast_path", 0),
          "cold_serves": eng.stats.get("cold_serves", 0)})

    # 2. drain: the builder's record
    drain_s = fused_drain(db)
    if is_cuda:
        import torch

        torch.cuda.synchronize()
    built = {k: v for k, v in launch_counts().items() if v}
    cache = eng.tile_cache.stats()
    ssts = sum(len(r.files()) for r in (db.storage.region(rid)
                                        for rid in db.storage.region_ids()))
    if cache["file_decodes"] != ssts:
        raise AssertionError(f"fused build: {cache['file_decodes']} file decodes for {ssts} SSTs")
    if is_cuda and not all(built.get(k) for k in (_QUANT, _ARGSORT, _GATHER)):
        raise AssertionError(f"the builder did not launch K5, K14 and K15: {built}")
    record = {k: cache[k] for k in ("fused_builds", "fused_manifests", "fused_regions_built",
                                     "file_decodes", "fused_decodes_saved",
                                     "fused_encodes_saved", "build_coalesced", "builds",
                                     "bytes")}
    record.update(ssts=ssts, fused_build_errors=eng.stats.get("fused_build_errors", 0))
    emit({"phase": "fused_ladder", "step": "drain", "seconds": drain_s,
          "since_first_touch_s": time.perf_counter() - t0, "builder": record,
          "launches": built})

    # 3. warm: the families the builder warmed, on the card
    t0 = time.perf_counter()
    warm = {}
    for name, sql in queries.items():
        runs = []
        for _ in range(max(reps, 1)):
            run = _routed_run(db, sql, is_cuda)
            want = WARM_ROUTES.get(name, "tile")
            if run["route"] != want:
                raise AssertionError(f"fused warm {name}: the {run['route']!r} route, expected "
                                     f"{want!r} ({run['decisions']})")
            if want == "tile" and (run["builds"] or run["bytes_added"]):
                raise AssertionError(f"fused warm {name}: {run['builds']} builds, "
                                     f"{run['bytes_added']} device bytes added")
            if runs and not run["result"].equals(runs[0]["result"]):
                raise AssertionError(f"fused warm {name}: a warm run changed the result")
            runs.append(run)
        against_cpu(name, runs[0], "fused warm")
        launched = _summed(*[r["launches"] for r in runs])
        if is_cuda and full_size and want == "tile":
            need = EXPECTED_TILE_PATH[name] - {_QUANT}
            if not need <= set(launched):
                raise AssertionError(f"fused warm {name}: launched {launched}, needs "
                                     f"{sorted(need)}")
        warm[name] = {"route": runs[0]["route"],
                      "p50_ms": float(np.median([r["ms"] for r in runs])),
                      "tile_p50_ms": tile_queries[name]["warm_p50_ms"],
                      "host_routes_p50_ms": host_routes["warm"][name]["p50_ms"],
                      "launches": launched}
    emit({"phase": "fused_ladder", "step": "warm", "seconds": time.perf_counter() - t0,
          "reps": max(reps, 1), "queries": warm})
    _free(db)

    # 4. prewarm: host-only, then a fused cold serve
    t0 = time.perf_counter()
    db = Database(data_home, device=device)
    eng = db.query_engine
    before = launch_counts()
    t1 = time.perf_counter()
    warmed = db.prewarm()
    prewarm_ms = (time.perf_counter() - t1) * 1e3
    table_key = f"{db.current_database}.cpu"
    launched = {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}
    cache = eng.tile_cache.stats()
    if warmed.get(table_key, {}).get("regions_built") != 1 or launched or cache["bytes"]:
        raise AssertionError(f"fused prewarm: {warmed}, launched {launched}, "
                             f"{cache['bytes']} device bytes")
    first = _routed_run(db, queries["double-groupby-1"], is_cuda)
    if first["route"] != "cold_host_serve" or first["route_attrs"].get("fused") is not True:
        raise AssertionError(f"after the fused prewarm double-groupby-1: {first['decisions']}")
    _first_touch_stages("double-groupby-1", first, "after the fused prewarm")
    against_cpu("double-groupby-1", first, "after the fused prewarm")
    prewarm_drain_s = fused_drain(db)
    emit({"phase": "fused_ladder", "step": "prewarm", "seconds": time.perf_counter() - t0,
          "prewarm": warmed.get(table_key), "prewarm_ms": prewarm_ms,
          "device_bytes_after_prewarm": cache["bytes"], "prewarm_launches": launched,
          "file_decodes": cache["file_decodes"], "first_query": line(first),
          "drain_s": prewarm_drain_s})
    _free(db)
    totals = launch_counts()  # the phase's launches end here
    seconds = time.perf_counter() - t_phase
    emit({"phase": "fused_ladder", "seconds": seconds,
          "launches": {k: v for k, v in totals.items() if v}})
    return {"seconds": seconds, "launches": totals, "cold": cold, "cold_s": cold_s,
            "drain_s": drain_s,
            "builder": record, "builder_launches": built, "warm": warm,
            "prewarm": {"stats": warmed.get(table_key), "ms": prewarm_ms,
                        "first_query": line(first)}}


def run_tql_first_touch(data_home: str, device: str, tsbs: Tsbs, legacy_t2) -> dict:
    """Phase 5e's TQL step, on phase 6's tables in a fresh Database at the
    defaults: T2 (`sum(rate(...))`) over the last hour at '15s', a family
    not yet touched with the fused build on, is declined by the tile route
    on its first touch (the legacy scan answers; its build is queued), then
    after the drain runs on the tile route (K9-K12).  Both against phase
    6's legacy result of the same window (rel 1e-12, TQL_ULP)."""
    from greptimedb_tpu_torch import Database

    is_cuda = device.startswith("cuda")
    hi = tsbs.end
    sql = tql(dict(tql_queries(tsbs.n_hosts))["T2"], hi - H3600, hi, "15s")
    t0 = time.perf_counter()
    db = Database(data_home, device=device)
    try:
        first, first_ms, first_st, d1 = _tql_run(db, sql, is_cuda)
        cold = db.query_engine.stats.get("tql_tile_cold_serves", 0)
        if cold != 1 or d1["tql_tile_dispatches"] or d1["tql_legacy"] != 1:
            raise AssertionError(f"TQL first touch: not served by the legacy scan: {d1}, "
                                 f"cold serves {cold}")
        compare_tql(first, legacy_t2, "TQL first touch vs phase 6's legacy", 1e-12)
        drain_s = fused_drain(db)
        before = launch_counts()
        again, again_ms, again_st, d2 = _tql_run(db, sql, is_cuda)
        launched = {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}
        if d2["tql_tile_dispatches"] != 1 or d2["tql_legacy"] or d2["tql_tile_declined"]:
            raise AssertionError(f"TQL after the drain: not the tile route: {d2}")
        if is_cuda and set(launched) != EXPECTED_TQL_PATH["T2"]:
            raise AssertionError(f"TQL after the drain launched {launched}, path is "
                                 f"{sorted(EXPECTED_TQL_PATH['T2'])}")
        rel = compare_tql(again, legacy_t2, "TQL tile route after the drain vs legacy", 1e-12)
        out = {"seconds": time.perf_counter() - t0, "first_ms": first_ms,
               "first_stage_ms": first_st, "first_delta": {k: v for k, v in d1.items() if v},
               "cold_serves": cold, "drain_s": drain_s, "tile_ms": again_ms,
               "tile_stage_ms": again_st, "launches": launched, "max_rel_err": rel,
               "builder": {k: v for k, v in db.query_engine.tile_cache.stats().items()
                           if k.startswith("fused") or k == "file_decodes"}}
        emit({"phase": "fused_ladder", "step": "tql_first_touch", **out})
        return out
    finally:
        _free(db)


def _tile_against_cpu(db, sql: str, what: str, tol: float = 1e-7, inexact=()):
    """One query on the tile path and on the CPU backend; returns (tile
    table, its stage ms, max rel err)."""
    eng = db.query_engine
    got = db.sql_one(sql)
    if db.device.startswith("cuda"):
        import torch

        torch.cuda.synchronize()
    if eng.last_path != "tile":
        raise AssertionError(f"{what}: answered by the {eng.last_path!r} path")
    stages = dict(eng.last_timings)
    db.config.query.backend = "cpu"
    try:
        want = db.sql_one(sql)
    finally:
        db.config.query.backend = "torch"
    return got, stages, compare_tables(got, want, what + " " + sql, tol=tol, inexact=inexact)


def run_tile_edge_queries(db, tsbs: Tsbs, is_cuda: bool) -> dict:
    """Queries off the TSBS family whose plans meet a kernel's limits or
    route: more ORDER BY keys than K7 takes (the Sort replays on the
    host); a bucket-only avg and sum (limb planes quantized over the
    time-major copies, K5/K6); and a minute-bucket query with the
    time_major pass off, whose (hostname, ts) layout fails K2's guard so
    that K3 takes the tile route.  Each answers on the tile path and equals
    the CPU backend.  Returns the launches of these runs."""
    lo, hi = tsbs.w12
    reset_counts()
    for keys in (("a", "b", "c", "hostname"), ("a", "b", "c", "hostname", "tb")):
        sql = (f"SELECT hostname, time_bucket('1h', ts) AS tb, max(usage_user) AS a, "
               f"min(usage_system) AS b, max(usage_idle) AS c FROM cpu "
               f"WHERE ts >= {lo} AND ts < {hi} GROUP BY hostname, tb "
               f"ORDER BY {', '.join(keys)} LIMIT 5")
        got, _st, _rel = _tile_against_cpu(db, sql, "edge query")
        emit({"phase": "tile_edge_query", "order_keys": len(keys), "rows_out": got.num_rows})
    sql = (f"SELECT time_bucket('1h', ts) AS tb, avg(usage_user) AS avg_usage_user, "
           f"sum(usage_system) AS sum_usage_system FROM cpu WHERE ts >= {lo} AND ts < {hi} "
           f"GROUP BY tb")
    before = launch_counts()
    got, st, rel = _tile_against_cpu(db, sql, "time-major limbs")
    ran = {k for k, v in launch_counts().items() if v > before[k]}
    if is_cuda and not {_LIMB} <= ran:
        raise AssertionError(f"time-major avg: launched {sorted(ran)}, needs K6")
    emit({"phase": "tile_edge_query", "what": "time-major limbs", "rows_out": got.num_rows,
          "max_rel_err": rel, "launched": sorted(ran), "stage_ms": st})
    saved = db.config.query.disabled_passes
    db.config.query.disabled_passes = tuple(saved) + ("time_major",)
    try:
        sql = dict(tsbs.queries())["single-groupby-1-1-12"].replace(
            f" AND hostname = '{tsbs.host1}'", "")
        before = launch_counts()
        got, st, rel = _tile_against_cpu(db, sql, "time_major off")
        ran = {k for k, v in launch_counts().items() if v > before[k]}
    finally:
        db.config.query.disabled_passes = saved
    if is_cuda and not {_BLOCKED, _SCATTER} <= ran:
        raise AssertionError(f"time_major off: launched {sorted(ran)}, needs K2 then K3")
    emit({"phase": "tile_edge_query", "what": "time_major off (K2 guard fails, K3)",
          "rows_out": got.num_rows, "launched": sorted(ran), "stage_ms": st})
    return launch_counts()


# ---- phase 5c: the dashboard tick ---------------------------------------------------------

TICK_WINDOW_MS = 120.0


def slid_queries(tsbs: Tsbs) -> list[tuple[str, str]]:
    """The 15 queries a dashboard sends one refresh later: every window
    one of its own buckets later (the hourly panels 1 h, the minute and
    unbucketed ones 1 min) and the host literals changed.  The plan
    structures stay, so a tick of them finds its program."""
    n = tsbs.n_hosts
    later = {}
    for step in (H3600, 60_000):
        t = Tsbs(n, tsbs.hours, n_metrics=len(tsbs.metrics), end=tsbs.end + step)
        t.host1 = f"host_{(703 + 1) % n}"
        t.hosts8 = [f"host_{(i + 1) % n}" for i in (703, 1217, 2048, 99, 3777, 1500, 2901, 42)]
        later[step] = dict(t.queries())
    hourly = ("double-groupby", "cpu-max-all")
    return [(name, later[H3600 if name.startswith(hourly) else 60_000][name])
            for name, _sql in tsbs.queries()]


def _tick_round(db, queries: list[str], window_ms: float):
    """One round: a thread per query, all released by one barrier.  Returns
    (results, stats delta, ms from the release to the last result net of
    the window)."""
    import threading

    eng = db.query_engine
    before = dict(eng.stats)
    results, errors = [None] * len(queries), []
    starts, ends = [0.0] * len(queries), [0.0] * len(queries)
    barrier = threading.Barrier(len(queries))

    def run(i, sql):
        try:
            barrier.wait(timeout=60)
            starts[i] = time.perf_counter()
            results[i] = db.sql_one(sql)
            ends[i] = time.perf_counter()
        except Exception as exc:  # noqa: BLE001 — raised below, on the main thread
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(i, q)) for i, q in enumerate(queries)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        if t.is_alive():
            raise AssertionError("a tick member never returned")
    if errors:
        raise errors[0]
    delta = {k: v - before.get(k, 0) for k, v in eng.stats.items()}
    return results, delta, (max(ends) - min(starts)) * 1e3 - window_ms


def _clean_tick(db, queries: list[str], window_ms: float, rounds: int = 8):
    """Rounds until one forms a clean tick: every query a member of one
    tick answered by one tick program.  Membership is read from the stats,
    never from timing."""
    for _ in range(rounds):
        results, delta, wall = _tick_round(db, queries, window_ms)
        if (delta["batch_ticks"], delta["batch_members"], delta["batch_fused_dispatches"],
                delta["tick_graph_replays"]) == (1, len(queries), 1, 1):
            return results, delta, wall
    raise AssertionError(f"no clean tick of {len(queries)} members formed in {rounds} rounds")


def _solo_refs(db, named: list[tuple[str, str]], is_cuda: bool, reps: int = 3):
    """Per query its solo bytes and solo wall p50 (window 0, the direct
    path)."""
    import torch

    refs, ms = {}, {}
    for name, sql in named:
        times = []
        out = None
        for _ in range(reps):
            t1 = time.perf_counter()
            out = db.sql_one(sql)
            if is_cuda:
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
        refs[sql] = _ipc_bytes(out)
        ms[name] = float(np.median(times))
    return refs, ms


def _tick_series(db, named, refs: dict, n_ticks: int, what: str) -> list[dict]:
    """n_ticks clean ticks of the named queries, each result held against
    its solo bytes; per tick the program's stage ms and the stats moved."""
    tile = db.query_engine.tile_executor()
    sqls = [sql for _n, sql in named]
    out = []
    for i in range(n_ticks):
        results, delta, wall = _clean_tick(db, sqls, TICK_WINDOW_MS)
        for (name, sql), r in zip(named, results):
            if _ipc_bytes(r) != refs[sql]:
                raise AssertionError(f"{what} tick {i}: {name} differs from its solo run")
        tick = tile.last_tick
        out.append({"wall_ms": wall, "stage_ms": dict(tick.last_stage_ms),
                    "new_programs": delta["tick_graph_captures"], "members": delta["batch_members"],
                    "agg_hash": delta["agg_hash"], "agg_sort": delta["agg_sort"]})
        emit({"phase": "tick", "what": what, "i": i, **out[-1]})
    return out


def _sync_free(program, is_cuda: bool) -> None:
    """Run a tick program's members eagerly with every synchronizing CUDA
    call an error (torch's sync debug mode)."""
    if not is_cuda:
        return
    import torch

    torch.cuda.set_sync_debug_mode("error")
    try:
        program.run_members()
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def run_tick_phase(db, tsbs: Tsbs, is_cuda: bool, n_ticks: int = 5) -> dict:
    """Phase 5c, on phase 5's resident region: the 15 queries as the
    dashboard tick (`batch.window_ms` 120, `max_members` 16): n_ticks
    ticks, then n_ticks with every window a bucket later and the host
    literals changed.  Each tick must be one tick-program run
    (`batch_fused_dispatches` +1, `tick_graph_replays` +1) serving all 15
    members, each result byte-identical to the same query's solo run; the
    first tick builds the program (on the card: captures the CUDA graph),
    and the slid ticks build none.  Then a result-cache re-hit that
    launches nothing.  Launch counts: 0 before the ticks, read after."""
    import torch

    eng = db.query_engine
    bc = db.config.batch
    tile = eng.tile_executor()
    named = tsbs.queries()
    slid = slid_queries(tsbs)
    bc.window_ms, bc.max_members, bc.fuse_programs = 0.0, 16, True
    refs, solo_ms = _solo_refs(db, named, is_cuda)
    slid_refs, _ms = _solo_refs(db, slid, is_cuda, reps=1)
    bc.window_ms = TICK_WINDOW_MS
    try:
        s0 = dict(eng.stats)
        reset_counts()  # the tick's main path starts here
        ticks = _tick_series(db, named, refs, n_ticks, "warm")
        program = tile.last_tick
        slid_ticks = _tick_series(db, slid, slid_refs, n_ticks, "slid")
        launches, shapes = launch_counts(), shape_counts()  # ... and ends here
        s2 = dict(eng.stats)
    finally:
        bc.window_ms = 0.0
    # counted over the clean ticks (a round that split the members into
    # two ticks may build a program for a smaller multiset)
    captured = [t["new_programs"] for t in ticks]
    recaptured = sum(t["new_programs"] for t in slid_ticks)
    if captured != [1] + [0] * (n_ticks - 1) or recaptured:
        raise AssertionError(f"tick programs built: {captured} for the warm ticks, {recaptured} "
                             "after the slide (expected one, then none)")
    if tile.last_tick is not program:
        raise AssertionError("the slid ticks ran another tick program")
    replays = s2["tick_graph_replays"] - s0["tick_graph_replays"]
    # no host read between a dispatch's start and its readback: the members
    # run eagerly, back to back, under the sync debug mode "error" (the
    # graph's capture already refused any sync); then B19 against that
    # plain form
    _sync_free(program, is_cuda)
    plain_ms = _timed(program.run_members, 3) if is_cuda else None
    replay_ms = [t["stage_ms"]["replay"] for t in ticks[1:] + slid_ticks]
    # the result cache: a re-asked window is served with no launch
    bc.result_cache_mb = 64
    try:
        name, sql = named[0]
        db.sql_one(sql)
        before, h0 = launch_counts(), eng.stats["result_cache_hits"]
        again = db.sql_one(sql)
        if eng.stats["result_cache_hits"] != h0 + 1 or launch_counts() != before:
            raise AssertionError("the result-cache re-hit launched kernels or missed")
        if _ipc_bytes(again) != refs[sql]:
            raise AssertionError("the result-cache re-hit differs from the solo bytes")
    finally:
        bc.result_cache_mb = 0
    out = {
        "members": len(named), "ticks": ticks, "slid_ticks": slid_ticks, "replays": replays,
        "launches": launches, "shape_launches": shapes, "capture_ms": program.capture_ms,
        "pool_bytes": program.pool_bytes,
        "readback_bytes": program.readback_bytes, "bytes_moved": program.bytes_moved(),
        "replay_p50_ms": float(np.median(replay_ms)) if replay_ms else None,
        "plain_ms": plain_ms,
        "wall_p50_ms": float(np.median([t["wall_ms"] for t in ticks[1:] + slid_ticks])),
        "solo_p50_ms": solo_ms, "solo_p50_sum_ms": float(sum(solo_ms.values())),
    }
    emit({"phase": "tick_summary", **{k: v for k, v in out.items()
                                        if k not in ("ticks", "slid_ticks")}})
    if is_cuda:
        torch.cuda.synchronize()
    return out


# ---- phase 5b: live ingest on the resident region --------------------------------------

def live_append(db, tsbs: Tsbs, new_hosts: int) -> int:
    """LIVE_MINUTES more minutes at the 10 s scrape after the load's end,
    for the load's hosts and `new_hosts` new ones (host_<n> ..), through
    Database.write with the WAL on, then flush.  Returns the rows."""
    import pyarrow as pa

    hosts = np.array([f"host_{i}" for i in range(tsbs.n_hosts + new_hosts)])
    ticks = LIVE_MINUTES * 60 // SCRAPE_S
    rng = np.random.default_rng(SEED + 1)
    ts = tsbs.end + np.arange(ticks, dtype=np.int64)[:, None] * (SCRAPE_S * 1000)
    ts = np.broadcast_to(ts, (ticks, hosts.size)).reshape(-1)
    n = ts.size
    db.write("cpu", pa.table({
        "hostname": pa.array(np.broadcast_to(hosts[None, :], (ticks, hosts.size)).reshape(-1)),
        "ts": pa.array(ts, pa.timestamp("ms")),
        **{m: pa.array(rng.uniform(0.0, 100.0, n), pa.float64()) for m in tsbs.metrics},
    }))
    db.flush()
    return n


def having_queries(tsbs: Tsbs) -> list[tuple[str, str]]:
    lo, hi = tsbs.w12
    base = (f"SELECT hostname, time_bucket('1h', ts) AS tb, max(usage_user) AS mu, "
            f"avg(usage_system) AS asys FROM cpu WHERE ts >= {lo} AND ts < {hi} "
            f"GROUP BY hostname, tb ")
    return [
        ("having-and-not", base + "HAVING max(usage_user) > 99.5 AND NOT (avg(usage_system) >= 60)"),
        ("having-or-orderby-limit",
         base + "HAVING max(usage_user) > 99 OR count(*) < 300 ORDER BY mu DESC LIMIT 10"),
    ]


def _same_planes(a, b, what: str) -> None:
    if (a is None) != (b is None):
        raise AssertionError(f"{what}: present in one entry only")
    if a is not None:
        _same_chunks(a, b, what)


def check_against_rebuild(db, table_key: str, tag_cols: list, ts_col: str,
                          is_cuda: bool) -> dict:
    """The (delta-extended) entry of a one-region table against a
    from-scratch rebuild of the same file set on the same device (a fresh
    cache: Parquet decode, encode, lexsort, upload): every resident
    column, its present mask, `valid`, `order` and the sorted host copies,
    byte for byte.  Returns the rebuild's ms."""
    from greptimedb_tpu_torch.parallel.tile_planes import TileCacheManager

    cache = db.query_engine.tile_cache
    (rid, entry), = list(cache._super.items())
    region = db.storage.region(rid)
    dictionary = db.dicts.get(table_key)
    fresh = TileCacheManager(8 << 30, chunk_rows=cache.chunk_rows, device=cache.device,
                             config=cache.config, tile_config=cache.tile_config)
    value_cols = sorted(c for c in entry.cols if c not in tag_cols and c != ts_col)
    t0 = time.perf_counter()
    rebuilt, excluded = fresh.super_tiles(region, dictionary, region.files(), list(tag_cols),
                                          ts_col, value_cols, {rid}, list(tag_cols))
    if is_cuda:
        import torch

        torch.cuda.synchronize()
    rebuild_ms = (time.perf_counter() - t0) * 1e3
    if rebuilt is None or excluded or rebuilt.file_ids != entry.file_ids:
        raise AssertionError("the rebuild did not cover the extended entry's files")
    if rebuilt.num_rows != entry.num_rows or rebuilt.pad != entry.pad:
        raise AssertionError(f"rows {entry.num_rows}/{entry.pad} vs rebuilt "
                             f"{rebuilt.num_rows}/{rebuilt.pad}")
    if set(rebuilt.cols) != set(entry.cols) or set(rebuilt.nulls) != set(entry.nulls):
        raise AssertionError("the rebuild holds other planes")
    for name in entry.cols:
        _same_planes(entry.cols[name], rebuilt.cols[name], f"rebuild {name}")
    for name in entry.nulls:
        _same_planes(entry.nulls[name], rebuilt.nulls[name], f"rebuild nulls {name}")
    _same_planes(entry.valid, rebuilt.valid, "rebuild valid")
    if not np.array_equal(entry.order, rebuilt.order):
        raise AssertionError("rebuild: order differs")
    for name, arr in entry.sorted_host.items():
        if not np.array_equal(arr, rebuilt.sorted_host[name]):
            raise AssertionError(f"rebuild: sorted host {name} differs")
    del fresh, rebuilt
    return {"rebuild_ms": rebuild_ms, "planes": sorted(entry.cols), "entry_rows": entry.num_rows}


def run_live_phase(db, tsbs: Tsbs, is_cuda: bool, full_size: bool,
                   new_hosts: int = LIVE_NEW_HOSTS) -> dict:
    """Phase 5b, on phase 5's resident region: LIVE_MINUTES more minutes
    for the hosts and `new_hosts` new ones, written and flushed; the next
    tile query must extend the entry in place (delta_extends +1, builds
    +0; K15 remaps the moved host codes, K16 patches every plane).  Then
    the 15 queries with their windows moved to the new end and two HAVING
    queries (consumed on the card: K13), each once cold and once warm on
    the tile path against the CPU backend (rel 1e-7 for sum/avg); then
    the extended entry against a from-scratch rebuild, byte for byte."""
    from greptimedb_tpu_torch.parallel import tile_planner

    eng = db.query_engine
    if is_cuda:
        import torch
    t0 = time.perf_counter()
    rows = live_append(db, tsbs, new_hosts)
    append_s = time.perf_counter() - t0
    live = Tsbs(tsbs.n_hosts, tsbs.hours, len(tsbs.metrics), end=tsbs.end + LIVE_MINUTES * 60_000)
    specs = []
    real_plan = tile_planner.plan_device_finalize

    def spy(*args, **kwargs):
        specs.append(real_plan(*args, **kwargs))
        return specs[-1]

    per_query = {}
    delta = None
    tile_planner.plan_device_finalize = spy
    reset_counts()  # the live phase's run starts here
    try:
        for i, (name, sql) in enumerate(live.queries() + having_queries(live)):
            stats0 = eng.tile_cache.stats()
            before = launch_counts()
            specs.clear()
            t1 = time.perf_counter()
            first = db.sql_one(sql)
            if is_cuda:
                torch.cuda.synchronize()
            cold_ms = (time.perf_counter() - t1) * 1e3
            if eng.last_path != "tile":
                raise AssertionError(f"live {name}: answered by the {eng.last_path!r} path")
            cold_stages = dict(eng.last_timings)
            ran = {k for k, v in launch_counts().items() if v > before[k]}
            if i == 0:
                stats1 = eng.tile_cache.stats()
                delta = {
                    "delta_extends": stats1["delta_extends"] - stats0["delta_extends"],
                    "builds": stats1["builds"] - stats0["builds"],
                    "delta_host_ms": cold_stages.get("delta_host"),
                    "delta_device_ms": cold_stages.get("delta_device"),
                    "query_ms": cold_ms, "launched": sorted(ran),
                }
                if delta["delta_extends"] != 1 or delta["builds"] != 0:
                    raise AssertionError(f"live {name}: not the delta route: {delta}")
                if is_cuda and not {_GATHER, _PATCH} <= ran:
                    raise AssertionError(f"live {name}: launched {sorted(ran)}, the delta route "
                                         "needs K15 (remap) and K16")
            if name.startswith("having"):
                if not specs or specs[-1] is None or specs[-1].having is None:
                    raise AssertionError(f"live {name}: HAVING not consumed on the device")
                if is_cuda and _HAVING not in ran:
                    raise AssertionError(f"live {name}: K13 did not launch")
            got, stages, rel = _tile_against_cpu(db, sql, f"live {name}", inexact=("asys",))
            if not got.equals(first):
                raise AssertionError(f"live {name}: the warm run differs from the cold run")
            if got.num_rows == 0 and not name.startswith("having"):
                raise AssertionError(f"live {name}: empty result")
            per_query[name] = {"rows_out": got.num_rows, "cold_ms": cold_ms,
                               "cold_stage_ms": cold_stages, "warm_stage_ms": stages,
                               "max_rel_err": rel,
                               "launched": sorted(ran)}
            emit({"phase": "live_query", "name": name, **per_query[name]})
    finally:
        tile_planner.plan_device_finalize = real_plan
    totals, shapes = launch_counts(), shape_counts()  # the live phase's launches end here
    having_tick = run_having_tick(db, live, is_cuda)
    # K15's launches here: the gathers of the rebuilt time-major copies,
    # one call a build as planned, and the delta route's remaps
    k15 = dict(K15_PLANNED)
    if is_cuda and (k15["made"] > totals[_GATHER] or k15["builds"] != k15["calls"]):
        raise AssertionError(f"K15 on the live phase: {totals[_GATHER]} launches, {k15}")
    rebuild = check_against_rebuild(db, "public.cpu", ["hostname"], "ts", is_cuda)
    out = {"rows": rows, "append_s": append_s, "delta": delta, **rebuild,
           "seconds": time.perf_counter() - t0, "queries": per_query, "launches": totals,
           "shape_launches": shapes, "k15_calls": k15, "having_tick": having_tick}
    emit({"phase": "live", **{k: v for k, v in out.items() if k != "queries"}})
    return out


def run_having_tick(db, tsbs: Tsbs, is_cuda: bool, n_ticks: int = 2) -> dict:
    """The two HAVING queries as one dashboard tick (K13 and K7 inside the
    tick program's CUDA graph), then the same with their HAVING literals
    changed: the second series must replay the first's program (no new
    capture) with the literals rewritten in its input buffer, and every
    result must equal its solo run's bytes — and at least one differs from
    the first series', so the rewrite is seen."""
    eng = db.query_engine
    bc = db.config.batch
    tile = eng.tile_executor()
    named = having_queries(tsbs)
    moved = [(f"{name} (literals moved)",
              sql.replace("> 99.5 AND", "> 99.2 AND").replace(">= 60)", ">= 55)")
              .replace("> 99 OR", "> 101 OR"))
             for name, sql in named]
    if any(a == b for (_n, a), (_m, b) in zip(named, moved)):
        raise AssertionError("the HAVING tick's moved literals did not change a query")
    bc.window_ms, bc.max_members, bc.fuse_programs = 0.0, 16, True
    refs, _ms = _solo_refs(db, named, is_cuda, reps=1)
    moved_refs, _ms = _solo_refs(db, moved, is_cuda, reps=1)
    if all(refs[a] == moved_refs[b] for (_n, a), (_m, b) in zip(named, moved)):
        raise AssertionError("the moved HAVING literals give the same results")
    bc.window_ms = TICK_WINDOW_MS
    try:
        first = _tick_series(db, named, refs, n_ticks, "having")
        program = tile.last_tick
        second = _tick_series(db, moved, moved_refs, n_ticks, "having, literals moved")
    finally:
        bc.window_ms = 0.0
    captured = [t["new_programs"] for t in first + second]
    if captured != [1] + [0] * (2 * n_ticks - 1) or tile.last_tick is not program:
        raise AssertionError(f"HAVING tick programs built: {captured} (expected one, then none)")
    out = {"ticks": len(captured), "captures": sum(captured),
           "replay_ms": [t["stage_ms"]["replay"] for t in first[1:] + second]}
    emit({"phase": "having_tick", **out})
    return out


# ---- the TQL (PromQL) slice --------------------------------------------------------

# Two Prometheus metrics in GreptimeDB's remote-write layout (one table per
# metric, labels as the primary key, not append_mode: GreptimeDB dedups
# remote writes on (labels, ts)), from the same seeded TSBS hosts: the
# TSBS gauge usage_user and a counter like TSBS devops' net.bytes_recv.
PROM_GAUGE, PROM_COUNTER = "cpu_usage_user", "net_bytes_recv"
_STRIP, _WIN, _FIN, _FOLD = TQL_KERNELS = (
    "strip_counter_resets", "range_windows", "range_finalize", "series_fold")
EXPECTED_TQL_PATH = {
    "T1": {_STRIP, _WIN, _FIN},
    "T2": {_STRIP, _WIN, _FIN, _FOLD},
    "T3": {_STRIP, _WIN, _FIN},
    "T4": {_WIN, _FIN},
    "T5": {_WIN, _FIN, _FOLD},
    "T6": {_WIN, _FIN},
    "T7": {_WIN, _FIN},
}
# the counter queries: the legacy path's reset strip and the tile path's
# agree to the last ulp only on series with a reset (rel 1e-12); every
# other result is held exact
TQL_ULP = {"T1", "T2", "T3"}
# hosts whose counter the numpy twin recomputes from the generator
TWIN_HOSTS = (0, 1, 16, 42, 703)


def tql_queries(n_hosts: int) -> list[tuple[str, str]]:
    """A Grafana dashboard's PromQL over the two metrics."""
    one = f"host_{42 % n_hosts}"
    return [
        ("T1", f"rate({PROM_COUNTER}[5m])"),
        ("T2", f"sum(rate({PROM_COUNTER}[5m]))"),
        ("T3", f"increase({PROM_COUNTER}[1h])"),
        ("T4", f"avg_over_time({PROM_GAUGE}[5m])"),
        ("T5", f"max(max_over_time({PROM_GAUGE}[10m]))"),
        ("T6", f'{PROM_GAUGE}{{hostname=~"host_1.*"}}'),
        ("T7", f'count_over_time({PROM_GAUGE}{{hostname="{one}"}}[5m])'),
    ]


def tql(promql: str, lo_ms: int, hi_ms: int, step: str) -> str:
    return f"TQL EVAL ({lo_ms // 1000}, {hi_ms // 1000}, '{step}') {promql}"


def ingest_prom(db, tsbs: Tsbs, samples: dict | None = None) -> tuple[int, dict]:
    """Both metrics through Database.write (WAL on), one pass over the
    ticks, then flush.  Every scrape adds a seeded positive increment to
    each host's counter; one host in 16 restarts once (its counter drops
    to a small value).  Then a remote-write retry re-sends the counter's
    last half hour, identical samples in a new SST that overlaps the last
    one (the dedup keep plane serves it).  Returns (rows written, the
    counter samples of TWIN_HOSTS: host -> (ts, values)); `samples`, when
    given, receives every value written as [tick, host] matrices under
    PROM_GAUGE and PROM_COUNTER (phase 6b's ground truth)."""
    import pyarrow as pa

    for name in (PROM_GAUGE, PROM_COUNTER):
        db.sql(f"CREATE TABLE {name} (hostname STRING, greptime_value DOUBLE, "
               "greptime_timestamp TIMESTAMP(3) TIME INDEX, PRIMARY KEY (hostname))")
    n_hosts = tsbs.n_hosts
    rng = np.random.default_rng(SEED + 1)
    ticks_total = tsbs.hours * 3600 // SCRAPE_S
    chunk_ticks = max(1, 2_000_000 // n_hosts)
    hosts_arr = np.array([f"host_{i}" for i in range(n_hosts)])
    level = rng.uniform(1e6, 1e9, n_hosts)  # counter value before the first scrape
    restart = np.where(np.arange(n_hosts) % 16 == 5, rng.integers(1, ticks_total, n_hosts), -1)
    twin_rows = [h for h in TWIN_HOSTS if h < n_hosts]
    twin = {h: ([], []) for h in twin_rows}
    if samples is not None:
        for name in (PROM_GAUGE, PROM_COUNTER):
            samples[name] = np.empty((ticks_total, n_hosts))
    last_batch = None
    n_rows = 0
    for start in range(0, ticks_total, chunk_ticks):
        ticks = min(chunk_ticks, ticks_total - start)
        tick = start + np.arange(ticks)
        ts = T0 + tick.astype(np.int64) * (SCRAPE_S * 1000)
        incr = rng.uniform(0.0, 2e5, (ticks, n_hosts))
        counter = level[None, :] + np.cumsum(incr, axis=0)
        hit = (restart[None, :] >= tick[:, None]) & (restart[None, :] < tick[0] + ticks)
        for h in np.nonzero(hit.any(axis=0))[0]:
            at = restart[h] - tick[0]
            counter[at:, h] -= counter[at, h] - rng.uniform(0.0, 1e4)
        level = counter[-1].copy()
        gauge = rng.uniform(0.0, 100.0, (ticks, n_hosts))
        ts_rows = np.repeat(ts, n_hosts)
        hs = np.broadcast_to(hosts_arr[None, :], (ticks, n_hosts)).reshape(-1)
        for name, vals in ((PROM_GAUGE, gauge), (PROM_COUNTER, counter)):
            batch = pa.table({
                "hostname": pa.array(hs),
                "greptime_value": pa.array(vals.reshape(-1), pa.float64()),
                "greptime_timestamp": pa.array(ts_rows, pa.timestamp("ms")),
            })
            db.write(name, batch)
            if samples is not None:
                samples[name][start:start + ticks] = vals
            if name == PROM_COUNTER:
                last_batch = batch
        for h in twin_rows:
            twin[h][0].append(ts)
            twin[h][1].append(counter[:, h])
        n_rows += 2 * ticks * n_hosts
    db.flush()
    retry_from = T0 + ticks_total * SCRAPE_S * 1000 - 1800_000
    tcol = last_batch["greptime_timestamp"].cast("int64").to_numpy()
    retry = last_batch.filter(pa.array(tcol >= retry_from))
    db.write(PROM_COUNTER, retry)
    db.flush()
    n_rows += retry.num_rows
    return n_rows, {h: (np.concatenate(t), np.concatenate(v)) for h, (t, v) in twin.items()}


def numpy_rate_twin(ts, vals, start, end, step, rng_ms) -> dict:
    """Prometheus rate() per eval step of one series, from raw samples
    (resets stripped with a sequential sum), after
    tests/test_tql_tile.py:174."""
    out = {}
    keep = (ts >= start - rng_ms) & (ts <= end)
    ts, vals = ts[keep], vals[keep]
    adj = vals.copy()
    acc = 0.0
    for i in range(1, len(adj)):
        if vals[i] < vals[i - 1]:
            acc += vals[i - 1]
        adj[i] = vals[i] + acc
    for t1 in range(start, end + 1, step):
        w = (ts > t1 - rng_ms) & (ts <= t1)
        if w.sum() < 2:
            continue
        wts, wv = ts[w], adj[w]
        si = float(wts[-1] - wts[0])
        avg = si / (len(wts) - 1)
        d_s, d_e = float(wts[0] - (t1 - rng_ms)), float(t1 - wts[-1])
        ext_s = d_s if d_s < avg * 1.1 else avg / 2.0
        ext_e = d_e if d_e < avg * 1.1 else avg / 2.0
        result = wv[-1] - wv[0]
        if result > 0 and wv[0] >= 0:
            zero_dur = si * (wv[0] / result)
            if 0 <= zero_dur < ext_s:
                ext_s = zero_dur
        out[t1] = result * ((si + ext_s + ext_e) / si) / (rng_ms / 1000.0)
    return out


def compare_tql(got, want, what: str, rtol: float) -> float:
    """Two TQL results: the same columns and rows (labels and ts exact),
    values exact or within relative `rtol`.  Returns the max rel error."""
    if got.column_names != want.column_names:
        raise AssertionError(f"{what}: columns {got.column_names} != {want.column_names}")
    if got.num_rows != want.num_rows:
        raise AssertionError(f"{what}: {got.num_rows} rows != {want.num_rows}")
    if got.num_rows == 0:
        raise AssertionError(f"{what}: empty result")
    keys = [c for c in got.column_names if c != "value"]
    g, w = _sorted_rows(got, keys), _sorted_rows(want, keys)
    for c in keys:
        if g[c].to_pylist() != w[c].to_pylist():
            raise AssertionError(f"{what}: column {c} differs")
    x = g["value"].to_numpy(zero_copy_only=False)
    y = w["value"].to_numpy(zero_copy_only=False)
    rel = np.abs(x - y) / np.maximum(np.abs(y), 1e-300)
    worst = float(rel.max())
    if (rtol == 0.0 and not np.array_equal(x, y)) or worst > rtol:
        raise AssertionError(f"{what}: max rel err {worst} (allowed {rtol})")
    return worst


def _tql_run(db, sql: str, is_cuda: bool):
    """(result, host ms through the last sync, stage ms, counter deltas)."""
    eng = db.query_engine
    before = dict(eng.stats)
    t1 = time.perf_counter()
    out = db.sql_one(sql)
    if is_cuda:
        import torch

        torch.cuda.synchronize()
    ms = (time.perf_counter() - t1) * 1e3
    return out, ms, dict(eng.last_tql_timings), {k: eng.stats[k] - before[k] for k in before}


def run_tql_slice(device: str, n_hosts: int, hours: int, reps: int, data_home: str,
                  prom_sql_reps: int = 3) -> dict:
    """Phase 6: TQL on `device` ("cuda" on the card; "cpu" rehearses the
    control flow with the plain versions).  Ingest both metrics, then:

    tile    T1-T7 over the whole load at '60s' on the warm tile path: one
            cold run (plane build, upload and dedup keep plane split out)
            and `reps` warm runs; every run one tile dispatch and no
            decline; on the card each query launches EXPECTED_TQL_PATH
            (counts set to 0 before this run, read after it);
    legacy  T1-T7 over the last hour at '15s' with tql.tile off (region
            scan, upload, K9-K11 on the card, host folds), each held
            against the tile path on the same window;
    twin    T1 of TWIN_HOSTS at the whole load against a numpy twin;
    6b      SQL panels over the same tables (run_prom_sql_phase,
            `prom_sql_reps` warm runs);
    cpu     the legacy hour again through Database(device="cpu"), the plain
            versions, held against the card's legacy results."""
    from greptimedb_tpu_torch import Database

    tsbs = Tsbs(n_hosts, hours)
    is_cuda = device.startswith("cuda")
    db = Database(data_home, device=device, config=device_route_config())
    t0 = time.perf_counter()
    samples: dict = {}
    n_rows, twin = ingest_prom(db, tsbs, samples)
    ingest_s = time.perf_counter() - t0
    emit({"phase": "tql_ingest", "rows": n_rows, "seconds": ingest_s,
          "rows_per_s": n_rows / ingest_s})
    lo12, hi = tsbs.end - hours * H3600, tsbs.end
    full_size = n_hosts == 4000 and hours == 12
    eng = db.query_engine

    # -- tile, the whole load at '60s' (the main path) --
    per_query = {}
    results12 = {}
    reset_counts()
    for name, promql in tql_queries(n_hosts):
        sql = tql(promql, lo12, hi, "60s")
        before = launch_counts()
        runs = []
        for _ in range(1 + reps):
            out, ms, stages, delta = _tql_run(db, sql, is_cuda)
            if delta["tql_tile_dispatches"] != 1 or delta["tql_tile_declined"] or delta["tql_legacy"]:
                raise AssertionError(f"{name}: not one warm tile dispatch: {delta}")
            runs.append((ms, stages))
        results12[name] = out
        launched = {k: v - before[k] for k, v in launch_counts().items() if v - before[k]}
        if is_cuda:
            ran = set(launched)
            if ran != EXPECTED_TQL_PATH[name]:
                raise AssertionError(f"{name}: launched {sorted(ran)}, path is "
                                     f"{sorted(EXPECTED_TQL_PATH[name])}")
        warm = runs[1:] if reps else runs
        keys = sorted({k for _m, st in warm for k in st})
        per_query[name] = {
            "promql": promql, "rows_out": out.num_rows,
            "cold_ms": runs[0][0], "cold_stage_ms": runs[0][1],
            "warm_p50_ms": float(np.median([m for m, _s in warm])),
            "warm_stage_p50_ms": {k: float(np.median([st.get(k, 0.0) for _m, st in warm]))
                                  for k in keys},
            "launches": launched,
        }
        if out.num_rows == 0 or not np.isfinite(out["value"].to_numpy()).all():
            raise AssertionError(f"{name}: empty or non-finite result")
        emit({"phase": "tql_tile_query", "name": name, **per_query[name]})
    tile_launches = launch_counts()  # the main path's launches end here
    tile_shapes = shape_counts()
    k9_calls = call_counts(_STRIP)

    # -- numpy twin of T1 on a few hosts over the whole load --
    t1_rows = results12["T1"]
    hosts = t1_rows["hostname"].to_pylist()
    tss = t1_rows["ts"].cast("int64").to_pylist()
    vals = t1_rows["value"].to_pylist()
    twin_err = 0.0
    for h, (hts, hv) in twin.items():
        want = numpy_rate_twin(hts, hv, lo12, hi, 60_000, 300_000)
        got = {t: v for hh, t, v in zip(hosts, tss, vals) if hh == f"host_{h}"}
        if set(got) != set(want):
            raise AssertionError(f"T1 twin host_{h}: {len(got)} steps, twin {len(want)}")
        for t, v in want.items():
            err = abs(got[t] - v) / max(abs(v), 1e-300)
            twin_err = max(twin_err, err)
            if err > 1e-9:
                raise AssertionError(f"T1 twin host_{h} at {t}: {got[t]} vs {v}")
    emit({"phase": "tql_twin", "hosts": sorted(twin), "max_rel_err": twin_err})

    # -- legacy on the card over the last hour at '15s', against the tile path --
    lo1 = hi - H3600
    legacy = {}
    legacy_launches = {k: 0 for k in launch_counts()}
    legacy_shapes: dict[str, int] = {}
    for name, promql in tql_queries(n_hosts):
        sql = tql(promql, lo1, hi, "15s")
        db.config.tql.tile = False
        before, shapes_before = launch_counts(), shape_counts()
        try:
            out, ms, stages, delta = _tql_run(db, sql, is_cuda)
        finally:
            db.config.tql.tile = True
        for k, v in launch_counts().items():
            legacy_launches[k] += v - before[k]
        for k, v in shape_counts().items():
            if v - shapes_before.get(k, 0):
                legacy_shapes[k] = legacy_shapes.get(k, 0) + v - shapes_before.get(k, 0)
        if delta["tql_legacy"] != 1 or delta["tql_tile_dispatches"] or delta["tql_tile_declined"]:
            raise AssertionError(f"{name}: not one legacy evaluation: {delta}")
        tile_out, tile_ms, _st, tdelta = _tql_run(db, sql, is_cuda)
        if tdelta["tql_tile_dispatches"] != 1:
            raise AssertionError(f"{name} (1 h): the tile path did not answer")
        rel = compare_tql(out, tile_out, f"{name} legacy vs tile",
                          1e-12 if name in TQL_ULP else 0.0)
        legacy[name] = {"result": out, "ms": ms, "stages": stages, "tile_ms": tile_ms,
                        "max_rel_err_vs_tile": rel}
        emit({"phase": "tql_legacy_query", "name": name, "rows_out": out.num_rows,
              "ms": ms, "stage_ms": stages, "tile_ms": tile_ms, "max_rel_err_vs_tile": rel})
    if is_cuda and (not all(legacy_launches[k] for k in (_STRIP, _WIN, _FIN))
                    or legacy_launches[_FOLD]):
        raise AssertionError(f"the legacy path did not launch K9-K11: {legacy_launches}")
    cache = eng.tile_cache.stats()
    prom_sql = run_prom_sql_phase(db, tsbs, samples, is_cuda, prom_sql_reps)
    del samples
    _free(db)
    del db
    # phase 5e's TQL step: a first touch under the fused build
    first_touch = run_tql_first_touch(data_home, device, tsbs, legacy["T2"]["result"])

    # -- the CPU backend (plain versions) over the same hour --
    cpu_db = Database(data_home, device="cpu", config=device_route_config())
    cpu_db.config.tql.tile = False
    cpu = {}
    try:
        for name, promql in tql_queries(n_hosts):
            out, ms, _st, delta = _tql_run(cpu_db, tql(promql, lo1, hi, "15s"), False)
            if delta["tql_legacy"] != 1:
                raise AssertionError(f"{name} (cpu): not one legacy evaluation")
            rel = compare_tql(legacy[name]["result"], out, f"{name} card vs cpu",
                              1e-12 if name in TQL_ULP else 0.0)
            cpu[name] = {"ms": ms, "max_rel_err": rel}
            emit({"phase": "tql_cpu_query", "name": name, "ms": ms, "max_rel_err": rel})
    finally:
        cpu_db.close()
    return {
        "rows": n_rows, "ingest_s": ingest_s, "queries": per_query,
        "launches": tile_launches, "legacy_launches": legacy_launches,
        "shape_launches": tile_shapes, "legacy_shape_launches": legacy_shapes,
        "k9_calls": k9_calls,
        "legacy": {k: {kk: vv for kk, vv in v.items() if kk != "result"}
                   for k, v in legacy.items()},
        "cpu": cpu, "twin_max_rel_err": twin_err, "cache": cache,
        "full_size": full_size, "prom_sql": prom_sql, "first_touch": first_touch,
    }


# ---- phase 6b: SQL over the remote-write tables (keep plane, window tiles) ----

PROM_TS, PROM_VAL = "greptime_timestamp", "greptime_value"
# the corrected remote write: hosts = 3 (mod 16), the last 10 minutes
OVERWRITE_MOD, OVERWRITE_HOST, OVERWRITE_TICKS, OVERWRITE_DELTA = 16, 3, 60, 0.5
# the passes each panel's trace must record: fired (True) or declined
# (False).  Where `dedup_plane` is not named, the panel's in-window files
# decide: the keep plane fires where they overlap (at 4000 hosts a flush
# cuts a memtable into SSTs by host range, each over the memtable's whole
# time range) and must not appear where they do not
PROM_SQL_PASSES = {
    "P1": {"dedup_plane": True, "window_tile": True},
    "P1b": {"window_tile": True},
    "P2": {"dedup_plane": True, "window_tile": False},
    "P3": {"dedup_plane": True},
    "P4": {"dedup_plane": True},
    "P5": {"window_tile": True},
}
# each panel's window [lo, hi) in ms from the load's end (None: the whole
# table) and its time bucket in ms
PROM_SQL_WINDOWS = {"P1": ((-H3600, 0), 60_000), "P1b": ((-3 * H3600, -2 * H3600), 60_000),
                    "P2": ((-12 * H3600, 0), H3600), "P3": ((-12 * H3600, 0), 300_000),
                    "P4": (None, None), "P5": ((-H3600, 0), None)}
# the kernels each panel of phase 6b launches at the default size (4000
# hosts x 12 h), its cold and warm runs together, as the card ran them:
# "P1'" etc. are the reruns after the corrected write.  A grouped panel
# runs K2 with K18 + K3 behind its guard (predicated launches), avg
# through K6 on the limb planes K5 quantizes in the cold run (P1, P1b:
# the window tile's chunk; P2: the full planes; P5: the gauge's window
# tile); P3's time-major plan sorts (K14) and gathers its copies with the
# keep plane's in one K15 call, again after the write; P4 and P5 select
# on the card (K7), P4 folds last values (K4); P1' extends the entry by
# K16 first; P1b' reads its kept window tile (no K5).
_PROM_GROUPED = {_MASK, _BLOCKED, _SCATTER, _SORT, _LIMB, _PACK}
_PROM_TIME_MAJOR = {_MASK, _SORT, _QUANT, _LIMB, _PACK, _ARGSORT, _GATHER}
_PROM_LAST = {_MASK, _BLOCKED, _SCATTER, _SORT, _LAST, _TOPK, _PACK}
EXPECTED_PROM_SQL_PATH: dict[str, set] | None = {
    "P1": _PROM_GROUPED | {_QUANT}, "P1b": _PROM_GROUPED | {_QUANT},
    "P2": _PROM_GROUPED | {_QUANT}, "P3": _PROM_TIME_MAJOR, "P4": _PROM_LAST,
    "P5": {_MASK, _SORT, _QUANT, _LIMB, _TOPK, _PACK},
    "P1'": _PROM_GROUPED | {_QUANT, _PATCH}, "P1b'": _PROM_GROUPED,
    "P3'": _PROM_TIME_MAJOR, "P4'": _PROM_LAST,
}


def prom_sql_panels(tsbs: Tsbs) -> list[tuple[str, str, str]]:
    """(name, table, SQL) of the remote-write dashboard's SQL panels."""
    def win(name):
        lo, hi = PROM_SQL_WINDOWS[name][0]
        return f"WHERE {PROM_TS} >= {tsbs.end + lo} AND {PROM_TS} < {tsbs.end + hi}"

    def per_host(name, aggs):
        b = {60_000: "1m", H3600: "1h"}[PROM_SQL_WINDOWS[name][1]]
        return (f"SELECT hostname, time_bucket('{b}', {PROM_TS}) AS tb, {aggs} "
                f"FROM {PROM_COUNTER} {win(name)} GROUP BY hostname, tb")

    avg_count = f"avg({PROM_VAL}) AS av, count(*) AS c"
    return [
        ("P1", PROM_COUNTER, per_host("P1", avg_count)),
        ("P1b", PROM_COUNTER, per_host("P1b", avg_count)),
        ("P2", PROM_COUNTER, per_host("P2", f"max({PROM_VAL}) AS mx, " + avg_count)),
        ("P3", PROM_COUNTER, f"SELECT time_bucket('5m', {PROM_TS}) AS tb, {avg_count} "
                             f"FROM {PROM_COUNTER} {win('P3')} GROUP BY tb"),
        ("P4", PROM_COUNTER, f"SELECT hostname, last_value({PROM_VAL}) AS lv "
                             f"FROM {PROM_COUNTER} GROUP BY hostname"),
        ("P5", PROM_GAUGE, f"SELECT hostname, avg({PROM_VAL}) AS av FROM {PROM_GAUGE} "
                           f"{win('P5')} GROUP BY hostname ORDER BY av DESC LIMIT 10"),
    ]


def prom_sql_truth(name: str, samples: dict, tsbs: Tsbs) -> dict:
    """The numpy ground truth of one panel from the generator's samples
    ([tick, host], one tick every SCRAPE_S from T0): {key: values}, keys
    (hostname, bucket ms) / bucket ms / hostname, in the panel's order
    for P5."""
    per_tick = SCRAPE_S * 1000
    _n_ticks, n_hosts = samples[PROM_COUNTER].shape
    t_end = (tsbs.end - T0) // per_tick
    hosts = [f"host_{h}" for h in range(n_hosts)]
    window, bucket = PROM_SQL_WINDOWS[name]
    if window is not None:
        lo, hi = (t_end + w // per_tick for w in window)
        t0 = T0 + lo * per_tick
        b = (bucket or per_tick) // per_tick

    c = samples[PROM_COUNTER]
    if name in ("P1", "P1b", "P2"):
        v = c[lo:hi].reshape(-1, b, n_hosts)
        out = {}
        for i in range(v.shape[0]):
            tb = t0 + i * b * per_tick
            means, maxes = v[i].mean(axis=0), v[i].max(axis=0)
            for h in range(n_hosts):
                vals = (float(means[h]), b) if name != "P2" else (float(maxes[h]), float(means[h]), b)
                out[(hosts[h], tb)] = vals
        return out
    if name == "P3":
        v = c[lo:hi].reshape(-1, b, n_hosts)
        return {t0 + i * b * per_tick: (float(v[i].mean()), b * n_hosts) for i in range(v.shape[0])}
    if name == "P4":
        return {hosts[h]: (float(c[t_end - 1, h]),) for h in range(n_hosts)}
    means = samples[PROM_GAUGE][lo:hi].mean(axis=0)
    top = np.argsort(-means, kind="stable")[:10]
    return {hosts[h]: (float(means[h]),) for h in top}


def check_prom_sql(name: str, table, truth: dict, rel: float = 1e-7) -> float:
    """A panel's rows against its ground truth: keys and counts exact, max
    and last exact, avg within `rel` (the limb verdict's bound).  Returns
    the max relative error of the averages."""
    import pyarrow as pa

    d = table.to_pydict()
    for c in table.column_names:
        if pa.types.is_timestamp(table.schema.field(c).type):
            d[c] = table[c].cast("int64").to_pylist()
    if name == "P3":
        keys = d["tb"]
        vals = list(zip(d["av"], d["c"]))
    elif name == "P4":
        keys = d["hostname"]
        vals = [(v,) for v in d["lv"]]
    elif name == "P5":
        keys = d["hostname"]
        vals = [(v,) for v in d["av"]]
        if keys != list(truth):
            raise AssertionError(f"{name}: top hosts {keys} != {list(truth)}")
    else:
        keys = list(zip(d["hostname"], d["tb"]))
        vals = (list(zip(d["mx"], d["av"], d["c"])) if name == "P2"
                else list(zip(d["av"], d["c"])))
    got = dict(zip(keys, vals))
    if len(got) != len(keys) or set(got) != set(truth):
        raise AssertionError(f"{name}: {len(keys)} rows, keys differ from the ground truth's "
                             f"{len(truth)}")
    worst = 0.0
    avg_at = {"P1": (0,), "P1b": (0,), "P2": (1,), "P3": (0,), "P5": (0,)}.get(name, ())
    for k, want in truth.items():
        have = got[k]
        for i, (x, y) in enumerate(zip(have, want)):
            if i in avg_at:
                err = abs(x - y) / max(abs(y), 1e-300)
                worst = max(worst, err)
                if err > rel:
                    raise AssertionError(f"{name} {k}: avg {x} vs {y} (rel {err})")
            elif x != y:
                raise AssertionError(f"{name} {k}: {x} != {y}")
    return worst


def _files_overlap(db, table: str, window) -> bool:
    """Whether any region of `table` holds SSTs whose time ranges overlap
    inside `window` ([lo, hi) in ms, None for all time)."""
    from greptimedb_tpu_torch.parallel.tile_planner import disjoint

    meta = db.catalog.table(table, db.current_database)
    for rid in meta.region_ids:
        ranges = [m.time_range for m in db.storage.region(rid).files()
                  if window is None or (m.time_range[1] >= window[0]
                                        and m.time_range[0] < window[1])]
        if not disjoint(ranges):
            return True
    return False


def prom_sql_passes(db, tsbs: Tsbs, name: str) -> dict:
    """The pass decisions a panel must record (PROM_SQL_PASSES, the keep
    plane where the files say)."""
    want = dict(PROM_SQL_PASSES[name])
    w = PROM_SQL_WINDOWS[name][0]
    table = PROM_GAUGE if name == "P5" else PROM_COUNTER
    overlap = _files_overlap(db, table, None if w is None else (tsbs.end + w[0],
                                                                tsbs.end + w[1]))
    if "dedup_plane" in want and want["dedup_plane"] != overlap:
        raise AssertionError(f"{name}: the in-window files overlap: {overlap}")
    if overlap:
        want["dedup_plane"] = True
    return want


def _prom_sql_run(db, sql: str, is_cuda: bool):
    """(result, host ms through the last sync, stage ms, pass decisions,
    stats deltas)."""
    from greptimedb_tpu_torch.query import passes

    eng = db.query_engine
    before = dict(eng.stats)
    trace = passes.PassTrace()
    t1 = time.perf_counter()
    with passes.use_trace(trace):
        out = db.sql_one(sql)
    if is_cuda:
        import torch

        torch.cuda.synchronize()
    ms = (time.perf_counter() - t1) * 1e3
    decisions = [(d.name, d.fired) for d in trace.decisions
                 if d.name in ("dedup_plane", "window_tile")]
    delta = {k: eng.stats.get(k, 0) - before.get(k, 0) for k in eng.stats}
    return out, ms, dict(eng.last_timings), decisions, delta


def _prom_sql_panel(db, tsbs: Tsbs, name: str, sql: str, runs: int, truth: dict,
                    is_cuda: bool, full_size: bool, key: str | None = None) -> dict:
    """One panel: `runs` runs (the first cold), each on the tile route with
    the panel's passes and the ground truth's rows; the kernels of all
    runs together must be EXPECTED_PROM_SQL_PATH[key]."""
    key = key or name
    eng = db.query_engine
    before = launch_counts()
    cache0 = eng.tile_cache.stats() if eng.tile_cache is not None else {}
    times, stages, worst = [], [], 0.0
    want = prom_sql_passes(db, tsbs, name)
    for i in range(runs):
        out, ms, st, decisions, delta = _prom_sql_run(db, sql, is_cuda)
        if eng.last_path != "tile" or delta.get("tile_dispatches") != 1 \
                or delta.get("tile_declined"):
            raise AssertionError(f"{key}: answered by the {eng.last_path!r} path ({delta})")
        if dict(decisions) != want or len(decisions) != len(want):
            raise AssertionError(f"{key}: passes {decisions}, expected {want}")
        if i in (0, runs - 1):
            worst = max(worst, check_prom_sql(name, out, truth))
        times.append(ms)
        stages.append(st)
    launched = {k: v - before[k] for k, v in launch_counts().items() if v - before[k]}
    if is_cuda and full_size and EXPECTED_PROM_SQL_PATH is not None \
            and set(launched) != EXPECTED_PROM_SQL_PATH[key]:
        raise AssertionError(f"{key}: launched {sorted(launched)}, path is "
                             f"{sorted(EXPECTED_PROM_SQL_PATH[key])}")
    cache = eng.tile_cache.stats()
    warm = stages[1:] or stages
    rec = {
        "rows_out": out.num_rows, "cold_ms": times[0], "cold_stage_ms": stages[0],
        "warm_p50_ms": float(np.median(times[1:] or times)),
        "warm_stage_p50_ms": {k: float(np.median([st.get(k, 0.0) for st in warm]))
                              for k in sorted({k for st in warm for k in st})},
        "max_rel_err": worst, "passes": want, "launches": launched,
        "cache_delta": {k: cache[k] - cache0.get(k, 0) for k in
                        ("window_tile_builds", "dedup_keep_builds", "delta_extends", "builds")},
    }
    emit({"phase": "prom_sql_query", "name": key, **rec})
    return {**rec, "result": out}


def _overwrite_rows(samples: dict, tsbs: Tsbs, delta: float):
    """The corrected remote write: the counter's last OVERWRITE_TICKS
    samples of hosts = OVERWRITE_HOST (mod OVERWRITE_MOD), value + delta."""
    import pyarrow as pa

    c = samples[PROM_COUNTER]
    n_ticks, n_hosts = c.shape
    t_end = (tsbs.end - T0) // (SCRAPE_S * 1000)
    hs = np.arange(OVERWRITE_HOST, n_hosts, OVERWRITE_MOD)
    ticks = np.arange(t_end - OVERWRITE_TICKS, t_end)
    vals = c[np.ix_(ticks, hs)] + delta
    return pa.table({
        "hostname": pa.array(np.tile([f"host_{h}" for h in hs], len(ticks))),
        "greptime_value": pa.array(vals.reshape(-1), pa.float64()),
        "greptime_timestamp": pa.array(np.repeat(T0 + ticks * SCRAPE_S * 1000, len(hs)),
                                       pa.timestamp("ms")),
    }), ticks, hs


def run_prom_sql_phase(db, tsbs: Tsbs, samples: dict, is_cuda: bool, reps: int) -> dict:
    """Phase 6b: SQL panels over phase 6's remote-write tables (not
    append_mode; the counter's retried half hour overlaps its last SST) on
    the tile path: P1-P5 once cold and `reps` times warm, each on the tile
    route with its PROM_SQL_PASSES (dedup_plane, window_tile) and the
    numpy ground truth's rows.  Then P1b builds a second window tile on
    the counter's entry, a corrected remote write lands (hosts = 3 mod 16,
    the last 10 minutes, + 0.5) and is flushed: P1 must extend the entry
    in place (K16) and rebuild its window tile, P1b keep its own, P3
    rebuild its time-major copies, P4 show the new values.  The launch
    counts are set to 0 before and read after these runs.  Then P1 and
    P5 with both passes disabled (P1 declines to the table-fed route; P5,
    with no overlap, takes the full planes, and with the tile cache off
    the table-fed route), each giving the same rows; then the corrected
    rows are written back as they were (phase 6's CPU backend reads these
    files after this phase)."""
    eng = db.query_engine
    full_size = tsbs.n_hosts == 4000 and tsbs.hours == 12
    panels = {name: (table, sql) for name, table, sql in prom_sql_panels(tsbs)}
    t_start = time.perf_counter()
    reset_counts()  # phase 6b's main path starts here
    out: dict = {"queries": {}}
    for name in ("P1", "P2", "P3", "P4", "P5", "P1b"):
        out["queries"][name] = _prom_sql_panel(
            db, tsbs, name, panels[name][1], 1 + reps, prom_sql_truth(name, samples, tsbs),
            is_cuda, full_size)
    # the corrected remote write
    extends0 = eng.tile_cache.stats()["delta_extends"]
    batch, ticks, hs = _overwrite_rows(samples, tsbs, OVERWRITE_DELTA)
    t0 = time.perf_counter()
    db.write(PROM_COUNTER, batch)
    db.flush()
    write_ms = (time.perf_counter() - t0) * 1e3
    samples[PROM_COUNTER][np.ix_(ticks, hs)] += OVERWRITE_DELTA
    before = launch_counts()
    builds0 = eng.tile_cache.stats()["window_tile_builds"]
    for name in ("P1", "P1b", "P3", "P4"):
        key = name + "'"
        out["queries"][key] = _prom_sql_panel(
            db, tsbs, name, panels[name][1], 1 + reps, prom_sql_truth(name, samples, tsbs),
            is_cuda, full_size, key=key)
        if name == "P1b":
            rebuilt = eng.tile_cache.stats()["window_tile_builds"] - builds0
            if rebuilt != 1:
                raise AssertionError(f"window tiles built over P1' and P1b': {rebuilt}, "
                                     "expected P1's alone")
    extends = eng.tile_cache.stats()["delta_extends"] - extends0
    patched = launch_counts()["delta_patch"] - before["delta_patch"]
    if extends != 1 or (is_cuda and not patched):
        raise AssertionError(f"the corrected write: delta_extends +{extends}, K16 x {patched}")
    p4 = out["queries"]["P4'"]["result"]
    lv = dict(zip(p4["hostname"].to_pylist(), p4["lv"].to_pylist()))
    c = samples[PROM_COUNTER]
    new_values = {f"host_{h}": lv[f"host_{h}"] for h in hs[:4]}
    if any(lv[f"host_{h}"] != c[ticks[-1], h] for h in hs):
        raise AssertionError("P4': an overwritten host does not show its corrected value")
    out["launches"] = launch_counts()  # phase 6b's main path ends here
    out["shape_launches"] = shape_counts()
    emit({"phase": "prom_sql_overwrite", "rows": batch.num_rows, "write_flush_ms": write_ms,
          "delta_extends": extends, "k16_launches": patched,
          "window_tile_builds": {k: out["queries"][k]["cache_delta"]["window_tile_builds"]
                                 for k in ("P1'", "P1b'")},
          "p4_new_values": new_values,
          "stage_ms": out["queries"]["P1'"]["cold_stage_ms"]})

    # the table-fed comparisons (outside the counted runs): with both
    # passes off a panel over overlapping files declines to the table-fed
    # route; the gauge's, where its files do not overlap, takes the full
    # planes, and with the tile cache off the table-fed route
    saved = db.config.query.disabled_passes
    compare = {}
    p5_dedup = "dedup_plane" in out["queries"]["P5"]["passes"]
    try:
        db.config.query.disabled_passes = tuple(saved) + ("dedup_plane", "window_tile")
        for name, tile_cache in (("P1", True), ("P5", True)) + ((("P5", False),)
                                                                 if not p5_dedup else ()):
            db.config.query.tile_cache_enable = tile_cache
            res, ms, _st, _dec, delta = _prom_sql_run(db, panels[name][1], is_cuda)
            route = eng.last_path
            # the full planes serve only the gauge with no overlap, with the cache on
            want_route = "tile" if tile_cache and name == "P5" and not p5_dedup else "table"
            declined = want_route == "table" and tile_cache
            if route != want_route or declined != bool(delta.get("tile_declined")):
                raise AssertionError(f"{name} with both passes off (tile cache {tile_cache}) "
                                     f"took the {route!r} route")
            tile_key = "P1'" if name == "P1" else "P5"
            compare_tables(out["queries"][tile_key]["result"], res, f"{name} {route}", tol=1e-7,
                           inexact=("av",))
            compare[f"{name} {route}"] = ms
    finally:
        db.config.query.disabled_passes = saved
        db.config.query.tile_cache_enable = True
    emit({"phase": "prom_sql_compare", "ms": compare})
    # write the corrected rows back as they were
    restore, _t, _h = _overwrite_rows(samples, tsbs, -OVERWRITE_DELTA)
    db.write(PROM_COUNTER, restore)
    db.flush()
    samples[PROM_COUNTER][np.ix_(ticks, hs)] -= OVERWRITE_DELTA
    for q in out["queries"].values():
        q.pop("result")
    out.update(compare_ms=compare, seconds=time.perf_counter() - t_start,
               cache=eng.tile_cache.stats())
    return out


def prom_planes(n_hosts: int, hours: int, dev, seed: int = SEED):
    """Super-tile planes of the counter table as the tile path reads them:
    hostname codes, ts, counter values with resets (one host in 16), NaN
    values and NULLs, invalid rows (dedup losers), padded to a multiple of
    4096 rows and cut into 2^24-row chunks."""
    import torch

    from greptimedb_tpu_torch.ops.tiles import pad_rows

    ticks = hours * 3600 // SCRAPE_S
    n = n_hosts * ticks
    npad = pad_rows(n)
    g = torch.Generator(device=dev).manual_seed(seed)
    codes = torch.arange(n_hosts, dtype=torch.int32, device=dev).repeat_interleave(ticks)
    ts = T0 + torch.arange(ticks, dtype=torch.int64, device=dev).repeat(n_hosts) * (SCRAPE_S * 1000)
    incr = torch.rand((n_hosts, ticks), generator=g, dtype=torch.float64, device=dev) * 2e5
    vals = torch.cumsum(incr, dim=1)
    at = ticks // 3
    vals[5::16, at:] -= vals[5::16, at:at + 1] - 100.0
    vals = vals.reshape(-1)
    vals[torch.rand(n, generator=g, device=dev) < 1e-3] = float("nan")
    present = torch.rand(n, generator=g, device=dev) >= 5e-3
    valid = torch.rand(n, generator=g, device=dev) >= 2e-2
    chunk = 1 << 24

    def chunks(x, fill):
        x = _padded(x, npad, fill)
        return [x[o:o + chunk].contiguous() for o in range(0, npad, chunk)]

    return n, npad, chunks(codes, 0), chunks(ts, 0), chunks(vals, 0.0), chunks(present, False), \
        chunks(valid, False)


def run_tql_kernel_phase(n_hosts: int, hours: int, reps: int) -> dict:
    """Phase 3c: K9-K12 against their plain versions on the card at the TQL
    main path's shapes — 17.28 M rows in two chunks, S_pad 4096, W_pad 1024,
    721 real steps, k = 8 (5m) and 64 (1h) — with NaN values, NULLs and
    invalid rows; each twice with identical bytes, timed (CUDA events)."""
    import torch

    from greptimedb_tpu_torch.ops import rate as R

    dev = torch.device("cuda", 0)
    n, npad, codes, ts, vals, present, valid = prom_planes(n_hosts, hours, dev)
    s_pad = 1 << (max(n_hosts, 1) - 1).bit_length()
    steps = hours * 60 + 1
    w_pad = 1 << (steps - 1).bit_length()
    start, end = T0, T0 + hours * H3600

    def source(range_ms):
        return R.RowSource(ts=ts, values=vals, num_series=s_pad, codes=(codes,),
                           radices=(s_pad,), nulls=present, valid=valid,
                           lo=start - range_ms, hi=end + 1)

    def grid(range_ms, k):
        return R.RangeGrid(start, 60_000, range_ms, w_pad, k, s_pad, steps)

    out: dict[str, dict] = {}
    src5 = source(300_000)
    sid, ts_ms, vf, inf = R.source_rows(src5)

    # K9
    def k9():
        return R.strip_counter_resets(src5)

    adj, layout = _twice_identical_masked(k9, inf, "strip_counter_resets")
    adj_p = R.strip_counter_resets_plain(sid, vf, inf)
    e9 = _compare(adj[inf], adj_p[inf], True, "strip_counter_resets")
    # valid, ts, code, value and present read once per row; adjusted value written
    b9, b9by = bound(npad * (1 + 8 + 4 + 8 + 1) + npad * 8, npad * 4)
    out[_STRIP] = dict(max_abs_err=e9, ms=_timed(k9, reps),
                       plain_ms=_timed(lambda: R.strip_counter_resets_plain(sid, vf, inf), 1),
                       bound_ms=b9, bound_by=b9by, library_ms=None,
                       # one copy: the chunk-pointer table
                       **_call_ops(k9, R.strip_counter_resets, K9_KERNELS, "strip_counter_resets",
                                   copies=1))

    # K10 at k = 8 (5m, rate's counter values) and k = 64 (1h)
    k10 = {}
    stats5 = None
    for range_ms, k, values in ((300_000, 8, adj), (3_600_000, 64, None)):
        src, gr = source(range_ms), grid(range_ms, k)
        sid_r, ts_r, vf_r, inf_r = R.source_rows(src)

        def run():
            return R.range_windows(src, gr, values=values)

        st, pres = _twice_identical_stats(run, f"range_windows k={k}")
        st_p = R.range_windows_plain(sid_r, ts_r, vf_r if values is None else adj_p, inf_r,
                                     gr.start, gr.step, gr.range_, gr.n_steps, gr.k,
                                     gr.num_series, gr.n_steps_actual)
        err = 0.0
        for f in R.WindowStats.FIELDS:
            err = max(err, _compare(getattr(st, f), getattr(st_p, f), True, f"range_windows.{f}"))
        if not torch.equal(pres, R.series_presence_plain(sid_r, inf_r, s_pad)):
            raise AssertionError("range_windows presence differs")
        cells = s_pad * w_pad
        visits = int(st.count.sum())
        # per row: valid, ts, code, value, present read once; per cell 60 B
        # of statistics written; ~8 operations per (sample, window) visit
        kb, kby = bound(npad * 22 + cells * 60, visits * 8 + npad * 10)
        k10[k] = dict(
            max_abs_err=err, visits=visits,
            ms=_timed(run, reps),
            plain_ms=_timed(lambda: R.range_windows_plain(
                sid_r, ts_r, vf_r, inf_r, gr.start, gr.step, gr.range_, gr.n_steps, gr.k,
                gr.num_series, gr.n_steps_actual), 1),
            bound_ms=kb, bound_by=kby, library_ms=None,
        )
        if k == 8:
            stats5 = st
    out[_WIN] = dict(k10[8], k64=k10[64])

    # K11 over the 5m stats: every function equal to the plain version byte
    # for byte; rate timed
    g5 = grid(300_000, 8)
    for func in R.FUNC_CODES:
        a = R.range_finalize([stats5], g5, func)
        b = R.range_finalize_plain([stats5], g5, func)
        _same_f64(a, b, f"range_finalize {func}")
    _twice_identical(lambda: R.range_finalize([stats5], g5, "rate"), "range_finalize")
    cells = s_pad * w_pad
    # rate reads count, first/last ts and first/last value (36 B) and writes
    # 8 B per cell; ~20 f64 operations per cell
    b11, b11by = bound(cells * (36 + 8), cells * 20)
    # the median of five readings: one reading's mean moves between runs
    out[_FIN] = dict(max_abs_err=0.0,
                     **_timed_runs(lambda: R.range_finalize([stats5], g5, "rate"), reps),
                     plain_ms=_timed(lambda: R.range_finalize_plain([stats5], g5, "rate"), 1),
                     bound_ms=b11, bound_by=b11by, library_ms=None)

    # K12: sum (T2's G = 1) and max by nothing, and sum by hostname (G = S),
    # in the form its plan picks and in both forms (the same bytes)
    mat = R.range_finalize([stats5], g5, "rate").view(s_pad, w_pad)
    folds = {}
    for keep in ((), (0,)):
        offsets, members = (torch.from_numpy(x).to(dev) for x in R.group_csr((s_pad,), keep))
        G = int(offsets.shape[0]) - 1
        forms = k12_forms(offsets, members, mat)
        for op in ("sum", "max", "avg", "count"):
            want = R.series_fold_plain(mat, offsets, members, op)
            for form, fn in forms.items():
                a = _twice_identical(lambda: fn(op), f"fold {op} {form}")
                _same_f64(a, want, f"series_fold {op} ({form} form)")
        gid = torch.from_numpy(R.gid_map((s_pad,), keep)).to(dev)
        zeroed = torch.nan_to_num(mat, nan=0.0)
        lib = _timed(lambda: torch.zeros((G, w_pad), dtype=torch.float64, device=dev)
                     .index_add_(0, gid, zeroed), reps)
        # the [S, W] matrix read once, [G, W] written, the CSR read
        b12, b12by = bound(cells * 8 + G * w_pad * 8 + (G + 1 + s_pad) * 8, cells * 2)
        ms = _timed(lambda: R.series_fold(mat, offsets, members, "sum"), reps)
        launched = k12_last_launch()  # the form, tw and CTAs of the timed calls
        folds[G] = dict(max_abs_err=0.0, ms=ms,
                        plain_ms=_timed(lambda: R.series_fold_plain(mat, offsets, members, "sum"),
                                        1),
                        bound_ms=b12, bound_by=b12by, library_ms=lib, **launched,
                        **{f"{f}_ms": _timed(lambda: forms[f]("sum"), reps)
                           for f in ("cells", "staged")})
    out[_FOLD] = dict(folds[1], by_series=folds[s_pad],
                      order_sensitive=run_fold_order_case(dev, s_pad, w_pad))
    del codes, ts, vals, present, valid, sid, ts_ms, vf, inf, adj, adj_p, stats5, mat
    torch.cuda.empty_cache()
    run_tql_edge_cases(dev)
    return out


def k12_forms(offsets, members, mat) -> dict:
    """K12 over one CSR in the form its plan picks and in each form forced
    (the cell form, the staged form at the tile the plan would give it):
    {form: op -> result}."""
    from greptimedb_tpu_torch.ops import rate as R

    G, W = int(offsets.shape[0]) - 1, int(mat.shape[1])
    return {"planned": lambda op: R.series_fold(mat, offsets, members, op),
            "cells": lambda op: R._series_fold_launch(mat, offsets, members, op, 0),
            "staged": lambda op: R._series_fold_launch(mat, offsets, members, op,
                                                       R._staged_tile(G, W))}


def run_fold_order_case(dev, s_pad: int, w_pad: int) -> dict:
    """K12 on an order-sensitive matrix: values of mixed magnitude (1e-8 to
    1e8, both signs) with NaN holes over [s_pad, w_pad], where a pairwise
    sum of a column gives other bytes than the left fold: every form at G =
    1, 2, 16 and 64 (the staged form at tw 8, 16 and 32, and the cell
    form as planned) byte for byte against the plain version.  Returns
    the form, tw and CTAs of the planned launch at each G, read from its
    arguments, and the columns whose pairwise sum differed."""
    import torch

    from greptimedb_tpu_torch.ops import rate as R

    rng = np.random.default_rng(SEED + 13)
    vals = rng.standard_normal((s_pad, w_pad)) * 10.0 ** rng.integers(-8, 9, (s_pad, w_pad))
    vals[rng.random((s_pad, w_pad)) < 0.2] = np.nan
    mat = torch.from_numpy(vals).to(dev)
    zeroed = torch.nan_to_num(mat, nan=0.0)
    left = torch.zeros(w_pad, dtype=torch.float64, device=dev)
    for r in range(s_pad):
        left = left + zeroed[r]
    tree = zeroed
    while tree.shape[0] > 1:
        half = tree.shape[0] // 2
        tree = tree[:half] + tree[half: 2 * half]
    differ = int((left.view(torch.int64) != tree[0].view(torch.int64)).sum())
    if differ == 0:
        raise AssertionError("K12 order case: a pairwise sum gives the left fold's bytes")
    out = {"columns_order_sensitive": differ}
    for radices, keep in (((s_pad,), ()), ((2, s_pad // 2), (0,)), ((16, s_pad // 16), (0,)),
                          ((64, s_pad // 64), (0,))):
        off, mem = (torch.from_numpy(x).to(dev) for x in R.group_csr(radices, keep))
        G = int(off.shape[0]) - 1
        forms = k12_forms(off, mem, mat)
        for op in ("sum", "avg", "count", "max"):
            want = R.series_fold_plain(mat, off, mem, op)
            if G == 1 and op == "sum":
                _same_f64(want[0], torch.where(torch.isnan(want[0]), want[0], left),
                          "K12 order case: the plain version is not the left fold")
            for form, fn in forms.items():
                _same_f64(fn(op), want, f"K12 order case G = {G} {op} ({form} form)")
        forms["planned"]("sum")
        out[f"launch_g{G}"] = k12_last_launch()
    emit({"phase": "kernels", "step": "k12_order", **out})
    return out


def _same_f64(a, b, what: str) -> None:
    """Byte for byte, except that any NaN equals any NaN (the payload of a
    NaN that arithmetic produces is the card's, not the function's)."""
    import torch

    nan = torch.isnan(a)
    if a.shape != b.shape or not torch.equal(nan, torch.isnan(b)) \
            or not torch.equal(a[~nan].view(torch.int64), b[~nan].view(torch.int64)):
        raise AssertionError(f"{what}: differs from the plain version")


def _twice_identical_masked(fn, mask, what: str):
    """K9 twice: the bytes of every fetched row identical (rows that are not
    fetched carry no value)."""
    import torch

    a, layout = fn()
    b, _l = fn()
    torch.cuda.synchronize()
    if not _same_bytes(a[mask], b[mask]):
        raise AssertionError(f"{what}: two runs differ in their bytes")
    return a, layout


def _twice_identical_stats(fn, what: str):
    import torch

    a, pa_ = fn()
    b, pb = fn()
    torch.cuda.synchronize()
    for x, y in zip(a.tensors() + (pa_,), b.tensors() + (pb,)):
        if not _same_bytes(x, y):
            raise AssertionError(f"{what}: two runs differ in their bytes")
    return a, pa_


def run_tql_edge_cases(dev) -> None:
    """K9-K12 on small inputs that make them hard, against their plain
    versions: equal timestamps in a window, NaN/+-inf values, a series
    that is all NULL, matcher masks, two tags, chunks that are not a power
    of two, ns and us time units with an offset, several regions merged;
    K10's slices at k = 64 with the range a multiple of the step, at a 1 s
    step (empty slices), at a 1 h step over 10 s scrapes (360-row slices,
    cut at a 1.5 h range) and with a series whose every sample precedes
    the first step (the clamp slice), twice each."""
    import torch

    from greptimedb_tpu_torch.ops import rate as R

    rng = np.random.default_rng(SEED)
    ca, cb = 5, 7
    rows = []
    for a in range(ca):
        for b in range(cb):
            m = int(rng.integers(0, 90))
            t = np.sort(rng.integers(0, 1200, m)) * 1000 + 5_000_000
            v = np.cumsum(rng.uniform(0, 3, m))
            if m > 10:
                v[m // 2:] -= v[m // 2] - 0.25
                v[rng.integers(0, m)] = np.nan
                v[rng.integers(0, m)] = np.inf
            rows.append((np.full(m, a), np.full(m, b), t, v))
    a_codes = np.concatenate([r[0] for r in rows]).astype(np.int32)
    b_codes = np.concatenate([r[1] for r in rows]).astype(np.int32)
    t_ms = np.concatenate([r[2] for r in rows]).astype(np.int64)
    v = np.concatenate([r[3] for r in rows])
    n = t_ms.shape[0]
    valid = rng.random(n) < 0.9
    present = rng.random(n) < 0.95
    present[(a_codes == 2) & (b_codes == 3)] = False  # an all-NULL series
    radices = (8, 8)
    s_pad = 64
    for unit_ns, chunk, regions in ((1_000_000, 3000, 1), (1_000, 4096, 2), (1, 1 << 20, 3)):
        ts_nat = t_ms * 1_000_000 // unit_ns

        def chunks(x, dt):
            t = torch.from_numpy(np.ascontiguousarray(x, dtype=dt)).to(dev)
            return [t[o:o + chunk].contiguous() for o in range(0, n, chunk)]

        start, step, rng_ms, offset = 5_300_000, 25_000, 120_000, 30_000
        steps = (6_200_000 - start) // step + 1
        w_pad = 1 << (steps - 1).bit_length()
        mask_b = torch.from_numpy(np.array([1, 1, 0, 1, 1, 1, 0, 1], bool)).to(dev)
        srcs = []
        for r in range(regions):
            vr = valid & ((a_codes % regions) == r)
            srcs.append(R.RowSource(
                ts=chunks(ts_nat, np.int64), values=chunks(v, np.float64), num_series=s_pad,
                codes=(chunks(a_codes, np.int32), chunks(b_codes, np.int32)), radices=radices,
                masks=((1, mask_b),), nulls=chunks(present, bool), valid=chunks(vr, bool),
                lo=(start - rng_ms - offset) * 1_000_000 // unit_ns,
                hi=(6_200_000 - offset) * 1_000_000 // unit_ns + 1,
                unit_ns=unit_ns, offset=offset))
        for k in (8, 16):
            gr = R.RangeGrid(start, step, rng_ms, w_pad, k, s_pad, steps)
            for func in ("rate", "delta", "sum_over_time", "last_over_time", "__last_ts"):
                stats_k, stats_p = [], []
                for src in srcs:
                    sid, ts_ms, vf, inf = R.source_rows(src)
                    adj_k = layout = None
                    vals_p = vf
                    if func == "rate":
                        adj_k, layout = R.strip_counter_resets(src)
                        vals_p = R.strip_counter_resets_plain(sid, vf, inf)
                        _compare(adj_k[inf], vals_p[inf], True, "edge strip")
                    st, pres = R.range_windows(src, gr, values=adj_k, layout=layout)
                    sp = R.range_windows_plain(sid, ts_ms, vals_p, inf, gr.start, gr.step,
                                               gr.range_, gr.n_steps, gr.k, gr.num_series,
                                               gr.n_steps_actual)
                    for f in R.WindowStats.FIELDS:
                        _compare(getattr(st, f), getattr(sp, f), True, f"edge range_windows.{f}")
                    if not torch.equal(pres, R.series_presence_plain(sid, inf, s_pad)):
                        raise AssertionError("edge presence differs")
                    stats_k.append(st)
                    stats_p.append(sp)
                fk = R.range_finalize(stats_k, gr, func)
                _same_f64(fk, R.range_finalize_plain(stats_p, gr, func), f"edge {func}")
                mat = fk.view(s_pad, w_pad)
                for keep in ((), (0,), (1, 0)):
                    off, mem = (torch.from_numpy(x).to(dev) for x in R.group_csr(radices, keep))
                    for op in ("sum", "min", "count"):
                        _same_f64(R.series_fold(mat, off, mem, op),
                                  R.series_fold_plain(mat, off, mem, op), f"edge fold {op}")
        if unit_ns == 1_000_000:
            # K10's slices over the same rows: k = 64 with the range a
            # multiple of the step, a 1 s step (most slices empty)
            src = srcs[0]
            for step_e, rng_e in ((10_000, 640_000), (1_000, 30_000)):
                n_e = (6_200_000 - start) // step_e + 1
                k_e = 1 << (-(-rng_e // step_e) - 1).bit_length()
                _k10_edge(R, src, R.RangeGrid(start, step_e, rng_e, 1 << (n_e - 1).bit_length(),
                                              k_e, s_pad, n_e), f"step {step_e} range {rng_e}")
    # a 1 h step over 10 s scrapes (slices of 360 rows, the oldest cut at
    # 1.5 h), one series whose every sample precedes the first step
    hours, s_hour = 6, 16
    ticks = hours * 3600 // SCRAPE_S
    t0 = 7_200_000_000
    sid = np.repeat(np.arange(s_hour, dtype=np.int32), ticks)
    t_ms = np.tile(t0 + np.arange(ticks, dtype=np.int64) * SCRAPE_S * 1000, s_hour)
    t_ms[sid == 3] -= hours * H3600  # series 3: every sample before `start`
    v = rng.normal(0, 1, sid.shape[0]).cumsum()
    order = np.lexsort((t_ms, sid))

    def one(x, dt):
        return [torch.from_numpy(np.ascontiguousarray(x[order], dtype=dt)).to(dev)]

    src = R.RowSource(ts=one(t_ms, np.int64), values=one(v, np.float64), num_series=s_hour,
                      codes=(one(sid, np.int32),), radices=(s_hour,))
    start = t0 + H3600 // 2
    for rng_e, k_e in ((5_400_000, 2), (3_600_000, 64)):
        n_e = (t0 + hours * H3600 - start) // H3600 + 1
        _k10_edge(R, src, R.RangeGrid(start, H3600, rng_e, 8, k_e, s_hour, n_e),
                  f"1 h step range {rng_e} k {k_e}")
    t9 = time.perf_counter()
    run_strip_edge_series(dev)
    CHECK_S["k9_edge_series_s"] += time.perf_counter() - t9
    emit({"phase": "tql_edge_cases", "ok": True, "k9_edge_series_s": time.perf_counter() - t9})


def strip_edge_rows(seed: int = SEED):
    """(sid, values, valid, present) of series where K9's reset ballot
    branches, sorted by series, rows relative to each series' first
    fetched row (lane = row % 32 in a group, row % 256 in a window of
    loads): no reset, one row, one reset, many, a reset on every row,
    resets at lanes 0 and 31 of many groups, resets just after unfetched
    rows that span a group's and a window's boundary, NaN and +-inf either
    side of a reset, a series with no fetched row; series 11 holds none."""
    rng = np.random.default_rng(seed)
    ramp = lambda m: np.cumsum(rng.uniform(0.5, 3.0, m))  # noqa: E731
    series = []
    series.append((ramp(600), None))                        # 0: no reset
    series.append((np.array([42.0]), None))                 # 1: one row
    v = ramp(500)
    v[300:] -= v[300] - 0.25
    series.append((v, None))                                # 2: one reset
    v = ramp(900)
    for at in np.sort(rng.choice(np.arange(1, 900), 90, replace=False)):
        v[at:] -= v[at] - rng.uniform(0, 1)
    series.append((v, rng.random(900) < 0.95))              # 3: many, 5 % unfetched
    series.append((1000.0 - np.arange(300.0), None))        # 4: a reset on every row
    v = ramp(700)
    for g in range(1, 21):
        for at in (32 * g, 32 * g + 31):
            v[at:] -= v[at] - 0.5 * v[at - 1]
    series.append((v, None))                                # 5: lanes 0 and 31
    v = ramp(600)
    valid = np.ones(600, bool)
    valid[20:41] = False                                    # across lanes 31 / 0
    v[41:] -= v[41] - 0.5
    valid[250:263] = False                                  # across the window's edge
    v[263:] -= v[263] - 0.5
    series.append((v, valid))                               # 6: after unfetched rows
    v = ramp(200)
    v[50], v[51] = np.nan, 1.0                              # NaN, then below it
    v[80] = 0.5                                             # a reset, then NaN
    v[81] = np.nan
    v[82] = 0.25                                            # after NaN: no reset
    v[120] = np.inf
    v[121] = 2.0                                            # below +inf: adds inf
    series.append((v, None))                                # 7: NaN, +inf
    v = ramp(150)
    v[40] = -np.inf                                         # a reset to -inf
    v[41] = -np.inf                                         # -inf after -inf
    v[42] = 1.0
    v[90], v[91] = 7.0, np.inf
    v[92] = np.inf                                          # inf after inf
    series.append((v, None))                                # 8: -inf, +inf
    series.append((ramp(40), np.zeros(40, bool)))           # 9: nothing fetched
    v = ramp(300)
    v[::7] = 0.0                                            # 10: -0.0 and 0.0 resets
    v[::14] = -0.0
    series.append((v, None))
    sid = np.concatenate([np.full(len(v), i, np.int32) for i, (v, _) in enumerate(series)])
    vals = np.concatenate([v for v, _ in series])
    valid = np.concatenate([np.ones(len(v), bool) if m is None else m for v, m in series])
    present = rng.random(sid.size) >= 0.02
    present[(sid == 4) | (sid == 5)] = True
    return sid, vals, valid, present


def run_strip_edge_series(dev) -> None:
    """K9 over strip_edge_rows' series against its plain version, byte for
    byte on every fetched row and twice, at chunk lengths that put a
    window of loads across a chunk boundary (1000 and 96 rows: a division;
    512: a shift) and in one chunk."""
    import torch

    from greptimedb_tpu_torch.ops import rate as R

    sid, vals, valid, present = strip_edge_rows()
    n = sid.size
    ts = T0 + np.arange(n, dtype=np.int64) * 10_000
    for chunk in (1000, 96, 512, n):
        def chunks(x):
            t = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            return [t[o:o + chunk].contiguous() for o in range(0, n, chunk)]

        src = R.RowSource(ts=chunks(ts), values=chunks(vals), num_series=16,
                          codes=(chunks(sid),), radices=(16,), nulls=chunks(present),
                          valid=chunks(valid))
        p_sid, _ts, vf, inf = R.source_rows(src)
        adj, _layout = _twice_identical_masked(lambda: R.strip_counter_resets(src), inf,
                                               f"edge K9 series, chunk {chunk}")
        _same_f64(adj[inf], R.strip_counter_resets_plain(p_sid, vf, inf)[inf],
                  f"edge K9 series, chunk {chunk}")


def _k10_edge(R, src, grid, what: str) -> None:
    """K10 twice (the same bytes) against its plain version on one grid."""
    import torch

    sid, ts_ms, vf, inf = R.source_rows(src)
    st, pres = _twice_identical_stats(lambda: R.range_windows(src, grid), f"edge K10 {what}")
    sp = R.range_windows_plain(sid, ts_ms, vf, inf, grid.start, grid.step, grid.range_,
                               grid.n_steps, grid.k, grid.num_series, grid.n_steps_actual)
    for f in R.WindowStats.FIELDS:
        _compare(getattr(st, f), getattr(sp, f), True, f"edge K10 {what}: {f}")
    if not torch.equal(pres, R.series_presence_plain(sid, inf, grid.num_series)):
        raise AssertionError(f"edge K10 {what}: presence differs")
    if int(st.count.sum()) == 0:
        raise AssertionError(f"edge K10 {what}: no sample in any window")


# ---- phase 7: the hash group-by on a high-cardinality container table ------------------

# the kernels a hash plan launches, and those it must not (the dense blocked
# path and the limb planes)
HASH_PATH = ("mask_gids", "hash_group_slots", _SCATTER, _PACK)
NOT_HASH_PATH = (_BLOCKED, _QUANT, _LIMB)


def container_queries(hours: int) -> list[tuple[str, str, str]]:
    """(name, expected strategy under auto, sql) of the container panel."""
    lo, hi = T0, T0 + hours * H3600
    t = CM_TABLE
    h1 = (f"SELECT namespace, pod, container, time_bucket('5m', ts) AS tb, "
          f"avg(greptime_value) AS a, max(greptime_value) AS m FROM {t} "
          f"WHERE ts >= {lo} AND ts < {hi} GROUP BY namespace, pod, container, tb")
    h2 = h1.replace(f"ts >= {lo} AND", f"ts >= {hi - H3600} AND namespace = 'ns-007' AND")
    h3 = (f"SELECT namespace, pod, count(*) AS n, max(greptime_value) AS m FROM {t} "
          f"WHERE ts >= {lo} AND ts < {hi} GROUP BY namespace, pod")
    h4 = (f"SELECT namespace, pod, container, time_bucket('5m', ts) AS tb, "
          f"max(greptime_value) AS m FROM {t} WHERE ts >= {lo} AND ts < {hi} "
          f"GROUP BY namespace, pod, container, tb ORDER BY m DESC LIMIT 10")
    return [("H1", "hash", h1), ("H2", "hash", h2), ("H3", "sort", h3), ("H4", "hash", h4)]


def container_overflow_query() -> str:
    return (f"SELECT pod, container, count(*) AS n, max(greptime_value) AS m FROM {CM_TABLE} "
            f"GROUP BY pod, container")


def ingest_containers(db, hours: int) -> int:
    """The container table through Database.write (WAL on), then a flush:
    8000 series, a sample every 30 s, whole-byte values of a seeded random
    walk that stays inside 1e7..2e9 bytes."""
    import pyarrow as pa

    db.sql(f"CREATE TABLE {CM_TABLE} (namespace STRING, pod STRING, container STRING, "
           f"ts TIMESTAMP(3) TIME INDEX, greptime_value DOUBLE, "
           f"PRIMARY KEY (namespace, pod, container)) WITH (append_mode = 'true')")
    ns, pod, cont = container_series()
    names = (np.array([f"ns-{i:03d}" for i in ns]), np.array([f"pod-{i:04d}" for i in pod]),
             np.array([f"c-{i:02d}" for i in cont]))
    rng = np.random.default_rng(SEED)
    level = rng.uniform(2e8, 1.5e9, ns.size)
    ticks_total = hours * 3600 // CM_SCRAPE_S
    chunk = max(1, 2_000_000 // ns.size)
    n_rows = 0
    for start in range(0, ticks_total, chunk):
        ticks = min(chunk, ticks_total - start)
        steps = rng.normal(0.0, 1e6, (ticks, ns.size))
        walk = level[None, :] + np.cumsum(steps, axis=0)
        level = walk[-1]
        ts = T0 + (start + np.arange(ticks, dtype=np.int64))[:, None] * (CM_SCRAPE_S * 1000)
        db.write(CM_TABLE, pa.table({
            **{k: pa.array(np.broadcast_to(v[None, :], (ticks, ns.size)).reshape(-1))
               for k, v in zip(("namespace", "pod", "container"), names)},
            "ts": pa.array(np.broadcast_to(ts, (ticks, ns.size)).reshape(-1), pa.timestamp("ms")),
            "greptime_value": pa.array(np.clip(np.round(walk), 1e7, 2e9).reshape(-1)),
        }))
        n_rows += ticks * ns.size
    db.flush()
    return n_rows


def _ipc_bytes(table) -> bytes:
    import io

    import pyarrow as pa

    sink = io.BytesIO()
    with pa.ipc.new_stream(sink, table.schema) as w:
        w.write_table(table)
    return sink.getvalue()


def run_container_slice(device: str, hours: int, reps: int, data_home: str) -> dict:
    """Phase 7: the container table, then H1-H4 on the tile path (cold and
    `reps` warm), each against the CPU backend: keys, counts and max
    exact, avg within rel 1e-7 (f32 avg rows for G >= 2^14, as the
    reference ships them).  The auto verdict of each query is asserted
    from `stats`, and the launches of the hash queries (K1, K17, K3, K8;
    no K2, K5 or K6).  H3 forced to hash equals H3 under sort byte for
    byte.  Then the overflow query: forced hash into 4096 slots for 8000
    keys overflows, the dense rerun is past max_internal_groups too, so
    the table-fed path answers, against the CPU backend."""
    from greptimedb_tpu_torch import Database
    from greptimedb_tpu_torch.ops.aggregate import last_hash_rounds

    is_cuda = device.startswith("cuda")
    if is_cuda:
        import torch
    db = Database(data_home, device=device, config=device_route_config())
    eng = db.query_engine
    t0 = time.perf_counter()
    n_rows = ingest_containers(db, hours)
    ingest_s = time.perf_counter() - t0
    emit({"phase": "container_ingest", "rows": n_rows, "series": n_rows * CM_SCRAPE_S // (hours * 3600),
          "seconds": ingest_s, "rows_per_s": n_rows / ingest_s})

    def run(sql):
        t1 = time.perf_counter()
        out = db.sql_one(sql)
        if is_cuda:
            torch.cuda.synchronize()
        return out, (time.perf_counter() - t1) * 1e3

    def cpu(sql):
        db.config.query.backend = "cpu"
        try:
            return run(sql)
        finally:
            db.config.query.backend = "torch"

    per_query = {}
    results = {}
    reset_counts()  # the main path's run starts here
    for name, strategy, sql in container_queries(hours):
        before = launch_counts()
        s0 = dict(eng.stats)
        times, stages, readback = [], [], []
        result = None
        for _ in range(1 + reps):
            result, ms = run(sql)
            times.append(ms)
            if eng.last_path != "tile":
                raise AssertionError(f"{name}: answered by the {eng.last_path!r} path")
            stages.append(dict(eng.last_timings))
            readback.append(eng.tile_executor().last_readback_bytes)
        delta = {k: v - before[k] for k, v in launch_counts().items()}
        got = {k: eng.stats[k] - s0[k] for k in ("agg_hash", "agg_sort", "tile_dispatches")}
        if got["agg_" + strategy] != 1 + reps or got["tile_dispatches"] != 1 + reps:
            raise AssertionError(f"{name}: expected {strategy} on the tile path, stats moved {got}")
        if is_cuda:
            ran = {k for k, d in delta.items() if d > 0}
            if strategy == "hash" and (not set(HASH_PATH) <= ran or ran & set(NOT_HASH_PATH)):
                raise AssertionError(f"{name}: launched {sorted(ran)}; a hash plan needs "
                                     f"{HASH_PATH} and none of {NOT_HASH_PATH}")
        cpu_t, cpu_ms = cpu(sql)
        rel = compare_tables(result, cpu_t, f"{name} {sql}", tol=1e-7, inexact=("a",),
                             keys=CM_KEYS)
        results[name] = result
        warm = stages[1:] if reps else stages
        keys = sorted({k for st in warm for k in st})
        per_query[name] = {
            "strategy": strategy, "rows_out": result.num_rows, "cold_ms": times[0],
            "cold_stage_ms": stages[0],
            "warm_p50_ms": float(np.median(times[1:] if reps else times)),
            "warm_stage_p50_ms": {k: float(np.median([st.get(k, 0.0) for st in warm])) for k in keys},
            "readback_bytes": readback[-1], "cpu_backend_ms": cpu_ms, "max_rel_err": rel,
            "k17_rounds": last_hash_rounds(),
            "launches": {k: v for k, v in delta.items() if v},
        }
        emit({"phase": "container_query", "name": name, **per_query[name]})
    totals, shapes = launch_counts(), shape_counts()  # the main path's launches end here
    k17_calls = call_counts("hash_group_slots")
    tick = run_container_tick(db, hours, results, is_cuda)

    # H3 forced to hash: the same bytes as its sort plan (count and max are exact)
    h3 = dict((n, s) for n, _st, s in container_queries(hours))["H3"]
    db.config.query.agg_strategy = "hash"
    try:
        h0 = eng.stats["agg_hash"]
        forced, forced_ms = run(h3)
        if eng.stats["agg_hash"] != h0 + 1 or eng.last_path != "tile":
            raise AssertionError("H3 forced to hash did not run a hash plan on the tile path")
    finally:
        db.config.query.agg_strategy = "auto"
    if _ipc_bytes(forced) != _ipc_bytes(results["H3"]):
        raise AssertionError("H3: the hash plan's result differs from the sort plan's bytes")
    emit({"phase": "container_query", "name": "H3 forced hash", "ms": forced_ms,
          "stage_ms": dict(eng.last_timings), "same_bytes_as_sort": True})

    # the overflow ladder: hash into 4096 slots, no dense rerun, the table path
    q = container_overflow_query()
    saved = (db.config.query.agg_strategy, db.config.query.max_internal_groups)
    db.config.query.agg_strategy, db.config.query.max_internal_groups = "hash", 4096
    try:
        s0 = dict(eng.stats)
        over, over_ms = run(q)
    finally:
        db.config.query.agg_strategy, db.config.query.max_internal_groups = saved
    moved = {k: eng.stats[k] - s0[k] for k in ("agg_hash", "agg_hash_overflow", "tile_declined")}
    if moved != {"agg_hash": 1, "agg_hash_overflow": 1, "tile_declined": 1} or eng.last_path != "table":
        raise AssertionError(f"overflow query: stats moved {moved}, path {eng.last_path}")
    cpu_t, _ms = cpu(q)
    compare_tables(over, cpu_t, "overflow " + q, tol=0.0, keys=CM_KEYS)
    emit({"phase": "container_overflow", "ms": over_ms, "rows_out": over.num_rows, **moved})
    db.close()
    return {"rows": n_rows, "ingest_s": ingest_s, "queries": per_query, "launches": totals,
            "shape_launches": shapes, "k17_calls": k17_calls, "overflow_ms": over_ms, "tick": tick}


def run_container_tick(db, hours: int, solo_tables: dict, is_cuda: bool, n_ticks: int = 2) -> dict:
    """Phase 7c: H1-H4 as one tick (H3 sort, H1, H2 and H4 hash; K17's
    probe rounds on the card inside the graph), each result byte-identical
    to its solo run of phase 7.  Launch counts: 0 before, read after."""
    from greptimedb_tpu_torch.ops.aggregate import last_hash_rounds

    eng = db.query_engine
    bc = db.config.batch
    named = [(name, sql) for name, _st, sql in container_queries(hours)]
    refs = {sql: _ipc_bytes(solo_tables[name]) for name, sql in named}
    bc.window_ms, bc.max_members, bc.fuse_programs = TICK_WINDOW_MS, 16, True
    try:
        reset_counts()  # the hash tick's main path starts here
        ticks = _tick_series(db, named, refs, n_ticks, "containers")
        launches = launch_counts()  # ... and ends here
    finally:
        bc.window_ms = 0.0
    moved = {k: sum(t[k] for t in ticks) for k in ("agg_hash", "agg_sort", "new_programs")}
    if moved["agg_hash"] != 3 * n_ticks or moved["agg_sort"] != n_ticks:
        raise AssertionError(f"container tick strategies: {moved}")
    program = eng.tile_executor().last_tick
    _sync_free(program, is_cuda)
    out = {"ticks": ticks, "launches": launches, "capture_ms": program.capture_ms,
           "pool_bytes": program.pool_bytes, "readback_bytes": program.readback_bytes,
           "k17_rounds": last_hash_rounds(), "programs_built": moved["new_programs"]}
    if is_cuda and launches["hash_group_slots"] == 0:
        raise AssertionError("the hash tick's capture launched no K17")
    emit({"phase": "container_tick", **{k: v for k, v in out.items() if k != "ticks"}})
    return out


# ---- phase 8: vector search (K19) on a SIFT1M-shaped table -------------------------------

# ANN-Benchmarks' sift-128-euclidean: 1,000,000 base vectors of 128 f32
# dimensions, recall at k = 10 and 100.  The data is made from the seed:
# integers in [0, 255] as f32 (SIFT's value range, not its distribution);
# one row in 1,000 copies an earlier row, so exact ties exist.
SIFT_ROWS, SIFT_DIM = 1_000_000, 128
SIFT_TABLE = "sift"
VECTOR_KS = (10, 100, 1000)
VEC_METRICS = {"l2sq": "vec_l2sq_distance", "cos": "vec_cos_distance", "dot": "vec_dot_product"}
U32 = 2.0 ** -24  # f32 unit roundoff


def sift_data(rows: int, dim: int, seed: int = SEED):
    """(base f32 [rows, dim], queries f32 [4, dim]): integer values in
    [0, 255]; rows 999, 1999, ... copy an earlier row; query 0 equals a
    stored row that has such a copy, so its nearest distance 0 is a tie."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (rows, dim)).astype(np.float32)
    dups = np.arange(999, rows, 1000)
    srcs = (rng.random(dups.size) * dups).astype(np.int64)
    srcs -= srcs % 1000 == 999  # a source is never a copy itself
    base[dups] = base[srcs]
    queries = rng.integers(0, 256, (4, dim)).astype(np.float32)
    if dups.size:
        queries[0] = base[srcs[dups.size // 2]]
    return base, queries


def vector_literal(q) -> str:
    return "[" + ",".join(str(int(x)) for x in q) + "]"


def vector_queries(queries, table: str = SIFT_TABLE) -> list[tuple]:
    """(name, sql, metric, k, offset, descending, query index)."""
    out = []
    for name, metric, k, offset, desc, qi in (
            ("V1 l2sq k10", "l2sq", 10, 0, False, 0), ("V2 l2sq k100", "l2sq", 100, 0, False, 1),
            ("V3 cos k10", "cos", 10, 0, False, 2), ("V4 dot desc k10", "dot", 10, 0, True, 3),
            ("V5 l2sq k10 offset 5", "l2sq", 10, 5, False, 1)):
        sql = (f"SELECT id FROM {table} ORDER BY {VEC_METRICS[metric]}(emb, "
               f"'{vector_literal(queries[qi])}'){' DESC' if desc else ''} LIMIT {k}"
               + (f" OFFSET {offset}" if offset else ""))
        out.append((name, sql, metric, k, offset, desc, qi))
    return out


def vector_truth(base64, ss64, q, metric: str):
    """f64 distances of every row to q: exact for l2sq and dot on integer
    data (every partial sum is an integer below 2^53)."""
    q64 = q.astype(np.float64)
    dots = base64 @ q64
    if metric == "dot":
        return dots
    if metric == "l2sq":
        return ss64 - 2.0 * dots + q64 @ q64
    denom = np.sqrt(ss64) * np.sqrt(q64 @ q64)
    return 1.0 - np.where(denom > 0, dots / np.maximum(denom, 1e-300), 0.0)


def check_vector_result(ids, dist, k: int, offset: int, desc: bool, exact: bool, what: str):
    """ids against the truth's ranks offset..offset+k (ties to the lower
    row: np.lexsort((row, d))); exact for l2sq and dot; cos by distance,
    within 1e-6 of the f64 truth at each rank (the port ranks in f32)."""
    key = -dist if desc else dist
    want = np.lexsort((np.arange(dist.size), key))[offset:offset + k]
    got = np.asarray(ids, dtype=np.int64)
    if exact:
        if not np.array_equal(got, want):
            raise AssertionError(f"{what}: ids {got[:12]} != truth {want[:12]}")
    elif got.size != want.size or not np.allclose(dist[got], dist[want], rtol=0, atol=1e-6):
        raise AssertionError(f"{what}: distances {dist[got][:6]} != truth {dist[want][:6]}")


def vector_column(mat):
    """A binary Arrow column of f32-le vectors, built from one buffer."""
    import pyarrow as pa

    n, d = mat.shape
    offsets = np.arange(n + 1, dtype=np.int32) * (d * 4)
    data = np.ascontiguousarray(mat, dtype="<f4").tobytes()
    return pa.Array.from_buffers(pa.binary(), n, [None, pa.py_buffer(offsets.tobytes()),
                                                  pa.py_buffer(data)])


def ingest_vectors(db, table: str, base, chunk: int = 100_000) -> int:
    """Rows (ts = T0 + i ms, id = i, emb) through Database.write, then a flush."""
    import pyarrow as pa

    n = base.shape[0]
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        ids = np.arange(s, e, dtype=np.int64)
        db.write(table, pa.table({"ts": pa.array(T0 + ids, pa.timestamp("ms")), "id": ids,
                                  "emb": vector_column(base[s:e])}))
    db.flush()
    return n


def run_vector_slice(device: str, rows: int, dim: int, reps: int, data_home: str) -> dict:
    """Phase 8's slice: the SIFT-shaped table in the default mode (one
    region scan feeds one K19 launch at 100,000 rows and more), the five
    queries once cold and `reps` times warm, each against a numpy ground
    truth from the seed data; K19 must launch once per run on the card.
    Then a small append-mode VECTOR INDEX table, flushed: the IVF route
    must answer (INDEX_VECTOR_APPLIED moves)."""
    from greptimedb_tpu_torch import Database
    from greptimedb_tpu_torch.ops.vector import _DIST_THRESHOLD_ROWS, topk_distances

    is_cuda = device.startswith("cuda")
    if is_cuda:
        import torch
    db = Database(data_home, device=device, config=device_route_config())
    base, queries = sift_data(rows, dim)
    db.sql(f"CREATE TABLE {SIFT_TABLE} (ts TIMESTAMP TIME INDEX, id BIGINT, emb VECTOR({dim}))")
    t0 = time.perf_counter()
    ingest_vectors(db, SIFT_TABLE, base)
    ingest_s = time.perf_counter() - t0
    emit({"phase": "vector_ingest", "rows": rows, "dim": dim, "seconds": ingest_s,
          "rows_per_s": rows / ingest_s})
    base64 = base.astype(np.float64)
    ss64 = np.einsum("ij,ij->i", base64, base64)
    per_query = {}
    reset_counts()  # the vector main path's run starts here
    for name, sql, metric, k, offset, desc, qi in vector_queries(queries):
        times, stages = [], []
        out = None
        for _ in range(1 + reps):
            before = topk_distances.launches
            t1 = time.perf_counter()
            out = db.sql_one(sql)
            if is_cuda:
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
            stages.append(dict(db.last_vector_timings))
            launched = topk_distances.launches - before
            if is_cuda and launched != int(rows >= _DIST_THRESHOLD_ROWS):
                raise AssertionError(f"{name}: K19 launched {launched} times in one run")
            if is_cuda and launched:
                k19_planned(name)
        truth = vector_truth(base64, ss64, queries[qi], metric)
        check_vector_result(out.column("id").to_numpy(), truth, k, offset, desc,
                            metric != "cos", name)
        warm = stages[1:] if reps else stages
        per_query[name] = {
            "metric": metric, "k": k, "offset": offset, "rows_out": out.num_rows,
            "cold_ms": times[0], "warm_p50_ms": float(np.median(times[1:] if reps else times)),
            "warm_stage_p50_ms": {s: float(np.median([st[s] for st in warm])) for s in warm[0]},
        }
        emit({"phase": "vector_query", "name": name, **per_query[name]})
    totals = launch_counts()  # ... and ends here
    del base64, ss64
    ivf = run_vector_ivf(db, is_cuda)
    db.close()
    return {"rows": rows, "dim": dim, "ingest_s": ingest_s, "queries": per_query,
            "launches": totals, "ivf": ivf}


def run_vector_ivf(db, is_cuda: bool, rows: int = 3000, dim: int = 16) -> dict:
    """An append-mode table with a VECTOR INDEX column, flushed: its SST
    has an IVF sidecar, the search takes the probed candidates
    (INDEX_VECTOR_APPLIED +1) and ranks them (numpy: below the K19
    threshold).  The query is a stored row, which must come first, and the
    five rows lie within the exact top 20 (IVF is approximate)."""
    from greptimedb_tpu_torch.ops.vector import topk_distances
    from greptimedb_tpu_torch.storage.sst import INDEX_VECTOR_APPLIED

    rng = np.random.default_rng(SEED + 8)
    base = rng.integers(0, 256, (rows, dim)).astype(np.float32)
    db.sql(f"CREATE TABLE sift_ivf (ts TIMESTAMP TIME INDEX, id BIGINT, "
           f"emb VECTOR({dim}) VECTOR INDEX) WITH (append_mode = 'true')")
    ingest_vectors(db, "sift_ivf", base)
    q = base[42]
    applied, k19 = INDEX_VECTOR_APPLIED.get(), topk_distances.launches
    t0 = time.perf_counter()
    out = db.sql_one(f"SELECT id FROM sift_ivf ORDER BY vec_l2sq_distance(emb, "
                     f"'{vector_literal(q)}') LIMIT 5")
    ms = (time.perf_counter() - t0) * 1e3
    applied = INDEX_VECTOR_APPLIED.get() - applied
    got = out.column("id").to_pylist()
    near = set(np.argsort(((base.astype(np.float64) - q) ** 2).sum(1), kind="stable")[:20].tolist())
    if applied < 1 or got[0] != 42 or not set(got) <= near or len(got) != 5:
        raise AssertionError(f"IVF route: applied {applied}, ids {got}")
    if topk_distances.launches != k19:
        raise AssertionError("the IVF table's search launched K19 below its threshold")
    res = {"rows": rows, "dim": dim, "ms": ms, "index_vector_applied": applied, "ids": got}
    emit({"phase": "vector_ivf", **res})
    return res


def _vector_bound(n: int, d: int, k: int, metric: str) -> tuple[float, str]:
    # mat, valid and q read once, dist (4 B) and idx (8 B) written once;
    # 2 flops per element for the dots, 2 more for sum(mat * mat)
    return bound(n * d * 4 + n + d * 4 + k * 12, n * d * (2 if metric == "dot" else 4))


K19_MAX_LAUNCHES = 5  # kernels and memsets a call at k <= SMALL_K


def k19_planned(what: str) -> dict:
    """K19's last call launched the kernels and memsets its plan says
    (`topk_launch_plan`), and at most K19_MAX_LAUNCHES where k <= SMALL_K."""
    from greptimedb_tpu_torch.ops import vector as V

    got = dict(V.topk_distances.last_launches)
    k = got.pop("k")
    planned = V.topk_launch_plan(k)
    if got != planned or (k <= V.SMALL_K and sum(got.values()) > K19_MAX_LAUNCHES):
        raise AssertionError(f"{what}: K19 at k={k} launched {got}, its plan {planned} "
                             f"(at most {K19_MAX_LAUNCHES} at k <= {V.SMALL_K})")
    return planned


def _same_topk(a, b, what: str) -> None:
    """Two (dist, idx) results: equal indices and dist bit for bit."""
    import torch

    if not torch.equal(a[1].cpu(), b[1].cpu()):
        bad = int((a[1].cpu() != b[1].cpu()).sum())
        raise AssertionError(f"{what}: {bad} of {a[1].numel()} indices differ")
    if not _same_bytes(a[0].cpu(), b[0].cpu()):
        raise AssertionError(f"{what}: distances differ in their bits")


def run_vector_kernel_phase(rows: int, dim: int, reps: int) -> dict:
    """Phase 8's kernels: K19 against its plain version on the card at the
    slice's shape (the SIFT-shaped rows, one row in 4099 invalid and
    zero-filled), k = 10, 100 and 1000, every metric, both orders: the
    same bytes (integer data: every sum is exact), twice; then uniform
    [0, 1) data, where the two add in different orders: distances within
    2 d 2^-24 of the terms' magnitude, indices equal wherever neighbours
    are further apart than that.  Timed: K19, the plain version, and
    torch.mv + torch.topk (the yardstick)."""
    import torch

    from greptimedb_tpu_torch.ops import vector as V

    dev = torch.device("cuda", 0)
    base, queries = sift_data(rows, dim)
    valid_np = np.ones(rows, dtype=bool)
    valid_np[::4099] = False
    base[~valid_np] = 0.0
    mat = torch.from_numpy(base).to(dev)
    valid = torch.from_numpy(valid_np).to(dev)
    qs = [torch.from_numpy(q).to(dev) for q in queries]
    out = {"ms": {}, "plain_ms": {}, "library_ms": {}, "bound_ms": {}}
    for metric in VEC_METRICS:
        for k in VECTOR_KS:
            for asc in (True, False):
                q = qs[0 if asc else 3]
                args = (mat, valid, q, metric, k, asc)
                got = _twice_identical(lambda: V.topk_distances(*args), f"topk_distances {metric}")
                k19_planned(f"topk_distances {metric} k={k}")
                _same_topk(got, V.topk_distances_plain(*args), f"topk_distances {metric} k={k} asc={asc}")
            key = f"{metric} k={k}"
            args = (mat, valid, qs[0], metric, k, True)
            out["ms"][key] = _timed(lambda: V.topk_distances(*args), reps)
            out["plain_ms"][key] = _timed(lambda: V.topk_distances_plain(*args), max(reps // 2, 1))
            out["library_ms"][key] = _timed(
                lambda: torch.topk(torch.mv(mat, qs[0]), k, largest=False), reps)
            out["bound_ms"][key] = _vector_bound(rows, dim, k, metric)[0]
            emit({"phase": "vector_kernel", "case": key, "ms": out["ms"][key],
                  "plain_ms": out["plain_ms"][key], "library_ms": out["library_ms"][key],
                  "bound_ms": out["bound_ms"][key]})
    # real data: f32 sums in other orders
    rng = np.random.default_rng(SEED + 9)
    real = torch.from_numpy(rng.random((rows, dim), dtype=np.float32)).to(dev)
    qr = torch.from_numpy(rng.random(dim, dtype=np.float32)).to(dev)
    worst, swaps = 0.0, 0
    for metric in VEC_METRICS:
        args = (real, valid, qr, metric, 100, metric != "dot")
        kd, ki = _twice_identical(lambda: V.topk_distances(*args), f"topk_distances real {metric}")
        pd, pi = V.topk_distances_plain(*args)
        rows_k = real[ki].double()
        terms = rows_k * qr.double()
        if metric == "dot":
            scale = terms.abs().sum(1)
        elif metric == "l2sq":
            scale = (rows_k * rows_k).sum(1) + 2 * terms.abs().sum(1) + (qr.double() ** 2).sum()
        else:
            scale = torch.ones_like(kd, dtype=torch.float64)
        tol = 2 * dim * U32 * scale
        diff = (kd.double() - pd.double()).abs()
        if bool((diff > tol).any()):
            raise AssertionError(f"real {metric}: K19 and plain differ by {float(diff.max())}")
        worst = max(worst, float(diff.max()))
        moved = ki != pi
        swaps += int(moved.sum())
        # a different row at a rank is a near-tie: its distance within tol
        if bool(moved.any()) and bool((diff[moved] > tol[moved]).any()):
            raise AssertionError(f"real {metric}: indices differ beyond near-ties")
    out["real_max_abs_err"], out["real_near_tie_swaps"] = worst, swaps
    del real, qr
    main = "l2sq k=10"
    b, by = _vector_bound(rows, dim, 10, "l2sq")
    res = {"max_abs_err": worst, "ms": out["ms"][main], "plain_ms": out["plain_ms"][main],
           "library_ms": out["library_ms"][main], "bound_ms": b, "bound_by": by,
           "rows": rows, "dim": dim, "per_case": out}
    del mat, valid, qs
    torch.cuda.empty_cache()
    res["large_k"] = run_vector_edge_cases(dev, reps)
    return res


def run_vector_edge_cases(dev, reps: int) -> dict:
    """K19 against its plain version on the card and on the host (the form
    the CPU tests hold against the JAX package): the NaN rules, signed
    zeros, d = 1, 3, 128 and 1024, N = 1 and N off every block size, all
    rows invalid, k past the valid rows, k = N past the one-block sort
    (its radix passes), duplicates and both orders, twice each."""
    import torch

    from greptimedb_tpu_torch.ops import vector as V

    rng = np.random.default_rng(SEED + 10)
    nan, neg_nan = np.float32(np.nan), -np.float32(np.nan)
    cases = []
    special = np.array([[1, 0], [nan, 0], [0, 0], [1, 0], [np.inf, 0], [neg_nan, 0],
                        [-np.inf, 0], [0, 1]], np.float32)
    cases.append(("nan rules", special, np.ones(8, bool), np.array([1, 0], np.float32)))
    cases.append(("query nan", special[[0, 2, 3, 7]], np.ones(4, bool),
                  np.array([nan, 1], np.float32)))
    cases.append(("signed zeros, d=1", np.array([[-0.0], [0.0], [-1.0], [2.0], [-0.0]], np.float32),
                  np.ones(5, bool), np.array([1.0], np.float32)))
    for d, hi in ((1, 256), (3, 256), (128, 256), (1024, 16)):
        n = 4099
        m = rng.integers(0, hi, (n, d)).astype(np.float32)
        m[rng.integers(0, n, 40)] = m[rng.integers(0, n, 40)]  # duplicates
        v = rng.random(n) < 0.9
        m[~v] = 0.0
        cases.append((f"d={d}", m, v, rng.integers(0, hi, d).astype(np.float32)))
    cases.append(("N=1", np.array([[3, 4]], np.float32), np.ones(1, bool), np.array([1, 1], np.float32)))
    cases.append(("all invalid", np.zeros((300, 4), np.float32), np.zeros(300, bool),
                  np.ones(4, np.float32)))
    few = rng.integers(0, 256, (100, 8)).astype(np.float32)
    fv = np.zeros(100, bool)
    fv[rng.choice(100, 30, replace=False)] = True
    few[~fv] = 0.0
    cases.append(("k past the valid rows", few, fv, rng.integers(0, 256, 8).astype(np.float32)))
    big = rng.integers(0, 256, (5000, 16)).astype(np.float32)
    cases.append(("k = N = 5000", big, np.ones(5000, bool), rng.integers(0, 256, 16).astype(np.float32)))
    # tie-heavy: a few distinct rows, each many times, so the k-th score is
    # shared by thousands of rows and the lower rows must win (K19's passes
    # over the row bits); at 6000 rows and at 200,003 (every row a candidate)
    for n_ties, d in ((6000, 16), (200_003, 8)):
        distinct = rng.integers(0, 4, (3, d)).astype(np.float32)
        ties = distinct[rng.integers(0, 3, n_ties)]
        tv = rng.random(n_ties) < 0.95
        ties[~tv] = 0.0
        cases.append((f"ties n={n_ties}", ties, tv, rng.integers(0, 4, d).astype(np.float32)))
    for what, m, v, q in cases:
        n = m.shape[0]
        ks = sorted({1, min(7, n), n} | ({2049} if n > 2049 else set()) | ({50} if n == 100 else set()))
        t = [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (m, v, q)]
        for metric in VEC_METRICS:
            for k in ks:
                for asc in (True, False):
                    args = (*t, metric, k, asc)
                    got = _twice_identical(lambda: V.topk_distances(*args), f"edge {what}")
                    k19_planned(f"edge {what} k={k}")
                    _same_topk(got, V.topk_distances_plain(*args), f"edge {what} {metric} k={k} asc={asc}")
                    _same_topk(got, V.topk_distances_plain(*(x.cpu() for x in t), metric, k, asc),
                               f"edge {what} {metric} k={k} asc={asc} (host)")
    # k past the one-block sort at the slice's width: the radix passes
    base, queries = sift_data(SIFT_ROWS // 10, SIFT_DIM)
    t = [torch.from_numpy(base).to(dev), torch.ones(base.shape[0], dtype=torch.bool, device=dev),
         torch.from_numpy(queries[0]).to(dev)]
    args = (*t, "l2sq", 10_000, True)
    _same_topk(_twice_identical(lambda: V.topk_distances(*args), "edge large k"),
               V.topk_distances_plain(*args), "edge k=10000")
    large_k = {"rows": base.shape[0], "k": 10_000,
               **_timed_sort(V.topk_distances, lambda: V.topk_distances(*args), reps)}
    emit({"phase": "vector_edge_cases", "ok": True, "large_k": large_k})
    return large_k


# ---- phase 9: approximate sketches -----------------------------------------------------

UDD_GAMMA = (1 + 0.01) / (1 - 0.01)  # uddsketch_state(128, 0.01, ...)'s starting gamma
SHARDS = 4  # the two-step merge: host ranges, folded in shard order
# the path K20 must take on the card (csrc/segment_hll.cu): rows in group
# runs take the ordered path, the rest the atomic one
HLL_PATHS = {"hll host p=12": "ordered", "hll hour p=12": "atomic", "hll host p=14": "ordered"}
# ... and K21's (csrc/segment_udd.cu), the same rule
UDD_PATHS = {"udd host B=128": "ordered", "udd host B=1024": "ordered",
             "udd hour B=1024": "atomic"}
HLL_BAR, UDD_BAR = 0.05, 0.10  # tests/test_sketch.py's bars: hll_count, uddsketch_calc


def _sketch_bound(kind: str, n: int, total: int) -> tuple[float, str]:
    # K20 reads reg_idx, rho and gids (12 B a row), K21 bucket_ids, gids
    # and mask (9 B a row), once; each writes its [G, width] int32 once
    return bound(n * (12 if kind == "hll" else 9) + total * 4, n * 4)


def _library_call(kind: str, args, dev):
    """One PyTorch call that scatters the same rows, given the flat ids
    the kernel computes per row (the id arithmetic is not timed):
    `scatter_reduce_(..., "amax")` for K20, `index_add_` for K21."""
    import torch

    from greptimedb_tpu_torch.ops.sketch import _flat_ids

    total = args[-2] * args[-1]
    out = torch.zeros(total, dtype=torch.int32, device=dev)
    if kind == "hll":
        reg, rho, gids = args[:3]
        flat, ok = _flat_ids(gids, reg, args[-1], total)
        flat, vals = flat[ok], rho[ok]
        return lambda: out.scatter_reduce_(0, flat, vals, "amax")
    bids, gids, mask = args[:3]
    flat, ok = _flat_ids(gids, bids, args[-1], total)
    flat = flat[ok & mask]
    ones = torch.ones(flat.shape, dtype=torch.int32, device=dev)
    return lambda: out.index_add_(0, flat, ones)


def _sketch_check(kind: str, args, what: str, is_cuda: bool, host_too: bool = False):
    """The kernel twice (the same bytes), against its plain version on the
    same device and, with host_too, on the host; returns its result."""
    import torch

    from greptimedb_tpu_torch.ops import sketch as sk

    kernel, plain = ((sk.segment_hll, sk.segment_hll_plain) if kind == "hll"
                     else (sk.segment_udd, sk.segment_udd_plain))
    a = kernel(*args)
    b = kernel(*args)
    if is_cuda:
        torch.cuda.synchronize()
    if not _same_bytes(a, b):
        raise AssertionError(f"{what}: two runs differ in their bytes")
    del b
    wants = [plain(*args)]
    if host_too:
        wants.append(plain(*(x.cpu() if torch.is_tensor(x) else x for x in args)))
    for want in wants:
        if a.dtype != want.dtype or a.shape != want.shape or not _same_bytes(a, want.to(a.device)):
            raise AssertionError(f"{what}: the kernel and its plain version differ")
    return a


def _hll_path(want: str, what: str) -> str:
    """The path of the last K20 call on the card, which must be `want`."""
    from greptimedb_tpu_torch.ops import sketch as sk

    got = sk.last_hll_path()
    if got != want:
        raise AssertionError(f"{what}: K20 took the {got} path, expected {want}")
    return got


def _udd_path(want: str, what: str) -> str:
    """The path of the last K21 call on the card, which must be `want`."""
    from greptimedb_tpu_torch.ops import sketch as sk

    got = sk.last_udd_path()
    if got != want:
        raise AssertionError(f"{what}: K21 took the {got} path, expected {want}")
    return got


def _hll_path_cases(rng, n_rows: int):
    """(name, path, gids, reg_idx, G, m) of K20's path edges on the card:
    sorted gids with empty groups between their runs, one decreasing gid at
    a warp's and a tile's first row, m at the shared-memory budget and
    above it, long runs of one window split over helper blocks."""
    n = min(n_rows, 1 << 21)
    g = 5000
    sorted_gids = np.sort(rng.integers(0, g, n)) // 3 * 3  # two empty groups in three
    down = sorted_gids.copy()
    at = 1 << 16 if n > 1 << 16 else n // 2 & ~31  # lane 0 of a warp, first row of a tile
    down[at] = down[at - 1] - 1
    big = np.repeat(np.arange(64, dtype=np.int64), n // 64)
    long_runs = np.repeat(np.arange(3, dtype=np.int64), -(-n // 3))[:n]
    regs = rng.integers(0, 4096, n).astype(np.int32)
    return [
        ("sorted, empty groups", "ordered", sorted_gids, regs, g, 4096),
        ("decreasing gid at a tile boundary", "atomic", down, regs, g, 4096),
        ("m at the budget (2^15)", "ordered", big, rng.integers(0, 1 << 15, big.shape[0]), 64,
         1 << 15),
        ("m above the budget (2^16)", "atomic", big, rng.integers(0, 1 << 16, big.shape[0]), 64,
         1 << 16),
        ("long runs, m = 64", "ordered", long_runs, rng.integers(0, 64, n), 3, 64),
    ]


def _udd_path_cases(rng, n_rows: int):
    """(name, path, gids, bucket_ids, mask, G, B) of K21's path edges on the
    card: sorted gids with empty groups between their runs and masked rows,
    a masked row whose bucket is B (ordered: it adds nothing), an unmasked
    bucket of B and of -1 (atomic: its int32 id aliases into a neighbour),
    one decreasing gid at a tile's first row, a gid of G inside a run,
    windows of several groups (few rows a group), and long runs split over
    helper blocks."""
    n = min(n_rows, 1 << 21)
    g = 5000
    sorted_gids = np.sort(rng.integers(0, g, n)) // 3 * 3  # two empty groups in three
    buckets = rng.integers(0, 1024, n).astype(np.int32)
    mask = rng.random(n) > 0.01
    masked_b = buckets.copy()
    masked_b[~mask] = 1024
    at = 1 << 16 if n > 1 << 16 else n // 2 & ~31
    bad_b, neg_b = buckets.copy(), buckets.copy()
    bad_b[at + 5], neg_b[at + 7] = 1024, -1
    mask_ok = mask.copy()
    mask_ok[at + 5] = mask_ok[at + 7] = True
    down = sorted_gids.copy()
    down[at] = down[at - 1] - 1
    past = sorted_gids.copy()
    past[at + 3] = g
    small = np.sort(rng.integers(0, n // 8, n))  # 8 rows a group: windows of 4 groups
    long_runs = np.repeat(np.arange(3, dtype=np.int64), -(-n // 3))[:n]
    return [
        ("sorted, empty groups, masked rows", "ordered", sorted_gids, buckets, mask, g, 1024),
        ("masked bucket = B", "ordered", sorted_gids, masked_b, mask, g, 1024),
        ("unmasked bucket = B", "atomic", sorted_gids, bad_b, mask_ok, g, 1024),
        ("unmasked bucket = -1", "atomic", sorted_gids, neg_b, mask_ok, g, 1024),
        ("decreasing gid at a tile boundary", "atomic", down, buckets, mask, g, 1024),
        ("gid G in a run", "atomic", past, buckets, mask, g, 1024),
        ("windows of several groups", "ordered", small, buckets, mask, n // 8, 1024),
        ("long runs, B = 128", "ordered", long_runs, buckets % 128, mask, 3, 128),
    ]


def run_sketch_edge_cases(dev, n_rows: int, reps: int) -> dict:
    """K20 and K21 against their plain versions on `dev` (on the card also
    against the host's), twice each: seeded ids, empty groups, rho <= 0,
    negative and out-of-range gids with the int32 wrap (gid 2^20 at
    m = 4096 lands on group 0, gid 2^19 wraps negative), masked rows,
    G = 1, N = 0; K20's and K21's path edges (`_hll_path_cases`,
    `_udd_path_cases`, timed on the card); every one of `n_rows` rows on
    one register / bucket (the worst contention, timed on the card); and on
    the card a width past 2^31 (G = 2^19 + 1 at m = 4096, G = 2^21 + 1 at
    B = 1024: 8.6 GB), where the last group's rows wrap negative and are
    dropped.  On the card each K20 and K21 case also checks the path it
    took (ordered or atomic)."""
    import torch

    is_cuda = dev.type == "cuda"
    rng = np.random.default_rng(SEED + 11)
    small = 5000
    wrap = rng.integers(0, 3, small).astype(np.int64)
    wrap[::5] = 1 << 20
    wrap[1::7] = 1 << 19
    wrap[2::11] = -(1 << 20)
    wrap[3::13] = -1
    wrap[4::17] = 3
    cases = [("seeded", rng.integers(0, 9, small), 9, 64),
             ("empty groups", rng.integers(0, 5, small) * 8, 40, 64),
             ("G=1", np.zeros(small, np.int64), 1, 1024),
             ("N=0", np.zeros(0, np.int64), 4, 16),
             ("int32 wrap", wrap, 3, 4096),
             ("out of range", rng.integers(-6, 10, small), 4, 128)]

    def up(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    out = {"hll_paths": {}, "udd_paths": {}}
    for what, gids, g, width in cases:
        n = gids.shape[0]
        cols = up(rng.integers(0, width, n).astype(np.int32))
        rho = up(rng.integers(-3, 40, n).astype(np.int32))
        mask = up(rng.random(n) > 0.2)
        gt = up(gids)
        _sketch_check("hll", (cols, rho, gt, g, width), f"edge hll {what}", is_cuda, is_cuda)
        if is_cuda:
            out["hll_paths"][what] = _hll_path(
                "ordered" if what in ("G=1", "N=0") else "atomic", f"edge hll {what}")
        _sketch_check("udd", (cols, gt, mask, g, width), f"edge udd {what}", is_cuda, is_cuda)
        if is_cuda:
            out["udd_paths"][what] = _udd_path(
                "ordered" if what in ("G=1", "N=0") else "atomic", f"edge udd {what}")
    for what, path, gids, regs, g, width in _hll_path_cases(rng, n_rows):
        args = (up(regs.astype(np.int32)), up(rng.integers(-3, 64, gids.shape[0]).astype(np.int32)),
                up(gids), g, width)
        _sketch_check("hll", args, f"edge hll {what}", is_cuda)
        if is_cuda:
            from greptimedb_tpu_torch.ops import sketch as sk

            out["hll_paths"][what] = {"path": _hll_path(path, f"edge hll {what}"),
                                      "ms": _timed(lambda: sk.segment_hll(*args), reps)}
        del args
    for what, path, gids, buckets, mask, g, width in _udd_path_cases(rng, n_rows):
        args = (up(buckets), up(gids), up(mask), g, width)
        _sketch_check("udd", args, f"edge udd {what}", is_cuda)
        if is_cuda:
            from greptimedb_tpu_torch.ops import sketch as sk

            out["udd_paths"][what] = {"path": _udd_path(path, f"edge udd {what}"),
                                      "ms": _timed(lambda: sk.segment_udd(*args), reps)}
        del args

    zeros = torch.zeros(n_rows, dtype=torch.int32, device=dev)
    rho = up(rng.integers(1, 50, n_rows).astype(np.int32))
    ones = torch.ones(n_rows, dtype=torch.bool, device=dev)
    hll_args, udd_args = (zeros, rho, zeros, 1, 4096), (zeros, zeros, ones, 1, 128)
    _sketch_check("hll", hll_args, "edge hll one register", is_cuda)
    if is_cuda:
        out["hll_paths"]["one register"] = _hll_path("ordered", "edge hll one register")
    _sketch_check("udd", udd_args, "edge udd one bucket", is_cuda)
    if is_cuda:
        out["udd_paths"]["one bucket"] = _udd_path("ordered", "edge udd one bucket")
        from greptimedb_tpu_torch.ops import sketch as sk

        out["one_register_ms"] = _timed(lambda: sk.segment_hll(*hll_args), reps)
        out["one_bucket_ms"] = _timed(lambda: sk.segment_udd(*udd_args), reps)
    del zeros, rho, ones, hll_args, udd_args
    if is_cuda:
        n = 1 << 20
        for kind, g, width in (("hll", (1 << 19) + 1, 4096), ("udd", (1 << 21) + 1, 1024)):
            gids = rng.integers(0, g, n).astype(np.int32)
            gids[::10] = g - 1  # wraps negative: dropped
            cols = up(rng.integers(0, width, n).astype(np.int32))
            second = up(rng.integers(1, 40, n).astype(np.int32)) if kind == "hll" else up(
                np.ones(n, bool))
            args = ((cols, second, up(gids), g, width) if kind == "hll"
                    else (cols, up(gids), second, g, width))
            got = _sketch_check(kind, args, f"edge {kind} G*width >= 2^31", is_cuda)
            if kind == "hll":
                out["hll_paths"]["G*m >= 2^31"] = _hll_path("atomic", "edge hll G*m >= 2^31")
            else:
                out["udd_paths"]["G*B >= 2^31"] = _udd_path("atomic", "edge udd G*B >= 2^31")
            if bool(got[g - 1].any()) or not bool(got[g - 2].any()):
                raise AssertionError(f"edge {kind} G*width >= 2^31: the last group's rows "
                                     f"were not dropped")
            del got, args, cols, second
            torch.cuda.empty_cache()
        out["past_2_31"] = True
    emit({"phase": "sketch_edge_cases", "ok": True, **out})
    return out


def run_sketch_kernel_phase(device: str, n_hosts: int, hours: int, reps: int) -> dict:
    """Phase 9's kernels on `device` ("cuda" on the card; "cpu" rehearses
    the control flow with the plain versions): K20 `segment_hll` over
    hll_inputs(hash64(usage_user)) of the TSBS rows in (hostname, ts)
    order, grouped by host (p = 12 and 14) and by hour (p = 12); K21
    `segment_udd` over udd_bucket_ids(usage_user, gamma(0.01), B), B = 128
    and 1024 by host and B = 1024 by hour, one row in 100 masked.  On the
    card each case's path (ordered or atomic) is asserted.  Each against its plain
    version byte for byte and twice; on the card the kernel, the plain
    version and the library call are timed.  The tie to the SQL path: K20's
    host registers as uint8 equal the host `hll_build_grouped` of the same
    rows.  Then the main path: the rows as SHARDS host ranges, K20 and K21
    per shard, folded in shard order by torch.maximum and +, which must
    equal the single pass (launches counted), and the estimates against
    the seed data.  Then the edge cases."""
    import pyarrow as pa
    import torch

    from greptimedb_tpu_torch.ops import sketch as sk

    is_cuda = device.startswith("cuda")
    dev = torch.device(device)
    t0 = time.perf_counter()
    user = tsbs_columns(Tsbs(n_hosts, hours), ("usage_user",))["usage_user"]
    n = user.shape[0]
    ticks = n // n_hosts
    host_np = np.repeat(np.arange(n_hosts, dtype=np.int32), ticks)
    hour_np = np.tile((np.arange(ticks) * SCRAPE_S // 3600).astype(np.int32), n_hosts)
    mask_np = np.ones(n, dtype=bool)
    mask_np[::100] = False
    t1 = time.perf_counter()
    hashes = sk.hash64(pa.array(user))
    t2 = time.perf_counter()
    inputs = {p: sk.hll_inputs(hashes, p) for p in (12, 14)}
    t3 = time.perf_counter()
    bids = {b: sk.udd_bucket_ids(user, UDD_GAMMA, b) for b in (128, 1024)}
    host_s = {"data_s": t1 - t0, "hash64_s": t2 - t1, "hll_inputs_s": t3 - t2,
              "udd_bucket_ids_s": time.perf_counter() - t3}

    def up(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    host, hour, mask = up(host_np), up(hour_np), up(mask_np)
    idx = {p: up(inputs[p][0]) for p in inputs}
    rho = {p: up(inputs[p][1]) for p in inputs}
    bid = {b: up(bids[b]) for b in bids}
    cases = {
        "hll host p=12": ("hll", (idx[12], rho[12], host, n_hosts, 1 << 12)),
        "hll hour p=12": ("hll", (idx[12], rho[12], hour, hours, 1 << 12)),
        "hll host p=14": ("hll", (idx[14], rho[14], host, n_hosts, 1 << 14)),
        "udd host B=128": ("udd", (bid[128], host, mask, n_hosts, 128)),
        "udd host B=1024": ("udd", (bid[1024], host, mask, n_hosts, 1024)),
        "udd hour B=1024": ("udd", (bid[1024], hour, mask, hours, 1024)),
    }
    out = {"rows": n, "hosts": n_hosts, "hours": hours, "host_s": host_s, "per_case": {}}
    single = {}
    for name, (kind, args) in cases.items():
        single[name] = _sketch_check(kind, args, name, is_cuda)
        b, by = _sketch_bound(kind, n, args[-2] * args[-1])
        rec = {"bound_ms": b, "bound_by": by}
        if is_cuda:
            rec["path"] = (_hll_path(HLL_PATHS[name], name) if kind == "hll"
                           else _udd_path(UDD_PATHS[name], name))
        if is_cuda:
            kernel, plain = ((sk.segment_hll, sk.segment_hll_plain) if kind == "hll"
                             else (sk.segment_udd, sk.segment_udd_plain))
            rec["ms"] = _timed(lambda: kernel(*args), reps)
            rec["plain_ms"] = _timed(lambda: plain(*args), max(reps // 2, 1))
            rec["library_ms"] = _timed(_library_call(kind, args, dev), reps)
            torch.cuda.empty_cache()
        out["per_case"][name] = rec
        emit({"phase": "sketch_kernel", "case": name, **rec})
    # the tie to the SQL path: K20's host registers are hll_build_grouped's
    t4 = time.perf_counter()
    host_regs = sk.hll_build_grouped(hashes, host_np, n_hosts, 12)
    host_s["hll_build_grouped_s"] = time.perf_counter() - t4
    regs_by_host = single["hll host p=12"].cpu().numpy().astype(np.uint8)
    if not np.array_equal(regs_by_host, host_regs):
        raise AssertionError("K20's registers differ from the host hll_build_grouped")
    del hashes, inputs, bids, host_regs
    # the main path: per-shard partials folded in shard order
    cut = [(s * n_hosts // SHARDS) * ticks for s in range(SHARDS + 1)]
    reset_counts()  # phase 9's main path starts here
    t5 = time.perf_counter()
    regs = counts = None
    verdicts = []  # each shard's kept verdict words, read after the timing
    for lo, hi in zip(cut[:-1], cut[1:]):
        r = sk.segment_hll(idx[12][lo:hi], rho[12][lo:hi], host[lo:hi], n_hosts, 1 << 12)
        c = sk.segment_udd(bid[1024][lo:hi], host[lo:hi], mask[lo:hi], n_hosts, 1024)
        verdicts.append((sk.segment_hll.last_verdict, sk.segment_udd.last_verdict))
        regs = r if regs is None else torch.maximum(regs, r)
        counts = c if counts is None else counts + c
    if is_cuda:
        torch.cuda.synchronize()
    out["two_step_ms"] = (time.perf_counter() - t5) * 1e3
    out["launches"] = launch_counts()  # ... and ends here
    if is_cuda:  # every shard's rows are host runs: both kernels' ordered path
        for s, (v_hll, v_udd) in enumerate(verdicts):
            for kernel, v in (("K20", v_hll), ("K21", v_udd)):
                if sk.path_of(v) != "ordered":
                    raise AssertionError(f"two-step shard {s}: {kernel} took the "
                                         f"{sk.path_of(v)} path, expected ordered")
        out["two_step_paths"] = "ordered"
    for got, name in ((regs, "hll host p=12"), (counts, "udd host B=1024")):
        if not _same_bytes(got, single[name]):
            raise AssertionError(f"two-step {name}: the folded shards differ from the single pass")
    if is_cuda and (out["launches"]["segment_hll"], out["launches"]["segment_udd"]) != (SHARDS,) * 2:
        raise AssertionError(f"two-step path launches {out['launches']}")
    # the estimates against the seed data: the union of the host registers
    # and each hour's registers within HLL_BAR of the exact distinct count
    # (the per-host estimates, 4320 rows each at 12 h, are reported: the
    # largest of thousands of 1.6 %-error estimates may pass a 5 % bar)
    by_host = user.reshape(n_hosts, ticks)
    est_host = sk.hll_estimate(regs.cpu().numpy())
    exact_host = np.array([np.unique(row).size for row in by_host])
    est_union = sk.hll_estimate(regs.max(0).values.cpu().numpy())
    exact_union = np.unique(user).size
    est_hour = sk.hll_estimate(single["hll hour p=12"].cpu().numpy())
    exact_hour = np.array([np.unique(user[hour_np == h]).size for h in range(hours)])
    kept = mask_np.reshape(n_hosts, ticks)
    truth = np.array([np.quantile(row[k], 0.99) for row, k in zip(by_host, kept)])
    p99 = sk.udd_quantile_dense(counts.cpu().numpy(), 0.99, UDD_GAMMA)
    out["hll_host_max_rel_err"] = float(np.max(np.abs(est_host - exact_host) / exact_host))
    out["hll_max_rel_err"] = float(max(abs(est_union - exact_union) / exact_union,
                                       np.max(np.abs(est_hour - exact_hour) / exact_hour)))
    out["udd_p99_max_rel_err"] = float(np.max(np.abs(p99 - truth) / truth))
    if out["hll_max_rel_err"] > HLL_BAR or out["udd_p99_max_rel_err"] > UDD_BAR:
        raise AssertionError(f"device sketches off their bars: hll {out['hll_max_rel_err']}, "
                             f"p99 {out['udd_p99_max_rel_err']}")
    del regs, counts, single, idx, rho, bid, host, hour, mask, cases
    if is_cuda:
        torch.cuda.empty_cache()
    out["edge"] = run_sketch_edge_cases(dev, n, reps)
    out["regs_by_host"] = regs_by_host
    emit({"phase": "sketch_kernels", "ok": True, "rows": n, "host_s": host_s,
          "two_step_ms": out["two_step_ms"], "two_step_paths": out.get("two_step_paths"),
          "hll_max_rel_err": out["hll_max_rel_err"], "hll_host_max_rel_err": out["hll_host_max_rel_err"],
          "udd_p99_max_rel_err": out["udd_p99_max_rel_err"]})
    return out


ROLLUP = "cpu_rollup"


def sketch_queries() -> list[tuple[str, str]]:
    """S1-S5: active hosts per hour, per-host p99, per-host HLL states,
    the whole table's hosts and median, and GreptimeDB's two-step rollup
    (hourly states stored in a BINARY table, merged at query time; S5's
    first statement makes the states, its second merges them)."""
    return [
        ("S1", "SELECT time_bucket('1h', ts) AS h, hll_count(hll(hostname)) AS hosts "
               "FROM cpu GROUP BY h ORDER BY h"),
        ("S2", "SELECT hostname, uddsketch_calc(0.99, uddsketch_state(128, 0.01, usage_user)) "
               "AS p99 FROM cpu GROUP BY hostname"),
        ("S3", "SELECT hostname, hll(usage_user) AS s FROM cpu GROUP BY hostname"),
        ("S4", "SELECT hll_count(hll(hostname)) AS hosts, hll(hostname) AS s, "
               "uddsketch_calc(0.5, uddsketch_state(128, 0.01, usage_idle)) AS p50 FROM cpu"),
        ("S5 states", "SELECT time_bucket('1h', ts) AS h, hll(hostname) AS s, "
                      "uddsketch_state(128, 0.01, usage_user) AS u FROM cpu GROUP BY h ORDER BY h"),
        ("S5", f"SELECT hll_count(hll_merge(s)) AS hosts, hll_merge(s) AS s, "
               f"uddsketch_calc(0.99, uddsketch_merge(u)) AS p99 FROM {ROLLUP}"),
    ]


def _rel(got, want) -> float:
    return abs(got - want) / abs(want)


def check_sketch_result(name: str, t, truth: dict) -> float:
    """Hold one result to the reference test's bars against the seed data;
    returns the largest relative error (0 where states are compared)."""
    from greptimedb_tpu_torch.ops import sketch as sk

    # every host reports at every tick of the load: the exact distinct
    # count of each hour and of the table is the number of hosts
    n_hosts, hours = truth["hosts"], truth["hours"]
    cols = t.to_pydict()
    if name == "S1":
        if len(cols["hosts"]) != hours:
            raise AssertionError(f"S1: {len(cols['hosts'])} hours")
        errs = [_rel(c, n_hosts) for c in cols["hosts"]]
        bar = HLL_BAR
    elif name == "S2":
        if len(cols["p99"]) != n_hosts:
            raise AssertionError(f"S2: {len(cols['p99'])} hosts")
        errs = [_rel(p, truth["user_p99_by_host"][int(h[5:])])
                for h, p in zip(cols["hostname"], cols["p99"])]
        bar = UDD_BAR
    elif name == "S3":
        if len(cols["s"]) != n_hosts:
            raise AssertionError(f"S3: {len(cols['s'])} hosts")
        for h, s in zip(cols["hostname"], cols["s"]):
            if not np.array_equal(sk.hll_deserialize(s), truth["regs_by_host"][int(h[5:])]):
                raise AssertionError(f"S3 {h}: the state is not K20's registers")
        return 0.0
    elif name == "S4":
        errs = [_rel(cols["hosts"][0], n_hosts), _rel(cols["p50"][0], truth["idle_p50"])]
        if errs[0] > HLL_BAR or errs[1] > UDD_BAR:
            raise AssertionError(f"S4 off its bars: {errs}")
        return max(errs)
    elif name == "S5 states":
        if len(cols["s"]) != hours:
            raise AssertionError(f"S5 states: {len(cols['s'])} hours")
        return 0.0
    else:  # S5
        if cols["s"][0] != truth["s4_state"]:
            raise AssertionError("S5: the merged HLL state is not S4's hll(hostname)")
        errs = [_rel(cols["hosts"][0], n_hosts), _rel(cols["p99"][0], truth["user_p99"])]
        if errs[0] > HLL_BAR or errs[1] > UDD_BAR:
            raise AssertionError(f"S5 off its bars: {errs}")
        return max(errs)
    if max(errs) > bar:
        raise AssertionError(f"{name}: relative error {max(errs)} past {bar}")
    return max(errs)


def run_sketch_slice(device: str, n_hosts: int, hours: int, reps: int, data_home: str,
                     regs_by_host) -> dict:
    """Phase 9's slice: the TSBS table through Database.write (WAL on),
    flushed; S1-S5 through Database.sql once cold and `reps` times warm.
    The sketches are host work in both packages: every run must be
    declined by the device executor (`declined` +1, last_path "cpu") and
    launch no kernel.  S5's hourly states go through Database.write into
    a BINARY table before the merge.  `regs_by_host` are K20's host
    registers for the same rows (S3's states must be them)."""
    import pyarrow as pa

    from greptimedb_tpu_torch import Database

    db = Database(data_home, device=device, config=device_route_config())
    tsbs = Tsbs(n_hosts, hours)
    t0 = time.perf_counter()
    n_rows, _gt = ingest(db, tsbs)
    ingest_s = time.perf_counter() - t0
    cols = tsbs_columns(tsbs, ("usage_user", "usage_idle"))
    truth = {"hosts": n_hosts, "hours": hours, "regs_by_host": regs_by_host,
             "user_p99_by_host": np.quantile(cols["usage_user"].reshape(n_hosts, -1), 0.99, axis=1),
             "user_p99": float(np.quantile(cols["usage_user"], 0.99)),
             "idle_p50": float(np.quantile(cols["usage_idle"], 0.5))}
    del cols
    emit({"phase": "sketch_ingest", "rows": n_rows, "seconds": ingest_s})
    eng = db.query_engine
    per_query = {}
    reset_counts()
    for name, sql in sketch_queries():
        if name == "S5":
            states = per_query["S5 states"].pop("table")
            db.sql(f"CREATE TABLE {ROLLUP} (h TIMESTAMP(3) TIME INDEX, s BINARY, u BINARY)")
            db.write(ROLLUP, pa.table({"h": states["h"], "s": states["s"], "u": states["u"]}))
            db.flush()
        times = []
        for _ in range(1 + reps):
            declined = eng.stats["declined"]
            t1 = time.perf_counter()
            t = db.sql_one(sql)
            times.append((time.perf_counter() - t1) * 1e3)
            if eng.stats["declined"] != declined + 1 or eng.last_path != "cpu":
                raise AssertionError(f"{name}: not declined to the CPU executor")
        err = check_sketch_result(name, t, truth)
        if name == "S4":
            truth["s4_state"] = t["s"][0].as_py()
        per_query[name] = {"cold_ms": times[0], "warm_p50_ms": float(np.median(times[1:] or times)),
                           "max_rel_err": err, "rows_out": t.num_rows}
        if name == "S5 states":
            per_query[name]["table"] = t
        emit({"phase": "sketch_query", "name": name,
              **{k: v for k, v in per_query[name].items() if k != "table"}})
    per_query["S5"]["states"] = per_query.pop("S5 states")
    launches = launch_counts()
    if any(launches.values()):
        raise AssertionError(f"a sketch query launched a kernel: {launches}")
    db.close()
    return {"rows": n_rows, "ingest_s": ingest_s, "queries": per_query}


# ---- main ------------------------------------------------------------------------------

# ---- phase 10: the mesh (tile.mesh_devices) and K22 ---------------------------------------

MESH_SLOTS = 4  # (c): the partitioned table's regions, and the device list's slots
MESH_SOURCES = 8  # (a) dense: partials of 8 sources
MESH_GROUPS = 4000 * 12  # double-groupby-all's groups (4000 hosts x 12 hourly buckets)
MESH_COLS = 10
MESH_H = 1 << 24  # (a) keyed: the container cell's slot tables
_K22 = "fold_states"
# bench.py's MULTICHIP_QUERIES (bench.py:1871-1880), all of them TSBS queries
MULTICHIP = ("double-groupby-1", "double-groupby-5", "double-groupby-all",
             "single-groupby-5-8-1", "cpu-max-all-8")


def _fold_inputs(rng, m: int, rows: int, dev, edge: bool = False):
    """Stacked partial states [m, rows] from the seed: f64 sums, min and max
    (NaN, +-inf and +-0.0 mixed in for `edge`), int32 counts, LAST (ts ties
    for `edge`)."""
    import torch

    from greptimedb_tpu_torch.ops.aggregate import AggState

    def f64():
        v = rng.standard_normal((m, rows)) * 100.0
        if edge:
            pool = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1.5, -1.5])
            v = np.where(rng.random((m, rows)) < 0.4, rng.choice(pool, size=(m, rows)), v)
        return torch.from_numpy(v).to(dev)

    ts = rng.integers(0, 4, (m, rows)) if edge else rng.integers(0, 1 << 40, (m, rows))
    return AggState(sums=f64(), counts=torch.from_numpy(rng.integers(0, 400, (m, rows))
                                                       .astype(np.int32)).to(dev),
                    mins=f64(), maxs=f64(), last_ts=torch.from_numpy(ts.astype(np.int64)).to(dev),
                    last_val=f64())


def _state_bytes(st) -> int:
    return sum(t.numel() * t.element_size() for t in _state_tensors(st) if t is not None)


def _same_state_bytes(a, b, what: str) -> None:
    for name, x, y in zip(("sums", "counts", "mins", "maxs", "last_ts", "last_val"),
                          _state_tensors(a), _state_tensors(b)):
        if not _same_bytes(x, y):
            raise AssertionError(f"{what}.{name}: K22 and its plain version differ in their bytes")


def _twice_on(dev, fn, what: str):
    """`_twice_identical` on the card; on the CPU (a rehearsal) the same
    check without the device sync."""
    if dev.type == "cuda":
        return _twice_identical(fn, what)
    a, b = fn(), fn()
    xs = _state_tensors(a) if hasattr(a, "sums") else [a]
    ys = _state_tensors(b) if hasattr(b, "sums") else [b]
    if not all(_same_bytes(x, y) for x, y in zip(xs, ys)):
        raise AssertionError(f"{what}: two runs differ in their bytes")
    return a


def _slot_tables(n_slots: int, h: int, hours: int, dev):
    """Slot tables of the container cell: H1's int64 group ids (K1 over the
    6 h table) in `n_slots` contiguous row shards, each shard's K17 table
    of `h` slots.  Returns the tables [n_slots, h]."""
    import torch

    from greptimedb_tpu_torch.ops.aggregate import HASH_EMPTY, hash_group_slots
    from greptimedb_tpu_torch.ops.filter import mask_gids

    n, args = h1_group_ids(hours, dev)
    gids, mask = mask_gids(*args)
    bounds = np.linspace(0, gids.shape[0], n_slots + 1).astype(np.int64)
    tables = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        t = torch.full((h,), HASH_EMPTY, dtype=torch.int64, device=dev)
        t, _slots, ovf = hash_group_slots(t, gids[a:b].contiguous(), mask[a:b].contiguous())
        if int(ovf) != 0:
            raise AssertionError("container slot table overflowed")
        tables.append(t)
    return torch.stack(tables)


def _keyed_states(tables, trailing: bool, seed: int):
    """Per slot table, partial states over its slots: seeded values in the
    occupied slots, the scatter identity in the empty ones (what a partial
    holds there), the trailing row seeded when present."""
    import torch

    from greptimedb_tpu_torch.ops.aggregate import HASH_EMPTY, AggState

    d, h = tables.shape
    dev = tables.device
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    occ = tables != HASH_EMPTY
    if trailing:
        occ = torch.cat([occ, torch.ones(d, 1, dtype=torch.bool, device=dev)], dim=1)

    def vals(ident, dtype=torch.float64):
        if dtype == torch.int32:
            v = torch.randint(0, 400, occ.shape, generator=g, device=dev, dtype=torch.int32)
        else:
            v = torch.randn(occ.shape, generator=g, device=dev, dtype=torch.float64) * 100.0
        return torch.where(occ, v, torch.full_like(v, ident))

    return AggState(sums=vals(0.0), counts=vals(0, torch.int32), mins=vals(float("inf")),
                    maxs=vals(float("-inf")))


def run_mesh_kernel_phase(device: str, reps: int, hours: int = 6, groups: int = MESH_GROUPS,
                          h: int = MESH_H) -> dict:
    """Phase 10a: K22 against its plain version on the card, byte for byte
    and twice: dense, S = 8 sources over double-groupby-all's state shape
    (48,000 groups x 10 columns: sums, counts, min, max, LAST); keyed, 4
    slot tables of 2^24 slots built by K17 from H1's ids of the container
    cell (8000 series x `hours`), unioned by K17, inverted and folded;
    then the edge cases.  Times K22, its plain version and the library
    calls (`sum`/`amin`/`amax` over the stacked states; `index_add_` for
    keyed, over the occupied rows; neither gives the same bytes) with CUDA
    events."""
    import torch

    from greptimedb_tpu_torch.ops import aggregate as agg

    dev = torch.device(device)
    is_cuda = dev.type == "cuda"
    rng = np.random.default_rng(SEED)
    out = {"per_case": {}}

    def timed(fn):
        return _timed(fn, reps) if is_cuda else None

    def merged(st, n_local, order, what, rule="fold"):
        """One key's fold as the mesh calls K22 (`fold_state_dicts` over
        per-source states) and in the one-key form, each twice and byte for
        byte the plain version; ms of the first, one_key_ms of the second."""
        per = [{"k": agg.AggState(**{f: getattr(st, f)[i] for f in _K22_FIELDS
                                     if getattr(st, f) is not None})}
               for i in range(st.sums.shape[0])]
        want = agg.fold_states_plain(st, n_local, order, rule=rule)
        for name, fn in (("merge", lambda: agg.fold_state_dicts(per, n_local, order,
                                                                rule=rule)["k"]),
                         ("one-key form", lambda: agg.fold_states(st, n_local, order,
                                                                  rule=rule))):
            _same_state_bytes(_twice_on(dev, fn, f"{what} {name}"), want, f"{what} {name}")
        return {"ms": timed(lambda: agg.fold_state_dicts(per, n_local, order, rule=rule)),
                "one_key_ms": timed(lambda: agg.fold_states(st, n_local, order, rule=rule))}, want

    # dense, at the main path's shape
    rows = groups * MESH_COLS
    st = _fold_inputs(rng, MESH_SOURCES, rows, dev)
    order = list(range(MESH_SOURCES))
    case, k = merged(st, MESH_SOURCES, order, "K22 dense")
    t_bound, by = bound(_state_bytes(st) + _state_bytes(k), 0)
    lib = (lambda: (st.sums.sum(0), st.counts.sum(0, dtype=torch.int32), st.mins.amin(0),
                    st.maxs.amax(0)))
    out["per_case"]["dense"] = {
        "sources": MESH_SOURCES, "rows": rows, **case,
        "plain_ms": timed(lambda: agg.fold_states_plain(st, MESH_SOURCES, order)),
        "library_ms": timed(lib), "bound_ms": t_bound, "bound_by": by,
    }
    # the mesh runs' most frequent shape: 4 sources (one a slot) x 2^16 rows
    st4 = _fold_inputs(rng, MESH_SLOTS, 1 << 16, dev)
    order4 = list(range(MESH_SLOTS))
    case, k4 = merged(st4, 1, order4, "K22 dense 4 x 2^16")
    b4, by4 = bound(_state_bytes(st4) + _state_bytes(k4), 0)
    out["per_case"]["dense_4x65536"] = {"sources": MESH_SLOTS, "rows": 1 << 16, **case,
                                        "bound_ms": b4, "bound_by": by4}
    del st4, k4
    # the table-fed route's rule (psum), one source per slot: the same
    # bytes in and out as the fold rule
    case, k = merged(st, 1, order, "K22 psum", rule="psum")
    out["per_case"]["psum"] = {**case, "bound_ms": t_bound, "bound_by": by}
    del st, k

    # keyed, at the container cell's slot tables
    tables = _slot_tables(MESH_SLOTS, h, hours, dev)
    keys = tables.reshape(-1)
    _u = torch.full((h,), agg.HASH_EMPTY, dtype=torch.int64, device=dev)
    _u, slots, ovf = agg.hash_group_slots(_u, keys, keys != agg.HASH_EMPTY)
    if int(ovf) != 0:
        raise AssertionError("the union of the slot tables overflowed")
    slot_map = slots.reshape(MESH_SLOTS, h)
    inv = _twice_on(dev, lambda: agg.invert_slot_maps(slot_map), "K22 invert")
    if not _same_bytes(inv, agg.invert_slot_maps_plain(slot_map)):
        raise AssertionError("K22 invert: kernel and plain version differ")
    kst = _keyed_states(tables, False, SEED)
    korder = list(range(MESH_SLOTS))
    k = _twice_on(dev, lambda: agg.fold_states(kst, 1, korder, inv=inv), "K22 keyed")
    _same_state_bytes(k, agg.fold_states_plain(kst, 1, korder, inv=inv), "K22 keyed")
    occupied = int((tables != agg.HASH_EMPTY).sum())
    # what the keyed fold needs: each slot map read once, each partial's
    # occupied rows (an empty slot holds the identity and is skipped), the
    # merged state written once
    row_bytes = sum(t.element_size() for t in _state_tensors(kst) if t is not None)
    t_bound, by = bound(slot_map.numel() * 4 + occupied * row_bytes + _state_bytes(k), 0)
    # the library yardstick: index_add_ of the occupied rows' sums into
    # their union slots (the rows and their slots gathered beforehand)
    occ = keys != agg.HASH_EMPTY
    lib_idx, lib_src = slots[occ].to(torch.int64), kst.sums.reshape(-1)[occ]
    lib_acc = torch.zeros(h, dtype=torch.float64, device=dev)
    out["per_case"]["keyed"] = {
        "slots": h, "tables": MESH_SLOTS, "occupied": occupied,
        "ms": timed(lambda: agg.fold_states(kst, 1, korder, inv=agg.invert_slot_maps(slot_map))),
        "invert_ms": timed(lambda: agg.invert_slot_maps(slot_map)),
        "plain_ms": timed(lambda: agg.fold_states_plain(
            kst, 1, korder, inv=agg.invert_slot_maps_plain(slot_map))),
        "library_ms": timed(lambda: lib_acc.index_add_(0, lib_idx, lib_src)),
        "bound_ms": t_bound, "bound_by": by,
    }
    del kst, k, inv, lib_idx, lib_src, lib_acc, occ, slots, slot_map, _u

    out["edge"] = run_mesh_edge_cases(dev, rng)
    return out


def run_mesh_edge_cases(dev, rng) -> list[str]:
    """K22's edge cases, each byte for byte against the plain version and
    twice: NaN, +-inf and +-0.0 in every field at 8 slots with dummies (3
    sources a slot, 7 real), LAST ts ties, empty sources, both rules; the
    keyed fold with and without the trailing row over small K17 tables;
    one source."""
    import torch

    from greptimedb_tpu_torch.ops import aggregate as agg

    done = []

    def check(st, n_local, order, what, inv=None, rule="fold"):
        k = _twice_on(dev, lambda: agg.fold_states(st, n_local, order, inv=inv, rule=rule), what)
        _same_state_bytes(k, agg.fold_states_plain(st, n_local, order, inv=inv, rule=rule), what)
        done.append(what)

    st = _fold_inputs(rng, 24, 4099, dev, edge=True)
    st.sums[5], st.counts[5], st.mins[5], st.maxs[5] = 0.0, 0, float("inf"), float("-inf")
    order = [0, 3, 6, 9, 12, 15, 18, 1, 4, 7, 10, 13, 16, 19, 2]  # real sources only
    check(st, 3, order, "edge dense, 8 slots x 3 with dummies")
    check(st, 1, list(range(24)), "edge dense, psum rule", rule="psum")
    check(st, 24, [7], "edge dense, one source")
    for trailing in (False, True):
        tables = torch.full((4, 4096), agg.HASH_EMPTY, dtype=torch.int64, device=dev)
        for d in range(4):
            ids = torch.from_numpy(rng.choice(3000, size=1500).astype(np.int64)).to(dev)
            agg.hash_group_slots(tables[d], ids, torch.ones_like(ids, dtype=torch.bool))
        keys = tables.reshape(-1)
        u = torch.full((4096,), agg.HASH_EMPTY, dtype=torch.int64, device=dev)
        _u, slots, _ovf = agg.hash_group_slots(u, keys, keys != agg.HASH_EMPTY)
        inv = agg.invert_slot_maps(slots.reshape(4, 4096))
        kst = _keyed_states(tables.repeat_interleave(2, dim=0), trailing, SEED + 1)
        check(kst, 2, [0, 2, 4, 6, 1, 3, 7], f"edge keyed, trailing row {trailing}", inv=inv)
        if trailing:
            # staged: 600 sources (560 real) over the same tables
            kst = _keyed_states(tables.repeat_interleave(150, dim=0), True, SEED + 3)
            korder = [s * 150 + i for i in range(140) for s in (2, 0, 3, 1)]
            check(kst, 150, korder, "edge keyed, 560 real sources (staged)", inv=inv)
    done += run_staged_fold_cases(dev, rng, check)
    return done


def run_staged_fold_cases(dev, rng, check) -> list[str]:
    """K22 past its descriptor, byte for byte against the plain version and
    twice: 640 sources at 8 slots x 80, 600 real (more real sources than
    the descriptor's 512; 3846 pointers), under both rules; 1000 sources
    at 4 x 250 with 300 real (the pointers alone past its 3734); and a
    merge of three keys at 700 sources whose middle key alone passes the
    descriptor: three launches, as `fold_launch_plan` makes them, the
    middle one staged."""
    from greptimedb_tpu_torch.ops import aggregate as agg

    done = []
    st = _fold_inputs(rng, 640, 4099, dev, edge=True)
    order = [s * 80 + i for i in range(75) for s in (3, 1, 4, 0, 6, 2, 7, 5)]
    check(st, 80, order, "staged dense, 600 of 640 sources")
    check(st, 1, list(range(640)), "staged dense, 640 sources, psum rule", rule="psum")
    del st
    st = _fold_inputs(rng, 1000, 1031, dev, edge=True)
    check(st, 250, [s * 250 + i for s in range(4) for i in range(75)],
          "staged dense, 300 of 1000 sources")
    del st
    st = _fold_inputs(rng, 700, 2053, dev, edge=True)
    order = list(range(0, 700, 2))
    per = [{"a": agg.AggState(sums=st.sums[i]),
            "b": agg.AggState(**{f: getattr(st, f)[i] for f in _K22_FIELDS}),
            "c": agg.AggState(counts=st.counts[i])} for i in range(700)]
    plan = agg.fold_launch_plan([("a", ("sums",)), ("b", _K22_FIELDS), ("c", ("counts",))],
                                700, len(order))
    if [agg.fold_launch_staged(u, 700, len(order)) for u in plan] != [False, True, False]:
        raise AssertionError(f"K22 staged merge: plan {plan}")
    l0 = agg.fold_states.launches
    got = agg.fold_state_dicts(per, 1, order)
    if dev.type == "cuda" and agg.fold_states.launches - l0 != len(plan):
        raise AssertionError(f"K22 staged merge: {agg.fold_states.launches - l0} launches, "
                             f"its plan makes {len(plan)}")
    again = agg.fold_state_dicts(per, 1, order)
    for key, fields_ in (("a", ("sums",)), ("b", _K22_FIELDS), ("c", ("counts",))):
        want = agg.fold_states_plain(agg.AggState(**{f: getattr(st, f) for f in fields_}), 1,
                                     order)
        _same_state_bytes(got[key], want, f"K22 staged merge {key}")
        _same_state_bytes(again[key], want, f"K22 staged merge {key}, second run")
    done.append("staged merge, 3 keys x 700 sources, the middle one staged")
    return done


def run_mesh_region(db, tsbs: Tsbs, is_cuda: bool, reps: int = 3) -> dict:
    """Phase 10b, on phase 5's resident region on the one card: the 15
    TSBS queries (bench.py's MULTICHIP_QUERIES among them) at
    tile.mesh_devices = 1 against mesh_devices = 0, byte for byte; each
    mesh run must advance `mesh_dispatches` and K22's launches.  Warm p50
    of both settings."""
    eng = db.query_engine
    if is_cuda:
        import torch
    per_query = {}
    reset_counts()  # the mesh region's run starts here
    for name, sql in tsbs.queries():
        res, p50 = {}, {}
        for n in (0, 1):
            db.config.tile.mesh_devices = n
            times = []
            try:
                for _ in range(1 + reps):
                    m0, k0 = eng.stats.get("mesh_dispatches", 0), launch_counts()[_K22]
                    t1 = time.perf_counter()
                    out = db.sql_one(sql)
                    if is_cuda:
                        torch.cuda.synchronize()
                    times.append((time.perf_counter() - t1) * 1e3)
                    if eng.last_path != "tile":
                        raise AssertionError(f"mesh {name}: answered by the {eng.last_path!r} path")
                    meshed = eng.stats.get("mesh_dispatches", 0) - m0
                    k22 = launch_counts()[_K22] - k0
                    if n and (meshed != 1 or (is_cuda and k22 == 0)):
                        raise AssertionError(f"mesh {name}: mesh_dispatches +{meshed}, K22 +{k22}")
                    if not n and (meshed or k22):
                        raise AssertionError(f"mesh {name}: meshed at mesh_devices 0")
            finally:
                db.config.tile.mesh_devices = 0
            res[n] = _ipc_bytes(out)
            p50[n] = float(np.median(times[1:]))
        if res[0] != res[1]:
            raise AssertionError(f"mesh {name}: mesh_devices 1 differs from 0")
        per_query[name] = {"p50_ms_mesh0": p50[0], "p50_ms_mesh1": p50[1],
                           "multichip": name in MULTICHIP}
    totals, shapes = launch_counts(), shape_counts()
    merges = k22_per_merge(shapes)
    emit({"phase": "mesh", "step": "b_region", "queries": per_query,
          "k22_launches": totals[_K22], **merges})
    return {"queries": per_query, "launches": totals, "shape_launches": shapes,
            "merges": merges}


def run_mesh_slice(device: str, n_hosts: int, hours: int, reps: int, data_home: str) -> dict:
    """Phase 10c: the TSBS table as `PARTITION BY HASH (hostname)
    PARTITIONS 4` (bench.py:866-869's layout) at --hosts x --hours in a
    Database over 4 slots of the one device.  bench.py's MULTICHIP_QUERIES,
    lastpoint and groupby-orderby-limit at mesh_devices 0, 1 and 4, byte
    for byte, under agg_strategy sort, hash and auto, and the ORDER BY
    query with device finalize off too; the table-fed route over the 4
    slots against the CPU backend (sums within rel 1e-12); one TQL
    sum(rate(...)) over a 4-region counter through the 4-slot mesh
    against mesh_devices 0."""
    from greptimedb_tpu_torch import Database

    is_cuda = device.startswith("cuda")
    if is_cuda:
        import torch
    db = Database(data_home, device=[device] * MESH_SLOTS, config=device_route_config())
    eng = db.query_engine
    tsbs = Tsbs(n_hosts, hours)
    t0 = time.perf_counter()
    n_rows, _gt = ingest(db, tsbs, partitions=MESH_SLOTS)
    ingest_s = time.perf_counter() - t0
    n_regions = len(db.catalog.table("cpu", "public").region_ids)
    if n_regions != MESH_SLOTS:
        raise AssertionError(f"partitioned table has {n_regions} regions")
    queries = dict(tsbs.queries())
    names = list(MULTICHIP) + ["lastpoint", "groupby-orderby-limit"]

    def run(sql):
        t1 = time.perf_counter()
        out = db.sql_one(sql)
        if is_cuda:
            torch.cuda.synchronize()
        return out, (time.perf_counter() - t1) * 1e3

    reset_counts()  # the partitioned mesh's run starts here
    per_case = {}
    for strategy in ("sort", "hash", "auto"):
        db.config.query.agg_strategy = strategy
        for name in names:
            for topk in ((True, False) if name == "groupby-orderby-limit" else (True,)):
                db.config.query.device_topk = topk
                res, p50 = {}, {}
                for n in (0, 1, MESH_SLOTS):
                    db.config.tile.mesh_devices = n
                    times = []
                    try:
                        for _ in range(1 + reps):
                            m0, k0 = eng.stats.get("mesh_dispatches", 0), launch_counts()[_K22]
                            out, ms = run(queries[name])
                            times.append(ms)
                            if eng.last_path != "tile":
                                raise AssertionError(f"mesh {name}: the {eng.last_path!r} path")
                            meshed = eng.stats.get("mesh_dispatches", 0) - m0
                            k22 = launch_counts()[_K22] - k0
                            if bool(n) != bool(meshed) or (n and is_cuda and k22 == 0):
                                raise AssertionError(f"mesh {name} at {n}: mesh_dispatches "
                                                     f"+{meshed}, K22 +{k22}")
                    finally:
                        db.config.tile.mesh_devices = 0
                    res[n], p50[n] = _ipc_bytes(out), float(np.median(times[1:]))
                if len(set(res.values())) != 1:
                    raise AssertionError(f"mesh {name} ({strategy}, topk {topk}): mesh_devices "
                                         "0, 1 and 4 differ")
                per_case[f"{strategy}/{name}" + ("" if topk else "/no_topk")] = {
                    f"p50_ms_mesh{n}": v for n, v in p50.items()}
    db.config.query.agg_strategy = "auto"
    db.config.query.device_topk = True
    tile_launches, tile_shapes = launch_counts(), shape_counts()
    merges = k22_per_merge(tile_shapes)
    emit({"phase": "mesh", "step": "c_tile_merges", **merges})

    # one TSBS mesh query's whole merge at 4 slots, dense (sort) and keyed
    # (hash), replayed from the state dicts its run folded
    whole = {}
    for strategy in ("sort", "hash"):
        db.config.query.agg_strategy = strategy
        call = capture_merge(db, queries["double-groupby-all"], MESH_SLOTS)
        whole[strategy] = run_whole_merge_case(call, is_cuda, reps)
    db.config.query.agg_strategy = "auto"
    emit({"phase": "mesh", "step": "c_whole_merge", **whole})

    # the table-fed route over the 4 slots (tile cache off)
    db.config.query.tile_cache_enable = False
    table_fed = {}
    reset_counts()
    for name in ("double-groupby-1", "lastpoint", "high-cpu-all"):
        k0 = launch_counts()[_K22]
        got, ms = run(queries[name])
        if eng.last_path != "table" or (is_cuda and launch_counts()[_K22] == k0):
            raise AssertionError(f"table-fed {name}: path {eng.last_path!r}, K22 did not fold")
        db.config.query.backend = "cpu"
        try:
            want, cpu_ms = run(queries[name])
        finally:
            db.config.query.backend = "torch"
        rel = compare_tables(got, want, f"table-fed {name}")
        table_fed[name] = {"ms": ms, "cpu_ms": cpu_ms, "max_rel_err": rel}
    db.config.query.tile_cache_enable = True
    table_launches, table_shapes = launch_counts(), shape_counts()
    merges = {"tile": merges, "table_fed": k22_per_merge(table_shapes)}

    # TQL: a counter over 4 regions, sum(rate(...)) through the mesh
    tql = run_mesh_tql(db, n_hosts, is_cuda)
    reset_counts()
    db.close()
    out = {"rows": n_rows, "ingest_s": ingest_s, "cases": per_case, "table_fed": table_fed,
           "tql": tql, "whole_merge": whole, "merges": merges,
           "launches": {k: tile_launches[k] + table_launches[k] + tql["launches"][k]
                        for k in tile_launches},
           "shape_launches": _summed(tile_shapes, table_shapes, tql["shape_launches"])}
    emit({"phase": "mesh", "step": "c_partitioned", "rows": n_rows, "ingest_s": ingest_s,
          "cases": per_case, "table_fed": table_fed, "tql": {k: v for k, v in tql.items()
                                                            if k != "launches"},
          "k22_launches": out["launches"][_K22], "k22_per_merge": merges})
    return out


def k22_per_merge(shapes: dict[str, int]) -> dict:
    """K22's fold launches (the invert apart) against the merges that made
    them and the launches their plans make, since the counts were last set
    to 0; fails where the launches are not the planned ones."""
    from greptimedb_tpu_torch.ops import aggregate as agg

    folds = sum(v for k, v in shapes.items() if k.startswith("fold_states "))
    merges = agg.fold_states.merges
    if folds != K22_PLANNED["planned"] or folds != K22_PLANNED["made"]:
        raise AssertionError(f"K22: {folds} fold launches, {K22_PLANNED['made']} in merges, "
                             f"{K22_PLANNED['planned']} planned")
    return {"k22_fold_launches": folds, "k22_merges": merges,
            "k22_planned_launches": K22_PLANNED["planned"],
            "k22_launches_per_merge": folds / merges if merges else None}


def capture_merge(db, sql: str, slots: int):
    """Run `sql` at mesh_devices = slots and return the arguments of its
    largest K22 merge (most sources x keys): (states by source, n_local,
    order, keyword arguments)."""
    from greptimedb_tpu_torch.parallel import tile_program as tp

    seen = []
    fold = tp.fold_state_dicts

    def hook(states, n_local, order, **kw):
        seen.append((states, n_local, list(order), kw))
        return fold(states, n_local, order, **kw)

    tp.fold_state_dicts = hook
    db.config.tile.mesh_devices = slots
    try:
        db.sql_one(sql)
    finally:
        tp.fold_state_dicts = fold
        db.config.tile.mesh_devices = 0
    if not seen:
        raise AssertionError("the mesh query made no K22 merge")
    return max(seen, key=lambda c: len(c[0]) * len(c[0][0]))


def run_whole_merge_case(call, is_cuda: bool, reps: int) -> dict:
    """A captured merge through `fold_state_dicts`: twice the same bytes,
    and byte for byte `fold_states_plain` key by key; its launches, its
    time beside the one-key form's per-key loop and its bound (each input
    read once, keyed keys only their slots' occupied rows, each slot map
    once, the outputs written once)."""
    import torch

    from greptimedb_tpu_torch.ops import aggregate as agg

    states, n_local, order, kw = call
    inv, dense = kw.get("inv"), kw.get("dense_keys", ())
    dev = torch.device(kw["dev"])
    l0 = agg.fold_states.launches
    got = agg.fold_state_dicts(states, n_local, order, **kw)
    launches = agg.fold_states.launches - l0
    plan = agg.fold_launch_plan([(key, tuple(f for f in _K22_FIELDS if getattr(st, f) is not None))
                                 for key, st in states[0].items()], len(states), len(order))
    if is_cuda and launches != len(plan):
        raise AssertionError(f"whole merge: {launches} K22 launches, its plan makes {len(plan)}")
    again = agg.fold_state_dicts(states, n_local, order, **kw)
    nbytes = 0 if inv is None else inv.numel() * 4
    occupied = None if inv is None else (inv >= 0).sum(1).tolist()
    for key in states[0]:
        keyed = inv is not None and key not in dense
        want = agg.fold_states_plain(agg.stack_states([s[key] for s in states], dev), n_local,
                                     order, inv if keyed else None, kw.get("rule", "fold"))
        for name, a, b, c in zip(_K22_FIELDS, _state_tensors(got[key]), _state_tensors(again[key]),
                                 _state_tensors(want)):
            if not (_same_bytes(a, c) and _same_bytes(a, b)):
                raise AssertionError(f"whole merge {key}.{name}: K22 and its plain version differ")
            if a is None:
                continue
            rows = a.numel()
            if keyed:
                per = [occupied[m // n_local] + (rows - inv.shape[1]) for m in range(len(states))]
                nbytes += sum(per) * a.element_size()
            else:
                nbytes += len(states) * rows * a.element_size()
            nbytes += rows * a.element_size()
    b, by = bound(nbytes, 0)
    out = {"sources": len(states), "keys": len(states[0]), "keyed": inv is not None,
           "launches": launches, "bound_ms": b, "bound_by": by}
    if is_cuda:
        out["ms"] = _timed(lambda: agg.fold_state_dicts(states, n_local, order, **kw), reps)
        out["per_key_loop_ms"] = _timed(lambda: {
            key: agg.fold_states(agg.stack_states([s[key] for s in states], dev), n_local, order,
                                 inv if inv is not None and key not in dense else None,
                                 kw.get("rule", "fold"))
            for key in states[0]}, reps)
    return out


def run_mesh_tql(db, n_hosts: int, is_cuda: bool, minutes: int = 60) -> dict:
    """A Prometheus counter of `n_hosts` hosts x `minutes` at 10 s over 4
    regions; `sum(rate(...[5m]))` at mesh_devices 4 against 0, byte for
    byte (each region's K9/K10 on its slot, K11/K12 on slot 0)."""
    import pyarrow as pa

    eng = db.query_engine
    db.sql("CREATE TABLE mesh_counter (host STRING, greptime_value DOUBLE, ts TIMESTAMP(3) "
           f"TIME INDEX, PRIMARY KEY (host)) PARTITION BY HASH (host) PARTITIONS {MESH_SLOTS}")
    rng = np.random.default_rng(SEED)
    ticks = minutes * 60 // SCRAPE_S
    hosts = np.array([f"host_{i}" for i in range(n_hosts)])
    vals = np.cumsum(rng.uniform(0.0, 10.0, (ticks, n_hosts)), axis=0)
    ts = T0 + np.arange(ticks, dtype=np.int64) * SCRAPE_S * 1000
    db.write("mesh_counter", pa.table({
        "host": pa.array(np.tile(hosts, ticks)),
        "greptime_value": pa.array(vals.reshape(-1)),
        "ts": pa.array(np.repeat(ts, n_hosts), pa.timestamp("ms")),
    }))
    db.flush()
    start_s, end_s = (T0 + 10 * 60_000) // 1000, (T0 + minutes * 60_000) // 1000
    sql = f"TQL EVAL ({start_s}, {end_s}, '60s') sum(rate(mesh_counter[5m]))"
    res, ms = {}, {}
    reset_counts()
    for n in (0, MESH_SLOTS):
        db.config.tile.mesh_devices = n
        try:
            for _ in range(2):
                m0, t0 = eng.stats.get("mesh_dispatches", 0), eng.stats["tql_tile_dispatches"]
                t1 = time.perf_counter()
                out = db.sql_one(sql)
                ms[n] = (time.perf_counter() - t1) * 1e3
                if eng.stats["tql_tile_dispatches"] != t0 + 1:
                    raise AssertionError(f"TQL mesh at {n}: not the tile route")
                if eng.stats.get("mesh_dispatches", 0) - m0 != int(bool(n)):
                    raise AssertionError(f"TQL mesh at {n}: mesh_dispatches did not follow")
        finally:
            db.config.tile.mesh_devices = 0
        res[n] = _ipc_bytes(out)
    if res[0] != res[MESH_SLOTS] or out.num_rows == 0:
        raise AssertionError("TQL sum(rate) through the 4-slot mesh differs from mesh_devices 0")
    launches = launch_counts()
    if is_cuda and not all(launches[k] for k in TQL_KERNELS):
        raise AssertionError(f"TQL mesh: K9-K12 launches {launches}")
    return {"rows_out": out.num_rows, "warm_ms_mesh0": ms[0], "warm_ms_mesh4": ms[MESH_SLOTS],
            "launches": launches, "shape_launches": shape_counts()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hours", type=int, default=12)
    ap.add_argument("--hosts", type=int, default=4000)
    ap.add_argument("--reps", type=int, default=1, help="warm runs per query, table-fed path")
    ap.add_argument("--tile-reps", type=int, default=5, help="warm runs per query, tile path")
    ap.add_argument("--kernel-reps", type=int, default=10, help="timed launches per kernel")
    ap.add_argument("--tql-reps", type=int, default=5, help="warm runs per TQL query, tile path")
    ap.add_argument("--prom-sql-reps", type=int, default=3,
                    help="warm runs per SQL panel over the remote-write tables (phase 6b)")
    ap.add_argument("--container-hours", type=int, default=CM_HOURS,
                    help="hours of the container table (phase 7)")
    ap.add_argument("--container-reps", type=int, default=3,
                    help="warm runs per container query, tile path")
    ap.add_argument("--tick-reps", type=int, default=5,
                    help="dashboard ticks before and after the slide (phase 5c)")
    ap.add_argument("--vector-rows", type=int, default=SIFT_ROWS,
                    help="rows of the SIFT-shaped vector table (phase 8)")
    ap.add_argument("--vector-reps", type=int, default=2,
                    help="warm runs per vector query (phase 8)")
    ap.add_argument("--sketch-hours", type=int, default=6,
                    help="hours of the TSBS table of phase 9")
    ap.add_argument("--sketch-reps", type=int, default=0,
                    help="warm runs per sketch query (phase 9)")
    ap.add_argument("--mesh-hours", type=int, default=6,
                    help="hours of the partitioned TSBS table of phase 10c")
    ap.add_argument("--mesh-reps", type=int, default=2,
                    help="warm runs per query and mesh_devices setting (phase 10c)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "greptimedb_tpu_torch", "csrc")):
        print("chip_smoke: greptimedb_tpu_torch/ not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    sys.modules.setdefault("jax", None)  # the port must not need it

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})

    from greptimedb_tpu_torch.kernels import build_all

    t0 = time.perf_counter()
    built = build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "per_source_s": built})
    count_shapes()

    t0 = time.perf_counter()
    kstats = run_kernel_phase(args.hosts, args.hours, args.kernel_reps)
    kstats.update(run_tile_kernel_phase(args.hosts, args.hours, args.kernel_reps))
    kstats["mask_gids"]["chunk"] = kstats.pop("mask_gids_chunk")
    kstats.update(run_tql_kernel_phase(args.hosts, args.hours, args.kernel_reps))
    kstats.update(run_plane_kernel_phase(args.hosts, args.hours, args.kernel_reps))
    hstats = run_hash_kernel_phase(args.kernel_reps)
    kstats["hash_group_slots"] = hstats["hash_group_slots"]
    kstats["mask_gids"]["int64"] = hstats["mask_gids_int64"]
    kstats["segment_reduce_scatter"]["hash_slots"] = hstats["scatter_hash_slots"]
    kstats["pack_result"]["hash_slots"] = hstats["pack_hash_slots"]
    gstats = run_guard_kernel_phase(args.hosts, args.hours, args.kernel_reps)
    kstats["segment_sort"] = gstats.pop("segment_sort")
    kstats["segment_sort"]["hash_slots"] = hstats["sort_hash_slots"]
    kstats["segment_last"]["falling"] = gstats.pop("k4_falling")
    kstats["segment_reduce_blocked"]["predicated"] = {k: v for k, v in gstats.items()
                                                     if k.startswith("k2_")}
    kstats["limb_segment_sums"]["predicated"] = {k: v for k, v in gstats.items()
                                                if k.startswith("k6_")}
    emit({"phase": "kernels_checked", "seconds": time.perf_counter() - t0, **CHECK_S})

    work = os.path.join(HERE, "build", "chip_smoke")  # listed in .gitignore
    shutil.rmtree(work, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        sl = run_slice("cuda", args.hosts, args.hours, args.reps, os.path.join(work, "db"),
                       tick_reps=args.tick_reps, tile_reps=args.tile_reps)
        emit({"phase": "slice", "seconds": time.perf_counter() - t0, "rows": sl["rows"],
              "card": smi, "warm_p50_ms": {k: v["warm_p50_ms"] for k, v in sl["queries"].items()},
              "tile_warm_p50_ms": {k: v["warm_p50_ms"]
                                   for k, v in sl["tile"]["queries"].items()},
              "tile_cache": sl["tile"]["cache"], "limb_reruns": sl["tile"]["limb_reruns"],
              "host_routes_s": sl["host_routes"]["seconds"],
              "fused_ladder_s": sl["fused"]["seconds"],
              "tick": {k: v for k, v in sl["tick"].items()
                       if k not in ("ticks", "slid_ticks", "launches")},
              "live": {k: v for k, v in sl["live"].items() if k not in ("queries", "launches")}})
        import gc

        import torch

        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        tq = run_tql_slice("cuda", args.hosts, args.hours, args.tql_reps,
                           os.path.join(work, "tql"), prom_sql_reps=args.prom_sql_reps)
        emit({"phase": "tql", "seconds": time.perf_counter() - t0, "rows": tq["rows"],
              "card": smi,
              "tile_warm_p50_ms": {k: v["warm_p50_ms"] for k, v in tq["queries"].items()},
              "tile_cold_ms": {k: v["cold_ms"] for k, v in tq["queries"].items()},
              "legacy_ms": {k: v["ms"] for k, v in tq["legacy"].items()},
              "cpu_ms": {k: v["ms"] for k, v in tq["cpu"].items()},
              "twin_max_rel_err": tq["twin_max_rel_err"], "tile_cache": tq["cache"]})
        ps = tq["prom_sql"]
        emit({"phase": "prom_sql", "seconds": ps["seconds"], "card": smi,
              "cold_ms": {k: v["cold_ms"] for k, v in ps["queries"].items()},
              "warm_p50_ms": {k: v["warm_p50_ms"] for k, v in ps["queries"].items()},
              "table_fed_ms": ps["compare_ms"], "tile_cache": ps["cache"]})
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        cm = run_container_slice("cuda", args.container_hours, args.container_reps,
                                 os.path.join(work, "containers"))
        emit({"phase": "containers", "seconds": time.perf_counter() - t0, "rows": cm["rows"],
              "card": smi, "ingest_s": cm["ingest_s"],
              "warm_p50_ms": {k: v["warm_p50_ms"] for k, v in cm["queries"].items()},
              "cold_ms": {k: v["cold_ms"] for k, v in cm["queries"].items()},
              "overflow_ms": cm["overflow_ms"]})
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        vk = run_vector_kernel_phase(args.vector_rows, SIFT_DIM, args.kernel_reps)
        kstats["topk_distances"] = vk
        vs = run_vector_slice("cuda", args.vector_rows, SIFT_DIM, args.vector_reps,
                              os.path.join(work, "vectors"))
        emit({"phase": "vectors", "seconds": time.perf_counter() - t0, "rows": vs["rows"],
              "card": smi, "ingest_s": vs["ingest_s"],
              "warm_p50_ms": {k: v["warm_p50_ms"] for k, v in vs["queries"].items()},
              "cold_ms": {k: v["cold_ms"] for k, v in vs["queries"].items()},
              "k19_ms": vk["per_case"]["ms"], "ivf_ms": vs["ivf"]["ms"]})
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        skk = run_sketch_kernel_phase("cuda", args.hosts, args.sketch_hours, args.kernel_reps)
        for name, case in (("segment_hll", "hll host p=12"), ("segment_udd", "udd host B=1024")):
            kstats[name] = {"max_abs_err": 0.0, **skk["per_case"][case]}
        sks = run_sketch_slice("cuda", args.hosts, args.sketch_hours, args.sketch_reps,
                               os.path.join(work, "sketches"), skk["regs_by_host"])
        emit({"phase": "sketches", "seconds": time.perf_counter() - t0, "rows": sks["rows"],
              "card": smi, "ingest_s": sks["ingest_s"],
              "cold_ms": {k: v["cold_ms"] for k, v in sks["queries"].items()},
              "warm_p50_ms": {k: v["warm_p50_ms"] for k, v in sks["queries"].items()},
              "s5_states_ms": {k: sks["queries"]["S5"]["states"][k]
                               for k in ("cold_ms", "warm_p50_ms")},
              "kernel_ms": {k: v.get("ms") for k, v in skk["per_case"].items()},
              "two_step_ms": skk["two_step_ms"], "host_s": skk["host_s"],
              "edge": skk["edge"]})
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        mk = run_mesh_kernel_phase("cuda", args.kernel_reps, hours=CM_HOURS)
        emit({"phase": "mesh", "step": "a_kernel", "card": smi, **mk})
        kstats[_K22] = {"max_abs_err": 0.0, **mk["per_case"]["dense"], "per_case": mk["per_case"]}
        gc.collect()
        torch.cuda.empty_cache()
        mc = run_mesh_slice("cuda", args.hosts, args.mesh_hours, args.mesh_reps,
                            os.path.join(work, "mesh"))
        emit({"phase": "mesh", "seconds": time.perf_counter() - t0, "card": smi,
              "rows": mc["rows"], "ingest_s": mc["ingest_s"],
              "region_p50_ms": sl["mesh"]["queries"],
              "k22_launches": {"region": sl["mesh"]["launches"][_K22],
                               "partitioned": mc["launches"][_K22]}})
    finally:
        shutil.rmtree(work, ignore_errors=True)

    from greptimedb_tpu_torch.ops import aggregate as agg

    kernels = []
    tick = sl["tick"]
    # B19: the tick program, one CUDA graph replay per tick (phase 5c); its
    # bound is its members' traffic (every source read once per member,
    # the slab written once) at the memory rate
    b19_bound, b19_by = bound(tick["bytes_moved"], 0)
    kernels.append({
        "name": "tick_program", "route": "cuda",
        "source": "greptimedb_tpu_torch/parallel/tile_program.py",
        "replaces": "greptimedb_tpu/parallel/tile_cache.py:3325",
        "launches": tick["replays"], "max_abs_err": 0.0, "ms": tick["replay_p50_ms"],
        "plain_ms": tick["plain_ms"], "bound_ms": b19_bound, "bound_by": b19_by,
        "library_ms": None, "members": tick["members"], "capture_ms": tick["capture_ms"],
        "pool_bytes": tick["pool_bytes"], "readback_bytes": tick["readback_bytes"],
        "hash_tick_replays": sum(1 for _t in cm["tick"]["ticks"]),
    })
    if tick["replays"] == 0:
        raise AssertionError("the tick program never ran on the dashboard tick (phase 5c)")
    for name in HASH_PATH:
        if cm["launches"][name] == 0:
            raise AssertionError(f"kernel {name} never launched on the hash path (phase 7)")
    for name, (_fn, source, replaces) in kernel_table().items():
        s = kstats[name]
        if name == _K22:
            # K22: its launches on phase 10's mesh runs (the resident region
            # at mesh_devices 1, the partitioned table at 1 and 4 slots and
            # its table-fed route); the dense case is the line's
            launches = sl["mesh"]["launches"][name] + mc["launches"][name]
            if sl["mesh"]["launches"][name] == 0 or mc["launches"][name] == 0:
                raise AssertionError("kernel fold_states never launched on a mesh run")
            kernels.append({
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": 0.0, "ms": s["ms"],
                "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"], "bound_by": s["bound_by"],
                "library_ms": s["library_ms"], "sources": s["sources"], "rows": s["rows"],
                "per_case": dict(s["per_case"], whole_merge=mc["whole_merge"]),
                "launches_by_shape": by_shape(_summed(sl["mesh"]["shape_launches"],
                                                      mc["shape_launches"]), name),
                "per_merge": {"region": sl["mesh"]["merges"], "partitioned": mc["merges"]},
            })
            continue
        if name in ("segment_hll", "segment_udd"):
            # K20/K21: their launches on phase 9's two-step path
            launches = skk["launches"][name]
            if launches == 0:
                raise AssertionError(f"kernel {name} never launched on the sketch path")
            kernels.append({
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, **s, "rows": skk["rows"],
                "per_case": {k: v for k, v in skk["per_case"].items()
                             if k.startswith(name[8:])},
            })
            continue
        if name == "topk_distances":
            from greptimedb_tpu_torch.ops.vector import topk_launch_plan

            # K19: its launches on phase 8's vector queries, one per run
            launches = vs["launches"][name]
            if launches == 0:
                raise AssertionError("kernel topk_distances never launched on the vector path")
            kernels.append({
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"], "bound_by": s["bound_by"],
                "library_ms": s["library_ms"], "rows": s["rows"], "dim": s["dim"],
                "per_case": s["per_case"], "large_k": s["large_k"],
                "launch_plan": {f"k={k}": topk_launch_plan(k) for k in (*VECTOR_KS, 10_000)},
            })
            continue
        if name == "hash_group_slots":
            # K17: its launches on phase 7's H1-H4
            kernels.append({
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": cm["launches"][name], "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"], "bound_by": s["bound_by"],
                "library_ms": s["library_ms"],
                **{k: s[k] for k in ("rows", "slots", "rounds", "occupied", "fill_ms", "device_us")},
                **per_call(cm["k17_calls"], K17_KERNELS, name),
            })
            continue
        if name in TQL_KERNELS:
            # K9-K12: their launches on the TQL tile path (phase 6); K9-K11
            # also on the TQL legacy path (its own runs only)
            launches = tq["launches"][name]
            if launches == 0 or (name != _FOLD and tq["legacy_launches"][name] == 0):
                raise AssertionError(f"kernel {name} never launched on its path")
            kernels.append({
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"], "bound_by": s["bound_by"],
                "library_ms": s["library_ms"], "legacy_launches": tq["legacy_launches"][name],
                **{k: s[k] for k in ("k64", "by_series", "form", "tw", "grid", "cells_ms",
                                     "staged_ms", "order_sensitive", "device_us", "ms_range")
                   if k in s},
                **(per_call(tq["k9_calls"], K9_KERNELS, name) if name == _STRIP else {}),
                **({"launches_by_tw": by_shape(tq["shape_launches"], name)}
                   if name == _FOLD else {}),
                **({"launches_by_k": by_shape(tq["shape_launches"], name),
                    "legacy_launches_by_k": by_shape(tq["legacy_shape_launches"], name)}
                   if name == _WIN else {}),
            })
            continue
        if name in PLANE_KERNELS:
            # K13-K16: their launches on the tile path (phase 5: K14, K15
            # gather) and on the live phase (5b: K13, K15 remap, K16)
            tile_launches = sl["tile"]["launches"][name]
            live_launches = sl["live"]["launches"][name]
            counted = {"tile": tile_launches, "live": live_launches}
            if any(counted[phase] == 0 for phase in PLANE_PHASES[name]):
                raise AssertionError(f"kernel {name} never launched on its path: {counted}")
            kernels.append({
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": tile_launches + live_launches, "max_abs_err": s["max_abs_err"],
                "ms": s["ms"], "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                "bound_by": s["bound_by"], "library_ms": s["library_ms"],
                "tile_launches": tile_launches, "live_launches": live_launches,
                **{k: s[k] for k in ("remap", "multi", "passes", "key_bytes", "sort_launches",
                                     "jittered", "groups", "ms_range", "live", "per_plane")
                   if k in s},
                # K13: its calls by G on the live phase's HAVING queries
                **({"launches_by_groups": {"live": by_shape(sl["live"]["shape_launches"], name)}}
                   if name == _HAVING else {}),
                # K15's gathers: one multi-plane call a time-major build, its
                # launches as its plan makes them (tile phase, live phase)
                **({"gather_calls": {"tile": sl["tile"]["k15_calls"],
                                     "live": sl["live"]["k15_calls"]}} if name == _GATHER else {}),
            })
            continue
        # K1-K4: their launches on the table-fed path (phase 4); K1-K8: on
        # the tile path (phase 5), K3's from the tile edge query with the
        # time_major pass off (the TSBS queries no longer fail K2's guard)
        tile_launches = sl["tile"]["launches"][name]
        tile_shapes = sl["tile"]["shape_launches"]
        if name == _SCATTER:
            tile_launches = sl["tile"]["edge_launches"][name]
            tile_shapes = sl["tile"]["edge_shape_launches"]
        launches = tile_launches if name in TILE_KERNELS else sl["launches"][name]
        if launches == 0 or tile_launches == 0:
            raise AssertionError(f"kernel {name} never launched on its path")
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"], "bound_by": s["bound_by"],
            "library_ms": s["library_ms"], "tile_launches": tile_launches,
            "hash_launches": cm["launches"][name],
            "tick_launches": tick["launches"][name],
            **({"tile_launches_by_c": by_shape(tile_shapes, name)}
               if name in (_BLOCKED, _SCATTER, _LIMB) else {}),
            **({"launches_by_rows": {
                "table_fed": by_shape(sl["shape_launches"], name),
                "tile": by_shape(sl["tile"]["shape_launches"], name),
                "tick": by_shape(tick["shape_launches"], name),
                "hash": by_shape(cm["shape_launches"], name)}} if name in (_SORT, _MASK) else {}),
            # K1's rank: its tile launches x (ms - bound ms) at each chunk
            # shape, split into the kernel's part (device ms - bound ms) and
            # the host's (ms - device ms)
            **(_k1_figures(s["chunk"], by_shape(sl["tile"]["shape_launches"], name))
               if name == _MASK else {}),
            **(_k1_figures(s["chunk"], by_shape(sl["tile"]["shape_launches"], name), "upload")
               if name == _MASK else {}),
            # K7: its calls by G on the tile path, the ticks and the live
            # phase (its HAVING queries)
            **({"launches_by_groups": {
                "tile": by_shape(sl["tile"]["shape_launches"], name),
                "tick": by_shape(tick["shape_launches"], name),
                "live": by_shape(sl["live"]["shape_launches"], name)},
                "launch_plans": {f"G={g} cap={cap} keys={n}": agg.topk_launch_plan(g, cap, n)
                                 for g, cap, n in ((768, 5, 1), (SELECT_CARD * SELECT_BUCKETS, 10, 1),
                                                   (4096, 4096, 0))}}
               if name == _TOPK else {}),
            **{k: s[k] for k in ("alone_ms", "c1", "c5", "guard_fail", "compact", "int64", "chunk",
                                 "ms_range", "enqueue_us", "device_us", "live", "select_stage",
                                 "groups", "cap",
                                 "hash_slots", "predicated", "falling", "passes", "key_bytes",
                                 "sort_launches")
               if k in s},
            **({"calls": sl["tile"]["k8_calls"]["calls"],
                "planned_launches": sl["tile"]["k8_calls"]["planned"],
                "launches_per_call": sl["tile"]["k8_calls"]["made"]
                / max(sl["tile"]["k8_calls"]["calls"], 1)}
               if name == _PACK else {}),
        })
    # phase 6b: each kernel's launches on the SQL panels over the
    # remote-write tables (the keep plane, window tiles, the corrected write)
    prom_sql_kernels = set().union(*EXPECTED_PROM_SQL_PATH.values()) \
        if EXPECTED_PROM_SQL_PATH is not None and tq["full_size"] else set()
    for k in kernels:
        k["prom_sql_launches"] = tq["prom_sql"]["launches"].get(k["name"], 0)
        # phase 5d: the host routes' runs (the card's queries among them)
        k["host_routes_launches"] = sl["host_routes"]["launches"].get(k["name"], 0)
        # phase 5e: the fused build's builder (first touch to drain) and
        # the warm runs, and the TQL first touch's tile run after its drain
        k["fused_ladder_launches"] = sl["fused"]["launches"].get(k["name"], 0)
        k["fused_builder_launches"] = sl["fused"]["builder_launches"].get(k["name"], 0)
        k["tql_first_touch_launches"] = tq["first_touch"]["launches"].get(k["name"], 0)
        if k["name"] in prom_sql_kernels and k["prom_sql_launches"] == 0:
            raise AssertionError(f"kernel {k['name']} never launched on phase 6b")
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
