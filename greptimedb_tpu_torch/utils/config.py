"""Configuration for the port: storage, query and the device.

Counterpart of `greptimedb_tpu/utils/config.py`, reduced to the sections
the port runs (`Config`, `StorageConfig`, `QueryConfig`, `TileConfig`,
`TqlConfig`).  Differences
that matter:

* `QueryConfig.device` names the torch device the lowered query path runs on
  (`"cuda"` by default, `"cpu"` for the tests).  Nothing probes for a
  card to pick one: `Database(device="cuda")` without a card raises.
  A tuple there lists the slots of the multi-device mesh
  (`Database(device=[...])`, a device may repeat); `slots` and
  `first_device` read it either way.
* `QueryConfig.backend` is `"torch"` (the lowered device path) or `"cpu"`
  (the authoritative Arrow executor).
* There is no `fallback_to_cpu`: a device-path failure raises instead of
  being served silently from the CPU executor.
* The tile-cache knobs (`tile_cache_enable` .. `agg_hash_min_group_space`)
  and the dense bounds (`max_groups`, `max_internal_groups`) are the
  reference's, at the configuration the port implements: the passes it
  has not ported do not exist (`query/passes.py`) and behave as disabled.
  `agg_strategy` is "auto" (hash or sort per query), "hash" or "sort",
  as in the reference; `tpu_min_rows` is the `cost_route` threshold (0,
  the default, turns it off).  Persistence of super-tiles, the streamed
  spill has no knobs here.
* `BatchConfig` is the reference's `batch` section: the dashboard batch
  tick (parallel/batcher.py) and the windowed result cache, off by
  default.
* `TileConfig` holds `incremental` (delta maintenance of the planes on
  flush), `mesh_devices` (multi-device tile execution) and `fused_build`
  (the fused family build and the cold serve's fused ladder, on by
  default as in the reference); the prewarm knobs (`prewarm_on_flush`,
  `prewarm_tables`, `prewarm_limbs`: an explicit `Database.prewarm()`
  always quantizes), `fused_build_timeout_s` and the pipelined build are
  not ported.  `Config.validate()` checks `mesh_devices` against the
  listed slots, as the reference checks it against the local devices.

The TOML/env layering, the other sections and the JAX probe are cut
(listed in ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass
class StorageConfig:
    data_home: str = "./greptimedb_data"
    wal_dir: str = ""  # defaults to {data_home}/wal
    sst_dir: str = ""  # defaults to {data_home}/data
    manifest_checkpoint_distance: int = 10
    write_buffer_size_mb: int = 64
    global_write_buffer_size_mb: int = 512
    memtable_time_partition_secs: int = 86400
    memtable_kind: str = "time_partition"
    wal_fsync: bool = False
    ingest_flush_workers: int = 2

    def effective_wal_dir(self) -> str:
        return self.wal_dir or os.path.join(self.data_home, "wal")

    def effective_sst_dir(self) -> str:
        return self.sst_dir or os.path.join(self.data_home, "data")


@dataclasses.dataclass
class QueryConfig:
    backend: str = "torch"  # "torch" = lowered device path, "cpu" = Arrow executor
    # the torch device the lowered path runs on, or a tuple of them: the
    # mesh slots (parallel/mesh.py), a device possibly filling several
    device: str | tuple = "cuda"
    # dense [G] bounds of the tile path: a sort plan runs when its output
    # group space is at most max_groups * 64 and its stage-1 (hierarchical)
    # space at most max_internal_groups; the hash slot table is capped at
    # max_internal_groups (its largest contained power of two)
    max_groups: int = 1 << 16
    max_internal_groups: int = 1 << 24
    # device-resident super-tiles (parallel/tile_planes.py): warm queries
    # run over planes cached on the card instead of rescanning Parquet
    tile_cache_enable: bool = True
    tile_cache_mb: int = 8192
    # rows per device chunk (a multiple of the 4096-row kernel block)
    tile_chunk_rows: int = 1 << 24
    # sum/avg accumulation on the tile path: "limb" (K5/K6 fixed-point
    # digits, a per-group error bound, exact f64 rerun when it fails) or
    # "float64" (K2/K3 directly)
    tile_acc_dtype: str = "limb"
    # Sort/LIMIT and empty-group compaction on the card (K7), so the one
    # readback is O(rows_out); False ships the whole [G] result
    device_topk: bool = True
    # named passes of query/passes.py to switch off
    disabled_passes: tuple = ()
    # device group-by strategy (the `agg_strategy` pass,
    # parallel/tile_planner.py): "auto" picks per query between the dense
    # mixed-radix states ("sort") and a slot table sized to the distinct
    # keys ("hash", K17), from the tag dictionaries against the padded
    # group space; "sort" and "hash" force one
    agg_strategy: str = "auto"
    # auto considers hash only when the padded group space is at least
    # this large: below it dense [G] states are trivially cheap
    agg_hash_min_group_space: int = 1 << 16
    # cost-based routing (the `cost_route` pass): a lowerable plan whose
    # row estimate falls below this runs on the CPU executor while no
    # super-tile of its table is resident; 0 turns the routing off
    tpu_min_rows: int = 0

    def __post_init__(self):
        self.validate()

    @property
    def slots(self) -> tuple[str, ...]:
        """The mesh slots: each listed device, or the one `device`."""
        return tuple(self.device) if isinstance(self.device, (list, tuple)) else (self.device,)

    @property
    def first_device(self) -> str:
        """The first slot, where single-device work runs."""
        return self.slots[0]

    def validate(self) -> None:
        from .errors import ConfigError

        if self.agg_strategy not in ("auto", "hash", "sort"):
            raise ConfigError(
                "query.agg_strategy must be 'auto', 'hash' or 'sort' (the "
                "device group-by strategy; 'sort' forces the dense path); "
                f"got {self.agg_strategy!r}"
            )
        if self.agg_hash_min_group_space < 1024:
            raise ConfigError(
                "query.agg_hash_min_group_space must be >= 1024 groups (below "
                "that the dense path is always cheaper than a hash table); "
                f"got {self.agg_hash_min_group_space!r}"
            )
        if not isinstance(self.tpu_min_rows, int) or self.tpu_min_rows < 0:
            raise ConfigError(
                "query.tpu_min_rows must be an int >= 0 (0 turns cost-based "
                f"routing off); got {self.tpu_min_rows!r}"
            )
        if self.tile_acc_dtype not in ("limb", "float64"):
            raise ConfigError(
                f"query.tile_acc_dtype={self.tile_acc_dtype!r}: use 'limb' or 'float64'"
            )
        if self.tile_chunk_rows <= 0 or self.tile_chunk_rows % 4096:
            raise ConfigError(
                f"query.tile_chunk_rows={self.tile_chunk_rows}: a positive "
                "multiple of 4096"
            )


@dataclasses.dataclass
class TileConfig:
    """Super-tile lifecycle: what happens to the resident planes when the
    region's files change."""

    # Incremental (delta) super-tile maintenance: when a flush APPENDS
    # files to a region's set, merge only the new rows into the existing
    # entry — delta encode, merge of two sorted runs (not a re-sort),
    # on-device patch of resident planes (K16) — so post-flush cold cost
    # is O(delta rows), not O(total rows).  Off restores the
    # invalidate-and-rebuild-from-scratch path bit-for-bit.
    incremental: bool = True
    # Multi-device tile execution (parallel/tile_program.py `mesh_run`):
    # N > 0 runs a query's chunk sources over the first N mesh slots —
    # each slot computes its sources' partial states on its device, the
    # partials gather on the first slot and fold there (K22: counts add,
    # min/max take order statistics, float sums and LAST fold in global
    # source order), and device finalize runs once after the fold, so the
    # result is byte-identical for any N and for 0.  0 (the default) is
    # the single-device dispatch.  Values above the listed slots are
    # rejected by `Config.validate`.  Unlike the reference, a failure in
    # the mesh run raises instead of degrading to the single device.
    mesh_devices: int = 0
    # Fused family builds (parallel/tile_executor.py, the `fused_build`
    # pass): a NEW query family answers from the host consolidation at
    # once (the cold serve's fused ladder: every grouped family, last_value
    # and group spaces past 2^22 included) while one background build —
    # the union of the table's plane manifests: each SST decoded once,
    # each column encoded once, one upload of the union's full planes —
    # warms the device planes, then a ghost run of each family primes its
    # path; a query of a family whose build is in flight waits for it.
    # False restores the legacy ladder: a cold serve at most once per
    # entry, the device planes built on the next touch, no builder thread.
    fused_build: bool = True

    def validate(self, slots: int | None = None) -> None:
        """`slots`: the number of mesh slots the device list holds."""
        from .errors import ConfigError

        if not isinstance(self.fused_build, bool):
            raise ConfigError(
                "tile.fused_build must be a boolean (fused one-pass family "
                f"cold builds + universal cold-serve); got {self.fused_build!r}"
            )
        n = self.mesh_devices
        if not isinstance(n, int) or isinstance(n, bool):
            raise ConfigError(
                "tile.mesh_devices must be an integer device count "
                f"(0 = single-device dispatch); got {n!r}"
            )
        if n < 0:
            raise ConfigError(
                "tile.mesh_devices must be >= 0 devices (0 = single-device "
                f"dispatch, N = shard over the first N slots); got {n!r}"
            )
        if slots is not None and n > slots:
            raise ConfigError(
                f"tile.mesh_devices ({n}) exceeds the {slots} listed device "
                "slot(s): the regions mesh cannot be built; lower it or list "
                "more devices (Database(device=[...]))"
            )


@dataclasses.dataclass
class TqlConfig:
    """The warm TQL path (query/promql/tile_exec.py, the `tql_tile` pass):
    PromQL range-vector evaluation — rate/increase/delta, *_over_time and
    the by-label sum/avg/min/max/count fold — as one program (K9-K12)
    over the resident super-tile planes.  `tile = False` evaluates every
    query on the legacy path (region scan, upload, K9-K11, host folds).
    Unlike the reference, a failure on the tile path raises: only shape
    declines (memtable rows in the window, `max_cells`, last_non_null
    merge mode, an empty grid) go to the legacy path."""

    tile: bool = True
    # Upper bound on padded series x padded steps cells per evaluation
    # ([S, W] window statistics live on the card); beyond it the query
    # takes the legacy path.
    max_cells: int = 1 << 22
    # Per-series results larger than this fetch in two round-trips:
    # presence first, then a gather of only the present rows on the card.
    compact_readback_kb: int = 1024


@dataclasses.dataclass
class BatchConfig:
    """Cross-query device batching + windowed result cache
    (parallel/batcher.py, hooked into the tile executor).  Everything here
    defaults off-safe: with `window_ms = 0` and `result_cache_mb = 0`
    every query runs the solo path bit for bit.

    Warm queries against the same table that arrive within `window_ms`
    of each other form one tick: with `fuse_programs` the members'
    programs run as one CUDA graph (one replay, one readback); without
    it, back to back with one shared readback.  Members share the
    readback, never each other's math, so results are byte-identical to
    solo runs; a member whose result carries a rerun verdict (limb bound,
    hash overflow) runs solo."""

    # Batching window: a warm query waits up to this long for peers to
    # join its tick.  0 disables batching entirely.
    window_ms: float = 0.0
    # Most members one tick may carry; arrivals past the cap start the
    # next tick rather than queueing behind this one.
    max_members: int = 16
    # Windowed result cache budget.  Keyed on (literal-insensitive plan
    # fingerprint, filter-literal digest, bucket-aligned time window,
    # per-region manifest version + WAL tail id) so a sliding dashboard
    # re-serves with no dispatch.  0 disables the cache.
    result_cache_mb: int = 0
    # The tick's members as one CUDA graph (B19), keyed on the multiset of
    # their program keys; literals and bucket geometry ride in device
    # buffers, so a slid window replays with no recapture.  False runs
    # the members back to back with one shared readback.
    fuse_programs: bool = True

    def validate(self) -> None:
        from .errors import ConfigError

        if self.window_ms < 0:
            raise ConfigError(
                "batch.window_ms must be >= 0 milliseconds (0 disables "
                f"cross-query batching); got {self.window_ms!r}"
            )
        if self.max_members < 2:
            raise ConfigError(
                "batch.max_members must be >= 2 queries per tick — a one-member "
                "batch is just a solo dispatch with extra latency; got "
                f"{self.max_members!r}"
            )
        if self.result_cache_mb < 0:
            raise ConfigError(
                "batch.result_cache_mb must be >= 0 MB (0 disables the windowed "
                f"result cache); got {self.result_cache_mb!r}"
            )
        if not isinstance(self.fuse_programs, bool):
            raise ConfigError(
                "batch.fuse_programs must be a boolean (run a tick's member "
                f"programs as one CUDA graph); got {self.fuse_programs!r}"
            )


@dataclasses.dataclass
class Config:
    storage: StorageConfig = dataclasses.field(default_factory=StorageConfig)
    query: QueryConfig = dataclasses.field(default_factory=QueryConfig)
    tql: TqlConfig = dataclasses.field(default_factory=TqlConfig)
    tile: TileConfig = dataclasses.field(default_factory=TileConfig)
    batch: BatchConfig = dataclasses.field(default_factory=BatchConfig)

    def validate(self) -> None:
        self.query.validate()
        self.tile.validate(len(self.query.slots))
        self.batch.validate()
