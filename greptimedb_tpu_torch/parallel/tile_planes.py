"""Device-resident per-region super-tiles: the tile cache's planes.

Counterpart of the cache half of `greptimedb_tpu/parallel/tile_cache.py`
(`TileContext`, `_FileHostTiles`, `_SuperTiles`, `TileCacheManager`,
`ensure_limbs`, `ensure_perm`, `ensure_time_major`, `repair_super`,
`_delta_extend`, `_lex_merge_positions`, `_entry_device_bytes`,
`_encode_host_tiles`; `_chunk_bounds` is `ops/tiles.py::chunk_bounds`).  Each region's flushed SSTs are
encoded once — tag strings to stable per-table dictionary codes
(storage/dictionary.py), timestamps to int64, values to float — globally
re-sorted by (pk..., ts) so primary-key runs stay long and the blocked
kernels (K2, K6) see the layout they want, padded, cut into chunks of
`tile_chunk_rows` (2^24) rows and uploaded to the card: the
"super-tile".  A warm query then skips the Parquet rescan, the encode
and the upload.  Host-side per-file encodes are cached too.

Keeping the planes current, as the reference does at its defaults:

* a flush that APPENDS files extends the entry in place
  (`_delta_extend`, the `incremental_tile` pass, `tile.incremental`):
  only the new files are host-encoded, their (pk, ts)-sorted run is
  merged into the cached order by binary search
  (`_lex_merge_positions`, ties to the old run, so the result is the
  stable lexsort a rebuild computes), and every resident plane is
  patched on the card by K16 (`ops/permute.py::delta_patch`), reading
  the old chunks through a chunk table.  Re-derivable planes (time-major
  copies, the permutation, limb planes, the dedup keep plane) are dropped
  and rebuild lazily.  Any other change of the file set (a removal) drops
  the entry and the next query rebuilds it; a failing patch raises (the
  reference's catch-all that rebuilds instead is not carried over);
* a dictionary growth that moved codes is repaired in place
  (`repair_super`): one K15 remap per stale tag code plane on the card,
  a numpy gather over the sorted host copies.  Unlike the reference, a
  tag's time-major copy is dropped only when its codes moved;
* time-major plans (bucket-only group-bys) read ts-ascending copies of
  the planes they need: the stable ts permutation is sorted on the card
  once per file set (K14, `ensure_perm`) and each copy gathered once
  (K15, `ensure_time_major`); limb planes are quantized over the copies
  (`ensure_limbs(..., time_major=True)`, keyed "tm:<column>");
* limb planes (K5) are cached per column and evicted first under budget
  pressure, then whole entries;
* the dedup keep plane (`ensure_dedup_keep`, the `dedup_plane` pass):
  the last-write-wins keep mask of a non-append region whose SSTs
  overlap, built on the host from the sorted host copies of the
  (pk..., ts) columns kept beside each entry (`keep_host`), then
  uploaded; the SQL and TQL tile paths read it in place of the valid
  plane, and time-major plans read its ts-ascending copy
  (`tm_valid_dedup`, gathered in the same K15 launch as the other
  copies);
* window tiles (`ensure_window_tile`, the `window_tile` pass; reference
  `tile_cache.py:2310-2575`): a compact tile of the rows inside one
  query window (and surviving the keep plane), gathered on the host from
  the sorted host copies or the per-file encodes, padded with zeros to a
  2^22-row grid, uploaded in chunks of that size (K5 quantizes its limb
  columns), keyed by (wlo, whi, dedup) beside the entry and extended
  with the columns a wider query adds;
* the fold CSRs of the fused TQL aggregations (`group_csr`), kept per
  (radices, kept tags);
* chunk placement (the `chunk_placement` pass; reference
  `tile_cache.py:1172-1260`): with several device slots an entry's chunk
  i goes to slot (base + i) % n, decided once per entry when its valid
  plane uploads — base 0 over every slot with the mesh off, base
  `region_device_index(region, mesh_devices)` over the mesh's slots with
  it on, every chunk on slot 0 with the pass disabled.  The entry keeps
  that rule (`_SuperTiles.placement`), so its sources are keyed to slots
  by index, never by device identity (one device may fill several
  slots).  Time-major copies and memtable tails live on slot 0, as in
  the reference;
* the fused family build (`fused_union_build`, the `fused_build` pass;
  reference `tile_cache.py:2706-2856`): the plane manifests of a table's
  query families (`PlaneManifest`, a ring of 64 a table,
  `record_manifest`) are unioned into one build a region — the host
  consolidation first, then the keep plane, one upload of the union's
  full-plane columns, K5, the time-major copies (K14, K15) and each
  window's tile — under `build_gate`, which makes concurrent builders of
  a table wait for the leader's build;
* not ported: persistence of consolidated encodes, the pipelined build.
  Limb-only columns keep their f64 plane (the reference skips that
  upload).

Padding keeps the port's rule (`ops/tiles.py::pad_rows`, a multiple of
4096, not the reference's next power of two); chunks are cut at the same
2^24-row bounds, so the rows and 4096-row blocks of every chunk are the
reference's and partials merge in the same order.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import torch

from ..ops.aggregate import BLOCK_ROWS, _FAST_MIN_ROWS, quantize_limbs
from ..ops.permute import delta_patch, gather_planes, gather_planes_multi, ts_argsort
from ..ops.rate import group_csr
from ..ops.tiles import chunk_bounds, pad_rows
from ..query import passes
from ..storage.dictionary import TableDictionary
from ..storage.region import Region
from ..storage.sst import FileMeta
from .mesh import make_mesh, region_device_index

TILE_CHUNK_ROWS = 1 << 24


def _lex_merge_positions(old_keys: list[np.ndarray], new_keys: list[np.ndarray]) -> np.ndarray:
    """Merge positions of two lexicographically sorted runs: for each row
    of the (sorted) delta run, the number of old-run rows that precede it
    in the merged order.  Ties place the old run first (side='right'),
    which is flush order, so merging with these positions gives the
    stable lexsort of the full concatenation a rebuild performs.  Keys
    are listed major-first.  A vectorized binary search over the old run:
    O(delta * keys * log old), no re-sort of the whole."""
    n_old = len(old_keys[0]) if old_keys else 0
    n_new = len(new_keys[0]) if new_keys else 0
    if n_new == 0:
        return np.zeros(0, np.int64)
    lo = np.zeros(n_new, np.int64)
    if n_old == 0:
        return lo
    hi = np.full(n_new, n_old, np.int64)
    while True:
        active = lo < hi
        if not active.any():
            break
        mid = (lo + hi) >> 1
        # settled lanes (lo == hi) may sit at n_old: clip the index, their
        # comparison is discarded by `active`
        safe = np.minimum(mid, n_old - 1)
        # lexicographic old[mid] <= new: ties fall through to the next key
        gt = np.zeros(n_new, bool)
        decided = np.zeros(n_new, bool)
        for a, b in zip(old_keys, new_keys):
            av = a[safe]
            lt_k = ~decided & (av < b)
            gt_k = ~decided & (av > b)
            gt |= gt_k
            decided |= lt_k | gt_k
        le = ~gt
        lo = np.where(active & le, mid + 1, lo)
        hi = np.where(active & ~le, mid, hi)
    return lo


@dataclass
class TileContext:
    """What the Database hands the tile executor for one table scan."""

    table_key: str
    dictionary: TableDictionary
    regions: list[Region]
    append_mode: bool = False


@dataclass
class _FileHostTiles:
    """Host-side encoded columns of one SST file (the build cache the
    super-tile consolidates from).  `absent` lists value columns the file
    predates; consolidation NULL-fills them."""

    cols: dict[str, np.ndarray] = field(default_factory=dict)
    nulls: dict[str, np.ndarray] = field(default_factory=dict)
    epochs: dict[str, int] = field(default_factory=dict)
    absent: set[str] = field(default_factory=set)
    num_rows: int = 0
    nbytes: int = 0


@dataclass
class _SuperTiles:
    """One region's consolidated device planes, rows in (pk..., ts) order,
    stored as lists of chunk tensors."""

    region_id: int
    file_ids: tuple[str, ...]
    num_rows: int  # real rows (sum of file rows)
    pad: int  # padded total length (a multiple of 4096)
    order: np.ndarray | None = None  # (pk, ts) sort of the file concat
    # the (pk..., ts) columns in `order`, on the host (the keep plane's,
    # the delta merge's and the host routes' input), and the dictionary
    # epoch of their codes
    sorted_host: dict[str, np.ndarray] = field(default_factory=dict)
    host_epochs: dict[str, int] = field(default_factory=dict)
    # the first row of each file in the concatenation `order` indexes
    # (len(file_ids) + 1 offsets): the host routes' value gathers
    file_row_offsets: np.ndarray | None = None
    # the cold serve answered from the host consolidation once: the next
    # grouped query builds device planes (parallel/tile_host.py)
    cold_served: bool = False
    cols: dict[str, list] = field(default_factory=dict)
    nulls: dict[str, list] = field(default_factory=dict)
    epochs: dict[str, int] = field(default_factory=dict)  # tag col -> dict epoch
    valid: list | None = None
    # last-write-wins keep plane (valid and not superseded): its host
    # copy over the real rows in (pk, ts) order, the device plane per
    # chunk, and its ts-ascending copy for time-major plans
    keep_host: np.ndarray | None = None
    valid_dedup: list | None = None
    tm_valid_dedup: list | None = None
    # the stable ts-ascending permutation (K14), int32 [pad], and the
    # time-major copies gathered through it (K15), per chunk
    perm: torch.Tensor | None = None
    tm_cols: dict[str, list] = field(default_factory=dict)
    tm_nulls: dict[str, list] = field(default_factory=dict)
    tm_valid: list | None = None
    # cached K5 planes per value column, keyed "" | "tm:" + column for the
    # two row orders: per chunk (limbs, scale)
    limb_cols: dict[str, list] = field(default_factory=dict)
    # window tiles by (wlo, whi, dedup): dicts of "cols" and "limbs" (name
    # -> per-chunk planes; a nullable column declines the tile), "valid",
    # "rows", "epoch" (the dictionary epoch of their codes), "placement"
    # and "nbytes"
    window_tiles: dict[tuple, dict] = field(default_factory=dict)
    # window keys whose rows were none or more than the cover allows: the
    # answer holds while the file set does
    window_declines: set = field(default_factory=set)
    nbytes: int = 0
    # host bytes held beside the host encode cache (the keep plane's host
    # copy), counted in the cache's host bytes
    host_nbytes: int = 0
    # in-place delta merges absorbed since the entry was built
    delta_extends: int = 0
    # chunk placement: chunk i lives on mesh slot (base + i) % modulus,
    # decided when the first device plane (valid, or the keep plane of a
    # host-only entry) uploads (TileCacheManager.placement)
    placement: tuple[int, int] = (0, 1)

    def chunk_slot(self, i: int) -> int:
        base, modulus = self.placement
        return (base + i) % modulus


@dataclass(frozen=True)
class PlaneManifest:
    """One query family's (or a prewarm's) device-plane requirements: the
    unit the fused build unions.  Each family's first touch records one;
    `fused_union_build` builds the union of a table's manifests in one
    pass, so each SST file is decoded once and each column encoded and
    uploaded once for the whole family."""

    table_key: str
    tag_cols: tuple = ()  # tag code planes (group, filter and layout tags)
    ts_col: str | None = None
    value_cols: tuple = ()  # f64 value planes (or window-tile columns)
    limb_cols: tuple = ()  # K5 limb planes (sum/avg columns)
    time_major: bool = False  # ts-ascending copies and the permutation
    window: tuple | None = None  # (lo, hi): a window tile's geometry
    dedup: bool = False  # the last-write-wins keep plane


def _nbytes(chunks) -> int:
    return sum(int(x.numel()) * x.element_size() for x in chunks)


def _limb_nbytes(chunks) -> int:
    return sum(_nbytes((lb, s)) for lb, s in chunks)


def _entry_device_bytes(entry: _SuperTiles) -> int:
    """An entry's resident device bytes, recomputed from its live planes
    (the delta merge swaps whole plane sets)."""
    total = 0
    for d in (entry.cols, entry.nulls, entry.tm_cols, entry.tm_nulls):
        for chunks in d.values():
            total += _nbytes(chunks)
    for planes in (entry.valid, entry.valid_dedup, entry.tm_valid, entry.tm_valid_dedup):
        if planes is not None:
            total += _nbytes(planes)
    if entry.perm is not None:
        total += _nbytes((entry.perm,))
    for chunks in entry.limb_cols.values():
        total += _limb_nbytes(chunks)
    total += sum(wt["nbytes"] for wt in entry.window_tiles.values())
    return total


def device_budget(config_mb: int, device: torch.device) -> int:
    """The cache's byte budget: the configured size, capped on a card at
    80 % of the device memory free when the cache is created."""
    budget = int(config_mb) << 20
    if device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        budget = min(budget, int(free * 0.8))
    return budget


class TileCacheManager:
    """Device-resident per-region super-tiles + host-side per-file encode
    cache, both LRU-bounded."""

    def __init__(
        self,
        budget_bytes: int = 8 << 30,
        chunk_rows: int = TILE_CHUNK_ROWS,
        device="cuda",
        config=None,
        tile_config=None,
    ):
        # the query config (its disabled passes) and the tile lifecycle
        # config (`incremental`), read at each decision
        self.config = config
        self.tile_config = tile_config
        self.budget = budget_bytes
        self.host_budget = budget_bytes * 2  # host encodes of the SST files
        self.chunk_rows = chunk_rows
        # the mesh slots (parallel/mesh.py; `device` is one device or a
        # sequence of them): chunks are placed over them, the first is
        # where single-device work runs
        self.devices = tuple(torch.device(d) for d in
                             (device if isinstance(device, (list, tuple)) else (device,)))
        self.device = self.devices[0]
        self._lock = threading.RLock()
        self._super: OrderedDict[int, _SuperTiles] = OrderedDict()
        self._host: OrderedDict[tuple[int, str], _FileHostTiles] = OrderedDict()
        self._used = 0
        self._host_used = 0
        self._region_versions: dict[int, int] = {}
        # files that can never join a super-tile (missing tag/ts column,
        # row-count mismatch): queries whose window touches them decline
        self._bad_files: set[tuple[int, str]] = set()
        # the fused TQL folds' device CSRs, per (radices, kept tags)
        self._group_csrs: OrderedDict[tuple, tuple] = OrderedDict()
        # counters: entries built, warm hits, Parquet decodes of SST files
        # (`file_decodes`), evictions, window tiles built or extended, dedup
        # keep planes built; under `tile.fused_build` the host requests the
        # per-file encode cache answered whole (`fused_decodes_saved`) and
        # the column encodes it saved (`fused_encodes_saved`), the
        # manifests recorded, the union builds run and the regions they
        # built, and the builders that waited for another's build
        # (`build_coalesced`)
        self.stats_counts = {"builds": 0, "hits": 0, "file_decodes": 0, "evictions": 0,
                             "window_tile_builds": 0, "dedup_keep_builds": 0,
                             "fused_decodes_saved": 0, "fused_encodes_saved": 0,
                             "fused_manifests": 0, "fused_builds": 0, "fused_regions_built": 0,
                             "build_coalesced": 0}
        # the fused build's plane manifests, a ring per table, and the
        # in-flight build of each (table, kind) (`build_gate`)
        self._manifests: dict[str, OrderedDict] = {}
        self._build_events: dict[tuple, threading.Event] = {}
        # called with a region id whenever a plane of its entry is replaced
        # or freed: the tile executor drops the tick programs (CUDA graphs)
        # that read it
        self.plane_listeners: list = []
        # device bytes the executor's tick programs hold, out of the budget
        self.graph_bytes = 0
        # the executor's windowed result cache, purged per region here
        self.result_cache = None

    def count(self, **deltas) -> None:
        """Add to the counters of `stats()` (the query and builder threads
        both count)."""
        with self._lock:
            for k, v in deltas.items():
                self.stats_counts[k] += v

    # ---- the fused build's manifests and gate ------------------------------------
    _MANIFESTS_PER_TABLE = 64

    def record_manifest(self, manifest: PlaneManifest) -> bool:
        """Add one family's plane requirements to its table's ring (the 64
        most recent); True when the manifest is new for the table."""
        with self._lock:
            d = self._manifests.setdefault(manifest.table_key, OrderedDict())
            if manifest in d:
                d.move_to_end(manifest)
                return False
            d[manifest] = None
            while len(d) > self._MANIFESTS_PER_TABLE:
                d.popitem(last=False)
            self.stats_counts["fused_manifests"] += 1
        return True

    def family_manifests(self, table_key: str) -> list[PlaneManifest]:
        with self._lock:
            return list(self._manifests.get(table_key, ()))

    @contextlib.contextmanager
    def build_gate(self, table_key: str, kind: str = "fused"):
        """One whole-table build at a time: the first caller leads (yields
        True) and builds; a caller that comes while it runs waits for it
        and yields False (counted in `build_coalesced`), then finds the
        leader's planes cached.  No deadline: a waiter waits for the
        leader's end."""
        key = (table_key, kind)
        with self._lock:
            ev = self._build_events.get(key)
            leader = ev is None
            if leader:
                ev = self._build_events[key] = threading.Event()
            else:
                self.stats_counts["build_coalesced"] += 1
        if leader:
            try:
                yield True
            finally:
                with self._lock:
                    self._build_events.pop(key, None)
                ev.set()
            return
        ev.wait()
        yield False

    # ---- placement -----------------------------------------------------------
    def mesh(self, n_devices: int) -> tuple:
        """The mesh of the first `n_devices` slots."""
        return make_mesh(n_devices, devices=self.devices)

    def mesh_devices(self) -> int:
        """The live `tile.mesh_devices` knob, clamped to the listed slots."""
        n = int(getattr(self.tile_config, "mesh_devices", 0) or 0)
        return min(max(n, 0), len(self.devices))

    def placement(self, region_id: int) -> tuple[int, int]:
        """(base, modulus) of a new entry's chunk placement: chunk i goes to
        slot (base + i) % modulus — round robin over every slot, from the
        region's co-located slot over the mesh's slots when the mesh is on,
        slot 0 when the `chunk_placement` pass is disabled."""
        if not passes.enabled("chunk_placement", self.config):
            return (0, 1)
        mesh_n = self.mesh_devices()
        if mesh_n > 0:
            return (region_device_index(region_id, mesh_n), mesh_n)
        return (0, len(self.devices))

    def _planes_changed(self, region_id: int) -> None:
        for fn in self.plane_listeners:
            fn(region_id)

    @property
    def plane_budget(self) -> int:
        """The budget left for planes beside the tick programs' graphs."""
        return max(self.budget - self.graph_bytes, 0)

    # ---- bookkeeping -------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {
                "regions": len(self._super),
                "bytes": self._used,
                "host_files": len(self._host),
                "host_bytes": self._host_used,
                "delta_extends": sum(e.delta_extends for e in self._super.values()),
                **self.stats_counts,
            }

    def has_region(self, region_id: int) -> bool:
        """A super-tile of the region is cached (host-only or uploaded): the
        `cost_route` pass leaves a query on the tile path then."""
        with self._lock:
            return region_id in self._super

    def invalidate_region(self, region_id: int, keep_file_ids: set[str] | None = None):
        """Drop host tiles of files no longer in the region's manifest and
        the region's super-tile when its file set changed."""
        with self._lock:
            for key in list(self._host):
                if key[0] == region_id and (keep_file_ids is None or key[1] not in keep_file_ids):
                    self._host_used -= self._host.pop(key).nbytes
            for key in list(self._bad_files):
                if key[0] == region_id and (keep_file_ids is None or key[1] not in keep_file_ids):
                    self._bad_files.discard(key)
            entry = self._super.get(region_id)
            if entry is not None and (
                keep_file_ids is None or not set(entry.file_ids) <= keep_file_ids
            ):
                self._drop_entry_locked(region_id)
            self._region_versions.pop(region_id, None)
        if self.result_cache is not None:
            self.result_cache.purge_region(region_id)

    def invalidate_region_if_changed(
        self, region_id: int, keep_file_ids: set[str], manifest_version: int
    ):
        """Version-gated sweep: runs only when the region's manifest
        advanced since the last query."""
        with self._lock:
            if self._region_versions.get(region_id) == manifest_version:
                return
        self.invalidate_region(region_id, keep_file_ids)
        with self._lock:
            self._region_versions[region_id] = manifest_version

    def repair_super(self, entries: list[_SuperTiles], dictionary: TableDictionary,
                     tag_cols) -> None:
        """Dictionary-growth repair: one K15 remap on the card per stale
        tag code plane, a numpy gather per stale sorted host copy.  Runs
        after every source of the query has updated the dictionary;
        serialized under the cache lock so a permutation never applies
        twice.  The device remap reproduces JAX's take(mode="fill"): a
        code in [-n, -1] counts from the end.  No negative code reaches a
        device plane (padding holds 0, encodes are repaired on the host
        first); the host half maps every negative code to -1."""
        with self._lock:
            for entry in entries:
                for tag in tag_cols:
                    if tag not in entry.epochs:
                        continue
                    perm = dictionary.perm_since(tag, entry.epochs[tag])
                    if perm is not None:
                        table = torch.from_numpy(np.ascontiguousarray(perm, np.int32)).to(
                            self.device)
                        entry.cols[tag] = gather_planes(entry.cols[tag], table, remap=True)
                        self._planes_changed(entry.region_id)
                        # the time-major copy holds the old codes
                        dropped = entry.tm_cols.pop(tag, None)
                        if dropped is not None:
                            freed = _nbytes(dropped)
                            entry.nbytes -= freed
                            if self._super.get(entry.region_id) is entry:
                                self._used -= freed
                    entry.epochs[tag] = dictionary.epoch
                for tag, epoch in list(entry.host_epochs.items()):
                    perm = dictionary.perm_since(tag, epoch)
                    if perm is not None:
                        codes = entry.sorted_host[tag]
                        ok = (codes >= 0) & (codes < len(perm))
                        entry.sorted_host[tag] = np.where(
                            ok, perm[np.clip(codes, 0, len(perm) - 1)], -1
                        ).astype(codes.dtype)
                    entry.host_epochs[tag] = dictionary.epoch

    def _drop_entry_locked(self, region_id: int) -> _SuperTiles:
        """Forget a cached entry: its device and host bytes leave the
        budgets, and the planes' listeners hear of it."""
        entry = self._super.pop(region_id)
        self._used -= entry.nbytes
        self._host_used -= entry.host_nbytes
        self._planes_changed(region_id)
        return entry

    def _drop_window_tile_locked(self, entry: _SuperTiles, key) -> int:
        """Forget one window tile of an entry; returns its device bytes."""
        freed = entry.window_tiles.pop(key)["nbytes"]
        entry.nbytes -= freed
        if self._super.get(entry.region_id) is entry:
            self._used -= freed
        self._planes_changed(entry.region_id)
        return freed

    def _reserve_locked(self, est: int, pinned_regions: set[int]):
        """Make room for `est` bytes about to allocate on the device."""
        if est and self._used > self.plane_budget - est:
            saved, self.budget = self.budget, max(self.budget - est, 0)
            try:
                self._evict_locked(pinned_regions)
            finally:
                self.budget = saved

    def release_unneeded(self, entry: _SuperTiles, keep_cols: set[str],
                         keep_dedup: bool = True) -> int:
        """Drop this entry's planes of columns the current query does not
        touch (whole-entry eviction cannot help a one-entry deployment),
        its window tiles that lack one of them, and, when the query does
        not read the keep plane (`keep_dedup` False), the keep plane's
        time-major copy."""
        with self._lock:
            freed = 0
            for d in (entry.cols, entry.nulls):
                for name in list(d):
                    if name not in keep_cols:
                        freed += _nbytes(d.pop(name))
                        entry.epochs.pop(name, None)
            for d in (entry.tm_cols, entry.tm_nulls):
                for name in list(d):
                    if name not in keep_cols:
                        freed += _nbytes(d.pop(name))
            for key in list(entry.limb_cols):
                if key.split(":", 1)[-1] not in keep_cols:
                    freed += _limb_nbytes(entry.limb_cols.pop(key))
            if not keep_dedup and entry.tm_valid_dedup is not None:
                freed += _nbytes(entry.tm_valid_dedup)
                entry.tm_valid_dedup = None
            for key in list(entry.window_tiles):
                wt = entry.window_tiles[key]
                if not all(c in wt["cols"] or c in wt["limbs"] for c in keep_cols):
                    freed += entry.window_tiles.pop(key)["nbytes"]
            entry.nbytes -= freed
            if self._super.get(entry.region_id) is entry:
                self._used -= freed
            if freed:
                self._planes_changed(entry.region_id)
            return freed

    def lacks_derived(self, entry: _SuperTiles, cols, limb_cols, time_major: bool,
                      dedup: bool) -> bool:
        """A time-major copy or a limb plane a query reads over the entry's
        full planes is not cached yet (the query would add it)."""
        with self._lock:
            if time_major:
                if entry.tm_valid is None or (dedup and entry.tm_valid_dedup is None):
                    return True
                if any((c in entry.cols and c not in entry.tm_cols)
                       or (c in entry.nulls and c not in entry.tm_nulls) for c in cols):
                    return True
            prefix = "tm:" if time_major else ""
            return any(prefix + c not in entry.limb_cols for c in limb_cols)

    def _evict_locked(self, pinned_regions: set[int]):
        # limb planes first (a quantize pass rebuilds them), then window
        # tiles (a host gather and an upload), then whole unpinned entries
        # (a Parquet decode rebuilds those)
        for entry in list(self._super.values()):
            for key in list(entry.limb_cols):
                if self._used <= self.plane_budget:
                    break
                freed = _limb_nbytes(entry.limb_cols.pop(key))
                entry.nbytes -= freed
                self._used -= freed
                self._planes_changed(entry.region_id)
        for entry in list(self._super.values()):
            for key in list(entry.window_tiles):
                if self._used <= self.plane_budget:
                    break
                self._drop_window_tile_locked(entry, key)
        while self._used > self.plane_budget and len(self._super) > len(pinned_regions):
            for rid in list(self._super):
                if rid not in pinned_regions:
                    self._drop_entry_locked(rid)
                    self.count(evictions=1)
                    break
            else:
                break
        while self._host_used > self.host_budget and self._host:
            _key, entry = next(iter(self._host.items()))
            self._host_used -= entry.nbytes
            del self._host[_key]

    # ---- host-side per-file encode cache -----------------------------------
    def _file_host_tiles(
        self,
        region: Region,
        dictionary: TableDictionary,
        meta: FileMeta,
        columns: list[str],
        tag_cols: list[str],
        ts_col: str | None,
    ) -> _FileHostTiles | None:
        key = (region.region_id, meta.file_id)
        with self._lock:
            entry = self._host.get(key)
            if entry is not None:
                self._host.move_to_end(key)
        if entry is None:
            entry = _FileHostTiles(num_rows=meta.num_rows)
        missing = [c for c in columns if c not in entry.cols and c not in entry.absent]
        fused_on = getattr(self.tile_config, "fused_build", True)
        if missing:
            # one Parquet decode of the file: the fused build's contract is
            # one a file for a whole family
            self.count(file_decodes=1)
            if fused_on and len(missing) < len(columns):
                # columns an earlier family member already encoded
                self.count(fused_encodes_saved=len(columns) - len(missing))
            table = region.sst_reader.read(meta, None, columns=missing)
            if table.num_rows != meta.num_rows:
                with self._lock:
                    self._bad_files.add(key)
                return None
            present = [c for c in missing if c in table.column_names]
            for name in missing:
                if name in table.column_names:
                    continue
                # the file predates the column: a value column NULL-fills,
                # a missing tag/ts column cannot be represented
                if name in tag_cols or name == ts_col:
                    with self._lock:
                        self._bad_files.add(key)
                    return None
                entry.absent.add(name)
            built = _encode_host_tiles(dictionary, table, present, tag_cols, ts_col)
            if built is None:
                with self._lock:
                    self._bad_files.add(key)
                return None
            cols, nulls, epochs, nbytes = built
            entry.cols.update(cols)
            entry.nulls.update(nulls)
            entry.epochs.update(epochs)
            entry.nbytes += nbytes
            with self._lock:
                old = self._host.pop(key, None)
                if old is not None and old is not entry:
                    self._host_used -= old.nbytes
                self._host[key] = entry
                self._host_used += nbytes
        elif fused_on and entry.cols:
            # the whole request from the per-file encode cache: a decode and
            # every column's encode saved by the shared pass
            self.count(fused_decodes_saved=1, fused_encodes_saved=len(columns))
        return entry

    def _repair_host_locked(self, entry: _FileHostTiles, dictionary: TableDictionary):
        """Bring a host tile's tag codes to the current dictionary epoch
        with one numpy gather per stale column."""
        for tag, epoch in list(entry.epochs.items()):
            perm = dictionary.perm_since(tag, epoch)
            if perm is not None:
                codes = entry.cols[tag]
                ok = (codes >= 0) & (codes < len(perm))
                entry.cols[tag] = np.where(
                    ok, perm[np.clip(codes, 0, len(perm) - 1)], -1
                ).astype(np.int32)
            entry.epochs[tag] = dictionary.epoch

    # ---- super-tile build / fetch -----------------------------------------
    def super_tiles(
        self,
        region: Region,
        dictionary: TableDictionary,
        metas: list[FileMeta],
        tag_cols: list[str],
        ts_col: str | None,
        value_cols: list[str],
        pinned_regions: set[int],
        pk_cols: list[str],
        timings: dict | None = None,
        device_upload: bool = True,
    ) -> tuple[_SuperTiles | None, list[FileMeta]]:
        """Cached (or freshly consolidated and uploaded) planes of one
        region's SST set.  Returns (entry, excluded): `excluded` lists files
        that cannot join the super-tile — the caller declines when any of
        them intersects the query window.  `pk_cols` + `ts_col` define the
        global sort order.  `timings` (optional) accumulates host ms of the
        "build" (decode, encode, sort, consolidate) and "upload" stages.

        With `device_upload` False the build stops on the host (the host
        routes may answer without the card): the per-file encodes, the
        (pk, ts) order and the sorted host copies, the entry committed to
        the cache under the host budget, and no upload.  A later call with
        uploads finds the entry and uploads what it lacks.  Only calls with
        uploads count `hits` and `builds`."""
        need = list(dict.fromkeys(tag_cols + ([ts_col] if ts_col else []) + value_cols))
        sort_cols = list(dict.fromkeys(pk_cols + ([ts_col] if ts_col else [])))
        host_need = list(dict.fromkeys(sort_cols + need))
        # the first consolidation reads Parquet anyway: host-decode every
        # numeric field column in that pass (device upload stays lazy)
        eager = [c.name for c in region.schema.field_columns() if c.data_type.is_numeric()]
        host_need = list(dict.fromkeys(host_need + eager))
        rid = region.region_id
        t_start = time.perf_counter()
        for _attempt in range(len(metas) + 1):
            with self._lock:
                included = [m for m in metas if (rid, m.file_id) not in self._bad_files]
            excluded = [m for m in metas if m not in included]
            if not included:
                return None, excluded
            ids = tuple(m.file_id for m in included)
            with self._lock:
                entry = self._super.get(rid)
                if entry is not None:
                    self._super.move_to_end(rid)
            if entry is not None and entry.file_ids != ids:
                # a flush appended files: extend the cached entry in place
                # (delta encode, merge of the sorted runs, K16 plane patch);
                # any other change of the file set rebuilds
                extended = None
                if not getattr(self.tile_config, "incremental", True):
                    why = "tile.incremental off: full rebuild"
                elif not passes.enabled("incremental_tile", self.config):
                    why = "pass disabled: full rebuild"
                elif not (len(ids) > len(entry.file_ids)
                          and ids[: len(entry.file_ids)] == entry.file_ids):
                    why = "file set not an append of the cached one (removal): full rebuild"
                elif entry.order is None:
                    why = "cached entry has no sort order yet: full rebuild"
                else:
                    why = "delta could not merge: full rebuild"
                    extended = self._delta_extend(
                        region, dictionary, entry, included, ids, host_need,
                        tag_cols + pk_cols, ts_col, sort_cols, pinned_regions, timings,
                    )
                if extended is None:
                    passes.note("incremental_tile", False, why, region=rid)
                    with self._lock:
                        if self._super.get(rid) is entry:
                            self._drop_entry_locked(rid)
                    entry = None
                else:
                    entry = extended
            if entry is None:
                total = sum(m.num_rows for m in included)
                entry = _SuperTiles(region_id=rid, file_ids=ids, num_rows=total,
                                    pad=pad_rows(max(total, 1)))
            missing = [c for c in need if c not in entry.cols]
            if not missing and entry.valid is not None:
                if device_upload:
                    self.count(hits=1)
                return entry, excluded

            host_tiles: list[_FileHostTiles] = []
            for meta in included:
                ht = self._file_host_tiles(region, dictionary, meta, host_need,
                                           tag_cols + pk_cols, ts_col)
                if ht is None:
                    break  # newly discovered bad file: retry without it
                host_tiles.append(ht)
            if len(host_tiles) != len(included):
                continue
            with self._lock:
                for ht in host_tiles:
                    self._repair_host_locked(ht, dictionary)
            if entry.order is None:
                # global (pk, ts) sort of the concatenation (lexsort keys
                # minor to major); code repair preserves relative order,
                # so `order` stays valid across dictionary growth
                cats = {
                    name: np.concatenate([ht.cols[name] for ht in host_tiles])
                    for name in sort_cols
                }
                if cats:
                    entry.order = np.lexsort(
                        [cats[name] for name in reversed(sort_cols)]
                    ).astype(np.int64)
                else:
                    entry.order = np.arange(entry.num_rows, dtype=np.int64)
                entry.sorted_host = {name: cats[name][entry.order] for name in sort_cols}
                entry.host_epochs = {
                    name: dictionary.epoch for name in sort_cols if name != ts_col
                }
                entry.file_row_offsets = np.concatenate(
                    [[0], np.cumsum([ht.num_rows for ht in host_tiles])]).astype(np.int64)

            if not device_upload:
                # host-only: commit the consolidation, keep the host budget
                with self._lock:
                    old = self._super.get(rid)
                    if old is not None and old is not entry:
                        self._drop_entry_locked(rid)
                    self._super.pop(rid, None)
                    self._super[rid] = entry
                    self._evict_locked(pinned_regions | {rid})
                if timings is not None:
                    timings["build"] = (timings.get("build", 0.0)
                                        + (time.perf_counter() - t_start) * 1e3)
                return entry, excluded

            est = 0
            for name in missing:
                src0 = next((ht.cols[name] for ht in host_tiles if name in ht.cols), None)
                item = src0.dtype.itemsize if src0 is not None else 8
                nullable = any(name in ht.nulls or name in ht.absent for ht in host_tiles)
                est += entry.pad * (item + (1 if nullable else 0))
            with self._lock:
                self._reserve_locked(est, pinned_regions | {rid})

            bounds = chunk_bounds(entry.pad, self.chunk_rows)
            acc = [0, 0.0]  # device bytes landed, upload seconds
            if entry.valid is None:
                v = np.zeros(entry.pad, bool)
                v[: entry.num_rows] = True
                t0 = time.perf_counter()
                self._decide_placement(entry)
                entry.valid = self._up_chunks(v, bounds, entry.placement)
                acc[0] += v.nbytes
                acc[1] += time.perf_counter() - t0
            self._upload_missing(entry, missing, host_tiles, bounds, acc, tag_cols, pk_cols,
                                 dictionary)
            added, t_up = acc
            entry.nbytes += added
            with self._lock:
                old = self._super.get(rid)
                if old is not None and old is not entry:
                    self._drop_entry_locked(rid)
                self._super.pop(rid, None)
                self._super[rid] = entry
                self._used += added
                self._evict_locked(pinned_regions | {rid})
            self.count(builds=1)
            if timings is not None:
                total_ms = (time.perf_counter() - t_start) * 1e3
                timings["upload"] = timings.get("upload", 0.0) + t_up * 1e3
                timings["build"] = timings.get("build", 0.0) + total_ms - t_up * 1e3
            return entry, excluded
        return None, list(metas)

    def _delta_extend(self, region, dictionary, entry: _SuperTiles, included, ids,
                      host_need, tag_like, ts_col, sort_cols, pinned_regions,
                      timings) -> _SuperTiles | None:
        """Extend a cached entry in place after a flush appended files:
        host-encode only the delta files, merge their (pk, ts)-sorted run
        into the cached order (`_lex_merge_positions`, no re-sort of the
        whole), and patch every resident plane on the card with K16, so
        only the positions and the delta values cross to the device.
        Re-derivable planes (time-major copies, the permutation, limb
        planes, the dedup keep plane and its copies) drop and rebuild
        lazily, as do the window tiles whose window a delta row can fall
        in; the others stay as they are.  Returns
        the entry, or None when the delta cannot merge (the caller
        rebuilds, the reference's semantics); a device failure raises.
        `timings` gains "delta_host" (encode + merge) and "delta_device"
        (the patches, through a sync) in ms.

        The merged (order, sorted_host) equal a rebuild's stable lexsort
        of the whole concatenation, since both runs were stably sorted and
        ties go to the old run (flush order)."""
        rid = entry.region_id
        old_ids = entry.file_ids
        delta_metas = included[len(old_ids):]
        delta_rows = sum(m.num_rows for m in delta_metas)
        if delta_rows == 0:
            return None
        if any(c not in entry.sorted_host for c in sort_cols):
            return None  # the entry predates a sort column: the rebuild owns it
        t_start = time.perf_counter()

        # 1. host-encode the delta files only; resident planes must be
        # patchable, so the decode covers them too
        resident = sorted(set(entry.cols) | set(entry.nulls))
        need = list(dict.fromkeys(list(host_need) + resident))
        delta_tiles: list[_FileHostTiles] = []
        for meta in delta_metas:
            ht = self._file_host_tiles(region, dictionary, meta, need, tag_like, ts_col)
            if ht is None:
                return None  # a bad delta file: the rebuild path gates it
            delta_tiles.append(ht)

        # 2. one dictionary epoch for every code before keys are compared:
        # the delta encode may have grown the dictionary
        with self._lock:
            for ht in delta_tiles:
                self._repair_host_locked(ht, dictionary)
        self.repair_super([entry], dictionary, sorted(entry.epochs))

        # 3. sort the delta, merge the two sorted runs
        old_n = entry.num_rows
        total = old_n + delta_rows
        new_pad = pad_rows(max(total, 1))
        delta_cats = {c: np.concatenate([ht.cols[c] for ht in delta_tiles]) for c in sort_cols}
        if sort_cols:
            delta_order = np.lexsort([delta_cats[c] for c in reversed(sort_cols)]).astype(np.int64)
        else:
            delta_order = np.arange(delta_rows, dtype=np.int64)
        delta_sorted = {c: delta_cats[c][delta_order] for c in sort_cols}
        old_sorted = {c: entry.sorted_host[c] for c in sort_cols}
        pos = _lex_merge_positions([old_sorted[c] for c in sort_cols],
                                   [delta_sorted[c] for c in sort_cols])
        shift = np.searchsorted(pos, np.arange(old_n), side="right")
        old_global = np.arange(old_n, dtype=np.int64) + shift
        delta_global = pos + np.arange(delta_rows, dtype=np.int64)
        new_order = np.empty(total, np.int64)
        new_order[old_global] = entry.order
        new_order[delta_global] = old_n + delta_order
        new_sorted: dict[str, np.ndarray] = {}
        for c in sort_cols:
            arr = np.empty(total, old_sorted[c].dtype)
            arr[old_global] = old_sorted[c]
            arr[delta_global] = delta_sorted[c].astype(old_sorted[c].dtype)
            new_sorted[c] = arr
        new_offsets = np.concatenate([
            entry.file_row_offsets, old_n + np.cumsum([ht.num_rows for ht in delta_tiles])
        ]).astype(np.int64)
        host_ms = (time.perf_counter() - t_start) * 1e3

        # 4. patch the resident planes on the card (K16): old rows read
        # through the old chunk table, each plane written into new chunks
        t_dev = time.perf_counter()
        patched_cols: dict[str, list] = {}
        patched_nulls: dict[str, list] = {}
        new_valid = None
        if entry.valid is not None:
            est = new_pad  # the valid plane
            for chunks in entry.cols.values():
                est += new_pad * chunks[0].element_size()
            est += (len(entry.nulls) + len(entry.cols)) * new_pad  # nulls
            with self._lock:
                self._reserve_locked(est, pinned_regions | {rid})
            pos_dev = torch.from_numpy(pos.astype(np.int32)).to(self.device)

            def up(arr: np.ndarray) -> torch.Tensor:
                return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

            def delta_col(name, dtype):
                cat = np.concatenate([
                    ht.cols[name] if name in ht.cols else np.zeros(ht.num_rows, dtype)
                    for ht in delta_tiles
                ])
                return up(cat[delta_order].astype(dtype, copy=False))

            def delta_null(name):
                if not any(name in ht.nulls or name in ht.absent for ht in delta_tiles):
                    return None
                ncat = np.concatenate([
                    ht.nulls[name] if name in ht.nulls
                    else np.full(ht.num_rows, name not in ht.absent)
                    for ht in delta_tiles
                ])
                return ncat[delta_order]

            def patch(chunks, dv):
                return delta_patch(chunks, old_n, dv, pos_dev, new_pad, self.chunk_rows)

            for name, chunks in entry.cols.items():
                np_dtype = torch.empty(0, dtype=chunks[0].dtype).numpy().dtype
                patched_cols[name] = patch(chunks, delta_col(name, np_dtype))
                dn = delta_null(name)
                if name in entry.nulls:
                    if dn is None:
                        dn = np.ones(delta_rows, bool)
                    patched_nulls[name] = patch(entry.nulls[name], up(dn))
                elif dn is not None and not dn.all():
                    # the delta brings the column's first nulls: the old
                    # rows are all present
                    ones = [torch.ones(old_n, dtype=torch.bool, device=self.device)]
                    patched_nulls[name] = patch(ones, up(dn))
            new_valid = patch(entry.valid, up(np.ones(delta_rows, bool)))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        dev_ms = (time.perf_counter() - t_dev) * 1e3

        # 5. commit: nothing above changed the entry
        with self._lock:
            if (self._super.get(rid) is not entry or entry.file_ids != old_ids
                    or entry.num_rows != old_n):
                return None  # evicted or changed meanwhile: the rebuild owns it
            old_dev = entry.nbytes
            entry.file_ids = ids
            entry.num_rows = total
            entry.pad = new_pad
            entry.order = new_order
            entry.sorted_host = new_sorted
            entry.host_epochs = {c: dictionary.epoch for c in sort_cols if c != ts_col}
            entry.file_row_offsets = new_offsets
            # a new file set: the cold serve may answer once more
            entry.cold_served = False
            self._host_used -= entry.host_nbytes
            entry.host_nbytes = 0
            entry.keep_host = None
            entry.valid_dedup = None
            if new_valid is not None:
                entry.cols = patched_cols
                entry.nulls = patched_nulls
                entry.valid = new_valid
            else:
                entry.cols, entry.nulls, entry.valid, entry.epochs = {}, {}, None, {}
            # re-derivable planes rebuild lazily from the patched planes
            entry.tm_cols, entry.tm_nulls, entry.tm_valid = {}, {}, None
            entry.tm_valid_dedup = None
            entry.perm = None
            entry.limb_cols = {}
            # window tiles whose window cannot hold a delta row keep their
            # bytes; the others rebuild on their next query
            if ts_col in delta_cats and delta_rows:
                dmin, dmax = int(delta_cats[ts_col].min()), int(delta_cats[ts_col].max())
            else:
                dmin, dmax = -(1 << 62), 1 << 62
            for key in [k for k in entry.window_tiles if dmax >= k[0] and dmin < k[1]]:
                del entry.window_tiles[key]
            entry.window_declines = set()
            entry.nbytes = _entry_device_bytes(entry)
            self._planes_changed(rid)
            self._used += entry.nbytes - old_dev
            self._evict_locked(pinned_regions | {rid})
        entry.delta_extends += 1
        if timings is not None:
            timings["delta_host"] = timings.get("delta_host", 0.0) + host_ms
            timings["delta_device"] = timings.get("delta_device", 0.0) + dev_ms
        passes.note(
            "incremental_tile", True,
            f"{delta_rows} delta rows merged into the cached super-tile "
            "(sorted-run merge + on-device plane patch)",
            region=rid, delta_rows=delta_rows, total_rows=total,
            ms=round((time.perf_counter() - t_start) * 1e3, 1),
        )
        return entry

    def _consolidate_column(self, entry: _SuperTiles, name, host_tiles):
        """Host-side assembly of one column's consolidated (sorted, padded)
        buffer + optional present-mask plane."""
        src = next((ht.cols[name] for ht in host_tiles if name in ht.cols), None)
        dtype = src.dtype if src is not None else np.float64
        cat = np.concatenate([
            ht.cols[name] if name in ht.cols else np.zeros(ht.num_rows, dtype)
            for ht in host_tiles
        ])
        buf = np.zeros(entry.pad, dtype=cat.dtype)
        buf[: entry.num_rows] = cat[entry.order]
        nbuf = None
        if any(name in ht.nulls or name in ht.absent for ht in host_tiles):
            ncat = np.concatenate([
                ht.nulls[name] if name in ht.nulls else np.full(ht.num_rows, name not in ht.absent)
                for ht in host_tiles
            ])
            nbuf = np.zeros(entry.pad, bool)
            nbuf[: entry.num_rows] = ncat[entry.order]
        return buf, nbuf

    def _land_column(self, entry: _SuperTiles, name, buf, nbuf, bounds, acc: list,
                     tag_cols, pk_cols, dictionary):
        """Upload one consolidated column (+ its present-mask plane) and
        stamp the dictionary epoch of a tag column."""
        t0 = time.perf_counter()
        entry.cols[name] = self._up_chunks(buf, bounds, entry.placement)
        acc[0] += buf.nbytes
        if nbuf is not None:
            entry.nulls[name] = self._up_chunks(nbuf, bounds, entry.placement)
            acc[0] += nbuf.nbytes
        acc[1] += time.perf_counter() - t0
        if name in tag_cols or name in pk_cols:
            entry.epochs[name] = dictionary.epoch

    def _upload_missing(self, entry: _SuperTiles, missing, host_tiles, bounds, acc: list,
                        tag_cols, pk_cols, dictionary):
        """Consolidate + upload the missing columns of an entry, one column
        at a time (the reference's pipelined form is not ported)."""
        for name in missing:
            buf, nbuf = self._consolidate_column(entry, name, host_tiles)
            self._land_column(entry, name, buf, nbuf, bounds, acc, tag_cols, pk_cols,
                              dictionary)

    def _up_chunks(self, buf: np.ndarray, bounds, placement=(0, 1)) -> list:
        """Upload a consolidated host buffer chunk by chunk, chunk i onto
        slot (base + i) % modulus of `placement`."""
        t = torch.from_numpy(buf)
        base, modulus = placement
        out = []
        for i, (a, b) in enumerate(bounds):
            dev = self.devices[(base + i) % modulus]
            out.append(t[a:b].to(dev).contiguous() if dev.type != "cpu" else t[a:b].clone())
        return out

    def _decide_placement(self, entry: _SuperTiles) -> None:
        """Fix an entry's chunk placement with its first device plane: the
        valid plane, or the keep plane of an entry built host-only."""
        if entry.valid is None and entry.valid_dedup is None:
            entry.placement = self.placement(entry.region_id)

    def gather_host_values(self, entry: _SuperTiles, col: str, positions: np.ndarray):
        """One value column at `positions` of the file concatenation (rows
        of `order`), from the per-file host encodes: (values, present), the
        present mask None when every row holds a value (a file that
        predates the column, or its NULLs, clear it), or None when an
        encode is no longer cached (the host routes then decline)."""
        offs = entry.file_row_offsets
        with self._lock:
            tiles = [self._host.get((entry.region_id, fid)) for fid in entry.file_ids]
        if offs is None or any(t is None for t in tiles):
            return None
        fidx = np.searchsorted(offs, positions, side="right") - 1
        rows = positions - offs[fidx]
        dtype = next((t.cols[col].dtype for t in tiles if col in t.cols), np.float64)
        out = np.zeros(len(positions), dtype=dtype)
        present: np.ndarray | None = None
        for i, t in enumerate(tiles):
            m = fidx == i
            if not m.any():
                continue
            if col in t.absent or col not in t.cols:
                if present is None:
                    present = np.ones(len(positions), bool)
                present[m] = False
                continue
            out[m] = t.cols[col][rows[m]]
            if col in t.nulls:
                if present is None:
                    present = np.ones(len(positions), bool)
                present[m] = t.nulls[col][rows[m]]
        return out, present

    def ensure_dedup_keep(self, entry: _SuperTiles) -> bool:
        """Build (once per file set) the last-write-wins keep plane from the
        sorted host copies: a row survives unless the next row holds the
        same (pk..., ts) — the stable lexsort orders duplicates by flush
        sequence (and the delta merge ties to the old run), so the newest
        version sits last in its run.  Keeps the host copy (`keep_host`,
        counted in the cache's host bytes; window tiles read it) and the
        device plane.  Returns False when the entry lacks its sorted host
        copies."""
        with self._lock:
            if entry.valid_dedup is not None:
                return True
            if not entry.sorted_host or entry.order is None:
                return False
            n = entry.num_rows
            keep = np.zeros(entry.pad, bool)
            keep[:n] = True
            if n > 1:
                same = np.ones(n - 1, bool)
                for arr in entry.sorted_host.values():
                    same &= arr[:-1] == arr[1:]
                keep[: n - 1] &= ~same
            entry.keep_host = keep[:n]
            self._decide_placement(entry)
            entry.valid_dedup = self._up_chunks(keep, chunk_bounds(entry.pad, self.chunk_rows),
                                                entry.placement)
            entry.nbytes += entry.pad
            entry.host_nbytes += entry.keep_host.nbytes
            if self._super.get(entry.region_id) is entry:
                self._used += entry.pad
                self._host_used += entry.keep_host.nbytes
            self.count(dedup_keep_builds=1)
            return True

    # window tiles engage when the window covers less than this share of
    # the entry's rows (above it the full super-tile is cheaper than a
    # nearly as large copy), and only on entries of this many rows or more
    # (below it the full scan is cheap)
    _WINDOW_TILE_MAX_COVER = 0.5
    _WINDOW_TILE_MIN_ROWS = 1 << 22

    def ensure_window_tile(self, entry: _SuperTiles, window: tuple[int, int], ts_name: str,
                           need_cols, limb_cols, dedup: bool, dictionary: TableDictionary,
                           timings: dict | None = None):
        """Build (or fetch, or extend with missing columns) the compact
        tile of one query window: `flatnonzero` of the window mask over
        the sorted ts on the host (AND `keep_host` with `dedup`, so stale
        versions never upload), a host gather of each needed column from
        the sorted host copies or the per-file encodes
        (`gather_host_values`), zero padding to the 2^22-row grid, an
        upload in chunks of `min(chunk_rows, 2^22)`
        rows onto the slots of the region's placement, and K5 over the
        gathered chunks of the limb columns (their f64 plane stays).
        Rows keep their (pk, ts) order.  Returns (sources, slots) — one
        (cols, valid, nulls, limbs) source per chunk and its mesh slot —
        or None when the window does not qualify: a small entry, no
        rows, more than half the entry's rows (both remembered for the
        file set, so a warm query does not mask the entry again), a
        nullable column, a host encode no longer cached.  `timings`
        gains the host ms of "window_gather", "window_upload" and
        "window_quantize" (through a sync)."""
        if entry.num_rows < self._WINDOW_TILE_MIN_ROWS or ts_name not in entry.sorted_host:
            return None
        key = (int(window[0]), int(window[1]), bool(dedup))
        if key in entry.window_declines:
            return None
        cols_needed = list(dict.fromkeys([c for c in need_cols if c != ts_name] + [ts_name]))
        epoch = dictionary.epoch
        with self._lock:
            wt = entry.window_tiles.get(key)
            if wt is not None and wt["epoch"] != epoch:
                # tag codes moved: drop it and build at the current epoch
                self._drop_window_tile_locked(entry, key)
                wt = None
            snap = None
            if wt is not None:
                missing = [c for c in cols_needed if c not in wt["cols"]]
                missing_limbs = [c for c in limb_cols
                                 if c in need_cols and c not in wt["limbs"] and c not in missing]
                if not missing and not missing_limbs:
                    return self._window_sources(wt, need_cols, limb_cols)
                # extend the cached tile: build only the missing planes and
                # merge them in; the snapshot keeps the existing planes for
                # the commit, should the tile be evicted meanwhile
                snap = {"cols": dict(wt["cols"]), "limbs": dict(wt["limbs"]),
                        "valid": wt["valid"], "rows": wt["rows"], "placement": wt["placement"]}
            else:
                missing = list(cols_needed)
                missing_limbs = []

        t0 = time.perf_counter()
        n = snap["rows"] if snap is not None else -1
        idx = None
        if missing:
            ts_sorted = entry.sorted_host[ts_name]
            mask = (ts_sorted >= window[0]) & (ts_sorted < window[1])
            if dedup:
                if not self.ensure_dedup_keep(entry):
                    return None
                mask &= entry.keep_host
            idx = np.flatnonzero(mask)
            if snap is not None and len(idx) != snap["rows"]:
                # the row set changed under the same epoch: build it anew
                snap = None
                missing = list(cols_needed)
                missing_limbs = []
            n = len(idx)
            if n == 0 or n > entry.num_rows * self._WINDOW_TILE_MAX_COVER:
                with self._lock:
                    entry.window_declines.add(key)
                return None
        # a 2^22-row grid: one chunk shape a tile, stable across column
        # extensions (cached and new planes chunk alike)
        grid = 1 << 22
        pad = -(-n // grid) * grid
        bounds = chunk_bounds(pad, min(self.chunk_rows, grid))
        # a nullable column has no host null plane here: the full
        # super-tile path owns it (every decline comes before the
        # reservation, so an aborted build evicts nothing)
        for name in missing:
            if name in entry.nulls:
                return None

        # gather every host buffer first (host memory only)
        host_bufs: dict[str, np.ndarray] = {}
        for name in missing:
            src = entry.sorted_host.get(name)
            if src is not None:
                rows = src[idx]
            else:
                got = self.gather_host_values(entry, name, entry.order[idx])
                if got is None or (got[1] is not None and not got[1].all()):
                    return None  # a host encode was evicted, or a row is NULL
                rows = got[0]
            buf = np.zeros(pad, dtype=rows.dtype)
            buf[:n] = rows
            host_bufs[name] = buf
        gather_ms = (time.perf_counter() - t0) * 1e3

        limb_build = set(missing_limbs) | (set(limb_cols) & set(missing))
        est = sum(buf.nbytes for buf in host_bufs.values())
        est += len(limb_build) * (pad * 8 + (pad // BLOCK_ROWS) * 8)
        if snap is None:
            est += pad
        with self._lock:
            self._reserve_locked(est, {entry.region_id})

        placement = snap["placement"] if snap is not None else self.placement(entry.region_id)
        t_up = time.perf_counter()
        cols_dev: dict[str, list] = {}
        for name in missing:
            cols_dev[name] = self._up_chunks(host_bufs[name], bounds, placement)
        valid = snap["valid"] if snap is not None else None
        if valid is None:
            v = np.zeros(pad, bool)
            v[:n] = True
            valid = self._up_chunks(v, bounds, placement)
        up_ms = (time.perf_counter() - t_up) * 1e3
        t_q = time.perf_counter()
        limbs_dev: dict[str, list] = {}
        for name in sorted(limb_build):
            # the new columns from their gathered chunks, the others from
            # the tile's resident chunks (no host gather)
            chunks = cols_dev[name] if name in cols_dev else snap["cols"][name]
            limbs_dev[name] = [quantize_limbs(x) for x in chunks]
        for dev in {lb.device for planes in limbs_dev.values() for lb, _sc in planes}:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        q_ms = (time.perf_counter() - t_q) * 1e3

        def plane_bytes(kind: str, chunks) -> int:
            return _limb_nbytes(chunks) if kind == "limbs" else _nbytes(chunks)

        built = {"cols": cols_dev, "limbs": limbs_dev}
        with self._lock:
            race = entry.window_tiles.get(key)
            if race is not None and race["epoch"] == epoch and race["rows"] == n:
                # merge the new planes (and the snapshot's) into the live
                # tile, charging only the planes it lacks
                added = 0
                for kind, d in built.items():
                    merged = {**snap[kind], **d} if snap is not None else d
                    for c, chunks in merged.items():
                        if c not in race[kind]:
                            race[kind][c] = chunks
                            added += plane_bytes(kind, chunks)
                race["nbytes"] += added
                entry.nbytes += added
                if self._super.get(entry.region_id) is entry:
                    self._used += added
                wt = race
            else:
                if race is not None:
                    self._drop_window_tile_locked(entry, key)
                merged = {kind: {**(snap[kind] if snap is not None else {}), **d}
                          for kind, d in built.items()}
                wt = {**merged, "valid": valid, "rows": n, "epoch": epoch,
                      "placement": placement}
                wt["nbytes"] = (sum(plane_bytes(kind, chunks) for kind, d in merged.items()
                                    for chunks in d.values()) + _nbytes(valid))
                entry.window_tiles[key] = wt
                entry.nbytes += wt["nbytes"]
                if self._super.get(entry.region_id) is entry:
                    self._used += wt["nbytes"]
            self.count(window_tile_builds=1)
        if timings is not None:
            for stage, ms in (("window_gather", gather_ms), ("window_upload", up_ms),
                              ("window_quantize", q_ms)):
                timings[stage] = timings.get(stage, 0.0) + ms
        return self._window_sources(wt, need_cols, limb_cols)

    @staticmethod
    def _window_sources(wt: dict, need_cols, limb_cols) -> tuple[list, list]:
        """A window tile's (sources, slots): a (cols, valid, nulls, limbs)
        source per chunk, and the chunk's mesh slot."""
        base, modulus = wt["placement"]
        sources, slots = [], []
        for i in range(len(wt["valid"])):
            sources.append((
                {c: wt["cols"][c][i] for c in need_cols if c in wt["cols"]},
                wt["valid"][i],
                {},
                {c: wt["limbs"][c][i] for c in limb_cols if c in wt["limbs"]},
            ))
            slots.append((base + i) % modulus)
        return sources, slots

    def group_csr(self, radices: tuple, keep_idx: tuple) -> tuple[torch.Tensor, torch.Tensor]:
        """The device CSR (offsets, members) of a fused TQL fold's series ->
        group map (ops/rate.py::group_csr), built once per (radices, kept
        tags) and kept (the 16 most recent)."""
        key = (tuple(radices), tuple(keep_idx))
        with self._lock:
            hit = self._group_csrs.get(key)
            if hit is not None:
                self._group_csrs.move_to_end(key)
                return hit
        offsets, members = group_csr(radices, keep_idx)
        csr = (torch.from_numpy(offsets).to(self.device), torch.from_numpy(members).to(self.device))
        with self._lock:
            self._group_csrs[key] = csr
            while len(self._group_csrs) > 16:
                self._group_csrs.popitem(last=False)
        return csr

    def ensure_perm(self, entry: _SuperTiles, ts_name: str) -> torch.Tensor:
        """The stable ts-ascending permutation of the entry (K14), built
        once per file set and cached; padding rows sort last.  Build and
        budget accounting run under the lock, so the sort never runs
        twice and bytes are charged only while the entry is cached."""
        with self._lock:
            if entry.perm is None:
                # the sort's working set, as the reference reserves it
                self._reserve_locked(entry.pad * 24, {entry.region_id})
                entry.perm = ts_argsort(entry.cols[ts_name], entry.valid)
                entry.nbytes += entry.pad * 4
                if self._super.get(entry.region_id) is entry:
                    self._used += entry.pad * 4
            return entry.perm

    def ensure_time_major(self, entry: _SuperTiles, ts_name: str, cols_needed,
                          dedup: bool = False):
        """ts-ascending copies of the needed planes (once per (entry, file
        set, column); the planes a call adds in one K15 launch, as
        `gather_planes_multi` plans it), so time-major dispatches gather
        nothing.  Returns (cols, valid, nulls) views limited to
        `cols_needed`; with `dedup` the valid planes are the keep plane's
        copy (`ensure_dedup_keep` must have run), gathered in the same
        launch as the others."""
        perm = self.ensure_perm(entry, ts_name)
        added = 0
        with self._lock:
            est = 0
            for c in cols_needed:
                if c in entry.cols and c not in entry.tm_cols:
                    est += _nbytes(entry.cols[c])
                if c in entry.nulls and c not in entry.tm_nulls:
                    est += entry.pad
            if entry.tm_valid is None:
                est += entry.pad
            if dedup and entry.tm_valid_dedup is None:
                est += entry.pad
            self._reserve_locked(est, {entry.region_id})
            # (where the copy goes, its column, the plane) for each copy made
            todo = []
            if entry.tm_valid is None:
                todo.append((None, "valid", entry.valid))
            if dedup and entry.tm_valid_dedup is None:
                todo.append((None, "valid_dedup", entry.valid_dedup))
            for c in dict.fromkeys(cols_needed):
                if c in entry.cols and c not in entry.tm_cols:
                    todo.append((entry.tm_cols, c, entry.cols[c]))
                if c in entry.nulls and c not in entry.tm_nulls:
                    todo.append((entry.tm_nulls, c, entry.nulls[c]))
            copies = gather_planes_multi([plane for _d, _c, plane in todo], perm)
            for (dest, c, _plane), copy in zip(todo, copies):
                if dest is None:
                    setattr(entry, "tm_" + c, copy)
                else:
                    dest[c] = copy
                added += _nbytes(copy)
            if added:
                entry.nbytes += added
                if self._super.get(entry.region_id) is entry:
                    self._used += added
            return (
                {c: entry.tm_cols[c] for c in cols_needed if c in entry.tm_cols},
                entry.tm_valid_dedup if dedup else entry.tm_valid,
                {c: entry.tm_nulls[c] for c in cols_needed if c in entry.tm_nulls},
            )

    def ensure_limbs(
        self,
        entry: _SuperTiles,
        cols_needed: list[str],
        time_major: bool = False,
        pinned_regions: set[int] = frozenset(),
    ) -> dict[str, list]:
        """Cached K5 planes for the given value columns in the requested
        row order (the (pk, ts) planes, or the time-major copies, which
        `ensure_time_major` must have built), quantized on the device once
        per (region, file set); returns col -> per-chunk (limbs, scale).
        Columns with a chunk below the limb geometry (a multiple of 4096,
        at least 2^16 rows) are skipped: those sources take the exact
        scatter path."""
        src = entry.tm_cols if time_major else entry.cols
        prefix = "tm:" if time_major else ""
        out: dict[str, list] = {}
        to_build = []
        with self._lock:
            for c in cols_needed:
                if prefix + c in entry.limb_cols:
                    out[c] = entry.limb_cols[prefix + c]
                    continue
                chunks = src.get(c)
                if chunks is None or any(
                    x.shape[0] % BLOCK_ROWS or x.shape[0] < _FAST_MIN_ROWS for x in chunks
                ):
                    continue
                to_build.append((c, chunks))
        if not to_build:
            return out
        # 4 bf16 digits (8 B) per row and 8 B of scale per block
        est = sum(x.shape[0] * 8 + (x.shape[0] // BLOCK_ROWS) * 8
                  for _c, chunks in to_build for x in chunks)
        with self._lock:
            self._reserve_locked(est, pinned_regions | {entry.region_id})
        built = [(c, [quantize_limbs(x) for x in chunks]) for c, chunks in to_build]
        added = 0
        with self._lock:
            for c, planes in built:
                if prefix + c in entry.limb_cols:
                    out[c] = entry.limb_cols[prefix + c]
                    continue
                entry.limb_cols[prefix + c] = planes
                out[c] = planes
                added += _limb_nbytes(planes)
            if added:
                entry.nbytes += added
                if self._super.get(entry.region_id) is entry:
                    self._used += added
                self._evict_locked(pinned_regions | {entry.region_id})
        return out

    # ---- the fused family build ------------------------------------------------
    def fused_union_build(self, ctx: TileContext, schema, manifests, device: bool = True) -> dict:
        """One build for a table's query families: the union of their plane
        manifests, made in one pass a region — the host consolidation
        (each SST file decoded once: the first read takes every numeric
        field; each column encoded once; the (pk, ts) sort), then with
        `device` the keep plane, ONE upload of the union's full-plane
        columns, K5 over the limb columns among them, the time-major copies
        (K14, K15) and each window geometry's tile.  `device=False` stops
        after the host consolidation and the sorted host copies (what the
        host routes read): the prewarm form.  The table lock is taken a
        region at a time.  Any failure raises (the reference skips the
        region).  Callers serialize whole-table builds through
        `build_gate`.  Returns {"regions_built", "manifests", "ms"}."""
        t0 = time.perf_counter()
        pk = [c.name for c in schema.tag_columns()]
        ts_name = schema.time_index.name if schema.time_index else None
        tag_union = list(dict.fromkeys([t for m in manifests for t in m.tag_cols] + pk))

        def values(ms):
            return list(dict.fromkeys(c for m in ms for c in m.value_cols
                                      if schema.has_column(c) and c != ts_name))

        value_union = values(manifests)
        limb_union = list(dict.fromkeys(c for m in manifests for c in m.limb_cols
                                        if schema.has_column(c)))
        # families with no window geometry scan the whole super-tile: their
        # columns ride full planes, and time-major families' copies too
        full_cols = values([m for m in manifests if m.window is None])
        tm_cols = values([m for m in manifests if m.time_major])
        tm_dedup = any(m.dedup for m in manifests if m.time_major)
        windows: dict[tuple, dict] = {}
        for m in manifests:
            if m.window is None:
                continue
            w = windows.setdefault((int(m.window[0]), int(m.window[1]), bool(m.dedup)),
                                   {"cols": set(), "limbs": set()})
            w["cols"].update(m.tag_cols)
            w["cols"].update(m.value_cols)
            if m.ts_col:
                w["cols"].add(m.ts_col)
            w["limbs"].update(m.limb_cols)
        dedup_any = any(m.dedup for m in manifests)
        built = 0
        pinned_ids = {r.region_id for r in ctx.regions}
        for region in ctx.regions:
            with ctx.dictionary.table_lock:
                region.pin_scan()
                try:
                    metas, _mems, version = region.tile_snapshot()
                    self.invalidate_region_if_changed(
                        region.region_id, {m.file_id for m in metas}, version)
                    if not metas:
                        continue
                    entry, _excluded = self.super_tiles(
                        region, ctx.dictionary, metas, tag_union, ts_name, value_union,
                        pinned_ids, pk, device_upload=False)
                    if entry is None:
                        continue
                    built += 1
                    if not device:
                        continue
                    if dedup_any:
                        self.ensure_dedup_keep(entry)
                    if full_cols or tm_cols:
                        entry, _excluded = self.super_tiles(
                            region, ctx.dictionary, metas, tag_union, ts_name,
                            list(dict.fromkeys(full_cols + tm_cols)), pinned_ids, pk)
                        if entry is None:
                            continue
                    if limb_union and full_cols:
                        self.ensure_limbs(entry, [c for c in limb_union if c in full_cols],
                                          False, pinned_ids)
                    if tm_cols and ts_name:
                        if tm_dedup:
                            self.ensure_dedup_keep(entry)
                        self.ensure_time_major(entry, ts_name, set(tm_cols) | {ts_name},
                                               dedup=tm_dedup)
                    for (wlo, whi, wd), want in windows.items():
                        self.ensure_window_tile(
                            entry, (wlo, whi), ts_name,
                            {c for c in want["cols"] if c == ts_name or schema.has_column(c)},
                            set(want["limbs"]), wd, ctx.dictionary)
                    for dev in dict.fromkeys(self.devices):
                        if dev.type == "cuda":
                            torch.cuda.synchronize(dev)
                finally:
                    region.unpin_scan()
        self.count(fused_builds=1, fused_regions_built=built)
        return {"regions_built": built, "manifests": len(manifests),
                "ms": round((time.perf_counter() - t0) * 1e3, 1)}


def _encode_host_tiles(
    dictionary: TableDictionary,
    table: pa.Table,
    columns: list[str],
    tag_cols: list[str],
    ts_col: str | None,
):
    """Shared host encode for SST files and memtable tails: tag strings ->
    dictionary codes (growing the dictionary), ts -> int64, values ->
    numeric.  Returns (cols, nulls, epochs, nbytes) of unpadded numpy
    arrays, or None when a column cannot tile."""
    cols: dict[str, np.ndarray] = {}
    nulls: dict[str, np.ndarray] = {}
    epochs: dict[str, int] = {}
    nbytes = 0
    for name in columns:
        col = table[name]
        if name in tag_cols:
            dictionary.update(name, col)
            np_arr = dictionary.encode(name, col)
            epochs[name] = dictionary.epoch
        elif name == ts_col:
            np_arr = np.asarray(pc.cast(col, pa.int64()).to_numpy(zero_copy_only=False))
        else:
            np_arr = _value_to_numpy(col)
            if np_arr is None:
                return None
            if col.null_count:
                present = np.asarray(pc.is_valid(col).to_numpy(zero_copy_only=False), bool)
                nulls[name] = present
                nbytes += present.nbytes
        cols[name] = np.ascontiguousarray(np_arr)
        nbytes += np_arr.nbytes
    return cols, nulls, epochs, nbytes


def _value_to_numpy(col) -> np.ndarray | None:
    t = col.type
    if pa.types.is_dictionary(t):
        col = pc.cast(col, t.value_type)
        t = t.value_type
    if not (pa.types.is_floating(t) or pa.types.is_integer(t) or pa.types.is_boolean(t)):
        return None
    arr = col.to_numpy(zero_copy_only=False)
    if arr.dtype == object:
        arr = np.array([0 if v is None else v for v in arr], dtype=np.float64)
    elif np.issubdtype(arr.dtype, np.floating):
        arr = np.nan_to_num(arr, nan=0.0)
    elif arr.dtype == bool:
        arr = arr.astype(np.float32)
    return arr
