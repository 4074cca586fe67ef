"""Query engine facade: parse -> plan -> execute (device or CPU backend).

Counterpart of `greptimedb_tpu/query/engine.py`.  With
`query.backend = "torch"` a plan that `try_lower` proves lowerable runs on
the configured torch device (query/device_exec.py); a plan it declines
runs on the authoritative Arrow executor, and is counted.  With
`backend = "cpu"` everything runs on the Arrow executor.

A device-path failure (a kernel build or launch, a malformed operand)
raises: a lowered query is never served from the CPU executor instead,
so a broken device path cannot hide behind correct CPU answers.

The `cost_route` pass (reference `engine.py:118-151`), with
`query.tpu_min_rows` > 0: a lowered query whose row estimate
(`_estimate_scan_rows`: file rows in the window plus memtable rows,
scaled by the tag equalities' selectivity from the dictionary) falls
below it runs on the CPU executor while no super-tile of its table is
resident (`_tiles_resident`); counted in `routed_to_cpu`.

With `query.tile_cache_enable` (the default) and a tile context
provider, a lowered query tries the device-resident super-tile path first
(parallel/tile_executor.py); the cache and its executor live on the
engine's device and are built at the first such query.

`stats` counts, per engine: `lowered` (queries answered on the device,
by either path), `declined` (queries try_lower declined, and table-fed
queries whose padded group space reaches 2^31 — the int32 ids cannot
hold it),
`tile_dispatches` (lowered queries the tile path answered) and
`tile_declined` (lowered queries it declined, answered by the table-fed
path), from the first one on (read them with `stats.get`)
`host_fast_path` and `cold_serves` (tile-path queries a host route
answered, with no upload and no launch: the reference's
TILE_HOST_FAST_PATH and TILE_COLD_SERVES) and `routed_to_cpu` (lowered
queries `cost_route` sent to the CPU executor), and, per query the tile
path dispatched, the strategy of its first plan, `agg_hash` or
`agg_sort`, and `agg_hash_overflow` (hash dispatches whose slot table
overflowed) — the reference's
AGG_STRATEGY_TOTAL{strategy} and AGG_HASH_OVERFLOW; `limb_reruns`
(tile queries rerun in f64 after a failed limb verdict); and the
dashboard tick (parallel/batcher.py, the reference's QUERY_BATCH_*):
`batch_ticks` (ticks of two or more members), `batch_members` (members
they served), `batch_fused_dispatches` (ticks answered by one tick
program), `tick_graph_captures` (tick programs built: on the card, a
CUDA graph captured), `tick_graph_replays` (tick program runs: on the
card, one graph replay each) and `result_cache_hits` (queries the
windowed result cache served with no dispatch); and, from the first
one on, `mesh_dispatches` (tile dispatches and TQL range evaluations run
over the `tile.mesh_devices` mesh, the reference's
TILE_MESH_DISPATCHES; read it with `stats.get`).  The counters are bumped
under a lock: the members of a tick run on their own threads.
`last_timings` holds the per-stage host wall ms of the calling thread's
last lowered query and `last_path` which path answered its last query:
"tile", "table", or "cpu" where the device executor declined it (or
`cost_route` sent it there).

PromQL (query/promql/) counts its range evaluations here too:
`tql_tile_dispatches` (answered by the warm tile program),
`tql_tile_declined` (the tile path declined a shape and the legacy path
answered), `tql_tile_cold_serves` (a family's first touch under the fused
build: the legacy path answered and the family's build was queued) and
`tql_legacy` (evaluations on the legacy path, declined, cold-served or
with `tql.tile` off; the fused builder's ghost runs count none of these);
`last_tql_timings` holds the host ms per stage of the calling thread's
last TQL statement.
"""

from __future__ import annotations

import threading

import pyarrow as pa

from ..datatypes.schema import Schema
from ..utils.config import BatchConfig, QueryConfig, TileConfig
from . import passes
from .cpu_exec import CpuExecutor
from .device_exec import DeviceExecutor, try_lower
from .logical_plan import LogicalPlan, TableScan
from .planner import plan_query
from .sql_parser import SelectStmt


class QueryEngine:
    def __init__(
        self,
        schema_provider,
        scan_provider,
        region_scan_provider,
        time_bounds_provider,
        config: QueryConfig | None = None,
        tile_context_provider=None,
        tile_config: TileConfig | None = None,
        batch_config: BatchConfig | None = None,
        vector_search_provider=None,
    ):
        """
        schema_provider(table, database) -> Schema
        scan_provider(scan: TableScan) -> pa.Table           (merged regions)
        region_scan_provider(scan) -> list[pa.Table]         (one per region)
        time_bounds_provider(table, database) -> (min_ts, max_ts)
        tile_context_provider(scan) -> TileContext | None    (the tile path)
        vector_search_provider(vs: VectorSearch) -> pa.Table (top-k rows;
            the CPU executor calls it on either backend, as the reference)
        """
        self.config = config or QueryConfig()
        self.tile_config = tile_config or TileConfig()
        self.batch_config = batch_config or BatchConfig()
        if self.config.backend not in ("torch", "cpu"):
            raise ValueError(
                f"query backend {self.config.backend!r}: use 'torch' or 'cpu'"
            )
        self.schema_of = schema_provider
        self.cpu = CpuExecutor(scan_provider, vector_search_provider)
        self._region_scan = region_scan_provider
        self._time_bounds = time_bounds_provider
        self._tile_ctx = tile_context_provider
        self.tile_cache = None
        self._tile_executor = None
        from ..parallel.tile_executor import Counters

        self.stats = Counters({
            "lowered": 0, "declined": 0, "tile_dispatches": 0, "tile_declined": 0,
            "agg_hash": 0, "agg_sort": 0, "agg_hash_overflow": 0, "limb_reruns": 0,
            "tql_tile_dispatches": 0, "tql_tile_declined": 0, "tql_legacy": 0,
            "batch_ticks": 0, "batch_members": 0, "batch_fused_dispatches": 0,
            "tick_graph_captures": 0, "tick_graph_replays": 0, "result_cache_hits": 0,
        })
        self._local = threading.local()

    # per-stage host wall ms of the calling thread's last lowered query
    # (DeviceExecutor), and which path answered it
    @property
    def last_timings(self) -> dict[str, float]:
        return getattr(self._local, "timings", {})

    @last_timings.setter
    def last_timings(self, value) -> None:
        self._local.timings = value

    # per-stage host wall ms of the calling thread's last TQL statement
    # (query/promql/)
    @property
    def last_tql_timings(self) -> dict[str, float]:
        t = getattr(self._local, "tql_timings", None)
        if t is None:
            t = self._local.tql_timings = {}
        return t

    @last_tql_timings.setter
    def last_tql_timings(self, value) -> None:
        self._local.tql_timings = value

    @property
    def last_path(self) -> str:
        return getattr(self._local, "path", "")

    @last_path.setter
    def last_path(self, value) -> None:
        self._local.path = value

    def tile_executor(self):
        """The engine's tile executor (built on first use), or None when the
        tile cache is off or there is no context provider."""
        if not self.config.tile_cache_enable or self._tile_ctx is None:
            return None
        if self._tile_executor is None:
            import torch

            from ..parallel.tile_executor import TileExecutor
            from ..parallel.tile_planes import TileCacheManager, device_budget

            device = torch.device(self.config.first_device)
            self.tile_cache = TileCacheManager(
                device_budget(self.config.tile_cache_mb, device),
                chunk_rows=self.config.tile_chunk_rows,
                device=self.mesh,
                config=self.config,
                tile_config=self.tile_config,
            )
            self._tile_executor = TileExecutor(self.tile_cache, self.config,
                                               batch_config=self.batch_config, stats=self.stats)
        return self._tile_executor

    @property
    def mesh(self):
        """Every listed device slot (parallel/mesh.py), the first being
        `config.first_device`: the table-fed route runs over all of them,
        the tile path over the first `tile.mesh_devices`."""
        from ..parallel.mesh import make_mesh

        return make_mesh(devices=self.config.slots)

    def execute_select(self, stmt: SelectStmt, database: str = "public") -> pa.Table:
        plan, schema = plan_query(stmt, self.schema_of, database)
        return self.execute_plan(plan, schema)

    def execute_plan(self, plan: LogicalPlan, schema: Schema) -> pa.Table:
        if self.config.backend != "torch" or not schema.columns:
            return self.cpu.execute(plan)
        lowering = try_lower(plan, schema)
        if lowering is None:
            self.stats.add(declined=1)
            self.last_path = "cpu"
            return self.cpu.execute(plan)
        if self._cost_routed(lowering, schema):
            self.stats.add(routed_to_cpu=1)
            self.last_path = "cpu"
            return self.cpu.execute(plan)
        scan = lowering.scan
        tile = self.tile_executor()
        if tile is not None:
            tile.last_strategy, tile.last_hash_overflow = None, False
        device = DeviceExecutor(self._region_scan, self.mesh, tile_executor=tile,
                                tile_context_provider=self._tile_ctx)
        table = device.execute(
            lowering,
            schema,
            time_bounds=lambda: self._time_bounds(scan.table, scan.database),
        )
        if table is None:
            # the table-fed path declined a shape (a group space past int32)
            self.stats.add(declined=1)
            self.last_path = "cpu"
            return self.cpu.execute(plan)
        counts = {"lowered": 1}
        if tile is not None:
            counts["tile_dispatches" if device.path == "tile" else "tile_declined"] = 1
            if tile.last_strategy is not None:
                counts["agg_" + tile.last_strategy] = 1
            counts["agg_hash_overflow"] = int(tile.last_hash_overflow)
        self.stats.add(**counts)
        self.last_timings = device.timings
        self.last_path = device.path
        return table

    def _cost_routed(self, lowering, schema: Schema) -> bool:
        """The `cost_route` pass: True when the scan's estimate is under
        `tpu_min_rows` and no super-tile of its table is resident (a
        resident one serves a small query faster on the tile path)."""
        if (self.config.tpu_min_rows <= 0 or self._tile_ctx is None
                or not passes.enabled("cost_route", self.config)):
            return False
        est = self._estimate_scan_rows(lowering.scan, schema)
        if est is not None and est < self.config.tpu_min_rows \
                and not self._tiles_resident(lowering.scan):
            passes.note("cost_route", True,
                        f"estimated {est} rows < tpu_min_rows={self.config.tpu_min_rows} and "
                        "tiles not resident: local CPU path", est_rows=est)
            return True
        passes.note("cost_route", False,
                    "scan large enough (or tiles resident) for the device path", est_rows=est)
        return False

    def _tiles_resident(self, scan: TableScan) -> bool:
        """Every region of the scanned table has a cached super-tile."""
        if self.tile_cache is None:
            return False
        ctx = self._tile_ctx(scan)
        if ctx is None or not ctx.regions:
            return False
        return all(self.tile_cache.has_region(r.region_id) for r in ctx.regions)

    def _estimate_scan_rows(self, scan: TableScan, schema: Schema) -> int | None:
        """The routing estimate: file rows intersecting the time window plus
        memtable rows, scaled by the selectivity of tag equalities (`=`:
        1 / cardinality, `IN`: n / cardinality) from the dictionary; None
        when the scan has no table to tile."""
        ctx = self._tile_ctx(scan)
        if ctx is None:
            return None
        window = scan.time_range
        rows = 0
        for region in ctx.regions:
            files, mems, _v = region.tile_snapshot()
            for meta in files:
                lo, hi = meta.time_range
                if window is None or (hi >= window[0] and lo < window[1]):
                    rows += meta.num_rows
            for mem in mems:
                rows += mem.num_rows
        sel = 1.0
        if ctx.dictionary is not None:
            tag_names = {c.name for c in schema.tag_columns()}
            for name, op, value in scan.filters:
                if name in tag_names:
                    card = max(ctx.dictionary.cardinality(name), 1)
                    if op == "=":
                        sel /= card
                    elif op == "in":
                        sel *= min(len(value) / card, 1.0)
        return int(rows * sel)

    def explain(self, stmt: SelectStmt, database: str = "public") -> pa.Table:
        plan, schema = plan_query(stmt, self.schema_of, database)
        lowered = try_lower(plan, schema) if schema.columns else None
        lines = plan.describe().split("\n")
        backend = [self.config.backend if lowered is not None else "cpu"] * len(lines)
        return pa.table({"plan": lines, "backend": backend})
