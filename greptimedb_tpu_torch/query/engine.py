"""Query engine facade: parse -> plan -> execute (device or CPU backend).

Counterpart of `greptimedb_tpu/query/engine.py`.  With
`query.backend = "torch"` a plan that `try_lower` proves lowerable runs on
the configured torch device (query/device_exec.py); a plan it declines
runs on the authoritative Arrow executor, and is counted.  With
`backend = "cpu"` everything runs on the Arrow executor.

A device-path failure (a kernel build or launch, a malformed operand)
raises: a lowered query is never served from the CPU executor instead,
so a broken device path cannot hide behind correct CPU answers.

`stats` counts, per engine: `lowered` (queries answered on the device)
and `declined` (queries try_lower declined); `last_timings` holds the
per-stage host wall ms of the last lowered query.
"""

from __future__ import annotations

import pyarrow as pa

from ..datatypes.schema import Schema
from ..utils.config import QueryConfig
from .cpu_exec import CpuExecutor
from .device_exec import DeviceExecutor, try_lower
from .logical_plan import LogicalPlan
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
    ):
        """
        schema_provider(table, database) -> Schema
        scan_provider(scan: TableScan) -> pa.Table           (merged regions)
        region_scan_provider(scan) -> list[pa.Table]         (one per region)
        time_bounds_provider(table, database) -> (min_ts, max_ts)
        """
        self.config = config or QueryConfig()
        if self.config.backend not in ("torch", "cpu"):
            raise ValueError(
                f"query backend {self.config.backend!r}: use 'torch' or 'cpu'"
            )
        self.schema_of = schema_provider
        self.cpu = CpuExecutor(scan_provider)
        self._region_scan = region_scan_provider
        self._time_bounds = time_bounds_provider
        self.stats = {"lowered": 0, "declined": 0}
        # per-stage host wall ms of the last lowered query (DeviceExecutor)
        self.last_timings: dict[str, float] = {}

    def execute_select(self, stmt: SelectStmt, database: str = "public") -> pa.Table:
        plan, schema = plan_query(stmt, self.schema_of, database)
        return self.execute_plan(plan, schema)

    def execute_plan(self, plan: LogicalPlan, schema: Schema) -> pa.Table:
        if self.config.backend != "torch" or not schema.columns:
            return self.cpu.execute(plan)
        lowering = try_lower(plan, schema)
        if lowering is None:
            self.stats["declined"] += 1
            return self.cpu.execute(plan)
        scan = lowering.scan
        device = DeviceExecutor(self._region_scan, self.config.device)
        table = device.execute(
            lowering,
            schema,
            time_bounds=lambda: self._time_bounds(scan.table, scan.database),
        )
        self.stats["lowered"] += 1
        self.last_timings = device.timings
        return table

    def explain(self, stmt: SelectStmt, database: str = "public") -> pa.Table:
        plan, schema = plan_query(stmt, self.schema_of, database)
        lowered = try_lower(plan, schema) if schema.columns else None
        lines = plan.describe().split("\n")
        backend = [self.config.backend if lowered is not None else "cpu"] * len(lines)
        return pa.table({"plan": lines, "backend": backend})
