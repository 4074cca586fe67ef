"""Configuration for the port: storage, query and the device.

Counterpart of `greptimedb_tpu/utils/config.py`, reduced to the sections
this slice runs (`Config`, `StorageConfig`, `QueryConfig`).  Differences
that matter:

* `QueryConfig.device` names the torch device the lowered query path runs on
  (`"cuda"` by default, `"cpu"` for the tests).  Nothing probes for a
  card to pick one: `Database(device="cuda")` without a card raises.
* `QueryConfig.backend` is `"torch"` (the lowered device path) or `"cpu"`
  (the authoritative Arrow executor).
* There is no `fallback_to_cpu`: a device-path failure raises instead of
  being served silently from the CPU executor.

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
    # the torch device the lowered path runs on
    device: str = "cuda"


@dataclasses.dataclass
class Config:
    storage: StorageConfig = dataclasses.field(default_factory=StorageConfig)
    query: QueryConfig = dataclasses.field(default_factory=QueryConfig)
