"""Catalog: databases -> tables -> regions, persisted in a KV-style store.

Role-equivalent of the reference's catalog + table metadata plane
(reference catalog/src/kvbackend/, common/meta/src/key.rs:389
`TableMetadataManager`): table ids are allocated from a sequence, table
metadata (schema, partition rule, region ids) lives in a JSON KV file, and
region ids are derived as table_id * MAX_REGIONS + seq (matching the
reference's RegionId = (table_id << 32) | region_seq encoding).
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass, field

from ..datatypes.schema import Schema
from ..utils.errors import (
    DatabaseNotFoundError,
    TableAlreadyExistsError,
    TableNotFoundError,
)
from .partition import PartitionRule, SingleRegionRule

MAX_REGIONS_PER_TABLE = 1 << 10
DEFAULT_CATALOG = "greptime"
DEFAULT_SCHEMA = "public"


def region_id(table_id: int, seq: int) -> int:
    return table_id * MAX_REGIONS_PER_TABLE + seq


@dataclass
class TableMeta:
    table_id: int
    name: str
    database: str
    schema: Schema
    partition_rule: PartitionRule = field(default_factory=SingleRegionRule)
    options: dict = field(default_factory=dict)
    # Region-id generation offset: repartition allocates the new partition
    # set at a fresh base so old and staging region ids never collide
    # (reference repartition RFC's staging regions).
    region_id_base: int = 0

    @property
    def region_ids(self) -> list[int]:
        return [
            region_id(self.table_id, self.region_id_base + i)
            for i in range(self.partition_rule.num_partitions())
        ]

    def to_dict(self) -> dict:
        return {
            "table_id": self.table_id,
            "name": self.name,
            "database": self.database,
            "schema": self.schema.to_json(),
            "partition_rule": self.partition_rule.to_dict(),
            "options": self.options,
            "region_id_base": self.region_id_base,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "TableMeta":
        return cls(
            table_id=d["table_id"],
            name=d["name"],
            database=d["database"],
            schema=Schema.from_json(d["schema"]),
            partition_rule=PartitionRule.from_dict(d["partition_rule"]),
            options=d.get("options", {}),
            region_id_base=d.get("region_id_base", 0),
        )


class Catalog:
    """In-process catalog with optional file persistence.

    With `path=None` it is the reference's memory catalog (tests); with a
    path it journals every mutation, the reference's KV-backed catalog.
    """

    def __init__(self, path: str | None = None):
        self.path = path
        self._lock = threading.RLock()
        self._databases: dict[str, dict[str, TableMeta]] = {DEFAULT_SCHEMA: {}}
        self._views: dict[str, dict[str, str]] = {}  # db -> name -> SQL text
        self._next_table_id = 1024  # reference reserves low ids for system tables
        # Bumped on every mutation — plan caches key on it so DDL invalidates
        # cached plans (the reference invalidates via KV cache broadcasts).
        self.revision = 0
        self._loaded_stat: tuple | None = None  # (mtime_ns, size) at last load
        if path and os.path.exists(path):
            self._load()

    # ---- databases --------------------------------------------------------
    def create_database(self, name: str, if_not_exists: bool = False):
        with self._ddl_guard():
            if name in self._databases:
                if if_not_exists:
                    return
                raise TableAlreadyExistsError(f"database {name!r} already exists")
            self._databases[name] = {}
            self._persist()

    def drop_database(self, name: str):
        with self._ddl_guard():
            if name not in self._databases:
                raise DatabaseNotFoundError(f"database not found: {name}")
            if name == DEFAULT_SCHEMA:
                raise DatabaseNotFoundError("cannot drop the default database")
            del self._databases[name]
            self._views.pop(name, None)
            self._persist()

    def databases(self) -> list[str]:
        with self._lock:
            return sorted(self._databases)

    def reload(self):
        """Re-read the persisted catalog: multi-process deployments (a
        distributed frontend beside other frontends/standalone tools on
        the same shared storage) see each other's DDL this way — the
        file plays the role of the reference's KV + cache invalidation."""
        with self._lock:
            if self.path and os.path.exists(self.path):
                # unchanged file = no-op: reload is called on every SHOW
                # by multi-process frontends, and an unconditional bump
                # would evict warm plan caches for nothing
                st = os.stat(self.path)
                if self._loaded_stat == (st.st_mtime_ns, st.st_size):
                    return
                self._load()
                self.revision += 1  # invalidate plan caches keyed on it

    def _ddl_guard(self):
        """Cross-PROCESS DDL critical section: an exclusive flock around
        reload -> mutate -> persist.  Without it two frontends over one
        shared catalog file race read-modify-write: both allocate the
        same table_id and the second _persist() erases the first's table
        while its regions stay open (the reference serializes DDL through
        metasrv procedures + KV transactions; the lock file plays the KV
        txn's role here).  In-memory-only catalogs (tests) skip it."""
        from contextlib import contextmanager

        @contextmanager
        def guard():
            with self._lock:
                if not self.path:
                    yield
                    return
                import fcntl

                os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
                with open(self.path + ".lock", "a") as lf:
                    fcntl.flock(lf, fcntl.LOCK_EX)
                    try:
                        if os.path.exists(self.path):
                            st = os.stat(self.path)
                            if self._loaded_stat != (st.st_mtime_ns, st.st_size):
                                self._load()  # another process mutated it
                                self.revision += 1
                        yield
                    finally:
                        fcntl.flock(lf, fcntl.LOCK_UN)

        return guard()

    # ---- tables -----------------------------------------------------------
    def allocate_table_id(self) -> int:
        """Burn a table id WITHOUT publishing a table: the durable
        CreateTable procedure allocates first, creates regions, then
        commits metadata (reference TableMetadataAllocator,
        common/meta/src/ddl/table_meta.rs) — a crash between steps wastes
        the id but can never collide."""
        with self._ddl_guard():
            tid = self._next_table_id
            self._next_table_id += 1
            self._persist()
            return tid

    def create_table(
        self,
        name: str,
        schema: Schema,
        partition_rule: PartitionRule | None = None,
        database: str = DEFAULT_SCHEMA,
        if_not_exists: bool = False,
        options: dict | None = None,
        on_create=None,
        table_id: int | None = None,
    ) -> TableMeta:
        """Create a table. `on_create(meta)` runs under the catalog lock
        before the table becomes visible, so callers can create storage
        regions atomically with the metadata publish (the reference commits
        region creation and KV metadata in one DDL procedure step,
        common/meta/src/ddl/create_table.rs).  `table_id` commits a
        previously `allocate_table_id`-reserved id (procedure path)."""
        with self._ddl_guard():
            db = self._db(database)
            if name in db:
                if if_not_exists:
                    return db[name]
                raise TableAlreadyExistsError(f"table {name!r} already exists")
            meta = TableMeta(
                table_id=table_id if table_id is not None else self._next_table_id,
                name=name,
                database=database,
                schema=schema,
                partition_rule=partition_rule or SingleRegionRule(),
                options=options or {},
            )
            if table_id is None:
                self._next_table_id += 1
            else:
                self._next_table_id = max(self._next_table_id, table_id + 1)
            if on_create is not None:
                on_create(meta)
            db[name] = meta
            self._persist()
            return meta

    def drop_table(self, name: str, database: str = DEFAULT_SCHEMA) -> TableMeta:
        with self._ddl_guard():
            db = self._db(database)
            if name not in db:
                raise TableNotFoundError(f"table not found: {name}")
            meta = db.pop(name)
            self._persist()
            return meta

    def rename_table(
        self, old: str, new: str, database: str = DEFAULT_SCHEMA
    ) -> TableMeta:
        """Rename keeps table_id and regions (the reference's RenameTable
        alter kind rewrites only the name keys, common/meta/src/key/table_name.rs)."""
        with self._ddl_guard():
            db = self._db(database)
            if old not in db:
                raise TableNotFoundError(f"table not found: {database}.{old}")
            if new in db:
                raise TableAlreadyExistsError(f"table {new!r} already exists")
            meta = db.pop(old)
            meta.name = new
            db[new] = meta
            self._persist()
            return meta

    def table(self, name: str, database: str = DEFAULT_SCHEMA) -> TableMeta:
        with self._lock:
            db = self._db(database)
            if name not in db:
                raise TableNotFoundError(f"table not found: {database}.{name}")
            return db[name]

    def has_table(self, name: str, database: str = DEFAULT_SCHEMA) -> bool:
        with self._lock:
            return name in self._databases.get(database, {})

    def tables(self, database: str = DEFAULT_SCHEMA) -> list[TableMeta]:
        with self._lock:
            return sorted(self._db(database).values(), key=lambda m: m.name)

    def update_table(self, meta: TableMeta):
        with self._ddl_guard():
            self._db(meta.database)[meta.name] = meta
            self._persist()

    # ---- views -------------------------------------------------------------
    # Views are stored as their defining SQL text and re-planned at query
    # time (the reference stores view_info in KV and decodes the logical
    # plan, common/meta/src/ddl/create_view.rs + key/view_info.rs).
    def create_view(
        self,
        name: str,
        sql_text: str,
        database: str = DEFAULT_SCHEMA,
        or_replace: bool = False,
        if_not_exists: bool = False,
    ):
        with self._ddl_guard():
            self._db(database)  # validates the database exists
            views = self._views.setdefault(database, {})
            if name in views and not or_replace:
                if if_not_exists:
                    return
                raise TableAlreadyExistsError(f"view {name!r} already exists")
            if self.has_table(name, database):
                raise TableAlreadyExistsError(f"table {name!r} already exists")
            views[name] = sql_text
            self._persist()

    def drop_view(self, name: str, database: str = DEFAULT_SCHEMA, if_exists: bool = False):
        with self._ddl_guard():
            views = self._views.get(database, {})
            if name not in views:
                if if_exists:
                    return
                raise TableNotFoundError(f"view not found: {database}.{name}")
            del views[name]
            self._persist()

    def view(self, name: str, database: str = DEFAULT_SCHEMA) -> str | None:
        with self._lock:
            return self._views.get(database, {}).get(name)

    def views(self, database: str = DEFAULT_SCHEMA) -> dict[str, str]:
        with self._lock:
            return dict(self._views.get(database, {}))

    # ---- persistence ------------------------------------------------------
    def _db(self, database: str) -> dict[str, TableMeta]:
        if database not in self._databases:
            raise DatabaseNotFoundError(f"database not found: {database}")
        return self._databases[database]

    def _persist(self):
        self.revision += 1
        if not self.path:
            return
        state = {
            "next_table_id": self._next_table_id,
            "databases": {
                db: {name: meta.to_dict() for name, meta in tables.items()}
                for db, tables in self._databases.items()
            },
            "views": self._views,
        }
        tmp = self.path + ".tmp"
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(state, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        st = os.stat(self.path)
        self._loaded_stat = (st.st_mtime_ns, st.st_size)  # disk == memory

    def _load(self):
        st = os.stat(self.path)
        self._loaded_stat = (st.st_mtime_ns, st.st_size)
        with open(self.path) as f:
            state = json.load(f)
        self._next_table_id = state["next_table_id"]
        self._databases = {
            db: {name: TableMeta.from_dict(d) for name, d in tables.items()}
            for db, tables in state["databases"].items()
        }
        self._views = state.get("views", {})
        if DEFAULT_SCHEMA not in self._databases:
            self._databases[DEFAULT_SCHEMA] = {}
