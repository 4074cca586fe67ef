"""Region manifest: an append log of metadata actions with checkpoints.

Role-equivalent of the reference's `RegionManifestManager` (reference
src/mito2/src/manifest/manager.rs:152): every region mutation (flush adds
files, compaction swaps files, truncate clears) appends a `RegionMetaAction`
delta; every `checkpoint_distance` versions the full state is compacted into
a checkpoint so region open replays O(checkpoint_distance) deltas instead of
the whole history.
"""

from __future__ import annotations

import json
import os
import threading
import uuid
from dataclasses import dataclass, field

from ..datatypes.schema import Schema
from ..utils.errors import StorageError
from .sst import FileMeta


@dataclass
class RegionManifest:
    """Materialized manifest state (reference manifest/action.rs:118)."""

    region_id: int
    schema: Schema | None = None
    files: dict[str, FileMeta] = field(default_factory=dict)
    flushed_entry_id: int = 0
    flushed_sequence: int = 0
    manifest_version: int = 0
    truncated_entry_id: int | None = None

    def to_dict(self) -> dict:
        return {
            "region_id": self.region_id,
            "schema": self.schema.to_json() if self.schema else None,
            "files": {k: v.to_dict() for k, v in self.files.items()},
            "flushed_entry_id": self.flushed_entry_id,
            "flushed_sequence": self.flushed_sequence,
            "manifest_version": self.manifest_version,
            "truncated_entry_id": self.truncated_entry_id,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "RegionManifest":
        return cls(
            region_id=d["region_id"],
            schema=Schema.from_json(d["schema"]) if d.get("schema") else None,
            files={k: FileMeta.from_dict(v) for k, v in d["files"].items()},
            flushed_entry_id=d.get("flushed_entry_id", 0),
            flushed_sequence=d.get("flushed_sequence", 0),
            manifest_version=d.get("manifest_version", 0),
            truncated_entry_id=d.get("truncated_entry_id"),
        )


class ManifestManager:
    """Per-region manifest log under `{dir}/manifest/`.

    Files: `{version:020d}.json` delta actions, `{version:020d}.checkpoint.json`
    checkpoints (full state).  Recovery loads the newest checkpoint then
    replays newer deltas, exactly the reference's scheme.
    """

    def __init__(
        self,
        store_or_dir,
        region_id: int,
        checkpoint_distance: int = 10,
    ):
        from .object_store import FsObjectStore, ObjectStore

        if isinstance(store_or_dir, ObjectStore):
            self.store = store_or_dir.scoped("manifest")
        else:
            self.store = FsObjectStore(os.path.join(store_or_dir, "manifest"))
        self.region_id = region_id
        self.checkpoint_distance = checkpoint_distance
        self._lock = threading.Lock()
        # A crash mid-write can leave fs .tmp leftovers; clean them before
        # recovery so they never accumulate (the pre-object-store code did
        # this during checkpoint GC).
        self.store.purge_incomplete()
        self.manifest = self._recover()

    # ---- actions ----------------------------------------------------------
    def apply(self, action: dict) -> RegionManifest:
        """Append one action and apply it to the in-memory state.

        Action kinds (reference RegionMetaAction):
          {"kind": "change", "schema": <json>}                      — DDL
          {"kind": "edit", "files_to_add": [...], "files_to_remove": [...],
           "flushed_entry_id": N, "flushed_sequence": N}            — flush/compaction
          {"kind": "truncate", "truncated_entry_id": N}             — truncate
        """
        with self._lock:
            version = self.manifest.manifest_version + 1
            # writer-unique suffix: two region holders racing one version
            # slot (transient split-brain during failover) must never
            # OVERWRITE each other's edit — a lost files_to_remove leaves
            # the manifest referencing deleted SSTs forever.  Both edits
            # survive and replay deterministically; adds/removes are
            # idempotent under re-application.
            uid = uuid.uuid4().hex[:8]
            self.store.write(
                f"{version:020d}.{uid}.json", json.dumps(action).encode()
            )
            self._apply_in_memory(action, version)
            if version % self.checkpoint_distance == 0:
                self._write_checkpoint()
            return self.manifest

    def _apply_in_memory(self, action: dict, version: int, manifest: RegionManifest | None = None):
        m = manifest if manifest is not None else self.manifest
        kind = action.get("kind")
        if kind == "change":
            m.schema = Schema.from_json(action["schema"])
        elif kind == "edit":
            anchor = action.get("insert_at")
            if anchor is not None and anchor in m.files:
                # ordered insertion (compaction): the merged output takes
                # the manifest position of its NEWEST input, so files
                # flushed DURING the merge stay newer than it — scans rank
                # duplicate (pk, ts) versions by manifest position, and an
                # appended output would beat data that overwrote its
                # inputs mid-compaction.  Dict rebuild preserves replay
                # determinism (the anchor rides the persisted action).
                rebuilt: dict[str, FileMeta] = {}
                removes = set(action.get("files_to_remove", []))
                for k, v in m.files.items():
                    if k == anchor:
                        # adds insert AT the anchor's slot (before it, if
                        # the anchor itself survives the edit)
                        for fd in action.get("files_to_add", []):
                            meta = FileMeta.from_dict(fd)
                            rebuilt[meta.file_id] = meta
                    if k not in removes:
                        rebuilt[k] = v
                m.files = rebuilt
            else:
                for fd in action.get("files_to_add", []):
                    meta = FileMeta.from_dict(fd)
                    m.files[meta.file_id] = meta
            for fid in action.get("files_to_remove", []):
                m.files.pop(fid, None)
            if action.get("flushed_entry_id") is not None:
                m.flushed_entry_id = max(m.flushed_entry_id, action["flushed_entry_id"])
            if action.get("flushed_sequence") is not None:
                m.flushed_sequence = max(m.flushed_sequence, action["flushed_sequence"])
        elif kind == "truncate":
            m.files.clear()
            m.truncated_entry_id = action.get("truncated_entry_id")
            m.flushed_entry_id = max(m.flushed_entry_id, action.get("truncated_entry_id") or 0)
        else:
            raise StorageError(f"unknown manifest action kind: {kind}")
        m.manifest_version = version

    # ---- checkpointing / recovery -----------------------------------------
    def _write_checkpoint(self):
        version = self.manifest.manifest_version
        # uid keeps two holders' same-version checkpoints from silently
        # overwriting each other; recovery picks the lexically-last
        self.store.write(
            f"{version:020d}.{uuid.uuid4().hex[:8]}.checkpoint.json",
            json.dumps(self.manifest.to_dict()).encode(),
        )
        # GC keeps a TRAILING WINDOW of deltas (2x checkpoint distance)
        # below the checkpoint, not just same-version ones: a concurrent
        # holder (transient split-brain) may have written edits at any
        # recent version our checkpoint never saw — deleting them loses
        # file adds/removes permanently.  The alive keeper closes stale
        # holders within seconds, so the window comfortably covers the
        # race; replay re-applies windowed deltas idempotently.
        keep_from = version - 2 * self.checkpoint_distance
        for name in self.store.list():
            v = _version_of(name)
            if v is not None and v < keep_from:
                self.store.delete(name)

    def _recover(self) -> RegionManifest:
        names = [n for n in self.store.list() if n.endswith(".json")]
        ckpts = sorted(n for n in names if n.endswith(".checkpoint.json"))
        deltas = sorted(n for n in names if not n.endswith(".checkpoint.json"))
        manifest = RegionManifest(region_id=self.region_id)
        base_version = 0
        if ckpts:
            manifest = RegionManifest.from_dict(json.loads(self.store.read(ckpts[-1])))
            base_version = manifest.manifest_version
        for name in deltas:
            v = _version_of(name)
            # re-apply the trailing delta window over the checkpoint
            # (idempotent adds/removes; concurrent-holder edits the
            # checkpoint never saw get incorporated here)
            if v is None or v < base_version - 2 * self.checkpoint_distance:
                continue
            action = json.loads(self.store.read(name))
            self._apply_in_memory(action, v, manifest=manifest)
        return manifest

    def refresh(self) -> tuple[RegionManifest, bool]:
        """Re-read the manifest log from shared storage and adopt the fresh
        state when another holder (the region's LEADER — this is the
        follower-replica path) advanced it; returns (manifest, changed).

        Read-only by construction: recovery never writes, so a follower can
        refresh on a cadence without racing the leader's appends.  A delta
        or checkpoint GC'd between list and read surfaces as a transient
        error the caller retries next round — the previous view stays
        installed, never a half-applied one."""
        with self._lock:
            fresh = self._recover()
            if fresh.manifest_version <= self.manifest.manifest_version:
                return self.manifest, False
            self.manifest = fresh
            return fresh, True

    def destroy(self):
        for name in self.store.list():
            self.store.delete(name)


def _version_of(name: str) -> int | None:
    stem = name.split(".")[0]
    return int(stem) if stem.isdigit() else None
