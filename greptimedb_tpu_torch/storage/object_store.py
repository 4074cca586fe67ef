"""Object-store abstraction under SSTs and manifests: the local-filesystem
backend only.

Counterpart of `greptimedb_tpu/storage/object_store.py` with the remote
backends and cache layers cut (listed in ROADMAP.md).  Keys are
forward-slash relative paths ("region_7/sst/abc.parquet"); the on-disk
layout is the reference package's, so either package opens the other's
data home.
"""

from __future__ import annotations

import os


class ObjectStore:
    """Minimal blob-store interface."""

    def read(self, key: str) -> bytes:
        raise NotImplementedError

    def read_range(self, key: str, offset: int, length: int) -> bytes:
        """`length` bytes at `offset` (a puffin sidecar's footer and blobs)."""
        return self.read(key)[offset : offset + length]

    def size(self, key: str) -> int:
        return len(self.read(key))

    def write(self, key: str, data: bytes) -> None:
        """Atomic full-object write."""
        raise NotImplementedError

    def put_file(self, key: str, local_src: str) -> None:
        raise NotImplementedError

    def open_input(self, key: str):
        """Something pyarrow can read: a filesystem path."""
        raise NotImplementedError

    def exists(self, key: str) -> bool:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def list(self, prefix: str = "") -> list[str]:
        """Keys under prefix (non-recursive names, like a directory listing)."""
        raise NotImplementedError

    def scoped(self, prefix: str) -> "ObjectStore":
        raise NotImplementedError

    def scratch_path(self, key: str) -> str:
        raise NotImplementedError

    def purge_incomplete(self, prefix: str = "") -> None:
        """Remove leftovers of writes that crashed mid-flight."""


class FsObjectStore(ObjectStore):
    """Local-filesystem backend; writes are tmp+rename atomic."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _p(self, key: str) -> str:
        return os.path.join(self.root, *key.split("/"))

    def read(self, key: str) -> bytes:
        with open(self._p(key), "rb") as f:
            return f.read()

    def read_range(self, key: str, offset: int, length: int) -> bytes:
        with open(self._p(key), "rb") as f:
            f.seek(offset)
            return f.read(length)

    def size(self, key: str) -> int:
        return os.path.getsize(self._p(key))

    def write(self, key: str, data: bytes) -> None:
        path = self._p(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def put_file(self, key: str, local_src: str) -> None:
        path = self._p(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        os.replace(local_src, path)

    def open_input(self, key: str):
        return self._p(key)

    def exists(self, key: str) -> bool:
        return os.path.exists(self._p(key))

    def delete(self, key: str) -> None:
        try:
            os.remove(self._p(key))
        except FileNotFoundError:
            pass

    def list(self, prefix: str = "") -> list[str]:
        d = self._p(prefix) if prefix else self.root
        if not os.path.isdir(d):
            return []
        return [n for n in os.listdir(d) if not n.endswith(".tmp")]

    def scoped(self, prefix: str) -> "FsObjectStore":
        """A view of this store under `prefix` (same files as a prefixed key)."""
        return FsObjectStore(self._p(prefix))

    def scratch_path(self, key: str) -> str:
        path = self._p(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        return path + ".scratch"

    def purge_incomplete(self, prefix: str = "") -> None:
        d = self._p(prefix) if prefix else self.root
        if not os.path.isdir(d):
            return
        for name in os.listdir(d):
            if name.endswith((".tmp", ".scratch")):
                try:
                    os.remove(os.path.join(d, name))
                except FileNotFoundError:
                    pass
