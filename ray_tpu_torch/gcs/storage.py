"""GCS table storage over a pluggable store client.

A port of ``ray_tpu.gcs.storage`` (reference
``src/ray/gcs/gcs_server/gcs_table_storage.{h,cc}`` and
``src/ray/gcs/store_client/``): ``GcsTable`` over an in-memory store
(``InMemoryStoreClient``, the default) or a file-backed one
(``FileStoreClient``) that journals every write, so that a restarted GCS
reloads its tables (``gcs_init_data.cc``).  Plain ``threading`` locks
stand in for the reference's lock-order witness (ROADMAP A.4b.7).
"""

from __future__ import annotations

import os
import pickle
import threading
from typing import Any, Dict, Iterator, Optional, Tuple


class StoreClient:
    """Abstract key-value store with (table, key) namespacing."""

    def put(self, table: str, key: bytes, value: Any) -> None:
        raise NotImplementedError

    def get(self, table: str, key: bytes) -> Optional[Any]:
        raise NotImplementedError

    def delete(self, table: str, key: bytes) -> bool:
        raise NotImplementedError

    def get_all(self, table: str) -> Iterator[Tuple[bytes, Any]]:
        raise NotImplementedError

    def keys(self, table: str, prefix: bytes = b"") -> list:
        raise NotImplementedError


class InMemoryStoreClient(StoreClient):
    def __init__(self):
        self._lock = threading.RLock()
        self._tables: Dict[str, Dict[bytes, Any]] = {}

    def put(self, table, key, value):
        with self._lock:
            self._tables.setdefault(table, {})[key] = value

    def get(self, table, key):
        with self._lock:
            return self._tables.get(table, {}).get(key)

    def delete(self, table, key):
        with self._lock:
            return self._tables.get(table, {}).pop(key, None) is not None

    def get_all(self, table):
        with self._lock:
            return list(self._tables.get(table, {}).items())

    def keys(self, table, prefix=b""):
        with self._lock:
            return [k for k in self._tables.get(table, {})
                    if k.startswith(prefix)]


class FileStoreClient(InMemoryStoreClient):
    """The in-memory store journaled to ``path``, replayed on
    construction: it survives a GCS restart (the Redis-backed store's
    part in the reference's fault-tolerance tests).  ``close`` closes
    the journal; a restarted GCS opens its own."""

    def __init__(self, path: str):
        super().__init__()
        self._path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._journal_lock = threading.Lock()
        if os.path.exists(path):
            self._replay()
        self._journal = open(path, "ab")

    def _replay(self):
        with open(self._path, "rb") as f:
            while True:
                try:
                    op, table, key, value = pickle.load(f)
                except EOFError:
                    break
                except Exception:
                    break  # a truncated tail from a crash: drop it
                if op == "put":
                    super().put(table, key, value)
                else:
                    super().delete(table, key)

    def _append(self, record):
        with self._journal_lock:
            pickle.dump(record, self._journal)
            self._journal.flush()

    def put(self, table, key, value):
        super().put(table, key, value)
        self._append(("put", table, key, value))

    def delete(self, table, key):
        existed = super().delete(table, key)
        if existed:
            self._append(("del", table, key, None))
        return existed

    def journal_bytes(self) -> int:
        with self._journal_lock:
            return self._journal.tell()

    def close(self) -> None:
        with self._journal_lock:
            self._journal.close()


class GcsTable:
    """Typed view over one table (``GcsTable<Key, Data>``)."""

    def __init__(self, store: StoreClient, name: str):
        self._store = store
        self._name = name

    def put(self, key, value):
        self._store.put(self._name, self._key(key), value)

    def get(self, key):
        return self._store.get(self._name, self._key(key))

    def delete(self, key):
        return self._store.delete(self._name, self._key(key))

    def get_all(self):
        return self._store.get_all(self._name)

    @staticmethod
    def _key(key) -> bytes:
        if isinstance(key, bytes):
            return key
        if hasattr(key, "binary"):
            return key.binary()
        return str(key).encode()


class GcsTableStorage:
    """Every GCS table (``gcs_table_storage.h:345``)."""

    def __init__(self, store: StoreClient):
        self.store = store
        self.job_table = GcsTable(store, "job")
        self.actor_table = GcsTable(store, "actor")
        self.node_table = GcsTable(store, "node")
        self.node_resource_table = GcsTable(store, "node_resource")
        self.placement_group_table = GcsTable(store, "placement_group")
        self.worker_table = GcsTable(store, "worker")
        self.kv_table = GcsTable(store, "internal_kv")
