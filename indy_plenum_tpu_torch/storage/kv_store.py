"""Key-value storage: uniform API over sqlite / in-memory backends.

Reference: storage/kv_store.py + storage/kv_store_leveldb.py /
kv_store_rocksdb.py / kv_in_memory.py and the ``initKeyValueStorage``
switch in storage/helper.py. This environment has no LevelDB/RocksDB
bindings; sqlite3 (stdlib, C-backed, crash-safe) is the durable backend and
preserves the same iteration/batch semantics. Keys and values are bytes;
iteration is byte-lexicographic as in LevelDB.

Copy of ``indy_plenum_tpu/storage/kv_store.py``,
with its imports bound to the port. The file-backed stores
(``storage/file_stores.py``) come with the deployed-node slice.
"""
from __future__ import annotations

import os
import sqlite3
from abc import ABC, abstractmethod
from typing import Iterable, Iterator, Optional, Tuple

from ..common.exceptions import StorageError


def _to_bytes(x) -> bytes:
    if isinstance(x, bytes):
        return x
    if isinstance(x, str):
        return x.encode()
    if isinstance(x, int):
        return str(x).encode()
    raise StorageError(f"unsupported key/value type {type(x)}")


class KeyValueStorage(ABC):
    @abstractmethod
    def get(self, key) -> bytes:
        """Raises KeyError when absent."""

    @abstractmethod
    def put(self, key, value) -> None:
        ...

    @abstractmethod
    def remove(self, key) -> None:
        ...

    @abstractmethod
    def iterator(self, start=None, end=None, include_value: bool = True
                 ) -> Iterator:
        """Byte-ordered iteration over [start, end] (inclusive bounds)."""

    @abstractmethod
    def do_batch(self, batch: Iterable[Tuple[bytes, Optional[bytes]]]) -> None:
        """Atomically apply (key, value) puts; value None means delete."""

    @abstractmethod
    def close(self) -> None:
        ...

    @abstractmethod
    def drop(self) -> None:
        ...

    @property
    @abstractmethod
    def size(self) -> int:
        ...

    def has_key(self, key) -> bool:
        try:
            self.get(key)
            return True
        except KeyError:
            return False

    # convenience
    def get_equal_or_none(self, key, default=None):
        try:
            return self.get(key)
        except KeyError:
            return default


class KeyValueStorageInMemory(KeyValueStorage):
    def __init__(self):
        self._dict: dict[bytes, bytes] = {}

    def get(self, key) -> bytes:
        return self._dict[_to_bytes(key)]

    def put(self, key, value) -> None:
        self._dict[_to_bytes(key)] = _to_bytes(value)

    def remove(self, key) -> None:
        self._dict.pop(_to_bytes(key), None)

    def iterator(self, start=None, end=None, include_value=True):
        start_b = _to_bytes(start) if start is not None else None
        end_b = _to_bytes(end) if end is not None else None
        for k in sorted(self._dict):
            if start_b is not None and k < start_b:
                continue
            if end_b is not None and k > end_b:
                break
            yield (k, self._dict[k]) if include_value else k

    def do_batch(self, batch):
        for k, v in batch:
            if v is None:
                self.remove(k)
            else:
                self.put(k, v)

    def close(self):
        pass

    def drop(self):
        self._dict.clear()

    @property
    def size(self) -> int:
        return len(self._dict)


class KeyValueStorageSqlite(KeyValueStorage):
    """Durable KV on sqlite3 (WAL mode): the RocksDB stand-in."""

    def __init__(self, db_dir: str, db_name: str):
        os.makedirs(db_dir, exist_ok=True)
        self._path = os.path.join(db_dir, db_name + ".sqlite")
        self._conn = sqlite3.connect(self._path)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA synchronous=NORMAL")
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS kv (k BLOB PRIMARY KEY, v BLOB)")
        self._conn.commit()

    def get(self, key) -> bytes:
        row = self._conn.execute(
            "SELECT v FROM kv WHERE k = ?", (_to_bytes(key),)).fetchone()
        if row is None:
            raise KeyError(key)
        return row[0]

    def put(self, key, value) -> None:
        self._conn.execute(
            "INSERT OR REPLACE INTO kv (k, v) VALUES (?, ?)",
            (_to_bytes(key), _to_bytes(value)))
        self._conn.commit()

    def remove(self, key) -> None:
        self._conn.execute("DELETE FROM kv WHERE k = ?", (_to_bytes(key),))
        self._conn.commit()

    def iterator(self, start=None, end=None, include_value=True):
        q = "SELECT k, v FROM kv"
        clauses, params = [], []
        if start is not None:
            clauses.append("k >= ?")
            params.append(_to_bytes(start))
        if end is not None:
            clauses.append("k <= ?")
            params.append(_to_bytes(end))
        if clauses:
            q += " WHERE " + " AND ".join(clauses)
        q += " ORDER BY k"
        for k, v in self._conn.execute(q, params):
            yield (bytes(k), bytes(v)) if include_value else bytes(k)

    def do_batch(self, batch):
        cur = self._conn.cursor()
        try:
            for k, v in batch:
                if v is None:
                    cur.execute("DELETE FROM kv WHERE k = ?", (_to_bytes(k),))
                else:
                    cur.execute(
                        "INSERT OR REPLACE INTO kv (k, v) VALUES (?, ?)",
                        (_to_bytes(k), _to_bytes(v)))
            self._conn.commit()
        except Exception:
            self._conn.rollback()
            raise

    def close(self):
        self._conn.close()

    def drop(self):
        self._conn.execute("DELETE FROM kv")
        self._conn.commit()

    @property
    def size(self) -> int:
        return self._conn.execute("SELECT COUNT(*) FROM kv").fetchone()[0]


def initKeyValueStorage(storage_type: str, data_dir: str, name: str
                        ) -> KeyValueStorage:
    """Reference: storage/helper.py initKeyValueStorage switch."""
    if storage_type == "memory":
        return KeyValueStorageInMemory()
    if storage_type == "sqlite":
        return KeyValueStorageSqlite(data_dir, name)
    if storage_type in ("chunked_file", "text_file"):
        raise NotImplementedError(
            f"the {storage_type} store comes with the deployed-node slice "
            "of the port")
    raise StorageError(f"unknown storage type {storage_type}")
