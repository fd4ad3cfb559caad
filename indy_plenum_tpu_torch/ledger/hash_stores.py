"""Hash stores: leaf + internal node hashes addressed by (level, offset).

Reference: ledger/hash_stores/* (HashStore, LevelDbHashStore, FileHashStore).
The reference addresses internal nodes by a sequential creation index with
bit-twiddling recovery; here nodes are addressed directly by their subtree
coordinates — level ``l`` (subtree of 2^l leaves) and leaf offset — which
makes audit-path assembly O(log n) KV gets with no index math.

Copy of ``indy_plenum_tpu/ledger/hash_stores.py``,
with its imports bound to the port.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Optional

from ..storage.kv_store import KeyValueStorage, KeyValueStorageInMemory


class HashStore(ABC):
    @abstractmethod
    def write_leaf(self, index: int, leaf_hash: bytes) -> None:
        ...

    @abstractmethod
    def read_leaf(self, index: int) -> bytes:
        ...

    @abstractmethod
    def write_node(self, level: int, offset: int, node_hash: bytes) -> None:
        ...

    @abstractmethod
    def read_node(self, level: int, offset: int) -> bytes:
        ...

    @property
    @abstractmethod
    def leaf_count(self) -> int:
        ...

    @leaf_count.setter
    @abstractmethod
    def leaf_count(self, count: int) -> None:
        ...

    def reset(self) -> None:
        ...


class MemoryHashStore(HashStore):
    def __init__(self):
        self._leaves: dict[int, bytes] = {}
        self._nodes: dict[tuple[int, int], bytes] = {}
        self._count = 0

    def write_leaf(self, index, leaf_hash):
        self._leaves[index] = leaf_hash

    def read_leaf(self, index):
        return self._leaves[index]

    def write_node(self, level, offset, node_hash):
        self._nodes[(level, offset)] = node_hash

    def read_node(self, level, offset):
        return self._nodes[(level, offset)]

    @property
    def leaf_count(self):
        return self._count

    @leaf_count.setter
    def leaf_count(self, count):
        self._count = count

    def reset(self):
        self._leaves.clear()
        self._nodes.clear()
        self._count = 0


class KvHashStore(HashStore):
    """Durable hash store over any KeyValueStorage backend."""

    def __init__(self, kv: Optional[KeyValueStorage] = None):
        self._kv = kv if kv is not None else KeyValueStorageInMemory()

    @staticmethod
    def _leaf_key(index: int) -> bytes:
        return b"L" + index.to_bytes(8, "big")

    @staticmethod
    def _node_key(level: int, offset: int) -> bytes:
        return b"N" + level.to_bytes(2, "big") + offset.to_bytes(8, "big")

    def write_leaf(self, index, leaf_hash):
        self._kv.put(self._leaf_key(index), leaf_hash)

    def read_leaf(self, index):
        try:
            return self._kv.get(self._leaf_key(index))
        except KeyError:
            raise KeyError(f"leaf {index}") from None

    def write_node(self, level, offset, node_hash):
        self._kv.put(self._node_key(level, offset), node_hash)

    def read_node(self, level, offset):
        try:
            return self._kv.get(self._node_key(level, offset))
        except KeyError:
            raise KeyError(f"node ({level},{offset})") from None

    @property
    def leaf_count(self):
        try:
            return int(self._kv.get(b"C"))
        except KeyError:
            return 0

    @leaf_count.setter
    def leaf_count(self, count):
        self._kv.put(b"C", str(count))

    def reset(self):
        self._kv.drop()
