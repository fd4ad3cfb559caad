"""File-backed stores: the reference's legacy ledger storage family.

Reference: storage/text_file_store.py (`TextFileStore`) and
storage/chunked_file_store.py (`ChunkedFileStore`) — plenum's original
ledger persistence before the KV backends. Re-implemented against this
package's :class:`KeyValueStorage` API so a
:class:`~indy_plenum_tpu_torch.ledger.ledger.Ledger` can run directly on a
chunked file store (reachable through
``initKeyValueStorage(config.LedgerStorageType, ...)``), and a human can
still inspect a validator's txn log with ``less``.

- :class:`TextFileStore`: append-only ``key<TAB>value`` hex lines with a
  rebuilt in-memory index; removals append tombstones; ``compact()``
  rewrites the live set.
- :class:`ChunkedFileStore`: integer-keyed append-only log split across
  fixed-size chunk files (the ledger txn shape: monotonically appended,
  truncated only from the tail by catchup's ``reset_to``).

Copy of ``indy_plenum_tpu/storage/file_stores.py``, with its imports bound
to the port. Host storage: no device path.
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, Iterator, Optional, Tuple

from .kv_store import KeyValueStorage, _to_bytes


class TextFileStore(KeyValueStorage):
    """Line-per-record KV store; the whole history is a readable file."""

    def __init__(self, db_dir: str, db_name: str):
        os.makedirs(db_dir, exist_ok=True)
        self._path = os.path.join(db_dir, db_name + ".txt")
        self._index: Dict[bytes, bytes] = {}
        if os.path.exists(self._path):
            with open(self._path) as fh:
                for line in fh:
                    line = line.rstrip("\n")
                    if not line:
                        continue
                    key_hex, _, value_hex = line.partition("\t")
                    key = bytes.fromhex(key_hex)
                    if value_hex == "-":  # tombstone
                        self._index.pop(key, None)
                    else:
                        self._index[key] = bytes.fromhex(value_hex)
        self._fh = open(self._path, "a")

    def _append(self, key: bytes, value: Optional[bytes]) -> None:
        self._fh.write(
            f"{key.hex()}\t{'-' if value is None else value.hex()}\n")

    def get(self, key) -> bytes:
        return self._index[bytes(_to_bytes(key))]

    def put(self, key, value) -> None:
        key, value = bytes(_to_bytes(key)), bytes(_to_bytes(value))
        self._index[key] = value
        self._append(key, value)
        self._fh.flush()

    def remove(self, key) -> None:
        key = bytes(_to_bytes(key))
        self._index.pop(key, None)
        self._append(key, None)
        self._fh.flush()

    def iterator(self, start=None, end=None, include_value: bool = True
                 ) -> Iterator:
        lo = bytes(_to_bytes(start)) if start is not None else None
        hi = bytes(_to_bytes(end)) if end is not None else None
        for key in sorted(self._index):
            if lo is not None and key < lo:
                continue
            if hi is not None and key > hi:
                break  # keys are sorted: nothing later can be in range
            yield (key, self._index[key]) if include_value else key

    def do_batch(self, batch: Iterable[Tuple[bytes, Optional[bytes]]]
                 ) -> None:
        # convert the WHOLE batch before mutating anything: a bad entry
        # mid-batch must not leave earlier entries applied (the KV
        # contract's atomicity)
        entries = [(bytes(_to_bytes(key)),
                    None if value is None else bytes(_to_bytes(value)))
                   for key, value in batch]
        for key, value in entries:
            if value is None:
                self._index.pop(key, None)
            else:
                self._index[key] = value
            self._append(key, value)
        self._fh.flush()

    def compact(self) -> None:
        """Rewrite the file with only live records (tombstone GC). A
        failed rewrite (disk full) leaves the original file intact and
        the store usable."""
        self._fh.close()
        tmp = self._path + ".compact"
        try:
            with open(tmp, "w") as fh:
                for key in sorted(self._index):
                    fh.write(f"{key.hex()}\t{self._index[key].hex()}\n")
            os.replace(tmp, self._path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
            self._fh = open(self._path, "a")

    def close(self) -> None:
        self._fh.close()

    def drop(self) -> None:
        self.close()
        if os.path.exists(self._path):
            os.unlink(self._path)
        self._index.clear()
        self._fh = open(self._path, "a")

    @property
    def size(self) -> int:
        return len(self._index)


class ChunkedFileStore(KeyValueStorage):
    """Append-only integer-keyed log over fixed-size chunk files.

    Keys are 8-byte big-endian integers (the Ledger's seqNo keys). Writes
    must arrive in append order; removal is tail-only (``reset_to``'s
    truncation shape) — both enforced, because silent out-of-order writes
    would corrupt the chunk arithmetic.
    """

    def __init__(self, db_dir: str, db_name: str, chunk_size: int = 1000):
        if chunk_size <= 0:
            raise ValueError("chunk_size must be positive")
        self._dir = os.path.join(db_dir, db_name)
        os.makedirs(self._dir, exist_ok=True)
        # chunk_size is part of the ON-DISK layout: reopening with a
        # different value would silently corrupt the seq->chunk
        # arithmetic, so the persisted value always wins and the ctor
        # argument only seeds NEW stores
        meta = os.path.join(self._dir, "chunk_size")
        if os.path.exists(meta):
            with open(meta) as fh:
                raw = fh.read().strip()
            persisted = int(raw) if raw.isdigit() else 0
            if persisted <= 0:
                raise ValueError(
                    f"corrupt chunk_size meta at {meta!r}: {raw!r}")
            chunk_size = persisted
        else:
            # tmp+rename: a crash mid-write must not leave a truncated
            # meta that bricks every future open
            with open(meta + ".tmp", "w") as fh:
                fh.write(str(chunk_size))
            os.replace(meta + ".tmp", meta)
        self._chunk_size = chunk_size
        # chunk i holds entries [i*chunk_size + 1, (i+1)*chunk_size]
        self._chunks: Dict[int, list] = {}
        self._count = 0
        for name in sorted(os.listdir(self._dir)):
            if not name.endswith(".chunk"):
                continue
            idx = int(name.split(".")[0])
            with open(os.path.join(self._dir, name)) as fh:
                lines = [bytes.fromhex(line.strip())
                         for line in fh if line.strip()]
            self._chunks[idx] = lines
        self._count = sum(len(c) for c in self._chunks.values())

    @staticmethod
    def _seq(key) -> int:
        if isinstance(key, int):
            return key
        return int.from_bytes(_to_bytes(key), "big")

    def _chunk_path(self, idx: int) -> str:
        return os.path.join(self._dir, f"{idx:06d}.chunk")

    def _persist_chunk(self, idx: int) -> None:
        tmp = self._chunk_path(idx) + ".tmp"
        with open(tmp, "w") as fh:
            for value in self._chunks.get(idx, []):
                fh.write(value.hex() + "\n")
        os.replace(tmp, self._chunk_path(idx))

    def get(self, key) -> bytes:
        seq = self._seq(key)
        if not 1 <= seq <= self._count:
            raise KeyError(key)
        idx, off = divmod(seq - 1, self._chunk_size)
        return self._chunks[idx][off]

    def _append_line(self, idx: int, value: bytes) -> None:
        """Append path: ONE line written, not a chunk rewrite — catchup
        replays txns one Ledger.add at a time, and rewriting ~chunk_size/2
        lines per append would make a 1M-txn sync quadratic in disk IO."""
        with open(self._chunk_path(idx), "a") as fh:
            fh.write(value.hex() + "\n")

    def put(self, key, value) -> None:
        seq = self._seq(key)
        value = bytes(_to_bytes(value))
        idx, off = divmod(seq - 1, self._chunk_size)
        if seq == self._count:  # idempotent last-entry overwrite
            self._chunks[idx][off] = value
            self._persist_chunk(idx)
        elif seq == self._count + 1:
            self._chunks.setdefault(idx, []).append(value)
            self._count = seq
            self._append_line(idx, value)
        else:
            raise ValueError(
                f"append-only: next key is {self._count + 1}, got {seq}")

    def remove(self, key) -> None:
        seq = self._seq(key)
        if seq != self._count:
            raise ValueError(
                f"tail-only removal: last key is {self._count}, got {seq}")
        idx, off = divmod(seq - 1, self._chunk_size)
        del self._chunks[idx][off]
        if not self._chunks[idx]:
            del self._chunks[idx]
            path = self._chunk_path(idx)
            if os.path.exists(path):
                os.unlink(path)
        else:
            self._persist_chunk(idx)
        self._count -= 1

    def iterator(self, start=None, end=None, include_value: bool = True
                 ) -> Iterator:
        lo = self._seq(start) if start is not None else 1
        hi = self._seq(end) if end is not None else self._count
        for seq in range(max(1, lo), min(self._count, hi) + 1):
            key = seq.to_bytes(8, "big")
            yield (key, self.get(key)) if include_value else key

    def do_batch(self, batch: Iterable[Tuple[bytes, Optional[bytes]]]
                 ) -> None:
        """Validate-then-apply: the whole batch is checked against the
        append/tail discipline BEFORE any mutation, so an invalid batch
        raises with memory and disk untouched (the atomicity the KV
        contract promises — per-chunk writes are individually atomic via
        tmp+rename; a mid-batch IO failure can still leave earlier chunks
        newer than later ones, same as any non-journaled file store)."""
        entries = []
        simulated = self._count
        for key, value in batch:
            seq = self._seq(key)
            if value is None:
                if seq != simulated:
                    raise ValueError(
                        f"tail-only removal: last key is {simulated}, "
                        f"got {seq}")
                simulated -= 1
                entries.append((seq, None))
            else:
                if seq not in (simulated, simulated + 1):
                    raise ValueError(
                        f"append-only: next key is {simulated + 1}, "
                        f"got {seq}")
                simulated = max(simulated, seq)
                entries.append((seq, bytes(_to_bytes(value))))
        touched = set()
        for seq, value in entries:
            idx, off = divmod(seq - 1, self._chunk_size)
            if value is None:
                del self._chunks[idx][off]
                if not self._chunks[idx]:
                    del self._chunks[idx]
                self._count -= 1
            elif seq == self._count:
                self._chunks[idx][off] = value
            else:
                self._chunks.setdefault(idx, []).append(value)
                self._count = seq
            touched.add(idx)
        for idx in touched:
            if idx in self._chunks:
                self._persist_chunk(idx)
            else:
                path = self._chunk_path(idx)
                if os.path.exists(path):
                    os.unlink(path)

    def close(self) -> None:
        pass  # chunks are persisted on every mutation

    def drop(self) -> None:
        for idx in list(self._chunks):
            path = self._chunk_path(idx)
            if os.path.exists(path):
                os.unlink(path)
        self._chunks.clear()
        self._count = 0
        # the layout parameter belongs to the DATA; with the data gone a
        # later store over this directory must get its own chunk_size
        meta = os.path.join(self._dir, "chunk_size")
        if os.path.exists(meta):
            os.unlink(meta)

    @property
    def size(self) -> int:
        return self._count
