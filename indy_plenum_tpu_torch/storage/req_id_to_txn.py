"""Replay protection: request digest -> committed (ledger_id, seq_no).

Reference: plenum/persistence/req_id_to_txn.py (`ReqIdrToTxn`). Every
executed request is recorded under BOTH its full digest and its
signature-independent payload digest; a re-submitted request (same payload,
same or different signature) is detected at ingress and rejected with a
pointer to the already-committed txn instead of being re-ordered and
re-executed.

Copy of ``indy_plenum_tpu/storage/req_id_to_txn.py``,
with its imports bound to the port.
"""
from __future__ import annotations

from typing import Optional, Tuple

from .kv_store import KeyValueStorage, KeyValueStorageInMemory


class ReqIdrToTxn:
    def __init__(self, store: Optional[KeyValueStorage] = None):
        self._store = store or KeyValueStorageInMemory()

    @staticmethod
    def _val(ledger_id: int, seq_no: int) -> bytes:
        return f"{ledger_id}~{seq_no}".encode()

    def add(self, digest: str, payload_digest: str,
            ledger_id: int, seq_no: int) -> None:
        val = self._val(ledger_id, seq_no)
        self._store.put(b"d:" + digest.encode(), val)
        self._store.put(b"p:" + payload_digest.encode(), val)

    def _get(self, key: bytes) -> Optional[Tuple[int, int]]:
        try:
            raw = self._store.get(key)
        except KeyError:
            return None
        if raw is None:
            return None
        lid, seq = raw.decode().split("~")
        return int(lid), int(seq)

    def get(self, digest: str) -> Optional[Tuple[int, int]]:
        return self._get(b"d:" + digest.encode())

    def get_by_payload_digest(self, payload_digest: str
                              ) -> Optional[Tuple[int, int]]:
        return self._get(b"p:" + payload_digest.encode())
