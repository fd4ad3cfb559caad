"""Multi-signature store keyed by state root.

Reference: plenum/bls/bls_store.py (`BlsStore`). State-proof reads fetch
the multi-sig proving a given committed state root; any KV backend works
(in-memory for sim, sqlite for durable nodes).

Copy of ``indy_plenum_tpu/bls/bls_store.py``, with its imports bound to
the port.
"""
from __future__ import annotations

import json
from typing import Optional

from ..crypto.bls.bls_crypto import MultiSignature
from ..storage.kv_store import KeyValueStorage, KeyValueStorageInMemory


class BlsStore:
    def __init__(self, kv: Optional[KeyValueStorage] = None):
        self._kv = kv if kv is not None else KeyValueStorageInMemory()

    def put(self, multi_sig: MultiSignature) -> None:
        key = multi_sig.value.state_root_hash.encode()
        self._kv.put(key, json.dumps(multi_sig.as_dict(),
                                     sort_keys=True).encode())

    def get(self, state_root_b58: str) -> Optional[MultiSignature]:
        try:
            raw = self._kv.get(state_root_b58.encode())
        except KeyError:
            return None
        if raw is None:
            return None
        return MultiSignature.from_dict(json.loads(raw.decode()))
