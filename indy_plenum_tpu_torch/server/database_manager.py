"""Registry of ledgers, states and auxiliary stores per ledger id.

Reference: plenum/server/database_manager.py (`DatabaseManager`). Also
holds the cross-cutting stores: the BLS multi-signature store (state-proof
reads) and the timestamp->state-root index.

Copy of ``indy_plenum_tpu/server/database_manager.py``,
with its imports bound to the port.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from ..ledger.ledger import Ledger
from ..state.state import State


class Database:
    def __init__(self, ledger: Ledger, state: Optional[State]):
        self.ledger = ledger
        self.state = state


class DatabaseManager:
    def __init__(self):
        self.databases: Dict[int, Database] = {}
        self.stores: Dict[str, object] = {}
        self._init_hooks: List = []

    def register_new_database(self, lid: int, ledger: Ledger,
                              state: Optional[State] = None) -> None:
        if lid in self.databases:
            raise ValueError(f"ledger {lid} already registered")
        self.databases[lid] = Database(ledger, state)

    def get_database(self, lid: int) -> Optional[Database]:
        return self.databases.get(lid)

    def get_ledger(self, lid: int) -> Optional[Ledger]:
        db = self.databases.get(lid)
        return db.ledger if db else None

    def get_state(self, lid: int) -> Optional[State]:
        db = self.databases.get(lid)
        return db.state if db else None

    def register_new_store(self, label: str, store) -> None:
        self.stores[label] = store

    def get_store(self, label: str):
        return self.stores.get(label)

    @property
    def ledger_ids(self) -> List[int]:
        return sorted(self.databases)

    # convenience used by handlers
    @property
    def ts_store(self):
        return self.stores.get("ts")

    @property
    def bls_store(self):
        return self.stores.get("bls")

    @property
    def idr_cache(self):
        return self.stores.get("idr")
