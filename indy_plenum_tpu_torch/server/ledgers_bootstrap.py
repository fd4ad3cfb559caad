"""Node-init wiring: ledgers, states, handlers, genesis, state rebuild.

Reference: plenum/server/ledgers_bootstrap.py (`LedgersBootstrapper`).
Builds the DatabaseManager with the four standard ledgers (POOL, DOMAIN,
CONFIG, AUDIT), sparse-Merkle states for the stateful ones, registers the
request/batch handlers with a WriteRequestManager, applies genesis txns to
fresh ledgers, and rebuilds any state that is missing or behind its ledger
(crash recovery: the ledger is the truth, state is derived).

Copy of ``indy_plenum_tpu/server/ledgers_bootstrap.py``,
with its imports bound to the port. ``device`` reaches every SMT state:
its device hash waves (K11) run there - the CUDA card unless the caller
passes ``device="cpu"``.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional

from ..common.constants import (
    AUDIT_LEDGER_ID,
    CONFIG_LEDGER_ID,
    DOMAIN_LEDGER_ID,
    POOL_LEDGER_ID,
)
from ..common.txn_util import get_type
from ..ledger.compact_merkle_tree import CompactMerkleTree
from ..ledger.hash_stores import MemoryHashStore
from ..ledger.ledger import Ledger
from ..state.sparse_merkle_state import SparseMerkleState
from ..storage.kv_store import KeyValueStorage, KeyValueStorageInMemory
from ..utils.torch_env import DeviceLike
from .batch_handlers.batch_handlers import (
    AuditBatchHandler,
    LedgerBatchHandler,
)
from .database_manager import DatabaseManager
from .request_handlers.node_handler import NodeHandler
from .request_handlers.nym_handler import NymHandler
from .request_managers.write_request_manager import WriteRequestManager

logger = logging.getLogger(__name__)

STATEFUL_LEDGERS = (POOL_LEDGER_ID, DOMAIN_LEDGER_ID, CONFIG_LEDGER_ID)


class NodeStorage:
    """The durable stores of one node, keyed so a 'restart' can reopen
    them (in tests the same objects are handed to a fresh bootstrap —
    equivalent to reopening on-disk stores)."""

    def __init__(self, factory=KeyValueStorageInMemory):
        self.txn_stores: Dict[int, KeyValueStorage] = {}
        self.hash_stores: Dict[int, Any] = {}
        self.state_stores: Dict[int, KeyValueStorage] = {}
        for lid in (POOL_LEDGER_ID, DOMAIN_LEDGER_ID, CONFIG_LEDGER_ID,
                    AUDIT_LEDGER_ID):
            self.txn_stores[lid] = factory()
            self.hash_stores[lid] = MemoryHashStore()
            if lid in STATEFUL_LEDGERS:
                self.state_stores[lid] = factory()


class LedgersBootstrap:
    def __init__(self, storage: Optional[NodeStorage] = None,
                 pool_genesis: Optional[List[Dict]] = None,
                 domain_genesis: Optional[List[Dict]] = None,
                 config=None, device: DeviceLike = None):
        self.storage = storage or NodeStorage()
        self.device = device
        self.pool_genesis = pool_genesis or []
        self.domain_genesis = domain_genesis or []
        self.config = config
        self.db = DatabaseManager()
        self.write_manager = WriteRequestManager(self.db)
        self.nym_handler: Optional[NymHandler] = None
        self.node_handler: Optional[NodeHandler] = None
        self.audit_handler: Optional[AuditBatchHandler] = None

    # ------------------------------------------------------------------

    def build(self) -> "LedgersBootstrap":
        for lid in (POOL_LEDGER_ID, DOMAIN_LEDGER_ID, CONFIG_LEDGER_ID,
                    AUDIT_LEDGER_ID):
            ledger = Ledger(
                tree=CompactMerkleTree(hash_store=self.storage.hash_stores[lid]),
                txn_store=self.storage.txn_stores[lid])
            # crash recovery: a lost/stale hash store rebuilds from the
            # durable txn log (the log is the truth; the tree is derived)
            ledger.recover_tree()
            state = None
            if lid in STATEFUL_LEDGERS:
                config = self.config
                if config is not None:
                    state = SparseMerkleState(
                        kv=self.storage.state_stores[lid],
                        node_cache_size=config.StateNodeCacheSize,
                        commit_batch_enabled=config.StateCommitBatchEnabled,
                        commit_batch_min=config.StateCommitBatchMin,
                        commit_mode=config.StateCommitBatchMode,
                        device=self.device)
                else:
                    state = SparseMerkleState(
                        kv=self.storage.state_stores[lid],
                        device=self.device)
            self.db.register_new_database(lid, ledger, state)

        self.nym_handler = NymHandler(self.db)
        self.node_handler = NodeHandler(
            self.db, get_nym_data=self.nym_handler.get_nym_data)
        from .request_handlers.pool_config_handler import PoolConfigHandler

        self.pool_config_handler = PoolConfigHandler(
            self.db, get_nym_data=self.nym_handler.get_nym_data)
        self.write_manager.register_req_handler(self.nym_handler)
        self.write_manager.register_req_handler(self.node_handler)
        self.write_manager.register_req_handler(self.pool_config_handler)
        for lid in STATEFUL_LEDGERS:
            self.write_manager.register_batch_handler(
                LedgerBatchHandler(self.db, lid))
        self.audit_handler = AuditBatchHandler(self.db)
        self.write_manager.register_audit_handler(self.audit_handler)

        self._apply_genesis(POOL_LEDGER_ID, self.pool_genesis)
        self._apply_genesis(DOMAIN_LEDGER_ID, self.domain_genesis)
        self._rebuild_states_if_behind()
        return self

    # ------------------------------------------------------------------

    def _apply_genesis(self, lid: int, txns: List[Dict]) -> None:
        ledger = self.db.get_ledger(lid)
        if ledger.size > 0 or not txns:
            return  # already initialized (restart) or nothing to do
        state = self.db.get_state(lid)
        for txn in txns:
            ledger.add(dict(txn))
            self._update_state_for(txn)
        if state is not None:
            state.commit()
        logger.info("ledger %d: %d genesis txns", lid, len(txns))

    def _update_state_for(self, txn: Dict) -> None:
        handler = self.write_manager.handlers.get(get_type(txn))
        if handler is not None:
            handler.update_state(txn, None, is_committed=True)

    def _rebuild_states_if_behind(self) -> None:
        """States are derived data: replay committed ledger txns through the
        handlers when a state is missing or stale (reference: state rebuild
        at node init). Coverage is located via the audit ledger — the
        recovery spine records each batch's state root per ledger — by
        finding the newest audit txn whose recorded root matches the
        persisted committed state root; the ledger sizes it pins tell us
        where replay must resume. A state matching no audit txn (corrupt or
        fresh) is rebuilt from scratch (the SMT 'reset' is a pointer move)."""
        from ..common.constants import (
            AUDIT_TXN_LEDGERS_SIZE,
            AUDIT_TXN_STATE_ROOT,
        )
        from ..common.txn_util import get_payload_data
        from ..state.sparse_merkle_state import EMPTY_ROOT
        from ..utils.base58 import b58encode

        audit_ledger = self.db.get_ledger(AUDIT_LEDGER_ID)
        for lid in STATEFUL_LEDGERS:
            ledger = self.db.get_ledger(lid)
            state = self.db.get_state(lid)
            if ledger.size == 0:
                continue
            current = b58encode(state.committed_head_hash)
            from_size = None
            if state.committed_head_hash == EMPTY_ROOT:
                from_size = 0
            elif audit_ledger.size == 0:
                # no batch ever committed (audit txns are 1:1 with batches):
                # the ledger holds only genesis, which the persisted state
                # already covers
                from_size = ledger.size
            else:
                for seq in range(audit_ledger.size, 0, -1):
                    data = get_payload_data(audit_ledger.get_by_seq_no(seq))
                    if data.get(AUDIT_TXN_STATE_ROOT, {}).get(str(lid)) \
                            == current:
                        from_size = data[AUDIT_TXN_LEDGERS_SIZE][str(lid)]
                        break
            if from_size is None:
                logger.warning(
                    "ledger %d: state root unknown to audit ledger; "
                    "rebuilding from genesis", lid)
                state.set_head_hash(EMPTY_ROOT)
                state.commit(EMPTY_ROOT)
                state.set_head_hash(EMPTY_ROOT)
                from_size = 0
            if from_size >= ledger.size:
                continue
            logger.info("ledger %d: replaying txns %d..%d into state",
                        lid, from_size + 1, ledger.size)
            for seq in range(from_size + 1, ledger.size + 1):
                self._update_state_for(ledger.get_by_seq_no(seq))
            state.commit()

    @property
    def committed_pp_seq_no(self) -> int:
        return self.write_manager.committed_pp_seq_no()
