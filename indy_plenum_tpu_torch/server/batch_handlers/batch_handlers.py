"""Per-ledger batch lifecycle hooks, including the audit-ledger spine.

Reference: plenum/server/batch_handlers/ — ``post_batch_applied`` /
``commit_batch`` / ``post_batch_rejected`` per ledger, and
``AuditBatchHandler``: one AUDIT txn per 3PC batch binding (viewNo,
ppSeqNo, every ledger's size+root, the state roots, primaries). The audit
ledger is the restart-recovery spine: on boot a node reads its last audit
txn to learn its committed 3PC height and the matching roots.

Copy of ``indy_plenum_tpu/server/batch_handlers/batch_handlers.py``,
with its imports bound to the port.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from ...common.constants import (
    AUDIT,
    AUDIT_LEDGER_ID,
    AUDIT_TXN_DIGEST,
    AUDIT_TXN_LEDGER_ROOT,
    AUDIT_TXN_LEDGERS_SIZE,
    AUDIT_TXN_PP_SEQ_NO,
    AUDIT_TXN_PRIMARIES,
    AUDIT_TXN_STATE_ROOT,
    AUDIT_TXN_VIEW_NO,
    CURRENT_TXN_VERSION,
    TXN_METADATA,
    TXN_PAYLOAD,
    TXN_PAYLOAD_DATA,
    TXN_PAYLOAD_METADATA,
    TXN_SIGNATURE,
    TXN_TYPE,
    TXN_VERSION,
)
from ...common.txn_util import get_payload_data
from ...utils.base58 import b58encode
from ..database_manager import DatabaseManager
from .three_pc_batch import ThreePcBatch


class BatchHandler:
    """Lifecycle hooks one ledger (or cross-cutting store) implements."""

    def __init__(self, database_manager: DatabaseManager, ledger_id: int):
        self.database_manager = database_manager
        self.ledger_id = ledger_id

    @property
    def ledger(self):
        return self.database_manager.get_ledger(self.ledger_id)

    @property
    def state(self):
        return self.database_manager.get_state(self.ledger_id)

    def post_batch_applied(self, batch: ThreePcBatch,
                           prev_result: Any = None) -> Any:
        """Batch speculatively applied (uncommitted)."""

    def post_batch_rejected(self, ledger_id: int,
                            prev_result: Any = None) -> Any:
        """The LAST applied batch for ledger_id is being reverted."""

    def commit_batch(self, batch: ThreePcBatch,
                     prev_result: Any = None) -> Any:
        """Batch ordered: move staged txns/state to committed."""


class LedgerBatchHandler(BatchHandler):
    """Generic domain/pool/config handler: commit/discard staged txns and
    advance the state's committed head to the batch's recorded root."""

    def post_batch_applied(self, batch: ThreePcBatch, prev_result=None):
        pass  # txns were staged by WriteRequestManager.apply_request

    def post_batch_rejected(self, ledger_id: int, prev_result=None):
        pass  # ledger discard + state head rewind handled by the manager

    def commit_batch(self, batch: ThreePcBatch, prev_result=None):
        count = len(batch.valid_digests)
        if count:
            self.ledger.commit_txns(count)
        if self.state is not None and batch.state_root is not None:
            self.state.commit(batch.state_root)


class AuditBatchHandler(BatchHandler):
    """Writes one AUDIT txn per 3PC batch (any ledger) — the recovery spine.

    Reference: plenum/server/batch_handlers/audit_batch_handler.py. The
    audit ledger has no state; its txns bind everything needed to restore
    a node's 3PC position and root expectations after restart.
    """

    def __init__(self, database_manager: DatabaseManager):
        super().__init__(database_manager, AUDIT_LEDGER_ID)

    def build_audit_txn(self, batch: ThreePcBatch) -> Dict[str, Any]:
        sizes: Dict[str, int] = {}
        roots: Dict[str, str] = {}
        states: Dict[str, str] = {}
        for lid in self.database_manager.ledger_ids:
            if lid == AUDIT_LEDGER_ID:
                continue
            ledger = self.database_manager.get_ledger(lid)
            sizes[str(lid)] = ledger.uncommitted_size
            roots[str(lid)] = b58encode(ledger.uncommitted_root_hash)
            state = self.database_manager.get_state(lid)
            if state is not None:
                states[str(lid)] = b58encode(state.head_hash)
        return {
            TXN_VERSION: CURRENT_TXN_VERSION,
            TXN_PAYLOAD: {
                TXN_TYPE: AUDIT,
                TXN_PAYLOAD_DATA: {
                    AUDIT_TXN_VIEW_NO: batch.view_no,
                    AUDIT_TXN_PP_SEQ_NO: batch.pp_seq_no,
                    AUDIT_TXN_LEDGERS_SIZE: sizes,
                    AUDIT_TXN_LEDGER_ROOT: roots,
                    AUDIT_TXN_STATE_ROOT: states,
                    AUDIT_TXN_PRIMARIES: list(batch.primaries),
                    AUDIT_TXN_DIGEST: batch.pp_digest,
                },
                TXN_PAYLOAD_METADATA: {},
            },
            TXN_METADATA: {},
            TXN_SIGNATURE: {},
        }

    def post_batch_applied(self, batch: ThreePcBatch, prev_result=None):
        txn = self.build_audit_txn(batch)
        self.ledger.append_txns([txn])
        return txn

    def post_batch_rejected(self, ledger_id: int, prev_result=None):
        self.ledger.discard_txns(1)

    def commit_batch(self, batch: ThreePcBatch, prev_result=None):
        _, committed = self.ledger.commit_txns(1)
        return committed[0]

    # --- recovery reads -------------------------------------------------

    def last_committed_audit_data(self) -> Optional[Dict[str, Any]]:
        if self.ledger.size == 0:
            return None
        return get_payload_data(self.ledger.get_by_seq_no(self.ledger.size))

    def committed_pp_seq_no(self) -> int:
        data = self.last_committed_audit_data()
        return data[AUDIT_TXN_PP_SEQ_NO] if data else 0

    def audit_data_for_seq(self, pp_seq_no: int) -> Optional[Dict[str, Any]]:
        """Audit txns are 1:1 with 3PC batches, so ledger seqNo == the
        batch's position in the total order; ppSeqNo is monotone across
        views but may skip after view changes, so scan back when needed."""
        size = self.ledger.size
        if size == 0:
            return None
        guess = min(pp_seq_no, size)
        for seq in range(guess, 0, -1):
            data = get_payload_data(self.ledger.get_by_seq_no(seq))
            if data[AUDIT_TXN_PP_SEQ_NO] == pp_seq_no:
                return data
            if data[AUDIT_TXN_PP_SEQ_NO] < pp_seq_no:
                return None
        return None
