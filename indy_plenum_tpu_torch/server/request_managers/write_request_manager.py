"""Write-request execution: validate -> apply (staged) -> commit/revert.

Reference: plenum/server/request_managers/write_request_manager.py
(`WriteRequestManager`). Dispatches per-txn-type handlers for validation
and state updates, stages txns on the ledger's uncommitted tail, writes the
audit txn per batch (AuditBatchHandler), and moves batches between staged
and committed as 3PC orders or reverts them. The LIFO revert uses the
sparse-Merkle state's content-addressed roots: rewinding is a pointer move
(``set_head_hash``), not a walk.

``NodeExecutor`` adapts this to the ``Executor`` seam of
:class:`~indy_plenum_tpu_torch.server.consensus.ordering_service.OrderingService`:
speculative apply returns the (state_root, txn_root) the PRE-PREPARE
carries; a re-apply at or below the committed height returns the historical
roots from the audit ledger (post-view-change re-ordering safety).

Copy of ``indy_plenum_tpu/server/request_managers/write_request_manager.py``,
with its imports bound to the port.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Tuple

from ...common.constants import (
    AUDIT_TXN_LEDGER_ROOT,
    AUDIT_TXN_STATE_ROOT,
)
from ...common.request import Request
from ...common.txn_util import append_txn_metadata, reqToTxn
from ...utils.base58 import b58encode
from ..batch_handlers.batch_handlers import (
    AuditBatchHandler,
    LedgerBatchHandler,
)
from ..batch_handlers.three_pc_batch import ThreePcBatch
from ..database_manager import DatabaseManager
from ..request_handlers.handler_interfaces import WriteRequestHandler
from .staged import StagedBatch

logger = logging.getLogger(__name__)


class WriteRequestManager:
    def __init__(self, database_manager: DatabaseManager):
        self.db = database_manager
        self.handlers: Dict[str, WriteRequestHandler] = {}
        self.batch_handlers: Dict[int, LedgerBatchHandler] = {}
        self.audit_handler: Optional[AuditBatchHandler] = None
        self._staged: List[StagedBatch] = []
        # set post-construction by the owning node (node.py / SimNode):
        # per-batch state-commit meters land here when present
        self.metrics = None

    # --- registration ---------------------------------------------------

    def register_req_handler(self, handler: WriteRequestHandler) -> None:
        self.handlers[handler.txn_type] = handler

    def register_batch_handler(self, handler: LedgerBatchHandler) -> None:
        self.batch_handlers[handler.ledger_id] = handler

    def register_audit_handler(self, handler: AuditBatchHandler) -> None:
        self.audit_handler = handler

    def ledger_id_for_request(self, request: Request) -> Optional[int]:
        h = self.handlers.get(request.txn_type)
        return h.ledger_id if h else None

    # --- validation -----------------------------------------------------

    def _handler(self, request: Request) -> WriteRequestHandler:
        h = self.handlers.get(request.txn_type)
        if h is None:
            from ...common.exceptions import InvalidClientRequest

            raise InvalidClientRequest(
                request.identifier, request.reqId,
                f"no handler for txn type {request.txn_type!r}")
        return h

    def static_validation(self, request: Request) -> None:
        self._handler(request).static_validation(request)

    def dynamic_validation(self, request: Request,
                           req_pp_time: Optional[int]) -> None:
        # pool-wide write switch, enforced IN CONSENSUS (not only at
        # ingress): a request smuggled in through a faulty node's
        # PROPAGATE must still be rejected by every honest replica's
        # dynamic validation, deterministically (uncommitted state).
        # POOL_CONFIG itself stays writable or the pool could never
        # re-enable.
        from ...common.constants import POOL_CONFIG
        from ...common.exceptions import UnauthorizedClientRequest

        if request.txn_type != POOL_CONFIG:
            cfg = self.handlers.get(POOL_CONFIG)
            if cfg is not None and not cfg.writes_enabled(
                    is_committed=False):
                raise UnauthorizedClientRequest(
                    request.identifier, request.reqId,
                    "pool writes are disabled (POOL_CONFIG)")
        self._handler(request).dynamic_validation(request, req_pp_time)

    # --- apply (staged) -------------------------------------------------

    def apply_request(self, request: Request,
                      pp_time: int) -> Dict[str, Any]:
        handler = self._handler(request)
        txn = append_txn_metadata(reqToTxn(request), txn_time=pp_time)
        handler.ledger.append_txns([txn])  # assigns provisional seqNo
        handler.update_state(txn, None, request=request)
        return txn

    def apply_batch(self, batch: ThreePcBatch, reqs: List[Request]
                    ) -> Tuple[bytes, bytes, List[Tuple[Request, Exception]]]:
        """Speculatively apply a whole 3PC batch; returns the raw
        (state_root, txn_root) every replica must reproduce plus the
        requests rejected by dynamic validation.

        Validation is interleaved with application in request order, so the
        valid/invalid split is a deterministic function of (pre-state,
        request sequence): every replica re-running this loop reaches the
        same split and the same roots. A rejected request is simply not
        applied (the reference tracks these via the PRE-PREPARE ``discarded``
        field and sends Rejects at execution); an *unexpected* failure rolls
        the ledger and state back to the pre-batch roots and re-raises —
        never leave half a batch applied without a staged record.
        """
        from ...common.exceptions import InvalidClientRequest

        ledger = self.db.get_ledger(batch.ledger_id)
        state = self.db.get_state(batch.ledger_id)
        pre_state_root = state.head_hash if state is not None else None
        pre_uncommitted = ledger.uncommitted_size
        # batched state commit: buffer the batch's writes and flush them
        # through ONE bottom-up tree walk (SparseMerkleState.apply_batch)
        # instead of a 256-hash path walk per write; reads during dynamic
        # validation see the pending overlay, so the valid/invalid split
        # (and therefore the root) is unchanged from sequential apply
        pre_hashes = state.hashes_total if state is not None else 0
        in_batch = state.begin_batch() if state is not None else False
        valid: List[Request] = []
        rejected: List[Tuple[Request, Exception]] = []
        try:
            for req in reqs:
                try:
                    self.dynamic_validation(req, batch.pp_time)
                except InvalidClientRequest as ex:
                    rejected.append((req, ex))
                    continue
                self.apply_request(req, batch.pp_time)
                valid.append(req)
            if in_batch:
                state.flush_batch()
        except Exception:
            # discard down to the pre-batch size, not len(valid): the
            # failing request's txn may already be appended (apply_request
            # appends before update_state runs)
            ledger.discard_txns(ledger.uncommitted_size - pre_uncommitted)
            if state is not None and pre_state_root is not None:
                # set_head_hash also discards any still-buffered writes
                state.set_head_hash(pre_state_root)
            raise
        state_root = state.head_hash if state is not None else b""
        if state is not None and self.metrics is not None:
            from ...common.metrics_collector import MetricsName

            self.metrics.add_event(MetricsName.STATE_COMMIT_HASHES,
                                   state.hashes_total - pre_hashes)
            self.metrics.add_event(MetricsName.STATE_COMMIT_BATCH_SIZE,
                                   len(valid))
        txn_root = ledger.uncommitted_root_hash
        batch.state_root = state_root
        batch.txn_root = txn_root
        batch.valid_digests = [r.digest for r in valid]
        if self.audit_handler is not None:
            self.audit_handler.post_batch_applied(batch)
        self._staged.append(StagedBatch(
            ledger_id=batch.ledger_id,
            pp_seq_no=batch.pp_seq_no,
            view_no=batch.view_no,
            txn_count=len(valid),
            pre_state_root=pre_state_root,
            state_root=state_root,
            batch=batch,
        ))
        return state_root, txn_root, rejected

    # --- revert (LIFO) --------------------------------------------------

    def revert_last_batch(self) -> None:
        staged = self._staged.pop()
        ledger = self.db.get_ledger(staged.ledger_id)
        state = self.db.get_state(staged.ledger_id)
        ledger.discard_txns(staged.txn_count)
        if state is not None and staged.pre_state_root is not None:
            state.set_head_hash(staged.pre_state_root)
        if self.audit_handler is not None:
            self.audit_handler.post_batch_rejected(staged.ledger_id)

    def revert_batches(self, ledger_id: int, count: int) -> None:
        """Revert up to ``count`` newest staged batches of ``ledger_id``.

        Staged batches for other ledgers above them must not exist when
        this is called per-ledger (the ordering service reverts newest
        first, grouped by ledger) — assert the LIFO discipline instead of
        silently corrupting roots.
        """
        for _ in range(count):
            if not self._staged:
                return
            assert self._staged[-1].ledger_id == ledger_id, (
                "revert discipline violated: top staged batch is for "
                f"ledger {self._staged[-1].ledger_id}, not {ledger_id}")
            self.revert_last_batch()

    # --- commit (FIFO) --------------------------------------------------

    def commit_next_batch(self) -> StagedBatch:
        staged = self._staged.pop(0)
        handler = self.batch_handlers.get(staged.ledger_id)
        if handler is None:
            handler = LedgerBatchHandler(self.db, staged.ledger_id)
        handler.commit_batch(staged.batch)
        if self.audit_handler is not None:
            self.audit_handler.commit_batch(staged.batch)
        return staged

    @property
    def staged_batches(self) -> List[StagedBatch]:
        return list(self._staged)

    def committed_pp_seq_no(self) -> int:
        if self.audit_handler is None:
            return 0
        return self.audit_handler.committed_pp_seq_no()


class NodeExecutor:
    """Adapter: OrderingService ``Executor`` seam -> WriteRequestManager.

    ``get_view_info`` supplies (view_no, primaries) for the audit txn.
    """

    def __init__(self, manager: WriteRequestManager, get_view_info=None):
        self.manager = manager
        self._get_view_info = get_view_info or (lambda: (0, []))
        # requests the last apply_batch rejected in dynamic validation —
        # the ordering service reads this to fill PrePrepare.discarded (on
        # the primary) and to cross-check it on re-apply (replicas)
        self.last_rejected: List[Tuple[Request, Exception]] = []

    def apply_batch(self, reqs: List[Request], ledger_id: int,
                    pp_time: int, pp_seq_no: int
                    ) -> Tuple[Optional[str], Optional[str]]:
        self.last_rejected = []
        committed = self.committed_seq()
        if pp_seq_no <= committed:
            # historical: already durably executed (pre-view-change); the
            # audit ledger knows the roots this batch must carry
            audit = self.manager.audit_handler
            data = audit.audit_data_for_seq(pp_seq_no) if audit else None
            if data is None:
                return None, None
            return (data[AUDIT_TXN_STATE_ROOT].get(str(ledger_id)),
                    data[AUDIT_TXN_LEDGER_ROOT].get(str(ledger_id)))
        view_no, primaries = self._get_view_info()
        batch = ThreePcBatch(
            ledger_id=ledger_id,
            inst_id=0,
            view_no=view_no,
            pp_seq_no=pp_seq_no,
            pp_time=pp_time,
            state_root=None,
            txn_root=None,
            valid_digests=[r.digest for r in reqs],
            primaries=primaries,
        )
        state_root, txn_root, rejected = self.manager.apply_batch(batch, reqs)
        self.last_rejected = rejected
        return b58encode(state_root), b58encode(txn_root)

    def revert_batches(self, ledger_id: int, count: int) -> None:
        self.manager.revert_batches(ledger_id, count)

    def committed_seq(self) -> int:
        return self.manager.committed_pp_seq_no()

    def commit_batch(self, pp_seq_no: int) -> Optional[StagedBatch]:
        if pp_seq_no <= self.committed_seq():
            return None  # already durable (re-ordered after view change)
        staged = self.manager.commit_next_batch()
        assert staged.pp_seq_no == pp_seq_no, (staged.pp_seq_no, pp_seq_no)
        return staged
