"""Catalogued byzantine-evidence codes.

Reference: plenum/server/suspicion_codes.py (`Suspicion`, `Suspicions`).
Raised as :class:`indy_plenum_tpu_torch.common.exceptions.SuspiciousNode`; the node
counts them per peer and can blacklist.

Copy of ``indy_plenum_tpu/server/suspicion_codes.py``, with its imports
bound to the port.
"""
from __future__ import annotations

from typing import NamedTuple


class Suspicion(NamedTuple):
    code: int
    reason: str


class Suspicions:
    PPR_FRM_NON_PRIMARY = Suspicion(1, "PRE-PREPARE from a non-primary")
    PR_FRM_PRIMARY = Suspicion(2, "PREPARE from the primary")
    DUPLICATE_PPR_SENT = Suspicion(3, "duplicate PRE-PREPARE for a 3PC key")
    DUPLICATE_PR_SENT = Suspicion(4, "duplicate PREPARE from one sender")
    DUPLICATE_CM_SENT = Suspicion(5, "duplicate COMMIT from one sender")
    PPR_DIGEST_WRONG = Suspicion(6, "PRE-PREPARE request digest mismatch")
    PR_DIGEST_WRONG = Suspicion(7, "PREPARE digest mismatch")
    CM_DIGEST_WRONG = Suspicion(8, "COMMIT digest mismatch")
    PPR_STATE_WRONG = Suspicion(9, "PRE-PREPARE state root mismatch on re-apply")
    PPR_TXN_WRONG = Suspicion(10, "PRE-PREPARE txn root mismatch on re-apply")
    PR_STATE_WRONG = Suspicion(11, "PREPARE state root mismatch")
    PR_TXN_WRONG = Suspicion(12, "PREPARE txn root mismatch")
    PPR_TIME_WRONG = Suspicion(13, "PRE-PREPARE timestamp out of bounds")
    CM_BLS_WRONG = Suspicion(14, "COMMIT BLS signature invalid")
    PPR_BLS_MULTISIG_WRONG = Suspicion(15, "PRE-PREPARE BLS multi-sig invalid")
    PPR_AUDIT_TXN_ROOT_WRONG = Suspicion(16, "PRE-PREPARE audit root mismatch")
    PPR_DISCARDED_WRONG = Suspicion(
        17, "PRE-PREPARE discarded count mismatch on re-apply")
    INSTANCE_CHANGE_SPOOFED = Suspicion(20, "INSTANCE_CHANGE signature bad")
    VIEW_CHANGE_WRONG = Suspicion(21, "VIEW_CHANGE malformed or inconsistent")
    NEW_VIEW_INVALID = Suspicion(22, "NEW_VIEW does not match VIEW_CHANGEs")
    NEW_VIEW_CHECKPOINT_WRONG = Suspicion(
        23, "NEW_VIEW checkpoint not supported by view-change quorum")
    CHK_DIGEST_WRONG = Suspicion(24, "CHECKPOINT digest mismatch at stable")
    PRIMARY_DEGRADED = Suspicion(
        25, "master primary degraded (throughput/latency vs backups)")
    PRIMARY_DEMOTED = Suspicion(
        26, "master primary left the validator set (NODE txn demotion)")
    PRIMARY_DISCONNECTED = Suspicion(
        27, "primary unreachable past ToleratePrimaryDisconnection")
    ORDERING_STALLED = Suspicion(
        28, "no ordering progress with requests pending "
            "(PBFT liveness timer expired)")
    SEQ_NO_OLD = Suspicion(30, "3PC message below watermark")
    SEQ_NO_FUTURE = Suspicion(31, "3PC message above watermark")
    CATCHUP_REP_WRONG = Suspicion(40, "CATCHUP_REP txns fail audit proof")
    LEDGER_STATUS_WRONG = Suspicion(41, "LEDGER_STATUS inconsistent")
    CATCHUP_FAILED = Suspicion(
        42, "catchup failed after divergence conviction; node stays "
            "non-participating (fail-closed) and retries on backoff")
    PROPAGATE_DIGEST_WRONG = Suspicion(50, "PROPAGATE digest != request digest")

    @classmethod
    def get_by_code(cls, code: int) -> Suspicion | None:
        for val in vars(cls).values():
            if isinstance(val, Suspicion) and val.code == code:
                return val
        return None
