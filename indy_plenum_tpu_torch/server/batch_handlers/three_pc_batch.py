"""Value object describing one 3PC batch flowing through the batch handlers.

Reference: plenum/server/batch_handlers/three_pc_batch.py (`ThreePcBatch`).

Copy of ``indy_plenum_tpu/server/batch_handlers/three_pc_batch.py``,
with its imports bound to the port.
"""
from __future__ import annotations

from typing import List, Optional


class ThreePcBatch:
    def __init__(self,
                 ledger_id: int,
                 inst_id: int,
                 view_no: int,
                 pp_seq_no: int,
                 pp_time: int,
                 state_root: Optional[bytes],
                 txn_root: Optional[bytes],
                 valid_digests: List[str],
                 pp_digest: str = "",
                 primaries: Optional[List[str]] = None,
                 original_view_no: Optional[int] = None):
        self.ledger_id = ledger_id
        self.inst_id = inst_id
        self.view_no = view_no
        self.pp_seq_no = pp_seq_no
        self.pp_time = pp_time
        self.state_root = state_root
        self.txn_root = txn_root
        self.valid_digests = list(valid_digests)
        self.pp_digest = pp_digest
        self.primaries = primaries or []
        self.original_view_no = original_view_no \
            if original_view_no is not None else view_no

    def __repr__(self):
        return (f"ThreePcBatch(lid={self.ledger_id}, "
                f"3pc=({self.view_no},{self.pp_seq_no}), "
                f"n={len(self.valid_digests)})")
