"""Bookkeeping for speculatively-applied (uncommitted) 3PC batches.

Copy of ``indy_plenum_tpu/server/request_managers/staged.py``,
with its imports bound to the port.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

from ..batch_handlers.three_pc_batch import ThreePcBatch


class StagedBatch(NamedTuple):
    ledger_id: int
    pp_seq_no: int
    view_no: int
    txn_count: int
    pre_state_root: Optional[bytes]  # state head before this batch applied
    state_root: Optional[bytes]  # state head after
    batch: ThreePcBatch
