"""Shared per-protocol-instance consensus state.

Reference: plenum/server/consensus/consensus_shared_data.py
(`ConsensusSharedData`) and plenum/server/consensus/batch_id.py (`BatchID`).
One instance of this object is shared by the ordering / checkpoint /
view-change services of a single protocol instance (replica); it is the
single source of truth for view number, primaries, watermarks and
in-flight batch certificates.

Copy of ``indy_plenum_tpu/server/consensus/consensus_shared_data.py``, with
its imports bound to the port.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from ...common.messages.node_messages import PrePrepare
from ..quorums import Quorums

# BatchID = [view_no, pp_view_no, pp_seq_no, pp_digest] (plain list on the
# wire; helpers in node_messages). Stored here as tuples for hashability.
BatchID = Tuple[int, int, int, str]


def preprepare_to_batch_id(pp: PrePrepare) -> BatchID:
    orig = pp.originalViewNo if pp.originalViewNo is not None else pp.viewNo
    return (pp.viewNo, orig, pp.ppSeqNo, pp.digest)


class ConsensusSharedData:
    def __init__(self, name: str, validators: List[str], inst_id: int,
                 is_master: bool = True, log_size: int = 300):
        self.name = name
        self.inst_id = inst_id
        self.is_master = is_master
        self.log_size = log_size

        self.view_no = 0
        self.waiting_for_new_view = False
        self.primaries: List[str] = []
        self.legacy_vc_in_progress = False

        self.validators: List[str] = []
        self.quorums: Quorums = Quorums(len(validators) or 1)
        self.set_validators(validators)

        # watermarks: batches may be 3PC-processed for h < seqNo <= H
        self.low_watermark = 0
        self.stable_checkpoint = 0

        # certificates held by this replica (ordered lists of BatchID)
        self.preprepared: List[BatchID] = []
        self.prepared: List[BatchID] = []

        self.last_ordered_3pc: Tuple[int, int] = (0, 0)
        self.last_completed_view_no = 0
        self.pp_seq_no = 0  # last pp seq no this primary assigned

        # node-level flags the services consult
        self.is_participating = True  # False while catching up
        self.is_synced = True
        self.node_mode_ready = True

        self.prev_view_prepare_cert: Optional[int] = None

    # --- validators / primaries ------------------------------------------

    def set_validators(self, validators: List[str]) -> None:
        self.validators = list(validators)
        self.quorums = Quorums(len(validators))

    @property
    def total_nodes(self) -> int:
        return len(self.validators)

    @property
    def primary_name(self) -> Optional[str]:
        if self.inst_id < len(self.primaries):
            return self.primaries[self.inst_id]
        return None

    def is_primary(self, name: Optional[str] = None) -> bool:
        return (name or self.name) == self.primary_name

    @property
    def is_primary_in_view(self) -> bool:
        return self.primary_name == self.name

    # --- watermarks -------------------------------------------------------

    @property
    def high_watermark(self) -> int:
        return self.low_watermark + self.log_size

    def is_in_watermarks(self, pp_seq_no: int) -> bool:
        return self.low_watermark < pp_seq_no <= self.high_watermark

    # --- certificates -----------------------------------------------------

    def preprepare_batch(self, bid: BatchID) -> None:
        if bid not in self.preprepared:
            self.preprepared.append(bid)

    def prepare_batch(self, bid: BatchID) -> None:
        if bid not in self.prepared:
            self.prepared.append(bid)

    def free_batch(self, bid: BatchID) -> None:
        if bid in self.preprepared:
            self.preprepared.remove(bid)
        if bid in self.prepared:
            self.prepared.remove(bid)

    def free_upto(self, pp_seq_no: int) -> None:
        self.preprepared = [b for b in self.preprepared if b[2] > pp_seq_no]
        self.prepared = [b for b in self.prepared if b[2] > pp_seq_no]

    def clear_batches(self) -> None:
        self.preprepared.clear()
        self.prepared.clear()

    def __repr__(self):
        return (f"ConsensusSharedData({self.name}, inst={self.inst_id}, "
                f"view={self.view_no}, h={self.low_watermark})")
