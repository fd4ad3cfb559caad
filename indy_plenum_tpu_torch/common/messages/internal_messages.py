"""Internal-bus events between consensus services (never hit the wire).

Reference: plenum/common/messages/internal_messages.py. Plain NamedTuples:
no validation needed (trusted, in-process).

Copy of ``indy_plenum_tpu/common/messages/internal_messages.py``, with its
imports bound to the port.
"""
from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Tuple


class NeedViewChange(NamedTuple):
    view_no: Optional[int] = None  # None = next view


class ViewChangeStarted(NamedTuple):
    view_no: int


class NewViewAccepted(NamedTuple):
    view_no: int
    checkpoint: Tuple[int, int, str]  # (view_no, pp_seq_no, digest)
    batches: List[list]  # BatchIDs to re-order
    primary: str


class NewViewCheckpointsApplied(NamedTuple):
    view_no: int
    checkpoint: Tuple[int, int, str]
    batches: List[list]


class ViewChangeFinished(NamedTuple):
    view_no: int


class CheckpointStabilized(NamedTuple):
    inst_id: int
    last_stable_3pc: Tuple[int, int]  # (view_no, pp_seq_no)


class NeedBackupCatchup(NamedTuple):
    inst_id: int
    caught_up_till_3pc: Tuple[int, int]


class NodeNeedViewChange(NamedTuple):
    view_no: int


class PrimaryDisconnected(NamedTuple):
    inst_id: int


class PrimarySelected(NamedTuple):
    pass


class VoteForViewChange(NamedTuple):
    suspicion: Any  # Suspicion
    view_no: Optional[int] = None


class NewViewTimeoutExpired(NamedTuple):
    view_no: int


class ReOrderedInNewView(NamedTuple):
    pass


class CatchupFinished(NamedTuple):
    last_caught_up_3pc: Tuple[int, int]
    master_last_ordered: Tuple[int, int]


class NeedMasterCatchup(NamedTuple):
    pass


class RequestPropagates(NamedTuple):
    """Ask the node to re-broadcast PROPAGATEs for missing requests."""

    bad_requests: List[str]  # digests


class PreSigVerification(NamedTuple):
    """A batch of inbound signed messages queued for device verification."""

    msgs: List[Any]


class MissingMessage(NamedTuple):
    msg_type: str
    key: Any
    inst_id: int
    dst: Optional[List[str]]
    stash_data: Optional[Any] = None


class RaisedSuspicion(NamedTuple):
    inst_id: int
    ex: Any  # SuspiciousNode


class Ordered3PC(NamedTuple):
    """Internal companion to the wire-level Ordered (master instance only)."""

    inst_id: int
    view_no: int
    pp_seq_no: int
