"""Instance-change voting: degradation evidence -> view change.

Reference: plenum/server/consensus/view_change_trigger_service.py
(`ViewChangeTriggerService`). Nodes vote INSTANCE_CHANGE(v) on master
degradation (Monitor), primary disconnect, or other suspicion; with f+1
votes for a view we join the vote (so slow nodes catch up the vote); with
n-f votes we start the view change (`NodeNeedViewChange` on the internal
bus). Votes expire after INSTANCE_CHANGE_TIMEOUT.

Copy of ``indy_plenum_tpu/server/consensus/view_change_trigger_service.py``,
with its imports bound to the port.
"""
from __future__ import annotations

import logging
from typing import Dict, Tuple

from ...common.event_bus import ExternalBus, InternalBus
from ...common.messages.internal_messages import (
    NodeNeedViewChange,
    PrimaryDisconnected,
    RaisedSuspicion,
    VoteForViewChange,
)
from ...common.messages.node_messages import InstanceChange
from ...common.stashing_router import DISCARD, PROCESS, StashingRouter
from ...common.timer import TimerService
from ..suspicion_codes import Suspicions
from .consensus_shared_data import ConsensusSharedData

logger = logging.getLogger(__name__)


class ViewChangeTriggerService:
    def __init__(self,
                 data: ConsensusSharedData,
                 timer: TimerService,
                 bus: InternalBus,
                 network: ExternalBus,
                 stasher: StashingRouter,
                 config=None):
        from ...config import getConfig

        self._data = data
        self._timer = timer
        self._bus = bus
        self._network = network
        self._stasher = stasher
        self._config = config or getConfig()

        # proposed_view -> {sender -> vote time}
        self._votes: Dict[int, Dict[str, float]] = {}

        stasher.subscribe(InstanceChange, self.process_instance_change)
        bus.subscribe(VoteForViewChange, self.process_vote_for_view_change)
        bus.subscribe(PrimaryDisconnected, self.process_primary_disconnected)
        bus.subscribe(RaisedSuspicion, self.process_raised_suspicion)

    # suspicions that convict the PRIMARY of protocol fraud for the
    # current view (reference: the instance-change-provoking suspicion set
    # consumed by Node.reportSuspiciousNodeEx): equivocation, forged
    # digests/roots/times, wrong discarded counts, bad multi-sigs in
    # PRE-PREPAREs. Derived from the named catalogue so a renumbering in
    # suspicion_codes.py cannot silently desync this set.
    PRIMARY_FAULT_CODES = frozenset(s.code for s in (
        Suspicions.DUPLICATE_PPR_SENT,
        Suspicions.PPR_DIGEST_WRONG,
        Suspicions.PPR_STATE_WRONG,
        Suspicions.PPR_TXN_WRONG,
        Suspicions.PPR_TIME_WRONG,
        Suspicions.PPR_BLS_MULTISIG_WRONG,
        Suspicions.PPR_AUDIT_TXN_ROOT_WRONG,
        Suspicions.PPR_DISCARDED_WRONG,
    ))

    def process_raised_suspicion(self, msg: RaisedSuspicion, *args) -> None:
        """Byzantine evidence that convicts the master primary becomes a
        view-change vote — without this, an equivocating primary stalls
        the pool in silence."""
        if msg.inst_id != self._data.inst_id or not self._data.is_master:
            return
        ex = msg.ex
        code = getattr(getattr(ex, "suspicion", None), "code", None)
        if code in self.PRIMARY_FAULT_CODES \
                and getattr(ex, "node", None) == self._data.primary_name:
            logger.info("%s: primary %s convicted (%s) -> view change",
                        self._data.name, ex.node, ex.suspicion)
            self._send_instance_change(self._data.view_no + 1, ex.suspicion)

    # ------------------------------------------------------------------

    def process_vote_for_view_change(self, msg: VoteForViewChange) -> None:
        view_no = msg.view_no if msg.view_no is not None \
            else self._data.view_no + 1
        suspicion = msg.suspicion
        self._send_instance_change(view_no, suspicion)

    def process_primary_disconnected(self, msg: PrimaryDisconnected) -> None:
        self._send_instance_change(
            self._data.view_no + 1, Suspicions.PRIMARY_DISCONNECTED)

    def _send_instance_change(self, view_no: int, suspicion) -> None:
        code = getattr(suspicion, "code", 0)
        ic = InstanceChange(viewNo=view_no, reason=code)
        self._record_vote(view_no, self._data.name)
        self._network.send(ic)
        logger.info("%s voted INSTANCE_CHANGE for view %d (%s)",
                    self._data.name, view_no,
                    getattr(suspicion, "reason", suspicion))
        self._try_start(view_no)

    def process_instance_change(self, ic: InstanceChange, sender: str):
        if sender != self._data.name \
                and sender not in self._data.validators:
            return DISCARD, "INSTANCE_CHANGE from non-validator"
        if ic.viewNo <= self._data.view_no:
            return DISCARD, "proposed view not ahead"
        self._record_vote(ic.viewNo, sender)
        # join the vote with weak-quorum evidence (someone honest voted)
        votes = self._votes.get(ic.viewNo, {})
        if (self._data.quorums.weak.is_reached(len(votes))
                and self._data.name not in votes):
            self._send_instance_change(
                ic.viewNo, Suspicions.get_by_code(ic.reason)
                or Suspicions.VIEW_CHANGE_WRONG)
        self._try_start(ic.viewNo)
        return PROCESS

    # ------------------------------------------------------------------

    def _record_vote(self, view_no: int, sender: str) -> None:
        self._gc_expired()
        self._votes.setdefault(view_no, {})[sender] = \
            self._timer.get_current_time()

    def _gc_expired(self) -> None:
        ttl = self._config.INSTANCE_CHANGE_TIMEOUT
        now = self._timer.get_current_time()
        for view_no in list(self._votes):
            votes = self._votes[view_no]
            for sender in [s for s, t in votes.items() if now - t > ttl]:
                del votes[sender]
            if not votes:
                del self._votes[view_no]

    def _try_start(self, view_no: int) -> None:
        if view_no <= self._data.view_no:
            return
        votes = self._votes.get(view_no, {})
        if self._data.quorums.view_change.is_reached(len(votes)):
            logger.info("%s instance-change quorum for view %d",
                        self._data.name, view_no)
            self._votes.pop(view_no, None)
            self._bus.send(NodeNeedViewChange(view_no=view_no))
