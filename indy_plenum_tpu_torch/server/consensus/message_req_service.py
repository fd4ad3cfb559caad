"""Fetching missing protocol messages from peers.

Reference: plenum/server/consensus/message_request_service.py
(`MessageReqService`). MESSAGE_REQUEST(type, params) asks peers for a
message we should have (a 3PC message for a key, a VIEW_CHANGE we lack);
MESSAGE_RESPONSE carries it back and it is re-injected through the normal
processing path (so all validation still applies).

Copy of ``indy_plenum_tpu/server/consensus/message_req_service.py``, with
its imports bound to the port.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, Optional

from ...common.event_bus import ExternalBus, InternalBus
from ...common.messages.internal_messages import MissingMessage
from ...common.messages.message_base import node_message_registry
from ...common.messages.node_messages import (
    MessageRep,
    MessageReq,
    PrePrepare,
    Prepare,
    Commit,
    Propagate,
    ViewChange,
)
from ...common.stashing_router import DISCARD, PROCESS, StashingRouter

logger = logging.getLogger(__name__)

PREPREPARE = "PREPREPARE"
PREPARE = "PREPARE"
COMMIT = "COMMIT"
VIEW_CHANGE = "VIEW_CHANGE"
OLD_VIEW_PREPREPARE = "OLD_VIEW_PREPREPARE"
PROPAGATE = "PROPAGATE"


class MessageReqService:
    """Answers peers' requests from our logs; asks peers for what we lack."""

    def __init__(self,
                 data,
                 bus: InternalBus,
                 network: ExternalBus,
                 ordering_service=None,
                 view_change_service=None,
                 propagator=None):
        self._data = data
        self._bus = bus
        self._network = network
        self._ordering = ordering_service
        self._view_change = view_change_service
        self._propagator = propagator
        # (msg_type, params_key) we actually asked for; unsolicited
        # MESSAGE_RESPONSEs are dropped
        self._outstanding: set = set()

        network.subscribe(MessageReq, self.process_message_req)
        network.subscribe(MessageRep, self.process_message_rep)
        bus.subscribe(MissingMessage, self.process_missing_message)

    # --- outbound requests ---------------------------------------------

    def process_missing_message(self, msg: MissingMessage) -> None:
        params: Dict[str, Any]
        dst = msg.dst
        if msg.msg_type in (PREPREPARE, PREPARE, COMMIT):
            view_no, pp_seq_no = msg.key
            params = {"viewNo": view_no, "ppSeqNo": pp_seq_no,
                      "instId": str(msg.inst_id)}
            if msg.msg_type == PREPREPARE and self._data.primaries:
                # Only the primary's PRE-PREPARE is authoritative: asking
                # anyone else would let a relayer forge primary-attributed
                # content (its roots/digest failures would be blamed on the
                # primary).
                dst = [self._data.primaries[self._data.inst_id]]
        elif msg.msg_type == VIEW_CHANGE:
            sender, digest = msg.key
            params = {"sender": sender, "digest": digest}
        elif msg.msg_type == OLD_VIEW_PREPREPARE:
            # broadcast: ANY node that prepared the batch holds it; the
            # digest in the key authenticates whatever comes back
            orig_view, pp_seq_no, digest = msg.key
            params = {"originalViewNo": orig_view, "ppSeqNo": pp_seq_no,
                      "digest": digest}
        elif msg.msg_type == PROPAGATE:
            # broadcast: the digest authenticates the carried request
            params = {"digest": str(msg.key)}
        else:
            return
        self._outstanding.add((msg.msg_type, self._params_key(params)))
        req = MessageReq(msg_type=msg.msg_type, params=params)
        self._network.send(req, dst)

    @staticmethod
    def _params_key(params: Dict[str, Any]):
        return tuple(sorted((k, str(v)) for k, v in params.items()))

    # --- inbound requests ----------------------------------------------

    def process_message_req(self, req: MessageReq, sender: str):
        handler = {
            PREPREPARE: self._find_preprepare,
            PREPARE: self._find_prepare,
            COMMIT: self._find_commit,
            VIEW_CHANGE: self._find_view_change,
            OLD_VIEW_PREPREPARE: self._find_old_view_preprepare,
            PROPAGATE: self._find_propagate,
        }.get(req.msg_type)
        if handler is None:
            return DISCARD, f"unknown msg_type {req.msg_type}"
        found = handler(req.params)
        if found is None:
            return DISCARD, "not found"
        rep = MessageRep(msg_type=req.msg_type, params=req.params,
                         msg=found.as_dict())
        self._network.send(rep, [sender])
        return PROCESS

    def _key_from(self, params) -> Optional[tuple]:
        try:
            return int(params["viewNo"]), int(params["ppSeqNo"])
        except (KeyError, ValueError, TypeError):
            return None

    def _find_preprepare(self, params):
        key = self._key_from(params)
        if key is None or self._ordering is None:
            return None
        # the primary keeps its OWN batches in sent_preprepares, not
        # prePrepares — and PRE-PREPARE requests go only to the primary,
        # so that log is the one that matters for a straggler's re-sync
        return (self._ordering.prePrepares.get(key)
                or self._ordering.sent_preprepares.get(key))

    def _find_prepare(self, params):
        key = self._key_from(params)
        if key is None or self._ordering is None:
            return None
        votes = self._ordering.prepares.get(key, {})
        return votes.get(self._data.name)

    def _find_commit(self, params):
        key = self._key_from(params)
        if key is None or self._ordering is None:
            return None
        votes = self._ordering.commits.get(key, {})
        return votes.get(self._data.name)

    def _find_old_view_preprepare(self, params):
        if self._ordering is None:
            return None
        try:
            key = (int(params["originalViewNo"]), int(params["ppSeqNo"]),
                   str(params["digest"]))
        except (KeyError, ValueError, TypeError):
            return None
        found = self._ordering.old_view_preprepares.get(key)
        if found is None:
            # the batch may still be live in the current-view log
            for pp in self._ordering.prePrepares.values():
                orig = pp.originalViewNo if pp.originalViewNo is not None \
                    else pp.viewNo
                if (orig, pp.ppSeqNo, pp.digest) == key:
                    return pp
        return found

    def _find_propagate(self, params):
        if self._propagator is None:
            return None
        digest = params.get("digest")
        if not digest:
            return None
        return self._propagator.find_propagate(str(digest))

    def _find_view_change(self, params):
        if self._view_change is None:
            return None
        from .view_change_service import view_change_digest

        sender = params.get("sender")
        digest = params.get("digest")
        vc = self._view_change._view_changes.get(sender)
        if vc is not None and view_change_digest(vc) == digest:
            return vc
        return None

    @staticmethod
    def _batch_digest_of(pp: PrePrepare) -> str:
        from .ordering_service import OrderingService

        return OrderingService._batch_digest(
            list(pp.reqIdr), pp.ppTime, pp.stateRootHash, pp.txnRootHash,
            pp.ledgerId, pp.discarded)

    # --- inbound responses ---------------------------------------------

    def process_message_rep(self, rep: MessageRep, sender: str):
        if rep.msg is None:
            return DISCARD, "empty MESSAGE_RESPONSE"
        key = (rep.msg_type, self._params_key(dict(rep.params)))
        if key not in self._outstanding:
            return DISCARD, "unsolicited MESSAGE_RESPONSE"
        try:
            msg = node_message_registry.obj_from_dict(dict(rep.msg))
        except Exception as exc:  # noqa: BLE001 - wire data is untrusted
            return DISCARD, f"bad payload: {exc}"
        expected = {PREPREPARE: PrePrepare, PREPARE: Prepare,
                    COMMIT: Commit, VIEW_CHANGE: ViewChange,
                    OLD_VIEW_PREPREPARE: PrePrepare,
                    PROPAGATE: Propagate}.get(rep.msg_type)
        if expected is None or not isinstance(msg, expected):
            return DISCARD, "payload type mismatch"
        if rep.msg_type == PROPAGATE:
            # the carried request must hash to the digest we asked for —
            # the responder cannot substitute a different request
            from ...common.request import Request

            try:
                digest = Request.from_dict(dict(msg.request)).digest
            except Exception as exc:  # noqa: BLE001 — untrusted wire data
                return DISCARD, f"bad PROPAGATE payload: {exc}"
            if digest != str(rep.params.get("digest")):
                return DISCARD, "PROPAGATE digest mismatch"
            self._outstanding.discard(key)
            self._network.process_incoming(msg, sender)
            return PROCESS
        if rep.msg_type == OLD_VIEW_PREPREPARE:
            # content is authenticated by the digest we asked for (it came
            # out of NEW_VIEW's weak-quorum-supported batch id)
            orig = msg.originalViewNo if msg.originalViewNo is not None \
                else msg.viewNo
            want = rep.params
            if (str(msg.digest) != str(want.get("digest"))
                    or int(orig) != int(want.get("originalViewNo", -1))
                    or int(msg.ppSeqNo) != int(want.get("ppSeqNo", -1))):
                return DISCARD, "old-view PRE-PREPARE mismatch"
            if msg.digest != self._batch_digest_of(msg):
                return DISCARD, "old-view PRE-PREPARE digest forged"
            self._outstanding.discard(key)
            if self._ordering is not None:
                self._ordering.process_requested_old_view_pp(msg)
            return PROCESS
        if isinstance(msg, PrePrepare):
            # Requests for PRE-PREPAREs only go to the primary (see
            # process_missing_message), so the relayer IS the claimed
            # author; require the key to match what we asked for.
            requested_key = self._key_from(rep.params)
            if requested_key != (msg.viewNo, msg.ppSeqNo):
                return DISCARD, "PRE-PREPARE key mismatch"
            if self._data.primaries and \
                    sender != self._data.primaries[self._data.inst_id]:
                return DISCARD, "PRE-PREPARE response not from primary"
            frm = sender
        elif isinstance(msg, ViewChange):
            # digest binds the content: any relayer is safe
            from .view_change_service import view_change_digest

            claimed_sender = rep.params.get("sender", sender)
            if view_change_digest(msg) != rep.params.get("digest"):
                return DISCARD, "VIEW_CHANGE digest mismatch"
            frm = claimed_sender
        else:
            # a peer's own PREPARE/COMMIT: attributed to the relayer, which
            # is exactly whose vote it is
            frm = sender
        self._outstanding.discard(key)
        self._network.process_incoming(msg, frm)
        return PROCESS
