"""Request dissemination and f+1 finalisation (the PROPAGATE phase).

Reference: plenum/server/propagator.py (`Propagator` mixin + `Requests`
container). A client request received by any node is broadcast as
PROPAGATE(request, clientName); each node counts distinct senders per
request digest (its own PROPAGATE included) and *finalises* the request
once the f+1 propagate quorum is reached — only finalised requests are
eligible for 3PC batching. A node seeing a PROPAGATE for a request it has
not itself relayed relays it, so an honest request reaches quorum even if
the client talked to a single node.

The digest is recomputed locally from the carried request content, so a
byzantine node cannot poison another request's tally: lying about the
digest only creates a tally for the digest its content actually hashes to.

TPU-first note: propagation is pure bookkeeping and stays on the host; the
expensive part of ingress — signature verification — happened before
``propagate()`` via ``CoreAuthNr.authenticate_batch`` on the device.

Copy of ``indy_plenum_tpu/server/propagator.py``, with its imports bound to
the port.
"""
from __future__ import annotations

import logging
from typing import Callable, Dict, List, Optional, Set

from ..common.event_bus import ExternalBus
from ..common.messages.node_messages import Propagate
from ..common.request import Request
from ..common.stashing_router import DISCARD, PROCESS

logger = logging.getLogger(__name__)


class ReqState:
    __slots__ = ("request", "propagates", "finalised", "sent",
                 "auth_pending", "sender_client")

    def __init__(self, request: Request):
        self.request = request
        self.propagates: Set[str] = set()  # nodes whose PROPAGATE we saw
        self.finalised = False
        self.sent = False  # our own PROPAGATE broadcast already went out
        self.auth_pending = False  # queued in the node's auth pipeline
        self.sender_client: Optional[str] = None


class Requests(Dict[str, ReqState]):
    """digest -> ReqState (reference: plenum/server/propagator.py Requests)."""

    def add(self, request: Request) -> ReqState:
        state = self.get(request.digest)
        if state is None:
            state = ReqState(request)
            self[request.digest] = state
        return state

    def add_propagate(self, request: Request, sender: str) -> ReqState:
        state = self.add(request)
        state.propagates.add(sender)
        return state

    def votes(self, digest: str) -> int:
        state = self.get(digest)
        return len(state.propagates) if state else 0


class Propagator:
    """One node's propagation engine; plugs into the node's external bus.

    ``on_finalised(request)`` fires exactly once per digest when the f+1
    quorum is reached — the Node routes it into its requests pool.
    """

    def __init__(self,
                 name: str,
                 quorums,
                 network: ExternalBus,
                 on_finalised: Callable[[Request], None],
                 on_needs_auth: Optional[Callable[[Request], None]] = None,
                 is_already_committed: Optional[
                     Callable[[Request], bool]] = None,
                 is_validator: Optional[Callable[[str], bool]] = None):
        self._name = name
        # a Quorums object or a zero-arg provider returning the CURRENT
        # one — membership changes replace the node's Quorums instance,
        # and finalisation must follow the live f+1 threshold
        self._quorums = (quorums if callable(quorums)
                         else (lambda: quorums))
        self._network = network
        self._on_finalised = on_finalised
        # replay floor: once a request executes, its propagator state is
        # GC'd — late-arriving PROPAGATEs must not recreate it and
        # re-finalise the same request into a fresh batch
        self._is_already_committed = is_already_committed or (lambda r: False)
        # only CURRENT validators' propagates count toward f+1 (a demoted
        # node keeps its transport identity but loses its vote)
        self._is_validator = is_validator or (lambda s: True)
        # a relayed request we have NOT authenticated must pass through the
        # node's (device-batched) auth pipeline before we add our own vote:
        # relaying blindly would let f byzantine propagates + our echo
        # finalise an unauthenticated request. None = trust-the-carrier
        # mode for compositions without an authenticator.
        self._on_needs_auth = on_needs_auth
        self.requests = Requests()

    # --- ingress (a client request authenticated by this node) ---------

    def propagate(self, request: Request,
                  sender_client: Optional[str] = None) -> None:
        """Record our own propagate vote and broadcast it (once)."""
        if self._is_already_committed(request):
            return
        state = self.requests.add_propagate(request, self._name)
        if sender_client is not None:
            state.sender_client = sender_client
        if not state.sent:
            state.sent = True
            self._network.send(Propagate(
                request=request.as_dict(),
                senderClient=state.sender_client))
        self._try_finalise(state)

    # --- peer PROPAGATEs ------------------------------------------------

    def process_propagate(self, msg: Propagate, sender: str):
        try:
            request = Request.from_dict(dict(msg.request))
            digest = request.digest
        except Exception as exc:  # noqa: BLE001 — wire data is untrusted
            return DISCARD, f"malformed PROPAGATE: {exc}"
        if self._is_already_committed(request):
            return DISCARD, "request already committed"
        state = self.requests.add(request)
        if self._is_validator(sender):
            state.propagates.add(sender)
        if state.sender_client is None and msg.senderClient:
            state.sender_client = msg.senderClient
        # relay: our own vote is what lets the pool converge when only one
        # node heard the client (reference: Propagator.propagate on receipt)
        if not state.sent and not state.auth_pending:
            if self._on_needs_auth is not None:
                state.auth_pending = True
                self._on_needs_auth(state.request)
            else:
                state.sent = True
                state.propagates.add(self._name)
                self._network.send(Propagate(
                    request=request.as_dict(),
                    senderClient=state.sender_client))
        self._try_finalise(state)
        return PROCESS

    def _try_finalise(self, state: ReqState) -> None:
        if state.finalised:
            return
        if self._quorums().propagate.is_reached(len(state.propagates)):
            state.finalised = True
            logger.debug("%s finalised request %s (%d propagates)",
                         self._name, state.request.digest,
                         len(state.propagates))
            self._on_finalised(state.request)

    # --- recovery: a PRE-PREPARE referenced requests we lack ------------

    def is_finalised(self, digest: str) -> bool:
        state = self.requests.get(digest)
        return bool(state and state.finalised)

    def get(self, digest: str) -> Optional[Request]:
        state = self.requests.get(digest)
        return state.request if state else None

    def find_propagate(self, digest: str) -> Optional[Propagate]:
        """Serve a peer's MessageReq(PROPAGATE, digest) from our container.

        Only requests we VOUCH for are served: ones we propagated ourselves
        (sent => authenticated here) or that reached the f+1 quorum. A
        request merely stored pending authentication must not be servable —
        the fetched reply credits OUR propagate vote at the requester, and
        f byzantine propagates + our unvouched echo would finalise a
        request no honest node ever verified."""
        state = self.requests.get(digest)
        if state is None or not (state.sent or state.finalised):
            return None
        return Propagate(request=state.request.as_dict(),
                         senderClient=state.sender_client)

    def gc(self, digests: List[str]) -> None:
        """Ordered requests leave the container (reference: free after
        execution; MessageReq for them is no longer served)."""
        for d in digests:
            self.pop_state(d)

    def pop_state(self, digest: str) -> Optional[ReqState]:
        return self.requests.pop(digest, None)
