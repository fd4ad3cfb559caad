"""The pool client: submit requests, collect quorum replies.

Reference: plenum/client/client.py (`Client`). Transport-agnostic: the
composition supplies ``send(request, node_name, client_id)`` (a ZMQ client
stack in production, direct node handles in the simulation) and routes
every node->client message into :meth:`process_node_message`.

Write path: submit to one or more nodes, collect REPLYs, and accept a
result once f+1 DISTINCT nodes returned the identical committed txn —
at least one of them is honest. Read path (GET_NYM): submit to ONE node
and accept its single reply iff the carried state proof verifies against
the pool's BLS keys (client/state_proof.verify_proved_reply) — a proved
read from one node is as trustworthy as f+1 matching replies.

Copy of ``indy_plenum_tpu/client/client.py``, with its imports bound to
the port.
"""
from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, List, Optional

from ..common.constants import GET_NYM, GET_TXN, TARGET_NYM
from ..common.messages.node_messages import Reply, RequestAck, RequestNack
from ..common.request import Request
from ..common.txn_util import get_digest
from ..utils.base58 import b58decode
from .state_proof import StateProofReply, verify_proved_reply

logger = logging.getLogger(__name__)

# a proved read's multi-signature must be recent: an old root with a
# genuine pool signature could otherwise serve provably-signed STALE state
DEFAULT_PROOF_MAX_AGE = 300.0  # seconds


class RequestRejected(Exception):
    """Raised by :meth:`Client.take_result` when the pool NACKed the
    request (>f distinct rejections). Carries the evidence and frees the
    request's state — a poll loop terminates instead of spinning, and a
    long-running client doesn't accumulate rejected entries."""

    def __init__(self, digest: str, nacks: Dict[str, str]):
        super().__init__(f"request {digest} rejected: {nacks}")
        self.digest = digest
        self.nacks = dict(nacks)


class PendingRequest:
    def __init__(self, request: Request, needed: int):
        self.request = request
        self.needed = needed
        self.replies: Dict[str, dict] = {}  # node -> result
        self.acks: set = set()
        self.nacks: Dict[str, str] = {}
        self.result: Optional[dict] = None  # set once quorum reached

    def add_reply(self, node: str, result: dict) -> None:
        self.replies[node] = result
        if self.result is not None:
            return
        by_content: Dict[str, List[str]] = {}
        for n, r in self.replies.items():
            by_content.setdefault(repr(sorted(r.items())), []).append(n)
        for content, nodes in by_content.items():
            if len(nodes) >= self.needed:
                self.result = self.replies[nodes[0]]
                return


class Client:
    def __init__(self,
                 name: str,
                 validators,
                 send: Callable[[Request, str, str], Any],
                 pool_bls_keys=None,
                 now_provider: Callable[[], float] = time.time,
                 proof_max_age: float = DEFAULT_PROOF_MAX_AGE):
        """``validators`` and ``pool_bls_keys`` may be values OR zero-arg
        providers: with dynamic membership (NODE txns) the client must
        verify against the CURRENT pool, not its construction-time view."""
        self.name = name
        self._validators_src = validators
        self._send = send
        self._bls_keys_src = pool_bls_keys or {}
        self._now = now_provider
        self._proof_max_age = proof_max_age
        self.pending: Dict[str, PendingRequest] = {}  # digest -> state
        # (identifier, reqId) -> state: inbound ACK/NACK/REPLY matching is
        # O(1), not O(pending) — the load-generator shape
        self._by_idr: Dict[tuple, PendingRequest] = {}
        self.proved_reads: Dict[str, dict] = {}  # digest -> verified result

    @property
    def _validators(self) -> List[str]:
        src = self._validators_src
        return list(src() if callable(src) else src)

    @property
    def _pool_bls_keys(self) -> Dict[str, str]:
        src = self._bls_keys_src
        return dict(src() if callable(src) else src)

    @property
    def _f(self) -> int:
        return (len(self._validators) - 1) // 3

    # ------------------------------------------------------------------

    def submit_write(self, request: Request,
                     to: Optional[List[str]] = None) -> str:
        """Send a write to ``to`` (default: all validators — the client
        needs f+1 REPLYs, and up to f nodes may ignore it)."""
        targets = to if to is not None else list(self._validators)
        self._track(request, needed=self._f + 1)
        for node in targets:
            self._send(request, node, self.name)
        return request.digest

    def submit_read(self, request: Request,
                    to: Optional[str] = None) -> str:
        """Proved reads (GET_NYM) go to ONE node — the reply carries a
        verifiable proof. Reads WITHOUT a proof surface (GET_TXN) fall
        back to the f+1 matching-reply quorum across the pool: a single
        unproved answer is never trusted."""
        if request.txn_type == GET_NYM:
            node = to or self._validators[0]
            self._track(request, needed=1)
            self._send(request, node, self.name)
        else:
            self._track(request, needed=self._f + 1)
            for node in self._validators:
                self._send(request, node, self.name)
        return request.digest

    def submit_action(self, request: Request, to: Optional[str] = None
                      ) -> str:
        """Privileged operational actions (VALIDATOR_INFO, POOL_RESTART)
        are point queries: each node answers for ITSELF, so one reply
        from the asked node is the answer — no quorum to wait for."""
        node = to or self._validators[0]
        self._track(request, needed=1)
        self._send(request, node, self.name)
        return request.digest

    def _track(self, request: Request, needed: int) -> PendingRequest:
        """Register a pending request. (identifier, reqId) must be unique
        among in-flight requests — node replies carry only that pair, so
        a DIFFERENT request under a known pair would silently steal the
        earlier one's replies. Resubmitting the SAME request (retry after
        a lost REPLY) reuses its existing state and goes out again."""
        key = (request.identifier, request.reqId)
        existing = self._by_idr.get(key)
        if existing is not None:
            if existing.request.digest == request.digest:
                return existing  # retry: resend, keep collected replies
            # NOT auto-retired even when completed: the collision may be
            # an application bug and the earlier result may be unread —
            # silently dropping it would mask the bug as reply loss. The
            # recovery path for legitimate reuse (wallet counter reset)
            # is take_result()/retire(), which frees the slot.
            raise ValueError(
                f"reqId {request.reqId} already used by a different "
                f"request for {request.identifier}; take_result()/"
                f"retire() the old request or pick a fresh reqId")
        state = self.pending[request.digest] = PendingRequest(
            request, needed=needed)
        self._by_idr[key] = state
        return state

    # ------------------------------------------------------------------

    def process_node_message(self, node_name: str, msg) -> None:
        if isinstance(msg, Reply):
            self._process_reply(node_name, dict(msg.result))
        elif isinstance(msg, RequestNack):
            self._process_nack(node_name, msg)
        elif isinstance(msg, RequestAck):
            self._process_ack(node_name, msg)

    def _match_pending(self, identifier, req_id) -> Optional[PendingRequest]:
        return self._by_idr.get((identifier, req_id))

    def _process_ack(self, node_name: str, msg: RequestAck) -> None:
        state = self._match_pending(msg.identifier, msg.reqId)
        if state is not None:
            state.acks.add(node_name)

    def _process_nack(self, node_name: str, msg: RequestNack) -> None:
        state = self._match_pending(msg.identifier, msg.reqId)
        if state is not None:
            state.nacks[node_name] = msg.reason

    def _process_reply(self, node_name: str, result: dict) -> None:
        state = self._match_pending(result.get("identifier"),
                                    result.get("reqId"))
        if state is None:
            return
        reply_digest = get_digest(result)
        if reply_digest is not None and \
                reply_digest != state.request.digest:
            # a straggler for a RETIRED request whose (identifier, reqId)
            # slot was legitimately reused: counting it toward the NEW
            # request's quorum would resolve it with the old result.
            # Write replies carry the request digest in the txn envelope;
            # replies without one fall through (reads validate against
            # our own request's operation instead).
            return
        digest = state.request.digest
        # the single-reply proved path applies ONLY when WE asked a proved
        # read: a byzantine node must not be able to short-circuit a
        # write's f+1 quorum by attaching a (genuine) proof of something
        if state.request.txn_type == GET_NYM:
            proof = result.get("state_proof")
            if proof is not None and self._verify_proved_read(
                    state.request, result, proof):
                self.proved_reads[digest] = result
                state.result = result
            else:
                logger.warning("client %s: unverifiable proved reply "
                               "from %s dropped", self.name, node_name)
            return
        if state.request.txn_type == GET_TXN and state.result is None:
            # a single reply may carry an audit proof + the pool's
            # multi-signature over this ledger root — as trustworthy as
            # f+1 matching replies, which remain the fallback
            if self._verify_proved_get_txn(state.request, result):
                self.proved_reads[digest] = result
                state.result = result
                return
        state.add_reply(node_name, result)

    def _verify_proved_read(self, request: Request, result: dict,
                            proof: dict) -> bool:
        # the proof must be about the key WE asked for (from our own
        # request), never the key the reply claims to answer
        dest = request.operation.get(TARGET_NYM)
        if not isinstance(dest, str) or result.get("dest") != dest:
            return False
        try:
            reply = StateProofReply(
                key=dest.encode(),
                value=result.get("data"),
                root=b58decode(proof["root_hash"]),
                proof=proof["proof_nodes"],
                multi_sig_dict=proof.get("multi_signature"))
        except Exception:  # noqa: BLE001 — reply content is untrusted
            return False
        n = len(self._validators)
        return verify_proved_reply(
            reply, self._pool_bls_keys, min_participants=n - self._f,
            now=self._now(), max_age=self._proof_max_age)

    def _verify_proved_get_txn(self, request: Request,
                               result: dict) -> bool:
        """Audit path -> ledger root co-signed by the pool => one node's
        GET_TXN answer suffices (reference: clients verify proofs rather
        than counting replies whenever proof material exists)."""
        proof = result.get("auditProof") or {}
        ms_dict = proof.get("multi_signature")
        txn = result.get("data")
        seq_no = result.get("seqNo")
        if not ms_dict or txn is None or not isinstance(seq_no, int):
            return False
        if seq_no != request.operation.get("data"):
            return False  # answers the seqNo WE asked about, or nothing
        from ..common.constants import DOMAIN_LEDGER_ID

        if result.get("ledgerId") != request.operation.get(
                "ledgerId", DOMAIN_LEDGER_ID):
            return False  # and from the ledger WE asked about: a genuine
            # proof over the WRONG ledger's txn must not slip through
        try:
            from ..common.serializers.serialization import (
                ledger_txn_serializer,
            )
            from ..crypto.bls.bls_crypto import MultiSignature
            from ..ledger.merkle_verifier import STH, MerkleVerifier

            ms = MultiSignature.from_dict(ms_dict)
            root_b58 = proof["rootHash"]
            if ms.value.txn_root_hash != root_b58 \
                    or ms.value.ledger_id != result.get("ledgerId"):
                return False
            size = int(proof["ledgerSize"])
            path = [b58decode(h) for h in proof["auditPath"]]
            sth = STH(tree_size=size, sha256_root_hash=b58decode(root_b58))
            if not MerkleVerifier().verify_leaf_inclusion(
                    ledger_txn_serializer.dumps(txn), seq_no - 1, path,
                    sth):
                return False
            from .state_proof import verify_pool_multi_sig

            pool_keys = self._pool_bls_keys
            if not pool_keys:
                return False
            n = len(self._validators)
            return verify_pool_multi_sig(
                ms, pool_keys, min_participants=n - self._f,
                now=self._now(), max_age=self._proof_max_age)
        except Exception:  # noqa: BLE001 — reply content is untrusted
            return False

    # ------------------------------------------------------------------

    def result(self, digest: str) -> Optional[dict]:
        state = self.pending.get(digest)
        return state.result if state else None

    def take_result(self, digest: str) -> Optional[dict]:
        """``result()`` + retire: the long-running-client shape. Returns
        the result (and frees the slot) on success, None while the
        quorum is pending, and raises :class:`RequestRejected` — with
        the NACK evidence attached, freeing the slot — once >f nodes
        rejected, so a poll loop always terminates and neither outcome
        leaks memory."""
        res = self.result(digest)
        if res is not None:
            self.retire(digest)
            return res
        if self.is_rejected(digest):
            nacks = dict(self.pending[digest].nacks)
            self.retire(digest)
            raise RequestRejected(digest, nacks)
        return None

    def retire(self, digest: str) -> None:
        """Forget a request: frees its memory AND releases its
        (identifier, reqId) slot for legitimate reuse. Without this a
        long-running client grows without bound (round-4 advisor
        finding). Late replies for a retired digest are dropped by the
        normal unknown-request path."""
        state = self.pending.pop(digest, None)
        if state is not None:
            self._by_idr.pop(
                (state.request.identifier, state.request.reqId), None)
        self.proved_reads.pop(digest, None)

    def is_rejected(self, digest: str) -> bool:
        state = self.pending.get(digest)
        return bool(state and not state.result
                    and len(state.nacks) > self._f)
