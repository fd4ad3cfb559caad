"""Answering peers' catchup requests from our committed ledgers.

Reference: plenum/server/catchup/seeder_service.py (`SeederService`).
Two inbound message types:

- ``LEDGER_STATUS`` from a peer: if the peer is behind us, reply with a
  ``CONSISTENCY_PROOF`` (their size -> our size, RFC 6962) so its
  ConsProofService can agree on a catchup target; if it matches us, echo
  our own ``LEDGER_STATUS`` (an "up to date" vote).
- ``CATCHUP_REQ`` for a txn range: reply with the txns AND a per-txn audit
  path against the requested ``catchupTill`` tree size (the TPU-first
  redesign: the leecher verifies the whole slice in one vmapped device
  kernel call instead of an incremental host tree fold).

Seeder-side throttling (overload robustness plane): serving a leecher is
host work the seeder steals from its own ordering loop — under ingress
saturation an unthrottled seeder can stall the very pool the leecher is
trying to rejoin. With ``CatchupSeederThrottleTxnsPerSec`` > 0 a token
bucket on the node's (virtual) clock bounds the serve rate; a slice the
bucket cannot cover is DEFERRED to the deterministic instant its tokens
accrue — never dropped, so the leecher's retry law sees a slow seeder,
not a silent one. Deferrals are metered (``catchup.seeder_deferred``)
and the chaos plane's catchup-under-saturation gate asserts ordering
kept moving while the meter ran.

Copy of ``indy_plenum_tpu/server/catchup/seeder_service.py``, with its
imports bound to the port.
"""
from __future__ import annotations

import logging
from typing import Optional

from ...common.event_bus import ExternalBus
from ...common.messages.node_messages import (
    CatchupRep,
    CatchupReq,
    ConsistencyProof,
    LedgerStatus,
)
from ...common.metrics_collector import MetricsName, NullMetricsCollector
from ...server.database_manager import DatabaseManager
from ...utils.base58 import b58encode

logger = logging.getLogger(__name__)

# cap on txns per CATCHUP_REP (the requester also slices; defence in depth)
MAX_TXNS_PER_REP = 10_000

# token-affordability tolerance (in txns — a thousandth of one is float
# debris): a wakeup scheduled for "when the bucket covers the head" must
# FIND it covered despite refill rounding, or it re-defers on a
# vanishing deficit forever
_TOKEN_EPS = 1e-3
# floor on the deferral wakeup delay: the virtual clock runs at epoch
# magnitude (~1.7e9), where one float ULP is ~2.4e-7 s — a deficit-sized
# delay below that rounds the wakeup back to NOW and freezes the clock
# in a same-instant fire loop. 10ms is noise against any real throttle
# rate and keeps every wakeup a genuine clock advance.
_MIN_DEFER_DELAY = 0.01


class SeederService:
    def __init__(self, network: ExternalBus, db: DatabaseManager,
                 own_name: str = "?", timer=None, config=None,
                 metrics=None):
        self._network = network
        self._db = db
        self._name = own_name
        self._metrics = metrics if metrics is not None \
            else NullMetricsCollector()
        # throttle state: armed only when both the knob and a timer are
        # provided (the timer defers replies AND is the bucket's clock —
        # virtual in simulation, so deferral instants replay per seed)
        self._timer = timer
        rate = config.CatchupSeederThrottleTxnsPerSec if config else 0.0
        self._throttle_rate = float(rate) if timer is not None else 0.0
        self._throttle_burst = max(
            1, int(config.CatchupSeederThrottleBurst)) if config else 1
        self._tokens = float(self._throttle_burst)
        self._tokens_at = timer.get_current_time() \
            if timer is not None else 0.0
        # deferred slices drain FIFO off ONE scheduled wakeup: per-slice
        # re-scheduling would let contending slices steal each other's
        # refill and spin sub-second deferral storms under load, and the
        # leecher's retry law re-asking a queued slice must not enqueue
        # a second copy (the dedupe set below)
        from collections import deque

        self._deferred: "deque" = deque()  # (key, req, sender)
        self._deferred_keys = set()
        self._wakeup_pending = False
        self.served_txns = 0
        self.deferred_total = 0
        network.subscribe(LedgerStatus, self.process_ledger_status)
        network.subscribe(CatchupReq, self.process_catchup_req)

    def _ledger(self, ledger_id: int):
        try:
            return self._db.get_ledger(ledger_id)
        except KeyError:
            return None

    # ------------------------------------------------------------------

    def own_ledger_status(self, ledger_id: int) -> Optional[LedgerStatus]:
        ledger = self._ledger(ledger_id)
        if ledger is None:
            return None
        return LedgerStatus(
            ledgerId=ledger_id,
            txnSeqNo=ledger.size,
            viewNo=None,
            ppSeqNo=None,
            merkleRoot=b58encode(ledger.root_hash),
            protocolVersion=2,
        )

    def process_ledger_status(self, status: LedgerStatus, sender: str):
        ledger = self._ledger(status.ledgerId)
        if ledger is None:
            return
        their_size = status.txnSeqNo
        if their_size > ledger.size:
            # the peer claims to be AHEAD of us: echo our own status. An
            # ahead-but-diverged peer (corrupt extra tail) gets no
            # consistency proofs from anyone — without this echo it could
            # never learn the pool's tip and would spin in catchup forever
            self._network.send(self.own_ledger_status(status.ledgerId),
                               [sender])
            return
        if their_size == ledger.size:
            # equality vote (also lets a diverged same-size peer notice the
            # root mismatch in our status)
            self._network.send(self.own_ledger_status(status.ledgerId),
                               [sender])
            return
        proof = ConsistencyProof(
            ledgerId=status.ledgerId,
            seqNoStart=their_size,
            seqNoEnd=ledger.size,
            viewNo=None,
            ppSeqNo=None,
            # root_hash_at(0) is the RFC 6962 empty-tree hash — one
            # convention everywhere (a zero-byte sentinel here would
            # desync from the statuses empty peers genuinely send)
            oldMerkleRoot=b58encode(ledger.root_hash_at(their_size)),
            newMerkleRoot=b58encode(ledger.root_hash),
            hashes=[b58encode(h)
                    for h in ledger.consistency_proof(their_size)],
        )
        self._network.send(proof, [sender])

    # ------------------------------------------------------------------

    def _refill(self) -> None:
        now = self._timer.get_current_time()
        self._tokens = min(
            float(self._throttle_burst),
            self._tokens + (now - self._tokens_at) * self._throttle_rate)
        self._tokens_at = now

    def _servable_range(self, req: CatchupReq):
        """The (start, end) this ledger can actually serve for ``req``
        RIGHT NOW, or None — validity is checked (and the throttle cost
        computed) against current ledger state, so garbage or
        beyond-the-tip requests never drain the bucket or occupy the
        deferral FIFO ahead of real slices."""
        ledger = self._ledger(req.ledgerId)
        if ledger is None:
            return None
        till = min(req.catchupTill, ledger.size)
        start = max(1, req.seqNoStart)
        end = min(req.seqNoEnd, till, start + MAX_TXNS_PER_REP - 1)
        if start > end or till <= 0:
            return None
        return start, end

    def _slice_cost(self, req: CatchupReq) -> int:
        """Token cost of what would actually be SERVED (the clamped
        range, not the raw request), capped at the burst so an
        over-wide slice still serves with a wait bounded by
        burst/rate. 0 = nothing servable."""
        rng = self._servable_range(req)
        if rng is None:
            return 0
        return min(rng[1] - rng[0] + 1, self._throttle_burst)

    def _throttle_defer(self, cost: int, req: CatchupReq,
                        sender: str) -> bool:
        """Token-bucket admission for one slice of ``cost`` txns. False
        = serve now (tokens debited). True = queued on the deferral
        FIFO — the leecher sees a slow seeder, never a silent one. A
        re-ask of a slice already queued (the leecher's retry law
        firing while we throttle) is absorbed into the queued copy."""
        if self._throttle_rate <= 0:
            return False
        if not self._deferred:  # FIFO fairness: never jump the queue
            self._refill()
            if self._tokens >= cost - _TOKEN_EPS:
                self._tokens = max(self._tokens - cost, 0.0)
                return False
        key = (sender, req.ledgerId, req.seqNoStart, req.seqNoEnd)
        if key not in self._deferred_keys:
            # the meter counts DISTINCT slices held back; a retry-law
            # re-ask of a slice already queued is absorbed silently
            self.deferred_total += 1
            self._metrics.add_event(MetricsName.CATCHUP_SEEDER_DEFERRED)
            self._deferred_keys.add(key)
            self._deferred.append((key, req, sender))
        self._schedule_wakeup()
        return True

    def _schedule_wakeup(self) -> None:
        """ONE pending wakeup at the deterministic instant the bucket
        covers the FIFO head (re-armed after each drain) — deferred
        slices never race each other for the refill."""
        if self._wakeup_pending or not self._deferred:
            return
        self._refill()
        head_cost = self._slice_cost(self._deferred[0][1])
        delay = max(max(head_cost - self._tokens, 0.0)
                    / self._throttle_rate, _MIN_DEFER_DELAY)
        self._wakeup_pending = True
        self._timer.schedule(delay, self._drain_deferred)

    def _drain_deferred(self) -> None:
        self._wakeup_pending = False
        while self._deferred:
            key, req, sender = self._deferred[0]
            self._refill()
            cost = self._slice_cost(req)
            if cost == 0:
                # became unservable while queued (ledger reset, stale
                # range): drop without debiting tokens
                self._deferred.popleft()
                self._deferred_keys.discard(key)
                continue
            if self._tokens < cost - _TOKEN_EPS:
                break
            self._deferred.popleft()
            self._deferred_keys.discard(key)
            self._tokens = max(self._tokens - cost, 0.0)
            self._serve_catchup_req(req, sender)
        self._schedule_wakeup()

    def process_catchup_req(self, req: CatchupReq, sender: str):
        if self._throttle_rate > 0:
            cost = self._slice_cost(req)
            if cost == 0:
                return  # nothing servable: never charge the bucket
            if self._throttle_defer(cost, req, sender):
                logger.debug("%s throttled catchup slice %s..%s for %s",
                             self._name, req.seqNoStart, req.seqNoEnd,
                             sender)
                return
        self._serve_catchup_req(req, sender)

    def _serve_catchup_req(self, req: CatchupReq, sender: str):
        rng = self._servable_range(req)
        if rng is None:
            return  # nothing we can serve
        start, end = rng
        ledger = self._ledger(req.ledgerId)
        till = min(req.catchupTill, ledger.size)
        self.served_txns += end - start + 1
        self._metrics.add_event(MetricsName.CATCHUP_SEEDER_TXNS,
                                end - start + 1)
        txns = {}
        paths = {}
        for seq in range(start, end + 1):
            txns[str(seq)] = ledger.get_by_seq_no(seq)
            paths[str(seq)] = [
                b58encode(h) for h in ledger.audit_path(seq, till)]
        rep = CatchupRep(ledgerId=req.ledgerId, txns=txns,
                         auditPaths=paths, catchupTill=till)
        self._network.send(rep, [sender])
        logger.debug("%s seeded %d..%d of ledger %d to %s", self._name,
                     start, end, req.ledgerId, sender)
