"""Agreeing on a catchup target (size, root) for one ledger.

Reference: plenum/server/catchup/cons_proof_service.py (`ConsProofService`).
Broadcast our ``LEDGER_STATUS``; peers ahead of us answer with RFC 6962
``CONSISTENCY_PROOF``s (our size -> their size), peers level with us echo
their ``LEDGER_STATUS``. Every proof is cryptographically verified against
our OWN committed root before it may vote; a weak quorum (f+1) of verified
votes on the same (size, root) decides the target — at least one vote is
then from an honest node, and every fetched txn will later be verified
against that root, so a lying majority-of-f voters cannot poison us.

Divergence detection: a peer's proof whose ``oldMerkleRoot`` (their tree at
OUR size) differs from our root proves our ledger's history itself is wrong
(not merely short). f+1 distinct peers saying so convicts our local state
-> the leecher truncates and re-syncs from scratch.

Copy of ``indy_plenum_tpu/server/catchup/cons_proof_service.py``, with
its imports bound to the port.
"""
from __future__ import annotations

import logging
from typing import Callable, Dict, Optional, Set, Tuple

from ...common.event_bus import ExternalBus
from ...common.messages.node_messages import (
    ConsistencyProof,
    LedgerStatus,
)
from ...common.timer import RepeatingTimer, TimerService
from ...ledger.merkle_verifier import MerkleVerifier
from ...utils.base58 import b58decode, b58encode

logger = logging.getLogger(__name__)

# target: (size, root_b58); DIVERGED is a sentinel outcome
Target = Tuple[int, str]


class ConsProofService:
    def __init__(self,
                 ledger_id: int,
                 network: ExternalBus,
                 timer: TimerService,
                 db,
                 quorums_provider: Callable[[], object],
                 config=None):
        from ...config import getConfig

        self._ledger_id = ledger_id
        self._network = network
        self._timer = timer
        self._db = db
        self._quorums = quorums_provider
        self._config = config or getConfig()
        self._verifier = MerkleVerifier()

        self._running = False
        self._on_target: Optional[Callable[[Optional[Target], bool], None]] \
            = None
        # (size, root_b58) -> senders with a VERIFIED proof / equal status
        self._votes: Dict[Target, Set[str]] = {}
        # (size, root_b58) below our size -> prefix-matching behind peers
        self._behind_votes: Dict[Target, Set[str]] = {}
        self._divergence_votes: Set[str] = set()
        self._own_size = 0
        self._own_root_b58 = ""
        self._retry = RepeatingTimer(
            timer, self._config.ConsistencyProofsTimeout,
            self._broadcast_status, active=False)

        network.subscribe(ConsistencyProof, self.process_consistency_proof)
        network.subscribe(LedgerStatus, self.process_ledger_status)

    # ------------------------------------------------------------------

    def start(self, on_target: Callable[[Optional[Target], bool], None]
              ) -> None:
        """``on_target(target, diverged)``: target None + diverged=True
        means our own history is provably wrong; target (size, root) means
        fetch up to there (size == own size: already caught up)."""
        ledger = self._db.get_ledger(self._ledger_id)
        self._own_size = ledger.size
        self._own_root_b58 = b58encode(ledger.root_hash)
        self._votes.clear()
        self._behind_votes.clear()
        self._divergence_votes.clear()
        self._on_target = on_target
        self._running = True
        self._broadcast_status()
        self._retry.start()

    def stop(self) -> None:
        self._running = False
        self._retry.stop()

    def _broadcast_status(self) -> None:
        if not self._running:
            self._retry.stop()
            return
        self._network.send(LedgerStatus(
            ledgerId=self._ledger_id,
            txnSeqNo=self._own_size,
            viewNo=None,
            ppSeqNo=None,
            merkleRoot=self._own_root_b58,
            protocolVersion=2,
        ))

    # ------------------------------------------------------------------

    def process_ledger_status(self, status: LedgerStatus, sender: str):
        """A peer's own status: votes 'you are caught up' when it matches
        us; a same-size DIFFERENT root is a divergence vote. A BEHIND
        peer's status is evidence too — if our prefix at their size
        matches their root, they vote for a target at their tip (we are
        AHEAD of the pool: uncommitted/corrupt tail to truncate); if our
        prefix differs, that is a divergence vote."""
        if not self._running or status.ledgerId != self._ledger_id:
            return
        if getattr(status, "probe", None):
            return  # a fork-search QUESTION, not an assertion — no vote
        if status.txnSeqNo > self._own_size:
            return  # ahead peers vote via CONSISTENCY_PROOF instead
        if status.txnSeqNo < self._own_size:
            ledger = self._db.get_ledger(self._ledger_id)
            # root_hash_at(0) is the RFC 6962 empty-tree hash — the same
            # value an empty peer's status carries (no "" sentinel, which
            # would convict healthy nodes against fresh peers)
            ours_at = b58encode(ledger.root_hash_at(status.txnSeqNo))
            if status.merkleRoot == ours_at:
                # prefix matches: the peer is merely behind. These become
                # a BELOW-us truncation target only under a STRONG quorum
                # (n-f distinct peers at the same tip) — with weak (f+1)
                # support, one byzantine peer plus ordinary replication
                # lag could make a caught-up node discard a batch it
                # legitimately committed (review finding); n-f peers at
                # the same tip means no quorum ever EXECUTED past it, so
                # the truncated tail is re-orderable, not lost history
                self._behind_votes.setdefault(
                    (status.txnSeqNo, status.merkleRoot),
                    set()).add(sender)
                self._check_done()
            else:
                self._add_divergence_vote(sender)
            return
        if status.merkleRoot == self._own_root_b58:
            self._add_vote((self._own_size, self._own_root_b58), sender)
        else:
            self._add_divergence_vote(sender)

    def process_consistency_proof(self, proof: ConsistencyProof, sender: str):
        if not self._running or proof.ledgerId != self._ledger_id:
            return
        if proof.seqNoStart != self._own_size \
                or proof.seqNoEnd <= self._own_size:
            return  # stale (our size changed) or useless
        if self._own_size > 0 and proof.oldMerkleRoot != self._own_root_b58:
            # their tree at our size is NOT our tree: one of us diverged.
            # Count it; only f+1 distinct accusers convict us.
            self._add_divergence_vote(sender)
            return
        try:
            ok = self._verifier.verify_consistency(
                self._own_size, proof.seqNoEnd,
                b58decode(self._own_root_b58) if self._own_size else b"",
                b58decode(proof.newMerkleRoot),
                [b58decode(h) for h in proof.hashes])
        except (ValueError, KeyError):
            ok = False
        if not ok:
            logger.warning("bad consistency proof from %s for ledger %d",
                           sender, self._ledger_id)
            return
        self._add_vote((proof.seqNoEnd, proof.newMerkleRoot), sender)

    # ------------------------------------------------------------------

    def _add_vote(self, target: Target, sender: str) -> None:
        self._votes.setdefault(target, set()).add(sender)
        self._check_done()

    def _add_divergence_vote(self, sender: str) -> None:
        self._divergence_votes.add(sender)
        self._check_done()

    def _check_done(self) -> None:
        if not self._running:
            return
        quorums = self._quorums()
        if quorums.weak.is_reached(len(self._divergence_votes)):
            logger.warning("ledger %d DIVERGED (f+1 peers disagree with "
                           "our history)", self._ledger_id)
            self._finish(None, diverged=True)
            return
        # pick the HIGHEST quorum-supported target (peers keep ordering;
        # any f+1-supported root is safe to fetch toward)
        best = None
        for target, senders in self._votes.items():
            if quorums.weak.is_reached(len(senders)):
                if best is None or target[0] > best[0]:
                    best = target
        if best is None:
            # no at-or-above target: a STRONG quorum of prefix-matching
            # behind peers (we are ahead of the whole pool) pins the
            # pool's tip as the target instead
            for target, senders in self._behind_votes.items():
                if quorums.strong.is_reached(len(senders)):
                    if best is None or target[0] > best[0]:
                        best = target
        if best is not None:
            self._finish(best, diverged=False)

    def _finish(self, target: Optional[Target], diverged: bool) -> None:
        self.stop()
        cb = self._on_target
        self._on_target = None
        if cb is not None:
            cb(target, diverged)
