"""The protocol side of BLS: sign state roots in COMMIT, aggregate at order.

Reference: plenum/bls/bls_bft_replica_plenum.py (`BlsBftReplicaPlenum`),
implementing the seam declared by
:class:`indy_plenum_tpu_torch.server.consensus.ordering_service.NoOpBlsBftReplica`:

- ``update_pre_prepare``: attach the latest known multi-sig to outgoing
  PRE-PREPAREs (propagates proofs of *previous* roots through the pool);
- ``validate_pre_prepare``: verify an attached multi-sig (suspicion
  PPR_BLS_MULTISIG_WRONG on failure);
- ``update_commit``: BLS-sign the batch's MultiSignatureValue;
- ``validate_commit``: OPTIMISTIC — individual COMMIT signatures are
  recorded without a pairing check; the aggregate is verified once at
  ordering time and only on failure are individual signatures re-checked
  to identify the culprit (aggregate-first is the batch-friendly, TPU-first
  discipline: one pairing check per ordered batch instead of n);
- ``process_order``: aggregate n-f valid signatures into a MultiSignature,
  persist it to the BlsStore keyed by state root (state-proof reads), and
  remember it for the next PRE-PREPARE.

Copy of ``indy_plenum_tpu/bls/bls_bft_replica.py``, with its imports bound to
the port.
"""
from __future__ import annotations

import logging
from typing import Dict, Optional, Tuple

from ..common.exceptions import SuspiciousNode
from ..crypto.bls import bn254 as bn
from ..crypto.bls.bls_crypto import (
    BlsCryptoSigner,
    BlsCryptoVerifier,
    MultiSignature,
    MultiSignatureValue,
    g1_from_bytes,
    g1_to_bytes,
)
from ..server.suspicion_codes import Suspicions
from ..utils.base58 import b58decode, b58encode
from .bls_key_register import BlsKeyRegister
from .bls_store import BlsStore

logger = logging.getLogger(__name__)


class BlsBftReplica:
    def __init__(self,
                 node_name: str,
                 signer: BlsCryptoSigner,
                 key_register: BlsKeyRegister,
                 store: Optional[BlsStore] = None,
                 pool_state_root_provider=None,
                 suspicion_sink=None):
        self._name = node_name
        self._signer = signer
        self._verifier = BlsCryptoVerifier()
        self._register = key_register
        self._store = store if store is not None else BlsStore()
        self.key_register = key_register  # pool manager updates membership
        self._pool_root = pool_state_root_provider or (lambda: "")
        # called with a SuspiciousNode when the culprit re-check identifies
        # a bad signer (process_order cannot raise: ordering must proceed)
        self._suspicion_sink = suspicion_sink or (lambda ex: None)
        # (view_no, pp_seq_no) -> sender -> sig b58
        self._sigs: Dict[Tuple[int, int], Dict[str, str]] = {}
        self._latest_multi_sig: Optional[MultiSignature] = None
        # deferred mode (set by tick-driven compositions): process_order
        # queues its aggregate checks and flush() verifies ALL batches
        # ordered this tick in one random-linear-combination multi-
        # pairing (BlsCryptoVerifier.verify_multi_sig_batch) — one shared
        # final exponentiation per tick instead of one pairing per batch
        self.defer_verification = False
        self._pending_orders: list = []

    # --- value under signature -----------------------------------------

    def _value_for(self, pp) -> Optional[MultiSignatureValue]:
        if pp is None or pp.stateRootHash is None:
            return None
        return MultiSignatureValue(
            ledger_id=pp.ledgerId,
            state_root_hash=pp.stateRootHash,
            pool_state_root_hash=pp.poolStateRootHash or self._pool_root(),
            txn_root_hash=pp.txnRootHash or "",
            timestamp=pp.ppTime,
        )

    # --- PRE-PREPARE ----------------------------------------------------

    def update_pre_prepare(self, params: dict, ledger_id) -> dict:
        if self._latest_multi_sig is not None:
            params["blsMultiSig"] = self._latest_multi_sig.as_dict()
        return params

    def validate_pre_prepare(self, pp, sender) -> None:
        raw = getattr(pp, "blsMultiSig", None)
        if raw is None:
            return
        try:
            ms = MultiSignature.from_dict(dict(raw))
        except (KeyError, TypeError, ValueError):
            raise SuspiciousNode(
                sender, Suspicions.PPR_BLS_MULTISIG_WRONG) from None
        # steady-state memo: the attached multi-sig is almost always one
        # WE assembled (or already verified) for that state root — an
        # identical store entry needs no second pairing check
        known = self._store.get(ms.value.state_root_hash)
        if known is not None and known == ms:
            return
        pks = self._register.get_keys(ms.participants)
        if pks is None or not self._verifier.verify_multi_sig(
                ms.signature, ms.value.serialize(), pks):
            raise SuspiciousNode(sender, Suspicions.PPR_BLS_MULTISIG_WRONG)

    def process_pre_prepare(self, pp, sender) -> None:
        raw = getattr(pp, "blsMultiSig", None)
        if raw is None:
            return
        ms = MultiSignature.from_dict(dict(raw))  # validated above
        self._store.put(ms)
        self._latest_multi_sig = ms

    # --- PREPARE (nothing to do) ----------------------------------------

    def process_prepare(self, prepare, sender) -> None:
        pass

    # --- COMMIT ---------------------------------------------------------

    def update_commit(self, params: dict, pp) -> dict:
        value = self._value_for(pp)
        if value is not None:
            params["blsSig"] = self._signer.sign(value.serialize())
        return params

    def validate_commit(self, commit, sender, pp) -> None:
        # optimistic: defer PAIRING checks to aggregation (see module doc),
        # but a signature must at least decode to a canonical on-curve G1
        # point — otherwise one byzantine COMMIT would make aggregate_sigs
        # raise at ordering time on every honest node. A missing signature
        # is fine (not every node must have BLS keys).
        sig = getattr(commit, "blsSig", None)
        if sig is None:
            return
        if not isinstance(sig, str):
            raise SuspiciousNode(sender, Suspicions.CM_BLS_WRONG)
        try:
            pt = g1_from_bytes(b58decode(sig))
        except (ValueError, KeyError):
            raise SuspiciousNode(sender, Suspicions.CM_BLS_WRONG) from None
        if pt is None:
            # the identity encoding: contributes nothing to the aggregate
            # but would fail the aggregate check every batch, forcing the
            # per-signer culprit scan on the ordering hot path
            raise SuspiciousNode(sender, Suspicions.CM_BLS_WRONG)

    def process_commit(self, commit, sender) -> None:
        sig = getattr(commit, "blsSig", None)
        if sig is None:
            return
        key = (commit.viewNo, commit.ppSeqNo)
        self._sigs.setdefault(key, {})[sender] = sig

    # --- ordering -------------------------------------------------------

    def process_order(self, key, quorums, pp) -> None:
        value = self._value_for(pp)
        if value is None:
            return
        sigs = dict(self._sigs.get(key, {}))
        # include our own signature (we signed in update_commit only if we
        # sent a COMMIT; recompute — signing is cheap, one G1 mul)
        sigs[self._name] = self._signer.sign(value.serialize())
        # decode each signature exactly ONCE and aggregate the points
        # directly. validate_commit guarantees stored sigs decode to
        # non-identity points, but a raise here would desync execution on
        # every honest node, so drop failures instead of propagating.
        points: Dict[str, object] = {}
        for p, s in sigs.items():
            try:
                pt = g1_from_bytes(b58decode(s))
            except (ValueError, KeyError):
                pt = None
            if pt is None:
                logger.warning("%s: dropping bad BLS sig from %s at %s",
                               self._name, p, key)
                continue
            points[p] = pt
        if not quorums.bls_signatures.is_reached(len(points)):
            logger.debug("%s: no BLS quorum for %s (%d sigs)", self._name,
                         key, len(points))
            return
        participants = sorted(points)
        message = value.serialize()

        def _aggregate(names):
            acc = None
            for nm in names:
                acc = bn.g1_add(acc, points[nm])
            return b58encode(g1_to_bytes(acc))

        agg = _aggregate(participants)
        pks = self._register.get_keys(participants)
        if pks is None:
            return
        if self.defer_verification:
            # verified in ONE multi-pairing with everything else ordered
            # this tick (flush()); ordering itself never waited on the
            # multi-sig — it only feeds proved reads + the next PP
            self._pending_orders.append(
                (key, quorums, value, participants, agg, sigs, message,
                 pks, _aggregate))
            return
        if not self._verifier.verify_multi_sig(agg, message, pks):
            retry = self._retry_without_culprits(
                key, quorums, sigs, message, participants, _aggregate)
            if retry is None:
                return
            participants, agg = retry
        ms = MultiSignature(signature=agg, participants=participants,
                            value=value)
        self._store.put(ms)
        self._latest_multi_sig = ms

    def _retry_without_culprits(self, key, quorums, sigs, message,
                                participants, aggregate_fn):
        """Aggregate check failed: identify bad signers individually,
        raise suspicions, and retry with the good subset. Returns
        (good_participants, good_aggregate) or None if no quorum of good
        signatures remains."""
        good = []
        for p in participants:
            pk = self._register.get_key(p)
            if pk and self._verifier.verify_sig(sigs[p], message, pk):
                good.append(p)
            elif p == self._name:
                logger.error("%s: OWN BLS sig failed verification at %s",
                             self._name, key)
            else:
                logger.warning("%s: invalid BLS sig from %s at %s",
                               self._name, p, key)
                self._suspicion_sink(
                    SuspiciousNode(p, Suspicions.CM_BLS_WRONG))
        if not quorums.bls_signatures.is_reached(len(good)):
            return None
        return good, aggregate_fn(good)

    def flush(self) -> None:
        """Verify every batch ordered since the last tick in one
        random-linear-combination multi-pairing; store the proven
        multi-sigs (deferred mode's tick hook — a no-op otherwise)."""
        if not self._pending_orders:
            return
        batch, self._pending_orders = self._pending_orders, []
        # through the instance seam (compositions may substitute or
        # instrument the verifier), same as every other verification path
        verdicts = self._verifier.verify_multi_sig_batch(
            [(agg, message, pks)
             for (_k, _q, _v, _p, agg, _s, message, pks, _a) in batch])
        for ok, (key, quorums, value, participants, agg, sigs, message,
                 pks, aggregate_fn) in zip(verdicts, batch):
            if not ok:
                retry = self._retry_without_culprits(
                    key, quorums, sigs, message, participants,
                    aggregate_fn)
                if retry is None:
                    continue
                participants, agg = retry
            ms = MultiSignature(signature=agg, participants=participants,
                                value=value)
            self._store.put(ms)
            self._latest_multi_sig = ms

    # --- GC -------------------------------------------------------------

    def gc(self, key_3pc) -> None:
        stable_seq = key_3pc[1]
        self._sigs = {k: v for k, v in self._sigs.items()
                      if k[1] > stable_seq}

    # --- reads (state proofs) -------------------------------------------

    @property
    def store(self) -> BlsStore:
        return self._store

    @property
    def latest_multi_sig(self) -> Optional[MultiSignature]:
        return self._latest_multi_sig
