"""Observer: a non-validator read replica fed by the pool.

Reference: plenum/server/observer/ (`ObserverSyncPolicyEachBatch`,
ObservedData) — nodes push each committed batch to registered observers,
which apply it WITHOUT participating in consensus. The TPU-era redesign
makes the push proof-carrying instead of policy-trusted:

- With the pool's BLS keys, ONE validator's push suffices: the attached
  multi-signature co-signs (state_root, txn_root, ledger_id, timestamp),
  and the observer re-applies the txns and checks its OWN recomputed
  roots against the co-signed ones (client/state_proof's
  verify_pool_multi_sig — the same trust anchor proved reads use).
- Without BLS keys it falls back to the reference's quorum shape:
  ``weak_quorum`` (f+1) IDENTICAL pushes from distinct validators.

Out-of-order batches are stashed until their predecessor arrives, so an
observer fed by racing validators still applies the total order.

Copy of ``indy_plenum_tpu/server/observer.py``, with its imports bound to
the port. An observer re-applies pushed batches into its own SMT states
and leeches through the catchup plane on its ``device``: the CUDA card
unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

from ..common.constants import POOL_LEDGER_ID
from ..common.messages.node_messages import ObservedData
from ..crypto.bls.bls_crypto import MultiSignature
from ..utils.base58 import b58decode, b58encode
from ..utils.torch_env import DeviceLike
from .ledgers_bootstrap import LedgersBootstrap, NodeStorage

logger = logging.getLogger(__name__)

# bound on stashed future batches (a byzantine feeder must not grow RAM)
MAX_STASHED = 1000


class Observer:
    def __init__(self,
                 name: str,
                 network,  # provides create_peer(name) -> ExternalBus
                 pool_bls_keys: Optional[Dict[str, str]] = None,
                 weak_quorum: Optional[int] = None,
                 storage: Optional[NodeStorage] = None,
                 pool_genesis: Optional[list] = None,
                 domain_genesis: Optional[list] = None,
                 timer=None,
                 pool_size: Optional[int] = None,
                 gap_timeout: float = 5.0,
                 validators: Optional[list] = None,
                 device: DeviceLike = None):
        """``pool_bls_keys``: node name -> BLS pk b58 (trust anchor for
        single-push mode); ``weak_quorum``: f+1 of the pool, used when no
        BLS keys are available — derived from ``pool_size`` /
        ``validators`` when not given, so constructing an Observer with a
        validator set never silently trusts a single push (round-4
        advisor finding). With ``timer`` + ``pool_size`` the
        observer self-heals gaps: an observer registered mid-stream (or
        one that missed pushes) runs the ordinary catchup plane against
        the validators' seeders instead of stalling forever."""
        self.name = name
        self.boot = LedgersBootstrap(
            storage=storage, pool_genesis=pool_genesis,
            domain_genesis=domain_genesis, device=device).build()
        self._bls_keys = dict(pool_bls_keys or {})
        # weak-quorum mode counts only VALIDATOR senders: without this,
        # f+1 arbitrary connected peers (other observers, clients) could
        # co-push fabricated batches whose self-consistent roots pass the
        # re-apply check. BLS keys double as the validator set.
        self._validators = set(validators) if validators is not None \
            else set(self._bls_keys) or None
        if weak_quorum is None:
            n = pool_size if pool_size is not None \
                else len(self._validators or ())
            weak_quorum = (n - 1) // 3 + 1 if n else 1
        self._weak_quorum = max(1, weak_quorum)
        self.bus = network.create_peer(name)
        self.bus.subscribe(ObservedData, self.process_observed_data)
        self.last_applied_pp_seq_no = self.boot.committed_pp_seq_no
        # ppSeqNo -> {digest(batch content) -> (data, senders)}
        self._stashed: Dict[int, Dict[str, Tuple[ObservedData, set]]] = {}
        self.batches_applied = 0
        self.batches_rejected = 0
        self.catchups = 0

        self.leecher = None
        if timer is not None and pool_size is not None:
            from ..common.event_bus import InternalBus
            from ..common.messages.internal_messages import CatchupFinished
            from ..common.timer import RepeatingTimer
            from .catchup import NodeLeecherService
            from .quorums import Quorums

            class _ObserverData:
                """The slice of ConsensusSharedData catchup reads."""

                def __init__(self, obs_name: str, n: int):
                    self.name = obs_name
                    self.quorums = Quorums(n)
                    self.is_participating = False
                    self.view_no = 0
                    self.last_ordered_3pc = (0, 0)
                    self.primaries: list = []

            self._data = _ObserverData(name, pool_size)
            self.internal_bus = InternalBus()
            self.leecher = NodeLeecherService(
                data=self._data, bus=self.internal_bus, network=self.bus,
                timer=timer, bootstrap=self.boot, device=device)
            self.internal_bus.subscribe(CatchupFinished,
                                        self._on_catchup_finished)
            self._gap_marker = None
            self._gap_timer = RepeatingTimer(timer, gap_timeout,
                                             self._check_gap)

    def _check_gap(self) -> None:
        """A stall — stashed batches exist but nothing applied between
        two checks — triggers catchup. That covers BOTH shapes: a missing
        predecessor (validators push each batch exactly once, so a missed
        push never resends) AND a present-but-untrusted head (e.g. a
        BLS-mode push whose multi-signature was absent)."""
        if not self._stashed:
            self._gap_marker = None
            return
        marker = (self.last_applied_pp_seq_no, min(self._stashed))
        if marker == self._gap_marker and self.leecher is not None:
            logger.info("%s: push stall at %s; running catchup", self.name,
                        marker)
            self.leecher.start()
            self._gap_marker = None
        else:
            self._gap_marker = marker

    def _on_catchup_finished(self, msg, *args) -> None:
        self.catchups += 1
        self.last_applied_pp_seq_no = max(self.last_applied_pp_seq_no,
                                          self.boot.committed_pp_seq_no)
        for pp in [p for p in self._stashed
                   if p <= self.last_applied_pp_seq_no]:
            del self._stashed[pp]
        self._drain()

    # ------------------------------------------------------------------

    def _content_key(self, data: ObservedData) -> str:
        import hashlib

        from ..common.serializers.serialization import ledger_txn_serializer

        # the TXNS are part of the identity: a byzantine push with
        # genuine roots but fabricated txns must not merge with (and
        # mask) honest pushes for the same batch. Canonical (key-sorted)
        # serialization: honest validators whose txn dicts were built in
        # different insertion orders (live execution vs catchup rebuild)
        # must still merge toward f+1 (round-4 advisor finding). The
        # LEDGER's serializer, not the None-dropping signing one: content
        # identity here must match what _apply hands to ledger.add, or a
        # byzantine first push ({"a":1,"b":None}) could absorb honest
        # senders ({"a":1}) into an entry whose txn root can't verify.
        # Raises on non-JSON txns (mixed-type keys etc.) — the caller
        # treats that as a rejected push, honest txns are JSON by
        # construction (ledger storage is JSON).
        return hashlib.sha256(ledger_txn_serializer.dumps({
            "l": data.ledgerId, "p": data.ppSeqNo,
            "s": data.stateRootHash, "t": data.txnRootHash,
            "x": list(data.txns),
        })).hexdigest()

    def process_observed_data(self, data: ObservedData, sender: str
                              ) -> None:
        if data.ppSeqNo <= self.last_applied_pp_seq_no:
            return  # duplicate push (several validators feed us)
        if len(self._stashed) >= MAX_STASHED \
                and data.ppSeqNo not in self._stashed:
            # bounded stash: evict the FARTHEST-future slot for a nearer
            # batch (refusing the needed next-in-order push would let a
            # far-future flood block honest traffic permanently)
            farthest = max(self._stashed)
            if data.ppSeqNo >= farthest:
                return
            del self._stashed[farthest]
        try:
            key = self._content_key(data)
        except Exception:  # noqa: BLE001 — pushed content is untrusted;
            # a non-JSON-serializable txn (mixed-type dict keys survive
            # msgpack) must reject the push, not crash the service loop
            self.batches_rejected += 1
            return
        slot = self._stashed.setdefault(data.ppSeqNo, {})
        entry = slot.get(key)
        if entry is None:
            slot[key] = (data, {sender})
        else:
            entry[1].add(sender)
        self._drain()

    def _drain(self) -> None:
        while True:
            nxt = self.last_applied_pp_seq_no + 1
            slot = self._stashed.get(nxt)
            if not slot:
                return
            applied = False
            for key, (data, senders) in list(slot.items()):
                if not self._trusted(data, senders):
                    continue
                if self._apply(data):
                    applied = True
                    break
                # garbage despite passing the trust gate (e.g. a valid
                # multi-sig over roots but fabricated txns): discard ONLY
                # this entry — an honest push for the same batch may sit
                # (or arrive) under a different content key
                self.batches_rejected += 1
                del slot[key]
            if not slot:
                del self._stashed[nxt]  # an empty slot must not mask the
                # gap from the watchdog
            if not applied:
                return  # wait for a proof / more matching pushes
            del self._stashed[nxt]
            self.last_applied_pp_seq_no = nxt
            self.batches_applied += 1

    # ------------------------------------------------------------------

    def _trusted(self, data: ObservedData, senders: set) -> bool:
        if self._bls_keys:
            ms_dict = data.multiSignature
            if not ms_dict:
                return False
            try:
                ms = MultiSignature.from_dict(ms_dict)
            except Exception:  # noqa: BLE001 — pushed content is untrusted
                return False
            if ms.value.ledger_id != data.ledgerId \
                    or ms.value.state_root_hash != data.stateRootHash \
                    or ms.value.txn_root_hash != data.txnRootHash:
                return False
            from ..client.state_proof import verify_pool_multi_sig

            n = len(self._bls_keys)
            return verify_pool_multi_sig(
                ms, self._bls_keys,
                min_participants=n - (n - 1) // 3)
        if self._validators is None:
            return False  # weak mode with no validator set: trust nothing
        return len(senders & self._validators) >= self._weak_quorum

    def _apply(self, data: ObservedData) -> bool:
        """Re-apply the batch and check our OWN roots against the
        (verified) claimed ones — an observer never trusts content it can
        recompute."""
        ledger = self.boot.db.get_ledger(data.ledgerId)
        state = self.boot.db.get_state(data.ledgerId)
        pre_size = ledger.size
        pre_state = state.head_hash if state is not None else None
        try:
            for txn in data.txns:
                ledger.add(dict(txn))
                self.boot._update_state_for(txn)
            if data.txnRootHash is not None \
                    and b58encode(ledger.root_hash) != data.txnRootHash:
                raise ValueError("txn root mismatch")
            if state is not None and data.stateRootHash is not None \
                    and b58encode(state.head_hash) != data.stateRootHash:
                raise ValueError("state root mismatch")
        except Exception as exc:  # noqa: BLE001 — pushed content is
            # untrusted; roll back whatever half-applied
            logger.warning("%s: observed batch %d rejected: %s",
                           self.name, data.ppSeqNo, exc)
            ledger.reset_to(pre_size)
            if state is not None and pre_state is not None:
                state.set_head_hash(pre_state)
            return False
        if state is not None:
            state.commit()
        if data.ledgerId == POOL_LEDGER_ID:
            pass  # observers track membership reads via get_node_data
        return True

    # ------------------------------------------------------------------

    def get_nym_data(self, did: str):
        return self.boot.nym_handler.get_nym_data(did, is_committed=True)


class ObserverRegistry:
    """The validator-side half: push each committed batch to registered
    observers (reference: Node.send_to_observers)."""

    def __init__(self, external_bus, find_multi_sig=None):
        self._bus = external_bus
        self._find_multi_sig = find_multi_sig or (lambda root: None)
        self.observers: List[str] = []

    def add(self, name: str) -> None:
        if name not in self.observers:
            self.observers.append(name)

    def remove(self, name: str) -> None:
        if name in self.observers:
            self.observers.remove(name)

    def push_batch(self, ledger_id: int, pp_seq_no: int, pp_time,
                   txns: List[dict], state_root_b58: Optional[str],
                   txn_root_b58: Optional[str]) -> None:
        if not self.observers:
            return
        self._bus.send(ObservedData(
            ledgerId=ledger_id,
            ppSeqNo=pp_seq_no,
            ppTime=pp_time,
            txns=[dict(t) for t in txns],
            stateRootHash=state_root_b58,
            txnRootHash=txn_root_b58,
            multiSignature=self._find_multi_sig(state_root_b58)
            if state_root_b58 else None,
        ), list(self.observers))
