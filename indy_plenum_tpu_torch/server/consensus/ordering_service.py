"""The 3PC ordering engine: PRE-PREPARE / PREPARE / COMMIT.

Reference: plenum/server/consensus/ordering_service.py (`OrderingService`).
Host-side protocol state machine; the bulk math it used to do per-message
(signature checks, vote counting at scale) lives in the device plane
(:mod:`indy_plenum_tpu_torch.tpu.ed25519`, :mod:`indy_plenum_tpu_torch.tpu.quorum`) —
this service handles the per-batch protocol logic: speculative execution,
root comparison, certificates, in-order delivery, view-change revert and
re-ordering.

Roles:
- primary: batches finalised requests (Max3PCBatchSize / Max3PCBatchWait),
  applies them speculatively via the executor seam, emits PRE-PREPARE with
  the uncommitted state/txn roots every replica must reproduce;
- non-primary: re-applies the batch, compares roots (byzantine check),
  sends PREPARE; on prepare quorum sends COMMIT (BLS-signed via the bls
  seam); on commit quorum orders IN SEQUENCE and emits ``Ordered`` on the
  internal bus (the node executes/commits);
- on ViewChangeStarted: reverts uncommitted batches; on
  NewViewCheckpointsApplied: re-orders the selected batches in the new view.

Copy of ``indy_plenum_tpu/server/consensus/ordering_service.py``, with its
imports bound to the port.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Tuple

from ...common.event_bus import ExternalBus, InternalBus
from ...common.exceptions import SuspiciousNode
from ...common.messages.internal_messages import (
    CatchupFinished,
    CheckpointStabilized,
    MissingMessage,
    NewViewCheckpointsApplied,
    RaisedSuspicion,
    RequestPropagates,
    ViewChangeStarted,
    VoteForViewChange,
)
from ...common.messages.node_messages import (
    Commit,
    Ordered,
    PrePrepare,
    Prepare,
)
from ...common.request import Request
from ...common.stashing_router import (
    DISCARD,
    PROCESS,
    STASH_CATCH_UP,
    STASH_VIEW_3PC,
    STASH_WAITING_NEW_VIEW,
    STASH_WATERMARKS,
    StashingRouter,
)
from ...common.timer import RepeatingTimer, TimerService
from ...common.constants import DOMAIN_LEDGER_ID
from ...observability.trace import NULL_TRACE
from ..suspicion_codes import Suspicions
from .consensus_shared_data import (
    BatchID,
    ConsensusSharedData,
    preprepare_to_batch_id,
)

logger = logging.getLogger(__name__)

STASH_WAITING_REQUESTS = 6
STASH_WAITING_PREV_PP = 7


class NoOpBlsBftReplica:
    """BLS protocol seam; the real implementation is in
    indy_plenum_tpu_torch.bls.bls_bft_replica (reference: plenum/bls/)."""

    def update_pre_prepare(self, params: dict, ledger_id) -> dict:
        return params

    def validate_pre_prepare(self, pp, sender) -> None:
        pass

    def process_pre_prepare(self, pp, sender) -> None:
        pass

    def process_prepare(self, prepare, sender) -> None:
        pass

    def update_commit(self, params: dict, pp) -> dict:
        return params

    def validate_commit(self, commit, sender, pp) -> None:
        pass

    def process_commit(self, commit, sender) -> None:
        pass

    def process_order(self, key, quorums, pp) -> None:
        pass

    def flush(self) -> None:
        pass

    def gc(self, key_3pc) -> None:
        pass


class Executor:
    """Execution seam (reference: WriteRequestManager + ledgers).

    ``apply_batch`` speculatively applies finalised requests and returns the
    resulting (state_root_b58, txn_root_b58) uncommitted roots. For a
    ``pp_seq_no`` at or below the already-committed height it must NOT
    re-apply — it returns the historical roots (the audit ledger knows them);
    this is what makes post-view-change re-ordering of batches some nodes
    already executed safe. ``revert_batches`` undoes up to ``count``
    uncommitted batches (LIFO). The master instance executes; backups pass
    and receive None roots.
    """

    def apply_batch(self, reqs: List[Request], ledger_id: int,
                    pp_time: int, pp_seq_no: int
                    ) -> Tuple[Optional[str], Optional[str]]:
        raise NotImplementedError

    def revert_batches(self, ledger_id: int, count: int) -> None:
        raise NotImplementedError

    def committed_seq(self) -> int:
        """Highest pp_seq_no whose batch is durably committed."""
        raise NotImplementedError


class RequestsPool:
    """Finalised-request source (reference: propagator's Requests container)."""

    def pop_ready(self, ledger_id: int, max_count: int) -> List[Request]:
        raise NotImplementedError

    def get(self, digest: str) -> Optional[Request]:
        raise NotImplementedError

    def has_ready(self, ledger_id: int) -> bool:
        raise NotImplementedError

    def ledger_ids_with_ready(self) -> List[int]:
        raise NotImplementedError


class OrderingService:
    def __init__(self,
                 data: ConsensusSharedData,
                 timer: TimerService,
                 bus: InternalBus,
                 network: ExternalBus,
                 stasher: StashingRouter,
                 executor: Optional[Executor] = None,
                 requests: Optional[RequestsPool] = None,
                 bls=None,
                 config=None,
                 get_time=None,
                 vote_plane=None,
                 shadow_check: bool = False,
                 trace=None):
        from ...config import getConfig

        self._data = data
        self._timer = timer
        self._bus = bus
        self._network = network
        self._stasher = stasher
        self._executor = executor
        self._requests = requests
        self._bls = bls or NoOpBlsBftReplica()
        self._config = config or getConfig()
        self._get_time = get_time or timer.get_current_time
        # Device quorum plane (tpu.vote_plane.DeviceVotePlane). When set,
        # prepare/commit certificates are DECIDED by the device tensors;
        # the dicts below remain as message logs (MessageReq, duplicate
        # detection). shadow_check additionally asserts dict-derived quorum
        # == device verdict on every query (sim/test mode).
        self._vote_plane = vote_plane
        self._shadow_check = shadow_check
        # flight recorder (observability.trace): 3PC lifecycle marks keyed
        # (view_no, pp_seq_no, digest). NULL_TRACE when tracing is off —
        # every record below guards arg construction on trace.enabled.
        self._trace = trace if trace is not None else NULL_TRACE
        # keys whose commit-quorum observation is already marked: the
        # quorum for seq k can become visible while k-1 still blocks
        # in-order delivery — the mark must land at OBSERVATION so the
        # derived "order" phase measures that head-of-line wait
        self._commit_quorum_marked: set = set()
        # tick-batched quorum evaluation (config.QuorumTickInterval > 0):
        # message handlers only RECORD votes; the runtime composition (the
        # SimPool / Node event loop) syncs the vote plane once per tick and
        # then calls service_quorum_tick(), so every vote recorded in the
        # interval rides one device flush instead of one per message.
        # Queries read the last-synced snapshot (plane.defer_flush_on_query).
        self._tick_mode = (vote_plane is not None
                           and self._config.QuorumTickInterval > 0)
        if self._tick_mode and hasattr(self._bls, "defer_verification"):
            # batch the per-ordered-batch BLS aggregate checks per tick:
            # service_quorum_tick flushes them through ONE multi-pairing
            self._bls.defer_verification = True
        self._dirty_prepare_keys: set = set()
        self._order_dirty = False

        # 3PC logs, keyed (view_no, pp_seq_no)
        self.sent_preprepares: Dict[Tuple[int, int], PrePrepare] = {}
        self.prePrepares: Dict[Tuple[int, int], PrePrepare] = {}
        self.prepares: Dict[Tuple[int, int], Dict[str, Prepare]] = {}
        self.commits: Dict[Tuple[int, int], Dict[str, Commit]] = {}
        self.ordered: set = set()
        self.batches: Dict[Tuple[int, int], int] = {}  # key -> ledger_id
        self.requested_pre_prepares: set = set()
        # PrePrepares retained across a view change for re-ordering
        self.old_view_preprepares: Dict[Tuple[int, int, str], PrePrepare] = {}
        # NEW_VIEW batches whose old PrePrepare we lack, awaiting fetch:
        # (orig_view, pp_seq_no, digest) -> new view_no
        self._pending_old_view_bids: Dict[Tuple[int, int, str], int] = {}
        # highest seq speculatively applied (or committed) — the in-order
        # apply guard for non-primary re-application
        self._last_applied_seq = 0
        # when this primary last minted a batch (freshness cadence base)
        self._last_batch_time = self._get_time()

        stasher.subscribe(PrePrepare, self.process_preprepare)
        stasher.subscribe(Prepare, self.process_prepare)
        stasher.subscribe(Commit, self.process_commit)
        bus.subscribe(ViewChangeStarted, self.process_view_change_started)
        bus.subscribe(NewViewCheckpointsApplied,
                      self.process_new_view_checkpoints_applied)
        bus.subscribe(CheckpointStabilized, self.process_checkpoint_stabilized)
        bus.subscribe(CatchupFinished, self.process_catchup_finished)

        self._batch_timer = RepeatingTimer(
            timer, self._config.Max3PCBatchWait, self._on_batch_timer,
            active=False)
        # liveness: a lost OLD_VIEW_PREPREPARE response must not leave the
        # node (or a mute primary) waiting forever — re-request periodically
        # until every pending NEW_VIEW-selected batch is fetched
        self._fetch_timer = RepeatingTimer(
            timer, self._config.OldViewPPRequestInterval,
            self._refetch_pending_old_view_pps, active=False)
        # the canonical PBFT liveness timer (Castro & Liskov §4.5.2): with
        # requests pending (or batches in flight) and NO ordering progress
        # across a full interval, vote for a view change. This is what
        # recovers a pool whose in-flight 3PC messages were lost for good
        # (partition heal, crashed links) — nobody retransmits them; the
        # new view re-proposes and stragglers fetch. Votes repeat while
        # the stall persists, so votes lost IN the partition don't matter.
        self._stall_snapshot: Optional[Tuple[int, Tuple[int, int]]] = None
        self._stall_timer = None
        if getattr(self._config, "OrderingStallTimeout", 0) > 0:
            self._stall_timer = RepeatingTimer(
                timer, self._config.OrderingStallTimeout,
                self._on_stall_check, active=False)

    # ------------------------------------------------------------------
    # primary: batch creation
    # ------------------------------------------------------------------

    def start(self) -> None:
        self._batch_timer.start()
        if self._stall_timer is not None and self._is_master:
            self._stall_timer.start()

    def stop(self) -> None:
        self._batch_timer.stop()
        if self._stall_timer is not None:
            self._stall_timer.stop()

    # --- ordering-stall watchdog ---------------------------------------

    def _on_stall_check(self) -> None:
        if (not self._is_master or self._data.waiting_for_new_view
                or not self._data.is_participating):
            self._stall_snapshot = None
            return
        pending = ((self._requests is not None
                    and bool(self._requests.ledger_ids_with_ready()))
                   # in-flight batches count as pending work on replicas
                   # (prePrepares) AND on the primary itself, whose own
                   # unacked batches live in sent_preprepares
                   or any(key not in self.ordered
                          for key in self.prePrepares)
                   or any(key not in self.ordered
                          for key in self.sent_preprepares))
        if not pending:
            self._stall_snapshot = None
            return
        marker = (self._data.view_no, self._data.last_ordered_3pc)
        if self._stall_snapshot == marker:
            logger.info("%s: no ordering progress for %.1fs with work "
                        "pending -> vote view change", self.name,
                        self._config.OrderingStallTimeout)
            # reset so the NEXT vote needs two more stalled checks — the
            # repeat cadence that survives votes lost mid-partition
            # without spamming an instance change every interval
            self._stall_snapshot = None
            if self._trace.enabled:
                # flight-recorder trigger: the trace tail at the moment
                # the watchdog fired IS the stall's forensic record
                self._trace.trigger_dump(
                    "ordering_stall", node=self.name,
                    args={"view_no": self._data.view_no,
                          "last_ordered":
                              list(self._data.last_ordered_3pc)})
            self._bus.send(VoteForViewChange(
                suspicion=Suspicions.ORDERING_STALLED))
            return
        self._stall_snapshot = marker
        # before escalating: try a cheap self-heal. A replica that missed
        # in-flight 3PC messages for good (partition, crash window) can
        # re-request them — peers keep everything above the stable
        # checkpoint, and each response re-enters the normal validated
        # processing path. A pool-wide outage still escalates to the vote
        # above; a single straggler resyncs without disturbing the view.
        self._rerequest_inflight_3pc()

    def _rerequest_inflight_3pc(self) -> None:
        view_no = self._data.view_no
        last_seq = self._data.last_ordered_3pc[1]
        seen = (set(self.prePrepares) | set(self.sent_preprepares)
                | set(self.prepares) | set(self.commits))
        hi = max((seq for v, seq in seen if v == view_no),
                 default=last_seq)
        hi = min(hi, last_seq + self._data.log_size)
        for seq in range(last_seq + 1, hi + 1):
            key = (view_no, seq)
            if key in self.ordered:
                continue
            if key not in self.prePrepares \
                    and key not in self.sent_preprepares:
                # dst resolution sends this to the primary only (the one
                # authoritative author of a PRE-PREPARE)
                self._bus.send(MissingMessage(
                    msg_type="PREPREPARE", key=key,
                    inst_id=self._data.inst_id, dst=None))
            self._bus.send(MissingMessage(
                msg_type="PREPARE", key=key,
                inst_id=self._data.inst_id, dst=None))
            self._bus.send(MissingMessage(
                msg_type="COMMIT", key=key,
                inst_id=self._data.inst_id, dst=None))

    # --- tick-batched quorum evaluation --------------------------------

    def _note_prepare_activity(self, key: Tuple[int, int]) -> None:
        if self._tick_mode:
            # ordering fast path: a delta-feed plane reports certificate
            # COMPLETIONS itself (device-side quorum eval) — host-side
            # activity tracking would re-evaluate every in-flight key
            # every tick for nothing
            if not self._vote_plane.delta_feed:
                self._dirty_prepare_keys.add(key)
        else:
            self._try_prepared(key)

    def _note_commit_activity(self, key: Tuple[int, int]) -> None:
        if self._tick_mode:
            if not self._vote_plane.delta_feed:
                self._order_dirty = True
        else:
            self._try_order(key)
            if self._trace.enabled and key not in self.ordered:
                # per-message mode: the quorum this COMMIT may have
                # completed is observable NOW even when in-order delivery
                # still blocks — mark the observation, not the ordering
                self._mark_commit_quorum_observed(key)

    def _mark_commit_quorum_observed(self, key: Tuple[int, int]) -> None:
        """Record ``3pc.commit_quorum`` ONCE per key, at the instant the
        service first sees the quorum (trace-gated: pure observability,
        the ordering path never depends on it)."""
        if not self._trace.enabled:
            return  # keeps the guard local: callers need not re-check
        if key in self._commit_quorum_marked:
            return
        pp = self.prePrepares.get(key)
        if pp is None \
                or preprepare_to_batch_id(pp) not in self._data.prepared:
            return
        if not self._has_commit_quorum(key):
            return
        self._commit_quorum_marked.add(key)
        self._trace.record("3pc.commit_quorum", node=self.name,
                           key=(pp.viewNo, pp.ppSeqNo, pp.digest))

    def _probe_commit_quorums(self) -> None:
        """Tick mode: sweep the unordered in-flight window for commit
        quorums that became visible this tick (bounded by the watermark
        window; snapshot reads only)."""
        for key in sorted(self.prePrepares):
            if key not in self.ordered \
                    and key not in self._commit_quorum_marked:
                self._mark_commit_quorum_observed(key)

    def service_quorum_tick(self) -> None:
        """Evaluate quorums for everything that moved since the last tick.
        The caller has already synced the vote plane; queries here (and any
        triggered by messages until the next tick) read that snapshot, so
        votes recorded during the tick wave buffer for the next flush.

        With a delta-feed plane (device-side quorum eval, the default)
        the tick consumes the plane's newly-completed-certificate deltas
        instead: the device already decided WHICH slots crossed their
        thresholds this tick, so evaluation is O(completions), not
        O(keys-with-activity) re-checked every tick until they order.
        The lost-wakeup guard is structural there — a vote recorded
        during this tick's wave flushes next tick and its transition
        arrives in that tick's delta."""
        plane = self._vote_plane
        if plane is not None and plane.delta_feed:
            deltas = plane.poll_deltas()
            committed_keys: list = []
            if deltas is not None:
                # resolve slots -> keys BEFORE evaluating: ordering below
                # can stabilize a checkpoint and slide the plane, and the
                # delta slots are relative to the PRE-slide h
                view_no, h = self._data.view_no, plane.h
                prepared_keys = [(view_no, h + slot + 1)
                                 for slot in deltas.prepared]
                committed_keys = [(view_no, h + slot + 1)
                                  for slot in deltas.committed]
                for key in prepared_keys:
                    self._try_prepared(key)
                if committed_keys:
                    self._try_order(self._data.last_ordered_3pc)
            # dirt accumulated while the feed was not yet authoritative
            # (plane armed mid-run) drains once; _note_* keeps it empty
            if self._dirty_prepare_keys:
                keys, self._dirty_prepare_keys = \
                    self._dirty_prepare_keys, set()
                for key in sorted(keys):
                    self._try_prepared(key)
            if self._order_dirty:
                self._order_dirty = False
                self._try_order(self._data.last_ordered_3pc)
            if self._trace.enabled:
                # commit quorums that can NOT order yet (head-of-line
                # wait): the delta names exactly the quorums that became
                # visible this tick, so no O(window) prePrepares sweep
                for key in committed_keys:
                    if key not in self.ordered:
                        self._mark_commit_quorum_observed(key)
            self._bls.flush()
            return
        keys: set = set()
        if self._dirty_prepare_keys:
            keys, self._dirty_prepare_keys = self._dirty_prepare_keys, set()
            for key in sorted(keys):
                self._try_prepared(key)
            self._order_dirty = True
        if self._order_dirty:
            self._order_dirty = False
            self._try_order(self._data.last_ordered_3pc)
        if self._vote_plane is not None \
                and self._vote_plane.has_buffered_votes:
            # votes recorded DURING this tick (e.g. our own COMMIT sent by
            # _try_prepared above) are not in the snapshot we just read;
            # they may complete a quorum with no further inbound message,
            # so re-arm evaluation for the next tick (lost-wakeup guard)
            self._order_dirty = True
            self._dirty_prepare_keys |= {
                k for k in keys if k not in self.ordered}
        if self._trace.enabled:
            # commit quorums visible in this tick's snapshot for batches
            # that can NOT order yet (a predecessor blocks in-order
            # delivery): mark the observation now, so commit_quorum →
            # ordered measures the head-of-line wait. Snapshot reads are
            # free in tick mode (defer_flush_on_query).
            self._probe_commit_quorums()
        # every batch _try_order delivered above queued its BLS aggregate
        # check (deferred mode): ONE multi-pairing proves them all
        self._bls.flush()

    @property
    def name(self) -> str:
        return self._data.name

    @property
    def _is_master(self) -> bool:
        return self._data.is_master

    def _can_send_batch(self) -> bool:
        return (self._data.is_primary_in_view
                and self._data.is_participating
                and not self._data.waiting_for_new_view
                # NEW_VIEW-selected batches still being fetched own their
                # seqNos; minting a fresh batch now would collide with them
                and not self._pending_old_view_bids
                and self._data.pp_seq_no < self._data.high_watermark)

    def _on_batch_timer(self) -> None:
        if not self._can_send_batch() or self._requests is None:
            return
        for ledger_id in self._requests.ledger_ids_with_ready():
            if not self._can_send_batch():
                break
            self.send_3pc_batch(ledger_id)
        self._maybe_send_freshness_batch()

    def _maybe_send_freshness_batch(self) -> None:
        """Idle primary: re-sign the state roots periodically with an EMPTY
        batch (reference: freshness updates). Without this, BLS multi-sigs
        over the committed roots age out and proved reads from an idle
        pool stop verifying against any freshness window."""
        interval = self._config.StateFreshnessUpdateInterval
        if interval <= 0 or not self._is_master:
            return
        if not self._can_send_batch():
            return
        now = self._get_time()
        if now - self._last_batch_time < interval:
            return
        self.send_3pc_batch(DOMAIN_LEDGER_ID, allow_empty=True)

    def send_3pc_batch(self, ledger_id: int = DOMAIN_LEDGER_ID,
                       allow_empty: bool = False) -> Optional[PrePrepare]:
        """Primary: pop finalised requests, apply, emit PRE-PREPARE."""
        if not self._can_send_batch() or self._requests is None:
            return None
        reqs = self._requests.pop_ready(
            ledger_id, self._config.Max3PCBatchSize)
        if not reqs and not allow_empty:
            return None
        pp_time = int(self._get_time())
        self._last_batch_time = pp_time
        self._data.pp_seq_no += 1
        state_root = txn_root = None
        discarded = 0
        if self._is_master and self._executor is not None:
            state_root, txn_root = self._executor.apply_batch(
                reqs, ledger_id, pp_time, self._data.pp_seq_no)
            discarded = len(getattr(self._executor, "last_rejected", []))
            self._last_applied_seq = max(self._last_applied_seq,
                                         self._data.pp_seq_no)
        params = dict(
            instId=self._data.inst_id,
            viewNo=self._data.view_no,
            ppSeqNo=self._data.pp_seq_no,
            ppTime=pp_time,
            reqIdr=[r.digest for r in reqs],
            discarded=discarded,
            digest=self._batch_digest([r.digest for r in reqs], pp_time,
                                      state_root, txn_root, ledger_id,
                                      discarded),
            ledgerId=ledger_id,
            stateRootHash=state_root,
            txnRootHash=txn_root,
            sub_seq_no=0,
            final=True,
        )
        params = self._bls.update_pre_prepare(params, ledger_id)
        pp = PrePrepare(**params)
        key = (pp.viewNo, pp.ppSeqNo)
        self.sent_preprepares[key] = pp
        self.prePrepares[key] = pp
        self.batches[key] = ledger_id
        self._data.preprepare_batch(preprepare_to_batch_id(pp))
        if self._vote_plane is not None:
            self._vote_plane.record_preprepare(pp.ppSeqNo)
        self._network.send(pp)
        if self._trace.enabled:
            # reqIdr rides the primary's send mark ONCE per batch: the
            # causal plane's request->batch join (journeys need to know
            # which requests a (view, seq, digest) batch carried, and
            # the batch digest is not invertible)
            self._trace.record("3pc.preprepare_sent", node=self.name,
                               key=(pp.viewNo, pp.ppSeqNo, pp.digest),
                               args={"reqs": len(reqs),
                                     "reqIdr": [r.digest for r in reqs]})
        logger.debug("%s sent PRE-PREPARE %s (%d reqs)", self.name, key,
                     len(reqs))
        return pp

    @staticmethod
    def _batch_digest(req_digests: List[str], pp_time=None,
                      state_root=None, txn_root=None, ledger_id=None,
                      discarded=None) -> str:
        """Digest binding the FULL batch content: request ids, ppTime, both
        roots, the ledger and the discarded count. Because PREPARE/COMMIT
        and NEW_VIEW BatchIDs carry this digest, a fetched
        OLD_VIEW_PREPREPARE with ANY field forged by the responder cannot
        match it (advisor r2 finding)."""
        import hashlib

        payload = "|".join(
            ["".join(req_digests), str(pp_time), str(state_root),
             str(txn_root), str(ledger_id), str(discarded)]).encode()
        return hashlib.sha256(payload).hexdigest()

    # ------------------------------------------------------------------
    # 3PC message processing
    # ------------------------------------------------------------------

    def _common_checks(self, msg, key: Tuple[int, int]):
        """Shared view/watermark admission checks; verdict or None=pass."""
        # multi-instance: every replica's services share the node's external
        # bus; messages of other protocol instances are not ours to handle
        if getattr(msg, "instId", self._data.inst_id) != self._data.inst_id:
            return DISCARD, "other instance"
        view_no, pp_seq_no = key
        if view_no < self._data.view_no:
            return DISCARD, "old view"
        if view_no > self._data.view_no:
            return STASH_VIEW_3PC, "future view"
        if self._data.waiting_for_new_view:
            return STASH_WAITING_NEW_VIEW, "waiting for NEW_VIEW"
        if not self._data.is_participating:
            return STASH_CATCH_UP, "catching up"
        if pp_seq_no <= self._data.low_watermark:
            return DISCARD, "below watermark"
        if pp_seq_no > self._data.high_watermark:
            return STASH_WATERMARKS, "above high watermark"
        return None

    def _raise_suspicion(self, sender: str, suspicion) -> None:
        self._bus.send(RaisedSuspicion(
            inst_id=self._data.inst_id,
            ex=SuspiciousNode(sender, suspicion)))

    def process_preprepare(self, pp: PrePrepare, sender: str):
        key = (pp.viewNo, pp.ppSeqNo)
        verdict = self._common_checks(pp, key)
        if verdict is not None:
            return verdict
        if sender != self._data.primary_name:
            self._raise_suspicion(sender, Suspicions.PPR_FRM_NON_PRIMARY)
            return DISCARD, "PRE-PREPARE from non-primary"
        existing = self.prePrepares.get(key)
        if existing is not None:
            if existing.digest != pp.digest:
                self._raise_suspicion(sender, Suspicions.DUPLICATE_PPR_SENT)
            return DISCARD, "duplicate PRE-PREPARE"
        try:
            self._bls.validate_pre_prepare(pp, sender)
        except SuspiciousNode as ex:
            self._bus.send(RaisedSuspicion(self._data.inst_id, ex))
            return DISCARD, "bad BLS multi-sig"

        # all referenced requests must be finalised here too — EXCEPT for
        # batches at/below our committed height (post-view-change
        # re-ordering of already-executed batches): their roots come from
        # the audit ledger and their content may be GC'd after execution
        committed = (self._executor.committed_seq()
                     if self._executor is not None else 0)
        if self._requests is not None and pp.ppSeqNo > committed:
            missing = [d for d in pp.reqIdr
                       if self._requests.get(d) is None]
            if missing:
                self._bus.send(RequestPropagates(missing))
                return STASH_WAITING_REQUESTS, f"missing {len(missing)} reqs"

        if pp.digest != self._batch_digest(list(pp.reqIdr), pp.ppTime,
                                           pp.stateRootHash, pp.txnRootHash,
                                           pp.ledgerId, pp.discarded):
            self._raise_suspicion(sender, Suspicions.PPR_DIGEST_WRONG)
            return DISCARD, "digest mismatch"

        # speculative re-apply on master: roots must match the primary's.
        # Application MUST be in ppSeqNo order (roots chain) — a PRE-PREPARE
        # arriving ahead of its predecessor is stashed, not mis-applied.
        if self._is_master and self._executor is not None \
                and self._requests is not None:
            committed = self._executor.committed_seq()
            floor = max(committed, self._last_applied_seq)
            historical = pp.ppSeqNo <= committed
            if not historical and pp.ppSeqNo != floor + 1:
                return STASH_WAITING_PREV_PP, (
                    f"out-of-order apply: {pp.ppSeqNo} after {floor}")
            reqs = [self._requests.get(d) for d in pp.reqIdr]
            state_root, txn_root = self._executor.apply_batch(
                reqs, pp.ledgerId, pp.ppTime, pp.ppSeqNo)
            # a HISTORICAL batch (<= committed: post-view-change re-order
            # of something already executed) stages nothing — the roots
            # come from the audit ledger, and on mismatch there is nothing
            # of ours to revert (reverting would pop an unrelated
            # genuinely-staged batch and corrupt the uncommitted roots)
            if state_root != pp.stateRootHash:
                if not historical:
                    self._executor.revert_batches(pp.ledgerId, 1)
                self._raise_suspicion(sender, Suspicions.PPR_STATE_WRONG)
                return DISCARD, "state root mismatch"
            if txn_root != pp.txnRootHash:
                if not historical:
                    self._executor.revert_batches(pp.ledgerId, 1)
                self._raise_suspicion(sender, Suspicions.PPR_TXN_WRONG)
                return DISCARD, "txn root mismatch"
            # the rejection split is deterministic: a primary lying about
            # the discarded count cannot hide behind matching roots
            my_discarded = len(getattr(self._executor, "last_rejected", []))
            if pp.ppSeqNo > committed and pp.discarded != my_discarded:
                self._executor.revert_batches(pp.ledgerId, 1)
                self._raise_suspicion(sender, Suspicions.PPR_DISCARDED_WRONG)
                return DISCARD, "discarded count mismatch"
            self._last_applied_seq = max(floor, pp.ppSeqNo)

        self.prePrepares[key] = pp
        self.batches[key] = pp.ledgerId
        self._data.preprepare_batch(preprepare_to_batch_id(pp))
        if self._vote_plane is not None:
            self._vote_plane.record_preprepare(pp.ppSeqNo)
            # replay digest-matching PREPAREs that arrived before the
            # PRE-PREPARE (they were logged but never scattered — only
            # validated votes reach the device)
            for s, p in self.prepares.get(key, {}).items():
                if p.digest == pp.digest:
                    self._vote_plane.record_prepare(s, pp.ppSeqNo)
        self._bls.process_pre_prepare(pp, sender)
        if self._trace.enabled:
            self._trace.record("3pc.preprepare", node=self.name,
                               key=(pp.viewNo, pp.ppSeqNo, pp.digest),
                               args={"reqs": len(pp.reqIdr)})

        if not self._data.is_primary_in_view:
            self._send_prepare(pp)
        self._note_prepare_activity(key)
        # the successor PRE-PREPARE may be waiting on this one
        self._stasher.process_stashed(STASH_WAITING_PREV_PP)
        return PROCESS

    def on_request_finalised(self) -> None:
        """Node hook: newly finalised requests may unblock stashed PPs."""
        self._stasher.process_stashed(STASH_WAITING_REQUESTS)

    def _send_prepare(self, pp: PrePrepare) -> None:
        prepare = Prepare(
            instId=self._data.inst_id,
            viewNo=pp.viewNo,
            ppSeqNo=pp.ppSeqNo,
            ppTime=pp.ppTime,
            digest=pp.digest,
            stateRootHash=pp.stateRootHash,
            txnRootHash=pp.txnRootHash,
        )
        key = (pp.viewNo, pp.ppSeqNo)
        self.prepares.setdefault(key, {})[self.name] = prepare
        if self._vote_plane is not None:
            self._vote_plane.record_prepare(self.name, pp.ppSeqNo)
        self._network.send(prepare)

    def process_prepare(self, prepare: Prepare, sender: str):
        key = (prepare.viewNo, prepare.ppSeqNo)
        verdict = self._common_checks(prepare, key)
        if verdict is not None:
            return verdict
        if sender not in self._data.validators:
            # a demoted (or never-admitted) node's votes must not count
            # toward any certificate
            return DISCARD, "PREPARE from non-validator"
        primary_name = self._data.primary_name
        if sender == primary_name:
            self._raise_suspicion(sender, Suspicions.PR_FRM_PRIMARY)
            return DISCARD, "PREPARE from primary"
        votes = self.prepares.setdefault(key, {})
        if sender in votes:
            self._raise_suspicion(sender, Suspicions.DUPLICATE_PR_SENT)
            return DISCARD, "duplicate PREPARE"
        pp = self.prePrepares.get(key)
        if pp is not None and prepare.digest != pp.digest:
            self._raise_suspicion(sender, Suspicions.PR_DIGEST_WRONG)
            return DISCARD, "PREPARE digest mismatch"
        votes[sender] = prepare
        if self._vote_plane is not None and pp is not None:
            # pp present => digest checked above; safe to scatter
            self._vote_plane.record_prepare(sender, prepare.ppSeqNo)
        self._bls.process_prepare(prepare, sender)
        self._note_prepare_activity(key)
        return PROCESS

    def _dict_prepare_quorum(self, key: Tuple[int, int]) -> bool:
        # Only votes whose digest matches the accepted PRE-PREPARE count:
        # PREPAREs can arrive before the PRE-PREPARE (and are recorded), so
        # a byzantine node must not be able to inflate the certificate with
        # arbitrary-digest early votes.
        pp = self.prePrepares.get(key)
        if pp is None:
            return False
        votes = self.prepares.get(key, {})
        others = [s for s, p in votes.items()
                  if s != self._data.primary_name and p.digest == pp.digest]
        return self._data.quorums.prepare.is_reached(len(others))

    def _has_prepare_quorum(self, key: Tuple[int, int]) -> bool:
        if self._vote_plane is None:
            return self._dict_prepare_quorum(key)
        dev = (key[0] == self._data.view_no
               and self._vote_plane.has_prepare_quorum(key[1]))
        if self._shadow_check:
            host = self._dict_prepare_quorum(key)
            assert dev == host, ("prepare quorum divergence", key, dev, host)
        return dev

    def _try_prepared(self, key: Tuple[int, int]) -> None:
        pp = self.prePrepares.get(key)
        if pp is None or not self._has_prepare_quorum(key):
            return
        bid = preprepare_to_batch_id(pp)
        if bid in self._data.prepared:
            return
        # votes must match the accepted PRE-PREPARE digest
        self._data.prepare_batch(bid)
        if self._trace.enabled:
            self._trace.record("3pc.prepare_quorum", node=self.name,
                               key=(pp.viewNo, pp.ppSeqNo, pp.digest))
        self._send_commit(pp)

    def _send_commit(self, pp: PrePrepare) -> None:
        key = (pp.viewNo, pp.ppSeqNo)
        params = dict(instId=self._data.inst_id, viewNo=pp.viewNo,
                      ppSeqNo=pp.ppSeqNo)
        params = self._bls.update_commit(params, pp)
        commit = Commit(**params)
        self.commits.setdefault(key, {})[self.name] = commit
        if self._vote_plane is not None:
            self._vote_plane.record_commit(self.name, pp.ppSeqNo)
        self._network.send(commit)
        self._note_commit_activity(key)

    def process_commit(self, commit: Commit, sender: str):
        key = (commit.viewNo, commit.ppSeqNo)
        verdict = self._common_checks(commit, key)
        if verdict is not None:
            return verdict
        if sender not in self._data.validators:
            return DISCARD, "COMMIT from non-validator"
        votes = self.commits.setdefault(key, {})
        if sender in votes:
            self._raise_suspicion(sender, Suspicions.DUPLICATE_CM_SENT)
            return DISCARD, "duplicate COMMIT"
        pp = self.prePrepares.get(key)
        try:
            self._bls.validate_commit(commit, sender, pp)
        except SuspiciousNode as ex:
            self._bus.send(RaisedSuspicion(self._data.inst_id, ex))
            return DISCARD, "bad BLS sig in COMMIT"
        votes[sender] = commit
        if self._vote_plane is not None:
            self._vote_plane.record_commit(sender, commit.ppSeqNo)
        self._bls.process_commit(commit, sender)
        self._note_commit_activity(key)
        return PROCESS

    # ------------------------------------------------------------------
    # ordering
    # ------------------------------------------------------------------

    def _dict_commit_quorum(self, key: Tuple[int, int]) -> bool:
        return self._data.quorums.commit.is_reached(
            len(self.commits.get(key, {})))

    def _has_commit_quorum(self, key: Tuple[int, int]) -> bool:
        if self._vote_plane is None:
            return self._dict_commit_quorum(key)
        dev = (key[0] == self._data.view_no
               and self._vote_plane.has_commit_quorum(key[1]))
        if self._shadow_check:
            host = self._dict_commit_quorum(key)
            assert dev == host, ("commit quorum divergence", key, dev, host)
        return dev

    def _can_order(self, key: Tuple[int, int]) -> bool:
        pp = self.prePrepares.get(key)
        if pp is None:
            return False
        bid = preprepare_to_batch_id(pp)
        if bid not in self._data.prepared:
            return False
        if not self._has_commit_quorum(key):
            return False
        if key in self.ordered:
            return False
        # strict in-order delivery within the view
        view_no, pp_seq_no = key
        last_view, last_seq = self._data.last_ordered_3pc
        return pp_seq_no == last_seq + 1

    def _try_order(self, key: Tuple[int, int]) -> None:
        # drain in order: the commit quorum for seq k may have arrived
        # before k-1 ordered
        progressed = True
        while progressed:
            progressed = False
            nxt = (self._data.view_no, self._data.last_ordered_3pc[1] + 1)
            if self._can_order(nxt):
                self._order_3pc_key(nxt)
                progressed = True

    def _order_3pc_key(self, key: Tuple[int, int]) -> None:
        pp = self.prePrepares[key]
        self.ordered.add(key)
        self._data.last_ordered_3pc = key
        if self._trace.enabled:
            # the quorum observation usually coincides with ordering
            # (head-of-line batch); when it was visible EARLIER while a
            # predecessor blocked, _mark_commit_quorum_observed already
            # stamped it and the dedupe keeps that earlier timestamp
            self._mark_commit_quorum_observed(key)
            self._trace.record("3pc.ordered", node=self.name,
                               key=(pp.viewNo, pp.ppSeqNo, pp.digest),
                               args={"reqs": len(pp.reqIdr)})
        self._bls.process_order(key, self._data.quorums, pp)
        ordered = Ordered(
            instId=self._data.inst_id,
            viewNo=pp.viewNo,
            ppSeqNo=pp.ppSeqNo,
            ppTime=pp.ppTime,
            reqIdr=list(pp.reqIdr),
            discarded=pp.discarded,
            ledgerId=pp.ledgerId,
            stateRootHash=pp.stateRootHash,
            txnRootHash=pp.txnRootHash,
            auditTxnRootHash=pp.auditTxnRootHash,
            originalViewNo=pp.originalViewNo,
            digest=pp.digest,
        )
        logger.debug("%s ordered %s", self.name, key)
        self._bus.send(ordered)

    # ------------------------------------------------------------------
    # view change integration
    # ------------------------------------------------------------------

    def process_view_change_started(self, msg: ViewChangeStarted) -> None:
        """Revert uncommitted batches; retain PrePrepares for re-ordering."""
        if self._trace.enabled:
            self._trace.record("vc.started", cat="vc", node=self.name,
                               args={"view_no": self._data.view_no})
        if self._is_master and self._executor is not None:
            # revert unordered speculatively-applied batches (newest first)
            unordered = [k for k in self.prePrepares
                         if k not in self.ordered]
            by_ledger: Dict[int, int] = {}
            for k in unordered:
                lid = self.batches.get(k, DOMAIN_LEDGER_ID)
                by_ledger[lid] = by_ledger.get(lid, 0) + 1
            for lid, count in by_ledger.items():
                self._executor.revert_batches(lid, count)
            self._last_applied_seq = self._executor.committed_seq()
        for key, pp in self.prePrepares.items():
            orig = pp.originalViewNo if pp.originalViewNo is not None \
                else pp.viewNo
            self.old_view_preprepares[(orig, pp.ppSeqNo, pp.digest)] = pp
        if self._vote_plane is not None:
            # old-view votes are void; slots refill during re-ordering
            self._vote_plane.reset(h=self._data.low_watermark)
        self._pending_old_view_bids.clear()
        self._dirty_prepare_keys.clear()
        self._commit_quorum_marked.clear()
        self._fetch_timer.stop()
        self.sent_preprepares.clear()
        self.prePrepares.clear()
        self.prepares.clear()
        self.commits.clear()
        self.batches.clear()

    def process_new_view_checkpoints_applied(
            self, msg: NewViewCheckpointsApplied) -> None:
        """Re-order the batches selected by NEW_VIEW in the new view."""
        cp_view, cp_seq, _ = msg.checkpoint
        # EVERY batch above the checkpoint is re-ordered in the new view,
        # including ones this node already ordered — its 3PC votes are
        # needed by peers that had not. Double-execution is prevented by
        # the executor seam (historical roots) and the node-level ordered
        # dedup on ppSeqNo.
        self._data.pp_seq_no = cp_seq
        self._data.last_ordered_3pc = (msg.view_no, cp_seq)
        self.ordered.clear()  # keys were in the old view; all re-keyed now
        self._data.clear_batches()
        for bid in msg.batches:
            view_no, pp_view_no, pp_seq_no, digest = bid
            old_key = (pp_view_no, pp_seq_no, digest)
            old_pp = self.old_view_preprepares.get(old_key)
            if old_pp is None:
                # liveness: with strict in-order ordering, a hole here would
                # stall everything at/past this seqNo. ANY node that listed
                # the batch in its VIEW_CHANGE holds the old PrePrepare (the
                # new primary may itself lack it), so fetch it from the pool
                # — the digest in the batch id authenticates the content.
                logger.warning("%s missing old PrePrepare for %s, requesting",
                               self.name, bid)
                self._pending_old_view_bids[old_key] = msg.view_no
                self._bus.send(MissingMessage(
                    msg_type="OLD_VIEW_PREPREPARE",
                    key=old_key,
                    inst_id=self._data.inst_id,
                    dst=None))
                continue
            self._apply_new_view_batch(old_pp, msg.view_no, pp_view_no)
        if self._pending_old_view_bids:
            self._fetch_timer.start()
        self._stasher.process_all_stashed()

    def _refetch_pending_old_view_pps(self) -> None:
        if not self._pending_old_view_bids:
            self._fetch_timer.stop()
            return
        for old_key in list(self._pending_old_view_bids):
            self._bus.send(MissingMessage(
                msg_type="OLD_VIEW_PREPREPARE",
                key=old_key,
                inst_id=self._data.inst_id,
                dst=None))

    def _apply_new_view_batch(self, old_pp: PrePrepare, new_view_no: int,
                              orig_view_no: int) -> None:
        """Re-key one NEW_VIEW-selected batch into the new view and process
        it (primary: re-broadcast; replica: run the normal PP path)."""
        params = old_pp._fields
        params.update(viewNo=new_view_no, originalViewNo=orig_view_no)
        new_pp = PrePrepare(**params)
        self._data.pp_seq_no = max(self._data.pp_seq_no, new_pp.ppSeqNo)
        if self._data.is_primary_in_view:
            self.sent_preprepares[(new_pp.viewNo, new_pp.ppSeqNo)] = new_pp
            self._network.send(new_pp)
            # these requests are owned by the re-keyed batch now; minting a
            # fresh batch from them later would double-order them
            if self._requests is not None:
                self._requests.mark_ordered(list(new_pp.reqIdr))
        # BOTH primary and replicas run the normal PP path through the
        # stasher: the primary must re-APPLY the batch (its speculative
        # state was reverted at view-change start) under the same in-order
        # discipline, and out-of-order/early verdicts must stash, not
        # vanish (a direct handler call would drop the verdict)
        self._stasher.process(new_pp, self._data.primary_name)

    def process_requested_old_view_pp(self, pp: PrePrepare) -> None:
        """A fetched old-view PrePrepare arrived (MessageReqService validated
        the digest against what we asked for)."""
        orig = pp.originalViewNo if pp.originalViewNo is not None \
            else pp.viewNo
        old_key = (orig, pp.ppSeqNo, pp.digest)
        self.old_view_preprepares[old_key] = pp
        new_view_no = self._pending_old_view_bids.pop(old_key, None)
        if not self._pending_old_view_bids:
            self._fetch_timer.stop()
        if new_view_no is None or new_view_no != self._data.view_no:
            return  # no longer waiting (another view change happened)
        self._apply_new_view_batch(pp, new_view_no, orig)
        self._stasher.process_stashed(STASH_WAITING_PREV_PP)

    def process_catchup_finished(self, msg: CatchupFinished) -> None:
        """Resync 3PC state to the durably caught-up point: everything at
        or below it is already executed (the ledgers ARE the certificates);
        stashed messages for the live tail replay through the normal path."""
        view_no, pp_seq_no = msg.last_caught_up_3pc
        if pp_seq_no > self._data.last_ordered_3pc[1]:
            self._data.last_ordered_3pc = (view_no, pp_seq_no)
        self._data.pp_seq_no = max(self._data.pp_seq_no, pp_seq_no)
        self._data.low_watermark = max(self._data.low_watermark, pp_seq_no)
        self._data.stable_checkpoint = max(self._data.stable_checkpoint,
                                           pp_seq_no)
        self._data.free_upto(pp_seq_no)
        for store in (self.sent_preprepares, self.prePrepares,
                      self.prepares, self.commits, self.batches):
            for key in [k for k in store if k[1] <= pp_seq_no]:
                del store[key]
        self.ordered = {k for k in self.ordered if k[1] > pp_seq_no}
        self._commit_quorum_marked = {
            k for k in self._commit_quorum_marked if k[1] > pp_seq_no}
        if self._executor is not None:
            # the leecher reverted EVERY staged speculative apply before
            # fetching (catchup writes committed txns): nothing above the
            # durable floor is applied anymore, whatever the pre-catchup
            # bookkeeping said — a stale higher floor would let a
            # retained batch order against a staged list that is empty
            self._last_applied_seq = self._executor.committed_seq()
        # retained PRE-PREPAREs above the caught-up point were applied
        # BEFORE the leecher's revert (a mid-stream second catchup hits
        # this): their staged batches are gone, so ordering them now
        # would commit nothing. Drop the PP records (their PREPARE/COMMIT
        # votes stay — the stall watchdog's in-flight re-request sees
        # those keys, re-fetches each PP from the primary, and the normal
        # processing path re-APPLIES it under the in-order discipline).
        dropped = [k for k in self.prePrepares if k not in self.ordered]
        for key in dropped:
            pp = self.prePrepares.pop(key)
            self.batches.pop(key, None)
            self._data.free_batch(preprepare_to_batch_id(pp))
        if self._vote_plane is not None:
            self._vote_plane.reset(h=pp_seq_no)
        self._bls.gc((view_no, pp_seq_no))
        self._stasher.process_all_stashed()

    def process_checkpoint_stabilized(self, msg: CheckpointStabilized) -> None:
        """GC 3PC logs at or below the new stable checkpoint."""
        stable_seq = msg.last_stable_3pc[1]
        self._data.low_watermark = stable_seq
        self._data.stable_checkpoint = stable_seq
        self._data.free_upto(stable_seq)
        for store in (self.sent_preprepares, self.prePrepares,
                      self.prepares, self.commits, self.batches):
            for key in [k for k in store if k[1] <= stable_seq]:
                del store[key]
        self.ordered = {k for k in self.ordered if k[1] > stable_seq}
        self._commit_quorum_marked = {
            k for k in self._commit_quorum_marked if k[1] > stable_seq}
        self.old_view_preprepares = {
            k: v for k, v in self.old_view_preprepares.items()
            if k[1] > stable_seq}
        if self._vote_plane is not None:
            self._vote_plane.slide_to(stable_seq)
        self._bls.gc(msg.last_stable_3pc)
        self._stasher.process_stashed(STASH_WATERMARKS)

    # --- introspection (tests / monitor) ------------------------------

    def l_last_ordered(self) -> Tuple[int, int]:
        return self._data.last_ordered_3pc
