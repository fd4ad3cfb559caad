"""View change: VIEW_CHANGE collection, NEW_VIEW computation & validation.

Reference: plenum/server/consensus/view_change_service.py
(`ViewChangeService`) and the batch/checkpoint selection math. The
selection functions are pure (unit-test exhaustively — SURVEY.md §7 hard
part #4):

- checkpoint selection: the highest checkpoint value present in >= f+1
  VIEW_CHANGE messages (some honest node has it; safe to start from).
- batch selection, per seqNo above that checkpoint: a batch is selected if
  it is *prepared* in >= 1 collected VIEW_CHANGE AND *preprepared* in >=
  f+1 of them. (A batch ordered anywhere must appear prepared in every
  n-f subset, and weak-quorum preprepare support authenticates the digest.)

All replicas run the same math over the same n-f VIEW_CHANGE set listed in
NEW_VIEW, so validation = recomputation.

Copy of ``indy_plenum_tpu/server/consensus/view_change_service.py``, with
its imports bound to the port.
"""
from __future__ import annotations

import hashlib
import logging
from typing import Dict, List, Optional, Tuple

from ...common.event_bus import ExternalBus, InternalBus
from ...common.messages.internal_messages import (
    NewViewAccepted,
    NewViewCheckpointsApplied,
    NodeNeedViewChange,
    PrimarySelected,
    ViewChangeFinished,
    ViewChangeStarted,
    VoteForViewChange,
)
from ...common.messages.node_messages import NewView, ViewChange
from ...common.serializers.serialization import serialize_for_signing
from ...common.stashing_router import (
    DISCARD,
    PROCESS,
    STASH_WAITING_VIEW_CHANGE,
    StashingRouter,
)
from ...common.timer import RepeatingTimer, TimerService
from ..quorums import Quorums
from .consensus_shared_data import ConsensusSharedData
from .primary_selector import RoundRobinConstantNodesPrimariesSelector

logger = logging.getLogger(__name__)

CheckpointValue = Tuple[int, int, str]
BatchIDList = List[list]


def view_change_digest(vc: ViewChange) -> str:
    return hashlib.sha256(
        serialize_for_signing(vc.as_dict())).hexdigest()


def calc_checkpoint(view_changes: List[ViewChange],
                    quorums: Quorums) -> Optional[CheckpointValue]:
    """Highest checkpoint supported by >= f+1 VIEW_CHANGEs."""
    counts: Dict[CheckpointValue, int] = {}
    for vc in view_changes:
        # dedup within each VIEW_CHANGE: one sender contributes at most one
        # vote per checkpoint value (else a single byzantine VC listing the
        # same checkpoint f+1 times fabricates weak-quorum support alone).
        # Order-preserving dedup: set iteration is hash-seed-dependent and
        # every replica must compute identical results.
        for cp in dict.fromkeys(map(tuple, vc.checkpoints)):
            counts[cp] = counts.get(cp, 0) + 1
    supported = [cp for cp, cnt in counts.items()
                 if quorums.weak.is_reached(cnt)]
    if not supported:
        return None
    return max(supported, key=lambda cp: cp[1])


def calc_batches(checkpoint: CheckpointValue,
                 view_changes: List[ViewChange],
                 quorums: Quorums) -> BatchIDList:
    """Batches to re-order in the new view, ascending by seqNo."""
    _, cp_seq, _ = checkpoint
    # candidate digests per seqNo with their support
    prepared_by_seq: Dict[int, Dict[str, int]] = {}
    preprepared_by_seq: Dict[int, Dict[str, int]] = {}
    batch_info: Dict[Tuple[int, str], list] = {}
    def _dedup_by_vote_key(batch_ids):
        # one vote per sender per COUNTING key (seq, digest) — deduping on
        # the full batch-id tuple would let a byzantine VC fabricate extra
        # votes by varying the view fields of the same (seq, digest).
        # Order-preserving (dict) so batch_info tie-breaks are identical on
        # every replica regardless of hash seed.
        seen = {}
        for b in batch_ids:
            t = tuple(b)
            seen.setdefault((t[2], t[3]), t)
        return seen.values()

    for vc in view_changes:
        for b in _dedup_by_vote_key(vc.prepared):
            _, pp_view, seq, digest = b
            prepared_by_seq.setdefault(seq, {})
            prepared_by_seq[seq][digest] = \
                prepared_by_seq[seq].get(digest, 0) + 1
            batch_info.setdefault((seq, digest), list(b))
        for b in _dedup_by_vote_key(vc.preprepared):
            _, pp_view, seq, digest = b
            preprepared_by_seq.setdefault(seq, {})
            preprepared_by_seq[seq][digest] = \
                preprepared_by_seq[seq].get(digest, 0) + 1
            batch_info.setdefault((seq, digest), list(b))

    out: BatchIDList = []
    for seq in sorted(set(prepared_by_seq) | set(preprepared_by_seq)):
        if seq <= cp_seq:
            continue
        for digest, prep_cnt in sorted(prepared_by_seq.get(seq, {}).items()):
            pp_cnt = preprepared_by_seq.get(seq, {}).get(digest, 0)
            if prep_cnt >= 1 and quorums.weak.is_reached(pp_cnt):
                out.append(batch_info[(seq, digest)])
                break  # at most one batch per seqNo can satisfy this
    # gaps are allowed to remain: the new primary fills them with its own
    # batches after re-ordering (reference does the same)
    return out


class ViewChangeService:
    def __init__(self,
                 data: ConsensusSharedData,
                 timer: TimerService,
                 bus: InternalBus,
                 network: ExternalBus,
                 stasher: StashingRouter,
                 checkpoint_values_provider=None,
                 config=None):
        from ...config import getConfig

        self._data = data
        self._timer = timer
        self._bus = bus
        self._network = network
        self._stasher = stasher
        self._config = config or getConfig()
        self._selector = RoundRobinConstantNodesPrimariesSelector(
            lambda: self._data.validators)
        # () -> list of checkpoint values for the VIEW_CHANGE msg
        self._checkpoint_values = checkpoint_values_provider or (
            lambda: [(self._data.view_no, self._data.stable_checkpoint, "stable")])

        self._view_changes: Dict[str, ViewChange] = {}  # sender -> VC
        self._new_view: Optional[NewView] = None
        self._timeout_generation = 0  # invalidates stale NewView timeouts

        stasher.subscribe(ViewChange, self.process_view_change)
        stasher.subscribe(NewView, self.process_new_view)
        bus.subscribe(NodeNeedViewChange, self.process_need_view_change)

    @property
    def name(self) -> str:
        return self._data.name

    # ------------------------------------------------------------------

    def process_need_view_change(self, msg: NodeNeedViewChange) -> None:
        proposed = msg.view_no if msg.view_no is not None \
            else self._data.view_no + 1
        if proposed <= self._data.view_no:
            return
        self.start_view_change(proposed)

    def start_view_change(self, proposed_view_no: int) -> None:
        logger.info("%s starting view change to view %d", self.name,
                    proposed_view_no)
        old_view = self._data.view_no
        self._data.view_no = proposed_view_no
        self._data.waiting_for_new_view = True
        self._data.primaries = self._selector.select_primaries(
            proposed_view_no, max(1, len(self._data.primaries) or 1))
        self._view_changes.clear()
        self._new_view = None

        # ordering service reverts; checkpoint service resets
        self._bus.send(ViewChangeStarted(view_no=proposed_view_no))

        vc = ViewChange(
            viewNo=proposed_view_no,
            stableCheckpoint=self._data.stable_checkpoint,
            prepared=[list(b) for b in self._data.prepared],
            preprepared=[list(b) for b in self._data.preprepared],
            checkpoints=[list(c) for c in self._checkpoint_values()],
        )
        self._view_changes[self.name] = vc
        self._network.send(vc)

        # liveness: if NEW_VIEW does not arrive in time (e.g. the new
        # primary is dead too), vote to skip to the next view
        self._timeout_generation += 1
        generation = self._timeout_generation

        def on_timeout():
            if (self._data.waiting_for_new_view
                    and generation == self._timeout_generation):
                logger.info("%s NEW_VIEW timeout in view %d", self.name,
                            self._data.view_no)
                self._bus.send(VoteForViewChange(
                    suspicion=None, view_no=self._data.view_no + 1))

        self._timer.schedule(self._config.NewViewTimeout, on_timeout)
        self._stasher.process_stashed(STASH_WAITING_VIEW_CHANGE)
        self._try_build_or_validate()

    def process_view_change(self, vc: ViewChange, sender: str):
        if vc.viewNo < self._data.view_no:
            return DISCARD, "old view"
        if vc.viewNo > self._data.view_no:
            return STASH_WAITING_VIEW_CHANGE, "future view"
        if not self._data.waiting_for_new_view:
            return DISCARD, "no view change in progress"
        self._view_changes[sender] = vc
        self._try_build_or_validate()
        return PROCESS

    def process_new_view(self, nv: NewView, sender: str):
        if nv.viewNo < self._data.view_no:
            return DISCARD, "old view"
        if nv.viewNo > self._data.view_no:
            return STASH_WAITING_VIEW_CHANGE, "future view"
        expected_primary = self._selector.select_master_primary(nv.viewNo)
        if sender != expected_primary or nv.primary != expected_primary:
            return DISCARD, "NEW_VIEW not from the expected primary"
        self._new_view = nv
        self._try_build_or_validate()
        return PROCESS

    # ------------------------------------------------------------------

    def _is_new_primary(self) -> bool:
        return self._selector.select_master_primary(
            self._data.view_no) == self.name

    def _try_build_or_validate(self) -> None:
        if not self._data.waiting_for_new_view:
            return
        if not self._data.quorums.view_change.is_reached(
                len(self._view_changes)):
            return
        if self._is_new_primary():
            self._build_new_view()
        elif self._new_view is not None:
            self._validate_new_view()

    def _build_new_view(self) -> None:
        vcs = list(self._view_changes.values())
        checkpoint = calc_checkpoint(vcs, self._data.quorums)
        if checkpoint is None:
            return
        batches = calc_batches(checkpoint, vcs, self._data.quorums)
        nv = NewView(
            viewNo=self._data.view_no,
            viewChanges=sorted(
                [s, view_change_digest(vc)]
                for s, vc in self._view_changes.items()),
            checkpoint=list(checkpoint),
            batches=batches,
            primary=self.name,
        )
        self._new_view = nv
        self._network.send(nv)
        self._finish(nv)

    def _validate_new_view(self) -> None:
        nv = self._new_view
        assert nv is not None
        # need every VIEW_CHANGE the primary claims to have used
        listed = {tuple(x) for x in nv.viewChanges}
        have = {(s, view_change_digest(vc))
                for s, vc in self._view_changes.items()}
        missing = listed - have
        if missing:
            logger.debug("%s waiting for %d VIEW_CHANGEs used by NEW_VIEW",
                         self.name, len(missing))
            return
        vcs = [vc for s, vc in self._view_changes.items()
               if (s, view_change_digest(vc)) in listed]
        checkpoint = calc_checkpoint(vcs, self._data.quorums)
        if checkpoint is None or list(checkpoint) != list(nv.checkpoint):
            logger.warning("%s NEW_VIEW checkpoint mismatch", self.name)
            self._start_next_view_change()
            return
        batches = calc_batches(tuple(nv.checkpoint), vcs, self._data.quorums)
        if [list(b) for b in batches] != [list(b) for b in nv.batches]:
            logger.warning("%s NEW_VIEW batches mismatch", self.name)
            self._start_next_view_change()
            return
        self._finish(nv)

    def _start_next_view_change(self) -> None:
        """Bad NEW_VIEW from the would-be primary: vote for the next view."""
        self._bus.send(NodeNeedViewChange(view_no=self._data.view_no + 1))

    def _finish(self, nv: NewView) -> None:
        self._data.waiting_for_new_view = False
        self._data.last_completed_view_no = self._data.view_no
        self._timeout_generation += 1  # cancel the pending NEW_VIEW timeout
        logger.info("%s completed view change to view %d (primary %s)",
                    self.name, nv.viewNo, nv.primary)
        self._bus.send(NewViewAccepted(
            view_no=nv.viewNo,
            checkpoint=tuple(nv.checkpoint),
            batches=[list(b) for b in nv.batches],
            primary=nv.primary,
        ))
        self._bus.send(NewViewCheckpointsApplied(
            view_no=nv.viewNo,
            checkpoint=tuple(nv.checkpoint),
            batches=[list(b) for b in nv.batches],
        ))
        self._bus.send(ViewChangeFinished(view_no=nv.viewNo))
        # lets the primary-connection monitor re-evaluate reachability
        self._bus.send(PrimarySelected())
