"""Checkpointing: periodic digests, stabilization, watermark advance.

Reference: plenum/server/consensus/checkpoint_service.py
(`CheckpointService`). Every CHK_FREQ ordered batches the replica emits
CHECKPOINT(seqNoEnd, digest); on a quorum (n-f-1 others + own match) the
checkpoint becomes *stable*: 3PC logs at or below it are garbage-collected
and the watermarks advance (emitted as ``CheckpointStabilized`` for the
OrderingService). If f+1 nodes checkpoint beyond our high watermark we are
lagging and need catchup (``NeedMasterCatchup``).

Copy of ``indy_plenum_tpu/server/consensus/checkpoint_service.py``, with its
imports bound to the port.
"""
from __future__ import annotations

import hashlib
import logging
from typing import Dict, Optional, Tuple

from ...common.event_bus import ExternalBus, InternalBus
from ...common.messages.internal_messages import (
    CatchupFinished,
    CheckpointStabilized,
    NeedMasterCatchup,
    ViewChangeStarted,
)
from ...common.messages.node_messages import Checkpoint, Ordered
from ...common.stashing_router import (
    DISCARD,
    PROCESS,
    StashingRouter,
)
from .consensus_shared_data import ConsensusSharedData

logger = logging.getLogger(__name__)

CheckpointKey = Tuple[int, int, str]  # (view_no, seq_no_end, digest)


class CheckpointService:
    def __init__(self,
                 data: ConsensusSharedData,
                 bus: InternalBus,
                 network: ExternalBus,
                 stasher: StashingRouter,
                 config=None,
                 vote_plane=None,
                 shadow_check: bool = False,
                 barrier=None,
                 lane: int = 0):
        from ...config import getConfig

        self._data = data
        self._bus = bus
        self._network = network
        self._stasher = stasher
        self._config = config or getConfig()
        # cross-lane checkpoint barrier (ordering lanes, lanes/barrier.py):
        # when set, a locally-quorate checkpoint window may not stabilize
        # (GC + watermark advance + CheckpointStabilized) until the
        # barrier has SEALED that window across every lane — the lane's
        # ordering then stalls at its high watermark instead of running
        # more than LOG_SIZE past the slowest lane. None = single-lane
        # behaviour, bit-identical to the pre-lanes service.
        self._barrier = barrier
        self._lane = lane
        # device checkpoint tally (tpu.vote_plane). Only digest-matching
        # votes are scattered (the tensor is digest-blind), own vote
        # included per the vote-inclusion contract: device n-f == host
        # n-f-1 others + own.
        self._vote_plane = vote_plane
        self._shadow_check = shadow_check
        # tick-batched mode: a stabilization attempt that fails against the
        # stale snapshot is retried on the next tick (see service_tick)
        self._tick_mode = (vote_plane is not None
                           and self._config.QuorumTickInterval > 0)
        self._dirty_stabilize: set = set()  # (view_no, seq_no_end)

        # digests of ordered batches since the last checkpoint boundary
        self._digests_since: list[str] = []
        self._own_checkpoints: Dict[int, Checkpoint] = {}  # seqNoEnd -> msg
        # votes: (view, seq_end, digest) -> set of senders
        self._received: Dict[CheckpointKey, set] = {}

        stasher.subscribe(Checkpoint, self.process_checkpoint)
        bus.subscribe(Ordered, self.process_ordered)
        bus.subscribe(ViewChangeStarted, self.process_view_change_started)
        bus.subscribe(CatchupFinished, self.process_catchup_finished)

    @property
    def _chk_freq(self) -> int:
        return self._config.CHK_FREQ

    # ------------------------------------------------------------------

    def process_ordered(self, ordered: Ordered, *args) -> None:
        if ordered.instId != self._data.inst_id:
            return
        self._digests_since.append(ordered.digest or "")
        seq_no = ordered.ppSeqNo
        if seq_no % self._chk_freq == 0:
            self._make_checkpoint(ordered.viewNo, seq_no)

    def _make_checkpoint(self, view_no: int, seq_no_end: int) -> None:
        digest = hashlib.sha256(
            "".join(self._digests_since).encode()).hexdigest()
        self._digests_since.clear()
        cp = Checkpoint(
            instId=self._data.inst_id,
            viewNo=view_no,
            seqNoStart=max(1, seq_no_end - self._chk_freq + 1),
            seqNoEnd=seq_no_end,
            digest=digest,
        )
        self._own_checkpoints[seq_no_end] = cp
        logger.debug("%s checkpoint at %d", self._data.name, seq_no_end)
        if self._vote_plane is not None:
            self._vote_plane.record_checkpoint_vote(
                self._data.name, seq_no_end, self._chk_freq)
            # replay received votes that arrived before our own checkpoint
            # existed (only now can their digests be validated)
            key = (view_no, seq_no_end, cp.digest)
            for sender in self._received.get(key, ()):
                self._vote_plane.record_checkpoint_vote(
                    sender, seq_no_end, self._chk_freq)
        self._network.send(cp)
        self._try_stabilize(view_no, seq_no_end)

    def process_checkpoint(self, cp: Checkpoint, sender: str):
        if getattr(cp, "instId", self._data.inst_id) != self._data.inst_id:
            return DISCARD, "other instance"
        if sender not in self._data.validators:
            return DISCARD, "CHECKPOINT from non-validator"
        if cp.viewNo < self._data.view_no:
            return DISCARD, "old view"
        if cp.seqNoEnd <= self._data.stable_checkpoint:
            return DISCARD, "already stable"
        key: CheckpointKey = (cp.viewNo, cp.seqNoEnd, cp.digest)
        self._received.setdefault(key, set()).add(sender)
        if self._vote_plane is not None:
            own = self._own_checkpoints.get(cp.seqNoEnd)
            if own is not None and own.viewNo == cp.viewNo \
                    and own.digest == cp.digest:
                self._vote_plane.record_checkpoint_vote(
                    sender, cp.seqNoEnd, self._chk_freq)
        self._check_lag(cp.viewNo, cp.seqNoEnd)
        self._try_stabilize(cp.viewNo, cp.seqNoEnd)
        return PROCESS

    def _has_quorum(self, view_no: int, seq_no_end: int, digest: str) -> bool:
        key: CheckpointKey = (view_no, seq_no_end, digest)
        host = self._data.quorums.checkpoint.is_reached(
            len(self._received.get(key, set())))
        if self._vote_plane is None:
            return host
        dev = (view_no == self._data.view_no
               and self._vote_plane.has_checkpoint_quorum(
                   seq_no_end, self._chk_freq))
        if self._shadow_check:
            assert dev == host, (
                "checkpoint quorum divergence", key, dev, host)
        return dev

    def service_quorum_tick(self) -> None:
        """Tick-batched mode: retry stabilizations that failed against the
        previous snapshot (the caller has already synced the vote plane)."""
        if not self._dirty_stabilize:
            return
        pending, self._dirty_stabilize = self._dirty_stabilize, set()
        for view_no, seq_no_end in sorted(pending):
            if seq_no_end > self._data.stable_checkpoint:
                self._try_stabilize(view_no, seq_no_end)

    def _try_stabilize(self, view_no: int, seq_no_end: int) -> None:
        own = self._own_checkpoints.get(seq_no_end)
        if own is None or own.viewNo != view_no:
            return
        if self._tick_mode:
            self._dirty_stabilize.add((view_no, seq_no_end))
        if not self._has_quorum(view_no, seq_no_end, own.digest):
            # byzantine check: quorum formed on a DIFFERENT digest for the
            # same seqNoEnd means we diverged
            for (v, s, d), senders in self._received.items():
                if v == view_no and s == seq_no_end and d != own.digest \
                        and self._data.quorums.checkpoint.is_reached(
                            len(senders)):
                    logger.warning("%s checkpoint digest divergence at %d",
                                   self._data.name, seq_no_end)
                    self._bus.send(NeedMasterCatchup())
            return
        self._mark_stable(view_no, seq_no_end)

    def _mark_stable(self, view_no: int, seq_no_end: int) -> None:
        if seq_no_end <= self._data.stable_checkpoint:
            return
        if self._barrier is not None:
            own = self._own_checkpoints.get(seq_no_end)
            digest = own.digest if own is not None else ""
            admitted = self._barrier.offer(
                self._lane, self._data.name, seq_no_end, digest,
                lambda: self._finish_stable(view_no, seq_no_end))
            if not admitted:
                return  # held: released when the barrier seals the window
        self._finish_stable(view_no, seq_no_end)

    def _finish_stable(self, view_no: int, seq_no_end: int) -> None:
        if seq_no_end <= self._data.stable_checkpoint:
            return
        logger.debug("%s stable checkpoint %d", self._data.name, seq_no_end)
        # GC own/received checkpoint state at or below
        self._own_checkpoints = {
            s: c for s, c in self._own_checkpoints.items() if s > seq_no_end}
        self._received = {
            k: v for k, v in self._received.items() if k[1] > seq_no_end}
        self._bus.send(CheckpointStabilized(
            inst_id=self._data.inst_id,
            last_stable_3pc=(view_no, seq_no_end)))
        if self._vote_plane is not None:
            # the bus dispatch above slid the plane's window (zeroing all
            # checkpoint columns); re-scatter the surviving votes for
            # boundaries above the new stable point
            for seq, own in self._own_checkpoints.items():
                if own.viewNo != self._data.view_no:
                    continue
                self._vote_plane.record_checkpoint_vote(
                    self._data.name, seq, self._chk_freq)
                key = (own.viewNo, seq, own.digest)
                for sender in self._received.get(key, ()):
                    self._vote_plane.record_checkpoint_vote(
                        sender, seq, self._chk_freq)

    def _check_lag(self, view_no: int, seq_no_end: int) -> None:
        """f+1 distinct nodes checkpointing beyond our H => we are behind."""
        if seq_no_end <= self._data.high_watermark:
            return
        voters = set()
        for (v, s, _), senders in self._received.items():
            if s > self._data.high_watermark:
                voters |= senders
        if self._data.quorums.weak.is_reached(len(voters)):
            logger.info("%s lagging (checkpoints beyond H=%d) -> catchup",
                        self._data.name, self._data.high_watermark)
            self._bus.send(NeedMasterCatchup())

    def process_view_change_started(self, msg: ViewChangeStarted) -> None:
        # checkpoints from the old view are void (digest chain broken),
        # except the stable one which is carried by the VIEW_CHANGE msgs
        self._digests_since.clear()

    def process_catchup_finished(self, msg: CatchupFinished) -> None:
        """Catchup moved the stable floor (set by the leecher on shared
        data); the digest chain below it is void, votes at/below it are
        stale."""
        _, pp_seq_no = msg.last_caught_up_3pc
        self._digests_since.clear()
        self._own_checkpoints = {
            s: c for s, c in self._own_checkpoints.items() if s > pp_seq_no}
        self._received = {
            k: v for k, v in self._received.items() if k[1] > pp_seq_no}
        if self._barrier is not None:
            # the leeched state is pool-verified up to pp_seq_no: the
            # lane is vacuously ready for every window it covers (the
            # seeders' stabilizations already passed the barrier)
            self._barrier.lane_caught_up(self._lane, pp_seq_no)

    # --- introspection -------------------------------------------------

    def own_checkpoint_values(self) -> list:
        """[(view_no, seqNoEnd, digest)] incl. the stable floor, for
        VIEW_CHANGE messages."""
        out = [(c.viewNo, c.seqNoEnd, c.digest)
               for c in self._own_checkpoints.values()]
        out.append((self._data.view_no, self._data.stable_checkpoint, "stable"))
        return sorted(out, key=lambda t: t[1])
