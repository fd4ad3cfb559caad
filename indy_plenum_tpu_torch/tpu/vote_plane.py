"""Host adapter making the device quorum tensors the consensus truth source.

Port of the unsharded, per-tick part of ``indy_plenum_tpu/tpu/vote_plane.py``
(reference analog: the prepare/commit cert collection of
``plenum/server/consensus/ordering_service.py``). Validated votes are
buffered on the host as packed uint32 words, scattered into the dense
(member x validator x slot) tensors of :mod:`.quorum` in padded batches,
and quorum verdicts come back as compact deltas.

- :class:`DeviceVotePlane`: one plane, flushed on query.
- :class:`VotePlaneGroup`: M stacked planes (nodes x instances) stepped in
  ONE fused CUDA launch per dispatch; every member holds a
  :class:`_MemberPlane` view. Sync and pipelined flush, device eval
  (compact readback, the default) and ``host_eval`` (full event-matrix
  readback), with the overflow fallback of the reference.

Transfer contract (the reference's XLA async dispatch and
``copy_to_host_async``, ``vote_plane.py:1311-1322``):

- all work of a group runs on ONE CUDA stream, the device's current one;
- scatter words are staged in pinned host buffers, one per ladder rung,
  and cross with ``non_blocking`` copies; a reused pinned buffer is
  rewritten only after the CUDA event recorded behind its last copy has
  completed (the hazard of ``vote_plane.py:724-734``);
- each dispatched step's readback arrays are copied device->host
  ``non_blocking`` into pinned buffers right after the dispatch, with one
  CUDA event per in-flight step, waited on before the absorb reads them;
  there is no fallback when a copy cannot be issued - it raises.

Pipelined mode keeps the reference's one-tick verdict lag; dtypes and
byte counts equal JAX's (int32 slot lists and counts, uint8 ``stable``,
bool events), so ``readback_bytes_total`` counts the same bytes. A mesh
and multi-tick residency (``resident_depth > 1``) come with later slices
of the port and raise ``NotImplementedError`` here.
"""
from __future__ import annotations

from collections import deque
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..common.metrics_collector import MetricsCollector, MetricsName
from ..observability.trace import NULL_TRACE, _NO_SPAN
from ..utils.torch_env import DeviceLike, resolve_device
from . import quorum as q
from .compile_plan import plan_for

# fixed flush granularity
FLUSH_BATCH = 128
# padded-shape ladder: a flush pads to the smallest rung that fits, so a
# single-vote tick costs a 16-wide scatter, not a 128-wide one
FLUSH_LADDER = (16, FLUSH_BATCH)


def ladder_shape(n_votes: int) -> int:
    """Smallest ladder rung holding ``n_votes``."""
    for rung in FLUSH_LADDER:
        if n_votes <= rung:
            return rung
    return FLUSH_BATCH


def pow2_rung(n_votes: int) -> int:
    """Smallest power-of-two rung >= ``n_votes``, clamped to the static
    ladder's bounds [FLUSH_LADDER[0], FLUSH_BATCH]."""
    rung = FLUSH_LADDER[0]
    while rung < min(n_votes, FLUSH_BATCH):
        rung *= 2
    return rung


class AdaptiveLadder:
    """Learned per-pool top flush rung: the p99 of the observed busiest-
    member votes per dispatch, rounded up to a power of two and clamped
    to the static ladder's bounds. Deterministic (integer percentile math
    over a bounded window); learning starts after ``min_samples``."""

    def __init__(self, window: int = 512, min_samples: int = 64,
                 recompute_every: int = 32):
        self._samples: "deque[int]" = deque(maxlen=window)
        self._min_samples = min_samples
        self._recompute_every = recompute_every
        self._count = 0
        self.top = FLUSH_BATCH

    def record(self, busiest_votes: int) -> None:
        self._samples.append(busiest_votes)
        self._count += 1
        if (self._count >= self._min_samples
                and (self._count - self._min_samples)
                % self._recompute_every == 0):
            ordered = sorted(self._samples)
            idx = (99 * (len(ordered) - 1) + 99) // 100
            self.top = pow2_rung(ordered[idx])

    def shape(self, n_votes: int) -> int:
        if n_votes <= FLUSH_LADDER[0]:
            return FLUSH_LADDER[0]
        if n_votes <= self.top:
            return self.top
        return pow2_rung(n_votes)


class PlaneDeltas(NamedTuple):
    """One member's accumulated device-eval deltas since the last poll:
    ascending h-relative slots whose prepare / commit certificates newly
    completed, plus the member's in-order ordering frontier."""

    prepared: List[int]
    committed: List[int]
    frontier: int


# --- host <-> device transfers ----------------------------------------------


class _PinnedPool:
    """Free lists of pinned host buffers by (shape, dtype)."""

    def __init__(self):
        self._free: dict = {}

    def take(self, like: torch.Tensor) -> torch.Tensor:
        key = (tuple(like.shape), like.dtype)
        free = self._free.get(key)
        if free:
            return free.pop()
        return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)

    def give(self, buf: torch.Tensor) -> None:
        self._free.setdefault((tuple(buf.shape), buf.dtype), []).append(buf)


class _Fetch:
    """Device->host copies of one step's readback arrays: issued
    ``non_blocking`` on the current stream at dispatch, completed by one
    CUDA event that :meth:`result` waits on. On the CPU the arrays are
    already host-side."""

    def __init__(self, tensors, pool: _PinnedPool):
        self._pool = pool
        self._event = None
        if tensors[0].device.type == "cuda":
            self._host = [pool.take(t) for t in tensors]
            for buf, t in zip(self._host, tensors):
                buf.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(tensors[0].device))
        else:
            self._host = list(tensors)

    def result(self) -> List[np.ndarray]:
        if self._event is not None:
            self._event.synchronize()
        # copy out: the pinned buffers go back to the pool for reuse
        out = [buf.numpy().copy() for buf in self._host]
        if self._event is not None:
            for buf in self._host:
                self._pool.give(buf)
        self._host = []
        return out


class _Staging:
    """One ladder rung's scatter staging: a pinned (M, width) host buffer
    and its device twin. The host buffer is rewritten only after the
    event behind its last H2D copy has completed."""

    def __init__(self, rows: int, width: int, device: torch.device):
        self._cuda = device.type == "cuda"
        self.host = torch.zeros((rows, width), dtype=torch.int32,
                                pin_memory=self._cuda)
        self._view = self.host.numpy().view(np.uint32)
        self._dev = (torch.empty((rows, width), dtype=torch.int32,
                                 device=device) if self._cuda else None)
        self._copied = torch.cuda.Event() if self._cuda else None
        self._pending_copy = False

    def stage(self, chunks) -> torch.Tensor:
        if self._pending_copy:
            self._copied.synchronize()
            self._pending_copy = False
        view = self._view
        view[...] = 0
        for i, entries in enumerate(chunks):
            if entries:
                q.fill_words_row(view[i], entries)
        if not self._cuda:
            # the plain step consumes the words before this returns
            return self.host
        self._dev.copy_(self.host, non_blocking=True)
        self._copied.record(torch.cuda.current_stream(self._dev.device))
        self._pending_copy = True
        return self._dev


def _host_words(packed, width: int, device: torch.device) -> torch.Tensor:
    """One padded (1, width) word row on ``device`` (standalone plane)."""
    return q.words_tensor(q.words_row(packed, width)[None, :], device)


# --- the standalone plane ----------------------------------------------------


class DeviceVotePlane:
    """Per-instance device vote tensors + lazy flush/query interface.

    ``host_eval`` False (default) runs the fused compact step and folds
    each flush's deltas into host mirrors, feeding ``poll_deltas``; True
    reads back the full event arrays (differential-testing fallback).
    Runs on the card unless ``device="cpu"``."""

    def __init__(self, validators: List[str], log_size: int,
                 n_checkpoints: int = 4, h: int = 0,
                 host_eval: bool = False,
                 delta_cap: Optional[int] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self._validators = list(validators)
        self._index = {name: i for i, name in enumerate(self._validators)}
        self._n = len(self._validators)
        self._log_size = log_size
        self._n_chk = n_checkpoints
        self._h = h
        self.host_eval = host_eval
        self._delta_cap = int(delta_cap) if delta_cap else q.ORDER_DELTA_CAP
        self._state = q.init_state(self._n, log_size, n_checkpoints, 1,
                                   self.device)
        self._pending: List[int] = []  # uint32 vote words (q.pack_vote)
        self._events: Optional[q.QuorumEvents] = None
        self._host_prepared: Optional[np.ndarray] = None
        self._host_prepare_counts: Optional[np.ndarray] = None
        self._host_commit_counts: Optional[np.ndarray] = None
        self._host_commit_ok: Optional[np.ndarray] = None
        self._host_stable: Optional[np.ndarray] = None
        self._mir_prepared = np.zeros(log_size, bool)
        self._mir_commit_ok = np.zeros(log_size, bool)
        self._mir_stable = np.zeros(n_checkpoints, bool)
        self._mir_frontier = 0
        self._delta_prepared: List[int] = []
        self._delta_committed: List[int] = []
        self.flushes = 0
        self.readback_bytes_total = 0
        self.readbacks = 0
        self.flush_votes_total = 0
        self.flush_capacity_total = 0
        self.defer_flush_on_query = False

    # --- recording ------------------------------------------------------

    @property
    def h(self) -> int:
        return self._h

    @property
    def has_buffered_votes(self) -> bool:
        return bool(self._pending)

    def _slot(self, pp_seq_no: int) -> Optional[int]:
        slot = pp_seq_no - self._h - 1
        if 0 <= slot < self._log_size:
            return slot
        return None

    def _record(self, kind: int, sender: Optional[str],
                pp_seq_no: int) -> None:
        slot = self._slot(pp_seq_no)
        if slot is None:
            return
        idx = 0 if sender is None else self._index.get(sender)
        if idx is None:
            return
        self._pending.append(q.vote_word(kind, idx, slot))
        self._events = None

    def record_preprepare(self, pp_seq_no: int) -> None:
        self._record(q.PREPREPARE, None, pp_seq_no)

    def record_prepare(self, sender: str, pp_seq_no: int) -> None:
        self._record(q.PREPARE, sender, pp_seq_no)

    def record_commit(self, sender: str, pp_seq_no: int) -> None:
        self._record(q.COMMIT, sender, pp_seq_no)

    def record_checkpoint(self, sender: str, chk_slot: int) -> None:
        if 0 <= chk_slot < self._n_chk and sender in self._index:
            self._pending.append(
                q.vote_word(q.CHECKPOINT, self._index[sender], chk_slot))
            self._events = None

    def checkpoint_slot(self, seq_no_end: int, chk_freq: int) -> Optional[int]:
        """Checkpoint boundary seqNoEnd -> window-relative checkpoint slot."""
        delta = seq_no_end - self._h
        if delta <= 0 or delta % chk_freq != 0:
            return None
        slot = delta // chk_freq - 1
        return slot if slot < self._n_chk else None

    def record_checkpoint_vote(self, sender: str, seq_no_end: int,
                               chk_freq: int) -> None:
        slot = self.checkpoint_slot(seq_no_end, chk_freq)
        if slot is not None:
            self.record_checkpoint(sender, slot)

    def has_checkpoint_quorum(self, seq_no_end: int, chk_freq: int) -> bool:
        slot = self.checkpoint_slot(seq_no_end, chk_freq)
        if slot is None:
            return False
        self.events()
        return bool(self._host_stable[slot])

    # --- window management ---------------------------------------------

    def slide_to(self, new_h: int) -> None:
        """Checkpoint stabilized at ``new_h``: drop slots <= new_h."""
        if new_h <= self._h:
            return
        self._flush()
        delta = new_h - self._h
        q.slide_state(self._state, torch.tensor([delta], dtype=torch.int32))
        self._h = new_h
        self._events = None
        self._host_prepared = None
        self._roll_mirrors(delta)

    def _roll_mirrors(self, delta: int) -> None:
        s = self._log_size
        for mir in (self._mir_prepared, self._mir_commit_ok):
            if delta < s:
                mir[:s - delta] = mir[delta:]
                mir[s - delta:] = False
            else:
                mir[:] = False
        self._mir_stable[:] = False
        self._mir_frontier = max(self._mir_frontier - delta, 0)
        self._delta_prepared = [
            x - delta for x in self._delta_prepared if x >= delta]
        self._delta_committed = [
            x - delta for x in self._delta_committed if x >= delta]

    def _zero_mirrors(self) -> None:
        self._mir_prepared[:] = False
        self._mir_commit_ok[:] = False
        self._mir_stable[:] = False
        self._mir_frontier = 0
        self._delta_prepared = []
        self._delta_committed = []

    def reset(self, h: Optional[int] = None) -> None:
        """View change: clear all votes (they were for the old view)."""
        if h is not None:
            self._h = h
        self._state = q.init_state(self._n, self._log_size, self._n_chk, 1,
                                   self.device)
        self._pending.clear()
        self._events = None
        self._host_prepared = None
        self._zero_mirrors()

    # --- flush + queries ------------------------------------------------

    def _step_chunk(self, words: torch.Tensor) -> None:
        if self.host_eval:
            self._events = q.step(self._state, words, self._n)
            return
        self._events, compact = q.step_compact(
            self._state, words, self._n, self._delta_cap)
        self._apply_compact_single(compact)

    def _apply_compact_single(self, compact: q.CompactEvents) -> None:
        host = q.CompactEvents(*[t.cpu().numpy() for t in compact])
        bytes_n = sum(a.nbytes for a in host)
        s = self._log_size
        if int(host.n_prepared[0]) > self._delta_cap:
            full = self._events.prepared[0].cpu().numpy()
            bytes_n += full.nbytes
            new_p = np.nonzero(full & ~self._mir_prepared)[0]
        else:
            row = host.new_prepared[0]
            new_p = row[row < s]
        if int(host.n_committed[0]) > self._delta_cap:
            full = self._events.ordered[0].cpu().numpy()
            bytes_n += full.nbytes
            new_c = np.nonzero(full & ~self._mir_commit_ok)[0]
        else:
            row = host.new_committed[0]
            new_c = row[row < s]
        if new_p.size:
            self._mir_prepared[new_p] = True
            self._delta_prepared.extend(int(x) for x in new_p)
        if new_c.size:
            self._mir_commit_ok[new_c] = True
            self._delta_committed.extend(int(x) for x in new_c)
        np.copyto(self._mir_stable, host.stable[0].astype(bool))
        self._mir_frontier = int(host.frontier[0])
        self.readback_bytes_total += bytes_n

    def _flush(self) -> None:
        while self._pending:
            chunk, self._pending = (self._pending[:FLUSH_BATCH],
                                    self._pending[FLUSH_BATCH:])
            shape = ladder_shape(len(chunk))
            self._step_chunk(_host_words(chunk, shape, self.device))
            self.flushes += 1
            self.flush_votes_total += len(chunk)
            self.flush_capacity_total += shape

    def _refresh(self) -> None:
        self._flush()
        if self._events is None:  # nothing ever recorded
            self._step_chunk(_host_words([], FLUSH_LADDER[0], self.device))
            self.flushes += 1
            self.flush_capacity_total += FLUSH_LADDER[0]
        if not self.host_eval:
            self._host_prepared = self._mir_prepared
            self._host_commit_ok = self._mir_commit_ok
            self._host_stable = self._mir_stable
            self._host_prepare_counts = None
            self._host_commit_counts = None
            self.readbacks += 1
            return
        ev = self._events
        (self._host_prepared, self._host_prepare_counts,
         self._host_commit_counts, self._host_stable) = [
            t[0].cpu().numpy() for t in (
                ev.prepared, ev.prepare_counts, ev.commit_counts,
                ev.stable_checkpoints)]
        self._host_commit_ok = (
            self._host_commit_counts >= self._n - (self._n - 1) // 3)
        self.readback_bytes_total += sum(
            a.nbytes for a in (self._host_prepared,
                               self._host_prepare_counts,
                               self._host_commit_counts, self._host_stable))
        self.readbacks += 1

    def sync(self) -> None:
        """Flush all buffered votes and refresh the host snapshot."""
        self._refresh()

    def events(self):
        if self._host_prepared is None or (
                not self.defer_flush_on_query
                and (self._pending or self._events is None)):
            self._refresh()
        return self._events

    def has_prepare_quorum(self, pp_seq_no: int) -> bool:
        """PRE-PREPARE seen AND n-f-1 matching PREPAREs (device verdict)."""
        slot = self._slot(pp_seq_no)
        if slot is None:
            return False
        self.events()
        return bool(self._host_prepared[slot])

    def has_commit_quorum(self, pp_seq_no: int) -> bool:
        slot = self._slot(pp_seq_no)
        if slot is None:
            return False
        self.events()
        return bool(self._host_commit_ok[slot])

    @property
    def delta_feed(self) -> bool:
        return not self.host_eval

    @property
    def lagging(self) -> bool:
        return False

    def poll_deltas(self) -> Optional[PlaneDeltas]:
        """Drain the accumulated device-eval deltas + the current frontier
        (None in host_eval mode and on quiet polls)."""
        if self.host_eval:
            return None
        if not self._delta_prepared and not self._delta_committed:
            return None
        prepared, self._delta_prepared = self._delta_prepared, []
        committed, self._delta_committed = self._delta_committed, []
        return PlaneDeltas(sorted(prepared), sorted(committed),
                           int(self._mir_frontier))

    def prepare_count(self, pp_seq_no: int) -> int:
        slot = self._slot(pp_seq_no)
        if slot is None:
            return 0
        self.events()
        if self._host_prepare_counts is not None:
            return int(self._host_prepare_counts[slot])
        if self._events is None:
            return 0
        return int(self._events.prepare_counts[0, slot].item())


# --- the group -----------------------------------------------------------------


class VotePlaneGroup:
    """M stacked vote planes stepped in ONE fused device launch.

    Every simulated node holds a :class:`_MemberPlane` view onto a shared
    (M, ...) tensor stack; when any member queries quorum state, ALL
    members' buffered votes ride a single (M, flush_batch) scatter.
    ``pipelined`` overlaps each flush's device round-trip with the next
    tick's host work (verdicts lag one tick). ``host_eval`` reads back
    the full event matrix instead of the compact deltas. Runs on the card
    unless ``device="cpu"``."""

    def __init__(self, n_members: int, validators: List[str], log_size: int,
                 n_checkpoints: int = 4, h: int = 0, metrics=None,
                 mesh=None, pipelined: bool = False,
                 adaptive_ladder: bool = False,
                 host_eval: bool = False,
                 delta_cap: Optional[int] = None,
                 resident_depth: int = 1,
                 device: DeviceLike = None):
        if mesh is not None:
            raise NotImplementedError(
                "mesh-sharded vote planes come with the mesh slice of the "
                "port")
        if int(resident_depth) > 1:
            raise NotImplementedError(
                "multi-tick device residency (resident_depth > 1) comes "
                "with the residency slice of the port")
        self.device = resolve_device(device)
        self._n = len(validators)
        self._log_size = log_size
        self._n_chk = n_checkpoints
        self.host_eval = host_eval
        self._delta_cap = int(delta_cap) if delta_cap else q.ORDER_DELTA_CAP
        self._plan = plan_for(None, self._n, self._n, self._delta_cap)
        self._states = q.init_state(self._n, log_size, n_checkpoints,
                                    n_members, self.device)
        self._members = [
            _MemberPlane(self, i, validators, log_size, n_checkpoints, h)
            for i in range(n_members)]
        self.version = 0  # bumped on every device-state change
        # host snapshot; `_host_prepared is None` means "void" (cold start
        # / post-slide / post-reset) in both eval modes
        self._host_prepared: Optional[np.ndarray] = None
        self._host_prepare_counts: Optional[np.ndarray] = None
        self._host_commit_counts: Optional[np.ndarray] = None
        self._host_commit_ok: Optional[np.ndarray] = None
        self._host_stable: Optional[np.ndarray] = None
        # device-eval mirrors kept current by folding compact deltas in
        self._mir_prepared = np.zeros((n_members, log_size), bool)
        self._mir_commit_ok = np.zeros((n_members, log_size), bool)
        self._mir_stable = np.zeros((n_members, n_checkpoints), bool)
        self._mir_frontier = np.zeros(n_members, np.int64)
        # last absorbed step's device-resident full events (overflow
        # fallback + on-demand diagnostics)
        self._dev_events: Optional[q.QuorumEvents] = None
        self.readback_bytes_total = 0
        self.readbacks = 0
        self.readbacks_overlapped = 0
        self._flush_seq = 0
        self.flushes = 0
        self.flush_votes_total = 0
        self.flush_capacity_total = 0
        # the governor's per-shard occupancy series; an unsharded group is
        # one shard holding every member row
        self.flush_votes_per_shard = [0]
        self.flush_capacity_per_shard = [0]
        # one flush chunk holds a full 3PC wave (~2N votes per member),
        # pow2, never below the static FLUSH_BATCH
        self.flush_batch = FLUSH_BATCH
        while self.flush_batch < 2 * self._n and self.flush_batch < 4096:
            self.flush_batch *= 2
        self._scatter_bufs: dict = {}  # rung width -> _Staging
        self._pinned = _PinnedPool()
        self._ladder = AdaptiveLadder() if adaptive_ladder else None
        self.metrics = metrics if metrics is not None else MetricsCollector()
        self.trace = NULL_TRACE
        self.pipelined = pipelined
        # in-flight steps of the last flush: [(events, compact, fetch)]
        self._inflight: Optional[list] = None
        self._inflight_seq = 0

    def view(self, member_idx: int) -> "DeviceVotePlane":
        return self._members[member_idx]

    @property
    def lagging(self) -> bool:
        """True while a dispatched step's events are not yet in the host
        snapshot (pipelined mode)."""
        return self._inflight is not None

    # --- dispatch -------------------------------------------------------

    def _stage_scatter(self, chunks: List[List[int]], shape: int
                       ) -> torch.Tensor:
        buf = self._scatter_bufs.get(shape)
        if buf is None:
            buf = self._scatter_bufs[shape] = _Staging(
                len(self._members), shape, self.device)
        return buf.stage(chunks)

    def _collect_chunks(self):
        chunks = []
        votes = 0
        for m in self._members:
            take, m._pending = (m._pending[:self.flush_batch],
                                m._pending[self.flush_batch:])
            chunks.append(take)
            votes += len(take)
        return chunks, votes

    def _dispatch_pending(self) -> list:
        """Chunk + scatter every member's pending votes; returns the
        chained (events, compact) step results (empty if nothing was
        pending)."""
        results = []
        while any(m._pending for m in self._members):
            chunks, votes = self._collect_chunks()
            busiest = max(len(c) for c in chunks)
            if self._ladder is not None:
                self._ladder.record(busiest)
                shape = self._ladder.shape(busiest)
            else:
                shape = ladder_shape(busiest)
            if busiest > FLUSH_BATCH:
                shape = FLUSH_BATCH
                while shape < busiest:
                    shape *= 2
            args = ({"votes": votes, "shape": shape}
                    if self.trace.enabled else None)
            with self.trace.span("flush.dispatch", args=args) \
                    if self.trace.enabled else _NO_SPAN:
                words = self._stage_scatter(chunks, shape)
                self._states, events, compact = self._plan.step(
                    self._states, words)
            results.append((events, compact))
            self.flushes += 1
            capacity = len(self._members) * shape
            self.flush_votes_total += votes
            self.flush_capacity_total += capacity
            self.flush_votes_per_shard[0] += votes
            self.flush_capacity_per_shard[0] += capacity
            self.metrics.add_event(MetricsName.DEVICE_FLUSH)
            self.metrics.add_event(MetricsName.DEVICE_FLUSH_VOTES, votes)
            self.metrics.add_event(
                MetricsName.DEVICE_FLUSH_OCCUPANCY, votes / capacity)
        return results

    def _dispatch_empty(self) -> list:
        """One padded no-vote step (cold start needs SOME events)."""
        words = self._stage_scatter(
            [[] for _ in self._members], FLUSH_LADDER[0])
        self._states, events, compact = self._plan.step(self._states, words)
        self.flushes += 1
        self.flush_capacity_total += len(self._members) * FLUSH_LADDER[0]
        self.flush_capacity_per_shard[0] += (len(self._members)
                                             * FLUSH_LADDER[0])
        self.metrics.add_event(MetricsName.DEVICE_FLUSH)
        return [(events, compact)]

    def _start_readbacks(self, results: list) -> list:
        """Issue the non-blocking device->host copies an absorb of these
        steps will read: the full event arrays of the LAST step in host
        eval (they are cumulative), every step's compact record in device
        eval."""
        out = []
        last = len(results) - 1
        for i, (events, compact) in enumerate(results):
            fetch = None
            if not self.host_eval:
                fetch = _Fetch(list(compact), self._pinned)
            elif i == last:
                fetch = _Fetch([events.prepared, events.prepare_counts,
                                events.commit_counts,
                                events.stable_checkpoints], self._pinned)
            out.append((events, compact, fetch))
        return out

    # --- absorb -------------------------------------------------------

    def _absorb_results(self, results: list, overlapped: bool) -> None:
        """Fold one flush's chained steps into the host snapshot."""
        trace_on = self.trace.enabled
        args = {"bytes": 0, "overlapped": overlapped} if trace_on else None
        with self.trace.span("flush.readback", args=args) \
                if trace_on else _NO_SPAN:
            if self.host_eval:
                (self._host_prepared, self._host_prepare_counts,
                 self._host_commit_counts,
                 self._host_stable) = results[-1][2].result()
                self._host_commit_ok = (
                    self._host_commit_counts
                    >= self._n - (self._n - 1) // 3)
                bytes_n = sum(a.nbytes for a in (
                    self._host_prepared, self._host_prepare_counts,
                    self._host_commit_counts, self._host_stable))
            else:
                bytes_n = 0
                for events, _, fetch in results:
                    bytes_n += self._apply_compact(
                        events, q.CompactEvents(*fetch.result()))
                self._host_prepared = self._mir_prepared
                self._host_commit_ok = self._mir_commit_ok
                self._host_stable = self._mir_stable
                self._host_prepare_counts = None
                self._host_commit_counts = None
            if args is not None:
                args["bytes"] = bytes_n
        self.readback_bytes_total += bytes_n
        self.readbacks += 1
        if overlapped:
            self.readbacks_overlapped += 1
        self.metrics.add_event(MetricsName.DEVICE_READBACK_BYTES, bytes_n)
        self._dev_events = results[-1][0]
        self.metrics.add_event(MetricsName.DEVICE_READBACK_COMPACT,
                               0 if self.host_eval else 1)
        self.version += 1

    def _apply_compact(self, events: q.QuorumEvents,
                       host: q.CompactEvents) -> int:
        """Fold one step's compact deltas into the mirrors + per-member
        delta accumulators; returns the bytes that crossed the link. A
        member whose true delta count exceeds the cap triggers one
        full-events fetch for this step (diffed against its mirror)."""
        bytes_n = sum(a.nbytes for a in host)
        s = self._log_size
        cap = self._delta_cap
        over_p = host.n_prepared > cap
        over_c = host.n_committed > cap
        full_prep = full_ord = None
        if over_p.any() or over_c.any():
            full_prep = events.prepared.cpu().numpy()
            full_ord = events.ordered.cpu().numpy()
            bytes_n += full_prep.nbytes + full_ord.nbytes
        touched = np.nonzero(
            (host.new_prepared[:, 0] < s) | (host.new_committed[:, 0] < s)
            | over_p | over_c)[0]
        for mi in touched:
            member = self._members[mi]
            if over_p[mi]:
                new = np.nonzero(full_prep[mi] & ~self._mir_prepared[mi])[0]
            else:
                row = host.new_prepared[mi]
                new = row[row < s]
            if new.size:
                self._mir_prepared[mi, new] = True
                member._delta_prepared.extend(int(x) for x in new)
            if over_c[mi]:
                new = np.nonzero(full_ord[mi] & ~self._mir_commit_ok[mi])[0]
            else:
                row = host.new_committed[mi]
                new = row[row < s]
            if new.size:
                self._mir_commit_ok[mi, new] = True
                member._delta_committed.extend(int(x) for x in new)
        self._mir_stable[:] = host.stable.astype(bool)
        self._mir_frontier[:] = host.frontier
        return bytes_n

    # --- flush --------------------------------------------------------

    def _flush_pipelined(self) -> None:
        # 1. absorb the steps dispatched LAST tick (their copies have had
        # a whole tick of host work to land)
        if self._inflight is not None:
            results, self._inflight = self._inflight, None
            self._absorb_results(
                results, overlapped=self._flush_seq > self._inflight_seq)
        # 2. dispatch this tick's votes and start their readback copies;
        # the absorb happens next tick
        results = self._dispatch_pending()
        if results:
            self._inflight = self._start_readbacks(results)
            self._inflight_seq = self._flush_seq
        if self._host_prepared is None:
            # cold start (or post-slide/reset): callers need SOME snapshot
            if self._inflight is None:
                self._inflight = self._start_readbacks(
                    self._dispatch_empty())
                self._inflight_seq = self._flush_seq
            self._sync_inflight()

    def flush(self) -> None:
        """Scatter every member's pending votes; refresh host event caches."""
        self._flush_seq += 1
        if self.pipelined:
            with self.metrics.measure_time(MetricsName.DEVICE_FLUSH_TIME):
                self._flush_pipelined()
            return
        if (not any(m._pending for m in self._members)
                and self._host_prepared is not None):
            return
        with self.metrics.measure_time(MetricsName.DEVICE_FLUSH_TIME):
            results = self._dispatch_pending()
            if not results:  # cold start: no votes recorded anywhere yet
                results = self._dispatch_empty()
            self._absorb_results(self._start_readbacks(results),
                                 overlapped=False)

    def _sync_inflight(self) -> None:
        """Absorb any in-flight steps NOW (window/view operations must not
        run with stale events pending under the OLD slot mapping)."""
        if self._inflight is not None:
            results, self._inflight = self._inflight, None
            self._absorb_results(
                results, overlapped=self._flush_seq > self._inflight_seq)

    # --- window management --------------------------------------------

    def _roll_member_mirrors(self, member_idx: int, delta: int) -> None:
        mi, s = member_idx, self._log_size
        for mir in (self._mir_prepared[mi], self._mir_commit_ok[mi]):
            if delta < s:
                mir[:s - delta] = mir[delta:]
                mir[s - delta:] = False
            else:
                mir[:] = False
        self._mir_stable[mi] = False
        self._mir_frontier[mi] = max(int(self._mir_frontier[mi]) - delta, 0)
        member = self._members[mi]
        member._delta_prepared = [
            x - delta for x in member._delta_prepared if x >= delta]
        member._delta_committed = [
            x - delta for x in member._delta_committed if x >= delta]

    def slide_member(self, member_idx: int, delta: int) -> None:
        self.flush()
        self._sync_inflight()
        deltas = torch.zeros(len(self._members), dtype=torch.int32)
        deltas[member_idx] = delta
        self._states = self._plan.slide(self._states, deltas)
        self.version += 1
        self._host_prepared = None
        self._roll_member_mirrors(member_idx, delta)

    def reset_member(self, member_idx: int) -> None:
        # pending for this member was cleared by the caller; other
        # members' buffered votes are untouched
        self._sync_inflight()
        mask = torch.zeros(len(self._members), dtype=torch.bool)
        mask[member_idx] = True
        self._states = self._plan.zero(self._states, mask)
        self.version += 1
        self._host_prepared = None
        self._mir_prepared[member_idx] = False
        self._mir_commit_ok[member_idx] = False
        self._mir_stable[member_idx] = False
        self._mir_frontier[member_idx] = 0
        member = self._members[member_idx]
        member._delta_prepared = []
        member._delta_committed = []


class _MemberPlane(DeviceVotePlane):
    """One member's view of a :class:`VotePlaneGroup` (same interface as a
    standalone :class:`DeviceVotePlane`; storage and flushing are shared)."""

    def __init__(self, group: VotePlaneGroup, member_idx: int,
                 validators: List[str], log_size: int, n_checkpoints: int,
                 h: int):
        self._group = group
        self._mi = member_idx
        self.device = group.device
        self._validators = list(validators)
        self._index = {name: i for i, name in enumerate(self._validators)}
        self._n = len(self._validators)
        self._log_size = log_size
        self._n_chk = n_checkpoints
        self._h = h
        self._pending: List[int] = []
        self._events = None
        self._seen_version = -1
        self._host_prepared = None
        self._host_prepare_counts = None
        self._host_commit_counts = None
        self._host_commit_ok = None
        self._host_stable = None
        self._delta_prepared: List[int] = []
        self._delta_committed: List[int] = []
        self.defer_flush_on_query = False

    # counters live on the group (shared dispatches); read-only views

    @property
    def flushes(self) -> int:
        return self._group.flushes

    @property
    def flush_votes_total(self) -> int:
        return self._group.flush_votes_total

    @property
    def flush_capacity_total(self) -> int:
        return self._group.flush_capacity_total

    @property
    def readback_bytes_total(self) -> int:
        return self._group.readback_bytes_total

    @property
    def readbacks(self) -> int:
        return self._group.readbacks

    @property
    def has_buffered_votes(self) -> bool:
        # votes dispatched but not yet in the snapshot keep the services'
        # lost-wakeup guard armed, like host-buffered votes
        return bool(self._pending) or self._group.lagging

    def _flush(self) -> None:
        self._group.flush()

    def _copy_slices(self) -> None:
        g = self._group
        self._host_prepared = g._host_prepared[self._mi]
        self._host_commit_ok = g._host_commit_ok[self._mi]
        self._host_stable = g._host_stable[self._mi]
        pc, cc = g._host_prepare_counts, g._host_commit_counts
        self._host_prepare_counts = None if pc is None else pc[self._mi]
        self._host_commit_counts = None if cc is None else cc[self._mi]
        self._seen_version = g.version
        self._events = True

    def _refresh(self) -> None:
        self._group.flush()
        if not self.defer_flush_on_query:
            # per-query mode wants CURRENT state: a pipelined group must
            # absorb its in-flight step now
            self._group._sync_inflight()
        self._copy_slices()

    def events(self):
        if (self._group._host_prepared is None
                or (not self.defer_flush_on_query
                    and (self._pending or self._events is None))):
            self._refresh()
        elif self._seen_version != self._group.version:
            self._copy_slices()
        return self._events

    def slide_to(self, new_h: int) -> None:
        if new_h <= self._h:
            return
        self._group.slide_member(self._mi, new_h - self._h)
        self._h = new_h
        self._events = None

    def reset(self, h: Optional[int] = None) -> None:
        if h is not None:
            self._h = h
        self._pending.clear()
        self._group.reset_member(self._mi)
        self._events = None

    @property
    def host_eval(self) -> bool:
        return self._group.host_eval

    @host_eval.setter
    def host_eval(self, value) -> None:  # eval mode is a GROUP property
        raise AttributeError("set host_eval on the VotePlaneGroup")

    def poll_deltas(self) -> Optional[PlaneDeltas]:
        g = self._group
        if g.host_eval:
            return None
        if not self._delta_prepared and not self._delta_committed:
            return None
        prepared, self._delta_prepared = self._delta_prepared, []
        committed, self._delta_committed = self._delta_committed, []
        return PlaneDeltas(sorted(prepared), sorted(committed),
                           int(g._mir_frontier[self._mi]))

    def prepare_count(self, pp_seq_no: int) -> int:
        slot = self._slot(pp_seq_no)
        if slot is None:
            return 0
        self.events()
        if self._host_prepare_counts is not None:
            return int(self._host_prepare_counts[slot])
        ev = self._group._dev_events
        if ev is None:
            return 0
        return int(ev.prepare_counts[self._mi, slot].item())
