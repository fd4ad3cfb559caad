"""Host adapter making the device quorum tensors the consensus truth source.

Port of ``indy_plenum_tpu/tpu/vote_plane.py`` (reference analog: the
prepare/commit cert collection of
``plenum/server/consensus/ordering_service.py``). Validated votes are
buffered on the host as packed uint32 words, scattered into the dense
(member x validator x slot) tensors of :mod:`.quorum` in padded batches,
and quorum verdicts come back as compact deltas.

- :class:`DeviceVotePlane`: one plane, flushed on query.
- :class:`VotePlaneGroup`: M stacked planes (nodes x instances) stepped in
  ONE fused CUDA launch per dispatch; every member holds a
  :class:`_MemberPlane` view. Sync and pipelined flush, device eval
  (compact readback, the default) and ``host_eval`` (full event-matrix
  readback), with the overflow fallback of the reference; and multi-tick
  residency (``resident_depth > 1``, reference ``vote_plane.py:759-789``,
  ``:1361-1497``): each tick's words are staged into a device ring without
  a launch, and ONE K9 launch consumes up to ``resident_depth`` ticks with
  the checkpoint slides folded in, quorums evaluated once; and the
  member x validator fabric (``mesh=``, reference ``:594-660``,
  ``:800-952``, ``:1116-1282``, ``:1499-1532``) with every tile on the
  group's one device: padded axes, K13 steps, per-block staging and
  absorb, the occupancy grid, and plane rotation (rebalance) through the
  placement map.

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

- the residency ring stages each slot's words in its own pinned host row
  and copies it to the device ring ``non_blocking``; a row is rewritten
  only after the event behind its last copy has completed.

Pipelined mode keeps the reference's one-tick verdict lag; dtypes and
byte counts equal JAX's (int32 slot lists and counts, uint8 ``stable``,
bool events), so ``readback_bytes_total`` counts the same bytes, and on a
mesh ``readback_bytes_per_shard`` the same bytes per member block.
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
from .compile_plan import plan_for, resident_plan_for

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
    and its device twin, staged and copied in ``blocks`` member blocks
    (one on an unsharded group). A block's host rows are rewritten only
    after the event behind their last H2D copy has completed."""

    def __init__(self, rows: int, width: int, device: torch.device,
                 blocks: int = 1):
        self._cuda = device.type == "cuda"
        self.host = torch.zeros((rows, width), dtype=torch.int32,
                                pin_memory=self._cuda)
        self._view = self.host.numpy().view(np.uint32)
        self._dev = (torch.empty((rows, width), dtype=torch.int32,
                                 device=device) if self._cuda else None)
        self._block = rows // blocks
        self._copied = [torch.cuda.Event() if self._cuda else None
                        for _ in range(blocks)]
        self._pending_copy = [False] * blocks

    def stage(self, row_chunks, interleave=None) -> torch.Tensor:
        """``row_chunks[r]``: the packed words of device row r. After
        each block's copy is issued, ``interleave`` (optional) advances
        once."""
        for b, event in enumerate(self._copied):
            lo, hi = b * self._block, (b + 1) * self._block
            if self._pending_copy[b]:
                event.synchronize()
                self._pending_copy[b] = False
            view = self._view[lo:hi]
            view[...] = 0
            for i, entries in enumerate(row_chunks[lo:hi]):
                if entries:
                    q.fill_words_row(view[i], entries)
            if self._cuda:
                self._dev[lo:hi].copy_(self.host[lo:hi], non_blocking=True)
                event.record(torch.cuda.current_stream(self._dev.device))
                self._pending_copy[b] = True
            if interleave is not None:
                next(interleave, None)
        # on the CPU the plain step consumes the words before the buffer
        # is staged again
        return self._dev if self._cuda else self.host


class _Ring:
    """The residency ring's word slots: a (capacity, M, width) int32 block
    on the device, grown by doubling, so a consume hands K9 its k slots as
    one operand. Each slot is staged in its own pinned host row and copied
    ``non_blocking``; a row is rewritten only after the CUDA event behind
    its last copy has completed. On the CPU the host block is the ring:
    the plain step reads it before a slot is staged again."""

    def __init__(self, rows: int, width: int, device: torch.device):
        self._shape = (rows, width)
        self._device = device
        self._cuda = device.type == "cuda"
        self._cap = 0
        self._host = self._dev = None
        self._copied: list = []  # per slot: the event behind its copy
        self._grow(4)

    def _grow(self, cap: int) -> None:
        host = torch.zeros((cap,) + self._shape, dtype=torch.int32,
                           pin_memory=self._cuda)
        dev = (torch.empty((cap,) + self._shape, dtype=torch.int32,
                           device=self._device) if self._cuda else None)
        if self._cap:
            # staged slots keep their words: on the card a copy behind
            # their H2D copies on the same stream
            (dev if self._cuda else host)[:self._cap].copy_(self.block(
                self._cap))
        self._host, self._dev = host, dev
        self._view = host.numpy().view(np.uint32)
        self._copied += [None] * (cap - self._cap)
        self._cap = cap

    def stage(self, pos: int, chunks) -> None:
        """Slot ``pos`` (at most one past the last staged) <- one
        padded word row per member."""
        if pos >= self._cap:
            self._grow(2 * self._cap)
        if self._copied[pos] is not None:
            self._copied[pos].synchronize()
            self._copied[pos] = None
        view = self._view[pos]
        view[...] = 0
        for i, entries in enumerate(chunks):
            if entries:
                q.fill_words_row(view[i], entries)
        if self._cuda:
            self._dev[pos].copy_(self._host[pos], non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self._device))
            self._copied[pos] = event

    def block(self, k: int) -> torch.Tensor:
        """Slots [0, k) as one contiguous (k, M, width) tensor."""
        return (self._dev if self._cuda else self._host)[:k]


def _rebase_full(row: np.ndarray, d: int) -> np.ndarray:
    """A full (S,) event row moved into the window slid by ``d``."""
    if not d:
        return row
    return np.concatenate([row[d:], np.zeros(min(d, row.shape[0]),
                                             row.dtype)])


def _rebase_slots(row: np.ndarray, d: int, s: int) -> np.ndarray:
    """An S-padded slot list's entries moved into the window slid by
    ``d`` (slots the slide dropped go)."""
    new = row[row < s]
    return new[new >= d] - d if d else new


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
    unless ``device="cpu"``.

    ``mesh`` (a :class:`~indy_plenum_tpu_torch.tpu.quorum.FabricMesh` on
    the group's device, from ``make_fabric_mesh``) runs the group as the
    reference's member x validator fabric, every tile on that one device:
    both axes pad up to their mesh multiple (pad member rows are zero
    planes with no member view, pad validator rows never receive votes),
    the step is K13 (the tiled K9 with residency), the word block is
    staged member block by member block, the absorb folds the compact
    record block by block (``readback_bytes_per_shard``), the occupancy
    grid has one cell per (member block, validator block), and a
    scheduled rebalance rotates the planes along the member axis (one K1
    roll) at the next checkpoint-boundary slide."""

    def __init__(self, n_members: int, validators: List[str], log_size: int,
                 n_checkpoints: int = 4, h: int = 0, metrics=None,
                 mesh=None, pipelined: bool = False,
                 adaptive_ladder: bool = False,
                 host_eval: bool = False,
                 delta_cap: Optional[int] = None,
                 resident_depth: int = 1,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        mesh = q.as_fabric(mesh)
        self._n = len(validators)
        self._log_size = log_size
        self._n_chk = n_checkpoints
        self.host_eval = host_eval
        self._delta_cap = int(delta_cap) if delta_cap else q.ORDER_DELTA_CAP
        self._mesh = mesh
        self._m_shards = 1  # member blocks (mesh axis 0)
        self._v_shards = 1  # validator blocks (mesh axis 1)
        self._shard_rows = n_members
        self._m_pad = n_members
        self._v_rows = self._n
        self._n_pad = self._n
        if mesh is not None:
            if mesh.device != self.device:
                raise ValueError(f"fabric mesh on {mesh.device}, group on "
                                 f"{self.device}")
            self._m_shards = mesh.m_shards
            self._v_shards = mesh.v_shards
            # both axes pad up to their mesh multiple (reference
            # vote_plane.py:612-617)
            self._shard_rows = -(-n_members // self._m_shards)
            self._m_pad = self._shard_rows * self._m_shards
            self._v_rows = -(-self._n // self._v_shards)
            self._n_pad = self._v_rows * self._v_shards
        # occupancy grid: cell i * v_shards + j = member block i x
        # validator block j
        self._n_shards = self._m_shards * self._v_shards
        self._plan = plan_for(mesh, self._n, self._n_pad, self._delta_cap)
        # real (non-pad) rows per member block and per validator block:
        # the capacity denominators of the occupancy grid
        self._real_rows = [
            min(max(n_members - si * self._shard_rows, 0), self._shard_rows)
            for si in range(self._m_shards)]
        self._v_real = [
            min(max(self._n - vj * self._v_rows, 0), self._v_rows)
            for vj in range(self._v_shards)]
        self._states = q.init_state(self._n_pad, log_size, n_checkpoints,
                                    self._m_pad, self.device)
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
        # device-eval mirrors kept current by folding compact deltas in,
        # indexed by MEMBER (the placement map translates rows)
        self._mir_prepared = np.zeros((self._m_pad, log_size), bool)
        self._mir_commit_ok = np.zeros((self._m_pad, log_size), bool)
        self._mir_stable = np.zeros((self._m_pad, n_checkpoints), bool)
        self._mir_frontier = np.zeros(self._m_pad, np.int64)
        # last absorbed step's device-resident full events (overflow
        # fallback + on-demand diagnostics)
        self._dev_events: Optional[q.QuorumEvents] = None
        # readback accounting; on a mesh the absorb counts one readback
        # per member block, and the bytes of each block
        self.readback_bytes_total = 0
        self.readbacks = 0
        self.readbacks_overlapped = 0
        self.readback_bytes_per_shard = [0] * self._m_shards
        self._flush_seq = 0
        self.flushes = 0
        self.flush_votes_total = 0
        self.flush_capacity_total = 0
        # the governor's per-cell occupancy series (one cell unsharded)
        self.flush_votes_per_shard = [0] * self._n_shards
        self.flush_capacity_per_shard = [0] * self._n_shards
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
        # multi-tick device residency (reference vote_plane.py:759-789):
        # with resident_depth N > 1 flush() stages each tick's words into
        # ring slots (a copy, no launch) and ONE K9 launch consumes up to
        # N ticks, each slot's checkpoint slide folded in before its
        # scatter; verdicts may lag up to N ticks. Device eval only:
        # host_eval stays per tick.
        self.resident_depth = max(1, int(resident_depth))
        self._resident = self.resident_depth > 1 and not host_eval
        self._ring: list = []  # per staged slot: its slide vector or None
        self._ring_words: Optional[_Ring] = None  # made on first use
        self._ring_ticks = 0  # enqueued ticks since the last consume
        self.resident_ticks = 0  # total ticks that rode the ring
        self.readbacks_deferred = 0  # ticks whose readback deferred
        # one fixed slot width (the adaptive ladder stays per tick)
        self._resident_width = self.flush_batch
        self._pending_slide = np.zeros(self._m_pad, np.int32)  # by ROW
        # cumulative slide per MEMBER, and its snapshot when the in-flight
        # consume was dispatched: the difference rebases reported slots
        self._slide_cum = np.zeros(self._m_pad, np.int64)
        self._inflight_cum = self._slide_cum.copy()
        if self._resident:
            self.metrics.add_event(MetricsName.DEVICE_RESIDENT_DEPTH,
                                   self.resident_depth)
        # occupancy-driven rebalancing (tpu/rebalance.py): member planes
        # may rotate across device rows at a checkpoint-boundary barrier;
        # the placement map translates member index <-> device row
        # wherever the host touches rows. Mirrors stay member-indexed.
        self._row_shift = 0
        self._rebalance_pending = 0
        self.rebalances = 0
        self._rebuild_placement()

    def _rebuild_placement(self) -> None:
        """Recompute the row -> member map from the rotation shift
        (identity until the first rebalance)."""
        rows = (np.arange(self._m_pad) - self._row_shift) % self._m_pad
        self._row_member = np.where(
            rows < len(self._members), rows, -1).astype(np.int64)
        self._row_valid = self._row_member >= 0

    def _row_of(self, member_idx: int) -> int:
        """Device row currently holding this member's plane."""
        return (member_idx + self._row_shift) % self._m_pad

    @property
    def row_shift(self) -> int:
        """Current member -> device-row rotation (0 until a rebalance)."""
        return self._row_shift

    def view(self, member_idx: int) -> "DeviceVotePlane":
        return self._members[member_idx]

    @property
    def shards(self) -> int:
        """Occupancy-grid cell count: 1 unsharded, member blocks x
        validator blocks on the fabric."""
        return self._n_shards

    @property
    def mesh_shape(self) -> tuple:
        """() unsharded, (m,) or (m, v) on the fabric."""
        return self._plan.mesh_shape

    @property
    def compile_strategy(self) -> dict:
        """The kernel behind each plan function (``CompilePlan.strategy``:
        what the port launches, where the reference names its
        compilation path)."""
        return dict(self._plan.strategy)

    @property
    def shard_occupancy(self) -> List[float]:
        """Cumulative per-cell occupancy (scattered votes / real-row
        capacity), the flattened grid of cell i * v + j."""
        return [round(v / c, 4) if c else 0.0
                for v, c in zip(self.flush_votes_per_shard,
                                self.flush_capacity_per_shard)]

    @property
    def eval_mode(self) -> str:
        """Where quorum decisions are made: "device" (compact readback,
        the default) or "host" (full event-matrix readback fallback)."""
        return "host" if self.host_eval else "device"

    @property
    def lagging(self) -> bool:
        """True while a dispatched step's events are not yet in the host
        snapshot (pipelined mode), or a ring slot is staged but not yet
        evaluated: the governor's absorb clamp and the services'
        lost-wakeup guard treat both as in flight."""
        return self._inflight is not None or bool(self._ring)

    # --- dispatch -------------------------------------------------------

    def _row_chunks(self, chunks: List[List[int]]) -> List[List[int]]:
        """Member chunks laid out by device row (pad rows empty)."""
        if not self._row_shift and self._m_pad == len(chunks):
            return chunks
        return [chunks[mi] if mi >= 0 else [] for mi in self._row_member]

    def _stage_scatter(self, chunks: List[List[int]], shape: int,
                       interleave=None) -> torch.Tensor:
        """The (M_pad, shape) word block on the device. On a mesh each
        member block's rows are staged and copied in turn, and
        ``interleave`` (the pipelined absorb) advances once after each
        block's copy is issued (reference ``vote_plane.py:1116-1136``)."""
        buf = self._scatter_bufs.get(shape)
        if buf is None:
            buf = self._scatter_bufs[shape] = _Staging(
                self._m_pad, shape, self.device, self._m_shards)
        return buf.stage(self._row_chunks(chunks), interleave)

    def _cell_votes(self, shard_votes: List[int], base: int, take) -> None:
        """Attribute one member's votes to occupancy-grid cells: by member
        block, and under the 2-axis fabric by each vote's SENDER block."""
        if self._v_shards == 1:
            shard_votes[base] += len(take)
            return
        for w in take:
            shard_votes[base + min(((w >> 16) & 0x1FFF) // self._v_rows,
                                   self._v_shards - 1)] += 1

    def _collect_chunks(self):
        """One flush-batch chunk from every member's pending queue, votes
        attributed to grid cells under the CURRENT placement."""
        chunks = []
        votes = 0
        shard_votes = [0] * self._n_shards
        for i, m in enumerate(self._members):
            take, m._pending = (m._pending[:self.flush_batch],
                                m._pending[self.flush_batch:])
            chunks.append(take)
            votes += len(take)
            self._cell_votes(
                shard_votes,
                (self._row_of(i) // self._shard_rows) * self._v_shards,
                take)
        return chunks, votes, shard_votes

    def _dispatch_pending(self, interleave=None) -> list:
        """Chunk + scatter every member's pending votes; returns the
        chained (events, compact) step results (empty if nothing was
        pending). ``interleave`` threads the pipelined per-block absorb
        through the staging."""
        results = []
        while any(m._pending for m in self._members):
            chunks, votes, shard_votes = self._collect_chunks()
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
            args = None
            if self.trace.enabled:
                args = {"votes": votes, "shape": shape}
                if self._n_shards > 1:
                    args["shard_votes"] = list(shard_votes)
            with self.trace.span("flush.dispatch", args=args) \
                    if self.trace.enabled else _NO_SPAN:
                words = self._stage_scatter(chunks, shape, interleave)
                self._states, events, compact = self._plan.step(
                    self._states, words)
            results.append((events, compact))
            self.flushes += 1
            self.metrics.add_event(MetricsName.DEVICE_FLUSH)
            self._count_scatter(votes, shape, shard_votes)
        return results

    def _cell_capacity(self, shape: int) -> List[float]:
        """One word block's capacity per grid cell: real member rows
        only, apportioned across validator blocks by their share of real
        senders under the 2-axis fabric."""
        if self._v_shards == 1:
            return [r * shape for r in self._real_rows]
        return [r * shape * v / self._n
                for r in self._real_rows for v in self._v_real]

    def _account_shards(self, shard_votes: List[int], shape: int) -> None:
        """Fold one word block into the per-cell occupancy series."""
        caps = self._cell_capacity(shape)
        for si in range(self._n_shards):
            self.flush_votes_per_shard[si] += shard_votes[si]
            self.flush_capacity_per_shard[si] += caps[si]
        if self._n_shards > 1:
            self.metrics.add_event(
                MetricsName.DEVICE_SHARD_COUNT, self._n_shards)
            for si in range(self._n_shards):
                if caps[si]:
                    self.metrics.add_event(
                        f"{MetricsName.DEVICE_SHARD_FLUSH_VOTES}.{si}",
                        shard_votes[si])
                    self.metrics.add_event(
                        f"{MetricsName.DEVICE_SHARD_FLUSH_CAPACITY}.{si}",
                        caps[si])

    def _count_scatter(self, votes: int, shape: int,
                       shard_votes: List[int]) -> None:
        """Occupancy counters of one (M, shape) word block, dispatched or
        staged into the ring (the governor's input)."""
        capacity = len(self._members) * shape
        self.flush_votes_total += votes
        self.flush_capacity_total += capacity
        self._account_shards(shard_votes, shape)
        self.metrics.add_event(MetricsName.DEVICE_FLUSH_VOTES, votes)
        self.metrics.add_event(
            MetricsName.DEVICE_FLUSH_OCCUPANCY, votes / capacity)

    def _dispatch_empty(self) -> list:
        """One padded no-vote step (cold start needs SOME events)."""
        words = self._stage_scatter(
            [[] for _ in self._members], FLUSH_LADDER[0])
        self._states, events, compact = self._plan.step(self._states, words)
        self.flushes += 1
        self.flush_capacity_total += len(self._members) * FLUSH_LADDER[0]
        self._account_shards([0] * self._n_shards, FLUSH_LADDER[0])
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
        """Fold one flush's chained steps into the host snapshot, every
        member block at once."""
        for _ in self._absorb_blocks(results, overlapped):
            pass

    def _absorb_blocks(self, results: list, overlapped: bool):
        """Generator folding one flush's chained steps into the host
        snapshot, one member block at a time (reference
        ``vote_plane.py:864-952``), yielding between blocks so the
        pipelined flush can fold a block while the next block's words are
        staged. host_eval: ONE full-matrix readback. Device eval: each
        step's compact record crosses in one copy (one device holds every
        block), and is folded and counted per member block on a mesh -
        one ``flush.readback`` span (with its ``shard``), one
        ``readbacks`` count and the block's bytes in
        ``readback_bytes_per_shard``, as a fabric with a card per block
        reads them back."""
        trace_on = self.trace.enabled
        if self.host_eval:
            args = ({"bytes": 0, "overlapped": overlapped}
                    if trace_on else None)
            with self.trace.span("flush.readback", args=args) \
                    if trace_on else _NO_SPAN:
                (self._host_prepared, self._host_prepare_counts,
                 self._host_commit_counts,
                 self._host_stable) = results[-1][2].result()
                if self._row_shift:
                    # the snapshot is row-indexed, members read it by
                    # index: un-rotate the rows
                    perm = (np.arange(self._m_pad)
                            + self._row_shift) % self._m_pad
                    (self._host_prepared, self._host_prepare_counts,
                     self._host_commit_counts, self._host_stable) = (
                        self._host_prepared[perm],
                        self._host_prepare_counts[perm],
                        self._host_commit_counts[perm],
                        self._host_stable[perm])
                self._host_commit_ok = (
                    self._host_commit_counts
                    >= self._n - (self._n - 1) // 3)
                bytes_n = sum(a.nbytes for a in (
                    self._host_prepared, self._host_prepare_counts,
                    self._host_commit_counts, self._host_stable))
                if args is not None:
                    args["bytes"] = bytes_n
            self._count_readback(bytes_n, overlapped, None)
        else:
            sharded = self._mesh is not None
            hosts = [(events, q.CompactEvents(*fetch.result()))
                     for events, _, fetch in results]
            for si in range(self._m_shards if sharded else 1):
                args = ({"bytes": 0, "overlapped": overlapped}
                        if trace_on else None)
                if args is not None and sharded:
                    args["shard"] = si
                with self.trace.span("flush.readback", args=args) \
                        if trace_on else _NO_SPAN:
                    bytes_n = 0
                    for events, host in hosts:
                        bytes_n += self._apply_compact(
                            events, host, si if sharded else None)
                    if args is not None:
                        args["bytes"] = bytes_n
                self._count_readback(bytes_n, overlapped,
                                     si if sharded else None)
                yield si
            self._host_prepared = self._mir_prepared
            self._host_commit_ok = self._mir_commit_ok
            self._host_stable = self._mir_stable
            self._host_prepare_counts = None
            self._host_commit_counts = None
        self._dev_events = results[-1][0]
        self.metrics.add_event(MetricsName.DEVICE_READBACK_COMPACT,
                               0 if self.host_eval else 1)
        self.version += 1

    def _count_readback(self, bytes_n: int, overlapped: bool,
                        si: Optional[int]) -> None:
        self.readback_bytes_total += bytes_n
        if si is not None:
            self.readback_bytes_per_shard[si] += bytes_n
        self.readbacks += 1
        if overlapped:
            self.readbacks_overlapped += 1
        self.metrics.add_event(MetricsName.DEVICE_READBACK_BYTES, bytes_n)

    def _apply_compact(self, events: q.QuorumEvents, host: q.CompactEvents,
                       si: Optional[int]) -> int:
        """Fold one step's compact deltas - the whole group (``si`` None)
        or member block ``si``'s rows - into the mirrors + per-member
        delta accumulators; returns the bytes of that block. A member
        whose true delta count exceeds the cap triggers one full-events
        fetch of the block for this step (diffed against its mirror)."""
        lo = 0 if si is None else si * self._shard_rows
        if si is not None:
            host = q.CompactEvents(*[a[lo:lo + self._shard_rows]
                                     for a in host])
        bytes_n = sum(a.nbytes for a in host)
        s = self._log_size
        cap = self._delta_cap
        rows = host.frontier.shape[0]
        # pad rows hold nothing; a rotated placement maps each device row
        # back to its member (or -1)
        row_member = self._row_member[lo:lo + rows]
        valid = self._row_valid[lo:lo + rows]
        over_p = host.n_prepared > cap
        over_c = host.n_committed > cap
        full_prep = full_ord = None
        if (over_p & valid).any() or (over_c & valid).any():
            full_prep = events.prepared[lo:lo + rows].cpu().numpy()
            full_ord = events.ordered[lo:lo + rows].cpu().numpy()
            bytes_n += full_prep.nbytes + full_ord.nbytes
        touched = np.nonzero(
            ((host.new_prepared[:, 0] < s) | (host.new_committed[:, 0] < s)
             | over_p | over_c) & valid)[0]
        # the residency slide-fold rebase (reference vote_plane.py:
        # 1009-1063): slides folded into the consumed step moved the
        # window after its certs were found, so reported slots are in
        # pre-slide coordinates; shift them down by the slides applied
        # since the consume was dispatched (0 on every per-tick path)
        shift = self._slide_cum - self._inflight_cum
        for r in touched:
            mi = int(row_member[r])
            member = self._members[mi]
            d = int(shift[mi])
            if over_p[r]:
                new = np.nonzero(_rebase_full(full_prep[r], d)
                                 & ~self._mir_prepared[mi])[0]
            else:
                new = _rebase_slots(host.new_prepared[r], d, s)
            if new.size:
                self._mir_prepared[mi, new] = True
                member._delta_prepared.extend(int(x) for x in new)
            if over_c[r]:
                new = np.nonzero(_rebase_full(full_ord[r], d)
                                 & ~self._mir_commit_ok[mi])[0]
            else:
                new = _rebase_slots(host.new_committed[r], d, s)
            if new.size:
                self._mir_commit_ok[mi, new] = True
                member._delta_committed.extend(int(x) for x in new)
        mis = row_member[valid]
        stable = host.stable.astype(bool)[valid]
        frontier = host.frontier[valid]
        deltas = shift[mis]
        plain = deltas == 0
        self._mir_stable[mis[plain]] = stable[plain]
        self._mir_frontier[mis[plain]] = frontier[plain]
        if not plain.all():
            # slid members: the checkpoint votes the report saw were
            # zeroed by the folded slide's own roll - keep the mirror's
            # post-slide state, and only advance the frontier by the
            # rebased report
            sh = ~plain
            self._mir_frontier[mis[sh]] = np.maximum(
                self._mir_frontier[mis[sh]],
                np.maximum(frontier[sh] - deltas[sh], 0))
        return bytes_n

    # --- flush --------------------------------------------------------

    def _flush_pipelined(self) -> None:
        # 1. absorb the steps dispatched LAST tick (their copies have had
        # a whole tick of host work to land). On a mesh with votes
        # pending, the absorb runs per member block, interleaved with
        # step 2's per-block staging (reference vote_plane.py:1282)
        absorb = None
        if self._inflight is not None:
            results, self._inflight = self._inflight, None
            absorb = self._absorb_blocks(
                results, overlapped=self._flush_seq > self._inflight_seq)
            if self._mesh is None or self.host_eval \
                    or not any(m._pending for m in self._members):
                for _ in absorb:  # nothing to interleave with
                    pass
                absorb = None
        # 2. dispatch this tick's votes and start their readback copies;
        # the absorb happens next tick
        results = self._dispatch_pending(interleave=absorb)
        if absorb is not None:
            for _ in absorb:  # the blocks the staging did not cover
                pass
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
        if self._resident:
            with self.metrics.measure_time(MetricsName.DEVICE_FLUSH_TIME):
                self._flush_resident()
            return
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

    # --- multi-tick residency ring ------------------------------------

    def _take_slide(self) -> Optional[np.ndarray]:
        """Detach the accumulated slide vector (row-indexed) for the NEXT
        ring slot (the step applies it before that slot's scatter)."""
        if not self._pending_slide.any():
            return None
        vec = self._pending_slide
        self._pending_slide = np.zeros(self._m_pad, np.int32)
        return vec

    def _ring_slot(self, chunks: List[List[int]]) -> None:
        if self._ring_words is None:
            self._ring_words = _Ring(self._m_pad, self._resident_width,
                                     self.device)
        self._ring_words.stage(len(self._ring), self._row_chunks(chunks))
        self._ring.append(self._take_slide())

    def _enqueue_chunks(self, count_tick: bool = True) -> None:
        """Stage every member's pending votes into ring slots: copies to
        the device, no launch."""
        enqueued = False
        while any(m._pending for m in self._members):
            chunks, votes, shard_votes = self._collect_chunks()
            shape = self._resident_width
            args = None
            if self.trace.enabled:
                args = {"votes": votes, "shape": shape}
                if self._n_shards > 1:
                    args["shard_votes"] = list(shard_votes)
            with self.trace.span("flush.enqueue", args=args) \
                    if self.trace.enabled else _NO_SPAN:
                self._ring_slot(chunks)
            self._count_scatter(votes, shape, shard_votes)
            enqueued = True
        if enqueued and count_tick:
            self._ring_ticks += 1
            self.resident_ticks += 1
            self.metrics.add_event(MetricsName.DEVICE_RESIDENT_TICKS)

    def _consume_ring(self, sync: bool = False) -> None:
        """ONE K9 launch (the tiled K9 on a mesh) consuming every ring
        slot (slides folded in per slot, quorums evaluated once), its
        compact readback handed to the pipeline - or absorbed now when
        ``sync`` (cold start, drain)."""
        if self._pending_slide.any():
            # a trailing slide with no votes after it rides an empty slot
            self._ring_slot([[] for _ in self._members])
            self.flush_capacity_total += (len(self._members)
                                          * self._resident_width)
            self._account_shards([0] * self._n_shards,
                                 self._resident_width)
        # absorb the PREVIOUS consume first: its readback overlapped the
        # resident ticks' host work
        self._sync_inflight()
        if not self._ring:
            results = self._dispatch_empty()  # cold start only
        else:
            slides = np.stack([
                vec if vec is not None else np.zeros(self._m_pad, np.int32)
                for vec in self._ring])
            k, self._ring = len(self._ring), []
            ticks, self._ring_ticks = self._ring_ticks, 0
            args = ({"slots": k, "ticks": ticks,
                     "resident": self.resident_depth}
                    if self.trace.enabled else None)
            with self.trace.span("flush.dispatch", args=args) \
                    if self.trace.enabled else _NO_SPAN:
                step = resident_plan_for(self._mesh, self._n, self._n_pad,
                                         self._delta_cap, k,
                                         self._resident_width, self.device)
                self._states, events, compact = step(
                    self._states, torch.from_numpy(slides),
                    self._ring_words.block(k))
            results = [(events, compact)]
            self.flushes += 1
            self.metrics.add_event(MetricsName.DEVICE_FLUSH)
        self._inflight_cum = self._slide_cum.copy()
        if self.pipelined and not sync:
            self._inflight = self._start_readbacks(results)
            self._inflight_seq = self._flush_seq
        else:
            self._absorb_results(self._start_readbacks(results),
                                 overlapped=False)

    def _drain_ring(self) -> None:
        """The residency barrier: consume and absorb everything staged NOW
        (view resets, rotations and per-query refreshes must see settled
        state)."""
        if self._resident and (self._ring or self._pending_slide.any()):
            self._consume_ring(sync=True)
        else:
            self._sync_inflight()

    def _flush_resident(self) -> None:
        """Stage this tick's votes into the ring; consume only when the
        ring holds ``resident_depth`` ticks, the pool went quiet, or the
        snapshot is void (cold start) - otherwise defer the readback."""
        had_pending = any(m._pending for m in self._members)
        if had_pending:
            self._enqueue_chunks()
        if self._host_prepared is None:
            # cold start (or post-reset): callers need SOME snapshot
            self._consume_ring(sync=True)
            return
        if self._ring and (self._ring_ticks >= self.resident_depth
                           or not had_pending):
            self._consume_ring()
        elif self._ring:
            self.readbacks_deferred += 1
            self.metrics.add_event(MetricsName.DEVICE_READBACKS_DEFERRED)
            if self.trace.enabled:
                self.trace.record("flush.defer", cat="dispatch",
                                  args={"ring_ticks": self._ring_ticks})
        elif not had_pending and self._inflight is not None:
            # quiet tick, nothing staged, a consume in flight: absorb now
            self._sync_inflight()

    # --- occupancy-driven rebalancing ---------------------------------

    def schedule_rebalance(self, rows: int) -> None:
        """Plan a member-plane rotation by ``rows`` device rows along the
        member axis (planes move, members don't), executed at the next
        checkpoint-boundary slide: the barrier where the ring is
        drained."""
        rows = int(rows) % self._m_pad
        if rows:
            self._rebalance_pending = rows

    def rebalance_at_barrier(self) -> None:
        """Execute a scheduled rotation, if any (the checkpoint-boundary
        slide calls this; harnesses may model their own barriers)."""
        if self._rebalance_pending:
            self._execute_rebalance()

    def _execute_rebalance(self) -> None:
        from .rebalance import rotate_planes

        rows, self._rebalance_pending = self._rebalance_pending, 0
        # barrier: everything staged settles under the OLD placement,
        # THEN the planes move (one K1 roll) and the placement map rewrites
        self._drain_ring()
        self._states = rotate_planes(self._states, self._mesh, rows,
                                     self._shard_rows)
        self._row_shift = (self._row_shift + rows) % self._m_pad
        self._rebuild_placement()
        self.rebalances += 1
        self.version += 1
        if self.trace.enabled:
            self.trace.record("rebalance.executed", cat="dispatch",
                              args={"rows": rows,
                                    "shift": self._row_shift})

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
        if self._resident:
            # slide-fold: stage the votes recorded against the OLD window
            # first (they scatter before the slide), then ACCUMULATE the
            # delta for the next ring slot. No sync, no launch: the
            # mirrors roll on the host and stay the live snapshot.
            self._enqueue_chunks(count_tick=False)
            self.rebalance_at_barrier()
            self._pending_slide[self._row_of(member_idx)] += delta
            self._slide_cum[member_idx] += delta
            self._roll_member_mirrors(member_idx, delta)
            self.version += 1
            return
        self.flush()
        self._sync_inflight()
        # the checkpoint-boundary barrier: a scheduled rotation runs now,
        # with the device state settled
        self.rebalance_at_barrier()
        deltas = torch.zeros(self._m_pad, dtype=torch.int32)
        deltas[self._row_of(member_idx)] = delta
        self._states = self._plan.slide(self._states, deltas)
        self.version += 1
        self._host_prepared = None
        self._roll_member_mirrors(member_idx, delta)

    def reset_member(self, member_idx: int) -> None:
        # pending for this member was cleared by the caller; other
        # members' buffered votes are untouched. A view reset drains the
        # residency ring first: old-view events must not land after it
        self._drain_ring()
        mask = torch.zeros(self._m_pad, dtype=torch.bool)
        mask[self._row_of(member_idx)] = True
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
            # absorb its in-flight step now, a resident one consume its
            # ring
            self._group._drain_ring()
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
        # one scalar from the device-resident events, addressed by row
        return int(ev.prepare_counts[self._group._row_of(self._mi),
                                     slot].item())
