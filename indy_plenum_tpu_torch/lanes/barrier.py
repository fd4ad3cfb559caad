"""Cross-lane checkpoint barrier: one consistent stabilized window.

Each ordering lane runs its own full 3PC pipeline, so without a join
point the lanes' stabilized checkpoint windows drift apart — state
proofs and catchup would see K mutually-inconsistent "latest" windows.
The barrier is that join point, and it enforces ONE rule:

    **no lane may commit (stabilize) a window the barrier hasn't
    sealed.**

Mechanics: a lane's :class:`~indy_plenum_tpu_torch.server.consensus
.checkpoint_service.CheckpointService` calls :meth:`offer` the moment it
observes a local checkpoint quorum for window ``w`` (``w = seqNoEnd //
CHK_FREQ`` — lane-local window ordinals). The first offer makes the lane
*ready* at ``w``; window ``w`` **seals** once every lane is ready at
``w`` (or provably idle — see below). Until then the stabilization is
HELD: no GC, no watermark advance, no ``CheckpointStabilized`` — so the
lane's ordering stalls at its high watermark after at most
``LOG_SIZE/CHK_FREQ`` unsealed windows. That watermark stall IS the
skew bound: a fast lane can never run away from the pool's sealed
window, which is exactly what keeps the proof plane
(:mod:`~indy_plenum_tpu_torch.proofs`) and catchup on one consistent window —
both ride ``CheckpointStabilized``, which the barrier now gates.

**Idle lanes**: a lane with no admitted, pending, or in-flight work
cannot produce checkpoints, and a strict all-lanes-ready rule would
deadlock the busy lanes against it. An idle lane is therefore vacuously
ready at every window (its per-lane digest folds as ``"idle"``). The
idleness probe is injected per lane (:meth:`set_idle_probe`) and
consulted at deterministic instants only (offers, catchup floors, and
the dispatch tick via :meth:`service_tick`) — the deployed analog is the
freshness empty batch (``StateFreshnessUpdateInterval``), which keeps an
idle lane's checkpoints flowing for real.

**Sealed-window fingerprint**: sealing window ``w`` folds the per-lane
checkpoint digests in lane order into a running chain —

    seal_fp(w) = sha256(seal_fp(w-1) | w | d_0 | d_1 | ... | d_{K-1})

where ``d_l`` is lane ``l``'s checkpoint digest for ``w`` (itself the
sha256 over the lane's ordered batch digests since the previous
boundary), ``"idle"`` for a vacuously-ready lane, and ``"catchup"`` for
a window a lane skipped by leeching. The chain tip
(:attr:`seal_fingerprint`) is THE cross-lane ordering fingerprint:
seeded runs replay it bit-for-bit, and the lanes gate compares runs on
it exactly like ``ordered_hash``.

Copy of ``indy_plenum_tpu/lanes/barrier.py``, with its imports bound to
the port.
"""
from __future__ import annotations

import hashlib
from typing import Callable, Dict, List, Optional, Tuple

GENESIS_FINGERPRINT = hashlib.sha256(b"lane-barrier-genesis").hexdigest()
IDLE_DIGEST = "idle"
CATCHUP_DIGEST = "catchup"


class CrossLaneBarrier:
    def __init__(self, lanes: int, chk_freq: int,
                 clock: Optional[Callable[[], float]] = None,
                 trace=None, metrics=None, keep: int = 0):
        if lanes < 1:
            raise ValueError(f"lanes must be >= 1: {lanes}")
        if chk_freq < 1:
            raise ValueError(f"chk_freq must be >= 1: {chk_freq}")
        self.lanes = int(lanes)
        self.chk_freq = int(chk_freq)
        # per-window record retention: 0 = retain everything (bounded
        # sim runs; full-chain recomputation), > 0 = keep the last
        # ``keep`` windows' seal records (the chain tip is O(1) state,
        # so verification re-seeds from the oldest retained window's
        # predecessor) — a long-lived pool must not grow O(windows)
        self.keep = int(keep)
        self._clock = clock if clock is not None else (lambda: 0.0)
        from ..observability.trace import NULL_TRACE

        self._trace = trace if trace is not None else NULL_TRACE
        self._metrics = metrics
        # the barrier state proper
        self.sealed_window = 0
        self.seal_fingerprint = GENESIS_FINGERPRINT
        self.fingerprints: Dict[int, str] = {}  # window -> chain value
        # window -> the per-lane digest list the fold consumed (lane
        # order) — the cross-lane invariant recomputes the chain from it
        self.seal_digests: Dict[int, List[str]] = {}
        self.seals = 0
        self._ready: Dict[int, int] = {}  # lane -> max ready window
        # (lane, window) pairs that emitted a barrier.ready trace mark —
        # the sealed mark names them so the Perfetto export only closes
        # flow arrows that actually have a start
        self._ready_marked: set = set()
        # (lane, window) -> checkpoint digest; first reporter wins (all
        # honest nodes of a lane report the quorum-checked digest)
        self._digests: Dict[Tuple[int, int], str] = {}
        self._ready_at: Dict[int, float] = {}  # window -> first-ready ts
        # held stabilizations: (lane, window, node) -> release callback;
        # keyed so tick-mode stabilization retries can't enqueue twice
        self._held: Dict[Tuple[int, int, str], Callable[[], None]] = {}
        self._held_order: List[Tuple[int, int, str]] = []
        self._idle_probe: Dict[int, Callable[[], bool]] = {}
        self._advancing = False

    # ------------------------------------------------------------------

    def set_idle_probe(self, lane: int, probe: Callable[[], bool]) -> None:
        """``probe()`` must return True iff ``lane`` has no admitted,
        pending, or in-flight work — a deterministic function of pool
        state on the virtual clock."""
        self._idle_probe[lane] = probe

    def window_of(self, seq_no_end: int) -> int:
        return seq_no_end // self.chk_freq

    def ready_window(self, lane: int) -> int:
        return self._ready.get(lane, 0)

    # ------------------------------------------------------------------

    def offer(self, lane: int, node: str, seq_no_end: int, digest: str,
              release: Callable[[], None]) -> bool:
        """A lane node's stabilization attempt for the window ending at
        ``seq_no_end``. Returns True when the window is already sealed
        (the caller stabilizes synchronously); otherwise the release
        callback is held and invoked — in offer order — the moment the
        barrier seals the window."""
        window = self.window_of(seq_no_end)
        self._digests.setdefault((lane, window), digest)
        if self._ready.get(lane, 0) < window:
            self._ready[lane] = window
            self._ready_marked.add((lane, window))
            if self._trace.enabled:
                self._trace.record(
                    "barrier.ready", cat="lanes", key=(window,),
                    args={"lane": lane, "seq": seq_no_end, "node": node})
        self._ready_at.setdefault(window, self._clock())
        self._advance()
        if window <= self.sealed_window:
            # late offer for an already-sealed window (e.g. a node whose
            # quorum observation lagged the seal): nothing to hold, and
            # the fold already consumed (or idled) this lane's slot
            self._digests.pop((lane, window), None)
            return True
        hkey = (lane, window, node)
        if hkey not in self._held:
            self._held[hkey] = release
            self._held_order.append(hkey)
        return False

    def lane_caught_up(self, lane: int, seq_no_end: int) -> None:
        """Catchup moved the lane's stable floor past windows it never
        locally stabilized: the leeched state is pool-verified, so the
        lane is vacuously ready up to that floor."""
        window = self.window_of(seq_no_end)
        if self._ready.get(lane, 0) >= window:
            return
        # every window the jump skips folds as "catchup" (the lane never
        # produced a local digest for it — the leeched state stands in)
        for skipped in range(self._ready.get(lane, 0) + 1, window + 1):
            if skipped > self.sealed_window:
                self._digests.setdefault((lane, skipped), CATCHUP_DIGEST)
        self._ready[lane] = window
        self._ready_marked.add((lane, window))
        self._ready_at.setdefault(window, self._clock())
        if self._trace.enabled:
            # the mark's seq is the WINDOW BOUNDARY, not the raw caught-
            # up pp_seq_no: a mid-window floor (seq 7, CHK_FREQ 2) covers
            # only window 3 (boundary 6), and the causal plane joins a
            # batch's barrier hop on "ready seq >= batch seq" — a raw 7
            # would wrongly claim window 3 covers the seq-7 batch
            self._trace.record(
                "barrier.ready", cat="lanes", key=(window,),
                args={"lane": lane, "seq": window * self.chk_freq,
                      "via": "catchup"})
        self._advance()

    def service_tick(self) -> None:
        """The dispatch tick's barrier pulse: re-evaluate the seal
        condition so a lane that went IDLE since the last offer (its
        probe flips with no new checkpoint to trigger one) unblocks the
        held lanes at a deterministic instant."""
        self._advance()

    # ------------------------------------------------------------------

    def _lane_ready_or_idle(self, lane: int, window: int) -> bool:
        if self._ready.get(lane, 0) >= window:
            return True
        probe = self._idle_probe.get(lane)
        return probe is not None and probe()

    def _advance(self) -> None:
        if self._advancing:
            return  # releases can re-enter through stabilization
        self._advancing = True
        try:
            while self._held or self._seal_next_possible():
                target = self.sealed_window + 1
                if not all(self._lane_ready_or_idle(lane, target)
                           for lane in range(self.lanes)):
                    break
                self._seal(target)
                self._release_upto(self.sealed_window)
        finally:
            self._advancing = False

    def _seal_next_possible(self) -> bool:
        """Only seal past the held queue when some lane actually reached
        the next window — vacuous idle-only seals (every lane idle, no
        work anywhere) would otherwise spin the window ordinal forever."""
        target = self.sealed_window + 1
        return any(self._ready.get(lane, 0) >= target
                   for lane in range(self.lanes))

    def _seal(self, window: int) -> None:
        digests = [self._digests.pop((lane, window), IDLE_DIGEST)
                   for lane in range(self.lanes)]
        fold = hashlib.sha256(
            ("%s|%d|%s" % (self.seal_fingerprint, window,
                           "|".join(digests))).encode()).hexdigest()
        self.sealed_window = window
        self.seal_fingerprint = fold
        self.fingerprints[window] = fold
        self.seal_digests[window] = digests
        self.seals += 1
        if self.keep > 0:
            floor = window - self.keep
            for old in [w for w in self.seal_digests if w <= floor]:
                del self.seal_digests[old]
                self._ready_at.pop(old, None)
            # keep the fingerprint ONE window below the digest floor:
            # it seeds the retained-chain recomputation
            for old in [w for w in self.fingerprints if w < floor]:
                del self.fingerprints[old]
            self._ready_marked = {
                key for key in self._ready_marked if key[1] > floor}
            self._digests = {key: d for key, d in self._digests.items()
                             if key[1] > floor}
        now = self._clock()
        lag = now - self._ready_at.get(window, now)
        if self._metrics is not None:
            from ..common.metrics_collector import MetricsName

            self._metrics.add_event(MetricsName.LANE_SEALED_WINDOW, window)
            self._metrics.add_event(MetricsName.LANE_BARRIER_SEAL_LAG, lag)
        if self._trace.enabled:
            ready_lanes = sorted(
                lane for lane in range(self.lanes)
                if (lane, window) in self._ready_marked)
            self._trace.record(
                "barrier.sealed", cat="lanes", key=(window,),
                args={"fingerprint": fold, "lanes": self.lanes,
                      "ready_lanes": ready_lanes,
                      "lag": round(lag, 9)})

    def _release_upto(self, window: int) -> None:
        due = [k for k in self._held_order if k[1] <= window]
        self._held_order = [k for k in self._held_order if k[1] > window]
        for key in due:
            release = self._held.pop(key)
            release()

    # ------------------------------------------------------------------

    def sized_resources(self, prefix: str = "barrier."):
        """Resource-ledger registration (observability.telemetry): the
        sealed-window records (bounded by ``keep``; keep=0 retains
        everything by design — the leak law still watches it) and the
        held-open in-flight window state."""
        from ..observability.telemetry import SizedResource

        bound = self.keep if self.keep > 0 else None
        return (
            SizedResource(prefix + "seal_digests",
                          lambda: len(self.seal_digests),
                          bound=bound, entry_bytes=256),
            SizedResource(prefix + "fingerprints",
                          lambda: len(self.fingerprints),
                          bound=bound, entry_bytes=128),
            SizedResource(prefix + "held", lambda: len(self._held),
                          bound=None, entry_bytes=128),
        )

    def counters(self) -> dict:
        return {
            "lanes": self.lanes,
            "sealed_window": self.sealed_window,
            "seals": self.seals,
            "seal_fingerprint": self.seal_fingerprint,
            "ready_window_per_lane": [self._ready.get(lane, 0)
                                      for lane in range(self.lanes)],
            "held": len(self._held),
        }
