"""Dispatch governor: occupancy-driven closed-loop control of the tick.

A static ``QuorumTickInterval`` freezes the dispatch plane's tick.
That interval is a throughput/latency dial with no single right setting:
too wide and a 3PC wave waits most of a tick for its quorum verdicts
(the bounded in-flight batch window stalls the pipeline); too narrow
and an idle or
trickling pool pays a near-empty padded scatter per tick. RBFT's
throughput case (Aublin et al., ICDCS 2013) and the pipelined-BFT designs
(HotStuff, PODC 2019) both point the same way: the win is keeping device
and host phases overlapped WITHOUT paying per-message dispatch — which
makes the tick interval a control variable, not a constant.

:class:`DispatchGovernor` closes the loop over the metrics the dispatch
plane already measures (``device.flush_occupancy``,
``device.dispatches_per_tick``):

- **narrow** while a tick chains more than one grouped step (its votes
  overflowed the top ``FLUSH_LADDER`` rung — splitting the same votes
  across more ticks costs no extra dispatches and cuts quorum latency),
  or while the occupancy EWMA runs above ``GovernorOccupancyHigh``;
- **widen** while the EWMA sits below ``GovernorOccupancyLow`` (sparse
  ticks: a wider tick coalesces the same trickle of votes into fewer,
  fuller scatters);
- **hold** in between.

The equilibrium is the dispatch plane's own contract: one tick ≈ one
grouped device step, as full as the workload allows.

Determinism: ``observe`` is a pure function of the metric sequence (EWMA
state + multiplicative steps clamped to configured bounds — no wall
clock, no randomness), so a seeded run (including chaos-scheduled fault
runs) replays to the *identical* interval trajectory. The trajectory is
itself an artifact: every observation lands in the metrics collector
(``governor.tick_interval`` stat + histogram, ``governor.occupancy_ewma``)
and in :attr:`trajectory` for bench/report digests.

Copy of ``indy_plenum_tpu/tpu/governor.py``, with its imports bound to the
port.
"""
from __future__ import annotations

from collections import deque
from typing import Optional

from ..common.metrics_collector import MetricsCollector, MetricsName
from ..observability.trace import NULL_TRACE

# retained trajectory window: full fidelity for any bench/test-sized run,
# bounded for a deployed node governing ticks for days (at the default
# floor of base/4 this is hours of history; the running min/max and the
# metrics stat/histogram keep whole-run aggregates exact)
TRAJECTORY_WINDOW = 65536

# governor anomaly (flight-recorder trigger): the law has pinned the
# interval at its floor for this many consecutive ticks while the
# saturation signal persists — the controller can no longer relieve the
# load, which is exactly the moment a trace tail is worth keeping
ANOMALY_SATURATED_TICKS = 8


class DispatchGovernor:
    """Deterministic EWMA controller for the quorum tick interval."""

    def __init__(self, interval: float, min_interval: float,
                 max_interval: float, alpha: float = 0.3,
                 occupancy_low: float = 0.02, occupancy_high: float = 0.85,
                 widen: float = 1.5, narrow: float = 0.5,
                 backpressure_queue_frac: float = 0.5,
                 metrics: Optional[MetricsCollector] = None,
                 trace=None):
        if not (0.0 < min_interval <= max_interval):
            raise ValueError(
                f"bad governor bounds [{min_interval}, {max_interval}]")
        if not (0.0 < alpha <= 1.0):
            raise ValueError(f"alpha must be in (0, 1]: {alpha}")
        if widen <= 1.0 or not (0.0 < narrow < 1.0):
            raise ValueError(f"bad step factors widen={widen} narrow={narrow}")
        self.min_interval = float(min_interval)
        self.max_interval = float(max_interval)
        self.interval = min(max(float(interval), self.min_interval),
                            self.max_interval)
        self.alpha = float(alpha)
        self.occupancy_low = float(occupancy_low)
        self.occupancy_high = float(occupancy_high)
        self.widen = float(widen)
        self.narrow = float(narrow)
        self.backpressure_queue_frac = float(backpressure_queue_frac)
        # absorb clamp (ordering fast path, pipelined-by-default): while
        # a dispatched step's verdicts are still in flight, the NEXT
        # tick exists to absorb work already paid for — an absorb tick
        # with no new votes dispatches nothing, so holding it at the
        # governor-widened interval buys no amortization and costs a
        # full wide tick of quorum latency at burst onset. The clamp
        # caps the EFFECTIVE interval at the configured base while
        # ``inflight`` is reported; the law's own interval state is
        # untouched, so the occupancy trajectory is unchanged.
        self.absorb_interval = self.interval
        self.absorb_clamps = 0
        # ingress backpressure (ingress/admission.BackpressureSignal):
        # fed once per tick by the ingress drain, consumed by the NEXT
        # observe call. None = no signal — the law is then bit-identical
        # to the occupancy-only law.
        self._backpressure = None
        self.backpressure_narrows = 0
        self.backpressure_widens = 0
        self.backpressure_holds = 0
        self.ewma: Optional[float] = None  # occupancy EWMA (None = cold)
        # per-shard EWMAs (mesh-sharded dispatch plane): one series per
        # shard, all fed the same law; ``ewma`` above is always the
        # HOTTEST shard's value (with one shard they coincide, which is
        # exactly the single-plane behaviour)
        self.shard_ewmas: Optional[list] = None
        self.ticks = 0
        # interval AFTER each observation (bounded recent window); the
        # running extremes below stay exact over the whole run
        self.trajectory: "deque[float]" = deque(maxlen=TRAJECTORY_WINDOW)
        self._interval_low: Optional[float] = None
        self._interval_high: Optional[float] = None
        self.metrics = metrics if metrics is not None else MetricsCollector()
        # flight recorder: saturation anomalies dump the trace tail
        self.trace = trace if trace is not None else NULL_TRACE
        self._saturated_ticks = 0
        self.anomalies = 0

    # ------------------------------------------------------------------

    def observe(self, votes: int, capacity: int, dispatches: int,
                inflight: bool = False) -> float:
        """Feed one tick's measurements; returns the interval for the NEXT
        tick. ``votes``/``capacity`` are the tick's scattered vote count
        and padded scatter capacity (0/0 for an idle tick — occupancy 0,
        which is what lets an idle pool widen); ``dispatches`` is how many
        grouped device steps the tick chained. ``inflight`` reports a
        pipelined plane's unabsorbed step (``plane.lagging``) — see the
        absorb clamp in :meth:`observe_shards`."""
        return self.observe_shards([votes], [capacity], dispatches,
                                   inflight=inflight)

    def observe_shards(self, votes_per_shard, capacity_per_shard,
                       dispatches: int, inflight: bool = False) -> float:
        """Per-shard variant of :meth:`observe` for the mesh-sharded
        dispatch plane: each shard's occupancy feeds its OWN EWMA, and
        the control law acts on the hottest one — a saturated shard
        narrows the tick for the whole pool even while its siblings
        idle, deterministically (a pool-wide average would let n-1 idle
        shards mask one drowning in votes). With a single shard this is
        bit-for-bit the single-plane law.

        ``inflight`` (ordering fast path): the pipelined plane reports
        that the step it just dispatched carries votes whose verdicts
        ride back NEXT tick. The returned (effective) interval is then
        capped at the configured base interval so the absorb happens
        promptly — measured: without the clamp, a burst landing on a
        governor-widened tick lags its quorum verdicts by a full wide
        interval per 3PC wave (adaptive ordered/sim-sec 2.86 vs static
        3.08 on the budget gate's bursty profile; with it, parity). A
        clamped tick with nothing newly pending absorbs WITHOUT
        dispatching (the pipelined flush skips empty dispatches), so an
        idle pool's amortization is untouched; while a 3PC wave is
        actively chaining, its phases ride the base cadence — the
        deliberate latency-over-coalescing trade (an absorb-only
        variant that deferred new votes to the law tick was measured:
        it kept the dispatch count but put the 7% sim-throughput
        regression right back). The clamp never touches
        ``self.interval`` — the law's trajectory is the pure occupancy
        law either way, and ``inflight=False`` calls are bit-identical
        to the law without the clamp."""
        occs = [v / c if c > 0 else 0.0
                for v, c in zip(votes_per_shard, capacity_per_shard)]
        if not occs:
            occs = [0.0]
        if self.shard_ewmas is None or len(self.shard_ewmas) != len(occs):
            self.shard_ewmas = list(occs)  # cold (or shard-count change)
        else:
            self.shard_ewmas = [
                self.alpha * occ + (1.0 - self.alpha) * ewma
                for occ, ewma in zip(occs, self.shard_ewmas)]
        self.ewma = max(self.shard_ewmas)
        # the signal is popped BEFORE the base law so retry pressure can
        # gate the occupancy widen (below); None / zero-signal paths
        # leave every branch bit-identical to the occupancy-only law
        sig, self._backpressure = self._backpressure, None
        retry_hold = sig is not None and sig.retry_pressure > 0
        saturated = dispatches > 1 or self.ewma >= self.occupancy_high
        if saturated:
            self.interval = max(self.interval * self.narrow,
                                self.min_interval)
        elif self.ewma <= self.occupancy_low:
            # retry-pressure HOLD (overload robustness plane): between
            # shed bursts a retry storm looks calm — the queue drained,
            # occupancy dipped — but the re-offers already sit on the
            # timer. Widening here is the metastable oscillation: wide
            # tick -> the whole backoff cohort lands in one drain ->
            # shed -> narrow -> repeat. While retries are outstanding
            # the law holds its narrow instead of widening; the widen
            # resumes the first tick the storm is actually over.
            if retry_hold:
                self.backpressure_holds += 1
            else:
                self.interval = min(self.interval * self.widen,
                                    self.max_interval)
        # ingress backpressure (the "widen while leeching" hook):
        # queue growth or shedding narrows ON TOP of the occupancy law —
        # draining the auth queue sooner is the only relief the tick can
        # offer — while a leeching pool widens: a node replaying ledger
        # catchup gains nothing from tight ticks, and wider ticks hand
        # the host loop to the leecher. Queue growth outranks leeching
        # (a full queue hurts now; catchup tolerates latency), and
        # leeching outranks the retry hold (seeder throttling protects
        # ordering; the leecher still gets its wide ticks). Narrowing
        # here counts as saturation for the anomaly trigger: pinned at
        # the floor with the queue still growing is exactly the moment a
        # trace tail is worth keeping.
        if sig is not None:
            growth = sig.shed_delta > 0 or (
                sig.capacity > 0 and sig.queue_depth
                >= sig.capacity * self.backpressure_queue_frac)
            if growth:
                self.interval = max(self.interval * self.narrow,
                                    self.min_interval)
                self.backpressure_narrows += 1
                saturated = True
            elif sig.leeching:
                self.interval = min(self.interval * self.widen,
                                    self.max_interval)
                self.backpressure_widens += 1
        # anomaly: pinned at the floor AND still saturated — narrowing
        # can't relieve the load anymore. Fires ONCE per episode (the
        # counter only rearms after a non-saturated tick), deterministic
        # like the rest of the law.
        if saturated and self.interval <= self.min_interval:
            self._saturated_ticks += 1
            if self._saturated_ticks == ANOMALY_SATURATED_TICKS:
                self.anomalies += 1
                if self.trace.enabled:
                    self.trace.trigger_dump(
                        "governor_saturated",
                        args={"ewma": round(self.ewma, 6),
                              "interval": self.interval,
                              "ticks": self.ticks})
        else:
            self._saturated_ticks = 0
        self.ticks += 1
        # absorb clamp: the EFFECTIVE cadence (what the timer runs at)
        # is capped at the base interval while verdicts are in flight;
        # the law's interval state above stays pure occupancy control
        effective = self.interval
        if inflight and effective > self.absorb_interval:
            effective = max(self.absorb_interval, self.min_interval)
            self.absorb_clamps += 1
        self.trajectory.append(effective)
        if self._interval_low is None or effective < self._interval_low:
            self._interval_low = effective
        if self._interval_high is None or effective > self._interval_high:
            self._interval_high = effective
        self.metrics.add_event(MetricsName.GOVERNOR_TICK_INTERVAL,
                               effective)
        self.metrics.add_to_histogram(MetricsName.GOVERNOR_TICK_INTERVAL,
                                      round(effective, 6))
        self.metrics.add_event(MetricsName.GOVERNOR_OCCUPANCY_EWMA,
                               self.ewma)
        if len(self.shard_ewmas) > 1:
            for si, ewma in enumerate(self.shard_ewmas):
                self.metrics.add_event(
                    f"{MetricsName.GOVERNOR_SHARD_OCCUPANCY_EWMA}.{si}",
                    ewma)
        return effective

    def feed_backpressure(self, signal) -> None:
        """Hand the NEXT :meth:`observe`/:meth:`observe_shards` call one
        tick's :class:`~indy_plenum_tpu_torch.ingress.admission
        .BackpressureSignal`. Feeding ``None`` (or never feeding) leaves
        the law bit-identical to the occupancy-only law —
        deterministic either way, since the signal itself is a pure
        function of the seeded workload."""
        self._backpressure = signal

    # ------------------------------------------------------------------

    def trajectory_summary(self) -> dict:
        """The bench/report digest: where the interval travelled (exact
        whole-run extremes; median over the retained window) and where
        the occupancy EWMA settled."""
        if not self.trajectory:
            return {"ticks": 0, "interval_min": self.interval,
                    "interval_median": self.interval,
                    "interval_max": self.interval,
                    "occupancy_ewma": self.ewma}
        ordered = sorted(self.trajectory)
        mid = len(ordered) // 2
        median = ordered[mid] if len(ordered) % 2 else (
            ordered[mid - 1] + ordered[mid]) / 2.0
        out = {
            "ticks": self.ticks,
            "interval_min": round(self._interval_low, 6),
            "interval_median": round(median, 6),
            "interval_max": round(self._interval_high, 6),
            "occupancy_ewma": (round(self.ewma, 6)
                               if self.ewma is not None else None),
            "anomalies": self.anomalies,
        }
        if self.backpressure_narrows or self.backpressure_widens \
                or self.backpressure_holds:
            out["backpressure_narrows"] = self.backpressure_narrows
            out["backpressure_widens"] = self.backpressure_widens
            out["backpressure_holds"] = self.backpressure_holds
        if self.shard_ewmas is not None and len(self.shard_ewmas) > 1:
            out["shards"] = len(self.shard_ewmas)
            out["shard_occupancy_ewma"] = [
                round(e, 6) for e in self.shard_ewmas]
        return out

    @classmethod
    def from_config(cls, config, metrics: Optional[MetricsCollector] = None,
                    trace=None) -> Optional["DispatchGovernor"]:
        """The single wiring point for every tick driver (quorum_driver,
        Node._quorum_tick): None unless tick-batched AND adaptive."""
        if config.QuorumTickInterval <= 0 or not config.QuorumTickAdaptive:
            return None
        lo, hi = config.governor_bounds()
        return cls(config.QuorumTickInterval, lo, hi,
                   alpha=config.GovernorEwmaAlpha,
                   occupancy_low=config.GovernorOccupancyLow,
                   occupancy_high=config.GovernorOccupancyHigh,
                   widen=config.GovernorWiden,
                   narrow=config.GovernorNarrow,
                   backpressure_queue_frac=(
                       config.GovernorBackpressureQueueFrac),
                   metrics=metrics, trace=trace)
