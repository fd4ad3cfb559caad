"""Long-horizon telemetry plane: resource ledger, windowed rollups and
deterministic drift detection.

RBFT's defining mechanism is *monitoring* — the protocol continuously
measures instance throughput and acts on degradation (Aublin et al.,
RBFT, ICDCS 2013) — so telemetry here is a first-class plane, not a log
sink. Three layers:

1. **Resource ledger** (:class:`ResourceLedger`): every bounded
   structure in the system registers a :class:`SizedResource` (name,
   live entry count, declared bound, approx bytes/entry) — trace rings,
   proof/edge cache windows, barrier seal records, admission queues,
   retry cohorts, LRU node/path caches, metrics histograms. One
   ``snapshot()`` reports current/high-water occupancy for the whole
   pool, and a structure exceeding its declared bound is a **hard
   violation** surfaced as an anomaly, not a log line.

2. **Windowed rollups** (:class:`TelemetryPlane`): bounded
   per-virtual-interval time-series rings — ordered/shed/retry deltas,
   e2e p99 from virtual-clock phase latency, governor occupancy EWMA,
   per-resource window high-waters — rolled at window boundaries
   reached through checkpoint-stabilization / ordered-event pulses.
   Every row is a pure function of virtual time and existing counters,
   so same-seed runs produce byte-identical rollup streams; the running
   ``telemetry_hash`` folds each row (and each anomaly) into a sha256
   chain exactly like the barrier's seal-fingerprint chain, so the
   fingerprint survives ring eviction with O(1) state.

3. **Drift detector**: deterministic window-over-window laws —
   throughput drift (ordered delta drops more than ``drift_frac``
   against the same-phase window ``drift_lag`` back), the leak law
   (a resource's window high-water strictly increasing for
   ``leak_windows`` consecutive windows), and latency creep (p99
   strictly increasing the same way). Each law fires the flight
   recorder's ``trigger_dump`` (bounded, once per episode), counts
   ``telemetry.anomalies``, and folds the anomaly record into the hash
   chain.

The plane's own rings (windows, anomalies, latency samples) register in
the ledger like everyone else — the monitor is not exempt from the
bounded-everything contract it enforces.

Copy of ``indy_plenum_tpu/observability/telemetry.py``, with its imports
bound to the port. It is host code: it reads sizes and counters, never a
tensor.
"""
from __future__ import annotations

import hashlib
import json
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from ..common.metrics_collector import MetricsName
from .trace import percentile

# per-window bound on the e2e latency sample ring: one sample per
# executed batch per connected node, cleared at each roll — 4096 covers
# minutes of saturated ordering between rolls; overflow drops newest
# (counted), never grows
LATENCY_SAMPLES_MAX = 4096

# metric name prefix for per-resource gauges (Stat.last = current at
# the latest roll, Stat.max = high-water over rolls); the monitor's
# telemetry block enumerates the collector summary by this prefix
RESOURCE_METRIC_PREFIX = "telemetry.resource."


@dataclass(frozen=True)
class SizedResource:
    """One bounded structure's registration: ``entries`` is a cheap O(1)
    occupancy probe, ``bound`` the structure's *declared* cap (None =
    intentionally unbounded here — still watched by the leak law), and
    ``entry_bytes`` a rough per-entry size for the byte estimate.
    ``ring=True`` declares a retention ring that fills to its maxlen BY
    CONSTRUCTION (trace rings, rollup rings): monotone growth is its
    design, so the leak law skips it — the bound-violation law still
    covers it."""

    name: str
    entries: Callable[[], int]
    bound: Optional[int] = None
    entry_bytes: int = 64
    ring: bool = False


class ResourceLedger:
    """The pool-wide occupancy register. ``sample()`` probes every
    resource (O(#resources), a handful of ``len()`` calls — safe on the
    ordered-event hot path) and maintains three views: current, running
    high-water, and per-window high-water (reset at each rollup)."""

    def __init__(self) -> None:
        self._resources: "Dict[str, SizedResource]" = {}
        self._current: Dict[str, int] = {}
        self._high_water: Dict[str, int] = {}
        self._window_hw: Dict[str, int] = {}

    def register(self, resource: SizedResource) -> None:
        if resource.name in self._resources:
            raise ValueError(f"resource {resource.name!r} already "
                             "registered (ledger names are unique)")
        self._resources[resource.name] = resource

    def register_all(self, resources: Iterable[SizedResource]) -> None:
        for res in resources:
            self.register(res)

    @property
    def names(self) -> List[str]:
        return sorted(self._resources)

    def is_ring(self, name: str) -> bool:
        res = self._resources.get(name)
        return res is not None and res.ring

    def sample(self) -> List[str]:
        """Probe every resource; returns the (usually empty) list of
        bound violations ``name entries=N over bound=B``."""
        violations: List[str] = []
        for name in self._resources:
            res = self._resources[name]
            cur = int(res.entries())
            self._current[name] = cur
            if cur > self._high_water.get(name, 0):
                self._high_water[name] = cur
            if cur > self._window_hw.get(name, 0):
                self._window_hw[name] = cur
            if res.bound is not None and cur > res.bound:
                violations.append(
                    f"{name} entries={cur} over bound={res.bound}")
        return violations

    def window_high_water(self) -> Dict[str, int]:
        """Per-resource high-water since the last :meth:`reset_window`
        (sorted keys — this dict feeds the hash chain)."""
        return {name: self._window_hw.get(name, 0)
                for name in sorted(self._resources)}

    def reset_window(self) -> None:
        self._window_hw = {}

    def current(self, name: str) -> int:
        return self._current.get(name, 0)

    def high_water(self, name: str) -> int:
        return self._high_water.get(name, 0)

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Current/high-water/bound/approx-bytes per resource, sorted by
        name — the monitor's telemetry block and the soak report both
        read this."""
        out: Dict[str, Dict[str, Any]] = {}
        for name in sorted(self._resources):
            res = self._resources[name]
            cur = self._current.get(name, 0)
            out[name] = {
                "entries": cur,
                "high_water": self._high_water.get(name, 0),
                "bound": res.bound,
                "approx_bytes": cur * res.entry_bytes,
            }
        return out


def _canon(obj: Any) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


class TelemetryPlane:
    """Windowed rollups + drift laws over a :class:`ResourceLedger`.

    Driven by ``pulse(now)`` from deterministic virtual-time hooks
    (checkpoint stabilization, ordered events, end-of-run finalize):
    each pulse samples the ledger and rolls every window boundary the
    virtual clock has crossed. Rows and anomalies fold into the running
    ``telemetry_hash`` chain; both rings are bounded and registered in
    the ledger themselves."""

    def __init__(self, ledger: ResourceLedger, t0: float,
                 window_sec: float, keep: int = 64,
                 leak_windows: int = 4, leak_grace: int = 6,
                 drift_frac: float = 0.5, drift_lag: int = 1,
                 anomaly_keep: int = 32,
                 metrics=None, trace=None) -> None:
        if window_sec <= 0:
            raise ValueError("window_sec must be positive (0 = leave "
                             "the plane unarmed instead)")
        self.ledger = ledger
        self.t0 = float(t0)
        self.window_sec = float(window_sec)
        self.leak_windows = max(1, int(leak_windows))
        self.leak_grace = max(0, int(leak_grace))
        self.drift_frac = float(drift_frac)
        self.drift_lag = max(1, int(drift_lag))
        self.metrics = metrics
        self.trace = trace
        self.windows: "deque[dict]" = deque(maxlen=max(1, int(keep)))
        self.anomalies: "deque[dict]" = deque(maxlen=max(1, int(anomaly_keep)))
        self.completed = 0  # windows rolled so far (ring may have evicted)
        self.anomaly_count = 0  # total fired (ring may have evicted)
        self._hash = hashlib.sha256(b"telemetry").hexdigest()
        self._counters: "Dict[str, Callable[[], int]]" = {}
        self._gauges: "Dict[str, Callable[[], float]]" = {}
        self._prev_counts: Dict[str, int] = {}
        # e2e latency samples (virtual seconds, ppTime -> executed),
        # cleared each roll; overflow drops newest and counts
        self._lat: "deque[float]" = deque(maxlen=LATENCY_SAMPLES_MAX)
        self._lat_dropped = 0
        # drift-law episode state
        self._ordered_ring: "deque[int]" = deque(maxlen=self.drift_lag + 1)
        self._drift_armed = True
        self._leak_streak: Dict[str, int] = {}
        self._leak_fired: Dict[str, bool] = {}
        self._prev_window_hw: Dict[str, int] = {}
        self._lat_streak = 0
        self._lat_fired = False
        self._prev_p99: Optional[float] = None
        self._violated: set = set()
        ledger.register_all(self.sized_resources())

    @classmethod
    def from_config(cls, config, ledger: ResourceLedger, t0: float,
                    metrics=None, trace=None) -> Optional["TelemetryPlane"]:
        """Composition-root constructor: None unless armed
        (``TelemetryWindowSec`` > 0) — the common path pays nothing."""
        if config.TelemetryWindowSec <= 0:
            return None
        return cls(ledger, t0,
                   window_sec=config.TelemetryWindowSec,
                   keep=config.TelemetryWindowKeep,
                   leak_windows=config.TelemetryLeakWindows,
                   leak_grace=config.TelemetryLeakGraceWindows,
                   drift_frac=config.TelemetryDriftFrac,
                   drift_lag=config.TelemetryDriftLag,
                   anomaly_keep=config.TelemetryAnomalyKeep,
                   metrics=metrics, trace=trace)

    def sized_resources(self, prefix: str = "telemetry.") -> \
            Tuple[SizedResource, ...]:
        return (
            SizedResource(prefix + "windows", lambda: len(self.windows),
                          bound=self.windows.maxlen, entry_bytes=512,
                          ring=True),
            SizedResource(prefix + "anomalies",
                          lambda: len(self.anomalies),
                          bound=self.anomalies.maxlen, entry_bytes=256,
                          ring=True),
            SizedResource(prefix + "latency_samples",
                          lambda: len(self._lat),
                          bound=self._lat.maxlen, entry_bytes=8,
                          ring=True),
        )

    # --- series wiring --------------------------------------------------

    def add_counter(self, name: str, fn: Callable[[], int]) -> None:
        """Register a cumulative counter; rollups record per-window
        deltas."""
        self._counters[name] = fn

    def add_gauge(self, name: str, fn: Callable[[], float]) -> None:
        """Register a point-in-time gauge sampled at each roll."""
        self._gauges[name] = fn

    def observe_latency(self, seconds: float) -> None:
        """One e2e sample (virtual pre-prepare -> executed); p99 per
        window. Bounded: past the ring cap newest samples drop
        (counted) rather than grow."""
        if len(self._lat) == self._lat.maxlen:
            self._lat_dropped += 1
            return
        self._lat.append(float(seconds))

    # --- the pulse ------------------------------------------------------

    def pulse(self, now: float) -> None:
        """Sample the ledger, surface bound violations, roll every
        window boundary crossed. Deterministic: everything is a pure
        function of virtual ``now`` and registered probes."""
        for violation in self.ledger.sample():
            name = violation.split(" ", 1)[0]
            if name not in self._violated:
                self._violated.add(name)
                self._anomaly("bound_violation", self.completed,
                              {"resource": name, "detail": violation})
        while self.t0 + (self.completed + 1) * self.window_sec <= now:
            self._roll()

    def finalize(self, now: float) -> None:
        """End-of-run flush: roll all fully elapsed windows (a trailing
        partial window is dropped — deterministically)."""
        self.pulse(now)

    def _roll(self) -> None:
        w = self.completed
        counts = {name: int(fn()) for name, fn in self._counters.items()}
        deltas = {name: counts[name] - self._prev_counts.get(name, 0)
                  for name in counts}
        gauges = {name: float(fn()) for name, fn in self._gauges.items()}
        hw = self.ledger.window_high_water()
        self.ledger.reset_window()
        p99 = percentile(sorted(self._lat), 99) if self._lat else None
        self._lat.clear()
        row = {
            "window": w,
            "t_end": self.t0 + (w + 1) * self.window_sec,
            "counters": deltas,
            "gauges": gauges,
            "p99": p99,
            "high_water": hw,
            "lat_dropped": self._lat_dropped,
        }
        self._lat_dropped = 0
        self.windows.append(row)
        self._fold({"row": row})
        if self.trace is not None:
            # one compact mark per roll: a flight dump then carries the
            # rollup series, and trace_tool --rollups rebuilds the
            # window table from the dump alone (largest resource named
            # so a leak suspect is visible without the full ledger)
            top = max(hw, key=lambda n: (hw[n], n)) if hw else None
            self.trace.record(
                "telemetry.roll", cat="telemetry",
                args={"window": w, "ordered": deltas.get("ordered"),
                      "shed": deltas.get("shed"),
                      "retry": deltas.get("retry"), "p99": p99,
                      "hw_total": sum(hw.values()),
                      "hw_top": top,
                      "hw_top_entries": hw.get(top, 0) if top else 0,
                      "lat_dropped": row["lat_dropped"]})
        self._prev_counts = counts
        self.completed = w + 1
        if self.metrics is not None:
            self.metrics.add_event(MetricsName.TELEMETRY_WINDOWS, 1)
            for name, value in hw.items():
                self.metrics.add_event(RESOURCE_METRIC_PREFIX + name,
                                       value)
        self._law_throughput(w, deltas)
        self._law_leak(w, hw)
        self._law_latency(w, p99)

    # --- drift laws -----------------------------------------------------

    def _law_throughput(self, w: int, deltas: Dict[str, int]) -> None:
        """Ordered-throughput drift vs the same-phase window
        ``drift_lag`` back (set the lag to profile-period/window so a
        diurnal trough never reads as drift). Shares the warm-up grace
        with the other laws: early windows hold pre-steady-state load
        (a soak's key-warming burst) that is no reference for drift."""
        cur = deltas.get("ordered")
        if cur is None:
            return
        self._ordered_ring.append(cur)
        if len(self._ordered_ring) <= self.drift_lag or w < self.leak_grace:
            return
        ref = self._ordered_ring[0]
        drifted = ref > 0 and (ref - cur) / ref > self.drift_frac
        if drifted and self._drift_armed:
            self._drift_armed = False
            self._anomaly("throughput_drift", w,
                          {"ordered": cur, "reference": ref,
                           "lag": self.drift_lag})
        elif not drifted:
            self._drift_armed = True

    def _law_leak(self, w: int, hw: Dict[str, int]) -> None:
        """The leak law: a resource's window high-water strictly
        increasing for ``leak_windows`` consecutive windows (after the
        warm-up grace) is a leak, bounded or not — one anomaly per
        episode, re-armed by any non-increasing window."""
        for name, value in hw.items():
            if self.ledger.is_ring(name):
                # retention rings (trace ring, the plane's own rollup
                # rings) grow one entry per event BY CONSTRUCTION until
                # their maxlen — monotone growth is their design, not a
                # leak; the bound-violation law still covers them
                continue
            prev = self._prev_window_hw.get(name)
            if prev is not None and value > prev and w >= self.leak_grace:
                self._leak_streak[name] = self._leak_streak.get(name, 0) + 1
            else:
                self._leak_streak[name] = 0
                self._leak_fired[name] = False
            if (self._leak_streak[name] >= self.leak_windows
                    and not self._leak_fired.get(name)):
                self._leak_fired[name] = True
                self._anomaly("resource_leak", w,
                              {"resource": name, "high_water": value,
                               "streak": self._leak_streak[name]})
        self._prev_window_hw = dict(hw)

    def _law_latency(self, w: int, p99: Optional[float]) -> None:
        """Latency creep: window p99 strictly increasing for
        ``leak_windows`` consecutive windows."""
        prev = self._prev_p99
        if p99 is not None and prev is not None and p99 > prev \
                and w >= self.leak_grace:
            self._lat_streak += 1
        else:
            self._lat_streak = 0
            self._lat_fired = False
        if self._lat_streak >= self.leak_windows and not self._lat_fired:
            self._lat_fired = True
            self._anomaly("latency_creep", w,
                          {"p99": p99, "streak": self._lat_streak})
        if p99 is not None:
            self._prev_p99 = p99

    def _anomaly(self, law: str, window: int, detail: Dict[str, Any]) \
            -> None:
        rec = {"law": law, "window": window}
        rec.update(detail)
        self.anomalies.append(rec)
        self.anomaly_count += 1
        self._fold({"anomaly": rec})
        if self.metrics is not None:
            self.metrics.add_event(MetricsName.TELEMETRY_ANOMALIES, 1)
        if self.trace is not None:
            self.trace.trigger_dump("telemetry." + law, args=rec)

    def _fold(self, entry: Dict[str, Any]) -> None:
        # the seal-fingerprint pattern (lanes/barrier.py): a running
        # sha256 chain keeps the fingerprint byte-stable with O(1)
        # state even after the bounded rings evict
        self._hash = hashlib.sha256(
            ("%s|%s" % (self._hash, _canon(entry))).encode()).hexdigest()

    # --- reading --------------------------------------------------------

    @property
    def telemetry_hash(self) -> str:
        """Chain tip over every rolled row and fired anomaly, in order —
        byte-identical across same-seed runs like ``ordered_hash``."""
        return self._hash

    def snapshot(self) -> Dict[str, Any]:
        return {
            "windows": self.completed,
            "anomalies": self.anomaly_count,
            "anomaly_tail": list(self.anomalies),
            "bound_violations": sorted(self._violated),
            "telemetry_hash": self._hash,
            "resources": self.ledger.snapshot(),
        }
