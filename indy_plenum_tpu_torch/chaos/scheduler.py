"""Compile a :class:`FaultPlan` into virtual-timer events + run a trace.

The scheduler is the deterministic bridge between a plan and the live
pool: every fault begin/end becomes a :class:`MockTimer` event, every
application is appended to an ``(virtual_time, description)`` trace, and
an optional safety probe (the invariant checker's non-liveness checks)
runs on a repeating virtual timer DURING the run — a violation is caught
at the moment it happens, with its timestamp, not just post-mortem.
Same pool seed + same plan ⇒ identical trace, identical pool history.

Copy of ``indy_plenum_tpu/chaos/scheduler.py``, with its imports bound to
the port.
"""
from __future__ import annotations

import random
from typing import Any, Callable, List, Optional, Tuple

from ..common.timer import RepeatingTimer
from ..observability.trace import NULL_TRACE
from .faults import Fault, FaultContext, FaultPlan


class FaultScheduler:
    def __init__(self, pool: Any, plan: FaultPlan,
                 safety_probe: Optional[Callable[[], List]] = None,
                 probe_interval: float = 1.0):
        self.pool = pool
        self.plan = plan
        self.rng = random.Random(plan.seed)
        self.trace: List[Tuple[float, str]] = []
        # flight recorder: fault begin/end marks ride the pool's span
        # trace too (cat "chaos"), and the FIRST safety violation dumps
        # the trace tail — the run's forensic record at the moment it
        # went wrong, not just post-mortem
        pool_trace = getattr(pool, "trace", None)
        self._span_trace = pool_trace if pool_trace is not None \
            else NULL_TRACE
        self.active_faults = 0
        self.probe_results: List[Tuple[float, bool]] = []
        self.first_violation: Optional[Tuple[float, str]] = None
        self._safety_probe = safety_probe
        self._probe_timer: Optional[RepeatingTimer] = None
        self._probe_interval = probe_interval
        self._ctx = FaultContext(
            pool=pool, network=pool.network, timer=pool.timer,
            rng=self.rng, trace=self._record)

    # --- trace ----------------------------------------------------------

    def _record(self, event: str) -> None:
        self.trace.append((self.pool.timer.get_current_time(), event))
        if self._span_trace.enabled:
            self._span_trace.record(event, cat="chaos")

    # --- wiring ---------------------------------------------------------

    def install(self) -> "FaultScheduler":
        """Schedule every fault's begin (and bounded end) on the pool's
        virtual clock, relative to now. Idempotent per plan instance is
        NOT attempted — install once."""
        for fault in self.plan.faults:
            self.pool.timer.schedule(
                fault.at, lambda f=fault: self._begin(f))
        if self._safety_probe is not None:
            self._probe_timer = RepeatingTimer(
                self.pool.timer, self._probe_interval, self._run_probe)
        return self

    def stop_probe(self) -> None:
        if self._probe_timer is not None:
            self._probe_timer.stop()

    def _begin(self, fault: Fault) -> None:
        undo = fault.begin(self._ctx)
        self.active_faults += 1
        self._record("begin " + fault.describe())
        metrics = getattr(self.pool, "metrics", None)
        if metrics is not None:
            from ..common.metrics_collector import MetricsName

            metrics.add_event(MetricsName.CHAOS_FAULTS_BEGUN)
        if fault.duration is not None:
            self.pool.timer.schedule(
                fault.duration, lambda: self._end(fault, undo))

    def _end(self, fault: Fault, undo) -> None:
        if undo is not None:
            undo()
        self.active_faults -= 1
        self._record("end " + fault.describe())

    def _run_probe(self) -> None:
        results = self._safety_probe()
        ok = all(r.passed for r in results)
        self.probe_results.append(
            (self.pool.timer.get_current_time(), ok))
        if not ok and self.first_violation is None:
            failed = "; ".join(r.name for r in results if not r.passed)
            self.first_violation = (
                self.pool.timer.get_current_time(), failed)
            self._record("safety violation: " + failed)
            if self._span_trace.enabled:
                self._span_trace.trigger_dump("invariant_violation",
                                              args={"failed": failed})
