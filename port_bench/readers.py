"""Arithmetic the metric readers under ``metrics/`` share. A reader takes
the run's view (``run.RunView``) and returns a number, or ``None`` where
the run has nothing for it to read; the harness then leaves the metric
out of the line. A share of a roofline or of the window is never made up
as 0.
"""
from __future__ import annotations

import math
from typing import List, Optional

from .roofline import bound_s, k7_work, k10_work, kc_work


def acked_in_window(run) -> list:
    return [w for w in run.writes if w.outcome == "acked" and not w.corrupt
            and w.t_done <= run.t_end]


def proved_in_window(run) -> list:
    return [r for r in run.reads if r.served is not None
            and r.t_done <= run.t_end and r.served.verified
            and r.served.multi_sig is not None]


def percentile(values: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile; ``None`` for no values."""
    if not values:
        return None
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)]


def latency_p95_ms(done: list) -> Optional[float]:
    return percentile([(x.t_done - x.t_sent) * 1e3 for x in done], 95.0)


def time_share(run, stat: str) -> Optional[float]:
    """Percent of the window's wall time inside the program's timed
    region ``stat`` (its ``perf_counter`` sum over the window)."""
    count, total = run.stat(stat)
    return 100.0 * total / run.seconds if count else None


def mean(run, stat: str) -> Optional[float]:
    count, total = run.stat(stat)
    return total / count if count else None


def per_batch(run, count: float) -> Optional[float]:
    return count / run.batches if run.batches else None


def roofline(run, family: str) -> Optional[float]:
    """Percent of the device time the family's kernels took in the traced
    window that the frozen bound says they need at least, summed over
    the launches the window made."""
    trace = run.trace
    if trace is None or not trace.shapes.get(family):
        return None
    device_s = trace.family_s(family)
    if device_s <= 0:
        return None
    work = {"kc": kc_work, "k7": k7_work, "k10": k10_work}[family]
    need = sum(bound_s(*work(*shape)) for shape in trace.shapes[family])
    return 100.0 * need / device_s


def idle_share(run) -> Optional[float]:
    trace = run.trace
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
