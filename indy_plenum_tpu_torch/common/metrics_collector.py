"""Metrics: named event accumulators + timing around the hot paths.

Copy of ``MetricsCollector`` from
``indy_plenum_tpu/common/metrics_collector.py`` (reference:
plenum/common/metrics_collector.py), with the ``MetricsName`` members the
vote plane writes. Every event is (name, value); the
collector keeps running count/sum/min/max/last per name.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Any, Dict, Optional


class MetricsName:
    DEVICE_FLUSH = "device.flush"
    DEVICE_FLUSH_TIME = "device.flush_time"
    DEVICE_FLUSH_VOTES = "device.flush_votes"
    DEVICE_FLUSH_OCCUPANCY = "device.flush_occupancy"
    # bytes crossing the device->host boundary per absorb, and the eval
    # mode as a gauge (1 = compact/device eval, 0 = host eval)
    DEVICE_READBACK_BYTES = "device.readback_bytes"
    DEVICE_READBACK_COMPACT = "device.readback_compact"


class Stat:
    __slots__ = ("count", "total", "min", "max", "last")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.last: Optional[float] = None

    def add(self, value: float) -> None:
        self.count += 1
        self.total += value
        self.min = value if self.min is None else min(self.min, value)
        self.max = value if self.max is None else max(self.max, value)
        self.last = value

    @property
    def avg(self) -> float:
        return self.total / self.count if self.count else 0.0

    def as_dict(self) -> Dict[str, Any]:
        return {"count": self.count, "sum": self.total, "avg": self.avg,
                "min": self.min, "max": self.max, "last": self.last}


class MetricsCollector:
    def __init__(self):
        self._stats: Dict[str, Stat] = {}

    def add_event(self, name: str, value: float = 1.0) -> None:
        stat = self._stats.get(name)
        if stat is None:
            stat = self._stats[name] = Stat()
        stat.add(value)

    def stat(self, name: str) -> Optional[Stat]:
        return self._stats.get(name)

    def summary(self) -> Dict[str, Dict[str, Any]]:
        return {name: s.as_dict() for name, s in sorted(self._stats.items())}

    @contextmanager
    def measure_time(self, name: str):
        """Time the body into ``name``; a body that raises lands under
        ``<name>.error`` instead, so failures never pollute the hot-path
        latency stats."""
        t0 = time.perf_counter()
        try:
            yield
        except BaseException:
            self.add_event(name + ".error", time.perf_counter() - t0)
            raise
        else:
            self.add_event(name, time.perf_counter() - t0)

