"""Windowed throughput / latency measurement for the RBFT monitor.

Reference: plenum/server/throughput_measurement.py
(`ThroughputMeasurement`, the windowed/EMA variants behind Monitor's
Delta check). Events (ordered requests) are accumulated into fixed-size
time windows; throughput is the event rate over the completed windows
inside the lookback horizon. Until ``min_cnt`` events have been observed
the measurement is None — a fresh instance must not be judged degraded
against an established one (the reference's "revival spike" guard).

Copy of ``indy_plenum_tpu/server/throughput_measurement.py``,
with its imports bound to the port.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Optional, Tuple


class WindowedThroughputMeasurement:
    def __init__(self, window_size: float = 15.0, lookback_windows: int = 4,
                 min_cnt: int = 16, first_ts: float = 0.0):
        self._window = window_size
        self._lookback = lookback_windows
        self._min_cnt = min_cnt
        self._start = first_ts
        self._windows: Deque[Tuple[int, int]] = deque()  # (win_idx, count)
        self._total = 0

    def _win(self, ts: float) -> int:
        return int((ts - self._start) // self._window)

    def add_request(self, ts: float, count: int = 1) -> None:
        w = self._win(ts)
        if self._windows and self._windows[-1][0] == w:
            idx, c = self._windows[-1]
            self._windows[-1] = (idx, c + count)
        else:
            self._windows.append((w, count))
        self._total += count
        self._gc(w)

    def _gc(self, current_win: int) -> None:
        floor = current_win - self._lookback
        while self._windows and self._windows[0][0] < floor:
            self._windows.popleft()

    def get_throughput(self, now: float) -> Optional[float]:
        """Events/sec over the lookback horizon; None until warmed up."""
        if self._total < self._min_cnt:
            return None
        current = self._win(now)
        self._gc(current)
        # completed windows only: the in-progress window undercounts
        counted = sum(c for w, c in self._windows if w < current)
        span = self._lookback * self._window
        return counted / span


class LatencyMeasurement:
    """Average request latency over a sliding event window."""

    def __init__(self, window_count: int = 15):
        self._samples: Deque[float] = deque(maxlen=window_count)

    def add_duration(self, seconds: float) -> None:
        self._samples.append(seconds)

    def get_avg_latency(self) -> Optional[float]:
        if not self._samples:
            return None
        return sum(self._samples) / len(self._samples)
