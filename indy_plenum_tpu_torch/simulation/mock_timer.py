"""Virtual clock for deterministic protocol testing.

Reference: plenum/common/timer.py MockTimer + stp_core's looper-driven time.
Advancing the clock fires due callbacks; nothing real-time anywhere, so a
whole multi-node pool runs deterministically in-process (SURVEY.md §4
tier 5).

Copy of ``indy_plenum_tpu/simulation/mock_timer.py``, with its imports bound
to the port.
"""
from __future__ import annotations

from ..common.timer import QueueTimer


class MockTimer(QueueTimer):
    def __init__(self, start_time: float = 0.0):
        self._now = start_time
        super().__init__(get_current_time=lambda: self._now)

    def set_time(self, value: float) -> None:
        """Jump the clock forward, firing everything due on the way."""
        events = self._events  # peek the heap directly: one pass per due
        # event, not a next_event_time() + service() pair per timestamp
        # (cancelled heads are popped unfired by service() itself)
        while events and events[0].timestamp <= value:
            self._now = events[0].timestamp
            self.service()
        self._now = value
        self.service()

    def advance(self, seconds: float = 0.0) -> None:
        self.set_time(self._now + seconds)

    def run_to_completion(self, max_time: float = 3600.0) -> None:
        """Fire events (and the events they schedule) until quiescent."""
        while True:
            nxt = self.next_event_time()
            if nxt is None or nxt > max_time:
                break
            self.set_time(nxt)
