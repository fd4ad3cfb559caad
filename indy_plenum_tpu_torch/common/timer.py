"""Timer service — the ONLY clock the protocol state machines see.

Reference: plenum/common/timer.py (`TimerService`, `QueueTimer`,
`RepeatingTimer`). Keeping all time behind this interface is what makes the
whole consensus engine deterministic under the simulation harness
(`indy_plenum_tpu_torch.simulation.mock_timer.MockTimer` drives a virtual clock).

Copy of ``indy_plenum_tpu/common/timer.py``, with its imports bound to the
port.
"""
from __future__ import annotations

import time
from abc import ABC, abstractmethod
from heapq import heappush, heappop
from typing import Callable, NamedTuple


class TimerService(ABC):
    """Schedule callbacks against a monotonic clock."""

    @abstractmethod
    def get_current_time(self) -> float:
        ...

    @abstractmethod
    def schedule(self, delay: float, callback: Callable[[], None],
                 barrier: bool = False) -> None:
        ...

    @abstractmethod
    def cancel(self, callback: Callable[[], None]) -> None:
        """Cancel ALL pending occurrences of ``callback``."""
        ...


class _Event(NamedTuple):
    timestamp: float
    # barrier events sort AFTER every plain event due at the same
    # timestamp: the dispatch-plane tick must observe a fully drained
    # delivery set, never race a same-instant message
    priority: int
    counter: int  # tie-break so heap order is deterministic & insertion-stable
    callback: Callable[[], None]


class QueueTimer(TimerService):
    """Heap-based timer; ``service()`` fires everything due at current time."""

    def __init__(self, get_current_time: Callable[[], float] = time.monotonic):
        self._get_current_time = get_current_time
        self._events: list[_Event] = []
        self._cancelled: set[int] = set()
        self._counter = 0

    def get_current_time(self) -> float:
        return self._get_current_time()

    def queue_size(self) -> int:
        return len(self._events) - len(self._cancelled)

    def schedule(self, delay: float, callback: Callable[[], None],
                 barrier: bool = False) -> None:
        """``barrier=True`` defers the event behind every plain event due
        at the same timestamp (the tick-batched dispatch plane's drain
        contract: deliveries first, quorum evaluation after)."""
        self._counter += 1
        heappush(
            self._events,
            _Event(self.get_current_time() + delay, 1 if barrier else 0,
                   self._counter, callback),
        )

    def cancel(self, callback: Callable[[], None]) -> None:
        for ev in self._events:
            if ev.callback == callback and ev.counter not in self._cancelled:
                self._cancelled.add(ev.counter)

    def service(self) -> int:
        """Fire all due events; returns the number fired.

        Only events scheduled before this call are eligible — a 0-delay
        callback rescheduled from inside a callback fires on the NEXT
        service() pass, so a virtual clock that never advances cannot hang
        the loop.
        """
        fired = 0
        now = self.get_current_time()
        counter_at_entry = self._counter
        while (self._events and self._events[0].timestamp <= now
               and self._events[0].counter <= counter_at_entry):
            ev = heappop(self._events)
            if ev.counter in self._cancelled:
                self._cancelled.discard(ev.counter)
                continue
            ev.callback()
            fired += 1
        return fired

    def next_event_time(self) -> float | None:
        while self._events and self._events[0].counter in self._cancelled:
            self._cancelled.discard(self._events[0].counter)
            heappop(self._events)
        return self._events[0].timestamp if self._events else None


class RepeatingTimer:
    """Re-schedules ``callback`` every ``interval`` until stopped.

    Each start() opens a new generation; occurrences from a stopped
    generation never fire or reschedule, so stop()+start() from inside the
    callback (watchdog reset) cannot double the chain.
    """

    def __init__(self, timer: TimerService, interval: float,
                 callback: Callable[[], None], active: bool = True,
                 barrier: bool = False):
        if interval <= 0:
            raise ValueError("interval must be positive")
        self._timer = timer
        self._interval = interval
        self._user_callback = callback
        self._active = False
        self._generation = 0
        self._barrier = barrier
        self._pending: Callable[[], None] | None = None
        if active:
            self.start()

    def _schedule_next(self) -> None:
        generation = self._generation
        def occurrence():
            self._fire(generation)
        self._pending = occurrence
        self._timer.schedule(self._interval, occurrence,
                             barrier=self._barrier)

    def _fire(self, generation: int) -> None:
        if not self._active or generation != self._generation:
            return
        self._user_callback()
        if self._active and generation == self._generation:
            self._schedule_next()

    def start(self) -> None:
        if not self._active:
            self._active = True
            self._generation += 1
            self._schedule_next()

    def stop(self) -> None:
        if self._active:
            self._active = False
            self._generation += 1
            if self._pending is not None:
                self._timer.cancel(self._pending)
                self._pending = None

    @property
    def interval(self) -> float:
        """The CURRENT interval (the dispatch governor retunes it live)."""
        return self._interval

    def update_interval(self, interval: float) -> None:
        """Takes effect at the next (re)schedule: calling this from inside
        the callback — the governor's pattern — retimes the very next
        occurrence, because _fire reschedules after the callback returns."""
        if interval <= 0:
            raise ValueError("interval must be positive")
        self._interval = interval
