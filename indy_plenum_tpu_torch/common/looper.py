"""Looper: the production event loop driving timers and transports.

Reference: stp_core/loop/looper.py (`Looper`, `Prodable`) and motor.py
(`Motor`). The reference wraps asyncio; here the loop is an explicit
synchronous pump — deterministic, exception-isolating, and trivially
embeddable in tests — that *prods* every registered prodable (ZStacks,
nodes) and then services the shared QueueTimer each pass, sleeping only
when a pass did no work.

Pump order IS the deployed node's dispatch-plane barrier (README
"Performance"): transports drain first — every pending socket read lands
in its handlers (signed ingress into the auth queue, votes recorded
host-side) — and only then do due timer events fire. A barrier-scheduled
quorum tick (``Node._quorum_tick``) therefore always observes a fully
drained transport, exactly like the simulation's tick observes a drained
delivery set: drain → scatter → single grouped step → read events holds
over real zstack sockets too.

A raising prodable/timer callback is logged and isolated (the reference
Looper's per-prodable error guard): one faulty component must not stall
the node's clock or its peers' IO. Each one is counted in ``errors``, so
whatever drives the card through a Looper checks ``errors == 0`` at the
end: a kernel that failed to launch cannot hide in the log.

Copy of ``indy_plenum_tpu/common/looper.py``, with its imports bound to
the port.
"""
from __future__ import annotations

import logging
import time
from typing import Callable, List, Optional

from .timer import QueueTimer, TimerService

logger = logging.getLogger(__name__)


class Prodable:
    """Anything the loop pumps: return the amount of work done."""

    def prod(self) -> int:  # pragma: no cover — interface
        raise NotImplementedError

    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass


class Looper:
    def __init__(self, timer: Optional[TimerService] = None,
                 idle_sleep: float = 0.002):
        # epoch-aligned monotonic clock: protocol timestamps (ppTime) are
        # wall-clock epoch seconds, but scheduling must never jump backwards
        # da: allow-file[nondet-source] -- the DEPLOYED event loop runs on real time; simulation pools inject MockTimer and never construct this clock
        epoch_offset = time.time() - time.monotonic()
        self.timer = timer or QueueTimer(
            lambda: epoch_offset + time.monotonic())
        self._prodables: List = []
        self._idle_sleep = idle_sleep
        self.errors = 0

    def add(self, prodable) -> None:
        self._prodables.append(prodable)
        if hasattr(prodable, "start"):
            try:
                prodable.start()
            except NotImplementedError:
                pass

    def remove(self, prodable) -> None:
        if prodable in self._prodables:
            self._prodables.remove(prodable)

    def _pump_once(self) -> int:
        worked = 0
        # transports BEFORE timers (the zstack transport barrier): a due
        # quorum tick must fire against a drained socket set — reads that
        # were already pending when the tick came due land first, so the
        # tick's one device step carries them instead of the next tick's
        for prodable in list(self._prodables):
            try:
                fn = getattr(prodable, "prod", None) or prodable.service
                worked += fn() or 0
            except Exception:  # noqa: BLE001
                logger.exception("prodable %r raised", prodable)
                self.errors += 1
        try:
            worked += self.timer.service()
        except Exception:  # noqa: BLE001 — isolate faulty callbacks
            logger.exception("timer callback raised")
            self.errors += 1
        return worked

    def run_for(self, seconds: float) -> None:
        deadline = time.monotonic() + seconds
        while time.monotonic() < deadline:
            if self._pump_once() == 0:
                time.sleep(self._idle_sleep)

    def run_until(self, condition: Callable[[], bool],
                  timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if condition():
                return True
            if self._pump_once() == 0:
                time.sleep(self._idle_sleep)
        return condition()

    def shutdown(self) -> None:
        for prodable in self._prodables:
            if hasattr(prodable, "stop"):
                try:
                    prodable.stop()
                except Exception:  # noqa: BLE001
                    logger.exception("prodable stop raised")
        self._prodables.clear()
