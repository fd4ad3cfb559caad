"""Message routing with bounded stash queues.

Reference: plenum/common/stashing_router.py (`StashingRouter`) and
plenum/common/router.py (`Router`). A handler returns a verdict:

- ``PROCESS`` (None or 0): handled.
- ``DISCARD``: drop, with a reason.
- any other positive int: STASH under that reason code; the message is
  re-delivered when ``process_stashed(reason)`` is called (e.g. after a
  catchup completes or a view change finishes).

Stash queues are bounded (byzantine peers must not grow host memory).

Copy of ``indy_plenum_tpu/common/stashing_router.py``, with its imports
bound to the port.
"""
from __future__ import annotations

import logging
from collections import defaultdict, deque
from typing import Any, Callable, Iterable

logger = logging.getLogger(__name__)

PROCESS = 0
DISCARD = -1

# Common stash reason codes (services may define more; any int > 0 works).
STASH_VIEW_3PC = 1        # wrong view / not yet in view
STASH_CATCH_UP = 2        # node is catching up
STASH_WATERMARKS = 3      # outside [h, H]
STASH_WAITING_VIEW_CHANGE = 4
STASH_WAITING_NEW_VIEW = 5


class Router:
    """Plain type-dispatch router (no stashing)."""

    def __init__(self):
        self._handlers: dict[type, Callable] = {}

    def add(self, message_type: type, handler: Callable) -> None:
        self._handlers[message_type] = handler

    def remove(self, message_type: type) -> None:
        self._handlers.pop(message_type, None)

    def handlers(self, message_type: type) -> Callable | None:
        for cls in message_type.__mro__:
            if cls in self._handlers:
                return self._handlers[cls]
        return None

    def process(self, message: Any, *args) -> Any:
        handler = self.handlers(type(message))
        if handler is None:
            logger.debug("no handler for %s", type(message).__name__)
            return None
        return handler(message, *args)


class RouterSpy:
    """Test instrumentation: records every routed message with its
    verdict (reference: plenum/test/testable.py ``Spyable`` /
    plenum/test/test_node.py spylog). Attach via
    ``StashingRouter.spy``; fault-injection tests can then assert
    e.g. "node X processed PREPARE from Y exactly once" instead of
    relying only on end-state convergence.
    """

    def __init__(self, clock: Callable | None = None):
        import time as _time

        self._clock = clock or _time.monotonic
        self.log: list = []  # (message, frm, verdict_code, t)

    def record(self, message, frm, verdict) -> None:
        self.log.append((message, frm, verdict, self._clock()))

    def events(self, msg_type: type | None = None,
               frm: str | None = None,
               verdict: int | None = None) -> list:
        return [e for e in self.log
                if (msg_type is None or isinstance(e[0], msg_type))
                and (frm is None or e[1] == frm)
                and (verdict is None or e[2] == verdict)]

    def count(self, msg_type: type | None = None, frm: str | None = None,
              verdict: int | None = None) -> int:
        return len(self.events(msg_type, frm, verdict))

    def clear(self) -> None:
        self.log.clear()


class StashingRouter(Router):
    def __init__(self, limit: int, buses: Iterable[Any] = (),
                 unstash_handler: Callable | None = None):
        super().__init__()
        self._limit = limit
        self._queues: dict[int, deque] = defaultdict(lambda: deque(maxlen=limit))
        self._unstash_handler = unstash_handler
        self._buses = list(buses)
        self.spy: RouterSpy | None = None  # test-only; None in production

    def subscribe(self, message_type: type, handler: Callable) -> None:
        """Route ``message_type`` to ``handler`` and listen for it on all
        attached buses. The single shared ``_process_from_bus`` bound method
        plus the buses' per-send handler dedupe guarantee exactly-once
        processing even when base and derived types are both subscribed."""
        self.add(message_type, handler)
        for bus in self._buses:
            bus.subscribe(message_type, self._process_from_bus)

    def _process_from_bus(self, message, *args) -> None:
        self.process(message, *args)

    def unsubscribe_all(self) -> None:
        """Detach from every bus and drop stashes (a torn-down replica's
        handlers must stop firing on the shared external bus)."""
        for bus in self._buses:
            if hasattr(bus, "unsubscribe"):
                for mtype in list(self._handlers):  # types WE subscribed
                    bus.unsubscribe(mtype, self._process_from_bus)
        self._handlers.clear()
        self._queues.clear()

    def stash_size(self, reason: int | None = None) -> int:
        if reason is not None:
            return len(self._queues[reason])
        return sum(len(q) for q in self._queues.values())

    def process(self, message: Any, *args) -> Any:
        handler = self.handlers(type(message))
        if handler is None:
            return None
        verdict = handler(message, *args)
        code, reason = verdict if isinstance(verdict, tuple) else (verdict, None)
        if self.spy is not None:
            self.spy.record(message, args[0] if args else None, code)
        if code is None or code == PROCESS:
            return PROCESS
        if code == DISCARD:
            logger.debug("discarding %s: %s", type(message).__name__, reason)
            return DISCARD
        queue = self._queues[code]
        if len(queue) == queue.maxlen:
            logger.debug("stash %s full; evicting oldest to admit %s", code,
                         type(message).__name__)
        queue.append((message, args))
        return code

    def process_stashed(self, reason: int) -> int:
        """Replay everything stashed under ``reason``; returns count replayed."""
        queue = self._queues[reason]
        processed = 0
        # Bound the replay to the entry length: re-stashed messages must
        # not cause an infinite loop within one call. Re-check emptiness
        # every iteration — processing a message can REENTER
        # process_stashed for the same reason (e.g. a fetched old-view
        # PRE-PREPARE unstashes its successor, which unstashes further)
        # and drain the queue under this loop.
        bound = len(queue)
        while processed < bound and queue:
            message, args = queue.popleft()
            self.process(message, *args)
            processed += 1
        if processed and self._unstash_handler:
            self._unstash_handler(reason, processed)
        return processed

    def process_all_stashed(self) -> int:
        return sum(self.process_stashed(r) for r in list(self._queues))

    def discard_stashed(self, reason: int) -> None:
        self._queues[reason].clear()
