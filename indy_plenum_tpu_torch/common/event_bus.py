"""In-process pub/sub buses.

Reference: plenum/common/event_bus.py (`InternalBus`, `ExternalBus`).
`InternalBus` carries typed events between consensus services inside one
node; `ExternalBus` abstracts "send a message to the network" so services
never touch sockets — in production it is wired to the ZMQ node stack, in
simulation to the in-memory network (`indy_plenum_tpu_torch.simulation`).

Copy of ``indy_plenum_tpu/common/event_bus.py``, with its imports bound to
the port.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Any, Callable, NamedTuple


class _DispatchCache:
    """MRO-walk + duplicate-handler dedupe, memoized per concrete type.

    Both buses deliver to every handler subscribed at any level of the
    message's MRO, each at most once per send. Doing that walk (and the
    O(handlers^2) bound-method equality dedupe) on EVERY delivery is the
    hottest line of a dense pool simulation; the subscription set changes
    rarely, so the flattened handler tuple is computed once per concrete
    type and invalidated on subscribe/unsubscribe.
    """

    def __init__(self):
        self._handlers: dict[type, list[Callable]] = defaultdict(list)
        self._cache: dict[type, tuple] = {}

    def subscribe(self, message_type: type, handler: Callable) -> None:
        self._handlers[message_type].append(handler)
        self._cache.clear()

    def unsubscribe(self, message_type: type, handler: Callable) -> None:
        if handler in self._handlers.get(message_type, []):
            self._handlers[message_type].remove(handler)
            self._cache.clear()

    def handlers_for(self, cls: type) -> tuple:
        cached = self._cache.get(cls)
        if cached is None:
            seen = []
            for base in cls.__mro__:
                for handler in self._handlers.get(base, ()):
                    if handler not in seen:  # == dedupes bound methods too
                        seen.append(handler)
            cached = self._cache[cls] = tuple(seen)
        return cached


class InternalBus(_DispatchCache):
    """Synchronous typed pub/sub: subscribers keyed by message class."""

    def send(self, message: Any, *args) -> None:
        for handler in self.handlers_for(type(message)):
            handler(message, *args)


class ExternalBus(_DispatchCache):
    """Network abstraction handed to consensus services.

    ``send_handler(msg, dst)`` with dst=None means broadcast to all
    connected peers. Inbound messages are delivered via ``process_incoming``.
    Connection state is tracked so services (e.g. the primary-connection
    monitor) can ask who is reachable.
    """

    class Connected(NamedTuple):
        name: str

    class Disconnected(NamedTuple):
        name: str

    def __init__(self, send_handler: Callable[[Any, str | None], None]):
        super().__init__()
        self._send_handler = send_handler
        self._connecteds: set[str] = set()

    @property
    def connecteds(self) -> set[str]:
        return set(self._connecteds)

    def is_connected(self, name: str) -> bool:
        """O(1) membership, no defensive copy (the per-delivery check)."""
        return name in self._connecteds

    def send(self, message: Any, dst: str | list[str] | None = None) -> None:
        self._send_handler(message, dst)

    def process_incoming(self, message: Any, frm: str) -> None:
        for handler in self.handlers_for(type(message)):
            handler(message, frm)

    def update_connecteds(self, connecteds: set[str]) -> None:
        added = connecteds - self._connecteds
        removed = self._connecteds - connecteds
        self._connecteds = set(connecteds)
        for name in sorted(added):
            self.process_incoming(self.Connected(name), name)
        for name in sorted(removed):
            self.process_incoming(self.Disconnected(name), name)
