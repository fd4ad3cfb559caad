"""Notifier: operator-facing events pushed to pluggable sinks.

Reference: plenum/server/notifier_plugin_manager.py — monitor degradation
and view-change events are forwarded to registered notifier plugins
(upstream: agent webhooks/email) rather than living only in logs. Here a
sink is any callable taking one event dict; plugins register theirs via
``plugin_entry(node)`` -> ``node.notifier.register_sink(fn)`` (same
plugin seam as request handlers, :mod:`indy_plenum_tpu_torch.plugins`).

Event kinds mirror the operationally-interesting internal-bus traffic:
master degradation votes, view-change lifecycle, catchup failure (the
fail-closed alarm), and byzantine suspicions. A raising sink is isolated
and logged — an operator webhook must never stall consensus.

Copy of ``indy_plenum_tpu/server/notifier.py``, with its imports bound to
the port.
"""
from __future__ import annotations

import logging
from collections import deque
from typing import Any, Callable, Dict, List

from ..common.event_bus import InternalBus
from ..common.messages.internal_messages import (
    NodeNeedViewChange,
    RaisedSuspicion,
    ViewChangeFinished,
    ViewChangeStarted,
    VoteForViewChange,
)
from .suspicion_codes import Suspicions

logger = logging.getLogger(__name__)

# event kinds (reference: the notifier plugin event names)
MASTER_DEGRADED = "master_degraded"
VIEW_CHANGE_VOTE = "view_change_vote"
VIEW_CHANGE_STARTED = "view_change_started"
VIEW_CHANGE_COMPLETE = "view_change_complete"
CATCHUP_FAILED = "catchup_failed"
SUSPICION = "suspicion"


class NotifierService:
    def __init__(self, node_name: str, bus: InternalBus,
                 timer=None, history: int = 200):
        self._name = node_name
        self._timer = timer
        self._sinks: List[Callable[[Dict[str, Any]], None]] = []
        # bounded in-process history: VALIDATOR_INFO / tests read it
        self.events: deque = deque(maxlen=history)

        bus.subscribe(VoteForViewChange, self._on_vote_for_view_change)
        bus.subscribe(NodeNeedViewChange, self._on_need_view_change)
        bus.subscribe(ViewChangeStarted, self._on_view_change_started)
        bus.subscribe(ViewChangeFinished, self._on_view_change_finished)
        bus.subscribe(RaisedSuspicion, self._on_raised_suspicion)

    def register_sink(self, sink: Callable[[Dict[str, Any]], None]) -> None:
        self._sinks.append(sink)

    # ------------------------------------------------------------------

    def _emit(self, kind: str, **data: Any) -> None:
        event = {"node": self._name, "kind": kind, **data}
        if self._timer is not None:
            event["timestamp"] = self._timer.get_current_time()
        self.events.append(event)
        for sink in self._sinks:
            try:
                sink(dict(event))
            except Exception:  # noqa: BLE001 — a webhook must never
                # stall consensus
                logger.exception("%s: notifier sink raised", self._name)

    def _on_vote_for_view_change(self, msg: VoteForViewChange,
                                 *args) -> None:
        suspicion = msg.suspicion
        code = getattr(suspicion, "code", None)
        if code == Suspicions.PRIMARY_DEGRADED.code:
            self._emit(MASTER_DEGRADED,
                       reason=getattr(suspicion, "reason", ""))
        else:
            self._emit(VIEW_CHANGE_VOTE, code=code,
                       reason=getattr(suspicion, "reason", ""))

    def _on_need_view_change(self, msg: NodeNeedViewChange, *args) -> None:
        self._emit(VIEW_CHANGE_STARTED, view_no=msg.view_no)

    def _on_view_change_started(self, msg: ViewChangeStarted,
                                *args) -> None:
        pass  # covered by NodeNeedViewChange (quorum reached)

    def _on_view_change_finished(self, msg: ViewChangeFinished,
                                 *args) -> None:
        self._emit(VIEW_CHANGE_COMPLETE, view_no=msg.view_no)

    def _on_raised_suspicion(self, msg: RaisedSuspicion, *args) -> None:
        ex = msg.ex
        suspicion = getattr(ex, "suspicion", None)
        code = getattr(suspicion, "code", None)
        if code == Suspicions.CATCHUP_FAILED.code:
            # the fail-closed alarm: the node is out of the protocol
            # until catchup succeeds — the one event an operator must see
            self._emit(CATCHUP_FAILED,
                       reason=getattr(suspicion, "reason", ""))
        else:
            self._emit(SUSPICION, code=code,
                       peer=getattr(ex, "node", None),
                       reason=getattr(suspicion, "reason", ""))
