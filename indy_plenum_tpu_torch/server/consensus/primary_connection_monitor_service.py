"""Primary liveness watchdog.

Reference: plenum/server/consensus/primary_connection_monitor_service.py.
If the master primary stays unreachable for ToleratePrimaryDisconnection
seconds, propose an instance change (PrimaryDisconnected -> trigger
service). Connection state comes from the ExternalBus Connected /
Disconnected events fed by the network stack.

Copy of
``indy_plenum_tpu/server/consensus/primary_connection_monitor_service.py``,
with its imports bound to the port.
"""
from __future__ import annotations

import logging

from ...common.event_bus import ExternalBus, InternalBus
from ...common.messages.internal_messages import (
    PrimaryDisconnected,
    PrimarySelected,
)
from ...common.timer import TimerService

logger = logging.getLogger(__name__)


class PrimaryConnectionMonitorService:
    def __init__(self,
                 data,
                 timer: TimerService,
                 bus: InternalBus,
                 network: ExternalBus,
                 config=None):
        from ...config import getConfig

        self._data = data
        self._timer = timer
        self._bus = bus
        self._network = network
        self._config = config or getConfig()
        self._primary_disconnection_time = timer.get_current_time()

        network.subscribe(ExternalBus.Connected, self._on_connected)
        network.subscribe(ExternalBus.Disconnected, self._on_disconnected)
        bus.subscribe(PrimarySelected, self._on_primary_selected)

    def _primary_connected(self) -> bool:
        primary = self._data.primary_name
        return primary is not None and (
            primary == self._data.name
            or primary in self._network.connecteds)

    def _on_connected(self, msg: ExternalBus.Connected, frm: str) -> None:
        if msg.name == self._data.primary_name:
            self._primary_disconnection_time = None
            self._timer.cancel(self._propose_view_change)

    def _on_disconnected(self, msg: ExternalBus.Disconnected,
                         frm: str) -> None:
        if msg.name == self._data.primary_name:
            self._schedule_proposal()

    def _on_primary_selected(self, msg, *args) -> None:
        if self._primary_connected():
            self._primary_disconnection_time = None
        else:
            self._schedule_proposal()

    def _schedule_proposal(self) -> None:
        self._primary_disconnection_time = self._timer.get_current_time()
        self._timer.cancel(self._propose_view_change)
        self._timer.schedule(
            self._config.ToleratePrimaryDisconnection,
            self._propose_view_change)

    def _propose_view_change(self) -> None:
        if self._primary_connected():
            return
        logger.info("%s primary %s unreachable -> propose view change",
                    self._data.name, self._data.primary_name)
        self._bus.send(PrimaryDisconnected(inst_id=self._data.inst_id))
        # keep proposing while still disconnected
        self._timer.schedule(
            self._config.ToleratePrimaryDisconnection,
            self._propose_view_change)
