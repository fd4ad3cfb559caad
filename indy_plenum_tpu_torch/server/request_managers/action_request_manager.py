"""Action requests: privileged immediate commands, never ledger-written.

Reference: plenum/server/request_managers/action_request_manager.py
(`ActionRequestManager`) with the pool-restart and validator-info handlers
(plenum/server/pool_req_handler.py analogs). An ACTION is executed by the
RECEIVING node right away — no consensus round, no txn — but unlike reads
it is PRIVILEGED: the signed request must authenticate AND its author must
hold an authorized role (TRUSTEE, or STEWARD for info).

- VALIDATOR_INFO: a status snapshot (view, last ordered, ledger sizes,
  freshness, mode) — the operational "how is this node doing" surface.
- POOL_RESTART: schedules a restart callback at ``datetime`` (seconds on
  the node clock; 0/absent = now). The composition injects what restart
  MEANS (systemd unit, container exit, test flag) via ``restart_sink``.

Copy of ``indy_plenum_tpu/server/request_managers/action_request_manager.py``,
with its imports bound to the port.
"""
from __future__ import annotations

import logging
from typing import Any, Callable, Dict, Optional

from ...common.constants import (
    POOL_RESTART,
    STEWARD,
    TRUSTEE,
    VALIDATOR_INFO,
)
from ...common.exceptions import (
    InvalidClientRequest,
    UnauthorizedClientRequest,
)
from ...common.request import Request

logger = logging.getLogger(__name__)

_INFO_ROLES = (TRUSTEE, STEWARD)
_RESTART_ROLES = (TRUSTEE,)


class ActionRequestManager:
    def __init__(self,
                 node_status_provider: Callable[[], Dict[str, Any]],
                 get_nym_data,
                 timer,
                 restart_sink: Optional[Callable[[], None]] = None):
        self._status = node_status_provider
        self._get_nym_data = get_nym_data  # (idr, is_committed) -> record
        self._timer = timer
        self._restart_sink = restart_sink or (lambda: None)
        self.restarts_scheduled = 0
        self._handlers = {
            VALIDATOR_INFO: self._handle_validator_info,
            POOL_RESTART: self._handle_pool_restart,
        }

    def is_action(self, txn_type: Optional[str]) -> bool:
        return txn_type in self._handlers

    def handle(self, request: Request) -> Dict[str, Any]:
        handler = self._handlers.get(request.txn_type)
        if handler is None:
            raise InvalidClientRequest(
                request.identifier, request.reqId,
                f"no action handler for {request.txn_type!r}")
        roles = (_RESTART_ROLES if request.txn_type == POOL_RESTART
                 else _INFO_ROLES)
        self._authorize(request, roles)
        return handler(request)

    def _authorize(self, request: Request, roles) -> None:
        record = self._get_nym_data(request.identifier, True) \
            if self._get_nym_data else None
        role = (record or {}).get("role")
        if role not in roles:
            raise UnauthorizedClientRequest(
                request.identifier, request.reqId,
                f"role {role!r} may not run action {request.txn_type}")

    # ------------------------------------------------------------------

    def _handle_validator_info(self, request: Request) -> Dict[str, Any]:
        return {"type": VALIDATOR_INFO, "data": self._status()}

    def _handle_pool_restart(self, request: Request) -> Dict[str, Any]:
        when = request.operation.get("datetime")
        now = self._timer.get_current_time()
        if when in (None, 0, ""):
            delay = 0.0
        elif isinstance(when, (int, float)) and when >= now:
            delay = when - now
        else:
            raise InvalidClientRequest(
                request.identifier, request.reqId,
                "datetime must be absent/0 (now) or a future node-clock "
                "timestamp")
        self.restarts_scheduled += 1
        logger.info("POOL_RESTART scheduled in %.1fs", delay)
        self._timer.schedule(delay, self._restart_sink)
        return {"type": POOL_RESTART, "scheduled_in": delay}
