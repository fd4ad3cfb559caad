"""Request handler base classes: the per-txn-type execution plugin seam.

Reference: plenum/server/request_handlers/handler_interfaces/ --
`WriteRequestHandler` (static_validation / dynamic_validation /
update_state hooks) and `ReadRequestHandler` (get_result + state proofs).
Handlers are registered per txn type with the request managers; adding a
new transaction type is: subclass, register (same plugin model as the
reference's ledger request handlers).

Copy of ``indy_plenum_tpu/server/request_handlers/handler_interfaces.py``,
with its imports bound to the port.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Dict, Optional

from ...common.exceptions import InvalidClientRequest
from ...common.request import Request
from ..database_manager import DatabaseManager


class RequestHandler(ABC):
    def __init__(self, database_manager: DatabaseManager, txn_type: str,
                 ledger_id: Optional[int]):
        self.database_manager = database_manager
        self.txn_type = txn_type
        self.ledger_id = ledger_id

    @property
    def ledger(self):
        return self.database_manager.get_ledger(self.ledger_id)

    @property
    def state(self):
        return self.database_manager.get_state(self.ledger_id)


class WriteRequestHandler(RequestHandler):
    @abstractmethod
    def static_validation(self, request: Request) -> None:
        """Schema-level checks, no state access. Raise InvalidClientRequest."""

    @abstractmethod
    def dynamic_validation(self, request: Request,
                           req_pp_time: Optional[int]) -> None:
        """Checks against *uncommitted* state (auth rules, conflicts).
        Raise UnauthorizedClientRequest / InvalidClientRequest."""

    @abstractmethod
    def update_state(self, txn: Dict[str, Any], prev_result: Any,
                     request: Optional[Request] = None,
                     is_committed: bool = False) -> Any:
        """Apply the txn to the (uncommitted) state."""

    # helpers
    def _validate_type(self, request: Request) -> None:
        if request.txn_type != self.txn_type:
            raise InvalidClientRequest(
                request.identifier, request.reqId,
                f"handler for {self.txn_type} got {request.txn_type}")


class ReadRequestHandler(RequestHandler):
    @abstractmethod
    def get_result(self, request: Request) -> Dict[str, Any]:
        ...


class ActionHandler(RequestHandler):
    """Pool actions (restart etc.) — validated + executed, never ledgered."""

    @abstractmethod
    def process_action(self, request: Request) -> Dict[str, Any]:
        ...
