"""NODE handler: validator membership on the pool ledger.

Reference: plenum/server/request_handlers/node_handler.py (`NodeHandler`).
State layout: key = node nym, value = msgpack {alias, node_ip, node_port,
client_ip, client_port, services, blskey, blskey_pop, steward}.
Membership changes flow through consensus itself; the pool manager watches
committed NODE txns and reconfigures stacks/replicas.

Rules (reference semantics): only a STEWARD may add a node; one node per
steward; only the owning steward may edit its node; demotion/promotion via
the services field.

Copy of ``indy_plenum_tpu/server/request_handlers/node_handler.py``,
with its imports bound to the port. State values are encoded and
decoded by the port's own msgpack codec
(``common/serializers/serialization.py``), byte-identical to
msgpack-python's.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from ...common.constants import (
    ALIAS,
    CLIENT_PORT,
    NODE,
    NODE_PORT,
    POOL_LEDGER_ID,
    SERVICES,
    STEWARD,
    TARGET_NYM,
    VALIDATOR,
)
from ...common.exceptions import (
    InvalidClientRequest,
    UnauthorizedClientRequest,
)
from ...common.request import Request
from ...common.serializers.serialization import packb, unpackb
from ...common.txn_util import get_payload_data
from .handler_interfaces import WriteRequestHandler


class NodeHandler(WriteRequestHandler):
    def __init__(self, database_manager, get_nym_data=None):
        super().__init__(database_manager, NODE, POOL_LEDGER_ID)
        # (nym, is_committed) -> dict | None; injected from the NymHandler
        self._get_nym_data = get_nym_data

    def static_validation(self, request: Request) -> None:
        self._validate_type(request)
        op = request.operation
        if not op.get(TARGET_NYM):
            raise InvalidClientRequest(request.identifier, request.reqId,
                                       "dest (node nym) is required")
        data = op.get("data") or {}
        if not isinstance(data, dict) or not data.get(ALIAS):
            raise InvalidClientRequest(request.identifier, request.reqId,
                                       "data.alias is required")
        services = data.get(SERVICES)
        if services is not None:
            if not isinstance(services, list) or \
                    any(s != VALIDATOR for s in services):
                raise InvalidClientRequest(
                    request.identifier, request.reqId,
                    f"services may only contain {VALIDATOR!r}")
        for port_field in (NODE_PORT, CLIENT_PORT):
            port = data.get(port_field)
            if port is not None and not (0 < int(port) < 65536):
                raise InvalidClientRequest(request.identifier, request.reqId,
                                           f"bad {port_field}: {port}")

    def dynamic_validation(self, request: Request,
                           req_pp_time: Optional[int]) -> None:
        op = request.operation
        dest = op[TARGET_NYM]
        author_nym = None
        if self._get_nym_data is not None:
            author_nym = self._get_nym_data(request.identifier, False)
        existing = self.get_node_data(dest, is_committed=False)
        if existing is None:
            if self._get_nym_data is not None and (
                    author_nym is None or author_nym.get("role") != STEWARD):
                raise UnauthorizedClientRequest(
                    request.identifier, request.reqId,
                    "only a STEWARD may add a node")
            if self._steward_has_node(request.identifier):
                raise UnauthorizedClientRequest(
                    request.identifier, request.reqId,
                    "steward already operates a node")
        else:
            if existing.get("steward") != request.identifier:
                raise UnauthorizedClientRequest(
                    request.identifier, request.reqId,
                    "only the owning steward may edit its node")

    def update_state(self, txn: Dict[str, Any], prev_result,
                     request=None, is_committed: bool = False):
        data = get_payload_data(txn)
        dest = data[TARGET_NYM]
        node_data = dict(data.get("data") or {})
        existing = self.get_node_data(dest, is_committed=False) or {}
        record = {**existing, **node_data}
        from ...common.txn_util import get_from

        record.setdefault("steward", get_from(txn))
        self.state.set(dest.encode(),
                       packb(record))
        return record

    # ------------------------------------------------------------------

    def get_node_data(self, nym: str, is_committed: bool = True
                      ) -> Optional[Dict]:
        raw = self.state.get(nym.encode(), is_committed=is_committed)
        return unpackb(raw) if raw is not None else None

    def _steward_has_node(self, steward_nym: Optional[str]) -> bool:
        # linear scan over committed pool ledger (pool is small)
        ledger = self.ledger
        if ledger is None or steward_nym is None:
            return False
        for _, txn in ledger.get_all_txn():
            from ...common.txn_util import get_from, get_type

            if get_type(txn) == NODE and get_from(txn) == steward_nym:
                return True
        return False
