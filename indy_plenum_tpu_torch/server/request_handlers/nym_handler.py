"""NYM handler: identity (DID) create/update on the domain ledger.

Reference: plenum/server/request_handlers/nym_handler.py (`NymHandler`).
State layout: key = DID utf-8, value = msgpack {verkey, role, seqNo,
txnTime} — the verkey source for client authentication
(`CoreAuthNr.authenticate` resolves signers from here).

Authorization rules (reference semantics):
- new NYM: creator must hold TRUSTEE or STEWARD role; only a TRUSTEE may
  grant a role (STEWARD creates plain identity owners);
- existing NYM: the owner may rotate its own verkey; only a TRUSTEE may
  change a role.

Copy of ``indy_plenum_tpu/server/request_handlers/nym_handler.py``,
with its imports bound to the port. State values are encoded and
decoded by the port's own msgpack codec
(``common/serializers/serialization.py``), byte-identical to
msgpack-python's.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from ...common.constants import (
    DOMAIN_LEDGER_ID,
    NYM,
    ROLE,
    STEWARD,
    TARGET_NYM,
    TRUSTEE,
    VERKEY,
)
from ...common.exceptions import (
    InvalidClientRequest,
    UnauthorizedClientRequest,
)
from ...common.request import Request
from ...common.serializers.serialization import packb, unpackb
from ...common.txn_util import get_payload_data, get_seq_no, get_txn_time
from .handler_interfaces import WriteRequestHandler


class NymHandler(WriteRequestHandler):
    def __init__(self, database_manager):
        super().__init__(database_manager, NYM, DOMAIN_LEDGER_ID)

    # ------------------------------------------------------------------

    def static_validation(self, request: Request) -> None:
        self._validate_type(request)
        op = request.operation
        if not op.get(TARGET_NYM):
            raise InvalidClientRequest(request.identifier, request.reqId,
                                       "dest is required")
        role = op.get(ROLE)
        if role not in (None, TRUSTEE, STEWARD):
            raise InvalidClientRequest(request.identifier, request.reqId,
                                       f"unknown role {role!r}")

    def dynamic_validation(self, request: Request,
                           req_pp_time: Optional[int]) -> None:
        op = request.operation
        dest = op[TARGET_NYM]
        existing = self.get_nym_data(dest, is_committed=False)
        author = self.get_nym_data(request.identifier, is_committed=False)
        author_role = author.get(ROLE) if author else None
        if existing is None:
            if author_role not in (TRUSTEE, STEWARD):
                raise UnauthorizedClientRequest(
                    request.identifier, request.reqId,
                    "only TRUSTEE or STEWARD may create identities")
            if op.get(ROLE) is not None and author_role != TRUSTEE:
                raise UnauthorizedClientRequest(
                    request.identifier, request.reqId,
                    "only TRUSTEE may grant roles")
        else:
            is_owner = request.identifier == dest
            if ROLE in op and op.get(ROLE) != existing.get(ROLE):
                if author_role != TRUSTEE:
                    raise UnauthorizedClientRequest(
                        request.identifier, request.reqId,
                        "only TRUSTEE may change a role")
            elif not is_owner and author_role != TRUSTEE:
                raise UnauthorizedClientRequest(
                    request.identifier, request.reqId,
                    "only the owner may edit its NYM")

    def update_state(self, txn: Dict[str, Any], prev_result,
                     request=None, is_committed: bool = False):
        data = get_payload_data(txn)
        dest = data[TARGET_NYM]
        existing = self.get_nym_data(dest, is_committed=False) or {}
        record = {
            VERKEY: data.get(VERKEY, existing.get(VERKEY)),
            ROLE: data.get(ROLE, existing.get(ROLE)),
            "seqNo": get_seq_no(txn),
            "txnTime": get_txn_time(txn),
        }
        self.state.set(dest.encode(), packb(record))
        return record

    # ------------------------------------------------------------------

    def get_nym_data(self, nym: Optional[str],
                     is_committed: bool = True) -> Optional[Dict]:
        if nym is None:
            return None
        raw = self.state.get(nym.encode(), is_committed=is_committed)
        if raw is None:
            return None
        return unpackb(raw)
