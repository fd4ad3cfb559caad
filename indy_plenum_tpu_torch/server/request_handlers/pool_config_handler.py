"""POOL_CONFIG handler: the config ledger's write path.

Reference: the config-ledger request handlers under
plenum/server/request_handlers/ (+ indy-node's pool_config handler, whose
``writes`` flag semantics this follows) and
plenum/server/batch_handlers/config_batch_handler.py (the batch side here
is the generic :class:`LedgerBatchHandler` registered for
CONFIG_LEDGER_ID — the config ledger commits like any stateful ledger).

A committed ``{writes: false}`` observably changes behaviour on every
node: client WRITE requests are NACKed at ingress
(`Node.submit_client_request`) until a trustee re-enables them. The flag
lives in config STATE, so it survives restart (state rebuild from the
config ledger) and reaches lagging nodes through catchup.

Copy of ``indy_plenum_tpu/server/request_handlers/pool_config_handler.py``,
with its imports bound to the port. State values are encoded and
decoded by the port's own msgpack codec
(``common/serializers/serialization.py``), byte-identical to
msgpack-python's.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from ...common.constants import (
    CONFIG_LEDGER_ID,
    POOL_CONFIG,
    TRUSTEE,
    WRITES,
)
from ...common.exceptions import (
    InvalidClientRequest,
    UnauthorizedClientRequest,
)
from ...common.request import Request
from ...common.serializers.serialization import packb, unpackb
from ...common.txn_util import get_payload_data
from .handler_interfaces import WriteRequestHandler

_STATE_KEY = b"config:writes"


class PoolConfigHandler(WriteRequestHandler):
    def __init__(self, database_manager, get_nym_data=None):
        super().__init__(database_manager, POOL_CONFIG, CONFIG_LEDGER_ID)
        # (nym, is_committed) -> dict | None; injected from the NymHandler
        self._get_nym_data = get_nym_data
        # is_committed -> (state root the value was read at, value)
        self._cache = {}

    def static_validation(self, request: Request) -> None:
        self._validate_type(request)
        writes = request.operation.get(WRITES)
        if not isinstance(writes, bool):
            raise InvalidClientRequest(
                request.identifier, request.reqId,
                "POOL_CONFIG needs a boolean 'writes'")

    def dynamic_validation(self, request: Request,
                           req_pp_time: Optional[int]) -> None:
        """Only a TRUSTEE may change pool-wide parameters (reference auth
        rule for config writes)."""
        if self._get_nym_data is None:
            return
        author = self._get_nym_data(request.identifier, False)
        if author is None or author.get("role") != TRUSTEE:
            raise UnauthorizedClientRequest(
                request.identifier, request.reqId,
                "only a TRUSTEE may write POOL_CONFIG")

    def update_state(self, txn: Dict[str, Any], prev_result: Any,
                     request: Optional[Request] = None,
                     is_committed: bool = False) -> Any:
        data = get_payload_data(txn)
        record = {WRITES: bool(data.get(WRITES, True))}
        self.state.set(_STATE_KEY,
                       packb(record))
        return record

    # ------------------------------------------------------------------

    def writes_enabled(self, is_committed: bool = True) -> bool:
        """The live flag (default True when never set). Root-keyed cache:
        this sits on the per-request ingress hot path, and an SMT walk +
        msgpack unpack per request would tax the north-star throughput for
        a flag that changes only when a POOL_CONFIG txn commits."""
        if self.state is None:
            return True
        root = (self.state.committed_head_hash if is_committed
                else self.state.head_hash)
        cached = self._cache.get(is_committed)
        if cached is not None and cached[0] == root:
            return cached[1]
        raw = self.state.get(_STATE_KEY, is_committed=is_committed)
        value = True if raw is None else bool(
            unpackb(raw).get(WRITES, True))
        self._cache[is_committed] = (root, value)
        return value
