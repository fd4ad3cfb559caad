"""Read requests: proved state reads and ledger txn lookups.

Reference: plenum/server/request_managers/read_request_manager.py
(`ReadRequestManager`) + the GET_TXN handler
(plenum/server/request_handlers/get_txn_handler.py). Reads are served by
the RECEIVING node alone — no consensus round — because every answer
carries proof material making it as trustworthy as f+1 matching replies:

- GET_NYM: {value, sparse-Merkle inclusion/absence proof, the pool's BLS
  multi-signature over the committed state root} — the client checks both
  (client/state_proof.verify_proved_reply) and can trust one node.
- GET_TXN: {txn, RFC 6962 audit path against the ledger root} — the root
  itself is bound into the audit ledger chain each batch.

Reads are permitted unsigned (reference behaviour: reading is public).

Copy of ``indy_plenum_tpu/server/request_managers/read_request_manager.py``,
with its imports bound to the port.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from ...common.constants import (
    DOMAIN_LEDGER_ID,
    GET_NYM,
    GET_TXN,
    TARGET_NYM,
)
from ...common.exceptions import InvalidClientRequest
from ...common.request import Request
from ...utils.base58 import b58encode
from ..database_manager import DatabaseManager


class ReadRequestManager:
    def __init__(self, db: DatabaseManager,
                 bls_multi_sig_getter: Optional[
                     Callable[[str], Optional[dict]]] = None):
        """``bls_multi_sig_getter(state_root_b58) -> MultiSignature dict``
        (the BlsStore lookup) — None when the pool runs without BLS."""
        self._db = db
        self._get_multi_sig = bls_multi_sig_getter or (lambda root: None)
        self._handlers: Dict[str, Callable[[Request], Dict[str, Any]]] = {
            GET_NYM: self.handle_get_nym,
            GET_TXN: self.handle_get_txn,
        }

    def is_read(self, txn_type: Optional[str]) -> bool:
        return txn_type in self._handlers

    def handle(self, request: Request) -> Dict[str, Any]:
        handler = self._handlers.get(request.txn_type)
        if handler is None:
            raise InvalidClientRequest(
                request.identifier, request.reqId,
                f"no read handler for txn type {request.txn_type!r}")
        return handler(request)

    # ------------------------------------------------------------------

    def handle_get_nym(self, request: Request) -> Dict[str, Any]:
        """Proved read of a NYM record from committed domain state."""
        dest = request.operation.get(TARGET_NYM)
        # reads are unsigned and unauthenticated: every field is hostile
        # until type-checked (a non-str dest would raise deep inside)
        if not dest or not isinstance(dest, str):
            raise InvalidClientRequest(
                request.identifier, request.reqId,
                "GET_NYM needs a string dest")
        state = self._db.get_state(DOMAIN_LEDGER_ID)
        root = state.committed_head_hash
        key = dest.encode()
        value = state.get(key, is_committed=True)
        proof = state.generate_state_proof(key, root=root, serialize=True)
        return {
            "type": GET_NYM,
            "dest": dest,
            "data": value,
            "state_proof": {
                "root_hash": b58encode(root),
                "proof_nodes": proof,
                "multi_signature": self._get_multi_sig(b58encode(root)),
            },
        }

    def handle_get_txn(self, request: Request) -> Dict[str, Any]:
        """A committed txn by seqNo + its audit path to the ledger root.

        When the pool runs BLS, the reply also carries the multi-signature
        over the LATEST batch of this ledger — its co-signed
        ``txn_root_hash`` is this ledger root, which upgrades GET_TXN to a
        proved single-node read (the client checks audit path -> co-signed
        root -> pool keys; see Client._verify_proved_get_txn)."""
        ledger_id = request.operation.get("ledgerId", DOMAIN_LEDGER_ID)
        seq_no = request.operation.get("data")
        if not isinstance(ledger_id, int):
            raise InvalidClientRequest(
                request.identifier, request.reqId,
                "GET_TXN ledgerId must be an int")
        if not isinstance(seq_no, int) or isinstance(seq_no, bool) \
                or seq_no < 1:
            raise InvalidClientRequest(
                request.identifier, request.reqId,
                "GET_TXN needs a positive seqNo in 'data'")
        ledger = self._db.get_ledger(ledger_id)
        if ledger is None or seq_no > ledger.size:
            return {"type": GET_TXN, "ledgerId": ledger_id,
                    "seqNo": seq_no, "data": None}
        txn = ledger.get_by_seq_no(seq_no)
        size = ledger.size
        multi_sig = None
        state = self._db.get_state(ledger_id)
        if state is not None:
            ms = self._get_multi_sig(b58encode(state.committed_head_hash))
            # only attach when it actually covers THIS ledger root (the
            # store is keyed by state root; its value co-signs the txn
            # root of the same batch)
            if ms and ms.get("value", {}).get("txn_root_hash") \
                    == b58encode(ledger.root_hash):
                multi_sig = ms
        return {
            "type": GET_TXN,
            "ledgerId": ledger_id,
            "seqNo": seq_no,
            "data": txn,
            "auditProof": {
                "rootHash": b58encode(ledger.root_hash),
                "ledgerSize": size,
                "auditPath": [b58encode(h)
                              for h in ledger.audit_path(seq_no, size)],
                "multi_signature": multi_sig,
            },
        }
