"""Genesis transaction builders and bootstrap loading.

Reference: ledger/genesis_txn/ (`GenesisTxnInitiatorFromFile`) and the
pool/domain genesis file format. Genesis txns are pre-consensus committed
facts: the initial trustee/steward NYMs (domain) and the validator NODE
txns (pool). They are applied directly to the committed ledger + state at
node init — no 3PC, no audit txn.

Copy of ``indy_plenum_tpu/ledger/genesis.py``,
with its imports bound to the port.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from ..common.constants import (
    ALIAS,
    BLS_KEY,
    BLS_KEY_PROOF,
    CLIENT_IP,
    CLIENT_PORT,
    CURRENT_TXN_VERSION,
    NODE,
    NODE_IP,
    NODE_PORT,
    NYM,
    ROLE,
    SERVICES,
    TARGET_NYM,
    TXN_METADATA,
    TXN_PAYLOAD,
    TXN_PAYLOAD_DATA,
    TXN_PAYLOAD_METADATA,
    TXN_PAYLOAD_METADATA_FROM,
    TXN_SIGNATURE,
    TXN_TYPE,
    TXN_VERSION,
    VALIDATOR,
    VERKEY,
)


def _txn(typ: str, data: Dict[str, Any],
         frm: Optional[str] = None) -> Dict[str, Any]:
    return {
        TXN_VERSION: CURRENT_TXN_VERSION,
        TXN_PAYLOAD: {
            TXN_TYPE: typ,
            TXN_PAYLOAD_DATA: data,
            TXN_PAYLOAD_METADATA: (
                {TXN_PAYLOAD_METADATA_FROM: frm} if frm else {}),
        },
        TXN_METADATA: {},
        TXN_SIGNATURE: {},
    }


def genesis_nym_txn(did: str, verkey: Optional[str] = None,
                    role: Optional[str] = None,
                    frm: Optional[str] = None) -> Dict[str, Any]:
    data: Dict[str, Any] = {TARGET_NYM: did}
    if verkey is not None:
        data[VERKEY] = verkey
    if role is not None:
        data[ROLE] = role
    return _txn(NYM, data, frm)


def genesis_node_txn(node_nym: str, alias: str, steward_did: str,
                     node_ip: str = "127.0.0.1", node_port: int = 9701,
                     client_ip: str = "127.0.0.1", client_port: int = 9702,
                     blskey: Optional[str] = None,
                     blskey_pop: Optional[str] = None,
                     transport_verkey: Optional[str] = None
                     ) -> Dict[str, Any]:
    from ..common.constants import TRANSPORT_VERKEY

    data = {
        TARGET_NYM: node_nym,
        "data": {
            ALIAS: alias,
            NODE_IP: node_ip,
            NODE_PORT: node_port,
            CLIENT_IP: client_ip,
            CLIENT_PORT: client_port,
            SERVICES: [VALIDATOR],
            **({BLS_KEY: blskey} if blskey else {}),
            **({BLS_KEY_PROOF: blskey_pop} if blskey_pop else {}),
            **({TRANSPORT_VERKEY: transport_verkey}
               if transport_verkey else {}),
        },
    }
    return _txn(NODE, data, frm=steward_did)


def load_genesis_file(path: str) -> List[Dict[str, Any]]:
    """One JSON txn per line (the reference's genesis file format)."""
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def dump_genesis_file(path: str, txns: List[Dict[str, Any]]) -> None:
    with open(path, "w") as fh:
        for txn in txns:
            fh.write(json.dumps(txn, sort_keys=True) + "\n")
