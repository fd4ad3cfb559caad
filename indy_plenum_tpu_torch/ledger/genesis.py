"""Genesis NYM transactions: the pre-consensus identities of a pool.

Copy of ``genesis_nym_txn`` from ``indy_plenum_tpu/ledger/genesis.py``
(reference: ledger/genesis_txn/ and the domain genesis file format).
Genesis txns are committed facts before any 3PC: the simulated pool's
ingress trusts the identities its domain genesis names. NODE txns and the
genesis file loader come with the real-execution slice of the port.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from ..common.constants import (
    CURRENT_TXN_VERSION,
    NYM,
    ROLE,
    TARGET_NYM,
    TXN_METADATA,
    TXN_PAYLOAD,
    TXN_PAYLOAD_DATA,
    TXN_PAYLOAD_METADATA,
    TXN_PAYLOAD_METADATA_FROM,
    TXN_SIGNATURE,
    TXN_TYPE,
    TXN_VERSION,
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

