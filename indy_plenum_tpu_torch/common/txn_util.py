"""Request <-> transaction conversion and txn envelope accessors.

Reference: plenum/common/txn_util.py (`reqToTxn`, `append_txn_metadata`,
`get_payload_data`, ...). Envelope layout (see constants):

    {ver, txn: {type, data, metadata: {from, reqId, digest}},
     txnMetadata: {seqNo, txnTime}, reqSignature}

Copy of ``indy_plenum_tpu/common/txn_util.py``,
with its imports bound to the port.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from .constants import (
    CURRENT_TXN_VERSION,
    TXN_METADATA,
    TXN_METADATA_SEQ_NO,
    TXN_METADATA_TIME,
    TXN_PAYLOAD,
    TXN_PAYLOAD_DATA,
    TXN_PAYLOAD_METADATA,
    TXN_PAYLOAD_METADATA_DIGEST,
    TXN_PAYLOAD_METADATA_FROM,
    TXN_PAYLOAD_METADATA_REQ_ID,
    TXN_SIGNATURE,
    TXN_TYPE,
    TXN_VERSION,
)
from .request import Request


def reqToTxn(req: Request) -> Dict[str, Any]:
    """Strip txn-type out of the operation into the envelope; keep the rest
    as payload data; record signer(s) and digest."""
    op = dict(req.operation)
    typ = op.pop(TXN_TYPE, None)
    sig = None
    if req.signature is not None:
        sig = {"type": "ED25519", "values": [
            {"from": req.identifier, "value": req.signature}]}
    elif req.signatures:
        sig = {"type": "ED25519", "values": [
            {"from": idr, "value": s} for idr, s in sorted(req.signatures.items())]}
    return {
        TXN_VERSION: CURRENT_TXN_VERSION,
        TXN_PAYLOAD: {
            TXN_TYPE: typ,
            TXN_PAYLOAD_DATA: op,
            TXN_PAYLOAD_METADATA: {
                TXN_PAYLOAD_METADATA_FROM: req.identifier,
                TXN_PAYLOAD_METADATA_REQ_ID: req.reqId,
                TXN_PAYLOAD_METADATA_DIGEST: req.digest,
            },
        },
        TXN_METADATA: {},
        TXN_SIGNATURE: sig or {},
    }


def append_txn_metadata(txn: Dict[str, Any], seq_no: Optional[int] = None,
                        txn_time: Optional[int] = None) -> Dict[str, Any]:
    md = txn.setdefault(TXN_METADATA, {})
    if seq_no is not None:
        md[TXN_METADATA_SEQ_NO] = seq_no
    if txn_time is not None:
        md[TXN_METADATA_TIME] = txn_time
    return txn


def get_type(txn: Dict[str, Any]) -> Optional[str]:
    return txn.get(TXN_PAYLOAD, {}).get(TXN_TYPE)


def get_payload_data(txn: Dict[str, Any]) -> Dict[str, Any]:
    return txn.get(TXN_PAYLOAD, {}).get(TXN_PAYLOAD_DATA, {})


def get_from(txn: Dict[str, Any]) -> Optional[str]:
    return (txn.get(TXN_PAYLOAD, {}).get(TXN_PAYLOAD_METADATA, {})
            .get(TXN_PAYLOAD_METADATA_FROM))


def get_req_id(txn: Dict[str, Any]) -> Optional[int]:
    return (txn.get(TXN_PAYLOAD, {}).get(TXN_PAYLOAD_METADATA, {})
            .get(TXN_PAYLOAD_METADATA_REQ_ID))


def get_digest(txn: Dict[str, Any]) -> Optional[str]:
    return (txn.get(TXN_PAYLOAD, {}).get(TXN_PAYLOAD_METADATA, {})
            .get(TXN_PAYLOAD_METADATA_DIGEST))


def get_seq_no(txn: Dict[str, Any]) -> Optional[int]:
    return txn.get(TXN_METADATA, {}).get(TXN_METADATA_SEQ_NO)


def get_txn_time(txn: Dict[str, Any]) -> Optional[int]:
    return txn.get(TXN_METADATA, {}).get(TXN_METADATA_TIME)


def get_version(txn: Dict[str, Any]) -> Optional[str]:
    return txn.get(TXN_VERSION)
