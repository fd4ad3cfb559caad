"""Client request object with canonical digest.

Copy of ``Request`` from ``indy_plenum_tpu/common/request.py`` (reference:
plenum/common/request.py). A request is {identifier, reqId, operation,
protocolVersion, signature | signatures}; its ``digest`` is sha256 over
the canonical signing serialization of everything except the
signature(s). The wire-validating ``SafeRequest`` stays with the node
runtime, which comes to the port with the consensus services.
"""
from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Optional

from .constants import CURRENT_PROTOCOL_VERSION, TXN_TYPE, f
from .serializers.serialization import serialize_for_signing


class Request:
    def __init__(self,
                 identifier: Optional[str] = None,
                 reqId: Optional[int] = None,
                 operation: Optional[Dict[str, Any]] = None,
                 signature: Optional[str] = None,
                 signatures: Optional[Dict[str, str]] = None,
                 protocolVersion: Optional[int] = CURRENT_PROTOCOL_VERSION):
        self.identifier = identifier
        self.reqId = reqId
        self.operation = operation or {}
        self.signature = signature
        self.signatures = signatures
        self.protocolVersion = protocolVersion
        # content hashes computed ONCE on first access: mutate the payload
        # only before the first read
        self._digest: Optional[str] = None
        self._payload_digest: Optional[str] = None

    @property
    def key(self) -> str:
        return self.digest

    @property
    def digest(self) -> str:
        if self._digest is None:
            self._digest = hashlib.sha256(
                serialize_for_signing(self.signing_payload())).hexdigest()
        return self._digest

    @property
    def payload_digest(self) -> str:
        """Digest without identifier (replay detection across
        differently-signed duplicates)."""
        if self._payload_digest is None:
            payload = self.signing_payload()
            payload.pop(f.IDENTIFIER, None)
            self._payload_digest = hashlib.sha256(
                serialize_for_signing(payload)).hexdigest()
        return self._payload_digest

    def signing_payload(self) -> Dict[str, Any]:
        return {
            f.IDENTIFIER: self.identifier,
            f.REQ_ID: self.reqId,
            f.OPERATION: self.operation,
            f.PROTOCOL_VERSION: self.protocolVersion,
        }

    def signing_bytes(self) -> bytes:
        return serialize_for_signing(self.signing_payload())

    @property
    def txn_type(self) -> Optional[str]:
        return self.operation.get(TXN_TYPE)

    def all_identifiers(self) -> List[str]:
        """Signer identifiers: single signature or multi-sig endorsements."""
        out = []
        if self.signatures:
            out.extend(self.signatures.keys())
        if self.identifier and self.identifier not in out:
            out.append(self.identifier)
        return out

    def as_dict(self) -> Dict[str, Any]:
        out = {
            f.IDENTIFIER: self.identifier,
            f.REQ_ID: self.reqId,
            f.OPERATION: self.operation,
            f.PROTOCOL_VERSION: self.protocolVersion,
        }
        if self.signature is not None:
            out[f.SIGNATURE] = self.signature
        if self.signatures is not None:
            out[f.SIGNATURES] = self.signatures
        return out

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Request":
        return cls(
            identifier=data.get(f.IDENTIFIER),
            reqId=data.get(f.REQ_ID),
            operation=data.get(f.OPERATION),
            signature=data.get(f.SIGNATURE),
            signatures=data.get(f.SIGNATURES),
            protocolVersion=data.get(f.PROTOCOL_VERSION,
                                     CURRENT_PROTOCOL_VERSION),
        )

    def __eq__(self, other):
        return isinstance(other, Request) and self.as_dict() == other.as_dict()

    def __hash__(self):
        return hash(self.digest)

    def __repr__(self):
        return (f"Request(identifier={self.identifier!r}, "
                f"reqId={self.reqId!r}, op={self.operation!r})")
