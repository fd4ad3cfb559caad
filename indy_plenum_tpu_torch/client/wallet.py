"""Wallet: client-side identity and signing-key management.

Reference: plenum/client/wallet.py (`Wallet`) — holds a client's DIDs and
their signing keys, signs outgoing requests, allocates monotonically
increasing per-identifier request ids (node-side replay protection keys
on them), and persists to disk. Secrets are written owner-only (0600),
the same posture as the pool key directories in
the reference's ``indy_plenum_tpu/tools/local_pool.py``.

Copy of ``indy_plenum_tpu/client/wallet.py``, with its imports bound to
the port.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Optional

from ..common.request import Request
from ..crypto.signers import DidSigner, Signer, SimpleSigner


class Wallet:
    def __init__(self, name: str = "wallet"):
        self.name = name
        self._signers: Dict[str, Signer] = {}  # identifier -> signer
        self.default_id: Optional[str] = None
        # last issued reqId per identifier: nodes dedup on
        # (identifier, reqId) payload digests, and the pool client refuses
        # a reused pair while one is in flight — monotone ids avoid both
        self._req_ids: Dict[str, int] = {}

    # --- identities -----------------------------------------------------

    def add_identifier(self, seed: Optional[bytes] = None,
                       did: bool = True) -> Signer:
        """Create (or import, given a seed) an identity; the first one
        becomes the default."""
        signer: Signer = DidSigner(seed) if did else SimpleSigner(seed)
        self._signers[signer.identifier] = signer
        if self.default_id is None:
            self.default_id = signer.identifier
        return signer

    def add_signer(self, signer: Signer) -> Signer:
        self._signers[signer.identifier] = signer
        if self.default_id is None:
            self.default_id = signer.identifier
        return signer

    @property
    def identifiers(self) -> List[str]:
        return list(self._signers)

    def signer(self, identifier: Optional[str] = None) -> Signer:
        ident = identifier or self.default_id
        if ident is None or ident not in self._signers:
            raise KeyError(f"no signer for identifier {ident!r}")
        return self._signers[ident]

    # --- requests -------------------------------------------------------

    def next_req_id(self, identifier: Optional[str] = None) -> int:
        ident = identifier or self.default_id
        self._req_ids[ident] = self._req_ids.get(ident, 0) + 1
        return self._req_ids[ident]

    def sign_request(self, request: Request,
                     identifier: Optional[str] = None) -> Request:
        self.signer(identifier).sign_request(request)
        return request

    def new_request(self, operation: dict,
                    identifier: Optional[str] = None) -> Request:
        """A signed request with a fresh reqId under ``identifier``."""
        ident = identifier or self.default_id
        req = Request(identifier=ident,
                      reqId=self.next_req_id(ident),
                      operation=dict(operation))
        return self.sign_request(req, ident)

    def endorse_request(self, request: Request,
                        identifiers: Iterable[str]) -> Request:
        """Multi-signature endorsement: each identifier adds an entry to
        ``request.signatures`` (the node verifies every one)."""
        for ident in identifiers:
            self.signer(ident).endorse_request(request)
        return request

    # --- persistence ----------------------------------------------------

    def save(self, path: str) -> None:
        """Owner-only secret file (seeds are the keys themselves)."""
        payload = {
            "name": self.name,
            "default_id": self.default_id,
            "req_ids": dict(self._req_ids),
            "identities": [
                {"seed": s.seed.hex(),
                 "did": isinstance(s, DidSigner)}
                for s in self._signers.values()],
        }
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        # O_CREAT's mode only applies to NEW files; overwriting an
        # existing wider-permissioned file must not leak the seeds
        os.fchmod(fd, 0o600)
        with os.fdopen(fd, "w") as fh:
            json.dump(payload, fh)

    @classmethod
    def load(cls, path: str) -> "Wallet":
        with open(path) as fh:
            payload = json.load(fh)
        wallet = cls(payload.get("name", "wallet"))
        for entry in payload.get("identities", []):
            wallet.add_identifier(bytes.fromhex(entry["seed"]),
                                  did=entry.get("did", True))
        wallet.default_id = payload.get("default_id", wallet.default_id)
        wallet._req_ids = {k: int(v)
                           for k, v in payload.get("req_ids", {}).items()}
        return wallet
