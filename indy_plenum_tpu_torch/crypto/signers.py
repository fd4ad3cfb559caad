"""Client-side request signers: simple and DID flavours.

Copy of ``indy_plenum_tpu/crypto/signers.py`` (reference:
plenum/common/signer_simple.py, signer_did.py, verifier.py). A signer owns
an Ed25519 seed and signs the canonical signing serialization of a
request; the two flavours differ only in how the identifier/verkey pair is
derived:

- SimpleSigner: identifier = base58(verkey) — the full verkey IS the id;
- DidSigner: identifier (the DID) = base58(verkey[:16]); the wire verkey is
  abbreviated as "~" + base58(verkey[16:]) (the DID supplies the prefix).
"""
from __future__ import annotations

import os
from typing import Optional

from ..utils.base58 import b58decode, b58encode
from . import ed25519 as ed


class Signer:
    def __init__(self, seed: Optional[bytes] = None):
        if seed is None:
            seed = os.urandom(32)
        if len(seed) != 32:
            raise ValueError("seed must be 32 bytes")
        self.seed = seed
        self.verkey_raw: bytes = ed.fast_public_key(seed)

    @property
    def identifier(self) -> str:
        raise NotImplementedError

    @property
    def verkey(self) -> str:
        """Wire form of the verkey (full or abbreviated)."""
        raise NotImplementedError

    def sign_bytes(self, data: bytes) -> bytes:
        return ed.fast_sign(self.seed, data)

    def sign_request(self, request) -> None:
        """Attach signature (single-sig) to a Request in place."""
        request.identifier = self.identifier
        request.signature = b58encode(self.sign_bytes(request.signing_bytes()))

    def endorse_request(self, request) -> None:
        """Add a multi-sig endorsement under this signer's identifier."""
        sig = b58encode(self.sign_bytes(request.signing_bytes()))
        if request.signatures is None:
            request.signatures = {}
        request.signatures[self.identifier] = sig


class SimpleSigner(Signer):
    @property
    def identifier(self) -> str:
        return b58encode(self.verkey_raw)

    @property
    def verkey(self) -> str:
        return b58encode(self.verkey_raw)


class DidSigner(Signer):
    @property
    def identifier(self) -> str:
        return b58encode(self.verkey_raw[:16])

    @property
    def verkey(self) -> str:
        return "~" + b58encode(self.verkey_raw[16:])

    @property
    def full_verkey(self) -> str:
        return b58encode(self.verkey_raw)


def resolve_verkey_bytes(identifier: str, verkey: Optional[str]) -> bytes:
    """Wire (identifier, verkey) -> raw 32-byte Ed25519 key.

    An abbreviated verkey ("~xyz") is completed with the DID bytes as
    prefix; a missing verkey means the identifier itself encodes the full
    key (SimpleSigner / cryptonym).
    """
    if verkey is None or verkey == "":
        raw = b58decode(identifier)
    elif verkey.startswith("~"):
        raw = b58decode(identifier) + b58decode(verkey[1:])
    else:
        raw = b58decode(verkey)
    if len(raw) != 32:
        raise ValueError(
            f"verkey for {identifier} is {len(raw)} bytes, expected 32")
    return raw
