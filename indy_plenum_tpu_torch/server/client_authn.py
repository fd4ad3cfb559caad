"""Client request authentication, batch-verified on the CUDA card.

Port of ``indy_plenum_tpu/server/client_authn.py`` (reference:
plenum/server/client_authn.py ``CoreAuthNr``,
plenum/server/req_authenticator.py ``ReqAuthenticator``).
``CoreAuthNr.authenticate`` resolves the signer's verkey and verifies the
request's canonical signing bytes on the host (the oracle);
``authenticate_batch`` is the ingress hot path: every attached signature
of a whole drain becomes one entry of ONE device verify. The reference
pads a drain to a bucket size so that XLA compiles a few shapes only; a
CUDA kernel (and the plain version) takes any batch, so the port verifies
exactly the drain's entries.

Every drain hashes on the device (``tpu.ed25519.verify_kernel_full``:
SHA-512 -> mod L -> curve check); the host only packs padded blocks. The
reference gates that tier on XLA-compiled shapes, to keep a compile off
the protocol path; a CUDA kernel takes any shape without compiling, so
the port has one tier and :func:`warm_device_auth_path` only builds and
loads the kernel library ahead of the first drain.
"""
from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..common.exceptions import (
    CouldNotAuthenticate,
    InsufficientSignatures,
    InvalidSignature,
    MissingSignature,
)
from ..common.request import Request
from ..crypto import ed25519 as ed
from ..crypto.signers import resolve_verkey_bytes
from ..tpu import ed25519 as ted
from ..utils import kernel_build
from ..utils.base58 import b58decode
from ..utils.torch_env import DeviceLike, resolve_device

logger = logging.getLogger(__name__)

def warm_device_auth_path(device: DeviceLike = None) -> None:
    """Build and load the kernel library OFF the protocol path: the only
    first-use cost a CUDA kernel has. Nothing to do for ``device="cpu"``."""
    if resolve_device(device).type == "cuda":
        kernel_build.library()


class ClientAuthNr:
    """Authenticator interface (reference: ClientAuthNr ABC)."""

    def authenticate(self, req: Request) -> List[str]:
        raise NotImplementedError

    def authenticate_batch(self, reqs: Sequence[Request]) -> np.ndarray:
        raise NotImplementedError


class CoreAuthNr(ClientAuthNr):
    """Verkey resolution + Ed25519 verification.

    ``verkey_source`` is any object with ``get_nym_data(idr,
    is_committed)`` returning the NYM record dict; ``seed_keys`` maps
    genesis identifiers to wire verkeys. Batches verify on the card unless
    ``device="cpu"``.
    """

    def __init__(self, verkey_source=None,
                 seed_keys: Optional[Dict[str, str]] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self._source = verkey_source
        self._seed_keys = dict(seed_keys or {})

    # --- verkey resolution ---------------------------------------------

    def resolve_verkey(self, identifier: str) -> Optional[bytes]:
        if self._source is not None:
            data = self._source.get_nym_data(identifier, is_committed=True)
            if data is not None:
                try:
                    return resolve_verkey_bytes(
                        identifier, data.get("verkey"))
                except ValueError:
                    return None
        wire = self._seed_keys.get(identifier)
        if wire is not None:
            try:
                return resolve_verkey_bytes(identifier, wire)
            except ValueError:
                return None
        # cryptonym: the identifier may itself be a full verkey
        try:
            raw = b58decode(identifier)
        except ValueError:
            return None
        return raw if len(raw) == 32 else None

    # --- single (host oracle) ------------------------------------------

    def authenticate(self, req: Request) -> List[str]:
        """Verify all signatures on one request; return verified idrs."""
        sigs = dict(req.signatures or {})
        if req.signature:
            sigs.setdefault(req.identifier, req.signature)
        if not sigs:
            raise MissingSignature(req.identifier)
        data = req.signing_bytes()
        verified = []
        for idr, sig_b58 in sigs.items():
            vk = self.resolve_verkey(idr)
            if vk is None:
                raise CouldNotAuthenticate(idr)
            try:
                sig = b58decode(sig_b58)
            except ValueError:
                raise InvalidSignature(idr) from None
            if not ed.fast_verify(vk, data, sig):
                raise InvalidSignature(idr)
            verified.append(idr)
        if not verified:
            raise InsufficientSignatures(0, 1)
        return verified

    # --- batched (the device hot path) ---------------------------------

    def authenticate_batch(self, reqs: Sequence[Request]) -> np.ndarray:
        """Device-verify a request batch; (B,) bool verdicts.

        Every attached signature is one batch entry; a request verifies
        only if ALL of its entries verify. Requests whose verkey cannot be
        resolved or whose signature is structurally invalid fail without
        touching the device; the rest are verified in one kernel chain.
        """
        n = len(reqs)
        verdict = np.zeros(n, bool)
        entry_req: List[int] = []  # owning request index per entry
        pks, msgs, sigs = [], [], []
        candidate = np.zeros(n, bool)
        for i, req in enumerate(reqs):
            pairs = dict(req.signatures or {})
            if req.signature:
                pairs.setdefault(req.identifier, req.signature)
            if not pairs:
                continue
            data = req.signing_bytes()
            local = []
            for idr in sorted(pairs):
                vk = self.resolve_verkey(idr)
                if vk is None:
                    break
                try:
                    sig = b58decode(pairs[idr])
                except ValueError:
                    break
                if len(sig) != 64:
                    break
                local.append((vk, sig))
            else:
                candidate[i] = True
                for vk, sig in local:
                    entry_req.append(i)
                    pks.append(vk)
                    msgs.append(data)
                    sigs.append(sig)
        if not entry_req:
            return verdict

        ok = self._verify_entries(pks, msgs, sigs)
        owners = np.asarray(entry_req)
        bad_per_req = np.bincount(owners[~ok], minlength=n)
        return candidate & (bad_per_req == 0)

    def _verify_entries(self, pks: List[bytes], msgs: List[bytes],
                        sigs: List[bytes]) -> np.ndarray:
        """One device verify of the drain's entries; (m,) bool with the
        structural checks folded in."""
        (pk_a, r_a, s_a, blocks, counts,
         pre) = ted.prepare_batch_device(pks, msgs, sigs,
                                         ted.max_blocks_for(msgs))
        ok = ted.verify_kernel_full(*ted.to_device(
            (pk_a, r_a, s_a, blocks, counts), self.device))
        # one batched sync per ingress drain: the verdicts decide admission
        return ok.cpu().numpy() & pre


class ReqAuthenticator:
    """Registry composing authenticators (reference: ReqAuthenticator)."""

    def __init__(self):
        self._authenticators: List[ClientAuthNr] = []

    def register_authenticator(self, authnr: ClientAuthNr) -> None:
        self._authenticators.append(authnr)

    @property
    def core_authenticator(self) -> Optional[CoreAuthNr]:
        for a in self._authenticators:
            if isinstance(a, CoreAuthNr):
                return a
        return None

    def authenticate(self, req: Request) -> List[str]:
        if not self._authenticators:
            raise CouldNotAuthenticate(req.identifier)
        identifiers: List[str] = []
        for authnr in self._authenticators:
            identifiers.extend(authnr.authenticate(req))
        return identifiers
