"""Exception taxonomy.

Reference: plenum/common/exceptions.py. Only the classes other components
actually raise/catch are kept; suspicion-carrying errors reference
:mod:`indy_plenum_tpu_torch.server.suspicion_codes`.

Copy of ``indy_plenum_tpu/common/exceptions.py``, with its imports bound to
the port.
"""
from __future__ import annotations


class PlenumError(Exception):
    """Base for all framework errors."""


class InvalidMessageError(PlenumError):
    """Schema/field validation failed on an inbound message."""


class InvalidClientRequest(PlenumError):
    def __init__(self, identifier=None, req_id=None, reason=""):
        self.identifier = identifier
        self.req_id = req_id
        self.reason = reason
        super().__init__(f"InvalidClientRequest({identifier}, {req_id}): {reason}")


class InvalidClientMessageException(InvalidClientRequest):
    pass


class UnauthorizedClientRequest(InvalidClientRequest):
    """Request failed dynamic authorization (role/ownership rules)."""


class CouldNotAuthenticate(PlenumError):
    def __init__(self, identifier=None):
        self.identifier = identifier
        super().__init__(f"could not authenticate {identifier}")


class InsufficientSignatures(CouldNotAuthenticate):
    def __init__(self, provided: int, required: int):
        self.provided = provided
        self.required = required
        PlenumError.__init__(
            self, f"insufficient signatures: {provided} of {required}"
        )


class MissingSignature(CouldNotAuthenticate):
    pass


class InvalidSignature(CouldNotAuthenticate):
    def __init__(self, identifier=None):
        self.identifier = identifier
        PlenumError.__init__(self, f"invalid signature by {identifier}")


class SuspiciousNode(PlenumError):
    """Byzantine evidence attributed to a peer (see suspicion_codes)."""

    def __init__(self, node: str, suspicion, offending_msg=None):
        self.node = node
        self.suspicion = suspicion
        self.offending_msg = offending_msg
        code = getattr(suspicion, "code", suspicion)
        reason = getattr(suspicion, "reason", "")
        super().__init__(f"suspicious node {node} ({code}): {reason}")


class SuspiciousClient(PlenumError):
    pass


class BlowUp(PlenumError):
    """Unrecoverable internal invariant violation — crash the node."""


class MismatchedMessageReplyException(PlenumError):
    """MESSAGE_RESPONSE did not match what was requested."""


class LedgerChronologicalOrderingError(PlenumError):
    pass


class StorageError(PlenumError):
    pass


class KeysNotFoundException(PlenumError):
    MSG = "Keys not found in the given directory; run key init first."
