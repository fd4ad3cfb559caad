"""The exceptions that request authentication raises.

Copy of the part of ``indy_plenum_tpu/common/exceptions.py`` (reference:
plenum/common/exceptions.py) that ``Request`` and ``CoreAuthNr`` use.
"""
from __future__ import annotations


class PlenumError(Exception):
    """Base for all framework errors."""


class InvalidClientRequest(PlenumError):
    def __init__(self, identifier=None, req_id=None, reason=""):
        self.identifier = identifier
        self.req_id = req_id
        self.reason = reason
        super().__init__(f"InvalidClientRequest({identifier}, {req_id}): {reason}")


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
