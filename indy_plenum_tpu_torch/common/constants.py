"""The wire names a request and a NYM payload use.

Copy of the part of ``indy_plenum_tpu/common/constants.py`` (reference:
plenum/common/constants.py and plenum/common/types.py ``f``) that
``common.request`` and the ingress drivers need.
"""

NYM = "1"  # domain: identity CRUD
TARGET_NYM = "dest"
VERKEY = "verkey"
ROLE = "role"
TXN_TYPE = "type"
CURRENT_PROTOCOL_VERSION = 2


class f:
    """Wire field names of a request."""

    IDENTIFIER = "identifier"
    REQ_ID = "reqId"
    OPERATION = "operation"
    SIGNATURE = "signature"
    SIGNATURES = "signatures"  # multi-sig endorsements
    PROTOCOL_VERSION = "protocolVersion"
