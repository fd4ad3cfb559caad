"""The client half of the state-proof plane.

Twin of ``indy_plenum_tpu/client/`` as far as the port goes:
:mod:`.state_proof` (``StateProofReply``, ``verify_proved_read`` and the
pool multi-signature check). The reference's ``client.py`` and
``wallet.py`` come with the deployed-node slice.
"""
from .state_proof import StateProofReply, verify_proved_read

__all__ = ["StateProofReply", "verify_proved_read"]
