"""Validator BLS public keys, sourced from the pool (NODE txns / genesis).

Reference: plenum/bls/bls_key_register_pool_manager.py. Keys rotate via
NODE txns through consensus; the register answers "key of node X as of
now". Proof-of-possession is checked at registration (rogue-key defence).

Copy of ``indy_plenum_tpu/bls/bls_key_register.py``, with its imports bound to
the port.
"""
from __future__ import annotations

import logging
from typing import Dict, Optional

from ..crypto.bls.bls_crypto import BlsCryptoVerifier

logger = logging.getLogger(__name__)


class BlsKeyRegister:
    def __init__(self):
        self._keys: Dict[str, str] = {}  # node name -> pk b58

    def add_key(self, node_name: str, pk_b58: str,
                pop_b58: Optional[str] = None,
                require_pop: bool = False) -> bool:
        if pop_b58 is not None:
            if not BlsCryptoVerifier.verify_pop(pop_b58, pk_b58):
                logger.warning("rejecting BLS key for %s: bad proof of "
                               "possession", node_name)
                return False
        elif require_pop:
            logger.warning("rejecting BLS key for %s: missing proof of "
                           "possession", node_name)
            return False
        self._keys[node_name] = pk_b58
        return True

    def remove_key(self, node_name: str) -> None:
        """Demoted validator: its key must stop counting toward multi-sigs."""
        self._keys.pop(node_name, None)

    def get_key(self, node_name: str) -> Optional[str]:
        return self._keys.get(node_name)

    def get_keys(self, node_names) -> Optional[list]:
        out = []
        for name in node_names:
            pk = self._keys.get(name)
            if pk is None:
                return None
            out.append(pk)
        return out
