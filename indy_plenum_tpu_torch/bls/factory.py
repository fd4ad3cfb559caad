"""BLS wiring helpers (reference: plenum/bls/bls_crypto_factory.py,
bls_bft_factory.py — the plugin seam building signer/verifier/replica).

Copy of ``indy_plenum_tpu/bls/factory.py``, with its imports bound to
the port.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from ..crypto.bls.bls_crypto import BlsCryptoSigner, BlsKeyPair
from .bls_bft_replica import BlsBftReplica
from .bls_key_register import BlsKeyRegister
from .bls_store import BlsStore


def generate_bls_keys(seed: bytes) -> Tuple[BlsKeyPair, str, str]:
    """seed -> (keypair, pk_b58, proof_of_possession_b58)."""
    kp = BlsKeyPair(seed)
    return kp, kp.pk_b58, kp.pop()


def create_bls_bft_replica(node_name: str,
                           keypair: BlsKeyPair,
                           pool_keys: Dict[str, Tuple[str, str]],
                           store: Optional[BlsStore] = None,
                           pool_state_root_provider=None,
                           suspicion_sink=None) -> BlsBftReplica:
    """pool_keys: node name -> (pk_b58, pop_b58); PoP verified on load."""
    register = BlsKeyRegister()
    for name, (pk, pop) in pool_keys.items():
        register.add_key(name, pk, pop, require_pop=True)
    return BlsBftReplica(
        node_name=node_name,
        signer=BlsCryptoSigner(keypair),
        key_register=register,
        store=store,
        pool_state_root_provider=pool_state_root_provider,
        suspicion_sink=suspicion_sink,
    )
