"""BLS protocol integration: BlsBftReplica, BlsStore, key register, factory.

Reference: plenum/bls/ (bls_bft_replica_plenum.py, bls_crypto_factory.py,
bls_store.py, bls_key_register_pool_manager.py).

Copy of ``indy_plenum_tpu/bls/__init__.py``, with its imports bound to
the port.
"""
from .bls_bft_replica import BlsBftReplica
from .bls_key_register import BlsKeyRegister
from .bls_store import BlsStore
from .factory import create_bls_bft_replica, generate_bls_keys

__all__ = ["BlsBftReplica", "BlsKeyRegister", "BlsStore",
           "create_bls_bft_replica", "generate_bls_keys"]
