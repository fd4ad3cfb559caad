"""Stack key management: deterministic CurveZMQ keypairs from seeds.

Copy of ``indy_plenum_tpu/network/keys.py`` (reference: plenum's key-init
utilities, plenum/common/keygen_utils.py, stp_core key directories). A
node's transport identity is its Curve25519 keypair; the pool's key
registry (a dict name -> public key, fed from the pool ledger) is what
lets the ZAP authenticator pin every inbound connection to a known
validator.
"""
from __future__ import annotations

import hashlib
from typing import Tuple

import zmq
import zmq.utils.z85 as z85


def client_stack_keypair_from_seed(seed: bytes) -> Tuple[bytes, bytes]:
    """The node's CLIENT-facing listener identity, derived separately from
    its node-to-node key (publishing it must leak nothing about the
    inter-validator plane). The single definition both the listener
    (ClientZStack) and pool provisioning (generate_pool_config) use — two
    copies of this derivation would silently desync the published
    client_public from the key actually served."""
    return curve_keypair_from_seed(
        hashlib.sha256(b"client-stack" + seed).digest())


def curve_keypair_from_seed(seed: bytes) -> Tuple[bytes, bytes]:
    """(public_z85, secret_z85) derived deterministically from ``seed``.

    Any 32 bytes are a valid Curve25519 secret (libzmq clamps); hashing
    the seed decouples the wire key from other uses of the same seed.
    """
    if len(seed) != 32:
        raise ValueError("seed must be 32 bytes")
    secret_raw = hashlib.sha256(b"zstack-curve" + seed).digest()
    secret_z85 = z85.encode(secret_raw)
    public_z85 = zmq.curve_public(secret_z85)
    return public_z85, secret_z85
