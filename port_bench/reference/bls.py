"""BLS multi-signatures over BN254 as the pool makes them: signatures in
G1, public keys in G2, hash-to-G1 by try-and-increment over SHA-256, a
multi-signature checked against the sum of its participants' keys.

Keys come from the deployment's seeds (``key_seed``), as the validators
derive theirs; nothing is taken from the program. The encodings (a G1
point as x || y, a G2 point as x0 || x1 || y0 || y1, 32-byte big-endian
words, base58 on the wire) and the signed value (the canonical msgpack of
``ledger_id``, ``state_root_hash``, ``pool_state_root_hash``,
``txn_root_hash`` and ``timestamp``) are indy-plenum's
``MultiSignatureValue``.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Optional, Sequence

from . import bn254 as bn
from .b58 import b58decode, b58encode
from .msgpack import signing_bytes

VALUE_FIELDS = ("ledger_id", "state_root_hash", "pool_state_root_hash",
                "txn_root_hash", "timestamp")


def key_seed(node_name: str) -> bytes:
    return hashlib.sha256(b"sim-bls-" + node_name.encode()).digest()


def public_key(seed: bytes):
    sk = int.from_bytes(hashlib.sha512(b"bls-bn254-sk" + seed).digest(),
                        "big") % bn.R
    return bn.g2_mul(bn.G2_GEN, sk)


def g2_b58(pt) -> str:
    (x0, x1), (y0, y1) = pt
    return b58encode(b"".join(v.to_bytes(32, "big")
                              for v in (x0, x1, y0, y1)))


def g1_from_b58(text: str):
    data = b58decode(text)
    if len(data) != 64:
        return None
    pt = (int.from_bytes(data[:32], "big"), int.from_bytes(data[32:], "big"))
    if pt[0] >= bn.P or pt[1] >= bn.P or not bn.g1_is_on_curve(pt):
        return None
    return pt


def hash_to_g1(msg: bytes):
    ctr = 0
    while True:
        h = hashlib.sha256(msg + ctr.to_bytes(4, "big")).digest()
        x = int.from_bytes(h, "big") % bn.P
        rhs = (x * x * x + 3) % bn.P
        y = pow(rhs, (bn.P + 1) // 4, bn.P)  # p = 3 mod 4
        if y * y % bn.P == rhs:
            return (x, bn.P - y if y > bn.P // 2 else y)
        ctr += 1


def verify_multi_sig(multi_sig: dict, keys: Dict[str, object],
                     min_participants: int) -> bool:
    """``multi_sig`` as the pool serves it (``signature``,
    ``participants``, ``value``); ``keys`` node name -> G2 point."""
    participants: Sequence[str] = multi_sig.get("participants") or []
    if len(set(participants)) < min_participants \
            or any(p not in keys for p in participants):
        return False
    sig = g1_from_b58(multi_sig["signature"])
    if sig is None:
        return False
    apk: Optional[tuple] = None
    for p in sorted(set(participants)):
        apk = keys[p] if apk is None else bn.g2_add(apk, keys[p])
    value = multi_sig["value"]
    message = signing_bytes({k: value[k] for k in VALUE_FIELDS})
    return bn.pairing_check([(hash_to_g1(message), apk),
                             (bn.g1_neg(sig), bn.G2_GEN)])
