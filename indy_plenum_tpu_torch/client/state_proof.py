"""Client-side state-proof verification: trust ONE node's answer.

Reference: the client half of SURVEY.md §3.5 — a read reply carries
{value, state proof, BLS multi-signature}; the client checks (a) the
sparse-Merkle inclusion proof against the claimed root and (b) the pool's
n-f multi-signature over that root, so a single node's reply is as
trustworthy as f+1 matching replies.

Copy of ``indy_plenum_tpu/client/state_proof.py``, with its imports bound to
the port.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

from ..crypto.bls.bls_crypto import BlsCryptoVerifier, MultiSignature
from ..state.sparse_merkle_state import verify_state_proof
from ..utils.base58 import b58decode, b58encode


class StateProofReply:
    """What a node returns for a proved read."""

    def __init__(self, key: bytes, value: Optional[bytes],
                 root: bytes, proof: bytes,
                 multi_sig_dict: Optional[dict]):
        self.key = key
        self.value = value
        self.root = root
        self.proof = proof
        self.multi_sig = (MultiSignature.from_dict(multi_sig_dict)
                          if multi_sig_dict else None)

    def as_dict(self) -> dict:
        return {
            "key": self.key,
            "value": self.value,
            "root": b58encode(self.root),
            "proof": self.proof,
            "multi_sig": self.multi_sig.as_dict() if self.multi_sig else None,
        }


def verify_proved_reply(reply: StateProofReply,
                        pool_bls_keys: Dict[str, str],
                        min_participants: int,
                        now: Optional[float] = None,
                        max_age: Optional[float] = None) -> bool:
    """True iff the reply proves (key -> value) under a root co-signed by
    >= min_participants validators (n-f for the reading client).

    ``pool_bls_keys``: node name -> BLS pk b58 (from the pool ledger /
    genesis — the client's trust anchor). When ``now``/``max_age`` are
    given, the multi-signature's timestamp must be recent: a byzantine
    node holding an OLD root with a genuine pool signature could otherwise
    serve provably-signed stale state (e.g. an absence proof for a key
    written since).
    """
    # 1. the Merkle proof binds (key, value) to the root
    if not verify_state_proof(reply.root, reply.key, reply.value,
                              reply.proof):
        return False
    # 2. the multi-sig binds the root to the pool
    ms = reply.multi_sig
    if ms is None:
        return False
    if ms.value.state_root_hash != b58encode(reply.root):
        return False
    return verify_pool_multi_sig(ms, pool_bls_keys, min_participants,
                                 now=now, max_age=max_age)


def verify_proved_read(read,
                       pool_bls_keys: Dict[str, str],
                       min_participants: int,
                       now: Optional[float] = None,
                       max_age: Optional[float] = None) -> bool:
    """Verify a :class:`~indy_plenum_tpu_torch.ingress.read_service.ProofRead`
    end-to-end with nothing but the pool's BLS keys (the state-proof
    plane's client half — README "State-proof plane").

    Three bindings, each independently forgeable only by breaking the
    crypto: (1) the RFC 6962 audit path binds (index, leaf) to ``root``
    at ``tree_size``; (2) the multi-signature's ``txn_root_hash`` binds
    ``root`` to the value the pool co-signed at a stabilized checkpoint
    window; (3) :func:`verify_pool_multi_sig` binds that value to
    >= ``min_participants`` pool validators. A flipped root, flipped
    signature, tampered participant set, or a proof replayed against a
    different window's root all fail one of the three. ``now``/
    ``max_age`` additionally reject STALE windows: a byzantine node
    replaying a genuinely-signed old window (e.g. an absence proof for a
    key written since) fails the freshness check even though every
    binding above holds.

    ``read`` needs ``leaf`` / ``index`` / ``path`` / ``tree_size`` /
    ``root`` / ``multi_sig`` attributes (``multi_sig`` may be the wire
    dict or a :class:`MultiSignature`).
    """
    ms = getattr(read, "multi_sig", None)
    if ms is None:
        return False
    if not isinstance(ms, MultiSignature):
        try:
            ms = MultiSignature.from_dict(dict(ms))
        except (KeyError, TypeError, ValueError):
            return False
    # 1. the audit path binds (index, leaf) to the root. The reply is
    # UNTRUSTED input: malformed fields (str root, non-bytes path
    # elements, ...) must be a False verdict, never an exception out of
    # the client's read loop — TypeError covers the bytes-concat and
    # hashing paths ValueError/IndexError do not
    if not isinstance(read.root, (bytes, bytearray)):
        return False
    from ..ledger.merkle_verifier import STH, MerkleVerifier

    try:
        ok = MerkleVerifier().verify_leaf_inclusion(
            read.leaf, read.index, read.path,
            STH(read.tree_size, read.root))
    except (ValueError, IndexError, TypeError):
        return False
    if not ok:
        return False
    # 2. the multi-sig's signed value names exactly this root
    if ms.value.txn_root_hash != b58encode(read.root):
        return False
    # 3. the pool signed that value (+ optional freshness)
    return verify_pool_multi_sig(ms, pool_bls_keys, min_participants,
                                 now=now, max_age=max_age)


def verify_read_binding(read) -> bool:
    """Bindings (1)+(2) of :func:`verify_proved_read` WITHOUT the
    multi-signature pairing check: the RFC 6962 audit path binds
    ``(index, leaf)`` to ``root`` at ``tree_size``, and the attached
    multi-sig's signed value names exactly that root.

    The geo plane's edge clients use this to amortize the pairing cost
    across a window (README "Planet-scale read fabric"): ONE full
    :func:`verify_proved_read` per distinct (window, signature,
    participants) establishes pool trust in the signed root; every
    further reply claiming the SAME signed material needs only these
    two offline bindings — a tampered leaf, path, or root fails here,
    and a reply smuggling a DIFFERENT multi-sig misses the caller's
    trust key and pays the full verification (which then fails)."""
    ms = getattr(read, "multi_sig", None)
    if ms is None:
        return False
    if not isinstance(read.root, (bytes, bytearray)):
        return False
    from ..ledger.merkle_verifier import STH, MerkleVerifier

    try:
        ok = MerkleVerifier().verify_leaf_inclusion(
            read.leaf, read.index, read.path,
            STH(read.tree_size, read.root))
    except (ValueError, IndexError, TypeError):
        return False
    if not ok:
        return False
    if isinstance(ms, MultiSignature):
        txn_root = ms.value.txn_root_hash
    else:
        try:
            txn_root = dict(ms).get("value", {}).get("txn_root_hash")
        except (TypeError, ValueError, AttributeError):
            return False
    return txn_root == b58encode(read.root)


def verify_pool_multi_sig(ms: MultiSignature,
                          pool_bls_keys: Dict[str, str],
                          min_participants: int,
                          now: Optional[float] = None,
                          max_age: Optional[float] = None) -> bool:
    """True iff ``ms`` is a genuine >=min_participants co-signature by
    pool members over its own value (roots + timestamp). Shared by proved
    reads and the observer plane — anything that trusts a pool-signed
    root goes through here."""
    if now is not None and max_age is not None:
        ts = ms.value.timestamp
        if not isinstance(ts, (int, float)) or now - ts > max_age:
            return False
    if len(set(ms.participants)) < min_participants:
        return False
    pks = []
    for name in ms.participants:
        pk = pool_bls_keys.get(name)
        if pk is None:
            return False  # signed by someone outside the pool
        pks.append(pk)
    return BlsCryptoVerifier.verify_multi_sig(
        ms.signature, ms.value.serialize(), pks)
