"""Audit-path and consistency-proof verification (host scalar path).

Reference: ledger/merkle_verifier.py (`MerkleVerifier`, `STH` in
ledger/util.py). The bulk path — verifying thousands of catchup txns at
once — is the batched device kernel in
:mod:`indy_plenum_tpu_torch.tpu.sha256` (K10); this host
verifier is the scalar oracle and the client-side implementation.

Copy of ``indy_plenum_tpu/ledger/merkle_verifier.py``,
with its imports bound to the port.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

from .tree_hasher import TreeHasher


class STH(NamedTuple):
    """Signed tree head (size + root)."""

    tree_size: int
    sha256_root_hash: bytes


class MerkleVerifier:
    def __init__(self, hasher: Optional[TreeHasher] = None):
        self.hasher = hasher or TreeHasher()

    def root_from_audit_path(self, leaf_hash: bytes, index: int,
                             audit_path: Sequence[bytes],
                             tree_size: int) -> bytes:
        """Fold a leaf-to-root audit path into the implied root hash."""
        fn, fsn = index, tree_size - 1
        r = leaf_hash
        for sibling in audit_path:
            if fsn == 0:
                raise ValueError("audit path longer than expected")
            if fn % 2 or fn == fsn:
                r = self.hasher.hash_children(sibling, r)
                while fn % 2 == 0 and fn != 0:
                    fn >>= 1
                    fsn >>= 1
            else:
                r = self.hasher.hash_children(r, sibling)
            fn >>= 1
            fsn >>= 1
        if fsn != 0:
            raise ValueError("audit path shorter than expected")
        return r

    def verify_leaf_inclusion(self, leaf_data: bytes, index: int,
                              audit_path: Sequence[bytes], sth: STH) -> bool:
        try:
            root = self.root_from_audit_path(
                self.hasher.hash_leaf(leaf_data), index, audit_path,
                sth.tree_size)
        except ValueError:
            return False
        return root == sth.sha256_root_hash

    def verify_consistency(self, old_size: int, new_size: int,
                           old_root: bytes, new_root: bytes,
                           proof: Sequence[bytes]) -> bool:
        """RFC 6962 consistency-proof check between two tree heads."""
        if old_size > new_size:
            return False
        if old_size == new_size:
            return old_root == new_root and not proof
        if old_size == 0:
            return not proof
        node, last_node = old_size - 1, new_size - 1
        while node % 2:
            node >>= 1
            last_node >>= 1
        proof = list(proof)
        if node:
            if not proof:
                return False
            new_hash = old_hash = proof.pop(0)
        else:
            new_hash = old_hash = old_root
        while node:
            if node % 2:
                if not proof:
                    return False
                nxt = proof.pop(0)
                old_hash = self.hasher.hash_children(nxt, old_hash)
                new_hash = self.hasher.hash_children(nxt, new_hash)
            elif node < last_node:
                if not proof:
                    return False
                new_hash = self.hasher.hash_children(
                    new_hash, proof.pop(0))
            node >>= 1
            last_node >>= 1
        if old_hash != old_root:
            return False
        while last_node:
            if not proof:
                return False
            new_hash = self.hasher.hash_children(new_hash, proof.pop(0))
            last_node >>= 1
        return new_hash == new_root and not proof
