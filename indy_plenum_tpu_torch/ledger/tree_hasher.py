"""RFC 6962 tree hashing (domain-separated SHA-256).

Reference: ledger/tree_hasher.py. leaf = H(0x00 || data),
node = H(0x01 || left || right); the empty tree hashes to H(b"").

Copy of ``indy_plenum_tpu/ledger/tree_hasher.py``,
with its imports bound to the port.
"""
from __future__ import annotations

import hashlib

LEAF_PREFIX = b"\x00"
NODE_PREFIX = b"\x01"


class TreeHasher:
    def __init__(self, hashfunc=hashlib.sha256):
        self._hashfunc = hashfunc

    def hash_empty(self) -> bytes:
        return self._hashfunc(b"").digest()

    def hash_leaf(self, data: bytes) -> bytes:
        return self._hashfunc(LEAF_PREFIX + data).digest()

    def hash_children(self, left: bytes, right: bytes) -> bytes:
        return self._hashfunc(NODE_PREFIX + left + right).digest()

    def hash_full_tree(self, leaves) -> bytes:
        """MTH over a list of raw leaf payloads (test oracle; O(n))."""
        n = len(leaves)
        if n == 0:
            return self.hash_empty()
        if n == 1:
            return self.hash_leaf(leaves[0])
        k = _largest_power_of_two_smaller_than(n)
        return self.hash_children(
            self.hash_full_tree(leaves[:k]), self.hash_full_tree(leaves[k:]))


def _largest_power_of_two_smaller_than(n: int) -> int:
    k = 1
    while k * 2 < n:
        k *= 2
    return k
