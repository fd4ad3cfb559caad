"""RFC 6962 / RFC 9162 Merkle trees over a ledger's serialized txns.

Leaf hash H(0x00 || data), node hash H(0x01 || left || right), the empty
tree H(""). :class:`PrefixRoots` gives the root of every prefix of a leaf
list; :func:`verify_inclusion` checks an audit path as RFC 9162, section
2.1.3.2, sets out.
"""
from __future__ import annotations

import hashlib
from typing import List, Sequence


def leaf_hash(data: bytes) -> bytes:
    return hashlib.sha256(b"\x00" + data).digest()


def node_hash(left: bytes, right: bytes) -> bytes:
    return hashlib.sha256(b"\x01" + left + right).digest()


EMPTY_ROOT = hashlib.sha256(b"").digest()


class PrefixRoots:
    """``roots[n]`` is the root of the first ``n`` leaves. Built in one
    pass with the stack of full subtrees a compact Merkle tree keeps."""

    def __init__(self, leaves: Sequence[bytes]):
        self.roots: List[bytes] = [EMPTY_ROOT]
        stack: List[tuple] = []  # (height, hash), heights strictly falling
        for data in leaves:
            h, height = leaf_hash(data), 0
            while stack and stack[-1][0] == height:
                h = node_hash(stack.pop()[1], h)
                height += 1
            stack.append((height, h))
            root = stack[-1][1]
            for _, left in reversed(stack[:-1]):
                root = node_hash(left, root)
            self.roots.append(root)

    def root(self, size: int) -> bytes:
        return self.roots[size]


def verify_inclusion(data: bytes, index: int, size: int,
                     path: Sequence[bytes], root: bytes) -> bool:
    """Leaf ``index`` (0-based) of a tree of ``size`` leaves holds ``data``
    under ``root`` by ``path``."""
    if not 0 <= index < size:
        return False
    fn, sn = index, size - 1
    r = leaf_hash(data)
    for p in path:
        if sn == 0:
            return False
        if fn & 1 or fn == sn:
            r = node_hash(p, r)
            while not fn & 1 and fn != 0:
                fn >>= 1
                sn >>= 1
        else:
            r = node_hash(r, p)
        fn >>= 1
        sn >>= 1
    return sn == 0 and r == root
