"""The pool's authenticated key/value state: a binary sparse Merkle tree
of depth 256.

A key's path is the 256 bits of sha256(key), most significant first. A
written leaf hashes H(0x00 || sha256(key) || value); an internal node
H(0x01 || left || right); an empty subtree at depth ``d`` has the default
hash ``DEFAULTS[d]`` (``DEFAULTS[256] = H("")``). This is the layout the
program documents for its state (the module docstring of its
``state/sparse_merkle_state.py``), written out again.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Tuple

DEPTH = 256


def _h(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def _defaults() -> List[bytes]:
    out = [b""] * (DEPTH + 1)
    out[DEPTH] = _h(b"")
    for d in range(DEPTH - 1, -1, -1):
        out[d] = _h(b"\x01" + out[d + 1] + out[d + 1])
    return out


DEFAULTS = _defaults()


class SparseMerkleTree:
    """Incremental: :meth:`set` rehashes the key's path, :attr:`root` is
    the current root."""

    def __init__(self):
        # (depth, prefix of that many path bits) -> hash, non-default only
        self._nodes: Dict[Tuple[int, int], bytes] = {}

    def _get(self, depth: int, prefix: int) -> bytes:
        return self._nodes.get((depth, prefix), DEFAULTS[depth])

    def set(self, key: bytes, value: bytes) -> None:
        digest = _h(key)
        path = int.from_bytes(digest, "big")
        h = _h(b"\x00" + digest + value)
        self._nodes[(DEPTH, path)] = h
        for depth in range(DEPTH - 1, -1, -1):
            child = path >> (DEPTH - depth - 1)
            sibling = self._get(depth + 1, child ^ 1)
            h = _h(b"\x01" + sibling + h) if child & 1 \
                else _h(b"\x01" + h + sibling)
            self._nodes[(depth, child >> 1)] = h

    @property
    def root(self) -> bytes:
        return self._get(0, 0)
