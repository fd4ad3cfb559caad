"""Append-only compact Merkle tree: O(log n) state, O(log n) append.

Reference: ledger/compact_merkle_tree.py. Keeps only the *frontier* (root
hashes of the maximal complete subtrees, one per set bit of the size);
full leaf/internal hashes go to a :class:`HashStore` so audit paths and
consistency proofs can be served.

Internal nodes are addressed by (level, offset): the complete subtree of
2^level leaves starting at leaf ``offset`` (offset aligned to 2^level).

Copy of ``indy_plenum_tpu/ledger/compact_merkle_tree.py``,
with its imports bound to the port.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from .hash_stores import HashStore, MemoryHashStore
from .tree_hasher import TreeHasher, _largest_power_of_two_smaller_than


class CompactMerkleTree:
    def __init__(self, hasher: Optional[TreeHasher] = None,
                 hash_store: Optional[HashStore] = None):
        self.hasher = hasher or TreeHasher()
        self.hash_store = hash_store or MemoryHashStore()
        self._size = 0
        self._frontier: List[bytes] = []  # index i = subtree of 2^i leaves
        self._load()

    # --- persistence ------------------------------------------------------

    def _load(self) -> None:
        n = self.hash_store.leaf_count
        self._size = n
        # frontier: index = level, value = hash of the complete subtree of
        # 2^level leaves at that position of the size's binary decomposition
        frontier: List[Optional[bytes]] = [None] * n.bit_length()
        for level in range(n.bit_length()):
            if (n >> level) & 1:
                offset = (n >> (level + 1)) << (level + 1)
                frontier[level] = self._stored_hash(level, offset)
        self._frontier = frontier  # type: ignore[assignment]

    def _stored_hash(self, level: int, offset: int) -> bytes:
        if level == 0:
            return self.hash_store.read_leaf(offset)
        return self.hash_store.read_node(level, offset)

    # --- append -----------------------------------------------------------

    def reset(self) -> None:
        """Forget all leaves (caller resets the hash store; catchup resync)."""
        self._size = 0
        self._frontier = []

    @property
    def tree_size(self) -> int:
        return self._size

    def __len__(self) -> int:
        return self._size

    @property
    def root_hash(self) -> bytes:
        # fold the frontier (O(log n), no store reads)
        return self.root_with_extra_leaves(())

    def append(self, leaf_data: bytes) -> bytes:
        """Append one leaf; persists hashes; returns the leaf hash."""
        leaf_hash = self.hasher.hash_leaf(leaf_data)
        index = self._size
        self.hash_store.write_leaf(index, leaf_hash)
        h = leaf_hash
        level = 0
        # merge complete subtrees upward wherever the size bit is set
        while level < len(self._frontier) and self._frontier[level] is not None:
            h = self.hasher.hash_children(self._frontier[level], h)
            self._frontier[level] = None
            level += 1
            offset = ((index + 1) - (1 << level))
            self.hash_store.write_node(level, offset, h)
        if level == len(self._frontier):
            self._frontier.append(None)
        self._frontier[level] = h
        self._size += 1
        self.hash_store.leaf_count = self._size
        return leaf_hash

    def extend(self, leaves: Sequence[bytes]) -> None:
        for leaf in leaves:
            self.append(leaf)

    # --- roots / proofs ---------------------------------------------------

    def merkle_tree_hash(self, lo: int, hi: int) -> bytes:
        """MTH over leaves [lo, hi); O(log n) via stored subtree hashes."""
        if hi <= lo:
            return self.hasher.hash_empty()
        size = hi - lo
        if size == 1:
            return self.hash_store.read_leaf(lo)
        if lo % size == 0 and size & (size - 1) == 0:
            # complete aligned subtree — stored at append time
            level = size.bit_length() - 1
            try:
                return self.hash_store.read_node(level, lo)
            except KeyError:
                pass  # partially-built region; recurse
        k = _largest_power_of_two_smaller_than(size)
        return self.hasher.hash_children(
            self.merkle_tree_hash(lo, lo + k),
            self.merkle_tree_hash(lo + k, hi))

    def root_hash_at(self, tree_size: int) -> bytes:
        """Root as of historical size ``tree_size`` (<= current size)."""
        if tree_size > self._size:
            raise ValueError(f"size {tree_size} > {self._size}")
        if tree_size == 0:
            return self.hasher.hash_empty()
        return self.merkle_tree_hash(0, tree_size)

    def audit_path(self, index: int, tree_size: Optional[int] = None
                   ) -> List[bytes]:
        """RFC 6962 PATH(index, D[tree_size]), leaf-to-root order."""
        n = self._size if tree_size is None else tree_size
        if index >= n:
            raise ValueError(f"index {index} >= size {n}")

        def path(m: int, lo: int, hi: int) -> List[bytes]:
            if hi - lo <= 1:
                return []
            k = _largest_power_of_two_smaller_than(hi - lo)
            if m < lo + k:
                return path(m, lo, lo + k) + [self.merkle_tree_hash(lo + k, hi)]
            return path(m, lo + k, hi) + [self.merkle_tree_hash(lo, lo + k)]

        return path(index, 0, n)

    def consistency_proof(self, old_size: int, new_size: Optional[int] = None
                          ) -> List[bytes]:
        """RFC 6962 PROOF(old_size, D[new_size])."""
        n = self._size if new_size is None else new_size
        if old_size > n:
            raise ValueError(f"{old_size} > {n}")
        if old_size == 0 or old_size == n:
            return []

        def subproof(m: int, lo: int, hi: int, b: bool) -> List[bytes]:
            if m == hi - lo:
                # SUBPROOF(m, D[m], b): empty if D[0:m] is the known old
                # tree itself (b), else the one subtree hash — for ANY
                # width, not just leaves (RFC 6962 §2.1.2)
                return [] if b else [self.merkle_tree_hash(lo, hi)]
            k = _largest_power_of_two_smaller_than(hi - lo)
            if m <= k:
                return (subproof(m, lo, lo + k, b)
                        + [self.merkle_tree_hash(lo + k, hi)])
            return (subproof(m - k, lo + k, hi, False)
                    + [self.merkle_tree_hash(lo, lo + k)])

        return subproof(old_size, 0, n, True)

    # --- bulk/clone helpers (uncommitted-root computation) ----------------

    def frontier_snapshot(self) -> tuple:
        return (self._size, tuple(self._frontier))

    def root_with_extra_leaves(self, extra_leaf_data: Sequence[bytes]) -> bytes:
        """Root hash if ``extra_leaf_data`` were appended — WITHOUT mutating
        the tree or the hash store. O(k log n). This is how the uncommitted
        txn root for a speculatively-applied 3PC batch is computed."""
        frontier: List[Optional[bytes]] = list(self._frontier)
        size = self._size
        for data in extra_leaf_data:
            h = self.hasher.hash_leaf(data)
            level = 0
            while level < len(frontier) and frontier[level] is not None:
                h = self.hasher.hash_children(frontier[level], h)
                frontier[level] = None
                level += 1
            if level == len(frontier):
                frontier.append(None)
            frontier[level] = h
            size += 1
        if size == 0:
            return self.hasher.hash_empty()
        root: Optional[bytes] = None
        for h in frontier:  # little-endian: combine towards the top
            if h is None:
                continue
            root = h if root is None else self.hasher.hash_children(h, root)
        return root  # type: ignore[return-value]
