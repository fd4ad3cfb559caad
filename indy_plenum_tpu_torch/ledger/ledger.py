"""Append-only transaction ledger with committed/uncommitted staging.

Reference: ledger/ledger.py (`Ledger`): seqNo-addressed txn log (1-based),
compact Merkle tree for roots/proofs, and a two-phase append — speculative
``append_txns`` during 3PC dynamic validation, then ``commit_txns`` when the
batch orders or ``discard_txns`` on revert (view change). The committed and
uncommitted root hashes are both observable; PRE-PREPARE carries the
uncommitted root every replica must reproduce.

Copy of ``indy_plenum_tpu/ledger/ledger.py``,
with its imports bound to the port.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple

from ..common.serializers.serialization import (
    ledger_txn_serializer,
)
from ..common.txn_util import append_txn_metadata, get_seq_no
from ..storage.kv_store import KeyValueStorage, KeyValueStorageInMemory
from .compact_merkle_tree import CompactMerkleTree


class Ledger:
    def __init__(self,
                 tree: Optional[CompactMerkleTree] = None,
                 txn_store: Optional[KeyValueStorage] = None,
                 serializer=ledger_txn_serializer):
        # NOT `tree or ...`: an empty CompactMerkleTree is falsy (__len__)
        self.tree = tree if tree is not None else CompactMerkleTree()
        self.txn_store = txn_store if txn_store is not None \
            else KeyValueStorageInMemory()
        self.serializer = serializer
        self._uncommitted: List[Dict[str, Any]] = []
        self.seq_no = self.tree.tree_size  # committed height (1-based last)

    # --- committed accessors ---------------------------------------------

    @property
    def size(self) -> int:
        return self.seq_no

    @property
    def root_hash(self) -> bytes:
        return self.tree.root_hash

    @property
    def uncommitted_size(self) -> int:
        return self.seq_no + len(self._uncommitted)

    @property
    def uncommitted_root_hash(self) -> bytes:
        return self.tree.root_with_extra_leaves(
            [self.serializer.dumps(t) for t in self._uncommitted])

    @property
    def uncommitted_txns(self) -> List[Dict[str, Any]]:
        return list(self._uncommitted)

    @staticmethod
    def _key(seq_no: int) -> bytes:
        return seq_no.to_bytes(8, "big")

    def get_by_seq_no(self, seq_no: int) -> Dict[str, Any]:
        if not 1 <= seq_no <= self.seq_no:
            raise KeyError(seq_no)
        return self.serializer.loads(self.txn_store.get(self._key(seq_no)))

    def get_serialized(self, seq_no: int) -> bytes:
        """Committed txn's STORED bytes — the exact leaf the Merkle tree
        hashed (audit proofs are over these, not a re-serialization)."""
        if not 1 <= seq_no <= self.seq_no:
            raise KeyError(seq_no)
        return self.txn_store.get(self._key(seq_no))

    def get_by_seq_no_uncommitted(self, seq_no: int) -> Dict[str, Any]:
        if seq_no <= self.seq_no:
            return self.get_by_seq_no(seq_no)
        idx = seq_no - self.seq_no - 1
        if idx >= len(self._uncommitted):
            raise KeyError(seq_no)
        return self._uncommitted[idx]

    def get_all_txn(self, frm: int = 1, to: Optional[int] = None):
        to = self.seq_no if to is None else min(to, self.seq_no)
        for seq in range(max(1, frm), to + 1):
            yield seq, self.get_by_seq_no(seq)

    # --- two-phase append -------------------------------------------------

    def append_txns(self, txns: Iterable[Dict[str, Any]]
                    ) -> Tuple[int, int, List[Dict[str, Any]]]:
        """Stage txns (uncommitted); assigns provisional seqNos; returns
        (start_seq_no, end_seq_no, txns)."""
        txns = list(txns)
        start = self.uncommitted_size + 1
        for i, txn in enumerate(txns):
            append_txn_metadata(txn, seq_no=start + i)
        self._uncommitted.extend(txns)
        return start, self.uncommitted_size, txns

    def commit_txns(self, count: int) -> Tuple[Tuple[int, int],
                                               List[Dict[str, Any]]]:
        """Move the first ``count`` staged txns into the committed log."""
        if count > len(self._uncommitted):
            raise ValueError(
                f"commit {count} > staged {len(self._uncommitted)}")
        committed = self._uncommitted[:count]
        self._uncommitted = self._uncommitted[count:]
        start = self.seq_no + 1
        batch = []
        for txn in committed:
            self.seq_no += 1
            data = self.serializer.dumps(txn)
            batch.append((self._key(self.seq_no), data))
            self.tree.append(data)
        self.txn_store.do_batch(batch)
        return (start, self.seq_no), committed

    def discard_txns(self, count: int) -> None:
        """Drop the LAST ``count`` staged txns (revert on view change)."""
        if count > len(self._uncommitted):
            raise ValueError(
                f"discard {count} > staged {len(self._uncommitted)}")
        if count:
            self._uncommitted = self._uncommitted[:-count]

    def add(self, txn: Dict[str, Any]) -> Dict[str, Any]:
        """Directly append a committed txn (catchup path: already ordered)."""
        assert not self._uncommitted, "add() while 3PC txns are staged"
        if get_seq_no(txn) is None:
            append_txn_metadata(txn, seq_no=self.seq_no + 1)
        data = self.serializer.dumps(txn)
        self.seq_no += 1
        self.txn_store.put(self._key(self.seq_no), data)
        self.tree.append(data)
        return txn

    def recover_tree(self) -> int:
        """Rebuild the Merkle tree from the committed txn log when the
        hash store is missing or behind it (crash recovery: the ledger
        LOG is the truth — a lost/stale hash store must never strand a
        node with an inconsistent root). Returns the number of leaves
        replayed."""
        log_size = self.txn_store.size
        if self.tree.tree_size > log_size:
            # tree AHEAD of the log (crash between the tree persist and
            # the log append): the LOG is still the truth — a root
            # committing to a leaf the log doesn't contain would poison
            # every proof served. Rebuild the tree from scratch — hash
            # store FIRST (CompactMerkleTree.reset leaves persistence to
            # the caller): a surviving leaf_count key would reload the
            # stale oversized tree on every restart, and orphaned
            # leaf/node entries would linger in durable storage.
            if self.tree.hash_store is not None:
                self.tree.hash_store.reset()
            self.tree.reset()
        behind = log_size - self.tree.tree_size
        if behind <= 0:
            self.seq_no = self.tree.tree_size
            return 0
        for seq in range(self.tree.tree_size + 1, log_size + 1):
            self.tree.append(self.txn_store.get(self._key(seq)))
        self.seq_no = self.tree.tree_size
        return behind

    def reset_to(self, size: int) -> None:
        """Truncate the committed log to ``size`` txns (diverged-node
        resync: everything past — or, for ``size=0``, the whole log — is
        re-fetched through catchup). The compact tree has no un-append, so
        the frontier is rebuilt by replaying the surviving txns; stored
        txns past ``size`` are deleted."""
        assert not self._uncommitted, "reset_to() while 3PC txns are staged"
        if size >= self.seq_no:
            return
        keep = [self.get_by_seq_no(s) for s in range(1, size + 1)]
        # descending: append-only stores (ChunkedFileStore) only support
        # tail removal, and KV stores don't care about the order
        for s in range(self.seq_no, size, -1):
            self.txn_store.remove(self._key(s))
        if self.tree.hash_store is not None:
            self.tree.hash_store.reset()
        self.tree.reset()
        self.seq_no = 0
        for txn in keep:
            self.seq_no += 1
            self.tree.append(self.serializer.dumps(txn))

    # --- proofs (serving catchup / state proofs) -------------------------

    def audit_path(self, seq_no: int, tree_size: Optional[int] = None):
        return self.tree.audit_path(seq_no - 1, tree_size)

    def consistency_proof(self, old_size: int,
                          new_size: Optional[int] = None):
        return self.tree.consistency_proof(old_size, new_size)

    def root_hash_at(self, tree_size: int) -> bytes:
        return self.tree.root_hash_at(tree_size)
