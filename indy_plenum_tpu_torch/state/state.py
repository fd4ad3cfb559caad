"""Key/value state interface with committed/uncommitted heads and proofs.

Reference: state/state.py (`State`) + state/pruning_state.py
(`PruningState`, an Ethereum-style Merkle Patricia Trie).

DESIGN DEPARTURE (TPU-first): the concrete implementation here is a
**binary sparse Merkle tree** (:mod:`sparse_merkle_state`), not an MPT.
Same capabilities — authenticated key/value store, committed vs
uncommitted heads, revert, externally-verifiable proofs — but with a
fixed 256-level structure whose proof verification is a fixed-depth hash
fold, i.e. exactly the shape the batched device kernel
(:func:`indy_plenum_tpu_torch.tpu.sha256.sha256_fixed`) wants: no variable-arity
nodes, no RLP, no data-dependent control flow.

Copy of ``indy_plenum_tpu/state/state.py``,
with its imports bound to the port.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Optional


class State(ABC):
    @abstractmethod
    def set(self, key: bytes, value: bytes) -> None:
        """Update the uncommitted head."""

    @abstractmethod
    def get(self, key: bytes, is_committed: bool = False) -> Optional[bytes]:
        ...

    @abstractmethod
    def remove(self, key: bytes) -> None:
        ...

    @abstractmethod
    def commit(self, root_hash: Optional[bytes] = None) -> None:
        """Promote the uncommitted head (or an explicit historical root)."""

    @abstractmethod
    def revert_to_head(self) -> None:
        """Discard uncommitted changes (back to the committed head)."""

    @property
    @abstractmethod
    def head_hash(self) -> bytes:
        """Uncommitted root."""

    @property
    @abstractmethod
    def committed_head_hash(self) -> bytes:
        ...

    @abstractmethod
    def generate_state_proof(self, key: bytes, root: Optional[bytes] = None,
                             serialize: bool = True):
        ...
