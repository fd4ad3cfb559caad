"""Pool manager: committed NODE txns become live membership.

Reference: plenum/server/pool_manager.py (`TxnPoolManager`). The pool
ledger IS the membership authority: every committed NODE txn (added,
edited, promoted, demoted via the services field) updates the validator
registry, and from it the consensus quorums (ConsensusSharedData), the
BLS key register (PoP-checked), and — through the composition callback —
transport connections and the device vote plane's validator axis.

Validator ORDER is the pool-ledger first-seen order (round-robin primary
selection must be identical on every node); demotion removes a name from
the active set but keeps its slot in the ordering history.

The registry keys validators by ALIAS (protocol names); the NODE txn's
dest nym identifies the node's signing identity.

Copy of ``indy_plenum_tpu/server/pool_manager.py``, with its imports bound to
the port.
"""
from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional

from ..common.constants import (
    ALIAS,
    BLS_KEY,
    BLS_KEY_PROOF,
    NODE,
    SERVICES,
    TARGET_NYM,
    VALIDATOR,
)
from ..common.txn_util import get_payload_data, get_type
from .consensus.consensus_shared_data import ConsensusSharedData

logger = logging.getLogger(__name__)


class PoolManager:
    def __init__(self,
                 node_name: str,
                 data: ConsensusSharedData,
                 bls_key_register=None,
                 on_membership_changed: Optional[
                     Callable[[List[str], Dict[str, dict]], None]] = None):
        self._node_name = node_name
        self._data = data
        self._bls_register = bls_key_register
        self._on_changed = on_membership_changed
        # alias -> merged record, insertion-ordered (= pool ledger order)
        self.registry: Dict[str, dict] = {}

    # ------------------------------------------------------------------

    @staticmethod
    def _is_active(record: dict) -> bool:
        services = record.get(SERVICES)
        if services is None:
            return True  # never demoted
        return VALIDATOR in services

    @property
    def validators(self) -> List[str]:
        return [alias for alias, rec in self.registry.items()
                if self._is_active(rec)]

    def node_record(self, alias: str) -> Optional[dict]:
        return self.registry.get(alias)

    # ------------------------------------------------------------------

    def init_from_ledger(self, pool_ledger) -> None:
        """Replay the committed pool ledger into the registry (node boot /
        restart). An empty pool ledger leaves static membership in place."""
        for _, txn in pool_ledger.get_all_txn():
            self._absorb(txn)
        if self.registry:
            self._reconfigure(notify=False)

    def refresh_from_ledger(self, pool_ledger) -> None:
        """Re-absorb the whole committed pool ledger (post-catchup: txns
        fetched by the leecher bypass the execution hook)."""
        before = self._snapshot()
        for _, txn in pool_ledger.get_all_txn():
            self._absorb(txn)
        if self.registry:
            self._reconfigure(notify=True,
                              records_changed=self._snapshot() != before)

    def process_committed_txn(self, txn: Dict[str, Any]) -> None:
        """Feed from execution: a NODE txn just committed on this node."""
        if get_type(txn) != NODE:
            return
        before = self._snapshot()
        self._absorb(txn)
        self._reconfigure(notify=True,
                          records_changed=self._snapshot() != before)

    def _snapshot(self) -> Dict[str, dict]:
        return {alias: dict(rec) for alias, rec in self.registry.items()}

    def _absorb(self, txn: Dict[str, Any]) -> None:
        if get_type(txn) != NODE:
            return
        payload = get_payload_data(txn)
        node_data = dict(payload.get("data") or {})
        alias = node_data.get(ALIAS)
        if not alias:
            return
        record = {**self.registry.get(alias, {}), **node_data,
                  "nym": payload.get(TARGET_NYM)}
        self.registry[alias] = record

    def _reconfigure(self, notify: bool,
                     records_changed: bool = False) -> None:
        """``records_changed``: a NODE txn altered a record WITHOUT
        changing the active set — key/address rotation. The composition
        hook must still fire (peers restart that connection with the new
        key), even though quorums are untouched."""
        new_validators = self.validators
        if not new_validators:
            logger.warning("%s: pool ledger yields an EMPTY validator set; "
                           "keeping current membership", self._node_name)
            return
        changed = new_validators != self._data.validators
        if changed:
            logger.info("%s: pool membership -> %s (n=%d, f=%d)",
                        self._node_name, new_validators,
                        len(new_validators),
                        (len(new_validators) - 1) // 3)
            self._data.set_validators(new_validators)
        self._sync_bls_keys()
        if (changed or records_changed) and notify \
                and self._on_changed is not None:
            self._on_changed(new_validators, dict(self.registry),
                             set_changed=changed)

    def _sync_bls_keys(self) -> None:
        if self._bls_register is None:
            return
        for alias, rec in self.registry.items():
            pk = rec.get(BLS_KEY)
            if not self._is_active(rec):
                self._bls_register.remove_key(alias)
            elif pk and self._bls_register.get_key(alias) != pk:
                # PoP required: a rogue-key aggregation needs possession
                self._bls_register.add_key(
                    alias, pk, rec.get(BLS_KEY_PROOF), require_pop=True)
