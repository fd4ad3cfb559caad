"""Catchup: trustless ledger synchronization for lagging/diverged nodes.

Reference: plenum/server/catchup/ (node_leecher_service.py,
ledger_leecher_service.py, cons_proof_service.py, catchup_rep_service.py,
seeder_service.py). The per-ledger LedgerLeecher layer is folded into
NodeLeecherService here; verification of fetched txns is the batched
device audit-path kernel (tpu/sha256.py).

Copy of ``indy_plenum_tpu/server/catchup/__init__.py``: the same exports,
from the port's modules.
"""
from .catchup_rep_service import CatchupRepService, verify_audit_paths_batch
from .cons_proof_service import ConsProofService
from .node_leecher_service import NodeLeecherService
from .retry import RetryLaw
from .seeder_service import SeederService

__all__ = [
    "CatchupRepService",
    "ConsProofService",
    "NodeLeecherService",
    "RetryLaw",
    "SeederService",
    "verify_audit_paths_batch",
]
