"""Million-client ingress plane: open-loop workload, admission, reads.

Four cooperating parts:

- :mod:`.workload` — a seeded open-loop client population (Zipf-skewed
  arrival rates and hot-key targets) scheduling arrivals on the pool's
  virtual clock, so every run is replay-identical;
- :mod:`.admission` — bounded auth queues with a deterministic shed
  policy (drop-newest, seeded tiebreak, per-client fairness caps) and
  the :class:`~indy_plenum_tpu_torch.ingress.admission.BackpressureSignal`
  that closes the loop into the dispatch governor;
- :mod:`.retry` — the CLIENTS' side of overload: seeded-backoff
  closed-loop retries of shed/NACKed requests with the ``retry_hash``
  fingerprint;
- :mod:`.read_service` — GET-style state reads answered from a ledger's
  Merkle tree with the device audit-proof kernel, zero 3PC involvement.

Copy of ``indy_plenum_tpu/ingress/__init__.py``, with its imports bound to
the port.
"""
from .admission import AdmissionController, BackpressureSignal
from .read_service import (
    LedgerBacking,
    ProofRead,
    ReadService,
    StaticCorpusBacking,
)
from .retry import RetryDriver, RetryPolicy
from .workload import WorkloadGenerator, WorkloadProfile, WorkloadSpec

__all__ = [
    "AdmissionController",
    "BackpressureSignal",
    "LedgerBacking",
    "ProofRead",
    "ReadService",
    "RetryDriver",
    "RetryPolicy",
    "StaticCorpusBacking",
    "WorkloadGenerator",
    "WorkloadProfile",
    "WorkloadSpec",
]
