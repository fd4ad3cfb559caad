"""Admission control: bounded auth queues with a deterministic shed law.

PBFT/RBFT evaluations (Castro & Liskov, OSDI 1999; Aublin et al., ICDCS
2013) run their pools at and beyond saturation — which only means
anything if overload has a defined behaviour. An unbounded auth queue
under open-loop load grows without limit: latency explodes, memory
grows, and the pool's *goodput* collapses behind a wall of doomed
requests. :class:`AdmissionController` bounds the queue and makes the
overflow decision a deterministic function of the arrival sequence and a
seed, so a seeded saturation run replays to the byte-identical shed set
(checkable like ``ordered_hash``):

- **fairness cap**: a client with ``per_client_cap`` requests already
  queued is shed outright — one hot client must not starve the
  population (plenum throttles per-client ingress the same way);
  anonymous submissions (``client_id=None``) carry no identity to cap
  and are outside it — the bounded queue still limits them;
- **drop-newest**: when the queue is full, only the newest arrivals
  compete; queued work is never abandoned after the pool has invested
  in it;
- **seeded tiebreak**: arrivals of the same virtual-clock instant
  compete by a seeded content rank (sha256 over seed|digest), so the
  shed set does not depend on host-side submission interleaving within
  one instant.

Shed accounting is deliberately deferred to :meth:`drain` (the dispatch
tick): the hot ``offer`` path appends to a pending list, and the drain
records the tick's sheds under the DEDICATED ``ingress.shed`` metric and
``req.shed`` trace events — shed load never pollutes the ``AUTH_BATCH_*``
hot-path stats (they measure work the device actually verified).

:class:`BackpressureSignal` is the per-tick digest the dispatch governor
consumes: pre-drain queue depth vs capacity, sheds since the last tick,
and whether any node is leeching (catching up). See
:meth:`~indy_plenum_tpu_torch.tpu.governor.DispatchGovernor.feed_backpressure`.

Copy of ``indy_plenum_tpu/ingress/admission.py``, with its imports bound to
the port.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple


@dataclass(frozen=True)
class BackpressureSignal:
    """One tick's ingress pressure, fed to the dispatch governor.

    ``queue_depth`` is the PRE-drain depth (what accumulated over the
    tick interval), ``shed_delta`` the sheds since the previous tick,
    ``leeching`` whether any pool node is catching up (not
    participating), ``retry_pressure`` how many closed-loop retries are
    outstanding on the virtual timer (ingress/retry.py) — load the pool
    ALREADY owes itself, which must hold the governor's narrow even
    while the queue momentarily looks calm. A zero signal
    (0, 0, 0, False, 0) is the explicit no-pressure statement — the
    governor's law is bit-identical to the occupancy-only law
    under it.
    """

    queue_depth: int = 0
    capacity: int = 0
    shed_delta: int = 0
    leeching: bool = False
    retry_pressure: int = 0

    @property
    def queue_frac(self) -> float:
        # capacity == 0 is the ingress-off (or synthetic-signal) case:
        # no queue to fill means no fractional pressure, never a
        # ZeroDivisionError
        return self.queue_depth / self.capacity if self.capacity else 0.0


class AdmissionController:
    """Bounded ingress queue with the deterministic shed policy above.

    ``clock`` is injected (the pool's virtual clock) so same-instant
    cohorts — and therefore the tiebreak — are a protocol-time notion,
    never a wall-clock one. Payloads only need a ``digest`` attribute
    (:class:`~indy_plenum_tpu_torch.common.request.Request` has one).
    """

    def __init__(self, capacity: int, per_client_cap: int = 0,
                 seed: int = 0,
                 clock: Optional[Callable[[], float]] = None):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive: {capacity}")
        self.capacity = int(capacity)
        self.per_client_cap = int(per_client_cap)
        self.seed = int(seed)
        self._clock = clock if clock is not None else (lambda: 0.0)
        # (ts, rank, client_id, req) — appended in arrival order; the
        # tail cohort (same ts) is the only eviction domain
        self._queue: List[Tuple[float, int, Optional[str], Any]] = []
        self._per_client: Dict[Optional[str], int] = {}
        # sheds since the last drain: (req, client_id, reason); recorded
        # by drain — the client id rides along so the closed-loop retry
        # driver can re-offer under the SAME identity (a retry that
        # dodged the fairness cap by dropping its client would be cap
        # evasion)
        self._shed_pending: List[Tuple[Any, Optional[str], str]] = []
        self.offered_total = 0
        self.admitted_total = 0
        self.shed_total = 0
        self.peak_depth = 0
        self.shed_digests: List[str] = []  # the run's shed fingerprint

    # ------------------------------------------------------------------

    def _rank(self, digest: str) -> int:
        """Seeded content rank: HIGHER ranks shed first within a cohort."""
        h = hashlib.sha256(
            b"%d|%s" % (self.seed, digest.encode())).digest()
        return int.from_bytes(h[:8], "big")

    @property
    def depth(self) -> int:
        return len(self._queue)

    def sized_resources(self, prefix: str = "admission."):
        """Resource-ledger registration (observability.telemetry). The
        queue and same-tick shed cohort are the controller's bounded
        stores; ``shed_digests`` is a by-design run-long fingerprint
        spine (like ``ordered_digests``) and stays off the ledger."""
        from ..observability.telemetry import SizedResource

        return (
            SizedResource(prefix + "queue", lambda: len(self._queue),
                          bound=self.capacity or None, entry_bytes=512),
            SizedResource(prefix + "shed_pending",
                          lambda: len(self._shed_pending),
                          bound=None, entry_bytes=512),
            SizedResource(prefix + "per_client",
                          lambda: len(self._per_client),
                          bound=None, entry_bytes=64),
        )


    def shed_hash(self) -> str:
        """sha256 over the SORTED shed digests — THE shed-set
        fingerprint. Canonical set hash: the shed SET is independent of
        same-instant submission interleaving, so the fingerprint must be
        too (seeded runs reproduce it byte-for-byte)."""
        return hashlib.sha256(
            "|".join(sorted(self.shed_digests)).encode()).hexdigest()

    # ------------------------------------------------------------------

    def _shed(self, req: Any, client_id: Optional[str],
              reason: str) -> None:
        self.shed_total += 1
        self.shed_digests.append(req.digest)
        self._shed_pending.append((req, client_id, reason))

    def offer(self, req: Any, client_id: Optional[str] = None) -> bool:
        """Admit ``req`` into the bounded queue or shed it. Returns
        whether the request is queued NOW (a later same-instant arrival
        with a lower seeded rank may still evict it — its shed then
        surfaces through :meth:`drain`)."""
        self.offered_total += 1
        now = self._clock()
        cap = self.per_client_cap
        if (cap > 0 and client_id is not None
                and self._per_client.get(client_id, 0) >= cap):
            self._shed(req, client_id, "client_cap")
            return False
        if len(self._queue) < self.capacity:
            self._queue.append((now, self._rank(req.digest), client_id,
                                req))
            self._per_client[client_id] = \
                self._per_client.get(client_id, 0) + 1
            if len(self._queue) > self.peak_depth:
                self.peak_depth = len(self._queue)
            return True
        # full: drop-newest — only the tail cohort (same instant as the
        # newcomer) competes, by seeded rank
        rank = self._rank(req.digest)
        worst_i, worst_rank = -1, rank
        for i in range(len(self._queue) - 1, -1, -1):
            ts, r, _cid, _req = self._queue[i]
            if ts != now:
                break
            if r > worst_rank:
                worst_i, worst_rank = i, r
        if worst_i < 0:
            self._shed(req, client_id, "queue_full")
            return False
        _ts, _r, ev_cid, ev_req = self._queue.pop(worst_i)
        self._per_client[ev_cid] = self._per_client.get(ev_cid, 1) - 1
        self._shed(ev_req, ev_cid, "queue_full")
        self._queue.append((now, rank, client_id, req))
        self._per_client[client_id] = \
            self._per_client.get(client_id, 0) + 1
        return True

    def drain(self) -> Tuple[List[Any],
                             List[Tuple[Any, Optional[str], str]]]:
        """The tick's handoff: (admitted batch in arrival order, sheds
        since the last drain as (req, client_id, reason)). Callers
        record the sheds under ``req.shed`` / ``ingress.shed`` — never
        ``AUTH_BATCH_*`` — and hand them to the retry driver when the
        closed loop is armed."""
        batch = [req for (_ts, _r, _cid, req) in self._queue]
        self._queue.clear()
        self._per_client.clear()
        self.admitted_total += len(batch)
        shed, self._shed_pending = self._shed_pending, []
        return batch, shed

    def counters(self) -> Dict[str, int]:
        return {
            "offered": self.offered_total,
            "admitted": self.admitted_total,
            "shed": self.shed_total,
            "depth": self.depth,
            "peak_depth": self.peak_depth,
            "capacity": self.capacity,
        }
