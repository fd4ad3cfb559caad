"""Closed-loop client retry: shed/NACKed requests come BACK.

The ingress plane's shed law (admission.py) models the pool's side of
overload; this module models the CLIENTS' side — the part that makes
real overload compound. An open-loop generator walks away from a shed
request; a real wallet retries it, which re-offers exactly when the pool
is weakest (RBFT's robustness claim is about sustained misbehaviour, and
a retry storm is sustained load the pool itself manufactured). The
admission plane alone is open-loop; :class:`RetryPolicy` +
:class:`RetryDriver` close the loop.

:class:`RetryPolicy` mirrors the catchup plane's
:class:`~indy_plenum_tpu_torch.server.catchup.retry.RetryLaw` shape — seeded
exponential backoff with per-key sha256 jitter and a max-attempts budget
— so both retry laws in the system read the same way and replay the same
way: every delay is a pure function of (seed, digest, attempt), no
shared RNG state, and exhaustion fails CLOSED (the request is abandoned
and counted, never re-asked forever).

:class:`RetryDriver` runs the loop on the pool's virtual timer: the
admission drain hands it each tick's sheds, it schedules seeded-backoff
re-offers, and every re-offer re-enters admission like any arrival —
counting against the per-client fairness cap (no retry-based cap
evasion) and competing in the same-instant shed cohort. Observability
mirrors the shed law's: ``req.retry`` trace marks (the ``retry`` hop in
causal journeys), ``ingress.retries`` / ``ingress.retry_exhausted``
metrics, and :meth:`RetryDriver.retry_hash` — a canonical fingerprint
over the (digest, attempt) retry set, byte-identical per seed exactly
like ``shed_hash``.

Copy of ``indy_plenum_tpu/ingress/retry.py``, with its imports bound to
the port; its law is the port's ``server/catchup/retry.RetryLaw``.
"""
from __future__ import annotations

import hashlib
from typing import Any, Callable, Dict, List, Optional

from ..server.catchup.retry import RetryLaw


class RetryPolicy(RetryLaw):
    """Seeded, deterministic per-request exponential backoff + budget —
    the catchup :class:`RetryLaw` itself (delay / jitter / exhaustion
    are INHERITED, so the two laws can never silently diverge), with
    the ingress knob surface and a client-flavoured budget name:
    ``max_attempts`` sheds and the client gives up (fail closed).

    Delay after the ``attempt``-th shed (1-based):

        base * mult^(attempt-1), capped at ``max_delay``, stretched by a
        seeded jitter in [0, jitter_frac] of itself — sha256 over
        ``seed|digest|attempt`` drives the stretch, so a shed cohort's
        retries desynchronize instead of re-thundering as one wave.
    """

    def __init__(self, base: float, mult: float = 2.0,
                 max_delay: float = 30.0, jitter_frac: float = 0.5,
                 seed: int = 0, max_attempts: int = 3):
        if max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1: {max_attempts}")
        super().__init__(base=base, mult=mult, max_delay=max_delay,
                         jitter_frac=jitter_frac, seed=seed,
                         max_retries=max_attempts)

    @property
    def max_attempts(self) -> int:
        return self.max_retries

    @classmethod
    def from_config(cls, config, seed: int = 0) -> "RetryPolicy":
        """The ``IngressRetry*`` knob surface; ``seed`` defaults to the
        pool seed (simulation) so the retry schedule replays with the
        run, mirroring the admission tiebreak's seeding."""
        return cls(base=config.IngressRetryBase,
                   mult=config.IngressRetryBackoffMult,
                   max_delay=config.IngressRetryBackoffMax,
                   jitter_frac=config.IngressRetryJitterFrac,
                   seed=seed,
                   max_attempts=config.IngressRetryMax)


class RetryDriver:
    """The closed loop: sheds in, seeded-backoff re-offers out.

    ``resubmit(req, client_id)`` is the injected re-offer path (the
    pool's admission offer — a re-offered request is an arrival like any
    other). All scheduling rides the injected virtual ``timer``, so the
    storm replays byte-for-byte per seed.
    """

    def __init__(self, policy: RetryPolicy, timer,
                 resubmit: Callable[[Any, Optional[str]], None],
                 metrics=None, trace=None):
        from ..common.metrics_collector import NullMetricsCollector
        from ..observability.trace import NULL_TRACE

        self.policy = policy
        self._timer = timer
        self._resubmit = resubmit
        self.metrics = metrics if metrics is not None \
            else NullMetricsCollector()
        self.trace = trace if trace is not None else NULL_TRACE
        self._attempts: Dict[str, int] = {}  # digest -> sheds seen
        self.outstanding = 0  # scheduled re-offers not yet fired
        self.reoffers_total = 0
        self.exhausted_total = 0
        self.retried_digests: set = set()
        # the run's retry fingerprint entries: "digest|attempt" per
        # re-offer actually scheduled
        self._records: List[str] = []

    def sized_resources(self, prefix: str = "retry."):
        """Resource-ledger registration (observability.telemetry): the
        live cohort (attempt counters + scheduled re-offers). The
        ``_records``/``retried_digests`` fingerprint spines are run-long
        by design and stay off the ledger."""
        from ..observability.telemetry import SizedResource

        return (
            SizedResource(prefix + "attempts",
                          lambda: len(self._attempts),
                          bound=None, entry_bytes=96),
            SizedResource(prefix + "outstanding",
                          lambda: self.outstanding,
                          bound=None, entry_bytes=512),
        )

    # ------------------------------------------------------------------

    def on_shed(self, req: Any, client_id: Optional[str],
                reason: str) -> None:
        """One shed (or NACK) from the drain: schedule the seeded
        re-offer, or give up once the budget is spent."""
        from ..common.metrics_collector import MetricsName

        digest = req.digest
        attempt = self._attempts.get(digest, 0) + 1
        self._attempts[digest] = attempt
        if self.policy.exhausted(attempt):
            self.exhausted_total += 1
            self.metrics.add_event(MetricsName.INGRESS_RETRY_EXHAUSTED)
            if self.trace.enabled:
                self.trace.record("req.retry_exhausted", cat="req",
                                  key=(digest,),
                                  args={"attempts": attempt - 1,
                                        "reason": reason})
            return
        delay = self.policy.delay(digest, attempt)
        self.outstanding += 1
        self._records.append("%s|%d" % (digest, attempt))
        self._timer.schedule(
            delay, lambda: self._fire(req, client_id, attempt))

    def _fire(self, req: Any, client_id: Optional[str],
              attempt: int) -> None:
        from ..common.metrics_collector import MetricsName

        self.outstanding -= 1
        self.reoffers_total += 1
        self.retried_digests.add(req.digest)
        self.metrics.add_event(MetricsName.INGRESS_RETRIES)
        if self.trace.enabled:
            # the journey's ``retry`` hop closes at the LAST of these
            # marks: first shed -> final re-offer is the client's whole
            # backoff wait
            self.trace.record("req.retry", cat="req", key=(req.digest,),
                              args={"attempt": attempt})
        self._resubmit(req, client_id)

    # ------------------------------------------------------------------

    def retry_hash(self) -> str:
        """sha256 over the SORTED ``digest|attempt`` re-offer records —
        THE retry-storm fingerprint (canonical set hash like
        ``shed_hash``: independent of the timer-heap pop order within an
        instant, byte-identical per seed)."""
        return hashlib.sha256(
            "|".join(sorted(self._records)).encode()).hexdigest()

    def counters(self) -> Dict[str, int]:
        return {
            "reoffers": self.reoffers_total,
            "exhausted": self.exhausted_total,
            "outstanding": self.outstanding,
            "requests_retried": len(self.retried_digests),
        }
