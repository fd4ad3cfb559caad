"""Deterministic retry/timeout/backoff law for leecher requests.

The chaos plane's catchup scenarios need recovery that neither stalls on
a silent seeder nor diverges between replays of the same seed: every
re-request decision here is a pure function of (seed, slice key, attempt
number), so a seeded simulation run reproduces the identical retry
schedule bit-for-bit, and a budget of ``max_retries`` turns "re-ask
forever" into a fail-closed round (the leecher's
``CatchupFailedRetryBackoff`` path then owns when to try again).

Delay for attempt ``k`` (1-based, the wait AFTER the k-th send):

    base * mult^(k-1), capped at ``max_delay``, then stretched by a
    seeded jitter in [0, jitter_frac] of itself — sha256(seed|key|k)
    drives the stretch, so concurrent slices (and concurrent leechers
    with different seeds) desynchronize instead of thundering together.

Copy of ``indy_plenum_tpu/server/catchup/retry.py``.
"""
from __future__ import annotations

import hashlib


class RetryLaw:
    """Seeded, deterministic per-key exponential backoff with a budget."""

    def __init__(self, base: float, mult: float = 1.5,
                 max_delay: float = 60.0, jitter_frac: float = 0.25,
                 seed: int = 0, max_retries: int = 10):
        if base <= 0:
            raise ValueError("base delay must be positive")
        self.base = base
        self.mult = max(mult, 1.0)
        self.max_delay = max(max_delay, base)
        self.jitter_frac = max(jitter_frac, 0.0)
        self.seed = seed
        self.max_retries = max_retries

    @classmethod
    def from_config(cls, config) -> "RetryLaw":
        # CatchupRequestTimeout 0 = inherit the pre-retry-law knob, so
        # existing configs keep their observed re-request cadence
        base = config.CatchupRequestTimeout \
            or config.CatchupTransactionsTimeout
        return cls(base=base,
                   mult=config.CatchupRetryBackoffMult,
                   max_delay=config.CatchupRetryBackoffMax,
                   jitter_frac=config.CatchupRetryJitterFrac,
                   seed=config.CatchupRetryJitterSeed,
                   max_retries=config.CatchupMaxRetries)

    def _jitter_unit(self, key, attempt: int) -> float:
        """[0, 1) drawn from sha256(seed|key|attempt) — no shared RNG
        state, so delays are replayable per key regardless of the order
        slices hit their deadlines."""
        h = hashlib.sha256(
            f"{self.seed}|{key}|{attempt}".encode()).digest()
        return int.from_bytes(h[:8], "big") / float(1 << 64)

    def delay(self, key, attempt: int) -> float:
        """Seconds to wait after the ``attempt``-th (1-based) send of
        ``key`` before re-asking someone else."""
        attempt = max(attempt, 1)
        raw = min(self.base * (self.mult ** (attempt - 1)), self.max_delay)
        return raw * (1.0 + self.jitter_frac
                      * self._jitter_unit(key, attempt))

    def exhausted(self, attempt: int) -> bool:
        """True once ``attempt`` sends have gone unanswered and the
        budget says stop re-asking (fail the round closed instead)."""
        return attempt > self.max_retries
