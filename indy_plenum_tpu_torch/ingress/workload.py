"""Open-loop workload generator: a seeded virtual client population.

RBFT and PBFT both evaluate under sustained client load; plenum's pools
face the open-loop version — millions of independent wallets whose
arrival rate does not slow down because the pool is busy. This module
models that population WITHOUT instantiating it: clients exist as a
Zipf-skewed index space (client ``0`` is the hottest wallet) and keys as
a second Zipf space (hot NYM/attrib targets), both sampled per arrival
from one seeded RNG. Arrival times are a seeded Poisson process.

:class:`WorkloadProfile` modulates that process: real load is not flat —
wallets follow the sun (diurnal curves) and pile onto events (flash
crowds). The profile is a pure piecewise function of VIRTUAL time since
the window opened (no wall clock, no extra RNG draws), scaling the
instantaneous Poisson rate, so a profiled run replays byte-identically
exactly like a steady one.

Everything rides the pool's virtual clock: the generator schedules ONE
timer event at a time (each arrival schedules its successor), so the
timer heap stays O(1) no matter how many arrivals the run produces, and
a seeded run is replay-identical — same arrival instants, same clients,
same keys, same read/write choices. That determinism is what lets the
admission plane's shed set and the pool's ``ordered_hash``/``trace_hash``
be compared byte-for-byte across runs (tests/test_ingress.py).

Copy of ``indy_plenum_tpu/ingress/workload.py``, with its imports bound to
the port. It is host code: numpy draws on the pool's virtual clock.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

PROFILE_KINDS = ("steady", "diurnal", "flash")


@dataclass(frozen=True)
class WorkloadProfile:
    """Seeded-replayable rate modulation: ``multiplier(t)`` scales the
    base arrival rate as a pure function of virtual seconds since the
    arrival window opened.

    - ``steady`` — the identity (multiplier 1.0 everywhere): profiled
      and unprofiled runs are bit-identical;
    - ``diurnal`` — a raised-cosine day curve between ``trough`` and
      ``peak`` with period ``period`` (the window opens at the trough:
      load ramps up, crests mid-period, ramps back down);
    - ``flash`` — baseline 1.0 with a ``peak``-multiplier crowd spike on
      ``[flash_at, flash_at + flash_duration)`` — the retry-storm arm's
      overload trigger (bench ``saturation``, the ``overload_gate``).
    """

    kind: str = "steady"
    period: float = 20.0
    trough: float = 0.5
    peak: float = 3.0
    flash_at: float = 0.0
    flash_duration: float = 2.0

    def __post_init__(self):
        if self.kind not in PROFILE_KINDS:
            raise ValueError(
                f"unknown profile kind {self.kind!r}; "
                f"known: {', '.join(PROFILE_KINDS)}")
        # validate only what the declared kind reads: from_config passes
        # every WorkloadProfile* knob through, and a config tuned for
        # one kind (e.g. FlashDuration=0 meaning "no flash") must not
        # break a steady/diurnal run that never evaluates it
        if self.kind == "diurnal":
            if self.period <= 0:
                raise ValueError("period must be positive")
            if self.trough <= 0 or self.peak <= 0:
                raise ValueError(
                    "trough and peak multipliers must be positive")
        elif self.kind == "flash":
            if self.flash_duration <= 0:
                raise ValueError("flash_duration must be positive")
            if self.peak <= 0:
                raise ValueError("peak multiplier must be positive")

    @classmethod
    def from_config(cls, kind: str, config) -> "WorkloadProfile":
        """Profile shape from the ``WorkloadProfile*`` config knobs (the
        scripted drivers and the chaos runner share one knob surface)."""
        return cls(kind=kind,
                   period=config.WorkloadProfilePeriod,
                   trough=config.WorkloadProfileTrough,
                   peak=config.WorkloadProfilePeak,
                   flash_at=config.WorkloadProfileFlashAt,
                   flash_duration=config.WorkloadProfileFlashDuration)

    def multiplier(self, t: float) -> float:
        """Rate multiplier at ``t`` virtual seconds into the window."""
        if self.kind == "diurnal":
            # raised cosine from the trough: trough at t=0 and t=period,
            # peak at t=period/2 — continuous, so the arrival chain's
            # gap math never sees a step it could amplify
            phase = 0.5 * (1.0 - math.cos(
                2.0 * math.pi * (t / self.period)))
            return self.trough + (self.peak - self.trough) * phase
        if self.kind == "flash":
            in_spike = self.flash_at <= t < self.flash_at \
                + self.flash_duration
            return self.peak if in_spike else 1.0
        return 1.0


@dataclass(frozen=True)
class WorkloadSpec:
    """One client population. ``rate`` is arrivals per SIM second (open
    loop — arrivals never wait for completions); ``read_fraction`` of
    arrivals are state reads against the hot-key space; the Zipf
    exponents (> 1) skew per-client activity and key popularity."""

    n_clients: int = 1_000_000
    rate: float = 100.0
    duration: float = 30.0
    start: float = 0.0
    read_fraction: float = 0.0
    zipf_clients: float = 1.1
    zipf_keys: float = 1.2
    n_keys: int = 4096
    seed: int = 0
    # rate modulation (None = steady: bit-identical to the pre-profile
    # generator — the arrival chain consumes the same RNG draws)
    profile: Optional[WorkloadProfile] = None

    def __post_init__(self):
        if self.rate <= 0 or self.duration <= 0:
            raise ValueError("rate and duration must be positive")
        if not (0.0 <= self.read_fraction <= 1.0):
            raise ValueError("read_fraction must be in [0, 1]")
        if self.zipf_clients <= 1.0 or self.zipf_keys <= 1.0:
            raise ValueError("zipf exponents must be > 1")


class WorkloadGenerator:
    """Schedules the population's arrivals onto an injected timer.

    ``on_write(client_idx, key_idx)`` / ``on_read(client_idx, key_idx)``
    fire at each arrival instant. The generator is single-use: one
    :meth:`start` per instance (the RNG stream is the identity of the
    run).
    """

    def __init__(self, spec: WorkloadSpec):
        import numpy as np

        self.spec = spec
        self._rng = np.random.RandomState(spec.seed)
        self._started = False
        self._stopped = False
        self.arrivals = 0
        self.writes = 0
        self.reads = 0

    # ------------------------------------------------------------------

    def _zipf_index(self, exponent: float, n: int) -> int:
        """Zipf-distributed index in [0, n): unbounded Zipf draw folded
        into the population (rank 0 is the hottest; the fold keeps the
        head's skew intact because draws beyond ``n`` are rare)."""
        return int(self._rng.zipf(exponent) - 1) % n

    def stop(self) -> None:
        """Cancel future arrivals (the pending timer event fires as a
        no-op). Counters keep their values."""
        self._stopped = True

    def start(self, timer,
              on_write: Callable[[int, int], None],
              on_read: Optional[Callable[[int, int], None]] = None) -> None:
        """Begin the open-loop arrival chain on ``timer``. Arrivals run
        from ``spec.start`` (relative to the timer's clock) until the
        first gap past ``spec.start + spec.duration``; read arrivals are
        DROPPED when no ``on_read`` is wired — the RNG draws are still
        consumed, so a reads-served and a reads-dropped run submit the
        IDENTICAL write sequence (the bench's no-reads comparison arm
        relies on it)."""
        if self._started:
            raise RuntimeError("generator already started")
        self._started = True
        spec = self.spec
        # the window is RELATIVE to the timer's clock at start() —
        # simulation pools begin at an epoch-like instant, and the
        # generator must not care
        begin = timer.get_current_time() + spec.start
        end = begin + spec.duration
        rng = self._rng

        def fire() -> None:
            if self._stopped:
                return
            client = self._zipf_index(spec.zipf_clients, spec.n_clients)
            key = self._zipf_index(spec.zipf_keys, spec.n_keys)
            is_read = (spec.read_fraction > 0.0
                       and rng.random_sample() < spec.read_fraction)
            self.arrivals += 1
            if is_read:
                self.reads += 1
                if on_read is not None:
                    on_read(client, key)
            else:
                self.writes += 1
                on_write(client, key)
            schedule_next()

        profile = spec.profile

        def rate_now() -> float:
            # piecewise-constant thinning-free modulation: the NEXT gap
            # is drawn at the instantaneous profiled rate — a pure
            # function of virtual time, so the RNG stream (and therefore
            # the replay) depends only on (seed, profile), and a steady
            # profile consumes the identical draws as no profile at all
            if profile is None:
                return spec.rate
            return spec.rate * profile.multiplier(
                timer.get_current_time() - begin)

        def schedule_next() -> None:
            gap = float(rng.exponential(1.0 / rate_now()))
            due = timer.get_current_time() + gap
            if due > end:
                return
            timer.schedule(gap, fire)

        rate0 = spec.rate if profile is None \
            else spec.rate * profile.multiplier(0.0)
        first_gap = float(rng.exponential(1.0 / rate0))
        first = begin + first_gap
        if first <= end:
            timer.schedule(
                max(first - timer.get_current_time(), 0.0), fire)

    # ------------------------------------------------------------------

    def counters(self) -> dict:
        return {"arrivals": self.arrivals, "writes": self.writes,
                "reads": self.reads}
