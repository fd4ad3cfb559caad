"""Named chaos scenarios: seed -> FaultPlan generators.

Each scenario is a recipe that expands ``(seed, n_nodes)`` into a
concrete :class:`FaultPlan` through ONE ``random.Random(seed)`` — victim
selection, fault timing and probabilities are all drawn from it, so a
scenario replays exactly from its seed (the whole point of the chaos
plane: any red run is a repro, not an anecdote).

``expect_fail`` names invariants a scenario is DESIGNED to violate — the
checker-vacuity proof (``broken_agreement``) must fail agreement, and a
runner treats exactly those failures as the expected outcome.

Copy of ``indy_plenum_tpu/chaos/scenarios.py``, with its imports bound to
the port.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

from .faults import (
    ClockSkewFault,
    CorruptCatchupRepFault,
    CorruptOrderedLogFault,
    CrashFault,
    DelayFault,
    DropFault,
    DuplicateFault,
    EquivocateFault,
    FaultPlan,
    PartitionFault,
    ReorderFault,
    SilenceFault,
)

THREE_PC_TYPES = ("PrePrepare", "Prepare", "Commit")
# the messages a seeder answers catchup with: silencing them models a
# seeder that accepts requests and never replies (retry law territory)
CATCHUP_REPLY_TYPES = ("CatchupRep", "ConsistencyProof", "LedgerStatus")


@dataclass
class Scenario:
    name: str
    build: Callable[[random.Random, List[str]], List]
    description: str = ""
    n_nodes: int = 4
    initial_requests: int = 8
    # a steady client trickle keeps work in flight while faults are
    # active, so crashes/partitions hit mid-protocol, not an idle pool
    trickle_requests: int = 12
    trickle_interval: float = 1.5
    run_seconds: float = 30.0
    liveness_timeout: float = 40.0
    expect_fail: Tuple[str, ...] = ()
    config_overrides: Dict = field(default_factory=dict)
    # catchup-plane scenarios run REAL ledgers (the leecher needs them);
    # bls additionally arms the state-proof plane so the freshly
    # caught-up node can serve verify_proved_read-able replies
    real_execution: bool = False
    bls: bool = False
    num_instances: int = 1  # RBFT protocol instances (0 = auto f+1)
    # extra invariants the runner appends for catchup scenarios — each
    # is ASSERTED from the pool's leecher meters, never assumed:
    # require_catchup: every crashed-and-restarted node completed >= 1
    #   leecher round, leeched > 0 txns, proof-verified every applied
    #   batch, and is participating again;
    # require_rejection: >= 1 CATCHUP_REP was rejected by audit-proof
    #   verification (byzantine-seeder scenarios);
    # require_retries: the retry law re-requested >= 1 silent slice;
    # proof_read: the caught-up node serves a proof-attached read from
    #   the window it just leeched that passes verify_proved_read
    #   against the pool's BLS keys (needs bls=True).
    require_catchup: bool = False
    require_rejection: bool = False
    require_retries: bool = False
    proof_read: bool = False
    # geo plane: arm the cache-poisoning closing check — a byzantine
    # region-local edge cache tampers every proof reply it serves, and
    # the client verification loop must catch 100% of it (asserted
    # non-vacuously, alongside an honest edge serving the same reads).
    # Needs bls=True + real_execution=True (the edge replicates a real
    # stabilized window's proof-attached replies).
    edge_poison: bool = False
    # ordering lanes: > 1 routes the scenario through a LanedPool of
    # this many lanes — faults apply INSIDE lane 0 (the runner's fault
    # facade), per-lane safety aggregates, the cross_lane invariant
    # (barrier seal/skew/fingerprint) probes continuously, and liveness
    # probes every lane
    lanes: int = 0
    # overload robustness plane: workload_rate > 0 drives a seeded
    # open-loop population (profiled via workload_profile, closed-loop
    # retries when the config overrides arm IngressRetryMax) through the
    # pool's ADMISSION path for the scenario's whole fault arc. Requires
    # the tick-batched dispatch plane (the ingress drain rides the tick)
    # and sign_requests (the runner arms both); IngressQueueCapacity
    # must come from config_overrides or nothing ever sheds.
    workload_rate: float = 0.0
    workload_duration: float = 0.0
    workload_start: float = 0.0
    workload_profile: str = "steady"
    workload_clients: int = 10_000

    def plan(self, seed: int, n_nodes: int = 0) -> FaultPlan:
        n = n_nodes or self.n_nodes
        validators = [f"node{i}" for i in range(n)]
        rng = random.Random(seed)
        return FaultPlan(seed=seed, faults=self.build(rng, validators))


SCENARIOS: Dict[str, Scenario] = {}


def register(scenario: Scenario) -> Scenario:
    SCENARIOS[scenario.name] = scenario
    return scenario


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown chaos scenario {name!r}; known: "
            f"{', '.join(sorted(SCENARIOS))}") from None


def _split(validators: List[str], rng: random.Random
           ) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """An rng-chosen ~half/half partition of the pool."""
    shuffled = list(validators)
    rng.shuffle(shuffled)
    cut = len(shuffled) // 2
    return tuple(shuffled[:cut]), tuple(shuffled[cut:])


# --- the acceptance scenario: f crashes + a partition that heals ---------

def _f_crash_partition(rng: random.Random, validators: List[str]) -> List:
    f = (len(validators) - 1) // 3
    # crash f non-primary nodes (staggered, all restart): the pool keeps
    # ordering on the remaining n-f quorum, and the restarted nodes must
    # re-join. node0 is the view-0 primary under the round-robin selector.
    victims = rng.sample(validators[1:], f)
    faults: List = [
        CrashFault(node=victim, at=2.0 + 2.0 * i, duration=6.0)
        for i, victim in enumerate(victims)]
    # then a clean ~half/half partition: no side may have a commit quorum,
    # ordering stalls, and the heal must bring progress back
    groups = _split(validators, rng)
    faults.append(PartitionFault(groups=groups, at=14.0, duration=6.0))
    return faults


register(Scenario(
    name="f_crash_partition",
    build=_f_crash_partition,
    description="f staggered crash/restarts, then a half/half partition "
                "that heals; all invariants must hold",
    run_seconds=30.0))


# --- single-primitive scenarios (each fault class in isolation) ----------

def _crash_restart(rng: random.Random, validators: List[str]) -> List:
    victim = rng.choice(validators)  # may be the primary: exercises VC
    return [CrashFault(node=victim, at=2.0, duration=8.0)]


register(Scenario(
    name="crash_restart",
    build=_crash_restart,
    description="one node (possibly the primary) fail-stops and restarts",
    run_seconds=25.0))


def _partition_heal(rng: random.Random, validators: List[str]) -> List:
    return [PartitionFault(groups=_split(validators, rng),
                           at=3.0, duration=8.0)]


register(Scenario(
    name="partition_heal",
    build=_partition_heal,
    description="half/half partition for 8s, then heal",
    run_seconds=25.0))


def _flaky_links(rng: random.Random, validators: List[str]) -> List:
    # probabilistic 3PC message loss on the whole mesh — below the drop
    # rate that starves a quorum, ordering must still make progress
    return [DropFault(types=THREE_PC_TYPES, probability=0.15,
                      at=2.0, duration=10.0)]


register(Scenario(
    name="flaky_links",
    build=_flaky_links,
    description="15% seeded loss on all 3PC traffic for 10s",
    run_seconds=30.0))


def _dup_reorder(rng: random.Random, validators: List[str]) -> List:
    # at-least-once + out-of-order delivery: vote collection must be
    # idempotent and order-insensitive
    return [
        DuplicateFault(types=THREE_PC_TYPES, copies=3, gap=0.07,
                       at=1.0, duration=10.0),
        ReorderFault(types=THREE_PC_TYPES, jitter=0.4,
                     at=1.0, duration=10.0),
    ]


register(Scenario(
    name="dup_reorder",
    build=_dup_reorder,
    description="3PC messages delivered 3x with 0.4s reorder jitter",
    run_seconds=25.0))


def _clock_skew(rng: random.Random, validators: List[str]) -> List:
    victim = rng.choice(validators[1:])
    return [ClockSkewFault(node=victim, skew=0.6, at=2.0, duration=10.0),
            DelayFault(frm=victim, seconds=0.3, at=2.0, duration=10.0)]


register(Scenario(
    name="clock_skew",
    build=_clock_skew,
    description="one replica runs 0.6s behind the pool (plus slow uplink)",
    run_seconds=25.0))


def _silent_primary(rng: random.Random, validators: List[str]) -> List:
    # byzantine silence, bounded: the primary withholds PRE-PREPAREs for a
    # while (slow-but-alive byzantine); ordering must resume after
    return [SilenceFault(node=validators[0], types=("PrePrepare",),
                         at=2.0, duration=6.0)]


register(Scenario(
    name="silent_primary",
    build=_silent_primary,
    description="primary withholds PRE-PREPAREs for 6s, then behaves",
    run_seconds=25.0))


def _equivocating_primary(rng: random.Random, validators: List[str]) -> List:
    # permanent equivocation by the view-0 primary: conflicting digests
    # can never gather a prepare quorum, suspicion evidence votes the
    # primary out, and the HONEST pool must stay consistent and live
    return [EquivocateFault(node=validators[0], at=1.0)]


register(Scenario(
    name="equivocating_primary",
    build=_equivocating_primary,
    description="primary sends per-recipient forged PRE-PREPARE digests "
                "until voted out",
    run_seconds=45.0,
    liveness_timeout=60.0))


def _storm(rng: random.Random, validators: List[str]) -> List:
    # everything at once, long horizon: crashes, loss, duplication,
    # reorder, skew — the 'as many scenarios as you can imagine' soak
    faults: List = [
        DropFault(types=THREE_PC_TYPES, probability=0.1,
                  at=1.0, duration=25.0),
        DuplicateFault(copies=2, gap=0.05, at=1.0, duration=25.0),
        ReorderFault(jitter=0.3, at=1.0, duration=25.0),
    ]
    f = (len(validators) - 1) // 3
    for i, victim in enumerate(rng.sample(validators[1:], f)):
        faults.append(CrashFault(node=victim, at=4.0 + 3.0 * i,
                                 duration=5.0))
        faults.append(ClockSkewFault(node=victim, skew=0.4,
                                     at=12.0 + 2.0 * i, duration=6.0))
    return faults


register(Scenario(
    name="storm",
    build=_storm,
    description="25s soak: loss + duplication + reorder + crashes + skew",
    run_seconds=60.0,
    liveness_timeout=60.0,
    initial_requests=16))


# --- catchup plane: recovery across checkpoint GC ------------------------
#
# The pre-catchup chaos library pinned CHK_FREQ high so a whole run fit
# one checkpoint window (a node behind a stabilized checkpoint could not
# recover). These scenarios do the opposite ON PURPOSE: tiny windows, a
# crash long enough for >= StateProofCacheWindows checkpoints to
# stabilize AND garbage-collect in the victim's absence, then a restart
# — the victim must detect the gap (f+1 checkpoints beyond its H),
# leech the missed range from seeders with every batch audit-proof
# verified, and rejoin 3PC ordering.

_CATCHUP_CONFIG = {
    "Max3PCBatchSize": 1,  # checkpoints move per txn
    "Max3PCBatchWait": 0.1,
    "CHK_FREQ": 2,
    "LOG_SIZE": 6,
    # several small slices per ledger so round-robin assignment spreads
    # requests across seeders (byzantine/silent seeders get their turn)
    "CatchupBatchSize": 2,
    # snappy, deterministic retry law under the mock clock
    "ConsistencyProofsTimeout": 1.0,
    "CatchupRequestTimeout": 1.5,
    "CatchupMaxRetries": 8,
    "OrderingStallTimeout": 4.0,
    "StateProofCacheWindows": 2,
}


def _crash_across_gc(rng: random.Random, validators: List[str],
                     at: float = 2.0, duration: float = 12.0) -> tuple:
    """A non-primary victim crashed long enough for >= 2 checkpoint
    windows to stabilize and GC without it (the trickle keeps batches —
    and therefore checkpoints — flowing the whole time)."""
    victim = rng.choice(validators[1:])
    return victim, CrashFault(node=victim, at=at, duration=duration)


def _f_crash_gc_catchup(rng: random.Random, validators: List[str]) -> List:
    _, crash = _crash_across_gc(rng, validators)
    return [crash]


register(Scenario(
    name="f_crash_gc_catchup",
    build=_f_crash_gc_catchup,
    description="node crashes, >= 2 checkpoint windows stabilize and GC "
                "in its absence, restart -> full leecher round (every "
                "batch audit-proof verified) -> rejoin; the caught-up "
                "node then serves a verify_proved_read-able reply",
    run_seconds=30.0,
    liveness_timeout=45.0,
    real_execution=True,
    bls=True,
    require_catchup=True,
    proof_read=True,
    config_overrides=dict(_CATCHUP_CONFIG)))


def _byzantine_seeder_catchup(rng: random.Random,
                              validators: List[str]) -> List:
    victim, crash = _crash_across_gc(rng, validators)
    # a byzantine seeder among the survivors: corrupted CATCHUP_REPs must
    # be rejected by proof verification, never trusted (it stays honest
    # in 3PC — only its catchup answers lie)
    evil = rng.choice([v for v in validators if v != victim])
    return [CorruptCatchupRepFault(node=evil, at=0.0), crash]


register(Scenario(
    name="byzantine_seeder_catchup",
    build=_byzantine_seeder_catchup,
    description="GC-crossing crash/restart while a byzantine seeder "
                "serves corrupted CATCHUP_REPs: proof verification must "
                "reject them (asserted) and honest seeders complete the "
                "round",
    run_seconds=30.0,
    liveness_timeout=45.0,
    real_execution=True,
    require_catchup=True,
    require_rejection=True,
    config_overrides=dict(_CATCHUP_CONFIG)))


def _silent_seeder_catchup(rng: random.Random,
                           validators: List[str]) -> List:
    victim, crash = _crash_across_gc(rng, validators)
    # one survivor answers NOTHING on the catchup plane while the victim
    # recovers: the seeded retry/timeout/backoff law must re-route its
    # slices to the live seeders instead of stalling
    mute = rng.choice([v for v in validators if v != victim])
    return [crash,
            SilenceFault(node=mute, types=CATCHUP_REPLY_TYPES,
                         at=13.0, duration=22.0)]


register(Scenario(
    name="silent_seeder_catchup",
    build=_silent_seeder_catchup,
    description="GC-crossing crash/restart with one seeder silent on the "
                "whole catchup plane: the retry law re-routes its slices "
                "(retries asserted) and recovery completes",
    run_seconds=40.0,
    liveness_timeout=45.0,
    real_execution=True,
    require_catchup=True,
    require_retries=True,
    config_overrides=dict(_CATCHUP_CONFIG)))


def _ic_storm_mid_catchup(rng: random.Random,
                          validators: List[str]) -> List:
    victim, crash = _crash_across_gc(rng, validators)
    # monitor-degradation storm mid-catchup: a byzantine backup-instance
    # primary withholds its PRE-PREPAREs for the whole recovery window
    # AND the master primary goes silent long enough for the ordering
    # stall watchdog to force an instance change while the victim is
    # still leeching — catchup must survive the view change. Under the
    # round-robin selector the instance-1 primary is validators[1] (the
    # victim is drawn from validators[1:], so skip to validators[2] when
    # they collide); the view-0 master primary is validators[0], which
    # is never the victim.
    backup_primary = validators[1] if validators[1] != victim \
        else validators[2]
    return [
        crash,
        SilenceFault(node=backup_primary, types=("PrePrepare",),
                     at=14.0, duration=8.0),
        SilenceFault(node=validators[0], types=("PrePrepare",),
                     at=15.0, duration=6.0),
    ]


register(Scenario(
    name="ic_storm_mid_catchup",
    build=_ic_storm_mid_catchup,
    description="GC-crossing crash/restart with a byzantine backup "
                "primary and a stalled master mid-catchup: the instance "
                "change fires while the victim is leeching and recovery "
                "still completes",
    run_seconds=45.0,
    liveness_timeout=60.0,
    real_execution=True,
    num_instances=0,  # auto f+1: real RBFT backup instances in the storm
    require_catchup=True,
    config_overrides=dict(_CATCHUP_CONFIG)))


# --- ordering lanes: faults inside one lane of a laned pool --------------
#
# The multi-lane write path's acceptance scenario: the f_crash_partition
# arc (f staggered crash/restarts, then a half/half partition that
# heals) applied INSIDE lane 0 of a 4-lane pool. The healthy lanes keep
# ordering — but only as far as the cross-lane barrier's skew bound
# (LOG_SIZE past the last sealed window): the continuously-probed
# cross_lane invariant asserts no lane ever stabilizes a window the
# barrier hasn't sealed, the seal fingerprint chain stays recomputable,
# and after the heal every lane resumes (per-lane liveness probes).
# Tiny checkpoint windows on purpose: the barrier must seal many times
# DURING the fault, not just at the end.

register(Scenario(
    name="lane_partition",
    build=_f_crash_partition,
    description="f crash/restarts + half/half partition INSIDE lane 0 "
                "of a 4-lane pool: healthy lanes stall at the barrier's "
                "skew bound, never past it (cross_lane asserted "
                "continuously); lane 0's crashed node leeches back "
                "across GC'd windows and every lane resumes after the "
                "heal",
    lanes=4,
    run_seconds=30.0,
    liveness_timeout=60.0,
    # real ledgers: lane 0's crash victim falls behind windows that
    # stabilize AND GC in its absence (CHK_FREQ=2), so rejoining takes
    # a real leecher round — the catchup plane must work INSIDE a lane,
    # with the barrier's lane_caught_up floor riding along; ASSERTED
    # via the catchup_recovery verdict, not assumed
    real_execution=True,
    require_catchup=True,
    config_overrides={
        "Max3PCBatchSize": 1,  # checkpoints move per txn
        "CHK_FREQ": 2,
        "LOG_SIZE": 6,
        "CatchupBatchSize": 2,
        "ConsistencyProofsTimeout": 1.0,
        "CatchupRequestTimeout": 1.5,
        "CatchupMaxRetries": 8,
        # the healthy lanes WILL stall at the skew bound while lane 0
        # is partitioned — give the stall watchdog room so they don't
        # churn instance changes against a wait that is by design
        "OrderingStallTimeout": 10.0,
    }))


# --- overload robustness: catchup while ingress saturates ----------------
#
# The catchup scenarios above recover on an otherwise-idle pool; real
# recoveries happen while the pool is busiest. Here the GC-crossing
# crash/restart arc runs UNDER a flash-crowd workload with closed-loop
# retries: the victim restarts right as the crowd spikes, so the pool is
# simultaneously (a) shedding + absorbing the retry storm, (b) ordering
# the admitted backlog, and (c) seeding the victim's leecher — with the
# seeder token bucket throttling (c) so it cannot stall (b). Verdicts
# assert recovery (catchup_recovery) and the shed/retry fingerprints in
# the report let the overload gate assert byte-identical replays.

def _f_crash_catchup_under_saturation(rng: random.Random,
                                      validators: List[str]) -> List:
    _, crash = _crash_across_gc(rng, validators, at=2.0, duration=8.0)
    return [crash]


register(Scenario(
    name="f_crash_catchup_under_saturation",
    build=_f_crash_catchup_under_saturation,
    description="GC-crossing crash/restart while a flash-crowd profile "
                "saturates ingress and shed clients retry on seeded "
                "backoff: the victim leeches back through a throttled "
                "seeder (deferrals metered, ordering never stalls) and "
                "the shed/retry sets replay byte-identically",
    run_seconds=30.0,
    liveness_timeout=60.0,
    real_execution=True,
    require_catchup=True,
    # the crowd: a modest base rate whose flash spike (12x for 2s,
    # absolute t=9.5..11.5) lands exactly as the victim restarts (t=10)
    # and starts leeching
    workload_rate=15.0,
    workload_duration=6.0,
    workload_start=6.0,
    workload_profile="flash",
    config_overrides={
        **_CATCHUP_CONFIG,
        # checkpoints still move fast (CHK_FREQ=2 in pp_seq space, the
        # trickle keeps single-request batches flowing through the
        # crash) but the crowd's admitted flood orders in REAL batches,
        # and the victim leeches it back in REAL slices — at the catchup
        # library's Max3PCBatchSize=1 / CatchupBatchSize=2 the backlog
        # and the slice chatter alone would dominate the wall clock
        "Max3PCBatchSize": 12,
        "CatchupBatchSize": 10,
        # admission + closed-loop retry: small queue so the spike sheds,
        # snappy seeded backoff so retries land inside the run window
        "IngressQueueCapacity": 6,
        "IngressRetryMax": 3,
        "IngressRetryBase": 0.3,
        "IngressRetryBackoffMult": 2.0,
        "IngressRetryBackoffMax": 4.0,
        "WorkloadProfilePeak": 12.0,
        "WorkloadProfileFlashAt": 3.5,
        "WorkloadProfileFlashDuration": 2.0,
        # seeder throttle: slices cost up to 10 txns (CatchupBatchSize),
        # the 10-token bucket refills at 40 txns/s — back-to-back slices
        # defer (metered) while the leecher's retry law rides the delay
        "CatchupSeederThrottleTxnsPerSec": 40.0,
        "CatchupSeederThrottleBurst": 10,
    }))


# --- geo plane: edge cache poisoning -------------------------------------
#
# The edge proof tier (proofs/edge_cache.py) is UNTRUSTED by design:
# verification, not the cache, is the security boundary. This arc proves
# that boundary non-vacuously: after a clean run seals checkpoint
# windows, the closing check replicates the last window's proof-attached
# replies into TWO region-local edges, arms deterministic tampering on
# one (leaf flips / root flips / corrupted multi-sigs), serves the same
# read set from both, and asserts (a) the client verification loop
# catches EVERY tampered reply and falls back to the origin validator,
# (b) the honest edge's replies all verify, (c) the tamper counter is
# non-zero (the check actually exercised the byzantine path).

def _edge_cache_poisoning(rng: random.Random, validators: List[str]) -> List:
    # the byzantine actor lives OUTSIDE consensus — a poisoned edge in
    # the closing check, not a network fault
    return []


register(Scenario(
    name="edge_cache_poisoning",
    build=_edge_cache_poisoning,
    description="a byzantine region-local edge cache tampers every proof "
                "reply it serves: clients catch 100% by offline "
                "verification and fall back to the origin validator, "
                "while an honest edge serving the same reads stays fully "
                "verifiable (all asserted, non-vacuously)",
    run_seconds=20.0,
    liveness_timeout=30.0,
    real_execution=True,
    bls=True,
    edge_poison=True,
    config_overrides=dict(_CATCHUP_CONFIG)))


# --- the checker-vacuity proof -------------------------------------------

def _broken_agreement(rng: random.Random, validators: List[str]) -> List:
    # an 'undetectable' state-corruption bug on an honest replica: the
    # agreement invariant MUST flag it, or the checker is vacuous
    victim = rng.choice(validators[1:])
    return [CorruptOrderedLogFault(node=victim, at=6.0)]


register(Scenario(
    name="broken_agreement",
    build=_broken_agreement,
    description="deliberately corrupt one honest replica's executed log; "
                "the agreement invariant must FAIL",
    run_seconds=12.0,
    expect_fail=("agreement", "ordered_prefix")))
