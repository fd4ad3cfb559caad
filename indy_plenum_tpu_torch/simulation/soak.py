"""The virtual-day soak: 24 simulated hours of diurnal load on a real
pool, with ONE chaos arc folded in, judged by the telemetry plane.

Long-horizon health is the claim RBFT's monitoring plane exists to make
(Aublin et al., ICDCS 2013): a pool that survives a day of realistic
load without leaking memory, shedding throughput or creeping latency.
This harness makes that claim checkable in minutes of wall clock:
everything rides the MockTimer, so 24 hours are just events, and the
whole artifact — ordered hash, state head, hourly tallies, the
telemetry plane's rollup/anomaly hash chain — is byte-identical across
same-seed runs (the ``soak`` gate runs it twice and diffs fingerprints).

The day is ONE arc, not a scenario matrix:

- **load**: a diurnal deterministic arrival grid (below) over
  ``SoakKeys`` NYM targets, all keys pre-warmed so steady-state touches
  no new state;
- **hour 6** (``SoakCrashHour``): a node fail-stops for
  ``SoakCrashHours`` — long enough that its gap crosses checkpoint GC
  (CHK_FREQ/LOG_SIZE are small here), so rejoining REQUIRES a real
  ledger catchup, verified from the leecher meters;
- **hour 12** (``SoakViewChangeHour``): the master primary drops and
  the pool must elect view 1 and keep ordering; the old primary then
  rejoins;
- **tick ~``SoakRebalanceTick``**: the occupancy rebalancer's forced
  arm fires one shard rotation mid-day (device/mesh pools only).

The drift law needs a subtlety: at soak rates a Poisson workload's
hour-to-hour count noise (~1/sqrt(N), several percent) would swamp the
<1% hour-1 -> hour-24 throughput-drift assertion. So the soak submits a
**deterministic arrival grid** — per 60s slice, ``rate * 60 *
multiplier(phase)`` arrivals with the fractional remainder carried
within the hour and reset at hour boundaries — making every hour's
offered load byte-identical at the same diurnal phase. Key/client picks
still come from the workload plane's seeded Zipf spaces. Whatever drift
the tally shows is then the SYSTEM's (backlog, batching shift), not the
generator's.

Anomaly accounting: the chaos arc legitimately trips drift/leak laws
(ordering stalls during the view change; queues spike during the
crash). Each fired anomaly is classified **explained** when its window
falls inside a chaos leg's influence range (leg start window - 1
through leg end window + drift lag + leak streak); ``bound_violation``
anomalies are NEVER explained. The gate requires zero unexplained
anomalies — and proves the law is live by re-running a short arm with a
deliberately registered leaking resource (``synthetic_leak=True``) and
asserting the leak law catches it.

Copy of ``indy_plenum_tpu/simulation/soak.py``, with its imports bound to
the port. The reference takes its ticked device arm on a (4,) fabric mesh
when JAX sees at least 4 devices (its tests always do) and an event-driven
arm otherwise; the port always takes the ticked arm, with the (4,) fabric
on the pool's one ``device`` (the CUDA card unless the caller passes
``"cpu"``): K13 every tick, fixed 2 s ticks, the forced rebalance leg
through K1. Both packages thus take the same arm on the same seed.
"""
from __future__ import annotations

# da: allow-file[nondet-source] -- soak harness: wall_s is REPORTED next to the deterministic verdicts (fingerprint, telemetry_hash, tallies), never folded into them

import hashlib
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..utils.torch_env import DeviceLike, resolve_device

SLICE_SEC = 60.0  # arrival-grid resolution; divides the window
VC_SLICE_SEC = 5.0  # finer drive while a view change converges
WARM_WRITE_SEC = 600.0  # all keys written once across this span
WARM_SETTLE_SEC = 600.0  # then the pool drains to steady state
WARM_SEC = WARM_WRITE_SEC + WARM_SETTLE_SEC


def _day_mesh(device: DeviceLike = None):
    """The soak's (4,)-fabric mesh, every tile on ``device``: the
    reference's ticked arm, which it takes when JAX sees >= 4 devices."""
    from ..tpu.quorum import make_fabric_mesh

    return make_fabric_mesh([resolve_device(device)] * 4, (4,))


def _day_config(window_sec: float, hours: float, rebalance_tick: int,
                ticked: bool):
    from ..config import getConfig

    overrides = {
        "Max3PCBatchWait": 0.25,
        "Max3PCBatchSize": 100,
        # hourly diurnal cycle: hour 1 and hour 24 sit at the SAME
        # phase, so the <1% drift law compares like with like
        "WorkloadProfilePeriod": 3600.0,
        "WorkloadProfileTrough": 0.5,
        "WorkloadProfilePeak": 2.0,
        "TelemetryWindowSec": window_sec,
        "TelemetryWindowKeep": int((hours * 3600.0 + WARM_SEC)
                                   / window_sec) + 4,
        "TelemetryDriftLag": max(1, int(3600.0 / window_sec)),
        "TelemetryLeakWindows": 6,
        # grace ~2h: warm-phase cache fill and the trace ring reaching
        # capacity are growth by design, not leaks
        "TelemetryLeakGraceWindows": max(6, int(7200.0 / window_sec)),
        "TelemetryAnomalyKeep": 64,
        # small checkpoint window so the hour-long crash gap crosses GC
        # and the rejoin exercises REAL catchup (chaos-runner knobs)
        "CHK_FREQ": 5,
        "LOG_SIZE": 15,
        "ConsistencyProofsTimeout": 1.0,
        "CatchupRequestTimeout": 1.5,
        "CatchupMaxRetries": 8,
        "OrderingStallTimeout": 4.0,
    }
    if ticked:
        overrides.update({
            # FIXED ticks: a request on the device arm needs ~2-3 tick
            # rounds to quorum, so adaptive idle-widening would push
            # order latency past any sane stall timeout during the
            # day's quiet stretches (observed: a view change every ~8
            # virtual seconds, view_no in the thousands). The rebalance
            # leg doesn't need the governor — RebalanceForceTick plans
            # unconditionally at its tick ordinal.
            "QuorumTickInterval": 2.0,
            "QuorumTickAdaptive": False,
            "RebalanceForceTick": rebalance_tick,
            # stall watchdog above the ticked-quorum worst case (~3
            # rounds x 2s) but well under a slice, so post-chaos
            # recovery still fires between arrivals
            "OrderingStallTimeout": 15.0,
        })
    return getConfig(overrides)


def _writer(pool, n_keys: int, seed: int) -> Callable[[], None]:
    """One deterministic NYM write per call: Zipf key/client picks from
    the workload plane's seeded spaces (numpy RandomState, exactly the
    WorkloadGenerator idiom) over a lazily-built signer population."""
    import numpy as np

    from ..common.constants import NYM, TARGET_NYM, TXN_TYPE, VERKEY
    from ..common.request import Request
    from ..crypto.signers import DidSigner

    rng = np.random.RandomState(seed)
    signers: Dict[int, DidSigner] = {}
    seq = [0]

    def signer_for(key: int) -> DidSigner:
        signer = signers.get(key)
        if signer is None:
            signer = DidSigner(hashlib.sha256(b"soak-key-%d" % key).digest())
            signers[key] = signer
        return signer

    def write(key: Optional[int] = None) -> None:
        if key is None:
            key = int(rng.zipf(1.2) - 1) % n_keys
        client = int(rng.zipf(1.1) - 1) % 8
        signer = signer_for(key)
        seq[0] += 1
        req = Request(
            identifier=pool.trustee.identifier,
            reqId=1_000_000 + seq[0],
            operation={TXN_TYPE: NYM, TARGET_NYM: signer.identifier,
                       VERKEY: signer.verkey})
        pool.submit_built(req, client_id="c%d" % client)

    write.count = seq  # type: ignore[attr-defined]
    return write


def _day_soak_once(hours: float, rate: float, seed: int, n_keys: int,
                   crash_hour: float, crash_hours: float,
                   vc_hour: float, rebalance_tick: int,
                   window_sec: float = 600.0,
                   synthetic_leak: bool = False,
                   device: DeviceLike = None) -> Dict:
    from ..ingress.workload import WorkloadProfile
    from .pool import SimPool

    device = resolve_device(device)
    mesh = _day_mesh(device)
    config = _day_config(window_sec, hours, rebalance_tick,
                         ticked=mesh is not None)
    pool = SimPool(4, seed=seed, config=config, real_execution=True,
                   device_quorum=mesh is not None,
                   shadow_check=False if mesh is not None else None,
                   mesh=mesh, trace=True, trace_capacity=8192,
                   device=device)
    profile = WorkloadProfile.from_config("diurnal", config)
    write = _writer(pool, n_keys, seed)
    t0 = pool.timer.get_current_time()

    leak_store: List[int] = []
    if synthetic_leak:
        # the non-vacuity arm: an unbounded structure growing one entry
        # per slice — the leak law MUST catch it within its streak
        from ..observability.telemetry import SizedResource

        pool.resource_ledger.register(SizedResource(
            "soak.synthetic_leak", lambda: len(leak_store)))

    # --- warm phase: every key written once, then a settle window ----
    per_slice = max(1, n_keys // int(WARM_WRITE_SEC / SLICE_SEC))
    next_key = 0
    t = 0.0
    while t < WARM_WRITE_SEC:
        for _ in range(per_slice):
            if next_key < n_keys:
                write(next_key)
                next_key += 1
        pool.run_for(SLICE_SEC)
        t += SLICE_SEC
    while next_key < n_keys:  # remainder lands in the settle window
        write(next_key)
        next_key += 1
    pool.run_for(WARM_SETTLE_SEC)

    # --- the day ------------------------------------------------------
    tap = pool._telemetry_tap
    crash_start = crash_hour * 3600.0
    crash_end = crash_start + crash_hours * 3600.0
    vc_start = vc_hour * 3600.0
    duration = hours * 3600.0
    victim = pool.nodes[-1].name
    crashed = False
    crash_done = crash_start >= duration
    old_primary: Optional[str] = None
    vc_pending = vc_start < duration
    vc_converged_t: Optional[float] = None
    vc_survivors: List = []
    rebalance_planned_t: Optional[float] = None
    hourly_ordered: List[int] = []
    prev_ordered = tap.ordered_txns()
    arrivals = 0
    acc = 0.0
    t = 0.0  # virtual seconds since the day began

    def vc_done() -> bool:
        return all(nd.data.view_no >= 1 and not nd.data.waiting_for_new_view
                   for nd in vc_survivors)

    while t < duration - 1e-9:
        if not crash_done and not crashed and t >= crash_start:
            pool.network.disconnect(victim)
            crashed = True
        if crashed and t >= crash_end:
            pool.network.reconnect(victim)
            crashed = False
            crash_done = True
        if vc_pending and t >= vc_start:
            old_primary = pool.nodes[0].data.primaries[0]
            pool.network.disconnect(old_primary)
            vc_survivors = [nd for nd in pool.nodes
                            if nd.name != old_primary]
            vc_pending = False
        in_vc = old_primary is not None and vc_converged_t is None
        # the arrival grid: per-slice count from the diurnal multiplier
        # at the slice midpoint; remainder carried within the hour and
        # reset at hour boundaries so every hour offers the IDENTICAL
        # byte sequence at the same phase
        step = VC_SLICE_SEC if in_vc else SLICE_SEC
        acc += rate * step * profile.multiplier((t + step / 2.0) % 3600.0)
        n = int(acc)
        acc -= n
        for _ in range(n):
            write()
        arrivals += n
        pool.run_for(step)
        t += step
        if in_vc and vc_done():
            vc_converged_t = t
            pool.network.reconnect(old_primary)
            # realign to the slice grid so hour boundaries keep landing
            # exactly (the VC fine-slices may have left t off-grid)
            rem = (-t) % SLICE_SEC
            if rem:
                pool.run_for(rem)
                t += rem
        if (pool.rebalance is not None and rebalance_planned_t is None
                and pool.rebalance.planned > 0):
            rebalance_planned_t = t
        if t % 3600.0 < step / 2.0 or t >= duration - 1e-9:
            if len(hourly_ordered) < int(t // 3600.0 + 0.5):
                ordered = tap.ordered_txns()
                hourly_ordered.append(ordered - prev_ordered)
                prev_ordered = ordered
                acc = 0.0
        if synthetic_leak:
            leak_store.append(len(leak_store))
    # settle: open-loop submission stops, stragglers (a node still
    # catching up after the chaos arc) get their stall timeouts
    pool.run_for(120.0)
    pool.telemetry.finalize(pool.timer.get_current_time())

    # --- verdicts -----------------------------------------------------
    from ..common.constants import DOMAIN_LEDGER_ID
    from .state_commit_bench import soak_high_water

    catchup = pool.node(victim).leecher.catchup_stats() \
        if crash_start < duration else None
    chaos = {
        "crash": None if crash_start >= duration else {
            "victim": victim,
            "hour": crash_hour,
            "rounds_completed": catchup["rounds_completed"],
            "txns_leeched": catchup["txns_leeched"],
            "ok": catchup["rounds_completed"] >= 1
            and catchup["txns_leeched"] > 0,
        },
        "view_change": None if vc_start >= duration else {
            "old_primary": old_primary,
            "hour": vc_hour,
            "converged_at_s": vc_converged_t,
            "view_no": max(nd.data.view_no for nd in pool.nodes),
            "ok": vc_converged_t is not None,
        },
        "rebalance": {
            "armed": pool.rebalance is not None,
            "planned": (pool.rebalance.planned
                        if pool.rebalance is not None else 0),
            "planned_at_s": rebalance_planned_t,
            "ok": (pool.rebalance.planned >= 1
                   if pool.rebalance is not None else None),
        },
    }

    # explained-anomaly classification: windows inside a chaos leg's
    # influence range (see module docstring); bound violations never
    wph = int(3600.0 / window_sec)
    lag = config.TelemetryDriftLag
    streak = config.TelemetryLeakWindows

    def w_of(day_t: float) -> int:
        return int((WARM_SEC + day_t) / window_sec)

    ranges: List[Tuple[int, int]] = []
    if crash_start < duration:
        ranges.append((w_of(crash_start) - 1,
                       w_of(min(crash_end, duration)) + lag + streak))
    if vc_start < duration:
        vc_end = vc_converged_t if vc_converged_t is not None else duration
        ranges.append((w_of(vc_start) - 1, w_of(vc_end) + lag + streak))
    if rebalance_planned_t is not None:
        ranges.append((w_of(rebalance_planned_t) - 1,
                       w_of(rebalance_planned_t) + lag + streak))
    unexplained = []
    for rec in pool.telemetry.anomalies:
        explained = rec["law"] != "bound_violation" and any(
            lo <= rec["window"] <= hi for lo, hi in ranges)
        if not explained:
            unexplained.append(dict(rec))

    # flatness: per-resource window high-water over the LAST ~30% of
    # post-hour-1 windows must not exceed the first ~70% (which contains
    # the whole chaos arc — its spikes raise the baseline, not the tail)
    rows = list(pool.telemetry.windows)
    post = [r for r in rows if r["window"] >= w_of(0.0) + wph]
    k = max(1, int(len(post) * 0.7))
    first_hw, last_hw, flat = soak_high_water(
        pool, per_hour=wph, first_rows=post[:k], last_rows=post[k:] or post,
        slack_frac=0.2)

    drift = (abs(hourly_ordered[-1] - hourly_ordered[0])
             / hourly_ordered[0]) if len(hourly_ordered) > 1 \
        and hourly_ordered[0] else 0.0
    state = pool.nodes[0].boot.db.get_state(DOMAIN_LEDGER_ID)
    # ledger-level agreement: catchup-recovered nodes have HOLES in
    # ordered_digests (leeched txns never ride Ordered), so the prefix
    # check is the wrong invariant for a chaos day — what must agree is
    # the committed artifact itself
    heads = set()
    for nd in pool.nodes:
        lg = nd.boot.db.get_ledger(DOMAIN_LEDGER_ID)
        st = nd.boot.db.get_state(DOMAIN_LEDGER_ID)
        heads.add((lg.size, lg.root_hash, st.committed_head_hash))
    agree = len(heads) == 1
    fingerprint = hashlib.sha256(repr((
        pool.ordered_hash(),
        state.committed_head_hash,
        hourly_ordered,
        pool.telemetry.telemetry_hash,
    )).encode()).hexdigest()
    return {
        "hours": hours,
        "rate": rate,
        "seed": seed,
        "n_keys": n_keys,
        "device_arm": mesh is not None,
        "arrivals": arrivals,
        "warm_writes": n_keys,
        "ordered_total": tap.ordered_txns(),
        "hourly_ordered": hourly_ordered,
        "throughput_drift": round(drift, 4),
        "first_high_water": first_hw,
        "last_high_water": last_hw,
        "flat_high_water": flat,
        "windows": pool.telemetry.completed,
        "anomalies": pool.telemetry.anomaly_count,
        "anomalies_unexplained": len(unexplained),
        "unexplained": unexplained,
        "bound_violations": pool.telemetry.snapshot()["bound_violations"],
        "chaos": chaos,
        "agree": agree,
        "telemetry_hash": pool.telemetry.telemetry_hash,
        "fingerprint": fingerprint,
    }


def run_day_soak(hours: Optional[float] = None,
                 rate: Optional[float] = None,
                 seed: int = 17,
                 n_keys: Optional[int] = None,
                 crash_hour: Optional[float] = None,
                 crash_hours: Optional[float] = None,
                 vc_hour: Optional[float] = None,
                 rebalance_tick: Optional[int] = None,
                 window_sec: float = 600.0,
                 repeats: int = 2,
                 synthetic_leak: bool = False,
                 device: DeviceLike = None) -> Dict:
    """The virtual-day soak, ``repeats`` times on one seed: the record
    everyone asserts on. Defaults come from the ``Soak*`` config knobs;
    pass explicit (scaled-down) hours for test slices. ``device`` runs the
    pool's kernels: the card unless ``"cpu"``."""
    from ..config import getConfig

    base = getConfig()
    hours = base.SoakHours if hours is None else hours
    rate = base.SoakRate if rate is None else rate
    n_keys = base.SoakKeys if n_keys is None else n_keys
    crash_hour = base.SoakCrashHour if crash_hour is None else crash_hour
    crash_hours = base.SoakCrashHours if crash_hours is None \
        else crash_hours
    vc_hour = base.SoakViewChangeHour if vc_hour is None else vc_hour
    rebalance_tick = base.SoakRebalanceTick if rebalance_tick is None \
        else rebalance_tick
    t0 = time.perf_counter()
    runs = [_day_soak_once(hours, rate, seed, n_keys, crash_hour,
                           crash_hours, vc_hour, rebalance_tick,
                           window_sec=window_sec,
                           synthetic_leak=synthetic_leak, device=device)
            for _ in range(repeats)]
    rec = dict(runs[0])
    rec.update({
        "repeats": repeats,
        "deterministic": all(r["fingerprint"] == runs[0]["fingerprint"]
                             for r in runs),
        "wall_s": round(time.perf_counter() - t0, 1),
    })
    return rec
