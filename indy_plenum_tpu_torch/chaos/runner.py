"""Scenario runner: pool up, plan in, invariants out, report saved.

One call drives the whole chaos loop deterministically on the virtual
clock: build a :class:`SimPool`, compile the scenario's seeded
:class:`FaultPlan` onto its timer, feed client traffic, run past the last
bounded fault, then hand the pool to the
:class:`~indy_plenum_tpu_torch.chaos.invariants.InvariantChecker` (safety
continuously during the run via the scheduler's probe, safety + liveness
at the end) and emit a replayable :class:`ChaosReport`.

Copy of ``indy_plenum_tpu/chaos/runner.py``, with its imports bound to
the port. ``run_scenario`` takes ``device`` and hands it to the pool: the
CUDA card unless the caller passes ``"cpu"``, so the tick-batched dispatch
plane's quorum step, window slides and zeros (and, with real execution,
the SMT commits and the catchup's proof folds) run on the card. Three
branches wait for later slices of the port and raise
``NotImplementedError`` naming them: laned scenarios (``lanes > 1``, the
lanes slice), saturating workloads (``workload_rate > 0``, the overload
slice) and the edge-cache poisoning check (``edge_poison``, the geo
slice).
"""
from __future__ import annotations

import hashlib
from typing import Dict, Optional

from ..config import getConfig
from ..simulation.pool import SimPool
from ..utils.torch_env import DeviceLike, resolve_device
from .faults import CrashFault
from .invariants import InvariantChecker, InvariantResult
from .report import ChaosReport
from .scenarios import Scenario, get_scenario
from .scheduler import FaultScheduler

# the simulation-friendly protocol tunables every scenario starts from;
# scenario config_overrides layer on top
BASE_CONFIG = {
    "Max3PCBatchWait": 0.1,
    "Max3PCBatchSize": 5,
    # keep executor-faked runs inside one checkpoint window: without real
    # ledgers there is no catchup, so a replica that falls behind a
    # stabilized checkpoint could never re-sync — recovery rides 3PC
    # re-request + NEW_VIEW re-ordering, both of which need peers to
    # still hold the logs. Catchup scenarios (real_execution=True)
    # OVERRIDE this with tiny windows on purpose: crossing a GC'd
    # checkpoint boundary and leeching back is exactly what they test.
    "CHK_FREQ": 50,
    "LOG_SIZE": 150,
    # tight PBFT stall timer: chaos runs stall pools on purpose and the
    # recovery path (stall votes -> view change -> re-propose) is exactly
    # what the liveness invariant exercises
    "OrderingStallTimeout": 4.0,
}


def _catchup_block(pool, plan, scenario, leech_floor) -> dict:
    """The report's catchup forensic record: per-node leecher meters,
    pool totals, per-node committed-ledger hashes (the ordering
    fingerprint that stays comparable ACROSS catchup — a caught-up
    node's ordered_log legitimately skips the leeched middle), and the
    proof-read closing check when the scenario requests it."""
    leechers = {nd.name: nd.leecher for nd in pool.nodes
                if getattr(nd, "leecher", None) is not None}
    if not leechers:
        return {}
    per_node = {name: l.catchup_stats() for name, l in leechers.items()}
    totals = {k: sum(per_node[name][k] for name in sorted(per_node))
              for k in ("rounds_completed", "txns_leeched",
                        "proofs_verified", "reps_rejected", "retries")}
    block = {
        "per_node": per_node,
        "rounds": totals["rounds_completed"],
        "txns_leeched": totals["txns_leeched"],
        "proofs_verified": totals["proofs_verified"],
        "reps_rejected": totals["reps_rejected"],
        "retries": totals["retries"],
        "restarted_nodes": sorted(plan.restarted_nodes),
        "leech_floor": dict(leech_floor),
        "ledger_hash_per_node": {nd.name: pool.ledger_hash(nd.name)
                                 for nd in pool.nodes},
    }
    if scenario.proof_read and pool.bls_keys is not None \
            and plan.restarted_nodes:
        from ..client.state_proof import verify_proved_read

        victim = sorted(plan.restarted_nodes)[0]
        # read a leaf from INSIDE the leeched range (0-based index =
        # the victim's committed size at restart = first leeched seq-1),
        # served by the victim itself against the stabilized window it
        # captured after rejoining — the window's tree COVERS the range
        # it just leeched
        index = leech_floor.get(victim, 0)
        service = pool.make_read_service(victim, mode="auto")
        service.submit(index)
        replies = service.drain()
        reply = replies[-1] if replies else None
        n = len(pool.validators)
        quorum = n - (n - 1) // 3
        keys = {name: pk for name, (kp, pk, pop) in pool.bls_keys.items()}
        verified = bool(
            reply is not None and reply.multi_sig is not None
            and verify_proved_read(reply, keys, min_participants=quorum))
        block["proof_read"] = {
            "node": victim,
            "index": index,
            "window": list(reply.window) if reply is not None
            and reply.window is not None else None,
            "has_multi_sig": bool(reply is not None
                                  and reply.multi_sig is not None),
            "verified": verified,
        }
    return block


def _catchup_verdicts(pool, plan, scenario, block) -> list:
    """The scenario's catchup requirements as first-class invariant
    results — ASSERTED from the leecher meters and the client-side
    proof verdict, so a chaos run can never 'pass' by silently skipping
    recovery."""
    out = []
    if scenario.require_catchup:
        problems = []
        if not plan.restarted_nodes:
            problems.append("no crashed-and-restarted node in the plan")
        for victim in sorted(plan.restarted_nodes):
            stats = (block.get("per_node") or {}).get(victim)
            if stats is None:
                problems.append(f"{victim} has no leecher")
                continue
            if stats["rounds_completed"] < 1:
                problems.append(f"{victim} completed no catchup round")
            if stats["txns_leeched"] < 1:
                problems.append(f"{victim} leeched no txns")
            if stats["proofs_verified"] < stats["txns_leeched"]:
                problems.append(
                    f"{victim} applied {stats['txns_leeched']} txns but "
                    f"proof-verified only {stats['proofs_verified']}")
            if not pool.node(victim).data.is_participating:
                problems.append(f"{victim} is not participating again")
        out.append(InvariantResult(
            "catchup_recovery", not problems,
            "; ".join(problems) if problems else
            f"restarted {sorted(plan.restarted_nodes)} completed "
            f"{block.get('rounds', 0)} round(s), "
            f"{block.get('txns_leeched', 0)} txns leeched, "
            f"{block.get('proofs_verified', 0)} proofs verified"))
    if scenario.require_rejection:
        rejected = block.get("reps_rejected", 0)
        out.append(InvariantResult(
            "catchup_rejection", rejected >= 1,
            f"{rejected} corrupted CATCHUP_REP(s) rejected by proof "
            "verification" if rejected else
            "no CATCHUP_REP was rejected — the byzantine seeder was "
            "never exercised (or its corruption was trusted)"))
    if scenario.require_retries:
        retries = block.get("retries", 0)
        out.append(InvariantResult(
            "catchup_retry", retries >= 1,
            f"retry law re-requested {retries} slice(s)" if retries else
            "no retry fired — the silent seeder was never exercised"))
    if scenario.proof_read:
        pr = block.get("proof_read") or {}
        out.append(InvariantResult(
            "catchup_proof_read", bool(pr.get("verified")),
            f"caught-up node {pr.get('node')} served index "
            f"{pr.get('index')} from window {pr.get('window')}; "
            "verify_proved_read against the pool BLS keys: "
            f"{bool(pr.get('verified'))}"))
    return out


def run_scenario(scenario: "str | Scenario", seed: int,
                 n_nodes: int = 0,
                 out_path: Optional[str] = None,
                 probe_interval: float = 1.0,
                 device_quorum: bool = False,
                 quorum_tick_interval: float = 0.0,
                 quorum_tick_adaptive: bool = False,
                 mesh=None,
                 host_eval: bool = False,
                 trace: bool = False,
                 trace_out: Optional[str] = None,
                 resident_depth: int = 0,
                 device: DeviceLike = None) -> ChaosReport:
    """``device_quorum`` + ``quorum_tick_interval`` > 0 route the scenario
    through the tick-batched dispatch plane (grouped device flushes, per-
    tick quorum evaluation) — fault paths must survive the tick barrier
    exactly as they do the per-message loop, and the report's metrics
    then carry the dispatch amortization numbers.
    ``quorum_tick_adaptive`` additionally hands the tick to the dispatch
    governor: the report's ``governor.tick_interval`` metrics then record
    the interval trajectory (deterministic — replaying the same seed
    yields the identical trajectory, which tests assert).
    ``mesh`` (a :class:`~indy_plenum_tpu_torch.tpu.quorum.FabricMesh`)
    runs the grouped vote plane as the member x validator fabric on the
    pool's one device — fault paths must survive it bit-for-bit
    (``ordered_hash_per_node`` equal to the unsharded run on the same
    seed).
    ``trace`` arms the consensus flight recorder on the pool's virtual
    clock: fault begin/end marks and the full 3PC/dispatch span timeline
    land in one ring, the first invariant violation (and any ordering
    stall / governor anomaly) snapshots its tail into the report's
    ``flight_recorder``, and the report carries ``trace_hash`` — a
    replay of the same seed must reproduce it bit-for-bit.
    ``trace_out`` additionally dumps the whole ring as JSONL
    (``observability.trace.load_jsonl`` reads it back).
    ``resident_depth`` > 1 arms multi-tick device residency on the tick
    plane (votes accumulate in device-side ring slots across that many
    ticks before one fused step consumes them) — fault paths must
    survive the deferred-readback window bit-for-bit, which the
    residency chaos test asserts.
    ``device`` is where the pool's kernels run: the CUDA card unless
    ``"cpu"`` (the kernels' plain versions)."""
    if mesh is not None and not device_quorum:
        raise ValueError("mesh requires device_quorum")
    if resident_depth > 1:
        if quorum_tick_interval <= 0 or not device_quorum:
            raise ValueError(
                "resident_depth requires the tick-batched dispatch "
                "plane (device_quorum=True, quorum_tick_interval > 0)")
        if host_eval:
            raise ValueError("resident_depth is a device-eval "
                             "optimization; host_eval would silently "
                             "run per-tick")
    if quorum_tick_interval > 0 and not device_quorum:
        # the services gate tick mode on having a vote plane: without
        # device_quorum the override would silently run the plain
        # per-message loop while the caller believes otherwise
        raise ValueError("quorum_tick_interval requires device_quorum")
    if quorum_tick_adaptive and quorum_tick_interval <= 0:
        raise ValueError("quorum_tick_adaptive requires a tick interval")
    # the card unless the caller asks for the CPU: without one this raises
    device = resolve_device(device)
    if isinstance(scenario, str):
        scenario = get_scenario(scenario)
    n = n_nodes or scenario.n_nodes
    if scenario.lanes > 1:
        raise NotImplementedError(
            f"scenario {scenario.name!r} runs ordering lanes: laned "
            "scenarios come with the lanes slice of the port")
    if scenario.workload_rate > 0:
        raise NotImplementedError(
            f"scenario {scenario.name!r} drives a saturating workload: "
            "it comes with the overload slice of the port")
    if scenario.edge_poison:
        raise NotImplementedError(
            f"scenario {scenario.name!r} runs the edge-cache poisoning "
            "check: it comes with the geo slice of the port")
    plan = scenario.plan(seed, n)

    overrides = {**BASE_CONFIG, **scenario.config_overrides}
    if quorum_tick_interval > 0:
        overrides["QuorumTickInterval"] = quorum_tick_interval
        overrides["QuorumTickAdaptive"] = quorum_tick_adaptive
    if resident_depth > 1:
        overrides["ResidentTickDepth"] = resident_depth
    config = getConfig(overrides)
    pool = SimPool(n_nodes=n, seed=seed, config=config,
                   device_quorum=device_quorum, mesh=mesh,
                   host_eval=host_eval, trace=trace,
                   real_execution=scenario.real_execution,
                   bls=scenario.bls,
                   num_instances=scenario.num_instances,
                   device=device)
    checker = InvariantChecker(
        pool,
        byzantine=plan.byzantine_nodes,
        crashed=plan.crashed_forever_nodes)
    scheduler = FaultScheduler(
        pool, plan,
        safety_probe=checker.check_safety,
        probe_interval=probe_interval).install()

    # client traffic from t=0, plus a steady trickle across the fault
    # window so crashes/partitions hit in-flight ordering
    for i in range(scenario.initial_requests):
        pool.submit_request(i)
    for i in range(scenario.trickle_requests):
        pool.timer.schedule(
            (i + 1) * scenario.trickle_interval,
            lambda seq=scenario.initial_requests + i:
            pool.submit_request(seq))

    # catchup scenarios: snapshot each restarted victim's committed
    # ledger size at its restart instant — the leeched range starts
    # there, and the proof-read check reads from INSIDE it
    leech_floor: Dict[str, int] = {}
    if scenario.real_execution:
        from ..common.constants import DOMAIN_LEDGER_ID

        def _snap_floor(victim: str) -> None:
            node = pool.node(victim)
            if node.boot is not None:
                leech_floor[victim] = node.boot.db.get_ledger(
                    DOMAIN_LEDGER_ID).size

        for fault in plan.faults:
            if isinstance(fault, CrashFault) and fault.duration is not None:
                pool.timer.schedule(fault.at + fault.duration,
                                    lambda v=fault.node: _snap_floor(v))

    # run past the last bounded fault, then let the pool settle
    horizon = max(scenario.run_seconds, plan.end_time + 5.0)
    pool.run_for(horizon)
    scheduler.stop_probe()

    results = checker.check_all(
        probes=3, liveness_timeout=scenario.liveness_timeout)
    # metrics snapshot before the closing checks: they serve extra reads
    # whose events belong to the checks, not the scenario's record
    metrics_summary = pool.metrics.summary()
    catchup_block = _catchup_block(pool, plan, scenario, leech_floor)
    results.extend(_catchup_verdicts(pool, plan, scenario, catchup_block))

    report = ChaosReport(
        scenario=scenario.name,
        seed=seed,
        n_nodes=n,
        dispatch_mode={
            "device_quorum": device_quorum,
            "tick": quorum_tick_interval,
            "adaptive": quorum_tick_adaptive,
            # the mesh SHAPE ("4" = member sharded, "2x2" = the 2-axis
            # fabric): replay_command must reproduce the exact grid, not
            # just the device count
            "mesh": ("x".join(str(d) for d in mesh.shape)
                     if mesh is not None else 0),
            "host_eval": host_eval,
            "trace": trace,
            "resident": resident_depth,
        },
        plan=plan.as_dicts(),
        trace=list(scheduler.trace),
        invariants=[r.as_dict() for r in results],
        expected_failures=list(scenario.expect_fail),
        network=pool.network.counters(),
        metrics=metrics_summary,
        ordered_per_node={nd.name: len(nd.ordered_digests)
                          for nd in pool.nodes},
        ordered_hash_per_node={
            nd.name: hashlib.sha256(
                "|".join(nd.ordered_digests).encode()).hexdigest()
            for nd in pool.nodes},
        monitor_per_node={
            nd.name: nd.monitor.snapshot() for nd in pool.nodes
            if getattr(nd, "monitor", None) is not None},
        catchup=catchup_block,
        byzantine_nodes=sorted(plan.byzantine_nodes),
        periodic_checks=len(scheduler.probe_results),
        first_violation=scheduler.first_violation,
        virtual_seconds=pool.timer.get_current_time()
        - 1_700_000_000.0,
    )
    if trace:
        # serialize the ring ONCE: the hash and the dump are the same
        # bytes by construction
        jsonl = pool.trace.to_jsonl()
        report.trace_hash = hashlib.sha256(jsonl.encode()).hexdigest()
        report.flight_recorder = [dict(d) for d in pool.trace.dumps]
        # causal request journeys: cross-node e2e latency with the
        # fault windows' measured cost (a journey that spans a fault
        # window shows the fault's latency price directly)
        from ..observability.causal import journey_summary

        report.journeys = journey_summary(pool.trace.events())
        if trace_out is not None:
            with open(trace_out, "w") as fh:
                fh.write(jsonl)
            report.trace_file = trace_out
    if out_path is not None:
        report.save(out_path)
    return report
