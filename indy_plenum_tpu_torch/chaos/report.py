"""Reproducible chaos-run reports.

A run's full forensic record as JSON: the seed and scenario (everything
needed to replay it exactly), the compiled fault plan, the virtual-time
event trace, network delivery accounting, pool metrics, per-node ordering
state and every invariant verdict. A failing run's report IS its repro —
``replay_command`` re-executes the identical schedule.

Copy of ``indy_plenum_tpu/chaos/report.py``, with its imports bound to
the port. ``replay_command`` names the port's chaos CLI
(``python -m indy_plenum_tpu_torch.tools.chaos_run``) where the reference
names its ``scripts/chaos_run.py``; the flags after it are the same.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


@dataclass
class ChaosReport:
    scenario: str
    seed: int
    n_nodes: int
    plan: List[Dict[str, Any]]
    trace: List[Tuple[float, str]]
    invariants: List[Dict[str, Any]]
    expected_failures: List[str]
    network: Dict[str, Any] = field(default_factory=dict)
    metrics: Dict[str, Any] = field(default_factory=dict)
    ordered_per_node: Dict[str, int] = field(default_factory=dict)
    # sha256 of each node's ordered-digest sequence: lets two runs (e.g.
    # per-message vs tick-batched vs adaptive-tick on the same seed) be
    # compared for ORDERING identity, not just count identity, without
    # embedding every digest in the report
    ordered_hash_per_node: Dict[str, str] = field(default_factory=dict)
    # RBFT monitor views, for pools whose nodes carry one (NodePool)
    monitor_per_node: Dict[str, Any] = field(default_factory=dict)
    # catchup plane (real-execution scenarios): per-node leecher meters
    # (rounds / txns leeched / proofs verified / reps rejected / retry-law
    # re-requests), per-node committed-ledger hashes — the ordering
    # fingerprint that stays comparable across catchup, asserted
    # bit-identical by the budget script's catchup gate — and the
    # proof-read closing check (the freshly caught-up node serving a
    # verify_proved_read-able reply from the window it just leeched)
    catchup: Dict[str, Any] = field(default_factory=dict)
    byzantine_nodes: List[str] = field(default_factory=list)
    periodic_checks: int = 0
    first_violation: Optional[Tuple[float, str]] = None
    virtual_seconds: float = 0.0
    # how the run was routed through the dispatch plane (device quorum /
    # tick / adaptive / mesh shape — "4" member-sharded or "2x2" for the
    # 2-axis member x validator fabric): replay_command must reproduce
    # the exact pipeline, not just the fault schedule — a mesh run
    # replayed unsharded (or a 2-axis run replayed 1-axis) would still
    # order identically (that's the tested contract) but would no longer
    # exercise the path being debugged
    dispatch_mode: Dict[str, Any] = field(default_factory=dict)
    # consensus flight recorder (observability.trace): the trace
    # fingerprint (bit-identical across replays of the same seed), where
    # the full JSONL dump landed, and every triggered tail snapshot
    # (invariant violation / ordering stall / governor anomaly) — the
    # report carries the flight-recorder moment itself, replayable via
    # replay_command
    trace_hash: Optional[str] = None
    trace_file: Optional[str] = None
    flight_recorder: List[Dict[str, Any]] = field(default_factory=list)
    # causal request journeys (observability.causal, traced runs only):
    # journey counts + completeness, the byte-stable journey_hash, e2e
    # percentiles per request class, and — because chaos fault begin/end
    # marks ride the same timeline — the measured latency cost of the
    # requests whose journey crossed a fault window vs the ones that
    # ran clear
    journeys: Dict[str, Any] = field(default_factory=dict)
    # ordering lanes (laned scenarios): router distribution, barrier
    # counters (sealed window / seals / fingerprint chain tip), per-lane
    # ordered hashes — the cross-lane ordering record the cross_lane
    # invariant verified during the run
    lanes: Dict[str, Any] = field(default_factory=dict)
    # overload robustness plane (workload-bearing scenarios): the
    # admission/shed/retry record of the saturating open-loop load the
    # scenario ran under — workload counters, admission counters, the
    # shed_hash / retry_hash fingerprints (byte-identical per seed, so
    # the overload gate replays them like trace_hash), and the
    # per-seeder throttle meters proving the pool kept ordering while
    # it seeded the returning victim
    ingress: Dict[str, Any] = field(default_factory=dict)
    # geo plane (edge_poison scenarios): the cache-poisoning closing
    # check's record — tampered/caught counts on the byzantine edge,
    # the honest edge's verification record, and the fallback
    # accounting proving every poisoned reply was re-served from the
    # origin after verification caught it
    edge: Dict[str, Any] = field(default_factory=dict)

    @property
    def failed(self) -> List[str]:
        return [r["name"] for r in self.invariants
                if r["verdict"] != "PASS"]

    @property
    def verdict_as_expected(self) -> bool:
        """True when exactly the designed-to-fail invariants failed —
        the pass criterion for scenarios proving the checker non-vacuous."""
        return sorted(self.failed) == sorted(self.expected_failures)

    @property
    def replay_command(self) -> str:
        """The port's chaos CLI with the reference's flags, in its order
        (``indy_plenum_tpu/chaos/report.py:103``): equal to the
        reference's command after the program name. It names no device,
        so it replays on the card."""
        cmd = (f"python -m indy_plenum_tpu_torch.tools.chaos_run "
               f"--seed {self.seed} "
               f"--scenario {self.scenario} --nodes {self.n_nodes}")
        mode = self.dispatch_mode
        if mode.get("device_quorum"):
            cmd += " --device-quorum"
        if mode.get("tick"):
            cmd += f" --tick {mode['tick']}"
        if mode.get("adaptive"):
            cmd += " --adaptive-tick"
        if mode.get("mesh"):
            cmd += f" --mesh {mode['mesh']}"
        if mode.get("resident"):
            cmd += f" --resident-depth {mode['resident']}"
        if mode.get("trace"):
            cmd += " --trace"
        if mode.get("lanes"):
            cmd += f" --lanes {mode['lanes']}"
        return cmd

    def as_dict(self) -> Dict[str, Any]:
        return {
            "scenario": self.scenario,
            "seed": self.seed,
            "n_nodes": self.n_nodes,
            "replay_command": self.replay_command,
            "dispatch_mode": dict(self.dispatch_mode),
            "verdict_as_expected": self.verdict_as_expected,
            "invariants": self.invariants,
            "expected_failures": list(self.expected_failures),
            "byzantine_nodes": list(self.byzantine_nodes),
            "plan": self.plan,
            "trace": [[t, e] for t, e in self.trace],
            "network": self.network,
            "metrics": self.metrics,
            "ordered_per_node": self.ordered_per_node,
            "ordered_hash_per_node": self.ordered_hash_per_node,
            "monitor_per_node": self.monitor_per_node,
            "catchup": self.catchup,
            "periodic_checks": self.periodic_checks,
            "first_violation": (list(self.first_violation)
                                if self.first_violation else None),
            "virtual_seconds": self.virtual_seconds,
            "trace_hash": self.trace_hash,
            "trace_file": self.trace_file,
            "flight_recorder": self.flight_recorder,
            "journeys": self.journeys,
            "lanes": self.lanes,
            "edge": self.edge,
        }

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.as_dict(), indent=indent, sort_keys=False)

    def save(self, path: str) -> str:
        with open(path, "w") as fh:
            fh.write(self.to_json() + "\n")
        return path

    def summary_lines(self) -> List[str]:
        lines = [f"scenario={self.scenario} seed={self.seed} "
                 f"nodes={self.n_nodes} "
                 f"virtual={self.virtual_seconds:.0f}s"]
        for r in self.invariants:
            mark = "PASS" if r["verdict"] == "PASS" else "FAIL"
            lines.append(f"  [{mark}] {r['name']}: {r['detail']}")
        net = self.network
        lines.append(
            f"  network: sent={net.get('sent')} "
            f"dropped={net.get('dropped')} "
            f"duplicated={net.get('duplicated')}")
        if self.first_violation is not None:
            t, what = self.first_violation
            lines.append(f"  first violation at t={t:.2f}: {what}")
        if self.catchup:
            lines.append(
                f"  catchup: rounds={self.catchup.get('rounds')} "
                f"txns_leeched={self.catchup.get('txns_leeched')} "
                f"proofs_verified={self.catchup.get('proofs_verified')} "
                f"reps_rejected={self.catchup.get('reps_rejected')} "
                f"retries={self.catchup.get('retries')}")
            pr = self.catchup.get("proof_read")
            if pr:
                lines.append(
                    f"  proof read: node={pr.get('node')} "
                    f"index={pr.get('index')} window={pr.get('window')} "
                    f"verified={pr.get('verified')}")
        if self.journeys:
            j = self.journeys
            e2e = (j.get("e2e") or {}).get("write") or {}
            lines.append(
                f"  journeys: {j.get('complete')}/{j.get('count')} "
                f"complete (orphans={j.get('orphan_spans')}, "
                f"via_catchup={j.get('catchup_journeys')}) "
                f"e2e p50={e2e.get('p50')} p99={e2e.get('p99')} "
                f"hash={str(j.get('journey_hash'))[:16]}…")
            fw = j.get("fault_window")
            if fw:
                lines.append(
                    f"  fault cost: {fw['through_fault']['count']} "
                    f"journeys crossed a fault window "
                    f"(p50 {fw['through_fault']['p50']} vs "
                    f"{fw['clear']['p50']} clear; "
                    f"p50_cost={fw['p50_cost']})")
        if self.lanes:
            ln = self.lanes
            barrier = ln.get("barrier") or {}
            lines.append(
                f"  lanes: {ln.get('count')} "
                f"router={ln.get('router', {}).get('distribution')} "
                f"sealed_window={barrier.get('sealed_window')} "
                f"seal_fp={str(barrier.get('seal_fingerprint'))[:16]}…")
        if self.edge:
            poisoned = self.edge.get("poisoned") or {}
            honest = self.edge.get("honest") or {}
            lines.append(
                f"  edge: tampered={poisoned.get('tampered')} "
                f"caught={poisoned.get('caught')} "
                f"fallbacks={poisoned.get('origin_fallbacks')} "
                f"honest_verified={honest.get('verified')}/"
                f"{honest.get('served')}")
        if self.trace_hash is not None:
            dumped = ", ".join(sorted({d.get("reason", "?")
                                       for d in self.flight_recorder})) \
                or "none"
            lines.append(f"  trace: hash={self.trace_hash[:16]}… "
                         f"file={self.trace_file} flight_dumps={dumped}")
        lines.append(f"  replay: {self.replay_command}")
        return lines
