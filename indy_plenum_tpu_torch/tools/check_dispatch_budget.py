"""Dispatch-budget gate: fail if the tick barrier stops amortizing.

Runs a short deterministic ``SimPool`` round through the tick-batched
dispatch plane and computes ``device_dispatches_per_ordered_batch`` (and
dispatches per delivered message). Exit status 1 if either exceeds its
budget — callable from the bench loop, chaos runs, or CI, so a regression
that quietly reverts to per-message flushing turns red instead of slow.

Governor gates: unless ``--no-governor-gates``, the script ALSO
runs a bursty profile (burst → trickle → burst — the load shape the
adaptive tick exists for) twice, static vs adaptive, and fails if

- the adaptive run's steady-state ``device.flush_occupancy`` falls below
  ``--occupancy-floor`` (the governor must keep scatters usefully full),
- the adaptive run regresses ``device_dispatches_per_ordered_batch``
  beyond ``--adaptive-tolerance`` of the static-tick run, or
- the adaptive run orders fewer txns per *sim* second than the static
  run allows after ``--adaptive-tolerance`` slack (the governor must not
  trade dispatches for protocol-time throughput).

Sharded gate: unless ``--no-sharded-gate``, the script runs the
n=16/k=6 workload twice on the SAME seed — once on one device, once with
the grouped vote plane mesh-sharded over ``--mesh-devices`` tiles
— and fails if the ordered digests diverge (sharding is a placement
choice, never a semantics change), if the mesh run's
``device_dispatches_per_ordered_batch`` drifts beyond
``--sharded-tolerance`` of the 1-device run, or if its flush occupancy
falls below the floor.

Tracing gate: unless ``--no-trace-gate``, the script runs the
n=16/k=6 workload twice on the SAME seed — flight recorder disabled vs
enabled — and fails if the ordered digests diverge (observability must
never perturb consensus) or the traced run's ordered/sim-second falls
more than ``--trace-tolerance`` below the untraced run. The wall-clock
ratio is recorded alongside, so the recorder can never silently tax the
hot path.

Ingress gate: unless ``--no-ingress-gate``, the script drives the
seeded open-loop workload generator at n=16/k=6 through the SIGNED auth
path twice — unsaturated vs well beyond the bounded admission queue's
drain rate — and fails if overload grows the queue past capacity, if the
shed set / ordering are not byte-identical across two identical
saturated runs, if the unsaturated baseline sheds at all, or if
ordered/sim-second under saturation collapses more than
``--ingress-tolerance`` below the unsaturated run (admission exists to
protect goodput, not to trade it away).

Proof gate: unless ``--no-proof-gate``, the script runs the same
seeded real-execution BLS pool twice — once idle, once serving
proof-attached reads through the state-proof plane — and fails if the
ordered digests diverge (reads never perturb consensus), if serving
cache-hit reads performed ANY pairing work (the serve path must be a
dict lookup), if any reply fails client-side end-to-end verification
(``verify_proved_read`` with only the pool's BLS keys), or if the
batched multi-sig verifier falls below 2x the per-root path at batch 64
(the whole point of batching pairings across roots/windows).

Catchup gate: unless ``--no-catchup-gate``, the script runs the
seeded GC-crossing crash/restart chaos scenario (a node crashes, >= 2
checkpoint windows stabilize and garbage-collect in its absence, it
restarts and leeches the gap back) and fails if any chaos verdict fails,
if the caught-up node's committed-ledger hash is not bit-identical to
the survivors', if the run does not replay byte-identically
(``trace_hash``) from its seed, if the freshly-caught-up node's
proof-attached read fails ``verify_proved_read``, or if the
byzantine-seeder scenario's corrupted CATCHUP_REPs were not rejected by
proof verification. Catchup throughput is recorded in the gate output.

Fabric gate: unless ``--no-fabric-gate``, the script runs the
n=16/k=6 workload on the 2-axis member x validator fabric (half the
sharded gate's devices on each axis) and compares it against the 1-axis
mesh run on the SAME seed — ``ordered_hash`` must match bit-for-bit and
dispatches/ordered-batch + bytes/readback must sit within
``--fabric-tolerance`` (the psum quorum reduction and per-shard
pipelined readbacks may move work between chips, never change or
inflate it).

Latency gate: unless ``--no-latency-gate``, the script runs the
n=16/k=6 workload traced TWICE on the SAME seed and fails if the causal
journey tables (observability.causal) are not byte-identical
(``journey_hash``), if any ordered request's journey is incomplete
(orphan spans — every ingress must join a finalisation, batch, ordering
and execution across the pool), if the traced ordered digests diverge
from the untraced run, or if e2e p99 (client ingress -> executed,
virtual protocol time) exceeds ``--e2e-budget``.

Lanes gate: unless ``--no-lanes-gate``, the script runs the
same routed workload through 1 and 4 ordering lanes (n=4 per lane,
tiny checkpoint windows so the cross-lane barrier seals continuously)
and fails unless the 4-lane arm's ordered/sim-second clears the
``--lanes-speedup-floor`` (3.0x), a 4-lane replay is byte-identical
(per-lane ordered hashes, the sealed-window fingerprint chain tip, the
journey table), no journey is orphaned, and every journey names its
lane and carries the barrier hop. The latency gate additionally
asserts per-lane e2e p99 at 4 lanes.

Static gate: unless ``--no-static-gate``, the pure-AST
determinism & hot-path analyzer (``indy_plenum_tpu_torch.analysis``)
runs over the whole port package TWICE and fails if any unsuppressed
finding remains (the shipped baseline is empty — new wall-clock reads,
unseeded RNGs, unordered fingerprint iterations, unguarded hot-path trace
args,
stray device syncs, aliased pinned staging hand-offs or
orphan/unknown config knobs fail closed) or if ``findings_hash`` drifts
between the two runs (the analyzer obeys the same byte-identical replay
contract it enforces).

State gate: unless ``--no-state-gate``, the batched state-commit
plane proves itself at state scale — identical per-window write sets
driven through sequential ``set()``, batched-host and batched-auto arms
on a 100k-key SMT produce bit-identical per-window roots, the batched
walk performs <= 1/3 the hashes per commit of the sequential loop at
delta=256 (``--state-hash-floor``), and the virtual-time soak arm (a
diurnal workload profile on a real-execution pool across a simulated
multi-hour horizon) holds a flat bounded-structure memory high-water,
<5% ordered-throughput drift first-vs-last simulated hour
(``--state-drift-tolerance``), byte-identical across two same-seed runs.

Geo gate: unless ``--no-geo-gate``, the planet-scale read
fabric proves itself on a 3-region pool — the edge arm serves
>= ``--geo-hit-floor`` (default 90%) of a region-spread read storm
from region-local edge proof caches at intra-band p99 while the
same-seed no-edge arm pays the WAN band for non-home regions, the edge
serve path performs ZERO pairing checks (clients amortize one full
multi-sig verify per trusted window and bind every later reply to it
offline), every reply in both arms passes client verification,
ordered/journey/shed fingerprints stay bit-identical between arms (the
fabric models latency on a dedicated seeded RNG — it never touches the
pool's RNG or timer), and two same-seed edge runs produce
byte-identical records.

Residency gate: unless ``--no-residency-gate``, the script runs
the n=16/k=6 workload per-tick vs with multi-tick device residency
(``--residency-depth`` ring slots, votes accumulating on device across
ticks before one fused consume) and fails if the ordered digests
diverge, if the resident arm spends more than
``--residency-dispatch-budget`` (1.0) device dispatches per ordered
batch or never defers a readback, or if ordered/sim-second regresses
beyond ``--residency-tolerance``. It also proves the occupancy-driven
rebalance law: a synthetic 8:1 hot member block over threshold 2.0
must plan a rotation whose predicted hottest block drops below the
threshold, and a forced mid-run plane migration on the 4-way member
mesh (executed at a checkpoint-boundary barrier) must keep the ordered
digests bit-identical to the never-rebalanced arm.

Soak gate: unless ``--no-soak-gate``, the script runs the
virtual-day soak (simulation/soak.py) — 24 simulated diurnal hours on a
real-execution pool with ONE chaos arc (a GC-crossing crash + catchup
at hour 6, a view change at hour 12, and a forced shard rebalance) —
twice on one seed, and fails if resource high-water is not flat after
hour 1, hour-1 vs hour-24 ordered throughput drifts >= ``--soak-drift-tolerance`` (1%), any telemetry
anomaly is unexplained by the chaos windows, any declared bound is
violated, the runs are not byte-identical, or a short arm with a
planted leaking resource does NOT trip the leak law (non-vacuity).

Running one gate: ``--only latency`` (or ``--only trace,latency``)
replaces stacking nine ``--no-*-gate`` flags; ``--list-gates`` prints
the names.

Usage (``TOOL`` is ``indy_plenum_tpu_torch.tools.check_dispatch_budget``):
    python -m TOOL                # defaults
    python -m TOOL --only latency
    python -m TOOL --nodes 16 --instances 6 --budget-per-batch 40 --json
    python -m TOOL --only latency --json --device cpu

Twin of ``scripts/check_dispatch_budget.py`` over the port: the same 17
gates (the dispatch budget and the ``GATES``), the same flags, defaults,
budgets, floors and tolerances, the same order in ``main`` and the same
reuse of arms between gates, plus ``--device``. Every pool's kernels run
on the CUDA card unless ``--device cpu`` asks for their plain versions;
without a card and without ``--device cpu`` it exits non-zero before it
builds a pool. No gate retries anything on the CPU.

Where the reference provisions XLA host devices before it imports JAX
(its sharded, fabric, residency and soak gates need a multi-device
mesh), the twin builds each mesh's tiles on the one device
(``make_fabric_mesh([device] * tiles, shape)``): ``--mesh-devices`` is a
tile count and nothing counts devices. The day soak (``simulation/
soak.py``) always takes the reference's ticked arm on a (4,) fabric, the
branch the reference takes with >= 4 XLA devices (which its default
``--mesh-devices 4`` provisions): its forced rebalance leg runs on one
card too. The static gate lints the port package with the port's
analyzer, so its ``findings_hash`` is the port's own.

A gate's record equals the reference's on the same flags but for the
fields built from ``time.perf_counter`` (``wall_s``, ``wall_ratio``, the
proof gate's timed verifies and speedup, the state arms' and soaks'
walls, the catchup rate per wall second), the chaos records'
``replay_command`` (which names this package's chaos CLI), and the static
gate's package-dependent counts.
"""
# da: allow-file[nondet-source] -- operator gate harness: its wall reads are the deadlines that bound a stalled run and the wall fields REPORTED beside the seeded, virtual-time verdicts; no wall value feeds a pool, a digest or a fingerprint
import argparse
import json
import os
import sys
import time

from ..common.metrics_collector import MetricsName
from ..config import getConfig
from ..simulation.pool import SimPool


def _submit_bursty(pool, target: int) -> None:
    """Burst → trickle → burst: a third of the load lands at t=0, a third
    trickles one request per 0.25 sim-seconds (sparse ticks — the regime
    the governor widens for), and the rest bursts after the trickle
    (saturation — the regime it narrows for). Deterministic: everything
    rides the pool's virtual timer."""
    seq = [0]

    def submit(count: int) -> None:
        for _ in range(count):
            pool.submit_request(seq[0])
            seq[0] += 1

    burst = max(1, target // 3)
    trickle = max(0, target - 2 * burst)
    submit(burst)
    for i in range(trickle):
        pool.timer.schedule(2.0 + i * 0.25, lambda: submit(1))
    pool.timer.schedule(2.0 + trickle * 0.25 + 2.0,
                        lambda: submit(target - burst - trickle))


def measure(n_nodes: int, instances: int, batches: int, batch_size: int,
            tick_interval: float, seed: int = 11, adaptive: bool = False,
            bursty: bool = False, mesh=None, trace: bool = False,
            host_eval: bool = False, resident_depth: int = 0,
            overrides: "dict | None" = None, device=None) -> dict:
    """DELIBERATELY a cold run, unlike profile_rbft's warm-up-excluded
    measurement: the gate counts every dispatch from pool construction on
    (cold-start/compile steps included), because the budget protects the
    whole loop's dispatch discipline, not the steady-state ratio. Budgets
    are calibrated with ~10x headroom over the cold numbers.
    ``resident_depth`` > 1 arms multi-tick device residency;
    ``overrides`` layers extra config knobs (the residency gate forces a
    rebalance with it) on top of the gate's shape. ``device`` runs the
    pool's kernels: the card unless ``"cpu"``."""
    knobs = {
        "Max3PCBatchSize": batch_size,
        "Max3PCBatchWait": 0.05,
        "QuorumTickInterval": tick_interval,
        "QuorumTickAdaptive": adaptive,
    }
    if resident_depth > 1:
        knobs["ResidentTickDepth"] = resident_depth
    if overrides:
        knobs.update(overrides)
    config = getConfig(knobs)
    pool = SimPool(n_nodes=n_nodes, seed=seed, config=config,
                   device_quorum=True, shadow_check=False,
                   num_instances=instances, mesh=mesh, trace=trace,
                   host_eval=host_eval,
                   device=device)

    def min_ordered():
        return min(len(nd.ordered_digests) for nd in pool.nodes)

    target = batches * batch_size
    sim_t0 = pool.timer.get_current_time()
    wall_t0 = time.perf_counter()
    if bursty:
        _submit_bursty(pool, target)
    else:
        for i in range(target):
            pool.submit_request(i)
    deadline = time.monotonic() + 240
    while min_ordered() < target and time.monotonic() < deadline:
        pool.run_for(0.5)
    assert min_ordered() >= target, f"stalled at {min_ordered()}/{target}"
    assert pool.honest_nodes_agree()
    sim_elapsed = pool.timer.get_current_time() - sim_t0
    wall_elapsed = time.perf_counter() - wall_t0

    dispatches = pool.vote_group.flushes
    delivered = pool.network.sent
    occ = pool.metrics.stat(MetricsName.DEVICE_FLUSH_OCCUPANCY)
    per_tick = pool.metrics.stat(MetricsName.DEVICE_DISPATCHES_PER_TICK)
    result = {
        "n_nodes": n_nodes,
        "instances": instances,
        "adaptive": adaptive,
        "bursty": bursty,
        "txns_ordered": min_ordered(),
        "ordered_batches": batches,
        "device_dispatches": dispatches,
        "delivered_messages": delivered,
        "device_dispatches_per_ordered_batch": round(
            dispatches / batches, 2),
        "device_dispatches_per_delivered_message": round(
            dispatches / delivered, 4) if delivered else 0.0,
        "flush_occupancy_avg": round(occ.avg, 4) if occ else None,
        "dispatches_per_tick_max": per_tick.max if per_tick else None,
        "ordered_per_sim_second": round(target / sim_elapsed, 2)
        if sim_elapsed else None,
        "wall_s": round(wall_elapsed, 2),
        # agreement is asserted above, so one node's ordered-digest hash
        # identifies the whole pool's ordering (the sharded gate compares
        # it against the 1-device run)
        "ordered_hash": pool.ordered_hash(),
        # ordering fast path: what actually crossed the device->host
        # boundary (compact deltas by default, the full event matrix
        # under host_eval) — the readback gate compares the two
        "eval_mode": pool.vote_group.eval_mode,
        "readback_bytes": pool.vote_group.readback_bytes_total,
        "readbacks": pool.vote_group.readbacks,
        "readbacks_overlapped": pool.vote_group.readbacks_overlapped,
    }
    if mesh is not None:
        result["shards"] = pool.vote_group.shards
        result["mesh_shape"] = list(pool.vote_group.mesh_shape)
        result["shard_occupancy"] = pool.vote_group.shard_occupancy
    vg = pool.vote_group
    if vg.resident_depth > 1 or vg.rebalances:
        # multi-tick residency / rebalancing surface: how many host
        # round-trips the ring deferred and where the planes ended up
        result["residency"] = {
            "resident_depth": vg.resident_depth,
            "resident_ticks": vg.resident_ticks,
            "readbacks_deferred": vg.readbacks_deferred,
            "rebalances": vg.rebalances,
            "row_shift": vg.row_shift,
        }
    if pool.governor is not None:
        result["governor"] = pool.governor.trajectory_summary()
    if trace:
        result["trace_events"] = len(pool.trace)
        result["trace_hash"] = pool.trace.trace_hash()
        # causal request journeys (latency gate): counts + completeness
        # + the byte-stable journey table fingerprint + client-observed
        # e2e percentiles with attribution shares
        from ..observability.causal import journey_summary

        js = journey_summary(pool.trace.events())
        result["journeys"] = {
            "count": js["count"],
            "complete": js["complete"],
            "orphan_spans": js["orphan_spans"],
            "journey_hash": js["journey_hash"],
            "e2e": js["e2e"]["write"],
            "attribution_share": js["attribution_share"],
        }
    return result


def governor_gates(args) -> "tuple[dict, list]":
    """Static vs adaptive on the SAME bursty workload and seed; returns
    (record, failures)."""
    static = measure(args.nodes, args.instances, args.batches,
                     args.batch_size, args.tick, seed=args.seed,
                     adaptive=False, bursty=True,
                     device=args.device)
    adaptive = measure(args.nodes, args.instances, args.batches,
                       args.batch_size, args.tick, seed=args.seed,
                       adaptive=True, bursty=True,
                       device=args.device)
    tol = args.adaptive_tolerance
    failures = []
    occ = adaptive["flush_occupancy_avg"] or 0.0
    if occ < args.occupancy_floor:
        failures.append(
            f"adaptive flush_occupancy {occ} < floor {args.occupancy_floor}")
    s_pb = static["device_dispatches_per_ordered_batch"]
    a_pb = adaptive["device_dispatches_per_ordered_batch"]
    if a_pb > s_pb * (1.0 + tol):
        failures.append(f"adaptive dispatches/batch {a_pb} regresses "
                        f"static {s_pb} beyond {tol:.0%}")
    s_tps = static["ordered_per_sim_second"] or 0.0
    a_tps = adaptive["ordered_per_sim_second"] or 0.0
    if a_tps < s_tps * (1.0 - tol):
        failures.append(f"adaptive ordered/sim-sec {a_tps} regresses "
                        f"static {s_tps} beyond {tol:.0%}")
    record = {
        "static_bursty": static,
        "adaptive_bursty": adaptive,
        "occupancy_floor": args.occupancy_floor,
        "adaptive_tolerance": tol,
        "adaptive_dispatch_ratio": round(a_pb / s_pb, 3) if s_pb else None,
        "adaptive_sim_throughput_ratio": round(a_tps / s_tps, 3)
        if s_tps else None,
    }
    return record, failures


def sharded_gates(args) -> "tuple[dict, list]":
    """1-device vs mesh-sharded on the SAME workload and seed at the
    acceptance shape (n=16, k=6, 4-way host mesh by default); returns
    (record, failures). The digests must be bit-identical and the
    dispatch discipline must survive sharding."""
    from ..tpu.quorum import make_fabric_mesh

    mesh = make_fabric_mesh([args.device] * args.mesh_devices,
                            (args.mesh_devices,))
    single = measure(args.sharded_nodes, args.sharded_instances,
                     args.batches, args.batch_size, args.tick,
                     seed=args.seed,
                     device=args.device)
    sharded = measure(args.sharded_nodes, args.sharded_instances,
                      args.batches, args.batch_size, args.tick,
                      seed=args.seed, mesh=mesh,
                      device=args.device)
    tol = args.sharded_tolerance
    failures = []
    if sharded["ordered_hash"] != single["ordered_hash"]:
        failures.append("sharded ordered digests diverge from the "
                        "1-device run (sharding changed semantics)")
    s_pb = single["device_dispatches_per_ordered_batch"]
    m_pb = sharded["device_dispatches_per_ordered_batch"]
    if s_pb and abs(m_pb - s_pb) > s_pb * tol:
        failures.append(f"sharded dispatches/batch {m_pb} drifts from "
                        f"1-device {s_pb} beyond {tol:.0%}")
    occ = sharded["flush_occupancy_avg"] or 0.0
    if occ < args.occupancy_floor:
        failures.append(
            f"sharded flush_occupancy {occ} < floor {args.occupancy_floor}")
    record = {
        "single_device": single,
        "mesh_sharded": sharded,
        "mesh_devices": args.mesh_devices,
        "sharded_tolerance": tol,
        "digests_match": sharded["ordered_hash"] == single["ordered_hash"],
        "sharded_dispatch_ratio": round(m_pb / s_pb, 3) if s_pb else None,
    }
    return record, failures


def fabric_gate(args, base: "dict | None" = None) -> "tuple[dict, list]":
    """Scale-out quorum fabric gate: the SAME n=16/k=6 workload and seed
    on a 1-axis member mesh vs the 2-axis member x validator fabric
    (both over the sharded gate's device pool). The fabric is a
    PLACEMENT choice: ``ordered_hash`` must match bit-for-bit,
    dispatches/ordered-batch and readback bytes must sit within
    ``--fabric-tolerance`` — the psum quorum reduction and per-shard
    pipelined readbacks may move work, never change or inflate it.
    ``base`` reuses the sharded gate's mesh run (identical arguments)
    as the 1-axis arm instead of re-paying the cold simulation."""
    from ..tpu.quorum import make_fabric_mesh

    devices = [args.device] * args.mesh_devices
    if base is None:
        base = measure(args.sharded_nodes, args.sharded_instances,
                       args.batches, args.batch_size, args.tick,
                       seed=args.seed,
                       mesh=make_fabric_mesh(devices,
                                             (args.mesh_devices,)),
                       device=args.device)
    # the 2-axis grid over the same device pool: members x validators
    m_axis = max(args.mesh_devices // 2, 1)
    two = measure(args.sharded_nodes, args.sharded_instances,
                  args.batches, args.batch_size, args.tick,
                  seed=args.seed,
                  mesh=make_fabric_mesh(devices, (m_axis, 2)),
                  device=args.device)
    tol = args.fabric_tolerance
    failures = []
    if two["ordered_hash"] != base["ordered_hash"]:
        failures.append("2-axis fabric ordered digests diverge from the "
                        "1-axis mesh run (the validator axis changed "
                        "semantics)")
    b_pb = base["device_dispatches_per_ordered_batch"]
    t_pb = two["device_dispatches_per_ordered_batch"]
    if b_pb and abs(t_pb - b_pb) > b_pb * tol:
        failures.append(f"2-axis dispatches/batch {t_pb} drifts from "
                        f"1-axis {b_pb} beyond {tol:.0%}")
    # TOTAL readback bytes, not bytes/readback: per-shard absorbs split
    # the same bytes across as many readbacks as the mesh has member
    # shards, so the per-readback figure legitimately differs between
    # mesh shapes — what must NOT drift is what crossed the link
    b_rb, t_rb = base["readback_bytes"], two["readback_bytes"]
    if b_rb and abs(t_rb - b_rb) > b_rb * tol:
        failures.append(f"2-axis readback bytes {t_rb} drift from "
                        f"1-axis {b_rb} beyond {tol:.0%} (the compact "
                        "blocks should be identical; the validator axis "
                        "must not be fetched twice)")
    record = {
        "one_axis": base,
        "two_axis": two,
        "fabric_tolerance": tol,
        "digests_match": two["ordered_hash"] == base["ordered_hash"],
        "fabric_dispatch_ratio": round(t_pb / b_pb, 3) if b_pb else None,
        "fabric_readback_ratio": round(t_rb / b_rb, 3) if b_rb else None,
    }
    return record, failures


def tracing_gate(args, base: "dict | None" = None) -> "tuple[dict, list]":
    """Flight recorder disabled vs enabled on the SAME n=16/k=6 workload
    and seed; returns (record, failures). Observability must be free in
    protocol time (identical digests, ordered/sim-second within
    ``--trace-tolerance``) — the wall ratio is recorded so host-side
    drift is visible even when the gate passes. ``base`` reuses the
    sharded gate's single-device run (identical arguments) instead of
    paying the cold n=16/k=6 simulation a third time."""
    if base is None:
        base = measure(args.sharded_nodes, args.sharded_instances,
                       args.batches, args.batch_size, args.tick,
                       seed=args.seed,
                       device=args.device)
    traced = measure(args.sharded_nodes, args.sharded_instances,
                     args.batches, args.batch_size, args.tick,
                     seed=args.seed, trace=True,
                     device=args.device)
    tol = args.trace_tolerance
    failures = []
    if traced["ordered_hash"] != base["ordered_hash"]:
        failures.append("traced ordered digests diverge from the "
                        "untraced run (recording perturbed consensus)")
    b_tps = base["ordered_per_sim_second"] or 0.0
    t_tps = traced["ordered_per_sim_second"] or 0.0
    if t_tps < b_tps * (1.0 - tol):
        failures.append(f"traced ordered/sim-sec {t_tps} regresses "
                        f"untraced {b_tps} beyond {tol:.0%}")
    record = {
        "untraced": base,
        "traced": traced,
        "trace_tolerance": tol,
        "digests_match": traced["ordered_hash"] == base["ordered_hash"],
        "sim_throughput_ratio": round(t_tps / b_tps, 4) if b_tps else None,
        "wall_ratio": (round(traced["wall_s"] / base["wall_s"], 3)
                       if base["wall_s"] else None),
    }
    return record, failures


def _measure_saturation(args, rate: float, seed: int) -> dict:
    """One open-loop ingress run at the acceptance shape (n=16/k=6 by
    default): the seeded workload generator drives the SIGNED auth path
    through a bounded admission queue for ``--ingress-duration`` sim
    seconds at ``rate`` arrivals/sim-second, then the pool settles."""
    from ..ingress import WorkloadGenerator, WorkloadSpec

    config = getConfig({
        "Max3PCBatchSize": 40,
        "Max3PCBatchWait": 0.05,
        "QuorumTickInterval": args.tick,
        "QuorumTickAdaptive": True,
        "IngressQueueCapacity": args.ingress_capacity,
    })
    pool = SimPool(n_nodes=args.sharded_nodes, seed=seed, config=config,
                   device_quorum=True, shadow_check=False,
                   num_instances=args.sharded_instances,
                   sign_requests=True,
                   device=args.device)

    def min_ordered():
        return min(len(nd.ordered_digests) for nd in pool.nodes)

    # warm-up OUTSIDE the measured window: a sub-capacity wave orders
    # once, compiling the signed-ingress + vote-plane shapes (a cold
    # XLA compile would otherwise eat the wall deadline and truncate
    # the measurement). Deterministic: ordering progress is a pure
    # function of the seed, so both saturated runs warm identically.
    warm = max(2, args.ingress_capacity // 2)
    for i in range(warm):
        pool.submit_request(10_000_000 + i, client_id="warm")
    deadline = time.monotonic() + 300
    while min_ordered() < warm and time.monotonic() < deadline:
        pool.run_for(0.5)
    assert min_ordered() >= warm, "ingress-gate warm-up stalled"
    warm_ordered = min_ordered()

    seq = [0]

    def on_write(client: int, key: int) -> None:
        seq[0] += 1
        pool.submit_request(seq[0], client_id="c%d" % client)

    gen = WorkloadGenerator(WorkloadSpec(
        n_clients=100_000, rate=rate, duration=args.ingress_duration,
        read_fraction=0.0, n_keys=64, seed=seed))
    gen.start(pool.timer, on_write)

    sim_t0 = pool.timer.get_current_time()
    horizon = args.ingress_duration + 8.0
    elapsed = 0.0
    deadline = time.monotonic() + 300
    while (elapsed < horizon or pool.admission.depth) \
            and time.monotonic() < deadline:
        pool.run_for(0.5)
        elapsed += 0.5
    assert pool.honest_nodes_agree()
    sim_elapsed = pool.timer.get_current_time() - sim_t0
    adm = pool.admission
    ordered = min_ordered() - warm_ordered
    return {
        "rate": rate,
        "arrivals": gen.arrivals,
        "admitted": adm.admitted_total - warm,  # warm-up wave excluded
        "shed": adm.shed_total,
        "peak_queue_depth": adm.peak_depth,
        "capacity": adm.capacity,
        "shed_hash": adm.shed_hash(),
        "ordered": ordered,
        "ordered_per_sim_second": round(ordered / sim_elapsed, 2)
        if sim_elapsed else None,
        "ordered_hash": pool.ordered_hash(),
        "governor": (pool.governor.trajectory_summary()
                     if pool.governor is not None else None),
    }


def readback_gate(args, base: "dict | None" = None) -> "tuple[dict, list]":
    """Ordering fast path gate: device-side quorum eval (compact delta
    readback, the default) vs the ``host_eval`` full-event-matrix
    fallback on the SAME n=16/k=6 workload and seed. The eval mode may
    change WHAT crosses the device->host link, never the ordering:
    digests must be bit-identical, the compact run's bytes/readback must
    sit under ``--readback-budget`` AND well below the matrix run's, and
    ordered/sim-second must not regress beyond ``--readback-tolerance``.
    ``base`` reuses the sharded gate's single-device run (identical
    arguments, device eval) instead of re-paying the cold simulation."""
    if base is None:
        base = measure(args.sharded_nodes, args.sharded_instances,
                       args.batches, args.batch_size, args.tick,
                       seed=args.seed,
                       device=args.device)
    host = measure(args.sharded_nodes, args.sharded_instances,
                   args.batches, args.batch_size, args.tick,
                   seed=args.seed, host_eval=True,
                   device=args.device)
    failures = []
    if base["ordered_hash"] != host["ordered_hash"]:
        failures.append("device-eval ordered digests diverge from the "
                        "host_eval fallback (fast path changed semantics)")
    d_per = (base["readback_bytes"] / base["readbacks"]
             if base["readbacks"] else 0.0)
    h_per = (host["readback_bytes"] / host["readbacks"]
             if host["readbacks"] else 0.0)
    if d_per > args.readback_budget:
        failures.append(f"device-eval readback {d_per:.0f} bytes/readback "
                        f"over budget {args.readback_budget}")
    # the structural claim: compact deltas, not the event matrix — the
    # fast path must read back a small fraction of the fallback's bytes
    if h_per and d_per > h_per * 0.5:
        failures.append(f"device-eval readback {d_per:.0f} bytes is not "
                        f"compact vs the event matrix {h_per:.0f}")
    tol = args.readback_tolerance
    d_tps = base["ordered_per_sim_second"] or 0.0
    h_tps = host["ordered_per_sim_second"] or 0.0
    if d_tps < h_tps * (1.0 - tol):
        failures.append(f"device-eval ordered/sim-sec {d_tps} regresses "
                        f"host_eval {h_tps} beyond {tol:.0%}")
    record = {
        "device_eval": base,
        "host_eval": host,
        "readback_budget": args.readback_budget,
        "readback_tolerance": tol,
        "digests_match": base["ordered_hash"] == host["ordered_hash"],
        "device_bytes_per_readback": round(d_per, 1),
        "host_bytes_per_readback": round(h_per, 1),
        "readback_compression": round(h_per / d_per, 1) if d_per else None,
        "sim_throughput_ratio": round(d_tps / h_tps, 4) if h_tps else None,
    }
    return record, failures


def ingress_gate(args) -> "tuple[dict, list]":
    """Saturation gate (ingress plane): at n=16/k=6, open-loop overload
    must shed DETERMINISTICALLY behind a bounded queue — never grow it
    past capacity — and goodput under saturation must stay within
    ``--ingress-tolerance`` of the unsaturated run (admission exists to
    protect throughput, not to trade it away). Two saturated runs on the
    same seed must produce the byte-identical shed set and ordering."""
    if args.ingress_capacity < 1:
        raise SystemExit(
            "--ingress-capacity must be >= 1 for the ingress gate "
            "(capacity 0 disables admission control entirely; pass "
            "--no-ingress-gate to skip the gate instead)")
    unsat = _measure_saturation(args, args.ingress_unsat_rate,
                                seed=args.seed)
    sat = _measure_saturation(args, args.ingress_rate, seed=args.seed)
    sat2 = _measure_saturation(args, args.ingress_rate, seed=args.seed)
    failures = []
    if unsat["shed"] > 0:
        failures.append(
            f"unsaturated run shed {unsat['shed']} requests "
            "(gate baseline must run below capacity)")
    if sat["shed"] == 0:
        failures.append("saturated run shed nothing (rate "
                        f"{args.ingress_rate} does not overload capacity "
                        f"{args.ingress_capacity})")
    if sat["peak_queue_depth"] > sat["capacity"]:
        failures.append(
            f"queue grew past capacity: peak {sat['peak_queue_depth']} "
            f"> {sat['capacity']}")
    if sat2["shed_hash"] != sat["shed_hash"]:
        failures.append("shed set is not deterministic across identical "
                        "saturated runs")
    if sat2["ordered_hash"] != sat["ordered_hash"]:
        failures.append("ordering diverged across identical saturated "
                        "runs")
    tol = args.ingress_tolerance
    u_tps = unsat["ordered_per_sim_second"] or 0.0
    s_tps = sat["ordered_per_sim_second"] or 0.0
    if s_tps < u_tps * (1.0 - tol):
        failures.append(f"saturated ordered/sim-sec {s_tps} collapsed "
                        f"below unsaturated {u_tps} beyond {tol:.0%}")
    record = {
        "unsaturated": unsat,
        "saturated": sat,
        "ingress_tolerance": tol,
        "shed_deterministic": sat2["shed_hash"] == sat["shed_hash"],
        "ordered_deterministic":
            sat2["ordered_hash"] == sat["ordered_hash"],
        "saturation_throughput_ratio": round(s_tps / u_tps, 3)
        if u_tps else None,
        "shed_fraction": round(
            sat["shed"] / max(sat["arrivals"], 1), 4),
    }
    return record, failures


# the overload gate's flash-crowd arm and its chaos arc: the reference's
# values (``scripts/check_dispatch_budget.py:724-726``, ``:874``). The gate
# reads them here, so a test can hold a smaller arm and arc to the same
# verdicts; the command line always runs these.
OVERLOAD_ARM = {"n_nodes": 6, "capacity": 10, "base_rate": 80.0,
                "duration": 7.0, "flash_at": 2.5, "flash_dur": 1.25,
                "peak": 10.0}
OVERLOAD_CHAOS = "f_crash_catchup_under_saturation"


def _measure_overload(args, retry: bool, seed: int) -> dict:
    """One flash-crowd overload arm at the gate shape (n=6, bounded
    queue, adaptive tick): a sub-saturation base rate with a hard crowd
    spike, open-loop (``retry=False``, shed requests walk away) or
    closed-loop (``retry=True``, every shed re-offers on the seeded
    backoff). Returns the goodput / recovery / fingerprint record the
    overload gate compares."""
    from ..common.metrics_collector import MetricsName
    from ..ingress import (
        WorkloadGenerator,
        WorkloadProfile,
        WorkloadSpec,
    )

    arm = OVERLOAD_ARM
    n_nodes, capacity = arm["n_nodes"], arm["capacity"]
    base_rate, duration = arm["base_rate"], arm["duration"]
    flash_at, flash_dur, peak = (arm["flash_at"], arm["flash_dur"],
                                 arm["peak"])
    config = getConfig({
        "Max3PCBatchSize": 40,
        "Max3PCBatchWait": 0.05,
        "QuorumTickInterval": 0.1,
        "QuorumTickAdaptive": True,
        "IngressQueueCapacity": capacity,
        "IngressRetryMax": 4 if retry else 0,
        "IngressRetryBase": 0.2,
        "IngressRetryBackoffMult": 2.0,
        "IngressRetryBackoffMax": 2.0,
    })
    pool = SimPool(n_nodes=n_nodes, seed=seed, config=config,
                   device_quorum=True, shadow_check=False,
                   sign_requests=True,
                   device=args.device)

    def min_ordered():
        return min(len(nd.ordered_digests) for nd in pool.nodes)

    warm = capacity - 4
    for i in range(warm):
        pool.submit_request(10_000_000 + i, client_id="warm")
    deadline = time.monotonic() + 300
    while min_ordered() < warm and time.monotonic() < deadline:
        pool.run_for(0.5)
    assert min_ordered() >= warm, "overload-gate warm-up stalled"
    ordered0 = min_ordered()

    seq = [0]

    def on_write(client: int, key: int) -> None:
        seq[0] += 1
        pool.submit_request(seq[0], client_id="c%d" % client)

    gen = WorkloadGenerator(WorkloadSpec(
        n_clients=100_000, rate=base_rate, duration=duration,
        read_fraction=0.0, n_keys=64, seed=seed,
        profile=WorkloadProfile(kind="flash", peak=peak,
                                flash_at=flash_at,
                                flash_duration=flash_dur)))
    gen.start(pool.timer, on_write)

    sim_t0 = pool.timer.get_current_time()
    samples = {}
    marks = (1.0, flash_at, flash_at + flash_dur, 5.0, duration)
    elapsed = 0.0
    deadline = time.monotonic() + 600
    while (elapsed < duration + 6.0 or pool.admission.depth
           or (pool.retry is not None and pool.retry.outstanding)) \
            and time.monotonic() < deadline:
        pool.run_for(0.5)
        elapsed += 0.5
        for m in marks:
            if m <= elapsed and m not in samples:
                samples[m] = min_ordered()
    assert pool.honest_nodes_agree()
    sim_elapsed = pool.timer.get_current_time() - sim_t0
    adm = pool.admission
    # a wall-deadline exit can leave late marks unsampled — fill them
    # with the final count so the gate fails on its rate floors instead
    # of a KeyError
    for m in marks:
        samples.setdefault(m, min_ordered())
    pre_rate = (samples[flash_at] - samples[1.0]) / (flash_at - 1.0)
    post_rate = (samples[duration] - samples[5.0]) / (duration - 5.0)
    readmitted = pool.metrics.stat(MetricsName.INGRESS_RETRY_ADMITTED)
    return {
        "retry": bool(retry),
        "arrivals": gen.arrivals,
        "admitted": adm.admitted_total - warm,
        "shed": adm.shed_total,
        "ordered": min_ordered() - ordered0,
        "ordered_per_sim_second": round(
            (min_ordered() - ordered0) / sim_elapsed, 2)
        if sim_elapsed else None,
        "pre_spike_rate": round(pre_rate, 2),
        "post_spike_rate": round(post_rate, 2),
        "recovery_ratio": round(post_rate / pre_rate, 3)
        if pre_rate else None,
        "retry_admitted": int(readmitted.total) if readmitted else 0,
        "reoffers": pool.retry.reoffers_total if pool.retry else 0,
        "retry_exhausted": pool.retry.exhausted_total
        if pool.retry else 0,
        "shed_hash": adm.shed_hash(),
        "retry_hash": pool.retry.retry_hash() if pool.retry else None,
        "ordered_hash": pool.ordered_hash(),
        "governor": (pool.governor.trajectory_summary()
                     if pool.governor is not None else None),
    }


def overload_gate(args) -> "tuple[dict, list]":
    """Overload robustness gate: the closed-loop retry storm
    must degrade GRACEFULLY, never metastably. On the same seeded
    flash-crowd spike:

    1. the spike must actually overload (open arm sheds, retry arm
       re-offers — a gate that never engages the storm is vacuous);
    2. goodput under the retry storm must hold >=
       ``--overload-goodput-floor`` of the open-loop arm (the storm
       compounds offered load; it must not crush throughput);
    3. ordered/sim-sec must RECOVER after the crowd ends — post-spike
       rate within ``--overload-recovery-tolerance`` of pre-spike on
       both arms (a metastable pool never comes back);
    4. two same-seed retry runs must replay byte-identical
       shed/retry/ordered fingerprints;
    5. the ``f_crash_catchup_under_saturation`` chaos scenario (victim
       crashes across GC'd windows while the crowd spikes and clients
       retry) must PASS every verdict — catchup_recovery included —
       with the seeder throttle's deferral meter engaged (the pool kept
       ordering while it fed the leecher) and a byte-identical replay.
    """
    from ..chaos import run_scenario

    open_arm = _measure_overload(args, retry=False, seed=args.seed)
    storm = _measure_overload(args, retry=True, seed=args.seed)
    storm2 = _measure_overload(args, retry=True, seed=args.seed)

    failures = []
    if open_arm["shed"] == 0:
        failures.append("open-loop arm shed nothing — the flash crowd "
                        "never overloaded the queue (gate vacuous)")
    if storm["reoffers"] == 0:
        failures.append("retry arm re-offered nothing — the closed "
                        "loop never engaged (gate vacuous)")
    floor = args.overload_goodput_floor
    ratio = storm["ordered"] / open_arm["ordered"] \
        if open_arm["ordered"] else 0.0
    if ratio < floor:
        failures.append(
            f"retry-storm goodput {storm['ordered']} fell to "
            f"{ratio:.2f}x of the open-loop arm {open_arm['ordered']} "
            f"(floor {floor})")
    tol = args.overload_recovery_tolerance
    for arm, rec in (("open", open_arm), ("retry", storm)):
        if (rec["recovery_ratio"] or 0.0) < 1.0 - tol:
            failures.append(
                f"metastable collapse on the {arm} arm: post-spike "
                f"rate {rec['post_spike_rate']} never recovered to "
                f"pre-spike {rec['pre_spike_rate']} "
                f"(ratio {rec['recovery_ratio']}, tolerance {tol})")
    for key in ("shed_hash", "retry_hash", "ordered_hash"):
        if storm2[key] != storm[key]:
            failures.append(
                f"retry storm is not deterministic: {key} diverged "
                "across identical same-seed runs")

    t0 = time.perf_counter()
    chaos = run_scenario(OVERLOAD_CHAOS,
                         seed=args.seed, device_quorum=True,
                         quorum_tick_interval=0.1,
                         quorum_tick_adaptive=True, trace=True,
                         device=args.device)
    chaos_wall = time.perf_counter() - t0
    replay = run_scenario(OVERLOAD_CHAOS,
                          seed=args.seed, device_quorum=True,
                          quorum_tick_interval=0.1,
                          quorum_tick_adaptive=True, trace=True,
                          device=args.device)
    if not chaos.verdict_as_expected:
        failures.append(
            f"f_crash_catchup_under_saturation verdicts: "
            f"failed={chaos.failed}")
    throttle = chaos.ingress.get("seeder_throttle", {})
    if not throttle.get("deferred"):
        failures.append("seeder throttle never deferred a slice — the "
                        "ordering-protection meter never engaged")
    if not (chaos.ingress.get("retry") or {}).get("reoffers"):
        failures.append("chaos arc saw no closed-loop retries — the "
                        "storm never reached the recovering pool")
    if replay.trace_hash != chaos.trace_hash \
            or replay.ingress.get("shed_hash") \
            != chaos.ingress.get("shed_hash") \
            or replay.ingress.get("retry_hash") \
            != chaos.ingress.get("retry_hash"):
        failures.append("catchup-under-saturation run does not replay "
                        "byte-identically (trace/shed/retry hash)")

    record = {
        "open_loop": open_arm,
        "retry_storm": storm,
        "goodput_floor": floor,
        "goodput_ratio": round(ratio, 3),
        "recovery_tolerance": tol,
        "deterministic": all(storm2[k] == storm[k] for k in
                             ("shed_hash", "retry_hash",
                              "ordered_hash")),
        "chaos": {
            "scenario": "f_crash_catchup_under_saturation",
            "verdicts_pass": chaos.verdict_as_expected,
            "catchup": {k: chaos.catchup.get(k)
                        for k in ("rounds", "txns_leeched",
                                  "proofs_verified")},
            "admission": chaos.ingress.get("admission"),
            "retry": chaos.ingress.get("retry"),
            "seeder_throttle": throttle,
            "replay_identical": replay.trace_hash == chaos.trace_hash,
            "wall_s": round(chaos_wall, 2),
            "replay_command": chaos.replay_command,
        },
    }
    return record, failures


def proof_gate(args) -> "tuple[dict, list]":
    """State-proof plane gate: (1) the SAME seeded real-execution BLS
    pool with and without proof-serving reads must order bit-identical
    digests; (2) serving cache-hit reads must perform ZERO pairing
    checks (``crypto.bls.bls_crypto.PAIRINGS``) — the window's
    aggregation was already paid by consensus; (3) every reply must
    verify end-to-end with only the pool's BLS keys; (4) the batched
    pairing verifier must hold >= ``--proof-speedup-floor`` x the
    per-root path at batch 64."""
    import hashlib as _hashlib

    from ..client.state_proof import verify_proved_read
    from ..crypto.bls.bls_crypto import (
        PAIRINGS,
        BlsCryptoSigner,
        BlsCryptoVerifier,
        BlsKeyPair,
    )
    from ..proofs import verify_multi_sigs_batch

    def run(serve_reads: bool) -> dict:
        config = getConfig({
            "CHK_FREQ": 5, "LOG_SIZE": 15,
            "Max3PCBatchSize": 1, "Max3PCBatchWait": 0.05,
        })
        pool = SimPool(4, seed=args.seed, config=config,
                       real_execution=True, bls=True,
                       device=args.device)
        for i in range(8):
            pool.submit_request(i)
        deadline = time.monotonic() + 240
        while min(len(nd.ordered_digests) for nd in pool.nodes) < 8 \
                and time.monotonic() < deadline:
            pool.run_for(0.5)
        assert pool.honest_nodes_agree()
        out = {"ordered_hash": pool.ordered_hash(),
               "windows_signed":
                   pool.nodes[0].proof_cache.windows_signed}
        if serve_reads:
            rs = pool.make_read_service("node0", mode="host")
            for i in range(32):
                rs.submit(i)
            checks0 = PAIRINGS.checks
            replies = rs.drain()
            out["serve_pairing_checks"] = PAIRINGS.checks - checks0
            pool_keys = {n: pk
                         for n, (kp, pk, pop) in pool.bls_keys.items()}
            out["reads"] = len(replies)
            out["reads_with_proof"] = sum(
                1 for r in replies if r.multi_sig is not None)
            out["reads_client_verified"] = sum(
                1 for r in replies
                if verify_proved_read(r, pool_keys, min_participants=3))
        return out

    idle = run(serve_reads=False)
    serving = run(serve_reads=True)
    failures = []
    if serving["ordered_hash"] != idle["ordered_hash"]:
        failures.append("proof-serving ordered digests diverge from the "
                        "idle run (reads perturbed consensus)")
    if serving["windows_signed"] < 1:
        failures.append("no checkpoint window captured a pool proof "
                        "(the CheckpointStabilized hook is dead)")
    if serving.get("serve_pairing_checks", 0) != 0:
        failures.append(
            f"cache-hit serve path performed "
            f"{serving['serve_pairing_checks']} pairing checks "
            "(must be a dict lookup — zero pairings)")
    if serving.get("reads_with_proof") != serving.get("reads"):
        failures.append(
            f"{serving.get('reads', 0) - serving.get('reads_with_proof', 0)}"
            " replies missing the pool multi-signature")
    if serving.get("reads_client_verified") != serving.get("reads"):
        failures.append("replies failed client-side verify_proved_read")

    # batched vs per-root pairing throughput at batch 64 (synthetic
    # windows: 8 validators, 64 roots — the batching claim is about
    # amortizing pairings ACROSS roots, not about the validator count)
    kps = [BlsKeyPair(_hashlib.sha256(b"proof-gate-%d" % i).digest())
           for i in range(8)]
    pks = [kp.pk_b58 for kp in kps]
    items = []
    for j in range(64):
        msg = b"window-root-%d|%d" % (j, args.seed)
        items.append((BlsCryptoVerifier.aggregate_sigs(
            [BlsCryptoSigner(kp).sign(msg) for kp in kps]), msg, pks))
    # warm both paths (subgroup/apk caches) before timing
    assert BlsCryptoVerifier.verify_multi_sig(*items[0])
    assert all(verify_multi_sigs_batch(items[:2], seed=args.seed))
    t0 = time.perf_counter()
    per_root_ok = [BlsCryptoVerifier.verify_multi_sig(*it)
                   for it in items]
    per_root_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    batched = verify_multi_sigs_batch(items, seed=args.seed)
    batch_s = time.perf_counter() - t0
    assert all(per_root_ok) and all(batched)
    speedup = per_root_s / batch_s if batch_s else 0.0
    if speedup < args.proof_speedup_floor:
        failures.append(
            f"batch-64 verify speedup {speedup:.2f}x below floor "
            f"{args.proof_speedup_floor}x vs the per-root path")
    record = {
        "idle": idle,
        "serving": serving,
        "digests_match": serving["ordered_hash"] == idle["ordered_hash"],
        "per_root_64_s": round(per_root_s, 4),
        "batch_64_s": round(batch_s, 4),
        "batch_speedup": round(speedup, 2),
        "proof_speedup_floor": args.proof_speedup_floor,
    }
    return record, failures


def catchup_gate(args) -> "tuple[dict, list]":
    """Chaos-hardened catchup gate: (1) the seeded GC-crossing
    crash/restart scenario (``f_crash_gc_catchup``: crash, >= 2
    checkpoint windows stabilize AND garbage-collect in the victim's
    absence, restart, full leecher round) must PASS every verdict —
    including ``catchup_recovery`` (each leeched batch audit-proof
    verified, victim participating again) and ``catchup_proof_read``
    (the caught-up node serves a ``verify_proved_read``-able reply from
    the window it just leeched); (2) the caught-up node's
    committed-ledger hash must be bit-identical to every survivor's;
    (3) the run must replay byte-identically (``trace_hash``) from its
    seed; (4) the byzantine-seeder scenario must REJECT corrupted
    CATCHUP_REPs by proof verification (asserted, not assumed) and
    still recover through honest seeders. Catchup throughput lands in
    the gate record."""
    from ..chaos import run_scenario

    t0 = time.perf_counter()
    first = run_scenario("f_crash_gc_catchup", seed=args.seed, trace=True,
                         device=args.device)
    gc_wall = time.perf_counter() - t0
    replay = run_scenario("f_crash_gc_catchup", seed=args.seed, trace=True,
                          device=args.device)
    byz = run_scenario("byzantine_seeder_catchup", seed=args.seed,
                       device=args.device)

    failures = []
    if not first.verdict_as_expected:
        failures.append(
            f"f_crash_gc_catchup verdicts: failed={first.failed} "
            f"expected={first.expected_failures}")
    hashes = first.catchup.get("ledger_hash_per_node", {})
    if len(set(hashes.values())) != 1:
        failures.append(
            "caught-up node's committed ledger diverges from the "
            f"survivors: {hashes}")
    if replay.trace_hash != first.trace_hash:
        failures.append(
            "catchup-bearing run does not replay byte-identically "
            f"(trace_hash {first.trace_hash[:12]} vs "
            f"{replay.trace_hash[:12]})")
    if not first.catchup.get("proof_read", {}).get("verified"):
        failures.append("caught-up node's proof-attached read failed "
                        "verify_proved_read")
    if not byz.verdict_as_expected:
        failures.append(
            f"byzantine_seeder_catchup verdicts: failed={byz.failed}")
    if byz.catchup.get("reps_rejected", 0) < 1:
        failures.append("byzantine seeder's corrupted CATCHUP_REPs were "
                        "never rejected (the corruption was trusted or "
                        "never exercised)")
    record = {
        "scenario": "f_crash_gc_catchup",
        "seed": args.seed,
        "verdicts_pass": first.verdict_as_expected,
        "txns_leeched": first.catchup.get("txns_leeched"),
        "proofs_verified": first.catchup.get("proofs_verified"),
        "retries": first.catchup.get("retries"),
        "ledger_hashes_match": len(set(hashes.values())) == 1,
        "proof_read": first.catchup.get("proof_read"),
        "trace_hash": first.trace_hash,
        "replay_identical": replay.trace_hash == first.trace_hash,
        "wall_s": round(gc_wall, 2),
        # recovery throughput: what the whole seeded arc (detect the
        # gap, agree a target, fetch, device-verify, rejoin) sustained
        "leeched_txns_per_wall_sec": round(
            (first.catchup.get("txns_leeched") or 0) / gc_wall, 1)
        if gc_wall else None,
        "byzantine_seeder": {
            "verdicts_pass": byz.verdict_as_expected,
            "reps_rejected": byz.catchup.get("reps_rejected"),
            "retries": byz.catchup.get("retries"),
        },
        "replay_command": first.replay_command,
    }
    return record, failures


def measure_laned(lanes: int, n_nodes: int, txns_per_lane: int,
                  tick: float, seed: int, device=None) -> dict:
    """One laned measurement (ordering lanes): K full
    ordering lanes (per-lane vote plane groups, one shared tick,
    adaptive governor) under the cross-lane checkpoint barrier with
    tiny windows, traced, routed client traffic, then a seal flush so
    every journey's window seals. Throughput is ordered txns per SIM
    second — the protocol-time rate the lanes add up to."""
    from ..lanes import LanedPool
    from ..observability.causal import journey_summary

    config = getConfig({
        "Max3PCBatchSize": 5,
        "Max3PCBatchWait": 0.05,
        "CHK_FREQ": 2,
        "LOG_SIZE": 6,
        "QuorumTickInterval": tick,
        "QuorumTickAdaptive": True,
    })
    pool = LanedPool(lanes=lanes, n_nodes=n_nodes, seed=seed,
                     config=config, device_quorum=True, trace=True,
                     device=device)
    total = txns_per_lane * lanes
    sim_t0 = pool.timer.get_current_time()
    for i in range(total):
        pool.submit_request(i)
    deadline = time.monotonic() + 240
    while pool.ordered_total() < total and time.monotonic() < deadline:
        pool.run_for(0.5)
    assert pool.ordered_total() >= total, \
        f"laned run stalled at {pool.ordered_total()}/{total}"
    assert pool.honest_nodes_agree()
    sim_elapsed = pool.timer.get_current_time() - sim_t0
    pads = pool.seal_flush()
    js = journey_summary(pool.trace.events())
    lanes_js = js.get("lanes") or {}
    return {
        "lanes": lanes,
        "n_per_lane": n_nodes,
        "txns_ordered": total,
        "ordered_per_sim_second": round(total / sim_elapsed, 2),
        "sim_elapsed": round(sim_elapsed, 3),
        "router_distribution": list(pool.router.distribution),
        "ordered_hash_per_lane": pool.ordered_hashes(),
        "sealed_window": pool.barrier.sealed_window,
        "sealed_fingerprint": pool.sealed_fingerprint,
        "seal_pads": pads,
        "journey_hash": js["journey_hash"],
        "journeys_count": js["count"],
        "journeys_complete": js["complete"],
        "orphan_spans": js["orphan_spans"],
        "with_lane": lanes_js.get("with_lane", 0),
        "with_barrier_hop": lanes_js.get("with_barrier_hop", 0),
        "e2e_per_lane": lanes_js.get("e2e_per_lane") or {},
    }


def lanes_gate(args) -> "tuple[dict, list]":
    """Multi-lane ordering gate: on the SAME seed,

    1. the 4-lane arm's ordered/sim-second must be at least
       ``--lanes-speedup-floor`` (3.0) times the 1-lane arm's — the
       write path scales horizontally, barrier included;
    2. a 4-lane replay must be BYTE-IDENTICAL: per-lane
       ``ordered_hash``es, the sealed-window fingerprint chain tip, and
       the journey table fingerprint;
    3. zero orphan journeys, and EVERY journey names its lane and
       carries the cross-lane barrier hop (seal coverage is total after
       the seal flush).
    """
    one = measure_laned(1, args.lanes_nodes, args.lanes_txns,
                        args.tick, seed=args.seed,
                        device=args.device)
    four = measure_laned(4, args.lanes_nodes, args.lanes_txns,
                         args.tick, seed=args.seed,
                         device=args.device)
    replay = measure_laned(4, args.lanes_nodes, args.lanes_txns,
                           args.tick, seed=args.seed,
                           device=args.device)
    failures = []
    speedup = (four["ordered_per_sim_second"]
               / one["ordered_per_sim_second"])
    if speedup < args.lanes_speedup_floor:
        failures.append(
            f"4-lane ordered/sim-sec speedup {speedup:.2f} below the "
            f"{args.lanes_speedup_floor}x floor "
            f"({four['ordered_per_sim_second']} vs "
            f"{one['ordered_per_sim_second']})")
    if replay["ordered_hash_per_lane"] != four["ordered_hash_per_lane"]:
        failures.append("per-lane ordered hashes diverge across "
                        "identical seeded 4-lane runs")
    if replay["sealed_fingerprint"] != four["sealed_fingerprint"]:
        failures.append("sealed-window fingerprint diverges across "
                        "identical seeded 4-lane runs")
    if replay["journey_hash"] != four["journey_hash"]:
        failures.append("laned journey tables diverge across identical "
                        "seeded 4-lane runs")
    for arm, label in ((one, "1-lane"), (four, "4-lane")):
        if arm["orphan_spans"] > 0 \
                or arm["journeys_complete"] != arm["journeys_count"]:
            failures.append(
                f"{label}: {arm['orphan_spans']} orphan journeys "
                f"({arm['journeys_complete']}/{arm['journeys_count']} "
                f"complete)")
        if arm["with_lane"] != arm["journeys_count"]:
            failures.append(
                f"{label}: only {arm['with_lane']} of "
                f"{arm['journeys_count']} journeys name their lane")
        if arm["with_barrier_hop"] != arm["journeys_count"]:
            failures.append(
                f"{label}: only {arm['with_barrier_hop']} of "
                f"{arm['journeys_count']} journeys carry the barrier "
                f"hop")
    record = {
        "one_lane": one,
        "four_lane": four,
        "replay_identical": (
            replay["ordered_hash_per_lane"]
            == four["ordered_hash_per_lane"]
            and replay["sealed_fingerprint"] == four["sealed_fingerprint"]
            and replay["journey_hash"] == four["journey_hash"]),
        "speedup_4_lanes": round(speedup, 3),
        "speedup_floor": args.lanes_speedup_floor,
    }
    return record, failures


def latency_gate(args, traced: "dict | None" = None,
                 base: "dict | None" = None,
                 laned: "dict | None" = None) -> "tuple[dict, list]":
    """End-to-end latency gate (causal tracing plane): on the
    SAME n=16/k=6 workload and seed,

    1. two traced runs must produce BYTE-IDENTICAL journey tables
       (``journey_hash``) — the causal plane is deterministic like
       everything else in this repo;
    2. 100% of ordered requests must yield COMPLETE journeys (no orphan
       spans: every ingress joins a finalisation, a batch, an ordering
       and an execution across the pool);
    3. the traced run's ordered digests must match the untraced run's
       bit-for-bit (tracing never perturbs consensus — shared with the
       tracing gate, re-asserted here because this gate can run alone
       via ``--only latency``);
    4. e2e p99 (client ingress -> executed, VIRTUAL protocol time) is
       recorded against ``--e2e-budget`` and fails the gate when over;
    5. (journeys phase 2) at 4 ordering lanes: zero orphan
       journeys and EVERY lane's e2e p99 within the same budget.

    ``traced``/``base`` reuse the tracing gate's runs and ``laned``
    the lanes gate's 4-lane arm (identical arguments) so the default
    full-script invocation pays only ONE extra traced run (the
    byte-identity replay)."""
    if laned is None:
        laned = measure_laned(4, args.lanes_nodes, args.lanes_txns,
                              args.tick, seed=args.seed,
                              device=args.device)
    if traced is None:
        traced = measure(args.sharded_nodes, args.sharded_instances,
                         args.batches, args.batch_size, args.tick,
                         seed=args.seed, trace=True,
                         device=args.device)
    replay = measure(args.sharded_nodes, args.sharded_instances,
                     args.batches, args.batch_size, args.tick,
                     seed=args.seed, trace=True,
                     device=args.device)
    if base is None:
        base = measure(args.sharded_nodes, args.sharded_instances,
                       args.batches, args.batch_size, args.tick,
                       seed=args.seed,
                       device=args.device)
    failures = []
    j, j2 = traced["journeys"], replay["journeys"]
    if j["journey_hash"] != j2["journey_hash"]:
        failures.append(
            "journey tables diverge across identical seeded runs "
            f"({j['journey_hash'][:12]} vs {j2['journey_hash'][:12]})")
    if j["orphan_spans"] > 0 or j["complete"] != j["count"]:
        failures.append(
            f"{j['orphan_spans']} ordered requests left orphan spans "
            f"({j['complete']}/{j['count']} journeys complete)")
    if j["count"] < traced["txns_ordered"]:
        failures.append(
            f"journey table covers {j['count']} of "
            f"{traced['txns_ordered']} ordered requests")
    if traced["ordered_hash"] != base["ordered_hash"]:
        failures.append("traced ordered digests diverge from the "
                        "untraced run (journey marks perturbed "
                        "consensus)")
    p99 = j["e2e"]["p99"]
    if p99 > args.e2e_budget:
        failures.append(f"e2e p99 {p99} sim-seconds over budget "
                        f"{args.e2e_budget}")
    # journeys phase 2 (ordering lanes): at 4 lanes, zero orphans and
    # per-lane e2e p99 inside the same budget
    if laned["orphan_spans"] > 0 \
            or laned["journeys_complete"] != laned["journeys_count"]:
        failures.append(
            f"4-lane run left {laned['orphan_spans']} orphan journeys "
            f"({laned['journeys_complete']}/{laned['journeys_count']} "
            f"complete)")
    lane_p99 = {lane: block["p99"]
                for lane, block in sorted(laned["e2e_per_lane"].items())}
    for lane, value in lane_p99.items():
        if value > args.e2e_budget:
            failures.append(
                f"lane {lane} e2e p99 {value} sim-seconds over budget "
                f"{args.e2e_budget}")
    record = {
        "traced": traced,
        "replay_journey_hash": j2["journey_hash"],
        "journeys_deterministic":
            j["journey_hash"] == j2["journey_hash"],
        "digests_match": traced["ordered_hash"] == base["ordered_hash"],
        "e2e": j["e2e"],
        "e2e_budget": args.e2e_budget,
        "attribution_share": j["attribution_share"],
        "laned_e2e_p99_per_lane": lane_p99,
        "laned_orphan_spans": laned["orphan_spans"],
    }
    return record, failures


def static_gate(args) -> "tuple[dict, list]":
    """Determinism & hot-path hygiene gate (static analysis plane): the
    pure-AST analyzer runs over ``indy_plenum_tpu_torch/`` TWICE on the SAME
    rule catalog and fails if

    1. any UNSUPPRESSED finding remains — the shipped baseline is
       empty, so a new nondeterminism source / fingerprint-ordering
       hazard / unguarded trace arg / stray device sync / staging-
       buffer alias / config-knob orphan fails closed the moment it is
       committed, whether or not a dynamic gate's seeds exercise it;
    2. any pragma suppressing a finding lacks a justification (the
       ``pragma`` rule fires, which is itself unsuppressed);
    3. ``findings_hash`` is not byte-identical across the two runs —
       the analyzer obeys the replay contract it enforces.
    """
    from collections import Counter

    from ..analysis import analyze_paths

    pkg = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    first = analyze_paths([pkg])
    replay = analyze_paths([pkg])
    failures = []
    if first.unsuppressed:
        head = "; ".join(f.render() for f in first.unsuppressed[:5])
        failures.append(
            f"{len(first.unsuppressed)} unsuppressed static finding(s) "
            f"(run python -m indy_plenum_tpu_torch.analysis for the "
            f"list): {head}")
    if replay.findings_hash != first.findings_hash:
        failures.append(
            "static findings_hash drifts across identical runs "
            f"({first.findings_hash[:12]} vs "
            f"{replay.findings_hash[:12]}) — the analyzer itself is "
            "nondeterministic")
    by_rule = Counter(f.rule for f in first.findings)
    record = {
        "files_analyzed": first.files_analyzed,
        "rules": first.rules,
        "findings_total": len(first.findings),
        "unsuppressed": len(first.unsuppressed),
        "suppressed": len(first.suppressed),
        "by_rule": {k: by_rule[k] for k in sorted(by_rule)},
        "findings_hash": first.findings_hash,
        "replay_identical": replay.findings_hash == first.findings_hash,
    }
    return record, failures


def state_gate(args) -> "tuple[dict, list]":
    """State-commit plane gate (state/sparse_merkle_state.py): the
    batched one-walk commit must be a pure optimization —

    1. identical per-window write sets driven through the sequential
       ``set()`` loop, batched host waves and batched ``mode='auto'``
       waves produce BIT-IDENTICAL per-window state roots (the replica-
       agreement invariant: placement and batching move nanoseconds,
       never a root);
    2. at delta=256 on a 100k-key SMT under the hot-key write law the
       batched walk performs <= 1/3 the hashes per commit of the
       sequential loop (the O(delta) claim, measured);
    3. the virtual-time soak holds: a diurnal profile driving a real-
       execution pool across a simulated multi-hour horizon shows a flat
       bounded-structure memory high-water, <``--state-drift-tolerance``
       ordered-throughput drift first-vs-last simulated hour, and two
       same-seed runs byte-identical.
    """
    from ..simulation.state_commit_bench import (
        run_commit_arms,
        run_state_soak,
    )

    failures = []
    try:
        arms = run_commit_arms(n_keys=args.state_keys,
                               delta=args.state_delta,
                               windows=args.state_windows,
                               device=args.device)
    except AssertionError as ex:
        return {"arms_error": str(ex)}, [f"state arms: {ex}"]
    if not arms["roots_identical"]:
        failures.append("state roots diverged across commit arms")
    reduction = arms.get("hash_reduction", 0.0)
    if reduction < args.state_hash_floor:
        failures.append(
            f"state batched hashes/commit reduction {reduction}x "
            f"< {args.state_hash_floor}x floor (delta={args.state_delta} "
            f"on {args.state_keys} keys)")
    soak = run_state_soak(hours=args.state_soak_hours,
                          device=args.device)
    if not soak["deterministic"]:
        failures.append("state soak: same-seed runs not byte-identical")
    if not soak["agree"]:
        failures.append("state soak: honest nodes diverged")
    if not soak["flat_high_water"]:
        failures.append(
            "state soak: bounded-structure high-water grew "
            f"(first hour {soak['first_hour_high_water']} -> last hour "
            f"{soak['last_hour_high_water']})")
    if soak["throughput_drift"] >= args.state_drift_tolerance:
        failures.append(
            f"state soak: ordered-throughput drift "
            f"{soak['throughput_drift']:.1%} >= "
            f"{args.state_drift_tolerance:.0%} first-vs-last hour")
    record = {
        "hash_reduction": reduction,
        "hash_floor": args.state_hash_floor,
        "roots_identical": arms["roots_identical"],
        "final_root": arms["final_root"],
        "arms": arms["arms"],
        "populate_s": arms["populate_s"],
        "n_keys": arms["n_keys"],
        "delta": arms["delta"],
        "windows": arms["windows"],
        "soak": {k: soak[k] for k in (
            "hours", "arrivals", "ordered_total", "hourly_ordered",
            "throughput_drift", "flat_high_water",
            "first_hour_high_water", "last_hour_high_water",
            "cache_hit_rate", "hashes_total", "deterministic", "agree",
            "fingerprint", "wall_s")},
    }
    return record, failures


def geo_gate(args) -> "tuple[dict, list]":
    """Planet-scale read fabric gate: a 3-region seeded pool serves a
    region-spread read storm twice on the same seed — once through
    region-local edge proof caches, once with every read paying the WAN
    trip to the origin validator. Passes when (1) the edge arm serves
    >= ``--geo-hit-floor`` of reads region-locally at intra-band p99
    while the no-edge arm's non-home regions pay the WAN band; (2) the
    edge serve path performs ZERO pairing checks (clients amortize one
    full verify per trusted window); (3) every reply in BOTH arms
    passes offline client verification; (4) ordered/journey/shed
    fingerprints are bit-identical between arms (the fabric never
    touches the pool's RNG or timer); (5) two same-seed edge runs
    produce byte-identical records."""
    from ..observability.causal import journey_summary
    from ..proofs.edge_cache import (
        EdgeProofCache,
        GeoReadFabric,
    )

    def run(use_edges: bool) -> dict:
        config = getConfig({
            "CHK_FREQ": 5, "LOG_SIZE": 15,
            "Max3PCBatchSize": 1, "Max3PCBatchWait": 0.05,
            "RegionCount": 3,
        })
        pool = SimPool(4, seed=args.seed, config=config,
                       real_execution=True, bls=True, trace=True,
                       device=args.device)
        for i in range(8):
            pool.submit_request(i, region=i % 3)
        deadline = time.monotonic() + 240
        while (min(len(nd.ordered_digests) for nd in pool.nodes) < 8
               or pool.nodes[0].proof_cache.current() is None) \
                and time.monotonic() < deadline:
            pool.run_for(0.5)
        assert pool.honest_nodes_agree()
        assert pool.nodes[0].proof_cache.current() is not None, \
            "no proof window stabilized for the edge tier"
        origin = pool.make_read_service("node0", mode="host")
        entry = origin.proof_cache.current()
        pool_keys = {n: pk
                     for n, (kp, pk, pop) in pool.bls_keys.items()}
        edges = {}
        if use_edges:
            for i in range(entry.tree_size):
                origin.submit(i)
            replies = origin.drain()
            edges = {r: EdgeProofCache(
                region=r, clock=pool.timer.get_current_time)
                for r in range(3)}
            # da: allow[unordered-fingerprint] -- each edge replicates the same window on its own; no digest reads their order
            for edge in edges.values():
                edge.replicate(entry.window, replies)
        fabric = GeoReadFabric(
            origin, pool.region_matrix, pool_keys, min_participants=3,
            n_regions=3, origin_region=0, edges=edges, seed=args.seed,
            clock=pool.timer.get_current_time)
        for wave in range(3):
            for client in range(60):
                fabric.submit(client,
                              (7 * client + wave) % entry.tree_size)
            served = fabric.drain()
            assert len(served) == 60, (wave, len(served))
            pool.run_for(1.0)
        counters = fabric.counters()
        js = journey_summary(pool.trace.events())
        # deterministic by construction: virtual clock + the fabric's
        # dedicated seeded RNG — no wall fields, so the whole record is
        # byte-comparable across same-seed runs
        return {
            "edges": bool(use_edges),
            "fabric": counters,
            "ordered_hash": pool.ordered_hash(),
            "journey_hash": js["journey_hash"],
            "shed_hash": origin.shed_hash(),
        }

    serving = run(use_edges=True)
    replay = run(use_edges=True)
    plain = run(use_edges=False)
    failures = []
    fb = serving["fabric"]
    if fb["edge_hit_rate"] < args.geo_hit_floor:
        failures.append(
            f"edge hit rate {fb['edge_hit_rate']} below floor "
            f"{args.geo_hit_floor} (reads leaking to the origin)")
    if fb["edge_serve_pairings"] != 0:
        failures.append(
            f"edge serve path performed {fb['edge_serve_pairings']} "
            "pairing checks (must be lookups — zero pairings)")
    if fb["verify_failures"] or plain["fabric"]["verify_failures"]:
        failures.append("replies failed offline client verification")
    intra_hi = 0.05  # the pool's intra-region band ceiling
    wan_floor = getConfig().RegionWanMinLatency
    for region, block in fb["regions"].items():
        if block["latency_p99"] > intra_hi:
            failures.append(
                f"edge arm region {region} read p99 "
                f"{block['latency_p99']} above the intra band "
                f"{intra_hi} (edge tier not region-local)")
    for region in ("1", "2"):
        p99 = plain["fabric"]["regions"][region]["latency_p99"]
        if p99 < wan_floor:
            failures.append(
                f"no-edge arm region {region} read p99 {p99} under the "
                f"WAN floor {wan_floor} (baseline not paying the WAN)")
    for key in ("ordered_hash", "journey_hash", "shed_hash"):
        if serving[key] != plain[key]:
            failures.append(
                f"{key} diverged between the edge and no-edge arms "
                "(the read fabric perturbed the write planes)")
    deterministic = (json.dumps(serving, sort_keys=True)
                     == json.dumps(replay, sort_keys=True))
    if not deterministic:
        failures.append("two same-seed edge runs were not "
                        "byte-identical")
    record = {
        "edge": serving,
        "no_edge": plain,
        "hit_floor": args.geo_hit_floor,
        "deterministic": deterministic,
        "wan_over_edge_p99": round(
            max(plain["fabric"]["regions"][r]["latency_p99"]
                for r in ("1", "2"))
            / max(b["latency_p99"] for b in fb["regions"].values()), 2),
    }
    return record, failures


def residency_gate(args) -> "tuple[dict, list]":
    """Multi-tick residency + rebalancing gate: on the SAME
    n=16/k=6 workload and seed,

    1. the resident arm (``--residency-depth`` ring slots) must order
       digests bit-identical to the per-tick arm — residency changes
       WHEN the host looks, never what the pool orders;
    2. its device dispatches per ordered batch must sit under
       ``--residency-dispatch-budget`` (1.0 — fewer than one fused
       step per ordered batch, cold start included) AND the ring must
       actually defer readbacks (a silently per-tick run is vacuous);
    3. ordered/sim-second must stay within ``--residency-tolerance``
       of the per-tick arm (generous: a short cold run quantizes sim
       time to whole ticks, so deferring the final readback by one
       tick legitimately moves the ratio);
    4. the deterministic rebalance law must un-skew a synthetic hot
       shard: skew 8:1 over 4 member blocks with threshold 2.0 plans a
       sub-block rotation whose predicted hottest block drops below
       the threshold;
    5. a forced mid-run rebalance on a 4-way member mesh (plane
       migration at a checkpoint-boundary barrier, host mirrors
       rotated) must leave the ordered digests bit-identical to the
       never-rebalanced same-seed arm.
    """
    from ..tpu.quorum import make_fabric_mesh
    from ..tpu.rebalance import RebalancePolicy

    failures = []
    per_tick = measure(args.sharded_nodes, args.sharded_instances,
                       args.residency_batches, args.batch_size,
                       args.tick, seed=args.seed,
                       device=args.device)
    resident = measure(args.sharded_nodes, args.sharded_instances,
                       args.residency_batches, args.batch_size,
                       args.tick, seed=args.seed,
                       resident_depth=args.residency_depth,
                       device=args.device)
    if resident["ordered_hash"] != per_tick["ordered_hash"]:
        failures.append("resident ordered digests diverge from the "
                        "per-tick run (residency changed semantics)")
    r_pb = resident["device_dispatches_per_ordered_batch"]
    if r_pb > args.residency_dispatch_budget:
        failures.append(
            f"resident dispatches/batch {r_pb} over budget "
            f"{args.residency_dispatch_budget}")
    res = resident.get("residency") or {}
    if not res.get("readbacks_deferred"):
        failures.append("resident arm deferred no readbacks — the ring "
                        "silently ran per-tick (gate vacuous)")
    tol = args.residency_tolerance
    p_tps = per_tick["ordered_per_sim_second"] or 0.0
    r_tps = resident["ordered_per_sim_second"] or 0.0
    if r_tps < p_tps * (1.0 - tol):
        failures.append(f"resident ordered/sim-sec {r_tps} regresses "
                        f"per-tick {p_tps} beyond {tol:.0%}")

    # the deterministic un-skew law on a synthetic hot shard: one block
    # 8x hotter than the rest must plan a sub-block rotation that
    # splits its heat below the threshold
    policy = RebalancePolicy(m_shards=4, shard_rows=2, threshold=2.0,
                             dwell=2)
    hot = [8.0, 1.0, 1.0, 1.0]
    rows = 0
    for _ in range(policy.dwell + 1):
        rows = policy.observe(hot)
        if rows:
            break
    pre_skew = policy.skew(policy.block_heat(hot))
    post_heat = _predicted_heat(policy.block_heat(hot), rows,
                                policy.shard_rows)
    post_skew = policy.skew(post_heat)
    if not rows:
        failures.append(f"skew {pre_skew:.2f} over threshold "
                        f"{policy.threshold} never planned a rotation")
    elif post_skew >= min(pre_skew, policy.threshold):
        failures.append(
            f"planned rotation ({rows} rows) does not un-skew the hot "
            f"shard: predicted skew {post_skew:.2f} (pre {pre_skew:.2f},"
            f" threshold {policy.threshold})")

    # forced plane migration mid-run on the 4-way member mesh (four
    # tiles on the one device): the barrier drains the ring, the planes
    # rotate, the host placement map rewrites — and the ordering must
    # not notice
    mesh = make_fabric_mesh([args.device] * 4, (4,))
    window = {"CHK_FREQ": 5, "LOG_SIZE": 15}
    baseline = measure(8, 2, args.residency_batches,
                       args.batch_size, args.tick, seed=args.seed,
                       mesh=mesh, resident_depth=args.residency_depth,
                       overrides=window,
                       device=args.device)
    rebalanced = measure(8, 2, args.residency_batches,
                         args.batch_size, args.tick, seed=args.seed,
                         mesh=mesh,
                         resident_depth=args.residency_depth,
                         overrides={**window,
                                    "RebalanceForceTick": 12},
                         device=args.device)
    moved = rebalanced.get("residency") or {}
    if not moved.get("rebalances"):
        failures.append("forced rebalance never executed (no "
                        "checkpoint barrier reached, or the policy "
                        "never planned)")
    elif not moved.get("row_shift"):
        failures.append("rebalance executed but the placement map "
                        "never rotated")
    if rebalanced["ordered_hash"] != baseline["ordered_hash"]:
        failures.append("rebalanced ordered digests diverge from "
                        "the never-rebalanced arm (plane migration "
                        "changed semantics)")

    record = {
        "per_tick": per_tick,
        "resident": resident,
        "residency_depth": args.residency_depth,
        "residency_dispatch_budget": args.residency_dispatch_budget,
        "residency_tolerance": tol,
        "digests_match":
            resident["ordered_hash"] == per_tick["ordered_hash"],
        "dispatch_ratio": round(
            r_pb / per_tick["device_dispatches_per_ordered_batch"], 3)
        if per_tick["device_dispatches_per_ordered_batch"] else None,
        "unskew_law": {
            "planned_rows": rows,
            "pre_skew": round(pre_skew, 3),
            "predicted_post_skew": round(post_skew, 3),
            "threshold": policy.threshold,
        },
        "rebalance_baseline": baseline,
        "rebalance_forced": rebalanced,
    }
    return record, failures


def soak_gate(args) -> "tuple[dict, list]":
    """Virtual-day soak gate (simulation/soak.py): the
    24-simulated-hour diurnal arc on a real-execution pool with the
    chaos folded into ONE day — a GC-crossing crash + catchup at hour
    6, a view change at hour 12, and (on hosts with >= 4 XLA devices,
    where the pool runs tick-batched on a quorum fabric) one forced
    shard rebalance — judged entirely by the telemetry plane:

    1. resource high-water FLAT after hour 1 (tail windows vs the
       baseline that contains the whole chaos arc);
    2. hour-1 -> hour-24 ordered-throughput drift < ``--soak-drift-
       tolerance`` (default 1%: the deterministic arrival grid makes
       both hours' offered load byte-identical, so drift is the
       system's);
    3. ZERO unexplained anomalies (chaos-window anomalies are
       classified explained; bound violations never are) and zero
       bound violations;
    4. the whole artifact — ordered hash, state head, hourly tallies,
       telemetry hash chain — byte-identical across two same-seed runs;
    5. non-vacuity: a short arm with a deliberately registered leaking
       resource MUST trip the leak law (the detector is proven live,
       not just silent).
    """
    from ..simulation.soak import run_day_soak

    failures = []
    soak = run_day_soak(hours=args.soak_hours, rate=args.soak_rate,
                        seed=args.soak_seed, repeats=2,
                        device=args.device)
    if not soak["deterministic"]:
        failures.append("day soak: same-seed runs not byte-identical")
    if not soak["agree"]:
        failures.append("day soak: ledgers diverged across the chaos arc")
    if not soak["flat_high_water"]:
        grew = {n: (soak["first_high_water"][n],
                    soak["last_high_water"][n])
                for n in soak["first_high_water"]
                if soak["last_high_water"][n]
                > soak["first_high_water"][n] * 1.2}
        failures.append(
            f"day soak: resource high-water grew past hour 1: {grew}")
    if soak["throughput_drift"] >= args.soak_drift_tolerance:
        failures.append(
            f"day soak: ordered-throughput drift "
            f"{soak['throughput_drift']:.2%} >= "
            f"{args.soak_drift_tolerance:.0%} hour-1 vs hour-24")
    if soak["anomalies_unexplained"]:
        failures.append(
            f"day soak: {soak['anomalies_unexplained']} unexplained "
            f"telemetry anomalies: {soak['unexplained']}")
    if soak["bound_violations"]:
        failures.append(
            f"day soak: declared bounds violated: "
            f"{soak['bound_violations']}")
    chaos = soak["chaos"]
    if chaos["crash"] is not None and not chaos["crash"]["ok"]:
        failures.append(
            f"day soak: crash/catchup leg failed: {chaos['crash']}")
    if chaos["view_change"] is not None \
            and not chaos["view_change"]["ok"]:
        failures.append(
            f"day soak: view-change leg failed: {chaos['view_change']}")
    if chaos["rebalance"]["armed"] and not chaos["rebalance"]["ok"]:
        failures.append(
            f"day soak: forced-rebalance leg never planned: "
            f"{chaos['rebalance']}")

    # non-vacuity: the leak law must CATCH a planted leak — otherwise
    # "zero anomalies" above proves nothing. EVERY chaos leg is pushed
    # out of range (rebalance_tick=0 included: a forced rotation's
    # explained-anomaly window would swallow the planted leak's)
    leak = run_day_soak(hours=4.0, rate=args.soak_rate,
                        seed=args.soak_seed, crash_hour=99.0,
                        vc_hour=99.0, rebalance_tick=0, repeats=1,
                        synthetic_leak=True,
                        device=args.device)
    caught = [a for a in leak["unexplained"]
              if a["law"] == "resource_leak"
              and a.get("resource") == "soak.synthetic_leak"]
    if not caught:
        failures.append(
            "day soak: the leak law never caught the planted "
            "synthetic leak (detector is vacuous) — anomalies: "
            f"{leak['unexplained']}")

    record = {
        "soak": {k: soak[k] for k in (
            "hours", "rate", "seed", "device_arm", "arrivals",
            "ordered_total", "hourly_ordered", "throughput_drift",
            "flat_high_water", "windows", "anomalies",
            "anomalies_unexplained", "unexplained", "bound_violations",
            "chaos", "agree", "telemetry_hash", "fingerprint",
            "deterministic", "wall_s")},
        "drift_tolerance": args.soak_drift_tolerance,
        "rebalance_leg": ("ran" if chaos["rebalance"]["armed"]
                          else "skipped (needs >= 4 XLA devices)"),
        "leak_arm": {
            "caught": bool(caught),
            "caught_at_window": caught[0]["window"] if caught else None,
            "anomalies": leak["anomalies"],
            "wall_s": leak["wall_s"],
        },
    }
    return record, failures


def _predicted_heat(heat, rows, shard_rows):
    """The policy's own placement model: rotating by ``rows`` device
    rows splits each block's load proportionally between the blocks
    its rows land on."""
    n_blocks = len(heat)
    b0, r = divmod(rows, shard_rows)
    return [(shard_rows - r) / shard_rows * heat[(k - b0) % n_blocks]
            + r / shard_rows * heat[(k - b0 - 1) % n_blocks]
            for k in range(n_blocks)]


# gate registry (--list-gates / --only): name -> (argparse dest of the
# skip flag, one-line description). The core dispatch-budget measurement
# always runs — it is the baseline every budget compares against.
GATES = {
    "static": ("no_static_gate",
               "determinism & hot-path static analysis (zero "
               "unsuppressed, 2-run findings_hash identity)"),
    "governor": ("no_governor_gates",
                 "bursty static-vs-adaptive tick comparison"),
    "sharded": ("no_sharded_gate", "1-device vs mesh-sharded identity"),
    "fabric": ("no_fabric_gate", "1-axis vs 2-axis quorum fabric"),
    "trace": ("no_trace_gate", "flight-recorder overhead + identity"),
    "readback": ("no_readback_gate", "device-eval vs host-eval readback"),
    "ingress": ("no_ingress_gate", "open-loop saturation/admission"),
    "overload": ("no_overload_gate",
                 "closed-loop retry storm: goodput floor, no metastable "
                 "collapse, byte-identical replay, catchup under "
                 "saturation with seeder throttling"),
    "proof": ("no_proof_gate", "state-proof plane (BLS, zero pairings)"),
    "catchup": ("no_catchup_gate", "chaos-hardened catchup recovery"),
    "lanes": ("no_lanes_gate",
              "multi-lane ordering: 1-vs-4-lane scaling floor, "
              "byte-identical replay, lane+barrier journey coverage"),
    "latency": ("no_latency_gate",
                "causal journeys: byte-identical tables, zero orphans, "
                "e2e p99 budget (pool-wide + per-lane at 4 lanes)"),
    "state": ("no_state_gate",
              "batched state commit: root bit-identity across "
              "sequential/host/auto arms, >=3x hashes/commit reduction "
              "at delta=256 on 100k keys, flat+deterministic "
              "virtual-time soak"),
    "geo": ("no_geo_gate",
            "planet-scale read fabric: >=90% edge-local reads at intra "
            "p99 vs same-seed WAN baseline, zero serve-path pairings, "
            "bit-identical write fingerprints, deterministic replay"),
    "residency": ("no_residency_gate",
                  "multi-tick device residency + rebalancing: per-tick "
                  "digest identity, <=1 dispatch/ordered batch, "
                  "synthetic un-skew law, forced plane migration with "
                  "unchanged digests"),
    "soak": ("no_soak_gate",
             "virtual-day soak: 24 simulated diurnal hours with one "
             "chaos arc (GC-crossing crash+catchup, view change, "
             "forced rebalance), flat resource high-water after hour "
             "1, <1% hour-1-vs-24 ordered drift, zero unexplained "
             "anomalies, byte-identical telemetry hash across two "
             "same-seed runs, leak-law non-vacuity"),
}


def build_parser() -> argparse.ArgumentParser:
    """The reference's flags, defaults and help, plus ``--device``."""
    ap = argparse.ArgumentParser(
        prog="python -m indy_plenum_tpu_torch.tools.check_dispatch_budget",
        description=__doc__)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--instances", type=int, default=1)
    ap.add_argument("--batches", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=10)
    ap.add_argument("--tick", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--budget-per-batch", type=float, default=25.0,
                    help="max device dispatches per ordered batch")
    ap.add_argument("--budget-per-message", type=float, default=0.25,
                    help="max device dispatches per delivered message")
    ap.add_argument("--no-governor-gates", action="store_true",
                    help="skip the bursty static-vs-adaptive comparison")
    ap.add_argument("--no-sharded-gate", action="store_true",
                    help="skip the 1-device vs mesh-sharded comparison")
    ap.add_argument("--no-trace-gate", action="store_true",
                    help="skip the flight-recorder overhead comparison")
    ap.add_argument("--no-ingress-gate", action="store_true",
                    help="skip the open-loop saturation/admission gate")
    ap.add_argument("--no-overload-gate", action="store_true",
                    help="skip the overload robustness gate (flash-"
                         "crowd retry storm goodput/recovery floors, "
                         "byte-identical shed/retry/ordered replay, "
                         "catchup-under-saturation chaos verdicts)")
    ap.add_argument("--overload-goodput-floor", type=float, default=0.70,
                    help="min retry-storm ordered count as a fraction "
                         "of the open-loop arm's")
    ap.add_argument("--overload-recovery-tolerance", type=float,
                    default=0.30,
                    help="max fractional post-spike ordered-rate "
                         "shortfall vs pre-spike (metastable-collapse "
                         "detector) either overload arm may show")
    ap.add_argument("--no-readback-gate", action="store_true",
                    help="skip the device-eval vs host-eval ordering "
                         "fast path comparison")
    ap.add_argument("--no-fabric-gate", action="store_true",
                    help="skip the 1-axis vs 2-axis quorum-fabric "
                         "comparison")
    ap.add_argument("--no-proof-gate", action="store_true",
                    help="skip the state-proof plane gate (ordered-hash "
                         "identity, zero serve-path pairings, client "
                         "verify, batched-verify speedup)")
    ap.add_argument("--no-catchup-gate", action="store_true",
                    help="skip the chaos-hardened catchup gate "
                         "(GC-crossing crash/restart verdicts, ledger "
                         "bit-identity, byte-identical replay, byzantine "
                         "seeder rejection)")
    ap.add_argument("--no-lanes-gate", action="store_true",
                    help="skip the multi-lane ordering gate (1-vs-4-"
                         "lane scaling floor, byte-identical replay, "
                         "lane + barrier-hop journey coverage)")
    ap.add_argument("--lanes-speedup-floor", type=float, default=3.0,
                    help="min 4-lane vs 1-lane ordered/sim-second "
                         "ratio the lanes gate accepts")
    ap.add_argument("--lanes-nodes", type=int, default=4,
                    help="validators PER LANE for the lanes gate")
    ap.add_argument("--lanes-txns", type=int, default=40,
                    help="routed txns per lane for the lanes gate")
    ap.add_argument("--no-latency-gate", action="store_true",
                    help="skip the causal-journey latency gate "
                         "(byte-identical journey tables, zero orphan "
                         "spans, traced-vs-untraced ordered_hash, e2e "
                         "p99 budget)")
    ap.add_argument("--no-static-gate", action="store_true",
                    help="skip the determinism & hot-path static-"
                         "analysis gate (zero unsuppressed findings, "
                         "byte-stable findings_hash across two runs)")
    ap.add_argument("--no-state-gate", action="store_true",
                    help="skip the batched state-commit gate (root "
                         "bit-identity across arms, hashes/commit "
                         "reduction floor, virtual-time soak flatness)")
    ap.add_argument("--state-keys", type=int, default=100_000,
                    help="resident SMT keys for the state gate's "
                         "commit arms")
    ap.add_argument("--state-delta", type=int, default=256,
                    help="writes per window commit for the state gate")
    ap.add_argument("--state-windows", type=int, default=20,
                    help="window commits per arm for the state gate")
    ap.add_argument("--state-hash-floor", type=float, default=3.0,
                    help="min sequential/batched hashes-per-commit "
                         "ratio the state gate accepts")
    ap.add_argument("--state-soak-hours", type=float, default=2.0,
                    help="simulated hours for the state gate's "
                         "virtual-time soak arm")
    ap.add_argument("--state-drift-tolerance", type=float, default=0.05,
                    help="max first-vs-last simulated-hour ordered-"
                         "throughput drift the soak arm accepts")
    ap.add_argument("--no-geo-gate", action="store_true",
                    help="skip the planet-scale read fabric gate "
                         "(edge hit-rate floor at intra-band p99 vs "
                         "the same-seed WAN baseline, zero serve-path "
                         "pairings, bit-identical write fingerprints "
                         "between arms, byte-identical replay)")
    ap.add_argument("--no-residency-gate", action="store_true",
                    help="skip the multi-tick residency + rebalancing "
                         "gate (per-tick digest identity, dispatch "
                         "budget, un-skew law, forced plane migration)")
    ap.add_argument("--residency-depth", type=int, default=4,
                    help="ring depth for the resident arm")
    ap.add_argument("--residency-batches", type=int, default=6,
                    help="ordered batches per residency-gate arm (long "
                         "enough to amortize the cold-start consumes "
                         "the gate deliberately counts)")
    ap.add_argument("--residency-dispatch-budget", type=float,
                    default=1.0,
                    help="max device dispatches per ordered batch on "
                         "the resident arm (cold run, n=16/k=6)")
    ap.add_argument("--residency-tolerance", type=float, default=0.5,
                    help="allowed resident ordered/sim-second slack vs "
                         "the per-tick arm (generous: short cold runs "
                         "quantize sim time to whole ticks)")
    ap.add_argument("--geo-hit-floor", type=float, default=0.90,
                    help="min fraction of storm reads the edge arm "
                         "must serve from region-local edge caches")
    ap.add_argument("--no-soak-gate", action="store_true",
                    help="skip the virtual-day soak gate (24 simulated "
                         "diurnal hours with one chaos arc, judged by "
                         "the telemetry plane; two same-seed runs + a "
                         "leak-law non-vacuity arm)")
    ap.add_argument("--soak-hours", type=float, default=None,
                    help="virtual hours for the day soak (default: the "
                         "SoakHours config knob, 24)")
    ap.add_argument("--soak-rate", type=float, default=None,
                    help="base arrivals/sim-second for the soak's "
                         "diurnal grid (default: the SoakRate knob)")
    ap.add_argument("--soak-seed", type=int, default=17,
                    help="seed for the day soak's two same-seed runs")
    ap.add_argument("--soak-drift-tolerance", type=float, default=0.01,
                    help="max hour-1 vs hour-24 ordered-throughput "
                         "drift for the day soak")
    ap.add_argument("--only", default=None, metavar="GATE[,GATE]",
                    help="run ONLY the named gate(s) — e.g. '--only "
                         "latency' instead of stacking nine --no-*-gate "
                         "flags; see --list-gates for names. The core "
                         "dispatch-budget measurement always runs")
    ap.add_argument("--list-gates", action="store_true",
                    help="print the gate names --only accepts and exit")
    ap.add_argument("--e2e-budget", type=float, default=5.0,
                    help="max e2e p99 (client ingress -> executed, "
                         "VIRTUAL sim-seconds) the latency gate accepts")
    ap.add_argument("--proof-speedup-floor", type=float, default=2.0,
                    help="min batch-64 multi-sig verify speedup vs the "
                         "per-root path")
    ap.add_argument("--fabric-tolerance", type=float, default=0.10,
                    help="max fractional dispatches/ordered-batch and "
                         "bytes/readback drift the 2-axis fabric run "
                         "may show vs the 1-axis mesh run")
    ap.add_argument("--readback-budget", type=float, default=32768,
                    help="max device->host bytes per readback the "
                         "compact (device-eval) run may average")
    ap.add_argument("--readback-tolerance", type=float, default=0.05,
                    help="max fractional ordered/sim-second regression "
                         "device eval may show vs the host_eval fallback")
    ap.add_argument("--ingress-capacity", type=int, default=16,
                    help="bounded auth-queue capacity for the ingress "
                         "gate (small on purpose: overload must engage "
                         "within the short gate window)")
    ap.add_argument("--ingress-rate", type=float, default=700.0,
                    help="saturated arrivals/sim-second (must overload "
                         "the queue at the starting tick)")
    ap.add_argument("--ingress-unsat-rate", type=float, default=120.0,
                    help="unsaturated baseline arrivals/sim-second")
    ap.add_argument("--ingress-duration", type=float, default=1.0,
                    help="arrival window, sim-seconds")
    ap.add_argument("--ingress-tolerance", type=float, default=0.10,
                    help="max fractional ordered/sim-second collapse the "
                         "saturated run may show vs the unsaturated run")
    ap.add_argument("--trace-tolerance", type=float, default=0.05,
                    help="max fractional ordered/sim-second regression "
                         "the recorder-enabled run may show vs disabled")
    ap.add_argument("--mesh-devices", type=int, default=4,
                    help="mesh width (tiles, all on the one device) for "
                         "the sharded and fabric gates")
    ap.add_argument("--sharded-nodes", type=int, default=16,
                    help="pool size for the sharded gate")
    ap.add_argument("--sharded-instances", type=int, default=6,
                    help="RBFT instances for the sharded gate")
    ap.add_argument("--sharded-tolerance", type=float, default=0.10,
                    help="max fractional dispatches/ordered-batch drift "
                         "the mesh run may show vs the 1-device run")
    ap.add_argument("--occupancy-floor", type=float, default=0.01,
                    help="min steady-state flush occupancy for the "
                         "adaptive bursty run")
    ap.add_argument("--adaptive-tolerance", type=float, default=0.05,
                    help="max fractional regression the adaptive run may "
                         "show vs the static run (dispatches/batch and "
                         "ordered/sim-second)")
    ap.add_argument("--json", action="store_true",
                    help="emit the measurement as one JSON line")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the kernels' plain versions; the "
                         "default is the CUDA card")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)

    if args.list_gates:
        for name, (_dest, desc) in GATES.items():
            print(f"{name:10s} {desc}")
        return 0
    if args.only is not None:
        chosen = [g.strip() for g in args.only.split(",") if g.strip()]
        unknown = [g for g in chosen if g not in GATES]
        if unknown:
            raise SystemExit(
                f"--only: unknown gate(s) {', '.join(unknown)} "
                f"(see --list-gates)")
        for name, (dest, _desc) in GATES.items():
            setattr(args, dest, name not in chosen)
    from ..utils.torch_env import NoCudaDevice, resolve_device

    try:
        args.device = resolve_device(args.device)
    except NoCudaDevice as exc:
        ap.error(str(exc))

    result = measure(args.nodes, args.instances, args.batches,
                     args.batch_size, args.tick, seed=args.seed,
                     device=args.device)
    per_batch = result["device_dispatches_per_ordered_batch"]
    per_msg = result["device_dispatches_per_delivered_message"]
    result["budget_per_batch"] = args.budget_per_batch
    result["budget_per_message"] = args.budget_per_message
    over = []
    if per_batch > args.budget_per_batch:
        over.append(f"dispatches/batch {per_batch} > {args.budget_per_batch}")
    if per_msg > args.budget_per_message:
        over.append(f"dispatches/message {per_msg} "
                    f"> {args.budget_per_message}")
    if not args.no_static_gate:
        record, failures = static_gate(args)
        result["static_gate"] = record
        over.extend(failures)
    if not args.no_governor_gates:
        record, failures = governor_gates(args)
        result["governor_gate"] = record
        over.extend(failures)
    sharded_single = None
    sharded_mesh = None
    if not args.no_sharded_gate:
        record, failures = sharded_gates(args)
        result["sharded_gate"] = record
        over.extend(failures)
        # same args as the tracing gate's untraced baseline — reuse it
        sharded_single = record.get("single_device")
        # ... and as the fabric gate's 1-axis arm
        sharded_mesh = record.get("mesh_sharded")
    if not args.no_fabric_gate:
        record, failures = fabric_gate(args, base=sharded_mesh)
        result["fabric_gate"] = record
        over.extend(failures)
    traced_run = None
    if not args.no_trace_gate:
        record, failures = tracing_gate(args, base=sharded_single)
        result["tracing_gate"] = record
        over.extend(failures)
        # same args as the latency gate's first traced arm — reuse it
        traced_run = record.get("traced")
    laned_run = None
    if not args.no_lanes_gate:
        record, failures = lanes_gate(args)
        result["lanes_gate"] = record
        over.extend(failures)
        # same args as the latency gate's 4-lane rider — reuse it
        laned_run = record.get("four_lane")
    if not args.no_latency_gate:
        record, failures = latency_gate(args, traced=traced_run,
                                        base=sharded_single,
                                        laned=laned_run)
        result["latency_gate"] = record
        over.extend(failures)
    if not args.no_readback_gate:
        record, failures = readback_gate(args, base=sharded_single)
        result["readback_gate"] = record
        over.extend(failures)
    if not args.no_ingress_gate:
        record, failures = ingress_gate(args)
        result["ingress_gate"] = record
        over.extend(failures)
    if not args.no_overload_gate:
        record, failures = overload_gate(args)
        result["overload_gate"] = record
        over.extend(failures)
    if not args.no_proof_gate:
        record, failures = proof_gate(args)
        result["proof_gate"] = record
        over.extend(failures)
    if not args.no_catchup_gate:
        record, failures = catchup_gate(args)
        result["catchup_gate"] = record
        over.extend(failures)
    if not args.no_state_gate:
        record, failures = state_gate(args)
        result["state_gate"] = record
        over.extend(failures)
    if not args.no_geo_gate:
        record, failures = geo_gate(args)
        result["geo_gate"] = record
        over.extend(failures)
    if not args.no_residency_gate:
        record, failures = residency_gate(args)
        result["residency_gate"] = record
        over.extend(failures)
    if not args.no_soak_gate:
        record, failures = soak_gate(args)
        result["soak_gate"] = record
        over.extend(failures)
    result["verdict"] = "FAIL: " + "; ".join(over) if over else "PASS"
    if args.json:
        print(json.dumps(result, separators=(",", ":")))
    else:
        for key, value in result.items():
            print(f"{key}: {value}")
    return 1 if over else 0


if __name__ == "__main__":
    sys.exit(main())
