"""Shared device-quorum wiring for the simulation pools.

:class:`~indy_plenum_tpu_torch.simulation.pool.SimPool` shares one
grouped device vote plane among its nodes and, in tick-batched mode, one
pool-level tick that flushes the whole group once and then lets every
node evaluate against the fresh snapshot.

The tick is the dispatch-plane barrier (README "Performance"): it is
scheduled with ``barrier=True`` so every network delivery due at the tick
instant lands FIRST; the tick then (1) drains the signed-request ingress
through one device batch verify, (2) scatters the whole pool's buffered
votes in one grouped device step, and (3) lets every service evaluate
against the fresh snapshot. ``device.dispatches_per_tick`` and
``device.flush_occupancy`` land in the group's metrics collector so the
amortization is a regression-guarded number
(``scripts/check_dispatch_budget.py``).

With a ``mesh`` the same contract runs on the member x validator fabric,
every tile on the group's one device: the governor observes the per-cell
occupancy grid, and an armed :class:`~indy_plenum_tpu_torch.tpu.rebalance
.RebalancePolicy` plans member-plane rotations that the group executes at
its next checkpoint-boundary slide. :func:`drive_lane_ticks` is the one
tick of the ordering lanes: every lane's group flushes once a tick, one
governor over all of them.

Copy of ``indy_plenum_tpu/simulation/quorum_driver.py``, with its imports
bound to the port.
"""
from __future__ import annotations

from typing import Callable, Optional

from ..common.metrics_collector import MetricsName
from ..common.timer import RepeatingTimer, TimerService
from ..config import Config
from ..ingress.admission import BackpressureSignal
from ..observability.trace import _NO_SPAN
from ..utils.torch_env import DeviceLike


def make_vote_group(n_nodes: int, validators, config: Config,
                    num_instances: int = 1, mesh=None,
                    pipelined: bool = True, metrics=None,
                    host_eval: bool = False, device: DeviceLike = None):
    """Member axis = (node x instance): member i*num_instances + inst_id
    is node i's plane for protocol instance inst_id (SURVEY §2.6's RBFT
    mapping — instances are a leading tensor dimension, so backups' vote
    tallies ride the same dispatch as the master's). ``mesh`` (a
    ``FabricMesh``) runs the group as the member x validator fabric on
    its one device (both axes padded up to a mesh multiple; readbacks
    counted per member block); ``pipelined`` (DEFAULT since the ordering
    fast path: README "Performance") overlaps each tick's device
    round-trip with the next tick's host work (verdicts lag one tick;
    the services' lost-wakeup guard re-arms while a step is in flight).
    ``host_eval`` selects the full-event-matrix readback fallback over
    the default on-device quorum eval + compact delta readback.
    ``config.FlushLadderAdaptive`` hands the padded flush width to the
    learned per-pool ladder; ``config.ResidentTickDepth`` > 1 turns on
    the multi-tick residency ring (one fused device dispatch per
    up-to-N ticks)."""
    from ..tpu.vote_plane import VotePlaneGroup

    return VotePlaneGroup(
        n_nodes * max(1, num_instances), list(validators),
        log_size=config.LOG_SIZE,
        n_checkpoints=max(1, config.LOG_SIZE // config.CHK_FREQ),
        mesh=mesh, pipelined=pipelined, metrics=metrics,
        adaptive_ladder=config.FlushLadderAdaptive,
        host_eval=host_eval,
        resident_depth=config.ResidentTickDepth,
        device=device)


def drive_group_ticks(timer: TimerService, config: Config, vote_group,
                      nodes, accounting=None,
                      ingress: Optional[Callable[[], None]] = None,
                      trace=None) -> Optional[RepeatingTimer]:
    """Start the pool-level quorum tick (tick-batched mode only).

    Each node must expose ``vote_plane`` / ``ordering`` / ``checkpoints``;
    queries between ticks read the per-tick snapshot
    (``defer_flush_on_query``), and ONE group flush per tick serves the
    whole pool. The tick is a ``barrier`` timer event: deliveries due at
    the tick instant drain before it fires, so quorum evaluation never
    races a same-instant message. ``ingress`` (optional) drains the
    pool's signed-request queue through one device batch verify at tick
    start — requests that arrived during the interval ride one Ed25519
    dispatch, then their finalisation is visible to the same tick's batch
    timers. ``accounting`` (name -> seconds) attributes each node's
    tick evaluation to it, plus the FULL shared flush time to EVERY node
    (conservative: a deployed node flushes only its own plane).

    With ``config.QuorumTickAdaptive`` the returned timer's interval is
    governed: after each tick the :class:`~indy_plenum_tpu_torch.tpu.governor
    .DispatchGovernor` observes the tick's scattered votes / padded
    capacity / chained dispatches and retunes the interval inside the
    configured bounds (the governor rides the timer as ``.governor`` so
    pools can expose the trajectory).
    """
    if vote_group is None or config.QuorumTickInterval <= 0:
        return None
    for node in nodes:
        node.vote_plane.defer_flush_on_query = True

    from time import perf_counter

    from ..observability.trace import NULL_TRACE
    from ..tpu.governor import DispatchGovernor

    # flight recorder: per-tick dispatch-plane spans (drain / flush /
    # eval / governor decision) join the 3PC lifecycle marks the
    # services record — one attributable timeline per tick
    trace = trace if trace is not None else NULL_TRACE
    governor = DispatchGovernor.from_config(config,
                                            metrics=vote_group.metrics,
                                            trace=trace)
    last = [vote_group.flushes, vote_group.flush_votes_total,
            vote_group.flush_capacity_total]
    # per-shard baselines (length 1 when unsharded): the governor's law
    # runs on per-shard occupancy deltas, so a mesh run's hot shard
    # narrows the tick for the whole pool
    last_shard = [list(vote_group.flush_votes_per_shard),
                  list(vote_group.flush_capacity_per_shard)]
    # occupancy-driven rebalancing (tpu/rebalance.py): None unless the
    # group is member-sharded AND a trigger is armed. The policy only
    # PLANS here; the group executes at its next checkpoint-boundary
    # slide (the rebalance barrier).
    from ..tpu.rebalance import RebalancePolicy

    rebalance = RebalancePolicy.from_config(config, vote_group)
    timer_box: list = []  # the RepeatingTimer, bound after construction

    def tick() -> None:
        # ingress stays OUTSIDE the accounted window: SimPool's shared
        # ingress is a pool-level stand-in — charging its auth batch to
        # every node's host_seconds would n-fold over-count it. The
        # drain's return value may be a BackpressureSignal (admission
        # plane): queue depth / sheds / leeching feed the governor's
        # law alongside the flush occupancy it already observes.
        drained = None
        if ingress is not None:
            if trace.enabled:
                with trace.span("tick.drain"):
                    drained = ingress()
            else:
                drained = ingress()
        # da: allow[nondet-source] -- host-CPU accounting (profile_rbft attribution); tick cadence and quorum math ride the injected timer
        t0 = perf_counter() if accounting is not None else 0.0
        vote_group.flush()
        dispatches = vote_group.flushes - last[0]
        vote_group.metrics.add_event(
            MetricsName.DEVICE_DISPATCHES_PER_TICK, dispatches)
        if trace.enabled:
            trace.record("tick.flush", cat="dispatch",
                         args={"dispatches": dispatches,
                               "votes": vote_group.flush_votes_total
                               - last[1]})
        if governor is not None:
            if isinstance(drained, BackpressureSignal):
                governor.feed_backpressure(drained)
            new_interval = governor.observe_shards(
                [a - b for a, b in zip(vote_group.flush_votes_per_shard,
                                       last_shard[0])],
                [a - b for a, b in zip(vote_group.flush_capacity_per_shard,
                                       last_shard[1])],
                dispatches,
                # pipelined plane with verdicts in flight: cap the next
                # tick at the base interval so the absorb is prompt (the
                # absorb tick dispatches nothing — see the governor's
                # absorb clamp)
                inflight=vote_group.lagging)
            timer_box[0].update_interval(new_interval)
            if trace.enabled:
                trace.record(
                    "tick.governor", cat="dispatch",
                    args={"interval": round(new_interval, 9),
                          "occupancy_ewma": round(governor.ewma, 6)})
        if rebalance is not None:
            rows = rebalance.observe(
                governor.shard_ewmas if governor is not None else None)
            if rows:
                if trace.enabled:
                    trace.record(
                        "rebalance.planned", cat="dispatch",
                        args={"rows": rows,
                              "skew": round(rebalance.last_skew, 4)})
                vote_group.schedule_rebalance(rows)
        last[:] = [vote_group.flushes, vote_group.flush_votes_total,
                   vote_group.flush_capacity_total]
        last_shard[0] = list(vote_group.flush_votes_per_shard)
        last_shard[1] = list(vote_group.flush_capacity_per_shard)
        # da: allow[nondet-source] -- accounting close (see t0 above)
        flush_dt = perf_counter() - t0 if accounting is not None else 0.0
        with trace.span("tick.eval", args={"nodes": len(nodes)}) \
                if trace.enabled else _NO_SPAN:
            for node in nodes:
                # da: allow[nondet-source] -- per-node accounting window open
                t0 = perf_counter() if accounting is not None else 0.0
                node.ordering.service_quorum_tick()
                node.checkpoints.service_quorum_tick()
                replicas = getattr(node, "replicas", None)  # SimNode: none
                for backup in (replicas.backups if replicas else ()):
                    if backup.vote_plane is not None:
                        backup.ordering.service_quorum_tick()
                        backup.checkpoints.service_quorum_tick()
                if accounting is not None:
                    # da: allow[nondet-source] -- accounting window close
                    accounting[node.name] += (perf_counter() - t0) + flush_dt

    interval = governor.interval if governor else config.QuorumTickInterval
    rt = RepeatingTimer(timer, interval, tick, barrier=True)
    timer_box.append(rt)
    rt.governor = governor
    rt.rebalance = rebalance
    return rt


def drive_lane_ticks(timer: TimerService, config: Config, lane_pools,
                     barrier=None, trace=None,
                     metrics=None) -> Optional[RepeatingTimer]:
    """One pool-level tick driving EVERY ordering lane: each lane owns a
    full :class:`~indy_plenum_tpu_torch.tpu.vote_plane.VotePlaneGroup`
    (its own fabric when the lane has a mesh; every lane on the pool's
    one device), but the tick cadence is shared — per tick, each lane's
    ingress drains, each lane's group flushes once, every lane's
    services evaluate against their fresh snapshot, and finally the
    cross-lane checkpoint barrier re-evaluates its seal condition
    (:meth:`~indy_plenum_tpu_torch.lanes.barrier.CrossLaneBarrier
    .service_tick`) so a lane that went idle unblocks the others at a
    deterministic instant.

    ONE dispatch governor serves all lanes: it observes the
    concatenation of every lane's per-shard occupancy deltas (the
    hottest lane-shard narrows the tick for the whole pool, exactly as
    the hottest shard does in a mesh run) and the FOLDED per-lane
    backpressure (max queue pressure, summed sheds, any-lane leeching).
    Returns None when ``config.QuorumTickInterval <= 0`` (per-message
    mode — the LanedPool then runs a plain barrier pulse instead)."""
    if config.QuorumTickInterval <= 0:
        return None
    from ..observability.trace import NULL_TRACE
    from ..tpu.governor import DispatchGovernor

    trace = trace if trace is not None else NULL_TRACE
    if metrics is None:
        metrics = lane_pools[0].metrics
    tick_groups = [lp.vote_group for lp in lane_pools
                   if lp.vote_group is not None]
    for lp in lane_pools:
        if lp.vote_group is not None:
            for node in lp.nodes:
                node.vote_plane.defer_flush_on_query = True
                replicas = getattr(node, "replicas", None)
                for backup in (replicas.backups if replicas else ()):
                    if backup.vote_plane is not None:
                        backup.vote_plane.defer_flush_on_query = True
    governor = DispatchGovernor.from_config(config, metrics=metrics,
                                            trace=trace) \
        if tick_groups else None
    last_flush = [g.flushes for g in tick_groups]
    last_shard = [(list(g.flush_votes_per_shard),
                   list(g.flush_capacity_per_shard)) for g in tick_groups]
    timer_box: list = []

    def tick() -> None:
        signals = []
        with trace.span("tick.drain") if trace.enabled else _NO_SPAN:
            for lp in lane_pools:
                if lp.authnr is not None:
                    drained = lp._ingress_tick()
                    if isinstance(drained, BackpressureSignal):
                        signals.append(drained)
        dispatches_per_lane = []
        vote_deltas: list = []
        cap_deltas: list = []
        for gi, group in enumerate(tick_groups):
            group.flush()
            dispatches_per_lane.append(group.flushes - last_flush[gi])
            last_flush[gi] = group.flushes
            votes0, caps0 = last_shard[gi]
            vote_deltas.extend(
                a - b for a, b in zip(group.flush_votes_per_shard, votes0))
            cap_deltas.extend(
                a - b for a, b in zip(group.flush_capacity_per_shard,
                                      caps0))
            last_shard[gi] = (list(group.flush_votes_per_shard),
                              list(group.flush_capacity_per_shard))
        dispatches = sum(dispatches_per_lane)
        if tick_groups:
            metrics.add_event(MetricsName.DEVICE_DISPATCHES_PER_TICK,
                              dispatches)
        if trace.enabled:
            trace.record("tick.flush", cat="dispatch",
                         args={"dispatches": dispatches,
                               "per_lane": dispatches_per_lane})
        if governor is not None:
            if signals:
                # fold per-lane pressure: the most-pressured lane's
                # queue fraction drives the narrow decision, sheds and
                # outstanding retries sum, and any lane leeching widens
                worst = max(signals, key=lambda s: s.queue_frac)
                governor.feed_backpressure(BackpressureSignal(
                    queue_depth=worst.queue_depth,
                    capacity=worst.capacity,
                    shed_delta=sum(s.shed_delta for s in signals),
                    leeching=any(s.leeching for s in signals),
                    retry_pressure=sum(s.retry_pressure
                                       for s in signals)))
            new_interval = governor.observe_shards(
                vote_deltas, cap_deltas, dispatches,
                inflight=any(g.lagging for g in tick_groups))
            timer_box[0].update_interval(new_interval)
            if trace.enabled:
                trace.record(
                    "tick.governor", cat="dispatch",
                    args={"interval": round(new_interval, 9),
                          "occupancy_ewma": round(governor.ewma, 6)})
        with trace.span("tick.eval",
                        args={"lanes": len(lane_pools)}) \
                if trace.enabled else _NO_SPAN:
            for lp in lane_pools:
                if lp.vote_group is None:
                    continue
                for node in lp.nodes:
                    node.ordering.service_quorum_tick()
                    node.checkpoints.service_quorum_tick()
                    replicas = getattr(node, "replicas", None)
                    for backup in (replicas.backups if replicas else ()):
                        if backup.vote_plane is not None:
                            backup.ordering.service_quorum_tick()
                            backup.checkpoints.service_quorum_tick()
        if barrier is not None:
            barrier.service_tick()
        # per-lane ordered totals (Monitor lanes block: Stat.last)
        for li, lp in enumerate(lane_pools):
            metrics.add_event(
                "%s.%d" % (MetricsName.LANE_ORDERED, li),
                min(len(nd.ordered_digests) for nd in lp.nodes))
        metrics.add_event(MetricsName.LANE_COUNT, len(lane_pools))

    interval = governor.interval if governor else config.QuorumTickInterval
    rt = RepeatingTimer(timer, interval, tick, barrier=True)
    timer_box.append(rt)
    rt.governor = governor
    return rt
