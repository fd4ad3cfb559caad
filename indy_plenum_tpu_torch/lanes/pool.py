"""LanedPool: K independent ordering lanes under one barrier.

The multi-lane write path: the request
keyspace partitions across K LANES via the deterministic
:class:`~indy_plenum_tpu_torch.lanes.router.LaneRouter`; each lane is a full
:class:`~indy_plenum_tpu_torch.simulation.pool.SimPool` — n validators, its
own :class:`~indy_plenum_tpu_torch.simulation.sim_network.SimNetwork`, its own
master-instance :class:`~indy_plenum_tpu_torch.tpu.vote_plane.VotePlaneGroup`
(optionally as its own fabric, :func:`lane_meshes`) — all
lanes sharing ONE virtual clock, ONE metrics collector, ONE
flight-recorder ring (each lane tagging its events through a
:class:`~indy_plenum_tpu_torch.observability.trace.LaneTraceView`), ONE
dispatch tick (:func:`~indy_plenum_tpu_torch.simulation.quorum_driver
.drive_lane_ticks`), and ONE
:class:`~indy_plenum_tpu_torch.lanes.barrier.CrossLaneBarrier` threaded into
every lane's checkpoint service.

Determinism: the router law, per-lane derived seeds, the shared virtual
clock, and the barrier's fold are all pure functions of (seed, inputs),
so a seeded laned run replays byte-identical per-lane ``ordered_hash``es
AND the byte-identical sealed-window fingerprint chain.

Copy of ``indy_plenum_tpu/lanes/pool.py``, with its imports bound to the
port. Every lane's vote group, ingress drain and window ops run on the
pool's ``device``: the CUDA card unless the caller passes ``"cpu"``. All
lanes share that one device: :func:`lane_meshes` builds each lane's fabric
on it, where the reference slices its device list into disjoint meshes;
spreading the lanes over several cards waits for the multi-card fabric.
"""
from __future__ import annotations

import hashlib
from typing import List, Optional

from ..common.constants import DOMAIN_LEDGER_ID
from ..common.metrics_collector import MetricsCollector, MetricsName
from ..common.request import Request
from ..common.timer import RepeatingTimer
from ..config import Config, getConfig
from ..simulation.mock_timer import MockTimer
from ..simulation.pool import SimPool
from ..simulation.quorum_driver import drive_lane_ticks
from ..utils.torch_env import DeviceLike, resolve_device
from .barrier import CrossLaneBarrier
from .router import LaneRouter


def lane_seed(seed: int, lane: int) -> int:
    """Per-lane derived seed (network latency draws, shed tiebreaks):
    distinct per lane, pure function of the pool seed."""
    h = hashlib.sha256(b"lane-pool|%d|%d" % (seed, lane)).digest()
    return int.from_bytes(h[:4], "big")


def lane_meshes(lanes: int, shape, device: DeviceLike = None) -> list:
    """One fabric mesh of ``shape`` for each of ``lanes`` lanes, every
    tile on ``device`` (the card unless ``"cpu"``). The reference slices
    its host's device grid into disjoint meshes, lane l on devices
    ``[l*prod(shape), (l+1)*prod(shape))``; the port has one card, so the
    lanes share it and each lane's vote plane runs as its own fabric
    there. Lanes on distinct cards wait for the multi-card fabric."""
    from ..tpu import quorum as q

    device = resolve_device(device)
    per = 1
    for dim in shape:
        per *= dim
    return [q.make_fabric_mesh([device] * per, tuple(shape))
            for _ in range(lanes)]


def _lane_busy(lane_pool: SimPool) -> bool:
    """Deterministic busyness probe for the barrier's idle-advance law:
    a lane counts busy while it holds admitted-but-undrained, pending,
    or in-flight (pre-prepared but unordered) work, or is mid view
    change. Pure function of pool state on the virtual clock."""
    if lane_pool.admission is not None and lane_pool.admission.depth:
        return True
    if lane_pool._ingress:
        return True
    for node in lane_pool.nodes:
        if node.data.waiting_for_new_view:
            return True
        if node.requests_view.has_ready(DOMAIN_LEDGER_ID):
            return True
        last = node.data.last_ordered_3pc[1]
        ordering = node.ordering
        if any(seq > last for (_view, seq) in ordering.prePrepares):
            return True
        if any(seq > last for (_view, seq) in ordering.sent_preprepares):
            return True
    return False


class LanedPool:
    def __init__(self, lanes: int = 0, n_nodes: int = 4, seed: int = 0,
                 config: Optional[Config] = None,
                 device_quorum: bool = False,
                 real_execution: bool = False,
                 sign_requests: bool = False,
                 bls: bool = False,
                 num_instances: int = 1,
                 meshes=None,
                 host_eval: bool = False,
                 pipelined_flush: bool = True,
                 trace: bool = False,
                 trace_capacity: Optional[int] = None,
                 device: DeviceLike = None):
        self.config = config or getConfig(
            {"Max3PCBatchWait": 0.1, "Max3PCBatchSize": 10})
        # the config knob is the deployed-surface default; an explicit
        # constructor arg wins (bench/gate runs sweep lane counts)
        lanes = lanes or self.config.OrderingLanes or 1
        self.n_lanes = lanes
        self.seed = seed
        self.timer = MockTimer(start_time=1_700_000_000.0)
        self.metrics = MetricsCollector()
        from ..observability.trace import (
            NULL_TRACE,
            LaneTraceView,
            TraceRecorder,
        )

        self.trace = (TraceRecorder(
            self.timer.get_current_time,
            capacity=trace_capacity or self.config.TraceRecorderCapacity)
            if trace else NULL_TRACE)
        self.router = LaneRouter(
            lanes, seed=self.config.LaneRouterSeed or seed,
            metrics=self.metrics)
        self.barrier = CrossLaneBarrier(
            lanes, chk_freq=self.config.CHK_FREQ,
            clock=self.timer.get_current_time,
            trace=self.trace, metrics=self.metrics,
            keep=self.config.LaneBarrierKeepWindows)
        if meshes is not None and len(meshes) != lanes:
            raise ValueError(
                f"meshes must carry one mesh per lane: "
                f"{len(meshes)} != {lanes}")
        self.lane_pools: List[SimPool] = [
            SimPool(n_nodes=n_nodes, seed=lane_seed(seed, lane),
                    config=self.config,
                    device_quorum=device_quorum,
                    real_execution=real_execution,
                    sign_requests=sign_requests,
                    bls=bls,
                    shadow_check=False if device_quorum else None,
                    num_instances=num_instances,
                    mesh=meshes[lane] if meshes is not None else None,
                    host_eval=host_eval,
                    pipelined_flush=pipelined_flush,
                    timer=self.timer,
                    metrics=self.metrics,
                    trace_recorder=(LaneTraceView(self.trace, lane)
                                    if trace else None),
                    drive_ticks=False,
                    barrier=self.barrier,
                    lane=lane,
                    device=device)
            for lane in range(lanes)]
        for lane, lane_pool in enumerate(self.lane_pools):
            self.barrier.set_idle_probe(
                lane, lambda lp=lane_pool: not _lane_busy(lp))
        self.metrics.add_event(MetricsName.LANE_COUNT, lanes)

        # one tick for every lane (tick-batched mode); in per-message
        # mode the barrier still needs a deterministic re-evaluation
        # pulse for its idle-advance law
        self._tick_timer = drive_lane_ticks(
            self.timer, self.config, self.lane_pools,
            barrier=self.barrier, trace=self.trace, metrics=self.metrics)
        self.governor = getattr(self._tick_timer, "governor", None)
        self._pulse_timer = None
        if self._tick_timer is None:
            self._pulse_timer = RepeatingTimer(
                self.timer, 0.05, self._barrier_pulse, barrier=True)

    def _barrier_pulse(self) -> None:
        self.barrier.service_tick()
        for lane, lane_pool in enumerate(self.lane_pools):
            self.metrics.add_event(
                "%s.%d" % (MetricsName.LANE_ORDERED, lane),
                min(len(nd.ordered_digests) for nd in lane_pool.nodes))

    # --- traffic --------------------------------------------------------

    def submit_request(self, seq: int,
                       client_id: Optional[str] = None) -> Request:
        """Build the request, route it by its key, submit it to the
        owning lane."""
        req = self.lane_pools[0].build_request(seq)
        lane = self.router.route(req)
        self.lane_pools[lane].submit_built(req, client_id)
        return req

    def submit_to_lane(self, seq: int, lane: int) -> Request:
        """Targeted (un-routed) submission — barrier flush padding and
        tests; real client traffic goes through :meth:`submit_request`."""
        req = self.lane_pools[lane].build_request(seq)
        self.lane_pools[lane].submit_built(req)
        return req

    def run_for(self, seconds: float) -> None:
        self.timer.advance(seconds)

    # --- seal flush -----------------------------------------------------

    def seal_flush(self, seq_base: int = 10_000_000,
                   max_sim_s: float = 300.0) -> int:
        """Drive every lane to a sealed boundary: pad each lane to its
        next checkpoint boundary (single-request batches — the
        simulation stand-in for freshness empty batches) and run until
        the barrier has sealed every executed window. Returns the number
        of pad requests submitted. Deterministic: two same-seed runs pad
        identically."""
        chk = self.config.CHK_FREQ
        seq = seq_base
        spent = 0.0
        while spent < max_sim_s:
            self.run_for(0.5)
            spent += 0.5
            all_idle = True
            for lane, lane_pool in enumerate(self.lane_pools):
                if _lane_busy(lane_pool):
                    all_idle = False
                    continue
                last = max(nd.data.last_ordered_3pc[1]
                           for nd in lane_pool.nodes)
                if last % chk != 0:
                    self.submit_to_lane(seq, lane)
                    seq += 1
                    all_idle = False
            if all_idle and self.barrier.sealed_window >= max(
                    self.barrier.window_of(
                        max(nd.data.last_ordered_3pc[1]
                            for nd in lane_pool.nodes))
                    for lane_pool in self.lane_pools):
                return seq - seq_base
        raise AssertionError(
            f"seal_flush did not converge within {max_sim_s} sim-s: "
            f"{self.counters()}")

    # --- fingerprints / agreement --------------------------------------

    def honest_nodes_agree(self) -> bool:
        return all(lp.honest_nodes_agree() for lp in self.lane_pools)

    def ordered_hashes(self) -> List[str]:
        """Per-lane ordering fingerprints, lane order."""
        return [lp.ordered_hash() for lp in self.lane_pools]

    @property
    def sealed_fingerprint(self) -> str:
        """The barrier chain tip — THE cross-lane ordering fingerprint."""
        return self.barrier.seal_fingerprint

    def ordered_total(self) -> int:
        return sum(min(len(nd.ordered_digests) for nd in lp.nodes)
                   for lp in self.lane_pools)

    def ordered_per_lane(self) -> List[int]:
        return [min(len(nd.ordered_digests) for nd in lp.nodes)
                for lp in self.lane_pools]

    def counters(self) -> dict:
        return {
            "lanes": self.n_lanes,
            "ordered_per_lane": self.ordered_per_lane(),
            "router": self.router.counters(),
            "barrier": self.barrier.counters(),
        }
