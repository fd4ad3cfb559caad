"""The R in RBFT: compare the master instance against the backups.

Reference: plenum/server/monitor.py (`Monitor`). Every protocol instance
orders the same client requests under a different primary; the monitor
measures per-instance throughput (and master-vs-backup request latency)
and, when the master's ratio drops below Delta — a slow-but-alive
byzantine (or just slow) master primary — votes for a view change so a
backup's primary takes over. Crash faults are caught by the primary
connection monitor; THIS is what catches a primary that stays alive but
throttles the pool.

Checks (reference Monitor.isMasterDegraded):
- throughput: master_tp / avg(backup_tps) < DELTA
- latency: avg master latency - avg backup latency > OMEGA  (per-request
  durations from finalisation to ordering)
Both sides must be warmed up (ThroughputMinCnt events) before judging.

Copy of ``indy_plenum_tpu/server/monitor.py``, with its imports bound to
the port. The monitor is host code: it reads the ordering events the node
hands it and the port's metrics collector, telemetry plane and trace
recorder.
"""
from __future__ import annotations

import logging
from typing import Dict, List, Optional

from ..common.event_bus import InternalBus
from ..common.messages.internal_messages import VoteForViewChange
from ..common.timer import RepeatingTimer, TimerService
from .suspicion_codes import Suspicions
from .throughput_measurement import (
    LatencyMeasurement,
    WindowedThroughputMeasurement,
)

logger = logging.getLogger(__name__)


class Monitor:
    def __init__(self,
                 name: str,
                 timer: TimerService,
                 bus: InternalBus,
                 config,
                 num_instances: int,
                 metrics=None,
                 trace=None):
        self._name = name
        self._timer = timer
        self._bus = bus
        self._config = config
        # dispatch-plane observability: when the node's collector is
        # handed in, snapshot() surfaces the device amortization numbers
        # (dispatches per tick, flush occupancy) next to the RBFT ratios
        self._metrics = metrics
        # consensus flight recorder: snapshot() derives the per-phase
        # 3PC latency percentiles from its lifecycle marks
        self._trace = trace
        # digest -> finalisation timestamp (latency measurement base)
        self._finalised_at: Dict[str, float] = {}
        self._throughputs: List[WindowedThroughputMeasurement] = []
        self._latencies: List[LatencyMeasurement] = []
        self.reset(num_instances)
        self.degradation_votes = 0  # observability / tests

        self._check_timer = RepeatingTimer(
            timer, config.PerfCheckFreq, self.service_check, active=False)

    def start(self) -> None:
        self._check_timer.start()

    def stop(self) -> None:
        self._check_timer.stop()

    # ------------------------------------------------------------------
    # feeding
    # ------------------------------------------------------------------

    def reset(self, num_instances: Optional[int] = None) -> None:
        """View change / instance count change: all measurements restart
        (the old master's stats must not taint the new one)."""
        if num_instances is None:
            num_instances = len(self._throughputs)
        now = self._timer.get_current_time()
        self._throughputs = [
            WindowedThroughputMeasurement(
                window_size=self._config.ThroughputWindowSize,
                min_cnt=self._config.ThroughputMinCnt,
                first_ts=now)
            for _ in range(num_instances)]
        self._latencies = [
            LatencyMeasurement(self._config.LatencyWindowSize)
            for _ in range(num_instances)]
        # latency bases from before the reset are meaningless against the
        # new measurements (and would otherwise leak across view changes)
        self._finalised_at.clear()

    def request_finalised(self, digest: str) -> None:
        self._finalised_at.setdefault(
            digest, self._timer.get_current_time())
        # opportunistic TTL pruning: on a single-instance node the check
        # timer never runs, and digests executed via catchup emit no
        # master Ordered — without this the dict grows for the process
        # lifetime
        if len(self._finalised_at) % 1024 == 0:
            self._prune_finalised()

    def _prune_finalised(self) -> None:
        now = self._timer.get_current_time()
        ttl = self._config.INSTANCE_CHANGE_TIMEOUT
        for d in [d for d, t in self._finalised_at.items()
                  if now - t > ttl]:
            del self._finalised_at[d]

    def requests_ordered(self, inst_id: int, digests: List[str]) -> None:
        if inst_id >= len(self._throughputs):
            return
        now = self._timer.get_current_time()
        self._throughputs[inst_id].add_request(now, count=len(digests))
        lat = self._latencies[inst_id]
        for d in digests:
            t0 = self._finalised_at.get(d)
            if t0 is not None:
                lat.add_duration(now - t0)
        if inst_id == 0:  # master ordered: the latency base is consumed
            for d in digests:
                self._finalised_at.pop(d, None)

    # ------------------------------------------------------------------
    # judging
    # ------------------------------------------------------------------

    def snapshot(self) -> Dict[str, object]:
        """Observability view for reports (chaos runs, diagnostics):
        per-instance throughput, the master/backup ratio the Delta check
        judges, and how often this node voted the master degraded."""
        now = self._timer.get_current_time()
        snap = {
            "throughput_per_instance": [
                t.get_throughput(now) for t in self._throughputs],
            "master_throughput_ratio": self.master_throughput_ratio(),
            "degradation_votes": self.degradation_votes,
        }
        if self._metrics is not None:
            from ..common.metrics_collector import MetricsName

            device = {}
            for label, name in (
                    ("dispatches_per_tick",
                     MetricsName.DEVICE_DISPATCHES_PER_TICK),
                    ("flush_occupancy",
                     MetricsName.DEVICE_FLUSH_OCCUPANCY),
                    ("flushes", MetricsName.DEVICE_FLUSH)):
                stat = self._metrics.stat(name)
                if stat is not None:
                    device[label] = {"count": stat.count,
                                     "avg": round(stat.avg, 4)}
            # adaptive tick (dispatch governor): the CURRENT effective
            # interval plus the dwell histogram — how the pool's tick
            # travelled between its bounds this run
            tick = self._metrics.stat(MetricsName.GOVERNOR_TICK_INTERVAL)
            if tick is not None:
                device["tick_interval"] = {
                    "current": tick.last,
                    "min": tick.min,
                    "max": tick.max,
                    "histogram": self._metrics.histogram(
                        MetricsName.GOVERNOR_TICK_INTERVAL),
                }
                ewma = self._metrics.stat(
                    MetricsName.GOVERNOR_OCCUPANCY_EWMA)
                if ewma is not None:
                    device["occupancy_ewma"] = round(ewma.last, 4)
            # mesh-sharded dispatch plane: mesh width + each shard's
            # CUMULATIVE occupancy (sum votes / sum real-row capacity —
            # the same VotePlaneGroup.shard_occupancy number bench, the
            # budget gate and profile_rbft report, NOT an average of
            # per-dispatch ratios, which diverges once flush shapes vary)
            # ordering fast path: what actually crosses the device->host
            # boundary per absorb, and which eval mode produced it
            # (compact deltas by default; the full event matrix under
            # the host_eval differential fallback)
            rb = self._metrics.stat(MetricsName.DEVICE_READBACK_BYTES)
            if rb is not None:
                device["readback"] = {
                    "bytes_total": int(rb.total),
                    "bytes_per_readback": round(rb.avg, 1),
                    "readbacks": rb.count,
                }
                mode = self._metrics.stat(
                    MetricsName.DEVICE_READBACK_COMPACT)
                if mode is not None:
                    device["eval_mode"] = ("device" if mode.last
                                           else "host")
            # multi-tick residency: present only when a group ran with
            # ResidentTickDepth > 1 — zero-residency snapshots stay
            # byte-compatible
            depth = self._metrics.stat(MetricsName.DEVICE_RESIDENT_DEPTH)
            if depth is not None and depth.last:
                rt = self._metrics.stat(MetricsName.DEVICE_RESIDENT_TICKS)
                rd = self._metrics.stat(
                    MetricsName.DEVICE_READBACKS_DEFERRED)
                device["residency"] = {
                    "resident_depth": int(depth.last),
                    "resident_ticks": int(rt.count) if rt else 0,
                    "readbacks_deferred": int(rd.count) if rd else 0,
                }
            shard_count = self._metrics.stat(MetricsName.DEVICE_SHARD_COUNT)
            if shard_count is not None and shard_count.last:
                n_shards = int(shard_count.last)
                occ_per_shard = []
                for si in range(n_shards):
                    votes = self._metrics.stat(
                        f"{MetricsName.DEVICE_SHARD_FLUSH_VOTES}.{si}")
                    cap = self._metrics.stat(
                        f"{MetricsName.DEVICE_SHARD_FLUSH_CAPACITY}.{si}")
                    occ_per_shard.append(
                        round(votes.total / cap.total, 4)
                        if votes and cap and cap.total else None)
                device["shards"] = n_shards
                device["shard_occupancy"] = occ_per_shard
            if device:
                snap["device_dispatch"] = device
            # ingress plane (admission control + device-proof reads):
            # the bounded queue's current/peak depth, the admitted/shed
            # totals the shed policy produced, and the read path's
            # served count + qps gauge (virtual-clock derived, so
            # snapshots replay byte-identically). Absent entirely when
            # the run never recorded ingress metrics (admission off, no
            # reads) — existing snapshots stay byte-compatible.
            ingress = {}
            depth = self._metrics.stat(MetricsName.INGRESS_QUEUE_DEPTH)
            if depth is not None:
                ingress["queue_depth"] = {"current": depth.last,
                                          "max": depth.max}
            for label, name in (
                    ("admitted", MetricsName.INGRESS_ADMITTED),
                    ("shed", MetricsName.INGRESS_SHED),
                    ("retries", MetricsName.INGRESS_RETRIES),
                    ("retry_exhausted",
                     MetricsName.INGRESS_RETRY_EXHAUSTED),
                    ("read_served", MetricsName.READ_SERVED)):
                stat = self._metrics.stat(name)
                if stat is not None:
                    ingress[label] = int(stat.total)
            # closed-loop retry goodput: the share of admitted work that
            # got in on its FIRST attempt (retry admissions are recovered
            # capacity, not fresh goodput) — present only when the run
            # recorded retries, so pre-overload-plane snapshots stay
            # byte-compatible
            if "retries" in ingress and ingress.get("admitted"):
                readmitted = self._metrics.stat(
                    MetricsName.INGRESS_RETRY_ADMITTED)
                readmitted_n = int(readmitted.total) \
                    if readmitted is not None else 0
                ingress["goodput_fraction"] = round(
                    (ingress["admitted"] - readmitted_n)
                    / ingress["admitted"], 4)
            read_qps = self._metrics.stat(MetricsName.READ_QPS)
            if read_qps is not None:
                ingress["read_qps"] = round(read_qps.last, 1)
            # read-path backpressure (state-proof plane satellite): the
            # read queue's own bounded-queue numbers, segregated from
            # the write side's
            read_depth = self._metrics.stat(MetricsName.READ_QUEUE_DEPTH)
            if read_depth is not None:
                ingress["read_queue_depth"] = {"current": read_depth.last,
                                               "max": read_depth.max}
            read_shed = self._metrics.stat(MetricsName.READ_SHED)
            if read_shed is not None:
                ingress["read_shed"] = int(read_shed.total)
            if ingress:
                snap["ingress"] = ingress
            # state-proof plane: windows captured, serve-path hit/miss
            # split, reads served WITH a pool proof, and the pairing
            # work the batched verifier performed — absent entirely when
            # the run never recorded proof metrics (plane off)
            proofs = {}
            for label, name in (
                    ("windows_signed", MetricsName.PROOF_WINDOWS_SIGNED),
                    ("cache_hits", MetricsName.PROOF_CACHE_HIT),
                    ("cache_misses", MetricsName.PROOF_CACHE_MISS),
                    ("proofs_served", MetricsName.PROOF_SERVED),
                    ("pairings", MetricsName.PROOF_PAIRINGS)):
                stat = self._metrics.stat(name)
                if stat is not None:
                    proofs[label] = int(stat.total)
            if proofs:
                snap["proofs"] = proofs
            # catchup plane (chaos-hardened recovery): leecher rounds
            # completed, txns fetched+applied, audit proofs verified on
            # leeched batches, byzantine reps rejected, and retry-law
            # re-requests — absent entirely when the node never leeched
            catchup = {}
            for label, name in (
                    ("rounds", MetricsName.CATCHUP_ROUNDS),
                    ("txns_leeched", MetricsName.CATCHUP_TXNS_LEECHED),
                    ("proofs_verified",
                     MetricsName.CATCHUP_PROOFS_VERIFIED),
                    ("reps_rejected", MetricsName.CATCHUP_REPS_REJECTED),
                    ("retries", MetricsName.CATCHUP_RETRIES),
                    ("failed", MetricsName.CATCHUP_FAILED)):
                stat = self._metrics.stat(name)
                if stat is not None:
                    catchup[label] = int(stat.total)
            if catchup:
                snap["catchup"] = catchup
            # ordering lanes (lanes/): lane count, per-lane ordered
            # totals and router assignments, and the cross-lane
            # barrier's sealed window + seal lag (first lane ready ->
            # sealed, virtual seconds) — absent entirely when the run
            # never recorded lane metrics (single-lane pools)
            lane_count = self._metrics.stat(MetricsName.LANE_COUNT)
            if lane_count is not None and lane_count.last:
                n_lanes = int(lane_count.last)
                lanes: Dict[str, object] = {"count": n_lanes}
                ordered, routed = [], []
                for li in range(n_lanes):
                    stat = self._metrics.stat(
                        f"{MetricsName.LANE_ORDERED}.{li}")
                    ordered.append(int(stat.last) if stat else 0)
                    stat = self._metrics.stat(
                        f"{MetricsName.LANE_ROUTED}.{li}")
                    routed.append(int(stat.total) if stat else 0)
                lanes["ordered_per_lane"] = ordered
                lanes["router_distribution"] = routed
                barrier = {}
                sealed = self._metrics.stat(
                    MetricsName.LANE_SEALED_WINDOW)
                if sealed is not None:
                    barrier["sealed_window"] = int(sealed.last)
                    barrier["seals"] = sealed.count
                lag = self._metrics.stat(
                    MetricsName.LANE_BARRIER_SEAL_LAG)
                if lag is not None:
                    barrier["seal_lag"] = {
                        "last": round(lag.last, 6),
                        "avg": round(lag.avg, 6),
                        "max": round(lag.max, 6),
                    }
                if barrier:
                    lanes["barrier"] = barrier
                snap["lanes"] = lanes
            # long-horizon telemetry plane (observability/telemetry.py):
            # rolled-window / fired-anomaly meters plus per-resource
            # occupancy gauges (last = at the latest roll, high_water =
            # max over rolls) — absent entirely when the run never
            # armed the plane (TelemetryWindowSec = 0)
            windows = self._metrics.stat(MetricsName.TELEMETRY_WINDOWS)
            if windows is not None and windows.count:
                from ..observability.telemetry import (
                    RESOURCE_METRIC_PREFIX,
                )

                telemetry: Dict[str, object] = {
                    "windows": int(windows.total)}
                fired = self._metrics.stat(
                    MetricsName.TELEMETRY_ANOMALIES)
                telemetry["anomalies"] = \
                    int(fired.total) if fired is not None else 0
                resources: Dict[str, object] = {}
                for name, stat in self._metrics.summary().items():
                    if name.startswith(RESOURCE_METRIC_PREFIX):
                        resources[name[len(RESOURCE_METRIC_PREFIX):]] = {
                            "last": int(stat["last"]),
                            "high_water": int(stat["max"]),
                        }
                if resources:
                    telemetry["resources"] = resources
                snap["telemetry"] = telemetry
        if self._trace is not None and self._trace.enabled:
            # per-phase latency attribution (flight recorder): where this
            # node's ordered batches spent their time — prepare / commit
            # / order / execute (+ the pool's auth phase) as p50/p90/p99
            from ..observability.trace import phase_percentiles

            phases = phase_percentiles(self._trace.events(),
                                       node=self._name)
            if phases:
                snap["phase_latency"] = phases
            # pool-rollup end-to-end latency (causal tracing plane):
            # journeys join the recorder's cross-node marks, so the
            # block reports what a CLIENT experienced — e2e percentiles
            # per request class, per-hop percentiles, and where the
            # time went (network / queue / compute / device-dispatch).
            # Pool-level on purpose: a journey spans nodes, so every
            # node's snapshot reports the same rollup.
            from ..observability.causal import journey_summary

            # the rollup is pool-level and the recorder is pool-shared:
            # cache it ON the recorder keyed by its event seq, so an
            # n-node snapshot sweep computes the journey table once per
            # ring generation instead of n times
            cache = getattr(self._trace, "_journey_rollup", None)
            if cache is not None and cache[0] == self._trace._seq:
                js = cache[1]
            else:
                js = journey_summary(self._trace.events())
                self._trace._journey_rollup = (self._trace._seq, js)
            if js["count"] or js["e2e"]["read"]["count"]:
                snap["e2e_latency"] = {
                    "write": js["e2e"]["write"],
                    "read": js["e2e"]["read"],
                    "complete": js["complete"],
                    "orphan_spans": js["orphan_spans"],
                    "hop_percentiles": js["hop_percentiles"],
                    "attribution_share": js["attribution_share"],
                    "journey_hash": js["journey_hash"],
                }
        return snap

    def master_throughput_ratio(self) -> Optional[float]:
        if len(self._throughputs) < 2:
            return None
        now = self._timer.get_current_time()
        master = self._throughputs[0].get_throughput(now)
        backups = [t.get_throughput(now) for t in self._throughputs[1:]]
        backups = [b for b in backups if b is not None]
        if not backups:
            return None
        avg = sum(backups) / len(backups)
        if avg == 0:
            return None
        if master is None:
            master = 0.0  # backups warmed up, master ordered ~nothing
        return master / avg

    def is_master_degraded(self) -> bool:
        ratio = self.master_throughput_ratio()
        if ratio is not None and ratio < self._config.DELTA:
            return True
        return self._is_master_latency_high()

    def _is_master_latency_high(self) -> bool:
        if len(self._latencies) < 2:
            return False
        master = self._latencies[0].get_avg_latency()
        if master is not None and master > self._config.LAMBDA:
            # RBFT Λ (Aublin et al. §IV): the master's ABSOLUTE request
            # latency bound — a master slow against the wall even when
            # every backup is equally slow (Ω alone cannot see that)
            return True
        backups = [l.get_avg_latency() for l in self._latencies[1:]]
        backups = [b for b in backups if b is not None]
        if master is None or not backups:
            return False
        return master - (sum(backups) / len(backups)) > self._config.OMEGA

    def service_check(self) -> None:
        self._prune_finalised()
        if self.is_master_degraded():
            self.degradation_votes += 1
            ratio = self.master_throughput_ratio()
            logger.info("%s master degraded (ratio=%s) -> vote view change",
                        self._name, ratio)
            self._bus.send(VoteForViewChange(
                view_no=None, suspicion=Suspicions.PRIMARY_DEGRADED))
