"""Configuration: every protocol tunable in one overridable namespace.

Reference: plenum/config.py (module-as-schema, ~200 attrs) with the overlay
chain from plenum/common/config_util.py (``getConfig``: package defaults ->
general config file -> network-specific -> user overrides). Here the schema
is a dataclass; overlays are dicts (loaded from JSON files or passed
directly), applied in order.

Copy of ``indy_plenum_tpu/config.py``, with its imports bound to the port.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass
class Config:
    # --- 3PC batching (reference: Max3PCBatchSize / Max3PCBatchWait) ------
    Max3PCBatchSize: int = 100
    Max3PCBatchWait: float = 0.25  # seconds

    # --- watermarks / checkpointing (LOG_SIZE, CHK_FREQ) ------------------
    CHK_FREQ: int = 100
    LOG_SIZE: int = 300  # = H - h window

    # --- RBFT monitor thresholds (Delta / Lambda / Omega) -----------------
    DELTA: float = 0.4  # min master/backup throughput ratio
    LAMBDA: float = 240.0  # max master latency excess (s)
    OMEGA: float = 20.0  # max avg latency gap master vs backups (s)
    ThroughputWindowSize: int = 15
    ThroughputMinCnt: int = 16
    LatencyWindowSize: int = 15
    PerfCheckFreq: float = 10.0  # monitor degradation check cadence (s)

    # --- freshness --------------------------------------------------------
    # idle pools re-sign their state roots periodically (an empty 3PC
    # batch): without this, proved reads go stale once writes stop
    # (reference: STATE_FRESHNESS_UPDATE_INTERVAL). Must sit WELL below
    # the client's proof max age (300s) so reads arriving just before a
    # freshness batch still verify.
    StateFreshnessUpdateInterval: float = 120.0  # 0 disables

    # --- view change ------------------------------------------------------
    ToleratePrimaryDisconnection: float = 2.0  # seconds
    OldViewPPRequestInterval: float = 1.0  # re-fetch missing old-view PPs
    NewViewTimeout: float = 30.0  # restart VC with v+1 if not completed
    # the canonical PBFT liveness timer (Castro & Liskov §4.5.2): a master
    # replica with work pending but no ordering progress across a full
    # interval votes INSTANCE_CHANGE (detection latency is 1-2 intervals;
    # 0 disables). Recovers from in-flight 3PC messages lost for good —
    # e.g. after a partition heals — which no retransmit path covers.
    OrderingStallTimeout: float = 12.0
    INSTANCE_CHANGE_TIMEOUT: float = 300.0  # discard stale instance changes

    # --- catchup ----------------------------------------------------------
    CatchupTransactionsTimeout: float = 6.0
    ConsistencyProofsTimeout: float = 5.0
    CatchupBatchSize: int = 5000  # txns per CATCHUP_REQ slice
    # Per-slice leecher retry law (server/catchup/retry.py): an unanswered
    # CATCHUP_REQ slice is re-assigned to another peer after
    # CatchupRequestTimeout (0 = fall back to CatchupTransactionsTimeout,
    # the pre-retry-law knob), each further silence backs the slice's
    # deadline off multiplicatively (CatchupRetryBackoffMult) with seeded
    # jitter (CatchupRetryJitterFrac of the delay, derived from
    # CatchupRetryJitterSeed | slice | attempt — deterministic, so seeded
    # sim runs replay identical retry schedules), and after
    # CatchupMaxRetries exhausted slices FAIL the round closed (the
    # leecher's CatchupFailedRetryBackoff path) instead of re-asking
    # forever — a silent seeder pool can delay recovery, never stall it.
    CatchupRequestTimeout: float = 0.0
    CatchupMaxRetries: int = 10
    CatchupRetryBackoffMult: float = 1.5
    CatchupRetryBackoffMax: float = 60.0
    CatchupRetryJitterFrac: float = 0.25
    CatchupRetryJitterSeed: int = 0
    # fail-closed retry: a node whose catchup FAILED (history convicted as
    # diverged but no honest quorum reachable, or a slice exhausted its
    # retry budget) stays non-participating and retries with exponential
    # backoff between these bounds
    CatchupFailedRetryBackoff: float = 10.0
    CatchupFailedRetryBackoffMax: float = 300.0
    # Seeder-side throttle (server/catchup/seeder_service.py): a token
    # bucket (txns/sec refill on the node's clock, Burst capacity) caps
    # how fast a seeder answers CATCHUP_REQs — a pool seeding a
    # returning node under ingress saturation must not stall its own
    # ordering to feed the leecher. A dry bucket DEFERS the reply to the
    # deterministic instant the tokens accrue (never drops it); the
    # leecher's retry law tolerates the delay. 0 = unthrottled.
    CatchupSeederThrottleTxnsPerSec: float = 0.0
    CatchupSeederThrottleBurst: int = 200

    # --- propagation ------------------------------------------------------
    PropagateBatchWait: float = 0.1

    # --- transport --------------------------------------------------------
    OUTGOING_BATCH_SIZE: int = 100
    MSG_LEN_LIMIT: int = 128 * 1024

    # --- geo plane: regional latency realism (simulation/sim_network.py) --
    # Number of simulated regions. 0 = single-region (the pre-geo
    # behaviour: one uniform latency band, byte-identical to every
    # earlier seed — region mode consumes exactly the same ONE rng draw
    # per delivery, only the band bounds change). > 0 assigns node i to
    # region i % RegionCount and draws cross-region deliveries from the
    # pair's seeded WAN band instead of the intra-region fast band.
    RegionCount: int = 0
    # WAN envelope: every cross-region pair gets a deterministic
    # (lo, hi) latency band inside [RegionWanMinLatency,
    # RegionWanMaxLatency), derived from RegionLatencySeed — the
    # inter-region latency matrix. Intra-region pairs keep the
    # SimNetwork min/max_latency fast band.
    RegionWanMinLatency: float = 0.08
    RegionWanMaxLatency: float = 0.25
    # Seed for the pair-band matrix. 0 = simulation pools fall back to
    # the pool seed, so a seeded run replays the identical matrix.
    RegionLatencySeed: int = 0

    # --- geo plane: edge proof-cache tier (proofs/edge_cache.py) ----------
    # Region-local UNTRUSTED replicas of the last sealed windows'
    # proof-attached replies. The edge holds at most this many sealed
    # windows' corpora; older windows evict when a new seal replicates
    # in (the CheckpointStabilized invalidation rule).
    EdgeProofCacheKeepWindows: int = 2
    # Bounded LRU entry cap per edge (replies across all held windows).
    # Misses fall back to the home-region validator over the WAN.
    EdgeProofCacheMaxEntries: int = 4096
    # Freshness bound clients fold into verify_proved_read against edge
    # replies: a held window older than this (vs the client's clock) is
    # treated as stale and the client falls back to the origin.
    EdgeProofCacheMaxAge: float = 300.0

    # --- device plane (TPU) ----------------------------------------------
    # Quorum evaluation cadence when the device vote plane is authoritative.
    # 0 = evaluate on every message (one padded device flush per query —
    # correct but unamortized); > 0 = defer quorum queries to a repeating
    # tick so all votes recorded in between ride ONE device flush
    # (vote_plane.py's batching contract; the Node event-loop mode).
    QuorumTickInterval: float = 0.0
    # Adaptive tick (dispatch governor, tpu/governor.py): the tick
    # interval becomes a closed-loop control variable — widened while the
    # observed flush occupancy is sparse (fewer near-empty scatters),
    # narrowed while a tick overflows one grouped step or runs hot
    # (lower quorum latency at no extra dispatch cost). The controller is
    # a pure function of the per-tick metrics, so seeded runs (incl.
    # chaos) replay to the identical interval trajectory.
    QuorumTickAdaptive: bool = False
    QuorumTickIntervalMin: float = 0.0  # 0 -> QuorumTickInterval / 4
    QuorumTickIntervalMax: float = 0.0  # 0 -> QuorumTickInterval * 4
    GovernorEwmaAlpha: float = 0.3  # weight of the newest tick's occupancy
    GovernorOccupancyLow: float = 0.02  # EWMA below this widens the tick
    GovernorOccupancyHigh: float = 0.85  # EWMA above this narrows it
    GovernorWiden: float = 1.5  # multiplicative widen step
    GovernorNarrow: float = 0.5  # multiplicative narrow step
    # Adaptive flush ladder (vote_plane.AdaptiveLadder): the grouped
    # dispatch plane learns its top padded-scatter rung from the
    # observed busiest-member votes-per-dispatch distribution (p99
    # rounded up to a power of two, clamped to the static FLUSH_LADDER
    # bounds), so a small pool stops compiling and paying the 128-wide
    # rung. Deterministic (pure function of the dispatch series);
    # learning only starts after a warm-up window, so short runs keep
    # the static ladder's exact behaviour.
    FlushLadderAdaptive: bool = True
    # Multi-tick device residency (tpu/vote_plane.py): with depth N > 1
    # the tick-batched group ENQUEUES each tick's scatter words into a
    # device-side ring (async device_put — a transfer, not an XLA
    # dispatch) and dispatches ONE fused step per up-to-N ticks, with
    # checkpoint slides folded in as per-slot operands — quorum verdicts
    # may lag up to N ticks but ordered CONTENT is bit-identical to the
    # per-tick path (the timing-robustness law; the residency gate
    # asserts it). 1 = off (the per-tick behaviour, bit-exact).
    # Device-eval only: host_eval groups fall back to per-tick.
    ResidentTickDepth: int = 1
    # Occupancy-driven shard rebalancing (tpu/rebalance.py): when the
    # hottest member block's occupancy EWMA exceeds the median by this
    # factor for RebalanceDwellTicks consecutive ticks, the policy plans
    # a member-plane rotation (ring_shift_planes) executed at the next
    # checkpoint-boundary slide — the rebalance barrier. 0 = disabled
    # (the policy is not even constructed). Member-sharded groups only.
    RebalanceSkewThreshold: float = 0.0
    RebalanceDwellTicks: int = 8
    # Testing/chaos hook: force ONE planned rotation at exactly this
    # tick ordinal regardless of skew (0 = off) — digest-identity arms
    # rebalance deterministically without engineering a hot shard.
    RebalanceForceTick: int = 0

    # --- ingress plane (admission control + backpressure) -----------------
    # Bounded auth queue (ingress/admission.py): client writes queue up to
    # this many entries between dispatch ticks; overflow sheds
    # deterministically (drop-newest, seeded tiebreak). 0 = unbounded
    # (admission control off — the unbounded ingress list).
    IngressQueueCapacity: int = 0
    # Per-client fairness cap: a client with this many requests already
    # queued is shed outright (0 = no cap). One hot wallet must not
    # starve the population.
    IngressPerClientCap: int = 0
    # Shed tiebreak seed for DEPLOYED nodes (simulation pools use the
    # pool seed so the shed set replays with the run).
    IngressShedSeed: int = 0
    # Backpressure law (governor.feed_backpressure): pre-drain queue
    # depth at or above this fraction of capacity counts as queue growth
    # and narrows the tick.
    GovernorBackpressureQueueFrac: float = 0.5
    # Read-path backpressure (ingress/read_service.py): bounded read
    # queue with the same seeded drop-newest shed law as writes, so a
    # read flood cannot starve the drain. 0 = unbounded (pre-proof-plane
    # behaviour). The shed tiebreak shares IngressShedSeed.
    IngressReadQueueCapacity: int = 0

    # --- closed-loop retry (ingress/retry.py) -----------------------------
    # Per-client retry of shed/NACKed requests: the overload-robustness
    # plane's client model. A shed request re-offers after a seeded
    # exponential backoff (base * mult^(attempt-1), capped, stretched by
    # sha256(seed|digest|attempt) jitter) up to IngressRetryMax attempts,
    # then the client gives up (counted under ingress.retry_exhausted).
    # 0 = open loop (the pre-overload-plane behaviour). Every re-offer
    # re-enters admission: it counts against the fairness cap and
    # competes in the same-instant shed cohort — no retry side door.
    IngressRetryMax: int = 0
    IngressRetryBase: float = 0.25
    IngressRetryBackoffMult: float = 2.0
    IngressRetryBackoffMax: float = 30.0
    IngressRetryJitterFrac: float = 0.5

    # --- workload profiles (ingress/workload.py) --------------------------
    # Rate modulation for the open-loop generator: the diurnal curve's
    # period and trough/peak multipliers, and the flash crowd's spike
    # window (offset into the arrival window + duration) and peak
    # multiplier (shared with diurnal's crest). Pure functions of
    # virtual time — profiled runs replay byte-identically.
    WorkloadProfilePeriod: float = 20.0
    WorkloadProfileTrough: float = 0.5
    WorkloadProfilePeak: float = 3.0
    WorkloadProfileFlashAt: float = 0.0
    WorkloadProfileFlashDuration: float = 2.0

    # --- ordering lanes (lanes/) ------------------------------------------
    # Keyspace-partitioned write path: the request keyspace splits across
    # this many independent ordering lanes, each a full master-instance
    # vote plane on its own slice of the fabric mesh, with a cross-lane
    # checkpoint barrier keeping state proofs and catchup on one
    # consistent stabilized window. 0/1 = single-lane (the pre-lanes
    # behaviour; LanedPool treats both as one lane).
    OrderingLanes: int = 0
    # Router law seed (sha256(seed | routing key) % lanes). 0 = simulation
    # pools fall back to the pool seed, so a seeded run replays the
    # byte-identical lane assignment.
    LaneRouterSeed: int = 0
    # Sealed-window records (per-lane digest lists, per-window chain
    # values) the barrier retains for verification — the chain TIP is
    # O(1) state either way. 0 = retain everything (bounded sim runs,
    # full-chain recomputation in the cross_lane invariant); a deployed
    # pool should bound this like StateProofCacheWindows.
    LaneBarrierKeepWindows: int = 0

    # --- state-proof plane (proofs/) --------------------------------------
    # Stabilized checkpoint windows whose pool multi-signature stays
    # servable from the CheckpointProofCache; older windows GC with the
    # checkpoint floor. 0 disables the proof plane (reads fall back to
    # local-root proofs only). Nodes build the cache only when they also
    # run a BLS replica — there is nothing to capture without one.
    StateProofCacheWindows: int = 2

    # --- state-commit plane (state/sparse_merkle_state.py) ----------------
    # Batched O(delta) state commit: WriteRequestManager.apply_batch
    # buffers a 3PC batch's writes and flushes them through ONE bottom-up
    # SMT walk (last-write-wins dedupe, each touched internal node hashed
    # once per batch) instead of a 256-hash path walk per write. False =
    # the pre-batch sequential set() loop (roots are bit-identical either
    # way — the state_gate asserts it).
    StateCommitBatchEnabled: bool = True
    # Write sets smaller than this skip the plan/wave machinery and apply
    # sequentially — below it, prefix sharing has nothing to share and
    # the plan-node overhead costs more than it saves.
    StateCommitBatchMin: int = 4
    # Placement of the per-level hash waves: "host" = hashlib loop,
    # "device" = force the batched tpu/sha256 kernel, "auto" = the
    # measured catchup offload policy decides per wave (DEVICE_MIN_BATCH
    # floor; host SHA wins on XLA:CPU, the kernel wins on real TPU).
    # Digests are bit-identical on either path — only nanoseconds move.
    StateCommitBatchMode: str = "auto"
    # Bounded LRU node cache fronting each state's KV store (entries are
    # immutable content-addressed nodes, so the cache never invalidates).
    # ~256 bytes/node -> the default is ~16 MB per stateful ledger.
    # 0 disables.
    StateNodeCacheSize: int = 65536

    # --- storage ----------------------------------------------------------
    # sqlite | memory
    KVStorageType: str = "sqlite"

    # --- request handling -------------------------------------------------
    # privileged actions must carry a node-clock timestamp this fresh
    # (replay window; seen digests are deduped inside it)
    ActionFreshnessWindow: float = 300.0

    # --- metrics / observability -----------------------------------------
    METRICS_COLLECTOR_TYPE: Optional[str] = "kv"
    # consensus flight recorder (observability.trace): span traces for
    # the 3PC lifecycle + dispatch plane. Disabled by default — recording
    # rides NULL_TRACE (zero-cost, like NullMetricsCollector); sim pools
    # enable it explicitly (trace=True) on the virtual clock so seeded
    # runs dump bit-identical traces, a deployed Node enables it here and
    # records perf_counter durations instead.
    TraceRecorderEnabled: bool = False
    TraceRecorderCapacity: int = 65536
    # causal tracing plane (observability.causal): when tracing is on,
    # the transports stamp net.send/net.recv marks for journey-joinable
    # message types. The 3PC waves are O(n^2) messages per batch, so
    # large-pool benches cap the stamped fan-out to deliveries into the
    # first K validators (0 = stamp every delivery) — the sampled set
    # keeps per-wave latency stats representative without drowning the
    # ring
    TraceNetReceivers: int = 0
    # long-horizon telemetry plane (observability/telemetry.py): windowed
    # rollups + resource ledger + drift laws on the virtual clock. 0 =
    # unarmed (no ledger, no plane, zero cost — the pre-telemetry pool).
    # Armed, the pool registers every bounded structure in one
    # ResourceLedger and rolls a time-series row every window, with the
    # running telemetry_hash chain byte-identical per seed.
    TelemetryWindowSec: float = 0.0
    # rollup rows the plane retains (the hash chain keeps fingerprinting
    # evicted rows with O(1) state, like the lane barrier's seal chain)
    TelemetryWindowKeep: int = 64
    # leak law: window high-water strictly increasing for this many
    # consecutive windows fires one anomaly per episode
    TelemetryLeakWindows: int = 4
    # windows exempt from the leak/creep laws while caches warm toward
    # their steady state (rings filling to capacity is not a leak)
    TelemetryLeakGraceWindows: int = 6
    # throughput law: ordered delta dropping by more than this fraction
    # against the window TelemetryDriftLag back is drift; set the lag to
    # profile-period/window so a diurnal trough compares to the same
    # phase a cycle earlier instead of reading as degradation
    TelemetryDriftFrac: float = 0.5
    TelemetryDriftLag: int = 1
    # anomaly records retained (total count and hash chain keep going)
    TelemetryAnomalyKeep: int = 32

    # --- virtual-day soak (simulation/soak.py) ----------------------------
    # the composed long-horizon arc: a diurnal day of real-execution
    # ordering with telemetry armed and chaos folded in — a GC-crossing
    # crash/catchup, a primary view change, and a forced shard rebalance.
    # Hours are offsets into the measured day (0 = that leg disabled).
    SoakHours: float = 24.0
    SoakRate: float = 0.1  # base writes/sec before the diurnal profile
    SoakKeys: int = 400  # distinct state keys the workload cycles over
    SoakCrashHour: float = 6.0  # non-primary crash (GC-crossing catchup)
    SoakCrashHours: float = 1.0  # outage length, in hours
    SoakViewChangeHour: float = 12.0  # primary partition -> view change
    SoakRebalanceTick: int = 5000  # RebalanceForceTick for the soak pool
    # logging (reference: stp logging config + rotating handler); the
    # five knobs below are consumed by tools/start_node.py (deployed
    # logging setup, through common/log.setup_logging)
    logLevel: str = "INFO"
    logRotationMaxBytes: int = 10 * 1024 * 1024
    logRotationBackupCount: int = 10
    logRotationWhen: str = "h"
    logRotationInterval: int = 1

    # --- plugins ----------------------------------------------------------
    # importable module paths, each exposing plugin_entry(node)
    PluginModules: Tuple[str, ...] = ()

    # --- misc -------------------------------------------------------------
    replicas_count_overrider: Optional[int] = None  # else f+1

    def governor_bounds(self) -> Tuple[float, float]:
        """Resolved (min, max) tick bounds for the adaptive governor; the
        0.0 defaults scale off the base interval so one knob still tunes
        a pool."""
        base = self.QuorumTickInterval
        lo = self.QuorumTickIntervalMin or base / 4.0
        hi = self.QuorumTickIntervalMax or base * 4.0
        return lo, hi

    def replicas_count(self, n_nodes: int) -> int:
        if self.replicas_count_overrider is not None:
            return self.replicas_count_overrider
        f_val = (n_nodes - 1) // 3
        return f_val + 1

    def overlay(self, overrides: Dict[str, Any]) -> "Config":
        unknown = set(overrides) - {fld.name for fld in dataclasses.fields(self)}
        if unknown:
            raise KeyError(f"unknown config keys: {sorted(unknown)}")
        return dataclasses.replace(self, **overrides)


_DEFAULT: Optional[Config] = None


def getConfig(overrides: Optional[Dict[str, Any]] = None,
              config_files: Tuple[str, ...] = ()) -> Config:
    """Overlay chain: defaults -> each JSON file in order -> overrides."""
    global _DEFAULT
    cfg = Config()
    for path in config_files:
        if os.path.exists(path):
            with open(path) as fh:
                cfg = cfg.overlay(json.load(fh))
    if overrides:
        cfg = cfg.overlay(overrides)
    if _DEFAULT is None and not overrides and not config_files:
        _DEFAULT = cfg
    return cfg
