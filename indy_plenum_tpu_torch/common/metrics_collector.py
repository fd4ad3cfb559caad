"""Metrics: named event accumulators + timing around the hot paths.

Copy of ``indy_plenum_tpu/common/metrics_collector.py`` (reference:
plenum/common/metrics_collector.py). Every event is (name, value); the
collector keeps running count/sum/min/max/last per name and bounded
histograms, and ``KvMetricsCollector`` persists periodic snapshots into a
key-value store (``storage/kv_store.initKeyValueStorage``) so a
long-running node's history survives restarts.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Any, Dict, Optional


class MetricsName:
    # ingress — AUTH_BATCH_* measures work the device actually verified;
    # the admission plane's shed/queue accounting lives under dedicated
    # ingress.* names so overload never pollutes the hot-path stats
    AUTH_BATCH_SIZE = "auth.batch_size"
    AUTH_BATCH_TIME = "auth.batch_time"
    # admission control (ingress/admission.py): pre-drain queue depth per
    # tick (Stat.last = current, max = the bound actually reached),
    # admitted/shed totals (Stat.total), and the device-proof read path's
    # batch sizes / served counts / wall-clock qps gauge
    INGRESS_QUEUE_DEPTH = "ingress.queue_depth"
    INGRESS_ADMITTED = "ingress.admitted"
    INGRESS_SHED = "ingress.shed"
    # closed-loop retry (ingress/retry.py): seeded-backoff re-offers the
    # retry driver actually fired, requests whose retry budget ran out
    # (fail closed), and admitted requests that needed >= 1 retry — the
    # goodput split: admitted - retry_admitted is first-attempt goodput
    INGRESS_RETRIES = "ingress.retries"
    INGRESS_RETRY_EXHAUSTED = "ingress.retry_exhausted"
    INGRESS_RETRY_ADMITTED = "ingress.retry_admitted"
    READ_BATCH_SIZE = "ingress.read_batch_size"
    READ_SERVED = "ingress.read_served"
    READ_QPS = "ingress.read_qps"
    # read-path backpressure: the read queue's own bounded-queue law
    # (same seeded drop-newest shed as writes) — pre-drain depth per
    # drain and shed totals, segregated from the write-side series
    READ_QUEUE_DEPTH = "ingress.read_queue_depth"
    READ_SHED = "ingress.read_shed"
    # state-proof plane (proofs/): windows captured per checkpoint
    # stabilization, serve-path hit/miss accounting (hits are dict
    # lookups — zero pairings, the proof gate's core assertion), reads
    # served WITH a pool proof attached, and the pairing work the
    # batched verifier actually performed
    PROOF_WINDOWS_SIGNED = "proof.windows_signed"
    PROOF_CACHE_HIT = "proof.cache_hit"
    PROOF_CACHE_MISS = "proof.cache_miss"
    PROOF_SERVED = "proof.served"
    PROOF_PAIRINGS = "proof.pairings"
    PROOF_VERIFY_BATCH = "proof.verify_batch"
    # 3PC
    BACKUP_ORDERED = "3pc.backup_ordered"
    ORDERED_BATCH_SIZE = "3pc.ordered_batch_size"
    # device plane
    DEVICE_FLUSH = "device.flush"
    DEVICE_FLUSH_TIME = "device.flush_time"
    DEVICE_FLUSH_VOTES = "device.flush_votes"
    # dispatch plane (tick-batched mode): how many device steps one tick
    # actually cost, and what fraction of each padded scatter carried
    # real votes. Together they are the measured amortization story —
    # device_dispatches_per_tick should sit near 1, flush_occupancy near
    # the votes-per-tick / padded-shape ratio (see README "Performance").
    DEVICE_DISPATCHES_PER_TICK = "device.dispatches_per_tick"
    DEVICE_FLUSH_OCCUPANCY = "device.flush_occupancy"
    # mesh-sharded dispatch plane: shard count (Stat.last = the current
    # mesh width) and per-shard vote/capacity counters, recorded as
    # "<prefix>.<shard_index>". Votes and capacity are separate series
    # (capacity counts REAL, non-pad rows only) so every consumer
    # derives the SAME cumulative occupancy — sum(votes)/sum(capacity),
    # the VotePlaneGroup.shard_occupancy definition — instead of an
    # average of per-dispatch ratios that diverges once flush shapes
    # vary. Only recorded when the group runs on a mesh (> 1 shard).
    DEVICE_SHARD_COUNT = "device.shard_count"
    DEVICE_SHARD_FLUSH_VOTES = "device.shard_flush_votes"
    DEVICE_SHARD_FLUSH_CAPACITY = "device.shard_flush_capacity"
    # ordering fast path (device-side quorum eval): bytes actually
    # crossing the device->host boundary per absorb — O(newly certified
    # + frontier) in device-eval mode, the full event matrix under the
    # host_eval fallback. DEVICE_READBACK_COMPACT records the mode as a
    # gauge (Stat.last: 1 = compact/device eval, 0 = host eval) so
    # snapshots can label the bytes they report.
    DEVICE_READBACK_BYTES = "device.readback_bytes"
    DEVICE_READBACK_COMPACT = "device.readback_compact"
    # multi-tick device residency (tpu/vote_plane.py): the configured
    # ring depth (gauge, recorded once when a group runs resident),
    # ticks whose votes rode the ring instead of dispatching, and ticks
    # whose compact readback deferred behind residency — together the
    # measured amortization of the fused multi-tick consume
    DEVICE_RESIDENT_DEPTH = "device.resident_depth"
    DEVICE_RESIDENT_TICKS = "device.resident_ticks"
    DEVICE_READBACKS_DEFERRED = "device.readbacks_deferred"
    # dispatch governor (adaptive tick, tpu/governor.py): the effective
    # interval after every tick (Stat.last = the CURRENT interval; the
    # histogram records how long the pool dwelt on each rung) and the
    # occupancy EWMA the control law acted on — together they make an
    # adaptive run's trajectory a comparable, replayable artifact
    GOVERNOR_TICK_INTERVAL = "governor.tick_interval"
    GOVERNOR_OCCUPANCY_EWMA = "governor.occupancy_ewma"
    # per-shard EWMAs under a mesh ("<prefix>.<shard_index>"): the
    # series the hottest-shard law acts on
    GOVERNOR_SHARD_OCCUPANCY_EWMA = "governor.shard_occupancy_ewma"
    # execution
    COMMIT_TIME = "exec.commit_time"
    # state-commit plane (state/sparse_merkle_state.py): per-3PC-batch
    # tree hashes the one-walk batched commit actually performed (the
    # O(delta) claim, measured — leaf + internal-node hashes, placement-
    # independent) and the valid-request count flushed per batch; the
    # per-state node-cache hit/miss totals live on the state object
    # (cache_hits/cache_misses) and surface through profile_rbft's
    # `state` block
    STATE_COMMIT_HASHES = "state.commit_hashes"
    STATE_COMMIT_BATCH_SIZE = "state.commit_batch_size"
    # catchup (chaos-hardened recovery plane): rounds completed, txns
    # fetched+applied, audit-proof verifications the leecher performed
    # on leeched batches (and the txns it REJECTED for failing them —
    # byzantine seeders), and re-requests the retry law issued
    CATCHUP_FAILED = "catchup.failed"
    CATCHUP_ROUNDS = "catchup.rounds"
    CATCHUP_TXNS_LEECHED = "catchup.txns_leeched"
    CATCHUP_PROOFS_VERIFIED = "catchup.proofs_verified"
    CATCHUP_REPS_REJECTED = "catchup.reps_rejected"
    CATCHUP_RETRIES = "catchup.retries"
    # seeder-side throttle (server/catchup/seeder_service.py): txns this
    # node served to leechers, and CATCHUP_REQ slices it deferred to a
    # later virtual instant because the token bucket was dry — seeding a
    # returning node must not stall the seeder's own ordering
    CATCHUP_SEEDER_TXNS = "catchup.seeder_txns"
    CATCHUP_SEEDER_DEFERRED = "catchup.seeder_deferred"
    # ordering lanes (keyspace-partitioned write path, lanes/): lane
    # count (Stat.last), per-lane ordered totals and router assignments
    # ("<prefix>.<lane>"), the barrier's sealed-window ordinal, and the
    # seal lag (first lane ready -> all lanes ready, virtual seconds) —
    # how long the fastest lane waited on the slowest per window
    LANE_COUNT = "lanes.count"
    LANE_ORDERED = "lanes.ordered"
    LANE_ROUTED = "lanes.routed"
    LANE_SEALED_WINDOW = "lanes.sealed_window"
    LANE_BARRIER_SEAL_LAG = "lanes.barrier_seal_lag"
    # transport
    ZSTACK_DROPPED = "zstack.dropped"
    # simulation network / chaos plane
    SIM_NET_DELIVERED = "sim_net.delivered"
    SIM_NET_DROPPED = "sim_net.dropped"
    CHAOS_FAULTS_BEGUN = "chaos.faults_begun"
    # long-horizon telemetry plane (observability/telemetry.py);
    # per-resource gauges ride "telemetry.resource.<name>" keys
    TELEMETRY_WINDOWS = "telemetry.windows"
    TELEMETRY_ANOMALIES = "telemetry.anomalies"


class Stat:
    __slots__ = ("count", "total", "min", "max", "last")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        # most recent value: for control variables (the governor's tick
        # interval) "current" is the question dashboards ask
        self.last: Optional[float] = None

    def add(self, value: float) -> None:
        self.count += 1
        self.total += value
        self.min = value if self.min is None else min(self.min, value)
        self.max = value if self.max is None else max(self.max, value)
        self.last = value

    @property
    def avg(self) -> float:
        return self.total / self.count if self.count else 0.0

    def as_dict(self) -> Dict[str, Any]:
        return {"count": self.count, "sum": self.total, "avg": self.avg,
                "min": self.min, "max": self.max, "last": self.last}


# distinct buckets kept per histogram: control variables take few values
# (the governor's ladder is multiplicative steps inside fixed bounds), so
# overflow means a bug upstream — excess lands in one "other" bucket
# instead of growing without bound
HISTOGRAM_MAX_BUCKETS = 64
HISTOGRAM_OVERFLOW_KEY = "other"


class MetricsCollector:
    def __init__(self):
        self._stats: Dict[str, Stat] = {}
        self._histograms: Dict[str, Dict[Any, int]] = {}

    def add_event(self, name: str, value: float = 1.0) -> None:
        stat = self._stats.get(name)
        if stat is None:
            stat = self._stats[name] = Stat()
        stat.add(value)

    def add_to_histogram(self, name: str, bucket: Any) -> None:
        """Count ``bucket`` occurrences under ``name`` (bounded: at most
        HISTOGRAM_MAX_BUCKETS distinct buckets, then "other")."""
        hist = self._histograms.get(name)
        if hist is None:
            hist = self._histograms[name] = {}
        if bucket not in hist and len(hist) >= HISTOGRAM_MAX_BUCKETS:
            bucket = HISTOGRAM_OVERFLOW_KEY
        hist[bucket] = hist.get(bucket, 0) + 1

    def histogram(self, name: str) -> Optional[Dict[Any, int]]:
        hist = self._histograms.get(name)
        return dict(hist) if hist is not None else None

    def stat(self, name: str) -> Optional[Stat]:
        return self._stats.get(name)

    def sized_resources(self, prefix: str = "metrics."):
        """Resource-ledger registration (observability.telemetry): stat
        names come from the fixed MetricsName space (leak-law watched),
        and the widest histogram must respect HISTOGRAM_MAX_BUCKETS
        (+1 for the overflow key)."""
        from ..observability.telemetry import SizedResource

        return (
            SizedResource(prefix + "stats", lambda: len(self._stats),
                          bound=None, entry_bytes=96),
            SizedResource(prefix + "histogram_buckets",
                          lambda: max((len(h) for h in
                                       self._histograms.values()),
                                      default=0),
                          bound=HISTOGRAM_MAX_BUCKETS + 1,
                          entry_bytes=48),
        )


    def summary(self) -> Dict[str, Dict[str, Any]]:
        return {name: s.as_dict() for name, s in sorted(self._stats.items())}

    @contextmanager
    def measure_time(self, name: str):
        """Time the body into ``name`` — EXCEPT when it raises: failure
        paths land under ``<name>.error`` instead, so a retry storm of
        raising bodies can never pollute the hot-path latency stats the
        dispatch plane is judged by (and the error count is itself an
        observable)."""
        # da: allow-file[nondet-source] -- wall-duration METERS only: metric values never feed consensus state, message contents or any *_hash fingerprint
        t0 = time.perf_counter()
        try:
            yield
        except BaseException:
            self.add_event(name + ".error", time.perf_counter() - t0)
            raise
        else:
            self.add_event(name, time.perf_counter() - t0)

    def close(self) -> None:
        """Teardown hook: persistent collectors flush; the in-memory
        base has nothing to do."""


class NullMetricsCollector(MetricsCollector):
    """Zero-cost sink for compositions that don't collect."""

    def add_event(self, name: str, value: float = 1.0) -> None:
        pass

    def add_to_histogram(self, name: str, bucket: Any) -> None:
        pass

    @contextmanager
    def measure_time(self, name: str):
        yield


# histogram entries share the stat keyspace; the prefix keeps them
# distinguishable (no metric name starts with it — MetricsName values
# are dotted lowercase words)
_HISTOGRAM_KEY_PREFIX = "hist!"


class KvMetricsCollector(MetricsCollector):
    """Persists summary snapshots into a KV store (reference: the
    KvStoreMetricsCollector's accumulated storage). Re-opening over a
    non-empty store SEEDS the counters from the persisted snapshot —
    stats AND histograms (``governor.tick_interval`` dwell history
    included), so history genuinely survives restarts instead of being
    overwritten by the new process's counters. ``close()`` flushes the
    up-to-``flush_every - 1`` events a periodic-only flush would lose on
    a clean shutdown — Node teardown calls it."""

    def __init__(self, store, flush_every: int = 1000):
        super().__init__()
        self._store = store
        self._flush_every = flush_every
        self._events_since_flush = 0
        for name, snap in self.load_persisted().items():
            stat = self._stats[name] = Stat()
            stat.count = snap.get("count", 0)
            stat.total = snap.get("sum", 0.0)
            stat.min = snap.get("min")
            stat.max = snap.get("max")
            stat.last = snap.get("last")
        for name, hist in self.load_persisted_histograms().items():
            self._histograms[name] = dict(hist)

    def add_event(self, name: str, value: float = 1.0) -> None:
        super().add_event(name, value)
        self._events_since_flush += 1
        if self._events_since_flush >= self._flush_every:
            self.flush()

    def flush(self) -> None:
        import json

        self._events_since_flush = 0
        for name, stat in self._stats.items():
            self._store.put(name.encode(),
                            json.dumps(stat.as_dict()).encode())
        for name, hist in self._histograms.items():
            # [bucket, count] pairs, not an object: JSON object keys are
            # strings, and the governor's float buckets must round-trip
            # as floats
            self._store.put(
                (_HISTOGRAM_KEY_PREFIX + name).encode(),
                json.dumps(sorted(
                    ([b, c] for b, c in hist.items()),
                    key=lambda pair: str(pair[0]))).encode())

    def close(self) -> None:
        self.flush()

    def load_persisted(self) -> Dict[str, Dict[str, Any]]:
        import json

        out = {}
        for key, value in self._store.iterator():
            name = bytes(key).decode()
            if name.startswith(_HISTOGRAM_KEY_PREFIX):
                continue
            out[name] = json.loads(bytes(value))
        return out

    def load_persisted_histograms(self) -> Dict[str, Dict[Any, int]]:
        import json

        out: Dict[str, Dict[Any, int]] = {}
        for key, value in self._store.iterator():
            name = bytes(key).decode()
            if not name.startswith(_HISTOGRAM_KEY_PREFIX):
                continue
            pairs = json.loads(bytes(value))
            out[name[len(_HISTOGRAM_KEY_PREFIX):]] = {
                # JSON has no tuple/int-key subtleties for our buckets
                # (floats and strings); lists would be unhashable, guard
                (tuple(b) if isinstance(b, list) else b): c
                for b, c in pairs}
        return out
