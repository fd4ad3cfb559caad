"""The RBFT monitor and the backup instances in the port against the JAX
package.

- ``tests/test_monitor_replicas.py``'s six cases: the windowed
  throughput unit on both packages' ``WindowedThroughputMeasurement``
  and ``LatencyMeasurement``; backups ordering in parallel with the
  master; the throttled master primary voted out by the same monitors
  (the same ``degradation_votes`` per node) to the same new primary, on
  the host planes as the reference runs it and on the device plane in
  tick mode, traced (the view change zeroes the members' planes; the
  snapshots' phase-latency and end-to-end blocks and the dispatch-free
  trace hash equal); backups
  rebuilt after a view change; backups on the device plane in both flush
  modes. Each pool case holds ``chip_smoke.node_record`` equal to the
  JAX run's (monitor ratios to 1e-9), with each node's ``snapshot()``
  in it.
- The notifier's share of the throttled-master run
  (``tests/test_notifier_logging.py``): the degradation vote and the
  view change reach every node's sink alike, and VALIDATOR_INFO's recent
  events.
- The snapshot's blocks (``tests/test_lanes.py:366``,
  ``tests/test_telemetry.py:314``, ``tests/test_overload.py:560`` and
  ``:581``): the lanes block of a 2-lane pool, the telemetry block of an
  armed pool, the ingress block with and without retries; the port's
  ``Monitor.snapshot()`` equal to the reference's on the same pools.
"""
import pytest

pytest.importorskip("jax")

from test_torch_node import (  # noqa: E402,F401
    JAX,
    PORT,
    Pkg,
    one_torch_thread,
    record,
    same,
)

THROTTLED = {"Max3PCBatchWait": 0.1, "Max3PCBatchSize": 2,
             "PropagateBatchWait": 0.05,
             "ThroughputWindowSize": 2, "ThroughputMinCnt": 4,
             "PerfCheckFreq": 2.0, "DELTA": 0.4,
             "ToleratePrimaryDisconnection": 10_000.0,
             "NewViewTimeout": 10_000.0}


def _throttle(pool, pkg, delay=60.0):
    PrePrepare = pkg.msg("PrePrepare")
    primary = pool.nodes[0].data.primaries[0]

    def throttle(msg, frm, to):
        if isinstance(msg, PrePrepare) and frm == primary \
                and msg.instId == 0:
            return delay
        return None

    pool.network.add_delayer(throttle)
    return primary


def test_windowed_throughput_and_latency_units_match_jax():
    def run(pkg):
        tm = pkg.mod("server.throughput_measurement")
        m = tm.WindowedThroughputMeasurement(
            window_size=5.0, lookback_windows=4, min_cnt=10, first_ts=0.0)
        out = [m.get_throughput(1.0)]
        for i in range(20):
            m.add_request(float(i))
            out.append(m.get_throughput(float(i) + 0.5))
        out.append(m.get_throughput(21.0))
        lat = tm.LatencyMeasurement(4)
        lats = []
        for d in (0.5, 1.5, 0.25, 3.0, 2.0, 0.75):
            lat.add_duration(d)
            lats.append(lat.get_avg_latency())
        return out, lats

    want, got = run(Pkg(JAX)), run(Pkg(PORT))
    assert got[0][0] is None and 0.5 < got[0][-1] < 1.5
    same(got, want)


def backups_in_parallel(pkg):
    pool = pkg.pool(4, seed=11, num_instances=0)
    node = pool.nodes[2]
    assert node.data.primaries[0] == "node0"
    assert node.replicas.backups[0].data.primaries[1] == "node1"
    for _ in range(4):
        pool.submit_to("node0", pool.make_nym_request())
    pool.run_for(20)
    backups = [n.replicas.backups[0].data.last_ordered_3pc
               for n in pool.nodes]
    assert all(len(n.ordered_digests) == 4 for n in pool.nodes)
    assert all(seq >= 1 for _, seq in backups)
    ratio = node.monitor.master_throughput_ratio()
    assert ratio is None or ratio >= 0.5
    return dict(record=record(pool), backups=backups, ratio=ratio)


def throttled_master(pkg, device_quorum=False):
    """The R in RBFT: the master primary alive but slow is voted out. On
    the device plane the run is traced, so the snapshots carry the
    phase-latency and end-to-end blocks and the record the trace hash."""
    overrides = dict(THROTTLED)
    if device_quorum:
        overrides["QuorumTickInterval"] = 0.05
    pool = pkg.pool(4, seed=12, config=pkg.config(overrides),
                    num_instances=0, device_quorum=device_quorum,
                    trace=device_quorum)
    sinks = {n.name: [] for n in pool.nodes}
    for n in pool.nodes:
        n.notifier.register_sink(sinks[n.name].append)
    old = _throttle(pool, pkg)
    for i in range(16):
        pool.submit_to(f"node{i % 4}", pool.make_nym_request())
    pool.run_for(60)
    voted = record(pool)
    assert all(v >= 1 for v in voted["views"])
    new = pool.nodes[1].data.primaries[0]
    assert new != old
    assert any(v > 0 for v in voted["degradation_votes"])
    # the notifier: the vote and the view change reach every node's sink
    notifier = pkg.mod("server.notifier")
    for n in pool.nodes:
        got = [e["kind"] for e in sinks[n.name]]
        assert notifier.VIEW_CHANGE_STARTED in got
        assert notifier.VIEW_CHANGE_COMPLETE in got
    assert any(notifier.MASTER_DEGRADED in [e["kind"] for e in evs]
               for evs in sinks.values())
    pool.run_for(40)
    after = record(pool)
    assert after["ordered_counts"] == [16] * 4 and after["agree"]
    if device_quorum:
        assert all("phase_latency" in snap and "e2e_latency" in snap
                   for snap in after["monitor"])
    return dict(voted=voted, record=after, new_primary=new, sinks=sinks,
                recent=pool.nodes[1].node_status()["recent_events"])


def backups_rebuilt(pkg):
    config = dict(THROTTLED)
    config.pop("DELTA")
    pool = pkg.pool(4, seed=13, config=pkg.config(config), num_instances=0)
    _throttle(pool, pkg)
    for i in range(12):
        pool.submit_to(f"node{i % 4}", pool.make_nym_request())
    pool.run_for(60)
    rebuilt = []
    for n in pool.nodes:
        backup = n.replicas.backups[0]
        assert n.data.view_no >= 1
        assert backup.data.view_no == n.data.view_no
        assert backup.data.primaries == n.data.primaries
        rebuilt.append((backup.data.view_no, list(backup.data.primaries)))
    return dict(record=record(pool), rebuilt=rebuilt)


def backups_on_device_plane(pkg, tick):
    if tick:
        pool = pkg.pool(4, seed=15, config=pkg.config(
            {"Max3PCBatchWait": 0.1, "Max3PCBatchSize": 5,
             "PropagateBatchWait": 0.05, "QuorumTickInterval": 0.05}),
            num_instances=0, device_quorum=True)
        writes = [f"node{i % 4}" for i in range(6)]
    else:
        pool = pkg.pool(4, seed=14, num_instances=0, device_quorum=True)
        writes = ["node0"] * 4
    assert pool.num_instances == 2
    for n in pool.nodes:
        plane = n.replicas.backups[0].vote_plane
        assert plane is not None and plane is not n.vote_plane
        assert plane.defer_flush_on_query == tick
    for entry in writes:
        pool.submit_to(entry, pool.make_nym_request())
    pool.run_for(30 if tick else 20)
    assert all(len(n.ordered_digests) == len(writes) for n in pool.nodes)
    assert all(n.replicas.backups[0].data.last_ordered_3pc[1] >= 1
               for n in pool.nodes)
    assert pool.vote_group.flushes > 0
    return dict(record=record(pool))


CASES = {
    "backups_in_parallel": backups_in_parallel,
    "throttled_master": throttled_master,
    "throttled_master_device_tick": lambda pkg: throttled_master(
        pkg, device_quorum=True),
    "backups_rebuilt": backups_rebuilt,
    "device_plane_per_message": lambda pkg: backups_on_device_plane(
        pkg, tick=False),
    "device_plane_tick": lambda pkg: backups_on_device_plane(
        pkg, tick=True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_monitor_case_matches_jax(name):
    want = CASES[name](Pkg(JAX))
    got = CASES[name](Pkg(PORT))
    same(got, want)


# --- the snapshot's blocks ---------------------------------------------------

def _monitor(pkg, pool):
    return pkg.mod("server.monitor").Monitor(
        "node0", pool.timer, pkg.mod("common.event_bus").InternalBus(),
        pool.config, num_instances=1, metrics=pool.metrics)


def _sim_pool(pkg, **kw):
    return pkg.mod("simulation.pool").SimPool(**Pkg._device(pkg, kw))


def lanes_block(pkg):
    lanes = pkg.mod("lanes")
    config = pkg.config({"Max3PCBatchWait": 0.1, "Max3PCBatchSize": 1,
                         "CHK_FREQ": 2, "LOG_SIZE": 6})
    pool = lanes.LanedPool(**Pkg._device(pkg, dict(
        lanes=2, n_nodes=4, seed=7, config=config)))
    for i in range(10):
        pool.submit_request(i)
    pool.run_for(30)
    block = _monitor(pkg, pool).snapshot()["lanes"]
    assert block["count"] == 2 and sum(block["ordered_per_lane"]) == 10
    assert block["router_distribution"] == pool.router.distribution
    assert block["barrier"]["sealed_window"] == pool.barrier.sealed_window
    plain = _sim_pool(pkg, n_nodes=4, seed=3)
    assert "lanes" not in _monitor(pkg, plain).snapshot()
    return block


def telemetry_block(pkg):
    config = pkg.config({"Max3PCBatchWait": 0.1, "Max3PCBatchSize": 10,
                         "TelemetryWindowSec": 1.0,
                         "TelemetryLeakGraceWindows": 2})
    pool = _sim_pool(pkg, n_nodes=4, seed=11, config=config, trace=True)
    for i in range(15):
        pool.submit_request(i)
        pool.run_for(1)
    block = _monitor(pkg, pool).snapshot()["telemetry"]
    assert block["windows"] == pool.telemetry.completed
    assert block["anomalies"] == pool.telemetry.anomaly_count
    assert "telemetry.windows" in block["resources"]
    for stat in block["resources"].values():
        assert set(stat) == {"last", "high_water"}
        assert stat["last"] <= stat["high_water"]
    return block


def ingress_block(pkg, retries):
    names = pkg.mod("common.metrics_collector")
    metrics = names.MetricsCollector()
    timer = pkg.mod("simulation.mock_timer").MockTimer()
    monitor = pkg.mod("server.monitor").Monitor(
        "node0", timer, pkg.mod("common.event_bus").InternalBus(),
        pkg.config({}), num_instances=1, metrics=metrics)
    m = names.MetricsName
    metrics.add_event(m.INGRESS_QUEUE_DEPTH, 4)
    metrics.add_event(m.INGRESS_ADMITTED, 50)
    if retries:
        metrics.add_event(m.INGRESS_SHED, 10)
        metrics.add_event(m.INGRESS_RETRIES, 9)
        metrics.add_event(m.INGRESS_RETRY_EXHAUSTED, 1)
        metrics.add_event(m.INGRESS_RETRY_ADMITTED, 8)
    block = monitor.snapshot()["ingress"]
    if retries:
        assert block["retries"] == 9 and block["retry_exhausted"] == 1
        assert block["goodput_fraction"] == pytest.approx(0.84)
    else:
        assert "retries" not in block and "goodput_fraction" not in block
    return block


BLOCKS = {
    "lanes": lanes_block,
    "telemetry": telemetry_block,
    "ingress_retries": lambda pkg: ingress_block(pkg, True),
    "ingress_without_retries": lambda pkg: ingress_block(pkg, False),
}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_monitor_snapshot_block_matches_jax(name):
    same(BLOCKS[name](Pkg(PORT)), BLOCKS[name](Pkg(JAX)))
