"""The port's KV-persisted metrics collector and trace dump analytics
against the JAX package's.

- ``KvMetricsCollector``: the same events (stats and histogram buckets,
  the governor's float buckets included) through both packages'
  collectors leave equal store contents, key for key and byte for byte
  (stats and ``hist!`` entries); ``close()`` flushes what the periodic
  flush has not; reopening a collector over the store seeds its counters
  and histograms, so new events add to the persisted history.
- ``critical_path``, ``overlap_report``, ``rollup_report`` and
  ``to_chrome_trace`` give the reference's outputs on the events of one
  pool's trace dump, loaded back through each package's ``load_jsonl``:
  a residency pool (``ResidentTickDepth`` 4, a view change, the telemetry
  plane armed) and a fabric pool on the (4, 2) mesh (per-shard columns),
  built as ``tests/test_residency.py`` and ``tests/test_quorum_fabric.py``
  build theirs, on the port with ``device="cpu"``.
"""
import importlib
import json

import pytest

pytest.importorskip("jax")

JAX, PORT = "indy_plenum_tpu", "indy_plenum_tpu_torch"


def mod(pkg, path):
    return importlib.import_module(f"{pkg}.{path}")


@pytest.fixture(autouse=True)
def one_torch_thread():
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def feed(collector, names):
    for i in range(7):
        collector.add_event(names.AUTH_BATCH_SIZE, i + 1)
        collector.add_event(names.ZSTACK_DROPPED, 2)
        collector.add_to_histogram(names.GOVERNOR_TICK_INTERVAL,
                                   0.05 * (1 + i % 3))
        collector.add_to_histogram("lanes.skew", f"bucket-{i % 2}")
    with collector.measure_time(names.AUTH_BATCH_TIME):
        pass


def store_contents(store):
    return {bytes(k): bytes(v) for k, v in store.iterator()}


@pytest.mark.parametrize("storage", ["sqlite", "memory"])
def test_kv_metrics_collector_matches_reference(tmp_path, storage):
    contents, seeded = {}, {}
    for pkg in (JAX, PORT):
        mc = mod(pkg, "common.metrics_collector")
        kv = mod(pkg, "storage.kv_store")
        store = kv.initKeyValueStorage(storage, str(tmp_path / pkg),
                                       "metrics_node0")
        collector = mc.KvMetricsCollector(store, flush_every=5)
        feed(collector, mc.MetricsName)
        collector.close()
        # the measured time differs run to run: drop it before comparing
        contents[pkg] = {k: v for k, v in store_contents(store).items()
                         if k != mc.MetricsName.AUTH_BATCH_TIME.encode()}
        assert any(k.startswith(b"hist!") for k in contents[pkg])
        # reopening seeds the counters from the persisted snapshot
        again = mc.KvMetricsCollector(store, flush_every=5)
        stat = again.stat(mc.MetricsName.AUTH_BATCH_SIZE)
        assert (stat.count, stat.total) == (7, 28)
        again.add_event(mc.MetricsName.AUTH_BATCH_SIZE, 100)
        again.close()
        seeded[pkg] = (again.stat(mc.MetricsName.AUTH_BATCH_SIZE).as_dict(),
                       again.histogram(mc.MetricsName.GOVERNOR_TICK_INTERVAL),
                       again.histogram("lanes.skew"))
        assert again.stat(mc.MetricsName.AUTH_BATCH_SIZE).count == 8
    assert contents[PORT] == contents[JAX]
    assert seeded[PORT] == seeded[JAX]


def residency_pool():
    """tests/test_residency.py's pool knobs at depth 4, with a view
    change, traced, the telemetry plane armed (rollup marks)."""
    from indy_plenum_tpu_torch.config import getConfig
    from indy_plenum_tpu_torch.simulation.pool import SimPool

    cfg = getConfig({"Max3PCBatchWait": 0.1, "Max3PCBatchSize": 5,
                     "QuorumTickInterval": 0.05, "QuorumTickAdaptive": True,
                     "ResidentTickDepth": 4, "TelemetryWindowSec": 1.0,
                     "TelemetryLeakGraceWindows": 2})
    pool = SimPool(4, seed=5, config=cfg, device_quorum=True,
                   shadow_check=False, num_instances=2, trace=True,
                   device="cpu")
    primary = pool.nodes[0].data.primaries[0]
    for i in range(6):
        pool.submit_request(i)
    pool.run_for(8)
    pool.network.disconnect(primary)
    pool.run_for(pool.config.ToleratePrimaryDisconnection + 10)
    for i in range(100, 104):
        pool.submit_request(i)
    pool.run_for(12)
    assert pool.honest_nodes_agree()
    pool.telemetry.finalize(pool.timer.get_current_time())
    return pool


def fabric_pool():
    """tests/test_quorum_fabric.py's pool on the (4, 2) fabric."""
    from indy_plenum_tpu_torch.config import getConfig
    from indy_plenum_tpu_torch.simulation.pool import SimPool
    from indy_plenum_tpu_torch.tpu.quorum import make_fabric_mesh

    cfg = getConfig({"Max3PCBatchWait": 0.1, "Max3PCBatchSize": 5,
                     "QuorumTickInterval": 0.05, "QuorumTickAdaptive": True})
    pool = SimPool(8, seed=7, config=cfg, device_quorum=True,
                   shadow_check=False, num_instances=2,
                   mesh=make_fabric_mesh(["cpu"] * 8, (4, 2)), trace=True,
                   device="cpu")
    for i in range(6):
        pool.submit_request(i)
    pool.run_for(8)
    assert pool.honest_nodes_agree()
    return pool


@pytest.mark.parametrize("build", [residency_pool, fabric_pool],
                         ids=["residency", "fabric"])
def test_trace_analytics_match_reference(tmp_path, build):
    pool = build()
    path = str(tmp_path / "trace.jsonl")
    pool.trace.dump(path)
    out = {}
    for pkg in (JAX, PORT):
        trace = mod(pkg, "observability.trace")
        events = trace.load_jsonl(path)
        nodes = sorted({ev.get("node", "") for ev in events} - {""})
        out[pkg] = {
            "critical_path": trace.critical_path(events),
            "critical_path_node": trace.critical_path(events, nodes[0]),
            "overlap": trace.overlap_report(events),
            "overlap_node": trace.overlap_report(events, nodes[1]),
            "rollup": trace.rollup_report(events),
            "chrome": trace.to_chrome_trace(events),
        }
    assert json.dumps(out[PORT], sort_keys=True) == \
        json.dumps(out[JAX], sort_keys=True)
    port = out[PORT]
    assert port["critical_path"]["batches"] > 0
    assert port["overlap"]["ticks"] > 0
    if build is residency_pool:
        assert "residency" in port["overlap"]
        assert port["rollup"]["windows"] >= 10
    else:
        assert "per_shard" in port["overlap"]
    # the package exports them as the reference's does
    obs = mod(PORT, "observability")
    for name in ("critical_path", "overlap_report", "rollup_report",
                 "to_chrome_trace"):
        assert getattr(obs, name) is getattr(mod(PORT,
                                                 "observability.trace"),
                                             name)
