"""The ordering lanes in the port against the JAX package.

``lanes/`` (router, barrier, pool), the lane tick
(``quorum_driver.drive_lane_ticks``), ``LaneTraceView``, the checkpoint
barrier seam and the laned invariants, the same inputs through both
packages (the reference's ``tests/test_lanes.py``, less its monitor and
trace-tool tests: neither is part of the port):

- the router's law and the barrier's seal chain, unit by unit;
- laned pools (the port with ``device="cpu"``): per-lane
  ``ordered_hash``es, the sealed fingerprint, ``trace_hash`` and the
  journeys with their lane and barrier hop, through a stalled lane, an
  idle lane and a view change on one lane, per message and on the tick
  plane;
- ``lane_meshes``: every lane's fabric on the pool's one device orders as
  the unmeshed laned run and as the reference's disjoint meshes;
- ``check_cross_lane`` / ``check_laned_safety`` / ``check_laned_liveness``
  on the same pool, and ``lane_partition``'s invariants (its whole report
  is in ``tests/test_torch_chaos.py``).
"""
import importlib
from types import SimpleNamespace

import pytest

pytest.importorskip("jax")


def _side(root):
    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    return SimpleNamespace(
        root=root, lanes=mod("lanes"), getConfig=mod("config").getConfig,
        inv=mod("chaos.invariants"), causal=mod("observability.causal"),
        trace=mod("observability.trace"),
        pool_kwargs={} if root == "indy_plenum_tpu" else {"device": "cpu"})


JAX = _side("indy_plenum_tpu")
PORT = _side("indy_plenum_tpu_torch")
SIDES = (JAX, PORT)

LANED_CONFIG = {
    "Max3PCBatchWait": 0.1,
    "Max3PCBatchSize": 1,  # checkpoints move per txn
    "CHK_FREQ": 2,
    "LOG_SIZE": 6,
}
TICK = {"QuorumTickInterval": 0.05, "QuorumTickAdaptive": True}


def _both(fn, *args, **kwargs):
    want, got = (fn(side, *args, **kwargs) for side in SIDES)
    assert got == want
    return got


def _laned(side, lanes=4, seed=7, trace=False, config=None, **kw):
    cfg = side.getConfig(config or LANED_CONFIG)
    return side.lanes.LanedPool(lanes=lanes, n_nodes=4, seed=seed,
                                config=cfg, trace=trace,
                                **side.pool_kwargs, **kw)


def _fingerprints(side, pool):
    out = {"ordered_hashes": pool.ordered_hashes(),
           "sealed_fingerprint": pool.sealed_fingerprint,
           "ordered_per_lane": pool.ordered_per_lane(),
           "router": pool.router.counters(),
           "barrier": pool.barrier.counters(),
           "cross_lane": side.inv.check_cross_lane(pool).as_dict()}
    if pool.trace.enabled:
        events = pool.trace.events()
        out["trace_hash"] = pool.trace.trace_hash(exclude_cats=("dispatch",))
        out["journeys"] = side.causal.journey_summary(events)
    return out


# --- router and barrier units ----------------------------------------------


def _router(side, lanes, seed):
    r = side.lanes.LaneRouter(lanes, seed=seed)
    return [r.lane_of(f"key-{i}") for i in range(200)]


@pytest.mark.parametrize("lanes,seed", [(4, 9), (4, 10), (3, 0), (1, 5)])
def test_router_law_matches_jax(lanes, seed):
    got = _both(_router, lanes, seed)
    if lanes == 4:
        assert all(got.count(lane) > 20 for lane in range(4))


def test_route_key_matches_jax():
    class Req:
        identifier = "cli"
        reqId = 5
        operation = {"dest": "TARGETDID"}

    for side in SIDES:
        Req.operation = {"dest": "TARGETDID"}
        assert side.lanes.route_key(Req()) == "TARGETDID"
        Req.operation = {"type": "1"}
        assert side.lanes.route_key(Req()) == "cli|5"


def _barrier(side, case):
    b = side.lanes.CrossLaneBarrier(lanes=2, chk_freq=2,
                                    keep=3 if case == "bounded" else 0)
    released = []
    verdicts = []
    if case == "hold":
        verdicts.append(b.offer(0, "node0", 2, "d0",
                                lambda: released.append("l0")))
        verdicts.append(b.offer(1, "node0", 2, "d1",
                                lambda: released.append("l1")))
        verdicts.append(b.offer(0, "node1", 2, "d0", lambda: None))
    elif case == "chain":
        for window in (2, 4, 6):
            b.offer(0, "n", window, f"a{window}", lambda: None)
            b.offer(1, "n", window, f"b{window}", lambda: None)
    elif case == "repeat":
        b.offer(0, "node0", 2, "d", lambda: released.append(1))
        b.offer(0, "node0", 2, "d", lambda: released.append(1))
        b.offer(1, "node0", 2, "d", lambda: None)
    elif case == "idle":
        b.set_idle_probe(1, lambda: True)
        verdicts.append(b.offer(0, "node0", 2, "d0",
                                lambda: released.append(1)))
        b.set_idle_probe(0, lambda: True)
        b.service_tick()
    elif case == "caught_up":
        b.offer(0, "node0", 2, "d0", lambda: None)
        b.offer(0, "node0", 4, "d0b", lambda: None)
        b.lane_caught_up(1, 4)
    elif case == "bounded":
        for window in range(1, 11):
            b.offer(0, "n", window * 2, f"a{window}", lambda: None)
            b.offer(1, "n", window * 2, f"b{window}", lambda: None)
    fake = SimpleNamespace(barrier=b, lane_pools=[],
                           config=side.getConfig(LANED_CONFIG))
    return (verdicts, released, b.sealed_window, b.seal_fingerprint,
            dict(b.seal_digests), dict(b.fingerprints), b.counters(),
            [(r.name, r.entries(), r.bound) for r in b.sized_resources()],
            side.inv.check_cross_lane(fake).as_dict())


@pytest.mark.parametrize("case", ["hold", "chain", "repeat", "idle",
                                  "caught_up", "bounded"])
def test_barrier_matches_jax(case):
    verdicts, released, sealed, tip, digests, chain, _, _, cross = \
        _both(_barrier, case)
    assert cross["verdict"] == "PASS"
    if case == "hold":
        assert verdicts == [False, True, True] and released == ["l0"]
    if case == "idle":
        assert sealed == 1 and digests[1] == ["d0", "idle"]
    if case == "caught_up":
        assert digests[2] == ["d0b", "catchup"]
    if case == "bounded":
        assert sorted(digests) == [8, 9, 10] and chain[10] == tip


# --- laned pools -------------------------------------------------------------


def _orders(side, lanes, seed, n_reqs, tick, trace):
    cfg = dict(LANED_CONFIG, **(TICK if tick else {}))
    pool = _laned(side, lanes=lanes, seed=seed, trace=trace, config=cfg,
                  device_quorum=tick)
    for i in range(n_reqs):
        pool.submit_request(i)
    pool.run_for(40)
    assert pool.honest_nodes_agree()
    assert pool.ordered_total() == n_reqs
    pads = pool.seal_flush()
    return dict(_fingerprints(side, pool), pads=pads,
                safety=[r.as_dict() for r in side.inv.check_laned_safety(
                    pool)])


@pytest.mark.parametrize("tick", [False, True], ids=["message", "tick"])
def test_laned_pool_matches_jax(tick):
    got = _both(_orders, 4, 7, 24, tick, True)
    assert got["cross_lane"]["verdict"] == "PASS"
    assert all(r["verdict"] == "PASS" for r in got["safety"])
    js = got["journeys"]
    total = 24 + got["pads"]
    assert js["count"] == total and js["orphan_spans"] == 0
    assert js["lanes"]["with_lane"] == js["lanes"]["with_barrier_hop"] \
        == total


def _stalled(side):
    pool = _laned(side, lanes=2, seed=11)
    chk = pool.config.CHK_FREQ
    lp1 = pool.lane_pools[1]
    lp1.network.disconnect("node2")
    lp1.network.disconnect("node3")
    for i in range(40):
        pool.submit_to_lane(i, 0)
        pool.submit_to_lane(100 + i, 1)
    pool.run_for(60)
    sealed = pool.barrier.sealed_window
    bound = sealed * chk + pool.config.LOG_SIZE
    fast = max(nd.data.last_ordered_3pc[1]
               for nd in pool.lane_pools[0].nodes)
    stalled = _fingerprints(side, pool)
    lp1.network.reconnect("node2")
    lp1.network.reconnect("node3")
    pool.run_for(120)
    return (sealed, bound, fast, stalled, _fingerprints(side, pool),
            pool.ordered_total())


def test_stalled_lane_bounds_the_fast_lane_as_jax():
    sealed, bound, fast, stalled, healed, total = _both(_stalled)
    assert pool_ok(stalled) and pool_ok(healed)
    assert 6 <= fast <= bound and total == 80
    assert healed["barrier"]["sealed_window"] > sealed


def pool_ok(fingerprints):
    return fingerprints["cross_lane"]["verdict"] == "PASS"


def _idle(side):
    pool = _laned(side, lanes=4, seed=13)
    for i in range(20):
        pool.submit_to_lane(i, 2)
    pool.run_for(30)
    return _fingerprints(side, pool), dict(pool.barrier.seal_digests)


def test_idle_lane_never_blocks_busy_lanes_as_jax():
    fingerprints, digests = _both(_idle)
    assert fingerprints["ordered_per_lane"] == [0, 0, 20, 0]
    assert len(digests) >= 8 and pool_ok(fingerprints)


def _view_change(side):
    pool = _laned(side, lanes=4, seed=23, trace=True)
    primary = pool.lane_pools[1].nodes[0].data.primaries[0]
    pool.timer.schedule(
        3.0, lambda: pool.lane_pools[1].network.disconnect(primary))
    for i in range(32):
        pool.submit_request(i)
    pool.run_for(60)
    pool.seal_flush()
    views = [nd.data.view_no for nd in pool.lane_pools[1].nodes
             if nd.name != primary]
    return _fingerprints(side, pool), views, pool.trace.trace_hash()


def test_view_change_on_one_lane_matches_jax():
    fingerprints, views, _ = _both(_view_change)
    assert min(views) >= 1
    assert fingerprints["journeys"]["orphan_spans"] == 0
    # and it replays
    assert _view_change(PORT)[0] == fingerprints


def test_lane_trace_view_tags_every_event_as_jax():
    def tagged(side):
        rec = side.trace.TraceRecorder(lambda: 1.5, capacity=64)
        view = side.trace.LaneTraceView(rec, 2)
        view.record("3pc.ordered", node="n0", key=(0, 1, "d"),
                    args={"x": 1})
        with view.span("tick.flush", args={"y": 2}):
            pass
        view.trigger_dump("why", node="n0")
        return (rec.events(), rec.trace_hash(), view.enabled,
                view.trace_hash(), len(view.dumps))

    events, *_ = _both(tagged)
    assert all(ev["args"]["lane"] == 2 for ev in events)


def _meshed(side, meshes):
    cfg = side.getConfig(dict(LANED_CONFIG, **TICK))
    pool = side.lanes.LanedPool(lanes=2, n_nodes=4, seed=7, config=cfg,
                                device_quorum=True, meshes=meshes,
                                **side.pool_kwargs)
    for i in range(12):
        pool.submit_request(i)
    pool.run_for(30)
    pool.seal_flush()
    shapes = [tuple(lp.vote_group.mesh_shape) for lp in pool.lane_pools]
    return pool.ordered_hashes(), pool.sealed_fingerprint, shapes


def test_lane_meshes_on_one_device_order_as_jax():
    """The reference slices its 8 virtual devices into two disjoint (2,)
    meshes; the port builds both lanes' (2,) fabrics on its one device.
    Both order as the unmeshed laned run."""
    port_meshes = PORT.lanes.lane_meshes(2, (2,), device="cpu")
    assert all(m.device.type == "cpu" and m.shape == (2,)
               for m in port_meshes)
    want = _meshed(JAX, JAX.lanes.lane_meshes(2, (2,)))
    got = _meshed(PORT, port_meshes)
    assert got == want and got[2] == [(2,), (2,)]
    assert got[:2] == _meshed(PORT, None)[:2]
    with pytest.raises(ValueError):
        PORT.lanes.LanedPool(lanes=2, n_nodes=4, seed=7,
                             config=PORT.getConfig(LANED_CONFIG),
                             device_quorum=True, meshes=port_meshes[:1],
                             device="cpu")


def _liveness(side):
    pool = _laned(side, lanes=2, seed=5)
    for i in range(8):
        pool.submit_request(i)
    pool.run_for(20)
    live = side.inv.check_laned_liveness(pool, probes=2, timeout=20.0)
    return live.as_dict(), _fingerprints(side, pool)


def test_laned_liveness_matches_jax():
    live, _ = _both(_liveness)
    assert live["verdict"] == "PASS"


def test_config_knob_defaults_lane_count_as_jax():
    for side in SIDES:
        cfg = side.getConfig(dict(LANED_CONFIG, OrderingLanes=2))
        pool = side.lanes.LanedPool(n_nodes=4, seed=5, config=cfg,
                                    **side.pool_kwargs)
        assert pool.n_lanes == 2
        pool = side.lanes.LanedPool(lanes=3, n_nodes=4, seed=5, config=cfg,
                                    **side.pool_kwargs)
        assert pool.n_lanes == 3


def test_lane_partition_invariants_match_jax():
    from indy_plenum_tpu.chaos import run_scenario as jax_run
    from indy_plenum_tpu_torch.chaos import run_scenario as port_run

    want = jax_run("lane_partition", 7)
    got = port_run("lane_partition", 7, device="cpu")
    assert got.invariants == want.invariants
    assert got.lanes == want.lanes and got.catchup == want.catchup
    verdicts = {r["name"]: r["verdict"] for r in got.invariants}
    assert verdicts["cross_lane"] == verdicts["catchup_recovery"] == "PASS"
    assert got.catchup["txns_leeched"] >= 1 and got.verdict_as_expected
    assert got.lanes["count"] == 4
    assert got.lanes["barrier"]["sealed_window"] >= 1
    assert len(got.lanes["ordered_hash_per_lane"]) == 4


def test_smoke_phase_n_arm_matches_bench_lanes():
    """``chip_smoke.py`` phase N's 4-lane arm on the CPU (the twin its card
    run is held against) equals ``bench.py``'s ``_run_laned`` on the JAX
    package at n=64 a lane: per-lane ``ordered_hash``es, the sealed
    fingerprint, ``journey_hash``, the router's split and the rate per
    virtual second; its journeys pass the smoke's checks."""
    import bench
    import chip_smoke as cs

    got = cs.run_laned_n("cpu", 4)
    want = bench._run_laned(4, cs.N_PER_LANE, cs.N_TXNS_PER_LANE, cs.N_SEED)
    for key in ("ordered_hash_per_lane", "sealed_fingerprint",
                "journey_hash", "router_distribution", "sealed_window",
                "seal_pads", "txns_ordered"):
        assert got[key] == want[key], key
    assert got["ordered_per_sim_sec"] == pytest.approx(
        want["ordered_per_sim_sec"], abs=0.05)
    assert {k: got["journeys"][k] for k in got["journeys"]} == \
        {k: want["journeys"][k] for k in got["journeys"]}
    cs.check_laned_arm(got)


def test_router_spies_match_jax():
    """The pool's spy seam (``SimPool(spy=True)``, ``spy_of``): every
    node's routers record each routed message with its verdict and
    virtual instant, the same log in both packages."""
    def spies(side):
        pool = importlib.import_module(f"{side.root}.simulation.pool") \
            .SimPool(4, seed=3, spy=True, num_instances=2, **side.pool_kwargs)
        for i in range(6):
            pool.submit_request(i)
        pool.run_for(10)
        out = {}
        for node in pool.nodes:
            for key in ((0, "3pc"), (0, "other"), (1, "3pc")):
                spy = pool.spy_of(node.name, *key)
                out[(node.name,) + key] = [
                    (type(m).__name__, frm, code, t)
                    for m, frm, code, t in spy.log]
        return out

    got = _both(spies)
    assert sum(len(log) for log in got.values()) > 0
