"""The slice as a whole: the port's ``SimPool(device="cpu")`` against the
JAX package's ``SimPool`` on the same seeds and the same request script.

Both pools run the same consensus services over the same seeded network;
the port's device work (ingress Ed25519 drains, the grouped quorum step,
window slides, view-change zeros) runs its kernels' plain versions on the
CPU. Equal results mean the same bytes ordered in the same order at every
node: ``ordered_hash()``, each node's ``ordered_digests``, view numbers,
the protocol timeline (``trace_hash(exclude_cats=("dispatch",))``), the
vote group's flush and readback counters, the slides per member and, with
admission control, ``shed_hash()``.

The mesh cases run the JAX pool on the conftest's virtual CPU devices and
the port's on its one-device fabric (``make_fabric_mesh(["cpu"] * 8,
shape)``), and compare the fabric's fingerprints too: ``shards``,
``shard_occupancy``, ``readback_bytes_per_shard``, ``row_shift`` and
``rebalances``. The forced-rebalance arms (``tests/test_residency.py:
135-171``) must also order and trace as their own unforced arms.
"""
import pytest

jax = pytest.importorskip("jax")

from indy_plenum_tpu.config import getConfig as jax_config  # noqa: E402
from indy_plenum_tpu.simulation.pool import SimPool as JaxPool  # noqa: E402
from indy_plenum_tpu_torch.config import getConfig as port_config  # noqa: E402,E501
from indy_plenum_tpu_torch.simulation.pool import SimPool as PortPool  # noqa: E402,E501
from indy_plenum_tpu.tpu.quorum import make_fabric_mesh as jax_mesh  # noqa: E402,E501
from indy_plenum_tpu_torch.tpu.quorum import make_fabric_mesh as port_mesh  # noqa: E402,E501
from test_torch_resident import copy_staging  # noqa: E402

COUNTERS = ("flushes", "flush_votes_total", "flush_capacity_total",
            "readback_bytes_total", "readbacks", "readbacks_overlapped",
            "resident_ticks", "readbacks_deferred", "shards",
            "shard_occupancy", "readback_bytes_per_shard", "row_shift",
            "rebalances")
BASE = {"Max3PCBatchWait": 0.1, "Max3PCBatchSize": 2,
        "QuorumTickInterval": 0.05}


def _view_change(pool, first, then):
    """Order ``first`` requests, disconnect the primary until the pool
    changes view, then order ``then`` more (the last one tampered)."""
    for i in range(first):
        pool.submit_request(i)
    pool.run_for(10)
    pool.network.disconnect(pool.nodes[0].data.primaries[0])
    pool.run_for(pool.config.ToleratePrimaryDisconnection + 10)
    for i in range(100, 100 + then):
        pool.submit_request(i)
    pool.submit_tampered_request(100 + then)
    pool.run_for(12)


def _steady(pool, count, seconds=15):
    for i in range(count):
        pool.submit_request(i)
    pool.run_for(seconds)


def _burst(pool, count):
    """``count`` signed requests from four clients in one instant: the
    bounded admission queue sheds the excess, and the rest order."""
    for i in range(count):
        pool.submit_request(i, client_id=f"client{i % 4}")
    pool.run_for(12)


SLIDE_FOLD = {"Max3PCBatchWait": 0.1, "QuorumTickInterval": 0.05,
              "QuorumTickAdaptive": True, "ResidentTickDepth": 4,
              "Max3PCBatchSize": 1, "CHK_FREQ": 5, "LOG_SIZE": 15}

MESH = {"Max3PCBatchWait": 0.1, "Max3PCBatchSize": 5,
        "QuorumTickInterval": 0.05, "QuorumTickAdaptive": True}
REBALANCE = {"Max3PCBatchWait": 0.1, "Max3PCBatchSize": 1,
             "QuorumTickInterval": 0.05, "CHK_FREQ": 5, "LOG_SIZE": 15,
             "ResidentTickDepth": 4, "RebalanceForceTick": 12}


def _mesh_view_change(pool):
    """tests/test_mesh_dispatch.py::_run_pool's script."""
    for i in range(6):
        pool.submit_request(i)
    pool.run_for(8)
    pool.network.disconnect(pool.nodes[0].data.primaries[0])
    pool.run_for(pool.config.ToleratePrimaryDisconnection + 10)
    for i in range(100, 104):
        pool.submit_request(i)
    pool.run_for(12)


def _rebalance_script(pool):
    """tests/test_residency.py::_run_rebalance_arm's script."""
    for i in range(6):
        pool.submit_request(i)
    pool.run_for(5)
    for i in range(6, 12):
        pool.submit_request(i)
    pool.run_for(25)


SCENARIOS = {
    # n=4, signed, a primary disconnect forces a view change
    "n4_signed_view_change": dict(
        n=4, seed=37, config=BASE, kwargs=dict(sign_requests=True),
        script=lambda p: _view_change(p, 6, 4)),
    # n=4, the full-event readback instead of the compact deltas
    "n4_host_eval": dict(
        n=4, seed=5, config=BASE, kwargs=dict(host_eval=True),
        script=lambda p: _steady(p, 10)),
    # n=16, six RBFT instances (96 members), adaptive tick, a small
    # window so that every member slides at least twice
    "n16_k6_adaptive": dict(
        n=16, seed=11,
        config=dict(BASE, LOG_SIZE=30, CHK_FREQ=5, Max3PCBatchSize=1,
                    QuorumTickAdaptive=True),
        kwargs=dict(num_instances=6),
        script=lambda p: _steady(p, 12), min_slides=2),
    # n=4, signed, the view change above with a depth-4 residency ring
    "n4_signed_view_change_resident": dict(
        n=4, seed=37, config=dict(BASE, ResidentTickDepth=4),
        kwargs=dict(sign_requests=True),
        script=lambda p: _view_change(p, 6, 4)),
    # tests/test_residency.py::test_resident_slide_fold_identity's pool:
    # checkpoint slides fold into the resident step
    "n4_resident_slide_fold": dict(
        n=4, seed=11, config=SLIDE_FOLD,
        kwargs={}, script=lambda p: _steady(p, 12, 30), min_slides=2),
    # tests/test_mesh_dispatch.py: n=8 x 2 instances on (4,), a view
    # change
    "n8_k2_mesh4": dict(
        n=8, seed=37, config=MESH, kwargs=dict(num_instances=2),
        mesh=(4,), script=_mesh_view_change),
    # tests/test_quorum_fabric.py: the same pool on the (2, 2) fabric
    "n8_k2_fabric2x2": dict(
        n=8, seed=37, config=MESH, kwargs=dict(num_instances=2),
        mesh=(2, 2), script=_mesh_view_change),
    # tests/test_residency.py:71-84: depth-4 residency on (4,)
    "n8_k2_mesh4_resident": dict(
        n=8, seed=37, config=dict(MESH, ResidentTickDepth=4),
        kwargs=dict(num_instances=2), mesh=(4,),
        script=_mesh_view_change),
    # tests/test_residency.py:155-171: a forced rotation at tick 12
    "n8_rebalance_mesh4": dict(
        n=8, seed=23, config=REBALANCE, kwargs={}, mesh=(4,),
        script=_rebalance_script),
    "n8_rebalance_fabric2x2": dict(
        n=8, seed=23, config=REBALANCE, kwargs={}, mesh=(2, 2),
        script=_rebalance_script),
    # n=4, signed, a burst through a bounded admission queue
    "n4_admission_burst": dict(
        n=4, seed=23,
        config=dict(BASE, IngressQueueCapacity=6, IngressPerClientCap=3),
        kwargs=dict(sign_requests=True),
        script=lambda p: _burst(p, 24)),
}


def _run(pool_cls, make_config, case, config_overrides=None, **extra):
    """The case's fingerprints; with ``config_overrides``, the pool."""
    spec = SCENARIOS[case]
    if "mesh" in spec:
        extra["mesh"] = (port_mesh(["cpu"] * 8, spec["mesh"])
                         if pool_cls is PortPool
                         else jax_mesh(jax.devices()[:8], spec["mesh"]))
    pool = pool_cls(spec["n"], seed=spec["seed"],
                    config=make_config(dict(spec["config"],
                                            **(config_overrides or {}))),
                    device_quorum=True, shadow_check=False, trace=True,
                    **spec["kwargs"], **extra)
    slides = [0] * len(pool.vote_group._members)
    real_slide = pool.vote_group.slide_member

    def slide_member(member_idx, delta):
        slides[member_idx] += 1
        real_slide(member_idx, delta)

    pool.vote_group.slide_member = slide_member
    spec["script"](pool)
    assert pool.honest_nodes_agree()
    if config_overrides is not None:
        return pool
    return {
        "ordered_hash": pool.ordered_hash(),
        "ordered_digests": [n.ordered_digests for n in pool.nodes],
        "views": [n.data.view_no for n in pool.nodes],
        "trace_hash": pool.trace.trace_hash(exclude_cats=("dispatch",)),
        "counters": {c: getattr(pool.vote_group, c) for c in COUNTERS},
        "slides": slides,
        "shed_hash": (pool.admission.shed_hash()
                      if pool.admission is not None else None),
        "shed": (pool.admission.shed_total
                 if pool.admission is not None else 0),
        "interval": (pool.governor.interval
                     if pool.governor is not None else None),
        "events": [{"name": ev["name"], "args": ev["args"]}
                   for ev in pool.trace.events()
                   if ev["name"].startswith("rebalance.")],
    }


@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_port_pool_matches_jax_pool(case, monkeypatch):
    spec = SCENARIOS[case]
    if spec["config"].get("ResidentTickDepth", 1) > 1:
        copy_staging(monkeypatch)  # the JAX ring's staging race
    want = _run(JaxPool, jax_config, case)
    got = _run(PortPool, port_config, case, device="cpu")
    for key in want:
        assert got[key] == want[key], key
    assert max(len(d) for d in got["ordered_digests"]) > 0
    if "view_change" in case:
        assert max(got["views"]) >= 1
    if "min_slides" in spec:
        assert min(got["slides"]) >= spec["min_slides"]
    if "admission" in case:
        assert got["shed"] > 0
    if "resident" in case:
        assert got["counters"]["resident_ticks"] > 0
    if "mesh" in spec:
        assert got["counters"]["shards"] == 4
        assert sum(got["counters"]["readback_bytes_per_shard"]) \
            == got["counters"]["readback_bytes_total"]
    if "rebalance" in case:
        assert got["counters"]["rebalances"] >= 1
        assert got["counters"]["row_shift"] != 0
        names = {ev["name"] for ev in got["events"]}
        assert {"rebalance.planned", "rebalance.executed"} <= names
        unforced = _run(PortPool, port_config, case,
                        {"RebalanceForceTick": 0}, device="cpu")
        assert unforced.vote_group.rebalances == 0
        assert unforced.ordered_hash() == got["ordered_hash"]
        assert unforced.trace.trace_hash(exclude_cats=("dispatch",)) \
            == got["trace_hash"]


def test_port_residency_orders_as_per_tick():
    """The slide-fold pool at depth 4 and at depth 1 in the port: the same
    ordering; the window really slid, every plane's h tracks its node's
    low watermark, and the ring really deferred readbacks."""
    resident = _run(PortPool, port_config, "n4_resident_slide_fold", {},
                    device="cpu")
    per_tick = _run(PortPool, port_config, "n4_resident_slide_fold",
                    {"ResidentTickDepth": 1}, device="cpu")
    assert resident.ordered_hash() == per_tick.ordered_hash()
    for node in resident.nodes:
        assert node.data.stable_checkpoint >= 10
        assert node.vote_plane.h == node.data.low_watermark
    group = resident.vote_group
    assert group.readbacks_deferred > 0
    assert group.flushes < per_tick.vote_group.flushes
