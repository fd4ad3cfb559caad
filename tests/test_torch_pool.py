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
"""
import pytest

pytest.importorskip("jax")

from indy_plenum_tpu.config import getConfig as jax_config  # noqa: E402
from indy_plenum_tpu.simulation.pool import SimPool as JaxPool  # noqa: E402
from indy_plenum_tpu_torch.config import getConfig as port_config  # noqa: E402,E501
from indy_plenum_tpu_torch.simulation.pool import SimPool as PortPool  # noqa: E402,E501

COUNTERS = ("flushes", "flush_votes_total", "flush_capacity_total",
            "readback_bytes_total", "readbacks", "readbacks_overlapped")
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


def _steady(pool, count):
    for i in range(count):
        pool.submit_request(i)
    pool.run_for(15)


def _burst(pool, count):
    """``count`` signed requests from four clients in one instant: the
    bounded admission queue sheds the excess, and the rest order."""
    for i in range(count):
        pool.submit_request(i, client_id=f"client{i % 4}")
    pool.run_for(12)


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
    # n=4, signed, a burst through a bounded admission queue
    "n4_admission_burst": dict(
        n=4, seed=23,
        config=dict(BASE, IngressQueueCapacity=6, IngressPerClientCap=3),
        kwargs=dict(sign_requests=True),
        script=lambda p: _burst(p, 24)),
}


def _run(pool_cls, make_config, case, **extra):
    spec = SCENARIOS[case]
    pool = pool_cls(spec["n"], seed=spec["seed"],
                    config=make_config(dict(spec["config"])),
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
    }


@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_port_pool_matches_jax_pool(case):
    want = _run(JaxPool, jax_config, case)
    got = _run(PortPool, port_config, case, device="cpu")
    for key in want:
        assert got[key] == want[key], key
    assert max(len(d) for d in got["ordered_digests"]) > 0
    spec = SCENARIOS[case]
    if "view_change" in case:
        assert max(got["views"]) >= 1
    if "min_slides" in spec:
        assert min(got["slides"]) >= spec["min_slides"]
    if "admission" in case:
        assert got["shed"] > 0
