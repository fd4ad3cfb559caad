"""The port's view-change storm cell (``bench.py:1478``
``bench_view_change_storm``, BASELINE config 4) run small through its
``n`` against the JAX package driven the reference's way (its wrapping
copied from the root ``bench.py`` below, ``n`` a parameter), on the CPU:
at n=4 the same signed and verified view-change copies, transport
messages, views and ordering. Every delivered copy waits for its chunk of
512 through K-c's plain version here, ~5-10 s a chunk on the CPU.
"""
import hashlib
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from indy_plenum_tpu_torch.tools import bench  # noqa: E402


def reference_view_change_storm(n, seed=17):
    """``bench.py:1478`` ``bench_view_change_storm`` at ``n`` validators:
    its record and its pool."""
    from indy_plenum_tpu.common.messages.node_messages import (
        InstanceChange,
        NewView,
        ViewChange,
        ViewChangeAck,
    )
    from indy_plenum_tpu.common.serializers.serialization import (
        serialize_msg,
    )
    from indy_plenum_tpu.config import getConfig
    from indy_plenum_tpu.crypto import ed25519 as ed
    from indy_plenum_tpu.simulation.pool import SimPool
    from indy_plenum_tpu.tpu import ed25519 as ted

    config = getConfig({"Max3PCBatchWait": 0.1, "Max3PCBatchSize": 10})
    pool = SimPool(n_nodes=n, seed=seed, config=config)
    vc_types = (ViewChange, ViewChangeAck, NewView, InstanceChange)
    seeds = {nd.name: hashlib.sha256(b"vc-%s" % nd.name.encode()).digest()
             for nd in pool.nodes}
    pks = {name: ed.fast_public_key(s) for name, s in seeds.items()}
    counters = {"signed": 0, "verified": 0}
    sigs_by_id = {}
    queue = []

    def wrap_node(nd):
        bus = nd.external_bus
        inner_send = bus._send_handler
        name = nd.name

        def signing_send(msg, dst=None):
            if isinstance(msg, vc_types):
                payload = serialize_msg(msg.as_dict())
                sig = ed.fast_sign(seeds[name], payload)
                counters["signed"] += 1
                sigs_by_id[id(msg)] = (msg, payload, sig, name)
            inner_send(msg, dst)

        bus._send_handler = signing_send
        inner_recv = bus.process_incoming

        def gated_recv(msg, frm):
            entry = sigs_by_id.get(id(msg))
            if entry is None or entry[0] is not msg:
                return inner_recv(msg, frm)
            _m, payload, sig, signer = entry
            queue.append((pks[signer], payload, sig,
                          lambda m=msg, f=frm: inner_recv(m, f)))

        bus.process_incoming = gated_recv

    for nd in pool.nodes:
        wrap_node(nd)
    VCHUNK = 512

    def _verify_chunk(batch):
        k = len(batch)
        pad = batch + [batch[0]] * (VCHUNK - k)
        pk_a, r_a, s_a, h_a, pre = ted.prepare_batch(
            [b[0] for b in pad], [b[1] for b in pad], [b[2] for b in pad])
        assert pre.all()
        ok = np.asarray(ted.verify_kernel(pk_a, r_a, s_a, h_a))
        counters["verified"] += k
        assert ok[:k].all(), "storm signature failed verification"

    def pump_verifications():
        if not queue:
            return
        batch, queue[:] = list(queue), []
        for i in range(0, len(batch), VCHUNK):
            _verify_chunk(batch[i:i + VCHUNK])
        for (_pk, _m, _s, deliver) in batch:
            deliver()

    warm_msg = serialize_msg({"warm": 1})
    warm_sig = ed.fast_sign(seeds[pool.nodes[0].name], warm_msg)
    _verify_chunk([(pks[pool.nodes[0].name], warm_msg, warm_sig)])
    counters["verified"] = 0
    for i in range(10):
        pool.submit_request(i)
    pool.run_for(10)
    assert pool.honest_nodes_agree()
    primary = pool.nodes[0].data.primaries[0]
    pool.network.disconnect(primary)
    survivors = [nd for nd in pool.nodes if nd.name != primary]

    def done():
        return all(nd.data.view_no >= 1 and not nd.data.waiting_for_new_view
                   for nd in survivors)

    guard = time.monotonic() + 240
    while not done() and time.monotonic() < guard:
        pool.run_for(0.5)
        pump_verifications()
    assert done(), "view change did not complete"
    assert counters["verified"] > 0
    return {"messages": pool.network.sent,
            "signatures_verified": counters["verified"],
            "signatures_signed": counters["signed"]}, pool



def test_view_change_storm_matches_reference():
    want, ref_pool = reference_view_change_storm(4)
    rec, pool = bench._view_change_storm(4, device="cpu")
    for key in ("messages", "signatures_verified", "signatures_signed"):
        assert rec[key] == want[key], key
    assert rec["signatures_verified"] > 0
    assert {nd.name: nd.data.view_no for nd in pool.nodes} \
        == {nd.name: nd.data.view_no for nd in ref_pool.nodes}
    assert pool.ordered_hash() == ref_pool.ordered_hash()
    assert rec["metric"] == "view_change_storm_n4_wall_s"
