"""The port's bench cells whose size the reference fixes in its body, run
small through their keyword arguments, against the JAX package driven the
reference's way (its wrapping copied from the root ``bench.py`` below,
with the same sizes as parameters), on the CPU:

- ``offload`` (``bench.py:843``) on 4 slices of a 1,024-leaf tree: each
  mode's ``ordered_hash``, orders and slices;
- ``_run_saturation`` (``bench.py:1077``) at n=4, 1,024 keys and a 0.1 s
  open-loop window, reads served: ``ordered_hash``, ``shed_hash``, the
  journeys, the admission and workload counters, the reads;
- ``ed`` (``bench.py:92``) at a batch of 8: the same record but for its
  times and its device.

``viewchange`` is in ``tests/test_torch_bench_viewchange.py``.
"""
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from indy_plenum_tpu_torch.tools import bench  # noqa: E402


# --- the reference's wrappings (bench.py), sizes as parameters -------------


def reference_catchup_offload(tree_size, slice_size):
    """``bench.py:843`` ``bench_catchup_offload`` on a ``tree_size`` tree
    in slices of ``slice_size``: per mode the pool's ``ordered_hash``, the
    requests ordered past the warm-up and the slices verified."""
    from indy_plenum_tpu.config import getConfig
    from indy_plenum_tpu.ledger.compact_merkle_tree import CompactMerkleTree
    from indy_plenum_tpu.ledger.merkle_verifier import STH, MerkleVerifier
    from indy_plenum_tpu.server.catchup.catchup_rep_service import (
        dispatch_audit_paths_batch,
        verify_audit_paths_batch,
    )
    from indy_plenum_tpu.simulation.pool import SimPool

    rng = np.random.RandomState(5)
    leaves = [rng.bytes(64) for _ in range(tree_size)]
    tree = CompactMerkleTree()
    tree.extend(leaves)
    root = tree.root_hash
    slices = []
    for start in range(0, tree_size, slice_size):
        idxs = list(range(start, start + slice_size))
        slices.append(([leaves[i] for i in idxs], idxs,
                       [tree.audit_path(i, tree_size) for i in idxs]))
    verifier = MerkleVerifier()
    sth = STH(tree_size=tree_size, sha256_root_hash=root)
    arms = {}

    def run_mode(mode, seed):
        n_nodes, batch_size = 16, 80
        config = getConfig({"Max3PCBatchSize": batch_size,
                            "Max3PCBatchWait": 0.05,
                            "QuorumTickInterval": 0.1})
        pool = SimPool(n_nodes=n_nodes, seed=seed, config=config,
                       device_quorum=True, shadow_check=False)
        for i in range(batch_size):
            pool.submit_request(i)
        deadline = time.monotonic() + 240
        while min(len(n.ordered_digests) for n in pool.nodes) < batch_size \
                and time.monotonic() < deadline:
            pool.run_for(0.5)
        if mode != "host":
            assert verify_audit_paths_batch(
                *slices[0][:3], tree_size, root).all()
        if mode == "auto":
            from indy_plenum_tpu.server.catchup.catchup_rep_service import (
                OFFLOAD_POLICY,
            )
            OFFLOAD_POLICY.host_ns = OFFLOAD_POLICY.dev_ns = None
            OFFLOAD_POLICY._batches = 0
        n_txns = 4 * batch_size
        for i in range(batch_size, batch_size + n_txns):
            pool.submit_request(i)
        pending = list(slices)
        inflight = None
        done = 0
        target = batch_size + n_txns
        while (min(len(n.ordered_digests) for n in pool.nodes) < target
               or pending or inflight) and time.monotonic() < deadline:
            pool.run_for(0.25)
            if inflight is not None:
                verdict = inflight()
                if verdict is not None:
                    assert verdict.all()
                    inflight = None
                    done += 1
            if pending and inflight is None:
                data, idxs, paths = pending.pop(0)
                if mode == "host":
                    for d, i, p in zip(data, idxs, paths):
                        assert verifier.verify_leaf_inclusion(d, i, p, sth)
                    done += 1
                else:
                    inflight = dispatch_audit_paths_batch(
                        data, idxs, paths, tree_size, root, mode=mode)
        ordered = min(len(n.ordered_digests)
                      for n in pool.nodes) - batch_size
        assert done == len(slices), "catchup stream did not finish"
        assert ordered >= n_txns, "ordering starved"
        arms[mode] = {"ordered_hash": pool.ordered_hash(),
                      "ordered": ordered, "slices": done}

    for mode in ("host", "device", "auto"):
        run_mode(mode, seed=21)
    return arms


def reference_saturation(n_nodes, n_keys, duration, seed=29):
    """``bench.py:1077`` ``_run_saturation(serve_reads=True)`` at
    ``n_nodes``, ``n_keys`` and an open-loop window of ``duration``: its
    fields that no wall clock builds."""
    from indy_plenum_tpu.config import getConfig
    from indy_plenum_tpu.ingress import (
        ReadService,
        StaticCorpusBacking,
        WorkloadGenerator,
        WorkloadSpec,
    )
    from indy_plenum_tpu.observability.causal import journey_summary
    from indy_plenum_tpu.simulation.pool import SimPool

    batch_size, capacity = 80, 24
    config = getConfig({
        "Max3PCBatchSize": batch_size, "Max3PCBatchWait": 0.05,
        "QuorumTickInterval": 0.1, "QuorumTickAdaptive": True,
        "IngressQueueCapacity": capacity})
    pool = SimPool(n_nodes=n_nodes, seed=seed, config=config,
                   device_quorum=True, shadow_check=False,
                   sign_requests=True, trace=True, trace_capacity=1 << 20)
    reads = ReadService(StaticCorpusBacking(n_keys, seed=seed),
                        clock=pool.timer.get_current_time,
                        metrics=pool.metrics, trace=pool.trace)

    def min_ordered():
        return min(len(nd.ordered_digests) for nd in pool.nodes)

    warm_n = capacity - 14
    for i in range(warm_n):
        pool.submit_request(1_000_000 + i, client_id="warm")
    pool.timer.schedule(1.0, lambda: [
        pool.submit_request(1_100_000 + i, client_id="warm")
        for i in range(warm_n)])
    deadline = time.monotonic() + 300
    while min_ordered() < 2 * warm_n and time.monotonic() < deadline:
        pool.run_for(0.5)
    assert min_ordered() >= 2 * warm_n, "saturation warm-up stalled"
    for _ in range(3):
        for i in range(600):
            reads.submit(i * 7)
        reads.drain()
    reads.reset_serve_meters()
    seq = [0]

    def on_write(client, key):
        seq[0] += 1
        pool.submit_request(seq[0], client_id="c%d" % client)

    gen = WorkloadGenerator(WorkloadSpec(
        n_clients=1_000_000, rate=1600.0, duration=duration,
        read_fraction=0.5, zipf_clients=1.1, zipf_keys=1.2,
        n_keys=n_keys, seed=seed))
    gen.start(pool.timer, on_write,
              on_read=lambda client, key: reads.submit(key))
    flushes0 = pool.vote_group.flushes
    ordered0 = min_ordered()
    elapsed_sim = 0.0
    deadline = time.monotonic() + 300
    while (elapsed_sim < 24.0 or pool.admission.depth) \
            and time.monotonic() < deadline:
        pool.run_for(0.5)
        elapsed_sim += 0.5
        reads.drain()
    assert pool.honest_nodes_agree()
    ordered = min_ordered() - ordered0
    rng = np.random.RandomState(seed)
    burst = ((rng.zipf(1.2, 20000) - 1) % n_keys).tolist()
    for lo in range(0, len(burst), 600):
        for k in burst[lo:lo + 600]:
            reads.submit(k)
        replies = reads.drain()
        assert all(r.verified for r in replies)
    adm = pool.admission
    js = journey_summary(pool.trace.events())
    return {"ordered": ordered, "ordered_hash": pool.ordered_hash(),
            "shed_hash": adm.shed_hash(), "admission": adm.counters(),
            "workload": gen.counters(),
            "device_flushes": pool.vote_group.flushes - flushes0,
            "journey_hash": js["journey_hash"],
            "reads": {k: v for k, v in reads.counters().items()
                      if k != "read_qps"}}


def reference_ed25519(batch):
    """``bench.py:92`` ``bench_ed25519`` at a batch of ``batch``: its
    record."""
    import jax.numpy as jnp

    from indy_plenum_tpu.crypto import ed25519 as ed
    from indy_plenum_tpu.tpu import ed25519 as ted

    rng = np.random.RandomState(7)
    seeds = [rng.bytes(32) for _ in range(64)]
    pks_all = [ed.fast_public_key(s) for s in seeds]
    pks, msgs, sigs = [], [], []
    for i in range(batch):
        seed = seeds[i % len(seeds)]
        msg = rng.bytes(64)
        pks.append(pks_all[i % len(seeds)])
        msgs.append(msg)
        sigs.append(ed.fast_sign(seed, msg))
    max_blocks = ted.max_blocks_for(msgs)
    pk_a, r_a, s_a, blocks, counts, pre = ted.prepare_batch_device(
        pks, msgs, sigs, max_blocks)
    assert pre.all()
    args = [jax.device_put(jnp.asarray(a))
            for a in (pk_a, r_a, s_a, blocks, counts)]
    ok = np.asarray(ted.verify_kernel_full(*args))
    assert ok.all(), "benchmark batch failed verification"
    return {"metric": "ed25519_full_onchip_verifies_per_sec",
            "batch": batch, "arrays": (pk_a, r_a, s_a, blocks, counts)}


# --- the tests --------------------------------------------------------------


def test_catchup_offload_matches_reference():
    want = reference_catchup_offload(1024, 256)
    rec, arms = bench._catchup_offload(1024, 256, device="cpu")
    assert arms == want
    assert set(arms) == {"host", "device", "auto"}
    assert all(arm["slices"] == 4 and arm["ordered"] == 320
               for arm in arms.values())
    assert rec["proofs"] == 1024 and rec["n_validators"] == 16
    assert rec["metric"] == "catchup_offload_ordered_txns_ratio"


def test_saturation_arm_matches_reference():
    want = reference_saturation(4, 1024, 0.1)
    got = bench._run_saturation(True, n_nodes=4, n_keys=1024, duration=0.1,
                                device="cpu")
    for key in ("ordered", "ordered_hash", "shed_hash", "admission",
                "workload", "device_flushes"):
        assert got[key] == want[key], key
    assert got["e2e_latency"]["journey_hash"] == want["journey_hash"]
    assert {k: v for k, v in got["reads"].items()
            if k not in ("read_qps", "read_proofs_per_wall_sec")} \
        == want["reads"]
    assert got["admission"]["shed"] > 0  # the window overran the queue


def test_ed25519_cell_matches_reference():
    want = reference_ed25519(8)
    rec = bench.bench_ed25519("cpu", batch=8)
    assert rec["metric"] == want["metric"]
    assert rec["batch"] == want["batch"] == 8
    assert rec["device"] == "cpu"
    assert rec["spread"]["runs"] == bench.REPS
    # the port packs the same blocks from the same seeded stream
    from indy_plenum_tpu_torch.tpu import ed25519 as ted

    pks, msgs, sigs = _ed_inputs(8)
    got = ted.prepare_batch_device(pks, msgs, sigs,
                                   ted.max_blocks_for(msgs))
    assert got[5].all()
    for a, b in zip(got[:5], want["arrays"]):
        assert np.array_equal(a, b)


def _ed_inputs(batch):
    """The cell's seeded inputs (``bench_ed25519``'s stream)."""
    from indy_plenum_tpu_torch.crypto import ed25519 as ed

    rng = np.random.RandomState(7)
    seeds = [rng.bytes(32) for _ in range(64)]
    pks_all = [ed.fast_public_key(s) for s in seeds]
    pks, msgs, sigs = [], [], []
    for i in range(batch):
        msg = rng.bytes(64)
        pks.append(pks_all[i % 64])
        msgs.append(msg)
        sigs.append(ed.fast_sign(seeds[i % 64], msg))
    return pks, msgs, sigs
