"""The slice as a whole: the port's ``SimPool(real_execution=True,
device="cpu")`` against the JAX package's ``SimPool`` on the same seeds and
request scripts, and the port's proved reads against JAX's.

Every node executes through its own ledgers and SMT states, so the
PRE-PREPARE digests carry real roots: any byte of difference in txn
serialization, state values or the audit txn would change every hash
after it. Both pools commit with ``StateCommitBatchMode="host"`` (the JAX
pool's device waves would compile on XLA:CPU); the port's device waves are
held against its host waves in ``tests/test_torch_state.py`` and, on the
card, by ``chip_smoke.py`` phase C.

Compared: ``ordered_hash``, each node's ``ledger_hash``, the txn root of
every ledger and the committed root of every state at every node, views,
and ``trace_hash(exclude_cats=("dispatch",))`` (state commits included).
The read service's replies are compared field by field, with the port in
``mode="host"`` and in ``mode="device"`` (K10's plain version).
"""
import pytest

pytest.importorskip("jax")

from indy_plenum_tpu.config import getConfig as jax_config  # noqa: E402
from indy_plenum_tpu.simulation.pool import SimPool as JaxPool  # noqa: E402
from indy_plenum_tpu_torch.config import getConfig as port_config  # noqa: E402,E501
from indy_plenum_tpu_torch.simulation.pool import SimPool as PortPool  # noqa: E402,E501

BASE = {"Max3PCBatchWait": 0.1, "Max3PCBatchSize": 3,
        "QuorumTickInterval": 0.05, "StateCommitBatchMode": "host"}


def _view_change(pool):
    """The reference's view-change revert (tests/test_signed_execution_e2e
    .py:41): order, lose the primary, change view, order more."""
    for i in range(4):
        pool.submit_request(i)
    pool.run_for(5)
    pool.network.disconnect(pool.nodes[0].data.primaries[0])
    pool.run_for(pool.config.ToleratePrimaryDisconnection + 8)
    for i in range(100, 104):
        pool.submit_request(i)
    pool.run_for(10)


def _signed(pool):
    for i in range(10):
        pool.submit_request(i)
    pool.submit_tampered_request(50)
    pool.run_for(10)


def _steady(pool):
    for i in range(14):
        pool.submit_request(i)
    pool.run_for(10)


SCENARIOS = {
    "unsigned_view_change": dict(seed=32, kwargs={}, script=_view_change,
                                 ordered=8),
    "signed_two_instances": dict(
        seed=11, kwargs=dict(sign_requests=True, num_instances=2,
                             device_quorum=True, shadow_check=False),
        script=_signed, ordered=10),
    "unsigned_two_instances": dict(
        seed=21, kwargs=dict(num_instances=2), script=_steady, ordered=14),
}


def _run(pool_cls, make_config, case, **extra):
    spec = SCENARIOS[case]
    pool = pool_cls(4, seed=spec["seed"], config=make_config(dict(BASE)),
                    real_execution=True, trace=True, **spec["kwargs"],
                    **extra)
    spec["script"](pool)
    return pool


def _fingerprint(pool):
    roots = []
    for nd in pool.nodes:
        db = nd.boot.db
        roots.append([(bytes(db.get_ledger(lid).root_hash),
                       db.get_state(lid).committed_head_hash
                       if db.get_state(lid) is not None else None)
                      for lid in (0, 1, 2, 3)])
    return {
        "ordered_hash": pool.ordered_hash(),
        "ledger_hashes": [pool.ledger_hash(nd.name) for nd in pool.nodes],
        "ordered": [len(nd.ordered_digests) for nd in pool.nodes],
        "roots": roots,
        "views": [nd.data.view_no for nd in pool.nodes],
        "trace_hash": pool.trace.trace_hash(exclude_cats=("dispatch",)),
        "committed_seq": [nd.executor.committed_seq() for nd in pool.nodes],
    }


@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_port_execution_matches_jax(case):
    want = _fingerprint(_run(JaxPool, jax_config, case))
    got = _fingerprint(_run(PortPool, port_config, case, device="cpu"))
    for key in want:
        assert got[key] == want[key], key
    assert max(got["ordered"]) == SCENARIOS[case]["ordered"]
    if "view_change" in case:
        assert max(got["views"]) >= 1


def _replies(service, indices):
    for i in indices:
        service.submit(i)
    return [(r.index, r.leaf, r.root, r.path, r.tree_size, r.verified,
             r.multi_sig, r.window) for r in service.drain()]


def test_proved_reads_match_jax():
    """Reads over a committed domain ledger: 64 seeded indices, so a drain
    takes the device path (at or above ``DEVICE_MIN_BATCH``)."""
    jax_pool = _run(JaxPool, jax_config, "unsigned_two_instances")
    port_pool = _run(PortPool, port_config, "unsigned_two_instances",
                     device="cpu")
    indices = [(i * 7919 + 3) % 1000 for i in range(64)]
    want_svc = jax_pool.make_read_service("node1", mode="host")
    want = _replies(want_svc, indices)
    assert len(want) == 64 and all(r[5] for r in want)
    for mode in ("host", "device"):
        svc = port_pool.make_read_service("node1", mode=mode)
        assert _replies(svc, indices) == want, mode
        assert svc.counters() == want_svc.counters()
    # a tampered snapshot root: every verdict False on both paths
    svc = port_pool.make_read_service("node1", mode="device")
    svc.backing.root = bytes(32)
    assert not any(r[5] for r in _replies(svc, indices))


def test_proof_cache_reads_match_jax():
    """``ReadService(proof_cache=...)`` over one pre-verified window of a
    seeded corpus: the port's replies (``mode="host"`` and ``"device"``,
    K10's plain version) carry the window's multi-signature and equal the
    JAX service's field by field, at zero pairings on both serve paths."""
    import dataclasses
    import hashlib

    from indy_plenum_tpu.crypto.bls import bls_crypto as jbc
    from indy_plenum_tpu.ingress import read_service as jrs
    from indy_plenum_tpu.proofs import checkpoint_cache as jcc
    from indy_plenum_tpu_torch.client.state_proof import verify_proved_read
    from indy_plenum_tpu_torch.crypto.bls import bls_crypto as tbc
    from indy_plenum_tpu_torch.ingress import read_service as trs
    from indy_plenum_tpu_torch.proofs import checkpoint_cache as tcc
    from indy_plenum_tpu_torch.utils.base58 import b58encode

    kps = [tbc.BlsKeyPair(hashlib.sha256(b"exec-proof-%d" % i).digest())
           for i in range(4)]
    keys = {"node%d" % i: kp.pk_b58 for i, kp in enumerate(kps)}

    def serve(bc, rs, cc, mode, kw):
        backing = rs.StaticCorpusBacking(300, seed=11)
        value = bc.MultiSignatureValue(
            ledger_id=1, state_root_hash="exec-state-root",
            pool_state_root_hash="", txn_root_hash=b58encode(backing.root),
            timestamp=1_700_000_000)
        msg = value.serialize()
        agg = bc.BlsCryptoVerifier.aggregate_sigs(
            [tbc.BlsCryptoSigner(kp).sign(msg) for kp in kps])
        ms = bc.MultiSignature(agg, sorted(keys), value)
        cache = cc.CheckpointProofCache(
            None, lambda: (backing.tree_size, backing.root),
            lambda: "exec-state-root")
        cache.install(cc.ProofWindow(
            window=(0, 20), tree_size=backing.tree_size, root=backing.root,
            state_root_b58="exec-state-root", multi_sig=ms,
            multi_sig_dict=ms.as_dict(), captured_at=0.0))
        service = rs.ReadService(backing, mode=mode, proof_cache=cache,
                                 **kw)
        for i in (5, 17, 299, 0, 128):
            service.submit(i)
        before = bc.PAIRINGS.checks
        out = service.drain()
        assert bc.PAIRINGS.checks == before
        return out, service.counters(), cache.counters()

    want, want_svc, want_cache = serve(jbc, jrs, jcc, "host", {})
    assert all(r.verified and r.multi_sig for r in want)
    for mode in ("host", "device"):
        got, svc, cache = serve(tbc, trs, tcc, mode, {"device": "cpu"})
        assert [dataclasses.asdict(r) for r in got] == \
            [dataclasses.asdict(r) for r in want], mode
        assert (svc, cache) == (want_svc, want_cache)
    assert svc["proofs_attached"] == 5
    assert verify_proved_read(got[2], keys, min_participants=3)
    # the resource-ledger registration is the reference's
    got = [(r.name, r.entries(), r.bound, r.entry_bytes) for r in
           tcc.CheckpointProofCache(None, None, None).sized_resources()]
    want = [(r.name, r.entries(), r.bound, r.entry_bytes) for r in
            jcc.CheckpointProofCache(None, None, None).sized_resources()]
    assert got == want and got