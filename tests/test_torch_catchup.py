"""Catchup in the port against the JAX package: the retry law, the
seeder / leecher / cons-proof / fork-point services, and whole pools that
fall behind, diverge or lose their ledgers and catch up.

Each pool case runs one of ``tests/test_catchup.py``'s scenarios on the
JAX package's ``SimPool`` and on the port's ``SimPool(device="cpu")``
with the same seed and script, then compares every node's
``ledger_hash``, domain and audit roots and committed state heads,
``ordered_hash``, ``trace_hash(exclude_cats=("dispatch",))``, each
leecher's ``catchup_stats()`` and ``is_participating``; the scenario's
own assertions run on both sides. Both pools commit with
``StateCommitBatchMode="host"`` (the JAX pool's device waves would compile
on XLA:CPU).

The last cases run ``chip_smoke.py``'s phase L (``bench.py``'s catchup
cell) at 40 missed txns from a fresh offload policy on both sides: the
first domain slice (at or above ``DEVICE_MIN_BATCH``) goes through K10's
plain version (``verify_audit_paths_indexed``) inside the live pool, and
with phase L2's altered rep both sides reject it alike.
"""
import importlib
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest

pytest.importorskip("jax")

import chip_smoke  # noqa: E402

DOMAIN, AUDIT = 1, 3

CATCHUP_CONFIG = {
    "Max3PCBatchWait": 0.1,
    "Max3PCBatchSize": 1,
    "CHK_FREQ": 2,
    "LOG_SIZE": 4,
    "ConsistencyProofsTimeout": 1.0,
    "CatchupTransactionsTimeout": 1.5,
    "StateCommitBatchMode": "host",
}


def _side(root, **pool_kwargs):
    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    return SimpleNamespace(
        root=root, pool_kwargs=pool_kwargs,
        SimPool=mod("simulation.pool").SimPool,
        getConfig=mod("config").getConfig,
        msgs=mod("common.messages.node_messages"),
        internal=mod("common.messages.internal_messages"),
        Suspicions=mod("server.suspicion_codes").Suspicions,
        MetricsName=mod("common.metrics_collector").MetricsName,
        crs=mod("server.catchup.catchup_rep_service"),
        catchup=mod("server.catchup"),
        ConsProofService=mod(
            "server.catchup.cons_proof_service").ConsProofService,
        ForkPointService=mod(
            "server.catchup.fork_point_service").ForkPointService,
        Ledger=mod("ledger.ledger").Ledger,
        DatabaseManager=mod("server.database_manager").DatabaseManager,
        ExternalBus=mod("common.event_bus").ExternalBus,
        QueueTimer=mod("common.timer").QueueTimer,
        Quorums=mod("server.quorums").Quorums,
        b58encode=mod("utils.base58").b58encode)


JAX = _side("indy_plenum_tpu")
PORT = _side("indy_plenum_tpu_torch", device="cpu")


def make_pool(side, seed, **extra):
    cfg = dict(CATCHUP_CONFIG)
    cfg.update(extra)
    return side.SimPool(4, seed=seed, real_execution=True,
                        config=side.getConfig(cfg), trace=True,
                        **side.pool_kwargs)


def ledger(node, lid=DOMAIN):
    return node.boot.db.get_ledger(lid)


def domain_sizes(pool):
    return [ledger(n).size for n in pool.nodes]


def domain_roots(pool):
    return [ledger(n).root_hash for n in pool.nodes]


def state_head(node):
    return node.boot.db.get_state(DOMAIN).committed_head_hash


def fingerprint(pool):
    nodes = pool.nodes
    return {
        "ordered_hash": pool.ordered_hash(),
        "trace_hash": pool.trace.trace_hash(exclude_cats=("dispatch",)),
        "ledger_hashes": [pool.ledger_hash(n.name) for n in nodes],
        "roots": [(bytes(ledger(n).root_hash), bytes(ledger(n, AUDIT)
                                                     .root_hash),
                   [bytes(n.boot.db.get_state(lid).committed_head_hash)
                    for lid in (0, 1, 2)]) for n in nodes],
        "sizes": [(ledger(n).size, ledger(n, AUDIT).size) for n in nodes],
        "catchup_stats": [n.leecher.catchup_stats() for n in nodes],
        "participating": [n.data.is_participating for n in nodes],
    }


CATCHUP_MODULES = ("retry", "catchup_rep_service", "cons_proof_service",
                   "fork_point_service", "seeder_service",
                   "node_leecher_service")


def test_catchup_modules_import_without_jax_or_reference():
    """The port's catchup package and each of its six modules import with
    ``jax`` and ``indy_plenum_tpu`` unimportable (a subprocess: this one
    has imported jax), and export what the reference's package does."""
    blocked = ("jax", "indy_plenum_tpu", "msgpack", "cryptography")
    mods = ["indy_plenum_tpu_torch.server.catchup"] + [
        "indy_plenum_tpu_torch.server.catchup." + m for m in CATCHUP_MODULES]
    code = (
        "import sys, importlib\n"
        f"for name in {blocked!r}:\n"
        "    sys.modules[name] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "pkg = sys.modules[" + repr(mods[0]) + "]\n"
        "print(','.join(sorted(pkg.__all__)))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().split(",") == sorted(JAX.catchup.__all__)
    for name in JAX.catchup.__all__:
        assert getattr(PORT.catchup, name).__module__.startswith(
            "indy_plenum_tpu_torch.")


# --- the retry law ------------------------------------------------------------

RETRY_LAWS = [
    dict(base=2.0, mult=1.5, max_delay=20.0, jitter_frac=0.25, seed=7,
         max_retries=4),
    dict(base=0.5, mult=1.0, max_delay=0.1, jitter_frac=0.0, seed=0,
         max_retries=0),
    dict(base=1.25, mult=3.0, max_delay=60.0, jitter_frac=1.0, seed=123,
         max_retries=10),
    dict(base=3.5, mult=0.5, max_delay=5.0, jitter_frac=-1.0, seed=2**40,
         max_retries=2),
]


@pytest.mark.parametrize("law", range(len(RETRY_LAWS)))
def test_retry_law_matches_jax(law):
    kw = RETRY_LAWS[law]
    want = JAX.catchup.RetryLaw(**kw)
    got = PORT.catchup.RetryLaw(**kw)
    assert vars(got) == vars(want)
    for key in ((1, 101), (3, 1), (0, 7), "slice", (2, 2**33)):
        for attempt in range(-1, 14):
            assert got.delay(key, attempt) == want.delay(key, attempt)
    for attempt in range(-1, 14):
        assert got.exhausted(attempt) == want.exhausted(attempt)
    with pytest.raises(ValueError):
        PORT.catchup.RetryLaw(base=0.0)


@pytest.mark.parametrize("cfg", [
    {}, {"CatchupRequestTimeout": 0.0, "CatchupTransactionsTimeout": 3.5},
    {"CatchupRequestTimeout": 1.25, "CatchupRetryBackoffMult": 2.0,
     "CatchupRetryBackoffMax": 9.0, "CatchupRetryJitterFrac": 0.5,
     "CatchupRetryJitterSeed": 99, "CatchupMaxRetries": 3}])
def test_retry_law_from_config_matches_jax(cfg):
    want = JAX.catchup.RetryLaw.from_config(JAX.getConfig(dict(cfg)))
    got = PORT.catchup.RetryLaw.from_config(PORT.getConfig(dict(cfg)))
    assert vars(got) == vars(want)
    assert [got.delay((1, 5), k) for k in range(1, 8)] \
        == [want.delay((1, 5), k) for k in range(1, 8)]


# --- pool scenarios (tests/test_catchup.py) -----------------------------------


def lagging_node(side):
    """tests/test_catchup.py::test_lagging_node_catches_up_and_rejoins"""
    pool = make_pool(side, 21)
    for i in range(2):
        pool.submit_request(i)
    pool.run_for(5)
    assert min(domain_sizes(pool)) == max(domain_sizes(pool))
    pool.network.disconnect("node3")
    for i in range(2, 10):
        pool.submit_request(i)
    pool.run_for(10)
    behind = pool.node("node3")
    assert ledger(behind).size < ledger(pool.node("node0")).size
    pool.network.reconnect("node3")
    for i in range(100, 104):
        pool.submit_request(i)
    pool.run_for(20)
    assert behind.leecher.catchups_completed >= 1
    assert len(set(domain_sizes(pool))) == 1
    assert len(set(domain_roots(pool))) == 1
    pre = ledger(behind).size
    for i in range(200, 203):
        pool.submit_request(i)
    pool.run_for(10)
    assert ledger(behind).size == pre + 3
    assert len(set(domain_roots(pool))) == 1
    return pool


def explicit_leecher(side):
    """test_restarted_node_syncs_via_explicit_catchup"""
    pool = make_pool(side, 22)
    for i in range(6):
        pool.submit_request(i)
    pool.run_for(8)
    pool.network.disconnect("node2")
    for i in range(6, 12):
        pool.submit_request(i)
    pool.run_for(10)
    pool.network.reconnect("node2")
    pool.node("node2").leecher.start()
    pool.run_for(10)
    assert len(set(domain_sizes(pool))) == 1
    assert len(set(domain_roots(pool))) == 1
    assert len({ledger(n, AUDIT).size for n in pool.nodes}) == 1
    return pool


def diverged_node(side):
    """test_diverged_node_detects_and_resyncs"""
    pool = make_pool(side, 23)
    for i in range(4):
        pool.submit_request(i)
    pool.run_for(6)
    evil = pool.node("node1")
    domain, audit = ledger(evil), ledger(evil, AUDIT)
    good_size = domain.size
    domain.reset_to(max(0, good_size - 2))
    domain.add({"fake": 1})
    domain.add({"fake": 2})
    assert domain.size == good_size
    audit.reset_to(max(0, audit.size - 1))
    audit.add({"fake_audit": 1})
    honest = pool.node("node0")
    assert domain.root_hash != ledger(honest).root_hash
    evil.leecher.start()
    pool.run_for(15)
    assert ledger(evil).root_hash == ledger(honest).root_hash
    assert ledger(evil, AUDIT).root_hash == ledger(honest, AUDIT).root_hash
    assert state_head(evil) == state_head(honest)
    return pool


def checkpoint_divergence(side):
    """test_checkpoint_divergence_triggers_recovery"""
    pool = make_pool(side, 24)
    for i in range(2):
        pool.submit_request(i)
    pool.run_for(5)
    evil = pool.node("node2")
    domain, audit = ledger(evil), ledger(evil, AUDIT)
    domain.reset_to(domain.size - 1)
    domain.add({"fake": 99})
    audit.reset_to(audit.size - 1)
    audit.add({"fake_audit": 99})
    evil.leecher.start()
    pool.run_for(15)
    assert len(set(domain_roots(pool))) == 1
    for i in range(50, 53):
        pool.submit_request(i)
    pool.run_for(8)
    assert len(set(domain_roots(pool))) == 1
    assert len(set(domain_sizes(pool))) == 1
    return pool


def failed_then_recovered(side):
    """test_failed_catchup_stays_non_participating_and_recovers: the
    audit ledger's truncation is broken (patched on both sides)."""
    pool = make_pool(side, 25, CatchupFailedRetryBackoff=2.0,
                     CatchupFailedRetryBackoffMax=2.0)
    for i in range(4):
        pool.submit_request(i)
    pool.run_for(6)
    assert len(set(domain_roots(pool))) == 1
    evil = pool.node("node1")
    alerts = []
    evil.internal_bus.subscribe(side.internal.RaisedSuspicion,
                                lambda m, *a: alerts.append(m.ex))
    domain, audit = ledger(evil), ledger(evil, AUDIT)
    domain.reset_to(domain.size - 1)
    domain.add({"fake": 1})
    audit.reset_to(audit.size - 1)
    audit.add({"fake_audit": 1})
    corrupted_root = domain.root_hash
    real_reset = audit.reset_to
    audit.reset_to = lambda size: None
    evil.leecher.start()
    pool.run_for(10)
    assert evil.leecher.catchups_failed >= 1
    assert evil.data.is_participating is False
    assert any(getattr(ex, "suspicion", None)
               is side.Suspicions.CATCHUP_FAILED for ex in alerts)
    ordered_before = len(evil.ordered_log)
    for i in range(50, 53):
        pool.submit_request(i)
    pool.run_for(8)
    assert ledger(pool.node("node0")).size > domain.size
    assert len(evil.ordered_log) == ordered_before
    assert domain.root_hash == corrupted_root
    assert evil.data.is_participating is False
    audit.reset_to = real_reset
    pool.run_for(10)
    assert evil.data.is_participating is True
    assert len(set(domain_roots(pool))) == 1
    assert len(set(domain_sizes(pool))) == 1
    pre = min(domain_sizes(pool))
    for i in range(200, 203):
        pool.submit_request(i)
    pool.run_for(8)
    assert domain_sizes(pool) == [pre + 3] * 4
    assert len(set(domain_roots(pool))) == 1
    return pool


def _record_requests(pool, side, frm="node1"):
    reqs = []

    def record(msg, sender, to):
        if isinstance(msg, side.msgs.CatchupReq) and sender == frm:
            reqs.append(msg)
        return None

    pool.network.add_delayer(record)
    return reqs


def suffix_refetch(side):
    """test_diverged_node_refetches_only_the_suffix"""
    pool = make_pool(side, 26)
    for i in range(12):
        pool.submit_request(i)
    pool.run_for(12)
    assert len(set(domain_roots(pool))) == 1
    evil = pool.node("node1")
    domain, audit = ledger(evil), ledger(evil, AUDIT)
    good_domain, good_audit = domain.size, audit.size
    domain.reset_to(good_domain - 2)
    domain.add({"fake": 1})
    domain.add({"fake": 2})
    audit.reset_to(good_audit - 2)
    audit.add({"fake_audit": 1})
    audit.add({"fake_audit": 2})
    reqs = _record_requests(pool, side)
    evil.leecher.start()
    pool.run_for(30)
    honest = pool.node("node0")
    assert ledger(evil).root_hash == ledger(honest).root_hash
    assert ledger(evil, AUDIT).root_hash == ledger(honest, AUDIT).root_hash
    audit_reqs = [r for r in reqs if r.ledgerId == AUDIT]
    domain_reqs = [r for r in reqs if r.ledgerId == DOMAIN]
    assert audit_reqs and min(r.seqNoStart for r in audit_reqs) \
        >= good_audit - 1
    assert domain_reqs and min(r.seqNoStart for r in domain_reqs) \
        >= good_domain - 1
    for i in range(100, 103):
        pool.submit_request(i)
    pool.run_for(8)
    assert len(set(domain_roots(pool))) == 1
    assert len(set(domain_sizes(pool))) == 1
    return pool


def corrupt_tail(side):
    """test_node_ahead_of_pool_with_corrupt_tail_recovers"""
    pool = make_pool(side, 27)
    for i in range(4):
        pool.submit_request(i)
    pool.run_for(6)
    assert len(set(domain_roots(pool))) == 1
    evil = pool.node("node2")
    domain, audit = ledger(evil), ledger(evil, AUDIT)
    honest_domain = domain.size
    domain.add({"fake": 1})
    domain.add({"fake": 2})
    audit.add({"fake_audit": 1})
    assert domain.size == honest_domain + 2
    evil.leecher.start()
    pool.run_for(20)
    assert len(set(domain_sizes(pool))) == 1
    assert len(set(domain_roots(pool))) == 1
    assert evil.data.is_participating is True
    for i in range(300, 303):
        pool.submit_request(i)
    pool.run_for(8)
    assert len(set(domain_roots(pool))) == 1
    assert len(set(domain_sizes(pool))) == 1
    return pool


def silent_seeder(side):
    """test_retry_law_reroutes_silent_seeder_and_is_metered"""
    pool = make_pool(side, 31, CatchupRequestTimeout=1.0,
                     CatchupBatchSize=2)
    for i in range(4):
        pool.submit_request(i)
    pool.run_for(6)
    pool.network.disconnect("node3")
    for i in range(4, 10):
        pool.submit_request(i)
    pool.run_for(8)
    pool.network.add_delayer(
        lambda msg, frm, to: float("inf")
        if isinstance(msg, side.msgs.CatchupRep) and frm == "node1"
        else None)
    pool.network.reconnect("node3")
    behind = pool.node("node3")
    behind.leecher.start()
    pool.run_for(30)
    assert behind.leecher.catchups_completed >= 1
    assert len(set(domain_sizes(pool))) == 1
    assert len(set(domain_roots(pool))) == 1
    stats = behind.leecher.catchup_stats()
    assert stats["retries"] >= 1
    assert stats["txns_leeched"] >= 6
    assert stats["proofs_verified"] >= stats["txns_leeched"]
    retr = pool.metrics.stat(side.MetricsName.CATCHUP_RETRIES)
    assert retr is not None and retr.total >= 1
    return pool


def exhausted_retries(side):
    """test_exhausted_retry_budget_fails_round_closed_then_recovers"""
    pool = make_pool(side, 32, CatchupRequestTimeout=0.5,
                     CatchupMaxRetries=3, CatchupFailedRetryBackoff=2.0,
                     CatchupFailedRetryBackoffMax=2.0)
    for i in range(4):
        pool.submit_request(i)
    pool.run_for(6)
    pool.network.disconnect("node2")
    for i in range(4, 8):
        pool.submit_request(i)
    pool.run_for(6)
    undo = pool.network.add_delayer(
        lambda msg, frm, to: float("inf")
        if isinstance(msg, side.msgs.CatchupRep) else None)
    pool.network.reconnect("node2")
    behind = pool.node("node2")
    behind.leecher.start()
    pool.run_for(25)
    assert behind.leecher.catchups_failed >= 1
    assert behind.data.is_participating is False
    assert behind.leecher.catchups_completed == 0
    undo()
    pool.run_for(15)
    assert behind.leecher.catchups_completed >= 1
    assert behind.data.is_participating is True
    assert len(set(domain_roots(pool))) == 1
    return pool


def gc_boundary_fork(side):
    """test_fork_point_on_gc_checkpoint_boundary"""
    pool = make_pool(side, 33)
    for i in range(8):
        pool.submit_request(i)
    pool.run_for(10)
    assert len(set(domain_roots(pool))) == 1
    evil = pool.node("node1")
    domain, audit = ledger(evil), ledger(evil, AUDIT)
    chk = pool.config.CHK_FREQ
    fork_at = ((domain.size - 1) // chk) * chk
    assert fork_at >= chk and fork_at % chk == 0
    tail = domain.size - fork_at
    domain.reset_to(fork_at)
    audit.reset_to(audit.size - tail)
    for i in range(tail):
        domain.add({"fake": i})
        audit.add({"fake_audit": i})
    reqs = _record_requests(pool, side)
    evil.leecher.start()
    pool.run_for(30)
    assert ledger(evil).root_hash == ledger(pool.node("node0")).root_hash
    domain_reqs = [r for r in reqs if r.ledgerId == DOMAIN]
    assert domain_reqs
    assert min(r.seqNoStart for r in domain_reqs) >= fork_at
    for i in range(50, 53):
        pool.submit_request(i)
    pool.run_for(8)
    assert len(set(domain_roots(pool))) == 1
    assert len(set(domain_sizes(pool))) == 1
    return pool


def empty_ledger(side):
    """test_empty_ledger_catchup_resyncs_everything"""
    pool = make_pool(side, 34)
    for i in range(4):
        pool.submit_request(i)
    pool.run_for(6)
    assert len(set(domain_roots(pool))) == 1
    wiped = pool.node("node2")
    for lid in (DOMAIN, AUDIT):
        ledger(wiped, lid).reset_to(0)
    assert ledger(wiped).size == 0
    wiped.leecher.start()
    pool.run_for(20)
    assert len(set(domain_sizes(pool))) == 1
    assert len(set(domain_roots(pool))) == 1
    assert state_head(wiped) == state_head(pool.node("node0"))
    pre = min(domain_sizes(pool))
    for i in range(100, 103):
        pool.submit_request(i)
    pool.run_for(8)
    assert domain_sizes(pool) == [pre + 3] * 4
    return pool


SCENARIOS = {fn.__name__: fn for fn in (
    lagging_node, explicit_leecher, diverged_node, checkpoint_divergence,
    failed_then_recovered, suffix_refetch, corrupt_tail, silent_seeder,
    exhausted_retries, gc_boundary_fork, empty_ledger)}


@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_port_catchup_matches_jax(case):
    want = fingerprint(SCENARIOS[case](JAX))
    got_pool = SCENARIOS[case](PORT)
    got = fingerprint(got_pool)
    for key in want:
        assert got[key] == want[key], key
    assert sum(s["rounds_started"] for s in got["catchup_stats"]) >= 1
    assert all(isinstance(n.seeder, PORT.catchup.SeederService)
               for n in got_pool.nodes)


def test_nodes_without_real_execution_have_no_catchup_plane():
    pool = PORT.SimPool(4, seed=1, device="cpu")
    assert all(n.seeder is None and n.leecher is None for n in pool.nodes)
    want = JAX.SimPool(4, seed=1)
    assert all(n.seeder is None and n.leecher is None for n in want.nodes)


# --- the services alone (tests/test_catchup.py:415, :595) ---------------------


def probe_statuses(side):
    """test_probe_statuses_are_never_status_evidence"""
    led = side.Ledger()
    for i in range(8):
        led.add({"k": i})
    db = side.DatabaseManager()
    db.register_new_database(1, led, None)
    bus = side.ExternalBus(lambda msg, dst=None: None)
    timer = side.QueueTimer()
    quorums = side.Quorums(4)
    service = side.ConsProofService(1, bus, timer, db,
                                    quorums_provider=lambda: quorums)
    outcome = []
    service.start(lambda target, diverged: outcome.append(
        (target, diverged)))
    corrupt_root = side.b58encode(b"\x07" * 32)
    probe = side.msgs.LedgerStatus(
        ledgerId=1, txnSeqNo=4, viewNo=None, ppSeqNo=None,
        merkleRoot=corrupt_root, protocolVersion=2, probe=True)
    for s in ("evil1", "evil2", "evil3"):
        service.process_ledger_status(probe, s)
    record = {"after_probes": (sorted(service._divergence_votes),
                               list(outcome))}
    assert not service._divergence_votes and not outcome
    genuine = side.msgs.LedgerStatus(
        ledgerId=1, txnSeqNo=4, viewNo=None, ppSeqNo=None,
        merkleRoot=corrupt_root, protocolVersion=2)
    service.process_ledger_status(genuine, "peer1")
    record["after_genuine"] = sorted(service._divergence_votes)
    assert len(service._divergence_votes) == 1
    fork = side.ForkPointService(1, bus, timer, db,
                                 quorums_provider=lambda: quorums)
    found = []
    fork.start(found.append)
    fork._mid = 4
    low_probe = side.msgs.LedgerStatus(
        ledgerId=1, txnSeqNo=2, viewNo=None, ppSeqNo=None,
        merkleRoot=corrupt_root, protocolVersion=2, probe=True)
    for s in ("evil1", "evil2", "evil3"):
        fork.process_ledger_status(low_probe, s)
    record["fork"] = (dict(fork._tip_votes), list(found), fork._lo,
                      fork._hi)
    assert not fork._tip_votes and not found
    return record


def conflicting_cons_proofs(side):
    """test_conflicting_cons_proofs_from_byzantine_seeders"""
    led = side.Ledger()
    for i in range(4):
        led.add({"k": i})
    own_size, own_root = led.size, led.root_hash
    honest = side.Ledger()
    for i in range(10):
        honest.add({"k": i})
    db = side.DatabaseManager()
    db.register_new_database(1, led, None)
    bus = side.ExternalBus(lambda msg, dst=None: None)
    service = side.ConsProofService(
        1, bus, side.QueueTimer(), db,
        quorums_provider=lambda: side.Quorums(4))
    outcome = []
    service.start(lambda target, diverged: outcome.append(
        (target, diverged)))
    b58 = side.b58encode

    def proof(end, root_b58, hashes):
        return side.msgs.ConsistencyProof(
            ledgerId=1, seqNoStart=own_size, seqNoEnd=end, viewNo=None,
            ppSeqNo=None, oldMerkleRoot=b58(own_root),
            newMerkleRoot=root_b58, hashes=hashes)

    forged = proof(12, b58(b"\x05" * 32), [b58(b"\x06" * 32)])
    service.process_consistency_proof(forged, "evil1")
    service.process_consistency_proof(forged, "evil2")
    assert not outcome and not service._votes
    record = {"forged": (dict(service._votes), list(outcome))}
    good = proof(honest.size, b58(honest.root_hash),
                 [b58(h) for h in honest.consistency_proof(own_size)])
    service.process_consistency_proof(good, "peer1")
    assert not outcome
    record["one_vote"] = ({k: sorted(v) for k, v in service._votes.items()},
                          list(outcome))
    service.process_consistency_proof(good, "peer2")
    assert outcome == [((honest.size, b58(honest.root_hash)), False)]
    record["decided"] = list(outcome)
    return record


@pytest.mark.parametrize("case", [probe_statuses, conflicting_cons_proofs],
                         ids=lambda fn: fn.__name__)
def test_port_services_match_jax(case):
    assert case(PORT) == case(JAX)


# --- K10 inside catchup: chip_smoke.py's phase L on the CPU -------------------

L_MISSED = 40  # >= DEVICE_MIN_BATCH proofs in the first domain slice


def _jax_pool(config):
    config = dict(config, StateCommitBatchMode="host")
    return JAX.SimPool(4, seed=chip_smoke.L_SEED, real_execution=True,
                       config=JAX.getConfig(config), trace=True)


def _port_pool(config):
    config = dict(config, StateCommitBatchMode="host")
    return PORT.SimPool(4, seed=chip_smoke.L_SEED, real_execution=True,
                        config=PORT.getConfig(config), trace=True,
                        device="cpu")


@pytest.mark.parametrize("tamper", [False, True], ids=["L1", "L2"])
def test_phase_l_runs_k10_in_catchup_as_jax(monkeypatch, tamper):
    monkeypatch.setattr(JAX.crs, "OFFLOAD_POLICY",
                        JAX.crs._AdaptiveOffload())
    # run_catchup_l gives the port's policy a fresh instance itself
    monkeypatch.setattr(PORT.crs, "OFFLOAD_POLICY", PORT.crs.OFFLOAD_POLICY)
    want = chip_smoke.run_catchup_l(None, tamper, L_MISSED,
                                    make_pool=_jax_pool)
    got = chip_smoke.run_catchup_l("cpu", tamper, L_MISSED,
                                   make_pool=_port_pool)
    for key in chip_smoke.L_COMPARE:
        assert got[key] == want[key], key
    assert got["txns_leeched"] >= L_MISSED
    # the first domain slice went through K10 (its plain version here)
    assert got["proofs_on_card"] >= L_MISSED
    assert want["proofs_on_card"] == 0  # the spy sees the port only
    assert got["k10_calls"] == []  # CPU tensors: nothing to hold after
    if tamper:
        assert got["altered"] == want["altered"] == {"peer": "node0",
                                                     "altered": 1}
        assert got["reps_rejected"] >= 1
        assert got["rep_wrong_suspicions"] >= 1
    else:
        assert got["reps_rejected"] == 0 and got["altered"] is None


def test_phase_l_default_pool_is_the_port_on_its_device(monkeypatch):
    monkeypatch.setattr(PORT.crs, "OFFLOAD_POLICY", PORT.crs.OFFLOAD_POLICY)
    folded = []
    fold = PORT.crs._ChunkedDeviceVerify

    def spy(leaf_data, *args):
        folded.append(len(leaf_data))
        return fold(leaf_data, *args)

    monkeypatch.setattr(PORT.crs, "_ChunkedDeviceVerify", spy)
    got = chip_smoke.run_catchup_l("cpu", False, L_MISSED)
    assert folded and max(folded) >= L_MISSED
    assert got["proofs_on_card"] == sum(folded)


@pytest.mark.parametrize("device_kw", [{}, {"device": "cuda"}],
                         ids=["default", "cuda"])
def test_rep_service_and_leecher_need_the_card_unless_cpu(monkeypatch,
                                                          device_kw):
    """The leecher's rep services verify on the card unless given
    ``device="cpu"``: without CUDA they raise instead of running the plain
    version, as a real-execution pool does."""
    import torch

    from indy_plenum_tpu_torch.common.event_bus import InternalBus
    from indy_plenum_tpu_torch.server.consensus.consensus_shared_data import (
        ConsensusSharedData,
    )
    from indy_plenum_tpu_torch.server.ledgers_bootstrap import (
        LedgersBootstrap,
    )
    from indy_plenum_tpu_torch.utils.torch_env import NoCudaDevice

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    boot = LedgersBootstrap(domain_genesis=[], device="cpu").build()
    db = boot.db
    bus = PORT.ExternalBus(lambda msg, dst=None: None)
    timer = PORT.QueueTimer()
    with pytest.raises(NoCudaDevice):
        PORT.crs.CatchupRepService(DOMAIN, bus, timer, db, **device_kw)
    data = ConsensusSharedData("node0", ["node0", "node1", "node2", "node3"],
                               inst_id=0, is_master=True)
    with pytest.raises(NoCudaDevice):
        PORT.catchup.NodeLeecherService(data, InternalBus(), bus, timer,
                                        boot, **device_kw)
    svc = PORT.crs.CatchupRepService(DOMAIN, bus, timer, db, device="cpu")
    assert svc._device.type == "cpu"
    PORT.catchup.NodeLeecherService(data, InternalBus(), bus, timer, boot,
                                    device="cpu")
