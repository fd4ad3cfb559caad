"""The deployed validator node in the port against the JAX package.

Each case runs the same scenario through the JAX package's ``NodePool``
and through the port's (``device="cpu"``: the plain versions of the
kernels), on the same seed with the same requests, checks the reference
test's own claims on both, and holds the two runs equal on the node
fingerprint of ``chip_smoke.node_record``: per node the ordered digests,
view, primaries, stable checkpoint, every ledger's size and root and
every state's committed head, the monitor's degradation votes and
snapshot; the client's results. Ordering and roots are exact; floats
(the monitor's ratios) agree to 1e-9.

- Node (``tests/test_node.py``): single-entry ordering everywhere,
  finalisation on a node that missed PROPAGATEs, replay rejected, a
  forged signature NACKed and not propagated, state-backed verkey
  resolution, the device quorum in tick mode, reads NACKed while not
  participating.
- Byzantine (``tests/test_byzantine_node.py``): an equivocating primary,
  an unsigned request that f byzantine PROPAGATEs cannot finalise, and
  the everything-on pool (BLS, f+1 instances, pool genesis, the device
  plane on a tick, checkpoints, a proved read).
- Pool membership from the pool ledger (``tests/test_pool_manager.py``),
  observers (``tests/test_observer.py``), proved reads and GET_TXN
  through the client (``tests/test_read_client.py``), actions
  (``tests/test_actions.py``), plugins (``tests/test_plugins_tools.py``)
  and the notifier (``tests/test_notifier_logging.py``).
"""
import hashlib
import importlib
import math
import sys
import types

import pytest

pytest.importorskip("jax")

import chip_smoke  # noqa: E402

JAX, PORT = "indy_plenum_tpu", "indy_plenum_tpu_torch"
TOL = 1e-9


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain kernels are many small eager ops: one torch thread runs
    them no slower, and stays fast when the test workers share the
    cores."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class Pkg:
    """One package's surface, so a scenario reads the same for both."""

    def __init__(self, name):
        self.name = name

    def mod(self, path):
        return importlib.import_module(f"{self.name}.{path}")

    def _device(self, kw):
        if self.name == PORT:
            kw.setdefault("device", "cpu")
        return kw

    def pool(self, *args, **kw):
        return self.mod("simulation.node_pool").NodePool(
            *args, **self._device(kw))

    def observer(self, *args, **kw):
        return self.mod("server.observer").Observer(
            *args, **self._device(kw))

    def config(self, overrides):
        return self.mod("config").getConfig(overrides)

    def const(self, name):
        return getattr(self.mod("common.constants"), name)

    def msg(self, name):
        return getattr(self.mod("common.messages.node_messages"), name)

    def request(self, **kw):
        return self.mod("common.request").Request(**kw)

    def signer(self, seed):
        return self.mod("crypto.signers").DidSigner(seed)


def same(got, want, where="record"):
    """Equal, but for floats, which agree to ``TOL``."""
    if isinstance(want, float) or isinstance(got, float):
        assert isinstance(got, (int, float)) and isinstance(
            want, (int, float)), (where, got, want)
        assert math.isclose(got, want, rel_tol=TOL, abs_tol=TOL), \
            (where, got, want)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got, key=str) == \
            sorted(want, key=str), (where, got, want)
        for key in want:
            same(got[key], want[key], f"{where}.{key}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), \
            (where, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"{where}[{i}]")
    else:
        assert got == want, (where, got, want)


def record(pool, client=None, digests=()):
    return chip_smoke.node_record(pool, client, digests)


def all_ordered(pool, count):
    return all(len(n.ordered_digests) == count for n in pool.nodes)


def kinds(node, client_id=None):
    return [type(m).__name__ for c, m in node.client_outbox
            if client_id is None or c == client_id]


# --- tests/test_node.py ----------------------------------------------------

def node_single_entry(pkg):
    pool = pkg.pool(4, seed=1)
    req = pool.make_nym_request()
    assert pool.submit_to("node2", req)
    pool.run_for(15)
    assert all_ordered(pool, 1) and pool.honest_nodes_agree()
    nyms = [n.get_nym_data(req.operation["dest"]) for n in pool.nodes]
    assert all(d["verkey"] == req.operation["verkey"] for d in nyms)
    entry = pool.node("node2")
    assert {"RequestAck", "Reply"} <= set(kinds(entry))
    reply = entry.replies[req.digest].result
    assert reply["txnMetadata"]["seqNo"] >= 1
    return dict(record=record(pool), nyms=nyms, kinds=kinds(entry),
                reply=reply)


def node_missed_propagates(pkg):
    pool = pkg.pool(4, seed=2)
    delay = pkg.mod("simulation.sim_network").delay_message_types
    undelay = pool.network.add_delayer(
        delay(pkg.msg("Propagate"), to="node3"))
    req = pool.make_nym_request()
    pool.submit_to("node0", req)
    pool.run_for(20)
    undelay()
    assert all_ordered(pool, 1) and pool.honest_nodes_agree()
    nym = pool.node("node3").get_nym_data(req.operation["dest"])
    assert nym is not None
    return dict(record=record(pool), nym=nym)


def node_replay(pkg):
    pool = pkg.pool(4, seed=3)
    req = pool.make_nym_request()
    pool.submit_to("node1", req)
    pool.run_for(15)
    assert all_ordered(pool, 1)
    again = [pool.submit_to("node1", req), pool.submit_to("node2", req)]
    assert again == [False, False]
    nacks = [m.reason for _, m in pool.node("node1").client_outbox
             if type(m).__name__ == "RequestNack"]
    assert nacks and "already processed" in nacks[-1]
    pool.run_for(10)
    assert all_ordered(pool, 1)
    return dict(record=record(pool), nacks=nacks)


def node_forged_signature(pkg):
    pool = pkg.pool(4, seed=4)
    req = pool.make_nym_request()
    req.operation["evil"] = True
    pool.submit_to("node0", req)
    pool.run_for(10)
    assert all_ordered(pool, 0)
    reasons = [m.reason for _, m in pool.node("node0").client_outbox
               if type(m).__name__ == "RequestNack"]
    assert any("signature" in r for r in reasons)
    spread = [n.propagator.requests.get(req.digest) is not None
              for n in pool.nodes[1:]]
    assert not any(spread)
    return dict(record=record(pool), reasons=reasons, spread=spread)


def node_state_backed_verkey(pkg):
    pool = pkg.pool(4, seed=5)
    nym_req = pool.make_nym_request()
    target = nym_req.target_signer
    pool.submit_to("node0", nym_req)
    pool.run_for(15)
    assert all_ordered(pool, 1)
    assert all(target.identifier not in n.authnr._seed_keys
               for n in pool.nodes)
    follow_up = pool.make_nym_request(signer=target)
    pool.submit_to("node3", follow_up)
    pool.run_for(15)
    entry = pool.node("node3")
    assert "RequestAck" in kinds(entry)
    return dict(record=record(pool), kinds=kinds(entry))


def node_device_quorum_tick(pkg):
    config = pkg.config({"Max3PCBatchWait": 0.1, "Max3PCBatchSize": 5,
                         "PropagateBatchWait": 0.05,
                         "QuorumTickInterval": 0.05})
    pool = pkg.pool(4, seed=6, config=config, device_quorum=True)
    for i in range(6):
        pool.submit_to(f"node{i % 4}", pool.make_nym_request())
    pool.run_for(30)
    assert all_ordered(pool, 6) and pool.honest_nodes_agree()
    assert pool.vote_group.flushes > 0
    return dict(record=record(pool))


def node_reads_not_participating(pkg):
    pool = pkg.pool(4, seed=7)
    req = pool.make_nym_request()
    pool.submit_to("node0", req)
    pool.run_for(15)
    assert all_ordered(pool, 1)
    node = pool.node("node2")

    def read(req_id):
        return pkg.request(identifier=pool.trustee.identifier,
                           reqId=req_id, operation={
                               pkg.const("TXN_TYPE"): pkg.const("GET_NYM"),
                               pkg.const("TARGET_NYM"):
                               req.operation["dest"]})

    assert node.submit_client_request(read(999), client_id="c1") is True
    served = node.client_outbox[-1][1]
    assert type(served).__name__ == "Reply"
    node.data.is_participating = False
    assert node.submit_client_request(read(1000), client_id="c1") is False
    nack = node.client_outbox[-1][1]
    assert "catching up" in nack.reason
    return dict(record=record(pool), served=served.result,
                nack=nack.reason)


# --- tests/test_byzantine_node.py ------------------------------------------

def byzantine_equivocating_primary(pkg):
    config = pkg.config({"Max3PCBatchWait": 0.1, "Max3PCBatchSize": 2,
                         "PropagateBatchWait": 0.05,
                         "ToleratePrimaryDisconnection": 10_000.0,
                         "NewViewTimeout": 5.0})
    pool = pkg.pool(4, seed=201, config=config)
    primary = pool.node("node0")
    PrePrepare = pkg.msg("PrePrepare")
    original_send = pool.network._make_send_handler("node0")

    def equivocating_send(msg, dst=None):
        if isinstance(msg, PrePrepare):
            for to in sorted(set(pool.validators) - {"node0"}):
                out = msg
                if to in ("node2", "node3"):
                    forged = msg._fields
                    forged["digest"] = hashlib.sha256(
                        (msg.digest + to).encode()).hexdigest()
                    out = PrePrepare(**forged)
                pool.network._deliver_later(out, "node0", to)
            return
        original_send(msg, dst)

    primary.external_bus._send_handler = equivocating_send
    pool.submit_to("node1", pool.make_nym_request())
    pool.run_for(60)
    honest = [n for n in pool.nodes if n.name != "node0"]
    logs = [tuple(n.ordered_digests) for n in honest]
    shortest = min(len(log) for log in logs)
    assert all(log[:shortest] == logs[0][:shortest] for log in logs)
    assert all(n.data.view_no >= 1 and n.data.primaries[0] != "node0"
               for n in honest)
    return dict(record=record(pool))


def byzantine_unsigned_request(pkg):
    pool = pkg.pool(4, seed=202)
    forged = pkg.request(identifier=pool.trustee.identifier, reqId=999,
                         operation={"type": "1", "dest": "EvilDid",
                                    "verkey": "EvilKey"})
    forged.signature = "1" * 88
    pool.node("node3").external_bus.send(pkg.msg("Propagate")(
        request=forged.as_dict(), senderClient="evil"))
    pool.run_for(15)
    states = []
    for node in pool.nodes[:3]:
        state = node.propagator.requests.get(forged.digest)
        assert state is None or not state.finalised, node.name
        assert forged.digest not in node.ordered_digests
        assert node.get_nym_data("EvilDid") is None
        states.append(None if state is None else state.finalised)
    return dict(record=record(pool), states=states)


def everything_on(pkg, writes=24):
    """tests/test_byzantine_node.py:90: every plane at once."""
    config = pkg.config({"Max3PCBatchWait": 0.1, "Max3PCBatchSize": 4,
                         "PropagateBatchWait": 0.05,
                         "QuorumTickInterval": 0.05,
                         "CHK_FREQ": 5, "LOG_SIZE": 15,
                         "ThroughputWindowSize": 5, "ThroughputMinCnt": 4})
    pool = pkg.pool(4, seed=203, config=config, device_quorum=True,
                    bls=True, num_instances=0, with_pool_genesis=True)
    client = pool.make_client()
    digests = [client.submit_write(pool.make_nym_request())
               for _ in range(writes)]
    pool.run_for(60)
    pool.pump_client(client)
    for node in pool.nodes:
        assert len(node.ordered_digests) == writes, node.name
        assert node.data.stable_checkpoint >= 5, node.name
        assert node.replicas.backups, node.name
    assert pool.vote_group.flushes > 0
    assert all(client.result(d) is not None for d in digests)
    dest = client.result(digests[0])["txn"]["data"]["dest"]
    read = pkg.request(identifier="reader", reqId=5000, operation={
        pkg.const("TXN_TYPE"): pkg.const("GET_NYM"),
        pkg.const("TARGET_NYM"): dest})
    rd = client.submit_read(read, to="node3")
    pool.pump_client(client)
    assert client.result(rd) is not None and rd in client.proved_reads
    return dict(record=record(pool, client, digests),
                read=client.result(rd))


# --- tests/test_pool_manager.py ---------------------------------------------

def _node_request(pkg, steward, alias, req_id, services=None):
    c = pkg.const
    data = {c("ALIAS"): alias, c("NODE_IP"): "127.0.0.1",
            c("NODE_PORT"): 9800, c("CLIENT_IP"): "127.0.0.1",
            c("CLIENT_PORT"): 9801}
    if services is not None:
        data[c("SERVICES")] = services
    req = pkg.request(identifier=steward.identifier, reqId=req_id,
                      operation={c("TXN_TYPE"): c("NODE"),
                                 c("TARGET_NYM"): f"nym-{alias}",
                                 "data": data})
    steward.sign_request(req)
    return req


def pool_grows_to_n5(pkg):
    """A NODE txn admits node4: every node reconfigures to n=5, the new
    node catches up through the txn that admitted it, and the pool of
    five orders."""
    c = pkg.const
    pool = pkg.pool(4, seed=52, with_pool_genesis=True)
    assert all(n.pool_manager.validators == pool.validators
               for n in pool.nodes)

    def order(req, entry, total):
        pool.submit_to(entry, req)
        pool.run_for(15)
        assert all_ordered(pool, total)

    order(pool.make_nym_request(), "node0", 1)
    steward5 = pkg.signer(hashlib.sha256(b"steward-5").digest())
    nym = pkg.request(identifier=pool.trustee.identifier, reqId=900,
                      operation={c("TXN_TYPE"): c("NYM"),
                                 c("TARGET_NYM"): steward5.identifier,
                                 c("VERKEY"): steward5.verkey,
                                 c("ROLE"): c("STEWARD")})
    pool.trustee.sign_request(nym)
    order(nym, "node0", 2)
    changed = []
    for node in pool.nodes:
        node.on_membership_changed_hook = \
            lambda v, reg, n=node.name: changed.append((n, list(v)))
    order(_node_request(pkg, steward5, "node4", 901), "node0", 3)
    expected = [f"node{i}" for i in range(5)]
    assert all(n.data.validators == expected and n.data.quorums.n == 5
               for n in pool.nodes)
    assert len(changed) == 4
    new = pool.add_node("node4")
    pool.run_for(30)
    assert new.pool_manager.validators == expected
    req = pool.make_nym_request()
    pool.submit_to("node1", req)
    pool.run_for(20)
    nyms = [n.get_nym_data(req.operation["dest"]) for n in pool.nodes]
    assert all(d is not None for d in nyms)
    return dict(record=record(pool), changed=changed,
                registry=[n.pool_manager.registry for n in pool.nodes],
                quorums=[n.data.quorums.commit.value for n in pool.nodes],
                nyms=nyms)


def pool_demotes_primary(pkg):
    """The master primary demoted by a NODE txn is voted out."""
    pool = pkg.pool(4, seed=55, with_pool_genesis=True)
    demote = _node_request(pkg, pool.stewards["node0"], "node0", 906,
                           services=[])
    pool.submit_to("node1", demote)
    pool.run_for(30)
    survivors = [n for n in pool.nodes if n.name != "node0"]
    for node in survivors:
        assert node.data.validators == ["node1", "node2", "node3"]
        assert node.data.view_no >= 1 and \
            node.data.primaries[0] != "node0"
    req = pool.make_nym_request()
    pool.submit_to("node1", req)
    pool.run_for(20)
    assert all(n.get_nym_data(req.operation["dest"]) is not None
               for n in survivors)
    return dict(record=record(pool))


# --- tests/test_observer.py --------------------------------------------------

def _bls_pks(pool):
    return {n: pk for n, (kp, pk, pop) in pool.bls_keys.items()}


def _observed(observer):
    domain = observer.boot.db.get_ledger(1)
    state = observer.boot.db.get_state(1)
    return dict(size=domain.size, root=domain.root_hash.hex(),
                state=state.committed_head_hash.hex(),
                applied=observer.batches_applied,
                rejected=observer.batches_rejected,
                catchups=observer.catchups)


def observer_with_bls(pkg):
    pool = pkg.pool(4, seed=81, bls=True)
    observer = pkg.observer(
        "observer1", pool.network, pool_bls_keys=_bls_pks(pool),
        weak_quorum=1, validators=list(pool.validators),
        domain_genesis=[dict(t) for t in pool._domain_genesis])
    pool.network.connect_all()
    for node in pool.nodes:
        node.observer_registry.add("observer1")
    reqs = [pool.make_nym_request() for _ in range(3)]
    for i, req in enumerate(reqs):
        pool.submit_to(f"node{i % 4}", req)
    pool.run_for(20)
    seen = _observed(observer)
    validator = pool.nodes[0].boot.db
    assert seen["applied"] >= 1 and seen["size"] == \
        validator.get_ledger(1).size
    assert seen["state"] == validator.get_state(1).committed_head_hash.hex()
    nyms = [observer.get_nym_data(r.operation["dest"]) for r in reqs]
    assert all(d is not None for d in nyms)
    return dict(record=record(pool), observer=seen, nyms=nyms)


def observer_late_catchup(pkg):
    pool = pkg.pool(4, seed=84, bls=True)
    early = [pool.make_nym_request() for _ in range(2)]
    for i, req in enumerate(early):
        pool.submit_to(f"node{i % 4}", req)
    pool.run_for(15)
    observer = pkg.observer(
        "late-observer", pool.network, pool_bls_keys=_bls_pks(pool),
        domain_genesis=[dict(t) for t in pool._domain_genesis],
        timer=pool.timer, pool_size=4, gap_timeout=2.0)
    pool.network.connect_all()
    for node in pool.nodes:
        node.observer_registry.add("late-observer")
    late = pool.make_nym_request()
    pool.submit_to("node2", late)
    pool.run_for(20)
    seen = _observed(observer)
    assert seen["catchups"] >= 1
    assert seen["root"] == pool.nodes[0].boot.db.get_ledger(
        1).root_hash.hex()
    assert all(observer.get_nym_data(r.operation["dest"]) is not None
               for r in early + [late])
    return dict(record=record(pool), observer=seen)


# --- tests/test_read_client.py -----------------------------------------------

def _write_one(pool, client):
    req = pool.make_nym_request()
    digest = client.submit_write(req)
    pool.run_for(15)
    pool.pump_client(client)
    return req, digest


def client_proved_read(pkg):
    pool = pkg.pool(4, seed=42, bls=True)
    client = pool.make_client()
    req, digest = _write_one(pool, client)
    assert len(client.pending[digest].replies) >= 2
    read = pkg.request(identifier="reader", reqId=100, operation={
        pkg.const("TXN_TYPE"): pkg.const("GET_NYM"),
        pkg.const("TARGET_NYM"): req.operation["dest"]})
    rd = client.submit_read(read, to="node2")
    pool.pump_client(client)
    result = client.result(rd)
    assert result is not None and result["data"] is not None
    assert rd in client.proved_reads
    return dict(record=record(pool, client, [digest]), read=result)


def client_get_txn(pkg):
    pool = pkg.pool(4, seed=44)
    client = pool.make_client()
    _, digest = _write_one(pool, client)
    seq_no = client.result(digest)["txnMetadata"]["seqNo"]
    c = pkg.const
    read = pkg.request(identifier="reader", reqId=102, operation={
        c("TXN_TYPE"): c("GET_TXN"), "ledgerId": c("DOMAIN_LEDGER_ID"),
        "data": seq_no})
    client.submit_read(read)
    pool.pump_client(client)
    assert len(client.pending[read.digest].replies) >= 2
    result = client.result(read.digest)
    proof = result["auditProof"]
    b58decode = pkg.mod("utils.base58").b58decode
    merkle = pkg.mod("ledger.merkle_verifier")
    leaf = pkg.mod("common.serializers.serialization") \
        .ledger_txn_serializer.dumps(result["data"])
    sth = merkle.STH(tree_size=proof["ledgerSize"],
                     sha256_root_hash=b58decode(proof["rootHash"]))
    assert merkle.MerkleVerifier().verify_leaf_inclusion(
        leaf, seq_no - 1, [b58decode(h) for h in proof["auditPath"]], sth)
    return dict(record=record(pool, client, [digest]), read=result)


# --- tests/test_actions.py ---------------------------------------------------

def _action(pool, pkg, node_name, signer, op, req_id=1):
    op = dict(op, timestamp=pool.timer.get_current_time())
    req = pkg.request(identifier=signer.identifier, reqId=req_id,
                      operation=op)
    signer.sign_request(req)
    node = pool.node(node_name)
    ok = node.submit_client_request(req, client_id="ops")
    msgs = [m for c, m in node.client_outbox if c == "ops"]
    node.client_outbox.clear()
    return ok, msgs


def actions_info_and_restart(pkg):
    """VALIDATOR_INFO after a write, a replay of it, a POOL_RESTART that
    fires on the node's clock, and an unprivileged author refused."""
    c = pkg.const
    pool = pkg.pool(4, seed=111)
    nym = pool.make_nym_request()
    pool.submit_to("node0", nym)
    pool.run_for(15)
    ok, msgs = _action(pool, pkg, "node2", pool.trustee,
                       {c("TXN_TYPE"): c("VALIDATOR_INFO")})
    (reply,) = [m for m in msgs if type(m).__name__ == "Reply"]
    info = dict(reply.result["data"])
    # the node's metrics summary holds host wall-clock series
    info.pop("metrics")
    assert ok and info["name"] == "node2" and \
        info["last_ordered_3pc"][1] >= 1
    node = pool.node("node1")
    now = pool.timer.get_current_time()
    ok, msgs = _action(pool, pkg, "node1", pool.trustee,
                       {c("TXN_TYPE"): c("POOL_RESTART"),
                        "datetime": now + 5}, req_id=2)
    (restart,) = [m for m in msgs if type(m).__name__ == "Reply"]
    assert ok and 4.0 <= restart.result["scheduled_in"] <= 5.0
    assert not node.restart_requested
    pool.run_for(6)
    assert node.restart_requested
    refused, msgs = _action(pool, pkg, "node0", nym.target_signer,
                            {c("TXN_TYPE"): c("VALIDATOR_INFO")}, req_id=3)
    reasons = [m.reason for m in msgs if type(m).__name__ == "RequestNack"]
    assert not refused and any("may not run" in r for r in reasons)
    return dict(record=record(pool), info=info,
                scheduled_in=restart.result["scheduled_in"],
                reasons=reasons)


# --- tests/test_plugins_tools.py ---------------------------------------------

CUSTOM_TYPE = "9999"


def _install_demo_plugin(pkg):
    """A plugin registering a write handler for a custom txn type on the
    config ledger, against the package's own handler interface."""
    base = pkg.mod("server.request_handlers.handler_interfaces") \
        .WriteRequestHandler
    get_payload_data = pkg.mod("common.txn_util").get_payload_data
    config_ledger = pkg.const("CONFIG_LEDGER_ID")

    class KvHandler(base):
        def __init__(self, db):
            super().__init__(db, CUSTOM_TYPE, config_ledger)

        def static_validation(self, request):
            self._validate_type(request)

        def dynamic_validation(self, request, req_pp_time):
            pass

        def update_state(self, txn, prev_result, request=None,
                         is_committed=False):
            data = get_payload_data(txn)
            self.state.set(data["k"].encode(), data["v"].encode())

    name = f"demo_kv_plugin_{pkg.name}"
    mod = types.ModuleType(name)
    mod.plugin_entry = lambda node: \
        node.boot.write_manager.register_req_handler(
            KvHandler(node.boot.db))
    sys.modules[name] = mod
    return name


def plugin_custom_txn(pkg):
    config = pkg.config({"Max3PCBatchWait": 0.1, "Max3PCBatchSize": 10,
                         "PropagateBatchWait": 0.05,
                         "PluginModules": (_install_demo_plugin(pkg),)})
    pool = pkg.pool(4, seed=101, config=config)
    req = pkg.request(identifier=pool.trustee.identifier, reqId=1,
                      operation={pkg.const("TXN_TYPE"): CUSTOM_TYPE,
                                 "k": "color", "v": "amaranth"})
    pool.trustee.sign_request(req)
    pool.submit_to("node1", req)
    pool.run_for(15)
    assert all_ordered(pool, 1)
    values = [n.boot.db.get_state(pkg.const("CONFIG_LEDGER_ID")).get(
        b"color", is_committed=True) for n in pool.nodes]
    assert values == [b"amaranth"] * 4
    # a missing or raising plugin stops the node from starting
    faulty = types.ModuleType(f"exploding_plugin_{pkg.name}")

    def boom(node):
        raise RuntimeError("kaboom")

    faulty.plugin_entry = boom
    sys.modules[faulty.__name__] = faulty
    error = pkg.mod("plugins.loader").PluginLoadError
    for modules, seed in (((faulty.__name__,), 102),
                          (("no_such_module_xyz",), 103)):
        with pytest.raises(error):
            pkg.pool(4, seed=seed, config=pkg.config(
                {"PluginModules": modules}))
    return dict(record=record(pool))


# --- tests/test_notifier_logging.py ------------------------------------------

def notifier_events(pkg):
    """The fail-closed catchup alarm and a raising sink, isolated."""
    pool = pkg.pool(4, seed=72)
    node = pool.nodes[0]
    got, good = [], []

    def bad_sink(event):
        raise RuntimeError("webhook down")

    node.notifier.register_sink(got.append)
    node.notifier.register_sink(bad_sink)
    node.notifier.register_sink(good.append)
    suspicious = pkg.mod("common.exceptions").SuspiciousNode
    codes = pkg.mod("server.suspicion_codes").Suspicions
    raised = pkg.mod("common.messages.internal_messages").RaisedSuspicion
    node.internal_bus.send(raised(inst_id=0, ex=suspicious(
        node.name, codes.CATCHUP_FAILED)))
    node.notifier._emit("test_event", detail=1)
    notifier = pkg.mod("server.notifier")
    assert any(e["kind"] == notifier.CATCHUP_FAILED for e in got)
    assert good[-1]["kind"] == "test_event" and good == got
    return dict(events=got, recent=list(node.notifier.events))


CASES = {
    "single_entry": node_single_entry,
    "missed_propagates": node_missed_propagates,
    "replay": node_replay,
    "forged_signature": node_forged_signature,
    "state_backed_verkey": node_state_backed_verkey,
    "device_quorum_tick": node_device_quorum_tick,
    "reads_not_participating": node_reads_not_participating,
    "equivocating_primary": byzantine_equivocating_primary,
    "unsigned_request": byzantine_unsigned_request,
    "everything_on": everything_on,
    "pool_grows_to_n5": pool_grows_to_n5,
    "pool_demotes_primary": pool_demotes_primary,
    "observer_with_bls": observer_with_bls,
    "observer_late_catchup": observer_late_catchup,
    "client_proved_read": client_proved_read,
    "client_get_txn": client_get_txn,
    "actions": actions_info_and_restart,
    "plugin_custom_txn": plugin_custom_txn,
    "notifier_events": notifier_events,
}


@pytest.mark.parametrize("name", list(CASES))
def test_node_case_matches_jax(name):
    want = CASES[name](Pkg(JAX))
    got = CASES[name](Pkg(PORT))
    same(got, want)


def test_node_pool_is_the_port():
    """The port's pool is built of the port's Node, Monitor, Propagator,
    pool manager, request managers and client, and hands its device to
    the node's authenticator, SMT states and vote group."""
    pool = Pkg(PORT).pool(4, seed=9, device_quorum=True, num_instances=0)
    node = pool.nodes[0]
    for obj in (node, node.monitor, node.propagator, node.pool_manager,
                node.read_manager, node.action_manager, node.notifier,
                node.observer_registry, node.req_idr_to_txn,
                pool.make_client()):
        assert type(obj).__module__.startswith(PORT + "."), type(obj)
    assert node.authnr.device.type == "cpu"
    assert node.boot.db.get_state(1).device.type == "cpu"
    assert pool.vote_group.device.type == "cpu"
