"""The port's transport (``indy_plenum_tpu_torch/network/``) against the
JAX package's.

- Wire bytes: the curve and client-stack keypairs of 8 seeds equal the
  JAX package's byte for byte; the port's ``serialize_msg`` gives the
  bytes msgpack-python gives through the reference's ``serialize_msg`` on
  one instance of every type in ``node_message_registry``, on a ``Batch``
  of them and on ``Request.as_dict()`` with and without ``None`` fields;
  the port's ``deserialize_msgpack`` gives back what the reference's does.
- The cases of ``tests/test_zstack.py`` (all but the one marked slow) on
  the port's ``ZStack``: attribution by curve key, an unknown key that
  cannot deliver, no speaking under another name, batch round trip, a
  malformed batch contained, an HWM drop counted, the looper draining
  transports before timers, the trace piggyback; a 4-node pool of the
  port's ``Node`` (``device="cpu"``) ordering signed writes over real
  sockets, and a primary crash that the socket monitors turn into a view
  change.
- Interoperation: a port ``ZStack`` and a JAX ``ZStack`` exchange a
  ``Batch`` both ways over real sockets.

The stacks here bind port 0 (the kernel's ephemeral range); nothing binds
a fixed port.
"""
import hashlib
import importlib
import time

import pytest

pytest.importorskip("jax")
pytest.importorskip("zmq")

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


# --- wire bytes ---------------------------------------------------------------

SEEDS = [hashlib.sha256(b"keys-%d" % i).digest() for i in range(8)]


def test_keypairs_equal_reference():
    ref, port = mod(JAX, "network.keys"), mod(PORT, "network.keys")
    for seed in SEEDS:
        assert port.curve_keypair_from_seed(seed) == \
            ref.curve_keypair_from_seed(seed)
        assert port.client_stack_keypair_from_seed(seed) == \
            ref.client_stack_keypair_from_seed(seed)
    with pytest.raises(ValueError):
        port.curve_keypair_from_seed(b"short")


def sample_value(field, depth=0):
    """A value ``field`` admits (one of each field type the registry's
    schemas use), for a message instance of every type."""
    from indy_plenum_tpu.common.constants import DOMAIN_LEDGER_ID
    from indy_plenum_tpu.utils.base58 import b58encode

    kind = type(field).__name__
    if kind == "AnyField":
        return {"k": [1, "v", None, 2.5, -7, True], "n": None}
    if kind == "BooleanField":
        return True
    if kind in ("NonNegativeNumberField", "RequestIdField"):
        return 2 ** 40 + 3
    if kind == "IntegerField":
        return -300
    if kind == "NonEmptyStringField":
        return "node1"
    if kind == "SignatureField":
        return b58encode(bytes(range(64)))
    if kind == "LimitedLengthStringField":
        return "x" * min(field.max_length, 40)
    if kind == "MerkleRootField":
        return b58encode(hashlib.sha256(b"root").digest())
    if kind == "TimestampField":
        return 1_700_000_000.25
    if kind == "LedgerIdField":
        return DOMAIN_LEDGER_ID
    if kind == "ProtocolVersionField":
        return 2
    if kind == "SerializedValueField":
        return b"\x00\x01serialized"
    if kind == "IterableField":
        return [sample_value(field.inner, depth + 1) for _ in range(2)]
    if kind == "MapField":
        return {sample_value(field.key, depth + 1):
                sample_value(field.value, depth + 1)}
    if kind == "FixedLengthTupleField":
        return [sample_value(inner, depth + 1) for inner in field.inners]
    raise AssertionError(f"no sample for {kind}")


def reference_messages():
    from indy_plenum_tpu.common.messages.message_base import (
        node_message_registry,
    )

    mod(JAX, "common.messages.node_messages")
    out = {}
    for typename, cls in sorted(node_message_registry._by_name.items()):
        kw = {name: sample_value(field) for name, field in cls.schema}
        if typename == "BATCH":
            kw["messages"] = [b"\x92\x01\x02", b"raw"]
        out[typename] = cls(**kw)
    return out


def test_serialize_msg_bytes_equal_reference():
    ref_ser = mod(JAX, "common.serializers.serialization")
    port_ser = mod(PORT, "common.serializers.serialization")
    port_registry = mod(PORT, "common.messages.message_base") \
        .node_message_registry
    mod(PORT, "common.messages.node_messages")
    msgs = reference_messages()
    assert len(msgs) == 22
    for typename, msg in msgs.items():
        data = msg.as_dict()
        want = ref_ser.serialize_msg(data)
        assert port_ser.serialize_msg(data) == want, typename
        # the port's message class keeps the schema's field order
        port_msg = port_registry.obj_from_dict(port_ser.unpackb(want))
        assert port_ser.serialize_msg(port_msg.as_dict()) == want, typename
        assert port_ser.deserialize_msgpack(want) == \
            ref_ser.deserialize_msgpack(want), typename
    # a Batch of every message, as the stack coalesces them
    inner = [ref_ser.serialize_msg(m.as_dict()) for m in msgs.values()]
    batch = mod(JAX, "common.messages.node_messages").Batch(
        messages=inner, signature=None).as_dict()
    want = ref_ser.serialize_msg(batch)
    assert port_ser.serialize_msg(batch) == want
    assert port_ser.deserialize_msgpack(want) == \
        ref_ser.deserialize_msgpack(want)


def test_request_wire_bytes_equal_reference():
    ref_ser = mod(JAX, "common.serializers.serialization")
    port_ser = mod(PORT, "common.serializers.serialization")
    for pkg_req in (mod(JAX, "common.request").Request,
                    mod(PORT, "common.request").Request):
        signer = mod(JAX, "crypto.signers").DidSigner(b"\x05" * 32)
        signed = pkg_req(identifier=signer.identifier, reqId=2 ** 33,
                         operation={"type": "1", "dest": "abc",
                                    "verkey": None, "n": [1, 2.5]})
        signer.sign_request(signed)
        bare = pkg_req(identifier=signer.identifier, reqId=1,
                       operation={"type": "105", "dest": "abc"})
        for req in (signed, bare):
            data = req.as_dict()
            want = ref_ser.serialize_msg(data)
            assert port_ser.serialize_msg(data) == want
            assert port_ser.deserialize_msgpack(want) == \
                ref_ser.deserialize_msgpack(want)
        assert None in signed.as_dict()["operation"].values()
        assert None not in bare.as_dict()["operation"].values()
        # signing drops None; the wire keeps it
        data = signed.as_dict()
        assert port_ser.serialize_for_signing(data) != \
            port_ser.serialize_msg(data)


def test_proof_nodes_serializer_matches_reference():
    ref_ser = mod(JAX, "common.serializers.serialization")
    port_ser = mod(PORT, "common.serializers.serialization")
    nodes = [[b"\x01" * 32, b"\x02" * 7], [b"leaf", b""], []]
    want = ref_ser.proof_nodes_serializer.serialize(nodes)
    assert port_ser.proof_nodes_serializer.serialize(nodes) == want
    assert port_ser.ProofNodesSerializer.deserialize(want) == \
        ref_ser.ProofNodesSerializer.deserialize(want)


def test_bad_wire_bytes_raise_an_exception_the_stacks_contain():
    """The port's decoder raises ``UnpackError`` (a ``ValueError``) where
    msgpack raises its own errors; both are ``Exception`` subclasses, so
    the stacks' broad ``except`` contains them."""
    port_ser = mod(PORT, "common.serializers.serialization")
    for bad in (b"\xc1", b"\x92\x01", b"\x01\x02", b"\xa3ab"):
        with pytest.raises(port_ser.UnpackError):
            port_ser.deserialize_msgpack(bad)
    assert issubclass(port_ser.UnpackError, Exception)


# --- the stack's own cases (tests/test_zstack.py) ------------------------------

def seed_of(name: str) -> bytes:
    return hashlib.sha256(b"zstack-test-" + name.encode()).digest()


def make_msg(pkg, n=1):
    return mod(pkg, "common.messages.node_messages").Checkpoint(
        instId=0, viewNo=0, seqNoStart=1, seqNoEnd=n, digest="d" * 16)


def pump_until(stacks, done, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if done():
            return True
        if sum(s.service() for s in stacks) == 0:
            time.sleep(0.002)
    return done()


def pump_for(stacks, seconds):
    pump_until(stacks, lambda: False, seconds)


def wire(names, pkgs=None):
    pkgs = pkgs or {name: PORT for name in names}
    stacks = {n: mod(pkgs[n], "network").ZStack(n, seed_of(n))
              for n in names}
    for a in stacks.values():
        for b in stacks.values():
            if a is not b:
                a.allow_peer(b.name, b.public_key)
                a.connect(b.name, b.ha, b.public_key)
    return stacks


def case_attributed_by_curve_key(stacks, extra):
    got = []
    stacks["A"].on_message = lambda msg, frm: got.append((msg, frm))
    stacks["B"].send(make_msg(PORT), ["A"])
    assert pump_until(stacks.values(), lambda: got), "nothing arrived"
    msg, frm = got[0]
    assert frm == "B"
    assert type(msg).__module__.startswith(PORT + ".")
    assert type(msg).__name__ == "Checkpoint"


def case_unknown_key_cannot_deliver(stacks, extra):
    attacker = mod(PORT, "network").ZStack("evil", seed_of("evil"))
    extra.append(attacker)
    attacker.connect("A", stacks["A"].ha, stacks["A"].public_key)
    got = []
    stacks["A"].on_message = lambda msg, frm: got.append((msg, frm))
    attacker.send(make_msg(PORT), ["A"])
    assert pump_until([*stacks.values(), attacker],
                      lambda: stacks["A"].rejected_unknown_key > 0)
    pump_for([*stacks.values(), attacker], 0.5)
    assert got == []


def case_no_speaking_under_another_name(stacks, extra):
    got = []
    stacks["A"].on_message = lambda msg, frm: got.append(frm)
    stacks["C"].send(make_msg(PORT), ["A"])
    assert pump_until(stacks.values(), lambda: got)
    pump_for(stacks.values(), 0.2)
    assert got == ["C"]


def case_batch_round_trip(stacks, extra):
    got = []
    stacks["A"].on_message = lambda msg, frm: got.append(msg)
    for i in range(25):
        stacks["B"].send(make_msg(PORT, i + 1), ["A"])
    assert pump_until(stacks.values(), lambda: len(got) >= 25)
    assert {m.seqNoEnd for m in got} == set(range(1, 26))
    assert stacks["A"].received == 25


def case_malformed_batch_contained(stacks, extra):
    ser = mod(PORT, "common.serializers.serialization")
    batch = mod(PORT, "common.messages.node_messages").Batch
    got = []
    stacks["A"].on_message = lambda msg, frm: got.append(msg)
    # deeply nested batches (recursion bomb), raw bytes via the dealer
    payload = ser.serialize_msg(make_msg(PORT).as_dict())
    for _ in range(1200):
        payload = ser.serialize_msg(
            batch(messages=[payload], signature=None).as_dict())
    sock = stacks["B"]._remotes["A"]
    sock.send(payload)
    # a str element (the schema admits str; dispatch must not crash)
    sock.send(ser.serialize_msg(
        batch(messages=["not-bytes"], signature=None).as_dict()))
    # bytes that are no msgpack at all: the port decoder's UnpackError
    sock.send(b"\xc1\xc1")
    stacks["B"].send(make_msg(PORT, 42), ["A"])
    assert pump_until(stacks.values(), lambda: got)
    pump_for(stacks.values(), 0.3)
    assert [m.seqNoEnd for m in got] == [42]


def case_hwm_drop_counted(stacks, extra):
    import zmq

    metrics_mod = mod(PORT, "common.metrics_collector")
    metrics = metrics_mod.MetricsCollector()
    stacks["B"]._metrics = metrics
    real_sock = stacks["B"]._remotes["A"]

    class FullSocket:
        def send(self, *a, **k):
            raise zmq.Again()

    stacks["B"]._remotes["A"] = FullSocket()
    try:
        for i in range(3):
            stacks["B"].send(make_msg(PORT, i + 1), ["A"])
        stacks["B"]._flush()
    finally:
        stacks["B"]._remotes["A"] = real_sock
    assert stacks["B"].dropped == 3
    stat = metrics.stat(metrics_mod.MetricsName.ZSTACK_DROPPED)
    assert stat is not None and stat.total == 3


def case_trace_piggyback(stacks, extra):
    prepare = mod(PORT, "common.messages.node_messages").Prepare
    recorder = mod(PORT, "observability.trace").TraceRecorder
    stacks["A"].trace = recorder(time.perf_counter, node="A")
    stacks["B"].trace = recorder(time.perf_counter, node="B")
    got = []
    stacks["B"].on_message = lambda msg, frm: got.append((msg, frm))
    stacks["A"].send(
        prepare(instId=0, viewNo=2, ppSeqNo=7, ppTime=time.time(),
                digest="d" * 16, stateRootHash=None, txnRootHash=None),
        ["B"])
    assert pump_until(stacks.values(), lambda: got)
    msg, frm = got[0]
    assert frm == "A" and msg.viewNo == 2 and msg.ppSeqNo == 7
    sends = [e for e in stacks["A"].trace.events() if e["name"] == "net.send"]
    recvs = [e for e in stacks["B"].trace.events() if e["name"] == "net.recv"]
    assert len(sends) == 1 and len(recvs) == 1
    assert sends[0]["key"] == [2, 7] == recvs[0]["key"]
    assert recvs[0]["args"]["id"] == sends[0]["args"]["id"]
    assert recvs[0]["args"]["sent"] == pytest.approx(sends[0]["ts"],
                                                     abs=1e-6)
    # untraced messages carry no context
    stacks["A"].trace = recorder(time.perf_counter, node="A")
    stacks["A"].send(make_msg(PORT), ["B"])
    assert pump_until(stacks.values(), lambda: len(got) == 2)
    assert type(got[1][0]).__name__ == "Checkpoint"


STACK_CASES = {
    "attributed_by_curve_key": (["A", "B"], case_attributed_by_curve_key),
    "unknown_key_cannot_deliver": (["A", "B"],
                                   case_unknown_key_cannot_deliver),
    "no_speaking_under_another_name": (["A", "B", "C"],
                                       case_no_speaking_under_another_name),
    "batch_round_trip": (["A", "B"], case_batch_round_trip),
    "malformed_batch_contained": (["A", "B"],
                                  case_malformed_batch_contained),
    "hwm_drop_counted": (["A", "B"], case_hwm_drop_counted),
    "trace_piggyback": (["A", "B"], case_trace_piggyback),
}


@pytest.mark.parametrize("case", sorted(STACK_CASES))
def test_zstack_case(case):
    names, fn = STACK_CASES[case]
    stacks = wire(names)
    extra = []
    try:
        fn(stacks, extra)
    finally:
        for s in [*stacks.values(), *extra]:
            s.close()


def test_looper_drains_transports_before_timer_events():
    looper = mod(PORT, "common.looper").Looper()
    order = []

    class FakeStack:
        def service(self):
            order.append("drain")
            return 0

    looper.add(FakeStack())
    looper.timer.schedule(0.0, lambda: order.append("tick"))
    looper._pump_once()
    assert order == ["drain", "tick"]


def test_port_and_reference_stacks_exchange_batches():
    """One port stack and one JAX stack, each admitting the other's key:
    a Batch of 5 goes each way, attributed by curve key, decoded into
    each side's own message classes."""
    stacks = wire(["P", "J"], {"P": PORT, "J": JAX})
    try:
        got = {"P": [], "J": []}
        for name, s in stacks.items():
            s.on_message = (lambda msg, frm, name=name:
                            got[name].append((msg, frm)))
        for i in range(5):
            stacks["P"].send(make_msg(PORT, i + 1), ["J"])
            stacks["J"].send(make_msg(JAX, i + 11), ["P"])
        assert pump_until(stacks.values(),
                          lambda: len(got["P"]) == 5 and len(got["J"]) == 5)
        assert [m.seqNoEnd for m, _ in got["J"]] == [1, 2, 3, 4, 5]
        assert [m.seqNoEnd for m, _ in got["P"]] == [11, 12, 13, 14, 15]
        assert {frm for _, frm in got["J"]} == {"P"}
        assert {frm for _, frm in got["P"]} == {"J"}
        assert all(type(m).__module__.startswith(JAX + ".")
                   for m, _ in got["J"])
        assert all(type(m).__module__.startswith(PORT + ".")
                   for m, _ in got["P"])
        assert stacks["P"].rejected_unknown_key == 0
        assert stacks["J"].rejected_unknown_key == 0
    finally:
        for s in stacks.values():
            s.close()


# --- pools of the port's Node over these stacks --------------------------------

def node_pool(config_overrides):
    from indy_plenum_tpu_torch.common.constants import TRUSTEE
    from indy_plenum_tpu_torch.common.looper import Looper
    from indy_plenum_tpu_torch.config import getConfig
    from indy_plenum_tpu_torch.crypto.signers import DidSigner
    from indy_plenum_tpu_torch.ledger.genesis import genesis_nym_txn
    from indy_plenum_tpu_torch.network import ZStackNetwork
    from indy_plenum_tpu_torch.server.node import Node

    names = [f"node{i}" for i in range(4)]
    config = getConfig(dict({"Max3PCBatchWait": 0.05,
                             "Max3PCBatchSize": 10,
                             "PropagateBatchWait": 0.02},
                            **config_overrides))
    trustee = DidSigner(b"\x09" * 32)
    genesis = [genesis_nym_txn(trustee.identifier, trustee.verkey,
                               role=TRUSTEE)]
    looper = Looper()
    stacks = wire(names)
    nodes = []
    for name in names:
        net = ZStackNetwork(stacks[name])
        node = Node(name, names, looper.timer, net, config=config,
                    domain_genesis=[dict(t) for t in genesis],
                    seed_keys={trustee.identifier: trustee.verkey},
                    device="cpu")
        net.mark_connected(set(names) - {name})
        node.start()
        looper.add(stacks[name])
        nodes.append(node)
    return looper, stacks, nodes, trustee


def test_socket_pool_orders_requests_end_to_end():
    """A real 4-node pool of the port's ``Node`` over real sockets: signed
    NYMs ordered and executed on every node (the drains verify with the
    plain versions on the CPU)."""
    from indy_plenum_tpu_torch.common.constants import (
        NYM,
        TARGET_NYM,
        TXN_TYPE,
        VERKEY,
    )
    from indy_plenum_tpu_torch.common.request import Request
    from indy_plenum_tpu_torch.crypto.signers import DidSigner

    looper, stacks, nodes, trustee = node_pool({})
    try:
        reqs = []
        for i in range(6):
            target = DidSigner(hashlib.sha256(b"sock-target-%d" % i)
                               .digest())
            req = Request(identifier=trustee.identifier, reqId=i + 1,
                          operation={TXN_TYPE: NYM,
                                     TARGET_NYM: target.identifier,
                                     VERKEY: target.verkey})
            trustee.sign_request(req)
            reqs.append(req)
        assert nodes[0].authnr.authenticate_batch([reqs[0]]).all()
        for i, req in enumerate(reqs):
            nodes[i % 4].submit_client_request(req, client_id="cli")
        ok = looper.run_until(
            lambda: all(len(n.ordered_digests) == 6 for n in nodes),
            timeout=30)
        assert ok, [len(n.ordered_digests) for n in nodes]
        assert len({tuple(n.ordered_digests) for n in nodes}) == 1
        for node in nodes:
            for req in reqs:
                assert node.get_nym_data(req.operation["dest"]) is not None
        assert looper.errors == 0
    finally:
        looper.shutdown()
        for node in nodes:
            node.stop()
        for s in stacks.values():
            s.close()


def test_primary_crash_detected_and_view_changed_over_sockets():
    """The primary's stack closes; the libzmq monitors report the drop,
    the primary-disconnect detector votes, and the survivors complete a
    view change over real sockets."""
    looper, stacks, nodes, _ = node_pool(
        {"ToleratePrimaryDisconnection": 1.0})
    try:
        assert looper.run_until(
            lambda: all(len(s._handshaken) == 3 for s in stacks.values()),
            timeout=30)
        assert nodes[1].data.primaries[0] == "node0"
        looper.remove(stacks["node0"])
        nodes[0].stop()
        stacks["node0"].close()
        survivors = nodes[1:]
        ok = looper.run_until(
            lambda: all(n.data.view_no >= 1
                        and not n.data.waiting_for_new_view
                        for n in survivors), timeout=30)
        assert ok, [(n.name, n.data.view_no) for n in survivors]
        assert all(n.data.primaries[0] != "node0" for n in survivors)
    finally:
        looper.shutdown()
        for node in nodes[1:]:
            node.stop()
        for s in stacks.values():
            s.close()
