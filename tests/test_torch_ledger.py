"""The port's ledger, storage, serialization and txn modules against the
JAX package's on the same seeded inputs.

- ``CompactMerkleTree``: roots, historical roots, audit paths and
  consistency proofs at sizes around powers of two;
- ``Ledger``: two-phase append (stage, uncommitted root, commit, discard)
  and the stored bytes, against JAX's on the same seeded NYM txns;
- ``MerkleVerifier``: inclusion and consistency verdicts, tampered ones
  included;
- the port's msgpack codec against ``msgpack`` (encoder bytes and decoded
  objects, ``raw=False``), seeded edge values and hypothesis-drawn ones;
- ``txn_util``, the key-value stores and the NYM handler's state values.
"""
import random

import msgpack
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from indy_plenum_tpu.common import txn_util as jtxn
from indy_plenum_tpu.common.request import Request as JaxRequest
from indy_plenum_tpu.ledger.compact_merkle_tree import (
    CompactMerkleTree as JaxTree,
)
from indy_plenum_tpu.ledger.ledger import Ledger as JaxLedger
from indy_plenum_tpu.ledger.merkle_verifier import (
    STH as JaxSTH,
    MerkleVerifier as JaxVerifier,
)
from indy_plenum_tpu.storage import kv_store as jkv
from indy_plenum_tpu_torch.common import txn_util as ptxn
from indy_plenum_tpu_torch.common.request import Request
from indy_plenum_tpu_torch.common.serializers import serialization as ser
from indy_plenum_tpu_torch.ledger.compact_merkle_tree import (
    CompactMerkleTree,
)
from indy_plenum_tpu_torch.ledger.ledger import Ledger
from indy_plenum_tpu_torch.ledger.merkle_verifier import STH, MerkleVerifier
from indy_plenum_tpu_torch.storage import kv_store as pkv

SIZES = (1, 2, 3, 7, 8, 9, 31, 32, 33, 100)


def _leaves(n, seed=1):
    rng = random.Random(seed)
    return [rng.randbytes(rng.randrange(1, 80)) for _ in range(n)]


@pytest.mark.parametrize("n", SIZES)
def test_compact_merkle_tree_matches_jax(n):
    leaves = _leaves(n, seed=n)
    port, ref = CompactMerkleTree(), JaxTree()
    for leaf in leaves:
        assert port.append(leaf) == ref.append(leaf)
    assert port.root_hash == ref.root_hash
    assert port.hasher.hash_full_tree(leaves) == port.root_hash
    for size in range(1, n + 1):
        assert port.root_hash_at(size) == ref.root_hash_at(size)
        assert port.consistency_proof(size) == ref.consistency_proof(size)
    for index in range(n):
        assert port.audit_path(index) == ref.audit_path(index)
        assert port.audit_path(index, n) == ref.audit_path(index, n)
    extra = _leaves(3, seed=100 + n)
    assert port.root_with_extra_leaves(extra) \
        == ref.root_with_extra_leaves(extra)


@pytest.mark.parametrize("n", (5, 17, 64))
def test_merkle_verifier_matches_jax(n):
    leaves = _leaves(n, seed=7 * n)
    tree = CompactMerkleTree()
    tree.extend(leaves)
    port, ref = MerkleVerifier(), JaxVerifier()
    root = tree.root_hash
    for index in range(n):
        path = tree.audit_path(index)
        bad_path = path[:-1] if path else [b"\x00" * 32]
        for data, idx, p in ((leaves[index], index, path),
                             (leaves[index] + b"x", index, path),
                             (leaves[index], (index + 1) % n, path),
                             (leaves[index], index, bad_path)):
            got = port.verify_leaf_inclusion(data, idx, p, STH(n, root))
            want = ref.verify_leaf_inclusion(data, idx, p, JaxSTH(n, root))
            assert got == want
    for old in range(0, n + 1):
        proof = tree.consistency_proof(old)
        old_root = tree.root_hash_at(old)
        for pr in (proof, proof[:-1], [b"\x01" * 32] + proof):
            assert port.verify_consistency(old, n, old_root, root, pr) \
                == ref.verify_consistency(old, n, old_root, root, pr)
        assert port.verify_consistency(old, n, old_root, root, proof)


def _nym_txns(count, seed):
    rng = random.Random(seed)
    out = []
    for i in range(count):
        op = {"type": "1", "dest": "did%d" % rng.randrange(1 << 20),
              "verkey": "~" + "%032x" % rng.randrange(1 << 128)}
        out.append((op, 1000 + i))
    return out


def test_ledger_two_phase_append_matches_jax():
    port, ref = Ledger(), JaxLedger()
    txns = _nym_txns(40, seed=3)
    for lid, (ledger, req_cls, util) in enumerate(
            ((port, Request, ptxn), (ref, JaxRequest, jtxn))):
        staged = []
        for op, req_id in txns:
            req = req_cls(identifier="trustee", reqId=req_id,
                          operation=dict(op))
            staged.append(util.append_txn_metadata(
                util.reqToTxn(req), txn_time=1_700_000_000 + req_id))
        ledger.append_txns(staged[:10])
        ledger.commit_txns(6)
        ledger.discard_txns(2)
        ledger.append_txns(staged[10:30])
        ledger.commit_txns(10)
        ledger.append_txns(staged[30:])
    assert port.size == ref.size and port.uncommitted_size \
        == ref.uncommitted_size
    assert port.root_hash == ref.root_hash
    assert port.uncommitted_root_hash == ref.uncommitted_root_hash
    for seq in range(1, port.size + 1):
        assert port.get_serialized(seq) == ref.get_serialized(seq)
        assert port.get_by_seq_no(seq) == ref.get_by_seq_no(seq)
        assert port.audit_path(seq) == ref.audit_path(seq)
    for ledger in (port, ref):
        ledger.discard_txns(len(ledger.uncommitted_txns))
        ledger.reset_to(5)
    assert port.root_hash == ref.root_hash and port.size == 5


# --- the msgpack codec -------------------------------------------------------

EDGE_INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
             2 ** 64 - 1, -1, -32, -33, -128, -129, -2 ** 15, -2 ** 15 - 1,
             -2 ** 31, -2 ** 31 - 1, -2 ** 63]


def _edge_values():
    rng = random.Random(11)
    out = [None, True, False, 0.0, -1.5, 1e300, "", b""]
    out += EDGE_INTS
    for n in (1, 31, 32, 255, 256, 65535, 65536):
        out.append("".join(rng.choice("abcé€𝄞") for _ in range(n)))
        out.append(rng.randbytes(n))
    for n in (0, 15, 16, 65536):
        out.append([rng.randrange(-300, 300) for _ in range(n)])
    for n in (0, 15, 16, 300):
        out.append({"k%d" % i: [i, "v", None, {"x": b"\x00"}]
                    for i in range(n)})
    # the NYM handler's state value, with and without role
    out.append({"verkey": "~abc", "role": "0", "seqNo": 17,
                "txnTime": 1_700_000_000})
    out.append({"verkey": None, "role": None, "seqNo": 1, "txnTime": None})
    return out


@pytest.mark.parametrize("value", _edge_values(),
                         ids=lambda v: type(v).__name__)
def test_msgpack_codec_matches_msgpack_on_edges(value):
    packed = msgpack.packb(value, use_bin_type=True)
    assert ser.packb(value) == packed
    assert ser.unpackb(packed) == msgpack.unpackb(packed, raw=False)


_values = st.recursive(
    st.none() | st.booleans()
    | st.integers(min_value=-2 ** 63, max_value=2 ** 64 - 1)
    | st.floats(allow_nan=False) | st.text(max_size=40)
    | st.binary(max_size=40),
    lambda inner: st.lists(inner, max_size=6)
    | st.dictionaries(st.text(max_size=8), inner, max_size=6),
    max_leaves=25)


@settings(max_examples=200, deadline=None, derandomize=True)
@given(_values)
def test_msgpack_codec_matches_msgpack_drawn(value):
    packed = msgpack.packb(value, use_bin_type=True)
    assert ser.packb(value) == packed
    assert ser.unpackb(packed) == msgpack.unpackb(packed, raw=False)


@pytest.mark.parametrize("data", [b"", b"\x92\x01", b"\xa3ab", b"\x01\x02",
                                  b"\xc1", b"\xd9\x02a", b"\xa1\xff"])
def test_msgpack_decoder_refuses_what_msgpack_refuses(data):
    with pytest.raises(Exception):
        msgpack.unpackb(data, raw=False)
    with pytest.raises(ser.UnpackError):
        ser.unpackb(data)


def test_serializers_match_jax():
    from indy_plenum_tpu.common.serializers import serialization as jser

    txn = {"b": [1, {"z": None, "a": "é"}], "a": 2}
    assert ser.ledger_txn_serializer.dumps(txn) \
        == jser.ledger_txn_serializer.dumps(txn)
    assert ser.ledger_txn_serializer.loads(
        jser.ledger_txn_serializer.dumps(txn)) == txn
    root = bytes(range(32))
    assert ser.state_roots_serializer.serialize(root) \
        == jser.state_roots_serializer.serialize(root)
    assert ser.state_roots_serializer.deserialize(
        jser.state_roots_serializer.serialize(root)) == root
    blob = msgpack.packb({1: b"x", "y": [None]}, use_bin_type=True)
    assert ser.deserialize_msgpack(blob) == jser.deserialize_msgpack(blob)


def test_txn_util_matches_jax():
    op = {"type": "1", "dest": "did1", "verkey": "~vk"}
    port = Request(identifier="idr", reqId=5, operation=dict(op),
                   signature="sig")
    ref = JaxRequest(identifier="idr", reqId=5, operation=dict(op),
                     signature="sig")
    pt = ptxn.append_txn_metadata(ptxn.reqToTxn(port), seq_no=3,
                                  txn_time=99)
    jt = jtxn.append_txn_metadata(jtxn.reqToTxn(ref), seq_no=3, txn_time=99)
    assert pt == jt
    for name in ("get_type", "get_payload_data", "get_from", "get_req_id",
                 "get_digest", "get_seq_no", "get_txn_time", "get_version"):
        assert getattr(ptxn, name)(pt) == getattr(jtxn, name)(jt)


@pytest.mark.parametrize("kind", ["memory", "sqlite"])
def test_kv_stores_match_jax(kind, tmp_path):
    port = pkv.initKeyValueStorage(kind, str(tmp_path / "p"), "db")
    ref = jkv.initKeyValueStorage(kind, str(tmp_path / "j"), "db")
    rng = random.Random(2)
    for store in (port, ref):
        r = random.Random(2)
        for _ in range(50):
            key = b"k%03d" % r.randrange(100)
            store.put(key, r.randbytes(8))
        store.do_batch([(b"k001", None), (b"z", b"last"), (b"a", b"first")])
        store.remove(b"k002")
    assert port.size == ref.size
    assert list(port.iterator()) == list(ref.iterator())
    lo, hi = b"k%03d" % rng.randrange(50), b"k%03d" % rng.randrange(50, 100)
    assert list(port.iterator(lo, hi, include_value=False)) \
        == list(ref.iterator(lo, hi, include_value=False))
    assert port.get_equal_or_none(b"nope") is None
    # the file-backed kinds are the port's storage/file_stores.py
    # (tests/test_torch_file_stores.py holds them against the JAX stores)
    for file_kind in ("chunked_file", "text_file"):
        got = pkv.initKeyValueStorage(file_kind, str(tmp_path / "pf"), "x")
        want = jkv.initKeyValueStorage(file_kind, str(tmp_path / "jf"), "x")
        assert type(got).__name__ == type(want).__name__
        assert type(got).__module__.startswith("indy_plenum_tpu_torch.")
        got.close()
        want.close()
    port.close()
    ref.close()
