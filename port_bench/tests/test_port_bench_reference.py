"""The plain reference against the program's own codecs and trees, on
seeded data: the reference imports nothing of the program, so these
tests are where the two are held together."""
from __future__ import annotations

import hashlib
import random

import pytest

from port_bench.reference import bls, ed25519, merkle, msgpack, smt
from port_bench.reference.b58 import b58decode, b58encode


def test_msgpack_matches_the_programs_encoder():
    from indy_plenum_tpu_torch.common.serializers.serialization import (
        packb,
        serialize_for_signing,
    )

    rng = random.Random(3)
    for _ in range(200):
        obj = {"verkey": "~" + "x" * rng.randrange(60),
               "role": rng.choice([None, "0", "2"]),
               "seqNo": rng.choice([0, 5, 200, 70000, 2**40]),
               "txnTime": rng.choice([None, -3, -200, 1_700_000_000]),
               "n": [rng.randrange(-2**31, 2**31) for _ in range(3)],
               "b": bytes(rng.randrange(300)), "t": True, "f": 1.5}
        assert msgpack.packb(obj) == packb(obj)
        assert msgpack.signing_bytes(obj) == serialize_for_signing(obj)


def test_sparse_merkle_root_matches_the_programs_state():
    from indy_plenum_tpu_torch.state.sparse_merkle_state import (
        SparseMerkleState,
    )

    ours, theirs = smt.SparseMerkleTree(), SparseMerkleState(device="cpu")
    rng = random.Random(5)
    for i in range(60):
        key, value = b"did-%d" % rng.randrange(40), b"v%d" % i
        ours.set(key, value)
        theirs.set(key, value)
    theirs.commit()
    assert ours.root == theirs.committed_head_hash


def test_audit_paths_and_roots_match_the_programs_ledger():
    from indy_plenum_tpu_torch.ledger.compact_merkle_tree import (
        CompactMerkleTree,
    )

    leaves = [b"txn-%d" % i for i in range(77)]
    tree = CompactMerkleTree()
    tree.extend(leaves)
    roots = merkle.PrefixRoots(leaves)
    assert roots.root(77) == tree.root_hash
    for size in (1, 2, 3, 31, 64, 77):
        for index in range(size):
            path = tree.audit_path(index, size)
            root = roots.root(size)
            assert merkle.verify_inclusion(leaves[index], index, size, path,
                                           root)
            assert not merkle.verify_inclusion(leaves[index], index, size,
                                               path, hashlib.sha256().digest())
            if path:
                bad = [bytes([path[0][0] ^ 1]) + path[0][1:]] + path[1:]
                assert not merkle.verify_inclusion(leaves[index], index,
                                                   size, bad, root)


def test_ed25519_verify_matches_the_programs_signer():
    from indy_plenum_tpu_torch.crypto import ed25519 as program

    seed = bytes(range(32))
    pk = ed25519.public_key(seed)
    assert pk == program.public_key(seed)
    for i in range(4):
        msg = b"message %d" % i
        sig = program.sign(seed, msg)
        assert ed25519.verify(pk, msg, sig)
        bad = sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]
        assert not ed25519.verify(pk, msg, bad)


def test_bls_keys_hash_and_multi_signature_match_the_program():
    from indy_plenum_tpu_torch.crypto.bls.bls_crypto import (
        BlsCryptoSigner,
        BlsCryptoVerifier,
        BlsKeyPair,
        MultiSignature,
        MultiSignatureValue,
    )

    names = ["node0", "node1", "node2"]
    pairs = {n: BlsKeyPair(bls.key_seed(n)) for n in names}
    keys = {n: bls.public_key(bls.key_seed(n)) for n in names}
    for n in names:
        assert bls.g2_b58(keys[n]) == pairs[n].pk_b58
    value = MultiSignatureValue(1, "s" * 44, "p" * 44, "t" * 44, 17)
    message = value.serialize()
    sigs = [BlsCryptoSigner(pairs[n]).sign(message) for n in names]
    ms = MultiSignature(BlsCryptoVerifier.aggregate_sigs(sigs), names,
                        value).as_dict()
    assert bls.verify_multi_sig(ms, keys, 3)
    assert not bls.verify_multi_sig(ms, keys, 4)
    forged = dict(ms, value=dict(ms["value"], timestamp=18))
    assert not bls.verify_multi_sig(forged, keys, 3)


@pytest.mark.parametrize("data", [b"", b"\0\0abc", bytes(range(40))])
def test_base58_round_trips(data):
    from indy_plenum_tpu_torch.utils.base58 import b58encode as program

    assert b58encode(data) == program(data)
    assert b58decode(b58encode(data)) == data
