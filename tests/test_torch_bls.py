"""BLS multi-signatures in the port against the JAX package.

- The port's affine oracle (``crypto/bls/bn254.py``) and its native
  backend (``bn254_native``, the repo's ``native/bn254/bn254c.c`` built by
  the port's own ``utils/native_build.py``) against the JAX package's
  oracle: G1/G2 multiples, sums, subgroup checks and pairings on seeded
  scalars, equal to the last integer.
- ``BlsKeyPair``, ``BlsCryptoSigner.sign``, ``aggregate_sigs``,
  ``verify_sig``, ``verify_multi_sig``, ``verify_pop`` and the batched
  verify: byte-equal strings and equal verdicts, a tampered share, a
  non-canonical and an off-curve point included. ``PAIRINGS`` is a module
  global in each package: parity compares the two counters' deltas.
- ``BlsBftReplica`` through a real-execution pool (``SimPool(bls=True)``):
  the same ordering, trace, ledgers, every node's BLS store and the same
  proved read as the JAX pool on one seed.
"""
import hashlib
import random

import pytest

pytest.importorskip("jax")

from indy_plenum_tpu.crypto.bls import bls_crypto as jbc  # noqa: E402
from indy_plenum_tpu.crypto.bls import bn254 as jbn  # noqa: E402
from indy_plenum_tpu_torch.crypto.bls import bls_crypto as tbc  # noqa: E402
from indy_plenum_tpu_torch.crypto.bls import bn254 as tbn  # noqa: E402
from indy_plenum_tpu_torch.crypto.bls import bn254_native as tnat  # noqa: E402,E501
from indy_plenum_tpu_torch.utils.base58 import b58decode, b58encode  # noqa: E402,E501


def _scalars(seed, n):
    rng = random.Random(seed)
    return [rng.randrange(1, jbn.R) for _ in range(n)] + [0, 1, jbn.R - 1]


def test_oracle_and_native_group_arithmetic_match_jax():
    for k in _scalars(5, 6):
        want1 = jbn.g1_mul(jbn.G1_GEN, k)
        assert tbn.g1_mul(tbn.G1_GEN, k) == want1
        assert tnat.g1_mul(tbn.G1_GEN, k) == want1
        want2 = jbn.g2_mul(jbn.G2_GEN, k)
        assert tbn.g2_mul(tbn.G2_GEN, k) == want2
        assert tnat.g2_mul(tbn.G2_GEN, k) == want2
    pts1 = [jbn.g1_mul(jbn.G1_GEN, k) for k in _scalars(6, 5)]
    pts2 = [jbn.g2_mul(jbn.G2_GEN, k) for k in _scalars(7, 5)]
    acc1 = acc2 = None
    for p in pts1:
        acc1 = jbn.g1_add(acc1, p)
    for p in pts2:
        acc2 = jbn.g2_add(acc2, p)
    assert tnat.g1_sum(pts1) == acc1
    assert tnat.g2_sum(pts2) == acc2
    assert tnat.g2_in_subgroup(pts2[0]) and jbn.g2_in_subgroup(pts2[0])
    # square roots: a residue and a non-residue
    rng = random.Random(8)
    for _ in range(8):
        x = rng.randrange(jbn.P)
        root = tnat.fp_sqrt(x)
        if root is None:
            assert pow(x, (jbn.P - 1) // 2, jbn.P) == jbn.P - 1
        else:
            assert root * root % jbn.P == x


def test_pairings_match_jax_oracle():
    a, b = _scalars(9, 2)[:2]
    p = jbn.g1_mul(jbn.G1_GEN, a)
    q = jbn.g2_mul(jbn.G2_GEN, b)
    want = jbn.pairing(q, p)
    assert tbn.pairing(q, p) == want
    assert tnat.pairing(q, p) == want
    # bilinearity: e(aP, bQ) == e(P, abQ), and the checked product
    assert tnat.pairing_check([(p, q), (jbn.g1_neg(jbn.G1_GEN),
                                        jbn.g2_mul(jbn.G2_GEN, a * b))])
    assert not tnat.pairing_check([(p, q), (jbn.g1_neg(jbn.G1_GEN), q)])
    assert tnat.multi_pairing([(p, q), (jbn.G1_GEN, jbn.G2_GEN)]) == \
        jbn.multi_pairing([(p, q), (jbn.G1_GEN, jbn.G2_GEN)])


def _keys(pkg, n, tag=b"torch-bls"):
    return [pkg.BlsKeyPair(hashlib.sha256(tag + b"%d" % i).digest())
            for i in range(n)]


def _counted(pkg, fn):
    before = pkg.PAIRINGS.snapshot()
    out = fn()
    after = pkg.PAIRINGS.snapshot()
    return out, (after[0] - before[0], after[1] - before[1])


def test_sign_aggregate_verify_match_jax():
    n = 7
    jk, tk = _keys(jbc, n), _keys(tbc, n)
    assert [k.pk_b58 for k in tk] == [k.pk_b58 for k in jk]
    assert [k.pop() for k in tk] == [k.pop() for k in jk]
    msg = b"multi-sig-value|ledger:1|root"
    jsigs = [jbc.BlsCryptoSigner(k).sign(msg) for k in jk]
    tsigs = [tbc.BlsCryptoSigner(k).sign(msg) for k in tk]
    assert tsigs == jsigs
    pks = [k.pk_b58 for k in jk]
    agg = tbc.BlsCryptoVerifier.aggregate_sigs(tsigs)
    assert agg == jbc.BlsCryptoVerifier.aggregate_sigs(jsigs)
    # a tampered share: another message's signature in the set
    bad = list(tsigs)
    bad[3] = tbc.BlsCryptoSigner(tk[3]).sign(b"other")
    bad_agg = tbc.BlsCryptoVerifier.aggregate_sigs(bad)
    assert bad_agg == jbc.BlsCryptoVerifier.aggregate_sigs(bad)
    # off-curve and non-canonical points: both packages refuse to sum
    off = b58encode((1).to_bytes(32, "big") + (3).to_bytes(32, "big"))
    big = b58encode(jbn.P.to_bytes(32, "big") + (2).to_bytes(32, "big"))
    for evil in (off, big):
        for pkg in (tbc, jbc):
            with pytest.raises(ValueError):
                pkg.BlsCryptoVerifier.aggregate_sigs(tsigs[:2] + [evil])
    cases = [
        ("verify_sig", (tsigs[0], msg, pks[0])),
        ("verify_sig", (tsigs[0], b"x", pks[0])),
        ("verify_sig", (off, msg, pks[0])),
        ("verify_sig", (big, msg, pks[0])),
        ("verify_multi_sig", (agg, msg, pks)),
        ("verify_multi_sig", (bad_agg, msg, pks)),
        ("verify_multi_sig", (agg, msg, pks[:-1])),
        ("verify_multi_sig", (off, msg, pks)),
        ("verify_pop", (tk[2].pop(), pks[2])),
        ("verify_pop", (tk[2].pop(), pks[1])),
        ("verify_pop", (tk[2].pop(), "not-a-key")),
    ]
    for name, args in cases:
        got, got_n = _counted(
            tbc, lambda: getattr(tbc.BlsCryptoVerifier, name)(*args))
        want, want_n = _counted(
            jbc, lambda: getattr(jbc.BlsCryptoVerifier, name)(*args))
        assert (got, got_n) == (want, want_n), (name, args)
    assert tbc.NATIVE_BACKEND


def test_point_codecs_match_jax():
    pt1 = jbn.g1_mul(jbn.G1_GEN, 12345)
    pt2 = jbn.g2_mul(jbn.G2_GEN, 6789)
    raw1, raw2 = tbc.g1_to_bytes(pt1), tbc.g2_to_bytes(pt2)
    assert raw1 == jbc.g1_to_bytes(pt1) and raw2 == jbc.g2_to_bytes(pt2)
    assert tbc.g1_from_bytes(raw1) == pt1 and tbc.g2_from_bytes(raw2) == pt2
    assert tbc.g1_from_bytes(bytes(64)) is None
    flipped = bytearray(raw1)
    flipped[-1] ^= 1
    for pkg in (tbc, jbc):
        with pytest.raises(ValueError):
            pkg.g1_from_bytes(bytes(flipped))
        with pytest.raises(ValueError):
            pkg.g2_from_bytes(raw2[:-1])
    assert tbc.hash_to_g1(b"abc") == jbc.hash_to_g1(b"abc")
    assert b58decode(b58encode(raw1)) == raw1


def test_batch_verify_matches_jax_and_names_the_forgery():
    from indy_plenum_tpu.proofs import verify_multi_sigs_batch as jbatch
    from indy_plenum_tpu_torch.proofs import verify_multi_sigs_batch as tbatch

    jk = _keys(jbc, 5, b"torch-batch")
    pks = [k.pk_b58 for k in jk]
    items = []
    for j in range(6):
        msg = b"window-root-%d" % j
        items.append((jbc.BlsCryptoVerifier.aggregate_sigs(
            [jbc.BlsCryptoSigner(k).sign(msg) for k in jk]), msg, pks))
    forged = list(items)
    forged[4] = (items[4][0], b"window-root-forged", pks)
    for batch in (items, forged, items[:1], []):
        got, got_n = _counted(tbc, lambda: tbatch(batch, seed=7))
        want, want_n = _counted(jbc, lambda: jbatch(batch, seed=7))
        assert (got, got_n) == (want, want_n)
    assert tbatch(forged, seed=7) == [True] * 4 + [False, True]
    # the aggregate-and-verify cycle of BASELINE config 3
    shares = [([jbc.BlsCryptoSigner(k).sign(m) for k in jk], m, pks)
              for m in (b"a", b"b")]
    assert tbc.BlsCryptoVerifier.aggregate_and_verify_batch(shares) == \
        jbc.BlsCryptoVerifier.aggregate_and_verify_batch(shares)


def test_multi_signature_value_objects_match_jax():
    fields = dict(ledger_id=1, state_root_hash="s", pool_state_root_hash="p",
                  txn_root_hash="t", timestamp=1_700_000_000)
    tv, jv = tbc.MultiSignatureValue(**fields), jbc.MultiSignatureValue(
        **fields)
    assert tv.serialize() == jv.serialize()
    tm = tbc.MultiSignature("sig", ["node1", "node0"], tv)
    jm = jbc.MultiSignature("sig", ["node1", "node0"], jv)
    assert tm.as_dict() == jm.as_dict()
    assert tbc.MultiSignature.from_dict(jm.as_dict()) == tm


def _bls_store(pool, name):
    return list(pool.node(name).bls_replica.store._kv.iterator())


def _bls_pool(pool_cls, config_fn, **kw):
    pool = pool_cls(4, seed=21, real_execution=True, bls=True,
                    config=config_fn({
                        "Max3PCBatchWait": 0.1, "Max3PCBatchSize": 3,
                        "CHK_FREQ": 2, "LOG_SIZE": 6,
                        "StateCommitBatchMode": "host"}), trace=True, **kw)
    for i in range(12):
        pool.submit_request(i)
    pool.run_for(15)
    return pool


def test_bls_replica_through_a_pool_matches_jax():
    from indy_plenum_tpu.config import getConfig as jax_config
    from indy_plenum_tpu.simulation.pool import SimPool as JaxPool
    from indy_plenum_tpu_torch.config import getConfig as port_config
    from indy_plenum_tpu_torch.simulation.pool import SimPool as PortPool

    (port, port_n) = _counted(
        tbc, lambda: _bls_pool(PortPool, port_config, device="cpu"))
    (ref, ref_n) = _counted(jbc, lambda: _bls_pool(JaxPool, jax_config))
    assert port_n == ref_n and port_n[0] > 0
    assert port.ordered_hash() == ref.ordered_hash()
    assert port.trace.trace_hash(exclude_cats=("dispatch",)) == \
        ref.trace.trace_hash(exclude_cats=("dispatch",))
    assert {name: (kp.pk_b58, pk, pop)
            for name, (kp, pk, pop) in port.bls_keys.items()} == \
        {name: (kp.pk_b58, pk, pop)
         for name, (kp, pk, pop) in ref.bls_keys.items()}
    for nd in port.nodes:
        assert port.ledger_hash(nd.name) == ref.ledger_hash(nd.name)
        store = _bls_store(port, nd.name)
        assert store and store == _bls_store(ref, nd.name)
        assert nd.bls_replica.latest_multi_sig.as_dict() == \
            ref.node(nd.name).bls_replica.latest_multi_sig.as_dict()
        assert nd.proof_cache.counters() == \
            ref.node(nd.name).proof_cache.counters()
    did = port.trustee.identifier
    got = port.node("node1").read_nym_with_proof(did)
    want = ref.node("node1").read_nym_with_proof(did)
    assert got.as_dict() == want.as_dict()
    assert got.multi_sig is not None


def test_native_build_raises_with_the_compiler_message(tmp_path):
    from indy_plenum_tpu_torch.utils.native_build import build_native_ext

    src = tmp_path / "broken.c"
    src.write_text("#include <Python.h>\nint broken( {\n")
    with pytest.raises(RuntimeError, match="broken") as err:
        build_native_ext(str(src), str(tmp_path / "out"), "broken")
    assert "error" in str(err.value)
    assert not list((tmp_path / "out").iterdir())
