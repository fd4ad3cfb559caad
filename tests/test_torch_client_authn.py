"""The port's ingress authentication against the JAX package: batch
verdicts on mixed requests (multi-sig, an unresolvable verkey, bad base58,
a wrong-length signature, a tampered payload) through the device-hash
route and the reference's host-hash route, the
host oracle, signers and request digests, and the msgpack signing encoder
byte-equal to ``msgpack.packb`` on generated payloads."""
import msgpack
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

pytest.importorskip("jax")

from indy_plenum_tpu.common import request as jreq  # noqa: E402
from indy_plenum_tpu.common.serializers import serialization as jser  # noqa: E402,E501
from indy_plenum_tpu.crypto import signers as jsig  # noqa: E402
from indy_plenum_tpu.server import client_authn as jauth  # noqa: E402
from indy_plenum_tpu_torch.common import request as treq  # noqa: E402
from indy_plenum_tpu_torch.common.serializers import serialization as tser  # noqa: E402,E501
from indy_plenum_tpu_torch.crypto import signers as tsig  # noqa: E402
from indy_plenum_tpu_torch.server import client_authn as tauth  # noqa: E402
from indy_plenum_tpu_torch.tpu import ed25519 as tted  # noqa: E402

SEEDS = [bytes([i]) * 32 for i in range(1, 6)]


def _requests(req_mod, sig_mod):
    """Eight requests built and signed the same way in either package."""
    signers = [sig_mod.DidSigner(s) for s in SEEDS[:3]]
    stranger = sig_mod.SimpleSigner(SEEDS[4])

    def nym(i, **extra):
        return req_mod.Request(reqId=100 + i, operation={
            "type": "1", "dest": f"did{i}", "verkey": f"~vk{i}", **extra})

    reqs = []
    for i in range(3):  # 0-2: good single signatures
        r = nym(i, role=None, amount=[i, -i, 2.5])
        signers[i].sign_request(r)
        reqs.append(r)
    r = nym(3)  # 3: signature plus a good endorsement
    signers[0].sign_request(r)
    signers[1].endorse_request(r)
    reqs.append(r)
    r = nym(4)  # 4: endorsement-only multi-sig, one endorsement forged
    r.identifier = signers[2].identifier
    signers[2].endorse_request(r)
    signers[1].endorse_request(r)
    r.signatures[signers[1].identifier] = reqs[3].signatures[
        signers[1].identifier]
    reqs.append(r)
    r = nym(5)  # 5: tampered after signing
    signers[1].sign_request(r)
    r.operation["dest"] = "evil"
    reqs.append(r)
    r = nym(6)  # 6: signature is not base58
    signers[2].sign_request(r)
    r.signature = "0OIl-not-base58"
    reqs.append(r)
    r = nym(7)  # 7: a cryptonym signer nobody registered: resolves
    stranger.sign_request(r)  # from the identifier itself
    reqs.append(r)
    seed_keys = {s.identifier: s.verkey for s in signers}
    return reqs, seed_keys, signers


def _extra_rejects(req_mod, sig_mod, signers):
    """An unresolvable DID and a wrong-length signature."""
    r = req_mod.Request(reqId=200, operation={"type": "1", "v": 1})
    sig_mod.DidSigner(SEEDS[3]).sign_request(r)  # DID not in seed_keys
    r2 = req_mod.Request(reqId=201, operation={"type": "1", "v": 2})
    signers[0].sign_request(r2)
    r2.signature = r2.signature[:-3]
    return [r, r2]


@pytest.fixture(scope="module")
def jax_verdicts():
    reqs, seed_keys, signers = _requests(jreq, jsig)
    reqs = reqs[:6] + _extra_rejects(jreq, jsig, signers)
    authnr = jauth.CoreAuthNr(seed_keys=seed_keys)
    oracle = []
    for r in reqs:
        try:
            authnr.authenticate(r)
            oracle.append(True)
        except Exception:
            oracle.append(False)
    return authnr.authenticate_batch(reqs).tolist(), oracle


def _port_batch():
    reqs, seed_keys, signers = _requests(treq, tsig)
    reqs = reqs[:6] + _extra_rejects(treq, tsig, signers)
    return reqs, tauth.CoreAuthNr(seed_keys=seed_keys, device="cpu")


def _host_hash_entries(pks, msgs, sigs):
    """The reference's host-hash tier (hashlib SHA-512 and mod L on the
    host, then the curve check), as a second route for the same entries."""
    pk_a, r_a, s_a, h_a, pre = tted.prepare_batch(pks, msgs, sigs)
    ok = tted.verify_kernel(*tted.to_device((pk_a, r_a, s_a, h_a), "cpu"))
    return ok.numpy() & pre


@pytest.mark.parametrize("tier", ["host_hash", "device_hash"])
def test_authenticate_batch_matches_jax(jax_verdicts, tier, monkeypatch):
    reqs, authnr = _port_batch()
    if tier == "host_hash":
        monkeypatch.setattr(authnr, "_verify_entries", _host_hash_entries)
    tauth.warm_device_auth_path(device="cpu")
    got = authnr.authenticate_batch(reqs).tolist()
    jax_batch, jax_oracle = jax_verdicts
    assert got == jax_batch == jax_oracle
    assert got == [True, True, True, True, False, False, False, False]


def test_host_oracle_matches_jax():
    jreqs, jkeys, _ = _requests(jreq, jsig)
    treqs, tkeys, _ = _requests(treq, tsig)
    ja = jauth.CoreAuthNr(seed_keys=jkeys)
    ta = tauth.CoreAuthNr(seed_keys=tkeys, device="cpu")
    for jr, tr in zip(jreqs, treqs):
        assert tr.signing_bytes() == jr.signing_bytes()
        assert tr.digest == jr.digest
        assert tr.payload_digest == jr.payload_digest
        try:
            expect = ja.authenticate(jr)
        except Exception as exc:  # noqa: BLE001 - compare exception types
            with pytest.raises(Exception) as got:
                ta.authenticate(tr)
            assert type(got.value).__name__ == type(exc).__name__
        else:
            assert ta.authenticate(tr) == expect


def test_signers_match_jax():
    for seed in SEEDS:
        for name in ("DidSigner", "SimpleSigner"):
            j = getattr(jsig, name)(seed)
            t = getattr(tsig, name)(seed)
            assert (t.identifier, t.verkey, t.verkey_raw) \
                == (j.identifier, j.verkey, j.verkey_raw)
            assert t.sign_bytes(b"payload") == j.sign_bytes(b"payload")
            assert tsig.resolve_verkey_bytes(t.identifier, t.verkey) \
                == jsig.resolve_verkey_bytes(j.identifier, j.verkey)


def test_entry_points_take_explicit_cpu():
    authnr = tauth.CoreAuthNr(device="cpu")
    assert authnr.device.type == "cpu"
    assert authnr.authenticate_batch([]).shape == (0,)


_SCALARS = (st.none() | st.booleans()
            | st.integers(min_value=-(1 << 63), max_value=(1 << 64) - 1)
            | st.floats(allow_nan=False) | st.text(max_size=300)
            | st.binary(max_size=300))
_PAYLOADS = st.recursive(
    _SCALARS,
    lambda kids: (st.lists(kids, max_size=20)
                  | st.dictionaries(st.text(max_size=40), kids,
                                    max_size=20)),
    max_leaves=60)


@settings(max_examples=150, deadline=None, derandomize=True)
@given(_PAYLOADS)
def test_signing_encoder_matches_msgpack(obj):
    assert tser.serialize_for_signing(obj) == jser.serialize_for_signing(obj)
    assert tser.packb(obj) == msgpack.packb(obj, use_bin_type=True)


@pytest.mark.parametrize("length", [0, 31, 32, 255, 256, 65535, 65536])
def test_signing_encoder_length_boundaries(length):
    for obj in ("x" * length, b"y" * length, [1] * min(length, 70000),
                {str(i): i for i in range(min(length, 70000))}):
        assert tser.packb(obj) == msgpack.packb(obj, use_bin_type=True)
