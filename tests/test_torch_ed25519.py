"""The port's Ed25519 batch verify (plain versions on the CPU) against the
JAX kernel and the host oracle: RFC 8032 vectors, a mixed batch, the
structural rejections and the empty batch (the cases of
``tests/test_ed25519_kernel.py``), through both tiers."""
import random

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from indy_plenum_tpu.crypto import ed25519 as jed  # noqa: E402
from indy_plenum_tpu.tpu import ed25519 as jted  # noqa: E402
from indy_plenum_tpu_torch.crypto import ed25519 as ed  # noqa: E402
from indy_plenum_tpu_torch.tpu import ed25519 as ted  # noqa: E402

RFC8032 = [
    ("9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60",
     "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a",
     "",
     "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e06522490155"
     "5fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b"),
    ("4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb",
     "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c",
     "72",
     "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da"
     "085ac1e43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00"),
    ("c5aa8df43f9f837bedb7442f31dcb7b166d38535076f094b85ce3a2e0b4458f7",
     "fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025",
     "af82",
     "6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3ac"
     "18ff9b538d16f290ae67f760984dc6594a7c15e9716ed28dc027beceea1ec40a"),
]


NONCANONICAL_Y = (ed.P + 1).to_bytes(32, "little")
X0_SIGN1 = (1 | (1 << 255)).to_bytes(32, "little")  # y = 1 -> x = 0
NO_ROOT = (2).to_bytes(32, "little")


def _rfc_batch():
    pks, msgs, sigs = [], [], []
    for seed_hex, pk_hex, msg_hex, sig_hex in RFC8032:
        seed, pk = bytes.fromhex(seed_hex), bytes.fromhex(pk_hex)
        msg, sig = bytes.fromhex(msg_hex), bytes.fromhex(sig_hex)
        assert ed.public_key(seed) == pk
        assert ed.sign(seed, msg) == sig  # the port signs per RFC 8032
        pks.append(pk)
        msgs.append(msg)
        sigs.append(sig)
    return pks, msgs, sigs


def _mixed_batch():
    """The mixed batch of the JAX test (same seed, same faults), plus a
    non-canonical A, an x = 0 / sign 1 A and S >= L."""
    rng = random.Random(42)
    pks, msgs, sigs = [], [], []
    for i in range(24):
        seed = bytes(rng.randrange(256) for _ in range(32))
        pk = jed.fast_public_key(seed)
        msg = bytes(rng.randrange(256) for _ in range(rng.randrange(0, 64)))
        sig = jed.fast_sign(seed, msg)
        kind = i % 4
        if kind == 1:
            sig = bytes([sig[0] ^ 1]) + sig[1:]
        elif kind == 2:
            msg = msg + b"!"
        elif kind == 3:
            sig = sig[:32] + bytes([sig[32] ^ 1]) + sig[33:]
        pks.append(pk)
        msgs.append(msg)
        sigs.append(sig)
    # decompression edge cases for A: y >= p, x = 0 with the sign bit set,
    # a y with no square root (27 entries pad to the JAX test's 32 bucket)
    for bad_pk in (NONCANONICAL_Y, X0_SIGN1, NO_ROOT):
        pks.append(bad_pk)
        msgs.append(msgs[0])
        sigs.append(sigs[0])
    return pks, msgs, sigs


def _oracle(pks, msgs, sigs):
    return [jed.verify(p, m, s) for p, m, s in zip(pks, msgs, sigs)]


def _structural_batch():
    seed = bytes(range(32))
    pk = ed.public_key(seed)
    msg = b"hello"
    sig = ed.sign(seed, msg)
    bad_s = sig[:32] + ed.L.to_bytes(32, "little")  # S >= L
    return [pk, pk[:31]], [msg, msg], [bad_s, sig]


@pytest.fixture(scope="module")
def combined():
    """RFC vectors (3) + the mixed batch (27) + structural rejections (2):
    32 entries, verified ONCE by the JAX package (one compiled shape,
    the 32-bucket of ``tests/test_ed25519_kernel.py``) and once by the
    port; the tests below read their slices."""
    parts = [_rfc_batch(), _mixed_batch(), _structural_batch()]
    pks, msgs, sigs = (sum((list(p[k]) for p in parts), [])
                       for k in range(3))
    assert len(pks) == 32
    port = ted.batch_verify(pks, msgs, sigs, device="cpu")
    jax_ok = jted.batch_verify(pks, msgs, sigs)
    return pks, msgs, sigs, port, jax_ok


def test_rfc8032_vectors_match_jax(combined):
    _, _, _, port, jax_ok = combined
    assert port[:3].tolist() == jax_ok[:3].tolist() == [True] * 3


def test_mixed_batch_matches_jax_and_oracle(combined):
    pks, msgs, sigs, port, jax_ok = combined
    assert port[3:30].tolist() == jax_ok[3:30].tolist()
    assert port[3:30].tolist() == _oracle(pks[3:30], msgs[3:30], sigs[3:30])
    assert port[3:7].tolist() == [True, False, False, False]
    assert not port[27:30].any()  # the three decompression edge cases


def test_structural_rejections_match_jax(combined):
    _, _, _, port, jax_ok = combined
    assert port[30:].tolist() == jax_ok[30:].tolist() == [False, False]
    pks, msgs, sigs = _structural_batch()
    truncated_sig = ted.batch_verify([pks[0]], [msgs[1]], [sigs[1][:63]],
                                     device="cpu")
    assert truncated_sig.tolist() == [False]
    assert ted.batch_verify([], [], [], device="cpu").shape == (0,)


def test_kernel_edge_points_both_tiers():
    """Decompression edge cases straight into the curve check, host-hash
    tier (verify_kernel) and device-hash tier (verify_kernel_full): y >= p,
    x = 0 with the sign bit set and a y with no square root are rejected;
    S + L (range check bypassed) verifies like S, because L * B is the
    identity - the host range check is what rejects it."""
    import hashlib

    seed = bytes(range(1, 33))
    pk = ed.public_key(seed)
    msg = b"edge"
    sig = ed.sign(seed, msg)
    assert ed.decompress(NO_ROOT) is None
    s_big = (int.from_bytes(sig[32:], "little") + ed.L).to_bytes(32, "little")
    rows = [(pk, sig), (NONCANONICAL_Y, sig), (X0_SIGN1, sig),
            (NO_ROOT, sig), (pk, sig[:32] + s_big)]
    pk_a = np.stack([np.frombuffer(p, np.uint8) for p, _ in rows])
    r_a = np.stack([np.frombuffer(s[:32], np.uint8) for _, s in rows])
    s_a = np.stack([np.frombuffer(s[32:], np.uint8) for _, s in rows])
    prefixes = [s[:32] + p for p, s in rows]
    h_a = np.stack([np.frombuffer(ted._reduce_mod_l(
        hashlib.sha512(pre + msg).digest()), np.uint8) for pre in prefixes])
    host = ted.verify_kernel(*[torch.from_numpy(a.copy())
                               for a in (pk_a, r_a, s_a, h_a)])
    blocks, counts = ted.s512.pad_ed25519_messages(
        prefixes, [msg] * len(rows), 1)
    full = ted.verify_kernel_full(*[torch.from_numpy(a.copy()) for a in (
        pk_a, r_a, s_a, blocks, counts)])
    assert host.tolist() == full.tolist() == [True, False, False, False,
                                              True]


def test_kernel_constants_encode_the_base_table():
    """csrc/ed25519.cu's constant block, re-read as integers: cached j*B
    entries, then d, 2d and sqrt(-1)."""
    words = ted._kernel_consts(torch.device("cpu")).tolist()

    def fe(off):
        return sum(words[off + i] << (51 * i) for i in range(5))

    for j in (1, 5, 15):
        x, y = ted._BASE_POINTS[j - 1]
        base = j * 20
        assert fe(base) == (y + x) % ed.P
        assert fe(base + 5) == (y - x) % ed.P
        assert fe(base + 10) == (2 * ed.D * x * y) % ed.P
    assert fe(320) == ed.D
    assert fe(325) == (2 * ed.D) % ed.P
    assert fe(330) == ed.SQRT_M1
