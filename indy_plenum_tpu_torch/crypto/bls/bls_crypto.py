"""BLS signatures over BN254: sign / verify / aggregate + value objects.

Reference: crypto/bls/bls_crypto.py (`BlsCryptoSigner`, `BlsCryptoVerifier`)
and crypto/bls/bls_multi_signature.py (`MultiSignature`,
`MultiSignatureValue`); concrete backend analog of
crypto/bls/indy_crypto/bls_crypto_indy_crypto.py (ursa/AMCL BN254 in Rust).

Scheme: signatures in G1, public keys in G2 (small sigs, one G2 key per
validator), hash-to-G1 by try-and-increment over sha256 (constant-time is
NOT required: inputs are public protocol data). Proof of possession = BLS
signature over the serialized public key (rogue-key defence).

Copy of ``indy_plenum_tpu/crypto/bls/bls_crypto.py``, with its imports
bound to the port. The port has one backend, the native C extension
(:mod:`.bn254_native`): where it cannot be built, importing this module
raises with the compiler's message. The reference's ladder down to the
projective pure-Python ``bn254_fast`` is not ported, and
``aggregate_sigs`` keeps only its native branch. The pairings are host
work: no kernel of the card runs here.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence

from ...utils.base58 import b58decode, b58encode
from . import bn254 as bn
from . import bn254_native as fast

# the backend this module runs: always the native extension in the port
NATIVE_BACKEND = True

# --- point serialization (wire: base58 of fixed-width big-endian) ---------


def g1_to_bytes(pt: bn.G1Point) -> bytes:
    if pt is None:
        return b"\x00" * 64
    return pt[0].to_bytes(32, "big") + pt[1].to_bytes(32, "big")


def g1_from_bytes(data: bytes) -> bn.G1Point:
    if len(data) != 64:
        raise ValueError("G1 point must be 64 bytes")
    if data == b"\x00" * 64:
        return None
    pt = (int.from_bytes(data[:32], "big"), int.from_bytes(data[32:], "big"))
    # canonical encodings only: a coordinate >= P would alias another point
    # mod P, giving one signature several distinct wire forms (malleability
    # breaking digest-based dedup and the b58-keyed subgroup cache)
    if pt[0] >= bn.P or pt[1] >= bn.P:
        raise ValueError("non-canonical G1 coordinate")
    if not bn.g1_is_on_curve(pt):
        raise ValueError("point not on G1")
    return pt


def g2_to_bytes(pt: bn.G2Point) -> bytes:
    if pt is None:
        return b"\x00" * 128
    (x0, x1), (y0, y1) = pt
    return b"".join(v.to_bytes(32, "big") for v in (x0, x1, y0, y1))


def g2_from_bytes(data: bytes) -> bn.G2Point:
    if len(data) != 128:
        raise ValueError("G2 point must be 128 bytes")
    if data == b"\x00" * 128:
        return None
    vals = [int.from_bytes(data[i:i + 32], "big") for i in range(0, 128, 32)]
    if any(v >= bn.P for v in vals):
        raise ValueError("non-canonical G2 coordinate")
    pt = ((vals[0], vals[1]), (vals[2], vals[3]))
    if not bn.g2_is_on_curve(pt):
        raise ValueError("point not on E'")
    return pt


# --- hash to G1 (try-and-increment) ---------------------------------------


def hash_to_g1(msg: bytes) -> bn.G1Point:
    ctr = 0
    while True:
        h = hashlib.sha256(msg + ctr.to_bytes(4, "big")).digest()
        x = int.from_bytes(h, "big") % bn.P
        rhs = (x * x * x + 3) % bn.P
        # the modular sqrt is the whole cost of a hash-to-curve attempt;
        # the backend's fp_sqrt (C Montgomery pow) beats the Python pow
        y = fast.fp_sqrt(rhs)
        if y is not None:
            # normalize sign deterministically
            if y > bn.P // 2:
                y = bn.P - y
            return (x, y)
        ctr += 1


# --- key generation / sign / verify / aggregate ----------------------------


class BlsKeyPair:
    def __init__(self, seed: bytes):
        if len(seed) != 32:
            raise ValueError("seed must be 32 bytes")
        self.sk = int.from_bytes(
            hashlib.sha512(b"bls-bn254-sk" + seed).digest(), "big") % bn.R
        self.pk: bn.G2Point = fast.g2_mul(bn.G2_GEN, self.sk)

    @property
    def pk_b58(self) -> str:
        return b58encode(g2_to_bytes(self.pk))

    def pop(self) -> str:
        """Proof of possession: BLS sig over the serialized pubkey."""
        return b58encode(g1_to_bytes(
            fast.g1_mul(hash_to_g1(g2_to_bytes(self.pk)), self.sk)))


class BlsCryptoSigner:
    """Reference: BlsCryptoSigner (indy-crypto backend)."""

    def __init__(self, keypair: BlsKeyPair):
        self._kp = keypair

    @property
    def pk(self) -> str:
        return self._kp.pk_b58

    def sign(self, message: bytes) -> str:
        sig = fast.g1_mul(hash_to_g1(message), self._kp.sk)
        return b58encode(g1_to_bytes(sig))


class PairingCounter:
    """Process-wide pairing accounting (the state-proof plane's cost
    meter): ``checks`` counts pairing-equation evaluations (one shared
    final exponentiation each), ``pairings`` the Miller loops they
    contained. The proof plane's serve-path contract — a cache hit costs
    ZERO pairings — is asserted against this counter by ``chip_smoke.py``
    phase P and the parity tests, so every verification path in this
    module must route through :func:`_pairing_check`."""

    __slots__ = ("checks", "pairings")

    def __init__(self):
        self.checks = 0
        self.pairings = 0

    def snapshot(self) -> tuple:
        return (self.checks, self.pairings)


PAIRINGS = PairingCounter()


def _pairing_check(pairs) -> bool:
    PAIRINGS.checks += 1
    PAIRINGS.pairings += len(pairs)
    return fast.pairing_check(pairs)


# validator keys are static between NODE txns: memoize the expensive
# subgroup membership checks (r*Q == O is a full scalar mul)
_SUBGROUP_CACHE: Dict[str, bool] = {}
# ... and the aggregated pool key per participant set (decode + subgroup
# checks + 64 G2 adds otherwise repeat for every single verification)
_APK_CACHE: Dict[tuple, Optional[bn.G2Point]] = {}


def _aggregated_pk(pks_b58: Sequence[str]) -> Optional[bn.G2Point]:
    key = tuple(pks_b58)
    if key in _APK_CACHE:
        return _APK_CACHE[key]
    pts = []
    apk: Optional[bn.G2Point] = None
    for pk in pks_b58:
        p = _g2_checked(pk)
        if p is None:
            break
        pts.append(p)
    else:
        apk = fast.g2_sum(pts)
    if len(_APK_CACHE) > 1024:
        _APK_CACHE.clear()
    _APK_CACHE[key] = apk
    return apk


def _g2_checked(pk_b58: str) -> Optional[bn.G2Point]:
    """Decode a G2 key with a cached subgroup check; None if invalid."""
    ok = _SUBGROUP_CACHE.get(pk_b58)
    try:
        pk = g2_from_bytes(b58decode(pk_b58))
    except ValueError:
        return None
    if pk is None:
        return None
    if ok is None:
        ok = fast.g2_in_subgroup(pk)
        if len(_SUBGROUP_CACHE) > 4096:
            _SUBGROUP_CACHE.clear()
        _SUBGROUP_CACHE[pk_b58] = ok
    return pk if ok else None


class BlsCryptoVerifier:
    """Reference: BlsCryptoVerifier. Stateless pairing checks."""

    @staticmethod
    def verify_sig(signature_b58: str, message: bytes, pk_b58: str) -> bool:
        try:
            sig = g1_from_bytes(b58decode(signature_b58))
        except ValueError:
            return False
        pk = _g2_checked(pk_b58)
        if sig is None or pk is None:
            return False
        # e(H(m), pk) == e(sig, G2) <=> e(H(m), pk) * e(-sig, G2) == 1
        return _pairing_check([
            (hash_to_g1(message), pk),
            (bn.g1_neg(sig), bn.G2_GEN),
        ])

    @staticmethod
    def verify_pop(pop_b58: str, pk_b58: str) -> bool:
        try:
            pk_bytes = b58decode(pk_b58)
            g2_from_bytes(pk_bytes)
        except ValueError:
            return False
        return BlsCryptoVerifier.verify_sig(pop_b58, pk_bytes, pk_b58)

    @staticmethod
    def aggregate_sigs(signatures_b58: Sequence[str]) -> str:
        # raw-bytes path: canonical + on-curve checks and the sum all
        # happen in ONE C call (no per-share int conversion)
        return b58encode(fast.g1_sum_checked_bytes(
            [b58decode(s) for s in signatures_b58]))

    @staticmethod
    def verify_multi_sig(signature_b58: str, message: bytes,
                         pks_b58: Sequence[str]) -> bool:
        try:
            sig = g1_from_bytes(b58decode(signature_b58))
        except ValueError:
            return False
        acc = _aggregated_pk(pks_b58)
        if sig is None or acc is None:
            return False
        return _pairing_check([
            (hash_to_g1(message), acc),
            (bn.g1_neg(sig), bn.G2_GEN),
        ])

    @staticmethod
    def verify_multi_sig_batch(
            items: Sequence[tuple],
            scalar_fn=None) -> List[bool]:
        """Verify k multi-signatures in (near) ONE pairing computation.

        ``items``: (signature_b58, message: bytes, pks_b58) per ordered
        batch. Instead of k independent pairing checks (2 Miller loops +
        1 final exponentiation EACH), the k equations are combined with
        fresh 128-bit random scalars r_i:

            prod_g e(sum_{i in g} r_i*H(m_i), apk_g)
                 * e(-sum_i r_i*sig_i, G2) == 1

        where batches are grouped by aggregated public key apk_g (ONE
        group in the common case — the same pool signs every batch), so
        the whole batch costs |groups|+1 Miller loops and ONE shared
        final exponentiation, plus two short-scalar G1 muls per item.
        A forged item makes the combined check fail with probability
        1 - 2^-128; on failure every item is re-verified individually,
        so the returned verdicts are always exact.

        Reference analog: crypto/bls/indy_crypto/bls_crypto_indy_crypto
        .py verifies one multi-sig per call; batching across ordered 3PC
        batches is the TPU-era redesign (SURVEY §2.3 / §7 step 6).

        ``scalar_fn(idx, sig_b58, message) -> int`` overrides the scalar
        source (the state-proof plane's SEEDED replay mode —
        :func:`indy_plenum_tpu_torch.proofs.batch_verify.verify_multi_sigs_batch`
        documents when predictable scalars are safe). Default: fresh
        ``secrets`` randomness, sound against adversarial input.
        """
        import secrets

        k = len(items)
        if k == 0:
            return []
        parsed = []  # indices of combinable items
        verdicts = [False] * k
        # apk carried IN the group entry (the bounded _APK_CACHE may be
        # cleared by a later miss in this very loop — re-reading it after
        # the loop could KeyError)
        by_apk: Dict[tuple, tuple] = {}  # pks_key -> (apk, entries)
        for idx, (sig_b58, message, pks_b58) in enumerate(items):
            try:
                sig = g1_from_bytes(b58decode(sig_b58))
            except ValueError:
                continue
            apk = _aggregated_pk(pks_b58)
            if sig is None or apk is None:
                continue
            r = (int.from_bytes(secrets.token_bytes(16), "big")
                 if scalar_fn is None
                 else scalar_fn(idx, sig_b58, message))
            if r == 0:
                r = 1  # a zero scalar would erase the item from the check
            h = hash_to_g1(message)
            by_apk.setdefault(tuple(pks_b58), (apk, []))[1].append(
                (r, h, sig))
            parsed.append(idx)
        if parsed:
            pairs = []
            sig_terms = []
            for apk, entries in by_apk.values():
                pairs.append((
                    fast.g1_sum(fast.g1_mul(h, r) for r, h, _ in entries),
                    apk))
                sig_terms.extend(
                    fast.g1_mul(sig, r) for r, _, sig in entries)
            agg_sig = fast.g1_sum(sig_terms)
            if agg_sig is not None:
                pairs.append((bn.g1_neg(agg_sig), bn.G2_GEN))
            if _pairing_check(pairs):
                for idx in parsed:
                    verdicts[idx] = True
                return verdicts
        # combined check failed: at least one forgery — find it exactly
        for idx in parsed:
            sig_b58, message, pks_b58 = items[idx]
            verdicts[idx] = BlsCryptoVerifier.verify_multi_sig(
                sig_b58, message, pks_b58)
        return verdicts

    @staticmethod
    def aggregate_and_verify_batch(
            items: Sequence[tuple]) -> List[tuple]:
        """Aggregate each item's signature shares AND batch-verify the
        aggregates: the full per-ordered-batch BLS cycle (BASELINE
        config 3), amortized across k batches.

        ``items``: (sig_shares_b58: Sequence[str], message: bytes,
        pks_b58) per ordered batch. Returns [(agg_sig_b58 | None, ok)].
        """
        aggs: List[Optional[str]] = []
        for shares, _msg, _pks in items:
            try:
                aggs.append(BlsCryptoVerifier.aggregate_sigs(shares))
            except ValueError:
                aggs.append(None)
        verdicts = BlsCryptoVerifier.verify_multi_sig_batch([
            (agg if agg is not None else "", msg, pks)
            for agg, (_s, msg, pks) in zip(aggs, items)])
        return list(zip(aggs, verdicts))


# --- multi-signature value objects ----------------------------------------


class MultiSignatureValue:
    """What the pool actually co-signs: the committed roots at a 3PC batch.

    Reference: crypto/bls/bls_multi_signature.py (`MultiSignatureValue`).
    """

    FIELDS = ("ledger_id", "state_root_hash", "pool_state_root_hash",
              "txn_root_hash", "timestamp")

    def __init__(self, ledger_id: int, state_root_hash: str,
                 pool_state_root_hash: str, txn_root_hash: str,
                 timestamp: int):
        self.ledger_id = ledger_id
        self.state_root_hash = state_root_hash
        self.pool_state_root_hash = pool_state_root_hash
        self.txn_root_hash = txn_root_hash
        self.timestamp = timestamp

    def as_dict(self) -> Dict:
        return {k: getattr(self, k) for k in self.FIELDS}

    @classmethod
    def from_dict(cls, data: Dict) -> "MultiSignatureValue":
        return cls(**{k: data[k] for k in cls.FIELDS})

    def serialize(self) -> bytes:
        from ...common.serializers.serialization import serialize_for_signing

        return serialize_for_signing(self.as_dict())

    def __eq__(self, other):
        return isinstance(other, MultiSignatureValue) \
            and self.as_dict() == other.as_dict()


class MultiSignature:
    """signature + participants + signed value (reference: MultiSignature)."""

    def __init__(self, signature: str, participants: List[str],
                 value: MultiSignatureValue):
        self.signature = signature
        self.participants = list(participants)
        self.value = value

    def as_dict(self) -> Dict:
        return {"signature": self.signature,
                "participants": self.participants,
                "value": self.value.as_dict()}

    @classmethod
    def from_dict(cls, data: Dict) -> "MultiSignature":
        return cls(data["signature"], list(data["participants"]),
                   MultiSignatureValue.from_dict(dict(data["value"])))

    def __eq__(self, other):
        return isinstance(other, MultiSignature) \
            and self.as_dict() == other.as_dict()
