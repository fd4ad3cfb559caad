"""Host Ed25519: keygen / sign / verify on Python ints, RFC 8032 semantics.

Copy of ``indy_plenum_tpu/crypto/ed25519.py`` without its OpenSSL fast
path: the port runs where the ``cryptography`` package may be missing, so
``fast_sign``/``fast_public_key``/``fast_verify`` are the pure-Python
functions here. Two things keep signing usable at ingress-batch scale:

- fixed-base multiplication ``k*B`` walks a precomputed table of
  ``j * 16^i * B`` (64 additions, no doublings) instead of double-and-add;
- public keys are cached per seed, so signing a batch derives each
  signer's key once.

Verification here is the oracle for the CUDA kernel in
:mod:`indy_plenum_tpu_torch.tpu.ed25519`.
"""
from __future__ import annotations

import functools
import hashlib
from typing import List, Optional, Tuple

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)

_BY = (4 * pow(5, P - 2, P)) % P

Point = Tuple[int, int, int, int]  # extended homogeneous (X, Y, Z, T)

IDENTITY: Point = (0, 1, 1, 0)


def _sqrt_ratio(u: int, v: int) -> Optional[int]:
    """x with v*x^2 == u (mod p), or None if no square root exists."""
    cand = (u * pow(v, 3, P) * pow((u * pow(v, 7, P)) % P, (P - 5) // 8, P)) % P
    if (v * cand * cand) % P == u % P:
        return cand
    if (v * cand * cand) % P == (-u) % P:
        return (cand * SQRT_M1) % P
    return None


def decompress(data: bytes) -> Optional[Point]:
    """32-byte compressed point -> extended point, rejecting non-canonical y."""
    if len(data) != 32:
        return None
    y = int.from_bytes(data, "little")
    sign = y >> 255
    y &= (1 << 255) - 1
    if y >= P:
        return None
    u = (y * y - 1) % P
    v = (D * y * y + 1) % P
    x = _sqrt_ratio(u, v)
    if x is None:
        return None
    if x == 0 and sign:
        return None
    if x & 1 != sign:
        x = P - x
    return (x, y, 1, (x * y) % P)


def compress(pt: Point) -> bytes:
    X, Y, Z, _ = pt
    zi = pow(Z, P - 2, P)
    x = (X * zi) % P
    y = (Y * zi) % P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def point_add(p: Point, q: Point) -> Point:
    """Unified addition, add-2008-hwcd-3 for a=-1 twisted Edwards."""
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    A = ((Y1 - X1) * (Y2 - X2)) % P
    B = ((Y1 + X1) * (Y2 + X2)) % P
    C = (T1 * 2 * D % P * T2) % P
    Dd = (Z1 * 2 * Z2) % P
    E = (B - A) % P
    F = (Dd - C) % P
    G = (Dd + C) % P
    H = (B + A) % P
    return ((E * F) % P, (G * H) % P, (F * G) % P, (E * H) % P)


def point_double(p: Point) -> Point:
    """dbl-2008-hwcd for a=-1."""
    X1, Y1, Z1, _ = p
    A = (X1 * X1) % P
    B = (Y1 * Y1) % P
    C = (2 * Z1 * Z1) % P
    Dd = (-A) % P
    E = ((X1 + Y1) * (X1 + Y1) - A - B) % P
    G = (Dd + B) % P
    F = (G - C) % P
    H = (Dd - B) % P
    return ((E * F) % P, (G * H) % P, (F * G) % P, (E * H) % P)


def point_neg(p: Point) -> Point:
    X, Y, Z, T = p
    return ((-X) % P, Y, Z, (-T) % P)


def point_eq(p: Point, q: Point) -> bool:
    X1, Y1, Z1, _ = p
    X2, Y2, Z2, _ = q
    return (X1 * Z2 - X2 * Z1) % P == 0 and (Y1 * Z2 - Y2 * Z1) % P == 0


def scalar_mult(k: int, p: Point) -> Point:
    acc = IDENTITY
    while k > 0:
        if k & 1:
            acc = point_add(acc, p)
        p = point_double(p)
        k >>= 1
    return acc


def _base_point() -> Point:
    pt = decompress(_BY.to_bytes(32, "little"))
    assert pt is not None
    return pt


BASE: Point = _base_point()


@functools.lru_cache(maxsize=1)
def _base_comb() -> List[List[Point]]:
    """rows[i][j] = j * 16^i * B for i < 64, j < 16 (fixed-base table)."""
    rows = []
    step = BASE
    for _ in range(64):
        row = [IDENTITY]
        for _ in range(15):
            row.append(point_add(row[-1], step))
        rows.append(row)
        for _ in range(4):
            step = point_double(step)
    return rows


def base_mult(k: int) -> Point:
    """k * B for 0 <= k < 2^256 through the fixed-base table."""
    rows = _base_comb()
    acc = IDENTITY
    i = 0
    while k:
        j = k & 15
        if j:
            acc = point_add(acc, rows[i][j])
        k >>= 4
        i += 1
    return acc


def _clamp(h: bytes) -> int:
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a


def secret_scalar(seed: bytes) -> Tuple[int, bytes]:
    """seed (32 bytes) -> (clamped scalar a, hash prefix for nonce derivation)."""
    h = hashlib.sha512(seed).digest()
    return _clamp(h), h[32:]


@functools.lru_cache(maxsize=4096)
def public_key(seed: bytes) -> bytes:
    a, _ = secret_scalar(seed)
    return compress(base_mult(a))


def sign(seed: bytes, msg: bytes) -> bytes:
    a, prefix = secret_scalar(seed)
    A = public_key(seed)
    r = int.from_bytes(hashlib.sha512(prefix + msg).digest(), "little") % L
    Rb = compress(base_mult(r))
    k = int.from_bytes(hashlib.sha512(Rb + A + msg).digest(), "little") % L
    S = (r + k * a) % L
    return Rb + S.to_bytes(32, "little")


def verify(pk: bytes, msg: bytes, sig: bytes) -> bool:
    """Scalar host verification (the oracle; the CUDA path is the hot one)."""
    if len(sig) != 64 or len(pk) != 32:
        return False
    Rb, Sb = sig[:32], sig[32:]
    S = int.from_bytes(Sb, "little")
    if S >= L:
        return False
    A = decompress(pk)
    R = decompress(Rb)
    if A is None or R is None:
        return False
    k = int.from_bytes(hashlib.sha512(Rb + pk + msg).digest(), "little") % L
    # S*B == R + k*A  <=>  S*B + k*(-A) == R
    lhs = point_add(base_mult(S), scalar_mult(k, point_neg(A)))
    return compress(lhs) == Rb


# the JAX package's names for its OpenSSL-backed helpers; here they are
# the pure-Python functions above
fast_sign = sign
fast_public_key = public_key
fast_verify = verify
