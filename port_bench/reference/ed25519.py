"""Ed25519 verification (RFC 8032, section 5.1.7) on Python integers.

Frozen copy of the verify path of ``indy_plenum_tpu_torch/crypto/ed25519.py``
(the curve constants, point decompression, the unified addition and
doubling of the a = -1 twisted Edwards curve, double-and-add scalar
multiplication and ``verify``), without its signing tables: the benchmark
only judges signatures here.
"""
from __future__ import annotations

import hashlib
from typing import Optional, Tuple

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)
_BY = (4 * pow(5, P - 2, P)) % P

Point = Tuple[int, int, int, int]  # extended homogeneous (X, Y, Z, T)
IDENTITY: Point = (0, 1, 1, 0)


def _sqrt_ratio(u: int, v: int) -> Optional[int]:
    cand = (u * pow(v, 3, P)
            * pow((u * pow(v, 7, P)) % P, (P - 5) // 8, P)) % P
    if (v * cand * cand) % P == u % P:
        return cand
    if (v * cand * cand) % P == (-u) % P:
        return (cand * SQRT_M1) % P
    return None


def decompress(data: bytes) -> Optional[Point]:
    if len(data) != 32:
        return None
    y = int.from_bytes(data, "little")
    sign = y >> 255
    y &= (1 << 255) - 1
    if y >= P:
        return None
    x = _sqrt_ratio((y * y - 1) % P, (D * y * y + 1) % P)
    if x is None or (x == 0 and sign):
        return None
    if x & 1 != sign:
        x = P - x
    return (x, y, 1, (x * y) % P)


def compress(pt: Point) -> bytes:
    X, Y, Z, _ = pt
    zi = pow(Z, P - 2, P)
    x, y = (X * zi) % P, (Y * zi) % P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def point_add(p: Point, q: Point) -> Point:
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    A = ((Y1 - X1) * (Y2 - X2)) % P
    B = ((Y1 + X1) * (Y2 + X2)) % P
    C = (T1 * 2 * D % P * T2) % P
    Dd = (Z1 * 2 * Z2) % P
    E, F, G, H = (B - A) % P, (Dd - C) % P, (Dd + C) % P, (B + A) % P
    return ((E * F) % P, (G * H) % P, (F * G) % P, (E * H) % P)


def point_double(p: Point) -> Point:
    X1, Y1, Z1, _ = p
    A, B, C = (X1 * X1) % P, (Y1 * Y1) % P, (2 * Z1 * Z1) % P
    Dd = (-A) % P
    E = ((X1 + Y1) * (X1 + Y1) - A - B) % P
    G = (Dd + B) % P
    F, H = (G - C) % P, (Dd - B) % P
    return ((E * F) % P, (G * H) % P, (F * G) % P, (E * H) % P)


def point_neg(p: Point) -> Point:
    X, Y, Z, T = p
    return ((-X) % P, Y, Z, (-T) % P)


def scalar_mult(k: int, p: Point) -> Point:
    acc = IDENTITY
    while k > 0:
        if k & 1:
            acc = point_add(acc, p)
        p = point_double(p)
        k >>= 1
    return acc


BASE: Point = decompress(_BY.to_bytes(32, "little"))


def verify(pk: bytes, msg: bytes, sig: bytes) -> bool:
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
    lhs = point_add(scalar_mult(S, BASE), scalar_mult(k, point_neg(A)))
    return compress(lhs) == Rb


def public_key(seed: bytes) -> bytes:
    """RFC 8032, section 5.1.5: the public key of a 32-byte seed."""
    h = hashlib.sha512(seed).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return compress(scalar_mult(a, BASE))
