"""BN254 (alt_bn128) pairing arithmetic, pure Python: the benchmark's
frozen oracle for checking the pool's BLS multi-signatures.

Frozen copy of ``indy_plenum_tpu_torch/crypto/bls/bn254.py`` (itself a
copy of ``indy_plenum_tpu/crypto/bls/bn254.py``), taken unchanged below
this docstring so that a later change to the program cannot move the
yardstick.

Standard construction (the Ethereum alt_bn128 parameterization):
  u = 4965661367192848881
  p = 36u^4 + 36u^3 + 24u^2 + 6u + 1   (field modulus)
  r = 36u^4 + 36u^3 + 18u^2 + 6u + 1   (group order)
  E:  y^2 = x^3 + 3       over Fp   (G1)
  E': y^2 = x^3 + 3/(9+i) over Fp2  (G2, D-type sextic twist)
Pairing: optimal ate, Miller loop over 6u+2, then final exponentiation
(p^12-1)/r with the standard hard-part decomposition.

Tower: Fp2 = Fp[i]/(i^2+1); Fp6 = Fp2[v]/(v^3 - (9+i)); Fp12 = Fp6[w]/(w^2 - v).
Elements are represented as nested tuples of ints; all functions are pure.
"""
from __future__ import annotations

from typing import Optional, Tuple

U = 4965661367192848881
P = 36 * U**4 + 36 * U**3 + 24 * U**2 + 6 * U + 1
R = 36 * U**4 + 36 * U**3 + 18 * U**2 + 6 * U + 1

assert P == 21888242871839275222246405745257275088696311157297823662689037894645226208583
assert R == 21888242871839275222246405745257275088548364400416034343698204186575808495617

# --- Fp2 -------------------------------------------------------------------
# a + b*i with i^2 = -1

Fp2 = Tuple[int, int]
FP2_ONE: Fp2 = (1, 0)
FP2_ZERO: Fp2 = (0, 0)

# the twist constant xi = 9 + i
XI: Fp2 = (9, 1)


def f2_add(a: Fp2, b: Fp2) -> Fp2:
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def f2_sub(a: Fp2, b: Fp2) -> Fp2:
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def f2_neg(a: Fp2) -> Fp2:
    return ((-a[0]) % P, (-a[1]) % P)


def f2_mul(a: Fp2, b: Fp2) -> Fp2:
    # (a0 + a1 i)(b0 + b1 i) = (a0b0 - a1b1) + (a0b1 + a1b0) i
    t0 = a[0] * b[0]
    t1 = a[1] * b[1]
    t2 = (a[0] + a[1]) * (b[0] + b[1])
    return ((t0 - t1) % P, (t2 - t0 - t1) % P)


def f2_sqr(a: Fp2) -> Fp2:
    # (a0 + a1 i)^2 = (a0+a1)(a0-a1) + 2 a0 a1 i
    t0 = (a[0] + a[1]) * (a[0] - a[1])
    t1 = 2 * a[0] * a[1]
    return (t0 % P, t1 % P)


def f2_muls(a: Fp2, s: int) -> Fp2:
    return ((a[0] * s) % P, (a[1] * s) % P)


def f2_inv(a: Fp2) -> Fp2:
    # 1/(a0 + a1 i) = (a0 - a1 i)/(a0^2 + a1^2)
    norm = (a[0] * a[0] + a[1] * a[1]) % P
    ninv = pow(norm, P - 2, P)
    return ((a[0] * ninv) % P, (-a[1] * ninv) % P)


def f2_conj(a: Fp2) -> Fp2:
    return (a[0], (-a[1]) % P)


def f2_pow(a: Fp2, e: int) -> Fp2:
    out = FP2_ONE
    base = a
    while e:
        if e & 1:
            out = f2_mul(out, base)
        base = f2_sqr(base)
        e >>= 1
    return out


# --- Fp6 = Fp2[v]/(v^3 - XI) ----------------------------------------------

Fp6 = Tuple[Fp2, Fp2, Fp2]
FP6_ZERO: Fp6 = (FP2_ZERO, FP2_ZERO, FP2_ZERO)
FP6_ONE: Fp6 = (FP2_ONE, FP2_ZERO, FP2_ZERO)


def _mul_xi(a: Fp2) -> Fp2:
    return f2_mul(a, XI)


def f6_add(a: Fp6, b: Fp6) -> Fp6:
    return (f2_add(a[0], b[0]), f2_add(a[1], b[1]), f2_add(a[2], b[2]))


def f6_sub(a: Fp6, b: Fp6) -> Fp6:
    return (f2_sub(a[0], b[0]), f2_sub(a[1], b[1]), f2_sub(a[2], b[2]))


def f6_neg(a: Fp6) -> Fp6:
    return (f2_neg(a[0]), f2_neg(a[1]), f2_neg(a[2]))


def f6_mul(a: Fp6, b: Fp6) -> Fp6:
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = f2_mul(a0, b0)
    t1 = f2_mul(a1, b1)
    t2 = f2_mul(a2, b2)
    c0 = f2_add(t0, _mul_xi(f2_sub(f2_mul(f2_add(a1, a2), f2_add(b1, b2)),
                                   f2_add(t1, t2))))
    c1 = f2_add(f2_sub(f2_mul(f2_add(a0, a1), f2_add(b0, b1)),
                       f2_add(t0, t1)), _mul_xi(t2))
    c2 = f2_add(f2_sub(f2_mul(f2_add(a0, a2), f2_add(b0, b2)),
                       f2_add(t0, t2)), t1)
    return (c0, c1, c2)


def f6_sqr(a: Fp6) -> Fp6:
    return f6_mul(a, a)


def f6_muls2(a: Fp6, s: Fp2) -> Fp6:
    return (f2_mul(a[0], s), f2_mul(a[1], s), f2_mul(a[2], s))


def f6_mul_v(a: Fp6) -> Fp6:
    # v * (a0 + a1 v + a2 v^2) = XI*a2 + a0 v + a1 v^2
    return (_mul_xi(a[2]), a[0], a[1])


def f6_inv(a: Fp6) -> Fp6:
    a0, a1, a2 = a
    c0 = f2_sub(f2_sqr(a0), _mul_xi(f2_mul(a1, a2)))
    c1 = f2_sub(_mul_xi(f2_sqr(a2)), f2_mul(a0, a1))
    c2 = f2_sub(f2_sqr(a1), f2_mul(a0, a2))
    t = f2_add(f2_mul(a2, c1), f2_mul(a1, c2))
    t = f2_add(_mul_xi(t), f2_mul(a0, c0))
    ti = f2_inv(t)
    return (f2_mul(c0, ti), f2_mul(c1, ti), f2_mul(c2, ti))


# --- Fp12 = Fp6[w]/(w^2 - v) ----------------------------------------------

Fp12 = Tuple[Fp6, Fp6]
FP12_ONE: Fp12 = (FP6_ONE, FP6_ZERO)


def f12_mul(a: Fp12, b: Fp12) -> Fp12:
    a0, a1 = a
    b0, b1 = b
    t0 = f6_mul(a0, b0)
    t1 = f6_mul(a1, b1)
    c0 = f6_add(t0, f6_mul_v(t1))
    c1 = f6_sub(f6_mul(f6_add(a0, a1), f6_add(b0, b1)), f6_add(t0, t1))
    return (c0, c1)


def f12_sqr(a: Fp12) -> Fp12:
    a0, a1 = a
    t0 = f6_mul(a0, a1)
    c0 = f6_mul(f6_add(a0, a1), f6_add(a0, f6_mul_v(a1)))
    c0 = f6_sub(f6_sub(c0, t0), f6_mul_v(t0))
    c1 = f6_add(t0, t0)
    return (c0, c1)


def f12_conj(a: Fp12) -> Fp12:
    return (a[0], f6_neg(a[1]))


def f12_inv(a: Fp12) -> Fp12:
    a0, a1 = a
    t = f6_sub(f6_mul(a0, a0), f6_mul_v(f6_mul(a1, a1)))
    ti = f6_inv(t)
    return (f6_mul(a0, ti), f6_neg(f6_mul(a1, ti)))


def f12_pow(a: Fp12, e: int) -> Fp12:
    if e < 0:
        return f12_pow(f12_conj(a), -e)  # valid for unitary elements only
    out = FP12_ONE
    base = a
    while e:
        if e & 1:
            out = f12_mul(out, base)
        base = f12_sqr(base)
        e >>= 1
    return out


# Frobenius coefficients: gamma_1[j] = XI^((p-1)*j/6) for j=1..5
_G1C = [f2_pow(XI, (P - 1) * j // 6) for j in range(6)]


def f12_frobenius(a: Fp12) -> Fp12:
    """x -> x^p on Fp12."""
    (a00, a01, a02), (a10, a11, a12) = a
    c00 = f2_conj(a00)
    c01 = f2_mul(f2_conj(a01), _G1C[2])
    c02 = f2_mul(f2_conj(a02), _G1C[4])
    c10 = f2_mul(f2_conj(a10), _G1C[1])
    c11 = f2_mul(f2_conj(a11), _G1C[3])
    c12 = f2_mul(f2_conj(a12), _G1C[5])
    return ((c00, c01, c02), (c10, c11, c12))


def f12_frobenius_n(a: Fp12, n: int) -> Fp12:
    for _ in range(n):
        a = f12_frobenius(a)
    return a


# --- G1 (affine over Fp, b=3) ----------------------------------------------

G1Point = Optional[Tuple[int, int]]  # None = infinity
G1_GEN: G1Point = (1, 2)


def g1_is_on_curve(pt: G1Point) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - 3) % P == 0


def g1_add(a: G1Point, b: G1Point) -> G1Point:
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = (3 * x1 * x1) * pow(2 * y1, P - 2, P) % P
    else:
        lam = (y2 - y1) * pow(x2 - x1, P - 2, P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def g1_neg(a: G1Point) -> G1Point:
    if a is None:
        return None
    return (a[0], (-a[1]) % P)


def g1_mul(a: G1Point, k: int) -> G1Point:
    k %= R
    out: G1Point = None
    add = a
    while k:
        if k & 1:
            out = g1_add(out, add)
        add = g1_add(add, add)
        k >>= 1
    return out


# --- G2 (affine over Fp2, b = 3/XI) ---------------------------------------

B2: Fp2 = f2_mul((3, 0), f2_inv(XI))

G2Point = Optional[Tuple[Fp2, Fp2]]
G2_GEN: G2Point = (
    (10857046999023057135944570762232829481370756359578518086990519993285655852781,
     11559732032986387107991004021392285783925812861821192530917403151452391805634),
    (8495653923123431417604973247489272438418190587263600148770280649306958101930,
     4082367875863433681332203403145435568316851327593401208105741076214120093531),
)


def g2_is_on_curve(pt: G2Point) -> bool:
    if pt is None:
        return True
    x, y = pt
    return f2_sub(f2_sqr(y), f2_add(f2_mul(f2_sqr(x), x), B2)) == FP2_ZERO


def g2_add(a: G2Point, b: G2Point) -> G2Point:
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if f2_add(y1, y2) == FP2_ZERO:
            return None
        lam = f2_mul(f2_muls(f2_sqr(x1), 3), f2_inv(f2_muls(y1, 2)))
    else:
        lam = f2_mul(f2_sub(y2, y1), f2_inv(f2_sub(x2, x1)))
    x3 = f2_sub(f2_sub(f2_sqr(lam), x1), x2)
    y3 = f2_sub(f2_mul(lam, f2_sub(x1, x3)), y1)
    return (x3, y3)


def g2_neg(a: G2Point) -> G2Point:
    if a is None:
        return None
    return (a[0], f2_neg(a[1]))


def g2_mul(a: G2Point, k: int) -> G2Point:
    k %= R
    out: G2Point = None
    add = a
    while k:
        if k & 1:
            out = g2_add(out, add)
        add = g2_add(add, add)
        k >>= 1
    return out


def g2_in_subgroup(pt: G2Point) -> bool:
    """Full-order check: r*Q == O (G2's cofactor is > 1).

    The ladder must NOT reduce the scalar mod R the way g2_mul does —
    [R mod R]Q = O for every point, which would make this check vacuous
    and admit out-of-subgroup keys (small-subgroup confinement on the
    twist, whose order is R*(2P - R))."""
    if pt is None:
        return True
    if not g2_is_on_curve(pt):
        return False
    out: G2Point = None
    add = pt
    k = R
    while k:
        if k & 1:
            out = g2_add(out, add)
        add = g2_add(add, add)
        k >>= 1
    return out is None


# --- pairing ---------------------------------------------------------------
# Strategy: untwist G2 into E(Fp12) and run a textbook Miller loop with
# affine Fp12 arithmetic. Slower than sparse-line tricks but immune to
# embedding-layout bugs — this library is the correctness oracle.


def _embed_f2(a: Fp2) -> Fp12:
    return ((a, FP2_ZERO, FP2_ZERO), FP6_ZERO)


def _embed_int(x: int) -> Fp12:
    return _embed_f2((x % P, 0))


# w^2 = v, w^6 = XI: the untwist scale factors
_W2: Fp12 = ((FP2_ZERO, FP2_ONE, FP2_ZERO), FP6_ZERO)  # = v = w^2
_W3: Fp12 = (FP6_ZERO, (FP2_ZERO, FP2_ONE, FP2_ZERO))  # = v*w = w^3

F12Point = Optional[Tuple[Fp12, Fp12]]


def _untwist(q: G2Point) -> F12Point:
    """E'(Fp2) -> E(Fp12): (x, y) -> (x*w^2, y*w^3)."""
    if q is None:
        return None
    x, y = q
    return (f12_mul(_embed_f2(x), _W2), f12_mul(_embed_f2(y), _W3))


def _f12pt_add(a: F12Point, b: F12Point) -> F12Point:
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if f12_add(y1, y2) == _F12_ZERO:
            return None
        lam = f12_mul(f12_muls(f12_sqr(x1), 3),
                      f12_inv(f12_muls(y1, 2)))
    else:
        lam = f12_mul(f12_sub(y2, y1), f12_inv(f12_sub(x2, x1)))
    x3 = f12_sub(f12_sub(f12_sqr(lam), x1), x2)
    y3 = f12_sub(f12_mul(lam, f12_sub(x1, x3)), y1)
    return (x3, y3)


def f12_add(a: Fp12, b: Fp12) -> Fp12:
    return (f6_add(a[0], b[0]), f6_add(a[1], b[1]))


def f12_sub(a: Fp12, b: Fp12) -> Fp12:
    return (f6_sub(a[0], b[0]), f6_sub(a[1], b[1]))


def f12_muls(a: Fp12, s: int) -> Fp12:
    return (f6_muls2(a[0], (s % P, 0)), f6_muls2(a[1], (s % P, 0)))


_F12_ZERO: Fp12 = (FP6_ZERO, FP6_ZERO)


def _line_f12(t: F12Point, q: F12Point, xp: Fp12, yp: Fp12) -> Fp12:
    """Line through t and q (tangent if equal) evaluated at (xp, yp)."""
    x1, y1 = t
    x2, y2 = q
    if x1 == x2 and f12_add(y1, y2) == _F12_ZERO:
        return f12_sub(xp, x1)  # vertical
    if x1 == x2 and y1 == y2:
        lam = f12_mul(f12_muls(f12_sqr(x1), 3), f12_inv(f12_muls(y1, 2)))
    else:
        lam = f12_mul(f12_sub(y2, y1), f12_inv(f12_sub(x2, x1)))
    return f12_sub(f12_sub(yp, y1), f12_mul(lam, f12_sub(xp, x1)))


def miller_loop(q: G2Point, p_at: G1Point) -> Fp12:
    if q is None or p_at is None:
        return FP12_ONE
    big_q = _untwist(q)
    xp, yp = _embed_int(p_at[0]), _embed_int(p_at[1])
    t = big_q
    f = FP12_ONE
    for bit in bin(6 * U + 2)[3:]:
        f = f12_mul(f12_sqr(f), _line_f12(t, t, xp, yp))
        t = _f12pt_add(t, t)
        if bit == "1":
            f = f12_mul(f, _line_f12(t, big_q, xp, yp))
            t = _f12pt_add(t, big_q)
    # optimal-ate correction terms: Q1 = pi(Q), Q2 = pi^2(Q)
    q1 = (f12_frobenius(big_q[0]), f12_frobenius(big_q[1]))
    q2 = (f12_frobenius(q1[0]), f12_frobenius(q1[1]))
    nq2 = (q2[0], f12_sub(_F12_ZERO, q2[1]))
    f = f12_mul(f, _line_f12(t, q1, xp, yp))
    t = _f12pt_add(t, q1)
    f = f12_mul(f, _line_f12(t, nq2, xp, yp))
    return f


def final_exponentiation(f: Fp12) -> Fp12:
    return _full(f)


def _easy(f: Fp12) -> Fp12:
    f1 = f12_conj(f)  # f^(p^6) for unitary... general: conj works after inv
    f2i = f12_inv(f)
    f = f12_mul(f1, f2i)  # f^(p^6 - 1)
    return f12_mul(f12_frobenius_n(f, 2), f)  # ^(p^2 + 1)


def _conj(a: Fp12) -> Fp12:
    return f12_conj(a)


def _hard(m: Fp12) -> Fp12:
    """Hard part m^((p^4-p^2+1)/r) for a unitary m, via the
    Devegili-Scott-Dahab vector addition chain (3 u-power chains instead of
    one 2544-bit exponentiation). Pinned against the generic power in
    tests/test_bls.py."""
    fu1 = f12_pow(m, U)
    fu2 = f12_pow(fu1, U)
    fu3 = f12_pow(fu2, U)
    fp1 = f12_frobenius(m)
    fp2 = f12_frobenius(fp1)
    fp3 = f12_frobenius(fp2)
    y0 = f12_mul(f12_mul(fp1, fp2), fp3)
    y1 = _conj(m)
    y2 = f12_frobenius_n(fu2, 2)
    y3 = _conj(f12_frobenius(fu1))
    y4 = _conj(f12_mul(fu1, f12_frobenius(fu2)))
    y5 = _conj(fu2)
    y6 = _conj(f12_mul(fu3, f12_frobenius(fu3)))
    t0 = f12_mul(f12_sqr(y6), f12_mul(y4, y5))
    t1 = f12_mul(f12_mul(y3, y5), t0)
    t0 = f12_mul(t0, y2)
    t1 = f12_mul(f12_sqr(t1), t0)
    t1 = f12_sqr(t1)
    t0 = f12_mul(t1, y1)
    t1 = f12_mul(t1, y0)
    t0 = f12_sqr(t0)
    return f12_mul(t0, t1)


def _full(f: Fp12) -> Fp12:
    return _hard(_easy(f))


def pairing(q: G2Point, p_at: G1Point) -> Fp12:
    """e(P, Q) with P in G1, Q in G2 (argument order: Q, P)."""
    assert g1_is_on_curve(p_at), "P not on G1"
    assert g2_is_on_curve(q), "Q not on E'"
    return _full(miller_loop(q, p_at))


def multi_pairing(pairs) -> Fp12:
    """prod e(Pi, Qi): shared final exponentiation (the batch trick)."""
    f = FP12_ONE
    for p_at, q in pairs:
        if p_at is None or q is None:
            continue
        f = f12_mul(f, miller_loop(q, p_at))
    return _full(f)


def pairing_check(pairs) -> bool:
    """True iff prod e(Pi, Qi) == 1."""
    return multi_pairing(pairs) == FP12_ONE
