"""GF(2^255 - 19) field arithmetic as batched PyTorch limb tensors.

The plain version of the field layer, port of
``indy_plenum_tpu/tpu/field25519.py``. It keeps the reference's
representation exactly - 22 little-endian limbs of radix 2^12, parallel
carry passes with the 2^264 fold, ``freeze`` as the only canonicalizing op
- so every op here returns the same limbs as the JAX function on the same
input. Tensors are int64 (the values never exceed the reference's int32
range; int64 keeps CPU torch's shifts and products exact).

This module runs on the CPU in the tests and on the card as the reference
the CUDA verify kernel (``csrc/fe25519.cuh``, radix 2^51) is held against:
the two radixes agree on every verdict, not on limbs.

Differences from the JAX code are in idiom only: the schoolbook product is
one broadcast outer product whose anti-diagonals are summed by a pad +
reshape skew, and exponent chains are Python loops over the static bits.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

P = 2**255 - 19
NLIMBS = 22
RADIX = 12
MASK = (1 << RADIX) - 1
# 2^(12*22) = 2^264 == 2^9 * 19 = 9728 (mod p)
TOP_FOLD = (1 << (RADIX * NLIMBS)) % P
assert TOP_FOLD == 9728

D = 37095705934669439343138083508754565189542113879843219016388785533085940283555
D2 = (2 * D) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)

_FOLD_L0 = TOP_FOLD & MASK  # 1536, into limb 0
_FOLD_L1 = TOP_FOLD >> RADIX  # 2, into limb 1
# where the top carry's low and high 12-bit halves fold to: low * 2^264
# -> limb 0 (x1536) and limb 1 (x2); high * 2^276 -> limb 1 (x9728)
_FOLD_LO_VEC = np.zeros(NLIMBS, np.int64)
_FOLD_LO_VEC[:2] = (_FOLD_L0, _FOLD_L1)
_FOLD_HI_VEC = np.zeros(NLIMBS, np.int64)
_FOLD_HI_VEC[1] = TOP_FOLD


def limbs_from_int(x: int) -> np.ndarray:
    out = np.zeros(NLIMBS, dtype=np.int64)
    for i in range(NLIMBS):
        out[i] = (x >> (RADIX * i)) & MASK
    return out


def int_from_limbs(limbs) -> int:
    if isinstance(limbs, torch.Tensor):
        # da: allow[device-sync] -- host-side bignum reassembly for tests/constants (object dtype cannot live on device anyway)
        limbs = limbs.cpu().numpy()
    arr = np.asarray(limbs, dtype=object).reshape(-1)
    return sum(int(arr[i]) << (RADIX * i) for i in range(NLIMBS)) % P


def _make_kp_limbwise() -> np.ndarray:
    """Multiple of p with every limb in [4*2^12 - 4, 2^17]: subtrahend-safe
    (the reference's constant, rebuilt the same way)."""
    k = (1 << 14) * P
    limbs = np.zeros(NLIMBS, dtype=np.int64)
    for i in range(NLIMBS - 1):
        limbs[i] = (k >> (RADIX * i)) & MASK
    limbs[NLIMBS - 1] = k >> (RADIX * (NLIMBS - 1))
    for i in range(NLIMBS - 1):
        limbs[i] += 4 << RADIX
        limbs[i + 1] -= 4
    assert sum(int(l) << (RADIX * i) for i, l in enumerate(limbs)) == k
    return limbs


_KP_LIMBS = _make_kp_limbwise()
ZERO = limbs_from_int(0)
ONE = limbs_from_int(1)
D_LIMBS = limbs_from_int(D)
D2_LIMBS = limbs_from_int(D2)
SQRT_M1_LIMBS = limbs_from_int(SQRT_M1)
P_LIMBS = limbs_from_int(P)


@functools.lru_cache(maxsize=None)
def _const_cached(name: str, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(globals()[name].copy()).to(device)


def const(name: str, like: torch.Tensor) -> torch.Tensor:
    """A module constant (e.g. ``"ONE"``) as an int64 tensor on
    ``like``'s device."""
    return _const_cached(name, like.device)


def _parallel_carry_pass(c: torch.Tensor) -> torch.Tensor:
    """All limbs emit carries at once; carries shift up; the top carry
    folds by 2^264 = 9728 (split into 12-bit halves, as the reference)."""
    cr = c >> RADIX
    top = cr[..., -1:]
    return ((c & MASK) + F.pad(cr[..., :-1], (1, 0))
            + (top & MASK) * const("_FOLD_LO_VEC", c)
            + (top >> RADIX) * const("_FOLD_HI_VEC", c))


def carry(c: torch.Tensor, passes: int = 4) -> torch.Tensor:
    for _ in range(passes):
        c = _parallel_carry_pass(c)
    return c


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return carry(a + b, passes=2)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return carry(a + const("_KP_LIMBS", a) - b, passes=2)


def neg(a: torch.Tensor) -> torch.Tensor:
    return carry(const("_KP_LIMBS", a) - a, passes=2)


def _mul_wide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook columns (..., 43): the outer product's anti-diagonal
    sums, by padding each row to 44 and re-reading the flat buffer with
    row stride 43 (row i lands shifted right by i)."""
    a, b = torch.broadcast_tensors(a, b)
    prod = a.unsqueeze(-1) * b.unsqueeze(-2)  # (..., 22, 22)
    lead = prod.shape[:-2]
    padded = F.pad(prod, (0, NLIMBS))  # (..., 22, 44)
    flat = padded.reshape(*lead, NLIMBS * 2 * NLIMBS)
    skew = flat[..., :NLIMBS * (2 * NLIMBS - 1)].reshape(
        *lead, NLIMBS, 2 * NLIMBS - 1)
    return skew.sum(dim=-2)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Product of loose elements; output loose (<= 2^12)."""
    wide = _mul_wide(a, b)
    lo = wide[..., :NLIMBS]
    hi = F.pad(wide[..., NLIMBS:], (0, 1))  # 22 columns
    hi = carry(hi, passes=4)
    return carry(lo + hi * TOP_FOLD)


def sqr(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def mul_small(a: torch.Tensor, k: int) -> torch.Tensor:
    assert 0 <= k < (1 << 17)
    return carry(a * k)


def _pow_const(a: torch.Tensor, exponent: int) -> torch.Tensor:
    """a ** exponent, left-to-right square-and-multiply (the reference's
    scan over the same static bits)."""
    acc = const("ONE", a).expand_as(a).clone()
    for i in reversed(range(exponent.bit_length())):
        acc = sqr(acc)
        if (exponent >> i) & 1:
            acc = mul(acc, a)
    return acc


def invert(a: torch.Tensor) -> torch.Tensor:
    return _pow_const(a, P - 2)


def pow_p58(a: torch.Tensor) -> torch.Tensor:
    """a ** ((p-5)/8), the core of the combined sqrt/division trick."""
    return _pow_const(a, (P - 5) // 8)


def freeze(a: torch.Tensor) -> torch.Tensor:
    """Canonical representative in [0, p): strict carry + cond subtracts
    (step for step the reference's freeze)."""
    for _ in range(4):
        a = _parallel_carry_pass(a)
    a = a.clone()
    for _ in range(3):
        for i in range(NLIMBS - 1):
            cr = a[..., i] >> RADIX
            a[..., i] -= cr << RADIX
            a[..., i + 1] += cr
        top = a[..., NLIMBS - 1] >> RADIX
        a[..., NLIMBS - 1] -= top << RADIX
        a[..., 0] += top * TOP_FOLD
    hi = a[..., NLIMBS - 1] >> 3
    a[..., NLIMBS - 1] -= hi << 3
    a[..., 0] += hi * 19
    for i in range(NLIMBS - 1):
        cr = a[..., i] >> RADIX
        a[..., i] -= cr << RADIX
        a[..., i + 1] += cr
    p_limbs = const("P_LIMBS", a)
    for _ in range(2):
        diff = a - p_limbs
        borrow = torch.zeros_like(a[..., 0])
        out = torch.empty_like(a)
        for i in range(NLIMBS):
            d = diff[..., i] - borrow
            borrow = (d < 0).to(a.dtype)
            out[..., i] = d + (borrow << RADIX)
        a = torch.where((borrow == 0).unsqueeze(-1), out, a)
    return a


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.all(freeze(a) == freeze(b), dim=-1)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return torch.all(freeze(a) == 0, dim=-1)


def parity(a: torch.Tensor) -> torch.Tensor:
    """Least significant bit of the canonical representative."""
    return freeze(a)[..., 0] & 1


# limb j covers bits [12j, 12j+12); byte k covers bits [8k, 8k+8)
_DEC_BYTE_IDX = np.zeros((NLIMBS, 3), np.int64)
_DEC_SHIFT = np.zeros(NLIMBS, np.int64)
for _j in range(NLIMBS):
    _bit = RADIX * _j
    _k = _bit // 8
    _DEC_BYTE_IDX[_j] = [_k, _k + 1, _k + 2]  # input padded to 34 bytes
    _DEC_SHIFT[_j] = _bit - 8 * _k

_ENC_LIMB_IDX = np.zeros((32, 2), np.int64)
_ENC_SHIFT = np.zeros(32, np.int64)
for _k in range(32):
    _bit = 8 * _k
    _j = _bit // RADIX
    _ENC_LIMB_IDX[_k] = [min(_j, NLIMBS - 1), min(_j + 1, NLIMBS - 1)]
    _ENC_SHIFT[_k] = _bit - RADIX * _j


def decode_bytes(b: torch.Tensor) -> torch.Tensor:
    """(..., 32) uint8 little-endian -> (..., 22) limbs (top bit cleared)."""
    b = b.to(torch.int64, copy=True)
    b[..., 31] &= 0x7F
    b = F.pad(b, (0, 2))
    idx = const("_DEC_BYTE_IDX", b)
    word = (b[..., idx[:, 0]] + (b[..., idx[:, 1]] << 8)
            + (b[..., idx[:, 2]] << 16))
    return (word >> const("_DEC_SHIFT", b)) & MASK


def encode_bytes(a: torch.Tensor) -> torch.Tensor:
    """(..., 22) limbs -> canonical (..., 32) uint8 little-endian."""
    a = freeze(a)
    idx = const("_ENC_LIMB_IDX", a)
    sh = const("_ENC_SHIFT", a)
    word = (a[..., idx[:, 0]] >> sh) + (a[..., idx[:, 1]] << (RADIX - sh))
    return (word & 0xFF).to(torch.uint8)
