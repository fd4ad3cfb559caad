"""Loader + adapter for the native BN254 backend (native/bn254/bn254c.c).

Copy of ``indy_plenum_tpu/crypto/bls/bn254_native.py``. The extension is
the repo's own C source, compiled on first import by
:func:`indy_plenum_tpu_torch.utils.native_build.build_native_ext` (gcc and
the CPython headers) into this package's ``_native_build/``. It exposes
the point representation of :mod:`indy_plenum_tpu_torch.crypto.bls.bn254`
(int tuples); conversion crosses the boundary as fixed-width big-endian
bytes, coarse-grained per call.

Importing this module raises if the extension cannot be built or loaded;
the port has no other backend.
"""
from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

from . import bn254 as bn

logger = logging.getLogger(__name__)

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "..", "..", "..", "native", "bn254", "bn254c.c")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "_native_build")


def _build_and_load():
    from ...utils.native_build import build_native_ext

    return build_native_ext(_SRC, _BUILD_DIR, "bn254c")


_C = _build_and_load()

# ---------------------------------------------------------------------------
# conversions: oracle int tuples <-> fixed-width big-endian bytes
# ---------------------------------------------------------------------------


def _g1_bytes(pt: bn.G1Point) -> Optional[bytes]:
    if pt is None:
        return None
    return pt[0].to_bytes(32, "big") + pt[1].to_bytes(32, "big")


def _g1_from(b: Optional[bytes]) -> bn.G1Point:
    if b is None:
        return None
    return (int.from_bytes(b[:32], "big"), int.from_bytes(b[32:], "big"))


def _g2_bytes(pt: bn.G2Point) -> Optional[bytes]:
    if pt is None:
        return None
    (x0, x1), (y0, y1) = pt
    return b"".join(v.to_bytes(32, "big") for v in (x0, x1, y0, y1))


def _g2_from(b: Optional[bytes]) -> bn.G2Point:
    if b is None:
        return None
    v = [int.from_bytes(b[i:i + 32], "big") for i in range(0, 128, 32)]
    return ((v[0], v[1]), (v[2], v[3]))


def _scalar(k: int) -> bytes:
    return (k % bn.R).to_bytes(32, "big")


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def g1_mul(pt: bn.G1Point, k: int) -> bn.G1Point:
    return _g1_from(_C.g1_mul(_g1_bytes(pt), _scalar(k)))


def fp_sqrt(x: int):
    """sqrt mod P, or None if ``x`` is a non-residue (C fast path)."""
    out = _C.fp_sqrt((x % bn.P).to_bytes(32, "big"))
    return None if out is None else int.from_bytes(out, "big")


def g2_mul(pt: bn.G2Point, k: int) -> bn.G2Point:
    return _g2_from(_C.g2_mul(_g2_bytes(pt), _scalar(k)))


def g1_sum(points) -> bn.G1Point:
    return _g1_from(_C.g1_sum(
        [_g1_bytes(p) for p in points if p is not None]))


def g1_sum_checked_bytes(raws) -> bytes:
    """Sum raw 64-byte G1 encodings with canonical + on-curve validation
    done in C (raises ValueError on any invalid encoding); returns the
    64-byte aggregate (all-zeros for the identity). The aggregation hot
    path — no per-point int conversion crosses the boundary."""
    out = _C.g1_sum_checked(raws)
    return b"\x00" * 64 if out is None else out


def g2_sum(points) -> bn.G2Point:
    return _g2_from(_C.g2_sum(
        [_g2_bytes(p) for p in points if p is not None]))


def g2_in_subgroup(pt: bn.G2Point) -> bool:
    if pt is None:
        return True
    if not bn.g2_is_on_curve(pt):
        return False
    return bool(_C.g2_in_subgroup(_g2_bytes(pt)))


def multi_pairing(pairs) -> "bn.Fp12":
    raw = _C.multi_pairing(
        [(_g1_bytes(p), _g2_bytes(q)) for p, q in pairs])
    coeffs = [int.from_bytes(raw[i:i + 32], "big")
              for i in range(0, 384, 32)]
    return (((coeffs[0], coeffs[1]), (coeffs[2], coeffs[3]),
             (coeffs[4], coeffs[5])),
            ((coeffs[6], coeffs[7]), (coeffs[8], coeffs[9]),
             (coeffs[10], coeffs[11])))


def pairing(q: bn.G2Point, p_at: bn.G1Point):
    assert bn.g1_is_on_curve(p_at), "P not on G1"
    assert bn.g2_is_on_curve(q), "Q not on E'"
    return multi_pairing([(p_at, q)])


def pairing_check(pairs) -> bool:
    return bool(_C.pairing_check(
        [(_g1_bytes(p), _g2_bytes(q)) for p, q in pairs]))
