"""Base58 (bitcoin alphabet): identifiers, verkeys, signatures and roots
cross the pool's wire in it.

Frozen copy of the codec in ``indy_plenum_tpu_torch/utils/base58.py``.
"""
from __future__ import annotations

ALPHABET = b"123456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz"
_INDEX = {c: i for i, c in enumerate(ALPHABET)}


def b58encode(data: bytes) -> str:
    n_zeros = len(data) - len(data.lstrip(b"\0"))
    num = int.from_bytes(data, "big")
    out = bytearray()
    while num > 0:
        num, rem = divmod(num, 58)
        out.append(ALPHABET[rem])
    out.extend(ALPHABET[0:1] * n_zeros)
    out.reverse()
    return out.decode("ascii")


def b58decode(text: str) -> bytes:
    raw = text.encode("ascii")
    n_zeros = len(raw) - len(raw.lstrip(ALPHABET[0:1]))
    num = 0
    for ch in raw:
        num = num * 58 + _INDEX[ch]
    body = num.to_bytes((num.bit_length() + 7) // 8, "big") if num else b""
    return b"\0" * n_zeros + body
