"""Minimal base58 (bitcoin alphabet) codec.

Copy of the pure-Python codec in ``indy_plenum_tpu/utils/base58.py``
(identifiers, verkeys and signatures cross the wire in base58, as in the
reference's ``plenum/common/messages/fields.py``). The port carries no
native codec: it is used once per request on the ingress path, next to a
signature check that costs far more.
"""
from __future__ import annotations

ALPHABET = b"123456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz"
_INDEX = {c: i for i, c in enumerate(ALPHABET)}
_POW58 = [58 ** i for i in range(11)]


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


def b58decode(text: str | bytes) -> bytes:
    if isinstance(text, str):
        try:
            text = text.encode("ascii")
        except UnicodeEncodeError:
            raise ValueError("invalid base58 text: not ASCII") from None
    n_zeros = len(text) - len(text.lstrip(ALPHABET[0:1]))
    num = 0
    try:
        # 10-digit chunks keep the inner loop on machine ints
        for i in range(0, len(text), 10):
            chunk = text[i:i + 10]
            v = 0
            for ch in chunk:
                v = v * 58 + _INDEX[ch]
            num = num * _POW58[len(chunk)] + v
    except KeyError as exc:
        raise ValueError(
            f"invalid base58 character {chr(exc.args[0])!r}") from None
    body = num.to_bytes((num.bit_length() + 7) // 8, "big") if num else b""
    return b"\0" * n_zeros + body
