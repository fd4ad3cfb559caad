"""The msgpack encoding the pool signs and stores, written from the
msgpack specification (https://github.com/msgpack/msgpack/blob/master/spec.md)
for the types a NYM request, a state value and a multi-signature value
hold: nil, bool, int, str, bytes, arrays and maps.

``canonical`` is the signing form: map keys sorted, ``None`` values
dropped (an absent field and a ``None`` one sign alike), as
indy-plenum's ``serialize_msg_for_signing`` does.
"""
from __future__ import annotations

import struct
from typing import Any


def canonical(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {k: canonical(v) for k, v in sorted(obj.items())
                if v is not None}
    if isinstance(obj, (list, tuple)):
        return [canonical(v) for v in obj]
    return obj


def _head(n: int, fix: int, fix_limit: int, wide) -> bytes:
    if fix is not None and n < fix_limit:
        return bytes([fix | n])
    for tag, fmt, limit in wide:
        if tag is not None and n < limit:
            return bytes([tag]) + struct.pack(fmt, n)
    raise ValueError("object too large")


_LENGTHS = {
    "str": (0xA0, 32, ((0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16),
                       (0xDB, ">I", 1 << 32))),
    "bin": (None, 0, ((0xC4, ">B", 1 << 8), (0xC5, ">H", 1 << 16),
                      (0xC6, ">I", 1 << 32))),
    "array": (0x90, 16, ((None, "", 0), (0xDC, ">H", 1 << 16),
                         (0xDD, ">I", 1 << 32))),
    "map": (0x80, 16, ((None, "", 0), (0xDE, ">H", 1 << 16),
                       (0xDF, ">I", 1 << 32))),
}


def _int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return bytes([v])
    if -32 <= v < 0:
        return bytes([v & 0xFF])
    if v >= 0:
        for tag, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < limit:
                return bytes([tag]) + struct.pack(fmt, v)
    else:
        for tag, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if v >= -limit:
                return bytes([tag]) + struct.pack(fmt, v)
    raise OverflowError("integer out of range")


def packb(obj: Any) -> bytes:
    if obj is None:
        return b"\xc0"
    if obj is True:
        return b"\xc3"
    if obj is False:
        return b"\xc2"
    if isinstance(obj, int):
        return _int(obj)
    if isinstance(obj, float):
        return b"\xcb" + struct.pack(">d", obj)
    if isinstance(obj, str):
        data = obj.encode("utf-8")
        return _head(len(data), *_LENGTHS["str"]) + data
    if isinstance(obj, (bytes, bytearray)):
        return _head(len(obj), *_LENGTHS["bin"]) + bytes(obj)
    if isinstance(obj, (list, tuple)):
        return _head(len(obj), *_LENGTHS["array"]) + b"".join(
            packb(v) for v in obj)
    if isinstance(obj, dict):
        return _head(len(obj), *_LENGTHS["map"]) + b"".join(
            packb(k) + packb(v) for k, v in obj.items())
    raise TypeError(f"cannot encode {type(obj).__name__}")


def signing_bytes(obj: Any) -> bytes:
    return packb(canonical(obj))
