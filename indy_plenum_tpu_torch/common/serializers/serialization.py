"""Canonical signing serialization: every node must sign/hash identical bytes.

Port of ``serialize_for_signing`` from
``indy_plenum_tpu/common/serializers/serialization.py``. The JAX package
calls ``msgpack.packb(_canonical(obj), use_bin_type=True)``; the machine
the port runs on may have no ``msgpack``, so this module carries a small
msgpack ENCODER of its own, byte-identical to msgpack-python for every
type a request payload holds: ``None``, ``bool``, ``int`` (-2^63 ..
2^64-1), ``float`` (as float 64), ``str``, ``bytes``/``bytearray``,
lists/tuples and dicts. Maps are key-sorted and ``None`` values dropped
(absent field == None), exactly as ``_canonical`` does there.
"""
from __future__ import annotations

import struct
from typing import Any


def _canonical(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {k: _canonical(v) for k, v in sorted(obj.items())
                if v is not None}
    if isinstance(obj, (list, tuple)):
        return [_canonical(v) for v in obj]
    return obj


def _pack_int(v: int, out: bytearray) -> None:
    if v >= 0:
        if v < 0x80:
            out.append(v)
        elif v < 0x100:
            out += b"\xcc" + struct.pack(">B", v)
        elif v < 0x10000:
            out += b"\xcd" + struct.pack(">H", v)
        elif v < 0x100000000:
            out += b"\xce" + struct.pack(">I", v)
        elif v < 0x10000000000000000:
            out += b"\xcf" + struct.pack(">Q", v)
        else:
            raise OverflowError("Integer value out of range")
    elif v >= -32:
        out.append(v & 0xFF)
    elif v >= -0x80:
        out += b"\xd0" + struct.pack(">b", v)
    elif v >= -0x8000:
        out += b"\xd1" + struct.pack(">h", v)
    elif v >= -0x80000000:
        out += b"\xd2" + struct.pack(">i", v)
    elif v >= -0x8000000000000000:
        out += b"\xd3" + struct.pack(">q", v)
    else:
        raise OverflowError("Integer value out of range")


def _pack_len(n: int, fix_tag: int, fix_max: int, tags, out: bytearray
              ) -> None:
    """Header of a str/bin/array/map: fix form when it fits, else the
    8/16/32-bit length forms in ``tags`` (None = form not available)."""
    if fix_tag is not None and n < fix_max:
        out.append(fix_tag | n)
        return
    t8, t16, t32 = tags
    if t8 is not None and n < 0x100:
        out += bytes([t8]) + struct.pack(">B", n)
    elif n < 0x10000:
        out += bytes([t16]) + struct.pack(">H", n)
    elif n < 0x100000000:
        out += bytes([t32]) + struct.pack(">I", n)
    else:
        raise ValueError("object too large to pack")


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
        out += data
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(len(obj), None, 0, (0xC4, 0xC5, 0xC6), out)
        out += obj
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, (None, 0xDC, 0xDD), out)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, (None, 0xDE, 0xDF), out)
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    """msgpack encoding with ``use_bin_type=True`` (dict order kept)."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def serialize_for_signing(obj: Any) -> bytes:
    """Deterministic bytes for signing/digesting (ordered msgpack)."""
    return packb(_canonical(obj))
