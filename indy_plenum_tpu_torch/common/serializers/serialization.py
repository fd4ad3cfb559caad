"""Canonical serialization: every node must hash/sign identical bytes.

Port of ``indy_plenum_tpu/common/serializers/serialization.py``: the
signing serializer (ordered msgpack), the wire serializer of node and
client messages (``serialize_msg``), the ledger txn serializer (compact
key-sorted JSON), the base58 root serializer and the state-proof node
serializer. The JAX package calls
``msgpack.packb``/``msgpack.unpackb``; the machine the port runs on may
have no ``msgpack``, so this module carries a small msgpack ENCODER and
DECODER of its own. The encoder is byte-identical to msgpack-python
(``use_bin_type=True``) for every type a request payload or a state value
holds: ``None``, ``bool``, ``int`` (-2^63 .. 2^64-1), ``float`` (as
float 64), ``str``, ``bytes``/``bytearray``, lists/tuples and dicts. For
signing, maps are key-sorted and ``None`` values dropped (absent field ==
None), exactly as ``_canonical`` does there; on the wire, dict order and
``None`` are kept, so a port node and a JAX node exchange the same
bytes. The decoder gives the objects
``msgpack.unpackb(raw=False)`` gives: str for str, bytes for bin, lists
for arrays, dicts for maps.
"""
from __future__ import annotations

import json
import struct
from typing import Any, Tuple

from ...utils.base58 import b58decode, b58encode


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


def serialize_msg(obj: Any) -> bytes:
    """Wire serialization for node/client messages (msgpack, order kept)."""
    return packb(obj)


# --- decoding (msgpack.unpackb(data, raw=False)) ----------------------------

# fixed-width headers: tag -> (struct format, size)
_FIXED = {
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
# length-prefixed: tag -> (kind, length format, length size)
_SIZED = {
    0xC4: ("bin", ">B", 1), 0xC5: ("bin", ">H", 2), 0xC6: ("bin", ">I", 4),
    0xD9: ("str", ">B", 1), 0xDA: ("str", ">H", 2), 0xDB: ("str", ">I", 4),
    0xDC: ("array", ">H", 2), 0xDD: ("array", ">I", 4),
    0xDE: ("map", ">H", 2), 0xDF: ("map", ">I", 4),
}


class UnpackError(ValueError):
    """Bytes that are not one complete msgpack object of the supported
    types (extension types and trailing bytes included)."""


def _take(data: bytes, pos: int, n: int) -> Tuple[bytes, int]:
    end = pos + n
    if end > len(data):
        raise UnpackError("truncated msgpack data")
    return data[pos:end], end


def _unpack(data: bytes, pos: int) -> Tuple[Any, int]:
    if pos >= len(data):
        raise UnpackError("truncated msgpack data")
    tag = data[pos]
    pos += 1
    if tag <= 0x7F:
        return tag, pos
    if tag >= 0xE0:
        return tag - 0x100, pos
    if 0xA0 <= tag <= 0xBF:
        kind, n = "str", tag & 0x1F
    elif 0x90 <= tag <= 0x9F:
        kind, n = "array", tag & 0x0F
    elif 0x80 <= tag <= 0x8F:
        kind, n = "map", tag & 0x0F
    elif tag == 0xC0:
        return None, pos
    elif tag == 0xC2:
        return False, pos
    elif tag == 0xC3:
        return True, pos
    elif tag in _FIXED:
        fmt, size = _FIXED[tag]
        raw, pos = _take(data, pos, size)
        return struct.unpack(fmt, raw)[0], pos
    elif tag in _SIZED:
        kind, fmt, size = _SIZED[tag]
        raw, pos = _take(data, pos, size)
        n = struct.unpack(fmt, raw)[0]
    else:
        raise UnpackError(f"unsupported msgpack tag 0x{tag:02x}")
    if kind == "bin":
        return _take(data, pos, n)
    if kind == "str":
        raw, pos = _take(data, pos, n)
        try:
            return raw.decode("utf-8"), pos
        except UnicodeDecodeError as ex:
            raise UnpackError(str(ex)) from None
    if kind == "array":
        items = []
        for _ in range(n):
            item, pos = _unpack(data, pos)
            items.append(item)
        return items, pos
    out = {}
    for _ in range(n):
        key, pos = _unpack(data, pos)
        value, pos = _unpack(data, pos)
        try:
            out[key] = value
        except TypeError:  # a list or dict as a key: not hashable
            raise UnpackError("unhashable map key") from None
    return out, pos


def unpackb(data: bytes) -> Any:
    """msgpack decoding with ``raw=False`` semantics."""
    data = bytes(data)
    obj, pos = _unpack(data, 0)
    if pos != len(data):
        raise UnpackError("extra data after the msgpack object")
    return obj


def deserialize_msgpack(data: bytes) -> Any:
    return unpackb(data)


class JsonSerializer:
    """Ledger txn serializer: compact, key-sorted JSON (stable digests)."""

    @staticmethod
    def dumps(obj: Any) -> bytes:
        return json.dumps(obj, sort_keys=True,
                          separators=(",", ":")).encode()

    @staticmethod
    def loads(data) -> Any:
        if isinstance(data, (bytes, bytearray)):
            data = data.decode()
        return json.loads(data)


ledger_txn_serializer = JsonSerializer()


class Base58Serializer:
    """Root-hash serializer: 32-byte roots <-> base58 text."""

    @staticmethod
    def serialize(raw: bytes) -> str:
        return b58encode(raw)

    @staticmethod
    def deserialize(txt: str) -> bytes:
        return b58decode(txt)


state_roots_serializer = Base58Serializer()


class ProofNodesSerializer:
    """State-proof node list <-> msgpack bytes (client-verifiable)."""

    @staticmethod
    def serialize(nodes: Any) -> bytes:
        return packb(nodes)

    @staticmethod
    def deserialize(data: bytes) -> Any:
        return unpackb(data)


proof_nodes_serializer = ProofNodesSerializer()
