"""Per-field validation DSL for wire messages.

Reference: plenum/common/messages/fields.py (NonNegativeNumberField,
LimitedLengthStringField, MerkleRootField, Base58Field, SignatureField,
TimestampField, IterableField, MapField, ProtocolVersionField, ...).

A field validator is a small object with ``validate(value) -> Optional[str]``
returning an error string or None. Composable; messages declare an ordered
schema of (name, validator) pairs.

Copy of ``indy_plenum_tpu/common/messages/fields.py``, with its imports
bound to the port.
"""
from __future__ import annotations

from typing import Any, Iterable, Optional, Sequence

from ...utils.base58 import b58decode


class FieldBase:
    _base_types: Sequence[type] = ()

    def __init__(self, optional: bool = False, nullable: bool = False):
        self.optional = optional
        self.nullable = nullable

    def validate(self, val: Any) -> Optional[str]:
        if val is None:
            return None if self.nullable else "missing value"
        if self._base_types and not isinstance(val, tuple(self._base_types)):
            want = "/".join(t.__name__ for t in self._base_types)
            return f"expected types {want}, got {type(val).__name__}"
        return self._specific(val)

    def _specific(self, val: Any) -> Optional[str]:
        return None

    def __repr__(self):
        return type(self).__name__


class AnyField(FieldBase):
    pass


class BooleanField(FieldBase):
    _base_types = (bool,)


class NonNegativeNumberField(FieldBase):
    _base_types = (int,)

    def _specific(self, val):
        if isinstance(val, bool):
            return "expected int, got bool"
        return "negative value" if val < 0 else None


class IntegerField(FieldBase):
    _base_types = (int,)


class NonEmptyStringField(FieldBase):
    _base_types = (str,)

    def _specific(self, val):
        return "empty string" if not val else None


class LimitedLengthStringField(FieldBase):
    _base_types = (str,)

    def __init__(self, max_length: int, **kw):
        super().__init__(**kw)
        self.max_length = max_length

    def _specific(self, val):
        if not val:
            return "empty string"
        if len(val) > self.max_length:
            return f"length {len(val)} > limit {self.max_length}"
        return None


class Base58Field(FieldBase):
    _base_types = (str,)

    def __init__(self, byte_lengths: Optional[Iterable[int]] = None, **kw):
        super().__init__(**kw)
        self.byte_lengths = set(byte_lengths or ())

    def _specific(self, val):
        try:
            raw = b58decode(val)
        except ValueError as exc:
            return str(exc)
        if self.byte_lengths and len(raw) not in self.byte_lengths:
            return f"b58-decoded length {len(raw)} not in {sorted(self.byte_lengths)}"
        return None


class MerkleRootField(Base58Field):
    def __init__(self, **kw):
        super().__init__(byte_lengths=(32,), **kw)


class IdentifierField(Base58Field):
    """DID (16 bytes) or full verkey (32 bytes), base58."""

    def __init__(self, **kw):
        super().__init__(byte_lengths=(16, 32), **kw)


class DestNodeField(Base58Field):
    def __init__(self, **kw):
        super().__init__(byte_lengths=(16, 32), **kw)


class VerkeyField(FieldBase):
    _base_types = (str,)

    def _specific(self, val):
        body, abbreviated = (val[1:], True) if val.startswith("~") else (val, False)
        try:
            raw = b58decode(body)
        except ValueError as exc:
            return str(exc)
        want = 16 if abbreviated else 32
        if len(raw) != want:
            return f"verkey length {len(raw)} != {want}"
        return None


class SignatureField(LimitedLengthStringField):
    def __init__(self, **kw):
        kw.setdefault("max_length", 512)
        super().__init__(**kw)


class TimestampField(FieldBase):
    _base_types = (int, float)
    _oldest = 1499906902  # sanity floor as in the reference

    def _specific(self, val):
        if val < self._oldest:
            return f"timestamp {val} implausibly old"
        return None


class LedgerIdField(FieldBase):
    _base_types = (int,)

    def _specific(self, val):
        from ..constants import VALID_LEDGER_IDS

        return None if val in VALID_LEDGER_IDS else f"unknown ledger id {val}"


class ProtocolVersionField(FieldBase):
    _base_types = (int,)

    def __init__(self, **kw):
        kw.setdefault("nullable", True)
        kw.setdefault("optional", True)
        super().__init__(**kw)

    def _specific(self, val):
        from ..constants import CURRENT_PROTOCOL_VERSION

        if val not in (1, 2, CURRENT_PROTOCOL_VERSION):
            return f"unsupported protocol version {val}"
        return None


class RequestIdField(NonNegativeNumberField):
    pass


class IterableField(FieldBase):
    _base_types = (list, tuple)

    def __init__(self, inner: FieldBase, min_length: Optional[int] = None,
                 max_length: Optional[int] = None, **kw):
        super().__init__(**kw)
        self.inner = inner
        self.min_length = min_length
        self.max_length = max_length

    def _specific(self, val):
        if self.min_length is not None and len(val) < self.min_length:
            return f"length {len(val)} < {self.min_length}"
        if self.max_length is not None and len(val) > self.max_length:
            return f"length {len(val)} > {self.max_length}"
        for i, item in enumerate(val):
            err = self.inner.validate(item)
            if err:
                return f"[{i}]: {err}"
        return None


class MapField(FieldBase):
    _base_types = (dict,)

    def __init__(self, key: FieldBase, value: FieldBase, **kw):
        super().__init__(**kw)
        self.key = key
        self.value = value

    def _specific(self, val):
        for k, v in val.items():
            err = self.key.validate(k)
            if err:
                return f"key {k!r}: {err}"
            err = self.value.validate(v)
            if err:
                return f"value of {k!r}: {err}"
        return None


class FixedLengthTupleField(FieldBase):
    """Positionally-typed tuple, e.g. a BatchID (view, pp_view, seq, digest)."""

    _base_types = (list, tuple)

    def __init__(self, inners: Sequence[FieldBase], **kw):
        super().__init__(**kw)
        self.inners = tuple(inners)

    def _specific(self, val):
        if len(val) != len(self.inners):
            return f"length {len(val)} != {len(self.inners)}"
        for i, (item, inner) in enumerate(zip(val, self.inners)):
            err = inner.validate(item)
            if err:
                return f"[{i}]: {err}"
        return None


class EnumField(FieldBase):
    def __init__(self, allowed: Iterable[Any], **kw):
        super().__init__(**kw)
        self.allowed = set(allowed)

    def _specific(self, val):
        return None if val in self.allowed else f"{val!r} not in {self.allowed}"


class SerializedValueField(FieldBase):
    _base_types = (bytes, str)

    def _specific(self, val):
        return "empty" if not val else None


class HexField(FieldBase):
    _base_types = (str,)

    def __init__(self, length: Optional[int] = None, **kw):
        super().__init__(**kw)
        self.length = length

    def _specific(self, val):
        try:
            bytes.fromhex(val)
        except ValueError:
            return "not hex"
        if self.length is not None and len(val) != self.length:
            return f"hex length {len(val)} != {self.length}"
        return None
