"""Typed wire messages: schema-validated, immutable, registry-dispatched.

Reference: plenum/common/messages/message_base.py (`MessageBase`) and the
type registry in plenum/common/messages/node_message_factory.py. Messages
are lightweight frozen objects; each class declares

    typename : str            -- wire tag ("op" field)
    schema   : ((name, FieldBase), ...)

Construction validates every field; ``as_dict``/``from_dict`` round-trip via
the wire serializers.

Copy of ``indy_plenum_tpu/common/messages/message_base.py``, with its
imports bound to the port.
"""
from __future__ import annotations

from typing import Any, ClassVar, Dict, Tuple, Type

from ..exceptions import InvalidMessageError
from .fields import FieldBase

OP_FIELD_NAME = "op"


class MessageBase:
    typename: ClassVar[str] = ""
    schema: ClassVar[Tuple[Tuple[str, FieldBase], ...]] = ()
    __slots__ = ("_values",)

    def __init__(self, *args, **kwargs):
        names = [name for name, _ in self.schema]
        if len(args) > len(names):
            raise InvalidMessageError(
                f"{self.typename}: too many positional args")
        values: Dict[str, Any] = dict(zip(names, args))
        overlap = set(values) & set(kwargs)
        if overlap:
            raise InvalidMessageError(
                f"{self.typename}: duplicate args {sorted(overlap)}")
        values.update(kwargs)
        unknown = set(values) - set(names)
        if unknown:
            raise InvalidMessageError(
                f"{self.typename}: unknown fields {sorted(unknown)}")
        for name, validator in self.schema:
            val = values.setdefault(name, None)
            if val is None and validator.optional:
                continue
            err = validator.validate(val)
            if err:
                raise InvalidMessageError(f"{self.typename}.{name}: {err}")
        # fields live in the instance __dict__ (subclasses declare no
        # __slots__, so one exists): attribute reads become native lookups
        # instead of __getattr__ -> dict fetch — 3PC handlers read several
        # fields per message and this is measurably the hottest attribute
        # path in a dense pool. _values ALIASES that dict (not a copy:
        # thousands of stashed messages must not pay double storage).
        # __setattr__ still blocks mutation.
        self.__dict__.update(values)
        object.__setattr__(self, "_values", self.__dict__)

    def __setattr__(self, key, value):
        raise AttributeError(f"{type(self).__name__} is immutable")

    def __getattr__(self, item):
        try:
            return object.__getattribute__(self, "_values")[item]
        except KeyError:
            raise AttributeError(item) from None

    @property
    def _fields(self) -> Dict[str, Any]:
        # SCHEMA fields only: _values aliases the instance __dict__, so a
        # stray attribute smuggled in via object.__setattr__ must never
        # leak into wire serialization, equality, or hashing (a tagged
        # message would stop round-tripping: "unknown fields")
        values = object.__getattribute__(self, "_values")
        return {name: values[name] for name, _v in self.schema}

    def as_dict(self) -> Dict[str, Any]:
        out = {OP_FIELD_NAME: self.typename}
        out.update(self._fields)
        return out

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "MessageBase":
        data = dict(data)
        data.pop(OP_FIELD_NAME, None)
        return cls(**data)

    def __eq__(self, other):
        return (type(self) is type(other)
                and self._fields == other._fields)

    def __hash__(self):
        return hash((self.typename,
                     tuple(sorted(
                         (k, _hashable(v)) for k, v in self._fields.items()))))

    def __repr__(self):
        inner = ", ".join(f"{k}={v!r}" for k, v in self._fields.items())
        return f"{type(self).__name__}({inner})"


def _hashable(v):
    if isinstance(v, dict):
        return tuple(sorted((k, _hashable(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(_hashable(x) for x in v)
    return v


class MessageRegistry:
    """typename -> class; the wire deserializer's dispatch table."""

    def __init__(self):
        self._by_name: Dict[str, Type[MessageBase]] = {}

    def register(self, cls: Type[MessageBase]) -> Type[MessageBase]:
        if not cls.typename:
            raise ValueError(f"{cls.__name__} has no typename")
        if cls.typename in self._by_name:
            raise ValueError(f"duplicate message type {cls.typename}")
        self._by_name[cls.typename] = cls
        return cls

    def get(self, typename: str) -> Type[MessageBase] | None:
        return self._by_name.get(typename)

    def obj_from_dict(self, data: Dict[str, Any]) -> MessageBase:
        op = data.get(OP_FIELD_NAME)
        cls = self._by_name.get(op)
        if cls is None:
            raise InvalidMessageError(f"unknown message type {op!r}")
        return cls.from_dict(data)


node_message_registry = MessageRegistry()
