"""Deterministic primary selection: round-robin over the validator list.

Reference: plenum/server/consensus/primary_selector.py
(`RoundRobinConstantNodesPrimariesSelector`). Master primary for view v is
validators[v mod N]; backup instance i gets validators[(v + i) mod N].
All nodes compute the same list with no communication.

Copy of ``indy_plenum_tpu/server/consensus/primary_selector.py``, with its
imports bound to the port.
"""
from __future__ import annotations

from typing import List


class RoundRobinConstantNodesPrimariesSelector:
    def __init__(self, validators):
        """``validators``: a list, or a zero-arg callable returning the
        CURRENT list — the pool manager can change membership between view
        changes, and primaries must be picked from the live set."""
        self._validators = validators

    @property
    def validators(self) -> List[str]:
        if callable(self._validators):
            return list(self._validators())
        return list(self._validators)

    def select_primaries(self, view_no: int, instance_count: int) -> List[str]:
        validators = self.validators
        n = len(validators)
        return [validators[(view_no + i) % n]
                for i in range(instance_count)]

    def select_master_primary(self, view_no: int) -> str:
        validators = self.validators
        return validators[view_no % len(validators)]
