"""Deterministic key→lane router for the multi-lane write path.

Mir-BFT (Stathakopoulou et al.) scales BFT ordering by partitioning the
request space across concurrent ordering instances; RBFT (Aublin et al.,
ICDCS 2013 — the source paper) already runs f+1 protocol instances in
parallel but orders every request on all of them. The lane router is the
partition law in between: every request maps to exactly ONE ordering
lane, decided by a pure function of its routing key and a seed —

    lane = sha256(b"lane|<seed>|<routing key>")[:8]  mod  K

so (a) every honest node computes the identical assignment with zero
coordination, (b) a seeded run replays the byte-identical lane split,
and (c) requests touching the same state key always land in the same
lane (no cross-lane write conflicts by construction).

The **routing key** is the request's state key when it has one — the
operation's ``dest`` field (NYM target, the plenum state-trie key) — and
the ``identifier|reqId`` pair otherwise, so keyless requests still
spread uniformly instead of pooling in one lane.

Copy of ``indy_plenum_tpu/lanes/router.py``, with its imports bound to the
port.
"""
from __future__ import annotations

import hashlib
from typing import Any, List, Optional

from ..common.constants import TARGET_NYM
from ..common.metrics_collector import MetricsName


def route_key(req: Any) -> str:
    """The request's partition key (see module docstring)."""
    operation = getattr(req, "operation", None) or {}
    dest = operation.get(TARGET_NYM) if isinstance(operation, dict) else None
    if dest:
        return str(dest)
    return "%s|%s" % (getattr(req, "identifier", ""),
                      getattr(req, "reqId", ""))


class LaneRouter:
    """Stateless routing law + per-lane assignment accounting.

    ``distribution`` (and the ``lanes.routed.<lane>`` metrics) is the
    observability surface: a skewed split is a capacity problem the
    Monitor's lanes block makes visible.
    """

    def __init__(self, lanes: int, seed: int = 0, metrics=None):
        if lanes < 1:
            raise ValueError(f"lanes must be >= 1: {lanes}")
        self.lanes = int(lanes)
        self.seed = int(seed)
        self._metrics = metrics
        self.routed_total = 0
        self.distribution: List[int] = [0] * self.lanes

    def lane_of(self, key: str) -> int:
        """Pure routing law — no state, usable by clients and tests."""
        h = hashlib.sha256(b"lane|%d|%s" % (self.seed, key.encode()))
        return int.from_bytes(h.digest()[:8], "big") % self.lanes

    def route(self, req: Any) -> int:
        """Assign ``req`` to its lane and account for it."""
        lane = self.lane_of(route_key(req))
        self.routed_total += 1
        self.distribution[lane] += 1
        if self._metrics is not None:
            self._metrics.add_event(
                "%s.%d" % (MetricsName.LANE_ROUTED, lane))
        return lane

    def counters(self) -> dict:
        return {"lanes": self.lanes,
                "routed": self.routed_total,
                "distribution": list(self.distribution)}
