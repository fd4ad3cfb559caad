"""The network-mark join keys of the causal tracing plane.

Copy of ``NET_TRACED_OPS`` and ``net_join_key`` from
``indy_plenum_tpu/observability/causal.py``: the simulated network stamps
``net.send``/``net.recv`` marks (cat ``net``) on the flight recorder for
these message types, keyed so that a later join can match them with the
3PC lifecycle marks. The journey builder itself (``build_journeys``,
``journey_summary``) is not part of the port yet.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

# message types whose deliveries the transports stamp with
# ``net.send``/``net.recv`` marks (cat ``net``). Key shapes join the
# lifecycle marks: 3PC waves by (viewNo, ppSeqNo) — master instance
# only, backups don't trace — PROPAGATE by the "identifier|reqId" pair
# the ingress mark carries (the wire never sees the digest), catchup
# slices by ledger id.
NET_TRACED_OPS = ("PROPAGATE", "PREPREPARE", "PREPARE", "COMMIT",
                  "CATCHUP_REQ", "CATCHUP_REP")


def net_join_key(op: str, get: Callable[[str], Any]) -> Optional[tuple]:
    """The journey-joinable key for one wire message (``get`` reads a
    field off the message object or its dict form). None = untraced."""
    if op == "PROPAGATE":
        req = get("request") or {}
        if not isinstance(req, dict):
            return None
        return ("%s|%s" % (req.get("identifier"), req.get("reqId")),)
    if op in ("PREPREPARE", "PREPARE", "COMMIT"):
        if get("instId"):
            return None  # only the master instance executes / is judged
        return (get("viewNo"), get("ppSeqNo"))
    if op in ("CATCHUP_REQ", "CATCHUP_REP"):
        return (get("ledgerId"),)
    return None
