"""Per-instance routing of 3PC traffic: one subscription, one O(1) hop.

Reference: plenum's Node delivers replica-bound messages into the TARGET
replica's inbox keyed by ``instId`` (plenum/server/node.py `sendToReplica`
/ `msgHasAcceptableInstId`); it never lets every replica inspect every
message. Without this, k protocol instances subscribed to one shared
external bus each run their full router pass over EVERY inbound 3PC
message and k-1 of them discard it — measured 22x handler amplification at
f+1=22 instances (n=64), the single largest host cost in the full-RBFT
configuration.

The demux owns the ONLY external-bus subscription for the per-instance
message types; each instance (master included) registers its
StashingRouter under its ``inst_id``. Messages for unknown instances are
dropped (the reference discards those too — a byzantine peer must not
make a node pay for instances it doesn't run).

Copy of ``indy_plenum_tpu/server/instance_demux.py``, with its imports bound
to the port.
"""
from __future__ import annotations

import logging
from typing import Dict

from ..common.messages.node_messages import (
    Checkpoint,
    Commit,
    PrePrepare,
    Prepare,
)

logger = logging.getLogger(__name__)

# every message type whose schema carries ``instId`` and which a
# per-instance service consumes from the network
INSTANCE_TYPES = (PrePrepare, Prepare, Commit, Checkpoint)


class Instance3PCDemux:
    def __init__(self, external_bus):
        self._bus = external_bus
        self._stashers: Dict[int, object] = {}
        for mtype in INSTANCE_TYPES:
            external_bus.subscribe(mtype, self._route)

    def register(self, inst_id: int, stasher) -> None:
        self._stashers[inst_id] = stasher

    def unregister(self, inst_id: int) -> None:
        self._stashers.pop(inst_id, None)

    def close(self) -> None:
        for mtype in INSTANCE_TYPES:
            self._bus.unsubscribe(mtype, self._route)
        self._stashers.clear()

    def _route(self, msg, frm: str) -> None:
        stasher = self._stashers.get(getattr(msg, "instId", 0))
        if stasher is None:
            logger.debug("dropping %s for unknown instance %s",
                         type(msg).__name__, getattr(msg, "instId", 0))
            return
        stasher.process(msg, frm)
