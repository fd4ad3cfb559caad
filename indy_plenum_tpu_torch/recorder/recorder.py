"""Record one node's inputs; replay them into a fresh node bit-for-bit.

Reference: plenum/recorder/ (`Recorder`, the replayer scripts). Because
every consensus service sees time ONLY through the TimerService and inputs
ONLY through the external bus + client ingress, a node is a deterministic
function of (genesis, config, timed input log). The recorder tees both
input surfaces with virtual-clock timestamps; the replayer schedules the
log against a fresh MockTimer and the replayed node reproduces the
original ordered log, ledgers and state roots — the debugging story for
"what did this node see before it diverged".

Copy of ``indy_plenum_tpu/recorder/recorder.py``, with its imports bound
to the port. The recorder builds nothing on a device: a replayed node
takes its ``device`` where it is built, and its kernels run there
(``chip_smoke.py`` phase Y replays into a node on the card).
"""
from __future__ import annotations

import json
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..common.messages.message_base import node_message_registry
from ..common.request import Request

NET = "net"
CLIENT = "client"


class Recorder:
    def __init__(self):
        self.entries: List[Tuple[float, str, str, Dict[str, Any]]] = []
        self._now: Optional[Callable[[], float]] = None

    # --- wiring ---------------------------------------------------------

    def attach(self, node) -> None:
        """Tee the node's two input surfaces (idempotent per node: a
        second attach would double-record every input and the replay
        would diverge)."""
        if getattr(node, "_recorder_attached", None) is self:
            return
        node._recorder_attached = self
        self._now = node.timer.get_current_time

        original_incoming = node.external_bus.process_incoming

        def recording_incoming(msg, frm):
            self.record_net(frm, msg)
            return original_incoming(msg, frm)

        node.external_bus.process_incoming = recording_incoming

        original_submit = node.submit_client_request

        def recording_submit(req, client_id=None):
            self.record_client(client_id, req)
            return original_submit(req, client_id=client_id)

        node.submit_client_request = recording_submit

    # --- recording ------------------------------------------------------

    def record_net(self, frm: str, msg) -> None:
        if hasattr(msg, "as_dict"):
            self.entries.append((self._now(), NET, frm, msg.as_dict()))

    def record_client(self, client_id: Optional[str], req: Request) -> None:
        self.entries.append(
            (self._now(), CLIENT, client_id or "", req.as_dict()))

    # --- persistence ----------------------------------------------------

    def dump(self, path: str) -> None:
        with open(path, "w") as fh:
            for ts, kind, frm, payload in self.entries:
                fh.write(json.dumps([ts, kind, frm, payload]) + "\n")

    @classmethod
    def load(cls, path: str) -> "Recorder":
        rec = cls()
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if line:
                    ts, kind, frm, payload = json.loads(line)
                    rec.entries.append((ts, kind, frm, payload))
        return rec


class Replayer:
    """Schedule a recorded input log against a fresh node's MockTimer."""

    def __init__(self, recorder: Recorder):
        self._entries = list(recorder.entries)

    def replay_into(self, node, timer) -> None:
        """``timer``: the MockTimer the node was built on, positioned at or
        before the first entry. Schedules every input at its recorded
        virtual time; the caller advances the clock."""
        start = timer.get_current_time()
        for ts, kind, frm, payload in self._entries:
            delay = max(0.0, ts - start)
            if kind == NET:
                def deliver(p=dict(payload), f=frm):
                    msg = node_message_registry.obj_from_dict(dict(p))
                    node.external_bus.process_incoming(msg, f)
            else:
                def deliver(p=dict(payload), c=frm):
                    node.submit_client_request(
                        Request.from_dict(dict(p)), client_id=c or None)
            timer.schedule(delay, deliver)

    @property
    def duration(self) -> float:
        if not self._entries:
            return 0.0
        return self._entries[-1][0] - self._entries[0][0]


class ReplayNetwork:
    """The replayed node's sends go nowhere (its outputs are a FUNCTION of
    the recorded inputs; the pool is not there to answer)."""

    def create_peer(self, name: str):
        from ..common.event_bus import ExternalBus

        return ExternalBus(lambda msg, dst=None: None)
