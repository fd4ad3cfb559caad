"""Node-to-node transport: authenticated ZMQ stacks.

Reference: stp_zmq/ (ZStack and friends). See :mod:`.zstack` for the
CurveZMQ ROUTER stack, :mod:`.client_stack` for the client-facing
listener and the pool client, and :mod:`.keys` for key management.

Copy of ``indy_plenum_tpu/network/__init__.py``: ``ZStackNetwork`` is the
``create_peer`` seam the port's ``Node`` takes, and its
``membership_hook`` rewires the stack on committed NODE txns.
"""
from ..common.event_bus import ExternalBus
from .keys import curve_keypair_from_seed
from .zstack import ZStack

__all__ = ["ZStack", "ZStackNetwork", "curve_keypair_from_seed"]


class ZStackNetwork:
    """Adapter: one node's ZStack as the Node composition's network seam
    (the same ``create_peer`` contract the simulation's SimNetwork has)."""

    def __init__(self, stack: ZStack):
        self.stack = stack
        self.bus = None

    def create_peer(self, name: str) -> ExternalBus:
        assert name == self.stack.name, (name, self.stack.name)

        def send_handler(msg, dst=None):
            if isinstance(dst, str):
                dst = [dst]
            self.stack.send(msg, dst)

        self.bus = ExternalBus(send_handler)
        # looked up at each delivery, not bound once: a recorder attached
        # after the node was built (recorder.Recorder.attach rebinds the
        # bus's process_incoming) must see every message the stack brings
        self.stack.on_message = \
            lambda msg, frm: self.bus.process_incoming(msg, frm)
        # socket-monitor liveness -> bus Connected/Disconnected events (the
        # primary-disconnect detector runs on these over real sockets)
        self.stack.on_connection_change = self._on_connection_change
        return self.bus

    def _on_connection_change(self, peer: str, up: bool) -> None:
        connecteds = set(self.bus.connecteds)
        if up:
            connecteds.add(peer)
        else:
            connecteds.discard(peer)
        self.bus.update_connecteds(connecteds)

    def mark_connected(self, peers) -> None:
        """Optimistic initial topology, reconciled against any liveness
        edges the stack observed before this composition attached (a peer
        already seen to drop must not be resurrected optimistically)."""
        known = self.stack.peer_states
        self.bus.update_connecteds(
            {p for p in peers if known.get(p, True)})

    def membership_hook(self, validators, registry) -> None:
        """Consumer for ``Node.on_membership_changed_hook`` (reference:
        KITZStack reacting to pool-ledger changes): members that left are
        disconnected; members whose NODE txn carries transport info are
        connected — or RECONNECTED when their key/address rotated. Records
        without transport info (static wiring) are left untouched."""
        from ..common.constants import (
            NODE_IP,
            NODE_PORT,
            TRANSPORT_VERKEY,
        )

        own = self.stack.name
        members = set(validators)
        for peer in list(self.stack.connected_peers):
            if peer not in members:
                self.stack.disconnect_peer(peer)
                self._on_connection_change(peer, False)
        for alias in validators:
            if alias == own:
                continue
            rec = registry.get(alias) or {}
            key = rec.get(TRANSPORT_VERKEY)
            host, port = rec.get(NODE_IP), rec.get(NODE_PORT)
            if not key or not host or not port:
                continue
            self.stack.upsert_peer(alias, (host, int(port)), key.encode())
