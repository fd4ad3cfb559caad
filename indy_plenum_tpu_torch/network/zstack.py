"""Authenticated node-to-node transport: ZMQ ROUTER + CurveZMQ.

Reference: stp_zmq/zstack.py (`ZStack`, `KITZStack`) and stp_zmq's ZAP
authenticator. Each node binds ONE ROUTER listener in curve-server mode
and opens a curve-client DEALER per peer. A minimal in-process ZAP handler
admits only Curve25519 keys from the pool registry, and — the part that
makes the byzantine tests honest — every inbound message is attributed by
the AUTHENTICATED curve key of its connection (ZMQ's User-Id metadata,
set by our ZAP handler), never by any name the bytes claim. A validator
cannot speak under another validator's name, and an unknown key cannot
complete the handshake at all.

Outgoing messages per peer are coalesced into one ``Batch`` envelope per
service() flush (reference: plenum/common/batched.py), bounded by
``OUTGOING_BATCH_SIZE``.

Wire format: msgpack of the registry dict form (``op`` field dispatch),
byte-identical to the JAX package's, so port and JAX validators share one
pool. The port's msgpack decoder raises ``UnpackError`` on bad bytes; the
receive path's broad ``except`` contains it as it contains msgpack's own
errors (wire data is untrusted).

Copy of ``indy_plenum_tpu/network/zstack.py``, with its imports bound to
the port. The transport is host code: it moves bytes, and the card's work
starts where the node drains what the stack delivered.
"""
# da: allow-file[nondet-source] -- DEPLOYED transport: reconnect/monitor timers and the wire-trace clock read real time; the seeded transport is simulation/sim_network.py on the virtual clock
from __future__ import annotations

import logging
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import zmq
import zmq.utils.z85 as z85
from zmq.utils.monitor import recv_monitor_message

from ..common.messages.message_base import node_message_registry
from ..common.messages.node_messages import Batch
from ..common.metrics_collector import MetricsName
from ..common.serializers.serialization import (
    deserialize_msgpack,
    serialize_msg,
)
from .keys import curve_keypair_from_seed

logger = logging.getLogger(__name__)

_ZAP_ENDPOINT = "inproc://zeromq.zap.01"


class ZStack:
    """One node's transport stack (listener + per-peer connections)."""

    def __init__(self,
                 name: str,
                 seed: bytes,
                 on_message: Optional[Callable] = None,
                 bind_host: str = "127.0.0.1",
                 bind_port: int = 0,
                 max_batch: int = 100,
                 msg_len_limit: int = 128 * 1024,
                 metrics=None,
                 reconnect_interval: float = 2.0):
        self.name = name
        self.public_key, self._secret_key = curve_keypair_from_seed(seed)
        self.on_message = on_message  # (msg_obj, sender_name) -> None
        self._max_batch = max_batch
        self._msg_len_limit = msg_len_limit
        self._metrics = metrics  # optional MetricsCollector
        # causal tracing plane: with a recorder attached (build_node
        # wires the Node's), journey-joinable messages piggyback a
        # ``~trc`` context on the serialized envelope — {id, sender,
        # sender-clock send ts} — and both ends stamp net.send/net.recv
        # marks. The receiver strips the context before schema
        # validation, so untraced peers interoperate unchanged.
        from ..observability.trace import NULL_TRACE

        self.trace = NULL_TRACE
        self._net_seq = 0

        self._ctx = zmq.Context()
        # never block interpreter shutdown: ctx.term() waits for open
        # sockets forever by default, so a composition that forgot close()
        # would hang Python at GC (observed in the test suite)
        self._ctx.set(zmq.BLOCKY, False)
        self._closed = False
        # ZAP handler must exist before any curve-server socket binds.
        # ROUTER, not REP: concurrent handshakes (the whole pool connecting
        # at startup) put several ZAP requests in flight at once, and REP's
        # strict alternation would wedge the handler.
        self._zap = self._ctx.socket(zmq.ROUTER)
        self._zap.bind(_ZAP_ENDPOINT)
        self._allowed: Dict[bytes, str] = {}  # public_z85 -> node name

        self._listener = self._ctx.socket(zmq.ROUTER)
        self._listener.setsockopt(zmq.CURVE_SERVER, 1)
        self._listener.setsockopt(zmq.CURVE_SECRETKEY, self._secret_key)
        self._listener.setsockopt(zmq.LINGER, 0)
        self._listener.bind(f"tcp://{bind_host}:{bind_port}")
        endpoint = self._listener.getsockopt_string(zmq.LAST_ENDPOINT)
        self.ha: Tuple[str, int] = (bind_host, int(endpoint.rsplit(":", 1)[1]))

        self._remotes: Dict[str, zmq.Socket] = {}
        self._remote_ha: Dict[str, Tuple[str, int]] = {}
        self._outbox: Dict[str, List[bytes]] = defaultdict(list)
        self._poller = zmq.Poller()
        self._poller.register(self._listener, zmq.POLLIN)
        self._poller.register(self._zap, zmq.POLLIN)
        self.received = 0
        self.rejected_unknown_key = 0
        # messages lost to a full peer HWM ("UDP-like" sends): without this
        # counter a saturated pool is slow in a way metrics can't explain
        self.dropped = 0
        # liveness: libzmq socket monitors per remote feed the composition
        # (handshake-succeeded = peer up, disconnected = peer down) — this
        # is what lets the primary-disconnect detector work over sockets
        self._monitors: Dict[zmq.Socket, str] = {}
        self._peer_up: Dict[str, bool] = {}
        # peers whose CURVE handshake ever completed on the current
        # connection registration. NOT derivable from _peer_up: a
        # ZAP-rejected attempt still emits EVENT_DISCONNECTED (TCP-level),
        # so _peer_up can hold False entries for peers that never
        # authenticated once
        self._handshaken: set = set()
        self._down_since: Dict[str, float] = {}  # peer -> monotonic time
        self.on_connection_change = None  # (peer_name, up: bool) -> None
        # keep-in-touch (reference: stp_zmq/kit_zstack.py): periodically
        # RECREATE the DEALER of any peer whose curve handshake hasn't
        # succeeded. Necessary, not cosmetic: a ZAP-rejected handshake is
        # TERMINAL for that socket in libzmq (observed: no further
        # reconnect attempts), so a peer admitted to the registry after a
        # first failed attempt — the add-a-node flow — would never become
        # reachable without this.
        self._reconnect_interval = reconnect_interval
        self._last_reconnect_check = time.monotonic()
        self.reconnects = 0
        # per-peer recreate pacing for NEVER-handshaken peers: the same
        # grace the handshaken path gets, then exponential backoff — a
        # slow-to-boot or slow-handshaking peer must not have its DEALER
        # (and in-flight handshake) torn down every interval (round-4
        # advisor finding). (attempts, earliest next recreate).
        self._recreate_state: Dict[str, Tuple[int, float]] = {}

    # --- registry -------------------------------------------------------

    def allow_peer(self, name: str, public_z85: bytes) -> None:
        """Admit ``name``'s transport key (pool-registry driven)."""
        self._allowed[bytes(public_z85)] = name

    def disallow_peer(self, name: str) -> None:
        for key, peer in list(self._allowed.items()):
            if peer == name:
                del self._allowed[key]

    def connect(self, name: str, ha: Tuple[str, int],
                server_public_z85: bytes) -> None:
        if name in self._remotes:
            return
        sock = self._ctx.socket(zmq.DEALER)
        sock.setsockopt(zmq.CURVE_SERVERKEY, bytes(server_public_z85))
        sock.setsockopt(zmq.CURVE_PUBLICKEY, self.public_key)
        sock.setsockopt(zmq.CURVE_SECRETKEY, self._secret_key)
        sock.setsockopt(zmq.LINGER, 0)
        # EVENT_CLOSED is deliberately absent: libzmq's connecter also
        # emits it for every FAILED connect attempt (peer not bound yet),
        # which would report a never-connected peer as "down" at startup.
        # DISCONNECTED only fires after an established session drops.
        monitor = sock.get_monitor_socket(
            zmq.EVENT_HANDSHAKE_SUCCEEDED | zmq.EVENT_DISCONNECTED)
        self._monitors[monitor] = name
        self._poller.register(monitor, zmq.POLLIN)
        sock.connect(f"tcp://{ha[0]}:{ha[1]}")
        self._remotes[name] = sock
        self._remote_ha[name] = (ha[0], int(ha[1]))

    @property
    def connected_peers(self) -> List[str]:
        return list(self._remotes)

    # --- keep-in-touch registry sync (reference: stp_zmq/kit_zstack.py) -

    def _close_remote(self, name: str) -> None:
        """Close ``name``'s DEALER + monitor; registry entries survive."""
        sock = self._remotes.pop(name, None)
        if sock is None:
            return
        for mon, peer in list(self._monitors.items()):
            if peer == name:
                try:
                    self._poller.unregister(mon)
                except KeyError:
                    pass
                mon.close(0)
                del self._monitors[mon]
        try:
            sock.disable_monitor()
        except Exception:  # noqa: BLE001
            pass
        sock.close(0)

    def disconnect_peer(self, name: str) -> None:
        """Close the DEALER to ``name`` and forget its curve key (member
        removed, or about to be reconnected under a new key)."""
        self._close_remote(name)
        self._outbox.pop(name, None)
        self._remote_ha.pop(name, None)
        self.disallow_peer(name)
        self._peer_up.pop(name, None)
        # a rotated/readmitted peer's fresh connection may be rejected
        # again — the KIT retry must be willing to recreate it
        self._handshaken.discard(name)
        self._down_since.pop(name, None)
        self._recreate_state.pop(name, None)

    def _retry_dead_connections(self) -> None:
        """KIT reconnect pass: any peer without a completed handshake gets
        a FRESH DEALER (old one may be in the terminal post-ZAP-reject
        state); queued outbox survives and flushes once the new session
        comes up."""
        now = time.monotonic()
        if now - self._last_reconnect_check < self._reconnect_interval:
            return
        self._last_reconnect_check = now
        grace = 3 * self._reconnect_interval
        for name in list(self._remotes):
            if name in self._handshaken:
                # handshake once succeeded: libzmq's native reconnect
                # handles transient drops AND preserves the messages
                # already queued in the pipe — recreating the socket would
                # close(0) them away. But only within a grace window: a
                # peer that restarted into a state that ZAP-rejects us is
                # terminal for this socket, so after a prolonged outage a
                # fresh DEALER is the only way back (queued messages are
                # stale by then; MessageReq recovers protocol state).
                down = self._down_since.get(name)
                if down is None or now - down < grace:
                    continue
                self._handshaken.discard(name)
            else:
                # never handshaken: give the in-flight attempt the same
                # grace before tearing its DEALER down, then back off
                # exponentially (cap 8x grace) — recreating every interval
                # can perpetually abort a handshake slower than the
                # interval and churns socket+monitor objects forever
                attempts, next_at = self._recreate_state.get(
                    name, (0, now + grace))
                if now < next_at:
                    if name not in self._recreate_state:
                        self._recreate_state[name] = (attempts, next_at)
                    continue
                attempts = min(attempts + 1, 3)  # clamp the exponent too:
                # a permanently-dead registry entry must not grow the
                # counter (and the bignum 2**attempts) without bound
                backoff = grace * (2 ** attempts)
                self._recreate_state[name] = (attempts, now + backoff)
            ha = self._remote_ha.get(name)
            key = next((k for k, p in self._allowed.items() if p == name),
                       None)
            if ha is None or key is None:
                continue
            self._close_remote(name)
            self.connect(name, ha, key)
            self.reconnects += 1

    def upsert_peer(self, name: str, ha: Tuple[str, int],
                    public_z85: bytes) -> bool:
        """Connect a new peer, or RESTART the connection when its curve
        key or address changed (the rotation path); returns True if the
        connection was (re)established."""
        key = bytes(public_z85)
        ha = (ha[0], int(ha[1]))
        if name in self._remotes:
            current_key = next((k for k, p in self._allowed.items()
                                if p == name), None)
            if current_key == key and self._remote_ha.get(name) == ha:
                return False  # unchanged
            logger.info("%s: peer %s rotated its transport key or "
                        "address; restarting connection", self.name, name)
            self.disconnect_peer(name)
        self.allow_peer(name, key)
        self.connect(name, ha, key)
        return True

    # --- sending --------------------------------------------------------

    def send(self, msg, dst: Optional[List[str]] = None) -> None:
        """Queue ``msg`` (a MessageBase or dict) for peers; coalesced into
        Batch envelopes at the next service() flush."""
        obj = msg.as_dict() if hasattr(msg, "as_dict") else msg
        targets = list(self._remotes) if dst is None else dst
        key = None
        if self.trace.enabled and isinstance(obj, dict):
            from ..observability.causal import (
                NET_TRACED_OPS,
                net_join_key,
            )

            op = obj.get("op")
            if op in NET_TRACED_OPS:
                key = net_join_key(op, obj.get)
        if key is None:
            data = serialize_msg(obj)
            for peer in targets:
                if peer in self._remotes:
                    self._outbox[peer].append(data)
            return
        # traced: each copy carries its own context (per-peer flow id),
        # so the envelope itself is the propagation vehicle — the
        # receiving node needs no shared state to join the hop
        ts = time.perf_counter()
        for peer in targets:
            if peer not in self._remotes:
                continue
            self._net_seq += 1
            nid = "%s:%d" % (self.name, self._net_seq)
            data = serialize_msg(dict(
                obj, **{"~trc": {"id": nid, "frm": self.name,
                                 "sent": ts}}))
            if len(data) > self._msg_len_limit:
                # near-limit payload: the context would push it past the
                # receiver's oversize drop — tracing must NEVER change
                # what gets delivered, so this copy ships untraced
                self._outbox[peer].append(serialize_msg(obj))
                continue
            # da: allow[trace-guard] -- key is non-None ONLY when self.trace.enabled held at the top of send(); this loop is unreachable untraced
            self.trace.record("net.send", cat="net", node=self.name,
                              key=key,
                              args={"m": obj["op"], "to": peer,
                                    "id": nid}, ts=ts)
            self._outbox[peer].append(data)

    def _flush(self) -> None:
        for peer, queue in self._outbox.items():
            sock = self._remotes.get(peer)
            if sock is None or not queue:
                continue
            while queue:
                chunk, self._outbox[peer] = (queue[:self._max_batch],
                                             queue[self._max_batch:])
                queue = self._outbox[peer]
                if len(chunk) == 1:
                    payload = chunk[0]
                else:
                    payload = serialize_msg(Batch(
                        messages=list(chunk), signature=None).as_dict())
                try:
                    sock.send(payload, flags=zmq.NOBLOCK)
                except zmq.Again:  # peer HWM reached; drop (UDP-like)
                    self.dropped += len(chunk)
                    if self._metrics is not None:
                        self._metrics.add_event(MetricsName.ZSTACK_DROPPED,
                                                len(chunk))
                    logger.warning("%s: send queue full for %s; %d "
                                   "message(s) dropped", self.name, peer,
                                   len(chunk))
                    break

    # --- receiving ------------------------------------------------------

    def _service_zap(self) -> None:
        while True:
            try:
                frames = self._zap.recv_multipart(flags=zmq.NOBLOCK)
            except zmq.Again:
                return
            # ROUTER framing: [envelope..., b"", version, request_id,
            # domain, address, identity, mechanism, credentials...];
            # CURVE credential = raw 32-byte client key
            try:
                split = frames.index(b"")
            except ValueError:
                continue
            envelope, body = frames[:split + 1], frames[split + 1:]
            if len(body) < 6:
                continue
            version, request_id, mechanism = body[0], body[1], body[5]
            status, user_id = b"400", b""
            if mechanism == b"CURVE" and len(body) > 6:
                key_z85 = z85.encode(body[6])
                if key_z85 in self._allowed:
                    status, user_id = b"200", key_z85
                else:
                    self.rejected_unknown_key += 1
                    logger.warning("%s: ZAP rejected unknown curve key",
                                   self.name)
            self._zap.send_multipart(envelope + [
                version, request_id, status,
                b"OK" if status == b"200" else b"unknown key",
                user_id, b""])

    def _sender_of(self, frame: zmq.Frame) -> Optional[str]:
        """The AUTHENTICATED peer name: resolved from the connection's
        curve key (ZAP User-Id), never from claimed content."""
        try:
            user_id = frame.get("User-Id")
        except Exception:  # noqa: BLE001
            return None
        if not user_id:
            return None
        return self._allowed.get(user_id.encode()
                                 if isinstance(user_id, str) else user_id)

    def _dispatch(self, payload: bytes, sender: str,
                  in_batch: bool = False) -> None:
        if len(payload) > self._msg_len_limit:
            logger.warning("%s: oversize message from %s dropped",
                           self.name, sender)
            return
        try:
            data = deserialize_msgpack(payload)
            # piggybacked trace context (causal tracing plane): strip it
            # BEFORE schema validation — the wire context is advisory
            # observability, never protocol surface
            ctx = data.pop("~trc", None) if isinstance(data, dict) \
                else None
            msg = node_message_registry.obj_from_dict(data)
        except Exception as exc:  # noqa: BLE001 — wire data is untrusted
            logger.warning("%s: bad message from %s: %s", self.name,
                           sender, exc)
            return
        if ctx is not None and self.trace.enabled:
            from ..observability.causal import net_join_key

            op = data.get("op")
            key = net_join_key(op, data.get) if op else None
            if key is not None:
                # args carry the SENDER's clock reading: the two hosts'
                # clocks differ, so causal joins use it as an offset
                # estimate, not a shared timeline
                self.trace.record(
                    "net.recv", cat="net", node=self.name, key=key,
                    args={"m": op, "frm": sender,
                          "id": ctx.get("id"),
                          "sent": ctx.get("sent")})
        if isinstance(msg, Batch):
            # byzantine guards: a batch inside a batch is never legitimate
            # (unbounded recursion), and elements must be bytes (the field
            # schema also admits str) — validate ALL before dispatching ANY
            if in_batch:
                logger.warning("%s: nested BATCH from %s dropped",
                               self.name, sender)
                return
            inners = []
            for inner in msg.messages:
                if not isinstance(inner, (bytes, bytearray)):
                    logger.warning("%s: non-bytes BATCH element from %s",
                                   self.name, sender)
                    return
                inners.append(bytes(inner))
            for inner_payload in inners:
                self._dispatch(inner_payload, sender, in_batch=True)
            return
        self.received += 1
        if self.on_message is not None:
            self.on_message(msg, sender)

    @property
    def peer_states(self) -> Dict[str, bool]:
        """Last known liveness per peer (edges observed so far) — lets a
        late-attaching composition reconcile instead of losing edges."""
        return dict(self._peer_up)

    def _service_monitors(self, events) -> None:
        for mon, peer in list(self._monitors.items()):
            if mon not in events:
                continue
            while True:
                try:
                    evt = recv_monitor_message(mon, flags=zmq.NOBLOCK)
                except zmq.Again:
                    break
                kind = evt["event"]
                if kind == zmq.EVENT_HANDSHAKE_SUCCEEDED:
                    up = True
                    self._handshaken.add(peer)
                    self._down_since.pop(peer, None)
                    self._recreate_state.pop(peer, None)
                elif kind == zmq.EVENT_DISCONNECTED:
                    up = False
                    self._down_since.setdefault(peer, time.monotonic())
                else:
                    continue
                if self._peer_up.get(peer) != up:
                    self._peer_up[peer] = up
                    logger.info("%s: peer %s %s", self.name, peer,
                                "up" if up else "down")
                    if self.on_connection_change is not None:
                        self.on_connection_change(peer, up)

    def drain_inbound(self) -> int:
        """Drain EVERY pending socket read and dispatch it (the
        dispatch-plane drain step over real sockets): loops until the
        listener reports empty, so when this returns the composition
        holds the COMPLETE inbound set — signed ingress in the auth
        queue, votes recorded host-side. The Looper prods transports
        before servicing timers, so a barrier quorum tick always fires
        against a drained transport (one grouped device step then covers
        everything that arrived during the interval)."""
        handled = 0
        while True:
            try:
                frames = self._listener.recv_multipart(
                    flags=zmq.NOBLOCK, copy=False)
            except zmq.Again:
                break
            payload = frames[-1]
            sender = self._sender_of(payload)
            if sender is None:
                continue  # unauthenticated — ZAP metadata missing
            self._dispatch(bytes(payload.buffer), sender)
            handled += 1
        return handled

    def service(self, timeout_ms: int = 0) -> int:
        """Pump ZAP + inbound + outbound once; returns messages handled.

        Order per pass: handshakes (ZAP) and liveness edges first, then a
        FULL inbound drain (:meth:`drain_inbound` — the tick contract's
        drain step), then the coalesced outbound flush."""
        handled = 0
        events = dict(self._poller.poll(timeout_ms))
        if self._zap in events:
            self._service_zap()
        self._service_monitors(events)
        self._retry_dead_connections()
        if self._listener in events:
            handled += self.drain_inbound()
        self._flush()
        return handled

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for sock in self._remotes.values():
            try:
                sock.disable_monitor()
            except Exception:  # noqa: BLE001
                pass
            sock.close(0)
        for mon in self._monitors:
            mon.close(0)
        self._listener.close(0)
        self._zap.close(0)
        self._ctx.term()
