"""Client-facing transport: the node's second listener + the pool client.

Reference: stp_zmq/simple_zstack.py (`SimpleZStack`) and
stp_zmq/client_message_provider.py (`ClientMessageProvider`). Every
validator binds TWO sockets: the node-to-node ROUTER (zstack.py, curve
keys pinned to the pool registry) and this client-facing ROUTER, which is
curve-ENCRYPTED but not curve-PINNED — any client keypair may complete the
handshake (clients are authenticated at the application layer by their
request signatures, not at transport). Replies route back over the same
ROUTER connection by ZMQ identity, which is what ClientMessageProvider
does upstream.

Wire format:
  client -> node: msgpack of ``Request.as_dict()`` (no "op" field — the
                  only legitimate inbound traffic on this socket is
                  client requests)
  node -> client: msgpack of REPLY / REQACK / REQNACK via the node
                  message registry ("op"-dispatched)

Copy of ``indy_plenum_tpu/network/client_stack.py``, with its imports
bound to the port.
"""
from __future__ import annotations

import logging
from typing import Callable, Dict, List, Optional, Tuple

import zmq

from ..common.messages.message_base import node_message_registry
from ..common.request import Request
from ..common.serializers.serialization import (
    deserialize_msgpack,
    serialize_msg,
)
from .keys import curve_keypair_from_seed

logger = logging.getLogger(__name__)

_ZAP_ENDPOINT = "inproc://zeromq.zap.01"


class ClientZStack:
    """The node-side client listener (reference: SimpleZStack)."""

    def __init__(self,
                 name: str,
                 seed: bytes,
                 on_request: Optional[Callable[[Request, str], None]] = None,
                 bind_host: str = "127.0.0.1",
                 bind_port: int = 0,
                 msg_len_limit: int = 128 * 1024):
        self.name = name
        from .keys import client_stack_keypair_from_seed

        self.public_key, self._secret_key = \
            client_stack_keypair_from_seed(seed)
        self.on_request = on_request  # (Request, client_id) -> None
        self._msg_len_limit = msg_len_limit

        # own context: ZAP policy is per-context, and this listener's
        # policy (admit any curve key) must not leak onto the node stack
        self._ctx = zmq.Context()
        self._ctx.set(zmq.BLOCKY, False)  # never hang shutdown on term()
        self._closed = False
        self._zap = self._ctx.socket(zmq.ROUTER)
        self._zap.bind(_ZAP_ENDPOINT)

        self._listener = self._ctx.socket(zmq.ROUTER)
        self._listener.setsockopt(zmq.CURVE_SERVER, 1)
        self._listener.setsockopt(zmq.CURVE_SECRETKEY, self._secret_key)
        self._listener.setsockopt(zmq.LINGER, 0)
        # unroutable replies must FAIL, not vanish: without MANDATORY a
        # ROUTER silently discards sends to a departed identity and
        # send_to_client's False path would be unreachable
        self._listener.setsockopt(zmq.ROUTER_MANDATORY, 1)
        self._listener.bind(f"tcp://{bind_host}:{bind_port}")
        endpoint = self._listener.getsockopt_string(zmq.LAST_ENDPOINT)
        self.ha: Tuple[str, int] = (bind_host,
                                    int(endpoint.rsplit(":", 1)[1]))

        self._poller = zmq.Poller()
        self._poller.register(self._listener, zmq.POLLIN)
        self._poller.register(self._zap, zmq.POLLIN)
        # client_id (identity hex) -> ROUTER identity frame for replies.
        # Bounded LRU: this listener admits ANY curve key by design, so an
        # attacker opening connections in a loop must not grow node
        # memory without bound; evicting an ACTIVE client only costs it a
        # reply (it re-submits / asks another node, reference behaviour)
        from collections import OrderedDict

        self._identities: "OrderedDict[str, bytes]" = OrderedDict()
        self._max_identities = 10_000
        self.received = 0

    # ------------------------------------------------------------------

    def _service_zap(self) -> None:
        """Permissive ZAP: every CURVE handshake is admitted. Clients are
        not pool members; their requests authenticate themselves."""
        while True:
            try:
                frames = self._zap.recv_multipart(flags=zmq.NOBLOCK)
            except zmq.Again:
                return
            try:
                split = frames.index(b"")
            except ValueError:
                continue
            envelope, body = frames[:split + 1], frames[split + 1:]
            if len(body) < 6:
                continue
            version, request_id = body[0], body[1]
            self._zap.send_multipart(envelope + [
                version, request_id, b"200", b"OK", b"client", b""])

    def _handle_payload(self, identity: bytes, payload: bytes) -> None:
        if len(payload) > self._msg_len_limit:
            logger.warning("%s: oversize client message dropped", self.name)
            return
        client_id = identity.hex()
        self._identities[client_id] = identity
        self._identities.move_to_end(client_id)
        while len(self._identities) > self._max_identities:
            self._identities.popitem(last=False)
        try:
            data = deserialize_msgpack(payload)
            req = Request.from_dict(data)
        except Exception as exc:  # noqa: BLE001 — wire data is untrusted
            logger.warning("%s: bad client request: %s", self.name, exc)
            return
        self.received += 1
        if self.on_request is not None:
            self.on_request(req, client_id)

    def send_to_client(self, client_id: str, msg) -> bool:
        """Route a REPLY/REQACK/REQNACK back over the client's own
        connection; False if the connection is gone (client's problem —
        it re-submits or asks another node, reference behaviour)."""
        identity = self._identities.get(client_id)
        if identity is None:
            return False
        payload = serialize_msg(msg.as_dict() if hasattr(msg, "as_dict")
                                else msg)
        try:
            self._listener.send_multipart([identity, payload],
                                          flags=zmq.NOBLOCK)
            return True
        except zmq.ZMQError:
            return False

    def service(self, timeout_ms: int = 0) -> int:
        handled = 0
        events = dict(self._poller.poll(timeout_ms))
        if self._zap in events:
            self._service_zap()
        if self._listener in events:
            while True:
                try:
                    frames = self._listener.recv_multipart(flags=zmq.NOBLOCK)
                except zmq.Again:
                    break
                if len(frames) < 2:
                    continue
                self._handle_payload(frames[0], frames[-1])
                handled += 1
        return handled

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._listener.close(0)
        self._zap.close(0)
        self._ctx.term()


class NodeClientSurface:
    """Glue: one node's ClientZStack pumped by the Looper — inbound
    requests into ``Node.submit_client_request``, the node's
    ``client_outbox`` drained back out (reference:
    ClientMessageProvider.transmit_to_client)."""

    def __init__(self, node, stack: ClientZStack):
        self.node = node
        self.stack = stack
        stack.on_request = self._on_request

    def _on_request(self, req: Request, client_id: str) -> None:
        try:
            self.node.submit_client_request(req, client_id=client_id)
        except Exception:  # noqa: BLE001 — one bad request must not kill
            # the client surface
            logger.exception("%s: client request failed", self.node.name)

    def service(self, timeout_ms: int = 0) -> int:
        handled = self.stack.service(timeout_ms)
        outbox, self.node.client_outbox = self.node.client_outbox, []
        for client_id, msg in outbox:
            if client_id is not None:
                self.stack.send_to_client(client_id, msg)
        return handled + len(outbox)

    def close(self) -> None:
        self.stack.close()


class PoolClientStack:
    """The client-process side: one DEALER per validator, fresh curve
    keypair, pool-published server keys (reference: the client's
    SimpleZStack connecting to every node's client port)."""

    def __init__(self,
                 name: str,
                 nodes: Dict[str, Tuple[Tuple[str, int], bytes]],
                 on_message: Optional[Callable] = None,
                 msg_len_limit: int = 128 * 1024):
        """``nodes``: node name -> ((host, port), server_public_z85)."""
        import os

        self.name = name
        self.on_message = on_message  # (node_name, msg) -> None
        self._msg_len_limit = msg_len_limit
        # da: allow[nondet-source] -- CurveZMQ session keypair generation: entropy by design (crypto keygen seam), never replayed
        public, secret = curve_keypair_from_seed(os.urandom(32))
        self._ctx = zmq.Context()
        self._ctx.set(zmq.BLOCKY, False)  # never hang shutdown on term()
        self._closed = False
        self._remotes: Dict[str, zmq.Socket] = {}
        self._poller = zmq.Poller()
        for node_name, (ha, server_public) in nodes.items():
            sock = self._ctx.socket(zmq.DEALER)
            sock.setsockopt(zmq.CURVE_SERVERKEY, bytes(server_public))
            sock.setsockopt(zmq.CURVE_PUBLICKEY, public)
            sock.setsockopt(zmq.CURVE_SECRETKEY, secret)
            sock.setsockopt(zmq.LINGER, 0)
            sock.connect(f"tcp://{ha[0]}:{ha[1]}")
            self._remotes[node_name] = sock
            self._poller.register(sock, zmq.POLLIN)

    @property
    def node_names(self) -> List[str]:
        return list(self._remotes)

    def send(self, request: Request, node_name: str) -> None:
        sock = self._remotes.get(node_name)
        if sock is None:
            logger.warning("client %s: unknown node %s", self.name,
                           node_name)
            return
        try:
            sock.send(serialize_msg(request.as_dict()), flags=zmq.NOBLOCK)
        except zmq.Again:
            logger.warning("client %s: send queue full for %s", self.name,
                           node_name)

    def service(self, timeout_ms: int = 0) -> int:
        handled = 0
        events = dict(self._poller.poll(timeout_ms))
        for node_name, sock in self._remotes.items():
            if sock not in events:
                continue
            while True:
                try:
                    payload = sock.recv(flags=zmq.NOBLOCK)
                except zmq.Again:
                    break
                if len(payload) > self._msg_len_limit:
                    continue
                try:
                    msg = node_message_registry.obj_from_dict(
                        deserialize_msgpack(payload))
                except Exception as exc:  # noqa: BLE001 — untrusted
                    logger.warning("client %s: bad message from %s: %s",
                                   self.name, node_name, exc)
                    continue
                handled += 1
                if self.on_message is not None:
                    self.on_message(node_name, msg)
        return handled

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for sock in self._remotes.values():
            sock.close(0)
        self._ctx.term()
