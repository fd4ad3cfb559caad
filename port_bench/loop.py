"""The system under test and the benchmark's own clients.

The pool is ``indy_plenum_tpu_torch.simulation.node_pool.NodePool``: real
validator ``Node``s on one seeded simulated network and one virtual
clock, every node's device work on the card. The clients live here: a
closed loop of ``clients`` x ``outstanding`` slots, each holding one
signed NYM write (sent to every node through
``Node.submit_client_request``, done at f+1 matching replies or f+1
rejections) or one proved read (queued on node ``client mod n``'s
``read_service``, done when a drain serves it). A freed slot is refilled
at once. The mix's read share is exact: every ``MIX_BLOCK`` requests hold
``round(MIX_BLOCK * read_fraction)`` reads, at places the seed draws, so
every seed sends the same work in another order. The network's delivery delay is virtual, so every wall second
the loop spends is processor time.
"""
from __future__ import annotations

import math
import time
from collections import deque
from typing import Dict, List, Optional

from .generator import Draws
from .reference.b58 import b58encode

NYM = "1"  # indy's NYM txn type
MIX_BLOCK = 100  # requests a block of the mix's exact read share


class Signer:
    """The client's Ed25519 key (OpenSSL, through ``cryptography``).
    Signing is the client's work, done in set-up."""

    def __init__(self, seed: bytes):
        from cryptography.hazmat.primitives.asymmetric.ed25519 import (
            Ed25519PrivateKey,
        )
        from cryptography.hazmat.primitives.serialization import (
            Encoding,
            PublicFormat,
        )

        key = Ed25519PrivateKey.from_private_bytes(seed)
        self.sign = key.sign
        self.verkey_raw = key.public_key().public_bytes(Encoding.Raw,
                                                        PublicFormat.Raw)
        self.identifier = b58encode(self.verkey_raw[:16])


class Write:
    __slots__ = ("req", "payload", "signature", "corrupt", "slot", "t_sent",
                 "t_done", "outcome", "quorum", "replies", "nacks", "acks")

    def __init__(self, req, payload, signature, corrupt):
        self.req = req
        self.payload = payload
        self.signature = signature
        self.corrupt = corrupt
        self.slot = None
        self.t_sent = self.t_done = None
        self.outcome: Optional[str] = None  # "acked" | "rejected"
        self.quorum = None  # the reply fingerprint f+1 nodes agree on
        self.replies: Dict[str, tuple] = {}
        self.nacks: Dict[str, str] = {}
        self.acks = 0


class Read:
    __slots__ = ("slot", "node", "index", "t_sent", "t_done", "served")

    def __init__(self, slot, node, index, t_sent):
        self.slot, self.node, self.index = slot, node, index
        self.t_sent, self.t_done, self.served = t_sent, None, None


def make_writes(count: int, draws: Draws, signer: Signer, first_req_id: int,
                corrupt_every: int = 0) -> List[Write]:
    """``count`` signed NYM creates of fresh DIDs (a DID and an
    abbreviated verkey from 16 seeded bytes each), unique ``reqId``s; with
    ``corrupt_every`` = k, one write in k (at a seeded offset) carries a
    signature with one bit of S flipped."""
    from indy_plenum_tpu_torch.common.request import Request

    offset = draws.integer(corrupt_every) if corrupt_every else 0
    out = []
    for i in range(count):
        op = {"type": NYM, "dest": b58encode(draws.bytes(16)),
              "verkey": "~" + b58encode(draws.bytes(16))}
        req = Request(identifier=signer.identifier,
                      reqId=first_req_id + i, operation=op)
        sig = signer.sign(req.signing_bytes())
        corrupt = bool(corrupt_every) and (i + offset) % corrupt_every == 0
        if corrupt:
            sig = sig[:40] + bytes([sig[40] ^ 0x01]) + sig[41:]
        req.signature = b58encode(sig)
        payload = {"identifier": req.identifier, "reqId": req.reqId,
                   "operation": dict(op),
                   "protocolVersion": req.protocolVersion}
        out.append(Write(req, payload, req.signature, corrupt))
    return out


def build_pool(config: dict, seed: int, device):
    from indy_plenum_tpu_torch.config import getConfig
    from indy_plenum_tpu_torch.simulation.node_pool import NodePool

    return NodePool(config["nodes"], seed=seed,
                    config=getConfig(config["config"]),
                    device_quorum=config["device_quorum"],
                    bls=config["bls"], num_instances=config["instances"],
                    with_pool_genesis=config["with_pool_genesis"],
                    device=device)


def _fingerprint(result: dict) -> tuple:
    md = result.get("txnMetadata") or {}
    txn_md = (result.get("txn") or {}).get("metadata") or {}
    return (md.get("seqNo"), md.get("txnTime"), result.get("txnRootHash"),
            result.get("stateRootHash"), txn_md.get("digest"))


class ClosedLoop:
    """The clients of one mix. ``writes`` are the pre-signed writes the
    window may send; running out of them raises: the window never signs."""

    def __init__(self, pool, mix: dict, draws: Draws, writes: List[Write],
                 span=None):
        self.pool = pool
        self.nodes = pool.nodes
        self.f = (len(self.nodes) - 1) // 3
        self.mix = mix
        self.draws = draws
        self._writes = iter(writes)
        self.by_req: Dict[int, Write] = {w.req.reqId: w for w in writes}
        self.sent: List[Write] = []
        self.reads: List[Read] = []
        self._fifo = [deque() for _ in self.nodes]
        self._freed: List[int] = []
        self.read_space = 0
        self._kinds: List[bool] = []  # the current block's rest, read or not
        self.refill = True
        self._span = span

    @property
    def slots(self) -> int:
        return self.mix["clients"] * self.mix["outstanding"]

    # --- sending -------------------------------------------------------

    def _send_write(self, slot: int, now: float) -> None:
        w = next(self._writes, None)
        if w is None:
            raise RuntimeError("the pre-signed writes ran out: raise "
                               "max_writes_per_s in the traffic file")
        w.slot, w.t_sent = slot, now
        cid = "c%d" % (slot // self.mix["outstanding"])
        self.sent.append(w)
        for node in self.nodes:
            node.submit_client_request(w.req, cid)

    def _send_read(self, slot: int, now: float) -> None:
        client = slot // self.mix["outstanding"]
        k = client % len(self.nodes)
        idx = self.draws.zipf_bounded(self.mix["zipf_theta"],
                                      self.read_space)
        r = Read(slot, k, idx, now)
        self.nodes[k].read_service.submit(idx)
        self._fifo[k].append(r)
        self.reads.append(r)

    def _next_is_read(self) -> bool:
        if not self._kinds:
            reads = round(MIX_BLOCK * self.mix.get("read_fraction", 0.0))
            self._kinds = [i < reads
                           for i in self.draws.permutation(MIX_BLOCK)]
        return self._kinds.pop()

    def _fill(self, slots, now: float) -> None:
        for slot in slots:
            if self._next_is_read():
                self._send_read(slot, now)
            else:
                self._send_write(slot, now)

    def start(self, now: float) -> None:
        self._fill(range(self.slots), now)

    # --- receiving -----------------------------------------------------

    def pump(self, now: float) -> None:
        """Take every node's client messages; settle writes."""
        need = self.f + 1
        for node in self.nodes:
            box = node.client_outbox
            if not box:
                continue
            node.client_outbox = []
            for _cid, msg in box:
                kind = msg.typename
                if kind == "REPLY":
                    w = self.by_req.get(msg.result.get("reqId"))
                    if w is None:
                        continue
                    fp = _fingerprint(msg.result)
                    w.replies[node.name] = fp
                    if w.outcome is None and sum(
                            1 for v in w.replies.values() if v == fp) >= need:
                        w.outcome, w.quorum, w.t_done = "acked", fp, now
                        self._freed.append(w.slot)
                elif kind == "REQNACK":
                    w = self.by_req.get(msg.reqId)
                    if w is None:
                        continue
                    w.nacks[node.name] = msg.reason
                    if w.outcome is None and len(w.nacks) >= need:
                        w.outcome, w.t_done = "rejected", now
                        self._freed.append(w.slot)
                elif kind == "REQACK":
                    w = self.by_req.get(msg.reqId)
                    if w is not None:
                        w.acks += 1

    def drain_reads(self, now: float) -> None:
        for k, fifo in enumerate(self._fifo):
            if not fifo:
                continue
            for served in self.nodes[k].read_service.drain():
                r = fifo.popleft()
                r.served, r.t_done = served, now
                self._freed.append(r.slot)

    def iterate(self, step_s: float) -> None:
        """One virtual step of the pool, then the clients' turn."""
        span = self._span
        with span("pool.step"):
            self.pool.run_for(step_s)
        now = time.perf_counter()
        with span("client.pump"):
            if self.read_space:
                self.drain_reads(now)
            self.pump(now)
        if self.refill and self._freed:
            freed, self._freed = self._freed, []
            with span("client.send"):
                self._fill(freed, now)
        elif not self.refill:
            self._freed = []

    def outstanding(self) -> int:
        return (sum(1 for w in self.sent if w.outcome is None)
                + sum(len(f) for f in self._fifo))


def presign_count(mix: dict, seconds: float) -> int:
    return int(math.ceil(mix["max_writes_per_s"] * seconds)) \
        + mix["clients"] * mix["outstanding"]


def settle(loop: ClosedLoop, step_s: float, wall_cap_s: float,
           done) -> bool:
    """Step the pool without new work until ``done()`` or the wall cap."""
    loop.refill = False
    t_cap = time.perf_counter() + wall_cap_s
    while not done():
        if time.perf_counter() > t_cap:
            return False
        loop.iterate(step_s)
    return True
