"""Fault primitives and seeded fault plans for the chaos plane.

RBFT's claim (Aublin et al., ICDCS 2013) is safety + liveness under up to
``f`` Byzantine replicas; exercising that claim needs *generated* fault
scenarios, not one-off hand-written adversaries. A :class:`FaultPlan` is a
list of :class:`Fault` primitives with virtual-time start offsets and
durations — crash/restart, partition/heal, probabilistic message drop,
delay, duplication, reorder, clock skew, and composable Byzantine
strategies (equivocation, silence) — compiled by the
:class:`~indy_plenum_tpu_torch.chaos.scheduler.FaultScheduler` into
:class:`~indy_plenum_tpu_torch.simulation.mock_timer.MockTimer` events driving a
:class:`~indy_plenum_tpu_torch.simulation.sim_network.SimNetwork` pool. All
randomness flows from ONE ``random.Random(seed)``, so a plan replays
bit-for-bit from its seed.

Copy of ``indy_plenum_tpu/chaos/faults.py``, with its imports bound to
the port.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field, fields
from typing import Any, Callable, Dict, FrozenSet, List, Optional, Tuple

# message-type filters are stored as class NAMES (plans must be
# JSON-serializable for the replayable report); resolved lazily against
# the node message namespace
from ..common.messages import node_messages as _node_messages

Undo = Optional[Callable[[], None]]


def resolve_message_types(names) -> Tuple[type, ...]:
    return tuple(getattr(_node_messages, name) for name in names)


@dataclass
class FaultContext:
    """Everything a fault may touch when it begins/ends."""

    pool: Any  # SimPool or NodePool (duck-typed: .node(), .network, ...)
    network: Any  # SimNetwork
    timer: Any  # MockTimer
    rng: random.Random  # THE plan rng — every draw is seed-deterministic
    trace: Callable[[str], None]


@dataclass
class Fault:
    """Base fault: active on [at, at + duration) of virtual time.

    ``duration=None`` means permanent (never reverted). Subclasses return
    an undo callable from :meth:`begin`; the scheduler invokes it at the
    fault's end time.
    """

    at: float = 0.0
    duration: Optional[float] = None

    def begin(self, ctx: FaultContext) -> Undo:
        raise NotImplementedError

    @property
    def byzantine_nodes(self) -> FrozenSet[str]:
        """Nodes this fault makes actively malicious (excluded from the
        honest-agreement checks)."""
        return frozenset()

    @property
    def crashed_nodes(self) -> FrozenSet[str]:
        """Nodes this fault fail-stops (excluded from liveness if never
        restarted)."""
        return frozenset()

    def describe(self) -> str:
        return self.as_dict()["kind"] + " " + ", ".join(
            f"{k}={v}" for k, v in sorted(self.as_dict().items())
            if k != "kind")

    @staticmethod
    def _jsonable(v):
        if isinstance(v, frozenset):
            return sorted(v)
        if isinstance(v, (tuple, list)):
            return [Fault._jsonable(x) for x in v]
        return v

    def as_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"kind": type(self).__name__}
        for f in fields(self):
            # deep list conversion so a saved report JSON-round-trips
            # equal to as_dict() (PartitionFault.groups nests tuples)
            out[f.name] = self._jsonable(getattr(self, f.name))
        return out


def _match(types: Tuple[type, ...], frm: Optional[str], to: Optional[str],
           msg, sender: str, dest: str) -> bool:
    if types and not isinstance(msg, types):
        return False
    if frm is not None and sender != frm:
        return False
    if to is not None and dest != to:
        return False
    return True


@dataclass
class LinkFault(Fault):
    """Shared shape for delayer-based faults: an optional message-type /
    endpoint filter. ``types`` holds node-message CLASS NAMES."""

    types: Tuple[str, ...] = ()
    frm: Optional[str] = None
    to: Optional[str] = None

    def _delayer(self, ctx: FaultContext) -> Callable:
        raise NotImplementedError

    def begin(self, ctx: FaultContext) -> Undo:
        return ctx.network.add_delayer(self._delayer(ctx))


@dataclass
class CrashFault(Fault):
    """Fail-stop: the node drops off the network (both directions); with a
    duration it restarts (reconnects) and must re-join ordering."""

    node: str = ""

    def begin(self, ctx: FaultContext) -> Undo:
        ctx.network.disconnect(self.node)
        if self.duration is None:
            return None
        return lambda: ctx.network.reconnect(self.node)

    @property
    def crashed_nodes(self) -> FrozenSet[str]:
        return frozenset({self.node})


@dataclass
class PartitionFault(Fault):
    """Split the pool into isolated groups; cross-group messages drop.
    Nodes named in no group are isolated singletons. Healing (the undo)
    removes the cut."""

    groups: Tuple[Tuple[str, ...], ...] = ()

    def begin(self, ctx: FaultContext) -> Undo:
        side = {name: i for i, grp in enumerate(self.groups) for name in grp}

        def cut(msg, sender, dest):
            if side.get(sender, -1) != side.get(dest, -2):
                return float("inf")
            return None

        return ctx.network.add_delayer(cut)


@dataclass
class DropFault(LinkFault):
    """Drop matched messages with seeded probability (1.0 = a hard cut)."""

    probability: float = 1.0

    def _delayer(self, ctx: FaultContext):
        types = resolve_message_types(self.types)

        def drop(msg, sender, dest):
            if not _match(types, self.frm, self.to, msg, sender, dest):
                return None
            if self.probability >= 1.0 or ctx.rng.random() < self.probability:
                return float("inf")
            return None

        return drop


@dataclass
class DelayFault(LinkFault):
    """Add fixed extra latency to matched messages (slow link / slow node)."""

    seconds: float = 1.0

    def _delayer(self, ctx: FaultContext):
        types = resolve_message_types(self.types)

        def slow(msg, sender, dest):
            if _match(types, self.frm, self.to, msg, sender, dest):
                return self.seconds
            return None

        return slow


@dataclass
class ReorderFault(LinkFault):
    """Seeded per-message jitter far above the base link latency, so
    delivery order scrambles relative to send order."""

    jitter: float = 0.5

    def _delayer(self, ctx: FaultContext):
        types = resolve_message_types(self.types)

        def scramble(msg, sender, dest):
            if _match(types, self.frm, self.to, msg, sender, dest):
                return ctx.rng.uniform(0.0, self.jitter)
            return None

        return scramble


@dataclass
class DuplicateFault(LinkFault):
    """Deliver matched messages ``copies`` times, ``gap`` seconds apart —
    the at-least-once transport every vote path must tolerate."""

    copies: int = 2
    gap: float = 0.05

    def _delayer(self, ctx: FaultContext):
        types = resolve_message_types(self.types)
        offsets = tuple(i * self.gap for i in range(self.copies))

        def dup(msg, sender, dest):
            if _match(types, self.frm, self.to, msg, sender, dest):
                return offsets
            return None

        return dup


@dataclass
class ClockSkewFault(Fault):
    """Model a node whose local clock lags by ``skew`` seconds: everything
    it RECEIVES lands ``skew`` late (its pipeline runs behind the pool),
    and its own sends leave on time. One shared MockTimer drives the whole
    simulation, so skew is expressed at the delivery boundary."""

    node: str = ""
    skew: float = 1.0

    def begin(self, ctx: FaultContext) -> Undo:
        def lag(msg, sender, dest):
            return self.skew if dest == self.node else None

        return ctx.network.add_delayer(lag)


@dataclass
class SilenceFault(LinkFault):
    """Byzantine silence: the node stays connected (so crash detection
    does NOT fire) but drops its outbound matched messages."""

    node: str = ""

    def _delayer(self, ctx: FaultContext):
        types = resolve_message_types(self.types)

        def mute(msg, sender, dest):
            # the silenced node IS the frm filter; to narrows further
            if _match(types, self.node, self.to, msg, sender, dest):
                return float("inf")
            return None

        return mute

    @property
    def byzantine_nodes(self) -> FrozenSet[str]:
        return frozenset({self.node})


@dataclass
class EquivocateFault(Fault):
    """Byzantine equivocation: the node's outbound PRE-PREPAREs carry a
    per-recipient forged digest for roughly half the pool, trying to split
    the prepare quorum (the classic split-brain attack the digest-filtered
    vote collection must defeat)."""

    node: str = ""

    def begin(self, ctx: FaultContext) -> Undo:
        import hashlib

        PrePrepare = _node_messages.PrePrepare
        bus = ctx.pool.node(self.node).external_bus
        original = bus._send_handler
        peers = sorted(set(ctx.pool.validators) - {self.node})
        forked = set(peers[len(peers) // 2:])

        def equivocate(msg, dst=None):
            if not isinstance(msg, PrePrepare):
                return original(msg, dst)
            if dst is None:
                targets = list(peers)
            elif isinstance(dst, str):
                targets = [dst]
            else:
                targets = list(dst)
            for to in targets:
                out = msg
                if to in forked:
                    forged = msg._fields
                    forged["digest"] = hashlib.sha256(
                        (msg.digest + to).encode()).hexdigest()
                    out = PrePrepare(**forged)
                ctx.network._deliver_later(out, self.node, to)

        bus._send_handler = equivocate

        def undo():
            bus._send_handler = original

        return undo

    @property
    def byzantine_nodes(self) -> FrozenSet[str]:
        return frozenset({self.node})


@dataclass
class CorruptCatchupRepFault(Fault):
    """Byzantine seeder: every ``CATCHUP_REP`` the node serves carries
    silently-corrupted txn payloads (the audit paths still reference the
    honest tree, so the leecher's batched proof verification MUST reject
    the whole slice, raise CATCHUP_REP_WRONG suspicion, and re-request
    from an honest seeder — corrupted history must never apply). The node
    stays honest in 3PC; only its catchup answers lie."""

    node: str = ""

    def begin(self, ctx: FaultContext) -> Undo:
        CatchupRep = _node_messages.CatchupRep
        bus = ctx.pool.node(self.node).external_bus
        original = bus._send_handler

        def corrupt(msg, dst=None):
            if not isinstance(msg, CatchupRep):
                return original(msg, dst)
            forged = msg._fields
            forged["txns"] = {
                seq: {**txn, "evil": "corrupted-by-" + self.node}
                if isinstance(txn, dict) else txn
                for seq, txn in dict(msg.txns).items()}
            ctx.trace(f"{self.node} corrupting CATCHUP_REP "
                      f"({len(forged['txns'])} txns, ledger "
                      f"{msg.ledgerId})")
            return original(CatchupRep(**forged), dst)

        bus._send_handler = corrupt

        def undo():
            bus._send_handler = original

        return undo

    @property
    def byzantine_nodes(self) -> FrozenSet[str]:
        return frozenset({self.node})


@dataclass
class CorruptOrderedLogFault(Fault):
    """Deliberately-broken adversary: silently rewrite the victim's LAST
    executed batch digest, modelling an undetected ordering/execution bug
    on an otherwise honest replica. The node is NOT marked byzantine —
    the agreement invariant MUST catch this, proving the checker is not
    vacuous."""

    node: str = ""

    def begin(self, ctx: FaultContext) -> Undo:
        node = ctx.pool.node(self.node)
        if not node.ordered_log:
            ctx.trace(f"corruption no-op: {self.node} has ordered nothing")
            return None
        entry = node.ordered_log[-1]
        forged = entry._fields
        forged["digest"] = "corrupted:" + (entry.digest or "")
        forged["reqIdr"] = ["corrupted:" + d for d in entry.reqIdr]
        node.ordered_log[-1] = type(entry)(**forged)
        ctx.trace(f"corrupted {self.node} ordered batch "
                  f"seq={entry.ppSeqNo}")
        return None


@dataclass
class FaultPlan:
    """A seed plus an ordered list of faults — the full, serializable
    description of one chaos run's adversary."""

    seed: int
    faults: List[Fault] = field(default_factory=list)

    @property
    def byzantine_nodes(self) -> FrozenSet[str]:
        out: FrozenSet[str] = frozenset()
        for fault in self.faults:
            out |= fault.byzantine_nodes
        return out

    @property
    def crashed_forever_nodes(self) -> FrozenSet[str]:
        """Crashed with no restart: alive for safety checks on what they
        ordered BEFORE dying, but exempt from liveness."""
        out: FrozenSet[str] = frozenset()
        for fault in self.faults:
            if fault.crashed_nodes and fault.duration is None:
                out |= fault.crashed_nodes
        return out

    @property
    def restarted_nodes(self) -> FrozenSet[str]:
        """Crashed WITH a restart: the nodes a catchup scenario expects
        to detect their gap, leech it back, and rejoin ordering."""
        out: FrozenSet[str] = frozenset()
        for fault in self.faults:
            if fault.crashed_nodes and fault.duration is not None:
                out |= fault.crashed_nodes
        return out

    @property
    def end_time(self) -> float:
        """Offset at which the last bounded fault has been reverted."""
        end = 0.0
        for fault in self.faults:
            end = max(end, fault.at + (fault.duration or 0.0))
        return end

    def as_dicts(self) -> List[Dict[str, Any]]:
        return [fault.as_dict() for fault in self.faults]
