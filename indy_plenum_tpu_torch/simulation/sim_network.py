"""Deterministic in-memory network for multi-node simulation.

Reference: plenum/test/simulation/ (sim_network, sim_random) and the
delayer mechanism of plenum/test/delayers.py. Messages between nodes are
delivered through the shared :class:`MockTimer` with configurable
(seeded-random or fixed) latency; *delayers* are predicates that can hold
back, drop or fan out specific message types from specific senders — the
fault-injection surface the chaos plane
(:mod:`indy_plenum_tpu_torch.chaos`) compiles :class:`FaultPlan` primitives
onto (partitions, slow links, duplication, reorder, byzantine silence).

Copy of ``indy_plenum_tpu/simulation/sim_network.py``, with its imports
bound to the port.
"""
from __future__ import annotations

import random
from collections import Counter
from typing import Any, Callable, Dict, Optional, Sequence, Union

from ..common.event_bus import ExternalBus
from ..common.metrics_collector import MetricsCollector, MetricsName
from ..observability.causal import NET_TRACED_OPS, net_join_key
from .mock_timer import MockTimer

# a delayer: (msg, frm, to) -> None | float | sequence of floats.
# None = no opinion; float = extra delay seconds; float('inf') = drop;
# a sequence = deliver ONE COPY PER ENTRY offset by that many seconds
# (duplication — the at-least-once transport chaos scenarios exercise).
Delayer = Callable[[Any, str, str],
                   Union[None, float, Sequence[float]]]


def delay_message_types(*types, frm: Optional[str] = None,
                        to: Optional[str] = None,
                        seconds: float = float("inf")) -> Delayer:
    """Classic delayer (reference: ppDelay/pDelay/cDelay/icDelay...)."""

    def delayer(msg, sender, dest):
        if types and not isinstance(msg, types):
            return None
        if frm is not None and sender != frm:
            return None
        if to is not None and dest != to:
            return None
        return seconds

    return delayer


class RegionLatencyMatrix:
    """Seeded inter-region latency bands — the geo plane's WAN matrix.

    Every unordered cross-region pair gets a deterministic ``(lo, hi)``
    uniform band inside the WAN envelope: ``lo`` draws from the lower
    half of the envelope and ``hi`` from the upper half, so ``lo < hi``
    by construction and two matrices built from the same seed are
    identical. Intra-region pairs (and peers with no region assignment)
    keep the network's fast band — the matrix only REPLACES the band
    bounds fed to the one per-delivery latency draw, so region mode
    consumes exactly the same rng sequence length as single-region runs.
    """

    def __init__(self, n_regions: int, seed: int,
                 intra_band: tuple, wan_band: tuple):
        self.n_regions = n_regions
        self.intra_band = (float(intra_band[0]), float(intra_band[1]))
        self.wan_band = (float(wan_band[0]), float(wan_band[1]))
        rng = random.Random(seed)
        lo_env, hi_env = self.wan_band
        mid = (lo_env + hi_env) / 2.0
        self._bands: Dict[tuple, tuple] = {}
        for a in range(n_regions):
            for b in range(a + 1, n_regions):
                self._bands[(a, b)] = (rng.uniform(lo_env, mid),
                                       rng.uniform(mid, hi_env))

    def band(self, a: Optional[int], b: Optional[int]) -> tuple:
        """The (lo, hi) latency band for a delivery between regions
        ``a`` and ``b`` (either may be None = unassigned = local)."""
        if a is None or b is None or a == b:
            return self.intra_band
        key = (a, b) if a < b else (b, a)
        return self._bands[key]

    def as_dict(self) -> Dict[str, list]:
        """The pair bands as a JSON-able record (bench/gate reports)."""
        return {"%d-%d" % (a, b): [round(lo, 6), round(hi, 6)]
                for (a, b), (lo, hi) in sorted(self._bands.items())}


class SimNetwork:
    def __init__(self, timer: MockTimer, seed: int = 0,
                 min_latency: float = 0.01, max_latency: float = 0.05,
                 metrics: Optional[MetricsCollector] = None,
                 trace=None, trace_receivers: int = 0,
                 regions: Optional[Dict[str, int]] = None,
                 region_matrix: Optional[RegionLatencyMatrix] = None):
        self._timer = timer
        self._rng = random.Random(seed)
        self._min_latency = min_latency
        self._max_latency = max_latency
        # geo plane: per-peer region assignment + the pair-band matrix.
        # Both default off — the default path draws from the single
        # (min, max) band exactly as before, bit-identical per seed.
        self._regions: Dict[str, int] = dict(regions) if regions else {}
        self._region_matrix = region_matrix
        self.cross_region = 0
        self._peers: Dict[str, ExternalBus] = {}
        self._peer_order: list[str] = []
        self._delayers: list[Delayer] = []
        self._metrics = metrics
        # causal tracing plane: when a recorder is attached, every
        # delivery of a journey-joinable message type (PROPAGATE / 3PC
        # waves / catchup slices) stamps virtual-clock ``net.send`` /
        # ``net.recv`` marks — the delayer-added latency is measured,
        # not modeled, because the recv mark fires at the actual
        # delivery instant. ``trace_receivers`` caps the stamped
        # fan-out to deliveries INTO the first K peers (0 = all): at
        # n=64 the 3PC waves are O(n^2) messages per batch and a
        # sampled receiver set keeps the ring representative without
        # drowning it.
        from ..observability.trace import NULL_TRACE

        self._trace = trace if trace is not None else NULL_TRACE
        self._trace_receivers = trace_receivers
        self._net_seq = 0
        self.dropped = 0
        self.sent = 0
        self.duplicated = 0
        # per-message-type delivery accounting (chaos reports: which
        # traffic a fault plan actually cut)
        self.sent_by_type: Counter = Counter()
        self.dropped_by_type: Counter = Counter()

    # --- wiring ---------------------------------------------------------

    def create_peer(self, name: str) -> ExternalBus:
        bus = ExternalBus(self._make_send_handler(name))
        self._peers[name] = bus
        self._peer_order.append(name)
        return bus

    def connect_all(self) -> None:
        for name, bus in self._peers.items():
            bus.update_connecteds(set(self._peers) - {name})

    def disconnect(self, name: str) -> None:
        """Simulate a node dropping off the network."""
        for peer, bus in self._peers.items():
            if peer != name:
                bus.update_connecteds(bus.connecteds - {name})
        self._peers[name].update_connecteds(set())

    def reconnect(self, name: str) -> None:
        for peer, bus in self._peers.items():
            if peer != name:
                bus.update_connecteds(bus.connecteds | {name})
        self._peers[name].update_connecteds(set(self._peers) - {name})

    def add_delayer(self, delayer: Delayer) -> Callable[[], None]:
        self._delayers.append(delayer)
        return lambda: self._delayers.remove(delayer)

    def reset_delays(self) -> None:
        self._delayers.clear()

    def region_of(self, name: str) -> Optional[int]:
        return self._regions.get(name)

    def assign_region(self, name: str, region: int) -> None:
        """Place a peer (or a client endpoint) in a region after
        construction — the geo fabric registers client homes here."""
        self._regions[name] = region

    def counters(self) -> Dict[str, Any]:
        """Delivery accounting snapshot (chaos report / diagnostics)."""
        out = {"sent": self.sent, "dropped": self.dropped,
               "duplicated": self.duplicated,
               "sent_by_type": dict(self.sent_by_type),
               "dropped_by_type": dict(self.dropped_by_type)}
        if self._region_matrix is not None:
            # absent entirely on single-region runs: pre-geo network
            # blocks stay byte-compatible
            out["cross_region"] = self.cross_region
        return out

    # --- delivery -------------------------------------------------------

    def _make_send_handler(self, frm: str):
        def send(msg, dst=None):
            if dst is None:
                targets = sorted(set(self._peers) - {frm})
            elif isinstance(dst, str):
                targets = [dst]
            else:
                targets = list(dst)
            for to in targets:
                self._deliver_later(msg, frm, to)

        return send

    def _count_drop(self, msg, frm: str = "", to: str = "") -> None:
        self.dropped += 1
        self.dropped_by_type[type(msg).__name__] += 1
        if self._metrics is not None:
            self._metrics.add_event(MetricsName.SIM_NET_DROPPED)
        if self._trace.enabled:
            key = self._net_key(msg, to)
            if key is not None:
                self._trace.record(
                    "net.drop", cat="net", node=to, key=key,
                    args={"m": getattr(type(msg), "typename",
                                       type(msg).__name__),
                          "frm": frm})

    def _net_key(self, msg, to: str) -> Optional[tuple]:
        """Journey-join key for a traced delivery, or None when this
        delivery is not stamped (untraced type, backup instance, or a
        receiver outside the sampled set)."""
        op = getattr(type(msg), "typename", type(msg).__name__)
        if op not in NET_TRACED_OPS:
            return None
        cap = self._trace_receivers
        if cap > 0 and to not in self._peer_order[:cap]:
            return None
        return net_join_key(op, lambda f: getattr(msg, f, None))

    def _deliver_later(self, msg, frm: str, to: str) -> None:
        if to not in self._peers:
            return
        # link must be up (receiver sees sender as connected)
        if not self._peers[to].is_connected(frm):
            self._count_drop(msg, frm, to)
            return
        # ONE latency draw per delivery, region mode or not: the geo
        # matrix only swaps the band bounds, so single-region runs keep
        # their exact historical rng sequence
        lo, hi = self._min_latency, self._max_latency
        is_wan = False
        if self._region_matrix is not None:
            band = self._region_matrix.band(self._regions.get(frm),
                                            self._regions.get(to))
            is_wan = band is not self._region_matrix.intra_band
            lo, hi = band
        latency = self._rng.uniform(lo, hi)
        offsets = [0.0]  # one entry per copy that will be delivered
        for delayer in list(self._delayers):
            extra = delayer(msg, frm, to)
            if extra is None:
                continue
            if isinstance(extra, (tuple, list)):
                offsets = [o + e for o in offsets for e in extra]
                continue
            if extra == float("inf"):
                self._count_drop(msg, frm, to)
                return
            offsets = [o + extra for o in offsets]
        self.sent += len(offsets)
        self.duplicated += len(offsets) - 1
        if is_wan:
            self.cross_region += len(offsets)
        self.sent_by_type[type(msg).__name__] += len(offsets)
        if self._metrics is not None:
            self._metrics.add_event(MetricsName.SIM_NET_DELIVERED,
                                    len(offsets))
        bus = self._peers[to]
        trace_key = (self._net_key(msg, to) if self._trace.enabled
                     else None)
        op = getattr(type(msg), "typename", type(msg).__name__) \
            if trace_key is not None else None
        for off in offsets:
            if trace_key is not None:
                # one send/recv mark pair PER COPY (duplication chaos
                # delivers each copy at its own instant); the recv mark
                # fires inside the scheduled delivery so delayer-added
                # latency lands in the measured gap
                self._net_seq += 1
                nid = self._net_seq
                self._trace.record(
                    "net.send", cat="net", node=frm, key=trace_key,
                    args={"m": op, "to": to, "id": nid})
                self._timer.schedule(
                    latency + off,
                    lambda m=msg, f=frm, b=bus, k=trace_key, i=nid,
                    o=op, t=to: self._traced_delivery(m, f, b, k, i,
                                                      o, t))
            else:
                self._timer.schedule(
                    latency + off,
                    lambda m=msg, f=frm, b=bus: b.process_incoming(m, f))

    def _traced_delivery(self, msg, frm, bus, key, nid, op, to) -> None:
        self._trace.record("net.recv", cat="net", node=to, key=key,
                           args={"m": op, "frm": frm, "id": nid})
        bus.process_incoming(msg, frm)
