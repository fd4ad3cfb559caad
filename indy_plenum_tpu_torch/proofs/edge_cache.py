"""Edge proof-serving tier: region-local UNTRUSTED replicas of sealed
window proofs.

The state-proof plane (``checkpoint_cache`` + ``client.state_proof``)
makes a read reply self-certifying: audit path + the pool's BLS
multi-signature over the window root verify offline with nothing but
the pool's keys. That property is exactly what makes an edge-CDN tier
sound — a cache that needs ZERO trust, because verification (not the
server) is the security boundary. This module is that tier:

- :class:`EdgeProofCache` — a region-local replica of the last sealed
  window's proof-attached replies, fed by ``replicate()`` snapshots of
  an origin :class:`~indy_plenum_tpu_torch.ingress.read_service.ReadService`
  drain and miss-filled by ``store()``. Bounded two ways: newest
  ``EdgeProofCacheKeepWindows`` windows (invalidation rides the SAME
  ``CheckpointStabilized`` bus hook ``LedgerBacking`` and
  ``CheckpointProofCache`` use — a seal retires the oldest held window
  to make room for the incoming one) and ``EdgeProofCacheMaxEntries``
  entries LRU across windows. The serve path is dict lookups only —
  zero pairings, zero hashing (asserted by the budget script's geo
  gate). ``poison()`` arms the byzantine-edge mode: served replies are
  deterministically tampered (leaf flip / root flip / signature
  corruption), which clients MUST catch by verification — the
  cache-poisoning chaos arc's subject.

- :class:`GeoReadFabric` — the client half: routes each client's reads
  to its home-region edge, verifies EVERY edge reply offline (one full
  :func:`~indy_plenum_tpu_torch.client.state_proof.verify_proved_read` per
  distinct signed window amortizes the pairing; further replies pay
  only the pairing-free
  :func:`~indy_plenum_tpu_torch.client.state_proof.verify_read_binding`),
  enforces the ``EdgeProofCacheMaxAge`` freshness bound, and falls
  back to the origin validator over the WAN on miss / stale /
  verification failure (miss-filling the edge on the way back).
  Latency is MODELED per read from the pool's
  :class:`~indy_plenum_tpu_torch.simulation.sim_network.RegionLatencyMatrix`
  bands using a DEDICATED seeded RNG — the pool's delivery RNG is
  never touched, so arming the fabric cannot move ``ordered_hash`` or
  any other fingerprint.

Copy of ``indy_plenum_tpu/proofs/edge_cache.py``, with its imports bound
to the port. The edge tier is host code; the origin it falls back to is a
``ReadService`` that verifies on its own device (K10 on the card in
``mode="device"``), and the client-side checks are the port's
``client/state_proof`` with its native BN254 pairings.
"""
from __future__ import annotations

import random
from collections import OrderedDict
from dataclasses import replace
from typing import Callable, Dict, List, Optional, Tuple


class EdgeProofCache:
    """An untrusted, bounded, region-local replica of proof-attached
    read replies. Holds per sealed window a ``{folded index -> reply}``
    map; :meth:`get` serves from the NEWEST held window containing the
    index. Nothing here is a trust anchor — a byzantine edge (see
    :meth:`poison`) can serve garbage, and the client catches 100% of
    it by offline verification."""

    def __init__(self, region: int,
                 keep_windows: Optional[int] = None,
                 max_entries: Optional[int] = None,
                 config=None, bus=None,
                 clock: Optional[Callable[[], float]] = None,
                 name: str = ""):
        if keep_windows is None or max_entries is None:
            if config is None:
                from ..config import getConfig

                config = getConfig()
            if keep_windows is None:
                keep_windows = config.EdgeProofCacheKeepWindows
            if max_entries is None:
                max_entries = config.EdgeProofCacheMaxEntries
        if keep_windows <= 0:
            raise ValueError(f"keep_windows must be positive: "
                             f"{keep_windows}")
        if max_entries <= 0:
            raise ValueError(f"max_entries must be positive: "
                             f"{max_entries}")
        self.region = int(region)
        self.keep_windows = int(keep_windows)
        self.max_entries = int(max_entries)
        self.name = name or ("edge-r%d" % self.region)
        self._clock = clock if clock is not None else (lambda: 0.0)
        # window -> {"replies": {idx: ProofRead}, "tree_size", ...};
        # insertion-ordered oldest-first (window GC pops the front)
        self._windows: "OrderedDict[Tuple[int, int], dict]" = OrderedDict()
        # entry LRU across ALL windows: (window, idx) touch order
        self._lru: "OrderedDict[Tuple, None]" = OrderedDict()
        self._queue: List[int] = []
        self.replicated_total = 0
        self.stored_total = 0
        self.hits = 0
        self.misses = 0
        self.invalidations = 0
        self.windows_evicted = 0
        self.entries_evicted = 0
        self.tampered_total = 0
        self._poison_rng: Optional[random.Random] = None
        if bus is not None:
            from ..common.messages.internal_messages import (
                CheckpointStabilized,
            )

            bus.subscribe(CheckpointStabilized,
                          self._on_checkpoint_stabilized)

    # --- feeding --------------------------------------------------------

    def replicate(self, window, replies) -> int:
        """Bulk-load one sealed window's proof-attached replies (an
        origin drain's output). Replies from OTHER windows are skipped —
        a replication batch must not smear roots across windows. Returns
        the number of entries stored."""
        if window is None:
            return 0
        window = tuple(window)
        bucket = self._bucket(window)
        stored = 0
        for reply in replies:
            if reply is None or reply.window is None \
                    or tuple(reply.window) != window:
                continue
            bucket["tree_size"] = reply.tree_size
            self._insert(window, bucket, reply)
            stored += 1
        self.replicated_total += stored
        self._gc_windows()
        return stored

    def store(self, reply) -> bool:
        """Miss-fill ONE reply fetched from the origin (must carry its
        proof window + multi-sig, or there is nothing worth caching)."""
        if reply is None or reply.window is None \
                or reply.multi_sig is None:
            return False
        window = tuple(reply.window)
        bucket = self._bucket(window)
        bucket["tree_size"] = reply.tree_size
        self._insert(window, bucket, reply)
        self.stored_total += 1
        self._gc_windows()
        return True

    def _bucket(self, window: Tuple[int, int]) -> dict:
        bucket = self._windows.get(window)
        if bucket is None:
            bucket = {"replies": {}, "tree_size": 0,
                      "replicated_at": self._clock()}
            self._windows[window] = bucket
        else:
            self._windows.move_to_end(window)
        return bucket

    def _insert(self, window, bucket, reply) -> None:
        bucket["replies"][reply.index] = reply
        key = (window, reply.index)
        self._lru[key] = None
        self._lru.move_to_end(key)
        while len(self._lru) > self.max_entries:
            (old_w, old_i), _ = self._lru.popitem(last=False)
            old_b = self._windows.get(old_w)
            if old_b is not None:
                old_b["replies"].pop(old_i, None)
            self.entries_evicted += 1

    def _gc_windows(self) -> None:
        while len(self._windows) > self.keep_windows:
            self._drop_oldest_window()

    def _drop_oldest_window(self) -> None:
        window, bucket = self._windows.popitem(last=False)
        for idx in bucket["replies"]:
            self._lru.pop((window, idx), None)
        self.windows_evicted += 1

    # --- invalidation ---------------------------------------------------

    def _on_checkpoint_stabilized(self, msg, *args) -> None:
        # master-instance seals only, same discipline as LedgerBacking /
        # CheckpointProofCache: a new window is sealed, so retire the
        # oldest held one when at capacity — the freshness bound
        # (EdgeProofCacheMaxAge, enforced client-side) covers whatever
        # staleness remains; verification is the security boundary
        if msg.inst_id != 0:
            return
        self.invalidations += 1
        if len(self._windows) >= self.keep_windows:
            self._drop_oldest_window()

    # --- serving --------------------------------------------------------

    def poison(self, seed: int) -> "EdgeProofCache":
        """Arm the byzantine-edge mode: every served reply is tampered
        (deterministically, per ``seed``) — a leaf flip, a root flip,
        or a corrupted multi-signature. The chaos plane's
        ``edge_cache_poisoning`` arc asserts clients catch ALL of it by
        offline verification."""
        self._poison_rng = random.Random("edge-poison-%d" % seed)
        return self

    def _tamper(self, reply):
        self.tampered_total += 1
        kind = self._poison_rng.randrange(3)
        if kind == 0 and reply.leaf:
            leaf = bytes([reply.leaf[0] ^ 0x01]) + bytes(reply.leaf[1:])
            return replace(reply, leaf=leaf)
        if kind == 1 and reply.root:
            root = bytes([reply.root[0] ^ 0x01]) + bytes(reply.root[1:])
            return replace(reply, root=root)
        ms = dict(reply.multi_sig or {})
        sig = str(ms.get("signature") or "")
        ms["signature"] = ("2" if not sig.startswith("2") else "3") \
            + sig[1:]
        return replace(reply, multi_sig=ms)

    def get(self, index: int):
        """Serve one read: the NEWEST held window containing the folded
        index wins. Dict lookups only — no hashing, no pairings. Returns
        None on miss (the fabric falls back to the origin)."""
        for window in reversed(self._windows):
            bucket = self._windows[window]
            size = bucket["tree_size"]
            if size <= 0:
                continue
            idx = index % size
            reply = bucket["replies"].get(idx)
            if reply is None:
                continue
            self.hits += 1
            key = (window, idx)
            if key in self._lru:
                self._lru.move_to_end(key)
            if self._poison_rng is not None:
                return self._tamper(reply)
            return reply
        self.misses += 1
        return None

    def submit(self, index: int) -> bool:
        """ReadService-shaped queueing (drain-based drivers plug an
        edge in where a ReadService went)."""
        self._queue.append(int(index))
        return True

    def drain(self) -> List:
        """Answer everything queued from the held windows, in
        submission order; misses are dropped (a standalone edge has no
        fallback — route through :class:`GeoReadFabric` for that)."""
        queued, self._queue = self._queue, []
        out = []
        for index in queued:
            reply = self.get(index)
            if reply is not None:
                out.append(reply)
        return out

    def window_age(self, now: float) -> Optional[float]:
        """Age of the newest held window's replication instant — the
        edge-side staleness signal (the CLIENT-side bound keys on the
        multi-sig's own timestamp, which the edge cannot forge)."""
        if not self._windows:
            return None
        newest = next(reversed(self._windows.values()))
        return now - newest["replicated_at"]

    def sized_resources(self, prefix: str = "edge_cache."):
        """Resource-ledger registration (observability.telemetry): the
        window buckets (keep_windows) and the reply LRU (max_entries)."""
        from ..observability.telemetry import SizedResource

        return (
            SizedResource(prefix + "windows", lambda: len(self._windows),
                          bound=self.keep_windows, entry_bytes=256),
            SizedResource(prefix + "lru", lambda: len(self._lru),
                          bound=self.max_entries, entry_bytes=1024),
        )

    def counters(self) -> Dict[str, object]:
        lookups = self.hits + self.misses
        return {
            "region": self.region,
            "windows_held": len(self._windows),
            "entries": len(self._lru),
            "replicated": self.replicated_total,
            "stored": self.stored_total,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": round(self.hits / lookups, 4) if lookups
            else 0.0,
            "invalidations": self.invalidations,
            "windows_evicted": self.windows_evicted,
            "entries_evicted": self.entries_evicted,
            "tampered": self.tampered_total,
        }


def _pct(sorted_samples: List[float], q: float) -> float:
    if not sorted_samples:
        return 0.0
    pos = min(len(sorted_samples) - 1,
              max(0, int(round(q * (len(sorted_samples) - 1)))))
    return sorted_samples[pos]


class GeoReadFabric:
    """Region-aware read routing + the client verification loop.

    ``origin`` is a proof-attached ReadService at the home region
    (``origin_region``); ``edges`` maps region -> EdgeProofCache (an
    empty map IS the no-edge arm: every read pays the WAN band to the
    origin). ``matrix`` supplies the latency bands (duck-typed:
    ``intra_band`` + ``band(a, b)``); per-read latency is drawn from a
    DEDICATED seeded RNG so the pool's delivery RNG — and with it every
    fingerprint — is untouched by serving reads.

    Client region is ``client % n_regions`` (the same modular placement
    the pool uses for nodes). Every reply is verified offline before it
    counts: edge replies first pass the freshness bound (strict ``>``
    against ``EdgeProofCacheMaxAge``, matching
    ``verify_pool_multi_sig``), then the amortized verification — one
    full pairing-bearing ``verify_proved_read`` per distinct
    (window, signature, participants), pairing-free
    ``verify_read_binding`` after. Miss / stale / failed verification
    falls back to the origin over the WAN and miss-fills the edge."""

    def __init__(self, origin, matrix, pool_keys: Dict[str, str],
                 min_participants: int, n_regions: int,
                 origin_region: int = 0,
                 edges: Optional[Dict[int, EdgeProofCache]] = None,
                 seed: int = 0,
                 clock: Optional[Callable[[], float]] = None,
                 max_age: Optional[float] = None,
                 config=None):
        if max_age is None:
            if config is None:
                from ..config import getConfig

                config = getConfig()
            max_age = config.EdgeProofCacheMaxAge
        self.origin = origin
        self.matrix = matrix
        self.pool_keys = dict(pool_keys)
        self.min_participants = int(min_participants)
        self.n_regions = int(n_regions)
        self.origin_region = int(origin_region)
        self.edges = dict(edges) if edges else {}
        self.max_age = max_age
        self._clock = clock if clock is not None else (lambda: 0.0)
        # NEVER the pool's RNG: the fabric draws one latency per served
        # read, and that stream must not perturb delivery jitter
        self._lat_rng = random.Random("geo-fabric-%d" % seed)
        self._queue: List[Tuple[int, int]] = []
        # (window, signature, participants) triples whose full
        # verification already succeeded — the pairing amortization set
        self._trusted: set = set()
        # region -> [(latency, source)] completion records
        self.samples: Dict[int, List[Tuple[float, str]]] = {}
        self.verified_by_region: Dict[int, int] = {}
        self.edge_served = 0
        self.origin_served = 0
        self.verify_caught = 0
        self.stale_fallbacks = 0
        self.verify_failures = 0
        self.edge_serve_pairings = 0
        self._vt_first: Optional[float] = None
        self._vt_last: Optional[float] = None

    # ------------------------------------------------------------------

    def region_of(self, client: int) -> int:
        return client % self.n_regions

    def submit(self, client: int, index: int) -> bool:
        self._queue.append((self.region_of(client), int(index)))
        return True

    def _stale(self, reply, now: float) -> bool:
        if self.max_age is None:
            return False
        ms = reply.multi_sig
        value = ms.get("value") if isinstance(ms, dict) else None
        ts = (value or {}).get("timestamp")
        if not isinstance(ts, (int, float)):
            return True  # unfreshable material is never served as fresh
        # strict >, matching verify_pool_multi_sig: a window EXACTLY at
        # max_age is still fresh
        return (now - ts) > self.max_age

    def _client_verify(self, reply, now: float) -> bool:
        from ..client.state_proof import (
            verify_proved_read,
            verify_read_binding,
        )

        ms = reply.multi_sig
        if not isinstance(ms, dict):
            return False
        trust_key = (reply.window, reply.root, ms.get("signature"),
                     tuple(ms.get("participants") or ()))
        if trust_key in self._trusted:
            return verify_read_binding(reply)
        ok = verify_proved_read(reply, self.pool_keys,
                                self.min_participants,
                                now=now, max_age=self.max_age)
        if ok:
            self._trusted.add(trust_key)
        return ok

    def drain(self) -> List:
        """Serve everything queued: edge lookups per region, client
        verification, origin fallback, latency modeling. Returns the
        verified replies (a reply failing even the origin's answer is
        dropped — and counted)."""
        queued, self._queue = self._queue, []
        if not queued:
            return []
        from ..crypto.bls.bls_crypto import PAIRINGS

        now = self._clock()
        if self._vt_first is None:
            self._vt_first = now
        self._vt_last = now
        by_region: Dict[int, List[int]] = {}
        for region, index in queued:
            by_region.setdefault(region, []).append(index)
        out = []
        for region in sorted(by_region):
            indexes = by_region[region]
            edge = self.edges.get(region)
            served: List[Tuple[object, str]] = []
            fallback: List[int] = []
            if edge is not None:
                checks_before = PAIRINGS.checks
                replies = [edge.get(i) for i in indexes]
                # the EDGE serve path must stay pairing-free (client
                # verification below legitimately pays one per window)
                self.edge_serve_pairings += \
                    PAIRINGS.checks - checks_before
                for index, reply in zip(indexes, replies):
                    if reply is None:
                        fallback.append(index)
                    elif self._stale(reply, now):
                        self.stale_fallbacks += 1
                        fallback.append(index)
                    elif not self._client_verify(reply, now):
                        self.verify_caught += 1
                        fallback.append(index)
                    else:
                        served.append((reply, "edge"))
            else:
                fallback = list(indexes)
            if fallback:
                for index in fallback:
                    self.origin.submit(index)
                origin_replies = self.origin.drain()
                for reply in origin_replies:
                    if not self._client_verify(reply, now):
                        # the home validator's own reply failing the
                        # offline check is a pool-level fault, not a
                        # cache artifact — count it, don't serve it
                        self.verify_failures += 1
                        continue
                    if edge is not None:
                        edge.store(reply)
                    served.append((reply, "origin"))
            band_wan = self.matrix.band(region, self.origin_region)
            band_intra = self.matrix.intra_band
            for reply, source in served:
                lo, hi = band_intra if source == "edge" else band_wan
                latency = self._lat_rng.uniform(lo, hi)
                self.samples.setdefault(region, []).append(
                    (latency, source))
                self.verified_by_region[region] = \
                    self.verified_by_region.get(region, 0) + 1
                if source == "edge":
                    self.edge_served += 1
                else:
                    self.origin_served += 1
                out.append(reply)
        return out

    # ------------------------------------------------------------------

    def counters(self) -> Dict[str, object]:
        served = self.edge_served + self.origin_served
        span = ((self._vt_last - self._vt_first)
                if self._vt_first is not None else 0.0)
        per_region = {}
        for region in sorted(self.samples):
            samples = self.samples[region]
            latencies = sorted(lat for lat, _ in samples)
            verified = self.verified_by_region.get(region, 0)
            per_region[str(region)] = {
                "served": len(samples),
                "edge": sum(1 for _, s in samples if s == "edge"),
                "verified": verified,
                "verified_per_sec": round(verified / span, 1)
                if span > 0 else 0.0,
                "latency_p50": round(_pct(latencies, 0.50), 6),
                "latency_p99": round(_pct(latencies, 0.99), 6),
            }
        return {
            "served": served,
            "edge_served": self.edge_served,
            "origin_served": self.origin_served,
            "edge_hit_rate": round(self.edge_served / served, 4)
            if served else 0.0,
            "verify_caught": self.verify_caught,
            "stale_fallbacks": self.stale_fallbacks,
            "verify_failures": self.verify_failures,
            "edge_serve_pairings": self.edge_serve_pairings,
            "regions": per_region,
        }
