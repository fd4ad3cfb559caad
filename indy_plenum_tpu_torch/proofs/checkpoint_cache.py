"""Checkpoint-window proof cache: one aggregation cost per stable window.

Plenum's defining client capability is the BLS-multi-signed state proof
(``BlsBftReplica`` / ``verify_pool_multi_sig``): a reply from ONE node
carries the pool's n-f co-signature over the committed root, so the
client needs zero server trust. The ingress plane's ``ReadService``
alone serves proofs against a LOCAL root only — externally worthless.
This cache closes the gap at checkpoint-window granularity, PBFT's
read-only-operation optimisation (Castro & Liskov 1999) taken to its
logical end: consensus already pays the aggregation + pairing cost once
per ordered batch (``BlsBftReplica.process_order``), so the cache never
does ANY cryptography — it rides the ``CheckpointStabilized`` bus (the
same hook ``LedgerBacking`` uses) and, per stabilized window, snapshots
the committed (ledger size, ledger root, state root) and looks the
matching :class:`~indy_plenum_tpu_torch.crypto.bls.bls_crypto.MultiSignature`
up in the replica's :class:`~indy_plenum_tpu_torch.bls.bls_store.BlsStore`
(keyed by state root). Every read served inside the window then shares
that ONE already-paid aggregation: attaching the proof is a dict lookup,
ZERO pairings (asserted via ``crypto.bls.bls_crypto.PAIRINGS`` by the
budget script's proof gate).

Window contract:

- a read served mid-window verifies against the LAST captured window's
  root — the serve snapshot only advances at stabilization events,
  mirroring ``LedgerBacking``'s refresh discipline;
- capture VERIFIES the binding ``multi_sig.value.txn_root_hash ==
  b58(ledger root)`` before publishing an entry. When the tip batch's
  aggregate is not assembled yet (deferred tick-mode verification
  flushes at tick end; stabilization can fire from a network checkpoint
  mid-tick), the capture parks as *pending* and resolves on the next
  :meth:`attach`/:meth:`capture` — the roots were snapshotted at the
  stabilization instant, so the late-resolved entry still binds exactly
  the stabilized state;
- entries GC with checkpoint GC: only the newest ``keep`` windows stay
  (old multi-sigs below the stable floor are exactly what checkpoint GC
  retires), and an evicted window is no longer served.

Copy of ``indy_plenum_tpu/proofs/checkpoint_cache.py``, with its imports bound to
the port.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

from ..crypto.bls.bls_crypto import MultiSignature
from ..utils.base58 import b58encode


@dataclass
class ProofWindow:
    """One stabilized window's servable proof material. ``multi_sig_dict``
    is pre-serialized at capture so the per-read attach is a reference
    copy, never a re-serialization."""

    window: Tuple[int, int]  # (view_no, seq_no_end) — last_stable_3pc
    tree_size: int
    root: bytes
    state_root_b58: str
    multi_sig: MultiSignature
    multi_sig_dict: dict
    captured_at: float


class CheckpointProofCache:
    """``root_provider() -> (tree_size, root_bytes)`` and
    ``state_root_provider() -> b58 str`` snapshot the node's committed
    ledger/state; ``bls_replica`` supplies the store the consensus layer
    already filled. ``bus`` (a node's internal bus) auto-captures on
    ``CheckpointStabilized`` for the master instance; tests and benches
    may :meth:`install` pre-verified windows directly."""

    def __init__(self,
                 bls_replica,
                 root_provider: Callable[[], Tuple[int, bytes]],
                 state_root_provider: Callable[[], str],
                 bus=None,
                 keep: int = 2,
                 clock: Optional[Callable[[], float]] = None,
                 metrics=None,
                 trace=None,
                 node: str = ""):
        from ..observability.trace import NULL_TRACE

        if keep <= 0:
            raise ValueError(f"keep must be positive: {keep}")
        self._bls = bls_replica
        self._root_provider = root_provider
        self._state_root_provider = state_root_provider
        self.keep = int(keep)
        self._clock = clock if clock is not None else (lambda: 0.0)
        self.metrics = metrics
        self.trace = trace if trace is not None else NULL_TRACE
        self.node = node
        # insertion-ordered: oldest window first (GC pops from the front)
        self._entries: Dict[Tuple[int, int], ProofWindow] = {}
        # stabilizations whose multi-sig was not in the store yet:
        # window -> (tree_size, root, state_root_b58) — roots frozen at
        # the stabilization instant, each lookup retried lazily. A dict
        # (bounded by ``keep``, like the entries), NOT a single slot:
        # deferred aggregation lagging two windows must not drop the
        # older one — its multi-sig may still land first
        self._pending: Dict[Tuple[int, int], Tuple] = {}
        self.windows_signed = 0
        self.cache_hits = 0
        self.cache_misses = 0
        self.pending_retries = 0
        if bus is not None:
            from ..common.messages.internal_messages import (
                CheckpointStabilized,
            )

            bus.subscribe(CheckpointStabilized,
                          self._on_checkpoint_stabilized)

    @classmethod
    def for_domain(cls, db, bls_replica, bus=None, keep: int = 2,
                   clock=None, metrics=None, trace=None,
                   node: str = "") -> "CheckpointProofCache":
        """The composition seam ``Node`` and ``SimNode`` share: snapshot
        providers over the DOMAIN ledger + state of a
        ``LedgersBootstrap`` database — one copy of the root-binding
        convention, so deployed and simulated proofs can never drift."""
        from ..common.constants import DOMAIN_LEDGER_ID

        ledger = db.get_ledger(DOMAIN_LEDGER_ID)
        state = db.get_state(DOMAIN_LEDGER_ID)
        return cls(
            bls_replica=bls_replica,
            root_provider=lambda: (
                ledger.size,
                ledger.root_hash_at(ledger.size) if ledger.size else b""),
            state_root_provider=lambda: b58encode(
                state.committed_head_hash),
            bus=bus, keep=keep, clock=clock, metrics=metrics,
            trace=trace, node=node)

    # --- capture --------------------------------------------------------

    def _on_checkpoint_stabilized(self, msg, *args) -> None:
        if msg.inst_id != 0:
            return  # master windows only: backups share the ledger
        self.capture(tuple(msg.last_stable_3pc))

    def capture(self, window: Tuple[int, int]) -> Optional[ProofWindow]:
        """Snapshot the committed roots for ``window`` and publish the
        entry if the pool's multi-sig over them is already in the store;
        park as pending otherwise. Safe to call redundantly."""
        self._resolve_pending()
        if window in self._entries:
            return self._entries[window]
        tree_size, root = self._root_provider()
        if tree_size <= 0:
            return None
        state_root_b58 = self._state_root_provider()
        entry = self._lookup(window, tree_size, root, state_root_b58)
        if entry is None:
            # deferred aggregation (tick-mode flush) has not stored the
            # tip multi-sig yet; the ROOTS are frozen now, the lookup
            # retries on the next attach/capture
            self._pending[tuple(window)] = (tree_size, root,
                                            state_root_b58)
            while len(self._pending) > self.keep:
                del self._pending[next(iter(self._pending))]
        return entry

    def _lookup(self, window, tree_size, root,
                state_root_b58) -> Optional[ProofWindow]:
        if self._bls is None:
            return None
        ms = self._bls.store.get(state_root_b58)
        if ms is None or ms.value.txn_root_hash != b58encode(root):
            return None
        entry = ProofWindow(
            window=tuple(window), tree_size=tree_size, root=root,
            state_root_b58=state_root_b58, multi_sig=ms,
            multi_sig_dict=ms.as_dict(), captured_at=self._clock())
        self._install(entry)
        return entry

    def _resolve_pending(self) -> None:
        if not self._pending:
            return
        for window in list(self._pending):
            if window in self._entries:
                del self._pending[window]
                continue
            self.pending_retries += 1
            tree_size, root, state_root_b58 = self._pending[window]
            if self._lookup(window, tree_size, root, state_root_b58):
                del self._pending[window]

    def install(self, entry: ProofWindow) -> None:
        """The test/bench seam: publish a PRE-VERIFIED window proof
        directly (e.g. a manufactured corpus signed out-of-band)."""
        self._install(entry)

    def _install(self, entry: ProofWindow) -> None:
        # a pending older window resolving AFTER a newer capture must
        # not masquerade as the freshest proof: keep insertion ordered
        # by seq_no_end
        self._entries[entry.window] = entry
        self._entries = dict(
            sorted(self._entries.items(), key=lambda kv: kv[0][::-1]))
        while len(self._entries) > self.keep:
            # checkpoint GC: the oldest window falls off with the floor
            oldest = next(iter(self._entries))
            del self._entries[oldest]
        self.windows_signed += 1
        if self.metrics is not None:
            from ..common.metrics_collector import MetricsName

            self.metrics.add_event(MetricsName.PROOF_WINDOWS_SIGNED, 1)
        if self.trace.enabled:
            self.trace.record(
                "proof.window_signed", cat="proof", node=self.node,
                key=entry.window,
                args={"tree_size": entry.tree_size,
                      "participants": len(entry.multi_sig.participants)})

    # --- serving --------------------------------------------------------

    @property
    def depth(self) -> int:
        return len(self._entries)

    def windows(self) -> list:
        return list(self._entries)

    def get(self, window: Tuple[int, int]) -> Optional[ProofWindow]:
        return self._entries.get(tuple(window))

    def current(self) -> Optional[ProofWindow]:
        """The newest stabilized window's entry — what reads serve."""
        if not self._entries:
            return None
        return next(reversed(self._entries.values()))

    def attach(self, batch: int = 1) -> Optional[ProofWindow]:
        """The serve-path hook: the current entry, with hit/miss
        accounting per read. A hit is a dict lookup — no store access,
        no serialization, ZERO pairings."""
        if self._pending:
            self._resolve_pending()
        entry = self.current()
        if self.metrics is not None:
            from ..common.metrics_collector import MetricsName

            self.metrics.add_event(
                MetricsName.PROOF_CACHE_HIT if entry is not None
                else MetricsName.PROOF_CACHE_MISS, batch)
            if entry is not None:
                self.metrics.add_event(MetricsName.PROOF_SERVED, batch)
        if entry is None:
            self.cache_misses += batch
            return None
        self.cache_hits += batch
        if self.trace.enabled:
            self.trace.record(
                "proof.cache_hit", cat="proof", node=self.node,
                key=entry.window, args={"batch": batch})
        return entry

    def sized_resources(self, prefix: str = "proof_cache."):
        """Resource-ledger registration (observability.telemetry):
        servable windows and half-signed pending windows, both bounded
        by ``keep``."""
        from ..observability.telemetry import SizedResource

        return (
            SizedResource(prefix + "windows", lambda: len(self._entries),
                          bound=self.keep, entry_bytes=512),
            SizedResource(prefix + "pending", lambda: len(self._pending),
                          bound=self.keep, entry_bytes=512),
        )

    def counters(self) -> Dict[str, int]:
        return {
            "windows_signed": self.windows_signed,
            "windows_cached": self.depth,
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
            "pending_retries": self.pending_retries,
        }
