"""Device-proof read path: state reads that never touch the 3PC plane.

Plenum serves client reads the same way: one node answers from its
committed state with proof material (root + path + pool signature) that
makes a single answer trustworthy — reads ride no agreement round
(PBFT §"read-only operations", Castro & Liskov 1999). Here the proof
material is an RFC 6962 audit path against the serving ledger's root,
and the node VERIFIES what it hands out using the batched device
audit-proof kernel (the catchup kernel, K10) — one launch covers a whole
drain chunk's worth of reads.

Contract (the reference's, asserted there by bench.py's ``saturation``
sub-bench and tests/test_ingress.py):

- **zero 3PC involvement**: the service holds no reference to the vote
  plane; serving reads changes neither ``vote_group.flushes`` nor
  ``ordered_hash`` on the same seed;
- reads are answered against a SNAPSHOT ``(tree_size, root)`` captured
  at construction / :meth:`ReadService.refresh`, so a proof never
  straddles a root that moved mid-batch;
- per-drain batched verification: the whole batch rides ONE
  :func:`~indy_plenum_tpu_torch.server.catchup.catchup_rep_service
  .verify_audit_paths_batch` call. The default ``mode="auto"`` consults
  the catchup plane's MEASURED offload policy: the device kernel where
  it wins, the scalar host loop where the link makes the kernel a tax —
  same proofs, same verdicts either way.

Backings adapt proof sources: :class:`LedgerBacking` serves a live
ledger's committed txns (GET_TXN-style); :class:`StaticCorpusBacking`
builds a seeded NYM/attrib corpus for workload benches where the read
universe is the generator's hot-key space.

Copy of ``indy_plenum_tpu/ingress/read_service.py``,
with its imports bound to the port. A service verifies on its ``device``:
the CUDA card unless the caller passes ``device="cpu"`` (the audit-fold
kernel's plain version). With a ``proof_cache`` (the state-proof plane)
each drain serves against the last stabilized window's snapshot and every
reply carries the pool's BLS multi-signature over that root: the attach is
a dict lookup, zero pairings on the serve path, and the drain's folds stay
on the service's device. The resource-ledger registration
(``sized_resources``) comes with the telemetry slice.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from ..utils.torch_env import DeviceLike, resolve_device


@dataclass
class ProofRead:
    """One answered read: leaf bytes + the proof that they are in the
    tree identified by ``root`` at ``tree_size``. With the state-proof
    plane attached, ``multi_sig`` carries the pool's BLS co-signature
    over that root (participants ride inside the dict) and ``window``
    the stabilized checkpoint window it was captured at — a client
    holding only the pool's BLS keys verifies the whole reply via
    :func:`indy_plenum_tpu_torch.client.state_proof.verify_proved_read`."""

    index: int
    leaf: bytes
    root: bytes
    path: List[bytes]
    tree_size: int
    verified: bool
    multi_sig: Optional[dict] = None
    window: Optional[Tuple[int, int]] = None


class StaticCorpusBacking:
    """A seeded read corpus: ``n_keys`` deterministic NYM-record leaves
    in a compact Merkle tree. Audit paths are cached per index — Zipf
    read traffic concentrates on the head, so the cache hits almost
    always after warm-up."""

    def __init__(self, n_keys: int, seed: int = 0):
        from ..ledger.compact_merkle_tree import CompactMerkleTree

        if n_keys <= 0:
            raise ValueError("n_keys must be positive")
        self._leaves = [
            b"nym|%d|%d|verkey-%d" % (seed, i, i) for i in range(n_keys)]
        tree = CompactMerkleTree()
        tree.extend(self._leaves)
        self._tree = tree
        self.tree_size = n_keys
        self.root = tree.root_hash
        self._path_cache: Dict[int, List[bytes]] = {}

    def leaf(self, index: int) -> bytes:
        return self._leaves[index]

    def path(self, index: int,
             tree_size: Optional[int] = None) -> List[bytes]:
        # the corpus is immutable: every snapshot IS the full tree, so a
        # pinned window size can only ever equal self.tree_size — a
        # mismatched pin (a mis-installed ProofWindow) must fail loudly,
        # not hand out paths that silently verify False
        if tree_size is not None and tree_size != self.tree_size:
            raise ValueError(
                f"static corpus has no size-{tree_size} snapshot "
                f"(corpus size {self.tree_size})")
        cached = self._path_cache.get(index)
        if cached is None:
            cached = self._tree.audit_path(index, self.tree_size)
            self._path_cache[index] = cached
        return cached


class LedgerBacking:
    """Committed-txn reads from a live :class:`~indy_plenum_tpu_torch.ledger
    .ledger.Ledger`. The (size, root) snapshot is captured at
    construction and advanced on :meth:`refresh` — refreshing
    invalidates the path cache, since audit paths are per-tree-size.

    Pass the serving node's internal ``bus`` and the snapshot rides the
    checkpoint-stabilized hook: every ``CheckpointStabilized`` the
    consensus layer emits re-snapshots (size, root), so reads serve (and
    prove) everything up to the latest stable watermark with no manual
    refresh calls. Stabilized boundaries are exactly the roots the pool
    has durable agreement on — refreshing mid-window would serve roots a
    view change could still unwind."""

    # audit-path cache bound: on a long-lived pool the pinned
    # (index, tree_size) keys are minted every stabilized window and
    # never re-keyed, so an uncapped dict grows for the life of the
    # node; LRU keeps the hot window working set and ~nothing else
    PATH_CACHE_MAX = 4096

    def __init__(self, ledger, bus=None,
                 path_cache_max: Optional[int] = None):
        self._ledger = ledger
        self.tree_size = 0
        self.root = b""
        self.refreshes = 0
        # index -> path at the live snapshot; (index, size) -> path at a
        # pinned historical size (the proof plane's window roots).
        # Bounded LRU: cleared on refresh(), capped between refreshes.
        self._path_cache: "OrderedDict[object, List[bytes]]" = OrderedDict()
        self._path_cache_max = (path_cache_max if path_cache_max is not None
                                else self.PATH_CACHE_MAX)
        self.refresh()
        if bus is not None:
            from ..common.messages.internal_messages import (
                CheckpointStabilized,
            )

            bus.subscribe(CheckpointStabilized,
                          self._on_checkpoint_stabilized)

    def _on_checkpoint_stabilized(self, msg, *args) -> None:
        self.refresh()

    def refresh(self) -> None:
        size = self._ledger.size
        if size == self.tree_size:
            return
        self.tree_size = size
        self.root = self._ledger.root_hash_at(size) if size else b""
        self._path_cache.clear()
        self.refreshes += 1

    def leaf(self, index: int) -> bytes:
        # the ledger's tree hashed the stored serialized bytes — return
        # them verbatim (a loads/dumps round-trip per hot read would
        # also make proofs depend on re-serialization stability)
        return self._ledger.get_serialized(index + 1)

    def path(self, index: int,
             tree_size: Optional[int] = None) -> List[bytes]:
        # ``tree_size`` pins a HISTORICAL snapshot (the state-proof
        # plane serves the last stabilized window's root, which may
        # trail the live tip mid-window); audit paths are per-tree-size,
        # so pinned sizes key the cache alongside the index
        if tree_size is None or tree_size == self.tree_size:
            key: object = index
            pinned_size = self.tree_size
        else:
            key = (index, tree_size)
            pinned_size = tree_size
        cached = self._path_cache.get(key)
        if cached is not None:
            self._path_cache.move_to_end(key)
            return cached
        cached = self._ledger.audit_path(index + 1, pinned_size)
        self._path_cache[key] = cached
        if len(self._path_cache) > self._path_cache_max:
            self._path_cache.popitem(last=False)
        return cached


class _QueuedRead:
    """Bounded-queue payload: gives one queued read the ``digest``
    identity the admission controller's seeded rank law keys on (unique
    per submission — the same index re-read later is a new arrival)."""

    __slots__ = ("seq", "index", "digest")

    def __init__(self, seq: int, index: int):
        self.seq = seq
        self.index = index
        self.digest = "read|%d|%d" % (seq, index)


class ReadService:
    """Batches GET-style reads and answers them with device-verified
    proofs. ``clock`` (the pool's virtual clock) timestamps the
    ``ingress.read`` trace marks so traces stay deterministic, and
    ``read_qps`` derives from the SAME virtual clock (served total over
    the first→last serving-drain span), so snapshots and reports replay
    byte-identically; the wall-clock spent serving still accumulates
    host-side (``serve_wall_s``) for wall-throughput benches only.

    ``proof_cache`` (a :class:`~indy_plenum_tpu_torch.proofs
    .checkpoint_cache.CheckpointProofCache`) attaches the state-proof plane:
    drains serve against the LAST stabilized window's (size, root) snapshot
    and every reply carries the pool's BLS multi-signature over that root —
    the attach is a dict lookup, zero pairings on the serve path.

    ``capacity`` > 0 bounds the read queue with the SAME deterministic
    drop-newest shed law writes use (an
    :class:`~indy_plenum_tpu_torch.ingress.admission.AdmissionController`
    seeded with ``seed``), so a read flood sheds deterministically
    instead of starving the drain — ``ingress.read_shed`` /
    ``ingress.read_queue_depth`` metrics segregate it from the write
    side."""

    def __init__(self, backing, clock: Optional[Callable[[], float]] = None,
                 metrics=None, trace=None, max_batch: int = 16384,
                 mode: str = "auto", proof_cache=None,
                 capacity: int = 0, seed: int = 0, name: str = "",
                 region: Optional[int] = None, device: DeviceLike = None):
        from ..common.metrics_collector import MetricsCollector
        from ..observability.trace import NULL_TRACE

        # where the drains' audit-path folds run: the card unless
        # device="cpu" (the kernel's plain version)
        self.device = resolve_device(device)

        # mode: "device" forces the audit-proof kernel, "host" the scalar
        # verifier, "auto" (default) the catchup plane's MEASURED offload
        # policy (where the link makes the kernel a tax, the host loop
        # wins)
        self.mode = mode
        self.backing = backing
        self.proof_cache = proof_cache
        self._clock = clock if clock is not None else (lambda: 0.0)
        self.metrics = metrics if metrics is not None \
            else MetricsCollector()
        self.trace = trace if trace is not None else NULL_TRACE
        # service identity on the read journey marks: two services
        # sharing one recorder (or N merged per-node dumps) pair their
        # submitted/served FIFO windows independently in causal.py
        self.name = name
        # geo plane: the service's home region rides the read.submitted
        # marks so causal.py segregates read e2e per region (None =
        # untagged — single-region dumps keep their exact bytes)
        self.region = region
        self.max_batch = int(max_batch)
        self._queue: List[int] = []
        self.admission = None
        if capacity > 0:
            from .admission import AdmissionController

            self.admission = AdmissionController(
                capacity=capacity, seed=seed, clock=self._clock)
        self._read_seq = 0
        self.served_total = 0
        self.verified_total = 0
        self.proofs_attached_total = 0
        self.serve_wall_s = 0.0
        # read_qps span on the VIRTUAL clock: first/last drain instant
        # that actually served reads — a pure function of the seeded
        # schedule, so every surface reporting read_qps replays
        # byte-identically (the wall meter above stays wall-only)
        self._vt_first_serve: Optional[float] = None
        self._vt_last_serve: Optional[float] = None

    # ------------------------------------------------------------------

    def reset_serve_meters(self) -> None:
        """Zero the serve accounting — benches call this after kernel
        warm-up so warm-up drains pollute neither the wall meter nor the
        virtual read_qps span."""
        self.served_total = 0
        self.verified_total = 0
        self.proofs_attached_total = 0
        self.serve_wall_s = 0.0
        self._vt_first_serve = None
        self._vt_last_serve = None

    @property
    def depth(self) -> int:
        if self.admission is not None:
            return self.admission.depth
        return len(self._queue)

    @property
    def shed_total(self) -> int:
        return self.admission.shed_total if self.admission else 0

    def shed_hash(self) -> str:
        """The read-shed fingerprint (bounded mode), same contract as
        the write side's ``AdmissionController.shed_hash``."""
        if self.admission is None:
            import hashlib

            return hashlib.sha256(b"").hexdigest()
        return self.admission.shed_hash()

    def submit(self, index: int) -> bool:
        """Queue one read for the next drain; ``index`` is folded into
        the backing's tree (the workload generator's key space may be
        larger than the corpus). Returns whether the read is queued NOW
        (always True unbounded; in bounded mode a shed read returns
        False and its drop settles in the drain's accounting)."""
        size = self.backing.tree_size
        if size <= 0:
            raise ValueError("read backing is empty")
        idx = index % size
        if self.admission is None:
            self._queue.append(idx)
            if self.trace.enabled:
                # read-journey start (causal plane): serves pair with
                # these FIFO per service, giving per-read e2e without a
                # per-item id on the serve path. Unbounded mode only —
                # a bounded queue's seeded shed would break the pairing.
                self.trace.record(
                    "read.submitted", cat="read", node=self.name,
                    args=({"region": self.region}
                          if self.region is not None else None))
            return True
        self._read_seq += 1
        return self.admission.offer(_QueuedRead(self._read_seq, idx))

    def read_one(self, index: int) -> ProofRead:
        """Synchronous single read (tests / interactive use): the proof
        still verifies — through the host tier below DEVICE_MIN_BATCH.
        Anything already queued drains too; the reply for ``index`` is
        the LAST one (drain answers in submission order)."""
        if not self.submit(index):
            raise RuntimeError("read shed by backpressure")
        return self.drain()[-1]

    def drain(self) -> List[ProofRead]:
        """Answer everything queued: gather leaves + cached paths, then
        ONE batched audit-proof verification per ``max_batch`` chunk.
        Returns the replies in submission order. In bounded mode the
        drain also settles the shed accounting (``ingress.read_shed`` /
        ``ingress.read_queue_depth``); with a proof cache attached, the
        replies serve the last stabilized window's root and carry its
        pool multi-signature."""
        from ..common.metrics_collector import MetricsName

        if self.admission is not None:
            self.metrics.add_event(MetricsName.READ_QUEUE_DEPTH,
                                   self.admission.depth)
            batch, shed = self.admission.drain()
            queued = [r.index for r in batch]
            if shed:
                self.metrics.add_event(MetricsName.READ_SHED, len(shed))
        else:
            queued, self._queue = self._queue, []
            if queued and self.trace.enabled:
                # read-journey end: one mark per drain closes the FIFO
                # window the submitted marks opened (per-read e2e =
                # serve ts - submit ts, in causal.py)
                self.trace.record("read.served", cat="read",
                                  node=self.name,
                                  args={"n": len(queued)})
        if not queued:
            return []
        from ..server.catchup.catchup_rep_service import (
            verify_audit_paths_batch,
        )

        backing = self.backing
        root, tree_size = backing.root, backing.tree_size
        ms_dict = window = None
        if self.proof_cache is not None:
            entry = self.proof_cache.attach(len(queued))
            if entry is not None:
                # the window snapshot, NOT the live tip: mid-window
                # commits stay unserved until the next stabilization, so
                # every reply's root is one the pool co-signed
                root, tree_size = entry.root, entry.tree_size
                ms_dict, window = entry.multi_sig_dict, entry.window
        out: List[ProofRead] = []
        # da: allow[nondet-source] -- serve_wall_s meter (here and at the += below): wall accounting only, never in a reply or fingerprint
        t0 = time.perf_counter()
        for lo in range(0, len(queued), self.max_batch):
            # re-fold into the SERVING snapshot: submit() folded into the
            # live tree, which may have grown past the proven window
            chunk = [i % tree_size for i in queued[lo:lo + self.max_batch]]
            leaves = [backing.leaf(i) for i in chunk]
            paths = [backing.path(i, tree_size) for i in chunk]
            verdicts = verify_audit_paths_batch(
                leaves, chunk, paths, tree_size, root, mode=self.mode,
                device=self.device)
            ok = int(verdicts.sum())
            self.verified_total += ok
            if self.trace.enabled:
                self.trace.record(
                    "ingress.read", cat="ingress",
                    args={"batch": len(chunk), "ok": ok})
            for i, leaf, path, good in zip(chunk, leaves, paths,
                                           verdicts):
                out.append(ProofRead(
                    index=i, leaf=leaf, root=root, path=path,
                    tree_size=tree_size, verified=bool(good),
                    multi_sig=ms_dict, window=window))
        # da: allow[nondet-source] -- serve_wall_s meter close (see t0 above)
        self.serve_wall_s += time.perf_counter() - t0
        self.served_total += len(queued)
        now = self._clock()
        if self._vt_first_serve is None:
            self._vt_first_serve = now
        self._vt_last_serve = now
        if ms_dict is not None:
            self.proofs_attached_total += len(queued)
        self.metrics.add_event(MetricsName.READ_BATCH_SIZE, len(queued))
        self.metrics.add_event(MetricsName.READ_SERVED, len(queued))
        # qps on the VIRTUAL serve span (zero until a second serving
        # drain opens it): deterministic per seed, so the metric stream
        # — and every snapshot built from it — replays byte-identically
        span = self._vt_last_serve - self._vt_first_serve
        if span > 0:
            self.metrics.add_event(MetricsName.READ_QPS,
                                   self.served_total / span)
        return out

    # ------------------------------------------------------------------

    def counters(self) -> Dict[str, object]:
        # read_qps from the virtual serve span — deterministic per seed
        # (the wall meter serve_wall_s stays an attribute for
        # wall-throughput benches, OUT of the replayable record)
        span = ((self._vt_last_serve - self._vt_first_serve)
                if self._vt_first_serve is not None else 0.0)
        qps = self.served_total / span if span > 0 else 0.0
        out = {
            "served": self.served_total,
            "verified": self.verified_total,
            "pending": self.depth,
            "read_qps": round(qps, 1),
            "proofs_attached": self.proofs_attached_total,
        }
        if self.admission is not None:
            out["shed"] = self.admission.shed_total
            out["capacity"] = self.admission.capacity
        return out
