"""Pool-wide PBFT safety/liveness invariants over a simulated pool.

The checks are the Castro & Liskov (OSDI 1999) safety arguments turned
into executable assertions over the simulation pools
(:class:`~indy_plenum_tpu_torch.simulation.pool.SimPool`; the reference's
deployed ``NodePool`` comes with the deployed-node slice):

- **agreement** — no two honest replicas commit different batch digests
  at the same ``(view, seqNo)`` (checked per seqNo across views too:
  execution order is total, so a seqNo maps to ONE batch pool-wide);
- **ordered_prefix** — honest executed-request logs are prefix-consistent
  (a lagging replica is a prefix of a leading one, never a fork);
- **ledger_roots** — honest replicas agree on the committed (Merkle)
  root at every common height, via the executor's memoized roots
  (:class:`SimExecutor`) or the real domain ledger under
  ``real_execution``;
- **liveness** — once active faults drop to ≤ f, newly submitted probe
  requests order on every reachable honest replica within a bounded
  amount of virtual time.

Byzantine nodes (known from the :class:`FaultPlan`) are excluded from the
honest set; crashed-forever nodes are exempt from liveness only.

Copy of ``indy_plenum_tpu/chaos/invariants.py``, with its imports bound to
the port. The ordering lanes' checks (``check_cross_lane``,
``check_laned_safety``, ``check_laned_liveness``) come with the lanes
slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, FrozenSet, Iterable, List, Optional

AGREEMENT = "agreement"
ORDERED_PREFIX = "ordered_prefix"
LEDGER_ROOTS = "ledger_roots"
LIVENESS = "liveness"


@dataclass
class InvariantResult:
    name: str
    passed: bool
    detail: str = ""

    def as_dict(self) -> Dict[str, Any]:
        return {"name": self.name,
                "verdict": "PASS" if self.passed else "FAIL",
                "detail": self.detail}


class InvariantChecker:
    def __init__(self, pool: Any,
                 byzantine: Iterable[str] = (),
                 crashed: Iterable[str] = ()):
        self.pool = pool
        self.byzantine: FrozenSet[str] = frozenset(byzantine)
        self.crashed: FrozenSet[str] = frozenset(crashed)

    @property
    def honest_nodes(self) -> List[Any]:
        return [n for n in self.pool.nodes if n.name not in self.byzantine]

    # --- safety ---------------------------------------------------------

    def check_agreement(self) -> InvariantResult:
        # seqNo -> digest -> [node names]; batch digest is the PRE-PREPARE
        # digest every commit certificate voted on
        by_seq: Dict[int, Dict[str, List[str]]] = {}
        for node in self.honest_nodes:
            for o in node.ordered_log:
                digest = o.digest or "|".join(o.reqIdr)
                by_seq.setdefault(o.ppSeqNo, {}) \
                    .setdefault(digest, []).append(node.name)
        conflicts = [
            (seq, {d: names for d, names in digests.items()})
            for seq, digests in sorted(by_seq.items())
            if len(digests) > 1]
        if conflicts:
            seq, split = conflicts[0]
            return InvariantResult(
                AGREEMENT, False,
                f"honest replicas committed {len(split)} different batches "
                f"at seqNo {seq}: {split} "
                f"(+{len(conflicts) - 1} more conflicting seqNos)")
        return InvariantResult(
            AGREEMENT, True,
            f"{len(by_seq)} seqNos, single digest each across "
            f"{len(self.honest_nodes)} honest replicas")

    def _ordered_seq(self, node: Any) -> tuple:
        """One node's ordering fingerprint sequence. Real-execution nodes
        use the committed domain ledger's request-digest sequence: a node
        that CAUGHT UP across a GC'd window never saw the leeched range's
        ``Ordered`` events, but the fetched txns carry the original
        request digests — the ledger IS its ordering record, comparable
        bit-for-bit against the survivors. Executor-faked pools keep the
        ordered_log view."""
        if getattr(node, "boot", None) is not None \
                and hasattr(type(node), "committed_request_digests"):
            return tuple(node.committed_request_digests)
        return tuple(node.ordered_digests)

    def check_ordered_prefix(self) -> InvariantResult:
        logs = {n.name: self._ordered_seq(n)
                for n in self.honest_nodes}
        longest_name = max(logs, key=lambda name: len(logs[name]))
        longest = logs[longest_name]
        for name, log in logs.items():
            if log != longest[:len(log)]:
                split = next(i for i in range(min(len(log), len(longest)))
                             if log[i] != longest[i])
                return InvariantResult(
                    ORDERED_PREFIX, False,
                    f"{name} forks from {longest_name} at position {split}:"
                    f" {log[split]!r} != {longest[split]!r}")
        return InvariantResult(
            ORDERED_PREFIX, True,
            f"all honest logs are prefixes of {longest_name} "
            f"(len {len(longest)})")

    def _committed_roots(self, node: Any) -> Optional[Dict[int, Any]]:
        """seqNo -> committed root for whatever executor the node runs."""
        executor = getattr(node, "executor", None)
        roots = getattr(executor, "roots_by_seq", None)
        if roots is not None:
            return dict(roots)
        return None

    def check_ledger_roots(self) -> InvariantResult:
        honest = self.honest_nodes
        roots = {n.name: self._committed_roots(n) for n in honest}
        if any(r is None for r in roots.values()):
            # real execution: compare the domain ledger's committed merkle
            # root at the minimum common height
            from ..common.constants import DOMAIN_LEDGER_ID

            ledgers = {n.name: n.boot.db.get_ledger(DOMAIN_LEDGER_ID)
                       for n in honest}
            common = min(l.size for l in ledgers.values())
            at_common = {name: l.root_hash_at(common)
                         for name, l in ledgers.items()}
            if len(set(at_common.values())) > 1:
                return InvariantResult(
                    LEDGER_ROOTS, False,
                    f"domain ledger roots diverge at height {common}: "
                    f"{ {k: v.hex() for k, v in at_common.items()} }")
            return InvariantResult(
                LEDGER_ROOTS, True,
                f"domain ledger root equal across {len(honest)} honest "
                f"replicas at common height {common}")
        common_seqs = None
        for r in roots.values():
            common_seqs = set(r) if common_seqs is None else common_seqs & set(r)
        for seq in sorted(common_seqs or ()):
            at_seq = {name: r[seq] for name, r in roots.items()}
            if len(set(at_seq.values())) > 1:
                return InvariantResult(
                    LEDGER_ROOTS, False,
                    f"committed roots diverge at seqNo {seq}: {at_seq}")
        return InvariantResult(
            LEDGER_ROOTS, True,
            f"committed roots equal across {len(honest)} honest replicas "
            f"at {len(common_seqs or ())} common seqNos")

    def check_safety(self) -> List[InvariantResult]:
        return [self.check_agreement(),
                self.check_ordered_prefix(),
                self.check_ledger_roots()]

    # --- liveness -------------------------------------------------------

    def _submit_probe(self, seq: int) -> None:
        pool = self.pool
        if hasattr(pool, "submit_request"):  # SimPool
            pool.submit_request(seq)
            return
        # NodePool: a signed write submitted to one reachable honest node
        req = pool.make_nym_request(seq=seq)
        entry = next(n.name for n in self.pool.nodes
                     if n.name not in self.byzantine
                     and n.name not in self.crashed)
        pool.submit_to(entry, req)

    def check_liveness(self, probes: int = 3, timeout: float = 30.0,
                       probe_seq_base: int = 900_000) -> InvariantResult:
        """Submit fresh requests and require ordering progress on every
        honest, never-permanently-crashed replica within ``timeout``
        virtual seconds. Run this AFTER the plan's bounded faults ended
        (active faults ≤ f) — during a full partition no protocol can be
        live."""
        eligible = [n for n in self.honest_nodes
                    if n.name not in self.crashed]
        before = {n.name: len(n.ordered_digests) for n in eligible}
        for i in range(probes):
            self._submit_probe(probe_seq_base + i)
        waited = 0.0
        step = 1.0
        while waited < timeout:
            self.pool.run_for(step)
            waited += step
            if all(len(n.ordered_digests) >= before[n.name] + probes
                   for n in eligible):
                return InvariantResult(
                    LIVENESS, True,
                    f"{probes} probe requests ordered on all "
                    f"{len(eligible)} reachable honest replicas within "
                    f"{waited:.0f}s virtual")
        stuck = {n.name: len(n.ordered_digests) - before[n.name]
                 for n in eligible
                 if len(n.ordered_digests) < before[n.name] + probes}
        return InvariantResult(
            LIVENESS, False,
            f"ordering did not resume within {timeout:.0f}s virtual; "
            f"progress per stuck replica: {stuck}")

    def check_all(self, probes: int = 3,
                  liveness_timeout: float = 30.0) -> List[InvariantResult]:
        results = self.check_safety()
        results.append(self.check_liveness(probes=probes,
                                           timeout=liveness_timeout))
        # liveness mutates pool history (probe requests); re-verify safety
        # over the post-probe state so the final verdicts cover it
        results[:3] = self.check_safety()
        return results
