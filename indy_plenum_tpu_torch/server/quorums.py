"""Quorum arithmetic for n = 3f + 1 Byzantine fault tolerance.

Reference: plenum/server/quorums.py (`Quorums`, `Quorum`). All thresholds
are pure functions of the pool size n; they are used both by the host
protocol state machines and (as integers baked into jitted closures) by the
device-plane quorum tally in `indy_plenum_tpu_torch.models.quorum_plane`.

Copy of ``indy_plenum_tpu/server/quorums.py``, with its imports bound to the
port.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class Quorum:
    """A single threshold: satisfied when votes >= value."""

    value: int

    def is_reached(self, votes: int) -> bool:
        return votes >= self.value


@dataclass(frozen=True)
class Quorums:
    """All protocol thresholds derived from pool size ``n``.

    f = (n - 1) // 3 is the max number of byzantine nodes tolerated.

    weak (f+1): at least one honest node among the voters.
    strong (n-f): a majority of honest nodes among the voters.
    """

    n: int
    f: int = field(init=False)
    weak: Quorum = field(init=False)
    strong: Quorum = field(init=False)
    propagate: Quorum = field(init=False)
    prepare: Quorum = field(init=False)
    commit: Quorum = field(init=False)
    checkpoint: Quorum = field(init=False)
    view_change: Quorum = field(init=False)
    new_view: Quorum = field(init=False)
    view_change_ack: Quorum = field(init=False)
    view_change_done: Quorum = field(init=False)
    election: Quorum = field(init=False)
    reply: Quorum = field(init=False)
    consistency_proof: Quorum = field(init=False)
    ledger_status: Quorum = field(init=False)
    backup_instance_faulty: Quorum = field(init=False)
    timestamp: Quorum = field(init=False)
    bls_signatures: Quorum = field(init=False)
    observer_data: Quorum = field(init=False)
    same_consistency_proof: Quorum = field(init=False)

    def __post_init__(self):
        n = self.n
        if n < 1:
            raise ValueError(f"pool size must be >= 1, got {n}")
        f = (n - 1) // 3
        object.__setattr__(self, "f", f)
        set_ = object.__setattr__
        set_(self, "weak", Quorum(f + 1))
        set_(self, "strong", Quorum(n - f))
        set_(self, "propagate", Quorum(f + 1))
        set_(self, "prepare", Quorum(n - f - 1))
        set_(self, "commit", Quorum(n - f))
        # checkpoint/ledger_status/view_change_ack count only OTHER nodes'
        # messages (a node does not message itself), hence n - f - 1.
        set_(self, "checkpoint", Quorum(n - f - 1))
        set_(self, "view_change", Quorum(n - f))
        set_(self, "new_view", Quorum(n - f))
        set_(self, "view_change_ack", Quorum(n - f - 1))
        set_(self, "view_change_done", Quorum(n - f))
        set_(self, "election", Quorum(n - f))
        set_(self, "reply", Quorum(f + 1))
        set_(self, "consistency_proof", Quorum(f + 1))
        set_(self, "ledger_status", Quorum(n - f - 1))
        set_(self, "backup_instance_faulty", Quorum(f + 1))
        set_(self, "timestamp", Quorum(f + 1))
        set_(self, "bls_signatures", Quorum(n - f))
        set_(self, "observer_data", Quorum(f + 1))
        set_(self, "same_consistency_proof", Quorum(f + 1))
