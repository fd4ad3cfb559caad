"""Batched pairing verification for the state-proof plane.

The per-root BLS cycle (aggregate + one pairing check) costs two Miller
loops and a final exponentiation on the host — fine for one committed
root per ordered batch, hopeless for verifying proofs across many
roots/windows at read-client scale (``PERF.md`` §2 has the port's rates,
from ``chip_smoke.py`` phase P). This module amortizes:
``K`` aggregate signatures over ``K`` different roots verify in ONE
combined pairing pass via random-linear-combination batching (|apk
groups|+1 Miller loops + one shared final exponentiation, instead of 2K
Miller loops + K final exponentiations), so proofs/sec scales with the
batch size instead of the per-root cycle cost.

Seeding contract: with ``seed`` set, the combination scalars are a pure
function of (seed, item index, signature, message), so a seeded run
replays bit-identically (the determinism discipline every plane here
follows). **Predictable scalars are only sound for TRUSTED input** — an
adversary who knows the scalars in advance can craft a batch whose
forgeries cancel in the combined equation. That is fine for the proof
plane's own windows (each multi-sig was already verified at aggregation
time by consensus) and for benches/gates; a client verifying replies
from an UNTRUSTED node must pass ``seed=None`` (fresh ``secrets``
randomness, the default) — then a forged item survives the combined
check with probability 2^-128 and is pinpointed exactly by the per-item
fallback.

Copy of ``indy_plenum_tpu/proofs/batch_verify.py``, with its imports bound to
the port.
"""
from __future__ import annotations

import hashlib
from typing import Callable, List, Optional, Sequence

from ..crypto.bls.bls_crypto import PAIRINGS, BlsCryptoVerifier


def seeded_scalar_fn(seed: int) -> Callable[[int, str, bytes], int]:
    """128-bit combination scalars as a pure function of
    (seed, index, signature, message) — the replay-deterministic source
    for :meth:`BlsCryptoVerifier.verify_multi_sig_batch`."""

    def scalar(idx: int, sig_b58: str, message: bytes) -> int:
        h = hashlib.sha256(
            b"proof-rlc|%d|%d|" % (seed, idx)
            + sig_b58.encode() + b"|" + message).digest()
        return int.from_bytes(h[:16], "big")

    return scalar


def verify_multi_sigs_batch(items: Sequence[tuple],
                            seed: Optional[int] = None,
                            trace=None,
                            metrics=None) -> List[bool]:
    """Verify K aggregate signatures across multiple roots/windows in one
    combined pairing pass; returns exact per-item verdicts.

    ``items``: (signature_b58, message: bytes, pks_b58) — one entry per
    root/window. ``seed`` selects the deterministic scalar source (see
    the module doc for when that is sound); ``None`` uses fresh
    randomness. ``trace``/``metrics`` record the pass as a
    ``proof.verify_batch`` event / ``proof.pairings`` series so the
    amortization is an observable, not a claim.
    """
    before = PAIRINGS.pairings
    verdicts = BlsCryptoVerifier.verify_multi_sig_batch(
        items, scalar_fn=None if seed is None else seeded_scalar_fn(seed))
    pairings = PAIRINGS.pairings - before
    if metrics is not None:
        from ..common.metrics_collector import MetricsName

        metrics.add_event(MetricsName.PROOF_PAIRINGS, pairings)
        metrics.add_event(MetricsName.PROOF_VERIFY_BATCH, len(items))
    if trace is not None and trace.enabled:
        trace.record("proof.verify_batch", cat="proof",
                     args={"k": len(items), "pairings": pairings,
                           "ok": int(sum(bool(v) for v in verdicts))})
    return verdicts
