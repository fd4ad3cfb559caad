"""State-proof plane: BLS-multi-signed verifiable reads at
checkpoint-window granularity.

Three cooperating parts:

- :mod:`.checkpoint_cache` — rides the ``CheckpointStabilized`` bus and
  captures, per stabilized window, the pool's multi-signature over the
  committed root (already aggregated by consensus), so every read served
  inside the window shares ONE aggregation cost and a cache hit is a
  dict lookup with zero pairings;
- :mod:`.batch_verify` — random-linear-combination verification of K
  aggregate signatures across multiple roots/windows in one combined
  pairing pass (seedable for deterministic replay), so proofs/sec scales
  with batch size instead of the per-root cycle cost;
- :mod:`.edge_cache` — the geo plane's edge tier: region-local
  UNTRUSTED replicas of the last sealed window's proof-attached
  replies (``EdgeProofCache``) plus the region-routing client loop
  (``GeoReadFabric``) that verifies every edge reply offline and falls
  back to the origin validator over the WAN — verification, not the
  cache, is the security boundary.

The client side closes the loop in
:func:`indy_plenum_tpu_torch.client.state_proof.verify_proved_read`: a reply
from ONE node verifies with nothing but the pool's BLS keys.

Copy of ``indy_plenum_tpu/proofs/__init__.py``, with its imports bound to
the port.
"""
from .batch_verify import seeded_scalar_fn, verify_multi_sigs_batch
from .checkpoint_cache import CheckpointProofCache, ProofWindow
from .edge_cache import EdgeProofCache, GeoReadFabric

__all__ = [
    "CheckpointProofCache",
    "EdgeProofCache",
    "GeoReadFabric",
    "ProofWindow",
    "seeded_scalar_fn",
    "verify_multi_sigs_batch",
]
