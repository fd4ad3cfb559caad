"""State-commit plane measurement harness (bench.py `state` + state_gate).

- :func:`run_commit_arms` — the O(delta) claim at state scale: populate a
  100k-key SMT through :meth:`SparseMerkleState.apply_batch` itself, then
  drive identical per-window delta commits through three arms (sequential
  ``set()`` loop, batched host waves, batched ``mode='auto'`` waves),
  asserting the per-window roots bit-identical across arms and measuring
  hashes/commit + commits/sec per arm. The window workload is hot-key
  (90% of writes to a 32-key hot set, 10% uniform over the keyspace —
  the ingress plane's zipf-shaped write law): last-write-wins dedupe plus
  prefix sharing is where the batched walk's >=3x reduction comes from;
  on 256 DISTINCT uniform keys the tree shares almost nothing and the
  walk saves only the duplicated near-root levels (~3%).

Copy of ``window_writes``, ``populate_state`` and ``run_commit_arms`` of
``indy_plenum_tpu/simulation/state_commit_bench.py``, with its imports
bound to the port and a ``device`` for the states' device waves (K11): the
CUDA card unless the caller passes ``device="cpu"``. The soak arm
(``run_state_soak``) comes with the telemetry slice of the port.
"""
from __future__ import annotations

import random
import time
from typing import Dict, List, Tuple

from ..state.sparse_merkle_state import SparseMerkleState
from ..storage.kv_store import KeyValueStorageInMemory
from ..utils.torch_env import DeviceLike

# da: allow-file[nondet-source] -- bench harness: wall-clock rates (commits/sec, populate seconds) are REPORTED alongside the deterministic meters (roots, hash counts), never inside them


def _key(i: int) -> bytes:
    return b"acct%08d" % i


def window_writes(n_keys: int, delta: int, windows: int, seed: int,
                  hot_keys: int = 32, hot_frac: float = 0.9,
                  ) -> List[List[Tuple[bytes, bytes]]]:
    """The per-window write sequences every arm replays verbatim."""
    rng = random.Random(seed)
    out = []
    for w in range(windows):
        writes = []
        for i in range(delta):
            if rng.random() < hot_frac:
                k = _key(rng.randrange(hot_keys))
            else:
                k = _key(rng.randrange(n_keys))
            writes.append((k, b"w%d:%d:%d" % (w, i, rng.randrange(1 << 30))))
        out.append(writes)
    return out


def populate_state(n_keys: int, chunk: int = 4096,
                   kv=None, device: DeviceLike = None
                   ) -> Tuple[object, bytes, float]:
    """Build the base SMT through apply_batch itself (the tentpole at
    population scale), in host waves; returns (kv, committed_root,
    seconds)."""
    kv = kv if kv is not None else KeyValueStorageInMemory()
    state = SparseMerkleState(kv=kv, commit_mode="host", device=device)
    t0 = time.perf_counter()
    for lo in range(0, n_keys, chunk):
        state.apply_batch(
            (_key(i), b"init%d" % i)
            for i in range(lo, min(lo + chunk, n_keys)))
        state.commit()
    return kv, state.committed_head_hash, time.perf_counter() - t0


def run_commit_arms(n_keys: int = 100_000, delta: int = 256,
                    windows: int = 20, seed: int = 7,
                    hot_keys: int = 32, hot_frac: float = 0.9,
                    arms: Tuple[str, ...] = ("sequential", "host", "auto"),
                    populate_chunk: int = 4096,
                    device: DeviceLike = None) -> Dict:
    """Identical per-window commits through each arm; per-window roots
    asserted bit-identical, hashes/commit + commits/sec per arm. Runs on
    the card unless ``device="cpu"``."""
    kv, base_root, populate_s = populate_state(
        n_keys, chunk=populate_chunk, device=device)
    workload = window_writes(n_keys, delta, windows, seed,
                             hot_keys=hot_keys, hot_frac=hot_frac)
    arm_records: Dict[str, Dict] = {}
    root_seqs: Dict[str, List[bytes]] = {}
    for arm in arms:
        mode = "host" if arm == "sequential" else arm
        state = SparseMerkleState(kv=kv, initial_root=base_root,
                                  commit_mode=mode, device=device)
        roots: List[bytes] = []
        h0 = state.hashes_total
        t0 = time.perf_counter()
        for writes in workload:
            if arm == "sequential":
                for k, v in writes:
                    state.set(k, v)
            else:
                state.apply_batch(writes)
            roots.append(state.head_hash)
            # content-addressed nodes: every arm commits the SAME tree,
            # so flushing into the shared kv is idempotent across arms
            # (the per-arm working root is what we compare)
            state.commit(roots[-1])
        elapsed = time.perf_counter() - t0
        hashes = state.hashes_total - h0
        arm_records[arm] = {
            "hashes_per_commit": hashes / windows,
            "commits_per_sec": windows / elapsed if elapsed else 0.0,
            "elapsed_s": round(elapsed, 3),
            "cache_hit_rate": round(state.cache_hit_rate(), 4),
            "wave_host_hashes": state.wave_host_hashes,
            "wave_device_hashes": state.wave_device_hashes,
        }
        root_seqs[arm] = roots
    ref = root_seqs[arms[0]]
    roots_identical = all(root_seqs[a] == ref for a in arms)
    assert roots_identical, "state-commit arms diverged on a window root"
    record = {
        "n_keys": n_keys,
        "delta": delta,
        "windows": windows,
        "seed": seed,
        "hot_keys": hot_keys,
        "hot_frac": hot_frac,
        "populate_s": round(populate_s, 2),
        "roots_identical": roots_identical,
        "final_root": ref[-1].hex(),
        "arms": arm_records,
    }
    if "sequential" in arm_records and "host" in arm_records:
        record["hash_reduction"] = round(
            arm_records["sequential"]["hashes_per_commit"]
            / arm_records["host"]["hashes_per_commit"], 2)
    return record
