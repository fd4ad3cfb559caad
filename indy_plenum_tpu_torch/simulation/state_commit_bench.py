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
CUDA card unless the caller passes ``device="cpu"``. With them come the
soak arm (``run_state_soak``) and the flatness law it shares with the day
soak (``soak_high_water``).
"""
from __future__ import annotations

import hashlib
import random
import time
from typing import Dict, List, Optional, Tuple

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


# ---------------------------------------------------------------------------
# virtual-time soak
# ---------------------------------------------------------------------------


def _soak_once(hours: float, rate: float, seed: int, n_keys: int,
               profile_kind: str, period: float,
               sample_every: float, device: DeviceLike = None) -> Dict:
    from ..common.constants import (
        DOMAIN_LEDGER_ID,
        NYM,
        TARGET_NYM,
        TXN_TYPE,
        VERKEY,
    )
    from ..common.request import Request
    from ..config import getConfig
    from ..crypto.signers import DidSigner
    from ..ingress.workload import (
        WorkloadGenerator,
        WorkloadProfile,
        WorkloadSpec,
    )
    from .pool import SimPool

    config = getConfig({
        "Max3PCBatchWait": 0.25,
        "Max3PCBatchSize": 100,
        "WorkloadProfilePeriod": period,
        "WorkloadProfileTrough": 0.5,
        "WorkloadProfilePeak": 2.0,
        # high-water accounting reads the telemetry plane's resource
        # ledger — ONE accounting implementation; windows align to the
        # sample grid
        "TelemetryWindowSec": sample_every,
        "TelemetryWindowKeep": int(hours * 3600.0 / sample_every) + 4,
        "TelemetryLeakGraceWindows": max(1, int(3600.0 / sample_every)),
        "TelemetryDriftLag": max(1, int(period / sample_every)),
    })
    pool = SimPool(4, seed=seed, config=config, real_execution=True,
                   device=device)
    duration = hours * 3600.0
    spec = WorkloadSpec(
        n_clients=8, rate=rate, duration=duration,
        start=0.0, read_fraction=0.0,
        n_keys=n_keys, seed=seed,
        profile=WorkloadProfile.from_config(profile_kind, config))
    signers: Dict[int, DidSigner] = {}
    wl_seq = [0]

    def _write(client: int, key: int) -> None:
        signer = signers.get(key)
        if signer is None:
            signer = DidSigner(hashlib.sha256(b"soak-key-%d" % key).digest())
            signers[key] = signer
        wl_seq[0] += 1
        req = Request(
            identifier=pool.trustee.identifier,
            reqId=1_000_000 + wl_seq[0],
            operation={TXN_TYPE: NYM, TARGET_NYM: signer.identifier,
                       VERKEY: signer.verkey})
        pool.submit_built(req, client_id="c%d" % client)

    generator = WorkloadGenerator(spec)
    generator.start(pool.timer, _write)

    # per-structure accounting rides the telemetry plane's resource
    # ledger (observability/telemetry.py): every bounded structure the
    # pool composed registers at construction, the plane rolls a
    # high-water row per sample window off consensus pulses, and the
    # ordered tally is the tap's O(1) counter
    tap = pool._telemetry_tap
    hourly_ordered: List[int] = []
    prev_ordered = 0
    t_base = pool.timer.get_current_time()
    steps = int(duration / sample_every)
    for step in range(1, steps + 1):
        pool.run_for(sample_every)
        sim_t = pool.timer.get_current_time() - t_base
        if sim_t % 3600.0 < sample_every / 2 or step == steps:
            if len(hourly_ordered) < int(sim_t // 3600.0 + 0.5):
                ordered = tap.ordered_txns()
                hourly_ordered.append(ordered - prev_ordered)
                prev_ordered = ordered
    pool.telemetry.finalize(pool.timer.get_current_time())
    node = pool.nodes[0]
    state = node.boot.db.get_state(DOMAIN_LEDGER_ID)
    # the dirty overlay is a quantized sawtooth: it accumulates one
    # trie-path's worth of nodes per executed batch and clears at the
    # state commit, so a window's peak is (batches straddled by the
    # longest commit interval) x (~nodes per batch). The baseline
    # interval straddles 3 batches; commit phase can deterministically
    # hand a tail window a 4th, so flatness tolerates exactly that one
    # extra batch (1/3). Real leaks (a floor that never clears) are the
    # leak law's job and are NOT forgiven by this slack.
    first_hw, last_hw, flat = soak_high_water(
        pool, per_hour=max(1, int(3600.0 / sample_every)),
        slack_frac=1.0 / 3.0)
    drift = (abs(hourly_ordered[-1] - hourly_ordered[0])
             / hourly_ordered[0]) if hourly_ordered and hourly_ordered[0] \
        else 0.0
    fingerprint = hashlib.sha256(repr((
        pool.ordered_hash(),
        state.committed_head_hash,
        hourly_ordered,
        pool.telemetry.telemetry_hash,
    )).encode()).hexdigest()
    return {
        "arrivals": generator.counters()["arrivals"],
        "ordered_total": tap.ordered_txns(),
        "hourly_ordered": hourly_ordered,
        "throughput_drift": round(drift, 4),
        "first_hour_high_water": first_hw,
        "last_hour_high_water": last_hw,
        "flat_high_water": flat,
        "hashes_total": state.hashes_total,
        "cache_hit_rate": round(state.cache_hit_rate(), 4),
        "agree": pool.honest_nodes_agree(),
        "telemetry_hash": pool.telemetry.telemetry_hash,
        "anomalies": pool.telemetry.anomaly_count,
        "fingerprint": fingerprint,
    }


def soak_high_water(pool, per_hour: int,
                    first_rows=None, last_rows=None,
                    slack_frac: float = 0.0):
    """First-hour vs last-hour per-resource window high-water from the
    telemetry rollup rows — THE soak flatness law, shared by the state
    soak and the virtual-day soak. The plane's own rollup rings
    (``telemetry.*``) grow for the whole horizon by construction
    (bounded by declared maxlen, bound-violation-checked instead) and
    are excluded. ``slack_frac`` tolerates sampling jitter on transient
    sawtooth structures (dirty overlays, request queues peak with the
    diurnal phase, and a tail window's peak can top the baseline's by a
    batch) — the leak law stays the sharp instrument; flatness is the
    backstop."""
    rows = list(pool.telemetry.windows)
    first_rows = first_rows if first_rows is not None else rows[:per_hour]
    last_rows = last_rows if last_rows is not None else rows[-per_hour:]
    names = [n for n in pool.resource_ledger.names
             if not n.startswith("telemetry.")]
    first_hw = {n: max((r["high_water"].get(n, 0) for r in first_rows),
                       default=0) for n in names}
    last_hw = {n: max((r["high_water"].get(n, 0) for r in last_rows),
                      default=0) for n in names}
    flat = all(last_hw[n] <= first_hw[n] * (1.0 + slack_frac)
               for n in names)
    return first_hw, last_hw, flat


def run_state_soak(hours: float = 2.0, rate: float = 0.6, seed: int = 11,
                   n_keys: int = 400, profile_kind: str = "diurnal",
                   period: float = 1800.0, sample_every: float = 300.0,
                   repeats: int = 2, device: DeviceLike = None) -> Dict:
    """Virtual-time soak under a diurnal profile, run ``repeats`` times
    with the same seed: the whole artifact (ordered hash, final root,
    every structure sample) must be byte-identical across runs.
    ``period`` divides 3600 so first and last hour see the same phase of
    the rate curve — drift measures the system, not the workload shape.
    ``device`` runs the pool's kernels: the card unless ``"cpu"``.
    """
    t0 = time.perf_counter()
    runs = [_soak_once(hours, rate, seed, n_keys, profile_kind, period,
                       sample_every, device=device)
            for _ in range(repeats)]
    rec = dict(runs[0])
    rec.update({
        "hours": hours,
        "rate": rate,
        "seed": seed,
        "repeats": repeats,
        "deterministic": all(r["fingerprint"] == runs[0]["fingerprint"]
                             for r in runs),
        "wall_s": round(time.perf_counter() - t0, 1),
    })
    return rec
