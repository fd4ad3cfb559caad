"""Benchmark entry point: prints ONE JSON line with the headline metric.

    python -m indy_plenum_tpu_torch.tools.bench [cell|all] [--device cpu]

Twin of the root ``bench.py`` over the port. The same 18 cells under the
same names (``ed``, ``ordered``, ``rbft``, ``sharded``, ``resident``,
``fabric``, ``lanes``, ``ordered100``, ``saturation``, ``bls``,
``proofs``, ``catchup``, ``catchup_e2e``, ``offload``, ``viewchange``,
``state``, ``geo``, ``soak``), the same function and metric names, sizes,
seeds and configs, the same in-cell assertions, the same compact stdout
line and full record, and the reference's ``BENCH_RESIDENT_DEPTH``
variable.

Headline (BASELINE.md config 2): batched Ed25519 signature verifies/sec
on the device. Baseline: libsodium Ed25519 verify on one CPU core is
~15-30k ops/sec (BASELINE.md provenance note); 25k/sec is the reference
point. The stdout line is COMPACT: the headline metric plus an ``extras``
digest of ``{metric: [value, vs_baseline]}`` per cell. Full records for
every cell go to ``BENCH_FULL.json`` beside this file and to stderr.

Every cell runs on the CUDA card (``cuda:0``, or the visible cards for a
mesh) unless ``--device cpu`` asks for the plain versions of the
kernels; without a card and without ``--device cpu`` the CLI raises
before it runs any cell. Where the reference is tied to JAX:

- ``ed`` and ``catchup``'s kernel-only arm put their packed arrays on the
  device as tensors and time each run to a ``torch.cuda.synchronize()``
  (the reference's ``block_until_ready``); ``ed``'s ``device`` is the
  card's name and power limit as ``nvidia-smi`` gives them;
- ``sharded`` and ``fabric`` build their meshes with
  ``tpu.quorum.make_fabric_mesh`` over the visible cards, 8 tiles (on one
  card every tile on it, the one-state layout), where the reference
  re-executes itself on 8 virtual XLA CPU devices. ``sharded``'s record
  states the layout and the card count;
- nothing retries: a cell that raises is recorded in ``errors`` as the
  reference records it, and the CLI exits 1 when ``errors`` is not
  empty. The kernels build at first use (``utils/kernel_build.py``), so
  there is no compile cache to set.

Cells whose size the reference fixes inside its body take it as keyword
arguments defaulting to the reference's (``viewchange``'s ``n``,
``offload``'s ``tree_size`` and ``slice_size``, ``_run_saturation``'s
``n_nodes``, ``n_keys`` and the open-loop window's ``duration``, ``ed``'s
``batch``), so tests can run them small; the CLI always runs the
defaults.
"""
# da: allow-file[nondet-source] -- benchmark harness: its wall reads time the cells and bound a stalled run; every seeded record (ordered_hash, shed_hash, journey_hash) is built on the virtual clock
# da: allow-file[device-sync] -- benchmark harness: each timed run ends on a synchronize and each verdict is read back once, after its timed window, to assert it
import argparse
import json
import os
import sys
import time
import traceback

from ..utils.torch_env import device_list, resolve_device

BASELINE_CPU_VERIFIES_PER_SEC = 25_000.0
# the reference publishes no numbers (BASELINE.json "published": {});
# community folklore for indy pools is low-hundreds of write txns/sec at
# 4-25 nodes with O(n^2) message handling, so 100/sec at n=64 is a
# deliberately generous CPU reference estimate. Clearly labelled as such.
ESTIMATED_REFERENCE_ORDERED_TXNS_PER_SEC_N64 = 100.0

ED_BATCH = 32768
REPS = 5  # >=5 timed runs: report median + spread, not a single best
MESH_TILES = 8  # the reference's virtual device count for sharded/fabric


def _sync(dev) -> None:
    """Close a timed run: wait for the card's queued work."""
    if dev.type == "cuda":
        import torch

        torch.cuda.synchronize(dev)


def _device_label(dev) -> str:
    """The card's name and power limit (``nvidia-smi``), or ``cpu``."""
    if dev.type != "cuda":
        return str(dev)
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", f"--id={dev.index}",
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def _mesh_tiles(dev, tiles: int = MESH_TILES) -> list:
    """The mesh's device list: tile t on visible card t % count (every
    tile on the one card when there is one), or the CPU ``tiles`` times."""
    cards = device_list(dev) if dev.type == "cuda" else [dev]
    return [cards[t % len(cards)] for t in range(tiles)]


def _spread(times):
    """Median + min/max over timed runs — run-to-run spread must be
    visible before small swings mean anything."""
    s = sorted(times)
    median = s[len(s) // 2] if len(s) % 2 else (
        s[len(s) // 2 - 1] + s[len(s) // 2]) / 2
    return {
        "median_ms": round(median * 1e3, 2),
        "min_ms": round(s[0] * 1e3, 2),
        "max_ms": round(s[-1] * 1e3, 2),
        "runs": len(s),
    }, median


def _timed_reps(fn, dev, reps=REPS):
    """One UNTIMED warmup call, then ``reps`` timed runs, each closed by
    a synchronize on ``dev``.

    The first call of a kernel cell pays the kernel library's build and
    first launch; kept out of the timed loop, it is still recorded in
    the spread as ``compile_ms`` (build + first execution), separate
    from the steady-state numbers it would otherwise contaminate."""
    t0 = time.perf_counter()
    fn()
    _sync(dev)
    compile_ms = round((time.perf_counter() - t0) * 1e3, 2)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        times.append(time.perf_counter() - t0)
    spread, median = _spread(times)
    spread["compile_ms"] = compile_ms
    return spread, median


def bench_ed25519(device=None, batch: int = ED_BATCH) -> dict:
    import numpy as np

    from ..crypto import ed25519 as ed
    from ..tpu import ed25519 as ted

    dev = resolve_device(device)
    rng = np.random.RandomState(7)
    seeds = [rng.bytes(32) for _ in range(64)]
    pks_all = [ed.fast_public_key(s) for s in seeds]
    pks, msgs, sigs = [], [], []
    for i in range(batch):
        seed = seeds[i % len(seeds)]
        msg = rng.bytes(64)
        pks.append(pks_all[i % len(seeds)])
        msgs.append(msg)
        sigs.append(ed.fast_sign(seed, msg))

    # production path: the device computes SHA512(R||A||M) mod L itself
    # (K-a, K-b) — the host only packs padded blocks (byte moves, no
    # hashing)
    max_blocks = ted.max_blocks_for(msgs)
    t0 = time.perf_counter()
    pk_a, r_a, s_a, blocks, counts, pre = ted.prepare_batch_device(
        pks, msgs, sigs, max_blocks)
    prep_new_s = time.perf_counter() - t0
    assert pre.all()
    args = ted.to_device((pk_a, r_a, s_a, blocks, counts), dev)

    # the untimed warmup inside _timed_reps is the build run (recorded
    # as spread.compile_ms); correctness is asserted on a warm call after
    spread, median = _timed_reps(lambda: ted.verify_kernel_full(*args), dev)
    ok = ted.verify_kernel_full(*args).cpu().numpy()
    assert ok.all(), "benchmark batch failed verification"
    value = batch / median

    # the older shape for comparison: host hashlib h + curve-only kernel
    t0 = time.perf_counter()
    ted.prepare_batch(pks, msgs, sigs)
    prep_old_s = time.perf_counter() - t0
    # this metric times SHA-512 + mod-L + the curve on the device; the
    # older ed25519_verifies_per_sec_per_chip hashed h on the host, so a
    # same-name comparison would misread the added work as a regression
    return {
        "metric": "ed25519_full_onchip_verifies_per_sec",
        "value": round(value, 1),
        "unit": "verifies/sec (SHA-512 + mod-L + curve math all on "
                "device; successor of ed25519_verifies_per_sec_per_chip)",
        "vs_baseline": round(value / BASELINE_CPU_VERIFIES_PER_SEC, 3),
        "batch": batch,
        "spread": spread,
        "host_prep_us_per_sig": round(prep_new_s / batch * 1e6, 2),
        "host_prep_us_per_sig_round4_path": round(
            prep_old_s / batch * 1e6, 2),
        "device": _device_label(dev),
    }


def _bench_ordered(n_nodes: int, num_instances: int, batches: int,
                   metric: str, note: str,
                   host_accounting: bool = False, mesh=None,
                   host_eval: bool = False,
                   resident_depth: int = 0, device=None) -> dict:
    """Ordered txns/sec with the device quorum plane as sole authority
    (no host shadow tallies), tick-batched flushes. ``num_instances`` > 1
    runs the full RBFT instance axis — backups' tallies ride the same
    grouped (node x instance) dispatch as the masters'.

    ``host_accounting``: the sim runs ALL n validators' host loops
    serially in one process, so raw wall-clock understates a deployed
    pool by ~n. With accounting on, the bench ALSO measures (a) each
    node's own CPU seconds (its message handling incl. triggered sends,
    its per-instance tick evaluation, plus the FULL shared device flush
    charged to every node — conservative) and (b) the protocol-time
    throughput on the virtual clock. A deployed pool's capacity is
    min(busiest-host bound, protocol pipeline bound) — that min becomes
    the metric ``value``; the serial wall number is reported alongside.

    ``mesh`` is a ``tpu.quorum.make_fabric_mesh`` fabric; ``device`` runs
    the pool's kernels on the card (None) or their plain versions
    ("cpu")."""
    from ..config import getConfig
    from ..simulation.pool import SimPool

    dev = resolve_device(device)
    batch_size = 320
    # the tick is SIM time (free): longer ticks mean fewer device
    # round-trips per ordered batch with zero wall-clock latency cost.
    # Adaptive: the governor retunes the interval from the flush
    # occupancy it observes — the trajectory is recorded in the extras
    # digest so successive runs track adaptation
    config = getConfig({
        "Max3PCBatchSize": batch_size,
        "Max3PCBatchWait": 0.05,
        "QuorumTickInterval": 0.1,
        "QuorumTickAdaptive": True,
        # net-mark fan-out cap (causal plane): the 3PC waves are O(n^2)
        # messages per batch at n=64+ — stamp deliveries into the first
        # 4 validators only, keeping per-wave latency stats
        # representative without flooding the ring
        "TraceNetReceivers": 4,
        # multi-tick device residency: > 1 keeps votes resident in
        # device-side ring slots across this many ticks before one fused
        # consume — same ordering, fewer host round-trips
        "ResidentTickDepth": max(resident_depth, 1),
    })
    # flight recorder on: the phase split below is what lets a later
    # record attribute a throughput regression to a phase instead of just
    # detecting it
    pool = SimPool(n_nodes=n_nodes, seed=11, config=config,
                   device_quorum=True, shadow_check=False,
                   num_instances=num_instances,
                   host_accounting=host_accounting,
                   pipelined_flush=True, mesh=mesh, trace=True,
                   host_eval=host_eval, device=dev)

    seq = 0

    def submit(count):
        nonlocal seq
        for _ in range(count):
            seq += 1
            pool.submit_request(seq)

    def min_ordered():
        return min(len(n.ordered_digests) for n in pool.nodes)

    def run_until(target, budget_s):
        # 0.1 sim-sec steps: sim_elapsed (the protocol-time bound) must
        # not be quantized by the bench loop's chunk size
        deadline = time.monotonic() + budget_s
        while min_ordered() < target and time.monotonic() < deadline:
            pool.run_for(0.1)
        return min_ordered()

    # warm-up: builds the kernels and fills every cache the measured run
    # will hit
    submit(batch_size)
    warm = run_until(batch_size, budget_s=240)
    assert warm >= batch_size, f"warm-up stalled at {warm}"

    if host_accounting:
        for name in pool.host_seconds:
            pool.host_seconds[name] = 0.0  # exclude warm-up/build time
    n_txns = batches * batch_size
    submit(n_txns)
    flushes0 = pool.vote_group.flushes  # exclude warm-up dispatches
    sim_t0 = pool.timer.get_current_time()
    t0 = time.perf_counter()
    got = run_until(batch_size + n_txns, budget_s=300)
    _sync(dev)
    elapsed = time.perf_counter() - t0
    sim_elapsed = pool.timer.get_current_time() - sim_t0
    ordered = got - batch_size
    assert pool.honest_nodes_agree()
    serial_tps = ordered / elapsed
    value = serial_tps
    # dispatch-plane digest: how hard the tick barrier amortized. The
    # occupancy avg covers the whole run (warm-up included — it is a
    # property of the workload shape, not of the timed window).
    from ..common.metrics_collector import MetricsName

    occ = pool.metrics.stat(MetricsName.DEVICE_FLUSH_OCCUPANCY)
    measured_dispatches = pool.vote_group.flushes - flushes0
    out = {
        "metric": metric,
        "value": round(value, 1),
        "unit": "txns/sec",
        "vs_baseline": round(
            value / ESTIMATED_REFERENCE_ORDERED_TXNS_PER_SEC_N64, 3),
        "baseline_note": note,
        "n_validators": n_nodes,
        "num_instances": num_instances,
        "txns_ordered": ordered,
        "wall_s": round(elapsed, 2),
        "device_flushes": pool.vote_group.flushes,
        "flush_occupancy": round(occ.avg, 4) if occ else None,
        # divide by the batches actually ordered: a budget-truncated run
        # (deliberately not asserted — the record must survive) must not
        # understate dispatches/batch
        "device_dispatches_per_ordered_batch": round(
            measured_dispatches / max(ordered / batch_size, 1e-9), 2),
        # agreement asserted above: the pool-ordering fingerprint (the
        # sharded cell compares runs on it)
        "ordered_hash": pool.ordered_hash(),
        "shards": pool.vote_group.shards,
        "mesh_shape": list(pool.vote_group.mesh_shape),
        # ordering fast path: what actually crossed the device->host
        # boundary — compact deltas ("device" eval, the default) vs the
        # full event matrix (host_eval fallback)
        "eval_mode": pool.vote_group.eval_mode,
        "readback_bytes_total": pool.vote_group.readback_bytes_total,
        "readback_bytes_per_readback": round(
            pool.vote_group.readback_bytes_total
            / max(pool.vote_group.readbacks, 1), 1),
        "readbacks": pool.vote_group.readbacks,
        "readback_overlap_fraction": round(
            pool.vote_group.readbacks_overlapped
            / max(pool.vote_group.readbacks, 1), 4),
        # multi-tick residency: ring depth + how many host readbacks the
        # resident window actually deferred (depth 1 = per-tick)
        "resident_depth": pool.vote_group.resident_depth,
        "resident_ticks": pool.vote_group.resident_ticks,
        "readbacks_deferred": pool.vote_group.readbacks_deferred,
    }
    # per-phase latency attribution (VIRTUAL protocol time): which 3PC
    # phase the ordered batches spent their latency in, and which phase
    # dominated
    from ..observability.trace import critical_path, phase_percentiles

    trace_events = pool.trace.events()
    out["phase_latency"] = phase_percentiles(trace_events)
    out["critical_path"] = critical_path(trace_events)
    # causal request journeys: client-observed e2e latency percentiles
    # with network/queue/compute/device attribution — the ground truth
    # the per-phase block approximates, byte-stable per seed
    # (journey_hash) like ordered_hash
    from ..observability.causal import journey_summary

    js = journey_summary(trace_events)
    out["e2e_latency"] = {
        "write": js["e2e"]["write"],
        "complete": js["complete"],
        "count": js["count"],
        "orphan_spans": js["orphan_spans"],
        "attribution_share": js["attribution_share"],
        "journey_hash": js["journey_hash"],
    }
    if mesh is not None:
        out["shard_occupancy"] = pool.vote_group.shard_occupancy
    if pool.governor is not None:
        # the adaptation record: tick-interval min/median/max + the
        # occupancy EWMA the control law settled on
        out["governor"] = pool.governor.trajectory_summary()
    if host_accounting:
        busiest = max(pool.host_seconds.values())
        per_host_tps = ordered / busiest if busiest > 0 else 0.0
        sim_tps = ordered / sim_elapsed if sim_elapsed > 0 else 0.0
        value = min(per_host_tps, sim_tps)
        out.update({
            "value": round(value, 1),
            "vs_baseline": round(
                value / ESTIMATED_REFERENCE_ORDERED_TXNS_PER_SEC_N64, 3),
            "serial_wall_txns_per_sec": round(serial_tps, 1),
            "per_host_cpu_bound_txns_per_sec": round(per_host_tps, 1),
            "protocol_time_txns_per_sec": round(sim_tps, 1),
            "busiest_host_cpu_s": round(busiest, 3),
            "sim_elapsed_s": round(sim_elapsed, 3),
            "accounting_note":
                "value = min(per-host CPU bound, protocol pipeline bound)."
                " The sim runs all %d hosts serially in ONE process"
                " (serial_wall is that raw number); per-host accounting"
                " charges each node its own message handling (incl. sends"
                " it triggers), its per-instance tick evaluation, and the"
                " FULL shared device flush (conservative: a deployed node"
                " flushes only its own %d-member plane). Excluded: the"
                " simulated network's timer-heap bookkeeping (a deployed"
                " node's transport loop is the zmq stack instead)."
                % (n_nodes, num_instances),
        })
    if num_instances > 1:
        out["backups_ordered_upto"] = min(
            b.data.last_ordered_3pc[1]
            for n in pool.nodes for b in n.replicas.backups)
    return out


def bench_ordered_txns_n64(device=None) -> dict:
    return _bench_ordered(
        64, 1, batches=10,
        metric="ordered_txns_per_sec_n64_device_quorum",
        note="reference publishes no numbers; vs 100 txns/sec CPU "
             "estimate at n=64 (BASELINE.md provenance)",
        device=device)


def bench_ordered_txns_n64_rbft(device=None) -> dict:
    """The TRUE RBFT north star: all f+1 protocol instances live, backup
    tallies on the device (node x instance) axis — what the reference
    actually runs, not just the master instance."""
    n = 64
    f_plus_1 = (n - 1) // 3 + 1
    return _bench_ordered(
        n, f_plus_1, batches=6,
        metric="ordered_txns_per_sec_n64_rbft_full_instances",
        note="full RBFT: f+1=%d parallel instances; vs the same 100 "
             "txns/sec CPU estimate (reference also pays the instance "
             "multiplier). See accounting_note for the capacity model "
             "behind value" % f_plus_1,
        host_accounting=True, device=device)


def bench_ordered_txns_n64_resident(device=None) -> dict:
    """The SAME n=64 ordered workload run per-tick vs with multi-tick
    device residency (depth-4 ring of device-side scatter slots,
    checkpoint slides folded into the fused consume). The digests must
    match bit-for-bit — residency changes WHEN the host looks at the
    device, never what the pool orders — and the metric is the resident
    arm's device dispatches per ordered batch (target: <= 1.0, vs ~1.5
    per-tick)."""
    depth = int(os.environ.get("BENCH_RESIDENT_DEPTH", "4"))
    per_tick = _bench_ordered(
        64, 1, batches=4,
        metric="ordered_txns_per_sec_n64_per_tick_for_resident_compare",
        note="per-tick arm of the residency comparison", device=device)
    resident = _bench_ordered(
        64, 1, batches=4,
        metric="ordered_txns_per_sec_n64_resident",
        note="depth-%d resident ring; vs the same 100 txns/sec CPU "
             "estimate as the 1-device n=64 bench" % depth,
        resident_depth=depth, device=device)
    assert resident["ordered_hash"] == per_tick["ordered_hash"], \
        "resident ordering diverged from the per-tick run"
    out = dict(resident)
    out["metric"] = "resident_n64_dispatches_per_ordered_batch"
    out["value"] = resident["device_dispatches_per_ordered_batch"]
    out["unit"] = ("device dispatches per ordered batch, n=64 with a "
                   "depth-%d resident ring (target <= 1.0)" % depth)
    out["vs_baseline"] = (
        round(resident["device_dispatches_per_ordered_batch"]
              / per_tick["device_dispatches_per_ordered_batch"], 3)
        if per_tick["device_dispatches_per_ordered_batch"] else None)
    out["baseline_note"] = (
        "vs_baseline = resident dispatches/ordered-batch over the "
        "per-tick figure (lower = the ring amortizes host round-trips);"
        " throughputs for both arms recorded alongside")
    out["digests_match_per_tick"] = True
    out["per_tick_txns_per_sec"] = per_tick["value"]
    out["per_tick_dispatches_per_ordered_batch"] = \
        per_tick["device_dispatches_per_ordered_batch"]
    out["resident_txns_per_sec"] = resident["value"]
    return out


def bench_ordered_txns_n64_sharded(device=None) -> dict:
    """The SAME n=64 ordered workload run twice on the same seed —
    grouped vote plane on one device vs mesh-sharded (member axis) over
    8 tiles. The digests must match bit-for-bit (sharding is a placement
    choice, never a semantics change — asserted, not assumed) and the
    record carries both throughputs so the sharding overhead/scaling is
    a tracked number.

    The tiles lie on the visible cards (``_mesh_tiles``): on one card
    every tile is on it (the one-state layout), over several cards one
    tile a card in turn (the per-tile layout)."""
    from ..tpu.quorum import make_fabric_mesh

    dev = resolve_device(device)
    tiles = _mesh_tiles(dev)
    n_dev = len(tiles)
    mesh = make_fabric_mesh(tiles, (n_dev,))
    single = _bench_ordered(
        64, 1, batches=4,
        metric="ordered_txns_per_sec_n64_single_for_sharded_compare",
        note="1-device arm of the sharded comparison", device=dev)
    sharded = _bench_ordered(
        64, 1, batches=4,
        metric="ordered_txns_per_sec_n64_mesh_sharded",
        note="mesh-sharded grouped vote plane (%d-tile member axis); vs "
             "the same 100 txns/sec CPU estimate as the 1-device n=64 "
             "bench" % n_dev,
        mesh=mesh, device=dev)
    assert sharded["ordered_hash"] == single["ordered_hash"], \
        "mesh-sharded ordering diverged from the 1-device run"
    out = dict(sharded)
    out["mesh_devices"] = n_dev
    out["mesh_layout"] = "per-tile" if mesh.split else "one-state"
    out["cards"] = len(set(tiles)) if dev.type == "cuda" else 0
    out["digests_match_single_device"] = True
    out["single_device_txns_per_sec"] = single["value"]
    out["sharded_vs_single_device"] = (
        round(sharded["value"] / single["value"], 3)
        if single["value"] else None)
    return out


def bench_fabric(device=None) -> dict:
    """The scale-out quorum fabric at n=256 on an 8-tile mesh. The SAME
    seeded n=256 workload runs three ways — 1 device, 1-axis member mesh
    (8,), 2-axis member x validator fabric (4, 2) — plus an n=64
    reference arm. The digests must match bit-for-bit across all three
    n=256 runs (the fabric is a placement choice) and the record carries
    dispatches/ordered-batch for the n=256 fabric vs the n=64 figure: the
    tick barrier's amortization must stay FLAT as the pool quadruples
    (the scale-out claim, recorded here). The tiles lie on the visible
    cards as ``sharded``'s do."""
    from ..tpu.quorum import make_fabric_mesh

    dev = resolve_device(device)
    devices = _mesh_tiles(dev)
    n, batches = 256, 2
    ref64 = _bench_ordered(
        64, 1, batches=batches,
        metric="ordered_txns_per_sec_n64_for_fabric_compare",
        note="n=64 reference arm of the fabric comparison", device=dev)
    single = _bench_ordered(
        n, 1, batches=batches,
        metric="ordered_txns_per_sec_n256_single_for_fabric_compare",
        note="1-device arm of the fabric comparison", device=dev)
    one_axis = _bench_ordered(
        n, 1, batches=batches,
        metric="ordered_txns_per_sec_n256_mesh_1axis",
        note="n=256 on the (8,) member mesh",
        mesh=make_fabric_mesh(devices, (8,)), device=dev)
    fabric = _bench_ordered(
        n, 1, batches=batches,
        metric="ordered_txns_per_sec_n256_fabric_4x2",
        note="n=256 on the (4, 2) member x validator fabric (quorum "
             "counts summed over the validator axis, per-shard "
             "pipelined readbacks)",
        mesh=make_fabric_mesh(devices, (4, 2)), device=dev)
    assert single["ordered_hash"] == one_axis["ordered_hash"] \
        == fabric["ordered_hash"], \
        "fabric ordering diverged across placements"
    # resident arm: the same fabric workload with the depth-N
    # device-resident ring — placement AND residency are both free
    res_depth = int(os.environ.get("BENCH_RESIDENT_DEPTH", "4"))
    resident = _bench_ordered(
        n, 1, batches=batches,
        metric="ordered_txns_per_sec_n256_fabric_4x2_resident",
        note="n=256 on the (4, 2) fabric with a depth-%d resident "
             "ring" % res_depth,
        mesh=make_fabric_mesh(devices, (4, 2)),
        resident_depth=res_depth, device=dev)
    assert resident["ordered_hash"] == fabric["ordered_hash"], \
        "resident fabric ordering diverged from the per-tick fabric run"
    out = dict(fabric)
    out["metric"] = "fabric_n256_dispatches_per_ordered_batch"
    out["value"] = fabric["device_dispatches_per_ordered_batch"]
    out["unit"] = ("device dispatches per ordered batch, n=256 on the "
                   "(4, 2) fabric (lower = the tick barrier still "
                   "amortizes at 4x the n=64 pool)")
    out["vs_baseline"] = (
        round(fabric["device_dispatches_per_ordered_batch"]
              / ref64["device_dispatches_per_ordered_batch"], 3)
        if ref64["device_dispatches_per_ordered_batch"] else None)
    out["baseline_note"] = (
        "vs_baseline = n=256 fabric dispatches/ordered-batch over the "
        "n=64 1-device figure (flat-scaling claim: ~1.0); throughputs "
        "for all four arms recorded alongside")
    out["mesh_shape"] = fabric["mesh_shape"]
    out["digests_match_across_placements"] = True
    out["n64_reference"] = {
        k: ref64[k] for k in ("value", "device_dispatches_per_ordered_batch",
                              "flush_occupancy")}
    out["n256_single_device_txns_per_sec"] = single["value"]
    out["n256_one_axis_txns_per_sec"] = one_axis["value"]
    out["n256_fabric_txns_per_sec"] = fabric["value"]
    out["digests_match_resident"] = True
    out["resident_depth"] = resident["resident_depth"]
    out["resident_ticks"] = resident["resident_ticks"]
    out["readbacks_deferred"] = resident["readbacks_deferred"]
    out["n256_resident_txns_per_sec"] = resident["value"]
    out["n256_resident_dispatches_per_ordered_batch"] = \
        resident["device_dispatches_per_ordered_batch"]
    return out


def _run_laned(lanes: int, n_per_lane: int, txns_per_lane: int,
               seed: int, device=None) -> dict:
    """One laned arm: K full n-validator ordering lanes (each its own
    master-instance vote plane group, tick-batched, adaptive governor)
    under the cross-lane checkpoint barrier. Throughput is ordered
    txns per SIM second (protocol time): the lanes run concurrently on
    the shared virtual clock, so K independent pipelines at the same
    per-lane rate is exactly the horizontal write scaling the bench
    measures — wall time runs all K*n validators serially in one
    process and says nothing about a deployed pool."""
    from ..config import getConfig
    from ..lanes import LanedPool
    from ..observability.causal import journey_summary

    dev = resolve_device(device)
    batch_size = 16
    config = getConfig({
        "Max3PCBatchSize": batch_size,
        "Max3PCBatchWait": 0.05,
        # small checkpoint windows so the barrier seals MANY times
        # inside the measured run — the thing being benched is lanes
        # under the barrier, not lanes in open air
        "CHK_FREQ": 2,
        "LOG_SIZE": 6,
        "QuorumTickInterval": 0.1,
        "QuorumTickAdaptive": True,
        "TraceNetReceivers": 4,
    })
    pool = LanedPool(lanes=lanes, n_nodes=n_per_lane, seed=seed,
                     config=config, device_quorum=True, trace=True,
                     device=dev)
    seq = [0]

    def submit(count):
        for _ in range(count):
            pool.submit_request(seq[0])
            seq[0] += 1

    def run_until(target, budget_s):
        deadline = time.monotonic() + budget_s
        while pool.ordered_total() < target \
                and time.monotonic() < deadline:
            pool.run_for(0.1)
        return pool.ordered_total()

    # warm-up: builds the kernels and the shapes the arms share
    warm = batch_size * lanes
    submit(warm)
    got = run_until(warm, budget_s=420)
    assert got >= warm, f"lanes={lanes} warm-up stalled at {got}"

    total = txns_per_lane * lanes
    sim_t0 = pool.timer.get_current_time()
    t0 = time.perf_counter()
    submit(total)
    got = run_until(warm + total, budget_s=600)
    _sync(dev)
    wall = time.perf_counter() - t0
    sim_elapsed = pool.timer.get_current_time() - sim_t0
    assert got >= warm + total, \
        f"lanes={lanes} stalled at {got}/{warm + total}"
    assert pool.honest_nodes_agree()
    # drive every lane to a sealed boundary so each journey's window
    # seals (the barrier-hop coverage below is asserted over ALL of
    # them) — outside the timed window on purpose
    pads = pool.seal_flush()
    js = journey_summary(pool.trace.events())
    lanes_js = js.get("lanes") or {}
    return {
        "lanes": lanes,
        "n_per_lane": n_per_lane,
        "txns_ordered": total,
        "ordered_per_sim_sec": round(total / sim_elapsed, 1),
        "sim_elapsed_s": round(sim_elapsed, 3),
        "wall_s": round(wall, 2),
        "router_distribution": list(pool.router.distribution),
        "ordered_hash_per_lane": pool.ordered_hashes(),
        "sealed_window": pool.barrier.sealed_window,
        "sealed_fingerprint": pool.sealed_fingerprint,
        "seal_pads": pads,
        "journey_hash": js["journey_hash"],
        "journeys": {
            "count": js["count"],
            "complete": js["complete"],
            "orphan_spans": js["orphan_spans"],
            "with_lane": lanes_js.get("with_lane", 0),
            "with_barrier_hop": lanes_js.get("with_barrier_hop", 0),
            "e2e_per_lane_p99": {
                lane: block["p99"] for lane, block in sorted(
                    (lanes_js.get("e2e_per_lane") or {}).items())},
        },
    }


def bench_lanes(device=None) -> dict:
    """Multi-lane ordering: ordered txns per sim-second at 1 / 2 / 4
    lanes, n=64 validators PER LANE, every arm under the cross-lane
    checkpoint barrier with small windows. Asserted here (not just
    recorded): 4-lane throughput >= 3.0x the 1-lane arm, the 4-lane
    replay byte-identical (per-lane ordered_hashes, the sealed
    fingerprint chain tip, journey_hash), zero orphan journeys, and
    every journey naming its lane and carrying the barrier hop."""
    n = 64
    arms = {k: _run_laned(k, n, txns_per_lane=96, seed=17, device=device)
            for k in (1, 2, 4)}
    replay = _run_laned(4, n, txns_per_lane=96, seed=17, device=device)
    four = arms[4]
    assert replay["ordered_hash_per_lane"] == four["ordered_hash_per_lane"], \
        "4-lane per-lane ordered hashes diverge across same-seed runs"
    assert replay["sealed_fingerprint"] == four["sealed_fingerprint"], \
        "sealed-window fingerprint diverges across same-seed runs"
    assert replay["journey_hash"] == four["journey_hash"], \
        "journey tables diverge across same-seed runs"
    for k, arm in arms.items():
        j = arm["journeys"]
        assert j["orphan_spans"] == 0, (k, j)
        assert j["complete"] == j["count"], (k, j)
        assert j["with_lane"] == j["count"], (k, j)
        assert j["with_barrier_hop"] == j["count"], (k, j)
    speedup_2 = arms[2]["ordered_per_sim_sec"] / arms[1]["ordered_per_sim_sec"]
    speedup_4 = four["ordered_per_sim_sec"] / arms[1]["ordered_per_sim_sec"]
    assert speedup_4 >= 3.0, \
        f"4-lane speedup {speedup_4:.2f} below the 3.0x floor"
    return {
        "metric": "lanes_ordered_txns_per_sim_sec_n64_per_lane",
        # headline: the 4-lane protocol-time rate; vs_baseline = the
        # measured fraction of perfectly linear 4-way scaling
        "value": four["ordered_per_sim_sec"],
        "unit": "txns/sim-sec",
        "vs_baseline": round(speedup_4 / 4.0, 3),
        "baseline_note": "vs_baseline = (4-lane / 1-lane ordered per "
                         "sim-sec) / 4 — the fraction of linear write "
                         "scaling the barrier + router skew leave; "
                         "floor asserted: speedup_4 >= 3.0",
        "speedup_2_lanes": round(speedup_2, 3),
        "speedup_4_lanes": round(speedup_4, 3),
        # [tps1, tps2, tps4, speedup4] — the compact extras digest row
        "lane_scaling": [arms[1]["ordered_per_sim_sec"],
                         arms[2]["ordered_per_sim_sec"],
                         four["ordered_per_sim_sec"],
                         round(speedup_4, 3)],
        "replay_identical": True,
        "arms": {str(k): arm for k, arm in arms.items()},
    }


def bench_ordered_txns_n100(device=None) -> dict:
    return _bench_ordered(
        100, 1, batches=5,
        metric="ordered_txns_per_sec_n100_device_quorum",
        note="n=100 with tick-batched device quorum; vs the same 100 "
             "txns/sec CPU estimate (folklore is for <=64 nodes; at "
             "n=100 the reference's O(n^2) host tallies only get worse)",
        host_accounting=True, device=device)


def bench_catchup_proofs(device=None) -> dict:
    """BASELINE config 5: audit-path proofs verified/sec at >=100k txns.
    vs_baseline is the host scalar verifier measured on this same machine."""
    import numpy as np
    import torch

    from ..ledger.compact_merkle_tree import CompactMerkleTree
    from ..ledger.merkle_verifier import STH, MerkleVerifier
    from ..server.catchup.catchup_rep_service import (
        pack_audit_batch,
        verify_audit_paths_batch,
    )
    from ..tpu.sha256 import verify_audit_paths_indexed

    dev = resolve_device(device)
    tree_size = 131072
    batch = 16384
    rng = np.random.RandomState(5)
    leaves = [rng.bytes(64) for _ in range(tree_size)]
    tree = CompactMerkleTree()
    tree.extend(leaves)
    root = tree.root_hash

    # a CATCHUP_REP covers a consecutive txn range — the shape the node
    # dedup in verify_audit_paths_batch is designed for
    start = 57344
    idxs = list(range(start, start + batch))
    data = [leaves[i] for i in idxs]
    paths = [tree.audit_path(i, tree_size) for i in idxs]

    # warmup (the kernel library's build) is the untimed first call
    # inside _timed_reps
    spread, median = _timed_reps(lambda: verify_audit_paths_batch(
        data, idxs, paths, tree_size, root, device=dev), dev)
    ok = verify_audit_paths_batch(data, idxs, paths, tree_size, root,
                                  device=dev)
    assert ok.all(), "audit-path batch failed verification"
    value = batch / median

    # kernel-only: pre-packed + device-resident args, pure verify time
    # (end-to-end above additionally pays host packing + the host->device
    # transfer)
    packed = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                   for a in pack_audit_batch(data, idxs, paths,
                                             tree_size, root))
    kspread, kmedian = _timed_reps(
        lambda: verify_audit_paths_indexed(*packed), dev)
    assert verify_audit_paths_indexed(*packed).cpu().numpy()[:batch].all()
    kernel_value = batch / kmedian

    # honest same-machine host baseline over a sample, scaled
    sample = 512
    v = MerkleVerifier()
    sth = STH(tree_size=tree_size, sha256_root_hash=root)
    t0 = time.perf_counter()
    for d, i, p in zip(data[:sample], idxs[:sample], paths[:sample]):
        assert v.verify_leaf_inclusion(d, i, p, sth)
    host_per_sec = sample / (time.perf_counter() - t0)
    return {
        "metric": "catchup_audit_proofs_per_sec",
        "value": round(value, 1),
        "unit": "proofs/sec (end-to-end: packing + transfer + verify)",
        # vs_baseline keeps its meaning (end-to-end / host) so records
        # stay comparable; the kernel-only ratio gets its own field
        "vs_baseline": round(value / host_per_sec, 3),
        "kernel_vs_host": round(kernel_value / host_per_sec, 3),
        "baseline_note": "vs_baseline = end-to-end vs the host scalar "
                         f"verifier on this machine ({round(host_per_sec, 1)}"
                         "/sec, SHA-NI); kernel_vs_host compares the device "
                         f"kernel ({round(kernel_value, 1)}/sec, device-"
                         "resident args) to the same host verifier. "
                         "End-to-end additionally pays host packing and the "
                         "host-to-device transfer; see "
                         "catchup_offload_ordered_txns_ratio for what that "
                         "means in a live node loop",
        "kernel_proofs_per_sec": round(kernel_value, 1),
        "kernel_spread": kspread,
        "tree_size": tree_size,
        "batch": batch,
        "spread": spread,
    }


def _catchup_offload(tree_size: int = 131072, slice_size: int = 16384,
                     device=None):
    """``bench_catchup_offload``'s body: its record, and for each mode
    the pool's ``ordered_hash``, the requests ordered past the warm-up
    and the slices verified (the seeded, virtual-clock side of the run,
    for checks that compare runs)."""
    import numpy as np

    from ..config import getConfig
    from ..ledger.compact_merkle_tree import CompactMerkleTree
    from ..ledger.merkle_verifier import STH, MerkleVerifier
    from ..server.catchup.catchup_rep_service import (
        dispatch_audit_paths_batch,
        verify_audit_paths_batch,
    )
    from ..simulation.pool import SimPool

    dev = resolve_device(device)
    rng = np.random.RandomState(5)
    leaves = [rng.bytes(64) for _ in range(tree_size)]
    tree = CompactMerkleTree()
    tree.extend(leaves)
    root = tree.root_hash
    slices = []
    for start in range(0, tree_size, slice_size):
        idxs = list(range(start, start + slice_size))
        slices.append((
            [leaves[i] for i in idxs], idxs,
            [tree.audit_path(i, tree_size) for i in idxs]))

    verifier = MerkleVerifier()
    sth = STH(tree_size=tree_size, sha256_root_hash=root)
    arms = {}

    def run_mode(mode: str, seed: int) -> float:
        """Ordered txns/sec while ALL slices get verified, interleaved
        with the ordering loop (one slice per loop iteration — the shape
        of CatchupRep processing in a live node)."""
        n_nodes, batch_size = 16, 80
        config = getConfig({
            "Max3PCBatchSize": batch_size,
            "Max3PCBatchWait": 0.05,
            "QuorumTickInterval": 0.1,
        })
        pool = SimPool(n_nodes=n_nodes, seed=seed, config=config,
                       device_quorum=True, shadow_check=False, device=dev)
        for i in range(batch_size):
            pool.submit_request(i)
        deadline = time.monotonic() + 240
        while min(len(n.ordered_digests) for n in pool.nodes) < batch_size \
                and time.monotonic() < deadline:
            pool.run_for(0.5)  # the warm-up batch builds the n=16 shapes
        if mode != "host":  # warm the verify kernel outside timing
            assert verify_audit_paths_batch(
                *slices[0][:3], tree_size, root, device=dev).all()
        if mode == "auto":
            from ..server.catchup.catchup_rep_service import OFFLOAD_POLICY

            OFFLOAD_POLICY.host_ns = OFFLOAD_POLICY.dev_ns = None
            OFFLOAD_POLICY._batches = 0  # fresh policy per measured run

        n_txns = 4 * batch_size
        for i in range(batch_size, batch_size + n_txns):
            pool.submit_request(i)
        pending = list(slices)
        inflight = None  # the production pipeline: dispatch async, keep
        # ordering, resolve on the next loop pass (CatchupRepService shape)
        done = 0
        t0 = time.perf_counter()
        target = batch_size + n_txns
        while (min(len(n.ordered_digests) for n in pool.nodes) < target
               or pending or inflight) and time.monotonic() < deadline:
            pool.run_for(0.25)
            if inflight is not None:
                verdict = inflight()
                if verdict is not None:  # chunked: None = pump again
                    assert verdict.all()
                    inflight = None
                    done += 1
            if pending and inflight is None:
                data, idxs, paths = pending.pop(0)
                if mode == "host":
                    for d, i, p in zip(data, idxs, paths):
                        assert verifier.verify_leaf_inclusion(d, i, p, sth)
                    done += 1
                else:  # "device" (forced) or "auto" (the measured policy)
                    inflight = dispatch_audit_paths_batch(
                        data, idxs, paths, tree_size, root, mode=mode,
                        device=dev)
        _sync(dev)
        elapsed = time.perf_counter() - t0
        ordered = min(len(n.ordered_digests)
                      for n in pool.nodes) - batch_size
        assert done == len(slices), "catchup stream did not finish"
        assert ordered >= n_txns, "ordering starved"
        arms[mode] = {"ordered_hash": pool.ordered_hash(),
                      "ordered": ordered, "slices": done}
        return ordered / elapsed

    host_tps = run_mode("host", seed=21)
    device_tps = run_mode("device", seed=21)
    auto_tps = run_mode("auto", seed=21)
    ratio = auto_tps / host_tps
    return {
        "metric": "catchup_offload_ordered_txns_ratio",
        "value": round(ratio, 3),
        "unit": "x ordered throughput during a %d-proof catchup "
                "(the node's MEASURED auto-select / forced host-verify)"
                % tree_size,
        "vs_baseline": round(ratio, 3),
        "baseline_note": "host-verify is the reference's shape (scalar "
                         "proof checks on the protocol thread): "
                         f"{round(host_tps, 1)} txns/sec; forced device "
                         f"offload: {round(device_tps, 1)} txns/sec; "
                         f"measured auto-select: {round(auto_tps, 1)} "
                         "txns/sec. The node compares host-blocking time "
                         "per proof for both modes from live traffic and "
                         "keeps whichever blocks the loop less, probing "
                         "the loser periodically — on a link where the "
                         "offload can't win, value converges to ~1.0 by "
                         "construction and the device_vs_host field "
                         "records how far the forced offload fell short",
        "device_vs_host": round(device_tps / host_tps, 3),
        "n_validators": 16,
        "proofs": tree_size,
    }, arms


def bench_catchup_offload(device=None, tree_size: int = 131072,
                          slice_size: int = 16384) -> dict:
    """Ordered txns/sec WHILE a 131072-proof catchup verify stream shares
    the single-threaded node loop — host-scalar verify vs device-batched
    verify. The device path is an offload; this quantifies what it
    frees."""
    return _catchup_offload(tree_size, slice_size, device)[0]


def bench_catchup_e2e(device=None) -> dict:
    """End-to-end leecher round through the live pool (the chaos-hardened
    catchup plane): a node misses a range spanning multiple stabilized —
    and GC'd — checkpoint windows, reconnects, and leeches it back with
    every batch audit-proof verified (the mode='auto' offload policy
    picks host or device per measured host-blocking cost). Headline:
    leeched txns/sec over the whole recovery arc (gap detection, quorum
    target, fetch, verify, state rebuild, 3PC resync); vs_baseline is
    recovery speed relative to the SAME pool's live ordering rate —
    catchup must outrun ordering or a lagging node can never rejoin."""
    from ..common.constants import DOMAIN_LEDGER_ID
    from ..config import getConfig
    from ..simulation.pool import SimPool

    dev = resolve_device(device)
    config = getConfig({
        "Max3PCBatchSize": 10,
        "Max3PCBatchWait": 0.1,
        "CHK_FREQ": 10,
        "LOG_SIZE": 30,
        "ConsistencyProofsTimeout": 1.0,
        "CatchupRequestTimeout": 1.5,
    })
    pool = SimPool(4, seed=31, real_execution=True, config=config,
                   device=dev)

    def domain_size(name):
        return pool.node(name).boot.db.get_ledger(DOMAIN_LEDGER_ID).size

    def order_until(target, budget_s=600.0):
        deadline = time.monotonic() + budget_s
        while min(domain_size(n.name) for n in pool.nodes
                  if n.name != "node3") < target \
                and time.monotonic() < deadline:
            pool.run_for(0.5)

    warm = 30
    for i in range(warm):
        pool.submit_request(i)
    order_until(warm + 1)  # +1 genesis txn

    pool.network.disconnect("node3")
    missed = 150
    sim0 = pool.timer.get_current_time()
    for i in range(warm, warm + missed):
        pool.submit_request(i)
    order_until(warm + missed + 1)
    ordering_sim = pool.timer.get_current_time() - sim0
    honest_size = domain_size("node0")
    behind = pool.node("node3")
    assert domain_size("node3") < honest_size, "node3 not behind"

    pool.network.reconnect("node3")
    leecher = behind.leecher
    stats0 = leecher.catchup_stats()
    t0 = time.perf_counter()
    sim0 = pool.timer.get_current_time()
    leecher.start()
    deadline = time.monotonic() + 600
    while domain_size("node3") < honest_size \
            and time.monotonic() < deadline:
        pool.run_for(0.5)
    _sync(dev)
    catchup_wall = time.perf_counter() - t0
    catchup_sim = pool.timer.get_current_time() - sim0
    stats = leecher.catchup_stats()
    leeched = stats["txns_leeched"] - stats0["txns_leeched"]
    proofs = stats["proofs_verified"] - stats0["proofs_verified"]
    assert domain_size("node3") == honest_size, "catchup incomplete"
    assert leeched >= missed, (leeched, missed)
    assert proofs >= leeched, "an applied batch was not proof-verified"
    roots = {n.name: n.boot.db.get_ledger(DOMAIN_LEDGER_ID).root_hash
             for n in pool.nodes}
    assert len(set(roots.values())) == 1, "roots diverge after catchup"

    # protocol-time throughput (virtual clock) is the comparable figure
    # for a simulated pool — the same basis the budget gates' ordered/
    # sim-sec numbers use; wall figures ride along for this host
    leeched_per_sim_sec = leeched / catchup_sim if catchup_sim else 0.0
    ordering_sim_tps = missed / ordering_sim if ordering_sim else 0.0
    from ..server.catchup.catchup_rep_service import OFFLOAD_POLICY

    return {
        "metric": "catchup_e2e_leeched_txns_per_sec",
        "value": round(leeched_per_sim_sec, 1),
        "unit": "txns/sim-sec leeched+verified end-to-end",
        "vs_baseline": round(leeched_per_sim_sec / ordering_sim_tps, 3)
        if ordering_sim_tps else 0.0,
        "baseline_note": "vs_baseline compares recovery speed to the "
                         "SAME pool's live ordering rate "
                         f"({round(ordering_sim_tps, 1)} txns/sim-sec "
                         "while node3 was down) — a lagging node can "
                         "only rejoin if catchup outruns ordering",
        "verified_proofs_per_sim_sec": round(proofs / catchup_sim, 1)
        if catchup_sim else 0.0,
        "leeched_txns_per_wall_sec": round(leeched / catchup_wall, 1)
        if catchup_wall else 0.0,
        "txns_leeched": leeched,
        "proofs_verified": proofs,
        "retries": stats["retries"] - stats0["retries"],
        "offload_mode": ("device" if (OFFLOAD_POLICY.dev_ns or 0)
                         and (OFFLOAD_POLICY.host_ns or 0)
                         and OFFLOAD_POLICY.dev_ns < OFFLOAD_POLICY.host_ns
                         else "host"),
        "catchup_sim_s": round(catchup_sim, 2),
        "catchup_wall_s": round(catchup_wall, 2),
        "ordering_sim_s": round(ordering_sim, 2),
    }


def _run_saturation(serve_reads: bool, seed: int = 29, n_nodes: int = 16,
                    n_keys: int = 16384, duration: float = 1.5,
                    device=None) -> dict:
    """One saturation arm: open-loop seeded workload beyond the service
    rate into a bounded admission queue, tick-batched device quorum,
    flight recorder on. ``serve_reads`` answers the read mix through the
    device-proof ReadService (the no-reads arm consumes the SAME RNG
    stream, so both arms submit the identical write sequence — the
    ordered_hash / dispatch-count comparison is exact)."""
    from ..common.metrics_collector import MetricsName
    from ..config import getConfig
    from ..ingress import (
        ReadService,
        StaticCorpusBacking,
        WorkloadGenerator,
        WorkloadSpec,
    )
    from ..simulation.pool import SimPool

    dev = resolve_device(device)
    batch_size, capacity = 80, 24
    config = getConfig({
        "Max3PCBatchSize": batch_size,
        "Max3PCBatchWait": 0.05,
        "QuorumTickInterval": 0.1,
        "QuorumTickAdaptive": True,
        "IngressQueueCapacity": capacity,
    })
    pool = SimPool(n_nodes=n_nodes, seed=seed, config=config,
                   device_quorum=True, shadow_check=False,
                   sign_requests=True, trace=True, trace_capacity=1 << 20,
                   device=dev)
    reads = None
    if serve_reads:
        reads = ReadService(StaticCorpusBacking(n_keys, seed=seed),
                            clock=pool.timer.get_current_time,
                            metrics=pool.metrics, trace=pool.trace,
                            device=dev)

    def min_ordered():
        return min(len(nd.ordered_digests) for nd in pool.nodes)

    # warm-up: two sub-capacity waves build the vote-plane and auth
    # shapes the saturated run will hit; reads warm the proof path and
    # the offload policy's calibration
    warm_n = capacity - 14
    for i in range(warm_n):
        pool.submit_request(1_000_000 + i, client_id="warm")
    pool.timer.schedule(1.0, lambda: [
        pool.submit_request(1_100_000 + i, client_id="warm")
        for i in range(warm_n)])
    deadline = time.monotonic() + 300
    while min_ordered() < 2 * warm_n and time.monotonic() < deadline:
        pool.run_for(0.5)
    assert min_ordered() >= 2 * warm_n, "saturation warm-up stalled"
    if reads is not None:
        for _ in range(3):
            for i in range(600):
                reads.submit(i * 7)
            reads.drain()
        reads.reset_serve_meters()

    # the open-loop window: a short hard burst whose wide-tick arrival
    # cohorts (~80/tick at the 0.1s starting interval) overrun the
    # 24-slot queue, so the shed policy and the governor's backpressure
    # narrowing both engage before the narrowed tick catches up
    seq = [0]

    def on_write(client, key):
        seq[0] += 1
        pool.submit_request(seq[0], client_id="c%d" % client)

    gen = WorkloadGenerator(WorkloadSpec(
        n_clients=1_000_000, rate=1600.0, duration=duration,
        read_fraction=0.5, zipf_clients=1.1, zipf_keys=1.2,
        n_keys=n_keys, seed=seed))
    gen.start(pool.timer, on_write,
              on_read=((lambda client, key: reads.submit(key))
                       if reads is not None else None))

    flushes0 = pool.vote_group.flushes
    ordered0 = min_ordered()
    sim_t0 = pool.timer.get_current_time()
    t0 = time.perf_counter()
    elapsed_sim = 0.0
    deadline = time.monotonic() + 300
    while (elapsed_sim < 24.0 or pool.admission.depth) \
            and time.monotonic() < deadline:
        pool.run_for(0.5)
        elapsed_sim += 0.5
        if reads is not None:
            reads.drain()  # bench-loop serving: zero 3PC involvement
    _sync(dev)
    wall_s = time.perf_counter() - t0
    sim_elapsed = pool.timer.get_current_time() - sim_t0
    assert pool.honest_nodes_agree()
    ordered = min_ordered() - ordered0

    if reads is not None:
        # a dedicated measured burst pins the read-rate number on a
        # decent sample (the generator's read mix alone is small)
        import numpy as np

        rng = np.random.RandomState(seed)
        burst = ((rng.zipf(1.2, 20000) - 1) % n_keys).tolist()
        for lo in range(0, len(burst), 600):
            for k in burst[lo:lo + 600]:
                reads.submit(k)
            replies = reads.drain()
            assert all(r.verified for r in replies)

    adm = pool.admission
    occ = pool.metrics.stat(MetricsName.DEVICE_FLUSH_OCCUPANCY)
    from ..observability.trace import critical_path, phase_percentiles

    events = pool.trace.events()
    phases = phase_percentiles(events)
    from ..observability.causal import journey_summary

    js = journey_summary(events)
    return {
        "ordered": ordered,
        # causal journeys under saturation: what an ADMITTED request's
        # end-to-end latency looked like while the shed law and the
        # governor's backpressure narrowing were both engaged — plus
        # the proof-read e2e when this arm served reads
        "e2e_latency": {
            "write": js["e2e"]["write"],
            "read": js["e2e"]["read"],
            "complete": js["complete"],
            "count": js["count"],
            "shed": js["shed"],
            "attribution_share": js["attribution_share"],
            "journey_hash": js["journey_hash"],
        },
        "wall_s": wall_s,
        "sim_elapsed_s": sim_elapsed,
        "workload": gen.counters(),
        "admission": adm.counters(),
        "shed_fraction": round(adm.shed_total
                               / max(adm.offered_total, 1), 4),
        "shed_hash": adm.shed_hash(),
        "ordered_hash": pool.ordered_hash(),
        "device_flushes": pool.vote_group.flushes - flushes0,
        "flush_occupancy": round(occ.avg, 4) if occ else None,
        "ingress_to_finalised": phases.get("auth"),
        "phase_latency": phases,
        "critical_path": critical_path(events),
        "governor": (pool.governor.trajectory_summary()
                     if pool.governor is not None else None),
        # counters() carries the VIRTUAL-clock read_qps (deterministic
        # per seed); the wall-throughput number the headline wants rides
        # alongside, straight off the wall meter
        "reads": dict(reads.counters(), read_proofs_per_wall_sec=round(
            reads.served_total / reads.serve_wall_s, 1)
            if reads.serve_wall_s else 0.0)
        if reads is not None else None,
    }


def _run_overload(retry: bool, seed: int = 37, device=None) -> dict:
    """One flash-crowd arm (overload robustness plane): a steady
    sub-saturation base rate with a hard crowd spike in the middle,
    reads served through the proof path throughout. ``retry`` arms the
    closed loop (seeded-backoff re-offers of everything shed) — the arm
    real overload actually looks like; the open-loop arm is the
    comparison baseline. Both arms consume the identical RNG stream, so
    goodput/recovery comparisons are exact. Measured per arm: ordered
    rate BEFORE the spike vs AFTER it ends (metastable collapse would
    show as a post-spike rate that never recovers), unique-request
    goodput, the first-attempt vs retry admission split, and the
    shed/retry/ordered fingerprints the overload gate replays."""
    from ..common.metrics_collector import MetricsName
    from ..config import getConfig
    from ..ingress import (
        ReadService,
        StaticCorpusBacking,
        WorkloadGenerator,
        WorkloadProfile,
        WorkloadSpec,
    )
    from ..simulation.pool import SimPool

    dev = resolve_device(device)
    # capacity 12 against a 800/s spike: even at the governor's tick
    # floor (0.025s -> 20 arrivals/tick) the crowd overflows the queue,
    # so the shed law + retry storm genuinely engage; the 100/s base
    # rate drains comfortably
    n_nodes, capacity, n_keys = 8, 12, 4096
    base_rate, duration = 100.0, 9.0
    flash_at, flash_dur, peak = 3.0, 1.5, 8.0
    warm = capacity - 8
    config = getConfig({
        "Max3PCBatchSize": 40,
        "Max3PCBatchWait": 0.05,
        "QuorumTickInterval": 0.1,
        "QuorumTickAdaptive": True,
        "IngressQueueCapacity": capacity,
        "IngressRetryMax": 4 if retry else 0,
        "IngressRetryBase": 0.2,
        "IngressRetryBackoffMult": 2.0,
        "IngressRetryBackoffMax": 2.0,
    })
    pool = SimPool(n_nodes=n_nodes, seed=seed, config=config,
                   device_quorum=True, shadow_check=False,
                   sign_requests=True, trace=True,
                   trace_capacity=1 << 20, device=dev)
    reads = ReadService(StaticCorpusBacking(n_keys, seed=seed),
                        clock=pool.timer.get_current_time,
                        metrics=pool.metrics, trace=pool.trace, device=dev)
    # warm-up outside the measured window: a sub-capacity ordered wave +
    # one read drain build the shapes the arms will hit
    for i in range(warm):
        pool.submit_request(2_000_000 + i, client_id="warm")
    deadline = time.monotonic() + 300
    while min(len(nd.ordered_digests) for nd in pool.nodes) \
            < warm and time.monotonic() < deadline:
        pool.run_for(0.5)
    assert min(len(nd.ordered_digests) for nd in pool.nodes) >= warm, \
        "overload warm-up stalled"
    for i in range(64):
        reads.submit(i)
    reads.drain()
    reads.reset_serve_meters()

    def min_ordered():
        return min(len(nd.ordered_digests) for nd in pool.nodes)

    seq = [0]

    def on_write(client, key):
        seq[0] += 1
        pool.submit_request(seq[0], client_id="c%d" % client)

    gen = WorkloadGenerator(WorkloadSpec(
        n_clients=250_000, rate=base_rate, duration=duration,
        read_fraction=0.25, n_keys=n_keys, seed=seed,
        profile=WorkloadProfile(kind="flash", peak=peak,
                                flash_at=flash_at,
                                flash_duration=flash_dur)))
    gen.start(pool.timer, on_write,
              on_read=lambda client, key: reads.submit(key))

    ordered0 = min_ordered()
    sim_t0 = pool.timer.get_current_time()
    wall_t0 = time.perf_counter()
    samples = {}  # sim instant -> ordered count (rate windows below)
    marks = (1.0, flash_at, flash_at + flash_dur, 6.5, duration)
    elapsed = 0.0
    deadline = time.monotonic() + 600
    # run through the arrival window, then settle until the queue AND
    # the retry storm drain (outstanding re-offers included)
    while (elapsed < duration + 8.0 or pool.admission.depth
           or (pool.retry is not None and pool.retry.outstanding)) \
            and time.monotonic() < deadline:
        pool.run_for(0.5)
        elapsed += 0.5
        reads.drain()
        for m in marks:
            if m <= elapsed and m not in samples:
                samples[m] = min_ordered()
    _sync(dev)
    wall_s = time.perf_counter() - wall_t0
    sim_elapsed = pool.timer.get_current_time() - sim_t0
    assert pool.honest_nodes_agree()
    ordered = min_ordered() - ordered0

    adm = pool.admission
    # a wall-deadline exit can leave late marks unsampled — fill them
    # with the final count so the record degrades to skewed rates (the
    # gate's floors then fail loudly) instead of a KeyError
    for m in marks:
        samples.setdefault(m, min_ordered())
    # rate windows: pre-spike [1, flash_at]; post-spike [6.5, duration]
    # (base arrivals still flowing, spike backlog drained) — recovery is
    # post/pre, the no-metastable-collapse number
    pre_rate = (samples[flash_at] - samples[1.0]) / (flash_at - 1.0)
    post_rate = (samples[duration] - samples[6.5]) / (duration - 6.5)
    retry_counters = pool.retry.counters() if pool.retry else None
    readmitted = pool.metrics.stat(MetricsName.INGRESS_RETRY_ADMITTED)
    readmitted_n = int(readmitted.total) if readmitted else 0
    # normalize the warm-up wave out of the admission record (it was
    # never part of the measured crowd — the overload gate's arm does
    # the same subtraction)
    adm_counters = adm.counters()
    adm_counters["offered"] -= warm
    adm_counters["admitted"] -= warm
    return {
        "retry": bool(retry),
        "arrivals": gen.counters(),
        "admission": adm_counters,
        "shed_fraction": round(adm.shed_total
                               / max(adm_counters["offered"], 1), 4),
        "ordered": ordered,
        "ordered_per_sim_second": round(ordered / sim_elapsed, 2),
        "pre_spike_rate": round(pre_rate, 2),
        "post_spike_rate": round(post_rate, 2),
        "recovery_ratio": round(post_rate / pre_rate, 3)
        if pre_rate else None,
        # the goodput split: admissions that needed >= 1 retry vs
        # first-attempt admissions (warm-up excluded on both sides)
        "retry_admitted": readmitted_n,
        "first_attempt_admitted": adm_counters["admitted"] - readmitted_n,
        "retries": retry_counters,
        "retry_hash": pool.retry.retry_hash() if pool.retry else None,
        "shed_hash": adm.shed_hash(),
        "ordered_hash": pool.ordered_hash(),
        "read_proofs_per_sec": round(
            reads.served_total / reads.serve_wall_s, 1)
        if reads.serve_wall_s else 0.0,
        "reads_verified": reads.verified_total,
        "governor": (pool.governor.trajectory_summary()
                     if pool.governor is not None else None),
        "sim_elapsed_s": round(sim_elapsed, 2),
        "wall_s": round(wall_s, 2),
    }


def bench_saturation(device=None) -> dict:
    """Ingress-plane saturation: the seeded open-loop population drives
    n=16 BEYOND its service rate through the bounded admission queue,
    while the device-proof read path serves the read mix outside the 3PC
    plane. Run twice on the same seed — reads served vs reads dropped —
    to PROVE reads are free: identical ordered_hash, identical
    vote-plane dispatch count.

    The flash-crowd block (overload robustness plane) adds the
    closed-loop arms: the same seeded crowd spike run open-loop (shed
    requests walk away) vs with per-client seeded-backoff retries (shed
    requests come BACK — how real overload compounds), measuring goodput
    under the storm, the first-attempt/retry admission split, and the
    post-spike recovery rate that proves no metastable collapse."""
    with_reads = _run_saturation(serve_reads=True, device=device)
    no_reads = _run_saturation(serve_reads=False, device=device)
    assert with_reads["ordered_hash"] == no_reads["ordered_hash"], \
        "serving reads perturbed the pool's ordering"
    assert with_reads["device_flushes"] == no_reads["device_flushes"], \
        "serving reads changed the vote-plane dispatch count"
    assert with_reads["shed_hash"] == no_reads["shed_hash"], \
        "serving reads changed the shed set"
    flash_open = _run_overload(retry=False, device=device)
    flash_retry = _run_overload(retry=True, device=device)
    value = with_reads["ordered"] / with_reads["wall_s"] \
        if with_reads["wall_s"] else 0.0
    reads = with_reads["reads"]
    p = with_reads["ingress_to_finalised"] or {}
    return {
        "metric": "saturation_ordered_txns_per_sec_n16",
        "value": round(value, 1),
        "unit": "txns/sec sustained under open-loop overload (bounded "
                "admission queue, deterministic shed, reads served "
                "outside 3PC)",
        "vs_baseline": round(
            value / ESTIMATED_REFERENCE_ORDERED_TXNS_PER_SEC_N64, 3),
        "baseline_note": "vs the same 100 txns/sec CPU estimate as the "
                         "ordered benches; the reference has no "
                         "admission control — open-loop overload grows "
                         "its queues without bound",
        "n_validators": 16,
        "workload": with_reads["workload"],
        "admission": with_reads["admission"],
        "shed_fraction": with_reads["shed_fraction"],
        "ordered": with_reads["ordered"],
        "ordered_per_sim_second": round(
            with_reads["ordered"] / with_reads["sim_elapsed_s"], 2)
        if with_reads["sim_elapsed_s"] else None,
        "wall_s": round(with_reads["wall_s"], 2),
        # the acceptance latency: earliest req.ingress anywhere ->
        # earliest req.finalised per request, in VIRTUAL protocol time
        "ingress_to_finalised_p50_s": p.get("p50"),
        "ingress_to_finalised_p99_s": p.get("p99"),
        # causal journeys: the FULL client-observed e2e under overload
        # (ingress -> executed), write and proof-read classes, with
        # network/queue/compute/device attribution
        "e2e_latency": with_reads["e2e_latency"],
        "phase_latency": with_reads["phase_latency"],
        "critical_path": with_reads["critical_path"],
        "flush_occupancy": with_reads["flush_occupancy"],
        "governor": with_reads["governor"],
        # the read-path proof: served outside 3PC, verified, and free
        "read_proofs_per_sec": reads["read_proofs_per_wall_sec"],
        "reads_served": reads["served"],
        "reads_verified": reads["verified"],
        "reads_zero_3pc_dispatches": True,  # asserted above
        "ordered_hash_matches_no_reads": True,  # asserted above
        "shed_hash": with_reads["shed_hash"],
        "ordered_hash": with_reads["ordered_hash"],
        # overload robustness plane: the closed-loop retry storm vs the
        # open-loop crowd on the same seeded flash spike — goodput under
        # the storm, the first-attempt/retry admission split, and the
        # post-spike recovery proving no metastable collapse (the
        # overload gate re-measures these with hard floors and asserts
        # byte-identical shed/retry/ordered replays)
        "flash_crowd": {
            "open_loop": flash_open,
            "retry_storm": flash_retry,
            "goodput_ratio": round(
                flash_retry["ordered"] / flash_open["ordered"], 3)
            if flash_open["ordered"] else None,
            "retry_recovered_requests":
                flash_retry["ordered"] - flash_open["ordered"],
        },
    }


def _view_change_storm(n: int = 100, seed: int = 17, device=None):
    """``bench_view_change_storm``'s body: its record, and the pool (for
    checks that read every survivor's view)."""
    import hashlib

    from ..common.messages.node_messages import (
        InstanceChange,
        NewView,
        ViewChange,
        ViewChangeAck,
    )
    from ..common.serializers.serialization import serialize_msg
    from ..config import getConfig
    from ..crypto import ed25519 as ed
    from ..simulation.pool import SimPool
    from ..tpu import ed25519 as ted

    dev = resolve_device(device)
    config = getConfig({"Max3PCBatchWait": 0.1, "Max3PCBatchSize": 10})
    pool = SimPool(n_nodes=n, seed=seed, config=config, device=dev)
    vc_types = (ViewChange, ViewChangeAck, NewView, InstanceChange)
    seeds = {nd.name: hashlib.sha256(b"vc-%s" % nd.name.encode()).digest()
             for nd in pool.nodes}
    pks = {name: ed.fast_public_key(seed) for name, seed in seeds.items()}

    # SIGN at send (side table keyed by message identity — messages are
    # immutable value objects, the bench must not mutate them); per-copy
    # delivery is held in a verification queue and released only on a
    # device-verified signature (the tick-batched gate the ingress uses)
    counters = {"signed": 0, "verified": 0}
    sigs_by_id = {}  # id(msg) -> (msg ref, payload, sig, signer)
    queue = []  # (pk, msg_bytes, sig, deliver)

    def wrap_node(nd):
        bus = nd.external_bus
        inner_send = bus._send_handler
        name = nd.name

        def signing_send(msg, dst=None):
            if isinstance(msg, vc_types):
                payload = serialize_msg(msg.as_dict())
                sig = ed.fast_sign(seeds[name], payload)
                counters["signed"] += 1
                sigs_by_id[id(msg)] = (msg, payload, sig, name)
            inner_send(msg, dst)

        # _send_handler alone intercepts every send (ExternalBus.send
        # forwards to it) — shadowing bus.send would bypass any future
        # logic in the method while appearing instrumented
        bus._send_handler = signing_send
        inner_recv = bus.process_incoming

        def gated_recv(msg, frm):
            entry = sigs_by_id.get(id(msg))
            if entry is None or entry[0] is not msg:
                return inner_recv(msg, frm)
            _m, payload, sig, signer = entry
            queue.append((pks[signer], payload, sig,
                          lambda m=msg, f=frm: inner_recv(m, f)))

        bus.process_incoming = gated_recv

    for nd in pool.nodes:
        wrap_node(nd)

    # ONE kernel shape for every verification wave: fixed chunks of 512
    # (padded by repetition) — message lengths vary wildly across VC
    # protocol messages, and the host hashes h, so every wave is K-c on
    # (512, 32) operands
    VCHUNK = 512

    def _verify_chunk(batch):
        k = len(batch)
        pad = batch + [batch[0]] * (VCHUNK - k)
        pk_a, r_a, s_a, h_a, pre = ted.prepare_batch(
            [b[0] for b in pad], [b[1] for b in pad], [b[2] for b in pad])
        assert pre.all()
        ok = ted.verify_kernel(
            *ted.to_device((pk_a, r_a, s_a, h_a), dev)).cpu().numpy()
        counters["verified"] += k
        assert ok[:k].all(), "storm signature failed verification"

    def pump_verifications():
        if not queue:
            return
        batch, queue[:] = list(queue), []
        for i in range(0, len(batch), VCHUNK):
            _verify_chunk(batch[i:i + VCHUNK])
        for (_pk, _m, _s, deliver) in batch:
            deliver()

    # warm THE kernel shape outside the timed region
    warm_msg = serialize_msg({"warm": 1})
    warm_sig = ed.fast_sign(seeds[pool.nodes[0].name], warm_msg)
    _verify_chunk([(pks[pool.nodes[0].name], warm_msg, warm_sig)])
    counters["verified"] = 0

    for i in range(10):
        pool.submit_request(i)
    pool.run_for(10)  # a little history so NEW_VIEW carries batches
    assert pool.honest_nodes_agree()

    primary = pool.nodes[0].data.primaries[0]
    pool.network.disconnect(primary)
    survivors = [nd for nd in pool.nodes if nd.name != primary]

    def done():
        return all(nd.data.view_no >= 1 and not nd.data.waiting_for_new_view
                   for nd in survivors)

    t0 = time.perf_counter()
    guard = time.monotonic() + 240
    while not done() and time.monotonic() < guard:
        pool.run_for(0.5)
        pump_verifications()
    _sync(dev)
    elapsed = time.perf_counter() - t0
    assert done(), "view change did not complete"
    assert counters["verified"] > 0, "config 4 requires verified sigs"
    msgs = pool.network.sent
    return {
        "metric": "view_change_storm_n%d_wall_s" % n,
        "value": round(elapsed, 2),
        "unit": "seconds to re-converge incl. per-copy device signature "
                "verification (lower is better)",
        "vs_baseline": 0.0,
        "baseline_note": "reference publishes no numbers; absolute "
                         "wall-clock for a full n=%d view change with "
                         f"{counters['verified']} view-change-protocol "
                         "signature copies device-verified "
                         f"({counters['signed']} signed) out of ~{msgs} "
                         "transport messages" % n,
        "n_validators": n,
        "messages": msgs,
        "signatures_verified": counters["verified"],
        "signatures_signed": counters["signed"],
        "sig_verifies_per_sec": round(
            counters["verified"] / elapsed, 1) if elapsed else 0.0,
    }, pool


def bench_view_change_storm(device=None, n: int = 100) -> dict:
    """BASELINE config 4 as SPECIFIED: VIEW-CHANGE / NEW-VIEW *signature
    verification* at n=100. The old primary drops, 100 validators
    broadcast VIEW_CHANGE; every view-change-protocol message is SIGNED
    by its sender at send time and each delivered copy is batch-verified
    ON DEVICE before processing (messages gate on their verdict — no
    optimistic delivery). Wall-clock covers signing + device verify +
    the full protocol re-convergence; the signature count is reported."""
    return _view_change_storm(n, device=device)[0]


def bench_bls_multisig(device=None) -> dict:
    """BASELINE config 3: BLS multi-sig aggregate + verify across 64
    validators per batch, on the production backend (the native C BN254
    module — the analog of the reference's Rust indy-crypto backend; the
    port has no pure-Python fallback). vs_baseline is measured against
    the affine correctness oracle on the same machine; the reference
    publishes no numbers (folklore puts AMCL BN254 near ~400
    cycles/sec). ``device`` is taken for the CLI's sake: the pairings run
    on the host."""
    import hashlib

    from ..crypto.bls import bn254 as bn
    from ..crypto.bls.bls_crypto import (
        BlsCryptoSigner,
        BlsCryptoVerifier,
        BlsKeyPair,
        g1_from_bytes,
        hash_to_g1,
    )
    from ..utils.base58 import b58decode

    n = 64
    kps = [BlsKeyPair(hashlib.sha256(b"bench-bls-%d" % i).digest())
           for i in range(n)]
    msg = b"multi-sig-value|ledger:1|state-root|txn-root|ts:1700000000"
    sigs = [BlsCryptoSigner(kp).sign(msg) for kp in kps]
    pks = [kp.pk_b58 for kp in kps]

    def cycle():
        agg = BlsCryptoVerifier.aggregate_sigs(sigs)
        assert BlsCryptoVerifier.verify_multi_sig(agg, msg, pks)

    cycle()  # warm subgroup cache (keys are static between NODE txns)
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        cycle()
        times.append(time.perf_counter() - t0)
    single_spread, single_median = _spread(times)

    # the batched plane: k ordered batches aggregated AND verified in
    # (|apk groups|+1) Miller loops + ONE shared final exponentiation
    # (random-linear-combination batch verification)
    k_batch = 16
    items = []
    for j in range(k_batch):
        m_j = msg + b"|batch:%d" % j
        items.append(([BlsCryptoSigner(kp).sign(m_j) for kp in kps],
                      m_j, pks))
    out = BlsCryptoVerifier.aggregate_and_verify_batch(items)  # warm
    assert all(ok for _, ok in out)
    btimes = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        out = BlsCryptoVerifier.aggregate_and_verify_batch(items)
        btimes.append(time.perf_counter() - t0)
    assert all(ok for _, ok in out)
    spread, bmedian = _spread(btimes)
    median = bmedian / k_batch  # amortized per ordered batch
    value = 1.0 / median

    # same-machine oracle baseline: one affine-path verification cycle
    agg_pt = g1_from_bytes(b58decode(
        BlsCryptoVerifier.aggregate_sigs(sigs)))
    pk_pts = [kp.pk for kp in kps]
    t0 = time.perf_counter()
    acc = None
    for p in pk_pts:
        acc = bn.g2_add(acc, p)
    assert bn.pairing_check([(hash_to_g1(msg), acc),
                             (bn.g1_neg(agg_pt), bn.G2_GEN)])
    oracle_s = time.perf_counter() - t0
    from ..crypto.bls.bls_crypto import NATIVE_BACKEND

    # external yardstick (non-self-referential): published optimal-ate
    # BN254 pairing timings on commodity x86 are ~1.5-4 ms/pairing for
    # AMCL/Milagro-class code (the reference's ursa backend) and ~0.5-1 ms
    # for the fastest assembly libraries (mcl). One agg+verify cycle here
    # is 2 pairings + 64 G2 adds + hash-to-curve, so a reference-class
    # backend lands at roughly 3-9 ms/cycle (~110-330 cycles/sec).
    reference_class_cycle_ms = (3.0, 9.0)
    # a metric name of its own for the batched plane: the older
    # bls_aggregate_verify_64_per_sec was the single-cycle rate, and a
    # silent 16x redefinition under the old name would corrupt
    # comparisons across records
    return {
        "metric": "bls_agg_verify_64_batched%d_per_sec" % k_batch,
        "value": round(value, 2),
        "unit": "agg+verify batches/sec (amortized across %d ordered "
                "batches, one shared final exponentiation)" % k_batch,
        "vs_baseline": round(
            value / (1e3 / reference_class_cycle_ms[1]), 3),
        "baseline_note": "absolute: %.3f ms/batch amortized; the bench "
                         "chose k=%d — production defers per quorum tick, "
                         "so real amortization is workload-dependent "
                         "(ticks ordering 2 batches amortize 2x). The "
                         "old single-cycle metric "
                         "(bls_aggregate_verify_64_per_sec) "
                         "measures %.2f ms this run — see "
                         "single_cycle_per_sec for the comparable "
                         "number. External yardstick: AMCL/Milagro-class "
                         "BN254 (the reference's ursa backend) at "
                         "published ~1.5-4ms/pairing => ~3-9ms/cycle; "
                         "vs_baseline uses the conservative 9ms end. "
                         "Same-machine affine oracle: %.2f/sec. "
                         "Backend: %s"
                         % (median * 1e3, k_batch, single_median * 1e3,
                            1.0 / oracle_s,
                            "native C (the reference's Rust-analog)"
                            if NATIVE_BACKEND else "pure-Python projective"),
        "single_cycle_ms": round(single_median * 1e3, 3),
        "single_cycle_per_sec": round(1.0 / single_median, 2),
        "batched_ms_per_batch": round(median * 1e3, 3),
        "batch_k": k_batch,
        "n_validators": n,
        "spread": spread,
        "single_spread": single_spread,
        "reference_class_cycle_ms": list(reference_class_cycle_ms),
    }


def bench_state_proofs(device=None) -> dict:
    """State-proof plane (proofs/): verifying K pool multi-signatures
    across K DIFFERENT roots/windows must scale with the batch size, not
    the per-root cycle cost — the random-linear-combination pass shares
    one final exponentiation across the whole batch. Also proves the
    serve-path contract: reads attaching a cached window proof perform
    ZERO pairings. The serve path runs ``mode="host"`` as the reference's
    does, on ``device``'s read service."""
    import hashlib

    from ..crypto.bls.bls_crypto import (
        NATIVE_BACKEND,
        PAIRINGS,
        BlsCryptoSigner,
        BlsCryptoVerifier,
        BlsKeyPair,
        MultiSignature,
        MultiSignatureValue,
    )
    from ..ingress.read_service import ReadService, StaticCorpusBacking
    from ..proofs import (
        CheckpointProofCache,
        ProofWindow,
        verify_multi_sigs_batch,
    )
    from ..utils.base58 import b58encode

    dev = resolve_device(device)
    n = 64  # validators per aggregate: the BASELINE config-3 shape
    k_max = 64  # roots/windows per combined pairing pass
    kps = [BlsKeyPair(hashlib.sha256(b"bench-proof-%d" % i).digest())
           for i in range(n)]
    pks = [kp.pk_b58 for kp in kps]
    signers = [BlsCryptoSigner(kp) for kp in kps]
    items = []
    for j in range(k_max):
        msg = b"proof-window-root-%d" % j
        items.append((BlsCryptoVerifier.aggregate_sigs(
            [s.sign(msg) for s in signers]), msg, pks))

    # per-root baseline: one pairing check per root (the pre-proof-plane
    # path a read server would pay per window root)
    assert BlsCryptoVerifier.verify_multi_sig(*items[0])  # warm caches
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        ok = [BlsCryptoVerifier.verify_multi_sig(*it) for it in items]
        times.append(time.perf_counter() - t0)
    assert all(ok)
    per_root_spread, per_root_median = _spread(times)
    per_root_rate = k_max / per_root_median

    # batched plane at batch 1 / 16 / 64: the scaling claim itself
    rates = {}
    batch_spread = None
    for k in (1, 16, 64):
        sub = items[:k]
        assert all(verify_multi_sigs_batch(sub, seed=7))  # warm
        times = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            verdicts = verify_multi_sigs_batch(sub, seed=7)
            times.append(time.perf_counter() - t0)
        assert all(verdicts)
        spread, median = _spread(times)
        rates[k] = round(k / median, 2)
        if k == 64:
            batch_spread = spread
    value = rates[64]

    # serve path: a manufactured stabilized window over a seeded corpus —
    # attaching the pool proof to every read must cost ZERO pairings
    # (the aggregation was paid once, above)
    backing = StaticCorpusBacking(4096, seed=11)
    value_obj = MultiSignatureValue(
        ledger_id=1, state_root_hash="bench-state-root",
        pool_state_root_hash="", txn_root_hash=b58encode(backing.root),
        timestamp=1_700_000_000)
    msg = value_obj.serialize()
    agg = BlsCryptoVerifier.aggregate_sigs([s.sign(msg) for s in signers])
    ms = MultiSignature(signature=agg,
                        participants=["node%d" % i for i in range(n)],
                        value=value_obj)
    cache = CheckpointProofCache(
        bls_replica=None,
        root_provider=lambda: (backing.tree_size, backing.root),
        state_root_provider=lambda: "bench-state-root")
    cache.install(ProofWindow(
        window=(0, 100), tree_size=backing.tree_size, root=backing.root,
        state_root_b58="bench-state-root", multi_sig=ms,
        multi_sig_dict=ms.as_dict(), captured_at=0.0))
    rs = ReadService(backing, mode="host", proof_cache=cache, device=dev)
    for i in range(4096):
        rs.submit(i)
    checks0 = PAIRINGS.checks
    t0 = time.perf_counter()
    replies = rs.drain()
    serve_s = time.perf_counter() - t0
    serve_pairings = PAIRINGS.checks - checks0
    assert serve_pairings == 0, "cache-hit serve path paid pairings"
    assert all(r.verified and r.multi_sig is not None for r in replies)

    return {
        "metric": "state_proof_batch64_verify_per_sec",
        "value": value,
        "unit": "pool multi-sigs verified/sec across 64 distinct "
                "roots/windows (one combined RLC pairing pass)",
        # the claim under test: batching must beat verifying each
        # root's aggregate individually — the floor is 2x
        "vs_baseline": round(value / per_root_rate, 3),
        "baseline_note": "vs_baseline is batch-64 throughput over the "
                         "per-root pairing path on the SAME machine and "
                         "backend (%s); the per-root aggregate+verify "
                         "cycle is bench 'bls' single_cycle_per_sec. "
                         "Serve path: %d proof-attached reads at %.0f "
                         "reads/sec with %d pairings (must be 0)."
                         % ("native C" if NATIVE_BACKEND
                            else "pure-Python projective",
                            len(replies), len(replies) / serve_s,
                            serve_pairings),
        "per_root_verify_per_sec": round(per_root_rate, 2),
        "proofs_per_sec_by_batch": rates,
        "n_validators": n,
        "spread": batch_spread,
        "per_root_spread": per_root_spread,
        "serve_reads": len(replies),
        "serve_reads_per_sec": round(len(replies) / serve_s, 1),
        "serve_pairing_checks": serve_pairings,
    }


def bench_state_commit(device=None) -> dict:
    """State-commit plane (state/sparse_merkle_state.py): a 3PC batch
    must commit state via ONE bottom-up tree walk — each touched
    internal node hashed once per batch — instead of a 256-hash path
    walk per write. Three arms over identical per-window hot-key write
    sets on a 100k-key SMT (sequential set() loop, batched host waves,
    batched mode='auto' waves): per-window roots bit-identical across
    arms, hashes/commit and commits/sec per arm, >=3x fewer hashes
    batched vs sequential at delta=256. Plus the virtual-time soak arm:
    a diurnal WorkloadProfile drives a real-execution pool across a
    simulated multi-hour horizon — bounded structures hold a flat
    high-water, ordered throughput does not drift first-vs-last
    simulated hour, and two same-seed runs are byte-identical."""
    from ..simulation.state_commit_bench import (
        run_commit_arms,
        run_state_soak,
    )

    dev = resolve_device(device)
    arms = run_commit_arms(device=dev)  # 100k keys, delta=256, 20 windows
    assert arms["roots_identical"]
    assert arms["hash_reduction"] >= 3.0, \
        "batched walk lost its hash advantage: %.2fx" % arms["hash_reduction"]
    # 2 simulated hours, diurnal, two same-seed runs
    soak = run_state_soak(device=dev)
    assert soak["deterministic"], "same-seed soak runs diverged"
    assert soak["flat_high_water"], \
        "bounded-structure high-water grew across the soak horizon"
    assert soak["throughput_drift"] < 0.05, \
        "ordered throughput drifted %.1f%% first-vs-last simulated hour" \
        % (soak["throughput_drift"] * 100)

    seq = arms["arms"]["sequential"]
    bat = arms["arms"]["host"]
    return {
        "metric": "state_commit_batched_per_sec",
        "value": round(bat["commits_per_sec"], 2),
        "unit": "delta=256 window commits/sec on a 100k-key SMT "
                "(batched one-walk commit, host waves)",
        "vs_baseline": round(bat["commits_per_sec"]
                             / seq["commits_per_sec"], 3),
        "baseline_note": "vs_baseline is batched-host commits/sec over "
                         "the sequential per-write set() loop on the "
                         "SAME windows; hash_reduction is the "
                         "hashes-per-commit ratio (the O(delta) claim "
                         "itself, placement-independent). Soak: %d "
                         "reqs ordered across %.0f simulated hours, "
                         "drift %.2f%%, byte-identical across two "
                         "same-seed runs."
                         % (soak["ordered_total"], soak["hours"],
                            soak["throughput_drift"] * 100),
        "hash_reduction": arms["hash_reduction"],
        "hashes_per_commit": {
            "sequential": seq["hashes_per_commit"],
            "batched": bat["hashes_per_commit"],
        },
        "commit_arms": arms,
        "soak": {k: soak[k] for k in (
            "arrivals", "ordered_total", "hourly_ordered",
            "throughput_drift", "flat_high_water",
            "first_hour_high_water", "last_hour_high_water",
            "cache_hit_rate", "deterministic", "wall_s")},
    }


def bench_day_soak(device=None) -> dict:
    """Virtual-day soak (simulation/soak.py): a multi-hour diurnal slice
    of the 24h arc — warm phase, deterministic arrival grid, a mid-run
    GC-crossing crash + catchup, a view change — judged entirely by the
    telemetry plane: flat resource high-water after the first hour,
    first-vs-last-hour ordered drift < 1%, zero unexplained anomalies,
    and the rollup/anomaly hash chain byte-identical across two
    same-seed runs. (The full 24h arc with the forced-rebalance leg runs
    in the ``soak`` dispatch-budget gate; the bench keeps a
    6-simulated-hour slice so the whole suite stays minutes.)"""
    from ..simulation.soak import run_day_soak

    soak = run_day_soak(hours=6.0, crash_hour=1.5, crash_hours=0.5,
                        vc_hour=3.0, repeats=2, device=resolve_device(device))
    assert soak["deterministic"], "same-seed day-soak runs diverged"
    assert soak["agree"], "ledgers diverged across the chaos arc"
    assert soak["flat_high_water"], \
        "bounded-structure high-water grew across the soak horizon"
    assert soak["throughput_drift"] < 0.01, \
        "ordered throughput drifted %.2f%% first-vs-last simulated hour" \
        % (soak["throughput_drift"] * 100)
    assert soak["anomalies_unexplained"] == 0, \
        "unexplained telemetry anomalies: %r" % soak["unexplained"]
    assert soak["chaos"]["crash"]["ok"], "crash/catchup leg failed"
    assert soak["chaos"]["view_change"]["ok"], "view-change leg failed"

    hourly = soak["hourly_ordered"]
    return {
        "metric": "day_soak_ordered_txns",
        "value": soak["ordered_total"],
        "unit": "txns ordered across %.0f simulated diurnal hours "
                "(crash+catchup @1.5h, view change @3h)" % soak["hours"],
        "vs_baseline": round(hourly[-1] / hourly[0], 4) if hourly[0]
        else 0.0,
        "baseline_note": "vs_baseline is last-hour over first-hour "
                         "ordered throughput (1.0 = no drift). "
                         "%d telemetry windows, %d anomalies (all "
                         "chaos-explained), telemetry_hash %s… "
                         "byte-identical across %d same-seed runs."
                         % (soak["windows"], soak["anomalies"],
                            soak["telemetry_hash"][:12],
                            soak["repeats"]),
        "soak_day": {k: soak[k] for k in (
            "hours", "device_arm", "arrivals", "ordered_total",
            "hourly_ordered", "throughput_drift", "flat_high_water",
            "windows", "anomalies", "anomalies_unexplained", "chaos",
            "agree", "telemetry_hash", "deterministic", "wall_s")},
    }


def bench_geo(device=None) -> dict:
    """Planet-scale read fabric. Phase A: what 3-region WAN RTTs do to
    3PC ordering, view-change convergence and the cross-lane barrier
    (regions off vs on, same seed — protocol time, so the cost is the
    latency realism itself). Phase B: a region-spread read storm served
    from region-local edge proof caches vs the same-seed no-edge arm —
    >= 90% edge hit rate at intra-region p99 while the no-edge arm pays
    the WAN band, ZERO pairings on the edge serve path, and
    ordered/journey/shed fingerprints bit-identical between arms (the
    fabric's dedicated RNG never touches the pool's). The origin serves
    in ``mode="host"``, as the reference's does."""
    from ..config import getConfig
    from ..observability.causal import journey_summary
    from ..simulation.pool import SimPool

    dev = resolve_device(device)
    INTRA_HI = 0.05  # the pool's intra-region band ceiling (sim_network)

    # --- phase A: regional latency realism on the write planes ----------
    def _ordering_arm(region_count: int) -> dict:
        config = getConfig({
            "Max3PCBatchSize": 4, "Max3PCBatchWait": 0.05,
            "OrderingStallTimeout": 4.0,
            "RegionCount": region_count})
        pool = SimPool(n_nodes=6, seed=23, config=config, trace=True,
                       device=dev)
        sim_t0 = pool.timer.get_current_time()
        for i in range(48):
            pool.submit_request(
                i, region=(i % 3) if region_count else None)
        guard = time.monotonic() + 300
        while min(len(nd.ordered_digests) for nd in pool.nodes) < 48 \
                and time.monotonic() < guard:
            pool.run_for(0.25)
        ordered = min(len(nd.ordered_digests) for nd in pool.nodes)
        assert ordered >= 48, \
            f"regions={region_count}: ordering stalled at {ordered}/48"
        assert pool.honest_nodes_agree()
        order_s = pool.timer.get_current_time() - sim_t0
        # view-change convergence: drop the primary with work in flight,
        # measure VIRTUAL re-convergence time
        primary = pool.nodes[0].data.primaries[0]
        pool.network.disconnect(primary)
        survivors = [nd for nd in pool.nodes if nd.name != primary]
        sim_t1 = pool.timer.get_current_time()
        for i in range(6):
            pool.submit_request(48 + i,
                                region=(i % 3) if region_count else None)

        def converged():
            return all(nd.data.view_no >= 1
                       and not nd.data.waiting_for_new_view
                       for nd in survivors)

        guard = time.monotonic() + 300
        while not converged() and time.monotonic() < guard:
            pool.run_for(0.25)
        assert converged(), \
            f"regions={region_count}: view change did not converge"
        vc_s = pool.timer.get_current_time() - sim_t1
        js = journey_summary(pool.trace.events())
        arm = {
            "regions": region_count,
            "order_48_sim_s": round(order_s, 3),
            "view_change_sim_s": round(vc_s, 3),
            "write_e2e_p99": ((js.get("e2e") or {}).get("write")
                              or {}).get("p99"),
            "cross_region_msgs":
                pool.network.counters().get("cross_region", 0),
        }
        if region_count:
            assert arm["cross_region_msgs"] > 0, \
                "geo arm never crossed a region boundary"
            arm["region_matrix"] = pool.region_matrix.as_dict()
            if js.get("regions"):
                arm["journeys_per_region"] = \
                    js["regions"].get("journeys_per_region")
        return arm

    def _barrier_arm(region_count: int) -> dict:
        from ..lanes import LanedPool

        config = getConfig({
            "Max3PCBatchSize": 4, "Max3PCBatchWait": 0.05,
            "CHK_FREQ": 2, "LOG_SIZE": 6,
            "RegionCount": region_count})
        pool = LanedPool(lanes=2, n_nodes=4, seed=23, config=config,
                         device=dev)
        sim_t0 = pool.timer.get_current_time()
        for i in range(32):
            pool.submit_request(i)
        guard = time.monotonic() + 300
        while pool.ordered_total() < 32 and time.monotonic() < guard:
            pool.run_for(0.25)
        assert pool.ordered_total() >= 32, "laned geo arm stalled"
        seal_s = pool.timer.get_current_time() - sim_t0
        return {
            "regions": region_count,
            "sealed_window": pool.barrier.sealed_window,
            "seals": pool.barrier.seals,
            "seal_32_sim_s": round(seal_s, 3),
            "sealed_fingerprint": pool.sealed_fingerprint,
        }

    phase_a = {
        "ordering": {"off": _ordering_arm(0), "on": _ordering_arm(3)},
        "barrier": {"off": _barrier_arm(0), "on": _barrier_arm(3)},
    }
    # WAN realism must COST protocol time, or the matrix isn't plumbed
    assert phase_a["ordering"]["on"]["order_48_sim_s"] > \
        phase_a["ordering"]["off"]["order_48_sim_s"], phase_a["ordering"]
    assert phase_a["barrier"]["on"]["seal_32_sim_s"] > \
        phase_a["barrier"]["off"]["seal_32_sim_s"], phase_a["barrier"]

    # --- phase B: edge proof-cache tier vs no-edge, same seed -----------
    def _edge_arm(use_edges: bool, seed: int = 29) -> dict:
        from ..proofs.edge_cache import EdgeProofCache, GeoReadFabric

        config = getConfig({
            "Max3PCBatchSize": 1, "Max3PCBatchWait": 0.05,
            "CHK_FREQ": 5, "LOG_SIZE": 15, "RegionCount": 3})
        pool = SimPool(n_nodes=4, seed=seed, config=config,
                       real_execution=True, bls=True, trace=True,
                       device=dev)
        for i in range(12):
            pool.submit_request(i, region=i % 3)
        guard = time.monotonic() + 300
        while (min(len(nd.ordered_digests) for nd in pool.nodes) < 12
               or pool.nodes[0].proof_cache.current() is None) \
                and time.monotonic() < guard:
            pool.run_for(0.25)
        assert pool.nodes[0].proof_cache.current() is not None, \
            "no proof window stabilized for the edge tier to replicate"
        origin = pool.make_read_service("node0", mode="host")
        entry = origin.proof_cache.current()
        keys = {name: pk
                for name, (kp, pk, pop) in pool.bls_keys.items()}
        quorum = len(pool.validators) - (len(pool.validators) - 1) // 3
        edges = {}
        if use_edges:
            # warm replication: the sealed window's whole proof corpus
            # fans out to every region's edge (the production feed is
            # the same drain, pushed at each seal)
            for i in range(entry.tree_size):
                origin.submit(i)
            replies = origin.drain()
            edges = {r: EdgeProofCache(
                region=r, clock=pool.timer.get_current_time)
                for r in range(3)}
            # da: allow[unordered-fingerprint] -- each edge replicates the same window on its own; no digest reads their order
            for edge in edges.values():
                stored = edge.replicate(entry.window, replies)
                assert stored == entry.tree_size, (stored, entry)
        origin.reset_serve_meters()
        fabric = GeoReadFabric(
            origin, pool.region_matrix, keys, min_participants=quorum,
            n_regions=3, origin_region=0, edges=edges, seed=seed,
            clock=pool.timer.get_current_time)
        reads_total = 0
        for wave in range(6):
            for client in range(120):
                fabric.submit(client,
                              (7 * client + wave) % entry.tree_size)
                reads_total += 1
            served = fabric.drain()
            assert len(served) == 120, (wave, len(served))
            pool.run_for(1.0)
        counters = fabric.counters()
        js = journey_summary(pool.trace.events())
        return {
            "edges": bool(use_edges),
            "reads": reads_total,
            "fabric": counters,
            "global_write_e2e_p99": ((js.get("e2e") or {}).get("write")
                                     or {}).get("p99"),
            "journey_hash": js["journey_hash"],
            "shed_hash": origin.shed_hash(),
            "ordered_hash": pool.ordered_hash(),
            "read_regions": (js.get("regions")
                             or {}).get("read_e2e_per_region"),
        }

    with_edges = _edge_arm(True)
    without = _edge_arm(False)
    fb = with_edges["fabric"]
    assert fb["edge_hit_rate"] >= 0.90, fb
    assert fb["edge_serve_pairings"] == 0, fb
    for region, block in fb["regions"].items():
        assert block["latency_p99"] <= INTRA_HI, (region, block)
    # the same-seed no-edge arm pays the WAN band for non-home regions
    wan_floor = getConfig().RegionWanMinLatency
    for region in ("1", "2"):
        block = without["fabric"]["regions"][region]
        assert block["latency_p99"] >= wan_floor, (region, block)
    # arming the edge tier must not move a single write-plane bit
    for key in ("ordered_hash", "journey_hash", "shed_hash"):
        assert with_edges[key] == without[key], \
            f"{key} diverged between edge and no-edge arms"

    edge_p99 = max(b["latency_p99"]
                   for b in fb["regions"].values())
    wan_p99 = max(without["fabric"]["regions"][r]["latency_p99"]
                  for r in ("1", "2"))
    value = round(wan_p99 / edge_p99, 2)
    return {
        "metric": "geo_edge_read_p99_speedup",
        "value": value,
        "unit": "no-edge WAN read p99 over edge-tier read p99, same "
                "seed (3 regions, clients verify every reply offline)",
        "vs_baseline": value,
        "baseline_note": "baseline is the SAME pool + seed serving all "
                         "reads from the home-region validator over "
                         "the WAN band; the edge tier serves "
                         f"{fb['edge_hit_rate']:.0%} region-locally at "
                         "intra-band p99 with 0 serve-path pairings "
                         "and bit-identical write fingerprints",
        "edge_hit_rate": fb["edge_hit_rate"],
        "edge_read_p99_s": edge_p99,
        "wan_read_p99_s": wan_p99,
        "verified_per_sec_by_region": {
            r: b["verified_per_sec"]
            for r, b in sorted(fb["regions"].items())},
        "global_write_e2e_p99": with_edges["global_write_e2e_p99"],
        "fingerprints_identical": True,
        "phase_a": phase_a,
        "phase_b": {"edge": with_edges, "no_edge": without},
    }


BENCHES = {
    "ed": bench_ed25519,
    "ordered": bench_ordered_txns_n64,
    "rbft": bench_ordered_txns_n64_rbft,
    "sharded": bench_ordered_txns_n64_sharded,
    "resident": bench_ordered_txns_n64_resident,
    "fabric": bench_fabric,
    "lanes": bench_lanes,
    "ordered100": bench_ordered_txns_n100,
    "saturation": bench_saturation,
    "bls": bench_bls_multisig,
    "proofs": bench_state_proofs,
    "catchup": bench_catchup_proofs,
    "catchup_e2e": bench_catchup_e2e,
    "offload": bench_catchup_offload,
    "viewchange": bench_view_change_storm,
    "state": bench_state_commit,
    "geo": bench_geo,
    "soak": bench_day_soak,
}


def _extras_digest(e):
    """[value, vs_baseline] (+ flush_occupancy, + the governor's
    [tick_min, tick_median, tick_max, occupancy_ewma], + the flight
    recorder's per-phase share of batch latency, + the readback
    contract's [eval_mode, bytes/readback, overlap] for the tick-batched
    ordered cells — index-based consumers keep [0]/[1])."""
    row = [e["value"], e["vs_baseline"]]
    if e.get("flush_occupancy") is not None:
        row.append(e["flush_occupancy"])
    gov = e.get("governor")
    if gov:
        row.append([gov["interval_min"], gov["interval_median"],
                    gov["interval_max"], gov["occupancy_ewma"]])
    cp = e.get("critical_path")
    if cp and cp.get("phase_share"):
        row.append(cp["phase_share"])
    if e.get("eval_mode") is not None:
        # the ordering fast path's readback contract: eval mode
        # + [bytes/readback, overlap fraction]
        row.append([e["eval_mode"],
                    e.get("readback_bytes_per_readback"),
                    e.get("readback_overlap_fraction")])
    if (e.get("resident_depth") or 0) > 1:
        # multi-tick residency: [ring depth, resident ticks, readbacks
        # deferred] — depth-1 (per-tick) rows omit it
        row.append([e["resident_depth"],
                    e.get("resident_ticks"),
                    e.get("readbacks_deferred")])
    if e.get("lane_scaling") is not None:
        # multi-lane ordering: [tps 1-lane, 2-lane, 4-lane, 4-lane
        # speedup]
        row.append(e["lane_scaling"])
    if e.get("hash_reduction") is not None:
        # state-commit plane: [hashes/commit reduction, soak throughput
        # drift, soak byte-identical]
        row.append([e["hash_reduction"],
                    e["soak"]["throughput_drift"],
                    e["soak"]["deterministic"]])
    if e.get("soak_day") is not None:
        # virtual-day soak: [anomalies, unexplained, flat high-water,
        # byte-identical]
        sd = e["soak_day"]
        row.append([sd["anomalies"],
                    sd["anomalies_unexplained"],
                    sd["flat_high_water"], sd["deterministic"]])
    if e.get("edge_hit_rate") is not None:
        # planet-scale read fabric: [edge hit rate, edge-tier read p99,
        # same-seed no-edge WAN read p99]
        row.append([e["edge_hit_rate"],
                    e["edge_read_p99_s"],
                    e["wan_read_p99_s"]])
    return row


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m indy_plenum_tpu_torch.tools.bench",
        description="Run the port's bench cells and print one compact "
                    "JSON line (full records: BENCH_FULL.json beside "
                    "this module, and stderr).")
    ap.add_argument("cell", nargs="?", default="all",
                    choices=["all", *BENCHES])
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain versions of the kernels; "
                         "default: the CUDA card")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # no card and no --device cpu: raise here, before any cell runs
    device = resolve_device(args.device)
    selected = list(BENCHES) if args.cell == "all" else [args.cell]

    # the cells run with BOTH sys.stdout (Python-level prints) and fd 1
    # (C-level writes) redirected to stderr; the full detail goes to
    # stderr AND BENCH_FULL.json, and the REAL stdout gets exactly one
    # compact JSON line, newline-guarded against any partial line
    # already on it
    real_stdout = sys.stdout
    real_fd = os.dup(1)
    sys.stdout = sys.stderr
    os.dup2(2, 1)
    results, errors = {}, {}
    try:
        # a cell that raises is recorded once and the run goes on; the
        # exit code says it failed
        for name in selected:
            try:
                results[name] = BENCHES[name](device)
            except Exception as ex:  # noqa: BLE001 — recorded in errors, exit 1
                traceback.print_exc(file=sys.stderr)
                errors[name] = f"{type(ex).__name__}: {ex}"
    finally:
        sys.stdout = real_stdout
        os.dup2(real_fd, 1)

    # headline: the ed25519 kernel; else the first cell that succeeded,
    # so a run ALWAYS records a number
    line = None
    for name in ["ed", *selected]:
        if name in results:
            line = dict(results.pop(name))
            break
    if line is None:
        line = {"metric": "bench_failed", "value": 0, "unit": "none",
                "vs_baseline": 0}
    extras = [results[n] for n in selected if n in results]

    full = dict(line)
    if extras:
        full["extra_metrics"] = extras
    if errors:
        full["errors"] = errors
    # the one stdout line: headline metric + a terse {metric: [value,
    # vs_baseline]} digest of the extras, small enough that a tail
    # capture still holds the whole line. Built and printed FIRST
    # (before any file IO) with default=str so a stray numpy scalar
    # cannot lose the record
    compact = {k: line.get(k) for k in ("metric", "value", "unit",
                                        "vs_baseline")}
    if extras:
        compact["extras"] = {e["metric"]: _extras_digest(e)
                             for e in extras}
    if errors:
        compact["errors"] = sorted(errors)
    compact["full"] = "BENCH_FULL.json"
    compact_s = json.dumps(compact, separators=(",", ":"), default=str)
    # leading newline: if any C-level write left a partial line on real
    # stdout before the redirect took effect, the record still starts a
    # fresh line (last-non-empty-line parsers see pure JSON)
    print("\n" + compact_s, file=real_stdout)
    real_stdout.flush()
    os.close(real_fd)

    full_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "BENCH_FULL.json")
    with open(full_path, "w") as f:
        json.dump(full, f, indent=1, default=str)
    print(json.dumps(full, default=str), file=sys.stderr)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
