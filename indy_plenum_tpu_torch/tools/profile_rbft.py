"""Profile the full-RBFT sim loop: where do 22 instances spend it?

Usage: python -m indy_plenum_tpu_torch.tools.profile_rbft [n_nodes]
           [instances] [txns] [--json] [--no-baseline] [--device cpu]

``--json`` emits ONE machine-readable line on stdout (everything else
goes to stderr): the top-20 cumulative hotspots plus the dispatch-plane
amortization numbers — ``device_dispatches_per_ordered_batch`` for the
tick-batched run and, unless ``--no-baseline``, the same measured on a
short per-message run (``QuorumTickInterval=0``) with the resulting
``amortization_factor``. ``--mesh M`` splits the grouped vote plane into
M member tiles (mesh-sharded dispatch plane) and ``--mesh MxV`` runs the
member x validator 2-axis quorum fabric; the record then carries
``shards``, ``mesh_shape`` and per-shard occupancy. ``--trace`` arms the consensus
flight recorder: the span trace dumps to ``--trace-out`` (JSONL for
``tools.trace_tool``) and the ``--json`` record gains
``phase_latency`` percentiles + ``critical_path``. ``--real-execution``
profiles with real ledgers + SMT states; the record's ``state`` block
then carries the batched state-commit plane's hashes/commit, node-cache
hit rate and offload mode (``state: null`` otherwise). The determinism cross-check
(``ordered_digests`` identical between the two modes) lives in
``tests/test_dispatch_plane.py``; the budget gate in
``tools.check_dispatch_budget``.

Twin of ``scripts/profile_rbft.py`` over the port's ``SimPool``: the same
flags and the same JSON record, plus ``--device``. The pool's kernels run
on the CUDA card unless ``--device cpu`` asks for their plain versions;
without a card and without ``--device cpu`` it exits non-zero before it
builds a pool. ``--mesh`` builds its tiles on that one device (the
reference takes them from ``jax.devices()``). The hotspots are cProfile's,
so they name the port's functions.
"""
# da: allow-file[nondet-source] -- profiler harness: wall reads bound a stalled run and time the profiled segment; the ordering they watch is seeded on the virtual clock
import argparse
import cProfile
import json
import os
import pstats
import sys
import time

from ..common.metrics_collector import MetricsName
from ..config import getConfig
from ..simulation.pool import SimPool

BATCH = 160


def _build_pool(n, k, tick_interval, adaptive=False, mesh=None,
                trace=False, ingress_capacity=0, real_execution=False,
                resident_depth=0, device=None):
    config = getConfig({
        "Max3PCBatchSize": BATCH,
        "Max3PCBatchWait": 0.05,
        "QuorumTickInterval": tick_interval,
        "QuorumTickAdaptive": adaptive,
        "IngressQueueCapacity": ingress_capacity,
        "ResidentTickDepth": max(resident_depth, 1),
    })
    # a bounded ingress queue only means something on the signed auth
    # path (the admission plane guards the device auth batch)
    return SimPool(n_nodes=n, seed=11, config=config, device_quorum=True,
                   shadow_check=False, num_instances=k, mesh=mesh,
                   trace=trace, sign_requests=ingress_capacity > 0,
                   real_execution=real_execution, device=device)


def _run(pool, txns, profile=False):
    """Warm up one batch, then order ``txns`` more; returns the measured
    segment's (ordered, wall_s, device_dispatches, profiler|None)."""
    seq = [0]

    def submit(count):
        for _ in range(count):
            seq[0] += 1
            pool.submit_request(seq[0])

    def min_ordered():
        return min(len(nd.ordered_digests) for nd in pool.nodes)

    def target_after_shed(base):
        # a bounded admission queue (--ingress-capacity) sheds overflow
        # deterministically: only what was ADMITTED can ever order
        adm = pool.admission
        return base - adm.shed_total if adm is not None else base

    # warm-up: loads the kernel library + fills the plan caches
    deadline = time.monotonic() + 240
    submit(BATCH)
    while min_ordered() < target_after_shed(BATCH) \
            and time.monotonic() < deadline:
        pool.run_for(0.5)
    warm_got = min_ordered()
    assert warm_got >= target_after_shed(BATCH), "warm-up stalled"

    # sheds are counted at offer() time (only their trace/metric emission
    # waits for the drain): snapshot BEFORE the burst, or the burst's own
    # sheds vanish from the delta and the loop waits on txns that were
    # never admitted until the deadline
    shed0 = pool.admission.shed_total if pool.admission else 0
    submit(txns)
    target = warm_got + txns
    flushes0 = pool.vote_group.flushes
    deadline = time.monotonic() + 240  # fresh budget: the warm-up must
    # not silently truncate the profiled run
    prof = cProfile.Profile() if profile else None
    t0 = time.perf_counter()
    if prof:
        prof.enable()
    while min_ordered() < target - (
            (pool.admission.shed_total - shed0) if pool.admission
            else 0) and time.monotonic() < deadline:
        pool.run_for(0.5)
    if prof:
        prof.disable()
    elapsed = time.perf_counter() - t0
    got = min_ordered() - warm_got
    dispatches = pool.vote_group.flushes - flushes0
    return got, elapsed, dispatches, prof


def _hotspots(prof, top=20):
    """Top ``top`` functions by cumulative time, machine-readable."""
    stats = pstats.Stats(prof)
    rows = []
    for (path, line, func), (cc, nc, tt, ct, _callers) in \
            sorted(stats.stats.items(), key=lambda kv: -kv[1][3])[:top]:
        rows.append({
            "func": f"{os.path.basename(path)}:{line}({func})",
            "ncalls": nc,
            "tottime_s": round(tt, 4),
            "cumtime_s": round(ct, 4),
        })
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m indy_plenum_tpu_torch.tools.profile_rbft",
        description=__doc__)
    ap.add_argument("n_nodes", nargs="?", type=int, default=16)
    ap.add_argument("instances", nargs="?", type=int, default=6)
    ap.add_argument("txns", nargs="?", type=int, default=320)
    ap.add_argument("--json", action="store_true",
                    help="one machine-readable stdout line: top-20 "
                         "hotspots + dispatch amortization metrics")
    ap.add_argument("--no-baseline", action="store_true",
                    help="skip the per-message baseline run in --json mode")
    ap.add_argument("--static-tick", action="store_true",
                    help="freeze the tick at 0.1 (skip the adaptive "
                         "governor the profiled loop now runs by default)")
    ap.add_argument("--mesh", default="0",
                    help="split the grouped vote plane: M tiles on the "
                         "member axis (e.g. 8) or an MxV member x "
                         "validator 2-axis fabric (e.g. 4x2), every tile "
                         "on the one device; 0 = unsharded")
    ap.add_argument("--ingress-capacity", type=int, default=0,
                    help="bound the auth queue (admission control): the "
                         "profiled pool then runs the SIGNED ingress "
                         "path and the --json record's ingress block "
                         "carries queue depth + admitted/shed totals")
    ap.add_argument("--real-execution", action="store_true",
                    help="profile with real ledgers + SMT states (NYM "
                         "writes through the batched state-commit "
                         "plane): the --json record's state block "
                         "carries hashes/commit, node-cache hit rate "
                         "and offload mode")
    ap.add_argument("--resident-depth", type=int, default=0,
                    help="multi-tick device residency: accumulate votes "
                         "in device-side ring slots over this many ticks "
                         "before one fused step consumes them; the "
                         "--json record gains a residency block")
    ap.add_argument("--trace", action="store_true",
                    help="arm the consensus flight recorder: dumps the "
                         "span trace as JSONL (--trace-out) and the "
                         "--json record gains phase_latency percentiles "
                         "+ critical_path attribution")
    ap.add_argument("--trace-out", default="profile_rbft.trace.jsonl",
                    help="trace dump path for --trace (consume with "
                         "tools.trace_tool)")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the kernels' plain versions; the "
                         "default is the CUDA card")
    args = ap.parse_args(argv)
    n, k, txns = args.n_nodes, args.instances, args.txns

    from ..utils.torch_env import (
        NoCudaDevice,
        mesh_devices,
        parse_mesh_shape,
        resolve_device,
    )

    try:
        device = resolve_device(args.device)
    except NoCudaDevice as exc:
        ap.error(str(exc))
    mesh = None
    if args.mesh not in ("0", 0):
        from ..tpu.quorum import make_fabric_mesh

        try:
            shape = parse_mesh_shape(args.mesh)
        except ValueError as exc:
            ap.error(str(exc))
        # every tile on the one device: the tile count is the shape's
        mesh = make_fabric_mesh([device] * mesh_devices(shape), shape)

    pool = _build_pool(n, k, tick_interval=0.1,
                       adaptive=not args.static_tick, mesh=mesh,
                       trace=args.trace,
                       ingress_capacity=args.ingress_capacity,
                       real_execution=args.real_execution,
                       resident_depth=args.resident_depth,
                       device=device)
    got, elapsed, dispatches, prof = _run(pool, txns, profile=True)
    print(f"n={n} k={k}: {got}/{txns} ordered in {elapsed:.2f}s "
          f"= {got / elapsed:.1f} txns/sec", file=sys.stderr)
    stats = pstats.Stats(prof, stream=sys.stderr)
    stats.sort_stats("cumulative").print_stats(35)
    stats.sort_stats("tottime").print_stats(35)

    trace_block = None
    if args.trace:
        from ..observability.trace import (
            critical_path,
            phase_percentiles,
        )

        events = pool.trace.events()
        pool.trace.dump(args.trace_out)
        trace_block = {
            "trace_file": args.trace_out,
            "trace_hash": pool.trace.trace_hash(),
            "trace_events": len(events),
            # virtual-time attribution: where the protocol pipeline
            # spends its latency, per phase (trace_tool.py renders the
            # same numbers from the dump)
            "phase_latency": phase_percentiles(events),
            "critical_path": critical_path(events),
        }
        print(f"trace: {args.trace_out} "
              f"({trace_block['trace_events']} events, "
              f"hash {trace_block['trace_hash'][:16]}…)", file=sys.stderr)

    if not args.json:
        return

    # fractional batches: a truncated or non-multiple-of-BATCH run must
    # not skew dispatches-per-batch by up to 2x through floor division
    batches = max(got / BATCH, 1e-9)
    per_batch = dispatches / batches
    occ = pool.metrics.stat(MetricsName.DEVICE_FLUSH_OCCUPANCY)
    # adaptive-tick surface: where the governor left the interval and how
    # long the run dwelt on each rung (static runs report the fixed tick
    # and no histogram)
    tick_stat = pool.metrics.stat(MetricsName.GOVERNOR_TICK_INTERVAL)
    record = {
        "n_nodes": n,
        "instances": k,
        "txns_ordered": got,
        "wall_s": round(elapsed, 2),
        "txns_per_sec": round(got / elapsed, 1) if elapsed else 0.0,
        "device_dispatches": dispatches,
        "ordered_batches": round(batches, 2),
        "device_dispatches_per_ordered_batch": round(per_batch, 2),
        "flush_occupancy_avg": round(occ.avg, 4) if occ else None,
        # mesh-sharded dispatch plane: mesh width + each shard's
        # cumulative occupancy (scattered votes / real-row capacity);
        # mesh_shape distinguishes (M,) member sharding from the (M, V)
        # 2-axis quorum fabric behind the same flat shards count
        "shards": pool.vote_group.shards,
        "mesh_shape": list(pool.vote_group.mesh_shape),
        "shard_occupancy": pool.vote_group.shard_occupancy,
        "effective_tick_interval": (tick_stat.last if tick_stat
                                    else pool.config.QuorumTickInterval),
        "tick_interval_histogram": pool.metrics.histogram(
            MetricsName.GOVERNOR_TICK_INTERVAL),
        "governor": (pool.governor.trajectory_summary()
                     if pool.governor is not None else None),
        # multi-tick residency: how much host round-tripping the ring
        # actually saved (None when the run was per-tick)
        "residency": ({
            "resident_depth": pool.vote_group.resident_depth,
            "resident_ticks": pool.vote_group.resident_ticks,
            "readbacks_deferred": pool.vote_group.readbacks_deferred,
        } if pool.vote_group.resident_depth > 1 else None),
        "hotspots_top20_cumulative": _hotspots(prof),
    }
    # ingress plane: the admission queue's depth/admitted/shed and the
    # read path's qps gauge, from the same pool collector every other
    # surface reads (None when the run had no admission and no reads)
    ingress = None
    if pool.admission is not None:
        ingress = pool.admission.counters()
        ingress["shed_hash"] = pool.admission.shed_hash()
    read_qps = pool.metrics.stat(MetricsName.READ_QPS)
    if read_qps is not None:
        ingress = ingress or {}
        ingress["read_qps"] = round(read_qps.last, 1)
    record["ingress"] = ingress
    # state-commit plane: the batched one-walk commit's cost surface,
    # from node0's domain state (every honest node commits the same
    # roots, so one node's meters are THE meters) — None when the run
    # executed nothing real (no ledgers, no states)
    state_block = None
    node0 = pool.nodes[0]
    if getattr(node0, "boot", None) is not None:
        from ..common.constants import DOMAIN_LEDGER_ID

        st = node0.boot.db.get_state(DOMAIN_LEDGER_ID)
        hashes_stat = pool.metrics.stat(MetricsName.STATE_COMMIT_HASHES)
        batch_stat = pool.metrics.stat(MetricsName.STATE_COMMIT_BATCH_SIZE)
        state_block = {
            "hashes_total": st.hashes_total,
            "hashes_per_commit": (round(hashes_stat.avg, 1)
                                  if hashes_stat else None),
            "commits": hashes_stat.count if hashes_stat else 0,
            "writes_per_commit": (round(batch_stat.avg, 1)
                                  if batch_stat else None),
            "node_cache_hit_rate": round(st.cache_hit_rate(), 4),
            "offload_mode": st.commit_mode,
            "wave_host_hashes": st.wave_host_hashes,
            "wave_device_hashes": st.wave_device_hashes,
            "batches_applied": st.batches_applied,
        }
    record["state"] = state_block
    if trace_block is not None:
        record.update(trace_block)
    if not args.no_baseline:
        # per-message baseline: same pool shape, QuorumTickInterval=0 —
        # every quorum query flushes. One post-warm-up batch is enough;
        # dispatches-per-ordered-batch is ~workload-independent.
        base_pool = _build_pool(n, k, tick_interval=0.0, device=device)
        bgot, belapsed, bdispatches, _ = _run(base_pool, BATCH)
        base_per_batch = bdispatches / max(bgot / BATCH, 1e-9)
        record.update({
            "baseline_mode": "per_message",
            "baseline_txns_ordered": bgot,
            "baseline_device_dispatches_per_ordered_batch":
                round(base_per_batch, 2),
            "amortization_factor":
                round(base_per_batch / per_batch, 2) if per_batch else None,
        })
    print(json.dumps(record, separators=(",", ":")))


if __name__ == "__main__":
    main()
