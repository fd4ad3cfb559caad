"""Ingress-plane run: open-loop load + admission + reads, end to end.

Runs the seeded million-client workload generator against a tick-batched
``SimPool`` with admission control armed, serves the read mix through the
device-proof :class:`~indy_plenum_tpu_torch.ingress.read_service.ReadService`,
and emits ONE machine-readable JSON line: arrivals/admitted/shed, the
shed-set fingerprint, sustained ordered/sim-second, p50/p99
``req.ingress -> req.finalised`` latency from the flight-recorder spans,
read qps (virtual-clock derived), ``ordered_hash`` and ``trace_hash``.
Same seed => byte-identical record fields (only ``wall_s`` is wall time)
— replay a saturation incident exactly.

Workload profiles + closed-loop retry (overload robustness plane):
``--profile diurnal|flash`` modulates the arrival rate (day curve /
crowd spike — the ``WorkloadProfile*`` config knobs shape it), and
``--retry`` arms the per-client seeded-backoff retry of shed requests
(``--retry-max`` attempts). The JSON record then carries a ``retry``
block: attempts, exhausted clients, the first-attempt/retry admission
split, the goodput fraction, and the ``retry_hash`` fingerprint.

Usage:
    python -m indy_plenum_tpu_torch.tools.ingress_run --nodes 16 \
        --rate 400 --duration 20 --capacity 256 --read-fraction 0.5 --json
    python -m indy_plenum_tpu_torch.tools.ingress_run --profile flash \
        --retry --retry-max 4 --rate 300 --capacity 64 --json

Twin of ``scripts/ingress_run.py`` over the port's ``ingress`` plane and
``SimPool``: the same flags and the same JSON record, plus ``--device``.
The signed ingress drains (K-a, K-b, K-c), the tick's quorum step (K7)
and the read path's audit folds run on the CUDA card unless ``--device
cpu`` asks for their plain versions; without a card and without
``--device cpu`` it exits non-zero before it builds a pool. Two same-seed
runs give the same record but for ``wall_s`` and the reads'
``read_qps``.
"""
# da: allow-file[nondet-source] -- operator tool: wall_s is REPORTED next to the seeded record (shed_hash, ordered_hash, trace_hash), never folded into it
import argparse
import json
import sys
import time

from ..config import getConfig
from ..ingress import (
    ReadService,
    StaticCorpusBacking,
    WorkloadGenerator,
    WorkloadProfile,
    WorkloadSpec,
)
from ..simulation.pool import SimPool


def build_pool(args, device) -> SimPool:
    config = getConfig({
        "Max3PCBatchSize": args.batch_size,
        "Max3PCBatchWait": 0.05,
        "QuorumTickInterval": args.tick,
        "QuorumTickAdaptive": not args.static_tick,
        "IngressQueueCapacity": args.capacity,
        "IngressPerClientCap": args.per_client_cap,
        "IngressRetryMax": args.retry_max if args.retry else 0,
    })
    return SimPool(n_nodes=args.nodes, seed=args.seed, config=config,
                   device_quorum=True, shadow_check=False,
                   sign_requests=True, num_instances=args.instances,
                   trace=True, trace_capacity=args.trace_capacity,
                   device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m indy_plenum_tpu_torch.tools.ingress_run",
        description=__doc__)
    ap.add_argument("--nodes", type=int, default=16)
    ap.add_argument("--instances", type=int, default=1)
    ap.add_argument("--batch-size", type=int, default=80)
    ap.add_argument("--tick", type=float, default=0.1)
    ap.add_argument("--static-tick", action="store_true",
                    help="freeze the tick (skip the adaptive governor)")
    ap.add_argument("--seed", type=int, default=11)
    # workload (open loop — arrivals never wait for completions)
    ap.add_argument("--clients", type=int, default=1_000_000,
                    help="virtual client population (Zipf-skewed)")
    ap.add_argument("--rate", type=float, default=400.0,
                    help="arrivals per sim-second")
    ap.add_argument("--duration", type=float, default=20.0,
                    help="arrival window, sim-seconds")
    ap.add_argument("--settle", type=float, default=20.0,
                    help="extra sim-seconds to drain after arrivals stop")
    ap.add_argument("--read-fraction", type=float, default=0.5)
    ap.add_argument("--zipf-clients", type=float, default=1.1)
    ap.add_argument("--zipf-keys", type=float, default=1.2)
    ap.add_argument("--keys", type=int, default=16384,
                    help="hot-key universe (NYM/attrib read corpus)")
    ap.add_argument("--profile", default="steady",
                    choices=["steady", "diurnal", "flash"],
                    help="arrival-rate modulation: steady (flat), "
                         "diurnal (day curve), flash (crowd spike) — "
                         "shaped by the WorkloadProfile* config knobs")
    # closed-loop retry (overload robustness plane)
    ap.add_argument("--retry", action="store_true",
                    help="arm per-client seeded-backoff retries of shed "
                         "requests (the closed loop real overload "
                         "compounds through)")
    ap.add_argument("--retry-max", type=int, default=3,
                    help="retry budget per request before the client "
                         "gives up (must be >= 1)")
    # admission
    ap.add_argument("--capacity", type=int, default=256,
                    help="bounded auth-queue capacity (per tick drain)")
    ap.add_argument("--per-client-cap", type=int, default=0)
    ap.add_argument("--trace-capacity", type=int, default=1 << 20)
    ap.add_argument("--trace-out", default=None,
                    help="dump the span trace as JSONL (tools.trace_tool)")
    ap.add_argument("--json", action="store_true",
                    help="one machine-readable stdout line")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the kernels' plain versions; the "
                         "default is the CUDA card")
    args = ap.parse_args(argv)
    if args.capacity < 1:
        # SimPool only arms the admission plane for a positive capacity —
        # fail here, not with an AttributeError after the full run
        ap.error("--capacity must be >= 1 (0 disables admission control, "
                 "which this tool exists to measure)")
    if args.retry_max < 1:
        # a zero/negative budget silently disarms the loop the flag
        # asked for — refuse instead of reporting an empty retry block
        ap.error("--retry-max must be >= 1 (a request needs at least "
                 "one retry for the closed loop to exist)")

    from ..utils.torch_env import NoCudaDevice, resolve_device

    try:
        device = resolve_device(args.device)
    except NoCudaDevice as exc:
        ap.error(str(exc))
    pool = build_pool(args, device)
    reads = ReadService(StaticCorpusBacking(args.keys, seed=args.seed),
                        clock=pool.timer.get_current_time,
                        metrics=pool.metrics, trace=pool.trace,
                        device=device)
    # warm the read-verify kernel outside the measured window (its first
    # call loads the kernel library)
    reads.submit(0)
    for i in range(63):
        reads.submit(i)
    reads.drain()
    reads.reset_serve_meters()

    seq = [0]

    def on_write(client: int, key: int) -> None:
        seq[0] += 1
        pool.submit_request(seq[0], client_id="c%d" % client)

    gen = WorkloadGenerator(WorkloadSpec(
        n_clients=args.clients, rate=args.rate, duration=args.duration,
        read_fraction=args.read_fraction,
        zipf_clients=args.zipf_clients, zipf_keys=args.zipf_keys,
        n_keys=args.keys, seed=args.seed,
        profile=WorkloadProfile.from_config(args.profile, pool.config)))
    gen.start(pool.timer, on_write,
              on_read=lambda client, key: reads.submit(key))

    sim_t0 = pool.timer.get_current_time()
    wall_t0 = time.perf_counter()
    horizon = args.duration + args.settle
    step = 0.5
    elapsed = 0.0
    # run the arrival window + settle, then keep going until the queue
    # AND the retry storm drain (outstanding seeded re-offers included)
    while elapsed < horizon or pool.admission.depth \
            or (pool.retry is not None and pool.retry.outstanding):
        pool.run_for(step)
        elapsed += step
        reads.drain()  # reads ride the run loop: zero 3PC involvement
    wall_s = time.perf_counter() - wall_t0
    sim_elapsed = pool.timer.get_current_time() - sim_t0

    assert pool.honest_nodes_agree(), "pool diverged under load"
    ordered = min(len(nd.ordered_digests) for nd in pool.nodes)

    from ..observability.trace import phase_percentiles

    phases = phase_percentiles(pool.trace.events())
    adm = pool.admission
    record = {
        "nodes": args.nodes,
        "instances": args.instances,
        "seed": args.seed,
        "profile": args.profile,
        "workload": gen.counters(),
        "admission": adm.counters(),
        "shed_fraction": round(adm.shed_total / max(adm.offered_total, 1),
                               4),
        "shed_hash": adm.shed_hash(),
        "ordered": ordered,
        "ordered_per_sim_second": round(ordered / sim_elapsed, 2)
        if sim_elapsed else None,
        "sim_elapsed_s": round(sim_elapsed, 2),
        "wall_s": round(wall_s, 2),
        # the acceptance latency: earliest req.ingress anywhere ->
        # earliest req.finalised, per request, from the trace spans
        "ingress_to_finalised": phases.get("auth"),
        "reads": reads.counters(),
        "ordered_hash": pool.ordered_hash(),
        "trace_hash": pool.trace.trace_hash(),
        "governor": (pool.governor.trajectory_summary()
                     if pool.governor is not None else None),
    }
    if pool.retry is not None:
        # the closed-loop record: re-offer counts, the first-attempt vs
        # retry admission split, goodput (unique requests that made it
        # through per unique write arrival), and the retry-storm
        # fingerprint — byte-identical per seed like shed_hash
        from ..common.metrics_collector import MetricsName

        counters = pool.retry.counters()
        readmitted = pool.metrics.stat(
            MetricsName.INGRESS_RETRY_ADMITTED)
        readmitted_n = int(readmitted.total) if readmitted else 0
        record["retry"] = {
            "max_attempts": args.retry_max,
            "attempts": counters["reoffers"],
            "requests_retried": counters["requests_retried"],
            "exhausted": counters["exhausted"],
            "retry_admitted": readmitted_n,
            "first_attempt_admitted": adm.admitted_total - readmitted_n,
            "goodput_fraction": round(
                ordered / max(gen.writes, 1), 4),
            "retry_hash": pool.retry.retry_hash(),
        }
    if args.trace_out:
        pool.trace.dump(args.trace_out)
        record["trace_file"] = args.trace_out
    if args.json:
        print(json.dumps(record, separators=(",", ":")))
    else:
        for key, value in record.items():
            print(f"{key}: {value}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
