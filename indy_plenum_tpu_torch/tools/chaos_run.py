"""Run a chaos scenario against the simulated RBFT pool.

Usage:
    python -m indy_plenum_tpu_torch.tools.chaos_run --seed 7 \
        --scenario f_crash_partition
    python -m indy_plenum_tpu_torch.tools.chaos_run --list
    python -m indy_plenum_tpu_torch.tools.chaos_run --seed 3 \
        --scenario storm --out storm.json

Every run is fully determined by (scenario, seed, nodes): the emitted
JSON report contains the fault plan, the virtual-time event trace,
delivery accounting and all invariant verdicts, plus the exact command
that replays it. Exit status: 0 when the verdicts match the scenario's
design (all PASS for normal scenarios; the designed failures for
checker-vacuity scenarios like broken_agreement), 2 otherwise.

Twin of ``scripts/chaos_run.py``: the same flags, ``--list`` text, report
file name and exit codes, over the port's ``chaos`` plane, plus
``--device``. The pool's kernels run on the CUDA card unless ``--device
cpu`` asks for their plain versions; without a card and without ``--device
cpu`` it exits non-zero before it builds a pool. ``--mesh`` builds the
fabric's tiles on that one device. This is the command a port report's
``replay_command`` names.
"""
import argparse
import sys

from ..chaos import SCENARIOS, run_scenario


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m indy_plenum_tpu_torch.tools.chaos_run",
        description="deterministic fault injection for the RBFT sim pool")
    parser.add_argument("--seed", type=int, default=7,
                        help="plan + pool seed (the replay key)")
    parser.add_argument("--scenario", default="f_crash_partition",
                        choices=sorted(SCENARIOS),
                        help="named fault scenario")
    parser.add_argument("--nodes", type=int, default=0,
                        help="pool size (0 = scenario default)")
    parser.add_argument("--out", default=None,
                        help="report path (default: "
                             "chaos_<scenario>_<seed>.json)")
    parser.add_argument("--list", action="store_true",
                        help="list scenarios and exit")
    parser.add_argument("--device-quorum", action="store_true",
                        help="decide quorums on the device vote plane")
    parser.add_argument("--tick", type=float, default=0.0,
                        help="QuorumTickInterval: > 0 routes the scenario "
                             "through the tick-batched dispatch plane "
                             "(requires --device-quorum)")
    parser.add_argument("--adaptive-tick", action="store_true",
                        help="hand the tick to the dispatch governor "
                             "(requires --tick; the report's "
                             "governor.tick_interval metrics record the "
                             "deterministic interval trajectory)")
    parser.add_argument("--mesh", default="0",
                        help="the grouped vote plane as a fabric: M tiles "
                             "on the member axis (e.g. 4) or an MxV member "
                             "x validator 2-axis fabric (e.g. 2x2), every "
                             "tile on the one device; requires "
                             "--device-quorum")
    parser.add_argument("--lanes", type=int, default=0,
                        help="override the scenario's ordering-lane "
                             "count (> 1 runs the laned path: faults "
                             "inside lane 0, cross_lane invariant "
                             "probed; 0 keeps the scenario's own value)")
    parser.add_argument("--resident-depth", type=int, default=0,
                        help="multi-tick device residency: votes "
                             "accumulate in device-side ring slots over "
                             "this many ticks before one fused step "
                             "consumes them (requires --device-quorum "
                             "and --tick; ordered output is bit-"
                             "identical to the per-tick run)")
    parser.add_argument("--trace", action="store_true",
                        help="arm the consensus flight recorder: the "
                             "report gains trace_hash + flight_recorder "
                             "tail dumps and the full span trace lands "
                             "next to the report as <out>.trace.jsonl "
                             "(consume with tools.trace_tool); "
                             "deterministic — replaying the same seed "
                             "reproduces the dump bit-for-bit")
    parser.add_argument("--device", default=None,
                        help="'cpu' runs the kernels' plain versions; the "
                             "default is the CUDA card")
    args = parser.parse_args(argv)
    if args.tick > 0 and not args.device_quorum:
        parser.error("--tick requires --device-quorum")
    if args.adaptive_tick and args.tick <= 0:
        parser.error("--adaptive-tick requires --tick")
    if args.resident_depth > 1 and args.tick <= 0:
        parser.error("--resident-depth requires --tick")
    mesh_shape = None
    if args.mesh not in ("0", 0):
        from ..utils.torch_env import parse_mesh_shape

        try:
            mesh_shape = parse_mesh_shape(args.mesh)
        except ValueError as exc:
            parser.error(str(exc))
        if not args.device_quorum:
            parser.error("--mesh requires --device-quorum")

    if args.list:
        for name in sorted(SCENARIOS):
            sc = SCENARIOS[name]
            tags = []
            if sc.expect_fail:
                tags.append("expects FAIL: " + ", ".join(sc.expect_fail))
            if sc.lanes > 1:
                tags.append(f"laned x{sc.lanes}; asserts cross_lane")
            if sc.real_execution:
                extra = [flag for flag, on in (
                    ("catchup", sc.require_catchup),
                    ("byz-seeder-rejection", sc.require_rejection),
                    ("retry-law", sc.require_retries),
                    ("proof-read", sc.proof_read)) if on]
                tags.append("real-exec" + ("+bls" if sc.bls else "")
                            + ("; asserts " + ", ".join(extra)
                               if extra else ""))
            tag = "".join(f" [{t}]" for t in tags)
            print(f"{name:24s} {sc.description}{tag}")
        return 0

    from ..utils.torch_env import NoCudaDevice, resolve_device

    try:
        device = resolve_device(args.device)
    except NoCudaDevice as exc:
        parser.error(str(exc))
    mesh = None
    if mesh_shape is not None:
        # every tile on the one device: the fabric is a placement choice
        from ..tpu.quorum import make_fabric_mesh
        from ..utils.torch_env import mesh_devices

        mesh = make_fabric_mesh([device] * mesh_devices(mesh_shape),
                                mesh_shape)

    out = args.out or f"chaos_{args.scenario}_{args.seed}.json"
    scenario = args.scenario
    if args.lanes:
        import dataclasses

        from ..chaos.scenarios import get_scenario

        scenario = dataclasses.replace(get_scenario(args.scenario),
                                       lanes=args.lanes)
    report = run_scenario(scenario, seed=args.seed,
                          n_nodes=args.nodes, out_path=out,
                          device_quorum=args.device_quorum,
                          quorum_tick_interval=args.tick,
                          quorum_tick_adaptive=args.adaptive_tick,
                          mesh=mesh,
                          trace=args.trace,
                          trace_out=(out + ".trace.jsonl"
                                     if args.trace else None),
                          resident_depth=args.resident_depth,
                          device=device)
    for line in report.summary_lines():
        print(line)
    print(f"  report: {out}")
    if report.verdict_as_expected:
        if report.expected_failures:
            print("OK (failed exactly as designed — checker not vacuous)")
        else:
            print("OK (all invariants PASS)")
        return 0
    print(f"UNEXPECTED VERDICT: failed={report.failed} "
          f"expected={report.expected_failures}")
    return 2


if __name__ == "__main__":
    sys.exit(main())
