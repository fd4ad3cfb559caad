"""Run a cell with a fault of ``faults.py`` planted, or with none, on
several seeds in one process, and print each run's compared numbers: the
readings the limits of ``run.LIMITS`` are set between.

    python -m port_bench.control --workload local-4.reads --fault live_tip \\
        --seeds 1 2 3 --seconds 30

The benchmark's own runs never plant a fault.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", default="none")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from .faults import FAULTS
    from .run import run_cell

    tamper = None if args.fault == "none" else FAULTS[args.fault]
    for seed in args.seeds:
        t0 = time.perf_counter()
        line, checks, info, _ = run_cell(args.workload, seed, args.seconds,
                                         False, device=args.device, t0=t0,
                                         tamper=tamper)
        print(json.dumps({"workload": args.workload, "fault": args.fault,
                          "seed": seed, "correct": line["correct"],
                          "checks": checks, "metrics": line["metrics"],
                          "failed": line["failed"],
                          "attempted": line["attempted"],
                          "wall_s": time.perf_counter() - t0}))
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
