"""The bench twin's command with each cell's wall clock. Run from the root
of a checkout:

    python3 indy_plenum_tpu_torch/utils/bench_clock.py [cell|all] [--device cpu]

It runs ``indy_plenum_tpu_torch.tools.bench``'s ``main`` on the same
arguments, in this process, with every cell of ``bench.BENCHES`` timed from
its call to its return (the cell's own work: set-up, warm-up and asserts
included). The bench's compact line stays the last line of stdout; the
walls go to stderr as one JSON line, ``{"bench_clock": {cell: seconds},
"rc": ..., "card": ...}``, after the bench's full record. The exit code is
the bench's.
"""
from __future__ import annotations

# da: allow-file[nondet-source] -- a measuring tool: its clocks time each cell for a report and never feed a result

import json
import os
import sys
import time


def main(argv=None) -> int:
    sys.path.insert(0, os.getcwd())
    from indy_plenum_tpu_torch.tools import bench

    walls = {}

    def timed(name, fn):
        def run(device):
            t0 = time.perf_counter()
            try:
                return fn(device)
            finally:
                bench._sync(bench.resolve_device(device))
                walls[name] = time.perf_counter() - t0
        return run

    for name, fn in list(bench.BENCHES.items()):
        bench.BENCHES[name] = timed(name, fn)
    rc = bench.main(argv)
    args = bench.build_parser().parse_args(argv)
    print(json.dumps({"bench_clock": walls, "rc": rc,
                      "card": bench._device_label(
                          bench.resolve_device(args.device))}),
          file=sys.stderr, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
