"""The whole gate suite of ``tools.check_dispatch_budget``, gate by gate,
each at the tool's defaults. Run from the root of a checkout:

    python3 indy_plenum_tpu_torch/utils/gate_suite.py [--out DIR] \
        [--device cpu] [GATE ...]

It calls the tool's ``main`` once for the dispatch budget alone (``--only
""``) and once for each gate (``--only GATE --json``; all of ``GATES``, in
the order ``main`` runs them, unless some are named), in this process, so
the kernel library loads once. Each run's JSON record goes to
``DIR/gate_<name>.json`` when ``--out DIR`` is given; stdout gets one
line a run (the gate, its exit code, its verdict, its wall seconds) and last
one JSON object with every line's fields and the card's name and power
limit. A gate run alone pays its own arms where the full command reuses
another gate's (the tracing and readback gates' base, the latency gate's
traced and 4-lane arms). It exits 1 when a gate fails.
"""
from __future__ import annotations

# da: allow-file[nondet-source] -- a measuring tool: the wall it reads is reported beside each gate's verdict and feeds no gate

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

# the order of check_dispatch_budget.main
ORDER = ("static", "governor", "sharded", "fabric", "trace", "lanes",
         "latency", "readback", "ingress", "overload", "proof", "catchup",
         "state", "geo", "residency", "soak")


def _card(device) -> str:
    if device == "cpu":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "nvidia-smi failed"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("gates", nargs="*", help="gates to run (default: all)")
    ap.add_argument("--out", default=None,
                    help="write each run's record here")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    from indy_plenum_tpu_torch.tools import check_dispatch_budget as cdb

    unknown = [g for g in args.gates if g not in cdb.GATES]
    if unknown:
        ap.error(f"unknown gate(s) {unknown}")
    runs = [("budget", "")] + [(g, g) for g in ORDER
                               if not args.gates or g in args.gates]
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    card = _card(args.device)
    lines = []
    for name, only in runs:
        argv = ["--only", only, "--json"] + (
            ["--device", args.device] if args.device else [])
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cdb.main(argv)
        wall = time.perf_counter() - t0
        text = out.getvalue().strip().splitlines()[-1]
        if args.out:
            with open(os.path.join(args.out, f"gate_{name}.json"),
                      "w") as fh:
                fh.write(text + "\n")
        verdict = json.loads(text)["verdict"]
        line = {"gate": name, "rc": rc, "verdict": verdict[:400],
                "wall_s": wall}
        lines.append(line)
        print(json.dumps(line), flush=True)
    print(json.dumps({"gates": lines, "card": card}), flush=True)
    return 0 if all(line["rc"] == 0 for line in lines) else 1


if __name__ == "__main__":
    sys.exit(main())
