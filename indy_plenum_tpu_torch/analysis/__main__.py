"""Determinism & hot-path hygiene linter — the analyzer's CLI.

Pure-AST: never imports torch, so it runs in seconds anywhere (CI,
pre-commit). Exit 1 when any UNSUPPRESSED finding remains — the shipped
baseline is empty, so new findings fail closed; sanctioned sites carry
inline ``# da: allow[rule] -- reason`` pragmas (reason required).

Usage (from the root of a checkout):
    python -m indy_plenum_tpu_torch.analysis
    python -m indy_plenum_tpu_torch.analysis indy_plenum_tpu_torch --json
    python -m indy_plenum_tpu_torch.analysis --show-suppressed
    python -m indy_plenum_tpu_torch.analysis --list-rules
    python -m indy_plenum_tpu_torch.analysis --emit-knobs
    python -m indy_plenum_tpu_torch.analysis \
        --write-baseline /tmp/baseline.json   # staged burn-downs only

Copy of ``scripts/lint_determinism.py``, with the same flags; it lints
``indy_plenum_tpu_torch`` by default.
"""
import argparse
import json
import os
import sys

from . import (
    DEFAULT_BASELINE,
    Analyzer,
    load_baseline,
    make_rules,
    write_baseline,
)
from .rules_config import ConfigKnobRule

# the package this CLI lints when it is given no path
PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m indy_plenum_tpu_torch.analysis",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("paths", nargs="*", default=[PACKAGE_DIR],
                    help="files or package directories to analyze "
                         "(default: the indy_plenum_tpu_torch package)")
    ap.add_argument("--json", action="store_true",
                    help="emit the full report as one JSON object")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="also print pragma/baseline-suppressed findings")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="baseline file of known findings (default: the "
                         "shipped — empty — baseline)")
    ap.add_argument("--write-baseline", default=None, metavar="PATH",
                    help="write the current unsuppressed findings as a "
                         "baseline to PATH and exit 0 (staged "
                         "burn-downs; the SHIPPED baseline stays empty)")
    ap.add_argument("--rule", default=None, metavar="NAME[,NAME]",
                    help="run only the named rule(s)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--emit-knobs", action="store_true",
                    help="render the config-knob registry (from the "
                         "config-knob rule's read map) as a markdown "
                         "table and exit")
    args = ap.parse_args(argv)

    rules = make_rules()
    # the pragma self-lint must know the FULL catalog even when --rule
    # narrows the run, or pragmas naming unfiltered rules would
    # false-positive as 'unknown rule'
    catalog = {r.name for r in rules}
    if args.list_rules:
        width = max(len(r.name) for r in rules)
        for r in rules:
            print(f"{r.name:{width}s}  {r.summary}")
        print(f"{'pragma':{width}s}  reasonless or unknown-rule "
              "'# da: allow[...]' pragmas (the suppression layer "
              "self-lints)")
        return 0
    if args.rule:
        chosen = {r.strip() for r in args.rule.split(",") if r.strip()}
        unknown = chosen - {r.name for r in rules}
        if unknown:
            raise SystemExit(f"unknown rule(s): {sorted(unknown)} "
                             "(see --list-rules)")
        rules = [r for r in rules if r.name in chosen]

    analyzer = Analyzer(rules, known_rules=catalog)
    try:
        report = analyzer.analyze_paths(
            args.paths, baseline_keys=load_baseline(args.baseline))
    except FileNotFoundError as err:
        raise SystemExit(f"error: {err}")  # fail CLOSED on a bad path
    if report.files_analyzed == 0:
        raise SystemExit(
            f"error: no .py files under {args.paths} — refusing to "
            "report a clean run over nothing")

    if args.emit_knobs:
        knob_rule = next((r for r in rules
                          if isinstance(r, ConfigKnobRule)), None)
        if knob_rule is None or not knob_rule.knob_defs:
            raise SystemExit("--emit-knobs needs the config-knob rule "
                             "and config.py inside the analyzed paths")
        print(knob_rule.render_registry())
        return 0

    if args.write_baseline:
        write_baseline(args.write_baseline,
                       [f.baseline_key() for f in report.unsuppressed])
        print(f"wrote {len(report.unsuppressed)} baseline entries to "
              f"{args.write_baseline}")
        return 0

    if args.json:
        print(json.dumps(report.to_dict(), sort_keys=True,
                         separators=(",", ":")))
        return 1 if report.unsuppressed else 0

    for f in report.findings:
        if f.suppressed and not args.show_suppressed:
            continue
        print(f.render())
        if f.suppressed == "pragma" and args.show_suppressed and f.reason:
            print(f"    reason: {f.reason}")
    print(f"files: {report.files_analyzed}  findings: "
          f"{len(report.findings)} ({len(report.unsuppressed)} "
          f"unsuppressed, {len(report.suppressed)} suppressed)")
    print(f"findings_hash: {report.findings_hash}")
    return 1 if report.unsuppressed else 0


if __name__ == "__main__":
    sys.exit(main())
