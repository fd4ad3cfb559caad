"""Consume consensus flight-recorder dumps (observability.trace JSONL).

Usage (``TOOL`` is ``indy_plenum_tpu_torch.tools.trace_tool``):
    python -m TOOL TRACE.jsonl                 # full report
    python -m TOOL TRACE.jsonl --phases        # percentiles
    python -m TOOL TRACE.jsonl --critical-path
    python -m TOOL TRACE.jsonl --journeys      # e2e table
    python -m TOOL TRACE.jsonl --journey DIGEST
    python -m TOOL TRACE.jsonl --chrome OUT.json
    python -m TOOL TRACE.jsonl --json
    python -m TOOL TRACE.jsonl --node node0
    python -m TOOL n0.jsonl n1.jsonl n2.jsonl --journeys

Dumps come from ``SimPool(trace=True)`` / ``NodePool(trace=True)``,
``tools.chaos_run --trace`` (``<report>.trace.jsonl``),
``tools.profile_rbft --trace``, or a deployed node's SIGUSR2 flight dump.
Several dumps (one per node) merge into one deterministic timeline —
the causal plane's cross-node joins work either way. Views:

- **--phases**: per-phase latency percentiles (p50/p90/p99/max) for the
  3PC lifecycle — prepare / commit / order / execute, plus the ingress
  auth phase. Simulation dumps measure VIRTUAL (protocol) time; deployed
  dumps measure perf_counter time.
- **--critical-path**: per ordered batch, which phase dominated its
  latency, plus each phase's share of total attributed time — the view
  that turns "a batch ordered in X ms" into "X went to the prepare wave".
- **--journeys**: the causal journey table (observability.causal) —
  per-request end-to-end latency ACROSS NODES with network / queue /
  compute / device attribution, completeness, and the byte-stable
  ``journey_hash``. Geo dumps add a home-region column per journey and
  a per-region write/read e2e rollup; ``--region R`` (like ``--lane``)
  restricts the table to one region.
- **--journey DIGEST** (prefix ok): one request's full cross-node path —
  every per-node lifecycle mark with its deterministic span id, per-hop
  attribution, and the per-wave network latency samples behind it.
- **--chrome**: Chrome trace-event JSON (one pid per node, one tid per
  category; matched net.send/net.recv marks become flow arrows between
  node tracks), loadable in Perfetto (https://ui.perfetto.dev) or
  chrome://tracing.

Twin of ``scripts/trace_tool.py``, over the port's
``observability/trace`` and ``observability/causal``: the same flags and,
on the same dump, the same output byte for byte. It launches no kernel
and so takes no ``--device``: it runs anywhere a dump lands, a host
without a card included.
"""
import argparse
import json
import sys

from ..observability.causal import (
    build_journeys,
    journey_for,
    journey_summary,
    merge_events,
)
from ..observability.trace import (
    critical_path,
    load_jsonl,
    overlap_report,
    phase_percentiles,
    rollup_report,
    to_chrome_trace,
)


def _counts(events) -> dict:
    by_cat, by_name = {}, {}
    for ev in events:
        by_cat[ev.get("cat", "")] = by_cat.get(ev.get("cat", ""), 0) + 1
        by_name[ev["name"]] = by_name.get(ev["name"], 0) + 1
    return {"events": len(events), "by_cat": by_cat, "by_name": by_name}


def _flight_events(events) -> list:
    return [ev for ev in events if ev.get("cat") == "flight"]


def _print_journey(detail: dict) -> None:
    j = detail["journey"]
    lane = f" lane={j['lane']}" if "lane" in j else ""
    region = f" region={j['region']}" if "region" in j else ""
    print(f"journey {j['digest'][:16]}… trace_id={j['trace_id']} "
          f"class={j['class']}{lane}{region} batch=(v{j['batch'][0]} "
          f"s{j['batch'][1]} {str(j['batch'][2])[:12]}…)")
    print(f"  e2e={j['e2e']} complete={j['complete']} "
          f"attribution={j['attribution']}"
          + (f" retries={j['retries']}" if j.get("retries") else "")
          + (f" via_catchup={j['catchup']}" if j.get("catchup") else "")
          + (f" proof_after={j['proof_after']}"
             if "proof_after" in j else ""))
    print(f"  {'hop':12s} {'t0':>16s} {'dur':>12s} {'network':>10s} "
          f"{'residual':>16s} span_id")
    for h in j["hops"]:
        residual = next(((k, v) for k, v in h.items()
                         if k in ("queue", "compute", "device")),
                        ("", 0.0))
        print(f"  {h['hop']:12s} {h['t0']:>16.6f} {h['dur']:>12.6f} "
              f"{h['network']:>10.6f} {residual[1]:>10.6f} "
              f"{residual[0]:<5s} {h['span_id']}")
    print("  cross-node marks:")
    for m in detail["marks"]:
        print(f"    t={m['ts']:.6f} {m['node'] or 'pool':10s} "
              f"{m['name']:22s} span={m['span_id']}")
    if detail["net_waves"]:
        print("  network waves (in-flight seconds per delivered copy):")
        for op, lats in detail["net_waves"].items():
            show = ", ".join(f"{v:.4f}" for v in lats[:8])
            more = f" (+{len(lats) - 8} more)" if len(lats) > 8 else ""
            print(f"    {op:12s} n={len(lats):<4d} {show}{more}")


def _print_journey_table(record: dict) -> None:
    js = record["journeys"]
    e2e_w, e2e_r = js["e2e"]["write"], js["e2e"]["read"]
    retried = f", retried={js['retried']}" if js.get("retried") else ""
    print(f"journeys: {js['complete']}/{js['count']} complete "
          f"(orphans={js['orphan_spans']}, pending={js['pending']}, "
          f"shed={js['shed']}, via_catchup={js['catchup_journeys']}"
          f"{retried}) hash={js['journey_hash'][:16]}…")
    print(f"  e2e write: n={e2e_w['count']} p50={e2e_w['p50']} "
          f"p90={e2e_w['p90']} p99={e2e_w['p99']} max={e2e_w['max']}")
    if e2e_r["count"]:
        print(f"  e2e read:  n={e2e_r['count']} p50={e2e_r['p50']} "
              f"p90={e2e_r['p90']} p99={e2e_r['p99']}")
    if js["attribution_share"]:
        print("  attribution: " + "  ".join(
            f"{k}={v:.1%}" for k, v in js["attribution_share"].items()))
    if js.get("critical_path"):
        print("  dominant hop: " + "  ".join(
            f"{k}={v}" for k, v in js["critical_path"].items()))
    lanes = js.get("lanes")
    if lanes:
        per = "  ".join(
            f"L{l}:n={lanes['journeys_per_lane'][l]}"
            f",p99={lanes['e2e_per_lane'][l]['p99']}"
            for l in sorted(lanes["journeys_per_lane"], key=int))
        print(f"  lanes: {lanes['count']} "
              f"(barrier hop on {lanes['with_barrier_hop']}"
              f"/{lanes['with_lane']})  {per}")
    regions = js.get("regions")
    if regions:
        print(f"  regions: {regions['count']} "
              f"(tagged {regions['with_region']}/{js['count']} writes)")
        per_w = regions.get("journeys_per_region") or {}
        e2e_w_r = regions.get("e2e_per_region") or {}
        for r in sorted(per_w, key=int):
            st = e2e_w_r.get(r) or {}
            print(f"    R{r} write: n={per_w[r]} p50={st.get('p50')} "
                  f"p99={st.get('p99')}")
        for r, st in sorted((regions.get("read_e2e_per_region")
                             or {}).items(), key=lambda kv: int(kv[0])):
            print(f"    R{r} read:  n={st['count']} p50={st['p50']} "
                  f"p99={st['p99']}")
    fw = js.get("fault_window")
    if fw:
        print(f"  fault windows: {fw['windows']} — "
              f"{fw['through_fault']['count']} journeys crossed one "
              f"(p50 {fw['through_fault']['p50']} vs "
              f"{fw['clear']['p50']} clear, p50_cost={fw['p50_cost']})")
    for j in record.get("journey_table", []):
        mark = "" if j["complete"] else "  INCOMPLETE"
        catchup = (" catchup=" + ",".join(j["catchup"])
                   if j.get("catchup") else "")
        lane = f"lane={j['lane']} " if "lane" in j else ""
        region = f"region={j['region']} " if "region" in j else ""
        # closed-loop retry: how many re-offers this request took (its
        # hops then carry the `retry` hop's backoff wait)
        retries = f"retries={j['retries']} " if j.get("retries") else ""
        print(f"  {j['digest'][:16]}… {lane}{region}{retries}"
              f"e2e={j['e2e']} "
              f"batch=v{j['batch'][0]}s{j['batch'][1]} "
              f"net={j['attribution']['network']} "
              f"queue={j['attribution']['queue']} "
              f"compute={j['attribution']['compute']} "
              f"device={j['attribution']['device']}{catchup}{mark}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m indy_plenum_tpu_torch.tools.trace_tool",
        description=__doc__)
    ap.add_argument("dump", nargs="+",
                    help="trace JSONL file(s); several per-node dumps "
                         "merge into one deterministic timeline")
    ap.add_argument("--phases", action="store_true",
                    help="per-phase latency percentiles only")
    ap.add_argument("--critical-path", action="store_true",
                    help="per-batch dominant-phase breakdown only")
    ap.add_argument("--overlap", action="store_true",
                    help="per-tick host/device overlap fraction + "
                         "readback-bytes column (ordering fast path)")
    ap.add_argument("--rollups", action="store_true",
                    help="telemetry windowed rollups: per-window "
                         "ordered/shed/p99/high-water table with drift "
                         "anomaly marks (long-horizon soak dumps)")
    ap.add_argument("--journeys", action="store_true",
                    help="causal journey table: per-request cross-node "
                         "e2e latency with network/queue/compute/device "
                         "attribution + journey_hash")
    ap.add_argument("--journey", metavar="DIGEST", default=None,
                    help="one request's full cross-node path (digest "
                         "prefix ok): per-node marks, span ids, per-hop "
                         "attribution, per-wave network samples")
    ap.add_argument("--lane", type=int, default=None, metavar="L",
                    help="restrict the --journeys table to one ordering "
                         "lane (laned dumps tag every journey with its "
                         "lane; the summary rollup stays pool-wide)")
    ap.add_argument("--region", type=int, default=None, metavar="R",
                    help="restrict the --journeys table to one home "
                         "region (geo dumps tag every journey with the "
                         "submitting client's region; the summary "
                         "rollup stays pool-wide)")
    ap.add_argument("--chrome", metavar="OUT",
                    help="write Chrome trace-event JSON (Perfetto)")
    ap.add_argument("--node", default=None,
                    help="restrict phase views to one node's marks")
    ap.add_argument("--json", action="store_true",
                    help="one machine-readable JSON line on stdout")
    args = ap.parse_args(argv)

    if len(args.dump) == 1:
        events = load_jsonl(args.dump[0])
    else:
        events = merge_events(*[load_jsonl(p) for p in args.dump])
    if not events:
        print(f"{', '.join(args.dump)}: no events", file=sys.stderr)
        return 2

    record = {"dump": args.dump[0] if len(args.dump) == 1
              else list(args.dump), "summary": _counts(events)}
    # --phases/--critical-path/--overlap/--journeys narrow the view;
    # --chrome is orthogonal, --journey replaces the report entirely
    if args.journey is not None:
        detail = journey_for(events, args.journey)
        if detail is None:
            print(f"no journey matches digest prefix {args.journey!r}",
                  file=sys.stderr)
            return 2
        if args.json:
            print(json.dumps(detail, separators=(",", ":"),
                             sort_keys=True))
            return 0
        _print_journey(detail)
        return 0
    view_selected = (args.phases or args.critical_path or args.overlap
                     or args.rollups or args.journeys)
    if args.phases or not view_selected:
        record["phase_latency"] = phase_percentiles(events, node=args.node)
    if args.critical_path or not view_selected:
        record["critical_path"] = critical_path(events, node=args.node)
    if args.overlap or not view_selected:
        record["overlap"] = overlap_report(events, node=args.node)
    if args.rollups or not view_selected:
        rollups = rollup_report(events, node=args.node)
        if rollups["windows"] or args.rollups:
            record["rollups"] = rollups
    if args.journeys or not view_selected:
        built = build_journeys(events)
        record["journeys"] = journey_summary(events, built=built)
        if args.journeys:
            table = built["journeys"]
            if args.lane is not None:
                table = [j for j in table if j.get("lane") == args.lane]
            if args.region is not None:
                table = [j for j in table
                         if j.get("region") == args.region]
            record["journey_table"] = table
    if not view_selected:
        record["flight_events"] = _flight_events(events)
    if args.chrome:
        chrome = to_chrome_trace(events)
        with open(args.chrome, "w") as fh:
            json.dump(chrome, fh, separators=(",", ":"))
        record["chrome"] = {"file": args.chrome,
                            "events": len(chrome["traceEvents"])}

    if args.json:
        print(json.dumps(record, separators=(",", ":"), sort_keys=True))
        return 0

    summary = record["summary"]
    print(f"{', '.join(args.dump)}: {summary['events']} events "
          f"({', '.join(f'{c}={n}' for c, n in sorted(summary['by_cat'].items()))})")
    if "phase_latency" in record:
        print("phase latency (p50/p90/p99/max, trace clock units):")
        for phase, st in record["phase_latency"].items():
            print(f"  {phase:10s} n={st['count']:<6d} p50={st['p50']:<10g}"
                  f" p90={st['p90']:<10g} p99={st['p99']:<10g}"
                  f" max={st['max']:g}")
    if "critical_path" in record:
        cp = record["critical_path"]
        print(f"critical path over {cp['batches']} batches:")
        for phase, cnt in cp["dominant"].items():
            share = cp["phase_share"].get(phase, 0.0)
            print(f"  {phase:10s} dominated {cnt} batches "
                  f"(share of attributed time: {share:.1%})")
    if "overlap" in record:
        ov = record["overlap"]
        bpt = ov["readback_bytes_per_tick"]
        print(f"dispatch overlap over {ov['ticks']} ticks: "
              f"{ov['overlap_fraction']:.1%} of {ov['readbacks']} "
              f"readbacks overlapped a full tick of host work; "
              f"readback bytes/tick p50={bpt['p50']} max={bpt['max']} "
              f"(total {ov['readback_bytes_total']})")
        resident = "residency" in ov
        if resident:
            rs = ov["residency"]
            print(f"residency: {rs['enqueues']} enqueues over "
                  f"{rs['resident_ticks_total']} resident ticks, "
                  f"{rs['readbacks_deferred']} readbacks deferred")
        if "rebalances" in ov:
            rb = ov["rebalances"]
            print(f"rebalances: {rb['executed']} executed")
            for m in rb["marks"]:
                print(f"  t={m['ts']:.6f} {m['name']} {m['args']}")
        if args.overlap:
            cols = (f"  {'tick_ts':>14s} {'dispatches':>10s} "
                    f"{'votes':>7s} {'readbacks':>9s} {'overlapped':>10s} "
                    f"{'rb_bytes':>9s}")
            if resident:
                cols += (f" {'enqueues':>8s} {'res_ticks':>9s} "
                         f"{'deferred':>8s}")
            print(cols)
            for t in ov["per_tick"]:
                row = (f"  {t.get('ts', 0):>14.6f} {t['dispatches']:>10d} "
                       f"{t['votes']:>7d} {t['readbacks']:>9d} "
                       f"{t['overlapped']:>10d} {t['readback_bytes']:>9d}")
                if resident:
                    row += (f" {t.get('enqueues', 0):>8d} "
                            f"{t.get('resident_ticks', 0):>9d} "
                            f"{t.get('deferred', 0):>8d}")
                print(row)
        if "per_shard" in ov:
            ps = ov["per_shard"]
            print("per-shard (scale-out quorum fabric; a hot shard is "
                  "visible here alone):")
            print(f"  {'member_shard':>12s} {'readbacks':>9s} "
                  f"{'rb_bytes':>9s}")
            for s, (rb, b) in enumerate(zip(ps["readbacks"],
                                            ps["readback_bytes"])):
                print(f"  {s:>12d} {rb:>9d} {b:>9d}")
            print(f"  {'grid_cell':>12s} {'votes':>9s} {'share':>9s}")
            for c, (v, sh) in enumerate(zip(ps["votes"],
                                            ps["vote_share"])):
                print(f"  {c:>12d} {v:>9d} {sh:>9.2%}")
    if "rollups" in record:
        ru = record["rollups"]
        laws = ", ".join(f"{k}={v}" for k, v in
                         ru["anomalies_by_law"].items()) or "none"
        print(f"telemetry rollups over {ru['windows']} windows: "
              f"ordered total={ru['ordered_total']} "
              f"(min={ru['ordered_min']} max={ru['ordered_max']} "
              f"per window), anomalies={ru['anomaly_count']} ({laws})")
        if args.rollups:
            print(f"  {'window':>6s} {'ts':>14s} {'ordered':>8s} "
                  f"{'shed':>6s} {'retry':>6s} {'p99':>10s} "
                  f"{'hw_total':>9s} {'largest resource':<28s} anomalies")
            for r in ru["per_window"]:
                p99 = f"{r['p99']:.4f}" if r.get("p99") is not None \
                    else "-"
                top = (f"{r.get('hw_top') or '-'}"
                       f"={r.get('hw_top_entries', 0)}")
                marks = ",".join(r["anomalies"]) if r["anomalies"] else ""
                print(f"  {r.get('window', 0):>6d} "
                      f"{r.get('ts', 0):>14.3f} "
                      f"{r.get('ordered') or 0:>8d} "
                      f"{r.get('shed') or 0:>6d} "
                      f"{r.get('retry') or 0:>6d} {p99:>10s} "
                      f"{r.get('hw_total', 0):>9d} {top:<28s} {marks}")
            for a in ru["anomalies"]:
                detail = {k: v for k, v in a.items()
                          if k not in ("law", "ts", "window")}
                print(f"  anomaly t={a['ts']:.3f} w={a.get('window')} "
                      f"{a['law']} {detail}")
    if "journeys" in record:
        _print_journey_table(record)
    if record.get("flight_events"):
        print("flight events:")
        for ev in record["flight_events"]:
            print(f"  t={ev['ts']:.3f} {ev['name']} "
                  f"{ev.get('args') or ''}")
    if args.chrome:
        print(f"chrome trace: {args.chrome} "
              f"({record['chrome']['events']} events) — load in Perfetto")
    return 0


if __name__ == "__main__":
    sys.exit(main())
